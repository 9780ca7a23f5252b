"""The real S3 event wiring on the port: tests/test_event_wiring.py's 12
tests — SigV4 golden vectors, the entrypoint's bucket CORS and notification
bootstrap, presigned PUT round trips and tampering, CORS preflight, strict
auth, and the whole upload -> ObjectCreated -> SQS -> analysis -> verdict
path through the real HTTP clients — run unchanged against the port's
MiniAWS, clients, entrypoint and app.

``use_port`` (shared by the other mirrors of the reference's wire tests)
points a reference test module at the port for the length of one test: each
of its globals taken from the JAX package becomes the port's object of the
same name, and each JAX-package module its tests import in their bodies
resolves to the port's, with ``DeviceCorpus`` and ``create_app`` given
``device="cpu"``. The reference modules themselves are not edited.
"""

import functools
import importlib
import sys
import types

import pytest

from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.service.app import create_app

ref = importlib.import_module("tests.test_event_wiring")

# The JAX-package modules the reference's wire tests import in their bodies.
REFERENCE_MODULES = (
    "tvidz_tpu.config", "tvidz_tpu.corpus.device_corpus",
    "tvidz_tpu.corpus.pgwire", "tvidz_tpu.corpus.store", "tvidz_tpu.decode",
    "tvidz_tpu.decode.synthetic", "tvidz_tpu.decode.y4m",
    "tvidz_tpu.pipeline.analyzer", "tvidz_tpu.pipeline.progress",
    "tvidz_tpu.service.app", "tvidz_tpu.service.aws",
    "tvidz_tpu.service.entrypoint", "tvidz_tpu.service.fakes",
    "tvidz_tpu.service.miniaws", "tvidz_tpu.service.minipg",
    "tvidz_tpu.service.sigv4", "tvidz_tpu.utils.timing",
)
PINNED = {"DeviceCorpus": functools.partial(DeviceCorpus, device="cpu"),
          "create_app": functools.partial(create_app, device="cpu")}
_views: dict = {}


def port_module(name: str):
    """The port's module for the JAX package's ``name``; where it defines
    ``DeviceCorpus`` or ``create_app``, a copy with those pinned to the
    CPU."""
    port = importlib.import_module("tvidz_tpu_torch" + name[len("tvidz_tpu"):])
    if not PINNED.keys() & vars(port).keys():
        return port
    if name not in _views:
        view = types.ModuleType(port.__name__)
        view.__dict__.update(vars(port))
        view.__dict__.update({k: v for k, v in PINNED.items() if hasattr(port, k)})
        _views[name] = view
    return _views[name]


def _port_of(value):
    """The port's counterpart of a reference module's global, or None."""
    if isinstance(value, types.ModuleType):
        name = value.__name__
    else:
        name = getattr(value, "__module__", None) or ""
    if name != "tvidz_tpu" and not name.startswith("tvidz_tpu."):
        return None
    port = port_module(name)
    return port if isinstance(value, types.ModuleType) else getattr(
        port, value.__name__)


def use_port(monkeypatch, module) -> None:
    """Point the reference test ``module`` at the port (see the note above)."""
    parents = {n: importlib.import_module(n.rpartition(".")[0])
               for n in REFERENCE_MODULES}
    for name, parent in parents.items():
        port = port_module(name)
        monkeypatch.setitem(sys.modules, name, port)
        monkeypatch.setattr(parent, name.rpartition(".")[2], port, raising=False)
    for key, value in list(vars(module).items()):
        port = _port_of(value)
        if port is not None:
            monkeypatch.setattr(module, key, port)


@pytest.fixture(autouse=True)
def _on_the_port(monkeypatch):
    use_port(monkeypatch, ref)


mini = ref.mini

test_sigv4_header_signing_aws_iam_vector = ref.test_sigv4_header_signing_aws_iam_vector
test_sigv4_presign_aws_s3_vector = ref.test_sigv4_presign_aws_s3_vector
test_sign_headers_produces_authorization = ref.test_sign_headers_produces_authorization
test_s3_object_roundtrip_and_queue_arn = ref.test_s3_object_roundtrip_and_queue_arn
test_bootstrap_applies_cors_and_notification = ref.test_bootstrap_applies_cors_and_notification
test_presigned_put_roundtrip = ref.test_presigned_put_roundtrip
test_presigned_put_rejects_tampering_and_expiry = ref.test_presigned_put_rejects_tampering_and_expiry
test_cors_preflight_from_bucket_config = ref.test_cors_preflight_from_bucket_config
test_e2e_presigned_upload_to_verdict = ref.test_e2e_presigned_upload_to_verdict
test_strict_auth_accepts_signed_clients_rejects_unsigned = ref.test_strict_auth_accepts_signed_clients_rejects_unsigned
test_presign_preserves_endpoint_path_prefix = ref.test_presign_preserves_endpoint_path_prefix
test_upload_url_validates_expires = ref.test_upload_url_validates_expires


def test_the_port_is_what_runs(monkeypatch):
    """Under ``use_port`` the reference module's clients, MiniAWS and the
    modules its tests import are the port's."""
    from tvidz_tpu.corpus.device_corpus import DeviceCorpus as imported
    from tvidz_tpu.service.entrypoint import bootstrap

    assert ref.S3Client.__module__ == "tvidz_tpu_torch.service.aws"
    assert ref.start_miniaws.__module__ == "tvidz_tpu_torch.service.miniaws"
    assert ref.Config.__module__ == "tvidz_tpu_torch.config"
    assert bootstrap.__module__ == "tvidz_tpu_torch.service.entrypoint"
    assert imported.keywords == {"device": "cpu"}
    import tvidz_tpu.utils.timing as timing

    assert timing.__name__ == "tvidz_tpu_torch.utils.timing"
