"""The real S3 event wiring on the port: tests/test_event_wiring.py's 12
tests — SigV4 golden vectors, the entrypoint's bucket CORS and notification
bootstrap, presigned PUT round trips and tampering, CORS preflight, strict
auth, and the whole upload -> ObjectCreated -> SQS -> analysis -> verdict
path through the real HTTP clients — run unchanged against the port's
MiniAWS, clients, entrypoint and app.

``use_port`` (shared by the other mirrors of the reference's tests)
points a reference test module at the port for the length of one test: each
of its globals taken from the JAX package becomes the port's object of the
same name, each JAX-package module its tests import in their bodies
resolves to the port's, with ``DeviceCorpus`` and ``create_app`` given
``device="cpu"``, and ``TVIDZ_TORCH_DEVICE=cpu`` puts every other entry
point (``FingerprintModel``, ``Analyzer``, ``make_mesh``) on the CPU by the
port's own contract. ``reference_cases``, ``reference_fixtures`` and
``run_reference`` run several reference modules' tests as the cases of one
parametrised test. The reference modules themselves are not edited.
"""

import functools
import importlib
import inspect
import sys
import types

import pytest

from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.service.app import create_app

ref = importlib.import_module("tests.test_event_wiring")

# The JAX-package modules the reference's wire tests import in their bodies.
REFERENCE_MODULES = (
    "tvidz_tpu.cli", "tvidz_tpu.config", "tvidz_tpu.corpus.device_corpus",
    "tvidz_tpu.corpus.pgwire", "tvidz_tpu.corpus.store", "tvidz_tpu.decode",
    "tvidz_tpu.decode.synthetic", "tvidz_tpu.decode.y4m",
    "tvidz_tpu.models.fingerprint", "tvidz_tpu.ops.fused",
    "tvidz_tpu.ops.golden", "tvidz_tpu.ops.hamming", "tvidz_tpu.ops.phash",
    "tvidz_tpu.ops.scene", "tvidz_tpu.parallel.mesh",
    "tvidz_tpu.parallel.mesh_corpus", "tvidz_tpu.parallel.sharded_search",
    "tvidz_tpu.pipeline.analyzer", "tvidz_tpu.pipeline.checkpoint",
    "tvidz_tpu.pipeline.dispatcher", "tvidz_tpu.pipeline.prefetch",
    "tvidz_tpu.pipeline.progress", "tvidz_tpu.service.app",
    "tvidz_tpu.service.aws", "tvidz_tpu.service.entrypoint",
    "tvidz_tpu.service.fakes", "tvidz_tpu.service.miniaws",
    "tvidz_tpu.service.minipg", "tvidz_tpu.service.sigv4",
    "tvidz_tpu.service.wsgi", "tvidz_tpu.utils.timing",
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
        view = _PinnedView(port.__name__)
        view.__dict__.update(vars(port))
        view.__dict__.update({k: v for k, v in PINNED.items() if hasattr(port, k)})
        view.__dict__["_port"] = port
        _views[name] = view
    return _views[name]


class _PinnedView(types.ModuleType):
    """A port module with ``PINNED`` names swapped in. Any other attribute
    a test sets (``dcm._AL_T0 = 32``, a monkeypatch) reaches the module
    itself too, so that the port's own code sees it."""

    def __setattr__(self, key, value):
        if key not in PINNED:
            setattr(self._port, key, value)
        super().__setattr__(key, value)

    def __delattr__(self, key):
        if key not in PINNED:
            delattr(self._port, key)
        super().__delattr__(key)


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
    monkeypatch.setenv("TVIDZ_TORCH_DEVICE", "cpu")
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


def _short(module) -> str:
    return module.__name__.rpartition(".")[2]


def reference_cases(module, without=()):
    """One ``pytest.param(module, test)`` per test function of the reference
    ``module``, in file order, save those named in ``without``."""
    tests = [(n, f) for n, f in vars(module).items()
             if n.startswith("test_") and inspect.isfunction(f)]
    missing = set(without) - {n for n, _ in tests}
    assert not missing, f"{module.__name__} has no {sorted(missing)}"
    return [pytest.param(module, f, id=f"{_short(module)}.{n}")
            for n, f in tests if n not in without]


def reference_fixtures(*modules) -> dict:
    """The fixtures the reference ``modules`` define, each renamed
    ``<module>__<name>`` (two modules may both define ``env``); a mirror
    puts them in its globals for ``run_reference`` to find."""
    out = {}
    for module in modules:
        for name, value in vars(module).items():
            marker = getattr(value, "_fixture_function_marker", None)
            if marker is not None:
                qualified = f"{_short(module)}__{name}"
                out[qualified] = pytest.fixture(
                    name=qualified, scope=marker.scope)(
                        value._get_wrapped_function())
    return out


def run_reference(request, monkeypatch, module, test) -> None:
    """Run the reference ``test`` of ``module`` on the port: ``use_port``
    first, then its fixtures (the module's own ones through
    ``reference_fixtures``' names), so that they too build the port's
    objects."""
    use_port(monkeypatch, module)
    own = {n for n, v in vars(module).items()
           if getattr(v, "_fixture_function_marker", None) is not None}
    kwargs = {name: request.getfixturevalue(
        f"{_short(module)}__{name}" if name in own else name)
        for name in inspect.signature(test).parameters}
    test(**kwargs)


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
