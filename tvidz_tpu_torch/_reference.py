"""The one place the port reaches into ``tvidz_tpu``: its jax-free host modules.

Config, logging, the NumPy golden models, the host decoders, the durable
store, the progress registry, the decode prefetcher, the futures helper and
the service's HTTP layer (``wsgi``), AWS fakes, clients and signer are
plain Python/NumPy and are reused unchanged. But ``tvidz_tpu.ops``,
``tvidz_tpu.corpus``, ``tvidz_tpu.pipeline`` and ``tvidz_tpu.service`` have
package ``__init__``s that import jax eagerly, and the port must run where
jax is missing and must not pull it in where it is installed.

So unless jax is already imported, this module registers BARE package
modules for those packages before importing any leaf: each has
``__path__`` set to the package directory and runs no ``__init__``, so
``tvidz_tpu.ops.golden`` and friends import on their own and the port never
imports jax — also where jax is installed but unused. Where jax is already
imported (the JAX package or its tests run in this process) the packages
import normally, and a module already in ``sys.modules`` is never replaced.
A process that uses both packages imports jax (or the JAX package) first.

Two reference paths still reach jax and are replaced in the port:
``AnalysisRegistry.lookup`` imports ``tvidz_tpu.pipeline.analyzer`` (the
port's ``pipeline/progress.py`` overrides it), and ``StageTimer`` wraps each
stage in a ``jax.profiler`` annotation when ``TVIDZ_PROFILE_DIR`` is set
(``StageTimer`` below never does).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.machinery
import os
import sys
import time
import types
from typing import List

import tvidz_tpu

BARE_PACKAGES = ("ops", "corpus", "pipeline", "service")


def jax_imported() -> bool:
    return "jax" in sys.modules


def install_bare_packages() -> List[str]:
    """Register ``tvidz_tpu.<pkg>`` for each of BARE_PACKAGES that is not
    imported yet, without running its ``__init__``. Returns the names it
    registered; a module already in ``sys.modules`` is left as it is."""
    root = os.path.dirname(os.path.abspath(tvidz_tpu.__file__))
    added = []
    for sub in BARE_PACKAGES:
        name = f"tvidz_tpu.{sub}"
        if name in sys.modules:
            continue
        path = os.path.join(root, sub)
        spec = importlib.machinery.ModuleSpec(name, None, is_package=True)
        spec.submodule_search_locations = [path]
        mod = types.ModuleType(name)
        mod.__spec__ = spec
        mod.__path__ = [path]
        mod.__package__ = name
        sys.modules[name] = mod
        setattr(tvidz_tpu, sub, mod)
        added.append(name)
    return added


if not jax_imported():
    install_bare_packages()

_config = importlib.import_module("tvidz_tpu.config")
_utils = importlib.import_module("tvidz_tpu.utils")
golden = importlib.import_module("tvidz_tpu.ops.golden")
_decode_base = importlib.import_module("tvidz_tpu.decode.base")
y4m = importlib.import_module("tvidz_tpu.decode.y4m")
synthetic = importlib.import_module("tvidz_tpu.decode.synthetic")
native = importlib.import_module("tvidz_tpu.decode.native")
mjpeg_avi = importlib.import_module("tvidz_tpu.decode.mjpeg_avi")
_store = importlib.import_module("tvidz_tpu.corpus.store")
pgwire = importlib.import_module("tvidz_tpu.corpus.pgwire")
_progress = importlib.import_module("tvidz_tpu.pipeline.progress")
_prefetch = importlib.import_module("tvidz_tpu.pipeline.prefetch")
_futures = importlib.import_module("tvidz_tpu.utils.futures")
wsgi = importlib.import_module("tvidz_tpu.service.wsgi")
fakes = importlib.import_module("tvidz_tpu.service.fakes")


def aws():
    """The real S3/SQS clients (``tvidz_tpu/service/aws.py``, with its
    ``sigv4`` signer), imported on first use: they need ``requests``, which
    the fakes do not. ``miniaws`` imports the same way when a caller wants
    it."""
    return importlib.import_module("tvidz_tpu.service.aws")


Config = _config.Config
log = _utils.log
Future = _futures.Future
DecodeError = _decode_base.DecodeError
FrameBlock = _decode_base.FrameBlock
get_decoder = _decode_base.get_decoder
Store = _store.Store
is_transient_store_error = _store.is_transient_store_error
AnalysisRegistry = _progress.AnalysisRegistry
BlockPrefetcher = _prefetch.BlockPrefetcher
write_synthetic_y4m = synthetic.write_synthetic_y4m


class StageTimer(_utils.StageTimer):
    """The reference's per-stage wall-clock timer without its jax.profiler
    branch (``tvidz_tpu/utils/timing.py:59``): ``TVIDZ_PROFILE_DIR`` is
    ignored, so timing a stage never imports jax."""

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._total[name] += dt
                self._count[name] += 1
