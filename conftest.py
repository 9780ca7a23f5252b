"""Build the native decoder libraries before the tests are collected.

The reference's decoder suites (``tests/test_decode_fast.py``,
``tests/test_decode_dcskim.py``, ``tests/test_scene_native.py`` and the
``natives`` cases of ``tests/test_torch_host_copies.py``) skip when
``tvidz_tpu/decode/_native/libtvidz_decode.so`` does not exist at
collection, and both libraries are build outputs that git ignores. So the
controlling pytest process builds them here, once, before any xdist worker
collects: ``make -C tvidz_tpu/decode/_native`` for the reference's and
``tvidz_tpu_torch.decode.native.build()`` for the port's (into
``build/tvidz_tpu_torch/``). Both are no-ops when the library is current,
nothing is built when ``pkg-config`` does not find libav, and a lock file
under ``build/`` keeps concurrent runs from building at once.

With xdist workers it also gives each worker its share of the cores,
``max(1, cores // workers)``, through the standard ``OMP_NUM_THREADS`` and
``MKL_NUM_THREADS``: torch's intra-op pool, OpenMP and the BLAS read them
when they load. Without them each worker's pools span the whole machine, and
the workers' threads crowd each other off the cores. The controlling
process sets them before it starts the workers, since pytest's plugins
import numpy (and with it the BLAS) in a worker before any conftest runs;
every process a test starts inherits them. A value the environment already
sets is kept, and a run without xdist is left as it is.
"""

import fcntl
import os
import subprocess

_ROOT = os.path.dirname(os.path.abspath(__file__))
_LIBAV = ("libavformat", "libavcodec", "libavutil", "libswscale")


def _libav_present() -> bool:
    try:
        return subprocess.run(["pkg-config", "--exists", *_LIBAV]).returncode == 0
    except OSError:
        return False


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    workers = config.getoption("numprocesses", None)    # None without xdist
    if workers:
        share = str(max(1, len(os.sched_getaffinity(0)) // workers))
        for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ.setdefault(name, share)
    if not _libav_present():
        return
    lock_dir = os.path.join(_ROOT, "build")
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, ".native-decoders.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-s", "-C",
                        os.path.join(_ROOT, "tvidz_tpu", "decode", "_native")],
                       check=False)
        from tvidz_tpu_torch.decode import native

        try:
            native.build()
        except native.DecodeError as e:
            print(f"conftest: the port's native decoder did not build: {e}")
