"""Device choice, numeric settings, and the hand-written CUDA kernels' build.

The device is explicit: ``resolve_device`` takes a ``device=`` argument,
else ``TVIDZ_TORCH_DEVICE``, else ``cuda``. With no GPU it raises unless
``cpu`` was asked for by name — the CPU runs only the kernels' plain
PyTorch versions and exists for tests and debugging, never as a silent
fallback.

Kernels live in ``csrc/*.cu`` with a plain C interface. On first CUDA use
each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/tvidz_tpu_torch/`` (named by the source's content hash, so an
edited source never loads a stale build) and bound with ``ctypes``. Every C
entry point takes device pointers and the CUDA stream as ``void*``, launches
on that stream, and returns ``cudaGetLastError()``; ``Kernel.call`` raises
on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import torch

ENV_DEVICE = "TVIDZ_TORCH_DEVICE"

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tvidz_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def set_full_precision() -> None:
    """TF32 off everywhere: Hopper's form of the reference's
    ``Precision.HIGHEST`` invariant. Hash bits are thresholded at the median
    of 64 coefficients, so reduced-precision products flip bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device every tensor of the port lives on (see module note)."""
    name = device if device is not None else os.environ.get(ENV_DEVICE) or "cuda"
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tvidz_tpu_torch needs a CUDA device and none is available; "
                "pass device='cpu' (CLI: --device cpu, env: "
                f"{ENV_DEVICE}=cpu) to run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    set_full_precision()
    return dev


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "toolkit is needed to build tvidz_tpu_torch's kernels")


class Kernel:
    """One hand-written CUDA source, its lazily built library, and the count
    of launches its Python wrappers made (raised by ``launch``, and nowhere
    else)."""

    def __init__(self, name: str, replaces: str,
                 entry_points: Dict[str, Sequence[type]]):
        self.name = name
        self.replaces = replaces
        self.source = os.path.join(CSRC_DIR, f"{name}.cu")
        self.launches = 0
        self.build_log = ""
        self._entry_points = entry_points
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def repo_source(self) -> str:
        return os.path.relpath(self.source, os.path.dirname(_PKG_DIR))

    def library(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load(self._build())
            return self._lib

    def _build(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f"lib{self.name}-{digest}.so")
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source} (exit {proc.returncode}):\n"
                f"{self.build_log[-4000:]}")
        os.replace(tmp, out)
        return out

    def _load(self, path: str) -> ctypes.CDLL:
        lib = ctypes.CDLL(path)
        for fn, argtypes in self._entry_points.items():
            sym = getattr(lib, fn)
            sym.argtypes = list(argtypes)
            sym.restype = ctypes.c_int
        lib.tvz_error_string.argtypes = [ctypes.c_int]
        lib.tvz_error_string.restype = ctypes.c_char_p
        return lib

    def call(self, fn: str, *args) -> None:
        """Run one C entry point; raise with CUDA's message on a failed
        launch (a refused launch never runs, and a later synchronize would
        not report it)."""
        lib = self.library()
        rc = getattr(lib, fn)(*args)
        if rc != 0:
            msg = lib.tvz_error_string(rc).decode(errors="replace")
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc} ({msg})")

    def launch(self, fn: str, device: torch.device, *args) -> None:
        """Launch the kernel through entry point ``fn`` on ``device``'s
        current stream (passed as the last argument), and count it. The
        entry points launch on the current CUDA device and keep per-device
        state, so ``device`` is made current for the call."""
        with torch.cuda.device(device):
            self.call(fn, *args, stream_ptr(device))
        self.launches += 1


KERNELS: List[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    KERNELS.append(kernel)
    return kernel


def build_all() -> None:
    """Build and load every registered kernel now (first use would too):
    one nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(KERNELS) or 1) as pool:
        for f in [pool.submit(k.library) for k in KERNELS]:
            f.result()


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device`` (an index-bearing device, as
    ``resolve_device`` gives), by PyTorch's raw-stream query: a kernel call
    pays for this on every launch."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))


def require(t: torch.Tensor, what: str, dtype: torch.dtype, shape=None,
            device: Optional[torch.device] = None) -> None:
    """The checks every kernel wrapper makes before passing a pointer."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
