"""Build, load and launch the package's hand-written CUDA kernels.

The sources under `csrc/` are compiled with nvcc, one process per source
and all at once, and linked into one shared library with a plain C
interface, at first use, into `_build/<hash of the sources and flags>/`.
Each C entry point launches one kernel on the stream it is given and
returns `cudaGetLastError()`. Importing this module needs neither nvcc nor
a GPU: nothing is built until a kernel is launched on a CUDA tensor (or
`load()` is called).

Every kernel is a `Kernel`: it carries its launch count, which a caller
can reset and read to show that a run went through the kernel, and the
name of the TPU kernel it replaces. A kernel may have one C entry point
per storage type (the stencil kernels take float32 or bfloat16 images);
launches of every instance count toward the one kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
LIB_NAME = "libcapsaicin_kernels.so"
# --fmad=false: contracting a*b+c into an FMA moves det/u/v of the
# triangle test by an ulp and flips hits on triangle edges against the
# plain versions; fast math would change powf/expf/sqrtf/division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)
# the C entry point of each storage type: "<symbol><suffix>"
STORAGE_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}

vp = ctypes.c_void_p
i32 = ctypes.c_int
f32 = ctypes.c_float


def _sources() -> List[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def _run(procs):
    """Wait for every (cmd, Popen); raise with the output of the first failure."""
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}"
    if failed:
        raise RuntimeError(failed)


def build(path: Optional[str] = None) -> str:
    """Compile every .cu under csrc/ (one nvcc per source, started
    together) and link them into the shared library at `path`."""
    path = path or library_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = find_nvcc()
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    try:
        _run(procs)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


class Kernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence, source: str,
                 replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.source = source  # path in the repository
        self.replaces = replaces  # file:line of the TPU kernel
        self.launches = 0
        self._fns = {}

    def launch(self, device: torch.device, *args, storage: torch.dtype = torch.float32):
        """Launch the instance for `storage` on `device`'s current stream;
        raise if the launch failed. `args` are the C arguments before the
        trailing (device, stream)."""
        fn = self._fns.get(storage)
        if fn is None:
            fn = getattr(_library(), self.symbol + STORAGE_SUFFIX[storage])
            fn.argtypes = [*self.argtypes, i32, vp]
            fn.restype = i32
            self._fns[storage] = fn
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, device.index or 0, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
        self.launches += 1


REGISTRY: List[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    REGISTRY.append(kernel)
    return kernel


def reset_counts():
    for k in REGISTRY:
        k.launches = 0


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                build(path)
            _lib = ctypes.CDLL(path)
        return _lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; returns the handle."""
    return _library()


def call(symbol: str, argtypes: Sequence, *args) -> int:
    """Call a C function of the library that launches no kernel (a query
    of a kernel's attributes); returns its error code. Counts nothing."""
    fn = getattr(_library(), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = i32
    return fn(*args)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
               device: Optional[torch.device] = None, align: int = 1):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape` and `device`, where given) whose data is `align`-byte aligned."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: must be {align}-byte aligned")


def on_cpu(t: torch.Tensor) -> bool:
    """True where a wrapper takes its plain version: the tensor lies on the
    CPU. A CUDA tensor launches the kernel; any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"no kernel for device {t.device}")
