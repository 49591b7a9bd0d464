"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with :mod:`ctypes` (no PyTorch
headers, so the build takes seconds).  The build happens at first use, into
``build/wgsassign_tpu_torch_kernels/<hash>/`` at the root of the checkout,
keyed by a hash of the sources and flags; it is written under a temporary
name and renamed into place, so concurrent first uses never load a
half-written library.

Each exported C function takes the device index and the stream, launches on
that stream, allocates nothing and returns ``cudaGetLastError()``;
:func:`launch` raises on a non-zero code.  ``launches`` counts, per kernel,
the launches the wrappers made.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "wgsassign_tpu_torch_kernels")
SOURCES = ("probe.cu", "em_chunk.cu", "loo_chunk.cu")
HEADERS = ("common.cuh",)
# -fmad=false: every multiply and add rounds on its own, as in the plain
# twins (see csrc/common.cuh); no --use_fast_math, so '/' is IEEE-rounded
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libwgsassign_kernels.so"

# A shared memory tile may take up to 227 KB on Hopper (after
# cudaFuncSetAttribute).
SMEM_LIMIT = 232448

launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wg_probe": (_I, _P, _P, _I, _P),
    "wg_em_chunk": (_I, _P, _P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "wg_loo_chunk": (_I, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _source_hash() / LIB_NAME


def build() -> tuple:
    """Compile the library unless this source hash is built already.
    Returns ``(path, seconds spent compiling)``; the compiler's resource
    report (``-Xptxas -v``) is kept beside the library as ``ptxas.log``."""
    path = library_path()
    if path.exists():
        return path, 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    (path.parent / "ptxas.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built at first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.wg_error_string.argtypes = [ctypes.c_int]
    lib.wg_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call ``wg_<name>`` on ``device`` and the current stream; raise if it
    reports an error, count the launch otherwise."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, f"wg_{name}")(device.index or 0, *args, stream)
    if rc != 0:
        msg = lib.wg_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")
    launches[name] += 1


def probe(device: torch.device) -> None:
    """Launch ``y = x + 1`` on an (8, 128) float32 tile and check it on the
    host; raises if the library does not build, load or run here."""
    device = torch.device(device)
    x = torch.zeros((8, 128), dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    launch("probe", device, x.data_ptr(), y.data_ptr(), x.numel())
    torch.cuda.synchronize(device)
    if not bool(torch.all(y == 1.0)):
        raise RuntimeError("CUDA probe kernel returned wrong values")


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what a kernel's raw pointer arithmetic assumes)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
