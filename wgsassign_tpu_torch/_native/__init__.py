"""ctypes bindings + lazy build for the native Beagle parser.

The port's own copy of ``wgsassign_tpu/_native``; ``beagle_reader.cpp`` is
the same source but for three ``#if`` / ``#endif`` pairs that keep its SWAR
digit parse (an 8-byte load read as little-endian) to little-endian
targets.  The shared library is built on first use with g++ into
``build/wgsassign_tpu_torch_native/<hash>/`` at the root of the checkout,
or under ``WGSA_COMPILE_CACHE`` (see
:mod:`wgsassign_tpu_torch.compile_cache`); never next to this module: the
``-march=native`` library belongs to the CPU that built it, so the hash
covers the host's CPU besides the source and flags.  It is
written under a temporary name and renamed into place; if no toolchain/zlib
is available every caller falls back to the pure-Python parser
transparently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from wgsassign_tpu_torch.compile_cache import build_root, host_key

_SRC = Path(__file__).resolve().parent / "beagle_reader.cpp"
BUILD_NAME = "wgsassign_tpu_torch_native"
LIB_NAME = "libbeagle_reader.so"
_GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_build_failed = False


class _BeagleResult(ctypes.Structure):
    _fields_ = [
        ("m", ctypes.c_int64),
        ("n", ctypes.c_int64),
        ("gl", ctypes.POINTER(ctypes.c_float)),
        ("sample_names", ctypes.c_char_p),
        ("site_names", ctypes.c_char_p),
        ("error", ctypes.c_char_p),
    ]


class _AdResult(ctypes.Structure):
    _fields_ = [
        ("m", ctypes.c_int64),
        ("cols", ctypes.c_int64),
        ("data", ctypes.POINTER(ctypes.c_int32)),
        ("error", ctypes.c_char_p),
    ]


def library_path() -> Path:
    """Where this source's library lives: keyed by a hash of the source, the
    flags and the host's CPU, so an edited reader never loads a stale build
    and a shared ``WGSA_COMPILE_CACHE`` never hands one CPU another's
    ``-march=native`` code."""
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    h.update(host_key().encode())
    h.update(_SRC.read_bytes())
    return build_root(BUILD_NAME) / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple:
    """Compile the library unless this source hash is built already.
    Returns ``(path, seconds spent compiling)``, with path None when g++ or
    zlib is missing or the compile failed."""
    path = library_path()
    if path.exists():
        return str(path), 0.0
    t0 = time.perf_counter()
    built = _compile(path)
    return built, time.perf_counter() - t0


def _compile(path: Path) -> Optional[str]:
    tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    # The library is always compiled on the machine that runs it (lazy local
    # build), so -march=native is safe and speeds up the SWAR token parse;
    # retried without it for toolchains that reject the flag.
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        for extra in (["-march=native"], []):
            cmd = ["g++", *_GXX_FLAGS, *extra, str(_SRC), "-o", str(tmp),
                   "-lz", "-lpthread"]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
            except subprocess.CalledProcessError:
                continue
            os.replace(tmp, path)
            return str(path)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return None


def native_available() -> bool:
    """True when the native library is built (now, if need be) and loaded;
    False when every reader will take the pure-Python fallback."""
    return _get_lib() is not None


def _get_lib():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path, _ = build()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.beagle_read.restype = ctypes.POINTER(_BeagleResult)
        lib.beagle_read.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.beagle_read_range.restype = ctypes.POINTER(_BeagleResult)
        lib.beagle_read_range.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.beagle_dims.restype = ctypes.c_int
        lib.beagle_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.beagle_free.restype = None
        lib.beagle_free.argtypes = [ctypes.POINTER(_BeagleResult)]
        lib.beagle_stream_open.restype = ctypes.c_void_p
        lib.beagle_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.beagle_stream_header.restype = ctypes.POINTER(_BeagleResult)
        lib.beagle_stream_header.argtypes = [ctypes.c_void_p]
        lib.beagle_stream_next.restype = ctypes.POINTER(_BeagleResult)
        lib.beagle_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.beagle_stream_skip.restype = ctypes.c_int64
        lib.beagle_stream_skip.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.beagle_stream_close.restype = None
        lib.beagle_stream_close.argtypes = [ctypes.c_void_p]
        lib.ad_read.restype = ctypes.POINTER(_AdResult)
        lib.ad_read.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ad_free.restype = None
        lib.ad_free.argtypes = [ctypes.POINTER(_AdResult)]
        _lib = lib
        return _lib


def read_beagle_native(path: str, n_threads: Optional[int] = None,
                       row_range=None):
    """Parse with the C++ loader; returns a BeagleData or None when the
    native library is unavailable.  Raises ValueError on malformed input.

    ``row_range=(lo, hi)`` parses only data rows lo..hi-1 (the multi-host
    per-process shard-loading window); sample names still come from the
    header, site names cover only the window.
    """
    lib = _get_lib()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = max(os.cpu_count() or 1, 1)
    if row_range is None:
        res = lib.beagle_read(path.encode(), int(n_threads))
    else:
        lo, hi = row_range
        res = lib.beagle_read_range(
            path.encode(), int(n_threads), int(lo), int(hi)
        )
    if not res:
        return None
    try:
        if res.contents.error:
            raise ValueError(
                f"Malformed Beagle file {path}: {res.contents.error.decode()}"
            )
        m, n = res.contents.m, res.contents.n
        if m > 0:
            flat = np.ctypeslib.as_array(res.contents.gl, shape=(m, n, 2)).copy()
        else:  # empty row window (lo >= file rows)
            flat = np.empty((0, n, 2), dtype=np.float32)
        samples = res.contents.sample_names.decode().splitlines()
        sites = res.contents.site_names.decode().splitlines()
    finally:
        lib.beagle_free(res)

    from wgsassign_tpu_torch.io.beagle import BeagleData

    if len(samples) != n or len(sites) != m:
        raise ValueError(f"Malformed Beagle file {path}: name/shape mismatch")
    return BeagleData(flat, samples, sites)


def beagle_dims_native(path: str):
    """Fast (header + newline count, no float parsing) dimensions scan.
    Returns ``(m_sites, n_inds)`` or None when the native library is
    unavailable.  Raises ValueError on malformed input."""
    lib = _get_lib()
    if lib is None:
        return None
    m = ctypes.c_int64()
    n = ctypes.c_int64()
    rc = lib.beagle_dims(path.encode(), ctypes.byref(m), ctypes.byref(n))
    if rc == 1:
        raise FileNotFoundError(f"Beagle file doesn't exist: {path}")
    if rc != 0:
        raise ValueError(f"Malformed Beagle file {path} (dims scan rc={rc})")
    return int(m.value), int(n.value)


class NativeBeagleStream:
    """Stateful sequential block reader over the native stream API.

    One decompression pass over the file; each :meth:`next_block` call
    returns the next ``<= max_rows`` data rows as ``(gl [b, N, 2],
    site_names)`` or ``None`` at EOF.  Peak native memory is O(block).
    Use :func:`open_beagle_stream` (returns None when the library is
    unavailable, so callers can fall back to the pure-Python reader).
    """

    def __init__(self, lib, handle, n_inds, sample_names):
        self._lib = lib
        self._handle = handle
        self.n_inds = n_inds
        self.sample_names = sample_names

    def next_block(self, max_rows: int):
        res = self._lib.beagle_stream_next(self._handle, int(max_rows))
        try:
            if res.contents.error:
                raise ValueError(
                    f"Malformed Beagle file: {res.contents.error.decode()}"
                )
            m, n = res.contents.m, res.contents.n
            if m == 0:
                return None
            gl = np.ctypeslib.as_array(res.contents.gl, shape=(m, n, 2)).copy()
            sites = res.contents.site_names.decode().splitlines()
        finally:
            self._lib.beagle_free(res)
        if len(sites) != m:
            raise ValueError("Malformed Beagle file: site/shape mismatch")
        return gl, sites

    def skip_rows(self, n_rows: int) -> int:
        """Skip the next ``n_rows`` data rows without tokenizing floats
        (decompression + line counting only).  Returns rows actually
        skipped — fewer than requested only at EOF."""
        got = self._lib.beagle_stream_skip(self._handle, int(n_rows))
        if got < 0:
            raise ValueError("Malformed Beagle file: gzip stream error")
        return int(got)

    def close(self):
        if self._handle:
            self._lib.beagle_stream_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_int_matrix_native(path: str, n_threads: Optional[int] = None):
    """Parse a whitespace-delimited int32 matrix (allele-depth files, plain
    or gzipped) with the native threaded tokenizer.  Returns an ``[M, C]``
    int32 array, or None when the library is unavailable.  Raises
    ValueError on malformed input (ragged rows, non-integer tokens)."""
    lib = _get_lib()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = max(os.cpu_count() or 1, 1)
    res = lib.ad_read(path.encode(), int(n_threads))
    if not res:
        return None
    try:
        if res.contents.error:
            msg = res.contents.error.decode()
            if "cannot open" in msg:
                raise FileNotFoundError(msg)
            raise ValueError(f"Malformed allele-depth file {path}: {msg}")
        m, cols = res.contents.m, res.contents.cols
        if m > 0 and cols > 0:
            out = np.ctypeslib.as_array(
                res.contents.data, shape=(m, cols)
            ).copy()
        else:
            out = np.empty((0, max(cols, 0)), dtype=np.int32)
    finally:
        lib.ad_free(res)
    return out


def open_beagle_stream(path: str, n_threads: Optional[int] = None):
    """Open a native sequential block stream; None when unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = max(os.cpu_count() or 1, 1)
    handle = lib.beagle_stream_open(path.encode(), int(n_threads))
    hdr = lib.beagle_stream_header(handle)
    try:
        if hdr.contents.error:
            msg = hdr.contents.error.decode()
            lib.beagle_stream_close(handle)
            if "cannot open" in msg:
                raise FileNotFoundError(msg)
            raise ValueError(f"Malformed Beagle file {path}: {msg}")
        n = int(hdr.contents.n)
        samples = hdr.contents.sample_names.decode().splitlines()
    finally:
        lib.beagle_free(hdr)
    return NativeBeagleStream(lib, handle, n, samples)
