"""Gzipped-Beagle genotype-likelihood ingest.

File contract (ANGSD Beagle output; see reference reader_cy.pyx:16-77 for the
behavior being reproduced):

- header row: ``marker  allele1  allele2`` then 3 columns per individual, each
  triple labelled with the individual's sample name;
- each data row: site name (``chr_pos``), two allele codes, then the three
  genotype likelihoods ``P(D|g=0), P(D|g=1), P(D|g=2)`` per individual,
  normalized to sum to 1.

In-memory model: we keep ``gl`` as float32 ``[M_sites, N_inds, 2]`` holding
GL(g=0) and GL(g=1); GL(g=2) is reconstructed in-register as ``1 - g0 - g1``
everywhere downstream (same 2-of-3 contract as the reference's ``[M, 2N]``
matrix, laid out for TPU-friendly batched ops).

Two parsers are provided:

- a native C++ streaming parser (``wgsassign_tpu_torch._native``): zlib inflate +
  overlapped chunked tokenization, used when the extension is built;
- a pure-Python/pandas fallback with identical results.
"""

from __future__ import annotations

import gzip
import io as _io
import json
import math
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class BeagleData:
    """Parsed Beagle matrix.

    Attributes:
      gl: float32 ``[M, N, 2]`` — GL(g=0), GL(g=1) per (site, individual).
      sample_names: length-N list (may contain duplicates, as in ANGSD output).
      site_names: length-M list of ``chr_pos`` marker names.
    """

    gl: np.ndarray
    sample_names: List[str]
    site_names: List[str]

    @property
    def n_sites(self) -> int:
        return self.gl.shape[0]

    @property
    def n_inds(self) -> int:
        return self.gl.shape[1]

    def filter_sites(self, keep_mask: np.ndarray) -> "BeagleData":
        """Row-subset by boolean mask, preserving order."""
        keep_mask = np.asarray(keep_mask, dtype=bool)
        sites = [s for s, k in zip(self.site_names, keep_mask) if k]
        return BeagleData(self.gl[keep_mask], list(self.sample_names), sites)


@dataclass
class BeagleShard:
    """This process's contiguous row block of a Beagle file (multi-host).

    Each host parses only its own window (``read_beagle_sharded``), so no
    host ever materializes the full ``[M, N, 2]`` matrix.  Replaces the
    reference's full-parse-everywhere ingest (reader_cy.pyx:16-77) at pod
    scale.

    ``site_names`` are the *local* window's markers; operations needing the
    global site list (downsampled-LOO intersection) are unsupported in
    sharded mode and raise in the CLI.
    """

    local: BeagleData        # rows [lo, hi) of the file
    m_global: int            # total data rows in the file
    lo: int
    hi: int
    rows_per_process: int    # padded per-process block size

    @property
    def n_sites(self) -> int:
        return self.m_global

    @property
    def n_inds(self) -> int:
        return self.local.n_inds

    @property
    def sample_names(self) -> List[str]:
        return self.local.sample_names

    @property
    def site_names(self) -> List[str]:
        return self.local.site_names


def process_row_range(m_total: int, multiple: int = 1, rank: int = 0,
                      world: int = 1) -> tuple:
    """Contiguous row range ``(lo, hi, rows_per_process)`` owned by process
    ``rank`` of ``world`` (counterpart of
    ``wgsassign_tpu/parallel/mesh.py::process_row_range``, which asks JAX
    for both).  Ranges are block-contiguous, each padded to ``multiple``."""
    m_pad = math.ceil(m_total / (multiple * world)) * (multiple * world)
    per = m_pad // world
    lo = rank * per
    hi = min(m_total, lo + per)
    return lo, max(hi, lo), per


def read_beagle_sharded(path: str, site_multiple: int = 1,
                        use_native: bool = True, n_threads=None,
                        rank: int = 0, world: int = 1) -> BeagleShard:
    """Multi-process ingest: dimension scan, then parse only this process's
    contiguous row window.

    ``rank`` and ``world`` are this process's index and the process count
    (``torch.distributed``'s, one device per process); the window is padded
    to ``site_multiple`` rows per process.
    """
    m_global, _n = beagle_dims(path, use_native=use_native)
    lo, hi, per = process_row_range(m_global, multiple=max(site_multiple, 1),
                                    rank=rank, world=world)
    local = read_beagle(path, use_native=use_native, row_range=(lo, hi),
                        n_threads=n_threads)
    return BeagleShard(local=local, m_global=m_global, lo=lo, hi=hi,
                       rows_per_process=per)


def _open_maybe_gzip(path: str) -> _io.BufferedReader:
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f)  # type: ignore[return-value]
    return f


def _read_beagle_python(path: str, row_range=None) -> BeagleData:
    """Pure-Python parser (pandas C engine for the float block).

    ``row_range=(lo, hi)`` parses only data rows lo..hi-1 — the per-host
    shard-loading path for multi-host runs (each host reads its own
    contiguous block; see parallel.mesh.process_row_range).
    """
    import pandas as pd

    with _open_maybe_gzip(path) as f:
        header = f.readline().decode()
        tokens = header.split()
        n_cols = len(tokens)
        if n_cols < 3 or (n_cols - 3) % 3 != 0:
            raise ValueError(
                f"Malformed Beagle header in {path}: {n_cols} columns "
                "(expected 3 + 3*N_individuals)"
            )
        sample_names = tokens[3::3]
        n_inds = len(sample_names)
        kwargs = {}
        if row_range is not None:
            lo, hi = row_range
            if hi <= lo:  # empty window (e.g. more processes than rows)
                return BeagleData(
                    np.empty((0, n_inds, 2), np.float32), sample_names, []
                )
            kwargs = {"skiprows": lo, "nrows": hi - lo}
        try:
            df = pd.read_csv(
                f,
                sep="\t",
                header=None,
                dtype={0: str},
                na_filter=False,
                **kwargs,
            )
        except pd.errors.EmptyDataError:
            # a window starting at/after EOF parses as zero rows
            return BeagleData(
                np.empty((0, n_inds, 2), np.float32), sample_names, []
            )
    if df.shape[1] != n_cols:
        raise ValueError(
            f"Malformed Beagle body in {path}: rows have {df.shape[1]} columns, "
            f"header has {n_cols}"
        )
    site_names = df.iloc[:, 0].tolist()
    body = df.iloc[:, 3:].to_numpy(dtype=np.float32)
    m = body.shape[0]
    gl3 = body.reshape(m, n_inds, 3)
    gl = np.ascontiguousarray(gl3[:, :, :2])
    return BeagleData(gl, sample_names, site_names)


def read_beagle(path: str, use_native: bool = True, row_range=None,
                n_threads=None) -> BeagleData:
    """Parse a (gzipped) Beagle file into a :class:`BeagleData`.

    Prefers the native C++ streaming parser when available; falls back to the
    pure-Python implementation.  ``row_range=(lo, hi)`` restricts parsing to
    a contiguous data-row block (the per-host shard-loading window for
    multi-host runs — supported by both parsers; the native one stops
    decompressing at the end of the window).  ``n_threads`` caps the native
    parser's tokenizer thread pool (the CLI's ``--threads``; None = all
    cores).
    """
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Beagle file doesn't exist: {path}")
    if use_native:
        try:
            from wgsassign_tpu_torch._native import read_beagle_native

            result = read_beagle_native(
                path, n_threads=n_threads, row_range=row_range
            )
            if result is not None:
                return result
        except ImportError:
            pass
    return _read_beagle_python(path, row_range=row_range)


def _dims_cache_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "wgsassign_tpu", "beagle_dims.json")


def _dims_cache_key(path: str) -> Optional[str]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return f"{os.path.realpath(path)}|{st.st_size}|{st.st_mtime_ns}"


def _dims_cache_get(key: Optional[str]):
    if key is None:
        return None
    try:
        with open(_dims_cache_path()) as f:
            entry = json.load(f).get(key)
        if entry is not None:
            return int(entry[0]), int(entry[1])
    except (OSError, ValueError, TypeError):
        pass
    return None


def _dims_cache_put(key: Optional[str], m: int, n: int) -> None:
    if key is None:
        return
    cache_file = _dims_cache_path()
    try:
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        try:
            with open(cache_file) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data[key] = [int(m), int(n)]
        if len(data) > 256:  # keep the cache bounded; drop oldest inserts
            data = dict(list(data.items())[-256:])
        tmp = cache_file + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, cache_file)
    except OSError:
        pass  # cache is best-effort only


def beagle_dims(path: str, use_native: bool = True):
    """Dimensions ``(m_sites, n_inds)`` of a Beagle file without parsing any
    genotype likelihoods — header column count + data-row count.  Multi-host
    startup uses this to compute each process's row window.

    The count costs a full decompression pass over the file, so results are
    memoized in ``~/.cache/wgsassign_tpu/beagle_dims.json`` keyed by
    (realpath, size, mtime): on re-runs against an unchanged file — the
    common production loop — streamed ingest skips the scan pass entirely.
    Best-effort: any cache I/O failure silently falls back to scanning."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Beagle file doesn't exist: {path}")
    key = _dims_cache_key(path)
    cached = _dims_cache_get(key)
    if cached is not None:
        return cached
    dims = _beagle_dims_scan(path, use_native)
    _dims_cache_put(key, *dims)
    return dims


def _beagle_dims_scan(path: str, use_native: bool = True):
    if use_native:
        try:
            from wgsassign_tpu_torch._native import beagle_dims_native

            dims = beagle_dims_native(path)
            if dims is not None:
                return dims
        except ImportError:
            pass
    with _open_maybe_gzip(path) as f:
        tokens = f.readline().decode().split()
        n_cols = len(tokens)
        if n_cols < 6 or (n_cols - 3) % 3 != 0:
            raise ValueError(
                f"Malformed Beagle header in {path}: {n_cols} columns "
                "(expected 3 + 3*N_individuals)"
            )
        m = sum(1 for line in f if line.strip())
    return m, (n_cols - 3) // 3


def scan_header_samples(path: str) -> List[str]:
    """Sample names from a Beagle header (one line read) — lets callers
    fail the downsampled sample-name equality check before any heavy
    parsing."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Beagle file doesn't exist: {path}")
    with _open_maybe_gzip(path) as f:
        return f.readline().decode().split()[3::3]


def scan_site_names(path: str) -> List[str]:
    """Site-name (marker) column of a Beagle file, without parsing any
    genotype likelihoods.  One decompression pass, O(M) host strings —
    used by the multi-host downsampled-LOO intersection, where every host
    needs the *global* site lists of both files before cutting its filtered
    row window."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Beagle file doesn't exist: {path}")
    names: List[str] = []
    with _open_maybe_gzip(path) as f:
        f.readline()  # header
        for line in f:
            if line.strip():
                names.append(line.split(b"\t", 1)[0].split()[0].decode())
    return names


def scan_site_hashes(path: str, m: Optional[int] = None) -> np.ndarray:
    """64-bit content hashes of a Beagle file's site-name column, without
    materializing the names.  One decompression pass; host memory is
    O(M) * 8 bytes (a ``uint64`` array — the same order as the boolean
    keep masks the intersection produces) instead of ``scan_site_names``'s
    O(M) Python strings (~hundreds of MB at 5M sites).  The hash is
    keyed (blake2b, fixed key) and process-independent, so multi-host
    processes computing masks independently agree bit-for-bit.  With a
    64-bit digest, a collision among 5M names has probability ~7e-7 —
    and a cross-file collision surfaces as the intersection order check
    failing loudly, not as silent corruption."""
    from hashlib import blake2b

    if not os.path.isfile(path):
        raise FileNotFoundError(f"Beagle file doesn't exist: {path}")
    out = np.empty(m if m is not None else 4096, dtype=np.uint64)
    i = 0
    with _open_maybe_gzip(path) as f:
        f.readline()  # header
        for line in f:
            if not line.strip():
                continue
            tok = line.split(b"\t", 1)[0].split()[0]
            if i == out.size:
                out = np.concatenate([out, np.empty_like(out)])
            out[i] = int.from_bytes(
                blake2b(tok, digest_size=8).digest(), "little"
            )
            i += 1
    return out[:i]


def site_intersection_masks_hashed(h_full: np.ndarray, h_ds: np.ndarray):
    """Order-preserving reciprocal site intersection (reference
    WGSassign.py:176-196) computed on ``scan_site_hashes`` arrays —
    vectorized ``np.isin`` over uint64 instead of Python set membership
    over strings.  Same keep-mask semantics as
    :func:`site_intersection_masks`."""
    keep_full = np.isin(h_full, h_ds)
    kept = h_full[keep_full]
    if kept.size == 0:
        raise ValueError(
            "No common sites between the reference and downsampled Beagle "
            "files — the site-name columns are disjoint."
        )
    keep_ds = np.isin(h_ds, kept)
    if not np.array_equal(h_ds[keep_ds], kept):
        raise ValueError(
            "Site names in full and downsampled Beagle do not match after "
            "filtering."
        )
    print(f"\tRetained {kept.size} common sites "
          f"({h_full.size - kept.size} filtered from the reference, "
          f"{h_ds.size - kept.size} from the downsampled set).")
    return keep_full, keep_ds


def site_intersection_masks(names_full, names_ds):
    """Order-preserving reciprocal site intersection (the reference's
    downsampled-LOO rule, WGSassign.py:176-196) as boolean keep masks over
    each file's data rows.  Raises when the surviving orders disagree."""
    ds_set = set(names_ds)
    keep_full = np.fromiter(
        (s in ds_set for s in names_full), dtype=bool, count=len(names_full)
    )
    kept = [s for s, k in zip(names_full, keep_full) if k]
    if not kept:
        raise ValueError(
            "No common sites between the reference and downsampled Beagle "
            "files — the site-name columns are disjoint."
        )
    kept_set = set(kept)
    keep_ds = np.fromiter(
        (s in kept_set for s in names_ds), dtype=bool, count=len(names_ds)
    )
    if [s for s, k in zip(names_ds, keep_ds) if k] != kept:
        raise ValueError(
            "Site names in full and downsampled Beagle do not match after "
            "filtering."
        )
    print(f"\tRetained {len(kept)} common sites "
          f"({len(names_full) - len(kept)} filtered from the reference, "
          f"{len(names_ds) - len(kept)} from the downsampled set).")
    return keep_full, keep_ds


def read_beagle_sharded_filtered(
    path: str,
    keep_mask: np.ndarray,
    site_multiple: int = 1,
    n_threads=None,
    rank: int = 0,
    world: int = 1,
) -> BeagleShard:
    """Multi-host ingest of a row-filtered Beagle file.

    ``keep_mask`` is the global boolean keep mask over the file's data rows
    (order-preserving — e.g. a site intersection from
    :func:`scan_site_names`).  Each process computes its contiguous window
    over the *filtered* row index, maps it back to the smallest contiguous
    window of original rows (filtering preserves order), parses only that
    range, and drops the masked rows locally — no host ever parses the full
    file.
    """
    keep_mask = np.asarray(keep_mask, dtype=bool)
    positions = np.flatnonzero(keep_mask)
    m_filtered = int(positions.size)
    lo, hi, per = process_row_range(m_filtered, multiple=max(site_multiple, 1),
                                    rank=rank, world=world)
    if hi > lo:
        orig_lo = int(positions[lo])
        orig_hi = int(positions[hi - 1]) + 1
        local = read_beagle(
            path, row_range=(orig_lo, orig_hi), n_threads=n_threads
        )
        local = local.filter_sites(keep_mask[orig_lo:orig_hi])
        if local.n_sites != hi - lo:
            raise ValueError(
                f"Filtered window mismatch in {path}: parsed "
                f"{local.n_sites} kept rows, expected {hi - lo}"
            )
    else:  # this process's window is empty (more processes than rows)
        local = read_beagle(path, row_range=(0, 0), n_threads=n_threads)
    return BeagleShard(local=local, m_global=m_filtered, lo=lo, hi=hi,
                       rows_per_process=per)


def sharded_downsampled_pair(
    beagle_path: str,
    downsampled_path: str,
    site_multiple: int = 1,
    n_threads=None,
    rank: int = 0,
    world: int = 1,
):
    """Multi-host equivalent of the reference's downsampled-LOO site
    intersection (WGSassign.py:176-196): every host scans both files'
    global site-name columns, builds the order-preserving reciprocal
    intersection, then shard-loads only its filtered row window of each
    file.  Returns ``(beagle_shard, downsampled_shard)`` covering the
    common sites in reference order.
    """
    if scan_header_samples(beagle_path) != scan_header_samples(downsampled_path):
        raise ValueError(
            "Sample names in downsampled Beagle file do not match original."
        )
    keep_full, keep_ds = site_intersection_masks_hashed(
        scan_site_hashes(beagle_path), scan_site_hashes(downsampled_path)
    )
    full = read_beagle_sharded_filtered(
        beagle_path, keep_full, site_multiple, n_threads, rank, world
    )
    ds = read_beagle_sharded_filtered(
        downsampled_path, keep_ds, site_multiple, n_threads, rank, world
    )
    return full, ds


def filter_sites_to_common(data: BeagleData, target_site_names) -> BeagleData:
    """Keep only sites whose name appears in ``target_site_names`` (order
    preserved).  Mirrors reference utils.py:22-42."""
    target = set(target_site_names)
    mask = np.fromiter((s in target for s in data.site_names), dtype=bool, count=data.n_sites)
    num_filtered = int((~mask).sum())
    if num_filtered > 0:
        print(f"\tFiltered out {num_filtered} sites not present in the target site list.")
    return data.filter_sites(mask)


def to_legacy_matrix(data: BeagleData) -> np.ndarray:
    """Return the reference's ``[M, 2N]`` float32 layout (columns alternate
    GL(g=0), GL(g=1) per individual) — used only for compat checks/tests."""
    m, n, _ = data.gl.shape
    return np.ascontiguousarray(data.gl.reshape(m, 2 * n))
