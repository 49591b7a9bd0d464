"""Streaming (beyond-host-RAM) Beagle ingest.

The reference reader materializes the full ``[M, 2N]`` GL matrix on the
host (reader_cy.pyx:71), capping M at host RAM.  Here the file is parsed in
site blocks — one sequential decompression pass — and each block is shipped
to the device mesh immediately, so peak host memory is O(block) while the
data lives SNP-sharded in device HBM:

    parse block i+1 (prefetch thread)  ||  H2D + placement of block i

Two block sources:

- the native C++ stream (``_native.open_beagle_stream``): zlib inflate +
  threaded tokenization with a stateful handle;
- a pandas ``read_csv(chunksize=...)`` fallback with identical results.

:func:`wgsassign_tpu_torch.models.common.stream_to_device` drives this iterator
into a :class:`DeviceCohort`.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

Block = Tuple[np.ndarray, List[str]]  # (gl [b, N, 2] float32, site names)


@dataclass
class BeagleStreamMeta:
    """Header/dimension info known before any GL rows are parsed.

    Stands in for :class:`~wgsassign_tpu_torch.io.beagle.BeagleData` in analyses
    that only need metadata (the GL matrix lives on device)."""

    n_sites: int
    n_inds: int
    sample_names: List[str]

    @property
    def site_names(self):
        raise RuntimeError(
            "site names are not retained under streamed ingest "
            "(--stream_ingest); analyses needing the global site list "
            "(--loo_downsampled_beagle) require in-memory ingest"
        )


def _iter_blocks_python(path: str, block_rows: int,
                        row_range=None) -> Iterator[Block]:
    import pandas as pd

    from wgsassign_tpu_torch.io.beagle import _open_maybe_gzip

    lo, hi = (0, None) if row_range is None else row_range
    budget = None if hi is None else hi - lo
    if budget is not None and budget <= 0:
        return
    with _open_maybe_gzip(path) as f:
        header = f.readline().decode()
        tokens = header.split()
        n_cols = len(tokens)
        if n_cols < 6 or (n_cols - 3) % 3 != 0:
            raise ValueError(
                f"Malformed Beagle header in {path}: {n_cols} columns "
                "(expected 3 + 3*N_individuals)"
            )
        n_inds = (n_cols - 3) // 3
        # skip to the window start counting DATA rows (blank lines don't
        # count — row offsets are computed in data-row space everywhere
        # else; pandas' skiprows counts raw lines and would mis-align
        # multi-host windows on files with blank lines)
        skipped = 0
        while skipped < lo:
            line = f.readline()
            if not line:
                return  # window starts at/after EOF
            if line.strip():
                skipped += 1
        # dtype=object for the marker column: pandas' pyarrow-backed
        # string arrays are not safe to construct off the main thread
        # (segfaults under the prefetch worker); plain object strings are.
        try:
            reader = pd.read_csv(
                f, sep="\t", header=None, dtype={0: object}, na_filter=False,
                chunksize=block_rows,
            )
            chunks = iter(reader)
        except pd.errors.EmptyDataError:  # window starts at/after EOF
            return
        for df in chunks:
            if df.shape[1] != n_cols:
                raise ValueError(
                    f"Malformed Beagle body in {path}: rows have "
                    f"{df.shape[1]} columns, header has {n_cols}"
                )
            if budget is not None and df.shape[0] > budget:
                df = df.iloc[:budget]
            sites = df.iloc[:, 0].tolist()
            body = df.iloc[:, 3:].to_numpy(dtype=np.float32)
            gl3 = body.reshape(body.shape[0], n_inds, 3)
            yield np.ascontiguousarray(gl3[:, :, :2]), sites
            if budget is not None:
                budget -= df.shape[0]
                if budget <= 0:
                    return


def _iter_blocks_native(stream, block_rows: int,
                        row_range=None) -> Iterator[Block]:
    try:
        budget = None
        if row_range is not None:
            lo, hi = row_range
            budget = hi - lo
            if budget <= 0:
                return
            if lo and stream.skip_rows(lo) < lo:
                return  # window starts at/after EOF
        while True:
            want = block_rows if budget is None else min(block_rows, budget)
            block = stream.next_block(want)
            if block is None:
                return
            yield block
            if budget is not None:
                budget -= block[0].shape[0]
                if budget <= 0:
                    return
    finally:
        stream.close()


def open_block_iterator(
    path: str, block_rows: int, use_native: bool = True, n_threads=None,
    row_range=None, dims=None,
) -> Tuple[BeagleStreamMeta, Iterator[Block]]:
    """Dimension scan + sequential block iterator over a Beagle file.

    Returns the stream metadata (``m``/``n``/sample names, known up front
    from the dims scan and header) and a generator of
    ``(gl [b, N, 2], site_names)`` blocks, each with ``b <= block_rows``.
    ``n_threads`` caps the native tokenizer's thread pool (None = all cores).
    ``row_range=(lo, hi)`` yields only data rows lo..hi-1 (the per-process
    window of a multi-host streamed ingest; skipped rows are decompressed
    and line-counted but never float-tokenized).  ``dims`` provides a
    pre-computed ``(m, n)`` to skip the dimensions scan.
    """
    from wgsassign_tpu_torch.io.beagle import beagle_dims

    m, n = beagle_dims(path, use_native=use_native) if dims is None else dims
    sample_names = None
    it: Optional[Iterator[Block]] = None
    if use_native:
        try:
            from wgsassign_tpu_torch._native import open_beagle_stream

            stream = open_beagle_stream(path, n_threads=n_threads)
            if stream is not None:
                sample_names = stream.sample_names
                it = _iter_blocks_native(stream, block_rows, row_range)
        except ImportError:
            pass
    if it is None:
        from wgsassign_tpu_torch.io.beagle import _open_maybe_gzip

        with _open_maybe_gzip(path) as f:
            sample_names = f.readline().decode().split()[3::3]
        it = _iter_blocks_python(path, block_rows, row_range)
    if len(sample_names) != n:
        raise ValueError(f"Malformed Beagle header in {path}")
    return BeagleStreamMeta(m, n, sample_names), it


def prefetch(it: Iterator[Block], depth: int = 2) -> Iterator[Block]:
    """Run a block iterator in a background thread with a bounded queue, so
    parsing block i+1 overlaps device placement of block i (the double
    buffer of the H2D pipeline)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _SENTINEL = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_SENTINEL)
        except BaseException as e:  # propagate parse errors to the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            t.join()
            return
        if isinstance(item, BaseException):
            t.join()
            raise item
        yield item
