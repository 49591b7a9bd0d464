"""Device-resident cohort, streamed ingest and array conversion."""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from wgsassign_tpu_torch.parallel.runtime import (
    PAD_AF,
    PAD_G0,
    PAD_G1,
    Runtime,
    pad_sites,
    site_weight_vector,
)


@dataclass
class DeviceCohort:
    """Genotype likelihood panels resident on ``runtime.device``.

    ``g0``/``g1`` are float32 ``[M_pad, N]``; ``site_weight`` is 1.0 on the
    first ``m_real`` rows, 0.0 on padding (which holds the (1, 0) GL
    pattern).
    """

    g0: torch.Tensor
    g1: torch.Tensor
    site_weight: torch.Tensor
    m_real: int
    runtime: Runtime

    @property
    def m_pad(self) -> int:
        return self.g0.shape[0]

    @property
    def n_inds(self) -> int:
        return self.g0.shape[1]


def to_device(beagle, runtime: Runtime, site_multiple: int = 1) -> DeviceCohort:
    """Pad a parsed :class:`wgsassign_tpu_torch.io.beagle.BeagleData` to a
    multiple of ``site_multiple`` sites (the ``--partition_sites`` count)
    and copy it to the device, one host-to-device copy per GL plane."""
    g0_h = pad_sites(np.ascontiguousarray(beagle.gl[:, :, 0]), site_multiple,
                     PAD_G0)
    g1_h = pad_sites(np.ascontiguousarray(beagle.gl[:, :, 1]), site_multiple,
                     PAD_G1)
    m_real = beagle.n_sites
    w = site_weight_vector(m_real, g0_h.shape[0])
    g0, g1, sw = from_jax_arrays(g0_h, g1_h, w, device=runtime.device)
    return DeviceCohort(g0=g0, g1=g1, site_weight=sw, m_real=m_real,
                        runtime=runtime)


def from_jax_arrays(*arrays, device) -> tuple:
    """NumPy arrays of the JAX package (GL planes ``[M, N]``, ``[K, M]`` AF
    panels, ``pop_af.npy`` ``[M, K]``, index tables) as tensors on
    ``device``.  The port keeps the JAX package's layouts at its public
    functions, so this is a plain copy: floating arrays become float32,
    integer and boolean arrays keep their type."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        if a.dtype.kind == "f":
            a = a.astype(np.float32, copy=False)
        out.append(torch.from_numpy(a).to(device))
    return tuple(out)


def pad_af_to(af: np.ndarray, m_pad: int) -> np.ndarray:
    """Pad an ``[M, K]`` AF panel's site axis up to ``m_pad`` with 0.5."""
    m = af.shape[0]
    if m == m_pad:
        return af
    return np.pad(af, [(0, m_pad - m), (0, 0)], constant_values=PAD_AF)


def _stream_overlap_default() -> bool:
    """Whether parsing overlaps the device copies (a prefetch thread parses
    block i+1 while block i is staged and sent).

    The JAX package's rule, kept with its environment semantics: on hosts
    with few cores the tokenizer threads and the host-to-device transfer
    fight for the same CPUs, so strict parse/copy alternation is used below
    4 cores and overlap from 4 up.  Override with WGSA_STREAM_OVERLAP=0/1.
    """
    env = os.environ.get("WGSA_STREAM_OVERLAP")
    if env is not None:
        return env not in ("0", "false", "False")
    return (os.cpu_count() or 1) >= 4


class _Uploader:
    """Copies parsed ``[b, N, 2]`` blocks into rows of the ``g0``/``g1``
    planes on the device.

    On a GPU each block goes through one of two pinned host staging
    buffers, is sent with one ``non_blocking`` copy on a side stream, and
    its planes are split on the device.  Each staging buffer has an event,
    recorded after its copy, that is waited on before the buffer is filled
    again.  On the CPU the block is copied into the planes directly."""

    def __init__(self, g0, g1, block_rows: int, wait_each: bool):
        self.g0, self.g1 = g0, g1
        self.dev = g0.device
        self.wait_each = wait_each
        self.cuda = self.dev.type == "cuda"
        if self.cuda:
            shape = (block_rows, g0.shape[1], 2)
            self.staging = [torch.empty(shape, dtype=torch.float32,
                                        pin_memory=True) for _ in range(2)]
            self.events = [None, None]
            self.stream = torch.cuda.Stream(self.dev)
            # the planes' fill ran on the current stream
            self.stream.wait_stream(torch.cuda.current_stream(self.dev))
            self.turn = 0

    def put(self, lo: int, gl_block: np.ndarray) -> None:
        b = gl_block.shape[0]
        if not self.cuda:
            src = torch.from_numpy(gl_block)
            self.g0[lo:lo + b].copy_(src[:, :, 0])
            self.g1[lo:lo + b].copy_(src[:, :, 1])
            return
        s = self.turn
        self.turn ^= 1
        if self.events[s] is not None:
            self.events[s].synchronize()  # its last copy has landed
        host = self.staging[s][:b]
        host.numpy()[...] = gl_block
        with torch.cuda.stream(self.stream):
            block = host.to(self.dev, non_blocking=True)
            self.g0[lo:lo + b].copy_(block[:, :, 0])
            self.g1[lo:lo + b].copy_(block[:, :, 1])
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.events[s] = ev
        if self.wait_each:
            # strict parse/copy alternation: the copy is done before the
            # tokenizer threads take the CPUs back
            ev.synchronize()

    def finish(self) -> None:
        if self.cuda:
            torch.cuda.current_stream(self.dev).wait_stream(self.stream)


def stream_to_device(
    path: str,
    runtime: Runtime,
    site_multiple: int = 1,
    block_rows: Optional[int] = None,
    use_native: bool = True,
    collect_site_names: bool = False,
    n_threads: Optional[int] = None,
    keep_mask: Optional[np.ndarray] = None,
):
    """Build a :class:`DeviceCohort` directly from a Beagle file in site
    blocks, without ever holding the full ``[M, N, 2]`` matrix on the host
    (counterpart of the single-process ``stream_to_device`` of
    ``wgsassign_tpu/models/common.py``).

    ``g0``/``g1`` ``[M_pad, N]`` are allocated on the device filled with
    the padding pattern, and each block parsed by
    :func:`wgsassign_tpu_torch.io.stream.open_block_iterator` is copied into
    its rows (see :class:`_Uploader`).  Peak host memory is O(block).  The
    cohort is bit-identical to ``to_device(read_beagle(path), runtime,
    site_multiple)`` (with ``keep_mask``: to the in-memory site
    intersection).

    ``block_rows`` defaults to ~256 MiB of parsed GLs per block.
    ``keep_mask`` (bool ``[file_rows]``) drops masked data rows on the fly
    -- the streamed form of the downsampled-LOO site intersection; the
    cohort then covers only the kept rows, in order.

    Returns ``(cohort, meta, site_names)``: ``meta`` is a
    :class:`wgsassign_tpu_torch.io.stream.BeagleStreamMeta`, ``site_names``
    None unless ``collect_site_names`` (an O(M) host list, for tests and small
    runs).
    """
    from wgsassign_tpu_torch.io.beagle import beagle_dims
    from wgsassign_tpu_torch.io.stream import (
        BeagleStreamMeta,
        open_block_iterator,
        prefetch,
    )

    m_scan, n = beagle_dims(path, use_native=use_native)
    if keep_mask is not None:
        keep_mask = np.asarray(keep_mask, dtype=bool)
        if keep_mask.shape[0] != m_scan:
            raise ValueError(
                f"keep_mask covers {keep_mask.shape[0]} rows, Beagle file "
                f"{path} has {m_scan}"
            )
        m_real = int(keep_mask.sum())
    else:
        m_real = m_scan
    mult = max(site_multiple, 1)
    m_pad = math.ceil(max(m_real, 1) / mult) * mult
    if block_rows is None:
        # ~256 MiB of parsed GL (2 float32s per site-individual) per block
        block_rows = max((256 << 20) // (8 * max(n, 1)), 1)

    meta, blocks = open_block_iterator(path, block_rows, use_native,
                                       n_threads=n_threads,
                                       dims=(m_scan, n))
    if keep_mask is not None:
        blocks = _rechunk_filtered(blocks, keep_mask, block_rows)

    dev = runtime.device
    g0 = torch.full((m_pad, n), PAD_G0, dtype=torch.float32, device=dev)
    g1 = torch.full((m_pad, n), PAD_G1, dtype=torch.float32, device=dev)
    overlap = _stream_overlap_default()
    uploader = _Uploader(g0, g1, block_rows, wait_each=not overlap)
    site_names = [] if collect_site_names else None
    done = 0
    for gl_block, names in (prefetch(blocks) if overlap else blocks):
        b = gl_block.shape[0]
        if done + b > m_real:
            raise ValueError(
                f"Beagle file {path} grew during streaming ingest "
                f"({done + b} rows > dims scan {m_real})"
            )
        uploader.put(done, gl_block)
        if site_names is not None:
            site_names.extend(names)
        done += b
    uploader.finish()
    if done != m_real:
        raise ValueError(
            f"Beagle file {path} shrank during streaming ingest "
            f"({done} rows < dims scan {m_real})"
        )
    (sw,) = from_jax_arrays(site_weight_vector(m_real, m_pad), device=dev)
    cohort = DeviceCohort(g0=g0, g1=g1, site_weight=sw, m_real=m_real,
                          runtime=runtime)
    return cohort, BeagleStreamMeta(m_scan, n, meta.sample_names), site_names


def _rechunk_filtered(blocks, keep_mask: np.ndarray, block_rows: int):
    """Apply a row keep-mask to a Beagle block stream and re-chunk the
    surviving rows into full ``block_rows`` blocks (+ one tail), so every
    block fits a staging buffer (copied from the JAX package)."""
    buf_gl, buf_names, have, pos = [], [], 0, 0
    for gl_block, names in blocks:
        b = gl_block.shape[0]
        sel = keep_mask[pos : pos + b]
        pos += b
        if sel.any():
            buf_gl.append(gl_block[sel])
            buf_names.append([nm for nm, k in zip(names, sel) if k])
            have += int(sel.sum())
        while have >= block_rows:
            gl_cat = np.concatenate(buf_gl) if len(buf_gl) > 1 else buf_gl[0]
            names_cat = [nm for chunk in buf_names for nm in chunk]
            yield gl_cat[:block_rows], names_cat[:block_rows]
            rest = gl_cat[block_rows:]
            buf_gl = [rest] if rest.shape[0] else []
            buf_names = [names_cat[block_rows:]] if rest.shape[0] else []
            have -= block_rows
    if have:
        gl_cat = np.concatenate(buf_gl) if len(buf_gl) > 1 else buf_gl[0]
        yield gl_cat, [nm for chunk in buf_names for nm in chunk]
