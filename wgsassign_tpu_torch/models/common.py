"""Device-resident cohort, streamed ingest and array conversion."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from wgsassign_tpu_torch.parallel.runtime import (
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
    real rows, 0.0 on padding (which holds the (1, 0) GL pattern).

    With several ranks the tensors hold this rank's window of the site
    axis: global rows ``[lo, hi)`` in the first ``hi - lo`` local rows,
    padded to the per-rank block ``m_pad``.  ``m_real`` is the global site
    count on every rank (the RMSE denominator, the row count of the output
    files).  With one rank ``lo == 0`` and ``hi == m_real``.
    """

    g0: torch.Tensor
    g1: torch.Tensor
    site_weight: torch.Tensor
    m_real: int
    runtime: Runtime
    lo: int = 0
    hi: Optional[int] = None

    def __post_init__(self):
        if self.hi is None:
            self.hi = self.m_real

    @property
    def n_local(self) -> int:
        """Real sites in this rank's window."""
        return self.hi - self.lo

    @property
    def m_pad(self) -> int:
        return self.g0.shape[0]

    @property
    def n_inds(self) -> int:
        return self.g0.shape[1]


def to_device(beagle, runtime: Runtime, site_multiple: int = 1) -> DeviceCohort:
    """Pad a parsed :class:`wgsassign_tpu_torch.io.beagle.BeagleData` to a
    multiple of ``site_multiple`` sites (the ``--partition_sites`` count)
    and copy it to the device, one host-to-device copy per GL plane.  A
    :class:`wgsassign_tpu_torch.io.beagle.BeagleShard` (one rank's row
    window) goes through :func:`_shard_to_device`."""
    from wgsassign_tpu_torch.io.beagle import BeagleShard

    if isinstance(beagle, BeagleShard):
        return _shard_to_device(beagle, runtime, site_multiple)
    if runtime.world > 1:
        raise ValueError(
            "with several ranks each rank loads its own row window: use "
            "read_beagle_sharded(path, site_multiple, rank=..., world=...)")
    g0_h = pad_sites(np.ascontiguousarray(beagle.gl[:, :, 0]), site_multiple,
                     PAD_G0)
    g1_h = pad_sites(np.ascontiguousarray(beagle.gl[:, :, 1]), site_multiple,
                     PAD_G1)
    m_real = beagle.n_sites
    w = site_weight_vector(m_real, g0_h.shape[0])
    g0, g1, sw = from_jax_arrays(g0_h, g1_h, w, device=runtime.device)
    return DeviceCohort(g0=g0, g1=g1, site_weight=sw, m_real=m_real,
                        runtime=runtime)


def _shard_to_device(shard, runtime: Runtime,
                     site_multiple: int) -> DeviceCohort:
    """This rank's row block, padded to the per-rank block size with the
    (PAD_G0, PAD_G1) pattern and weight 0 (counterpart of
    ``_shard_to_device`` in the JAX package, which also assembles the
    global array)."""
    per = shard.rows_per_process
    if per % max(site_multiple, 1) != 0:
        raise ValueError(
            f"BeagleShard block size {per} is not a multiple of "
            f"{site_multiple}; re-read with read_beagle_sharded(path, "
            "site_multiple, ...)")
    n_local = shard.hi - shard.lo

    def pad_block(a: np.ndarray, fill) -> np.ndarray:
        out = np.full((per,) + a.shape[1:], fill, dtype=np.float32)
        out[: a.shape[0]] = a
        return out

    g0, g1, sw = from_jax_arrays(
        pad_block(shard.local.gl[:, :, 0], PAD_G0),
        pad_block(shard.local.gl[:, :, 1], PAD_G1),
        pad_block(np.ones(n_local, dtype=np.float32), 0.0),
        device=runtime.device)
    return DeviceCohort(g0=g0, g1=g1, site_weight=sw, m_real=shard.m_global,
                        runtime=runtime, lo=shard.lo, hi=shard.hi)


@dataclass
class DeviceDepths:
    """Allele depths (``--ind_ad_file``) resident beside a
    :class:`DeviceCohort`: ``counts`` is ``[M_pad, 2N]`` (major, minor read
    counts of each individual) over the cohort's rows, its window with
    several ranks, in uint8 where every count fits, else int32; padding
    rows hold 0.  ``col_max`` is each individual's largest count over the
    whole site axis (``[N]`` int64, on the host): it sizes the combo
    tables."""

    counts: torch.Tensor
    col_max: np.ndarray


def _narrowest(lo: int, hi: int) -> torch.dtype:
    if lo < 0:
        raise ValueError(f"allele depths must not be negative (found {lo})")
    if hi > 0x7FFFFFFF:
        raise ValueError(f"allele depth {hi} does not fit in int32")
    return torch.uint8 if hi <= 0xFF else torch.int32


def upload_allele_depths(ad: np.ndarray, cohort: DeviceCohort) -> DeviceDepths:
    """Copy a host ``[M, 2N]`` allele-depth matrix (``read_allele_depths``)
    to the cohort's device once: this rank's rows, padded to ``m_pad``,
    narrowed there by :func:`device_depths`.  Raises on a negative count."""
    ad = np.asarray(ad)
    if ad.ndim != 2 or ad.shape != (cohort.m_real, 2 * cohort.n_inds):
        raise ValueError(
            f"allele depths {ad.shape} do not match the cohort's "
            f"{cohort.m_real} sites x {cohort.n_inds} individuals")
    (counts,) = from_jax_arrays(local_rows(ad, cohort, 0),
                                device=cohort.runtime.device)
    return device_depths(counts, cohort)


def device_depths(counts: torch.Tensor, cohort: DeviceCohort) -> DeviceDepths:
    """Allele depths on the device (``[M_pad, 2N]``, integer, this rank's
    rows, padding rows 0) as :class:`DeviceDepths`, in uint8 where every
    count fits, else int32.  One small fetch: each
    individual's largest count (over all ranks) and the smallest count."""
    rt = cohort.runtime
    if counts.dtype.is_floating_point or counts.dtype == torch.bool:
        raise ValueError(f"allele depths have dtype {counts.dtype}")
    if tuple(counts.shape) != (cohort.m_pad, 2 * cohort.n_inds):
        raise ValueError(f"allele depths {tuple(counts.shape)}, expected "
                         f"{(cohort.m_pad, 2 * cohort.n_inds)}")
    # a max over the ranks by a sum: each rank fills its own row with its
    # individuals' largest counts and its negated smallest count
    rows = torch.zeros((rt.world, cohort.n_inds + 1), dtype=torch.long,
                       device=counts.device)
    if cohort.n_local:
        real = counts[: cohort.n_local].view(cohort.n_local, -1, 2)
        rows[rt.rank, :-1] = real.amax(dim=(0, 2))
        rows[rt.rank, -1] = -real.amin().long()
    rows = rt.all_reduce_sum(rows).cpu().numpy().max(axis=0)
    col_max, lo = rows[:-1].astype(np.int64), -int(rows[-1])
    return DeviceDepths(
        counts=counts.to(_narrowest(lo, int(col_max.max()))).contiguous(),
        col_max=col_max)


def local_rows(arr: np.ndarray, cohort: DeviceCohort, pad_value) -> np.ndarray:
    """The rows of a global ``[M, ...]`` host array that fall in the
    cohort's window, padded to its ``m_pad`` rows with ``pad_value``."""
    arr = np.asarray(arr)
    if cohort.lo == 0 and arr.shape[0] == cohort.m_pad:
        return arr
    out = np.full((cohort.m_pad,) + arr.shape[1:], pad_value, dtype=arr.dtype)
    out[: cohort.n_local] = arr[cohort.lo : cohort.hi]
    return out


def gather_real_sites(cohort: DeviceCohort, t: torch.Tensor, axis: int = 0,
                      to_all: bool = False) -> Optional[np.ndarray]:
    """The global real-site rows of a per-rank tensor whose ``axis`` is the
    local (padded) site axis, as a host array: on rank 0, or on every rank
    with ``to_all`` (None elsewhere)."""
    rt = cohort.runtime
    if rt.world == 1:
        return t.narrow(axis, 0, cohort.m_real).cpu().numpy()
    whole = rt.gather_sites(t, axis, to_all=to_all)
    if whole is None:
        return None
    return whole.narrow(axis, 0, cohort.m_real).numpy()


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


def _stream_overlap_default() -> bool:
    """Whether parsing overlaps the device copies (a prefetch thread parses
    block i+1 while block i is staged and sent).

    The JAX package's rule, kept with its environment semantics: on hosts
    with few cores the tokenizer threads and the host-to-device transfer
    fight for the same CPUs, so strict parse/copy alternation is used below
    4 cores and overlap from 4 up.  Override with WGSA_STREAM_OVERLAP: ``0``,
    ``false``, ``no`` and ``off`` in any case turn it off, anything else on.
    (The JAX package differs here: it reads only ``0``, ``false`` and
    ``False`` as off.)
    """
    env = os.environ.get("WGSA_STREAM_OVERLAP")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "no", "off")
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

    With several ranks (``runtime.world > 1``) each rank streams only its
    own contiguous row window, under ``keep_mask`` the window over the kept
    rows, into its block of the site axis.

    Returns ``(cohort, meta, site_names)``: ``meta`` is a
    :class:`wgsassign_tpu_torch.io.stream.BeagleStreamMeta`, ``site_names``
    None unless ``collect_site_names`` (an O(M) host list, for tests and small
    runs).
    """
    from wgsassign_tpu_torch.io.beagle import beagle_dims, process_row_range
    from wgsassign_tpu_torch.io.stream import (
        BeagleStreamMeta,
        open_block_iterator,
        prefetch,
    )

    rank, world = runtime.rank, runtime.world
    if collect_site_names and world > 1:
        raise ValueError(
            "collect_site_names would return only this rank's window when "
            "several ranks stream")
    m_scan, n = beagle_dims(path, use_native=use_native)
    positions = None
    if keep_mask is not None:
        keep_mask = np.asarray(keep_mask, dtype=bool)
        if keep_mask.shape[0] != m_scan:
            raise ValueError(
                f"keep_mask covers {keep_mask.shape[0]} rows, Beagle file "
                f"{path} has {m_scan}"
            )
        positions = np.flatnonzero(keep_mask)
        m_real = int(positions.size)
    else:
        m_real = m_scan
    # this rank's window [lo, hi) over the kept rows; ``per`` is the padded
    # block every rank holds.  A rank whose whole window lies in the padded
    # tail sees an empty window (hi == lo).
    lo, hi, per = process_row_range(max(m_real, 1), max(site_multiple, 1),
                                    rank, world)
    hi = max(lo, min(hi, m_real))
    n_local = hi - lo
    if block_rows is None:
        # ~256 MiB of parsed GL (2 float32s per site-individual) per block
        block_rows = max((256 << 20) // (8 * max(n, 1)), 1)

    # the window mapped back to the smallest range of original rows
    # (filtering preserves order); rows before it are inflated and
    # line-counted, never tokenized
    local_mask = None
    if world == 1:
        row_range = None
        local_mask = keep_mask
    elif n_local == 0:
        row_range = (0, 0)
    elif positions is not None:
        row_range = (int(positions[lo]), int(positions[hi - 1]) + 1)
        local_mask = keep_mask[row_range[0]:row_range[1]]
    else:
        row_range = (lo, hi)
    meta, blocks = open_block_iterator(path, block_rows, use_native,
                                       n_threads=n_threads,
                                       row_range=row_range,
                                       dims=(m_scan, n))
    if local_mask is not None:
        blocks = _rechunk_filtered(blocks, local_mask, block_rows)

    dev = runtime.device
    g0 = torch.full((per, n), PAD_G0, dtype=torch.float32, device=dev)
    g1 = torch.full((per, n), PAD_G1, dtype=torch.float32, device=dev)
    overlap = _stream_overlap_default()
    uploader = _Uploader(g0, g1, block_rows, wait_each=not overlap)
    site_names = [] if collect_site_names else None
    done = 0
    for gl_block, names in (prefetch(blocks) if overlap else blocks):
        b = gl_block.shape[0]
        if done + b > n_local:
            raise ValueError(
                f"Beagle file {path} grew during streaming ingest "
                f"({lo + done + b} rows > dims scan {hi})"
            )
        uploader.put(done, gl_block)
        if site_names is not None:
            site_names.extend(names)
        done += b
    uploader.finish()
    if done != n_local:
        raise ValueError(
            f"Beagle file {path} shrank during streaming ingest "
            f"({lo + done} rows < dims scan {hi})"
        )
    (sw,) = from_jax_arrays(site_weight_vector(n_local, per), device=dev)
    cohort = DeviceCohort(g0=g0, g1=g1, site_weight=sw, m_real=m_real,
                          runtime=runtime, lo=lo, hi=hi)
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
