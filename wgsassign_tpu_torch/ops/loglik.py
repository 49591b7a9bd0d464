"""Assignment log-likelihoods (counterpart of ``ops/loglik.py``).

Per (site, individual, population) the assignment likelihood under HWE is

    P(D_si | pop k) = g0 (1-a)^2 + g1 2a(1-a) + g2 a^2,   a = af[s, k]

and the log-likelihood sums the float32 per-site logs over sites.  The sum
is taken in float64 on the device, as the reference's ``np.sum(...,
dtype=float)`` does; the JAX package's f32 block partials and host combine
existed only because the TPU has no float64.  Under ``--f32_sums`` it is
taken in float32.

:func:`loglik_partition_sums` is the one entry: it gives each (individual,
population) pair its own AF row of a site-minor bank ``af_bank_t [C, M]``
through ``col_idx [N, K]`` -- the leave-one-out path's in-place-AF
semantics.  ``--get_pop_like`` evaluates the bank ``af.T`` with
``col_idx[i, k] = k`` (:func:`identity_columns`).  Individuals are
processed in blocks sized so the ``[block, K, M]`` float32 temporaries stay
within :data:`BLOCK_ELEMENTS`: the JAX op fuses the ``[M, N, K]`` product
into the site reduction, a plain torch broadcast would materialise it (3.6
GB at 1M x 180 x 5).  :func:`assign_loglik_f64` and
:func:`assign_loglik_selected_f64` are its float64, one-partition forms
returned as NumPy.

On a GPU the sums are the hand-written kernel ``csrc/loglik.cu``
(:func:`loglik_sums`): one read of the GL planes, each float32 term formed
in registers in the order :func:`site_like` writes it, then widened and
added.  The blocked form is its plain twin: it runs for CPU tensors, and on
the card where the caller passes ``kernel=False`` (the runtime's
``--no_pallas``).

With several ranks each rank sums its window of the site axis and ``reduce``
(``Runtime.all_reduce_sum``) adds the ranks' ``[N, K]`` or ``[N, K, P]``
sums, in the dtype of the sum: float64, or float32 under ``--f32_sums``.
Partition p holds the sites with ``s % P == p``; every rank's window starts
at a multiple of P, so a site's partition does not depend on the number of
ranks.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.obs.profiling import count
from wgsassign_tpu_torch.ops import log

# float32 elements per temporary of the [individuals, K, M] per-site pass:
# 2**28 is 1 GiB, a few of which coexist -- well inside an 80 GB card.
BLOCK_ELEMENTS = 1 << 28

# The kernel's block (csrc/loglik.cu): rows x width threads, width pairs
# (individual, AF column) a row, rows a multiple of the partition count.  A
# block walks tiles of sites; each tile's GL rows, weights and (while they
# fit) AF bank rows are staged in shared memory, bank rows LOGLIK_ROW_PAD
# floats apart beyond the tile, double-buffered, in at most
# LOGLIK_STAGE_BYTES (two blocks of 720 threads an SM at the benchmark's
# 180 individuals) where the smallest tile allows.
LOGLIK_MAX_THREADS = 768  # csrc/loglik.cu: __launch_bounds__(768, 2)
LOGLIK_THREADS = 256
LOGLIK_MAX_WIDTH = 512
LOGLIK_MAX_TILE = 64
LOGLIK_MIN_STAGED_TILE = 16
LOGLIK_ROW_PAD = 4
LOGLIK_STAGE_BYTES = _kernels.SMEM_LIMIT // 2


def site_like(g0, g1, a):
    """g0*(1-a)^2 + g1*2a(1-a) + (1-g0-g1)*a^2, broadcasting."""
    oma = 1.0 - a
    return g0 * oma * oma + g1 * 2.0 * a * oma + (1.0 - g0 - g1) * a * a


def site_loglik(g0, g1, a):
    """log( g0*(1-a)^2 + g1*2a(1-a) + (1-g0-g1)*a^2 ), broadcasting."""
    return log(site_like(g0, g1, a))


def _selected_site_like(g0, g1, af_bank_t, col_idx):
    """Yield ``(rows, like [b, K, M] float32)`` per individual block: the
    per-site likelihoods of the selected AF rows."""
    m, n = g0.shape
    k = col_idx.shape[1]
    b = max(1, BLOCK_ELEMENTS // max(k * m, 1))
    idx = col_idx.long()
    for lo in range(0, n, b):
        hi = min(lo + b, n)
        a = af_bank_t[idx[lo:hi]]  # [b, K, M]
        yield slice(lo, hi), site_like(g0[:, lo:hi].t()[:, None, :],
                                       g1[:, lo:hi].t()[:, None, :], a)


def _selected_site_ll(g0, g1, af_bank_t, col_idx, site_weight):
    """Yield ``(rows, ll [b, K, M] float32)`` per individual block: the
    weighted per-site log-likelihoods of the selected AF rows."""
    for rows, like in _selected_site_like(g0, g1, af_bank_t, col_idx):
        yield rows, log(like) * site_weight


def loglik_geometry(n: int, ks: int, c: int, p: int) -> tuple:
    """``(rows, width, tile, nb, smem_bytes, bank_staged)`` of the kernel's
    launch for ``n`` individuals, ``ks`` AF columns each, a bank of ``c``
    rows and ``p`` partitions.

    A block row holds ``width`` consecutive pairs (all ``n * ks`` where
    they fit, else ``min(LOGLIK_MAX_WIDTH, LOGLIK_MAX_THREADS // p)``, and
    more blocks side by side take the rest); its pairs span at most ``nb``
    individuals.  ``tile`` is the most sites, a multiple of 4 and of ``p``
    and at most LOGLIK_MAX_TILE, whose two staged buffers (GL rows of
    ``nb`` individuals, weights, and the ``[c, tile]`` bank rows) take at
    most LOGLIK_STAGE_BYTES; where no tile of LOGLIK_MIN_STAGED_TILE sites
    or more leaves room for the bank rows (a large population's
    mini-bank), ``bank_staged`` is False and the kernel reads them from
    global memory.  ``rows`` is the multiple of ``p`` that keeps the most lanes busy, in
    whole warps and over the tile's sites (``rows`` rows take sites ``r,
    r + rows, ...``), the nearest to LOGLIK_THREADS threads on a tie; a
    row's sites then all lie in one partition."""
    q = n * ks
    if q < 1 or c < 1 or not 1 <= p <= LOGLIK_MAX_THREADS:
        raise ValueError(f"loglik: no launch for n={n}, ks={ks}, c={c}, "
                         f"p={p}")
    width = min(q, LOGLIK_MAX_WIDTH, LOGLIK_MAX_THREADS // p)
    nb = min(n, (width - 1) // ks + 2)
    unit = 4 * p // math.gcd(4, p)

    def smem(tile, staged):
        bank = c * (tile + LOGLIK_ROW_PAD) if staged else 0
        return 2 * 4 * (2 * tile * nb + tile + bank)

    for staged in (True, False):
        tile = max(unit, LOGLIK_MAX_TILE // unit * unit)
        least = -(-LOGLIK_MIN_STAGED_TILE // unit) * unit if staged else unit
        while tile > least and smem(tile, staged) > LOGLIK_STAGE_BYTES:
            tile -= unit
        if smem(tile, staged) <= LOGLIK_STAGE_BYTES:
            break
    if smem(tile, staged) > _kernels.SMEM_LIMIT:
        raise ValueError(f"loglik: a tile of {tile} sites of {nb} "
                         "individuals does not fit in shared memory")

    def score(rows):
        threads = rows * width
        lanes = threads / (32 * -(-threads // 32))
        sites = tile / (rows * -(-tile // rows))
        return lanes * sites, -abs(threads - LOGLIK_THREADS)

    rows = max(range(p, LOGLIK_MAX_THREADS // width + 1, p), key=score)
    return rows, width, tile, nb, smem(tile, staged), staged


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: torch.device, threads: int, smem: int,
                     f64: bool) -> int:
    """Blocks of this launch shape the whole card holds at once."""
    per_sm = _kernels.occupancy("loglik", device, threads, smem, f64)
    if per_sm < 1:
        raise RuntimeError(f"loglik: a block of {threads} threads and "
                           f"{smem} bytes of shared memory cannot run")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * per_sm


def loglik_sums(g0, g1, af_bank_t, col_idx, site_weight,
                num_partitions: int, dtype):
    """``[N, Ks, P]`` selected partition sums by the ``loglik`` kernel, in
    ``dtype`` (float64, or float32 for ``--f32_sums``): the sums of
    :func:`loglik_partition_sums`'s blocked twin over the same float32
    terms, added in the kernel's fixed order.

    Args (CUDA tensors, contiguous):
      g0, g1: float32 ``[M, N]``.
      af_bank_t: float32 ``[C, M]``.
      col_idx: int32 ``[N, Ks]``, each in ``[0, C)`` (a pair whose row is
        outside sums to NaN).
      site_weight: float32 ``[M]``.
      num_partitions: P; partition p holds the sites with ``s % P == p``,
        and ``M`` must be a multiple of P.
    """
    dev = g0.device
    if dev.type != "cuda":
        raise ValueError(f"loglik: no kernel for device {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"loglik: sums in {dtype}, expected float32 or "
                         "float64")
    m, n = g0.shape
    c = af_bank_t.shape[0]
    ks = col_idx.shape[1]
    p = num_partitions
    for name, t, want_dtype, shape in (
            ("g0", g0, torch.float32, (m, n)),
            ("g1", g1, torch.float32, (m, n)),
            ("af_bank_t", af_bank_t, torch.float32, (c, m)),
            ("col_idx", col_idx, torch.int32, (n, ks)),
            ("site_weight", site_weight, torch.float32, (m,))):
        _kernels.check_operand(name, t, dev, want_dtype, shape)
    if p < 1 or m % p != 0:
        raise ValueError(f"site axis ({m}) must be padded to a multiple of "
                         f"num_partitions ({p})")
    if m == 0 or n * ks == 0:
        return torch.zeros((n, ks, p), dtype=dtype, device=dev)
    rows, width, tile, nb, smem, staged = loglik_geometry(n, ks, c, p)
    f64 = dtype == torch.float64
    grid_y = -(-(n * ks) // width)
    grid_x = min(-(-m // tile),
                 max(1, _resident_blocks(dev, rows * width, smem, f64)
                     // grid_y))
    aligned = (int(all(t.data_ptr() % 16 == 0 for t in (g0, g1, site_weight)))
               | 2 * int(_kernels.rows_aligned(m, af_bank_t)))
    part = torch.empty((grid_x, rows, n * ks), dtype=dtype, device=dev)
    out = torch.empty((n, ks, p), dtype=dtype, device=dev)
    _kernels.launch(
        "loglik", dev, g0.data_ptr(), g1.data_ptr(), af_bank_t.data_ptr(),
        col_idx.data_ptr(), site_weight.data_ptr(), part.data_ptr(),
        out.data_ptr(), m, n, ks, c, p, rows, width, tile, nb, grid_x,
        grid_y, smem, int(staged), aligned, int(f64),
    )
    count("loglik.launches")
    return out


def loglik_partition_sums(g0, g1, af_bank_t, col_idx, site_weight,
                          num_partitions: int = 1, dtype=torch.float64,
                          reduce=None, kernel=True):
    """``[N, Ks, P]`` sums of the weighted per-site log-likelihoods, in
    ``dtype`` (float64, or float32 for ``--f32_sums``), on the operands'
    device; partition p holds the sites with ``s % P == p`` of the (padded)
    site axis.

    Args:
      g0, g1: float32 ``[M, N]``.
      af_bank_t: float32 ``[C, M]`` bank of AF rows, site-minor
        (:func:`identity_columns` for one ``[M, K]`` panel).
      col_idx: integer ``[N, Ks]`` -- bank row used for pair (i, k).
      site_weight: float32 ``[M]`` (0 for padded sites).
      reduce: adds the ranks' sums (``Runtime.all_reduce_sum``).
      kernel: False runs the plain blocked form on a GPU too
        (``--no_pallas``); CPU tensors always take it.  The kernel wants
        contiguous operands and an int32 ``col_idx``.
    """
    m = g0.shape[0]
    n, k = col_idx.shape
    p = num_partitions
    if p < 1 or m % p != 0:
        raise ValueError(
            f"site axis ({m}) must be padded to a multiple of "
            f"num_partitions ({p})")
    if kernel and g0.device.type == "cuda":
        out = loglik_sums(g0, g1, af_bank_t, col_idx, site_weight, p, dtype)
    else:
        out = torch.empty((n, k, p), dtype=dtype, device=g0.device)
        for rows, ll in _selected_site_ll(g0, g1, af_bank_t, col_idx,
                                          site_weight):
            out[rows] = torch.sum(ll.reshape(ll.shape[0], k, m // p, p),
                                  dim=2, dtype=dtype)
    return out if reduce is None else reduce(out)


def identity_columns(n: int, af) -> tuple:
    """``(bank [K, M], col_idx [N, K])`` that make
    :func:`loglik_partition_sums` evaluate every individual against every
    column of ``af [M, K]``."""
    k = af.shape[1]
    col_idx = torch.arange(k, dtype=torch.int32, device=af.device)
    return af.t().contiguous(), col_idx.repeat(n, 1)


def assign_loglik_selected_f64(g0, g1, af_bank_t, col_idx, site_weight,
                               reduce=None, kernel=True) -> np.ndarray:
    """``[N, K]`` bank-selected log-likelihoods with float64 site sums
    (the LOO path's sum, reference glassy.py:101).  Returns np.float64."""
    return loglik_partition_sums(g0, g1, af_bank_t, col_idx, site_weight,
                                 reduce=reduce, kernel=kernel)[:, :, 0] \
        .cpu().numpy()


def assign_loglik_f64(g0, g1, af, site_weight, reduce=None,
                      kernel=True) -> np.ndarray:
    """``[N, K]`` assignment log-likelihoods of every individual against
    ``af [M, K]``, float64 site sums (reference glassy.py:38).  Returns
    np.float64."""
    return assign_loglik_selected_f64(
        g0, g1, *identity_columns(g0.shape[1], af), site_weight, reduce,
        kernel)


def check_loglik_inputs(g0, g1, af, site_weight, reduce=None) -> None:
    """Sanitizer for the reachable ``log(0)``: malformed GL triples
    (negative GLs, or g0+g1 > 1 making g2 negative) drive the per-site
    likelihood to zero or below, which the likelihood passes would fold
    into silent ``-inf``/NaN sums.  Run under ``--debug_checks`` before the
    assignment and LOO likelihood passes.  Counts the (site, individual,
    population) cells of ``af [M, K]`` with ``like <= 0`` or NaN on
    weighted sites, blocked over individuals like the passes, and raises
    ``ValueError`` with the count."""
    bank, col_idx = identity_columns(g0.shape[1], af)
    weighted = site_weight > 0.0
    bad = 0
    for _, like in _selected_site_like(g0, g1, bank, col_idx):
        bad += int((((like <= 0.0) | torch.isnan(like)) & weighted).sum())
    if reduce is not None:  # every rank raises, or none
        bad = int(reduce(torch.tensor(bad, device=g0.device)))
    if bad:
        raise ValueError(
            f"non-positive assignment likelihood at {bad} (site, individual, "
            "population) cells -- malformed GL triples (negative GLs or "
            "g0+g1 > 1)?"
        )
