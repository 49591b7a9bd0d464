#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit (nvidia-smi);
2. build, the cold start: (a) the native Beagle reader (g++, must load:
   the parse times are its), with the seconds g++ took; (b) the first
   tensor on the card (the CUDA context), csrc/*.cu with nvcc for sm_90a
   (one nvcc per source, all started together), then load and the probe;
3. every kernel against its plain PyTorch twin on the card, at the shapes
   its path gives it, with both times, the kernel's bound on this card and
   its share of it and the occupancy the CUDA runtime reports (and, for
   the two z-score kernels, the kernel's time at the other EM structure's
   typical kept fraction, ``zloo_chunk`` with random left-out rows and
   ``sites_chunk`` with half its problems at limit 0; for the two
   leave-one-out kernels, one iteration in place as the EM driver launches
   them, at the loo cell's largest population (49 x 5,000,000) and a
   z-score EM of 9 of its members, with a stopped problem, and the time of
   a launch with every problem stopped; for the convergence test
   ``em_decide``, 16 iterations of the loo cell's partials (156,250 blocks
   x 49 problems) against its twin, with and without a reduce between its
   two launches: the same stops and counters, sums bit for bit; for the
   likelihood pass ``loglik``, the benchmark's leave-one-out column and
   assignment call at 5,000,000 sites; for the z-score tables' two passes
   ``ztables_bin`` and ``ztables_filter``, the z-score cell's 5,000,000 x
   180 cohort of uint8 read counts, bit for bit; for the z sums ``zsums``,
   one AF group of 32 individuals of that cohort, W = 16, float64 sums to
   rtol 1e-12);
4. the main path, ``--get_reference_af --loo`` through
   ``wgsassign_tpu_torch.cli.main``, on a synthetic gzipped Beagle file of
   1,000,000 sites x 180 individuals x 5 populations (seed 0), checking the
   output files and that its kernels were launched (``em_decide`` twice
   for each ``loo_chunk`` launch);
5. parity on the card at 100,000 sites: reference AF and LOO
   log-likelihoods from the kernels against the twins (the twins' EMs in
   chunks with the host's convergence test, so ``em_decide`` decides only
   the kernels' side);
6. the z-score path on phase 4's cohort, its AF files and a synthetic
   allele-depth file, scoring all 180 individuals: (a)
   ``--get_reference_z_score --get_assignment_z_score`` (the loo-structured
   EM, ``zloo_chunk``), (b) ``--get_reference_z_score
   --single_read_threshold`` (the gathered EM, ``sites_chunk``);
7. parity on the card at 100,000 sites: reference z-scores in both EM
   structures from the kernels against the twins (the twins' EMs with the
   host's test, as in phase 5), and assignment z-scores
   on the card against the same run on the CPU;
8. the other analyses on phase 4's file and AF outputs: (a)
   ``--stream_ingest 0 --get_reference_af --ne_obs --loo``, whose AF and LOO
   files must equal phase 4's byte for byte, with the same kernel launches;
   (b) ``--get_pop_like --profile``, whose trace must hold CUDA kernels;
   (c) the EM and MCMC mixture on (b)'s log-likelihoods;
9. parity on the card at 100,000 sites: assignment log-likelihoods and Ne
   on the card against the CPU, streamed ingest against the in-memory
   cohort (bit for bit), and ``--debug_checks`` raising on a malformed GL
   triple;
10. several ranks, one process each, started through the
   ``WGSA_COORDINATOR_ADDRESS`` / ``WGSA_NUM_PROCESSES`` /
   ``WGSA_PROCESS_ID`` variables (with one card both ranks share ``cuda:0``
   and their collectives go over gloo; with two or more each rank has its
   own card and they go over NCCL; the phase prints which): (a) phase 4's
   command on two ranks against phase 4: equal EM iterations per population
   and per LOO problem, ``.pop_af.npy`` byte for byte, LOO log-likelihoods
   to rtol 1e-6 with identical argmax, and each rank's ``em_chunk`` and
   ``loo_chunk`` launches equal to phase 4's; (b) both z-score flags on two
   ranks at 100,000 sites against the one-rank run of the same file: equal
   loci and EM iterations, z to atol 5e-4, and the assignment z-scores of
   both against a one-rank run whose three z sums are added in float64, to
   atol 1e-4 each (what separates the two runs is the rounding of float32
   sums over ~86,000 kept sites, added in another order); (c) populations
   of 909 members, one more than the three EM kernels stage in shared
   memory: each kernel's unstaged form against its twin, bit for bit, with
   its time beside the staged form's at 908 members, then
   ``leave_one_out`` on the card, which must launch ``loo_chunk`` for the
   big population, warn of nothing and agree with the CPU run.  A failed
   rank, a rank that outlasts its time limit or a mismatch fails the
   script;
11. the entry points of ``wgsassign_tpu_torch/graft_entry.py``: (a)
   ``entry()`` on the card against ``entry("cpu")`` at the hooks' shape
   (1,024 x 64 x 4): ``f_new`` bit for bit, log-likelihoods to rtol 1e-5 /
   atol 2e-3, exactly one ``em_chunk`` and one ``loglik`` launch; (b) the
   same ``ForwardStep`` at phase 4's width (1,000,000 x 180 x 5, GLs drawn
   on the card from seed 0) with the kernel against its twin, both on the
   card, bit for bit, with CUDA-event times of the step and of
   ``em_chunk`` at T=1 beside ``em_chunk``'s bound at T=1; (c)
   ``dryrun_multichip(max(2, device_count))``: with one card both ranks
   share ``cuda:0`` over gloo, with several each rank has its own over
   NCCL; the phase prints which.

``python3 chip_smoke.py --rank-worker SPEC.json`` is one such rank (phase 10
starts it; it reads its rank from the three variables).

The line before the last is a JSON object with each kernel's launches on
its path (phase 4, 6a or 6b, each counted from 0 over that phase's run),
its launches in phase 11a and in 11c's rank 0 apart, under
``phase11_launches``, its largest difference from the twin, both
times in phase 3, its bound and, where one PyTorch call computes the same
function, that call's time; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""

import contextlib
import json
import logging
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 0
M_MAIN, N_MAIN, K_MAIN = 1_000_000, 180, 5
M_PARITY = 100_000
# kernel vs twin tolerances: op-for-op rounding, sums in another order
FT_ATOL, SQ_RTOL = 1e-6, 1e-5
# parity of the whole path: EM trajectories over up to 200 iterations, and
# log-likelihood sums over M sites (as tests/test_cli.py for the JAX CLI)
AF_ATOL, LL_RTOL, LL_ATOL = 1e-5, 1e-5, 2e-3
# z-scores: float32 sums over up to ~1M kept sites in another order (the JAX
# goldens hold z to 2e-3, tests/test_zscore.py)
Z_ATOL = 2e-3
# Ne against the CPU: float32 member sums in another order
# (tests/test_torch_ne.py)
NE_RTOL, NE_ATOL = 1e-5, 1e-4
# mixture proportions: each row sums to 1 (float32 text in the files)
MIX_ATOL = 1e-5
# several ranks against one: the LOO log-likelihood sums are float64 sums of
# the same float32 terms, split in two.  The three z sums are float32 sums
# per rank over ~86,000 kept sites of 100,000 (|w| ~ 1e5, so each carries a
# rounding error of ~1e-3 to 1e-2 that the one-rank sum has too, in another
# order); on z = (w_obs - w_mu) / sqrt(w_var) that is ~1e-4: 1.07e-4 was
# measured on an H100.  Phase 10b shows that this is the cause: the same
# assignment z-scores with the three sums added in float64 lie within
# RANKS_Z_F64_ATOL of the one-rank and of the two-rank run.
# tests/test_torch_distributed.py holds 1e-4 at 600 sites; phase 7 holds the
# kernels to their twins at 2e-3.
RANKS_LL_RTOL, RANKS_Z_ATOL, RANKS_Z_F64_ATOL = 1e-6, 5e-4, 1e-4
RANKS = 2
RANKS_WAIT_S = 300  # of one phase's rank processes
# phase 10c: one member above the 908 that loo_chunk stages in shared
# memory, beside a small population.  The CPU run it is compared with loops
# over the members (~19 ms a member, iteration and 1,024 sites on an H100
# host's 8 cores: 280.6 s at 4,096 sites and 4 iterations), so 2,048 sites
# and 2 iterations
BIG_POP, SMALL_POP, M_BIG, BIG_ITERS = 909, 11, 2048, 2

# The card's published peaks (H100 SXM): float32 outside the tensor cores,
# and device memory.  A kernel's bound is the larger of its operations over
# the first and its bytes (each input read once, each output written once)
# over the second.  An EM weight (csrc/common.cuh::em_w<true>, g2 = 1 - g0 -
# g1 and the accumulate included) is 15 float32 operations, the divide
# counted as one.
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
OPS_PER_WEIGHT = 15

PALLAS = "wgsassign_tpu/ops/pallas_emmaf.py"
# kernel -> (source, TPU kernel it replaces, phase whose path launches it)
KERNELS = {
    "probe": ("wgsassign_tpu_torch/csrc/probe.cu",
              "wgsassign_tpu/parallel/mesh.py:125", "4"),
    "em_chunk": ("wgsassign_tpu_torch/csrc/em_chunk.cu", f"{PALLAS}:220",
                 "4"),
    "loo_chunk": ("wgsassign_tpu_torch/csrc/loo_chunk.cu", f"{PALLAS}:680",
                  "4"),
    "zloo_chunk": ("wgsassign_tpu_torch/csrc/zloo_chunk.cu",
                   f"{PALLAS}:1174", "6a"),
    "sites_chunk": ("wgsassign_tpu_torch/csrc/sites_chunk.cu",
                    f"{PALLAS}:1068", "6b"),
    "em_decide": ("wgsassign_tpu_torch/csrc/em_decide.cu",
                  f"none (the host's numpy test, {PALLAS}:541)", "4"),
    "loglik": ("wgsassign_tpu_torch/csrc/loglik.cu",
               "none (wgsassign_tpu/ops/loglik.py is XLA-fused jnp)", "4"),
    "ztables_bin": ("wgsassign_tpu_torch/csrc/ztables.cu",
                    "none (host numpy build_combo_tables)", "6a"),
    "ztables_filter": ("wgsassign_tpu_torch/csrc/ztables.cu",
                       "none (host numpy build_combo_tables)", "6a"),
    "zsums": ("wgsassign_tpu_torch/csrc/zsums.cu",
              "none (XLA-fused jnp in the JAX package)", "6a"),
}
# the likelihood pass at the benchmark's shapes (portbench/configs): a
# leave-one-out column (a population of 49 at individuals [60, 109), its
# mini-bank of 50 rows) and an assignment call of 34 individuals against
# K = 5 columns, both at 5,000,000 sites with float64 sums.  The sums of the
# kernel and of its plain form add the same float32 terms in another order
LL_M, LL_LOO_N, LL_LOO_POP, LL_LOO_FIRST = 5_000_000, 180, 49, 60
LL_ASSIGN_N, LL_ASSIGN_K, LL_SUM_RTOL = 34, 5, 1e-12
# the z-score tables' two passes at the z-score cell's cohort
# (portbench/configs/wgs180_5m_ad.json): 5,000,000 sites x 180 individuals,
# uint8 read counts of Poisson(2) depth, capped at 15 reads so the combo
# tables are W = 16 wide (364 chunks of the site axis a pass)
ZT_M, ZT_N, ZT_DEPTH, ZT_CAP = 5_000_000, 180, 2.0, 15
# the z sums on that cohort: one AF group of the z-score cell (32
# individuals), float64 sums of the same float32 terms in another order
ZS_GROUP, ZS_SUM_RTOL = 32, 1e-12
# the leave-one-out EMs at the benchmark's shapes: the loo cell's largest
# population (49 members, each a problem) over 5,000,000 sites (156,250
# blocks of 32), and a z-score EM of that population in one AF group of 32
# individuals (9 of its members, ascending, on ~87% kept sites)
STEP_M, STEP_N, STEP_B, STEP_FILL = 5_000_000, 49, 9, 0.87
DECIDE_ITERS = 16


def paths_kernels(path):
    return [name for name, (_, _, p) in KERNELS.items() if p == path]


def bound(ops, nbytes):
    """``bound_ms``, ``bound_by``: the least time the card could take for
    ``ops`` float32 operations on ``nbytes`` bytes of inputs and outputs."""
    ops_ms = ops / PEAK_F32_OPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    if ops_ms >= bytes_ms:
        return {"bound_ms": ops_ms, "bound_by": "operations"}
    return {"bound_ms": bytes_ms, "bound_by": "bytes"}


def em_chunk_bound(m, n, k, T, weights):
    """``em_chunk``'s bound for ``weights`` EM weights on ``[M, N]`` GL
    planes, ``[K, M]`` AF panels in and out, ``sq [T, K]``, the ``[N]``
    population index and three ``[K]`` vectors."""
    return bound(weights * OPS_PER_WEIGHT,
                 4 * (2 * m * n + 2 * k * m + T * k + 3 * k + n))


def stepped_chunk(step, ft, lim, T):
    """The twins' chunk of T iterations from the one-iteration kernels: T
    launches of ``step(f, limits)`` on a copy of ``ft``, problem j running
    while ``lim[j] > t``.  Returns ``(f, sq [T, P])``, each launch's
    per-block partials summed in float64 and rounded to float32 (a stopped
    problem's sum 0), as the EM driver's decision sums them."""
    import torch

    f = ft.clone()
    sq = []
    for t in range(T):
        run = lim > t
        part = step(f, run.float())
        s = torch.sum(part, 0, dtype=torch.float64).to(torch.float32)
        sq.append(torch.where(run, s, 0.0))
    return f, torch.stack(sq)


def loo_by_steps(g0p, g1p, ft, lim, n_real, T, fast_math=True):
    """``loo_chunk_twin``'s contract from ``loo_step`` launches."""
    from wgsassign_tpu_torch.ops.loo_chunk import loo_step

    return stepped_chunk(
        lambda f, run: loo_step(g0p, g1p, f, run, n_real, fast_math), ft,
        lim, T)


def zloo_by_steps(g0p, g1p, ft, sw, leave, lim, n_real, T, fast_math=True):
    """``zloo_chunk_twin``'s contract from ``zloo_step`` launches."""
    from wgsassign_tpu_torch.ops.zloo_chunk import zloo_step

    return stepped_chunk(
        lambda f, run: zloo_step(g0p, g1p, f, sw, leave, run, n_real,
                                 fast_math), ft, lim, T)


def phase(name, t0, **info):
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[phase {name}] {time.perf_counter() - t0:.3f}s {fields}",
          flush=True)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_gls(rows, cols, gen, dev):
    """Dirichlet(1, 1, 1) GL triples on the device; returns (g0, g1)."""
    import torch

    # rand lies in [0, 1): -log(1 - u) is finite
    e = -torch.log1p(-torch.rand((3, rows, cols), generator=gen, device=dev))
    e /= e.sum(dim=0, keepdim=True)
    return e[0].contiguous(), e[1].contiguous()


def random_panels(b, p, s, gen, dev):
    """``[b, p, s]`` gathered member GL panels, made one problem at a
    time (the [3, b * p, s] draw would take 3x the panels' memory)."""
    import torch

    g0 = torch.empty((b, p, s), device=dev)
    g1 = torch.empty((b, p, s), device=dev)
    for i in range(b):
        g0[i], g1[i] = random_gls(p, s, gen, dev)
    return g0, g1


def check_pair(name, got, want, sq_got, sq_want):
    import torch

    err = float((got - want).abs().max())
    if err > FT_ATOL:
        raise AssertionError(f"{name}: ft differs from the twin by {err}")
    torch.testing.assert_close(sq_got, sq_want, rtol=SQ_RTOL, atol=0)
    return err


def kernels_vs_twins(dev, results):
    """Phase 3: each kernel against its twin at the main path's shapes."""
    import torch

    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.ops.em_chunk import (
        EM_LANES,
        em_chunk,
        em_chunk_geometry,
        em_chunk_twin,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)

    x = torch.rand((8, 128), generator=gen, device=dev)
    y = torch.empty_like(x)

    def probe():
        _kernels.launch("probe", dev, x.data_ptr(), y.data_ptr(), x.numel())

    results["probe"].update(
        ms=time_ms(probe, 100), plain_ms=time_ms(lambda: x + 1.0, 100),
        library_ms=time_ms(lambda: torch.add(x, 1.0), 100),
        **bound(x.numel(), 2 * 4 * x.numel()))
    results["probe"]["max_abs_err"] = float((y - (x + 1.0)).abs().max())

    m, n, k, T = M_MAIN, N_MAIN, K_MAIN, 16
    g0, g1 = random_gls(m, n, gen, dev)
    ft = 0.05 + 0.9 * torch.rand((k, m), generator=gen, device=dev)
    pop = (torch.arange(n, device=dev) % k).to(torch.int32)
    inv = 1.0 / torch.bincount(pop, minlength=k).to(torch.float32)
    lim = torch.tensor([16, 16, 5, 1, 0], dtype=torch.float32, device=dev)
    errs = []
    for fast in (True, False):
        f_k, sq_k = em_chunk(g0, g1, ft, pop, inv, lim, T, fast)
        f_t, sq_t = em_chunk_twin(g0, g1, ft, pop, inv, lim, T, fast)
        errs.append(check_pair(f"em_chunk fast_math={fast}", f_k, f_t,
                               sq_k, sq_t))
    sizes = torch.bincount(pop, minlength=k).float()
    weights = m * float((sizes * lim.clamp(0, T)).sum())
    geo = em_chunk_geometry(n, k, T)
    results["em_chunk"].update(
        **em_chunk_bound(m, n, k, T, weights),
        occupancy="{}x{}warps".format(
            _kernels.occupancy("em_chunk", dev, geo[0], geo[3]),
            geo[0] * EM_LANES // 32),
        max_abs_err=max(errs),
        ms=time_ms(lambda: em_chunk(g0, g1, ft, pop, inv, lim, T), 5),
        plain_ms=time_ms(lambda: em_chunk_twin(g0, g1, ft, pop, inv, lim, T),
                         2),
        shape=f"M={m} N={n} K={k} T={T} limits=16,16,5,1,0",
    )
    del g0, g1, f_k, f_t
    loo_steps_vs_twins(dev, gen, results)
    decide_vs_twin(dev, gen, results)
    zscore_kernels_vs_twins(dev, gen, results)
    loglik_vs_twin(dev, gen, results)
    ztables_vs_twins(dev, gen, results)


def loo_steps_vs_twins(dev, gen, results):
    """Phase 3, the two leave-one-out kernels as the EM driver launches
    them, one iteration in place (``loo_step``, ``zloo_step``), against one
    iteration of their twins at ``STEP_*``: ``ft`` of the running problems
    to ``FT_ATOL``, the summed partials to ``SQ_RTOL``, a stopped problem's
    row and partials left as they were (0), and a launch with every limit
    at 0 (a tail launch, timed apart) writing nothing.  ``zloo_step`` is
    also timed at the z path's other kept fraction (0.27) and with its
    left-out rows in random order."""
    import torch

    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.ops.loo_chunk import (
        loo_chunk_geometry,
        loo_chunk_twin,
        loo_step,
    )
    from wgsassign_tpu_torch.ops.zloo_chunk import (
        zloo_chunk_geometry,
        zloo_chunk_twin,
        zloo_step,
    )

    m, n = STEP_M, STEP_N
    blocks = -(-m // 32)

    def check(name, step, twin, ft0, lim):
        run = lim > 0
        errs = []
        for fast in (True, False):
            f_k = ft0.clone()
            part = step(f_k, lim, fast)
            if tuple(part.shape) != (blocks, ft0.shape[0]):
                raise AssertionError(f"{name}: partials {tuple(part.shape)}")
            f_t, sq_t = twin(ft0, lim, fast)
            sq_k = torch.sum(part, 0, dtype=torch.float64).to(torch.float32)
            errs.append(check_pair(f"{name} fast_math={fast}", f_k[run],
                                   f_t[run], sq_k[run], sq_t[0, run]))
            if not torch.equal(f_k[~run], ft0[~run]) or part[:, ~run].any():
                raise AssertionError(f"{name}: a stopped problem changed")
            del f_k, f_t
        f_k = ft0.clone()
        step(f_k, torch.zeros_like(lim), True)
        if not torch.equal(f_k, ft0):
            raise AssertionError(f"{name}: a launch with every limit at 0 "
                                 "wrote ft")
        return max(errs)

    g0p, g1p = random_gls(n, m, gen, dev)
    ft = 0.05 + 0.9 * torch.rand((n, m), generator=gen, device=dev)
    lim = torch.ones(n, device=dev)
    lim[7] = 0.0
    n_run = float(lim.sum())
    err = check(
        "loo_chunk",
        lambda f, lv, fast: loo_step(g0p, g1p, f, lv, n, fast),
        lambda f, lv, fast: loo_chunk_twin(g0p, g1p, f, lv, n, 1, fast),
        ft, lim)
    scratch = ft.clone()
    warps, smem = loo_chunk_geometry(n)
    tail_ms = time_ms(
        lambda: loo_step(g0p, g1p, scratch, torch.zeros_like(lim), n), 20)
    results["loo_chunk"].update(
        **bound(m * (n - 1) * n_run * OPS_PER_WEIGHT,
                4 * (2 * n * m + n * m + n_run * m + blocks * n + n)),
        occupancy="{}x{}warps".format(
            _kernels.occupancy("loo_chunk", dev, warps, smem), warps),
        max_abs_err=err,
        ms=time_ms(lambda: loo_step(g0p, g1p, scratch, lim, n), 5),
        plain_ms=time_ms(lambda: loo_chunk_twin(g0p, g1p, ft, lim, n, 1), 2),
        shape=f"n_real={n} P={n} M={m} one_iteration one_stopped",
    )
    print(f"[phase 3 loo_chunk tail] all_limits_0_ms={tail_ms:.4f}",
          flush=True)
    del ft, scratch

    b = STEP_B
    leave = torch.sort(torch.randperm(n, generator=gen, device=dev)[:b])
    leave = leave.values.to(torch.int32)
    leave_rand = leave[torch.randperm(b, generator=gen, device=dev)]
    ftz = 0.05 + 0.9 * torch.rand((b, m), generator=gen, device=dev)
    sw = (torch.rand((b, m), generator=gen, device=dev) < STEP_FILL).float()
    sw_low = (torch.rand((b, m), generator=gen, device=dev) < 0.27).float()
    limz = torch.ones(b, device=dev)
    limz[3] = 0.0
    b_run = float(limz.sum())
    err = check(
        "zloo_chunk",
        lambda f, lv, fast: zloo_step(g0p, g1p, f, sw, leave, lv, n, fast),
        lambda f, lv, fast: zloo_chunk_twin(g0p, g1p, f, sw, leave, lv, n, 1,
                                            fast),
        ftz, limz)
    scratch = ftz.clone()
    warps, smem = zloo_chunk_geometry(n, b)
    tail_ms = time_ms(lambda: zloo_step(g0p, g1p, scratch, sw, leave,
                                        torch.zeros_like(limz), n), 20)
    results["zloo_chunk"].update(
        **bound(m * (n - 1) * b_run * OPS_PER_WEIGHT,
                4 * (2 * n * m + 2 * b * m + b_run * m + blocks * b + 3 * b)),
        occupancy="{}x{}warps".format(
            _kernels.occupancy("zloo_chunk", dev, warps, smem), warps),
        max_abs_err=err,
        ms=time_ms(lambda: zloo_step(g0p, g1p, scratch, sw, leave, limz, n),
                   5),
        plain_ms=time_ms(lambda: zloo_chunk_twin(g0p, g1p, ftz, sw, leave,
                                                 limz, n, 1), 2),
        other_fill_ms=time_ms(lambda: zloo_step(g0p, g1p, scratch, sw_low,
                                                leave, limz, n), 5),
        shape=f"n_real={n} B={b} M={m} one_iteration one_stopped "
              f"fill={STEP_FILL}",
        other_shape="fill=0.27",
        extra_ms=time_ms(lambda: zloo_step(g0p, g1p, scratch, sw, leave_rand,
                                           limz, n), 5),
        extra_shape="random_leave",
    )
    print(f"[phase 3 zloo_chunk tail] all_limits_0_ms={tail_ms:.4f}",
          flush=True)
    del g0p, g1p, ftz, scratch, sw, sw_low
    torch.cuda.empty_cache()


def decide_vs_twin(dev, gen, results):
    """Phase 3, the convergence test (``em_decide``) against its twin on the
    card, at the loo cell's partials (156,250 blocks x 49 problems): one
    :class:`Convergence` updated by the kernel and one by the twin
    (``_update_twin``) from the same partials for ``DECIDE_ITERS``
    iterations, without and with a reduce between the summing and the
    testing launch.  Limits, iterations and counters must be equal after
    every iteration and the float32 sums that the reduce sees equal bit for
    bit.  Problem 1 holds a NaN (never converges), problem 2 negative
    partials (stops at once), problem 3 starts stopped; problem j's RMSE is
    ~tol * 2 ** (j % 8 - it / 2), so the rest stop at iterations 1 to 16."""
    import numpy as np
    import torch

    from wgsassign_tpu_torch.ops.em_decide import Convergence

    rows, p, tol = -(-STEP_M // 32), STEP_N, 1e-4
    m_real = np.full(p, float(STEP_M))
    base = 2.0 * torch.rand((rows, p), generator=gen, device=dev)
    base *= (tol * tol * STEP_M / rows) * 4.0 ** (
        torch.arange(p, device=dev) % 8)
    base[0, 1] = float("nan")
    base[:, 2] = -base[:, 2]
    iters0 = np.full(p, 200, np.int32)
    active = np.ones(p, bool)
    active[3], iters0[3] = False, 5
    for with_reduce in (False, True):
        sides = {"kernel": Convergence(iters0, active, m_real, tol, dev),
                 "twin": Convergence(iters0, active, m_real, tol, dev)}
        seen = {side: [] for side in sides}

        def reduce_of(side):
            def reduce(sq):
                seen[side].append(sq.clone())
                return sq
            return reduce if with_reduce else None

        for it in range(DECIDE_ITERS):
            part = base * 0.5 ** it
            sides["kernel"].update(part, it, reduce_of("kernel"))
            sides["twin"]._update_twin(part, it, reduce_of("twin"))
            k, t = sides["kernel"], sides["twin"]
            for field in ("limits", "iters", "stats"):
                if not torch.equal(getattr(k, field), getattr(t, field)):
                    raise AssertionError(
                        f"em_decide: {field} differ from the twin's after "
                        f"iteration {it} (reduce={with_reduce})")
        for got, want in zip(seen["kernel"], seen["twin"]):
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True)
        iters, act, ran, tails = sides["kernel"].fetch()
        if (not act[1] or act[2] or iters[2] != 1 or iters[3] != 5
                or len(set(iters[act == 0].tolist())) < 8):
            raise AssertionError(f"em_decide: iterations {iters.tolist()}")
    timed = Convergence(np.full(p, 200, np.int32), np.ones(p, bool), m_real,
                        0.0, dev)
    twin = Convergence(np.full(p, 200, np.int32), np.ones(p, bool), m_real,
                       0.0, dev)
    results["em_decide"].update(
        **bound(p * 8, 4 * rows * p + 4 * 4 * p),
        max_abs_err=0.0,
        ms=time_ms(lambda: timed.update(base, 0), 20),
        plain_ms=time_ms(lambda: twin._update_twin(base, 0, None), 20),
        library_ms=time_ms(lambda: torch.sum(base, 0, dtype=torch.float64),
                           20),
        shape=f"rows={rows} P={p} iters={DECIDE_ITERS} reduce=none,capture",
    )


def ztables_vs_twins(dev, gen, results):
    """Phase 3, the two passes of the z-score tables (``ztables_bin``,
    ``ztables_filter``) against their twins on the card at ``ZT_*``, bit
    for bit.  Each GL is a function of its read counts, as in the
    benchmark's cohort, so a chunk's float64 sum of one combo adds equal
    float32 values and is exact in any order: the twin's ``index_add_``,
    atomic on the card, gives the kernel's bits.  Each bound counts the
    pass's bytes: the uint8 counts and the GL planes read once, and its
    outputs (the partials; the mask and the per-depth counts) written
    once."""
    import torch

    from wgsassign_tpu_torch.ops.ztables import (
        chunk_count,
        combo_bins,
        combo_bins_twin,
        site_filter,
        site_filter_twin,
    )

    m, n, w = ZT_M, ZT_N, ZT_CAP + 1
    g_tab = random_gls(w * w, 1, gen, dev)
    ad = torch.empty((m, 2 * n), dtype=torch.uint8, device=dev)
    g0 = torch.empty((m, n), device=dev)
    g1 = torch.empty((m, n), device=dev)
    rows = 500_000
    for lo in range(0, m, rows):
        hi = min(lo + rows, m)
        depth = torch.poisson(torch.full((hi - lo, n), ZT_DEPTH, device=dev),
                              generator=gen).clamp(max=ZT_CAP)
        minor = torch.binomial(depth, torch.full_like(depth, 0.3),
                               generator=gen)
        major = depth - minor
        ad[lo:hi, 0::2] = major.to(torch.uint8)
        ad[lo:hi, 1::2] = minor.to(torch.uint8)
        code = major.long() * w + minor.long()
        g0[lo:hi] = g_tab[0][code, 0]
        g1[lo:hi] = g_tab[1][code, 0]
        del depth, minor, major, code
    args = (ad, g0, g1, 0, n, m, w)
    n_chunks = chunk_count(m, n, w)
    part = combo_bins(*args)
    if not torch.equal(part, combo_bins_twin(*args)):
        raise AssertionError("ztables_bin: partials differ from the twin's")
    sums = part.sum(0)
    code = torch.arange(w * w, device=dev)
    keepc = ((sums[..., 3] > 0) & (code // w + code % w != 0))
    mean = sums[..., :3] / sums[..., 3:].clamp(min=1.0)
    amax = mean.argmax(dim=2)
    tabs = (keepc.to(torch.uint8), amax.to(torch.uint8),
            mean.gather(2, amax[..., None])[..., 0].contiguous())
    masks = [torch.zeros((n, m), dtype=torch.uint8, device=dev)
             for _ in range(2)]
    counts = site_filter(*args, *tabs, masks[0], 0.01)
    want = site_filter_twin(*args, *tabs, masks[1], 0.01)
    if not (torch.equal(masks[0], masks[1]) and torch.equal(counts, want)):
        raise AssertionError("ztables_filter: mask or counts differ from the "
                             "twin's")
    kept = float(masks[0].sum(dtype=torch.float64)) / (m * n)
    shape = f"M={m} N={n} uint8 W={w} chunks={n_chunks} kept={kept:.4f}"
    reads = m * n * (2 + 8)
    results["ztables_bin"].update(
        **bound(0, reads + part.numel() * 8), max_abs_err=0.0,
        ms=time_ms(lambda: combo_bins(*args), 5),
        plain_ms=time_ms(lambda: combo_bins_twin(*args), 1), shape=shape)
    results["ztables_filter"].update(
        **bound(0, reads + m * n + counts.numel() * 4), max_abs_err=0.0,
        ms=time_ms(lambda: site_filter(*args, *tabs, masks[0], 0.01), 5),
        plain_ms=time_ms(
            lambda: site_filter_twin(*args, *tabs, masks[1], 0.01), 1),
        shape=shape)
    del part, masks
    torch.cuda.empty_cache()
    zsums_vs_twin(dev, gen, results, ad, g0, g1)
    del ad, g0, g1
    torch.cuda.empty_cache()


def zsums_vs_twin(dev, gen, results, ad, g0, g1):
    """Phase 3, the z sums (``zsums``) against their twin on the z-score
    cell's cohort (``ztables_vs_twins``'s): the tables of its first
    ``ZS_GROUP`` individuals as the z-score path builds them, their kept
    slots, AF in [0.02, 0.98], float64 sums to ``ZS_SUM_RTOL``.  The
    twin runs in the z-score path's blocks (``Z_BLOCK_BYTES``).  The
    bound counts each kept slot's bytes once (its keep index, AF, two GLs
    and two read counts), the tables and the sums."""
    import numpy as np
    import torch

    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.models.common import DeviceCohort, device_depths
    from wgsassign_tpu_torch.models.zscore import (
        Z_BLOCK_BYTES,
        _bucket,
        _kept_slots,
        build_tables,
    )
    from wgsassign_tpu_torch.ops.zscore_ops import (
        kept_slot_sums,
        zsums,
        zsums_geometry,
    )
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    m, g, f64 = ad.shape[0], ZS_GROUP, torch.float64
    cohort = DeviceCohort(g0=g0, g1=g1,
                          site_weight=torch.ones(m, device=dev), m_real=m,
                          runtime=make_runtime(dev))
    depths = device_depths(ad, cohort)
    tables = build_tables(cohort, depths, 0, g, 0, False)
    s_pad = _bucket(int(tables.s_local.max()), 1)
    keep, _ = _kept_slots(tables.mask, s_pad)
    af = 0.02 + 0.96 * torch.rand((g, s_pad), generator=gen, device=dev)
    ops = (g0, g1, depths.counts, 0, keep, af, tables.s_local,
           tables.rows_by_depth, tables.mean_gl, tables.read_probs)
    block = max(1, min(g, Z_BLOCK_BYTES // (s_pad * 256)))
    got = zsums(*ops, f64)
    want = kept_slot_sums(*ops, f64, block=block, kernel=False)
    err = float(((got - want).abs() / want.abs()).max())
    if not err <= ZS_SUM_RTOL:
        raise AssertionError(f"zsums: sums differ from the twin's by {err} "
                             "(relative)")
    slots = int(tables.s_local.sum())
    c, r = tables.rows_by_depth.shape[1], tables.mean_gl.shape[1]
    chunk, n_chunks, smem, cmax = zsums_geometry(
        g, int(tables.s_local.max()), c, r)
    results["zsums"].update(
        **bound(0, slots * (8 + 4 + 4 + 4 + 2) + 4 * g * (c * c + 6 * r)
                + 8 * 3 * g),
        max_abs_err=err,
        ms=time_ms(lambda: zsums(*ops, f64), 5),
        plain_ms=time_ms(
            lambda: kept_slot_sums(*ops, f64, block=block, kernel=False), 1),
        occupancy="{}x{}threads".format(
            _kernels.occupancy("zsums", dev, cmax, smem, True), 256),
        shape=f"M={m} G={g} S={s_pad} kept={slots / g:.0f}/individual "
              f"C={c} R={r} chunk={chunk} chunks={n_chunks} smem={smem} "
              f"cmax={cmax} twin_block={block}")
    del cohort, depths, tables, keep, af, ops


def loglik_vs_twin(dev, gen, results):
    """Phase 3, the likelihood pass (``loglik``) against its plain form at
    the benchmark's two shapes (``LL_*``): the leave-one-out column in
    ``results["loglik"]``, the assignment call under ``assign_*`` keys."""
    import torch

    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.ops.loglik import (
        _resident_blocks,
        loglik_geometry,
        loglik_partition_sums,
        loglik_sums,
    )

    m = LL_M
    sw = torch.ones(m, device=dev)
    f64 = torch.float64

    def _twin(*args):
        return loglik_partition_sums(*args, kernel=False)[:, :, 0]

    def case(n, bank, col):
        c, ks = bank.shape[0], col.shape[1]
        g0, g1 = random_gls(m, n, gen, dev)
        args = (g0, g1, bank, col, sw)
        got = loglik_sums(*args, 1, f64)[:, :, 0]
        want = _twin(*args)
        err = float(((got - want).abs() / want.abs()).max())
        if err > LL_SUM_RTOL:
            raise AssertionError(f"loglik: sums differ from the plain "
                                 f"form's by {err} (relative)")
        rows, width, tile, _, smem, staged = loglik_geometry(n, ks, c, 1)
        threads = rows * width
        return dict(
            **bound(15 * m * n * ks, 4 * (2 * m * n + c * m + m) + 8 * n * ks),
            max_abs_err=err,
            ms=time_ms(lambda: loglik_sums(*args, 1, f64), 10),
            plain_ms=time_ms(lambda: _twin(*args), 2),
            occupancy="{}x{}threads ({} blocks resident)".format(
                _kernels.occupancy("loglik", dev, threads, smem, True),
                threads, _resident_blocks(dev, threads, smem, True)),
            shape=f"M={m} N={n} Ks={ks} C={c} tile={tile} smem={smem} "
                  f"bank_staged={staged}")

    bank = 0.05 + 0.9 * torch.rand((LL_LOO_POP + 1, m), generator=gen,
                                   device=dev)
    i = torch.arange(LL_LOO_N, device=dev)
    col = torch.where(i < LL_LOO_FIRST, LL_LOO_POP,
                      (i - LL_LOO_FIRST).clamp(max=LL_LOO_POP - 1))
    results["loglik"].update(case(LL_LOO_N, bank,
                                  col.to(torch.int32)[:, None].contiguous()))
    bank = 0.05 + 0.9 * torch.rand((LL_ASSIGN_K, m), generator=gen,
                                   device=dev)
    col = torch.arange(LL_ASSIGN_K, dtype=torch.int32,
                       device=dev).repeat(LL_ASSIGN_N, 1)
    results["loglik"].update(
        {f"assign_{k}": v
         for k, v in case(LL_ASSIGN_N, bank, col).items()})
    a = results["loglik"]
    print(f"[phase 3 loglik assign] shape=({a['assign_shape']}) "
          f"ms={a['assign_ms']:.4f} bound_ms={a['assign_bound_ms']:.4f} "
          f"bound_by={a['assign_bound_by']} share_of_bound="
          f"{a['assign_bound_ms'] / a['assign_ms']:.4f} "
          f"plain_ms={a['assign_plain_ms']:.3f} "
          f"occupancy={a['assign_occupancy']}", flush=True)


def zscore_kernels_vs_twins(dev, gen, results):
    """Phase 3, the gathered z-score EM kernel (``sites_chunk``) at phase
    6b's gathered block (64 problems, 35 members, 524,288 kept-site slots),
    also timed at the loo-structured path's kept fraction and with every
    second problem finished (limit 0), as in the later chunks of a run.
    (``zloo_chunk`` is held to its twin in :func:`loo_steps_vs_twins`.)"""
    import torch

    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.ops.sites_chunk import (
        sites_chunk,
        sites_chunk_geometry,
        sites_chunk_twin,
    )

    T = 8
    for b, p, s, timed in ((64, 35, 524_288, "main"),
                           (16, 35, 1_048_576, "other")):
        g0s, g1s = random_panels(b, p, s, gen, dev)
        ft = 0.05 + 0.9 * torch.rand((b, s), generator=gen, device=dev)
        mask = (torch.rand((b, p), generator=gen, device=dev) < 0.9).float()
        mask[:, 0] = 1.0
        inv = 1.0 / mask.sum(dim=1)
        kept = (0.5 + 0.02 * torch.rand((b,), generator=gen, device=dev)) * s
        sw = (torch.arange(s, device=dev)[None, :] < kept[:, None]).float()
        lim = torch.full((b,), float(T), device=dev)
        lim[1], lim[4] = 2.0, 0.0
        args = (g0s, g1s, ft, mask, sw, lim, inv, T)
        if timed == "other":
            results["sites_chunk"].update(
                other_fill_ms=time_ms(lambda: sites_chunk(*args), 5),
                other_shape=f"B={b} S={s} fill=0.86")
            continue
        errs = []
        for fast in (True, False):
            f_k, sq_k = sites_chunk(*args, fast)
            f_t, sq_t = sites_chunk_twin(*args, fast)
            errs.append(check_pair(f"sites_chunk fast_math={fast}", f_k, f_t,
                                   sq_k, sq_t))
        weights = s * float((mask.sum(dim=1) * lim.clamp(0, T)).sum())
        lim_half = lim.clone()
        lim_half[::2] = 0.0
        warps, smem = sites_chunk_geometry(p)
        results["sites_chunk"].update(
            **bound(weights * OPS_PER_WEIGHT,
                    4 * (2 * b * p * s + 3 * b * s + b * p + T * b + 2 * b)),
            occupancy="{}x{}warps".format(
                _kernels.occupancy("sites_chunk", dev, warps, smem), warps),
            max_abs_err=max(errs),
            ms=time_ms(lambda: sites_chunk(*args), 5),
            plain_ms=time_ms(lambda: sites_chunk_twin(*args), 2),
            shape=f"B={b} P={p} S={s} T={T} fill=0.27",
            extra_ms=time_ms(
                lambda: sites_chunk(g0s, g1s, ft, mask, sw, lim_half, inv, T),
                5),
            extra_shape="half_at_limit_0",
        )
        del g0s, g1s, f_k, f_t
        torch.cuda.empty_cache()


def synth_file(m, n, k, seed):
    """The synthetic Beagle and IDs files, cached by shape and seed."""
    from wgsassign_tpu_torch.io.synth import synth_beagle_file

    os.makedirs(WORK, exist_ok=True)
    stem = os.path.join(WORK, f"synth_M{m}_N{n}_K{k}_seed{seed}")
    beagle, ids = stem + ".beagle.gz", stem + ".ids.txt"
    if not os.path.exists(beagle):
        synth_beagle_file(beagle + ".tmp", m, n, n_pops=k, seed=seed)
        os.replace(beagle + ".tmp", beagle)
    with open(ids, "w") as f:
        for i in range(n):  # synth_cohort's population of individual i
            f.write(f"Ind{i}\tpop{i % k}\n")
    return beagle, ids


def write_synth_ad(path, m, n, k, seed, chunk=100_000):
    """The allele depths behind ``synth_beagle_file(path, m, n, n_pops=k,
    seed=seed, chunk=chunk)``: each site chunk is regenerated with the same
    ``synth_cohort`` call, so row r of this file belongs to site r of that
    Beagle file.  Plain text, one space-separated row of 2n integers per
    site, rendered through a byte lookup table."""
    import numpy as np

    from wgsassign_tpu_torch.io.synth import synth_cohort

    with open(path, "wb") as f:
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            _, _, ad = synth_cohort(hi - lo, n, n_pops=k, seed=seed + 1 + lo)
            width = len(str(int(ad.max())))
            table = np.frombuffer(
                "".join(str(v).rjust(width) for v in range(10 ** width))
                .encode(), np.uint8).reshape(-1, width)
            rows = np.empty(ad.shape + (width + 1,), np.uint8)
            rows[..., :width] = table[ad]
            rows[..., width] = ord(" ")
            rows[:, -1, width] = ord("\n")
            f.write(rows.tobytes())
    return path


def main_path(results):
    """Phase 4: the CLI's --get_reference_af --loo on the card."""
    import numpy as np
    import pandas as pd

    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    beagle, ids = synth_file(M_MAIN, N_MAIN, K_MAIN, SEED)
    phase("4a synth-file", t0, M=M_MAIN, N=N_MAIN, K=K_MAIN, seed=SEED,
          bytes=os.path.getsize(beagle))
    out = os.path.join(WORK, "main")
    t0 = time.perf_counter()
    _kernels.launches.clear()
    timer = cli_main(["--beagle", beagle, "--pop_af_IDs", ids,
                      "--get_reference_af", "--loo", "-o", out])
    counts = dict(_kernels.launches)
    wall = time.perf_counter() - t0
    for name in paths_kernels("4"):
        results[name]["launches"] = counts.get(name, 0)
        if not counts.get(name):
            raise AssertionError(f"the main path never launched {name}")
    # the convergence test: a summing and a testing launch an iteration
    if counts["em_decide"] != 2 * counts["loo_chunk"]:
        raise AssertionError(f"em_decide launches {counts}")
    af = np.load(out + ".pop_af.npy")
    if af.shape != (M_MAIN, K_MAIN) or af.dtype != np.float32:
        raise AssertionError(f"pop_af has shape {af.shape} {af.dtype}")
    if not (np.isfinite(af).all() and (af > 0).all() and (af < 1).all()):
        raise AssertionError("pop_af holds values outside (0, 1)")
    pops = open(out + ".pop_names.txt").read().split()
    if pops != [f"pop{j}" for j in range(K_MAIN)]:
        raise AssertionError(f"pop_names: {pops}")
    df = pd.read_csv(out + ".pop_like_LOO.tsv", sep="\t")
    ll = df.iloc[:, 2:].to_numpy()
    if df.shape != (N_MAIN, 2 + K_MAIN) or not np.isfinite(ll).all():
        raise AssertionError(f"LOO tsv has shape {df.shape} or non-finite")
    phases = {k: round(v, 3) for k, v in timer.totals.items()}
    phase("4b main-path", t0, wall_s=f"{wall:.3f}",
          launches=json.dumps(counts, sort_keys=True),
          phases_s=json.dumps(phases, sort_keys=True))
    iters = {"af_iters": timer.results["reference_af"].iters.tolist(),
             "loo_iters": timer.results["loo"].iters.tolist()}
    return counts, dict(timer.totals), iters


def parity(dev):
    """Phase 5: the whole path with kernels against the twins, on the card."""
    import numpy as np

    from wgsassign_tpu_torch.io.beagle import BeagleData
    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.io.synth import synth_cohort
    from wgsassign_tpu_torch.models.common import to_device
    from wgsassign_tpu_torch.models.loo import leave_one_out
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
    from wgsassign_tpu_torch.ops.em_chunk import em_chunk_twin
    from wgsassign_tpu_torch.ops.loo_chunk import loo_chunk_twin
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    t0 = time.perf_counter()
    gl, labels, _ = synth_cohort(M_PARITY, N_MAIN, n_pops=K_MAIN,
                                 seed=SEED + 1)
    names = [f"Ind{i}" for i in range(N_MAIN)]
    beagle = BeagleData(gl, names, [f"s{i}" for i in range(M_PARITY)])
    popmap = population_map(names, labels)
    cohort = to_device(beagle, make_runtime(dev))
    ref_k = estimate_reference_af(beagle, popmap, cohort=cohort)
    ref_t = estimate_reference_af(beagle, popmap, cohort=cohort,
                                  chunk_op=em_chunk_twin)
    if not np.array_equal(ref_k.iters, ref_t.iters):
        raise AssertionError(f"EM iterations {ref_k.iters} vs {ref_t.iters}")
    af_err = float(np.abs(ref_k.af - ref_t.af).max())
    if af_err > AF_ATOL:
        raise AssertionError(f"reference AF differs by {af_err}")
    loo_k = leave_one_out(beagle, ref_k.af, popmap, cohort=cohort,
                          af_t_dev=ref_k.af_t_dev)
    loo_t = leave_one_out(beagle, ref_t.af, popmap, cohort=cohort,
                          af_t_dev=ref_t.af_t_dev, chunk_op=loo_chunk_twin)
    it_diff = int((loo_k.iters != loo_t.iters).sum())
    if it_diff:
        raise AssertionError(f"{it_diff} LOO problems converge elsewhere")
    np.testing.assert_allclose(loo_k.ll, loo_t.ll, rtol=LL_RTOL,
                               atol=LL_ATOL)
    if not np.array_equal(loo_k.ll.argmax(1), loo_t.ll.argmax(1)):
        raise AssertionError("LOO assignments (argmax) differ")
    phase("5 parity", t0, M=M_PARITY, em_iters=",".join(map(str, ref_k.iters)),
          af_max_abs_err=af_err,
          ll_max_abs_err=float(np.abs(loo_k.ll - loo_t.ll).max()),
          loo_iters=f"{loo_k.iters.min()}..{loo_k.iters.max()}")


def read_z_file(path, n):
    import numpy as np

    z = np.loadtxt(path, ndmin=1)
    if z.shape != (n,) or not np.isfinite(z).all():
        raise AssertionError(f"{path}: shape {z.shape} or non-finite values")
    return z


def zscore_path(results):
    """Phase 6: the z-score CLI on phase 4's cohort and AF files."""
    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    beagle, ids = synth_file(M_MAIN, N_MAIN, K_MAIN, SEED)
    ad = beagle[: -len(".beagle.gz")] + ".ad.txt"
    if not os.path.exists(ad):
        write_synth_ad(ad + ".tmp", M_MAIN, N_MAIN, K_MAIN, SEED)
        os.replace(ad + ".tmp", ad)
    phase("6 synth-ad-file", t0, bytes=os.path.getsize(ad))
    main = os.path.join(WORK, "main")
    common = ["--beagle", beagle, "--pop_af_IDs", ids, "--ind_ad_file", ad,
              "--pop_names", main + ".pop_names.txt"]
    runs = (
        ("6a", ["--get_reference_z_score", "--get_assignment_z_score",
                "--pop_af_file", main + ".pop_af.npy"],
         (".reference_z_ind.txt", ".z_ind.txt")),
        ("6b", ["--get_reference_z_score", "--single_read_threshold"],
         (".reference_z_ind.txt",)),
    )
    for path, flags, outputs in runs:
        out = os.path.join(WORK, f"z{path}")
        t0 = time.perf_counter()
        _kernels.launches.clear()
        # the CLI prints six lines per individual: keep them in a log
        with open(out + ".log", "w") as log, contextlib.redirect_stdout(log):
            timer = cli_main([*common, *flags, "-o", out])
        counts = dict(_kernels.launches)
        wall = time.perf_counter() - t0
        for name in paths_kernels(path):
            results[name]["launches"] = counts.get(name, 0)
            if not counts.get(name):
                raise AssertionError(f"z-score run {path} never launched "
                                     f"{name}")
        other = "sites_chunk" if path == "6a" else "zloo_chunk"
        if counts.get(other):
            raise AssertionError(f"z-score run {path} launched {other}")
        if counts.get("em_decide", 0) != 2 * counts.get("zloo_chunk", 0):
            raise AssertionError(f"z-score run {path}: em_decide launches "
                                 f"{counts}")
        for suffix in outputs:
            read_z_file(out + suffix, N_MAIN)
        with open(out + ".log") as log:
            em_line = next((ln.strip() for ln in log
                            if ln.startswith("Reference z-score EM")), "")
        phases = {k: round(v, 3) for k, v in timer.totals.items()}
        phase(f"{path} zscore-cli", t0, wall_s=f"{wall:.3f}",
              flags=",".join(f for f in flags if f.startswith("--get")
                             or f.startswith("--single")),
              launches=json.dumps(counts, sort_keys=True),
              phases_s=json.dumps(phases, sort_keys=True),
              em=repr(em_line))


def zscore_parity(dev):
    """Phase 7: reference z-scores in both EM structures with the kernels
    against the twins, and assignment z-scores on the card against the
    CPU, at 100,000 sites."""
    import numpy as np

    from wgsassign_tpu_torch.io.beagle import BeagleData
    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.io.synth import synth_cohort
    from wgsassign_tpu_torch.models.common import to_device
    from wgsassign_tpu_torch.models.zscore import (
        assignment_z_scores,
        reference_z_scores,
    )
    from wgsassign_tpu_torch.ops.sites_chunk import sites_chunk_twin
    from wgsassign_tpu_torch.ops.zloo_chunk import zloo_chunk_twin
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    t0 = time.perf_counter()
    gl, labels, ad = synth_cohort(M_PARITY, N_MAIN, n_pops=K_MAIN,
                                  seed=SEED + 1)
    names = [f"Ind{i}" for i in range(N_MAIN)]
    beagle = BeagleData(gl, names, [f"s{i}" for i in range(M_PARITY)])
    popmap = population_map(names, labels)
    cohort = to_device(beagle, make_runtime(dev))
    info = {}
    for single_read, want in ((False, "loo-structured"), (True, "gathered")):
        kw = dict(single_read_threshold=single_read, cohort=cohort)
        got = reference_z_scores(beagle, ad, popmap, **kw)
        ref = reference_z_scores(beagle, ad, popmap, zloo_op=zloo_chunk_twin,
                                 sites_op=sites_chunk_twin, **kw)
        if got.structure != want or ref.structure != want:
            raise AssertionError(f"structure {got.structure}, wanted {want}")
        if not np.array_equal(got.loci, ref.loci):
            raise AssertionError(f"{want}: loci differ")
        if not np.array_equal(got.em_iters, ref.em_iters):
            raise AssertionError(f"{want}: EM iterations differ")
        err = float(np.abs(got.z - ref.z).max())
        if not err <= Z_ATOL:
            raise AssertionError(f"{want}: z differs by {err}")
        info[want] = (f"fill={got.fill:.4f},iters={got.em_iters.min()}.."
                      f"{got.em_iters.max()},z_max_abs_err={err}")
    af = np.random.default_rng(SEED).uniform(
        0.05, 0.95, (M_PARITY, K_MAIN)).astype(np.float32)
    pops = np.asarray([f"pop{j}" for j in range(K_MAIN)])
    got = assignment_z_scores(beagle, ad, labels, af, pops, cohort=cohort)
    ref = assignment_z_scores(beagle, ad, labels, af, pops,
                              runtime=make_runtime("cpu"))
    if not np.array_equal(got.loci, ref.loci):
        raise AssertionError("assignment: loci differ")
    err = float(np.abs(got.z - ref.z).max())
    if not err <= Z_ATOL:
        raise AssertionError(f"assignment: z differs from the CPU by {err}")
    info["assignment"] = f"z_max_abs_err_vs_cpu={err}"
    phase("7 zscore-parity", t0, M=M_PARITY, **{
        k.replace("-", "_"): v for k, v in info.items()})


def read_mixture(path, rows):
    import numpy as np

    mix = np.loadtxt(path, dtype=str, ndmin=2)
    pi = mix[:, 1:].astype(np.float64)
    if mix.shape[0] != rows or not np.isfinite(pi).all():
        raise AssertionError(f"{path}: shape {mix.shape} or non-finite")
    err = float(np.abs(pi.sum(axis=1) - 1.0).max())
    if err > MIX_ATOL:
        raise AssertionError(f"{path}: a row sums to 1 +- {err}")
    return err


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def analyses_path(main_counts, main_totals):
    """Phase 8: streamed ingest with Ne and LOO, --get_pop_like under the
    profiler, and the mixture, through the CLI on phase 4's file."""
    import glob
    import shutil

    import numpy as np
    import torch

    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.cli import main as cli_main

    beagle, ids = synth_file(M_MAIN, N_MAIN, K_MAIN, SEED)
    main = os.path.join(WORK, "main")

    out = os.path.join(WORK, "s8a")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _kernels.launches.clear()
    timer = cli_main(["--beagle", beagle, "--pop_af_IDs", ids,
                      "--stream_ingest", "0", "--get_reference_af",
                      "--ne_obs", "--loo", "-o", out])
    counts = dict(_kernels.launches)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for name in paths_kernels("4"):
        if not counts.get(name) or counts.get(name) != main_counts.get(name):
            raise AssertionError(f"streamed run launched {name} "
                                 f"{counts.get(name, 0)} times, phase 4 "
                                 f"{main_counts.get(name, 0)}")
    for suffix in (".pop_af.npy", ".pop_names.txt", ".pop_like_LOO.tsv"):
        if not same_bytes(out + suffix, main + suffix):
            raise AssertionError(f"streamed {suffix} differs from phase 4's")
    for suffix in (".fisher_obs.npy", ".ne_obs.npy"):
        a = np.load(out + suffix)
        if a.shape != (M_MAIN, K_MAIN) or not np.isfinite(a).all():
            raise AssertionError(f"{suffix}: shape {a.shape} or non-finite")
    ne_txt = np.loadtxt(out + ".ne_obs.txt", dtype=str, ndmin=2)
    if (ne_txt.shape != (2, K_MAIN)
            or not np.isfinite(ne_txt[1].astype(float)).all()):
        raise AssertionError(f".ne_obs.txt: {ne_txt}")
    ne_ind = np.loadtxt(out + ".ne_ind.txt", ndmin=1)
    if ne_ind.shape != (N_MAIN,) or not np.isfinite(ne_ind).all():
        raise AssertionError(f".ne_ind.txt: shape {ne_ind.shape}")
    phases = {k: round(v, 3) for k, v in timer.totals.items()}
    phase("8a streamed-ne-loo", t0, wall_s=f"{wall:.3f}",
          parse_upload_s=f"{timer.totals['parse']:.3f}",
          phase4_parse_plus_h2d_s=(
              f"{main_totals['parse'] + main_totals['h2d']:.3f}"),
          peak_mem_gb=f"{peak / 1e9:.2f}",
          launches=json.dumps(counts, sort_keys=True),
          phases_s=json.dumps(phases, sort_keys=True),
          same_bytes_as_4="pop_af,pop_names,pop_like_LOO")

    out = os.path.join(WORK, "s8b")
    trace_dir = os.path.join(WORK, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    timer = cli_main(["--beagle", beagle, "--get_pop_like", "--pop_af_file",
                      main + ".pop_af.npy", "--profile", trace_dir,
                      "-o", out])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ll = np.loadtxt(out + ".pop_like.txt", ndmin=2)
    if ll.shape != (N_MAIN, K_MAIN) or not np.isfinite(ll).all():
        raise AssertionError(f".pop_like.txt: shape {ll.shape} or non-finite")
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"profiler traces: {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernel_events = [ev for ev in events if ev.get("cat") == "kernel"]
    if not kernel_events:
        raise AssertionError("the profiler trace holds no CUDA kernel")
    kernel_us = sum(float(ev.get("dur", 0.0)) for ev in kernel_events)
    phases = {k: round(v, 3) for k, v in timer.totals.items()}
    phase("8b pop-like-profile", t0, wall_s=f"{wall:.3f}",
          peak_mem_gb=f"{peak / 1e9:.2f}", trace_events=len(events),
          cuda_kernel_events=len(kernel_events),
          cuda_kernel_ms=f"{kernel_us / 1e3:.3f}",
          phases_s=json.dumps(phases, sort_keys=True))

    out8c = os.path.join(WORK, "s8c")
    t0 = time.perf_counter()
    timer = cli_main(["--pop_like", out + ".pop_like.txt", "--pop_like_IDs",
                      ids, "--get_em_mix", "--get_mcmc_mix", "--mcmc_seed",
                      "0", "--stable_mix", "-o", out8c])
    errs = [read_mixture(out8c + suffix, K_MAIN)
            for suffix in (".em_mix.txt", ".mcmc_mix.txt")]
    phase("8c mixture", t0, mixture_s=f"{timer.totals['mixture']:.3f}",
          row_sum_err=max(errs))


def analyses_parity(dev):
    """Phase 9: the torch-op analyses on the card against the CPU, streamed
    ingest against the in-memory cohort, and --debug_checks, at 100,000
    sites."""
    import numpy as np
    import torch

    from wgsassign_tpu_torch.io.beagle import BeagleData, read_beagle
    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.io.synth import synth_cohort
    from wgsassign_tpu_torch.models.assign import assignment_loglikelihoods
    from wgsassign_tpu_torch.models.common import stream_to_device, to_device
    from wgsassign_tpu_torch.models.ne import effective_sample_sizes
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    t0 = time.perf_counter()
    gl, labels, _ = synth_cohort(M_PARITY, N_MAIN, n_pops=K_MAIN,
                                 seed=SEED + 1)
    names = [f"Ind{i}" for i in range(N_MAIN)]
    beagle = BeagleData(gl, names, [f"s{i}" for i in range(M_PARITY)])
    popmap = population_map(names, labels)
    af = np.random.default_rng(SEED).uniform(
        0.05, 0.95, (M_PARITY, K_MAIN)).astype(np.float32)
    gpu, cpu = make_runtime(dev), make_runtime("cpu")
    info = {}
    for p, f64 in ((1, True), (1, False), (4, True)):
        kw = dict(num_partitions=p, f64_sums=f64)
        got = assignment_loglikelihoods(beagle, af, runtime=gpu, **kw)
        want = assignment_loglikelihoods(beagle, af, runtime=cpu, **kw)
        got, want = (got, want) if p > 1 else ((got,), (want,))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=LL_RTOL, atol=LL_ATOL)
        if not np.array_equal(got[0].argmax(1), want[0].argmax(1)):
            raise AssertionError(f"pop_like P={p} f64={f64}: argmax differs")
        info[f"pop_like_P{p}_{'f64' if f64 else 'f32'}_max_abs_err"] = float(
            max(np.abs(g - w).max() for g, w in zip(got, want)))
    ne_g = effective_sample_sizes(beagle, af, popmap, runtime=gpu)
    ne_c = effective_sample_sizes(beagle, af, popmap, runtime=cpu)
    for name in ("f_obs", "ne_obs", "ne_ind"):
        g, w = getattr(ne_g, name), getattr(ne_c, name)
        np.testing.assert_allclose(g, w, rtol=NE_RTOL, atol=NE_ATOL)
        info[f"ne_{name}_max_abs_err"] = float(np.abs(g - w).max())

    path = parity_stream_file()
    full = read_beagle(path)
    keep = np.arange(M_PARITY) % 7 != 3
    rows = np.flatnonzero(keep)
    kept = BeagleData(full.gl[rows], full.sample_names,
                      [full.site_names[r] for r in rows])
    for label, mask, ref in (("all", None, full), ("masked", keep, kept)):
        got, _, _ = stream_to_device(path, gpu, site_multiple=4,
                                     block_rows=4096, keep_mask=mask)
        want = to_device(ref, gpu, site_multiple=4)
        same = all(torch.equal(getattr(got, a), getattr(want, a))
                   for a in ("g0", "g1", "site_weight"))
        if not same or got.m_real != want.m_real:
            raise AssertionError(f"streamed cohort ({label}) differs from "
                                 "the in-memory one")
    info["stream_bit_identical"] = "all,masked"

    bad_gl = gl.copy()
    bad_gl[3, 1] = (0.5, 0.9)  # g2 = -0.4
    bad_af = af.copy()
    bad_af[3] = 0.95  # likelihood 0.5(1-a)^2 + 1.8a(1-a) - 0.4a^2 < 0
    bad = BeagleData(bad_gl, names, beagle.site_names)
    try:
        assignment_loglikelihoods(
            bad, bad_af, runtime=make_runtime(dev, debug_checks=True))
    except ValueError as e:
        info["debug_checks"] = repr(str(e).split(" --")[0])
    else:
        raise AssertionError("--debug_checks let a malformed triple through")
    phase("9 analyses-parity", t0, M=M_PARITY, **info)


def parity_stream_file():
    """The 100,000-site Beagle file of phases 9 and 10b (seed ``SEED + 2``,
    one generator chunk)."""
    from wgsassign_tpu_torch.io.synth import synth_beagle_file

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, f"synth_M{M_PARITY}_stream.beagle.gz")
    if not os.path.exists(path):
        synth_beagle_file(path + ".tmp", M_PARITY, N_MAIN, n_pops=K_MAIN,
                          seed=SEED + 2)
        os.replace(path + ".tmp", path)
    return path


def rank_worker(spec_path):
    """One rank of phase 10: the CLI with the spec's arguments, as the rank
    the ``WGSA_*`` variables name.  Writes ``<result>.rank<r>.json``: its
    kernel launches, phase seconds and per-problem results."""
    sys.path.insert(0, ROOT)
    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.cli import main as cli_main

    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["WGSA_PROCESS_ID"])
    _kernels.launches.clear()
    t0 = time.perf_counter()
    with open(f"{spec['result']}.rank{rank}.log", "w") as log, \
            contextlib.redirect_stdout(log):
        timer = cli_main(spec["argv"])
    out = {"wall_s": time.perf_counter() - t0,
           "launches": dict(_kernels.launches),
           "totals": dict(timer.totals), "mesh": timer.results["mesh"]}
    if "reference_af" in timer.results:
        out["af_iters"] = timer.results["reference_af"].iters.tolist()
    if "loo" in timer.results:
        out["loo_iters"] = timer.results["loo"].iters.tolist()
        out["loo_engines"] = list(timer.results["loo"].engines)
    for key in ("reference_z", "assignment_z"):
        if key in timer.results:
            res = timer.results[key]
            out[key] = {"loci": res.loci.tolist(), "z": res.z.tolist(),
                        "em_iters": res.em_iters.tolist(),
                        "structure": res.structure, "engine": res.engine}
    with open(f"{spec['result']}.rank{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def run_ranks(name, argv, world=RANKS, wait_s=RANKS_WAIT_S):
    """Start ``world`` rank processes of this script on ``argv`` through the
    ``WGSA_*`` variables, wait at most ``wait_s`` seconds for all, and return
    their result dicts in rank order.  A rank that fails or outlasts the
    limit stops the others and raises."""
    result = os.path.join(WORK, name)
    spec_path = result + ".spec.json"
    with open(spec_path, "w") as f:
        json.dump({"argv": argv, "result": result}, f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, errs = [], []
    for rank in range(world):
        env = dict(os.environ, WGSA_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   WGSA_NUM_PROCESSES=str(world), WGSA_PROCESS_ID=str(rank))
        errs.append(open(f"{result}.rank{rank}.err", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker",
             spec_path], env=env, stdout=errs[-1], stderr=errs[-1]))
    deadline = time.monotonic() + wait_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"{name}: a rank outlasted {wait_s} s (hung collective?)")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in errs:
            f.close()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(f"{result}.rank{rank}.err") as f:
                tail = f.read()[-3000:]
            raise AssertionError(
                f"{name}: rank {rank} exited with {p.returncode}:\n{tail}")
    out = []
    for rank in range(world):
        with open(f"{result}.rank{rank}.json") as f:
            out.append(json.load(f))
    return out


def ranks_main_path(main_counts, main_totals, main_iters):
    """Phase 10a: phase 4's command on two ranks, against phase 4."""
    import numpy as np
    import pandas as pd
    import torch

    beagle, ids = synth_file(M_MAIN, N_MAIN, K_MAIN, SEED)
    main = os.path.join(WORK, "main")
    out = os.path.join(WORK, "r10a")
    t0 = time.perf_counter()
    ranks = run_ranks("r10a", ["--beagle", beagle, "--pop_af_IDs", ids,
                               "--get_reference_af", "--loo", "-o", out])
    wall = time.perf_counter() - t0
    mesh = ranks[0]["mesh"]
    want_backend = "nccl" if torch.cuda.device_count() >= RANKS else "gloo"
    if mesh["world"] != RANKS or mesh["backend"] != want_backend:
        raise AssertionError(f"10a: mesh {mesh}, wanted {RANKS} ranks over "
                             f"{want_backend}")
    devices = [r["mesh"]["device"] for r in ranks]
    for r in ranks:
        if r["af_iters"] != ranks[0]["af_iters"] \
                or r["loo_iters"] != ranks[0]["loo_iters"]:
            raise AssertionError("10a: the ranks disagree on EM iterations")
        if set(r["loo_engines"]) != {"loo_chunk"}:
            raise AssertionError(f"10a: LOO engines {r['loo_engines']}")
    af_off = [a - b for a, b in zip(ranks[0]["af_iters"],
                                    main_iters["af_iters"])]
    loo_off = np.asarray(ranks[0]["loo_iters"]) - np.asarray(
        main_iters["loo_iters"])
    # the one allowed difference: the sum of sq over two ranks rounds
    # differently from one rank's, so an RMSE within rounding of the
    # tolerance may cross one iteration apart
    if max(map(abs, af_off)) > 1 or np.abs(loo_off).max() > 1:
        raise AssertionError(f"10a: EM iterations differ from phase 4's by "
                             f"more than one: {af_off}, {loo_off.tolist()}")
    exact = not any(af_off) and not loo_off.any()
    if exact and not same_bytes(out + ".pop_af.npy", main + ".pop_af.npy"):
        raise AssertionError("10a: .pop_af.npy differs from phase 4's")
    # launches per rank: phase 4's, give or take one chunk and its replay
    # for the reference AF's EM, and one launch (an iteration) for each LOO
    # EM, if it crossed the tolerance an iteration apart (individual i
    # belongs to population i % K)
    slack = {"em_chunk": 2 * any(af_off),
             "loo_chunk": len({int(i) % K_MAIN
                               for i in np.flatnonzero(loo_off)})}
    for rank, r in enumerate(ranks):
        for name, allowed in slack.items():
            got_n = r["launches"].get(name, 0)
            if abs(got_n - main_counts.get(name, 0)) > allowed:
                raise AssertionError(
                    f"10a: rank {rank} launched {name} {got_n} times, phase "
                    f"4 {main_counts.get(name, 0)} (allowed difference "
                    f"{allowed})")
    af_err = float(np.abs(np.load(out + ".pop_af.npy")
                          - np.load(main + ".pop_af.npy")).max())
    if af_err > AF_ATOL:
        raise AssertionError(f"10a: pop_af differs from phase 4's by {af_err}")
    got = pd.read_csv(out + ".pop_like_LOO.tsv", sep="\t")
    want = pd.read_csv(main + ".pop_like_LOO.tsv", sep="\t")
    ll_g, ll_w = got.iloc[:, 2:].to_numpy(), want.iloc[:, 2:].to_numpy()
    if not got.iloc[:, :2].equals(want.iloc[:, :2]):
        raise AssertionError("10a: LOO tsv labels differ from phase 4's")
    np.testing.assert_allclose(ll_g, ll_w, rtol=RANKS_LL_RTOL if exact
                               else LL_RTOL, atol=0 if exact else LL_ATOL)
    if not np.array_equal(ll_g.argmax(1), ll_w.argmax(1)):
        raise AssertionError("10a: LOO assignments (argmax) differ")
    keys = ("parse", "h2d", "reference_af", "loo")
    phase("10a ranks-main-path", t0, wall_s=f"{wall:.3f}", ranks=RANKS,
          backend=mesh["backend"], devices=",".join(devices),
          iterations=("equal_to_phase_4" if exact else
                      f"tol_exception:af={af_off},loo_problems_off_by_one="
                      f"{int(np.abs(loo_off).sum())}"),
          pop_af="same_bytes_as_4" if exact else f"max_abs_err={af_err}",
          ll_max_rel_err=float(np.abs(ll_g / ll_w - 1).max()),
          launches_per_rank=json.dumps(
              [r["launches"] for r in ranks], sort_keys=True),
          **{f"rank{i}_s": json.dumps(
              {k: round(r["totals"].get(k, 0.0), 3) for k in keys},
              sort_keys=True) for i, r in enumerate(ranks)},
          rank_cli_wall_s=",".join(f"{r['wall_s']:.3f}" for r in ranks),
          phase4_s=json.dumps({k: round(main_totals.get(k, 0.0), 3)
                               for k in keys}, sort_keys=True))


def assignment_z_f64_sums(beagle_path, ids, ad_path, prefix):
    """The assignment z-scores of phase 10b's one-rank command with the
    three z sums added in float64 (one rank, on the card)."""
    import numpy as np

    from wgsassign_tpu_torch.io.ad import read_allele_depths
    from wgsassign_tpu_torch.io.beagle import read_beagle
    from wgsassign_tpu_torch.io.ids import read_ids, read_pop_names
    from wgsassign_tpu_torch.models.common import to_device
    from wgsassign_tpu_torch.models.zscore import assignment_z_scores
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    beagle = read_beagle(beagle_path)
    cohort = to_device(beagle, make_runtime("cuda:0"))
    ad = read_allele_depths(ad_path, n_sites=cohort.m_real,
                            n_inds=beagle.n_inds)
    res = assignment_z_scores(
        beagle, ad, read_ids(ids).pop_labels,
        np.load(prefix + ".pop_af.npy"),
        read_pop_names(prefix + ".pop_names.txt"), cohort=cohort,
        f64_sums=True)
    return res.z


def ranks_zscore():
    """Phase 10b: both z-score flags on two ranks at 100,000 sites, against
    the one-rank run of the same file."""
    import numpy as np

    from wgsassign_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    beagle = parity_stream_file()
    _, ids = synth_file(M_MAIN, N_MAIN, K_MAIN, SEED)  # Ind{i} pop{i % K}
    ad = beagle[: -len(".beagle.gz")] + ".ad.txt"
    if not os.path.exists(ad):
        write_synth_ad(ad + ".tmp", M_PARITY, N_MAIN, K_MAIN, SEED + 2)
        os.replace(ad + ".tmp", ad)
    one = os.path.join(WORK, "r10b_one")
    z_flags = ["--beagle", beagle, "--pop_af_IDs", ids, "--ind_ad_file", ad,
               "--pop_names", one + ".pop_names.txt", "--pop_af_file",
               one + ".pop_af.npy", "--get_reference_z_score",
               "--get_assignment_z_score"]
    with open(one + ".log", "w") as log, contextlib.redirect_stdout(log):
        timer = cli_main([*z_flags, "--get_reference_af", "-o", one])
    one_wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    two = os.path.join(WORK, "r10b")
    ranks = run_ranks("r10b", [*z_flags, "-o", two])
    two_wall = time.perf_counter() - t1
    info = {}
    for key, suffix in (("reference_z", ".reference_z_ind.txt"),
                        ("assignment_z", ".z_ind.txt")):
        want = timer.results[key]
        for rank, r in enumerate(ranks):
            if r[key]["loci"] != want.loci.tolist():
                raise AssertionError(f"10b {key}: rank {rank}'s loci differ")
            if r[key]["em_iters"] != want.em_iters.tolist():
                raise AssertionError(f"10b {key}: rank {rank}'s EM "
                                     "iterations differ")
        err = float(np.abs(read_z_file(two + suffix, N_MAIN)
                           - read_z_file(one + suffix, N_MAIN)).max())
        if not err <= RANKS_Z_ATOL:
            raise AssertionError(f"10b {key}: z differs by {err}")
        info[f"{key}_max_abs_err"] = err
    # what separates the two runs: assignment mode runs no EM, so a site's
    # terms are the same on any rank and only the three sums differ.  With
    # the sums in float64 the z-scores must lie within RANKS_Z_F64_ATOL of
    # both runs (values from the result objects, not the 7-decimal files)
    z64 = assignment_z_f64_sums(beagle, ids, ad, one)
    for name, z in (("one_rank", timer.results["assignment_z"].z),
                    ("two_ranks", np.asarray(ranks[0]["assignment_z"]["z"],
                                             np.float32))):
        err = float(np.abs(z - z64).max())
        if not err <= RANKS_Z_F64_ATOL:
            raise AssertionError(f"10b: assignment z on {name} differs from "
                                 f"the float64-sum run by {err}")
        info[f"assignment_z_{name}_vs_f64_sums"] = err
    ref = ranks[0]["reference_z"]
    if ref["structure"] != "loo-structured" or ref["engine"] != "zloo_chunk":
        raise AssertionError(f"10b: reference z-score EM {ref}")
    keys = ("parse", "h2d", "parse_ad", "zscore_tables", "zscore_af",
            "zscore_sums")
    phase("10b ranks-zscore", t0, M=M_PARITY, ranks=RANKS,
          backend=ranks[0]["mesh"]["backend"],
          one_rank_wall_s=f"{one_wall:.3f}", ranks_wall_s=f"{two_wall:.3f}",
          loci="equal", em_iters=f"equal:{min(ref['em_iters'])}.."
          f"{max(ref['em_iters'])}", structure=ref["structure"],
          launches_per_rank=json.dumps([r["launches"] for r in ranks],
                                       sort_keys=True),
          **info,
          **{f"rank{i}_s": json.dumps(
              {k: round(r["totals"].get(k, 0.0), 3) for k in keys},
              sort_keys=True) for i, r in enumerate(ranks)},
          one_rank_s=json.dumps({k: round(timer.totals.get(k, 0.0), 3)
                                 for k in keys}, sort_keys=True))


def unstaged_kernels_vs_twins(dev):
    """The three EM kernels one member above what they stage in shared
    memory (the unstaged form, which reads the members from the global
    panels) against their twins, bit for bit in ``ft``, with the time of the
    staged form one member below beside it (the two LOO kernels over T
    one-iteration launches, :func:`stepped_chunk`).  Returns the fields to
    print."""
    import torch

    from wgsassign_tpu_torch.ops.loo_chunk import (
        loo_chunk_geometry,
        loo_chunk_twin,
        max_loo_members,
    )
    from wgsassign_tpu_torch.ops.sites_chunk import (
        max_sites_members,
        sites_chunk,
        sites_chunk_geometry,
        sites_chunk_twin,
    )
    from wgsassign_tpu_torch.ops.zloo_chunk import (
        max_zloo_members,
        zloo_chunk_geometry,
        zloo_chunk_twin,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    info = {}

    def check(name, op, twin, geometry, args_of, bound):
        if geometry(bound)[1] <= 0 or geometry(bound + 1)[1] != 0:
            raise AssertionError(f"{name}: staging does not end at {bound}")
        ms = {}
        for n in (bound, bound + 1):
            args = args_of(n)
            f_k, sq_k = op(*args)
            f_t, sq_t = twin(*args)
            if not torch.equal(f_k, f_t):
                raise AssertionError(
                    f"{name} at {n} members: ft differs from the twin by "
                    f"{float((f_k - f_t).abs().max())}")
            torch.testing.assert_close(sq_k, sq_t, rtol=SQ_RTOL, atol=0)
            ms[n] = time_ms(lambda: op(*args), 3)
        plain = time_ms(lambda: twin(*args), 1)
        info[name] = (f"unstaged@{bound + 1}={ms[bound + 1]:.3f}ms/"
                      f"staged@{bound}={ms[bound]:.3f}ms/"
                      f"plain@{bound + 1}={plain:.3f}ms/err=0.0")

    # loo_chunk at phase 10c's own shape: every member a problem, a ragged
    # last site tile, mixed limits
    m, T = M_BIG + 5, BIG_ITERS
    top = max_loo_members() + 1
    g0p, g1p = random_gls(top, m, gen, dev)
    ft = 0.05 + 0.9 * torch.rand((top, m), generator=gen, device=dev)

    def loo_args(n):
        lim = torch.full((n,), float(T), device=dev)
        lim[3], lim[7], lim[n - 1] = 1.0, 0.0, 1.0
        return (g0p[:n].contiguous(), g1p[:n].contiguous(),
                ft[:n].contiguous(), lim, n, T)

    check("loo_chunk", loo_by_steps, loo_chunk_twin, loo_chunk_geometry,
          loo_args, max_loo_members())

    b, T = 13, 8
    ftz = 0.05 + 0.9 * torch.rand((b, m), generator=gen, device=dev)
    sw = (torch.rand((b, m), generator=gen, device=dev) < 0.86).float()
    lim = torch.full((b,), float(T), device=dev)
    lim[2], lim[5] = 3.0, 0.0

    def zloo_args(n):
        leave = torch.randperm(n, generator=gen, device=dev)[:b].to(
            torch.int32)
        return (g0p[:n].contiguous(), g1p[:n].contiguous(), ftz, sw, leave,
                lim, n, T)

    check("zloo_chunk", zloo_by_steps, zloo_chunk_twin,
          lambda n: zloo_chunk_geometry(n, b), zloo_args, max_zloo_members())
    del g0p, g1p, ft, ftz, sw

    b, s = 4, M_BIG + 5
    top = max_sites_members() + 1
    g0s, g1s = random_panels(b, top, s, gen, dev)
    fts = 0.05 + 0.9 * torch.rand((b, s), generator=gen, device=dev)
    sws = (torch.rand((b, s), generator=gen, device=dev) < 0.5).float()
    mask = (torch.rand((b, top), generator=gen, device=dev) < 0.9).float()
    mask[:, 0] = 1.0
    mask[1] *= 0.5  # one problem takes the multiplied path
    lims = torch.tensor([float(T), 2.0, 0.0, float(T)], device=dev)

    def sites_args(n):
        mk = mask[:, :n].contiguous()
        return (g0s[:, :n].contiguous(), g1s[:, :n].contiguous(), fts, mk,
                sws, lims, 1.0 / (mk != 0).sum(dim=1).float(), T)

    check("sites_chunk", sites_chunk, sites_chunk_twin, sites_chunk_geometry,
          sites_args, max_sites_members())
    return info


def big_population(dev):
    """Phase 10c: populations one member above what the EM kernels stage in
    shared memory: the kernels' unstaged forms against their twins, then
    such a population through ``leave_one_out`` on the card."""
    import numpy as np
    import torch

    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.io.beagle import BeagleData
    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.io.synth import synth_cohort
    from wgsassign_tpu_torch.models.common import to_device
    from wgsassign_tpu_torch.models.loo import leave_one_out
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
    from wgsassign_tpu_torch.ops.loo_chunk import max_loo_members
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    t0 = time.perf_counter()
    if BIG_POP != max_loo_members() + 1:
        raise AssertionError(f"loo_chunk stages {max_loo_members()} members")
    kernels = unstaged_kernels_vs_twins(dev)
    torch.cuda.empty_cache()
    n = BIG_POP + SMALL_POP
    gl, _, _ = synth_cohort(M_BIG, n, n_pops=2, seed=SEED + 3)
    names = [f"Ind{i}" for i in range(n)]
    labels = np.asarray(["big"] * BIG_POP + ["small"] * SMALL_POP)
    beagle = BeagleData(gl, names, [f"s{i}" for i in range(M_BIG)])
    popmap = population_map(names, labels)

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    keep = Keep(level=logging.WARNING)
    logger = logging.getLogger("wgsassign_tpu")
    logger.addHandler(keep)
    try:
        gpu = to_device(beagle, make_runtime(dev))
        ref = estimate_reference_af(beagle, popmap, cohort=gpu)
        _kernels.launches.clear()
        t_gpu = time.perf_counter()
        got = leave_one_out(beagle, ref.af, popmap, max_iter=BIG_ITERS,
                            cohort=gpu, af_t_dev=ref.af_t_dev)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t_gpu
        counts = dict(_kernels.launches)
    finally:
        logger.removeHandler(keep)
    warned = [r.getMessage() for r in records
              if r.levelno >= logging.WARNING]
    if warned:
        raise AssertionError(f"10c: warnings {warned}")
    if got.engines != ("loo_chunk", "loo_chunk"):
        raise AssertionError(f"10c: engines {got.engines}")
    # one launch an iteration, BIG_ITERS for each of the two populations
    if counts.get("loo_chunk", 0) != 2 * BIG_ITERS:
        raise AssertionError(f"10c: launches {counts}")
    t_cpu = time.perf_counter()
    want = leave_one_out(beagle, ref.af, popmap, max_iter=BIG_ITERS,
                         runtime=make_runtime("cpu"))
    cpu_s = time.perf_counter() - t_cpu
    if not np.array_equal(got.iters, want.iters):
        raise AssertionError("10c: EM iterations differ from the CPU run's")
    if not np.isfinite(got.ll).all():
        raise AssertionError("10c: non-finite log-likelihoods")
    np.testing.assert_allclose(got.ll, want.ll, rtol=LL_RTOL, atol=LL_ATOL)
    if not np.array_equal(got.ll.argmax(1), want.ll.argmax(1)):
        raise AssertionError("10c: LOO assignments (argmax) differ")
    phase("10c big-population", t0, members=BIG_POP, sites=M_BIG,
          em_iterations=BIG_ITERS, engines=",".join(got.engines),
          loo_chunk_launches=counts["loo_chunk"], warnings=0,
          loo_on_card_s=f"{gpu_s:.3f}", loo_on_cpu_s=f"{cpu_s:.3f}",
          ll_max_abs_err_vs_cpu=float(np.abs(got.ll - want.ll).max()),
          **kernels)


def entry_points(dev):
    """Phase 11: the entry points of ``graft_entry.py`` on the card.
    Returns the launches of each of their paths, each counted from 0:
    ``{"11a": {...}, "11c_rank0": {...}}``."""
    import torch

    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.graft_entry import (
        ForwardStep,
        dryrun_multichip,
        entry,
    )
    from wgsassign_tpu_torch.ops.em_chunk import em_chunk, em_chunk_twin

    t0 = time.perf_counter()
    module, args = entry()
    _kernels.launches.clear()
    f_new, ll = module(*args)
    torch.cuda.synchronize()
    counts = dict(_kernels.launches)
    if counts != {"em_chunk": 1, "loglik": 1}:
        raise AssertionError(f"11a: entry() launched {counts}, wanted "
                             "em_chunk and loglik once each")
    cpu_module, cpu_args = entry("cpu")
    f_cpu, ll_cpu = cpu_module(*cpu_args)
    if not torch.equal(f_new.cpu(), f_cpu):
        raise AssertionError("11a: f_new differs from the CPU step by "
                             f"{float((f_new.cpu() - f_cpu).abs().max())}")
    torch.testing.assert_close(ll.cpu(), ll_cpu, rtol=LL_RTOL, atol=LL_ATOL)
    phase("11a entry", t0, device=str(args[0].device),
          shape="M=1024,N=64,K=4", em_chunk_launches=counts["em_chunk"],
          loglik_launches=counts["loglik"],
          f_new="bit_equal_to_cpu",
          ll_max_abs_err=float((ll.cpu() - ll_cpu).abs().max()))

    t0 = time.perf_counter()
    m, n, k = M_MAIN, N_MAIN, K_MAIN
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g0, g1 = random_gls(m, n, gen, dev)
    pop = (torch.arange(n, device=dev) % k).to(torch.int32)
    membership = torch.nn.functional.one_hot(pop.long(), k).float()
    f0 = torch.full((m, k), 0.25, device=dev)
    step_args = (g0, g1, membership, pop, f0, torch.ones(m, device=dev))
    kernel_step, twin_step = ForwardStep(), ForwardStep(em_chunk_twin)
    f_k, ll_k = kernel_step(*step_args)
    f_t, ll_t = twin_step(*step_args)
    if not torch.equal(f_k, f_t) or not torch.equal(ll_k, ll_t):
        raise AssertionError(
            f"11b: kernel step differs from the twin step: f_new by "
            f"{float((f_k - f_t).abs().max())}, ll by "
            f"{float((ll_k - ll_t).abs().max())}")
    if not torch.isfinite(ll_k).all():
        raise AssertionError("11b: non-finite log-likelihoods")
    ft = f0.t().contiguous()
    inv = 1.0 / membership.sum(dim=0)
    lim = torch.ones(k, device=dev)
    em_ms = time_ms(lambda: em_chunk(g0, g1, ft, pop, inv, lim, 1, False), 10)
    step_ms = time_ms(lambda: kernel_step(*step_args), 5)
    plain_step_ms = time_ms(lambda: twin_step(*step_args), 2)
    em_bound = em_chunk_bound(m, n, k, 1, float(m * n))
    phase("11b forward-step", t0, shape=f"M={m},N={n},K={k}",
          f_new_and_ll="bit_equal_kernel_vs_twin", step_ms=f"{step_ms:.4f}",
          plain_step_ms=f"{plain_step_ms:.4f}", em_chunk_t1_ms=f"{em_ms:.4f}",
          bound_ms=f"{em_bound['bound_ms']:.4f}",
          bound_by=em_bound["bound_by"] + "(em_chunk,T=1)",
          em_chunk_share_of_bound=f"{em_bound['bound_ms'] / em_ms:.4f}")
    del g0, g1, step_args, f_k, f_t, ft
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    world = max(RANKS, cards)
    got = dryrun_multichip(world)
    want_backend = "nccl" if cards >= RANKS else "gloo"
    if str(got["backend"]) != want_backend:
        raise AssertionError(f"11c: backend {got['backend']}, wanted "
                             f"{want_backend}")
    rank0 = {key[len("launches_"):]: int(v) for key, v in got.items()
             if key.startswith("launches_")}
    for name in ("probe", "em_chunk", "loo_chunk", "zloo_chunk", "loglik"):
        if not rank0.get(name):
            raise AssertionError(f"11c: rank 0 never launched {name}")
    phase("11c dryrun-multichip", t0, ranks=world, backend=want_backend,
          devices=",".join(got["devices"].tolist()),
          iters=",".join(map(str, got["iters"].tolist())),
          rank0_launches=json.dumps(rank0, sort_keys=True))
    return {"11a": counts, "11c_rank0": rank0}


def main():
    import torch
    import torch.distributed

    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(sys.argv[2])

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from wgsassign_tpu_torch import _kernels  # fails outside the repository

    dev = torch.device("cuda:0")
    t_start = t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    phase("1 environment", t0, device=repr(torch.cuda.get_device_name(dev)),
          torch=torch.__version__, cuda=torch.version.cuda,
          device_count=torch.cuda.device_count(),
          nccl_available=torch.distributed.is_nccl_available())

    from wgsassign_tpu_torch import _native

    t0 = time.perf_counter()
    _, gxx_s = _native.build()
    if not _native.native_available():
        raise AssertionError("the native Beagle reader did not build or load "
                             "(g++ and zlib are needed on this host)")
    phase("2a native-reader", t0, loaded=True,
          gxx_s=f"{gxx_s:.3f}" if gxx_s else "0.000 (already built)",
          path=_native.library_path())
    t0 = time.perf_counter()
    torch.ones(1, device=dev).sum().item()
    context_s = time.perf_counter() - t0
    _, build_s = _kernels.build()
    t1 = time.perf_counter()
    _kernels.library()
    _kernels.probe(dev)
    phase("2b build", t0, context_s=f"{context_s:.3f}",
          nvcc_s=f"{build_s:.3f}" if build_s else "0.000 (already built)",
          load_probe_s=f"{time.perf_counter() - t1:.3f}",
          path=_kernels.library_path())

    results = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "library_ms": None}
               for name, (src, rep, _) in KERNELS.items()}
    t0 = time.perf_counter()
    kernels_vs_twins(dev, results)
    phase("3 kernels-vs-twins", t0, **{
        n: f"{r['ms']:.3f}ms/plain={r['plain_ms']:.3f}ms/err={r['max_abs_err']}"
           + (f"/{r['other_shape']}:{r['other_fill_ms']:.3f}ms"
              f"/{r['extra_shape']}:{r['extra_ms']:.3f}ms"
              if "other_fill_ms" in r else "")
        for n, r in results.items()})
    for n, r in results.items():
        print(f"[phase 3 {n}] shape=({r.get('shape', '8x128')}) "
              f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"bound_by={r['bound_by']} "
              f"share_of_bound={r['bound_ms'] / r['ms']:.4f} "
              f"library_ms={r['library_ms']}"
              + (f" occupancy_blocks_per_sm={r['occupancy']}"
                 if "occupancy" in r else ""), flush=True)
    torch.cuda.empty_cache()

    main_counts, main_totals, main_iters = main_path(results)
    torch.cuda.empty_cache()
    parity(dev)
    torch.cuda.empty_cache()
    zscore_path(results)
    torch.cuda.empty_cache()
    zscore_parity(dev)
    torch.cuda.empty_cache()
    analyses_path(main_counts, main_totals)
    torch.cuda.empty_cache()
    analyses_parity(dev)
    torch.cuda.empty_cache()
    ranks_main_path(main_counts, main_totals, main_iters)
    ranks_zscore()
    torch.cuda.empty_cache()
    big_population(dev)
    torch.cuda.empty_cache()
    hooks = entry_points(dev)
    for name, r in results.items():
        r["phase11_launches"] = {path: counts.get(name, 0)
                                 for path, counts in hooks.items()}

    print(f"[chip_smoke] phases 1-11 in {time.perf_counter() - t_start:.1f}s",
          flush=True)
    for n, r in results.items():
        print(f"[kernel {n}] launches={r['launches']} on the path of phase "
              f"{KERNELS[n][2]}, ms={r['ms']:.4f}, bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']}), launches x (ms - "
              f"bound_ms)={r['launches'] * (r['ms'] - r['bound_ms']):.3f}; "
              f"phase 11 {json.dumps(r['phase11_launches'], sort_keys=True)}",
              flush=True)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms",
                           "phase11_launches")}
        for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
