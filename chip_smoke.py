#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit (nvidia-smi);
2. build: the native Beagle reader (g++, must load: the parse times are
   its), then csrc/*.cu with nvcc for sm_90a (one nvcc per source, all
   started together), load, run the probe;
3. every kernel against its plain PyTorch twin on the card, at the shapes
   its path gives it, with both times, the kernel's bound on this card and
   its share of it and the occupancy the CUDA runtime reports (and, for
   the two z-score kernels, the kernel's time at the other EM structure's
   typical kept fraction, ``zloo_chunk`` with ascending left-out rows and
   ``sites_chunk`` with half its problems at limit 0);
4. the main path, ``--get_reference_af --loo`` through
   ``wgsassign_tpu_torch.cli.main``, on a synthetic gzipped Beagle file of
   1,000,000 sites x 180 individuals x 5 populations (seed 0), checking the
   output files and that its kernels were launched;
5. parity on the card at 100,000 sites: reference AF and LOO
   log-likelihoods from the kernels against the twins;
6. the z-score path on phase 4's cohort, its AF files and a synthetic
   allele-depth file, scoring all 180 individuals: (a)
   ``--get_reference_z_score --get_assignment_z_score`` (the loo-structured
   EM, ``zloo_chunk``), (b) ``--get_reference_z_score
   --single_read_threshold`` (the gathered EM, ``sites_chunk``);
7. parity on the card at 100,000 sites: reference z-scores in both EM
   structures from the kernels against the twins, and assignment z-scores
   on the card against the same run on the CPU;
8. the other analyses on phase 4's file and AF outputs: (a)
   ``--stream_ingest 0 --get_reference_af --ne_obs --loo``, whose AF and LOO
   files must equal phase 4's byte for byte, with the same kernel launches;
   (b) ``--get_pop_like --profile``, whose trace must hold CUDA kernels;
   (c) the EM and MCMC mixture on (b)'s log-likelihoods;
9. parity on the card at 100,000 sites: assignment log-likelihoods and Ne
   on the card against the CPU, streamed ingest against the in-memory
   cohort (bit for bit), and ``--debug_checks`` raising on a malformed GL
   triple.

The line before the last is a JSON object with each kernel's launches on
its path (phase 4, 6a or 6b), its largest difference from the twin, both
times in phase 3, its bound and, where one PyTorch call computes the same
function, that call's time; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""

import contextlib
import json
import os
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
}


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


def updates(limits, T):
    """Updates the chunk contract asks of problems with these limits."""
    return float(limits.clamp(0, T).sum())


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
    from wgsassign_tpu_torch.ops.loo_chunk import (
        loo_chunk,
        loo_chunk_geometry,
        loo_chunk_twin,
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
        **bound(weights * OPS_PER_WEIGHT,
                4 * (2 * m * n + 2 * k * m + T * k + 3 * k + n)),
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

    n_real, p, T = 36, 40, 8
    g0p, g1p = random_gls(p, m, gen, dev)
    g0p[n_real:], g1p[n_real:] = 1.0, 0.0
    ftp = 0.05 + 0.9 * torch.rand((p, m), generator=gen, device=dev)
    limp = torch.full((p,), float(T), device=dev)
    limp[3], limp[7], limp[n_real:] = 2.0, 0.0, 0.0
    errs = []
    for fast in (True, False):
        f_k, sq_k = loo_chunk(g0p, g1p, ftp, limp, n_real, T, fast)
        f_t, sq_t = loo_chunk_twin(g0p, g1p, ftp, limp, n_real, T, fast)
        errs.append(check_pair(f"loo_chunk fast_math={fast}", f_k, f_t,
                               sq_k, sq_t))
    warps, smem = loo_chunk_geometry(n_real)
    results["loo_chunk"].update(
        **bound(m * (n_real - 1) * updates(limp, T) * OPS_PER_WEIGHT,
                4 * (2 * n_real * m + 2 * p * m + T * p + p)),
        occupancy="{}x{}warps".format(
            _kernels.occupancy("loo_chunk", dev, warps, smem), warps),
        max_abs_err=max(errs),
        ms=time_ms(lambda: loo_chunk(g0p, g1p, ftp, limp, n_real, T), 5),
        plain_ms=time_ms(
            lambda: loo_chunk_twin(g0p, g1p, ftp, limp, n_real, T), 2),
        shape=f"n_real={n_real} P={p} M={m} T={T}",
    )
    del g0p, g1p, ftp, f_k, f_t
    zscore_kernels_vs_twins(dev, gen, results)


def zscore_kernels_vs_twins(dev, gen, results):
    """Phase 3, the z-score EM kernels: zLOO at one population's share of
    a 64-individual AF group over 1M sites (kept fraction ~0.86, the
    loo-structured path's), sites at phase 6b's gathered block (64
    problems, 35 members, 524,288 kept-site slots).  Each is also timed at
    the other structure's typical kept fraction; zLOO with the ascending
    left-out rows of the z-score path (phase 3's are a random permutation),
    sites with every second problem finished (limit 0), as in the later
    chunks of a run."""
    import torch

    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.ops.sites_chunk import (
        sites_chunk,
        sites_chunk_geometry,
        sites_chunk_twin,
    )
    from wgsassign_tpu_torch.ops.zloo_chunk import (
        zloo_chunk,
        zloo_chunk_geometry,
        zloo_chunk_twin,
    )

    m, n_real, b, T = M_MAIN, 36, 13, 8
    g0p, g1p = random_gls(n_real, m, gen, dev)
    ft = 0.05 + 0.9 * torch.rand((b, m), generator=gen, device=dev)
    sw = (torch.rand((b, m), generator=gen, device=dev) < 0.86).float()
    leave = torch.randperm(n_real, generator=gen, device=dev)[:b].to(
        torch.int32)
    lim = torch.full((b,), float(T), device=dev)
    lim[2], lim[5] = 3.0, 0.0
    args = (g0p, g1p, ft, sw, leave, lim, n_real, T)
    errs = []
    for fast in (True, False):
        f_k, sq_k = zloo_chunk(*args, fast)
        f_t, sq_t = zloo_chunk_twin(*args, fast)
        errs.append(check_pair(f"zloo_chunk fast_math={fast}", f_k, f_t,
                               sq_k, sq_t))
    sw_low = (torch.rand((b, m), generator=gen, device=dev) < 0.27).float()
    leave_up = torch.sort(leave).values
    warps, smem = zloo_chunk_geometry(n_real, b)
    results["zloo_chunk"].update(
        **bound(m * (n_real - 1) * updates(lim, T) * OPS_PER_WEIGHT,
                4 * (2 * n_real * m + 3 * b * m + T * b + 2 * b)),
        occupancy="{}x{}warps".format(
            _kernels.occupancy("zloo_chunk", dev, warps, smem), warps),
        max_abs_err=max(errs),
        ms=time_ms(lambda: zloo_chunk(*args), 5),
        plain_ms=time_ms(lambda: zloo_chunk_twin(*args), 2),
        other_fill_ms=time_ms(
            lambda: zloo_chunk(g0p, g1p, ft, sw_low, leave, lim, n_real, T),
            5),
        shape=f"n_real={n_real} B={b} M={m} T={T} fill=0.86",
        other_shape="fill=0.27",
        extra_ms=time_ms(
            lambda: zloo_chunk(g0p, g1p, ft, sw, leave_up, lim, n_real, T),
            5),
        extra_shape="ascending_leave",
    )
    del g0p, g1p, ft, sw, sw_low, f_k, f_t

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
    return counts, dict(timer.totals)


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
    from wgsassign_tpu_torch.io.synth import synth_beagle_file, synth_cohort
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

    path = os.path.join(WORK, f"synth_M{M_PARITY}_stream.beagle.gz")
    if not os.path.exists(path):
        synth_beagle_file(path + ".tmp", M_PARITY, N_MAIN, n_pops=K_MAIN,
                          seed=SEED + 2)
        os.replace(path + ".tmp", path)
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from wgsassign_tpu_torch import _kernels  # fails outside the repository

    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    phase("1 environment", t0, device=repr(torch.cuda.get_device_name(dev)),
          torch=torch.__version__, cuda=torch.version.cuda)

    from wgsassign_tpu_torch import _native

    t0 = time.perf_counter()
    if not _native.native_available():
        raise AssertionError("the native Beagle reader did not build or load "
                             "(g++ and zlib are needed on this host)")
    phase("2a native-reader", t0, loaded=True,
          path=os.path.relpath(_native.library_path(), ROOT))
    t0 = time.perf_counter()
    _, build_s = _kernels.build()
    _kernels.library()
    _kernels.probe(dev)
    phase("2b build", t0, nvcc_s=f"{build_s:.3f}")

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

    main_counts, main_totals = main_path(results)
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

    for n, r in results.items():
        print(f"[kernel {n}] launches={r['launches']} on the path of phase "
              f"{KERNELS[n][2]}, ms={r['ms']:.4f}, bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']}), launches x (ms - "
              f"bound_ms)={r['launches'] * (r['ms'] - r['bound_ms']):.3f}",
              flush=True)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
