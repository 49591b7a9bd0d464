#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit (nvidia-smi);
2. build: compile csrc/*.cu with nvcc for sm_90a, load, run the probe;
3. every kernel of the main path against its plain PyTorch twin on the
   card, at the main path's shapes, with both times;
4. the main path, ``--get_reference_af --loo`` through
   ``wgsassign_tpu_torch.cli.main``, on a synthetic gzipped Beagle file of
   1,000,000 sites x 180 individuals x 5 populations (seed 0), checking the
   output files and that every kernel was launched;
5. parity on the card at 100,000 sites: reference AF and LOO
   log-likelihoods from the kernels against the twins.

The line before the last is a JSON object with each kernel's launches in
phase 4, its largest difference from the twin and both times in phase 3;
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

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

PALLAS = "wgsassign_tpu/ops/pallas_emmaf.py"
KERNELS = {
    "probe": ("wgsassign_tpu_torch/csrc/probe.cu",
              "wgsassign_tpu/parallel/mesh.py:125"),
    "em_chunk": ("wgsassign_tpu_torch/csrc/em_chunk.cu", f"{PALLAS}:220"),
    "loo_chunk": ("wgsassign_tpu_torch/csrc/loo_chunk.cu", f"{PALLAS}:680"),
}


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
    from wgsassign_tpu_torch.ops.em_chunk import em_chunk, em_chunk_twin
    from wgsassign_tpu_torch.ops.loo_chunk import loo_chunk, loo_chunk_twin

    gen = torch.Generator(device=dev).manual_seed(SEED)

    x = torch.rand((8, 128), generator=gen, device=dev)
    y = torch.empty_like(x)

    def probe():
        _kernels.launch("probe", dev, x.data_ptr(), y.data_ptr(), x.numel())

    results["probe"].update(
        ms=time_ms(probe, 100), plain_ms=time_ms(lambda: x + 1.0, 100))
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
    results["em_chunk"].update(
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
    results["loo_chunk"].update(
        max_abs_err=max(errs),
        ms=time_ms(lambda: loo_chunk(g0p, g1p, ftp, limp, n_real, T), 5),
        plain_ms=time_ms(
            lambda: loo_chunk_twin(g0p, g1p, ftp, limp, n_real, T), 2),
        shape=f"n_real={n_real} P={p} M={m} T={T}",
    )


def synth_file(m, n, k, seed):
    """The synthetic Beagle and IDs files, cached by shape and seed."""
    from wgsassign_tpu.io.synth import synth_beagle_file

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
    for name in KERNELS:
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


def parity(dev):
    """Phase 5: the whole path with kernels against the twins, on the card."""
    import numpy as np

    from wgsassign_tpu.io.beagle import BeagleData
    from wgsassign_tpu.io.ids import population_map
    from wgsassign_tpu.io.synth import synth_cohort
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

    t0 = time.perf_counter()
    _, build_s = _kernels.build()
    _kernels.library()
    _kernels.probe(dev)
    phase("2 build", t0, nvcc_s=f"{build_s:.3f}")

    results = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep}
               for name, (src, rep) in KERNELS.items()}
    t0 = time.perf_counter()
    kernels_vs_twins(dev, results)
    phase("3 kernels-vs-twins", t0, **{
        n: f"{r['ms']:.3f}ms/plain={r['plain_ms']:.3f}ms/err={r['max_abs_err']}"
        for n, r in results.items()})
    torch.cuda.empty_cache()

    main_path(results)
    torch.cuda.empty_cache()
    parity(dev)

    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms")}
        for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
