"""Time variants of the four EM chunk kernels on the card.

    python3 -m wgsassign_tpu_torch.tools.tune_chunk_kernels [--only loo,em,zloo,sites]

Each variant is the kernel library rebuilt with other tile constants (the
``-DWG_LOO_JB`` / ``-DWG_EM_LANES`` / ``-DWG_ZLOO_JB`` / ``-DWG_SITES_WARPS``
/ ``-DWG_SITES_UNROLL`` / ``-DWG_SITES_LAYOUT`` macros of ``csrc/``, a
register cap) and the wrappers' matching Python constants; it is first held
to its plain twin at 100,000 sites (``ft`` must be bit-equal), then timed
with CUDA events at the shapes of ``chip_smoke.py`` phase 3 (1,000,000
sites; 524,288 site slots for ``sites_chunk``).  One line per variant; the
variant the tree ships is marked ``default``.  Then, for the shipped build:
the device time of each kernel alone (``torch.profiler``; the wrapper's
time above includes its small torch ops); ``em_chunk`` with all populations
active, with one active, and with one iteration each (what staging the GLs
costs); ``zloo_chunk`` with ascending left-out rows and with B = 12, 16 and
64; ``sites_chunk`` with all 64 problems active, with half of them at limit
0 and with one active (what skipping a finished problem's staging saves).
``--sass FILE`` also writes ``cuobjdump -sass`` of the shipped library there
(instruction slots per weight are counted from it).  Needs a GPU and nvcc; every
variant is a separate build directory under ``build/``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops import em_chunk as em_mod
from wgsassign_tpu_torch.ops import loo_chunk as loo_mod
from wgsassign_tpu_torch.ops import sites_chunk as sites_mod
from wgsassign_tpu_torch.ops import zloo_chunk as zloo_mod

M_CHECK, M_TIME = 100_000, 1_000_000
S_CHECK, S_TIME = 100_000, 524_288

# name -> (extra nvcc flags, {module constant: value}, forced loo warps)
LOO_VARIANTS = {
    "default": ((), {}, None),
    "jb2": (("-DWG_LOO_JB=2",), {"LOO_PROBLEM_TILE": 2}, None),
    "jb3": (("-DWG_LOO_JB=3",), {"LOO_PROBLEM_TILE": 3}, None),
    "jb6": (("-DWG_LOO_JB=6",), {"LOO_PROBLEM_TILE": 6}, None),
    "jb8": (("-DWG_LOO_JB=8",), {"LOO_PROBLEM_TILE": 8}, None),
    "jb4_regs56": (("-maxrregcount=56",), {}, None),
    "jb4_regs48": (("-maxrregcount=48",), {}, None),
    "jb4_warps5": ((), {}, 5),
    "jb4_warps1": ((), {}, 1),
    "jb4_warps8": ((), {}, 8),
}
EM_VARIANTS = {
    "default": ((), {}),
    "lanes4": (("-DWG_EM_LANES=4",), {"EM_LANES": 4}),
    "lanes16": (("-DWG_EM_LANES=16",), {"EM_LANES": 16}),
    "lanes4_sites8": (("-DWG_EM_LANES=4",),
                      {"EM_LANES": 4, "EM_BLOCK_SITES": (8, 4)}),
    "lanes8_sites8": ((), {"EM_BLOCK_SITES": (8, 4)}),
}
# name -> (extra nvcc flags, {module constant: value}, forced zloo warps)
ZLOO_VARIANTS = {
    "default": ((), {}, None),
    "jb2": (("-DWG_ZLOO_JB=2",), {"ZLOO_PROBLEM_TILE": 2}, None),
    "jb3": (("-DWG_ZLOO_JB=3",), {"ZLOO_PROBLEM_TILE": 3}, None),
    "jb6": (("-DWG_ZLOO_JB=6",), {"ZLOO_PROBLEM_TILE": 6}, None),
    "jb4_warps1": ((), {}, 1),
    "jb4_warps2": ((), {}, 2),
    "jb4_warps3": ((), {}, 3),
    "jb4_warps4": ((), {}, 4),
    "jb4_regs56": (("-maxrregcount=56",), {}, None),
}
# name -> (extra nvcc flags, {module constant: value}, forced sites warps):
# site tile (warps a block), member-loop unroll, layout of the staged GLs
# (0: two planes, 1: (g0, g1) pairs, 2: g2 kept as a third plane)
SITES_VARIANTS = {
    "default": ((), {}, None),
    "warps1": ((), {}, 1),
    "warps2": ((), {}, 2),
    "warps4": ((), {}, 4),
    "warps8": ((), {}, 8),
    "unroll2": (("-DWG_SITES_UNROLL=2",), {}, None),
    "unroll4": (("-DWG_SITES_UNROLL=4",), {}, None),
    "unroll4_warps2": (("-DWG_SITES_UNROLL=4",), {}, 2),
    "pair": (("-DWG_SITES_LAYOUT=1",), {}, None),
    "pair_unroll4": (("-DWG_SITES_LAYOUT=1", "-DWG_SITES_UNROLL=4"), {},
                     None),
    "plane3": (("-DWG_SITES_LAYOUT=2",), {"SITES_PLANES": 3}, None),
    "plane3_unroll4": (("-DWG_SITES_LAYOUT=2", "-DWG_SITES_UNROLL=4"),
                       {"SITES_PLANES": 3}, None),
}


@contextlib.contextmanager
def variant(flags, module, constants):
    """The library rebuilt with ``flags`` and ``module``'s constants set."""
    saved_flags = _kernels.NVCC_FLAGS
    saved = {k: getattr(module, k) for k in constants}
    _kernels.NVCC_FLAGS = (*saved_flags, *flags)
    _kernels.library.cache_clear()
    for k, v in constants.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        _kernels.NVCC_FLAGS = saved_flags
        _kernels.library.cache_clear()
        for k, v in saved.items():
            setattr(module, k, v)


def registers(kernel: str) -> list:
    """Registers per thread of ``kernel``'s two instantiations, from the
    compiler's report of the current build."""
    log = (_kernels.library_path().parent / "ptxas.log").read_text()
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            # the mangled name carries its length: "16loo_chunk_kernel"
            # is not part of "17zloo_chunk_kernel"
            inside = f"{len(kernel) + 7}{kernel}_kernel" in line
        elif inside and "Used" in line:
            out.append(int(line.split("Used")[1].split()[0]))
    return out


def time_ms(fn, reps=5):
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


def gls(rows, cols, gen, dev):
    e = -torch.log1p(-torch.rand((3, rows, cols), generator=gen, device=dev))
    e /= e.sum(dim=0, keepdim=True)
    return e[0].contiguous(), e[1].contiguous()


def loo_inputs(m, gen, dev, n_real=36, p=40, T=8):
    g0p, g1p = gls(p, m, gen, dev)
    g0p[n_real:], g1p[n_real:] = 1.0, 0.0
    ft = 0.05 + 0.9 * torch.rand((p, m), generator=gen, device=dev)
    lim = torch.full((p,), float(T), device=dev)
    lim[3], lim[7], lim[n_real:] = 2.0, 0.0, 0.0
    return g0p, g1p, ft, lim, n_real, T


def em_inputs(m, gen, dev, n=180, k=5, T=16):
    g0, g1 = gls(m, n, gen, dev)
    ft = 0.05 + 0.9 * torch.rand((k, m), generator=gen, device=dev)
    pop = (torch.arange(n, device=dev) % k).to(torch.int32)
    inv = 1.0 / torch.bincount(pop, minlength=k).to(torch.float32)
    lim = torch.tensor([16, 16, 5, 1, 0], dtype=torch.float32, device=dev)
    return g0, g1, ft, pop, inv, lim, T


def zloo_inputs(m, gen, dev, n_real=36, b=13, T=8, ascending=False):
    """chip_smoke.py phase 3's zloo_chunk inputs."""
    g0p, g1p = gls(n_real, m, gen, dev)
    ft = 0.05 + 0.9 * torch.rand((b, m), generator=gen, device=dev)
    sw = (torch.rand((b, m), generator=gen, device=dev) < 0.86).float()
    if ascending:
        leave = (torch.arange(b, device=dev) * n_real // b).to(torch.int32)
    else:
        leave = (torch.randperm(max(n_real, b), generator=gen, device=dev)[:b]
                 % n_real).to(torch.int32)
    lim = torch.full((b,), float(T), device=dev)
    if b > 5:
        lim[2], lim[5] = 3.0, 0.0
    return g0p, g1p, ft, sw, leave, lim, n_real, T


def sites_inputs(s, gen, dev, b=64, p=35, T=8):
    """chip_smoke.py phase 3's sites_chunk inputs."""
    g0s = torch.empty((b, p, s), device=dev)
    g1s = torch.empty((b, p, s), device=dev)
    for i in range(b):
        g0s[i], g1s[i] = gls(p, s, gen, dev)
    ft = 0.05 + 0.9 * torch.rand((b, s), generator=gen, device=dev)
    mask = (torch.rand((b, p), generator=gen, device=dev) < 0.9).float()
    mask[:, 0] = 1.0
    inv = 1.0 / mask.sum(dim=1)
    kept = (0.5 + 0.02 * torch.rand((b,), generator=gen, device=dev)) * s
    sw = (torch.arange(s, device=dev)[None, :] < kept[:, None]).float()
    lim = torch.full((b,), float(T), device=dev)
    lim[1], lim[4] = 2.0, 0.0
    return g0s, g1s, ft, mask, sw, lim, inv, T


def run(kernel, name, op, twin, small, big, occupancy):
    f_k, sq_k = op(*small)
    f_t, sq_t = twin(*small)
    torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)
    print(json.dumps({
        "kernel": kernel, "variant": name,
        "ft_max_abs_err": float((f_k - f_t).abs().max()),
        "ms": time_ms(lambda: op(*big)), "registers": registers(kernel),
        "blocks_per_sm": occupancy(),
    }), flush=True)


def kernel_only_ms(op, inputs, reps=3):
    """Device time of the one hand-written kernel inside ``op``."""
    from torch.profiler import ProfilerActivity, profile

    op(*inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            op(*inputs)
        torch.cuda.synchronize()
    ours = [e for e in prof.key_averages() if "_chunk_kernel" in e.key]
    return sum(e.device_time_total for e in ours) / reps / 1e3


def shipped_loo(dev, gen):
    loo = loo_inputs(M_TIME, gen, dev)
    print(json.dumps({"kernel": "loo_chunk", "kernel_only_ms":
                      kernel_only_ms(loo_mod.loo_chunk, loo)}), flush=True)


def shipped_em(dev, gen):
    em = list(em_inputs(M_TIME, gen, dev))
    row = {"kernel": "em_chunk",
           "kernel_only_ms": kernel_only_ms(em_mod.em_chunk, em)}
    for name, lim in (("all_active_16", [16.0] * 5),
                      ("one_active_16", [16.0, 0, 0, 0, 0]),
                      ("all_one_iteration", [1.0] * 5)):
        em[5] = torch.tensor(lim, device=dev)
        row[f"{name}_ms"] = time_ms(lambda: em_mod.em_chunk(*em))
    print(json.dumps(row), flush=True)


def shipped_zloo(dev, gen):
    z = zloo_inputs(M_TIME, gen, dev)
    row = {"kernel": "zloo_chunk",
           "kernel_only_ms": kernel_only_ms(zloo_mod.zloo_chunk, z),
           "random_leave_ms": time_ms(lambda: zloo_mod.zloo_chunk(*z))}
    del z
    for name, kw in (("ascending_leave", dict(ascending=True)),
                     ("b12", dict(b=12, ascending=True)),
                     ("b16", dict(b=16, ascending=True)),
                     ("b64", dict(b=64, ascending=True))):
        z = zloo_inputs(M_TIME, gen, dev, **kw)
        row[f"{name}_ms"] = time_ms(lambda: zloo_mod.zloo_chunk(*z))
        row[f"{name}_warps"] = zloo_mod.zloo_chunk_geometry(z[6],
                                                            z[2].shape[0])[0]
        del z
    print(json.dumps(row), flush=True)


def shipped_sites(dev, gen):
    st = list(sites_inputs(S_TIME, gen, dev))
    b, T = st[2].shape[0], st[7]
    row = {"kernel": "sites_chunk",
           "kernel_only_ms": kernel_only_ms(sites_mod.sites_chunk, st)}
    full = torch.full((b,), float(T), device=dev)
    half = full.clone()
    half[::2] = 0.0
    one = torch.zeros_like(full)
    one[0] = float(T)
    for name, lim in (("all_active", full), ("half_at_limit_0", half),
                      ("one_active", one)):
        st[5] = lim
        row[f"{name}_ms"] = time_ms(lambda: sites_mod.sites_chunk(*st))
        row[f"{name}_kernel_only_ms"] = kernel_only_ms(sites_mod.sites_chunk,
                                                       st)
    print(json.dumps(row), flush=True)


def write_sass(sass):
    if sass:
        out = subprocess.run(
            [str(Path(_kernels._nvcc()).with_name("cuobjdump")), "-sass",
             str(_kernels.library_path())],
            capture_output=True, text=True, check=True).stdout
        Path(sass).parent.mkdir(parents=True, exist_ok=True)
        Path(sass).write_text(out)


def tune_loo(dev, gen):
    small, big = loo_inputs(M_CHECK, gen, dev), loo_inputs(M_TIME, gen, dev)
    auto_geometry = loo_mod.loo_chunk_geometry
    for name, (flags, constants, warps) in LOO_VARIANTS.items():
        with variant(flags, loo_mod, constants):
            if warps is not None:
                loo_mod.loo_chunk_geometry = (
                    lambda n_real: (warps, auto_geometry(n_real)[1]))
            try:
                run("loo_chunk", name, loo_mod.loo_chunk,
                    loo_mod.loo_chunk_twin, small, big,
                    lambda: _kernels.occupancy(
                        "loo_chunk", dev, *loo_mod.loo_chunk_geometry(36)))
            finally:
                loo_mod.loo_chunk_geometry = auto_geometry


def tune_em(dev, gen):
    small, big = em_inputs(M_CHECK, gen, dev), em_inputs(M_TIME, gen, dev)
    for name, (flags, constants) in EM_VARIANTS.items():
        with variant(flags, em_mod, constants):
            def occupancy():
                s, _, _, smem = em_mod.em_chunk_geometry(180, 5, 16)
                return _kernels.occupancy("em_chunk", dev, s, smem)

            run("em_chunk", name, em_mod.em_chunk, em_mod.em_chunk_twin,
                small, big, occupancy)


def tune_zloo(dev, gen):
    small, big = zloo_inputs(M_CHECK, gen, dev), zloo_inputs(M_TIME, gen, dev)
    auto_geometry = zloo_mod.zloo_chunk_geometry
    for name, (flags, constants, warps) in ZLOO_VARIANTS.items():
        with variant(flags, zloo_mod, constants):
            if warps is not None:
                zloo_mod.zloo_chunk_geometry = (
                    lambda n_real, b: (warps, auto_geometry(n_real, b)[1]))
            try:
                run("zloo_chunk", name, zloo_mod.zloo_chunk,
                    zloo_mod.zloo_chunk_twin, small, big,
                    lambda: _kernels.occupancy(
                        "zloo_chunk", dev,
                        *zloo_mod.zloo_chunk_geometry(36, 13)))
            finally:
                zloo_mod.zloo_chunk_geometry = auto_geometry


def tune_sites(dev, gen):
    small, big = sites_inputs(S_CHECK, gen, dev), sites_inputs(S_TIME, gen,
                                                               dev)
    auto_geometry = sites_mod.sites_chunk_geometry
    for name, (flags, constants, warps) in SITES_VARIANTS.items():
        with variant(flags, sites_mod, constants):
            if warps is not None:
                sites_mod.sites_chunk_geometry = (
                    lambda p: (warps, sites_mod._smem_bytes(p, warps)))
            try:
                run("sites_chunk", name, sites_mod.sites_chunk,
                    sites_mod.sites_chunk_twin, small, big,
                    lambda: _kernels.occupancy(
                        "sites_chunk", dev,
                        *sites_mod.sites_chunk_geometry(35)))
            finally:
                sites_mod.sites_chunk_geometry = auto_geometry


GROUPS = {"loo": (tune_loo, shipped_loo), "em": (tune_em, shipped_em),
          "zloo": (tune_zloo, shipped_zloo),
          "sites": (tune_sites, shipped_sites)}


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--sass", metavar="FILE", default=None)
    args.add_argument("--only", metavar="KERNELS", default=",".join(GROUPS),
                      help="comma-separated subset of " + ",".join(GROUPS))
    args = args.parse_args(argv)
    only = args.only.split(",")
    unknown = [k for k in only if k not in GROUPS]
    if unknown:
        print(f"tune_chunk_kernels: unknown kernels {unknown}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tune_chunk_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    for tune, _ in (GROUPS[k] for k in only):
        tune(dev, gen)
        torch.cuda.empty_cache()
    for _, shipped in (GROUPS[k] for k in only):
        shipped(dev, gen)
        torch.cuda.empty_cache()
    write_sass(args.sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
