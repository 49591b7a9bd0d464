"""Time variants of the ``loo_chunk`` and ``em_chunk`` kernels on the card.

    python3 -m wgsassign_tpu_torch.tools.tune_chunk_kernels

Each variant is the kernel library rebuilt with other tile constants (the
``-DWG_LOO_JB`` / ``-DWG_EM_LANES`` macros of ``csrc/``, a register cap) and
the wrappers' matching Python constants; it is first held to its plain twin
at 100,000 sites (``ft`` must be bit-equal), then timed with CUDA events at
the shapes of ``chip_smoke.py`` phase 3 (1,000,000 sites).  One line per
variant; the variant the tree ships is marked ``default``.  Then, for the
shipped build: the device time of each kernel alone (``torch.profiler``; the
wrapper's time above includes its small torch ops), and ``em_chunk`` with
all populations active, with one active, and with one iteration each (what
staging the GLs costs).  ``--sass FILE`` also writes ``cuobjdump -sass`` of
the shipped library there (issue slots per weight are counted from it).
Needs a GPU and nvcc; every variant is a separate build directory under
``build/``.
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

M_CHECK, M_TIME = 100_000, 1_000_000

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


def shipped_build(dev, gen, sass):
    """The tree's own build: kernel-only times and the em_chunk sweep."""
    loo = loo_inputs(M_TIME, gen, dev)
    print(json.dumps({"kernel": "loo_chunk", "kernel_only_ms":
                      kernel_only_ms(loo_mod.loo_chunk, loo)}), flush=True)
    del loo
    torch.cuda.empty_cache()
    em = list(em_inputs(M_TIME, gen, dev))
    row = {"kernel": "em_chunk",
           "kernel_only_ms": kernel_only_ms(em_mod.em_chunk, em)}
    for name, lim in (("all_active_16", [16.0] * 5),
                      ("one_active_16", [16.0, 0, 0, 0, 0]),
                      ("all_one_iteration", [1.0] * 5)):
        em[5] = torch.tensor(lim, device=dev)
        row[f"{name}_ms"] = time_ms(lambda: em_mod.em_chunk(*em))
    print(json.dumps(row), flush=True)
    if sass:
        out = subprocess.run(
            [str(Path(_kernels._nvcc()).with_name("cuobjdump")), "-sass",
             str(_kernels.library_path())],
            capture_output=True, text=True, check=True).stdout
        Path(sass).parent.mkdir(parents=True, exist_ok=True)
        Path(sass).write_text(out)


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--sass", metavar="FILE", default=None)
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_chunk_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)

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
    del small, big
    torch.cuda.empty_cache()

    small, big = em_inputs(M_CHECK, gen, dev), em_inputs(M_TIME, gen, dev)
    for name, (flags, constants) in EM_VARIANTS.items():
        with variant(flags, em_mod, constants):
            def occupancy():
                s, _, _, smem = em_mod.em_chunk_geometry(180, 5, 16)
                return _kernels.occupancy("em_chunk", dev, s, smem)

            run("em_chunk", name, em_mod.em_chunk, em_mod.em_chunk_twin,
                small, big, occupancy)
    del small, big
    torch.cuda.empty_cache()
    shipped_build(dev, gen, args.sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
