"""One rank of the port, run as a process by tests/test_torch_distributed.py
(it holds no test itself): ``python test_torch_rank_worker.py RANK WORLD PORT
COMMANDS.json`` runs each command of the JSON list in turn on the CPU, as
rank RANK of WORLD gloo ranks at ``127.0.0.1:PORT + index`` (a fresh process
group per command).  Imports torch and the port only, never jax.

A command is an argv list for the port's CLI, or ``["@model", ...]`` /
``["@ckpt", ...]``: model-level runs whose results the CLI does not write
(:func:`run_model`, :func:`write_checkpoints`).
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _cohort(beagle_path, ranks, site_multiple=1):
    from wgsassign_tpu_torch.io.beagle import read_beagle_sharded
    from wgsassign_tpu_torch.models.common import to_device
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    rt = make_runtime("cpu", ranks=ranks)
    shard = read_beagle_sharded(beagle_path, site_multiple, rank=rt.rank,
                                world=rt.world)
    return rt, shard, to_device(shard, rt, site_multiple)


def run_model(beagle_path, ids_path, ad_path, out, ranks=None):
    """Reference AF, LOO and reference z-scores at the model level; rank 0
    saves every per-problem iteration count and result to ``out`` (npz)."""
    from wgsassign_tpu_torch.io.ad import read_allele_depths
    from wgsassign_tpu_torch.io.ids import read_ids
    from wgsassign_tpu_torch.models.loo import leave_one_out
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
    from wgsassign_tpu_torch.models.zscore import reference_z_scores
    from wgsassign_tpu_torch.parallel.runtime import shutdown_distributed

    rt, shard, cohort = _cohort(beagle_path, ranks)
    popmap = read_ids(ids_path)
    res = estimate_reference_af(shard, popmap, cohort=cohort)
    loo = leave_one_out(shard, res.af, popmap, cohort=cohort,
                        af_t_dev=res.af_t_dev)
    ad = read_allele_depths(ad_path, n_sites=cohort.m_real,
                            n_inds=cohort.n_inds)
    z = reference_z_scores(shard, ad, popmap, cohort=cohort)
    if rt.is_primary():
        np.savez(out, af=res.af, af_iters=res.iters, loo_ll=loo.ll,
                 loo_iters=loo.iters, loo_converged=loo.converged,
                 z=z.z, z_loci=z.loci, z_iters=z.em_iters,
                 z_structure=z.structure, z_engine=z.engine)
    shutdown_distributed(rt)


def write_checkpoints(beagle_path, ids_path, prefix, ranks=None):
    """Leave the restart files of a run interrupted after 4 EM iterations
    at ``prefix``: ``.em.ckpt.npz`` (the chunked EM's state) and
    ``.loo.ckpt.pop1.done.npz`` (population 1's LOO EM marked as finished,
    with marker values)."""
    from wgsassign_tpu_torch.io.ids import read_ids
    from wgsassign_tpu_torch.models.loo import _save_pop_done
    from wgsassign_tpu_torch.obs.checkpoint import make_checkpoint
    from wgsassign_tpu_torch.ops.emmaf import _EM_EPS
    from wgsassign_tpu_torch.ops.fused_em import (
        _use_jax_layout,
        em_maf_pops_fused,
    )
    from wgsassign_tpu_torch.parallel.runtime import shutdown_distributed

    rt, _shard, cohort = _cohort(beagle_path, ranks)
    popmap = read_ids(ids_path)
    ft, _, _ = em_maf_pops_fused(
        cohort.g0, cohort.g1, popmap.membership, cohort.site_weight,
        cohort.m_real, 4, 1e-4, return_device_panel=True,
        reduce=rt.all_reduce_sum)
    k = popmap.n_pops
    ckpt = make_checkpoint(prefix + ".em.ckpt.npz", cohort, _EM_EPS)
    _use_jax_layout(ckpt, k, cohort.m_real)
    ckpt.save(ft, np.full(k, 200, np.int32), np.ones(k, bool), 4)
    n_p = len(popmap.members_of(popmap.pops[1]))
    _save_pop_done(prefix + ".loo.ckpt.pop1.done.npz", cohort,
                   torch.full((n_p, cohort.m_pad), 0.3),
                   np.full(n_p, 7, np.int32), np.ones(n_p, bool))
    shutdown_distributed(rt)


def run_command(argv, ranks=None):
    if argv[0] == "@model":
        run_model(*argv[1:], ranks=ranks)
    elif argv[0] == "@ckpt":
        write_checkpoints(*argv[1:], ranks=ranks)
    else:
        from wgsassign_tpu_torch.cli import _run, parser

        _run(parser.parse_args(argv), "cpu", ranks)


if __name__ == "__main__":
    rank, world, port = (int(a) for a in sys.argv[1:4])
    with open(sys.argv[4]) as f:
        commands = json.load(f)
    for i, argv in enumerate(commands):
        print(f"== command {i}: {' '.join(argv)}", flush=True)
        run_command(argv, (f"127.0.0.1:{port + i}", world, rank))
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "wgsassign_tpu"))
    assert not bad, f"loaded: {bad}"
    print("ALL_COMMANDS_DONE", flush=True)
