"""Entry points of the port: a single-device forward step and a dry run on
several ranks (counterparts of ``entry()`` and ``dryrun_multichip(n)`` in
the repository's ``__graft_entry__.py``, which drives the JAX package).

    python -c "from wgsassign_tpu_torch.graft_entry import entry; \\
        m, a = entry(); print(m(*a)[1].shape)"
    python -c "from wgsassign_tpu_torch.graft_entry import dryrun_multichip; \\
        dryrun_multichip(2)"

Both run on the card unless the caller passes ``device="cpu"``, where the
kernels' plain twins run instead.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch
from torch import nn

from wgsassign_tpu_torch.ops.em_chunk import em_chunk
from wgsassign_tpu_torch.ops.loglik import (
    identity_columns,
    loglik_partition_sums,
)

# the example shape of the JAX package's entry()
ENTRY_M, ENTRY_N, ENTRY_K = 1024, 64, 4
# the dry run: 16 sites a rank, 12 individuals, 3 populations, 8 reference
# EM iterations and 4 of each leave-one-out EM (tol 0: fixed counts)
DRY_SITES_PER_RANK, DRY_N, DRY_K = 16, 12, 3
DRY_EM_ITERS, DRY_LOO_ITERS, DRY_SUBSET_B = 8, 4, 2
# several ranks against one rank in the calling process.  Every EM update is
# pointwise in the site axis and tol 0 fixes the iteration counts, so the AF
# panels agree to rounding (atol 1e-6, the JAX dry run's assert on f_raw);
# the log-likelihood, Fisher and Ne sums are the same float32 terms summed
# over the ranks' windows in another order.
DRY_AF_ATOL = 1e-6
DRY_SUM_RTOL, DRY_SUM_ATOL = 1e-5, 1e-4
_AF_KEYS = ("f_raw", "f", "f_loo", "f_z")
_SUM_KEYS = ("ll", "f_obs", "ne_obs", "ne_ind")
_ITER_KEYS = ("iters", "converged", "loo_iters", "z_iters")


def synthetic_problem(m, n, k, seed=0):
    """Random normalized GL panels + a K-population split: the same numpy
    arrays as ``__graft_entry__._synthetic_problem`` from the same seed."""
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)
    g0, g1 = raw[:, :, 0], raw[:, :, 1]
    pop_index = (np.arange(n) % k).astype(np.int32)
    membership = np.zeros((n, k), dtype=np.float32)
    membership[np.arange(n), pop_index] = 1.0
    site_weight = np.ones(m, dtype=np.float32)
    return g0, g1, membership, pop_index, site_weight


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run the plain versions")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class ForwardStep(nn.Module):
    """One MAF-EM update for all populations, then the ``[N, K]``
    assignment log-likelihood panel (float32 sums), for any shape.

    The update is one :func:`em_chunk` at T=1 with every limit 1 (the
    ``em_chunk`` kernel on a card, its twin on the CPU) in the canonical
    weight form of the JAX package's ``em_weights``; ``chunk_op`` replaces
    it where a check compares the kernel with its twin on the card.  The
    panel is :func:`loglik_partition_sums` over :func:`identity_columns`
    (the ``loglik`` kernel on a card).
    """

    def __init__(self, chunk_op=em_chunk):
        super().__init__()
        self.chunk_op = chunk_op

    def forward(self, g0, g1, membership, pop_index, f, site_weight):
        """``g0``/``g1`` float32 ``[M, N]``, ``membership`` float32
        ``[N, K]`` one-hot, ``pop_index`` int32 ``[N]``, ``f`` float32
        ``[M, K]``, ``site_weight`` float32 ``[M]``.  Returns ``(f_new
        [M, K], ll [N, K])``."""
        k = membership.shape[1]
        inv_counts = 1.0 / membership.sum(dim=0)
        limits = torch.ones(k, dtype=torch.float32, device=g0.device)
        ft, _ = self.chunk_op(g0, g1, f.t().contiguous(), pop_index,
                              inv_counts, limits, 1, False)
        f_new = ft.t().contiguous()
        ll = loglik_partition_sums(
            g0, g1, *identity_columns(g0.shape[1], f_new), site_weight,
            dtype=torch.float32)
        return f_new, ll[:, :, 0]


def entry(device="cuda:0"):
    """``(module, example_args)``: :class:`ForwardStep` and the JAX entry's
    example arguments (M=1024, N=64, K=4, seed 0) as float32 / int32
    tensors on ``device``; ``module(*example_args)`` runs one step."""
    device = _device(device)
    g0, g1, membership, pop_index, site_weight = synthetic_problem(
        ENTRY_M, ENTRY_N, ENTRY_K)
    f0 = np.full((ENTRY_M, ENTRY_K), 0.25, dtype=np.float32)
    args = tuple(torch.from_numpy(a).to(device) for a in
                 (g0, g1, membership, pop_index, f0, site_weight))
    return ForwardStep(), args


def _dryrun_step(rt, problem) -> dict:
    """The dry run's step on this rank's window of the site axis, gathered
    to rank 0 (numpy arrays there, None on the other ranks)."""
    from wgsassign_tpu_torch import _kernels
    from wgsassign_tpu_torch.ops.emmaf import clamp_af
    from wgsassign_tpu_torch.ops.fisher import fisher_obs_pops
    from wgsassign_tpu_torch.ops.fused_em import (
        em_maf_loo_group_fused,
        em_maf_loo_subset_fused,
        em_maf_pops_fused,
    )

    g0, g1, membership, pop_index, site_weight = problem
    m = g0.shape[0]
    per = m // rt.world
    lo, hi = rt.rank * per, (rt.rank + 1) * per
    reduce = rt.all_reduce_sum if rt.world > 1 else None

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(rt.device)

    rt.load_kernels()  # on a card: build, load and probe the kernels
    g0_d, g1_d, sw_d = put(g0[lo:hi]), put(g1[lo:hi]), put(site_weight[lo:hi])
    ft, iters, converged = em_maf_pops_fused(
        g0_d, g1_d, membership, sw_d, m, DRY_EM_ITERS, 0.0,
        return_device_panel=True, reduce=reduce)
    f = clamp_af(ft.t(), membership.sum(axis=0))
    ll = loglik_partition_sums(g0_d, g1_d, *identity_columns(g0_d.shape[1], f),
                               sw_d, dtype=torch.float32,
                               reduce=reduce)[:, :, 0]
    f_obs, ne_obs, ne_ind = fisher_obs_pops(
        g0_d, g1_d, f, put(membership), put(pop_index), sw_d, m)
    if reduce is not None:
        ne_ind = reduce(ne_ind)

    # batched leave-one-out EM of population 0 on its [n_p, M] panels, then
    # B of them over a kept-site mask that drops the second half of the sites
    members = np.flatnonzero(pop_index == 0)
    g0p, g1p = put(g0[lo:hi, members].T), put(g1[lo:hi, members].T)
    f_loo, loo_iters, _ = em_maf_loo_group_fused(
        g0p, g1p, m, DRY_LOO_ITERS, 0.0, reduce=reduce, n_local=hi - lo)
    sw_z = np.ones((DRY_SUBSET_B, m), np.float32)
    sw_z[:, m // 2:] = 0.0
    f_z, z_iters, _ = em_maf_loo_subset_fused(
        g0p, g1p, np.arange(DRY_SUBSET_B, dtype=np.int32), put(sw_z[:, lo:hi]),
        np.full(DRY_SUBSET_B, float(m // 2), np.float32), DRY_LOO_ITERS, 0.0,
        reduce=reduce)

    devices = [str(rt.device)]
    if rt.world > 1:
        import torch.distributed as dist

        devices = [None] * rt.world
        dist.all_gather_object(devices, str(rt.device))
    panels = {"f_raw": (ft, 1), "f": (f, 0), "f_obs": (f_obs, 0),
              "ne_obs": (ne_obs, 0), "f_loo": (f_loo, 1), "f_z": (f_z, 1)}
    gathered = {key: rt.gather_sites(t, axis) for key, (t, axis)
                in panels.items()}
    if not rt.is_primary():
        return None
    out = {key: t.cpu().numpy() for key, t in gathered.items()}
    out["f_raw"] = np.ascontiguousarray(out["f_raw"].T)  # [M, K]
    out.update(
        ll=ll.cpu().numpy(), ne_ind=ne_ind.cpu().numpy(), iters=iters,
        converged=converged, loo_iters=loo_iters, z_iters=z_iters,
        backend=np.asarray(rt.backend or "none"),
        devices=np.asarray(devices),
        **{f"launches_{name}": np.asarray(count)
           for name, count in _kernels.launches.items()})
    return out


def _dryrun_rank(rank, world, address, device, out_path):
    """One rank of :func:`dryrun_multichip` (a spawned process); rank 0
    writes the gathered results to ``out_path``."""
    from wgsassign_tpu_torch.parallel.runtime import (
        make_runtime,
        shutdown_distributed,
    )

    rt = make_runtime(device, ranks=(address, world, rank))
    problem = synthetic_problem(DRY_SITES_PER_RANK * world, DRY_N, DRY_K,
                                seed=1)
    out = _dryrun_step(rt, problem)
    if out is not None:
        np.savez(out_path, **out)
    shutdown_distributed(rt)


def _check_against_one_rank(got: dict, want: dict) -> None:
    for key in _ITER_KEYS:
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"dry run: {key} {got[key]} on several "
                                 f"ranks, {want[key]} on one")
    for key in _AF_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=DRY_AF_ATOL, err_msg=key)
    for key in _SUM_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=DRY_SUM_RTOL,
                                   atol=DRY_SUM_ATOL, err_msg=key)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The reference-AF EM (8 iterations), AF clamp, assignment
    log-likelihoods, Fisher/Ne, a batched leave-one-out EM and a LOO-subset
    EM (4 iterations each) on ``n_devices`` ranks, one spawned process each
    with a window of the site axis of ``synthetic_problem(16 n, 12, 3,
    seed=1)``, held against one rank in this process; then the port's CLI
    (``--get_reference_af --loo --maf_iter 8``) on ``n_devices`` ranks on a
    small synthetic Beagle file.

    On ``cuda`` rank r takes ``cuda:{r % device_count}``: with a card a rank
    the collectives go over NCCL, ranks that share a card use gloo (see
    :func:`wgsassign_tpu_torch.parallel.runtime.maybe_initialize_distributed`).
    A failed rank or a mismatch raises.  Prints one OK line (with the
    call's wall seconds) and returns rank 0's gathered results as a dict of
    numpy arrays.
    """
    from wgsassign_tpu_torch.cli import run_on_local_ranks
    from wgsassign_tpu_torch.io.synth import synth_cohort, write_beagle
    from wgsassign_tpu_torch.parallel.runtime import (
        make_runtime,
        run_local_ranks,
    )

    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs at least one rank, got "
                         f"{n_devices}")
    device = _device(device)
    t0 = time.perf_counter()
    rank_device = device.type  # each rank picks its own card
    what = f"dryrun_multichip({n_devices})"
    problem = synthetic_problem(DRY_SITES_PER_RANK * n_devices, DRY_N, DRY_K,
                                seed=1)
    with tempfile.TemporaryDirectory() as td:
        out_path = os.path.join(td, "rank0.npz")
        run_local_ranks(_dryrun_rank, n_devices, rank_device, out_path,
                        what=what)
        with np.load(out_path) as saved:
            got = dict(saved)
        _check_against_one_rank(got, _dryrun_step(make_runtime(device),
                                                  problem))

        gl, labels, _ = synth_cohort(64, 12, n_pops=3, seed=3)
        beagle, ids, out = (os.path.join(td, name) for name in
                            ("dry.beagle.gz", "ids.txt", "dry"))
        write_beagle(beagle, gl)
        with open(ids, "w") as fh:
            for i, lab in enumerate(labels):
                fh.write(f"Ind{i}\t{lab}\n")
        # --devices n as it runs on a host with n cards: n ranks even where
        # they share one card
        run_on_local_ranks(
            ["--beagle", beagle, "--pop_af_IDs", ids, "--get_reference_af",
             "--loo", "--maf_iter", "8", "--devices", str(n_devices),
             "--out", out], rank_device, n_devices)
        af = np.load(out + ".pop_af.npy")
        if af.shape != (64, 3) or not np.isfinite(af).all():
            raise AssertionError(f"{what}: the CLI's .pop_af.npy has shape "
                                 f"{af.shape} or non-finite values")
    print(f"{what}: OK -- EM + clamp + LL + Fisher/Ne + LOO + LOO-subset on "
          f"{n_devices} rank(s), world {n_devices}, backend {got['backend']}, "
          f"devices {','.join(got['devices'])}, match one rank; the CLI ran "
          f"on {n_devices} rank(s); {time.perf_counter() - t0:.3f} s",
          flush=True)
    return got
