"""The port's chunked EMs and plain EMs against the JAX package's.

The JAX package's fused EMs run their Pallas kernels in interpret mode, as
tests/test_pallas.py does on the CPU.  Convergence iteration counts must be
equal; AF agrees to atol 1e-5 (member sums in another order, a few float32
ulps per iteration over up to 200 iterations).  Checkpoints written by
either package resume in the other.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from wgsassign_tpu.obs.checkpoint import EMCheckpoint as JaxEMCheckpoint
from wgsassign_tpu.ops import emmaf as jax_emmaf
from wgsassign_tpu.ops import pallas_emmaf as jax_fused
from wgsassign_tpu_torch.models.common import from_jax_arrays
from wgsassign_tpu_torch.obs.checkpoint import EMCheckpoint
from wgsassign_tpu_torch.ops import emmaf, fused_em
from wgsassign_tpu_torch.ops.loo_chunk import loo_chunk_twin
from wgsassign_tpu_torch.ops.zloo_chunk import zloo_chunk_twin

CASES = [
    (1e-4, 200, 16),   # normal convergence, mid-chunk crossings + replay
    (0.0, 12, 5),      # fixed iterations, uneven final chunk
    (1e-2, 200, 64),   # fast convergence inside the first chunk
]


def _problem(m=96, n=24, k=3, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)
    g0, g1 = raw[:, :, 0].copy(), raw[:, :, 1].copy()
    pop_index = (np.arange(n) % k).astype(np.int32)
    membership = np.zeros((n, k), dtype=np.float32)
    membership[np.arange(n), pop_index] = 1.0
    return g0, g1, membership, pop_index, np.ones(m, np.float32)


def _loo_problem(m=96, n_p=7, seed=11):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(m, n_p)).astype(np.float32)
    g0p = np.ascontiguousarray(raw[:, :, 0].T)  # [n_p, M] site-minor
    g1p = np.ascontiguousarray(raw[:, :, 1].T)
    return g0p, g1p, np.ones(m, np.float32)


def _pad_sites(g0, g1, sw, pad, axis):
    """Append ``pad`` sites of the (1, 0) padding pattern, weight 0."""
    shape = list(g0.shape)
    shape[axis] = pad
    return (np.concatenate([g0, np.ones(shape, np.float32)], axis=axis),
            np.concatenate([g1, np.zeros(shape, np.float32)], axis=axis),
            np.concatenate([sw, np.zeros(pad, np.float32)]))


@pytest.mark.parametrize("tol,max_iter,chunk", CASES)
def test_pops_fused_matches_jax(tol, max_iter, chunk):
    g0, g1, membership, _, sw = _problem()
    m = g0.shape[0]
    f_ref, it_ref, conv_ref = jax_fused.em_maf_pops_fused(
        g0, g1, membership, sw, m, max_iter, tol, chunk=chunk, interpret=True
    )
    g0t, g1t, swt = from_jax_arrays(g0, g1, sw, device="cpu")
    f, it, conv = fused_em.em_maf_pops_fused(
        g0t, g1t, membership, swt, m, max_iter, tol, chunk=chunk
    )
    np.testing.assert_array_equal(it, np.asarray(it_ref))
    np.testing.assert_array_equal(conv, np.asarray(conv_ref))
    np.testing.assert_allclose(f, np.asarray(f_ref), rtol=0, atol=1e-5)


def test_pops_fused_padded_sites_match_jax():
    g0, g1, membership, _, sw = _problem(m=64)
    g0p, g1p, swp = _pad_sites(g0, g1, sw, 32, axis=0)
    f_ref, it_ref, _ = jax_fused.em_maf_pops_fused(
        g0p, g1p, membership, swp, 64, 200, 1e-4, chunk=8, interpret=True
    )
    f, it, _ = fused_em.em_maf_pops_fused(
        *from_jax_arrays(g0p, g1p, device="cpu"), membership,
        torch.from_numpy(swp), 64, 200, 1e-4, chunk=8,
    )
    np.testing.assert_array_equal(it, np.asarray(it_ref))
    np.testing.assert_allclose(f[:64], np.asarray(f_ref)[:64], rtol=0,
                               atol=1e-5)
    # padded sites sit at their fixed point
    assert np.all(f[64:] == np.float32(1e-7))


@pytest.mark.parametrize("tol,max_iter,chunk", [
    (1e-4, 200, 8), (0.0, 12, 5), (1e-2, 200, 64),
])
def test_loo_fused_matches_jax(tol, max_iter, chunk):
    g0p, g1p, _ = _loo_problem()
    m = g0p.shape[1]
    f_ref, it_ref, conv_ref = jax_fused.em_maf_loo_group_fused(
        g0p, g1p, m, max_iter, tol, chunk=chunk, interpret=True
    )
    f, it, conv = fused_em.em_maf_loo_group_fused(
        *from_jax_arrays(g0p, g1p, device="cpu"), m, max_iter, tol,
        chunk=chunk,
    )
    np.testing.assert_array_equal(it, np.asarray(it_ref))
    np.testing.assert_array_equal(conv, np.asarray(conv_ref))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=1e-5)


def test_loo_fused_padded_sites_match_jax():
    g0p, g1p, sw = _loo_problem(m=64, n_p=5, seed=12)
    g0pp, g1pp, _ = _pad_sites(g0p, g1p, sw, 32, axis=1)
    f_ref, it_ref, _ = jax_fused.em_maf_loo_group_fused(
        g0pp, g1pp, 64, 200, 1e-4, chunk=8, interpret=True
    )
    f, it, _ = fused_em.em_maf_loo_group_fused(
        *from_jax_arrays(g0pp, g1pp, device="cpu"), 64, 200, 1e-4, chunk=8
    )
    np.testing.assert_array_equal(it, np.asarray(it_ref))
    np.testing.assert_allclose(f.numpy()[:, :64], np.asarray(f_ref)[:, :64],
                               rtol=0, atol=1e-5)


def test_plain_em_maf_pops_matches_jax():
    g0, g1, membership, pop_index, sw = _problem(m=80, seed=4)
    f_ref, it_ref, conv_ref = jax_emmaf.em_maf_pops(
        g0, g1, membership, pop_index, sw, 80, 200, 1e-4
    )
    f, it, conv = emmaf.em_maf_pops(
        *from_jax_arrays(g0, g1, membership, pop_index, sw, device="cpu"),
        80, 200, 1e-4,
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_ref))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=1e-5)
    n = membership.sum(axis=0)
    np.testing.assert_allclose(
        emmaf.clamp_af(f, torch.from_numpy(n)).numpy(),
        np.asarray(jax_emmaf.clamp_af(f_ref, n)), rtol=0, atol=1e-5)


def test_plain_em_maf_loo_group_matches_jax():
    g0p, g1p, sw = _loo_problem(m=80, n_p=6, seed=5)
    f_ref, it_ref, conv_ref = jax_emmaf.em_maf_loo_group(
        g0p, g1p, sw, 80, 200, 1e-4
    )
    f, it, conv = emmaf.em_maf_loo_group(
        *from_jax_arrays(g0p, g1p, sw, device="cpu"), 80, 200, 1e-4
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_ref))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=1e-5)


class _Stop(Exception):
    pass


def _interrupt_after(ckpt, n_saves):
    """Make ``ckpt`` raise _Stop once it has saved ``n_saves`` times."""
    orig = ckpt.maybe_save
    calls = []

    def counting(f, iters, active, it):
        orig(f, iters, active, it)
        calls.append(it)
        if len(calls) == n_saves:
            raise _Stop()

    ckpt.maybe_save = counting


def _run_pops(pkg, g0, g1, membership, sw, ckpt):
    if pkg == "jax":
        f, it, _ = jax_fused.em_maf_pops_fused(
            g0, g1, membership, sw, 64, 60, 1e-5, chunk=8, interpret=True,
            checkpoint=ckpt)
        return np.asarray(f), np.asarray(it)
    f, it, _ = fused_em.em_maf_pops_fused(
        *from_jax_arrays(g0, g1, device="cpu"), membership,
        torch.from_numpy(sw), 64, 60, 1e-5, chunk=8, checkpoint=ckpt)
    return f, it


def _run_loo(pkg, g0p, g1p, ckpt):
    if pkg == "jax":
        f, it, _ = jax_fused.em_maf_loo_group_fused(
            g0p, g1p, 64, 60, 1e-5, chunk=8, interpret=True, checkpoint=ckpt)
        return np.asarray(f), np.asarray(it)
    f, it, _ = fused_em.em_maf_loo_group_fused(
        *from_jax_arrays(g0p, g1p, device="cpu"), 64, 60, 1e-5, chunk=8,
        checkpoint=ckpt)
    return f.numpy(), it


_CKPT = {"jax": JaxEMCheckpoint, "torch": EMCheckpoint}


@pytest.mark.parametrize("kind", ["pops", "loo"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_checkpoint_interchange(tmp_path, kind, writer, reader):
    """Interrupt one package's chunked EM after 3 checkpoints; the other
    package resumes from the file and lands on its own uninterrupted
    result: same iterations, AF within the parity tolerance."""
    if kind == "pops":
        g0, g1, membership, _, sw = _problem(m=64, n=16, k=2, seed=3)

        def run(pkg, ckpt):
            return _run_pops(pkg, g0, g1, membership, sw, ckpt)
    else:
        g0p, g1p, _ = _loo_problem(m=64, n_p=5, seed=7)

        def run(pkg, ckpt):
            return _run_loo(pkg, g0p, g1p, ckpt)

    full, it_full = run(reader, None)
    path = str(tmp_path / "em.ckpt.npz")
    ck_w = _CKPT[writer](path, interval_chunks=1)
    _interrupt_after(ck_w, 3)
    with pytest.raises(_Stop):
        run(writer, ck_w)
    ck_r = _CKPT[reader](path, interval_chunks=1)
    assert ck_r.load() is not None and ck_r.load()[3] == 24
    resumed, it_res = run(reader, ck_r)
    np.testing.assert_array_equal(it_res, it_full)
    np.testing.assert_allclose(resumed, full, rtol=0, atol=1e-5)
    assert ck_r.load() is None  # cleared on completion


def _schedule_op(schedule):
    """A chunk function over problems whose k-th update has the squared
    update ``schedule[p, k]``; the state's column 0 counts a problem's
    updates, column 1 moves by a float32 map, so a stop one iteration early
    or late changes both."""
    sched = torch.from_numpy(np.asarray(schedule, np.float32))
    rows = torch.arange(sched.shape[0])

    def chunk(ft, limits, T):
        f = ft.clone()
        sq = torch.zeros((T, f.shape[0]), dtype=torch.float32)
        for t in range(T):
            run = torch.as_tensor(limits) > t
            k = f[:, 0].long().clamp(max=sched.shape[1] - 1)
            sq[t] = torch.where(run, sched[rows, k], 0.0)
            moved = torch.stack([f[:, 0] + 1.0, f[:, 1] * 0.75 + 0.125], 1)
            f = torch.where(run[:, None], moved, f)
        return f, sq

    return chunk


def _geometric(p, n, start, ratio):
    return start * ratio ** np.arange(n)[None, :] * np.ones((p, 1))


def _schedule_case(schedule, max_iter, tol, m_real):
    """Both drivers on ``_schedule_op(schedule)``."""
    chunk = _schedule_op(schedule)
    p = len(schedule)
    ft0 = torch.zeros((p, 2), dtype=torch.float32)
    ft0[:, 1] = 0.5
    old = fused_em._drive_chunks(
        lambda ft, lv, T: chunk(ft, lv, T), None, ft0, p, max_iter, tol,
        m_real, 8, None, name="test_old")
    new = fused_em._drive_steps(
        lambda ft, limits: chunk(ft, limits, 1), None, ft0, p, max_iter, tol,
        m_real, None, name="test_new")
    return old, new


def _loo_case():
    g0p, g1p, _ = _loo_problem(m=80, n_p=6, seed=21)
    g0t, g1t = from_jax_arrays(g0p, g1p, device="cpu")
    n_p, m = g0t.shape

    def run_chunk(ft, lv, T):
        return loo_chunk_twin(g0t, g1t, ft, torch.from_numpy(lv), n_p, T)

    ft0 = fused_em._device_init_ft((n_p, m), m, g0t.device)
    old = fused_em._drive_chunks(run_chunk, None, ft0, n_p, 200, 1e-4, m, 8,
                                 None, name="test_old")
    f, it, conv = fused_em.em_maf_loo_group_fused(g0t, g1t, m, 200, 1e-4)
    return old, (f, it, ~conv)


def _zloo_case():
    g0p, g1p, _ = _loo_problem(m=90, n_p=7, seed=22)
    g0t, g1t = from_jax_arrays(g0p, g1p, device="cpu")
    rng = np.random.default_rng(23)
    leave = np.asarray([0, 2, 3, 6, 9], np.int32)  # 9: leaves nothing out
    sw = torch.from_numpy((rng.random((5, 90)) < 0.7).astype(np.float32))
    m_real = sw.sum(dim=1).numpy()
    n_p = g0t.shape[0]
    leave_t = torch.from_numpy(leave)

    def run_chunk(ft, lv, T):
        return zloo_chunk_twin(g0t, g1t, ft, sw, leave_t,
                               torch.from_numpy(lv), n_p, T)

    ft0 = torch.full((5, 90), 0.25)
    old = fused_em._drive_chunks(run_chunk, None, ft0, 5, 200, 1e-4, m_real,
                                 8, None, name="test_old")
    f, it, conv = fused_em.em_maf_loo_subset_fused(g0t, g1t, leave, sw,
                                                   m_real, 200, 1e-4)
    return old, (f, it, ~conv)


def _crossings():
    # problem p's squared update drops below tol^2 * m_real at update k_p:
    # inside the first chunk, at a chunk's end, inside the second, later
    sched = np.ones((4, 40))
    for p, k in enumerate((3, 7, 11, 17)):
        sched[p, k:] = 1e-12
    return _schedule_case(sched, 40, 1e-4, 100)


def _first_iteration():
    sched = _geometric(3, 30, 1.0, 0.5)
    sched[1, :] = 0.0  # converged after its first update
    return _schedule_case(sched, 30, 1e-4, 50)


def _never():
    sched = _geometric(3, 30, 1.0, 0.5)
    sched[0, :] = 1.0  # never below tol: runs max_iter updates
    sched[2, :12] = np.nan  # a NaN never converges; later ones do
    return _schedule_case(sched, 30, 1e-4, 50)


def _per_problem_m_real():
    # one squared-update sequence, four site counts: four stops
    sched = _geometric(4, 60, 1.0, 0.7)
    return _schedule_case(sched, 60, 1e-3,
                          np.asarray([1.0, 1e2, 1e4, 1e6], np.float32))


def _zero_or_negative_sq():
    sched = _geometric(4, 30, 1.0, 0.8)
    sched[0, 5] = 0.0
    sched[1, 9] = -1.0  # max(sq, 0) = 0: converged
    sched[2, 0] = -0.0
    return _schedule_case(sched, 30, 1e-5, 10)


@pytest.mark.parametrize("case", [
    _crossings, _first_iteration, _never, _per_problem_m_real,
    _zero_or_negative_sq, _loo_case, _zloo_case])
def test_steps_driver_matches_chunks_and_replays(case):
    """The one-iteration driver with the test on the device stops every
    problem where the chunked driver's replays stop it: equal iterations
    and convergence, the state equal bit for bit."""
    (f_old, it_old, act_old), (f_new, it_new, act_new) = case()
    np.testing.assert_array_equal(it_new, it_old)
    np.testing.assert_array_equal(act_new, act_old)
    assert it_new.dtype == np.int32 and act_new.dtype == bool
    assert torch.equal(f_new, f_old)
