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
