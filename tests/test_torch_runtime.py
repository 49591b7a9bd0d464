"""The port's runtime and device cohort (``wgsassign_tpu_torch.parallel.
runtime``, ``wgsassign_tpu_torch.models.common``) against the single-device
helpers of the JAX package's ``parallel/mesh.py``.  Exact comparisons: both
sides only pad and copy."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from wgsassign_tpu.io.beagle import BeagleData
from wgsassign_tpu.parallel import mesh as jax_mesh
from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.models.common import from_jax_arrays, to_device
from wgsassign_tpu_torch.parallel import runtime


@pytest.mark.parametrize("m,multiple", [(10, 1), (10, 4), (12, 4), (7, 3)])
def test_pad_helpers_match_jax(m, multiple):
    arr = np.arange(m * 2, dtype=np.float32).reshape(m, 2)
    got = runtime.pad_sites(arr, multiple, runtime.PAD_G0)
    want = jax_mesh.pad_sites(arr, multiple, jax_mesh.PAD_G0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        runtime.site_weight_vector(m, got.shape[0]),
        jax_mesh.site_weight_vector(m, want.shape[0]))
    assert (runtime.PAD_G0, runtime.PAD_G1, runtime.PAD_AF) == (
        jax_mesh.PAD_G0, jax_mesh.PAD_G1, jax_mesh.PAD_AF)


def test_cpu_runtime_launches_no_kernel():
    rt = runtime.make_runtime("cpu", fast_math=False)
    before = dict(_kernels.launches)
    rt.load_kernels()
    assert dict(_kernels.launches) == before
    assert not rt.fast_math and not rt.debug_checks
    # the counterpart of Precision.HIGHEST: no TF32 in float32 products
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_to_device_pads_to_the_partition_multiple():
    rng = np.random.default_rng(0)
    gl = rng.dirichlet(np.ones(3), size=(10, 4)).astype(np.float32)
    beagle = BeagleData(gl, [f"i{j}" for j in range(4)],
                        [f"s{j}" for j in range(10)])
    cohort = to_device(beagle, runtime.make_runtime("cpu"), site_multiple=4)
    assert (cohort.m_pad, cohort.m_real, cohort.n_inds) == (12, 10, 4)
    assert cohort.g0.dtype == torch.float32 and cohort.g0.is_contiguous()
    np.testing.assert_array_equal(cohort.g0[:10].numpy(), gl[:, :, 0])
    np.testing.assert_array_equal(cohort.g1[:10].numpy(), gl[:, :, 1])
    assert torch.all(cohort.g0[10:] == 1.0) and torch.all(cohort.g1[10:] == 0.0)
    np.testing.assert_array_equal(cohort.site_weight.numpy(),
                                  jax_mesh.site_weight_vector(10, 12))


def test_from_jax_arrays_keeps_layout_and_integer_types():
    af = np.linspace(0.1, 0.9, 6).reshape(3, 2)  # float64, e.g. pop_af [M, K]
    idx = np.arange(4, dtype=np.int32)
    mask = np.array([True, False])
    a, b, c = from_jax_arrays(af, idx, mask, device="cpu")
    assert a.dtype == torch.float32 and tuple(a.shape) == (3, 2)
    assert b.dtype == torch.int32 and c.dtype == torch.bool
    np.testing.assert_array_equal(a.numpy(), af.astype(np.float32))
    np.testing.assert_array_equal(b.numpy(), idx)


def test_one_rank_never_touches_torch_distributed(monkeypatch):
    """With ``world == 1`` (no ``WGSA_*`` variables) every rank helper is the
    identity and no process group is made."""
    import torch.distributed as dist

    for var in ("WGSA_COORDINATOR_ADDRESS", "WGSA_NUM_PROCESSES",
                "WGSA_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)

    def forbidden(*a, **k):
        raise AssertionError("torch.distributed was called with one rank")

    for name in ("init_process_group", "all_reduce", "all_gather", "gather",
                 "barrier", "broadcast_object_list", "new_group"):
        monkeypatch.setattr(dist, name, forbidden)
    assert runtime.distributed_env() is None
    rt = runtime.make_runtime("cpu")
    assert (rt.rank, rt.world, rt.backend, rt.group) == (0, 1, "", None)
    assert rt.is_primary()
    t = torch.arange(6.0).reshape(2, 3)
    assert rt.all_reduce_sum(t) is t
    assert rt.gather_sites(t, axis=1) is t
    assert rt.gather_sites(t, to_all=True) is t
    assert rt.broadcast_object({"a": 1}) == {"a": 1}
    rt.barrier()
    runtime.shutdown_distributed(rt)
    assert not dist.is_initialized()


def test_distributed_env_reads_the_jax_packages_variables(monkeypatch):
    monkeypatch.setenv("WGSA_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("WGSA_NUM_PROCESSES", "4")
    monkeypatch.setenv("WGSA_PROCESS_ID", "3")
    assert runtime.distributed_env() == ("10.0.0.1:1234", 4, 3)


@pytest.mark.parametrize("world, extra, want", [(1, 1, 1), (1, 3, 3),
                                                (2, 1, 2), (4, 3, 12)])
def test_site_multiple_is_world_times_extra(world, extra, want):
    """The JAX runtime's rule without its 256-site Pallas tile."""
    rt = runtime.Runtime(device=torch.device("cpu"), world=world)
    assert rt.site_multiple(extra) == want


def test_shard_to_device_pads_the_window():
    """A rank's rows go to the first rows of its block; the rest holds the
    padding pattern with weight 0, and ``m_real`` is the global count."""
    from wgsassign_tpu_torch.io.beagle import BeagleData as TorchBeagleData
    from wgsassign_tpu_torch.io.beagle import BeagleShard, process_row_range
    from wgsassign_tpu_torch.models.common import gather_real_sites, local_rows

    rng = np.random.default_rng(1)
    gl = rng.dirichlet(np.ones(3), size=(10, 4)).astype(np.float32)
    names = [f"i{j}" for j in range(4)]
    rt = runtime.Runtime(device=torch.device("cpu"), rank=1, world=2)
    lo, hi, per = process_row_range(10, 4, rank=1, world=2)
    assert (lo, hi, per) == (8, 10, 8)
    shard = BeagleShard(
        TorchBeagleData(gl[lo:hi], names, [f"s{j}" for j in range(lo, hi)]),
        m_global=10, lo=lo, hi=hi, rows_per_process=per)
    cohort = to_device(shard, rt, site_multiple=4)
    assert (cohort.m_pad, cohort.m_real, cohort.lo, cohort.hi,
            cohort.n_local) == (8, 10, 8, 10, 2)
    np.testing.assert_array_equal(cohort.g0[:2].numpy(), gl[8:, :, 0])
    assert torch.all(cohort.g0[2:] == 1.0) and torch.all(cohort.g1[2:] == 0.0)
    np.testing.assert_array_equal(cohort.site_weight.numpy(),
                                  [1, 1, 0, 0, 0, 0, 0, 0])
    af = np.arange(20, dtype=np.float32).reshape(10, 2)
    rows = local_rows(af, cohort, 0.5)
    np.testing.assert_array_equal(rows[:2], af[8:])
    assert rows.shape == (8, 2) and (rows[2:] == 0.5).all()
    with pytest.raises(ValueError, match="not a multiple"):
        to_device(shard, rt, site_multiple=3)
    with pytest.raises(ValueError, match="several ranks"):
        to_device(TorchBeagleData(gl, names, []), rt)
    # one rank: the gather is a crop to the real sites
    one = to_device(TorchBeagleData(gl, names, []),
                    runtime.make_runtime("cpu"), site_multiple=4)
    got = gather_real_sites(one, one.g0, axis=0)
    np.testing.assert_array_equal(got, gl[:, :, 0])
