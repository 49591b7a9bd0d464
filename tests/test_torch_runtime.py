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
    assert rt.kernels_enabled() is False
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
