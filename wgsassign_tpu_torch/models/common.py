"""Device-resident cohort and array conversion."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wgsassign_tpu_torch.parallel.runtime import (
    PAD_AF,
    PAD_G0,
    PAD_G1,
    Runtime,
    pad_sites,
    site_weight_vector,
)


@dataclass
class DeviceCohort:
    """Genotype likelihood panels resident on ``runtime.device``.

    ``g0``/``g1`` are float32 ``[M_pad, N]``; ``site_weight`` is 1.0 on the
    first ``m_real`` rows, 0.0 on padding (which holds the (1, 0) GL
    pattern).
    """

    g0: torch.Tensor
    g1: torch.Tensor
    site_weight: torch.Tensor
    m_real: int
    runtime: Runtime

    @property
    def m_pad(self) -> int:
        return self.g0.shape[0]

    @property
    def n_inds(self) -> int:
        return self.g0.shape[1]


def to_device(beagle, runtime: Runtime, site_multiple: int = 1) -> DeviceCohort:
    """Pad a parsed :class:`wgsassign_tpu.io.beagle.BeagleData` to a
    multiple of ``site_multiple`` sites (the ``--partition_sites`` count)
    and copy it to the device, one host-to-device copy per GL plane."""
    g0_h = pad_sites(np.ascontiguousarray(beagle.gl[:, :, 0]), site_multiple,
                     PAD_G0)
    g1_h = pad_sites(np.ascontiguousarray(beagle.gl[:, :, 1]), site_multiple,
                     PAD_G1)
    m_real = beagle.n_sites
    w = site_weight_vector(m_real, g0_h.shape[0])
    g0, g1, sw = from_jax_arrays(g0_h, g1_h, w, device=runtime.device)
    return DeviceCohort(g0=g0, g1=g1, site_weight=sw, m_real=m_real,
                        runtime=runtime)


def from_jax_arrays(*arrays, device) -> tuple:
    """NumPy arrays of the JAX package (GL planes ``[M, N]``, ``[K, M]`` AF
    panels, ``pop_af.npy`` ``[M, K]``, index tables) as tensors on
    ``device``.  The port keeps the JAX package's layouts at its public
    functions, so this is a plain copy: floating arrays become float32,
    integer and boolean arrays keep their type."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        if a.dtype.kind == "f":
            a = a.astype(np.float32, copy=False)
        out.append(torch.from_numpy(a).to(device))
    return tuple(out)


def pad_af_to(af: np.ndarray, m_pad: int) -> np.ndarray:
    """Pad an ``[M, K]`` AF panel's site axis up to ``m_pad`` with 0.5."""
    m = af.shape[0]
    if m == m_pad:
        return af
    return np.pad(af, [(0, m_pad - m), (0, 0)], constant_values=PAD_AF)
