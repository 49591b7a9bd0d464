"""Reference-population allele-frequency estimation (``--get_reference_af``).

Counterpart of ``wgsassign_tpu/models/reference_af.py``: the all-K MAF EM
(reference emMAF.py:15-27) followed by clamping to ``[1/(2(n+1)),
1-1/(2(n+1))]`` (WGSassign.py:236-240), all K populations batched.  The EM
always runs through the chunked EM: on a GPU its chunks are the
``em_chunk`` kernel, whose member loop has no individual-count bound.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from wgsassign_tpu_torch.io.beagle import BeagleData
from wgsassign_tpu_torch.io.ids import PopulationMap
from wgsassign_tpu_torch.models.common import DeviceCohort, to_device
from wgsassign_tpu_torch.obs.checkpoint import EMCheckpoint
from wgsassign_tpu_torch.ops.em_chunk import em_chunk
from wgsassign_tpu_torch.ops.fused_em import em_maf_pops_fused
from wgsassign_tpu_torch.parallel.runtime import Runtime


def _clamp_rows(ft, min_val):
    """Per-row clamp of a site-minor ``[K, M]`` panel on the device."""
    mv = torch.from_numpy(np.asarray(min_val, np.float32)).to(ft.device)
    return torch.clamp(ft, mv[:, None], 1.0 - mv[:, None])


@dataclass
class ReferenceAFResult:
    af: np.ndarray          # float32 [M, K], clamped
    pops: np.ndarray        # [K] population names (sorted unique order)
    iters: np.ndarray       # int32 [K] 1-based EM convergence iteration
    converged: np.ndarray   # bool [K]
    # the clamped [K, m_pad] site-minor panel on the device: the LOO
    # pipeline builds its mini-banks from it with no host round trip
    af_t_dev: Optional[torch.Tensor] = None


def estimate_reference_af(
    beagle: BeagleData,
    popmap: PopulationMap,
    max_iter: int = 200,
    tol: float = 1e-4,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
    checkpoint_path: Optional[str] = None,
    chunk_op=em_chunk,
) -> ReferenceAFResult:
    """``chunk_op`` is the EM chunk function (see
    :func:`wgsassign_tpu_torch.ops.fused_em.em_maf_pops_fused`)."""
    if beagle.n_inds != popmap.n_inds:
        raise ValueError(
            "Number of individuals in beagle and reference ID file do not match!"
        )
    if cohort is None:
        cohort = to_device(beagle, runtime)
    rt = cohort.runtime
    rt.kernels_enabled()  # on a GPU: build, load and probe, or raise
    ckpt = EMCheckpoint(checkpoint_path) if checkpoint_path else None
    ft, iters, converged = em_maf_pops_fused(
        cohort.g0,
        cohort.g1,
        popmap.membership,
        cohort.site_weight,
        cohort.m_real,
        max_iter,
        tol,
        checkpoint=ckpt,
        fast_math=rt.fast_math,
        return_device_panel=True,
        chunk_op=chunk_op,
    )
    # clamp on the device in the site-minor layout (padded sites clamp to
    # min_val, harmless: everything downstream weights them to zero), keep
    # the panel for the LOO mini-banks, fetch one host copy for .pop_af.npy
    min_val = 1.0 / (2.0 * (popmap.pop_sizes.astype(np.float32) + 1.0))
    af_t_dev = _clamp_rows(ft, min_val)
    af = np.ascontiguousarray(
        af_t_dev[:, : cohort.m_real].t().cpu().numpy()
    ).astype(np.float32)
    return ReferenceAFResult(
        af=af,
        pops=popmap.pops,
        iters=np.asarray(iters),
        converged=np.asarray(converged),
        af_t_dev=af_t_dev,
    )
