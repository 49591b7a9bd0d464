"""Reference-population allele-frequency estimation (``--get_reference_af``).

Counterpart of ``wgsassign_tpu/models/reference_af.py``: the all-K MAF EM
(reference emMAF.py:15-27) followed by clamping to ``[1/(2(n+1)),
1-1/(2(n+1))]`` (WGSassign.py:236-240), all K populations batched.  The EM
runs through the chunked EM: on a GPU its chunks are the ``em_chunk``
kernel, whose member loop has no individual-count bound.  Under
``--no_pallas`` (``Runtime.use_kernels`` False) the plain
:func:`wgsassign_tpu_torch.ops.emmaf.em_maf_pops` runs instead.

With several ranks each rank estimates its window of the site axis; the
``[K, per]`` panels are gathered for ``.pop_af.npy`` (every rank gets the
``[M, K]`` result, which ``--ne_obs`` and ``--loo`` take as input), and the
clamped panel stays on each rank for the LOO.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from wgsassign_tpu_torch.io.beagle import BeagleData
from wgsassign_tpu_torch.io.ids import PopulationMap
from wgsassign_tpu_torch.models.common import (
    DeviceCohort,
    from_jax_arrays,
    gather_real_sites,
    to_device,
)
from wgsassign_tpu_torch.obs.checkpoint import make_checkpoint
from wgsassign_tpu_torch.obs.profiling import count, span
from wgsassign_tpu_torch.ops.em_chunk import em_chunk
from wgsassign_tpu_torch.ops.emmaf import _EM_EPS, em_maf_pops
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
    # what ran the EM: "em_chunk" (the chunked EM) or "plain"
    engine: str = "em_chunk"


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
    with span("wgsa.refaf.em"):
        if rt.chunked_em():  # on a GPU: build, load and probe, or raise
            engine = "em_chunk"
            ft, iters, converged = em_maf_pops_fused(
                cohort.g0,
                cohort.g1,
                popmap.membership,
                cohort.site_weight,
                cohort.m_real,
                max_iter,
                tol,
                checkpoint=make_checkpoint(checkpoint_path, cohort, _EM_EPS),
                fast_math=rt.fast_math,
                return_device_panel=True,
                chunk_op=chunk_op,
                reduce=rt.all_reduce_sum,
            )
        else:
            engine = "plain"
            membership, pop_index = from_jax_arrays(
                popmap.membership, popmap.pop_index, device=rt.device)
            f, iters, converged = em_maf_pops(
                cohort.g0, cohort.g1, membership, pop_index,
                cohort.site_weight, cohort.m_real, max_iter, tol,
                reduce=rt.all_reduce_sum,
            )
            ft = f.t().contiguous()
            iters, converged = iters.cpu().numpy(), converged.cpu().numpy()
    # clamp on the device in the site-minor layout (padded sites clamp to
    # min_val, harmless: everything downstream weights them to zero), keep
    # the panel for the LOO mini-banks, fetch one host copy for .pop_af.npy
    min_val = 1.0 / (2.0 * (popmap.pop_sizes.astype(np.float32) + 1.0))
    with span("wgsa.refaf.clamp"):
        af_t_dev = _clamp_rows(ft, min_val)
    with span("wgsa.refaf.fetch"):
        af = np.ascontiguousarray(
            gather_real_sites(cohort, af_t_dev, axis=1, to_all=True).T
        ).astype(np.float32)
    count("host_syncs")
    return ReferenceAFResult(
        af=af,
        pops=popmap.pops,
        iters=np.asarray(iters),
        converged=np.asarray(converged),
        af_t_dev=af_t_dev,
        engine=engine,
    )
