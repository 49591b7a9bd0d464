"""Fisher-information effective sample sizes (``--ne_obs``).

Counterpart of ``wgsassign_tpu/models/ne.py`` (reference
fisher.fisher_obs / fisher_obs_ind, fisher.py:11-59): one device pass per
site block.  With several ranks each rank takes its window of the site
axis: the per-site ``f_obs``/``ne_obs`` rows are gathered to rank 0 (None on
the other ranks) and the per-individual sums are added over the ranks.
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
    local_rows,
    to_device,
)
from wgsassign_tpu_torch.ops.fisher import fisher_obs_pops
from wgsassign_tpu_torch.parallel.runtime import PAD_AF, Runtime


@dataclass
class NeResult:
    f_obs: np.ndarray   # float32 [M, K] observed Fisher information
    ne_obs: np.ndarray  # float32 [M, K] per-site effective sample size
    ne_ind: np.ndarray  # float32 [N] per-individual Ne (mean over sites)


# Site-block size cap: the Fisher op materialises several float32 [block, N]
# temporaries (th, term and the pieces of both), so a block holds at most
# this many bytes per temporary.  At 1M sites x 180 individuals each is
# 720 MB and the whole axis is one block; a few of them fit an 80 GB card
# beside the cohort.  Blocks change nothing numerically except the float64
# association of the ne_ind partial sums.
_BLOCK_TEMP_BYTES = 4 << 30


def effective_sample_sizes(
    beagle: BeagleData,
    af: np.ndarray,
    popmap: PopulationMap,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
    site_block: Optional[int] = None,
) -> NeResult:
    if cohort is None:
        cohort = to_device(beagle, runtime)
    rt = cohort.runtime
    dev = rt.device
    m_pad, n = cohort.m_pad, cohort.n_inds
    if site_block is None:
        site_block = max(_BLOCK_TEMP_BYTES // (4 * n), 1)
    site_block = max(int(site_block), 1)

    af_d, membership, pop_index = from_jax_arrays(
        local_rows(np.asarray(af, np.float32), cohort, PAD_AF),
        popmap.membership, popmap.pop_index, device=dev)
    m = cohort.n_local
    # this rank's block of the output rows; rows past ``m`` stay zero
    f_obs = np.zeros((m_pad, popmap.n_pops), dtype=np.float32)
    ne_obs = np.zeros((m_pad, popmap.n_pops), dtype=np.float32)
    ne_ind_sum = torch.zeros(n, dtype=torch.float64, device=dev)
    for lo in range(0, m_pad, site_block):
        hi = min(lo + site_block, m_pad)
        fo, no, ni = fisher_obs_pops(
            cohort.g0[lo:hi], cohort.g1[lo:hi], af_d[lo:hi], membership,
            pop_index, cohort.site_weight[lo:hi],
            1.0,  # per-block sums; the mean is taken below over m_real
        )
        real_hi = min(hi, m)
        if real_hi > lo:
            f_obs[lo:real_hi] = fo[: real_hi - lo].cpu().numpy()
            ne_obs[lo:real_hi] = no[: real_hi - lo].cpu().numpy()
        ne_ind_sum += ni
    ne_ind = (rt.all_reduce_sum(ne_ind_sum) / cohort.m_real
              ).cpu().numpy().astype(np.float32)
    if rt.world == 1:
        return NeResult(f_obs=f_obs[:m], ne_obs=ne_obs[:m], ne_ind=ne_ind)
    whole = [rt.gather_sites(torch.from_numpy(a)) for a in (f_obs, ne_obs)]
    f_obs, ne_obs = (None if w is None else w[: cohort.m_real].numpy()
                     for w in whole)
    return NeResult(f_obs=f_obs, ne_obs=ne_obs, ne_ind=ne_ind)
