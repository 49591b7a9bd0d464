"""Assignment log-likelihoods (``--get_pop_like``).

Counterpart of ``wgsassign_tpu/models/assign.py`` (reference
glassy.assignLL, glassy.py:18-44): the full ``[N, K]`` matrix in one device
pass, blocked over individuals (``ops/loglik.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from wgsassign_tpu_torch.io.beagle import BeagleData
from wgsassign_tpu_torch.models.common import (
    DeviceCohort,
    from_jax_arrays,
    local_rows,
    to_device,
)
from wgsassign_tpu_torch.obs.profiling import count, span
from wgsassign_tpu_torch.ops.loglik import (
    assign_loglik,
    assign_loglik_f64,
    assign_loglik_partitioned,
    assign_loglik_partitioned_f64,
    check_loglik_inputs,
)
from wgsassign_tpu_torch.parallel.runtime import PAD_AF, Runtime


def assignment_loglikelihoods(
    beagle: BeagleData,
    af: np.ndarray,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
    num_partitions: int = 1,
    f64_sums: bool = True,
):
    """Log-likelihood of assigning each individual to each population.

    Returns ``ll [N, K] float32``; with ``num_partitions > 1`` returns
    ``(ll, parts [N*num_partitions, K])`` where partition p sums sites with
    ``site_index % P == p`` (reference utils.partition_loglikes).

    ``f64_sums`` (default) sums the site axis in float64 on the device,
    like the reference (glassy.py:38); False sums in float32.  Under the
    runtime's ``debug_checks`` the inputs are sanitised first
    (:func:`check_loglik_inputs`).  With several ranks each rank takes its
    window of ``af`` and the sums are added over the ranks.
    """
    if cohort is None:
        cohort = to_device(beagle, runtime, site_multiple=num_partitions)
    rt = cohort.runtime
    with span("wgsa.assign.af_upload"):
        (af_dev,) = from_jax_arrays(
            local_rows(np.asarray(af, np.float32), cohort, PAD_AF),
            device=rt.device)
    args = (cohort.g0, cohort.g1, af_dev, cohort.site_weight)
    reduce = rt.all_reduce_sum
    if rt.debug_checks:
        check_loglik_inputs(*args, reduce=reduce)
    count("host_syncs")
    with span("wgsa.loglik.pass"):
        if num_partitions <= 1:
            if f64_sums:
                ll = assign_loglik_f64(*args, reduce=reduce)
            else:
                ll = assign_loglik(*args, reduce=reduce).cpu().numpy()
            return ll.astype(np.float32)
        if f64_sums:
            parts = assign_loglik_partitioned_f64(*args, num_partitions,
                                                  reduce=reduce)
        else:
            parts = assign_loglik_partitioned(*args, num_partitions,
                                              reduce=reduce).cpu().numpy()
    ll = parts.sum(axis=0).astype(np.float32)  # [N, K]
    n, k = ll.shape
    parts_nk = np.transpose(parts.astype(np.float32), (1, 0, 2)).reshape(
        n * num_partitions, k)
    return ll, parts_nk
