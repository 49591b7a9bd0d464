"""Entry ``zscore``: reference z-scores (``--get_reference_z_score`` with
``--ind_ad_file``) on a device-resident cohort and its allele depths.

One analysis is the call ``cli.py::_z_scores`` makes once the GL planes and
the read counts are on the device: ``reference_z_scores`` over the
traffic's individuals, from the ``DeviceCohort`` and the ``DeviceDepths``
to the host ``z``, ``loci`` and ``em_iters``: the combo tables, each
individual's leave-one-out EM on its kept sites, and the three z sums
(float64, the traffic's ``f64_sums``).

The comparison recomputes every individual with the plain reference
(``zreference.py``) and prints three numbers:

- ``loci_gap``: individuals whose kept-site count differs from the
  reference's, in the worst analysis;
- ``iter_gap``: EM problems (one per individual) whose convergence
  iteration differs;
- ``z_gap``: the largest ``|z - z_ref|``.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from portbench import cohort as synth
from portbench import reference, zreference, zroofline
from portbench.harness import synchronize
from portbench.zcohort import genotype_likelihoods_and_depths


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.m = int(config["sites"])
        self.n = int(config["individuals"])
        self.k = int(config["populations"])
        self.max_iter = int(traffic["max_iter"])
        self.tol = float(traffic["tol"])
        self.f64_sums = bool(traffic["f64_sums"])
        self.sizes = synth.population_sizes(config)
        self.pop_index = synth.population_index(self.sizes)
        self.inds = range(int(traffic["ind_start"]),
                          min(int(traffic["ind_end"]), self.n))

    def make_inputs(self):
        cfg = self.config
        gen = synth.make_generator(self.seed, self.device)
        pop_af = synth.population_af(gen, self.m, self.k, cfg["fst"],
                                     self.device)
        self.g0, self.g1, self.ad = genotype_likelihoods_and_depths(
            gen, pop_af, self.pop_index, cfg["mean_depth"],
            cfg["error_rate"])

    def build(self):
        from wgsassign_tpu_torch.io.ids import population_map
        from wgsassign_tpu_torch.models.common import (
            DeviceCohort,
            device_depths,
        )
        from wgsassign_tpu_torch.parallel.runtime import make_runtime

        rt = make_runtime(self.device)
        sw = torch.ones(self.m, dtype=torch.float32, device=self.device)
        self.cohort = DeviceCohort(g0=self.g0, g1=self.g1, site_weight=sw,
                                   m_real=self.m, runtime=rt)
        self.depths = device_depths(self.ad, self.cohort)
        self.popmap = population_map(
            [f"ind{i}" for i in range(self.n)],
            [f"pop{p:02d}" for p in self.pop_index])
        # reference_z_scores reads the parsed file only without a cohort
        self.beagle = types.SimpleNamespace(n_inds=self.n)

    def run(self, spans) -> dict:
        from wgsassign_tpu_torch.models.zscore import reference_z_scores

        t = self.traffic
        t0 = time.perf_counter()
        res = reference_z_scores(
            self.beagle, self.depths, self.popmap, self.inds.start,
            self.inds.stop, int(t["n_threshold"]),
            bool(t["single_read_threshold"]), self.max_iter, self.tol,
            cohort=self.cohort, error_rate=float(t["error_rate"]),
            f64_sums=self.f64_sums)
        synchronize(self.device)
        spans["zscore"].append(time.perf_counter() - t0)
        return {"z": res.z, "loci": res.loci, "em_iters": res.em_iters,
                "fill": res.fill}

    @staticmethod
    def thin(record: dict):
        pass  # a record holds [n] arrays only

    def work(self, record: dict) -> dict:
        zloo = zroofline.Work()
        pops = self.pop_index[list(self.inds)]
        for p in np.unique(pops):
            sel = pops == p
            zloo = zloo + zroofline.zloo_em(
                self.m, int(self.sizes[p]), record["loci"][sel],
                record["em_iters"][sel])
        return {"zloo_chunk": zloo,
                "ztables": zroofline.tables(self.m, len(self.inds),
                                            self.ad.element_size())}

    def release(self):
        self.cohort = self.depths = self.popmap = None

    def reference(self, em_round=None, sum_dtype=torch.float64) -> dict:
        t = self.traffic
        z, loci, iters = zreference.reference_z(
            self.g0, self.g1, self.ad, self.pop_index, self.inds,
            int(t["n_threshold"]), bool(t["single_read_threshold"]),
            self.max_iter, self.tol, float(t["error_rate"]), em_round,
            sum_dtype)
        return {"z": z, "loci": loci, "em_iters": iters}

    def control_reference(self) -> dict:
        """The reference in lower precisions: TF32 member sums in the EMs
        and float32 z sums."""
        return self.reference(em_round=reference.round_tf32,
                              sum_dtype=torch.float32)

    def as_record(self, ref: dict) -> dict:
        """A reference's outputs in the shape of an analysis's record."""
        return {"z": ref["z"].astype(np.float32), "loci": ref["loci"],
                "em_iters": ref["em_iters"]}

    def compare(self, records: list, ref: dict) -> list:
        out = []
        for rec in records:
            z = np.asarray(rec["z"], np.float64)
            out.append({
                "loci_gap": float((np.asarray(rec["loci"])
                                   != ref["loci"]).sum()),
                "iter_gap": float((np.asarray(rec["em_iters"])
                                   != ref["em_iters"]).sum()),
                "z_gap": float(np.max(np.abs(z - ref["z"]))),
            })
        return out
