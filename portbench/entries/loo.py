"""Entry ``loo``: reference AF, then leave-one-out cross-validation, on a
device-resident cohort.

One analysis is the two calls ``cli.py::_reference_af`` makes for
``--get_reference_af --loo`` once the cohort is on the device:
``estimate_reference_af`` and ``leave_one_out`` with ``af_t_dev`` (the
clamped panel handed over on the device), from the ``DeviceCohort`` to the
host ``[M, K]`` AF and ``[N, K]`` LOO log-likelihoods.

The comparison recomputes the reference AF, every population's
leave-one-out EMs (every member left out in turn) and the whole ``[N, K]``
likelihood output.  It prints three numbers:

- ``af_gap``: the largest ``|AF - AF_ref|`` over the ``[M, K]`` panel of
  the analyses whose panels were kept;
- ``iter_gap``: EM problems (populations, and left-out members) whose
  convergence iteration differs from the reference's, in the worst
  analysis;
- ``ll_gap``: the largest gap of an LOO log-likelihood from the
  reference's float64 sum, in units of the float32 spacing at that value
  (the port returns float32: a sound sum reads at most about 0.5).
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from portbench import cohort as synth
from portbench import reference, roofline
from portbench.harness import synchronize, ulps


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

    def make_inputs(self):
        cfg = self.config
        gen = synth.make_generator(self.seed, self.device)
        pop_af = synth.population_af(gen, self.m, self.k, cfg["fst"],
                                     self.device)
        self.g0, self.g1 = synth.genotype_likelihoods(
            gen, pop_af, self.pop_index, cfg["mean_depth"],
            cfg["error_rate"])

    def build(self):
        from wgsassign_tpu_torch.io.ids import population_map
        from wgsassign_tpu_torch.models.common import DeviceCohort
        from wgsassign_tpu_torch.parallel.runtime import make_runtime

        rt = make_runtime(self.device)
        sw = torch.ones(self.m, dtype=torch.float32, device=self.device)
        self.cohort = DeviceCohort(g0=self.g0, g1=self.g1, site_weight=sw,
                                   m_real=self.m, runtime=rt)
        self.popmap = population_map(
            [f"ind{i}" for i in range(self.n)],
            [f"pop{p:02d}" for p in self.pop_index])
        # estimate_reference_af reads the parsed file's individual count
        self.beagle = types.SimpleNamespace(n_inds=self.n)

    def run(self, spans) -> dict:
        from wgsassign_tpu_torch.models.loo import leave_one_out
        from wgsassign_tpu_torch.models.reference_af import (
            estimate_reference_af,
        )

        t0 = time.perf_counter()
        res = estimate_reference_af(self.beagle, self.popmap, self.max_iter,
                                    self.tol, cohort=self.cohort)
        synchronize(self.device)
        t1 = time.perf_counter()
        out = leave_one_out(
            self.beagle, res.af, self.popmap, self.max_iter, self.tol,
            num_partitions=int(self.traffic["num_partitions"]),
            cohort=self.cohort,
            compat_af_mutation=bool(self.traffic["compat_af_mutation"]),
            f64_sums=self.f64_sums, af_t_dev=res.af_t_dev)
        synchronize(self.device)
        t2 = time.perf_counter()
        spans["refaf"].append(t1 - t0)
        spans["loo"].append(t2 - t1)
        return {"af": res.af, "ref_iters": np.asarray(res.iters),
                "loo_iters": np.asarray(out.iters), "ll": out.ll}

    @staticmethod
    def thin(record: dict):
        record["af"] = None

    def work(self, record: dict) -> dict:
        m = self.m
        loo = roofline.Work()
        for p in range(self.k):
            its = record["loo_iters"][self.pop_index == p]
            loo = loo + roofline.loo_em(m, int(self.sizes[p]), its)
        return {
            "em_chunk": roofline.reference_af_em(m, self.sizes,
                                                 record["ref_iters"]),
            "loo_chunk": loo,
            "loglik": roofline.loglik(m, self.n, self.k, self.n + self.k),
        }

    def release(self):
        self.cohort = self.popmap = None

    def reference(self, em_round=None) -> dict:
        af, ref_iters = reference.reference_af(
            self.g0, self.g1, self.pop_index, self.k, self.max_iter,
            self.tol, em_round)
        loo_iters, ll = {}, {}
        for p in range(self.k):
            members = np.flatnonzero(self.pop_index == p)
            cols = torch.from_numpy(members).to(self.device)
            f, its = reference.loo_em(
                self.g0.index_select(1, cols).t().contiguous(),
                self.g1.index_select(1, cols).t().contiguous(),
                self.max_iter, self.tol, em_round)
            lo = float(np.float32(1.0 / (2.0 * len(members))))
            bank = torch.cat([f.clamp(lo, 1.0 - lo), af[:, p][None, :]])
            del f
            ll[p] = reference.banked_loglik(
                self.g0, self.g1, bank,
                reference.loo_bank_rows(self.pop_index, p)).cpu().numpy()
            loo_iters[p] = its
        return {"af": af.cpu().numpy(), "ref_iters": ref_iters,
                "loo_iters": loo_iters, "ll": ll}

    def control_reference(self) -> dict:
        """The reference with TF32 member sums, in the program's place."""
        return self.reference(em_round=reference.round_tf32)

    def as_record(self, ref: dict) -> dict:
        """A reference's outputs in the shape of an analysis's record."""
        loo_iters = np.full(self.n, -1, np.int64)
        ll = np.full((self.n, self.k), np.nan, np.float32)
        for p, its in ref["loo_iters"].items():
            loo_iters[self.pop_index == p] = its
            ll[:, p] = ref["ll"][p].astype(np.float32)
        return {"af": ref["af"], "ref_iters": ref["ref_iters"],
                "loo_iters": loo_iters, "ll": ll}

    def compare(self, records: list, ref: dict) -> list:
        out = []
        for rec in records:
            gap = int((rec["ref_iters"] != ref["ref_iters"]).sum())
            ll_gap = 0.0
            for p, its in ref["loo_iters"].items():
                gap += int((rec["loo_iters"][self.pop_index == p]
                            != its).sum())
                ll_gap = max(ll_gap, ulps(rec["ll"][:, p], ref["ll"][p]))
            nums = {"iter_gap": float(gap), "ll_gap": ll_gap}
            if rec["af"] is not None:
                nums["af_gap"] = float(np.max(np.abs(
                    rec["af"].astype(np.float64) - ref["af"])))
            out.append(nums)
        return out
