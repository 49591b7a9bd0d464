"""Entry ``assign``: assignment log-likelihoods of a batch of individuals
of unknown origin against a reference AF panel.

One analysis is the call ``cli.py::_pop_like`` makes for
``--get_pop_like``: ``assignment_loglikelihoods`` on a device-resident
batch and a host ``[M, K]`` float32 panel, as ``--pop_af_file`` gives it
(the call uploads it).  The window cycles through ``batches`` distinct
batches of ``batch`` individuals, drawn from the configuration's
populations in proportion to their sizes, at the same sites.  The panel is
the populations' true allele frequencies, each column clamped as a panel
of that population's stated size would be.

The comparison prints ``ll_gap``: the largest gap of an ``[N, K]`` output
from the reference's float64 sum, in units of the float32 spacing at that
value, over every analysis of the window.
"""

from __future__ import annotations

import time

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
        self.k = int(config["populations"])
        self.batch = int(traffic["batch"])
        self.n_batches = int(traffic["batches"])
        self.f64_sums = bool(traffic["f64_sums"])
        self.calls = 0

    def make_inputs(self):
        cfg = self.config
        gen = synth.make_generator(self.seed, self.device)
        pop_af = synth.population_af(gen, self.m, self.k, cfg["fst"],
                                     self.device)
        sizes = synth.population_sizes(cfg)
        pop_of = synth.population_index(
            synth.proportional_sizes(sizes, self.batch))
        self.planes = [synth.genotype_likelihoods(
            gen, pop_af, pop_of, cfg["mean_depth"], cfg["error_rate"])
            for _ in range(self.n_batches)]
        self.af = synth.clamp_panel(pop_af, sizes).cpu().numpy()

    def build(self):
        from wgsassign_tpu_torch.models.common import DeviceCohort
        from wgsassign_tpu_torch.parallel.runtime import make_runtime

        rt = make_runtime(self.device)
        sw = torch.ones(self.m, dtype=torch.float32, device=self.device)
        self.cohorts = [DeviceCohort(g0=g0, g1=g1, site_weight=sw,
                                     m_real=self.m, runtime=rt)
                        for g0, g1 in self.planes]

    def run(self, spans) -> dict:
        from wgsassign_tpu_torch.models.assign import (
            assignment_loglikelihoods,
        )

        b = self.calls % self.n_batches
        self.calls += 1
        t0 = time.perf_counter()
        ll = assignment_loglikelihoods(None, self.af, cohort=self.cohorts[b],
                                       f64_sums=self.f64_sums)
        synchronize(self.device)
        spans["assign"].append(time.perf_counter() - t0)
        return {"batch": b, "ll": ll}

    @staticmethod
    def thin(record: dict):
        pass

    def work(self, record: dict) -> dict:
        return {"loglik": roofline.loglik(self.m, self.batch, self.k,
                                          self.k)}

    def release(self):
        self.cohorts = None

    def reference(self, ll_round=None) -> dict:
        af = torch.from_numpy(self.af).to(self.device)
        return {"ll": [reference.assignment_loglik(g0, g1, af, ll_round)
                       .cpu().numpy() for g0, g1 in self.planes]}

    def control_reference(self) -> dict:
        """The reference with bfloat16 likelihood operands, in the
        program's place."""
        return self.reference(ll_round=reference.round_bf16)

    def as_record(self, ref: dict, batch: int = 0) -> dict:
        return {"batch": batch, "ll": ref["ll"][batch].astype(np.float32)}

    def compare(self, records: list, ref: dict) -> list:
        return [{"ll_gap": ulps(rec["ll"], ref["ll"][rec["batch"]])}
                for rec in records]
