"""A whole run on the CPU at a tiny size, with the look for a card
skipped: a sound port comes out ``correct``; the control (the reference in
a lower precision in the port's place), and each fault a cell can have,
planted in the port, come out not correct.  Faults: a step that returns
its state unchanged, half of the batch left out with the mean taken over
the rest, an answer altered where it is produced.  (One card: no
exchange between chips to leave out.)"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import tiny

CPU = torch.device("cpu")


def run(cell, seed=2**31 + 11, seconds=0.2):
    return harness.run_cell(cell, seed, seconds, False, CPU,
                            time.perf_counter())


def _loo_cell():
    return tiny("loo.wgs180_5m")


def _assign_cell():
    return tiny("assign.wgs180_5m", batch=8)


@pytest.mark.parametrize("make", [_loo_cell, _assign_cell])
def test_sound_run_is_correct(make):
    out = run(make())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def _stale_chunks(monkeypatch):
    import wgsassign_tpu_torch.models.loo as loo_mod

    orig = loo_mod.em_maf_loo_group_fused

    def stale(g0p, g1p, ft, limits, n_real, T, fast_math=True):
        return ft.clone(), torch.zeros((T, ft.shape[0]))

    monkeypatch.setattr(loo_mod, "em_maf_loo_group_fused",
                        lambda *a, **k: orig(*a, **dict(k, chunk_op=stale)))


def _half_members(monkeypatch):
    import wgsassign_tpu_torch.models.reference_af as ref_mod

    orig = ref_mod.em_maf_pops_fused

    def half(g0, g1, membership, *a, **k):
        return orig(g0[:, ::2].contiguous(), g1[:, ::2].contiguous(),
                    membership[::2], *a, **k)

    monkeypatch.setattr(ref_mod, "em_maf_pops_fused", half)


def _altered_ll(monkeypatch):
    import wgsassign_tpu_torch.models.loo as loo_mod

    orig = loo_mod.assign_loglik_selected_f64

    def altered(*a, **k):
        out = orig(*a, **k)
        out[0] += 1e-3 * abs(out[0])
        return out

    monkeypatch.setattr(loo_mod, "assign_loglik_selected_f64", altered)


@pytest.mark.parametrize("plant", [_stale_chunks, _half_members,
                                   _altered_ll])
def test_loo_faults_are_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    out = run(_loo_cell())
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


def _half_batch(monkeypatch):
    import wgsassign_tpu_torch.models.assign as assign_mod

    orig = assign_mod.assign_loglik_f64

    def half(g0, g1, af, sw, reduce=None):
        n = g0.shape[1] // 2
        part = orig(g0[:, :n], g1[:, :n], af, sw, reduce=reduce)
        rest = part.mean(axis=0, keepdims=True).repeat(g0.shape[1] - n, 0)
        return np.concatenate([part, rest])

    monkeypatch.setattr(assign_mod, "assign_loglik_f64", half)


def _altered_assign(monkeypatch):
    import wgsassign_tpu_torch.models.assign as assign_mod

    orig = assign_mod.assign_loglik_f64

    def altered(*a, **k):
        out = orig(*a, **k)
        out[0, 0] += 1e-3 * abs(out[0, 0])
        return out

    monkeypatch.setattr(assign_mod, "assign_loglik_f64", altered)


@pytest.mark.parametrize("plant", [_half_batch, _altered_assign])
def test_assign_faults_are_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    out = run(_assign_cell())
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("make", [_loo_cell, _assign_cell])
def test_control_is_not_correct(make):
    """The control reads over the cell's limits on three seeds."""
    cell = make()
    for seed in (3, 2**32 + 4, 12345):
        entry = cell.entry_class()(cell.config, cell.traffic, seed, CPU)
        entry.make_inputs()
        ref = entry.reference()
        numbers = entry.compare([entry.as_record(entry.control_reference())],
                                ref)
        checks, failed = harness.judge(numbers, cell.limits)
        assert failed == 1, checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["loo.wgs180_5m", "assign.wgs180_5m"])
def test_float32_sum_control_is_not_correct_on_the_card(workload):
    """The port's own float32-sum path (``f64_sums`` off), the control of
    the float64 sums, reads over ``ll_gap``'s limit at the cell's size on
    three seeds, where the sound port reads under it.  (On the CPU,
    torch's float32 sums are cascaded and too exact to show it.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell.load(workload)
    dev = torch.device("cuda", 0)
    for seed in (7, 2**32 + 8, 9):
        entry = cell.entry_class()(cell.config, cell.traffic, seed, dev)
        entry.make_inputs()
        entry.build()
        spans = {"refaf": [], "loo": [], "assign": []}
        sound = entry.run(spans)
        entry.f64_sums = False
        f32 = entry.run(spans)
        entry.release()
        ref = entry.reference()
        numbers = entry.compare([sound, f32], ref)
        limit = cell.limits["ll_gap"]["limit"]
        assert numbers[0]["ll_gap"] <= limit < numbers[1]["ll_gap"]
        del entry
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "loo.wgs180_5m", "--seed", "5", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
