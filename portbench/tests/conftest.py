"""Shared helpers of the benchmark's CPU tests: the cells of
``BENCHMARK.json`` cut to a size the CPU runs in a moment."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(workload: str, sites: int = 2000, sizes=(5, 7, 6), **traffic):
    """The workload's cell with its configuration cut to a tiny size (the
    generative model and the limits kept): populations of ``sizes``."""
    from portbench import harness

    cell = harness.Cell.load(workload)
    cell.config = dict(cell.config, sites=sites, individuals=sum(sizes),
                       populations=len(sizes),
                       population_sizes=list(sizes))
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
