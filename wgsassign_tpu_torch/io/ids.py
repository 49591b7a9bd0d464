"""Population-ID files → membership structures.

The ID file is tab-delimited, two columns, one row per individual in Beagle
column order: ``sample_name<TAB>pop_name`` (reference WGSassign.py:208-211).

The canonical population order everywhere in the framework (AF columns,
output columns, pop-name files) is ``np.unique`` sorted order of the labels,
matching reference WGSassign.py:213.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class PopulationMap:
    """Individual→population assignment for a cohort.

    Attributes:
      sample_names: ``[N]`` sample names (column order of the Beagle file).
      pop_labels:   ``[N]`` population label per individual.
      pops:         ``[K]`` unique population names, sorted (np.unique order).
      pop_index:    int32 ``[N]`` — index into ``pops`` per individual.
      membership:   float32 ``[N, K]`` one-hot membership matrix.  Every
                    per-population gather/loop in the reference becomes a
                    matmul against this.
    """

    sample_names: np.ndarray
    pop_labels: np.ndarray
    pops: np.ndarray
    pop_index: np.ndarray
    membership: np.ndarray

    @property
    def n_inds(self) -> int:
        return self.sample_names.shape[0]

    @property
    def n_pops(self) -> int:
        return self.pops.shape[0]

    @property
    def pop_sizes(self) -> np.ndarray:
        """int32 ``[K]`` individuals per population."""
        return np.bincount(self.pop_index, minlength=self.n_pops).astype(np.int32)

    def members_of(self, pop_name: str) -> np.ndarray:
        """Indices of individuals in ``pop_name`` (ascending)."""
        return np.flatnonzero(self.pop_labels == pop_name)


def population_map(sample_names, pop_labels) -> PopulationMap:
    sample_names = np.asarray(sample_names, dtype=str)
    pop_labels = np.asarray(pop_labels, dtype=str)
    pops, pop_index = np.unique(pop_labels, return_inverse=True)
    pop_index = pop_index.astype(np.int32)
    n, k = len(sample_names), len(pops)
    membership = np.zeros((n, k), dtype=np.float32)
    membership[np.arange(n), pop_index] = 1.0
    return PopulationMap(sample_names, pop_labels, pops, pop_index, membership)


def read_pop_names(path: str) -> np.ndarray:
    """Load a one-column population-names file (the ``.pop_names.txt``
    output) as a 1-D string array.  A single-name file parses as a 0-d
    array under bare ``np.loadtxt`` and breaks downstream indexing (the
    reference shares the bug, WGSassign.py:322); ``atleast_1d`` restores
    the row."""
    return np.atleast_1d(np.loadtxt(path, dtype=str))


def read_ids(path: str) -> PopulationMap:
    """Load a two-column tab-delimited ID file."""
    ids = np.loadtxt(path, delimiter="\t", dtype=str)
    if ids.ndim == 1:  # single row
        ids = ids.reshape(1, -1)
    if ids.shape[1] != 2:
        raise ValueError(f"ID file {path} must have 2 tab-delimited columns, got {ids.shape[1]}")
    return population_map(ids[:, 0], ids[:, 1])
