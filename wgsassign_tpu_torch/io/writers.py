"""Output writers — file formats are part of the compatibility contract.

Formats reproduced (reference file:line):
- ``.pop_af.npy`` float32 [M, K]                      (WGSassign.py:243)
- ``.pop_names.txt`` one pop per line                 (WGSassign.py:247)
- ``.pop_like.txt`` ``%.7f`` text matrix              (WGSassign.py:306)
- ``.fisher_obs.npy`` / ``.ne_obs.npy`` float32 [M,K] (WGSassign.py:255,258)
- ``.ne_obs.txt`` 2-row text (pops; per-pop mean)     (WGSassign.py:261-264)
- ``.ne_ind.txt`` one ``%.7f`` per individual         (WGSassign.py:270)
- LOO TSVs via pandas, gzip iff name ends ``.gz``     (utils.py:49-123)
- ``.args`` provenance file                           (WGSassign.py:127-141)
"""

from __future__ import annotations

import functools
import gzip
import os
from datetime import datetime

import numpy as np


def primary_only(fn):
    """Writers take a keyword ``rank`` (this process's index; 0, the
    default, for a single process) and become no-ops (returning None) on
    every other rank: in a run of several processes only process 0 writes
    output files (hosts share a filesystem; duplicate writers would race)."""

    @functools.wraps(fn)
    def wrapper(*args, rank: int = 0, **kwargs):
        if rank != 0:
            return None
        return fn(*args, **kwargs)

    return wrapper


@primary_only
def write_pop_af(out_prefix: str, af: np.ndarray) -> str:
    path = out_prefix + ".pop_af.npy"
    np.save(out_prefix + ".pop_af", af.astype(np.float32))
    return path


@primary_only
def write_pop_names(out_prefix: str, pops) -> str:
    path = out_prefix + ".pop_names.txt"
    np.savetxt(path, np.asarray(pops, dtype=str), fmt="%s")
    return path


@primary_only
def write_loglike_txt(out_prefix: str, logl_mat: np.ndarray) -> str:
    path = out_prefix + ".pop_like.txt"
    np.savetxt(path, logl_mat, fmt="%.7f")
    return path


@primary_only
def write_ne_outputs(out_prefix: str, f_obs, ne_obs, pops) -> list:
    paths = []
    np.save(out_prefix + ".fisher_obs", f_obs.astype(np.float32))
    paths.append(out_prefix + ".fisher_obs.npy")
    np.save(out_prefix + ".ne_obs", ne_obs.astype(np.float32))
    paths.append(out_prefix + ".ne_obs.npy")
    ne_mean = np.empty((2, len(pops)), dtype=np.dtype("U25"))
    ne_mean[0, :] = pops
    ne_mean[1, :] = np.mean(ne_obs, axis=0)
    p = out_prefix + ".ne_obs.txt"
    np.savetxt(p, ne_mean, fmt="%s")
    paths.append(p)
    return paths


@primary_only
def write_ne_ind(out_prefix: str, ne_ind: np.ndarray) -> str:
    path = out_prefix + ".ne_ind.txt"
    np.savetxt(path, np.asarray(ne_ind).reshape(-1, 1), fmt="%.7f")
    return path


@primary_only
def write_z_scores(out_prefix: str, z: np.ndarray, reference_mode: bool) -> str:
    suffix = ".reference_z_ind.txt" if reference_mode else ".z_ind.txt"
    path = out_prefix + suffix
    np.savetxt(path, np.asarray(z).reshape(-1, 1), fmt="%.7f")
    return path


@primary_only
def write_mixture(out_prefix: str, mix_out: np.ndarray, mcmc: bool = False) -> str:
    path = out_prefix + (".mcmc_mix.txt" if mcmc else ".em_mix.txt")
    np.savetxt(path, mix_out, fmt="%s")
    return path


@primary_only
def write_assignment_matrix(
    filename: str,
    loglike_mat: np.ndarray,
    sample_names,
    pop_names,
    partition_count: int = 1,
    print_part_column: bool = True,
    sample_locations=None,
    doing_LOO: bool = False,
) -> str:
    """Tab-delimited assignment matrix (gzipped iff name ends ``.gz``).

    Column layout matches reference utils.write_ass_mats (utils.py:49-123):
    ``sample``, then ``source_pop`` (LOO) or ``location`` if locations given,
    optional ``data_part``, then one ``%.6f`` column per population.
    """
    import pandas as pd

    sample_names = list(sample_names)
    pop_names = list(pop_names)
    n_ind = len(sample_names)
    k = len(pop_names)
    expected = (n_ind * partition_count, k)
    if tuple(loglike_mat.shape) != expected:
        raise ValueError(f"loglike_mat shape mismatch: expected {expected}, got {loglike_mat.shape}")
    if not print_part_column and partition_count != 1:
        raise ValueError("print_part_column=False is only allowed if partition_count == 1")
    data = {"sample": np.repeat(sample_names, partition_count)}
    if sample_locations is not None:
        if len(sample_locations) != n_ind:
            raise ValueError("Length of sample_locations does not match sample_names")
        if doing_LOO and not set(sample_locations).issubset(set(pop_names)):
            raise ValueError("sample_locations contains values not in pop_names (required for LOO mode)")
        col = "source_pop" if doing_LOO else "location"
        data[col] = np.repeat(list(sample_locations), partition_count)
    if print_part_column:
        data["data_part"] = np.tile(np.arange(partition_count), n_ind)
    df = pd.concat(
        [pd.DataFrame(data), pd.DataFrame(loglike_mat, columns=pop_names)], axis=1
    )
    if filename.endswith(".gz"):
        with gzip.open(filename, "wt") as f:
            df.to_csv(f, sep="\t", index=False, float_format="%.6f")
    else:
        df.to_csv(filename, sep="\t", index=False, float_format="%.6f")
    return filename


@primary_only
def write_args_file(out_prefix: str, args_namespace, default_namespace) -> str:
    """``{out}.args`` provenance log: non-default options only, with timestamp
    and cwd (reference WGSassign.py:127-141)."""
    full = vars(args_namespace)
    deaf = vars(default_namespace)
    path = out_prefix + ".args"
    with open(path, "w") as f:
        f.write("WGSassign\n")
        f.write("Time: " + datetime.now().strftime("%d/%m/%Y %H:%M:%S") + "\n")
        f.write("Directory: " + str(os.getcwd()) + "\n")
        f.write("Options:\n")
        for key in full:
            if full[key] != deaf.get(key):
                if type(full[key]) is bool:
                    f.write("\t-" + str(key) + "\n")
                else:
                    f.write("\t-" + str(key) + " " + str(full[key]) + "\n")
    return path
