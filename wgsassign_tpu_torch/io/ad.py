"""Allele-depth file ingest + the major/minor-count preprocessing tool.

``--ind_ad_file`` format: whitespace-delimited int32 ``[M, 2N]`` (major,
minor read counts per individual), optionally gzipped (reference
WGSassign.py:320,399 uses ``np.loadtxt``).

``extract_majmin_counts`` reproduces the standalone
``allele_counts_beagle.py`` preprocessing script (reference
allele_counts_beagle.py:1-25): from an ANGSD ``.counts.gz`` (4 columns
A,C,G,T per individual) plus the Beagle file's integer allele codes, gather
the (major, minor) count pair per individual per site.
"""

from __future__ import annotations

import numpy as np

def read_allele_depths(path: str, n_sites: int | None = None,
                       n_inds: int | None = None) -> np.ndarray:
    """Load an ``[M, 2N]`` allele-depth matrix.

    ``n_sites``/``n_inds`` (when given) are validated against the Beagle
    dimensions at parse time — a mismatched AD file otherwise fails deep in
    the z pipeline, or silently mis-aligns rows after a downsampled-LOO
    site filter (the reference is equally lax, WGSassign.py:320).

    Parsing goes through the native threaded tokenizer
    (``_native/beagle_reader.cpp::ad_read`` — zlib inflate + int parse in
    worker threads; gzopen reads plain files transparently, so gzip is
    detected by content, not filename).  ``np.loadtxt`` remains the
    fallback when the native library is unavailable."""
    from wgsassign_tpu_torch._native import read_int_matrix_native

    ad = read_int_matrix_native(path)
    if ad is None:
        ad = np.loadtxt(path, dtype=np.int32)
    if ad.ndim == 1:
        ad = ad.reshape(1, -1)
    if ad.shape[1] % 2 != 0:
        raise ValueError(
            f"Allele-depth file {path} must have 2 columns per individual"
        )
    if n_inds is not None and ad.shape[1] != 2 * n_inds:
        raise ValueError(
            f"Allele-depth file {path} covers {ad.shape[1] // 2} "
            f"individuals, but the Beagle file has {n_inds}"
        )
    if n_sites is not None and ad.shape[0] != n_sites:
        raise ValueError(
            f"Allele-depth file {path} has {ad.shape[0]} rows, but the "
            f"analysis covers {n_sites} sites — the AD matrix must align "
            "row-for-row with the Beagle sites in use (note: a "
            "downsampled-LOO run filters the site set; z-scores need an AD "
            "file over the same filtered sites)"
        )
    return ad


def extract_majmin_counts(
    raw_counts: np.ndarray, major_minor_codes: np.ndarray
) -> np.ndarray:
    """Gather (major, minor) counts from per-base count rows.

    Args:
      raw_counts: int ``[M, 4*N]`` — A,C,G,T read counts per individual.
      major_minor_codes: int ``[M, 2]`` — allele1/allele2 codes (0..3) from
        the Beagle header columns.

    Returns: int32 ``[M, 2*N]`` (major, minor) count pairs.
    """
    m, c4 = raw_counts.shape
    n = c4 // 4
    ind_base = np.tile(np.repeat(np.arange(n), 2), (m, 1)) * 4
    allele_off = np.tile(major_minor_codes, n)
    idx = ind_base + allele_off
    return np.take_along_axis(raw_counts, idx, axis=1).astype(np.int32)


def extract_majmin_counts_files(
    raw_counts_file: str, beagle_like_file: str, out_file: str | None = None
) -> str:
    """File-level wrapper matching the reference script's CLI contract."""
    raw = np.loadtxt(raw_counts_file, dtype="int", skiprows=1)
    codes = np.loadtxt(beagle_like_file, dtype="int", skiprows=1, usecols=(1, 2))
    out = extract_majmin_counts(raw, codes)
    if out_file is None:
        out_file = raw_counts_file + ".majmin.counts.txt.gz"
    np.savetxt(out_file, out, fmt="%d")
    return out_file


def main(argv=None):
    """Console entry point matching the reference's standalone
    allele_counts_beagle.py usage:

        WGSassign-allele-counts <raw.counts.gz> <majmin-codes-file> [out]
    """
    import sys

    args = sys.argv[1:] if argv is None else argv
    if len(args) not in (2, 3):
        print(__doc__)
        print("usage: WGSassign-allele-counts RAW_COUNTS MAJMIN_FILE [OUT]")
        raise SystemExit(2)
    out = extract_majmin_counts_files(args[0], args[1], args[2] if len(args) == 3 else None)
    print(f"Wrote major/minor allele counts to {out}")
