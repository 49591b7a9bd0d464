"""PLINK .bed → genotype-likelihood conversion.

Capability parity with the reference's (currently CLI-disabled) PLINK path
(reader_cy.pyx:80-108 ``convertBed``): hard genotype calls are converted to
GL triples under a genotype-error model with error rate ``e``:

  g=0 (hom major): (  (1-e)^2,        2e(1-e),  e^2   ) -> stored (g0, g1)
  g=1 (het):       (  (1-e)e,  (1-e)^2 + e^2,  (1-e)e )
  g=2 (hom minor): (  e^2,           2e(1-e), (1-e)^2 )
  missing:         (1/3, 1/3, 1/3)

matching the reference's per-code assignments (reader_cy.pyx:91-104 sets
only the first two of each normalized triple; the third is implied).
"""

from __future__ import annotations

import os

import numpy as np

from wgsassign_tpu_torch.io.beagle import BeagleData

_BED_MAGIC = b"\x6c\x1b\x01"

# PLINK 2-bit codes (SNP-major mode): 00=hom A1, 01=missing, 10=het, 11=hom A2.
# PLINK A1 is conventionally the minor allele, so hom-A1 = genotype 2.
_CODE_TO_GENO = np.array([2, 9, 1, 0], dtype=np.int8)


def read_plink_bed(prefix: str, error_rate: float = 0.0) -> BeagleData:
    """Load PLINK ``{prefix}.bed/.bim/.fam`` as GLs.

    ``error_rate == 0`` produces certain calls (1/0 likelihoods); missing
    genotypes always get the flat (1/3, 1/3, 1/3) triple.
    """
    bed, bim, fam = prefix + ".bed", prefix + ".bim", prefix + ".fam"
    for p in (bed, bim, fam):
        if not os.path.isfile(p):
            raise FileNotFoundError(p)
    fam_rows = np.loadtxt(fam, dtype=str, ndmin=2)
    sample_names = fam_rows[:, 1].tolist()
    bim_rows = np.loadtxt(bim, dtype=str, ndmin=2)
    site_names = [f"{r[0]}_{r[3]}" for r in bim_rows]
    n, m = len(sample_names), len(site_names)

    raw = np.fromfile(bed, dtype=np.uint8)
    if raw[:3].tobytes() != _BED_MAGIC:
        raise ValueError(f"{bed} is not a SNP-major PLINK .bed file")
    bytes_per_site = (n + 3) // 4
    body = raw[3 : 3 + m * bytes_per_site].reshape(m, bytes_per_site)
    # unpack 2-bit codes, little-endian within each byte
    codes = np.empty((m, bytes_per_site * 4), dtype=np.uint8)
    for shift in range(4):
        codes[:, shift::4] = (body >> (2 * shift)) & 0b11
    geno = _CODE_TO_GENO[codes[:, :n]]

    e = float(error_rate)
    table = np.array(
        [
            [(1 - e) * (1 - e), 2 * e * (1 - e)],          # genotype 0
            [(1 - e) * e, (1 - e) * (1 - e) + e * e],      # genotype 1
            [e * e, 2 * e * (1 - e)],                      # genotype 2
        ],
        dtype=np.float32,
    )
    gl = np.empty((m, n, 2), dtype=np.float32)
    missing = geno == 9
    safe = np.where(missing, 0, geno)
    gl[:] = table[safe]
    gl[missing] = np.float32(1.0 / 3.0)
    return BeagleData(gl, sample_names, site_names)
