"""Entry ``zscore_single``: reference z-scores on each individual's depth-1
loci alone (``--get_reference_z_score --single_read_threshold`` with
``--ind_ad_file``) on a device-resident cohort and its allele depths.

The analysis, the plain reference and the comparison are the ``zscore``
entry's (``entries/zscore.py``), which passes the traffic's
``single_read_threshold``.  Under Poisson(2) depths an individual keeps
about 2e^-2 = 27% of the sites, below the port's ``LOO_STRUCTURED_FILL``,
so the port runs its gathered EM: each AF group's members gathered into
``[B, P, S]`` panels of its kept sites and the EMs on them in chunks
(``sites_chunk``).

``work()`` counts what the ``zscore`` entry counts, whatever implements
the EM (``zroofline.zloo_em``: each problem's kept sites x its population's
other members x 15 operations x its convergence iteration), keyed as
``sites_chunk``, beside ``ztables``.
"""

from __future__ import annotations

from portbench.harness import HERE, load_file

_zscore = load_file(HERE / "entries" / "zscore.py", "portbench_entry_zscore")


class Entry(_zscore.Entry):
    def work(self, record: dict) -> dict:
        work = super().work(record)
        work["sites_chunk"] = work.pop("zloo_chunk")
        return work
