"""Benchmark of ``wgsassign_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell once::

    python3 portbench/run.py --workload <traffic>.<config> --seed <n> \\
        --seconds <s> --trace <0|1>

Everything a cell is made of is found by name, so that a cell is added by
adding files:

- ``configs/<config>.json``: the deployment's sizes (sites, individuals,
  populations) and the generative model of its genotype likelihoods;
- ``traffic/<traffic>.json``: the parameters of the analysis the window
  repeats, read by ``entries/<entry>.py`` (the entry the file names);
- ``limits/<workload>.json``: each number the comparison with the plain
  reference prints, with its limit and the readings it was set from;
- ``metrics/<metric>.py``: one reader per per-layer metric of
  ``BENCHMARK.json``.

The yardstick lives here too: the device-side data generator
(``cohort.py``), the plain reference (``reference.py``, which imports
nothing of the port), the peaks and work counts (``roofline.py``) and the
trace reduction (``devtrace.py``).  Nothing here imports JAX or the JAX
package.
"""
