"""wgsassign_tpu_torch: the PyTorch/CUDA port of wgsassign_tpu.

The JAX package (``wgsassign_tpu``) is the reference; this package runs the
same analyses with PyTorch tensors and hand-written CUDA kernels for Hopper
(``csrc/``).  Its layout mirrors the JAX package (``ops/``, ``models/``,
``parallel/``, ``obs/``, ``cli.py``) so each counterpart is found by name.

Ported: every analysis of the JAX CLI on one process and one GPU
(:mod:`wgsassign_tpu_torch.cli`); several GPUs are not ported yet.
Host-side parsing and output writing are imported from the JAX-free modules
of ``wgsassign_tpu`` (``io/*``, ``_native``, ``obs.profiling``,
``obs.log``, the argparse ``parser``); nothing here imports ``jax``.
"""

from wgsassign_tpu.version import __version__

__all__ = ["__version__"]
