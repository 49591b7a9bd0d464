"""wgsassign_tpu_torch: the PyTorch/CUDA port of wgsassign_tpu.

The JAX package (``wgsassign_tpu``) is the reference; this package runs the
same analyses with PyTorch tensors and hand-written CUDA kernels for Hopper
(``csrc/``).  Its layout mirrors the JAX package (``ops/``, ``models/``,
``parallel/``, ``obs/``, ``cli.py``) so each counterpart is found by name.

Ported: every analysis of the JAX CLI on one process and one GPU
(:mod:`wgsassign_tpu_torch.cli`); several GPUs are not ported yet.
Host-side parsing and output writing (``io/*``, ``_native``, ``obs/*``, the
argparse ``parser``) are this package's own copies of the JAX package's
modules, under the same names; nothing here imports ``jax`` or
``wgsassign_tpu``.
"""

from wgsassign_tpu_torch.version import __version__

__all__ = ["__version__"]
