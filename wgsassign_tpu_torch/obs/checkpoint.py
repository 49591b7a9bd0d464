"""EM-state checkpoints, interchangeable with the JAX package's.

The JAX package's ``EMCheckpoint.save`` imports its device mesh module, and
with it ``jax``; this is the same class without that import.  The npz keys
are the same (``f``, ``iters``, ``active``, ``it``), so a file written by
either package resumes in the other.  The JAX package's fused EMs store
their panel padded (sites to a multiple of 128, LOO problem rows to a
multiple of 8); the port's fused EMs set :attr:`EMCheckpoint.file_layout`
to write that layout and crop it again on load.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from wgsassign_tpu.obs.checkpoint import save_npz_atomic


class EMCheckpoint:
    """Atomic npz checkpoint for a chunked EM run."""

    def __init__(self, path: Optional[str], interval_chunks: int = 4):
        self.path = path
        self.interval = max(interval_chunks, 1)
        self._chunk_count = 0
        # host panel -> the array stored under "f" (set by the fused EM)
        self.file_layout: Optional[Callable[[np.ndarray], np.ndarray]] = None

    def maybe_save(self, f, iters, active, it: int) -> None:
        if self.path is None:
            return
        self._chunk_count += 1
        if self._chunk_count % self.interval != 0:
            return
        self.save(f, iters, active, it)

    def save(self, f, iters, active, it: int) -> None:
        if self.path is None:
            return
        if isinstance(f, torch.Tensor):
            f = f.detach().cpu().numpy()
        f = np.asarray(f)
        if self.file_layout is not None:
            f = self.file_layout(f)
        save_npz_atomic(
            self.path,
            f=f,
            iters=np.asarray(iters),
            active=np.asarray(active),
            it=np.asarray(it),
        )

    def load(self):
        """Returns ``(f, iters, active, it)`` or None when absent."""
        if self.path is None or not os.path.exists(self.path):
            return None
        with np.load(self.path) as z:
            return z["f"], z["iters"], z["active"], int(z["it"])

    def clear(self) -> None:
        if self.path and os.path.exists(self.path):
            try:
                os.remove(self.path)
            except FileNotFoundError:
                pass  # another process on a shared filesystem won the race
