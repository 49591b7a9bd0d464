"""EM-state checkpoints, interchangeable with the JAX package's.

The JAX package's ``EMCheckpoint.save`` imports its device mesh module, and
with it ``jax``; this is the same class without that import.  The npz keys
are the same (``f``, ``iters``, ``active``, ``it``), so a file written by
either package resumes in the other.  The JAX package's fused EMs store
their panel padded (sites to a multiple of 128, LOO problem rows to a
multiple of 8); the port's fused EMs set :attr:`EMCheckpoint.file_layout`
to write that layout and crop it again on load.

With several ranks (:class:`ShardedEMCheckpoint`) the panel is gathered to
rank 0, which writes the one file, in the same layout over the global site
axis; every rank loads the file and takes its own window.  A file therefore
resumes under any number of ranks, and in the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch


def save_npz_atomic(path: str, **arrays) -> None:
    """Write an npz atomically (temp file + rename)."""
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # np.savez appends .npz when missing
    src = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(src, path)


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


class ShardedEMCheckpoint(EMCheckpoint):
    """:class:`EMCheckpoint` of a run whose ranks each hold a window of the
    site axis (``cohort``: a ``DeviceCohort`` with ``runtime.world > 1``).
    Every method is called by all ranks in step: ``save`` gathers, ``load``
    and ``clear`` act on rank 0's view of the file."""

    def __init__(self, path, cohort, pad_value: float,
                 interval_chunks: int = 4):
        super().__init__(path, interval_chunks)
        self.cohort = cohort
        self.pad_value = pad_value

    def save(self, f, iters, active, it: int) -> None:
        if self.path is None:
            return
        from wgsassign_tpu_torch.models.common import gather_real_sites

        whole = gather_real_sites(self.cohort, f, axis=1)
        if whole is not None:  # rank 0
            super().save(whole, iters, active, it)

    def load(self):
        rt = self.cohort.runtime
        present = rt.broadcast_object(
            self.path is not None and os.path.exists(self.path))
        if not present:
            return None
        f, iters, active, it = super().load()
        c = self.cohort
        local = np.full((f.shape[0], c.m_pad), self.pad_value, np.float32)
        local[:, : c.n_local] = f[:, c.lo : c.hi]
        return local, iters, active, it

    def clear(self) -> None:
        rt = self.cohort.runtime
        rt.barrier()  # no rank is still reading the file
        if rt.is_primary():
            super().clear()


def make_checkpoint(path: Optional[str], cohort, pad_value: float):
    """The checkpoint of a chunked EM over ``cohort``'s site axis, or None
    without a ``path``; ``pad_value`` is what padded sites of the panel
    hold."""
    if not path:
        return None
    if cohort.runtime.world == 1:
        return EMCheckpoint(path)
    return ShardedEMCheckpoint(path, cohort, pad_value)
