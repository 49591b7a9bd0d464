"""The leave-one-out EMs' convergence test on the device, after every
iteration: the CUDA kernel (``csrc/em_decide.cu``) and its plain PyTorch
twin, behind :class:`Convergence`.

The test is the host's in ``ops/fused_em.py::_drive_chunks`` (the JAX
package's driver), to the bit: a problem's squared-update partials are
summed in float64 and rounded to float32, ``rmse = sqrt(max(sq, 0) /
m_real)`` in float64 (a NaN stays NaN, so it never converges), and a
problem with ``rmse < tol`` after iteration ``it`` (0-based) stops there:
``iters = it + 1`` and its limit becomes 0.  The state stays on the device
between iterations; the host fetches it once, at the end of the EM
(:meth:`Convergence.fetch`).  Each update is two launches: one sums the
partials into ``sq [P]``, the other tests; between them ``reduce`` (the
runtime's ``all_reduce_sum``, which returns ``sq`` itself with one rank)
sums ``sq`` over the ranks, so every rank takes the same decisions.

:meth:`Convergence.update` launches the kernel for CUDA tensors and runs
the twin for CPU tensors; nothing else chooses between them.
"""

from __future__ import annotations

import numpy as np
import torch

from wgsassign_tpu_torch import _kernels

_F32 = torch.float32
_F64 = torch.float64

# the summing launch of csrc/em_decide.cu: at most DECIDE_BLOCKS blocks
# share the partials' rows, at least DECIDE_MIN_ROWS rows each
DECIDE_BLOCKS = 256
DECIDE_MIN_ROWS = 64
# the launch's mode (csrc/em_decide.cu)
DECIDE_SUM, DECIDE_TEST = 1, 2


class Convergence:
    """Where P EM problems stand between iterations, on their device.

    ``limits`` float32 ``[P]``: 1 while a problem runs, 0 once it stopped
    (the chunk kernels' per-problem limits for one iteration); ``iters``
    int32 ``[P]``: the iteration a problem converged at, ``max_iter`` until
    then; ``stats`` int64 ``[3]``: problem-iterations run, launches in which
    no problem ran (tail launches), problems still running.
    """

    def __init__(self, iters: np.ndarray, active: np.ndarray, m_real,
                 tol: float, device: torch.device):
        n = len(iters)
        self.device = torch.device(device)
        self.limits = torch.from_numpy(
            np.where(active, 1.0, 0.0).astype(np.float32)).to(self.device)
        self.iters = torch.from_numpy(
            np.asarray(iters, np.int32).copy()).to(self.device)
        self.stats = torch.tensor([0, 0, int(np.sum(active))],
                                  dtype=torch.int64, device=self.device)
        self.m_real = torch.from_numpy(np.broadcast_to(
            np.asarray(m_real, np.float64), (n,)).copy()).to(self.device)
        self.tol = float(tol)
        self._sq = torch.zeros(n, dtype=_F32, device=self.device)
        self._ticket = self._partial = None

    @property
    def running(self) -> torch.Tensor:
        """The one-element count of problems still running (on the
        device)."""
        return self.stats[2:3]

    def update(self, sq_part: torch.Tensor, it: int, reduce=None) -> None:
        """Test every running problem after iteration ``it`` from the
        iteration's squared-update partials ``sq_part [..., P]`` float32
        (the kernel's per-block rows, or one row of sums).  ``reduce`` sums
        the float32 sums over the ranks before the test, as
        ``_drive_chunks`` does."""
        p = self.limits.shape[0]
        if sq_part.shape[-1] != p:
            raise ValueError(f"sq_part has {sq_part.shape[-1]} problems, "
                             f"expected {p}")
        if self.device.type == "cpu":
            self._update_twin(sq_part.reshape(-1, p), it, reduce)
            return
        if self.device.type != "cuda":
            raise ValueError(f"em_decide: no kernel for device {self.device}")
        rows = sq_part.numel() // p
        _kernels.check_operand("sq_part", sq_part, self.device, _F32,
                               tuple(sq_part.shape))
        blocks = max(1, min(DECIDE_BLOCKS, -(-rows // DECIDE_MIN_ROWS)))
        if self._partial is None:
            self._ticket = torch.zeros(1, dtype=torch.int32,
                                       device=self.device)
            self._partial = torch.empty((DECIDE_BLOCKS, p), dtype=_F64,
                                        device=self.device)
        self._launch(sq_part, rows, self._sq, it, DECIDE_SUM, blocks)
        sq = self._sq if reduce is None else reduce(self._sq).to(self.device)
        self._launch(sq_part, rows, sq, it, DECIDE_TEST, 1)

    def _launch(self, sq_part, rows, sq, it, mode, blocks):
        _kernels.launch(
            "em_decide", self.device, sq_part.data_ptr(), rows,
            self.limits.shape[0], self._partial.data_ptr(),
            self._ticket.data_ptr(), sq.data_ptr(), self.m_real.data_ptr(),
            self.tol, int(it), self.limits.data_ptr(), self.iters.data_ptr(),
            self.stats.data_ptr(), mode, blocks)

    def _update_twin(self, sq_part, it, reduce):
        ran = self.limits > 0
        sq = torch.where(ran, torch.sum(sq_part, dim=0, dtype=_F64), 0.0).to(
            _F32)
        if reduce is not None:
            sq = reduce(sq).to(self.device)
        v = torch.clamp(sq.to(_F64), min=0.0)  # keeps a NaN, as numpy does
        stop = ran & (torch.sqrt(v / self.m_real) < self.tol)
        self.iters[stop] = it + 1
        self.limits[stop] = 0.0
        n_ran = ran.sum()
        self.stats[0] += n_ran
        self.stats[1] += (n_ran == 0).long()
        self.stats[2] = (self.limits > 0).sum()

    def fetch(self) -> tuple:
        """``(iters [P] int32, active [P] bool, problem-iterations run,
        tail launches)`` on the host; waits for the device."""
        iters = self.iters.cpu().numpy()
        active = (self.limits > 0).cpu().numpy()
        stats = self.stats.cpu().numpy()
        return iters, active, int(stats[0]), int(stats[1])
