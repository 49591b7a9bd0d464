"""Single-device runtime: the device, the EM options and the kernel probe.

Counterpart of the single-device part of ``wgsassign_tpu/parallel/mesh.py``.
The port passes an explicit ``torch.device`` down from here; there is no
global device state.  Several devices are a later slice.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

import numpy as np
import torch

# Pad values forming a valid, numerically safe GL triple / AF.
PAD_G0 = 1.0
PAD_G1 = 0.0
PAD_AF = 0.5

log = logging.getLogger("wgsassign_tpu")


@dataclass
class Runtime:
    """One engine instance on one device."""

    device: torch.device
    # algebraically-reduced EM weight inside the kernels, DEFAULT ON (see
    # ops/em_chunk.py::em_w); --no_fast_em selects the canonical form
    fast_math: bool = True
    # sanitizers of the likelihood inputs; --debug_checks is not ported yet
    # (ROADMAP item 14), so nothing sets it
    debug_checks: bool = False
    _probed: bool = field(default=False, init=False, repr=False)

    def kernels_enabled(self) -> bool:
        """True on a CUDA device, after the kernel library is built and
        loaded and its probe kernel returned ``x + 1`` (once per runtime);
        False on the CPU, where every kernel wrapper runs its plain PyTorch
        twin.  On a CUDA device a failed build, load or probe raises: there
        is no fallback to the twins."""
        if self.device.type != "cuda":
            return False
        if not self._probed:
            from wgsassign_tpu_torch._kernels import probe

            probe(self.device)
            self._probed = True
            log.info("engine path on %s: hand-written CUDA kernels",
                     torch.cuda.get_device_name(self.device))
        return True


def make_runtime(device="cuda:0", fast_math: bool = True) -> Runtime:
    """Build the runtime for ``device``.

    float32 matrix products and convolutions run in full float32 (no TF32),
    the counterpart of ``Precision.HIGHEST`` in the JAX package's member
    sums: TF32 keeps ~3 decimal digits, far coarser than the 1e-4 EM
    convergence tolerance.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain versions"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Runtime(device=device, fast_math=fast_math)


def pad_sites(arr: np.ndarray, multiple: int, pad_value: float) -> np.ndarray:
    """Pad dim 0 up to a multiple; returns the padded array."""
    m = arr.shape[0]
    m_pad = math.ceil(m / multiple) * multiple if multiple > 1 else m
    if m_pad == m:
        return arr
    pad_width = [(0, m_pad - m)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=pad_value)


def site_weight_vector(m_real: int, m_pad: int) -> np.ndarray:
    w = np.zeros(m_pad, dtype=np.float32)
    w[:m_real] = 1.0
    return w
