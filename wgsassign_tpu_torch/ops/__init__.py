"""Tensor ops and the kernel wrappers with their plain twins."""

import functools

import torch


@functools.cache
def _first_cpu_log() -> None:
    torch.log(torch.full((1,), 0.5))


def log(x: torch.Tensor) -> torch.Tensor:
    """``torch.log``; on a CPU tensor, after one serial log in the process.

    PyTorch's CPU float32 log (MKL's vsLn) can return one worker thread's
    chunk about 2e-5 off (relative) on the first multi-threaded call of a
    process; one serial call first sets it up.  The torch-only case: a
    fresh process with 8 threads, x = [16, 131072] float32 in [0.05, 0.95],
    one other parallel op, then torch.log(x) twice, differed in up to half
    of such processes, by load, and in none after the serial call.  It is
    made at the first CPU log, not at import, so that processes that run
    on the card never start MKL."""
    if x.device.type == "cpu":
        _first_cpu_log()
    return torch.log(x)
