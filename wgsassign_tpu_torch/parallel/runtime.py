"""Runtime: the device, the EM options, the kernel probe and the ranks.

Counterpart of ``wgsassign_tpu/parallel/mesh.py``.  The port passes an
explicit ``torch.device`` down from here; there is no global device state.

Parallelism model: where the JAX package runs one program over a global
array on a 1-D ``snp`` mesh and lets GSPMD place the collectives, the port
runs one process per GPU (a *rank*) with explicit ``torch.distributed``
collectives.  Each rank holds one contiguous window of the site axis.  Every
EM update is pointwise in the site axis, so the only traffic between ranks is
the per-chunk convergence partials, the final float64 sums and the gather of
per-site outputs to rank 0 (:meth:`Runtime.all_reduce_sum`,
:meth:`Runtime.gather_sites`).  One rank (``world == 1``, the default) is
the degenerate case: no function here then touches ``torch.distributed``.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import socket
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

# Pad values forming a valid, numerically safe GL triple / AF.
PAD_G0 = 1.0
PAD_G1 = 0.0
PAD_AF = 0.5

log = logging.getLogger("wgsassign_tpu")


@dataclass
class Runtime:
    """One engine instance: one rank on one device."""

    device: torch.device
    # algebraically-reduced EM weight inside the kernels, DEFAULT ON (see
    # ops/em_chunk.py::em_w); --no_fast_em selects the canonical form
    fast_math: bool = True
    # --debug_checks: sanitise the likelihood inputs before the assignment
    # and LOO likelihood passes (ops/loglik.py::check_loglik_inputs)
    debug_checks: bool = False
    # counterpart of ``use_pallas``: True runs the chunked EMs, the
    # likelihood pass and the z-score tables and sums as the CUDA kernels
    # on a GPU (their plain twins on the CPU); False (--no_pallas) runs the
    # plain EM ops of ops/emmaf.py and the twins on the device
    use_kernels: bool = True
    # this process's index among ``world`` processes, each holding one
    # window of the site axis
    rank: int = 0
    world: int = 1
    # "nccl" or "gloo" (``world > 1``), and the group the tensors go through
    backend: str = ""
    group: object = field(default=None, repr=False)
    _probed: bool = field(default=False, init=False, repr=False)

    def load_kernels(self) -> None:
        """On a CUDA device with ``use_kernels``: build and load the kernel
        library and check that its probe kernel returns ``x + 1``, once per
        runtime; a failed build, load or probe raises (there is no fallback
        to the twins).  Nothing on the CPU, where every kernel wrapper runs
        its plain PyTorch twin, or under ``--no_pallas``."""
        if self.device.type != "cuda" or not self.use_kernels or self._probed:
            return
        from wgsassign_tpu_torch._kernels import probe

        probe(self.device)
        self._probed = True
        log.info("engine path on %s: hand-written CUDA kernels",
                 torch.cuda.get_device_name(self.device))

    # -- ranks ---------------------------------------------------------------
    def is_primary(self) -> bool:
        """True on the rank that owns user-facing output (files, stdout)."""
        return self.rank == 0

    def site_multiple(self, extra: int = 1) -> int:
        """The global site axis is padded to a multiple of ``world * extra``
        so that every rank's window is a multiple of ``extra`` (the
        ``--partition_sites`` count)."""
        return self.world * max(extra, 1)

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        # gloo moves host memory: a tensor on the card goes through the host
        return t.cpu() if self.backend == "gloo" else t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks, the same on every rank (``t`` itself
        with one rank).  Under gloo the result is a host tensor."""
        if self.world == 1:
            return t
        import torch.distributed as dist

        out = self._staged(t).contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def gather_sites(self, t: torch.Tensor, axis: int = 0,
                     to_all: bool = False) -> Optional[torch.Tensor]:
        """The ranks' equal-sized windows of ``t`` joined along ``axis`` in
        rank order (counterpart of ``fetch_to_host`` in the JAX package's
        mesh module).  Rank 0 gets the whole, the others None; with
        ``to_all`` every rank gets it.  Returns a host tensor when there is
        more than one rank, ``t`` itself otherwise."""
        if self.world == 1:
            return t
        import torch.distributed as dist

        local = self._staged(t).contiguous()
        want = to_all or self.is_primary()
        parts = ([torch.empty_like(local) for _ in range(self.world)]
                 if want else None)
        if to_all:
            dist.all_gather(parts, local, group=self.group)
        else:
            dist.gather(local, parts, dst=0, group=self.group)
        if not want:
            return None
        return torch.cat(parts, dim=axis).cpu()

    def broadcast_object(self, obj):
        """``obj`` of rank 0 on every rank (small host objects)."""
        if self.world == 1:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier()


def distributed_env() -> Optional[tuple]:
    """``(address, world, rank)`` from ``WGSA_COORDINATOR_ADDRESS``,
    ``WGSA_NUM_PROCESSES`` and ``WGSA_PROCESS_ID`` (the JAX package's
    variables), or None when the first is not set."""
    address = os.environ.get("WGSA_COORDINATOR_ADDRESS")
    if not address:
        return None
    return (address, int(os.environ["WGSA_NUM_PROCESSES"]),
            int(os.environ["WGSA_PROCESS_ID"]))


# Time limit of every collective, so that a rank whose peer died fails
# instead of waiting for ever.  The slowest rank's parse of a large file
# lies inside the first all-reduce, hence half an hour.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=1800)


def maybe_initialize_distributed(device, ranks: Optional[tuple] = None) -> tuple:
    """Join the process group when launched as one of several ranks;
    returns ``(device, rank, world, backend, group)``.

    ``ranks`` is ``(address, world, rank)``; None reads the three ``WGSA_*``
    variables (:func:`distributed_env`), and without them this is a
    single-process run: ``(device, 0, 1, "", None)`` and no
    ``torch.distributed`` call.

    A rank's device is ``cuda:{rank % torch.cuda.device_count()}`` (the CPU
    when ``device`` is the CPU).  The default group is gloo over
    ``tcp://<address>``: it carries host objects and, where needed, staged
    tensors.  The tensors go over NCCL when every rank has a card of its
    own, which the ranks establish by exchanging ``(hostname, card)`` over
    gloo; ranks that share a card (NCCL refuses that) and CPU ranks stay on
    gloo.  The choice is a rule on the layout, logged, not a retry.
    """
    device = torch.device(device)
    if ranks is None:
        ranks = distributed_env()
    if ranks is None:
        return device, 0, 1, "", None
    import torch.distributed as dist

    address, world, rank = ranks
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() "
                "is False")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{address}", world_size=world,
        rank=rank, timeout=COLLECTIVE_TIMEOUT)
    place = (socket.gethostname(),
             device.index if device.type == "cuda" else None)
    places = [None] * world
    dist.all_gather_object(places, place)
    own_card = (all(p[1] is not None for p in places)
                and len(set(places)) == world)
    if own_card and dist.is_nccl_available():
        backend = "nccl"
        group = dist.new_group(backend="nccl", timeout=COLLECTIVE_TIMEOUT)
    else:
        backend, group = "gloo", None
    log.info("rank %d of %d on %s: collectives over %s (%s)", rank, world,
             device, backend,
             "every rank has a card of its own" if backend == "nccl"
             else "CPU ranks, or ranks that share a card")
    return device, rank, world, backend, group


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_local_ranks(target, world: int, *args, what: str = "ranks") -> None:
    """Start ``world`` processes ``target(rank, world, address, *args)`` on
    this host with the ``spawn`` start method (CUDA forbids ``fork`` once it
    is initialised), ``address`` a free local port for
    :func:`maybe_initialize_distributed`; wait for all, and raise
    RuntimeError if any failed: the others are stopped then, so a rank whose
    peer died never waits out :data:`COLLECTIVE_TIMEOUT`."""
    import multiprocessing
    import time

    ctx = multiprocessing.get_context("spawn")
    address = f"127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=target, args=(rank, world, address, *args))
             for rank in range(world)]
    for proc in procs:
        proc.start()
    try:
        while any(proc.is_alive() for proc in procs):
            if any(proc.exitcode not in (None, 0) for proc in procs):
                break
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
        for proc in procs:
            proc.join()
    failed = {rank: proc.exitcode for rank, proc in enumerate(procs)
              if proc.exitcode != 0}
    if failed:
        raise RuntimeError(
            f"{what}: rank(s) failed (rank: exit code) {failed}")


def shutdown_distributed(runtime: Runtime) -> None:
    """Leave the process group (after a last barrier, so no rank tears the
    store down under a peer still in a collective)."""
    if runtime.world > 1:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


def make_runtime(device="cuda:0", fast_math: bool = True,
                 debug_checks: bool = False,
                 use_kernels: bool = True,
                 ranks: Optional[tuple] = None) -> Runtime:
    """Build the runtime for ``device``; joins the process group first when
    this process is one of several ranks (``ranks`` or the ``WGSA_*``
    variables, see :func:`maybe_initialize_distributed`).

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
    device, rank, world, backend, group = maybe_initialize_distributed(
        device, ranks)
    return Runtime(device=device, fast_math=fast_math,
                   debug_checks=debug_checks, use_kernels=use_kernels,
                   rank=rank, world=world, backend=backend, group=group)


def synchronize(device: torch.device) -> None:
    """Wait for ``device``, so a timed phase includes its work (nothing to
    wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
