"""A world of ranks on one host, and the collectives the tier needs.

``run(fn, world_size, *args)`` spawns ``world_size`` processes
(``torch.multiprocessing``, start method ``spawn``), joins them in one
``torch.distributed`` group through a rendezvous file in a temporary
directory (no network), calls ``fn(rank, world_size, *args)`` in each and
returns the ranks' return values in rank order.  An exception in any rank
ends the others and is raised in the caller.

``start_world(fn, world_size, *args)`` is the form in which the calling
process is rank 0 (its device, its profiler, its memory counters): it
spawns ranks 1 to ``world_size - 1`` running ``fn``, joins the group
itself and returns a :class:`World` whose ``close()`` ends it.  A watchdog
ends the world, this process included, when a spawned rank fails or the
world outlives its deadline; a spawned rank ends itself when its parent
is gone.  So no rank waits on a collective that can never complete.

The backend is ``nccl`` when every rank has a GPU of its own and ``gloo``
otherwise (the CPU, or several ranks sharing one GPU: NCCL refuses two
ranks on one device).  The tier's combine hands gloo CUDA tensors
itself (gloo stages them through the host; ``tools/gloo_combine.py`` times
it); for :func:`all_gather_cat` a CUDA tensor is copied to the host here.
"""
from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from repro_torch import device as _device

DEFAULT_TIMEOUT_S = 600

# the device ``run`` gave this process (None outside a spawned rank)
_rank_device: Optional[torch.device] = None


def pick_backend(world_size: int, device) -> str:
    """``nccl`` when each of ``world_size`` ranks gets its own GPU, else
    ``gloo``."""
    dev = torch.device(device)
    if (dev.type == "cuda" and tdist.is_nccl_available()
            and world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def rank_device(rank: int, device) -> torch.device:
    """The device rank ``rank`` works on: ``cuda:{rank % device_count}`` on
    the GPU, the CPU when asked."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def current_device() -> torch.device:
    """The device of this rank (``rank_device`` of ``run``'s ``device``);
    outside a rank spawned by ``run``, the port's default device (the GPU,
    raising without one)."""
    return _rank_device if _rank_device is not None else _device.resolve()


def _rank_main(rank: int, fn: Callable, world_size: int, args: tuple,
               kwargs: dict, backend: str, device: str, init_file: str,
               out_dir: str, threads: Optional[int],
               timeout_s: float) -> None:
    global _rank_device
    if threads:
        torch.set_num_threads(threads)
    dev = _rank_device = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world_size, *args, **kwargs)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        tdist.destroy_process_group()


def run(fn: Callable, world_size: int, *args, device=None,
        backend: Optional[str] = None, threads: Optional[int] = None,
        timeout_s: float = DEFAULT_TIMEOUT_S, **kwargs) -> List[Any]:
    """Run ``fn(rank, world_size, *args, **kwargs)`` on a world of
    ``world_size`` spawned ranks, rank r on ``rank_device(r, device)``
    (:func:`current_device` inside the rank; ``device`` defaults to the
    GPU and raises without one, as every entry point); returns their return values
    in rank order (tensors come back on the CPU).  ``fn`` and its arguments
    must pickle (a module-level function of the package, so a rank imports
    only what ``fn`` needs).  ``threads`` sets each rank's torch CPU thread
    count; ``timeout_s`` bounds every collective."""
    device = str(_device.resolve(device))
    backend = backend or pick_backend(world_size, device)
    tmp = tempfile.mkdtemp(prefix="repro_torch_dist_")
    try:
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(fn, world_size, args, kwargs, backend, device,
                       os.path.join(tmp, "rendezvous"), tmp, threads,
                       timeout_s))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _orphan_watch(parent: int) -> None:
    """End this process once the process that spawned it is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(3)


def _worker_main(i: int, parent: int, *rest) -> None:
    """Spawned rank ``i + 1`` of a :class:`World`."""
    threading.Thread(target=_orphan_watch, args=(parent,),
                     daemon=True).start()
    _rank_main(i + 1, *rest)


class World:
    """A world whose rank 0 is this process (see :func:`start_world`)."""

    def __init__(self, ctx, tmp: str, world_size: int,
                 deadline_s: Optional[float]):
        self._ctx, self._tmp, self.world_size = ctx, tmp, world_size
        self._closed = threading.Event()
        self._deadline = None if deadline_s is None \
            else time.monotonic() + deadline_s
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        procs = self._ctx.processes if self._ctx is not None else []
        while not self._closed.wait(0.5):
            bad = [(r + 1, p.exitcode) for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            late = self._deadline is not None \
                and time.monotonic() > self._deadline
            if bad or late:
                why = (f"rank(s) {bad} (rank, exit code) failed" if bad
                       else "the world outlived its deadline")
                print(f"launch.dist: {why}; ending the world",
                      file=sys.stderr, flush=True)
                for p in procs:
                    if p.is_alive():
                        p.kill()
                os._exit(3)

    def close(self) -> List[Any]:
        """Leave the group, wait for the spawned ranks and return their
        return values (ranks 1..) in rank order."""
        global _rank_device
        try:
            tdist.destroy_process_group()
            if self._ctx is not None:
                while not self._ctx.join():
                    pass
            return [torch.load(os.path.join(self._tmp, f"rank{r}.pt"),
                               map_location="cpu", weights_only=False)
                    for r in range(1, self.world_size)]
        finally:
            self._closed.set()
            _rank_device = None
            shutil.rmtree(self._tmp, ignore_errors=True)


def start_world(fn: Callable, world_size: int, *args, device=None,
                backend: Optional[str] = None, threads: Optional[int] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S,
                deadline_s: Optional[float] = None, **kwargs) -> World:
    """Make this process rank 0 of a ``world_size`` world, on
    ``rank_device(0, device)`` (the default device thereafter; outside the
    group's collectives it runs whatever the caller runs), and spawn ranks
    1.. running ``fn(rank, world_size, *args, **kwargs)`` as :func:`run`'s
    ranks do.  ``deadline_s`` bounds the world's life: past it, or on a
    spawned rank's failure, the watchdog kills every rank and exits this
    process (code 3).  Returns the :class:`World`."""
    global _rank_device
    device = str(_device.resolve(device))
    backend = backend or pick_backend(world_size, device)
    tmp = tempfile.mkdtemp(prefix="repro_torch_dist_")
    init_file = os.path.join(tmp, "rendezvous")
    ctx = None
    if world_size > 1:
        ctx = mp.start_processes(
            _worker_main, nprocs=world_size - 1, join=False, daemon=True,
            start_method="spawn",
            args=(os.getpid(), fn, world_size, args, kwargs, backend, device,
                  init_file, tmp, threads, timeout_s))
    world = World(ctx, tmp, world_size, deadline_s)
    dev = _rank_device = rank_device(0, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world_size,
        rank=0, timeout=datetime.timedelta(seconds=timeout_s))
    return world


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (gloo
    gathers host tensors: a CUDA ``t`` goes through a host copy)."""
    staged = t.is_cuda and tdist.get_backend(group) == "gloo"
    src = t.cpu() if staged else t
    parts = [torch.empty_like(src) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts, dim=dim).to(t.device)
