"""A world of ranks on one host, and the collectives the tier needs.

``run(fn, world_size, *args)`` spawns ``world_size`` processes
(``torch.multiprocessing``, start method ``spawn``), joins them in one
``torch.distributed`` group through a rendezvous file in a temporary
directory (no network), calls ``fn(rank, world_size, *args)`` in each and
returns the ranks' return values in rank order.  An exception in any rank
ends the others and is raised in the caller.

The backend is ``nccl`` when every rank has a GPU of its own and ``gloo``
otherwise (the CPU, or several ranks sharing one GPU: NCCL refuses two
ranks on one device).  Gloo's ``all_reduce`` takes CUDA tensors itself
(it stages them through the host, twice as fast on an H100 host as a
copy made here, ``tools/gloo_combine.py``); for its ``all_gather`` a CUDA
tensor is copied to the host here.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
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
