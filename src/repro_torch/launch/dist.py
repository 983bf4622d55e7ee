"""Process groups for the port's multi-device paths.

``init`` starts one rank's default group for a named backend ("gloo" or
"nccl"); it guesses none. ``spawn`` starts ``world_size`` ranks of a
function on this host with ``torch.multiprocessing.spawn``, each in its
own process with its default group initialised, and tears the group down
when the function returns. The rendezvous is an explicit ``init_method``:
``file://<path>`` (a ``FileStore``, which needs no port) or
``tcp://localhost:<port>``.

    dist.spawn(fn, 4, backend="gloo", init_method=f"file://{tmp}/store",
               args=(out_dir,))          # fn(rank, out_dir) in each rank

One card and several ranks: NCCL refuses two ranks on one device, so the
ranks of a one-card run share it under gloo, which stages CUDA tensors
through the host for its collectives.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")


def init(backend: str, rank: int, world_size: int, init_method: str) -> None:
    """This process's default group: ``backend`` over ``world_size`` ranks
    meeting at ``init_method``. NCCL takes the card ``rank`` modulo the
    cards this host sees."""
    if backend not in BACKENDS:
        raise ValueError(f"init: backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init: the nccl backend needs a CUDA device "
                               "and torch.cuda.is_available() is False")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def _rank_main(rank: int, fn, world_size: int, backend: str,
               init_method: str, args: tuple) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    init(backend, rank, world_size, init_method)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, *, backend: str, init_method: str,
          args: tuple = ()) -> None:
    """``fn(rank, *args)`` in ``world_size`` new processes (one thread
    each), each with its default group up. ``fn`` must be importable by
    name (a module-level function). Raises if any rank raises or exits
    non-zero."""
    if backend not in BACKENDS:
        raise ValueError(f"spawn: backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    mp.spawn(_rank_main, args=(fn, world_size, backend, init_method, args),
             nprocs=world_size, join=True)
