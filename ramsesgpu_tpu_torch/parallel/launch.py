"""Start the ranks of a distributed run as local processes: the port's
counterpart of ``mpirun -np N`` on one host (the JAX package serves an
``[mpi]`` input from one process, ramsesgpu_tpu/cli/main.py:100-115).

``spawn_ranks(fn, world_size, args)`` starts ``world_size`` processes with
the ``spawn`` start method (torch.multiprocessing), each with ``RANK``,
``WORLD_SIZE`` and ``RAMSES_DIST_INIT`` (a ``file://`` rendezvous in a
temporary directory) set before it calls ``fn(*args)``, and returns their
results in rank order. A rank that raises or dies fails the call: the
parent joins every child, ends the others and raises.
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Callable

import torch
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, world_size: int, init: str, outdir: str,
               args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), RAMSES_DIST_INIT=init,
                      LOCAL_RANK=str(rank))
    import torch.distributed as dist

    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        result = fn(*args)
        torch.save(result, Path(outdir) / f"rank{rank}.pt")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: tuple = ()) -> list:
    """Run ``fn(*args)`` in ``world_size`` new processes, one per rank, and
    return their results (each saved by ``torch.save``) in rank order.
    ``fn`` must be importable by name (a module-level function)."""
    with tempfile.TemporaryDirectory(prefix="ramses_ranks_") as tmp:
        init = "file://" + str(Path(tmp) / "rendezvous")
        mp.start_processes(_rank_main, args=(fn, world_size, init, tmp, args),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world_size)]
