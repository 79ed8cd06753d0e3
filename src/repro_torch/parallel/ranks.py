"""Run one function as the ranks of a process group, on one machine.

:func:`run_ranks` starts ``world_size`` processes (``spawn``), joins them in
one process group through a file store in a temporary directory, runs
``fn(rank, *args)`` in each, and returns each rank's result.  gloo is the
backend on the CPU and on a card alike: it reduces CUDA tensors too (through
the host), and, unlike NCCL, it takes several ranks on one card, so four
ranks on one GPU run the explicit collectives of
:mod:`repro_torch.parallel.sp_decode` and :mod:`repro_torch.models.moe_ep` for
real.  Each rank runs with one intra-op thread.  ``fn`` must be importable
(a module-level function).  ``args`` are pickled to each process as it
starts, and a pickle larger than a pipe's buffer (64 KB) holds the next
start until the process has read it, after its imports: pass bulk host data
as a file.  CUDA tensors among ``args`` pickle small: they reach the ranks
through CUDA IPC, without a copy, and stay owned by the caller; each rank
drops its references once ``fn`` has returned, so that the caller's memory is
freed when it drops its own (a block shared by IPC stays allocated in the
caller until every rank has released it).  A rank that raises makes
:func:`run_ranks` raise.
"""

from __future__ import annotations

import gc
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist


def run_ranks(fn, world_size: int, *args, backend: str = "gloo") -> list:
    """``[fn(0, *args), ..., fn(world_size - 1, *args)]``, each in its own
    process, a rank of one process group."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(fn, world_size, backend, tmp, list(args)), nprocs=world_size, join=True)
        if torch.cuda.is_initialized():
            torch.cuda.ipc_collect()  # release what the ranks held of this process's CUDA tensors
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world_size)]


def _rank_main(rank: int, fn, world_size: int, backend: str, tmp: str, args: list) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=rank, world_size=world_size)
    try:
        out = fn(rank, *args)
        args.clear()  # release the caller's CUDA tensors (IPC) before this process ends
        gc.collect()
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
