"""Multi-process launch (counterpart of
``diffusion_extensions_tpu/parallel/launch.py``).

PyTorch runs one process per card.  Every process runs the same driver and
calls ``maybe_initialize_distributed()`` first; it joins the default
process group when the environment describes one, and is a no-op in a
process that runs alone, so drivers call it unconditionally.

Environment contract, either of:
  torchrun's  RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT
  the JAX package's  DXT_COORDINATOR (host:port of process 0),
              DXT_NUM_PROCESSES, DXT_PROCESS_ID (or the JAX_* names)
On the card the backend is NCCL and each process takes the card of its
local rank (LOCAL_RANK, else the process id modulo the cards of the host);
on the CPU it is gloo.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["maybe_initialize_distributed", "distributed_env"]


def _env(*names):
    return next((os.environ[n] for n in names if os.environ.get(n)), None)


def distributed_env() -> dict | None:
    """``{"init_method", "world_size", "rank", "local_rank"}`` from the
    environment, or None when it describes no process group."""
    coord = _env("DXT_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
    if coord:
        rank = int(_env("DXT_PROCESS_ID", "JAX_PROCESS_ID"))
        world = int(_env("DXT_NUM_PROCESSES", "JAX_NUM_PROCESSES"))
    elif os.environ.get("WORLD_SIZE") and os.environ.get("MASTER_ADDR"):
        coord = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        return None
    local = os.environ.get("LOCAL_RANK")
    return {"init_method": f"tcp://{coord}", "world_size": world, "rank": rank,
            "local_rank": int(local) if local is not None else None}


def maybe_initialize_distributed(device=None, verbose: bool = True) -> bool:
    """Join the default process group when the environment configures one.

    ``device`` is where the process computes (default: the card): NCCL and
    ``torch.cuda.set_device(local rank)`` on the card, gloo on the CPU.
    Returns True when a group is (or already was) initialised, False in a
    process that runs alone."""
    if dist.is_initialized():
        return True
    env = distributed_env()
    if env is None:
        return False
    on_card = torch.device("cuda" if device is None else device).type == "cuda"
    if on_card:
        local = env["local_rank"]
        if local is None:
            local = env["rank"] % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if on_card else "gloo", init_method=env["init_method"],
                            world_size=env["world_size"], rank=env["rank"])
    if verbose:
        print(f"torch.distributed: process {dist.get_rank()}/{dist.get_world_size()} "
              f"({dist.get_backend()})")
    return True
