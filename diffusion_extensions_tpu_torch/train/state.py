"""Training state and full checkpointing (counterpart of
``diffusion_extensions_tpu/train/state.py``).

A checkpoint is the complete ``TrainState``: weights, optimizer state, step
counter and the training generator's state, so training resumes exactly.
Checkpoints live in a **directory**, one ``torch.save`` file per step
(``step_00001000.pt``); the newest ``MAX_TO_KEEP`` are kept.  Files are
read back with ``weights_only=True`` (tensors, numbers, strings and dicts
of them only).

In a process group, every rank calls ``save_checkpoint`` (weights and
moments sharded as DTensors, by FSDP2 or tensor parallelism, are gathered
whole) and rank 0 writes; every rank restores from the same file, each
taking its own shards.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from .optim import Adam

__all__ = ["TrainState", "save_checkpoint", "restore_checkpoint", "latest_step",
           "checkpoint_path", "load_eval_weights"]

MAX_TO_KEEP = 3
_FILE = re.compile(r"^step_(\d+)\.pt$")


@dataclass
class TrainState:
    """What a train step reads and updates in place: the model's weights,
    the optimizer's moments, the step counter and the generator that draws
    timesteps and noise.  Evaluation, which restores ``params_only``, may
    leave ``optimizer`` as ``None``."""

    model: nn.Module
    optimizer: Optional[Adam]
    generator: torch.Generator
    step: int = 0


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir: str, state: TrainState, step: Optional[int] = None) -> str:
    """Write ``state`` as step ``step`` (default ``state.step``) and drop all
    but the newest ``MAX_TO_KEEP`` checkpoints; returns the file's path."""
    step = state.step if step is None else step
    path = checkpoint_path(ckpt_dir, step)
    payload = {
        "step": state.step,
        "params": {k: _whole(v.detach()) for k, v in state.model.state_dict().items()},
        "opt_state": _map_tensors(_whole, state.optimizer.state_dict()),
        "generator_state": state.generator.get_state(),
    }
    if not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in _steps(ckpt_dir)[:-MAX_TO_KEEP]:
            os.remove(checkpoint_path(ckpt_dir, old))
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()  # the file is there before any rank reads it
    return path


def _whole(t):
    """A DTensor gathered whole (a collective); any other value as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _shards_like(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``src`` (whole) laid out as ``dst``: this rank's shard when ``dst``
    is a DTensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(dst, DTensor):
        return distribute_tensor(src.to(dst.device), dst.device_mesh, dst.placements)
    return src


def restore_checkpoint(ckpt_dir: str, target: TrainState, params_only: bool = False) -> TrainState:
    """Restore the latest checkpoint of ``ckpt_dir`` into ``target`` (in
    place; ``target`` is returned unchanged when there is none).

    ``params_only=True`` takes weights, step and generator state from disk
    and ignores the stored optimizer state.  Evaluation uses this: it never
    touches the optimizer, and a checkpoint written with other optimizer
    flags (moments in bf16) would not fit the evaluation side's optimizer.
    The stored names and shapes are validated against the model first.
    """
    step = latest_step(ckpt_dir)
    if step is None:
        return target
    device = next(target.model.parameters()).device
    raw = torch.load(checkpoint_path(ckpt_dir, step), map_location=device, weights_only=True)
    want = target.model.state_dict()
    if params_only:
        got_names, want_names = sorted(raw["params"]), sorted(want)
        if got_names != want_names:
            raise ValueError(
                f"params_only restore from {ckpt_dir} step {step}: "
                f"checkpoint param tree does not match the model config "
                f"(stored {got_names} vs target {want_names}) — check the eval flags "
                f"match the training flags")
        for name in want:
            a, b = raw["params"][name], want[name]
            if tuple(a.shape) != tuple(b.shape):
                raise ValueError(
                    f"params_only restore from {ckpt_dir} step {step}: "
                    f"shape mismatch at {name}: stored "
                    f"{tuple(a.shape)} vs model {tuple(b.shape)}")
    target.model.load_state_dict({k: _shards_like(want.get(k), v)
                                  for k, v in raw["params"].items()})
    if not params_only:
        opt, stored = target.optimizer, raw["opt_state"]
        mine = {key: dict(zip(opt.names, getattr(opt, key))) for key in ("mu", "nu")}
        opt.load_state_dict({"count": stored["count"], **{
            key: {n: _shards_like(mine[key].get(n), v) for n, v in stored[key].items()}
            for key in ("mu", "nu")}})
    target.generator.set_state(raw["generator_state"].cpu())
    target.step = int(raw["step"])
    return target


def load_eval_weights(model: nn.Module, ckpt: str, device) -> bool:
    """Weights for evaluation: the newest checkpoint of the directory
    ``ckpt`` (``params_only``, validated against the model), or a bare
    ``torch.save`` state dict at that path.  False when there is neither."""
    if os.path.isfile(ckpt):
        model.load_state_dict(torch.load(ckpt, map_location=device, weights_only=True))
        return True
    target = TrainState(model, None, torch.Generator(device=device))
    return restore_checkpoint(ckpt, target, params_only=True).step > 0
