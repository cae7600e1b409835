"""Training-loop utilities: throughput metering, metric logging and a
step-range profiler capture (counterpart of
``diffusion_extensions_tpu/train/loop.py``)."""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Optional

__all__ = ["Throughput", "MetricLogger", "trace_window"]


def trace_window(out_dir: str, start_step: int = 50, num_steps: int = 10):
    """Step-range ``torch.profiler`` capture: returns ``on_step(i)`` to call
    once per training step; writes a Chrome trace of steps
    [start_step, start_step + num_steps) to ``out_dir/trace.json`` (the
    drivers' ``--profile-dir``).  Spans (``obs``) are cleared and on from
    this call, so a step captured after it holds its device stamps and the
    trace its ``dxt::`` ranges; at the window's end ``obs.snapshot()`` is
    written to ``out_dir/spans.json`` and spans go off."""
    import torch

    from .. import obs

    obs.reset()
    obs.enable()
    state = {"prof": None, "done": False}

    def on_step(i: int):
        if state["done"]:
            return
        if state["prof"] is None and i >= start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            state["prof"] = torch.profiler.profile(activities=activities)
            state["prof"].start()
        elif state["prof"] is not None and i >= start_step + num_steps:
            state["prof"].stop()
            os.makedirs(out_dir, exist_ok=True)
            state["prof"].export_chrome_trace(os.path.join(out_dir, "trace.json"))
            with open(os.path.join(out_dir, "spans.json"), "w") as f:
                json.dump(obs.snapshot(), f)
            obs.disable()
            state["prof"] = None
            state["done"] = True
            print(f"profiler trace written to {out_dir}")

    return on_step


class Throughput:
    """Steps/sec meter with warmup exclusion.  It reads the host's clock
    only: read ``steps_per_sec`` after something that waited for the device
    (a logged loss does)."""

    def __init__(self, warmup_steps: int = 10):
        self.warmup_steps = warmup_steps
        self._count = 0
        self._t0 = None

    def tick(self):
        self._count += 1
        if self._count == self.warmup_steps:
            self._t0 = time.perf_counter()

    @property
    def steps_per_sec(self) -> Optional[float]:
        if self._t0 is None or self._count <= self.warmup_steps:
            return None
        return (self._count - self.warmup_steps) / (
            time.perf_counter() - self._t0
        )


class MetricLogger:
    """Console + optional JSONL + optional wandb metric sink."""

    def __init__(
        self,
        jsonl_path: Optional[str] = None,
        print_every: int = 10,
        use_wandb: bool = False,
        wandb_kwargs: Optional[dict] = None,
    ):
        self.print_every = print_every
        self._jsonl = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self._wandb = wandb
            except Exception as e:  # zero-egress / not installed
                print(f"wandb disabled: {e}", file=sys.stderr)

    def log(self, step: int, metrics: dict[str, Any]):
        scalars = {
            k: (float(v) if hasattr(v, "__float__") else v)
            for k, v in metrics.items()
        }
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        if self.print_every and step % self.print_every == 0:
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in scalars.items()
            )
            print(f"step {step}: {parts}", flush=True)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
