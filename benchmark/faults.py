"""Faults planted underneath the timed path, to show that ``correct``
catches them (``tests/test_bench_faults.py`` on the CPU, ``control.py
--mode fault:<name>`` on the card).  Each patches the program's classes
or the experiments' loss functions for the length of a ``with`` block.

Training: ``unchanged`` (the optimizer step leaves the state as it was),
``half_batch`` (the loss over the first half of each batch, the mean
taken over it).  Sampling: ``unchanged`` (a DDIM step returns the state it
was given), ``half_batch`` (the denoiser sees the first half of the poses
and its outputs stand for the others too), ``altered`` (the answer's first
pose turned by 0.01 rad where the sampler produces it)."""
from __future__ import annotations

import contextlib

import torch

TRAIN = ("unchanged", "half_batch")
SAMPLE = ("unchanged", "half_batch", "altered")


def _half(batch):
    from .harness.util import tree_map

    if isinstance(batch, torch.Tensor):
        return batch[: batch.shape[0] // 2]
    return tree_map(lambda x: x[: x.shape[0] // 2], batch)


@contextlib.contextmanager
def planted(kind: str, name: str):
    """Plant fault ``name`` of traffic ``kind`` ("train" / "sample")."""
    from diffusion_extensions_tpu_torch.experiments import aircraft, protein
    from diffusion_extensions_tpu_torch.models.protnet import ProtNet
    from diffusion_extensions_tpu_torch.ops.se3 import AffineGrad
    from diffusion_extensions_tpu_torch.processes.se3 import SE3Diffusion
    from diffusion_extensions_tpu_torch.train.optim import Adam

    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if (kind, name) == ("train", "unchanged"):
        patch(Adam, "step", lambda self: None)
    elif (kind, name) == ("train", "half_batch"):
        for mod in (aircraft, protein):
            def make(*a, _orig=mod.make_loss_fn, **k):
                inner = _orig(*a, **k)
                return lambda gen, batch: inner(gen, _half(batch))
            patch(mod, "make_loss_fn", make)
    elif (kind, name) == ("sample", "unchanged"):
        orig_map = SE3Diffusion._ddim_map

        def stuck(self, denoise_fn, x, *a, **k):
            orig_map(self, denoise_fn, x, *a, **k)
            return x
        patch(SE3Diffusion, "_ddim_map", stuck)
    elif (kind, name) == ("sample", "half_batch"):
        orig_fwd = ProtNet.forward

        def half(self, x, t):
            h = t.shape[0] // 2
            out = orig_fwd(self, _half(x), t[:h])
            n = t.shape[0]
            return AffineGrad(out.rot_g.repeat(2, 1)[:n], out.shift_g.repeat(2, 1)[:n])
        patch(ProtNet, "forward", half)
    elif (kind, name) == ("sample", "altered"):
        orig_loop = SE3Diffusion.ddim_sample_loop

        def altered(self, *a, **k):
            out = orig_loop(self, *a, **k)
            c, s = torch.cos(torch.tensor(0.01)), torch.sin(torch.tensor(0.01))
            turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], device=out.rot.device)
            rot = out.rot.clone()
            rot[0] = rot[0] @ turn
            out.rot = rot
            return out
        patch(SE3Diffusion, "ddim_sample_loop", altered)
    else:
        raise ValueError(f"no fault {name!r} for {kind} traffic")
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)
