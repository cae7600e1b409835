"""PlaneNet on SO(3) (the aircraft workload): the program through
``experiments/aircraft.py`` ``make_loss_fn`` and ``parallel/dp.py``
``make_dp_train_step``."""
from __future__ import annotations

import numpy as np
import torch

from ..flops import planenet as flops
from ..reference import planenet as ref_model
from ..reference import processes as ref_proc
from ..traffic import synthetic

SE3 = False
# the leaves after the bf16 encoder: the pooling and the head
READOUT = ("pool.", "head.")
param_spec = ref_model.param_spec


def forward_flops(cfg: dict) -> float:
    return flops.forward(cfg["dim"], cfg["layers"], cfg["batch"], cfg["points"])


def build_model(cfg: dict, weights: dict, device):
    from diffusion_extensions_tpu_torch.models.planenet import PlaneNet

    with torch.device("meta"):
        model = PlaneNet(dim=cfg["dim"], heads=cfg["heads"], layers=cfg["layers"], bf16=cfg["bf16"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def build_train(cfg: dict, model, device):
    """(process, the experiment's loss function)."""
    from diffusion_extensions_tpu_torch.experiments import aircraft
    from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion

    process = ProjectedSO3Diffusion(timesteps=cfg["timesteps"], device=device)
    return process, aircraft.make_loss_fn(model, process, so3=True)


def train_inputs(cfg: dict, k: int, rng: np.random.Generator, device):
    """(the program's batch with a leading K axis, the K sub-batches as
    the reference takes them): K x batch distinct clouds."""
    clouds = synthetic.planes(k * cfg["batch"], cfg["points"], rng)
    pool = torch.from_numpy(clouds).to(device).reshape(k, cfg["batch"], cfg["points"], 3)
    return pool, [pool[i] for i in range(k)]


def ref_loss(cfg: dict, sched, q=None):
    def loss(params, clouds, draw):
        t, rot, _ = draw
        return ref_proc.so3_loss(lambda x, tt: ref_model.forward(params, cfg, x, tt, q),
                                 clouds.to(rot.dtype), t, rot, sched)

    return loss
