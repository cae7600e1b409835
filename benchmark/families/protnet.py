"""ProtNet on SE(3) (the docking workload): training through
``experiments/protein.py`` ``make_loss_fn`` and ``parallel/dp.py``
``make_dp_train_step``; sampling through ``processes/se3.py``
``ddim_sample_loop`` with the experiment's ``ProtProjection``."""
from __future__ import annotations

import numpy as np
import torch

from ..flops import protnet as flops
from ..reference import processes as ref_proc
from ..reference import protnet as ref_model
from ..traffic import synthetic

SE3 = True
# the leaves after the bf16 encoder and cross layers: the poolings, the
# moment gate and the head
READOUT = ("r_pool.", "l_pool.", "r_pos.", "l_pos.", "moment_gate.", "r_frame.", "l_frame.", "head_")
param_spec = ref_model.param_spec


def forward_flops(cfg: dict) -> float:
    return flops.forward(cfg["dim"], cfg["t_depth"], cfg["c_depth"], cfg["batch"], cfg["receptor_len"],
                         cfg["ligand_len"], cfg["cross_depth"], cfg["frame_pool"], cfg["rel_frame"],
                         cfg["equiv_head"])


def build_model(cfg: dict, weights: dict, device):
    from diffusion_extensions_tpu_torch.models.protnet import ProtNet

    with torch.device("meta"):
        model = ProtNet(dim=cfg["dim"], heads=cfg["heads"], t_depth=cfg["t_depth"], c_depth=cfg["c_depth"],
                        se3=True, bf16=cfg["bf16"], frame_pool=cfg["frame_pool"],
                        cross_depth=cfg["cross_depth"], rel_frame=cfg["rel_frame"],
                        equiv_head=cfg["equiv_head"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def build_process(cfg: dict, device):
    from diffusion_extensions_tpu_torch.processes.se3 import ProjectedSE3Diffusion

    return ProjectedSE3Diffusion(timesteps=cfg["timesteps"], clip_shift=cfg["clip_shift"], device=device)


def build_train(cfg: dict, model, device):
    from diffusion_extensions_tpu_torch.experiments import protein

    process = build_process(cfg, device)
    return process, protein.make_loss_fn(model, process, se3=True)


def program_batch(batch: dict):
    """The benchmark's dict of tensors as the program's ProtBatch."""
    from diffusion_extensions_tpu_torch.models.projections import ProtBatch
    from diffusion_extensions_tpu_torch.ops.se3 import ProtData

    return ProtBatch(ProtData(batch["rec_res"], batch["rec_pos"], batch["rec_frames"]),
                     ProtData(batch["lig_res"], batch["lig_pos"], batch["lig_frames"]),
                     batch["rec_mask"], batch["lig_mask"])


def _to_device(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def train_inputs(cfg: dict, k: int, rng: np.random.Generator, device):
    """(the program's ProtBatch with a leading K axis, the K sub-batches
    as the reference takes them): K batches of the pairs, each pair
    augmented afresh."""
    pairs = synthetic.prot_pairs(cfg["batch"], cfg, rng)
    subs = [synthetic.prot_batch(pairs, cfg, rng) for _ in range(k)]
    stacked = _to_device({key: np.stack([s[key] for s in subs]) for key in subs[0]}, device)
    return program_batch(stacked), [{key: v[i] for key, v in stacked.items()} for i in range(k)]


def sample_inputs(cfg: dict, rng: np.random.Generator, device) -> dict:
    """One batch of ``batch`` poses: the pairs, each augmented once."""
    pairs = synthetic.prot_pairs(cfg["batch"], cfg, rng)
    return _to_device(synthetic.prot_batch(pairs, cfg, rng), device)


def projection(batch: dict):
    from diffusion_extensions_tpu_torch.models.projections import ProtProjection

    return ProtProjection(program_batch(batch), se3=True)


def _as(batch: dict, dtype) -> dict:
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in batch.items()}


def ref_loss(cfg: dict, sched, q=None):
    def loss(params, batch, draw):
        t, rot, z = draw
        return ref_proc.se3_loss(lambda b, tt: ref_model.forward(params, cfg, b, tt, q),
                                 _as(batch, rot.dtype), t, rot, z, sched)

    return loss


def ref_denoise(cfg: dict, params: dict, batch: dict, rot, shift, t, q=None):
    """The reference denoiser's (B, 6) at the state (rot, shift): the
    ligand moved about its centroid, the receptor kept."""
    b = _as(batch, rot.dtype)
    pos, frames = ref_proc.move_ligand(b["lig_pos"], b["lig_frames"], b["lig_mask"], rot, shift)
    return ref_model.forward(params, cfg, dict(b, lig_pos=pos, lig_frames=frames), t, q)
