"""PlaneNet with DeepSeek-V2's MLA + MoE block as its trunk, on SO(3) (the
aircraft workload): the program through ``experiments/aircraft.py``
``make_loss_fn`` and ``parallel/dp.py`` ``make_dp_train_step``, its trunk
built from the configuration's keys (those of the published
``config.json``, with ``experts_held`` the routed experts this rank holds).

``routing_fault(name)`` plants a routing fault in the program for the
length of a ``with`` block (``tools/dsv2_limits.py`` on the card,
``tests/test_bench_dsv2.py`` on the CPU): ``top_k_minus_one`` (the top k -
1 in place of the top k: the cell's top 5 for its top 6) or
``renormalised`` (the chosen scores divided by their sum)."""
from __future__ import annotations

import contextlib

import torch

from ..flops import dsv2 as flops
from ..reference import dsv2 as ref_model
from ..reference import processes as ref_proc
from . import planenet

SE3 = False
# the leaves after the bf16 trunk: the pooling and the head
READOUT = ("pool.", "head.")
ROUTING_FAULTS = ("top_k_minus_one", "renormalised")
param_spec = ref_model.param_spec
train_inputs = planenet.train_inputs


def trunk_config(cfg: dict):
    """The program's ``DeepSeekV2Config`` of a configuration."""
    from dataclasses import fields

    from diffusion_extensions_tpu_torch.models.deepseek_v2 import DeepSeekV2Config

    keys = {f.name for f in fields(DeepSeekV2Config)}
    out = {k: v for k, v in cfg.items() if k in keys}
    return DeepSeekV2Config(**out, rope_factor=cfg["rope_scaling"]["factor"],
                            mscale_all_dim=cfg["rope_scaling"]["mscale_all_dim"])


def forward_flops(cfg: dict) -> float:
    return flops.forward(cfg, cfg["batch"], cfg["points"])


def build_model(cfg: dict, weights: dict, device):
    from diffusion_extensions_tpu_torch.models.planenet import PlaneNet

    with torch.device("meta"):
        model = PlaneNet(bf16=cfg["bf16"], trunk=trunk_config(cfg))
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


build_train = planenet.build_train


def ref_loss(cfg: dict, sched, q=None):
    def loss(params, clouds, draw):
        t, rot, _ = draw
        aux = []

        def model(x, tt):
            out, layer_aux = ref_model.forward(params, cfg, x, tt, q)
            aux.append(layer_aux)
            return out

        base = ref_proc.so3_loss(model, clouds.to(rot.dtype), t, rot, sched)
        return base + cfg["aux_loss_alpha"] * aux[0]

    return loss


@contextlib.contextmanager
def routing_fault(name: str):
    """Plant routing fault ``name`` (ROUTING_FAULTS) in the program's MoE layers."""
    from diffusion_extensions_tpu_torch.models.deepseek_v2 import DeepSeekMoE

    orig = DeepSeekMoE.route

    def top_k_minus_one(self, tokens):
        probs, top_w, top_i = orig(self, tokens)
        return probs, top_w[:, :-1], top_i[:, :-1]

    def renormalised(self, tokens):
        probs, top_w, top_i = orig(self, tokens)
        return probs, top_w / top_w.sum(-1, keepdim=True), top_i

    if name not in ROUTING_FAULTS:
        raise ValueError(f"no routing fault {name!r}")
    DeepSeekMoE.route = top_k_minus_one if name == "top_k_minus_one" else renormalised
    try:
        yield
    finally:
        DeepSeekMoE.route = orig
