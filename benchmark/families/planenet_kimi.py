"""PlaneNet with Kimi Linear's hybrid block as its trunk, on SO(3) (the
aircraft workload): the program through ``experiments/aircraft.py``
``make_loss_fn`` and ``parallel/dp.py`` ``make_dp_train_step``, its trunk
built from the configuration's keys (those of the published
``config.json``, ``linear_attn_config`` flattened, with ``experts_held``
the routed experts this rank holds).

The reference keeps each MoE layer's correction bias in its loss closure,
from 0, and moves it before each step after the first from the previous
step's choices: as the program moves its buffer after each optimizer step.

``routing_fault(name)`` plants a fault in the program for the length of a
``with`` block (``tools/dsv2_limits.py`` on the card,
``benchmark/tests/test_bench_kimi.py`` on the CPU): in the router
``top_k_minus_one`` (the top k - 1, renormalised over them: the cell's top
7 for its top 8), ``not_renormalised`` (the chosen scores not divided by
their sum) and ``bias_frozen`` (the correction bias never moved); in KDA
``state_not_carried`` (each chunk starts from a zero state) and
``decay_dropped`` (g = 0: nothing decays)."""
from __future__ import annotations

import contextlib

import torch

from ..flops import kimi_linear as flops
from ..reference import kimi_linear as ref_model
from ..reference import processes as ref_proc
from . import planenet

SE3 = False
# the leaves after the bf16 trunk: the pooling and the head
READOUT = ("pool.", "head.")
ROUTING_FAULTS = ("top_k_minus_one", "not_renormalised", "bias_frozen", "state_not_carried", "decay_dropped")
param_spec = ref_model.param_spec
train_inputs = planenet.train_inputs
build_train = planenet.build_train


def trunk_config(cfg: dict):
    """The program's ``KimiLinearConfig`` of a configuration."""
    from dataclasses import fields

    from diffusion_extensions_tpu_torch.models.kimi_linear import KimiLinearConfig

    keys = {f.name for f in fields(KimiLinearConfig)}
    lin = cfg["linear_attn_config"]
    out = {k: v for k, v in cfg.items() if k in keys}
    return KimiLinearConfig(**out, linear_attn_num_heads=lin["num_heads"], linear_attn_head_dim=lin["head_dim"],
                            short_conv_kernel_size=lin["short_conv_kernel_size"],
                            kda_layers=tuple(lin["kda_layers"]), full_attn_layers=tuple(lin["full_attn_layers"]))


def forward_flops(cfg: dict) -> float:
    return flops.forward(cfg, cfg["batch"], cfg["points"])


def build_model(cfg: dict, weights: dict, device):
    """The program's model with the seeded weights and its MoE layers'
    correction biases at 0."""
    from diffusion_extensions_tpu_torch.models.planenet import PlaneNet

    with torch.device("meta"):
        model = PlaneNet(bf16=cfg["bf16"], trunk=trunk_config(cfg))
    model = model.to_empty(device=device)
    buffers = {k: torch.zeros_like(v) for k, v in model.named_buffers()}
    model.load_state_dict(dict(weights, **buffers), strict=True)
    return model


def ref_loss(cfg: dict, sched, q=None):
    c = ref_model._cfg(cfg)
    moe_layers = c["layers"] - c["first_moe"]
    state = {"biases": None, "counts": None}

    def loss(params, clouds, draw):
        t, rot, _ = draw
        if state["biases"] is None:
            state["biases"] = [torch.zeros(c["experts"], device=clouds.device) for _ in range(moe_layers)]
        elif state["counts"] is not None:  # the last step's move
            state["biases"] = [ref_model.update_bias(b, n, c) for b, n in zip(state["biases"], state["counts"])]

        def model(x, tt):
            out, state["counts"] = ref_model.forward(params, cfg, x, tt, state["biases"], q)
            return out

        return ref_proc.so3_loss(model, clouds.to(rot.dtype), t, rot, sched)

    return loss


@contextlib.contextmanager
def routing_fault(name: str):
    """Plant fault ``name`` (ROUTING_FAULTS) in the program."""
    from diffusion_extensions_tpu_torch.models import kimi_linear
    from diffusion_extensions_tpu_torch.models.deepseek_v2 import DeepSeekMoE

    if name not in ROUTING_FAULTS:
        raise ValueError(f"no routing fault {name!r}")
    route, decay = DeepSeekMoE.route, kimi_linear.KimiDeltaAttention.decay

    def top_k_minus_one(self, tokens):
        probs, top_w, top_i = route(self, tokens)
        w = top_w[:, :-1]
        return probs, w / w.sum(-1, keepdim=True) * self.cfg.routed_scaling_factor, top_i[:, :-1]

    def not_renormalised(self, tokens):
        probs, _, top_i = route(self, tokens)
        return probs, probs.gather(-1, top_i) * self.cfg.routed_scaling_factor, top_i

    patches = {"top_k_minus_one": (DeepSeekMoE, "route", top_k_minus_one),
               "not_renormalised": (DeepSeekMoE, "route", not_renormalised),
               "bias_frozen": (DeepSeekMoE, "after_step", lambda self, groups=(): None),
               "state_not_carried": (kimi_linear, "_carry", lambda M, R: torch.zeros_like(R)),
               "decay_dropped": (kimi_linear.KimiDeltaAttention, "decay", lambda self, x: decay(self, x) * 0)}
    owner, attr, value = patches[name]
    orig = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, orig)
