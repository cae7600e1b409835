"""Point-cloud denoiser of the aircraft alignment experiment (counterpart of
``diffusion_extensions_tpu/models/planenet.py``).

Siren point embedding + sinusoidal timestep embedding, a post-norm
transformer encoder over the points, gated pooling and a linear head.
``bf16=True`` runs the encoder under bf16 autocast (its matmuls in bf16,
LayerNorm and softmax in float32); the embeddings and the head stay float32.
``moe_experts > 0`` gives every encoder layer a Switch MoE FFN
(``models/moe.py``, scatter dispatch by default, as the JAX PlaneNet);
after a forward, ``moe_aux()`` is the load-balance loss summed over the
layers and ``expert_fracs()`` the (layers, E) token fractions.
``trunk=DeepSeekV2Config(...)`` takes DeepSeek-V2's pre-norm MLA + MoE
block (``models/deepseek_v2.py``) in place of the encoder, at the trunk's
own width, with a final RMSNorm before the pool; its MoE layers' balance
loss is weighted by ``aux_weight`` (the trunk's ``aux_loss_alpha``).

``planenet_pp_params`` / ``planenet_pp_apply`` run the encoder stack
through the GPipe pipeline of ``parallel/pp.py``.
"""
from __future__ import annotations

import torch
from torch import nn

from .deepseek_v2 import DeepSeekV2Config, DeepSeekV2Trunk
from .layers import PoolRN, SinusoidalPosEmb, Siren, TransformerEncoder, dense, widen

__all__ = ["PlaneNet", "planenet_pp_params", "planenet_pp_apply"]


class PlaneNet(nn.Module):
    """x: (B, N, 3) projected point cloud, t: (B,) timesteps ->
    (B, 3) skew-vec noise prediction."""

    def __init__(self, dim: int = 512, heads: int = 4, layers: int = 4,
                 bf16: bool = False, moe_experts: int = 0, moe_dispatch: str = "scatter",
                 trunk: DeepSeekV2Config | None = None):
        super().__init__()
        if trunk is not None:
            if moe_experts:
                raise ValueError("the DeepSeek-V2 trunk brings its own experts: moe_experts must be 0")
            dim, moe_experts = trunk.hidden_size, trunk.n_routed_experts
            self.aux_weight = trunk.aux_loss_alpha
        self.bf16, self.moe_experts = bf16, moe_experts
        self.siren = Siren(3, dim // 2, scale=30)
        self.pos_emb = SinusoidalPosEmb(dim // 2)
        if trunk is not None:
            self.encoder = DeepSeekV2Trunk(trunk)
        else:
            self.encoder = TransformerEncoder(dim, heads, layers, moe_experts=moe_experts,
                                              moe_dispatch=moe_dispatch)
        self.pool = PoolRN(dim)
        self.head = dense(dim, 3)

    def embed(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The encoder's input: (B, N, dim)."""
        x_emb = self.siren(x)  # (B, N, dim/2)
        t_tok = self.pos_emb(t)[:, None, :].expand_as(x_emb)
        return torch.cat((x_emb, t_tok), dim=-1)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        h = self.embed(x, t)
        with torch.autocast(h.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            h = self.encoder(h)
        return self.head(self.pool(h.float()))

    def _moe_layers(self):
        if isinstance(self.encoder, DeepSeekV2Trunk):
            return self.encoder.moe_layers()
        return [layer.moe for layer in self.encoder.layers if layer.moe is not None]

    def moe_aux(self) -> torch.Tensor:
        """The last forward's load-balance loss, summed over the layers."""
        return sum(m.aux_loss for m in self._moe_layers())

    def expert_fracs(self) -> torch.Tensor:
        """The last forward's token fraction of each expert: (layers, E)."""
        return torch.stack([m.expert_frac for m in self._moe_layers()])


def planenet_pp_params(model: PlaneNet, group) -> dict:
    """The pipeline layout of ``model`` over the ranks of ``group``: this
    rank's stage, the contiguous L / P of the encoder layers (the
    embedding and the head stay the model's own, run on every rank)."""
    from ..parallel.pp import shard_stacked_params

    return {"layers": shard_stacked_params(list(model.encoder.layers), group)}


def planenet_pp_apply(model: PlaneNet, pp_params: dict, x: torch.Tensor, t: torch.Tensor,
                      group, n_microbatches: int):
    """PlaneNet's forward with the encoder stack run through the GPipe
    pipeline (``parallel/pp.py``) over ``group``: the embedding and the
    head run on every rank, the L encoder layers in P stages.  Equal to
    ``model(x, t)`` without MoE.  With MoE the return is ``(pred, aux)``:
    every microbatch routes its own tokens (the capacity follows the token
    count), and ``aux`` is the load-balance loss summed over the layers
    and averaged over the microbatches."""
    from ..parallel.pp import pipeline_apply

    moe = model.moe_experts > 0
    h = model.embed(x, t)

    def layer_fn(layer, h):
        with torch.autocast(h.device.type, dtype=torch.bfloat16, enabled=model.bf16):
            out = layer(h)
        return (out, layer.moe.aux_loss) if moe else out

    out = pipeline_apply(layer_fn, pp_params["layers"], h, group, n_microbatches,
                         layer_has_aux=moe)
    h, aux = out if moe else (out, None)
    pred = model.head(model.pool(widen(h)))
    return (pred, aux) if moe else pred
