"""bf16 against JAX's bf16, on the CPU at dim 32: PlaneNet (2 heads, 2
layers) and ProtNet (2 heads, t_depth 2, c_depth 3; the reference flags and
every flag), forwards and losses, flax ``bf16=True`` (its modules'
``dtype=bfloat16``) against the port's ``bf16=True`` (autocast), from the
same converted weights and inputs.

Where the two bf16 paths differ in dtype:
* the attention softmax: flax takes it in bf16 (``force_fp32_for_softmax``
  is off), the port in float32 cast back to bf16;
* a masked logit: bf16's most negative value in flax, float32's in the
  port (both give the key a weight of 0);
* everything else matches: q/k/v, output and feed-forward matmuls in bf16
  with bf16 outputs, q scaled in bf16 before the product, LayerNorms,
  residual sums, poolings, Sirens and the heads in float32.
Each library's bf16 forward parts from its own float32 one by 1.2e-3 to
3.3e-3 of the output's largest entry, and the two bf16 forwards part from
each other by 0.8e-3 to 2.3e-3 (measured), so both are held to 1e-2 of
that scale; the losses to rtol 1e-2.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.data.pdb import pad_prot_batch as j_pad
from diffusion_extensions_tpu.data.pdb import synthetic_prot_pair as j_pair
from diffusion_extensions_tpu.models import protnet as jprotnet
from diffusion_extensions_tpu.models.planenet import PlaneNet as JPlaneNet
from diffusion_extensions_tpu.models.projections import PointCloudProj as JCloudProj
from diffusion_extensions_tpu.models.projections import ProtProjection as JProtProj
from diffusion_extensions_tpu.ops import se3 as jse3
from diffusion_extensions_tpu.processes.se3 import ProjectedSE3Diffusion as JSE3
from diffusion_extensions_tpu.processes.so3 import ProjectedSO3Diffusion as JSO3
from diffusion_extensions_tpu_torch.convert import (
    planenet_params_from_flax,
    protnet_config_from_flax,
    protnet_params_from_flax,
)
from diffusion_extensions_tpu_torch.data.pdb import to_device
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.models.projections import PointCloudProj, ProtProjection
from diffusion_extensions_tpu_torch.models.protnet import ProtNet
from diffusion_extensions_tpu_torch.ops.se3 import AffineT
from diffusion_extensions_tpu_torch.processes.se3 import ProjectedSE3Diffusion
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion

torch.set_num_threads(1)
TOL = 1e-2
T = 50
PROT_FLAGS = {"reference": {}, "all": dict(frame_pool=True, cross_depth=2, rel_frame=True,
                                          equiv_head=True)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Pair:
    """A flax model and the port's with its weights, at one bf16 setting."""

    def __init__(self, kind: str, bf16: bool):
        rng = np.random.default_rng(0)
        self.kind = kind
        if kind == "planenet":
            self.x = rng.standard_normal((4, 64, 3)).astype(np.float32) * 0.5
            self.t = np.array([0, 10, 30, 49], np.int32)
            self.jm = JPlaneNet(dim=32, heads=2, layers=2, bf16=bf16)
            self.params = _np(self.jm.init(jax.random.PRNGKey(0), jnp.asarray(self.x),
                                           jnp.asarray(self.t)))
            self.tm = PlaneNet(dim=32, heads=2, layers=2, bf16=bf16).eval()
            self.tm.load_state_dict(planenet_params_from_flax(self.params))
        else:
            self.x = j_pad([j_pair(rng, 14 - 2 * i, 8 - i) for i in range(3)])
            self.t = np.array([0, 17, 49], np.int32)
            self.jm = jprotnet.ProtNet(dim=32, heads=2, t_depth=2, c_depth=3, bf16=bf16,
                                       **PROT_FLAGS[kind])
            self.params = _np(self.jm.init(jax.random.PRNGKey(0), self.x, jnp.asarray(self.t)))
            self.tm = ProtNet(**protnet_config_from_flax(self.params), bf16=bf16).eval()
            self.tm.load_state_dict(protnet_params_from_flax(self.params))

    def forwards(self):
        """(flax output, port output) as (B, k) numpy arrays."""
        tt = torch.from_numpy(self.t).long()
        if self.kind == "planenet":
            ref = self.jm.apply(self.params, jnp.asarray(self.x), jnp.asarray(self.t))
            with torch.no_grad():
                ours = self.tm(torch.from_numpy(self.x), tt)
            return np.asarray(ref), ours.numpy()
        ref = self.jm.apply(self.params, self.x, jnp.asarray(self.t))
        with torch.no_grad():
            ours = self.tm(to_device(self.x, "cpu"), tt)
        return (np.concatenate([np.asarray(ref.rot_g), np.asarray(ref.shift_g)], -1),
                torch.cat([ours.rot_g, ours.shift_g], -1).numpy())

    def losses(self):
        """(flax loss, port loss) of the process the model serves (the
        aircraft's SO(3) loss, the docking SE(3) loss), the port given JAX's
        t and noise."""
        key = jax.random.PRNGKey(3)
        k_t, k_n = jax.random.split(key)
        if self.kind == "planenet":
            b = self.x.shape[0]
            jproc, tproc = JSO3(T), ProjectedSO3Diffusion(T, device="cpu")
            t = jax.random.randint(k_t, (b,), 0, T)
            noise = torch.from_numpy(np.array(jproc.sample_noise(k_n, t)))
            ref = jproc.loss(lambda x, tt: self.jm.apply(self.params, x, tt), key,
                             jnp.broadcast_to(jnp.eye(3), (b, 3, 3)),
                             JCloudProj(jnp.asarray(self.x)))
            with torch.no_grad():
                ours = tproc.loss(self.tm, None, torch.eye(3).expand(b, 3, 3),
                                  PointCloudProj(torch.from_numpy(self.x)),
                                  t=torch.from_numpy(np.array(t)).long(), noise=noise)
            return float(ref), float(ours)
        b = 3
        jproc, tproc = JSE3(T), ProjectedSE3Diffusion(T, device="cpu")
        t = jax.random.randint(k_t, (b,), 0, T)
        noise = jproc.sample_noise(k_n, t)
        truth = jse3.AffineT(jnp.broadcast_to(jnp.eye(3), (b, 3, 3)), jnp.zeros((b, 3)))
        ref = jproc.loss(lambda x, tt: self.jm.apply(self.params, x, tt), key, truth,
                         JProtProj(self.x))
        with torch.no_grad():
            ours = tproc.loss(self.tm, None, AffineT.identity((b,)),
                              ProtProjection(to_device(self.x, "cpu")),
                              t=torch.from_numpy(np.array(t)).long(),
                              noise=AffineT(torch.from_numpy(np.array(noise.rot)),
                                            torch.from_numpy(np.array(noise.shift))))
        return float(ref), float(ours)


KINDS = ["planenet", "reference", "all"]


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, kind, bf16):
    if (kind, bf16) not in pairs:
        pairs[kind, bf16] = Pair(kind, bf16)
    return pairs[kind, bf16]


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_forward_matches_jax_bf16(pairs, kind):
    """The two bf16 forwards within 1e-2 of the float32 output's largest
    entry, and each bf16 forward off its own float32 one (bf16 did run)."""
    ref32, ours32 = _pair(pairs, kind, False).forwards()
    ref, ours = _pair(pairs, kind, True).forwards()
    scale = float(np.abs(ref32).max())
    np.testing.assert_allclose(ours32, ref32, rtol=1e-4, atol=1e-5 * scale)
    assert float(np.abs(ours - ref).max()) < TOL * scale
    for bf, f32 in ((ref, ref32), (ours, ours32)):
        assert 1e-5 * scale < float(np.abs(bf - f32).max()) < TOL * scale


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_loss_matches_jax_bf16(pairs, kind):
    ref, ours = _pair(pairs, kind, True).losses()
    np.testing.assert_allclose(ours, ref, rtol=TOL)
