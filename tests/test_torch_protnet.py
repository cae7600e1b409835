"""The port's ProtNet and its weight converter against the JAX package's flax
ProtNet, on the CPU: dim 32, heads 2, t_depth 2, c_depth 3, float32, weights
converted by ``convert.protnet_params_from_flax``, the same numpy batch
(three ragged pairs padded to one shape) and timesteps."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.data.pdb import pad_prot_batch as j_pad
from diffusion_extensions_tpu.data.pdb import synthetic_prot_pair as j_pair
from diffusion_extensions_tpu.models import protnet as jprotnet
from diffusion_extensions_tpu_torch.convert import (
    _protnet_tables,
    protnet_config_from_flax,
    protnet_params_from_flax,
)
from diffusion_extensions_tpu_torch.data.pdb import to_device
from diffusion_extensions_tpu_torch.models.protnet import ProtNet, receptor_moment_frame
from diffusion_extensions_tpu_torch.models.projections import ProtBatch
from diffusion_extensions_tpu_torch.ops.se3 import AffineGrad, ProtData

torch.set_num_threads(1)
SMALL = dict(dim=32, heads=2, t_depth=2, c_depth=3)
RTOL, ATOL = 1e-4, 1e-5
FLAG_SETS = {
    "reference": {},
    "two_pass": dict(fuse_chains=False),
    "separate_encoders": dict(share_encoders=False),
    "frame_pool": dict(frame_pool=True),
    "cross_depth_1": dict(cross_depth=1),
    "rel_frame": dict(rel_frame=True),
    "equiv_head": dict(equiv_head=True),
    "all": dict(share_encoders=False, frame_pool=True, cross_depth=2, rel_frame=True,
                equiv_head=True),
}
HEADLINE = dict(dim=1024, heads=8, t_depth=12, c_depth=8, frame_pool=True, cross_depth=2,
                rel_frame=True, equiv_head=True)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    pairs = [j_pair(rng, 14 - 2 * i, 8 - i) for i in range(3)]
    t = np.array([0, 317, 999], np.int32)
    return j_pad(pairs), t


def _pair_of_models(flags, batch_np, t, seed=0):
    jm = jprotnet.ProtNet(**SMALL, **flags)
    params = jm.init(jax.random.PRNGKey(seed), batch_np, jnp.asarray(t))
    tree = _np_tree(params)
    cfg = protnet_config_from_flax(tree)
    fuse = flags.get("fuse_chains", True)
    tm = ProtNet(**cfg, fuse_chains=fuse).eval()
    tm.load_state_dict(protnet_params_from_flax(tree), strict=True)
    return jm, params, tm, cfg


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_forward_parity(batch, name):
    """Each flag set: the converter recovers the flags from the tree, the
    converted model gives JAX's outputs within rtol 1e-4 / atol 1e-5
    (measured: <= 7e-6 abs on outputs of size ~3)."""
    flags = FLAG_SETS[name]
    batch_np, t = batch
    jm, params, tm, cfg = _pair_of_models(flags, batch_np, t)
    want = {k: v for k, v in flags.items() if k != "fuse_chains"}
    assert {k: cfg[k] for k in want} == want
    ref = jm.apply(params, batch_np, jnp.asarray(t))
    with torch.no_grad():
        out = tm(to_device(batch_np, "cpu"), torch.from_numpy(t).long())
    assert isinstance(out, AffineGrad) and out.rot_g.shape == (3, 3)
    np.testing.assert_allclose(out.rot_g.numpy(), np.asarray(ref.rot_g), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.shift_g.numpy(), np.asarray(ref.shift_g), rtol=RTOL,
                               atol=ATOL)


def test_receptor_moment_frame_alone(batch):
    """The equivariant head's frame on its own (soft_norm and cross products
    are where two libraries' float32 part first): 1e-5, and a rotation."""
    batch_np, _ = batch
    w = np.random.default_rng(4).uniform(0.0, 1.0, batch_np.receptor_mask.shape + (2,))
    w = w.astype(np.float32)
    ref = jprotnet.receptor_moment_frame(jnp.asarray(w), jnp.asarray(batch_np.receptor.positions),
                                         jnp.asarray(batch_np.receptor_mask))
    ours = receptor_moment_frame(torch.from_numpy(w),
                                 torch.from_numpy(batch_np.receptor.positions),
                                 torch.from_numpy(batch_np.receptor_mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    rtr = ours @ ours.transpose(-1, -2)
    np.testing.assert_allclose(rtr.numpy(), np.broadcast_to(np.eye(3), rtr.shape), atol=1e-3)


def test_padding_content_does_not_change_the_output(batch):
    """Positions and frames of padded ligand residues are masked out of
    every path (the residue conv's content is left alone, as the JAX test
    does: a width-3 conv reads one token across the boundary)."""
    batch_np, t = batch
    _, _, tm, _ = _pair_of_models(FLAG_SETS["all"], batch_np, t)
    tb = to_device(batch_np, "cpu")
    pad = ~tb.ligand_mask
    assert pad.any()
    lig = tb.ligand
    scrambled = ProtBatch(tb.receptor,
                          ProtData(lig.residues, lig.positions + pad[..., None] * 100.0,
                                   lig.angles + pad[..., None, None] * 3.0),
                          tb.receptor_mask, tb.ligand_mask)
    tt = torch.from_numpy(t).long()
    with torch.no_grad():
        a, b = tm(tb, tt), tm(scrambled, tt)
    np.testing.assert_allclose(a.rot_g, b.rot_g, atol=1e-5)
    np.testing.assert_allclose(a.shift_g, b.shift_g, atol=1e-5)


def test_bf16_autocast_close_to_f32(batch):
    """bf16 matmuls keep ~3 significant digits; the output stays float32."""
    batch_np, t = batch
    _, _, tm, cfg = _pair_of_models(FLAG_SETS["all"], batch_np, t)
    tb16 = ProtNet(**cfg, bf16=True).eval()
    tb16.load_state_dict(tm.state_dict())
    tb, tt = to_device(batch_np, "cpu"), torch.from_numpy(t).long()
    with torch.no_grad():
        a, b = tm(tb, tt), tb16(tb, tt)
    assert b.rot_g.dtype == torch.float32
    scale = float(torch.cat((a.rot_g, a.shift_g)).abs().max())
    np.testing.assert_allclose(b.rot_g, a.rot_g, atol=5e-2 * scale)
    np.testing.assert_allclose(b.shift_g, a.shift_g, atol=5e-2 * scale)


def test_headline_width_maps_every_leaf():
    """The headline flags (dim 1024, heads 8, t_depth 12, c_depth 8,
    frame_pool, cross_depth 2, rel_frame, equiv_head): 163,077,652
    parameters in 310 leaves; the converter's table has every flax leaf at
    its shape and the port's model (built on the meta device) the same
    count.  Shapes only: nothing of that size is allocated."""
    rng = np.random.default_rng(0)
    example = j_pad([j_pair(rng, 12, 6)])
    shapes = jax.eval_shape(jprotnet.ProtNet(**HEADLINE).init, jax.random.PRNGKey(0), example,
                            jnp.zeros((1,), jnp.int32))
    flat = {"/".join(str(k.key) for k in path[1:]): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert len(flat) == 310
    assert sum(int(np.prod(s)) for s in flat.values()) == 163_077_652
    cfg = protnet_config_from_flax(shapes)
    assert cfg == dict(HEADLINE, share_encoders=True)
    table, mapping = _protnet_tables(cfg)
    assert table == flat and set(mapping) == set(flat)
    with torch.device("meta"):
        model = ProtNet(**cfg)
    assert sum(p.numel() for p in model.parameters()) == 163_077_652
    assert {key for key, _ in mapping.values()} == set(model.state_dict())


def test_converter_raises_on_bad_trees(batch):
    batch_np, t = batch
    jm = jprotnet.ProtNet(**SMALL, equiv_head=True)
    tree = _np_tree(jm.init(jax.random.PRNGKey(0), batch_np, jnp.asarray(t)))["params"]
    missing = {k: v for k, v in tree.items() if k != "PoolPos_1"}
    with pytest.raises(ValueError, match="missing"):
        protnet_params_from_flax(missing)
    extra = dict(tree, Extra_0={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="extra"):
        protnet_params_from_flax(extra)
    conv = dict(tree["_ResConv_0"], Conv_1={"kernel": np.zeros((3, 32, 31), np.float32),
                                            "bias": np.zeros((32,), np.float32)})
    with pytest.raises(ValueError, match="mis-shaped"):
        protnet_params_from_flax(dict(tree, _ResConv_0=conv))
    head = dict(tree, Dense_1={"kernel": np.zeros((50, 32), np.float32),
                               "bias": np.zeros((32,), np.float32)})
    with pytest.raises(ValueError, match="no flag set"):
        protnet_params_from_flax(head)
    with pytest.raises(ValueError, match="not a flax ProtNet"):
        protnet_config_from_flax({"Dense_0": {}})
    with pytest.raises(NotImplementedError, match="A.2"):
        ProtNet(**SMALL, fused_qkv=True)
    with pytest.raises(ValueError, match="conv_impl"):
        ProtNet(**SMALL, conv_impl="fft")
