"""The Euler arms' geometry and models against the JAX package, on the CPU:
``rmat_to_euler``, the Euler ``PointCloudProj`` and ``ProtProjection``,
``EulerRotPredict`` and its converter, the fused-QKV attention and
``ProtNet(fused_qkv=True)``, and ``ProtNet(se3=False)`` over the flag sets
of ``test_torch_protnet.py`` (dim 32, heads 2, t_depth 2, c_depth 3).
Weights are flax's, converted; inputs the same numpy arrays.  Forwards are
held to rtol 1e-4 / atol 1e-5, geometry to 1e-5."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.data.pdb import pad_prot_batch as j_pad
from diffusion_extensions_tpu.data.pdb import synthetic_prot_pair as j_pair
from diffusion_extensions_tpu.models import layers as jlayers
from diffusion_extensions_tpu.models import protnet as jprotnet
from diffusion_extensions_tpu.models.projections import PointCloudProj as JCloudProj
from diffusion_extensions_tpu.models.projections import ProtProjection as JProtProj
from diffusion_extensions_tpu.models.rot_predict import EulerRotPredict as JEulerRotPredict
from diffusion_extensions_tpu.models.rot_predict import RotPredict as JRotPredict
from diffusion_extensions_tpu.ops import so3 as jso3
from diffusion_extensions_tpu_torch import convert
from diffusion_extensions_tpu_torch.convert import (
    euler_rot_predict_config_from_flax,
    euler_rot_predict_params_from_flax,
    protnet_config_from_flax,
    protnet_params_from_flax,
    rot_predict_params_from_flax,
)
from diffusion_extensions_tpu_torch.data.pdb import to_device
from diffusion_extensions_tpu_torch.models.layers import TransformerEncoderLayer
from diffusion_extensions_tpu_torch.models.projections import PointCloudProj, ProtProjection
from diffusion_extensions_tpu_torch.models.protnet import ProtNet
from diffusion_extensions_tpu_torch.models.rot_predict import EulerRotPredict, RotPredict
from diffusion_extensions_tpu_torch.ops.so3 import euler_to_rmat, haar_rotations, rmat_to_euler

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


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    pairs = [j_pair(rng, 14 - 2 * i, 8 - i) for i in range(3)]
    return j_pad(pairs), np.array([0, 317, 999], np.int32)


# -- geometry ----------------------------------------------------------------
def test_rmat_to_euler_away_from_the_lock():
    """Haar rotations with |y| < 1.4: the angles equal JAX's within 1e-5 and
    compose back to R."""
    r = haar_rotations(torch.Generator().manual_seed(0), (256,))
    r = r * torch.linalg.det(r)[:, None, None]  # proper rotations
    ours = torch.stack(rmat_to_euler(r), -1)
    ref = np.stack(jso3.rmat_to_euler(jnp.asarray(r.numpy())), -1)
    keep = np.abs(ref[:, 1]) < 1.4
    assert keep.sum() > 200
    np.testing.assert_allclose(ours.numpy()[keep], ref[keep], rtol=0, atol=1e-5)
    back = euler_to_rmat(*ours.unbind(-1))
    np.testing.assert_allclose(back.numpy(), r.numpy(), atol=2e-6)


def test_rmat_to_euler_across_the_lock():
    """The lock segment's rotations about y from pi/3 to 2 pi/3 (|y| crosses
    pi/2, where x and z are ill-defined): only the rotation the angles
    compose back to (measured 9e-8), and y, are compared.  Past the lock
    the decomposition gives y' = pi - y with x = z = +-pi: another triple
    for the same rotation."""
    y = torch.linspace(math.pi / 3, 2 * math.pi / 3, 257)
    zero = torch.zeros_like(y)
    r = euler_to_rmat(zero, y, zero)
    x, yy, z = rmat_to_euler(r)
    back = euler_to_rmat(x, yy, z)
    np.testing.assert_allclose(back.numpy(), r.numpy(), atol=1e-6)
    ref_y = np.asarray(jso3.rmat_to_euler(jnp.asarray(r.numpy()))[1])
    np.testing.assert_allclose(yy.numpy(), ref_y, atol=1e-5)
    assert float(yy.abs().max()) == pytest.approx(math.pi / 2, abs=1e-3)


def test_point_cloud_projection_euler_arm():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((4, 16, 3)).astype(np.float32)
    eul = rng.uniform(-3, 3, (4, 3)).astype(np.float32)
    ref = JCloudProj(jnp.asarray(data), so3=False)(jnp.asarray(eul))
    ours = PointCloudProj(_t(data), so3=False)(_t(eul))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    rot = euler_to_rmat(*_t(eul).unbind(-1))
    torch.testing.assert_close(PointCloudProj(_t(data))(rot), ours)


def test_prot_projection_euler_arm(batch):
    """The 6-vector (Euler, shift) moves the ligand as JAX's does (atol 2e-5
    at ~30 A); the receptor is untouched; k x B rows tile the batch."""
    batch_np, _ = batch
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(-3, 3, (3, 3)), rng.standard_normal((3, 3)) * 10],
                       -1).astype(np.float32)
    ref = JProtProj(batch_np, se3=False)(jnp.asarray(x))
    tb = to_device(batch_np, "cpu")
    ours = ProtProjection(tb, se3=False)(_t(x))
    np.testing.assert_allclose(ours.ligand.positions.numpy(), np.asarray(ref.ligand.positions),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(ours.ligand.angles.numpy(), np.asarray(ref.ligand.angles),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours.receptor.positions.numpy(), batch_np.receptor.positions)
    tiled = ProtProjection(tb, se3=False)(_t(np.concatenate([x, x])))
    torch.testing.assert_close(tiled.ligand.positions[3:], ours.ligand.positions)


# -- EulerRotPredict ----------------------------------------------------------
def test_euler_rot_predict_and_converter():
    """Flax ``EulerRotPredict(255)`` converted: rtol 1e-4 / atol 1e-5 on a
    batch and with a single t broadcast over it."""
    jm = JEulerRotPredict(255)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)),
                              jnp.zeros((1,), jnp.int32)))
    assert euler_rot_predict_config_from_flax(params) == {"d_model": 255}
    tm = EulerRotPredict(255).eval()
    tm.load_state_dict(euler_rot_predict_params_from_flax(params))
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 3, (6, 3)).astype(np.float32)
    for t in (np.array([0, 1, 10, 100, 500, 999], np.int32), np.array([250], np.int32)):
        ref = jm.apply(params, jnp.asarray(x), jnp.asarray(t))
        with torch.no_grad():
            ours = tm(_t(x), torch.from_numpy(t).long())
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_euler_and_rotation_trees_cannot_be_told_apart():
    """``EulerRotPredict(d)`` and ``RotPredict(d, "skewvec", "resnet")`` have
    one tree shape: each converter maps either; the caller picks the
    model.  A tree of another RotPredict raises in the Euler converter."""
    je = _np_tree(JEulerRotPredict(31).init(jax.random.PRNGKey(0), jnp.zeros((1, 3)),
                                            jnp.zeros((1,), jnp.int32)))
    jr = _np_tree(JRotPredict(31, "skewvec", "resnet").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 3)), jnp.zeros((1,), jnp.int32)))
    assert jax.tree_util.tree_map(np.shape, je) == jax.tree_util.tree_map(np.shape, jr)
    EulerRotPredict(31).load_state_dict(euler_rot_predict_params_from_flax(jr))
    RotPredict(31, "skewvec", "resnet").load_state_dict(rot_predict_params_from_flax(je))
    mlp = _np_tree(JRotPredict(31).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 3)),
                                        jnp.zeros((1,), jnp.int32)))
    with pytest.raises(ValueError, match="EulerRotPredict"):
        euler_rot_predict_params_from_flax(mlp)


# -- fused-QKV attention ------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_fused_encoder_layer(masked):
    """One flax ``TransformerEncoderLayer(fused_qkv=True)`` (its
    ``FusedSelfAttention``: logits scaled after q.k, masked to -1e9)
    against the port's, with and without a key mask: rtol 1e-4 / atol
    1e-5; a masked key changes nothing."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 10, 32)).astype(np.float32)
    valid = np.ones((3, 10), bool)
    valid[1, 7:], valid[2, 3:] = False, False
    mask = valid[:, None, None, :] if masked else None
    jl = jlayers.TransformerEncoderLayer(32, 4, fused_qkv=True)
    params = _np_tree(jl.init(jax.random.PRNGKey(0), jnp.asarray(x), mask=mask))
    shapes = convert._block_shapes("L", 32, 4, fused_qkv=True)
    state = convert._convert("layer", {"L": params["params"]}, shapes,
                             convert._block_mapping("L", "L", fused_qkv=True))
    tl = TransformerEncoderLayer(32, 4, fused_qkv=True).eval()
    tl.load_state_dict({k[2:]: v for k, v in state.items()})
    assert not hasattr(tl, "query")
    ref = jl.apply(params, jnp.asarray(x), mask=mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        ours = tl(_t(x), tmask)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    if masked:
        x2 = x.copy()
        x2[2, 5] += 10.0  # a masked-out key of row 2
        with torch.no_grad():
            again = tl(_t(x2), tmask)
        torch.testing.assert_close(again[2, :3], ours[2, :3])


@pytest.mark.parametrize("flags", [{}, dict(fuse_chains=False), dict(cross_depth=1)],
                         ids=["fused_chains", "two_pass", "cross_depth_1"])
def test_protnet_fused_qkv(batch, flags):
    """``ProtNet(fused_qkv=True)``: the converter reads the fused tree (its
    head count from the cross layers when there are some, else from
    ``heads=``), and the forward equals flax's."""
    batch_np, t = batch
    jm = jprotnet.ProtNet(**SMALL, fused_qkv=True, **flags)
    tree = _np_tree(jm.init(jax.random.PRNGKey(1), batch_np, jnp.asarray(t)))
    heads = None if flags.get("cross_depth") else 2
    if heads is not None:
        with pytest.raises(ValueError, match="heads"):
            protnet_config_from_flax(tree)
    cfg = protnet_config_from_flax(tree, heads=heads)
    assert cfg["fused_qkv"] and cfg["heads"] == 2
    tm = ProtNet(**cfg, fuse_chains=flags.get("fuse_chains", True)).eval()
    tm.load_state_dict(protnet_params_from_flax(tree, heads=heads), strict=True)
    ref = jm.apply(tree, batch_np, jnp.asarray(t))
    with torch.no_grad():
        out = tm(to_device(batch_np, "cpu"), torch.from_numpy(t).long())
    np.testing.assert_allclose(out.rot_g.numpy(), np.asarray(ref.rot_g), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.shift_g.numpy(), np.asarray(ref.shift_g), rtol=RTOL,
                               atol=ATOL)


# -- ProtNet(se3=False) -------------------------------------------------------
@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_protnet_euler_arm_forward(batch, name):
    """The (B, 6) output of ``ProtNet(se3=False)``, whose weights are the
    SE(3) arm's tree: the existing converter loads them."""
    flags = FLAG_SETS[name]
    batch_np, t = batch
    jm = jprotnet.ProtNet(**SMALL, se3=False, **flags)
    tree = _np_tree(jm.init(jax.random.PRNGKey(0), batch_np, jnp.asarray(t)))
    cfg = protnet_config_from_flax(tree)
    tm = ProtNet(**cfg, se3=False, fuse_chains=flags.get("fuse_chains", True)).eval()
    tm.load_state_dict(protnet_params_from_flax(tree), strict=True)
    ref = jm.apply(tree, batch_np, jnp.asarray(t))
    with torch.no_grad():
        out = tm(to_device(batch_np, "cpu"), torch.from_numpy(t).long())
    assert isinstance(out, torch.Tensor) and out.shape == (3, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
