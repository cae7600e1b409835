"""The port's SE(3) containers, ``move_prot_batch`` and ``ProtProjection``
against the JAX package's, on the CPU, from the same numpy inputs (rtol
1e-6).  ``ProtProjection`` is also held on k x B transforms (the Picard
sampler's sweep-major rows), which the JAX projection does not take."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.data.pdb import pad_prot_batch as j_pad
from diffusion_extensions_tpu.data.pdb import synthetic_prot_pair as j_pair
from diffusion_extensions_tpu.models.projections import ProtProjection as JProtProjection
from diffusion_extensions_tpu.models.projections import move_prot_batch as j_move
from diffusion_extensions_tpu.ops import se3 as jse3
from diffusion_extensions_tpu.ops.so3 import exp_skewvec as j_exp
from diffusion_extensions_tpu_torch.data.pdb import to_device
from diffusion_extensions_tpu_torch.models.projections import (
    ProtBatch,
    ProtProjection,
    move_prot_batch,
)
from diffusion_extensions_tpu_torch.ops.se3 import AffineGrad, AffineT, ProtData, se3_lerp, se3_scale

B = 3
RTOL = 1e-6


def _rots(n, seed, scale=1.0):
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32) * scale
    return np.array(j_exp(jnp.asarray(v)))


def _shifts(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32) * 10


def _pair(n, seed):
    return (AffineT(torch.from_numpy(_rots(n, seed)), torch.from_numpy(_shifts(n, seed + 1))),
            jse3.AffineT(jnp.asarray(_rots(n, seed)), jnp.asarray(_shifts(n, seed + 1))))


def _close(ours, ref, atol=1e-6):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=RTOL, atol=atol)


def test_affine_containers():
    (a, ja), (b, jb) = _pair(B, 0), _pair(B, 5)
    assert len(a) == B and a.shape == (B, 3) and a.dtype == torch.float32
    one = a[1]
    assert one.rot.shape == (3, 3) and one.shift.shape == (3,)
    c, jc = a.compose(b), ja.compose(jb)
    _close(c.rot, jc.rot)
    _close(c.shift, jc.shift, atol=1e-5)  # shifts of size ~30
    ident = AffineT.identity((B,))
    _close(ident.rot, jse3.AffineT.identity((B,)).rot)
    _close(ident.compose(a).rot, a.rot)
    np.testing.assert_array_equal(ident.compose(a).shift, a.shift)
    g = AffineGrad(torch.zeros(B, 3), torch.ones(B, 3))
    assert len(g) == B and g[0].shift_g.shape == (3,)
    assert ProtData._fields == ("residues", "positions", "angles")


@pytest.mark.parametrize("weight", [0.0, 0.3, 0.9])
def test_se3_scale_and_lerp(weight):
    (a, ja), (b, jb) = _pair(B, 0), _pair(B, 5)
    s = np.array([weight, 0.5, 1.7], np.float32)
    ours, ref = se3_scale(a, torch.from_numpy(s)), jse3.se3_scale(ja, jnp.asarray(s))
    _close(ours.rot, ref.rot, atol=2e-6)
    _close(ours.shift, ref.shift)
    w = np.full((B, 1), weight, np.float32)
    ours, ref = se3_lerp(a, b, torch.from_numpy(w)), jse3.se3_lerp(ja, jb, jnp.asarray(w))
    _close(ours.rot, ref.rot, atol=2e-6)
    _close(ours.shift, ref.shift, atol=1e-5)


def _batch(seed=0, b=B):
    """Ragged pairs padded to one shape: (numpy ProtBatch, port ProtBatch)."""
    rng = np.random.default_rng(seed)
    pairs = [j_pair(rng, 10 + i, 5 + 2 * i) for i in range(b)]
    jb = j_pad(pairs, receptor_len=14, ligand_len=11)
    return jb, to_device(jb, "cpu")


def test_move_prot_batch():
    """About each ligand's masked centroid; padded rows move with the rest
    (their content is masked downstream)."""
    jb, tb = _batch()
    (tr, jr) = _pair(B, 9)
    ours = move_prot_batch(tr, tb.ligand, tb.ligand_mask)
    ref = j_move(jr, jse3.ProtData(*map(jnp.asarray, jb.ligand)), jnp.asarray(jb.ligand_mask))
    np.testing.assert_array_equal(ours.residues, jb.ligand.residues)
    _close(ours.positions, ref.positions, atol=2e-5)  # positions ~30 A
    _close(ours.angles, ref.angles)


def test_prot_projection_moves_the_ligand_only():
    jb, tb = _batch()
    tr, jr = _pair(B, 11)
    ours, ref = ProtProjection(tb)(tr), JProtProjection(jb)(jr)
    assert isinstance(ours, ProtBatch)
    for a, b in zip(ours.receptor, jb.receptor):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.receptor_mask, jb.receptor_mask)
    _close(ours.ligand.positions, ref.ligand.positions, atol=2e-5)
    _close(ours.ligand.angles, ref.ligand.angles)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_prot_projection_tiles_the_batch_for_k_b_transforms(k):
    """k x B transforms, row s * B + j: protein j moved by transform s * B +
    j, equal to the JAX projection of each block of B on its own."""
    jb, tb = _batch()
    tr, jr = _pair(k * B, 13)
    ours = ProtProjection(tb)(tr)
    assert ours.ligand.positions.shape == (k * B, 11, 3)
    assert ours.receptor_mask.shape == (k * B, 14)
    for s in range(k):
        rows = slice(s * B, (s + 1) * B)
        ref = JProtProjection(jb)(jse3.AffineT(jr.rot[rows], jr.shift[rows]))
        _close(ours.ligand.positions[rows], ref.ligand.positions, atol=2e-5)
        _close(ours.ligand.angles[rows], ref.ligand.angles)
        np.testing.assert_array_equal(ours.receptor.positions[rows], jb.receptor.positions)
        np.testing.assert_array_equal(ours.ligand_mask[rows], jb.ligand_mask)
    with pytest.raises(ValueError, match="7 transforms"):
        ProtProjection(tb)(_pair(7, 1)[0])

