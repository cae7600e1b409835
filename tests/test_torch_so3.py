"""The port's SO(3) geometry against the JAX package's, on the CPU.

Inputs are made with numpy from fixed seeds and go through both.  Both sides
compute in float32 with different elementwise math libraries, so values
agree to a few ulps of the operands: 1e-5 absolute on unit-scale outputs
unless a test says otherwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.ops import so3 as jso3
from diffusion_extensions_tpu_torch.ops import so3 as tso3
from conftest import require_golden

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture(scope="module")
def g():
    return require_golden("so3.npz")


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _rots(seed=0, n=64):
    """Random rotations plus the identity, exact pi rotations about the
    axes and a generic axis, and near-0 / near-pi angles."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    special = [np.eye(3), np.diag([-1.0, -1.0, 1.0]), np.diag([1.0, -1.0, -1.0]),
               np.diag([-1.0, 1.0, -1.0])]
    r = np.asarray(jso3.exp_skewvec(jnp.asarray(v)))
    extra = []
    for ang in (1e-7, 1e-5, np.pi - 1e-3, np.pi):
        axis = np.array([0.3, -0.5, 0.8], np.float32)
        axis /= np.linalg.norm(axis)
        extra.append(np.asarray(jso3.exp_skewvec(jnp.asarray(axis * ang, jnp.float32))))
    return np.concatenate([r, np.asarray(special, np.float32), np.asarray(extra)], 0)


def test_skew_vec_roundtrip(g):
    vecs = g["vecs"]
    np.testing.assert_allclose(tso3.vec2skew(_t(vecs)), jso3.vec2skew(jnp.asarray(vecs)), atol=0)
    np.testing.assert_allclose(tso3.vec2skew(_t(vecs)), g["skews"], atol=TOL)
    np.testing.assert_allclose(tso3.skew2vec(_t(g["skews"])), vecs, atol=TOL)


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 1.0, 3.0])
def test_exp_skewvec_matches_jax(scale):
    v = np.random.default_rng(1).standard_normal((64, 3)).astype(np.float32) * scale
    np.testing.assert_allclose(
        tso3.exp_skewvec(_t(v)), jso3.exp_skewvec(jnp.asarray(v)), atol=TOL
    )


def test_log_and_angle_match_jax_with_0_and_pi():
    r = _rots()
    tv = tso3.log_rmat_vec(_t(r)).numpy()
    jv = np.asarray(jso3.log_rmat_vec(jnp.asarray(r)))
    # at exactly pi the axis sign is immaterial (exp(+pi n) == exp(-pi n))
    np.testing.assert_allclose(np.abs(tv), np.abs(jv), atol=1e-5)
    np.testing.assert_allclose(
        tso3.exp_skewvec(_t(tv)).numpy(), r, atol=1e-5
    )
    np.testing.assert_allclose(
        tso3.rotation_angle(_t(r)), jso3.rotation_angle(jnp.asarray(r)), atol=1e-6
    )


def test_pi_axis_matches_jax():
    r = _rots()
    np.testing.assert_allclose(
        np.abs(tso3._pi_axis(_t(r)).numpy()),
        np.abs(np.asarray(jso3._pi_axis(jnp.asarray(r)))),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        tso3._safe_norm(_t(r[:, 0])), jso3._safe_norm(jnp.asarray(r[:, 0])), atol=1e-6
    )


def test_log_rmat_golden(g):
    rots = _t(g["rots"])
    log = tso3.log_rmat(rots).numpy()
    angle = tso3.rotation_angle(rots).numpy()
    regular = angle < 3.141  # the reference's pi branch reads a wrong axis
    err = np.abs(log - g["log"]).max(axis=(-1, -2))
    assert err[regular].max() < 1e-4, err[regular].max()
    back = tso3.exp_skewvec(tso3.log_rmat_vec(rots)).numpy()
    np.testing.assert_allclose(back, g["rots"], atol=1e-5)
    np.testing.assert_allclose(
        log, np.asarray(jso3.log_rmat(jnp.asarray(g["rots"]))), atol=1e-5
    )


def test_aa_golden_and_parity(g):
    r = tso3.aa_to_rmat(_t(g["axes_aa"]), _t(g["angs_aa"])[..., 0])
    np.testing.assert_allclose(r, g["r_aa"], atol=1e-5)
    ax_t, ang_t = tso3.rmat_to_aa(_t(g["rots"]))
    ax_j, ang_j = jso3.rmat_to_aa(jnp.asarray(g["rots"]))
    np.testing.assert_allclose(ang_t, ang_j, atol=1e-6)
    interior = (np.asarray(ang_j)[..., 0] < 3.1)
    np.testing.assert_allclose(ax_t.numpy()[interior], np.asarray(ax_j)[interior], atol=1e-5)
    # identity -> the x-axis, as the JAX package returns
    ax0, ang0 = tso3.rmat_to_aa(torch.eye(3))
    np.testing.assert_allclose(ax0, [1.0, 0.0, 0.0])
    assert float(ang0) == 0.0


def test_so3_scale_golden_and_parity(g):
    rots, sc = g["rots"], g["scalars"]
    out = tso3.so3_scale(_t(rots), _t(sc)).numpy()
    angle = tso3.rotation_angle(_t(rots)).numpy()
    ref = g["scaled"]
    ok = (~np.isnan(ref).any(axis=(-1, -2))) & (angle < 3.141)
    np.testing.assert_allclose(out[ok], ref[ok], atol=1e-4)
    jout = np.asarray(jso3.so3_scale(jnp.asarray(rots), jnp.asarray(sc)))
    np.testing.assert_allclose(out[angle < 3.141], jout[angle < 3.141], atol=1e-5)


def test_so3_lerp_golden_and_parity(g):
    out = tso3.so3_lerp(_t(g["rots"]), _t(g["rots_b"]), _t(g["weight"])).numpy()
    ref = g["lerped"]
    ok = ~np.isnan(ref).any(axis=(-1, -2))
    np.testing.assert_allclose(out[ok], ref[ok], atol=2e-4)
    jout = np.asarray(jso3.so3_lerp(
        jnp.asarray(g["rots"]), jnp.asarray(g["rots_b"]), jnp.asarray(g["weight"])
    ))
    np.testing.assert_allclose(out, jout, atol=1e-5)


def test_euler_golden_and_parity(g):
    eul = g["eul"]
    r = tso3.euler_to_rmat(_t(eul[:, 0]), _t(eul[:, 1]), _t(eul[:, 2]))
    np.testing.assert_allclose(r, g["r_eul"], atol=1e-5)
    jr = jso3.euler_to_rmat(*(jnp.asarray(eul[:, i]) for i in range(3)))
    np.testing.assert_allclose(r, jr, atol=1e-6)
    # scalar broadcast against a batch
    rb = tso3.euler_to_rmat(_t(eul[:, 0]), torch.tensor(0.3), _t(eul[:, 2]))
    assert rb.shape == (len(eul), 3, 3)


def test_rmul_is_full_float32():
    """TF32 is off package-wide; a product of unit-scale 3x3s is exact to
    float32 rounding."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    r = _rots()
    prod = tso3.rmul(_t(r), _t(r).transpose(-1, -2)).numpy()
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(3), prod.shape), atol=1e-5)


def test_haar_rotations_orthogonal_and_qr_matches_jax():
    """The port draws its own normals; given the same normal matrices, the
    QR factor is the JAX package's (both are LAPACK Householder QR), with
    det = +-1 left as it is."""
    q = tso3.haar_rotations(torch.Generator().manual_seed(0), (256,))
    assert q.shape == (256, 3, 3)
    np.testing.assert_allclose(
        q @ q.transpose(-1, -2), np.broadcast_to(np.eye(3), (256, 3, 3)), atol=1e-5
    )
    det = np.linalg.det(q.numpy())
    np.testing.assert_allclose(np.abs(det), 1.0, atol=1e-5)
    gm = np.random.default_rng(4).standard_normal((32, 3, 3)).astype(np.float32)
    qt, _ = torch.linalg.qr(_t(gm))
    qj, _ = jnp.linalg.qr(jnp.asarray(gm))
    np.testing.assert_allclose(qt, qj, atol=1e-5)


@pytest.mark.parametrize("fn", ["log_rmat_vec", "rotation_angle_sum", "so3_scale"])
def test_grads_nan_free_at_0_and_pi(fn):
    r = _t(_rots()).requires_grad_(True)
    if fn == "log_rmat_vec":
        val = (tso3.log_rmat_vec(r) ** 2).sum()
    elif fn == "rotation_angle_sum":
        val = tso3.rotation_angle(r).sum()
    else:
        val = tso3.so3_scale(r, torch.full((r.shape[0],), 0.5)).sum()
    val.backward()
    assert torch.isfinite(r.grad).all()
    v = torch.zeros(4, 3, requires_grad=True)
    tso3.exp_skewvec(v).sum().backward()
    assert torch.isfinite(v.grad).all()
    # the JAX package's gradient agrees where the reference is regular
    if fn == "log_rmat_vec":
        jg = jax.grad(lambda x: jnp.sum(jso3.log_rmat_vec(x) ** 2))(jnp.asarray(_rots()))
        ang = np.asarray(jso3.rotation_angle(jnp.asarray(_rots())))
        reg = (ang > 1e-3) & (ang < 3.0)
        np.testing.assert_allclose(r.grad.numpy()[reg], np.asarray(jg)[reg], atol=1e-3)
