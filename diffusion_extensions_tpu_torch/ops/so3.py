"""SO(3) geometry core in PyTorch (counterpart of ``diffusion_extensions_tpu/ops/so3.py``).

Shape-polymorphic over leading batch dims, float32, branch-free: every small
angle and pi guard is a ``torch.where`` over sanitised inputs, so autograd
stays NaN-free on both sides of each branch.  ``log_rmat`` computes the
pi-rotation axis unconditionally from (R + I)/2 = n n^T and selects it.
"""
from __future__ import annotations

import torch

__all__ = [
    "rmul",
    "skew2vec",
    "vec2skew",
    "exp_skewvec",
    "log_rmat",
    "log_rmat_vec",
    "rotation_angle",
    "aa_to_rmat",
    "rmat_to_aa",
    "so3_lerp",
    "so3_bezier",
    "so3_scale",
    "rmat2six",
    "six2rmat",
    "quat_to_rmat",
    "euler_to_rmat",
    "rmat_to_euler",
    "orthogonalise",
    "haar_rotations",
    "haar_rotations_proper",
]

_EPS = 1e-8


def rmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation-matrix product (true float32: TF32 is off package-wide)."""
    return torch.matmul(a, b)


def _safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm whose gradient is 0 (not NaN) at the origin."""
    sumsq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    ok = sumsq > 1e-24
    norm = torch.sqrt(torch.where(ok, sumsq, torch.ones_like(sumsq)))
    return torch.where(ok, norm, torch.zeros_like(norm))


def skew2vec(skew: torch.Tensor) -> torch.Tensor:
    return torch.stack((skew[..., 2, 1], -skew[..., 2, 0], skew[..., 1, 0]), dim=-1)


def vec2skew(vec: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(vec[..., 0])
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    row0 = torch.stack((zero, -z, y), dim=-1)
    row1 = torch.stack((z, zero, -x), dim=-1)
    row2 = torch.stack((-y, x, zero), dim=-1)
    return torch.stack((row0, row1, row2), dim=-2)


def _eye_like(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


def exp_skewvec(vec: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map R = exp([v]_x) with Taylor branches at 0."""
    theta_sq = torch.sum(vec * vec, dim=-1)
    small = theta_sq < 1e-8  # theta < 1e-4
    one = torch.ones_like(theta_sq)
    theta_safe = torch.sqrt(torch.where(small, one, theta_sq))
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta_safe) / theta_safe)
    b = torch.where(
        small,
        0.5 - theta_sq / 24.0,
        (1.0 - torch.cos(theta_safe)) / torch.where(small, one, theta_sq),
    )
    k = vec2skew(vec)
    k2 = torch.matmul(k, k)
    return _eye_like(vec) + a[..., None, None] * k + b[..., None, None] * k2


def _pi_axis(r_mat: torch.Tensor) -> torch.Tensor:
    """Rotation axis of R ~= rotation by pi, from (R + I)/2 = n n^T: the
    column with the largest diagonal entry, normalised."""
    sym = 0.5 * (r_mat + r_mat.transpose(-1, -2))
    nnt = 0.5 * (sym + _eye_like(r_mat))
    diag = torch.diagonal(nnt, dim1=-2, dim2=-1)  # (..., 3) = n_i^2
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*k.shape, 3, 1)
    col = torch.gather(nnt, -1, idx)[..., 0]
    norm = _safe_norm(col, keepdim=True)
    return col / torch.clamp(norm, min=_EPS)


def log_rmat(r_mat: torch.Tensor) -> torch.Tensor:
    """Matrix logarithm on SO(3); ``exp_skewvec(log_rmat_vec(R)) == R``
    holds for all inputs, theta == pi included."""
    return vec2skew(log_rmat_vec(r_mat))


def _trace(r_mat: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(r_mat, dim1=-2, dim2=-1).sum(-1)


def log_rmat_vec(r_mat: torch.Tensor) -> torch.Tensor:
    """skew2vec(log_rmat(R)) = theta * axis."""
    skew = r_mat - r_mat.transpose(-1, -2)
    sk_vec = skew2vec(skew)  # = 2 sin(theta) * axis
    s_angle = 0.5 * _safe_norm(sk_vec)
    c_angle = 0.5 * (_trace(r_mat) - 1.0)
    angle = torch.atan2(s_angle, c_angle)

    near_zero = angle < 1e-6
    near_pi = s_angle < 1e-6
    denom = torch.where(near_pi | near_zero, torch.ones_like(s_angle), 2.0 * s_angle)
    scale = torch.where(near_zero, torch.zeros_like(angle), angle / denom)
    v_reg = scale[..., None] * sk_vec

    v_pi = angle[..., None] * _pi_axis(r_mat)

    use_pi = (near_pi & (c_angle < 0.0))[..., None]
    return torch.where(use_pi, v_pi, v_reg)


def rotation_angle(r_mat: torch.Tensor) -> torch.Tensor:
    """Geodesic angle theta in [0, pi] (atan2 form)."""
    skew = r_mat - r_mat.transpose(-1, -2)
    s_angle = 0.5 * _safe_norm(skew2vec(skew))
    c_angle = 0.5 * (_trace(r_mat) - 1.0)
    return torch.atan2(s_angle, c_angle)


def aa_to_rmat(rot_axis: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> rotation; ``ang`` broadcasts against ``rot_axis[..., 0]``."""
    norm = _safe_norm(rot_axis, keepdim=True)
    axis = rot_axis / torch.clamp(norm, min=_EPS)
    return exp_skewvec(axis * ang[..., None])


def rmat_to_aa(r_mat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotation -> (axis, angle (..., 1)); the x-axis at the identity."""
    v = log_rmat_vec(r_mat)
    angle = _safe_norm(v, keepdim=True)
    axis = v / torch.clamp(angle, min=_EPS)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    axis = torch.where(angle < _EPS, x_axis, axis)
    return axis, angle


def so3_lerp(rot_a: torch.Tensor, rot_b: torch.Tensor, weight) -> torch.Tensor:
    """Geodesic interpolation; batched ``weight`` carries a trailing
    singleton dim (it multiplies the (..., 1) angle)."""
    rot_c = rmul(rot_a.transpose(-1, -2), rot_b)
    axis, angle = rmat_to_aa(rot_c)
    i_angle = weight * angle
    return rmul(rot_a, aa_to_rmat(axis, i_angle[..., 0]))


def so3_bezier(rots, weight) -> torch.Tensor:
    """Recursive de Casteljau on SO(3) over the control rotations ``rots``
    (a sequence, at least two), ``weight`` as ``so3_lerp`` takes it."""
    if len(rots) == 2:
        return so3_lerp(rots[0], rots[1], weight)
    return so3_lerp(so3_bezier(rots[:-1], weight), so3_bezier(rots[1:], weight), weight)


def so3_scale(rmat: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Fractional rotation power exp(s * log R)."""
    return exp_skewvec(log_rmat_vec(rmat) * scalars[..., None])


def rmat2six(x: torch.Tensor) -> torch.Tensor:
    """First two rows flattened: the 6D rotation representation."""
    return x[..., :2, :].reshape(*x.shape[:-2], 6)


def six2rmat(x: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt reconstruction from the 6D representation (rows b1, b2,
    b1 x b2)."""
    a1, a2 = x[..., :3], x[..., 3:6]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=_EPS)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.clamp(torch.linalg.norm(b2, dim=-1, keepdim=True), min=_EPS)
    return torch.stack((b1, b2, torch.linalg.cross(b1, b2, dim=-1)), dim=-2)


def quat_to_rmat(quaternions: torch.Tensor) -> torch.Tensor:
    """Real-first quaternion (r, i, j, k) -> rotation matrix; the input
    need not be unit (it is divided by its squared norm)."""
    r, i, j, k = (quaternions[..., n] for n in range(4))
    two_s = 2.0 / torch.sum(quaternions * quaternions, dim=-1)
    o = torch.stack(
        (
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ),
        dim=-1,
    )
    return o.reshape(*quaternions.shape[:-1], 3, 3)


def euler_to_rmat(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """XYZ Euler composition R = Rz @ Ry @ Rx, with the JAX package's (and
    its reference's) convention R_y[2, 0] = +sin(y)."""
    x, y, z = torch.broadcast_tensors(x, y, z)
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    ryx_00 = cy
    ryx_01 = -sy * sx
    ryx_02 = -sy * cx
    ryx_10 = torch.zeros_like(cy)
    ryx_11 = cx
    ryx_12 = -sx
    o = torch.stack(
        (
            cz * ryx_00 - sz * ryx_10,
            cz * ryx_01 - sz * ryx_11,
            cz * ryx_02 - sz * ryx_12,
            sz * ryx_00 + cz * ryx_10,
            sz * ryx_01 + cz * ryx_11,
            sz * ryx_02 + cz * ryx_12,
            sy,
            cy * sx,
            cy * cx,
        ),
        dim=-1,
    )
    return o.reshape(*x.shape, 3, 3)


def rmat_to_euler(rmat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """XYZ Euler decomposition (x, y, z), the inverse of ``euler_to_rmat``
    for |y| < pi/2.  At |y| = pi/2 (gimbal lock) sy = 0 and x and z are
    each ill-defined; only the rotation they compose back to is."""
    sy = torch.sqrt(rmat[..., 0, 0] * rmat[..., 0, 0] + rmat[..., 1, 0] * rmat[..., 1, 0])
    x = torch.atan2(rmat[..., 2, 1], rmat[..., 2, 2])
    y = torch.atan2(rmat[..., 2, 0], sy)
    z = torch.atan2(rmat[..., 1, 0], rmat[..., 0, 0])
    return x, y, z


def orthogonalise(mat: torch.Tensor) -> torch.Tensor:
    """SVD re-orthogonalisation of the leading 3x3 block with the singular
    values rounded to integers (so a near-rotation maps to U V^T); columns
    past the third are kept."""
    u, s, vh = torch.linalg.svd(mat[..., :3, :3], full_matrices=False)
    core = u @ (torch.round(s)[..., :, None] * vh)
    if mat.shape[-1] == 3:
        return core
    out = mat.clone()
    out[..., :3, :3] = core
    return out


def haar_rotations(
    generator: torch.Generator | None, shape=(), device=None
) -> torch.Tensor:
    """Haar-uniform random orthogonal matrices via QR of an iid normal
    matrix.  Like the JAX package (and its reference) the raw Q has
    det = +-1; it is not sign-fixed, for parity.  The draw lands on the
    generator's device unless ``device`` says otherwise."""
    if device is None and generator is not None:
        device = generator.device
    g = torch.randn(
        (*shape, 3, 3), generator=generator, device=device, dtype=torch.float32
    )
    q, _ = torch.linalg.qr(g)
    return q


def haar_rotations_proper(
    generator: torch.Generator | None, shape=(), device=None
) -> torch.Tensor:
    """Haar-uniform rotations with det = +1: QR of an iid normal matrix,
    Q's columns signed by R's diagonal, then the first column by det Q."""
    if device is None and generator is not None:
        device = generator.device
    g = torch.randn(
        (*shape, 3, 3), generator=generator, device=device, dtype=torch.float32
    )
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]
    det = torch.linalg.det(q)
    return torch.cat((q[..., :, :1] * det[..., None, None], q[..., :, 1:]), dim=-1)
