"""The port's viz/, diagnostics and grad_check against the JAX package's, on
the CPU (figures headless through Agg; matplotlib is installed here, not on
the card's machine): the pi formatter, the colours, both sphere figures, the
PLY writer (byte for byte), every diagnostics subcommand at a small size
(``prot-diags`` on the committed ``results/prot_samples_{eul,se3}.json``,
its printed rows equal the JAX command's; ``pdb-path`` on a PDB pair this
test writes, its frames equal the JAX command's), and grad_check (the naive
pull-back's scale and symmetric share, the field's loss and gradient at a
given field, all to 1e-5 of JAX's; the optimisation at 800 iterations).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu import viz as jviz
from diffusion_extensions_tpu.data.shapenet import synthetic_planes as jplanes
from diffusion_extensions_tpu.experiments import diagnostics as jdiag
from diffusion_extensions_tpu.ops import so3 as jso3
from diffusion_extensions_tpu.viz.mpl import multiple_formatter as jformatter
from diffusion_extensions_tpu.viz.obj3d import save_point_cloud_ply as jsave_ply
from diffusion_extensions_tpu_torch import viz
from diffusion_extensions_tpu_torch.experiments import diagnostics, grad_check
from diffusion_extensions_tpu_torch.ops.so3 import exp_skewvec
from diffusion_extensions_tpu_torch.viz.mpl import multiple_formatter
from diffusion_extensions_tpu_torch.viz.obj3d import save_point_cloud_ply
from diffusion_extensions_tpu_torch.viz.sphere import (
    plot_igso3_density_spheres,
    plot_rotation_frames,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- viz -----------------------------------------------------------------
def test_multiple_formatter():
    f = multiple_formatter(denominator=2)
    assert f(0.0, None) == r"$0$"
    assert f(np.pi, None) == r"$\pi$"
    assert f(-np.pi, None) == r"$-\pi$"
    assert f(np.pi / 2, None) == r"$\frac{\pi}{2}$"
    assert f(3 * np.pi / 2, None) == r"$\frac{3\pi}{2}$"
    for den in (2, 4, 3):
        mine, ref = multiple_formatter(den), jformatter(den)
        for x in np.linspace(-3 * np.pi, 3 * np.pi, 37):
            assert mine(x, None) == ref(x, None)


@pytest.mark.parametrize("name", ["BLUE", "ORANGE", "GREEN", "BLACK", "WHITE", "GREY"])
def test_colors(name):
    assert getattr(viz, name) == getattr(jviz, name)
    assert getattr(viz, f"{name}_F") == getattr(jviz, f"{name}_F")
    assert len(getattr(viz, f"{name}_F")) == 3
    np.testing.assert_allclose(viz.BLUE_F, (0x1F / 255, 0x77 / 255, 0xB4 / 255))


def test_sphere_figures(tmp_path):
    rots = exp_skewvec(torch.randn(64, 3, generator=torch.Generator().manual_seed(0)))
    out1 = str(tmp_path / "frames.png")
    plot_rotation_frames(rots, out_path=out1)
    assert os.path.getsize(out1) > 1000
    out2 = str(tmp_path / "dens.png")
    plot_igso3_density_spheres([0.1, 1.0], out_path=out2, count=31)
    assert os.path.getsize(out2) > 1000


@pytest.mark.parametrize("colors", [None, np.array([[0.2, 0.4, 1.0]]), "per_point_uint8"])
def test_ply_writer_matches_jax(tmp_path, colors):
    pts = np.random.default_rng(0).standard_normal((17, 3)).astype(np.float32)
    if isinstance(colors, str):
        colors = np.random.default_rng(1).integers(0, 256, (17, 3)).astype(np.uint8)
    a = save_point_cloud_ply(str(tmp_path / "a" / "c.ply"), pts, colors)
    b = jsave_ply(str(tmp_path / "b" / "c.ply"), pts, colors)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with pytest.raises(ValueError):
        save_point_cloud_ply(str(tmp_path / "x.ply"), pts, np.zeros((4, 3)))


# -- diagnostics -------------------------------------------------------------
def _rows(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.endswith(r"\\")]


def test_sphere_probs(tmp_path):
    out = diagnostics.main(["sphere-probs", "--out-dir", str(tmp_path)])
    assert out == str(tmp_path / "sphere_probs.png") and os.path.getsize(out) > 1000


def test_interp_path_and_figures(tmp_path):
    """The geodesic lock segment equals JAX's (1e-6) and both figures land
    in --out-dir."""
    path = diagnostics.main(["interp", "--device", "cpu", "--out-dir", str(tmp_path)])
    from diffusion_extensions_tpu.data.synthetic import lock_segment_endpoints

    r1, r2 = lock_segment_endpoints()
    ref = np.asarray(jso3.so3_lerp(r1, r2, jnp.linspace(0, 1, 1000)[:, None]))
    np.testing.assert_allclose(path, ref, atol=1e-6)
    assert sorted(os.listdir(tmp_path)) == ["interp_euler_traces.png", "interp_sphere.png"]


def test_se3_path_shapes_and_group(tmp_path):
    rots, shifts = diagnostics.main(["se3-path", "--device", "cpu", "--out-dir", str(tmp_path),
                                     "--samples", "3", "--steps", "8"])
    saved = np.load(str(tmp_path / "se3_paths.npz"))
    assert saved["rots"].shape == (9, 3, 3, 3) and saved["shifts"].shape == (9, 3, 3)
    np.testing.assert_array_equal(saved["rots"], rots)
    np.testing.assert_array_equal(saved["shifts"], shifts)
    assert np.isfinite(shifts).all()
    np.testing.assert_array_equal(rots[0], np.broadcast_to(np.eye(3), (3, 3, 3)))
    np.testing.assert_allclose(rots @ np.swapaxes(rots, -1, -2),
                               np.broadcast_to(np.eye(3), rots.shape), atol=1e-5)


def test_se3_path_distribution_matches_jax(tmp_path):
    """1,000 poses over 10 steps in both packages: the shifts' spread at
    each step within 6% and the final rotation angles' two-sample KS
    distance under 0.07 (different random streams, the same process)."""
    n, steps = 1000, 10
    rots, shifts = diagnostics.main(["se3-path", "--device", "cpu", "--out-dir",
                                     str(tmp_path / "t"), "--samples", str(n), "--steps",
                                     str(steps)])
    jdiag.main(["se3-path", "--out-dir", str(tmp_path / "j"), "--samples", str(n), "--steps",
                str(steps)])
    ref = np.load(str(tmp_path / "j" / "se3_paths.npz"))
    np.testing.assert_allclose(shifts[1:].std(axis=(1, 2)), ref["shifts"][1:].std(axis=(1, 2)),
                               rtol=0.06)

    def angles(r):
        return np.sort(np.arccos(np.clip((np.trace(r, axis1=-2, axis2=-1) - 1) / 2, -1, 1)))

    a, b = angles(rots[-1]), angles(ref["rots"][-1])
    grid = np.linspace(0, np.pi, 200)
    ks = np.abs(np.searchsorted(a, grid) - np.searchsorted(b, grid)).max() / n
    assert ks < 0.07


def test_bingham_render(tmp_path):
    written = diagnostics.main(["bingham-render", "--device", "cpu", "--out-dir",
                                str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["lcr.png", "lur.png", "scr.png", "sur.png"]
    assert all(os.path.getsize(p) > 1000 for p in written)


def test_aircraft_diags_rows_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(2)
    res = tmp_path / "res"
    res.mkdir()
    np.save(str(res / "results_aircraft_eul.npy"), rng.uniform(0, 3, 200))
    np.save(str(res / "results_aircraft_so3.npy"), rng.uniform(0, 0.5, 200))
    diagnostics.main(["aircraft-diags", "--results-dir", str(res), "--out-dir",
                      str(tmp_path / "t")])
    ours = capsys.readouterr().out
    jdiag.main(["aircraft-diags", "--results-dir", str(res), "--out-dir", str(tmp_path / "j")])
    ref = capsys.readouterr().out
    assert len(_rows(ours)) == 4 and _rows(ours) == _rows(ref)
    assert os.listdir(tmp_path / "t") == ["aircraft_diags.png"]


def test_prot_diags_rows_match_jax_on_the_committed_results(tmp_path, capsys):
    res = os.path.join(ROOT, "results")
    diagnostics.main(["prot-diags", "--results-dir", res, "--out-dir", str(tmp_path / "t")])
    ours = capsys.readouterr().out
    jdiag.main(["prot-diags", "--results-dir", res, "--out-dir", str(tmp_path / "j")])
    ref = capsys.readouterr().out
    assert len(_rows(ours)) == 8 and _rows(ours) == _rows(ref)
    assert "eul-angles" in ours and "se3-shifts" in ours
    assert sorted(os.listdir(tmp_path / "t")) == ["prot_diags_angles.png",
                                                  "prot_diags_shifts.png"]


_PDB = (
    "ATOM      1  N   ALA A   1      11.104   6.134  -6.504  1.00  0.00           N\n"
    "ATOM      2  CA  ALA A   1      11.639   6.071  -5.147  1.00  0.00           C\n"
    "ATOM      3  C   ALA A   1      10.674   6.719  -4.163  1.00  0.00           C\n"
    "TER\n"
)


def test_pdb_path_matches_jax(tmp_path):
    """A receptor / ligand pair written here, moved along a 2-sample, 8-step
    se3_paths.npz: the frames and the receptor equal the JAX command's byte
    for byte, the PyMOL script up to its output directory."""
    data = tmp_path / "data"
    data.mkdir()
    for name in ("1abc_receptors.pdb", "1abc_ligand.pdb"):
        (data / name).write_text(_PDB)
    diagnostics.main(["se3-path", "--device", "cpu", "--out-dir", str(tmp_path),
                      "--samples", "2", "--steps", "8"])
    paths = str(tmp_path / "se3_paths.npz")
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    diagnostics.main(["pdb-path", "--se3-paths", paths, "--data-root", str(data),
                      "--out-dir", t_out, "--frames", "3"])
    jdiag.main(["pdb-path", "--se3-paths", paths, "--data-root", str(data),
                "--out-dir", j_out, "--frames", "3"])
    files = sorted(os.listdir(t_out))
    assert files == sorted(os.listdir(j_out))
    assert files == ["1abc_ligand_0000.pdb", "1abc_ligand_0003.pdb", "1abc_ligand_0006.pdb",
                     "1abc_receptors.pdb", "render_path.pml"]
    for f in files:
        with open(os.path.join(t_out, f)) as a, open(os.path.join(j_out, f)) as b:
            mine, ref = a.read(), b.read()
        if f.endswith(".pml"):
            mine, ref = mine.replace(t_out, "OUT"), ref.replace(j_out, "OUT")
        assert mine == ref, f


def test_outputs_default_to_torch_results():
    for cmd in ("sphere-probs", "interp", "se3-path", "bingham-render", "aircraft-diags",
                "prot-diags", "pdb-path"):
        assert diagnostics.parse_args([cmd]).out_dir == "torch_results"
    assert diagnostics.parse_args(["pdb-path"]).se3_paths == "torch_results/se3_paths.npz"
    for cmd in ("se3-path", "interp", "bingham-render"):
        assert diagnostics.parse_args([cmd]).device is None  # the card


# -- grad_check ----------------------------------------------------------
def _jax_problem():
    """grad_check.py's quantities, computed as the JAX script computes them."""
    data = jnp.asarray(jplanes(1, points=512, seed=0))
    rot = jnp.asarray([[[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]]])
    log_rot = jso3.log_rmat(rot)
    rot_grad = jso3.rmul(log_rot, rot)
    skew_targ = jso3.skew2vec(log_rot)

    def project(r):
        return jnp.matmul(data, jnp.swapaxes(r, -1, -2))

    return data, rot, rot_grad, skew_targ, project


def test_grad_check_naive_pullback_matches_jax():
    data, rot, rot_grad, skew_targ, project = _jax_problem()
    _, vjp = jax.vjp(project, rot)
    (r_grad,) = vjp(jnp.matmul(data, jnp.swapaxes(rot_grad, -1, -2)))
    s_v = jso3.rmul(r_grad, jnp.swapaxes(rot, -1, -2))
    skew_part = 0.5 * (s_v - jnp.swapaxes(s_v, -1, -2))
    sym_part = 0.5 * (s_v + jnp.swapaxes(s_v, -1, -2))
    predict = jso3.skew2vec(skew_part)
    scale = float(jnp.vdot(predict, skew_targ)
                  / jnp.maximum(jnp.vdot(skew_targ, skew_targ), 1e-12))
    sym_frac = float(jnp.linalg.norm(sym_part) / jnp.linalg.norm(s_v))
    ours = grad_check.Problem("cpu").naive()
    np.testing.assert_allclose(ours, (scale, sym_frac), rtol=1e-5)


def test_grad_check_field_loss_and_gradient_match_jax():
    """The loss the script optimises and its gradient at a numpy field."""
    data, rot, _, skew_targ, project = _jax_problem()
    proj_data = project(rot)
    field = np.random.default_rng(3).standard_normal((1, 512, 3)).astype(np.float32)

    def loss_fn(pg):
        orth_loss = jnp.mean(jnp.sum(proj_data * pg, axis=-1) ** 2)
        _, vjp = jax.vjp(project, rot)
        (rg,) = vjp(pg)
        sv = jso3.rmul(rg, jnp.swapaxes(rot, -1, -2))
        sv_proj = 0.5 * (sv - jnp.swapaxes(sv, -1, -2))
        sym = 0.5 * (sv + jnp.swapaxes(sv, -1, -2))
        return jnp.mean((jso3.skew2vec(sv_proj) - skew_targ) ** 2) + jnp.mean(sym**2) + orth_loss

    ref_loss, ref_grad = jax.value_and_grad(loss_fn)(jnp.asarray(field))
    pg = torch.from_numpy(field).requires_grad_(True)
    loss = grad_check.Problem("cpu").field_loss(pg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    ref_grad = np.asarray(ref_grad)
    assert float(np.abs(pg.grad.numpy() - ref_grad).max()) <= 1e-5 * float(np.abs(ref_grad).max())


def test_grad_check_fast(tmp_path, capsys):
    """800 iterations at lr 0.05 (the JAX test's): the loss halves, the
    naive pull-back's numbers print as JAX's, the PLY files land in
    --obj3d-dir."""
    res = grad_check.main(["--device", "cpu", "--iters", "800", "--lr", "0.05",
                           "--obj3d-dir", str(tmp_path)])
    assert res["iters"] == 800 and res["loss_last"] < 0.5 * res["loss_first"]
    assert "naive pullback: scale vs target 26.734, symmetric-part fraction 0.634" in \
        capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["grad_field_tips.ply", "projected_cloud.ply"]
    with open(tmp_path / "projected_cloud.ply") as f:
        assert "element vertex 512" in f.read()
