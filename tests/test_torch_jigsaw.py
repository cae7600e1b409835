"""The port's jigsaw suite against the JAX package's, on the CPU: the puzzle
draw (positions and x_0, bit for bit), the renderer and ``draw_true``
(pixel for pixel, the port's NCHW images against JAX's NHWC ones permuted),
the CoordConv converter and parameter count, the forward at size 128 (1e-4
of the output's scale), the l2 loss and every weight gradient with JAX's t
and noise, the projected ancestral chain (each step from JAX's state, and
the free chain from JAX's x_init and noise), the jigsaw driver end to end
(``train()``, exact resume, ``--test`` writing only to ``--out-dir``), and
the committed ``results/jigsaw_samples.npy`` scored by the port's puzzle.

Seven 2x2 pools need the full size 128, so these tests shrink the batch,
never the image.
"""
import hashlib
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.data.jigsaw import JigsawPuzzle as JPuzzle
from diffusion_extensions_tpu.experiments import jigsaw as jjigsaw
from diffusion_extensions_tpu.models.coordconv import CoordConv as JCoordConv
from diffusion_extensions_tpu.processes.r3 import ProjectedGaussianDiffusion as JProjGauss
from diffusion_extensions_tpu_torch.convert import coordconv_params_from_flax
from diffusion_extensions_tpu_torch.data.jigsaw import JigsawPuzzle, puzzle_rows, render_jigsaw
from diffusion_extensions_tpu_torch.experiments import jigsaw
from diffusion_extensions_tpu_torch.models.coordconv import CoordConv
from diffusion_extensions_tpu_torch.processes.r3 import ProjectedGaussianDiffusion
from diffusion_extensions_tpu_torch.train.state import checkpoint_path, latest_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, B, T = 128, 2, 20
FWD_TOL, STEP_TOL, CHAIN_TOL = 1e-4, 1e-4, 1e-3
N_PARAMS = 145_378


def tree_hashes(*dirs) -> dict:
    """sha256 of every file under the repository's ``dirs``."""
    out = {}
    for d in dirs:
        for base, _, files in os.walk(os.path.join(ROOT, d)):
            for f in files:
                path = os.path.join(base, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, ROOT)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _nchw(imgs) -> np.ndarray:
    return np.moveaxis(np.asarray(imgs), -1, -3)


# -- the puzzle and its renderer ----------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 1234, 1_000_003 * 7 + 11])
def test_puzzle_draw_matches_jax(seed):
    ours, ref = JigsawPuzzle(seed=seed), JPuzzle(seed=seed)
    np.testing.assert_array_equal(ours.square_pos, ref.square_pos)
    np.testing.assert_array_equal(ours.circle_pos, ref.circle_pos)
    assert ours.x_0.dtype == np.float32
    np.testing.assert_array_equal(ours.x_0, np.asarray(ref.x_0))


def test_puzzle_rows_are_the_puzzles():
    seeds = range(40, 45)
    rows = puzzle_rows(seeds)
    for row, seed in zip(rows, seeds):
        jp = JPuzzle(seed=seed)
        np.testing.assert_array_equal(row, np.concatenate(
            (jp.square_pos, jp.circle_pos, np.asarray(jp.x_0))).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_render_matches_jax(seed):
    """Free float states (up to 4 standard deviations, some off the image)
    and the integer pixel positions of the base image: every pixel equal.
    The circles' edges are ``hypot <= 16``; a pixel exactly on an edge could
    flip between two math libraries, but none does here (0 allowed)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((48, 2)) * 1.5).astype(np.float32)
    ours, ref = JigsawPuzzle(seed=seed), JPuzzle(seed=seed)
    ints = ((np.stack([ref.square_pos, ref.circle_pos]) - SIZE / 2) * 8.0 / SIZE)
    x = np.concatenate((x, ints.astype(np.float32), [[4.5, -4.5]]), 0).astype(np.float32)
    got = ours(torch.from_numpy(x)).numpy()
    want = _nchw(ref(jnp.asarray(x)))
    assert got.shape == (51, 3, SIZE, SIZE)
    assert int((got != want).any(1).sum()) == 0
    # batched shapes keep their leading dims, each image its solo render
    grid = ours(torch.from_numpy(x[:6].reshape(2, 3, 2)))
    assert grid.shape == (2, 3, 3, SIZE, SIZE)
    np.testing.assert_array_equal(grid[1, 2].numpy(), got[5])


def test_render_first_spatial_axis_is_x():
    """The circle moved along the state's first coordinate moves along the
    image's first spatial axis, as in JAX (``gx`` is ``[:, None]``)."""
    img = render_jigsaw(torch.tensor([[2.0, 0.0]]), torch.tensor([-100.0, -100.0]),
                        torch.tensor([-1e6, -1e6]))[0]
    blue = (img[2] == 1) & (img[0] == 0)
    xs, ys = torch.nonzero(blue, as_tuple=True)
    assert float(xs.float().mean()) == pytest.approx(SIZE * 2 / 8 + SIZE / 2)
    assert float(ys.float().mean()) == pytest.approx(SIZE / 2)


@pytest.mark.parametrize("seed", [0, 5])
def test_draw_true_matches_jax(seed):
    got = JigsawPuzzle(seed=seed).draw_true("cpu").numpy()
    np.testing.assert_array_equal(got, _nchw(JPuzzle(seed=seed).draw_true()))


def test_render_takes_positions_as_tensors_of_a_batch_row():
    """The train step's projection: square and circle as slices of a
    device row, the same images as the puzzle's own call."""
    jp = JigsawPuzzle(seed=9)
    row = torch.from_numpy(puzzle_rows([9])[0])
    x = torch.randn(5, 2, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(render_jigsaw(x, row[0:2], row[2:4]).numpy(), jp(x).numpy())


# -- CoordConv -------------------------------------------------------------
@pytest.fixture(scope="module")
def flax_model():
    model = JCoordConv(size=SIZE)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3)),
                        jnp.zeros((1,), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(params_np) -> CoordConv:
    model = CoordConv(size=SIZE)
    model.load_state_dict(coordconv_params_from_flax(params_np))
    return model


def test_converter_names_shapes_and_count(flax_model):
    _, params = flax_model
    sd = coordconv_params_from_flax(params)
    model = CoordConv(size=SIZE)
    assert set(sd) == set(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS
    assert sum(v.size for v in jax.tree_util.tree_leaves(params)) == N_PARAMS
    np.testing.assert_array_equal(sd["convs.0.weight"].numpy(),
                                  params["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["params"]["Conv_3"]["kernel"] = np.zeros((3, 3, 32, 31), np.float32)
    with pytest.raises(ValueError, match="mis-shaped"):
        coordconv_params_from_flax(bad)
    del bad["params"]["Conv_16"]
    with pytest.raises(ValueError, match="missing"):
        coordconv_params_from_flax(bad)


def test_seeded_init_matches_flax_distribution(flax_model):
    """Each conv starts as flax's does: zero bias and a truncated normal of
    std sqrt(1 / (9 Cin)), cut at two of its standard deviations."""
    torch.manual_seed(0)
    model = CoordConv(size=SIZE)
    _, params = flax_model
    for i, conv in enumerate(model.convs):
        w, ref = conv.weight.detach().numpy(), params["params"][f"Conv_{i}"]["kernel"]
        assert not conv.bias.detach().any()
        std = np.sqrt(1.0 / (9 * w.shape[1]))
        for a in (w, ref):
            assert abs(a.std() / std - 1.0) < 0.25 and np.abs(a).max() <= 2.0 * std / 0.8796 + 1e-6


def test_forward_matches_flax(flax_model):
    """Size 128, batch 2, a random image and two timesteps: 1e-4 of the
    output's scale."""
    model, params = flax_model
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    t = np.array([3, 777], np.int32)
    ref = np.asarray(model.apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    assert got.shape == (B, 2)
    assert float(np.abs(got.numpy() - ref).max()) <= FWD_TOL * float(np.abs(ref).max())


def test_loss_and_weight_gradients_match_jax(flax_model):
    """The l2 loss of a puzzle's solution through the renderer, with JAX's
    t and noise (``loss``'s split of one key): rtol 1e-4.  Every weight's
    gradient against ``jax.grad``: 1e-5 of the leaf's scale from the third
    stage on; 5e-4 in the six convs at 128 and 64 pixels, whose gradients
    sum 2 x 16,384 (4,096) float32 products with cancellation.  There the
    float64 gradient of the same loss (the port in float64) puts the port's
    float32 within 2e-4 (measured 8.4e-5) and JAX's within 7.5e-5 (2.1e-4
    under ``jit``): the difference is float32's, not the port's."""
    model, params = flax_model
    jp, ours_jp = JPuzzle(seed=11), JigsawPuzzle(seed=11)
    jproc = JProjGauss(T, loss_type="l2")
    key = jax.random.PRNGKey(5)
    x0 = jnp.broadcast_to(jp.x_0, (B, 2))

    def jloss(p):
        return jproc.loss(lambda img, t: model.apply(p, img, t), key, x0, projection=jp)

    ref_loss, ref_grads = jax.value_and_grad(jloss)(params)
    k_t, k_n = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(k_t, (B,), 0, T))).long()
    noise = torch.from_numpy(np.array(jax.random.normal(k_n, (B, 2))))
    row = torch.from_numpy(puzzle_rows([11])[0])
    want = coordconv_params_from_flax(jax.tree_util.tree_map(np.asarray, ref_grads))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        net = _port(params).to(dtype)
        proc = ProjectedGaussianDiffusion(T, loss_type="l2", device="cpu")
        loss = jigsaw.make_loss_fn(net, proc, B, SIZE)(
            None, (row.to(dtype), t, noise.to(dtype)))
        loss.backward()
        grads[dtype] = {n: p.grad.double() for n, p in net.named_parameters()}
        if dtype == torch.float32:
            np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-4)
            # the puzzle given as a row and as the puzzle's own call agree
            same = proc.loss(net, None, torch.from_numpy(ours_jp.x_0).expand(B, 2),
                             projection=ours_jp, t=t, noise=noise)
            assert float(same) == float(loss.detach())
    for name, g in grads[torch.float32].items():
        scale = float(want[name].abs().max())
        tol = 5e-4 if int(name.split(".")[1]) < 6 else 1e-5
        assert float((g - want[name].double()).abs().max()) <= tol * scale, name
        exact = grads[torch.float64][name]
        assert float((g - exact).abs().max()) <= 2e-4 * float(exact.abs().max()), name


def _jax_chain_draws(seed, shape):
    """JAX p_sample_loop's x_init and step noises (split for the init,
    fold_in(key, i) at timestep i); noise[j] belongs to t = T - 1 - j."""
    key, init_key = jax.random.split(jax.random.PRNGKey(seed))
    x0 = np.asarray(jax.random.normal(init_key, shape))
    keys = [jax.random.fold_in(key, i) for i in range(T - 1, -1, -1)]
    noise = np.stack([np.asarray(jax.random.normal(k, shape)) for k in keys])
    return x0, keys, noise


def test_projected_chain_matches_jax_step_by_step(flax_model):
    """T = 20 over batch 2 on a puzzle: each ancestral step of the port from
    JAX's state with JAX's noise (1e-4 of 1 + the state's largest entry),
    and the free chain from JAX's x_init and noise (1e-3)."""
    model, params = flax_model
    jp, ours_jp = JPuzzle(seed=4), JigsawPuzzle(seed=4)
    jproc = JProjGauss(T, loss_type="l2")
    proc = ProjectedGaussianDiffusion(T, loss_type="l2", device="cpu")
    net = _port(params).eval()
    apply = jax.jit(model.apply)

    def jden(img, t):
        return apply(params, img, t)

    x0, keys, noise = _jax_chain_draws(7, (B, 2))
    x, step_err = jnp.asarray(x0), 0.0
    with torch.no_grad():
        for j, i in enumerate(range(T - 1, -1, -1)):
            t = jnp.full((B,), i, jnp.int32)
            nxt = jproc.p_sample(jden, keys[j], x, t, projection=jp)
            got = proc.p_sample(net, None, torch.from_numpy(np.array(x)),
                                torch.full((B,), i), projection=ours_jp,
                                noise=torch.from_numpy(noise[j]))
            ref = np.asarray(nxt)
            step_err = max(step_err, float(np.abs(got.numpy() - ref).max())
                           / (1.0 + float(np.abs(ref).max())))
            x = nxt
        free = proc.p_sample_loop(net, None, (B, 2), projection=ours_jp,
                                  x_init=torch.from_numpy(x0), noise=torch.from_numpy(noise))
    assert step_err < STEP_TOL
    ref = np.asarray(jproc.p_sample_loop(jden, jax.random.PRNGKey(7), (B, 2), projection=jp))
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-6, atol=1e-6)
    err = float(np.abs(free.numpy() - ref).max()) / (1.0 + float(np.abs(ref).max()))
    assert err < CHAIN_TOL


# -- the jigsaw driver -------------------------------------------------------
@pytest.fixture()
def small(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return ["--device", "cpu", "--timesteps", "10", "--batch", "4"]


def test_driver_end_to_end(small, tmp_path, capsys):
    """``train()`` 3 steps at batch 4 and T = 10, then ``--test`` (and
    ``--plot``) on the checkpoint: the samples, the record and the figure
    land in ``--out-dir``, nothing else is written, and the repository's
    results/ and images/ keep their bytes."""
    before = tree_hashes("results", "images")
    ck, log, out = str(tmp_path / "ck"), str(tmp_path / "log.jsonl"), str(tmp_path / "out")
    state = jigsaw.main(small + ["--steps", "3", "--ckpt", ck, "--log", log,
                                 "--print-every", "1", "--ckpt-every", "2"])
    assert state.step == 3 and latest_step(ck) == 3
    with open(log) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 3] and all(np.isfinite(r["loss"]) for r in rows)
    rec = jigsaw.main(small + ["--test", "--eval-batch", "6", "--ckpt", ck, "--out-dir", out,
                               "--plot"])
    text = capsys.readouterr().out
    assert "untrained" not in text and "final circle-position error" in text
    assert rec["count"] == 6 and rec["model_evals"] == 10 and rec["finite"]
    assert set(rec["px"]) == {"median", "mean", "p90"} and 0 <= rec["diverged"] <= 6
    assert sorted(os.listdir(out)) == ["torch_jigsaw.json", "torch_jigsaw_frames.png",
                                       "torch_jigsaw_samples.npy"]
    samples = np.load(os.path.join(out, "torch_jigsaw_samples.npy"))
    assert samples.shape == (6, 2)
    with open(os.path.join(out, "torch_jigsaw.json")) as f:
        assert json.load(f)["px"] == rec["px"]
    err = jigsaw.placement_px(samples, JigsawPuzzle(seed=1234).x_0, SIZE)
    assert float(np.median(err)) == pytest.approx(rec["px"]["median"])
    assert sorted(os.listdir(tmp_path)) == ["ck", "log.jsonl", "out"]
    assert tree_hashes("results", "images") == before


def test_exact_resume(small, tmp_path):
    """4 steps against 2 + save + restore + 2: the same weights, Adam
    moments, step and generator, to the bit (each step's fresh puzzle is
    drawn from its step index, so the resumed run sees the same ones)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    base = small[:-1] + ["2", "--print-every", "100"]
    jigsaw.main(base + ["--steps", "4", "--ckpt", a])
    jigsaw.main(base + ["--steps", "2", "--ckpt", b])
    jigsaw.main(base + ["--steps", "4", "--ckpt", b, "--resume"])
    ra, rb = (torch.load(checkpoint_path(d, 4), weights_only=True) for d in (a, b))
    assert ra["step"] == rb["step"] == 4
    for k, v in ra["params"].items():
        assert torch.equal(v, rb["params"][k]), k
    for part in ("mu", "nu"):
        for k, v in ra["opt_state"][part].items():
            assert torch.equal(v, rb["opt_state"][part][k]), (part, k)
    assert torch.equal(ra["generator_state"], rb["generator_state"])


def test_the_driver_defaults_to_the_card(small):
    """Without ``--device`` the jigsaw driver runs on CUDA; with no card here it
    fails instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        jigsaw.main(["--steps", "1", "--timesteps", "10", "--batch", "2"])


def test_committed_jax_samples_score_with_the_port_s_puzzle():
    """The JAX driver's 64 samples after 15k steps (results/jigsaw_samples.npy),
    scored against the port's puzzle of seed 1234 (JAX's --test puzzle):
    median 0.7906 px, 13 chains off the image."""
    samples = np.load(os.path.join(ROOT, "results", "jigsaw_samples.npy"))
    err = jigsaw.placement_px(samples, JigsawPuzzle(seed=1234).x_0, SIZE)
    assert samples.shape == (64, 2)
    assert float(np.median(err)) == pytest.approx(0.7906, abs=1e-4)
    assert int((err > jigsaw.DIVERGED_PX).sum()) == 13


JAX_FLAGS = ["batch", "lr", "steps", "size", "timesteps", "seed", "ckpt", "ckpt_every",
             "print_every", "log", "resume", "debug_nans", "test", "eval_batch", "plot"]


@pytest.mark.parametrize("name", JAX_FLAGS)
def test_parser_option_matches_the_jax_driver(name):
    ref, ours = vars(jjigsaw.parse_args([])), vars(jigsaw.parse_args([]))
    assert set(ref) == set(JAX_FLAGS)
    assert set(ours) == set(JAX_FLAGS) | {"out_dir", "device"}
    assert ours[name] == ref[name]
