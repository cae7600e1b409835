"""The port's gimbal-lock driver against the JAX package's, on the CPU: the
segment (endpoints, samples from JAX's uniforms, the distribution of the
port's own draws, the Euler arm's batches), a 10-step train trajectory of
each arm against the JAX driver's step (``skip_nonfinite`` on both sides),
parity on the committed checkpoint ``sweeps/lock_r3/batch32_lr0.0003/ckpt``
(its newest step, 5000, restored by the JAX package's ``restore_checkpoint``
in this process and converted), and the driver end to end with the
committed ``results/``, ``images/`` and ``sweeps/`` untouched."""
import hashlib
import json
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import Mesh
from scipy import stats

from diffusion_extensions_tpu.data import synthetic as jsynthetic
from diffusion_extensions_tpu.experiments import lock as jlock
from diffusion_extensions_tpu.ops.so3 import haar_rotations as j_haar
from diffusion_extensions_tpu.parallel.dp import make_dp_train_step as j_make_step
from diffusion_extensions_tpu.train.state import TrainState as JTrainState
from diffusion_extensions_tpu.train.state import restore_checkpoint as j_restore
from diffusion_extensions_tpu_torch.convert import (
    euler_rot_predict_params_from_flax,
    rot_predict_config_from_flax,
    rot_predict_params_from_flax,
)
from diffusion_extensions_tpu_torch.data.synthetic import lock_segment_endpoints, sample_lock_batch
from diffusion_extensions_tpu_torch.experiments import lock
from diffusion_extensions_tpu_torch.ops.so3 import rmat_to_aa, rmat_to_euler, so3_lerp
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
from diffusion_extensions_tpu_torch.train.optim import make_optimizer
from diffusion_extensions_tpu_torch.train.state import TrainState, latest_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "sweeps", "lock_r3", "batch32_lr0.0003", "ckpt")
T, B, LR, STEPS = 100, 8, 1e-3, 10


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


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


def test_segment_endpoints_and_samples_from_jax_uniforms():
    """R(0, pi/3, 0) and R(0, 2 pi/3, 0) equal JAX's; so3_lerp of JAX's
    uniforms equals JAX's batch within 1e-6."""
    for ours, ref in zip(lock_segment_endpoints(), jsynthetic.lock_segment_endpoints()):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-7)
    key = jax.random.PRNGKey(0)
    u = _t(jax.random.uniform(key, (64, 1)))
    r1, r2 = lock_segment_endpoints()
    np.testing.assert_allclose(so3_lerp(r1, r2, u).numpy(),
                               np.asarray(jsynthetic.sample_lock_batch(key, 64)), atol=1e-6)


def test_segment_samples_by_distribution():
    """4096 of the port's draws: rotations about y (|axis . y| = 1 within
    1e-5) with angles uniform on [pi/3, 2 pi/3] (Kolmogorov-Smirnov p >
    0.01), half of them past the gimbal lock."""
    rots = sample_lock_batch(torch.Generator().manual_seed(0), 4096)
    axis, angle = rmat_to_aa(rots)
    assert float((axis[:, 1].abs() - 1).abs().max()) < 1e-5
    a = angle[:, 0].numpy()
    assert stats.kstest((a - math.pi / 3) / (math.pi / 3), "uniform").pvalue > 0.01
    assert abs(float((a > math.pi / 2).mean()) - 0.5) < 0.03


def test_euler_batches_are_the_decomposed_segment():
    """The Euler arm's batch: rmat_to_euler of the rotations, as the JAX
    driver's jitted sampler gives it (1e-5 where |y| < pi/2 - 1e-3; the
    decomposition's x and z are ill-defined at the lock)."""
    key = jax.random.PRNGKey(1)
    ref = np.asarray(jlock._make_batch_fn(jlock.parse_args(["--param", "euler", "--batch",
                                                            "256"]))(key))
    rots = _t(jsynthetic.sample_lock_batch(key, 256))
    ours = torch.stack(rmat_to_euler(rots), -1).numpy()
    keep = np.abs(ref[:, 1]) < math.pi / 2 - 1e-3
    assert keep.mean() > 0.9
    np.testing.assert_allclose(ours[keep], ref[keep], atol=1e-5)
    gen = torch.Generator().manual_seed(2)
    drawn = lock.lock_batch(gen, 16, "euler")
    assert drawn.shape == (16, 3) and float(drawn[:, 1].abs().max()) <= math.pi / 2 + 1e-6


def _step_randomness(jproc, state_key, step: int, param: str):
    key = jax.random.fold_in(state_key, step)
    step_key, _ = jax.random.split(key)
    k_t, k_n = jax.random.split(jax.random.fold_in(step_key, 0))
    t = jax.random.randint(k_t, (B,), 0, T)
    noise = jproc.sample_noise(k_n, t) if param == "so3" else jax.random.normal(k_n, (B, 3))
    return torch.from_numpy(np.array(t)).long(), _t(noise)


@pytest.mark.parametrize("param", ["so3", "euler"])
def test_ten_step_trajectory_matches_the_jax_step(param):
    """Each arm's JAX model, loss and ``optax.adam`` under the JAX driver's
    ``make_dp_train_step(skip_nonfinite=True)``, and the port's from one JAX
    init, the same batches, t and noise, lr 1e-3: every loss rtol 1e-4,
    every weight after 10 steps within lr / 10 of JAX's."""
    jargs = jlock.parse_args(["--param", param, "--timesteps", str(T), "--batch", str(B)])
    jmodel, jproc = jlock.build(jargs)
    batch_fn = jlock._make_batch_fn(jargs)
    batches = [np.asarray(batch_fn(jax.random.PRNGKey(100 + i))) for i in range(STEPS)]
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]),
                         jnp.zeros((B,), jnp.int32))
    tx = optax.adam(LR)
    jstate = JTrainState.create(params, tx, jax.random.PRNGKey(1))
    jstep = j_make_step(lambda p, k, b: jproc.loss(lambda x, t: jmodel.apply(p, x, t), k, b),
                        tx, Mesh(np.asarray(jax.devices()[:1]), ("dp",)), donate=False,
                        skip_nonfinite=True)
    convert = rot_predict_params_from_flax if param == "so3" else euler_rot_predict_params_from_flax
    args = lock.parse_args(["--param", param, "--timesteps", str(T), "--device", "cpu"])
    model, proc = lock.build(args, torch.device("cpu"))
    model.load_state_dict(convert(jax.tree_util.tree_map(np.asarray, params)))
    optimizer = make_optimizer(model.named_parameters(), LR)
    tstep = make_dp_train_step(lock.make_loss_fn(model, proc), model, optimizer,
                               skip_nonfinite=True)
    tstate = TrainState(model, optimizer, torch.Generator())
    for i in range(STEPS):
        t, noise = _step_randomness(jproc, jstate.key, int(jstate.step), param)
        jstate, jm = jstep(jstate, jnp.asarray(batches[i]))
        tstate, tm = tstep(tstate, (_t(batches[i]), t, noise))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    want = convert(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, p in model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) < LR / 10, name


@pytest.fixture(scope="module")
def committed():
    """The committed so3-arm checkpoint, restored by the JAX package (its
    newest step) and converted; its files' hashes before the restore."""
    before = tree_hashes(os.path.join("sweeps", "lock_r3"))
    jargs = jlock.parse_args(["--param", "so3"])
    jmodel, jproc = jlock.build(jargs)
    key = jax.random.PRNGKey(0)
    params = jmodel.init(key, jnp.zeros((1, 3, 3)), jnp.zeros((1,), jnp.int32))
    state = j_restore(CKPT, JTrainState.create(params, optax.adam(3e-4), key), params_only=True)
    tree = jax.tree_util.tree_map(np.asarray, state.params)
    model, proc = lock.build(lock.parse_args(["--param", "so3", "--device", "cpu"]),
                             torch.device("cpu"))
    model.load_state_dict(rot_predict_params_from_flax(tree))
    return dict(step=int(state.step), tree=tree, jmodel=jmodel, jproc=jproc, model=model.eval(),
                proc=proc, before=before)


def test_committed_checkpoint_forward(committed):
    """Step 5000's forward on segment rotations and Haar rotations at six
    timesteps: rtol 1e-4 / atol 1e-5."""
    c = committed
    assert c["step"] == 5000
    assert rot_predict_config_from_flax(c["tree"]) == {"d_model": 255, "out_type": "skewvec",
                                                       "variant": "resnet"}
    x = np.concatenate([np.asarray(jsynthetic.sample_lock_batch(jax.random.PRNGKey(3), 6)),
                        np.asarray(j_haar(jax.random.PRNGKey(4), (6,)))])
    t = np.array([0, 1, 50, 300, 700, 999] * 2, np.int32)
    ref = c["jmodel"].apply(c["tree"], jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        ours = c["model"](_t(x), torch.from_numpy(t).long())
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_committed_checkpoint_short_chain(committed):
    """Ancestral steps of the JAX test's chain (``init="qr"``) from JAX's
    Haar x_init with JAX's IGSO(3) noise.  Ten steps from t = 500: each
    step from JAX's state within 1e-5, the port's own chain within 1e-4
    (measured 4.8e-7 and 1.8e-5).  The first step of the chain, t = 999,
    within 1e-3 (measured 1.8e-4): its x0 estimate multiplies the two
    forwards' float32 difference by sqrt(1/acp_999 - 1) = 20291, which also
    makes the chain's next steps from there ill-conditioned.  The
    checkpoint's files keep their bytes."""
    c = committed
    n = 16
    key = jax.random.PRNGKey(5)
    jstep = jax.jit(lambda x, t, k: c["jproc"].p_sample(
        lambda a, b: c["jmodel"].apply(c["tree"], a, b), k, x, t))

    def noise_at(i):
        jt = jnp.full((n,), i, jnp.int32)
        k = jax.random.fold_in(key, i)
        return jt, k, _t(c["jproc"].p_table.sample(k, jt))

    jx = j_haar(key, (n,))
    tx = _t(jx)
    with torch.no_grad():
        jt, k, noise = noise_at(999)
        first = c["proc"].p_sample(c["model"], None, tx, torch.full((n,), 999), noise=noise)
        np.testing.assert_allclose(first.numpy(), np.asarray(jstep(jx, jt, k)), atol=1e-3)
        for i in range(500, 490, -1):
            jt, k, noise = noise_at(i)
            tt = torch.full((n,), i)
            one = c["proc"].p_sample(c["model"], None, _t(jx), tt, noise=noise)
            jx = jstep(jx, jt, k)
            np.testing.assert_allclose(one.numpy(), np.asarray(jx), atol=1e-5)
            tx = c["proc"].p_sample(c["model"], None, tx, tt, noise=noise)
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    assert tree_hashes(os.path.join("sweeps", "lock_r3")) == c["before"]


@pytest.fixture()
def small(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return ["--device", "cpu", "--timesteps", "20", "--batch", "8"]


@pytest.mark.parametrize("param", ["so3", "euler"])
def test_driver_end_to_end(small, tmp_path, capsys, param):
    """Train 12 eager steps, resume to 16, ``--test`` on the checkpoint:
    the samples and the record land in ``--out-dir`` as torch_lock_* files,
    nothing else is written, the repository's results/ and images/ keep
    their bytes."""
    before = tree_hashes("results", "images")
    ck, log, out = str(tmp_path / "ck"), str(tmp_path / "log.jsonl"), str(tmp_path / "out")
    state = lock.main(small + ["--param", param, "--steps", "12", "--print-every", "4",
                               "--ckpt", ck, "--log", log])
    assert state.step == 12 and latest_step(ck) == 12
    with open(log) as f:
        assert [json.loads(line)["step"] for line in f] == [4, 8, 12]
    assert lock.main(small + ["--param", param, "--steps", "16", "--resume",
                              "--ckpt", ck]).step == 16
    rec = lock.main(small + ["--param", param, "--test", "--eval-batch", "16", "--ckpt", ck,
                             "--out-dir", out])
    text = capsys.readouterr().out
    assert "untrained" not in text and "|axis.y| mean" in text
    assert rec["finite"] and rec["count"] == 16 and 0.0 <= rec["axis_y_mean"] <= 1.0
    assert sorted(os.listdir(out)) == sorted([f"torch_lock_samples_{param}.npy",
                                              f"torch_lock_{param}.json"])
    samples = np.load(os.path.join(out, f"torch_lock_samples_{param}.npy"))
    assert samples.shape == (16, 3, 3)
    np.testing.assert_allclose(samples @ samples.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), samples.shape), atol=1e-5)
    assert sorted(os.listdir(tmp_path)) == ["ck", "log.jsonl", "out"]
    assert tree_hashes("results", "images") == before


def test_plot_is_not_ported_yet(small, tmp_path):
    """``--plot`` is ported now: ``--test --plot`` draws the final frames on
    the sphere into ``<out-dir>/torch_lock_sphere_<param>.png``, beside the
    samples and the record."""
    out = str(tmp_path / "out")
    rec = lock.main(small + ["--test", "--plot", "--eval-batch", "8", "--out-dir", out])
    assert rec["count"] == 8
    assert sorted(os.listdir(out)) == ["torch_lock_samples_so3.npy", "torch_lock_so3.json",
                                       "torch_lock_sphere_so3.png"]
    assert os.path.getsize(os.path.join(out, "torch_lock_sphere_so3.png")) > 1000


JAX_FLAGS = ["param", "batch", "lr", "steps", "timesteps", "seed", "ckpt", "ckpt_every",
             "print_every", "log", "resume", "debug_nans", "test", "eval_batch", "plot"]


@pytest.mark.parametrize("name", JAX_FLAGS)
@pytest.mark.parametrize("param", ["so3", "euler"])
def test_parser_option_matches_the_jax_drivers(name, param):
    ref = vars(jlock.parse_args(["--param", param]))
    ours = vars(lock.parse_args(["--param", param]))
    assert set(ref) == set(JAX_FLAGS) and set(ours) == set(JAX_FLAGS) | {"out_dir", "device"}
    assert ours[name] == ref[name]
