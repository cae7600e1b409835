"""The port's protein probe (``experiments/probe_protein.py``) against the
JAX package's ``tools/probe_protein.py``, on the CPU at a small ProtNet
(dim 32, 2 heads, t_depth 1, c_depth 3): one t's four MSEs from the same
explicit noise and weights against the same computation built from the
JAX package's functions, the flags, and the probe end to end on a
checkpoint written by the port's protein driver."""
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.data.pdb import pad_prot_batch as j_pad
from diffusion_extensions_tpu.data.pdb import synthetic_prot_pair as j_pair
from diffusion_extensions_tpu.models.projections import ProtProjection as JProj
from diffusion_extensions_tpu.models.protnet import ProtNet as JProtNet
from diffusion_extensions_tpu.ops import se3 as jse3
from diffusion_extensions_tpu.ops.so3 import log_rmat_vec as j_log_rmat_vec
from diffusion_extensions_tpu.processes.schedule import extract as j_extract
from diffusion_extensions_tpu.processes.se3 import ProjectedSE3Diffusion as JProc
from diffusion_extensions_tpu_torch.convert import protnet_config_from_flax, protnet_params_from_flax
from diffusion_extensions_tpu_torch.data.pdb import to_device
from diffusion_extensions_tpu_torch.experiments import probe_protein, protein
from diffusion_extensions_tpu_torch.models.protnet import ProtNet
from diffusion_extensions_tpu_torch.ops.se3 import AffineT
from diffusion_extensions_tpu_torch.processes.se3 import ProjectedSE3Diffusion

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(dim=32, heads=2, t_depth=1, c_depth=3)
SMALL_ARGV = ["--dim", "32", "--heads", "2", "--t_depth", "1", "--c_depth", "3"]
HEADLINE_FLAGS = dict(frame_pool=True, cross_depth=1, rel_frame=True, equiv_head=True)
B = 4
# measured: at most 3.4e-7 relative over the four terms (float32 on both sides)
RTOL = 1e-4


@pytest.fixture(scope="module")
def batch_np():
    rng = np.random.default_rng(0)
    pairs = [j_pair(rng) for _ in range(16)]
    return j_pad(pairs[:B])


def _jax_terms(model, params, proc, batch, t, noise):
    """The JAX tool's per-t computation (tools/probe_protein.py:89-102)."""
    truepos = jse3.AffineT(jnp.broadcast_to(jnp.eye(3), (B, 3, 3)), jnp.zeros((B, 3)))
    eps = j_extract(proc.schedule.sqrt_one_minus_alphas_cumprod, t, 1)
    x_noisy = proc.q_sample(truepos, t, noise)
    x_in = JProj(batch, se3=True)(x_noisy)
    pred = model.apply(params, x_in, t)
    tgt_rot = j_log_rmat_vec(noise.rot) / eps
    tgt_shift = noise.shift / (eps * proc.shift_scale)

    def mse(a, b):
        return jnp.mean((a - b) ** 2)

    return np.array([mse(pred.rot_g, tgt_rot), mse(0.0 * tgt_rot, tgt_rot),
                     mse(pred.shift_g, tgt_shift), mse(0.0 * tgt_shift, tgt_shift)])


@pytest.mark.parametrize("flags", ["reference", "headline"])
@pytest.mark.parametrize("t_s", [20, 600])
def test_probe_terms_match_jax(batch_np, flags, t_s):
    """``probe_terms`` on JAX's noise and converted weights gives the JAX
    computation's four MSEs within rtol 1e-4."""
    extra = HEADLINE_FLAGS if flags == "headline" else {}
    jm = JProtNet(**SMALL, se3=True, **extra)
    t = jnp.full((B,), t_s, jnp.int32)
    params = jm.init(jax.random.PRNGKey(3), batch_np, t)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    tm = ProtNet(**protnet_config_from_flax(tree), se3=True).eval()
    tm.load_state_dict(protnet_params_from_flax(tree), strict=True)
    jproc = JProc(timesteps=1000)
    noise = jproc.sample_noise(jax.random.fold_in(jax.random.PRNGKey(42), t_s), t)
    want = _jax_terms(jm, params, jproc, batch_np, t, noise)

    process = ProjectedSE3Diffusion(timesteps=1000, device="cpu")
    t_t = torch.full((B,), t_s, dtype=torch.long)
    noise_t = AffineT(torch.from_numpy(np.array(noise.rot)),
                      torch.from_numpy(np.array(noise.shift)))
    with torch.no_grad():
        got = probe_protein.probe_terms(tm, process, to_device(batch_np, "cpu"), t_t, noise_t)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def _flags(source: str) -> set:
    return set(re.findall(r'add_argument\(\s*"(--?[\w-]+)"', source))


def test_probe_flags_are_the_jax_tools():
    with open(os.path.join(ROOT, "tools", "probe_protein.py")) as f:
        jax_flags = _flags(f.read())
    with open(probe_protein.__file__) as f:
        port_flags = _flags(f.read())
    assert port_flags == jax_flags | {"--device"}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """Four steps of the port's protein driver at the small width with the
    headline flags (cross depth 1)."""
    d = str(tmp_path_factory.mktemp("probe") / "ckpt")
    protein.main(["--se3", "--device", "cpu", *SMALL_ARGV, "--frame-pool", "--cross-depth",
                  "1", "--rel-frame", "--equiv-head", "--batch", "4", "--timesteps", "50",
                  "--steps", "4", "--steps-per-call", "2", "--ckpt", d,
                  "--data-root", "/nonexistent"])
    return d


@pytest.mark.parametrize("augment", [False, True])
def test_probe_end_to_end(checkpoint, capsys, augment):
    """The probe restores the checkpoint (its step is printed) and returns
    one finite row of four MSEs a t; the zero predictor's terms do not
    depend on the weights, so they equal those of the seeded init."""
    argv = ["--ckpt", checkpoint, "--device", "cpu", *SMALL_ARGV, "--frame-pool",
            "--cross-depth", "1", "--rel-frame", "--equiv-head", "--batch", "4", "--rounds", "2"]
    argv += ["--augment"] if augment else []
    table = probe_protein.main(argv)
    out = capsys.readouterr().out
    assert "ckpt step: 4" in out
    assert out.count("rot: model") == len(probe_protein.TIMESTEPS)
    assert table.shape == (5, 4) and np.isfinite(table).all()
    untrained = probe_protein.main(argv[:1] + [os.path.dirname(checkpoint)] + argv[2:])
    assert "ckpt step: 0" in capsys.readouterr().out
    np.testing.assert_array_equal(untrained[:, [1, 3]], table[:, [1, 3]])
    assert not np.array_equal(untrained[:, [0, 2]], table[:, [0, 2]])
