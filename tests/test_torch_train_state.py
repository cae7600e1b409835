"""The port's train state and checkpoints on the CPU: exact round trips,
newest-3 retention, ``params_only`` restores with the reference's two
validation errors, and exact resume (N + save + restore + N == 2N)."""
import os

import numpy as np
import pytest
import torch

from diffusion_extensions_tpu_torch.models.rot_predict import RotPredict
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
from diffusion_extensions_tpu_torch.processes.so3 import SO3Diffusion
from diffusion_extensions_tpu_torch.train.optim import make_optimizer
from diffusion_extensions_tpu_torch.train.state import (
    MAX_TO_KEEP,
    TrainState,
    checkpoint_path,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)
PROC = SO3Diffusion.create(50, device="cpu")


def _state(seed=0, d_model=65, gen_seed=1, **opt):
    torch.manual_seed(seed)
    model = RotPredict(d_model, "skewvec")
    optimizer = make_optimizer(model.named_parameters(), 1e-3, **opt)
    return TrainState(model, optimizer, torch.Generator().manual_seed(gen_seed))


def _step_fn(state):
    def loss_fn(gen, batch):
        return PROC.loss(state.model, gen, batch)

    return make_dp_train_step(loss_fn, state.model, state.optimizer)


def _batches(n, seed=3):
    q = np.random.default_rng(seed).standard_normal((n, 16, 3, 3)).astype(np.float32)
    return [torch.linalg.qr(torch.from_numpy(b))[0] for b in q]


def _train(state, batches):
    step = _step_fn(state)
    for b in batches:
        state, _ = step(state, b)
    return state


def _assert_same_bits(a: TrainState, b: TrainState):
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    for x, y in zip(a.optimizer.mu + a.optimizer.nu, b.optimizer.mu + b.optimizer.nu):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(a.optimizer.count) == int(b.optimizer.count) and a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_round_trip_is_exact(tmp_path):
    """Weights, moments, count, step and the generator's state come back to
    the bit: the next draw is the same."""
    ckpt = str(tmp_path / "ck")
    state = _train(_state(), _batches(3))
    path = save_checkpoint(ckpt, state)
    assert path == checkpoint_path(ckpt, 3) and os.path.isfile(path)
    assert os.listdir(ckpt) == ["step_00000003.pt"]
    restored = restore_checkpoint(ckpt, _state(seed=9, gen_seed=7))
    _assert_same_bits(state, restored)
    assert torch.equal(torch.rand(5, generator=state.generator),
                       torch.rand(5, generator=restored.generator))
    # restored weights train on: they are leaves that require grad
    assert all(p.requires_grad and p.is_leaf for p in restored.model.parameters())
    _train(restored, _batches(1, seed=4))


def test_newest_three_are_kept_and_latest_step(tmp_path):
    ckpt = str(tmp_path / "ck")
    assert latest_step(ckpt) is None and MAX_TO_KEEP == 3
    state = _state()
    assert restore_checkpoint(ckpt, state) is state and state.step == 0  # nothing there
    for step in (10, 20, 5, 30, 40):
        save_checkpoint(ckpt, state, step=step)
    assert sorted(os.listdir(ckpt)) == [f"step_{s:08d}.pt" for s in (20, 30, 40)]
    assert latest_step(ckpt) == 40
    (tmp_path / "ck" / "notes.txt").write_text("not a checkpoint")
    assert latest_step(ckpt) == 40


def test_params_only_across_optimizer_structures(tmp_path):
    """A checkpoint written with a clipped, fused, bf16-state optimizer
    restores into an evaluation target with a plain optimizer, or none:
    weights, step and generator state; the optimizer is left alone."""
    ckpt = str(tmp_path / "ck_clip")
    state = _train(_state(clip=1.0, impl="fused", state_dtype="bf16"), _batches(2))
    state.step = 200
    save_checkpoint(ckpt, state)
    for target in (_state(seed=5), TrainState(RotPredict(65, "skewvec"), None, torch.Generator())):
        restored = restore_checkpoint(ckpt, target, params_only=True)
        assert restored.step == 200
        for (k, x), (_, y) in zip(state.model.state_dict().items(),
                                  restored.model.state_dict().items()):
            assert torch.equal(x, y), k
        assert torch.equal(restored.generator.get_state(), state.generator.get_state())
        if target.optimizer is not None:
            assert int(target.optimizer.count) == 0
            assert all(float(m.abs().max()) == 0.0 for m in target.optimizer.mu)
    with pytest.raises(ValueError, match="same --opt-state-dtype"):
        restore_checkpoint(ckpt, _state(seed=5))  # a full restore needs the same optimizer


def test_params_only_validation_errors(tmp_path):
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, _state(), step=7)
    with pytest.raises(ValueError, match=r"step 7: shape mismatch at hidden\.0\.weight: "
                                         r"stored \(65, 65\) vs model \(33, 33\)"):
        restore_checkpoint(ckpt, _state(d_model=33), params_only=True)
    torch.manual_seed(0)
    other = RotPredict(65, "skewvec", "resnet")
    target = TrainState(other, None, torch.Generator())
    with pytest.raises(ValueError, match="checkpoint param tree does not match the model "
                                         "config .* check the eval flags match the training flags"):
        restore_checkpoint(ckpt, target, params_only=True)


@pytest.mark.parametrize("opt", [dict(), dict(clip=0.5, schedule="cosine", total_steps=8),
                                 dict(impl="fused"), dict(impl="fused", state_dtype="bf16")],
                         ids=["plain", "clip-cosine", "fused", "fused-bf16"])
def test_resume_is_exact(tmp_path, opt):
    """N steps, save, restore into a fresh state, N steps == 2N steps, to
    the bit, for every optimizer structure."""
    n = 4
    batches = _batches(2 * n)
    full = _train(_state(**opt), batches)
    half = _train(_state(**opt), batches[:n])
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, half)
    resumed = restore_checkpoint(ckpt, _state(seed=11, gen_seed=13, **opt))
    assert resumed.step == n
    resumed = _train(resumed, batches[n:])
    _assert_same_bits(full, resumed)
    assert resumed.step == 2 * n
