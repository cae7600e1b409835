"""The port's parallel layer on the CPU: gloo process groups of 2 and 4
spawned workers (``torch.multiprocessing``, spawn), each group joined
through a ``FileStore`` under ``tmp_path`` so that test workers never
share a port, with a collective timeout and a join deadline so that a hung
collective fails instead of eating the suite's time.  Every worker runs one
thread.

Each spawn runs a list of scenarios and writes what they measured; the
tests read it, one assertion a test.  Held: the launch environment,
``make_mesh``, the data-parallel step against the mean of the ranks'
single-process gradients, a data-parallel resume, mesh invariance of the
one-program step (single process, dp2, tp2, sp2, fsdp dp2, and dp2 x tp2,
dp2 x sp2 on four ranks; with and without MoE layers, which route the
global batch) over two SGD steps, expert parallelism against the
replicated step, the
GPipe pipeline against the sequential stack, the pipelined PlaneNet with
and without MoE, and the driver under a launcher.  The layout rules are
held against the JAX package's."""
from __future__ import annotations

import os
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)
JOIN_SECONDS = 240
COLLECTIVE_SECONDS = 90
BATCH, POINTS, T = 8, 32, 50


# ---------------------------------------------------------------- spawning
def _entry(fn_name, rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=COLLECTIVE_SECONDS))
    results = {}
    try:
        for name, scenario in SCENARIOS[fn_name]:
            try:
                results[name] = scenario(rank, world, out_dir)
            except Exception:  # recorded for the test that reads it
                results[name] = {"error": traceback.format_exc()}
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def _spawn(fn_name: str, world: int, tmp_path) -> list[dict]:
    """Run the scenario list ``fn_name`` on ``world`` gloo ranks; each
    rank's results."""
    ctx = mp.get_context("spawn")
    out_dir = tmp_path / fn_name
    out_dir.mkdir()
    procs = [ctx.Process(target=_entry, args=(fn_name, r, world, str(out_dir / "store"),
                                              str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_SECONDS
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} of {world} workers did not finish in {JOIN_SECONDS} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _ok(result: dict) -> dict:
    assert "error" not in result, result["error"]
    return result


# ------------------------------------------------------------- scenarios
def _planenet_setup(moe: int = 0):
    from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
    from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion

    torch.manual_seed(0)
    model = PlaneNet(dim=64, heads=4, layers=2, moe_experts=moe)
    process = ProjectedSO3Diffusion(T, device="cpu")
    data = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH, POINTS, 3)).astype(np.float32))
    return model, process, data


def _full_params(model) -> dict:
    from torch.distributed.tensor import DTensor

    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach().clone()
            for k, v in model.state_dict().items()}


def _dropped(model) -> int:
    """The tokens the last forward's MoE layers dropped, from the experts'
    token counts and the capacity."""
    drops = 0
    for layer in model.encoder.layers:
        if layer.moe is not None:
            t = BATCH * POINTS
            counts = torch.round(layer.moe.expert_frac * t)
            drops += int(torch.clamp(counts - layer.moe.capacity(t), min=0).sum())
    return drops


def _single_process_steps(steps: int = 2, moe: int = 0):
    """The reference: the plain single-process step, two SGD steps."""
    from diffusion_extensions_tpu_torch.experiments import aircraft
    from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
    from diffusion_extensions_tpu_torch.train.state import TrainState

    model, process, data = _planenet_setup(moe)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt)
    state = TrainState(model, opt, torch.Generator().manual_seed(1))
    losses, dropped = [], []
    for _ in range(steps):
        state, m = step(state, data)
        losses.append(float(m["loss"]))
        dropped.append(_dropped(model))
    return losses, _full_params(model), dropped


def _mesh_steps(axes, fsdp=False, steps: int = 2, moe: int = 0):
    """Two SGD steps of the one-program step on the mesh ``axes``."""
    from diffusion_extensions_tpu_torch.experiments import aircraft
    from diffusion_extensions_tpu_torch.parallel import make_mesh
    from diffusion_extensions_tpu_torch.parallel.gspmd import (
        make_gspmd_train_step,
        shard_params,
    )
    from diffusion_extensions_tpu_torch.train.state import TrainState

    mesh = make_mesh(axes, "cpu")
    model, process, data = _planenet_setup(moe)
    shard_params(model, mesh, fsdp=fsdp)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    step = make_gspmd_train_step(aircraft.make_global_loss_fn(model, process, mesh), model, opt,
                                 mesh, fsdp=fsdp)
    state = TrainState(model, opt, torch.Generator().manual_seed(1))
    losses = []
    for _ in range(steps):
        state, m = step(state, data)
        losses.append(float(m["loss"]))
    from torch.distributed.tensor import DTensor

    sharded = sorted(k for k, v in model.state_dict().items()
                     if isinstance(v, DTensor) and any(p.is_shard() for p in v.placements))
    return {"losses": losses, "params": _full_params(model), "sharded": sharded}


def _invariance(axes, fsdp=False, moe=0):
    def run(rank, world, tmp):
        ref_losses, ref_params, dropped = _single_process_steps(moe=moe)
        out = _mesh_steps(axes, fsdp, moe=moe)
        out.update(ref_losses=ref_losses, ref_params=ref_params, dropped=dropped)
        return out if rank == 0 else {"losses": out["losses"]}
    return run


def _launch_and_mesh(rank, world, tmp):
    from diffusion_extensions_tpu_torch.parallel import make_mesh
    from diffusion_extensions_tpu_torch.parallel.launch import maybe_initialize_distributed

    out = {"already": maybe_initialize_distributed("cpu", verbose=False)}
    inferred = make_mesh([("dp", -1), ("tp", 1)], "cpu")
    out["inferred"] = (inferred.mesh_dim_names, tuple(inferred.mesh.shape))
    default = make_mesh(device_type="cpu")
    out["default"] = (default.mesh_dim_names, tuple(default.mesh.shape))
    try:
        make_mesh([("dp", 3)], "cpu")
    except ValueError as e:
        out["bad"] = str(e)
    return out


def _dp_step(rank, world, tmp):
    """One data-parallel step on the global batch against the rank's
    single-process gradient on its half (the half of the global draw of
    t and noise, no group)."""
    from diffusion_extensions_tpu_torch.experiments import aircraft
    from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step, shard_batch
    from diffusion_extensions_tpu_torch.train.state import TrainState

    group = dist.group.WORLD
    model, process, data = _planenet_setup()
    t, noise = aircraft.draw_t_noise(process, torch.Generator().manual_seed(1), BATCH)
    shard = shard_batch((data, t, noise), group)
    local = aircraft.make_loss_fn(model, process)(None, shard)
    local.backward()
    local_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    step = make_dp_train_step(aircraft.make_global_loss_fn(model, process, group), model, opt,
                              group=group)
    state, m = step(TrainState(model, opt, torch.Generator().manual_seed(1)), data)
    return {"local_grads": local_grads, "local_loss": float(local),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "loss": float(m["loss"]), "params": _full_params(model),
            "shard_rows": shard[0].shape[0]}


def _dp_resume(rank, world, tmp):
    """Four data-parallel Adam steps straight, and two, a checkpoint, a
    restore into a fresh state and two more: the weights and the losses
    on every rank."""
    from diffusion_extensions_tpu_torch.experiments import aircraft
    from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer
    from diffusion_extensions_tpu_torch.train.state import (
        TrainState,
        restore_checkpoint,
        save_checkpoint,
    )

    group = dist.group.WORLD
    batches = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, BATCH, POINTS, 3)).astype(np.float32))

    def fresh():
        model, process, _ = _planenet_setup()
        opt = make_optimizer(model.named_parameters(), 1e-3)
        step = make_dp_train_step(aircraft.make_global_loss_fn(model, process, group), model,
                                  opt, group=group)
        return step, TrainState(model, opt, torch.Generator().manual_seed(1))

    def run(step, state, lo, hi):
        losses = []
        for i in range(lo, hi):
            state, m = step(state, batches[i])
            losses.append(float(m["loss"]))
        return state, losses

    step, state = fresh()
    state, straight = run(step, state, 0, 4)
    want = _full_params(state.model)
    step, state = fresh()
    state, first = run(step, state, 0, 2)
    d = os.path.join(tmp, "dp_resume")
    save_checkpoint(d, state)
    step, state = fresh()
    state = restore_checkpoint(d, state)
    state, second = run(step, state, 2, 4)
    got = _full_params(state.model)
    return {"straight": straight, "resumed": first + second, "step": state.step,
            "max_abs_diff": max(float((got[k] - want[k]).abs().max()) for k in want)}


def _ep_step(dispatch):
    def run(rank, world, tmp):
        from diffusion_extensions_tpu_torch.models.layers import TransformerEncoder
        from diffusion_extensions_tpu_torch.models.moe import EXPERT_LEAVES, shard_moe_params

        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((4, 16, 32)).astype(np.float32))
        weight = torch.from_numpy(rng.standard_normal((4, 16, 32)).astype(np.float32))

        def whole(name, g, sharded=True):
            """An expert leaf's gradient or weight gathered over the ranks."""
            if not sharded or name.split(".")[-1] not in EXPERT_LEAVES:
                return g.detach().clone()
            parts = [torch.empty_like(g) for _ in range(world)]
            dist.all_gather(parts, g.detach().contiguous())
            return torch.cat(parts)

        def step(enc, sharded):
            """One SGD step of a loss that reaches every weight before the
            MoE layer (the attention and the first norm) through it."""
            opt = torch.optim.SGD(enc.parameters(), lr=1e-2)
            out = enc(x)
            loss = torch.sum(out * weight) / out.numel() + 0.01 * enc.layers[0].moe.aux_loss
            loss.backward()
            grads = {n: whole(n, p.grad, sharded) for n, p in enc.named_parameters()}
            opt.step()
            return float(loss), grads

        def fresh():
            torch.manual_seed(0)
            return TransformerEncoder(32, 4, 1, moe_experts=4, moe_dispatch=dispatch)

        ref = fresh()
        ref_loss, ref_grads = step(ref, False)
        enc = fresh()
        sharded = shard_moe_params(enc, dist.group.WORLD)
        local_shapes = {n: tuple(p.shape) for n, p in enc.named_parameters()}
        loss, grads = step(enc, True)
        return {"loss": loss, "ref_loss": ref_loss, "sharded": sharded,
                "local_shapes": local_shapes, "grads": grads, "ref_grads": ref_grads,
                "params": {n: whole(n, p) for n, p in enc.named_parameters()},
                "ref_params": {n: p.detach().clone() for n, p in ref.named_parameters()}}
    return run


L_PP, D_PP, B_PP = 8, 16, 16


def _pp_stack(m):
    def run(rank, world, tmp):
        from torch import nn

        from diffusion_extensions_tpu_torch.parallel.pp import (
            pipeline_apply,
            shard_stacked_params,
            stack_layer_params,
        )

        torch.manual_seed(0)
        layers = stack_layer_params([nn.Linear(D_PP, D_PP) for _ in range(L_PP)])
        x = torch.from_numpy(np.random.default_rng(1).standard_normal((B_PP, D_PP))
                             .astype(np.float32)).requires_grad_(True)
        stage = shard_stacked_params(layers, dist.group.WORLD)
        layer_fn = lambda layer, h: torch.tanh(layer(h))  # noqa: E731
        out = pipeline_apply(layer_fn, stage, x, dist.group.WORLD, m)
        (out ** 2).sum().backward()
        got = {"out": out.detach().clone(), "x_grad": x.grad.clone(),
               "stage": [{n: p.grad.clone() for n, p in layer.named_parameters()}
                         for layer in stage]}
        x.grad = None
        h = x
        for layer in layers:
            h = layer_fn(layer, h)
        ref_grads = torch.autograd.grad((h ** 2).sum(), [x] + [p for layer in stage
                                                            for p in layer.parameters()])
        got.update(ref_out=h.detach().clone(), ref_x_grad=ref_grads[0],
                   ref_stage=list(ref_grads[1:]), n_stage=len(stage))
        return got
    return run


def _pp_planenet(moe):
    def run(rank, world, tmp):
        from diffusion_extensions_tpu_torch.models.planenet import (
            PlaneNet,
            planenet_pp_apply,
            planenet_pp_params,
        )

        m_micro = 4
        torch.manual_seed(0)
        model = PlaneNet(dim=64, heads=4, layers=4, moe_experts=moe)
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal((8, 32, 3)).astype(np.float32))
        t = torch.from_numpy(rng.integers(0, 50, 8))
        pp = planenet_pp_params(model, dist.group.WORLD)
        got = planenet_pp_apply(model, pp, x, t, dist.group.WORLD, m_micro)
        pred, aux = got if moe else (got, None)
        (pred ** 2).sum().backward() if not moe else (pred.sum() + aux).backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad()
        if moe:
            mb = x.shape[0] // m_micro
            outs, auxs = [], []
            for i in range(m_micro):
                outs.append(model(x[i * mb:(i + 1) * mb], t[i * mb:(i + 1) * mb]))
                auxs.append(model.moe_aux())
            want, want_aux = torch.cat(outs), torch.stack(auxs).mean()
            (want.sum() + want_aux).backward()
        else:
            want, want_aux = model(x, t), None
            (want ** 2).sum().backward()
        ref = {n: model.get_parameter(n).grad.clone() for n in grads}
        return {"pred": pred.detach(), "want": want.detach(),
                "aux": None if aux is None else float(aux),
                "want_aux": None if want_aux is None else float(want_aux),
                "grads": grads, "ref_grads": ref,
                "stage_layers": len(pp["layers"])}
    return run


def _driver_tp(rank, world, tmp):
    """The aircraft driver as a launcher starts it: --tp 2 then a resume."""
    from diffusion_extensions_tpu_torch.experiments import aircraft

    d = os.path.join(tmp, "ckpt")
    args = ["--so3", "--device", "cpu", "--dim", "64", "--heads", "4", "--layers", "1",
            "--batch", "4", "--samples", "16", "--timesteps", "50", "--data-root",
            "/nonexistent", "--no-native", "--ckpt", d, "--print-every", "1",
            "--steps-per-call", "2"]
    state = aircraft.main(args + ["--tp", "2", "--steps", "3"])
    first = state.step
    state = aircraft.main(args + ["--tp", "2", "--steps", "5", "--resume"])
    from diffusion_extensions_tpu_torch.train.state import latest_step

    return {"first": first, "resumed": state.step, "latest": latest_step(d)}


SCENARIOS = {
    "two": [
        ("launch_and_mesh", _launch_and_mesh),
        ("dp", _dp_step),
        ("dp_resume", _dp_resume),
        ("dp2", _invariance([("dp", 2)])),
        ("tp2", _invariance([("dp", 1), ("tp", 2)])),
        ("sp2", _invariance([("dp", 1), ("sp", 2)])),
        ("fsdp_dp2", _invariance([("dp", 2)], fsdp=True)),
        ("dp2_moe", _invariance([("dp", 2)], moe=4)),
        ("tp2_moe", _invariance([("dp", 1), ("tp", 2)], moe=4)),
        ("sp2_moe", _invariance([("dp", 1), ("sp", 2)], moe=4)),
        ("fsdp_dp2_moe", _invariance([("dp", 2)], fsdp=True, moe=4)),
        ("ep_onehot", _ep_step("onehot")),
        ("ep_scatter", _ep_step("scatter")),
        ("pp_2_4", _pp_stack(4)),
        ("pp_2_8", _pp_stack(8)),
        ("pp_planenet", _pp_planenet(0)),
        ("pp_planenet_moe", _pp_planenet(4)),
        ("driver_tp", _driver_tp),
    ],
    "four": [
        ("dp2_tp2", _invariance([("dp", 2), ("sp", 1), ("tp", 2)])),
        ("dp2_sp2", _invariance([("dp", 2), ("sp", 2), ("tp", 1)])),
        ("dp2_sp2_moe", _invariance([("dp", 2), ("sp", 2), ("tp", 1)], moe=4)),
    ],
}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn("two", 2, tmp_path_factory.mktemp("gloo2"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn("four", 4, tmp_path_factory.mktemp("gloo4"))


# ------------------------------------------------------------------ tests
def test_launch_env_parsing(monkeypatch):
    """``maybe_initialize_distributed``: no environment, a no-op; the DXT_*
    triple and torchrun's variables give ``init_process_group``'s
    arguments (gloo on the CPU, NCCL and the local card on cuda); an
    initialised group returns True without a second init."""
    from diffusion_extensions_tpu_torch.parallel import launch

    calls, cards = [], []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for var in ("DXT_COORDINATOR", "DXT_NUM_PROCESSES", "DXT_PROCESS_ID",
                "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert launch.maybe_initialize_distributed("cpu", verbose=False) is False and not calls

    monkeypatch.setenv("DXT_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("DXT_NUM_PROCESSES", "2")
    monkeypatch.setenv("DXT_PROCESS_ID", "1")
    assert launch.maybe_initialize_distributed("cpu", verbose=False) is True
    assert calls[-1] == (("gloo",), {"init_method": "tcp://10.0.0.1:1234", "world_size": 2,
                                     "rank": 1})
    assert launch.maybe_initialize_distributed(verbose=False) is True  # the card
    assert calls[-1][0] == ("nccl",) and cards == [1]  # process id 1 of 4 cards

    for var in ("DXT_COORDINATOR", "DXT_NUM_PROCESSES", "DXT_PROCESS_ID"):
        monkeypatch.delenv(var)
    for var, value in (("RANK", "3"), ("WORLD_SIZE", "4"), ("LOCAL_RANK", "1"),
                       ("MASTER_ADDR", "host0"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(var, value)
    assert launch.distributed_env() == {"init_method": "tcp://host0:29500", "world_size": 4,
                                        "rank": 3, "local_rank": 1}
    assert launch.maybe_initialize_distributed("cuda", verbose=False) is True
    assert calls[-1] == (("nccl",), {"init_method": "tcp://host0:29500", "world_size": 4,
                                     "rank": 3})
    assert cards[-1] == 1
    n = len(calls)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert launch.maybe_initialize_distributed("cpu", verbose=False) is True and len(calls) == n


def test_make_mesh(two):
    out = _ok(two[0]["launch_and_mesh"])
    assert out["already"] is True
    assert out["inferred"] == (("dp", "tp"), (2, 1))
    assert out["default"] == (("dp",), (2,))
    assert "needs 3 processes, the group has 2" in out["bad"]


def test_dp_step_is_the_mean_of_the_ranks_gradients(two):
    """Each rank's half of the batch and of the global draw of t and
    noise; the step's gradients are the mean of the ranks'
    single-process gradients, the loss the mean of their losses, and the
    weights after it the same on both ranks."""
    a, b = _ok(two[0]["dp"]), _ok(two[1]["dp"])
    assert a["shard_rows"] == b["shard_rows"] == BATCH // 2
    for name, g in a["grads"].items():
        want = (a["local_grads"][name] + b["local_grads"][name]) / 2
        torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-9, msg=name)
        torch.testing.assert_close(b["grads"][name], g, rtol=0, atol=0)
    assert a["loss"] == b["loss"]
    np.testing.assert_allclose(a["loss"], (a["local_loss"] + b["local_loss"]) / 2, rtol=1e-6)
    for name, p in a["params"].items():
        torch.testing.assert_close(b["params"][name], p, rtol=0, atol=0)


def test_dp_resume_is_exact_on_every_rank(two):
    """2 steps, save, restore into a fresh state, 2 steps: the straight 4
    steps' losses and weights to the bit on both ranks (every rank draws
    the global batch's noise from the restored generator)."""
    for r in two:
        out = _ok(r["dp_resume"])
        assert out["step"] == 4
        assert out["resumed"] == out["straight"]
        assert out["max_abs_diff"] == 0.0


INVARIANT = ["dp2", "tp2", "sp2", "fsdp_dp2", "dp2_moe", "tp2_moe", "sp2_moe", "fsdp_dp2_moe"]


@pytest.mark.parametrize("mesh", INVARIANT)
def test_mesh_invariance_losses(two, mesh):
    """Two SGD steps on the mesh: the losses of the single-process step,
    rtol 1e-6, on every rank (the tolerances of the JAX package's
    ``tests/test_tp.py``)."""
    out = _ok(two[0][mesh])
    np.testing.assert_allclose(out["losses"], out["ref_losses"], rtol=1e-6)
    assert _ok(two[1][mesh])["losses"] == out["losses"]


@pytest.mark.parametrize("mesh", INVARIANT)
def test_mesh_invariance_params(two, mesh):
    """... and the weights after them, rtol 1e-5 / atol 1e-7."""
    out = _ok(two[0][mesh])
    for name, p in out["params"].items():
        torch.testing.assert_close(p, out["ref_params"][name], rtol=1e-5, atol=1e-7, msg=name)


@pytest.mark.parametrize("mesh,sharded", [
    ("dp2", []), ("sp2", []),
    ("tp2", [f"encoder.layers.{i}.{k}.{w}" for i in range(2)
             for k in ("ff1", "ff2", "key", "out", "query", "value")
             for w in ("bias", "weight") if not (k in ("ff2", "out") and w == "bias")]),
])
def test_tp_pairs_are_sharded(two, mesh, sharded):
    """tp shards the Megatron pairs of every layer (a row-parallel layer's
    bias is replicated); dp and sp shard nothing."""
    assert _ok(two[0][mesh])["sharded"] == sorted(sharded)


def test_fsdp_shards_every_weight(two):
    out = _ok(two[0]["fsdp_dp2"])
    assert out["sharded"] == sorted(out["params"])


@pytest.mark.parametrize("mesh", ["dp2_moe", "sp2_moe", "fsdp_dp2_moe"])
def test_moe_reference_drops_tokens(two, mesh):
    """The MoE cases route the global batch: the reference step drops
    tokens past the capacity, so the meshes' routing must drop the same."""
    assert min(_ok(two[0][mesh])["dropped"]) > 0


@pytest.mark.parametrize("mesh", ["dp2_tp2", "dp2_sp2", "dp2_sp2_moe"])
def test_mesh_invariance_on_four_ranks(four, mesh):
    out = _ok(four[0][mesh])
    np.testing.assert_allclose(out["losses"], out["ref_losses"], rtol=1e-6)
    for name, p in out["params"].items():
        torch.testing.assert_close(p, out["ref_params"][name], rtol=1e-5, atol=1e-7, msg=name)
    assert all(_ok(r[mesh])["losses"] == out["losses"] for r in four)


@pytest.mark.parametrize("dispatch", ["onehot", "scatter"])
def test_ep_step_matches_the_replicated_step(two, dispatch):
    """Expert parallelism over 2 ranks: exactly the 4 expert leaves hold
    half the experts, and one SGD step gives the replicated step's loss
    (rtol 1e-6) and weights (rtol 1e-5 / atol 1e-7)."""
    out = _ok(two[0][f"ep_{dispatch}"])
    leaves = [f"layers.0.moe.{k}" for k in ("w1", "b1", "w2", "b2")]
    assert out["sharded"] == leaves
    assert [out["local_shapes"][k][0] for k in leaves] == [2, 2, 2, 2]
    assert out["local_shapes"]["layers.0.moe.router.weight"] == (4, 32)
    np.testing.assert_allclose(out["loss"], out["ref_loss"], rtol=1e-6)
    for name, p in out["params"].items():
        torch.testing.assert_close(p, out["ref_params"][name], rtol=1e-5, atol=1e-7, msg=name)


@pytest.mark.parametrize("dispatch", ["onehot", "scatter"])
def test_ep_gradients_match_the_replicated_step(two, dispatch):
    """... and every gradient of that step, the attention's, the norms' and
    the router's upstream of the experts too, within 1e-5 of its scale on
    both ranks (the loss weighs the output with fixed random weights, so
    the gradient reaches through the post-norm)."""
    for r in two:
        out = _ok(r[f"ep_{dispatch}"])
        for name, g in out["grads"].items():
            want = out["ref_grads"][name]
            assert float(want.abs().max()) > 0, name
            torch.testing.assert_close(g, want, rtol=0,
                                       atol=1e-5 * float(want.abs().max()), msg=name)


@pytest.mark.parametrize("case", ["pp_2_4", "pp_2_8"])
def test_pipeline_matches_sequential(two, case):
    """GPipe over 2 stages of 4 layers with 4 and 8 microbatches: the
    output within 1e-6 of the sequential stack's on both ranks."""
    for r in two:
        out = _ok(r[case])
        assert out["n_stage"] == L_PP // 2
        torch.testing.assert_close(out["out"], out["ref_out"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["pp_2_4", "pp_2_8"])
def test_pipeline_gradients_match_sequential(two, case):
    """... the stage's parameter gradients and the input's within 1e-5."""
    for r in two:
        out = _ok(r[case])
        torch.testing.assert_close(out["x_grad"], out["ref_x_grad"], rtol=0, atol=1e-5)
        got = [g for layer in out["stage"] for g in layer.values()]
        for g, want in zip(got, out["ref_stage"]):
            torch.testing.assert_close(g, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["pp_planenet", "pp_planenet_moe"])
def test_pipelined_planenet(two, case):
    """PlaneNet's encoder in 2 stages, 4 microbatches: the model's output
    (with MoE: the model run a microbatch at a time, each routing its own
    tokens, and the aux the microbatches' mean) within 1e-5, and every
    gradient the rank holds within 1e-5 of its scale."""
    for r in two:
        out = _ok(r[case])
        assert out["stage_layers"] == 2
        torch.testing.assert_close(out["pred"], out["want"], rtol=1e-5, atol=1e-5)
        if out["aux"] is not None:
            np.testing.assert_allclose(out["aux"], out["want_aux"], rtol=1e-6)
        assert len(out["grads"]) > 0
        for name, g in out["grads"].items():
            want = out["ref_grads"][name]
            torch.testing.assert_close(g, want, rtol=0,
                                       atol=1e-5 * max(float(want.abs().max()), 1e-3), msg=name)


def test_driver_under_a_launcher(two):
    """``aircraft.main --tp 2`` on 2 ranks: 3 steps (K forced to 1), rank 0
    writes the checkpoints, ``--resume`` continues to 5 on both ranks."""
    for r in two:
        out = _ok(r["driver_tp"])
        assert (out["first"], out["resumed"], out["latest"]) == (3, 5, 5)


SPEC_SHAPES = [(64, 128), (128,), (64, 30), (64, 129), (4, 64, 2048), (2048, 512), (3, 3), ()]


@pytest.mark.parametrize("shape", SPEC_SHAPES)
def test_layout_rules_match_the_jax_package(shape):
    """``tp_kernel_spec``, ``param_spec`` (with and without fsdp) and
    ``batch_spec`` give the JAX package's specs for the same shapes."""
    import jax.numpy as jnp
    from diffusion_extensions_tpu.parallel import gspmd as jgspmd

    from diffusion_extensions_tpu_torch.parallel import gspmd

    x = torch.zeros(shape)
    jx = jnp.zeros(shape)
    for tp in (1, 2, 4):
        assert tuple(gspmd.tp_kernel_spec(x, tp)) == tuple(jgspmd.tp_kernel_spec(jx, tp))
        for dp, fsdp in ((1, False), (2, True), (4, True)):
            assert tuple(gspmd.param_spec(x, tp, dp, fsdp=fsdp)) == tuple(
                jgspmd.param_spec(jx, tp, dp, fsdp=fsdp))
    for sp in (1, 2):
        assert tuple(gspmd.batch_spec(x, sp_size=sp)) == tuple(jgspmd.batch_spec(jx, sp_size=sp))


def test_config_plumbing_matches_the_jax_package():
    """``init_from_dict`` / ``dataclass_from_dict``: the constructors get the
    keys their signatures name, as the JAX package's functions give them."""
    import dataclasses

    from diffusion_extensions_tpu.train import config as jconfig

    from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
    from diffusion_extensions_tpu_torch.train import config

    @dataclasses.dataclass
    class Opt:
        lr: float = 1.0
        steps: int = 1

    argdict = {"dim": 32, "heads": 2, "layers": 1, "moe_experts": 4, "lr": 0.5, "batch": 9}
    (model,) = config.init_from_dict(argdict, PlaneNet)
    assert model.moe_experts == 4 and len(model.encoder.layers) == 1
    assert model.encoder.layers[0].heads == 2
    made = []

    def record(dim, heads=1, *, lr=0.0):
        made.append((dim, heads, lr))

    config.init_from_dict(argdict, record)
    jconfig.init_from_dict(argdict, record)
    assert made[0] == made[1] == (32, 2, 0.5)
    assert config.dataclass_from_dict(Opt, argdict) == jconfig.dataclass_from_dict(Opt, argdict) \
        == Opt(lr=0.5)
