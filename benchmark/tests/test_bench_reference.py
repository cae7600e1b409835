"""The reference against the port at small sizes on the CPU: the same
weights, inputs and randomness give the same numbers (float32 program,
float64 reference)."""
import numpy as np
import pytest
import torch

from benchmark.harness import files, util
from benchmark.harness import weights as wts
from benchmark.reference import adam as ref_adam
from benchmark.reference import igso3 as ref_igso3
from benchmark.reference import planenet as ref_planenet
from benchmark.reference import processes as ref_proc
from benchmark.reference import protnet as ref_protnet
from benchmark.reference.schedule import Schedule
from benchmark.tests import small
from benchmark.traffic import synthetic

CPU = torch.device("cpu")


def _cfg(name, **extra):
    return dict(files.config(name), **extra)


AIR = _cfg("planenet-d512", **small.AIRCRAFT, bf16=False)
PROT = _cfg("protnet-d1024-prod", **small.PROTEIN, bf16=False)


def _weights(cfg, seed=3):
    fam = files.family(cfg["family"])
    return fam, wts.make(fam.param_spec(cfg), seed, CPU)


def _f64(w):
    return {k: v.double() for k, v in w.items()}


@pytest.mark.parametrize("cfg", [AIR, PROT], ids=["planenet", "protnet"])
def test_spec_is_the_programs_layout(cfg):
    fam, w = _weights(cfg)
    model = fam.build_model(cfg, w, CPU)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: tuple(v.shape) for k, v in w.items()}


@pytest.mark.parametrize("name", ["planenet-d512", "protnet-d1024-prod"])
def test_spec_counts_the_full_model(name):
    """The full configuration's layout on the meta device, nothing made."""
    cfg = files.config(name)
    fam = files.family(cfg["family"])
    spec = {n: s for n, s, _ in fam.param_spec(cfg)}
    with torch.device("meta"):
        if cfg["family"] == "planenet":
            from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
            model = PlaneNet(dim=cfg["dim"], heads=cfg["heads"], layers=cfg["layers"])
        else:
            from diffusion_extensions_tpu_torch.models.protnet import ProtNet
            model = ProtNet(dim=cfg["dim"], heads=cfg["heads"], t_depth=cfg["t_depth"], c_depth=cfg["c_depth"],
                            frame_pool=True, cross_depth=2, rel_frame=True, equiv_head=True)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == spec


def test_planenet_forward():
    fam, w = _weights(AIR)
    model = fam.build_model(AIR, w, CPU)
    x = torch.randn(4, 16, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([0, 7, 30, 49])
    with torch.no_grad():
        got = model(x, t).double()
    want = ref_planenet.forward(_f64(w), AIR, x.double(), t)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_protnet_forward_with_padding():
    fam, w = _weights(PROT)
    model = fam.build_model(PROT, w, CPU)
    batch = fam.sample_inputs(PROT, np.random.default_rng(4), CPU)
    assert not batch["rec_mask"].all() and not batch["lig_mask"].all()
    t = torch.tensor([0, 5, 20, 49])
    with torch.no_grad():
        out = model(fam.program_batch(batch), t)
    got = torch.cat((out.rot_g, out.shift_g), -1).double()
    want = ref_protnet.forward(_f64(w), PROT, {k: (v.double() if v.is_floating_point() else v)
                                              for k, v in batch.items()}, t)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cfg", [AIR, PROT], ids=["planenet", "protnet"])
def test_loss_and_its_randomness(cfg):
    """The experiment's loss, drawing from a generator, against the reference's
    from its own draw of the same seed."""
    fam, w = _weights(cfg)
    model = fam.build_model(cfg, w, CPU)
    _, loss_fn = fam.build_train(cfg, model, CPU)
    pool, ref_batches = fam.train_inputs(cfg, 2, np.random.default_rng(5), CPU)
    got = float(loss_fn(torch.Generator().manual_seed(9), util.tree_map(lambda x: x[0], pool)))
    sched = Schedule(cfg["timesteps"], CPU)
    table = torch.from_numpy(ref_igso3.quantile_table(sched.eps_np))
    draw = ref_igso3.draw_step(torch.Generator().manual_seed(9), table, sched.eps, cfg["batch"], fam.SE3)
    want = float(fam.ref_loss(cfg, sched)(_f64(w), ref_batches[0], draw))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_quantile_table_is_the_programs():
    from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion

    process = ProjectedSO3Diffusion(timesteps=50, device=CPU)
    sched = Schedule(50, CPU)
    np.testing.assert_array_equal(ref_igso3.quantile_table(sched.eps_np), process.q_table.inv_cdf.numpy())
    np.testing.assert_array_equal(sched.eps.numpy(), process.schedule.sqrt_one_minus_alphas_cumprod.numpy())


def test_se3_ddim_step_and_estimate():
    from diffusion_extensions_tpu_torch.ops.se3 import AffineGrad, AffineT

    process = files.family("protnet").build_process(PROT, CPU)
    sched = Schedule(PROT["timesteps"], CPU)
    g = torch.Generator().manual_seed(2)
    rot = torch.linalg.qr(torch.randn(6, 3, 3, generator=g))[0]
    rot = rot * torch.linalg.det(rot)[:, None, None]
    shift, pred = torch.randn(6, 3, generator=g) * 5, torch.randn(6, 6, generator=g)
    t, t_prev = torch.tensor([49, 30, 20, 10, 3, 1]), torch.tensor([40, 20, 20, 5, 0, 0])
    out = process._ddim_map(lambda x, tt: AffineGrad(pred[:, :3], pred[:, 3:]), AffineT(rot, shift), t, t_prev)
    rots, sh = ref_proc.se3_ddim_step(rot.double(), shift.double(), pred.double(), t, t_prev, sched, PROT["clip_shift"])
    torch.testing.assert_close(out.shift.double(), sh, rtol=1e-5, atol=1e-4)
    near = torch.minimum(*[(out.rot.double() - r).abs().amax((-1, -2)) for r in rots])
    assert float(near.max()) < 1e-4
    est = process._x0_hat(lambda x, tt: AffineGrad(pred[:, :3], pred[:, 3:]), AffineT(rot, shift), t, None)[1]
    r0, s0 = ref_proc.se3_x0(rot.double(), shift.double(), pred.double(), t, sched, PROT["clip_shift"])
    torch.testing.assert_close(est.shift.double(), s0, rtol=1e-5, atol=1e-4)
    assert float((est.rot.double() - r0).abs().max()) < 1e-3


@pytest.mark.parametrize("impl,state", [("optax", "f32"), ("fused", "f32"), ("fused", "bf16")])
def test_adam(impl, state):
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer

    g = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(3, generator=g)}
    prog = {k: torch.nn.Parameter(v.clone()) for k, v in p.items()}
    opt = make_optimizer(list(prog.items()), 1e-3, impl=impl, state_dtype=state)
    ref = ref_adam.Adam({k: v.double().clone() for k, v in p.items()}, 1e-3)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
        for k, v in prog.items():
            v.grad = grads[k].clone()
        opt.step()
        ref.step({k: v.double() for k, v in grads.items()})
    tol = 1e-6 if state == "f32" else 3e-5
    for k in p:
        torch.testing.assert_close(prog[k].detach().double(), ref.params[k], rtol=0, atol=tol)


def test_traffic_generators_are_the_experiments_fallbacks():
    from diffusion_extensions_tpu_torch.data.pdb import synthetic_prot_pair
    from diffusion_extensions_tpu_torch.data.shapenet import synthetic_planes

    np.testing.assert_array_equal(synthetic.planes(3, 64, np.random.default_rng(7)), synthetic_planes(3, 64, seed=7))
    a, b = np.random.default_rng(8), np.random.default_rng(8)
    mine = (synthetic._chain(a, 120, np.zeros(3)), synthetic._chain(a, 60, np.array([20.0, 0.0, 0.0])))
    theirs = synthetic_prot_pair(b)
    for m, t in zip(mine, theirs):
        for x, y in zip(m, t):
            np.testing.assert_array_equal(x, y)


def test_weights_repeat_from_the_seed():
    spec = files.family("planenet").param_spec(AIR)
    a, b, c = (wts.make(spec, s, CPU) for s in (5, 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a) and not all(torch.equal(a[k], c[k]) for k in a)
    lin = a["siren.lin.weight"]
    assert float(lin.abs().max()) <= 30 * (6 / 3) ** 0.5
