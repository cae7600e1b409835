"""Aircraft rotational alignment (counterpart of
``diffusion_extensions_tpu/experiments/aircraft.py``):

    python -m diffusion_extensions_tpu_torch.experiments.aircraft --so3 --steps 10000
    python -m diffusion_extensions_tpu_torch.experiments.aircraft --so3 --test
    python -m diffusion_extensions_tpu_torch.experiments.aircraft --test --euler-init haar

Training: the state is the identity rotation (``--so3``) or zero XYZ Euler
angles (the Euler arm) and ``PlaneNet`` sees the point cloud rendered
through the projection ``data @ R^T``; one step draws t and the noise
(IGSO(3) or standard normal), takes the loss of ``ProjectedSO3Diffusion``
(skew-vec) or ``ProjectedGaussianDiffusion`` (l1) and applies Adam.  Every
``--print-every`` steps the loss, the loss of a frozen validation probe
(``test_loss``) and the steps per second are logged;
checkpoints (weights, optimizer, step, generator) go to the directory
``--ckpt`` every ``--ckpt-every`` steps and at ``--steps``, and ``--resume``
continues from the newest.

``--test`` samples SAMPLES_PER_SHAPE rotations per test shape with the
ancestral chain and prints the angle-error percentile table.  The Euler
arm's chain starts from the Euler angles of Haar-QR matrices
(``--euler-init haar``, the reference's) or from the forward marginal
sqrt(1 - acp_{T-1}) N(0, 1) (``marginal``), and its angles are decoded to a
rotation at the end.  Its weights are the newest checkpoint of the
directory ``--ckpt`` (or a bare ``torch.save`` state dict of PlaneNet at
that path, which ``convert.planenet_params_from_flax`` makes from a JAX
checkpoint); without either the seeded init is evaluated.

Falls back to ``synthetic_planes`` when the ShapeNet files are absent.  Runs
on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import os
import subprocess

import numpy as np
import torch

from .. import resolve_device
from ..data.shapenet import BatchLoader, ShapeNet, synthetic_planes
from ..models.planenet import PlaneNet
from ..models.projections import PointCloudProj
from ..ops.so3 import euler_to_rmat, haar_rotations, log_rmat_vec, rmat_to_aa, rmat_to_euler
from ..parallel.dp import make_dp_train_step
from ..processes.r3 import ProjectedGaussianDiffusion
from ..processes.schedule import extract
from ..processes.so3 import ProjectedSO3Diffusion
from ..train.loop import MetricLogger, Throughput, trace_window
from ..train.optim import add_optim_flags, make_optimizer
from ..train.state import (
    TrainState,
    load_eval_weights,
    restore_checkpoint,
    save_checkpoint,
)

SAMPLES_PER_SHAPE = 8
PERCENTILES = (1, 5, 10, 50, 90, 95, 99)
# flags of the JAX driver that the port parses and does not serve yet:
# (flag, its default, where ROADMAP.md queues it)
NOT_PORTED = (
    ("tp", 1, "A.8 (scale-out: DTensor tp)"),
    ("sp", 1, "A.8 (scale-out: sequence parallelism)"),
    ("fsdp", False, "A.8 (scale-out: FSDP2)"),
    ("moe_experts", 0, "A.8 (scale-out: models/moe.py)"),
)


def load_data(split: str, args) -> np.ndarray:
    try:
        return ShapeNet(split, (0,), root=args.data_root).data
    except (FileNotFoundError, OSError):
        n = 1024 if split == "train" else 128
        seed = {"train": 0, "valid": 1, "test": 2}[split]
        print(f"ShapeNet not found under {args.data_root}; "
              f"using synthetic_planes({n}) for split={split}")
        return synthetic_planes(n, seed=seed)


def subsample_points(clouds: np.ndarray, samples: int, seed: int) -> np.ndarray:
    """Random per-shape point subsample (not a head slice: the synthetic
    generator fills parts in order, so a head slice is the fuselage only)."""
    if clouds.shape[1] <= samples:
        return clouds
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, clouds.shape[1], size=(len(clouds), samples))
    return np.take_along_axis(clouds, cols[..., None], axis=1)


def check_ported(args) -> None:
    for name, default, item in NOT_PORTED:
        if getattr(args, name) != default:
            raise SystemExit(
                f"--{name.replace('_', '-')} is not ported yet: ROADMAP.md {item}"
            )


def build(args, device):
    """(model, process); the model's init is seeded by ``args.seed``."""
    check_ported(args)
    torch.manual_seed(args.seed)
    model = PlaneNet(dim=args.dim, heads=args.heads, layers=args.layers, bf16=args.bf16)
    model = model.to(device)
    if args.so3:
        process = ProjectedSO3Diffusion(timesteps=args.timesteps, device=device)
    else:
        process = ProjectedGaussianDiffusion(timesteps=args.timesteps, device=device)
    return model, process


def true_pos(b: int, so3: bool, device) -> torch.Tensor:
    """The clean state: identity rotations, or zero Euler angles."""
    if so3:
        return torch.eye(3, device=device).expand(b, 3, 3)
    return torch.zeros((b, 3), device=device)


def make_loss_fn(model, process, so3: bool = True):
    """``loss_fn(generator, batch)``: the process's loss of the clean state
    seen through the batch's clouds.  ``batch`` is the clouds (B, N, 3), or
    ``(clouds, t, noise)`` to fix the timesteps and the noise."""

    def loss_fn(generator, batch):
        clouds, t, noise = batch if isinstance(batch, (tuple, list)) else (batch, None, None)
        return process.loss(model, generator, true_pos(clouds.shape[0], so3, clouds.device),
                            PointCloudProj(clouds, so3=so3), t=t, noise=noise)

    return loss_fn


def make_val_probe(model, process, clouds: torch.Tensor, t_v: torch.Tensor,
                   noise_v: torch.Tensor, so3: bool = True):
    """The frozen validation probe: fixed clouds, timesteps and noise;
    ``val_loss()`` is the denoiser's MSE against the frozen target (the
    scaled log of the rotation noise, or the normal noise itself), taken
    without gradients and without changing the model's mode."""
    truepos = true_pos(clouds.shape[0], so3, clouds.device)
    x_in = PointCloudProj(clouds, so3=so3)(process.q_sample(truepos, t_v, noise_v))
    if so3:
        eps_v = extract(process.schedule.sqrt_one_minus_alphas_cumprod, t_v)
        target_v = log_rmat_vec(noise_v) / eps_v[..., None]
    else:
        target_v = noise_v

    def val_loss() -> torch.Tensor:
        with torch.no_grad():
            return torch.mean((model(x_in, t_v) - target_v) ** 2)

    return val_loss


def make_loader(train_data: np.ndarray, args, device):
    """The native threaded loader where it builds, else the numpy loader."""
    if not args.no_native:
        try:
            from ..data.native import NativeBatchLoader

            loader = NativeBatchLoader(train_data, args.batch, samples=args.samples,
                                       seed=args.seed, n_threads=2, device=device)
            print("using native threaded batch loader")
            return loader
        except (OSError, subprocess.CalledProcessError) as e:
            # a host data loader, not a device path: the reference's own fallback
            print(f"native loader unavailable ({e}); using numpy loader")
    return iter(BatchLoader(train_data, args.batch, samples=args.samples,
                            seed=args.seed, device=device))


def train(args) -> TrainState:
    device = resolve_device(args.device)
    model, process = build(args, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"PlaneNet params: {n_params/1e6:.2f}M")
    optimizer = make_optimizer(
        model.named_parameters(), args.lr, clip=args.clip, schedule=args.lr_schedule,
        total_steps=args.steps, impl=args.opt_impl, state_dtype=args.opt_state_dtype,
    )
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = TrainState(model, optimizer, generator)
    if args.resume:
        state = restore_checkpoint(args.ckpt, state)

    K = max(args.steps_per_call, 1)
    step_fn = make_dp_train_step(
        make_loss_fn(model, process, args.so3), model, optimizer, steps_per_call=K,
        log_norms=args.log_norms or args.log_norms_per_layer,
        per_layer_norms=args.log_norms_per_layer,
    )
    # the loader is seeded anew at a resume, as the reference's is
    loader = make_loader(load_data("train", args), args, device)

    # frozen validation probe: fixed (t, noise, clouds)
    v_clouds = subsample_points(load_data("valid", args)[: args.batch], args.samples,
                                args.seed + 29)
    t_v = torch.randint(0, process.num_timesteps, (len(v_clouds),), device=device,
                        generator=torch.Generator(device=device).manual_seed(7))
    noise_gen = torch.Generator(device=device).manual_seed(8)
    if args.so3:
        noise_v = process.q_table.sample(noise_gen, t_v)
    else:
        noise_v = torch.randn((len(v_clouds), 3), generator=noise_gen, device=device)
    val_loss = make_val_probe(model, process, torch.from_numpy(v_clouds).to(device),
                              t_v, noise_v, args.so3)

    logger = MetricLogger(jsonl_path=args.log, print_every=args.print_every)
    meter = Throughput()
    profile_step = trace_window(args.profile_dir) if args.profile_dir else None
    try:
        i = state.step
        while i < args.steps:
            if profile_step is not None:
                profile_step(i)
            k = min(K, args.steps - i)  # the tail is exact
            if K == 1:
                batch = next(loader)
            else:
                batch = torch.stack([next(loader) for _ in range(k)])
            state, metrics = step_fn(state, batch)
            for _ in range(k):
                meter.tick()
            i += k
            if i % args.print_every == 0:
                row = {name: float(v) for name, v in metrics.items()}
                row["test_loss"] = float(val_loss())
                row["steps_per_sec"] = meter.steps_per_sec or float("nan")
                logger.log(i, row)
            if i % args.ckpt_every == 0 or i == args.steps:
                save_checkpoint(args.ckpt, state)
    finally:
        logger.close()
        if hasattr(loader, "close"):
            loader.close()  # join the native worker threads
    return state


def print_percentiles(res: np.ndarray, diff_type: str) -> None:
    res_sorted = np.sort(res)
    idxs = [int(len(res_sorted) * p / 100) for p in PERCENTILES]
    print(f"{len(res)} samples ({diff_type}); angle-error percentiles (rad):")
    print("percentiles " + " ".join(f"& {p}%" for p in PERCENTILES) + r" \\")
    print(diff_type + " " + " ".join(f"& {res_sorted[i]:.2f}" for i in idxs) + r" \\")


def sample_rotations(process, model, gen, proj, args) -> torch.Tensor:
    """One ancestral chain per shape of the batch -> (B, 3, 3).  The Euler
    arm starts from ``--euler-init``: the Euler angles of Haar-QR matrices
    (det +-1, as the reference draws them), or sqrt(1 - acp_{T-1}) times a
    standard normal; its angles are decoded at the end."""
    if args.so3:
        return process.p_sample_loop(model, gen, (args.batch,), proj)
    if args.euler_init == "marginal":
        sig_t = process.schedule.sqrt_one_minus_alphas_cumprod[-1]
        x_init = sig_t * torch.randn((args.batch, 3), generator=gen, device=gen.device)
    else:
        x_init = torch.stack(rmat_to_euler(haar_rotations(gen, (args.batch,))), dim=-1)
    eul = process.p_sample_loop(model, gen, (args.batch, 3), projection=proj, x_init=x_init)
    return euler_to_rmat(eul[..., 0], eul[..., 1], eul[..., 2])


@torch.inference_mode()
def test(args):
    """Per-shape SAMPLES_PER_SHAPE-sample angle-error percentile table."""
    device = resolve_device(args.device)
    model, process = build(args, device)
    model.eval()
    if not load_eval_weights(model, args.ckpt, device):
        print(f"warning: no checkpoint found at {args.ckpt}; evaluating untrained model")

    test_data = subsample_points(load_data("test", args), args.samples, args.seed + 17)
    results = []
    for b in range(0, len(test_data), args.batch):
        batch_np = test_data[b : b + args.batch]
        n_valid = len(batch_np)
        if n_valid < args.batch:
            # pad the ragged tail to the full batch shape
            pad = np.repeat(batch_np[-1:], args.batch - n_valid, axis=0)
            batch_np = np.concatenate([batch_np, pad], axis=0)
        proj = PointCloudProj(torch.from_numpy(batch_np).to(device), so3=args.so3)
        for s in range(SAMPLES_PER_SHAPE):
            gen = torch.Generator(device=device)
            gen.manual_seed((args.seed + 1) * 1_000_003 + b * 100 + s)
            rots = sample_rotations(process, model, gen, proj, args)
            _, angle = rmat_to_aa(rots)
            results.append(angle[:n_valid, 0].cpu().numpy())
        if args.max_shapes and b + args.batch >= args.max_shapes:
            break

    res = np.concatenate(results)
    diff_type = "so3" if args.so3 else "eul"
    if not args.so3 and args.euler_init != "haar":
        diff_type = f"eul_{args.euler_init}"
    out_dir = os.path.dirname(args.ckpt) or "."
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"results_aircraft_{diff_type}.npy"), res)
    print_percentiles(res, diff_type)
    return res


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Aircraft rotation args")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    add_optim_flags(p)
    p.add_argument("--samples", type=int, default=256)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--so3", action="store_true",
                   help="SO(3) diffusion (without: the Euler-angle arm)")
    p.add_argument("--bf16", action="store_true",
                   help="run the transformer encoder under bf16 autocast")
    p.add_argument("--no-native", dest="no_native", action="store_true",
                   help="disable the C++ threaded batch loader")
    p.add_argument("--steps-per-call", dest="steps_per_call", type=int,
                   default=1, help="run K optimizer steps per call of the step function")
    p.add_argument("--tp", type=int, default=1, help="not ported yet")
    p.add_argument("--fsdp", action="store_true", help="not ported yet")
    p.add_argument("--sp", type=int, default=1, help="not ported yet")
    p.add_argument("--moe-experts", dest="moe_experts", type=int, default=0,
                   help="not ported yet")
    p.add_argument("--moe-dispatch", dest="moe_dispatch", default="scatter",
                   choices=("onehot", "scatter"), help="with --moe-experts")
    p.add_argument("--log-norms", dest="log_norms", action="store_true",
                   help="log grad/param global norms")
    p.add_argument("--log-norms-per-layer", dest="log_norms_per_layer",
                   action="store_true",
                   help="additionally log one grad norm per top-level "
                        "module as grad_norm/<module> JSONL keys (implies "
                        "--log-norms)")
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--steps", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-root", dest="data_root", type=str,
                   default="data/shapenetcorev2_hdf5_2048")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint directory (--test also takes a bare "
                        "torch.save state dict of PlaneNet)")
    p.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=1000)
    p.add_argument("--print-every", dest="print_every", type=int, default=10)
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--profile-dir", dest="profile_dir", type=str, default=None,
                   help="capture a torch.profiler trace of steps 50-60 here")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--debug-nans", dest="debug_nans", action="store_true",
                   help="enable torch.autograd.set_detect_anomaly")
    p.add_argument("--test", action="store_true")
    p.add_argument("--euler-init", dest="euler_init",
                   choices=("haar", "marginal"), default="haar",
                   help="chain init of the Euler arm at --test: the Euler angles of "
                        "Haar-QR matrices (the reference's), or the forward marginal "
                        "sqrt(1 - acp_{T-1}) N(0, 1)")
    p.add_argument("--max-shapes", dest="max_shapes", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.ckpt is None:
        args.ckpt = f"weights/aircraft_{'so3' if args.so3 else 'eul'}"
    return args


def main(argv=None):
    args = parse_args(argv)
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        return test(args) if args.test else train(args)


if __name__ == "__main__":
    main()
