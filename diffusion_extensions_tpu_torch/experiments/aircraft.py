"""Aircraft rotational alignment (counterpart of
``diffusion_extensions_tpu/experiments/aircraft.py``):

    python -m diffusion_extensions_tpu_torch.experiments.aircraft --so3 --steps 10000
    python -m diffusion_extensions_tpu_torch.experiments.aircraft --so3 --test
    python -m diffusion_extensions_tpu_torch.experiments.aircraft --test --euler-init haar
    python -m diffusion_extensions_tpu_torch.experiments.aircraft --so3 --moe-experts 4 --bf16
    torchrun --nproc_per_node 2 -m diffusion_extensions_tpu_torch.experiments.aircraft --so3 --tp 2

Training: the state is the identity rotation (``--so3``) or zero XYZ Euler
angles (the Euler arm) and ``PlaneNet`` sees the point cloud rendered
through the projection ``data @ R^T``; one step draws t and the noise
(IGSO(3) or standard normal), takes the loss of ``ProjectedSO3Diffusion``
(skew-vec) or ``ProjectedGaussianDiffusion`` (l1) and applies Adam.  Every
``--print-every`` steps the loss, the loss of a frozen validation probe
(``test_loss``) and the steps per second are logged;
checkpoints (weights, optimizer, step, generator) go to the directory
``--ckpt`` every ``--ckpt-every`` steps and at ``--steps``, and ``--resume``
continues from the newest.  ``--moe-experts E`` swaps every encoder
layer's feed-forward pair for a Switch MoE (``--moe-dispatch``); the loss
then adds 0.01 times the load-balance loss, and each logged row the
experts' token fractions on the validation probe.  ``--trunk
dsv2lite-ep8`` takes DeepSeek-V2-Lite's MLA + MoE block in place of the
encoder (``models/deepseek_v2.py``), with its width, heads, depth (1 dense
+ 4 MoE layers) and held experts (8 of 64, one rank of eight) from the
trunk, not from ``--dim`` / ``--heads`` / ``--layers``; the loss adds
0.001 times its balance loss.  ``--trunk kimilinear-ep32`` takes Kimi
Linear's hybrid block (``models/kimi_linear.py``: KDA, KDA, KDA, MLA layers
over a dense layer and sigmoid-routed MoE FFNs, 8 of 256 experts held, one
rank of 32) the same way; it has no balance loss, and its MoE layers' correction
biases move after every optimizer step and are checkpointed with the weights.

Launched by torchrun (or the ``DXT_*`` variables, ``parallel/launch.py``)
the driver joins the process group: every rank loads the same global
batch, draws t and the noise for all of it and takes its slice, and the
gradients are averaged over the ranks (``parallel/dp.py``; each rank's
MoE layers route its own slice, as the JAX package's data-parallel step
does).  ``--tp``, ``--sp`` and ``--fsdp`` take the
one-program step of ``parallel/gspmd.py`` over a ("dp", "sp", "tp") mesh
instead (eager, one step a call; its MoE layers route the global batch);
without a launcher they run in a group of one process.

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
import torch.distributed as dist

from .. import resolve_device
from ..data.shapenet import BatchLoader, ShapeNet, synthetic_planes
from ..models import deepseek_v2, kimi_linear
from ..models.planenet import PlaneNet
from ..models.projections import PointCloudProj
from ..ops.so3 import euler_to_rmat, haar_rotations, log_rmat_vec, rmat_to_aa, rmat_to_euler
from ..parallel.dp import make_dp_train_step, shard_batch
from ..parallel.launch import maybe_initialize_distributed
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
AUX_WEIGHT = 0.01  # the JAX driver's weight of the MoE load-balance loss
# --trunk: the DeepSeek-V2 and Kimi Linear presets
TRUNKS = {**deepseek_v2.TRUNKS, **kimi_linear.TRUNKS}


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


def build(args, device):
    """(model, process); the model's init is seeded by ``args.seed``."""
    torch.manual_seed(args.seed)
    model = PlaneNet(dim=args.dim, heads=args.heads, layers=args.layers, bf16=args.bf16,
                     moe_experts=args.moe_experts, moe_dispatch=args.moe_dispatch,
                     trunk=TRUNKS.get(args.trunk))
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


def make_loss_fn(model, process, so3: bool = True, aux_weight: float | None = None):
    """``loss_fn(generator, batch)``: the process's loss of the clean state
    seen through the batch's clouds.  ``batch`` is the clouds (B, N, 3), or
    ``(clouds, t, noise)`` to fix the timesteps and the noise.  With MoE
    layers, ``aux_weight`` (None: the model's ``aux_weight``, else
    AUX_WEIGHT) times the mean over the loss's model calls of the
    load-balance loss (summed over the layers) is added; a weight of 0
    adds nothing."""
    if aux_weight is None:
        aux_weight = getattr(model, "aux_weight", AUX_WEIGHT)
    moe = getattr(model, "moe_experts", 0) > 0 and aux_weight != 0

    def loss_fn(generator, batch):
        clouds, t, noise = batch if isinstance(batch, (tuple, list)) else (batch, None, None)
        aux = []

        def denoise(x, t):
            out = model(x, t)
            if moe:
                aux.append(model.moe_aux())
            return out

        base = process.loss(denoise, generator, true_pos(clouds.shape[0], so3, clouds.device),
                            PointCloudProj(clouds, so3=so3), t=t, noise=noise)
        if aux:
            base = base + aux_weight * sum(aux) / len(aux)
        return base

    return loss_fn


def draw_t_noise(process, generator, b: int, so3: bool = True):
    """The timesteps and the noise ``process.loss`` draws for a batch of
    ``b``, in its order: t uniform on [0, T), then IGSO(3) or standard
    normal noise."""
    t = torch.randint(0, process.num_timesteps, (b,), generator=generator, device=process.device)
    if so3:
        return t, process.sample_noise(generator, t)
    return t, torch.randn((b, 3), generator=generator, device=process.device)


def make_global_loss_fn(model, process, shards, so3: bool = True,
                        aux_weight: float | None = None):
    """The loss of a step over ranks: the global batch's clouds in, t and
    noise drawn for all of it from the generator every rank holds alike,
    then this rank's slice through ``make_loss_fn``.  ``shards`` is the
    ("dp", "sp", "tp") mesh of the one-program step (``parallel/gspmd.py``:
    rows over "dp", points over "sp") or the "dp" process group of the
    data-parallel step (rows)."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..parallel.gspmd import shard_global_batch

    inner = make_loss_fn(model, process, so3, aux_weight)

    def loss_fn(generator, clouds):
        t, noise = draw_t_noise(process, generator, clouds.shape[0], so3)
        if isinstance(shards, DeviceMesh):
            local = shard_global_batch(shards, (clouds, t, noise), seq_dims=(0,))
        else:
            local = shard_batch((clouds, t, noise), shards)
        return inner(generator, tuple(local))

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
    """The native threaded loader where it builds, else the numpy loader.
    In a process group of several ranks the native loader runs one worker
    thread, so that every rank draws the same global batches (the order of
    two threads' batches is the order they finish in)."""
    if not args.no_native:
        try:
            from ..data.native import NativeBatchLoader

            ranks = dist.get_world_size() if dist.is_initialized() else 1
            loader = NativeBatchLoader(train_data, args.batch, samples=args.samples,
                                       seed=args.seed, n_threads=2 if ranks == 1 else 1,
                                       device=device)
            print("using native threaded batch loader")
            return loader
        except (OSError, subprocess.CalledProcessError) as e:
            # a host data loader, not a device path: the reference's own fallback
            print(f"native loader unavailable ({e}); using numpy loader")
    return iter(BatchLoader(train_data, args.batch, samples=args.samples,
                            seed=args.seed, device=device))


def make_mesh_for(args, device):
    """The ("dp", "sp", "tp") mesh of ``--tp`` / ``--sp`` / ``--fsdp`` over
    the process group (a group of one process when no launcher made one)."""
    from ..parallel.mesh import make_mesh

    if args.sp > 1 and args.samples % args.sp:
        raise SystemExit(f"--sp {args.sp} does not divide --samples {args.samples}; "
                         "sequence parallelism needs a divisible points axis")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % (args.sp * args.tp):
        raise SystemExit(f"--sp {args.sp} --tp {args.tp} need a multiple of {args.sp * args.tp} "
                         f"processes, the group has {world}: launch with torchrun "
                         f"--nproc_per_node {args.sp * args.tp}")
    if not dist.is_initialized():  # train() ends it
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh([("dp", -1), ("sp", args.sp), ("tp", args.tp)], device.type)


def train(args) -> TrainState:
    device = resolve_device(args.device)
    maybe_initialize_distributed(device)
    if device.type == "cuda" and dist.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    model, process = build(args, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"PlaneNet params: {n_params/1e6:.2f}M")
    K = max(args.steps_per_call, 1)
    gspmd = args.tp > 1 or args.sp > 1 or args.fsdp
    own_group = gspmd and not dist.is_initialized()
    mesh = make_mesh_for(args, device) if gspmd else None
    if gspmd:
        from ..parallel.gspmd import shard_params

        shard_params(model, mesh, fsdp=args.fsdp)
    optimizer = make_optimizer(
        model.named_parameters(), args.lr, clip=args.clip, schedule=args.lr_schedule,
        total_steps=args.steps, impl=args.opt_impl, state_dtype=args.opt_state_dtype,
    )
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = TrainState(model, optimizer, generator)
    if args.resume:
        state = restore_checkpoint(args.ckpt, state)

    group = None
    if gspmd:
        from ..parallel.gspmd import make_gspmd_train_step, shard_global_batch

        if K != 1:
            print("--tp/--sp/--fsdp uses steps_per_call=1")
            K = 1
        step_fn = make_gspmd_train_step(make_global_loss_fn(model, process, mesh, args.so3),
                                        model, optimizer, mesh, fsdp=args.fsdp)
    else:
        group = dist.group.WORLD if dist.is_initialized() else None
        loss_fn = (make_loss_fn(model, process, args.so3) if group is None
                   else make_global_loss_fn(model, process, group, args.so3))
        step_fn = make_dp_train_step(
            loss_fn, model, optimizer, steps_per_call=K,
            log_norms=args.log_norms or args.log_norms_per_layer,
            per_layer_norms=args.log_norms_per_layer, group=group,
        )
    # the loader is seeded anew at a resume, as the reference's is; every
    # rank draws the same global batches
    loader = make_loader(load_data("train", args), args, device)

    # frozen validation probe: fixed (t, noise, clouds); under sp each rank
    # holds its slice of the points
    v_clouds = subsample_points(load_data("valid", args)[: args.batch], args.samples,
                                args.seed + 29)
    t_v = torch.randint(0, process.num_timesteps, (len(v_clouds),), device=device,
                        generator=torch.Generator(device=device).manual_seed(7))
    noise_gen = torch.Generator(device=device).manual_seed(8)
    if args.so3:
        noise_v = process.q_table.sample(noise_gen, t_v)
    else:
        noise_v = torch.randn((len(v_clouds), 3), generator=noise_gen, device=device)
    v_clouds = torch.from_numpy(v_clouds).to(device)
    if gspmd:
        (v_clouds,) = shard_global_batch(mesh, (v_clouds,), seq_dims=(0,), dp_axis=None)
    val_loss = make_val_probe(model, process, v_clouds, t_v, noise_v, args.so3)
    expert_fracs = model.expert_fracs if model.moe_experts > 0 else None

    lead = not dist.is_initialized() or dist.get_rank() == 0
    logger = MetricLogger(jsonl_path=args.log if lead else None,
                          print_every=args.print_every if lead else 0)
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
                if expert_fracs is not None:  # of the probe's forward just run
                    fr = expert_fracs().cpu().numpy()  # (layers, E)
                    row["expert_frac_min"] = float(fr.min())
                    row["expert_frac_max"] = float(fr.max())
                    row["expert_fracs"] = [[round(float(v), 4) for v in layer] for layer in fr]
                logger.log(i, row)
            if i % args.ckpt_every == 0 or i == args.steps:
                save_checkpoint(args.ckpt, state)
    finally:
        logger.close()
        if hasattr(loader, "close"):
            loader.close()  # join the native worker threads
        if own_group:
            dist.destroy_process_group()
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
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh size (Megatron pairs; one-program step)")
    p.add_argument("--fsdp", action="store_true",
                   help="FSDP2 over the dp axis: weights and Adam moments sharded at rest")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel mesh size: the points axis split over 'sp'")
    p.add_argument("--moe-experts", dest="moe_experts", type=int, default=0,
                   help="swap every encoder FFN for a Switch MoE with this many experts "
                        "(models/moe.py); 0 = dense")
    p.add_argument("--trunk", default="transformer", choices=("transformer", *TRUNKS),
                   help="the denoiser's trunk: the reference's post-norm encoder (--dim, --heads, "
                        "--layers, --moe-experts) or a trunk of models/deepseek_v2.py or "
                        "models/kimi_linear.py TRUNKS, which brings its own sizes")
    p.add_argument("--moe-dispatch", dest="moe_dispatch", default="scatter",
                   choices=("onehot", "scatter"),
                   help="MoE token dispatch: (T, E, C) one-hot einsums or slot scatter")
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
