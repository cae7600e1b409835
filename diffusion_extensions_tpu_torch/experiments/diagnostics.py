"""Diagnostics and figures, the reference's analysis scripts as one CLI
(counterpart of ``diffusion_extensions_tpu/experiments/diagnostics.py``):

    python -m diffusion_extensions_tpu_torch.experiments.diagnostics sphere-probs
    python -m diffusion_extensions_tpu_torch.experiments.diagnostics interp
    python -m diffusion_extensions_tpu_torch.experiments.diagnostics se3-path
    python -m diffusion_extensions_tpu_torch.experiments.diagnostics bingham-render
    python -m diffusion_extensions_tpu_torch.experiments.diagnostics aircraft-diags
    python -m diffusion_extensions_tpu_torch.experiments.diagnostics prot-diags
    python -m diffusion_extensions_tpu_torch.experiments.diagnostics pdb-path

* ``sphere-probs``: the IGSO(3) density painted on spheres for six eps.
* ``interp``: the Euler traces and sphere frames of the geodesic lock
  segment.
* ``se3-path``: the forward SE(3) noising path of ``--samples`` identity
  poses over ``--steps`` steps (step i draws from ``IGSO3xR3`` about the
  pose scaled by sqrt(1 - beta_i), eps = beta_i, the process's
  ``shift_scale``), written as ``se3_paths.npz``.
* ``bingham-render``: sphere scatters of 1024 draws of each Bingham preset.
* ``aircraft-diags`` / ``prot-diags``: percentile rows and sorted-error
  curves of the Euler and SO(3) / SE(3) result files in ``--results-dir``.
* ``pdb-path``: the ligand of each PDB pair in ``--data-root`` moved along
  an ``se3_paths.npz`` trajectory, frame by frame, and a PyMOL script that
  renders the frames.

Everything goes to ``--out-dir`` (default ``torch_results/``).  The
figures need matplotlib; ``se3-path`` and ``pdb-path`` do not.  The
subcommands that compute (``se3-path``, ``interp``, ``bingham-render``) run
on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

from .. import resolve_device

PERCENTILES = (1, 5, 10, 50, 90, 95, 99)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def sphere_probs(args) -> str:
    from ..viz.sphere import plot_igso3_density_spheres

    out = os.path.join(args.out_dir, "sphere_probs.png")
    os.makedirs(args.out_dir, exist_ok=True)
    plot_igso3_density_spheres(np.logspace(-2, 0.5, 6), out_path=out)
    print(f"wrote {out}")
    return out


def interp_path(device) -> torch.Tensor:
    """(1000, 3, 3): the geodesic from R(0, pi/3, 0) to R(0, 2pi/3, 0)."""
    from ..data.synthetic import lock_segment_endpoints
    from ..ops.so3 import so3_lerp

    r1, r2 = lock_segment_endpoints(device)
    return so3_lerp(r1, r2, torch.linspace(0, 1, 1000, device=device)[:, None])


def interp(args) -> np.ndarray:
    """Euler traces of the geodesic lock segment, and its frames on the sphere."""
    from ..ops.so3 import rmat_to_euler
    from ..viz.colors import BLUE, GREEN, ORANGE
    from ..viz.mpl import setup_pi_axis
    from ..viz.sphere import plot_rotation_frames

    plt = _pyplot()
    path = interp_path(resolve_device(args.device))
    series = [s.cpu().numpy() for s in rmat_to_euler(path)]
    path = path.cpu().numpy()
    fig, axlist = plt.subplots(nrows=3, ncols=1, sharex=True)
    for ax, values, c in zip(axlist, series, (BLUE, ORANGE, GREEN)):
        ax.plot(values, c=c)
        setup_pi_axis(ax)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "interp_euler_traces.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    plot_rotation_frames(path[::20], out_path=os.path.join(args.out_dir, "interp_sphere.png"))
    print(f"wrote {out} and interp_sphere.png")
    return path


def se3_path(args) -> tuple[np.ndarray, np.ndarray]:
    """The forward SE(3) noising path: (rots (S+1, N, 3, 3), shifts (S+1, N, 3))."""
    from ..ops.igso3 import IGSO3xR3
    from ..ops.se3 import AffineT, se3_scale
    from ..processes.se3 import SE3Diffusion

    device = resolve_device(args.device)
    process = SE3Diffusion.create(timesteps=args.steps, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    x = AffineT.identity((args.samples,), device=device)
    rots, shifts = [x.rot], [x.shift]
    for i in range(args.steps):
        beta_t = process.schedule.betas[i]
        mean = se3_scale(x, torch.sqrt(1.0 - beta_t).expand(args.samples))
        dist = IGSO3xR3.create(beta_t.expand(args.samples), mean=mean,
                               shift_scale=process.shift_scale, device=device)
        x = dist.sample(gen)
        rots.append(x.rot)
        shifts.append(x.shift)
    rots, shifts = torch.stack(rots).cpu().numpy(), torch.stack(shifts).cpu().numpy()
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "se3_paths.npz")
    np.savez(out, rots=rots, shifts=shifts)
    print(f"wrote {out}: {len(rots)} steps x {args.samples} samples")
    return rots, shifts


def bingham_render(args) -> list[str]:
    """Sphere scatter of 1024 draws of each Bingham preset."""
    from ..data.synthetic import BINGHAM_COVS, bingham_dist
    from ..ops.so3 import quat_to_rmat
    from ..viz.sphere import plot_rotation_frames

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for acro in sorted(BINGHAM_COVS):
        gen = torch.Generator(device=device).manual_seed(0)
        rots = quat_to_rmat(bingham_dist(acro, device=device).sample(gen, (1024,)))
        out = os.path.join(args.out_dir, f"{acro}.png")
        plot_rotation_frames(rots, out_path=out, title=acro)
        print(f"wrote {out}")
        written.append(out)
    return written


def _percentile_table(name, values, pcts=PERCENTILES) -> np.ndarray:
    """Print the LaTeX rows of the sorted values at ``pcts``; returns them sorted."""
    vals = np.sort(np.ravel(values))
    idxs = [int(len(vals) * p / 100) for p in pcts]
    print("percentiles " + " ".join(f"& {p}%" for p in pcts) + r" \\")
    print(name + " " + " ".join(f"& {vals[i]:.2f}" for i in idxs) + r" \\")
    return vals


def aircraft_diags(args) -> str:
    """Euler against SO(3): ``results_aircraft_{eul,so3}.npy`` angle errors."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    for diff_type in ("eul", "so3"):
        path = os.path.join(args.results_dir, f"results_aircraft_{diff_type}.npy")
        if not os.path.exists(path):
            print(f"missing {path}, skipping")
            continue
        vals = _percentile_table(diff_type, np.load(path))
        ax.plot(vals, label={"eul": "euler", "so3": "so3"}[diff_type])
    ax.legend()
    ax.set_ylabel("angle error (rad)")
    ax.set_xlabel("sorted sample index")
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "aircraft_diags.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def prot_diags(args) -> list[str]:
    """SE(3) against Euler docking: ``prot_samples_{eul,se3}.json`` angles and shifts."""
    plt = _pyplot()
    figs = {metric: plt.subplots() for metric in ("angles", "shifts")}
    for diff_type in ("eul", "se3"):
        path = os.path.join(args.results_dir, f"prot_samples_{diff_type}.json")
        if not os.path.exists(path):
            print(f"missing {path}, skipping")
            continue
        with open(path) as f:
            data = json.load(f)
        for metric, (_, ax) in figs.items():
            vals = _percentile_table(f"{diff_type}-{metric}", np.asarray(data[metric]))
            ax.plot(vals, label=diff_type)
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for metric, (fig, ax) in figs.items():
        ax.legend()
        ax.set_xlabel("sorted sample index")
        ax.set_ylabel(metric)
        out = os.path.join(args.out_dir, f"prot_diags_{metric}.png")
        fig.savefig(out, dpi=150)
        plt.close(fig)
        print(f"wrote {out}")
        written.append(out)
    return written


_PML = """\
# PyMOL batch render of the noised docking trajectories
# usage: pymol -cq render_path.pml
python
from glob import glob
import os
from pymol import cmd
base = {base!r}
for rec in sorted(glob(os.path.join(base, '*_receptors.pdb'))):
    prefix = os.path.basename(rec)[:4]
    cmd.delete('all'); cmd.load(rec); cmd.color('gray70')
    for lig in sorted(glob(os.path.join(base, prefix + '_ligand_*.pdb'))):
        name = os.path.splitext(os.path.basename(lig))[0]
        cmd.load(lig); cmd.color('tv_red', name)
        cmd.ray(1600, 1200)
        cmd.png(os.path.join(base, name + '.png'))
        cmd.delete(name)
python end
"""


def pdb_path(args) -> str:
    """Each pair's receptor, its ligand moved to every ``--frames``-th pose
    of one ``se3_paths.npz`` sample (shifts x 40 A), and the PyMOL script."""
    from ..data.pdb import ProtPairDataset, transform_pdb

    paths = np.load(args.se3_paths)
    rots, shifts = paths["rots"], paths["shifts"]  # (S+1, N, 3, 3), (S+1, N, 3)
    ds = ProtPairDataset(args.data_root)
    os.makedirs(args.out_dir, exist_ok=True)
    n = min(len(ds.prots), rots.shape[1])
    stride = max(1, rots.shape[0] // args.frames)
    for i in range(n):
        prot = ds.prots[i]
        lig = ds.basepath / f"{prot}_ligand.pdb"
        shutil.copy2(ds.basepath / f"{prot}_receptors.pdb",
                     os.path.join(args.out_dir, f"{prot}_receptors.pdb"))
        for step in range(0, rots.shape[0], stride):
            out = os.path.join(args.out_dir, f"{prot}_ligand_{step:04d}.pdb")
            transform_pdb(lig, out, rots[step, i], shifts[step, i] * 40.0)
        print(f"wrote trajectory for {prot}")
    pml = os.path.join(args.out_dir, "render_path.pml")
    with open(pml, "w") as f:
        f.write(_PML.format(base=args.out_dir))
    print(f"wrote {pml}")
    return pml


COMMANDS = {
    "sphere-probs": sphere_probs,
    "interp": interp,
    "se3-path": se3_path,
    "bingham-render": bingham_render,
    "aircraft-diags": aircraft_diags,
    "prot-diags": prot_diags,
    "pdb-path": pdb_path,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Diagnostics & figure generation")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in COMMANDS:
        sp = sub.add_parser(name)
        sp.add_argument("--out-dir", dest="out_dir", default="torch_results")
        if name in ("se3-path", "interp", "bingham-render"):
            sp.add_argument("--device", type=str, default=None,
                            help="torch device (default: cuda)")
        if name == "se3-path":
            sp.add_argument("--samples", type=int, default=14)
            sp.add_argument("--steps", type=int, default=1000)
        if name in ("aircraft-diags", "prot-diags"):
            sp.add_argument("--results-dir", dest="results_dir", default="weights")
        if name == "pdb-path":
            sp.add_argument("--se3-paths", dest="se3_paths",
                            default="torch_results/se3_paths.npz")
            sp.add_argument("--data-root", dest="data_root", default="data/BPTI_dock")
            sp.add_argument("--frames", type=int, default=100)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    main()
