"""The cells' inputs, made from the seed on the host in NumPy: aircraft
point clouds and padded receptor / ligand pairs.

Frozen copies of the port's synthetic generators (``data/shapenet.py``
``synthetic_planes``, ``data/pdb.py`` ``synthetic_prot_pair``,
``random_affine_np``, ``move_prots_np`` and the padding), which the
experiments fall back to without ShapeNet or BPTI_dock, so that a change to
the program cannot change what the benchmark feeds it.  The pairs' chain
lengths are drawn (``min_*_len`` up to the padded length), so that the
masks and the padding do work as real pairs make them."""
from __future__ import annotations

import numpy as np

RES_COUNT = 21


def planes(n: int, points: int, rng: np.random.Generator) -> np.ndarray:
    """(n, points, 3) float32 aircraft-like clouds, unit-sphere normalised:
    fuselage, swept wings, nose, tall fin and tailplane."""
    out = np.empty((n, points, 3), dtype=np.float32)
    for i in range(n):
        n_fus, n_wing = (2 * points) // 5, points // 3
        n_nose = n_fin = points // 10
        n_tail = points - n_fus - n_wing - n_nose - n_fin
        fx = rng.uniform(-1.0, 1.0, n_fus)
        taper = 0.04 + 0.03 * (fx + 1.0) / 2.0
        fus = np.stack([fx, rng.normal(0, 1.0, n_fus) * taper, rng.normal(0, 1.0, n_fus) * taper], -1)
        wy = rng.uniform(-0.9, 0.9, n_wing)
        wing = np.stack([0.25 - 0.45 * np.abs(wy) + rng.normal(0, 0.05, n_wing), wy,
                         rng.normal(0.02, 0.02, n_wing)], -1)
        nose = np.stack([1.0 - np.abs(rng.normal(0, 0.08, n_nose)), rng.normal(0, 0.03, n_nose),
                         rng.normal(0, 0.03, n_nose)], -1)
        fin = np.stack([rng.uniform(-1.0, -0.8, n_fin), rng.normal(0, 0.02, n_fin),
                        rng.uniform(0.0, 0.5, n_fin)], -1)
        ty = rng.uniform(-0.35, 0.35, n_tail)
        tail = np.stack([rng.normal(-0.9, 0.04, n_tail), ty, rng.normal(0.05, 0.02, n_tail)], -1)
        cloud = np.concatenate([fus, wing, nose, fin, tail], 0)
        cloud -= cloud.mean(0, keepdims=True)
        out[i] = cloud / np.abs(cloud).max()
    return out


def _chain(rng: np.random.Generator, n: int, center) -> tuple:
    """One-hot residues (n, 21), C-alpha positions spread 8 A about
    ``center``, unit orthonormal frames (n, 3, 3)."""
    res = np.zeros((n, RES_COUNT), np.float32)
    res[np.arange(n), rng.integers(0, RES_COUNT - 1, n)] = 1.0
    pos = (rng.standard_normal((n, 3)) * 8.0 + center).astype(np.float32)
    v1 = rng.standard_normal((n, 3)).astype(np.float32)
    v1 /= np.linalg.norm(v1, axis=-1, keepdims=True)
    v2 = rng.standard_normal((n, 3)).astype(np.float32)
    v2 -= (v1 * v2).sum(-1, keepdims=True) * v1
    v2 /= np.linalg.norm(v2, axis=-1, keepdims=True)
    return res, pos, np.stack((v1, v2, np.cross(v1, v2)), 1)


def prot_pairs(n: int, cfg: dict, rng: np.random.Generator) -> list:
    """``n`` receptor / ligand pairs (receptor about the origin, ligand
    about (20, 0, 0)) with lengths drawn in [min, padded length]."""
    pairs = []
    for _ in range(n):
        nr = int(rng.integers(cfg["min_receptor_len"], cfg["receptor_len"] + 1))
        nl = int(rng.integers(cfg["min_ligand_len"], cfg["ligand_len"] + 1))
        pairs.append((_chain(rng, nr, np.zeros(3)), _chain(rng, nl, np.array([20.0, 0.0, 0.0]))))
    return pairs


def _augment(pair, rng: np.random.Generator):
    """Both chains moved together about their joint centroid by a Haar-QR
    rotation and a unit normal shift (the training augmentation)."""
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    rot, shift = q.astype(np.float32), rng.standard_normal(3).astype(np.float32)
    mean = np.concatenate([c[1] for c in pair], 0).mean(0, keepdims=True)
    return tuple((res, ((pos - mean) @ rot.T + mean + shift).astype(np.float32),
                  (frames @ rot.T).astype(np.float32)) for res, pos, frames in pair)


def _pad(chains: list, length: int) -> dict:
    b = len(chains)
    out = {"res": np.zeros((b, length, RES_COUNT), np.float32), "pos": np.zeros((b, length, 3), np.float32),
           "frames": np.zeros((b, length, 3, 3), np.float32), "mask": np.zeros((b, length), bool)}
    for i, (res, pos, frames) in enumerate(chains):
        k = len(pos)
        out["res"][i, :k], out["pos"][i, :k], out["frames"][i, :k] = res, pos, frames
        out["mask"][i, :k] = True
    return out


def prot_batch(pairs: list, cfg: dict, rng: np.random.Generator) -> dict:
    """One batch of every pair in a fresh order, each augmented, padded to
    the configuration's lengths: a dict of ``rec_*`` / ``lig_*`` arrays."""
    chosen = [_augment(pairs[j], rng) for j in rng.permutation(len(pairs))]
    rec = _pad([c[0] for c in chosen], cfg["receptor_len"])
    lig = _pad([c[1] for c in chosen], cfg["ligand_len"])
    return {**{"rec_" + k: v for k, v in rec.items()}, **{"lig_" + k: v for k, v in lig.items()}}
