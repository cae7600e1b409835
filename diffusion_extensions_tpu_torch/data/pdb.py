"""PDB parsing and protein batches (counterpart of
``diffusion_extensions_tpu/data/pdb.py``, a numpy copy of it).

A fixed-column ATOM-record parser (PDB v3.3) gives each residue's one-hot
class over the 21-class vocabulary, its C-alpha position and a local frame
from the C-CA / N-CA bond directions and their cross product.  Ragged
protein pairs are collated on the host, in numpy, into static-shape masked
``ProtBatch`` arrays; ``to_device`` moves such a batch to the device in one
copy.  ``synthetic_prot_pair`` makes pairs for runs without the BPTI_dock
files.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models.projections import ProtBatch
from ..ops.se3 import ProtData

__all__ = [
    "UNIQUE_RESIDUES",
    "RES_COUNT",
    "parse_pdb_residues",
    "pdb_to_rigid_gas",
    "ProtPairDataset",
    "pad_prot_batch",
    "synthetic_prot_pair",
    "transform_pdb",
    "random_affine_np",
    "move_prots_np",
    "to_device",
]

UNIQUE_RESIDUES = [
    "ALA", "CYS", "ASP", "GLU", "PHE", "GLY", "HIS", "ILE", "LYS", "LEU",
    "MET", "ASN", "PRO", "GLN", "ARG", "SER", "THR", "VAL", "TRP", "TYR",
    "---",  # unknown / padding
]
RES_COUNT = len(UNIQUE_RESIDUES)
_UNKNOWN = UNIQUE_RESIDUES.index("---")


def parse_pdb_residues(pdbfile) -> List[dict]:
    """ATOM records -> ordered residues, each a dict of atom name -> xyz
    plus ``resname``.  Columns: name 13-16, altloc 17, resname 18-20, chain
    22, resseq 23-26, icode 27, x/y/z 31-54.  Only the first model and the
    primary conformation (altloc blank or "A") are read."""
    residues: List[dict] = []
    current_key = None
    current: dict | None = None
    with open(pdbfile) as f:
        for line in f:
            if not line.startswith("ATOM"):
                if line.startswith("ENDMDL"):
                    break
                continue
            name = line[12:16].strip()
            altloc = line[16]
            if altloc not in (" ", "A"):
                continue
            resname = line[17:20].strip()
            key = (line[21], line[22:27])  # chain, resseq + icode
            xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            if key != current_key:
                current = {"resname": resname}
                residues.append(current)
                current_key = key
            current.setdefault(name, xyz)
    return residues


def pdb_to_rigid_gas(pdbfile, strict: bool = False) -> ProtData:
    """PDB file -> ProtData of numpy arrays.  Residues without all of CA, C
    and N are dropped; an unknown residue name is the "---" class, or
    raises with ``strict``."""
    residues = [r for r in parse_pdb_residues(pdbfile) if all(k in r for k in ("CA", "C", "N"))]
    n = len(residues)
    one_hot = np.zeros((n, RES_COUNT), dtype=np.float32)
    pos = np.zeros((n, 3), dtype=np.float32)
    vecs = np.zeros((n, 3, 3), dtype=np.float32)
    for i, res in enumerate(residues):
        name = res["resname"]
        if name in UNIQUE_RESIDUES:
            one_hot[i, UNIQUE_RESIDUES.index(name)] = 1.0
        elif strict:
            raise ValueError(f"unknown residue {name!r} in {pdbfile}")
        else:
            one_hot[i, _UNKNOWN] = 1.0
        ca = np.asarray(res["CA"], dtype=np.float32)
        pos[i] = ca
        v1 = np.asarray(res["C"], dtype=np.float32) - ca
        v2 = np.asarray(res["N"], dtype=np.float32) - ca
        v1 /= np.linalg.norm(v1)
        v2 /= np.linalg.norm(v2)
        vecs[i] = np.stack((v1, v2, np.cross(v1, v2)), axis=0)
    return ProtData(one_hot, pos, vecs)


class ProtPairDataset:
    """(receptor, ligand) ProtData pairs from ``<id>_receptors.pdb`` /
    ``<id>_ligand.pdb`` files of one directory, ids sorted."""

    def __init__(self, path):
        self.basepath = Path(path)
        self.prots = sorted(
            {x[:4] for x in os.listdir(path)
             if x.endswith("pdb") and ("receptors" in x or "ligand" in x)}
        )

    def __len__(self):
        return len(self.prots)

    def __getitem__(self, idx) -> Tuple[ProtData, ProtData]:
        receptor = pdb_to_rigid_gas(self.basepath / (self.prots[idx] + "_receptors.pdb"))
        ligand = pdb_to_rigid_gas(self.basepath / (self.prots[idx] + "_ligand.pdb"))
        return receptor, ligand


def _pad_stack(prots: Sequence[ProtData], length: int | None = None):
    lengths = [p.positions.shape[0] for p in prots]
    L = length or max(lengths)
    b = len(prots)
    res = np.zeros((b, L, RES_COUNT), dtype=np.float32)
    pos = np.zeros((b, L, 3), dtype=np.float32)
    ang = np.zeros((b, L, 3, 3), dtype=np.float32)
    mask = np.zeros((b, L), dtype=bool)
    for i, p in enumerate(prots):
        n = lengths[i]
        res[i, :n] = p.residues
        pos[i, :n] = p.positions
        ang[i, :n] = p.angles
        mask[i, :n] = True
    return ProtData(res, pos, ang), mask


def pad_prot_batch(
    pairs: Sequence[Tuple[ProtData, ProtData]],
    receptor_len: int | None = None,
    ligand_len: int | None = None,
) -> ProtBatch:
    """Ragged pairs -> a static-shape masked ProtBatch of numpy arrays;
    fixed bucket lengths keep every batch one shape."""
    rec, r_mask = _pad_stack([r for r, _ in pairs], receptor_len)
    lig, l_mask = _pad_stack([l for _, l in pairs], ligand_len)
    return ProtBatch(rec, lig, r_mask, l_mask)


def synthetic_prot_pair(
    rng: np.random.Generator, n_rec: int = 120, n_lig: int = 60
) -> Tuple[ProtData, ProtData]:
    """A random rigid-gas pair at realistic scales: C-alpha positions spread
    8 A about the origin (receptor) and (20, 0, 0) (ligand), unit frames."""

    def mk(n, center):
        one_hot = np.zeros((n, RES_COUNT), dtype=np.float32)
        one_hot[np.arange(n), rng.integers(0, RES_COUNT - 1, n)] = 1.0
        pos = (rng.standard_normal((n, 3)) * 8.0 + center).astype(np.float32)
        v1 = rng.standard_normal((n, 3)).astype(np.float32)
        v1 /= np.linalg.norm(v1, axis=-1, keepdims=True)
        v2 = rng.standard_normal((n, 3)).astype(np.float32)
        v2 -= (v1 * v2).sum(-1, keepdims=True) * v1
        v2 /= np.linalg.norm(v2, axis=-1, keepdims=True)
        vecs = np.stack((v1, v2, np.cross(v1, v2)), axis=1)
        return ProtData(one_hot, pos, vecs)

    return mk(n_rec, np.zeros(3)), mk(n_lig, np.array([20.0, 0.0, 0.0]))


def transform_pdb(in_path, out_path, rot: np.ndarray, shift: np.ndarray):
    """Rewrite a PDB file with every ATOM/HETATM coordinate moved by
    ``x -> x @ rot^T + shift``; all other columns kept byte for byte."""
    rot = np.asarray(rot, dtype=np.float64)
    shift = np.asarray(shift, dtype=np.float64)
    out_lines = []
    with open(in_path) as f:
        for line in f:
            if line.startswith(("ATOM", "HETATM")) and len(line) >= 54:
                xyz = np.array([float(line[30:38]), float(line[38:46]), float(line[46:54])])
                nx, ny, nz = xyz @ rot.T + shift
                line = line[:30] + f"{nx:8.3f}{ny:8.3f}{nz:8.3f}" + line[54:]
            out_lines.append(line)
    with open(out_path, "w") as f:
        f.writelines(out_lines)


def random_affine_np(rng: np.random.Generator):
    """Haar-QR rotation and unit normal shift (the training augmentation)."""
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return q.astype(np.float32), rng.standard_normal(3).astype(np.float32)


def move_prots_np(rot: np.ndarray, shift: np.ndarray, prots):
    """Move proteins together about their shared centroid (host numpy)."""
    all_pos = np.concatenate([np.asarray(p.positions) for p in prots], axis=0)
    mean = all_pos.mean(axis=0, keepdims=True)
    out = []
    for p in prots:
        pos = (np.asarray(p.positions) - mean) @ rot.T + mean + shift
        ang = np.asarray(p.angles) @ rot.T
        out.append(ProtData(p.residues, pos.astype(np.float32), ang.astype(np.float32)))
    return out


def _flatten(batch) -> list:
    if isinstance(batch, tuple):
        return [leaf for v in batch for leaf in _flatten(v)]
    return [batch]


def _unflatten(template, leaves):
    if isinstance(template, tuple):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    return next(leaves)


def to_device(batch, device) -> ProtBatch:
    """A (nested) NamedTuple of numpy arrays -> the same of tensors on
    ``device``.  On a CUDA device every leaf is packed into one pinned host
    buffer (16-byte aligned slots) and moved by one asynchronous copy; the
    leaves are views of the device buffer."""
    device = torch.device(device)
    arrays = [np.ascontiguousarray(a) for a in _flatten(batch)]
    if device.type != "cuda":
        return _unflatten(batch, iter([torch.from_numpy(a).to(device) for a in arrays]))
    slots = [(a.nbytes + 15) // 16 * 16 for a in arrays]
    host = torch.empty(sum(slots), dtype=torch.uint8, pin_memory=True)
    view = host.numpy()
    offsets = np.concatenate(([0], np.cumsum(slots)))
    for a, off in zip(arrays, offsets):
        view[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    leaves = []
    for a, off in zip(arrays, offsets):
        if a.dtype not in (np.bool_, np.float32):
            raise TypeError(f"to_device: unexpected leaf dtype {a.dtype}")
        dtype = torch.bool if a.dtype == np.bool_ else torch.float32
        leaves.append(dev[off : off + a.nbytes].view(dtype).reshape(a.shape))
    return _unflatten(batch, iter(leaves))
