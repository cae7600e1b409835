"""The port's numpy copy of ``data/pdb.py`` against the JAX package's, on a
mini PDB written by the test: every array bit-equal.  Also the port's
``to_device`` (one copy of a nested batch)."""
import os

import numpy as np
import pytest
import torch

from diffusion_extensions_tpu.data import pdb as jpdb
from diffusion_extensions_tpu.models import protnet as jprotnet
from diffusion_extensions_tpu_torch.data import pdb
from diffusion_extensions_tpu_torch.models.projections import ProtBatch
from diffusion_extensions_tpu_torch.ops.se3 import ProtData


def _atom(serial, name, resname, resseq, xyz, chain="A", altloc=" ", icode=" ",
          record="ATOM"):
    x, y, z = xyz
    return (f"{record:<6}{serial:>5} {' ' + name:<4}{altloc}{resname:>3} {chain}"
            f"{resseq:>4}{icode}   {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           "
            f"{name[0]}\n")


def _mini_pdb(path, seed=0, n_res=6, chain="A"):
    """Residues with N/CA/C/O, one unknown residue name, one residue
    without C (dropped), an insertion code, an altloc B atom (skipped), a
    HETATM, a second model after ENDMDL (ignored)."""
    rng = np.random.default_rng(seed)
    names = ["ALA", "GLY", "XYZ", "TRP", "SER", "LYS", "MET", "HIS"]
    lines, serial = ["HEADER    TEST\n"], 1
    for i in range(n_res):
        base = rng.standard_normal(3) * 5
        atoms = ["N", "CA", "C", "O"] if i != 3 else ["N", "CA", "O"]
        for a in atoms:
            lines.append(_atom(serial, a, names[i % len(names)], i + 1,
                               base + rng.standard_normal(3), chain=chain,
                               altloc="A" if a == "CA" and i == 1 else " "))
            serial += 1
            if a == "CA" and i == 1:
                lines.append(_atom(serial, "CA", names[1], i + 1, base + 9.0, chain=chain,
                                   altloc="B"))
                serial += 1
    for a in ("N", "CA", "C"):  # an insertion code makes a residue of its own
        lines.append(_atom(serial, a, "VAL", n_res, rng.standard_normal(3) * 5, chain=chain,
                           icode="A"))
        serial += 1
    lines.append(_atom(serial, "O", "HOH", 99, (1.0, 2.0, 3.0), chain=chain, record="HETATM"))
    lines += ["ENDMDL\n", "MODEL        2\n",
              _atom(serial + 1, "CA", "ALA", 1, (0.0, 0.0, 0.0), chain=chain), "END\n"]
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def _equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        if isinstance(b, tuple):
            _equal(a, b)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype


def test_vocabulary_is_the_jax_package_s():
    assert pdb.UNIQUE_RESIDUES == jprotnet.UNIQUE_RESIDUES
    assert pdb.RES_COUNT == jprotnet.RES_COUNT == 21


def test_parse_and_rigid_gas(tmp_path):
    path = _mini_pdb(tmp_path / "x.pdb")
    ours, ref = pdb.parse_pdb_residues(path), jpdb.parse_pdb_residues(path)
    assert ours == ref
    assert len(ours) == 7  # 6 residues + the insertion code; model 2 not read
    assert ours[1]["CA"] != (9.0,) and all("resname" in r for r in ours)
    gas, jgas = pdb.pdb_to_rigid_gas(path), jpdb.pdb_to_rigid_gas(path)
    assert isinstance(gas, ProtData)
    _equal(gas, jgas)
    assert gas.positions.shape == (6, 3)  # the residue without C is dropped
    assert gas.residues[2, pdb.UNIQUE_RESIDUES.index("---")] == 1.0
    with pytest.raises(ValueError, match="XYZ"):
        pdb.pdb_to_rigid_gas(path, strict=True)


def test_pair_dataset(tmp_path):
    for i, pid in enumerate(("2abc", "1xyz")):
        _mini_pdb(tmp_path / f"{pid}_receptors.pdb", seed=i, n_res=6)
        _mini_pdb(tmp_path / f"{pid}_ligand.pdb", seed=10 + i, n_res=4, chain="B")
    (tmp_path / "notes.txt").write_text("not a pdb")
    ds, jds = pdb.ProtPairDataset(tmp_path), jpdb.ProtPairDataset(tmp_path)
    assert ds.prots == jds.prots == ["1xyz", "2abc"]
    assert len(ds) == 2
    for i in range(2):
        _equal(ds[i], jds[i])


@pytest.mark.parametrize("lengths", [(None, None), (130, 70)])
def test_pad_and_synthetic_pairs(lengths):
    pairs = [pdb.synthetic_prot_pair(np.random.default_rng(3), 120 - 7 * i, 60 - 5 * i)
             for i in range(4)]
    jpairs = [jpdb.synthetic_prot_pair(np.random.default_rng(3), 120 - 7 * i, 60 - 5 * i)
              for i in range(4)]
    for p, q in zip(pairs, jpairs):
        _equal(p, q)
    batch, jbatch = pdb.pad_prot_batch(pairs, *lengths), jpdb.pad_prot_batch(jpairs, *lengths)
    assert isinstance(batch, ProtBatch)
    _equal(batch, jbatch)
    assert batch.receptor_mask.sum(1).tolist() == [120, 113, 106, 99]


def test_random_affine_and_move(tmp_path):
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        rot, shift = pdb.random_affine_np(rng)
        jrot, jshift = jpdb.random_affine_np(jrng)
        np.testing.assert_array_equal(rot, jrot)
        np.testing.assert_array_equal(shift, jshift)
    pair = pdb.synthetic_prot_pair(np.random.default_rng(1), 20, 10)
    moved, jmoved = pdb.move_prots_np(rot, shift, pair), jpdb.move_prots_np(rot, shift, pair)
    for p, q in zip(moved, jmoved):
        _equal(p, q)
    src = _mini_pdb(tmp_path / "in.pdb")
    pdb.transform_pdb(src, tmp_path / "ours.pdb", rot, shift)
    jpdb.transform_pdb(src, tmp_path / "ref.pdb", rot, shift)
    assert (tmp_path / "ours.pdb").read_bytes() == (tmp_path / "ref.pdb").read_bytes()
    assert os.path.getsize(src) == os.path.getsize(tmp_path / "ours.pdb")


def test_to_device_keeps_structure_and_bits():
    """On the CPU a plain conversion; the packed pinned copy is the card's
    (tests/test_torch_cuda.py)."""
    pairs = [pdb.synthetic_prot_pair(np.random.default_rng(i), 12, 7) for i in range(3)]
    batch = pdb.pad_prot_batch(pairs, 14, 9)
    stacked = ProtBatch(*(ProtData(*(np.stack([a, a]) for a in p)) if isinstance(p, tuple)
                          else np.stack([p, p]) for p in batch))
    for b in (batch, stacked):
        dev = pdb.to_device(b, "cpu")
        assert isinstance(dev, ProtBatch) and isinstance(dev.ligand, ProtData)
        assert dev.receptor_mask.dtype == torch.bool
        _equal(dev, b)
