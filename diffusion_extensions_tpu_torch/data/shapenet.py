"""ShapeNet point clouds, their synthetic stand-in and the host batcher
(counterpart of ``diffusion_extensions_tpu/data/shapenet.py``; numpy on the
host, so batches are the JAX package's to the bit for the same seed)."""
from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

__all__ = ["ShapeNet", "synthetic_planes", "BatchLoader", "HostToDevice"]

_SPLIT_FILES = {
    "train": "train_files.txt",
    "valid": "val_files.txt",
    "test": "test_files.txt",
}


class ShapeNet:
    """Point clouds (M, 2048, 3) of the given class labels (aircraft = 0)
    from the shapenetcorev2 HDF5 distribution under ``root``.

    Raises ``FileNotFoundError`` when the split's file list is absent, and
    ``ImportError`` when the files are there but ``h5py`` is not installed.
    """

    def __init__(self, datatype: str, ids=(0,),
                 root: str = "data/shapenetcorev2_hdf5_2048"):
        if isinstance(ids, int):
            ids = (ids,)
        if datatype not in _SPLIT_FILES:
            raise ValueError(f"wrong dataset type specified: {datatype}")
        with open(os.path.join(root, _SPLIT_FILES[datatype])) as f:
            files = [x.strip("\n") for x in f.readlines()]
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"ShapeNet files found under {root}, but reading them needs "
                "h5py, which is not installed"
            ) from e
        clouds = []
        for file in files:
            if not os.path.isabs(file) and not os.path.exists(file):
                file = os.path.join(os.path.dirname(root), file)
            with h5py.File(file, "r") as f:
                labels = np.asarray(f["label"]).reshape(-1)
                keep = np.isin(labels, ids)
                if keep.any():
                    clouds.append(np.asarray(f["data"])[keep].astype(np.float32))
        self.data = np.concatenate(clouds, axis=0)

    def __len__(self) -> int:
        return len(self.data)


def synthetic_planes(n: int = 1024, points: int = 2048, seed: int = 0) -> np.ndarray:
    """Aircraft-like synthetic clouds (n, points, 3) float32, unit-sphere
    normalised like ShapeNet: fuselage, swept wings mounted forward, a nose
    cluster, a tall rear fin and a tailplane, so that no non-identity
    rotation maps the shape near itself."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, points, 3), dtype=np.float32)
    for i in range(n):
        n_fus = (2 * points) // 5
        n_wing = points // 3
        n_nose = points // 10
        n_fin = points // 10
        n_tail = points - n_fus - n_wing - n_nose - n_fin
        fx = rng.uniform(-1.0, 1.0, n_fus)
        taper = 0.04 + 0.03 * (fx + 1.0) / 2.0
        fus = np.stack(
            [fx, rng.normal(0, 1.0, n_fus) * taper,
             rng.normal(0, 1.0, n_fus) * taper],
            axis=-1,
        )
        wy = rng.uniform(-0.9, 0.9, n_wing)
        wing = np.stack(
            [
                0.25 - 0.45 * np.abs(wy) + rng.normal(0, 0.05, n_wing),
                wy,
                rng.normal(0.02, 0.02, n_wing),
            ],
            axis=-1,
        )
        nose = np.stack(
            [
                1.0 - np.abs(rng.normal(0, 0.08, n_nose)),
                rng.normal(0, 0.03, n_nose),
                rng.normal(0, 0.03, n_nose),
            ],
            axis=-1,
        )
        fin = np.stack(
            [
                rng.uniform(-1.0, -0.8, n_fin),
                rng.normal(0, 0.02, n_fin),
                rng.uniform(0.0, 0.5, n_fin),
            ],
            axis=-1,
        )
        ty = rng.uniform(-0.35, 0.35, n_tail)
        tail = np.stack(
            [
                rng.normal(-0.9, 0.04, n_tail),
                ty,
                rng.normal(0.05, 0.02, n_tail),
            ],
            axis=-1,
        )
        cloud = np.concatenate([fus, wing, nose, fin, tail], axis=0)
        cloud -= cloud.mean(axis=0, keepdims=True)
        cloud /= np.abs(cloud).max()
        out[i] = cloud
    return out


class HostToDevice:
    """Moves host batches of one shape to ``device``.  For a CUDA device the
    batch is staged in one of two rotating pinned buffers and copied with
    ``non_blocking=True`` on the current stream, where the step that reads
    it is ordered after it; a buffer is rewritten only after the event
    recorded behind its last copy has passed.  For the CPU (or ``None``)
    the batch is wrapped as it is."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self._pinned: list = []
        self._events: list = []
        self._turn = 0

    def __call__(self, batch: np.ndarray) -> torch.Tensor:
        if self.device is None or self.device.type != "cuda":
            return torch.from_numpy(batch)
        if not self._pinned or self._pinned[0].shape != batch.shape:
            self._pinned = [torch.empty(batch.shape, dtype=torch.float32).pin_memory()
                            for _ in range(2)]
            self._events = [None, None]
        i = self._turn
        self._turn = 1 - i
        if self._events[i] is not None:
            self._events[i].synchronize()
        self._pinned[i].numpy()[...] = batch
        out = self._pinned[i].to(self.device, non_blocking=True)
        self._events[i] = torch.cuda.Event()
        self._events[i].record()
        return out


class BatchLoader:
    """Vectorised host batcher: shuffle, per-batch point subsampling, and
    one batch of device prefetch (the copy of batch i + 1 is queued before
    batch i is handed out).  Yields (batch, samples, 3) float32 tensors on
    ``device`` (host tensors when it is ``None``)."""

    def __init__(
        self,
        data: np.ndarray,
        batch: int,
        samples: Optional[int] = None,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        device=None,
    ):
        self.data = data
        self.batch = batch
        self.samples = samples
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._put = HostToDevice(device)

    def _make_batch(self, idx: np.ndarray) -> np.ndarray:
        clouds = self.data[idx]  # (B, P, 3)
        if self.samples is not None and self.samples < clouds.shape[1]:
            cols = self.rng.integers(
                0, clouds.shape[1], size=(len(idx), self.samples)
            )
            clouds = np.take_along_axis(clouds, cols[..., None], axis=1)
        return clouds

    def epoch(self) -> Iterator[torch.Tensor]:
        order = np.arange(len(self.data))
        if self.shuffle:
            self.rng.shuffle(order)
        end = len(order) - (len(order) % self.batch if self.drop_last else 0)
        pending = None
        for i in range(0, end, self.batch):
            batch = self._put(self._make_batch(order[i : i + self.batch]))
            if pending is not None:
                yield pending
            pending = batch
        if pending is not None:
            yield pending

    def __iter__(self):
        while True:
            yield from self.epoch()
