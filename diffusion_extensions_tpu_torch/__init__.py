"""PyTorch/CUDA port of ``diffusion_extensions_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout (``ops/``, ``processes/``,
``models/``, ``data/``, ``experiments/``) so each module has an obvious
counterpart.  It imports torch and numpy only: never JAX, and nothing from
the JAX package.

Every rotation product runs in true float32.  TF32 keeps ~3 decimal digits,
which would drift rotation matrices off SO(3) over a 1000-step chain; this is
the counterpart of the JAX package's ``MM = Precision.HIGHEST``.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller passes ``device``."""
    return torch.device("cuda" if device is None else device)
