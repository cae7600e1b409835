#!/usr/bin/env python3
"""The headline measurement of the PyTorch/CUDA port on one NVIDIA GPU:

    python bench_torch.py [--quick] [--steps N] [--no-bf16] [--headline-only]

Prints one JSON line (``diffusion_extensions_tpu_torch/bench.py`` says what
it holds).  Runs on the card; ``--device cpu`` runs the rows on the CPU.
"""
from diffusion_extensions_tpu_torch.bench import main

if __name__ == "__main__":
    main()
