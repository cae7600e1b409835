"""Closed-form FLOP counts, one file per model family, and the peak rates
they are divided by.

A forward counts 2 m n k for every matrix product of the model (the
counting of ``torch.utils.flop_counter.FlopCounterMode``) and nothing for
elementwise work, normalisations, softmax or reductions.  A train step is
taken as 3 forwards (the forward, and the backward's two products per
forward product); FlopCounterMode counts less by the input gradients of
the first layers, whose inputs need none (2e-5 of the aircraft step, 2e-4
of the docking step).  Frozen copies of the port's
``diffusion_extensions_tpu_torch/flops.py``: a change to the program
cannot change what a metric divides by."""

# NVIDIA H100 SXM data sheet, dense bf16 (the configurations' matrix products)
PEAK_BF16_FLOPS = 989.4e12
PEAK_NAME = "H100 SXM dense bf16 989.4 TFLOP/s"
STEP_FORWARDS = 3
