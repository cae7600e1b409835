"""The sampler's denoiser forwards' share of the card's bf16 peak: the
forwards a call x the frozen closed-form FLOPs of a forward, over the
wall time a call takes in the window outside the profiler's stretch."""
from benchmark.flops import PEAK_BF16_FLOPS

LAYER = "denoiser"
UNIT = "%"
MOVES = "sample_s"


def read(ctx: dict):
    if "forwards" not in ctx:
        return None
    return 100.0 * ctx["forwards"] / ctx["calls"] * ctx["flops_forward"] / ctx["wall_per_call_s"] / PEAK_BF16_FLOPS
