"""The train step's share of the card's bf16 peak: the frozen closed-form
FLOPs a step (3 forwards) over the wall time a step takes in the window
outside the profiler's stretch."""
from benchmark.flops import PEAK_BF16_FLOPS

LAYER = "train step"
UNIT = "%"
MOVES = "train_step_ms"


def read(ctx: dict):
    if "steps" not in ctx:
        return None
    return 100.0 * ctx["flops_step"] / ctx["wall_per_step_s"] / PEAK_BF16_FLOPS
