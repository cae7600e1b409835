"""Kernels a MoE layer's forward adds to a replayed train step: the kernel,
copy and fill nodes the program reads from the graph being captured
before and after each MoE layer's forward (``moe.graph_kernels``; its own
time stamps left out), over the forwards captured (``moe.captures``).  The
launch work of the router, the dispatch, the grouped products and the
combine; None where the program counts neither."""
from benchmark.harness import spans

LAYER = "experts"
UNIT = "kernels"
MOVES = "train_step_ms"


def read(ctx: dict):
    if "steps" not in ctx:
        return None
    c = spans.counters(ctx)
    if not c or not c.get("moe.captures"):
        return None
    return c["moe.graph_kernels"] / c["moe.captures"]
