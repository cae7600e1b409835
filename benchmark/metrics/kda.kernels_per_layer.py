"""Kernels a KDA mixer's forward adds to a replayed train step: the kernel,
copy and fill nodes the program reads from the graph being captured
before and after each KDA mixer's forward (``kda.graph_kernels``; its own
time stamps left out), over the forwards captured (``kda.captures``).  The
launch work of the projections, convolutions, gates and the chunked
recurrence, which a hand-written KDA kernel would fold; None where the
program counts neither."""
from benchmark.harness import spans

LAYER = "denoiser"
UNIT = "kernels"
MOVES = "train_step_ms"


def read(ctx: dict):
    if "steps" not in ctx:
        return None
    c = spans.counters(ctx)
    if not c or not c.get("kda.captures"):
        return None
    return c["kda.graph_kernels"] / c["kda.captures"]
