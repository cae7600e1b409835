"""Kernels a replayed train step runs: the kernel, copy and fill nodes of
the step's CUDA graph (a replay runs a copy node as a kernel), read by the
program from the graph as it was captured (``train.graph_kernels``; its
own time stamps left out), over the graphs captured (``train.captures``).
A count of the launch work the step's time follows where kernels are
short; None where the program counts neither."""
from benchmark.harness import spans

LAYER = "train step"
UNIT = "kernels"
MOVES = "train_step_ms"


def read(ctx: dict):
    if "steps" not in ctx:
        return None
    c = spans.counters(ctx)
    if not c or not c.get("train.captures"):
        return None
    return c["train.graph_kernels"] / c["train.captures"]
