"""Host seconds the program spent capturing and instantiating its train
step's CUDA graph (``train.capture_ns``: the capture's clone of the batch,
the capture and the instantiation), a part of ``setup_s``; None where the
program counts no capture."""
from benchmark.harness import spans

LAYER = "train step"
UNIT = "s"
MOVES = "setup_s"


def read(ctx: dict):
    if "steps" not in ctx:
        return None
    c = spans.counters(ctx)
    if not c or not c.get("train.captures"):
        return None
    return c["train.capture_ns"] / 1e9
