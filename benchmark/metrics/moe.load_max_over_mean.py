"""The busiest held expert's rows over the held experts' mean, of the MoE
layers of the DeepSeek-V2 trunk: the program's device counters
(``moe.rows``, ``moe.rows_max``, ``moe.layer_steps``, ``moe.experts_held``,
each summed over the layers and the steps the run took, eager and
replayed) as sum of the maxima / sum of the means.  1 is an even load; the
grouped products of a layer wait on its busiest expert.  None where the
program keeps no such counters (no MoE layer of this kind, or a checkout
from before them)."""
from benchmark.harness import spans

LAYER = "experts"
UNIT = "x"
MOVES = "train_step_ms"


def read(ctx: dict):
    if "steps" not in ctx:
        return None
    c = spans.counters(ctx)
    if not c or not c.get("moe.rows"):
        return None
    return c["moe.rows_max"] * c["moe.experts_held"] / (c["moe.rows"] * c["moe.layer_steps"])
