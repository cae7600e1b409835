"""How far the held experts' rows lie from their even share of the
choices, of the MoE layers of the DeepSeek-V2 and Kimi Linear trunks:
|rows / rows_even - 1|, from the program's device counters ``moe.rows``
(the rows the held experts took) and ``moe.rows_even`` (T k held / E a
layer step), each summed over the layers and the steps the run took,
eager and replayed.  0 is a rank that gets its share of the tokens; a
rank above its share is the expert-parallel step's straggler, one below
it idles while others take its rows, so lower is better either way.
None where the program keeps no such counters (no MoE layer of this kind,
or a checkout from before ``moe.rows_even``)."""
from benchmark.harness import spans

LAYER = "experts"
UNIT = "x"
MOVES = "train_step_ms"


def read(ctx: dict):
    if "steps" not in ctx:
        return None
    c = spans.counters(ctx)
    if not c or not c.get("moe.rows_even"):
        return None
    return abs(c["moe.rows"] / c["moe.rows_even"] - 1.0)
