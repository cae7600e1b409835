"""The program's own counters (``diffusion_extensions_tpu_torch.obs``) as
a traced run leaves them: ``ctx["spans"]["counters"]`` where the loop put a
snapshot into the trace context, else the program's live counters, read in
the run's own process after its window.  None where the program has no
such module (a checkout from before it)."""
from __future__ import annotations


def counters(ctx: dict):
    if "spans" in ctx:
        return ctx["spans"]["counters"]
    try:
        from diffusion_extensions_tpu_torch import obs
    except ImportError:
        return None
    return obs.snapshot()["counters"]
