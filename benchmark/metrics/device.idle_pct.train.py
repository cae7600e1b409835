"""The share of the profiler's stretch of a training window in which no
operation ran on the card: 100 x (1 - the union of the device's operation
intervals / the stretch's wall time).  Both come from the traced stretch:
busy time set against the untraced wall time of a replayed step reads
about 0, or below it, as the kernels' traced durations are a little
longer than their untraced ones.  Under the profiler the stretch of a
replayed step is longer than an untraced step by about as much as the
share reads, so it counts mostly the gaps that tracing each of the graph's
kernels opens: it follows the kernels a step, not the untraced idle time."""
LAYER = "device"
UNIT = "%"
MOVES = "train_step_ms"


def read(ctx: dict):
    if "steps" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
