"""The share of a sampling call's wall time in which no operation ran on
the card: 100 x (1 - device busy time a call / wall time a call).  The
busy time is the union of the device's operation intervals over the
profiler's stretch, a call's share of it; the wall time is that of the
window's calls outside the stretch, since the profiler adds some 11 us of
host time to each launch and so stretches a launch-bound call by 70% or
more.  What the profiler adds to the kernels' own durations is counted as
busy, so the share reads low by that much."""
LAYER = "device"
UNIT = "%"
MOVES = "sample_s"


def read(ctx: dict):
    if "sampler_steps" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["calls"] / ctx["wall_per_call_s"])
