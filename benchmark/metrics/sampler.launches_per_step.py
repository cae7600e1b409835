"""Device kernels the profiler records in a sampling stretch, over its
sampler steps (the final x_0 estimate's forward counts with its chain):
a count, the host's launch work that the sampler's time follows."""
LAYER = "sampler"
UNIT = "launches/step"
MOVES = "sample_s"


def read(ctx: dict):
    if "sampler_steps" not in ctx:
        return None
    return ctx["kernels"] / ctx["sampler_steps"]
