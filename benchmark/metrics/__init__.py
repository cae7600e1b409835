"""Per-layer metrics, one reader a file (``<metric name>.py``): ``LAYER``,
``UNIT``, ``MOVES`` and ``read(ctx)``, which returns the metric from a
``--trace 1`` run, or None where the run holds nothing for it.

``ctx`` holds what the profiler's stretch of the window saw: ``busy_s``
(the union of the device's operation intervals), ``window_s`` (its wall
time), ``kernels`` (device kernels), ``device_ops`` and ``idle_gaps``; a
training run also ``steps`` (in the stretch), ``flops_step`` and
``wall_per_step_s``, a sampling run ``calls``, ``sampler_steps`` and
``forwards`` (in the stretch), ``flops_forward`` and ``wall_per_call_s``.
The wall times a step or call are those of the window's calls outside
the stretch: the profiler adds some 11 us of host time to each launch,
which nearly doubles a launch-bound call, so the MFU readers and the
sampler's idle reader divide by them; the training idle reader stays
inside the stretch (its docstring says why)."""
