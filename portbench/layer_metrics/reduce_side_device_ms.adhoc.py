"""Device time of the kernels launched inside the port's `bgp.reduce_side`
step spans, a query answered, in ms: as `mapsin_device_ms.adhoc`, for the
planner's reduce-side join steps (`portbench/program_trace.py`)."""
from portbench import program_trace


def read(ctx):
    pt = program_trace.of(ctx)
    return None if pt is None else pt.per_answer(ctx.window,
                                                 "reduce_device_ms")
