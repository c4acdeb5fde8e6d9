"""Device time of the kernels launched inside the port's `bgp.mapsin` and
`bgp.multiway` step spans, a query answered, in ms: torch.profiler's
kernels, each put down to the innermost span open at its CUDA launch, in
the replay after the window (`portbench/program_trace.py`), each query's
time a run weighted by its runs in the window."""
from portbench import program_trace


def read(ctx):
    pt = program_trace.of(ctx)
    return None if pt is None else pt.per_answer(ctx.window,
                                                 "probe_device_ms")
