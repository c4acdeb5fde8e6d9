"""Host time of the front end and the plan lookup a query answered, in ms:
the port's `sparql.parse` and `bgp.plan` spans, from the replay after the
window (`portbench/program_trace.py`), each query's time a run weighted by
its runs in the window."""
from portbench import program_trace


def read(ctx):
    pt = program_trace.of(ctx)
    return None if pt is None else pt.per_answer(ctx.window, "host_ms")
