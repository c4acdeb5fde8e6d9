"""The bulk load of the window's graph, in s: the port's `store.build` span
(host sorts, dedups and the upload to the card), the graph loaded anew
after the window (`portbench/program_trace.py`)."""
from portbench import program_trace


def read(ctx):
    pt = program_trace.of(ctx)
    return None if pt is None else pt.store_build_s()
