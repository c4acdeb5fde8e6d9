"""Valid rows over the slots searched, in %, over every cascade step of
the window: each step span's `found` (the rows its output `compact` found
before the out_cap cut) and `slots` (the candidates it searched), from the
replay after the window, each query weighted by its runs
(`portbench/program_trace.py`)."""
from portbench import program_trace


def read(ctx):
    pt = program_trace.of(ctx)
    return None if pt is None else pt.slot_fill(ctx.window)
