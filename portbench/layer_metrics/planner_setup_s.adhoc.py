"""Host time of the plan lookups that miss the store's plan cache, in s:
the port's `bgp.plan` spans with `hit` false (`compile_plan` and its
`relation_stats` passes), each query of the mix once on a store whose plan
cache is cold, as in the warm-up's first round (`portbench/program_trace.py`)."""
from portbench import program_trace


def read(ctx):
    pt = program_trace.of(ctx)
    return None if pt is None else pt.planner_setup_s()
