"""MAPSIN join engine — the paper's core contribution, on one device or a
mesh of region shards."""
from repro_torch.core.bgp import (  # noqa: F401
    ExecConfig, execute_local, execute_sharded, query_traffic, rows_set,
)
from repro_torch.core.collectives import LocalMesh, ProcessGroupMesh  # noqa: F401
from repro_torch.core.mapsin import Bindings, mapsin_step, multiway_step, scan_pattern  # noqa: F401
from repro_torch.core.oracle import execute_oracle  # noqa: F401
from repro_torch.core.planner import (  # noqa: F401
    Caps, LogicalPlan, PhysicalPlan, PlanStep, compile_plan, explain,
    quantize_cap,
)
from repro_torch.core.rdf import Dictionary, Pattern, pack3, pattern_from, unpack3  # noqa: F401
from repro_torch.core.triple_store import TripleStore, build_store, store_from_numpy  # noqa: F401
