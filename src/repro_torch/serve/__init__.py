"""SPARQL BGP front-end, the batched serving engine (one device or a mesh
of region shards) and fault injection (a2a answer legs, the WAL)."""
from repro_torch.serve.engine import (  # noqa: F401
    EngineBusy, QueryResult, QueryShed, QueryTimeout, ServeEngine,
    plan_signature,
)
from repro_torch.serve.faults import (  # noqa: F401
    KINDS, DurabilityFaultPlan, Fault, FaultPlan, SimulatedCrash, WalFault,
)
from repro_torch.serve.sparql import ParsedQuery, parse_bgp  # noqa: F401
