"""SPARQL BGP front-end, the single-device batched serving engine and the
WAL's durability fault injection."""
from repro_torch.serve.engine import (  # noqa: F401
    EngineBusy, QueryResult, QueryShed, QueryTimeout, ServeEngine,
    plan_signature,
)
from repro_torch.serve.faults import (  # noqa: F401
    DurabilityFaultPlan, SimulatedCrash, WalFault,
)
from repro_torch.serve.sparql import ParsedQuery, parse_bgp  # noqa: F401
