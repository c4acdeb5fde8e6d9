"""SPARQL BGP front-end and the single-device batched serving engine."""
from repro_torch.serve.engine import (  # noqa: F401
    EngineBusy, QueryResult, QueryShed, QueryTimeout, ServeEngine,
    plan_signature,
)
from repro_torch.serve.sparql import ParsedQuery, parse_bgp  # noqa: F401
