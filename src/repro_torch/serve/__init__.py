"""SPARQL BGP front-end."""
from repro_torch.serve.sparql import ParsedQuery, parse_bgp  # noqa: F401
