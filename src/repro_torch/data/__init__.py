"""Synthetic RDF generators mirroring the paper's benchmarks."""
from repro_torch.data.rdf_gen import lubm_like, sp2b_like  # noqa: F401
