"""Synthetic data: RDF generators mirroring the paper's benchmarks and the
deterministic LM token pipeline."""
from repro_torch.data.lm_data import batch_for_step, tokens_for  # noqa: F401
from repro_torch.data.rdf_gen import lubm_like, sp2b_like  # noqa: F401
