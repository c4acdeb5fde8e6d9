"""The LM stack: the dense GQA decoder and its serving steps."""
from repro_torch.models.api import (  # noqa: F401
    build_model, make_decode_step, make_prefill_step,
)
