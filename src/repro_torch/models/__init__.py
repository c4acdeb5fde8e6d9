"""The LM stack: the dense GQA decoder, its train step and serving steps."""
from repro_torch.models.api import (  # noqa: F401
    build_model, default_micro_batches, input_defs, loss_and_grads,
    make_decode_step, make_prefill_step, make_train_step,
)
