"""The LM stack: TransformerLM (dense, MoE, vlm, audio; GQA or MLA),
RecurrentGemmaLM (hybrid) and XLSTMLM (ssm), their train step and serving
steps."""
from repro_torch.models.api import (  # noqa: F401
    build_model, default_micro_batches, input_defs, loss_and_grads,
    make_decode_step, make_prefill_step, make_train_step,
)
from repro_torch.models.recurrent import RecurrentGemmaLM  # noqa: F401
from repro_torch.models.transformer import TransformerLM  # noqa: F401
from repro_torch.models.xlstm import XLSTMLM  # noqa: F401
