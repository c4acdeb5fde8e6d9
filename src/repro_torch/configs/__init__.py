"""Architecture registry — importing this package registers every config
of the JAX package, and imports the paper's own workload config."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeConfig, get_config, list_archs,
    reduce_for_smoke, runnable_shapes,
)
from repro_torch.configs import (  # noqa: F401
    dbrx_132b, deepseek_7b, deepseek_v3_671b, mapsin_rdf, musicgen_large,
    pixtral_12b, qwen3_8b, recurrentgemma_9b, xlstm_125m, yi_34b, yi_6b,
)
