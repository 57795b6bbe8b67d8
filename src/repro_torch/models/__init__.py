"""The LM family of the port: the counterpart of ``repro/models``.

Attention stacks with dense or MoE MLPs (``transformer``, ``moe``), and
the training loss (``lm_loss``).
"""

from repro_torch.models.config import (  # noqa: F401
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    count_params,
)
from repro_torch.models.transformer import (  # noqa: F401
    cross_entropy,
    decode_step,
    forward,
    greedy_generate,
    init_model,
    init_model_cache,
    lm_loss,
    prefill,
)
