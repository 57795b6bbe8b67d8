"""The LM family of the port: the counterpart of ``repro/models``.

Dense attention stacks so far (``transformer``); the reference's
``lm_loss`` waits for LM training (ROADMAP queue 1, item 11a).
"""

from repro_torch.models.config import (  # noqa: F401
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    count_params,
)
from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    forward,
    greedy_generate,
    init_model,
    init_model_cache,
    prefill,
)
