"""Model library: the Wan video DiT (text- and image-to-video) and its
denoising pipelines; the GPT family and its per-family configurations; the
BERT encoder.
Sparse-against-dense quality (``models.eval``) and threshold calibration
(``models.calibrate``) are submodules, not exported here, as in JAX."""

from liteattention_torch.models.bert import BertConfig, BertForPreTraining, BertModel
from liteattention_torch.models.configs import (
    baichuan_config,
    bigcode_config,
    btlm_config,
    falcon_config,
    gpt2_config,
    gpt_neox_config,
    gptj_config,
    llama_config,
    opt_config,
)
from liteattention_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    GPTModel,
    gpt_loss_fn,
    gpt_state_dict_from_jax,
)
from liteattention_torch.models.pipeline import (
    denoise,
    denoise_two_expert,
    flow_timesteps,
    linear_threshold_schedule,
)
from liteattention_torch.models.wan import (
    WanConfig,
    WanModel,
    init_skip_states,
    wan_state_dict_from_jax,
)

__all__ = [
    "GPTConfig",
    "GPTLMHeadModel",
    "GPTModel",
    "gpt_loss_fn",
    "gpt_state_dict_from_jax",
    "WanConfig",
    "WanModel",
    "init_skip_states",
    "wan_state_dict_from_jax",
    "denoise",
    "denoise_two_expert",
    "flow_timesteps",
    "linear_threshold_schedule",
    "gpt2_config",
    "opt_config",
    "gptj_config",
    "gpt_neox_config",
    "falcon_config",
    "llama_config",
    "bigcode_config",
    "baichuan_config",
    "btlm_config",
    "BertConfig",
    "BertModel",
    "BertForPreTraining",
]
