"""Model library: the Wan video DiT (text-to-video) and its denoising
pipeline; the GPT family (training path)."""

from liteattention_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    GPTModel,
    gpt_loss_fn,
    gpt_state_dict_from_jax,
)
from liteattention_torch.models.pipeline import (
    denoise,
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
    "flow_timesteps",
    "linear_threshold_schedule",
]
