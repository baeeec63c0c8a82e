"""Text models of the port (the GPT serving slice)."""
from .convert import state_dict_from_jax
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, PagedBatch,
                  gpt_config)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "PagedBatch",
           "gpt_config", "state_dict_from_jax"]
