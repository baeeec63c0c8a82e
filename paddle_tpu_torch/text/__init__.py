"""Text models of the port: the GPT (serving and training) and the weights
bridge to and from the JAX package."""
from .convert import state_dict_from_jax, state_dict_to_jax
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, PagedBatch,
                  gpt_config)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "PagedBatch",
           "gpt_config", "state_dict_from_jax", "state_dict_to_jax"]
