"""Text models of the port: the GPT (serving and training) with its
weights bridge to and from the JAX package, and BERT (``nn.Layer``
models, whose weights load by ``set_state_dict``)."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel)
from . import bert  # noqa: F401
from .convert import state_dict_from_jax, state_dict_to_jax
from .generation import generate, sample_logits
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, PagedBatch,
                  gpt_config)

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "bert",
           "GPTConfig", "GPTForCausalLM", "GPTModel", "PagedBatch",
           "gpt_config", "state_dict_from_jax", "state_dict_to_jax",
           "generate", "sample_logits"]
