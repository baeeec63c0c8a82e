"""Text models and ops of the port: the GPT (serving and training) with
its weights bridge to and from the JAX package; BERT, ERNIE and the
Transformer translation model (``nn.Layer`` models, whose weights load
by ``set_state_dict``); Viterbi decoding; the BERT tokenizer op and the
host string tensors it reads; the reference's synthetic datasets
(``datasets``: Imdb, Conll05st, Imikolov, Movielens, UCIHousing, WMT14,
WMT16)."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel)
from . import bert  # noqa: F401
from .convert import state_dict_from_jax, state_dict_to_jax
from .ernie import (ErnieConfig, ErnieForMaskedLM,
                    ErnieForSequenceClassification, ErnieModel, ernie_config)
from .generation import generate, sample_logits
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, PagedBatch,
                  gpt_config)
from .tokenizer_ops import BertTokenizerLite, FasterTokenizer, \
    faster_tokenizer
from .transformer_mt import (TransformerMT, TransformerMTConfig,
                             sinusoid_position_encoding)
from .viterbi_decode import ViterbiDecoder, viterbi_decode
from ..core.string_tensor import (StringTensor, VocabTensor, to_map_tensor,
                                  to_string_tensor)
from . import datasets
from .datasets import (Conll05st, Imdb, Imikolov, Movielens, UCIHousing,
                       WMT14, WMT16)

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "bert",
           "ErnieConfig", "ErnieForMaskedLM",
           "ErnieForSequenceClassification", "ErnieModel", "ernie_config",
           "GPTConfig", "GPTForCausalLM", "GPTModel", "PagedBatch",
           "gpt_config", "state_dict_from_jax", "state_dict_to_jax",
           "generate", "sample_logits", "BertTokenizerLite",
           "FasterTokenizer", "faster_tokenizer", "TransformerMT",
           "TransformerMTConfig", "sinusoid_position_encoding",
           "ViterbiDecoder", "viterbi_decode", "StringTensor",
           "VocabTensor", "to_map_tensor", "to_string_tensor", "datasets",
           "Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing",
           "WMT14", "WMT16"]
