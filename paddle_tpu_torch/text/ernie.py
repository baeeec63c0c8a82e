"""ERNIE — the port of ``paddle_tpu/text/ernie.py`` (``ErnieConfig`` with
its three presets, ``ernie_config``, ``ErnieEmbeddings``, ``ErnieModel``,
``ErnieForSequenceClassification``, ``ErnieForMaskedLM``).

ERNIE is BERT's encoder with a task-type embedding added to the word,
position and segment embeddings, so it is built on the port's
``text/bert.py``: ``ErnieModel`` is a ``BertModel`` whose
``embeddings_cls`` is ``ErnieEmbeddings``. Parameter names, the draw
order of ``paddle.seed(s)`` and the ``state_dict()`` layout are the
reference's. On CUDA tensors a step runs the kernels BERT's does: flash
attention in every layer when there is no ``attention_mask``, the
LayerNorm kernels, dropout's kernel at a non-zero rate, fused Adam, and
the MLM loss through the fused, chunked ``linear_cross_entropy`` over
the tied word embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from ..nn import functional as F
from .bert import BertConfig, BertEmbeddings, BertModel

__all__ = ["ErnieConfig", "ernie_config", "ErnieEmbeddings", "ErnieModel",
           "ErnieForSequenceClassification", "ErnieForMaskedLM"]


@dataclass
class ErnieConfig(BertConfig):
    vocab_size: int = 18000
    max_position_embeddings: int = 513
    task_type_vocab_size: int = 3
    use_task_id: bool = True


_PRESETS = {
    "ernie-3.0-base": dict(hidden_size=768, num_layers=12, num_heads=12),
    "ernie-3.0-medium": dict(hidden_size=768, num_layers=6, num_heads=12),
    "ernie-3.0-xbase": dict(hidden_size=1024, num_layers=20, num_heads=16,
                            intermediate_size=4096),
}


def ernie_config(preset: str, **overrides) -> ErnieConfig:
    """One of the presets ``ernie-3.0-base``, ``-medium`` and ``-xbase``,
    with ``overrides`` on top."""
    cfg = dict(_PRESETS[preset])
    cfg.update(overrides)
    return ErnieConfig(**cfg)


def _zeros_like_ids(ids):
    return torch.zeros(tuple(ids.shape), dtype=torch.int64,
                       device=ids.device)


class ErnieEmbeddings(BertEmbeddings):
    """BERT's embeddings plus the task-type embedding (when
    ``use_task_id``)."""

    def __init__(self, cfg: ErnieConfig):
        super().__init__(cfg)
        self.task_type_embeddings = (
            nn.Embedding(cfg.task_type_vocab_size, cfg.hidden_size)
            if cfg.use_task_id else None)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(
                s, dtype=torch.int64, device=input_ids.device).unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = _zeros_like_ids(input_ids)
        e = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        if self.task_type_embeddings is not None:
            if task_type_ids is None:
                task_type_ids = _zeros_like_ids(input_ids)
            e = e + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(e))


class ErnieModel(BertModel):
    """BERT's encoder and pooler over ERNIE's embeddings. The positional
    signature stays ``BertModel``'s (``attention_mask`` third); the
    ERNIE arguments come after it."""

    embeddings_cls = ErnieEmbeddings

    def __init__(self, cfg: ErnieConfig | None = None, **kwargs):
        super().__init__(cfg or ErnieConfig(**kwargs))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None, task_type_ids=None):
        """``(sequence [b, s, h], pooled [b, h])``."""
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        x = self.encoder(x, attention_mask)
        return x, F.tanh(self.pooler(x[:, 0]))


class ErnieForSequenceClassification(nn.Layer):
    def __init__(self, cfg: ErnieConfig | None = None, num_classes=2,
                 **kwargs):
        super().__init__()
        cfg = cfg or ErnieConfig(**kwargs)
        self.ernie = ErnieModel(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None, labels=None):
        """Logits ``[b, num_classes]``, or with ``labels`` the mean
        cross-entropy."""
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask,
                               task_type_ids=task_type_ids)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels)
        return logits


class ErnieForMaskedLM(nn.Layer):
    """The MLM pretraining head: a transform, GELU and LayerNorm, then
    the decoder tied to the word embeddings."""

    def __init__(self, cfg: ErnieConfig | None = None, **kwargs):
        super().__init__()
        cfg = cfg or ErnieConfig(**kwargs)
        self.cfg = cfg
        self.ernie = ErnieModel(cfg)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.norm = nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None, masked_lm_labels=None):
        """With ``masked_lm_labels`` (``-1`` where not masked) the MLM loss
        from the fused, chunked head (the ``[b, s, vocab]`` logits never
        formed); without, the logits."""
        seq, _ = self.ernie(input_ids, token_type_ids, attention_mask,
                            task_type_ids=task_type_ids)
        h = self.norm(F.gelu(self.transform(seq)))
        word = self.ernie.embeddings.word_embeddings.weight
        if masked_lm_labels is not None:
            return F.linear_cross_entropy(h, word, masked_lm_labels,
                                          transpose_y=True, ignore_index=-1)
        return torch.matmul(h, word.T)
