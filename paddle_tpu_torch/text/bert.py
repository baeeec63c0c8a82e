"""BERT — the port of ``paddle_tpu/text/bert.py`` (``BertConfig``,
``BertEmbeddings``, ``BertModel``, ``BertForSequenceClassification``,
``BertForPretraining``), built, as the reference's is, from ``nn``'s
layers: ``Embedding``, ``LayerNorm``, ``Dropout``, ``Linear`` and the
``TransformerEncoder``. Its structured parameter names are the
reference's, so the reference's ``state_dict()`` loads with
``set_state_dict`` and nothing else; ``paddle.seed(s)`` before building
gives the reference's initial weights (the initializers draw the key
schedule in its order, and the encoder's layers are deep copies of the
first).

On CUDA tensors a step runs the port's kernels: the flash kernels in
every encoder layer when there is no ``attention_mask`` (the composite
with one, as the reference routes it), the LayerNorm kernels in the
embeddings, each layer and the MLM head, dropout's kernel when a
dropout is non-zero, and the MLM loss through the fused, chunked
``linear_cross_entropy`` over the tied word embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from ..nn import functional as F

__all__ = ["BertConfig", "BertEmbeddings", "BertModel",
           "BertForSequenceClassification", "BertForPretraining"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    layer_norm_eps: float = 1e-12


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, dtype=torch.int64, device=input_ids.device).unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.int64,
                                         device=input_ids.device)
        e = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(e))


class BertModel(nn.Layer):
    embeddings_cls = BertEmbeddings  # subclasses (ERNIE) swap the embeddings

    def __init__(self, cfg: BertConfig | None = None, **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        self.cfg = cfg
        self.embeddings = self.embeddings_cls(cfg)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout, activation="gelu",
            attn_dropout=cfg.attn_dropout, act_dropout=0.0)
        self.encoder = nn.TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """``(sequence [b, s, h], pooled [b, h])``; ``attention_mask`` is
        bool (True = visible) or additive, broadcast to ``[b, heads, s,
        s]``."""
        x = self.embeddings(input_ids, token_type_ids)
        x = self.encoder(x, attention_mask)
        return x, F.tanh(self.pooler(x[:, 0]))


class BertForSequenceClassification(nn.Layer):
    def __init__(self, cfg: BertConfig | None = None, num_classes=2,
                 **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        self.bert = BertModel(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        """Logits ``[b, num_classes]``, or with ``labels`` the mean
        cross-entropy."""
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels)
        return logits


class BertForPretraining(nn.Layer):
    def __init__(self, cfg: BertConfig | None = None, **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.mlm_norm = nn.LayerNorm(cfg.hidden_size,
                                     epsilon=cfg.layer_norm_eps)
        self.nsp = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_labels=None):
        """With ``masked_lm_labels`` (``-1`` where not masked) the MLM loss
        from the fused, chunked head over the tied word embeddings (the
        ``[b, s, vocab]`` logits never formed), plus the NSP loss with
        ``next_sentence_labels``; without, ``(mlm_logits, nsp_logits)``."""
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        nsp_logits = self.nsp(pooled)
        word = self.bert.embeddings.word_embeddings.weight
        if masked_lm_labels is not None:
            loss = F.linear_cross_entropy(h, word, masked_lm_labels,
                                          transpose_y=True, ignore_index=-1)
            if next_sentence_labels is not None:
                loss = loss + F.cross_entropy(
                    nsp_logits, next_sentence_labels.reshape(-1))
            return loss
        return torch.matmul(h, word.T), nsp_logits
