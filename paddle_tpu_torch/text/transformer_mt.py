"""Transformer machine translation — the port of
``paddle_tpu/text/transformer_mt.py`` (``TransformerMTConfig``,
``sinusoid_position_encoding``, ``TransformerMT``).

The model is the port's ``nn.Transformer`` between two embeddings (each
scaled by ``sqrt(d_model)`` and added to a fixed sinusoid table, the
``pos_table`` buffer) and a linear head. Training is teacher-forced: a
label-smoothed cross-entropy, masked over pad positions and divided by
the count of valid ones. The masks are additive ``-1e9``: ``[b, 1, 1,
s]`` over the source's pads, and causal plus pad ``[b, 1, s, s]`` over
the target's; attention under a mask takes the composite, as the
reference routes it, so this model launches no flash kernel.

Decoding keeps the reference's algorithm: beam search through
``nn.BeamSearchDecoder`` / ``nn.dynamic_decode`` with a fixed
``[b * beam, max_len]`` token buffer in the cell state (gathered by
parent beam like any state), the decoder re-run over the whole prefix
at each step under a causal mask that also hides the positions past the
step. The step index stays on the device; ``dynamic_decode`` reads the
device once a step (whether every beam has finished).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import nn
from .._device import resolve_device
from ..core.tensor import as_port
from ..nn import functional as F

__all__ = ["TransformerMTConfig", "sinusoid_position_encoding",
           "TransformerMT"]

#: the additive mask value of a hidden position, as the reference's
MASKED = -1e9


@dataclass
class TransformerMTConfig:
    src_vocab_size: int = 10000
    tgt_vocab_size: int = 10000
    d_model: int = 512
    nhead: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    max_length: int = 256
    bos_id: int = 0
    eos_id: int = 1
    pad_id: int = 2
    label_smooth_eps: float = 0.1
    tie_embeddings: bool = False  # share tgt embedding with the output head


def sinusoid_position_encoding(max_len: int, d_model: int,
                               device=None) -> torch.Tensor:
    """The fixed sin/cos table ``[max_len, d_model]`` in float32
    (``d_model`` must be even), computed on the CPU and placed on
    ``device`` (None: ``set_device``'s choice, else the card)."""
    if d_model % 2:
        raise ValueError(f"d_model must be even, got {d_model}")
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0), dim / d_model)
    pe = torch.zeros((max_len, d_model), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return as_port(pe.to(resolve_device(device)))


def _additive(hidden):
    """``-1e9`` where ``hidden``, else 0, in float32."""
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    return torch.where(hidden, torch.full_like(zero, MASKED), zero)


def _causal(s, device):
    """The additive causal mask ``[s, s]``."""
    return _additive(~torch.ones((s, s), dtype=torch.bool,
                                 device=device).tril())


class TransformerMT(nn.Layer):
    """An encoder-decoder translation model over ``nn.Transformer`` with
    beam-search decoding."""

    def __init__(self, cfg: TransformerMTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.src_emb = nn.Embedding(cfg.src_vocab_size, d)
        self.tgt_emb = nn.Embedding(cfg.tgt_vocab_size, d)
        self.register_buffer(
            "pos_table", sinusoid_position_encoding(
                cfg.max_length, d, self.src_emb.weight.device))
        self.dropout = nn.Dropout(cfg.dropout)
        self.transformer = nn.Transformer(
            d_model=d, nhead=cfg.nhead,
            num_encoder_layers=cfg.num_encoder_layers,
            num_decoder_layers=cfg.num_decoder_layers,
            dim_feedforward=cfg.dim_feedforward, dropout=cfg.dropout)
        if cfg.tie_embeddings:
            self.head = None
        else:
            self.head = nn.Linear(d, cfg.tgt_vocab_size, bias_attr=False)

    # --------------------------------------------------------------- helpers
    def _embed(self, emb, ids, start: int = 0):
        x = emb(ids) * math.sqrt(self.cfg.d_model)
        pe = self.pos_table[start:start + ids.shape[1]]
        return self.dropout(x + pe[None, :, :].to(x.dtype))

    def _pad_mask(self, ids):
        """``[b, s]`` ids -> the additive ``[b, 1, 1, s]`` mask, ``-1e9``
        on pad positions."""
        return _additive(ids == self.cfg.pad_id)[:, None, None, :]

    def _project(self, h):
        if self.head is not None:
            return self.head(h)
        return torch.matmul(h, self.tgt_emb.weight.T)

    # --------------------------------------------------------------- training
    def forward(self, src_ids, tgt_ids, labels=None):
        """Teacher-forced forward: the logits ``[b, s_tgt, tgt_vocab]``,
        or with ``labels`` the label-smoothed cross-entropy masked over
        pad positions (its sum over valid positions by their count)."""
        cfg = self.cfg
        src_mask = self._pad_mask(src_ids)
        tgt_mask = _causal(tgt_ids.shape[1], tgt_ids.device)[None, None] \
            + self._pad_mask(tgt_ids)
        mem = self.transformer.encoder(self._embed(self.src_emb, src_ids),
                                       src_mask=src_mask)
        h = self.transformer.decoder(self._embed(self.tgt_emb, tgt_ids), mem,
                                     tgt_mask=tgt_mask, memory_mask=src_mask)
        logits = self._project(h)
        if labels is None:
            return logits
        valid = (labels != cfg.pad_id).to(torch.float32)
        loss = F.cross_entropy(
            logits.reshape(-1, cfg.tgt_vocab_size), labels.reshape(-1),
            reduction="none", label_smoothing=cfg.label_smooth_eps)
        loss = loss.reshape(labels.shape)
        return (loss * valid).sum() / valid.sum()

    # --------------------------------------------------------------- decoding
    def encode(self, src_ids):
        """``(memory [b, s, d], src_mask [b, 1, 1, s])``."""
        src_mask = self._pad_mask(src_ids)
        return self.transformer.encoder(self._embed(self.src_emb, src_ids),
                                        src_mask=src_mask), src_mask

    @torch.no_grad()
    def beam_search(self, src_ids, beam_size=4, max_len=None):
        """``src_ids [b, s_src]`` -> ``(ids [b, max_len, beam], lengths [b,
        beam])``, in eval mode and without autograd (each step's decoder
        activations would otherwise stay alive through the beam scores).
        ``max_len`` defaults to ``min(max_length, s_src + 50)``."""
        cfg = self.cfg
        was_training = self.training
        self.eval()
        try:
            max_len = int(max_len or min(cfg.max_length,
                                         src_ids.shape[1] + 50))
            mem, src_mask = self.encode(src_ids)
            b, dev = src_ids.shape[0], src_ids.device
            mem_t = torch.repeat_interleave(mem, beam_size, dim=0)
            src_mask_t = torch.repeat_interleave(src_mask, beam_size, dim=0)
            causal = _causal(max_len, dev)
            key_pos = torch.arange(max_len, device=dev)[None, :]
            model = self

            def cell(inputs, states):
                tokens, pos = states   # [B, max_len] int32, [B] int32
                p = pos[:1].long()     # every row shares the step index
                buf = tokens.index_copy(1, p, inputs.to(torch.int32)[:, None])
                # positions past p are padding: hidden from the keys
                tgt_mask = causal[None, None] + _additive(
                    key_pos > p)[:, None, None, :]
                h = model.transformer.decoder(
                    model._embed(model.tgt_emb, buf), mem_t,
                    tgt_mask=tgt_mask, memory_mask=src_mask_t)
                step = torch.index_select(model._project(h), 1, p)[:, 0]
                return step, (buf, pos + 1)

            tokens0 = torch.full((b, max_len), cfg.pad_id, dtype=torch.int32,
                                 device=dev)
            pos0 = torch.zeros((b,), dtype=torch.int32, device=dev)
            dec = nn.BeamSearchDecoder(cell, start_token=cfg.bos_id,
                                       end_token=cfg.eos_id,
                                       beam_size=beam_size)
            out, _, lengths = nn.dynamic_decode(
                dec, inits=(tokens0, pos0), max_step_num=max_len,
                return_length=True)
            return out, lengths
        finally:
            if was_training:
                self.train()

    def translate(self, src_ids, beam_size=4, max_len=None):
        """The best beam's ids ``[b, max_len]``, pad past its length."""
        out, lengths = self.beam_search(src_ids, beam_size, max_len)
        ids = out[:, :, 0]
        steps = torch.arange(ids.shape[1], device=ids.device)[None, :]
        return as_port(torch.where(steps < lengths[:, :1], ids,
                                   torch.full_like(ids, self.cfg.pad_id)))
