"""The ``faster_tokenizer`` op — the port of
``paddle_tpu/text/tokenizer_ops.py``: BERT tokenization from a
``StringTensor`` to a batch of ids on the device.

The work is host Python, as in the reference: basic tokenization
(lowercase with NFD accent stripping, punctuation splitting, CJK
spacing), greedy longest-match wordpiece, ``[CLS]`` / ``[SEP]``
assembly, longest-first pair truncation and right padding. The op's
output is the int32 ``(input_ids, token_type_ids)`` pair, made on the
device asked for (``set_device``'s choice, else the card).
"""
from __future__ import annotations

import unicodedata

import numpy as np
import torch

from .._device import resolve_device
from ..core.string_tensor import StringTensor, VocabTensor
from ..core.tensor import as_port
from ..nn.layer import Layer

__all__ = ["FasterTokenizer", "faster_tokenizer", "BertTokenizerLite"]

_MAX_CHARS_PER_WORD = 100  # reference faster_tokenizer_op.h:61


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _clean(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C") \
                and ch not in ("\t", "\n", "\r"):
            continue
        out.append(" " if ch in ("\t", "\n", "\r") or ch.isspace() else ch)
    return "".join(out)


def basic_tokenize(text: str, do_lower_case: bool = True) -> list[str]:
    """reference BasicTokenizer::Tokenize."""
    text = _clean(text)
    spaced = []
    for ch in text:
        if _is_cjk(ord(ch)):
            spaced.append(f" {ch} ")
        else:
            spaced.append(ch)
    tokens = []
    for tok in "".join(spaced).split():
        if do_lower_case:
            tok = tok.lower()
            tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                          if unicodedata.category(c) != "Mn")
        cur = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


def wordpiece_tokenize(token: str, vocab, unk="[UNK]") -> list[str]:
    """reference WordPieceTokenizer::Tokenize — greedy longest-match-first."""
    if len(token) > _MAX_CHARS_PER_WORD:
        return [unk]
    pieces = []
    start = 0
    while start < len(token):
        end = len(token)
        piece = None
        while start < end:
            sub = token[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                piece = sub
                break
            end -= 1
        if piece is None:
            return [unk]
        pieces.append(piece)
        start = end
    return pieces


class BertTokenizerLite:
    """reference BertTokenizer (faster_tokenizer_op.h:71): Tokenize + Encode
    + BatchEncode with special tokens and longest-first truncation."""

    def __init__(self, vocab, do_lower_case=True, unk_token="[UNK]",
                 pad_token="[PAD]", cls_token="[CLS]", sep_token="[SEP]"):
        self.vocab = vocab if isinstance(vocab, VocabTensor) \
            else VocabTensor(vocab)
        self.do_lower_case = do_lower_case
        self.unk, self.pad = unk_token, pad_token
        self.cls, self.sep = cls_token, sep_token
        self.pad_id = self.vocab.get(pad_token, 0)

    def tokenize(self, text: str) -> list[int]:
        ids = []
        for tok in basic_tokenize(text, self.do_lower_case):
            for piece in wordpiece_tokenize(tok, self.vocab, self.unk):
                ids.append(self.vocab.get(piece, self.vocab.get(self.unk, 0)))
        return ids

    def encode(self, text, text_pair=None, max_seq_len=0,
               is_split_into_words=False):
        if is_split_into_words:
            ids = [self.vocab.get(t, self.vocab.get(self.unk, 0))
                   for t in (text if isinstance(text, list) else text.split())]
            pair_ids = None
        else:
            ids = self.tokenize(text)
            pair_ids = self.tokenize(text_pair) if text_pair else None
        n_special = 3 if pair_ids is not None else 2
        if max_seq_len and max_seq_len < n_special:
            raise ValueError(
                f"max_seq_len={max_seq_len} cannot hold the {n_special} "
                "special tokens ([CLS]/[SEP]) this encoding requires")
        if max_seq_len and len(ids) + (len(pair_ids) if pair_ids else 0) \
                + n_special > max_seq_len:
            # longest-first truncation (reference TruncateSequence)
            budget = max_seq_len - n_special
            while len(ids) + (len(pair_ids) if pair_ids else 0) > budget \
                    and (ids or pair_ids):
                if pair_ids and len(pair_ids) >= len(ids):
                    pair_ids.pop()
                else:
                    ids.pop()
        cls_id = self.vocab.get(self.cls, 0)
        sep_id = self.vocab.get(self.sep, 0)
        input_ids = [cls_id] + ids + [sep_id]
        token_type = [0] * len(input_ids)
        if pair_ids is not None:
            input_ids += pair_ids + [sep_id]
            token_type += [1] * (len(pair_ids) + 1)
        return input_ids, token_type


def faster_tokenizer(vocab, text, text_pair=None, do_lower_case=True,
                     max_seq_len=-1, is_split_into_words=False,
                     pad_to_max_seq_len=False, device=None):
    """The op: ``(vocab, StringTensor [, StringTensor])`` ->
    ``(input_ids, token_type_ids)``, int32 ``[batch, width]`` tensors on
    ``device`` (None: ``set_device``'s choice, else the card), right-padded
    with the vocabulary's ``[PAD]`` id (reference
    ``FasterTokenizerOp::RunImpl``). ``width`` is ``max_seq_len`` with
    ``pad_to_max_seq_len``, else the longest encoding."""
    dev = resolve_device(device)
    texts = text.tolist() if isinstance(text, StringTensor) else list(text)
    pairs = (text_pair.tolist() if isinstance(text_pair, StringTensor)
             else list(text_pair)) if text_pair is not None \
        else [None] * len(texts)
    if len(pairs) != len(texts):
        raise ValueError(
            f"text_pair batch {len(pairs)} != text batch {len(texts)}")
    tok = BertTokenizerLite(vocab, do_lower_case=do_lower_case)
    max_len = max_seq_len if max_seq_len and max_seq_len > 0 else 0
    encoded = [tok.encode(t, p, max_seq_len=max_len,
                          is_split_into_words=is_split_into_words)
               for t, p in zip(texts, pairs)]
    width = 0 if not encoded else max_len if (
        max_len and pad_to_max_seq_len) else max(
            len(ids) for ids, _ in encoded)
    input_ids = np.full((len(encoded), width), tok.pad_id, np.int32)
    token_type = np.zeros((len(encoded), width), np.int32)
    for i, (ids, tt) in enumerate(encoded):
        input_ids[i, :len(ids)] = ids
        token_type[i, :len(tt)] = tt
    return (as_port(torch.as_tensor(input_ids, device=dev)),
            as_port(torch.as_tensor(token_type, device=dev)))


class FasterTokenizer(Layer):
    """An ``nn.Layer`` over the op, its vocabulary a host ``VocabTensor``
    (reference ``test_faster_tokenizer_op.py:66``)."""

    def __init__(self, vocab_dict):
        super().__init__()
        self.vocab = vocab_dict if isinstance(vocab_dict, VocabTensor) \
            else VocabTensor(vocab_dict)

    def forward(self, text, text_pair=None, do_lower_case=True,
                max_seq_len=-1, is_split_into_words=False,
                pad_to_max_seq_len=False, device=None):
        return faster_tokenizer(
            self.vocab, text, text_pair, do_lower_case=do_lower_case,
            max_seq_len=max_seq_len, is_split_into_words=is_split_into_words,
            pad_to_max_seq_len=pad_to_max_seq_len, device=device)
