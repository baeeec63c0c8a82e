"""Text datasets (reference: ``paddle_tpu/text/datasets.py``; Paddle's
``python/paddle/text/datasets/``: Conll05st, Imdb, Imikolov, Movielens,
UCIHousing, WMT14, WMT16). Paddle's versions download corpora; these are
the reference's deterministic synthetic fallbacks, with the same item
structure and dtypes, and each item equal to the reference's for the same
arguments: every draw comes from the same ``np.random.RandomState`` seed
in the same order."""
from __future__ import annotations

import numpy as np

from ..io.dataset import Dataset


class SyntheticLMDataset(Dataset):
    """Deterministic Zipf-ish token stream for LM training/benchmarks."""

    def __init__(self, vocab_size=50304, seq_len=1024, size=4096, seed=0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.size = size
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        # zipf-distributed tokens clipped to vocab
        toks = rng.zipf(1.3, self.seq_len + 1)
        toks = np.minimum(toks, self.vocab_size - 1).astype(np.int64)
        return toks[:-1], toks[1:]

    def __len__(self):
        return self.size


class Imdb(Dataset):
    """reference: text/datasets/imdb.py — (token ids, 0/1 sentiment)."""

    def __init__(self, mode="train", cutoff=150, size=2048):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self._x = rng.randint(0, 5000, (size, 128)).astype(np.int64)
        self._y = rng.randint(0, 2, size).astype(np.int64)

    def __getitem__(self, idx):
        return self._x[idx], self._y[idx]

    def __len__(self):
        return len(self._y)


class Conll05st(Dataset):
    """reference: text/datasets/conll05.py — SRL: 8 feature columns + labels.
    Items: (pred_idx, mark, word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
    label) as int64 sequences of one shared length."""

    WORD_DICT_LEN, LABEL_DICT_LEN, PRED_DICT_LEN = 44068, 106, 3162

    def __init__(self, mode="train", size=1024, seq_len=32):
        self._rng_seed = 0 if mode == "train" else 1
        self.size = size
        self.seq_len = seq_len

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._rng_seed * 100003 + idx)
        s = self.seq_len
        word = rng.randint(0, self.WORD_DICT_LEN, s).astype(np.int64)
        ctx = [np.roll(word, k) for k in (-2, -1, 0, 1, 2)]
        pred = np.full(s, rng.randint(0, self.PRED_DICT_LEN), np.int64)
        mark = (rng.rand(s) < 0.1).astype(np.int64)
        label = rng.randint(0, self.LABEL_DICT_LEN, s).astype(np.int64)
        return (pred, mark, word, *ctx, label)

    def __len__(self):
        return self.size

    def get_dict(self):
        word_d = {f"w{i}": i for i in range(100)}
        label_d = {f"l{i}": i for i in range(self.LABEL_DICT_LEN)}
        pred_d = {f"p{i}": i for i in range(100)}
        return word_d, pred_d, label_d


class Imikolov(Dataset):
    """reference: text/datasets/imikolov.py — PTB n-grams: [n-1 context, next]."""

    def __init__(self, mode="train", data_type="NGRAM", window_size=5,
                 size=4096):
        self._seed = 0 if mode == "train" else 1
        self.window_size = window_size
        self.size = size
        self.vocab = 2074

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seed * 7919 + idx)
        gram = rng.zipf(1.2, self.window_size)
        return tuple(np.int64(min(g, self.vocab - 1)) for g in gram)

    def __len__(self):
        return self.size


class Movielens(Dataset):
    """reference: text/datasets/movielens.py — (user feats, movie feats,
    rating): uid, gender, age, job, mid, title ids, categories, score."""

    def __init__(self, mode="train", size=4096):
        self._seed = 0 if mode == "train" else 1
        self.size = size

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seed * 104729 + idx)
        uid = np.int64(rng.randint(1, 6041))
        gender = np.int64(rng.randint(0, 2))
        age = np.int64(rng.randint(0, 7))
        job = np.int64(rng.randint(0, 21))
        mid = np.int64(rng.randint(1, 3953))
        title = rng.randint(1, 5175, 8).astype(np.int64)
        categories = rng.randint(0, 18, 3).astype(np.int64)
        rating = np.float32(rng.randint(1, 6))
        return uid, gender, age, job, mid, title, categories, rating

    def __len__(self):
        return self.size


class UCIHousing(Dataset):
    """reference: text/datasets/uci_housing.py — 13 float features, 1 target."""

    def __init__(self, mode="train"):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        n = 404 if mode == "train" else 102
        self._x = rng.randn(n, 13).astype(np.float32)
        w = rng.randn(13).astype(np.float32)
        self._y = (self._x @ w + 0.1 * rng.randn(n)).astype(np.float32)[:, None]

    def __getitem__(self, idx):
        return self._x[idx], self._y[idx]

    def __len__(self):
        return len(self._y)


class _WMT(Dataset):
    def __init__(self, mode, src_vocab, trg_vocab, size, seed0):
        self._seed = seed0 if mode == "train" else seed0 + 1
        self.src_vocab, self.trg_vocab = src_vocab, trg_vocab
        self.size = size

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seed * 31337 + idx)
        n = rng.randint(4, 30)
        src = rng.randint(3, self.src_vocab, n).astype(np.int64)
        trg = rng.randint(3, self.trg_vocab, n + rng.randint(-2, 3)).astype(np.int64)
        trg = np.concatenate([[1], trg, [2]])  # <s> ... <e>
        return src, trg[:-1], trg[1:]

    def __len__(self):
        return self.size


class WMT14(_WMT):
    """reference: text/datasets/wmt14.py — (src ids, trg ids, trg_next ids)."""

    def __init__(self, mode="train", dict_size=30000, size=2048):
        super().__init__(mode, dict_size, dict_size, size, 10)


class WMT16(_WMT):
    """reference: text/datasets/wmt16.py."""

    def __init__(self, mode="train", src_dict_size=10000, trg_dict_size=10000,
                 lang="en", size=2048):
        super().__init__(mode, src_dict_size, trg_dict_size, size, 20)
