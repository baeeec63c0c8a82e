"""Viterbi decoding, the BERT tokenizer op and the host string tensors
(``text/viterbi_decode.py``, ``text/tokenizer_ops.py``,
``core/string_tensor.py``) in the port against the JAX package.

- ``viterbi_decode`` / ``ViterbiDecoder``: scores within float32 rounding
  (rtol 1e-6 / atol 1e-5) and paths equal, with and without the BOS/EOS
  tags, over variable lengths (1 to T), on random potentials and on
  integer-valued ones whose ties every argmax must break to the first
  index, as ``jnp.argmax`` does; then against a brute-force search.
- ``faster_tokenizer`` / ``FasterTokenizer`` / ``BertTokenizerLite``: ids
  and token-type ids equal over strings with accents, CJK, punctuation,
  control characters, pairs, longest-first truncation and padding; the
  output is int32 on the device asked for.
- ``StringTensor`` / ``VocabTensor``: the reference's surface.
"""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy

SCORE_TOL = dict(rtol=1e-6, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _viterbi(P, pot, trans, lengths, include):
    scores, paths = P.text.viterbi_decode(
        P.to_tensor(pot), P.to_tensor(trans), P.to_tensor(lengths),
        include_bos_eos_tag=include)
    return to_numpy(scores), to_numpy(paths)


def _cases():
    rng = np.random.RandomState(0)
    b, t, n = 6, 7, 5
    random = (rng.randn(b, t, n).astype(np.float32),
              rng.randn(n, n).astype(np.float32))
    # small integers: many equal candidates at every step
    ties = (rng.randint(-1, 2, (b, t, n)).astype(np.float32),
            rng.randint(-1, 2, (n, n)).astype(np.float32))
    return {"random": random, "ties": ties}


@pytest.mark.parametrize("include", [True, False], ids=["bos_eos", "plain"])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_viterbi_decode_equals_the_reference(case, include):
    pot, trans = _cases()[case]
    lengths = np.array([7, 3, 1, 5, 7, 2], np.int64)
    ws, wp = _viterbi(J, pot, trans, lengths, include)
    gs, gp = _viterbi(T, pot, trans, lengths, include)
    assert gp.dtype == wp.dtype == np.int32 and gp.shape == (6, 7)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_allclose(gs, ws, **SCORE_TOL)
    assert (gp[np.arange(7)[None, :] >= lengths[:, None]] == 0).all()


def _brute(pot, trans, length, include):
    n = pot.shape[1]
    best = (-np.inf, None)
    for path in itertools.product(range(n), repeat=length):
        s = pot[0, path[0]] + (trans[n - 2, path[0]] if include else 0.0)
        for i in range(1, length):
            s += trans[path[i - 1], path[i]] + pot[i, path[i]]
        if include:
            s += trans[path[-1], n - 1]
        if s > best[0]:
            best = (s, path)
    return best


@pytest.mark.parametrize("include", [True, False], ids=["bos_eos", "plain"])
def test_viterbi_decode_is_the_best_path(include):
    pot, trans = _cases()["random"]
    pot, trans = pot[:3, :5, :4].astype(np.float64), trans[:4, :4]
    lengths = np.array([5, 3, 1], np.int64)
    scores, paths = _viterbi(T, pot, trans.astype(np.float64), lengths,
                             include)
    for row, length in enumerate(lengths):
        score, path = _brute(pot[row], trans, length, include)
        np.testing.assert_allclose(scores[row], score, rtol=1e-12)
        assert tuple(paths[row, :length]) == path


def test_viterbi_decoder_layer():
    rng = np.random.RandomState(1)
    trans = rng.randn(5, 5).astype(np.float32)
    pot = rng.randn(2, 4, 5).astype(np.float32)
    lengths = np.array([4, 2], np.int64)
    out = {}
    for P in (J, T):
        dec = P.text.ViterbiDecoder(P.to_tensor(trans),
                                    include_bos_eos_tag=False)
        out[P] = [to_numpy(o) for o in dec(P.to_tensor(pot),
                                          P.to_tensor(lengths))]
    np.testing.assert_allclose(out[T][0], out[J][0], **SCORE_TOL)
    np.testing.assert_array_equal(out[T][1], out[J][1])


_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
          "the", "quick", "brown", "fox", "jump", "##ed", "##s", "over",
          "lazy", "dog", "un", "##want", "##able", "runn", "##ing", ",", ".",
          "!", "?", "hello", "world", "中", "国", "cafe", "naive", "'",
          "-", "re", "##sume"]
VOCAB = {t: i for i, t in enumerate(_VOCAB)}
TEXTS = ["The quick brown fox jumped over the lazy dog.",
         "Héllo, WORLD! Café naïve résumé",
         "中国 runnings unwantable?",
         "tab\tand\nnew\x00line� don't re-jump",
         "", "zzz " + "a" * 120, "Fox"]
PAIRS = ["hello world", "the dog's fox", "中国中国中国", "", "?!",
         "jumps over", "running dog running dog running dog"]


@pytest.mark.parametrize("max_seq_len,pad,pairs", [
    (-1, False, False), (-1, False, True), (8, False, True), (8, True, True),
    (12, True, False), (5, False, True)])
def test_faster_tokenizer_equals_the_reference(max_seq_len, pad, pairs):
    out = {}
    for P in (J, T):
        texts = P.text.to_string_tensor(TEXTS)
        pair = P.text.to_string_tensor(PAIRS) if pairs else None
        out[P] = [to_numpy(t) for t in P.text.faster_tokenizer(
            VOCAB, texts, pair, max_seq_len=max_seq_len,
            pad_to_max_seq_len=pad)]
    for got, want in zip(out[T], out[J]):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    if max_seq_len > 0:
        assert out[T][0].shape[1] <= max_seq_len


def test_tokenizer_layer_words_and_case():
    args = dict(max_seq_len=-1, is_split_into_words=True)
    words = [["the", "fox", "zzz"], ["hello", "world"]]
    out = {}
    for P in (J, T):
        layer = P.text.FasterTokenizer(VOCAB)
        cased = P.text.faster_tokenizer(VOCAB, ["The FOX"],
                                        do_lower_case=False)
        out[P] = [to_numpy(t) for t in (*layer(words, **args), *cased)]
    for got, want in zip(out[T], out[J]):
        np.testing.assert_array_equal(got, want)
    tok = {P: P.text.BertTokenizerLite(VOCAB) for P in (J, T)}
    for text in TEXTS:
        assert tok[T].tokenize(text) == tok[J].tokenize(text)
        assert tok[T].encode(text, "the fox", max_seq_len=9) == \
            tok[J].encode(text, "the fox", max_seq_len=9)
    with pytest.raises(ValueError, match="special tokens"):
        tok[T].encode("the", "fox", max_seq_len=2)
    with pytest.raises(ValueError, match="batch"):
        T.text.faster_tokenizer(VOCAB, ["a"], ["b", "c"])


def test_tokenizer_output_device():
    ids, tt = T.text.faster_tokenizer(VOCAB, ["the fox"], device="cpu")
    assert ids.device.type == tt.device.type == "cpu"
    assert isinstance(ids, T.Tensor) and ids.dtype == torch.int32
    empty = T.text.faster_tokenizer(VOCAB, [])
    assert [tuple(t.shape) for t in empty] == [(0, 0), (0, 0)]


def test_string_and_vocab_tensors():
    for P in (J, T):
        st = P.text.to_string_tensor(["a b", "c", "d"], name="txt")
        assert st.shape == [3] and st.dtype == "pstring" and \
            st.place == "cpu" and st.name == "txt"
        assert st[0] == "a b" and list(st) == ["a b", "c", "d"]
        assert st[1:].tolist() == ["c", "d"] and len(st) == 3
        assert st.numpy().dtype == object
        assert st == P.text.StringTensor(["a b", "c", "d"])
        assert P.text.StringTensor("one").tolist() == ["one"]
        vt = P.text.to_map_tensor(VOCAB, name="vocab")
        assert vt["the"] == 5 and "fox" in vt and len(vt) == len(VOCAB)
        assert vt.get("nope", -1) == -1
        assert vt.get_map_tensor()["[CLS]"] == 2
        assert repr(vt) == f"VocabTensor({len(VOCAB)} tokens)"
    assert repr(T.text.StringTensor(list("abcde"))) == repr(
        J.text.StringTensor(list("abcde")))
    assert T.core.string_tensor.__all__ == J.core.string_tensor.__all__
