"""``TransformerMT`` and ``sinusoid_position_encoding``
(``text/transformer_mt.py``) in the port against the JAX package, at the
reference test's tiny configuration (``tests/test_transformer_mt.py:
20-25``: vocabularies of 20, d_model 32, 4 heads, 1 + 1 layers, FFN 64,
24 positions, label smoothing 0.1).

- The sinusoid table within 1e-6 (sin and cos of float32 angles up to
  23 radians: one float32 ulp of the angle), and its odd-``d_model``
  raise.
- ``seed(s)`` construction gives the reference's parameters and the
  ``pos_table`` buffer; the reference's ``state_dict()`` loads.
- The teacher-forced forward on pad-filled sources and targets: the
  logits, the label-smoothed loss masked over pad positions, and every
  gradient but the embeddings', float32 within rtol / atol 1e-5 (of the
  largest gradient). The reference's embeddings take no gradient through
  their lookups (its ``_embed`` rebuilds the sum from raw arrays); the
  port's do, and the test pins that divergence.
- ``beam_search`` and ``translate``: ids and lengths equal, on random
  carried weights in float64 (no near-ties can flip between two float32
  orders of summation), at two beam widths; then ``translate``'s pad
  fill and ``eos`` ends.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy

INIT_TOL = dict(rtol=1e-5, atol=2e-5)
EMBEDDINGS = ("src_emb.weight", "tgt_emb.weight")
F32 = dict(rtol=1e-5, atol=1e-5)
CFG = dict(src_vocab_size=20, tgt_vocab_size=20, d_model=32, nhead=4,
           num_encoder_layers=1, num_decoder_layers=1, dim_feedforward=64,
           dropout=0.0, max_length=24, bos_id=0, eos_id=1, pad_id=2,
           label_smooth_eps=0.1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _state(layer) -> dict:
    return {k: to_numpy(v) for k, v in layer.state_dict().items()}


def _pair(seed=42, **kw):
    models = {}
    for P in (J, T):
        P.seed(seed)
        models[P] = P.text.TransformerMT(
            P.text.TransformerMTConfig(**dict(CFG, **kw)))
    return models


def _batch(seed=0, b=3):
    """Sources of 6 and targets of 5 tokens (3-19), tails padded."""
    rng = np.random.RandomState(seed)
    src = rng.randint(3, 20, (b, 6))
    src[1, 4:] = 2
    tgt = rng.randint(3, 20, (b, 5))
    labels = rng.randint(3, 20, (b, 5))
    tgt[-1, 3:] = labels[-1, 3:] = 2
    return src, tgt, labels


@pytest.mark.parametrize("max_len,d", [(24, 32), (256, 512), (7, 2)])
def test_sinusoid_position_encoding(max_len, d):
    want = np.asarray(J.text.sinusoid_position_encoding(max_len, d))
    got = to_numpy(T.text.sinusoid_position_encoding(max_len, d,
                                                     device="cpu"))
    assert got.dtype == np.float32 and got.shape == (max_len, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sinusoid_position_encoding_odd_d_model_raises():
    for P in (J, T):
        with pytest.raises(ValueError, match="even"):
            P.text.sinusoid_position_encoding(8, 5)


@pytest.mark.parametrize("tie", [False, True], ids=["head", "tied"])
def test_seed_draws_the_references_weights(tie):
    models = _pair(tie_embeddings=tie)
    want, got = _state(models[J]), _state(models[T])
    assert sorted(got) == sorted(want) and "pos_table" in want
    assert ("head.weight" in want) != tie
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **INIT_TOL)
    models[T].pos_table.zero_()
    missing, unexpected = models[T].set_state_dict(want)
    assert missing == [] and unexpected == []
    np.testing.assert_allclose(to_numpy(models[T].pos_table),
                               want["pos_table"], atol=1e-6)


@pytest.mark.parametrize("tie", [False, True], ids=["head", "tied"])
def test_teacher_forced_logits_loss_and_gradients(tie):
    models = _pair(tie_embeddings=tie)
    models[T].set_state_dict(_state(models[J]))
    src, tgt, labels = _batch()
    out = {}
    for P in (J, T):
        m = models[P]
        logits = to_numpy(m(P.to_tensor(src), P.to_tensor(tgt)))
        loss = m(P.to_tensor(src), P.to_tensor(tgt),
                 labels=P.to_tensor(labels))
        loss.backward()
        out[P] = (logits, float(to_numpy(loss)),
                  {n: None if p.grad is None else to_numpy(p.grad)
                   for n, p in m.named_parameters()})
    (wl, wloss, wg), (gl, gloss, gg) = out[J], out[T]
    assert gl.shape == (3, 5, 20)
    np.testing.assert_allclose(gl, wl, **F32)
    np.testing.assert_allclose(gloss, wloss, **F32)
    assert sorted(gg) == sorted(wg)
    # pinned divergence: the reference's _embed rebuilds the embedded
    # tokens from raw arrays (paddle_tpu/text/transformer_mt.py:83), so
    # no gradient reaches an embedding through its lookup (a tied
    # tgt_emb takes the head's only); the port's lookups take theirs
    assert {n for n, g in wg.items() if g is None} == (
        {"src_emb.weight"} if tie else set(EMBEDDINGS))
    assert all(gg[n] is not None for n in EMBEDDINGS)
    top = max(float(np.abs(g).max()) for g in wg.values() if g is not None)
    for n in wg:
        if n not in EMBEDDINGS:
            np.testing.assert_allclose(gg[n], wg[n], err_msg=n, rtol=1e-5,
                                       atol=1e-5 * top)


def test_loss_counts_only_valid_positions():
    """Padding every label but one leaves that position's smoothed
    cross-entropy."""
    models = _pair()
    models[T].set_state_dict(_state(models[J]))
    src, tgt, labels = _batch(1, b=2)
    labels[:] = 2
    labels[0, 2] = 7
    got = float(to_numpy(models[T](T.to_tensor(src), T.to_tensor(tgt),
                                   labels=T.to_tensor(labels))))
    logits = to_numpy(models[T](T.to_tensor(src), T.to_tensor(tgt)))[0, 2]
    lp = logits - logits.max() - np.log(np.exp(logits - logits.max()).sum())
    want = -(0.9 * lp[7] + 0.1 * lp.mean())
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.fixture(scope="module")
def carried64():
    """The reference's model and the port's with its weights, in float64
    and eval mode, with random weights (normal, 0.3) so that the beams
    spread."""
    prev = _device._CURRENT
    T.set_device("cpu")
    models = _pair(7)
    rng = np.random.default_rng(3)
    state = {k: (v if k == "pos_table" else
                 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in _state(models[J]).items()}
    for P in (J, T):
        models[P].set_state_dict(state)
        models[P].to(dtype="float64")
        models[P].eval()
    yield models
    _device._CURRENT = prev


@pytest.mark.parametrize("beam,max_len", [(3, 10), (1, 8)])
def test_beam_search_and_translate_equal_the_reference(carried64, beam,
                                                       max_len):
    src = _batch(2)[0]
    out = {}
    for P, m in carried64.items():
        ids, lengths = m.beam_search(P.to_tensor(src), beam_size=beam,
                                     max_len=max_len)
        best = m.translate(P.to_tensor(src), beam_size=beam,
                           max_len=max_len)
        out[P] = [to_numpy(t) for t in (ids, lengths, best)]
    for got, want, what in zip(out[T], out[J], ("ids", "lengths", "best")):
        np.testing.assert_array_equal(got, want, err_msg=what)
    ids, lengths, best = out[T]
    assert ids.shape == (3, max_len, beam) and lengths.shape == (3, beam)
    for row, n in zip(best, lengths[:, 0]):
        assert (row[n:] == CFG["pad_id"]).all()
        assert n == max_len or row[n - 1] == CFG["eos_id"]


def test_beam_search_restores_training_mode_and_records_no_graph():
    """``beam_search`` runs in eval mode without autograd (each step's
    decoder activations would otherwise stay alive through the beam
    scores) and leaves the model in the mode it found."""
    models = _pair()
    m = models[T]
    m.train()
    modes = []
    hook = m.transformer.decoder.register_forward_pre_hook(
        lambda *_: modes.append((torch.is_grad_enabled(), m.training)))
    m.beam_search(T.to_tensor(_batch(3)[0]), beam_size=2, max_len=4)
    hook.remove()
    assert modes and set(modes) == {(False, False)}
    assert m.training and torch.is_grad_enabled()
