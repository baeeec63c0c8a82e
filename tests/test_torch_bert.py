"""The port's BERT (``text/bert.py``) against the JAX package's at 2
layers, hidden 64 (4 heads), vocab 211, float32, dropouts 0:

- ``seed(0)`` models equal the reference's: the same structured names
  and initial weights (normal draws within float32 rounding of
  ``erfinv``: rtol 1e-5, atol 2e-5), the encoder's second layer a copy
  of the first on both sides (the reference deep-copies the layer it is
  given);
- with the reference's ``state_dict()`` loaded by ``set_state_dict``:
  the pretraining loss (MLM over the tied word embeddings, whose
  gradient sums both uses, plus NSP) and every gradient; ``BertModel``'s
  outputs and the MLM logits; three AdamW steps; the classifier under a
  padding mask. Losses and outputs within rtol 1e-4 / atol 1e-5;
  gradients within rtol 1e-4 / atol 1e-5 of their values.

The key projection's bias is held apart: softmax ignores a shift of all
of a query's logits, so its exact gradient is 0 and both sides return
rounding noise (about 1e-9); after Adam steps, which move an entry by
up to lr whatever the gradient's size, its entries may differ by up to
2 lr a step."""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.text.bert import BertConfig as JConfig
from paddle_tpu.text.bert import BertForPretraining as JPre
from paddle_tpu.text.bert import BertForSequenceClassification as JCls
from paddle_tpu.text.bert import BertModel as JModel
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy
from paddle_tpu_torch.text import (BertConfig, BertForPretraining,
                                   BertForSequenceClassification, BertModel)

CFG = dict(vocab_size=211, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position_embeddings=32,
           hidden_dropout=0.0, attn_dropout=0.0)
INIT = dict(rtol=1e-5, atol=2e-5)
RED = dict(rtol=1e-4, atol=1e-5)
B, S, LR, STEPS = 3, 16, 1e-3, 3


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _pair(jcls, tcls, **kw):
    J.seed(0)
    jm = jcls(JConfig(**CFG), **kw)
    T.seed(0)
    tm = tcls(BertConfig(**CFG), **kw)
    return jm, tm


def _load(jm, tm):
    missing, unexpected = tm.set_state_dict(
        {k: to_numpy(v) for k, v in jm.state_dict().items()})
    assert missing == [] and unexpected == []


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab_size"], (B, S))
    mlm = np.full((B, S), -1)
    sel = rng.rand(B, S) < 0.3
    mlm[sel] = rng.randint(0, CFG["vocab_size"], int(sel.sum()))
    nsp = rng.randint(0, 2, (B,))
    tt = (np.arange(S)[None, :] >= S // 2).astype(np.int64).repeat(B, 0)
    return ids, mlm, nsp, tt


def _loss(P, model, batch):
    ids, mlm, nsp, tt = batch
    return model(P.to_tensor(ids), P.to_tensor(tt),
                 masked_lm_labels=P.to_tensor(mlm),
                 next_sentence_labels=P.to_tensor(nsp))


def _key_bias(name):
    return name.endswith("self_attn.k_proj.bias")


def test_seeded_models_equal_the_references():
    jm, tm = _pair(JPre, BertForPretraining)
    jsd = {k: to_numpy(v) for k, v in jm.state_dict().items()}
    tsd = {k: to_numpy(v) for k, v in tm.state_dict().items()}
    assert sorted(tsd) == sorted(jsd)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    for k in jsd:
        np.testing.assert_allclose(tsd[k], jsd[k], err_msg=k, **INIT)
    for k in tsd:
        if ".layers.1." in k:  # the deep copy of layer 0, both sides
            first = k.replace(".layers.1.", ".layers.0.")
            np.testing.assert_array_equal(tsd[k], tsd[first])
            np.testing.assert_array_equal(jsd[k], jsd[first])


def test_pretraining_loss_and_every_gradient():
    jm, tm = _pair(JPre, BertForPretraining)
    _load(jm, tm)
    batch = _batch()
    jl, tl = _loss(J, jm, batch), _loss(T, tm, batch)
    np.testing.assert_allclose(to_numpy(tl), to_numpy(jl), **RED)
    jl.backward()
    tl.backward()
    jg = {n: to_numpy(p.grad) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        g = to_numpy(p.grad)
        if _key_bias(n):
            assert np.abs(g).max() < 1e-5 and np.abs(jg[n]).max() < 1e-5
            continue
        np.testing.assert_allclose(g, jg[n], err_msg=n, **RED)
    # the tied word embeddings take the MLM head's gradient too
    word = "bert.embeddings.word_embeddings.weight"
    ids = set(batch[0].ravel().tolist())
    unseen = [i for i in range(CFG["vocab_size"]) if i not in ids]
    assert np.abs(to_numpy(
        dict(tm.named_parameters())[word].grad)[unseen]).max() > 0


def test_outputs_without_labels():
    jm, tm = _pair(JPre, BertForPretraining)
    _load(jm, tm)
    ids, _, _, tt = _batch(1)
    jout = jm(J.to_tensor(ids), J.to_tensor(tt))
    tout = tm(T.to_tensor(ids), T.to_tensor(tt))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), **RED)
    jb, tb = _pair(JModel, BertModel)
    _load(jb, tb)
    for a, b in zip(tb(T.to_tensor(ids)), jb(J.to_tensor(ids))):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), **RED)


def test_three_adamw_steps_float32():
    jm, tm = _pair(JPre, BertForPretraining)
    _load(jm, tm)
    jopt = J.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters())
    topt = T.optimizer.AdamW(learning_rate=LR, parameters=tm.parameters())
    for step in range(STEPS):
        batch = _batch(10 + step)
        jl, tl = _loss(J, jm, batch), _loss(T, tm, batch)
        np.testing.assert_allclose(to_numpy(tl), to_numpy(jl), **RED)
        jl.backward()
        tl.backward()
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        jp = dict(jm.named_parameters())
        for n, p in tm.named_parameters():
            got, want = to_numpy(p), to_numpy(jp[n])
            if _key_bias(n):
                assert np.abs(got - want).max() <= 2 * LR * (step + 1)
                continue
            np.testing.assert_allclose(got, want, err_msg=n, **RED)


def test_sequence_classification_under_a_padding_mask():
    jm, tm = _pair(JCls, BertForSequenceClassification, num_classes=3)
    _load(jm, tm)
    ids, _, _, tt = _batch(2)
    pad = np.array([0, 3, 7])
    mask = (np.arange(S)[None, :] < (S - pad)[:, None])[:, None, None, :]
    labels = np.array([0, 2, 1])
    jl = jm(J.to_tensor(ids), J.to_tensor(tt), J.to_tensor(mask),
            labels=J.to_tensor(labels))
    tl = tm(T.to_tensor(ids), T.to_tensor(tt), T.to_tensor(mask),
            labels=T.to_tensor(labels))
    np.testing.assert_allclose(to_numpy(tl), to_numpy(jl), **RED)
    jl.backward()
    tl.backward()
    jg = {n: to_numpy(p.grad) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        if _key_bias(n):
            continue
        np.testing.assert_allclose(to_numpy(p.grad), jg[n], err_msg=n,
                                   **RED)
    # the mask matters: without it the logits differ
    plain = tm(T.to_tensor(ids), T.to_tensor(tt))
    masked = tm(T.to_tensor(ids), T.to_tensor(tt), T.to_tensor(mask))
    assert not np.allclose(to_numpy(plain)[1:], to_numpy(masked)[1:])
