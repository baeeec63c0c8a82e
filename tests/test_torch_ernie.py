"""ERNIE (``text/ernie.py``) in the port against the JAX package, at the
reference test's tiny configuration (``tests/test_text.py:97-100``:
vocab 120, hidden 32, 2 layers of 2 heads, 16 positions, no dropout).

- ``seed(s)`` construction gives the reference's parameters (within
  float32 rounding of the normal draws, INIT_TOL), under the reference's
  names, and its ``state_dict()`` loads with ``set_state_dict``.
- ``ErnieForSequenceClassification``'s logits with and without
  ``task_type_ids`` (which must move them), and with an attention mask.
- ``ErnieForMaskedLM``'s loss (``-1`` labels ignored) and every
  parameter's gradient in float32 within rtol 1e-5 / atol 1e-5 of the
  largest gradient (summation order), then six Adam steps in lockstep,
  the losses and the parameters after the last within 1e-5. ``epsilon``
  1e-4 keeps the key projection's bias, whose exact gradient is 0 (the
  softmax ignores a shift of every score), from taking a full Adam step
  on each package's own rounding.
- ``ernie_config``'s presets and ``ErnieModel``'s outputs.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy

INIT_TOL = dict(rtol=1e-5, atol=2e-5)
F32 = dict(rtol=1e-5, atol=1e-5)
CFG = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_position_embeddings=16,
           hidden_dropout=0.0, attn_dropout=0.0)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _state(layer) -> dict:
    return {k: to_numpy(v) for k, v in layer.state_dict().items()}


def _pair(cls, seed=6, **kw):
    """The reference's model and the port's, each built after
    ``seed(seed)``; the port's then carries the reference's weights."""
    models = {}
    for P in (J, T):
        P.seed(seed)
        models[P] = getattr(P.text, cls)(P.text.ErnieConfig(**CFG), **kw)
    return models


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 120, (2, 12)).astype(np.int64)
    task = np.ones((2, 12), np.int64)
    labels = rng.randint(0, 120, (2, 12))
    labels[0, :6] = -1
    return ids, task, labels.astype(np.int64)


@pytest.mark.parametrize("cls,kw", [
    ("ErnieForMaskedLM", {}), ("ErnieForSequenceClassification",
                               {"num_classes": 3}), ("ErnieModel", {})])
def test_seed_draws_the_references_weights(cls, kw):
    models = _pair(cls, **kw)
    want, got = _state(models[J]), _state(models[T])
    assert sorted(got) == sorted(want)
    assert any("task_type_embeddings" in k for k in want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **INIT_TOL)
    missing, unexpected = models[T].set_state_dict(want)
    assert missing == [] and unexpected == []


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_classifier_logits_with_and_without_task_ids(masked):
    models = _pair("ErnieForSequenceClassification", num_classes=3)
    models[T].set_state_dict(_state(models[J]))
    ids, task, _ = _inputs()
    mask = None
    if masked:  # the second row's last 4 positions hidden
        mask = np.ones((2, 1, 1, 12), bool)
        mask[1, ..., 8:] = False
    out = {}
    for P in (J, T):
        m = P.to_tensor(mask) if masked else None
        out[P] = [to_numpy(models[P](P.to_tensor(ids), attention_mask=m,
                                     task_type_ids=t))
                  for t in (None, P.to_tensor(task))]
    for got, want in zip(out[T], out[J]):
        assert got.shape == (2, 3)
        np.testing.assert_allclose(got, want, **F32)
    assert not np.allclose(out[T][0], out[T][1])


def test_mlm_loss_gradients_and_adam_steps():
    models = _pair("ErnieForMaskedLM")
    models[T].set_state_dict(_state(models[J]))
    ids, task, labels = _inputs()
    opts = {P: P.optimizer.Adam(5e-3, epsilon=1e-4,
                                parameters=models[P].parameters())
            for P in (J, T)}
    losses = {J: [], T: []}
    for step in range(6):
        grads = {}
        for P in (J, T):
            loss = models[P](P.to_tensor(ids),
                             task_type_ids=P.to_tensor(task),
                             masked_lm_labels=P.to_tensor(labels))
            loss.backward()
            losses[P].append(float(to_numpy(loss)))
            grads[P] = {n: None if p.grad is None else to_numpy(p.grad)
                        for n, p in models[P].named_parameters()}
            opts[P].step()
            opts[P].clear_grad()
        if step == 0:  # the pooler takes no part in the MLM loss
            assert {n for n, g in grads[T].items() if g is None} == \
                {n for n, g in grads[J].items() if g is None} == \
                {"ernie.pooler.weight", "ernie.pooler.bias"}
            top = max(float(np.abs(g).max()) for g in grads[J].values()
                      if g is not None)
            for n, g in grads[J].items():
                if g is not None:
                    np.testing.assert_allclose(grads[T][n], g, err_msg=n,
                                               rtol=1e-5, atol=1e-5 * top)
    np.testing.assert_allclose(losses[T], losses[J], **F32)
    assert losses[T][-1] < losses[T][0]
    want, got = _state(models[J]), _state(models[T])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **F32)


def test_mlm_logits_and_the_model_outputs():
    models = _pair("ErnieForMaskedLM")
    models[T].set_state_dict(_state(models[J]))
    ids, task, _ = _inputs(1)
    logits = {P: to_numpy(models[P](P.to_tensor(ids))) for P in (J, T)}
    assert logits[T].shape == (2, 12, 120)
    np.testing.assert_allclose(logits[T], logits[J], **F32)
    seq = {P: [to_numpy(o) for o in models[P].ernie(P.to_tensor(ids))]
           for P in (J, T)}
    for got, want in zip(seq[T], seq[J]):
        np.testing.assert_allclose(got, want, **F32)


def test_presets_and_defaults():
    for name in ("ernie-3.0-base", "ernie-3.0-medium", "ernie-3.0-xbase"):
        assert vars(T.text.ernie_config(name)) == \
            vars(J.text.ernie_config(name))
    base = T.text.ernie_config("ernie-3.0-base", hidden_dropout=0.0)
    assert (base.hidden_size, base.num_layers, base.num_heads,
            base.vocab_size, base.max_position_embeddings,
            base.hidden_dropout) == (768, 12, 12, 18000, 513, 0.0)
    assert T.text.ErnieConfig() == T.text.ernie.ErnieConfig(**vars(
        J.text.ErnieConfig()))


def test_without_task_ids_the_embedding_is_absent():
    cfg = dict(CFG, use_task_id=False)
    for P in (J, T):
        P.seed(0)
    jm = J.text.ErnieModel(J.text.ErnieConfig(**cfg))
    tm = T.text.ErnieModel(T.text.ErnieConfig(**cfg))
    assert tm.embeddings.task_type_embeddings is None
    assert sorted(_state(tm)) == sorted(_state(jm))
    tm.set_state_dict(_state(jm))
    ids = _inputs(2)[0]
    np.testing.assert_allclose(to_numpy(tm(T.to_tensor(ids))[1]),
                               to_numpy(jm(J.to_tensor(ids))[1]), **F32)
    with torch.no_grad():
        assert tm(torch.as_tensor(ids))[0].shape == (2, 12, 32)


def test_float64_mlm_with_dropout_matches_the_reference():
    """In float64 with both dropouts at 0.1: the LayerNorms take the
    composite with float64 statistics, attention without a mask the
    composite (the kernels take no float64, nor do the reference's), the
    MLM head float64 logits, and dropout the reference's bits divided in
    float64. The reference rounds its LayerNorm statistics and its
    fused head's logits through float32 (pinned divergences: the port's
    float64 model stays float64, so that the card and the CPU agree to
    float64 rounding); so the loss within rtol 1e-6 and every gradient
    within 1e-5 of its own largest (a gradient that is 0 but for the
    reference's float32 rounding, below 1e-5 of the model's largest: the
    key projection's bias, of the model's largest). A
    dropout mask off by one element would be off by far more."""
    cfg = dict(CFG, hidden_dropout=0.1, attn_dropout=0.1)
    models = {}
    for P in (J, T):
        P.seed(6)
        models[P] = P.text.ErnieForMaskedLM(P.text.ErnieConfig(**cfg))
    models[T].set_state_dict(_state(models[J]))
    ids, task, labels = _inputs(3)
    out = {}
    for P in (J, T):
        models[P].to(dtype="float64")
        P.seed(11)
        loss = models[P](P.to_tensor(ids), task_type_ids=P.to_tensor(task),
                         masked_lm_labels=P.to_tensor(labels))
        loss.backward()
        out[P] = (float(to_numpy(loss)), {
            n: to_numpy(p.grad) for n, p in models[P].named_parameters()
            if p.grad is not None})
    assert models[T].ernie.embeddings.word_embeddings.weight.dtype == \
        torch.float64
    np.testing.assert_allclose(out[T][0], out[J][0], rtol=1e-6)
    assert sorted(out[T][1]) == sorted(out[J][1])
    top = max(float(np.abs(g).max()) for g in out[J][1].values())
    for n, want in out[J][1].items():
        own = float(np.abs(want).max())
        scale = top if own < 1e-5 * top else own
        err = float(np.abs(out[T][1][n] - want).max())
        assert err <= 1e-5 * scale, (n, err, scale)


def test_float64_layer_norm_attention_and_head_stay_float64():
    """The float64 routes: LayerNorm's statistics, unmasked attention's
    logits and the fused head's logits in float64 (against numpy in
    float64, within 1e-12)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 3, 5, 4)) for _ in range(3))
    got = T.nn.functional.scaled_dot_product_attention(
        *(torch.tensor(a) for a in (q, k, v)), training=False)
    s = q @ np.swapaxes(k, -1, -2) * np.float32(0.5)
    p = np.exp(s - s.max(-1, keepdims=True))
    np.testing.assert_allclose(got.numpy(), (p / p.sum(-1, keepdims=True)) @ v,
                               rtol=1e-12, atol=1e-12)
    x = rng.standard_normal((6, 8)) * 3 + 1
    w, b = rng.standard_normal(8), rng.standard_normal(8)
    got = T.nn.functional.layer_norm(torch.tensor(x), 8, torch.tensor(w),
                                     torch.tensor(b), epsilon=1e-12)
    mu = x.mean(-1, keepdims=True)
    want = (x - mu) / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True)
                              + 1e-12) * w + b
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    h, emb = rng.standard_normal((5, 8)), rng.standard_normal((11, 8))
    lab = np.array([3, -1, 0, 10, 4])
    loss = T.nn.functional.linear_cross_entropy(
        torch.tensor(h), torch.tensor(emb), torch.tensor(lab),
        transpose_y=True, ignore_index=-1, chunk_size=2)
    logits = h @ emb.T
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    keep = lab >= 0
    want = (lse[keep] - logits[keep, lab[keep]]).mean()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss), want, rtol=1e-12)
