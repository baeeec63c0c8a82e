"""Float16 through attention and LayerNorm, against the JAX package on the
CPU. The kernels take float32 and bfloat16; a float16 call takes the
composites (``kernels.attention.sdpa_reference``, the plain LayerNorm:
float32 statistics cast to x's dtype), as the reference computes float16
through ``sdpa_reference`` and XLA.

- ``F.scaled_dot_product_attention`` on float16 ``[2, 2, 16, 8]`` q, k and
  v, causal and not: float16 out, within rtol / atol 2e-3 of the
  reference's (one float16 rounding of values of order 1 is 4.9e-4).
- ERNIE (2 layers, hidden 64, 4 heads) under ``amp.auto_cast(dtype=
  "float16")`` (O1) and after ``amp.decorate(level="O2", dtype=
  "float16")``: the classifier's and the MLM head's logits and loss on the reference's weights and
  ids. The logits within rtol 2e-2 / atol 2e-2 of their largest value
  (float16 rounding through two layers, each package rounding at its own
  op boundaries), the loss within rtol 1e-2.
- Attention in float16 never reaches the flash wrapper (its plain-version
  counter stays still); a float16 LayerNorm never reaches the LayerNorm
  kernel's wrapper. Under O1 the LayerNorm is black-listed and runs in
  float32, where the wrapper takes it.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_layernorm as fl

ERNIE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=32,
             hidden_dropout=0.0, attn_dropout=0.0)
SDPA_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _np(t):
    return np.asarray(t.numpy(), dtype=np.float64)


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "").replace("paddle.", "")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_float16_sdpa_matches_the_reference(causal):
    rng = np.random.RandomState(1)
    q, k, v = (rng.standard_normal((2, 2, 16, 8)).astype(np.float16)
               for _ in range(3))
    outs = {P: P.nn.functional.scaled_dot_product_attention(
        P.to_tensor(q), P.to_tensor(k), P.to_tensor(v), is_causal=causal)
        for P in (J, T)}
    assert _dtype(outs[T]) == _dtype(outs[J]) == "float16"
    np.testing.assert_allclose(_np(outs[T]), _np(outs[J]), **SDPA_TOL)


@pytest.mark.parametrize("head", ["classifier", "mlm"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_float16_ernie_matches_the_reference(level, head):
    models = {}
    for P in (J, T):
        P.seed(3)
        cfg = P.text.ErnieConfig(**ERNIE)
        models[P] = P.text.ErnieForMaskedLM(cfg) if head == "mlm" else \
            P.text.ErnieForSequenceClassification(cfg, num_classes=15)
    models[T].set_state_dict({k: np.asarray(v.numpy()) for k, v in
                              models[J].state_dict().items()})
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 97, (2, 16)).astype(np.int64)
    labels = rng.randint(0, 15, (2,)).astype(np.int64)
    if head == "mlm":
        labels = rng.randint(0, 97, (32,)).astype(np.int64)
    outs = {}
    fa_calls = fa.reference_calls
    for P in (J, T):
        m = models[P]
        m.eval()
        if level == "O2":
            m = P.amp.decorate(m, level="O2", dtype="float16")
        x = P.to_tensor(ids)
        with P.amp.auto_cast(level=level, dtype="float16"):
            logits = m(x)
        loss = P.nn.functional.cross_entropy(
            logits.astype("float32").reshape([labels.shape[0], -1]),
            P.to_tensor(labels))
        outs[P] = (logits, loss)
    assert fa.reference_calls == fa_calls
    (jl, jloss), (tl, tloss) = outs[J], outs[T]
    assert _dtype(tl) == _dtype(jl)
    assert np.isfinite(_np(tl)).all()
    scale = float(np.abs(_np(jl)).max())
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=2e-2,
                               atol=2e-2 * scale)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-2)


def test_float16_layer_norm_is_the_composite():
    x = np.random.RandomState(2).standard_normal((4, 32)).astype(np.float16)
    w = np.linspace(0.5, 1.5, 32).astype(np.float16)
    b = np.linspace(-0.1, 0.1, 32).astype(np.float16)
    fl_calls = fl.reference_calls
    outs = {P: P.nn.functional.layer_norm(
        P.to_tensor(x), 32, P.to_tensor(w), P.to_tensor(b)) for P in (J, T)}
    assert fl.reference_calls == fl_calls
    assert _dtype(outs[T]) == "float16"
    np.testing.assert_allclose(_np(outs[T]), _np(outs[J]), **SDPA_TOL)
