"""Every layer class the port's ``nn`` has, against the JAX package's, one
case a class (``analysis.layercheck.LAYER_CASES``; variants add an
option). Each side builds its layer after ``seed(0)``; the initial
weights must agree (normal draws within float32 rounding of ``erfinv``:
rtol 1e-5, atol 2e-5) and the reference's ``state_dict()`` then loads
into the port's with ``set_state_dict``, no key missing or unexpected.
Both run the case's seeded inputs forward and backward, and the outputs,
the inputs' and the parameters' gradients and the buffers (BatchNorm's
running statistics after three training calls) must agree within the
case's tolerance: elementwise rtol 1e-5 / atol 1e-6; sums, norms and
losses rtol 1e-4 / atol 1e-5; attention rtol 1e-4 / atol 1e-4 (the
float32 flash kernel's limit, which phase 11 of ``chip_smoke.py`` holds
the same cases to on the card)."""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import (LAYER_CASES, TOLERANCES,
                                                  run_case, to_numpy)

INIT_TOL = dict(rtol=1e-5, atol=2e-5)
CASES = {c.name: c for c in LAYER_CASES}


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _close(got, want, tol, what):
    rtol, atol = tol
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def build_pair(case):
    J.seed(0)
    jl = case.build(J)
    T.seed(0)
    tl = case.build(T)
    jsd = {k: to_numpy(v) for k, v in jl.state_dict().items()}
    tsd = {k: to_numpy(v) for k, v in tl.state_dict().items()}
    assert list(jsd) == list(tsd) or sorted(jsd) == sorted(tsd)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], jsd[k], err_msg=k, **INIT_TOL)
    missing, unexpected = tl.set_state_dict(jsd)
    assert missing == [] and unexpected == []
    return jl, tl


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_reference(name):
    case = CASES[name]
    jl, tl = build_pair(case)
    arrays = case.inputs(np.random.default_rng(0))
    want = run_case(J, jl, case, arrays)
    got = run_case(T, tl, case, arrays)
    tol = TOLERANCES[case.kind]
    assert len(got["outputs"]) == len(want["outputs"])
    for i, (g, w) in enumerate(zip(got["outputs"], want["outputs"])):
        _close(g, w, tol, f"output {i}")
    assert not got["detached"]
    if "reference_detached" in case.tags:
        # pinned: the reference's output takes no gradient
        assert want["detached"] and got["input_grads"]
        return
    assert sorted(got["input_grads"]) == sorted(want["input_grads"])
    for i in want["input_grads"]:
        _close(got["input_grads"][i], want["input_grads"][i], tol,
               f"input {i} grad")
    assert sorted(got["param_grads"]) == sorted(want["param_grads"])
    for n in want["param_grads"]:
        _close(got["param_grads"][n], want["param_grads"][n], tol,
               f"{n} grad")
    assert sorted(got["buffers"]) == sorted(want["buffers"])
    for n in want["buffers"]:
        _close(got["buffers"][n], want["buffers"][n], tol, n)


def test_every_layer_class_has_a_case():
    """Each layer class of the port's ``nn`` with a forward of its own is
    exercised by a case of its name (or a named variant)."""
    import torch

    classes = {n for n in T.nn.__all__
               if isinstance(getattr(T.nn, n), type)
               and issubclass(getattr(T.nn, n), T.nn.Layer)
               and n not in ("Layer", "LayerList", "LayerDict",
                             "ParameterList")}
    covered = {n for n in classes
               if n in CASES or any(c.startswith(n + "-") for c in CASES)}
    assert classes - covered == set()
    assert issubclass(T.nn.Layer, torch.nn.Module)


def test_batchnorm_running_statistics_follow_the_reference_momentum():
    """momentum 0.9 weighs the running value: after one training call
    ``_mean = 0.9 * 0 + 0.1 * batch_mean`` (torch's convention would weigh
    the batch by 0.9)."""
    layer = T.nn.BatchNorm1D(3)
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    layer(T.to_tensor(x))
    np.testing.assert_allclose(layer._mean.numpy(), 0.1 * x.mean(0),
                               rtol=1e-6)
    var = x.var(0, ddof=1)
    np.testing.assert_allclose(layer._variance.numpy(), 0.9 + 0.1 * var,
                               rtol=1e-6)


def test_attention_dropout_drops_the_output_not_the_probabilities():
    """The reference's ``dropout`` of MultiHeadAttention acts on the
    attention output ``[b, h, s, d]`` (one key, the output's shape), so
    the port's output equals ``out_proj`` of the undropped attention with
    that mask applied — never a softmax with dropped probabilities."""
    x = np.random.default_rng(3).standard_normal((2, 5, 8)).astype(
        np.float32)
    J.seed(0)
    jl = J.nn.MultiHeadAttention(8, 2, dropout=0.5)
    T.seed(0)
    tl = T.nn.MultiHeadAttention(8, 2, dropout=0.5)
    tl.set_state_dict({k: to_numpy(v) for k, v in jl.state_dict().items()})
    J.seed(11)
    want = to_numpy(jl(J.to_tensor(x)))
    T.seed(11)
    got = to_numpy(tl(T.to_tensor(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the same draw applied by hand to the undropped output
    T.seed(11)
    key = T.core.rng.next_rng_key()
    tl.eval()
    import torch

    from paddle_tpu_torch.kernels import dropout as kd

    q, k, v = (tl._shape(p(T.to_tensor(x))) for p in
               (tl.q_proj, tl.k_proj, tl.v_proj))
    att = T.nn.functional.scaled_dot_product_attention(q, k, v)
    dropped = kd.dropout_reference(att, key, 0.5)
    by_hand = tl.out_proj(dropped.transpose(1, 2).reshape(2, 5, 8))
    np.testing.assert_allclose(to_numpy(by_hand), got, rtol=1e-5,
                               atol=1e-6)
    assert torch.is_tensor(att)
