"""The port's training path (``nn.functional.linear_cross_entropy``, the GPT
loss, ``train.build_train_step``) against the JAX package's at a small
size.

The chunked head + cross-entropy is held against the JAX function, loss
and gradients, at float32 atol 1e-5. A tiny GPT (vocab 97, hidden 64, 2
layers, 4 heads, batch 2, seq 16, float32) takes 3 steps through the
port's ``build_train_step(..., device="cpu")`` and through a JAX step
built as ``bench.py``'s ``build_train_step`` builds it (AdamW
``multi_precision``, lr 1e-4, ``functional_update``), from the same
weights and batches (numpy, from a seed): losses agree within 1e-5 and
the parameters after 3 steps, compared under ``state_dict_to_jax``,
within atol 2e-6 (each step moves a weight by at most about lr = 1e-4;
the two frameworks' gradients differ in summation order, which can move
an update whose gradient is within a few eps of zero).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import rng as rng_mod
from paddle_tpu.core import tape as tape_mod
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import functional as JF
from paddle_tpu.text.gpt import GPTConfig as JGPTConfig
from paddle_tpu.text.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.nn.functional import linear_cross_entropy
from paddle_tpu_torch.text import (GPTConfig, GPTForCausalLM, PagedBatch,
                                   state_dict_from_jax, state_dict_to_jax)
from paddle_tpu_torch.train import build_train_step, flops_per_token

ATOL = 1e-5
PARAM_ATOL = 2e-6
TINY = dict(vocab=97, hidden=64, layers=2, heads=4, batch=2, seq=16,
            loss_chunk=12)


def _jax_lce(h, w, lab, **kw):
    with tape_mod.no_grad():
        return JF.linear_cross_entropy(Tensor(h), Tensor(w), Tensor(lab),
                                       **kw)._value


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("transpose_y", [True, False], ids=["tied", "untied"])
def test_linear_cross_entropy_matches_reference(chunk, transpose_y):
    rng = np.random.default_rng(chunk)
    h = rng.standard_normal((2, 13, 8), np.float32)
    w = rng.standard_normal((29, 8) if transpose_y else (8, 29), np.float32)
    lab = rng.integers(0, 29, (2, 13)).astype(np.int32)
    lab[0, :3] = lab[1, 7] = -100  # ignored rows
    kw = dict(transpose_y=transpose_y, chunk_size=chunk)
    want, (dh_w, dw_w) = jax.value_and_grad(
        lambda a, b: _jax_lce(a, b, jnp.asarray(lab), **kw), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    got = linear_cross_entropy(th, tw, torch.from_numpy(lab).long(), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh_w), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_w), atol=ATOL,
                               rtol=0)


def test_linear_cross_entropy_all_ignored_is_zero():
    h = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 5)
    loss = linear_cross_entropy(h, w, torch.full((4,), -100), chunk_size=3)
    loss.backward()
    assert loss.item() == 0.0 and not h.grad.abs().any()


def _jax_step(rung):
    """The JAX train step as ``bench.py``'s ``build_train_step`` builds it,
    in float32 (no ``.to(dtype="bfloat16")``)."""
    policy = rung["policy"]
    cfg = JGPTConfig(vocab_size=rung["vocab"], hidden_size=rung["hidden"],
                     num_layers=rung["layers"], num_heads=rung["heads"],
                     max_seq_len=rung["seq"], dropout=0.0,
                     recompute=policy != "off",
                     recompute_policy=None if policy == "off" else policy,
                     loss_chunk_size=rung["loss_chunk"])
    paddle.seed(0)
    model = JGPT(cfg)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    params, _ = model.functional_state()
    p_arrays = {k: v._value for k, v in params.items() if not v.stop_gradient}
    opt_state = opt.functional_init(p_arrays)

    def loss_fn(pvals, key, ids, labels):
        with tape_mod.no_grad(), rng_mod.trace_rng_scope(key):
            loss, _ = model.functional_call(pvals, {}, Tensor(ids),
                                            labels=Tensor(labels))
        return loss._value

    @jax.jit
    def train_step(pvals, opt_st, key, ids, labels):
        loss, grads = jax.value_and_grad(loss_fn)(pvals, key, ids, labels)
        new_p, new_st = opt.functional_update(pvals, grads, opt_st, 1e-4)
        return loss, new_p, new_st

    return train_step, p_arrays, opt_state


def _batches(rung, n, seed=3):
    rng = np.random.default_rng(seed)
    shape = (n, rung["batch"], rung["seq"])
    return (rng.integers(0, rung["vocab"], shape).astype(np.int32),
            rng.integers(0, rung["vocab"], shape).astype(np.int32))


@pytest.mark.parametrize("policy", ["off", None], ids=["no-remat", "full-remat"])
def test_train_steps_match_reference(policy):
    rung = dict(TINY, policy=policy)
    jstep, p_arrays, opt_state = _jax_step(rung)
    built = build_train_step(rung, device="cpu", dtype=torch.float32)
    model, cfg = built["model"], built["cfg"]
    model.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in p_arrays.items()}, cfg))
    ids_all, labels_all = _batches(rung, 3)
    key = jax.random.key(0)
    for ids, labels in zip(ids_all, labels_all):
        jloss, p_arrays, opt_state = jstep(p_arrays, opt_state, key,
                                           jnp.asarray(ids),
                                           jnp.asarray(labels))
        tloss = built["train_step"](torch.from_numpy(ids).long(),
                                    torch.from_numpy(labels).long())
        np.testing.assert_allclose(tloss.item(), float(jloss), atol=ATOL,
                                   rtol=0)
    got = state_dict_to_jax(model.state_dict(), cfg)
    for name, want in p_arrays.items():
        np.testing.assert_allclose(got[name], np.asarray(want),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    assert built["opt"]._step_count == 3


def test_loss_equals_cross_entropy_of_the_logits():
    built = build_train_step(dict(TINY, policy="off"), device="cpu",
                             dtype=torch.float32)
    model = built["model"]
    ids, labels = (torch.from_numpy(a[0]).long() for a in _batches(TINY, 1))
    labels[0, :5] = -100
    loss = model(ids, labels=labels)
    want = torch.nn.functional.cross_entropy(
        model(ids).reshape(-1, TINY["vocab"]), labels.reshape(-1))
    np.testing.assert_allclose(loss.item(), want.item(), atol=ATOL, rtol=0)


def test_state_dict_round_trip():
    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
                    max_seq_len=16)
    sd = GPTForCausalLM(cfg, device="cpu").state_dict()
    back = state_dict_from_jax(state_dict_to_jax(sd, cfg), cfg)
    assert set(back) == set(sd)
    for name, t in sd.items():
        assert torch.equal(back[name], t), name
    with pytest.raises(KeyError):
        state_dict_to_jax({k: v for k, v in sd.items()
                           if k != "gpt.wpe.weight"}, cfg)


def test_unported_training_options_raise():
    with pytest.raises(NotImplementedError, match="item 7"):
        build_train_step(dict(TINY, policy="dots"), device="cpu")
    model = GPTForCausalLM(GPTConfig(vocab_size=97, hidden_size=64,
                                     num_layers=1, num_heads=4, max_seq_len=16,
                                     dropout=0.1), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    model(ids)  # eval: dropout is off
    with pytest.raises(NotImplementedError, match="item 5"):
        model.train()(ids)
    paged = PagedBatch(torch.zeros(1), torch.zeros(1), torch.zeros(1),
                       torch.zeros(1))
    with pytest.raises(NotImplementedError, match="paged"):
        model.eval()(ids, labels=ids, paged=paged)


def test_flops_per_token_is_benchs_formula():
    built = build_train_step(dict(TINY, policy="off"), device="cpu",
                             dtype=torch.float32)
    n = built["n_params"]
    assert n == sum(p.numel() for p in built["model"].parameters())
    assert flops_per_token(built["cfg"], n, 16) == 6.0 * n + 12.0 * 2 * 16 * 64


def _bf16_ulp_flips(got, want):
    """Entries of two bf16-valued arrays that differ, after checking that
    each differs by at most one bf16 step (8 significant bits)."""
    diff = got != want
    step = np.abs(want) * 2.0 ** -7  # >= one bf16 step at that magnitude
    assert (np.abs(got - want)[diff] <= step[diff]).all()
    return int(diff.sum())


@pytest.mark.parametrize("ignored", [False, True],
                         ids=["all-rows", "ignored-rows"])
def test_linear_cross_entropy_bf16_grads_match_reference(ignored):
    """bf16 ``h [64, 32]``, ``w [500, 32]`` tied, chunk 16 (numpy seed 0):
    the reference forms ``dh`` and ``dw`` from the float32 logit gradient
    and rounds once (the chunks' ``dw`` then summed in bf16, last chunk
    first); the port's CPU backward does the same arithmetic in the same
    order. The loss is equal, and on all rows so are both gradients, bit
    for bit. The two frameworks' float32 products sum in other orders
    (XLA's CPU dot and PyTorch's differ in the last float32 bit on most
    entries of the same product), so a sum lying at a bf16 rounding
    boundary can round one step apart: with ignored rows (a loss scale of
    1/62) two entries of ``dw`` do. Held there: every entry within one
    bf16 step, at most 0.1% of entries different."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((64, 32)).astype(np.float32)
    w = rng.standard_normal((500, 32)).astype(np.float32)
    lab = rng.integers(0, 500, (64,)).astype(np.int32)
    if ignored:
        lab[5] = lab[40] = -100
    jh, jw = (jnp.asarray(a).astype(jnp.bfloat16) for a in (h, w))
    kw = dict(transpose_y=True, chunk_size=16)
    want, (dh_w, dw_w) = jax.value_and_grad(
        lambda a, b: _jax_lce(a, b, jnp.asarray(lab), **kw), argnums=(0, 1))(
        jh, jw)
    th, tw = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_() for a in (jh, jw))
    got = linear_cross_entropy(th, tw, torch.from_numpy(lab).long(), **kw)
    got.backward()
    assert got.item() == float(want)
    flips = [_bf16_ulp_flips(t.grad.float().numpy(),
                             np.asarray(j.astype(jnp.float32)))
             for t, j in ((th, dh_w), (tw, dw_w))]
    if not ignored:
        assert flips == [0, 0]
    assert flips[0] <= 0.001 * th.numel() and flips[1] <= 0.001 * tw.numel()


def test_train_step_bf16_loss_and_grads_match_reference():
    """One bf16 step of the 2-layer GPT, the JAX model cast as ``bench.py``
    casts it (``model.to(dtype="bfloat16")``), the port's built by
    ``build_train_step(dtype=torch.bfloat16)`` from the same bf16 weights.
    bf16 keeps 8 significant bits (a rounding moves a value by up to 0.4%)
    and the two frameworks round at different points through attention,
    GELU and LayerNorm, so most gradient entries differ in their last
    bits. Held: the loss within 1e-3 relative, and each gradient within
    5% of its largest entry at any entry and 0.5% on average (measured
    at most 2.6% and far below 0.5%)."""
    rung = dict(TINY, policy="off")
    cfg = JGPTConfig(vocab_size=97, hidden_size=64, num_layers=2,
                     num_heads=4, max_seq_len=16, dropout=0.0,
                     loss_chunk_size=12)
    paddle.seed(0)
    jm = JGPT(cfg)
    jm.to(dtype="bfloat16")
    p_arrays = {k: v._value for k, v in jm.functional_state()[0].items()
                if not v.stop_gradient}
    ids, labels = (a[0] for a in _batches(rung, 1))

    def loss_fn(pvals):
        with tape_mod.no_grad(), rng_mod.trace_rng_scope(jax.random.key(0)):
            loss, _ = jm.functional_call(pvals, {}, Tensor(jnp.asarray(ids)),
                                         labels=Tensor(jnp.asarray(labels)))
        return loss._value

    jloss, jgrads = jax.value_and_grad(loss_fn)(p_arrays)
    built = build_train_step(rung, device="cpu", dtype=torch.bfloat16)
    model = built["model"]
    model.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v.astype(jnp.float32)) for k, v in p_arrays.items()},
        built["cfg"]))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    loss = model(torch.from_numpy(ids).long(),
                 labels=torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-3)
    got = state_dict_to_jax({k: p.grad.float()
                             for k, p in model.named_parameters()},
                            built["cfg"])
    for name, want in jgrads.items():
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got[name] - want) / np.abs(want).max()
        assert err.max() <= 0.05 and err.mean() <= 0.005, (
            name, err.max(), err.mean())
