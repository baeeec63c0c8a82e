"""The port's recompute (``paddle_tpu_torch.distributed.fleet.recompute``)
on a 2-layer GPT with dropout 0.1 (vocab 97, hidden 64, 4 heads, batch 2,
seq 16, float32, the reference's weights), under the policies ``"off"``
(no remat), ``"dots"`` and ``None`` (full).

Recompute runs a block's forward again in the backward. Its dropout
masks must be the first forward's (the key source is replayed), so the
loss and every gradient are equal bit for bit across the three policies;
and they equal the JAX step's under the same key within float32
summation order (loss atol 1e-5; each gradient within 1e-4 of its
largest entry, the two frameworks summing products in other orders).

What a policy keeps is counted on the CPU: tensors saved for the backward
outside checkpointed regions (``saved_tensors_hooks``) plus the outputs a
selective policy keeps (``recompute.saved_outputs``). ``dots`` keeps the
four Linear products of each block: fewer than no remat, more than full.
The plain versions' call counts give the recompute's extra forwards.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu.core import rng as J
from paddle_tpu.core import tape as tape_mod
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.text.gpt import GPTConfig as JGPTConfig
from paddle_tpu.text.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.core import rng as T
from paddle_tpu_torch.distributed.fleet import apply_recompute, recompute
from paddle_tpu_torch.kernels import dropout as kd
from paddle_tpu_torch.kernels import fused_layernorm as fl
from paddle_tpu_torch.text import (GPTConfig, GPTForCausalLM,
                                   state_dict_from_jax, state_dict_to_jax)

rc = importlib.import_module("paddle_tpu_torch.distributed.fleet.recompute")

LAYERS = 2
POLICIES = {"off": "off", "dots": "dots", "full": None}
KEY = 11


def _cfg(module, policy, dropout=0.1):
    return module(vocab_size=97, hidden_size=64, num_layers=LAYERS,
                  num_heads=4, max_seq_len=16, dropout=dropout,
                  recompute=policy != "off",
                  recompute_policy=None if policy == "off" else policy,
                  loss_chunk_size=12)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(2)
    return (rng.integers(0, 97, (2, 16)).astype(np.int32),
            rng.integers(0, 97, (2, 16)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_weights():
    paddle.seed(0)
    model = JGPT(_cfg(JGPTConfig, "off"))
    params, _ = model.functional_state()
    return {k: np.asarray(v._value) for k, v in params.items()}


def _port_step(policy, weights, batch, key=(0, KEY)):
    cfg = _cfg(GPTConfig, policy)
    model = GPTForCausalLM(cfg, device="cpu").train()
    model.load_state_dict(state_dict_from_jax(weights, cfg))
    ids, labels = (torch.from_numpy(a).long() for a in batch)
    before = (kd.reference_calls, fl.reference_calls, rc.saved_outputs)
    packed = [0]

    def pack(t):
        packed[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with T.trace_rng_scope(key):
            loss = model(ids, labels=labels)
    fwd = kd.reference_calls - before[0]
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return dict(loss=loss, grads=grads, cfg=cfg,
                saved=packed[0] + rc.saved_outputs - before[2],
                dropout_fwd=fwd, dropout_calls=kd.reference_calls - before[0],
                ln_calls=fl.reference_calls - before[1])


@pytest.fixture(scope="module")
def port_runs(jax_weights, batch):
    return {name: _port_step(policy, jax_weights, batch)
            for name, policy in POLICIES.items()}


@pytest.mark.parametrize("name", ["dots", "full"])
def test_remat_loss_and_grads_equal_no_remat(port_runs, name):
    got, want = port_runs[name], port_runs["off"]
    assert torch.equal(got["loss"], want["loss"])
    for n, g in want["grads"].items():
        assert torch.equal(got["grads"][n], g), n


@pytest.mark.parametrize("name", POLICIES)
def test_loss_and_grads_match_the_jax_step(port_runs, jax_weights, batch,
                                           name):
    paddle.seed(0)
    model = JGPT(_cfg(JGPTConfig, POLICIES[name]))
    key = jax.random.key(KEY)

    def loss_fn(pvals):
        with tape_mod.no_grad(), J.trace_rng_scope(key):
            loss, _ = model.functional_call(pvals, {}, Tensor(batch[0]),
                                            labels=Tensor(batch[1]))
        return loss._value

    pvals = {k: jax.numpy.asarray(v) for k, v in jax_weights.items()}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(pvals)
    run = port_runs[name]
    np.testing.assert_allclose(run["loss"].item(), float(loss), atol=1e-5,
                               rtol=0)
    got = state_dict_to_jax(run["grads"], run["cfg"])
    for n, g in grads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(got[n], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=n)
    # dropout fired: the loss differs from the same step without it
    cfg0 = _cfg(GPTConfig, "off", dropout=0.0)
    m0 = GPTForCausalLM(cfg0, device="cpu").train()
    m0.load_state_dict(state_dict_from_jax(jax_weights, cfg0))
    loss0 = m0(torch.from_numpy(batch[0]).long(),
               labels=torch.from_numpy(batch[1]).long())
    assert loss0.item() != run["loss"].item()


def test_saved_tensor_counts_order_off_dots_full(port_runs):
    saved = {k: v["saved"] for k, v in port_runs.items()}
    assert saved["off"] > saved["dots"] > saved["full"], saved
    # dots keeps exactly the four Linear products of each block
    assert saved["dots"] - saved["full"] == 4 * LAYERS


def test_recompute_runs_the_forward_again_up_to_the_last_saved_tensor(
        port_runs):
    """Dropout draws at 1 + 3L sites a forward, each with a backward; a
    recomputed block runs its attention and residual dropouts again, not
    the MLP's (fc2's input is its last saved tensor), and both
    LayerNorms."""
    sites = 1 + 3 * LAYERS
    for name, run in port_runs.items():
        remat = name != "off"
        assert run["dropout_fwd"] == sites
        assert run["dropout_calls"] == 2 * sites + (2 * LAYERS if remat
                                                    else 0)
        assert run["ln_calls"] == 2 * (2 * LAYERS + 1) + (
            2 * LAYERS if remat else 0)


def test_the_eager_generator_is_replayed_too(jax_weights, batch):
    """Outside a scope, the process-wide generator draws; recompute
    replays its draws as well."""
    out = {}
    for name in ("off", "dots"):
        cfg = _cfg(GPTConfig, POLICIES[name])
        model = GPTForCausalLM(cfg, device="cpu").train()
        model.load_state_dict(state_dict_from_jax(jax_weights, cfg))
        T.seed(123)
        loss = model(torch.from_numpy(batch[0]).long(),
                     labels=torch.from_numpy(batch[1]).long())
        loss.backward()
        out[name] = (loss, [p.grad for p in model.parameters()])
    assert torch.equal(out["off"][0], out["dots"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["off"][1],
                                                 out["dots"][1]))


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.blocks = nn.ModuleList([nn.Linear(4, 4) for _ in range(3)])
        self.head = nn.Linear(4, 1)

    def forward(self, x):
        for b in self.blocks:
            x = torch.tanh(b(x))
        return self.head(x)


@pytest.mark.parametrize("policy", [None, "full", "dots", "dots_saveable",
                                    "nothing", "everything"])
def test_policies_give_the_plain_gradients(policy):
    torch.manual_seed(0)
    net = _Net()
    x = torch.randn(5, 4)
    net(x).sum().backward()
    want = [p.grad.clone() for p in net.parameters()]
    net.zero_grad()
    assert apply_recompute(net, policy=policy) == 3
    assert apply_recompute(net, policy=policy) == 3  # idempotent
    net(x).sum().backward()
    for a, b in zip(net.parameters(), want):
        torch.testing.assert_close(a.grad, b, rtol=0, atol=0)


def test_apply_recompute_by_name_and_recompute_calls():
    net = _Net()
    assert apply_recompute(net, checkpoints=[r"blocks\.[02]$"]) == 2
    assert net.blocks[0]._recompute_wrapped
    assert not getattr(net.blocks[1], "_recompute_wrapped", False)
    x = torch.randn(2, 4, requires_grad=True)
    recompute(net.head, x).sum().backward()
    assert x.grad is not None
    with torch.no_grad():  # nothing to record: called as it is
        assert torch.equal(recompute(net.head, x), net.head(x))
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(net.head, x, policy="some")
