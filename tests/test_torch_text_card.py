"""ERNIE, TransformerMT and a vision family on the card against CPU copies
of themselves, in float64: the loss, every gradient and the beam-search
outputs; and a bf16 ERNIE step through the kernels, counted.

A float64 model of the port stays float64 on either device (LayerNorm
and unmasked attention take the composite, dropout's kernel takes
float64), so the card and the CPU agree to float64 rounding: within
1e-10 of each array's own largest value (a gradient that is 0 but for
rounding, below 1e-8 of the model's largest, within 1e-10 of that).

This file imports no JAX, so it runs on the card:
``python -m pytest --noconftest tests/test_torch_text_card.py -q``. On a
machine without a CUDA device each test skips with the reason."""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import _device
from paddle_tpu_torch.kernels import dropout as kd
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_layernorm as fl

REL, ZERO = 1e-10, 1e-8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels and the float64 "
                    "routes under test run on the card")
    prev = _device._CURRENT
    paddle.set_device("gpu")
    yield
    _device._CURRENT = prev


def _pair(build):
    """A model built on the card from the seed, and a CPU copy, both
    float64."""
    paddle.seed(0)
    card = build()
    host = copy.deepcopy(card)
    host.to(device="cpu")
    card.to(dtype="float64")
    host.to(dtype="float64")
    return card, host


def _step(card, host, *args):
    """Each model's loss on ``args`` (each package seeded just before, for
    dropout's keys) and its gradients."""
    out = []
    for model in (card, host):
        dev = next(iter(model.parameters())).device
        paddle.set_device("cpu" if dev.type == "cpu" else "gpu")
        paddle.seed(3)
        loss = model(*(None if a is None else a.to(dev) for a in args))
        loss.backward()
        out.append((loss.item(), {n: p.grad.detach().cpu()
                                  for n, p in model.named_parameters()
                                  if p.grad is not None}))
    paddle.set_device("gpu")
    return out


def _close(got, want):
    (gl, gg), (wl, wg) = got, want
    assert abs(gl - wl) <= REL * abs(wl)
    assert sorted(gg) == sorted(wg)
    top = max(float(w.abs().max()) for w in wg.values())
    for n, w in wg.items():
        own = float(w.abs().max())
        scale = top if own < ZERO * top else own
        assert float((gg[n] - w).abs().max()) <= REL * scale, n


def test_ernie_float64_with_dropout_matches_its_cpu_copy(card):
    from paddle_tpu_torch.text import ErnieConfig, ErnieForMaskedLM

    cfg = ErnieConfig(vocab_size=300, hidden_size=64, num_layers=2,
                      num_heads=4, intermediate_size=128,
                      max_position_embeddings=64)
    pair = _pair(lambda: ErnieForMaskedLM(cfg))
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.randint(0, 300, (2, 32)))
    labels = torch.as_tensor(np.where(rng.rand(2, 32) < 0.3,
                                      rng.randint(0, 300, (2, 32)), -1))
    _close(*_step(*pair, ids, None, None, None, labels))


def test_transformer_float64_loss_and_beam_search(card):
    from paddle_tpu_torch.text import TransformerMT, TransformerMTConfig

    cfg = TransformerMTConfig(src_vocab_size=40, tgt_vocab_size=40,
                              d_model=32, nhead=4, num_encoder_layers=2,
                              num_decoder_layers=2, dim_feedforward=64,
                              max_length=32)
    card_m, host_m = _pair(lambda: TransformerMT(cfg))
    rng = np.random.RandomState(1)
    src = torch.as_tensor(rng.randint(3, 40, (3, 9)))
    tgt = torch.as_tensor(rng.randint(3, 40, (3, 7)))
    lab = torch.as_tensor(rng.randint(3, 40, (3, 7)))
    src[1, 6:] = tgt[2, 5:] = lab[2, 5:] = cfg.pad_id
    _close(*_step(card_m, host_m, src, tgt, lab))
    outs = []
    for model in (card_m, host_m):
        dev = next(iter(model.parameters())).device
        ids, lengths = model.beam_search(src.to(dev), beam_size=3,
                                         max_len=12)
        outs.append((ids.cpu(), lengths.cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_vision_family_float64_matches_its_cpu_copy(card):
    from paddle_tpu_torch.vision.models import squeezenet1_1

    card_m, host_m = _pair(lambda: squeezenet1_1(num_classes=10))
    rng = np.random.RandomState(2)
    x = torch.as_tensor(rng.rand(2, 3, 64, 64))
    y = torch.as_tensor(rng.randint(0, 10, 2))

    class Loss(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x, y):
            return paddle.nn.functional.cross_entropy(self.model(x), y)

    _close(*_step(Loss(card_m), Loss(host_m), x, y))
    for (n, a), (_, b) in zip(card_m.named_buffers(),
                              host_m.named_buffers()):
        assert float((a.cpu() - b).abs().max()) <= REL * max(
            float(b.abs().max()), 1.0), n


def test_bf16_ernie_step_runs_the_kernels(card):
    """A bf16 ERNIE forward and backward with its dropouts on: flash once
    a layer each way, LayerNorm 2L + 2 each way, dropout 3L + 1 each way,
    no plain version."""
    from paddle_tpu_torch.text import ErnieConfig, ErnieForMaskedLM

    cfg = ErnieConfig(vocab_size=300, hidden_size=128, num_layers=2,
                      num_heads=2, intermediate_size=256,
                      max_position_embeddings=128)
    paddle.seed(0)
    model = ErnieForMaskedLM(cfg)
    model.to(dtype="bfloat16")
    ids = torch.randint(0, 300, (2, 128), device="cuda")
    labels = torch.where(torch.rand((2, 128), device="cuda") < 0.15, ids,
                         torch.full_like(ids, -1))
    for mod in (fa, fl, kd):
        mod.reference_calls = 0
    fa.fwd_launches = fa.bwd_launches = 0
    fl.fwd_launches = fl.dx_launches = fl.reduce_launches = 0
    kd.fwd_launches = kd.bwd_launches = 0
    model(ids, masked_lm_labels=labels).backward()
    torch.cuda.synchronize()
    layers = cfg.num_layers
    assert (fa.fwd_launches, fa.bwd_launches) == (layers, layers)
    assert (fl.fwd_launches, fl.dx_launches, fl.reduce_launches) == \
        (2 * layers + 2,) * 3
    assert (kd.fwd_launches, kd.bwd_launches) == (3 * layers + 1,) * 2
    assert fa.reference_calls == fl.reference_calls == \
        kd.reference_calls == 0
