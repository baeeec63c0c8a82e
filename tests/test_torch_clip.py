"""The port's gradient clipping (``paddle_tpu_torch.utils.clip_grad``) and
the optimizer step with ``ClipGradByGlobalNorm`` against the JAX
package's, on float32 and bf16 gradients (numpy, seed 0).

``ClipGradByValue`` is a clamp: equal bit for bit. The norm clips sum
squares in float32 in another order than XLA (torch's CPU sum against
XLA's), so the sum of squares — and the scale — may differ in the last
float32 bits: held within rtol 1e-5 (float32 sums of 2,200 squares in two
orders; measured 1.4e-6). A clipped float32 gradient is then within rtol
1e-5; a clipped bf16 gradient is rounded to bf16 after the float32
product, so where that product lies at a rounding boundary the two may
round one bf16 step apart: every entry within one bf16 step (2**-7
relative), at most 0.1% of entries different.

The optimizer step (AdamW, bf16 parameters with float32 masters, weight
decay 0.01, clip 1.0 with a norm above it, 2 steps) is held against both
the reference's ``functional_update`` and its eager ``step()``: moments
and masters within rtol 1e-5 (the scale's last bits, and a bf16 gradient
rounding apart as above, move an Adam moment by at most (1 - beta) of a
bf16 step of that entry; those entries are counted as above).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.utils import clip_grad as J
from paddle_tpu_torch.kernels import global_norm as gn
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils import clip_grad as T

SHAPES = [(64, 32), (32,), (7, 3, 5), (1,)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _grads(dtype, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    tdt, jdt = DTYPES[dtype]
    arrs = [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]
    jg = [jnp.asarray(a).astype(jdt) for a in arrs]
    tg = [torch.tensor(np.asarray(g.astype(jnp.float32))).to(tdt)
          for g in jg]
    return jg, tg


def _close(got, want, dtype, rtol=1e-5):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
        return 0
    diff = got != want
    step = np.abs(want) * 2.0 ** -7
    assert (np.abs(got - want)[diff] <= step[diff]).all()
    assert diff.sum() <= max(1, 0.001 * diff.size)
    return int(diff.sum())


@pytest.mark.parametrize("dtype", DTYPES)
def test_clip_by_value_bit_for_bit(dtype):
    jg, tg = _grads(dtype)
    want = J.ClipGradByValue(0.5).apply(jg + [None], None)
    got = T.ClipGradByValue(0.5).apply(tg + [None], None)
    assert got[-1] is None and want[-1] is None
    for a, w in zip(got[:-1], want[:-1]):
        assert a.dtype == tg[0].dtype
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(w.astype(jnp.float32)))
    lo = T.ClipGradByValue(0.2, min=-0.1).apply(tg, None)
    assert all(t.min() >= torch.tensor(-0.1, dtype=t.dtype)
               and t.max() <= torch.tensor(0.2, dtype=t.dtype) for t in lo)


@pytest.mark.parametrize("dtype", DTYPES)
def test_clip_by_norm_matches_reference(dtype):
    jg, tg = _grads(dtype, scale=0.2)
    # norms of the four gradients: about 9, 1.1, 2.1 and 0.2: some clipped
    want = J.ClipGradByNorm(1.5).apply(jg + [None], None)
    got = T.ClipGradByNorm(1.5).apply(tg + [None], None)
    assert got[-1] is None
    for a, w in zip(got[:-1], want[:-1]):
        _close(a, w, dtype)


@pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_clip_by_global_norm_matches_reference(dtype, clip):
    jg, tg = _grads(dtype)
    want = J.ClipGradByGlobalNorm(clip).apply(jg + [None], None)
    got = T.ClipGradByGlobalNorm(clip).apply(tg + [None], None)
    assert got[-1] is None
    for a, w in zip(got[:-1], want[:-1]):
        _close(a, w, dtype)
    total, scale = gn.global_norm_scale(tg, clip)
    want_total = jnp.sum(jnp.stack([jnp.sum(g.astype(jnp.float32) ** 2)
                                    for g in jg]))
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-5)
    if clip > 1e3:
        assert scale.item() == 1.0
    # the [(param, grad)] interface
    pairs = T.ClipGradByGlobalNorm(clip)(list(zip(range(4), tg)))
    assert [p for p, _ in pairs] == [0, 1, 2, 3]


def test_norm_launch_plan():
    sizes = [1024 * 1024] * 100 + [4096] * 192
    assert gn.norm_launch_plan(sizes) == [(0, 292)]
    assert gn.norm_launch_plan(sizes, 4096) == [(0, 145), (145, 290),
                                                (290, 292)]
    assert gn.norm_chunks([1, 16384, 16385]) == 4
    assert gn.norm_table_capacity() == 1169
    with pytest.raises(ValueError):
        gn.norm_launch_plan([3, 0])


def _reference_adamw(kind, p0, grads_per_step, lrs):
    """The reference's AdamW (multi_precision, clip 1.0) over bf16
    parameters, by ``functional_update`` (lr an argument) or eager
    ``step()``: each state slot as float32 numpy arrays."""
    names = [f"w{i}" for i in range(len(p0))]
    if kind == "functional":
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     grad_clip=J.ClipGradByGlobalNorm(1.0),
                                     multi_precision=True)
        params = {n: jnp.asarray(p).astype(jnp.bfloat16)
                  for n, p in zip(names, p0)}
        state = opt.functional_init(params)
        for grads, lr in zip(grads_per_step, lrs):
            params, state = opt.functional_update(
                params, dict(zip(names, grads)), state, lr)
        return {n: {k: np.asarray(v.astype(jnp.float32))
                    for k, v in state["slots"][n].items()} for n in names}
    ps = []
    for p in p0:
        t = jnn.Parameter(np.asarray(p, np.float32))
        t._value = t._value.astype("bfloat16")
        ps.append(t)
    sched = paddle.optimizer.lr.PiecewiseDecay([1], lrs)
    opt = paddle.optimizer.AdamW(learning_rate=sched, parameters=ps,
                                 grad_clip=jnn.ClipGradByGlobalNorm(1.0),
                                 multi_precision=True)
    for grads in grads_per_step:
        for t, g in zip(ps, grads):
            t.grad = paddle.to_tensor(g)
        opt.step()
        sched.step()
    return {n: {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
                for k, v in opt._slots[id(t)].items()}
            for n, t in zip(names, ps)}


@pytest.mark.parametrize("kind", ["functional", "eager"])
def test_adamw_step_with_global_norm_clip_matches_reference(kind):
    rng = np.random.default_rng(1)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    steps = [[jnp.asarray(rng.standard_normal(s).astype(np.float32))
              .astype(jnp.bfloat16) for s in SHAPES] for _ in range(2)]
    lrs = [1e-3, 5e-4]
    want = _reference_adamw(kind, p0, steps, lrs)
    names = [f"w{i}" for i in range(len(p0))]
    tp = [torch.tensor(p).to(torch.bfloat16).requires_grad_() for p in p0]
    sched_vals = iter(lrs)
    from paddle_tpu_torch.optimizer import lr as tlr

    sched = tlr.PiecewiseDecay([1], lrs)
    opt = AdamW(learning_rate=sched, parameters=list(zip(names, tp)),
                grad_clip=T.ClipGradByGlobalNorm(1.0), multi_precision=True)
    for grads in steps:
        assert opt.get_lr() == next(sched_vals)
        for t, g in zip(tp, grads):
            t.grad = torch.tensor(np.asarray(g.astype(jnp.float32))).to(
                torch.bfloat16)
        opt.step()
        sched.step()
    for n in names:
        for slot in ("moment1", "moment2", "master_weight"):
            np.testing.assert_allclose(opt.state[n][slot].numpy(),
                                       want[n][slot], rtol=1e-5, atol=1e-9,
                                       err_msg=f"{n}.{slot}")
    sd = opt.state_dict()
    assert sd["@step"] == 2 and sd["LR_Scheduler"]["last_epoch"] == 2
    assert set(sd) == {f"{n}.{s}" for n in names for s in
                       ("moment1", "moment2", "master_weight")} | {
        "@step", "LR_Scheduler"}
