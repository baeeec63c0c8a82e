"""The port's Adam/AdamW (``paddle_tpu_torch.optimizer``) and its fused
update's plain version against the JAX package's at a small size.

``AdamW.functional_update`` is the update ``bench.py``'s train step runs;
the port's ``step()`` takes the same parameters and gradients (numpy, from
a seed) for 3 steps, and every master, moment and parameter is compared
after each. Tolerance: rtol 1e-6 (one float32 computation in the same
order; the two frameworks may round a power or a division one ulp apart);
a bf16 parameter equals its master rounded to bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.fused_optimizer import \
    fused_adam_update as jax_fused_adam
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.kernels import fused_optimizer as fo
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer.lr import StepDecay
from paddle_tpu_torch.utils.clip_grad import ClipGradByGlobalNorm

RTOL = 1e-6
SHAPES = {"w": (8, 16), "bias": (37,), "emb": (5, 3, 4)}


def _grads(rng, dtype):
    return {n: rng.standard_normal(s).astype(np.float32).astype(dtype)
            for n, s in SHAPES.items()}


def _run_both(dtype, steps=3, lr=1e-3, wd=0.01, decay_fun=None):
    """(JAX (params, state) per step, port (params, optimizer) per step)."""
    rng = np.random.default_rng(11)
    np_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else np.float32
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
    jopt = JAdamW(learning_rate=lr, weight_decay=wd, multi_precision=True)
    jparams = {n: jnp.asarray(a).astype(np_dtype) for n, a in init.items()}
    jstate = jopt.functional_init(jparams)
    tparams = {n: torch.tensor(np.asarray(jparams[n].astype(jnp.float32)),
                               dtype=dtype, requires_grad=True)
               for n in SHAPES}
    topt = AdamW(learning_rate=lr, weight_decay=wd, multi_precision=True,
                 parameters=list(tparams.items()),
                 apply_decay_param_fun=decay_fun)
    wd_mask = None if decay_fun is None else {n: decay_fun(n) for n in SHAPES}
    for _ in range(steps):
        grads = _grads(rng, np.float32)
        jgrads = {n: jnp.asarray(g).astype(np_dtype) for n, g in grads.items()}
        jparams, jstate = jopt.functional_update(jparams, jgrads, jstate, lr,
                                                 wd_mask=wd_mask)
        for n, p in tparams.items():
            p.grad = torch.tensor(np.asarray(jgrads[n].astype(jnp.float32)),
                                  dtype=dtype)
        topt.step()
        topt.zero_grad()
        yield jparams, jstate, tparams, topt


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16-master"])
def test_adamw_matches_functional_update(dtype):
    for jparams, jstate, tparams, topt in _run_both(dtype):
        for n in SHAPES:
            jslots, tslots = jstate["slots"][n], topt.state[n]
            for slot in ("moment1", "moment2"):
                np.testing.assert_allclose(tslots[slot].numpy(),
                                           _f32(jslots[slot]), rtol=RTOL,
                                           atol=0, err_msg=f"{n} {slot}")
            if dtype == torch.bfloat16:
                np.testing.assert_allclose(
                    tslots["master_weight"].numpy(),
                    _f32(jslots["master_weight"]), rtol=RTOL, atol=0,
                    err_msg=f"{n} master")
                # the parameter is the master rounded to bf16
                assert torch.equal(tparams[n].detach(),
                                   tslots["master_weight"].to(dtype))
            else:
                assert "master_weight" not in tslots
            np.testing.assert_allclose(tparams[n].detach().float().numpy(),
                                       _f32(jparams[n]), rtol=RTOL, atol=0,
                                       err_msg=f"{n} param")
    assert topt._step_count == 3


def test_apply_decay_param_fun_matches_wd_mask():
    fun = lambda name: name != "bias"  # noqa: E731
    for jparams, _, tparams, _ in _run_both(torch.float32, decay_fun=fun):
        for n in SHAPES:
            np.testing.assert_allclose(tparams[n].detach().numpy(),
                                       _f32(jparams[n]), rtol=RTOL, atol=0,
                                       err_msg=n)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16],
                         ids=["g-fp32", "g-bf16"])
def test_plain_fused_update_matches_jax_kernel_interpret(g_dtype):
    rng = np.random.default_rng(5)
    n = 10_000  # not a whole number of the TPU kernel's (8, 1024) tiles
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = rng.random(n).astype(np.float32)
    g = np.asarray(torch.from_numpy(g).to(g_dtype).float())
    lr, bc1, bc2 = 1e-3, 0.271, 0.00299
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    want = jax_fused_adam(*(jnp.asarray(a) for a in (p, g, m, v)),
                          jnp.float32(lr), jnp.float32(bc1), jnp.float32(bc2),
                          interpret=True, **hyper)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    launches = fo.launches
    fo.fused_adam_update(tp, torch.from_numpy(g).to(g_dtype), tm, tv, lr, bc1,
                         bc2, **hyper)
    assert fo.launches == launches  # CPU tensors: the plain version
    # atol 1e-7: the compiled kernel may fuse b*m + (1-b)*g into one
    # multiply-add, which rounds once where the plain version rounds twice
    for name, got, w in zip("pmv", (tp, tm, tv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-7, err_msg=name)


def test_adam_folds_l2_into_the_gradient():
    p = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    opt = Adam(learning_rate=0.1, weight_decay=0.5, parameters=[p])
    p.grad = torch.tensor([0.0, 0.0, 0.0])
    opt.step()
    # g = 0.5 * p: the first Adam step moves each weight by lr * sign(g)
    np.testing.assert_allclose(p.detach().numpy(), [0.9, -1.9, 2.9],
                               rtol=1e-6)


def test_options_are_checked_and_schedulers_drive_the_rate():
    """A clip and a scheduler are taken now (they raised before this
    slice); anything else in their place raises, as does a bf16
    parameter without masters. With a scheduler the step reads its rate,
    ``set_lr`` is refused as in the reference, and ``clear_grad`` drops
    the gradients."""
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(TypeError, match="grad_clip"):
        AdamW(parameters=[p], grad_clip=object())
    with pytest.raises(TypeError, match="learning_rate"):
        AdamW(learning_rate=object(), parameters=[p])
    with pytest.raises(ValueError, match="multi_precision"):
        AdamW(parameters=[torch.zeros(3, dtype=torch.bfloat16,
                                      requires_grad=True)])
    sched = StepDecay(0.1, step_size=1, gamma=0.5)
    opt = Adam(learning_rate=sched, parameters=[p],
               grad_clip=ClipGradByGlobalNorm(1.0))
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError, match="set_lr"):
        opt.set_lr(0.2)
    p.grad = torch.tensor([3.0, 4.0, 0.0])  # norm 5: clipped to 1
    opt.step()
    sched.step()
    assert opt.get_lr() == 0.05
    # Adam's first step moves each weight by lr * sign(g), up to the
    # float32 bias corrections (1 - 0.999 is 0.0009999871 in float32)
    np.testing.assert_allclose(p.detach().numpy(), [-0.1, -0.1, 0.0],
                               rtol=1e-5)
    opt.clear_grad()
    assert p.grad is None
    plain = AdamW(learning_rate=0.1, parameters=[p])
    plain.set_lr(0.2)
    assert plain.get_lr() == 0.2


def test_state_dict_round_trips_with_the_reference_keys():
    p = torch.ones(4, dtype=torch.bfloat16, requires_grad=True)
    sched = StepDecay(0.1, step_size=2)
    opt = AdamW(learning_rate=sched, parameters=[("w", p)],
                multi_precision=True)
    p.grad = torch.full((4,), 0.5, dtype=torch.bfloat16)
    opt.step()
    sched.step()
    sd = opt.state_dict()
    assert set(sd) == {"w.moment1", "w.moment2", "w.master_weight", "@step",
                       "LR_Scheduler"}
    assert sd["@step"] == 1 and sd["LR_Scheduler"]["last_epoch"] == 1
    q = torch.ones(4, dtype=torch.bfloat16, requires_grad=True)
    sched2 = StepDecay(0.1, step_size=2)
    opt2 = AdamW(learning_rate=sched2, parameters=[("w", q)],
                 multi_precision=True)
    opt2.set_state_dict({k: (v.numpy() if torch.is_tensor(v) else v)
                         for k, v in sd.items()})
    assert opt2._step_count == 1 and sched2.last_epoch == 1
    for k in ("moment1", "moment2", "master_weight"):
        assert torch.equal(opt2.state["w"][k], opt.state["w"][k])


@pytest.mark.parametrize("decay_on", [True, False], ids=["decay", "masked"])
def test_adam_l2_bf16_grad_bit_for_bit(decay_on, monkeypatch):
    """Adam's L2 term with a bf16 gradient: the reference adds ``wd * p``
    to the gradient in bf16 (the coefficient rounded to bf16 first) and
    casts after, and skips a name its ``wd_mask`` turns off. One step on
    4,096 values from numpy seed 0: every state tensor equal bit for bit."""
    rng = np.random.default_rng(0)
    p = rng.standard_normal(4096).astype(np.float32)
    g = rng.standard_normal(4096).astype(np.float32)
    jp = {"w": jnp.asarray(p).astype(jnp.bfloat16)}
    jg = {"w": jnp.asarray(g).astype(jnp.bfloat16)}
    jopt = JAdam(learning_rate=1e-3, weight_decay=0.37, multi_precision=True)
    jparams, jstate = jopt.functional_update(
        jp, jg, jopt.functional_init(jp), 1e-3,
        wd_mask=None if decay_on else {"w": False})
    tp = torch.tensor(_f32(jp["w"])).to(torch.bfloat16).requires_grad_()
    topt = Adam(learning_rate=1e-3, weight_decay=0.37, multi_precision=True,
                parameters=[("w", tp)])
    if not decay_on:
        monkeypatch.setattr(topt, "_decay_on", lambda name: False)
    tp.grad = torch.tensor(_f32(jg["w"])).to(torch.bfloat16)
    topt.step()
    js, ts = jstate["slots"]["w"], topt.state["w"]
    for slot in ("moment1", "moment2", "master_weight"):
        np.testing.assert_array_equal(ts[slot].numpy(), _f32(js[slot]),
                                      err_msg=slot)
    np.testing.assert_array_equal(tp.detach().float().numpy(),
                                  _f32(jparams["w"]))
