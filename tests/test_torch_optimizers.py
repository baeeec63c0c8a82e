"""The reference's eleven other update rules (``SGD``, ``Momentum``,
``Lamb``, ``LarsMomentum``, ``RMSProp``, ``Adagrad``, ``Adadelta``,
``Adamax``, ``DecayedAdagrad``, ``Ftrl``, ``Dpsgd``) and the two decays
(``L1Decay``, ``L2Decay``) in the port, against the JAX package's
``functional_update`` jitted as ``tests/test_torch_train.py`` runs it:
the same parameters and gradients (numpy, from a seed) for 5 steps, the
rate passed into the jitted step as an argument (a scheduler's, stepped
on both sides, where one is given), every parameter, master and state
slot compared after each step. Low-precision parameters: bfloat16 with
float32 masters, the parameter equal to its master rounded (so within
one bfloat16 step, rtol 2**-7, of the reference's).

Tolerance: rtol 1e-5, atol 1e-6 — one float32 computation in the same
order of operations, where the two frameworks may round a power, a
square root or a norm's sum one ulp apart. The eager step's
per-parameter rules (``ParamAttr`` learning rate and regularizer) are
held against the reference's eager ``step()``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-6)
SHAPES = {"w": (6, 5), "b": (5,), "emb": (3, 2, 4)}
STEPS = 5


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _sched(P):
    return P.optimizer.lr.StepDecay(0.05, step_size=2, gamma=0.5)


# name -> (constructor over (package, rate), takes masters, rate)
OPTS = {
    "SGD": (lambda P, lr: P.optimizer.SGD(lr, parameters=_PARAMS[P],
                                          multi_precision=True), True),
    "SGD-L2Decay": (lambda P, lr: P.optimizer.SGD(
        lr, parameters=_PARAMS[P],
        weight_decay=P.regularizer.L2Decay(0.05)), False),
    "SGD-L1Decay": (lambda P, lr: P.optimizer.SGD(
        lr, parameters=_PARAMS[P],
        weight_decay=P.regularizer.L1Decay(0.03)), False),
    "Momentum": (lambda P, lr: P.optimizer.Momentum(
        lr, 0.8, parameters=_PARAMS[P], multi_precision=True), True),
    "Momentum-nesterov-L2": (lambda P, lr: P.optimizer.Momentum(
        lr, 0.9, parameters=_PARAMS[P], use_nesterov=True,
        weight_decay=P.optimizer.L2Decay(0.01)), False),
    "Lamb": (lambda P, lr: P.optimizer.Lamb(
        lr, lamb_weight_decay=0.02, parameters=_PARAMS[P],
        multi_precision=True), True),
    "LarsMomentum": (lambda P, lr: P.optimizer.LarsMomentum(
        lr, 0.9, lars_coeff=0.01, lars_weight_decay=0.001,
        parameters=_PARAMS[P], multi_precision=True), True),
    "RMSProp": (lambda P, lr: P.optimizer.RMSProp(
        lr, rho=0.9, epsilon=1e-6, momentum=0.5, parameters=_PARAMS[P]),
        False),
    "RMSProp-centered": (lambda P, lr: P.optimizer.RMSProp(
        lr, centered=True, parameters=_PARAMS[P]), False),
    "Adagrad": (lambda P, lr: P.optimizer.Adagrad(
        lr, parameters=_PARAMS[P], initial_accumulator_value=0.1), False),
    "Adadelta": (lambda P, lr: P.optimizer.Adadelta(
        lr, rho=0.9, parameters=_PARAMS[P]), False),
    "Adamax": (lambda P, lr: P.optimizer.Adamax(
        lr, parameters=_PARAMS[P]), False),
    "DecayedAdagrad": (lambda P, lr: P.optimizer.DecayedAdagrad(
        lr, decay=0.9, parameters=_PARAMS[P]), False),
    "Ftrl": (lambda P, lr: P.optimizer.Ftrl(
        lr, l1=0.01, l2=0.02, parameters=_PARAMS[P]), False),
    "Ftrl-lr_power": (lambda P, lr: P.optimizer.Ftrl(
        lr, lr_power=-0.25, parameters=_PARAMS[P]), False),
    "Dpsgd": (lambda P, lr: P.optimizer.Dpsgd(
        lr, clip=0.5, batch_size=4.0, sigma=0.3, parameters=_PARAMS[P],
        seed=7), False),
}
_PARAMS = {J: None, T: None}  # the reference's functional path takes none


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _run(name, low_precision, sched):
    make, _ = OPTS[name]
    rng = np.random.default_rng(3)
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
    jdt = jnp.bfloat16 if low_precision else jnp.float32
    tdt = torch.bfloat16 if low_precision else torch.float32
    jsched, tsched = (_sched(J), _sched(T)) if sched else (None, None)
    jopt = make(J, jsched or 0.05)
    jparams = {n: jnp.asarray(a).astype(jdt) for n, a in init.items()}
    jstate = jopt.functional_init(jparams)
    tparams = {n: torch.tensor(_f32(jparams[n]), dtype=tdt,
                               requires_grad=True) for n in SHAPES}
    _PARAMS[T] = list(tparams.items())
    topt = make(T, tsched or 0.05)
    _PARAMS[T] = None
    step = jax.jit(lambda p, g, s, lr: jopt.functional_update(p, g, s, lr))
    for _ in range(STEPS):
        grads = {n: rng.standard_normal(s).astype(np.float32)
                 for n, s in SHAPES.items()}
        jgrads = {n: jnp.asarray(g).astype(jdt) for n, g in grads.items()}
        lr = jsched() if sched else 0.05
        jparams, jstate = step(jparams, jgrads, jstate, jnp.float32(lr))
        for n, p in tparams.items():
            p.grad = torch.tensor(_f32(jgrads[n]), dtype=tdt)
        topt.step()
        topt.clear_grad()
        if sched:
            jsched.step()
            tsched.step()
        yield jparams, jstate, tparams, topt


CASES = [(n, False, False) for n in OPTS] + \
    [(n, True, False) for n, (_, mp) in OPTS.items() if mp] + \
    [(n, False, True) for n in ("SGD", "Momentum", "Adamax", "Ftrl")]


@pytest.mark.parametrize("name,low,sched", CASES, ids=[
    f"{n}{'-bf16-masters' if lo else ''}{'-scheduler' if s else ''}"
    for n, lo, s in CASES])
def test_optimizer_matches_functional_update(name, low, sched):
    for jparams, jstate, tparams, topt in _run(name, low, sched):
        for n in SHAPES:
            jslots, tslots = jstate["slots"][n], topt.state[n]
            assert sorted(jslots) == sorted(tslots), n
            for slot, want in jslots.items():
                np.testing.assert_allclose(to_numpy(tslots[slot]),
                                           _f32(want), err_msg=f"{n} {slot}",
                                           **TOL)
            # a bf16 parameter is its master rounded: masters a float32
            # ulp apart may round one bf16 step apart
            np.testing.assert_allclose(to_numpy(tparams[n]),
                                       _f32(jparams[n]), err_msg=n,
                                       **(BF16_STEP if low else TOL))
            if low:
                assert torch.equal(tparams[n].detach(),
                                   tslots["master_weight"].to(
                                       torch.bfloat16))


def _eager_pair(make):
    """A Linear of each package, the same weights; the weight's
    ``ParamAttr`` halves its rate and carries an L2Decay(0.1)."""
    layers = {}
    for P in (J, T):
        P.seed(0)
        attr = P.ParamAttr(learning_rate=0.5,
                           regularizer=P.regularizer.L2Decay(0.1))
        layers[P] = P.nn.Linear(4, 3, weight_attr=attr)
    layers[T].set_state_dict({k: to_numpy(v) for k, v in
                              layers[J].state_dict().items()})
    opts = {P: make(P, layers[P]) for P in (J, T)}
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = rng.standard_normal((2, 4)).astype(np.float32)
        for P in (J, T):
            loss = P.sum(layers[P](P.to_tensor(x)) ** 2)
            loss.backward()
            opts[P].step()
            opts[P].clear_grad()
    return layers


@pytest.mark.parametrize("name,make", [
    ("SGD", lambda P, m: P.optimizer.SGD(0.1, parameters=m.parameters(),
                                         weight_decay=0.01)),
    ("Momentum", lambda P, m: P.optimizer.Momentum(
        0.1, parameters=m.parameters(), weight_decay=0.01)),
    ("Adam", lambda P, m: P.optimizer.Adam(0.1, parameters=m.parameters(),
                                           weight_decay=0.01)),
])
def test_param_attr_rate_and_regularizer_match_the_eager_step(name, make):
    layers = _eager_pair(make)
    for k, v in layers[J].state_dict().items():
        np.testing.assert_allclose(to_numpy(layers[T].state_dict()[k]),
                                   to_numpy(v), err_msg=k, rtol=1e-4,
                                   atol=1e-5)


def test_lamb_exclude_from_weight_decay_fn():
    """Pinned divergence: the reference's Lamb takes
    ``exclude_from_weight_decay_fn`` and never calls it; the port's skips
    the decay term for the parameters it names, so those follow a Lamb
    without decay and the rest the decayed one."""
    rng = np.random.default_rng(8)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    g = rng.standard_normal((4, 3)).astype(np.float32)
    out = {}
    for wd, exclude in ((0.1, True), (0.1, False), (0.0, False)):
        p = torch.tensor(w0, requires_grad=True)
        opt = T.optimizer.Lamb(0.01, lamb_weight_decay=wd,
                               parameters=[("w", p)],
                               exclude_from_weight_decay_fn=(
                                   (lambda param: True) if exclude
                                   else None))
        p.grad = torch.tensor(g)
        opt.step()
        out[wd, exclude] = p.detach().numpy()
    np.testing.assert_array_equal(out[0.1, True], out[0.0, False])
    assert not np.allclose(out[0.1, False], out[0.0, False])


def test_state_dict_round_trip_and_shared_names():
    """Deep-copied layers share their parameters' names (the reference's
    deepcopy keeps them): each still gets its own state, keyed
    ``name@k`` after the first, and ``set_state_dict`` restores it."""
    import copy

    T.seed(0)
    a = T.nn.Linear(3, 2)
    b = copy.deepcopy(a)
    params = a.parameters() + b.parameters()
    opt = T.optimizer.Momentum(0.1, parameters=params)
    names = [n for n, _ in opt._params]
    assert len(set(names)) == 4 and names[2] == names[0] + "@1"
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    sd = opt.state_dict()
    fresh = T.optimizer.Momentum(0.1, parameters=params)
    fresh.set_state_dict(sd)
    for n in names:
        assert torch.equal(fresh.state[n]["velocity"],
                           opt.state[n]["velocity"])
    assert sorted(T.optimizer.__all__) == sorted(
        set(T.optimizer.__all__))


def test_adamw_decay_fun_sees_the_names_of_deep_copied_layers():
    """``TransformerEncoder`` deep-copies its layer, so every layer's
    parameters carry layer 0's names. ``apply_decay_param_fun`` is asked
    about the parameter's own name (the usual recipe builds its set from
    ``p.name``), so AdamW decays every layer as the reference's eager
    ``step()`` does; only the optimizer state's keys carry ``@k``.
    ``epsilon`` 1e-4 keeps the key projection's bias, whose gradient is
    zero but for rounding (softmax ignores a shift of every score), from
    taking a full Adam step on that rounding."""
    models, opts = {}, {}
    for P in (J, T):
        P.seed(0)
        layer = P.nn.TransformerEncoderLayer(16, 2, 32, dropout=0.0)
        models[P] = P.nn.TransformerEncoder(layer, 2)
    models[T].set_state_dict({k: to_numpy(v) for k, v in
                              models[J].state_dict().items()})
    for P in (J, T):
        decay = {p.name for n, p in models[P].named_parameters()
                 if "bias" not in n and "norm" not in n}
        opts[P] = P.optimizer.AdamW(
            0.01, epsilon=1e-4, parameters=models[P].parameters(),
            weight_decay=0.5, apply_decay_param_fun=lambda n, d=decay: n in d)
    rng = np.random.default_rng(6)
    for _ in range(3):
        x, y = rng.standard_normal((2, 2, 5, 16)).astype(np.float32)
        for P in (J, T):
            loss = P.mean((models[P](P.to_tensor(x)) - P.to_tensor(y)) ** 2)
            loss.backward()
            opts[P].step()
            opts[P].clear_grad()
    want = models[J].state_dict()
    got = models[T].state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(to_numpy(got[k]), to_numpy(v),
                                   err_msg=k, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,make", [
    ("Adam", lambda P, m: P.optimizer.Adam(0.01, parameters=m.parameters())),
    ("Adam-L2-clip", lambda P, m: P.optimizer.Adam(
        0.01, parameters=m.parameters(), weight_decay=0.02,
        grad_clip=P.nn.ClipGradByGlobalNorm(100.0))),
    ("AdamW", lambda P, m: P.optimizer.AdamW(
        0.01, parameters=m.parameters(), weight_decay=0.1)),
])
def test_adam_keeps_float64_moments_for_float64_parameters(name, make):
    """A float64 model under Adam and AdamW keeps float64 moments and
    updates in float64, as the reference's eager ``step()`` does (its
    bias corrections from a float32 step): after three steps the
    parameters and both moments equal the reference's within 1e-12
    relative to each array's largest value. The clip's norm is a float32
    sum in both packages, in their own orders; its limit is set above
    the norm so that the scale is exactly 1 on both sides."""
    models = {}
    for P in (J, T):
        P.seed(0)
        models[P] = P.nn.Sequential(P.nn.Linear(5, 4), P.nn.Tanh(),
                                    P.nn.Linear(4, 3))
    models[T].set_state_dict({k: to_numpy(v) for k, v in
                              models[J].state_dict().items()})
    for P in (J, T):
        models[P].to(dtype="float64")
    opts = {P: make(P, models[P]) for P in (J, T)}
    rng = np.random.default_rng(11)
    for _ in range(3):
        x = rng.standard_normal((6, 5))
        for P in (J, T):
            loss = P.sum(models[P](P.to_tensor(x)) ** 2)
            loss.backward()
            opts[P].step()
            opts[P].clear_grad()
    jparams = models[J].parameters()
    tkeys = [k for k, _ in opts[T]._params]
    assert len(jparams) == len(tkeys) == 4
    for jp, key, (n, tp) in zip(jparams, tkeys,
                                models[T].named_parameters()):
        jslots = opts[J]._slots[id(jp)]
        pairs = [(n, tp, jp)] + [
            (f"{n}.{s}", opts[T].state[key][s], jslots[s])
            for s in ("moment1", "moment2")]
        for what, got, want in pairs:
            assert got.dtype == torch.float64, what
            want = np.asarray(to_numpy(want), np.float64)
            err = np.abs(to_numpy(got) - want).max()
            assert err <= 1e-12 * np.abs(want).max(), (what, err)


def test_float64_adam_state_survives_set_state_dict():
    """``set_state_dict`` keeps a float64 parameter's moments float64."""
    p = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    opt = T.optimizer.Adam(0.1, parameters=[("w", p)])
    p.grad = torch.tensor([1.0, 2.0, 1e-9], dtype=torch.float64)
    opt.step()
    fresh = T.optimizer.Adam(0.1, parameters=[("w", p)])
    fresh.set_state_dict(opt.state_dict())
    for s in ("moment1", "moment2"):
        assert fresh.state["w"][s].dtype == torch.float64
        assert torch.equal(fresh.state["w"][s], opt.state["w"][s])
