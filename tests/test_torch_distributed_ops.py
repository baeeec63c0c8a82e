"""The functional collectives (``distributed.ops``), ``DataParallel`` and
the meta-optimizers of the port against the JAX package's.

The port's ranks are four gloo processes spawned once for the module
(``test_torch_fleet_ranks.ops_rank``). The reference runs each ``c_*``
function inside ``shard_map`` over four devices of the conftest's mesh
(axis ``"mp"``, ``check_vma=False``) under ``jax.vjp`` with a random
cotangent a rank; rank r's output and input gradient must equal shard r
of the reference's (float32 rounding: rtol 1e-6, atol 1e-6; the moves
exactly). ``c_allreduce_max`` / ``_min`` / ``_prod`` / ``_avg`` are held
forward only: the reference's ``pmax`` has no gradient.

``c_softmax_with_cross_entropy`` and ``c_embedding`` are held forward
against the reference's under ``shard_map``, and their gradients against
``jax.grad`` of the unsharded loss and lookup (the gradient a
vocab-parallel layer must give, each replicated output counted once;
the reference's ``psum`` under ``check_vma=False`` would count it once a
rank): rtol 1e-5, atol 1e-6.

``DataParallel``: two SGD steps of an MLP over four ranks, each with a
quarter of the batch (buckets small enough that there are several),
against the reference's one-controller step on the whole batch: the
ranks' mean loss and every parameter within 1e-6. The meta-optimizers:
``GradientMergeOptimizer`` (k 2, four steps) and the strategy compiler's
report in one process against the reference's; LocalSGD and DGC over the
four ranks equal the mean over the ranks of the reference's one-process
step (SGD is linear), within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.distributed import ops as JO
from paddle_tpu.distributed.fleet import meta_optimizers as JM
from paddle_tpu_torch import _device
from paddle_tpu_torch.distributed.fleet import meta_optimizers as TM
from test_torch_fleet_ranks import (OPS, OPS_FORWARD, WORLD, ops_rank,
                                    spawn_ranks)

TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
#: each op's per-rank input shape
SHAPES = {name: (4, 8) for name in OPS}
SHAPES.update(global_scatter=(4, 2, 3), global_gather=(4, 2, 3))
V, T_TOK, H = 24, 10, 5     # vocab (6 a rank), tokens, embedding width


def _ref(name):
    """The reference's ``c_*`` call for ``name`` on axis ``"mp"``."""
    return {
        "c_allreduce_sum": lambda x: JO.c_allreduce_sum(x, "mp"),
        "c_allgather": lambda x: JO.c_allgather(x, "mp"),
        "c_reducescatter": lambda x: JO.c_reducescatter(x, "mp"),
        "c_broadcast": lambda x: JO.c_broadcast(x, "mp", 1),
        "c_identity": lambda x: JO.c_identity(x, "mp"),
        "mp_allreduce": lambda x: JO.mp_allreduce(x, "mp"),
        "c_concat": lambda x: JO.c_concat(x, "mp", -1),
        "c_split": lambda x: JO.c_split(x, "mp", -1),
        "c_alltoall": lambda x: JO.c_alltoall(x, "mp"),
        "send_next": lambda x: JO.send_next(x, "mp"),
        "send_prev": lambda x: JO.send_prev(x, "mp"),
        "send_v2": lambda x: JO.send_v2(x, "mp", dst=2, src=0),
        "recv_v2": lambda x: JO.recv_v2(x, "mp", src=1, dst=3),
        "p2p_exchange": lambda x: JO.p2p_exchange(
            x, "mp", [(0, 3), (3, 1), (1, 0), (2, 2)]),
        "global_scatter": lambda x: JO.global_scatter(x, "mp"),
        "global_gather": lambda x: JO.global_gather(x, "mp"),
    }[name]


def _mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("mp",))


def _sharded(fn, *args):
    """``fn`` over the four devices: each argument ``[4, ...]`` split by
    rank (the leading 1 dropped), each output stacked back by rank."""
    def body(*local):
        outs = fn(*(a[0] for a in local))
        return jax.tree_util.tree_map(lambda o: o[None], outs)

    return jax.jit(jax.shard_map(body, mesh=_mesh(),
                                 in_specs=tuple(P("mp") for _ in args),
                                 out_specs=P("mp"), check_vma=False))(*args)


def _out_shape(name):
    s = SHAPES[name]
    return {"c_allgather": (s[0] * WORLD, s[1]),
            "c_reducescatter": (s[0] // WORLD, s[1]),
            "c_concat": (s[0], s[1] * WORLD),
            "c_split": (s[0], s[1] // WORLD)}.get(name, s)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    if len(jax.devices()) < WORLD:
        pytest.skip("needs the conftest 8-device CPU mesh")
    rng = np.random.default_rng(5)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    d = {}
    for name in OPS:
        d[f"x:{name}"] = f32(WORLD, *SHAPES[name])
        d[f"ct:{name}"] = f32(WORLD, *_out_shape(name))
    d["x:fwd"] = rng.uniform(0.5, 2.0, (WORLD, 3, 4)).astype(np.float32)
    d["logits"] = f32(WORLD, T_TOK, V // WORLD)
    d["labels"] = rng.integers(0, V, (T_TOK,))
    d["table"] = f32(WORLD, V // WORLD, H)
    d["ids"] = rng.integers(0, V, (T_TOK,))
    d["emb_ct"] = f32(T_TOK, H)
    J.seed(3)
    ref_mlp = J.nn.Sequential(J.nn.Linear(8, 16), J.nn.ReLU(),
                              J.nn.Linear(16, 4))
    for k, v in ref_mlp.state_dict().items():
        d[f"mlp:{k}"] = np.asarray(v.numpy())
    d["dp_x"] = f32(16, 8)
    d["dp_y"] = rng.integers(0, 4, (16,))
    d["meta_w"] = f32(WORLD, 12)
    d["meta_g"] = f32(WORLD, 12)
    tmp = tmp_path_factory.mktemp("ops")
    path = str(tmp / "in.npz")
    np.savez(path, **d)
    return d, ref_mlp, spawn_ranks(ops_rank, str(tmp), path)


@pytest.fixture(scope="module")
def reference_ops(inputs):
    """Every op's output and input gradient in the reference, all in one
    ``shard_map`` program (one compile)."""
    d = inputs[0]
    names = sorted(OPS)

    def fwd_bwd(*args):
        out = {}
        for name, x, ct in zip(names, args[0::2], args[1::2]):
            y, vjp = jax.vjp(_ref(name), x)
            out[name] = (y, vjp(ct)[0])
        return out

    args = [a for n in names for a in (d[f"x:{n}"], d[f"ct:{n}"])]
    return _sharded(fwd_bwd, *args)


@pytest.mark.parametrize("name", sorted(OPS))
def test_c_op_and_its_gradient(inputs, reference_ops, name):
    _, _, ranks = inputs
    y, dx = reference_ops[name]
    for r in range(WORLD):
        got_y, got_dx = ranks[r][name]
        np.testing.assert_allclose(got_y, np.asarray(y[r]), **TOL)
        np.testing.assert_allclose(got_dx, np.asarray(dx[r]), **TOL)


@pytest.fixture(scope="module")
def reference_forward(inputs):
    return _sharded(lambda x: {n: getattr(JO, n)(x, "mp")
                               for n in OPS_FORWARD}, inputs[0]["x:fwd"])


@pytest.mark.parametrize("name", OPS_FORWARD)
def test_c_op_forward(inputs, reference_forward, name):
    _, _, ranks = inputs
    want = reference_forward[name]
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][name], np.asarray(want[r]),
                                   rtol=1e-5, atol=1e-6)


def test_vocab_parallel_cross_entropy(inputs):
    d, _, ranks = inputs
    labels = jnp.asarray(d["labels"])
    want = _sharded(lambda lg, lab: JO.c_softmax_with_cross_entropy(
        lg, lab, "mp"), d["logits"], np.broadcast_to(
            d["labels"], (WORLD, T_TOK)))
    full = np.concatenate(list(d["logits"]), axis=-1)    # [T, V]

    def loss(lg):
        return jnp.sum(jax.nn.logsumexp(lg, -1)
                       - jnp.take_along_axis(lg, labels[:, None], -1)[:, 0])

    grad = np.asarray(jax.grad(loss)(jnp.asarray(full)))
    v = V // WORLD
    for r in range(WORLD):
        got, dlogits = ranks[r]["ce"]
        np.testing.assert_allclose(got, np.asarray(want[r]), **GRAD_TOL)
        np.testing.assert_allclose(dlogits, grad[:, r * v:(r + 1) * v],
                                   **GRAD_TOL)


def test_vocab_parallel_embedding(inputs):
    d, _, ranks = inputs
    want = _sharded(lambda ids, tab: JO.c_embedding(ids, tab, "mp"),
                    np.broadcast_to(d["ids"], (WORLD, T_TOK)), d["table"])
    full = np.concatenate(list(d["table"]), axis=0)       # [V, H]
    grad = np.asarray(jax.grad(lambda t: jnp.sum(
        t[jnp.asarray(d["ids"])] * d["emb_ct"]))(jnp.asarray(full)))
    v = V // WORLD
    for r in range(WORLD):
        emb, dtable = ranks[r]["embedding"]
        np.testing.assert_allclose(emb, np.asarray(want[r]), **GRAD_TOL)
        np.testing.assert_allclose(dtable, grad[r * v:(r + 1) * v],
                                   **GRAD_TOL)


def test_data_parallel_matches_the_single_controller_step(inputs):
    d, ref_mlp, ranks = inputs
    opt = J.optimizer.SGD(0.1, parameters=ref_mlp.parameters())
    losses = []
    for _ in range(2):
        loss = J.nn.functional.cross_entropy(
            ref_mlp(J.to_tensor(d["dp_x"])), J.to_tensor(d["dp_y"]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    want = {k: np.asarray(v.numpy()) for k, v in ref_mlp.state_dict().items()}
    got_losses = np.mean([ranks[r]["dataparallel"][0] for r in range(WORLD)],
                         axis=0)
    np.testing.assert_allclose(got_losses, losses, rtol=1e-6)
    for r in range(WORLD):
        state = ranks[r]["dataparallel"][1]
        assert sorted(state) == sorted(want)
        for k in want:
            np.testing.assert_allclose(state[k], want[k], **TOL)


def _one_process(meta_cls, w, g, **kw):
    """The reference's meta-optimizer over SGD(0.5), one step."""
    t = J.to_tensor(w.copy())
    t.stop_gradient = False
    opt = meta_cls(J.optimizer.SGD(0.5, parameters=[t]), **kw)
    t.grad = J.to_tensor(g)
    opt.step()
    return np.asarray(t.numpy())


def test_local_sgd_and_dgc_average_over_the_ranks(inputs):
    d, _, ranks = inputs
    local = np.mean([_one_process(JM.LocalSGDOptimizer, d["meta_w"][r],
                                  d["meta_g"][r]) for r in range(WORLD)], 0)
    dgc = np.mean([_one_process(JM.DGCMomentumOptimizer, d["meta_w"][0],
                                d["meta_g"][r], sparsity=0.5)
                   for r in range(WORLD)], 0)
    for r in range(WORLD):
        got_local, got_dgc = ranks[r]["meta"]
        np.testing.assert_allclose(got_local, local, **TOL)
        np.testing.assert_allclose(got_dgc, dgc, **TOL)


@pytest.fixture
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def test_gradient_merge_and_the_strategy_compiler(_cpu):
    rng = np.random.default_rng(9)
    w0 = rng.standard_normal(6).astype(np.float32)
    grads = rng.standard_normal((4, 6)).astype(np.float32)
    jt = J.to_tensor(w0.copy())
    jt.stop_gradient = False
    jopt = JM.GradientMergeOptimizer(J.optimizer.SGD(0.5, parameters=[jt]),
                                     k_steps=2)
    import torch

    tt = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = TM.GradientMergeOptimizer(T.optimizer.SGD(0.5, parameters=[tt]),
                                     k_steps=2)
    for g in grads:
        jt.grad = J.to_tensor(g)
        jopt.step()
        tt.grad = torch.from_numpy(g.copy())
        topt.step()
        np.testing.assert_allclose(tt.detach().numpy(), np.asarray(
            jt.numpy()), **TOL)
    for flags in ({"lamb": True, "lars": True},
                  {"dgc": True, "localsgd": True, "gradient_merge": True}):
        reports = []
        for P_, M in ((J, JM), (T, TM)):
            s = P_.distributed.fleet.DistributedStrategy()
            for k, v in flags.items():
                setattr(s, k, v)
            with pytest.warns(UserWarning):
                reports.append(M.StrategyCompiler().compile(s)[1:])
        assert reports[0] == reports[1]
