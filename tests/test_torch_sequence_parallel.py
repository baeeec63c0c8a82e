"""Sequence parallelism of the port (``distributed.sequence_parallel``)
against the JAX package's, which runs inside ``shard_map`` on the
conftest's 8-device CPU mesh: port rank ``r`` of four gloo ranks against
the reference's shard ``r`` (``tests/test_torch_sp_ranks.py`` holds what
a rank runs; one spawn for the module).

- ring and Ulysses attention, causal and full, on q, k, v ``[2, 4, 32,
  8]`` float32: each rank's output and its gradients of ``sum(out * g)``
  against the reference's shard within atol/rtol 2e-5 (outputs) and
  3e-5 (gradients), the reference test's own tolerances;
- ``split_sequence`` and ``gather_sequence``: exact; the gradient
  through the gather against the reference's within 1e-6;
- ``scaled_dot_product_attention`` inside ``sequence_parallel_scope`` is
  the ring (within 2e-5 of the reference's ring; Ulysses, a port
  extension, where the scope names it), and raises on an explicit mask
  as the reference's does;
- ``build_context_parallel_step`` at dp2 x sp2 on the tiny GPT of
  ``tests/test_context_parallel_gpt.py``, SGD at lr 0.1: three steps'
  losses (rtol 2e-5) and the final weights (rtol 1e-4, atol 1e-5), and
  two steps on labels whose last 24 tokens a row are -100, where the
  token weighting of each shard's loss shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as J
from paddle_tpu.distributed import sequence_parallel as jsp
from paddle_tpu.distributed.sequence_parallel import _shard_map
from paddle_tpu.text.gpt import GPTConfig as JGPTConfig
from paddle_tpu.text.gpt import GPTForCausalLM as JGPT
from test_torch_sp_ranks import (B, CP_BATCH, CP_LR, CP_PAD, CP_PAD_STEPS,
                                 CP_SEQ, CP_STEPS, D, GPT, H, S, WORLD,
                                 SPAWN_TIMEOUT_S, sp_rank)

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=3e-5, rtol=3e-5)
CP_PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(0)
    data = {n: rng.standard_normal((B, H, S, D)).astype(np.float32)
            for n in "qkvg"}
    data["x"] = rng.standard_normal((B, S, 16)).astype(np.float32)
    data["w"] = rng.standard_normal((B, S, 16)).astype(np.float32)
    ids = rng.integers(0, GPT["vocab_size"], (CP_BATCH, CP_SEQ))
    labels = rng.integers(0, GPT["vocab_size"], (CP_BATCH, CP_SEQ))
    pad = labels.copy()
    pad[:, -CP_PAD:] = -100
    data.update(ids=ids.astype(np.int64), labels=labels.astype(np.int64),
                labels_pad=pad.astype(np.int64))
    return data


def _ref_params():
    J.seed(11)
    m = JGPT(JGPTConfig(**GPT))
    return {k: np.asarray(v._value) for k, v in
            m.functional_state()[0].items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if len(jax.devices()) < WORLD:
        pytest.skip("needs the conftest 8-device CPU mesh")
    from paddle_tpu_torch.distributed import spawn

    tmp = tmp_path_factory.mktemp("sp")
    data = _inputs()
    params = _ref_params()
    path = str(tmp / "in.npz")
    np.savez(path, **data, **{f"p:{k}": v for k, v in params.items()})
    ranks = spawn(sp_rank, WORLD, args=(f"file://{tmp / 'rdv'}", path),
                  timeout_s=SPAWN_TIMEOUT_S)
    return {"data": data, "params": params, "ranks": ranks}


def _sp_mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("sp",))


def _reference_attention(fn, causal, data):
    spec = P(None, None, "sp", None)
    f = _shard_map(lambda q, k, v: fn(q, k, v, "sp", causal), _sp_mesh(),
                   (spec, spec, spec), spec)
    q, k, v, g = (jnp.asarray(data[n]) for n in "qkvg")
    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * g),
                             argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(a) for a in (out, *grads)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_attention_matches_the_reference_shard(world, name, causal):
    fn = jsp.ring_attention if name == "ring" else jsp.ulysses_attention
    want = _reference_attention(fn, causal, world["data"])
    for r, res in enumerate(world["ranks"]):
        got = res[f"{name}_{causal}"]
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(
                a, np.split(b, WORLD, axis=2)[r], err_msg=f"rank {r} [{i}]",
                **(OUT_TOL if i == 0 else GRAD_TOL))


def test_split_and_gather_sequence(world):
    x, w = (jnp.asarray(world["data"][n]) for n in "xw")
    mesh = _sp_mesh()
    split = jax.jit(_shard_map(lambda t: jsp.split_sequence(t, "sp", 1),
                               mesh, (P(),), P(None, "sp")))(x)
    gather = _shard_map(lambda t: jsp.gather_sequence(t, "sp", 1), mesh,
                        (P(None, "sp"),), P())
    full = jax.jit(gather)(x)
    grad = jax.jit(jax.grad(lambda t: jnp.sum(gather(t) * w)))(x)
    for r, res in enumerate(world["ranks"]):
        np.testing.assert_array_equal(
            res["split"], np.split(np.asarray(split), WORLD, axis=1)[r])
        np.testing.assert_array_equal(res["gather"], np.asarray(full))
        np.testing.assert_allclose(
            res["gather_grad"], np.split(np.asarray(grad), WORLD, axis=1)[r],
            atol=1e-6, rtol=1e-6)


def test_sdpa_dispatches_to_the_ring_and_raises_on_a_mask(world):
    want = _reference_attention(jsp.ring_attention, True, world["data"])[0]
    ulysses = _reference_attention(jsp.ulysses_attention, True,
                                   world["data"])[0]
    for r, res in enumerate(world["ranks"]):
        np.testing.assert_allclose(res["sdpa"],
                                   np.split(want, WORLD, axis=2)[r],
                                   **OUT_TOL)
        np.testing.assert_allclose(res["sdpa_ulysses"],
                                   np.split(ulysses, WORLD, axis=2)[r],
                                   **OUT_TOL)
        assert res["mask_raises"]
    # the reference raises there too
    spec = P(None, None, "sp", None)

    def f(q):
        with jsp.sequence_parallel_scope("sp"):
            t = J.to_tensor(q) if not isinstance(q, jax.Array) else \
                J.Tensor(q)
            return J.nn.functional.scaled_dot_product_attention(
                t, t, t, attn_mask=J.Tensor(jnp.ones((8, 8), bool)))._value

    with pytest.raises(NotImplementedError):
        jax.jit(_shard_map(f, _sp_mesh(), (spec,), spec))(
            jnp.asarray(world["data"]["q"]))


def _cp_loss(logits, labels):
    return J.nn.functional.cross_entropy(
        logits.reshape([-1, GPT["vocab_size"]]), labels.reshape([-1]))


def _reference_cp(params, ids, labels, steps):
    from paddle_tpu.text.gpt import GPTForCausalLM

    model = GPTForCausalLM(JGPTConfig(**GPT))
    for k, t in model.functional_state()[0].items():
        t._value = jnp.asarray(params[k])
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ("dp", "sp"))
    opt = J.optimizer.SGD(CP_LR, parameters=model.parameters())
    init_fn, step_fn, shard_batch = jsp.build_context_parallel_step(
        model, opt, _cp_loss, mesh)
    state = init_fn()
    xs, ys = shard_batch([ids]), shard_batch([labels])
    losses = []
    for i in range(steps):
        loss, state = step_fn(state, jax.random.key(7 + i), CP_LR, xs, ys)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in state["p"].items()}


@pytest.mark.parametrize("case", ["cp", "cp_pad"])
def test_context_parallel_step_matches_the_reference(world, case):
    from paddle_tpu_torch.text import GPTConfig
    from paddle_tpu_torch.text.convert import state_dict_from_jax

    data = world["data"]
    labels = data["labels" if case == "cp" else "labels_pad"]
    steps = CP_STEPS if case == "cp" else CP_PAD_STEPS
    losses, params = _reference_cp(world["params"], data["ids"], labels,
                                   steps)
    want = state_dict_from_jax(params, GPTConfig(**GPT))
    for r, res in enumerate(world["ranks"]):
        got = res[case]
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5,
                                   err_msg=f"rank {r}")
        assert sorted(got["state"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["state"][k], np.asarray(v),
                                       err_msg=f"rank {r} {k}",
                                       **CP_PARAM_TOL)
    assert losses[-1] < losses[0]
