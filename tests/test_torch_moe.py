"""The Mixture-of-Experts layer of the port
(``incubate.distributed.models.moe``) against the JAX package's.

The port's layer splits its 8 experts over four gloo ranks, spawned once
for the module (``test_torch_fleet_ranks.moe_rank``): each rank routes
its own 10 tokens, its dispatch buffer crosses to the experts' ranks by
``global_scatter`` and back by ``global_gather``. The reference is the
dense layer on one controller, run on each rank's tokens with the same
weights (``jax.jit`` of its ``functional_call`` under ``jax.vjp``). A capacity factor of 0.5 (capacity 1 a expert for 10 tokens at
top-2) makes most (token, k) slots overflow. Rank r must give:

- the reference's output on its tokens, and the gradient of ``<ct, y>``
  for its tokens and for the gate (its own tokens'), within rtol 1e-5 /
  atol 1e-6 — equal outputs mean the same top-k, capacity positions, keep
  mask and renormalised gates;
- for its two experts, the reference's gradients summed over every
  rank's tokens (an expert's weights see every rank's tokens);
- some slots dropped: the overflow is exercised.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.incubate import MoELayer as JMoE
from test_torch_fleet_ranks import MOE, WORLD, moe_rank, spawn_ranks

TOL = dict(rtol=1e-5, atol=1e-6)
TOKENS = 10


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if len(jax.devices()) < WORLD:
        pytest.skip("needs the conftest 8-device CPU mesh")
    J.seed(4)
    ref = JMoE(**MOE)
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    rng = np.random.default_rng(8)
    tokens = rng.standard_normal((WORLD, TOKENS, MOE["d_model"])).astype(
        np.float32)
    ct = rng.standard_normal(tokens.shape).astype(np.float32)
    tmp = tmp_path_factory.mktemp("moe")
    path = str(tmp / "in.npz")
    np.savez(path, tokens=tokens, ct=ct,
             **{f"moe:{k}": v for k, v in state.items()})
    return ref, tokens, ct, spawn_ranks(moe_rank, str(tmp), path)


def _reference(ref, x, ct):
    """The dense layer on one rank's tokens (one ``jax.jit`` of its
    ``functional_call`` under ``jax.vjp``): output, input gradient and
    every parameter's gradient."""
    params = {k: v._value for k, v in ref.functional_state()[0].items()}

    @jax.jit
    def run(p, x, ct):
        y, vjp = jax.vjp(lambda p, x: ref.functional_call(
            p, {}, JTensor(x))[0]._value, p, x)
        gp, gx = vjp(ct)
        return y, gx, gp

    y, dx, grads = run(params, jnp.asarray(x), jnp.asarray(ct))
    return (np.asarray(y), np.asarray(dx),
            {n: np.asarray(g) for n, g in grads.items()})


@pytest.fixture(scope="module")
def reference(world):
    ref, tokens, ct, _ = world
    runs = [_reference(ref, tokens[r], ct[r]) for r in range(WORLD)]
    experts = {n: sum(run[2][n] for run in runs)
               for n in ("w1", "b1", "w2", "b2")}
    return runs, experts


@pytest.mark.parametrize("rank", range(WORLD))
def test_moe_outputs_gradients_and_overflow(world, reference, rank):
    got = world[3][rank]
    runs, experts = reference
    y, dx, grads = runs[rank]
    k = MOE["num_experts"] // WORLD
    np.testing.assert_allclose(got["y"], y, **TOL)
    np.testing.assert_allclose(got["dx"], dx, **TOL)
    np.testing.assert_allclose(got["grads"]["gate.weight"],
                               grads["gate.weight"], **TOL)
    for n, g in experts.items():
        np.testing.assert_allclose(got["grads"][n], g[rank * k:(rank + 1) * k],
                                   err_msg=n, **TOL)
    assert got["keep"].shape == (TOKENS, 2)
    assert int((~got["keep"]).sum()) > 0   # slots overflowed
