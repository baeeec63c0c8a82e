"""Hybrid-parallel training of the port (``distributed.fleet``) against
the JAX package's ``train_batch``, which computes the unsharded model's
step with GSPMD on the conftest's 8-device CPU mesh.

The port's four ranks are gloo processes spawned once for the module
(``test_torch_fleet_ranks.hybrid_and_pipeline_rank``: every hybrid case,
then the pipeline cases, in one spawn). Each case
trains the tiny GPT (vocab 128, hidden 32, 2 layers, 2 heads, seq 16,
dropout 0; 4 heads for mp4, whose ranks keep whole heads) for three
``train_batch`` steps of AdamW (epsilon 1e-4, so that the key bias,
whose exact gradient is 0, does not take a full step on each package's
rounding) with ``ClipGradByGlobalNorm(1.0)`` on a batch of 8, from the
reference's weights:

- dp2 x mp2, mp4, dp4, ZeRO ``os`` / ``os_g`` / ``p_g_os`` (sharding 2 x
  mp2), ``strategy.recompute`` and ``strategy.amp`` (O1, bfloat16): the
  three losses on every rank and each rank's final ``state_dict()``
  (its model-parallel shard, cut from the reference's by
  ``meta_parallel.shard_state_dict``) against the reference's, read
  through ``dm.state_dict()`` (the reference's step donates the layer's
  arrays: an eager call of its model after ``train_batch`` raises).
  Float32: the losses within rtol 1e-5, the parameters within rtol 1e-4
  / atol 1e-5. bfloat16 (amp): rtol 2e-2 / atol 3e-3 (three steps of lr
  1e-3: an element whose gradient is near 0 may step the other way);
- pp2 x dp2 through ``build_gpt_pipeline`` with 1F1B over 2
  micro-batches, in both ``pipeline_configs["recompute"]`` modes, AdamW
  without a clip: the losses, ``eval_batch`` and each stage's parameters,
  the same float32 tolerances. The reference's eager
  ``ClipGradByGlobalNorm`` cannot run over a pipeline (its stages'
  arrays lie on different devices, and its norm concatenates them:
  ``ValueError: Received incompatible devices``), so the pipeline's clip
  is held on the card against the one-rank step (``chip_smoke.py`` phase
  16 (c));
- the hybrid clip: the rank's ``HybridNorm`` total over its shard equals
  the whole model's sum of squares of the reference's gradients (rtol
  1e-5);
- dropout 0.1 at dp2 x mp2: the reference draws one mask over each full
  tensor; a rank of the port draws that mask's slice (its rows, and its
  heads of the attention output) through the window of its
  ``ShardWindow``: the losses and the final state at the float32
  tolerances above. The pipeline at dropout 0.1 (pp2 x dp2, 1F1B): the
  reference draws one key a (micro-batch, stage) and its masks over the
  whole micro-batch, and a data rank draws its rows of them.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.text.gpt import GPTConfig as JGPTConfig
from paddle_tpu.text.gpt import GPTForCausalLM as JGPT
from paddle_tpu.text.gpt import build_gpt_pipeline as jpipeline
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    model_specs, rank_state_dict)
from paddle_tpu_torch.distributed.topology import CommunicateTopology
from test_torch_fleet_ranks import (ACCUMULATE, ADAM, BATCH, GPT, HYBRID,
                                    PIPE_DROPOUT, SEQ, STEP_SEED, STEPS,
                                    gpt_config,
                                    gpt_from,
                                    gpt_pipeline, hybrid_and_pipeline_rank,
                                    spawn_ranks)

F32 = dict(rtol=1e-4, atol=1e-5)
#: bfloat16: an element whose gradient is near 0 may take its Adam steps
#: (lr 1e-3 each) the other way in one package: 3 steps of it
BF16 = dict(rtol=2e-2, atol=3e-3)


@contextlib.contextmanager
def _fresh_mesh():
    """The reference's fleet sets its global mesh: restore it after."""
    prev = (jenv._global_mesh, jenv._initialized)
    try:
        yield
    finally:
        jenv._global_mesh, jenv._initialized = prev
        jfleet.fleet.reset()


def _ref_params():
    J.seed(11)
    m = JGPT(JGPTConfig(**GPT))
    return {k: np.asarray(v._value) for k, v in
            m.functional_state()[0].items()}


def _ref_model(params, name=None):
    m = JGPT(JGPTConfig(**gpt_config(name)))
    for k, t in m.functional_state()[0].items():
        t._value = jnp.asarray(params[k])
    return m


def _batch():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, GPT["vocab_size"], (BATCH, SEQ + 1))
    return ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)


def _strategy(name):
    hybrid, switches = HYBRID[name][:2]
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = dict(dict(dp_degree=1, mp_degree=1, pp_degree=1,
                                 sharding_degree=1), **hybrid)
    for k, v in switches.items():
        setattr(s, k, v)
    return s


def reference_hybrid(name, params, ids, labels):
    with _fresh_mesh():
        f = jfleet.fleet.reset()
        f.init(is_collective=True, strategy=_strategy(name))
        model = _ref_model(params, name)
        jfleet.apply_megatron_specs(model)
        opt = J.optimizer.AdamW(parameters=model.parameters(),
                                grad_clip=J.nn.ClipGradByGlobalNorm(1.0),
                                **ADAM)
        dm = f.distributed_model(model)
        dopt = f.distributed_optimizer(opt)
        J.seed(STEP_SEED)
        losses = [float(dm.train_batch([ids, labels], dopt).numpy())
                  for _ in range(STEPS)]
        state = {k: np.asarray(v.numpy()) for k, v in dm.state_dict().items()}
    return losses, state


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The inputs of the hybrid and the pipeline cases, and the four
    ranks' results of both (one spawn)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the conftest 8-device CPU mesh")
    tmp = tmp_path_factory.mktemp("hybrid")
    ids, labels = _batch()
    # the 4-head GPT of mp4 has the 2-head one's parameter shapes
    params = _ref_params()
    path = str(tmp / "in.npz")
    np.savez(path, ids=ids, labels=labels,
             **{f"p:{k}": v for k, v in params.items()})
    J.seed(12)
    pipe = jpipeline(JGPTConfig(**GPT), 2)
    pipe_params = {k: np.asarray(v.numpy())
                   for k, v in pipe.state_dict().items()}
    pipe_path = str(tmp / "pipe.npz")
    np.savez(pipe_path, ids=ids, labels=labels,
             **{f"q:{k}": v for k, v in pipe_params.items()})
    ranks = spawn_ranks(hybrid_and_pipeline_rank, str(tmp), path,
                        list(HYBRID), "file://" + str(tmp / "rdv-pipe"),
                        pipe_path)
    return {"params": params, "pipe_params": pipe_params, "ids": ids,
            "labels": labels, "ranks": [h for h, _ in ranks],
            "pipe_ranks": [p for _, p in ranks]}


@pytest.fixture(scope="module")
def world(spawned):
    return spawned


def _want_shard(state, name, rank):
    """The reference's state in the port's layout, cut to global ``rank``
    of the case's topology (``meta_parallel.rank_state_dict``)."""
    from paddle_tpu_torch.distributed import fleet

    port = gpt_from(state, name)
    fleet.apply_megatron_specs(port)
    hc = dict(dict(dp_degree=1, pp_degree=1, sharding_degree=1,
                   mp_degree=1), **HYBRID[name][0])
    topo = CommunicateTopology(("data", "pipe", "sharding", "model"),
                               [hc["dp_degree"], hc["pp_degree"],
                                hc["sharding_degree"], hc["mp_degree"]])
    full = {k: v.detach() for k, v in port.state_dict().items()}
    return rank_state_dict(full, model_specs(port), topo, rank,
                           zero=name.startswith("zero"))


@pytest.mark.parametrize("name", [n for n in HYBRID if "dropout" not in n])
def test_hybrid_steps_match_the_reference(world, name):
    params = world["params"]
    losses, state = reference_hybrid(name, params, world["ids"],
                                     world["labels"])
    tol = BF16 if "amp" in name else F32
    for r, res in enumerate(world["ranks"]):
        got = res[name]
        np.testing.assert_allclose(got["losses"], losses,
                                   rtol=tol["rtol"] / 10 if tol is F32
                                   else tol["rtol"], err_msg=f"rank {r}")
        want = _want_shard(state, name, r)
        chunk = want.pop("zero_chunk", None)
        assert sorted(got["state"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["state"][k], v.numpy(),
                                       err_msg=f"{name} rank {r} {k}", **tol)
        if chunk is not None:   # the rank's ZeRO partition, and its bytes
            np.testing.assert_allclose(got["zero_chunk"], chunk.numpy(),
                                       **tol)
            # moments and float32 master of 1/2 the model (and the
            # optimizer's scalars)
            assert 12 * chunk.numel() <= got["state_bytes"] \
                <= 12 * chunk.numel() + 4096


def test_hybrid_clip_norm_is_the_whole_models(world):
    params = world["params"]
    model = _ref_model(params)
    pvals, bvals = model.functional_state()
    pv = {k: v._value for k, v in pvals.items()}

    def loss(p):
        out, _ = model.functional_call(p, {k: v._value for k, v in
                                           bvals.items()},
                                       J.to_tensor(world["ids"]))
        lv = J.nn.functional.cross_entropy(out, J.to_tensor(world["labels"]))
        return lv._value

    grads = jax.jit(jax.grad(loss))(pv)
    want = sum(float(np.sum(np.asarray(g, np.float64) ** 2))
               for g in grads.values())
    for res in world["ranks"]:
        np.testing.assert_allclose(res["norm"], want, rtol=1e-5)


def test_dropout_hybrid_step_differs_from_the_references_mask(world):
    """ROADMAP Queue 3 fault 5, repaired: with dropout 0.1 at dp2 x mp2
    each rank draws its slice of the reference's one mask over each full
    tensor, so the losses and the weights are the reference's (the name
    is the test's from before the repair, when the masks differed)."""
    name = "dp2_mp2_dropout"
    losses, state = reference_hybrid(name, world["params"], world["ids"],
                                     world["labels"])
    no_dropout, _ = reference_hybrid("dp2_mp2", world["params"],
                                     world["ids"], world["labels"])
    assert abs(losses[0] - no_dropout[0]) > 1e-4  # the masks drop
    for r, res in enumerate(world["ranks"]):
        got = res[name]
        np.testing.assert_allclose(got["losses"], losses,
                                   rtol=F32["rtol"] / 10, err_msg=f"rank {r}")
        want = _want_shard(state, name, r)
        assert sorted(got["state"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["state"][k], v.numpy(),
                                       err_msg=f"{name} rank {r} {k}", **F32)


# ------------------------------------------------------------ pipeline
def reference_pipeline(recompute, params, ids, labels, dropout=0.0):
    with _fresh_mesh():
        s = jfleet.DistributedStrategy()
        s.hybrid_configs = dict(dp_degree=2, mp_degree=1, pp_degree=2,
                                sharding_degree=1)
        s.pipeline = True
        s.pipeline_configs = {"accumulate_steps": ACCUMULATE,
                              "micro_batch_size": BATCH // ACCUMULATE,
                              "recompute": recompute}
        f = jfleet.fleet.reset()
        f.init(is_collective=True, strategy=s)
        pipe = jpipeline(JGPTConfig(**dict(GPT, dropout=dropout)), 2)
        for k, t in pipe.state_dict().items():
            t._value = jnp.asarray(params[k])
        dm = f.distributed_model(pipe)
        opt = J.optimizer.AdamW(parameters=pipe.parameters(), **ADAM)
        dopt = f.distributed_optimizer(opt)
        J.seed(STEP_SEED)
        losses = [float(dm.train_batch((J.to_tensor(ids),
                                        J.to_tensor(labels)), dopt).numpy())
                  for _ in range(STEPS)]
        ev = float(dm.eval_batch((J.to_tensor(ids), J.to_tensor(labels)))
                   .numpy())
        state = {k: np.asarray(v.numpy()) for k, v in pipe.state_dict().items()}
    return losses, ev, state


@pytest.fixture(scope="module")
def piped(spawned):
    return (spawned["pipe_params"], spawned["ids"], spawned["labels"],
            spawned["pipe_ranks"])


@pytest.mark.parametrize("recompute", [True, False],
                         ids=["recompute", "stash"])
def test_pipeline_1f1b_matches_the_reference(piped, recompute):
    params, ids, labels, ranks = piped
    losses, ev, state = reference_pipeline(recompute, params, ids, labels)
    for r, res in enumerate(ranks):
        got = res[recompute]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["eval"], ev, rtol=1e-5)
        stage = got["coord"]["pipe"]
        assert got["state"] and all(k.startswith(f"stages.{stage}.")
                                    for k in got["state"])
        want = gpt_pipeline(state).state_dict()
        for k, v in got["state"].items():
            np.testing.assert_allclose(v, want[k].detach().numpy(),
                                       err_msg=f"rank {r} {k}", **F32)


def test_pipeline_dropout_draws_one_mask_a_micro_batch(piped):
    """Dropout 0.1 over pp2 x dp2: as the reference, one key a
    (micro-batch, stage), each mask over the whole micro-batch, of which
    a data rank draws its rows."""
    params, ids, labels, ranks = piped
    losses, ev, state = reference_pipeline(False, params, ids, labels,
                                           PIPE_DROPOUT)
    plain, _, _ = reference_pipeline(False, params, ids, labels)
    assert abs(losses[0] - plain[0]) > 1e-4  # the masks drop
    want = gpt_pipeline(state).state_dict()
    for r, res in enumerate(ranks):
        got = res["dropout"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["eval"], ev, rtol=1e-5)
        for k, v in got["state"].items():
            np.testing.assert_allclose(v, want[k].detach().numpy(),
                                       err_msg=f"rank {r} {k}", **F32)
