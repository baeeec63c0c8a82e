"""Tensor-parallel serving in the port against the JAX engine: the port's
ranks are real processes over gloo, the JAX engine runs in this process on
the conftest's 8-device CPU mesh, exactly as ``tests/test_serving_tp.py``
runs it.

The ranks are spawned once for TP=2 and once for TP=4 (module fixtures,
``file://`` rendezvous under ``tmp_path``, joined within
``SPAWN_TIMEOUT_S``); each spawn serves every scenario of
``test_torch_tp_ranks.SCENARIOS`` and returns its outputs. For each
scenario and degree:

- every rank's token streams are equal, equal to the port's TP=1 and to
  the JAX engine's at the same degree (the quantized-logits scenario, which
  changes the logits by design, against the JAX engine only);
- the last forward's logits lie within 1e-5 of the JAX TP engine's,
  relative to their largest entry;
- every target forward issues ``2L + 1`` all-reduces (``2L + 2`` with
  quantized logits), the draft's forwards none, and the host reads the
  device as often as at TP=1.

``quantized_psum`` is held bit for bit against the reference's under
``shard_map``; the ranks' shards against the reference's
``TPContext._spec_and_transform``; the validation errors, the
``serving_tp_degree`` gauge and ``RNGStatesTracker`` against the
reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import paddle_tpu.core.rng as jrng
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.spec import SpecConfig as JSpecConfig
from paddle_tpu.serving.tp import TPContext as JTPContext
from paddle_tpu.serving.tp import quantized_psum as j_quantized_psum
from paddle_tpu.text.gpt import GPTConfig as JGPTConfig
from paddle_tpu.text.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving.tp import TPContext
from paddle_tpu_torch.text import GPTConfig
from test_torch_tp_ranks import (BASE, DRAFT, LAYERS, MODEL, SCENARIOS,
                                 build_model, check_rank, rids,
                                 run_scenario, save_params, serve_rank,
                                 spawn_ranks)

LOGITS_RTOL = 1e-5


def _jax_model(params, cfg):
    m = JGPT(JGPTConfig(dropout=0.0, **cfg))
    m.eval()
    for name, t in m.functional_state()[0].items():
        t._value = jnp.asarray(params[name])
    return m


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The saved weights, the JAX models and the port's TP=1 runs."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the conftest 8-device CPU mesh")
    tmp = tmp_path_factory.mktemp("tp")
    path = str(tmp / "params.npz")
    params = save_params(path)
    return {"tmp": tmp, "path": path,
            "jmodel": _jax_model(params["model"], MODEL),
            "jdraft": _jax_model(params["draft"], DRAFT),
            "one": {n: run_scenario(n, 1, path) for n in SCENARIOS
                    if not SCENARIOS[n].get("tp_only")}}


@pytest.fixture(scope="module")
def ranks2(world):
    return spawn_ranks(serve_rank, 2, world["tmp"], world["path"],
                       list(SCENARIOS))


@pytest.fixture(scope="module")
def ranks4(world):
    return spawn_ranks(serve_rank, 4, world["tmp"], world["path"],
                       list(SCENARIOS))


def run_jax(world, name, tp):
    """The JAX engine at degree ``tp`` on one scenario: outputs by rid and
    the last model call's logits (taken off the device by a debug
    callback, inside the sharded program)."""
    sc = SCENARIOS[name]
    cfg = dict(BASE, **sc["cfg"])
    kw = {}
    if "spec" in cfg:
        spec = dict(cfg["spec"])
        if spec["method"] == "draft":
            spec["draft"] = JGPTConfig(dropout=0.0, **DRAFT)
            kw["draft_model"] = world["jdraft"]
        cfg["spec"] = JSpecConfig(**spec)
    eng = JServingEngine(world["jmodel"], JServingConfig(
        tensor_parallel=tp, enable_tracing=False, **cfg), **kw)
    last = {}
    run_model = eng._run_model

    def captured(*a):
        logits, pools = run_model(*a)
        jax.debug.callback(
            lambda v: last.__setitem__("logits", np.asarray(v)), logits)
        return logits, pools

    eng._run_model = captured
    outs = {}
    pairs = list(zip(rids(name), sc["reqs"]))
    for rid, (p, b) in pairs:
        eng.add_request(p, b, rid=rid)
        if sc.get("sequential"):
            outs.update(eng.run())
    outs.update(eng.run())
    jax.effects_barrier()
    return ({r: np.asarray(o).tolist() for r, o in outs.items()},
            last["logits"])


def _check(world, ranks, name, tp):
    r0 = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["outs"] == r0["outs"], (name, "ranks diverged")
        np.testing.assert_array_equal(r[name]["logits"], r0["logits"])
    jouts, jlogits = run_jax(world, name, tp)
    assert r0["outs"] == jouts, (name, tp)
    scale = np.abs(jlogits).max()
    assert np.abs(r0["logits"] - jlogits).max() <= LOGITS_RTOL * scale, name
    quantized = SCENARIOS[name]["cfg"].get("tp_quantized_logits", False)
    want = 2 * LAYERS + 1 + int(quantized)
    assert set(r0["per_forward"]) == {want}, (name, r0["per_forward"])
    # the draft's forwards add none
    assert r0["all_reduces"] == want * len(r0["per_forward"]), name
    assert r0["tp_degree"] == tp
    assert r0["pool_shape"][4] == MODEL["num_heads"] // tp
    if not quantized:
        one = world["one"][name]
        assert r0["outs"] == one["outs"], (name, "differs from TP=1")
        assert r0["reads"] == one["reads"], name
        assert r0["counters"] == one["counters"], name


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp2_matches_jax_tp2_and_port_tp1(world, ranks2, name):
    _check(world, ranks2, name, 2)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp4_matches_jax_tp4_and_port_tp1(world, ranks4, name):
    _check(world, ranks4, name, 4)


def test_scenarios_exercise_their_feature(world, ranks2):
    """Each scenario reaches the path it is named for."""
    c = {n: r["counters"] for n, r in ranks2[0].items()}
    assert c["prefix"]["prefix_hit_tokens"] >= 8
    assert c["recompute"]["preemptions"] >= 1
    assert c["swap"]["swaps_out"] >= 1 and c["chunked_swap"]["swaps_out"] >= 1
    assert c["ngram"]["verify_steps"] == c["ngram"]["decode_steps"] > 0
    assert c["draft"]["verify_steps"] > 0


# --------------------------------------------------------- quantized_psum
@pytest.mark.parametrize("kind", ["q", "zero", "mixed"])
def test_quantized_psum_bit_equal_to_reference(checked, kind):
    """The ranks' ``quantized_psum`` against the reference's under
    ``shard_map`` on the same partials, bit for bit: random partials, an
    all-zero input, and one rank's partial zero."""
    xs = [c["x"] for c in checked]
    if kind == "zero":
        xs = [np.zeros_like(x) for x in xs]
    elif kind == "mixed":
        xs = [xs[0], np.zeros_like(xs[1])]
    mesh = Mesh(np.array(jax.devices()[:2]), ("tp",))
    from jax.experimental.shard_map import shard_map
    f = shard_map(lambda x: j_quantized_psum(x[0], "tp")[None], mesh=mesh,
                  in_specs=P("tp"), out_specs=P("tp"), check_rep=False)
    want = np.asarray(f(jnp.asarray(np.stack(xs))))
    for r, c in enumerate(checked):
        np.testing.assert_array_equal(c[kind], want[r])


# ---------------------------------------------- shards against the reference
@pytest.fixture(scope="module")
def checked(world):
    return spawn_ranks(check_rank, 2, world["tmp"])


def test_rank_shards_equal_reference_transformed_shards(checked):
    """Each rank's parameters equal its block of the reference's
    ``_spec_and_transform`` output, transposed to ``[out, in]``."""
    from paddle_tpu_torch.text import GPTForCausalLM
    from paddle_tpu_torch.text.convert import state_dict_to_jax
    cfg = GPTConfig(**MODEL)
    full = GPTForCausalLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    ref = state_dict_to_jax(full.state_dict(), cfg)  # [in, out] layout
    jtp = JTPContext.__new__(JTPContext)
    jtp.model_cfg, jtp.degree = JGPTConfig(dropout=0.0, **MODEL), 2
    for name, arr in ref.items():
        glob, axes = jtp._spec_and_transform(name, arr)
        for r, rank in enumerate(checked):
            shard = glob
            for ax, a in enumerate(axes):
                if a == "tp":
                    k = glob.shape[ax] // 2
                    shard = np.take(glob, range(r * k, (r + 1) * k), axis=ax)
            if name.endswith(("out_proj.bias", "fc2.bias")):
                shard = shard[0]  # the stacked [tp, dim] bias's row
            mine = rank["shards"][name]
            if mine.ndim == 2 and name != "gpt.wte.weight" \
                    and name != "gpt.wpe.weight":
                mine = mine.T  # torch's [out, in] back to [in, out]
            np.testing.assert_array_equal(mine, shard, err_msg=name)


def test_validation_errors_and_tp_degree_gauge(world):
    """The reference's messages: a degree below 1, heads not divisible,
    more ranks than the process group holds; ``serving_tp_degree`` is
    seeded at 0 and set at construction."""
    model = build_model(world["path"])
    with pytest.raises(ValueError, match="tensor_parallel -1"):
        ServingEngine(model, ServingConfig(tensor_parallel=-1), device="cpu")
    with pytest.raises(ValueError, match="num_heads"):
        TPContext(3, GPTConfig(**MODEL))
    with pytest.raises(ValueError, match="only 1 rank"):
        ServingEngine(model, ServingConfig(tensor_parallel=2, **BASE),
                      device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        TPContext(1, GPTConfig(**MODEL))
    eng = ServingEngine(model, ServingConfig(**BASE), device="cpu")
    assert eng.metrics.snapshot()["serving_tp_degree"] == 1
    from paddle_tpu_torch.serving.metrics import ServingMetrics
    snap = ServingMetrics().snapshot()
    for k in ("serving_tp_degree", "serving_tp_collective_ops_per_step",
              "serving_tp_collective_bytes_per_token"):
        assert snap[k] == 0, k
    with pytest.raises(NotImplementedError, match="item 11"):
        ServingConfig(mesh_topology=object())


def test_step_budget_matches_reference():
    cfg = GPTConfig(**MODEL)
    jcfg = JGPTConfig(dropout=0.0, **MODEL)
    for q in (False, True):
        tp = TPContext.__new__(TPContext)
        tp.model_cfg, tp.quantized_logits = cfg, q
        tp.overlap_scheduler = q
        jtp = JTPContext.__new__(JTPContext)
        jtp.model_cfg, jtp.quantized_logits = jcfg, q
        jtp.overlap_scheduler = q
        mine, ref = tp.step_budget(2, 8), jtp.step_budget(2, 8)
        assert mine.all_reduce == ref.all_reduce == 2 * LAYERS + 1 + q
        assert mine.max_collective_bytes == ref.max_collective_bytes
        assert mine.min_overlap_frac == ref.min_overlap_frac
        assert tp.compiler_options() is None


# -------------------------------------------------------- RNGStatesTracker
def test_rng_states_tracker_matches_reference():
    """``add`` twice and an unknown name raise as in the reference; inside
    ``rng_state(name)`` the named stream draws the reference's keys;
    ``seed`` reseeds the named streams."""
    for mod in (jrng, trng):
        mod.get_rng_tracker().reset()
    jt, tt = jrng.get_rng_tracker(), trng.get_rng_tracker()
    for tr in (jt, tt):
        tr.add("model_parallel_rng", 1234)
        with pytest.raises(ValueError, match="already added"):
            tr.add("model_parallel_rng", 1)
        with pytest.raises(ValueError, match="not added"):
            with tr.rng_state("nope"):
                pass

    def draws(mod):
        with mod.get_rng_tracker().rng_state("model_parallel_rng"):
            return [np.asarray(jax.random.key_data(k)).tolist()
                    if mod is jrng else list(k)
                    for k in (mod.next_rng_key(), mod.next_rng_key())]

    assert draws(trng) == draws(jrng)
    jrng.seed(7)
    trng.seed(7)
    assert draws(trng) == draws(jrng)
    assert set(tt.states()) == set(jt.states()) == {"model_parallel_rng"}
    for mod in (jrng, trng):
        mod.get_rng_tracker().reset()
    assert tt.states() == {} == jt.states()
