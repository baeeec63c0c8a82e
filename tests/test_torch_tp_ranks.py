"""The ranks' half of the tensor-parallel serving tests, and the tests that
need no JAX: the scenarios, the function each spawned rank runs, and the
shard math, validation and ``quantized_psum`` on real gloo ranks.

This module imports no JAX: a rank started with the ``spawn`` method
imports the module that defines its function, and importing the JAX
package would turn on x64 process-wide. ``tests/test_torch_tp.py`` holds
what the ranks return against the JAX engine.

The model is the reference TP tests' size (vocab 97, hidden 32, 2 layers,
4 heads, float32), its weights made with numpy from a seed and passed to
the ranks as an ``.npz`` file. Every scenario gives its requests explicit
ids, so both packages fold the same sampling keys.
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.serving import ServingConfig, ServingEngine, SpecConfig
from paddle_tpu_torch.serving.tp import TPContext, quantized_psum
from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.text.convert import expected_shapes, state_dict_from_jax

MODEL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=48)
DRAFT = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=48)
LAYERS = MODEL["num_layers"]
#: the engine shape of the reference TP tests
BASE = dict(max_batch=2, page_size=4, num_pages=24, max_prompt_len=8)
#: a rank's rendezvous and collective timeout, and the parent's join limit
RANK_TIMEOUT_S = 120.0
SPAWN_TIMEOUT_S = 240.0


def random_params(cfg: GPTConfig, seed: int) -> dict:
    """Numpy weights for every parameter of the reference GPT (its names
    and layout): weights N(0, 0.3), biases N(0, 0.1), LayerNorm scales
    near 1 — greedy argmax gaps stay wide."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in expected_shapes(cfg).items():
        if name.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith(".bias"):
            arr = 0.1 * rng.standard_normal(shape)
        else:
            arr = 0.3 * rng.standard_normal(shape)
        out[name] = arr.astype(np.float32)
    return out


def prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, (n,)).astype(np.int32) for n in lens]


def _whale(lo, hi):
    return np.arange(lo, hi, dtype=np.int32)


#: name -> engine fields (port-neutral: ``spec`` is a dict of SpecConfig
#: fields, ``draft`` builds the draft from DRAFT), the requests as
#: (prompt, max_new_tokens) and whether they run one after another
SCENARIOS = {
    "greedy": dict(cfg=dict(max_prompt_len=16),
                   reqs=list(zip(prompts(0, (3, 12, 7, 5)), (6, 5, 7, 6)))),
    "sampled": dict(cfg=dict(do_sample=True, temperature=0.8, top_k=20,
                             top_p=0.95, seed=5),
                    reqs=list(zip(prompts(1, (4, 7, 6)), (7, 6, 5)))),
    "prefix": dict(cfg=dict(num_pages=32), sequential=True,
                   reqs=[(np.concatenate([prompts(2, (4,))[0], t]), 5)
                         for t in prompts(3, (3, 3, 3))]),
    "chunked": dict(cfg=dict(chunk_size=4, max_prompt_len=16),
                    reqs=list(zip([_whale(1, 14)] + prompts(4, (3, 6)),
                                  (6, 5, 6)))),
    "recompute": dict(cfg=dict(preemption_mode="recompute", num_pages=7),
                      reqs=list(zip(prompts(5, (3, 8, 7, 5)), (8,) * 4))),
    "swap": dict(cfg=dict(preemption_mode="swap", num_pages=7),
                 reqs=list(zip(prompts(5, (3, 8, 7, 5)), (8,) * 4))),
    "chunked_swap": dict(cfg=dict(chunk_size=4, preemption_mode="swap",
                                  num_pages=7),
                         reqs=list(zip([_whale(2, 10)] + prompts(6, (7, 5)),
                                       (8, 8, 8)))),
    "ngram": dict(cfg=dict(spec=dict(method="ngram", depth=2)),
                  reqs=list(zip(prompts(7, (6, 8, 5)), (7, 6, 8)))),
    "draft": dict(cfg=dict(spec=dict(method="draft", depth=2, window=8)),
                  reqs=list(zip(prompts(8, (6, 8, 5)), (7, 6, 8)))),
    "int8": dict(cfg=dict(kv_dtype="int8"),
                 reqs=list(zip(prompts(9, (3, 8, 6)), (6, 6, 5)))),
    "qlogits": dict(cfg=dict(tp_quantized_logits=True), tp_only=True,
                    reqs=list(zip(prompts(10, (3, 8, 6)), (6, 6, 5)))),
}
RID0 = 7000  # scenario k's requests take rids RID0 + 100 k + i


def rids(name):
    k = list(SCENARIOS).index(name)
    return [RID0 + 100 * k + i for i in range(len(SCENARIOS[name]["reqs"]))]


def build_model(params_path, cfg=MODEL, key="model"):
    """The port's float32 CPU model from the weights saved at
    ``params_path`` under ``<key>/<name>``."""
    with np.load(params_path) as z:
        params = {n[len(key) + 1:]: z[n] for n in z.files
                  if n.startswith(key + "/")}
    m = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    m.load_state_dict(state_dict_from_jax(params, m.cfg))
    return m


def save_params(path, seed=23, draft_seed=29):
    """Write the target's and the draft's weights to ``path``; returns
    them ({"model": ..., "draft": ...})."""
    out = {"model": random_params(GPTConfig(**MODEL), seed),
           "draft": random_params(GPTConfig(**DRAFT), draft_seed)}
    np.savez(path, **{f"{k}/{n}": a for k, ps in out.items()
                      for n, a in ps.items()})
    return out


def run_scenario(name, tp, params_path):
    """Serve one scenario on this process (one rank of a ``tp``-rank group
    when ``tp > 1``). Returns the outputs by rid, the all-reduces of every
    target forward, the run's all-reduce and forward totals, the host reads
    (``Tensor.cpu``/``.item``/``.tolist``), the engine's counters, the last
    forward's logits and the pool's shape."""
    sc = SCENARIOS[name]
    cfg = dict(BASE, **sc["cfg"])
    draft = None
    if "spec" in cfg:
        spec = dict(cfg["spec"])
        if spec["method"] == "draft":
            spec["draft"] = GPTConfig(**DRAFT)
            draft = build_model(params_path, DRAFT, key="draft")
        cfg["spec"] = SpecConfig(**spec)
    eng = ServingEngine(build_model(params_path),
                        ServingConfig(tensor_parallel=tp, **cfg),
                        device="cpu", draft_model=draft)
    per_forward, last = [], {}
    forward = eng._forward

    def counted_forward(ids, paged):
        n0 = collective.all_reduces
        out = forward(ids, paged)
        per_forward.append(collective.all_reduces - n0)
        last["logits"] = out
        return out

    eng._forward = counted_forward
    reads = []
    originals = {n: getattr(torch.Tensor, n) for n in ("cpu", "item",
                                                       "tolist")}

    def counter(n):
        def read(self, *a, **kw):
            reads.append(n)
            return originals[n](self, *a, **kw)
        return read

    outs = {}
    n0 = collective.all_reduces
    for n in originals:
        setattr(torch.Tensor, n, counter(n))
    try:
        pairs = list(zip(rids(name), sc["reqs"]))
        if sc.get("sequential"):
            for rid, (p, b) in pairs:
                eng.add_request(p, b, rid=rid)
                outs.update(eng.run())
        else:
            for rid, (p, b) in pairs:
                eng.add_request(p, b, rid=rid)
            outs.update(eng.run())
    finally:
        for n, f in originals.items():
            setattr(torch.Tensor, n, f)
    c = eng.counters
    return {
        "outs": {r: np.asarray(o).tolist() for r, o in outs.items()},
        "per_forward": per_forward,
        "all_reduces": collective.all_reduces - n0,
        "reads": len(reads),
        "counters": {k: getattr(c, k) for k in (
            "prefills", "decode_steps", "verify_steps", "preemptions",
            "swaps_out", "prefix_hit_tokens", "spec_accepted")},
        "logits": last["logits"].detach().numpy().copy(),
        "pool_shape": tuple(eng.cache.pools.shape),
        "tp_degree": eng.metrics.snapshot()["serving_tp_degree"],
    }


def serve_rank(rank, world, init_method, params_path, names):
    """A spawned rank: join the gloo group, serve every scenario of
    ``names``, leave the group. Returns {name: run_scenario(...)}."""
    torch.set_num_threads(1)
    ptd.init_parallel_env("gloo", init_method, world, rank,
                          timeout_s=RANK_TIMEOUT_S)
    try:
        return {n: run_scenario(n, world, params_path) for n in names}
    finally:
        ptd.destroy_process_group()


def serve_and_check_rank(rank, world, init_method, params_path, names,
                         check_init):
    """:func:`serve_rank`, then :func:`check_rank` over the rendezvous
    ``check_init``, in one spawned process: a test module's TP=2 fixtures
    share one spawn (a spawned rank costs seconds before it computes)."""
    served = serve_rank(rank, world, init_method, params_path, names)
    return served, check_rank(rank, world, check_init)


def spawn_ranks(fn, world, tmp_path, *args):
    """``fn(rank, world, init_method, *args)`` on ``world`` spawned
    ranks over a ``file://`` rendezvous under ``tmp_path``."""
    init = f"file://{os.path.join(tmp_path, f'rdv{world}')}"
    return ptd.spawn(fn, world, args=(init, *args),
                     timeout_s=SPAWN_TIMEOUT_S)


# ------------------------------------------------ rank-side checks, no JAX
def check_rank(rank, world, init_method):
    """Shard math, ``quantized_psum`` and validation on one rank; returns
    what the parent compares across ranks."""
    torch.set_num_threads(1)
    ptd.init_parallel_env("gloo", init_method, world, rank,
                          timeout_s=RANK_TIMEOUT_S)
    try:
        cfg = GPTConfig(**MODEL)
        with pytest.raises(ValueError, match="num_heads=3"):
            TPContext(world, GPTConfig(**dict(MODEL, num_heads=3,
                                              hidden_size=33)))
        with pytest.raises(ValueError, match=f"only {world} rank"):
            TPContext(4 * world, GPTConfig(**dict(MODEL, num_heads=8)))
        tp = TPContext(world, cfg)
        g = torch.Generator().manual_seed(0)
        full = GPTForCausalLM(cfg, device="cpu", generator=g)
        local = tp.shard_params(full)
        shards = {k: v.numpy().copy() for k, v in local.state_dict().items()}
        rng = np.random.default_rng(rank)
        x = torch.from_numpy(rng.standard_normal((3, 97)).astype(np.float32))
        q = quantized_psum(x.clone(), tp.axis).numpy()
        z = quantized_psum(torch.zeros(3, 97), tp.axis).numpy()
        m = quantized_psum(x.clone() if rank == 0 else torch.zeros(3, 97),
                           tp.axis).numpy()
        pools = torch.arange(2 * 2 * 3 * 4 * 4 * 8, dtype=torch.float32) \
            .reshape(2, 2, 3, 4, 4, 8)      # [L, 2, pages, ps, heads, d]
        scales = torch.arange(2 * 2 * 3 * 4.0).reshape(2, 2, 3, 4)
        pool_shard, scale_shard = tp.shard_pools(pools, scales)
        return {"shards": shards, "q": q, "zero": z, "mixed": m,
                "x": x.numpy(), "untied": untied_logits(world),
                "pools": (pools.numpy(), pool_shard.numpy(),
                          scales.numpy(), scale_shard.numpy())}
    finally:
        ptd.destroy_process_group()


def untied_logits(world):
    """An untied LM head served at TP=1 and at TP=``world`` on this rank:
    the largest difference of their forwards' logits (real tokens' rows),
    relative to the largest entry, and whether the tokens are equal."""
    cfg = GPTConfig(**dict(MODEL, tie_word_embeddings=False))
    model = GPTForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    for p in model.parameters():  # wide argmax gaps, as random_params
        p.data.mul_(15.0)
    logits, outs = {}, {}
    for tp in (1, world):
        eng = ServingEngine(model, ServingConfig(tensor_parallel=tp, **BASE),
                            device="cpu")
        seen = logits[tp] = []
        forward = eng._forward

        def kept(ids, paged, _forward=forward, _seen=seen):
            out = _forward(ids, paged)
            _seen.append(out[paged.valid])
            return out

        eng._forward = kept
        for i, p in enumerate(prompts(11, (5, 7))):
            eng.add_request(p, 4, rid=i)
        outs[tp] = {r: o.tolist() for r, o in eng.run().items()}
    err = max(float((a - b).abs().max() / a.abs().max())
              for a, b in zip(logits[1], logits[world]))
    return {"err": err, "equal": outs[1] == outs[world],
            "forwards": len(logits[world])}


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpcheck")
    return spawn_ranks(check_rank, 2, tmp)


def test_rank_shards_reassemble_the_full_model(checked):
    """Concatenating the ranks' shards along their split axes gives the
    full weights back (qkv through the head permutation); row-parallel
    biases are real on rank 0 only; replicated weights are equal."""
    cfg = GPTConfig(**MODEL)
    full = GPTForCausalLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in full.state_dict().items()}
    r0, r1 = checked[0]["shards"], checked[1]["shards"]
    hd, heads = 32 // 4, 4
    for name, w in sd.items():
        a, b = r0[name], r1[name]
        if "qkv_proj" in name:
            parts = [p.reshape(3, heads // 2, hd, *w.shape[1:])
                     for p in (a, b)]
            np.testing.assert_array_equal(
                np.concatenate(parts, 1).reshape(w.shape), w)
        elif name.endswith(("out_proj.weight", "fc2.weight")):
            np.testing.assert_array_equal(np.concatenate([a, b], 1), w)
        elif name.endswith(("out_proj.bias", "fc2.bias")):
            np.testing.assert_array_equal(a, w)
            assert not b.any()
        elif "fc1" in name:
            np.testing.assert_array_equal(np.concatenate([a, b], 0), w)
        else:
            np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(b, w)


def test_quantized_psum_on_ranks_matches_its_formula(checked):
    """Every rank dequantises to the same bits; the value is the
    reference's formula over the gathered inputs, and an all-zero input
    stays zero (step 1)."""
    xs = [c["x"] for c in checked]
    np.testing.assert_array_equal(checked[0]["q"], checked[1]["q"])
    step = np.float32(sum(np.abs(x).max() for x in xs)) / np.float32(125)
    codes = sum(np.clip(np.round(x / step), -127, 127).astype(np.int32)
                for x in xs)
    np.testing.assert_array_equal(
        checked[0]["q"], codes.astype(np.float32) * step)
    assert not checked[0]["zero"].any()


def test_untied_head_splits_its_contraction(checked):
    """An untied ``lm_head`` takes the same hidden split as the tied
    ``wte``: TP=2 logits within 1e-5 of TP=1's, the same tokens, on every
    rank."""
    for c in checked:
        u = c["untied"]
        assert u["forwards"] > 0 and u["equal"]
        assert u["err"] <= 1e-5, u


def test_pool_shards_split_the_heads_axis(checked):
    """``shard_pools``: rank r holds heads ``[r h/tp, (r+1) h/tp)`` of
    the pools (axis 4) and of the int8 scales (axis 3)."""
    pools, _, scales, _ = checked[0]["pools"]
    np.testing.assert_array_equal(
        np.concatenate([c["pools"][1] for c in checked], axis=4), pools)
    np.testing.assert_array_equal(
        np.concatenate([c["pools"][3] for c in checked], axis=3), scales)


# ------------------------------------------- debug checks under TP, no JAX
#: the debug-check legs: engine fields over BASE and the "greedy"
#: scenario's requests
AUDIT_LEGS = {"bf16": {}, "quantized logits": {"tp_quantized_logits": True}}


def _census(report) -> dict:
    return {"ops": len(report.collectives),
            "bytes": [c.nbytes for c in report.collectives],
            "groups": [c.replica_groups for c in report.collectives],
            "host_transfers": len(report.host_transfers),
            "donated": (report.donated_leaves, report.aliased_leaves),
            "flops": report.flops}


def audit_rank(rank, world, init_method, params_path):
    """A spawned rank serving the "greedy" requests under ``debug_checks``
    in each of ``AUDIT_LEGS``, then on a declared one-host topology and a
    declared two-host one. Returns per leg the census of every audited
    program, the step budgets, the ``serving_tp_*`` and placement gauges,
    the outputs; and the two-host leg's refusal of a zero-DCN budget."""
    from paddle_tpu_torch.analysis import (CollectiveBudgetError,
                                           meshcheck)

    torch.set_num_threads(1)
    ptd.init_parallel_env("gloo", init_method, world, rank,
                          timeout_s=RANK_TIMEOUT_S)
    gauges = ("serving_tp_collective_ops_per_step",
              "serving_tp_collective_bytes_per_token",
              "serving_tp_collective_overlap_frac",
              "serving_ici_bytes_per_token", "serving_dcn_bytes_per_token",
              "serving_collective_time_predicted_s",
              "serving_analysis_retraces_total",
              "serving_analysis_host_syncs_total", "serving_decode_steps",
              "serving_prefills_total")
    legs = dict(AUDIT_LEGS)
    legs["one host"] = {"mesh_topology": meshcheck.single_host_topology(
        world)}
    legs["two hosts"] = {"mesh_topology": meshcheck.multi_host_topology(
        world, 1, (("tp", world),))}
    out = {}
    try:
        for name, extra in legs.items():
            sc = SCENARIOS["greedy"]
            eng = ServingEngine(build_model(params_path), ServingConfig(
                tensor_parallel=world, debug_checks=True,
                **dict(BASE, **sc["cfg"], **extra)), device="cpu")
            for rid, (p, b) in zip(rids("greedy"), sc["reqs"]):
                eng.add_request(p, b, rid=rid)
            outs = eng.run()
            snap = eng.metrics.snapshot()
            res = {"audits": {k: _census(r)
                              for k, r in eng.hlo_audits.items()},
                   "budgets": {k: eng._step_budget(k)
                               for k in eng.hlo_audits},
                   "gauges": {g: snap[g] for g in gauges},
                   "compile_counts": eng.compile_counts,
                   "outs": {r: np.asarray(o).tolist()
                            for r, o in outs.items()}}
            if name == "two hosts":
                decode = eng.hlo_audits["decode"]
                topo = eng.config.mesh_topology
                mesh = meshcheck.analyze(decode.collectives, topo, "decode")
                res["axis_media"] = mesh.axis_media
                try:
                    mesh.check(meshcheck._all_ici_budget(
                        eng._step_budget("decode")))
                    res["zero_dcn"] = None
                except CollectiveBudgetError as e:
                    res["zero_dcn"] = str(e)
            out[name] = res
        return out
    finally:
        ptd.destroy_process_group()
