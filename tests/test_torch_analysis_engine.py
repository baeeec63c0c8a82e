"""The port's serving engine under ``ServingConfig(debug_checks=True)``
against the JAX engine's: the reference's analysis toy (vocab 97, hidden
32, 2 layers, 2 heads, batch 2, pages of 4, 12 pages a sequence), one set
of weights, the same requests with the same ids.

Both engines must agree on what the checks count — the signatures each
guarded program took (``compile_counts``, the cache's movers too), the
host reads (one a decode or verify step, one a completed prefill), the
retraces (none), the donation audits and the audited programs — and each
audited program must show no collective and no host read inside it. The
port's flops per program (``hlocheck.step_cost``: the matmuls and the
attention at the program's width) lie within 0.85-1.0 of the XLA count
the reference's audit reads, which adds the elementwise work. Tokens are
equal across the two engines and with the checks on and off, and the
speculative verify and swap paths are audited too."""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.spec import SpecConfig as JSpecConfig
from paddle_tpu_torch.analysis import (HostTransferError, RetraceError,
                                       hlocheck)
from paddle_tpu_torch.serving import ServingConfig, ServingEngine, SpecConfig
from test_torch_gpt import make_pair

TOY = dict(hidden_size=32, num_heads=2, max_seq_len=48)
SERVE = dict(max_batch=2, num_pages=20, page_size=4, max_prompt_len=8,
             debug_checks=True)
#: the speculative leg: n-gram depth 2, a pool small enough that swap
#: preemption fires, four requests of 12 new tokens
SPEC_SWAP = dict(num_pages=9, preemption_mode="swap")


@pytest.fixture(scope="module")
def pair():
    return make_pair(23, **TOY)


def _prompts(extra: bool):
    rng = np.random.RandomState(2)
    ps = [rng.randint(0, 97, (n,)).astype(np.int32) for n in (3, 5)]
    if extra:
        ps += [rng.randint(0, 97, (n,)).astype(np.int32) for n in (7, 6)]
    return ps


def _serve(engine, extra=False):
    new = 12 if extra else 4
    for i, p in enumerate(_prompts(extra)):
        engine.add_request(p, new, rid=1000 + i)
    outs = engine.run()
    return outs, engine.metrics.snapshot()


def _engines(pair, spec=False, **kw):
    jm, tm = pair
    cfg = dict(SERVE, **kw)
    jspec = JSpecConfig(method="ngram", depth=2) if spec else None
    tspec = SpecConfig(method="ngram", depth=2) if spec else None
    return (JServingEngine(jm, JServingConfig(spec=jspec, **cfg)),
            ServingEngine(tm, ServingConfig(spec=tspec, **cfg),
                          device="cpu"))


@pytest.fixture(scope="module")
def plain(pair):
    je, te = _engines(pair)
    jo, js = _serve(je)
    to, ts = _serve(te)
    return dict(je=je, te=te, jo=jo, to=to, js=js, ts=ts)


@pytest.fixture(scope="module")
def spec_swap(pair):
    je, te = _engines(pair, spec=True, **SPEC_SWAP)
    jo, js = _serve(je, extra=True)
    to, ts = _serve(te, extra=True)
    return dict(je=je, te=te, jo=jo, to=to, js=js, ts=ts)


def test_counts_equal_reference(plain):
    je, te, js, ts = plain["je"], plain["te"], plain["js"], plain["ts"]
    assert te.compile_counts == je.compile_counts == \
        {"prefill": 1, "decode": 1}
    assert te.compile_counts["decode"] == te.guards["decode"].traces
    assert te.cache.compile_counts == dict(je.cache.compile_counts) == \
        {"swap_gather": 0, "swap_scatter": 0, "cow_copy": 0}
    for k in ("serving_analysis_host_syncs_total",
              "serving_analysis_retraces_total", "serving_decode_steps",
              "serving_prefills_total"):
        assert ts[k] == js[k], k
    assert ts["serving_analysis_host_syncs_total"] == 5  # 3 decodes + 2
    assert ts["serving_analysis_retraces_total"] == 0
    assert set(plain["to"]) == set(plain["jo"])
    for rid in plain["jo"]:
        np.testing.assert_array_equal(plain["to"][rid], plain["jo"][rid])


def test_retrace_names_ctx_like_reference(plain):
    """A decode call one slot wider than the engine's batch: both guards
    refuse it before running, blaming ``ctx`` on axis 0."""
    import jax.numpy as jnp

    je, te = plain["je"], plain["te"]
    b = te.config.max_batch
    args = list(te._decode_args())
    args[3] = torch.zeros(b + 1, dtype=torch.int32)
    with pytest.raises(RetraceError) as got:
        te._decode_jit(*args)
    from paddle_tpu.analysis import RetraceError as JRetraceError
    with pytest.raises(JRetraceError) as want:
        je._decode_jit(
            je._p, je.cache.pools, jnp.asarray(je.cache.page_table),
            jnp.zeros((b + 1,), jnp.int32), jnp.asarray(je._last_tok),
            jnp.asarray(je._active), jnp.asarray(je._rids),
            jnp.asarray(je._gen))
    for msg in (str(got.value), str(want.value)):
        assert "'decode'" in msg and "ctx" in msg
        assert f"axis 0: {b} -> {b + 1}" in msg
    assert te.compile_counts == je.compile_counts == \
        {"prefill": 1, "decode": 1}


def test_audits_equal_reference(plain):
    je, te = plain["je"], plain["te"]
    assert te._donation_audits == je._donation_audits == \
        {"prefill": [], "decode": []}
    assert set(te.hlo_audits) == set(je.hlo_audits) == {"prefill[8]",
                                                        "decode"}
    for label, ref in je.hlo_audits.items():
        mine = te.hlo_audits[label]
        assert len(mine.collectives) == len(ref.collectives) == 0
        assert len(mine.host_transfers) == len(ref.host_transfers) == 0
        assert mine.donated_leaves == mine.aliased_leaves == 1
        assert 0.85 <= mine.flops / ref.flops <= 1.0, (label, mine.flops,
                                                      ref.flops)


def test_step_cost_is_the_stated_formula():
    """decode on the toy: 2 tokens x 2 x (matmul params + LM head) plus
    4 x tokens x layers x hidden x width (48 positions)."""
    from paddle_tpu_torch.text import GPTConfig

    cfg = GPTConfig(vocab_size=97, num_layers=2, **TOY)
    h, f = 32, 128
    matmul = 2 * (4 * h * h + 2 * h * f) + 97 * h
    cost = hlocheck.step_cost(cfg, "decode", 2, 1, 48)
    assert cost.flops == 2 * 2 * matmul + 4 * 2 * 2 * h * 48 == 135_296
    tp2 = hlocheck.step_cost(cfg, "decode", 2, 1, 48, tp=2)
    assert tp2.flops == cost.flops / 2
    q8 = hlocheck.step_cost(cfg, "decode", 2, 1, 48, kv_dtype="int8")
    assert q8.kv_bytes < cost.kv_bytes and q8.peak_bytes < cost.peak_bytes


def test_metrics_and_roofline_fed(plain):
    """The audits feed the serving_hlo_* gauges and, through the roofline
    tracker, a real share of the peaks; the flight record names each
    audited program."""
    ts, te = plain["ts"], plain["te"]
    assert ts["serving_hlo_collective_ops"] == 0
    assert ts["serving_hlo_host_transfers"] == 0
    assert ts["serving_hlo_flops_per_step"] == \
        te.hlo_audits["prefill[8]"].flops
    assert ts["serving_hlo_peak_hbm_bytes"] == max(
        r.peak_bytes for r in te.hlo_audits.values())
    assert 0 < ts["serving_mfu"] <= 1 and 0 < ts["serving_hbm_bw_util"]
    for label in ("prefill[8]", "decode"):
        assert ts[f"serving_cost_model_drift{{program={label}}}"] > 0
    rec = te.flight_record()
    assert set(rec["programs"]) == set(te.hlo_audits)
    assert rec["programs"]["decode"]["collective_ops"] == 0


def test_tokens_equal_with_checks_on_and_off(pair, plain):
    _, tm = pair
    off = ServingEngine(tm, ServingConfig(**dict(SERVE, debug_checks=False)),
                        device="cpu")
    outs, snap = _serve(off)
    for rid, toks in outs.items():
        np.testing.assert_array_equal(toks, plain["to"][rid])
    assert off.hlo_audits == {} and off._donation_audits == {}
    assert snap["serving_analysis_host_syncs_total"] == 0
    assert off.compile_counts == {"prefill": 1, "decode": 1}


def test_spec_and_swap_legs_audited(spec_swap):
    je, te, js, ts = (spec_swap[k] for k in ("je", "te", "js", "ts"))
    assert ts["serving_preemptions_total"] == \
        js["serving_preemptions_total"] > 0
    assert te.counters.swaps_out > 0
    assert te.compile_counts == je.compile_counts == \
        {"prefill": 1, "decode": 0, "verify": 1}
    assert te.cache.compile_counts == dict(je.cache.compile_counts) == \
        {"swap_gather": 1, "swap_scatter": 1, "cow_copy": 0}
    assert set(te.hlo_audits) == set(je.hlo_audits) == {"prefill[8]",
                                                        "verify"}
    assert te._donation_audits == je._donation_audits == \
        {"prefill": [], "verify": []}
    verify, ref = te.hlo_audits["verify"], je.hlo_audits["verify"]
    assert len(verify.collectives) == len(verify.host_transfers) == 0
    assert 0.85 <= verify.flops / ref.flops <= 1.0
    assert ts["serving_analysis_retraces_total"] == 0
    assert ts["serving_decode_steps"] == js["serving_decode_steps"]
    for rid in spec_swap["jo"]:
        np.testing.assert_array_equal(spec_swap["to"][rid],
                                      spec_swap["jo"][rid])


def test_host_read_inside_a_program_raises(pair, monkeypatch):
    """A device program that reads the device from the host fails its
    first-call audit (engine-fatal), naming the read."""
    _, tm = pair
    te = ServingEngine(tm, ServingConfig(**SERVE), device="cpu")
    impl = te._decode_jit.fn

    def reads(*args):
        out = impl(*args)
        out.sum().item()  # a host read inside the program
        return out

    monkeypatch.setattr(te._decode_jit, "fn", reads)
    te.add_request(_prompts(False)[0], 4, rid=1)
    with pytest.raises(HostTransferError, match="item"):
        te.run()
