"""The port's serving engine against the JAX package's: the same request
stream, through ``paddle_tpu.serving.ServingEngine`` (tracing off) and
``paddle_tpu_torch.serving.ServingEngine(device="cpu")``, on one set of
weights (numpy, from a seed).

The pool is small enough to force recompute preemption, and prompts share
page-aligned prefixes, so prefix caching hits, copies on write and
evicts. Greedy outputs must be equal token for token, with prefix caching
on and off, and the preemption and prefix-hit counts must be equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu.obs import TenantSLO as JTenantSLO
from paddle_tpu.obs import WatchdogConfig as JWatchdogConfig
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.slo import SLOConfig as JSLOConfig
from paddle_tpu.utils import monitor
from paddle_tpu_torch.analysis import RetraceError, single_host_topology
from paddle_tpu_torch.obs import TenantSLO, WatchdogConfig
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving.slo import SLOConfig
from test_torch_gpt import make_pair

SERVE = dict(max_batch=2, num_pages=11, page_size=4, max_prompt_len=16)


def _requests(seed=5):
    """Seven (prompt, max_new_tokens) pairs; four share an 8-token prefix
    (two pages), one repeats a whole earlier prompt (a full hit)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 97, 8)
    reqs = []
    for i in range(6):
        tail = rng.integers(1, 97, 2 + i)
        prompt = np.concatenate([shared, tail]) if i % 2 == 0 \
            else rng.integers(1, 97, 6 + i)
        reqs.append((prompt.astype(np.int32), 10 + i))
    reqs.append((reqs[0][0].copy(), 9))
    return reqs


def _serve(engine, reqs):
    rids = [engine.add_request(p, n) for p, n in reqs]
    out = engine.run()
    return [out[r].tolist() for r in rids]


@pytest.mark.parametrize("prefix_caching", [True, False])
def test_greedy_outputs_match_reference(prefix_caching):
    jm, tm = make_pair(seed=6)
    reqs = _requests()
    stats = ("prefix_tokens_saved", "tokens_total", "decode_steps",
             "prefills_total")
    je = JServingEngine(jm, JServingConfig(
        enable_tracing=False, enable_prefix_caching=prefix_caching, **SERVE))
    before = {k: monitor.stat_get("serving_" + k, 0) for k in stats}
    want = _serve(je, reqs)
    ref = {k: monitor.stat_get("serving_" + k, 0) - before[k] for k in stats}

    te = ServingEngine(tm, ServingConfig(
        enable_prefix_caching=prefix_caching, **SERVE), device="cpu")
    got = _serve(te, reqs)

    assert got == want
    assert [len(o) for o in got] == [len(p) + n for p, n in reqs]
    c = te.counters
    assert c.preemptions == je.scheduler.preemption_count > 0
    assert c.prefix_hit_tokens == ref["prefix_tokens_saved"]
    assert (c.prefix_hit_tokens > 0) == prefix_caching
    # recompute preemption replays: more prefills and tokens than requests
    assert (c.tokens, c.decode_steps, c.prefills) == (
        ref["tokens_total"], ref["decode_steps"], ref["prefills_total"])
    assert c.prefills == len(reqs) + c.preemptions
    te.cache.check_invariants()
    assert te.cache.allocator.pages_in_use == 0


def test_engine_defaults_to_the_card(monkeypatch):
    _, tm = make_pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tm, ServingConfig(**SERVE))


def _other_value(default):
    """A value other than a field's accepted default."""
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return default + 1
    return object()


#: the last reference fields the port refused (NotImplementedError) until
#: the analysis contracts came (ROADMAP Queue 1 item 11)
_AUDIT_FIELDS = ("debug_checks", "mesh_topology")


@pytest.mark.parametrize("field", sorted(_AUDIT_FIELDS))
def test_unported_config_fields_raise(field):
    """Both fields are served now: the engine serves a request with each,
    and each raises where its contract is broken — under debug_checks a
    decode call one slot wider is refused as a retrace naming ``ctx``; a
    mesh_topology that is no ``MeshTopology`` is refused at once."""
    _, tm = make_pair()
    value = {"debug_checks": True,
             "mesh_topology": single_host_topology(1)}[field]
    te = ServingEngine(tm, ServingConfig(**{field: value}, **SERVE),
                       device="cpu")
    rid = te.add_request(np.arange(1, 6), 4)
    assert te.run()[rid].shape == (9,)
    if field == "debug_checks":
        args = list(te._decode_args())
        args[3] = torch.zeros(SERVE["max_batch"] + 1, dtype=torch.int32)
        with pytest.raises(RetraceError, match="ctx"):
            te._decode_jit(*args)
    else:
        with pytest.raises(TypeError, match="MeshTopology"):
            ServingConfig(mesh_topology=_other_value(None))


def _obs_cases(jax: bool) -> dict:
    """field -> (a non-default value the reference serves, a value the
    reference refuses with ValueError or None, extra config fields), in
    one package's own types."""
    W = JWatchdogConfig if jax else WatchdogConfig
    T = JTenantSLO if jax else TenantSLO
    S = JSLOConfig if jax else SLOConfig
    return {
        "enable_tracing": (False, None, {}),
        "trace_capacity": (4, 0, {}),
        "decode_mark_every": (2, 0, {}),
        "timeline_capacity": (3, 0, {}),
        "enable_watchdogs": (False, None, {}),
        "watchdog": (W(stall_steps=2), W(stall_steps=0), {}),
        "peak_flops_per_s": (1e12, -1.0, {}),
        "peak_hbm_bytes_per_s": (1e11, -1.0, {}),
        "flight_record_path": ("dump.json", None, {}),
        "flight_record_steps": (2, 0, {}),
        "tenants": ({"batch": T(1.0, 1.0)}, {"batch": (1.0, 1.0)}, {}),
        "slo": (S(tpot_p99_s=1.0), S(tpot_p99_s=1.0),
                {"chunk_size": 4}),
    }


@pytest.mark.parametrize("field", sorted(_obs_cases(False)))
def test_observability_config_fields_served(field, tmp_path, monkeypatch):
    """The observability fields left ``_LATER`` when the layer was
    ported: each is served at a non-default value (the engine serves a
    request with it), and a value the reference refuses raises the
    reference's ValueError (for ``slo``: without ``chunk_size``)."""
    monkeypatch.chdir(tmp_path)
    jm, tm = make_pair()
    value, bad, extra = _obs_cases(False)[field]
    te = ServingEngine(tm, ServingConfig(**{field: value}, **extra, **SERVE),
                       device="cpu")
    rid = te.add_request(np.arange(1, 6), 4)
    assert te.run()[rid].shape == (9,)
    assert getattr(te.config, field) == value
    assert (te.trace(rid) is None) == (field == "enable_tracing")
    if bad is None:
        return
    jbad = _obs_cases(True)[field][1]
    with pytest.raises(ValueError) as want:
        JServingEngine(jm, JServingConfig(**{field: jbad}, **SERVE))
    with pytest.raises(ValueError) as got:
        ServingEngine(tm, ServingConfig(**{field: bad}, **SERVE),
                      device="cpu")
    if field.startswith("peak_"):  # the message quotes each default peak
        assert str(got.value).split(",")[0] == str(want.value).split(",")[0]
    else:
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(JServingConfig)])
def test_config_defaults_equal_reference(field):
    assert getattr(ServingConfig(), field) == \
        getattr(JServingConfig(), field)


def test_config_field_names_equal_reference():
    assert [f.name for f in dataclasses.fields(ServingConfig)] == \
        [f.name for f in dataclasses.fields(JServingConfig)]
    served = {f.name for f in dataclasses.fields(ServingConfig)}
    assert {"do_sample", "temperature", "top_k", "top_p", "seed",
            "max_waiting", "shed_policy", "preemption_mode", "chunk_size",
            "spec"} <= served


def test_add_request_validation():
    _, tm = make_pair()
    te = ServingEngine(tm, ServingConfig(**SERVE), device="cpu")
    with pytest.raises(ValueError):
        te.add_request(np.arange(17), 4)  # longer than max_prompt_len
    with pytest.raises(ValueError):
        te.add_request(np.array([], np.int32), 4)
    with pytest.raises(ValueError):
        te.add_request(np.arange(1, 5), 0)
    with pytest.raises(ValueError):
        te.add_request(np.arange(1, 16), 60)  # past max_seq_len
