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

from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.utils import monitor
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving.engine import _LATER
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


@pytest.mark.parametrize("field", sorted(_LATER))
def test_unported_config_fields_raise(field):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        ServingConfig(**{field: _other_value(_LATER[field][0])})
    ServingConfig(**{field: _LATER[field][0]})  # the default is accepted


def test_config_field_names_equal_reference():
    assert [f.name for f in dataclasses.fields(ServingConfig)] == \
        [f.name for f in dataclasses.fields(JServingConfig)]
    served = {f.name for f in dataclasses.fields(ServingConfig)} - set(_LATER)
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
