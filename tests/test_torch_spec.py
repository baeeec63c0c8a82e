"""The port's speculative decoding (``paddle_tpu_torch.serving.spec`` and
the engine's verify step) against the JAX package's.

The proposer and acceptance functions against goldens and against the
JAX functions on random inputs; then the engine as a :class:`Twin` (see
``test_torch_engine_features``): the JAX engine and the port's in
lockstep, page tables, refcounts and every request's tokens equal after
every step, outputs equal token for token — greedy with the n-gram and
the draft proposer at depths 2 and 4 through a pool small enough to
preempt, sampled with both proposers (by swap and by recompute), int8
pools, and the ``verify_fail`` fault. Inside the port, speculation on and
off give the same float32 outputs, and between steps a decoding slot
holds exactly the pages its tokens need.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving.spec import draft_window as jdraft_window
from paddle_tpu.serving.spec import propose_ngram as jpropose_ngram
from paddle_tpu_torch.serving import (InjectedFault, ServingConfig,
                                      ServingEngine, SpecConfig)
from paddle_tpu_torch.serving.spec import (accept_counts, draft_window,
                                           propose_ngram)
from paddle_tpu_torch.text import GPTConfig
from test_torch_engine_features import BASE, SAMPLE, Twin, prompts
from test_torch_gpt import make_pair

SMALL_POOL = dict(BASE, num_pages=14)


def test_accept_counts_golden():
    cand = torch.tensor([[5, 7, 9], [5, 7, 9], [1, 2, 3], [5, 9, 7]])
    target = torch.tensor([[5, 7, 9, 4],   # all accepted
                           [5, 7, 8, 4],   # first two
                           [9, 9, 9, 9],   # none
                           [5, 7, 7, 4]])  # the first mismatch stops it
    assert accept_counts(cand, target).tolist() == [3, 2, 0, 1]


def test_ngram_proposer_golden():
    hist = torch.zeros((3, 16), dtype=torch.int32)
    hist[0, :10] = torch.tensor([9, 5, 7, 1, 2, 3, 4, 9, 5, 7])
    hist[1, :6] = torch.tensor([1, 2, 3, 4, 5, 6])  # no earlier bigram
    hist[2, :4] = torch.tensor([5, 7, 5, 7])  # runs off the known tokens
    got = propose_ngram(hist, torch.tensor([10, 6, 4]), 3, 2, pad_id=0)
    assert got.tolist() == [[1, 2, 3], [0, 0, 0], [5, 7, 0]]


@pytest.mark.parametrize("n,depth", [(1, 2), (2, 4), (3, 3)])
def test_proposers_match_reference_on_random_history(n, depth):
    rng = np.random.default_rng(n + depth)
    hist = rng.integers(0, 4, (6, 40)).astype(np.int32)  # repetitive
    known = rng.integers(1, 41, 6).astype(np.int32)
    want = np.asarray(jpropose_ngram(jnp.asarray(hist), jnp.asarray(known),
                                     depth, n, 0))
    got = propose_ngram(torch.from_numpy(hist), torch.from_numpy(known),
                        depth, n, 0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        draft_window(torch.from_numpy(hist), torch.from_numpy(known),
                     8).numpy(), jdraft_window(hist, known, 8))


@pytest.mark.parametrize("method,depth", [("ngram", 2), ("ngram", 4),
                                          ("draft", 2), ("draft", 4)])
def test_greedy_parity_with_preemption(method, depth):
    tw = Twin(wseed=3, spec=dict(method=method, depth=depth), **SMALL_POOL)
    for p in prompts(21, (9, 14, 7, 11)):
        tw.add(p, 10)
    tw.run()
    c = tw.t.counters
    assert c.preemptions > 0 and c.verify_steps == c.decode_steps > 0
    assert c.spec_proposed == tw.j.metrics.snapshot()[
        "serving_spec_proposed_tokens_total"]
    assert c.spec_accepted == tw.j.metrics.snapshot()[
        "serving_spec_accepted_tokens_total"]
    tw.drained()


@pytest.mark.parametrize("method,mode", [("ngram", "swap"),
                                         ("draft", "recompute")])
def test_sampled_parity(method, mode):
    tw = Twin(wseed=4, spec=dict(method=method, depth=3),
              preemption_mode=mode, **SAMPLE, **SMALL_POOL)
    for p in prompts(22, (9, 14, 7, 11)):
        tw.add(p, 10)
    tw.run()
    assert tw.t.counters.preemptions > 0
    tw.drained()


def test_int8_pools_with_speculation():
    tw = Twin(wseed=5, spec=dict(method="ngram", depth=4), kv_dtype="int8",
              chunk_size=8, **SMALL_POOL)
    for p in prompts(23, (20, 6, 13)):
        tw.add(p, 9)
    tw.run()
    assert tw.t.cache.pools.dtype == torch.int8
    tw.drained()


def test_verify_fail_retires_only_its_request():
    tw = Twin(wseed=6, arms=[], spec=dict(method="ngram", depth=3), **BASE)
    rids = [tw.add(p, 8) for p in prompts(24, (8, 12, 5))]
    tw.arm(point="verify_fail", step=2, rid=rids[1])
    outs = tw.run()
    assert tw.t.status(rids[1]) == "failed"
    assert isinstance(tw.t.request(rids[1]).error, InjectedFault)
    assert set(outs) == {rids[0], rids[2]}
    tw.drained()


def test_repetitive_traffic_accepts_and_equals_plain_decoding():
    """A 5-token vocabulary makes the greedy stream cycle, so the n-gram
    proposer's candidates are accepted: the tokens equal the engine's
    with speculation off, and between steps every decoding slot holds
    exactly the pages its resident tokens need (the reserve for rejected
    candidates given back)."""
    _, tm = make_pair(seed=3, vocab_size=5)
    prompt = np.asarray([1, 2, 3], np.int32)
    outs = {}
    for spec in (None, SpecConfig(method="ngram", depth=4)):
        te = ServingEngine(tm, ServingConfig(spec=spec, **BASE),
                           device="cpu")
        rid = te.add_request(prompt, 24)
        while not te.scheduler.all_done:
            te.step()
            for slot, req in te.scheduler.running.items():
                held = len(te.cache._slot_pages[slot])
                res = req.tokens_resident
                assert te.cache.pages_for(res - 1) <= held \
                    <= te.cache.pages_for(res)
        outs[spec is None] = te.result(rid).tolist()
        if spec is not None:
            assert te.counters.spec_accepted > 0
        assert te.cache.allocator.pages_in_use == 0
    assert outs[True] == outs[False]


def test_spec_validation():
    _, tm = make_pair()
    with pytest.raises(ValueError, match="draft"):
        ServingEngine(tm, ServingConfig(spec=SpecConfig(method="draft")),
                      device="cpu")
    with pytest.raises(ValueError, match="vocab_size"):
        ServingEngine(tm, ServingConfig(spec=SpecConfig(
            method="draft", draft=GPTConfig(vocab_size=50))), device="cpu")
    with pytest.raises(ValueError, match="depth"):
        ServingEngine(tm, ServingConfig(spec=SpecConfig(depth=0)),
                      device="cpu")
    _, draft = make_pair(seed=1)
    with pytest.raises(ValueError, match="draft_model"):
        ServingEngine(tm, ServingConfig(), device="cpu", draft_model=draft)
