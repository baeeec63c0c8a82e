"""The port's GPT (``paddle_tpu_torch.text``) against the JAX package's
(``paddle_tpu.text.gpt``) at a small size: vocab 97, hidden 64, 2 layers,
4 heads.

Both models get the same weights, made with numpy from a seed and carried
across by ``state_dict_from_jax``. Logits agree within float32 atol 1e-4
(two matmul/softmax/LayerNorm implementations, summed in other orders);
paged pools within atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.text.gpt import GPTConfig as JGPTConfig
from paddle_tpu.text.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.text import (GPTConfig, GPTForCausalLM, PagedBatch,
                                   state_dict_from_jax)
from paddle_tpu_torch.text.convert import expected_shapes

LOGITS_ATOL = 1e-4
POOL_ATOL = 1e-5
SMALL = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=64)


def random_params(cfg, seed):
    """Numpy weights for every parameter, scaled so greedy argmax gaps are
    wide: weights N(0, 0.3), biases N(0, 0.1), LayerNorm scale near 1."""
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


def make_pair(seed=0, **overrides):
    """(JAX model, port model on the CPU), both holding one set of random
    weights."""
    kw = dict(SMALL, **overrides)
    jm = JGPT(JGPTConfig(**kw))
    jm.eval()
    params = random_params(GPTConfig(**kw), seed)
    for name, t in jm.functional_state()[0].items():
        t._value = jnp.asarray(params[name])
    tm = GPTForCausalLM(GPTConfig(**kw), device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, tm.cfg))
    return jm, tm


def test_converter_maps_names_and_shapes():
    jm = JGPT(JGPTConfig(**SMALL))
    params = {k: np.asarray(t._value)
              for k, t in jm.functional_state()[0].items()}
    cfg = GPTConfig(**SMALL)
    sd = state_dict_from_jax(params, cfg)
    tm = GPTForCausalLM(cfg, device="cpu")
    assert set(sd) == set(tm.state_dict())
    for name, t in tm.state_dict().items():
        assert sd[name].shape == t.shape, name
    qkv = "gpt.blocks.1.attn.qkv_proj.weight"
    assert tuple(sd[qkv].shape) == (3 * 64, 64)  # [out, in]
    np.testing.assert_array_equal(sd[qkv].numpy(), params[qkv].T)
    np.testing.assert_array_equal(sd["gpt.wte.weight"].numpy(),
                                  params["gpt.wte.weight"])
    with pytest.raises(KeyError):
        state_dict_from_jax({k: v for k, v in params.items()
                             if k != "gpt.ln_f.bias"}, cfg)
    bad = dict(params, **{qkv: params[qkv].T})
    with pytest.raises(ValueError):
        state_dict_from_jax(bad, cfg)


def test_converter_carries_an_untied_head():
    jm = JGPT(JGPTConfig(**SMALL, tie_word_embeddings=False))
    params = {k: np.asarray(t._value)
              for k, t in jm.functional_state()[0].items()}
    cfg = GPTConfig(**SMALL, tie_word_embeddings=False)
    sd = state_dict_from_jax(params, cfg)
    assert tuple(sd["lm_head.weight"].shape) == (97, 64)
    np.testing.assert_array_equal(sd["lm_head.weight"].numpy(),
                                  params["lm_head.weight"].T)
    GPTForCausalLM(cfg, device="cpu").load_state_dict(sd)


@pytest.mark.parametrize("tied", [True, False])
def test_no_cache_logits_match_reference(tied):
    jm, tm = make_pair(seed=1, tie_word_embeddings=tied)
    ids = np.random.default_rng(2).integers(0, 97, (2, 11)).astype(np.int32)
    want = np.asarray(jm(Tensor(jnp.asarray(ids)))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    assert got.shape == want.shape == (2, 11, 97)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def test_paged_prefill_and_decode_match_reference():
    """A batched paged prefill (row 0 cold, row 1 entering at a cached
    prefix of 3, row 2 an inactive slot) and 3 decode steps through both
    models: equal pools and logits after every call."""
    jm, tm = make_pair(seed=3)
    rng = np.random.default_rng(4)
    num_pages, page_size, heads, head_dim = 13, 4, 4, 16
    shape = (num_pages, page_size, heads, head_dim)
    jpools = [{"k_pool": jnp.asarray(rng.standard_normal(shape, np.float32)),
               "v_pool": jnp.asarray(rng.standard_normal(shape, np.float32))}
              for _ in range(2)]
    tpools = torch.stack([torch.stack([torch.from_numpy(np.array(p[n]))
                                       for n in ("k_pool", "v_pool")])
                          for p in jpools])
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    ctx = np.array([0, 3, 0], np.int32)
    ids = rng.integers(0, 97, (3, 8)).astype(np.int32)
    valid = np.zeros((3, 8), bool)
    valid[0, :7] = valid[1, :5] = True
    last = [6, 4]
    for _ in range(4):
        caches = [dict(p, page_table=jnp.asarray(table),
                       ctx_lens=jnp.asarray(ctx), valid=jnp.asarray(valid))
                  for p in jpools]
        jlogits, new = jm(Tensor(jnp.asarray(ids)), caches=caches)
        jlogits = np.asarray(jlogits._value)
        jpools = [{n: c[n] for n in ("k_pool", "v_pool")} for c in new]
        with torch.no_grad():
            tlogits = tm(torch.from_numpy(ids).long(), paged=PagedBatch(
                tpools, torch.from_numpy(table), torch.from_numpy(ctx),
                torch.from_numpy(valid))).numpy()
        np.testing.assert_allclose(tlogits, jlogits, atol=LOGITS_ATOL, rtol=0)
        for layer, p in enumerate(jpools):
            for i, n in enumerate(("k_pool", "v_pool")):
                # page 0 is the null page: several dead writes land on its
                # slot 0 in one call and which one wins is unspecified in
                # both packages, so it is left out
                np.testing.assert_allclose(
                    tpools[layer, i, 1:].numpy(), np.asarray(p[n])[1:],
                    atol=POOL_ATOL, rtol=0)
        # next decode step: each live row feeds back its greedy token
        toks = jlogits[np.arange(2), last].argmax(-1)
        ctx = ctx + valid.sum(1).astype(np.int32)
        ids = np.zeros((3, 1), np.int32)
        ids[:2, 0] = toks
        valid = np.array([[True], [True], [False]])
        last = [0, 0]


def test_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(GPTConfig(**SMALL))

