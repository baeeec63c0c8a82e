"""The port's sampler and decode loop (``paddle_tpu_torch.text.generation``)
against the JAX package's on the same logits, keys and weights.

``sample_logits`` on ``[4, 97]`` float32 logits for each filter (the
temperature alone, top-k, top-p, both) under one key: the sampled ids are
equal. The filters compare float32 values (the k-th largest, the nucleus
cutoff) that both frameworks compute from the same inputs in the same
order, and the draw is the Gumbel-max of bit-equal uniforms, so ids can
only differ at a tie, which these inputs do not hold.

``generate`` on the small GPT of ``test_torch_gpt``: greedy and sampled,
with an eos that finishes some rows early so their padding is compared
too; the outputs are equal token for token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.text.generation import generate as jgenerate
from paddle_tpu.text.generation import sample_logits as jsample
from paddle_tpu_torch import random as R
from paddle_tpu_torch.text.generation import sample_logits
from test_torch_gpt import make_pair

FILTERS = {"temperature": dict(temperature=0.7),
           "top_k": dict(top_k=10),
           "top_p": dict(top_p=0.8),
           "top_k+top_p": dict(temperature=1.3, top_k=20, top_p=0.9)}


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("seed", [0, 3])
def test_sample_logits_matches_reference(name, seed):
    rng = np.random.default_rng(seed + 40)
    logits = (2.0 * rng.standard_normal((4, 97))).astype(np.float32)
    kw = FILTERS[name]
    want = np.asarray(jsample(jnp.asarray(logits), jax.random.key(seed), **kw))
    got = sample_logits(torch.from_numpy(logits), R.key(seed, "cpu"), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    # per-row keys, as the serving engine samples
    keys = jax.vmap(lambda r: jax.random.fold_in(jax.random.key(seed), r))(
        jnp.arange(4))
    want = np.asarray(jax.vmap(lambda lg, k: jsample(lg[None], k, **kw)[0])(
        jnp.asarray(logits), keys))
    tkeys = R.fold_in(R.key(seed, "cpu").expand(4, 2), torch.arange(4))
    np.testing.assert_array_equal(
        sample_logits(torch.from_numpy(logits), tkeys, **kw).numpy(), want)


@pytest.mark.parametrize("case", [
    dict(), dict(do_sample=True, temperature=0.9, top_k=20, top_p=0.9,
                 seed=4),
    dict(do_sample=True, seed=1)], ids=["greedy", "sampled-filtered",
                                        "sampled"])
def test_generate_matches_reference(case):
    jm, tm = make_pair(seed=2)
    rng = np.random.default_rng(9)
    ids = rng.integers(1, 97, (3, 7)).astype(np.int32)
    plain = np.asarray(jgenerate(jm, Tensor(jnp.asarray(ids)),
                                 max_new_tokens=12, **case)._value)
    # an eos that one row emits early: the rows after it are padded
    eos = int(plain[0, 7 + 3])
    want = np.asarray(jgenerate(jm, Tensor(jnp.asarray(ids)),
                                max_new_tokens=12, eos_token_id=eos,
                                pad_token_id=0, **case)._value)
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=12,
                      eos_token_id=eos, pad_token_id=0, **case)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, 7 + 4:] == 0).all()
    got_plain = tm.generate(torch.from_numpy(ids), max_new_tokens=12, **case)
    np.testing.assert_array_equal(got_plain.numpy(), plain)
