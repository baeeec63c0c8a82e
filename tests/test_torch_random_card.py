"""The port's threefry (``paddle_tpu_torch.random``) and sampler on their
own: the Threefry-2x32 (20 rounds) known-answer vectors of its
published specification, and on the card the same bits, uniforms and
samples from CUDA tensors as from CPU tensors.

This file imports no JAX, so it runs on the card too:
``python -m pytest --noconftest tests/test_torch_random_card.py -q``.
The CUDA cases skip here with the reason.
"""
import pytest
import torch

from paddle_tpu_torch import random as R
from paddle_tpu_torch.text.generation import sample_logits

# (key words, counter words, expected output words): the Random123
# known-answer vectors for threefry2x32 with 20 rounds
KAT = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
        (0x6B200159, 0x99BA4EFE)),
       ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
        (0x1CB996FC, 0xBB002BE7)),
       ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
        (0xC4923A9C, 0x483DF7A0))]


@pytest.mark.parametrize("key,count,want", KAT)
def test_threefry2x32_known_answers(key, count, want):
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    got = R.threefry2x32(t(key[0]), t(key[1]), t(count[0]), t(count[1]))
    assert tuple(int(x) for x in got) == want


def test_key_of_a_64_bit_seed_is_its_two_words():
    assert R.key(2**40 + 7, "cpu").tolist() == [2**8, 7]
    assert R.key(5, "cpu").tolist() == [0, 5]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card's integer and "
                    "sampling arithmetic with the CPU's")


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_cuda_bits_and_samples_equal_cpu(seed):
    _cuda_or_skip()
    keys = {d: R.fold_in(R.fold_in(R.key(seed, d).expand(8, 2),
                                   torch.arange(8, device=d)),
                         torch.arange(8, device=d) * 3)
            for d in ("cpu", "cuda")}
    assert torch.equal(keys["cuda"].cpu(), keys["cpu"])
    for fn in (lambda k: R.random_bits(k, (50304,)),
               lambda k: R.uniform(k, (50304,))):
        assert torch.equal(fn(keys["cuda"]).cpu(), fn(keys["cpu"]))
    gen = torch.Generator().manual_seed(seed % 97)
    logits = 3.0 * torch.randn((8, 50304), generator=gen)
    kw = dict(temperature=0.8, top_k=50, top_p=0.95)
    want = sample_logits(logits, keys["cpu"], **kw)
    got = sample_logits(logits.cuda(), keys["cuda"], **kw).cpu()
    assert torch.equal(got, want)
