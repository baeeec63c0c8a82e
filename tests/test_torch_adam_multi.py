"""Fused Adam's multi-tensor launch: the plan and the CPU path.

``fused_optimizer.adam_launch_plan`` cuts an optimizer step's tensors into
the kernel's launches (each launch's table of tensors is a kernel
parameter) and ``adam_chunk_ranges`` a tensor into the chunks a block
takes. Both are functions of the sizes alone, so they are held here, on
the training path's 292 parameter shapes (``gpt3-350m``, as
``chip_smoke.train_param_shapes`` builds them) and on odd sizes. The CPU
path of ``fused_adam_update_many`` (the plain version per tensor) is held
against the JAX package's ``fused_adam_update(..., interpret=True)`` per
tensor, within the tolerance ``test_torch_optimizer.py`` states for one
tensor: rtol 1e-6, atol 1e-7 (the compiled JAX kernel may contract
``b*m + (1-b)*g`` to one multiply-add, which rounds once where the plain
version rounds twice). Decay is 1: the JAX kernel has none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.fused_optimizer import \
    fused_adam_update as jax_fused_adam
from paddle_tpu_torch.kernels import fused_optimizer as fo
from paddle_tpu_torch.text import GPTForCausalLM, gpt_config

RTOL, ATOL = 1e-6, 1e-7
ODD_SIZES = [1, 3, 5, 1023, 4097]
PARAM_BYTES = [fo.PARAM_BYTES, 4096]


def _train_sizes():
    model = GPTForCausalLM(gpt_config("gpt3-350m", max_seq_len=1024),
                           device="meta")
    return [p.numel() for _, p in model.named_parameters()]


def _dtypes(n):
    return [torch.bfloat16 if i % 2 else torch.float32 for i in range(n)]


def test_the_training_step_has_292_tensors():
    sizes = _train_sizes()
    assert len(sizes) == 292
    assert sum(sizes) == 354_871_296
    assert sum(n <= 4096 for n in sizes) == 194


@pytest.mark.parametrize("param_bytes", PARAM_BYTES,
                         ids=["cuda-12.1", "4-kib"])
def test_every_tensor_lands_in_one_launch_in_order(param_bytes):
    sizes = _train_sizes() + ODD_SIZES
    plan = fo.adam_launch_plan(sizes, _dtypes(len(sizes)), param_bytes)
    assert plan[0][0] == 0 and plan[-1][1] == len(sizes)
    for a, b in zip(plan, plan[1:]):
        assert a[1] == b[0]
    assert [i for start, stop in plan for i in range(start, stop)] == \
        list(range(len(sizes)))


@pytest.mark.parametrize("param_bytes", PARAM_BYTES,
                         ids=["cuda-12.1", "4-kib"])
def test_each_table_fits_its_parameter_limit(param_bytes):
    sizes = _train_sizes()
    plan = fo.adam_launch_plan(sizes, _dtypes(len(sizes)), param_bytes)
    for start, stop in plan:
        table = (stop - start) * fo.ADAM_ENTRY_BYTES
        assert 0 < stop - start <= fo.adam_table_capacity(param_bytes)
        assert table + fo.ADAM_FIXED_BYTES <= param_bytes


@pytest.mark.parametrize("param_bytes,launches", [(fo.PARAM_BYTES, 1),
                                                  (4096, 5)],
                         ids=["cuda-12.1", "4-kib"])
def test_launch_count_is_the_documented_one(param_bytes, launches):
    sizes = _train_sizes()
    # the docstring: ceil(tensors / capacity); 545 and 67 tensors a table
    assert fo.adam_table_capacity(fo.PARAM_BYTES) == 545
    assert fo.adam_table_capacity(4096) == 67
    plan = fo.adam_launch_plan(sizes, _dtypes(len(sizes)), param_bytes)
    assert len(plan) == launches
    for count, want in ((545, 1), (546, 2), (1, 1)):
        assert len(fo.adam_launch_plan([7] * count, _dtypes(count))) == want


@pytest.mark.parametrize("n", ODD_SIZES + [16384, 16385, 1_000_003,
                                           50304 * 1024],
                         ids=lambda n: f"n{n}")
def test_chunks_cover_each_element_once(n):
    ranges = fo.adam_chunk_ranges(n)
    assert fo.ADAM_CHUNK % 4 == 0
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1  # no gap, no overlap
    for b, e in ranges:
        assert b % 4 == 0  # 16-byte aligned for float32
        assert 0 < e - b <= fo.ADAM_CHUNK
    covered = np.zeros(n, np.int64)
    for b, e in ranges:
        covered[b:e] += 1
    assert (covered == 1).all()


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="at least one element"):
        fo.adam_launch_plan([4, 0], _dtypes(2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fo.adam_launch_plan([4], [torch.float16])
    with pytest.raises(ValueError, match="gradient dtypes"):
        fo.adam_launch_plan([4, 4], _dtypes(1))


def test_many_on_cpu_matches_jax_kernel_interpret():
    rng = np.random.default_rng(13)
    lr, bc1, bc2 = 1e-3, 0.271, 0.00299
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    groups, inputs = [], []
    for i, n in enumerate(ODD_SIZES):
        g_dtype = _dtypes(len(ODD_SIZES))[i]
        p, g, m = (rng.standard_normal(n).astype(np.float32)
                   for _ in range(3))
        v = rng.random(n).astype(np.float32)
        tg = torch.from_numpy(g).to(g_dtype)
        inputs.append((p, tg.float().numpy(), m, v))
        groups.append((torch.from_numpy(p.copy()), tg,
                       torch.from_numpy(m.copy()), torch.from_numpy(v.copy()),
                       1.0, None))
    launches, tensors, calls = fo.launches, fo.tensors, fo.reference_calls
    fo.fused_adam_update_many(groups, lr, bc1, bc2, **hyper)
    # CPU tensors: the plain version, once per tensor; no kernel launch
    assert (fo.launches, fo.tensors) == (launches, tensors)
    assert fo.reference_calls == calls + len(ODD_SIZES)
    for (tp, _, tm, tv, _, _), arrays in zip(groups, inputs):
        want = jax_fused_adam(*(jnp.asarray(a) for a in arrays),
                              jnp.float32(lr), jnp.float32(bc1),
                              jnp.float32(bc2), interpret=True, **hyper)
        for name, got, w in zip("pmv", (tp, tm, tv), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{name} n={tp.numel()}")


def _bert_sizes():
    """BERT-base's parameters in optimizer order (``BertForPretraining``
    at ``BertConfig()``'s widths, built under ``LazyGuard``: nothing is
    allocated)."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.text import BertConfig, BertForPretraining

    with T.LazyGuard():
        model = BertForPretraining(BertConfig())
    return [p.numel() for p in model.parameters()]


def test_bert_base_has_205_tensors_as_the_reference():
    import paddle_tpu as J
    from paddle_tpu.text.bert import BertConfig, BertForPretraining

    sizes = _bert_sizes()
    with J.LazyGuard():
        ref = BertForPretraining(BertConfig())
    ref_sizes = [int(np.prod(p.shape)) for p in ref.parameters()]
    assert sizes == ref_sizes
    assert len(sizes) == 205 and sum(sizes) == 110_075_906
    # the tied word embeddings, the largest tensor, and many 768-vectors
    assert max(sizes) == 30522 * 768
    assert sum(n == 768 for n in sizes) == 114


@pytest.mark.parametrize("param_bytes,launches", [(fo.PARAM_BYTES, 1),
                                                  (4096, 4)],
                         ids=["cuda-12.1", "4-kib"])
def test_bert_base_plan_lands_every_tensor_once(param_bytes, launches):
    sizes = _bert_sizes()
    dtypes = [torch.bfloat16] * len(sizes)  # phase 11: bf16 gradients
    plan = fo.adam_launch_plan(sizes, dtypes, param_bytes)
    assert len(plan) == launches
    assert [i for start, stop in plan for i in range(start, stop)] == \
        list(range(len(sizes)))
    for start, stop in plan:
        assert (stop - start) * fo.ADAM_ENTRY_BYTES + fo.ADAM_FIXED_BYTES \
            <= param_bytes
    for n in set(sizes):
        ranges = fo.adam_chunk_ranges(n)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
