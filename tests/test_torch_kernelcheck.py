"""``paddle_tpu_torch.analysis.kernelcheck``: every kernel entry's launch
plan certified at its main-path and odd shapes (budgets, write-race and
coverage proofs), the plans consistent with the kernels' own Python plans
(``ragged_paged_attention.launch_plan``, ``flash_attention.
forward_tile_schedule``, ``adam_launch_plan``, ``norm_launch_plan``), the
certifier refusing a colliding map, shared memory over the H100's budget,
too many registers and a spill past the frozen bytes, the roofline bank
and the coverage report. On the card, the C launch geometry is held equal
to the plan (the test skips here: the kernels have no CPU mode)."""
import json

import pytest
import torch

from paddle_tpu_torch.analysis import kernelcheck as kc
from paddle_tpu_torch.kernels import dropout as kd
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_layernorm as fl
from paddle_tpu_torch.kernels import fused_optimizer as fo
from paddle_tpu_torch.kernels import global_norm as gn
from paddle_tpu_torch.kernels import ragged_paged_attention as rpa

MODULES = (rpa, fa, fo, fl, kd, gn)


@pytest.mark.parametrize("name", sorted(kc.REGISTRY))
def test_every_plan_certifies(name):
    reports, record = kc.run_kernel(name)
    spec = kc.REGISTRY[name]
    assert len(reports) == len(spec.shapes) + len(spec.odd)
    for r in reports:
        assert r.ok, r.summary() + str(r.errors)
        r.enforce()
        for lc in r.launches:
            assert 0 < lc.threads <= kc.MAX_THREADS
            assert lc.smem <= kc.SMEM_CAP
    assert record["bound_ms"] > 0 and record["bound_by"] in ("bytes",
                                                            "operations")


def test_certs_name_live_entries():
    """PT011's contract: each kernel module's KERNELCHECK_CERTS names
    registry entries, and every entry is claimed by one module."""
    claimed = [c for m in MODULES for c in m.KERNELCHECK_CERTS]
    assert sorted(claimed) == sorted(kc.REGISTRY)


@pytest.mark.parametrize("shape", ["decode", "prefill", "verify", "chunk",
                                   "prefix_tail", "decode_b1"])
def test_ragged_plan_is_the_wrappers(shape):
    s = kc.REGISTRY["ragged_paged_attention"].shapes[shape]
    program, splits, chunk = rpa.launch_plan(
        (s["b"], s["h"], s["s"], s["d"]), torch.bfloat16, s["page_size"],
        s["pps"], 132)
    launches = kc.ragged_plan(**kc._plan_args(s))
    assert launches[0].kernel.startswith(f"ragged_{program}_kernel")
    if program == "split":
        assert launches[0].grid == (splits, s["h"], s["b"])
        assert len(launches) == (2 if splits > 1 else 1)
    assert program == {"decode": "split", "verify": "split",
                       "decode_b1": "split"}.get(shape, "mma")


@pytest.mark.parametrize("label", [c[0] for c in kc._FLASH])
def test_flash_units_follow_the_tile_schedule(label):
    """The forward's work units (``fwd_next_item``) cover exactly the
    query blocks ``forward_tile_schedule`` lists, unit by unit."""
    s = kc.REGISTRY["flash_attention_forward"].shapes[label]
    (lc,) = kc.flash_plan(**s)
    sched = fa.forward_tile_schedule(s["s_q"], s["s_k"], s["causal"])
    n_pairs = lc.work[0] // (s["b"] * s["h"])
    nqb = -(-s["s_q"] // fa.FWD_ITEM_ROWS)
    for unit in range(n_pairs):  # batch-head 0
        want = sorted(b.q0 // fa.FWD_ITEM_ROWS for b in sched
                      if b.unit == unit)
        assert sorted(t % nqb for t in lc.outputs[0].tiles((unit,))) == want


def test_adam_and_norm_plans_follow_theirs():
    sizes = kc._train_sizes()
    assert len(sizes) == 292
    adam = kc.adam_plan(sizes)
    assert len(adam) == len(fo.adam_launch_plan(
        sizes, [torch.bfloat16] * len(sizes)))
    norm = kc.norm_plan(sizes)
    assert len(norm) == len(gn.norm_launch_plan(sizes)) + 1
    assert norm[-1].kernel == "finalize_kernel"


def test_colliding_map_raises_naming_the_kernel():
    bad = kc.Launch("ragged_warp_kernel<float, float, 64>", (4, 1, 1), 64, 0,
                    (kc.Output("out", lambda p: (p[0] // 2,), 2),))
    found = kc._races([bad], 1 << 10)
    assert found and found[0].kind == "race"
    assert "ragged_warp_kernel" in found[0].message and \
        "written twice" in found[0].message
    gap = kc.Launch("k", (2, 1, 1), 32, 0,
                    (kc.Output("out", lambda p: (2 * p[0],), 4),))
    assert kc._races([gap], 1 << 10)[0].kind == "coverage"
    summed = kc.Launch("k", (4, 1, 1), 32, 0,
                       (kc.Output("acc", lambda p: (0,), None,
                                  accumulates=True),))
    assert kc._races([summed], 1 << 10) == []


def test_colliding_plan_fails_certification(monkeypatch):
    real = kc.REGISTRY["layernorm_forward"]

    def colliding(**shape):
        (lc,) = kc.layernorm_plan(**shape)
        return [kc.Launch(lc.kernel, lc.grid, lc.threads, lc.smem, (
            kc.Output("y", lambda p: range(0, 8), shape["rows"]),))]

    monkeypatch.setitem(kc.REGISTRY, "layernorm_forward", kc.KernelSpec(
        real.name, real.source, colliding, real.shapes, real.odd,
        real.bound))
    rep = kc.certify("layernorm_forward", real.shapes["train"])
    with pytest.raises(kc.KernelCheckError, match="ln_fwd_rows_kernel"):
        rep.enforce()


def test_shared_memory_over_budget_raises():
    s = kc.REGISTRY["ragged_paged_attention"].shapes["prefill"]
    (lc,) = kc.ragged_plan(**kc._plan_args(s))
    assert lc.smem == 5 * 64 * (128 + 8) * 2  # the mma program's tiles
    rep = kc.certify("ragged_paged_attention", s,
                     budget=kc.KernelBudget(max_smem_bytes=lc.smem - 1))
    assert [f.kind for f in rep.errors] == ["smem"]
    # static shared memory from ptxas counts against the same cap
    row = (f"void (anonymous namespace)::{lc.kernel}(x)", 164,
           kc.SMEM_CAP - lc.smem + 1, 0, 0)
    rep = kc.certify("ragged_paged_attention", s, ptxas=[row])
    assert [f.kind for f in rep.errors] == ["smem"]


def test_registers_and_frozen_spills():
    frozen = ("void (anonymous namespace)::ragged_split_kernel<float, "
              "float, 192>(float const*)", 72, 0, 8, 8)
    assert kc.spill_budget_findings([frozen]) == []
    over = frozen[:3] + (16, 16)
    assert [f.kind for f in kc.spill_budget_findings([over])] == ["spill"]
    other = ("(anonymous namespace)::fused_adam_multi_kernel((anonymous "
             "namespace)::Table)", 300, 0, 4, 0)
    assert sorted(f.kind for f in kc.spill_budget_findings([other])) == \
        ["registers", "spill"]
    s = kc.REGISTRY["flash_attention_forward"].shapes["train"]
    (lc,) = kc.flash_plan(**s)
    row = (f"void (anonymous namespace)::{lc.kernel}(CUtensorMap_st)",
           176, 0, 0, 0)  # 176 x 384 threads > 65,536 registers
    assert [f.kind for f in kc.certify(
        "flash_attention_forward", s, ptxas=[row]).errors] == ["registers"]


def test_geometry_mismatch_raises():
    s = kc.REGISTRY["layernorm_dx"].shapes["train"]
    (lc,) = kc.layernorm_plan(**s)
    good = [lc.geometry()]
    assert kc.certify("layernorm_dx", s, geometry=good).ok
    bad = [(lc.grid[0] + 1, 1, 1, lc.threads, 0)]
    rep = kc.certify("layernorm_dx", s, geometry=bad)
    assert [f.kind for f in rep.errors] == ["geometry"]


def test_bank_holds_every_entry():
    with open(kc.bank_path()) as fh:
        banked = json.load(fh)
    records = {name: kc.run_kernel(name)[1] for name in kc.REGISTRY}
    assert kc.diff_banked(records, banked) == []
    moved = dict(records["dropout"], bound_ms=1.0)
    found = kc.diff_banked({"dropout": moved}, banked)
    assert [f.kind for f in found] == ["drift"] and "bound_ms" in \
        found[0].message


def test_bound_matches_the_smoke_formulas():
    """The flash training forward's bytes bound (q, k, v, o at bf16 and
    the float32 row statistics over 3.35 TB/s): PERF.md's 0.0202 ms."""
    b = kc.bound("flash_attention_forward",
                 kc.REGISTRY["flash_attention_forward"].shapes["train"])
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.0202, abs=1e-4)
    adam = kc.bound("fused_adam", kc.REGISTRY["fused_adam"].shapes["train"])
    assert adam["bound_ms"] == pytest.approx(2.9661, abs=1e-3)


def test_layernorm_backward_plans_follow_the_wrapper():
    """The backward entries launch what ``fused_layernorm.backward_plan``
    chooses: dx alone one launch of the backward kernel; with dgamma and
    dbeta also the reduction, whose grid covers d in 32-column blocks and
    whose input is one partial row per block of the first launch."""
    dx = kc.REGISTRY["layernorm_dx"].shapes["train"]
    full = kc.REGISTRY["layernorm_backward"].shapes["train"]
    (lc,) = kc.layernorm_plan(**dx)
    bwd, red = kc.layernorm_plan(**full)
    (program, steps), parts = fl.backward_plan(8192, 1024, torch.bfloat16,
                                               True, 132)
    assert (program, steps, parts) == ("rows", 4, 132)
    assert lc.geometry() == bwd.geometry() == (parts, 1, 1,
                                               fl.ROW_WARPS * 32, 0)
    assert bwd.kernel == "ln_bwd_rows_kernel<__nv_bfloat16, " \
        "__nv_bfloat16, 4>"
    assert red.kernel == "ln_bwd_reduce_kernel<__nv_bfloat16>"
    assert red.grid == (1024 // 32, 1, 1)
    assert [o.n_tiles for o in bwd.outputs] == [8192, parts]
    strips = kc.REGISTRY["layernorm_backward"].odd["d8192"]
    assert kc.layernorm_plan(**strips)[0].kernel.startswith(
        "ln_bwd_strips_kernel")
    # the function's bytes: x, dy read, dx written, gamma, mu, rstd read,
    # dgamma, dbeta written (not the kernels' own partials)
    assert kc.bound("layernorm_backward", full)["bytes"] == \
        3 * 8192 * 1024 * 2 + 3 * 1024 * 2 + 8 * 8192


_LN_FWD = kc.REGISTRY["layernorm_forward"]


@pytest.mark.parametrize("label", sorted({**_LN_FWD.shapes, **_LN_FWD.odd}))
def test_layernorm_forward_plan_follows_the_wrapper(label):
    """The forward entry launches what ``fused_layernorm.forward_plan``
    chooses at every certified shape, the serving ones included: one
    launch of the rows program (512 threads, a row to a group of N warps)
    or of the strips program (256 threads, a block each 8 rows)."""
    s = {**_LN_FWD.shapes, **_LN_FWD.odd}[label]
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[
        s.get("dtype", "bf16")]
    (program, arg), grid = fl.forward_plan(s["rows"], s["d"], dt, True, 132)
    (lc,) = kc.layernorm_plan(**s)
    assert lc.kernel.startswith(f"ln_fwd_{program}_kernel<")
    assert lc.kernel.endswith(f", {str(arg).lower()}>")
    threads = fl.ROW_WARPS * 32 if program == "rows" else 256
    assert lc.geometry() == (grid, 1, 1, threads, 0)
    assert [o.n_tiles for o in lc.outputs] == [s["rows"]]


def test_layernorm_forward_takes_the_rows_program_on_every_path():
    """Every serving and training shape (and the two odd-row shapes of
    phase 3) runs the rows program; d 8192 and 99 the strips program."""
    every = {**_LN_FWD.shapes, **_LN_FWD.odd}
    for label in ("train", "prefill-1.3b", "decode-1.3b", "bert",
                  "transformer-base", "rows-1001-d2048", "rows-1001-d1032",
                  "fp32-decode-1.3b"):
        (lc,) = kc.layernorm_plan(**every[label])
        assert lc.kernel.startswith("ln_fwd_rows_kernel<"), label
    (lc,) = kc.layernorm_plan(**every["decode-1.3b"])
    assert lc.kernel == "ln_fwd_rows_kernel<__nv_bfloat16, " \
        "__nv_bfloat16, 8>" and lc.grid == (4, 1, 1)
    for label in ("d8192", "elementwise-d99"):
        (lc,) = kc.layernorm_plan(**every[label])
        assert lc.kernel.startswith("ln_fwd_strips_kernel<"), label


def test_dropout_bounds_follow_the_compiled_count():
    """The forward is bound by the INT32 ALU pipe at DROPOUT_INT_OPS a
    mask element (48.5 in the compiled hash, against the 80 counted from
    the source before it), the backward by its bytes (dy, the bits, dx)."""
    hidden = kc.REGISTRY["dropout"].shapes["hidden"]
    n = hidden["n"]
    fwd = kc.bound("dropout", hidden)
    assert kc.DROPOUT_INT_OPS == 48.5
    assert fwd["bound_by"] == "operations"
    assert fwd["bound_ms"] == pytest.approx(
        n * 48.5 / kc.PEAK_FLOPS["int32"] * 1e3, rel=1e-9)
    assert fwd["bound_ms"] == pytest.approx(0.0243, abs=1e-4)
    bwd = kc.bound("dropout_backward",
                   kc.REGISTRY["dropout_backward"].shapes["hidden"])
    assert bwd["bound_by"] == "bytes" and bwd["bytes"] == 4 * n + n // 8
    assert bwd["bound_ms"] == pytest.approx(0.0103, abs=1e-4)
    (lc,) = kc.dropout_backward_plan(n)
    assert lc.kernel == "dropout_apply_kernel<__nv_bfloat16, false>"
    assert lc.geometry() == kc.dropout_plan(n)[0].geometry()


def test_coverage_report():
    rep = kc.coverage_report()
    assert rep["plain_on_card"] == []
    families = {r["family"] for r in rep["rows"]}
    assert families == set(kc.REGISTRY)
    for r in rep["rows"]:
        if r["family"].startswith("ragged"):
            s = int(r["config"].split("[")[1].split("]")[0]) \
                if "[" in r["config"] and "K+1" not in r["config"] else \
                (5 if "K+1" in r["config"] else 1)
            dt = torch.bfloat16 if " bf16 " in r["config"] \
                else torch.float32
            assert r["program"] == rpa.choose_program(s, 128, dt)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the C launch geometry comes from "
                    "the built kernels, which have no CPU mode")


@pytest.mark.parametrize("name", sorted(kc.REGISTRY))
def test_c_geometry_equals_plan_on_card(name):
    _cuda_or_skip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    spec = kc.REGISTRY[name]
    for shapes in {**spec.shapes, **spec.odd}.values():
        shapes = dict(shapes, sm_count=sms)
        rep = kc.certify(name, shapes,
                         geometry=kc.c_geometry(name, shapes))
        assert rep.ok, rep.summary() + str(rep.errors)
