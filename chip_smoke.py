"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. card — the GPU's name and power limit (``nvidia-smi``) and versions;
2. build — compiles every CUDA kernel of the port from ``csrc/`` (one
   ``nvcc`` per source, all at once) into ``build/paddle_tpu_torch/``:
   ragged paged attention, flash attention and fused Adam;
3. kernels — holds each kernel against its plain PyTorch version on the
   card on the same inputs: the ragged kernel at the serving path's
   shapes (decode, cold prefill, prefix-tail prefill, verify; head_dim 64
   and 128; float32 and bfloat16; page tables with inactive null-page
   rows); flash attention forward and backward (o, dq, dk, dv) at the
   training shape [8, 16, 1024, 64] causal, [2, 16, 512, 128] causal,
   [2, 4, 384, 64] non-causal, tails that are no multiple of the 64-row
   tile ([2, 8, 1000, 64] causal; s_q 200 / s_k 333 at head_dim 128),
   causal s_q 256 / s_k 640 (splash's offset) and [1, 16, 4096, 64]
   causal (splash's route), in float32 (against the plain version) and
   bfloat16 (kernel and plain version each against the plain version in
   float32 on the upcast inputs: the kernel's error at most twice the
   plain one's); fused Adam over 1,000,003 elements with the gradient in
   float32 and in bfloat16 (bit for bit). Then it times each kernel, its
   plain version and a library yardstick at the main paths' shapes,
   beside the least time the card could take (``bound_ms``);
4. fp32 check — ``gpt3-1.3b`` at full width in float32 (random weights
   from a seed) serves 2 requests; every greedy token must equal the
   argmax of the model's no-cache forward over the same sequence (a
   reference path whose attention is the flash kernel, held against its
   plain version in phase 3), except past a position whose reference
   top-2 logits are within 1e-3 (a numerical tie);
5. serve — the main path: ``gpt3-1.3b`` in bfloat16 serves 16 requests
   (prompts 32-512 tokens, four sharing a 256-token prefix, 64 new tokens
   each) through ``ServingEngine``; every kernel's launch counter is set
   to 0 just before and read just after, and each must equal its launches
   on that path (the plain version's count must stay 0);
6. profile — a short window of decode steps under ``torch.profiler``:
   device time by kernel and the device's busy share;
7. training fp32 check — ``gpt3-350m`` widths with 2 layers, batch 2,
   seq 256, in float32 with TF32 off, and a copy of it on the CPU (where
   the plain versions run) take 2 AdamW steps each: the losses, every
   gradient of step 1 and every parameter after step 2 agree within the
   stated tolerances, and at most a share of 1e-4 of the parameters are
   off by more than 1e-6;
8. train — the second main path: ``bench.py``'s ``350M-b8-off`` rung at
   full width (``gpt3-350m``: hidden 1024, 24 layers, 16 heads, vocab
   50304; batch 8, seq 1024, no remat; bf16 with float32 masters;
   ``loss_chunk`` 2048) through ``train.build_train_step``: 2 warm-up
   steps, then 10 timed steps on one seeded batch. The counters are set
   to 0 just before the 10 steps and read just after: flash forward 24,
   flash backward 24 and fused Adam 292 launches a step, every plain
   version 0. The loss must be finite and lower at the last step than at
   the first;
9. training profile — one training step under ``torch.profiler``: device
   time by kernel and by layer, the device's busy share, and the fused
   head + cross-entropy timed alone.

It prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``. With no CUDA device it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.nn import functional as F

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_optimizer as fo
from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
from paddle_tpu_torch.kernels.paged_attention import paged_gather, ragged_mask
from paddle_tpu_torch.nn.functional import linear_cross_entropy
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.text import GPTForCausalLM, gpt_config
from paddle_tpu_torch.train import BASE_RUNGS, build_train_step, flops_per_token

SEED = 0
PRESET = "gpt3-1.3b"
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),   # summation order
       torch.bfloat16: dict(atol=2e-2, rtol=0.0)}   # plain rounds probs
TIE_GAP = 1e-3
L2_FLUSH_BYTES = 64 << 20  # above the 50 MB L2, so each timed launch is cold
# flash kernel vs plain, float32: summation order only
FLASH_TOL_FP32 = dict(atol=1e-4, rtol=1e-4)
# bfloat16: kernel and plain version round at different points (the plain
# version rounds the probabilities and dP to bf16), so each is held
# against the plain version in float32 on the same inputs upcast, and the
# kernel's max abs error there may be at most this multiple of the plain
# bf16 version's own, plus a small floor
FLASH_BF16_ERR_RATIO, FLASH_BF16_ERR_FLOOR = 2.0, 1e-3
FLASH_CASES = [  # (label, b, h, s_q, s_k, d, causal)
    ("train", 8, 16, 1024, 1024, 64, True),
    ("causal-d128", 2, 16, 512, 512, 128, True),
    ("noncausal", 2, 4, 384, 384, 64, False),
    ("causal-tail", 2, 8, 1000, 1000, 64, True),      # 1000 = 15 x 64 + 40
    ("rect-tail-d128", 1, 8, 200, 333, 128, True),
    ("splash-offset", 2, 16, 256, 640, 128, True),
    ("splash-route", 1, 16, 4096, 4096, 64, True),
]
TRAIN_RUNG = BASE_RUNGS[0]  # bench.py's 350M-b8-off
TRAIN_WARMUP, TRAIN_STEPS = 2, 10


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 1
def card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0].strip()
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return line


# ---------------------------------------------------------------- phase 2
def build() -> None:
    t0 = time.perf_counter()
    secs = _build.build(_build.KERNELS)
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 3
def attention_case(gen, *, b, s, ctx, d, dtype, h=16, page_size=16, pps=64,
                   inactive_rows=1):
    """Random pools and q on the card; a page table of distinct random
    pages per row, the last ``inactive_rows`` rows all null page with
    ctx 0 (inactive slots). ``ctx`` is an int or a per-row list."""
    num_pages = 1 + b * pps
    dev = "cuda"
    k_pool = torch.randn((num_pages, page_size, h, d), generator=gen,
                         device=dev).to(dtype)
    v_pool = torch.randn((num_pages, page_size, h, d), generator=gen,
                         device=dev).to(dtype)
    q = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    table = perm.view(b, pps).to(torch.int32)
    ctx_lens = torch.as_tensor(np.broadcast_to(ctx, (b,)).copy(),
                               dtype=torch.int32, device=dev)
    if inactive_rows:
        table[-inactive_rows:] = 0
        ctx_lens[-inactive_rows:] = 0
    return q, k_pool, v_pool, table, ctx_lens.contiguous()


def bound(q, k_pool, table, ctx_lens):
    """(ms, "bytes" | "operations"): the least time the card could take —
    each input byte this call's data needs read once (the visible K/V
    prefix of every row, q, the table) and the output written once, over
    the HBM rate, against the score and PV operations over the peak rate
    of the dtype."""
    b, h, s, d = q.shape
    item = q.element_size()
    total = table.shape[1] * k_pool.shape[1]
    ctx = ctx_lens.long().cpu()
    kv_positions = int(torch.clamp(ctx + s, max=total).sum())
    visible = int(sum(torch.clamp(ctx + t + 1, max=total).sum()
                      for t in range(s)))
    nbytes = (2 * kv_positions * h * d * item + 2 * q.numel() * item
              + table.numel() * 4 + ctx_lens.numel() * 4)
    flops = 4 * h * d * visible
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, flush, iters=20, warmup=3) -> float:
    """Mean CUDA-event time of one call, each launch after an L2 flush."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(z) for a, z in pairs) / iters


def check_kernels(gen) -> dict:
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    shapes = [("decode", dict(b=8, s=1, ctx=None)),
              ("prefill", dict(b=2, s=512, ctx=0)),
              ("prefix_tail", dict(b=2, s=64, ctx=200)),
              ("verify", dict(b=8, s=5, ctx=None))]
    for name, shp in shapes:
        for d in (64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                ctx = shp["ctx"]
                if ctx is None:  # decode/verify: random lengths per row
                    ctx = torch.randint(0, 64 * 16 - shp["s"], (shp["b"],),
                                        generator=gen, device="cuda").cpu()
                    ctx = ctx.numpy()
                args = attention_case(gen, b=shp["b"], s=shp["s"], ctx=ctx,
                                      d=d, dtype=dtype)
                got = rpa.ragged_paged_attention(*args)
                torch.cuda.synchronize()
                want = rpa.ragged_paged_attention_reference(*args)
                err = (got.float() - want.float()).abs().max().item()
                torch.testing.assert_close(got.float(), want.float(),
                                           **TOL[dtype])
                errs[dtype] = max(errs[dtype], err)
                log(f"  kernel vs plain {name:11s} d={d:3d} "
                    f"{str(dtype):14s} max_abs_err {err:.3e} "
                    f"(atol {TOL[dtype]['atol']}, rtol {TOL[dtype]['rtol']})")
    return errs


def time_kernels(gen) -> dict:
    """Kernel, plain and library times at the main path's shapes: the
    bfloat16 decode batch (8 rows, contexts over the served range) and
    the 512-token cold prefill bucket."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    ctx = torch.randint(32, 576, (8,), generator=gen, device="cuda").cpu()
    cases = {
        "decode": attention_case(gen, b=8, s=1, ctx=ctx.numpy(), d=128,
                                 dtype=torch.bfloat16, inactive_rows=0),
        "prefill": attention_case(gen, b=1, s=512, ctx=0, d=128,
                                  dtype=torch.bfloat16, inactive_rows=0),
    }
    out = {}
    for name, args in cases.items():
        q, k_pool, v_pool, table, ctx_lens = args
        k_all, v_all = paged_gather(k_pool, table), paged_gather(v_pool, table)
        mask = ragged_mask(ctx_lens, k_all.shape[2], q.shape[2])
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k_all, v_all, attn_mask=mask)
        kernel = lambda: rpa.ragged_paged_attention(*args)  # noqa: E731
        plain = lambda: rpa.ragged_paged_attention_reference(*args)  # noqa
        # plain, kernel, kernel, plain: the two pairs bracket drift
        t_plain = time_ms(plain, flush)
        t_kernel = time_ms(kernel, flush)
        t_kernel = min(t_kernel, time_ms(kernel, flush))
        t_plain = min(t_plain, time_ms(plain, flush))
        t_lib = time_ms(lib, flush)
        b_ms, b_by = bound(q, k_pool, table, ctx_lens)
        shape = (f"b={q.shape[0]} h={q.shape[1]} s={q.shape[2]} "
                 f"d={q.shape[3]} bf16 ctx={ctx_lens.tolist()} "
                 f"page_size={k_pool.shape[1]} pages_per_seq={table.shape[1]}")
        out[name] = {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": t_lib, "shape": shape}
        log(f"  time {name}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms,"
            f" library (sdpa over the gathered, masked K/V) {t_lib:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}) [{shape}]")
    return out


def flash_inputs(gen, b, h, s_q, s_k, d, dtype):
    """q, k, v and an output gradient, standard normal, on the card."""
    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return mk(b, h, s_q, d), mk(b, h, s_k, d), mk(b, h, s_k, d), \
        mk(b, h, s_q, d)


def flash_outputs(fn, q, k, v, do, causal) -> list:
    """[o, dq, dk, dv] of ``fn`` under autograd on copies of q, k, v."""
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*x, causal=causal)
    out.backward(do)
    return [out.detach()] + [t.grad for t in x]


def check_flash(gen) -> dict:
    """Flash forward and backward against the plain version (autograd
    through ``sdpa_reference``) at every FLASH_CASES shape. float32: the
    kernel against the plain version on the same inputs. bfloat16: the
    kernel and the plain version, each against the plain version in
    float32 on the same inputs upcast; the kernel's error may be at most
    FLASH_BF16_ERR_RATIO times the plain version's plus
    FLASH_BF16_ERR_FLOOR. Every case is printed before any failure is
    raised. Returns, per dtype and fwd/bwd, the max abs error against the
    plain version on the same inputs, and for bf16 also the kernel's and
    the plain version's against float32."""
    errs = {}
    failures = []
    for label, b, h, s_q, s_k, d, causal in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_inputs(gen, b, h, s_q, s_k, d, dtype)
            got = flash_outputs(fa.flash_attention, q, k, v, do, causal)
            plain = flash_outputs(fa.flash_attention_reference, q, k, v, do,
                                  causal)
            exact = (flash_outputs(fa.flash_attention_reference,
                                   *(t.float() for t in (q, k, v, do)),
                                   causal) if dtype == torch.bfloat16
                     else None)
            torch.cuda.synchronize()
            line = []
            for i, name in enumerate(("o", "dq", "dk", "dv")):
                part = "fwd" if name == "o" else "bwd"
                diff = (got[i].float() - plain[i].float()).abs()
                err = diff.max().item()
                errs[dtype, part] = max(errs.get((dtype, part), 0.0), err)
                if dtype == torch.float32:
                    tol = FLASH_TOL_FP32
                    if bool((diff > tol["atol"] + tol["rtol"]
                             * plain[i].float().abs()).any()):
                        failures.append(f"{label} {dtype} {name}")
                    line.append(f"{name} {err:.3e}")
                    continue
                e_kernel = (got[i].float() - exact[i]).abs().max().item()
                e_plain = (plain[i].float() - exact[i]).abs().max().item()
                limit = FLASH_BF16_ERR_RATIO * e_plain + FLASH_BF16_ERR_FLOOR
                for key, val in (("kernel_vs_fp32", e_kernel),
                                 ("plain_vs_fp32", e_plain)):
                    errs[dtype, part, key] = max(
                        errs.get((dtype, part, key), 0.0), val)
                if not e_kernel <= limit:
                    failures.append(f"{label} {dtype} {name}")
                line.append(f"{name} {e_kernel:.3e} (plain {e_plain:.3e}, "
                            f"limit {limit:.3e}; vs plain bf16 {err:.3e})")
            del got, plain, exact
            if dtype == torch.float32:
                how = (f"max_abs_err vs plain {', '.join(line)} (atol "
                       f"{FLASH_TOL_FP32['atol']}, rtol "
                       f"{FLASH_TOL_FP32['rtol']})")
            else:
                how = (f"max_abs_err vs fp32 plain on the upcast inputs "
                       f"{', '.join(line)} (limit = "
                       f"{FLASH_BF16_ERR_RATIO} x plain + "
                       f"{FLASH_BF16_ERR_FLOOR})")
            log(f"  flash {label:14s} [{b},{h},{s_q},{s_k},{d}] "
                f"{'causal' if causal else 'full':6s} {str(dtype):14s} {how}")
    if failures:
        raise RuntimeError(f"flash kernel outside its limit: {failures}")
    return errs


def check_adam(gen) -> dict:
    """Fused Adam against its plain version on the same buffers of
    1,000,003 elements (a tail past the last 4-element group), with the
    AdamW decay and the bf16 parameter copy, the gradient in float32 and
    in bfloat16: equal bit for bit. Returns the max abs error."""
    n = 1_000_003
    err = 0.0
    for g_dtype in (torch.float32, torch.bfloat16):
        p = torch.randn(n, generator=gen, device="cuda")
        g = torch.randn(n, generator=gen, device="cuda").to(g_dtype)
        m = torch.randn(n, generator=gen, device="cuda")
        v = torch.rand(n, generator=gen, device="cuda")
        runs = [[t.clone() for t in (p, m, v)]
                + [torch.empty(n, dtype=torch.bfloat16, device="cuda")]
                for _ in range(2)]
        hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, decay=1 - 1e-6)
        for fn, (pp, mm, vv, out) in zip(
                (fo.fused_adam_update, fo.fused_adam_update_reference), runs):
            fn(pp, g, mm, vv, 1e-4, 0.19, 0.001999, p_out=out, **hyper)
        torch.cuda.synchronize()
        for name, got, want in zip(("p", "m", "v", "p_bf16"), *runs):
            e = (got.float() - want.float()).abs().max().item()
            err = max(err, e)
            if not torch.equal(got, want):
                raise RuntimeError(f"fused adam {name} (g {g_dtype}) differs "
                                   f"from the plain version by up to {e:.3e}")
        log(f"  adam vs plain n={n} g {str(g_dtype):14s} p, m, v, p_bf16 "
            f"equal bit for bit (max_abs_err {err:.1e}; tolerance 0)")
    return err


def flash_bound(b, h, s_q, s_k, d, item, causal, backward):
    """(ms, "bytes" | "operations") for one flash call: the (query, key)
    pairs these shapes make visible (causal bottom-right; a row that sees
    no key attends every key), 4·d operations per pair forward and 10·d
    backward (five products), against q, k, v, o (and do, dq, dk, dv
    backward) read or written once, plus the float32 row statistics."""
    if causal:
        i = np.arange(s_q)
        seen = np.clip(i + s_k - s_q + 1, 0, s_k)
        pairs = int(np.where(i + s_k - s_q < 0, s_k, seen).sum())
    else:
        pairs = s_q * s_k
    pairs *= b * h
    if backward:  # read q, o, do, k, v, lse; write dq, dk, dv
        flops = 10 * d * pairs
        nbytes = (4 * s_q + 4 * s_k) * d * b * h * item + 4 * b * h * s_q
    else:         # read q, k, v; write o, lse
        flops = 4 * d * pairs
        nbytes = (2 * s_q + 2 * s_k) * d * b * h * item + 4 * b * h * s_q
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.bfloat16 if item == 2 else torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_flash(gen) -> dict:
    """Forward and backward at the training shape (bf16, causal): the
    kernel, the plain version and ``scaled_dot_product_attention`` (the
    library yardstick, never called by the port), each timed alone; the
    backward rows time only the backward (autograd over a kept graph)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    _, b, h, s, _, d, _ = FLASH_CASES[0]
    q, k, v, do = flash_inputs(gen, b, h, s, s, d, torch.bfloat16)
    o, lse = fa.flash_attention_forward(q, k, v, causal=True)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out_plain = fa.flash_attention_reference(*xs, causal=True)
    out_lib = F.scaled_dot_product_attention(*xs, is_causal=True)

    def plain_fwd():
        with torch.no_grad():
            fa.flash_attention_reference(q, k, v, causal=True)

    cases = {
        "fwd": (lambda: fa.flash_attention_forward(q, k, v, causal=True),
                plain_fwd,
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True)),
        "bwd": (lambda: fa.flash_attention_backward(q, k, v, o, lse, do,
                                                    causal=True),
                lambda: torch.autograd.grad(out_plain, xs, do,
                                            retain_graph=True),
                lambda: torch.autograd.grad(out_lib, xs, do,
                                            retain_graph=True)),
    }
    shape = f"[{b}, {h}, {s}, {d}] bf16 causal"
    out = {}
    for name, (kernel, plain, lib) in cases.items():
        t_plain = time_ms(plain, flush)
        t_kernel = time_ms(kernel, flush)
        t_kernel = min(t_kernel, time_ms(kernel, flush))
        t_plain = min(t_plain, time_ms(plain, flush))
        t_lib = time_ms(lib, flush)
        b_ms, b_by = flash_bound(b, h, s, s, d, 2, True, name == "bwd")
        out[name] = {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": t_lib, "shape": shape}
        log(f"  time flash {name}: kernel {t_kernel:.4f} ms, plain "
            f"{t_plain:.4f} ms, library (scaled_dot_product_attention) "
            f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{shape}]")
    t_lib_fb = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*xs, is_causal=True), xs, do), flush)
    t_fb = time_ms(lambda: fa.flash_attention_backward(
        q, k, v, *fa.flash_attention_forward(q, k, v, causal=True), do,
        causal=True), flush)
    out["fwd_bwd"] = {"ms": t_fb, "library_ms": t_lib_fb}
    log(f"  time flash fwd+bwd: kernels {t_fb:.4f} ms, library "
        f"{t_lib_fb:.4f} ms [{shape}]")
    return out


def train_param_shapes() -> list:
    """The shapes of the training path's parameters, in optimizer order
    (a model on the meta device allocates nothing)."""
    cfg = gpt_config("gpt3-350m", max_seq_len=TRAIN_RUNG.get("seq", 1024))
    model = GPTForCausalLM(cfg, device="meta")
    return [tuple(p.shape) for _, p in model.named_parameters()]


def time_adam(gen) -> dict:
    """One optimizer step's fused Adam launches over buffers of the
    training path's 292 parameter shapes (float32 master, moments, bf16
    gradient and parameter copy), against the plain version over the same
    buffers and ``torch.optim.AdamW(fused=True)`` (the library yardstick,
    never called by the port; it reads float32 gradients and writes no
    bf16 copy)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    shapes = train_param_shapes()
    n = sum(int(np.prod(s)) for s in shapes)
    bufs = []
    for shp in shapes:
        p = torch.randn(shp, generator=gen, device="cuda") * 0.02
        bufs.append((p, (torch.randn(shp, generator=gen, device="cuda")
                         * 1e-3).to(torch.bfloat16),
                     torch.zeros_like(p), torch.zeros_like(p),
                     torch.empty(shp, dtype=torch.bfloat16, device="cuda")))
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    decay = 1 - 1e-6
    groups = [(p, g, m, v, decay, out) for p, g, m, v, out in bufs]

    def kernel():  # one host call, one launch per tensor: as the optimizer
        fo.fused_adam_update_many(groups, 1e-4, 0.1, 0.001, **hyper)

    def plain():
        for p, g, m, v, out in bufs:
            fo.fused_adam_update_reference(p, g, m, v, 1e-4, 0.1, 0.001,
                                           decay=decay, p_out=out, **hyper)

    lib_params = [torch.nn.Parameter(p.clone()) for p, *_ in bufs]
    for lp, (_, g, *_rest) in zip(lib_params, bufs):
        lp.grad = g.float()
    lib_opt = torch.optim.AdamW(lib_params, lr=1e-4, weight_decay=0.01,
                                fused=True)
    t_plain = time_ms(plain, flush, iters=5)
    t_kernel = time_ms(kernel, flush, iters=10)
    t_kernel = min(t_kernel, time_ms(kernel, flush, iters=10))
    t_plain = min(t_plain, time_ms(plain, flush, iters=5))
    t_lib = time_ms(lib_opt.step, flush, iters=10)
    nbytes = n * (3 * 4 + 2 + 3 * 4 + 2)  # p, m, v, g in; p, m, v, bf16 p out
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 10 * n / PEAK_FLOPS[torch.float32]
    b_ms = max(t_bytes, t_ops) * 1e3
    b_by = "bytes" if t_bytes >= t_ops else "operations"
    shape = f"{len(shapes)} tensors, {n} elements (one training step)"
    log(f"  time adam: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, "
        f"library (torch.optim.AdamW fused) {t_lib:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {nbytes / 1e9:.3f} GB) [{shape}]")
    return {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": t_lib, "shape": shape}


# ---------------------------------------------------------------- phase 4
def fp32_check(model) -> None:
    cfg = ServingConfig(max_batch=2, num_pages=1 + 2 * 64, page_size=16,
                        max_prompt_len=512)
    engine = ServingEngine(model, cfg)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (100, 300)]
    rids = [engine.add_request(p, 16) for p in prompts]
    out = engine.run()
    compared = 0
    for rid, prompt in zip(rids, prompts):
        seq = out[rid]
        if seq.shape != (len(prompt) + 16,):
            raise RuntimeError(f"request {rid}: output shape {seq.shape}")
        with torch.no_grad():
            logits = model(torch.as_tensor(seq, device="cuda").long()[None])[0]
        if not torch.isfinite(logits).all():
            raise RuntimeError("non-finite logits in the reference forward")
        for i in range(16):
            row = logits[len(prompt) - 1 + i]
            top2 = torch.topk(row, 2).values
            gap = (top2[0] - top2[1]).item()
            if gap < TIE_GAP:
                log(f"  fp32 request {rid}: reference top-2 within {gap:.2e} "
                    f"at generated token {i}; comparison stops there")
                break
            want = int(row.argmax())
            if int(seq[len(prompt) + i]) != want:
                raise RuntimeError(
                    f"request {rid} token {i}: served {seq[len(prompt) + i]}"
                    f", reference argmax {want} (top-2 gap {gap:.3e})")
            compared += 1
    log(f"  fp32 check: {compared} of 32 greedy tokens equal the no-cache "
        f"reference argmax")


# ---------------------------------------------------------------- phase 5
def serve_requests(vocab: int):
    """16 prompts of 32-512 tokens; requests 0, 8, 12 and 15 share a
    256-token prefix (0 is admitted first; the others after slots free,
    so they find its pages in the prefix cache)."""
    rng = np.random.default_rng(SEED + 2)
    shared = rng.integers(0, vocab, 256)
    prompts = []
    for i in range(16):
        if i in (0, 8, 12, 15):
            tail = rng.integers(0, vocab, int(rng.integers(16, 257)))
            prompts.append(np.concatenate([shared, tail]).astype(np.int32))
        else:
            n = int(rng.integers(32, 513))
            prompts.append(rng.integers(0, vocab, n).astype(np.int32))
    return prompts


def serve(model, card_line: str) -> dict:
    cfg = ServingConfig(max_batch=8, num_pages=1 + 8 * 64, page_size=16,
                        max_prompt_len=512)
    engine = ServingEngine(model, cfg)
    prompts = serve_requests(model.cfg.vocab_size)
    rids = [engine.add_request(p, 64) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()          # every kernel's count, just before the path
    t0 = time.perf_counter()
    out = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = rpa.launches, rpa.reference_calls
    c = engine.counters
    peak = torch.cuda.max_memory_allocated()
    for rid, prompt in zip(rids, prompts):
        seq = out[rid]
        if seq.shape != (len(prompt) + 64,) or \
                not ((seq >= 0) & (seq < model.cfg.vocab_size)).all():
            raise RuntimeError(f"request {rid}: bad output {seq.shape}")
    if c.prefix_hit_tokens <= 0:
        raise RuntimeError("no prefix-cache hit on the shared 256-token "
                           "prefix")
    want = model.cfg.num_layers * (c.prefills + c.decode_steps)
    if launches != want:
        raise RuntimeError(f"ragged kernel launched {launches} times, the "
                           f"path made {want} attention calls")
    if plain_calls:
        raise RuntimeError(f"the plain attention ran {plain_calls} times on "
                           f"the CUDA serving path")
    generated = 64 * len(prompts)
    log(f"  serve {PRESET} bf16: {len(prompts)} requests, {generated} tokens "
        f"in {wall:.3f} s = {generated / wall:.1f} tok/s; "
        f"{c.prefills} prefills, mean {1e3 * c.prefill_seconds / c.prefills:.3f}"
        f" ms; {c.decode_steps} decode steps, mean "
        f"{1e3 * c.decode_seconds / c.decode_steps:.3f} ms; prefix-hit tokens "
        f"{c.prefix_hit_tokens}; preemptions {c.preemptions}; peak memory "
        f"{peak / 2**30:.3f} GiB; ragged kernel launches {launches} "
        f"= {model.cfg.num_layers} x ({c.prefills} + {c.decode_steps}) "
        f"[{card_line}]")
    return {"launches": launches}


# ---------------------------------------------------------------- phase 6
def profile_decode(model) -> None:
    """Device time by kernel over 8 steady decode steps of a full batch,
    and the device's busy share of those steps' wall time (measured once
    without and once under the profiler)."""
    engine = ServingEngine(model, ServingConfig(
        max_batch=8, num_pages=1 + 8 * 64, page_size=16, max_prompt_len=512))
    rng = np.random.default_rng(SEED + 3)
    for _ in range(8):
        engine.add_request(rng.integers(0, model.cfg.vocab_size, 256), 40)
    for _ in range(3):  # admit + prefill all, then settle
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        engine.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / 8
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            engine.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / 8
    # device-side events only: an aten op's row repeats its kernels' time
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / 8
    if not busy_ms:
        log("  profile: the profiler recorded no device time (not measured)")
        return
    log(f"  profile: decode step of batch 8 (256-token prompts): "
        f"{plain_ms:.3f} ms wall unprofiled, {prof_ms:.3f} ms profiled; "
        f"device busy {busy_ms:.3f} ms a step = "
        f"{100 * busy_ms / plain_ms:.1f}% of the unprofiled step "
        f"(idle {100 - 100 * busy_ms / plain_ms:.1f}%)")
    for dev_us, key, count in rows[:10]:
        log(f"    {100 * dev_us / 1e3 / 8 / busy_ms:5.1f}%  "
            f"{dev_us / 1e3 / 8:7.3f} ms/step  x{count // 8:<4d} {key[:80]}")


# ---------------------------------------------------------------- phase 7
# training fp32 check: GPU step vs the CPU copy (plain versions). float32
# summation orders differ, so gradients are held relative to each
# tensor's largest entry. An Adam step moves a weight by up to about
# lr = 1e-4 whatever its gradient's size, in the gradient's direction
# over sqrt(v) + eps: where a gradient is within a few eps (1e-8) of
# zero, the summation order can flip that move, so a parameter may be
# off by up to 2 lr after two steps; but only a small share of entries
# may be off by more than PARAM_NEAR (2.4e-5 of them measured on an H100),
# which a fault that shifts every update would exceed
TRAIN_CHECK_TOL = dict(loss=1e-4, grad_rel=1e-3, param=2e-4,
                       param_off_share=1e-4)
PARAM_NEAR = 1e-6


def train_fp32_check() -> None:
    rung = dict(TRAIN_RUNG, layers=2, batch=2, seq=256)
    gpu = build_train_step(rung, dtype=torch.float32)
    cpu = build_train_step(rung, device="cpu", dtype=torch.float32)
    cpu["model"].load_state_dict(
        {k: t.cpu() for k, t in gpu["model"].state_dict().items()})
    rng = np.random.default_rng(SEED + 4)
    vocab, shape = gpu["cfg"].vocab_size, (2, rung["batch"], rung["seq"])
    ids_all = torch.from_numpy(rng.integers(0, vocab, shape))
    labels_all = torch.from_numpy(rng.integers(0, vocab, shape))
    worst = dict(loss=0.0, grad_rel=0.0, param=0.0)
    for step in range(2):
        losses = []
        for built, dev in ((gpu, "cuda"), (cpu, "cpu")):
            loss = built["model"](ids_all[step].to(dev),
                                  labels=labels_all[step].to(dev))
            loss.backward()
            losses.append(loss.item())
        worst["loss"] = max(worst["loss"], abs(losses[0] - losses[1]))
        log(f"  train fp32 step {step + 1}: loss card {losses[0]:.6f}, cpu "
            f"{losses[1]:.6f}")
        if step == 0:
            cpu_params = dict(cpu["model"].named_parameters())
            for name, p in gpu["model"].named_parameters():
                want = cpu_params[name].grad
                rel = ((p.grad.cpu() - want).abs().max()
                       / want.abs().max().clamp(min=1e-30)).item()
                worst["grad_rel"] = max(worst["grad_rel"], rel)
        for built in (gpu, cpu):
            built["opt"].step()
            built["opt"].zero_grad()
    cpu_params = dict(cpu["model"].named_parameters())
    off, total = 0, 0
    for name, p in gpu["model"].named_parameters():
        diff = (p.detach().cpu() - cpu_params[name].detach()).abs()
        worst["param"] = max(worst["param"], diff.max().item())
        off += int((diff > PARAM_NEAR).sum())
        total += diff.numel()
    worst["param_off_share"] = off / total
    log(f"  train fp32 check ({rung['layers']} layers, batch {rung['batch']},"
        f" seq {rung['seq']}, hidden {rung['hidden']}, vocab {vocab}): loss "
        f"diff {worst['loss']:.3e} (tol {TRAIN_CHECK_TOL['loss']}), step-1 "
        f"gradients max diff / max |grad| {worst['grad_rel']:.3e} (tol "
        f"{TRAIN_CHECK_TOL['grad_rel']}), parameters after step 2 max diff "
        f"{worst['param']:.3e} (tol {TRAIN_CHECK_TOL['param']}); {off} of "
        f"{total} entries off by more than {PARAM_NEAR}: share "
        f"{worst['param_off_share']:.3e} (tol "
        f"{TRAIN_CHECK_TOL['param_off_share']})")
    bad = [k for k, v in worst.items() if not v <= TRAIN_CHECK_TOL[k]]
    if bad:
        raise RuntimeError(f"training on the card disagrees with the CPU "
                           f"plain path: {bad}")


# ---------------------------------------------------------------- phase 8
def reset_counters() -> None:
    rpa.launches = rpa.reference_calls = 0
    fa.fwd_launches = fa.bwd_launches = fa.reference_calls = 0
    fo.launches = fo.reference_calls = 0


def train(card_line: str) -> dict:
    built = build_train_step(TRAIN_RUNG)
    cfg, step_fn = built["cfg"], built["train_step"]
    b, s = TRAIN_RUNG["batch"], TRAIN_RUNG.get("seq", 1024)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    losses = [step_fn(ids, labels) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()          # every kernel's count, just before the path
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(step_fn(ids, labels))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa.fwd_launches, "flash_bwd": fa.bwd_launches,
                "adam": fo.launches}
    plain = {"flash": fa.reference_calls, "adam": fo.reference_calls,
             "ragged": rpa.reference_calls}
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training losses {losses}: not finite, or the "
                           f"last is not below the first")
    n_tensors = len(list(built["model"].parameters()))
    want = {"flash_fwd": cfg.num_layers * TRAIN_STEPS,
            "flash_bwd": cfg.num_layers * TRAIN_STEPS,
            "adam": n_tensors * TRAIN_STEPS}
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} over {TRAIN_STEPS} "
                           f"steps; the path makes {want}")
    if any(plain.values()):
        raise RuntimeError(f"plain versions ran on the CUDA training path: "
                           f"{plain}")
    ms = wall * 1e3 / TRAIN_STEPS
    tok_s = b * s / (wall / TRAIN_STEPS)
    fpt = flops_per_token(cfg, built["n_params"], s)
    mfu = tok_s * fpt / PEAK_FLOPS[torch.bfloat16]
    log(f"  train {TRAIN_RUNG['tag']} ({built['n_params']} parameters, bf16 "
        f"+ fp32 masters, batch {b}, seq {s}, loss_chunk "
        f"{cfg.loss_chunk_size}): {TRAIN_STEPS} steps in {wall:.3f} s = "
        f"{ms:.3f} ms/step, {tok_s:.1f} tokens/s, MFU {100 * mfu:.2f}% "
        f"of 989 TFLOP/s ({fpt / 1e9:.3f} GFLOP/token); peak memory "
        f"{peak / 2**30:.3f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"launches per step: flash fwd {launches['flash_fwd'] // TRAIN_STEPS}"
        f", flash bwd {launches['flash_bwd'] // TRAIN_STEPS}, adam "
        f"{launches['adam'] // TRAIN_STEPS}; plain calls 0 [{card_line}]")
    return {"launches": launches, "built": built, "ids": ids,
            "labels": labels}


# ---------------------------------------------------------------- phase 9
def kernel_layer(name: str) -> str:
    """The layer a device kernel belongs to, from its name."""
    low = name.lower()
    if "flash_fwd" in low:
        return "attention forward (flash kernel)"
    if "flash_bwd" in low:
        return "attention backward (flash kernels)"
    if "fused_adam" in low:
        return "optimizer (fused Adam kernel)"
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "sm90_",
                              "splitk")):
        return "matrix products (weights and LM head, cuBLAS)"
    return "other (LayerNorm, GELU, CE softmax, elementwise, copies)"


def profile_train(trained) -> None:
    step_fn, ids, labels = (trained["built"]["train_step"], trained["ids"],
                            trained["labels"])
    model = trained["built"]["model"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_fn(ids, labels)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step_fn(ids, labels)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if not busy_ms:
        log("  training profile: the profiler recorded no device time (not "
            "measured)")
        return
    log(f"  training profile: one step {plain_ms:.3f} ms wall unprofiled, "
        f"{prof_ms:.3f} ms profiled; device busy {busy_ms:.3f} ms = "
        f"{100 * busy_ms / plain_ms:.1f}% of the unprofiled step (idle "
        f"{100 - 100 * busy_ms / plain_ms:.1f}%)")
    layers = {}
    for dev_us, key, count in rows:
        layer = layers.setdefault(kernel_layer(key), [0.0, 0])
        layer[0] += dev_us / 1e3
        layer[1] += count
    for name, (dev_ms, count) in sorted(layers.items(),
                                        key=lambda kv: -kv[1][0]):
        log(f"    layer {100 * dev_ms / busy_ms:5.1f}%  {dev_ms:8.3f} ms  "
            f"x{count:<5d} {name}")
    for dev_us, key, count in rows[:12]:
        log(f"    {100 * dev_us / 1e3 / busy_ms:5.1f}%  {dev_us / 1e3:8.3f} "
            f"ms  x{count:<5d} {key[:80]}")
    # the fused head + cross-entropy alone, forward and backward
    cfg = trained["built"]["cfg"]
    h = torch.randn((*ids.shape, cfg.hidden_size), device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    w = model.gpt.wte.weight.detach().clone().requires_grad_()

    def head_ce():
        linear_cross_entropy(h, w, labels, transpose_y=True,
                             chunk_size=cfg.loss_chunk_size).backward()

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    t_head = time_ms(head_ce, flush, iters=5)
    log(f"    head + CE alone (linear_cross_entropy forward + backward, "
        f"[{ids.numel()}, {cfg.hidden_size}] x [{cfg.vocab_size}, "
        f"{cfg.hidden_size}], chunk {cfg.loss_chunk_size}): {t_head:.3f} ms")


def bf16_vs_fp32(flash_errs, part) -> dict:
    """The bf16 kernel's and plain version's max abs errors against the
    float32 plain version, for the kernels line."""
    return {f"bf16_{key}": flash_errs[torch.bfloat16, part, key]
            for key in ("kernel_vs_fp32", "plain_vs_fp32")}


def kernel_entry(name, module, replaces, launches, err, err32, t,
                 card_line, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": module.SOURCE,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "max_abs_err_fp32": err32, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "card": card_line, **extra}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    log("== 1 card")
    card_line = card()
    log("== 2 build")
    build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    log("== 3 kernels against their plain versions")
    errs = check_kernels(gen)
    flash_errs = check_flash(gen)
    adam_err = check_adam(gen)
    times = time_kernels(gen)
    flash_times = time_flash(gen)
    adam_times = time_adam(gen)
    torch.cuda.empty_cache()
    log("== 4 fp32 check")
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    model = GPTForCausalLM(gpt_config(PRESET), dtype=torch.float32,
                           generator=torch.Generator("cuda").manual_seed(SEED))
    fp32_check(model)
    log("== 5 serve")
    model = model.to(torch.bfloat16)
    torch.cuda.empty_cache()
    served = serve(model, card_line)
    log("== 6 profile")
    profile_decode(model)
    del model  # the serving model's memory goes back before training
    torch.cuda.empty_cache()
    log("== 7 training fp32 check")
    train_fp32_check()
    torch.cuda.empty_cache()
    log("== 8 train")
    trained = train(card_line)
    log("== 9 training profile")
    profile_train(trained)
    dec = times["decode"]
    tl = trained["launches"]
    kernels = [
        {"name": "ragged_paged_attention", "route": "cuda",
         "source": rpa.SOURCE, "replaces": rpa.REPLACES,
         "launches": served["launches"],
         "max_abs_err": errs[torch.bfloat16],
         "max_abs_err_fp32": errs[torch.float32],
         "ms": dec["ms"], "plain_ms": dec["plain_ms"],
         "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
         "library_ms": dec["library_ms"], "shape": dec["shape"],
         "prefill": times["prefill"], "card": card_line},
        kernel_entry("flash_attention_forward", fa, fa.REPLACES,
                     tl["flash_fwd"], flash_errs[torch.bfloat16, "fwd"],
                     flash_errs[torch.float32, "fwd"], flash_times["fwd"],
                     card_line, replaces_splash=fa.REPLACES_SPLASH,
                     **bf16_vs_fp32(flash_errs, "fwd")),
        kernel_entry("flash_attention_backward", fa, fa.REPLACES,
                     tl["flash_bwd"], flash_errs[torch.bfloat16, "bwd"],
                     flash_errs[torch.float32, "bwd"], flash_times["bwd"],
                     card_line, replaces_splash=fa.REPLACES_SPLASH,
                     fwd_bwd=flash_times["fwd_bwd"],
                     **bf16_vs_fp32(flash_errs, "bwd")),
        kernel_entry("fused_adam", fo, fo.REPLACES, tl["adam"], adam_err,
                     adam_err, adam_times, card_line),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
