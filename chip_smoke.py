"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. card — the GPU's name and power limit (``nvidia-smi``) and versions;
2. build — compiles every CUDA kernel of the port from ``csrc/`` (one
   ``nvcc`` per source, all at once) into ``build/paddle_tpu_torch/``;
3. kernels — holds each kernel against its plain PyTorch version on the
   card at the serving path's shapes (decode, cold prefill, prefix-tail
   prefill, verify; head_dim 64 and 128; float32 and bfloat16; page
   tables with inactive null-page rows), and times the kernel, its plain
   version and a library yardstick at the main path's decode and prefill
   shapes, beside the least time the card could take (``bound_ms``);
4. fp32 check — ``gpt3-1.3b`` at full width in float32 (random weights
   from a seed) serves 2 requests; every greedy token must equal the
   argmax of the model's no-cache forward over the same sequence (a
   reference path through the plain attention), except past a position
   whose reference top-2 logits are within 1e-3 (a numerical tie);
5. serve — the main path: ``gpt3-1.3b`` in bfloat16 serves 16 requests
   (prompts 32-512 tokens, four sharing a 256-token prefix, 64 new tokens
   each) through ``ServingEngine``; every kernel's launch counter is set
   to 0 just before and read just after, and each must equal its launches
   on that path (the plain version's count must stay 0);
6. profile — a short window of decode steps under ``torch.profiler``:
   device time by kernel and the device's busy share.

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
from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
from paddle_tpu_torch.kernels.paged_attention import paged_gather, ragged_mask
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.text import GPTForCausalLM, gpt_config

SEED = 0
PRESET = "gpt3-1.3b"
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),   # summation order
       torch.bfloat16: dict(atol=2e-2, rtol=0.0)}   # plain rounds probs
TIE_GAP = 1e-3
L2_FLUSH_BYTES = 64 << 20  # above the 50 MB L2, so each timed launch is cold


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
    rpa.launches = 0          # every kernel's count, just before the path
    rpa.reference_calls = 0
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
    times = time_kernels(gen)
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
    dec = times["decode"]
    kernel = {"name": "ragged_paged_attention", "route": "cuda",
              "source": rpa.SOURCE, "replaces": rpa.REPLACES,
              "launches": served["launches"],
              "max_abs_err": errs[torch.bfloat16],
              "max_abs_err_fp32": errs[torch.float32],
              "ms": dec["ms"], "plain_ms": dec["plain_ms"],
              "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
              "library_ms": dec["library_ms"], "shape": dec["shape"],
              "prefill": times["prefill"], "card": card_line}
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
