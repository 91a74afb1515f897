"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits non-zero and prints no result):

1. Build: compile the three CUDA kernels (one nvcc each, all at once).
2. Kernels vs their plain PyTorch versions on the card, at the serving
   path's full-width qwen2-0.5b shapes, with times (CUDA events, L2 flushed
   before every launch), the bound and a PyTorch library yardstick:
   K1 fused w8a8 GEMM, K3 paged decode attention, K2 paged prefill.
3. Serving: full-width qwen2-0.5b with random weights from a seed, W8A8,
   8 requests of 512 prompt tokens (two sharing a 256-token prefix) and 32
   new tokens each on the continuous-batching engine over the int8 paged
   pool. Every kernel's launch count must rise during this run. Then a
   profiled rerun; every kernel call of one request held against its plain
   version on the same inputs; and that request's first-step logits
   through the kernels against the same forward through the plain versions
   (impl='torch'), in bf16 and in f32.
4. Report: a ``kernels`` JSON line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Needs the repository's ``src/`` beside it; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import camp_gemm_fused as k1  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as k3  # noqa: E402
from repro_torch.kernels import paged_prefill as k2  # noqa: E402
from repro_torch.kernels.epilogue import apply_epilogue, parse_epilogue  # noqa: E402
from repro_torch.kernels.ref import quantize_rowwise_ref  # noqa: E402
from repro_torch.models import init_params, quantize_params  # noqa: E402
from repro_torch.serving import kv_cache as kvc  # noqa: E402
from repro_torch.serving.engine import ContinuousBatchingEngine  # noqa: E402
from repro_torch.serving.spec_decode import paged_chunk_forward  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
BF16_ULP_REL = 2.0 ** -7           # one bf16 ULP, relative, at most
ATT_TOL = 1e-5                     # K2/K3 f32 atol = rtol
# First-step logits, kernels vs plain versions, through all 24 layers: 10%
# of max |logit|, in bf16 and in f32 alike. Each kernel call agrees with its
# plain version on the same inputs (exactly, or within one ULP: phase 2 and
# the in-situ check), but a last-bit difference flips the int8 rounding of
# an activation now and then, and every flip moves that GEMM's outputs by
# ~1e-3 relative, which flips many more roundings in the next layer: W8A8
# amplifies rounding noise to a few percent of the logits over 24 layers of
# random weights. 10% still catches a wrong page, row or scale (errors of
# order 100%); the in-situ check holds every kernel call tightly.
LOGIT_TOL = 0.10
SEED = 0                           # inputs and random weights

KERNELS = {
    "K1": dict(name="camp_gemm_fused_w8a8", route="cuda",
               source="src/repro_torch/csrc/camp_gemm_fused.cu",
               replaces="src/repro/kernels/camp_gemm_fused.py:108"),
    "K2": dict(name="paged_prefill", route="cuda",
               source="src/repro_torch/csrc/paged_prefill.cu",
               replaces="src/repro/kernels/paged_prefill.py:197"),
    "K3": dict(name="paged_attention", route="cuda",
               source="src/repro_torch/csrc/paged_attention.cu",
               replaces="src/repro/kernels/paged_attention.py:178"),
}


class Timer:
    """Mean device time of ``fn`` in ms, with L2 flushed before each launch
    (a 64 MB write exceeds the 50 MB L2), as the serving path finds it:
    every layer's weights and pages are cold. A ~1 ms device sleep before
    the start event keeps the GPU busy while the host enqueues ``fn``, so
    the events bracket device time, not the wrapper's host overhead."""

    def __init__(self, iters: int = 20):
        self.iters = iters
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def within_bf16_ulp(a, b, atol: float = 0.0) -> bool:
    """|a - b| ≤ atol + one bf16 ULP of the larger magnitude."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + BF16_ULP_REL
                 * torch.maximum(a.abs(), b.abs())).all())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def k1_library(x, w_q, s_b, epilogue, bias, operand):
    """Yardstick: rowwise quantize, torch._int_mm, then the elementwise
    flush (cuBLASLt wants M > 16, so small M is padded to 32 rows)."""
    a_q, a_s = quantize_rowwise_ref(x)
    m = a_q.shape[0]
    if m <= 16:
        a_q = F.pad(a_q, (0, 0, 0, 32 - m))
    acc = torch._int_mm(a_q, w_q)[:m]
    y = acc.float() * (a_s * s_b)
    y = apply_epilogue(y, parse_epilogue(epilogue),
                       bias=None if bias is None else bias.reshape(1, -1),
                       operand=operand)
    return y.to(x.dtype)


def check_k1(timer, gen):
    rows = []
    for m in (1, 8, 256):
        for (k, n) in ((896, 896), (896, 128), (896, 4864), (4864, 896)):
            w = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                              device="cuda", generator=gen)
            s_b = torch.rand(1, n, device="cuda", generator=gen) * 0.01 + 1e-4
            x = torch.randn(m, k, device="cuda",
                            generator=gen).to(torch.bfloat16)
            for epi in ("none", "bias", "silu", "mul"):
                bias = (torch.randn(n, device="cuda", generator=gen)
                        .to(torch.bfloat16) if epi == "bias" else None)
                opd = (torch.randn(m, n, device="cuda", generator=gen)
                       .to(torch.bfloat16) if epi == "mul" else None)
                kw = dict(out_dtype=torch.bfloat16, epilogue=epi, bias=bias,
                          operand=opd)
                got = k1.camp_gemm_fused_w8a8(x, w, s_b, **kw)
                want = k1.camp_gemm_fused_w8a8_ref(x, w, s_b, **kw)
                torch.cuda.synchronize()
                err = max_err(got, want)
                ok = (within_bf16_ulp(got, want) if epi == "silu"
                      else torch.equal(got, want))
                n_bytes = (2 * m * k + k * n + 4 * n + 2 * m * n
                           + (2 * n if bias is not None else 0)
                           + (2 * m * n if opd is not None else 0))
                b_ms, b_by = bound(n_bytes, 2.0 * m * n * k, INT8_OPS_PER_S)
                try:
                    lib = timer(lambda: k1_library(x, w, s_b, epi, bias, opd))
                except RuntimeError as e:       # cuBLASLt refused the shape
                    print(f"  K1 library yardstick unavailable: {e}")
                    lib = None
                row = dict(kernel="K1", m=m, k=k, n=n, epilogue=epi,
                           max_abs_err=err, ok=ok,
                           ms=timer(lambda: k1.camp_gemm_fused_w8a8(
                               x, w, s_b, **kw)),
                           plain_ms=timer(lambda: k1.camp_gemm_fused_w8a8_ref(
                               x, w, s_b, **kw)),
                           library_ms=lib, bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
                print(f"  K1 M={m:3d} K={k:4d} N={n:4d} {epi:4s} "
                      f"err={err:.3g} ({'exact' if epi != 'silu' else '1 bf16 ULP'}"
                      f" {'ok' if ok else 'FAIL'}) ms={row['ms']:.4f} "
                      f"plain={row['plain_ms']:.4f} lib={lib} "
                      f"bound={b_ms:.4f} ({b_by})")
    return rows


def _pages(gen, num_pages, kv, ps, hd):
    def i8():
        return torch.randint(-127, 128, (num_pages, kv, ps, hd),
                             dtype=torch.int8, device="cuda", generator=gen)

    def sc():
        return torch.rand(num_pages, kv, ps, device="cuda",
                          generator=gen) * 0.05 + 1e-3
    return i8(), i8(), sc(), sc()


def _dense(pages, scales, slots):
    """Gather + dequantize pages → (KV, T, hd) f32 (yardstick inputs)."""
    x = pages[slots.long()].float() * scales[slots.long()][..., None]
    return x.transpose(0, 1).reshape(pages.shape[1], -1, pages.shape[3])


def _att_ok(got, want, dtype):
    if dtype == torch.float32:
        return bool(((got - want).abs() <= ATT_TOL + ATT_TOL * want.abs())
                    .all())
    return within_bf16_ulp(got, want, atol=ATT_TOL)


def check_k3(timer, gen):
    b, kv, g, hd, ps = 8, 2, 7, 64, 16
    lengths = torch.tensor([1, 16, 17, 100, 255, 512, 529, 544],
                           dtype=torch.int32, device="cuda")
    max_pages = 34
    num_pages = b * max_pages + 8
    kp, vp, ks, vs = _pages(gen, num_pages, kv, ps, hd)
    tables = torch.randperm(num_pages, device="cuda", generator=gen)[
        :b * max_pages].reshape(b, max_pages).int().contiguous()
    n_used = ((lengths + ps - 1) // ps).long()
    tokens = lengths.long().sum().item()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, kv, g, hd, device="cuda",
                        generator=gen).to(dtype)
        args = (q, kp, vp, ks, vs, tables, lengths)
        got = k3.paged_attention_cuda(*args)
        want = k3.paged_attention_reference(*args)
        torch.cuda.synchronize()
        err, ok = max_err(got, want), _att_ok(got.float(), want.float(), dtype)
        pages_read = n_used.sum().item()
        n_bytes = (2 * q.numel() * q.element_size()
                   + pages_read * kv * ps * (2 * hd + 8)
                   + 4 * (pages_read + b))
        b_ms, b_by = bound(n_bytes, 4.0 * g * hd * kv * tokens,
                           BF16_OPS_PER_S)
        # yardstick: SDPA over the dequantized dense KV (prepared outside)
        k_d = torch.stack([_dense(kp, ks, tables[i]) for i in range(b)])
        v_d = torch.stack([_dense(vp, vs, tables[i]) for i in range(b)])
        mask = (torch.arange(max_pages * ps, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        q_s = q.float().reshape(b, kv * g, 1, hd)

        def lib():
            return F.scaled_dot_product_attention(q_s, k_d, v_d,
                                                  attn_mask=mask,
                                                  enable_gqa=True)
        row = dict(kernel="K3", b=b, dtype=str(dtype), max_abs_err=err, ok=ok,
                   ms=timer(lambda: k3.paged_attention_cuda(*args)),
                   plain_ms=timer(lambda: k3.paged_attention_reference(*args)),
                   library_ms=timer(lib), bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print(f"  K3 B={b} lengths={lengths.tolist()} {dtype} err={err:.3g} "
              f"({'ok' if ok else 'FAIL'}) ms={row['ms']:.4f} "
              f"plain={row['plain_ms']:.4f} lib={row['library_ms']:.4f} "
              f"bound={b_ms:.4f} ({b_by})")
    return rows


def check_k2(timer, gen):
    kv, g, hd, ps, c = 2, 7, 64, 16, 256
    rows = []
    for q_start in (0, 512, 517):
        n_pages = -(-(q_start + c) // ps)
        num_pages = n_pages + 16
        kp, vp, ks, vs = _pages(gen, num_pages, kv, ps, hd)
        table = torch.randperm(num_pages, device="cuda", generator=gen)[
            :n_pages + 2].int().contiguous()
        visible = sum(q_start + i + 1 for i in range(c))
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(kv, c, g, hd, device="cuda",
                            generator=gen).to(dtype)
            args = (q, kp, vp, ks, vs, table)
            got = k2.paged_prefill_cuda(*args, q_start=q_start)
            want = k2.paged_prefill_reference(*args, q_start=q_start)
            torch.cuda.synchronize()
            err = max_err(got, want)
            ok = _att_ok(got.float(), want.float(), dtype)
            n_bytes = (2 * q.numel() * q.element_size()
                       + n_pages * kv * ps * (2 * hd + 8) + 4 * n_pages)
            b_ms, b_by = bound(n_bytes, 4.0 * g * hd * kv * visible,
                               BF16_OPS_PER_S)
            k_d = _dense(kp, ks, table[:n_pages])[None]
            v_d = _dense(vp, vs, table[:n_pages])[None]
            t = n_pages * ps
            mask = (torch.arange(t, device="cuda")[None, :]
                    <= q_start + torch.arange(c, device="cuda")[:, None])
            q_s = q.float().permute(0, 2, 1, 3).reshape(1, kv * g, c, hd)

            def lib():
                return F.scaled_dot_product_attention(q_s, k_d, v_d,
                                                      attn_mask=mask,
                                                      enable_gqa=True)
            row = dict(kernel="K2", c=c, q_start=q_start, dtype=str(dtype),
                       max_abs_err=err, ok=ok,
                       ms=timer(lambda: k2.paged_prefill_cuda(
                           *args, q_start=q_start)),
                       plain_ms=timer(lambda: k2.paged_prefill_reference(
                           *args, q_start=q_start)),
                       library_ms=timer(lib), bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            print(f"  K2 C={c} q_start={q_start} {dtype} err={err:.3g} "
                  f"({'ok' if ok else 'FAIL'}) ms={row['ms']:.4f} "
                  f"plain={row['plain_ms']:.4f} lib={row['library_ms']:.4f} "
                  f"bound={b_ms:.4f} ({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: full-width serving
# ---------------------------------------------------------------------------
def serve(seed: int):
    cfg = get_config("qwen2-0.5b", qmode="w8a8")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = quantize_params(init_params(cfg, generator=gen, device="cuda"),
                             cfg, "w8a8")
    torch.cuda.synchronize()
    print(f"  init_params + quantize_params(w8a8): "
          f"{time.perf_counter() - t0:.2f} s")
    n_req, prompt_len, prefix_len, new = 8, 512, 256, 32
    prompts = torch.randint(0, cfg.vocab_size, (n_req, prompt_len),
                            generator=gen, device="cuda")
    prompts[1, :prefix_len] = prompts[0, :prefix_len]   # a shared prefix
    ps = kvc.DEFAULT_PAGE_SIZE

    def engine():
        return ContinuousBatchingEngine(
            params, cfg, page_size=ps,
            capacity_tokens=n_req * kvc.round_up(prompt_len + new, ps),
            device="cuda")

    warm = engine()                      # first-use costs (cuBLAS, caches)
    warm.submit(prompts[0, :40], 2)
    warm.run()
    torch.cuda.synchronize()
    eng = engine()
    for k in (k1, k2, k3):
        k.launches = 0
    t0 = time.perf_counter()
    sids = [eng.submit(p, new) for p in prompts]
    ttft, shared = {}, 0
    while eng.step():
        now = time.perf_counter() - t0
        for r in list(eng.active) + list(eng.finished.values()):
            if r.tokens and r.seq_id not in ttft:
                ttft[r.seq_id] = now
        shared = max(shared, eng.pool.shared_page_stats()["shared_slots"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": k1.launches, "K2": k2.launches, "K3": k3.launches}
    for r in eng.finished.values():
        ttft.setdefault(r.seq_id, wall)
    out = [eng.finished[s].tokens for s in sids]
    steps = sum(len(t) for t in out)
    print(f"  served {n_req} requests x {prompt_len} prompt + {new} new "
          f"tokens in {wall:.3f} s: {steps / wall:.1f} generated tok/s, "
          f"{n_req * (prompt_len + new) / wall:.1f} processed tok/s")
    print(f"  time to first token: first {min(ttft.values()):.3f} s, "
          f"median {sorted(ttft.values())[n_req // 2]:.3f} s, "
          f"last {max(ttft.values()):.3f} s; pages shared: {shared} "
          f"(prefix {prefix_len} tokens = {prefix_len // ps} pages)")
    print(f"  kernel launches during serving: {launches}")
    if any(v == 0 for v in launches.values()):
        raise RuntimeError(f"a kernel of the path was never launched: "
                           f"{launches}")
    if [len(t) for t in out] != [new] * n_req or not all(
            0 <= x < cfg.vocab_size for t in out for x in t):
        raise RuntimeError("generated tokens of the wrong count or range")
    if shared != prefix_len // ps:
        raise RuntimeError(f"expected {prefix_len // ps} shared pages, "
                           f"saw {shared}")

    profile = profile_serving(engine, prompts, new)
    in_situ = check_in_situ(engine, prompts[0])
    logit_checks = {"bfloat16": first_step_logits(params, cfg, prompts[0])}
    cfg32 = get_config("qwen2-0.5b", qmode="w8a8", dtype="float32")
    params32 = quantize_params(init_params(
        cfg32, generator=torch.Generator(device="cuda").manual_seed(seed),
        device="cuda"), cfg32, "w8a8")
    logit_checks["float32"] = first_step_logits(params32, cfg32, prompts[0])
    return dict(launches=launches, wall_s=wall, gen_tok_s=steps / wall,
                ttft_s=sorted(ttft.values()), shared_pages=shared,
                in_situ=in_situ, logits=logit_checks, profile=profile)


def check_in_situ(engine, prompt):
    """Every kernel launch of one request (two prefill chunks, two decode
    steps) on the engine, held against its plain version on the very same
    inputs: K1 exact (silu: one bf16 ULP), K2/K3 within one bf16 ULP."""
    worst, calls = {"K1": 0.0, "K2": 0.0, "K3": 0.0}, {"K1": 0, "K2": 0,
                                                      "K3": 0}

    def checked(key, kernel, plain, close):
        def call(*args, **kw):
            got = kernel(*args, **kw)
            kw.pop("pages_per_step", None)
            want = plain(*args, **kw)
            if not close(got, want, kw):
                raise RuntimeError(f"{key} in situ differs from its plain "
                                   f"version by {max_err(got, want):.3g}")
            worst[key] = max(worst[key], max_err(got, want))
            calls[key] += 1
            return got
        return call

    def k1_close(got, want, kw):
        return (within_bf16_ulp(got, want) if "silu" in kw.get("epilogue", "")
                else torch.equal(got, want))

    def att_close(got, want, kw):
        return _att_ok(got.float(), want.float(), got.dtype)

    saved = (ops.camp_gemm_fused_w8a8, k2.paged_prefill_cuda,
             k3.paged_attention_cuda)
    ops.camp_gemm_fused_w8a8 = checked("K1", saved[0],
                                       k1.camp_gemm_fused_w8a8_ref, k1_close)
    k2.paged_prefill_cuda = checked("K2", saved[1],
                                    k2.paged_prefill_reference, att_close)
    k3.paged_attention_cuda = checked("K3", saved[2],
                                      k3.paged_attention_reference, att_close)
    try:
        eng = engine()
        eng.submit(prompt, 3)
        eng.run()
    finally:
        (ops.camp_gemm_fused_w8a8, k2.paged_prefill_cuda,
         k3.paged_attention_cuda) = saved
    print(f"  in situ, every kernel call vs its plain version on the same "
          f"inputs: calls {calls}, max |diff| {worst}")
    if not all(calls.values()):
        raise RuntimeError(f"in-situ check saw no call of a kernel: {calls}")
    return dict(calls=calls, max_abs_diff=worst)

def profile_serving(engine, prompts, new):
    """The same workload again under torch.profiler: device busy share of
    the wall time and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    eng = engine()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, new)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0 and getattr(e, "device_type", None) is not None and \
                str(e.device_type).endswith("CUDA"):
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + t / 1e3
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    if busy == 0:
        print("  profiler: no device time recorded (not measured)")
    else:
        print(f"  profiled rerun: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy:.1f} ms ({busy / (wall * 1e3):.1%}); top kernels (ms):")
        for name, ms in top:
            print(f"    {ms:9.2f}  {name[:100]}")
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                top=[[n, ms] for n, ms in top])


def first_step_logits(params, cfg, prompt, rel_tol=LOGIT_TOL):
    """One request's first-step logits (its prompt prefilled in two chunks
    of 256) through the kernels and through the plain versions, on the
    card; fails beyond ``rel_tol`` × max |logit|."""
    ps = kvc.DEFAULT_PAGE_SIZE

    def run(impl):
        pool = kvc.PagePool(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                            head_dim=cfg.hd, num_pages=len(prompt) // ps + 1,
                            page_size=ps, device="cuda")
        pool.reserve(0, len(prompt))
        for start in range(0, len(prompt), 256):
            logits = paged_chunk_forward(
                params, cfg, pool, 0, prompt[start:start + 256], start,
                logits="last" if start + 256 >= len(prompt) else "none",
                impl=impl)
        return logits[0, -1].float()

    got, want = run("auto"), run("torch")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError("non-finite logits")
    err, scale = max_err(got, want), want.abs().max().item()
    print(f"  first-step logits ({cfg.dtype}), kernels vs plain: max |diff| "
          f"{err:.4g} = {err / scale:.2%} of max |logit| {scale:.4g} "
          f"(limit {rel_tol:.0%}); argmax {got.argmax().item()} vs "
          f"{want.argmax().item()}")
    if err > rel_tol * scale:
        raise RuntimeError(f"{cfg.dtype} kernel logits differ from the plain "
                           f"versions by more than {rel_tol:.0%} of max |logit|")
    return dict(max_abs_diff=err, max_abs_logit=scale, rel_tol=rel_tol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measurement here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[chip_smoke] {torch.cuda.get_device_name(0)}; {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all()
    print(f"[phase 1] built {', '.join(build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s")

    print("[phase 2] kernels vs plain versions at the serving shapes")
    timer, gen = Timer(), torch.Generator(device="cuda").manual_seed(SEED)
    rows = check_k1(timer, gen) + check_k3(timer, gen) + check_k2(timer, gen)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"{len(bad)} kernel checks failed: {bad}")

    print("[phase 3] full-width qwen2-0.5b W8A8 serving")
    served = serve(SEED)

    # one headline row per kernel: a decode-shaped gate GEMM, the K3 bf16
    # batch, the K2 chunk at q_start 512 in bf16; errors over every case
    headline = {
        "K1": next(r for r in rows if r["kernel"] == "K1" and r["m"] == 8
                   and r["n"] == 4864 and r["epilogue"] == "silu"),
        "K2": next(r for r in rows if r["kernel"] == "K2"
                   and r["q_start"] == 512 and "bfloat16" in r["dtype"]),
        "K3": next(r for r in rows if r["kernel"] == "K3"
                   and "bfloat16" in r["dtype"])}
    kernels = []
    for key, meta in KERNELS.items():
        h = headline[key]
        kernels.append(dict(
            meta, launches=served["launches"][key],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["kernel"] == key),
            ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=h["library_ms"]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=smi, rows=rows, serving=served, kernels=kernels),
            indent=1))
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
