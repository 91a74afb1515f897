"""Shape-keyed launch plans and serving parameters, with a persistent JSON
cache.

Port of ``repro/core/autotune.py``. The analytic choices
(:func:`~repro_torch.core.blocking.choose_plan` for the int8 tensor-core
GEMMs, a fixed page size and prefill chunk for the engine) cannot be right
for every shape, so each becomes a cache entry:

* **GEMM plans** (K1, K4, K5, K6a, K6b): key (kernel kind, fused and the
  activations' bytes, M, N, K, backend); candidates are the seed plan and
  its neighbourhood (every row tile; 1, half, the same and twice the
  seed's splits; ``FLUSH_IN_BLOCK`` and ``SCALE_KERNEL`` where they
  apply), each within the card's shared memory before anything launches.
  On the card each candidate is timed through the real wrapper
  (:func:`_measure_time_s`); on the CPU an analytic H100 model
  (:func:`model_time_s`) picks, so tests are instant and deterministic.
  The seed always competes, so a measured plan is never slower than the
  seed beyond noise. Every plan gives the same output bit for bit: the
  integer sums and the rowwise flush do not depend on it.
* **The KV page size** (``pattn|`` keys, :func:`get_page_size`): K3's
  decode step timed at each page size on the card in interleaved rounds;
  another size replaces the engine's page of 16 only where it beats it by
  more than the rounds' spread. On the CPU a model picks.
* **The prefill chunk and pages per step** (``pprefill|`` keys,
  :func:`get_prefill_params`): the analytic model on every backend, as
  in the reference. Timing K2 alone would not see what a chunk changes.
* **The speculation window** (``spec|`` keys, :func:`get_spec_gamma`): a
  closed-form model of acceptance and cost.

:func:`get_plan` is the GEMM wrappers' lookup: a tuple-keyed dict in
memory, the file read at most once a process. Unlike the reference's
``get_blocks``, a shape the cache lacks gets the seed and nothing is
stored: a request launches the analytic plan until a warmup
(``serving.engine.warm_gemm_autotune``) has measured its shape, and a
stored guess would make the warmup skip it (ROADMAP queue 3).

The cache is the port's own: ``$REPRO_TORCH_AUTOTUNE_CACHE``, or
``~/.cache/repro_torch/autotune.json``; the reference's file is never read
or written.
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Callable, Optional

import torch

from repro_torch.core.blocking import (BF16_OPS_PER_S, FLUSH_IN_BLOCK,
                                       HBM_BYTES_PER_S, INT8_OPS_PER_S,
                                       SCALE_KERNEL, TC_BK, TC_BN,
                                       TC_ROW_TILES, PlanConfig, choose_plan,
                                       k_steps, sm_count, valid_plan)

KINDS = ("i8", "w4", "a4w4")
_KIND_BITS = {"i8": (8, 8), "w4": (4, 8), "a4w4": (4, 4)}  # (w_bits, a_bits)

# H100 model terms besides the data sheet's rates (blocking.py); assumed,
# not measured: what the analytic picks on the CPU rest on
_KERNEL_S = 2e-6          # a device kernel's launch on the stream
_SM_SHARE = 4             # an SM alone streams up to 4x its share of HBM
_RUN_BYTES = 64           # the cost of starting a contiguous run in HBM
_OUT_BYTES = 2            # a GEMM's output element (bf16, as served)
_FLUSH_L2_BYTES = 64 << 20    # a write that evicts the 50 MB L2
_SLEEP_CYCLES = 500_000       # ~0.3 ms of device sleep before a timed call

_lock = threading.Lock()
_mem_cache: dict = {}
_disk_loaded = False
# get_plan's memo: (kind, fused, a_in_bytes or 0, m, n, k) → PlanConfig
_plans: dict = {}


def cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def clear_cache(*, disk: bool = False) -> None:
    global _disk_loaded
    with _lock:
        _mem_cache.clear()
        _plans.clear()
        _disk_loaded = False
        if disk:
            try:
                os.remove(cache_path())
            except OSError:
                pass


def _load_disk() -> None:
    """Merge the JSON cache into memory once per process (under _lock)."""
    global _disk_loaded
    if _disk_loaded:
        return
    _disk_loaded = True
    try:
        with open(cache_path()) as f:
            on_disk = json.load(f)
    except (OSError, ValueError):
        return
    if isinstance(on_disk, dict):
        for key, entry in on_disk.items():
            _mem_cache.setdefault(key, entry)


def _save_disk() -> None:
    """Atomic read-merge-write of the JSON cache (under _lock); best-effort."""
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        merged = {}
        try:
            with open(path) as f:
                merged = json.load(f)
        except (OSError, ValueError):
            pass
        merged.update(_mem_cache)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only file system etc.: the in-memory cache still works


def _backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def flush() -> None:
    """Write the in-memory cache through to disk (for ``save=False`` loops)."""
    with _lock:
        _save_disk()


def cached_entries(prefix: str) -> dict:
    """Copies of the cache's entries whose key starts with ``prefix`` (e.g.
    ``'pattn|'``): what was picked, from what, and each candidate's score."""
    with _lock:
        _load_disk()
        return {k: dict(v) for k, v in _mem_cache.items()
                if k.startswith(prefix)}


def _store(key: str, entry: dict, save: bool) -> None:
    with _lock:
        _load_disk()
        _mem_cache[key] = entry
        if save:
            _save_disk()


def _event_time_s(call: Callable, reps: int = 5) -> float:
    """Median device time of ``call`` on the card: one warm call, then
    ``reps`` timed by CUDA events, each after an L2 flush (the serving path
    finds weights and pages cold) and a short device sleep, so that the
    events bracket device time and not the host's enqueue."""
    flush_buf = torch.empty(_FLUSH_L2_BYTES, dtype=torch.uint8, device="cuda")
    call()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush_buf.zero_()
        torch.cuda._sleep(_SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2] * 1e-3


# ---------------------------------------------------------------------------
# GEMM launch plans (K1, K4 fused; K5, K6a, K6b unfused)
# ---------------------------------------------------------------------------
def _key(kind: str, fused: bool, m: int, n: int, k: int, backend: str,
         a_in_bytes: int) -> str:
    # a_in_bytes is the type of x, which only the fused kernels read; the
    # unfused ones read quantized A, so it stays out of their key
    f = f"fused-a{a_in_bytes}B" if fused else "unfused"
    return f"{kind}|{f}|m{m}|n{n}|k{k}|{backend}"


def candidates(kind: str, m: int, n: int, k: int, *, fused: bool = False,
               sms: Optional[int] = None) -> list:
    """The seed plan first, then its neighbourhood: each row tile with 1,
    half, the same and twice the seed's splits (each normalised to equal
    runs of whole K steps), without and with ``FLUSH_IN_BLOCK`` (one split
    only) and ``SCALE_KERNEL`` (fused only), every one valid
    (:func:`~repro_torch.core.blocking.valid_plan`: within the card's
    shared memory, never ``SPLIT_SCALES``). Unlike the reference's, they
    do not depend on x's type: the fused kernels stage x through
    registers, so a block's shared memory is the same for bf16 and f32."""
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r} not in {KINDS}")
    sms = sms or sm_count()
    w4 = kind != "i8"
    seed = choose_plan(m, n, k, sms, fused)
    if not valid_plan(seed, k, fused=fused, w4=w4):
        raise RuntimeError(f"seed plan {seed} invalid at {kind} {(m, n, k)}")
    steps = k_steps(k)
    out = [seed]
    for mt in TC_ROW_TILES:
        for s in (1, seed.splits // 2, seed.splits, 2 * seed.splits):
            per = -(-steps // max(1, min(s, steps)))
            splits = -(-steps // per)
            for flush_in_block in (0, FLUSH_IN_BLOCK)[:1 + (splits == 1)]:
                for scale in (0, SCALE_KERNEL)[:1 + fused]:
                    plan = PlanConfig(mt, splits, per, flush_in_block | scale)
                    if plan not in out and valid_plan(plan, k, fused=fused,
                                                      w4=w4):
                        out.append(plan)
    return out


def model_time_s(kind: str, m: int, n: int, k: int, plan: PlanConfig, *,
                 fused: bool = False, a_in_bytes: int = 4,
                 sms: Optional[int] = None) -> float:
    """Analytic H100 time of one GEMM under ``plan``.

    A block computes MT × 128 outputs over its split's K steps, so padded
    rows cost operations (MT 128 at M 8 does 16× the work) and each of its
    K steps streams MT rows of A (x in its own type when fused) and 128
    columns of W. Blocks run in waves of one an SM, an SM alone streaming
    up to ``_SM_SHARE`` times its share of HBM; the whole call moves at
    least W once per row tile, A once and the output once. Without
    ``FLUSH_IN_BLOCK`` each split's int32 sums go through the workspace to
    a flush kernel; the fused kernels' row scales come from a scale pass
    that reads x again (``SCALE_KERNEL``) or from each block reducing its
    rows over the whole K. Each device kernel adds a launch.
    """
    w_bits, a_bits = _KIND_BITS[kind]
    sms = sms or sm_count()
    mt, splits, per, flags = plan
    a_el = a_in_bytes if fused else a_bits / 8
    row_tiles, col_tiles = -(-m // mt), -(-n // TC_BN)
    blocks = row_tiles * col_tiles * splits
    kp = k_steps(k) * TC_BK
    block_bytes = per * TC_BK * (mt * a_el + TC_BN * w_bits / 8)
    if fused and not flags & SCALE_KERNEL:
        block_bytes += mt * k * a_in_bytes
    block_ops = 2.0 * mt * TC_BN * per * TC_BK
    block_s = max(block_bytes / (_SM_SHARE * HBM_BYTES_PER_S / sms),
                  block_ops / (INT8_OPS_PER_S / sms))
    total_bytes = (k * n * w_bits / 8 * row_tiles + m * k * a_el
                   + m * n * _OUT_BYTES)
    total_ops = 2.0 * row_tiles * mt * col_tiles * TC_BN * kp
    t = max(-(-blocks // sms) * block_s, total_bytes / HBM_BYTES_PER_S,
            total_ops / INT8_OPS_PER_S)
    kernels = 1
    if not flags & FLUSH_IN_BLOCK:
        t += 2 * splits * m * n * 4 / HBM_BYTES_PER_S
        kernels += 1
    if fused and flags & SCALE_KERNEL:
        t += m * k * a_in_bytes / HBM_BYTES_PER_S
        kernels += 1
    return t + kernels * _KERNEL_S


def _measure_time_s(kind: str, m: int, n: int, k: int, plan: PlanConfig, *,
                    fused: bool, a_in_bytes: int = 2, reps: int = 5) -> float:
    """Median device time of the real wrapper under ``plan`` on synthetic
    operands on the card (the same draws for every plan of a shape)."""
    from repro_torch.kernels import camp_gemm as k5
    from repro_torch.kernels import camp_gemm_fused as k1
    from repro_torch.kernels import camp_gemm_w4 as k6

    gen = torch.Generator(device="cuda").manual_seed(0)

    def ints(lo, shape):
        return torch.randint(lo, -lo + 1, shape, dtype=torch.int8,
                             device="cuda", generator=gen)
    kb = k if kind == "i8" else k // 2
    w = ints(-127, (kb, n))             # packed bytes: any two int4 values
    s_b = torch.rand(1, n, device="cuda", generator=gen) * 0.01 + 1e-4
    if fused:
        dtype = torch.bfloat16 if a_in_bytes == 2 else torch.float32
        x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
        fn = {"i8": k1.camp_gemm_fused_w8a8, "w4": k1.camp_gemm_fused_w4a8,
              "a4w4": k1.camp_gemm_fused_w4a4}[kind]
        return _event_time_s(lambda: fn(x, w, s_b, out_dtype=dtype,
                                        plan=plan), reps)
    a = ints(-127, (m, k if kind != "a4w4" else k // 2))
    s_a = torch.rand(m, 1, device="cuda", generator=gen) * 0.01 + 1e-4
    fn = {"i8": k5.camp_gemm_i8, "w4": k6.camp_gemm_w4,
          "a4w4": k6.camp_gemm_a4w4}[kind]
    return _event_time_s(lambda: fn(a, w, s_a, s_b, out_dtype=torch.bfloat16,
                                    plan=plan), reps)


def has_cached(kind: str, m: int, n: int, k: int, *, fused: bool = False,
               a_in_bytes: int = 4) -> bool:
    """Is (kind, fused, m, n, k) already tuned for this backend? Warmups
    skip such shapes; :func:`tune` itself always scores again."""
    key = _key(kind, fused, m, n, k, _backend(), a_in_bytes)
    with _lock:
        _load_disk()
        return key in _mem_cache


def tune(kind: str, m: int, n: int, k: int, *, fused: bool = False,
         a_in_bytes: int = 4, measure: Optional[bool] = None,
         timer: Optional[Callable] = None, save: bool = True) -> PlanConfig:
    """Pick the fastest of :func:`candidates` for (kind, fused, m, n, k)
    and cache it.

    ``measure=None`` → measure iff the process has a card (the operands
    then live on it). Any other value must agree: on the card a plan is
    always measured, so the model's picks never reach a launch, and the
    CPU has no kernel to time. ``timer(plan)`` replaces the scorer
    (tests). ``save=False`` defers the disk write: a loop over shapes
    calls :func:`flush` once at the end. Ties go to the earlier
    candidate, so the seed wins a tie.
    """
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r} not in {KINDS}")
    backend = _backend()
    if measure is None:
        measure = backend == "cuda"
    elif measure != (backend == "cuda"):
        raise ValueError(f"measure={measure} on {backend}: plans are "
                         f"measured on the card and modelled on the CPU")
    sms = sm_count()
    cands = candidates(kind, m, n, k, fused=fused, sms=sms)
    if timer is not None:
        source, score = "timer", timer
    elif measure:
        source = "measured"

        def score(p):
            return _measure_time_s(kind, m, n, k, p, fused=fused,
                                   a_in_bytes=a_in_bytes)
    else:
        source = "model"

        def score(p):
            return model_time_s(kind, m, n, k, p, fused=fused,
                                a_in_bytes=a_in_bytes, sms=sms)
    scores = {p: score(p) for p in cands}
    best = min(cands, key=scores.__getitem__)
    _store(_key(kind, fused, m, n, k, backend, a_in_bytes),
           {"plan": list(best), "source": source,
            "t_us": scores[best] * 1e6, "seed_us": scores[cands[0]] * 1e6},
           save)
    _plans[(kind, fused, a_in_bytes if fused else 0, m, n, k)] = best
    return best


def _cold_plan(kind: str, fused: bool, a_in_bytes: int, m: int, n: int,
               k: int) -> PlanConfig:
    """The cache's plan for a shape get_plan has not seen in this process:
    a valid stored one, else the seed (not stored)."""
    with _lock:
        _load_disk()
        hit = _mem_cache.get(_key(kind, fused, m, n, k, _backend(),
                                  a_in_bytes))
    plan = None
    if hit is not None:
        try:
            plan = PlanConfig(*(int(v) for v in hit["plan"]))
        except (KeyError, TypeError, ValueError):
            plan = None
        if plan is not None and not valid_plan(plan, k, fused=fused,
                                               w4=kind != "i8"):
            plan = None
    return plan or choose_plan(m, n, k, sm_count(), fused)


def get_plan(kind: str, m: int, n: int, k: int, *, fused: bool = False,
             a_in_bytes: int = 4) -> PlanConfig:
    """The GEMM wrappers' plan for (kind, fused, m, n, k): the tuned plan
    where the cache has a valid one, else the seed
    (:func:`~repro_torch.core.blocking.choose_plan`), which is not stored.
    One dict lookup once a shape has been seen in this process."""
    key = (kind, fused, a_in_bytes if fused else 0, m, n, k)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _cold_plan(kind, fused, a_in_bytes, m, n, k)
    return plan


# ---------------------------------------------------------------------------
# The KV page size (``pattn|`` keys)
# ---------------------------------------------------------------------------
# K2 and K3 read a token's row through the block table one row at a time
# (csrc/paged_common.cuh), so every page size here works with both
PAGE_SIZES = (8, 16, 32, 64, 128)


def model_paged_decode_time_s(batch: int, kv_heads: int, head_dim: int,
                              mean_len: int, page_size: int) -> float:
    """Analytic H100 time of one layer's K3 decode step over int8 pages.

    Each sequence's ``mean_len`` tokens stream once (k and v int8 and their
    per-token f32 scales) whatever the page size, since K3 stops at the
    length; a page holds one contiguous run a head of each of the four
    arrays, and every run costs ``_RUN_BYTES`` more, which charges small
    pages. The last page's empty rows cost pool memory, not time.
    """
    runs = batch * kv_heads * 4 * math.ceil(mean_len / page_size)
    data = batch * kv_heads * mean_len * 2 * (head_dim + 4)
    return (data + runs * _RUN_BYTES) / HBM_BYTES_PER_S + 2 * _KERNEL_S


def _random_pages(gen, n_pages: int, kv_heads: int, page_size: int,
                  head_dim: int):
    """int8 k/v pages and f32 per-token scales on the card."""
    shape = (n_pages, kv_heads, page_size, head_dim)
    pages = [torch.randint(-127, 128, shape, dtype=torch.int8,
                           device="cuda", generator=gen) for _ in range(2)]
    scales = [torch.rand(shape[:3], device="cuda", generator=gen) * 0.02
              + 1e-3 for _ in range(2)]
    return pages[0], pages[1], scales[0], scales[1]


def _paged_decode_call(batch: int, kv_heads: int, head_dim: int,
                       mean_len: int, group: int, page_size: int):
    """K3 on the card, ready to launch: ``batch`` sequences of ``mean_len``
    ± a few tokens, ``group`` query heads a kv head, bf16, pages in a
    shuffled order."""
    from repro_torch.kernels import paged_attention as k3
    gen = torch.Generator(device="cuda").manual_seed(0)
    lengths = torch.tensor([max(1, mean_len + i - batch // 2)
                            for i in range(batch)], dtype=torch.int32,
                           device="cuda")
    per_seq = -(-int(lengths.max()) // page_size)
    n_pages = batch * per_seq
    kp, vp, ks, vs = _random_pages(gen, n_pages, kv_heads, page_size,
                                   head_dim)
    tables = torch.randperm(n_pages, generator=gen, device="cuda").to(
        torch.int32).reshape(batch, per_seq)
    q = torch.randn(batch, kv_heads, group, head_dim, device="cuda",
                    generator=gen).to(torch.bfloat16)
    plan = k3.plan_for(q, batch * kv_heads, group,
                       -(-per_seq * page_size // k3.TILE))
    return lambda: k3._run(q, kp, vp, ks, vs, tables, lengths, None, plan)


PAGE_ROUNDS = 5       # interleaved rounds of the page-size scorer


def measure_page_sizes(batch: int, kv_heads: int, head_dim: int,
                       mean_len: int, group: int = 1,
                       rounds: int = PAGE_ROUNDS) -> dict:
    """K3's device time at each of ``PAGE_SIZES`` on the card, ``rounds``
    rounds that each time every size once (so that drift falls on all
    sizes alike) → {page size: [seconds a round]}."""
    calls = {ps: _paged_decode_call(batch, kv_heads, head_dim, mean_len,
                                    group, ps) for ps in PAGE_SIZES}
    times = {ps: [] for ps in PAGE_SIZES}
    for _ in range(rounds):
        for ps, call in calls.items():
            times[ps].append(_event_time_s(call))
    return times


def pick_measured_page(times: dict) -> tuple:
    """The page size that :func:`measure_page_sizes`'s rounds support →
    (page size, medians, spread). The spread is the largest
    (max − min) / median of any size over the rounds. The engine's page
    before this autotune (``DEFAULT_PAGE_SIZE``) stays unless the fastest
    median beats its median by more than the spread, so noise never moves
    the pool's layout, its prefix sharing or its kernels' split plans."""
    from repro_torch.serving.kv_cache import DEFAULT_PAGE_SIZE
    med = {ps: sorted(ts)[len(ts) // 2] for ps, ts in times.items()}
    spread = max((max(ts) - min(ts)) / med[ps] for ps, ts in times.items())
    best = min(med, key=med.get)
    if med[best] >= med[DEFAULT_PAGE_SIZE] * (1.0 - spread):
        best = DEFAULT_PAGE_SIZE
    return best, med, spread


def get_page_size(kv_heads: int, head_dim: int, mean_len: int,
                  batch: int = 8, *, group: int = 1,
                  timer: Optional[Callable] = None,
                  save: bool = True) -> int:
    """Cached KV page-size pick for a serving shape; tunes on first sight.

    On the card each of ``PAGE_SIZES`` is timed by K3's decode step at
    ``batch`` sequences of about ``mean_len`` tokens with ``group`` query
    heads a kv head (:func:`measure_page_sizes`), and
    :func:`pick_measured_page` decides; on the CPU
    :func:`model_paged_decode_time_s` picks. ``timer(page_size)`` replaces
    the scorer (tests). Ties go to the smaller page. The key is the
    reference's with the query group added.
    """
    key = (f"pattn|kv{kv_heads}|hd{head_dim}|len{mean_len}|b{batch}"
           f"|g{group}|{_backend()}")
    with _lock:
        _load_disk()
        hit = _mem_cache.get(key)
    if hit is not None:
        return int(hit["page_size"])
    extra = {}
    if timer is not None or _backend() != "cuda":
        source = "timer" if timer is not None else "model"
        score = timer or (lambda ps: model_paged_decode_time_s(
            batch, kv_heads, head_dim, mean_len, ps))
        scores = {ps: score(ps) for ps in PAGE_SIZES}
        best = min(scores, key=scores.get)
    else:
        source = "measured"
        times = measure_page_sizes(batch, kv_heads, head_dim, mean_len,
                                   group)
        best, scores, spread = pick_measured_page(times)
        extra = {"spread": spread,
                 "rounds_us": {str(p): [t * 1e6 for t in ts]
                               for p, ts in times.items()}}
    _store(key, {"page_size": int(best), "source": source,
                 "t_us": scores[best] * 1e6,
                 "scores_us": {str(p): t * 1e6 for p, t in scores.items()},
                 **extra}, save)
    return int(best)


# ---------------------------------------------------------------------------
# The prefill chunk (``pprefill|`` keys)
# ---------------------------------------------------------------------------
PREFILL_CHUNKS = (64, 128, 256, 512)
# Kept for the reference's key and signature: K2 stages 64-token tiles
# whatever the page size and does not read pages per step
# (kernels/paged_prefill.py), so every value scores alike and the tie
# goes to 1.
PREFILL_PAGES_PER_STEP = (1, 2, 4, 8)


def model_paged_prefill_time_s(kv_heads: int, head_dim: int, page_size: int,
                               mean_len: int, chunk: int,
                               pages_per_step: int) -> float:
    """Analytic H100 per-token time of one layer's K2 chunk ending at
    ``mean_len`` tokens (one query head a kv head, bf16).

    A chunk streams the cached pages once (L2 serves its other row blocks:
    k and v int8, per-token scales, a ``_RUN_BYTES`` run a page and array)
    plus its q and output, and does 4 · chunk · hd operations a visible
    token on the bf16 tensor cores; its one or two launches are shared by
    the chunk's tokens, which is what favours big chunks.
    ``pages_per_step`` does not enter.
    """
    ctx = max(mean_len, chunk)
    data = (kv_heads * ctx * 2 * (head_dim + 4)
            + kv_heads * 4 * math.ceil(ctx / page_size) * _RUN_BYTES
            + chunk * kv_heads * head_dim * 2 * 2)
    ops = 4.0 * chunk * kv_heads * head_dim * (ctx - chunk / 2)
    t = max(data / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) + 2 * _KERNEL_S
    return t / chunk


def get_prefill_params(kv_heads: int, head_dim: int, page_size: int,
                       mean_len: int, *, timer: Optional[Callable] = None,
                       save: bool = True) -> tuple:
    """Cached (chunk tokens, pages per step) pick for chunked prefill.

    Scored by :func:`model_paged_prefill_time_s` on every backend, as in
    the reference; ``timer(chunk, pages_per_step)`` replaces the scorer
    (tests). Ties go to the smaller chunk, then the fewer pages per step,
    so pages per step, which K2 does not read, is 1. On the card K2's
    time a token only falls as the chunk grows (PERF.md), and what a
    bigger chunk saves is whole prefill forwards (every GEMM launch and
    the host's work a step), which no one-kernel scorer sees; the model's
    launch term, shared by the chunk's tokens, stands for that.
    """
    key = (f"pprefill|kv{kv_heads}|hd{head_dim}|ps{page_size}"
           f"|len{mean_len}|{_backend()}")
    with _lock:
        _load_disk()
        hit = _mem_cache.get(key)
    if hit is not None:
        return int(hit["chunk"]), int(hit["pages_per_step"])
    score = timer or (lambda c, pp: model_paged_prefill_time_s(
        kv_heads, head_dim, page_size, mean_len, c, pp))
    scores = {(c, pp): score(c, pp)
              for c in PREFILL_CHUNKS for pp in PREFILL_PAGES_PER_STEP}
    best = min(scores, key=scores.get)
    _store(key, {"chunk": int(best[0]), "pages_per_step": int(best[1]),
                 "source": "timer" if timer else "model",
                 "t_us": scores[best] * 1e6,
                 "scores_us": {f"{c},{pp}": t * 1e6
                               for (c, pp), t in scores.items()}}, save)
    return int(best[0]), int(best[1])


# ---------------------------------------------------------------------------
# Speculative-decoding window tuning (``spec|`` keys)
# ---------------------------------------------------------------------------
SPEC_GAMMAS = (1, 2, 3, 4, 6, 8)
DEFAULT_SPEC_GAMMA = 4
# Marginal cost of one extra verify row relative to a whole decode step:
# decode is bound by the weight and cache stream, paid once per forward
# whether it scores 1 row or γ+1 (the reference's model, kept as it is).
_SPEC_ROW_COST = 0.06


def expected_spec_tokens(gamma: int, acceptance: float) -> float:
    """E[tokens emitted per verify step] under per-token acceptance rate
    ``acceptance``: 1 + a + a² + … + a^γ (a step always emits at least one
    token)."""
    a = min(max(acceptance, 0.0), 1.0)
    if a >= 1.0:
        return float(gamma + 1)
    return (1.0 - a ** (gamma + 1)) / (1.0 - a)


def get_spec_gamma(acceptance: float, *, draft_cost: float = 0.0,
                   save: bool = True) -> int:
    """Cached speculation-window pick from measured acceptance × cost.

    Scores each candidate γ by expected tokens per unit cost, where one
    verify step costs ``1 + _SPEC_ROW_COST·γ + draft_cost·γ`` decode-step
    equivalents (``draft_cost``: the drafter's per-token cost ratio: 0 for
    n-gram lookup, 0.25 for a draft model). Acceptance is bucketed to 0.05
    so the ``spec|`` key space stays bounded.
    """
    bucket = round(min(max(acceptance, 0.0), 0.95) * 20) / 20
    key = f"spec|acc{bucket:.2f}|dc{draft_cost:.2f}|{_backend()}"
    with _lock:
        _load_disk()
        hit = _mem_cache.get(key)
    if hit is not None:
        return int(hit["gamma"])
    scores = {g: -expected_spec_tokens(g, bucket)
              / (1.0 + _SPEC_ROW_COST * g + draft_cost * g)
              for g in SPEC_GAMMAS}
    best = min(scores, key=scores.get)
    _store(key, {"gamma": int(best), "score": scores[best]}, save)
    return int(best)
