"""Speculative-window tuning, with a persistent JSON cache.

Port of the ``spec|`` part of ``repro/core/autotune.py``: the γ a
speculative engine runs with (``gamma='auto'``) is picked from the
measured acceptance rate and the drafter's cost by a closed-form model.
Every pick is a pure function of its key (acceptance bucket, draft cost,
backend), so the JSON cache only memoizes it across processes; it is kept
for the GEMM and page tuning below, which will store measured picks
there. The cache is the port's own: ``$REPRO_TORCH_AUTOTUNE_CACHE``, or
``~/.cache/repro_torch/autotune.json``; the reference's file is never read
or written.

The reference's GEMM-block and page/prefill-chunk parts of the file tune
TPU blocks; their Hopper counterparts (and ``warm_gemm_autotune``'s
``spec_gammas=``, which pre-tunes the verify panels' GEMM shapes, with the
serve CLI's call to it) wait for ROADMAP queue 1 item 5. The port's
kernels pick their own tiles per call meanwhile.
"""
from __future__ import annotations

import json
import os
import threading
import torch

_lock = threading.Lock()
_mem_cache: dict = {}
_disk_loaded = False


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
    with _lock:
        _load_disk()
        _mem_cache[key] = {"gamma": int(best), "score": scores[best]}
        if save:
            _save_disk()
    return int(best)
