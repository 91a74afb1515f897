"""Speculative decoding: draft–verify serving on the paged int8 KV cache.

Port of ``repro/serving/spec_decode.py``. A drafter proposes up to γ
cheap tokens; the target model scores all of them in ONE forward over the
paged cache (the γ+1-token query goes through the chunked paged-prefill
path, K2 at C = γ+1 and a mid-page ``q_start``, its projections through
the fused GEMMs K1/K4 at M = γ+1); exact acceptance–rejection keeps the
longest draft prefix the target agrees with, so each verify forward emits
between 1 and γ+1 tokens.

Three layers:

* **drafters**, anything satisfying the :class:`Drafter` protocol.
  :class:`NGramDrafter` is model-free prompt lookup (continue the most
  recent earlier occurrence of the trailing n-gram; a one-hot draft
  distribution). :class:`DraftModelDrafter` runs a small causal LM over
  its **own** paged int8 pool, lazily synced to the verified history
  (truncate + one catch-up chunk) at each proposal, so rejected drafts
  never reach its cache.
* **verification**: :func:`accept_speculative`, the exact rule. Greedy
  accepts while the draft equals the row's argmax, so the stream equals
  non-speculative greedy decoding; temperature accepts draft i with
  probability min(1, p_i(d_i)/q_i(d_i)), samples the residual
  norm(max(p−q, 0)) at the first rejection and a bonus token from the last
  row when all are accepted, which preserves the target distribution.
* **rollback**: the engine writes the panel's KV into the sequence's pages
  before verification, then :meth:`PagePool.truncate` discards the
  rejected suffix. Pages are write-once at token granularity and every
  read is bounded by ``pool.lens``, so the kept prefix is the one a run
  that never speculated would hold.

Randomness: where the reference folds a ``jax.random`` key per
(seq_id, emitted index, stream), each draw here comes from a CPU
``torch.Generator`` seeded by (seed, seq_id, index, stream), as the
engine's ``_sample_tokens`` seeds by (seed, seq_id, token index). Stream 0
is the acceptance test's uniform, stream 1 the residual or bonus draw, so
a position draws the same values however many drafts came before it.
Temperature streams match the reference in distribution only.

The engine integration (scheduling, stats, γ autotune) lives in
:class:`repro_torch.serving.engine.ContinuousBatchingEngine`; this module
has no engine import.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

# mixes a drafter's seed away from its engine's (the reference folds its
# engine key with 0x5bec)
DRAFT_SEED_SALT = 0x5BEC


# ---------------------------------------------------------------------------
# Configuration + stats
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SpecConfig:
    """How an engine should speculate.

    ``method``: 'off' | 'ngram' | 'draft'. ``gamma``: speculation window
    (draft tokens per step), or 'auto' to pick from the measured acceptance
    rate through the autotune cache (``spec|`` keys).
    ``draft_cfg``/``draft_params``: the small draft LM for method='draft'.
    ``ngram_max``/``ngram_min``: prompt-lookup n-gram sizes tried, longest
    first.
    """
    method: str = "off"
    gamma: Any = 4                       # int or "auto"
    ngram_max: int = 3
    ngram_min: int = 1
    ngram_window: int = 4096             # trailing tokens scanned per lookup
    draft_cfg: Any = None                # ModelConfig
    draft_params: Any = None
    draft_page_size: Optional[int] = None
    draft_capacity_tokens: Optional[int] = None


@dataclasses.dataclass
class SpecStats:
    """Draft/verify accounting (per request and engine-aggregate)."""
    steps: int = 0                       # verification forwards run
    proposed: int = 0                    # draft tokens scored
    accepted: int = 0                    # draft tokens kept
    emitted: int = 0                     # tokens emitted by spec steps

    def add(self, proposed: int, accepted: int, emitted: int) -> None:
        self.steps += 1
        self.proposed += proposed
        self.accepted += accepted
        self.emitted += emitted

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def mean_tokens_per_step(self) -> float:
        return self.emitted / self.steps if self.steps else 0.0

    def summary(self) -> Dict[str, float]:
        return {"spec_steps": self.steps, "proposed": self.proposed,
                "accepted": self.accepted, "emitted": self.emitted,
                "acceptance_rate": self.acceptance_rate,
                "mean_tokens_per_step": self.mean_tokens_per_step}


# ---------------------------------------------------------------------------
# One sequence's multi-token chunk through the paged-prefill call path
# ---------------------------------------------------------------------------
def paged_chunk_forward(params, cfg, pool, seq_id: int, tokens, start: int, *,
                        pages_per_step: int = 1, logits: str = "all",
                        impl: str = "auto"):
    """Run ``forward()`` over one sequence's chunk via PagedPrefillCache
    views: write the chunk's KV into the pool's pages, attend over the whole
    cached prefix, advance ``pool.lens``. The one implementation behind the
    engine's prefill lane, its verify panels, and the draft model's
    catch-up and proposal steps. ``logits``: 'all' (1, C, V) | 'last'
    (1, 1, V) | 'none' (skip the vocabulary head). ``start`` need not be
    page-aligned."""
    from repro_torch.models.transformer import forward  # lazy: import cycle
    toks = torch.as_tensor(tokens, dtype=torch.long,
                           device=pool.device).reshape(1, -1)
    c = toks.shape[1]
    positions = (start + torch.arange(c, device=pool.device))[None]
    caches = [{"attn": pool.prefill_cache(i, seq_id, start, pages_per_step)}
              for i in range(cfg.n_layers)]
    kw = {"last_logits_only": True} if logits == "last" else \
        {"return_hidden": True} if logits == "none" else {}
    out, new_caches, _ = forward(params, cfg, toks, positions=positions,
                                 caches=caches, impl=impl, **kw)
    for i, layer in enumerate(new_caches):
        pool.writeback(i, layer["attn"])
    pool.lens[seq_id] = start + int(c)
    return None if logits == "none" else out


# ---------------------------------------------------------------------------
# Seeded draws
# ---------------------------------------------------------------------------
def stream_generator(seed: int, seq_id: int, index: int,
                     stream: int) -> torch.Generator:
    """A CPU generator for one draw, seeded by (seed, seq_id, index,
    stream) alone."""
    s = ((seed * 1_000_003 + seq_id) * 1_000_003 + index) * 2 + stream
    return torch.Generator().manual_seed(s % (1 << 63))


def _categorical(p: np.ndarray, gen: torch.Generator) -> int:
    """One draw from the distribution ``p`` (V,)."""
    return int(torch.multinomial(torch.from_numpy(p), 1, generator=gen))


# ---------------------------------------------------------------------------
# Drafters
# ---------------------------------------------------------------------------
class Drafter(Protocol):
    """Proposes up to ``gamma`` continuation tokens for one sequence.

    ``propose`` returns (tokens, q) where ``q`` is a (len(tokens), V)
    f32 array of the draft distribution each token was sampled from, or
    None for a deterministic drafter (one-hot q: acceptance then tests
    the raw target probability of the proposed token).
    ``cost_ratio`` is the drafter's rough per-token cost relative to one
    target decode step (feeds the γ autotune). ``release`` drops any
    per-sequence state when the engine retires the request.
    """
    cost_ratio: float

    def propose(self, seq_id: int, history: Sequence[int], gamma: int, *,
                reserve_tokens: int = 0
                ) -> Tuple[List[int], Optional[np.ndarray]]: ...

    def release(self, seq_id: int) -> None: ...


class NGramDrafter:
    """Model-free prompt-lookup drafting.

    Finds the most recent earlier occurrence of the history's trailing
    n-gram (n from ``max_n`` down to ``min_n``) and proposes the tokens
    that followed it. ``scan_window`` bounds the host-side lookup to the
    trailing W tokens of the history (proposals are unchanged whenever the
    match lies inside the window).
    """

    cost_ratio = 0.0

    def __init__(self, max_n: int = 3, min_n: int = 1,
                 scan_window: int = 4096):
        if min_n < 1 or max_n < min_n:
            raise ValueError(f"bad n-gram range [{min_n}, {max_n}]")
        self.max_n, self.min_n = max_n, min_n
        self.scan_window = scan_window

    def propose(self, seq_id: int, history: Sequence[int], gamma: int, *,
                reserve_tokens: int = 0):
        h = list(history)[-self.scan_window:]
        for n in range(self.max_n, self.min_n - 1, -1):
            if len(h) <= n:
                continue
            pat = h[-n:]
            # the most recent earlier occurrence with a full-γ continuation
            # wins; matches flush against the tail yield only their short
            # suffix, so fall back to the longest continuation seen
            # (i + n <= len(h) - 1, so a continuation is never empty)
            best: List[int] = []
            for i in range(len(h) - n - 1, -1, -1):
                if h[i:i + n] == pat:
                    cont = h[i + n:i + n + gamma]
                    if len(cont) == gamma:
                        return cont, None
                    if len(cont) > len(best):
                        best = cont
            if best:
                return best, None
        return [], None

    def release(self, seq_id: int) -> None:
        pass


class DraftModelDrafter:
    """A small causal LM drafting over its own paged int8 pool.

    At each ``propose`` the longest common prefix of the cached tokens and
    the current history survives (:meth:`PagePool.truncate` rewinds the
    rest, so the previous step's rejected drafts fall off here), and the
    unseen suffix is fed as one catch-up chunk through the paged-prefill
    path the verifier uses. Then γ single-token steps autoregress the
    proposals. Under temperature sampling each token is drawn from the
    distribution returned as its q (seeded per (seed, seq_id, position)),
    so acceptance–rejection stays exact.
    """

    cost_ratio = 0.25

    def __init__(self, params, cfg, *, sample: str = "greedy",
                 temperature: float = 1.0, seed: int = 1,
                 page_size: Optional[int] = None,
                 capacity_tokens: Optional[int] = None,
                 pages_per_step: int = 2, device=None, impl: str = "auto"):
        from repro_torch.models.transformer import dtype_of
        from repro_torch.serving import kv_cache as kvc
        mixers = {cfg.mixer_of(i) for i in range(cfg.n_layers)}
        if mixers != {"attn"}:
            raise ValueError(
                f"draft model needs attention mixers, got {mixers}")
        self.params, self.cfg = params, cfg
        self.sample, self.temperature = sample, temperature
        self.seed, self.impl = seed, impl
        self.pages_per_step = pages_per_step
        ps = page_size or kvc.DEFAULT_PAGE_SIZE
        capacity = capacity_tokens or 8 * cfg.max_seq_len
        self.pool = kvc.PagePool(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, num_pages=-(-capacity // ps), page_size=ps,
            quantized=True, dtype=dtype_of(cfg), device=device)
        self.cached: Dict[int, List[int]] = {}   # tokens whose KV is cached

    def _forward_chunk(self, seq_id: int, tokens: List[int],
                       start: int) -> np.ndarray:
        """Feed ``tokens`` at positions [start, start+m); last-row logits."""
        need = self.pool.pages_for(start + len(tokens))
        if need > len(self.pool.tables[seq_id]):
            raise RuntimeError(
                f"draft seq {seq_id}: {start + len(tokens)} tokens exceed "
                f"the {len(self.pool.tables[seq_id])}-page reservation")
        logits = paged_chunk_forward(
            self.params, self.cfg, self.pool, seq_id, tokens, start,
            pages_per_step=self.pages_per_step, logits="last",
            impl=self.impl)
        return logits[0, -1].float().cpu().numpy()

    def propose(self, seq_id: int, history: Sequence[int], gamma: int, *,
                reserve_tokens: int = 0):
        history = list(history)
        if seq_id not in self.pool.tables:
            need = max(reserve_tokens, len(history) + 1)
            if not self.pool.can_reserve(need):
                # the draft pool is its own admission domain: when it cannot
                # hold this sequence, decline to draft (the engine verifies
                # the bare last token) instead of aborting the serve loop
                return [], None
            self.pool.reserve(seq_id, need)
            self.cached[seq_id] = []
        cached = self.cached[seq_id]
        # survive on the longest verified prefix; rewind the rest
        n = 0
        for a, b in zip(cached, history):
            if a != b:
                break
            n += 1
        if n < len(cached):
            self.pool.truncate(seq_id, n)
            del cached[n:]
        feed = history[n:]               # ≥ 1: history grew since last step
        tokens: List[int] = []
        qs: List[np.ndarray] = []
        for _ in range(gamma):
            logits = self._forward_chunk(seq_id, feed, len(cached))
            cached.extend(feed)
            if self.sample == "greedy":
                t = int(logits.argmax())
            else:
                p = _softmax(logits / self.temperature)
                t = _categorical(p, stream_generator(self.seed, seq_id,
                                                     len(cached), 0))
                qs.append(p)
            tokens.append(t)
            feed = [t]
        if self.sample == "greedy" or not tokens:
            return tokens, None
        return tokens, np.stack(qs)

    def release(self, seq_id: int) -> None:
        if seq_id in self.pool.tables:
            self.pool.release(seq_id)
        self.cached.pop(seq_id, None)


def make_drafter(spec: SpecConfig, *, sample: str = "greedy",
                 temperature: float = 1.0, seed: int = 1, device=None,
                 impl: str = "auto") -> Drafter:
    if spec.method == "ngram":
        return NGramDrafter(max_n=spec.ngram_max, min_n=spec.ngram_min,
                            scan_window=spec.ngram_window)
    if spec.method == "draft":
        if spec.draft_cfg is None or spec.draft_params is None:
            raise ValueError("method='draft' needs draft_cfg + draft_params")
        return DraftModelDrafter(
            spec.draft_params, spec.draft_cfg, sample=sample,
            temperature=temperature, seed=seed,
            page_size=spec.draft_page_size,
            capacity_tokens=spec.draft_capacity_tokens, device=device,
            impl=impl)
    raise ValueError(f"unknown spec method {spec.method!r}")


# ---------------------------------------------------------------------------
# Exact acceptance–rejection
# ---------------------------------------------------------------------------
def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def accept_speculative(rows: np.ndarray, draft: Sequence[int],
                       draft_q: Optional[np.ndarray], *, sample: str,
                       temperature: float, seed: int, seq_id: int,
                       start_index: int) -> Tuple[int, List[int]]:
    """Exact draft verification. Returns (n_accepted, emitted_tokens).

    ``rows``: (len(draft)+1, V) f32 target logits; row i scores the token
    after position i of the panel [last_sampled, d_1, …, d_γ]. ``draft_q``:
    (len(draft), V) draft distributions, or None for a deterministic
    drafter (one-hot). ``start_index``: how many tokens the request had
    emitted before this step; the draws of emitted position
    ``start_index + i`` come from :func:`stream_generator` (seed, seq_id,
    start_index + i, stream), whatever preceded it.

    * greedy: accept while the draft matches the target argmax; the first
      mismatch emits the target argmax instead; full acceptance emits the
      bonus argmax of the last row.
    * temperature: accept d_i with probability min(1, p_i(d_i)/q_i(d_i));
      on the first rejection sample the residual norm(max(p−q, 0)); on full
      acceptance sample the bonus row.
    """
    emitted: List[int] = []
    if sample == "greedy":
        for i, d in enumerate(draft):
            t = int(rows[i].argmax())
            emitted.append(t)
            if t != int(d):
                return i, emitted
        emitted.append(int(rows[len(draft)].argmax()))
        return len(draft), emitted

    def gen(i: int, stream: int) -> torch.Generator:
        return stream_generator(seed, seq_id, start_index + i, stream)

    for i, d in enumerate(draft):
        d = int(d)
        p = _softmax(rows[i] / temperature)
        if draft_q is None:
            q_d = 1.0                    # deterministic drafter: one-hot q
            q = np.zeros_like(p)
            q[d] = 1.0
        else:
            q = draft_q[i]
            q_d = float(q[d])
        u = float(torch.rand((), generator=gen(i, 0), dtype=torch.float64))
        if q_d > 0 and u < float(p[d]) / q_d:
            emitted.append(d)
            continue
        residual = np.maximum(p - q, 0.0)
        z = residual.sum()
        r = residual / z if z > 0 else p     # q ⊇ p: degenerate, resample p
        emitted.append(_categorical(r, gen(i, 1)))
        return i, emitted
    g = len(draft)
    emitted.append(_categorical(_softmax(rows[g] / temperature), gen(g, 1)))
    return g, emitted
