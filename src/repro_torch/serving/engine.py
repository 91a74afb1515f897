"""Serving engine: continuous batching over the paged KV pool, and the
dense-slab loop.

Port of ``repro/serving/engine.py``. Each
:meth:`ContinuousBatchingEngine.step`:

1. admits the next queued request once the prefill lane is clear, sharing
   the pages of any registered prompt prefix (refcounted, copy-on-write) and
   reserving only the remainder;
2. advances the head prefill by one **chunk**: the chunk's KV is written
   straight into the sequence's pages and attends over the cached prefix
   through the paged-prefill kernel (K2);
3. runs **one ragged decode** over every active sequence: per-sequence
   positions and block tables, attention through the paged decode kernel
   (K3); every projection goes through the fused w8a8 GEMM (K1) when the
   weights are quantized;
4. retires sequences that hit their token budget and decrefs their pages.

Pages are int8 with per-token scales for ``kv_dtype='int8'``, else the
model dtype; float pages take the plain attention versions, as in the
reference (K2 and K3 read int8 pages).

A sequence decodes identically alone or inside a changing batch: pages are
owned exclusively or shared immutably, per-token scales depend only on a
token's own values, attention is masked per sequence, chunk boundaries
depend only on the engine's chunk size, and temperature sampling draws each
token's noise from a generator seeded by (engine seed, seq_id, token index).

**The dense-slab path** (:func:`build_prefill_step`,
:func:`build_decode_step`, :func:`_generate_dense`) prefills the whole
batch into a (B, max_len) :class:`~repro_torch.serving.kv_cache.
DenseKVCache` slab (float, or int8 with per-page scales) and decodes one
token per step at a shared position; Mamba and RWKV layers carry their
recurrent state there, beside the attention slabs. :func:`generate` sends
models with recurrent mixers or embedding inputs there, as the reference
does.

**Speculative decoding** (``spec=``, a
:class:`~repro_torch.serving.spec_decode.SpecConfig` with method 'ngram'
or 'draft'): the decode lane runs draft–verify steps instead of the ragged
decode. Per active sequence the drafter proposes up to γ tokens, the panel
[last token, drafts] is written into the sequence's pages (each touched
page crossing the COW barrier) and scored by ONE forward through the
chunked paged-prefill path (K2 at C = γ+1, any ``q_start``; K1/K4 at
M = γ+1), exact acceptance keeps the agreed prefix and
:meth:`~repro_torch.serving.kv_cache.PagePool.truncate` rolls the rest
back. Greedy speculative streams equal non-speculative ones; temperature
streams keep the target distribution. The verify forwards run one
sequence at a time, as in the reference. ``gamma='auto'`` re-picks the
window from the measured acceptance rate every ``SPEC_RETUNE_EVERY``
steps (:mod:`repro_torch.core.autotune`).

The engine's page size, prefill chunk and pages per kernel step come
from the autotune (:func:`repro_torch.core.autotune.get_page_size`: K3
timed on the card, an analytic H100 model on the CPU; and
:func:`~repro_torch.core.autotune.get_prefill_params`: the model) unless
the caller gives them, as in the reference. :func:`warm_gemm_autotune` measures the
integer GEMMs' launch plans at a model's serving shapes before it serves.

**Tensor parallelism** (``mesh=``, this rank's
:class:`~repro_torch.launch.mesh.RankMesh` of shape (1, tp)): the engine
runs as SPMD, one process a rank, each rank constructing the same engine on the same
requests. It keeps this rank's shards of the params
(:func:`~repro_torch.parallel.sharding.shard_params`; a
:class:`~repro_torch.parallel.sharding.RankShards` tree is taken as it
is), its kv heads of every page (``PagePool(mesh=)``), and runs every
target forward inside a ``mode='serve'`` mesh context: column-parallel
q/kv/gate/up, K2/K3 over the rank's heads, row-parallel wo/down with an
f32 or (``tp_int8_reduce``) int8-wire all-reduce, every expert's gate/up
columns and down rows (the down projection quantized with the whole
row's scale, one reduce a layer after the combine: :mod:`repro_torch.
models.moe`), a vocabulary-sharded embedding and head. The scheduler
state is replicated; rank 0's sampled
tokens are broadcast every step, and the page size, chunk and pages per
step are picked once, by rank 0, and broadcast. ``self.tp`` is the
degree attention gets (1 when the model axis does not divide the kv
heads: attention then runs replicated, the MLP and head still sharded).
A speculative engine verifies under the mesh and drafts replicated, each
rank holding the whole draft model; rank 0's draft ids and verdict are
broadcast, so every rank's cache holds the KV of the same tokens.
:func:`warm_gemm_autotune` with
``tp=`` tunes the shard shapes. :func:`generate` under a mesh runs the
recurrent and embedding-input models on the dense slab on this rank's
shards (:func:`slab_context`), as the reference's ``serve`` places them
under the serve rules and GSPMD runs them; :func:`build_prefill_step` and
:func:`build_decode_step` run the same way under the prefill / decode
rules on a (data, model) mesh (rows over data, the KV slab by kv heads or
by positions over model, the MoE slab by expert over data).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import autotune
from repro_torch.device import resolve_device
from repro_torch.kernels.camp_gemm_fused import KIND as QMODE_KIND
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import expert_capacity, routing_group_size
from repro_torch.models.transformer import dtype_of, forward, init_caches
from repro_torch.parallel.collectives import broadcast_ints, gather_blocks
from repro_torch.parallel.sharding import (RankShards, batch_block,
                                           block_shape, cache_pspecs,
                                           effective_model_shards,
                                           make_rules, mesh_context,
                                           runs_dense_slab, shard_params)
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving import spec_decode as sd


def init_serve_caches(cfg: ModelConfig, batch: int, max_len: int,
                      kv_dtype: Optional[str] = None, device=None, *,
                      mesh=None, rules=None) -> list:
    """Dense KV and recurrent-state caches; ``kv_dtype='int8'`` stores
    attention KV quantized with per-page dynamic scales (see
    :mod:`repro_torch.serving.kv_cache`).

    Under ``mesh``: this rank's blocks of the caches of the global
    ``batch``, placed by :func:`~repro_torch.parallel.sharding.
    cache_pspecs` under ``rules`` (default the serve rules): the rows
    over data (the prefill / decode rules), a KV slab's kv heads over
    model where it divides them, else its positions (the prefill / decode
    rules; ``DenseKVCache.rank_block``), the Mamba state and conv window
    by d_inner and the WKV state by heads."""
    if mesh is None:
        return init_caches(cfg, batch, max_len, kv_dtype=kv_dtype,
                           device=device)
    device = resolve_device(device)
    whole = init_caches(cfg, batch, max_len, kv_dtype=kv_dtype,
                        device="meta")
    specs = cache_pspecs(whole, rules or make_rules("serve"), mesh)

    def block(node, spec):
        if isinstance(node, dict):
            return {k: block(v, spec[k]) for k, v in node.items()}
        if isinstance(node, kvc.DenseKVCache):
            return node.rank_block(spec, mesh, device)
        return torch.zeros(block_shape(node.shape, spec, mesh),
                           dtype=node.dtype, device=device)

    return [block(c, s) for c, s in zip(whole, specs)]


def serving_gemm_shapes(cfg: ModelConfig, *, batch_sizes=(1, 8, 32),
                        prefill_len: int = 0, tp: int = 1,
                        spec_gammas=()) -> set:
    """{(fused, m, n, k)}: the integer GEMMs :func:`warm_gemm_autotune`
    tunes for ``cfg``.

    Decode runs one token a sequence (M = batch) and prefill M = batch ×
    prompt_len, over the same (K, N) weights: attention q/kv/out, the
    dense MLP's up/gate and down, the MoE experts' up/gate and down at the
    **expert-capacity M** (groups × capacity, as :mod:`repro_torch.models.
    moe` launches them) and the untied lm head, all fused (K1, K4).
    Mixer-specific projections (Mamba, RWKV) are not covered.

    ``tp > 1`` gives the tensor-parallel shard shapes instead: column-
    parallel projections run (m, n/tp, k) a rank and the row-parallel
    out and down projections (m, n, k/tp); the experts' down projection
    then runs unfused (K7, then K5 / K6a / K6b at (m, d, expert_ff/tp):
    the whole row's scale, ``moe._down_partial``).

    ``spec_gammas`` adds the speculative verify panels: each width
    M ∈ [2, γ+1] (drafters often propose fewer than γ tokens).
    """
    d, hd = cfg.d_model, cfg.hd

    def shard(k, n, *, row_parallel):
        """Local (K, N) of one device's GEMM under tp-way model sharding."""
        if tp <= 1:
            return (k, n)
        if row_parallel:
            return (k // tp, n) if k % tp == 0 else (k, n)
        return (k, n // tp) if n % tp == 0 else (k, n)

    proj = {
        shard(d, hd * cfg.n_heads, row_parallel=False),     # q proj
        shard(d, hd * cfg.n_kv_heads, row_parallel=False),  # kv proj
        shard(hd * cfg.n_heads, d, row_parallel=True),      # attn out
        shard(d, cfg.d_ff, row_parallel=False),             # mlp up/gate
        shard(cfg.d_ff, d, row_parallel=True),              # mlp down
    }
    if not cfg.tie_embeddings:
        proj.add(shard(d, cfg.vocab_size, row_parallel=False))  # lm head
    ms = sorted({b * max(prefill_len, 1) for b in batch_sizes}
                | set(batch_sizes)
                | {m for g in spec_gammas for m in range(2, g + 2)})
    shapes = {(True, m, n, k) for m in ms for (k, n) in proj}
    if cfg.moe_experts:
        # expert GEMMs run at M = groups × capacity, not M = tokens
        gate = shard(d, cfg.expert_ff, row_parallel=False)
        down = shard(cfg.expert_ff, d, row_parallel=True)
        down_fused = down == (cfg.expert_ff, d)
        for m in ms:
            sg = routing_group_size(m)
            em = max((m // sg) * expert_capacity(sg, cfg), 1)
            shapes |= {(True, em, gate[1], gate[0]),
                       (down_fused, em, down[1], down[0])}
    return shapes


def warm_gemm_autotune(cfg: ModelConfig, *, batch_sizes=(1, 8, 32),
                       prefill_len: int = 0, measure=None, tp: int = 1,
                       spec_gammas=()):
    """Tune the integer GEMMs' launch plans at the transformer's serving
    shapes (:func:`serving_gemm_shapes`), so the request path finds them
    in the cache. Measured on the card, analytic on the CPU (``measure``
    as in :func:`repro_torch.core.autotune.tune`). Shapes already in the
    cache are skipped, so no shape is tuned twice.

    Returns [((m, n, k), plan), ...] for the shapes tuned now.
    """
    kind = QMODE_KIND.get(cfg.qmode)
    if kind is None:  # 'none' / weight-only: float matmul, nothing to tune
        return []
    a_in_bytes = dtype_of(cfg).itemsize      # x's type on the request path
    out = []
    for fused, m, n, k in sorted(serving_gemm_shapes(
            cfg, batch_sizes=batch_sizes, prefill_len=prefill_len, tp=tp,
            spec_gammas=spec_gammas), key=lambda s: (*s[1:], s[0])):
        if autotune.has_cached(kind, m, n, k, fused=fused,
                               a_in_bytes=a_in_bytes):
            continue           # an earlier warmup already paid for it
        plan = autotune.tune(kind, m, n, k, fused=fused,
                             a_in_bytes=a_in_bytes, measure=measure,
                             save=False)
        out.append(((m, n, k), plan))
    autotune.flush()           # one disk write for the whole warmup
    return out


def build_prefill_step(cfg: ModelConfig, *, impl: str = "auto"):
    """(params, inputs, caches) → (last-position logits (B, V), caches)."""

    def prefill_step(params, inputs, caches):
        logits, caches, _ = forward(params, cfg, inputs, caches=caches,
                                    last_logits_only=True, impl=impl)
        return logits[:, -1], caches

    return prefill_step


def _gumbel_argmax(logits: torch.Tensor, temperature: float,
                   generator: torch.Generator) -> torch.Tensor:
    """One categorical sample per row of ``logits / temperature``
    (Gumbel-max), the noise drawn from ``generator`` on its own device."""
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).clamp_(min=1e-20)
    gumbel = -torch.log(-torch.log(u))
    return (logits / temperature + gumbel.to(logits.device)).argmax(dim=-1)


def build_decode_step(cfg: ModelConfig, *, sample: str = "greedy",
                      temperature: float = 1.0, impl: str = "auto"):
    """(params, caches, token, pos, generator) → (next token, caches).

    ``token``: (B, 1) long; ``pos``: the current position (int). Temperature
    sampling needs an explicit ``torch.Generator``; it matches the
    reference's ``jax.random`` draws in distribution only.
    """
    if sample not in ("greedy", "temperature"):
        raise ValueError(f"sample={sample!r}")

    def decode_step(params, caches, token, pos, generator=None):
        logits, caches, _ = forward(params, cfg, token, caches=caches,
                                    cache_pos=pos, impl=impl)
        last = logits[:, -1].float()
        if sample == "greedy":
            nxt = last.argmax(dim=-1)
        else:
            nxt = _gumbel_argmax(last, temperature, generator)
        return nxt[:, None], caches

    return decode_step


@dataclasses.dataclass
class Request:
    """One in-flight generation request."""
    seq_id: int
    prompt: torch.Tensor                 # (S,) long, on the engine's device
    max_new_tokens: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0                         # prompt tokens cached so far
    spec: sd.SpecStats = dataclasses.field(default_factory=sd.SpecStats)

    def __post_init__(self):
        # host-side token tuple: prefix-trie keys without device round-trips
        self.prompt_tokens = tuple(self.prompt.tolist())

    @property
    def reserve_tokens(self) -> int:
        return int(self.prompt.shape[0]) + self.max_new_tokens


class ContinuousBatchingEngine:
    """Admit/finish sequences mid-flight over a shared paged KV pool.

    A request is admitted only when the pool can reserve its worst-case page
    count (prompt + max_new_tokens, minus the prefix pages the trie lookup
    shares), so an admitted sequence never stalls mid-decode. One prefill is
    in flight at a time, so a burst of same-prefix prompts shares the pages
    the first one writes. Pages are int8 for ``kv_dtype='int8'``, else the
    model dtype. ``impl`` selects the kernels or the plain versions (see
    :mod:`repro_torch.kernels.ops`); ``device`` defaults to the card.
    ``spec`` turns on speculative decoding (module docstring); a draft
    model runs on the engine's device with the engine's ``impl``.
    ``mesh`` (this rank's serving mesh), ``rules`` (default: the serve
    table) and ``tp_int8_reduce`` turn on tensor-parallel serving (module
    docstring); ``params`` are then the full tree (this rank keeps its
    shards) or this rank's :class:`RankShards`.
    """

    SPEC_RETUNE_EVERY = 16               # spec steps between auto-γ re-picks

    def __init__(self, params, cfg: ModelConfig, *,
                 kv_dtype: Optional[str] = "int8",
                 page_size: Optional[int] = None,
                 capacity_tokens: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 pages_per_step: Optional[int] = None,
                 sample: str = "greedy", temperature: float = 1.0,
                 seed: int = 0, retain_pages: Optional[int] = None,
                 mesh=None, rules=None, tp_int8_reduce: bool = False,
                 spec: Optional[sd.SpecConfig] = None,
                 device=None, impl: str = "auto"):
        mixers = {cfg.mixer_of(i) for i in range(cfg.n_layers)}
        if mixers != {"attn"}:
            raise ValueError(
                f"continuous batching requires attention mixers, got {mixers}")
        if sample not in ("greedy", "temperature"):
            raise ValueError(f"sample={sample!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sample, self.temperature, self.seed = sample, temperature, seed
        self.impl = impl
        self.mesh = mesh
        self.rules = rules if rules is not None else (
            make_rules("serve") if mesh is not None else None)
        self.tp_int8_reduce = tp_int8_reduce
        # the sharding degree attention and the pool get (replicated
        # attention where the model axis does not divide the kv heads)
        self.tp = effective_model_shards(mesh, cfg.n_kv_heads)
        if mesh is not None and not isinstance(params, RankShards):
            params = shard_params(params, mesh, cfg, self.rules)
        if mesh is not None and "attn_cols" in params.layout:
            raise ValueError("the paged engine runs attention the model "
                             "axis does not divide on whole weights; these "
                             "shards were cut for the dense slab")
        self.params = params
        ps, prefill_chunk, pages_per_step = self._pick_pages(
            page_size, prefill_chunk, pages_per_step)
        # non-final chunks cover whole pages, so a partial page is quantized
        # exactly once (by the final chunk)
        self.chunk_tokens = max(ps, prefill_chunk - prefill_chunk % ps)
        self.pages_per_step = pages_per_step or 1
        capacity_tokens = capacity_tokens or 8 * cfg.max_seq_len
        self.pool = kvc.PagePool(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            num_pages=-(-capacity_tokens // ps), page_size=ps,
            quantized=(kv_dtype == "int8"), dtype=dtype_of(cfg),
            mesh=mesh if self.tp > 1 else None, retain_pages=retain_pages,
            device=self.device)
        self.waiting: collections.deque = collections.deque()
        self.prefilling: collections.deque = collections.deque()
        self.active: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._next_id = 0
        # -- speculative decoding ---------------------------------------
        self.spec_cfg = spec if spec is not None and spec.method != "off" \
            else None
        self.drafter = None
        self.spec_totals = sd.SpecStats()
        if self.spec_cfg is not None:
            self.drafter = sd.make_drafter(
                self.spec_cfg, sample=sample, temperature=temperature,
                seed=seed * 1_000_003 + sd.DRAFT_SEED_SALT,
                device=self.device, impl=impl)
            self._spec_auto = self.spec_cfg.gamma == "auto"
            self._spec_last_tune = 0
            self.spec_gamma = (autotune.DEFAULT_SPEC_GAMMA if self._spec_auto
                               else int(self.spec_cfg.gamma))
            if self.spec_gamma < 1:
                raise ValueError(f"spec gamma {self.spec_gamma} < 1")

    def _pick_pages(self, page_size, prefill_chunk, pages_per_step):
        """Page size, prefill chunk and pages per step: the caller's, else
        the autotune's (the page timed through K3 on the card, the chunk
        from the analytic model). Under a mesh rank 0 picks and broadcasts
        them: ranks timing K3 at once on one card could pick apart."""
        cfg = self.cfg
        if page_size and prefill_chunk:
            return page_size, prefill_chunk, pages_per_step
        picks = [0, 0, 0]
        if self.mesh is None or self.mesh.rank == 0:
            mean_len = max(cfg.max_seq_len // 2, 128)
            ps = page_size or autotune.get_page_size(
                cfg.n_kv_heads, cfg.hd, mean_len=mean_len,
                group=cfg.n_heads // cfg.n_kv_heads)
            chunk = prefill_chunk
            if chunk is None:
                chunk, pp = autotune.get_prefill_params(
                    cfg.n_kv_heads, cfg.hd, ps, mean_len=mean_len)
                pages_per_step = pages_per_step or pp
            picks = [ps, chunk, pages_per_step or 0]
        if self.mesh is not None:
            picks = broadcast_ints(picks, self.mesh)
        return picks[0], picks[1], picks[2] or None

    def _mesh_scope(self):
        """Serve-mode mesh context for one target forward (a no-op without
        a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return mesh_context(self.mesh, self.rules, mode="serve",
                            opts={"tp_int8_reduce": self.tp_int8_reduce},
                            layout=self.params.layout)

    def _agree(self, values: List[int]) -> List[int]:
        """Rank 0's ``values`` on every rank (as they are without a mesh):
        the replicated scheduler must see one token stream."""
        return values if self.mesh is None else broadcast_ints(values,
                                                               self.mesh)

    # -- request lifecycle ----------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> int:
        """Queue a prompt; returns its sequence id."""
        prompt = torch.as_tensor(prompt).reshape(-1).to(self.device,
                                                         torch.long)
        seq_id = self._next_id
        self._next_id += 1
        self.waiting.append(Request(seq_id, prompt, max_new_tokens))
        return seq_id

    def _sample_tokens(self, logits: torch.Tensor,
                       reqs: List[Request]) -> List[int]:
        """logits (B, V) → B token ids; rows align with ``reqs``.

        Temperature sampling is Gumbel-max with noise from a CPU generator
        seeded by (engine seed, seq_id, token index), never from a shared
        stream: a token does not depend on which other sequences share the
        batch, nor on the device.
        """
        last = logits.float()
        if self.sample == "greedy":
            return self._agree(last.argmax(dim=-1).tolist())
        out = []
        for row, r in zip(last, reqs):
            gen = torch.Generator().manual_seed(
                (self.seed * 1_000_003 + r.seq_id) * 1_000_003 + len(r.tokens))
            out.append(int(_gumbel_argmax(row, self.temperature, gen)))
        return self._agree(out)

    def _finish(self, req: Request) -> None:
        self.pool.release(req.seq_id)
        if self.drafter is not None:
            self.drafter.release(req.seq_id)
        self.finished[req.seq_id] = req

    def _admit(self) -> None:
        """Admit the next queued request once the prefill lane is clear."""
        while self.waiting and not self.prefilling:
            nxt: Request = self.waiting[0]
            if not self.pool.can_reserve(nxt.reserve_tokens,
                                         prompt=nxt.prompt_tokens):
                if not self.active:
                    raise RuntimeError(
                        f"request {nxt.seq_id} needs "
                        f"{self.pool.pages_for(nxt.reserve_tokens)} pages; "
                        f"pool has {self.pool.num_pages} total")
                break
            self.waiting.popleft()
            nxt.pos = self.pool.reserve(nxt.seq_id, nxt.reserve_tokens,
                                        prompt=nxt.prompt_tokens)
            self.prefilling.append(nxt)

    def _prefill_step(self) -> None:
        """Advance the head prefill by up to ``chunk_tokens`` prompt tokens;
        the final chunk registers the prompt's full pages in the prefix trie
        and moves the request to the decode lane."""
        budget = self.chunk_tokens
        while budget > 0 and self.prefilling:
            req: Request = self.prefilling[0]
            s = int(req.prompt.shape[0])
            remaining = s - req.pos
            chunk = min(budget, remaining)
            if chunk < remaining:
                chunk -= chunk % self.pool.page_size
                if chunk == 0:
                    break        # leftover budget smaller than one page
            last = req.pos + chunk == s
            logits = sd.paged_chunk_forward(
                self.params, self.cfg, self.pool, req.seq_id,
                req.prompt[req.pos:req.pos + chunk], req.pos,
                pages_per_step=self.pages_per_step,
                logits="last" if last else "none", impl=self.impl)
            req.pos += chunk
            budget -= chunk
            if not last:
                continue
            self.prefilling.popleft()
            self.pool.register_prefix(req.seq_id, req.prompt_tokens)
            req.tokens.append(self._sample_tokens(logits[:, -1], [req])[0])
            if len(req.tokens) >= req.max_new_tokens:
                self._finish(req)
            else:
                self.active.append(req)

    def _decode(self) -> None:
        """One ragged decode step over all active sequences."""
        reqs = list(self.active)
        ps = self.pool.page_size
        for r in reqs:
            # COW barrier: the page this append touches must be exclusive
            self.pool.ensure_writable(r.seq_id, self.pool.lens[r.seq_id] // ps)
        tokens = torch.tensor([[r.tokens[-1]] for r in reqs], dtype=torch.long,
                              device=self.device)
        tables, lengths = self.pool.batch_tables([r.seq_id for r in reqs])
        caches = [{"attn": self.pool.layer_cache(i, tables, lengths)}
                  for i in range(self.cfg.n_layers)]
        logits, new_caches, _ = forward(self.params, self.cfg, tokens,
                                        positions=lengths[:, None].long(),
                                        caches=caches, impl=self.impl)
        for i, layer in enumerate(new_caches):
            self.pool.writeback(i, layer["attn"])
        for r in reqs:
            self.pool.lens[r.seq_id] += 1
        nxt = self._sample_tokens(logits[:, -1], reqs)
        self.active = []
        for r, t in zip(reqs, nxt):
            r.tokens.append(t)
            if len(r.tokens) >= r.max_new_tokens:
                self._finish(r)
            else:
                self.active.append(r)

    # -- speculative decode lane -----------------------------------------
    def _spec_verify(self, req: Request, draft: List[int]) -> np.ndarray:
        """Score [last_sampled] + draft in one forward over the paged cache.

        The panel's KV is written into the sequence's pages first (each
        touched page crosses the COW barrier), then the γ+1-token query
        attends over the whole cached prefix through the chunked
        paged-prefill path, from wherever decode left off, page-aligned or
        not. Returns the (γ+1, V) f32 logit rows on the host (the step's one
        copy); the caller rolls the rejected suffix back with
        ``pool.truncate``.
        """
        L = self.pool.lens[req.seq_id]
        m = 1 + len(draft)
        ps = self.pool.page_size
        for pidx in range(L // ps, (L + m - 1) // ps + 1):
            self.pool.ensure_writable(req.seq_id, pidx)
        with self._mesh_scope():
            logits = sd.paged_chunk_forward(
                self.params, self.cfg, self.pool, req.seq_id,
                [req.tokens[-1]] + draft, L,
                pages_per_step=self.pages_per_step, logits="all",
                impl=self.impl)
        return logits[0].float().cpu().numpy()

    def _spec_one(self, req: Request) -> None:
        """One draft–verify–rollback step for one active sequence."""
        remaining = req.max_new_tokens - len(req.tokens)
        gamma = min(self.spec_gamma, remaining - 1)
        draft, draft_q = ([], None)
        # the draft reservation covers the largest window auto-tuning
        # could pick
        gamma_cap = max(self.spec_gamma, max(autotune.SPEC_GAMMAS))
        if gamma > 0:
            # drafting runs replicated, outside the mesh: every rank holds
            # the whole draft model
            draft, draft_q = self.drafter.propose(
                req.seq_id, list(req.prompt_tokens) + req.tokens, gamma,
                reserve_tokens=req.reserve_tokens + gamma_cap + 1)
            if self.mesh is not None:
                # every rank verifies (and writes the KV of) rank 0's
                # draft, at a fixed width; a rank whose own draft differed
                # scores it as a deterministic one (its verdict is
                # replaced by rank 0's below)
                got = self._agree([len(draft)] + draft
                                  + [-1] * (gamma - len(draft)))
                if got[1:got[0] + 1] != draft:
                    draft, draft_q = got[1:got[0] + 1], None
        L = self.pool.lens[req.seq_id]
        rows = self._spec_verify(req, draft)
        n_acc, emitted = sd.accept_speculative(
            rows, draft, draft_q, sample=self.sample,
            temperature=self.temperature, seed=self.seed, seq_id=req.seq_id,
            start_index=len(req.tokens))
        if self.mesh is not None:      # rank 0's verdict, at a fixed width
            got = self._agree([n_acc] + emitted
                              + [-1] * (gamma_cap + 1 - len(emitted)))
            n_acc, emitted = got[0], got[1:got[0] + 2]
        # the cache must hold everything but the last emitted token
        self.pool.truncate(req.seq_id, L + n_acc + 1)
        req.tokens.extend(emitted)
        req.spec.add(len(draft), n_acc, len(emitted))
        self.spec_totals.add(len(draft), n_acc, len(emitted))
        if len(req.tokens) >= req.max_new_tokens:
            self._finish(req)
        else:
            self.active.append(req)

    def _spec_step(self) -> None:
        """Draft–verify every active sequence (replaces the ragged decode)."""
        reqs = list(self.active)
        self.active = []
        for r in reqs:
            self._spec_one(r)
        if (self._spec_auto and self.spec_totals.steps
                - self._spec_last_tune >= self.SPEC_RETUNE_EVERY):
            self._spec_last_tune = self.spec_totals.steps
            self.spec_gamma = autotune.get_spec_gamma(
                self.spec_totals.acceptance_rate,
                draft_cost=self.drafter.cost_ratio)

    def spec_summary(self) -> Dict:
        """Aggregate + per-request draft/verify stats (finished, active,
        prefilling and waiting requests, so mid-serve polling sees every
        sequence the aggregate counters cover)."""
        reqs = list(self.finished.values()) + self.active \
            + list(self.prefilling) + list(self.waiting)
        per = {r.seq_id: r.spec.summary()
               for r in sorted(reqs, key=lambda r: r.seq_id)}
        out = self.spec_totals.summary()
        out.update(enabled=self.drafter is not None,
                   gamma=self.spec_gamma if self.drafter is not None else 0,
                   per_request=per)
        return out

    # -- driving ---------------------------------------------------------
    def step(self) -> bool:
        """Admit what fits, one prefill chunk, one ragged decode step (or,
        with a drafter, one draft–verify step per active sequence).
        Returns True while work remains."""
        self._admit()
        if self.prefilling:
            with self._mesh_scope():
                self._prefill_step()
        if self.active:
            if self.drafter is not None:
                self._spec_step()        # only the verify runs in the mesh
            else:
                with self._mesh_scope():
                    self._decode()
        return bool(self.active or self.waiting or self.prefilling)

    def run(self) -> Dict[int, List[int]]:
        """Drain all queued/active requests; {seq_id: generated tokens}."""
        while self.step():
            pass
        return {sid: list(r.tokens) for sid, r in self.finished.items()}


# ---------------------------------------------------------------------------
# Batched generation entry points
# ---------------------------------------------------------------------------
def slab_context(mesh, layout, rules=None):
    """The dense slab's mesh context (``mode="dense"``) for a rank
    holding the params of ``layout`` (a :class:`RankShards` tree's) under
    ``rules`` (default the serve rules; ``make_rules("prefill" |
    "decode")`` the reference's dense-slab TP). :func:`build_prefill_step`
    and :func:`build_decode_step` run inside it on this rank's shards, its
    rows (:func:`~repro_torch.parallel.sharding.batch_block`) and its
    caches (:func:`init_serve_caches` ``(mesh=, rules=)``)."""
    return mesh_context(mesh, rules or make_rules("serve"), mode="dense",
                        layout=layout)


def slab_shards(params, mesh, cfg: ModelConfig, rules=None) -> RankShards:
    """This rank's shards of a whole params tree for the dense slab:
    :func:`~repro_torch.parallel.sharding.shard_params` inside its mesh
    context, so attention whose kv heads the model axis does not divide
    takes the reference's column blocks (the ``"attn_cols"`` part)
    whatever the config, as it does for every config :func:`generate`
    sends to the dense slab."""
    with mesh_context(mesh, rules or make_rules("serve"), mode="dense"):
        return shard_params(params, mesh, cfg, rules)


def _generate_dense(params, cfg: ModelConfig, prompt: torch.Tensor, *,
                    steps: int, seed: int = 0, sample: str = "greedy",
                    temperature: float = 1.0, max_len: Optional[int] = None,
                    kv_dtype: Optional[str] = None, mesh=None, device=None,
                    impl: str = "auto") -> torch.Tensor:
    """The dense-slab loop: prompt (B, S) token ids, or (B, S, D) float
    embeddings for a model with ``embedding_inputs`` → (B, steps) new
    tokens (on the CPU). The whole batch prefills at once into (B,
    max_len) slabs and recurrent states, then decodes one token per step
    at the shared position S + i, the generated ids fed back through the
    embedding table, as in the reference. The first token is greedy, as
    in the reference; decode step i samples with a generator seeded by
    (seed, i).

    Under ``mesh`` a rank holds its shards of the params under the serve
    rules (a whole tree is cut by :func:`slab_shards`; a
    :class:`RankShards` tree is taken as it is), its
    blocks of the caches, and runs the loop in :func:`slab_context`, where
    GSPMD's meaning holds: the row-parallel projections take the whole
    row's scale. The ranks along the model axis feed back rank 0's tokens
    (broadcast each step), so their streams agree under temperature
    sampling too; a data axis splits the rows, gathered at the end."""
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt).to(device)
    if not prompt.is_floating_point():
        prompt = prompt.long()
    b, s = prompt.shape[:2]
    rules = make_rules("serve")
    scope = contextlib.nullcontext()
    if mesh is not None:
        if not isinstance(params, RankShards):
            params = slab_shards(params, mesh, cfg, rules)
        scope = slab_context(mesh, params.layout, rules)
        prompt = batch_block(prompt, mesh, rules)
    caches = init_serve_caches(cfg, b, max_len or (s + steps),
                               kv_dtype=kv_dtype, device=device, mesh=mesh,
                               rules=rules)
    prefill = build_prefill_step(cfg, impl=impl)
    decode = build_decode_step(cfg, sample=sample, temperature=temperature,
                               impl=impl)

    def agree(tok):
        if mesh is None:
            return tok
        return torch.tensor(broadcast_ints(tok.reshape(-1).tolist(), mesh),
                            dtype=tok.dtype, device=tok.device
                            ).reshape(tok.shape)
    with scope:
        last, caches = prefill(params, prompt, caches)
        tok = agree(last.float().argmax(dim=-1)[:, None])
        out = [tok]
        for i in range(steps - 1):
            gen = None
            if sample != "greedy":
                gen = torch.Generator().manual_seed(seed * 1_000_003 + i)
            tok, caches = decode(params, caches, tok, s + i, gen)
            tok = agree(tok)
            out.append(tok)
    out = torch.cat(out, dim=1)
    if mesh is not None and mesh.shape["data"] > 1:
        out = torch.cat(gather_blocks(out, mesh, "data"))
    return out.cpu()


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, *, steps: int,
             seed: int = 0, sample: str = "greedy", temperature: float = 1.0,
             max_len: Optional[int] = None, kv_dtype: Optional[str] = None,
             page_size: Optional[int] = None,
             prefill_chunk: Optional[int] = None,
             retain_pages: Optional[int] = None, mesh=None,
             tp_int8_reduce: bool = False,
             spec: Optional[sd.SpecConfig] = None, device=None,
             impl: str = "auto") -> torch.Tensor:
    """Batched generation: prompt (B, S) → (B, steps) new tokens (on the
    CPU). All-attention models run on the continuous-batching engine (pages
    int8 for ``kv_dtype='int8'``, else the model dtype; ``spec`` turns on
    speculative decoding; ``mesh`` and ``tp_int8_reduce`` tensor-parallel
    serving, every rank calling with the same arguments); models with
    recurrent mixers or embedding inputs (a float (B, S, D) prompt) take
    the dense-slab loop, as in the reference (``max_len`` is that loop's
    slab length; ``spec`` is ignored there, since speculation needs the
    paged cache's rollback). Under ``mesh`` those run on this rank's
    shards of the params and caches (:func:`_generate_dense`), as the
    reference's ``serve`` places them and GSPMD runs them, with rank 0's
    tokens broadcast each step; ``tp_int8_reduce`` is the paged engine's
    (GSPMD's dense slab has no int8 wire)."""
    b, s = prompt.shape[:2]
    if runs_dense_slab(cfg):
        return _generate_dense(params, cfg, prompt, steps=steps, seed=seed,
                               sample=sample, temperature=temperature,
                               max_len=max_len, kv_dtype=kv_dtype, mesh=mesh,
                               device=device, impl=impl)
    ps = page_size or kvc.DEFAULT_PAGE_SIZE
    eng = ContinuousBatchingEngine(
        params, cfg, kv_dtype=kv_dtype, page_size=ps,
        capacity_tokens=b * kvc.round_up(s + steps, ps),
        prefill_chunk=prefill_chunk, sample=sample, temperature=temperature,
        seed=seed, retain_pages=retain_pages, mesh=mesh,
        tp_int8_reduce=tp_int8_reduce, spec=spec, device=device, impl=impl)
    sids = [eng.submit(prompt[i], steps) for i in range(b)]
    outs = eng.run()
    return torch.tensor([outs[sid] for sid in sids], dtype=torch.long)
