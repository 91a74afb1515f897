"""GQA attention with rope / qk-norm / qkv-bias, the dense KV slab, the
paged KV pool and q-chunked prefill.

Port of ``repro/models/attention.py``:

* cache None              → full causal self-attention (``_grouped_attn``).
* DenseKVCache, S > 1     → prefill from position 0: attend, and fill the
  slab's positions [0, S).
* DenseKVCache, S = 1     → decode: append at ``cache_pos``, attend over
  the slab's first ``cache_pos + 1`` positions.
* PagedPrefillCache       → chunked paged prefill: the chunk's KV is
  written into the sequence's pages, then causal attention over every
  cached page through the paged-prefill kernel (K2; float pages take the
  plain version).
* PagedDecodeCache, S = 1 → ragged decode: append one token per sequence,
  then the paged decode kernel (K3; float pages take the plain version).

Causal attention without a cache read runs q-chunked when
``cfg.attn_q_chunk`` is set: each chunk of queries attends to the full KV,
exact and without online-softmax state; peak memory is proportional to
chunk × T instead of T × T.

Grouped computation never repeats KV heads: q is viewed as (B, S, KV, G,
hd).

Under a serving mesh whose layout shards the heads (the model axis
divides the kv heads: ``effective_model_shards`` > 1), a rank holds its
column shards of wq/wk/wv (and their biases), so its projections yield
its own heads; the paged branches run K2/K3 over them through the ``_tp``
wrappers, the dense slab holds the rank's kv heads, and the out
projection is row-parallel (:func:`repro_torch.models.modules.row_linear`:
shard-local scales on the paged engine, the whole row's on the dense
slab) when the layout shards ``wo``, else the heads are gathered for the
whole ``wo``. Otherwise the paged engine runs attention replicated on
whole weights, and the dense slab holds the layout's ``"attn_cols"``
(the reference's specs, which split q/k/v by columns whatever the
heads): it runs every head from the rank's column blocks, each
projection's block of columns gathered whole (an all-gather over model),
and ``wo`` takes the rank's block of the attention output's columns as
its rows (:func:`~repro_torch.models.modules.row_linear`); every value
is one process's, bit for bit, in the integer modes.

**A sequence split in training.** Under the multi-pod train rules a rank
holds its block of positions (``parallel.fsdp.seq_split``): it projects
q/k/v on its block (rope at the global positions), gathers k and v over
``pod`` (``collectives.gather_seq``, whose backward sums the pods'
gradients of each block), and attends its own queries over the whole
sequence, q-chunked as before; only its block of the output reaches
``wo``. Each query row is the one one process computes.

**A sequence-split slab.** Under the dense slab's prefill / decode rules,
where the model axis does not divide the kv heads, each rank's
:class:`DenseKVCache` holds its block of positions (``start``, whole
pages of an int8 slab). Prefill attends over the fresh k/v, as the
reference does, and writes the positions the rank owns; a decode step
appends on the owner of ``cache_pos`` only, and
:func:`seq_split_attn` merges the ranks' partial softmaxes: a MAX
all-reduce of the row maxima, then one SUM all-reduce of the rescaled
denominators and numerators.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_tp)
from repro_torch.kernels.paged_prefill import (paged_prefill_attention,
                                               paged_prefill_attention_tp)
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import (apply_rope, linear, rms_norm,
                                        rope_freqs, row_linear)
from repro_torch.parallel.collectives import (all_gather_last, all_reduce,
                                              gather_seq)
from repro_torch.parallel.fsdp import seq_split
from repro_torch.parallel.sharding import dense_ctx, sharded, tp_mesh
from repro_torch.serving.kv_cache import (DEFAULT_PAGE_SIZE, DenseKVCache,
                                          PagedDecodeCache, PagedPrefillCache)

_NEG = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sc = d ** -0.5

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=device) * sc).to(dtype)

    p = {"wq": normal((d, h * hd)), "wk": normal((d, kv * hd)),
         "wv": normal((d, kv * hd)), "wo": normal((h * hd, d))}
    if cfg.qkv_bias:
        p["wq_bias"] = torch.zeros(h * hd, dtype=dtype, device=device)
        p["wk_bias"] = torch.zeros(kv * hd, dtype=dtype, device=device)
        p["wv_bias"] = torch.zeros(kv * hd, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    return p


def _grouped_attn(q, k, v, q_pos, k_pos, *, k_len=None):
    """q (B,S,KV,G,hd); k, v (B,T,KV,hd) → (B,S,KV,G,hd).

    Scores and softmax in f32; probabilities stored in q's dtype before the
    value product, as the reference does.
    """
    hd = q.shape[-1]
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) \
        * (hd ** -0.5)
    mask = q_pos[:, None] >= k_pos[None, :]                      # (S, T)
    if k_len is not None:
        mask = mask & (k_pos[None, :] < k_len)
    scores = torch.where(mask[None, None, None], scores,
                         torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v).to(q.dtype)


def seq_split_attn(q, k, v, q_pos, k_pos, *, k_len, mesh, axes,
                   drop_rank=None):
    """:func:`_grouped_attn` over a slab whose positions are split over
    the ranks along ``axes``: q (B,S,KV,G,hd) whole on every rank, k, v
    (B,T/n,KV,hd) this rank's block at positions ``k_pos``.

    Each rank scores its own positions (masked by ``k_len`` and
    causality) in f32; a MAX all-reduce gives every row's maximum; each
    rank's exponentials (the probabilities before their norm) are stored
    in q's dtype before the value product, as ``_grouped_attn`` stores the
    probabilities, and one SUM all-reduce adds the ranks' denominators
    and f32 numerators. The one-process result up to f32 rounding.
    ``drop_rank`` (a control) leaves that rank's partial out of the sum.
    """
    hd = q.shape[-1]
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) \
        * (hd ** -0.5)
    mask = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] < k_len)
    scores = torch.where(mask[None, None, None], scores,
                         torch.full_like(scores, _NEG))
    top = all_reduce(scores.amax(dim=-1, keepdim=True), mesh, axes,
                     op=dist.ReduceOp.MAX)
    ex = torch.exp(scores - top)
    num = torch.einsum("bkgst,btkh->bskgh", ex.to(q.dtype).float(),
                       v.float())
    den = ex.sum(dim=-1).permute(0, 3, 1, 2)                   # (B,S,KV,G)
    part = torch.cat([num.reshape(-1), den.reshape(-1)])
    if drop_rank is not None and mesh.rank == drop_rank:
        part = torch.zeros_like(part)
    part = all_reduce(part, mesh, axes)
    num, den = part.split([num.numel(), den.numel()])
    return (num.view(q.shape) / den.view(q.shape[:-1])[..., None]
            ).to(q.dtype)


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, cache=None,
              cache_pos: Optional[int] = None, qmode: str = "none",
              impl: str = "auto"):
    """x (B, S, D) → (y, new_cache); ``cache_pos``: the decode position of
    a one-token step over a DenseKVCache."""
    b, s, _ = x.shape
    h_all, kv_all, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h_all // kv_all
    # head-sharded TP applies when every kv shard holds whole head groups
    # (the layout's "heads"); h and kv are then this rank's heads
    mesh, tp = tp_mesh()
    head_tp = sharded("heads")
    cols = sharded("attn_cols")
    h, kv = (h_all // tp, kv_all // tp) if head_tp else (h_all, kv_all)

    def proj(name, heads):
        y = linear(x, p[name], p.get(name + "_bias"), qmode=qmode,
                   impl=impl)
        if cols and y.shape[-1] < heads * hd:        # this rank's columns
            y = all_gather_last(y, mesh)
        return y.reshape(b, s, heads, hd)

    q, k, v = proj("wq", h), proj("wk", kv), proj("wv", kv)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(positions, hd, cfg.rope_theta)         # (B,S,hd/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    def out_proj(out):
        rows = p["wo"].shape[0]
        if cols and rows < h * hd:                   # wo's row block
            r = mesh.coords["model"]
            return row_linear(out[..., r * rows:(r + 1) * rows], p["wo"],
                              qmode=qmode, impl=impl)
        if sharded("wo"):
            return row_linear(out, p["wo"], qmode=qmode, impl=impl)
        if head_tp:
            out = all_gather_last(out, mesh)         # wo kept whole
        return linear(out, p["wo"], qmode=qmode, impl=impl)

    if isinstance(cache, PagedPrefillCache):
        if b != 1:
            raise ValueError("paged prefill runs one sequence's chunk at a time")
        new_cache = cache.write_chunk(k.transpose(1, 2), v.transpose(1, 2))
        qp = q.reshape(s, kv, g, hd).permute(1, 0, 2, 3).contiguous()
        args = (qp, new_cache.k_pages, new_cache.v_pages, new_cache.k_scale,
                new_cache.v_scale, new_cache.table)
        kw = dict(q_start=new_cache.q_start,
                  pages_per_step=new_cache.pages_per_step, impl=impl)
        ctx = (paged_prefill_attention_tp(*args, mesh=mesh,
                                          n_kv_heads=kv_all, **kw)
               if head_tp else paged_prefill_attention(*args, **kw))
        out = ctx.permute(1, 0, 2, 3).reshape(1, s, h * hd)
        return out_proj(out), new_cache

    if isinstance(cache, PagedDecodeCache):
        if s != 1:
            raise ValueError("paged decode takes one token per sequence")
        new_cache = cache.append(k.transpose(1, 2)[:, :, 0],
                                 v.transpose(1, 2)[:, :, 0])
        args = (q.reshape(b, kv, g, hd).contiguous(), new_cache.k_pages,
                new_cache.v_pages, new_cache.k_scale, new_cache.v_scale,
                new_cache.tables, new_cache.lengths)
        ctx = (paged_attention_tp(*args, mesh=mesh, n_kv_heads=kv_all,
                                  impl=impl)
               if head_tp else paged_attention(*args, impl=impl))
        return out_proj(ctx.reshape(b, 1, h * hd)), new_cache

    new_cache = None
    k_all, v_all, k_pos, k_len = k, v, positions[0], None
    if cache is not None:
        k_t, v_t = k.transpose(1, 2), v.transpose(1, 2)          # (B,KV,S,hd)
        if s > 1:       # prefill from position 0
            new_cache = cache.write_prefill(k_t, v_t)
        else:           # decode: append at cache_pos, attend over the slab
            new_cache = cache.append(k_t, v_t, cache_pos)
            k_all, v_all = new_cache.read(x.dtype)               # (B,T,KV,hd)
            k_pos = cache.start + torch.arange(k_all.shape[1],
                                               device=x.device)
            k_len = cache_pos + 1

    q_pos = k_pos
    split = seq_split() if cache is None else None
    if split is not None:     # this rank's queries over the whole sequence
        kv_all = gather_seq(torch.cat([k, v], dim=-1), split.mesh,
                            split.seq_axes)
        k_all, v_all = kv_all.split(hd, dim=-1)
        k_pos = torch.arange(k_all.shape[1], device=x.device)

    qg = q.reshape(b, s, kv, g, hd)
    chunk = cfg.attn_q_chunk
    if cache is not None and s == 1:
        q_pos = torch.full((1,), cache_pos, device=x.device)
        if cache.seq_axes:     # this rank's block of the slab's positions
            out = seq_split_attn(qg, k_all, v_all, q_pos, k_pos,
                                 k_len=k_len, mesh=cache_mesh(),
                                 axes=cache.seq_axes)
        else:
            out = _grouped_attn(qg, k_all, v_all, q_pos, k_pos,
                                k_len=k_len)
    elif chunk and s > chunk:
        if s % chunk:
            raise ValueError(f"sequence {s} is not a multiple of "
                             f"attn_q_chunk {chunk}")
        out = torch.cat([_grouped_attn(qg[:, i:i + chunk], k_all, v_all,
                                       q_pos[i:i + chunk], k_pos)
                         for i in range(0, s, chunk)], dim=1)
    else:
        out = _grouped_attn(qg, k_all, v_all, q_pos, k_pos)
    return out_proj(out.reshape(b, s, h * hd)), new_cache


def cache_mesh():
    """The mesh of the dense-slab context a sequence-split slab runs in."""
    ctx = dense_ctx()
    if ctx is None:
        raise RuntimeError("a sequence-split KV slab runs inside its "
                           "dense-slab mesh context")
    return ctx.mesh


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
               kv_dtype: Optional[str] = None,
               page_size: Optional[int] = None, device=None) -> DenseKVCache:
    """Dense slab cache; ``kv_dtype='int8'`` stores KV quantized with
    per-page dynamic scales (see :mod:`repro_torch.serving.kv_cache`)."""
    return DenseKVCache.init(
        batch, cfg.n_kv_heads, max_len, cfg.hd, dtype,
        quantized=(kv_dtype == "int8"),
        page_size=page_size or DEFAULT_PAGE_SIZE, device=device)
