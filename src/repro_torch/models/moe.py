"""Mixture-of-Experts FFN: top-k router with capacity, slot dispatch,
per-expert CAMP GEMMs.

Port of ``repro/models/moe.py``. Dispatch is **slot-indexed**: routing
builds an (expert, slot) → token index map with a cumsum and a scatter,
dispatch and combine are gathers, and every GEMM FLOP is expert compute
at M = the expert capacity.

* Routing runs per group of ``routing_group_size(T)`` tokens. Within a
  group, slot priority follows token order, one top-k rank j at a time;
  a token past an expert's capacity goes to the sentinel slot ``E·cap``,
  which reads a zero row. The output therefore depends on the batch
  (which tokens share a group), as in the reference.
* The router is f32 (``x.f32 @ router``, softmax in f32). Top-k is a
  stable descending sort, so ties go to the lower expert index, as
  ``jax.lax.top_k`` gives them; a CUDA router refuses TF32.
* The integer modes launch the fused CAMP GEMM (K1 for int8 weights, K4
  for packed int4) once per expert and projection, every expert at
  capacity M whether or not a token routed to it, with f32 output and no
  fused epilogue, then round to the activation dtype: the reference's
  design and roundings. The float and weight-only modes take an einsum
  over the (dequantized) weights.

Under a serve-mode mesh whose layout shards the experts
(:mod:`repro_torch.parallel.sharding`), a rank holds every expert's
``expert_ff`` columns of ``w_gate`` / ``w_up`` (their (E, 1, N) scales
sliced alike) and the matching rows of ``w_down``, as the reference's
serve rules place them, and its GSPMD keeps the one-process meaning:

* routing is not split: every rank routes the same tokens with the whole
  router, so the slots agree and no token moves between ranks;
* gate and up are column-parallel: each rank's K1/K4 per expert gives
  the one-process values of its columns, bit for bit;
* down is row-parallel with the **whole row's** activation scale, as
  GSPMD computes it (the dense FFN's ``shard_map`` quantizes from the
  rank's own rows instead): a MAX all-reduce of h's row absmax
  (``modules.row_absmax``), K7 over the rank's rows with one more column
  holding it, then K5 / K6a / K6b per expert on the quantized block
  (:func:`_down_partial`), f32 out;
* each rank combines its f32 partials with the routing weights, and one
  all-reduce of y (T, D) a layer sums them (f32, or the int8 wire of
  ``tp_int8_reduce``): the combine is linear, so it moves T × D values
  where the (E·C, D) slab would move E·C × D. The expert outputs are not
  rounded to the activation dtype before the combine, as one process
  rounds them; y is rounded once, after the sum.

On the dense slab (``engine.slab_context``, ``mode="dense"``) the down
projection keeps GSPMD's meaning exactly (:func:`_down_whole`): each
expert's int32 sums of the whole-row-scaled rows are added over the model
ranks before one flush, and the combine reads one process's expert
outputs. Under the dense slab's prefill / decode rules the batch splits
over data (``sharding.data_split``): each rank lays its tokens on the
grid of the global routing groups (:func:`run_grid`,
:func:`split_offsets`, as a sharded train step does), and where the data
ranks divide the experts (:func:`expert_split`) one all-to-all sends
every rank's slots of expert block j to data rank j, which runs the
GEMMs of its E/data experts over every rank's slots, and a second one
brings the outputs back for the combine (the eager counterpart of the
reference's ``logical(xe, "moe_group", "expert", ...)``). The expert
weights stay whole over data, as the reference places them.

Under the multi-pod train rules a rank's tokens are not one run: its
rows' block of the sequence is one run a row, the other pods' runs
between them in token order (:func:`token_runs`). Each run takes its own
rows of the grid, and its offsets count every run before it in the
global token order (:func:`_exchange_offsets`), so the slots are one
process's.

Under the hillclimb's B2 rules (``expert`` over model, ``expert_ff`` over
data) the weights stay where the reference's ``params_pspecs`` puts them
(every expert's columns over model): model rank j gathers experts block
j whole over model, keeps its data rank's ``expert_ff`` block, and runs
it on every data rank's slots (:func:`_experts_over_model`).

The reference's other sharding annotations (``logical(...)``) are GSPMD
layout hints with no eager counterpart and are left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quant import (QuantizedTensor, pack_int4,
                                    quantize_colwise)
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import (gemm_acc, quantize_whole_rows,
                                        reduce_partials, refuse_tf32)
from repro_torch.parallel.collectives import (all_reduce, all_to_all,
                                              gather_blocks, psum_grad)
from repro_torch.parallel.fsdp import batch_split
from repro_torch.parallel.sharding import (data_split, dense_ctx, sharded,
                                           tp_mesh)

MOE_MIN_CAPACITY = 8
MOE_GROUP_SIZE = 4096  # tokens per routing group


def routing_group_size(n_tokens: int) -> int:
    """Largest group size ≤ MOE_GROUP_SIZE that divides ``n_tokens``
    (halving from the cap)."""
    sg = min(MOE_GROUP_SIZE, n_tokens)
    while n_tokens % sg:
        sg //= 2
    return sg


def expert_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Expert slot count for one routing group: the capacity factor's
    share, at least MOE_MIN_CAPACITY, rounded up to a multiple of 4 and
    at most every top-k pick of the group."""
    cap = max(MOE_MIN_CAPACITY,
              int((tokens_per_group * cfg.moe_top_k * cfg.moe_capacity_factor)
                  / cfg.moe_experts))
    return min(-(-cap // 4) * 4, tokens_per_group * cfg.moe_top_k)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """Router (D, E) f32 and expert weights (E, D, F), (E, F, D) with the
    reference's scales, drawn from ``gen``."""
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.expert_ff

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    sc = d ** -0.5
    return {
        "router": normal((d, e), sc).float(),
        "experts": {"w_gate": normal((e, d, f), sc).to(dtype),
                    "w_up": normal((e, d, f), sc).to(dtype),
                    "w_down": normal((e, f, d), f ** -0.5).to(dtype)},
    }


def quantize_expert_weight(w: torch.Tensor, bits: int) -> QuantizedTensor:
    """(E, K, N) → per-expert per-output-channel quantization, 4-bit
    payloads packed along each expert's K."""
    q, scale = quantize_colwise(w, bits)          # each expert's columns
    if bits == 4:                                 # along each expert's K
        q = pack_int4(q.transpose(0, 1)).transpose(0, 1).contiguous()
    return QuantizedTensor(q=q, scale=scale, bits=bits, shape=tuple(w.shape))


def _dequant_expert(w: QuantizedTensor) -> torch.Tensor:
    return w.dequantize()


def _expert_matmul(xe: torch.Tensor, w, qmode: str,
                   impl: str = "auto") -> torch.Tensor:
    """Batched per-expert GEMM: (..., E, C, K) × (E, K, N) → (..., E, C, N).

    The integer modes launch one fused CAMP GEMM per expert (rows: every
    group's C slots of that expert), f32 out, rounded to xe's dtype after.
    """
    if not isinstance(w, QuantizedTensor):
        return torch.einsum("...eck,ekn->...ecn", xe, w.to(xe.dtype))
    if qmode in ("w8a16", "w4a16", "none"):
        return torch.einsum("...eck,ekn->...ecn", xe,
                            _dequant_expert(w).to(xe.dtype))
    lead = xe.shape[:-3]
    e, c, kk = xe.shape[-3:]
    x2 = xe.reshape(-1, e, c, kk).transpose(0, 1).reshape(e, -1, kk)
    x2 = x2.contiguous()                                          # (E,L*C,K)
    if w.bits == 8:
        gemm = ops.gemm_i8_fused
    elif qmode == "w4a4":
        gemm = ops.gemm_a4w4_fused
    else:
        gemm = ops.gemm_w4_fused
    acc = torch.stack([gemm(x2[ei], w.q[ei], w.scale[ei],
                            out_dtype=torch.float32, impl=impl)
                       for ei in range(e)])                       # (E,L*C,N)
    n = acc.shape[-1]
    acc = acc.reshape(e, -1, c, n).transpose(0, 1).reshape(*lead, e, c, n)
    return acc.to(xe.dtype)


def _down_partial(h: torch.Tensor, w, qmode: str, impl: str,
                  mesh, axis="model") -> torch.Tensor:
    """This rank's f32 partial of the down projection: h (..., E, C,
    F/tp) its block of every expert's rows, ``w`` its (E, F/tp, D) rows →
    (..., E, C, D) f32.

    The integer modes quantize h with each whole row's scale
    (``modules.quantize_whole_rows``): K7 over all of the layer's rows at
    once, with one more column holding the row's absmax, so each value is
    the one one process quantizes; then K5 (int8 weights), K6a (w4a8) or
    K6b (w4a4, h packed along K) per expert, f32 out. The float and
    weight-only modes take an f32 einsum.
    """
    if not isinstance(w, QuantizedTensor) or qmode in ("w8a16", "w4a16",
                                                        "none"):
        wf = w.dequantize() if isinstance(w, QuantizedTensor) else w
        return torch.einsum("...eck,ekn->...ecn", h.float(),
                            wf.to(h.dtype).float())
    lead = h.shape[:-3]
    e, c, kk = h.shape[-3:]
    h2 = h.reshape(-1, e, c, kk).transpose(0, 1).reshape(-1, kk)
    rows = h2.shape[0] // e                                       # L*C
    a4 = w.bits == 4 and qmode == "w4a4"
    q, s = quantize_whole_rows(h2, mesh, a4=a4, impl=impl, axis=axis)
    parts, kw = [], dict(out_dtype=torch.float32, impl=impl)
    for ei in range(e):
        a, sa = q[ei * rows:(ei + 1) * rows], s[ei * rows:(ei + 1) * rows]
        if w.bits == 8:
            parts.append(ops.gemm_i8(a, w.q[ei], sa, w.scale[ei], **kw))
        elif a4:
            parts.append(ops.gemm_a4w4(a, w.q[ei], kk, sa, w.scale[ei],
                                       **kw))
        else:
            parts.append(ops.gemm_w4(a, w.q[ei], sa, w.scale[ei], **kw))
    acc = torch.stack(parts)                                      # (E,L*C,N)
    n = acc.shape[-1]
    return acc.reshape(e, -1, c, n).transpose(0, 1).reshape(*lead, e, c, n)


def _down_whole(h: torch.Tensor, w, qmode: str, impl: str,
                mesh, axis="model") -> torch.Tensor:
    """The dense slab's down projection, as GSPMD runs the reference's
    expert einsum on K-sharded rows: h (..., E, C, F/tp) this rank's block
    of every expert's rows, ``w`` its (E, F/tp, D) rows → the whole (...,
    E, C, D) in h's dtype on every rank of the model axis.

    The integer modes quantize h with each whole row's scale (K7 once over
    the layer's rows), take K5 / K6a / K6b's int32 sums unflushed per
    expert, add them over the ranks (exact) and flush: one process's
    expert outputs, bit for bit. The float and weight-only modes add f32
    partials (:func:`_down_partial`) and round once. ``axis``: the axes
    that split the rows (the model axis; the data axes under the
    hillclimb's B2 rules)."""
    if not isinstance(w, QuantizedTensor) or qmode in ("w8a16", "w4a16",
                                                        "none"):
        return reduce_partials(_down_partial(h, w, qmode, impl, mesh, axis),
                               mesh, axis).to(h.dtype)
    lead = h.shape[:-3]
    e, c, kk = h.shape[-3:]
    h2 = h.reshape(-1, e, c, kk).transpose(0, 1).reshape(-1, kk)
    rows = h2.shape[0] // e                                       # L*C
    a4 = w.bits == 4 and qmode == "w4a4"
    q, s = quantize_whole_rows(h2, mesh, a4=a4, impl=impl, axis=axis)
    acc = torch.stack([gemm_acc(q[ei * rows:(ei + 1) * rows],
                                s[ei * rows:(ei + 1) * rows],
                                QuantizedTensor(q=w.q[ei], scale=w.scale[ei],
                                                bits=w.bits,
                                                shape=tuple(w.shape[1:])),
                                kk, a4=a4, impl=impl)
                       for ei in range(e)])                       # (E,L*C,N)
    acc = all_reduce(acc, mesh, axis)
    y = ops.flush(acc, s.reshape(e, rows, 1), w.scale,
                  out_dtype=torch.float32)
    n = y.shape[-1]
    return y.reshape(e, -1, c, n).transpose(0, 1).reshape(
        *lead, e, c, n).to(h.dtype)


def _route(gates: torch.Tensor, k: int, cap: int, mask=None, offsets=None):
    """gates: (G, S, E) f32 → (slots (G, S, k) long in [0, E·cap],
    weights (G, S, k) f32). Slot E·cap is the overflow sentinel.

    ``mask`` (G, S) bool: the tokens of this rank's run (the others hold
    no token here and take no slot); ``offsets`` (G, k, E) int32: for
    each level the picks of the group's tokens that come before this
    rank's run in slot order (:func:`split_offsets`). Without them the
    group is whole here, as in one process."""
    g, s, e = gates.shape
    order = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = order.values[..., :k], order.indices[..., :k]
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    counts = torch.zeros((g, e), dtype=torch.int32, device=gates.device)
    slots = []
    for j in range(k):
        oh = F.one_hot(topi[:, :, j], e).to(torch.int32)          # (G,S,E)
        if mask is not None:
            oh = oh * mask[..., None]
        if offsets is not None:
            counts = offsets[:, j]
        pos_all = torch.cumsum(oh, dim=1, dtype=torch.int32) - 1 \
            + counts[:, None]
        pos = torch.gather(pos_all, -1, topi[:, :, j:j + 1])[..., 0]
        counts = counts + oh.sum(dim=1, dtype=torch.int32)
        slots.append(torch.where(pos < cap, topi[:, :, j] * cap + pos,
                                 e * cap))
    return torch.stack(slots, dim=-1), topv


def level_counts(gates: torch.Tensor, k: int, mask=None) -> torch.Tensor:
    """gates (G, S, E) → (G, k, E) int32: how many of the tokens (those in
    ``mask``) pick each expert at each top-k level."""
    e = gates.shape[-1]
    topi = torch.sort(gates, dim=-1, descending=True,
                      stable=True).indices[..., :k]
    oh = F.one_hot(topi, e).to(torch.int32)                     # (G,S,k,E)
    if mask is not None:
        oh = oh * mask[..., None, None]
    return oh.sum(dim=1, dtype=torch.int32)


def split_offsets(counts: torch.Tensor, rank: int) -> torch.Tensor:
    """counts (R, G, k, E): every rank's :func:`level_counts` of the global
    groups, ranks in token order → (G, k, E) int32, rank ``rank``'s
    offsets: at level j, the whole group's picks at levels < j plus the
    earlier ranks' at level j. A pick's slot is then this offset plus its
    place among the rank's own picks, as one process's cumsum over the
    whole group gives it (every level's positions follow the earlier
    levels' totals, never another position)."""
    total = counts.sum(dim=0, dtype=torch.int32)                 # (G,k,E)
    before = torch.cumsum(total, dim=1, dtype=torch.int32) - total
    return before + counts[:rank].sum(dim=0, dtype=torch.int32)


def run_grid(first: int, t: int, sg: int):
    """A run of ``t`` tokens of the global token array from token
    ``first`` on, laid on the grid of the routing groups of ``sg`` tokens
    it meets: (first group, groups, the run's first cell in the grid's
    flattened (groups, sg) cells)."""
    g0 = first // sg
    return g0, (first + t - 1) // sg - g0 + 1, first - g0 * sg


def token_runs(split, b: int, s: int, coords=None) -> list:
    """The runs of the global token array (rows × sequence, row-major)
    that the rank at ``coords`` (default: this rank) holds under
    ``split`` (a :class:`~repro_torch.parallel.sharding.Split`), each
    ``(first token, length)``, in its own token order: its ``b`` rows of
    ``s`` positions. One run where it holds whole rows; one a row where
    it holds a block of the sequence (the multi-pod train rules), the
    other sequence blocks' runs between them."""
    row, _, blk, blocks = split.blocks(coords)
    if blocks == 1:
        return [(row * b * s, b * s)]
    whole = s * blocks
    return [((row * b + i) * whole + blk * s, s) for i in range(b)]


def _run_order(firsts) -> list:
    """The runs of every rank (members in the group's order, each rank's
    runs in its order) sorted into global token order: their indices."""
    return sorted(range(len(firsts)), key=lambda i: firsts[i])


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
            qmode: str = "none", impl: str = "auto"):
    """x: (B, S, D) → (y (B, S, D), Switch load-balance aux loss). Under
    a serving mesh whose layout shards the experts, this rank's column
    and row blocks of them; under a sharded train step, or a dense-slab
    context whose rules split the batch over data, this rank's rows of
    the global batch, and in the second case the dispatch slab split by
    expert over the data ranks (module docstring)."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    t = b * s
    split = batch_split() or data_split()
    n = 1 if split is None else split.n
    sg = routing_group_size(n * t)
    cap = expert_capacity(sg, cfg)
    refuse_tf32(x, "the MoE router")

    if split is None:
        g, cells = t // sg, None
        xg = x.reshape(g, sg, d)
    else:    # each run of this rank's tokens on the grid of its groups
        runs = token_runs(split, b, s)
        grids = [run_grid(first, length, sg) for first, length in runs]
        g = sum(gl for _, gl, _ in grids)
        starts = [sg * sum(gl for _, gl, _ in grids[:u])
                  for u in range(len(runs))]
        cells = torch.cat([torch.arange(at + lo, at + lo + length,
                                        device=x.device)
                           for at, (_, _, lo), (_, length)
                           in zip(starts, grids, runs)])
        xg = x.new_zeros(g * sg, d).index_copy(0, cells, x.reshape(t, d))
        xg = xg.reshape(g, sg, d)
    gates = torch.softmax(xg.float() @ p["router"].float(), dim=-1)
    if split is None:
        slots, weights = _route(gates, k, cap)                    # (G,S,k)
    else:
        mask = torch.zeros(g * sg, dtype=torch.int32, device=x.device)
        mask = mask.index_fill(0, cells, 1).reshape(g, sg)
        slots, weights = _route(gates, k, cap, mask, _exchange_offsets(
            level_counts(gates, k, mask), grids, n * t // sg, split,
            (b, s)))
        slots = torch.where(mask[..., None].bool(), slots, e * cap)

    # slot → token map; the sentinel token index sg reads a zero row
    tok_for_slot = torch.full((g, e * cap + 1), sg, dtype=torch.long,
                              device=x.device)
    tok_ids = torch.arange(sg, device=x.device)[None, :, None].expand(
        g, sg, k)
    tok_for_slot.scatter_(1, slots.reshape(g, -1), tok_ids.reshape(g, -1))

    # dispatch: gather tokens into (G, E, C, D)
    xpad = torch.cat([xg, x.new_zeros(g, 1, d)], dim=1)
    idx = tok_for_slot[:, :e * cap, None].expand(g, e * cap, d)
    xe = torch.gather(xpad, 1, idx).reshape(g, e, cap, d)

    ep = expert_split(cfg)
    b2 = None if ep is not None else experts_over_model(cfg)
    experts = p["experts"]
    mesh = None
    if b2 is not None:       # the model rank's experts, every rank's slots
        ye = _experts_over_model(xe, experts, b2, t, sg, qmode, impl)
    else:
        if ep is not None:   # this data rank's experts, every rank's slots
            xe, experts = _to_expert_ranks(xe, experts, ep, t, sg)
        gate = _expert_matmul(xe, experts["w_gate"], qmode, impl)
        up = _expert_matmul(xe, experts["w_up"], qmode, impl)
        h = F.silu(gate.float()).to(x.dtype) * up
        mesh = tp_mesh()[0] if sharded("experts") else None
        if mesh is None:
            ye = _expert_matmul(h, experts["w_down"], qmode, impl)
        elif dense_ctx() is not None:  # GSPMD's: the slab whole, then combine
            ye = _down_whole(h, experts["w_down"], qmode, impl, mesh)
            mesh = None
        else:
            ye = _down_partial(h, experts["w_down"], qmode, impl, mesh)
        if ep is not None:   # the slots' outputs back to their tokens' rank
            ye = _from_expert_ranks(ye, ep, g)

    # combine: gather each token's k expert outputs, weight, sum in f32
    ye_pad = torch.cat([ye.reshape(g, e * cap, d), ye.new_zeros(g, 1, d)],
                       dim=1)
    picked = torch.gather(ye_pad, 1, slots.reshape(g, sg * k, 1)
                          .expand(g, sg * k, d))
    picked = picked.reshape(g, sg, k, d).float()
    y = torch.einsum("gskd,gsk->gsd", picked, weights)
    if mesh is not None:               # the ranks' partials, once a layer
        y = reduce_partials(y, mesh)
    y = y.to(x.dtype)

    # load-balance aux (Switch): E · Σ_e fraction_e · mean_gate_e
    top1 = F.one_hot(gates.argmax(dim=-1), e).float()
    if split is None:
        aux = e * torch.sum(top1.reshape(t, e).mean(dim=0)
                            * gates.reshape(t, e).mean(dim=0))
        return y.reshape(b, s, d), aux
    # the global batch's means: the ranks' sums, summed (and so their
    # gradients, in the backward), over its token count
    sums = torch.stack([top1.reshape(-1, e)[cells].sum(dim=0),
                        gates.reshape(-1, e)[cells].sum(dim=0)])
    frac, mean_gate = psum_grad(sums, split.mesh, split.axes) / (n * t)
    aux = e * torch.sum(frac * mean_gate)
    return y.reshape(-1, d)[cells].reshape(b, s, d), aux


def expert_split(cfg: ModelConfig):
    """Under a dense-slab context whose rules split the batch over data
    (:func:`~repro_torch.parallel.sharding.data_split`): (mesh, data axes,
    their rank count n, this rank's index), when n divides the experts:
    each data rank then runs the expert GEMMs of its E/n experts; else
    None (every rank runs every expert on its own slots). Rules that put
    the experts over the model axis take :func:`experts_over_model`."""
    split = data_split()
    if split is None or "model" in dense_ctx().rules.get("expert", ()):
        return None
    if cfg.moe_experts % split.n:
        return None
    return split


def experts_over_model(cfg: ModelConfig):
    """Under a dense-slab context whose rules put the experts over the
    model axis and ``expert_ff`` over the data axes (the hillclimb's B2:
    ``{"expert": ("model",), "expert_ff": ("data",)}``): (the rows'
    :class:`~repro_torch.parallel.sharding.Split` over data or None, the
    model rank count M), when M divides the experts and the data ranks
    divide ``expert_ff``; else None (every rank runs every expert on its
    own slots)."""
    ctx = dense_ctx()
    if ctx is None or "model" not in ctx.rules.get("expert", ()):
        return None
    m = ctx.mesh.shape["model"]
    split = data_split()
    n = 1 if split is None else split.n
    ff = tuple(a for a in ctx.rules.get("expert_ff", ())
               if ctx.mesh.shape.get(a, 1) > 1)
    if (m == 1 or cfg.moe_experts % m or cfg.expert_ff % n
            or ff != (() if split is None else split.axes)):
        return None
    return split, m


def _cols(w, lo: int, hi: int):
    """Columns [lo, hi) of an (E, K, N) stack (a QuantizedTensor's scales
    alike), copied out: the GEMM kernels take contiguous weights."""
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(q=w.q[..., lo:hi].contiguous(),
                               scale=w.scale[..., lo:hi].contiguous(),
                               bits=w.bits, shape=(*w.shape[:-1], hi - lo))
    return w[..., lo:hi].contiguous()


def _rows(w, lo: int, hi: int):
    """Rows [lo, hi) of an (E, K, N) stack (a packed int4 payload's rows
    halved, so ``lo`` and ``hi`` even; the scales kept), copied out."""
    if isinstance(w, QuantizedTensor):
        pk = 2 if w.bits == 4 else 1
        if lo % pk or hi % pk:
            raise ValueError(f"rows [{lo}, {hi}) of a packed int4 stack: "
                             "its bytes hold rows in pairs")
        return QuantizedTensor(q=w.q[:, lo // pk:hi // pk].contiguous(),
                               scale=w.scale, bits=w.bits,
                               shape=(w.shape[0], hi - lo, w.shape[2]))
    return w[:, lo:hi].contiguous()


def _gather_experts(w, mesh, m: int, dim: int):
    """This model rank's block of the experts (block j of ``m``) made
    whole along ``dim`` (2: the columns of w_gate / w_up, 1: the rows of
    w_down), from every model rank's block of every expert: one
    all-to-all over the model axis a payload (a row-split
    QuantizedTensor's scales are whole already)."""
    j = mesh.coords["model"]
    el = w.shape[0] // m

    def move(t):
        got = all_to_all([t[i * el:(i + 1) * el] for i in range(m)], mesh,
                         "model")
        return torch.cat(got, dim=dim)
    if not isinstance(w, QuantizedTensor):
        return move(w)
    q = move(w.q)
    scale = (move(w.scale) if dim == 2
             else w.scale[j * el:(j + 1) * el])
    rows = q.shape[1] * (2 if w.bits == 4 else 1)
    return QuantizedTensor(q=q, scale=scale, bits=w.bits,
                           shape=(el, rows, q.shape[2]))


def _experts_over_model(xe, experts: dict, b2, t: int, sg: int, qmode: str,
                        impl: str) -> torch.Tensor:
    """The hillclimb's B2 layout on the dense slab → ye (G, E, C, D) of
    this rank's slots, one process's.

    xe (G, E, C, D): this rank's dispatch slab. Model rank j runs experts
    block j (E/M experts), data rank i their ``expert_ff`` block i:

    * the dispatch slabs are gathered over data (every data rank's slots,
      each padded to the most groups a rank meets);
    * the weights come as the reference places them (every expert's
      column block of w_gate / w_up and row block of w_down over model):
      one all-to-all over model makes experts block j whole, and the rank
      keeps its ``expert_ff`` block i (:func:`_gather_experts`);
    * gate and up run through K1 / K4 on the column block (x's rows are
      whole, so their quantization is one process's);
    * the down projection takes each h row's whole scale by a row MAX
      over data (K7 with one more column), K5 / K6a / K6b's int32 sums
      are added over data and flushed once (:func:`_down_whole`);
    * the experts' outputs are gathered over model, and the rank keeps
      its own slots."""
    split, m = b2
    mesh = dense_ctx().mesh
    axes = () if split is None else split.axes
    n, i = (1, 0) if split is None else (split.n, split.index)
    g, e, c, d = xe.shape
    gmax = g if split is None else _grid_rows(t, sg, n)
    pad = xe.new_zeros(gmax, e, c, d)
    pad[:g] = xe
    slab = torch.cat(gather_blocks(pad, mesh, axes)) if axes else pad
    j, el = mesh.coords["model"], e // m
    mine = slab[:, j * el:(j + 1) * el]
    if sharded("experts"):        # every expert's model block: regather
        w = {"w_gate": _gather_experts(experts["w_gate"], mesh, m, 2),
             "w_up": _gather_experts(experts["w_up"], mesh, m, 2),
             "w_down": _gather_experts(experts["w_down"], mesh, m, 1)}
    else:
        w = {k: _expert_block(v, j * el, (j + 1) * el)
             for k, v in experts.items()}
    fb = w["w_gate"].shape[-1] // n
    gate = _expert_matmul(mine, _cols(w["w_gate"], i * fb, (i + 1) * fb),
                          qmode, impl)
    up = _expert_matmul(mine, _cols(w["w_up"], i * fb, (i + 1) * fb),
                        qmode, impl)
    h = F.silu(gate.float()).to(xe.dtype) * up
    down = _rows(w["w_down"], i * fb, (i + 1) * fb)
    if axes:
        ye = _down_whole(h, down, qmode, impl, mesh, axes)
    else:
        ye = _expert_matmul(h, down, qmode, impl)
    ye = torch.cat(gather_blocks(ye.contiguous(), mesh, "model"), dim=1)
    return ye[i * gmax:i * gmax + g]


def _expert_block(w, lo: int, hi: int):
    """Experts [lo, hi) of an (E, K, N) stack, as views."""
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(q=w.q[lo:hi], scale=w.scale[lo:hi],
                               bits=w.bits, shape=(hi - lo, *w.shape[1:]))
    return w[lo:hi]


def _grid_rows(t: int, sg: int, n: int) -> int:
    """The most groups any of the ``n`` ranks' runs of ``t`` tokens meets
    (every rank's block of the all-to-all is padded to it)."""
    return max(run_grid(r * t, t, sg)[1] for r in range(n))


def _to_expert_ranks(xe: torch.Tensor, experts: dict, ep, t: int, sg: int):
    """xe (G, E, C, D): this rank's dispatch slab (its tokens' slots
    filled, the rest zero) → (every data rank's slots of this rank's
    experts, stacked (n·Gmax, E/n, C, D), and those experts' weights).

    One all-to-all over the data axes: block j (experts [j·E/n, (j+1)·E/n)
    of every group, padded to the most groups a rank meets) goes to data
    rank j. Every output row of an expert's GEMM depends on its input row
    alone (rowwise quantization, integer sums), so each slot's output is
    one process's."""
    mesh, axes, n, me = ep.mesh, ep.axes, ep.n, ep.index
    g, e, c, d = xe.shape
    gmax = _grid_rows(t, sg, n)
    el = e // n
    pad = xe.new_zeros(gmax, e, c, d)
    pad[:g] = xe
    blocks = [pad[:, j * el:(j + 1) * el] for j in range(n)]
    got = all_to_all(blocks, mesh, axes)
    mine = {k: _expert_block(w, me * el, (me + 1) * el)
            for k, w in experts.items()}
    return torch.cat(got, dim=0), mine


def _from_expert_ranks(ye: torch.Tensor, ep, g: int) -> torch.Tensor:
    """ye (n·Gmax, E/n, C, D') this rank's experts' outputs of every data
    rank's slots → this rank's slab (G, E, C, D'): block r goes back to
    data rank r, and the blocks received stack by expert."""
    got = all_to_all(list(ye.chunk(ep.n, dim=0)), ep.mesh, ep.axes)
    return torch.cat(got, dim=1)[:g]


def _exchange_offsets(counts, grids, groups: int, split, rows: tuple):
    """The :func:`split_offsets` of each of this rank's runs, their grid
    rows stacked as ``counts`` (G, k, E) is (``grids``: each run's
    :func:`run_grid`): every rank's counts of each of its runs over the
    ``groups`` global groups, all-gathered as int32 over the split's axes
    (one call a layer), the runs sorted into global token order
    (:func:`token_runs` of each member, ``rows`` = (b, s) its block's
    rows and positions, :func:`_run_order`), and each run's offsets
    those of the runs before it."""
    b, s = rows
    mine = counts.new_zeros((len(grids), groups) + tuple(counts.shape[1:]))
    at = 0
    for u, (g0, gl, _) in enumerate(grids):
        mine[u, g0:g0 + gl] = counts[at:at + gl]
        at += gl
    every = gather_blocks(mine, split.mesh, split.axes)
    firsts = [first for j in range(len(every)) for first, _ in token_runs(
        split, b, s, split.mesh.member_coords(split.axes, j))]
    order = _run_order(firsts)
    ranked = torch.cat(every)[order]
    place = {run: pos for pos, run in enumerate(order)}
    me = split.index * len(grids)
    return torch.cat([split_offsets(ranked, place[me + u])[g0:g0 + gl]
                      for u, (g0, gl, _) in enumerate(grids)])
