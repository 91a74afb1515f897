"""Shared building blocks: norms, rope, linear-with-CAMP, gated MLP, and
the training loss (softmax cross entropy, streamed over the vocabulary).

Port of ``repro/models/modules.py``. Under a serving mesh
(:mod:`repro_torch.parallel.sharding`) a rank holds its shards of the
weights: the gated MLP's gate/up columns and down rows, reduced by
:func:`row_linear`. That is :func:`row_parallel_linear` on the paged
engine (``mode="serve"``: x quantized from the rank's own K shard, the
reference's ``shard_map`` body) and :func:`whole_row_linear` on the dense
slab (``mode="dense"``: each row's scale the whole row's, as GSPMD runs
the reference's plain ``linear`` on sharded operands).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.core.camp import camp_matmul, weight_bits
from repro_torch.core.quant import QuantizedTensor, div_exact, pack_int4
from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import apply_epilogue, parse_epilogue
from repro_torch.parallel.collectives import (all_reduce, psum,
                                              quantized_psum)
from repro_torch.parallel.sharding import (active_ctx, dense_ctx, sharded,
                                           tp_mesh)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """Variance in f32; the normalised product is rounded in x's dtype, as
    the reference does (``x * inv * scale`` with ``inv`` cast to x.dtype)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def refuse_tf32(x: torch.Tensor, what: str) -> None:
    """Raise on a CUDA tensor while TF32 matmuls are on: ``what`` computes
    f32 products that must stay f32, as in the reference."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{what} is f32; TF32 matmuls "
                           "(torch.backends.cuda.matmul.allow_tf32) would "
                           "change its results")


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Per-head LayerNorm over the last dim, in f32. x: (..., H, hd). The
    variance is the population variance (``jnp.var``), not torch's
    unbiased default."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, *,
           qmode: str = "none", impl: str = "auto",
           epilogue: Optional[str] = None,
           operand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W (+ b)``, through the CAMP pipeline when W is quantized.

    ``epilogue`` appends fused tail stages after the bias (e.g. ``'silu'``,
    ``'mul'`` with ``operand``); on the quantized path they run inside the
    kernel's flush on the f32 accumulator.
    """
    stages = []
    if bias is not None:
        stages.append("bias")
    if epilogue and epilogue != "none":
        stages.append(epilogue)
    epi = "+".join(stages) if stages else "none"
    if isinstance(w, QuantizedTensor):
        # The weight's payload decides the kernel family: a caller-side qmode
        # of 'none' (or one whose weight bits disagree with the payload) is
        # remapped to the mode matching the weight, keeping the requested
        # activation treatment (weight-only stays weight-only).
        return camp_matmul(x, w, qmode=_act_qmode(w, qmode), impl=impl,
                           epilogue=epi, bias=bias, operand=operand)
    y = torch.matmul(x, w.to(x.dtype))
    if epi != "none":
        y = apply_epilogue(
            y.float(), parse_epilogue(epi),
            bias=None if bias is None else bias.reshape(1, -1),
            operand=operand).to(x.dtype)
    return y


def tp_shardable(w, tp: int) -> bool:
    """Can a (K, N) weight's contraction dim split over ``tp`` shards?

    int4 payloads are packed 2-per-byte along K, so each K-shard must also
    hold an even number of logical rows.
    """
    if tp <= 1:
        return False
    k = w.shape[0]
    if k % tp:
        return False
    if isinstance(w, QuantizedTensor) and w.bits == 4:
        return (k // tp) % 2 == 0
    return True


def _tp_int8_reduce() -> bool:
    ctx = active_ctx()
    return bool(ctx is not None and ctx.opts.get("tp_int8_reduce"))


def row_parallel_linear(x: torch.Tensor, w, *, mesh, axis: str = "model",
                        qmode: str = "none", impl: str = "auto",
                        quantized_reduce: Optional[bool] = None
                        ) -> torch.Tensor:
    """Megatron row-parallel projection, this rank's part: ``x @ W`` with
    W K-sharded.

    ``x``: this rank's (..., K/tp) columns (its heads × head_dim after
    head-sharded attention, its d_ff slice after the column-parallel
    gate/up); ``w``: its (K/tp, N) rows. The rank runs :func:`linear` on
    its shard (the fused CAMP GEMM quantizes x from shard-local rows, so
    no quantized operand is gathered); the f32 partials are all-reduced,
    with an int8 payload when ``quantized_reduce`` (default: the serve
    context's ``tp_int8_reduce`` option), and cast to x's dtype.
    """
    y = linear(x, w, qmode=qmode, impl=impl).float()
    return reduce_partials(y, mesh, axis, quantized_reduce).to(x.dtype)


def row_absmax(h2: torch.Tensor, mesh, axis="model") -> torch.Tensor:
    """h2 (M, K/tp), this rank's block of each row → (M, 1) the whole
    row's absmax, in h2's dtype: the block's, MAX-reduced over ``axis``
    (exact: it is one of the row's values)."""
    amax = h2.abs().amax(dim=-1, keepdim=True).float()
    return all_reduce(amax, mesh, axis, op=dist.ReduceOp.MAX).to(h2.dtype)


def quantize_whole_rows(h2: torch.Tensor, mesh, *, a4: bool,
                        impl: str = "auto", axis="model"):
    """This rank's (M, K/tp) block of each row, quantized as one process
    quantizes the whole row: K7 over the block with one more column
    holding the row's absmax (:func:`row_absmax` over ``axis``, the axes
    splitting the rows), so the scale and every value are the whole
    row's, bit for bit → (int8 q (M, K/tp), packed along K for ``a4``
    (w4a4), f32 scales (M, 1))."""
    q, s = ops.quantize_rowwise(
        torch.cat([h2, row_absmax(h2, mesh, axis)], dim=-1).contiguous(),
        bits=4 if a4 else 8, impl=impl)
    q = q[:, :-1]
    return (pack_int4(q.T).T if a4 else q).contiguous(), s


def _act_qmode(w, qmode: str) -> str:
    """The mode :func:`linear` runs a quantized ``w`` in (the weight's
    bits decide the kernel family)."""
    if qmode == "none" or weight_bits(qmode) != w.bits:
        if qmode.endswith("a16"):
            return "w8a16" if w.bits == 8 else "w4a16"
        return "w8a8" if w.bits == 8 else "w4a8"
    return qmode


def gemm_acc(q: torch.Tensor, s: torch.Tensor, w: QuantizedTensor, k: int,
             *, a4: bool, impl: str = "auto") -> torch.Tensor:
    """The int32 sums of pre-quantized rows ``q`` (packed along K for
    ``a4``) times ``w``, unflushed: K5 (int8 weights), K6a (w4a8) or K6b
    (w4a4) with int32 out."""
    kw = dict(out_dtype=torch.int32, impl=impl)
    if w.bits == 8:
        return ops.gemm_i8(q, w.q, s, w.scale, **kw)
    if a4:
        return ops.gemm_a4w4(q, w.q, k, s, w.scale, **kw)
    return ops.gemm_w4(q, w.q, s, w.scale, **kw)


def whole_row_linear(x: torch.Tensor, w, *, mesh, axis: str = "model",
                     qmode: str = "none", impl: str = "auto"
                     ) -> torch.Tensor:
    """The dense slab's row-parallel ``x @ W``, as GSPMD runs the
    reference's plain ``linear`` on a K-sharded W: ``x`` (..., K/tp) this
    rank's columns, ``w`` its (K/tp, N) rows → the whole (..., N) in x's
    dtype, on every rank of ``axis``.

    The integer modes quantize x with each whole row's scale
    (:func:`quantize_whole_rows`: every value the one one process
    quantizes), take K5 / K6a / K6b's int32 sums unflushed
    (:func:`gemm_acc`), add them over the ranks (int32: exact) and flush
    once: one process's K1 / K4 output, bit for bit. The float and
    weight-only modes add the ranks' f32 partials and round once."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    mode = _act_qmode(w, qmode) if isinstance(w, QuantizedTensor) else None
    if mode in ("w8a8", "w4a8", "w4a4"):
        q, s = quantize_whole_rows(x2, mesh, a4=mode == "w4a4", impl=impl)
        acc = all_reduce(gemm_acc(q, s, w, k, a4=mode == "w4a4", impl=impl),
                         mesh, axis)
        y = ops.flush(acc, s, w.scale, out_dtype=x.dtype)
    else:
        wf = w.dequantize().to(x.dtype) if mode else w.to(x.dtype)
        y = psum(x2.float() @ wf.float(), mesh, axis).to(x.dtype)
    return y.reshape(*lead, -1)


def row_linear(x: torch.Tensor, w, *, qmode: str = "none",
               impl: str = "auto") -> torch.Tensor:
    """The row-parallel projection of a rank holding W's K rows under a
    serving mesh context: :func:`whole_row_linear` on the dense slab,
    :func:`row_parallel_linear` on the paged engine."""
    mesh, _ = tp_mesh()
    fn = whole_row_linear if dense_ctx() is not None else row_parallel_linear
    return fn(x, w, mesh=mesh, qmode=qmode, impl=impl)


def reduce_partials(y: torch.Tensor, mesh, axis: str = "model",
                    quantized_reduce: Optional[bool] = None
                    ) -> torch.Tensor:
    """The sum over the ranks of this rank's f32 partial ``y``: the f32
    all-reduce, or with ``quantized_reduce`` (default: the serve context's
    ``tp_int8_reduce`` option) an int8 payload on the wire."""
    if quantized_reduce is None:
        quantized_reduce = _tp_int8_reduce()
    return quantized_psum(y, mesh, axis) if quantized_reduce \
        else psum(y, mesh, axis)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int → (cos, sin) of shape (..., head_dim // 2), f32.

    The inverse frequencies are computed on the CPU (correctly rounded
    division, as the reference) and moved to the positions' device.
    """
    half = head_dim // 2
    expo = div_exact(torch.arange(half, dtype=torch.float32), half)
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), expo)
    ang = positions.float()[..., None] * inv.to(positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B, S, hd // 2) → rotated x (half-split)."""
    x32 = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def gated_mlp(x: torch.Tensor, p: dict, *, qmode: str = "none",
              impl: str = "auto") -> torch.Tensor:
    """SiLU-gated FFN: down(silu(gate(x)) * up(x)), as three fused GEMMs.

    The gate applies SiLU in its flush, the up projection multiplies by the
    activated gate in its flush, and the down projection is plain. Under a
    serving mesh whose layout shards the MLP, a rank holds its d_ff
    columns of gate/up and the matching rows of ``w_down``
    (:func:`~repro_torch.parallel.sharding.shard_params` shards the three
    together): the down projection is then row-parallel
    (:func:`row_linear`), one all-reduce per MLP.
    """
    g = linear(x, p["w_gate"], qmode=qmode, impl=impl, epilogue="silu")
    h = linear(x, p["w_up"], qmode=qmode, impl=impl, epilogue="mul", operand=g)
    if sharded("mlp"):
        return row_linear(h, p["w_down"], qmode=qmode, impl=impl)
    return linear(h, p["w_down"], qmode=qmode, impl=impl)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy; logits (B, S, V) taken in f32,
    labels (B, S)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def _chunk_stats(h, head_c, labels, c0: int, vc: int):
    """One vocabulary chunk's (row max, Σ exp(logit − max), gold logit or
    0 where the label lies outside the chunk), each (B, S) f32."""
    logits = torch.matmul(h, head_c.to(h.dtype)).float()
    m = logits.amax(dim=-1)
    s = torch.exp(logits - m[..., None]).sum(dim=-1)
    idx = labels - c0
    in_c = (idx >= 0) & (idx < vc)
    gold = torch.gather(logits, -1, idx.clamp(0, vc - 1)[..., None])[..., 0]
    return m, s, torch.where(in_c, gold, 0.0)


def chunked_xent(h: torch.Tensor, head, labels: torch.Tensor, *,
                 n_chunks: int = 8) -> torch.Tensor:
    """Streamed cross entropy: the (B, S, V) f32 logits are never held
    whole. The head's columns go in ``n_chunks`` chunks (fewer until they
    divide V) with an online max / sum-exp, each chunk's statistics
    recomputed in the backward pass (a checkpoint), so live memory is one
    (B, S, V / n) slice. Exact up to f32 rounding.

    h: (B, S, D) final hidden; head: (D, V) weight (or QuantizedTensor).
    """
    if isinstance(head, QuantizedTensor):
        head = head.dequantize()
    b, s, _ = h.shape
    v = head.shape[-1]
    while v % n_chunks:
        n_chunks -= 1
    vc = v // n_chunks
    labels = labels.long()
    run_m = torch.full((b, s), -torch.inf, dtype=torch.float32,
                       device=h.device)
    run_s = torch.zeros((b, s), dtype=torch.float32, device=h.device)
    gold_total = torch.zeros((b, s), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        m, s_, gold = checkpoint(_chunk_stats, h, head[:, c * vc:(c + 1) * vc],
                                 labels, c * vc, vc, use_reentrant=False,
                                 preserve_rng_state=False)
        new_m = torch.maximum(run_m, m)
        run_s = run_s * torch.exp(run_m - new_m) + s_ * torch.exp(m - new_m)
        run_m = new_m
        gold_total = gold_total + gold
    lse = run_m + torch.log(run_s)
    return (lse - gold_total).mean()
