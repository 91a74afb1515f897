"""Collectives of one rank over the axes of a mesh of ranks.

Port of ``repro/parallel/collectives.py``. The reference's ``shard_map``
bodies (``psum``, ``pmax``, ``all_gather``, ``ppermute`` over an axis)
become ``torch.distributed`` calls of this rank on the process group of
the mesh's axes (:mod:`repro_torch.launch.mesh`); ``axis`` names one axis
or a tuple of them. Serving reduces over the model axis:

* :func:`psum` — the f32 all-reduce of the row-parallel partials;
* :func:`quantized_psum` — the same with an **int8** payload on the wire:
  the global absmax by a MAX all-reduce, every partial quantized against
  it, the int8 payloads all-gathered and summed in int32 in rank order;
* :func:`ring_collective_matmul` — ``x @ W`` with x row-sharded and W
  column-sharded, x's shards rotated around the ring (send/recv), one
  partial product a hop;
* :func:`int8_allreduce_mean` — the int8-compressed mean all-reduce of a
  gradient;
* :func:`all_gather_last` and :func:`broadcast_ints` — the vocabulary
  gather of the head's columns (and of any column-split activation the
  next op needs whole) and rank 0's host decisions (sampled tokens, the
  engine's page size), which the replicated scheduler needs;
* :func:`all_reduce` with ``op=MAX`` — a row's global absmax
  (``modules.row_absmax``) and the sequence-split softmax's row maxima;
* :func:`all_to_all` — the dense slab's expert-parallel MoE: each data
  rank's dispatch slab to the ranks of its experts, and back.

Sharded training (:mod:`repro_torch.train.train_step`) gathers and
reduce-scatters blocks over one axis or both:

* :func:`all_reduce` — a sum or a MAX over the axes (a row's global
  absmax, the loss, the squares of the gradient norm);
* :func:`gather_blocks` — every rank's block along the axes, in the
  group's order (a parameter made whole);
* :func:`reduce_scatter` — the sum over the ranks of each rank's block
  (a gradient reduced to this rank's shard);
* :func:`psum_grad` — a sum whose backward sums too (the MoE aux loss's
  per-expert sums over the global batch).

Under the multi-pod train rules a rank holds its block of the sequence
(``seq_act`` on ``pod``) and a mixer runs over the whole of it:

* :func:`gather_seq` — the ranks' sequence blocks made whole; its
  backward sums the ranks' gradients of every block and hands a rank its
  own (a reduce-scatter: each rank used every block);
* :func:`halo_prev` — the previous rank's last position (the token
  shift's input at a block's first position); its backward sends the
  gradient back to that rank.

Every call takes tensors on the rank's device as they are: NCCL and gloo
both take CUDA tensors for these calls (gloo stages them through host
memory itself). ``broadcast_ints`` builds its tensor where the backend
wants it: on the card for NCCL, on the host for gloo.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.core.quant import div_exact
from repro_torch.launch.mesh import AXES, _live


Axes = Union[str, Sequence[str]]


def _axes(axis: Axes) -> tuple:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    unknown = set(axes) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}: of {AXES}")
    return axes


def _group(mesh, axis: Axes):
    """The process group over ``axis``; None when it holds one rank."""
    return mesh.group_of(_axes(axis))


def _size(mesh, axis: Axes) -> int:
    n = 1
    for a in _axes(axis):
        n *= mesh.shape[a]
    return n


def _gather(x: torch.Tensor, mesh, axis: Axes) -> List[torch.Tensor]:
    """Every rank's ``x``, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(mesh, axis))]
    dist.all_gather(parts, x, group=_group(mesh, axis))
    return parts


def all_reduce(x: torch.Tensor, mesh, axis: Axes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced (``op``: SUM or MAX) over the ranks along ``axis``, a
    new tensor (a copy of ``x`` where they are this rank alone)."""
    out = x.clone(memory_format=torch.contiguous_format)
    group = _group(mesh, axis)
    if group is not None:
        dist.all_reduce(out, op=op, group=group)
    return out


def gather_blocks(x: torch.Tensor, mesh, axis: Axes) -> List[torch.Tensor]:
    """Every rank's ``x`` along ``axis``, member ``j`` of the group at
    ``mesh.member_coords(axis, j)``; ``[x]`` where the group is one rank."""
    if _group(mesh, axis) is None:
        return [x]
    return _gather(x, mesh, axis)


def reduce_scatter(blocks: Sequence[torch.Tensor], mesh, axis: Axes
                   ) -> torch.Tensor:
    """Σ over the ranks along ``axis`` of their ``blocks[j]``, for this
    rank's ``j`` (its index in the group): ``blocks`` holds one block a
    member, in the group's order, all of one shape."""
    group = _group(mesh, axis)
    if group is None:
        return blocks[0].clone(memory_format=torch.contiguous_format)
    out = torch.empty_like(blocks[0], memory_format=torch.contiguous_format)
    dist.reduce_scatter(out, [b.contiguous() for b in blocks], group=group)
    return out


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


def psum_grad(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis``, differentiable: the
    backward sums the ranks' output gradients alike, so each rank's
    ``x`` gets the gradient of every rank's use of the sum (the one
    process's gradient, summed again once the step reduces the ranks'
    parameter gradients and divides by their count)."""
    return _PsumGrad.apply(x, mesh, _axes(axis))


def _index(mesh, axes: tuple) -> tuple:
    """(this rank's index along ``axes``, row-major over them; their rank
    count)."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coords[a]
        n *= mesh.shape[a]
    return idx, n


def seq_grad(blocks: List[torch.Tensor], mesh, axes) -> torch.Tensor:
    """The gradient of this rank's block of a gathered sequence: ``blocks``
    this rank's gradient of every rank's block, in the group's order →
    their sum over the ranks for this rank's block (each rank's mixer
    used every block)."""
    return reduce_scatter(blocks, mesh, axes)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return torch.cat(gather_blocks(x, mesh, axes), dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = _index(ctx.mesh, ctx.axes)[1]
        blocks = [b.contiguous() for b in g.chunk(n, dim=ctx.dim)]
        return seq_grad(blocks, ctx.mesh, ctx.axes), None, None, None


def gather_seq(x: torch.Tensor, mesh, axis: Axes, dim: int = 1
               ) -> torch.Tensor:
    """Every rank's block of a sequence along ``axis``, concatenated along
    ``dim`` in the group's order (the whole sequence), differentiable:
    the backward is :func:`seq_grad`."""
    axes = _live(_axes(axis), mesh.shape)
    if not axes:
        return x
    return _GatherSeq.apply(x, mesh, axes, dim)


class _HaloPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.shape = mesh, axes, x.shape
        idx = _index(mesh, axes)[0]
        last = gather_blocks(x[:, -1:].contiguous(), mesh, axes)
        return last[idx - 1] if idx else torch.zeros_like(last[0])

    @staticmethod
    def backward(ctx, g):
        idx, n = _index(ctx.mesh, ctx.axes)
        back = gather_blocks(g.contiguous(), ctx.mesh, ctx.axes)
        out = g.new_zeros(ctx.shape)
        if idx + 1 < n:
            out[:, -1:] = back[idx + 1]
        return out, None, None


def halo_prev(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """x (B, S/n, ...) this rank's sequence block → (B, 1, ...) the last
    position of the previous rank's block along ``axis`` (zeros on the
    first), differentiable."""
    axes = _live(_axes(axis), mesh.shape)
    if not axes:
        return x.new_zeros((x.shape[0], 1) + tuple(x.shape[2:]))
    return _HaloPrev.apply(x, mesh, axes)


def psum(y: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """All-reduce-sum of this rank's f32 partial (a new tensor)."""
    out = y.float().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(mesh, axis))
    return out


def quantized_psum(y: torch.Tensor, mesh, axis: str = "model"
                   ) -> torch.Tensor:
    """All-reduce-sum with an int8 payload on the wire.

    ``y`` is this rank's partial sum. Every rank quantizes against the
    GLOBAL absmax (one scalar MAX all-reduce): ``scale = absmax / 127`` (1
    where absmax is 0, correctly rounded), ``round(y / scale)`` half to
    even, clipped to [-127, 127]. The int8 payloads are all-gathered, each
    rank sums them in int32 in rank order (exact), then multiplies by the
    scale. Bit for bit the reference's arithmetic; off by at most one
    shared quantization step a rank from the exact sum.
    """
    group = _group(mesh, axis)
    y32 = y.float()
    absmax = y32.abs().amax().reshape(1)
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        div_exact(absmax, 127.0))
    q = torch.clamp(torch.round(y32 / scale), -127, 127).to(torch.int8)
    total = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    for part in _gather(q, mesh, axis):          # rank order
        total += part.to(torch.int32)
    return total.float() * scale


def all_gather_last(x: torch.Tensor, mesh, axis: str = "model"
                    ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last dim, in rank order
    (a column-sharded output made whole)."""
    return torch.cat(_gather(x, mesh, axis), dim=-1)


def all_to_all(blocks: Sequence[torch.Tensor], mesh, axis: Axes
               ) -> List[torch.Tensor]:
    """Block ``j`` of this rank's ``blocks`` (one a member of the group
    over ``axis``, in its order; all of one shape and dtype) to member
    ``j`` → the block each member sent this rank, in the group's order.

    One ``all_to_all_single`` of the blocks' bytes (gloo takes it on the
    CPU and on a card), so any dtype travels bit for bit."""
    group = _group(mesh, axis)
    if group is None:
        return [blocks[0]]
    shape, dtype = blocks[0].shape, blocks[0].dtype
    send = torch.cat([b.contiguous().reshape(-1).view(torch.uint8)
                      for b in blocks])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return [part.view(dtype).reshape(shape)
            for part in recv.chunk(len(blocks))]


def broadcast_ints(values: Sequence[int], mesh, axis: Axes = "model"
                   ) -> List[int]:
    """Rank 0's ``values`` on every rank (the same count on each)."""
    group = _group(mesh, axis)
    if group is None:
        return list(values)
    dev = mesh.device if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor(list(values), dtype=torch.long, device=dev)
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t.tolist()


def ring_collective_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
                           axis: str = "model") -> torch.Tensor:
    """x: this rank's (M/p, K) rows; w: its (K, N/p) columns → its
    (M, N/p) column block of ``concat(x) @ W``.

    Instead of gathering x up front, the ring rotates x's shards: at hop
    ``s`` this rank holds rank ``(r + s) % p``'s rows, multiplies them into
    their row block, and passes them to rank ``r - 1`` while taking the
    next from ``r + 1``. The wire carries one all-gather of x in all.
    """
    group = _group(mesh, axis)
    p, r = mesh.shape[axis], mesh.coords[axis]
    m_blk = x.shape[0]
    y = torch.zeros((m_blk * p, w.shape[1]), dtype=w.dtype, device=w.device)
    cur = x.contiguous()
    for step in range(p):
        src = (r + step) % p
        y[src * m_blk:(src + 1) * m_blk] = (cur @ w).to(y.dtype)
        if step != p - 1:
            nxt = torch.empty_like(cur)
            ops = [dist.P2POp(dist.isend, cur,
                              dist.get_global_rank(group, (r - 1) % p),
                              group),
                   dist.P2POp(dist.irecv, nxt,
                              dist.get_global_rank(group, (r + 1) % p),
                              group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            cur = nxt
    return y


def int8_allreduce_mean(g: torch.Tensor, mesh, axis: str = "model"
                        ) -> torch.Tensor:
    """Mean all-reduce of this rank's ``g`` with an int8-valued payload:
    quantized against the global absmax, int32 counts summed, dequantized
    and divided by the rank count; exact up to the shared step."""
    group = _group(mesh, axis)
    p = mesh.shape[axis]
    g32 = g.float()
    absmax = g32.abs().amax().reshape(1)
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        div_exact(absmax, 127.0))
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return div_exact(q.float() * scale, float(p)).to(g.dtype)
