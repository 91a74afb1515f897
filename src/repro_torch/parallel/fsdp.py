"""Flat FSDP, one layer at a time: the sharded train step's gather and
reduce inside the forward and backward.

The reference's train rules gather one layer's parameters at a time
(flat FSDP / ZeRO-3): GSPMD all-gathers a block's weights where the
block runs and reduce-scatters its gradients where its backward ends,
and ``jax.checkpoint`` per block gathers them again for the recompute.
Here the sharded step (:mod:`repro_torch.train.train_step`) enters
:func:`sharded_step` around its forward and backward, and the model code
asks :func:`whole` for a part of the params where it uses it:

* ``whole(layer, ("layers", i))`` at the top of each block, inside the
  block's checkpoint: an autograd function whose forward all-gathers the
  layer's blocks (one call a group of mesh axes and dtype) and whose
  backward reduces the layer's whole gradient to this rank's block at
  once (:func:`reduce_blocks`: the sum over the ranks holding distinct
  rows, divided by their count). Under ``cfg.remat`` the backward's
  recompute gathers the layer again, as the reference's remat does, and
  the gathered layer lives only while its block runs; without remat
  the gathered layer is what autograd saves for the backward, so every
  layer stays whole until its backward has run.
* ``whole(leaf, (name,))`` around each use of a top-level leaf (the
  embedding's lookup, a tied head, the untied ``lm_head``,
  ``final_norm``).

No rank ever holds the whole gradient tree: each gather's backward hands
autograd this rank's reduced blocks. Outside :func:`sharded_step`,
:func:`whole` returns its argument.

Under the multi-pod train rules the batch's sequence is split over
``pod`` too (``RankBatch.seq_axes``): a rank's loss is the mean of its
own positions, every leaf's block is a replica over ``pod``, and each
reduce sums over the sequence's axes as well (:func:`reduce_blocks`);
the model reads :func:`seq_split` for its block's positions and
:func:`batch_split` for its tokens' runs in the global order.

The step's setting is a module global, not a context variable: the
backward (and the recompute inside it) runs on autograd's worker threads,
which see no context variable of the caller's. Steps of one process run
one at a time.

:class:`Step` counts the collectives (calls, and the bytes a rank sends
under ring algorithms: ``(p - 1)/p`` of the payload for an all-gather or
a reduce-scatter, ``2 (p - 1)/p`` for an all-reduce) of the forward
gathers, the recompute gathers and the reduces, and the largest number
of whole bytes gathered and alive at once (a weak reference a gathered
tensor's storage, read at every gather and reduce).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.core.quant import div_exact
from repro_torch.launch.mesh import AXES
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (Split, _block, block_view,
                                           live_axes, token_split)
from repro_torch.tree import leaves, unflatten

KINDS = ("gather", "regather", "reduce")


class Step:
    """One sharded step: the mesh, the params' spec tree, the axes the
    batch's rows are split over (``RankBatch.axes``), the axes its
    sequence is split over (``RankBatch.seq_axes``: the multi-pod train
    rules' ``pod``) and the number of distinct token blocks
    (``RankBatch.shards``); its counters."""

    def __init__(self, mesh, specs, batch_axes: tuple, shards: int,
                 seq_axes: tuple = ()):
        self.mesh, self.specs = mesh, specs
        self.batch_axes = tuple(a for a in AXES if a in batch_axes
                                and mesh.shape[a] > 1)
        self.seq_axes = tuple(a for a in AXES if a in seq_axes
                              and mesh.shape[a] > 1)
        self.shards = int(shards)
        self.calls = {k: 0 for k in KINDS}
        self.sent = {k: 0 for k in KINDS}
        self.peak_whole = 0
        self._alive: list = []

    def batch_index(self) -> int:
        """This rank's index among the ranks along the batch axes (its
        block of the rows), row-major over them."""
        return _block(self.batch_axes, self.mesh.coords, self.mesh)[0]

    def _count(self, kind: str, payload: int, ways: int, factor: int = 1):
        self.calls[kind] += 1
        self.sent[kind] += factor * (ways - 1) * payload // ways

    def _hold(self, xs) -> None:
        for x in xs:
            self._alive.append((StorageWeakRef(x.untyped_storage()),
                                x.untyped_storage().nbytes()))
        self._sample()

    def _sample(self) -> None:
        self._alive = [(r, n) for r, n in self._alive if not r.expired()]
        self.peak_whole = max(self.peak_whole,
                              sum(n for _, n in self._alive))

    def gather(self, blocks, specs) -> list:
        """The whole leaves of ``blocks`` (this rank's, under ``specs``):
        one all-gather a group of mesh axes and dtype; a leaf no axis
        splits is copied."""
        mesh = self.mesh
        out = [None] * len(blocks)
        buckets: dict = {}
        for i, (x, spec) in enumerate(zip(blocks, specs)):
            axes = live_axes(spec, mesh)
            if axes:
                buckets.setdefault((axes, x.dtype), []).append(i)
            else:
                out[i] = x.clone()
        # inside autograd's backward (a checkpoint's recompute) or not
        kind = ("regather" if torch._C._current_graph_task_id() >= 0
                else "gather")
        for (axes, _), idx in buckets.items():
            flat = torch.cat([blocks[i].reshape(-1) for i in idx])
            parts = coll.gather_blocks(flat, mesh, axes)
            self._count(kind, flat.numel() * flat.element_size() * len(parts),
                        len(parts))
            for i in idx:
                out[i] = blocks[i].new_empty(
                    [d * _block(e, mesh.coords, mesh)[1]
                     for d, e in zip(blocks[i].shape, specs[i])])
            for j, part in enumerate(parts):
                coords = mesh.member_coords(axes, j)
                for i, piece in zip(idx, part.split(
                        [blocks[i].numel() for i in idx])):
                    block_view(out[i], specs[i], mesh, coords).copy_(
                        piece.view(blocks[i].shape))
        self._hold(out)
        return out


def reduce_blocks(step: Step, grads, specs) -> list:
    """This rank's block of every mean gradient of ``grads`` (whole
    leaves under ``specs``): its block summed in f32 over the ranks along
    the step's batch and sequence axes (those holding distinct tokens),
    divided by the step's shard count, in the leaf's dtype. The leaves
    the batch axes shard are reduce-scattered over them (each member of
    the group gets its own block), then all-reduced over the sequence
    axes (a leaf's block is the same on every sequence block's rank);
    the others are all-reduced over both: one call each, over one flat
    buffer."""
    mesh, live, seq = step.mesh, step.batch_axes, step.seq_axes
    scatter = [i for i, s in enumerate(specs)
               if set(live) & set(live_axes(s, mesh))]
    whole = sorted(set(range(len(grads))) - set(scatter))
    n = int(math.prod(mesh.shape[a] for a in live))
    n_seq = int(math.prod(mesh.shape[a] for a in seq))
    out = [None] * len(grads)

    def flat(idx, coords=None):
        return torch.cat([block_view(grads[i], specs[i], mesh, coords)
                          .float().reshape(-1) for i in idx])

    def place(idx, total):
        shapes = [block_view(grads[i], specs[i], mesh).shape for i in idx]
        pieces = total.split([math.prod(x) for x in shapes])
        for i, shape, piece in zip(idx, shapes, pieces):
            out[i] = div_exact(piece.view(shape), step.shards).to(
                grads[i].dtype)

    if scatter:
        blocks = [flat(scatter, mesh.member_coords(live, j))
                  for j in range(n)]
        step._count("reduce", blocks[0].numel() * 4 * n, n)
        total = coll.reduce_scatter(blocks, mesh, live)
        if seq:
            step._count("reduce", total.numel() * 4, n_seq, factor=2)
            total = coll.all_reduce(total, mesh, seq)
        place(scatter, total)
    if whole:
        total = flat(whole)
        if n * n_seq > 1:
            step._count("reduce", total.numel() * 4, n * n_seq, factor=2)
        place(whole, coll.all_reduce(total, mesh, live + seq))
    return out


class _Gather(torch.autograd.Function):
    """Blocks → whole leaves; the backward reduces the whole gradients to
    this rank's blocks (:func:`reduce_blocks`, looked up at call time)."""

    @staticmethod
    def forward(ctx, step, specs, *blocks):
        ctx.step, ctx.specs = step, specs
        return tuple(step.gather(blocks, specs))

    @staticmethod
    def backward(ctx, *grads):
        step = ctx.step
        step._sample()
        return (None, None, *reduce_blocks(step, list(grads), ctx.specs))


_STEP: Optional[Step] = None


@contextlib.contextmanager
def sharded_step(mesh, specs, batch_axes: tuple, shards: int,
                 seq_axes: tuple = ()):
    """Make one sharded step's setting current for :func:`whole`,
    :func:`batch_split` and :func:`seq_split` (the forward, the backward
    and its recompute)."""
    global _STEP
    if _STEP is not None:
        raise RuntimeError("a sharded step is already running")
    _STEP = Step(mesh, specs, batch_axes, shards, seq_axes)
    try:
        yield _STEP
    finally:
        _STEP = None


def whole(tree, path: tuple):
    """The part of the params at ``path`` (a tuple of keys and indices
    into the params tree, ``tree`` its blocks) made whole, under a
    sharded step; ``tree`` itself otherwise."""
    step = _STEP
    if step is None:
        return tree
    spec = step.specs
    for key in path:
        spec = spec[key]
    blocks = leaves(tree)
    return unflatten(tree, _Gather.apply(step, leaves(spec), *blocks))


def batch_split() -> Optional[Split]:
    """Under a sharded step whose tokens are split over ranks (rows, or
    the sequence too): the :class:`~repro_torch.parallel.sharding.Split`
    of its token blocks; None otherwise."""
    step = _STEP
    if step is None or not (step.batch_axes or step.seq_axes):
        return None
    return token_split(step.mesh, step.batch_axes, step.seq_axes)


def seq_split() -> Optional[Split]:
    """Under a sharded step whose sequence is split over ranks: its
    :func:`batch_split` (``seq_axes`` the sequence's axes, ``seq_index``
    this rank's block of it); None otherwise."""
    split = batch_split()
    return split if split is not None and split.seq_axes else None
