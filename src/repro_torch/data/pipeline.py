"""Deterministic synthetic LM data pipeline.

Port of ``repro/data/pipeline.py``; :class:`SyntheticLMData` is plain
numpy and yields the reference's batches bit for bit.

* **step-addressable determinism**: the batch of step ``s`` is a pure
  function of ``(seed, s)``; a restart from a checkpoint replays the exact
  stream with no stored iterator state (the contract of
  :mod:`repro_torch.train.loop`).
* **feeding**: :func:`shard_batch` puts a host batch on the device; on a
  mesh of ranks, only this rank's rows (:class:`RankBatch`), by the specs
  ``spec_for`` gives the batch's dims (:func:`batch_specs`): the batch
  binds ``("data", "model")`` in training (recurrent families ``data``
  only), and rows the mesh does not divide stay replicated; under the
  multi-pod train rules the sequence binds ``pod``, and a rank holds its
  block of positions of its rows. With
  ``grad_accum=k`` a rank holds its block of each of the k global
  micro-batches, in order, as the reference's micro-batch i is global
  rows [i·GB/k, (i+1)·GB/k) (an MoE layer routes over each).
* **background prefetch**: a depth-2 thread prefetcher overlaps host data
  generation with device steps.

The token stream is a mixed Markov / Zipf source, so the LM loss has real
structure to learn.
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import (_block, axes_of, block_view,
                                           spec_for)


class SyntheticLMData:
    def __init__(self, vocab_size: int, batch: int, seq: int, *,
                 seed: int = 0, embedding_dim: Optional[int] = None):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.embedding_dim = embedding_dim
        # fixed Markov backbone: each token prefers a successor band
        self._succ = np.random.default_rng(seed).integers(
            0, vocab_size, size=(min(vocab_size, 4096),), dtype=np.int64)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        noise = rng.random((self.batch, self.seq))
        jump = rng.integers(0, self.vocab, (self.batch, self.seq))
        for t in range(self.seq):
            follow = self._succ[toks[:, t] % len(self._succ)] % self.vocab
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, follow, jump[:, t])
        out = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        if self.embedding_dim:                  # embedding-input models
            emb = rng.standard_normal(
                (self.batch, self.seq, self.embedding_dim)).astype(np.float32)
            out["inputs"] = emb
        return out

    def __iter__(self) -> Iterator[dict]:
        s = 0
        while True:
            yield self.batch_at(s)
            s += 1


class RankBatch(dict):
    """This rank's block of a batch (:func:`shard_batch` on a mesh).

    ``axes``: the mesh axes the rows are split over (empty: every rank
    holds every row); ``seq_axes``: those the sequence is split over (the
    multi-pod train rules' ``pod``; empty: every rank holds the whole
    sequence of its rows); ``shards``: how many distinct blocks of tokens
    (rows × sequence) the mesh holds; ``micro``: how many micro-batches
    the rows hold (this rank's block of each, in order); ``start``: the
    position of the block's first token in its sequence. The sharded
    train step reduces its gradients over ``axes`` and ``seq_axes`` and
    divides by ``shards``, so replicated tokens count once.
    """

    def __init__(self, rows: dict, axes: tuple, shards: int,
                 micro: int = 1, seq_axes: tuple = (), start: int = 0):
        super().__init__(rows)
        self.axes, self.shards = tuple(axes), int(shards)
        self.micro = int(micro)
        self.seq_axes, self.start = tuple(seq_axes), int(start)


def batch_specs(batch: dict, rules, mesh, grad_accum: int = 1) -> dict:
    """The spec of each array of a host batch: dims named ``("batch",
    "seq_act")`` (embedding inputs: ``+ ("embed",)``), as the reference's
    dry run names them; with ``grad_accum``, of each of its micro-batches.
    Only the multi-pod train rules bind ``seq_act`` (to ``pod``)."""
    names = ("batch", "seq_act", "embed")

    def shape(v):
        gb = np.shape(v)[0]
        if gb % grad_accum:
            raise ValueError(f"batch {gb} does not split into {grad_accum} "
                             "micro-batches")
        return (gb // grad_accum,) + np.shape(v)[1:]
    return {k: spec_for(shape(v), names[:np.ndim(v)], rules, mesh)
            for k, v in batch.items()}


def _split_of(specs: dict, dim: int, mesh) -> tuple:
    """(the axes every array's ``dim`` binds, their rank count)."""
    bound = {specs[k][dim] for k in specs}
    if len(bound) != 1:
        raise ValueError(f"the arrays' dim {dim} binds apart: {bound}")
    axes = axes_of(bound.pop())
    return axes, math.prod(mesh.shape[a] for a in axes)


def shard_batch(batch: dict, mesh=None, specs: Optional[dict] = None, *,
                device=None, grad_accum: int = 1) -> dict:
    """A host batch of numpy arrays → tensors on ``device`` (default: the
    card; see :func:`repro_torch.device.resolve_device`; on a mesh, the
    mesh's device). With ``mesh`` and ``specs`` (:func:`batch_specs` with
    the same ``grad_accum``): this rank's block of every array (its rows,
    and under the multi-pod train rules its block of the sequence), of
    each micro-batch in turn, as a :class:`RankBatch`; every array's
    batch dim must bind the same axes, and so must its sequence dim."""
    if mesh is None:
        if specs is not None:
            raise ValueError("specs without a mesh")
        device = resolve_device(device)
        return {k: torch.from_numpy(np.array(v, order="C")).to(device)
                for k, v in batch.items()}
    if specs is None:
        raise ValueError("a mesh needs the batch's specs (batch_specs)")
    device = mesh.device if device is None else torch.device(device)
    axes, rows = _split_of(specs, 0, mesh)
    seq_axes, blocks = _split_of(specs, 1, mesh)
    seq_len = {np.shape(v)[1] for v in batch.values()}.pop()
    start = _block(seq_axes, mesh.coords, mesh)[0] * (seq_len // blocks)

    def rows_of(v, spec):
        v = torch.from_numpy(np.asarray(v))
        if v.shape[0] % grad_accum:
            raise ValueError(f"batch {v.shape[0]} does not split into "
                             f"{grad_accum} micro-batches")
        return torch.cat([block_view(x, spec, mesh)
                          for x in v.chunk(grad_accum)]).contiguous().to(
                              device)
    return RankBatch({k: rows_of(v, specs[k]) for k, v in batch.items()},
                     axes, rows * blocks, grad_accum, seq_axes, start)


class Prefetcher:
    """Depth-N background prefetch over a data iterator."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
