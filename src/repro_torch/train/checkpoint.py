"""Checkpoints in the reference's on-disk format.

Port of ``repro/train/checkpoint.py``:

* ``save(dir, state, step)`` flattens the state tree to path-keyed arrays
  (keys are the ``/``-joined tree paths, dict keys and list indices, as
  the reference writes them; bf16 leaves widened to f32, losslessly) and
  writes ``step_<n>/arrays.npz`` plus ``manifest.json``, atomically (a
  ``.tmp_step_<n>`` directory renamed into place), optionally on a
  background thread so the loop never blocks on I/O. Older checkpoints
  past ``keep`` are removed.
* ``restore(dir, like)`` loads the newest (or a given) step into the
  structure of ``like``, each leaf cast back to the dtype and device of
  ``like``'s. A checkpoint written by either package restores in the
  other.
* A ``QuantizedTensor`` leaf is stored as its payload and scale under
  ``<path>/0`` and ``<path>/1`` (the reference flattens it so); ``bits``
  and the shape come back from ``like``.
* Sharded state (a train mesh): ``save(..., shardings=)`` gathers whole
  leaves, rank 0 writes them and the others wait at a barrier, so the
  files are the one-process format; ``restore(..., shardings=)`` slices
  every leaf to the target mesh's specs, so a checkpoint restores
  elastically onto any (d, m) mesh or one process.
* Crash safety: a checkpoint is only visible under its final name with
  its manifest; ``find_latest`` ignores half-written directories.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.quant import QuantizedTensor
from repro_torch.parallel.sharding import gather_tree, shard_leaf
from repro_torch.tree import leaves, leaves_with_path, unflatten

_CKPT_RE = re.compile(r"^step_(\d+)$")


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _arrays(path, leaf):
    """[(key, tensor)] of one leaf: a QuantizedTensor as its payload and
    scale."""
    if isinstance(leaf, QuantizedTensor):
        return [(_key(path + (0,)), leaf.q), (_key(path + (1,)), leaf.scale)]
    return [(_key(path), leaf)]


def _flatten(state) -> dict:
    flat = {}
    for path, leaf in leaves_with_path(state):
        for key, t in _arrays(path, leaf):
            t = t.detach()
            if t.dtype == torch.bfloat16:          # numpy has no bf16
                t = t.float()
            # a copy: the writer thread must not see later in-place updates
            flat[key] = t.to("cpu", copy=True).numpy()
    return flat


def _mesh(shardings):
    return leaves(shardings)[0].mesh


def save(ckpt_dir, state, step: int, *, keep: int = 3,
         async_: bool = False, shardings: Any = None
         ) -> Optional[threading.Thread]:
    """Write checkpoint ``step_<step>`` under ``ckpt_dir``; with
    ``async_`` the write runs on a started thread, returned to join.

    ``shardings`` (a tree of ``NamedSharding`` matching ``state``, whose
    leaves are this rank's shards): a collective of the mesh's ranks.
    Every rank gathers the whole leaves; rank 0 writes; a synchronous save
    returns on every rank once the files are in place (a barrier). An
    asynchronous one returns rank 0's writer thread (None elsewhere): join
    it, then meet the other ranks at a barrier before the files are read.
    """
    ckpt_dir = Path(ckpt_dir)
    mesh = None
    if shardings is not None:
        mesh = _mesh(shardings)
        state = gather_tree(state, shardings)
        if mesh.rank != 0:
            if not async_:
                dist.barrier(group=mesh.group)
            return None
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(state)                  # snapshot on the caller thread

    def _write():
        tmp = ckpt_dir / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "keys": sorted(flat)}))
        final = ckpt_dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if mesh is not None:
        dist.barrier(group=mesh.group)
    return None


def _gc(ckpt_dir: Path, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def all_steps(ckpt_dir) -> list:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        m = _CKPT_RE.match(p.name)
        if m and (p / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def find_latest(ckpt_dir) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir, like: Any, *, step: Optional[int] = None,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (a state tree of tensors and
    QuantizedTensors): each leaf takes the dtype and device of ``like``'s.

    ``shardings``: a matching tree of ``NamedSharding``; each whole leaf
    is sliced to this rank's block of its spec on its mesh (elastic: the
    checkpoint may come from any mesh or one process)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = find_latest(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    paths = leaves_with_path(like)
    named = (leaves(shardings) if shardings is not None
             else [None] * len(paths))
    out = []
    with np.load(ckpt_dir / f"step_{step}" / "arrays.npz") as data:
        def load(key, like_t):
            return torch.from_numpy(np.array(data[key], order="C")).to(
                device=like_t.device, dtype=like_t.dtype)
        for (path, leaf), sharding in zip(paths, named):
            if isinstance(leaf, QuantizedTensor):
                q, scale = (load(key, t) for key, t in _arrays(path, leaf))
                rows = q.shape[-2] * (2 if leaf.bits == 4 else 1)
                whole = QuantizedTensor(q=q, scale=scale, bits=leaf.bits,
                                        shape=(*q.shape[:-2], rows,
                                               q.shape[-1]))
            else:
                whole = load(_key(path), leaf)
            out.append(whole if sharding is None else
                       shard_leaf(whole, sharding.spec, sharding.mesh))
    return unflatten(like, out)
