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

from repro_torch.tree import leaves_with_path, unflatten

_CKPT_RE = re.compile(r"^step_(\d+)$")


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _flatten(state) -> dict:
    flat = {}
    for path, leaf in leaves_with_path(state):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:          # numpy has no bf16
            t = t.float()
        # a copy: the writer thread must not see later in-place updates
        flat[_key(path)] = t.to("cpu", copy=True).numpy()
    return flat


def save(ckpt_dir, state, step: int, *, keep: int = 3,
         async_: bool = False) -> Optional[threading.Thread]:
    """Write checkpoint ``step_<step>`` under ``ckpt_dir``; with
    ``async_`` the write runs on a started thread, returned to join."""
    ckpt_dir = Path(ckpt_dir)
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


def restore(ckpt_dir, like: Any, *, step: Optional[int] = None) -> Any:
    """Restore into the structure of ``like`` (a state tree of tensors):
    each leaf takes the dtype and device of ``like``'s."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = find_latest(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    out = []
    with np.load(ckpt_dir / f"step_{step}" / "arrays.npz") as data:
        for path, leaf in leaves_with_path(like):
            arr = np.array(data[_key(path)], order="C")
            out.append(torch.from_numpy(arr).to(device=leaf.device,
                                                dtype=leaf.dtype))
    return unflatten(like, out)
