"""Carry weights across from the JAX reference.

``jax.random`` cannot be replayed in PyTorch, so the parity tests hand the
reference's own weights to the port. The input is framework-neutral: a
nested dict/list of **numpy arrays**, with each quantized weight given as a
dict ``{"q", "scale", "bits", "shape"}`` (for ``bits`` 4, ``q`` is the
packed (K//2, N) payload and ``shape`` the logical (K, N)). bf16 leaves arrive as ``uint16``
views of their bits, because ``torch.from_numpy`` rejects ml_dtypes'
bfloat16; they become ``torch.bfloat16`` through a bit view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.device import resolve_device

_QT_KEYS = {"q", "scale", "bits", "shape"}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")          # a contiguous copy; 0-d stays 0-d
    if a.dtype == np.uint16:
        return torch.from_numpy(a).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(tree, device=None):
    """Numpy params tree (see module docstring) → the port's params."""
    device = resolve_device(device)

    def walk(x):
        if isinstance(x, dict) and set(x) == _QT_KEYS:
            return QuantizedTensor(q=_tensor(x["q"], device),
                                   scale=_tensor(x["scale"], device),
                                   bits=int(x["bits"]),
                                   shape=tuple(int(d) for d in x["shape"]))
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        if isinstance(x, np.ndarray):
            return _tensor(x, device)
        raise TypeError(f"unsupported leaf {type(x)}")

    return walk(tree)


def from_jax_train_state(state: dict, device=None) -> dict:
    """The reference's ``init_train_state`` output as numpy (see the module
    docstring) → the port's train state: ``{"params", "opt": {"m", "v",
    "count"}, "step"}``, int8 moments as ``{"q", "scale"}`` dicts, and
    ``count`` and ``step`` 0-d int32 tensors. The port then starts from
    the reference's exact state."""
    if set(state) != {"params", "opt", "step"}:
        raise ValueError(f"a train state has params, opt and step; got "
                         f"{sorted(state)}")
    return {k: from_jax_params(v, device) for k, v in state.items()}
