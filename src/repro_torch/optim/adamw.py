"""AdamW with optional int8-quantized moments.

Port of ``repro/optim/adamw.py``. The quantized-moment option is the CAMP
storage idea applied to optimizer state: each moment is stored as an int8
payload **in the parameter's own shape** plus per-row (last-axis) f32
absmax scales; the second moment goes through a sqrt transform
(``q = sqrt(v) / scale``) to compress its dynamic range (8-bit Adam). The
rowwise quantize is K7 (:func:`repro_torch.kernels.quantize.
quantize_lastdim`) on a CUDA tensor and its plain version on a CPU one:
the reference's chain under ``jit``, bit for bit.

Functional API, as the reference's (optax-like), over the port's dict /
list trees (:mod:`repro_torch.tree`):

    opt = adamw(lr=..., quantize_moments=True)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = tree_map(lambda p, u: p + u, params, updates)

Updates are rounded to each parameter's dtype and added in it: there are
no f32 master weights, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.kernels.quantize import quantize_lastdim
from repro_torch.tree import leaves, tree_map


def int8_moment_quant(x: torch.Tensor, *, sqrt_transform: bool = False
                      ) -> dict:
    """f32 tensor → {'q': int8 same shape, 'scale': f32 (..., 1)}; a 0-d
    x is taken as one row of one value (q and scale of shape (1,))."""
    x32 = x.float()
    if sqrt_transform:
        x32 = torch.sqrt(torch.clamp_min(x32, 0.0))
    if x32.ndim == 0:
        x32 = x32[None]
    q, scale = quantize_lastdim(x32, bits=8)
    return {"q": q, "scale": scale}


def int8_moment_dequant(m: dict, *, sqrt_transform: bool = False,
                        scalar: bool = False) -> torch.Tensor:
    x = m["q"].float() * m["scale"]
    if sqrt_transform:
        x = torch.square(x)
    if scalar:
        x = x[0]
    return x


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in f32 (the reference's order)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def adamw(lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, quantize_moments: bool = False,
          grad_clip_norm: Optional[float] = 1.0) -> Optimizer:
    def _qm(x, sqrt_t=False):
        if quantize_moments:
            return int8_moment_quant(x, sqrt_transform=sqrt_t)
        return x.float()

    def _dqm(m, like, sqrt_t=False):
        if quantize_moments:
            return int8_moment_dequant(m, sqrt_transform=sqrt_t,
                                       scalar=(like.ndim == 0))
        return m

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        count_dev = leaves(params)[0].device
        return {"m": tree_map(lambda p: _qm(zeros(p)), params),
                "v": tree_map(lambda p: _qm(zeros(p), True), params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=count_dev)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        f32 = torch.float32
        if grad_clip_norm is not None:
            gnorm = global_norm(grads)
            clip = torch.clamp(torch.full_like(gnorm, grad_clip_norm)
                               / (gnorm + 1e-9), max=1.0)
        else:
            clip = None
        cf = count.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=cf.device), cf)
        step_lr = (lr(count) if callable(lr)
                   else torch.tensor(lr, dtype=f32, device=cf.device))

        def leaf(p, g, mq, vq):
            g = g.float() if clip is None else g.float() * clip
            m = b1 * _dqm(mq, p) + (1 - b1) * g
            v = b2 * _dqm(vq, p, True) + (1 - b2) * torch.square(g)
            u = -(step_lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
            if weight_decay:
                u = u - step_lr * weight_decay * p.float()
            return u.to(p.dtype), _qm(m), _qm(v, True)

        out = tree_map(leaf, params, grads, state["m"], state["v"])

        def part(i):
            return tree_map(lambda t: t[i], out)
        return part(0), {"m": part(1), "v": part(2), "count": count}

    return Optimizer(init=init, update=update)
