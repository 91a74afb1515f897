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

Sharded (flat FSDP under a train :func:`~repro_torch.parallel.sharding.
mesh_context`): ``update(..., specs=)`` takes this rank's blocks of the
gradients, moments and params, with the params' spec tree, and keeps the
reference's global semantics (under GSPMD its reductions are over whole
arrays): the clipping norm sums every leaf's squares over its distinct
blocks (:func:`global_norm`), and an int8 moment's row absmax is the whole
row's, a MAX over the axes that split the last dim before K7's chain.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

import torch.distributed as dist

from repro_torch.kernels.quantize import quantize_lastdim
from repro_torch.launch.mesh import AXES
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import active_ctx, axes_of, live_axes
from repro_torch.tree import leaves, tree_map

RowMax = Optional[Callable[[torch.Tensor], torch.Tensor]]


def int8_moment_quant(x: torch.Tensor, *, sqrt_transform: bool = False,
                      row_max: RowMax = None) -> dict:
    """f32 tensor → {'q': int8 same shape, 'scale': f32 (..., 1)}; a 0-d
    x is taken as one row of one value (q and scale of shape (1,)).
    ``row_max``: for a block of longer rows, maps the block's row absmax
    to the whole rows' (:func:`row_max_of`)."""
    x32 = x.float()
    if sqrt_transform:
        x32 = torch.sqrt(torch.clamp_min(x32, 0.0))
    if x32.ndim == 0:
        x32 = x32[None]
    absmax = (None if row_max is None
              else row_max(x32.abs().amax(dim=-1, keepdim=True)))
    q, scale = quantize_lastdim(x32, bits=8, row_absmax=absmax)
    return {"q": q, "scale": scale}


def train_mesh():
    """The mesh of the active train-mode mesh context (raises without
    one: sharded state never runs as if it were whole)."""
    ctx = active_ctx()
    if ctx is None or ctx.mode != "train":
        raise RuntimeError("sharded training needs an active "
                           "mesh_context(..., mode='train')")
    return ctx.mesh


def row_max_of(spec: tuple, mesh) -> RowMax:
    """For a block under ``spec``: the MAX over the axes that split its
    last dim (None where none does)."""
    axes = axes_of(spec[-1]) if spec else ()
    if not any(mesh.shape[a] > 1 for a in axes):
        return None
    return lambda a: coll.all_reduce(a, mesh, axes, op=dist.ReduceOp.MAX)


def int8_moment_dequant(m: dict, *, sqrt_transform: bool = False,
                        scalar: bool = False) -> torch.Tensor:
    x = m["q"].float() * m["scale"]
    if sqrt_transform:
        x = torch.square(x)
    if scalar:
        x = x[0]
    return x


def global_norm(tree, specs=None) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in f32, leaves added in the reference's
    order. With ``specs`` (the tree holds this rank's blocks, under a
    train mesh context): each leaf's Σ g² summed over its distinct blocks
    (one all-reduce, a value a leaf; a block held by several ranks counts
    once, from the rank at coordinate 0 of every axis the leaf's spec
    leaves out)."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    if specs is not None:
        mesh = train_mesh()
        own = torch.tensor(
            [float(all(mesh.coords[a] == 0 for a in AXES
                       if a not in live_axes(spec, mesh)))
             for spec in leaves(specs)], device=sq[0].device)
        sq = coll.all_reduce(torch.stack(sq) * own, mesh, AXES).unbind()
    return torch.sqrt(sum(sq))


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def adamw(lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, quantize_moments: bool = False,
          grad_clip_norm: Optional[float] = 1.0) -> Optimizer:
    def _qm(x, sqrt_t=False, row_max=None):
        if quantize_moments:
            return int8_moment_quant(x, sqrt_transform=sqrt_t,
                                     row_max=row_max)
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
    def update(grads, state, params, *, specs=None):
        """``specs``: the params' spec tree when grads, state and params
        are this rank's blocks (module docstring)."""
        count = state["count"] + 1
        f32 = torch.float32
        if grad_clip_norm is not None:
            gnorm = global_norm(grads, specs)
            clip = torch.clamp(torch.full_like(gnorm, grad_clip_norm)
                               / (gnorm + 1e-9), max=1.0)
        else:
            clip = None
        cf = count.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=cf.device), cf)
        step_lr = (lr(count) if callable(lr)
                   else torch.tensor(lr, dtype=f32, device=cf.device))

        mesh = None if specs is None else train_mesh()

        def leaf(p, g, mq, vq, spec=None):
            g = g.float() if clip is None else g.float() * clip
            m = b1 * _dqm(mq, p) + (1 - b1) * g
            v = b2 * _dqm(vq, p, True) + (1 - b2) * torch.square(g)
            u = -(step_lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
            if weight_decay:
                u = u - step_lr * weight_decay * p.float()
            row_max = None if spec is None else row_max_of(spec, mesh)
            return u.to(p.dtype), _qm(m, row_max=row_max), _qm(
                v, True, row_max=row_max)

        trees = (params, grads, state["m"], state["v"])
        out = tree_map(leaf, *trees, *(() if specs is None else (specs,)))

        def part(i):
            return tree_map(lambda t: t[i], out)
        return part(0), {"m": part(1), "v": part(2), "count": count}

    return Optimizer(init=init, update=update)
