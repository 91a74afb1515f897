"""Train-step builder: loss → grads → (optional compression) → AdamW.

Port of ``repro/train/train_step.py``.

* Gradient accumulation is a Python-unrolled loop over micro-batches,
  each micro-batch's gradient divided by k before the sum, as in the
  reference.
* ``compress_grads='int8'`` quantizes → dequantizes each gradient leaf per
  row of its last axis (int8, absmax): the reference's numerics of an int8
  data-parallel all-reduce. The quantize is K7 on a CUDA tensor.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.quant import div_exact
from repro_torch.kernels.quantize import quantize_lastdim
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.optim.adamw import Optimizer, global_norm
from repro_torch.tree import leaves, tree_map, unflatten


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, *,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> dict:
    """{params, opt, step} with random params (``init_params``)."""
    params = init_params(cfg, generator=generator, device=device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params["final_norm"].device)}


def _int8_compress(g: torch.Tensor) -> torch.Tensor:
    """Quantize → dequantize a gradient leaf (per last-axis row, int8)."""
    if g.ndim == 0:
        return g
    q, scale = quantize_lastdim(g, bits=8)
    return (q.float() * scale).to(g.dtype)


def value_and_grad(loss: Callable, params, cfg: ModelConfig, batch: dict):
    """(loss, gradients in params' structure and dtypes) of
    ``loss(params, cfg, batch)``; a leaf the loss does not reach gets a
    zero gradient."""
    flat = leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        lval = loss(unflatten(params, live), cfg, batch)
    grads = torch.autograd.grad(lval, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return lval.detach(), unflatten(params, grads)


def build_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                     grad_accum: int = 1,
                     compress_grads: Optional[str] = None,
                     loss: Callable = loss_fn):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch['inputs']``: (GB, S) (or (GB, S, D) for embedding-input
    models), ``batch['labels']``: (GB, S), tensors on the state's device.
    With ``grad_accum=k`` the leading dim is split into k micro-batches.
    ``metrics``: ``loss`` and ``grad_norm`` (f32 tensors; reading one is
    the caller's host sync).
    """
    if compress_grads not in (None, "int8"):
        raise ValueError(f"compress_grads={compress_grads!r}: None or 'int8'")

    def train_step(state, batch):
        params = state["params"]
        if grad_accum == 1:
            lval, grads = value_and_grad(loss, params, cfg, batch)
        else:
            gb = batch["labels"].shape[0]
            if gb % grad_accum:
                raise ValueError(f"batch {gb} does not split into "
                                 f"{grad_accum} micro-batches")
            mbs = gb // grad_accum
            lval = torch.zeros((), dtype=torch.float32,
                               device=batch["labels"].device)
            grads = None
            for i in range(grad_accum):
                mb = {k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()}
                lv, g = value_and_grad(loss, params, cfg, mb)
                lval = lval + div_exact(lv, grad_accum)
                g = tree_map(lambda x: div_exact(x, grad_accum), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)

        with torch.no_grad():
            if compress_grads == "int8":
                grads = tree_map(_int8_compress, grads)
            updates, opt_state = optimizer.update(grads, state["opt"], params)
            new_params = tree_map(lambda p, u: p + u, params, updates)
            metrics = {"loss": lval, "grad_norm": global_norm(grads)}
        return ({"params": new_params, "opt": opt_state,
                 "step": state["step"] + 1}, metrics)

    return train_step
