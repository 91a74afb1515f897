"""Train-step builder: loss → grads → (optional compression) → AdamW.

Port of ``repro/train/train_step.py``.

* Gradient accumulation is a Python-unrolled loop over micro-batches,
  each micro-batch's gradient divided by k before the sum, as in the
  reference.
* ``compress_grads='int8'`` quantizes → dequantizes each gradient leaf per
  row of its last axis (int8, absmax): the reference's numerics of an int8
  data-parallel all-reduce. The quantize is K7 on a CUDA tensor.

Under a train :func:`~repro_torch.parallel.sharding.mesh_context` (flat
FSDP on a (data, model) mesh of ranks, the counterpart of the reference's
GSPMD step under ``make_rules("train", family=...)``, every model family;
under ``make_rules("train", multi_pod=True)`` on a (pod, data, model)
mesh, where a rank's rows hold its block of the sequence) the state
holds this rank's blocks of the params and moments
(:func:`~repro_torch.parallel.sharding.shard_tree` by
:func:`~repro_torch.parallel.sharding.train_state_pspecs`) and the batch
is this rank's rows of each global micro-batch (``shard_batch(mesh=,
grad_accum=)``). A step:

1. computes the loss and gradients on this rank's rows inside
   :func:`~repro_torch.parallel.fsdp.sharded_step`: each block gathers its
   layer where it runs (again in its recompute), each top-level leaf is
   gathered around its use, and each gather's backward reduces its whole
   gradients to this rank's blocks, summed over the ranks that hold
   distinct rows and divided by their count (rows a batch replicates
   count once; :func:`~repro_torch.parallel.fsdp.reduce_blocks`). An MoE
   layer routes the global micro-batch's groups (its counts exchanged
   over the batch axes, its aux loss over the global tokens). Under a
   sequence split each mixer gathers its sequence over ``pod``, and the
   gradients are summed over ``pod`` too;
2. reduces the loss alike (over ``pod`` too);
3. compresses the reduced gradient blocks with each whole row's absmax
   (``int8``), and runs AdamW on the blocks (``update(specs=)``).

No rank holds the whole params or the whole gradient tree.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.quant import div_exact
from repro_torch.data.pipeline import RankBatch
from repro_torch.kernels.quantize import quantize_lastdim
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.optim.adamw import (Optimizer, RowMax, global_norm,
                                     row_max_of)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import (active_ctx, block_shape,
                                           params_pspecs)
from repro_torch.tree import leaves, tree_map, unflatten


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, *,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> dict:
    """{params, opt, step} with random params (``init_params``)."""
    params = init_params(cfg, generator=generator, device=device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params["final_norm"].device)}


def _int8_compress(g: torch.Tensor, row_max: RowMax = None
                   ) -> torch.Tensor:
    """Quantize → dequantize a gradient leaf (per last-axis row, int8);
    ``row_max`` as :func:`~repro_torch.optim.adamw.int8_moment_quant`'s."""
    if g.ndim == 0:
        return g
    absmax = (None if row_max is None
              else row_max(g.abs().amax(dim=-1, keepdim=True)))
    q, scale = quantize_lastdim(g, bits=8, row_absmax=absmax)
    return (q.float() * scale).to(g.dtype)


def param_specs(cfg: ModelConfig, rules, mesh):
    """(spec tree, shape tree) of ``cfg``'s whole params on ``mesh``
    (shapes from meta tensors: nothing is allocated)."""
    meta = init_params(cfg, generator=torch.Generator(), device="meta")
    return (params_pspecs(meta, rules, mesh),
            tree_map(lambda p: tuple(p.shape), meta))


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
    With ``grad_accum=k`` the leading dim is split into k micro-batches
    (under a train mesh: this rank's rows of each, ``shard_batch(...,
    grad_accum=k)``). ``metrics``: ``loss`` and ``grad_norm`` (f32
    tensors; reading one is the caller's host sync). After a sharded
    step, ``train_step.last`` is its :class:`~repro_torch.parallel.fsdp.
    Step` (the collectives' counts and the peak of whole bytes).
    """
    if compress_grads not in (None, "int8"):
        raise ValueError(f"compress_grads={compress_grads!r}: None or 'int8'")
    specs_of: dict = {}

    def local_grads(params, batch):
        """(loss, gradients) of ``batch``, split into micro-batches."""
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
        return lval, grads

    def sharded_step(state, batch, ctx):
        if not isinstance(batch, RankBatch):
            raise TypeError("under a train mesh the step takes this rank's "
                            "rows: shard_batch(batch, mesh=, specs=)")
        if batch.micro != grad_accum:
            raise ValueError(f"the batch was sharded for {batch.micro} "
                             f"micro-batches, the step takes {grad_accum}")
        mesh = ctx.mesh
        key = (id(mesh), repr(sorted(ctx.rules.items())))
        if key not in specs_of:
            specs_of.clear()
            specs_of[key] = param_specs(cfg, ctx.rules, mesh)
        specs, shapes = specs_of[key]
        if [tuple(p.shape) for p in leaves(state["params"])] != [
                block_shape(x, spec, mesh)
                for x, spec in zip(leaves(shapes), leaves(specs))]:
            raise ValueError("under a train mesh the state holds this "
                             "rank's shards (shard_tree by "
                             "train_state_pspecs)")
        with fsdp.sharded_step(mesh, specs, batch.axes, batch.shards,
                               batch.seq_axes) as step:
            lval, grads = local_grads(state["params"], batch)
        train_step.last = step
        with torch.no_grad():
            lval = div_exact(coll.all_reduce(
                lval, mesh, batch.axes + batch.seq_axes), batch.shards)
            if compress_grads == "int8":
                grads = tree_map(lambda g, spec: _int8_compress(
                    g, row_max_of(spec, mesh)), grads, specs)
            updates, opt_state = optimizer.update(
                grads, state["opt"], state["params"], specs=specs)
            new_params = tree_map(lambda p, u: p + u, state["params"],
                                  updates)
            metrics = {"loss": lval, "grad_norm": global_norm(grads, specs)}
        return ({"params": new_params, "opt": opt_state,
                 "step": state["step"] + 1}, metrics)

    def train_step(state, batch):
        ctx = active_ctx()
        if ctx is not None and ctx.mode == "train":
            return sharded_step(state, batch, ctx)
        params = state["params"]
        lval, grads = local_grads(params, batch)

        with torch.no_grad():
            if compress_grads == "int8":
                grads = tree_map(_int8_compress, grads)
            updates, opt_state = optimizer.update(grads, state["opt"], params)
            new_params = tree_map(lambda p, u: p + u, params, updates)
            metrics = {"loss": lval, "grad_norm": global_norm(grads)}
        return ({"params": new_params, "opt": opt_state,
                 "step": state["step"] + 1}, metrics)

    train_step.last = None
    train_step.grad_accum = grad_accum    # the loop shards batches by it
    return train_step
