"""Rank bodies of ``tests/test_torch_fsdp_families.py``: the port's sharded
training of the MoE and recurrent families on a (2, 2) mesh of gloo CPU
ranks.

:func:`run_all` runs every case of ``fsdp_families_reference.CASES`` from
the parent's converted initial states (a ``torch.save`` file), then the
checks of one layer at a time (the whole bytes gathered at once, against
a control that gathers the whole tree first), the MoE aux loss's
gradient over split rows (against a control whose all-reduce does not
sum in the backward) and a checkpoint of a MoE state. This module
imports neither ``jax`` nor the reference package.
"""
import math
import os

import torch

from repro_torch.configs import get_config
from repro_torch.data import batch_specs, shard_batch
from repro_torch.models import moe
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import (gather_tree, make_rules,
                                           mesh_context, named, shard_tree,
                                           train_state_pspecs)
from repro_torch.train import build_train_step
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import param_specs
from repro_torch.tree import leaves
from torch_fsdp_worker import pair_mesh

LR = 1e-2


def config(arch):
    return get_config(arch, reduced=True, dtype="float32")


def whole_bytes(cfg) -> dict:
    """From the shapes: the largest layer's whole bytes and the largest
    top-level leaf's."""
    _, shapes = param_specs(cfg, make_rules("train", family=cfg.family),
                            _One())
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()

    def size(tree):
        return sum(math.prod(s) for s in leaves(tree)) * item
    return dict(layer=max(size(lay) for lay in shapes["layers"]),
                top=max(size(v) for k, v in shapes.items() if k != "layers"))


class _One:
    shape = {"data": 1, "model": 1}
    coords = {"data": 0, "model": 0}


def tree_first(params, cfg, batch):
    """The control: the whole params gathered before the loss and held
    to its end (the gradient unchanged: they enter it times zero)."""
    held = fsdp.whole(params, ())
    zero = sum(x.sum() for x in leaves(held)) * 0.0
    return loss_fn(params, cfg, batch) + zero


def run_case(mesh, case, state, batches, loss=loss_fn):
    """The steps of one case on this rank's rows → (state, metrics, the
    whole params after each step on rank 0, each step's collectives)."""
    arch, qm, cg, accum, eps = case
    cfg = config(arch)
    rules = make_rules("train", family=cfg.family)
    step = build_train_step(cfg, adamw(lr=LR, quantize_moments=qm, eps=eps),
                            grad_accum=accum, compress_grads=cg, loss=loss)
    specs, _ = param_specs(cfg, rules, mesh)
    out = dict(loss=[], grad_norm=[], params=[], peak=[], calls=[], sent=[])
    for b in batches:
        state, m = step(state, shard_batch(
            b, mesh=mesh, specs=batch_specs(b, rules, mesh, accum),
            grad_accum=accum))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        whole = gather_tree(state["params"], named(specs, mesh))
        if mesh.rank == 0:
            out["params"].append(whole)
        out["peak"].append(step.last.peak_whole)
        out["calls"].append(dict(step.last.calls))
        out["sent"].append(dict(step.last.sent))
    return state, out


def aux_grad(mesh, params, x, control: bool):
    """d(aux)/d(router) of layer 0's MoE FFN over this rank's rows of
    ``x`` (B, S, D), summed over the ranks and divided by their count (as
    the step reduces it) → (this, one process's on the whole x). The
    control's all-reduce does not sum in the backward."""
    cfg = config("moonshot-v1-16b-a3b")
    p = params["layers"][0]["moe"]
    n = mesh.shape["data"] * mesh.shape["model"]
    rows = x.shape[0] // n
    mine = x[mesh.rank * rows:(mesh.rank + 1) * rows]

    def grad(x_in):
        router = p["router"].detach().requires_grad_(True)
        _, aux = moe.moe_ffn({**p, "router": router}, cfg, x_in)
        return torch.autograd.grad(aux, router)[0]
    one = grad(x)
    psum_grad = moe.psum_grad
    if control:
        class NoSum(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                return coll.all_reduce(t, mesh, ("data", "model"))

            @staticmethod
            def backward(ctx, g):
                return g
        moe.psum_grad = lambda t, m, axes: NoSum.apply(t)
    try:
        with fsdp.sharded_step(mesh, {}, ("data", "model"), n):
            g = grad(mine)
    finally:
        moe.psum_grad = psum_grad
    return coll.all_reduce(g, mesh, ("data", "model")) / n, one


def run_all(mesh, path):
    torch.set_num_threads(1)
    inp = torch.load(path, weights_only=False)
    out = {"rank": mesh.rank}
    pair = pair_mesh(mesh)
    states = {}
    for name, case in inp["cases"].items():
        cfg = config(case[0])
        rules = make_rules("train", family=cfg.family)
        with mesh_context(mesh, rules, mode="train"):
            full = inp["states"][name]
            sh = named(train_state_pspecs(full, rules, mesh), mesh)
            states[name], out[name] = run_case(
                mesh, case, shard_tree(full, sh), inp["batches"][name])
        out[name]["bytes"] = whole_bytes(cfg)
    # the control: the whole tree gathered first, one step
    name = "moonshot f32"
    case = inp["cases"][name]
    rules = make_rules("train", family="moe")
    with mesh_context(mesh, rules, mode="train"):
        full = inp["states"][name]
        sh = named(train_state_pspecs(full, rules, mesh), mesh)
        _, res = run_case(mesh, case, shard_tree(full, sh),
                          inp["batches"][name][:1], loss=tree_first)
    out["tree_first"] = dict(peak=res["peak"][0], loss=res["loss"][0])
    del res
    # the aux loss's gradient over split rows, and its control
    whole_params = inp["states"][name]["params"]
    out["aux"] = aux_grad(mesh, whole_params, inp["aux_x"], False)
    out["aux_control"] = aux_grad(mesh, whole_params, inp["aux_x"], True)[0]
    # a MoE checkpoint: saved on (2, 2), restored on (2, 2) and (1, 2)
    name = "moonshot int8"
    with mesh_context(mesh, rules, mode="train"):
        full = inp["states"][name]
        sh = named(train_state_pspecs(full, rules, mesh), mesh)
        d = os.path.join(inp["tmp"], "moe")
        ckpt.save(d, states[name], 3, shardings=sh)
        saved = gather_tree(states[name], sh)
        if mesh.rank == 0:
            out["saved_state"] = saved
        back = ckpt.restore(d, shard_tree(full, sh), shardings=sh)
        out["restored_same_mesh"] = all(
            torch.equal(a, b) for a, b in zip(leaves(back),
                                              leaves(states[name])))
    if pair is not None:
        with mesh_context(pair, rules, mode="train"):
            sh12 = named(train_state_pspecs(full, rules, pair), pair)
            back = ckpt.restore(d, shard_tree(full, sh12), shardings=sh12)
            out["restored_1x2"] = gather_tree(back, sh12)
    if mesh.rank:
        for name in inp["cases"]:
            out[name].pop("params")
    return out
