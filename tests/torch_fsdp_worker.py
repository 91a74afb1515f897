"""Rank bodies of the port's sharded-training CPU tests.

``tests/test_torch_fsdp.py`` starts :func:`run_all` with
:func:`repro_torch.launch.mesh.spawn_ranks` on a (2, 2) mesh of gloo CPU
ranks. This module imports neither ``jax`` nor the reference package: the
parent converts the reference's states and computes the reference's
numbers, hands the inputs over in a ``torch.save`` file, and holds each
rank's raw outputs against them.
"""
import os
import signal

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import batch_specs, shard_batch
from repro_torch.launch.mesh import RankMesh
from repro_torch.optim import adamw
from repro_torch.optim.adamw import global_norm, int8_moment_quant, row_max_of
from repro_torch.parallel.sharding import (gather_tree, make_rules,
                                           mesh_context, named, shard_leaf,
                                           shard_tree, train_state_pspecs)
from repro_torch.train import build_train_step, init_train_state
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train.train_step import _int8_compress, param_specs
from repro_torch.tree import leaves, leaves_with_path, tree_map

ARCH = "qwen3-0.6b"
LR = 1e-2
RULES = make_rules("train", family="dense")


def config(**kw):
    return get_config(ARCH, reduced=True, dtype="float32", **kw)


def setup(int8: bool):
    """(cfg, optimizer, step) of a case: int8 moments and int8 gradient
    compression, or f32 moments."""
    cfg = config()
    opt = adamw(lr=LR, quantize_moments=int8)
    return cfg, opt, build_train_step(cfg, opt,
                                      compress_grads="int8" if int8 else None)


class Batches:
    """``batch_at`` over a list of host batches (the loop's data)."""

    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        return self.batches[step]


def steps(step, state, batches, mesh):
    """Each batch through the step on this rank's rows → (state, loss,
    grad_norm, the whole params after every step)."""
    out = dict(loss=[], grad_norm=[], params=[])
    specs, _ = param_specs(config(), RULES, mesh)
    for b in batches:
        state, m = step(state, shard_batch(
            b, mesh=mesh, specs=batch_specs(b, RULES, mesh)))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["params"].append(gather_tree(state["params"], named(specs, mesh)))
    return state, out


def quant_checks(mesh, whole_params):
    """Moment and gradient int8 scales on every sharded leaf's block
    against the slices of the whole leaf's, with the whole-row MAX and
    with a block-local absmax (the control)."""
    specs, _ = param_specs(config(), RULES, mesh)
    rng = np.random.default_rng(3)
    rows = []
    for (path, spec), p in zip(leaves_with_path(specs),
                               leaves(whole_params)):
        x = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
        x = x * p.abs().float().clamp_min(1e-3)
        whole_m = int8_moment_quant(x * x, sqrt_transform=True)
        whole_g = _int8_compress(x)
        blk = shard_leaf(x, spec, mesh)
        rm = row_max_of(spec, mesh)
        m = int8_moment_quant(blk * blk, sqrt_transform=True, row_max=rm)
        g = _int8_compress(blk, rm)
        local = int8_moment_quant(blk * blk, sqrt_transform=True)
        split = rm is not None
        rows.append(dict(
            path="/".join(map(str, path)), split=split,
            moment_exact=bool(
                torch.equal(m["q"], shard_leaf(whole_m["q"], spec, mesh))
                and torch.equal(m["scale"], shard_leaf(
                    whole_m["scale"], spec[:-1] + (None,), mesh))),
            grad_exact=bool(torch.equal(g, shard_leaf(whole_g, spec, mesh))),
            control_exact=bool(torch.equal(local["scale"], shard_leaf(
                whole_m["scale"], spec[:-1] + (None,), mesh)))))
    return rows


def norm_check(mesh, whole_params):
    """Sharded global_norm of a random gradient tree against the whole
    tree's."""
    specs, _ = param_specs(config(), RULES, mesh)
    gen = torch.Generator().manual_seed(4)
    g = tree_map(lambda p: torch.randn(p.shape, generator=gen), whole_params)
    blocks = tree_map(lambda x, s: shard_leaf(x, s, mesh), g, specs)
    return float(global_norm(blocks, specs)), float(global_norm(g))


def pair_mesh(mesh):
    """A (1, 2) mesh of ranks 0 and 1 (every rank creates the group);
    None on the other ranks."""
    pair = dist.new_group([0, 1])
    if mesh.rank >= 2:
        return None
    return RankMesh({"data": 1, "model": 2}, mesh.rank, pair,
                    {"model": pair}, mesh.device)


def signal_run(mesh, state, sh, step, data, who: int, at: int, d):
    """The loop with SIGTERM raised on rank ``who`` alone at step ``at``:
    the steps every rank ran and the checkpoints left."""
    def on_metrics(s, _):
        if s == at and mesh.rank == who:
            os.kill(os.getpid(), signal.SIGTERM)
    _, hist = loop.run(step, state, data, steps=3, ckpt_dir=d, ckpt_every=0,
                       log_every=0, shardings=sh, on_metrics=on_metrics)
    return dict(steps=len(hist["loss"]), saved=ckpt.all_steps(d))


FAMILIES = ("moonshot-v1-16b-a3b", "jamba-v0.1-52b", "rwkv6-7b")


def family_step(mesh, arch, batch):
    """(loss, grad_norm) of one step of the reduced ``arch`` on this
    rank's rows, and of one process on the whole batch."""
    cfg = get_config(arch, reduced=True, dtype="float32")
    rules = make_rules("train", family=cfg.family)
    opt = adamw(lr=LR)
    step = build_train_step(cfg, opt)
    full = init_train_state(cfg, opt, device="cpu")
    _, one = step(full, shard_batch(batch, device="cpu"))
    with mesh_context(mesh, rules, mode="train"):
        sh = named(train_state_pspecs(full, rules, mesh), mesh)
        _, m = step(shard_tree(full, sh), shard_batch(
            batch, mesh=mesh, specs=batch_specs(batch, rules, mesh)))
    return {k: (float(m[k]), float(one[k])) for k in ("loss", "grad_norm")}


def run_all(mesh, path):
    torch.set_num_threads(1)
    inp = torch.load(path, weights_only=False)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords)}
    tmp = inp["tmp"]
    pair = pair_mesh(mesh)
    with mesh_context(mesh, RULES, mode="train"):
        for name, int8 in (("f32", False), ("int8", True)):
            cfg, opt, step = setup(int8)
            full = inp["states"][name]
            sh = named(train_state_pspecs(full, RULES, mesh), mesh)
            state, res = steps(step, shard_tree(full, sh), inp["batches"],
                               mesh)
            if mesh.rank:
                res.pop("params")
            out[name] = res
            # an indivisible batch: 6 rows bind data only, 3 none
            out[name + " indivisible"] = [
                steps(step, shard_tree(full, sh), [b], mesh)[1]
                for b in inp["indivisible"]]
            if not int8:
                continue
            # checkpoints: a save on (2, 2), the whole state gathered
            d = os.path.join(tmp, "port")
            ckpt.save(d, state, 3, shardings=sh)
            whole = gather_tree(state, sh)
            if mesh.rank == 0:
                out["saved_state"] = whole
            back = ckpt.restore(d, state, shardings=sh)
            out["restored_same_mesh"] = all(
                torch.equal(a, b) for a, b in zip(leaves(back),
                                                  leaves(state)))
            # the reference's checkpoint of the initial f32 state
            f32 = inp["states"]["f32"]
            sh32 = named(train_state_pspecs(f32, RULES, mesh), mesh)
            ref = ckpt.restore(inp["ref_ckpt"], shard_tree(f32, sh32),
                               shardings=sh32)
            out["ref_ckpt_exact"] = all(torch.equal(a, b) for a, b in zip(
                leaves(gather_tree(ref, sh32)), leaves(f32)))
            # a restart on the same mesh against the run at once
            data = Batches(inp["batches"])
            once, _ = loop.run(step, shard_tree(full, sh), data, steps=3,
                               log_every=0, shardings=sh)
            d2 = os.path.join(tmp, "restart")
            loop.run(step, shard_tree(full, sh), data, steps=2, ckpt_dir=d2,
                     ckpt_every=2, log_every=0, shardings=sh)
            again, hist = loop.run(step, shard_tree(full, sh), data, steps=3,
                                   ckpt_dir=d2, ckpt_every=0, log_every=0,
                                   shardings=sh)
            out["restart"] = dict(
                steps=len(hist["loss"]),
                exact=all(torch.equal(a, b) for a, b in zip(
                    leaves(gather_tree(once, sh)),
                    leaves(gather_tree(again, sh)))))
            # signals: rank 1 alone runs on; rank 0 stops every rank
            out["signal_rank1"] = signal_run(
                mesh, shard_tree(full, sh), sh, step, data, 1, 0,
                os.path.join(tmp, "sig1"))
            out["signal_rank0"] = signal_run(
                mesh, shard_tree(full, sh), sh, step, data, 0, 1,
                os.path.join(tmp, "sig0"))
            whole_params = full["params"]
        out["quant"] = quant_checks(mesh, whole_params)
        out["norm"] = norm_check(mesh, whole_params)
    # MoE and recurrent models take a sharded step (their own rules),
    # against one process from the same state and batch
    out["families"] = {arch: family_step(mesh, arch, inp["batches"][0])
                       for arch in FAMILIES}
    # elastic: the (2, 2) save onto a (1, 2) mesh
    if pair is not None:
        cfg, opt, step = setup(True)
        full = inp["states"]["int8"]
        with mesh_context(pair, RULES, mode="train"):
            sh12 = named(train_state_pspecs(full, RULES, pair), pair)
            back = ckpt.restore(os.path.join(tmp, "port"),
                                shard_tree(full, sh12), shardings=sh12)
            out["restored_1x2"] = gather_tree(back, sh12)
    return out
