"""Rank bodies of ``tests/test_torch_multipod.py``: the port's training
under the multi-pod train rules on gloo CPU ranks.

:func:`run_all` runs on eight ranks: qwen3-0.6b on the whole (2, 2, 2)
mesh, then the (2, 2, 1) cases on two meshes of four ranks at once
(ranks 0-3 and 4-7, :data:`SUBMESHES`), each case from the parent's
converted initial state (a ``torch.save`` file), then the controls that
must miss. This module imports neither ``jax`` nor the reference
package.
"""
import dataclasses
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import batch_specs, shard_batch
from repro_torch.launch.mesh import AXES, RankMesh, axis_sizes
from repro_torch.models import moe
from repro_torch.models import rwkv
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import (gather_tree, make_rules,
                                           mesh_context, named, shard_tree,
                                           train_state_pspecs)
from repro_torch.train import build_train_step
from repro_torch.tree import leaves

LR = 1e-2
# the (2, 2, 1) cases each four-rank mesh runs, by its first rank
SUBMESHES = {0: ("moonshot", "pixtral"), 4: ("rwkv6", "jamba")}
MOE_SEED = 5             # the routing check's input
MOE_CAPACITY = 0.5       # its capacity factor: every expert drops tokens


def config(arch):
    return get_config(arch, reduced=True, dtype="float32")


def _shapes(tree) -> list:
    return [list(x.shape) for x in leaves(tree)]


def sub_mesh(shape, first: int, device):
    """Ranks [first, first + p·d·m) of the joined group as a (pod, data,
    model) mesh of at most two axes longer than one → this rank's
    :class:`RankMesh`, None outside it. Every rank of the group calls it
    with the same arguments, in one order (``dist.new_group`` must be
    called so)."""
    sizes = axis_sizes(shape)
    size = math.prod(sizes.values())
    live = [a for a in AXES if sizes[a] > 1]
    if len(live) > 2:
        raise ValueError(f"a sub-mesh {shape}: at most two axes")
    whole = dist.new_group(list(range(first, first + size)))
    coords = [RankMesh(sizes, r, None, {}, None).coords for r in range(size)]
    me = dist.get_rank() - first
    inside = 0 <= me < size
    groups = {}
    for axis in live if len(live) == 2 else ():
        rest = [a for a in AXES if a != axis]
        members = {}         # the other axes' coordinates → the ranks
        for r, c in enumerate(coords):
            members.setdefault(tuple(c[a] for a in rest), []).append(r)
        for key, ranks in members.items():
            grp = dist.new_group([first + r for r in ranks])
            if inside and key == tuple(coords[me][a] for a in rest):
                groups[axis] = grp
    return RankMesh(sizes, me, whole, groups, device) if inside else None


def run_case(mesh, arch, state, batches, steps=None):
    """The steps of one case on this rank's block → dict(loss, grad_norm,
    each step's whole params on the mesh's rank 0, the blocks' shapes)."""
    cfg = config(arch)
    rules = make_rules("train", multi_pod=True, family=cfg.family)
    out = dict(loss=[], grad_norm=[], params=[])
    with mesh_context(mesh, rules, mode="train"):
        sh = named(train_state_pspecs(state, rules, mesh), mesh)
        st = shard_tree(state, sh)
        out["blocks"] = dict(params=_shapes(st["params"]),
                             m=_shapes(st["opt"]["m"]),
                             v=_shapes(st["opt"]["v"]))
        step = build_train_step(cfg, adamw(lr=LR))
        for b in batches[:steps]:
            rb = shard_batch(b, mesh=mesh, specs=batch_specs(b, rules, mesh))
            out["blocks"].update(inputs=list(rb["inputs"].shape),
                                 labels=list(rb["labels"].shape),
                                 start=rb.start)
            st, m = step(st, rb)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            whole = gather_tree(st["params"], sh["params"])
            if mesh.rank == 0:
                out["params"].append(whole)
    return out


def routing(mesh, params, control: bool):
    """Layer 0's MoE FFN of reduced moonshot at capacity factor
    :data:`MOE_CAPACITY` on a (8, 32, D) input from :data:`MOE_SEED`:
    this rank's block of its output, under a sharded step whose batch is
    split as the multi-pod train rules split it (rows over data, the
    sequence over pod). The control orders the runs rank by rank, not by
    their place in the global token order."""
    cfg = dataclasses.replace(config("moonshot-v1-16b-a3b"),
                              moe_capacity_factor=MOE_CAPACITY)
    x = torch.randn((8, 32, cfg.d_model), generator=torch.Generator(
        ).manual_seed(MOE_SEED))
    rows, pods = mesh.shape["data"], mesh.shape["pod"]
    b, s = 8 // rows, 32 // pods
    d, p = mesh.coords["data"], mesh.coords["pod"]
    mine = x[d * b:(d + 1) * b, p * s:(p + 1) * s]
    inner = moe._run_order
    if control:
        moe._run_order = lambda firsts: list(range(len(firsts)))
    try:
        with fsdp.sharded_step(mesh, {}, ("data",), rows * pods, ("pod",)):
            y, _ = moe.moe_ffn(params["layers"][0]["moe"], cfg, mine)
    finally:
        moe._run_order = inner
    return y


def controls(mesh, inp, which):
    """The controls of this mesh's cases: one step each."""
    out = {}
    if "qwen3" in which:      # the gather's backward without the pod sum
        inner = coll.seq_grad

        def own_block(blocks, mesh_, axes):
            return blocks[mesh_.coords["pod"]].clone()
        coll.seq_grad = own_block
        try:
            out["qwen3_no_sum"] = run_case(
                mesh, "qwen3-0.6b", inp["states"]["qwen3"],
                inp["batches"]["qwen3"], steps=1)
        finally:
            coll.seq_grad = inner
    if "rwkv6" in which:      # the token shift's halo zeroed
        inner = rwkv.halo_prev
        rwkv.halo_prev = lambda x, mesh_, axis: x.new_zeros(
            (x.shape[0], 1) + tuple(x.shape[2:]))
        try:
            out["rwkv6_no_halo"] = run_case(
                mesh, "rwkv6-7b", inp["states"]["rwkv6"],
                inp["batches"]["rwkv6"], steps=1)
        finally:
            rwkv.halo_prev = inner
    if "moonshot" in which:   # MoE offsets per rank, not per run
        params = inp["states"]["moonshot"]["params"]
        out["routing"] = routing(mesh, params, False)
        out["routing_control"] = routing(mesh, params, True)
    for res in out.values():
        if isinstance(res, dict):
            res.pop("params", None)
    return out


def run_all(mesh, path, cases):
    """Eight ranks: qwen3 on (2, 2, 2), then the (2, 2, 1) cases on two
    meshes of four ranks. The ranks start while the parent builds the
    inputs: they wait for ``path``."""
    torch.set_num_threads(1)
    deadline = time.monotonic() + 240
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no inputs at {path}")
        time.sleep(0.05)
    inp = torch.load(path, weights_only=False)
    subs = {first: sub_mesh((2, 2, 1), first, mesh.device)
            for first in SUBMESHES}
    out = {"rank": mesh.rank}
    out["qwen3"] = run_case(mesh, cases["qwen3"][0], inp["states"]["qwen3"],
                            inp["batches"]["qwen3"])
    out["controls"] = controls(mesh, inp, ("qwen3",))
    first = 0 if mesh.rank < 4 else 4
    sub = subs[first]
    for name in SUBMESHES[first]:
        out[name] = run_case(sub, cases[name][0], inp["states"][name],
                             inp["batches"][name])
    out["controls"].update(controls(sub, inp, SUBMESHES[first]))
    if sub.rank:
        for name in SUBMESHES[first] + ("qwen3",):
            out[name].pop("params")
    return out
