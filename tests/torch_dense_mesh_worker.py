"""Rank bodies of ``tests/test_torch_dense_mesh.py``: the dense slab on
shards.

The parent starts :func:`dense_mesh` on four gloo CPU ranks with
:func:`repro_torch.launch.mesh.spawn_ranks`; it hands the inputs over in a
``torch.save`` file and holds each rank's raw outputs against one process
and the reference's recordings. This module imports neither ``jax`` nor
the reference package; :func:`slab_run` and :func:`moe_layer` also give
the parent's one-process runs.
"""
import contextlib
import functools
import os
import time

import torch

from repro_torch.kernels import ops
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import modules as modules_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.modules import (linear, row_linear,
                                        row_parallel_linear)
from repro_torch.parallel.sharding import (batch_block, make_rules,
                                           shard_params, tree_bytes)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import (build_decode_step,
                                        build_prefill_step,
                                        init_serve_caches, slab_context,
                                        slab_shards)

PROJ_SEED = 11           # the row-parallel projections' input
MOE_SEED = 13            # layer 0's MoE input
MOE_SHAPE = (4, 6)       # its (B, S): the rows split over the data ranks


@contextlib.contextmanager
def record_logits():
    """Every forward's last-position logits of the dense slab's steps, in
    call order (``build_prefill_step`` / ``build_decode_step`` call the
    engine module's ``forward``)."""
    inner, got = engine_mod.forward, []

    def forward(*a, **kw):
        out = inner(*a, **kw)
        got.append(out[0][:, -1].float().clone())
        return out
    engine_mod.forward = forward
    try:
        yield got
    finally:
        engine_mod.forward = inner


def slab_run(cfg, params, prompt, steps, mesh=None, rules=None,
             kv_dtype=None, keep_pages=False):
    """The dense-slab loop through ``build_prefill_step`` and
    ``build_decode_step``: ``prompt``'s greedy stream over ``steps``
    tokens and every step's logits (the prefill's and each decode
    step's), one process (``mesh`` None) or this rank (its shards, rows
    and caches under ``rules``, in ``slab_context``) → dict(tokens (B,
    steps), logits (steps, B, V), layout, bytes, slab, and with
    ``keep_pages`` every attention layer's slab contents)."""
    rules = rules or make_rules("serve")
    b, s = prompt.shape[:2]
    scope = contextlib.nullcontext()
    if mesh is not None:
        params = slab_shards(params, mesh, cfg, rules)
        scope = slab_context(mesh, params.layout, rules)
        prompt = batch_block(prompt, mesh, rules)
    caches = init_serve_caches(cfg, b, s + steps, kv_dtype=kv_dtype,
                               device="cpu", mesh=mesh, rules=rules)
    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
    with scope, record_logits() as logits:
        last, caches = prefill(params, prompt, caches)
        tok = last.float().argmax(dim=-1)[:, None]
        toks = [tok]
        for i in range(steps - 1):
            tok, caches = decode(params, caches, tok, s + i)
            toks.append(tok)
    slab = None
    attn = [c["attn"] for c in caches if "attn" in c]
    if attn:
        c = attn[0]
        slab = dict(k=tuple(c.k.shape), start=c.start,
                    seq_axes=list(c.seq_axes),
                    k_scale=None if c.k_scale is None
                    else tuple(c.k_scale.shape))
    pages = [{a: getattr(c, a) for a in ("k", "v", "k_scale", "v_scale")}
             for c in attn] if keep_pages else None
    return dict(tokens=torch.cat(toks, dim=1), logits=torch.stack(logits),
                layout=sorted(getattr(params, "layout", ())),
                bytes=tree_bytes(params),
                whole_bytes=getattr(params, "whole_bytes", 0), slab=slab,
                pages=pages)


def row_parallel_layers(cfg, params):
    """(name, path) of layer 0's row-parallel projections: the MLP's or
    the channel mix's w_down, and attention's wo where its heads split."""
    out = []
    for i, layer in enumerate(params["layers"]):
        for key in ("mlp", "rwkv_cm"):
            if key in layer:
                out.append((f"{i}/{key}/w_down", (i, key, "w_down")))
        if "attn" in layer and cfg.n_kv_heads % 2 == 0:
            out.append((f"{i}/attn/wo", (i, "attn", "wo")))
        if out:
            return out
    return out


def _leaf(tree, path):
    i, *rest = path
    node = tree["layers"][i]
    for k in rest:
        node = node[k]
    return node


def projections(mesh, cfg, params):
    """Layer 0's row-parallel projections on one input: one process's
    whole product, this rank's (the whole row's scale, ``row_linear`` in
    the dense slab's context) and the shard-local-scale control
    (``row_parallel_linear``, the paged engine's)."""
    local = shard_params(params, mesh, cfg)
    out = {}
    for name, path in row_parallel_layers(cfg, params):
        w, w_loc = _leaf(params, path), _leaf(local, path)
        k = w.shape[0]
        x = torch.randn((2, 5, k), generator=torch.Generator().manual_seed(
            PROJ_SEED)).to(getattr(torch, cfg.dtype))
        kb = k // 2
        xb = x[..., mesh.coords["model"] * kb:(mesh.coords["model"] + 1) * kb]
        with slab_context(mesh, local.layout):
            got = row_linear(xb, w_loc, qmode=cfg.qmode)
        control = row_parallel_linear(xb, w_loc, mesh=mesh, qmode=cfg.qmode)
        out[name] = dict(one=linear(x, w, qmode=cfg.qmode).float(),
                         tp=got.float(), control=control.float())
    return out


def part_a(mesh, case):
    """One model on a (1, 2) mesh under the serve rules: the f32 and the
    W8A8 streams with their logits, and layer 0's projections (W8A8)."""
    out = {}
    for q in ("none", "w8a8"):
        cfg, params, prompt, steps = case[q]
        out[q] = slab_run(cfg, params, prompt, steps, mesh)
    cfg, params, _, _ = case["w8a8"]
    out["proj"] = projections(mesh, cfg, params)
    return out


def seq_split(mesh, case):
    """qwen2-0.5b under the decode rules, its slab split along the
    sequence: float (with the control that drops rank 1's partial from
    every split softmax's sum) and int8 (its pages kept)."""
    cfg, params, prompt, steps = case
    rules = make_rules("decode")
    out = {"float": slab_run(cfg, params, prompt, steps, mesh, rules),
           "int8": slab_run(cfg, params, prompt, steps, mesh, rules, "int8",
                            keep_pages=True)}
    inner = attn_mod.seq_split_attn
    attn_mod.seq_split_attn = functools.partial(inner, drop_rank=1)
    try:
        out["dropped"] = slab_run(cfg, params, prompt, steps, mesh,
                                  rules)["logits"]
    finally:
        attn_mod.seq_split_attn = inner
    return out


GEMMS = ("gemm_i8_fused", "gemm_w4_fused", "gemm_a4w4_fused", "gemm_i8",
         "gemm_w4", "gemm_a4w4")


@contextlib.contextmanager
def count_expert_work():
    """The expert stacks the MoE FFN multiplies (their expert counts) and
    the integer GEMM launches (``ops``' wrappers) while it runs."""
    seen = {"experts": [], "gemms": 0}
    inner = moe_mod._expert_matmul
    saved = {n: getattr(ops, n) for n in GEMMS}

    def expert_matmul(xe, w, *a, **kw):
        seen["experts"].append(int(w.shape[0]))
        return inner(xe, w, *a, **kw)

    def wrap(fn):
        def call(*a, **kw):
            seen["gemms"] += 1
            return fn(*a, **kw)
        return call
    moe_mod._expert_matmul = expert_matmul
    for n, fn in saved.items():
        setattr(ops, n, wrap(fn))
    try:
        yield seen
    finally:
        moe_mod._expert_matmul = inner
        for n, fn in saved.items():
            setattr(ops, n, fn)


def moe_layer(params, cfg, mesh=None, rules=None):
    """Layer 0's MoE FFN on :data:`MOE_SHAPE` tokens: one process's, or
    this rank's rows under the decode rules (its experts' GEMMs, every
    data rank's slots) → (y, the expert counts and GEMM launches)."""
    x = torch.randn(MOE_SHAPE + (cfg.d_model,), generator=torch.Generator(
        ).manual_seed(MOE_SEED)).to(getattr(torch, cfg.dtype))
    p = params["layers"][0]["moe"]
    scope = contextlib.nullcontext()
    if mesh is not None:
        rules = rules or make_rules("decode")
        local = slab_shards(params, mesh, cfg, rules)
        p = local["layers"][0]["moe"]
        x = batch_block(x, mesh, rules)
        scope = slab_context(mesh, local.layout, rules)
    with scope, count_expert_work() as seen:
        y, _ = moe_mod.moe_ffn(p, cfg, x, qmode=cfg.qmode)
    return y.float(), seen


def experts_split(mesh, cases):
    """moonshot under the decode rules on ``mesh``: each qmode's stream
    and logits, and layer 0's MoE FFN."""
    out = {}
    for q, (cfg, params, prompt, steps) in cases.items():
        out[q] = slab_run(cfg, params, prompt, steps, mesh,
                          make_rules("decode"))
        out[q]["moe"] = moe_layer(params, cfg, mesh)
    return out


B2 = {"expert": ("model",), "expert_ff": ("data",)}


def experts_over_model(mesh, cases):
    """moonshot under the decode rules with the hillclimb's B2 override
    (experts over model, expert_ff over data) on (2, 2): each qmode's
    stream and logits, layer 0's MoE FFN, and (W8A8) the FFN with h
    quantized from the rank's own expert_ff block (the control)."""
    rules = {**make_rules("decode"), **B2}
    out = {}
    for q, (cfg, params, prompt, steps) in cases.items():
        out[q] = slab_run(cfg, params, prompt, steps, mesh, rules)
        out[q]["moe"] = moe_layer(params, cfg, mesh, rules)
    cfg, params, _, _ = cases["w8a8"]
    inner = modules_mod.row_absmax
    modules_mod.row_absmax = lambda h2, m, *axis: h2.abs().amax(
        dim=-1, keepdim=True)
    try:
        out["control"] = moe_layer(params, cfg, mesh, rules)[0]
    finally:
        modules_mod.row_absmax = inner
    return out


def dense_mesh(mesh, path):
    """Four ranks on a (2, 2) mesh. Two pairs (ranks 0-1, 2-3) each take
    half of part A's models as (1, 2) meshes; then pair 0 runs qwen2's
    sequence-split slab on (1, 2) while pair 1 runs moonshot on (2, 1)
    (the pair as the data axis); then all four moonshot on (2, 2), under
    the decode rules and with the hillclimb's B2 override. The ranks start
    while the parent still builds the inputs: they wait for ``path``."""
    torch.set_num_threads(1)
    deadline = time.monotonic() + 240
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no inputs at {path}")
        time.sleep(0.05)
    inp = torch.load(path, weights_only=False)
    r = mesh.rank
    pairs = [torch.distributed.new_group([0, 1]),
             torch.distributed.new_group([2, 3])]
    group = pairs[r // 2]
    model = RankMesh({"data": 1, "model": 2}, r % 2, group,
                     {"model": group}, mesh.device)
    data = RankMesh({"data": 2, "model": 1}, r % 2, group, {"data": group},
                    mesh.device)
    out = {"part_a": {a: part_a(model, inp["part_a"][a])
                      for a in inp["pairs"][r // 2]}}
    if r < 2:
        out["seq_split"] = seq_split(model, inp["seq_split"])
    else:
        out["experts (2, 1)"] = experts_split(data, inp["moonshot"])
    out["experts (2, 2)"] = experts_split(mesh, inp["moonshot"])
    out["b2"] = experts_over_model(mesh, {**inp["moonshot"],
                                          **inp["b2_int4"]})
    return out
