"""Rank bodies of the port's tensor-parallel CPU tests.

``tests/test_torch_collectives.py``, ``tests/test_torch_tp_serving.py``
and ``tests/test_torch_tp_moe.py`` start these with :func:`repro_torch.launch.mesh.spawn_ranks` (gloo, one
process a rank). This module imports neither ``jax`` nor the reference
package: the parent computes the reference's outputs and hands the inputs
over in a ``torch.save`` file; each rank returns its raw outputs, and the
parent holds them against the reference.
"""
import contextlib
import os
import time

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import ops
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import init_params
from repro_torch.models import modules
from repro_torch.models import moe as moe_mod
from repro_torch.models.modules import linear, row_parallel_linear
from repro_torch.models.transformer import forward
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (effective_model_shards,
                                           make_rules, mesh_context,
                                           shard_params, tree_bytes)
from repro_torch.serving.engine import ContinuousBatchingEngine, generate
from repro_torch.serving.kv_cache import PagePool
from repro_torch.serving.spec_decode import SpecConfig


def k_shard(w, rank: int, tp: int):
    """Rank ``rank``'s K rows of a (K, N) weight (packed int4 rows for a
    4-bit QuantizedTensor; the scale kept)."""
    if isinstance(w, QuantizedTensor):
        rows = w.q.shape[0] // tp
        q = w.q[rank * rows:(rank + 1) * rows].clone()
        return QuantizedTensor(q=q, scale=w.scale, bits=w.bits,
                               shape=(w.shape[0] // tp, w.shape[1]))
    k = w.shape[0] // tp
    return w[rank * k:(rank + 1) * k].clone()


# ---------------------------------------------------------------------------
# Collectives and the row-parallel linear
# ---------------------------------------------------------------------------
def collectives(mesh, path):
    torch.set_num_threads(1)
    inp = torch.load(path, weights_only=False)
    r, p = mesh.rank, mesh.shape["model"]
    out = {"qpsum": coll.quantized_psum(inp["partials"][r], mesh)}
    # a 2-rank mesh over ranks 0 and 1 (every rank creates the group)
    pair = torch.distributed.new_group([0, 1])
    if r < 2:
        m2 = RankMesh({"data": 1, "model": 2}, r, pair, {"model": pair},
                      mesh.device)
        out["psum2"] = coll.psum(inp["partials"][r], m2)
    x, w = inp["ring_x"], inp["ring_w"]
    mb, nb = x.shape[0] // p, w.shape[1] // p
    out["ring"] = coll.ring_collective_matmul(
        x[r * mb:(r + 1) * mb], w[:, r * nb:(r + 1) * nb], mesh)
    out["mean"] = coll.int8_allreduce_mean(inp["grad"], mesh)
    out["gather"] = coll.all_gather_last(inp["partials"][r], mesh)
    out["bcast"] = coll.broadcast_ints([r, 7 * r + 1], mesh)
    xx = inp["x"]
    kx = xx.shape[-1] // p
    x_l = xx[..., r * kx:(r + 1) * kx]
    for qmode, w in inp["weights"].items():
        w_l = k_shard(w, r, p)
        out[f"partial/{qmode}"] = linear(x_l, w_l, qmode=qmode).float()
        for wire in (False, True):
            out[f"reduced/{qmode}/{wire}"] = row_parallel_linear(
                x_l, w_l, mesh=mesh, qmode=qmode, quantized_reduce=wire)
    return out


# ---------------------------------------------------------------------------
# Serving: prefill / decode, the engine, INDIV, QUANT, SPEC (n-gram and a
# draft model)
# ---------------------------------------------------------------------------
def engine_state(eng):
    """The replicated host-side accounting that must match bit for bit."""
    return {"tables": dict(eng.pool.tables), "lens": dict(eng.pool.lens),
            "stats": eng.pool.shared_page_stats(), "free": eng.pool.num_free,
            "retained": eng.pool.num_retained}


def chunked_prefill(params, cfg, pool, prompt, chunk, steps, scope):
    """Engine-shaped chunked paged prefill → each chunk's last logits."""
    s = int(prompt.shape[0])
    pool.reserve(0, s + steps)
    outs, pos = [], 0
    while pos < s:
        c = min(chunk, s - pos)
        caches = [{"attn": pool.prefill_cache(i, 0, pos, 2)}
                  for i in range(cfg.n_layers)]
        with scope():
            lg, new, _ = forward(params, cfg, prompt[None, pos:pos + c],
                                 positions=(pos + torch.arange(c))[None],
                                 caches=caches, last_logits_only=True)
        for i, layer in enumerate(new):
            pool.writeback(i, layer["attn"])
        pool.lens[0] = pos + c
        outs.append(lg[:, -1].float())
        pos += c
    return outs


def decode_steps(params, cfg, pool, tok, steps, scope):
    """Manual ragged decode loop → per-step logits."""
    outs = []
    for _ in range(steps):
        pool.ensure_writable(0, pool.lens[0] // pool.page_size)
        tables, lengths = pool.batch_tables([0])
        caches = [{"attn": pool.layer_cache(i, tables, lengths)}
                  for i in range(cfg.n_layers)]
        with scope():
            lg, new, _ = forward(params, cfg, tok,
                                 positions=lengths[:, None].long(),
                                 caches=caches)
        for i, layer in enumerate(new):
            pool.writeback(i, layer["attn"])
        pool.lens[0] += 1
        last = lg[:, -1].float()
        outs.append(last)
        tok = last.argmax(-1)[:, None]
    return outs


def run_engine(params, cfg, prompts, new, mesh, *, ps, snap_at=None, **kw):
    eng = ContinuousBatchingEngine(params, cfg, kv_dtype="int8",
                                   page_size=ps, capacity_tokens=512,
                                   mesh=mesh, device="cpu", **kw)
    sids = [eng.submit(p, new) for p in prompts]
    snap, steps = None, 0
    while eng.step():
        steps += 1
        if steps == snap_at:
            snap = engine_state(eng)
    return {"tokens": [list(eng.finished[s].tokens) for s in sids],
            "mid": snap, "end": engine_state(eng), "tp": eng.tp,
            "sharded": eng.pool.sharded,
            "page_shape": tuple(eng.pool.k_pages[0].shape),
            "spec": eng.spec_summary() if kw.get("spec") else None}


def serving(mesh, path):
    torch.set_num_threads(1)
    inp = torch.load(path, weights_only=False)
    cfg, params, ps = inp["cfg"], inp["params"], inp["page_size"]
    rules = make_rules("serve")
    out = {}

    # (d) prefill and decode over a head-sharded pool
    local = shard_params(params, mesh, cfg)

    def scope():
        return mesh_context(mesh, rules, mode="serve", layout=local.layout)

    pool = PagePool(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.hd, num_pages=64, page_size=ps,
                    quantized=True, dtype=torch.float32, mesh=mesh)
    out["pool_sharded"] = pool.sharded
    out["pool_shape"] = tuple(pool.k_pages[0].shape)
    out["prefill"] = chunked_prefill(local, cfg, pool, inp["pd_prompt"],
                                     inp["chunk"], inp["steps"], scope)
    out["decode"] = decode_steps(local, cfg, pool,
                                 out["prefill"][-1].argmax(-1)[:, None],
                                 inp["steps"], scope)
    # (e) the prefix-sharing mix on the engine, full params in
    out["engine"] = run_engine(params, cfg, inp["engine_prompts"], 6, mesh,
                               ps=ps, snap_at=4)
    # (f) kv heads the model axis does not divide
    icfg, iparams = inp["indiv_cfg"], inp["indiv_params"]
    ilocal = shard_params(iparams, mesh, icfg)
    out["indiv_mlp_rows"] = tuple(ilocal["layers"][0]["mlp"]["w_down"].shape)
    out["indiv_wq"] = tuple(ilocal["layers"][0]["attn"]["wq"].shape)
    out["indiv"] = run_engine(iparams, icfg, inp["indiv_prompts"], 6, mesh,
                              ps=ps, snap_at=2)
    # (g) w8a8 with the int8-wire reduce
    out["quant"] = run_engine(inp["quant_params"], inp["quant_cfg"],
                              inp["quant_prompts"], 6, mesh, ps=ps,
                              tp_int8_reduce=True)
    # (h) n-gram speculative decoding, gamma 3, and its plain twin
    out["spec"] = run_engine(params, cfg, inp["spec_prompts"], 10, mesh,
                             ps=ps, spec=SpecConfig(method="ngram", gamma=3))
    out["spec_base"] = run_engine(params, cfg, inp["spec_prompts"], 10, mesh,
                                  ps=ps)
    # a draft model that rank 1 holds apart: rank 0 drafts with the target
    # itself (every draft token accepted), rank 1 with other weights
    draft = params if mesh.rank != 1 else init_params(
        cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    out["spec_draft"] = run_engine(
        params, cfg, inp["spec_prompts"], 10, mesh, ps=ps,
        spec=SpecConfig(method="draft", gamma=3, draft_cfg=cfg,
                        draft_params=draft))
    return out


# ---------------------------------------------------------------------------
# MoE under a serving mesh, and the dense slab under one
# ---------------------------------------------------------------------------
FFN_SEED, FFN_SHAPE = 7, (2, 8)     # the MoE FFN's input: (B, S) tokens


def first_logits(params, cfg, prompt, chunk, mesh, opts=None):
    """The prompt's chunked paged prefill → its last row of logits (f32);
    under ``mesh`` over this rank's shards and kv heads, with the serve
    context's ``opts``."""
    tp = effective_model_shards(mesh, cfg.n_kv_heads) if mesh else 1
    pool = PagePool(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.hd, num_pages=64, page_size=8,
                    quantized=True, dtype=torch.float32,
                    mesh=mesh if tp > 1 else None)

    def scope():
        if mesh is None:
            return contextlib.nullcontext()
        return mesh_context(mesh, make_rules("serve"), mode="serve",
                            opts=opts, layout=params.layout)
    return chunked_prefill(params, cfg, pool, prompt, chunk, 0, scope)[-1][0]


@contextlib.contextmanager
def record_calls(target, name):
    """Record every call of ``target.name`` → a list of (args, kwargs,
    output)."""
    inner, calls = getattr(target, name), []

    def call(*a, **kw):
        out = inner(*a, **kw)
        calls.append((a, kw, out))
        return out
    setattr(target, name, call)
    try:
        yield calls
    finally:
        setattr(target, name, inner)


def moe_ffn_case(mesh, cfg, params, local):
    """The first MoE layer's FFN on one input, one process and this
    rank: the gate / up outputs (this rank's and one process's columns),
    y of both, and y of the shard-local-scale control (h quantized from
    the rank's own rows, as the dense FFN's row-parallel down does)."""
    i = next(j for j in range(cfg.n_layers) if cfg.ffn_of(j) == "moe")
    x = torch.randn(FFN_SHAPE + (cfg.d_model,), generator=torch.Generator(
        ).manual_seed(FFN_SEED)).to(getattr(torch, cfg.dtype))
    kw = dict(qmode=cfg.qmode)
    with record_calls(moe_mod, "_expert_matmul") as calls:
        one, _ = moe_mod.moe_ffn(params["layers"][i]["moe"], cfg, x, **kw)
    whole = [out for _, _, out in calls[:2]]
    scope = mesh_context(mesh, make_rules("serve"), mode="serve",
                         layout=local.layout)
    with scope, record_calls(moe_mod, "_expert_matmul") as calls:
        tp, _ = moe_mod.moe_ffn(local["layers"][i]["moe"], cfg, x, **kw)
    n, r = calls[0][2].shape[-1], mesh.coords["model"]
    cols = [out[..., r * n:(r + 1) * n] for out in whole]
    inner = modules.row_absmax
    modules.row_absmax = lambda h2, m, *axis: h2.abs().amax(
        dim=-1, keepdim=True)
    try:
        with mesh_context(mesh, make_rules("serve"), mode="serve",
                          layout=local.layout):
            control, _ = moe_mod.moe_ffn(local["layers"][i]["moe"], cfg, x,
                                         **kw)
    finally:
        modules.row_absmax = inner
    return {"gate_up_equal": [torch.equal(out, want) for (_, _, out), want
                              in zip(calls[:2], cols)],
            "gate_n": n, "one": one.float(), "tp": tp.float(),
            "control": control.float()}


GEMMS = {"gemm_i8_fused": True, "gemm_w4_fused": True,
         "gemm_a4w4_fused": True, "gemm_i8": False, "gemm_w4": False,
         "gemm_a4w4": False}


@contextlib.contextmanager
def expert_gemms():
    """Record (fused, m, n, k) of every integer GEMM the MoE FFNs launch
    (``ops``' wrappers, called from inside ``moe_ffn``) and each FFN's
    token count."""
    shapes, tokens, inner = set(), [], moe_mod.moe_ffn
    saved = {name: getattr(ops, name) for name in GEMMS}
    depth = [0]

    def ffn(p, cfg, x, **kw):
        tokens.append(x.shape[0] * x.shape[1])
        depth[0] += 1
        try:
            return inner(p, cfg, x, **kw)
        finally:
            depth[0] -= 1

    def wrap(name):
        def call(a, b, *rest, **kw):
            if depth[0]:
                k = rest[0] if name == "gemm_a4w4" else a.shape[-1]
                shapes.add((GEMMS[name], a.shape[0], b.shape[-1], k))
            return saved[name](a, b, *rest, **kw)
        return call
    moe_mod.moe_ffn = ffn
    for name in GEMMS:
        setattr(ops, name, wrap(name))
    try:
        yield shapes, tokens
    finally:
        moe_mod.moe_ffn = inner
        for name, fn in saved.items():
            setattr(ops, name, fn)


def moe_case(mesh, case, inp):
    """One MoE model under ``mesh``: the engine's streams and host state
    (and with the int8 wire), the first-step logits, the FFN check, this
    rank's expert blocks; for moonshot in f32 an n-gram speculative run."""
    cfg, params = inp["moe"][case]
    local = shard_params(params, mesh, cfg)
    layer = next(lp for lp in local["layers"] if "moe" in lp)["moe"]
    out = {"layout": sorted(local.layout),
           "w_gate": tuple(layer["experts"]["w_gate"].shape),
           "w_down": tuple(layer["experts"]["w_down"].shape)}
    ps, prompts = inp["page_size"], inp["moe_prompts"]
    with expert_gemms() as (shapes, tokens):
        out["engine"] = run_engine(local, cfg, prompts, inp["moe_new"], mesh,
                                   ps=ps, snap_at=inp["moe_snap"])
    out["expert_gemms"], out["moe_tokens"] = sorted(shapes), tokens
    out["first"] = first_logits(local, cfg, prompts[0], inp["chunk"], mesh)
    out["ffn"] = moe_ffn_case(mesh, cfg, params, local)
    if cfg.qmode == "w8a8":
        out["wire"] = run_engine(local, cfg, prompts, inp["moe_new"], mesh,
                                 ps=ps, tp_int8_reduce=True)
        out["wire_first"] = first_logits(local, cfg, prompts[0],
                                         inp["chunk"], mesh,
                                         opts={"tp_int8_reduce": True})
    if case == inp["spec_case"]:
        out["spec"] = run_engine(local, cfg, inp["spec_prompts"], 10, mesh,
                                 ps=ps, spec=SpecConfig(method="ngram",
                                                        gamma=3))
        out["spec_base"] = run_engine(local, cfg, inp["spec_prompts"], 10,
                                      mesh, ps=ps)
    return out


def moe_serving(mesh, path):
    """Four ranks: two (1, 2) meshes (ranks 0-1 and 2-3) each take half
    of the tp 2 MoE cases and of the dense-slab models through
    ``generate(mesh=)`` on this rank's shards; then all four the tp 4 MoE
    cases. The ranks start
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
    pair = RankMesh({"data": 1, "model": 2}, r % 2, group, {"model": group},
                    mesh.device)
    out = {"tp2": {c: moe_case(pair, c, inp) for c in inp["tp2"][r // 2]},
           "dense_slab": {}}
    for name in inp["slab"][r // 2]:
        cfg, params, prompt, steps = inp["slab_cases"][name]
        local = shard_params(params, pair, cfg)
        out["dense_slab"][name] = dict(
            tokens=generate(local, cfg, prompt, steps=steps, mesh=pair,
                            device="cpu"),
            layout=sorted(local.layout), bytes=tree_bytes(local),
            whole_bytes=local.whole_bytes)
    # temperature with a seed of each rank's own: the ranks follow rank 0
    cfg, params, prompt, steps = inp["slab_cases"][inp["slab"][r // 2][0]]
    kw = dict(steps=steps, sample="temperature", seed=r % 2, device="cpu")
    out["slab_temp"] = {"tokens": generate(params, cfg, prompt, mesh=pair,
                                           **kw),
                        "own": generate(params, cfg, prompt, **kw)}
    out["tp4"] = {c: moe_case(mesh, c, inp) for c in inp["tp4"]}
    return out
