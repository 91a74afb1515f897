"""Rank bodies of the port's tensor-parallel CPU tests.

``tests/test_torch_collectives.py`` and ``tests/test_torch_tp_serving.py``
start these with :func:`repro_torch.launch.mesh.spawn_ranks` (gloo, one
process a rank). This module imports neither ``jax`` nor the reference
package: the parent computes the reference's outputs and hands the inputs
over in a ``torch.save`` file; each rank returns its raw outputs, and the
parent holds them against the reference.
"""
import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import init_params
from repro_torch.models.modules import linear, row_parallel_linear
from repro_torch.models.transformer import forward
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (make_rules, mesh_context,
                                           shard_params)
from repro_torch.serving.engine import ContinuousBatchingEngine
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
