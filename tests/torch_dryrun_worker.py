"""Subprocess and rank bodies of ``tests/test_torch_dryrun.py`` (no jax).

* :func:`attn_cols_rank` — one rank of a (1, 2) gloo mesh: the reduced
  qwen2-0.5b in W8A8 on the dense slab with attention in the reference's
  layout (``slab_shards``: q/k/v column blocks gathered
  after the projection, wo's row block), under the serve rules (prefill
  and two decode steps) and the decode rules (prefill);
* :func:`one_process` — the same runs in one process;
* :func:`live_dryrun` — a spawned process's dry run: one live
  ``run_cell`` and a :class:`~repro_torch.launch.dryrun.Counter` over
  collectives at group sizes 2, 16 and 256 of the 256-rank fake group;
* :func:`meta_steps` — a spawned process's steps on meta under an
  8-rank fake group, measured as the dry run measures a cell: the train
  step under the multi-pod train rules (reduced models on a (2, 2, 2)
  mesh) and the decode step under the hillclimb's B2 rules (reduced
  moonshot W8A8 on a (2, 2) mesh of four of the ranks).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.models.transformer import (forward, init_params,
                                            quantize_params)
from repro_torch.parallel.sharding import batch_block, make_rules
from repro_torch.serving.engine import (build_prefill_step,
                                        init_serve_caches, slab_context,
                                        slab_shards)

ARCH, SEED, BATCH, PROMPT, MAX_LEN = "qwen2-0.5b", 3, 2, 8, 16


def _setup():
    cfg = get_config(ARCH, reduced=True, qmode="w8a8", dtype="float32")
    gen = torch.Generator().manual_seed(SEED)
    params = quantize_params(init_params(cfg, generator=gen, device="cpu"),
                             cfg, "w8a8")
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=gen)
    return cfg, params, prompt


def _slab(cfg, params, prompt, steps, mesh=None, rules=None):
    """Prefill logits and ``steps`` teacher-forced decode logits."""
    caches = init_serve_caches(cfg, prompt.shape[0], MAX_LEN, device="cpu",
                               mesh=mesh, rules=rules)
    prefill = build_prefill_step(cfg)
    out = []
    with torch.no_grad():
        last, caches = prefill(params, prompt, caches)
        out.append(last)
        tok = last.argmax(dim=-1)[:, None]
        for i in range(steps):
            # the logits of the decode step, through the forward the step
            # runs (the step returns the sampled token only)
            logits, caches, _ = forward(params, cfg, tok, caches=caches,
                                        cache_pos=PROMPT + i)
            out.append(logits[:, -1])
            tok = logits[:, -1].argmax(dim=-1)[:, None]
    return [x.float() for x in out]


def one_process():
    cfg, params, prompt = _setup()
    return {"serve": _slab(cfg, params, prompt, 2),
            "decode_rules": _slab(cfg, params, prompt, 0)}


def attn_cols_rank(mesh):
    cfg, params, prompt = _setup()
    out = {}
    for name, rules, steps in (("serve", make_rules("serve"), 2),
                               ("decode_rules", make_rules("decode"), 0)):
        local = slab_shards(params, mesh, cfg, rules)
        with slab_context(mesh, local.layout, rules):
            out[name] = _slab(cfg, local, batch_block(prompt, mesh, rules),
                              steps, mesh, rules)
        out[name + "_layout"] = sorted(local.layout)
    return out


def live_dryrun(conn):
    """In a spawned process: the live cell's record, and a Counter's
    collectives over all-gather, all-reduce, reduce-scatter and
    all-to-all at group sizes 2, 16 and 256 (result bytes beside)."""
    try:
        from repro_torch.launch import dryrun as dr
        rec = dr.run_cell("qwen2-0.5b", "decode_32k", multi_pod=False,
                          qmode="w8a8", verbose=False)
        groups = {2: dist.new_group([0, 1]), 16: dist.new_group(
            list(range(16))), 256: dist.group.WORLD}
        colls = {}
        for n, g in groups.items():
            x = torch.empty(8, 96, dtype=torch.bfloat16, device="meta")
            with dr.Counter() as c:
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x, group=g)
                dist.all_reduce(x, group=g)
                out = torch.empty_like(x)
                dist.reduce_scatter(out, [x] * n, group=g)
                send = torch.empty(n * 64, dtype=torch.uint8, device="meta")
                dist.all_to_all_single(torch.empty_like(send), send, group=g)
            colls[n] = {k: dict(v) for k, v in c.collectives.items()}
        conn.send(("ok", rec, colls))
    except BaseException as exc:  # noqa: BLE001 — reported to the parent
        import traceback
        conn.send(("error", f"{exc!r}\n{traceback.format_exc()}", None))


MULTI_POD_ARCHS = ("qwen3-0.6b", "jamba-v0.1-52b")
B2 = {"expert": ("model",), "expert_ff": ("data",)}


def meta_steps(conn):
    """In a spawned process, under an 8-rank fake group, on meta: each of
    :data:`MULTI_POD_ARCHS` (reduced), rank 0's train step under
    ``make_rules("train", multi_pod=True)`` on a (2, 2, 2) mesh at 8
    rows of 64 positions → {arch: (the batch's labels spec, the step's
    record: ``dr.measure``'s, with the rank's batch shapes, its first
    position and the axes of each sequence gather's backward sum)}; and
    under ``"b2"`` rank 0's decode step of reduced moonshot W8A8 under
    the decode rules with the hillclimb's B2 override on a (2, 2) mesh
    (its kernels on their meta rules, as on the card)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        from repro_torch.configs.shapes import ShapeSpec
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel import collectives as coll
        from torch_multipod_worker import sub_mesh
        inner, summed = coll.seq_grad, []

        def seq_grad(blocks, mesh, axes):
            summed.append(tuple(axes))
            return inner(blocks, mesh, axes)
        coll.seq_grad = seq_grad
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        mesh = make_mesh((2, 2, 2), device="meta")
        shape = ShapeSpec("train_tiny", 64, 8, "train")
        out = {}
        for arch in MULTI_POD_ARCHS:
            cfg = get_config(arch, reduced=True)
            rules = make_rules("train", multi_pod=True, family=cfg.family)
            _, specs = dr.batch_specs(cfg, 8, 64, rules, mesh)
            run, args = dr.build_train_cell(cfg, shape, mesh, rules)
            batch = args[1]
            summed.clear()
            with torch.enable_grad():
                rec = dr.measure(run, args)
            rec["seq_grads"] = list(summed)
            rec["batch"] = {k: list(v.shape) for k, v in batch.items()}
            rec["start"] = batch.start
            out[arch] = (specs["labels"], rec)
        coll.seq_grad = inner
        square = sub_mesh((2, 2), 0, torch.device("meta"))
        cfg = get_config("moonshot-v1-16b-a3b", reduced=True, qmode="w8a8")
        rules = {**make_rules("decode"), **B2}
        with torch.no_grad():
            run, args = dr.build_decode_cell(
                cfg, ShapeSpec("decode_tiny", 64, 4, "decode"), square,
                rules, "w8a8")
            out["b2"] = dr.measure(run, args)
        conn.send(("ok", out))
    except BaseException as exc:  # noqa: BLE001 — reported to the parent
        import traceback
        conn.send(("error", f"{exc!r}\n{traceback.format_exc()}"))
