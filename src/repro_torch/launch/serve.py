"""Serving entry point: CAMP-quantized batched generation on the card.

On the H100 (full-width qwen2-0.5b, random weights from a seed):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --qmode w8a8 --batch 4 --prompt-len 512 --steps 32

On the CPU, at the reduced width (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --reduced --device cpu --qmode w8a8 --batch 4 --prompt-len 32 --steps 16

``--arch`` takes every config of the registry: the attention decoders,
the mixture-of-experts ones (moonshot-v1-16b-a3b, llama4-maverick-400b-a17b;
full-width llama4 does not fit one card), the recurrent ones
(jamba-v0.1-52b: Mamba and attention with MoE; rwkv6-7b) and those that
take float embeddings (pixtral-12b, musicgen-large: the prompt is a random
(batch, prompt-len, d_model) bf16 tensor, as in the reference's CLI). The
last four run on the dense-slab loop, as the reference's ``generate``
sends them. With a quantizing ``--qmode`` the weights are built and
quantized one layer at a time (the same draws), so full-width
jamba-v0.1-52b (~103 GB in bf16, ~52 GB at int8) fits the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --qmode w8a8 --batch 4 --prompt-len 512 --steps 16

``--qmode`` takes every CAMP mode: w8a8 (fused GEMM K1), w4a8 and w4a4
(packed int4 weights, fused GEMM K4), the weight-only w8a16 and w4a16
(dequantize, then a float matmul) and none. Serving runs on the
continuous-batching engine through ``generate`` with its default KV pages,
as the reference's ``serve`` does: float pages in the model dtype (the
fused GEMMs on the card, attention through its plain versions).

Speculative decoding (draft–verify over the paged int8 cache, K1/K4 and K2
at the verify panels' shapes):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --qmode w8a8 --batch 1 --steps 32 --spec-method ngram --spec-gamma 4

``--spec-method draft`` drives a small draft LM (``--spec-draft-config``,
always built with the reduced shapes, its weights from the seed + 1 and
quantized to ``--qmode``) over its own paged pool; ``--spec-gamma auto``
picks the window from the measured acceptance rate
(:mod:`repro_torch.core.autotune`). With a spec method the CLI drives the
engine itself over int8 pages, as the reference does, and prints the
acceptance summary; before serving it tunes the fused GEMMs' launch plans
at the decode and verify-panel shapes (``warm_gemm_autotune``: measured
on the card, stored in ``$REPRO_TORCH_AUTOTUNE_CACHE`` or
``~/.cache/repro_torch/autotune.json`` for later processes).

Tensor-parallel serving (``--tp N``): N rank processes (the ``spawn``
start method), rank 0 printing. Each rank builds the weights from the seed
a layer at a time and keeps only its shards
(``init_quantized_params(mesh=)``), so no rank ever holds the whole
model: column-parallel q/kv/gate/up,
row-parallel wo/down (``--tp-int8-reduce``: an int8 payload on the wire),
every MoE expert's gate/up columns and down rows (the down projection
quantized with the whole row's scale), a vocabulary-sharded embedding and
head, and the paged pool head-sharded. The recurrent and embedding-input
archs serve on the dense slab on shards too, as the reference's serve
places them under the serve rules (RWKV heads and channel-mix blocks,
Mamba's block of d_inner, attention heads, experts, vocabulary), with
the row-parallel projections quantized from the whole row, as GSPMD
runs them; rank 0 prints the bytes a rank holds beside the whole
model's.
``--tp-backend``: nccl (the default on cards: a card a rank) or gloo (the
CPU's, or several ranks sharing one card). On the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --reduced --device cpu --qmode w8a8 --tp 2 --batch 2 \
      --prompt-len 16 --steps 4
(every ``--arch``: moonshot-v1-16b-a3b and llama4-maverick-400b-a17b
split their experts; jamba-v0.1-52b, rwkv6-7b, pixtral-12b and
musicgen-large run on the dense slab, each rank on its shards).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import autotune
from repro_torch.core.camp import QMODES
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import (init_params, init_quantized_params,
                                 quantize_params)
from repro_torch.parallel.sharding import effective_model_shards, tree_bytes
from repro_torch.serving.engine import (ContinuousBatchingEngine, generate,
                                       runs_dense_slab, warm_gemm_autotune)
from repro_torch.serving.kv_cache import round_up
from repro_torch.serving.spec_decode import SpecConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--qmode", default="w8a8", choices=QMODES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--sample", default="greedy",
                    choices=["greedy", "temperature"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis (tensor-parallel) degree; 1 = off")
    ap.add_argument("--tp-int8-reduce", action="store_true",
                    help="int8-compress the row-parallel all-reduces")
    ap.add_argument("--tp-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend of --tp (default: nccl on "
                         "cards, a card a rank; gloo on the CPU)")
    ap.add_argument("--spec-method", default="off",
                    choices=["off", "ngram", "draft"],
                    help="speculative decoding: model-free n-gram lookup "
                         "or a small draft model")
    ap.add_argument("--spec-gamma", default="4",
                    help="speculation window (draft tokens/step), or 'auto' "
                         "to pick from the measured acceptance rate")
    ap.add_argument("--spec-draft-config", default="qwen2-0.5b",
                    help="draft model arch for --spec-method draft "
                         "(always built with --reduced shapes)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced, qmode=args.qmode)
    if args.spec_method != "off":
        # pre-tune the γ+1-row verify panels next to the decode shapes (at
        # the shard shapes under --tp), before any rank starts
        gammas = autotune.SPEC_GAMMAS if args.spec_gamma == "auto" \
            else (int(args.spec_gamma),)
        t0 = time.perf_counter()
        tuned = warm_gemm_autotune(cfg, batch_sizes=(1, args.batch),
                                   tp=args.tp, spec_gammas=gammas)
        print(f"[serve] tuned {len(tuned)} GEMM plans in "
              f"{time.perf_counter() - t0:.2f}s")
    if args.tp > 1:
        with tempfile.TemporaryDirectory(prefix="serve-tp-") as init_dir:
            spawn_ranks(_serve_rank, args.tp, init_dir=init_dir,
                        backend=args.tp_backend, device=device, args=(args,))
        return 0
    _serve(args, cfg, device, None, print)
    return 0


def _serve_rank(mesh, args) -> None:
    """One rank of ``--tp``: rank 0 prints."""
    tp = mesh.shape["model"]
    if mesh.device.type == "cpu":       # the host's cores split over ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // tp))
    cfg = get_config(args.arch, reduced=args.reduced, qmode=args.qmode)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    tp_eff = effective_model_shards(mesh, cfg.n_kv_heads)
    shape = {a: n for a, n in mesh.shape.items() if a != "pod" or n > 1}
    say(f"[serve] mesh {shape}; kv-head sharding: "
        f"{tp_eff if tp_eff > 1 else 'replicated'}")
    say(f"[serve] {tp} ranks, {torch.distributed.get_backend(mesh.group)} "
        f"on {mesh.device}")
    _serve(args, cfg, mesh.device, mesh, say)


def _serve(args, cfg, device, mesh, say) -> None:
    """Build the weights and the prompts from the seed and serve them;
    under ``mesh`` as one rank of it, on its shards."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    shard = mesh is not None
    if args.qmode != "none" or shard:
        params = init_quantized_params(cfg, args.qmode, generator=gen,
                                       device=device,
                                       mesh=mesh if shard else None)
    else:
        params = init_params(cfg, generator=gen, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    done = [what for what, on in (("PTQ to " + args.qmode,
                                   args.qmode != "none"),
                                  ("shard", shard)) if on]
    if done:
        say(f"[serve] init + {' + '.join(done)}, a layer at a time, in "
            f"{time.perf_counter()-t0:.2f}s")
    if shard and runs_dense_slab(cfg):
        say(f"[serve] dense slab on shards: {tree_bytes(params):,} bytes a "
            f"rank of {params.whole_bytes:,} whole (layout "
            f"{sorted(params.layout)})")

    spec = None
    if args.spec_method != "off":
        gamma = args.spec_gamma if args.spec_gamma == "auto" \
            else int(args.spec_gamma)
        draft_cfg = draft_params = None
        if args.spec_method == "draft":
            draft_cfg = get_config(args.spec_draft_config, reduced=True,
                                   qmode=args.qmode)
            draft_params = init_params(
                draft_cfg, device=device, generator=torch.Generator(
                    device=device).manual_seed(args.seed + 1))
            if args.qmode != "none":
                draft_params = quantize_params(draft_params, draft_cfg,
                                               args.qmode)
        spec = SpecConfig(method=args.spec_method, gamma=gamma,
                          draft_cfg=draft_cfg, draft_params=draft_params)
        say(f"[serve] speculative decoding: {args.spec_method}, "
            f"gamma={gamma}")

    if cfg.embedding_inputs:
        prompt = torch.randn((args.batch, args.prompt_len, cfg.d_model),
                             generator=gen, device=device).to(torch.bfloat16)
    else:
        prompt = torch.randint(0, cfg.vocab_size,
                               (args.batch, args.prompt_len), generator=gen,
                               device=device)
    t0 = time.perf_counter()
    if spec is None:
        toks = generate(params, cfg, prompt, steps=args.steps,
                        seed=args.seed, sample=args.sample, mesh=mesh,
                        tp_int8_reduce=args.tp_int8_reduce, device=device)
    else:
        # drive the engine directly so the acceptance stats are reportable
        eng = ContinuousBatchingEngine(
            params, cfg, kv_dtype="int8",
            capacity_tokens=args.batch * round_up(
                args.prompt_len + args.steps, 128),
            sample=args.sample, seed=args.seed, mesh=mesh,
            tp_int8_reduce=args.tp_int8_reduce, spec=spec, device=device)
        sids = [eng.submit(prompt[i], args.steps)
                for i in range(args.batch)]
        outs = eng.run()
        toks = torch.tensor([outs[s] for s in sids], dtype=torch.long)
        s = eng.spec_summary()
        say(f"[serve] spec: {s['spec_steps']} verify steps, acceptance "
            f"{s['acceptance_rate']:.2f}, "
            f"{s['mean_tokens_per_step']:.2f} tokens/step "
            f"(gamma={s['gamma']})")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n_new = toks.shape[0] * toks.shape[1]
    say(f"[serve] {device}: generated {tuple(toks.shape)} in {dt:.2f}s "
        f"({n_new/dt:.1f} tok/s incl. kernel build)")
    say(f"[serve] sample row: {toks[0][:16].tolist()}")


if __name__ == "__main__":
    raise SystemExit(main())
