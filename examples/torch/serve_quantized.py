"""Serve a small model through the CAMP paged serving stack of the
PyTorch/CUDA port (the counterpart of ``examples/serve_quantized.py``): PTQ
weights → continuous batching over a shared int8 KV page pool, chunked
paged prefill, copy-on-write prefix sharing, and draft–verify speculative
decoding.

Eight requests with mixed prompt lengths and token budgets are queued
against a pool deliberately too small to hold them all at once: the
engine admits what fits, prefills chunk by chunk straight into int8 pages,
finishes short requests mid-flight, reclaims their pages, and admits the
rest. Three of the prompts share a 32-token prefix, so after the first of
them prefills, the others share its physical pages through the pool's
prefix trie. Compares bf16 vs w8a8 vs w4a8 weights on top of the same
paged int8 cache.

The speculative section then re-serves a repetitive prompt with
``--spec-method ngram`` (default): the drafter proposes γ tokens a step, one
γ+1-row verify forward scores them over the paged cache, and rejected
suffixes roll back; greedy output is bit-identical to the plain run.

    PYTHONPATH=src python examples/torch/serve_quantized.py [--device cpu]
    PYTHONPATH=src python examples/torch/serve_quantized.py --spec-method off

Weights and prompts are random, from a seed (torch's generator: not the
reference's numbers).
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.quant import QuantizedTensor
from repro_torch.device import resolve_device
from repro_torch.models import init_params, quantize_params
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.spec_decode import SpecConfig
from repro_torch.tree import leaves

# (prompt_len, max_new_tokens): deliberately ragged
REQUESTS = [(48, 24), (16, 8), (96, 12), (8, 32),
            (64, 16), (24, 24), (40, 8), (12, 16)]
PAGE_SIZE = 16
CAPACITY_TOKENS = 384   # < sum of worst cases: admission is staggered
SHARED_PREFIX = 32      # the first three long prompts open alike
SHARERS = (0, 2, 4)


def weight_bytes(p) -> int:
    return sum(leaf.memory_bytes() if isinstance(leaf, QuantizedTensor)
               else leaf.numel() * leaf.element_size()
               for leaf in leaves(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec-method", default="ngram",
                    choices=["off", "ngram", "draft"])
    ap.add_argument("--spec-gamma", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("qwen2-0.5b", n_layers=4, d_model=256, n_heads=4,
                     n_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=8192,
                     max_seq_len=512)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, generator=gen, device=device)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=device)
    prefix = tokens(SHARED_PREFIX)
    prompts = [tokens(n) for n, _ in REQUESTS]
    prompts = [torch.cat([prefix, p[SHARED_PREFIX:]]) if i in SHARERS else p
               for i, p in enumerate(prompts)]

    for qmode in ("none", "w8a8", "w4a8"):
        p = params if qmode == "none" else quantize_params(params, cfg, qmode)
        eng = ContinuousBatchingEngine(p, cfg, kv_dtype="int8",
                                       page_size=PAGE_SIZE,
                                       capacity_tokens=CAPACITY_TOKENS,
                                       device=device)
        sids = [eng.submit(prompts[i], mx)
                for i, (_, mx) in enumerate(REQUESTS)]
        t0 = time.time()
        steps = peak_saved = 0
        while eng.step():
            steps += 1
            stats = eng.pool.shared_page_stats()
            peak_saved = max(peak_saved,
                             stats["table_entries"] - stats["distinct_slots"])
        dt = time.time() - t0
        outs = {sid: r.tokens for sid, r in eng.finished.items()}
        n_new = sum(len(t) for t in outs.values())
        pool_mib = eng.pool.num_pages * eng.pool.page_bytes() / 2**20
        print(f"{qmode:>5}: weights {weight_bytes(p) / 2**20:6.1f} MiB | "
              f"{n_new} toks over {steps} ragged steps | "
              f"{n_new / dt:6.1f} tok/s (incl. first-use costs) | "
              f"pool {eng.pool.num_pages} pages = {pool_mib:.2f} MiB, "
              f"{eng.pool.num_free} free at end, "
              f"peak {peak_saved} pages saved by prefix sharing")
        print(f"       first request: {list(outs[sids[0]][:8])}")

    if args.spec_method == "off":
        return 0
    # speculative decoding: draft–verify over the same paged int8 cache
    qp = quantize_params(params, cfg, "w8a8")
    rep_prompt = tokens(8).repeat(8)           # 64 repetitive tokens
    max_new = 48
    spec = SpecConfig(method=args.spec_method, gamma=args.spec_gamma)
    if args.spec_method == "draft":
        # a self-draft; in production a much smaller checkpoint
        spec.draft_cfg, spec.draft_params = cfg, qp
    streams = {}
    for label, sp in (("baseline", None), ("speculative", spec)):
        eng = ContinuousBatchingEngine(qp, cfg, kv_dtype="int8",
                                       page_size=PAGE_SIZE,
                                       capacity_tokens=512, spec=sp,
                                       device=device)
        sid = eng.submit(rep_prompt, max_new)
        t0 = time.time()
        streams[label] = eng.run()[sid]
        dt = time.time() - t0
        line = f"{label:>11}: {max_new} toks in {dt:5.2f}s"
        if sp is not None:
            s = eng.spec_summary()
            line += (f" | {s['spec_steps']} verify steps, acceptance "
                     f"{s['acceptance_rate']:.2f}, "
                     f"{s['mean_tokens_per_step']:.2f} tok/step "
                     f"(gamma={s['gamma']})")
            per = next(iter(s["per_request"].values()))
            line += (f"\n             per-request: proposed "
                     f"{per['proposed']}, accepted {per['accepted']}")
        print(line)
    match = streams["baseline"] == streams["speculative"]
    print(f"             greedy streams bit-identical: {match}")
    if not match:
        raise SystemExit("speculative greedy decode diverged from baseline")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
