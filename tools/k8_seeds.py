"""K8 (dense flash attention) against its plain version at the shapes of
``chip_smoke.py``'s phase 5, over several seeds.

    python3 tools/k8_seeds.py 5 0 1 2 [--out k8_seeds.json]

Each seed draws phase 5's cases in phase 5's order (seed ``SEED`` + 5 is
phase 5's own draw), runs K8 and the plain version, and applies phase 5's
elementwise check. For every bf16 case it records the share of the derived
bound (one bf16 ULP of the larger magnitude + 2u·Σp|v|/l, ``chip_smoke.
k8_p_bound``) that the worst element uses, and that element. Prints one
line a seed, every failing case, and the largest share per head dim over
all seeds. Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as k8  # noqa: E402


def worst_element(got, want, p_bound, s, d):
    """The largest share of the bound any element uses, and that
    element."""
    ex = cs.k8_excess(got, want, p_bound)
    i = int(ex.argmax())
    h, r, c = i // (s * d), (i // d) % s, i % d
    return ex.max().item(), dict(
        head=h, row=r, col=c, got=got.float().view(-1)[i].item(),
        want=want.float().view(-1)[i].item(),
        p_bound=p_bound.view(-1)[i].item())


def sweep(seed: int) -> list:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(label, s, d, dtype, causal,
              *cs.k8_inputs(gen, heads, kv, s, d, dtype))
             for label, heads, kv, s, d, dtype, causal in cs.K8_SHAPES]
    out = []
    for label, s, d, dtype, causal, q, k, v in cases:
        got = k8.flash_attention(q, k, v, causal=causal)
        want = k8.flash_attention_reference(q, k, v, causal=causal)
        p_bound = (cs.k8_p_bound(q, k, v, causal)
                   if dtype == torch.bfloat16 else None)
        rec = dict(seed=seed, label=label, s=s, d=d, dtype=str(dtype),
                   causal=causal, ok=cs.k8_close(got, want, p_bound),
                   err=cs.max_err(got, want))
        if p_bound is not None:
            rec["share"], rec["worst"] = worst_element(got, want, p_bound,
                                                       s, d)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--out", help="write every case here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k8_seeds: no CUDA device", file=sys.stderr)
        return 2
    build.build_all()
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = sweep(seed)
        torch.cuda.synchronize()
        fails = [r for r in got if not r["ok"]]
        bf16 = [r["share"] for r in got if "share" in r]
        print(f"seed {seed}: {len(got)} cases, {len(fails)} fail, largest "
              f"share of the bf16 bound {max(bf16):.3g} "
              f"({time.perf_counter() - t0:.1f} s)")
        for f in fails:
            print("  FAIL", json.dumps(f))
        rows += got
    by_d = {}
    for r in rows:
        if "share" in r:
            by_d[r["d"]] = max(by_d.get(r["d"], 0.0), r["share"])
    print("largest share of the bf16 bound by head dim: " + ", ".join(
        f"hd {d} {x:.3g}" for d, x in sorted(by_d.items())))
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 1 if any(not r["ok"] for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
