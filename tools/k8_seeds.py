"""K8 (dense flash attention) against its plain version at the shapes of
``chip_smoke.py``'s phase 5, over several seeds.

    python3 tools/k8_seeds.py 5 0 1 2 [--out k8_seeds.json]

Each seed draws phase 5's cases in phase 5's order (seed ``SEED`` + 5 is
phase 5's own draw), runs K8 and the plain version, and applies phase 5's
elementwise check. For every bf16 case it records the excess over one bf16
ULP of the larger magnitude, and at the worst element the scale of the
error that rounding p to bf16 at another running maximum can cause:
Σp|v|/l (the plain version with |v|) and 2^-8 times it. Prints one line a
seed and every failing case. Needs a CUDA card; imports nothing of JAX.
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


def worst_element(q, k, v, got, want, s, d, causal):
    """Excess over one bf16 ULP, and the p-rounding scale at its worst
    element."""
    a, b = got.float(), want.float()
    ex = (a - b).abs() - cs.BF16_ULP_REL * torch.maximum(a.abs(), b.abs())
    i = int(ex.argmax())
    h, r, c = i // (s * d), (i // d) % s, i % d
    pv = k8.flash_attention_reference(
        q[h:h + 1], k[h:h + 1], v[h:h + 1].abs(), causal=causal
    )[0, r, c].float().item()
    return max(ex.max().item(), 0.0), dict(
        head=h, row=r, col=c, got=a.view(-1)[i].item(),
        want=b.view(-1)[i].item(), sum_p_absv=pv, p_round_bound=2.0 ** -8 * pv)


def sweep(seed: int) -> list:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(label, s, d, dtype, causal,
              *cs.k8_inputs(gen, heads, kv, s, d, dtype))
             for label, heads, kv, s, d, dtype, causal in cs.K8_SHAPES]
    out = []
    for label, s, d, dtype, causal, q, k, v in cases:
        got = k8.flash_attention(q, k, v, causal=causal)
        want = k8.flash_attention_reference(q, k, v, causal=causal)
        rec = dict(seed=seed, label=label, s=s, d=d, dtype=str(dtype),
                   causal=causal, ok=cs.k8_close(got, want),
                   err=cs.max_err(got, want))
        if dtype == torch.bfloat16:
            rec["ulp_excess"], rec["worst"] = worst_element(
                q, k, v, got, want, s, d, causal)
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
        bf16 = [r["ulp_excess"] for r in got if "ulp_excess" in r]
        print(f"seed {seed}: {len(got)} cases, {len(fails)} fail, largest "
              f"bf16 excess over one ULP {max(bf16):.3g} "
              f"({time.perf_counter() - t0:.1f} s)")
        for f in fails:
            print("  FAIL", json.dumps(f))
        rows += got
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 1 if any(not r["ok"] for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
