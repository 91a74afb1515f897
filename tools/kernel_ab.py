"""Time the integer GEMM and quantize kernels of two checkouts in turns on
one card.

    python3 tools/kernel_ab.py --tree A=path/to/parent --tree B=. \
        [--order A,B,B,A] [--out results.json]

Each turn runs one checkout in its own process (its ``src/`` first on the
path, its kernel libraries built from its own sources), times every case
below by CUDA events with L2 flushed before each launch (as
``chip_smoke.py``'s ``Timer``), and prints one JSON line. The cases are
the headline shapes of K1, K4, K5, K6a, K6b and K7 (``PERF.md`` §6) and a
few more; the inputs come from one seed, so both checkouts see the same
ones. At the end a table gives each case's mean µs per checkout over its
turns and the ratio of the second checkout to the first. Needs a CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (kernel, wrapper, M, K, N or None for K7, epilogue or bits, x dtype)
CASES = (
    ("K1", "k1.camp_gemm_fused_w8a8", 8, 896, 4864, "silu", "bf16"),
    ("K1", "k1.camp_gemm_fused_w8a8", 256, 4864, 896, "none", "bf16"),
    ("K4 w4a8", "k1.camp_gemm_fused_w4a8", 8, 896, 4864, "silu", "bf16"),
    ("K4 w4a8", "k1.camp_gemm_fused_w4a8", 256, 4864, 896, "none", "bf16"),
    ("K4 w4a4", "k1.camp_gemm_fused_w4a4", 8, 896, 4864, "silu", "bf16"),
    ("K4 w4a4", "k1.camp_gemm_fused_w4a4", 256, 4864, 896, "none", "bf16"),
    ("K5", "k5.camp_gemm_i8", 8, 4864, 896, "none", "bf16"),
    ("K5", "k5.camp_gemm_i8", 256, 4864, 896, "none", "bf16"),
    ("K6a", "k6.camp_gemm_w4", 8, 4864, 896, "none", "bf16"),
    ("K6a", "k6.camp_gemm_w4", 256, 4864, 896, "none", "bf16"),
    ("K6b", "k6.camp_gemm_a4w4", 8, 4864, 896, "none", "bf16"),
    ("K6b", "k6.camp_gemm_a4w4", 256, 4864, 896, "none", "bf16"),
    ("K7", "k7.quantize_rowwise_kernel", 8, 896, None, 8, "bf16"),
    ("K7", "k7.quantize_rowwise_kernel", 256, 4864, None, 8, "bf16"),
    ("K7", "k7.quantize_rowwise_kernel", 4096, 896, None, 8, "bf16"),
    ("K7", "k7.quantize_rowwise_kernel", 8, 29568, None, 8, "f32"),
)


def label(case) -> str:
    key, _, m, k, n, extra, dt = case
    shape = f"{m}x{k}" + (f"x{n}" if n else "")
    return f"{key} {shape} {extra} {dt}"


def measure(tree: Path) -> dict:
    """Every case's mean device ms on ``tree``'s kernels."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.core.quant import pack_int4
    from repro_torch.kernels import build
    from repro_torch.kernels import camp_gemm as k5  # noqa: F401
    from repro_torch.kernels import camp_gemm_fused as k1  # noqa: F401
    from repro_torch.kernels import camp_gemm_w4 as k6  # noqa: F401
    from repro_torch.kernels import quantize as k7  # noqa: F401

    build.build_all(("camp_gemm_fused", "camp_gemm", "quantize"))
    mods = dict(k1=k1, k5=k5, k6=k6, k7=k7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def timer(fn, iters=40):
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, dtype=torch.int8, device="cuda",
                             generator=gen)

    out = {}
    for case in CASES:
        key, wrapper, m, k, n, extra, dt = case
        mod, name = wrapper.split(".")
        fn = getattr(mods[mod], name)
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        if key == "K7":
            x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
            out[label(case)] = timer(lambda: fn(x, bits=extra))
            continue
        w4 = key != "K1" and key != "K5"
        w = pack_int4(ints(-7, 8, (k, n))) if w4 else ints(-127, 128, (k, n))
        s_b = torch.rand(1, n, device="cuda", generator=gen) * 0.01 + 1e-4
        kw = dict(out_dtype=dtype, epilogue=extra)
        if key.startswith(("K1", "K4")):
            x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
            args = (x, w, s_b)
        else:
            a = (pack_int4(ints(-7, 8, (m, k)).T).T.contiguous()
                 if key == "K6b" else ints(-127, 128, (m, k)))
            s_a = torch.rand(m, 1, device="cuda", generator=gen) * 0.01 + 1e-4
            args = (a, w, s_a, s_b)
        out[label(case)] = timer(lambda: fn(*args, **kw))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a checkout (give two)")
    ap.add_argument("--order", default="A,B,B,A",
                    help="the turns, by name (default A,B,B,A)")
    ap.add_argument("--out", help="also write the turns here (JSON)")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(Path(args.measure).resolve())))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.tree)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[kernel_ab] {smi}; trees {trees}")
    turns = []
    for name in args.order.split(","):
        proc = subprocess.run([sys.executable, __file__, "--measure",
                               trees[name]], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"  turn {len(turns)}: {name} done", flush=True)
    names = list(dict.fromkeys(n for n, _ in turns))
    print(f"  µs, mean over each checkout's turns; {names[-1]} / {names[0]}")
    means = {}
    for case in CASES:
        key = label(case)
        means[key] = {n: 1e3 * sum(t[key] for m, t in turns if m == n)
                      / sum(1 for m, _ in turns if m == n) for n in names}
        row = "  ".join(f"{n} {means[key][n]:8.2f}" for n in names)
        print(f"  {key:34s} {row}  ratio "
              f"{means[key][names[-1]] / means[key][names[0]]:.3f}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=smi, trees=trees,
                                                  turns=turns, means=means),
                                             indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
