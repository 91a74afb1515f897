"""Phase 9's seconds at full depth and at its cut, beside phase 13's MoE
and dense-slab parts, in one call on the card.

    python3 tools/phase_budget.py [--layers 48,12] [--out results.json]

Builds the kernels as ``chip_smoke.py`` does, then runs, in this order,
``chip_smoke.moe_serving`` (phase 9) with the W8A8 model at each of
``--layers`` (the first its full depth, the last ``chip_smoke``'s cut),
and phase 13's second part: K1 / K7 / K5 at a tp 2 rank's expert shard
shapes (``tp_moe_kernels``) and ``tp_families`` (moonshot's experts split
over 2 ranks, rwkv6-7b and pixtral-12b through ``generate(mesh=)``). Each
part's checks gate as they do in ``chip_smoke.py``. It prints every
part's seconds, the card's name and power limit, and what the cut saves
against what the new parts take. Needs a CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", default=f"48,{cs.MOE_W8A8_LAYERS}",
                    help="phase 9's W8A8 depths, in turn")
    ap.add_argument("--out", help="also write the seconds here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_budget: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[phase_budget] {smi}; torch {torch.__version__}")
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="autotune-") as cache_dir:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            cache_dir, "autotune.json")
        cs.autotune.clear_cache()
        t0 = time.perf_counter()
        cs.build.build_all()
        seconds["build"] = time.perf_counter() - t0
        for layers in (int(n) for n in args.layers.split(",")):
            print(f"[phase 9] W8A8 at {layers} of 48 layers")
            t0 = time.perf_counter()
            cs.moe_serving(cs.SEED, smi, layers)
            seconds[f"phase 9, W8A8 at {layers}"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        print("[phase 13] every model family under the mesh")
        t0 = time.perf_counter()
        rows = cs.tp_moe_kernels(cs.Timer(), cs.phase_gen(13))
        cs.gate(rows, "K1, K7 and K5 at the expert shard shapes")
        families = cs.tp_families(cs.SEED, smi)
        seconds["phase 13 families"] = time.perf_counter() - t0
    depths = [k for k in seconds if k.startswith("phase 9")]
    saved = seconds[depths[0]] - seconds[depths[-1]]
    print(f"[phase_budget] {smi}; seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(f"[phase_budget] the cut saves {saved:.1f} s; phase 13's new "
          f"parts take {seconds['phase 13 families']:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=smi, seconds=seconds, saved=saved,
            families={k: v for k, v in families.items()
                      if k not in ("ranks", "one_process")}),
            indent=1, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
