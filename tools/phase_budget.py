"""Seconds of chosen phases of ``chip_smoke.py`` in one call on the card:
what a cut saves beside what new parts take.

    python3 tools/phase_budget.py [--parts 9,13] [--layers 48,12]
                                  [--out results.json]

Builds the kernels as ``chip_smoke.py`` does, then runs each part of
``--parts`` in turn:

* ``8``: phase 8, speculative decoding (``chip_smoke.speculative``, which
  prints its own laps);
* ``9``: phase 9 (``chip_smoke.moe_serving``) with the W8A8 model at each
  of ``--layers`` (the first its full depth, the last ``chip_smoke``'s
  cut);
* ``13``: phase 13's second part: K1 / K7 / K5 at a tp 2 rank's expert
  shard shapes (``tp_moe_kernels``) and ``tp_families``;
* ``13s``: phase 13's third part: K5 / K6a / K6b with int32 out
  (``int32_sums``) and the dense slab on shards (``dense_slab_mesh``,
  with the hillclimb's B2 on (2, 2));
* ``14``: phase 14 (``fsdp_training``: qwen3-0.6b, then moonshot-v1-16b-a3b
  and rwkv6-7b under a train mesh, one layer gathered at a time, then
  qwen3-0.6b and jamba-v0.1-52b under the multi-pod train rules, in one
  spawn of two ranks);
* ``16``: phase 16 (``dryrun_phase``: the dry run's prediction of rank
  0's step against the card) with the qwen3-0.6b train cells (one pod and
  two) at each of ``--dry-layers`` (0: its full 28).

Each part's checks gate as they do in ``chip_smoke.py``. It prints every
part's seconds and the card's name and power limit. Needs a CUDA card;
imports nothing of JAX.
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
    ap.add_argument("--parts", default="9,13",
                    help="comma-separated: 8, 9, 13, 13s, 14, 16")
    ap.add_argument("--layers", default=f"48,{cs.MOE_W8A8_LAYERS}",
                    help="phase 9's W8A8 depths, in turn")
    ap.add_argument("--dry-layers", default=str(cs.DRYRUN_CELLS[1][3]),
                    help="phase 16's train depths, in turn (0: full)")
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
        parts, results = args.parts.split(","), {}

        def timed(label, fn, *fn_args):
            print(f"[{label}]")
            t0 = time.perf_counter()
            results[label] = fn(*fn_args)
            seconds[label] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        if "8" in parts:
            timed("phase 8", cs.speculative, cs.SEED)
        if "9" in parts:
            for layers in (int(n) for n in args.layers.split(",")):
                timed(f"phase 9, W8A8 at {layers}", cs.moe_serving, cs.SEED,
                      smi, layers)
        if "13" in parts:
            def families():
                rows = cs.tp_moe_kernels(cs.Timer(), cs.phase_gen(13))
                cs.gate(rows, "K1, K7 and K5 at the expert shard shapes")
                return cs.tp_families(cs.SEED, smi)
            timed("phase 13 families", families)
        if "13s" in parts:
            def dense_slab():
                rows = cs.int32_sums(cs.Timer(), cs.phase_gen(13))
                cs.gate(rows, "K5 / K6a / K6b with int32 out")
                return cs.dense_slab_mesh(cs.SEED, smi)
            timed("phase 13 dense slab", dense_slab)
        if "14" in parts:
            timed("phase 14", cs.fsdp_training, cs.SEED, smi)
        if "16" in parts:
            for n in (int(x) for x in args.dry_layers.split(",")):
                cells = (cs.DRYRUN_CELLS[0],
                         *((*c[:3], n or None, c[4])
                           for c in cs.DRYRUN_CELLS[1:]))
                timed(f"phase 16, train at {n or 'full'} layers",
                      cs.dryrun_phase, smi, cells)
    print(f"[phase_budget] {smi}; seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    depths = [k for k in seconds if k.startswith("phase 9")]
    if len(depths) > 1:
        print(f"[phase_budget] phase 9's cut saves "
              f"{seconds[depths[0]] - seconds[depths[-1]]:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=smi, seconds=seconds, results=results), indent=1,
            default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
