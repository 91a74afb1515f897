"""Hillclimb runner: the three selected (arch × shape) cells, each with a
hypothesis → change ladder, every variant a dry-run record
(:mod:`repro_torch.launch.dryrun`: rank 0's step on the meta device, the
H100's roofline terms) tagged by its rung.

Port of ``repro/launch/hillclimb.py``; the same tags, qmodes, KV dtypes
and overrides:

  A. qwen2-72b × decode_32k — decode is weight-bandwidth-bound; each
     quantization rung should cut the memory term by the storage ratio.
       A1 bf16 (reference) → A0 w8a8 (the sweep's baseline)
       → A2 w4a8 (packed int4 weights) → A3 w4a8 + int8 KV cache
  B. an MoE arch × decode_32k (``--b-arch``, default jamba-v0.1-52b)
       B0 w8a8 → B1 w4a8 experts → B2 experts over model, expert_ff over
       data → B3 w4a8 + int8 KV
  C. pixtral-12b × prefill_32k — the worst roofline fraction:
       C0 w8a8 chunked attention → C1 w4a8 weights
       → C2 q-chunk 8192 (half the score-buffer writebacks)
       → C3 flash attention: an analytic memory-term entry marked
         ``modeled`` (K8 is on no model path of the port either).

B2's override moves no weight (the reference's ``params_pspecs`` matches
an expert stack by the dense MLP's patterns first, so every expert's
columns stay over model): each model rank gathers its block of experts
whole over model for every step and runs it on its data rank's
``expert_ff`` block (``models.moe.experts_over_model``).

Usage:  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell A
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
from pathlib import Path

from repro_torch.launch import dryrun as dr

OUT = Path("artifacts/dryrun_torch")


def _run(tag: str, **kw):
    cid = dr.cell_id(kw["arch"], kw["shape_name"], kw.get("multi_pod", False),
                     kw.get("qmode", "none"), kw.get("kv_dtype"), tag)
    path = OUT / f"{cid}.json"
    if path.exists() and not kw.pop("force", False):
        print(f"[cached] {cid}")
        return json.loads(path.read_text())
    print(f"[hillclimb] {cid}", flush=True)
    kw.pop("force", None)
    rec = dr.run_cell(**kw)
    rec["tag"] = tag
    path.write_text(json.dumps(rec, indent=1, default=float))
    print(f"  -> {rec['status']}"
          + (f" ({rec.get('error', '')})" if rec["status"] == "FAIL"
             else ""), flush=True)
    return rec


def cell_a(force=False):
    base = dict(arch="qwen2-72b", shape_name="decode_32k", multi_pod=False,
                force=force)
    _run("A1_bf16", qmode="none", **base)
    _run("A0_w8a8", qmode="w8a8", **base)          # == sweep baseline
    _run("A2_w4a8", qmode="w4a8", **base)
    _run("A3_w4a8_kv8", qmode="w4a8", kv_dtype="int8", **base)


def cell_b(arch="llama4-maverick-400b-a17b", force=False):
    """An MoE arch's expert-parallel decode (the all-to-alls of the
    dispatch slab over the data axis)."""
    base = dict(arch=arch, shape_name="decode_32k", multi_pod=False,
                force=force)
    _run("B0_w8a8", qmode="w8a8", **base)          # == sweep baseline
    # B1: int4 experts — half the resident expert bytes
    _run("B1_w4a8", qmode="w4a8", **base)
    # B2: experts over model instead of data — hypothesis: worse memory,
    # less wire
    _run("B2_experts_model", qmode="w8a8",
         rules_override={"expert": ("model",), "expert_ff": ("data",)},
         **base)
    # B3: int8 KV on top of the winner
    _run("B3_w4a8_kv8", qmode="w4a8", kv_dtype="int8", **base)


def cell_c(force=False):
    base = dict(arch="pixtral-12b", shape_name="prefill_32k", multi_pod=False,
                force=force)
    _run("C0_w8a8", qmode="w8a8", **base)          # == sweep baseline
    _run("C1_w4a8", qmode="w4a8", **base)
    _run("C2_qchunk8k", qmode="w8a8",
         cfg_override={"attn_q_chunk": 8192}, **base)
    # C3: flash attention — analytic roofline entry
    rec = _flash_modeled_entry()
    (OUT / "pixtral-12b__prefill_32k__single__w8a8__C3_flash.json"
     ).write_text(json.dumps(rec, indent=1, default=float))
    print("[hillclimb] C3_flash (modeled) written")


def _flash_modeled_entry():
    """First-principles memory term of flash-attention prefill (pixtral).

    The chunked-attention baseline writes and reads per layer per device
    the f32 scores (B_loc, H_loc, S, S) once (the term the kernel
    removes), plus Q/K/V/O traffic; the flash kernel moves Q+K+V+O once
    (the scores stay on chip)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    cfg = get_config("pixtral-12b")
    b_loc, s, h_loc, dh = 2, 32768, cfg.n_heads // 16, cfg.hd
    layers = cfg.n_layers
    qkvo = 4 * b_loc * s * h_loc * dh * 2                      # bf16
    scores_rw = 2 * b_loc * h_loc * s * s * 4                  # f32 w+r
    base_attn_bytes = layers * (qkvo + scores_rw)
    flash_attn_bytes = layers * qkvo
    # non-attention bytes: take the C0 record and subtract the score
    # traffic analytically
    c0 = json.loads((OUT / "pixtral-12b__prefill_32k__single__w8a8__C0_w8a8"
                     ".json").read_text())
    total_bytes = c0["cost"]["bytes accessed"]
    new_bytes = max(total_bytes - (base_attn_bytes - flash_attn_bytes), 0.0)
    rec = dict(c0)
    rec["tag"] = "C3_flash_modeled"
    rec["modeled"] = True
    rec["provenance"] = ("memory term recomputed analytically: chunked-score "
                         "HBM traffic removed (flash attention keeps the "
                         "scores on chip); K8 is held against its plain "
                         "version on the card by chip_smoke.py phase 5, and "
                         "no model path runs it")
    rec["cost"] = dict(c0["cost"], **{"bytes accessed": new_bytes})
    rec["collectives"] = c0["collectives"]
    rec["roofline"] = dr.roofline(rec, 256, cfg, SHAPES["prefill_32k"])
    return rec


def _cells(cell: str, b_arch: str, force: bool):
    OUT.mkdir(parents=True, exist_ok=True)
    if cell in ("A", "all"):
        cell_a(force)
    if cell in ("C", "all"):
        cell_c(force)
    if cell in ("B", "all"):
        cell_b(b_arch, force)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=["A", "B", "C", "all"], default="all")
    ap.add_argument("--b-arch", default="jamba-v0.1-52b")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    # every cell is single-pod: one process holds the 256-rank fake group
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pool.apply(_cells, (args.cell, args.b_arch, args.force))


if __name__ == "__main__":
    main()
