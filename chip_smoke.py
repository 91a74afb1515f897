"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits non-zero and prints no result):

1. Build: compile the six CUDA kernel libraries (one nvcc each, all at
   once), and beside them K3's, K2's, K8's, K5/K6a/K6b's, K1/K4's and K7's
   sources with ``-Xptxas -v``: the registers, stack and spills of each of
   their device kernels (K8's bf16 builds for hd 64 and 128, every
   tensor-core GEMM instance (K5/K6a/K6b: a row tile each; K1/K4: a row
   tile, qmode and x type each) with its scale pass and flush kernels, and
   every K7 instance must not spill), and the dynamic shared memory of
   each build; then ``cuobjdump -sass`` of K8's library: the ``HGMMA``
   (wgmma) and asynchronous-copy (``UTMALDG``, ``LDGSTS``) instructions of
   each bf16 build, none of which may lack either; and of K5/K6a/K6b's and
   K1/K4's: every tensor-core instance must hold an int8 tensor-core
   instruction (``IGMMA``: wgmma s8; or ``IMMA``) and an asynchronous copy,
   and neither library any dp4a (``IDP.4A``); each pattern is first held
   against a literal SASS line it must match (``SASS_LINES``).
2. Kernels vs their plain PyTorch versions on the card, at the serving
   path's full-width qwen2-0.5b shapes, with times (CUDA events, L2 flushed
   before every launch), the bound and a PyTorch library yardstick:
   K1 fused w8a8 GEMM; K4 fused w4a8 and w4a4 GEMMs; K5, K6a, K6b unfused
   int8 / w4 / a4w4 GEMMs (all also at ragged M 1, 3, 17, 100, N 200 and
   208, K 928, 4,870 and 4,880: byte gathers where rows are not 16-byte
   aligned, TMA's zero fill where they are; each with its split plan, its
   device kernels a call and a second yardstick, ``torch._int_mm`` with B
   K-major, alone and with the flush (K1/K4: with the quantize and the
   flush; K6b: with A's unpack and the flush); a control that drops the
   last split and, for K1/K4, one that takes each split's row scales from
   its own K range, which the exact check must each reject; and K1/K4's
   row scales from the block and from the scale pass, timed side by
   side); K7 rowwise quantize (bits 8 and 4, bf16 and f32, with a zero
   row; M 1 to 4,096, K 896 to 29,568, and K 4,870, whose rows take
   element loads), its threads a row and blocks; K3 paged
   decode attention (the serving batch, then the heads of qwen3-0.6b,
   qwen2-72b and stablelm-12b (hd 128 with G 2 and 8, hd 160 with G 4),
   page size 8, one 4,096-token sequence and 32 ragged sequences), with
   its split plan and device kernels per call, and a control that drops
   one kv tile and must fail the check; K2 paged prefill (C 256 at
   q_start 0, 512, 517, the same heads, page size 8, a verify panel of
   C 5 at a mid-page and a page-aligned q_start, a one-token feed, and the
   reduced draft's heads (hd 16, G 4) at C 1 and 13), and K2's serving
   chunk at 1 to 12 splits. For the MoE path: K1 at moonshot-v1-16b-a3b's
   expert GEMMs (M 8 and 32 × (K 2,048, N 1,408) and (1,408, 2,048), f32
   out, no epilogue) and its untied head (M 1 and 8 × 2,048 × 163,840);
   K3 and K2 at its heads (hd 128, G 1).
3. Serving: full-width qwen2-0.5b with random weights from a seed, in
   W8A8, W4A8 and W4A4, 8 requests of 512 prompt tokens (two sharing a
   256-token prefix) and 32 new tokens each on the continuous-batching
   engine over the int8 paged pool. Every kernel of the mode's path must be
   launched during its run. Then, per mode, a profiled rerun; every kernel
   call of one request held against its plain version on the same inputs;
   and that request's first-step logits through the kernels against the
   same forward through the plain versions (impl='torch'), in bf16 and f32.
   The profile sums each run's integer GEMM device kernels.
4. The unfused path: ``camp_matmul(fused=False)`` in w8a8, w4a8 and w4a4 at
   the serving shapes (K7, then K5, K6a or K6b), every one of its kernels
   launched, each output equal bit for bit to ``camp_matmul(fused=True)``
   and to the plain versions.
5. K8, dense flash attention, through its entry point ``flash_attention``
   at the qwen2-0.5b shapes (14 heads, hd 64: S 512, 4,096 and 32,768 bf16
   causal; 4,096 f32 causal and bf16 non-causal), qwen3-0.6b's (16 heads,
   hd 128, S 4,096), stablelm-12b's (32 heads over 8 kv heads, hd 160,
   S 4,096, bf16 and f32 causal), and hd 8, 16, 32 and 256 at an S that
   leaves a ragged last tile (f32 and bf16, causal and not): every call
   launches K8; each output within its tolerance of the plain version (f32
   2e-5; bf16 one ULP + 2u·Σp|v|/l, a bound derived per element beside
   ``K8_P_ROUND``), and in bf16 no farther
   (root-mean-square distance) from an f64 computation of 64 rows of up to
   three heads than twice the plain version is, and each head's RMS
   distance to the plain version over all its elements within
   ``K8_ALL_RMS`` times the plain version's own to f64; dropped-kv-tile
   controls that the checks must reject, one in the sampled rows and one
   in a whole other head, which the every-element check itself must
   reject (which check caught each printed); times
   beside the plain version, SDPA and
   the bound, with the share of the bound and the factor against SDPA.
6. Dense-slab serving: full-width qwen2-0.5b W8A8, the same 8 prompts of
   512 tokens and 32 new tokens through ``_generate_dense`` with a bf16
   slab and with an int8 slab, and through ``generate`` with its default
   float pages. K1 launches 168 times a forward in every run; K2 and K3
   never launch on float pages. Every K1 call of the dense prefill (M =
   4,096 rows) and of one decode step held against its plain version on
   the same inputs; the dense path's first-step logits through the
   kernels against the plain versions, and the bf16 slab's against the
   float-page engine's, each within W8A8's ``LOGIT_TOL``; profiled reruns
   of the bf16 slab and float pages; then the three runs again in turns.
7. stablelm-12b's attention shape (hd 160, 32 query / 8 kv heads) at full
   width, depth cut to 4 of its 40 layers, W8A8 on the paged engine over
   int8 pages: K1, K2 and K3 launched, every call of one request held
   against its plain version in situ.
8. Speculative decoding: full-width qwen2-0.5b on the paged engine over
   int8 pages, the kernels only: (a) n-gram, gamma 4, batch 1, an 8-token
   pattern tiled 8x and 48 new tokens (the reference benchmark's shape);
   (b) n-gram, gamma 4, phase 3's mix with prompts of repeated 64-token
   spans; (c) a draft model with the target's own weights; (d) the serve
   CLI's default draft (the reduced qwen2-0.5b, weights from the seed + 1),
   gamma 'auto', its pool sized so every sequence drafts; (e) (a) in W4A8
   and W4A4 (K4); (f) (a) at temperature 0.9 with the n-gram drafter, and
   with the self-draft twice with one seed, which must give one stream. Each greedy stream equals the plain engine's or
   first differs where the speculative token lies within one bf16 ULP of
   the plain row's maximum (a near-tie, ``SPEC_FLIP_ULPS``); an accept-all
   control with the reduced draft must fail that check. Every run launches K1 (K4) 7 times
   and K2 once a layer of every forward, target's and draft's, and K3
   never; every pool is free after it, its invariants holding; gamma
   'auto' re-picks at least once. Every K1 and K2 call of one request
   (verify panels at C 5 from mid-page q_starts, the draft's C 1 feeds)
   held against its plain version in situ; (b) under the profiler.
9. MoE serving: moonshot-v1-16b-a3b (48 layers, d 2,048, 16/16 heads of
   128, 64 experts top-6 of d_ff 1,408, vocab 163,840) at full width,
   12 of its 48 layers (``MOE_W8A8_LAYERS``), in W8A8, random weights from
   a seed built and quantized one layer at a time; phase 3's 8 prompts
   with 16 new tokens each on the paged engine over int8 pages. Every
   forward launches K1 2,353 times (12 × (4 + 64 × 3) + the head; a
   non-final prefill chunk computes no logits: 2,352), K2 12 times
   (prefill) or K3 12 times (decode), and nothing else. Every K1, K2 and K3 call of one request held against its plain
   version in situ; its first-step logits through the kernels against the
   plain versions within ``LOGIT_TOL``, with the share of (token, layer)
   pairs whose top-6 expert set differs and the picks each layer drops
   over capacity in a 256-token chunk; one decode forward profiled. Then
   W4A8 and W4A4 at full width, 8 of 48 layers, one request of 256 + 4
   tokens each: K4 1,569 times a forward, in situ.
10. Recurrent mixers and embedding inputs on the dense-slab loop
   (``generate`` → ``_generate_dense``, bf16 slab), random weights from
   a seed built and quantized a layer at a time: jamba-v0.1-52b (d 4,096,
   Mamba d_inner 8,192 state 16, attention 32/8 heads of 128, 16 experts
   top-2 of d_ff 14,336 on odd layers, vocab 65,536) at full width, 8 of
   its 32 layers (one whole period: Mamba at 0-3 and 5-7, attention at 4),
   and rwkv6-7b (d 4,096, 64 heads of 64, d_ff 14,336) at full width and
   depth, W8A8, 4 requests of 512 prompt tokens and 16 new tokens each;
   jamba in W4A8 and W4A4, one request of 256 + 4; pixtral-12b and
   musicgen-large at full width, 4 layers each, W8A8, 2 requests of 256
   float embedding frames (``frontend.synth_*_embeddings``) + 8 new
   tokens. Every forward launches the mode's fused GEMM exactly
   ``gemms_per_forward`` times (jamba 230, rwkv6 257, pixtral and musicgen
   29) and nothing else. Each run: every K1 (K4) call of one request held
   against its plain version in situ (exact); first-step logits, kernels
   vs plain, within ``LOGIT_TOL``. For jamba and rwkv6 W8A8 besides:
   layer 0's Mamba scan segments or chunked WKV on their prefill inputs
   against an f64 sequential recurrence (``SCAN_TOL``, ``WKV_TOL``); the
   state carried from prefill into 4 decode steps, layer 0's final state
   against an f64 recurrence over the inputs those steps computed, with
   a control that zeroes the states after the prefill and must fail; one
   decode forward profiled (busy share, fused GEMM ms, the recurrence's
   own kernels' ms).
11. Training: full-width qwen3-0.6b (28 layers, d 1,024, vocab 151,936,
   bf16, a checkpoint per block) from random weights, ``TRAIN_STEPS``
   steps of 8 x 512 tokens through ``build_train_step`` and ``loop.run``
   as the train CLI sets them up (cosine LR, AdamW with weight decay),
   once with f32 moments and once with int8 moments and int8 gradient
   compression. Each run: every loss finite and the last five's mean below
   the first five's; no kernel launched with f32 moments, and K7 exactly
   3 times a leaf a step with int8 (both moments and the gradient); step
   time, tokens/s, peak memory and one profiled step (device busy share)
   beside the 6·N·tokens bound. Every K7 call of one int8 step held
   against its plain version in situ (exact), and K7 at moonshot-v1-16b-
   a3b's trained leaf shapes (the untied head's 163,840-long rows, the
   expert stack as E·K rows, a norm scale as one row), timed at each; the
   reduced f32 step's loss and gradients on the card against the CPU's
   (the CPU tests' tolerances); a restart from a mid-run checkpoint (full
   width, 2 layers, int8) against the run at once (the reference test's
   rtol 1e-5 on ``final_norm``; whether the whole state is bit for bit is
   printed).
12. The autotune, on an empty cache of its own, within
   ``AUTOTUNE_BUDGET_S``: (d) the engine's page size, prefill chunk and
   pages per step for full-width qwen2-0.5b: K3 timed at each page size
   in interleaved rounds (16 stays unless beaten by more than the rounds'
   spread), the chunk model's scores, and K3's rounds again at the served
   mix's context (deciding nothing); (a) ``warm_gemm_autotune`` in W8A8,
   W4A8 and W4A4 at batch 1 and 8, then at one prompt of the tuned chunk:
   per shape the seed and the winner with their µs, the analytic model's
   pick and the bound; (b) every candidate plan at every tuned shape equal
   bit for bit to the plain version (so the winner equals the seed); (c) a
   plan with split-local scales (``SPLIT_SCALES``) that (b) must reject;
   (e) phase 3's W8A8 mix on the engine with its tuned defaults and on the
   fixed engine (page 16, chunk 256, the seed plans: the engine before its
   autotune): every kernel call of a 768-token request on the tuned engine
   in situ; the tuned plans at the fixed page and chunk equal bit for bit
   to the fixed engine; with K2 and K3 held to one split, the tuned and
   the fixed engine equal bit for bit (the witness that only the split
   plans' merge order moves the logits); the plain versions' engines at
   both settings beside them; the tuned engine's logits within W8A8's
   ``LOGIT_TOL`` of the fixed engine's; then both in turns; (f) the host
   µs of a K1 call with the plan computed per call and with the cache
   lookup.
13. Tensor-parallel serving: first K1 against its plain version at a tp
   2 rank's shard shapes, as phase 2 holds it (q 896 × 448 and k/v 896 ×
   64 with their bias, wo 448 × 896, gate/up 896 × 2,432, down 2,432 ×
   896; M 1, 8, 256), every case exact or the phase fails. Then
   full-width qwen2-0.5b W8A8 (random weights
   from the seed, every rank sharding the whole tree) served by 2 ranks,
   two processes on the one card joined through gloo (NCCL refuses two
   ranks on one device): each rank holds 7 of 14 q heads and 1 of 2 kv
   heads of every page, d_ff 2,432 and vocabulary rows 75,968. Phase 3's
   mix (8 × 512 prompt tokens, two sharing a 256-token prefix) with 16
   new tokens, page 16 and chunk 256. Each rank must launch K1, K2 and K3,
   K1 at exactly the shard shapes; every K1/K2/K3 call of one request in
   situ; both ranks' host state (tables, lens, shared pages, free,
   retained) at step 4 and at the end equal to a one-process engine's on
   the same mix; the sharded first-step logits through the kernels within
   W8A8's ``LOGIT_TOL`` of the sharded plain forward and of the one-process
   engine, and a control in which rank 1 leaves its partial out of the
   wo/w_down reduce must fail both; with the int8 wire, every
   ``quantized_psum`` on the card equal to the same call on CPU copies of
   the partials. Then 4 ranks, which do not divide the 2 kv heads, on 2 ×
   (128 + 8): attention replicated (``engine.tp`` 1, the pool unsharded),
   the MLP sharded 4 ways (d_ff 1,216), host state equal. Each rank's
   peak memory and the tok/s of one process and of the ranks in turns
   are printed beside the card's name and power limit: two processes
   time-sharing one card, not a tensor-parallel speed. Then every model
   family under the mesh, 2 ranks in one spawn (``tp_families``): K1 at a
   rank's expert column shards (M 8, 32; K 2,048, N 704) and K7 / K5 at
   its down projection's (K7 over a layer's E·C rows of 704 + 1 columns,
   K5 at K 704, N 2,048), exact; moonshot-v1-16b-a3b W8A8 at full width,
   ``TP_MOE_LAYERS`` (4) of 48 layers, phase 3's 8 prompts with 8 new
   tokens: every forward of a rank launches K1 4 + 2 × 64 times a layer
   (+ the head), K7 once and K5 64 times a layer (the down projection
   with the whole row's scale: ``moe._down_partial``), K2 or K3 once a
   layer; every K1/K2/K3/K7/K5 call of one request in situ; host state
   equal to one process's; layer 0's MoE FFN on one input within one bf16
   ULP of max |y| of one process's, and a control quantizing h from the
   rank's own rows (as the dense FFN does) must miss that; first-step
   logits within W8A8's ``LOGIT_TOL`` of one process's, a dropped-partial
   control outside; a rank's memory and the bytes it sends a decode step
   from the shapes. Then the dense slab on shards (``dense_slab_mesh``):
   first K5 (and K6a / K6b) with int32 out, the dense slab's row-parallel
   shards (``INT32_SHAPES``), exact against the plain dot, beside the
   flushed K5 and ``_int_mm``; then one spawn of 4 ranks on the card,
   each part against one process on the same inputs: (b) qwen2-0.5b
   W8A8 at full width and depth under the decode rules on (1, 4), 8 ×
   (512 + 8), its int8 slab split along the sequence (2 kv heads, 4
   ranks: 144 positions a rank, whole pages) and its attention in the
   reference's column blocks (the dense slab's ``"attn_cols"``, as for
   jamba and pixtral in (a)): prefill logits bit for bit,
   layer 0's attention at the first decode step within one bf16 ULP +
   2^-8·Σp|v| of one process's elementwise (``att_gap``), the control
   that drops rank 1's partial from the merge outside; then ranks 0-1 as
   a (1, 2) mesh run (a) rwkv6-7b (4 layers), jamba-v0.1-52b (8 of 32:
   one attention and 4 MoE layers) and pixtral-12b (4) W8A8 at full
   width through ``generate(mesh=)`` on their shards, 2 × (256 + 8),
   streams equal to one process's, a rank's bytes below the whole's,
   every decode forward launching K1, K7 and K5; beside them ranks 2-3 as
   a (2, 1) mesh run (c) moonshot-v1-16b-a3b W8A8 (4 of 48 layers) under
   the decode rules, 8 × (128 + 4): layer 0's MoE FFN on each rank's rows
   bit for bit one process's, with half of one process's expert GEMMs
   (K1), the streams equal; then all four as a (2, 2) mesh run (d)
   moonshot W8A8 (2 of 48 layers) under the decode rules with the
   hillclimb's B2 override (experts over model, expert_ff over data),
   the same mix: streams bit for bit one process's, every decode forward
   launching K1, K7 and K5. Each prints its gloo calls a decode step.
14. Sharded (FSDP) training, one layer gathered at a time (its gather
   and reduce counted: gloo calls and bytes a rank sends a step), every
   entry of ``FSDP_FAMILIES`` at full width with int8 moments and int8
   gradients, two processes on the one card joined through gloo, each
   holding its block of every sharded leaf of the state, ``FSDP_STEPS``
   steps of 2 x 512 tokens a rank against one process from the same
   state and batches: qwen3-0.6b (d 1,024, vocab 151,936, bf16),
   ``FSDP_LAYERS`` (4) of its 28 layers, on (data 1, model 2);
   moonshot-v1-16b-a3b (64 experts top-6, vocab 163,840, untied), 2 of its
   48 layers on (data 1, model 2), its routing groups spanning both ranks;
   rwkv6-7b, 2 of 32 layers, on (data 2, model 1) (its batch binds data
   only). Each: the first step's loss and grad_norm within
   ``FSDP_FIRST_RTOL``, the losses of its gated steps (every step
   within ``FSDP_LOSS_RTOL``; moonshot's first two within
   ``FSDP_MOE_LOSS_RTOL``; rwkv6: every grad_norm too); K7 exactly 3 times a leaf a step on each rank, every
   K7 call of the last step in situ (exact); controls that must land
   outside those limits: rank 1's gradient left out of the reduce (the
   first step) and rank 1's first AdamW update zeroed (the second loss).
   moonshot: layer 0's routing in the first forward equal to one
   process's at all but ``FSDP_ROUTE_SHARE`` of the picks (control:
   routing counted on a rank's own tokens), and at every later step
   printed; each rank's peak memory over the steps beside the
   shape-derived peaks of gathering the whole params once a step and a
   layer at a time (``fsdp_peak_gb``): below the first by at least half
   the predicted saving. qwen3: the moment scales after the first step of
   the leaves the mesh splits within ``FSDP_SCALE_TOL`` of the leaf's
   largest (control: moments quantized with a block-local absmax); a save
   from the shards (rank 0 writes), restored into one process byte for
   byte the state the ranks hold (a CRC a leaf), whose next step's loss
   and grad_norm lie within ``FSDP_FIRST_RTOL`` of the ranks' same step.
   Then the multi-pod train rules on (pod, data, model) = (2, 1, 1), the
   two ranks splitting the sequence (``MULTIPOD_FAMILIES``: qwen3-0.6b
   and jamba-v0.1-52b, 2 layers each, jamba with 4 of its 16 experts):
   each rank's block its rows' half of the positions, the first step's
   loss and grad_norm within ``MULTIPOD_RTOL`` of one process's from the
   same state; each control (the sequence gather's backward without the
   sum over the pods) puts grad_norm outside.
15. The examples on the card (``examples/torch/``: quickstart,
   serve_quantized, fault_tolerance_demo), each in a process of its own,
   started together before phase 14 and running beside it: each exits 0
   within ``EXAMPLES_BUDGET_S`` (60 s) of its start and prints its
   equalities (the unfused int8 GEMM's CUDA kernel equal to its plain
   version, the speculative greedy stream equal to the plain one, the
   resumed training equal to the uninterrupted run).
16. The dry run against the card (``src/repro_torch/launch/dryrun.py``),
   in a spawned process a world size holding a fake process group (256
   ranks on one pod, 512 on two), side by side: rank 0's step of each of
   ``DRYRUN_CELLS`` (qwen2-0.5b x decode_32k W8A8, full depth; qwen3-0.6b
   x train_4k, 2 of 28 layers, on (16, 16) and on (2, 16, 16)) first on the
   meta device (the dry run's prediction: argument and peak bytes, the
   kernels' meta rules), then on the card from the same arguments made
   real (collectives of the fake group move nothing), after one warm
   step: the card's argument bytes equal the prediction's exactly, the
   predicted peak lies within ``DRYRUN_PEAK_RTOL`` +
   ``DRYRUN_PEAK_ATOL`` of ``torch.cuda.max_memory_allocated`` (reset
   before the step), its two parts (what is resident at the reset, and
   the step's own bytes above it) each within ``DRYRUN_PART_RTOL`` +
   ``DRYRUN_PART_ATOL`` of the card's with a control outside, and K1, K5
   and K7 launched.
17. Report: a ``kernels`` JSON line (each kernel's launches on every path
   that ran it: K7's main path is the int8 training run), the card's name
   and power limit, and as the last line ``{"ok": true, "device":
   {...}}``.

Each phase that draws random cases draws them from a generator of its
own, seeded from ``SEED`` and the phase's number (``phase_gen``), so
cases added to one phase move no other phase's inputs.

The autotune's cache (``$REPRO_TORCH_AUTOTUNE_CACHE``) points at a fresh
temporary file for the whole run, and the engines of phases 3, 6, 7, 8 and
9 pin page 16 and chunk 256, so phases 1-11 launch the seed plans on the
page size and chunk they always measured.

Needs the repository's ``src/`` beside it; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import autotune, blocking, camp  # noqa: E402
from repro_torch.core.quant import (QuantizedTensor, pack_int4,  # noqa: E402
                                    unpack_int4)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import camp_gemm as k5  # noqa: E402
from repro_torch.kernels import camp_gemm_fused as k1  # noqa: E402
from repro_torch.kernels import camp_gemm_w4 as k6  # noqa: E402
from repro_torch.kernels import flash_attention as k8  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as k3  # noqa: E402
from repro_torch.kernels import paged_prefill as k2  # noqa: E402
from repro_torch.kernels import quantize as k7  # noqa: E402
from repro_torch.kernels.epilogue import apply_epilogue, parse_epilogue  # noqa: E402
from repro_torch.kernels.ref import quantize_rowwise_ref  # noqa: E402
from repro_torch.models import init_params, quantize_params  # noqa: E402
from repro_torch.models import frontend  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import modules as modules_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.transformer import init_quantized_params  # noqa: E402
from repro_torch.launch.mesh import RankMesh, spawn_ranks  # noqa: E402
from repro_torch.launch.mesh import AXES, axis_sizes, make_mesh  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel import fsdp as fsdp_mod  # noqa: E402
from repro_torch.parallel.sharding import (axes_of, batch_block,  # noqa: E402
                                           gather_tree, make_rules,
                                           mesh_context, named, shard_params,
                                           shard_tree, train_state_pspecs,
                                           tree_bytes)
from repro_torch.parallel.sharding import (  # noqa: E402
    block_shape as sharding_block_shape)
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import kv_cache as kvc  # noqa: E402
from repro_torch.serving.engine import (ContinuousBatchingEngine,  # noqa: E402
                                        _generate_dense, build_decode_step,
                                        build_prefill_step, generate,
                                        init_serve_caches)
from repro_torch.serving import spec_decode as sd  # noqa: E402
from repro_torch.serving.spec_decode import paged_chunk_forward  # noqa: E402
from repro_torch.data import (SyntheticLMData, batch_specs,  # noqa: E402
                              shard_batch)
from repro_torch.models.transformer import loss_fn  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.optim.adamw import int8_moment_quant  # noqa: E402
from repro_torch.train import build_train_step, init_train_state  # noqa: E402
# the module (the package exports the function ``adamw`` under its name)
adamw_mod = importlib.import_module("repro_torch.optim.adamw")
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train.train_step import (_int8_compress,  # noqa: E402
                                          param_specs, value_and_grad)
from repro_torch.tree import leaves, leaves_with_path, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores
BF16_ULP_REL = 2.0 ** -7           # one bf16 ULP, relative, at most
F32_ULP_REL = 2.0 ** -23           # one f32 ULP, relative, at most
ATT_TOL = 1e-5                     # K2/K3 f32 atol = rtol
# First-step logits, kernels vs plain versions, through all 24 layers, as a
# share of max |logit|, in bf16 and in f32 alike. Each kernel call agrees
# with its plain version on the same inputs (exactly, or within one ULP:
# phase 2 and the in-situ check), but a last-bit difference flips the
# integer rounding of an activation now and then, and every flip moves that
# GEMM's outputs, which flips more roundings in the next layer. Two
# controls, printed beside the gap, measure that amplification (H100, this
# seed): flipping the last bit of layer 0's norm weights moves the plain
# path's own logits by 3.3-8.2% in W8A8 and W4A8 and by 64-78% in W4A4 (an
# int4 activation step is 127/7 ≈ 18× an int8 one), while an unrelated
# prompt lands 135-171% away in every mode.
# * W8A8, W4A8: 10% (measured gaps 3.2-4.6%), well under a wrong page,
#   row or scale.
# * W4A4: 100% (measured gaps 41.0% bf16, 42.6% f32, argmax differing):
#   above what one flipped bit does to this model, below an unrelated
#   prompt.
# The in-situ check holds every kernel call tightly in every mode.
LOGIT_TOL = {"w8a8": 0.10, "w4a8": 0.10, "w4a4": 1.00}
SEED = 0                           # inputs and random weights
QMODES = ("w8a8", "w4a8", "w4a4")

KERNELS = {
    "K1": dict(name="camp_gemm_fused_w8a8", route="cuda",
               source="src/repro_torch/csrc/camp_gemm_fused.cu",
               replaces="src/repro/kernels/camp_gemm_fused.py:108"),
    "K4 w4a8": dict(name="camp_gemm_fused_w4a8", route="cuda",
                    source="src/repro_torch/csrc/camp_gemm_fused.cu",
                    replaces="src/repro/kernels/camp_gemm_fused.py:108"),
    "K4 w4a4": dict(name="camp_gemm_fused_w4a4", route="cuda",
                    source="src/repro_torch/csrc/camp_gemm_fused.cu",
                    replaces="src/repro/kernels/camp_gemm_fused.py:108"),
    "K5": dict(name="camp_gemm_i8", route="cuda",
               source="src/repro_torch/csrc/camp_gemm.cu",
               replaces="src/repro/kernels/camp_gemm.py:121"),
    "K6a": dict(name="camp_gemm_w4", route="cuda",
                source="src/repro_torch/csrc/camp_gemm.cu",
                replaces="src/repro/kernels/camp_gemm_w4.py:135"),
    "K6b": dict(name="camp_gemm_a4w4", route="cuda",
                source="src/repro_torch/csrc/camp_gemm.cu",
                replaces="src/repro/kernels/camp_gemm_w4.py:194"),
    "K7": dict(name="quantize_rowwise", route="cuda",
               source="src/repro_torch/csrc/quantize.cu",
               replaces="src/repro/kernels/quantize.py:46"),
    "K2": dict(name="paged_prefill", route="cuda",
               source="src/repro_torch/csrc/paged_prefill.cu",
               replaces="src/repro/kernels/paged_prefill.py:197"),
    "K3": dict(name="paged_attention", route="cuda",
               source="src/repro_torch/csrc/paged_attention.cu",
               replaces="src/repro/kernels/paged_attention.py:178"),
    "K8": dict(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:88"),
}
# each kernel's launch counter: (module, attribute)
COUNTERS = {"K1": (k1, "launches"), "K4 w4a8": (k1, "launches_w4a8"),
            "K4 w4a4": (k1, "launches_w4a4"), "K5": (k5, "launches"),
            "K6a": (k6, "launches_w4"), "K6b": (k6, "launches_a4w4"),
            "K7": (k7, "launches"), "K2": (k2, "launches"),
            "K3": (k3, "launches"), "K8": (k8, "launches")}
# the kernels each path launches
PATHS = {"w8a8": ("K1", "K2", "K3"), "w4a8": ("K4 w4a8", "K2", "K3"),
         "w4a4": ("K4 w4a4", "K2", "K3"), "unfused": ("K7", "K5", "K6a", "K6b"),
         "flash": ("K8",), "dense": ("K1",), "float pages": ("K1",)}
# qmode → the fused GEMM's key and wrapper name (kernels/camp_gemm_fused.py)
FUSED = {"w8a8": ("K1", "camp_gemm_fused_w8a8"),
         "w4a8": ("K4 w4a8", "camp_gemm_fused_w4a8"),
         "w4a4": ("K4 w4a4", "camp_gemm_fused_w4a4")}
# the six GEMM shapes (M, K, N) of full-width qwen2-0.5b serving: decode
# (batch 8) and prefill (chunk 256) of the gate/up, q/o, k/v and down
# projections
SERVING_SHAPES = ((8, 896, 4864), (8, 896, 896), (8, 896, 128),
                  (8, 4864, 896), (256, 896, 4864), (256, 4864, 896))
EPILOGUES = ("none", "bias", "silu", "mul")


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {key: getattr(mod, attr) for key, (mod, attr) in COUNTERS.items()}


class Timer:
    """Mean device time of ``fn`` in ms, with L2 flushed before each launch
    (a 64 MB write exceeds the 50 MB L2), as the serving path finds it:
    every layer's weights and pages are cold. A ~1 ms device sleep before
    the start event keeps the GPU busy while the host enqueues ``fn``, so
    the events bracket device time, not the wrapper's host overhead."""

    def __init__(self, iters: int = 20):
        self.iters = iters
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def phase_gen(phase: int) -> torch.Generator:
    """The generator of one phase's random cases: seeded from SEED and the
    phase's number, so that cases added to one phase move no other's."""
    return torch.Generator(device="cuda").manual_seed(SEED + phase)


def gate(rows, what: str) -> None:
    """Raise if any checked row failed."""
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"{what}: {len(bad)} kernel checks failed: {bad}")


def within_bf16_ulp(a, b, atol: float = 0.0) -> bool:
    """|a - b| ≤ atol + one bf16 ULP of the larger magnitude."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + BF16_ULP_REL
                 * torch.maximum(a.abs(), b.abs())).all())


def gemm_close(got, want, epilogue: str) -> bool:
    """Exact, except through silu/gelu: one bf16 ULP, or 4 f32 ULPs (the
    card's expf/tanhf against PyTorch's)."""
    if "silu" not in epilogue and "gelu" not in epilogue:
        return torch.equal(got, want)
    if got.dtype == torch.bfloat16:
        return within_bf16_ulp(got, want)
    return bool(((got - want).abs() <= 4 * F32_ULP_REL
                 * torch.maximum(got.abs(), want.abs())).all())


# ---------------------------------------------------------------------------
# Phase 1: the build; K2/K3/K8's register and shared-memory budgets; K8's
# instructions
# ---------------------------------------------------------------------------
PTXAS_SOURCES = {"K3": "paged_attention", "K2": "paged_prefill",
                 "K8": "flash_attention", "K5/K6": "camp_gemm",
                 "K1/K4": "camp_gemm_fused", "K7": "quantize"}
GEMM_SOURCES = ("K5/K6", "K1/K4")
K8_NO_SPILL = (64, 128)      # K8 bf16 builds that must not spill
ASYNC_COPIES = ("UTMALDG", "LDGSTS")
# SASS of the tensor cores: wgmma in bf16 (HGMMA) and in int8 (IGMMA),
# mma.sync in int8 (IMMA); and of __dp4a (IDP.4A on sm_90)
TENSOR_CORE = ("HGMMA", "IGMMA", "IMMA")
SASS_OPS = {**{op: rf"\b{op}\b" for op in (*TENSOR_CORE, *ASYNC_COPIES)},
            "IDP4A": r"\bIDP\.?4A\b"}
# a line of cuobjdump -sass (CUDA 12.8, sm_90a) that each pattern must
# match: IGMMA from K6b's MT 8 instance in camp_gemm, IDP.4A from the dp4a
# kernel that K6b was before it joined the tensor-core template
SASS_LINES = {
    "IGMMA": "        /*4e30*/                   IGMMA.64x8x32.S8.S8 R24, "
             "gdesc[UR20], R24 ;",
    "IDP4A": "        /*2790*/                   IDP.4A.S8.S8 R30, R8, R25, "
             "R30 ;",
}
# a tensor-core GEMM instance (csrc/camp_gemm_tc.cuh): W4, MT, QMAX (0:
# int8 or packed A) and how A arrives (0: packed int4; 1: int8; 2, 4: x in
# bf16, f32)
TC_NAME = re.compile(r"camp_gemm_tc_kernelILb([01])ELi(\d+)ELi(\d+)ELi(\d+)E")
TC_A = {"0": "int4", "1": "int8", "2": "bf16", "4": "f32"}
# the libraries' tensor-core instances: K5/K6a, int8 A, and K6b, packed A;
# K1/K4, x in bf16 and f32 in three qmodes; then their other device kernels
TC_INSTANCES = {"camp_gemm": 3 * len(blocking.TC_ROW_TILES),
                "camp_gemm_fused": 3 * 2 * len(blocking.TC_ROW_TILES)}
TC_OTHERS = {"camp_gemm": ("camp_gemm_tc_flush_kernel",),
             "camp_gemm_fused": ("camp_gemm_tc_flush_kernel",
                                 "camp_gemm_tc_scale_kernel")}
# (W4, QMAX, A) → kernel; x in bf16 or f32 counts as "x"
TC_KEYS = {("0", "0", "int8"): "K5", ("1", "0", "int8"): "K6a",
           ("1", "0", "int4"): "K6b", ("0", "127", "x"): "K1",
           ("1", "127", "x"): "K4 w4a8", ("1", "7", "x"): "K4 w4a4"}


def start_ptxas(tmp):
    """``nvcc -Xptxas -v`` for ``PTXAS_SOURCES``, started beside
    ``build.build_all()`` (whose libraries the kernels load)."""
    return {key: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(Path(tmp) / f"{name}.so"), str(build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, name in PTXAS_SOURCES.items()}


def ptxas_functions(key, proc):
    """[(entry name, {registers, stack, spill_stores, spill_loads})] from
    one ``nvcc -Xptxas -v`` log."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc -Xptxas -v failed for "
                           f"{PTXAS_SOURCES[key]}.cu:\n{log}")
    found, info = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            info = {}
            found.append((m.group(1), info))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m and info is not None:
            info.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                        spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and info is not None:
            info["registers"] = int(m.group(1))
    return found


def tc_instance(name):
    """(kernel key, MT, A element) of a tensor-core GEMM instance's mangled
    name, e.g. ("K4 w4a8", 128, "bf16"); None for any other function."""
    m = TC_NAME.search(name)
    if m is None:
        return None
    a = TC_A[m.group(4)]
    key = TC_KEYS[m.group(1), m.group(3),
                  a if a in ("int4", "int8") else "x"]
    return key, int(m.group(2)), a


def tc_label(inst):
    key, mt, a = inst
    return f"{key} MT {mt}" + ("" if a in ("int4", "int8") else f" {a}")


def other_label(lib_key, name):
    """The scale pass or flush kernel of a GEMM library (``lib_key``: "K1/K4"
    or "K5/K6") by its mangled name, with the scale pass's QMAX and x
    type."""
    part = "scale" if "scale_kernel" in name else "flush"
    q = re.search(r"ILi(\d+)ELi(\d+)E", name)
    return f"{lib_key} {part}" + (
        f" QMAX {q.group(1)} {'bf16' if q.group(2) == '2' else 'f32'}"
        if q else "")


def tc_ptxas_report(procs):
    """Registers, stack, spills and dynamic shared memory of each
    tensor-core product instance (K5/K6a/K6b: a row tile each; K1/K4: a row
    tile and an x type each) and of their scale and flush kernels; raises if
    one spills or one is missing."""
    rows = []
    for key in GEMM_SOURCES:
        lib = PTXAS_SOURCES[key]
        found = others = 0
        for name, info in ptxas_functions(key, procs[key]):
            inst = tc_instance(name)
            if inst is not None:
                found += 1
                rows.append(dict(kernel=tc_label(inst), **info,
                                 smem=k5.tc_smem_bytes(inst[0] != "K5"
                                                       and inst[0] != "K1",
                                                       inst[1])))
            elif any(o in name for o in TC_OTHERS[lib]):
                others += 1
                rows.append(dict(kernel=other_label(key, name), **info,
                                 smem=0))
        want_others = 1 if lib == "camp_gemm" else 1 + 4
        if found != TC_INSTANCES[lib] or others != want_others:
            raise RuntimeError(f"{lib}: {found} tensor-core instances and "
                               f"{others} other kernels, expected "
                               f"{TC_INSTANCES[lib]} and {want_others}")
    for r in sorted(rows, key=lambda r: r["kernel"]):
        print(f"  ptxas {r['kernel']}: {r.get('registers')} registers, stack "
              f"{r.get('stack')} B, spill stores/loads {r.get('spill_stores')}"
              f"/{r.get('spill_loads')} B, dynamic shared memory "
              f"{r['smem']:,} B a block")
    spilled = [r["kernel"] for r in rows
               if r.get("spill_stores") or r.get("spill_loads")]
    if spilled:
        raise RuntimeError(f"tensor-core GEMM kernels that spill: {spilled}")
    return rows


def paged_smem(q: str, dp: int, warps: int) -> int:
    """Dynamic shared memory of one K2/K3 block (csrc/paged_common.cuh:
    q rows, for f32 their probabilities, then two int8 K/V tiles of 64
    tokens with their scales)."""
    rows = (dp + 8) * 2 if q == "bf16" else (dp + 8 + 65) * 4
    return 16 * warps * rows + 2 * (2 * 64 * (dp + 16) + 512)


def ptxas_report(procs):
    """Registers, stack and spills of every K2/K3/K8 device kernel, and the
    dynamic shared memory of each attention build (K2/K3: 1 and 4 warps;
    K8: one block, read from its library)."""
    rows = []
    for key, proc in procs.items():
        if key in (*GEMM_SOURCES, "K7"):
            continue
        for name, info in ptxas_functions(key, proc):
            dp = re.search(r"Li(\d+)E", name)
            rows.append(dict(kernel=key, name=name,
                             part="combine" if "combine_kernel" in name
                             else "attend",
                             q="f32" if ("attend_f32" in name
                                         or "flash_f32" in name) else "bf16",
                             hd_build=int(dp.group(1)) if dp else None,
                             **info))
    for r in sorted(rows, key=lambda r: (r["kernel"], r["part"], r["q"],
                                         r["hd_build"] or 0)):
        smem = ""
        if r["kernel"] == "K8":
            r["smem"] = k8.smem_bytes(
                torch.bfloat16 if r["q"] == "bf16" else torch.float32,
                r["hd_build"])
            smem = f", dynamic shared memory {r['smem']:,} B a block"
        elif r["part"] == "attend":
            r["smem_1_warp"] = paged_smem(r["q"], r["hd_build"], 1)
            r["smem_4_warps"] = paged_smem(r["q"], r["hd_build"], 4)
            smem = (f", dynamic shared memory {r['smem_1_warp']:,} B (1 warp)"
                    f" / {r['smem_4_warps']:,} B (4 warps)")
        build_of = f" hd<={r['hd_build']}" if r["hd_build"] else ""
        print(f"  ptxas {r['kernel']} {r['part']} {r['q']}{build_of}: "
              f"{r.get('registers')} registers, stack {r.get('stack')} B, "
              f"spill stores/loads {r.get('spill_stores')}/"
              f"{r.get('spill_loads')} B{smem}")
    spilled = [r["hd_build"] for r in rows
               if r["kernel"] == "K8" and r["q"] == "bf16"
               and r["hd_build"] in K8_NO_SPILL
               and (r.get("spill_stores") or r.get("spill_loads"))]
    if spilled:
        raise RuntimeError(f"K8 bf16 builds spill: hd {spilled}")
    return rows


def k7_ptxas_report(procs):
    """Registers, stack and spills of every K7 instance (bits and x type);
    raises if one spills or the four are not all there."""
    rows = []
    for name, info in ptxas_functions("K7", procs["K7"]):
        q = re.search(r"quantize_rowwise_kernelILi(\d+)ELi(\d+)E", name)
        if q is None:
            continue
        rows.append(dict(kernel=f"K7 QMAX {q.group(1)} "
                         f"{'bf16' if q.group(2) == '2' else 'f32'}", **info))
    for r in sorted(rows, key=lambda r: r["kernel"]):
        print(f"  ptxas {r['kernel']}: {r.get('registers')} registers, stack "
              f"{r.get('stack')} B, spill stores/loads {r.get('spill_stores')}"
              f"/{r.get('spill_loads')} B")
    spilled = [r["kernel"] for r in rows
               if r.get("spill_stores") or r.get("spill_loads")]
    if spilled or len(rows) != 4:
        raise RuntimeError(f"K7 instances: {[r['kernel'] for r in rows]}; "
                           f"spilled: {spilled}")
    return rows


def cuobjdump_path():
    """The toolkit's cuobjdump beside nvcc, else Triton's copy; None when
    neither exists."""
    cand = Path(build.nvcc_path()).parent / "cuobjdump"
    if cand.exists():
        return str(cand)
    try:
        import triton
    except ImportError:
        return None
    cand = Path(triton.__file__).parent / "backends/nvidia/bin/cuobjdump"
    return str(cand) if cand.exists() else None


def k8_sass():
    """HGMMA and asynchronous-copy instructions of every K8 bf16 build, from
    ``cuobjdump -sass`` of the built library; raises if a build has none of
    either. None (and "not measured") without cuobjdump."""
    tool = cuobjdump_path()
    if tool is None:
        print("  K8 SASS: no cuobjdump beside nvcc or in Triton: not measured")
        return None
    lib = build.lib_path("flash_attention")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        if "flash_bf16_kernel" not in name:
            continue
        dp = int(re.search(r"Li(\d+)E", name).group(1))
        counts[dp] = {op: len(re.findall(rf"\b{op}\b", part))
                      for op in ("HGMMA", *ASYNC_COPIES)}
    for dp, c in sorted(counts.items()):
        print(f"  K8 SASS bf16 hd<={dp}: " + ", ".join(
            f"{op} {n}" for op, n in c.items()))
    bad = [dp for dp, c in counts.items()
           if not c["HGMMA"] or not any(c[op] for op in ASYNC_COPIES)]
    if bad or len(counts) != 6:
        raise RuntimeError(f"K8 bf16 builds without wgmma or asynchronous "
                           f"copies: {bad} (of {sorted(counts)})")
    return counts


def sass_patterns_match():
    """Raise unless each pattern of ``SASS_LINES`` matches its literal line
    and no other pattern does (the control that a count of 0 means the
    instruction is absent, not that the pattern is wrong)."""
    for op, line in SASS_LINES.items():
        hits = [o for o, pat in SASS_OPS.items() if re.search(pat, line)]
        if hits != [op]:
            raise RuntimeError(f"the SASS patterns {hits} match {line!r}; "
                               f"expected only {op}")


def tc_sass():
    """Tensor-core (``HGMMA``, ``IGMMA``, ``IMMA``), asynchronous-copy and
    dp4a (``IDP.4A``) instructions of every tensor-core instance (K5/K6a/K6b
    in ``camp_gemm``, K1/K4 in ``camp_gemm_fused``) and of the scale and
    flush kernels, from ``cuobjdump -sass`` of the built libraries; raises
    if an instance lacks a tensor-core or an asynchronous-copy instruction,
    or if either library holds a dp4a anywhere. None (and "not measured")
    without cuobjdump."""
    sass_patterns_match()
    tool = cuobjdump_path()
    if tool is None:
        print("  GEMM SASS: no cuobjdump beside nvcc or in Triton: not "
              "measured")
        return None
    counts, bad = {}, []
    for key, lib in zip(GEMM_SOURCES, ("camp_gemm", "camp_gemm_fused")):
        sass = subprocess.run([tool, "-sass", str(build.lib_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        found = 0
        for part in sass.split("Function : ")[1:]:
            name = part.split()[0]
            inst = tc_instance(name)
            label = tc_label(inst) if inst else (
                other_label(key, name)
                if any(o in name for o in TC_OTHERS[lib])
                else f"{lib} {name[:60]}")
            c = {op: len(re.findall(pat, part))
                 for op, pat in SASS_OPS.items()}
            counts[label] = c
            if c["IDP4A"]:
                bad.append(label)
            if inst is not None:
                found += 1
                if (not any(c[op] for op in TENSOR_CORE)
                        or not any(c[op] for op in ASYNC_COPIES)):
                    bad.append(label)
        if found != TC_INSTANCES[lib]:
            bad.append(f"{lib}: {found} instances")
    for label, c in sorted(counts.items()):
        print(f"  {label} SASS: " + ", ".join(f"{op} {n}"
                                              for op, n in c.items()))
    if bad:
        raise RuntimeError(f"tensor-core instances without tensor-core or "
                           f"asynchronous-copy instructions, or kernels "
                           f"with IDP4A: {bad}")
    return counts


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def int_mm(a_q, b_q):
    """torch._int_mm (cuBLASLt wants M > 16, so small M is padded to 32)."""
    m = a_q.shape[0]
    if m <= 16:
        a_q = F.pad(a_q, (0, 0, 0, 32 - m))
    return torch._int_mm(a_q, b_q)[:m]


def library_flush(acc, a_s, s_b, epilogue, bias, operand, out_dtype):
    y = acc.float() * (a_s * s_b)
    y = apply_epilogue(y, parse_epilogue(epilogue),
                       bias=None if bias is None else bias.reshape(1, -1),
                       operand=operand)
    return y.to(out_dtype)


def fused_library(qmode):
    """Yardstick for K1/K4: rowwise quantize, unpack W (int4), then
    torch._int_mm and the elementwise flush."""
    a_bits = 4 if qmode == "w4a4" else 8

    def run(x, w, s_b, *, out_dtype, epilogue, bias, operand):
        a_q, a_s = quantize_rowwise_ref(x, a_bits)
        b_q = w if qmode == "w8a8" else unpack_int4(w, x.shape[1])
        return library_flush(int_mm(a_q, b_q), a_s, s_b, epilogue, bias,
                             operand, out_dtype)
    return run


def unfused_library(kind):
    """Yardstick for K5/K6: unpack the packed operands, torch._int_mm, and
    the elementwise flush."""
    def run(a, w, s_a, s_b, *, out_dtype, epilogue, bias, operand):
        k = w.shape[0] * (1 if kind == "i8" else 2)
        a_q = unpack_int4(a.T, k).T if kind == "a4w4" else a
        b_q = w if kind == "i8" else unpack_int4(w, k)
        return library_flush(int_mm(a_q.contiguous(), b_q), s_a, s_b,
                             epilogue, bias, operand, out_dtype)
    return run


def kmajor_b(w, kind):
    """B int8 and K-major (unpacked for int4), as a deployment that stored
    its weights for cuBLASLt's preferred "TN" layout would."""
    k = w.shape[0] * (1 if kind == "i8" else 2)
    return (w if kind == "i8" else unpack_int4(w, k)).t().contiguous()


def kmajor_library(kind):
    """Second yardstick for K5/K6: torch._int_mm on K-major B, alone
    (``flush=False``) and with the elementwise flush (K6b: with A's unpack
    too). ``prepare`` unpacks and transposes B once, and unpacks A once for
    the product alone, outside the timed region."""
    def unpack_a(a, w):
        return unpack_int4(a.T, 2 * w.shape[0]).T.contiguous()

    def prepare(a, w, s_a, s_b):
        return (unpack_a(a, w) if kind == "a4w4" else a), kmajor_b(w, kind)

    def run(state, a, w, s_a, s_b, *, flush, out_dtype, epilogue, bias,
            operand):
        a_q, b_t = state
        if not flush:
            return int_mm(a_q, b_t.t())
        if kind == "a4w4":
            a_q = unpack_a(a, w)
        return library_flush(int_mm(a_q, b_t.t()), s_a, s_b, epilogue, bias,
                             operand, out_dtype)
    return prepare, run


def fused_kmajor(qmode):
    """Second yardstick for K1/K4: torch._int_mm on K-major B, alone on the
    activations quantized beforehand (``flush=False``), and with the
    rowwise quantize and the elementwise flush, the whole function.
    ``prepare`` quantizes once and unpacks and transposes B once, outside
    the timed region."""
    a_bits = 4 if qmode == "w4a4" else 8

    def prepare(x, w, s_b):
        return quantize_rowwise_ref(x, a_bits)[0], kmajor_b(
            w, "i8" if qmode == "w8a8" else "w4")

    def run(state, x, w, s_b, *, flush, out_dtype, epilogue, bias, operand):
        a_q, b_t = state
        if not flush:
            return int_mm(a_q, b_t.t())
        a_q, a_s = quantize_rowwise_ref(x, a_bits)
        return library_flush(int_mm(a_q, b_t.t()), a_s, s_b, epilogue, bias,
                             operand, out_dtype)
    return prepare, run


def time_library(timer, key, fn, what):
    """``timer(fn)``, or None (printed) where cuBLASLt refuses the shape."""
    try:
        return timer(fn)
    except RuntimeError as e:
        print(f"  {key} {what} unavailable: {e}")
        return None


def gemm_case(timer, key, kernel, plain, library, args, kw, n_ops, desc,
              kmajor=None):
    """One GEMM kernel against its plain version: error, times, bound; with
    ``kmajor`` (every tensor-core kernel) also the K-major ``_int_mm``
    yardsticks, the split plan and the device kernels a call launches."""
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    epi = kw["epilogue"]
    err, ok = max_err(got, want), gemm_close(got, want, epi)
    m, n = got.shape
    n_bytes = nbytes(*args, kw["bias"], kw["operand"]) + m * n * got.element_size()
    b_ms, b_by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
    lib = time_library(timer, key, lambda: library(*args, **kw),
                       "library yardstick")
    row = dict(kernel=key, **desc, epilogue=epi, dtype=str(got.dtype),
               max_abs_err=err, ok=ok, ms=timer(lambda: kernel(*args, **kw)),
               plain_ms=timer(lambda: plain(*args, **kw)), library_ms=lib,
               bound_ms=b_ms, bound_by=b_by)
    extra = ""
    if kmajor is not None:
        prepare, run = kmajor
        state = prepare(*args)
        for flush, col in ((False, "library_kmajor_ms"),
                           (True, "library_kmajor_flush_ms")):
            row[col] = time_library(
                timer, key, lambda: run(state, *args, flush=flush, **kw),
                "K-major _int_mm" + (" + flush" if flush else ""))
        a = args[0]
        row["plan"] = k5.plan_for(a, n, desc["k"], len(args) == 3)
        row["device_kernels"] = k5.device_kernels(row["plan"].flags)
        extra = (f" tn={row['library_kmajor_ms']} "
                 f"tn+flush={row['library_kmajor_flush_ms']} "
                 f"plan={row['plan']} kernels={row['device_kernels']}")
    tol = "exact" if "silu" not in epi else "1 ULP"
    print(f"  {key:7s} " + " ".join(f"{a}={b}" for a, b in desc.items())
          + f" {epi:4s} {str(got.dtype)[6:]:8s} err={err:.3g} ({tol} "
          f"{'ok' if ok else 'FAIL'}) ms={row['ms']:.4f} "
          f"plain={row['plain_ms']:.4f} lib={lib}{extra} bound={b_ms:.4f} "
          f"({b_by})")
    return row


def _weight(gen, k, n, w4):
    """Random int8 (K, N) weights, or int4 values packed to (K//2, N)."""
    if not w4:
        return torch.randint(-127, 128, (k, n), dtype=torch.int8,
                             device="cuda", generator=gen)
    return pack_int4(torch.randint(-7, 8, (k, n), dtype=torch.int8,
                                   device="cuda", generator=gen))


def _extras(gen, m, n, epi, dtype):
    bias = (torch.randn(n, device="cuda", generator=gen).to(dtype)
            if epi == "bias" else None)
    opd = (torch.randn(m, n, device="cuda", generator=gen).to(dtype)
           if epi == "mul" else None)
    return bias, opd


def check_fused(timer, gen, qmode, shapes, dtypes, out_dtype=None,
                epilogues=EPILOGUES):
    """K1 (w8a8) or K4 (w4a8, w4a4) at ``shapes`` for every epilogue of
    ``epilogues``, x in each of ``dtypes``, out in x's dtype or
    ``out_dtype``."""
    key, name = FUSED[qmode]
    kernel, plain = getattr(k1, name), getattr(k1, name + "_ref")
    rows = []
    for m, k, n in shapes:
        w = _weight(gen, k, n, qmode != "w8a8")
        s_b = torch.rand(1, n, device="cuda", generator=gen) * 0.01 + 1e-4
        for dtype in dtypes:
            x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
            for epi in epilogues:
                bias, opd = _extras(gen, m, n, epi, dtype)
                kw = dict(out_dtype=out_dtype or dtype, epilogue=epi,
                          bias=bias, operand=opd)
                rows.append(gemm_case(timer, key, kernel, plain,
                                      fused_library(qmode), (x, w, s_b), kw,
                                      2.0 * m * n * k, dict(m=m, k=k, n=n),
                                      kmajor=fused_kmajor(qmode)))
    return rows


def fused_scale_modes(timer, gen):
    """K1 and K4 (w4a8) at the serving shapes and at row tile 32, with the
    row scales from the block's own warps and from the scale pass kernel:
    both exact, their times beside each other (kernels/camp_gemm.py's
    ``SCALE_KERNEL_ROW_TILES`` keeps the faster per row tile)."""
    rows = []
    for qmode in ("w8a8", "w4a8"):
        name = FUSED[qmode][1]
        for m, k, n in SERVING_SHAPES + ((32, 896, 4864), (32, 4864, 896)):
            w = _weight(gen, k, n, qmode != "w8a8")
            s_b = torch.rand(1, n, device="cuda", generator=gen) * 0.01 + 1e-4
            x = torch.randn(m, k, device="cuda", generator=gen).to(
                torch.bfloat16)
            kw = dict(out_dtype=torch.bfloat16, epilogue="none", bias=None,
                      operand=None)
            *plan, flags = k5.plan_for(x, n, k, True)
            want = getattr(k1, name + "_ref")(x, w, s_b, **kw)
            times = {}
            for mode, fl in (("block", flags & ~blocking.SCALE_KERNEL),
                             ("scale pass", flags | blocking.SCALE_KERNEL)):
                def call():
                    return k5.launch_gemm("camp_gemm_fused", name, x, None, w,
                                          s_b, k, plan=plan, flags=fl, **kw)
                if not torch.equal(call(), want):
                    raise RuntimeError(f"{qmode} {(m, k, n)} with the scales "
                                       f"from the {mode} differs")
                times[mode] = timer(call)
            chosen = "scale pass" if flags & blocking.SCALE_KERNEL else "block"
            print(f"  {FUSED[qmode][0]:7s} m={m} k={k} n={n} plan={plan} "
                  f"scales from the block {times['block']:.4f} ms, from the "
                  f"scale pass {times['scale pass']:.4f} ms; the wrapper "
                  f"takes the {chosen}")
            rows.append(dict(kernel=FUSED[qmode][0], m=m, k=k, n=n,
                             plan=plan, chosen=chosen,
                             block_ms=times["block"],
                             scale_pass_ms=times["scale pass"]))
    return rows


def fused_controls(gen):
    """Controls for K1 and K4 at M 8 and M 256, K 4,864, N 896: the kernel
    launched with each split's row scales taken from its own K range only
    (``SPLIT_SCALES``), and with its plan's last split dropped. The exact
    check must reject both."""
    rows = []
    for qmode in QMODES:
        key, name = FUSED[qmode]
        for m, k, n in ((8, 4864, 896), (256, 4864, 896)):
            w = _weight(gen, k, n, qmode != "w8a8")
            s_b = torch.rand(1, n, device="cuda", generator=gen) * 0.01 + 1e-4
            x = torch.randn(m, k, device="cuda", generator=gen).to(
                torch.bfloat16)
            kw = dict(out_dtype=torch.bfloat16, epilogue="none", bias=None,
                      operand=None)
            mt, splits, per, _ = k5.plan_for(x, n, k, True)
            plan = (mt, splits, per)
            want = getattr(k1, name + "_ref")(x, w, s_b, **kw)
            got = {"split-local scales": k5.launch_gemm(
                       "camp_gemm_fused", name, x, None, w, s_b, k, plan=plan,
                       flags=blocking.SPLIT_SCALES, **kw),
                   "last split dropped": k5.launch_gemm(
                       "camp_gemm_fused", name, x, None, w, s_b, k,
                       plan=(mt, splits - 1, per), **kw)}
            torch.cuda.synchronize()
            for what, y in got.items():
                caught = not gemm_close(y, want, "none")
                print(f"  {key} control, {what}, M={m} K={k} N={n} (plan "
                      f"{plan}): err={max_err(y, want):.3g}, "
                      f"{'caught' if caught else 'NOT CAUGHT'}")
                if splits < 2 or not caught:
                    raise RuntimeError(f"{key}'s exact check passes {what}")
                rows.append(dict(kernel=key, control=what, m=m, k=k, n=n,
                                 splits=splits, max_abs_err=max_err(y, want)))
    return rows


# ragged shapes for the tensor-core GEMMs (M, K, N): every M the row tiles
# leave ragged, an N and Ks whose rows are not 16-byte aligned (the
# byte-gather loads; K6b's packed rows of 2,435 and 2,440 bytes too), K
# 4,870 even for the packed operands; then 16-byte aligned rows with
# ragged tiles on every edge (TMA's zero fill)
RAGGED_SHAPES = ((1, 928, 200), (3, 4870, 200), (17, 928, 200),
                 (100, 4870, 200), (100, 4880, 208))
UNFUSED = {"i8": ("K5", k5.camp_gemm_i8, k5.camp_gemm_i8_ref),
           "w4": ("K6a", k6.camp_gemm_w4, k6.camp_gemm_w4_ref),
           "a4w4": ("K6b", k6.camp_gemm_a4w4, k6.camp_gemm_a4w4_ref)}


def _unfused_inputs(gen, kind, m, k, n):
    w = _weight(gen, k, n, kind != "i8")
    s_b = torch.rand(1, n, device="cuda", generator=gen) * 0.01 + 1e-4
    if kind == "a4w4":
        a = pack_int4(torch.randint(-7, 8, (m, k), dtype=torch.int8,
                                    device="cuda", generator=gen).T
                      ).T.contiguous()
    else:
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                          device="cuda", generator=gen)
    s_a = torch.rand(m, 1, device="cuda", generator=gen) * 0.01 + 1e-4
    return a, w, s_a, s_b


def check_unfused(timer, gen, kind, shapes=SERVING_SHAPES + RAGGED_SHAPES,
                  epilogues=EPILOGUES, out_dtype=torch.bfloat16):
    """K5 (i8), K6a (w4) or K6b (a4w4) at ``shapes`` (M, K, N), by
    default the serving and the ragged ones, bf16, with their split plans
    and the K-major ``_int_mm`` yardsticks."""
    key, kernel, plain = UNFUSED[kind]
    rows = []
    for m, k, n in shapes:
        args = _unfused_inputs(gen, kind, m, k, n)
        for epi in epilogues:
            bias, opd = _extras(gen, m, n, epi, torch.bfloat16)
            kw = dict(out_dtype=out_dtype, epilogue=epi, bias=bias,
                      operand=opd)
            rows.append(gemm_case(timer, key, kernel, plain,
                                  unfused_library(kind), args, kw,
                                  2.0 * m * n * k, dict(m=m, k=k, n=n),
                                  kmajor=kmajor_library(kind)))
    return rows


def k5_dropped_split(gen, kind, shape):
    """Control: K5, K6a or K6b launched with its plan's last split left out
    (splits - 1 runs of the same K steps, so the last run's K range is
    never summed). The exact check must reject it."""
    key, _, plain = UNFUSED[kind]
    m, k, n = shape
    a, w, s_a, s_b = _unfused_inputs(gen, kind, m, k, n)
    mt, splits, per, _ = k5.plan_for(a, n, k, False)
    kw = dict(out_dtype=torch.bfloat16, epilogue="none", bias=None,
              operand=None)
    got = k5.launch_gemm("camp_gemm", UNFUSED[kind][1].__name__, a, s_a, w,
                         s_b, k, plan=(mt, splits - 1, per), **kw)
    want = plain(a, w, s_a, s_b, **kw)
    torch.cuda.synchronize()
    caught = not gemm_close(got, want, "none")
    print(f"  {key} control, the last of {splits} splits dropped at M={m} "
          f"K={k} N={n}: err={max_err(got, want):.3g}, "
          f"{'caught' if caught else 'NOT CAUGHT'}")
    if splits < 2 or not caught:
        raise RuntimeError(f"{key}'s exact check passes a dropped split")
    return dict(kernel=key, m=m, k=k, n=n, splits=splits,
                max_abs_err=max_err(got, want))


# K7's shapes (M, K): the serving activations' (decode 8, prefill 256, the
# dense prefill 4,096; d 896 and d_ff 4,864), one row, K 4,870 (rows not
# 16-byte aligned: element loads) and qwen2-72b's d_ff 29,568
K7_SHAPES = ((1, 896), (8, 896), (256, 896), (4096, 896), (8, 4864),
             (256, 4864), (256, 4870), (8, 29568), (256, 29568))


def check_k7(timer, gen, shapes=K7_SHAPES,
             dtypes=(torch.bfloat16, torch.float32)):
    """K7 at ``shapes`` (default ``K7_SHAPES``), bits 8 and 4, in
    ``dtypes``, a zero row in each (but M 1), with its threads a row
    (``team_size``). No single PyTorch call computes it, so there is no
    library yardstick; beside it is timed one that moves the same bytes,
    ``x.to(torch.int8)`` (reads x, writes M x K int8), the floor this
    timer gives a one-pass kernel of them."""
    rows = []
    for m, k in shapes:
        for dtype in dtypes:
            x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
            if m > 1:
                x[m // 2] = 0.0                         # a zero row → (0, 1)
            team = k7.team_size(m, k, x.element_size(), k5.sms_of(x))
            for bits in (8, 4):
                q, s = k7.quantize_rowwise_kernel(x, bits=bits)
                q_r, s_r = quantize_rowwise_ref(x, bits)
                torch.cuda.synchronize()
                ok = torch.equal(q, q_r) and torch.equal(s, s_r)
                err = max(max_err(q, q_r), max_err(s, s_r))
                # reads x, writes q and s; ~3 f32 operations a value
                b_ms, b_by = bound(nbytes(x, q, s), 3.0 * m * k,
                                   F32_OPS_PER_S)
                row = dict(kernel="K7", m=m, k=k, bits=bits,
                           dtype=str(dtype), team=team, max_abs_err=err,
                           ok=ok,
                           ms=timer(lambda: k7.quantize_rowwise_kernel(
                               x, bits=bits)),
                           plain_ms=timer(lambda: quantize_rowwise_ref(
                               x, bits)),
                           library_ms=None,
                           same_bytes_ms=timer(lambda: x.to(torch.int8)),
                           bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
                print(f"  K7      m={m} k={k} bits={bits} {str(dtype)[6:]:8s}"
                      f" team={team} err={err:.3g} "
                      f"(exact {'ok' if ok else 'FAIL'}) "
                      f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                      f"lib=None x.to(int8)={row['same_bytes_ms']:.4f} "
                      f"bound={b_ms:.4f} ({b_by})")
    return rows


def _pages(gen, num_pages, kv, ps, hd):
    def i8():
        return torch.randint(-127, 128, (num_pages, kv, ps, hd),
                             dtype=torch.int8, device="cuda", generator=gen)

    def sc():
        return torch.rand(num_pages, kv, ps, device="cuda",
                          generator=gen) * 0.05 + 1e-3
    return i8(), i8(), sc(), sc()


def _dense(pages, scales, slots):
    """Gather + dequantize pages → (KV, T, hd) f32 (yardstick inputs)."""
    x = pages[slots.long()].float() * scales[slots.long()][..., None]
    return x.transpose(0, 1).reshape(pages.shape[1], -1, pages.shape[3])


def _att_ok(got, want, dtype):
    if dtype == torch.float32:
        return bool(((got - want).abs() <= ATT_TOL + ATT_TOL * want.abs())
                    .all())
    return within_bf16_ulp(got, want, atol=ATT_TOL)


def _k3_inputs(gen, b, kv, g, hd, ps, lengths, max_pages, dtype):
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    num_pages = b * max_pages + 8
    kp, vp, ks, vs = _pages(gen, num_pages, kv, ps, hd)
    tables = torch.randperm(num_pages, device="cuda", generator=gen)[
        :b * max_pages].reshape(b, max_pages).int().contiguous()
    q = torch.randn(b, kv, g, hd, device="cuda", generator=gen).to(dtype)
    return q, kp, vp, ks, vs, tables, lengths


def k3_plan(q, tables, ps):
    """K3's split of the kv tiles for these inputs (the wrapper's)."""
    b, kv, g, _ = q.shape
    return k3.plan_for(q, b * kv, g, -(-tables.shape[1] * ps // 64))


def k3_case(timer, args, label):
    """One K3 call against its plain version: error, the plan and device
    kernels per call, times beside the plain version and SDPA, bound."""
    q, kp, vp, ks, vs, tables, lengths = args
    b, kv, g, hd = q.shape
    ps, max_pages = kp.shape[2], tables.shape[1]
    got = k3.paged_attention_cuda(*args)
    want = k3.paged_attention_reference(*args)
    torch.cuda.synchronize()
    err, ok = max_err(got, want), _att_ok(got.float(), want.float(), q.dtype)
    plan = k3_plan(q, tables, ps)
    n_used = ((lengths + ps - 1) // ps).long()
    tokens = lengths.long().sum().item()
    pages_read = n_used.sum().item()
    n_bytes = (2 * q.numel() * q.element_size()
               + pages_read * kv * ps * (2 * hd + 8) + 4 * (pages_read + b))
    b_ms, b_by = bound(n_bytes, 4.0 * g * hd * kv * tokens, BF16_OPS_PER_S)
    # yardstick: SDPA over the dequantized dense KV (prepared outside)
    k_d = torch.stack([_dense(kp, ks, tables[i]) for i in range(b)])
    v_d = torch.stack([_dense(vp, vs, tables[i]) for i in range(b)])
    mask = (torch.arange(max_pages * ps, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    q_s = q.float().reshape(b, kv * g, 1, hd)

    def lib():
        return F.scaled_dot_product_attention(q_s, k_d, v_d, attn_mask=mask,
                                              enable_gqa=True)
    row = dict(kernel="K3", label=label, b=b, kv=kv, g=g, hd=hd, ps=ps,
               dtype=str(q.dtype), plan=list(plan),
               device_kernels=1 if plan[0] == 1 else 2, max_abs_err=err,
               ok=ok, ms=timer(lambda: k3.paged_attention_cuda(*args)),
               plain_ms=timer(lambda: k3.paged_attention_reference(*args)),
               library_ms=timer(lib), bound_ms=b_ms, bound_by=b_by)
    del k_d, v_d
    print(f"  K3 {label}: B={b} KV={kv} G={g} hd={hd} ps={ps} "
          f"{str(q.dtype)[6:]} splits={plan[0]}x{plan[1]} tiles "
          f"({row['device_kernels']} kernels) err={err:.3g} "
          f"({'ok' if ok else 'FAIL'}) ms={row['ms']:.4f} "
          f"plain={row['plain_ms']:.4f} sdpa={row['library_ms']:.4f} "
          f"bound={b_ms:.4f} ({b_by})")
    return row


def k3_dropped_tile(args):
    """Control: the same K3 call with its last kv tile left out (bf16: the
    last split left out of the merge; f32, one split: the walk stopped a
    tile early). ``_att_ok`` must reject it."""
    q, kp, vp, ks, vs, tables, lengths = args
    n_split, per = k3_plan(q, tables, kp.shape[2])
    plan = (n_split - 1, per) if n_split > 1 else (1, per - 1)
    got = k3._run(*args, None, plan)
    want = k3.paged_attention_reference(*args)
    torch.cuda.synchronize()
    caught = not _att_ok(got.float(), want.float(), q.dtype)
    print(f"  K3 control, the last kv tile dropped (plan {plan} for "
          f"{(n_split, per)}, {str(q.dtype)[6:]}): err="
          f"{max_err(got, want):.3g}, {'caught' if caught else 'NOT CAUGHT'}")
    if not caught:
        raise RuntimeError("K3's check passes a dropped kv tile")
    return dict(dtype=str(q.dtype), max_abs_err=max_err(got, want))


def check_k3(timer, gen):
    """The serving batch (B 8, lengths 1 to 544; the headline rows) and the
    dropped-tile control, then K3 at the other registry head shapes, page
    sizes 8 and 32 (the autotune's candidates beside 16), one 4,096-token
    sequence and a ragged batch of 32."""
    rows, controls = [], []
    serving = [1, 16, 17, 100, 255, 512, 529, 544]
    for dtype in (torch.float32, torch.bfloat16):
        args = _k3_inputs(gen, 8, 2, 7, 64, 16, serving, 34, dtype)
        rows.append(k3_case(timer, args, "serving"))
        controls.append(k3_dropped_tile(args))
    ragged = [1, 15, 16, 17, 31, 32, 33, 100, 255, 256, 257, 300, 511, 512,
              513, 529, 544, 600, 700, 777, 800, 900, 1000, 1023, 1024, 1,
              16, 48, 64, 65, 128, 129]
    shapes = (   # label, B, KV, G, hd, ps, lengths, table width in pages
        ("qwen3-0.6b heads (hd 128, G 2)", 4, 8, 2, 128, 16,
         [1, 100, 513, 1000], 64),
        ("qwen2-72b heads (hd 128, G 8)", 4, 8, 8, 128, 16,
         [1, 100, 513, 1000], 64),
        ("stablelm-12b heads (hd 160, G 4)", 4, 8, 4, 160, 16,
         [1, 100, 513, 1000], 64),
        ("moonshot-v1-16b-a3b heads (hd 128, G 1)", 8, 16, 1, 128, 16,
         serving, 34),
        ("serving, page size 8", 8, 2, 7, 64, 8, serving, 68),
        ("serving, page size 32", 8, 2, 7, 64, 32, serving, 17),
        ("one sequence of 4,096 tokens", 1, 2, 7, 64, 16, [4096], 256),
        ("32 ragged sequences", 32, 2, 7, 64, 16, ragged, 64))
    for label, b, kv, g, hd, ps, lengths, width in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = _k3_inputs(gen, b, kv, g, hd, ps, lengths, width, dtype)
            rows.append(k3_case(timer, args, label))
    return rows, controls


def k2_case(timer, gen, label, kv, g, hd, ps, c, q_start, dtype):
    """One K2 chunk against its plain version: error, plan, times beside
    the plain version and SDPA, bound."""
    n_pages = -(-(q_start + c) // ps)
    num_pages = n_pages + 16
    kp, vp, ks, vs = _pages(gen, num_pages, kv, ps, hd)
    table = torch.randperm(num_pages, device="cuda", generator=gen)[
        :n_pages + 2].int().contiguous()
    visible = sum(q_start + i + 1 for i in range(c))
    q = torch.randn(kv, c, g, hd, device="cuda", generator=gen).to(dtype)
    args = (q, kp, vp, ks, vs, table)
    got = k2.paged_prefill_cuda(*args, q_start=q_start)
    want = k2.paged_prefill_reference(*args, q_start=q_start)
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = _att_ok(got.float(), want.float(), dtype)
    plan = k2.plan_for(q, kv, c * g, -(-(q_start + c) // 64))
    n_bytes = (2 * q.numel() * q.element_size()
               + n_pages * kv * ps * (2 * hd + 8) + 4 * n_pages)
    b_ms, b_by = bound(n_bytes, 4.0 * g * hd * kv * visible, BF16_OPS_PER_S)
    k_d = _dense(kp, ks, table[:n_pages])[None]
    v_d = _dense(vp, vs, table[:n_pages])[None]
    t = n_pages * ps
    mask = (torch.arange(t, device="cuda")[None, :]
            <= q_start + torch.arange(c, device="cuda")[:, None])
    q_s = q.float().permute(0, 2, 1, 3).reshape(1, kv * g, c, hd)

    def lib():
        return F.scaled_dot_product_attention(q_s, k_d, v_d, attn_mask=mask,
                                              enable_gqa=True)
    row = dict(kernel="K2", label=label, kv=kv, g=g, hd=hd, ps=ps, c=c,
               q_start=q_start, dtype=str(dtype), plan=list(plan),
               device_kernels=1 if plan[0] == 1 else 2, max_abs_err=err,
               ok=ok, ms=timer(lambda: k2.paged_prefill_cuda(
                   *args, q_start=q_start)),
               plain_ms=timer(lambda: k2.paged_prefill_reference(
                   *args, q_start=q_start)),
               library_ms=timer(lib), bound_ms=b_ms, bound_by=b_by)
    print(f"  K2 {label}: C={c} q_start={q_start} KV={kv} G={g} hd={hd} "
          f"ps={ps} {str(dtype)[6:]} splits={plan[0]}x{plan[1]} tiles "
          f"err={err:.3g} ({'ok' if ok else 'FAIL'}) ms={row['ms']:.4f} "
          f"plain={row['plain_ms']:.4f} sdpa={row['library_ms']:.4f} "
          f"bound={b_ms:.4f} ({b_by})")
    return row


def k2_split_sweep(timer, gen):
    """K2 at the serving chunk (C 256, q_start 512, bf16) with its 12 kv
    tiles cut into 1, 2, 3, 4, 6 and 12 splits, each output checked: the
    measurement behind split_plan's target of four blocks per SM."""
    kv, g, hd, ps, c, q_start = 2, 7, 64, 16, 256, 512
    n_pages = -(-(q_start + c) // ps)
    kp, vp, ks, vs = _pages(gen, n_pages + 16, kv, ps, hd)
    table = torch.randperm(n_pages + 16, device="cuda", generator=gen)[
        :n_pages + 2].int().contiguous()
    q = torch.randn(kv, c, g, hd, device="cuda",
                    generator=gen).to(torch.bfloat16)
    args = (q, kp, vp, ks, vs, table)
    want = k2.paged_prefill_reference(*args, q_start=q_start)
    tiles = -(-(q_start + c) // 64)
    times = {}
    for n in (1, 2, 3, 4, 6, 12):
        per = -(-tiles // n)
        plan = (-(-tiles // per), per)
        got = k2._run(*args, q_start, None, plan)
        torch.cuda.synchronize()
        if not _att_ok(got.float(), want.float(), q.dtype):
            raise RuntimeError(f"K2 with {plan[0]} splits differs from its "
                               f"plain version by {max_err(got, want):.3g}")
        times[plan[0]] = timer(lambda: k2._run(*args, q_start, None, plan))
    print("  K2 C=256 q_start=512 bf16 by number of splits (ms): "
          + ", ".join(f"{n}: {ms:.4f}" for n, ms in times.items())
          + f"; the wrapper picks {k2.plan_for(q, kv, c * g, tiles)[0]}")
    return times


def check_k2(timer, gen):
    """The serving chunk (C 256 at q_start 0, 512 and 517; q_start 512 in
    bf16 is the headline row), then the other registry head shapes, page
    size 8, the autotune's chunk (C 512 at q_start 0 and 512; on pages of
    32 too), a speculative verify panel (gamma 4: C 5) at a mid-page and a
    page-aligned q_start, a one-token feed, and the reduced draft's heads
    (hd 16, G 4) as a feed and a ragged catch-up chunk."""
    rows = []
    for q_start in (0, 512, 517):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(k2_case(timer, gen, "serving", 2, 7, 64, 16, 256,
                                q_start, dtype))
    for label, kv, g, hd, ps, c, q_start in (
            ("qwen3-0.6b heads (hd 128, G 2)", 8, 2, 128, 16, 256, 512),
            ("qwen2-72b heads (hd 128, G 8)", 8, 8, 128, 16, 256, 512),
            ("stablelm-12b heads (hd 160, G 4)", 8, 4, 160, 16, 256, 512),
            ("moonshot-v1-16b-a3b heads (hd 128, G 1)", 16, 1, 128, 16,
             256, 256),
            ("serving, page size 8", 2, 7, 64, 8, 256, 517),
            ("serving, chunk 512", 2, 7, 64, 16, 512, 0),
            ("serving, chunk 512", 2, 7, 64, 16, 512, 512),
            ("serving, chunk 512, page size 32", 2, 7, 64, 32, 512, 0),
            ("verify panel, gamma 4", 2, 7, 64, 16, 5, 517),
            ("verify panel, page-aligned", 2, 7, 64, 16, 5, 512),
            ("one-token feed", 2, 7, 64, 16, 1, 517),
            ("reduced draft heads (hd 16, G 4), feed", 1, 4, 16, 16, 1, 77),
            ("reduced draft heads, catch-up", 1, 4, 16, 16, 13, 83)):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(k2_case(timer, gen, label, kv, g, hd, ps, c, q_start,
                                dtype))
    return rows


# ---------------------------------------------------------------------------
# Phase 3: full-width serving
# ---------------------------------------------------------------------------
N_REQ, PROMPT_LEN, PREFIX_LEN, NEW = 8, 512, 256, 32


def run_workload(eng, prompts, new=NEW):
    """The request mix on engine ``eng``, ``new`` tokens a request →
    (wall s, TTFTs, pages shared, streams)."""
    t0 = time.perf_counter()
    sids = [eng.submit(p, new) for p in prompts]
    ttft, shared = {}, 0
    while eng.step():
        now = time.perf_counter() - t0
        for r in list(eng.active) + list(eng.finished.values()):
            if r.tokens and r.seq_id not in ttft:
                ttft[r.seq_id] = now
        shared = max(shared, eng.pool.shared_page_stats()["shared_slots"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in eng.finished.values():
        ttft.setdefault(r.seq_id, wall)
    return wall, sorted(ttft.values()), shared, [eng.finished[s].tokens
                                                 for s in sids]


def serve(seed: int, qmode: str):
    """The serving path in ``qmode``; every kernel of that path must launch.
    → (measurements, engine factory, prompts)."""
    cfg = get_config("qwen2-0.5b", qmode=qmode)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = quantize_params(init_params(cfg, generator=gen, device="cuda"),
                             cfg, qmode)
    torch.cuda.synchronize()
    print(f"  init_params + quantize_params({qmode}): "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = torch.randint(0, cfg.vocab_size, (N_REQ, PROMPT_LEN),
                            generator=gen, device="cuda")
    prompts[1, :PREFIX_LEN] = prompts[0, :PREFIX_LEN]   # a shared prefix
    ps = kvc.DEFAULT_PAGE_SIZE

    def engine():
        # page 16 and chunk 256 pinned, as the engine ran before its
        # autotune, so the phase measures what it always measured (phase
        # 12 serves the tuned engine)
        return ContinuousBatchingEngine(
            params, cfg, kv_dtype="int8", page_size=ps, prefill_chunk=256,
            capacity_tokens=N_REQ * kvc.round_up(PROMPT_LEN + NEW, ps),
            device="cuda")

    warm = engine()                      # first-use costs (cuBLAS, caches)
    warm.submit(prompts[0, :40], 2)
    warm.run()
    torch.cuda.synchronize()
    reset_counts()
    wall, ttft, shared, out = run_workload(engine(), prompts)
    launches = {k: v for k, v in read_counts().items() if v}
    steps = sum(len(t) for t in out)
    print(f"  {qmode}: served {N_REQ} requests x {PROMPT_LEN} prompt + {NEW} "
          f"new tokens in {wall:.3f} s: {steps / wall:.1f} generated tok/s, "
          f"{N_REQ * (PROMPT_LEN + NEW) / wall:.1f} processed tok/s")
    print(f"  time to first token: first {ttft[0]:.3f} s, "
          f"median {ttft[N_REQ // 2]:.3f} s, last {ttft[-1]:.3f} s; pages "
          f"shared: {shared} (prefix {PREFIX_LEN} tokens = "
          f"{PREFIX_LEN // ps} pages)")
    print(f"  kernel launches during serving: {launches}")
    if set(launches) != set(PATHS[qmode]):
        raise RuntimeError(f"{qmode} serving launched {launches}; its path "
                           f"is {PATHS[qmode]}")
    if [len(t) for t in out] != [NEW] * N_REQ or not all(
            0 <= x < cfg.vocab_size for t in out for x in t):
        raise RuntimeError("generated tokens of the wrong count or range")
    if shared != PREFIX_LEN // ps:
        raise RuntimeError(f"expected {PREFIX_LEN // ps} shared pages, "
                           f"saw {shared}")

    profile = profile_serving(engine, prompts)
    in_situ = check_in_situ(engine, prompts[0], qmode)
    logit_checks = {"bfloat16": first_step_logits(params, cfg, prompts)}
    cfg32 = get_config("qwen2-0.5b", qmode=qmode, dtype="float32")
    params32 = quantize_params(init_params(
        cfg32, generator=torch.Generator(device="cuda").manual_seed(seed),
        device="cuda"), cfg32, qmode)
    logit_checks["float32"] = first_step_logits(params32, cfg32, prompts)
    del params32
    return (dict(launches=launches, wall_s=wall, gen_tok_s=steps / wall,
                 ttft_s=ttft, shared_pages=shared, in_situ=in_situ,
                 logits=logit_checks, profile=profile), engine, prompts)


def serve_in_turns(engines):
    """Generated tok/s of every mode's serving run again, in turns
    (w8a8, w4a8, w4a4, w4a4, w4a8, w8a8), so that host-side drift on the
    shared machine falls on all modes alike."""
    tok_s = {q: [] for q in engines}
    for q in list(engines) + list(reversed(list(engines))):
        engine, prompts = engines[q]
        wall, ttft, _, out = run_workload(engine(), prompts)
        tok_s[q].append(sum(len(t) for t in out) / wall)
        print(f"  {q}: {tok_s[q][-1]:.1f} generated tok/s, wall {wall:.3f} "
              f"s, TTFT first/median/last {ttft[0]:.3f}/"
              f"{ttft[N_REQ // 2]:.3f}/{ttft[-1]:.3f} s")
    return tok_s


def checked(key, kernel, plain, close, worst, calls):
    """``kernel`` wrapped so that every call is held against ``plain`` on
    the very same inputs (``close(got, want, kwargs)``); the largest
    difference goes to ``worst[key]`` and the calls to ``calls[key]``."""
    def call(*args, **kw):
        got = kernel(*args, **kw)
        kw.pop("pages_per_step", None)
        kw.pop("plan", None)
        want = plain(*args, **kw)
        err = max(max_err(a, b) for a, b in zip(
            *(x if isinstance(x, tuple) else (x,) for x in (got, want))))
        if not close(got, want, kw):
            raise RuntimeError(f"{key} in situ differs from its plain "
                               f"version by {err:.3g}")
        worst[key] = max(worst[key], err)
        calls[key] += 1
        return got
    return call


def gemm_in_situ(gemm, name, worst, calls):
    """The fused GEMM ``ops.<name>``, checked call by call (see
    :func:`checked`): exact, silu within one bf16 ULP."""
    return checked(gemm, getattr(ops, name), getattr(k1, name + "_ref"),
                   lambda got, want, kw: gemm_close(
                       got, want, kw.get("epilogue", "none")), worst, calls)


def exact(got, want, kw) -> bool:
    """Bit for bit (a tuple output: every member)."""
    return all(torch.equal(a, b) for a, b in zip(
        *(x if isinstance(x, tuple) else (x,) for x in (got, want))))


# the unfused kernels as a tensor-parallel MoE layer's down projection
# calls them (``moe._down_partial``): ops' name, the plain version
UNFUSED_IN_SITU = {"K7": ("quantize_rowwise_kernel", quantize_rowwise_ref),
                   "K5": ("camp_gemm_i8", k5.camp_gemm_i8_ref)}


def check_in_situ(engine, prompt, qmode, unfused=()):
    """Every kernel launch of one request (two prefill chunks, two decode
    steps) on the engine, held against its plain version on the very same
    inputs: the GEMM exact (silu: one bf16 ULP), K2/K3 within one bf16
    ULP; and each of ``unfused`` (keys of ``UNFUSED_IN_SITU``) exact."""
    gemm, name = FUSED[qmode]
    keys = (gemm, "K2", "K3", *unfused)
    worst = {key: 0.0 for key in keys}
    calls = {key: 0 for key in keys}

    def att_close(got, want, kw):
        return _att_ok(got.float(), want.float(), got.dtype)

    saved = (getattr(ops, name), k2.paged_prefill_cuda,
             k3.paged_attention_cuda)
    saved_unfused = {UNFUSED_IN_SITU[key][0]: getattr(
        ops, UNFUSED_IN_SITU[key][0]) for key in unfused}
    setattr(ops, name, gemm_in_situ(gemm, name, worst, calls))
    k2.paged_prefill_cuda = checked("K2", saved[1],
                                    k2.paged_prefill_reference, att_close,
                                    worst, calls)
    k3.paged_attention_cuda = checked("K3", saved[2],
                                      k3.paged_attention_reference, att_close,
                                      worst, calls)
    for key in unfused:
        attr, plain = UNFUSED_IN_SITU[key]
        setattr(ops, attr, checked(key, saved_unfused[attr], plain, exact,
                                   worst, calls))
    try:
        eng = engine()
        eng.submit(prompt, 3)
        eng.run()
    finally:
        setattr(ops, name, saved[0])
        k2.paged_prefill_cuda, k3.paged_attention_cuda = saved[1:]
        for attr, fn in saved_unfused.items():
            setattr(ops, attr, fn)
    print(f"  in situ, every kernel call vs its plain version on the same "
          f"inputs: calls {calls}, max |diff| {worst}")
    if not all(calls.values()):
        raise RuntimeError(f"in-situ check saw no call of a kernel: {calls}")
    return dict(calls=calls, max_abs_diff=worst)


def profile_serving(engine, prompts):
    """The same workload again under torch.profiler (see profile_run),
    the device's activity alone: with the host ops, a whole serving run's
    trace took the profiler ~80 s to process."""
    eng = engine()

    def run():
        for p in prompts:
            eng.submit(p, NEW)
        eng.run()
    return profile_run(run, host_ops=False)


def union_ms(spans):
    """Milliseconds covered by the union of (start, end) µs intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_run(fn, host_ops: bool = True, ranges=()):
    """``fn()`` under torch.profiler: device busy share of the wall time
    and the kernels that take the most device time. Busy time is the union
    of the device kernels' intervals: a programmatic dependent launch (the
    GEMMs' flush kernel) starts before its predecessor ends and waits
    inside it, so the sum of kernel times ("summed") counts that overlap
    twice. ``host_ops=False`` records the device's activity alone, which
    keeps a long run's trace small. ``ranges``: names of
    ``record_function`` ranges opened inside ``fn`` (host ops needed);
    the device ms of the kernels launched inside each come back under
    ``"ranges"``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # a record_function range also leaves a device-side span under its
    # name (first to last kernel, gaps included): not a kernel
    per_kernel, counts = {}, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0 and getattr(e, "device_type", None) is not None and \
                str(e.device_type).endswith("CUDA") and e.key not in ranges:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + t / 1e3
            counts[e.key] = counts.get(e.key, 0) + e.count
    summed = sum(per_kernel.values())
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA")
             and e.name not in ranges]
    busy = union_ms([(a, b) for a, b, _ in spans])
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    # K3's and K2's device kernels (the split attention and its merge) by
    # their tags in csrc/paged_common.cuh
    paged = {}
    for key, tag in (("K3", "Decode"), ("K2", "Prefill")):
        names = [n for n in per_kernel if tag in n
                 and ("attend_" in n or "combine_kernel" in n)]
        paged[key] = dict(ms=sum(per_kernel[n] for n in names),
                          device_kernels=sum(counts[n] for n in names))
    # the integer GEMMs' device kernels (csrc/camp_gemm_tc.cuh: product,
    # scale pass, flush)
    names = [n for n in per_kernel if "camp_gemm" in n]
    gemm = dict(ms=union_ms([(a, b) for a, b, n in spans
                             if "camp_gemm" in n]),
                summed_ms=sum(per_kernel[n] for n in names),
                device_kernels=sum(counts[n] for n in names))
    if busy == 0:
        print("  profiler: no device time recorded (not measured)")
    else:
        print(f"  profiled rerun: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy:.1f} ms ({busy / (wall * 1e3):.1%}; kernel times "
              f"summed {summed:.1f} ms); top kernels (ms):")
        for name, ms in top:
            print(f"    {ms:9.2f}  {name[:100]}")
        print("  paged attention: " + ", ".join(
            f"{k} {v['ms']:.2f} ms in {v['device_kernels']} device kernels"
            for k, v in paged.items()))
        print(f"  integer GEMMs: {gemm['ms']:.2f} ms busy (summed "
              f"{gemm['summed_ms']:.2f} ms) in {gemm['device_kernels']} "
              f"device kernels")
    # a range's host-side event totals the kernels launched inside it
    in_ranges = {name: 0.0 for name in ranges}
    for e in prof.events():
        if e.name in in_ranges and str(e.device_type).endswith("CPU"):
            in_ranges[e.name] += e.device_time_total / 1e3
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                device_summed_ms=summed,
                top=[[n, ms] for n, ms in top], paged=paged, gemm=gemm,
                ranges=in_ranges)


def prefill_last_logits(params, cfg, prompt, impl, mesh=None, opts=None):
    """``prompt`` prefilled in chunks of 256 over a fresh int8 pool →
    its last position's logits (f32). Under ``mesh`` (phase 13): this
    rank's shards and kv heads, inside a serve-mode mesh context with
    ``opts``."""
    ps = kvc.DEFAULT_PAGE_SIZE
    pool = kvc.PagePool(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.hd, num_pages=len(prompt) // ps + 1,
                        page_size=ps, quantized=True, mesh=mesh,
                        device=prompt.device)
    pool.reserve(0, len(prompt))
    scope = (contextlib.nullcontext() if mesh is None else mesh_context(
        mesh, make_rules("serve"), mode="serve", opts=opts,
        layout=params.layout))
    with scope:
        for start in range(0, len(prompt), 256):
            logits = paged_chunk_forward(
                params, cfg, pool, 0, prompt[start:start + 256], start,
                logits="last" if start + 256 >= len(prompt) else "none",
                impl=impl)
    return logits[0, -1].float()


def first_step_logits(params, cfg, prompts):
    """The first request's first-step logits (its prompt prefilled in two
    chunks of 256) through the kernels and through the plain versions, on
    the card; fails beyond ``LOGIT_TOL[cfg.qmode]`` × max |logit|.

    Two controls through the plain versions, printed beside the gap and
    gating nothing: the same prompt with the last bit of every weight of
    layer 0's input norm flipped, which moves every input of the first
    GEMMs by about one ULP (how far the model itself amplifies last-bit
    differences), and an unrelated prompt (how far apart a wrong result
    would be)."""
    rel_tol = LOGIT_TOL[cfg.qmode]

    def run(impl, p=params, prompt=prompts[0]):
        return prefill_last_logits(p, cfg, prompt, impl)

    got, want = run("auto"), run("torch")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError("non-finite logits")
    scale = want.abs().max().item()
    ln1 = params["layers"][0]["ln1"].clone()   # each value one ULP away
    bits = ln1.view({torch.bfloat16: torch.int16,
                     torch.float32: torch.int32}[ln1.dtype])
    bits ^= 1
    layers = [{**params["layers"][0], "ln1": ln1}] + params["layers"][1:]
    controls = {"last_bit": max_err(run("torch",
                                        {**params, "layers": layers}),
                                    want) / scale,
                "other_prompt": max_err(run("torch", prompt=prompts[2]),
                                        want) / scale}
    err = max_err(got, want)
    print(f"  first-step logits ({cfg.qmode}, {cfg.dtype}), kernels vs "
          f"plain: max |diff| {err:.4g} = {err / scale:.2%} of max |logit| "
          f"{scale:.4g} (limit {rel_tol:.0%}); argmax {got.argmax().item()} "
          f"vs {want.argmax().item()}; plain vs plain with the last bit of "
          f"layer 0's norm weights flipped {controls['last_bit']:.2%}, vs an "
          f"unrelated prompt {controls['other_prompt']:.2%}")
    if err > rel_tol * scale:
        raise RuntimeError(f"{cfg.qmode} {cfg.dtype} kernel logits differ "
                           f"from the plain versions by more than "
                           f"{rel_tol:.0%} of max |logit|")
    return dict(max_abs_diff=err, max_abs_logit=scale, rel_tol=rel_tol,
                controls=controls)


# ---------------------------------------------------------------------------
# Phase 4: the unfused path
# ---------------------------------------------------------------------------
# the epilogue each serving shape carries on the model path
SHAPE_EPILOGUE = {(8, 896, 4864): "silu", (8, 896, 896): "none",
                  (8, 896, 128): "bias", (8, 4864, 896): "none",
                  (256, 896, 4864): "silu", (256, 4864, 896): "none"}


def unfused_path(timer, gen):
    """``camp_matmul(fused=False)`` in every integer mode at the serving
    shapes: K7, then K5 (w8a8), K6a (w4a8) or K6b (w4a4) must each launch,
    and every output must equal ``camp_matmul(fused=True)`` bit for bit
    (the reference's claim, tests/test_fused_gemm.py) and the plain
    versions (exactly; silu within one bf16 ULP)."""
    cases = []
    for (m, k, n), epi in SHAPE_EPILOGUE.items():
        w = torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        bias = (torch.randn(n, device="cuda", generator=gen)
                .to(torch.bfloat16) if epi == "bias" else None)
        for qmode in QMODES:
            cases.append((qmode, x, camp.prepare_weight(w, qmode),
                          dict(epilogue=epi, bias=bias)))
    torch.cuda.synchronize()
    reset_counts()
    outs = [camp.camp_matmul(x, w, qmode=q, fused=False, **kw)
            for q, x, w, kw in cases]
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    print(f"  kernel launches on the unfused path: {launches}")
    if set(launches) != set(PATHS["unfused"]):
        raise RuntimeError(f"the unfused path launched {launches}; its "
                           f"kernels are {PATHS['unfused']}")
    rows = []
    for (q, x, w, kw), y in zip(cases, outs):
        fused = camp.camp_matmul(x, w, qmode=q, **kw)
        plain = camp.camp_matmul(x, w, qmode=q, fused=False, impl="torch",
                                 **kw)
        torch.cuda.synchronize()
        ok = torch.equal(y, fused) and gemm_close(y, plain, kw["epilogue"])
        (m, k), n = x.shape, w.shape[1]
        row = dict(qmode=q, m=m, k=k, n=n, epilogue=kw["epilogue"], ok=ok,
                   max_abs_err_fused=max_err(y, fused),
                   max_abs_err_plain=max_err(y, plain),
                   fused_ms=timer(lambda: camp.camp_matmul(x, w, qmode=q,
                                                           **kw)),
                   unfused_ms=timer(lambda: camp.camp_matmul(
                       x, w, qmode=q, fused=False, **kw)))
        rows.append(row)
        print(f"  {q} M={m:3d} K={k:4d} N={n:4d} {kw['epilogue']:4s} unfused "
              f"== fused {'ok' if ok else 'FAIL'} (vs plain "
              f"{row['max_abs_err_plain']:.3g}); fused {row['fused_ms']:.4f}"
              f" ms, unfused {row['unfused_ms']:.4f} ms")
    if not all(r["ok"] for r in rows):
        raise RuntimeError("the unfused path differs from the fused path "
                           "or from the plain versions")
    return dict(launches=launches, rows=rows)


# ---------------------------------------------------------------------------
# Phase 5: K8, dense flash attention
# ---------------------------------------------------------------------------
def _k8_shapes():
    """(label, heads, kv heads, S, D, dtype, causal): the model shapes at
    batch 1 (BH = the arch's query heads, kv heads repeated), stablelm-12b's
    hd 160 among them; then the reference test's head dims
    (tests/test_kernels.py:148), which take the kernel's 16- and 32-wide
    builds, and hd 256, each at an S that leaves a ragged last tile
    (1000 = 15 * 64 + 40; 777 = 12 * 64 + 9)."""
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = []
    for label, arch, s, dtype, causal in (
            ("serving prompt", "qwen2-0.5b", 512, bf16, True),
            ("", "qwen2-0.5b", 4096, bf16, True),
            ("prefill_32k", "qwen2-0.5b", 32768, bf16, True),
            ("", "qwen2-0.5b", 4096, f32, True),
            ("non-causal", "qwen2-0.5b", 4096, bf16, False),
            ("", "qwen3-0.6b", 4096, bf16, True),
            ("", "stablelm-12b", 4096, bf16, True),
            ("", "stablelm-12b", 4096, f32, True)):
        cfg = get_config(arch)
        shapes.append((f"{arch} {label}".strip(), cfg.n_heads,
                       cfg.n_kv_heads, s, cfg.hd, dtype, causal))
    for bh, s, d in ((1, 777, 8), (4, 1000, 16), (2, 1000, 32),
                     (2, 1000, 256)):
        for dtype in (bf16, f32):
            for causal in (True, False):
                shapes.append(("ragged", bh, bh, s, d, dtype, causal))
    return tuple(shapes)


K8_SHAPES = _k8_shapes()
# K8 against its plain version, elementwise.
# * f32: rtol = atol = 2e-5, the reference's own (tests/test_kernels.py:162).
# * bf16: a bound derived per element, |kernel - plain| <= one bf16 ULP of
#   the larger magnitude + 2u * (sum_j p_j |v_j|) / l, u = 2^-8 (bf16's
#   unit roundoff). Both sides compute o = sum_j p_j v_j / l with every p_j
#   rounded to bf16 before the PV product, each at its own running maximum
#   (the kernel's 64- or 128-column tiles, the plain version's blocks), so
#   one side's p_j and the other's differ by at most 2u p_j (relative error
#   <= u each), which moves o by at most 2u * sum_j p_j |v_j| / l; the
#   output then rounds once more to bf16 (the ULP). sum_j p_j |v_j| / l is
#   the plain version run on |v| in f32 (``k8_p_bound``). It replaces a
#   fitted atol (2e-3, one seed's worst case) that other inputs exceeded.
# Beside it, at every bf16 shape: 64 rows of up to three heads in f64, and
# the kernel no farther from them (root-mean-square) than twice the plain
# version is. A control proves the checks can see a fault: the same rows
# with one 64-column kv tile dropped for the late rows must fail one of
# them (at long S the elementwise bound grows with E|v| while one dropped
# tile moves an output by ~64/S of it, so there the RMS check catches it).
# Over every element, at every bf16 shape: each head's RMS distance
# between the kernel and the plain version within K8_ALL_RMS times the
# plain version's own RMS distance to f64 (the sampled rows). By the
# triangle inequality RMS(kernel - plain) <= RMS(kernel - f64) +
# RMS(plain - f64), which is at most (2 + 1) times the plain version's
# when the kernel meets the f64 check; taken per head, so a fault in one
# head cannot hide among the others. Its control drops the same kv tile
# in one whole head outside the sampled ones and must fail it.
K8_F32_TOL = 2e-5
K8_P_ROUND = 2.0 ** -8
K8_ALL_RMS = 3.0


def k8_inputs(gen, heads, kv_heads, s, d, dtype):
    """q (heads, S, D) and k, v with kv_heads repeated to heads."""
    def randn(n):
        return torch.randn(n, s, d, device="cuda", generator=gen)
    q = randn(heads).to(dtype)
    k, v = (randn(kv_heads).repeat_interleave(heads // kv_heads, dim=0)
            .to(dtype) for _ in range(2))
    return q, k, v


def k8_p_bound(q, k, v, causal):
    """2u * sum_j p_j |v_j| / l per output element (bf16 inputs): the
    plain version on f32 copies with |v|."""
    return 2 * K8_P_ROUND * k8.flash_attention_reference(
        q.float(), k.float(), v.float().abs(), causal=causal)


def k8_excess(got, want, p_bound) -> torch.Tensor:
    """|got - want| over the bf16 bound, elementwise (≤ 1 passes)."""
    a, b = got.float(), want.float()
    return (a - b).abs() / (BF16_ULP_REL * torch.maximum(a.abs(), b.abs())
                            + p_bound)


def k8_close(got, want, p_bound=None) -> bool:
    """Within K8's elementwise limit (f32: 2e-5; bf16: the derived bound,
    ``p_bound`` from :func:`k8_p_bound`)."""
    if got.dtype == torch.float32:
        return bool(((got - want).abs()
                     <= K8_F32_TOL + K8_F32_TOL * want.abs()).all())
    return bool((k8_excess(got, want, p_bound) <= 1).all())


def f64_rows(q, k, v, causal, heads, rows, drop=None):
    """Attention of the given rows of the given heads, in f64; ``drop``
    (first column, last row excluded): leave the 64 kv columns from that
    column out for the rows from S / 2 on, as a kernel that skipped one
    kv tile would."""
    scale = q.shape[-1] ** -0.5
    cols = torch.arange(k.shape[1], device=q.device)
    mask = torch.zeros(len(rows), k.shape[1], dtype=torch.bool,
                       device=q.device)
    if causal:
        mask |= cols[None, :] > rows[:, None]
    if drop is not None:
        mask |= ((rows[:, None] >= k.shape[1] // 2)
                 & (cols[None, :] >= drop) & (cols[None, :] < drop + 64))
    out = []
    for h in heads:
        s = (q[h, rows].double() @ k[h].double().T) * scale
        out.append(torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
                   @ v[h].double())
    return torch.stack(out)


def f64_head(q, k, v, causal, h, drop=None):
    """Every row of head ``h`` as :func:`f64_rows` computes them, in
    chunks of rows whose f64 scores take 512 MB."""
    s = q.shape[1]
    step = max(1, (1 << 26) // s)
    return torch.cat([f64_rows(q, k, v, causal, [h], torch.arange(
        r, min(r + step, s), device=q.device), drop)[0]
        for r in range(0, s, step)])


def rms(x) -> float:
    return x.double().pow(2).mean().sqrt().item()


def head_rms(a, b) -> torch.Tensor:
    """RMS(a - b) of each head (dim 0)."""
    return (a.double() - b.double()).pow(2).mean(dim=(1, 2)).sqrt()


def check_k8(gen):
    """K8 through its entry point at every shape (the launches counted),
    then each output against the plain version, every head's RMS distance
    to it and f64 rows, the dropped-tile controls, times, bound,
    yardstick."""
    cases = [(label, s, dtype, causal,
              *k8_inputs(gen, heads, kv, s, d, dtype))
             for label, heads, kv, s, d, dtype, causal in K8_SHAPES]
    torch.cuda.synchronize()
    reset_counts()
    outs = [k8.flash_attention(q, k, v, causal=causal)
            for _, _, _, causal, q, k, v in cases]
    torch.cuda.synchronize()
    launches = {key: n for key, n in read_counts().items() if n}
    print(f"  kernel launches through flash_attention: {launches}")
    if launches != {"K8": len(cases)}:
        raise RuntimeError(f"flash_attention launched {launches}, expected "
                           f"K8 once per shape ({len(cases)})")
    rows = []
    for (label, s, dtype, causal, q, k, v), got in zip(cases, outs):
        bh, _, d = q.shape
        long = s > 4096
        bf16 = dtype == torch.bfloat16
        want = k8.flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = max_err(got, want)
        p_bound = k8_p_bound(q, k, v, causal) if bf16 else None
        elem_ok = k8_close(got, want, p_bound)
        share = k8_excess(got, want, p_bound).max().item() if bf16 else None
        # 64 rows of up to three heads against f64, and the control
        r = torch.linspace(0, s - 1, 64, device="cuda").long()
        heads = sorted({0, bh // 2, bh - 1})
        exact = f64_rows(q, k, v, causal, heads, r)
        fault = f64_rows(q, k, v, causal, heads, r, drop=64).to(dtype)
        g_rows, w_rows = got[heads][:, r], want[heads][:, r]
        b_rows = p_bound[heads][:, r] if bf16 else None
        f64 = dict(kernel=rms(g_rows.double() - exact),
                   plain=rms(w_rows.double() - exact),
                   kernel_max=max_err(g_rows.double(), exact),
                   plain_max=max_err(w_rows.double(), exact),
                   control=rms(fault.double() - exact))
        rms_ok = not bf16 or f64["kernel"] <= 2 * f64["plain"]
        # every element: each head's RMS distance to the plain version
        all_lim = K8_ALL_RMS * f64["plain"]
        all_rms = head_rms(got, want).max().item() if bf16 else None
        all_ok = not bf16 or all_rms <= all_lim
        control = dict(elementwise=k8_close(fault, w_rows, b_rows),
                       rms=not bf16 or f64["control"] <= 2 * f64["plain"],
                       all=True, max_abs_err=max_err(fault, w_rows),
                       share=(k8_excess(fault, w_rows, b_rows).max().item()
                              if bf16 else None))
        if bf16:            # the same tile dropped in one whole head
            h = min(1, bh - 1)
            bad = want.clone()
            bad[h] = f64_head(q, k, v, causal, h, drop=64).to(dtype)
            control["head"] = h
            control["all_rms"] = head_rms(bad, want).max().item()
            control["all"] = control["all_rms"] <= all_lim
            del bad
            if control["all"]:
                raise RuntimeError(f"K8 {label} S={s}: the every-element "
                                   f"check passes a dropped kv tile in "
                                   f"head {h}: {control}")
        if control["elementwise"] and control["rms"] and control["all"]:
            raise RuntimeError(f"K8 {label} S={s}: the check passes a "
                               f"dropped kv tile: {control}")
        control["caught_by"] = "+".join(
            k for k in ("elementwise", "rms", "all") if not control[k])
        pairs = s * (s + 1) // 2 if causal else s * s
        b_ms, b_by = bound(4 * nbytes(q), 4.0 * bh * d * pairs,
                           BF16_OPS_PER_S if bf16 else F32_OPS_PER_S)
        q4, k4, v4 = q[None], k[None], v[None]
        timer = Timer(iters=3 if long else 20)
        row = dict(kernel="K8", label=label, bh=bh, s=s, d=d,
                   dtype=str(dtype), causal=causal, max_abs_err=err,
                   tol=(dict(ulp=1, p_round=2 * K8_P_ROUND) if bf16
                        else dict(atol=K8_F32_TOL, rtol=K8_F32_TOL)),
                   bound_share=share,
                   p_bound_max=p_bound.max().item() if bf16 else None,
                   all_rms=all_rms, all_rms_limit=all_lim if bf16 else None,
                   ok=elem_ok and rms_ok and all_ok, f64=f64,
                   control=control,
                   ms=timer(lambda: k8.flash_attention_cuda(
                       q, k, v, causal=causal)),
                   plain_ms=Timer(iters=1 if long else 5)(
                       lambda: k8.flash_attention_reference(
                           q, k, v, causal=causal)),
                   library_ms=timer(lambda: F.scaled_dot_product_attention(
                       q4, k4, v4, is_causal=causal)),
                   bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        lim = (f"1 ULP + 2u·Σp|v|/l (≤ {row['p_bound_max']:.3g}), "
               f"{share:.3f} of it used" if bf16 else f"{K8_F32_TOL:g}")
        every = (f"; every head's rms to plain ≤ {all_rms:.3g} "
                 f"(limit {all_lim:.3g})" if bf16 else "")
        ctl = (f"control max {control['max_abs_err']:.3g}"
               + (f" ({control['share']:.3g} of the bound), rms "
                  f"{f64['control']:.3g}, head {control['head']} whole rms "
                  f"{control['all_rms']:.3g}" if bf16 else "")
               + f" caught by {control['caught_by']}")
        print(f"  K8 BH={bh} S={s} D={d} {str(dtype)[6:]} "
              f"{'causal' if causal else 'non-causal'} {label}: err={err:.3g}"
              f" ({lim}) {'ok' if row['ok'] else 'FAIL'}; f64 rms kernel "
              f"{f64['kernel']:.3g} plain {f64['plain']:.3g}, max kernel "
              f"{f64['kernel_max']:.3g} plain {f64['plain_max']:.3g}{every};"
              f" {ctl}; "
              f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
              f"sdpa={row['library_ms']:.4f} bound={b_ms:.4f} ({b_by}), "
              f"{b_ms / row['ms']:.1%} of the bound, "
              f"{row['ms'] / row['library_ms']:.2f}x SDPA")
        del want, p_bound
    return dict(launches=launches, rows=rows)


# ---------------------------------------------------------------------------
# Phase 6: dense-slab serving
# ---------------------------------------------------------------------------
def dense_serving(seed: int):
    """Full-width qwen2-0.5b W8A8 through the dense-slab loop (bf16 and int8
    slabs) and through ``generate``'s default float pages."""
    cfg = get_config("qwen2-0.5b", qmode="w8a8")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = quantize_params(init_params(cfg, generator=gen, device="cuda"),
                             cfg, "w8a8")
    prompts = torch.randint(0, cfg.vocab_size, (N_REQ, PROMPT_LEN),
                            generator=gen, device="cuda")
    ps = kvc.DEFAULT_PAGE_SIZE
    per_forward = 7 * cfg.n_layers           # q, k, v, o, gate, up, down

    def dense(kv_dtype):
        return lambda: _generate_dense(params, cfg, prompts, steps=NEW,
                                       kv_dtype=kv_dtype, device="cuda")
    runs = {"dense bf16 slab": dense(None), "dense int8 slab": dense("int8"),
            "float pages": lambda: generate(params, cfg, prompts, steps=NEW,
                                            prefill_chunk=256,
                                            device="cuda")}
    dense(None)()                            # first-use costs
    torch.cuda.synchronize()
    result = {}
    for name, run in runs.items():
        reset_counts()
        t0 = time.perf_counter()
        toks = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in read_counts().items() if n}
        path = "float pages" if name == "float pages" else "dense"
        print(f"  {name}: {N_REQ} x ({PROMPT_LEN} + {NEW}) tokens in "
              f"{wall:.3f} s, {N_REQ * NEW / wall:.1f} generated tok/s; "
              f"kernel launches {launches}")
        if set(launches) != set(PATHS[path]) or launches["K1"] % per_forward:
            raise RuntimeError(f"{name} launched {launches}; its path is "
                               f"{PATHS[path]}, K1 {per_forward} a forward")
        if path == "dense" and launches["K1"] != per_forward * NEW:
            raise RuntimeError(f"{name}: {launches['K1']} K1 launches for "
                               f"{NEW} forwards")
        if path == "float pages":
            print("  K2 and K3 were not launched: float pages take the plain "
                  "attention versions, as in the reference, whose Pallas "
                  "kernels read int8 pages only")
        if tuple(toks.shape) != (N_REQ, NEW) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise RuntimeError(f"{name}: tokens of the wrong shape or range")
        result[name] = dict(launches=launches, wall_s=wall,
                            gen_tok_s=N_REQ * NEW / wall, tokens=toks.tolist())
    for name in ("dense bf16 slab", "float pages"):
        print(f"  profiled rerun, {name}:")
        result[name]["profile"] = profile_run(runs[name], host_ops=False)
    agree = (torch.tensor(result["dense bf16 slab"]["tokens"])
             == torch.tensor(result["float pages"]["tokens"])).float().mean()
    print(f"  greedy tokens equal between the bf16 slab and float pages: "
          f"{agree.item():.1%}")

    # every K1 call of the dense prefill (M = 4,096 rows) and of one decode
    # step (M = 8) against K1's plain version on the same inputs; then the
    # first-step logits: through the kernels vs the plain versions (all 8
    # prompts), and the bf16 slab vs the float-page engine's chunked
    # prefill (prompt 0)
    def dense_first(impl):
        caches = init_serve_caches(cfg, N_REQ, PROMPT_LEN + NEW,
                                   device="cuda")
        last, caches = build_prefill_step(cfg, impl=impl)(params, prompts,
                                                          caches)
        build_decode_step(cfg, impl=impl)(
            params, caches, last.float().argmax(-1)[:, None], PROMPT_LEN)
        return last.float()
    worst, calls = {"K1": 0.0}, {"K1": 0}
    saved = ops.camp_gemm_fused_w8a8
    ops.camp_gemm_fused_w8a8 = gemm_in_situ("K1", "camp_gemm_fused_w8a8",
                                            worst, calls)
    try:
        got = dense_first("auto")
    finally:
        ops.camp_gemm_fused_w8a8 = saved
    print(f"  in situ, every K1 call of the dense prefill and one decode "
          f"step vs its plain version on the same inputs: {calls['K1']} "
          f"calls, max |diff| {worst['K1']:.3g}")
    if calls["K1"] != 2 * per_forward:
        raise RuntimeError(f"in situ: {calls['K1']} K1 calls, expected "
                           f"{2 * per_forward}")
    want = dense_first("torch")
    pool = kvc.PagePool(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.hd, num_pages=PROMPT_LEN // ps + 1,
                        page_size=ps, quantized=False, dtype=torch.bfloat16,
                        device="cuda")
    pool.reserve(0, PROMPT_LEN)
    for start in range(0, PROMPT_LEN, 256):
        paged = paged_chunk_forward(
            params, cfg, pool, 0, prompts[0, start:start + 256], start,
            logits="last" if start + 256 >= PROMPT_LEN else "none")
    paged = paged[0, -1].float()
    if not all(torch.isfinite(x).all() for x in (got, want, paged)):
        raise RuntimeError("non-finite dense-path logits")
    rel_tol = LOGIT_TOL["w8a8"]
    gaps = {"kernels vs plain": max_err(got, want) / want.abs().max().item(),
            "bf16 slab vs float pages": max_err(got[0], paged)
            / paged.abs().max().item()}
    print("  first-step logits, as a share of max |logit| (limit "
          f"{rel_tol:.0%}): " + ", ".join(f"{k} {v:.2%}" for k, v in gaps.items())
          + f"; argmax equal {(got.argmax(-1) == want.argmax(-1)).sum().item()}"
          f"/{N_REQ} (kernels vs plain), "
          f"{int(got[0].argmax() == paged.argmax())}/1 (slab vs pages); "
          f"kernels vs plain bit for bit: {torch.equal(got, want)}")
    if max(gaps.values()) > rel_tol:
        raise RuntimeError(f"dense-path logit gap beyond {rel_tol:.0%}: {gaps}")

    def engine_turn():           # generate()'s engine, stepped for TTFT
        return run_workload(ContinuousBatchingEngine(
            params, cfg, kv_dtype=None, page_size=ps, prefill_chunk=256,
            capacity_tokens=N_REQ * kvc.round_up(PROMPT_LEN + NEW, ps),
            device="cuda"), prompts)

    def dense_turn(kv_dtype):    # TTFT: the batch's prefill, then the loop
        t0 = time.perf_counter()
        caches = init_serve_caches(cfg, N_REQ, PROMPT_LEN + NEW,
                                   kv_dtype=kv_dtype, device="cuda")
        build_prefill_step(cfg)(params, prompts, caches)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense(kv_dtype)()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, [ttft] * N_REQ
    turns = {"dense bf16 slab": lambda: dense_turn(None),
             "dense int8 slab": lambda: dense_turn("int8"),
             "float pages": lambda: engine_turn()[:2]}
    in_turns = {k: [] for k in turns}
    for name in list(turns) + list(reversed(list(turns))):
        wall, ttft = turns[name]()
        in_turns[name].append(dict(gen_tok_s=N_REQ * NEW / wall,
                                   ttft_s=sorted(ttft)))
        print(f"  in turns, {name}: {N_REQ * NEW / wall:.1f} generated tok/s, "
              f"TTFT first/median/last {min(ttft):.3f}/"
              f"{sorted(ttft)[N_REQ // 2]:.3f}/{max(ttft):.3f} s")
    for r in result.values():
        del r["tokens"]
    return dict(runs=result, greedy_agreement=agree.item(), logit_gaps=gaps,
                logits_equal=torch.equal(got, want), rel_tol=rel_tol,
                in_situ=dict(calls=calls, max_abs_diff=worst),
                in_turns=in_turns)


# ---------------------------------------------------------------------------
# Phase 7: stablelm-12b's attention shape on the paged engine
# ---------------------------------------------------------------------------
STABLELM_LAYERS = 4      # of its 40: full width, depth cut to fit the run
STABLELM_REQ, STABLELM_PROMPT, STABLELM_NEW = 4, 300, 8


def int8_weight_bytes(tree) -> int:
    """Bytes of the quantized weight payloads in a parameter tree."""
    if isinstance(tree, dict):
        return sum(int8_weight_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(int8_weight_bytes(v) for v in tree)
    if isinstance(tree, QuantizedTensor):
        return tree.q.numel() * tree.q.element_size()
    return 0


def serve_stablelm(seed: int):
    """stablelm-12b (configs/stablelm_12b.py: hd 160, 32 query / 8 kv heads,
    d 5120, d_ff 13824, vocab 100352) at full width with its depth cut to
    ``STABLELM_LAYERS`` of 40 layers, W8A8 on the continuous-batching
    engine over int8 pages: 4 requests of 300 prompt tokens (chunks of 256
    and 44) and 8 new tokens each. K1, K2 and K3 must launch, and every
    kernel call of one request is held against its plain version in
    situ."""
    cfg = get_config("stablelm-12b", qmode="w8a8", n_layers=STABLELM_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = quantize_params(init_params(cfg, generator=gen, device="cuda"),
                             cfg, "w8a8")
    int8_bytes = int8_weight_bytes(params["layers"])
    print(f"  stablelm-12b, {cfg.n_layers} of 40 layers at full width: int8 "
          f"weight bytes {int8_bytes:,} ({int8_bytes / cfg.n_layers:,.0f} "
          f"a layer)")
    prompts = torch.randint(0, cfg.vocab_size,
                            (STABLELM_REQ, STABLELM_PROMPT), generator=gen,
                            device="cuda")
    ps = kvc.DEFAULT_PAGE_SIZE

    def engine():
        return ContinuousBatchingEngine(
            params, cfg, kv_dtype="int8", page_size=ps, prefill_chunk=256,
            capacity_tokens=STABLELM_REQ * kvc.round_up(
                STABLELM_PROMPT + STABLELM_NEW, ps),
            device="cuda")

    warm = engine()
    warm.submit(prompts[0, :40], 2)
    warm.run()
    torch.cuda.synchronize()
    reset_counts()
    eng = engine()
    t0 = time.perf_counter()
    sids = [eng.submit(p, STABLELM_NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    out = [eng.finished[s].tokens for s in sids]
    print(f"  served {STABLELM_REQ} requests x {STABLELM_PROMPT} prompt + "
          f"{STABLELM_NEW} new tokens in {wall:.3f} s; kernel launches "
          f"{launches}")
    if set(launches) != set(PATHS["w8a8"]):
        raise RuntimeError(f"stablelm-12b launched {launches}; its path is "
                           f"{PATHS['w8a8']}")
    if [len(t) for t in out] != [STABLELM_NEW] * STABLELM_REQ or not all(
            0 <= x < cfg.vocab_size for t in out for x in t):
        raise RuntimeError("stablelm-12b: tokens of the wrong count or range")
    in_situ = check_in_situ(engine, prompts[0], "w8a8")
    return dict(layers=cfg.n_layers, int8_weight_bytes=int8_bytes,
                launches=launches, wall_s=wall, in_situ=in_situ)


# ---------------------------------------------------------------------------
# Phase 8: speculative decoding on the paged engine
# ---------------------------------------------------------------------------
SPEC_GAMMA = 4
# (a): the reference benchmark's speculative shape (benchmarks/
# decode_serving.py): an 8-token pattern tiled 8x, 48 new tokens
SPEC_PATTERN, SPEC_REPEATS, SPEC_NEW = 8, 8, 48
# (b): phase 3's mix, each prompt a 64-token span repeated
SPEC_SPAN = 64
SPEC_TEMPERATURE = 0.9
SITU_NEW = 8             # new tokens of the in-situ request
SPEC_PROFILE_STEPS = 2   # engine steps of (b) profiled, after its prefill
#                          (4 took 37.3 s, mostly the trace's parse, with
#                          28 verify forwards in the window)
# Greedy parity between the speculative and the plain engine. A verify
# panel reads K2 where plain decoding reads K3, and their float orders
# differ, so one context's logits differ a little between the two engines,
# and a near-tie can flip an argmax. At the first position where two
# streams differ, the speculative token's logit in the plain engine's row
# must lie within one bf16 ULP of that row's maximum, |max| * 2^-7 (its
# top-2 gap is then within it too): the logits are bf16, so that is the
# least by which two roundings can differ. Measured (H100, this seed, runs
# (a)-(e)): the two engines' rows of one context agree bit for bit (K2 and
# K3 are one template, csrc/paged_common.cuh), while the accept-all
# control's first speculative token lies 2.198 below its row's maximum.
SPEC_FLIP_ULPS = 1


def spec_prompts(gen, vocab):
    """(a)'s prompt (1, 64) and (b)'s (8, 512), two of them sharing a
    256-token prefix."""
    a = torch.randint(0, vocab, (SPEC_PATTERN,), generator=gen,
                      device="cuda").repeat(SPEC_REPEATS)[None]
    spans = torch.randint(0, vocab, (N_REQ, SPEC_SPAN), generator=gen,
                          device="cuda")
    b = spans.repeat(1, PROMPT_LEN // SPEC_SPAN)
    b[1, :PREFIX_LEN] = b[0, :PREFIX_LEN]
    return a, b


def spec_engine(params, cfg, prompts, new, spec=None, **kw):
    n, s = prompts.shape
    ps = kvc.DEFAULT_PAGE_SIZE
    return ContinuousBatchingEngine(
        params, cfg, kv_dtype="int8", page_size=ps, prefill_chunk=256,
        capacity_tokens=n * kvc.round_up(s + new, ps), spec=spec,
        device="cuda", **kw)


def record_rows(eng):
    """Keep, on the host, the logits row that chose each token of ``eng``:
    rows[(seq_id, token index)] (V,) f32. A verify step writes every row
    of its panel; a row whose context holds a rejected draft is written
    over by the step that emits that index."""
    rows = {}
    sample, verify = eng._sample_tokens, eng._spec_verify

    def sample_tokens(logits, reqs):
        for row, r in zip(logits.float().cpu().numpy(), reqs):
            rows[(r.seq_id, len(r.tokens))] = row
        return sample(logits, reqs)

    def spec_verify(req, draft):
        out = verify(req, draft)
        for i, row in enumerate(out):
            rows[(req.seq_id, len(req.tokens) + i)] = row
        return out
    eng._sample_tokens, eng._spec_verify = sample_tokens, spec_verify
    return rows


def check_pools(eng):
    """Every page of the target's pool and the draft's free again, the
    allocator's invariants holding."""
    pools = [eng.pool]
    if getattr(eng.drafter, "pool", None) is not None:
        pools.append(eng.drafter.pool)
    for pool in pools:
        pool.check_invariants()
        if pool.num_free != pool.num_pages or pool.tables:
            raise RuntimeError(f"pool holds {pool.num_pages - pool.num_free} "
                               f"pages after the run")


def spec_run(make, prompts, new, rows=False):
    """Serve ``prompts`` on a fresh engine from ``make()``; every forward's
    layers are counted so the kernels' launches can be held to them.
    → dict(streams, wall_s, launches, forward_layers, rows, summary)."""
    eng = make()
    recorded = record_rows(eng) if rows else None
    layers = {"n": 0}
    inner = sd.paged_chunk_forward

    def counted(params, cfg, *a, **kw):
        layers["n"] += cfg.n_layers
        return inner(params, cfg, *a, **kw)
    sd.paged_chunk_forward = counted
    reset_counts()
    try:
        t0 = time.perf_counter()
        sids = [eng.submit(p, new) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sd.paged_chunk_forward = inner
    launches = {k: v for k, v in read_counts().items() if v}
    check_pools(eng)
    streams = [eng.finished[s].tokens for s in sids]
    if [len(t) for t in streams] != [new] * len(prompts):
        raise RuntimeError("generated tokens of the wrong count")
    return dict(streams=streams, wall_s=wall, launches=launches,
                forward_layers=layers["n"], rows=recorded,
                summary=eng.spec_summary() if eng.drafter else None,
                engine=eng)


def check_spec_launches(label, run, gemm):
    """A speculative run launches the qmode's GEMM 7 times and K2 once a
    layer of every forward (target and draft alike, so no call took a plain
    version), and K3 never."""
    n, got = run["forward_layers"], run["launches"]
    want = {gemm: 7 * n, "K2": n}
    print(f"  {label}: kernel launches {got} (forward layers {n})")
    if got != want:
        raise RuntimeError(f"{label} launched {got}; expected {want} and no "
                           f"K3")


def greedy_parity(label, spec, base, ulps=SPEC_FLIP_ULPS):
    """First divergence of each speculative stream from the plain one: its
    index, the plain row's top-2 gap and the speculative token's deficit
    (the plain row's max minus its logit there), held to ``ulps`` bf16
    ULPs of the row's max; and the largest |diff| of the two engines' rows
    of one context (indices up to the first divergence).
    → (divergences, row max |diff|, ok)."""
    divs, row_diff = [], 0.0
    for i, (s, b) in enumerate(zip(spec["streams"], base["streams"])):
        n = next((t for t, (x, y) in enumerate(zip(s, b)) if x != y), None)
        for t in range(len(s) if n is None else n + 1):
            row_diff = max(row_diff, float(np.abs(
                spec["rows"][(i, t)] - base["rows"][(i, t)]).max()))
        if n is not None:
            row = base["rows"][(i, n)]
            top2 = np.sort(row)[-2:]
            divs.append(dict(request=i, index=n,
                             gap=float(top2[1] - top2[0]),
                             deficit=float(row.max() - row[s[n]]),
                             limit=ulps * BF16_ULP_REL * abs(float(top2[1]))))
    ok = all(d["deficit"] <= d["limit"] for d in divs)
    print(f"  {label}: greedy parity {'holds' if ok else 'FAILS'}: "
          f"{len(divs)} of {len(spec['streams'])} streams differ "
          + "".join(f"[request {d['request']} at {d['index']}: top-2 gap "
                    f"{d['gap']:.4g}, token {d['deficit']:.4g} below the "
                    f"max, limit {d['limit']:.4g}] " for d in divs)
          + f"; rows of one context differ by at most {row_diff:.4g}")
    return divs, row_diff, ok


def spec_in_situ(params, cfg, spec, prompt):
    """Every K1 and K2 call of one speculative request (verify panels at
    C = gamma + 1 from any q_start, the draft's catch-up chunks and C = 1
    feeds) held against its plain version on the same inputs."""
    gemm, name = FUSED[cfg.qmode]
    worst = {gemm: 0.0, "K2": 0.0}
    calls = {gemm: 0, "K2": 0}
    shapes = []
    saved = (getattr(ops, name), k2.paged_prefill_cuda)

    def k2_recorded(q, *a, **kw):
        shapes.append((q.shape[1], kw["q_start"]))
        return saved[1](q, *a, **kw)

    def att_close(got, want, kw):
        return _att_ok(got.float(), want.float(), got.dtype)
    setattr(ops, name, gemm_in_situ(gemm, name, worst, calls))
    k2.paged_prefill_cuda = checked("K2", k2_recorded,
                                    k2.paged_prefill_reference, att_close,
                                    worst, calls)
    try:
        run = spec_run(lambda: spec_engine(params, cfg, prompt, SITU_NEW,
                                           spec), prompt, SITU_NEW)
    finally:
        setattr(ops, name, saved[0])
        k2.paged_prefill_cuda = saved[1]
    ps = kvc.DEFAULT_PAGE_SIZE
    panels = [(c, q) for c, q in shapes if c == SPEC_GAMMA + 1 and q % ps]
    feeds = [(c, q) for c, q in shapes if c == 1]
    print(f"  in situ, one speculative request: calls {calls}, max |diff| "
          f"{worst}; K2 shapes: {len(panels)} verify panels of C "
          f"{SPEC_GAMMA + 1} at a mid-page q_start, {len(feeds)} C = 1 "
          f"feeds, C {sorted({c for c, _ in shapes})}")
    if not panels or not feeds or not all(calls.values()):
        raise RuntimeError("in-situ check missed a verify panel or a draft "
                           "feed")
    return dict(calls=calls, max_abs_diff=worst, panels=len(panels),
                feeds=len(feeds), k2_c=sorted({c for c, _ in shapes}),
                summary=run["summary"]["per_request"])


def accept_all(rows, draft, draft_q, **kw):
    """The control's acceptance: every draft kept, the last row's argmax
    as the bonus."""
    return len(draft), list(draft) + [int(rows[len(draft)].argmax())]


def speculative(seed: int):
    """Phase 8: speculative serving of full-width qwen2-0.5b (W8A8, and
    W4A8/W4A4 for (a)) over int8 pages (page 16, chunk 256), the kernels
    only: (a) n-gram, gamma 4, batch 1, the reference benchmark's shape;
    (b) n-gram, gamma 4, phase 3's mix of repeated spans; (c) a draft
    model with the target's own weights; (d) the serve CLI's default draft
    (reduced qwen2-0.5b, weights from seed + 1), gamma 'auto'; (e) (a) in
    W4A8 and W4A4; (f) (a) at temperature 0.9 with the n-gram drafter and
    with the self-draft (its proposals sampled from the q it returns),
    twice with one seed. Greedy parity with the plain engine (the near-tie
    rule, and an accept-all control that must fail it), launches held to
    the forwards, pools free after every run, every K1/K2 call of one
    request in situ, (b) profiled."""
    from repro_torch.core import autotune
    tmp = tempfile.TemporaryDirectory()
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(Path(tmp.name)
                                                   / "autotune.json")
    autotune.clear_cache()
    cfg = get_config("qwen2-0.5b", qmode="w8a8")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = quantize_params(init_params(cfg, generator=gen, device="cuda"),
                             cfg, "w8a8")
    dcfg = get_config("qwen2-0.5b", reduced=True, qmode="w8a8")
    dparams = quantize_params(init_params(
        dcfg, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
        device="cuda"), dcfg, "w8a8")
    pa, pb = spec_prompts(gen, cfg.vocab_size)
    ngram = sd.SpecConfig(method="ngram", gamma=SPEC_GAMMA)
    strong = sd.SpecConfig(method="draft", gamma=SPEC_GAMMA, draft_cfg=cfg,
                           draft_params=params)
    ps = kvc.DEFAULT_PAGE_SIZE
    # every sequence of (b) holds its reservation in the draft's pool:
    # request + max(SPEC_GAMMAS) + 1 tokens
    reduced = sd.SpecConfig(
        method="draft", gamma="auto", draft_cfg=dcfg, draft_params=dparams,
        draft_capacity_tokens=N_REQ * kvc.round_up(
            PROMPT_LEN + NEW + max(autotune.SPEC_GAMMAS) + 1, ps))

    def make(prompts, new, spec=None, p=params, c=cfg, **kw):
        return lambda: spec_engine(p, c, prompts, new, spec, **kw)

    out, laps, t_lap = {}, {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    def report(label, run, base, retunes=0):
        """Launches, greedy parity against ``base`` and the spec counts of
        one speculative run; every sequence must have drafted."""
        check_spec_launches(label, run, FUSED[run["engine"].cfg.qmode][0])
        divs, row_diff, ok = greedy_parity(label, run, base)
        if not ok:
            raise RuntimeError(f"{label}: greedy parity fails")
        s = run["summary"]
        drafted = sum(1 for r in s["per_request"].values() if r["proposed"])
        print(f"  {label}: {s['spec_steps']} verify steps, proposed "
              f"{s['proposed']}, accepted {s['accepted']} "
              f"({s['acceptance_rate']:.3f}), "
              f"{s['mean_tokens_per_step']:.3f} tokens a step, gamma "
              f"{s['gamma']}, {drafted} of {len(run['streams'])} sequences "
              f"drafted, {retunes} gamma re-picks, wall with logit rows "
              f"recorded {run['wall_s']:.3f} s")
        if drafted != len(run["streams"]):
            raise RuntimeError(f"{label}: only {drafted} sequences drafted")
        out[label] = dict(
            launches=run["launches"], wall_rows_recorded_s=run["wall_s"],
            divergences=divs, row_max_abs_diff=row_diff, retunes=retunes,
            summary={k: v for k, v in s.items() if k != "per_request"})

    lap("weights")
    spec_run(make(pa[:, :40], 6, ngram), pa[:, :40], 6)     # first use
    spec_run(make(pa[:, :40], 6, reduced), pa[:, :40], 6)
    lap("first use")

    # (a) and (b): a plain and a speculative run of each, their logit
    # rows kept for the parity check (untimed: phase 3 times serving)
    base = {}
    for label, prompts, new in (("(a) n-gram", pa, SPEC_NEW),
                                ("(b) n-gram", pb, NEW)):
        recorded = {kind: spec_run(make(prompts, new, spec), prompts, new,
                                   rows=True)
                    for kind, spec in (("plain", None), ("spec", ngram))}
        report(label, recorded["spec"], recorded["plain"])
        base[label[:3]] = recorded["plain"]
        lap(label)

    retunes = {"n": 0}
    pick = autotune.get_spec_gamma

    def counted_pick(*a, **kw):
        retunes["n"] += 1
        return pick(*a, **kw)
    autotune.get_spec_gamma = counted_pick
    try:
        for label, mk, prompts, new, b in (
                ("(c) self-draft", make(pa, SPEC_NEW, strong), pa, SPEC_NEW,
                 base["(a)"]),
                ("(d) reduced draft, gamma auto", make(pb, NEW, reduced), pb,
                 NEW, base["(b)"])):
            retunes["n"] = 0
            report(label, spec_run(mk, prompts, new, rows=True), b,
                   retunes["n"])
            lap(label)
    finally:
        autotune.get_spec_gamma = pick
    if out["(d) reduced draft, gamma auto"]["retunes"] < 1:
        raise RuntimeError("gamma='auto' never re-picked the window")
    base_a = base["(a)"]

    # the accept-all control: the reduced draft's every token kept must
    # fail the parity check
    inner = sd.accept_speculative
    sd.accept_speculative = accept_all
    try:
        control = spec_run(make(pa, SPEC_NEW, sd.SpecConfig(
            method="draft", gamma=SPEC_GAMMA, draft_cfg=dcfg,
            draft_params=dparams)), pa, SPEC_NEW, rows=True)
    finally:
        sd.accept_speculative = inner
    divs, _, ok = greedy_parity("accept-all control", control, base_a)
    if ok:
        raise RuntimeError("the accept-all control passed the parity check")
    out["accept-all control"] = dict(divergences=divs)
    lap("accept-all control")

    # (e) the int4 modes through K4
    for qmode in ("w4a8", "w4a4"):
        qcfg = get_config("qwen2-0.5b", qmode=qmode)
        qparams = quantize_params(init_params(
            qcfg, generator=torch.Generator(device="cuda").manual_seed(seed),
            device="cuda"), qcfg, qmode)
        label = f"(e) {qmode.upper()} n-gram"
        plain = spec_run(make(pa, SPEC_NEW, None, qparams, qcfg), pa,
                         SPEC_NEW, rows=True)
        report(label, spec_run(make(pa, SPEC_NEW, ngram, qparams, qcfg), pa,
                               SPEC_NEW, rows=True), plain)
        del qparams
        lap(label)

    # (f) temperature: the n-gram drafter (no q: draft_q None) once, and
    # the self-draft, whose proposals are sampled from the q they return,
    # twice with one seed: one stream
    for label, spec, runs in (("n-gram", ngram, 1), ("self-draft", strong,
                                                      2)):
        t = [spec_run(make(pa, SPEC_NEW, spec, sample="temperature",
                           temperature=SPEC_TEMPERATURE, seed=seed + 5),
                      pa, SPEC_NEW) for _ in range(runs)]
        same = all(x["streams"] == t[0]["streams"] for x in t)
        s1 = t[0]["summary"]
        print(f"  (f) temperature {SPEC_TEMPERATURE}, {label}: "
              f"{s1['spec_steps']} verify steps, accepted {s1['accepted']} "
              f"of {s1['proposed']}" + (
                  f"; the same seed gives the same stream: {same}"
                  if runs > 1 else ""))
        if not same:
            raise RuntimeError(f"temperature, {label}: one seed gave two "
                               f"streams")
        out[f"(f) temperature, {label}"] = dict(
            same_stream=same if runs > 1 else None,
            summary={k: v for k, v in s1.items() if k != "per_request"})
    lap("(f) temperature")

    out["in situ"] = spec_in_situ(params, cfg, sd.SpecConfig(
        method="draft", gamma=SPEC_GAMMA, draft_cfg=dcfg,
        draft_params=dparams), pa)
    lap("in situ")

    # (b) under the profiler: a window of SPEC_PROFILE_STEPS engine steps
    # once every prompt is prefilled (the whole run's trace takes the
    # profiler minutes to parse)
    eng = make(pb, NEW, ngram)()
    for p in pb:
        eng.submit(p, NEW)
    while eng.waiting or eng.prefilling:
        eng.step()
    before = eng.spec_summary()["spec_steps"]

    def profiled():
        for _ in range(SPEC_PROFILE_STEPS):
            eng.step()
    print(f"  (b) n-gram under the profiler (device activity only), "
          f"{SPEC_PROFILE_STEPS} engine steps after the prefill:")
    out["profile_b"] = profile_run(profiled, host_ops=False)
    out["profile_b"]["verify_forwards"] = verifies = (
        eng.spec_summary()["spec_steps"] - before)
    print(f"  the window held {verifies} verify forwards of "
          f"{len(eng.active)} sequences still active after it")
    if not verifies:
        raise RuntimeError("the profiled window of (b) held no verify step")
    eng.run()
    check_pools(eng)
    lap("(b) profiled")

    print("  phase 8 seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in laps.items()))
    out["seconds"] = laps
    autotune.clear_cache()
    tmp.cleanup()
    return out


# ---------------------------------------------------------------------------
# Phase 9: MoE serving, moonshot-v1-16b-a3b at full width and depth
# ---------------------------------------------------------------------------
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_NEW = 16             # new tokens a request, phase 3's 8 prompts of 512
# W8A8: full width, 12 of 48 layers (at 48 the phase took ~140 s, and the
# script must leave room for phase 13's MoE serving mesh)
MOE_W8A8_LAYERS = 12
MOE_CUT_LAYERS = 8       # W4A8 / W4A4: full width, 8 of 48 layers
MOE_CUT_PROMPT, MOE_CUT_NEW = 256, 4
# K1 as moe._expert_matmul calls it (f32 out, no epilogue): M is the
# expert capacity, 8 for a decode batch of 8 and 32 for a 256-token chunk;
# gate/up (K d 2,048, N expert d_ff 1,408) and down (1,408, 2,048). Then
# the untied lm head (bf16 out) at a chunk's last row and a decode batch.
MOE_EXPERT_SHAPES = ((8, 2048, 1408), (8, 1408, 2048), (32, 2048, 1408),
                     (32, 1408, 2048))
MOE_HEAD_SHAPES = ((1, 2048, 163840), (8, 2048, 163840))


def gemms_per_forward(cfg) -> int:
    """Fused GEMM calls of one forward that computes logits, by each
    layer's mixer (attention: q, k, v, o; Mamba: in, x and out
    projections, dt_proj being a float matmul; RWKV time mix: r, k, v, g
    and out) and FFN (dense: gate, up, down; MoE: those of every expert,
    each at capacity M whether or not a token routed to it; RWKV channel
    mix: key, value, receptance); the untied head."""
    mixer = {"attn": 4, "mamba": 3, "rwkv": 5}
    ffn = {"dense": 3, "moe": 3 * cfg.moe_experts, "rwkv_cmix": 3}
    return (sum(mixer[cfg.mixer_of(i)] + ffn[cfg.ffn_of(i)]
                for i in range(cfg.n_layers))
            + (0 if cfg.tie_embeddings else 1))


def build_layerwise(cfg, qmode: str, seed: int, device="cuda") -> dict:
    """``quantize_params(init_params(cfg, generator=seeded))`` built one
    layer at a time (``transformer.init_quantized_params``), so at most
    one layer is ever held in bf16 (full-width moonshot's bf16 experts
    alone are 53 GB, jamba's 90 GB)."""
    return init_quantized_params(
        cfg, qmode, generator=torch.Generator(device=device).manual_seed(seed),
        device=device)


@contextlib.contextmanager
def forward_launches():
    """Record the kernel launches of every forward an engine runs: its
    prefill chunks go through ``sd.paged_chunk_forward``, its ragged decode
    through the engine module's ``forward``. Yields a list of
    dict(lane, logits, launches), one a forward."""
    recs = []
    saved = sd.paged_chunk_forward, engine_mod.forward

    def wrap(inner, lane):
        def call(*a, **kw):
            before = read_counts()
            out = inner(*a, **kw)
            after = read_counts()
            recs.append(dict(
                lane=lane, logits=kw.get("logits", "all") != "none",
                launches={k: after[k] - before[k] for k in after
                          if after[k] != before[k]}))
            return out
        return call
    sd.paged_chunk_forward = wrap(saved[0], "prefill")
    engine_mod.forward = wrap(saved[1], "decode")
    try:
        yield recs
    finally:
        sd.paged_chunk_forward, engine_mod.forward = saved


def check_forward_launches(label, recs, cfg, gemm):
    """Every forward launched the mode's GEMM ``gemms_per_forward`` times
    (one fewer on a prefill chunk that computes no logits: no head), K2
    once a layer of a prefill chunk, K3 once a layer of a decode step, and
    nothing else: no call took a plain version."""
    per = gemms_per_forward(cfg)
    bad = []
    for r in recs:
        attn = "K2" if r["lane"] == "prefill" else "K3"
        want = {gemm: per - (0 if r["logits"] else 1), attn: cfg.n_layers}
        if r["launches"] != want:
            bad.append(dict(r, want=want))
    lanes = {lane: sum(r["lane"] == lane for r in recs)
             for lane in ("prefill", "decode")}
    print(f"  {label}: {len(recs)} forwards ({lanes['prefill']} prefill "
          f"chunks, {lanes['decode']} decode steps): {gemm} {per} a forward "
          f"({per - 1} on a chunk without logits), K2 or K3 "
          f"{cfg.n_layers}; mismatches {len(bad)}")
    if bad or not all(lanes.values()):
        raise RuntimeError(f"{label}: forwards launched other than "
                           f"expected: {bad[:2]}")
    return dict(forwards=len(recs), lanes=lanes, gemm_per_forward=per)


@contextlib.contextmanager
def record_routes():
    """Record every MoE routing call (``moe._route``): each token's top-k
    expert set, the picks that overflowed an expert's capacity, and the
    picks of the busiest expert."""
    recs = []
    inner = moe_mod._route

    def call(gates, k, cap):
        slots, weights = inner(gates, k, cap)
        top = torch.sort(gates, dim=-1, descending=True, stable=True
                         ).indices[..., :k].sort(dim=-1).values
        load = torch.bincount(top.reshape(-1), minlength=gates.shape[-1])
        recs.append(dict(top=top, tokens=gates.shape[0] * gates.shape[1],
                         dropped=int((slots == gates.shape[-1] * cap).sum()),
                         busiest=int(load.max())))
        return slots, weights
    moe_mod._route = call
    try:
        yield recs
    finally:
        moe_mod._route = inner


def moe_first_step(params, cfg, prompt):
    """The request's first-step logits (two chunks of 256) through the
    kernels and through the plain versions (impl='torch'), within
    ``LOGIT_TOL[cfg.qmode]`` of max |logit|; with both forwards' routing:
    the share of (token, layer) pairs whose top-k expert set differs, and
    the picks dropped over capacity in each layer of the first chunk."""
    with record_routes() as kern:
        got = prefill_last_logits(params, cfg, prompt, "auto")
    with record_routes() as plain:
        want = prefill_last_logits(params, cfg, prompt, "torch")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError("non-finite MoE logits")
    n_chunks = -(-len(prompt) // 256)
    if len(kern) != len(plain) or len(kern) != n_chunks * cfg.n_layers:
        raise RuntimeError(f"routing calls {len(kern)} / {len(plain)}; "
                           f"expected {n_chunks * cfg.n_layers}")
    differ = [int((a["top"] != b["top"]).any(dim=-1).sum())
              for a, b in zip(kern, plain)]
    pairs = sum(r["tokens"] for r in kern)
    # routing calls run chunk by chunk, layer by layer
    first = kern[:cfg.n_layers]
    dropped = [r["dropped"] for r in first]
    busiest = [r["busiest"] for r in first]
    scale = want.abs().max().item()
    err = max_err(got, want)
    rel_tol = LOGIT_TOL[cfg.qmode]
    print(f"  first-step logits ({cfg.qmode}), kernels vs plain: max |diff| "
          f"{err:.4g} = {err / scale:.2%} of max |logit| {scale:.4g} (limit "
          f"{rel_tol:.0%}); argmax {got.argmax().item()} vs "
          f"{want.argmax().item()}; top-{cfg.moe_top_k} expert sets differ "
          f"in {sum(differ)} of {pairs} (token, layer) pairs "
          f"({sum(differ) / pairs:.3%}); in the first chunk, layer by layer: "
          f"{differ[:cfg.n_layers]}")
    print(f"  the first 256-token chunk, layer by layer (cap "
          f"{moe_mod.expert_capacity(256, cfg)} of {256 * cfg.moe_top_k} "
          f"picks over {cfg.moe_experts} experts): picks dropped over "
          f"capacity {dropped} (sum {sum(dropped)}); picks of the busiest "
          f"expert {busiest}")
    if err > rel_tol * scale:
        raise RuntimeError(f"MoE {cfg.qmode} kernel logits differ from the "
                           f"plain versions by more than {rel_tol:.0%} of "
                           f"max |logit|")
    return dict(max_abs_diff=err, max_abs_logit=scale, rel_tol=rel_tol,
                topk_sets_differ=differ, token_layer_pairs=pairs,
                dropped_first_chunk=dropped, busiest_first_chunk=busiest)


def profile_moe_decode(engine, prompts):
    """One ragged decode forward of all requests under the profiler: the
    prompts prefilled on a fresh engine first, then one engine step with
    nothing left to prefill. A forward of full-width moonshot launches
    9,409 K1 calls; a longer window's trace takes the profiler minutes to
    parse."""
    eng = engine()
    for p in prompts:
        eng.submit(p, MOE_NEW)
    while eng.waiting or eng.prefilling:
        eng.step()
    if len(eng.active) != len(prompts):
        raise RuntimeError(f"{len(eng.active)} of {len(prompts)} requests "
                           f"active after the prefill")
    print(f"  one decode forward of {len(eng.active)} requests under the "
          f"profiler (device activity only):")
    with forward_launches() as recs:
        prof = profile_run(eng.step, host_ops=False)
    if [r["lane"] for r in recs] != ["decode"]:
        raise RuntimeError(f"the profiled step ran {recs}")
    eng.run()
    check_pools(eng)
    prof["launches"] = recs[0]["launches"]
    if prof["device_busy_ms"]:
        print(f"  K1 busy {prof['gemm']['ms']:.2f} ms of the device's "
              f"{prof['device_busy_ms']:.2f} ms busy in a {prof['wall_ms']:.1f}"
              f" ms forward ({prof['device_busy_ms'] / prof['wall_ms']:.1%})")
    return prof


def moe_engine(params, cfg, n_req, prompt_len, new):
    """A factory of engines over int8 pages sized for the request mix."""
    ps = kvc.DEFAULT_PAGE_SIZE

    def engine():
        return ContinuousBatchingEngine(
            params, cfg, kv_dtype="int8", page_size=ps, prefill_chunk=256,
            capacity_tokens=n_req * kvc.round_up(prompt_len + new, ps),
            device="cuda")
    return engine


def serve_moe_w8a8(seed: int, smi: str, layers: int = MOE_W8A8_LAYERS):
    """Full-width moonshot-v1-16b-a3b in W8A8 at ``layers`` of 48 on the
    paged engine: phase 3's request mix with ``MOE_NEW`` new tokens, every
    forward's launches held to the model; in situ; first-step logits and
    routing; one profiled decode forward."""
    cfg = get_config(MOE_ARCH, qmode="w8a8", n_layers=layers)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = build_layerwise(cfg, "w8a8", seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    on_card = torch.cuda.memory_allocated()
    experts = int8_weight_bytes([lp["moe"] for lp in params["layers"]])
    print(f"  {MOE_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
          f"{cfg.moe_experts} experts top-{cfg.moe_top_k} of d_ff "
          f"{cfg.expert_ff}, vocab {cfg.vocab_size}, W8A8, built and "
          f"quantized one layer at a time in {build_s:.1f} s: {on_card:,} "
          f"bytes on the card ({experts:,} of int8 experts), peak "
          f"{torch.cuda.max_memory_allocated():,}; {smi}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (N_REQ, PROMPT_LEN),
                            generator=gen, device="cuda")
    prompts[1, :PREFIX_LEN] = prompts[0, :PREFIX_LEN]   # a shared prefix
    engine = moe_engine(params, cfg, N_REQ, PROMPT_LEN, MOE_NEW)
    warm = engine()
    warm.submit(prompts[0, :40], 2)
    warm.run()
    torch.cuda.synchronize()
    reset_counts()
    with forward_launches() as recs:
        wall, ttft, shared, out = run_workload(engine(), prompts, MOE_NEW)
    launches = {k: v for k, v in read_counts().items() if v}
    steps = sum(len(t) for t in out)
    print(f"  served {N_REQ} requests x {PROMPT_LEN} prompt + {MOE_NEW} new "
          f"tokens in {wall:.3f} s: {steps / wall:.2f} generated tok/s; "
          f"time to first token: first {ttft[0]:.3f} s, median "
          f"{ttft[N_REQ // 2]:.3f} s, last {ttft[-1]:.3f} s; pages shared "
          f"{shared}; kernel launches {launches}")
    per_forward = check_forward_launches("W8A8", recs, cfg, "K1")
    if [len(t) for t in out] != [MOE_NEW] * N_REQ or not all(
            0 <= x < cfg.vocab_size for t in out for x in t):
        raise RuntimeError("MoE: generated tokens of the wrong count or range")
    if shared != PREFIX_LEN // kvc.DEFAULT_PAGE_SIZE:
        raise RuntimeError(f"MoE: {shared} shared pages")
    in_situ = check_in_situ(engine, prompts[0], "w8a8")
    logits = moe_first_step(params, cfg, prompts[0])
    profile = profile_moe_decode(engine, prompts)
    return dict(build_s=build_s, bytes_on_card=on_card,
                int8_expert_bytes=experts, launches=launches,
                per_forward=per_forward, wall_s=wall,
                gen_tok_s=steps / wall, ttft_s=ttft, shared_pages=shared,
                in_situ=in_situ, logits=logits, profile=profile)


def serve_moe_cut(seed: int, qmode: str):
    """W4A8 or W4A4 at full width, depth cut to ``MOE_CUT_LAYERS``: one
    request of ``MOE_CUT_PROMPT`` + ``MOE_CUT_NEW`` tokens, every
    forward's launches held to the model (K4), then in situ."""
    cfg = get_config(MOE_ARCH, qmode=qmode, n_layers=MOE_CUT_LAYERS)
    gemm = FUSED[qmode][0]
    params = build_layerwise(cfg, qmode, seed)
    prompt = torch.randint(0, cfg.vocab_size, (MOE_CUT_PROMPT,),
                           generator=torch.Generator(
                               device="cuda").manual_seed(seed + 1),
                           device="cuda")
    engine = moe_engine(params, cfg, 1, MOE_CUT_PROMPT, MOE_CUT_NEW)
    reset_counts()
    with forward_launches() as recs:
        eng = engine()
        sid = eng.submit(prompt, MOE_CUT_NEW)
        out = eng.run()[sid]
    launches = {k: v for k, v in read_counts().items() if v}
    print(f"  {qmode.upper()}, {cfg.n_layers} of 48 layers: one request of "
          f"{MOE_CUT_PROMPT} + {MOE_CUT_NEW} tokens, kernel launches "
          f"{launches}")
    per_forward = check_forward_launches(qmode.upper(), recs, cfg, gemm)
    if len(out) != MOE_CUT_NEW:
        raise RuntimeError(f"MoE {qmode}: {len(out)} tokens")
    in_situ = check_in_situ(engine, prompt, qmode)
    return dict(layers=cfg.n_layers, launches=launches,
                per_forward=per_forward, in_situ=in_situ)


def moe_serving(seed: int, smi: str, layers: int = MOE_W8A8_LAYERS):
    """Phase 9: W8A8 at ``layers`` of 48, then W4A8 and W4A4 cut to
    ``MOE_CUT_LAYERS`` layers; the phase's seconds."""
    t0 = time.perf_counter()
    out = {"w8a8": serve_moe_w8a8(seed, smi, layers)}
    torch.cuda.empty_cache()
    for qmode in ("w4a8", "w4a4"):
        out[qmode] = serve_moe_cut(seed, qmode)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 9 seconds: {out['seconds']:.1f}")
    return out


# ---------------------------------------------------------------------------
# Phase 10: recurrent mixers (Mamba, RWKV6) and embedding inputs on the
# dense-slab loop
# ---------------------------------------------------------------------------
REC_LAYERS = 8           # jamba-v0.1-52b: one whole period of its 32 layers
REC_REQ, REC_PROMPT, REC_NEW = 4, 512, 16
REC_CUT_PROMPT, REC_CUT_NEW = 256, 4     # jamba W4A8 / W4A4: one request
FRONT_LAYERS = 4         # pixtral-12b, musicgen-large: 4 of 40 / 48 layers
FRONT_REQ, FRONT_PROMPT, FRONT_NEW = 2, 256, 8
STATE_STEPS = 4          # decode steps of the state check
# Layer 0's recurrence on its prefill inputs, f32 on the card against an
# f64 sequential recurrence on the same inputs, as a share of max |f64|:
# the reference's own property tests hold the scan to rtol = atol = 2e-5
# and the chunked WKV to 1e-4 against their sequential forms
# (tests/test_properties.py:125, :105). The WKV's factorised decays
# exp(cl_prev - CL) reach e^(C·LW_MAX) = e^80 at chunk 32, so their
# exponents carry an absolute error of ~C·LW_MAX·2^-24 ≈ 5e-6.
SCAN_TOL, WKV_TOL = 2e-5, 1e-4
# the recurrent states a control zeroes between prefill and decode
REC_STATE_KEYS = ("mamba", "rwkv_tm", "rwkv_cm")


def rec_inputs(cfg, gen, n_req, prompt_len):
    """Token ids (n_req, prompt_len), or bf16 embeddings (n_req,
    prompt_len, d_model) for a model with ``embedding_inputs``
    (``frontend.synth_*_embeddings``)."""
    if cfg.embedding_inputs:
        synth = (frontend.synth_frame_embeddings if cfg.family == "audio"
                 else frontend.synth_patch_embeddings)
        return synth(gen, cfg, n_req, prompt_len)
    return torch.randint(0, cfg.vocab_size, (n_req, prompt_len),
                         generator=gen, device="cuda")


def rec_generate(label, params, cfg, prompts, new):
    """``generate`` (→ ``_generate_dense``, the bf16 slab) over the batch;
    every forward must launch the mode's fused GEMM exactly
    ``gemms_per_forward`` times and nothing else; then the batch's prefill
    once more, timed alone (its time to first token)."""
    gemm = FUSED[cfg.qmode][0]
    per = gemms_per_forward(cfg)
    reset_counts()
    with forward_launches() as recs:
        t0 = time.perf_counter()
        toks = generate(params, cfg, prompts, steps=new, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    bad = [r["launches"] for r in recs if r["launches"] != {gemm: per}]
    b = prompts.shape[0]
    t0 = time.perf_counter()
    build_prefill_step(cfg)(params, prompts, init_serve_caches(
        cfg, b, prompts.shape[1] + new, device="cuda"))
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    print(f"  {label}: {b} x ({prompts.shape[1]} + {new}) through generate "
          f"(dense slab) in {wall:.3f} s, {b * new / wall:.2f} generated "
          f"tok/s, the batch's prefill alone {ttft:.3f} s; {len(recs)} "
          f"forwards, {gemm} {per} each; mismatches {len(bad)}; kernel "
          f"launches {launches}")
    if bad or len(recs) != new or launches != {gemm: per * new}:
        raise RuntimeError(f"{label}: forwards launched {bad[:2]} (want "
                           f"{gemm} {per}), {len(recs)} forwards, {launches}")
    if tuple(toks.shape) != (b, new) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise RuntimeError(f"{label}: tokens of the wrong shape or range")
    return dict(wall_s=wall, gen_tok_s=b * new / wall, prefill_s=ttft,
                launches=launches, forwards=len(recs), per_forward=per,
                tokens=toks)


def rec_in_situ(params, cfg, prompt):
    """Every fused GEMM call of one request (its prefill and two decode
    steps) held against the plain version on the same inputs: exact (silu:
    one bf16 ULP)."""
    gemm, name = FUSED[cfg.qmode]
    worst, calls = {gemm: 0.0}, {gemm: 0}
    saved = getattr(ops, name)
    setattr(ops, name, gemm_in_situ(gemm, name, worst, calls))
    try:
        _generate_dense(params, cfg, prompt[None], steps=3, device="cuda")
    finally:
        setattr(ops, name, saved)
    want = 3 * gemms_per_forward(cfg)
    print(f"  in situ, every {gemm} call of one request (prefill, two "
          f"decode steps) vs its plain version: {calls[gemm]} calls, max "
          f"|diff| {worst[gemm]:.3g}")
    if calls[gemm] != want:
        raise RuntimeError(f"in situ: {calls[gemm]} calls, expected {want}")
    return dict(calls=calls, max_abs_diff=worst)


def rec_first_step(params, cfg, prompt):
    """One request's prefill logits through the kernels and through the
    plain versions (impl='torch'), within ``LOGIT_TOL`` of max |logit|."""
    def run(impl):
        caches = init_serve_caches(cfg, 1, prompt.shape[0] + 1,
                                   device="cuda")
        return build_prefill_step(cfg, impl=impl)(params, prompt[None],
                                                  caches)[0][0].float()
    got, want = run("auto"), run("torch")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError("non-finite logits")
    scale, err = want.abs().max().item(), max_err(got, want)
    rel_tol = LOGIT_TOL[cfg.qmode]
    print(f"  first-step logits, kernels vs plain: max |diff| {err:.4g} = "
          f"{err / scale:.2%} of max |logit| {scale:.4g} (limit "
          f"{rel_tol:.0%}); argmax {got.argmax().item()} vs "
          f"{want.argmax().item()}")
    if err > rel_tol * scale:
        raise RuntimeError(f"{cfg.name} {cfg.qmode} kernel logits differ "
                           f"from the plain versions by more than "
                           f"{rel_tol:.0%}")
    return dict(max_abs_diff=err, max_abs_logit=scale, rel_tol=rel_tol)


@contextlib.contextmanager
def layer0_recurrence(mamba: bool):
    """Record the recurrence calls of every forward (the engine module's
    ``forward``, which the dense loop's steps call): per forward, the
    (args, output) of its Mamba scan segments (``ssm._ssm_scan_segment``)
    or of its WKV (``rwkv._wkv6_chunked`` / ``_wkv6_step``), layer 0's
    being the first ``nseg`` (Mamba) or the first one (RWKV)."""
    fwd = []
    names = ("_ssm_scan_segment",) if mamba else ("_wkv6_chunked",
                                                  "_wkv6_step")
    mod = ssm_mod if mamba else rwkv_mod
    saved = [getattr(mod, n) for n in names] + [engine_mod.forward]

    def rec(fn):
        def call(*args):
            out = fn(*args)
            fwd[-1].append((args, out))
            return out
        return call

    def forward(*a, **kw):
        fwd.append([])
        return saved[-1](*a, **kw)
    for n, fn in zip(names, saved):
        setattr(mod, n, rec(fn))
    engine_mod.forward = forward
    try:
        yield fwd
    finally:
        for n, fn in zip(names, saved):
            setattr(mod, n, fn)
        engine_mod.forward = saved[-1]


def rec_state(params, cfg, prompt, toks):
    """Layer 0's recurrence, on the card against f64: the request's
    prefill, then ``STATE_STEPS`` decode steps feeding its own tokens,
    with every scan segment or WKV call of layer 0 recorded. An f64
    sequential recurrence over the very inputs those calls took (the Mamba
    scan's decays and drives, the WKV's r, k, v and log decays) must give
    the prefill's outputs (the scan's h at every position; the WKV's y and
    final state) and the state after the decode steps, within
    ``SCAN_TOL`` / ``WKV_TOL`` of max |f64|. A control zeroes the
    recurrent states between prefill and decode, and the check must
    reject it.

    Beside it, not gated: the state and the last logits against one
    prefill over all the tokens. A step's inputs at M = 1 and that
    prefill's at M = 516 differ by the bf16 roundings of the float
    matmuls (the RWKV token-shift LoRAs, Mamba's dt_proj), whose cuBLAS
    kernels depend on M; the fused GEMMs' int8 roundings then amplify
    such differences layer by layer (seen on the H100, this seed:
    rwkv6-7b layer 0's state 4.8e-3 of max from that prefill's, about as
    far as the zeroed control; the logits ~74% at full depth)."""
    s = prompt.shape[0]
    n = s + STATE_STEPS
    seq = torch.cat([prompt, toks[:STATE_STEPS].to(prompt.device)])[None]
    mamba = cfg.mixer_of(0) == "mamba"
    key, name = ("mamba", "h") if mamba else ("rwkv_tm", "s")
    chunks = cfg.ssm_seq_chunks
    nseg = chunks if mamba and s > chunks and s % chunks == 0 else 1

    def incremental(zero):
        with layer0_recurrence(mamba) as fwd:
            caches = init_serve_caches(cfg, 1, n, device="cuda")
            _, caches = build_prefill_step(cfg)(params, prompt[None],
                                                caches)
            if zero:
                for c in caches:
                    for k in REC_STATE_KEYS:
                        for t in c.get(k, {}).values():
                            t.zero_()
            for i in range(STATE_STEPS):
                logits, caches, _ = engine_mod.forward(
                    params, cfg, seq[:, s + i:s + i + 1], caches=caches,
                    cache_pos=s + i)
        return logits[0, -1].float(), caches[0], fwd
    got_logits, layer0, fwd = incremental(False)
    prefill, steps = fwd[0][:nseg], [f[0] for f in fwd[1:]]
    if len(fwd) != 1 + STATE_STEPS or len(prefill) != nseg:
        raise RuntimeError(f"recorded {len(fwd)} forwards, {len(prefill)} "
                           f"prefill calls")

    def rel(got, want):
        return max_err(got, want) / want.abs().max().item()
    errs = {}
    if mamba:          # h_t = a_t h_{t-1} + bu_t, over every call in order
        h = prefill[0][0][2].double()
        for i, ((a, bu, _), (h_all, _)) in enumerate(prefill + steps):
            hs = []
            for t in range(a.shape[1]):
                h = a[:, t].double() * h + bu[:, t].double()
                hs.append(h)
            if i < nseg:
                errs["prefill h"] = max(errs.get("prefill h", 0.0), rel(
                    h_all, torch.stack(hs, dim=1)))
        tol, what = SCAN_TOL, f"{nseg} scan segments"
    else:
        (r, k, v, lw, u, s0, chunk), (y, s_fin) = prefill[0]
        ref_y, h = rwkv_mod.wkv6_sequential_ref(
            *(t.double() for t in (r, k, v, lw, u, s0)))
        errs["prefill y"], errs["prefill s"] = rel(y, ref_y), rel(s_fin, h)
        for (r, k, v, lw, u, _), _ in steps:
            h = rwkv_mod.wkv6_sequential_ref(
                *(t.double() for t in (r, k, v, lw, u)), h)[1]
        tol, what = WKV_TOL, f"the chunked WKV (chunk {chunk})"
    errs[f"{name} after decode"] = rel(layer0[key][name], h)
    control = rel(incremental(True)[1][key][name], h)
    last, once = build_prefill_step(cfg)(params, seq, init_serve_caches(
        cfg, 1, n, device="cuda"))
    beside = max(rel(layer0[k][m], once[0][k][m])
                 for k in ("mamba", "rwkv_tm") if k in once[0]
                 for m in once[0][k])
    gap = rel(got_logits, last[0].float())
    print(f"  layer 0, prefill ({what}) + {STATE_STEPS} decode steps vs an "
          f"f64 sequential recurrence over the inputs they took, max |diff| "
          f"/ max |f64|: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                       errs.items())
          + f" (limit {tol:g}); control with the states zeroed after the "
          f"prefill {control:.3g} (must exceed the limit); beside, not "
          f"gated, against one prefill over the same {n} tokens: layer 0's "
          f"mixer states {beside:.3g}, the last logits {gap:.2%} of max "
          f"|logit|")
    if max(errs.values()) > tol or control <= tol:
        raise RuntimeError(f"{cfg.name}: layer 0's recurrence {errs}, "
                           f"control {control:.3g}, limit {tol:g}")
    return dict(rel_err=errs, control_rel_err=control, tol=tol,
                one_prefill_state_rel=beside, one_prefill_logits_rel=gap)


@contextlib.contextmanager
def mixer_ranges(gemm_name):
    """Profiler ranges: "recurrence" around each Mamba and RWKV time-mix
    call, "gemm in recurrence" around each fused GEMM call inside one; the
    recurrence's own kernels (conv, dt_proj, the scan or WKV, norms,
    gates) are the first less the second."""
    from torch.profiler import record_function
    inside = [0]

    def mixer(fn):
        def call(*a, **kw):
            inside[0] += 1
            try:
                with record_function("recurrence"):
                    return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return call

    def gemm(fn):
        def call(*a, **kw):
            if not inside[0]:
                return fn(*a, **kw)
            with record_function("gemm in recurrence"):
                return fn(*a, **kw)
        return call
    targets = [(ssm_mod, "mamba_mixer", mixer),
               (rwkv_mod, "rwkv_time_mix", mixer), (ops, gemm_name, gemm)]
    saved = [getattr(m, n) for m, n, _ in targets]
    for m, n, wrap in targets:
        setattr(m, n, wrap(getattr(m, n)))
    try:
        yield
    finally:
        for (m, n, _), fn in zip(targets, saved):
            setattr(m, n, fn)


def rec_profile(params, cfg, prompts, new):
    """One decode forward of the batch under the profiler, after its
    prefill: device busy share, K1 ms, and the recurrence's own kernels'
    ms (the Mamba / RWKV time-mix calls less their GEMMs)."""
    b, s = prompts.shape[:2]
    caches = init_serve_caches(cfg, b, s + new, device="cuda")
    last, caches = build_prefill_step(cfg)(params, prompts, caches)
    tok = last.float().argmax(-1)[:, None]
    decode = build_decode_step(cfg)
    decode(params, caches, tok, s)               # first-use costs
    torch.cuda.synchronize()
    print(f"  one decode forward of {b} requests under the profiler:")
    with mixer_ranges(FUSED[cfg.qmode][1]):
        prof = profile_run(lambda: decode(params, caches, tok, s + 1),
                           ranges=("recurrence", "gemm in recurrence"))
    rng = prof["ranges"]
    prof["recurrence_ms"] = rng["recurrence"] - rng["gemm in recurrence"]
    if prof["device_busy_ms"]:
        print(f"  busy {prof['device_busy_ms']:.2f} ms of a "
              f"{prof['wall_ms']:.1f} ms forward "
              f"({prof['device_busy_ms'] / prof['wall_ms']:.1%}); fused "
              f"GEMMs {prof['gemm']['ms']:.2f} ms; the recurrence's own "
              f"kernels {prof['recurrence_ms']:.2f} ms (Mamba / RWKV "
              f"time-mix calls {rng['recurrence']:.2f} ms less their GEMMs "
              f"{rng['gemm in recurrence']:.2f} ms)")
    return prof


def rec_case(label, arch, qmode, seed, smi, *, layers, n_req, prompt_len,
             new, full):
    """One run of phase 10: the model built and quantized a layer at a
    time, ``generate`` over its request mix, in situ, first-step logits;
    with ``full``, the f64 recurrence check, the state check and one
    profiled decode forward."""
    t0 = time.perf_counter()
    over = {} if layers is None else dict(n_layers=layers)
    cfg = get_config(arch, qmode=qmode, **over)
    torch.cuda.reset_peak_memory_stats()
    params = build_layerwise(cfg, qmode, seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kinds = sorted({f"{cfg.mixer_of(i)}/{cfg.ffn_of(i)}"
                    for i in range(cfg.n_layers)})
    print(f"  {label}: {cfg.n_layers} layers ({', '.join(kinds)}), d "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {qmode.upper()}, built "
          f"and quantized a layer at a time in {build_s:.1f} s: "
          f"{torch.cuda.memory_allocated():,} bytes on the card "
          f"({int8_weight_bytes(params):,} of integer weights), peak "
          f"{torch.cuda.max_memory_allocated():,}; {smi}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompts = rec_inputs(cfg, gen, n_req, prompt_len)
    generate(params, cfg, prompts[:1, :16], steps=2, device="cuda")  # warm
    out = dict(layers=cfg.n_layers, build_s=build_s,
               bytes_on_card=torch.cuda.memory_allocated())
    out["run"] = rec_generate(label, params, cfg, prompts, new)
    toks = out["run"].pop("tokens")
    out["in_situ"] = rec_in_situ(params, cfg, prompts[0])
    out["logits"] = rec_first_step(params, cfg, prompts[0])
    if full:
        out["state"] = rec_state(params, cfg, prompts[0], toks[0])
        out["profile"] = rec_profile(params, cfg, prompts, new)
    out["seconds"] = time.perf_counter() - t0
    print(f"  {label} seconds: {out['seconds']:.1f}")
    return out


def recurrent_serving(seed: int, smi: str):
    """Phase 10: jamba-v0.1-52b (8 of 32 layers) and rwkv6-7b (all 32) in
    W8A8 at full width through ``generate``'s dense-slab loop; jamba in
    W4A8 / W4A4; pixtral-12b and musicgen-large (4 layers each) from float
    embeddings."""
    t0 = time.perf_counter()
    runs = {}
    for label, arch, qmode, layers, mix, full in (
            ("jamba w8a8", "jamba-v0.1-52b", "w8a8", REC_LAYERS,
             (REC_REQ, REC_PROMPT, REC_NEW), True),
            ("rwkv6 w8a8", "rwkv6-7b", "w8a8", None,
             (REC_REQ, REC_PROMPT, REC_NEW), True),
            ("jamba w4a8", "jamba-v0.1-52b", "w4a8", REC_LAYERS,
             (1, REC_CUT_PROMPT, REC_CUT_NEW), False),
            ("jamba w4a4", "jamba-v0.1-52b", "w4a4", REC_LAYERS,
             (1, REC_CUT_PROMPT, REC_CUT_NEW), False),
            ("pixtral w8a8", "pixtral-12b", "w8a8", FRONT_LAYERS,
             (FRONT_REQ, FRONT_PROMPT, FRONT_NEW), False),
            ("musicgen w8a8", "musicgen-large", "w8a8", FRONT_LAYERS,
             (FRONT_REQ, FRONT_PROMPT, FRONT_NEW), False)):
        n_req, prompt_len, new = mix
        runs[label] = rec_case(label, arch, qmode, seed, smi, layers=layers,
                               n_req=n_req, prompt_len=prompt_len, new=new,
                               full=full)
        torch.cuda.empty_cache()
    runs["seconds"] = time.perf_counter() - t0
    print(f"  phase 10 seconds: {runs['seconds']:.1f}")
    return runs


# ---------------------------------------------------------------------------
# Phase 11: training
# ---------------------------------------------------------------------------
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 20
TRAIN_LR = 3e-3          # the train CLI's default; cosine, 2 warm-up steps
TRAIN_WARM = 2           # steps left out of the step time (first-use costs)
# restart check: full width, depth cut so the checkpoint's write and read
# stay short (the embedding alone is 156 M values)
RESTART_LAYERS, RESTART_STEPS, RESTART_AT = 2, 6, 3
RESTART_RTOL = 1e-5      # tests/test_train_loop.py::test_restart_exact
# the reduced f32 step, card vs CPU: the CPU tests' f32 tolerances against
# the reference (tests/test_torch_train.py: loss relative, each gradient
# leaf as a share of its largest |g|)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-6, 1e-5
# leaf shapes of moonshot-v1-16b-a3b's trained state through K7: the
# untied head's 163,840-long rows, its embedding, an expert stack (rows of
# E·K), the router and a norm scale (one row)
K7_LEAF_SHAPES = ((2048, 163840), (163840, 2048), (64, 2048, 1408),
                  (2048, 64), (2048,))


@contextlib.contextmanager
def k7_checked(record):
    """Every K7 call inside: the kernel, then its plain version on the same
    tensor, exact; a row of ``record`` per call."""
    kernel = k7.quantize_rowwise_kernel

    def call(x, *, bits=8):
        q, s = kernel(x, bits=bits)
        q_r, s_r = quantize_rowwise_ref(x, bits)
        record.append(dict(shape=tuple(x.shape), dtype=str(x.dtype),
                           exact=bool(torch.equal(q, q_r)
                                      and torch.equal(s, s_r)),
                           max_abs_err=max(max_err(q, q_r), max_err(s, s_r))))
        return q, s
    k7.quantize_rowwise_kernel = call
    try:
        yield
    finally:
        k7.quantize_rowwise_kernel = kernel


def train_setup(cfg, int8: bool, steps: int):
    """(optimizer, train step) as the train CLI builds them; ``int8``:
    int8 moments and int8 gradient compression (K7)."""
    opt = adamw(lr=cosine_schedule(TRAIN_LR, steps // 10, steps),
                weight_decay=0.01, quantize_moments=int8)
    return opt, build_train_step(cfg, opt,
                                 compress_grads="int8" if int8 else None)


def train_state(cfg, opt, seed):
    return init_train_state(
        cfg, opt, generator=torch.Generator(device="cuda").manual_seed(seed),
        device="cuda")


def train_run(label, cfg, seed, int8, smi):
    """``TRAIN_STEPS`` steps of full-width training through ``loop.run``
    from random weights: the launch counts of the run, step time, tokens/s,
    peak memory and the losses; then, for the int8 run, every K7 call of
    one more step against its plain version, and one step profiled."""
    opt, step = train_setup(cfg, int8, TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    state = train_state(cfg, opt, seed)
    data = SyntheticLMData(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=seed)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, hist = train_loop.run(step, state, data, steps=TRAIN_STEPS,
                                 log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    loss = hist["loss"]
    step_s = float(np.median(hist["step_time"][TRAIN_WARM:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = dict(int8=int8, launches=launches, loss=loss, wall_s=wall,
               step_ms=step_s * 1e3, step_ms_all=[t * 1e3 for t in
                                                  hist["step_time"]],
               tokens_per_s=tokens / step_s,
               peak_bytes=torch.cuda.max_memory_allocated(),
               loss_first5=float(np.mean(loss[:5])),
               loss_last5=float(np.mean(loss[-5:])))
    n_leaves = len(leaves(state["params"]))
    n = sum(p.numel() for p in leaves(state["params"]))
    # 6·N·tokens (forward 2, backward 4) at the dense bf16 peak; the
    # recomputed forward (remat) and attention's S² products not counted
    out.update(params=n, bound_ms=6.0 * n * tokens / BF16_OPS_PER_S * 1e3)
    print(f"  {label}: {n:,} parameters; 6·N·tokens bound "
          f"{out['bound_ms']:.2f} ms a step at the dense bf16 peak")
    print(f"  {label}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens in {wall:.1f} s; step {out['step_ms']:.1f} ms (median "
          f"after {TRAIN_WARM}; first {out['step_ms_all'][0]:.0f} ms), "
          f"{out['tokens_per_s']:,.0f} tokens/s, peak "
          f"{out['peak_bytes']:,} bytes; loss {loss[0]:.4f} → {loss[-1]:.4f}"
          f" (first 5 {out['loss_first5']:.4f}, last 5 "
          f"{out['loss_last5']:.4f}); launches "
          f"{ {k: v for k, v in launches.items() if v} }; {smi}")
    if not all(np.isfinite(loss)):
        raise RuntimeError(f"{label}: a loss is not finite: {loss}")
    if not out["loss_last5"] < out["loss_first5"]:
        raise RuntimeError(f"{label}: the loss did not fall: {loss}")
    # int8: each step quantizes every gradient leaf and both moments of
    # every leaf; f32 moments: no kernel at all
    want = dict.fromkeys(launches, 0)
    if int8:
        want["K7"] = TRAIN_STEPS * 3 * n_leaves
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, expected {want}")
    batch = shard_batch(data.batch_at(TRAIN_STEPS), device="cuda")
    if int8:
        calls = []
        with k7_checked(calls):
            step(state, batch)
        torch.cuda.synchronize()
        bad = [c for c in calls if not c["exact"]]
        longest = max(c["shape"][-1] for c in calls)
        print(f"  {label}: in situ, one step's {len(calls)} K7 calls "
              f"({len({c['shape'] for c in calls})} shapes, rows up to "
              f"{longest:,}) against the plain version: "
              f"{'exact' if not bad else f'{len(bad)} FAIL'}")
        if bad or len(calls) != 3 * n_leaves:
            raise RuntimeError(f"{label}: K7 in situ: {len(calls)} calls, "
                               f"{bad[:3]}")
        out["in_situ"] = dict(calls=len(calls), longest_row=longest,
                              max_abs_err=max(c["max_abs_err"]
                                              for c in calls))
    print(f"  {label}: one step under the profiler:")
    prof = profile_run(lambda: step(state, batch), host_ops=False)
    out["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                           "device_summed_ms", "top")}
    return out


def k7_training_shapes(timer, gen):
    """K7 through the optimizer's and the gradient compression's calls at
    ``K7_LEAF_SHAPES`` (a second moment in f32 after the sqrt transform, a
    bf16 gradient), each call exact against its plain version; times of
    the moment quantize at the widest rows."""
    calls, rows = [], []
    for shape in K7_LEAF_SHAPES:
        v = torch.rand(shape, device="cuda", generator=gen) * 1e-6
        g = (torch.randn(shape, device="cuda", generator=gen)
             * 1e-3).to(torch.bfloat16)
        with k7_checked(calls):
            int8_moment_quant(v, sqrt_transform=True)
            _int8_compress(g)
        x = torch.sqrt(v).reshape(-1, shape[-1])
        m, k = x.shape
        q, s = k7.quantize_rowwise_kernel(x)
        b_ms, b_by = bound(nbytes(x, q, s), 3.0 * m * k, F32_OPS_PER_S)
        rows.append(dict(kernel="K7", m=m, k=k, bits=8, dtype=str(x.dtype),
                         label="training", max_abs_err=0.0, ok=True,
                         ms=timer(lambda: k7.quantize_rowwise_kernel(x)),
                         plain_ms=timer(lambda: quantize_rowwise_ref(x, 8)),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del v, g, x, q, s
    torch.cuda.synchronize()
    for c, r in zip(calls[::2], rows):
        r["max_abs_err"] = c["max_abs_err"]
        r["ok"] = c["exact"]
    bad = [c for c in calls if not c["exact"]]
    for r in rows:
        print(f"  K7 at a trained leaf m={r['m']} k={r['k']} f32: "
              f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"bound={r['bound_ms']:.4f} ({r['bound_by']})")
    print(f"  K7 at moonshot's leaf shapes: {len(calls)} calls (moments and "
          f"bf16 gradients) {'exact' if not bad else f'{len(bad)} FAIL'}")
    if bad:
        raise RuntimeError(f"K7 at the trained leaf shapes: {bad}")
    return rows


def train_card_vs_cpu(seed):
    """The reduced f32 train step's loss and gradients on the card against
    the same computation on the CPU, from the same weights and batch."""
    cfg = get_config(TRAIN_ARCH, reduced=True, dtype="float32")
    params = init_params(cfg, generator=torch.Generator().manual_seed(seed),
                         device="cpu")
    batch = SyntheticLMData(cfg.vocab_size, 8, 32, seed=seed).batch_at(0)
    l_cpu, g_cpu = value_and_grad(loss_fn, params, cfg,
                                  shard_batch(batch, device="cpu"))
    l_gpu, g_gpu = value_and_grad(loss_fn, tree_map(torch.Tensor.cuda, params),
                                  cfg, shard_batch(batch, device="cuda"))
    loss_rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    worst, where = 0.0, None
    for (path, a), b in zip(leaves_with_path(g_cpu), leaves(g_gpu)):
        rel = max_err(b.cpu(), a) / max(a.abs().max().item(), 1e-30)
        if rel >= worst:
            worst, where = rel, "/".join(map(str, path))
    ok = loss_rel <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL
    print(f"  reduced f32 step, card vs CPU: loss {float(l_gpu):.7f} vs "
          f"{float(l_cpu):.7f} (relative {loss_rel:.2e}, limit "
          f"{TRAIN_LOSS_TOL:g}); gradients worst {worst:.2e} of a leaf's "
          f"largest at {where} (limit {TRAIN_GRAD_TOL:g}): "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the card's train step differs from the CPU's")
    return dict(loss_rel=loss_rel, grad_worst=worst, grad_worst_leaf=where)


def train_restart(seed):
    """Full width at ``RESTART_LAYERS`` layers, int8 moments and gradients:
    ``RESTART_STEPS`` steps at once against ``RESTART_AT`` steps, a
    checkpoint, and a new state restored from it for the rest."""
    cfg = get_config(TRAIN_ARCH, n_layers=RESTART_LAYERS)
    opt, step = train_setup(cfg, True, RESTART_STEPS)
    data = SyntheticLMData(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=seed)
    full, _ = train_loop.run(step, train_state(cfg, opt, seed), data,
                             steps=RESTART_STEPS, log_every=0)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        train_loop.run(step, train_state(cfg, opt, seed), data,
                       steps=RESTART_AT, ckpt_dir=d, ckpt_every=RESTART_AT,
                       log_every=0)
        t1 = time.perf_counter()
        resumed, hist = train_loop.run(step, train_state(cfg, opt, seed),
                                       data, steps=RESTART_STEPS, ckpt_dir=d,
                                       ckpt_every=100, log_every=0)
        t2 = time.perf_counter()
        ckpt_bytes = sum(f.stat().st_size for f in Path(d).rglob("*")
                         if f.is_file())
    a = full["params"]["final_norm"].float()
    b = resumed["params"]["final_norm"].float()
    ok = (len(hist["loss"]) == RESTART_STEPS - RESTART_AT
          and torch.allclose(b, a, rtol=RESTART_RTOL, atol=0))
    same = all(torch.equal(x, y) for x, y in zip(leaves(full),
                                                  leaves(resumed)))
    print(f"  restart ({RESTART_LAYERS} layers, full width, int8): "
          f"{RESTART_AT} steps + a {ckpt_bytes:,}-byte checkpoint "
          f"({t1 - t0:.1f} s) + restore and {len(hist['loss'])} steps "
          f"({t2 - t1:.1f} s) → final_norm within rtol {RESTART_RTOL:g} of "
          f"{RESTART_STEPS} steps at once: {'ok' if ok else 'FAIL'}; "
          f"whole state bit for bit: {same}")
    if not ok:
        raise RuntimeError("restart from the checkpoint is not exact")
    return dict(ok=ok, bit_for_bit=same, ckpt_bytes=ckpt_bytes,
                first_s=t1 - t0, resumed_s=t2 - t1)


def training(seed: int, smi: str, timer, gen):
    """Phase 11: full-width qwen3-0.6b trained with f32 moments, then with
    int8 moments and int8 gradients (K7); K7 at the trained leaf shapes;
    the reduced f32 step on the card vs the CPU; the restart."""
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    print(f"  {TRAIN_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size:,}, bf16, remat {cfg.remat}; {smi}")
    out = {}
    for label, int8 in (("f32 moments", False),
                        ("int8 moments + int8 gradients", True)):
        out[label] = train_run(label, cfg, seed, int8, smi)
        torch.cuda.empty_cache()
    out["k7_rows"] = k7_training_shapes(timer, gen)
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = train_card_vs_cpu(seed)
    out["restart"] = train_restart(seed)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 11 seconds: {out['seconds']:.1f}")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the autotune
# ---------------------------------------------------------------------------
AUTOTUNE_ARCH = "qwen2-0.5b"
AUTOTUNE_BUDGET_S = 90.0   # the phase's limit: over it, the script fails
# the engine's page size, chunk and pages per step before its autotune
FIXED_ENGINE = dict(page_size=16, prefill_chunk=256, pages_per_step=1)
HOST_CALLS = 2000          # K1 calls a host-cost sample
HOST_SHAPE = (8, 896, 4864)    # (M, K, N): the decode gate
SERVED_CONTEXT = PROMPT_LEN + NEW // 2   # the mix's mean decode context


@contextlib.contextmanager
def seed_plans(path: Path):
    """The GEMMs' plans as before any tuning: the autotune's cache pointed
    at the empty file ``path``, so every wrapper launches its seed; the
    warmed cache comes back from its file afterwards."""
    saved = os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(path)
    autotune.clear_cache()
    try:
        yield
    finally:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = saved
        autotune.clear_cache()


def check_plan_smem():
    """``PlanConfig.smem_bytes`` against the built library's
    ``camp_gemm_tc_smem``, every row tile and B kind."""
    for w4 in (False, True):
        for mt in blocking.TC_ROW_TILES:
            want = k5.tc_smem_bytes(w4, mt)
            got = blocking.PlanConfig(mt, 1, 1, 0).smem_bytes(w4)
            if got != want or got > blocking.SMEM_PER_BLOCK:
                raise RuntimeError(f"smem_bytes(w4={w4}, MT {mt}) = {got}, "
                                   f"the library's {want}")
    print("  PlanConfig.smem_bytes equals camp_gemm_tc_smem at every row "
          "tile and B kind")


def tune_pages(cfg):
    """(d) the engine's page size, chunk and pages per step for ``cfg``,
    tuned on an empty cache the way the engine tunes them: K3's rounds at
    each page size and the spread that decides, the chunk model's scores;
    the engine built with no pins must take them. Then, deciding nothing,
    K3's rounds at the served mix's context, for comparison."""
    mean_len = max(cfg.max_seq_len // 2, 128)
    group = cfg.n_heads // cfg.n_kv_heads
    t0 = time.perf_counter()
    ps = autotune.get_page_size(cfg.n_kv_heads, cfg.hd, mean_len=mean_len,
                                group=group)
    chunk, pp = autotune.get_prefill_params(cfg.n_kv_heads, cfg.hd, ps,
                                            mean_len=mean_len)
    secs = time.perf_counter() - t0
    pages = autotune.cached_entries("pattn|")
    chunks = autotune.cached_entries("pprefill|")
    if (len(pages), len(chunks)) != (1, 1):
        raise RuntimeError(f"page and chunk entries: {pages}, {chunks}")
    (page_key, page), = pages.items()
    (chunk_key, chunked), = chunks.items()
    if (page["source"], chunked["source"]) != ("measured", "model"):
        raise RuntimeError(f"page and chunk entries: {pages}, {chunks}")

    def rounds(times, med):
        return ", ".join(f"{p}: {med[p] * 1e6:.2f} ({min(ts) * 1e6:.2f}-"
                         f"{max(ts) * 1e6:.2f})" for p, ts in times.items())
    times = {int(p): [t * 1e-6 for t in ts]
             for p, ts in page["rounds_us"].items()}
    _, med, spread = autotune.pick_measured_page(times)
    print(f"  {page_key}: K3 µs by page size, median (min-max) of "
          f"{autotune.PAGE_ROUNDS} rounds: {rounds(times, med)}; spread "
          f"{spread:.2%} → page {ps}")
    per_chunk = {c: chunked["scores_us"][f"{c},1"]
                 for c in autotune.PREFILL_CHUNKS}
    print(f"  {chunk_key}: the model's µs a token by chunk "
          + ", ".join(f"{c}: {t:.4f}" for c, t in per_chunk.items())
          + f" → chunk {chunk}, pages per step {pp}; tuned in {secs:.2f} s")
    served = autotune.measure_page_sizes(N_REQ, cfg.n_kv_heads, cfg.hd,
                                         SERVED_CONTEXT, group)
    s_ps, s_med, s_spread = autotune.pick_measured_page(served)
    print(f"  at the served mix's context ({SERVED_CONTEXT} tokens, "
          f"deciding nothing): K3 µs {rounds(served, s_med)}; spread "
          f"{s_spread:.2%} → page {s_ps}")
    return dict(page_size=ps, chunk=chunk, pages_per_step=pp, seconds=secs,
                mean_len=mean_len, group=group, page_us=page["scores_us"],
                page_rounds_us=page["rounds_us"], page_spread=spread,
                chunk_model_us_per_token=per_chunk,
                served_context=dict(
                    tokens=SERVED_CONTEXT, page_size=s_ps, spread=s_spread,
                    median_us={p: t * 1e6 for p, t in s_med.items()}))


def gemm_bound(qmode, m, n, k, a_in_bytes=2):
    """The fused GEMM's bound: x, W, W's scales and the bf16 output moved
    once, 2·M·N·K int8 operations."""
    w_bytes = k * n if qmode == "w8a8" else k // 2 * n
    return bound(m * k * a_in_bytes + w_bytes + 4 * n + 2 * m * n,
                 2.0 * m * n * k, INT8_OPS_PER_S)


def warm_and_hold(timer, gen, qmode, cfg, **warm_kw):
    """(a) ``warm_gemm_autotune`` for ``cfg`` in ``qmode``; at every shape
    it tuned: the seed's and the winner's µs (the tuner's own medians, and
    again by ``timer``), the analytic model's pick and the bound. (b)
    every candidate's output equal bit for bit to the plain version's (so
    the winner's equals the seed's too)."""
    key, name = FUSED[qmode]
    kind = k1.KIND[qmode]
    kernel, plain = getattr(k1, name), getattr(k1, name + "_ref")
    t0 = time.perf_counter()
    tuned = engine_mod.warm_gemm_autotune(cfg, **warm_kw)
    secs = time.perf_counter() - t0
    print(f"  {key}: warm_gemm_autotune({warm_kw}) tuned {len(tuned)} "
          f"shapes in {secs:.2f} s")
    rows = []
    for (m, n, k), won in tuned:
        w = _weight(gen, k, n, qmode != "w8a8")
        s_b = torch.rand(1, n, device="cuda", generator=gen) * 0.01 + 1e-4
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        kw = dict(out_dtype=torch.bfloat16)
        want = plain(x, w, s_b, **kw)
        cands = autotune.candidates(kind, m, n, k, fused=True)
        seed = cands[0]
        if won not in cands:
            raise RuntimeError(f"{key} {(m, n, k)}: {won} is no candidate")
        differ = [p for p in cands
                  if not torch.equal(kernel(x, w, s_b, plan=p, **kw), want)]
        if differ:
            raise RuntimeError(f"{key} {(m, n, k)}: plans {differ} differ "
                               f"from the plain version")
        model = min(cands, key=lambda p: autotune.model_time_s(
            kind, m, n, k, p, fused=True, a_in_bytes=2))
        (entry,) = autotune.cached_entries(
            f"{kind}|fused-a2B|m{m}|n{n}|k{k}|").values()
        seed_ms = timer(lambda: kernel(x, w, s_b, plan=seed, **kw))
        won_ms = (seed_ms if won == seed
                  else timer(lambda: kernel(x, w, s_b, plan=won, **kw)))
        b_ms, b_by = gemm_bound(qmode, m, n, k)
        print(f"  {key:7s} M={m} N={n} K={k}: seed {tuple(seed)} "
              f"{entry['seed_us']:.2f} µs, winner {tuple(won)} "
              f"{entry['t_us']:.2f} µs (again: {seed_ms * 1e3:.2f} / "
              f"{won_ms * 1e3:.2f} µs); model picks {tuple(model)}; bound "
              f"{b_ms * 1e3:.2f} µs ({b_by}); {len(cands)} candidates "
              f"exact")
        rows.append(dict(kernel=key, m=m, n=n, k=k, seed=list(seed),
                         winner=list(won), model=list(model),
                         tuner_seed_us=entry["seed_us"],
                         tuner_winner_us=entry["t_us"],
                         seed_us=seed_ms * 1e3, winner_us=won_ms * 1e3,
                         bound_us=b_ms * 1e3, bound_by=b_by,
                         candidates=len(cands)))
    return rows, secs


def split_scales_control(gen, rows):
    """(c) the check of (b) at a warmed shape with several splits, under a
    plan that takes each split's row scales from its own K range
    (``SPLIT_SCALES``, wrong on purpose): it must fail."""
    row = next((r for r in rows if r["kernel"] == "K1" and r["seed"][1] > 1),
               None)
    if row is None:
        raise RuntimeError("no tuned K1 shape has several splits")
    m, n, k = row["m"], row["n"], row["k"]
    mt, splits, per, _ = row["seed"]
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w = _weight(gen, k, n, False)
    s_b = torch.rand(1, n, device="cuda", generator=gen) * 0.01 + 1e-4
    bad = blocking.PlanConfig(mt, splits, per, blocking.SPLIT_SCALES)
    got = k1.camp_gemm_fused_w8a8(x, w, s_b, out_dtype=torch.bfloat16,
                                  plan=bad)
    want = k1.camp_gemm_fused_w8a8_ref(x, w, s_b, out_dtype=torch.bfloat16)
    caught = not torch.equal(got, want)
    print(f"  control: K1 M={m} N={n} K={k} under {tuple(bad)}: err="
          f"{max_err(got, want):.3g}, {'caught' if caught else 'NOT CAUGHT'}")
    if not caught:
        raise RuntimeError("the exact check passes split-local scales")
    return dict(m=m, n=n, k=k, plan=list(bad), max_abs_err=max_err(got, want))


def row_gap(a, b) -> float:
    """Largest |difference| of two runs' logits rows of one context (each
    stream up to its first divergence), as a share of that row's max
    |logit|."""
    gap = 0.0
    for i, (s, t) in enumerate(zip(a["streams"], b["streams"])):
        n = next((j for j, (x, y) in enumerate(zip(s, t)) if x != y), None)
        for j in range(len(s) if n is None else n + 1):
            ra, rb = a["rows"][(i, j)], b["rows"][(i, j)]
            gap = max(gap, float(np.abs(ra - rb).max() / np.abs(rb).max()))
    return gap


@contextlib.contextmanager
def one_split():
    """K2 and K3 with all of a row block's kv tiles in one split (the plan
    that f32 always takes): no split partials to merge, so a row's output
    depends on its context alone, not on the chunk or the pool around
    it."""
    saved = k2.plan_for, k3.plan_for
    k2.plan_for = k3.plan_for = lambda q, n_bh, rows, tiles: (1, tiles)
    try:
        yield
    finally:
        k2.plan_for, k3.plan_for = saved


def tuned_serving(seed: int, pages: dict, cold: Path):
    """(e) phase 3's W8A8 mix on the engine with its tuned defaults and the
    warmed GEMM plans ("tuned") against the engine as it ran before its
    autotune: page 16, chunk 256, the seed plans ("fixed").
    * Every K1, K2 and K3 call of one 768-token request (chunks of 512
      and 256) and its decode steps on the tuned engine, held against its
      plain version on the same inputs (``check_in_situ``).
    * "tuned plans" (the warmed plans at page 16 and chunk 256) against
      "fixed": every plan gives the same output bit for bit, so the
      streams and every logits row must be equal.
    * The chunk and the page size change K2's and K3's split plans
      (``split_plan``: the splits follow the blocks of query rows and the
      kv tiles), so the f32 merge order of the split partials. Witness:
      with both kernels held to one split, "tuned" and "fixed" must give
      the same streams and logits rows bit for bit. The plain versions'
      engines at the two settings are printed beside them.
    * The issue's criterion, streams equal or first differing within
      phase 8's one-ULP bound, is printed as met or not; the gate is the
      tuned engine's rows within W8A8's ``LOGIT_TOL`` of the fixed
      engine's, and another request's row beyond it.
    Then "tuned" and "fixed" in turns."""
    cfg = get_config(AUTOTUNE_ARCH, qmode="w8a8")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = quantize_params(init_params(cfg, generator=gen, device="cuda"),
                             cfg, "w8a8")
    prompts = torch.randint(0, cfg.vocab_size, (N_REQ, PROMPT_LEN),
                            generator=gen, device="cuda")
    prompts[1, :PREFIX_LEN] = prompts[0, :PREFIX_LEN]

    def engine(tuned: bool, impl: str = "auto"):
        ps = pages["page_size"] if tuned else FIXED_ENGINE["page_size"]
        pins = {} if tuned else FIXED_ENGINE

        def make():
            eng = ContinuousBatchingEngine(
                params, cfg, kv_dtype="int8", capacity_tokens=N_REQ
                * kvc.round_up(PROMPT_LEN + NEW, ps), device="cuda",
                impl=impl, **pins)
            got = (eng.pool.page_size, eng.chunk_tokens, eng.pages_per_step)
            want = ((pages["page_size"], pages["chunk"],
                     pages["pages_per_step"]) if tuned
                    else tuple(FIXED_ENGINE.values()))
            if got != want:
                raise RuntimeError(f"engine (page, chunk, pages per step) "
                                   f"{got}, expected {want}")
            return eng
        return make

    # label → (engine factory, seed plans, one split)
    runs = {"tuned": (engine(True), False, False),
            "tuned plans": (engine(False), False, False),
            "fixed": (engine(False), True, False),
            "tuned, one split": (engine(True), False, True),
            "fixed, one split": (engine(False), True, True),
            "plain versions, tuned": (engine(True, "torch"), False, False),
            "plain versions, fixed": (engine(False, "torch"), False, False)}

    def run(label, fn):
        make, seeds, split = runs[label]
        with contextlib.ExitStack() as stack:
            if seeds:
                stack.enter_context(seed_plans(cold))
            if split:
                stack.enter_context(one_split())
            return fn(make)
    for label in runs:                      # first-use costs
        run(label, lambda mk: run_workload(mk(), prompts[:1, :40], 2))
    long_prompt = torch.cat([prompts[0], prompts[2, :256]])
    in_situ = check_in_situ(runs["tuned"][0], long_prompt, "w8a8")
    recorded = {label: run(label, lambda mk: spec_run(mk, prompts, NEW,
                                                      rows=True))
                for label in runs}
    for label, r in recorded.items():
        want = set() if label.startswith("plain") else set(PATHS["w8a8"])
        if set(r["launches"]) != want:
            raise RuntimeError(f"{label} launched {r['launches']}")
    for a, b in (("tuned plans", "fixed"),
                 ("tuned, one split", "fixed, one split")):
        divs, row_diff, _ = greedy_parity(f"{a} vs {b}", recorded[a],
                                          recorded[b])
        if divs or row_diff:
            raise RuntimeError(f"{a} and {b} differ")
    divs, row_diff, parity = greedy_parity(
        "tuned vs fixed", recorded["tuned"], recorded["fixed"])
    gap = row_gap(recorded["tuned"], recorded["fixed"])
    plain_divs, _, plain_parity = greedy_parity(
        "plain versions, tuned vs fixed", recorded["plain versions, tuned"],
        recorded["plain versions, fixed"])
    plain_gap = row_gap(recorded["plain versions, tuned"],
                        recorded["plain versions, fixed"])
    print(f"  tuned vs fixed: rows of one context within {gap:.2%} of max "
          f"|logit| (limit {LOGIT_TOL['w8a8']:.0%}; the plain versions' "
          f"engines {plain_gap:.2%}); the issue's greedy parity "
          f"{'met' if parity else 'NOT MET'}: {len(divs)} of {N_REQ} "
          f"streams differ, {sum(d['deficit'] > d['limit'] for d in divs)} "
          f"beyond one bf16 ULP of the max")
    # control: another request's first row is another context
    rows = recorded["fixed"]["rows"]
    other = min(float(np.abs(rows[(i, 0)] - rows[((i + 1) % N_REQ, 0)]).max()
                      / np.abs(rows[((i + 1) % N_REQ, 0)]).max())
                for i in range(N_REQ))
    print(f"  control: a request's first row against the next request's, "
          f"at least {other:.2%} apart")
    if gap > LOGIT_TOL["w8a8"] or other <= LOGIT_TOL["w8a8"]:
        raise RuntimeError(f"tuned vs fixed logits {gap:.2%} apart, "
                           f"other contexts {other:.2%}")
    turns = {"tuned": [], "fixed": []}
    for label in ("tuned", "fixed", "fixed", "tuned"):
        wall, ttft, shared, _ = run(label,
                                    lambda mk: run_workload(mk(), prompts))
        ps = (pages["page_size"] if label == "tuned"
              else FIXED_ENGINE["page_size"])
        if shared != PREFIX_LEN // ps:
            raise RuntimeError(f"{label}: {shared} shared pages, expected "
                               f"{PREFIX_LEN // ps}")
        turns[label].append(dict(gen_tok_s=N_REQ * NEW / wall, wall_s=wall,
                                 ttft_s=ttft, shared_pages=shared))
        print(f"  {label}: {N_REQ * NEW / wall:.1f} generated tok/s, wall "
              f"{wall:.3f} s, TTFT first/median/last {ttft[0]:.3f}/"
              f"{ttft[N_REQ // 2]:.3f}/{ttft[-1]:.3f} s, pages shared "
              f"{shared}")
    return dict(in_situ=in_situ, divergences=divs, row_max_diff=row_diff,
                row_gap=gap, issue_parity_met=parity,
                plain_divergences=plain_divs, plain_parity=plain_parity,
                plain_row_gap=plain_gap, other_context_gap=other,
                turns=turns,
                launches={k: r["launches"] for k, r in recorded.items()})


def host_cost(gen):
    """(f) host µs a K1 call at the decode gate (M 8, K 896, N 4,864,
    silu): the plan computed per call as before (``plan_for``), against
    the cache lookup of ``get_plan``; in turns. The card runs each call
    in ~16 µs, behind the host, so the host's clock over many calls is
    the host's cost a call."""
    m, k, n = HOST_SHAPE
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w = _weight(gen, k, n, False)
    s_b = torch.rand(1, n, device="cuda", generator=gen) * 0.01 + 1e-4
    kw = dict(out_dtype=torch.bfloat16, epilogue="silu")
    calls = {
        "plan_for": lambda: k1.camp_gemm_fused_w8a8(
            x, w, s_b, plan=k5.plan_for(x, n, k, True), **kw),
        "cache lookup": lambda: k1.camp_gemm_fused_w8a8(x, w, s_b, **kw)}
    us = {label: [] for label in calls}
    for label in ("plan_for", "cache lookup", "cache lookup", "plan_for"):
        fn = calls[label]
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        us[label].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    print("  K1 host µs a call at M 8, K 896, N 4,864: " + "; ".join(
        f"{label} {', '.join(f'{t:.1f}' for t in ts)}"
        for label, ts in us.items()))
    return us


def autotune_phase(seed: int, timer, gen, smi: str):
    """Phase 12: the Hopper autotune on an empty cache of its own (page
    size and chunk, then the GEMM plans of full-width qwen2-0.5b in W8A8,
    W4A8 and W4A4, held bit for bit; the control; the tuned engine against
    the fixed one in turns; the lookup's host cost), within
    ``AUTOTUNE_BUDGET_S``."""
    t0 = time.perf_counter()
    base = Path(os.environ["REPRO_TORCH_AUTOTUNE_CACHE"])
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        base.with_name("phase12.json"))
    autotune.clear_cache()
    cold = base.with_name("empty.json")
    print(f"  {smi}")
    check_plan_smem()
    cfg = get_config(AUTOTUNE_ARCH, qmode="w8a8")
    out = {"pages": tune_pages(cfg), "gemm": [], "warm_seconds": {}}
    for qmode in QMODES:
        qcfg = get_config(AUTOTUNE_ARCH, qmode=qmode)
        for kw in (dict(batch_sizes=(1, 8), prefill_len=0),
                   dict(batch_sizes=(1,),
                        prefill_len=out["pages"]["chunk"])):
            rows, secs = warm_and_hold(timer, gen, qmode, qcfg, **kw)
            out["gemm"] += rows
            out["warm_seconds"][f"{qmode} {kw}"] = secs
    out["control"] = split_scales_control(gen, out["gemm"])
    out["serving"] = tuned_serving(seed, out["pages"], cold)
    out["host_us"] = host_cost(gen)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 12 seconds: {out['seconds']:.1f} (limit "
          f"{AUTOTUNE_BUDGET_S:.0f})")
    if out["seconds"] > AUTOTUNE_BUDGET_S:
        raise RuntimeError(f"phase 12 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: tensor-parallel serving
# ---------------------------------------------------------------------------
TP_ARCH = "qwen2-0.5b"
TP_RANKS = 2             # two processes time-sharing cuda:0 through gloo
TP_NEW = 16              # new tokens a request of phase 3's mix
TP_INDIV_RANKS = 4       # does not divide qwen2-0.5b's 2 kv heads
TP_INDIV_MIX = (2, 128, 8)   # requests, prompt tokens, new tokens
TP_ENGINE = dict(kv_dtype="int8", page_size=16, prefill_chunk=256,
                 pages_per_step=1)
TP_TIMEOUT_S = 300.0     # a spawned group's limit; the phase aims at 120 s
TP_SNAP = 4              # engine step of the mid-flight host state
# K1's (K, N) on a tp 2 rank of full-width qwen2-0.5b, by its epilogue on
# the path: q and k/v column shards (bias), wo and down row shards, the
# gate and up column shards; N 64 lies below the template's 128-wide
# n-tile and K 448 is 3.5 K steps
TP_SHARD_GEMMS = {"bias": ((896, 448), (896, 64)),
                  "none": ((448, 896), (2432, 896)),
                  "silu": ((896, 2432),), "mul": ((896, 2432),)}


def tp_shard_k1(timer, gen):
    """K1 rows, as phase 2's, at the tp 2 shard shapes, M 1, 8 and 256."""
    return [row for epi, kns in TP_SHARD_GEMMS.items()
            for row in check_fused(timer, gen, "w8a8",
                                   [(m, k, n) for m in (1, 8, 256)
                                    for k, n in kns],
                                   (torch.bfloat16,), epilogues=(epi,))]


def tp_build(cfg, seed: int, device, n_req=N_REQ, prompt_len=PROMPT_LEN):
    """Full W8A8 weights from the seed and phase 3's mix after them (two
    requests sharing a ``PREFIX_LEN`` prefix), cut to its first ``n_req``
    requests of ``prompt_len`` tokens (tp 4's two share every page)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = quantize_params(init_params(cfg, generator=gen, device=device),
                             cfg, "w8a8")
    prompts = torch.randint(0, cfg.vocab_size, (N_REQ, PROMPT_LEN),
                            generator=gen, device=device)
    prompts[1, :PREFIX_LEN] = prompts[0, :PREFIX_LEN]
    return params, prompts[:n_req, :prompt_len]


def tp_engine(params, cfg, n_req, prompt_len, new, device, mesh=None, **kw):
    return ContinuousBatchingEngine(
        params, cfg, capacity_tokens=n_req * kvc.round_up(prompt_len + new,
                                                          16),
        mesh=mesh, device=device, **TP_ENGINE, **kw)


def host_state(eng):
    """The replicated scheduler state that must be equal on every rank and
    to a one-process engine's."""
    return {"tables": {k: list(v) for k, v in eng.pool.tables.items()},
            "lens": dict(eng.pool.lens),
            "stats": eng.pool.shared_page_stats(), "free": eng.pool.num_free,
            "retained": eng.pool.num_retained}


def tp_drive(eng, prompts, new, device):
    """The mix on ``eng`` → wall seconds, streams, the host state at step
    ``TP_SNAP`` and at the end."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    sids = [eng.submit(p, new) for p in prompts]
    steps, mid = 0, None
    while eng.step():
        steps += 1
        if steps == TP_SNAP:
            mid = host_state(eng)
    sync()
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, tokens=[eng.finished[s].tokens for s in sids],
                mid=mid, end=host_state(eng),
                gen_tok_s=len(sids) * new / wall)


def tp_expected_k1(cfg, tp: int):
    """The (K, N) of every K1 a rank launches: q, k/v and gate/up column
    shards, wo and down row shards (the tied head is a float product)."""
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    return {(d, cfg.n_heads * hd // tp), (d, cfg.n_kv_heads * hd // tp),
            (cfg.n_heads * hd // tp, d), (d, f // tp), (f // tp, d)}


def tp_wire_check(local, cfg, prompt, mesh):
    """One forward with the int8-wire reduce: every ``quantized_psum`` call
    on the card recorded, then the same call again on CPU copies of its
    partial (gloo takes both) → (calls, max |card − CPU|, the logits)."""
    from repro_torch.models import modules
    from repro_torch.parallel.collectives import quantized_psum
    calls = []

    def spy(y, m, axis="model"):
        out = quantized_psum(y, m, axis)
        calls.append((y.detach().clone(), out.detach().clone()))
        return out
    modules.quantized_psum = spy
    try:
        logits = prefill_last_logits(local, cfg, prompt, "auto", mesh,
                                opts={"tp_int8_reduce": True})
    finally:
        modules.quantized_psum = quantized_psum
    worst = 0.0
    for y, out in calls:
        cpu = quantized_psum(y.cpu(), mesh)
        worst = max(worst, (cpu - out.cpu()).abs().max().item())
    return len(calls), worst, logits


def tp_dropped_partial(local, cfg, prompt, mesh):
    """The control: rank 1 leaves its partial out of every wo / w_down
    reduce (a zero in its place) → the logits."""
    from repro_torch.models import modules
    from repro_torch.parallel.collectives import psum

    def drop(y, m, axis="model"):
        return psum(torch.zeros_like(y) if m.rank == 1 else y, m, axis)
    modules.psum = drop
    try:
        return prefill_last_logits(local, cfg, prompt, "auto", mesh)
    finally:
        modules.psum = psum


def tp_rank(mesh, job):
    """One rank of phase 13: build the weights from the seed, keep this
    rank's shards, serve the mix (twice, for the turns), and with
    ``job['checks']`` the in-situ check with the K1 shapes, the logits
    through the kernels and the plain versions, the dropped-partial
    control and the int8 wire on card vs CPU."""
    device = mesh.device.type
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TP_ARCH, qmode="w8a8")
    n_req, prompt_len, new = job["mix"]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, prompts = tp_build(cfg, job["seed"], mesh.device, n_req,
                               prompt_len)
    local = shard_params(params, mesh, cfg)
    del params
    peak = {}
    if device == "cuda":
        torch.cuda.empty_cache()
        peak["build_gb"] = torch.cuda.max_memory_allocated() / 1e9
        peak["shards_gb"] = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    def make():
        return tp_engine(local, cfg, n_req, prompt_len, new, mesh.device,
                         mesh=mesh)
    warm = make()                        # first-use costs (cuBLAS, caches)
    warm.submit(prompts[0, :40], 2)
    warm.run()
    reset_counts()
    first = tp_drive(make(), prompts, new, device)
    eng = make()
    out = dict(rank=mesh.rank, run=first, peak=peak,
               launches={k: v for k, v in read_counts().items() if v},
               tp=eng.tp, sharded=eng.pool.sharded,
               pages=tuple(eng.pool.k_pages[0].shape),
               w_down=tuple(local["layers"][0]["mlp"]["w_down"].shape),
               vocab_rows=local["embedding"].shape[0])
    if not job["checks"]:
        return out
    out["again"] = tp_drive(make(), prompts, new, device)
    shapes = set()
    gemm = ops.camp_gemm_fused_w8a8

    def record(x, b, *a, **kw):
        shapes.add((x.shape[-1], b.shape[-1]))
        return gemm(x, b, *a, **kw)
    ops.camp_gemm_fused_w8a8 = record
    try:
        out["in_situ"] = check_in_situ(make, prompts[0], "w8a8")
    finally:
        ops.camp_gemm_fused_w8a8 = gemm
    out["k1_shapes"] = sorted(shapes)
    out["logits"] = prefill_last_logits(local, cfg, prompts[0], "auto", mesh)
    out["plain_logits"] = prefill_last_logits(local, cfg, prompts[0], "torch",
                                         mesh)
    out["dropped_logits"] = tp_dropped_partial(local, cfg, prompts[0], mesh)
    out["wire_calls"], out["wire_card_vs_cpu"], out["wire_logits"] = \
        tp_wire_check(local, cfg, prompts[0], mesh)
    if device == "cuda":
        peak["serve_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def tp_spawn(world: int, job: dict, device: str):
    with tempfile.TemporaryDirectory(prefix="tp-") as d:
        return spawn_ranks(tp_rank, world, init_dir=d, backend="gloo",
                           device=device, args=(job,), timeout=TP_TIMEOUT_S)


def tp_gap(got, want) -> float:
    """max |got − want| as a share of max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def tp_serving(seed: int, smi: str, device: str = "cuda"):
    """Phase 13: full-width qwen2-0.5b W8A8 served by ``TP_RANKS`` ranks
    (processes on one card, gloo) against a one-process engine on the
    same mix; then ``TP_INDIV_RANKS`` ranks, which do not divide the kv
    heads. Every failure raises."""
    t0 = time.perf_counter()
    cfg = get_config(TP_ARCH, qmode="w8a8")
    params, prompts = tp_build(cfg, seed, device)
    one = {}
    warm = tp_engine(params, cfg, N_REQ, PROMPT_LEN, TP_NEW, device)
    warm.submit(prompts[0, :40], 2)
    warm.run()
    one["first"] = tp_drive(tp_engine(params, cfg, N_REQ, PROMPT_LEN, TP_NEW,
                                      device), prompts, TP_NEW, device)
    one["logits"] = prefill_last_logits(params, cfg, prompts[0], "auto",
                                   None).cpu().numpy()
    n_i, len_i, new_i = TP_INDIV_MIX
    one["indiv"] = tp_drive(tp_engine(params, cfg, n_i, len_i, new_i,
                                      device), prompts[:n_i, :len_i], new_i,
                            device)
    ranks = tp_spawn(TP_RANKS, dict(seed=seed, checks=True,
                                    mix=(N_REQ, PROMPT_LEN, TP_NEW)), device)
    one["again"] = tp_drive(tp_engine(params, cfg, N_REQ, PROMPT_LEN,
                                      TP_NEW, device), prompts, TP_NEW,
                            device)
    indiv = tp_spawn(TP_INDIV_RANKS, dict(seed=seed, checks=False,
                                          mix=TP_INDIV_MIX), device)
    del params

    fails = []
    want_k1 = tp_expected_k1(cfg, TP_RANKS)
    for r in ranks:
        missing = {"K1", "K2", "K3"} - set(r["launches"])
        if device == "cuda" and missing:
            fails.append(f"rank {r['rank']} launched no {sorted(missing)}")
        if set(map(tuple, r["k1_shapes"])) != want_k1:
            fails.append(f"rank {r['rank']} K1 at {r['k1_shapes']}, the "
                         f"shards are {sorted(want_k1)}")
        if not (r["tp"] == TP_RANKS and r["sharded"]):
            fails.append(f"rank {r['rank']}: tp {r['tp']}, sharded "
                         f"{r['sharded']}")
        for run in ("run", "again"):
            for when in ("mid", "end"):
                if r[run][when] != one["first"][when]:
                    fails.append(f"rank {r['rank']} {run}: host state at "
                                 f"{when} differs from one process's")
        if r["wire_card_vs_cpu"] != 0.0 or not r["wire_calls"]:
            fails.append(f"rank {r['rank']}: quantized_psum card vs CPU "
                         f"{r['wire_card_vs_cpu']} over {r['wire_calls']} "
                         f"calls")
    r0, r1 = ranks
    if r0["run"]["tokens"] != r1["run"]["tokens"]:
        fails.append("the ranks' streams differ")
    tol = LOGIT_TOL["w8a8"]
    gaps = {"kernels_vs_plain": tp_gap(r0["logits"], r0["plain_logits"]),
            "kernels_vs_one_process": tp_gap(r0["logits"], one["logits"]),
            "wire_vs_f32": tp_gap(r0["wire_logits"], r0["logits"]),
            "ranks": tp_gap(r1["logits"], r0["logits"]),
            "control_vs_plain": tp_gap(r0["dropped_logits"],
                                       r0["plain_logits"]),
            "control_vs_one_process": tp_gap(r0["dropped_logits"],
                                             one["logits"])}
    for k in ("kernels_vs_plain", "kernels_vs_one_process"):
        if gaps[k] > tol:
            fails.append(f"logits {k} {gaps[k]:.2%} > {tol:.0%}")
    if gaps["ranks"] != 0.0:
        fails.append(f"the ranks' logits differ by {gaps['ranks']:.3g}")
    for k in ("control_vs_plain", "control_vs_one_process"):
        if gaps[k] <= tol:
            fails.append(f"the dropped-partial control passed: {k} "
                         f"{gaps[k]:.2%}")
    for r in indiv:
        if r["tp"] != 1 or r["sharded"] or r["pages"][1] != cfg.n_kv_heads:
            fails.append(f"tp {TP_INDIV_RANKS} rank {r['rank']}: tp "
                         f"{r['tp']}, pages {r['pages']}")
        if r["w_down"] != (cfg.d_ff // TP_INDIV_RANKS, cfg.d_model):
            fails.append(f"tp {TP_INDIV_RANKS} rank {r['rank']}: w_down "
                         f"{r['w_down']}")
        for when in ("mid", "end"):
            if r["run"][when] != one["indiv"][when]:
                fails.append(f"tp {TP_INDIV_RANKS} rank {r['rank']}: host "
                             f"state at {when} differs")
    agree = np.mean([a == b for s, t in zip(r0["run"]["tokens"],
                                            one["first"]["tokens"])
                     for a, b in zip(s, t)])
    agree_i = np.mean([a == b for s, t in zip(indiv[0]["run"]["tokens"],
                                              one["indiv"]["tokens"])
                       for a, b in zip(s, t)])
    print(f"  {smi}; two processes time-sharing one card through gloo: no "
          f"tensor-parallel speed")
    for r in ranks:
        print(f"  rank {r['rank']}: launches {r['launches']}, K1 (K, N) "
              f"{r['k1_shapes']}, pages {r['pages']}, w_down {r['w_down']}, "
              f"vocab rows {r['vocab_rows']}, in situ "
              f"{r['in_situ']['calls']} max |diff| "
              f"{r['in_situ']['max_abs_diff']}, memory GB (peak of the "
              f"full build, its shards, peak serving) "
              + "/".join(f"{v:.3f}" for v in r["peak"].values())
              + f", int8 wire card vs CPU {r['wire_card_vs_cpu']} over "
              f"{r['wire_calls']} calls")
    print(f"  logits (share of max |logit|, limit {tol:.0%}): "
          + ", ".join(f"{k} {v:.2%}" for k, v in gaps.items()))
    print(f"  host state equal to one process's at step {TP_SNAP} and at the "
          f"end; streams agree with one process's on {agree:.1%} of tokens")
    print(f"  generated tok/s in turns: one process {one['first']['gen_tok_s']:.1f}, "
          f"tp {TP_RANKS} {r0['run']['gen_tok_s']:.1f} / "
          f"{r0['again']['gen_tok_s']:.1f}, one process "
          f"{one['again']['gen_tok_s']:.1f}")
    print(f"  tp {TP_INDIV_RANKS} (kv heads indivisible): tp "
          f"{indiv[0]['tp']}, pages {indiv[0]['pages']}, w_down "
          f"{indiv[0]['w_down']}, launches {indiv[0]['launches']}, host "
          f"state equal, streams agree on {agree_i:.1%}")
    seconds = time.perf_counter() - t0
    print(f"  phase 13 seconds: {seconds:.1f}")
    if fails:
        raise RuntimeError("phase 13: " + "; ".join(fails))
    ranks = [{k: v for k, v in r.items() if not k.endswith("logits")}
             for r in ranks]               # the rows' values stay out
    return dict(card=smi, ranks=ranks, indiv=indiv, gaps=gaps,
                one_process={k: one[k] for k in ("first", "again", "indiv")},
                agree=agree, agree_indiv=agree_i, seconds=seconds,
                launches=r0["launches"])


# ---------------------------------------------------------------------------
# Phase 13 (continued): every model family under a serving mesh
# ---------------------------------------------------------------------------
TP_MOE_LAYERS = 4        # moonshot-v1-16b-a3b W8A8: full width, 4 of 48
TP_MOE_NEW = 8           # new tokens a request of phase 3's 8 prompts
TP_FFN_TOKENS = 32       # layer 0's MoE FFN check: (1, 32, d) input
# A tp 2 rank's expert GEMMs of moonshot: K1 at the gate/up column shards
# (K d 2,048, N 704 of 1,408), K7 over a layer's E·C rows of its 704 down
# columns and one more holding the whole row's absmax, K5 at the down
# projection's row shards (K 704, N 2,048); M the capacity: 8 for a
# decode batch of 8, 32 for a 256-token chunk
TP_MOE_K1 = ((8, 2048, 704), (32, 2048, 704))
TP_MOE_K7 = ((64 * 8, 705), (64 * 32, 705))
TP_MOE_K5 = ((8, 704, 2048), (32, 704, 2048))


def tp_moe_kernels(timer, gen):
    """K1, K7 and K5 at a tp 2 rank's expert shard shapes, f32 out (as
    ``moe`` calls them), against their plain versions: exact."""
    return (check_fused(timer, gen, "w8a8", TP_MOE_K1, (torch.bfloat16,),
                        out_dtype=torch.float32, epilogues=("none",))
            + check_k7(timer, gen, TP_MOE_K7, (torch.bfloat16,))
            + check_unfused(timer, gen, "i8", TP_MOE_K5, ("none",),
                            torch.float32))


def tp_moe_per_forward(cfg, lane: str, logits: bool) -> dict:
    """A rank's launches in one forward of the MoE model under the mesh:
    K1 for q, k, v, o and every expert's gate and up column shards (and
    the head), K7 once and K5 once an expert for the down projection,
    K2 (prefill) or K3 (decode) once a layer."""
    n, e = cfg.n_layers, cfg.moe_experts
    return {"K1": n * (4 + 2 * e) + int(logits), "K7": n, "K5": n * e,
            "K2" if lane == "prefill" else "K3": n}


def tp_wire_bytes(cfg, tp: int, batch: int, capacity: int) -> dict:
    """Bytes a rank puts on the wire in one decode step of ``batch``
    tokens, from the shapes (each collective's payload): per layer the wo
    and the MoE y reduces (f32, or int8 with the wire), the MoE row MAX
    (one f32 a slot row); the embedding's reduce and the head's gather of
    the rank's logit columns."""
    d, n = cfg.d_model, cfg.n_layers
    rows = cfg.moe_experts * capacity
    return {"reduce_f32": n * 2 * batch * d * 4,
            "reduce_int8": n * 2 * batch * d,
            "row_max": n * rows * 4,
            "embedding": batch * d * 4,
            "logit_gather": batch * cfg.vocab_size // tp * 4}


def tp_moe_ffn(local, cfg, x, mesh):
    """Layer 0's MoE FFN under the mesh on ``x``, and the control that
    quantizes h from this rank's own rows (the shard-local scale of the
    dense FFN's row-parallel down projection)."""
    def run():
        with mesh_context(mesh, make_rules("serve"), mode="serve",
                          layout=local.layout):
            return moe_mod.moe_ffn(local["layers"][0]["moe"], cfg, x,
                                   qmode=cfg.qmode)[0].float().cpu()
    y = run()
    inner = modules_mod.row_absmax
    modules_mod.row_absmax = lambda h2, m, *axis: h2.abs().amax(
        dim=-1, keepdim=True)
    try:
        return y, run()
    finally:
        modules_mod.row_absmax = inner


def tp_moe_part(mesh, job):
    """A rank's MoE serving: build its shards a layer at a time, serve
    the mix (every forward's launches held), in situ, the first-step
    logits, the dropped-partial control and layer 0's FFN check."""
    cfg = get_config(MOE_ARCH, qmode="w8a8", n_layers=TP_MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    local = init_quantized_params(
        cfg, "w8a8", generator=torch.Generator(device="cuda").manual_seed(
            job["seed"]), device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    peak = {"build_gb": torch.cuda.max_memory_allocated() / 1e9,
            "shards_gb": torch.cuda.memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    prompts = job["prompts"].to("cuda")
    n_req, prompt_len = prompts.shape

    def make():
        return tp_engine(local, cfg, n_req, prompt_len, TP_MOE_NEW, "cuda",
                         mesh=mesh)
    warm = make()
    warm.submit(prompts[0, :40], 2)
    warm.run()
    reset_counts()
    with forward_launches() as recs:
        run = tp_drive(make(), prompts, TP_MOE_NEW, "cuda")
    launches = {k: v for k, v in read_counts().items() if v}
    bad = [r for r in recs if r["launches"] != tp_moe_per_forward(
        cfg, r["lane"], r["logits"])]
    out = dict(rank=mesh.rank, run=run, launches=launches,
               forwards=len(recs), bad=bad[:2],
               lanes=sorted({r["lane"] for r in recs}),
               layout=sorted(local.layout),
               w_gate=tuple(local["layers"][0]["moe"]["experts"]
                            ["w_gate"].shape),
               w_down=tuple(local["layers"][0]["moe"]["experts"]
                            ["w_down"].shape))
    out["in_situ"] = check_in_situ(make, prompts[0], "w8a8",
                                   unfused=("K7", "K5"))
    out["logits"] = prefill_last_logits(local, cfg, prompts[0], "auto",
                                        mesh).cpu()
    out["dropped_logits"] = tp_dropped_partial(local, cfg, prompts[0],
                                               mesh).cpu()
    out["ffn"], out["ffn_control"] = tp_moe_ffn(local, cfg,
                                                job["ffn_x"].to("cuda"),
                                                mesh)
    peak["serve_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["peak"] = peak
    return out


def tp_families_rank(mesh, job):
    """One rank of phase 13's second spawn: the MoE part."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(moe=tp_moe_part(mesh, job))


def ulp_bf16(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def tp_families(seed: int, smi: str, device: str = "cuda"):
    """Phase 13's second part: moonshot-v1-16b-a3b W8A8 (4 of 48 layers)
    with its experts split over 2 ranks on the paged engine, against one
    process on the same inputs. Every failure raises."""
    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH, qmode="w8a8", n_layers=TP_MOE_LAYERS)
    params = build_layerwise(cfg, "w8a8", seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (N_REQ, PROMPT_LEN),
                            generator=gen, device=device)
    prompts[1, :PREFIX_LEN] = prompts[0, :PREFIX_LEN]   # a shared prefix
    ffn_x = torch.randn((1, TP_FFN_TOKENS, cfg.d_model), generator=gen,
                        device=device).to(torch.bfloat16)
    one = {}
    warm = tp_engine(params, cfg, N_REQ, PROMPT_LEN, TP_MOE_NEW, device)
    warm.submit(prompts[0, :40], 2)
    warm.run()
    one["run"] = tp_drive(tp_engine(params, cfg, N_REQ, PROMPT_LEN,
                                    TP_MOE_NEW, device), prompts, TP_MOE_NEW,
                          device)
    one["logits"] = prefill_last_logits(params, cfg, prompts[0], "auto",
                                        None).cpu()
    one["ffn"] = moe_mod.moe_ffn(params["layers"][0]["moe"], cfg, ffn_x,
                                 qmode="w8a8")[0].float().cpu()
    del params
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    job = dict(seed=seed, prompts=prompts.cpu(), ffn_x=ffn_x.cpu())
    with tempfile.TemporaryDirectory(prefix="tp-families-") as d:
        ranks = spawn_ranks(tp_families_rank, TP_RANKS, init_dir=d,
                            backend="gloo", device=device, args=(job,),
                            timeout=TP_TIMEOUT_S)

    fails = []
    f = cfg.expert_ff
    top = float(one["ffn"].abs().max())
    ulp = ulp_bf16(top)
    tol = LOGIT_TOL["w8a8"]
    gaps = {}
    one_ffn = one["ffn"].numpy()
    for rr in ranks:
        m = rr["moe"]
        r = m["rank"]
        if m["bad"] or m["lanes"] != ["decode", "prefill"]:
            fails.append(f"rank {r}: forwards launched other than expected: "
                         f"{m['bad']} (lanes {m['lanes']})")
        if m["w_gate"] != (cfg.moe_experts, cfg.d_model, f // TP_RANKS) or \
                m["w_down"] != (cfg.moe_experts, f // TP_RANKS, cfg.d_model):
            fails.append(f"rank {r}: expert blocks {m['w_gate']} / "
                         f"{m['w_down']}")
        if "experts" not in m["layout"]:
            fails.append(f"rank {r}: layout {m['layout']}")
        for when in ("mid", "end"):
            if m["run"][when] != one["run"][when]:
                fails.append(f"rank {r}: host state at {when} differs from "
                             f"one process's")
        g = dict(ffn=float(np.abs(m["ffn"] - one_ffn).max()),
                 ffn_control=float(np.abs(m["ffn_control"] - one_ffn).max()),
                 logits=tp_gap(m["logits"], one["logits"]),
                 dropped=tp_gap(m["dropped_logits"], one["logits"]))
        gaps[r] = g
        if g["ffn"] > ulp:
            fails.append(f"rank {r}: MoE FFN {g['ffn']:.4g} from one "
                         f"process's, over one bf16 ULP {ulp:.4g}")
        if g["ffn_control"] <= ulp:
            fails.append(f"rank {r}: the shard-local-scale control passed "
                         f"({g['ffn_control']:.4g} <= {ulp:.4g})")
        if g["logits"] > tol:
            fails.append(f"rank {r}: logits {g['logits']:.2%} > {tol:.0%}")
        if g["dropped"] <= tol:
            fails.append(f"rank {r}: the dropped-partial control passed "
                         f"({g['dropped']:.2%})")
    m0, m1 = ranks[0]["moe"], ranks[1]["moe"]
    if m0["run"]["tokens"] != m1["run"]["tokens"]:
        fails.append("the ranks' MoE streams differ")
    agree = np.mean([a == b for s, t in zip(m0["run"]["tokens"],
                                            one["run"]["tokens"])
                     for a, b in zip(s, t)])
    cap = moe_mod.expert_capacity(N_REQ, cfg)
    wire = tp_wire_bytes(cfg, TP_RANKS, N_REQ, cap)
    print(f"  {MOE_ARCH} W8A8, {cfg.n_layers} of 48 layers, experts split "
          f"over {TP_RANKS} ranks ({smi}; processes sharing the card through "
          f"gloo, no tensor-parallel speed):")
    for rr in ranks:
        m = rr["moe"]
        print(f"  rank {m['rank']}: launches {m['launches']} in "
              f"{m['forwards']} forwards (a forward: "
              f"{tp_moe_per_forward(cfg, 'decode', True)} decode), expert "
              f"blocks gate {m['w_gate']} down {m['w_down']}, layout "
              f"{m['layout']}, in situ {m['in_situ']['calls']} max |diff| "
              f"{m['in_situ']['max_abs_diff']}, memory GB (peak of the "
              f"build, its shards, peak serving) "
              + "/".join(f"{v:.3f}" for v in m["peak"].values()))
        g = gaps[m["rank"]]
        print(f"    layer 0's MoE FFN vs one process: {g['ffn']:.4g} (one "
              f"bf16 ULP of max |y| {top:.4g}: {ulp:.4g}), shard-local-scale "
              f"control {g['ffn_control']:.4g}; first-step logits "
              f"{g['logits']:.2%} of max |logit| (limit {tol:.0%}), "
              f"dropped-partial control {g['dropped']:.2%}")
    print(f"  host state equal to one process's at step {TP_SNAP} and at the "
          f"end; streams agree with one process's on {agree:.1%} of tokens; "
          f"generated tok/s: one process {one['run']['gen_tok_s']:.1f}, "
          f"tp {TP_RANKS} {m0['run']['gen_tok_s']:.1f}")
    print(f"  bytes a rank sends a decode step at B {N_REQ}, capacity {cap} "
          f"(from the shapes): " + ", ".join(f"{k} {v:,}"
                                             for k, v in wire.items()))
    seconds = time.perf_counter() - t0
    print(f"  phase 13 families seconds: {seconds:.1f} (one process "
          f"{one_s:.1f})")
    if fails:
        raise RuntimeError("phase 13 families: " + "; ".join(fails))
    return dict(card=smi, gaps=gaps, ulp=ulp, max_abs_y=top, agree=agree,
                wire_bytes=wire, seconds=seconds, one_process_s=one_s,
                one_process=dict(run=one["run"]),
                ranks=[dict(rank=rr["moe"]["rank"], **{
                    k: v for k, v in rr["moe"].items()
                    if k not in ("logits", "dropped_logits", "ffn",
                                 "ffn_control", "rank")})
                    for rr in ranks],
                launches=m0["launches"])


# ---------------------------------------------------------------------------
# Phase 13 (continued): the dense slab on shards
# ---------------------------------------------------------------------------
# (a) the serve rules on (1, 2): full width, W8A8, each rank on its shards
SLAB_LAYERS = {"rwkv6-7b": 4, "jamba-v0.1-52b": 8, "pixtral-12b": 4}
SLAB_MIX = (2, 256, 8)       # requests, prompt tokens, new tokens
# (b) the decode rules on (1, 4): qwen2-0.5b at full width and depth, its
# int8 slab split along the sequence (4 ranks do not divide 2 kv heads)
SEQ_ARCH = TP_ARCH
SEQ_RANKS = 4
SEQ_MIX = (8, 512, 8)
# (c) the decode rules on (2, 1): moonshot's experts split over data
EXPERT_LAYERS = 4
EXPERT_MIX = (8, 128, 4)
EXPERT_FFN_SHAPE = (8, 32)   # layer 0's MoE check: (8, 32, d) input
# (d) the hillclimb's B2 (experts over model, expert_ff over data) on
# (2, 2): moonshot-v1-16b-a3b at 2 of 48 layers, the mix of (c)
B2_RULES = {"expert": ("model",), "expert_ff": ("data",)}
B2_LAYERS = 2
SLAB_TIMEOUT_S = 420.0
# K5 with int32 out (no flush) at the dense slab's row-parallel shards, (M,
# K, N): rwkv6 / jamba w_down at tp 2 (K 7,168 of 14,336, N 4,096; M a
# decode batch of 2 and a 2 x 256 prefill), pixtral's wo (K 2,048 of
# 4,096, N 5,120), qwen2-0.5b's w_down at tp 4 (K 1,216 of 4,864, N 896;
# M 8 and 8 x 520); K6a / K6b at one shape each (their CPU paths)
INT32_SHAPES = {"i8": ((2, 7168, 4096), (512, 7168, 4096), (2, 2048, 5120),
                       (8, 1216, 896), (4160, 1216, 896)),
                "w4": ((8, 1216, 896),), "a4w4": ((8, 1216, 896),)}
# one bf16 ULP of max |out| plus 2u·max|v| (u = 2^-8): the split softmax
# rounds each rank's exponentials to bf16 before the value product where
# one process rounds the normalised probabilities, so each product term
# may move by a relative 2u; the sums then differ by at most 2u·Σp|v|
SEQ_ATT_U = 2.0 ** -8


def int32_sums(timer, gen):
    """K5 (and K6a / K6b) with int32 out against their plain versions (the
    exact dot), at ``INT32_SHAPES``: exact; library ``_int_mm``; beside
    them the same kernel flushed to bf16 (``flushed_ms``)."""
    rows = []
    for kind, shapes in INT32_SHAPES.items():
        key, kernel, plain = UNFUSED[kind]

        def library(a, w, s_a, s_b, **kw):
            k = w.shape[0] * (1 if kind == "i8" else 2)
            a_q = unpack_int4(a.T, k).T if kind == "a4w4" else a
            b_q = w if kind == "i8" else unpack_int4(w, k)
            return int_mm(a_q.contiguous(), b_q)
        for m, k, n in shapes:
            args = _unfused_inputs(gen, kind, m, k, n)
            kw = dict(out_dtype=torch.int32, epilogue="none", bias=None,
                      operand=None)
            row = gemm_case(timer, key, kernel, plain, library, args, kw,
                            2.0 * m * n * k, dict(m=m, k=k, n=n))
            flushed = timer(lambda: kernel(*args, **dict(
                kw, out_dtype=torch.bfloat16)))
            print(f"    flushed to bf16: ms={flushed:.4f}")
            rows.append(dict(row, int32=True, flushed_ms=flushed))
    return rows


@contextlib.contextmanager
def gloo_calls():
    """Count this process's collective calls (the functions
    ``parallel.collectives`` calls); yields the count dict."""
    dist = torch.distributed
    names = ("all_reduce", "all_gather", "broadcast", "all_to_all_single",
             "reduce_scatter")
    saved = {n: getattr(dist, n) for n in names}
    seen = {"calls": 0}

    def wrap(fn):
        def call(*a, **kw):
            seen["calls"] += 1
            return fn(*a, **kw)
        return call
    for n, fn in saved.items():
        setattr(dist, n, wrap(fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


@contextlib.contextmanager
def per_forward(seen):
    """The kernel launches and collective calls (``seen``) of every forward
    the dense slab's steps run (``engine.forward``)."""
    recs, inner = [], engine_mod.forward

    def call(*a, **kw):
        before, calls = read_counts(), seen["calls"]
        out = inner(*a, **kw)
        after = read_counts()
        recs.append(dict(decode=kw.get("cache_pos") is not None,
                         calls=seen["calls"] - calls,
                         launches={k: after[k] - before[k] for k in after
                                   if after[k] != before[k]}))
        return out
    engine_mod.forward = call
    try:
        yield recs
    finally:
        engine_mod.forward = inner


def slab_loop(params, cfg, prompts, new, mesh=None, rules=None,
              kv_dtype=None, seen=None):
    """The dense-slab loop through ``build_prefill_step`` /
    ``build_decode_step`` (greedy), one process or this rank (its rows,
    caches, in ``slab_context``) → (tokens, prefill logits, caches, the
    forwards' records)."""
    b, s = prompts.shape[:2]
    rules = rules or make_rules("serve")
    scope = contextlib.nullcontext()
    if mesh is not None:
        scope = engine_mod.slab_context(mesh, params.layout, rules)
        prompts = batch_block(prompts, mesh, rules)
    caches = init_serve_caches(cfg, b, s + new, kv_dtype=kv_dtype,
                               device="cuda", mesh=mesh, rules=rules)
    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
    seen = seen if seen is not None else {"calls": 0}
    with scope, per_forward(seen) as recs:
        last, caches = prefill(params, prompts, caches)
        tok = last.float().argmax(dim=-1)[:, None]
        toks = [tok]
        for i in range(new - 1):
            tok, caches = decode(params, caches, tok, s + i)
            toks.append(tok)
    torch.cuda.synchronize()
    return torch.cat(toks, 1).cpu(), last.float().cpu(), caches, recs


@contextlib.contextmanager
def first_call(mod, name, when=lambda a, kw: True):
    """Record the first call of ``mod.name`` that ``when`` accepts (args,
    kwargs, output)."""
    inner, got = getattr(mod, name), []

    def call(*a, **kw):
        out = inner(*a, **kw)
        if not got and when(a, kw):
            got.append((a, kw, out))
        return out
    setattr(mod, name, call)
    try:
        yield got
    finally:
        setattr(mod, name, inner)


def sum_pv(q, k, v, q_pos, k_pos, *, k_len):
    """Σ_t p_t |v_t| of ``attention._grouped_attn``'s call, elementwise in
    its output's shape (B,S,KV,G,hd), f32: the bound's weight."""
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    mask = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] < k_len)
    p = torch.softmax(torch.where(mask[None, None, None], scores,
                                  torch.full_like(scores, -1e30)), dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", p, v.float().abs())


def att_gap(got, want, spv) -> float:
    """The largest share of the bound ``one bf16 ULP of |want| +
    SEQ_ATT_U·Σp|v|`` that ``got`` takes, elementwise (≤ 1: within)."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30)))
                     - 7)
    return float(((got - want).abs() / (ulp + SEQ_ATT_U * spv)).max())


def slab_part_a(mesh, job):
    """(a) A (1, 2) rank: each model built from the seed a layer at a
    time, keeping its shards, through ``generate(mesh=)``."""
    out = {}
    for arch, layers in SLAB_LAYERS.items():
        cfg = get_config(arch, qmode="w8a8", n_layers=layers)
        local = init_quantized_params(
            cfg, "w8a8", generator=torch.Generator(device="cuda").manual_seed(
                job["seed"]), device="cuda", mesh=mesh)
        prompts = job["slab_prompts"][arch].to("cuda")
        generate(local, cfg, prompts[:1, :16], steps=2, mesh=mesh,
                 device="cuda")                                 # warm
        reset_counts()
        with gloo_calls() as seen, per_forward(seen) as recs:
            toks = generate(local, cfg, prompts, steps=SLAB_MIX[2],
                            mesh=mesh, device="cuda")
        dec = [r for r in recs if r["decode"]]
        out[arch] = dict(tokens=toks, layout=sorted(local.layout),
                         bytes=tree_bytes(local),
                         whole_bytes=local.whole_bytes,
                         launches={k: v for k, v in read_counts().items()
                                   if v},
                         decode_calls=dec[-1]["calls"] + 1,   # + the tokens
                         decode_launches=dec[-1]["launches"])
        del local
        torch.cuda.empty_cache()
    return out


def slab_part_b(mesh, job):
    """(b) A (1, 4) rank under the decode rules: qwen2-0.5b's shards, its
    block of the int8 slab's positions; layer 0's attention at the first
    decode step and the control that drops rank 1's partial there."""
    cfg = get_config(SEQ_ARCH, qmode="w8a8")
    rules = make_rules("decode")
    with mesh_context(mesh, rules, mode="dense"):     # the slab's shards
        local = init_quantized_params(
            cfg, "w8a8", generator=torch.Generator(
                device="cuda").manual_seed(job["seed"]), device="cuda",
            mesh=mesh)
    prompts = job["seq_prompts"].to("cuda")
    slab_loop(local, cfg, prompts[:, :32], 2, mesh, rules, "int8")  # warm
    reset_counts()
    with gloo_calls() as seen, first_call(attn_mod, "seq_split_attn") as att:
        toks, last, caches, recs = slab_loop(local, cfg, prompts,
                                             SEQ_MIX[2], mesh, rules,
                                             "int8", seen)
    (a, kw, y), = att
    control = attn_mod.seq_split_attn(*a, **dict(kw, drop_rank=1))
    c = caches[0]["attn"]
    slab = sum(tree_bytes(cc["attn"]) for cc in caches)
    dec = [r for r in recs if r["decode"]]
    return dict(tokens=toks, prefill_logits=last, att=y.float().cpu(),
                control=control.float().cpu(),
                slab=dict(k=tuple(c.k.shape), start=c.start,
                          k_scale=tuple(c.k_scale.shape), bytes=slab),
                launches={k: v for k, v in read_counts().items() if v},
                decode_calls=dec[-1]["calls"],
                decode_launches=dec[-1]["launches"],
                layout=sorted(local.layout))


def slab_part_c(mesh, job):
    """(c) A (2, 1) rank under the decode rules: moonshot's experts
    split over data (each rank's E/2 experts over every rank's slots):
    layer 0's MoE FFN on its rows (its K1 launches counted), the
    stream."""
    cfg = get_config(MOE_ARCH, qmode="w8a8", n_layers=EXPERT_LAYERS)
    rules = make_rules("decode")
    local = init_quantized_params(
        cfg, "w8a8", generator=torch.Generator(device="cuda").manual_seed(
            job["seed"]), device="cuda", mesh=mesh)
    x = batch_block(job["expert_x"].to("cuda"), mesh, rules)
    with engine_mod.slab_context(mesh, local.layout, rules):
        moe_mod.moe_ffn(local["layers"][0]["moe"], cfg, x, qmode="w8a8")
        reset_counts()
        y, _ = moe_mod.moe_ffn(local["layers"][0]["moe"], cfg, x,
                               qmode="w8a8")
        torch.cuda.synchronize()
        ffn_k1 = read_counts()["K1"]
    prompts = job["expert_prompts"].to("cuda")
    slab_loop(local, cfg, prompts[:, :16], 2, mesh, rules)            # warm
    reset_counts()
    with gloo_calls() as seen:
        toks, last, _, recs = slab_loop(local, cfg, prompts, EXPERT_MIX[2],
                                        mesh, rules, seen=seen)
    dec = [r for r in recs if r["decode"]]
    return dict(tokens=toks, ffn=y.float().cpu(), ffn_k1=ffn_k1,
                launches={k: v for k, v in read_counts().items() if v},
                decode_calls=dec[-1]["calls"],
                decode_launches=dec[-1]["launches"])


def slab_part_d(mesh, job):
    """(d) A (2, 2) rank under the decode rules with the hillclimb's B2
    override: moonshot's weights as those rules place them (every
    expert's column block over model), each model rank running its
    experts block on its data rank's expert_ff block for every data
    rank's slots (``moe._experts_over_model``); the stream."""
    cfg = get_config(MOE_ARCH, qmode="w8a8", n_layers=B2_LAYERS)
    rules = {**make_rules("decode"), **B2_RULES}
    with mesh_context(mesh, rules, mode="dense"):     # the slab's shards
        local = init_quantized_params(
            cfg, "w8a8", generator=torch.Generator(
                device="cuda").manual_seed(job["seed"]), device="cuda",
            mesh=mesh)
    prompts = job["expert_prompts"].to("cuda")
    slab_loop(local, cfg, prompts[:, :16], 2, mesh, rules)            # warm
    reset_counts()
    with gloo_calls() as seen:
        toks, _, _, recs = slab_loop(local, cfg, prompts, EXPERT_MIX[2],
                                     mesh, rules, seen=seen)
    dec = [r for r in recs if r["decode"]]
    return dict(tokens=toks, bytes=tree_bytes(local),
                launches={k: v for k, v in read_counts().items() if v},
                decode_calls=dec[-1]["calls"],
                decode_launches=dec[-1]["launches"])


def slab_rank(mesh, job):
    """One rank of the dense-slab spawn, four ranks on one card through
    gloo: (b) on the whole (1, 4) mesh; then ranks 0-1 run (a) as a (1, 2)
    mesh while ranks 2-3 run (c) as a (2, 1) mesh; then all four (d) as a
    (2, 2) mesh."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": mesh.rank, "b": slab_part_b(mesh, job)}
    torch.cuda.empty_cache()
    pairs = [torch.distributed.new_group([0, 1]),
             torch.distributed.new_group([2, 3])]
    r = mesh.rank
    group = pairs[r // 2]
    if r < 2:
        pair = RankMesh({"data": 1, "model": 2}, r, group, {"model": group},
                        mesh.device)
        out["a"] = slab_part_a(pair, job)
    else:
        pair = RankMesh({"data": 2, "model": 1}, r - 2, group,
                        {"data": group}, mesh.device)
        out["c"] = slab_part_c(pair, job)
    del pair
    torch.cuda.empty_cache()
    out["d"] = slab_part_d(make_mesh((2, 2), device=mesh.device), job)
    return out


def slab_one_process(seed: int, device: str = "cuda"):
    """The one-process runs the dense-slab spawn is held against, and its
    inputs."""
    one, job = {"a": {}}, dict(seed=seed, slab_prompts={})
    n_req, prompt_len, new = SLAB_MIX
    for arch, layers in SLAB_LAYERS.items():
        cfg = get_config(arch, qmode="w8a8", n_layers=layers)
        prompts = rec_inputs(cfg, torch.Generator(device=device).manual_seed(
            seed + 1), n_req, prompt_len)
        job["slab_prompts"][arch] = prompts.cpu()
        params = build_layerwise(cfg, "w8a8", seed, device=device)
        reset_counts()
        one["a"][arch] = dict(
            tokens=generate(params, cfg, prompts, steps=new, device=device),
            launches={k: v for k, v in read_counts().items() if v},
            whole_bytes=tree_bytes(params))
        del params
        torch.cuda.empty_cache()
    cfg = get_config(SEQ_ARCH, qmode="w8a8")
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, SEQ_MIX[:2], generator=gen,
                            device=device)
    job["seq_prompts"] = prompts.cpu()
    params = build_layerwise(cfg, "w8a8", seed, device=device)
    # the first call with a k_len is layer 0's at the first decode step
    with first_call(attn_mod, "_grouped_attn",
                    lambda a, kw: "k_len" in kw) as att:
        toks, last, caches, _ = slab_loop(params, cfg, prompts, SEQ_MIX[2],
                                          kv_dtype="int8")
    (a, kw, y), = att
    one["b"] = dict(tokens=toks, prefill_logits=last, att=y.float().cpu(),
                    sum_pv=sum_pv(*a, **kw).cpu(),
                    slab_bytes=sum(tree_bytes(c["attn"]) for c in caches))
    del params, caches
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH, qmode="w8a8", n_layers=EXPERT_LAYERS)
    x = torch.randn(EXPERT_FFN_SHAPE + (cfg.d_model,), generator=gen,
                    device=device).to(torch.bfloat16)
    job["expert_x"] = x.cpu()
    prompts = torch.randint(0, cfg.vocab_size, EXPERT_MIX[:2], generator=gen,
                            device=device)
    job["expert_prompts"] = prompts.cpu()
    params = build_layerwise(cfg, "w8a8", seed, device=device)
    moe_mod.moe_ffn(params["layers"][0]["moe"], cfg, x, qmode="w8a8")
    reset_counts()
    y, _ = moe_mod.moe_ffn(params["layers"][0]["moe"], cfg, x, qmode="w8a8")
    torch.cuda.synchronize()
    ffn_k1 = read_counts()["K1"]
    toks, _, _, _ = slab_loop(params, cfg, prompts, EXPERT_MIX[2])
    one["c"] = dict(tokens=toks, ffn=y.float().cpu(), ffn_k1=ffn_k1)
    del params
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH, qmode="w8a8", n_layers=B2_LAYERS)
    params = build_layerwise(cfg, "w8a8", seed, device=device)
    toks, _, _, _ = slab_loop(params, cfg, prompts, EXPERT_MIX[2])
    one["d"] = dict(tokens=toks, whole_bytes=tree_bytes(params))
    del params
    torch.cuda.empty_cache()
    return one, job


def dense_slab_mesh(seed: int, smi: str, device: str = "cuda"):
    """Phase 13's third part: (a) rwkv6-7b, jamba-v0.1-52b and pixtral-12b
    on their shards under the serve rules, (1, 2); (b) qwen2-0.5b under the
    decode rules on (1, 4), its int8 slab split along the sequence; (c)
    moonshot-v1-16b-a3b under the decode rules on (2, 1), its experts split
    over data; (d) moonshot under the decode rules with the hillclimb's B2
    override on (2, 2); each against one process on the same inputs. Four
    ranks share the card through gloo. Every failure raises."""
    t0 = time.perf_counter()
    one, job = slab_one_process(seed, device)
    one_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="slab-") as d:
        ranks = spawn_ranks(slab_rank, SEQ_RANKS, init_dir=d, backend="gloo",
                            device=device, args=(job,),
                            timeout=SLAB_TIMEOUT_S, shape=(1, SEQ_RANKS))
    fails = []
    print(f"  {smi}; four processes time-sharing one card through gloo: no "
          f"tensor-parallel speed")
    n_req, prompt_len, new = SLAB_MIX
    for arch, layers in SLAB_LAYERS.items():
        want = one["a"][arch]
        for rr in ranks[:2]:
            got, r = rr["a"][arch], rr["rank"]
            if not np.array_equal(np.asarray(got["tokens"]),
                                  want["tokens"].numpy()):
                fails.append(f"(a) {arch} rank {r}: streams differ from one "
                             f"process's")
            if not got["bytes"] < got["whole_bytes"] == want["whole_bytes"]:
                fails.append(f"(a) {arch} rank {r}: {got['bytes']} bytes of "
                             f"{got['whole_bytes']} (one process "
                             f"{want['whole_bytes']})")
            if not {"K1", "K5", "K7"} <= set(got["decode_launches"]):
                fails.append(f"(a) {arch} rank {r}: a decode forward "
                             f"launched {got['decode_launches']}")
        g = ranks[0]["a"][arch]
        print(f"  (a) {arch} W8A8, {layers} layers, {n_req} x ({prompt_len} "
              f"+ {new}), serve rules on (1, 2): a rank holds "
              f"{g['bytes'] / 1e9:.3f} GB of {g['whole_bytes'] / 1e9:.3f} "
              f"(layout {g['layout']}); streams equal to one process's; a "
              f"decode step {g['decode_calls']} gloo calls, launches "
              f"{g['decode_launches']} (one process's run: "
              f"{want['launches']}, a rank's {g['launches']})")
    n_req, prompt_len, new = SEQ_MIX
    b_one = one["b"]
    gaps = {}
    for rr in ranks:
        b, r = rr["b"], rr["rank"]
        k = b["slab"]["k"]
        if k[2] % 16 or b["slab"]["start"] != r * k[2] or \
                b["slab"]["k_scale"][2] * 16 != k[2]:
            fails.append(f"(b) rank {r}: slab {b['slab']}")
        if not np.array_equal(b["prefill_logits"],
                              b_one["prefill_logits"].numpy()):
            fails.append(f"(b) rank {r}: prefill logits differ from one "
                         f"process's")
        gaps[r] = {k: att_gap(torch.as_tensor(b[k]), b_one["att"],
                              b_one["sum_pv"]) for k in ("att", "control")}
        if gaps[r]["att"] > 1.0:
            fails.append(f"(b) rank {r}: layer 0's attention at {gaps[r]['att']:.3g} "
                         f"of its bound")
        if gaps[r]["control"] <= 1.0:
            fails.append(f"(b) rank {r}: the dropped-partial control passed "
                         f"({gaps[r]['control']:.3g} of the bound)")
    b0 = ranks[0]["b"]
    b_layers = get_config(SEQ_ARCH).n_layers
    agree = float(np.mean(b0["tokens"] == b_one["tokens"].numpy()))
    print(f"  (b) {SEQ_ARCH} W8A8, {b_layers} layers, {n_req} x ({prompt_len} + "
          f"{new}), decode rules on (1, {SEQ_RANKS}): int8 slab {b0['slab']['k']} "
          f"a rank from positions {[rr['b']['slab']['start'] for rr in ranks]}, "
          f"{b0['slab']['bytes'] / 1e6:.2f} MB a rank of "
          f"{b_one['slab_bytes'] / 1e6:.2f} MB; prefill logits equal to one "
          f"process's; layer 0's attention at the first decode step "
          + ", ".join(f"rank {r} {g['att']:.3g}" for r, g in gaps.items())
          + " of its bound (one bf16 ULP + 2^-8 Σp|v|), the dropped-partial "
          "control " + ", ".join(f"{g['control']:.3g}" for g in gaps.values())
          + f"; streams agree with one process's on {agree:.1%} of tokens; a "
          f"decode step {b0['decode_calls']} gloo calls, launches "
          f"{b0['decode_launches']}")
    n_req, prompt_len, new = EXPERT_MIX
    c_one = one["c"]
    rows = c_one["ffn"].shape[0] // 2
    for rr in ranks[2:]:
        c, r = rr["c"], rr["rank"] - 2
        mine = slice(r * rows, (r + 1) * rows)
        if not np.array_equal(c["ffn"], c_one["ffn"][mine].numpy()):
            fails.append(f"(c) data rank {r}: layer 0's MoE FFN differs from "
                         f"one process's")
        if 2 * c["ffn_k1"] != c_one["ffn_k1"]:
            fails.append(f"(c) data rank {r}: {c['ffn_k1']} expert GEMMs, one "
                         f"process {c_one['ffn_k1']}")
        if not np.array_equal(c["tokens"], c_one["tokens"][
                n_req // 2 * r:n_req // 2 * (r + 1)].numpy()):
            fails.append(f"(c) data rank {r}: streams differ from one "
                         f"process's")
    c0 = ranks[2]["c"]
    print(f"  (c) {MOE_ARCH} W8A8, {EXPERT_LAYERS} of 48 layers, {n_req} x "
          f"({prompt_len} + {new}), decode rules on (2, 1): layer 0's MoE "
          f"FFN on {EXPERT_FFN_SHAPE} tokens equal to one process's rows bit "
          f"for bit; expert GEMMs (K1) a rank {c0['ffn_k1']} against one "
          f"process's {c_one['ffn_k1']}; streams equal; a decode step "
          f"{c0['decode_calls']} gloo calls, launches {c0['decode_launches']}")
    d_one = one["d"]
    for rr in ranks:
        dd, r = rr["d"], rr["rank"]
        rows = slice(n_req // 2 * (r // 2), n_req // 2 * (r // 2 + 1))
        if not np.array_equal(dd["tokens"], d_one["tokens"][rows].numpy()):
            fails.append(f"(d) rank {r}: streams differ from one process's")
        if not {"K1", "K5", "K7"} <= set(dd["decode_launches"]):
            fails.append(f"(d) rank {r}: a decode forward launched "
                         f"{dd['decode_launches']}")
    d0 = ranks[0]["d"]
    print(f"  (d) {MOE_ARCH} W8A8, {B2_LAYERS} of 48 layers, {n_req} x "
          f"({prompt_len} + {new}), decode rules with the hillclimb's B2 "
          f"(experts over model, expert_ff over data) on (2, 2): a rank "
          f"holds {d0['bytes'] / 1e9:.3f} GB of "
          f"{d_one['whole_bytes'] / 1e9:.3f}; streams equal to one "
          f"process's bit for bit; a decode step {d0['decode_calls']} gloo "
          f"calls, launches {d0['decode_launches']}")
    seconds = time.perf_counter() - t0
    print(f"  phase 13 dense slab seconds: {seconds:.1f} (one process "
          f"{one_s:.1f})")
    if fails:
        raise RuntimeError("phase 13 dense slab: " + "; ".join(fails))
    return dict(card=smi, seconds=seconds, one_process_s=one_s,
                att_gaps=gaps, agree=agree,
                a={a: {k: v for k, v in ranks[0]["a"][a].items()
                       if k != "tokens"} for a in SLAB_LAYERS},
                b={k: v for k, v in b0.items()
                   if k not in ("tokens", "prefill_logits", "att",
                                "control")},
                c={k: v for k, v in c0.items() if k not in ("tokens", "ffn")},
                d={k: v for k, v in d0.items() if k != "tokens"},
                one_process_c_k1=c_one["ffn_k1"],
                launches={"slab (1, 4) rank 0": b0["launches"],
                          "slab (2, 1) rank 0": c0["launches"],
                          "slab B2 (2, 2) rank 0": d0["launches"],
                          **{f"slab {a} (1, 2) rank 0": ranks[0]["a"][a][
                              "launches"] for a in SLAB_LAYERS}})


# ---------------------------------------------------------------------------
# Phase 14: sharded (FSDP) training
# ---------------------------------------------------------------------------
FSDP_MESH = (1, 2)       # (data, model): two processes sharing cuda:0, gloo
FSDP_BATCH, FSDP_STEPS = 4, 4      # 4 rows of TRAIN_SEQ: 2 x 512 a rank
# qwen3-0.6b at full width, depth cut to 4 of the 28 layers: at full
# depth the phase took 102.0 s of its 90 s budget, and at 14 layers (81.1
# s) the whole script took 1,178.8 s of its 1,200 s (NVIDIA H100 80GB
# HBM3, 700 W); at 8 layers it took 69.8 s gathering a layer at a time,
# and the other families need the room; the gather, reduce and checkpoint
# scale with the parameters
FSDP_LAYERS = 4
FSDP_TIMEOUT_S = 600.0   # the spawned group's limit; the phase aims at 300 s
# Sharded against one process from the same state and batches, bf16. The
# ranks' gradients are the one process's summed over their row blocks in
# another order, so bf16 roundings differ and compound through the
# layers. From the same state (the first step) only that separates them;
# after it the two trajectories drift apart (AdamW's normalized updates
# turn a last-bit difference of a near-zero gradient into a full step).
# qwen3's later grad_norms moved by up to ~10% (printed), its losses far
# less; moonshot's capacity routing turns a last-bit difference into other
# picks and drops, so only its first two losses are gated and its later
# steps are printed beside layer 0's routing at each (NVIDIA H100 80GB
# HBM3, 700 W: losses 1.4e-3-8.6e-3 apart at steps 2-3, grad_norm up to
# 61%, layer 0's first routing equal at every pick); rwkv6 matched at
# every printed digit. Each limit has a control that must land outside.
FSDP_FIRST_RTOL = 5e-4   # a step from one state: the first step's loss
#                          and grad_norm (control: rank 1's gradient left
#                          out of the reduce), and the restored one's
#                          against the ranks' step from the saved state
FSDP_LOSS_RTOL = 5e-4    # the gated steps' losses, and with ``norms``
#                          every grad_norm (control: rank 1's first AdamW
#                          update zeroed)
# moonshot's second loss: one process alone, run twice, gave it 3.3e-4
# apart (its step is not deterministic, and the capacity routing turns
# that into other picks: 8% of layer 0's after one update), and the ranks
# 1.5e-5-5.3e-4 from one process in 7 runs (NVIDIA H100 80GB HBM3, 700
# W; tools/fsdp_moe_spread.py); the zeroed-update control 3.7e-3-4.5e-3
FSDP_MOE_LOSS_RTOL = 1.5e-3
# the moment scales after the first step of the leaves whose last dim the
# mesh splits, as a share of the leaf's largest scale (control: those
# moments quantized with each block's own absmax): 16 bf16 ULPs, as the
# gradients' compounded bf16 roundings move a row's absmax by several
FSDP_SCALE_TOL = 2.0 ** -4
# layer 0's routing in the first forward: the share of the ranks' (token,
# top-k pick) slots that differ from one process's. Each rank's router
# input comes from attention over its own rows, so bf16 roundings may
# flip a near-tie pick now and then; rank-local counting (the control)
# moves every later rank's picks.
FSDP_ROUTE_SHARE = 0.01
# Every family under a train mesh, each gathering one layer at a time,
# one entry a model: its depth, its (data, model) mesh over the spawned
# ranks, the steps whose loss is gated (``losses``) and their limit
# (``loss_rtol``), whether every grad_norm is gated (``norms``), and two
# checks of qwen3's alone: the moment scales of the leaves the mesh
# splits (``scales``) and a checkpoint restored into one process
# (``checkpoint``). moonshot-v1-16b-a3b's routing groups span the ranks
# (2 x 2 x 512 tokens make one group of 2,048 over both); rwkv6-7b runs
# on (data 2, model 1): its batch binds data only, so (1, 2) would split
# nothing of it.
FSDP_FAMILIES = {
    TRAIN_ARCH: dict(layers=FSDP_LAYERS, mesh=FSDP_MESH, losses=FSDP_STEPS,
                     loss_rtol=FSDP_LOSS_RTOL, norms=False, scales=True,
                     checkpoint=True),
    "moonshot-v1-16b-a3b": dict(layers=2, mesh=(1, 2), losses=2,
                                loss_rtol=FSDP_MOE_LOSS_RTOL, norms=False,
                                scales=False, checkpoint=False),
    "rwkv6-7b": dict(layers=2, mesh=(2, 1), losses=FSDP_STEPS,
                     loss_rtol=FSDP_LOSS_RTOL, norms=True, scales=False,
                     checkpoint=False),
}


def _moment_scales(tree):
    """The scale leaves of an int8 moment tree (or of its shardings)."""
    return tree_map(lambda m: m["scale"], tree,
                    is_leaf=lambda x: isinstance(x, dict) and "q" in x)


def state_crcs(state) -> list:
    """A CRC-32 of each leaf's bytes, in leaf order (any dtype, device)."""
    return [zlib.crc32(x.detach().contiguous().view(-1).view(torch.uint8)
                       .cpu().numpy()) for x in leaves(state)]


def fsdp_split_leaves(cfg, mesh_shape) -> list:
    """For each params leaf, in leaf order: does ``mesh_shape`` split its
    last dim (so that its int8 rows need the MAX over the split)?"""
    mesh = types.SimpleNamespace(shape=axis_sizes(mesh_shape))
    specs, _ = param_specs(cfg, make_rules("train", family=cfg.family), mesh)
    return [adamw_mod.row_max_of(spec, mesh) is not None
            for spec in leaves(specs)]


def step_traffic(step) -> dict:
    """A sharded step's collectives as its ``fsdp.Step`` counted them:
    calls and the bytes a rank sends (ring algorithms) of the forward
    gathers, the recompute gathers and the reduces."""
    return dict(calls=dict(step.calls), sent=dict(step.sent),
                peak_whole_gb=step.peak_whole / 1e9)


def dropped_rank_1():
    """The dropped-gradient control: rank 1's whole gradients zeroed
    before every reduce (``fsdp.reduce_blocks``) until the context ends."""
    reduce_blocks = fsdp_mod.reduce_blocks

    def dropped(step, grads, specs):
        if step.mesh.rank == 1:
            grads = [torch.zeros_like(g) for g in grads]
        return reduce_blocks(step, grads, specs)
    return patched(fsdp_mod, "reduce_blocks", dropped)


@contextlib.contextmanager
def patched(mod, name, value):
    old = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, old)


def _rel_gap(got, want) -> float:
    return abs(got - want) / abs(want)


def _scale_gap(got, want) -> float:
    """max |got − want| over the moment scales, as a share of the largest
    scale of its leaf."""
    return max(float(np.max(np.abs(np.asarray(g) - np.asarray(w)))
                     / np.max(np.asarray(w)))
               for gs, ws in zip(got, want) for g, w in zip(gs, ws))


def fsdp_training(seed: int, smi: str):
    """Phase 14: each of ``FSDP_FAMILIES`` at full width, int8 moments and
    int8 gradients, on its mesh of ranks against one process from the
    same state and batches (every one-process run first, then one spawn
    of the ranks for every entry: a process takes ~8 s to reach the
    card); the checkpoint entry's save restored into one process. Every
    failure raises."""
    t0 = time.perf_counter()
    one = {arch: family_one_process(arch, seed) for arch in FSDP_FAMILIES}
    pod_one = {arch: multipod_one_process(arch, seed)
               for arch in MULTIPOD_FAMILIES}
    with tempfile.TemporaryDirectory(prefix="fsdp-") as d:
        ck = os.path.join(d, "ck")
        ranks = spawn_ranks(fsdp_phase_rank, math.prod(FSDP_MESH),
                            init_dir=d, backend="gloo", device="cuda",
                            args=(dict(seed=seed, dir=ck),),
                            timeout=FSDP_TIMEOUT_S, shape=FSDP_MESH)
        elastic = restored_step(ck, seed)
    parts = {arch: family_report(arch, one[arch], [r[arch] for r in ranks],
                                 smi, elastic if spec["checkpoint"]
                                 else None)
             for arch, spec in FSDP_FAMILIES.items()}
    multi_pod = multipod_report(pod_one, [r["multi-pod"] for r in ranks],
                                smi)
    seconds = time.perf_counter() - t0
    print(f"  phase 14 seconds: {seconds:.1f} (one spawn of "
          f"{len(ranks)} ranks for every part)")
    return dict(card=smi, families=parts, multi_pod=multi_pod,
                seconds=seconds)


def restored_step(path: str, seed: int) -> dict:
    """The checkpoint entry's save at ``path`` restored into one process:
    its bytes, the restore's seconds, a CRC a leaf, and the loss and
    grad_norm of its next step (batch ``FSDP_STEPS``)."""
    arch = next(a for a, v in FSDP_FAMILIES.items() if v["checkpoint"])
    cfg = get_config(arch, n_layers=FSDP_FAMILIES[arch]["layers"])
    opt, step = train_setup(cfg, True, FSDP_STEPS + 1)
    t1 = time.perf_counter()
    restored = ckpt_lib.restore(path, train_state(cfg, opt, seed))
    out = dict(restore_s=time.perf_counter() - t1,
               bytes=sum(f.stat().st_size for f in Path(path).rglob("*.npz")),
               crcs=state_crcs(restored))
    data = SyntheticLMData(cfg.vocab_size, FSDP_BATCH, TRAIN_SEQ, seed=seed)
    _, m = step(restored, shard_batch(data.batch_at(FSDP_STEPS),
                                      device="cuda"))
    out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    del restored
    torch.cuda.empty_cache()
    return out


def fsdp_phase_rank(mesh, job):
    """One rank of phase 14: each of ``FSDP_FAMILIES`` on its own mesh over
    the spawned ``FSDP_MESH`` processes, then each of
    ``MULTIPOD_FAMILIES`` on ``MULTIPOD_MESH``."""
    out = {}
    for arch in FSDP_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = fsdp_family_rank(family_mesh(mesh, arch),
                                     dict(job, arch=arch))
    out["multi-pod"] = {}
    for arch in MULTIPOD_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        out["multi-pod"][arch] = multipod_rank(
            mesh_over(mesh, MULTIPOD_MESH), dict(job, arch=arch))
    return out


def family_mesh(mesh, arch):
    """``arch``'s mesh (``FSDP_FAMILIES``) over the ranks of ``mesh``, each
    rank at its own place: the axis longer than one spans them all."""
    return mesh_over(mesh, FSDP_FAMILIES[arch]["mesh"])


def mesh_over(mesh, shape):
    """A mesh of ``shape`` ((d, m) or (p, d, m)) with one axis longer than
    one over the ranks of ``mesh``, each rank at its own place."""
    sizes = axis_sizes(shape)
    if sizes == mesh.shape:
        return mesh
    live = [a for a in AXES if sizes[a] > 1]
    if math.prod(sizes.values()) != math.prod(mesh.shape.values()) or \
            len(live) > 1:
        raise ValueError(f"a mesh {shape} over {mesh.shape}")
    return RankMesh(sizes, mesh.rank, mesh.group,
                    {a: mesh.group for a in live}, mesh.device)


# Phase 14 (continued): the multi-pod train rules. The two ranks split
# the sequence only ((pod, data, model) = (2, 1, 1): ``seq_act`` on pod,
# each rank a replica of every parameter): each holds its rows' half of
# the positions, and each mixer gathers the sequence over pod. Gated: the
# first step's loss and grad_norm against one process from the same
# state within ``MULTIPOD_RTOL``; the control (the sequence gather's
# backward without the sum over the pods) must put grad_norm outside.
# qwen3-0.6b at full width, 2 of 28 layers; jamba-v0.1-52b at full width,
# 2 of 32 layers (a Mamba layer with its MLP, then a Mamba layer with its
# MoE), its 16 experts cut to 4: at 16 a replica's step peaks at 58.0 GB
# (the meta run of ``launch/dryrun.py::measure``, int8 moments), and two
# replicas share the 80 GB card. In jamba the cross-pod terms reach only
# the Mamba layers' x_in, through a scan whose steps are scaled by a
# small dt at initialisation, and the token-local MLP and MoE gradients
# fill the norm: its control moved grad_norm by 5.13e-4 where qwen3's
# moved it by 0.114 (its attention's k/v gradients cross the pods).
# ``MULTIPOD_RTOL`` sits between the sound readings (qwen3 6.66e-5,
# jamba 1.44e-5) and jamba's control, with room on both sides (NVIDIA
# H100 80GB HBM3, 700 W).
MULTIPOD_MESH = (2, 1, 1)
MULTIPOD_FAMILIES = {TRAIN_ARCH: dict(n_layers=2),
                     "jamba-v0.1-52b": dict(n_layers=2, moe_experts=4)}
MULTIPOD_RTOL = 2e-4


def multipod_config(arch: str):
    """``arch`` at full width with ``MULTIPOD_FAMILIES``' cuts."""
    return get_config(arch, **MULTIPOD_FAMILIES[arch])


def _own_pod_block(blocks, mesh, axes):
    """The control's sequence-gather backward: this rank's own gradient of
    its block, the other pods' left out."""
    return blocks[mesh.coords["pod"]].clone()


def multipod_rank(mesh, job):
    """One rank of the multi-pod part: the seed's full-width state (every
    leaf a replica), the first step on its block of the batch (its rows'
    half of the positions) → loss, grad_norm, the step's ms and K7
    launches; the control's first step from the same state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = multipod_config(job["arch"])
    opt, step = train_setup(cfg, True, FSDP_STEPS + 1)
    rules = make_rules("train", multi_pod=True, family=cfg.family)
    b = SyntheticLMData(cfg.vocab_size, FSDP_BATCH, TRAIN_SEQ,
                        seed=job["seed"]).batch_at(0)
    out = dict(rank=mesh.rank)
    with mesh_context(mesh, rules, mode="train"):
        full = train_state(cfg, opt, job["seed"])
        state0 = shard_tree(full, named(train_state_pspecs(full, rules, mesh),
                                        mesh))
        del full
        batch = shard_batch(b, mesh=mesh, specs=batch_specs(b, rules, mesh))
        out["block"] = [list(batch["labels"].shape), batch.start]
        for name, patch in (("control", patched(collectives, "seq_grad",
                                                _own_pod_block)),
                            ("step", contextlib.nullcontext())):
            reset_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with patch:
                state, m = step(state0, batch)
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            out[name] = dict(loss=loss, grad_norm=norm,
                             ms=(time.perf_counter() - t1) * 1e3,
                             k7=read_counts()["K7"])
            del state
    return out


def multipod_one_process(arch: str, seed: int) -> dict:
    """One process's first step of ``arch`` (``MULTIPOD_FAMILIES``) from
    the seed's state on the whole batch."""
    cfg = multipod_config(arch)
    opt, step = train_setup(cfg, True, FSDP_STEPS + 1)
    state = train_state(cfg, opt, seed)
    b = SyntheticLMData(cfg.vocab_size, FSDP_BATCH, TRAIN_SEQ,
                        seed=seed).batch_at(0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, m = step(state, shard_batch(b, device="cuda"))
    out = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t1) * 1e3
    del state
    torch.cuda.empty_cache()
    return out


def multipod_report(one: dict, ranks: list, smi: str) -> dict:
    """The multi-pod part's gates (raises on a failure) and its print."""
    fails, out = [], {}
    for arch, want in one.items():
        cfg = multipod_config(arch)
        got = [r[arch] for r in ranks]
        gaps = {k: max(_rel_gap(g["step"][k], want[k]) for g in got)
                for k in ("loss", "grad_norm")}
        control = min(_rel_gap(g["control"]["grad_norm"], want["grad_norm"])
                      for g in got)
        for k, gap in gaps.items():
            if gap > MULTIPOD_RTOL:
                fails.append(f"{arch}: first {k} {gap:.3g} from one process "
                             f"(limit {MULTIPOD_RTOL:g})")
        if control <= MULTIPOD_RTOL:
            fails.append(f"{arch}: the control (no sum over the pods) put "
                         f"grad_norm within {control:.3g}")
        blocks = [g["block"] for g in got]
        if blocks != [[[FSDP_BATCH, TRAIN_SEQ // 2], r * TRAIN_SEQ // 2]
                      for r in range(len(got))]:
            fails.append(f"{arch}: the ranks' blocks {blocks}")
        print(f"  multi-pod {arch}, {cfg.n_layers} layers"
              + (f", {cfg.moe_experts} experts" if cfg.moe_experts else "")
              + f", {FSDP_BATCH} x {TRAIN_SEQ} on (pod, data, model) = "
              f"{MULTIPOD_MESH} ({smi}): each rank {blocks[0][0]} from "
              f"positions {[b[1] for b in blocks]}; first loss "
              f"{got[0]['step']['loss']:.6f} vs one process "
              f"{want['loss']:.6f} ({gaps['loss']:.3g}), grad_norm "
              f"{got[0]['step']['grad_norm']:.6f} vs {want['grad_norm']:.6f} "
              f"({gaps['grad_norm']:.3g}; limit {MULTIPOD_RTOL:g}); the "
              f"no-pod-sum control's grad_norm {control:.3g} away; step "
              f"{got[0]['step']['ms']:.1f} ms a rank (one process "
              f"{want['ms']:.1f}), K7 {got[0]['step']['k7']} a rank")
        out[arch] = dict(one=want, ranks=got, gaps=gaps, control=control,
                         launches={"K7": got[0]["step"]["k7"]})
    if fails:
        raise RuntimeError("phase 14 multi-pod: " + "; ".join(fails))
    return out


class RoutedLayer0(Exception):
    """Raised by :func:`first_route` with ``stop``: every rank stops its
    step where layer 0 has routed, at the same collective."""


@contextlib.contextmanager
def first_route(record: list, stop: bool = False):
    """The first MoE routing call inside (layer 0's, in the forward):
    its slots and the mask of this rank's tokens on the grid (None in one
    process), as numpy, into ``record``; with ``stop``, the step ends
    there (:class:`RoutedLayer0`, caught here)."""
    inner = moe_mod._route

    def call(gates, k, cap, mask=None, offsets=None):
        slots, weights = inner(gates, k, cap, mask, offsets)
        if not record:
            record.append(dict(
                cap=cap, slots=slots.reshape(-1, k).cpu().numpy(),
                mask=None if mask is None
                else mask.reshape(-1).bool().cpu().numpy()))
            if stop:
                raise RoutedLayer0
        return slots, weights
    try:
        with patched(moe_mod, "_route", call):
            yield
    except RoutedLayer0:
        pass


def route_share(one: dict, ranks: list, record, experts=False) -> float:
    """The share of the ranks' layer-0 picks (``record(rank)``: its
    :func:`first_route` record) whose slot (with ``experts``: whose
    expert, a dropped pick's being none) differs from one process's
    (``one``) at the same token. One pick moved to another expert moves
    the slots of the later picks of both experts."""
    want, differ, total = one["slots"], 0, 0
    if experts:
        want = want // one["cap"]
    for r in ranks:
        rec = record(r)
        got = rec["slots"][rec["mask"]]
        if experts:
            got = got // rec["cap"]
        lo = r["batch_index"] * len(got)
        differ += int((got != want[lo:lo + len(got)]).sum())
        total += got.size
    return differ / total


UPDATE_F32_COPIES = 8


def fsdp_peak_gb(cfg, mesh_shape) -> dict:
    """A rank's peak device memory (GB) from the shapes, in two designs,
    with int8 moments and gradients in the params' dtype: its shards
    (params, moments: an int8 a value and an f32 scale a row, twice)
    plus, at the worst point of a step,

    * ``whole_step`` (the whole params gathered once a step): the whole
      params and the whole gradients during the backward; then at the
      reduce the whole gradients, their f32 copy laid out a block a
      member for the reduce-scatter, and the f32 blocks it returns;
    * ``per_layer``: the largest part gathered at once (a layer, or a
      top-level leaf): its whole params and gradients, their f32 copy
      and the f32 block; the reduced gradient blocks held meanwhile;
    * the update, in both: the old params and moments, the gradient
      blocks, the updates and the new moments as they fill, and
      ``UPDATE_F32_COPIES`` f32 copies of the largest block (g, m, v,
      their quotients, the update, the quantizer's input with its absmax
      column).

    Activations are left out (they are small beside these at 2 x 512
    tokens a rank)."""
    mesh = types.SimpleNamespace(shape=axis_sizes(mesh_shape),
                                 coords={a: 0 for a in AXES})
    specs, shapes = param_specs(cfg, make_rules("train", family=cfg.family),
                                mesh)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()

    def blk(shape, spec):
        return math.prod(sharding_block_shape(shape, spec, mesh))

    def size(tree_shapes):
        return sum(math.prod(x) for x in leaves(tree_shapes))
    blocks = [blk(x, sp) for x, sp in zip(leaves(shapes), leaves(specs))]
    rows = [math.prod(sharding_block_shape(x, sp, mesh)[:-1]) if x else 1
            for x, sp in zip(leaves(shapes), leaves(specs))]
    params = sum(blocks) * item
    moments = 2 * sum(n + 4 * r for n, r in zip(blocks, rows))
    grads = params
    total = size(shapes)
    n = math.prod(mesh_shape)
    parts = [size(layer) for layer in shapes["layers"]] + [
        math.prod(v) for k, v in shapes.items() if k != "layers"]
    part = max(parts)
    update = (2 * (params + moments) + grads
              + UPDATE_F32_COPIES * 4 * max(blocks))
    whole_step = params + moments + max(
        2 * total * item, total * item + 4 * total + 4 * total / n)
    per_layer = params + moments + grads + (
        2 * part * item + 4 * part + 4 * part / n)
    return {k: v / 1e9 for k, v in dict(
        whole_step=max(whole_step, update), per_layer=max(per_layer, update),
        shards=params + moments).items()}


def sharded_loss(cfg, state, batch, mesh, rules) -> float:
    """The loss of this rank's shards on the ranks' rows of ``batch`` (a
    forward, each part gathered where it is used, as the step does)."""
    specs, _ = param_specs(cfg, rules, mesh)
    with torch.no_grad(), fsdp_mod.sharded_step(mesh, specs, batch.axes,
                                                batch.shards,
                                                batch.seq_axes):
        lval = loss_fn(state["params"], cfg, batch)
    return float(collectives.all_reduce(lval, mesh, batch.axes
                                        + batch.seq_axes) / batch.shards)


def fsdp_family_rank(mesh, job):
    """One rank of an entry of phase 14: the seed's full-width state
    sharded by its family's train specs; the controls from those shards
    (rank 1's gradient dropped from the reduce; for an MoE model, layer 0
    routed on counts of the rank's own tokens alone; with ``scales``, the
    moments quantized with each block's own absmax); then ``FSDP_STEPS``
    steps on its rows (K7 counted, the last step's K7 calls in situ,
    layer 0's routing at each step, the first step's collectives and
    split moment scales), with after the first the zeroed-update control
    (rank 1 keeping its initial params beside the ranks' new moments: the
    second step's loss), and the peak memory over the steps after the
    first (the initial shards are held until the control has run); with
    ``checkpoint``, a save from the shards (rank 0 writes the whole
    leaves; their CRCs) and one more step."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = FSDP_FAMILIES[job["arch"]]
    cfg = get_config(job["arch"], n_layers=spec["layers"])
    opt, step = train_setup(cfg, True, FSDP_STEPS + 1)
    rules = make_rules("train", family=cfg.family)
    data = SyntheticLMData(cfg.vocab_size, FSDP_BATCH, TRAIN_SEQ,
                           seed=job["seed"])

    def batch(s):
        b = data.batch_at(s)
        return shard_batch(b, mesh=mesh, specs=batch_specs(b, rules, mesh))

    def one_step(state, s):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, batch(s))
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        return state, loss, norm, (time.perf_counter() - t1) * 1e3

    out = dict(rank=mesh.rank, loss=[], grad_norm=[], step_ms=[], k7=[])
    with mesh_context(mesh, rules, mode="train"):
        full = train_state(cfg, opt, job["seed"])
        out["n_leaves"] = len(leaves(full["params"]))
        sh = named(train_state_pspecs(full, rules, mesh), mesh)
        state0 = shard_tree(full, sh)
        del full
        if spec["scales"]:
            scale_sh = _moment_scales(sh["opt"]["m"])
            split = fsdp_split_leaves(cfg, spec["mesh"])

            def scales(state):
                """The moment scales of the leaves the mesh splits."""
                return [[x for x, cut in zip(leaves(gather_tree(
                    _moment_scales(state["opt"][k]), scale_sh)), split)
                    if cut] for k in ("m", "v")]
            with patched(adamw_mod, "row_max_of", lambda spec, m: None):
                st, *_ = one_step(state0, 0)
            out["control_local_absmax"] = scales(st)
            del st
        with dropped_rank_1():
            _, loss, norm, _ = one_step(state0, 0)
        out["control_dropped"] = dict(loss=loss, grad_norm=norm)
        if cfg.moe_experts:
            def own_counts(counts, grids, groups, split, rows):
                return moe_mod.split_offsets(counts[None], 0)
            routes = []           # the first forward, to layer 0's routing
            with patched(moe_mod, "_exchange_offsets", own_counts), \
                    first_route(routes, stop=True):
                step(state0, batch(0))
            # the step stopped inside layer 0's checkpoint: torch 2.11's
            # ``checkpoint`` leaves that block's saved-tensor hooks
            # pushed until its generator is collected, and the next
            # forward would pack its tensors into them
            gc.collect()
            out["control_route"] = routes[0]
        calls, state = [], state0
        out["routes"] = []        # layer 0's routing at each step
        for s in range(FSDP_STEPS):
            reset_counts()
            routes = []
            with contextlib.ExitStack() as inside:
                if s == FSDP_STEPS - 1:
                    inside.enter_context(k7_checked(calls))
                if cfg.moe_experts:
                    inside.enter_context(first_route(routes))
                state, loss, norm, ms = one_step(state, s)
            out["routes"] += routes
            out["k7"].append(read_counts()["K7"])
            out["loss"].append(loss)
            out["grad_norm"].append(norm)
            out["step_ms"].append(ms)
            if s == 0:
                out["traffic"] = step_traffic(step.last)
                out["batch_index"] = step.last.batch_index()
                if spec["scales"]:
                    out["scales"] = scales(state)
                kept = state0["params"] if mesh.rank == 1 else state["params"]
                out["control_update"] = sharded_loss(
                    cfg, {**state, "params": kept}, batch(1), mesh, rules)
                del state0, kept
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                out["shards_gb"] = torch.cuda.memory_allocated() / 1e9
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["in_situ"] = dict(calls=len(calls),
                              exact=all(c["exact"] for c in calls),
                              max_abs_err=max(c["max_abs_err"]
                                              for c in calls),
                              longest_row=max(c["shape"][-1] for c in calls))
        if spec["checkpoint"]:
            t1 = time.perf_counter()
            ckpt_lib.save(job["dir"], state, FSDP_STEPS, shardings=sh)
            out["save_s"] = time.perf_counter() - t1
            whole = gather_tree(state, sh)
            if mesh.rank == 0:
                out["crcs"] = state_crcs(whole)
            del whole
            _, loss, norm, _ = one_step(state, FSDP_STEPS)
            out["next"] = dict(loss=loss, grad_norm=norm)
    if mesh.rank:
        out.pop("scales", None)
        out.pop("control_local_absmax", None)
    out["seconds"] = time.perf_counter() - t0
    return out


def row_blocks(cfg, mesh_shape) -> int:
    """How many distinct row blocks ``mesh_shape`` splits a
    ``FSDP_BATCH``-row batch into under ``cfg``'s train rules."""
    mesh = types.SimpleNamespace(shape=axis_sizes(mesh_shape))
    batch = SyntheticLMData(cfg.vocab_size, FSDP_BATCH, 1).batch_at(0)
    spec = batch_specs(batch, make_rules("train", family=cfg.family),
                       mesh)["labels"][0]
    return math.prod(mesh.shape[a] for a in axes_of(spec))


def family_one_process(arch: str, seed: int) -> dict:
    """One process's ``FSDP_STEPS`` steps of ``arch`` from the seed's
    state, the reference of its sharded part. A model without experts
    takes the ranks' row blocks as micro-batches (``grad_accum``): the
    sharded step sums the blocks' gradients, and the bf16 matmuls round
    otherwise at another M (rwkv6's first grad_norm moved 5.3e-3 with the
    rows on an H100); its first step on the whole batch is printed
    beside. An MoE model routes the whole batch's groups, as its ranks
    do. With ``scales``, the first step's moment scales of the leaves the
    entry's mesh splits."""
    spec = FSDP_FAMILIES[arch]
    cfg = get_config(arch, n_layers=spec["layers"])
    accum = 1 if cfg.moe_experts else row_blocks(cfg, spec["mesh"])
    opt, whole_step = train_setup(cfg, True, FSDP_STEPS + 1)
    step = build_train_step(cfg, opt, grad_accum=accum, compress_grads="int8")
    data = SyntheticLMData(cfg.vocab_size, FSDP_BATCH, TRAIN_SEQ, seed=seed)
    one = dict(accum=accum)
    if accum > 1:
        _, m = whole_step(train_state(cfg, opt, seed),
                          shard_batch(data.batch_at(0), device="cuda"))
        one["whole_batch_first"] = dict(loss=float(m["loss"]),
                                        grad_norm=float(m["grad_norm"]))
        gc.collect()
        torch.cuda.empty_cache()
    state = train_state(cfg, opt, seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    one.update(loss=[], grad_norm=[], step_ms=[])
    routes = []                   # layer 0's routing at each step
    for s in range(FSDP_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec = []
        with (first_route(rec) if cfg.moe_experts
              else contextlib.nullcontext()):
            state, m = step(state, shard_batch(data.batch_at(s),
                                               device="cuda"))
        routes += rec
        one["loss"].append(float(m["loss"]))
        one["grad_norm"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        one["step_ms"].append((time.perf_counter() - t1) * 1e3)
        if s == 0 and spec["scales"]:
            split = fsdp_split_leaves(cfg, spec["mesh"])
            one["scales"] = [[x.cpu().numpy() for x, cut in zip(leaves(
                _moment_scales(state["opt"][k])), split) if cut]
                for k in ("m", "v")]
    one["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state
    gc.collect()
    torch.cuda.empty_cache()
    one["routes"] = routes
    return one


def family_report(arch: str, one: dict, ranks: list, smi: str,
                  elastic: dict = None) -> dict:
    """Phase 14's gates and printout for one entry: its ranks' results
    against one process's (``family_one_process``) and, for the
    checkpoint entry, against its save restored into one process
    (``elastic``: :func:`restored_step`); raises on any failure."""
    cfg = get_config(arch, n_layers=FSDP_FAMILIES[arch]["layers"])
    spec = FSDP_FAMILIES[arch]
    routes = one.pop("routes")
    r0 = ranks[0]
    first = max(_rel_gap(r0[k][0], one[k][0]) for k in ("loss", "grad_norm"))
    n = spec["losses"]
    gaps = dict(
        first_step=first,
        loss=max(_rel_gap(a, b) for a, b in
                 zip(r0["loss"][:n], one["loss"][:n])),
        grad_norm=max(_rel_gap(a, b) for a, b in
                      zip(r0["grad_norm"], one["grad_norm"])),
        control_dropped=max(_rel_gap(r0["control_dropped"][k], one[k][0])
                            for k in ("loss", "grad_norm")),
        control_update=_rel_gap(r0["control_update"], one["loss"][1]))
    if n < FSDP_STEPS:
        gaps["later_losses"] = max(_rel_gap(a, b) for a, b in
                                   zip(r0["loss"][n:], one["loss"][n:]))
    gated = [("first_step", FSDP_FIRST_RTOL), ("loss", spec["loss_rtol"])]
    if spec["norms"]:
        gated.append(("grad_norm", FSDP_LOSS_RTOL))
    controls = [("control_dropped", FSDP_FIRST_RTOL),
                ("control_update", spec["loss_rtol"])]
    shares = [[route_share(routes[s], ranks, lambda r: r["routes"][s], e)
               for e in (True, False)] for s in range(len(routes))]
    if cfg.moe_experts:
        gaps["route_share"] = shares[0][1]
        gaps["control_route_share"] = route_share(
            routes[0], ranks, lambda r: r["control_route"])
        gated.append(("route_share", FSDP_ROUTE_SHARE))
        controls.append(("control_route_share", FSDP_ROUTE_SHARE))
    if spec["scales"]:
        gaps["scales"] = _scale_gap(r0["scales"], one["scales"])
        gaps["control_local_absmax"] = _scale_gap(r0["control_local_absmax"],
                                                  one["scales"])
        gated.append(("scales", FSDP_SCALE_TOL))
        controls.append(("control_local_absmax", FSDP_SCALE_TOL))
    if elastic is not None:
        gaps["restored"] = max(_rel_gap(elastic[k], r0["next"][k])
                               for k in ("loss", "grad_norm"))
        gated.append(("restored", FSDP_FIRST_RTOL))
    fails = [f"{k} gap {gaps[k]:.3g} > {tol:g}" for k, tol in gated
             if not gaps[k] <= tol]
    fails += [f"the {k} passed ({gaps[k]:.3g})" for k, tol in controls
              if gaps[k] <= tol]
    if elastic is not None and elastic["crcs"] != r0["crcs"]:
        bad = [i for i, (a, b) in enumerate(zip(elastic["crcs"], r0["crcs"]))
               if a != b]
        fails.append(f"the restored state differs from the saved one in "
                     f"{len(bad)} of {len(r0['crcs'])} leaves: {bad[:8]}")
    for r in ranks:
        want = 3 * r["n_leaves"]
        if r["k7"] != [want] * FSDP_STEPS:
            fails.append(f"rank {r['rank']}: K7 {r['k7']} a step, expected "
                         f"{want}")
        if not (r["in_situ"]["exact"] and r["in_situ"]["calls"] == want):
            fails.append(f"rank {r['rank']}: K7 in situ {r['in_situ']}")
        if (r["loss"], r["grad_norm"]) != (r0["loss"], r0["grad_norm"]):
            fails.append(f"rank {r['rank']}'s metrics differ from rank 0's")
    peak = fsdp_peak_gb(cfg, spec["mesh"])
    limit = peak["whole_step"] - 0.5 * (peak["whole_step"]
                                        - peak["per_layer"])
    measured = max(r["peak_gb"] for r in ranks)
    if cfg.moe_experts and not measured <= limit:
        fails.append(f"a rank's peak {measured:.2f} GB is not below the "
                     f"whole-step design's {peak['whole_step']:.2f} by half "
                     f"the predicted saving (limit {limit:.2f} GB)")
    total = get_config(arch).n_layers
    print(f"  {arch} full width, {cfg.n_layers} of {total} layers, int8 "
          f"moments + int8 gradients, {spec['mesh']} mesh of ranks "
          f"(processes time-sharing one card through gloo: no sharded "
          f"speed); one process with grad_accum {one['accum']}; {smi}")
    if "whole_batch_first" in one:
        w = one["whole_batch_first"]
        print(f"  one process's first step on the whole batch: loss "
              f"{w['loss']:.6f}, grad_norm {w['grad_norm']:.6f} (gaps to "
              f"the ranks' {_rel_gap(r0['loss'][0], w['loss']):.3g}, "
              f"{_rel_gap(r0['grad_norm'][0], w['grad_norm']):.3g})")
    for s in range(FSDP_STEPS):
        print(f"  step {s}: loss {r0['loss'][s]:.6f} (one process "
              f"{one['loss'][s]:.6f}, gap "
              f"{_rel_gap(r0['loss'][s], one['loss'][s]):.3g}), grad_norm "
              f"{r0['grad_norm'][s]:.6f} ({one['grad_norm'][s]:.6f}, gap "
              f"{_rel_gap(r0['grad_norm'][s], one['grad_norm'][s]):.3g})"
              + (f", layer 0's picks apart from one process's: experts "
                 f"{shares[s][0]:.3%}, slots {shares[s][1]:.3%}"
                 if shares else "") + "; ms "
              + " / ".join(f"{r['step_ms'][s]:.0f}" for r in ranks)
              + f", one process {one['step_ms'][s]:.0f}")
    print("  gaps (limits: " + ", ".join(f"{k} {tol:g}" for k, tol in gated)
          + f"; loss over steps 0-{n - 1}; scales a share of a leaf's "
          f"largest, the rest relative; controls must exceed theirs; the "
          f"rest printed): "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
    print(f"  K7 {r0['k7']} a step a rank ({r0['n_leaves']} leaves x 3), in "
          f"situ (last step) {r0['in_situ']['calls']} calls "
          f"{'exact' if r0['in_situ']['exact'] else 'FAIL'} (rows up to "
          f"{r0['in_situ']['longest_row']:,})")
    print(f"  memory GB a rank: shards " + " / ".join(
        f"{r['shards_gb']:.3f}" for r in ranks) + ", peak over steps 1-3 "
        + " / ".join(f"{r['peak_gb']:.3f}" for r in ranks)
        + f" (predicted from the shapes: per layer "
          f"{peak['per_layer']:.3f}, whole-step design "
          f"{peak['whole_step']:.3f}, shards {peak['shards']:.3f}"
        + (f"; limit {limit:.3f}" if cfg.moe_experts else "")
        + f"); one process peak {one['peak_gb']:.3f}")
    wire = r0["traffic"]
    print(f"  a step's collectives a rank (gloo calls / GB sent): "
          + ", ".join(f"{k} {wire['calls'][k]} / {wire['sent'][k] / 1e9:.3f}"
                      for k in wire["calls"])
          + f"; whole params held at once at most "
            f"{wire['peak_whole_gb']:.3f} GB")
    if elastic is not None:
        same = elastic["crcs"] == r0["crcs"]
        print(f"  checkpoint {elastic['bytes']:,} bytes: save "
              f"{r0['save_s']:.1f} s (gather, rank 0 writes), restore into "
              f"one process {elastic['restore_s']:.1f} s, "
              f"{len(r0['crcs'])} leaves "
              f"{'byte for byte' if same else 'DIFFERENT'} the saved "
              f"state; its next step loss {elastic['loss']:.6f}, "
              f"grad_norm {elastic['grad_norm']:.6f} (the ranks' step "
              f"{FSDP_STEPS}: {r0['next']['loss']:.6f}, "
              f"{r0['next']['grad_norm']:.6f})")
    print(f"  {arch} part seconds on the ranks: {r0['seconds']:.1f}")
    if fails:
        raise RuntimeError(f"phase 14 ({arch}): " + "; ".join(fails))
    for r in ranks:
        for k in ("routes", "control_route", "scales", "control_local_absmax",
                  "crcs"):
            r.pop(k, None)
    one.pop("scales", None)
    return dict(card=smi, ranks=ranks, one_process=one, gaps=gaps,
                route_share_by_step=shares, predicted_peak_gb=peak,
                peak_limit_gb=limit, launches={"K7": sum(r0["k7"])},
                **({} if elastic is None else dict(elastic={
                    k: v for k, v in elastic.items() if k != "crcs"})))


# ---------------------------------------------------------------------------
# Phase 15: the examples
# ---------------------------------------------------------------------------
EXAMPLES = {"quickstart": ("CUDA kernel == plain version: True",
                           "hybrid(4-bit blocks) == int8 dot: True"),
            "serve_quantized": ("greedy streams bit-identical: True",),
            "fault_tolerance_demo": ("resumed == uninterrupted: True",)}
EXAMPLES_BUDGET_S = 60.0


def start_examples() -> dict:
    """Phase 15's examples, each in a process of its own, all started at
    once (they run beside phase 14), each waited for by a thread of its
    own that keeps its output and the seconds it took."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    runs = {}
    for name in EXAMPLES:
        run = dict(t0=time.perf_counter(), proc=subprocess.Popen(
            [sys.executable, str(root / "examples" / "torch" / f"{name}.py")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(root)))

        def wait(run=run):
            run["stdout"], run["stderr"] = run["proc"].communicate()
            run["seconds"] = time.perf_counter() - run["t0"]
        run["waiter"] = threading.Thread(target=wait, daemon=True)
        run["waiter"].start()
        runs[name] = run
    return runs


def stop_examples(runs: dict) -> None:
    for run in runs.values():
        if run["proc"].poll() is None:
            run["proc"].kill()
        run["waiter"].join()


def finish_examples(runs: dict):
    """Phase 15: each example must exit 0, print its equalities and end
    within ``EXAMPLES_BUDGET_S`` of its start."""
    out, fails = {}, []
    try:
        for name, run in runs.items():
            left = EXAMPLES_BUDGET_S - (time.perf_counter() - run["t0"])
            run["waiter"].join(timeout=max(left, 1.0))
            if run["waiter"].is_alive():
                raise RuntimeError(f"example {name} still runs after "
                                   f"{EXAMPLES_BUDGET_S:g} s")
            missing = [w for w in EXAMPLES[name] if w not in run["stdout"]]
            code = run["proc"].returncode
            print(f"  {name}: exit {code} in {run['seconds']:.1f} s"
                  + (f", missing {missing}" if missing
                     else ", equalities hold"))
            for line in run["stdout"].strip().splitlines():
                print(f"    {line}")
            if code or missing:
                fails.append(f"example {name}: exit {code}, missing "
                             f"{missing}: {run['stderr'][-2000:]}")
            if run["seconds"] > EXAMPLES_BUDGET_S:
                fails.append(f"example {name} took {run['seconds']:.1f} s "
                             f"of its {EXAMPLES_BUDGET_S:g} s")
            out[name] = dict(seconds=run["seconds"], stdout=run["stdout"])
    finally:
        stop_examples(runs)
    seconds = max(r["seconds"] for r in out.values())
    print(f"  phase 15 seconds: {seconds:.1f} beside phase 14 (limit "
          f"{EXAMPLES_BUDGET_S:g} s)")
    if fails:
        raise RuntimeError("phase 15: " + "; ".join(fails))
    return dict(runs=out, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 16: the dry run against the card
# ---------------------------------------------------------------------------
# (arch, shape, qmode, layers: None for full depth, multi-pod) of the
# cells whose rank-0 step the meta run predicts and the card then runs;
# the multi-pod cell is rank 0 of (pod, data, model) = (2, 16, 16), its
# rows' first 2,048 of 4,096 positions
DRYRUN_CELLS = (("qwen2-0.5b", "decode_32k", "w8a8", None, False),
                ("qwen3-0.6b", "train_4k", "none", 2, False),
                ("qwen3-0.6b", "train_4k", "none", 2, True))
DRYRUN_PEAK_RTOL = 0.05            # predicted peak vs the card's ...
DRYRUN_PEAK_ATOL = 64 * 2**20      # ... within 5% + 64 MiB
# The peak's two parts, each against the card's within 1% + 2 MiB (the
# gaps measured on the H100 were under 1.8 MiB): what is resident at the
# reset (the arguments and the cuBLAS workspaces) and the step's own
# bytes above it (its live peak and kernel temporaries). A control
# must fall outside each: the resident part without its workspaces, the
# step without its temporaries (its new outputs alone) and, where it
# has some, without its kernel temporaries.
DRYRUN_PART_RTOL = 0.01
DRYRUN_PART_ATOL = 2 * 2**20
DRYRUN_KERNELS = ("K1", "K5", "K7")
DRYRUN_TIMEOUT_S = 240.0


def materialize(tree, device, gen: torch.Generator):
    """A meta tree (the dry run's arguments) as real tensors on
    ``device``, the same structure and shapes: floats ~ N(0, 0.02²), int8
    payloads uniform in [-127, 127], every other integer zero (token ids,
    labels, counters). A tensor shared by two paths stays shared."""
    memo = {}

    def leaf(t):
        if id(t) not in memo:
            if t.is_floating_point():
                x = (torch.randn(t.shape, generator=gen, device=device)
                     * 0.02).to(t.dtype)
            elif t.dtype == torch.int8:
                x = torch.randint(-127, 128, t.shape, generator=gen,
                                  device=device, dtype=torch.int8)
            else:
                x = torch.zeros(t.shape, dtype=t.dtype, device=device)
            memo[id(t)] = x
        return memo[id(t)]

    def walk(node):
        if isinstance(node, torch.Tensor):
            return leaf(node)
        if isinstance(node, dict):        # RankShards, RankBatch keep theirs
            new = copy.copy(node)
            for k, v in node.items():
                new[k] = walk(v)
            return new
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name))
                for f in dataclasses.fields(node) if f.init})
        return node
    return walk(tree)


def dryrun_card_cells(conn, cells) -> None:
    """Phase 16's body, in a spawned process of its own (the fake
    process group is global to a process, so the cells of one world
    size: 256 ranks on one pod, 512 on two): for each cell, rank 0's step
    on the meta device under the fake group (the dry run's prediction,
    ``launch/dryrun.py::measure``), then the same step on the card from
    the same arguments made real; the card's peak
    (``max_memory_allocated``, reset after a warm step) beside the
    prediction."""
    try:
        t_in = time.perf_counter()
        # the card's context comes up beside the meta runs
        cuda_up = threading.Thread(target=torch.cuda.init, daemon=True)
        cuda_up.start()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.configs.shapes import SHAPES
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import fake_production_mesh
        from repro_torch.parallel.sharding import make_rules, tree_bytes
        setup_s = time.perf_counter() - t_in
        out = []
        for arch, shape_name, qmode, layers, multi in cells:
            t0 = time.perf_counter()
            shape = SHAPES[shape_name]
            mesh = fake_production_mesh(multi, train=shape.kind == "train")
            cfg = get_config(arch, qmode=qmode,
                             **({"n_layers": layers} if layers else {}))
            rules = make_rules(shape.kind, multi_pod=multi,
                               family=cfg.family)
            grad = (torch.enable_grad if shape.kind == "train"
                    else torch.no_grad)
            with grad():
                run, args = dr.build_cell(cfg, shape, mesh, rules, qmode)
                pred = dr.measure(run, args)
            meta_s = time.perf_counter() - t0
            cuda_up.join()
            dev_args = materialize(args, "cuda", torch.Generator(
                device="cuda").manual_seed(SEED))
            del args
            card_args = tree_bytes(list(dev_args))
            with grad():
                warm = run(*dev_args)
                del warm
                torch.cuda.synchronize()
                warm_s = time.perf_counter() - t0 - meta_s
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                for mod, name in COUNTERS.values():
                    setattr(mod, name, 0)
                t1 = time.perf_counter()
                res = run(*dev_args)
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t1
            peak = torch.cuda.max_memory_allocated()
            launches = {k: getattr(mod, name)
                        for k, (mod, name) in COUNTERS.items()}
            del res, dev_args
            torch.cuda.empty_cache()
            out.append(dict(
                arch=arch, shape=shape_name, qmode=qmode,
                mesh="2x16x16" if multi else "16x16",
                layers=layers or cfg.n_layers, n_layers=cfg.n_layers,
                predicted=pred["memory"], kernels=pred["kernels"],
                collectives=pred["collectives"], cost=pred["cost"],
                card_argument_bytes=card_args, card_base_bytes=base,
                card_peak_bytes=peak, launches=launches,
                setup_s=setup_s, meta_s=meta_s, warm_s=warm_s,
                step_s=step_s, seconds=time.perf_counter() - t0))
        conn.send(("ok", out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        conn.send(("error", traceback.format_exc()))


def dryrun_parts(c) -> dict:
    """The predicted peak's two parts against the card's, each with its
    gap, its limit and its controls' gaps: ``resident`` (the arguments and
    the cuBLAS workspaces, against ``memory_allocated`` at the reset) and
    ``step`` (the bytes above it, against ``max_memory_allocated`` less
    that)."""
    m, t = c["predicted"], c["predicted"]["terms"]
    card_step = c["card_peak_bytes"] - c["card_base_bytes"]
    resident = m["argument_bytes"] + t["cublas_workspace_bytes"]
    step = m["peak_bytes"] - resident
    controls = {"no temporaries": m["output_bytes"] - m["alias_bytes"]}
    if t["kernel_temp_bytes"]:
        controls["no kernel temporaries"] = step - t["kernel_temp_bytes"]
    parts = {}
    for name, pred, card, ctl in (
            ("resident", resident, c["card_base_bytes"],
             {"no workspaces": m["argument_bytes"]}
             if t["cublas_workspace_bytes"] else {}),
            ("step", step, card_step, controls)):
        parts[name] = dict(
            predicted=pred, card=card, gap=pred - card,
            limit=DRYRUN_PART_RTOL * card + DRYRUN_PART_ATOL,
            controls={k: v - card for k, v in ctl.items()})
    return parts


def dryrun_phase(smi: str, cells=DRYRUN_CELLS):
    """Phase 16: the dry run's meta model of rank 0's step held against
    the card. Gates: the card's argument bytes equal the meta run's
    exactly; the predicted peak within ``DRYRUN_PEAK_RTOL`` +
    ``DRYRUN_PEAK_ATOL`` of the card's, and each of its parts within
    ``DRYRUN_PART_RTOL`` + ``DRYRUN_PART_ATOL`` with its controls outside
    (:func:`dryrun_parts`); K1, K5 and K7 launched."""
    ctx = torch.multiprocessing.get_context("spawn")
    runs = []              # a process a world size, side by side
    for multi in sorted({c[4] for c in cells}):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=dryrun_card_cells, daemon=True, args=(
            child, [c for c in cells if c[4] == multi]))
        proc.start()
        runs.append((proc, parent))
    out, errors = [], []
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    try:
        for proc, parent in runs:
            if not parent.poll(max(deadline - time.monotonic(), 0.1)):
                raise RuntimeError(f"phase 16 gave no result in "
                                   f"{DRYRUN_TIMEOUT_S:g} s")
            status, got = parent.recv()
            if status == "ok":
                out += got
            else:
                errors.append(got)
    finally:
        for proc, _ in runs:
            proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join()
    if errors:
        raise RuntimeError("phase 16 failed:\n" + "\n".join(errors))
    fails, launched = [], {}
    print(f"  card: {smi}")
    for c in out:
        m = c["predicted"]
        gap = m["peak_bytes"] - c["card_peak_bytes"]
        limit = DRYRUN_PEAK_RTOL * c["card_peak_bytes"] + DRYRUN_PEAK_ATOL
        c["peak_gap_bytes"], c["peak_limit_bytes"] = gap, limit
        c["parts"] = dryrun_parts(c)
        for name, part in c["parts"].items():
            print(f"    {name}: predicted {part['predicted'] / 2**20:.2f} "
                  f"MiB, card {part['card'] / 2**20:.2f} MiB, gap "
                  f"{part['gap'] / 2**20:+.2f} of +-"
                  f"{part['limit'] / 2**20:.2f} MiB; controls "
                  + ", ".join(f"{k} {g / 2**20:+.2f}"
                              for k, g in part["controls"].items()))
            if abs(part["gap"]) > part["limit"]:
                fails.append(f"{c['arch']} {c['mesh']}: {name} {part['gap'] / 2**20:+.2f}"
                             f" MiB off, limit {part['limit'] / 2**20:.2f}")
            for k, g in part["controls"].items():
                if abs(g) <= part["limit"]:
                    fails.append(f"{c['arch']} {c['mesh']}: {name}'s control '{k}' "
                                 f"passed ({g / 2**20:+.2f} MiB)")
        for k, n in c["launches"].items():
            launched[k] = launched.get(k, 0) + n
        print(f"  {c['arch']} x {c['shape']} on {c['mesh']} ({c['qmode']}, "
              f"{c['layers']} layers): arguments meta {m['argument_bytes']:,} / card "
              f"{c['card_argument_bytes']:,} B; peak predicted "
              f"{m['peak_bytes'] / 2**20:.1f} MiB, card "
              f"{c['card_peak_bytes'] / 2**20:.1f} MiB (resident at the "
              f"reset {c['card_base_bytes'] / 2**20:.1f} MiB), gap "
              f"{gap / 2**20:+.1f} of +-{limit / 2**20:.1f} MiB; meta "
              f"{c['meta_s']:.1f} s, arguments made real and a warm step "
              f"{c['warm_s']:.1f} s, card step {c['step_s']:.2f} s (the "
              f"process's setup {c['setup_s']:.1f} s); "
              f"launches {({k: n for k, n in c['launches'].items() if n})}")
        if c["card_argument_bytes"] != m["argument_bytes"]:
            fails.append(f"{c['arch']} {c['mesh']}: argument bytes apart")
        if abs(gap) > limit:
            fails.append(f"{c['arch']} {c['mesh']}: peak {gap / 2**20:+.1f} MiB off, "
                         f"limit {limit / 2**20:.1f}")
    missing = [k for k in DRYRUN_KERNELS if not launched.get(k)]
    if missing:
        fails.append(f"not launched: {missing}")
    if fails:
        raise RuntimeError("phase 16: " + "; ".join(fails))
    return dict(cells=out, card=smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measurement here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="autotune-") as cache_dir:
        # an autotune cache left on the machine must never change a phase
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            cache_dir, "autotune.json")
        autotune.clear_cache()
        return smoke(args)


def smoke(args) -> int:
    """Phases 1-17 (module docstring); raises on any failure."""
    t_all = time.perf_counter()
    phase_s, last = {}, [t_all]

    def lap(phase):
        now = time.perf_counter()
        phase_s[str(phase)] = round(now - last[0], 1)
        last[0] = now
        print(f"[phase {phase}] seconds: {phase_s[str(phase)]}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[chip_smoke] {torch.cuda.get_device_name(0)}; {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_ptxas(tmp)
        build.build_all()
        print(f"[phase 1] built {', '.join(build.KERNELS)} in "
              f"{time.perf_counter() - t0:.1f} s")
        ptxas = ptxas_report(procs)
        tc_ptxas = tc_ptxas_report(procs)
        k7_ptxas = k7_ptxas_report(procs)
    sass = k8_sass()
    gemm_sass = tc_sass()
    lap(1)

    print("[phase 2] kernels vs plain versions at the serving shapes")
    timer, gen = Timer(), phase_gen(2)
    k1_shapes = [(m, k, n) for m in (1, 8, 256)
                 for k, n in ((896, 896), (896, 128), (896, 4864),
                              (4864, 896))]
    both = (torch.bfloat16, torch.float32)
    rows = (check_fused(timer, gen, "w8a8", k1_shapes, (torch.bfloat16,))
            + check_fused(timer, gen, "w8a8", RAGGED_SHAPES, both)
            + check_fused(timer, gen, "w4a8", SERVING_SHAPES + RAGGED_SHAPES,
                          both)
            + check_fused(timer, gen, "w4a4", SERVING_SHAPES + RAGGED_SHAPES,
                          both)
            + check_unfused(timer, gen, "i8") + check_unfused(timer, gen, "w4")
            + check_unfused(timer, gen, "a4w4") + check_k7(timer, gen)
            + check_fused(timer, gen, "w8a8", MOE_EXPERT_SHAPES,
                          (torch.bfloat16,), out_dtype=torch.float32,
                          epilogues=("none",))
            + check_fused(timer, gen, "w8a8", MOE_HEAD_SHAPES,
                          (torch.bfloat16,), epilogues=("none",)))
    k5_controls = [k5_dropped_split(gen, kind, shape)
                   for kind in ("i8", "w4", "a4w4")
                   for shape in ((256, 4864, 896), (8, 4864, 896))]
    k1_controls = fused_controls(gen)
    scale_modes = fused_scale_modes(timer, gen)
    k3_rows, k3_controls = check_k3(timer, gen)
    rows += k3_rows + check_k2(timer, gen)
    k2_splits = k2_split_sweep(timer, gen)
    gate(rows, "phase 2")
    lap(2)

    served, engines = {}, {}
    for qmode in QMODES:
        print(f"[phase 3] full-width qwen2-0.5b {qmode.upper()} serving")
        served[qmode], engine, prompts = serve(SEED, qmode)
        engines[qmode] = (engine, prompts)
        torch.cuda.empty_cache()
    print("[phase 3] the three modes' serving runs again, in turns")
    in_turns = serve_in_turns(engines)
    del engines
    lap(3)

    print("[phase 4] the unfused path: camp_matmul(fused=False) at the "
          "serving shapes")
    unfused = unfused_path(timer, phase_gen(4))
    lap(4)

    print("[phase 5] K8 flash attention through flash_attention, at the "
          "qwen2-0.5b, qwen3-0.6b and stablelm-12b shapes and hd 8-256 "
          "ragged")
    flash = check_k8(phase_gen(5))
    gate(flash["rows"], "phase 5")
    torch.cuda.empty_cache()
    lap(5)

    print("[phase 6] full-width qwen2-0.5b W8A8 dense-slab serving and "
          "float pages")
    dense = dense_serving(SEED)
    torch.cuda.empty_cache()
    lap(6)

    print(f"[phase 7] stablelm-12b's heads (hd 160, 32/8) at full width, "
          f"{STABLELM_LAYERS} of 40 layers, W8A8 on the paged engine")
    stablelm = serve_stablelm(SEED)
    torch.cuda.empty_cache()
    lap(7)

    print("[phase 8] speculative decoding: full-width qwen2-0.5b on the "
          "paged engine, n-gram and draft-model drafters")
    spec = speculative(SEED)
    torch.cuda.empty_cache()
    lap(8)

    print(f"[phase 9] MoE serving: {MOE_ARCH} at full width, W8A8 at "
          f"{MOE_W8A8_LAYERS} of 48 layers, W4A8 and W4A4 at "
          f"{MOE_CUT_LAYERS}, on the paged engine")
    moe = moe_serving(SEED, smi)
    torch.cuda.empty_cache()
    lap(9)

    print(f"[phase 10] recurrent mixers and embedding inputs on the "
          f"dense-slab loop: jamba-v0.1-52b ({REC_LAYERS} of 32 layers) and "
          f"rwkv6-7b (32) W8A8 at full width, jamba W4A8 / W4A4, "
          f"pixtral-12b and musicgen-large ({FRONT_LAYERS} layers) from "
          f"float embeddings")
    recurrent = recurrent_serving(SEED, smi)
    torch.cuda.empty_cache()
    lap(10)

    print(f"[phase 11] training: full-width {TRAIN_ARCH} for {TRAIN_STEPS} "
          f"steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens with f32 moments, "
          f"then int8 moments and int8 gradients (K7)")
    trained = training(SEED, smi, timer, phase_gen(11))
    rows += trained["k7_rows"]
    torch.cuda.empty_cache()
    lap(11)

    print(f"[phase 12] the autotune: {AUTOTUNE_ARCH}'s page size and chunk, "
          f"its GEMM plans in W8A8, W4A8 and W4A4 (bit for bit), the tuned "
          f"engine against the fixed one in turns")
    tuned = autotune_phase(SEED, timer, phase_gen(12), smi)
    torch.cuda.empty_cache()
    lap(12)

    print(f"[phase 13] tensor-parallel serving: full-width {TP_ARCH} W8A8 "
          f"served by {TP_RANKS} ranks (processes sharing the card through "
          f"gloo) against one process; {TP_INDIV_RANKS} ranks, which do not "
          f"divide its kv heads")
    gen13 = phase_gen(13)
    k1_shards = tp_shard_k1(timer, gen13)
    gate(k1_shards, "phase 13: K1 at the tp shard shapes")
    rows += k1_shards
    tp = tp_serving(SEED, smi)
    torch.cuda.empty_cache()
    print(f"[phase 13] every model family under the mesh: {MOE_ARCH} W8A8 "
          f"({TP_MOE_LAYERS} of 48 layers) with its experts split over "
          f"{TP_RANKS} ranks on the paged engine")
    moe_shards = tp_moe_kernels(timer, gen13)
    gate(moe_shards, "phase 13: K1, K7 and K5 at the expert shard shapes")
    rows += moe_shards
    families = tp_families(SEED, smi)
    torch.cuda.empty_cache()
    print(f"[phase 13] the dense slab on shards: "
          f"{', '.join(SLAB_LAYERS)} under the serve rules on (1, 2); "
          f"{SEQ_ARCH} under the decode rules on (1, {SEQ_RANKS}), its int8 "
          f"slab split along the sequence; {MOE_ARCH} on (2, 1), its experts "
          f"split over data, and on (2, 2) under the hillclimb's B2 "
          f"(experts over model)")
    int32_rows = int32_sums(timer, gen13)
    gate(int32_rows, "phase 13: K5 / K6a / K6b with int32 out")
    rows += int32_rows
    slab = dense_slab_mesh(SEED, smi)
    torch.cuda.empty_cache()
    lap(13)

    print("[phase 15] the examples on the card (quickstart, "
          "serve_quantized, fault_tolerance_demo) start, beside phase 14")
    procs = start_examples()
    try:
        print(f"[phase 14] sharded training at full width, one layer "
              f"gathered at a time: "
              + ", ".join(f"{a} ({v['layers']} layers, {v['mesh']})"
                          for a, v in FSDP_FAMILIES.items()) + " "
              f"(processes sharing the card through gloo), int8 moments and "
              f"gradients, against one process; {TRAIN_ARCH}'s checkpoint "
              f"restored into one process; then "
              + ", ".join(MULTIPOD_FAMILIES) + " under the multi-pod "
              f"train rules on {MULTIPOD_MESH}")
        fsdp = fsdp_training(SEED, smi)
        torch.cuda.empty_cache()
    except BaseException:
        stop_examples(procs)
        raise
    print("[phase 15] the examples' results")
    examples = finish_examples(procs)
    lap("14 + 15")

    print("[phase 16] the dry run against the card: rank 0's step of "
          + ", ".join(f"{a} x {s} on {'2x16x16' if m else '16x16'} "
                      f"({q}{f', {n} layers' if n else ''})"
                      for a, s, q, n, m in DRYRUN_CELLS)
          + " on the meta device under a fake process group of the mesh's "
          "world size, then on the card")
    dry = dryrun_phase(smi)
    lap(16)

    # one headline row per kernel: the decode gate GEMM (K1, K4), the
    # prefill down projection (K5, K6), the widest K7 in bf16, the K3 bf16
    # batch, the K2 chunk at q_start 512 in bf16, K8 at prefill_32k's
    # length; errors over every case
    def pick(key, **want):
        return next(r for r in rows if r["kernel"] == key
                    and all(r[a] == b for a, b in want.items()))
    decode_gate = dict(m=8, k=896, n=4864, epilogue="silu",
                       dtype=str(torch.bfloat16))
    prefill_down = dict(m=256, k=4864, n=896, epilogue="none")
    headline = {
        "K1": pick("K1", **decode_gate),
        "K4 w4a8": pick("K4 w4a8", **decode_gate),
        "K4 w4a4": pick("K4 w4a4", **decode_gate),
        "K5": pick("K5", **prefill_down), "K6a": pick("K6a", **prefill_down),
        "K6b": pick("K6b", **prefill_down),
        "K7": pick("K7", m=256, k=4864, bits=8, dtype=str(torch.bfloat16)),
        "K2": pick("K2", label="serving", q_start=512,
                   dtype=str(torch.bfloat16)),
        "K3": pick("K3", label="serving", dtype=str(torch.bfloat16)),
        "K8": next(r for r in flash["rows"] if r["s"] == 32768)}
    rows += flash["rows"]
    # the path whose run counts each kernel's launches
    path_of = {"K1": "w8a8", "K2": "w8a8", "K3": "w8a8", "K4 w4a8": "w4a8",
               "K4 w4a4": "w4a4", "K5": "unfused", "K6a": "unfused",
               "K6b": "unfused", "K7": "train int8", "K8": "flash"}
    counts = {q: served[q]["launches"] for q in QMODES}
    counts["unfused"] = unfused["launches"]
    counts["flash"] = flash["launches"]
    for q in QMODES:
        counts["moe " + q] = moe[q]["launches"]
    for label, run in recurrent.items():
        if label != "seconds":
            counts[label] = run["run"]["launches"]
    counts["train int8"] = trained["int8 moments + int8 gradients"][
        "launches"]
    counts[f"tp{TP_RANKS} rank 0"] = tp["launches"]
    counts[f"tp{TP_RANKS} moe rank 0"] = families["launches"]
    counts.update(slab["launches"])
    for arch, part in fsdp["families"].items():
        counts[f"fsdp {arch} rank 0"] = part["launches"]
    for arch, part in fsdp["multi_pod"].items():
        counts[f"fsdp multi-pod {arch} rank 0"] = part["launches"]
    kernels = []
    for key, meta in KERNELS.items():
        h = headline[key]
        kernels.append(dict(
            meta, launches=counts[path_of[key]][key],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["kernel"] == key),
            ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=h["library_ms"],
            path=path_of[key],
            launches_by_path={path: n[key] for path, n in counts.items()
                              if n.get(key)}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=smi, ptxas=ptxas, tc_ptxas=tc_ptxas,
                 k7_ptxas=k7_ptxas, k8_sass=sass,
                 tc_sass=gemm_sass, k5_controls=k5_controls,
                 k1_controls=k1_controls, scale_modes=scale_modes, rows=rows,
                 k3_controls=k3_controls, k2_splits=k2_splits,
                 serving=served, in_turns=in_turns, unfused=unfused,
                 dense=dense, stablelm=stablelm, spec=spec, moe=moe,
                 recurrent=recurrent, training=trained, autotune=tuned,
                 tensor_parallel=tp, tp_families=families, dense_slab=slab,
                 fsdp=fsdp, examples=examples, dryrun=dry,
                 kernels=kernels, phase_s=phase_s),
            indent=1))
    print(f"[chip_smoke] seconds by phase: {phase_s}")
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
