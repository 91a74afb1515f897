"""Every model family under a serving mesh: MoE experts split over the
model axis on the paged engine, and the dense slab under ``generate(mesh=)``.

One spawned group of four gloo CPU ranks (``tests/torch_tp_worker.py::
moe_serving``) runs every case; meanwhile this process runs the port's
one-process engine on the same inputs:

* reduced moonshot-v1-16b-a3b (4/4 heads: attention sharded) and reduced
  llama4-maverick-400b-a17b (1 kv head: attention whole, dense and MoE
  layers alternating), with the reference's weights carried across, in
  none (f32), w8a8, w4a8 and w4a4 at tp 2 (ranks 0-1 and 2-3 split the
  cases) and at tp 4 (the shapes divide);
* each rank holds its column and row blocks of every expert; gate and up
  give one process's columns bit for bit; the first MoE layer's FFN is
  within one bf16 ULP of max |y| of one process's (f32: 1e-5 · max |y|),
  and the shard-local-scale control misses that bound in every integer
  mode (the down projection's scale is the whole row's, as under the
  reference's GSPMD);
* f32 greedy streams equal the port's one-process engine and the
  reference's replicated engine (``tests/tp_reference.json``, whose
  weights' SHA-256 is checked); first-step logits within 2e-4 there; in
  w8a8 within 5% of max |logit| (the span ``tests/test_torch_collectives.py``
  holds the dense row-parallel reduce to), with the f32 reduce and with
  the int8 wire; the int4 modes' first-step logits within chip_smoke's
  ``LOGIT_TOL`` of one process's; host state equal to one process's;
  every rank of a mesh alike; an n-gram speculative run equal to the
  plain stream; ``warm_gemm_autotune(tp=)`` covers every expert GEMM the
  forwards launched (the down projection unfused: K7, then K5/K6a/K6b);
* reduced jamba, rwkv6, pixtral and musicgen through ``generate(mesh=)``
  on 2 ranks, each on its shards, give ``tests/recurrent_reference.json``'s
  streams, and a temperature run whose ranks hold other seeds follows
  rank 0's tokens.
"""
import concurrent.futures
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_tp_worker  # noqa: E402
from recurrent_reference import CASES as REC_CASES  # noqa: E402
from recurrent_reference import JSON_PATH as REC_JSON  # noqa: E402
from recurrent_reference import STEPS as REC_STEPS  # noqa: E402
from recurrent_reference import config as rec_config  # noqa: E402
from recurrent_reference import prompt as rec_prompt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import quantize_params as jax_quantize  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch.kernels.camp_gemm_fused import KIND  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.serving.engine import (serving_gemm_shapes,  # noqa: E402
                                        warm_gemm_autotune)
from spec_reference import weight_digest as rec_digest  # noqa: E402
from torch_parity import jax_to_numpy  # noqa: E402
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)
from torch_parity import one_thread  # noqa: E402,F401 (autouse)
from tp_reference import (CHUNK, MOE_ARCHS, MOE_NEW, MOE_SNAP,  # noqa: E402
                          PS, load, moe_overrides, moe_prompts, prompts,
                          weight_digest)

QMODES = ("none", "w8a8", "w4a8", "w4a4")
MOONSHOT, LLAMA4 = MOE_ARCHS
TP2 = [[f"{MOONSHOT}/{q}" for q in QMODES], [f"{LLAMA4}/{q}" for q in QMODES]]
TP4 = [f"{a}/{q}" for a in MOE_ARCHS for q in QMODES]
SPEC_CASE = f"{MOONSHOT}/none"
# the dense-slab models, one recorded case each, split over the two pairs
SLAB_QMODE = {"jamba-v0.1-52b": "w8a8", "rwkv6-7b": "none",
              "pixtral-12b": "w4a8", "musicgen-large": "w4a4"}
SLAB = [["jamba-v0.1-52b", "rwkv6-7b"], ["pixtral-12b", "musicgen-large"]]
RTOL = ATOL = 2e-4         # f32 logits (test_torch_tp_serving.py)
W8A8_SPAN = 0.05           # w8a8 logits, share of max |logit|
LOGIT_TOL = {"w4a8": 0.10, "w4a4": 1.00}    # chip_smoke.py's
F32_FFN = 1e-5             # the f32 FFN's gap, share of max |y|


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def moe_draw(arch, dtype):
    """One draw of the reduced ``arch`` (dtype None: the config's bf16)
    and its cases: {"arch/qmode": (port cfg, port params, reference
    params as numpy)}: none from the f32 draw, the integer modes from the
    bf16 one."""
    qmodes = ("none",) if dtype else QMODES[1:]
    jp = None
    out = {}
    for qmode in qmodes:
        over = moe_overrides(qmode, dtype)
        jcfg = jax_get_config(arch, **over)
        if jp is None:
            jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
        tree = jax_to_numpy(jp if qmode == "none"
                            else jax_quantize(jp, jcfg, qmode))
        out[f"{arch}/{qmode}"] = (get_config(arch, **over),
                                  from_jax_params(tree, device="cpu"), tree)
    return out


def slab_case(arch):
    """(port cfg, params, prompt, steps, recorded streams, the recorded
    and the converted weights' SHA-256) of ``arch``'s recorded case."""
    qmode = SLAB_QMODE[arch]
    dtype = dict(REC_CASES)[qmode]
    jcfg = rec_config(arch, qmode, dtype, jax_get_config)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    if qmode != "none":
        jp = jax_quantize(jp, jcfg, qmode)
    tree = jax_to_numpy(jp)
    cfg = rec_config(arch, qmode, dtype, get_config)
    x = torch.from_numpy(rec_prompt(cfg))
    x = x.to(torch.bfloat16) if cfg.embedding_inputs else x.long()
    case = json.loads(REC_JSON.read_text())["cases"][f"{arch}/{qmode}"]
    return (cfg, from_jax_params(tree, device="cpu"), x, REC_STEPS,
            case["streams"], case["weights_sha256"], rec_digest(tree))


def build_inputs():
    """(MoE cases, dense-slab cases), the reference's draws made in
    threads (eager JAX compiles each op on first use)."""
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        draws = [pool.submit(moe_draw, arch, dtype) for arch in MOE_ARCHS
                 for dtype in ("float32", None)]
        slab = {arch: pool.submit(slab_case, arch) for arch in SLAB_QMODE}
        trees = {}
        for fut in draws:
            trees.update(fut.result())
        return trees, {arch: fut.result() for arch, fut in slab.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's outputs, the one-process runs, the recording, the MoE
    trees, the dense-slab cases)."""
    d = tmp_path_factory.mktemp("tp_moe")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the ranks start up while the inputs are built; they wait for
        # the file, written whole under another name first
        fut = pool.submit(spawn_ranks, torch_tp_worker.moe_serving, 4,
                          init_dir=str(d), backend="gloo", device="cpu",
                          args=(d / "inputs.pt",), timeout=300)
        trees, slab = build_inputs()
        t = [torch.from_numpy(p.astype(np.int64)) for p in moe_prompts()]
        spec = [torch.from_numpy(p.astype(np.int64))
                for p in prompts()["spec"]]
        torch.save({"moe": {k: v[:2] for k, v in trees.items()},
                    "moe_prompts": t, "moe_new": MOE_NEW,
                    "moe_snap": MOE_SNAP, "page_size": PS, "chunk": CHUNK,
                    "spec_prompts": spec, "spec_case": SPEC_CASE,
                    "tp2": TP2, "tp4": TP4, "slab": SLAB,
                    "slab_cases": {k: v[:4] for k, v in slab.items()}},
                   d / "inputs.tmp")
        os.replace(d / "inputs.tmp", d / "inputs.pt")
        one = {}
        for case, (cfg, params, _) in trees.items():
            one[case] = {
                "engine": torch_tp_worker.run_engine(
                    params, cfg, t, MOE_NEW, None, ps=PS, snap_at=MOE_SNAP),
                "first": torch_tp_worker.first_logits(
                    params, cfg, t[0], CHUNK, None).numpy()}
        one["spec_base"] = torch_tp_worker.run_engine(
            trees[SPEC_CASE][1], trees[SPEC_CASE][0], spec, 10, None, ps=PS)
        ranks = fut.result()
    return ranks, one, load(), trees, slab


def tp_cases(ranks):
    """(tp, case, rank, its outputs) of every MoE case on every rank."""
    for tp, key in ((2, "tp2"), (4, "tp4")):
        for r, out in enumerate(ranks):
            for case, got in out[key].items():
                yield tp, case, r, got


def test_moe_recording_holds_the_reference_weights(runs):
    *_, rec, trees, slab = runs
    for case in rec["moe"]:
        assert weight_digest(trees[case][2]) == rec["moe"][case]["digest"], \
            "reference weights changed: rerun tests/tp_reference.py"
    for arch, case in slab.items():
        assert case[5] == case[6], arch


def test_every_case_ran_on_both_meshes(runs):
    ranks, *_ = runs
    seen = {(tp, case) for tp, case, _, _ in tp_cases(ranks)}
    assert seen == ({(2, c) for pair in TP2 for c in pair}
                    | {(4, c) for c in TP4})


def test_each_rank_holds_its_expert_blocks(runs):
    ranks, _, _, trees, _ = runs
    for tp, case, _, got in tp_cases(ranks):
        cfg = trees[case][0]
        e, d, f = cfg.moe_experts, cfg.d_model, cfg.expert_ff
        assert got["w_gate"] == (e, d, f // tp), case
        assert got["w_down"] == (e, f // tp, d), case
        want = {"experts", "embedding", "lm_head"}
        want |= {"heads", "wo"} if case.startswith(MOONSHOT) else {"mlp"}
        assert set(got["layout"]) == want, (tp, case)
        assert got["engine"]["tp"] == (tp if case.startswith(MOONSHOT)
                                       else 1)


def test_gate_up_give_one_process_columns_bit_for_bit(runs):
    ranks, _, _, trees, _ = runs
    for tp, case, r, got in tp_cases(ranks):
        assert got["ffn"]["gate_up_equal"] == [True, True], (tp, case, r)
        assert got["ffn"]["gate_n"] == trees[case][0].expert_ff // tp


def test_moe_ffn_whole_row_scale_and_its_control(runs):
    ranks, *_ = runs
    for tp, case, r, got in tp_cases(ranks):
        ffn = got["ffn"]
        top = float(np.abs(ffn["one"]).max())
        gap = float(np.abs(ffn["tp"] - ffn["one"]).max())
        if case.endswith("/none"):
            assert gap <= F32_FFN * top, (tp, case, gap, top)
            continue
        ulp = bf16_ulp(top)
        control = float(np.abs(ffn["control"] - ffn["one"]).max())
        assert gap <= ulp, (tp, case, r, gap, ulp)
        assert control > ulp, ("shard-local control passed", tp, case, r,
                               control, ulp)


def test_f32_streams_equal_one_process_and_the_reference(runs):
    ranks, one, rec, _, _ = runs
    for tp, case, _, got in tp_cases(ranks):
        if case.endswith("/none"):
            assert got["engine"]["tokens"] == one[case]["engine"]["tokens"] \
                == rec["moe"][case]["tokens"], (tp, case)


def test_first_step_logits_within_limits(runs):
    ranks, one, rec, _, _ = runs
    for tp, case, _, got in tp_cases(ranks):
        lg, base = got["first"], one[case]["first"]
        qmode = case.split("/")[1]
        if qmode == "none":
            for want in (base, rec["moe"][case]["first"]):
                np.testing.assert_allclose(lg, want, rtol=RTOL, atol=ATOL,
                                           err_msg=f"tp {tp} {case}")
            continue
        tol = W8A8_SPAN if qmode == "w8a8" else LOGIT_TOL[qmode]
        wants = [base] + ([rec["moe"][case]["first"]] if qmode == "w8a8"
                          else [])
        for want in wants:
            gap = np.abs(lg - want).max() / np.abs(want).max()
            assert gap <= tol, (tp, case, gap)


def test_w8a8_int8_wire_within_logit_limits(runs):
    ranks, one, rec, _, _ = runs
    for tp, case, _, got in tp_cases(ranks):
        if not case.endswith("/w8a8"):
            continue
        for want in (one[case]["first"], rec["moe"][case]["first"]):
            gap = np.abs(got["wire_first"] - want).max() / np.abs(want).max()
            assert gap <= W8A8_SPAN, (tp, case, gap)
        wire = got["wire"]
        assert wire["end"] == one[case]["engine"]["end"]
        assert [len(s) for s in wire["tokens"]] == [MOE_NEW] * 3
        assert all(0 <= t < 512 for s in wire["tokens"] for t in s)


def test_host_state_equals_one_process(runs):
    ranks, one, rec, _, _ = runs
    for tp, case, _, got in tp_cases(ranks):
        for when in ("mid", "end"):
            assert got["engine"][when] == one[case]["engine"][when], \
                (tp, case, when)
            if case in rec["moe"]:
                assert got["engine"][when] == rec["moe"][case][when]


def test_ranks_of_a_mesh_agree(runs):
    ranks, *_ = runs
    for key, members in (("tp2", (0, 1)), ("tp2", (2, 3)),
                         ("tp4", (0, 1, 2, 3))):
        first = ranks[members[0]][key]
        for r in members[1:]:
            for case, got in ranks[r][key].items():
                want = first[case]
                for k in ("engine", "wire", "spec", "spec_base"):
                    assert got.get(k) == want.get(k), (key, case, k)
                np.testing.assert_array_equal(got["first"], want["first"])
                np.testing.assert_array_equal(got["ffn"]["tp"],
                                              want["ffn"]["tp"])


def test_speculative_moe_stream_equals_plain(runs):
    ranks, one, *_ = runs
    got = ranks[0]["tp2"][SPEC_CASE]
    assert got["spec"]["tokens"] == got["spec_base"]["tokens"] \
        == one["spec_base"]["tokens"]
    assert got["spec"]["end"] == got["spec_base"]["end"]
    s = got["spec"]["spec"]
    assert s["proposed"] > 0 and s["accepted"] > 0, "speculation inactive"


def test_warm_gemm_autotune_covers_the_expert_shards(runs):
    ranks, _, _, trees, _ = runs
    unfused = 0
    for tp, case, _, got in tp_cases(ranks):
        cfg = trees[case][0]
        if cfg.qmode == "none":
            assert got["expert_gemms"] == []
            continue
        shapes = {tuple(s) for s in got["expert_gemms"]}
        sizes = tuple(sorted(set(got["moe_tokens"])))
        assert shapes <= serving_gemm_shapes(cfg, batch_sizes=sizes, tp=tp)
        warm_gemm_autotune(cfg, batch_sizes=sizes, tp=tp, measure=False)
        for fused, m, n, k in shapes:
            assert autotune.has_cached(KIND[cfg.qmode], m, n, k, fused=fused,
                                       a_in_bytes=2), (tp, case, m, n, k)
        down = {(m, n, k) for fused, m, n, k in shapes if not fused}
        assert {k for _, _, k in down} == {cfg.expert_ff // tp}, case
        unfused += len(down)
    assert unfused


@pytest.mark.parametrize("arch", list(SLAB_QMODE))
def test_dense_slab_under_a_mesh_matches_recording(runs, arch):
    """Each rank holds its shards (fewer bytes than the whole model) and
    the streams are the recording's."""
    ranks, *_, slab = runs
    want = slab[arch][4]
    pair = next(i for i, archs in enumerate(SLAB) if arch in archs)
    for r in (2 * pair, 2 * pair + 1):
        got = ranks[r]["dense_slab"][arch]
        assert got["layout"], (arch, r, "no part held as shards")
        assert got["bytes"] < got["whole_bytes"], (arch, r)
        assert got["tokens"].shape == (len(want), REC_STEPS)
        assert got["tokens"].tolist() == want, (arch, r)


def test_dense_slab_follows_rank_0s_tokens(runs):
    ranks, *_ = runs
    for pair in (0, 1):
        a, b = (ranks[2 * pair + i]["slab_temp"] for i in (0, 1))
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert not np.array_equal(a["tokens"], b["own"]), \
            "rank 1's own seed drew rank 0's stream"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_quantized_params_shards_moe_layers_as_the_whole(arch):
    """``init_quantized_params(mesh=)`` builds and shards an MoE model a
    layer at a time into the tree ``shard_params`` cuts from the whole."""
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.models import (init_params, init_quantized_params,
                                    quantize_params)
    from repro_torch.parallel import sharding as tsh
    from repro_torch.tree import leaves_with_path

    class Mesh:
        shape = {"data": 1, "model": 2}
        coords = {"data": 0, "model": 1}

    cfg = get_config(arch, reduced=True, qmode="w4a8")
    whole = tsh.shard_params(quantize_params(init_params(
        cfg, generator=torch.Generator().manual_seed(3), device="cpu"),
        cfg, "w4a8"), Mesh(), cfg)
    got = init_quantized_params(cfg, "w4a8", device="cpu", mesh=Mesh(),
                                generator=torch.Generator().manual_seed(3))
    assert got.layout == whole.layout and "experts" in got.layout
    flat = dict(leaves_with_path(whole))
    assert [p for p, _ in leaves_with_path(got)] == list(flat)
    for path, leaf in leaves_with_path(got):
        want = flat[path]
        if isinstance(leaf, QuantizedTensor):
            assert torch.equal(leaf.q, want.q), path
            leaf, want = leaf.scale, want.scale
        assert torch.equal(leaf, want), path
