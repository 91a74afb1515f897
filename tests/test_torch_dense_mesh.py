"""The dense slab on shards: every family's params as shards under the
serve rules, and the prefill / decode rules on a (data, model) mesh.

One spawned group of four gloo CPU ranks (``tests/torch_dense_mesh_worker.
py::dense_mesh``) runs every sharded case while this process builds the
inputs (the reference's weights, carried across) and runs the port's one
process on them:

* **part A**, the serve rules on (1, 2): reduced jamba, rwkv6, pixtral and
  musicgen, each rank on its shards (RWKV heads and channel-mix blocks,
  Mamba's block of d_inner, attention heads where the kv heads divide,
  MLP and experts, vocabulary). f32 (qmode none) streams equal
  ``tests/recurrent_reference.json`` and one process; W8A8 layer 0's
  row-parallel projections equal one process's bit for bit (the whole
  row's scale, int32 sums added over the ranks) while the
  shard-local-scale control lands more than one bf16 ULP of max |y|
  away; W8A8 streams and logits equal one process's bit for bit and the
  recording. In this process: every leaf's serve-rule spec equals the
  reference's (``tests/dense_mesh_reference.json``) but the documented
  whole attention; a rank's bytes are below the whole model's and its
  leaves are slices of the whole;
* **part B**, the decode rules: reduced qwen2-0.5b on (1, 2), its one kv
  head not dividing 2, so its int8 slab splits along the sequence (each
  rank half the positions, in whole pages of the int8 slab); f32 logits
  (the float slab) within 1e-5 of one process and of the reference's
  decode-rule recording at every step; dropping rank 1's partial from
  the split softmax lands outside; the int8 slab's blocks side by side
  are one process's slab (layer 0 bit for bit; later layers within one
  int8 step, printed). Reduced moonshot on (2, 1) and (2, 2): layer 0's
  MoE output equal to one process's (W8A8 bit for bit, f32 within 1e-5
  of max |y|), each data rank running the expert GEMMs of its E/2
  experts (counted), the streams equal to one process's and the
  recording;
* **the hillclimb's B2**: the decode rules with the experts over model and
  ``expert_ff`` over data, reduced moonshot on (2, 2): the weights where
  the reference's ``params_pspecs`` puts them (the override moves none),
  each model rank running E/2 experts' GEMMs on its data rank's block of
  ``expert_ff`` for every data rank's slots; layer 0's MoE output and the
  streams and logits equal one process's (W8A8, W4A8 and W4A4 bit for
  bit, f32 within 1e-5) and the recording (W8A8 streams; f32 logits
  within 1e-5 at every step; the 4-bit modes have none), while h
  quantized with shard-local scales (each rank's own ``expert_ff``
  block) lands outside.
"""
import concurrent.futures
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_dense_mesh_worker as worker  # noqa: E402
from dense_mesh_reference import CASES as DM_CASES  # noqa: E402
from dense_mesh_reference import JSON_PATH as DM_JSON  # noqa: E402
from dense_mesh_reference import (BATCH, PROMPT_LEN, SEQ_CASE,  # noqa: E402
                                  STEPS, spec_list)
from dense_mesh_reference import config as dm_config  # noqa: E402
from dense_mesh_reference import prompt as dm_prompt  # noqa: E402
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
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import init_params, quantize_params  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.serving.engine import init_serve_caches  # noqa: E402
from spec_reference import weight_digest  # noqa: E402
from torch_parity import jax_to_numpy  # noqa: E402
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)
from torch_parity import one_thread  # noqa: E402,F401 (autouse)

ARCHS = ("jamba-v0.1-52b", "rwkv6-7b", "pixtral-12b", "musicgen-large")
PAIRS = [list(ARCHS[:2]), list(ARCHS[2:])]
MOONSHOT = "moonshot-v1-16b-a3b"
MOON_CASES = {"none": "moonshot f32", "w8a8": "moonshot w8a8"}
EXPERT_MESHES = ("experts (2, 1)", "experts (2, 2)")
SEQ_TOL = 1e-5             # f32 logits of the sequence-split slab
F32_TOL = 1e-5             # f32 MoE outputs, a share of max |y|
# the parts a (1, 2) rank holds: attention only where the kv heads divide
PARTS = {"jamba-v0.1-52b": {"attn_cols", "mamba", "mlp", "experts",
                            "embedding", "lm_head"},
         "rwkv6-7b": {"rwkv_tm", "rwkv_cm", "embedding", "lm_head"},
         "pixtral-12b": {"attn_cols", "mlp", "embedding", "lm_head"},
         "musicgen-large": {"heads", "wo", "mlp", "embedding", "lm_head"}}


class Mesh:
    """A rank's view of a (1, 2) mesh, for the specs and the shards."""
    shape = {"data": 1, "model": 2}

    def __init__(self, rank=1):
        self.coords = {"data": 0, "model": rank}


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def reference_tree(arch, qmode, dtype, cfg_fn, jcfg=None):
    """The reference's weights of a reduced config, as numpy."""
    jcfg = jcfg or cfg_fn(jax_get_config)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jax_to_numpy(jp if qmode == "none" else
                        jax_quantize(jp, jcfg, qmode))


def part_a_case(arch):
    """{qmode: (cfg, params, prompt, steps)} of ``arch``'s f32 and W8A8
    cases of ``tests/recurrent_reference.py``, and each one's weights'
    SHA-256."""
    out, digests = {}, {}
    for qmode in ("none", "w8a8"):
        dtype = dict(REC_CASES)[qmode]
        tree = reference_tree(arch, qmode, dtype, lambda g: rec_config(
            arch, qmode, dtype, g))
        cfg = rec_config(arch, qmode, dtype, get_config)
        x = torch.from_numpy(rec_prompt(cfg))
        x = x.to(torch.bfloat16) if cfg.embedding_inputs else x.long()
        out[qmode] = (cfg, from_jax_params(tree, device="cpu"), x, REC_STEPS)
        digests[qmode] = weight_digest(tree)
    return out, digests


def dm_case(name):
    """(cfg, params, prompt, steps) of a case of ``tests/
    dense_mesh_reference.py``, and its weights' SHA-256."""
    arch, qmode, dtype, _, _ = DM_CASES[name]
    tree = reference_tree(arch, qmode, dtype, lambda g: dm_config(
        g, arch, qmode, dtype))
    cfg = dm_config(get_config, arch, qmode, dtype)
    x = torch.from_numpy(dm_prompt(cfg)).long()
    return (cfg, from_jax_params(tree, device="cpu"), x, STEPS), \
        weight_digest(tree)


def build_inputs():
    """(part A cases, qwen2's case, moonshot's cases, the weights'
    SHA-256 by case), the reference's draws made in threads."""
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        a = {arch: pool.submit(part_a_case, arch) for arch in ARCHS}
        b = {name: pool.submit(dm_case, name) for name in
             [SEQ_CASE] + [f"{MOON_CASES[q]} (2, 1)" for q in MOON_CASES]}
        part_a = {arch: f.result()[0] for arch, f in a.items()}
        digests = {arch: f.result()[1] for arch, f in a.items()}
        got = {name: f.result() for name, f in b.items()}
    digests.update({name: d for name, (_, d) in got.items()})
    moon = {q: got[f"{MOON_CASES[q]} (2, 1)"][0] for q in MOON_CASES}
    return part_a, got[SEQ_CASE][0], moon, digests


def b2_int4_cases():
    """{qmode: (cfg, params, prompt, steps)} of reduced moonshot in bf16
    with 4-bit weights (:data:`B2_INT4`), the port's own weights (seed
    0): B2 cuts their packed w_down by rows of ``expert_ff``."""
    out = {}
    for qmode in B2_INT4:
        cfg = dm_config(get_config, MOONSHOT, qmode, "bfloat16")
        params = quantize_params(init_params(cfg, device="cpu"), cfg, qmode)
        out[qmode] = (cfg, params, torch.from_numpy(dm_prompt(cfg)).long(),
                      STEPS)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's outputs, the one-process runs, the recordings, the
    inputs, the weights' SHA-256)."""
    d = tmp_path_factory.mktemp("dense_mesh")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn_ranks, worker.dense_mesh, 4,
                          init_dir=str(d), backend="gloo", device="cpu",
                          args=(d / "inputs.pt",), timeout=300,
                          shape=(2, 2))
        part_a, seq, moon, digests = build_inputs()
        int4 = b2_int4_cases()
        torch.save({"part_a": part_a, "pairs": PAIRS, "seq_split": seq,
                    "moonshot": moon, "b2_int4": int4}, d / "inputs.tmp")
        os.replace(d / "inputs.tmp", d / "inputs.pt")
        one = {"part_a": {a: {q: worker.slab_run(*c)
                              for q, c in part_a[a].items()}
                          for a in ARCHS},
               "seq_split": {"float": worker.slab_run(*seq),
                             "int8": worker.slab_run(*seq, kv_dtype="int8",
                                                     keep_pages=True)},
               "moonshot": {q: dict(worker.slab_run(*c),
                                    moe=worker.moe_layer(c[1], c[0]))
                            for q, c in {**moon, **int4}.items()}}
        ranks = fut.result()
    rec = {"recurrent": json.loads(REC_JSON.read_text())["cases"],
           "dense_mesh": json.loads(DM_JSON.read_text())}
    return ranks, one, rec, dict(part_a=part_a, seq=seq,
                                 moon={**moon, **int4}), digests


def part_a_ranks(ranks, arch):
    """The two ranks' part A outputs of ``arch``."""
    pair = next(i for i, archs in enumerate(PAIRS) if arch in archs)
    return [ranks[2 * pair + i]["part_a"][arch] for i in (0, 1)]


# ---------------------------------------------------------------------------
# The recordings and the specs
# ---------------------------------------------------------------------------
def test_recordings_hold_the_reference_weights(runs):
    *_, rec, _, digests = runs
    for arch in ARCHS:
        for qmode, digest in digests[arch].items():
            assert rec["recurrent"][f"{arch}/{qmode}"]["weights_sha256"] \
                == digest, (arch, qmode)
    for name, case in rec["dense_mesh"]["decode"].items():
        key = name.replace(" B2", "").replace(" (2, 2)", " (2, 1)").replace(
            " int8", "")
        assert case["weights_sha256"] == digests[key], name


def _flat_specs(specs, path=()):
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_flat_specs(v, path + (str(k),)))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_flat_specs(v, path + (str(i),)))
        return out
    if isinstance(specs, tsh.QSpec):
        return {"/".join(path): {"q": spec_list(specs.q),
                                 "scale": spec_list(specs.scale)}}
    return {"/".join(path): spec_list(specs)}


@pytest.mark.parametrize("qmode", ["none", "w8a8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_specs_equal_the_reference_leaf_by_leaf(arch, qmode):
    """``serve_pspecs`` on (1, 2) is the reference's ``params_pspecs(...,
    make_rules("serve"))`` at every leaf: the dense slab holds attention
    whose kv heads the model axis does not divide in the reference's
    column blocks too (the paged engine keeps it whole)."""
    want = json.loads(DM_JSON.read_text())["specs"][f"{arch}/{qmode}"]
    cfg = get_config(arch, reduced=True, qmode="w8a8")
    params = init_params(cfg, device="cpu")
    if qmode != "none":
        params = quantize_params(params, cfg, qmode)
    got = _flat_specs(tsh.serve_pspecs(params, Mesh(), cfg))
    assert set(got) == set(want)
    differ = sorted(k for k in got if got[k] != want[k])
    assert differ == [], [(k, got[k], want[k]) for k in differ]


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_below_the_whole_and_leaves_are_slices(arch):
    """A rank's tree holds fewer bytes than the whole model's, and each
    of its leaves is the block of the whole leaf its spec names."""
    cfg = get_config(arch, reduced=True, qmode="w8a8")
    params = quantize_params(init_params(cfg, device="cpu"), cfg, "w8a8")
    for rank in (0, 1):
        mesh = Mesh(rank)
        local = tsh.shard_params(params, mesh, cfg)
        assert set(local.layout) == PARTS[arch]
        assert tsh.tree_bytes(local) < tsh.tree_bytes(params) \
            == local.whole_bytes
        specs = tsh.serve_pspecs(params, mesh, cfg)

        def walk(mine, whole, spec, path=()):
            if isinstance(whole, dict):
                for k in whole:
                    walk(mine[k], whole[k], spec[k], path + (k,))
            elif isinstance(whole, list):
                for i, w in enumerate(whole):
                    walk(mine[i], w, spec[i], path + (i,))
            elif isinstance(whole, QuantizedTensor):
                assert torch.equal(mine.q, tsh.block_view(
                    whole.q, spec.q, mesh)), path
                assert torch.equal(mine.scale, tsh.block_view(
                    whole.scale, spec.scale, mesh)), path
            else:
                assert torch.equal(mine, tsh.block_view(whole, spec, mesh)), \
                    path
        walk(local, params, specs)


@pytest.mark.parametrize("name", list(DM_CASES))
def test_cache_specs_equal_the_reference(name):
    """``cache_pspecs`` gives the reference's KV slab specs under the
    decode rules: kv heads on model where they divide, else positions."""
    arch, qmode, dtype, kv, shape = DM_CASES[name]
    want = json.loads(DM_JSON.read_text())["decode"][name]["kv_spec"]

    class M:
        shape = dict(zip(("data", "model"), DM_CASES[name][4]))
    cfg = dm_config(get_config, arch, qmode, dtype)
    caches = init_serve_caches(cfg, BATCH, PROMPT_LEN + STEPS, kv_dtype=kv,
                               device="meta")
    specs = tsh.cache_pspecs(caches, tsh.make_rules("decode"), M())
    got = specs[0]["attn"]
    assert spec_list(got["k"]) == want["k"]
    assert (None if got["k_scale"] is None
            else spec_list(got["k_scale"])) == want["k_scale"]


# ---------------------------------------------------------------------------
# Part A: the serve rules on (1, 2)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_hold_their_shards(runs, arch):
    ranks, *_ = runs
    for got in part_a_ranks(ranks, arch):
        for q in ("none", "w8a8"):
            assert set(got[q]["layout"]) == PARTS[arch], (arch, q)
            assert got[q]["bytes"] < got[q]["whole_bytes"], (arch, q)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_streams_equal_recording_and_one_process(runs, arch):
    ranks, one, rec, *_ = runs
    want = rec["recurrent"][f"{arch}/none"]["streams"]
    assert one["part_a"][arch]["none"]["tokens"].tolist() == want
    for got in part_a_ranks(ranks, arch):
        assert got["none"]["tokens"].tolist() == want, arch
        np.testing.assert_allclose(
            got["none"]["logits"], one["part_a"][arch]["none"]["logits"],
            rtol=SEQ_TOL, atol=SEQ_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_projections_whole_row_scale_and_control(runs, arch):
    """Layer 0's row-parallel projections give one process's output bit
    for bit (the whole row's scale, the int32 sums added over the ranks,
    one flush); the shard-local-scale control lands more than one bf16
    ULP of max |y| away."""
    ranks, *_ = runs
    for got in part_a_ranks(ranks, arch):
        assert got["proj"], arch
        for name, p in got["proj"].items():
            np.testing.assert_array_equal(p["tp"], p["one"], err_msg=name)
            ulp = bf16_ulp(float(np.abs(p["one"]).max()))
            control = float(np.abs(p["control"] - p["one"]).max())
            assert control > ulp, ("shard-local control passed", arch, name,
                                   control, ulp)


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_streams_equal_one_process_and_the_recording(runs, arch):
    ranks, one, rec, *_ = runs
    want = rec["recurrent"][f"{arch}/w8a8"]["streams"]
    assert one["part_a"][arch]["w8a8"]["tokens"].tolist() == want
    for got in part_a_ranks(ranks, arch):
        assert got["w8a8"]["tokens"].tolist() == want, arch
        np.testing.assert_array_equal(got["w8a8"]["logits"],
                                      one["part_a"][arch]["w8a8"]["logits"])


# ---------------------------------------------------------------------------
# Part B: the decode rules
# ---------------------------------------------------------------------------
def test_seq_split_slab_holds_whole_pages(runs):
    """Each rank holds half of the positions, the int8 slab's as whole
    pages with their scales, from its own start."""
    ranks, one, *_ = runs
    for kind, ps in (("float", None), ("int8", 16)):
        whole = one["seq_split"][kind]["slab"]
        b, kv, t, hd = whole["k"]
        for r in (0, 1):
            slab = ranks[r]["seq_split"][kind]["slab"]
            assert slab["seq_axes"] == ["model"]
            assert slab["k"] == (b, kv, t // 2, hd) and \
                slab["start"] == r * t // 2, kind
            if ps:
                assert (t // 2) % ps == 0
                assert slab["k_scale"] == (b, kv, t // 2 // ps)


def test_seq_split_logits_match_one_process_and_the_recording(runs):
    """f32 logits within 1e-5 of one process's and of the reference's
    decode-rule recording at every step (the float slab)."""
    ranks, one, rec, *_ = runs
    want = rec["dense_mesh"]["decode"][SEQ_CASE]
    base = one["seq_split"]["float"]["logits"].numpy()
    refs = [np.asarray(want["prefill_logits"])] + [
        np.asarray(x) for x in want["step_logits"]]
    assert len(refs) == base.shape[0] == STEPS
    assert one["seq_split"]["float"]["tokens"].tolist() == want["tokens"]
    for r in (0, 1):
        got = ranks[r]["seq_split"]["float"]
        assert got["tokens"].tolist() == want["tokens"]
        for step, ref in enumerate(refs):
            for other in (base[step], ref):
                np.testing.assert_allclose(got["logits"][step], other,
                                           rtol=SEQ_TOL, atol=SEQ_TOL,
                                           err_msg=f"rank {r} step {step}")


def test_seq_split_int8_pages_are_one_processs(runs):
    """The int8 slab's blocks, side by side, are one process's slab:
    layer 0's (whose k/v are computed from the same inputs) bit for bit,
    every later layer's values within one int8 step (an f32 sum of
    another order, quantized, may round the other way), every scale
    within 1e-6 of it; the streams are the recording's."""
    ranks, one, rec, *_ = runs
    want = one["seq_split"]["int8"]["pages"]
    blocks = [ranks[r]["seq_split"]["int8"]["pages"] for r in (0, 1)]
    assert one["seq_split"]["int8"]["tokens"].tolist() == \
        rec["dense_mesh"]["decode"][SEQ_CASE + " int8"]["tokens"]
    for layer, whole in enumerate(want):
        for name, x in whole.items():
            got = np.concatenate([np.asarray(b[layer][name]) for b in blocks],
                                 axis=2)
            x = x.numpy()
            if layer == 0:
                np.testing.assert_array_equal(got, x, err_msg=name)
            elif name in ("k", "v"):
                diff = np.abs(got.astype(np.int32) - x.astype(np.int32))
                print(f"layer {layer} {name}: {int((diff > 0).sum())} of "
                      f"{diff.size} int8 values one step apart")
                assert diff.max() <= 1, (layer, name)
            else:
                np.testing.assert_allclose(got, x, rtol=1e-6, err_msg=name)
    for r in (0, 1):
        assert ranks[r]["seq_split"]["int8"]["tokens"].tolist() == \
            one["seq_split"]["int8"]["tokens"].tolist()


def test_seq_split_dropped_partial_control(runs):
    """Leaving rank 1's partial out of the split softmax's sum lands
    outside the limit at every decode step."""
    ranks, one, *_ = runs
    base = one["seq_split"]["float"]["logits"].numpy()
    for r in (0, 1):
        dropped = ranks[r]["seq_split"]["dropped"]
        for step in range(1, STEPS):
            gap = float(np.abs(dropped[step] - base[step]).max())
            assert gap > SEQ_TOL * 100, ("dropped-partial control passed",
                                         step, gap)


@pytest.mark.parametrize("qmode", list(MOON_CASES))
@pytest.mark.parametrize("where", EXPERT_MESHES)
def test_moe_output_equals_one_process(runs, where, qmode):
    """Layer 0's MoE FFN on each rank's rows: W8A8 one process's bit for
    bit (the slots' outputs are one process's, the split down
    projection's int32 sums added over the model ranks); f32 within 1e-5
    of max |y|."""
    ranks, one, *_ = runs
    want, _ = one["moonshot"][qmode]["moe"]
    members = (2, 3) if where == "experts (2, 1)" else (0, 1, 2, 3)
    model = 1 if where == "experts (2, 1)" else 2
    rows = want.shape[0] // 2
    top = float(np.abs(want).max())
    for i, r in enumerate(members):
        mine = want[(i // model) * rows:(i // model + 1) * rows].numpy()
        got, _ = ranks[r][where][qmode]["moe"]
        if qmode == "none":
            assert float(np.abs(got - mine).max()) <= F32_TOL * top
        else:
            np.testing.assert_array_equal(got, mine)


@pytest.mark.parametrize("qmode", list(MOON_CASES))
@pytest.mark.parametrize("where", EXPERT_MESHES)
def test_each_data_rank_runs_its_experts(runs, where, qmode):
    """Each data rank's expert GEMMs cover E/2 experts: half of one
    process's launches (W8A8), gate and up over E/2-expert stacks."""
    ranks, one, _, inputs, _ = runs
    cfg = inputs["moon"][qmode][0]
    _, base = one["moonshot"][qmode]["moe"]
    assert base["experts"] == [cfg.moe_experts] * 3
    for out in ranks:
        if where not in out:
            continue
        _, seen = out[where][qmode]["moe"]
        assert seen["experts"][:2] == [cfg.moe_experts // 2] * 2
        if qmode == "w8a8":
            assert seen["gemms"] * 2 == base["gemms"], (where, seen, base)


@pytest.mark.parametrize("qmode", list(MOON_CASES))
@pytest.mark.parametrize("where", EXPERT_MESHES)
def test_expert_streams_equal_one_process_and_the_recording(runs, where,
                                                            qmode):
    ranks, one, rec, *_ = runs
    base = one["moonshot"][qmode]
    name = f"{MOON_CASES[qmode]} {where[len('experts '):]}"
    want = rec["dense_mesh"]["decode"].get(name)
    members = (2, 3) if where == "experts (2, 1)" else (0, 1, 2, 3)
    model = 1 if where == "experts (2, 1)" else 2
    rows = base["tokens"].shape[0] // 2
    assert base["tokens"].tolist() == rec["dense_mesh"]["decode"][
        f"{MOON_CASES[qmode]} (2, 1)"]["tokens"]
    for i, r in enumerate(members):
        mine = slice((i // model) * rows, (i // model + 1) * rows)
        got = ranks[r][where][qmode]["tokens"]
        assert got.tolist() == base["tokens"][mine].tolist(), (where, r)
        if want is not None:
            assert got.tolist() == want["tokens"][mine]


# ---------------------------------------------------------------------------
# The int32 sums of K5 / K6a / K6b, unflushed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["i8", "w4", "a4w4"])
def test_int32_sums_of_shards_add_up_to_the_flushed_gemm(kind, out_dtype):
    """``out_dtype=torch.int32`` gives a GEMM's int32 sums unflushed (the
    plain versions: the exact dot); two K shards' sums add up to the
    whole's, and ``ops.flush`` of them is the flushed GEMM bit for bit."""
    from repro_torch.core.quant import pack_int4
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import dot_i32
    gen = torch.Generator().manual_seed(3)
    m, k, n = 5, 64, 24
    qmax = 7 if kind == "a4w4" else 127
    a = torch.randint(-qmax, qmax + 1, (m, k), generator=gen,
                      dtype=torch.int8)
    b = torch.randint(-7 if kind != "i8" else -127,
                      8 if kind != "i8" else 128, (k, n), generator=gen,
                      dtype=torch.int8)
    sa = torch.rand((m, 1), generator=gen) / 100
    sb = torch.rand((1, n), generator=gen) / 100

    def gemm(a_, b_, out):
        kk = a_.shape[1]
        if kind == "i8":
            return ops.gemm_i8(a_, b_, sa, sb, out_dtype=out)
        if kind == "w4":
            return ops.gemm_w4(a_, pack_int4(b_), sa, sb, out_dtype=out)
        return ops.gemm_a4w4(pack_int4(a_.T).T.contiguous(), pack_int4(b_),
                             kk, sa, sb, out_dtype=out)
    whole = gemm(a, b, torch.int32)
    assert whole.dtype == torch.int32
    assert torch.equal(whole, dot_i32(a, b))
    h = k // 2
    parts = gemm(a[:, :h].contiguous(), b[:h], torch.int32) \
        + gemm(a[:, h:].contiguous(), b[h:], torch.int32)
    assert torch.equal(parts, whole)
    assert torch.equal(ops.flush(parts, sa, sb, out_dtype=out_dtype),
                       gemm(a, b, out_dtype))


# ---------------------------------------------------------------------------
# The hillclimb's B2: the experts over model, expert_ff over data
# ---------------------------------------------------------------------------
B2_CASES = {"none": "moonshot B2 f32 (2, 2)",
            "w8a8": "moonshot B2 w8a8 (2, 2)"}
B2_INT4 = ("w4a8", "w4a4")     # held to one process only: no recording


@pytest.mark.parametrize("qmode", list(B2_CASES) + list(B2_INT4))
def test_b2_moe_output_equals_one_process(runs, qmode):
    """Layer 0's MoE FFN on each rank's rows under B2: W8A8, W4A8 and
    W4A4 (whose packed int4 w_down each data rank cuts by rows of
    ``expert_ff``) one process's bit for bit, f32 within 1e-5 of max
    |y|; each model rank's gate and up run over E/2-expert stacks."""
    ranks, one, _, inputs, _ = runs
    cfg = inputs["moon"][qmode][0]
    want, _ = one["moonshot"][qmode]["moe"]
    rows = want.shape[0] // 2
    top = float(np.abs(want).max())
    for r, out in enumerate(ranks):
        mine = want[(r // 2) * rows:(r // 2 + 1) * rows].numpy()
        got, seen = out["b2"][qmode]["moe"]
        assert seen["experts"][:2] == [cfg.moe_experts // 2] * 2
        if qmode == "none":
            assert float(np.abs(got - mine).max()) <= F32_TOL * top, r
        else:
            np.testing.assert_array_equal(got, mine)


@pytest.mark.parametrize("qmode", B2_INT4)
def test_b2_int4_streams_and_logits_equal_one_process(runs, qmode):
    """W4A8 / W4A4 under B2: the streams and every step's logits are one
    process's bit for bit (no recording holds them)."""
    ranks, one, *_ = runs
    base = one["moonshot"][qmode]
    rows = base["tokens"].shape[0] // 2
    for r, out in enumerate(ranks):
        mine = slice((r // 2) * rows, (r // 2 + 1) * rows)
        got = out["b2"][qmode]
        assert got["tokens"].tolist() == base["tokens"][mine].tolist(), r
        np.testing.assert_array_equal(got["logits"],
                                      base["logits"][:, mine].numpy())


def test_b2_shard_local_scales_control_misses(runs):
    ranks, one, *_ = runs
    want, _ = one["moonshot"]["w8a8"]["moe"]
    rows = want.shape[0] // 2
    for r, out in enumerate(ranks):
        mine = want[(r // 2) * rows:(r // 2 + 1) * rows].numpy()
        gap = float(np.abs(out["b2"]["control"] - mine).max())
        assert gap > bf16_ulp(float(np.abs(mine).max())), (r, gap)


@pytest.mark.parametrize("qmode", list(B2_CASES))
def test_b2_streams_and_logits(runs, qmode):
    """The streams equal one process's and the recording; the logits of
    every step equal one process's (W8A8 bit for bit, f32 within 1e-5)
    and, in f32, the recording's within 1e-5."""
    ranks, one, rec, *_ = runs
    base = one["moonshot"][qmode]
    want = rec["dense_mesh"]["decode"][B2_CASES[qmode]]
    assert base["tokens"].tolist() == want["tokens"]
    refs = [np.asarray(want["prefill_logits"])] + [
        np.asarray(x) for x in want["step_logits"]]
    assert len(refs) == STEPS
    rows = base["tokens"].shape[0] // 2
    for r, out in enumerate(ranks):
        mine = slice((r // 2) * rows, (r // 2 + 1) * rows)
        got = out["b2"][qmode]
        assert got["tokens"].tolist() == want["tokens"][mine], r
        # the override moves no weight: the decode rules' shards
        assert "experts" in got["layout"]
        assert got["bytes"] == out["experts (2, 2)"][qmode]["bytes"], r
        if qmode == "w8a8":
            np.testing.assert_array_equal(
                got["logits"], base["logits"][:, mine].numpy())
            continue
        for step, ref in enumerate(refs):
            for other in (base["logits"][step, mine].numpy(), ref[mine]):
                np.testing.assert_allclose(got["logits"][step], other,
                                           rtol=SEQ_TOL, atol=SEQ_TOL,
                                           err_msg=f"rank {r} step {step}")
