"""Tensor-parallel serving in the port against the reference.

In-process (no ranks): the rule tables, ``spec_for``, ``params_pspecs``
and ``tp_shardable`` against the reference's; ``shard_params`` against
numpy slices by those specs; the engine without a mesh; the errors.

Then one spawned group of four gloo CPU ranks (``tests/torch_tp_worker.py
::serving``) runs the checks of ``tests/tp_parity_check.py`` at its
configuration (qwen2-0.5b, 2 layers, d 64, 8/4 heads of 16, d_ff 128,
vocab 512, f32, page 8, chunk 16, TP 4) with the reference's weights,
against the reference's replicated side on the same inputs: its prefill
and decode rerun here meanwhile, its engine runs read from
``tests/tp_reference.json`` (recorded by ``tests/tp_reference.py``; the
recording is held to the live prefill and decode and to the weights'
SHA-256):

* PREFILL / DECODE: chunked prefill and four ragged decode steps over a
  head-sharded pool ((64, 1, 8, 16) a rank) against the reference's
  replicated pool, rtol = atol = 2e-4;
* ENGINE: the prefix-sharing mix: tokens, and tables / lens / shared
  stats / free / retained at step 4 and at the end, equal to the
  reference's replicated engine and across ranks;
* INDIV: d 60, 6/3 heads: ``engine.tp == 1``, the pool unsharded, the MLP
  still row-parallel, tokens and accounting equal;
* QUANT: w8a8 with ``tp_int8_reduce``: at least half the tokens of the
  reference's single-device run;
* SPEC: n-gram, gamma 3: the sharded streams equal the reference's
  speculative and plain streams; ``spec_summary()`` and the accounting
  equal.
"""
import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_tp_worker  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.camp import prepare_weight as jax_prepare_weight  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import quantize_params as jax_quantize_params  # noqa: E402
from repro.models.modules import tp_shardable as jax_tp_shardable  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.camp import prepare_weight  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_tp  # noqa: E402
from repro_torch.kernels.paged_prefill import \
    paged_prefill_attention_tp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models.modules import tp_shardable  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.serving.engine import ContinuousBatchingEngine  # noqa: E402
from torch_parity import jax_to_numpy  # noqa: E402
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)
from repro_torch.tree import leaves_with_path  # noqa: E402
from tp_reference import (CHUNK, INDIV, PS, SMALL, STEPS, TP,  # noqa: E402
                          load, models, prefill_decode, prompts,
                          weight_digest)

RTOL = ATOL = 2e-4


class FakeMesh:
    """A mesh's shape and this rank's coordinates: all the rules,
    ``spec_for`` and ``shard_params`` read."""

    def __init__(self, shape, rank=0):
        self.shape = dict(shape)
        self.coords = {"data": 0, "model": rank}


MESH = FakeMesh({"data": 2, "model": 4})


def cfgs(qmode="none", **kw):
    """(jax cfg, port cfg) at the parity config; f32 unless ``dtype`` is
    given (None: the config's own, as the reference's QUANT check)."""
    over = dict(SMALL, **{"dtype": "float32", **kw})
    if over["dtype"] is None:
        del over["dtype"]
    return (jax_get_config("qwen2-0.5b", qmode=qmode, **over),
            get_config("qwen2-0.5b", qmode=qmode, **over))


def ref_tree(qmode, **kw):
    """(jax cfg, jax params, port cfg, port params) at the parity config."""
    jcfg, cfg = cfgs(qmode=qmode, **kw)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    if qmode != "none":
        jp = jax_quantize_params(jp, jcfg, qmode)
    return jcfg, jp, cfg, from_jax_params(jax_to_numpy(jp), device="cpu")


# ---------------------------------------------------------------------------
# (a) rules and specs, in-process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "prefill", "decode", "serve"])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_make_rules_match_reference(mode, multi_pod, family):
    want = jsh.make_rules(mode, multi_pod=multi_pod, family=family)
    got = tsh.make_rules(mode, multi_pod=multi_pod, family=family)
    assert got == {k: tuple(v) for k, v in want.items()}


def test_make_rules_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown mode"):
        tsh.make_rules("bogus")


SPEC_CASES = [
    ((64, 4, 8, 16), ("kv_pages", "kv_heads", None, None)),
    ((8, 4, 2, 16), ("batch", "kv_heads", None, "head_dim")),
    ((8, 4096, 16), ("batch", "seq_kv", None)),
    ((64, 3, 8, 16), ("kv_pages", "kv_heads", None, None)),
    ((16, 6), ("batch", "heads")),
]


@pytest.mark.parametrize("shape,names", SPEC_CASES)
@pytest.mark.parametrize("mode", ["serve", "train", "decode"])
def test_spec_for_matches_reference(shape, names, mode):
    want = jsh.spec_for(shape, names, jsh.make_rules(mode), MESH)
    got = tsh.spec_for(shape, names, tsh.make_rules(mode), MESH)
    assert got == tuple(want)


def test_serve_rules_shard_kv_heads_not_seq():
    rules = tsh.make_rules("serve")
    assert tsh.spec_for((64, 4, 8, 16), ("kv_pages", "kv_heads", None, None),
                        rules, MESH) == (None, "model", None, None)
    assert tsh.spec_for((8, 4096, 16), ("batch", "seq_kv", None), rules,
                        MESH) == ("data", None, None)


@pytest.mark.parametrize("qmode", ["none", "w8a8", "w4a8"])
def test_params_pspecs_match_reference(qmode):
    _, jp, _, tp = ref_tree(qmode)
    want = jsh.params_pspecs(jp, jsh.make_rules("serve"), MESH)
    got = tsh.params_pspecs(tp, tsh.make_rules("serve"), MESH)
    jleaves = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, jsh.P)
        or hasattr(x, "bits"))
    n = 0
    for path, spec in jleaves:
        node = got
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        if hasattr(spec, "bits"):
            assert node == tsh.QSpec(tuple(spec.q), tuple(spec.scale)), path
        else:
            assert node == tuple(spec), path
        n += 1
    assert n > 10


def test_tp_shardable_packed_int4():
    w = torch.zeros((24, 16))
    assert tp_shardable(w, 4) and not tp_shardable(w, 5)
    w4 = prepare_weight(w, "w4a8")
    assert tp_shardable(w4, 4) and not tp_shardable(w4, 8)
    w4b = prepare_weight(torch.zeros((20, 16)), "w4a8")
    assert tp_shardable(w4b, 2) and not tp_shardable(w4b, 4)
    for k, tp in ((24, 4), (24, 8), (20, 2), (20, 4), (24, 5)):
        jw = jax_prepare_weight(jnp.zeros((k, 16), jnp.float32), "w4a8")
        tw = prepare_weight(torch.zeros((k, 16)), "w4a8")
        assert tp_shardable(tw, tp) == jax_tp_shardable(jw, tp)


def _np_slice(a, spec, rank):
    for dim, ax in enumerate(spec):
        if ax is not None:
            n = a.shape[dim] // TP
            a = np.take(a, np.arange(rank * n, (rank + 1) * n), axis=dim)
    return a


@pytest.mark.parametrize("qmode", ["none", "w8a8", "w4a8"])
def test_shard_params_equal_numpy_slices(qmode):
    _, jp, cfg, tp = ref_tree(qmode)
    mesh = FakeMesh({"data": 1, "model": TP})
    specs = jsh.params_pspecs(jp, jsh.make_rules("serve"), mesh)
    full = jax_to_numpy(jp)
    for rank in range(TP):
        got = tsh.shard_params(tp, FakeMesh(mesh.shape, rank), cfg)

        def walk(g, f, s, path=""):
            if isinstance(f, dict) and set(f) == {"q", "scale", "bits",
                                                  "shape"}:
                assert isinstance(g, QuantizedTensor), path
                np.testing.assert_array_equal(
                    g.q.numpy(), _np_slice(f["q"], tuple(s.q), rank))
                np.testing.assert_array_equal(
                    g.scale.numpy(), _np_slice(f["scale"], tuple(s.scale),
                                               rank))
                return
            if isinstance(f, dict):
                for k in f:
                    walk(g[k], f[k], s[k], path + "/" + k)
                return
            if isinstance(f, list):
                for i, (gg, ff, ss) in enumerate(zip(g, f, s)):
                    walk(gg, ff, ss, f"{path}/{i}")
                return
            np.testing.assert_array_equal(g.numpy(),
                                          _np_slice(f, tuple(s), rank))
        walk(got, full, specs)
    w_down = tsh.shard_params(tp, FakeMesh(mesh.shape, 1), cfg)[
        "layers"][0]["mlp"]["w_down"]
    assert w_down.shape[0] == cfg.d_ff // TP


def test_shard_params_keeps_attention_whole_when_heads_do_not_divide():
    _, _, cfg, tp = ref_tree("none", **{k: INDIV[k] for k in
                                        ("d_model", "n_heads",
                                         "n_kv_heads")})
    got = tsh.shard_params(tp, FakeMesh({"data": 1, "model": TP}, 2), cfg)
    attn, mlp = got["layers"][0]["attn"], got["layers"][0]["mlp"]
    for k in ("wq", "wk", "wv", "wo", "wq_bias"):
        assert torch.equal(attn[k], tp["layers"][0]["attn"][k]), k
    assert tuple(mlp["w_down"].shape) == (cfg.d_ff // TP, cfg.d_model)
    assert tuple(mlp["w_gate"].shape) == (cfg.d_model, cfg.d_ff // TP)
    assert got["embedding"].shape[0] == cfg.vocab_size // TP


def _layout_of(over, qmode="none"):
    _, _, cfg, tp = ref_tree(qmode, **over)
    return tsh.shard_params(tp, FakeMesh({"data": 1, "model": TP}, 1),
                            cfg).layout


@pytest.mark.parametrize("qmode", ["none", "w8a8", "w4a8"])
def test_shard_params_records_its_layout(qmode):
    # the parity config: heads, wo, the MLP and the tied embedding sharded
    assert _layout_of({}, qmode) == {"heads", "wo", "mlp", "embedding"}
    # kv heads the model axis does not divide: attention whole
    indiv = {k: INDIV[k] for k in ("d_model", "n_heads", "n_kv_heads")}
    assert _layout_of(indiv, qmode) == {"mlp", "embedding"}
    # an untied head shards its vocabulary columns
    assert _layout_of({"tie_embeddings": False}, qmode) == {
        "heads", "wo", "mlp", "embedding", "lm_head"}


def test_sharded_reads_the_context_layout():
    assert not tsh.sharded("mlp")
    with tsh.mesh_context(MESH, tsh.make_rules("serve"), mode="serve",
                          layout={"mlp"}):
        assert tsh.sharded("mlp") and not tsh.sharded("heads")
    with tsh.mesh_context(MESH, tsh.make_rules("train"), mode="train",
                          layout={"mlp"}):
        assert not tsh.sharded("mlp")
    with pytest.raises(ValueError, match="unknown part"):
        tsh.sharded("w_down")


@pytest.mark.parametrize("qmode", ["none", "w8a8"])
def test_init_quantized_params_under_a_mesh_equals_sharding_the_whole(qmode):
    from repro_torch.models import (init_params, init_quantized_params,
                                    quantize_params)
    _, cfg = cfgs(qmode)
    mesh = FakeMesh({"data": 1, "model": TP}, 2)
    whole = tsh.shard_params(quantize_params(init_params(
        cfg, generator=torch.Generator().manual_seed(3), device="cpu"),
        cfg, qmode), mesh, cfg)
    got = init_quantized_params(cfg, qmode, device="cpu", mesh=mesh,
                                generator=torch.Generator().manual_seed(3))
    assert isinstance(got, tsh.RankShards) and got.layout == whole.layout
    flat = dict(leaves_with_path(whole))
    assert [p for p, _ in leaves_with_path(got)] == list(flat)
    for path, leaf in leaves_with_path(got):
        want = flat[path]
        if isinstance(leaf, QuantizedTensor):
            assert torch.equal(leaf.q, want.q), path
            leaf, want = leaf.scale, want.scale
        assert torch.equal(leaf, want), path


def test_serve_tp_inactive_without_context():
    assert tsh.serve_tp() == (None, 1)
    with tsh.mesh_context(MESH, tsh.make_rules("serve"), mode="serve"):
        assert tsh.serve_tp() == (MESH, 4)
    with tsh.mesh_context(MESH, tsh.make_rules("train"), mode="train"):
        assert tsh.serve_tp() == (None, 1)
    assert tsh.effective_model_shards(MESH, 4) == 4
    assert tsh.effective_model_shards(MESH, 3) == 1
    assert tsh.effective_model_shards(None, 4) == 1


def test_tp_wrappers_raise_when_kv_heads_do_not_divide():
    q = torch.zeros(1, 1, 2, 16)
    pages = torch.zeros(4, 1, 8, 16, dtype=torch.int8)
    sc = torch.ones(4, 1, 8)
    tables = torch.zeros(1, 1, dtype=torch.int32)
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible by model=4"):
        paged_attention_tp(q, pages, pages, sc, sc, tables, lengths,
                           mesh=MESH, n_kv_heads=3)
    with pytest.raises(ValueError, match="not divisible by model=4"):
        paged_prefill_attention_tp(q.permute(1, 0, 2, 3), pages, pages, sc,
                                   sc, tables[0], mesh=MESH, n_kv_heads=3,
                                   q_start=0)
    # a rank's heads are checked against its page shards
    with pytest.raises(ValueError, match="holds 1 of 4"):
        paged_attention_tp(torch.zeros(1, 2, 2, 16), pages, pages, sc, sc,
                           tables, lengths, mesh=MESH, n_kv_heads=4)


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="a card a rank"):
        tmesh.pick_backend(2, torch.device("cuda"), "nccl")
    assert tmesh.pick_backend(2, torch.device("cuda"), "gloo") == "gloo"
    assert tmesh.pick_backend(2, torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError, match="needs CUDA"):
        tmesh.pick_backend(2, torch.device("cpu"), "nccl")


def test_shard_params_splits_every_expert():
    """Reduced moonshot on a (1, 2) mesh: each rank holds every expert's
    w_gate / w_up columns with their (E, 1, N) scales sliced alike, and
    w_down's (packed) K rows with the whole scale; the router whole."""
    from repro_torch.models import init_params, quantize_params
    for qmode in ("none", "w8a8", "w4a8"):
        cfg = get_config("moonshot-v1-16b-a3b", reduced=True, qmode=qmode)
        full = quantize_params(init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
            cfg, qmode)
        f = cfg.expert_ff
        for rank in range(2):
            got = tsh.shard_params(full, FakeMesh({"data": 1, "model": 2},
                                                  rank), cfg)
            assert "experts" in got.layout
            for i, layer in enumerate(got["layers"]):
                moe, whole = layer["moe"], full["layers"][i]["moe"]
                assert torch.equal(moe["router"], whole["router"])
                cols = slice(rank * f // 2, (rank + 1) * f // 2)
                for k in ("w_gate", "w_up"):
                    w, ww = moe["experts"][k], whole["experts"][k]
                    if qmode == "none":
                        assert torch.equal(w, ww[:, :, cols]), k
                        continue
                    assert w.shape == (cfg.moe_experts, cfg.d_model, f // 2)
                    assert torch.equal(w.q, ww.q[:, :, cols]), k
                    assert torch.equal(w.scale, ww.scale[:, :, cols]), k
                w, ww = moe["experts"]["w_down"], whole["experts"]["w_down"]
                if qmode == "none":
                    assert torch.equal(w, ww[:, cols]), "w_down"
                    continue
                rows = ww.q.shape[1] // 2
                assert w.shape == (cfg.moe_experts, f // 2, cfg.d_model)
                assert torch.equal(w.q, ww.q[:, rank * rows:(rank + 1) * rows])
                assert torch.equal(w.scale, ww.scale)


# ---------------------------------------------------------------------------
# (i) the engine without a mesh
# ---------------------------------------------------------------------------
def test_engine_without_mesh_is_single_device():
    _, _, cfg, tp = ref_tree("none")
    eng = ContinuousBatchingEngine(tp, cfg, kv_dtype="int8", page_size=8,
                                   capacity_tokens=64, device="cpu")
    assert eng.tp == 1 and eng.mesh is None and not eng.pool.sharded
    assert tuple(eng.pool.k_pages[0].shape)[1] == cfg.n_kv_heads


# ---------------------------------------------------------------------------
# (d)-(h): four gloo ranks against the reference's replicated runs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's outputs, the reference's side, port cfg, recorded
    digests, the converted weights' digests)."""
    d = tmp_path_factory.mktemp("tp_serving")
    ms, ps = models(), prompts()
    port = {}
    for name, (_, jp, over) in ms.items():
        tree = jax_to_numpy(jp)
        port[name] = (get_config("qwen2-0.5b", **over),
                      from_jax_params(tree, device="cpu"),
                      weight_digest(tree))

    def t(prompt_list):
        return [torch.from_numpy(p.astype(np.int64)) for p in prompt_list]
    cfg, params, _ = port["small"]
    torch.save({"cfg": cfg, "params": params, "page_size": PS,
                "chunk": CHUNK, "steps": STEPS,
                "pd_prompt": t([ps["prefill"]])[0],
                "engine_prompts": t(ps["engine"]),
                "indiv_cfg": port["indiv"][0],
                "indiv_params": port["indiv"][1],
                "indiv_prompts": t(ps["indiv"]),
                "quant_cfg": port["quant"][0],
                "quant_params": port["quant"][1],
                "quant_prompts": t(ps["quant"]),
                "spec_prompts": t(ps["spec"])}, d / "inputs.pt")
    # the ranks run while the reference's prefill and decode rerun here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn_ranks, torch_tp_worker.serving, TP,
                          init_dir=str(d), backend="gloo", device="cpu",
                          args=(d / "inputs.pt",), timeout=300)
        jcfg, jp, _ = ms["small"]
        live = prefill_decode(jcfg, jp, ps["prefill"])
        ranks = fut.result()
    rec = load()
    ref = {"prefill": rec["prefill"], "decode": rec["decode"],
           **rec["cases"]}
    return ranks, ref, cfg, live, rec["digests"], {
        name: port[name][2] for name in port}


def test_recording_holds_the_reference_weights(runs):
    *_, recorded, converted = runs
    assert converted == recorded, \
        "reference weights changed: rerun tests/tp_reference.py"


def test_recording_matches_live_prefill_and_decode(runs):
    _, ref, _, live, _, _ = runs
    for want, got in zip(live, (ref["prefill"], ref["decode"])):
        assert len(want) == len(got)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


def test_pool_is_head_sharded(runs):
    ranks, _, cfg, *_ = runs
    for out in ranks:
        assert out["pool_sharded"]
        assert out["pool_shape"] == (64, cfg.n_kv_heads // TP, PS, cfg.hd)


def test_prefill_matches_replicated_reference(runs):
    ranks, ref, *_ = runs
    for out in ranks:
        assert len(out["prefill"]) == len(ref["prefill"]) == 3
        for i, (got, want) in enumerate(zip(out["prefill"], ref["prefill"])):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"prefill chunk {i}")


def test_decode_matches_replicated_reference(runs):
    ranks, ref, *_ = runs
    assert (ranks[0]["prefill"][-1].argmax(-1)
            == ref["prefill"][-1].argmax(-1)).all()
    for out in ranks:
        for i, (got, want) in enumerate(zip(out["decode"], ref["decode"])):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"decode step {i}")


def test_ranks_agree_bit_for_bit(runs):
    ranks, *_ = runs
    for out in ranks[1:]:
        for key in ("prefill", "decode"):
            for a, b in zip(out[key], ranks[0][key]):
                np.testing.assert_array_equal(a, b)
        for key in ("engine", "indiv", "quant", "spec", "spec_base"):
            assert out[key] == ranks[0][key], key


def test_engine_tokens_match_reference(runs):
    ranks, ref, *_ = runs
    got = ranks[0]["engine"]
    assert got["tp"] == TP and got["sharded"]
    assert got["page_shape"][1] == SMALL["n_kv_heads"] // TP
    assert got["tokens"] == ref["engine"]["tokens"]


@pytest.mark.parametrize("when", ["mid", "end"])
def test_engine_accounting_matches_reference(runs, when):
    ranks, ref, *_ = runs
    want = ref["engine"][when]
    for out in ranks:
        assert out["engine"][when] == want
    if when == "mid":
        assert want["stats"]["shared_slots"] > 0, "prefix sharing inactive"
    else:
        assert want["retained"] > 0, "trie retention inactive"


def test_indivisible_heads_fall_back_to_replicated_attention(runs):
    ranks, ref, *_ = runs
    for out in ranks:
        got = out["indiv"]
        assert got["tp"] == 1 and not got["sharded"]
        assert got["page_shape"][1] == INDIV["n_kv_heads"]
        assert out["indiv_mlp_rows"] == (INDIV["d_ff"] // TP,
                                         INDIV["d_model"])
        assert out["indiv_wq"] == (INDIV["d_model"],
                                   INDIV["n_heads"] * INDIV["head_dim"])
        assert got["tokens"] == ref["indiv"]["tokens"]
        assert got["end"] == ref["indiv"]["end"]


def test_w8a8_int8_wire_keeps_majority_agreement(runs):
    ranks, ref, *_ = runs
    got = ranks[0]["quant"]
    assert got["tp"] == TP and got["sharded"]
    a = [t for s in got["tokens"] for t in s]
    b = [t for s in ref["quant"]["tokens"] for t in s]
    assert len(a) == len(b) == 12
    assert np.mean([x == y for x, y in zip(a, b)]) >= 0.5


def test_speculative_streams_match_reference(runs):
    ranks, ref, *_ = runs
    got = ranks[0]
    assert got["spec"]["tp"] == TP and got["spec"]["sharded"]
    assert ref["spec"]["tokens"] == ref["spec_base"]["tokens"]
    assert got["spec"]["tokens"] == ref["spec"]["tokens"]
    assert got["spec_base"]["tokens"] == ref["spec_base"]["tokens"]


def test_draft_model_speculation_verifies_rank_0s_draft(runs):
    # rank 1's draft model proposes other tokens than rank 0's; every rank
    # verifies rank 0's, so the stream stays the plain one
    ranks, ref, *_ = runs
    for out in ranks:
        got = out["spec_draft"]
        assert got["tokens"] == ref["spec_base"]["tokens"]
        assert got["end"] == ranks[0]["spec_draft"]["end"]
        assert got["spec"] == ranks[0]["spec_draft"]["spec"]
    s = ranks[0]["spec_draft"]["spec"]
    assert s["accepted"] > 0, "speculation inactive"


def test_speculative_stats_and_accounting_match_reference(runs):
    ranks, ref, *_ = runs
    for out in ranks:
        assert out["spec"]["end"] == ref["spec"]["end"] \
            == ref["spec_base"]["end"]
        assert out["spec"]["spec"] == ref["spec"]["spec"]
    s = ranks[0]["spec"]["spec"]
    assert s["proposed"] > 0 and s["accepted"] > 0, "speculation inactive"
