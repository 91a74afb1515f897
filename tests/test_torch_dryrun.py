"""The dry run and the hillclimb (``repro_torch.launch.dryrun`` /
``hillclimb``) against the reference's.

* (a) For every arch × shape on the single-pod mesh and on the multi-pod
  one (the train cells on (2, 16, 16), the serve cells on (32, 16)), and
  for the hillclimb's B2 (its rules' override), rank 0's argument bytes
  by group (params, opt state, step, caches, inputs, labels) as the
  port's cell builders make them on meta equal the reference's
  per-device shard bytes, recorded in ``tests/dryrun_reference.json``
  (``tests/dryrun_reference.py``: ``NamedSharding.shard_shape`` of each
  leaf, no compile). The reference also holds the decode position as a
  4-byte device scalar; the port's step takes it as a host int.
* (b) One live ``run_cell`` in a spawned process (qwen2-0.5b ×
  decode_32k × single, W8A8) ends OK, and its kernels' counted GEMM
  FLOPs equal Σ 2·M·N·K over the step's projections, from the shapes.
* (c) The counter's wire bytes per kind, over real collectives of the
  256-rank fake group at group sizes 2, 16 and 256, equal the reference's
  ``parse_collectives`` on synthetic HLO lines of the same result bytes.
* (d) ``model_flops`` and ``roofline`` equal the reference's on one
  record, given the same constants.
* (e) The peak tracker on a short op sequence with a view.
* (f) The hillclimb's tags and run_cell kwargs equal the reference's
  (captured in a subprocess).
* (g) A meta tensor at K2, K3 or K8 raises; a meta forward reaches no
  plain version.
* The dense slab's attention in the reference's layout (``attn_cols``) on
  a (1, 2) gloo mesh equals one process bit for bit (W8A8); that layout
  is the dense slab's, the paged engine's keeps such attention whole.
* Multi-pod training runs under its rules: the batch's sequence binds
  ``pod``, and rank 0's train step of reduced qwen3-0.6b and
  jamba-v0.1-52b (Mamba, attention and MoE layers) on a (2, 2, 2) mesh
  of an 8-rank fake group runs on meta, its blocks the rank's rows and
  sequence block, its mixers gathering the sequence over ``pod``; so
  does rank 0's decode step under the hillclimb's B2 rules (reduced
  moonshot W8A8 on (2, 2)), through the kernels' meta rules.
"""
import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

jax.devices()           # one device, before the reference's dry run sets 512
_flags = os.environ.get("XLA_FLAGS")
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch import dryrun as ref_dr  # noqa: E402

if _flags is None:      # no later subprocess inherits the reference's flags
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

import torch_dryrun_worker as worker  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.kernels import flash_attention as k8  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as k3  # noqa: E402
from repro_torch.kernels import paged_prefill as k2  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import hillclimb as hc  # noqa: E402
from repro_torch.launch.mesh import (RankMesh, production_shape,  # noqa: E402
                                     spawn_ranks)
from repro_torch.models.transformer import (forward, init_params,  # noqa: E402
                                            quantize_params)
from repro_torch.parallel.sharding import make_rules, tree_bytes  # noqa: E402
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)

HERE = Path(__file__).resolve().parent
REF = json.loads((HERE / "dryrun_reference.json").read_text())
ARCHS = sorted({k.split("__")[0] for k in REF})

_REF_HILLCLIMB = """
import json, pathlib, sys, tempfile
sys.path.insert(0, {src!r})
from repro.launch import dryrun as dr, hillclimb as hc
calls = []
orig = hc._run
def run(tag, **kw):
    calls.append([tag, {{k: v for k, v in kw.items() if k != "force"}}])
    return orig(tag, **kw)
hc._run = run
dr.run_cell = lambda **kw: {{"status": "OK", "collectives": {{}},
                             "cost": {{"flops": 1.0, "bytes accessed": 1e15}}}}
hc.OUT = pathlib.Path(tempfile.mkdtemp())
hc.cell_a(); hc.cell_c(); hc.cell_b("jamba-v0.1-52b")
print(json.dumps(calls))
"""


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """Start the slow parts at once: the live dry run (a spawned process
    of its own: the fake group is global), the (1, 2) gloo mesh, the
    reference's hillclimb capture; yield their futures."""
    tmp = tmp_path_factory.mktemp("dryrun")
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    live = ctx.Process(target=worker.live_dryrun, args=(child,), daemon=True)
    live.start()
    ref_hc = subprocess.Popen(
        [sys.executable, "-c", _REF_HILLCLIMB.format(
            src=str(HERE.parent / "src"))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(spawn_ranks, worker.attn_cols_rank, 2,
                        init_dir=str(tmp), backend="gloo", device="cpu",
                        shape=(1, 2), timeout=180)
    pod_parent, pod_child = ctx.Pipe()
    pod = ctx.Process(target=worker.meta_steps, args=(pod_child,),
                      daemon=True)
    pod.start()
    state = {"live": (live, parent), "ref_hc": ref_hc, "ranks": ranks,
             "pod": (pod, pod_parent)}
    yield state
    live.kill()
    pod.kill()
    ref_hc.kill()
    pool.shutdown(wait=True)


def _live(background):
    if "live_result" not in background:
        proc, conn = background["live"]
        if not conn.poll(240):
            raise TimeoutError("the live dry run gave no result in 240 s")
        status, rec, colls = conn.recv()
        proc.join(10)
        assert status == "ok", rec
        background["live_result"] = (rec, colls)
    return background["live_result"]


# ---------------------------------------------------------------------------
# (a) rank 0's argument bytes against the reference's shard bytes
# ---------------------------------------------------------------------------
def _groups(kind, args) -> dict:
    if kind == "train":
        state, batch = args
        return {"params": tree_bytes(state["params"]),
                "opt": tree_bytes(state["opt"]),
                "step": tree_bytes(state["step"]),
                "inputs": tree_bytes(batch["inputs"]),
                "labels": tree_bytes(batch["labels"])}
    if kind == "prefill":
        params, inputs, caches = args
    else:
        params, caches, inputs = args
    return {"params": tree_bytes(params), "caches": tree_bytes(caches),
            "inputs": tree_bytes(inputs)}


# the rules' overrides of the tagged cells (the hillclimb's)
OVERRIDES = {"B2_experts_model": {"expert": ("model",),
                                  "expert_ff": ("data",)}}


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_reference(arch):
    cells = [k for k in REF if k.startswith(arch + "__")]
    assert len(cells) >= 4
    for key in cells:
        _, shape_name, mesh_name, qmode, *tag = key.split("__")
        multi, shape = mesh_name == "multi", SHAPES[shape_name]
        mesh = RankMesh(production_shape(multi, shape.kind == "train"), 0,
                        None, {}, torch.device("meta"))
        cfg = get_config(arch, qmode=qmode)
        rules = make_rules(mode=shape.kind, multi_pod=multi,
                           family=cfg.family)
        rules.update(OVERRIDES[tag[0]] if tag else {})
        _, args = dr.build_cell(cfg, shape, mesh, rules, qmode)
        want = {g: b for g, b in REF[key].items() if g != "pos"}
        assert _groups(shape.kind, args) == want, key


# ---------------------------------------------------------------------------
# (b) one live cell
# ---------------------------------------------------------------------------
def test_live_cell_gemm_flops(background):
    rec, _ = _live(background)
    assert rec["status"] == "OK", rec.get("traceback")
    cfg = get_config("qwen2-0.5b")
    tp, rows = 16, SHAPES["decode_32k"].global_batch // 16
    d, hd = cfg.d_model, cfg.hd
    cols = [cfg.n_heads * hd // tp, cfg.n_kv_heads * hd // tp,
            cfg.n_kv_heads * hd // tp, cfg.d_ff // tp, cfg.d_ff // tp]
    fused = cfg.n_layers * sum(2 * rows * n * d for n in cols)
    # wo and w_down: the rank's K rows, K5 with int32 out
    row_par = cfg.n_layers * sum(2 * rows * k * d for k in
                                 (cfg.n_heads * hd // tp, cfg.d_ff // tp))
    kern = rec["kernels"]
    assert kern["camp_gemm_fused_w8a8"]["flops"] == fused
    assert kern["camp_gemm_i8"]["flops"] == row_par
    assert kern["camp_gemm_fused_w8a8"]["calls"] == 5 * cfg.n_layers
    assert kern["quantize_rowwise"]["calls"] == 2 * cfg.n_layers
    m = rec["memory"]
    assert m["peak_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                               + m["temp_bytes"] - m["alias_bytes"])
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert set(rec["roofline"]) >= {"compute_s", "memory_s",
                                    "collective_s", "bottleneck"}


# ---------------------------------------------------------------------------
# (c) wire bytes against the reference's HLO parser
# ---------------------------------------------------------------------------
def _hlo(kind, n, result, operand):
    groups = ("replica_groups=[1,256]<=[256]" if n == 256 else
              "replica_groups={{" + ",".join(map(str, range(n))) + "}}")
    return (f"  %{kind}.1 = {result} {kind}({operand} %p), channel_id=1, "
            f"{groups}, dimensions={{0}}")


def test_wire_bytes_equal_reference(background):
    _, colls = _live(background)
    for n in (2, 16, 256):
        lines = [
            _hlo("all-gather", n, f"bf16[{8 * n},96]{{1,0}}",
                 "bf16[8,96]{1,0}"),
            _hlo("all-reduce", n, "bf16[8,96]{1,0}", "bf16[8,96]{1,0}"),
            _hlo("reduce-scatter", n, "bf16[8,96]{1,0}",
                 f"bf16[{8 * n},96]{{1,0}}"),
            _hlo("all-to-all", n, f"u8[{64 * n}]{{0}}", f"u8[{64 * n}]{{0}}"),
        ]
        want = ref_dr.parse_collectives("\n".join(lines), 256)
        assert set(want) == {"all-gather", "all-reduce", "reduce-scatter",
                             "all-to-all"}
        assert colls[n] == {k: dict(v) for k, v in want.items()}, n


# ---------------------------------------------------------------------------
# (d) the roofline
# ---------------------------------------------------------------------------
def test_roofline_equals_reference(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref_dr, name, getattr(dr, name))
    rec = {"cost": {"flops": 3.7e12, "bytes accessed": 2.9e11},
           "collectives": {"all-reduce": {"count": 3, "result_bytes": 10,
                                          "wire_bytes": 123456789},
                           "all-gather": {"count": 1, "result_bytes": 10,
                                          "wire_bytes": 987654}}}
    for arch, shape in (("qwen2-72b", "decode_32k"),
                        ("llama4-maverick-400b-a17b", "train_4k"),
                        ("pixtral-12b", "prefill_32k")):
        assert dr.model_flops(get_config(arch), SHAPES[shape]) == \
            ref_dr.model_flops(jax_get_config(arch), JAX_SHAPES[shape])
        got = dr.roofline(rec, 256, get_config(arch), SHAPES[shape])
        want = ref_dr.roofline(rec, 256, jax_get_config(arch),
                               JAX_SHAPES[shape])
        assert got == want, arch


# ---------------------------------------------------------------------------
# (e) the peak tracker
# ---------------------------------------------------------------------------
def test_peak_tracker_views():
    f32 = dict(dtype=torch.float32, device="meta")
    with dr.Counter() as c:
        a = torch.empty(1000, **f32)          # 4,000 B
        v = a[10:20]                          # a view: no new storage
        b = a * 2                             # 4,000 B: 8,000 live
        del a                                 # v keeps a's storage
        w = v + 1                             # 40 B: 8,040
        del v                                 # a's storage dies: 4,040
        e = torch.empty(1500, **f32)          # 6,000 B: 10,040
        del b                                 # 6,040
    assert (c.peak, c.cur) == (10040, 6040)
    # bytes: a * 2 reads and writes 4,000 each, v + 1 40 each; the view
    # and the allocations move none
    assert c.bytes == 8080 and c.flops == 0
    del w, e


# ---------------------------------------------------------------------------
# (f) the hillclimb's ladders
# ---------------------------------------------------------------------------
def test_hillclimb_ladders_equal_reference(background, monkeypatch,
                                           tmp_path):
    calls = []
    orig = hc._run

    def run(tag, **kw):
        calls.append([tag, {k: v for k, v in kw.items() if k != "force"}])
        return orig(tag, **kw)
    monkeypatch.setattr(hc, "_run", run)
    monkeypatch.setattr(dr, "run_cell", lambda **kw: {
        "status": "OK", "collectives": {},
        "cost": {"flops": 1.0, "bytes accessed": 1e15}})
    monkeypatch.setattr(hc, "OUT", tmp_path)
    hc.cell_a()
    hc.cell_c()
    hc.cell_b("jamba-v0.1-52b")
    out, err = background["ref_hc"].communicate(timeout=240)
    assert background["ref_hc"].returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    assert json.loads(json.dumps(calls)) == want
    c3 = json.loads((tmp_path / "pixtral-12b__prefill_32k__single__w8a8"
                                 "__C3_flash.json").read_text())
    assert c3["modeled"] and c3["tag"] == "C3_flash_modeled"
    assert c3["cost"]["bytes accessed"] < 1e15


# ---------------------------------------------------------------------------
# (g) meta tensors: K2, K3 and K8 raise; no plain version is reached
# ---------------------------------------------------------------------------
def test_meta_raises_at_kernels_without_rules():
    m = dict(device="meta")
    q = torch.empty(2, 1, 4, 16, dtype=torch.bfloat16, **m)
    pages = torch.empty(8, 1, 16, 16, dtype=torch.int8, **m)
    scale = torch.empty(8, 1, 16, dtype=torch.float32, **m)
    with pytest.raises(NotImplementedError, match="K3"):
        k3.paged_attention(q, pages, pages, scale, scale,
                           torch.empty(2, 4, dtype=torch.int32, **m),
                           torch.empty(2, dtype=torch.int32, **m))
    with pytest.raises(NotImplementedError, match="K2"):
        k2.paged_prefill_attention(q.reshape(1, 2, 4, 16), pages, pages,
                                   scale, scale,
                                   torch.empty(4, dtype=torch.int32, **m),
                                   q_start=0)
    with pytest.raises(NotImplementedError, match="K8"):
        k8.flash_attention(*(torch.empty(2, 64, 16, **m) for _ in range(3)))
    x = torch.empty(4, 64, dtype=torch.bfloat16, **m)
    for impl in ("torch", "hybrid"):
        with pytest.raises(ValueError, match="meta"):
            ops.quantize_rowwise(x, impl=impl)


def test_meta_forward_reaches_no_plain_version():
    cfg = get_config("qwen2-0.5b", reduced=True, qmode="w8a8")
    params = quantize_params(init_params(cfg, generator=torch.Generator(),
                                         device="meta"), cfg, "w8a8")
    kernels = str(Path(ops.__file__).parent)
    plain = []

    def prof(frame, event, arg):
        code = frame.f_code
        if event == "call" and code.co_filename.startswith(kernels) and (
                code.co_name.endswith(("_ref", "_reference"))):
            plain.append(code.co_name)
    tokens = torch.empty(2, 8, dtype=torch.int32, device="meta")
    counted = []
    from repro_torch.kernels import meta
    sys.setprofile(prof)
    try:
        with meta.recording(lambda k, f, b: counted.append(k)), \
                torch.no_grad():
            logits, _, _ = forward(params, cfg, tokens)
    finally:
        sys.setprofile(None)
    assert logits.shape == (2, 8, cfg.vocab_size) and logits.is_meta
    assert plain == []
    assert counted.count("camp_gemm_fused_w8a8") == 7 * cfg.n_layers


# ---------------------------------------------------------------------------
# the dense slab's attention in the reference's layout
# ---------------------------------------------------------------------------
def test_attn_cols_bit_for_bit(background):
    one = worker.one_process()
    ranks = background["ranks"].result(timeout=240)
    for r, got in enumerate(ranks):
        for name in ("serve", "decode_rules"):
            assert "attn_cols" in got[name + "_layout"], (r, name)
            assert len(got[name]) == len(one[name])
            for i, (g, w) in enumerate(zip(got[name], one[name])):
                assert (torch.from_numpy(g) == w).all(), (r, name, i)


class _Pair:
    """Rank 1's view of a (1, 2) mesh, for the shards alone."""
    shape = {"data": 1, "model": 2}
    coords = {"data": 0, "model": 1}
    rank = 1


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "jamba-v0.1-52b"])
def test_attention_layout_follows_the_path(arch):
    """Attention whose kv heads the model axis does not divide: the paged
    engine's shards hold it whole; the dense slab's (``slab_shards``, and
    ``shard_params`` of a config only the dense slab serves) hold the
    reference's column blocks, which the paged engine refuses."""
    from repro_torch.parallel.sharding import runs_dense_slab, shard_params
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            slab_shards)
    cfg = get_config(arch, reduced=True, qmode="w8a8")
    assert cfg.n_kv_heads % 2
    params = quantize_params(init_params(cfg, device="cpu"), cfg, "w8a8")
    i = next(i for i in range(cfg.n_layers) if cfg.mixer_of(i) == "attn")
    wq = params["layers"][i]["attn"]["wq"]
    slab = slab_shards(params, _Pair(), cfg)
    assert "attn_cols" in slab.layout and not slab.layout & {"heads", "wo"}
    assert slab["layers"][i]["attn"]["wq"].q.shape[-1] == wq.q.shape[-1] // 2
    paged = shard_params(params, _Pair(), cfg)
    if runs_dense_slab(cfg):
        assert paged.layout == slab.layout
        return
    assert not paged.layout & {"attn_cols", "heads", "wo"}
    assert paged["layers"][i]["attn"]["wq"] is wq
    with pytest.raises(ValueError, match="dense slab"):
        ContinuousBatchingEngine(slab, cfg, mesh=_Pair(), device="cpu")


def _meta_steps(background):
    if "meta_steps" not in background:
        proc, conn = background["pod"]
        assert conn.poll(240), "the meta steps gave no result in 240 s"
        status, out = conn.recv()
        proc.join(10)
        assert status == "ok", out
        background["meta_steps"] = out
    return background["meta_steps"]


def test_multi_pod_training_runs_under_its_rules(background):
    """The multi-pod train rules put the batch's sequence (``seq_act``) on
    ``pod``, the single-pod rules keep it whole; rank 0's step under them
    runs on meta (reduced qwen3-0.6b, and jamba-v0.1-52b's Mamba,
    attention and MoE layers, on a (2, 2, 2) fake mesh): its batch holds
    its rows' first 32 of 64 positions, and every mixer's gather of the
    sequence sums its gradient over ``pod`` in the backward."""
    cfg = get_config("qwen2-0.5b", reduced=True)
    _, specs = dr.batch_specs(cfg, 4, 8, make_rules("train"), _Pair())
    assert specs["labels"] == (("data", "model"), None)
    out = _meta_steps(background)
    for arch in worker.MULTI_POD_ARCHS:
        spec, rec = out[arch]
        family = get_config(arch).family
        rows = ("data",) if family == "hybrid" else ("data", "model")
        assert spec == (rows if len(rows) > 1 else rows[0], "pod"), arch
        b = 8 // (2 if family == "hybrid" else 4)
        assert rec["batch"]["labels"] == [b, 32] and rec["start"] == 0
        n_layers = get_config(arch, reduced=True).n_layers
        assert rec["seq_grads"] == [("pod",)] * n_layers, arch
        assert rec["memory"]["peak_bytes"] > 0, arch


def test_b2_decode_runs_on_meta(background):
    """The hillclimb's B2 (experts over model, expert_ff over data): rank
    0's decode step of reduced moonshot W8A8 on a (2, 2) fake mesh runs
    through the kernels' meta rules (the card's path: contiguous
    operands), the experts' weights moving by all-to-all over model and
    the dispatch slabs by all-gather over data."""
    rec = _meta_steps(background)["b2"]
    assert rec["kernels"]["camp_gemm_fused_w8a8"]["calls"] > 0
    assert rec["kernels"]["camp_gemm_i8"]["calls"] > 0
    assert {"all-to-all", "all-gather", "all-reduce"} <= set(
        rec["collectives"])
