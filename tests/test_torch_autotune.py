"""The port's autotune against the reference's (``repro/core/autotune.py``).

* Page size and prefill chunk: given the same scorer, ``get_page_size``
  and ``get_prefill_params`` pick what the reference's pick (same
  candidates, same tie order, same keys).
* ``warm_gemm_autotune`` enumerates the reference's (M, N, K) set at full
  width: qwen2-0.5b (with verify panels, with tp 2), moonshot-v1-16b-a3b
  (the experts at capacity M) and stablelm-12b (the untied head).
* GEMM plans: the candidates hold the seed, never ``SPLIT_SCALES``, and
  fit shared memory; ``tune(timer=)`` takes the argmin and persists it to
  the port's file only; a cold ``get_plan`` returns the seed and stores
  nothing, and a stored plan the template cannot run is ignored.
* The analytic H100 model rises with M, N and K.
* The engine's defaults are the autotune's picks, and the reference's
  engine with those picks pinned gives the same greedy streams and page
  accounting.

Every test points both packages' cache files into its own ``tmp_path``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import autotune as jax_autotune  # noqa: E402
from repro.serving.engine import \
    ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving.engine import \
    warm_gemm_autotune as jax_warm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import autotune, blocking  # noqa: E402
from repro_torch.core.blocking import PlanConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.engine import (ContinuousBatchingEngine,  # noqa: E402
                                        warm_gemm_autotune)
from torch_parity import (check_streams, random_prompts,  # noqa: E402
                          reduced_qwen_pair)
from torch_parity import one_thread  # noqa: E402,F401 (autouse)


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    """Both caches in ``tmp_path``, empty in memory before and after."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    autotune.clear_cache()
    jax_autotune.clear_cache()
    yield tmp_path
    autotune.clear_cache()
    jax_autotune.clear_cache()


PAGE_TIMERS = {"nearest 32": lambda ps: abs(ps - 32),
               "largest": lambda ps: -ps,
               "all tie": lambda ps: 1.0}
CHUNK_TIMERS = {"nearest 128, fewest pages": lambda c, pp: abs(c - 128) + pp,
                "largest product": lambda c, pp: -c * pp,
                "pages tie": lambda c, pp: -c,
                "all tie": lambda c, pp: 1.0}


@pytest.mark.parametrize("timer", list(PAGE_TIMERS), ids=str)
def test_page_size_pick_matches_reference(caches, timer):
    fn = PAGE_TIMERS[timer]
    got = autotune.get_page_size(2, 64, 4096, timer=fn)
    assert got == jax_autotune.get_page_size(2, 64, 4096, timer=fn)
    data = json.loads((caches / "torch.json").read_text())
    # the reference's key, with the query group (the card's scorer reads it)
    assert list(data) == ["pattn|kv2|hd64|len4096|b8|g1|cpu"]
    assert data["pattn|kv2|hd64|len4096|b8|g1|cpu"]["page_size"] == got
    # cached: a contradictory timer does not override the stored pick
    assert autotune.get_page_size(2, 64, 4096, timer=lambda ps: ps) == got
    # another query group is another shape
    assert autotune.get_page_size(2, 64, 4096, group=7,
                                  timer=lambda ps: ps) == 8


@pytest.mark.parametrize("timer", list(CHUNK_TIMERS), ids=str)
def test_prefill_pick_matches_reference(caches, timer):
    fn = CHUNK_TIMERS[timer]
    got = autotune.get_prefill_params(2, 64, 16, 4096, timer=fn)
    assert got == jax_autotune.get_prefill_params(2, 64, 16, 4096, timer=fn)
    data = json.loads((caches / "torch.json").read_text())
    entry = data["pprefill|kv2|hd64|ps16|len4096|cpu"]
    assert (entry["chunk"], entry["pages_per_step"]) == got


MEASURED_ROUNDS = {
    # K3 µs a round by page size → the pick
    "within the spread": ({8: [33, 33, 34], 16: [30.8, 30.9, 31.2],
                           32: [30.5, 30.6, 30.9], 64: [31, 31, 31.1],
                           128: [30.8, 30.8, 31]}, 16),
    "beyond the spread": ({8: [40, 40, 40], 16: [30, 30.3, 30.1],
                           32: [25, 25.1, 25], 64: [27, 27, 27],
                           128: [26, 26, 26]}, 32),
    "the incumbent fastest": ({8: [9, 9, 9], 16: [5, 5, 5], 32: [6, 6, 6],
                               64: [7, 7, 7], 128: [8, 8, 8]}, 16),
}


@pytest.mark.parametrize("case", list(MEASURED_ROUNDS), ids=str)
def test_measured_page_pick_keeps_16_within_the_spread(case):
    """On the card the page only leaves the engine's 16 for a size whose
    median beats 16's by more than the largest spread of any size's
    rounds."""
    from repro_torch.serving.kv_cache import DEFAULT_PAGE_SIZE
    rounds, want = MEASURED_ROUNDS[case]
    got, med, spread = autotune.pick_measured_page(
        {ps: [t * 1e-6 for t in ts] for ps, ts in rounds.items()})
    assert DEFAULT_PAGE_SIZE == 16 and got == want
    assert med[16] == pytest.approx(sorted(rounds[16])[1] * 1e-6)
    assert spread == pytest.approx(max((max(ts) - min(ts)) / sorted(ts)[1]
                                       for ts in rounds.values()))


def test_tune_refuses_a_measure_the_backend_cannot_keep(caches):
    """The CPU has no kernel to time; on the card plans are always
    measured, so the model's picks never reach a launch."""
    with pytest.raises(ValueError, match="measured on the card"):
        autotune.tune("i8", 8, 896, 896, fused=True, a_in_bytes=2,
                      measure=True)
    assert autotune.cached_entries("") == {}
    assert autotune.tune("i8", 8, 896, 896, fused=True, a_in_bytes=2,
                         measure=False) == autotune.get_plan(
        "i8", 8, 896, 896, fused=True, a_in_bytes=2)


def test_analytic_pages_per_step_is_one():
    """K2 does not read pages per step, so the port's model scores every
    value alike and the tie goes to 1."""
    for mean_len in (128, 4096):
        chunk, pp = autotune.get_prefill_params(2, 64, 16, mean_len)
        assert chunk in autotune.PREFILL_CHUNKS and pp == 1
    assert autotune.get_page_size(2, 64, 4096) in autotune.PAGE_SIZES


WARM_CASES = {
    "qwen2-0.5b": ("qwen2-0.5b", {}),
    "qwen2-0.5b spec 4": ("qwen2-0.5b", {"spec_gammas": (4,)}),
    "qwen2-0.5b tp 2": ("qwen2-0.5b", {"tp": 2}),
    "qwen2-0.5b prefill 256": ("qwen2-0.5b", {"batch_sizes": (1,),
                                              "prefill_len": 256}),
    "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", {}),
    "stablelm-12b w4a8": ("stablelm-12b", {"batch_sizes": (1, 8)}),
}


@pytest.mark.parametrize("case", list(WARM_CASES), ids=str)
def test_warm_gemm_autotune_shapes_match_reference(case):
    arch, kw = WARM_CASES[case]
    qmode = "w4a8" if "w4a8" in case else "w8a8"
    want = jax_warm(jax_get_config(arch, qmode=qmode), measure=False, **kw)
    cfg = get_config(arch, qmode=qmode)
    got = warm_gemm_autotune(cfg, measure=False, **kw)
    assert sorted(s for s, _ in got) == sorted(s for s, _ in want)
    if cfg.moe_experts:
        kns = {(k, n) for ((m, n, k), _) in got}
        assert {(cfg.d_model, cfg.expert_ff), (cfg.expert_ff, cfg.d_model)} \
            <= kns
    if not cfg.tie_embeddings:
        assert any(n == cfg.vocab_size for ((m, n, k), _) in got)
    kind = autotune.KINDS[0 if qmode == "w8a8" else 1]
    for (m, n, k), plan in got:
        assert autotune.has_cached(kind, m, n, k, fused=True, a_in_bytes=2)
        assert autotune.get_plan(kind, m, n, k, fused=True,
                                 a_in_bytes=2) == plan
    assert warm_gemm_autotune(cfg, measure=False, **kw) == []   # all cached
    assert warm_gemm_autotune(get_config(arch, qmode="none")) == []


GEMM_SHAPES = [(1, 896, 896), (8, 4864, 896), (8, 896, 4864), (32, 896, 128),
               (256, 896, 4864), (4096, 4864, 896), (3, 200, 4870),
               (8, 163840, 2048)]


@pytest.mark.parametrize("kind", autotune.KINDS)
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_candidates_hold_seed_fit_and_never_split_scales(kind, fused):
    w4 = kind != "i8"
    for m, n, k in GEMM_SHAPES:
        cands = autotune.candidates(kind, m, n, k, fused=fused)
        seed = blocking.choose_plan(m, n, k, blocking.H100_SMS, fused)
        assert cands[0] == seed
        assert len(set(cands)) == len(cands)
        assert {p.mt for p in cands} == set(blocking.TC_ROW_TILES)
        steps = blocking.k_steps(k)
        for p in cands:
            assert not p.flags & blocking.SPLIT_SCALES
            assert p.smem_bytes(w4) <= blocking.SMEM_PER_BLOCK
            assert blocking.valid_plan(p, k, fused=fused, w4=w4)
            assert p.splits * p.per >= steps > (p.splits - 1) * p.per
            if p.flags & blocking.FLUSH_IN_BLOCK:
                assert p.splits == 1
            if not fused:
                assert not p.flags & blocking.SCALE_KERNEL
        splits = {p.splits for p in cands}
        assert 1 in splits and seed.splits in splits


def test_valid_plan_refuses_what_the_template_cannot_run():
    k = 896                                  # 7 K steps
    ok = PlanConfig(8, 3, 3, 0)
    assert blocking.valid_plan(ok, k, fused=True, w4=False)
    for bad in (PlanConfig(16, 3, 3, 0),                 # no such row tile
                PlanConfig(8, 2, 3, 0),                  # steps left out
                PlanConfig(8, 7, 2, 0),                  # empty splits
                PlanConfig(8, 3, 3, blocking.FLUSH_IN_BLOCK),
                PlanConfig(8, 3, 3, blocking.SPLIT_SCALES)):
        assert not blocking.valid_plan(bad, k, fused=True, w4=False), bad
    assert not blocking.valid_plan(PlanConfig(8, 3, 3, blocking.SCALE_KERNEL),
                                   k, fused=False, w4=False)


def test_tune_picks_argmin_and_persists_to_the_port_file(caches, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    m, n, k = 8, 4864, 896
    cands = autotune.candidates("w4", m, n, k, fused=True)
    want = cands[-1]
    assert want != cands[0]
    got = autotune.tune("w4", m, n, k, fused=True, a_in_bytes=2,
                        timer=lambda p: 0.0 if p == want else 1.0)
    assert got == want
    path = caches / "home" / ".cache" / "repro_torch" / "autotune.json"
    assert autotune.cache_path() == str(path)
    entry = json.loads(path.read_text())["w4|fused-a2B|m8|n4864|k896|cpu"]
    assert entry["plan"] == list(want) and entry["source"] == "timer"
    assert not (caches / "home" / ".cache" / "repro").exists()
    assert not (caches / "ref.json").exists()
    assert autotune.get_plan("w4", m, n, k, fused=True, a_in_bytes=2) == want
    autotune.clear_cache()                   # a new process reads the file
    assert autotune.get_plan("w4", m, n, k, fused=True, a_in_bytes=2) == want
    # another activation type is another shape: the seed
    assert autotune.get_plan("w4", m, n, k, fused=True, a_in_bytes=4) \
        == cands[0]
    # ties go to the seed
    assert autotune.tune("w4", m, n, k, fused=True, a_in_bytes=2,
                         timer=lambda p: 1.0) == cands[0]


def test_tune_on_the_cpu_takes_the_model_argmin(caches):
    m, n, k = 256, 896, 4864
    got = autotune.tune("i8", m, n, k, fused=True, a_in_bytes=2)
    cands = autotune.candidates("i8", m, n, k, fused=True)
    times = [autotune.model_time_s("i8", m, n, k, p, fused=True,
                                   a_in_bytes=2) for p in cands]
    assert got == cands[int(np.argmin(times))]
    entry = autotune.cached_entries("i8|")["i8|fused-a2B|m256|n896|k4864|cpu"]
    assert entry["source"] == "model"


def test_cold_get_plan_returns_seed_and_stores_nothing(caches):
    for kind in autotune.KINDS:
        for fused in (False, True):
            for m, n, k in GEMM_SHAPES:
                plan = autotune.get_plan(kind, m, n, k, fused=fused,
                                         a_in_bytes=2)
                assert plan == blocking.choose_plan(m, n, k,
                                                    blocking.H100_SMS, fused)
                assert not autotune.has_cached(kind, m, n, k, fused=fused,
                                               a_in_bytes=2)
    assert autotune.cached_entries("") == {}
    autotune.flush()
    assert json.loads((caches / "torch.json").read_text()) == {}


def test_stored_plans_the_template_cannot_run_are_ignored(caches):
    """A cache file is outside input: a plan with ``SPLIT_SCALES`` (wrong
    on purpose), a split that leaves K steps out, or a malformed entry
    gives way to the seed."""
    m, n, k = 8, 896, 4864
    seed = blocking.choose_plan(m, n, k, blocking.H100_SMS, True)
    bad = {f"i8|fused-a2B|m{m}|n{n}|k{k}|cpu":
           {"plan": [seed.mt, seed.splits, seed.per, blocking.SPLIT_SCALES]},
           f"w4|fused-a2B|m{m}|n{n}|k{k}|cpu":
           {"plan": [seed.mt, seed.splits - 1, seed.per, 0]},
           f"a4w4|fused-a2B|m{m}|n{n}|k{k}|cpu": {"plan": "8,1,1,0"}}
    (caches / "torch.json").write_text(json.dumps(bad))
    for kind in autotune.KINDS:
        assert autotune.has_cached(kind, m, n, k, fused=True, a_in_bytes=2)
        assert autotune.get_plan(kind, m, n, k, fused=True,
                                 a_in_bytes=2) == seed


def test_model_time_rises_with_m_n_k():
    def t(kind, m, n, k):
        plan = blocking.choose_plan(m, n, k, blocking.H100_SMS, True)
        return autotune.model_time_s(kind, m, n, k, plan, fused=True,
                                     a_in_bytes=2)
    for kind in autotune.KINDS:
        for axis in range(3):
            times = []
            for v in (8, 256, 4096, 32768):
                shape = [512, 896, 896]
                shape[axis] = v
                times.append(t(kind, *shape))
            assert times == sorted(times) and times[-1] > times[0], \
                (kind, axis, times)
        # at one plan: more rows or columns never cost less
        plan = PlanConfig(32, 4, 2, 0)
        for small, big in (((8, 896, 896), (32, 896, 896)),
                           ((64, 896, 896), (64, 4864, 896))):
            assert autotune.model_time_s(kind, *small, plan) \
                <= autotune.model_time_s(kind, *big, plan)


def test_cpu_tensors_ignore_the_plan():
    """The plain versions have no plan: ``plan=`` changes nothing on the
    CPU, through ``ops`` and ``camp_matmul``."""
    from repro_torch.core.camp import camp_matmul
    from repro_torch.core.quant import quantize_weight
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    w = quantize_weight(torch.from_numpy(
        rng.standard_normal((64, 48)).astype(np.float32)), bits=8)
    odd = PlanConfig(128, 1, 1, blocking.SPLIT_SCALES)
    for qmode, fn in (("w8a8", ops.gemm_i8_fused),):
        want = fn(x, w.q, w.scale)
        assert torch.equal(fn(x, w.q, w.scale, plan=odd), want)
        assert torch.equal(camp_matmul(x, w, qmode=qmode, plan=odd),
                           camp_matmul(x, w, qmode=qmode))
    a_q, a_s = ops.quantize_rowwise(x)
    assert torch.equal(ops.gemm_i8(a_q, w.q, a_s, w.scale, plan=odd),
                       ops.gemm_i8(a_q, w.q, a_s, w.scale))


@pytest.fixture(scope="module")
def model():
    return reduced_qwen_pair()


def test_engine_defaults_are_the_autotune_picks(model):
    """No ``page_size``/``prefill_chunk``: the port's engine takes the
    autotune's picks (at ``mean_len = max(max_seq_len // 2, 128)``, as
    the reference's). The reference's engine given those picks pinned
    gives the same page accounting after every step and the same greedy
    streams. Float pages (``generate``'s default): the reference compiles
    its int8-page path for ~20 s on the CPU, and the picks do not depend on
    the page type."""
    jcfg, jp, cfg, tp = model
    mean_len = max(cfg.max_seq_len // 2, 128)
    ps = autotune.get_page_size(cfg.n_kv_heads, cfg.hd, mean_len,
                                group=cfg.n_heads // cfg.n_kv_heads)
    chunk, pp = autotune.get_prefill_params(cfg.n_kv_heads, cfg.hd, ps,
                                            mean_len)
    teng = ContinuousBatchingEngine(tp, cfg, kv_dtype=None,
                                    capacity_tokens=4 * ps, device="cpu")
    assert teng.pool.page_size == ps
    assert teng.chunk_tokens == max(ps, chunk - chunk % ps)
    assert teng.pages_per_step == pp
    jeng = JaxEngine(jp, jcfg, kv_dtype=None, capacity_tokens=4 * ps,
                     page_size=ps, prefill_chunk=chunk, pages_per_step=pp)
    assert jeng.pool.page_size == ps and jeng.chunk_tokens == \
        teng.chunk_tokens
    prompts = random_prompts([6, 6], seed=70)   # one prefill shape
    for p in prompts:
        jeng.submit(jnp.asarray(p), 2)
        teng.submit(torch.from_numpy(p), 2)
    while True:
        more = teng.step()
        assert jeng.step() == more
        assert teng.pool.shared_page_stats() == jeng.pool.shared_page_stats()
        assert teng.pool.tables == jeng.pool.tables
        if not more:
            break
    got = {s: r.tokens for s, r in teng.finished.items()}
    want = {s: r.tokens for s, r in jeng.finished.items()}
    assert sorted(got) == sorted(want)
    check_streams([got[s] for s in sorted(got)],
                  [want[s] for s in sorted(want)], jcfg, jp, prompts)
    assert teng.pool.free == jeng.pool.free


def test_pinned_chunk_skips_the_chunk_pick(model):
    """A caller that pins the chunk gets pages per step 1 unless it pins
    that too, and the chunk's autotune is not consulted."""
    _, _, cfg, tp = model
    for pp, want in ((None, 1), (2, 2)):
        eng = ContinuousBatchingEngine(tp, cfg, kv_dtype=None, page_size=16,
                                       prefill_chunk=64, pages_per_step=pp,
                                       capacity_tokens=64, device="cpu")
        assert (eng.chunk_tokens, eng.pages_per_step) == (64, want)
    assert autotune.cached_entries("pprefill|") == {}
    assert autotune.cached_entries("pattn|") == {}
