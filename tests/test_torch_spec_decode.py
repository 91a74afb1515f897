"""The port's speculative decoding against the reference's.

* The pieces, live against the reference on the same inputs: the n-gram
  drafter's proposals, greedy ``accept_speculative``, ``SpecStats.
  summary()``, and the γ model (``expected_spec_tokens``,
  ``get_spec_gamma``) over a grid of acceptance × draft cost, each
  package with its own temporary cache.
* The engine, in W8A8 and ``none`` over int8 pages, on the reference
  test's tiny config (``tests/test_spec_decode.py``) with the reference's
  own weights carried across: every case of ``tests/spec_reference.py``
  (an n-gram drafter, a strong and a bad draft model, prefix sharing with
  mixed admission, the token budget, ``gamma='auto'``) gives the
  reference's greedy streams, per-request spec counts, free pages and
  ``shared_page_stats()`` after every step; and each stream equals the
  port's own non-speculative one. The reference engine runs live for
  ``LIVE_CASES`` (an n-gram drafter and a strong draft, W8A8); the other
  cases read ``tests/spec_reference.json``, recorded from the reference
  engine (its eager compiles make a live run of all cases take minutes),
  and the recording is held to the live runs.
* Temperature, the port alone: the first emitted token's marginal is
  softmax(row/T) (total variation < 0.06 over 3,000 draws) for a sampled
  and a one-hot draft, and one seed gives one stream.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import autotune as jax_autotune  # noqa: E402
from repro.serving import spec_decode as jax_sd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch.serving import spec_decode as sd  # noqa: E402
from repro_torch.serving.engine import (ContinuousBatchingEngine,  # noqa: E402
                                        generate)
from spec_reference import (BAD_DRAFT, CAPACITY, CASES, CHUNK,  # noqa: E402
                            JSON_PATH, LIVE_CASES, PS, TINY, prompts_main,
                            reference_case, reference_models, run_engine,
                            weight_digest)
from torch_parity import jax_to_numpy  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401 (autouse)
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)

RECORDED = json.loads(JSON_PATH.read_text())


# ---------------------------------------------------------------------------
# The pieces, live against the reference
# ---------------------------------------------------------------------------
def _history(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 12, 40).tolist()
    pat = rng.integers(0, 50, 5).tolist()
    return (pat * 6)[:30 - rng.integers(0, 5)] + rng.integers(0, 50, 2).tolist()


@pytest.mark.parametrize("kind", ["random", "repetitive"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gamma", [1, 4])
def test_ngram_proposals_match_reference(kind, seed, gamma):
    h = _history(kind, seed)
    for args in ((3, 1, 4096), (2, 2, 4096), (3, 1, 12)):
        want = jax_sd.NGramDrafter(*args).propose(0, h, gamma)
        got = sd.NGramDrafter(*args).propose(0, h, gamma)
        assert got == want
    # the reference test's literal cases
    d = sd.NGramDrafter(max_n=3, min_n=1)
    assert d.propose(0, [5, 6, 7, 8, 9, 5, 6, 7], 3) == ([8, 9, 5], None)
    assert d.propose(0, [1, 2, 3], 4) == ([], None)
    assert d.propose(0, [1, 9, 1, 4, 1], 1) == ([4], None)


@pytest.mark.parametrize("seed", range(4))
def test_greedy_acceptance_matches_reference(seed):
    rng = np.random.default_rng(seed)
    gamma, v = 4, 9
    rows = rng.standard_normal((gamma + 1, v)).astype(np.float32)
    argm = [int(r.argmax()) for r in rows]
    for n_good in range(gamma + 1):
        draft = argm[:n_good] + [(a + 1) % v for a in argm[n_good:gamma]]
        want = jax_sd.accept_speculative(
            rows, draft, None, sample="greedy", temperature=1.0,
            key=jax.random.PRNGKey(0), seq_id=0, start_index=0)
        got = sd.accept_speculative(rows, draft, None, sample="greedy",
                                    temperature=1.0, seed=0, seq_id=0,
                                    start_index=0)
        assert got == want
        assert got == (n_good, argm[:n_good + 1])


def test_spec_stats_summary_matches_reference():
    got, want = sd.SpecStats(), jax_sd.SpecStats()
    assert got.summary() == want.summary()
    for p, a, e in ((4, 2, 3), (3, 3, 4), (0, 0, 1)):
        got.add(p, a, e)
        want.add(p, a, e)
    assert got.summary() == want.summary()
    assert list(got.summary()) == list(want.summary())


@pytest.mark.parametrize("draft_cost", [0.0, 0.1, 0.25, 1.0])
def test_gamma_model_matches_reference(draft_cost, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "port.json"))
    jax_autotune.clear_cache()
    autotune.clear_cache()
    try:
        assert autotune.SPEC_GAMMAS == jax_autotune.SPEC_GAMMAS
        assert autotune.DEFAULT_SPEC_GAMMA == jax_autotune.DEFAULT_SPEC_GAMMA
        for acc in np.linspace(0.0, 1.0, 23):
            for g in autotune.SPEC_GAMMAS:
                assert autotune.expected_spec_tokens(g, acc) == \
                    jax_autotune.expected_spec_tokens(g, acc)
            assert autotune.get_spec_gamma(acc, draft_cost=draft_cost,
                                           save=False) == \
                jax_autotune.get_spec_gamma(acc, draft_cost=draft_cost,
                                            save=False)
        ref_keys = {k for k in jax_autotune._mem_cache if k.startswith("spec|")}
        assert set(autotune._mem_cache) == ref_keys
        assert not (tmp_path / "port.json").exists()
        autotune.clear_cache()
        autotune.get_spec_gamma(0.5, draft_cost=draft_cost)   # persisted
        assert autotune.cache_path() == str(tmp_path / "port.json")
        on_disk = json.loads((tmp_path / "port.json").read_text())
        assert f"spec|acc0.50|dc{draft_cost:.2f}|cpu" in on_disk
        assert not (tmp_path / "ref.json").exists()
    finally:
        jax_autotune.clear_cache()
        autotune.clear_cache()


def test_forward_clamps_token_ids_past_the_vocabulary_like_reference():
    """A draft model with a narrower vocabulary than its target reads the
    target's token ids: the reference's gather clamps ids past the
    vocabulary to its last row, and so must the port."""
    import jax.numpy as jnp
    from repro.models import forward as jax_forward
    from torch_parity import reduced_qwen_pair, to_numpy
    from repro_torch.models import forward
    jcfg, jp, cfg, tp = reduced_qwen_pair()
    ids = np.array([[3, 511, 512, 900, 151_935, 7]], np.int32)
    want, _, _ = jax_forward(jp, jcfg, jnp.asarray(ids))
    got, _, _ = forward(tp, cfg, torch.from_numpy(ids).long())
    clamped, _, _ = forward(tp, cfg, torch.from_numpy(
        np.minimum(ids, cfg.vocab_size - 1)).long())
    assert torch.equal(got, clamped)
    # the forward tolerance of tests/test_torch_transformer.py
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=0,
                               atol=0.01 * np.abs(to_numpy(want)).max())


# ---------------------------------------------------------------------------
# The engine against the reference's live and recorded runs
# ---------------------------------------------------------------------------
class PortModels:
    """The port's cfgs and params, converted from the reference's and
    checked against the digests the recording was made from, the port's
    non-speculative streams, and the reference engine's live records,
    each made once per module."""

    def __init__(self, cache_dir):
        self._cache_dir = cache_dir
        self._models, self._jax, self._base, self._live = {}, {}, {}, {}

    def __call__(self, qmode):
        if qmode not in self._models:
            self._jax[qmode] = reference_models(qmode)
            _, jp, _, jdp = self._jax[qmode]
            tree, dtree = jax_to_numpy(jp), jax_to_numpy(jdp)
            assert [weight_digest(tree), weight_digest(dtree)] == \
                RECORDED["digests"][qmode], \
                "reference weights changed: rerun tests/spec_reference.py"
            self._models[qmode] = (
                get_config("qwen2-0.5b", qmode=qmode, **TINY),
                from_jax_params(tree, device="cpu"),
                get_config("qwen2-0.5b", qmode=qmode, **BAD_DRAFT),
                from_jax_params(dtree, device="cpu"))
        return self._models[qmode]

    def base_streams(self, qmode, prompts_fn, max_new):
        key = (qmode, prompts_fn.__name__, max_new)
        if key not in self._base:
            cfg, params, _, _ = self(qmode)
            self._base[key] = run_engine(
                lambda: _engine(cfg, params, None), _submit, prompts_fn(),
                max_new)["streams"]
        return self._base[key]

    def reference(self, qmode, name, max_new):
        """The reference engine's record of one case, run live."""
        key = (qmode, name, max_new)
        if key not in self._live:
            self(qmode)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("REPRO_AUTOTUNE_CACHE",
                          str(self._cache_dir / "ref.json"))
                jax_autotune.clear_cache()
                try:
                    self._live[key] = reference_case(self._jax[qmode], name,
                                                     max_new)
                finally:
                    jax_autotune.clear_cache()
        return self._live[key]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return PortModels(tmp_path_factory.mktemp("spec_reference"))


def _engine(cfg, params, spec, **kw):
    return ContinuousBatchingEngine(
        params, cfg, kv_dtype="int8", page_size=PS, capacity_tokens=CAPACITY,
        prefill_chunk=CHUNK, spec=spec, device="cpu", **kw)


def _submit(eng, p, n):
    return eng.submit(torch.from_numpy(p), n)


ENGINE_CASES = [(q, name, n) for q in ("w8a8", "none")
                for name, (_, _, max_news) in CASES.items()
                for n in max_news]


@pytest.mark.parametrize("qmode,name,max_new", ENGINE_CASES)
def test_engine_matches_reference(port, qmode, name, max_new, tmp_path,
                                  monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    autotune.clear_cache()
    (method, gamma, draft), prompts_fn, _ = CASES[name]
    cfg, params, dcfg, dparams = port(qmode)
    dc, dp = {"self": (cfg, params), "bad": (dcfg, dparams),
              None: (None, None)}[draft]
    spec = sd.SpecConfig(method=method, gamma=gamma, draft_cfg=dc,
                         draft_params=dp)
    try:
        got = run_engine(lambda: _engine(cfg, params, spec), _submit,
                         prompts_fn(), max_new)
    finally:
        autotune.clear_cache()
    if (qmode, name, max_new) in LIVE_CASES:
        want = port.reference(qmode, name, max_new)
    else:
        want = RECORDED["cases"][f"{qmode}/{name}/{max_new}"]
    assert got["streams"] == want["streams"]
    assert got["streams"] == port.base_streams(qmode, prompts_fn, max_new)
    assert all(len(s) == max_new for s in got["streams"])
    assert got == want                 # counts, γ, pages, shared-page trace
    assert got["free"] == got["num_pages"]
    if draft is not None:
        assert got["draft_free"] == got["draft_pages"]
    if name == "strong_draft":
        assert got["totals"][2] > 0.9 * got["totals"][1]
    if name == "bad_draft":
        assert got["totals"][2] < 0.5 * got["totals"][1]
    if name == "prefix_mixed":
        assert max(s["shared_slots"] for s in got["shared"]) == 2
    if name == "auto_gamma":
        assert got["totals"][0] >= ContinuousBatchingEngine.SPEC_RETUNE_EVERY
        assert got["gamma"] == max(autotune.SPEC_GAMMAS)


@pytest.mark.parametrize("qmode,name,max_new", LIVE_CASES)
def test_recording_matches_live_reference(port, qmode, name, max_new):
    """Today's reference engine still gives what the recording holds."""
    assert RECORDED["cases"][f"{qmode}/{name}/{max_new}"] == \
        port.reference(qmode, name, max_new)


def test_engine_spec_options_and_generate(port):
    cfg, params, _, _ = port("none")
    assert _engine(cfg, params, sd.SpecConfig(method="off")).drafter is None
    with pytest.raises(ValueError, match="gamma"):
        _engine(cfg, params, sd.SpecConfig(method="ngram", gamma=0))
    with pytest.raises(ValueError, match="draft_cfg"):
        _engine(cfg, params, sd.SpecConfig(method="draft"))
    prompts = prompts_main()
    batch = torch.from_numpy(np.stack([prompts[0][:17], prompts[1]]))
    want = generate(params, cfg, batch, steps=9, kv_dtype="int8",
                    device="cpu")
    got = generate(params, cfg, batch, steps=9, kv_dtype="int8",
                   device="cpu", spec=sd.SpecConfig(method="ngram", gamma=3))
    assert torch.equal(got, want)


def test_draft_model_declines_when_its_pool_is_full(port):
    """A draft pool too small for a sequence: that sequence runs without
    drafts (the reference's behaviour) and the stream is unchanged."""
    cfg, params, _, _ = port("none")
    spec = sd.SpecConfig(method="draft", gamma=3, draft_cfg=cfg,
                         draft_params=params, draft_capacity_tokens=48)
    got = run_engine(lambda: _engine(cfg, params, spec), _submit,
                     prompts_main(), 14)
    assert got["streams"] == port.base_streams("none", prompts_main, 14)
    # a draft reservation is the request's tokens + max(SPEC_GAMMAS) + 1:
    # 36 + 14 + 9 = 59 does not fit the 48-token pool, 17 + 14 + 9 = 40 does
    per = got["per_request"]
    assert per[0][1] == 0 and per[1][1] > 0
    assert got["draft_free"] == got["draft_pages"]


# ---------------------------------------------------------------------------
# Temperature, the port alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sampled_q", [True, False])
def test_acceptance_preserves_target_distribution(sampled_q):
    """The first emitted token's marginal equals softmax(row/T) whether the
    drafts are sampled from q or come from a one-hot drafter."""
    rng = np.random.default_rng(0)
    v, gamma, temp, n = 12, 2, 0.8, 3000
    rows = (rng.standard_normal((gamma + 1, v)) * 2).astype(np.float32)
    q = sd._softmax(rng.standard_normal((gamma, v)).astype(np.float32))
    p0 = sd._softmax(rows[0] / temp)
    counts = np.zeros(v)
    for s in range(n):
        if sampled_q:
            draft = [int(rng.choice(v, p=q[i])) for i in range(gamma)]
            _, emitted = sd.accept_speculative(
                rows, draft, q, sample="temperature", temperature=temp,
                seed=s, seq_id=0, start_index=0)
        else:
            _, emitted = sd.accept_speculative(
                rows, [3, 5], None, sample="temperature", temperature=temp,
                seed=s, seq_id=1, start_index=4)
        counts[emitted[0]] += 1
    tv = 0.5 * np.abs(counts / n - p0).sum()
    assert tv < 0.06, f"total variation {tv:.3f}"


@pytest.mark.parametrize("method", ["ngram", "draft"])
def test_temperature_spec_is_deterministic(port, method):
    cfg, params, _, _ = port("w8a8")
    spec = sd.SpecConfig(method=method, gamma=3, draft_cfg=cfg,
                         draft_params=params)

    # every token of the vocabulary in the first prompt: whatever is
    # sampled, the n-gram drafter finds a continuation
    prompts = [np.random.default_rng(3).permutation(256).astype(np.int32),
               prompts_main()[0]]

    def run(seed):
        return run_engine(
            lambda: _engine(cfg, params, spec, sample="temperature",
                            temperature=0.9, seed=seed),
            _submit, prompts, 10)

    a, b = run(5), run(5)
    assert a == b
    assert a["totals"][1] > 0
    assert all(0 <= t < cfg.vocab_size for s in a["streams"] for t in s)
    assert a["free"] == a["num_pages"]
    assert run(6)["streams"] != a["streams"]
