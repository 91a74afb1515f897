"""Serving the recurrent and frontend configs: the port's ``generate``
against the reference's, and the frontend models' forwards.

Every case runs on the reduced configs of jamba-v0.1-52b (Mamba +
attention 1:7, MoE on odd layers), rwkv6-7b (RWKV time and channel mix),
pixtral-12b and musicgen-large (float (B, S, D) prompts), none in f32 and
w8a8 / w4a8 / w4a4 in bf16 (``recurrent_reference.CASES`` says why), with
the reference's weights carried across and its numpy prompts.

* The whole model: logits and every cache leaf (attention slabs, Mamba
  h/conv, RWKV s/x_prev) after a prefill and after two teacher-forced
  decode steps, against the eager reference (its engine runs eagerly),
  within ``REL``: f32 5e-5 of max |reference| (the f32 reduction orders
  of the norms, softmax, float matmuls and einsums; seen: up to 8.2e-6,
  rwkv6-7b), bf16 1%, the port's forward tolerance
  (tests/test_torch_transformer.py).
* ``generate`` sends these models to the dense-slab loop in both
  packages; the port's greedy streams must equal the reference's.
  The reference runs live for ``recurrent_reference.LIVE_CASES`` (one a
  model); the other cases read ``tests/recurrent_reference.json``
  (regenerate with ``PYTHONPATH=src python tests/recurrent_reference.py``,
  about a minute), whose weights' SHA-256 must match the ones converted
  here, and the recording is held to the live runs.
* Decode steps feed token ids through the embedding table after a float
  prompt, as the reference does; the paged engine refuses recurrent
  mixers.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from recurrent_reference import (ARCHS, CASES, JSON_PATH,  # noqa: E402
                                 LIVE_CASES, STEPS, config, prompt,
                                 reference_models, reference_streams)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from spec_reference import weight_digest  # noqa: E402
from torch_parity import assert_rel_close, jax_to_numpy  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401 (autouse)
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)

RECORDED = json.loads(JSON_PATH.read_text())
REL = {"float32": 5e-5, "bfloat16": 1e-2}
STATE_STEPS = 2          # teacher-forced decode steps after the prefill


class _Models:
    """Per arch, built once: the reference's cfg and params of every case,
    and the params' numpy trees."""

    def __init__(self):
        self.built = {}

    def __call__(self, arch):
        if arch not in self.built:
            self.built[arch] = {
                q: (cfg, p, jax_to_numpy(p))
                for q, (cfg, p) in reference_models(arch).items()}
        return self.built[arch]


@pytest.fixture(scope="module")
def models():
    return _Models()


def _port_prompt(cfg):
    x = torch.from_numpy(prompt(cfg))
    return x.to(torch.bfloat16) if cfg.embedding_inputs else x.long()


def _jax_prompt(cfg):
    import jax.numpy as jnp
    return jnp.asarray(prompt(cfg), jnp.bfloat16 if cfg.embedding_inputs
                       else jnp.int32)


@pytest.mark.parametrize("qmode,dtype", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(models, arch, qmode, dtype):
    jcfg, jparams, tree = models(arch)[qmode]
    rec = RECORDED["cases"][f"{arch}/{qmode}"]
    assert rec["dtype"] == dtype == jcfg.dtype
    assert weight_digest(tree) == rec["weights_sha256"]
    if (arch, qmode) in LIVE_CASES:
        want = reference_streams(jcfg, jparams)
    else:
        want = rec["streams"]
    cfg = config(arch, qmode, dtype, get_config)
    got = teng.generate(from_jax_params(tree, device="cpu"), cfg,
                        _port_prompt(cfg), steps=STEPS, device="cpu")
    assert got.shape == (len(want), STEPS)
    assert got.tolist() == want


@pytest.mark.parametrize("arch,qmode", LIVE_CASES)
def test_recording_matches_live_reference(models, arch, qmode):
    """Today's reference still gives what the recording holds."""
    jcfg, jparams, _ = models(arch)[qmode]
    assert RECORDED["cases"][f"{arch}/{qmode}"]["streams"] == \
        reference_streams(jcfg, jparams)


def cache_leaves(caches, prefix=""):
    """A per-layer cache list of either package → {path: array}: dict
    entries by key, a DenseKVCache by its k and v."""
    out = {}
    if isinstance(caches, (list, tuple)):
        for i, c in enumerate(caches):
            out.update(cache_leaves(c, f"{prefix}{i}/"))
    elif isinstance(caches, dict):
        for k in sorted(caches):
            out.update(cache_leaves(caches[k], f"{prefix}{k}/"))
    elif hasattr(caches, "k") and hasattr(caches, "v"):
        out.update({prefix + "k": caches.k, prefix + "v": caches.v})
    else:
        out[prefix.rstrip("/")] = caches
    return out


@pytest.mark.parametrize("qmode,dtype", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_state_matches_reference(models, arch, qmode, dtype):
    """Prefill the prompt into fresh float caches in both packages, then
    ``STATE_STEPS`` decode steps, each feeding both the reference's greedy
    token."""
    import jax.numpy as jnp
    from repro.models import forward as jax_forward
    from repro.models import init_caches as jax_init_caches
    from repro_torch.models import forward, init_caches
    jcfg, jq, tree = models(arch)[qmode]
    cfg = config(arch, qmode, dtype, get_config)
    tq = from_jax_params(tree, device="cpu")
    x = prompt(cfg)
    b, s = x.shape[:2]
    jc = jax_init_caches(jcfg, b, s + STATE_STEPS)
    tc = init_caches(cfg, b, s + STATE_STEPS, device="cpu")
    jlog, jc, _ = jax_forward(jq, jcfg, _jax_prompt(cfg), caches=jc)
    tlog, tc, _ = forward(tq, cfg, _port_prompt(cfg), caches=tc)
    for step in range(STATE_STEPS + 1):
        what = f"{arch} {qmode} {dtype} step {step}"
        assert_rel_close(tlog, jlog, REL[dtype], f"{what} logits")
        want, got = cache_leaves(jc), cache_leaves(tc)
        assert sorted(got) == sorted(want), what
        for path in want:
            assert_rel_close(got[path], want[path], REL[dtype],
                             f"{what} {path}")
        if step == STATE_STEPS:
            break
        tok = np.array(jnp.argmax(jlog[:, -1].astype(jnp.float32), -1))
        jlog, jc, _ = jax_forward(jq, jcfg, jnp.asarray(tok[:, None]),
                                  caches=jc, cache_pos=s + step)
        tlog, tc, _ = forward(tq, cfg, torch.from_numpy(tok[:, None]).long(),
                              caches=tc, cache_pos=s + step)


def test_float_prompts_and_engine_refusal():
    """A float prompt reaches the layers as given (no embedding lookup),
    a model without ``embedding_inputs`` refuses one, and the paged
    engine refuses recurrent mixers with ``ValueError``, as the
    reference's does."""
    cfg = get_config("musicgen-large", reduced=True)
    params = init_params(cfg, device="cpu")
    x = _port_prompt(cfg)
    out = teng._generate_dense(params, cfg, x, steps=3, device="cpu")
    assert out.shape == (x.shape[0], 3) and out.dtype == torch.long
    qwen = get_config("qwen2-0.5b", reduced=True)
    with pytest.raises(ValueError, match="embedding_inputs"):
        teng._generate_dense(init_params(qwen, device="cpu"), qwen, x,
                             steps=2, device="cpu")
    for arch in ("jamba-v0.1-52b", "rwkv6-7b"):
        rcfg = get_config(arch, reduced=True)
        with pytest.raises(ValueError, match="attention mixers"):
            teng.ContinuousBatchingEngine(init_params(rcfg, device="cpu"),
                                          rcfg, device="cpu")
    # the dense loop's states: prefill + decode equals one longer forward
    # when the decode feeds the same tokens (teacher forcing), for a
    # recurrent model in f32
    rcfg = dataclasses.replace(get_config("jamba-v0.1-52b", reduced=True),
                               dtype="float32")
    rp = init_params(rcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, rcfg.vocab_size, (2, 9)))
    full, _, _ = teng.forward(rp, rcfg, toks)
    caches = teng.init_serve_caches(rcfg, 2, 9, device="cpu")
    last, caches = teng.build_prefill_step(rcfg)(rp, toks[:, :8], caches)
    step, _, _ = teng.forward(rp, rcfg, toks[:, 8:], caches=caches,
                              cache_pos=8)
    torch.testing.assert_close(last, full[:, 7], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(step[:, 0], full[:, 8], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_gemm_count(arch, monkeypatch):
    """chip_smoke.py holds every forward of phase 10 to
    ``gemms_per_forward`` fused GEMM calls: on the reduced config one
    forward with logits makes exactly that many (counted where K1 is
    called), and at the phase's full widths and depths the count is the
    one it requires."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from repro_torch.kernels import ops
    cfg = get_config(arch, reduced=True, qmode="w8a8")
    params = chip_smoke.build_layerwise(cfg, "w8a8", 0, device="cpu")
    calls = []
    inner = ops.gemm_i8_fused
    monkeypatch.setattr(ops, "gemm_i8_fused",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    teng.forward(params, cfg, _port_prompt(cfg))
    assert len(calls) == chip_smoke.gemms_per_forward(cfg)
    full = {"jamba-v0.1-52b": (chip_smoke.REC_LAYERS, 230),
            "rwkv6-7b": (32, 257), "pixtral-12b": (4, 29),
            "musicgen-large": (4, 29)}[arch]
    assert chip_smoke.gemms_per_forward(
        get_config(arch, n_layers=full[0])) == full[1]
