"""The port's MoE FFN (repro_torch/models/moe.py) against the reference's
(repro/models/moe.py), on a small config like tests/test_moe.py's
(8 experts, top-3, d 32, expert d_ff 48), with the reference's weights
carried across by ``from_jax_params``.

* ``_route``'s slots, recorded inside both ``moe_ffn`` calls, must be
  equal bit for bit, ties and capacity drops included: a zero router
  (every gate ties), a router with two equal columns, and capacity
  factor 0.25 (drops past the expert capacity).
* y and aux, in all six qmodes, f32 and bf16 activations. The integer
  GEMMs are exact against the jitted reference and the gathers move bits,
  so what remains are f32 reduction orders: the router matmul, the
  softmax and the k-way combine. f32: within 8 f32 ULPs of max |y| (seen:
  under 2); bf16: within one bf16 ULP of max |y| (seen: equal). aux:
  within 1e-6 relative (seen: 1.1e-7 in f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
import repro_torch.models.moe as tmoe  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from torch_parity import (assert_ulps, cuda_like, jax_to_numpy,  # noqa: E402
                          to_numpy)
from torch_parity import one_thread  # noqa: E402,F401 (autouse)
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)

QMODE_BITS = {"none": None, "w8a16": 8, "w4a16": 4, "w8a8": 8, "w4a8": 4,
              "w4a4": 4}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
Y_ULPS = {"float32": 8, "bfloat16": 1}
AUX_RTOL = 1e-6


def _cfgs(**kw):
    base = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=4, d_ff=64, vocab_size=256, moe_experts=8,
                moe_top_k=3, moe_d_ff=48, moe_capacity_factor=2.0)
    base.update(kw)
    return JaxModelConfig(**base), ModelConfig(**base)


def _params(jcfg, dtype, qmode, router=None):
    """(reference params, port params) in ``dtype`` for ``qmode``."""
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, DTYPES[dtype][0])
    if router is not None:
        jp = {**jp, "router": jnp.asarray(router)}
    bits = QMODE_BITS[qmode]
    if bits:
        jp = {**jp, "experts": {k: jmoe.quantize_expert_weight(v, bits)
                                for k, v in jp["experts"].items()}}
    return jp, from_jax_params(jax_to_numpy(jp), device="cpu")


def _x(dtype, shape=(2, 16, 32), seed=1):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                    DTYPES[dtype][0])
    return x, torch.from_numpy(to_numpy(x)).to(DTYPES[dtype][1])


def _run_both(monkeypatch, jcfg, cfg, params, x, qmode):
    """Both ``moe_ffn`` calls, with every ``_route`` result recorded →
    (jax y, jax aux, port y, port aux, jax routes, port routes)."""
    routes = {"jax": [], "torch": []}
    for key, mod in (("jax", jmoe), ("torch", tmoe)):
        inner = mod._route

        def rec(gates, k, cap, inner=inner, out=routes[key]):
            res = inner(gates, k, cap)
            out.append((gates, *res))
            return res
        monkeypatch.setattr(mod, "_route", rec)
    jy, jaux = jmoe.moe_ffn(params[0], jcfg, x[0], qmode=qmode)
    ty, taux = tmoe.moe_ffn(params[1], cfg, x[1], qmode=qmode)
    return jy, jaux, ty, taux, routes["jax"], routes["torch"]


def _check(dtype, jy, jaux, ty, taux, jroutes, troutes):
    assert len(jroutes) == len(troutes) == 1
    (jg, js, jw), (tg, ts, tw) = jroutes[0], troutes[0]
    np.testing.assert_array_equal(to_numpy(ts), to_numpy(js))
    assert ty.dtype == DTYPES[dtype][1] and ty.shape == tuple(jy.shape)
    want = to_numpy(jy)
    assert_ulps(to_numpy(ty), want, Y_ULPS[dtype], dtype,
                scale=np.abs(want).max())
    assert abs(float(taux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))
    return to_numpy(js), to_numpy(tg)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("qmode", list(QMODE_BITS))
def test_moe_ffn_matches_reference(monkeypatch, qmode, dtype):
    jcfg, cfg = _cfgs()
    out = _run_both(monkeypatch, jcfg, cfg, _params(jcfg, dtype, qmode),
                    _x(dtype), qmode)
    slots, _ = _check(dtype, *out)
    assert (slots < cfg.moe_experts * 24).all()      # cap 24: no drops


@pytest.mark.parametrize("case", ["zero router", "equal columns",
                                  "capacity factor 0.25"])
def test_route_ties_and_drops_bit_exact(monkeypatch, case):
    """Slots equal bit for bit where top-k meets ties (the lower expert
    index first, as ``jax.lax.top_k`` orders them) and where tokens
    overflow an expert's capacity (the sentinel slot E·cap)."""
    overrides = {"capacity factor 0.25": dict(moe_capacity_factor=0.25)}
    jcfg, cfg = _cfgs(**overrides.get(case, {}))
    router = None
    if case != "capacity factor 0.25":
        base = np.array(jmoe.init_moe(jax.random.PRNGKey(0), jcfg,
                                      jnp.float32)["router"])
        router = np.zeros_like(base) if case == "zero router" else base
        if case == "equal columns":
            router[:, 5] = router[:, 2]
    params = _params(jcfg, "bfloat16", "w8a8", router)
    slots, gates = _check("bfloat16", *_run_both(
        monkeypatch, jcfg, cfg, params, _x("bfloat16"), "w8a8"))
    e = cfg.moe_experts
    cap = tmoe.expert_capacity(32, cfg)
    if case == "equal columns":
        assert (gates[..., 5] == gates[..., 2]).all()
    if case == "zero router":
        assert (gates == gates.flat[0]).all()
        # every token picks experts 0, 1, 2 in order; tokens past cap drop
        assert (slots[0, :cap] == np.arange(cap)[:, None]
                + cap * np.arange(3)).all()
    if case != "equal columns":
        assert (slots == e * cap).any()                  # tokens dropped


def test_group_size_invariance(monkeypatch):
    """Many small routing groups (MOE_GROUP_SIZE 8 in both packages): the
    port still gives the reference's slots and y, and, drop-free, its own
    one-group y."""
    jcfg, cfg = _cfgs()
    params, x = _params(jcfg, "float32", "w8a8"), _x("float32")
    one_group = tmoe.moe_ffn(params[1], cfg, x[1], qmode="w8a8")[0]
    monkeypatch.setattr(jmoe, "MOE_GROUP_SIZE", 8)
    monkeypatch.setattr(tmoe, "MOE_GROUP_SIZE", 8)
    out = _run_both(monkeypatch, jcfg, cfg, params, x, "w8a8")
    slots, _ = _check("float32", *out)
    assert slots.shape[:2] == (4, 8)
    torch.testing.assert_close(out[2], one_group, rtol=1e-5, atol=1e-6)


def test_capacity_and_group_size_match_reference():
    cfgs = [(jax_get_config(n, reduced=r), get_config(n, reduced=r))
            for n in ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")
            for r in (False, True)] + [_cfgs(moe_capacity_factor=0.25)]
    for n in range(1, 4097):
        sg = tmoe.routing_group_size(n)
        assert sg == jmoe.routing_group_size(n)
        for jcfg, cfg in cfgs:
            assert tmoe.expert_capacity(sg, cfg) == \
                jmoe.expert_capacity(sg, jcfg)
    assert (tmoe.MOE_MIN_CAPACITY, tmoe.MOE_GROUP_SIZE) == \
        (jmoe.MOE_MIN_CAPACITY, jmoe.MOE_GROUP_SIZE)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_expert_weight_bit_exact(bits, dtype):
    """Payload and scales equal to the reference's; the reference's
    quantized stack carried across by ``from_jax_params`` dequantizes to
    the reference's ``_dequant_expert``."""
    w = jnp.asarray(np.random.default_rng(bits).standard_normal(
        (5, 64, 24)) * 0.1, DTYPES[dtype][0])
    w = w.at[1, :, 3].set(0.0)                             # a zero column
    want = jmoe.quantize_expert_weight(w, bits)
    got = tmoe.quantize_expert_weight(
        torch.from_numpy(to_numpy(w)).to(DTYPES[dtype][1]), bits)
    assert got.shape == tuple(want.shape) == (5, 64, 24)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    carried = from_jax_params({"w": jax_to_numpy(want)}, device="cpu")["w"]
    assert isinstance(carried, QuantizedTensor) and carried.bits == bits
    np.testing.assert_array_equal(
        tmoe._dequant_expert(carried).numpy(),
        np.asarray(jmoe._dequant_expert(want)))


def test_quantized_tensor_shapes():
    q8 = torch.zeros(3, 8, 5, dtype=torch.int8)
    QuantizedTensor(q=q8, scale=torch.ones(3, 1, 5), bits=8, shape=(3, 8, 5))
    QuantizedTensor(q=q8[:, :4], scale=torch.ones(3, 1, 5), bits=4,
                    shape=(3, 8, 5))
    for q, shape in ((q8, (2, 8, 5)), (q8, (3, 8, 5, 1)), (q8[0], (3, 8, 5))):
        with pytest.raises(ValueError):
            QuantizedTensor(q=q, scale=torch.ones(3, 1, 5), bits=8,
                            shape=shape)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
                                  "rwkv6-7b", "pixtral-12b", "musicgen-large"])
def test_supported_architectures(arch):
    """Every architecture builds, each layer with the mixer and FFN that
    ``cfg.mixer_of`` / ``cfg.ffn_of`` give it (recurrent mixers and
    embedding inputs are ported), the MoE router in f32."""
    cfg = get_config(arch, reduced=True)
    params = init_params(cfg, device="cpu")
    mixer_key = {"attn": "attn", "mamba": "mamba", "rwkv": "rwkv_tm"}
    ffn_key = {"dense": "mlp", "moe": "moe", "rwkv_cmix": "rwkv_cm"}
    kinds = [sorted(set(lp) - {"ln1", "ln2"}) for lp in params["layers"]]
    assert kinds == [sorted({mixer_key[cfg.mixer_of(i)],
                             ffn_key[cfg.ffn_of(i)]})
                     for i in range(cfg.n_layers)]
    for i, lp in enumerate(params["layers"]):
        if cfg.ffn_of(i) == "moe":
            assert lp["moe"]["router"].dtype == torch.float32


def test_router_refuses_tf32(monkeypatch):
    """On the card the router must run in f32: TF32 would move gates and
    so routing. (CPU tensors never take TF32; the check reads the flag
    only for CUDA tensors, so the CPU path is held with a stand-in.)"""
    jcfg, cfg = _cfgs()
    tp = _params(jcfg, "float32", "none")[1]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = _x("float32")[1]
    tmoe.moe_ffn(tp, cfg, x)                       # CPU: unaffected
    with pytest.raises(RuntimeError, match="TF32"):
        tmoe.moe_ffn(tp, cfg, cuda_like(x))


def test_chip_smoke_layerwise_build_equals_init_params():
    """chip_smoke.py builds full-width moonshot one layer at a time (its
    bf16 experts would not fit beside their int8 copies); at the reduced
    width that build equals ``quantize_params(init_params(...))`` leaf for
    leaf, and its GEMM count a forward is the model's."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from repro_torch.models import quantize_params

    cfg = get_config("llama4-maverick-400b-a17b", reduced=True, qmode="w4a8")
    got = chip_smoke.build_layerwise(cfg, "w4a8", 3, device="cpu")
    want = quantize_params(init_params(
        cfg, generator=torch.Generator().manual_seed(3), device="cpu"),
        cfg, "w4a8")

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for key in sorted(tree)
                    for k, v in leaves(tree[key], f"{path}/{key}").items()}
        if isinstance(tree, list):
            return {k: v for i, x in enumerate(tree)
                    for k, v in leaves(x, f"{path}/{i}").items()}
        if isinstance(tree, QuantizedTensor):
            return {path + ".q": tree.q, path + ".scale": tree.scale}
        return {path: tree}
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert any(k.endswith("experts/w_down.q") for k in got)
    assert [chip_smoke.gemms_per_forward(get_config(a, **kw)) for a, kw in (
        ("moonshot-v1-16b-a3b", {}), ("moonshot-v1-16b-a3b", dict(n_layers=8)),
        ("llama4-maverick-400b-a17b", {}), ("qwen2-0.5b", {}))] == \
        [9409, 1569, 48 * 4 + 24 * 3 * 128 + 24 * 3 + 1, 168]
