"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

The same numpy arrays go into the JAX reference and into the port. JAX
arrays become numpy here (bf16 as its uint16 bits), and the port's
``from_jax_params`` takes that framework-neutral tree.
"""
import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models, for the module that
    imports this fixture: the suite runs six workers at once, and torch's
    default of a thread a core oversubscribes the host (measured: the
    speculative tests ran about ten times slower that way)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def autotune_cache(tmp_path_factory):
    """Both packages' autotune caches in a fresh directory for the module
    that imports this fixture, and empty in memory before and after:
    engines that pick their own page size and chunk, and GEMM warmups,
    never read or write a cache in the home directory."""
    from repro.core import autotune as jax_autotune
    from repro_torch.core import autotune
    d = tmp_path_factory.mktemp("autotune")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(d / "torch.json"))
        mp.setenv("REPRO_AUTOTUNE_CACHE", str(d / "ref.json"))
        autotune.clear_cache()
        jax_autotune.clear_cache()
        yield d
    autotune.clear_cache()
    jax_autotune.clear_cache()


def jax_to_numpy(tree):
    """JAX params tree → numpy tree; QuantizedTensor → {q, scale, bits, shape}."""
    import jax.numpy as jnp
    from repro.core.quant import QuantizedTensor

    def leaf(x):
        a = np.asarray(x)
        if x.dtype == jnp.bfloat16:
            return a.view(np.uint16)
        return a

    def walk(x):
        if isinstance(x, QuantizedTensor):
            return {"q": leaf(x.q), "scale": leaf(x.scale), "bits": x.bits,
                    "shape": tuple(x.shape)}
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return leaf(x)

    return walk(tree)


def to_numpy(x):
    """A JAX or torch array as float32/int numpy (bf16 upcast exactly)."""
    import torch
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    a = np.array(x)                    # a writable copy, as torch wants
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def assert_ulps(got, want, max_ulps, dtype, scale=None):
    """|got - want| ≤ max_ulps ULPs of ``dtype`` ('float32' or 'bfloat16',
    bf16 values held in f32) at the magnitude max(|want|, |scale|)."""
    mag = np.abs(np.asarray(want, np.float32))
    if scale is not None:
        mag = np.maximum(mag, np.abs(np.asarray(scale, np.float32)))
    ulp = np.spacing(mag) * (2.0 ** 16 if dtype == "bfloat16" else 1.0)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    worst = (err / ulp).max(initial=0.0)
    assert worst <= max_ulps, f"{worst} ULPs"


def pre_activation_epilogue(epilogue):
    """The stages of ``epilogue`` before its first silu/gelu ('none' if it
    starts with one); None when it has no transcendental stage."""
    stages = epilogue.split("+")
    acts = [s in ("silu", "gelu") for s in stages]
    if not any(acts):
        return None
    return "+".join(stages[:acts.index(True)]) or "none"


def reduced_qwen_pair():
    """(jax cfg, jax params, port cfg, port params): the reduced qwen2-0.5b
    with the reference's weights, carried to the port on the CPU."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import init_params as jax_init_params
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_params
    jcfg = jax_get_config("qwen2-0.5b", reduced=True)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return (jcfg, jp, get_config("qwen2-0.5b", reduced=True),
            from_jax_params(jax_to_numpy(jp), device="cpu"))


def random_prompts(lengths, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def check_streams(got, want, jcfg, jp, prompts):
    """Identical greedy streams; on a divergence report the reference's
    top-2 logit gap at the first differing step."""
    import jax.numpy as jnp
    import pytest
    from repro.models import forward as jax_forward
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        step = next(t for t, (a, b) in enumerate(zip(g, w)) if a != b)
        ctx = np.concatenate([prompts[i], np.asarray(w[:step], np.int32)])
        logits, _, _ = jax_forward(jp, jcfg, jnp.asarray(ctx)[None])
        top2 = np.sort(to_numpy(logits)[0, -1])[-2:]
        pytest.fail(f"request {i} diverged at step {step}: reference top-2 "
                    f"gap {top2[1] - top2[0]:.5f}")


def assert_rel_close(got, want, rel, what=""):
    """max |got - want| ≤ rel · max |want| (same shapes)."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * np.abs(want).max(initial=0.0)
    err = np.abs(got.astype(np.float64) - want).max(initial=0.0)
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


def cuda_like(x):
    """``x`` as a CPU tensor that reports ``is_cuda``: the TF32 guards
    read the flag only for CUDA tensors."""
    import torch

    class CudaLike(torch.Tensor):
        @property
        def is_cuda(self):
            return True
    return torch.Tensor._make_subclass(CudaLike, x)
