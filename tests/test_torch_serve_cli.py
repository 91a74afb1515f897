"""The port's ``serve`` command calls ``generate`` as the reference's does.

Both ``main`` functions run with the same arguments on the CPU, at the
reduced width, with ``generate`` replaced in each module by a stub that
records its keyword arguments and returns tokens of the right shape. The
KV page type each passes (``kv_dtype``, absent meaning the default: float
pages) must be the same, and so must the request's shape.

With ``--spec-*`` flags both drive the engine themselves: the engine class
is stubbed the same way, and its ``kv_dtype``, ``capacity_tokens``, the
``SpecConfig`` fields and the draft config must be the same. Then the
port's command runs unstubbed with each spec method, with each MoE
architecture, and with jamba-v0.1-52b, rwkv6-7b and pixtral-12b (the CPU
smokes); for pixtral-12b and jamba both commands hand ``generate`` a
prompt of the same shape (float embeddings for pixtral).
"""
import re
import sys

import numpy as np

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jax_serve  # noqa: E402
from repro_torch.launch import serve as torch_serve  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401 (autouse)
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)

BATCH, PROMPT_LEN, STEPS = 2, 8, 3


def _recorder(calls, as_array):
    def generate(params, cfg, prompt, *, steps, **kw):
        calls.append(dict(kw, steps=steps, prompt_shape=tuple(prompt.shape)))
        return as_array(np.zeros((prompt.shape[0], steps), np.int32))
    return generate


@pytest.mark.parametrize("qmode", ["w8a8", "none"])
def test_serve_passes_the_reference_kv_dtype(monkeypatch, qmode):
    args = ["--arch", "qwen2-0.5b", "--reduced", "--qmode", qmode,
            "--batch", str(BATCH), "--prompt-len", str(PROMPT_LEN),
            "--steps", str(STEPS)]
    ref_calls, port_calls = [], []
    monkeypatch.setattr(jax_serve, "generate",
                        _recorder(ref_calls, lambda a: a))
    monkeypatch.setattr(torch_serve, "generate",
                        _recorder(port_calls, torch.from_numpy))
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    assert jax_serve.main() == 0
    assert torch_serve.main(args + ["--device", "cpu"]) == 0
    assert len(ref_calls) == len(port_calls) == 1
    ref, port = ref_calls[0], port_calls[0]
    assert port.get("kv_dtype") == ref.get("kv_dtype")
    assert port["prompt_shape"] == ref["prompt_shape"] == (BATCH, PROMPT_LEN)
    assert port["steps"] == ref["steps"] == STEPS
    assert port["sample"] == ref["sample"]


class _StubEngine:
    """Answers ``submit``/``run``/``spec_summary`` with tokens of the right
    count."""

    def __init__(self):
        self.steps = []

    def submit(self, prompt, steps):
        self.steps.append(steps)
        return len(self.steps) - 1

    def run(self):
        return {i: [0] * n for i, n in enumerate(self.steps)}

    def spec_summary(self):
        return {"spec_steps": 0, "acceptance_rate": 0.0,
                "mean_tokens_per_step": 0.0, "gamma": 0}


def _engine_recorder(calls):
    """Stands in for ``ContinuousBatchingEngine``: records its keyword
    arguments."""
    def engine(params, cfg, **kw):
        calls.append(kw)
        return _StubEngine()
    return engine


SPEC_FLAGS = [["--spec-method", "ngram", "--spec-gamma", "4"],
              ["--spec-method", "draft", "--spec-gamma", "auto"]]


@pytest.mark.parametrize("flags", SPEC_FLAGS, ids=["ngram", "draft"])
def test_serve_spec_flags_match_reference(monkeypatch, flags):
    import repro.serving.engine as jax_engine
    from repro.serving.spec_decode import SpecConfig as JaxSpecConfig
    args = ["--arch", "qwen2-0.5b", "--reduced", "--qmode", "w8a8",
            "--batch", str(BATCH), "--prompt-len", str(PROMPT_LEN),
            "--steps", str(STEPS), *flags]
    ref_calls, port_calls = [], []
    monkeypatch.setattr(jax_engine, "ContinuousBatchingEngine",
                        _engine_recorder(ref_calls))
    monkeypatch.setattr(jax_serve, "warm_gemm_autotune",
                        lambda *a, **kw: None)       # a TPU-block warmup
    monkeypatch.setattr(torch_serve, "ContinuousBatchingEngine",
                        _engine_recorder(port_calls))
    for mod in (jax_serve, torch_serve):
        monkeypatch.setattr(mod, "generate", _recorder([], lambda a: a))
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    assert jax_serve.main() == 0
    assert torch_serve.main(args + ["--device", "cpu"]) == 0
    assert len(ref_calls) == len(port_calls) == 1
    ref, port = ref_calls[0], port_calls[0]
    assert port["kv_dtype"] == ref["kv_dtype"] == "int8"
    assert port["capacity_tokens"] == ref["capacity_tokens"]
    assert port["sample"] == ref["sample"]
    rs, ps = ref["spec"], port["spec"]
    assert isinstance(rs, JaxSpecConfig)
    for f in ("method", "gamma", "ngram_max", "ngram_min", "ngram_window",
              "draft_page_size", "draft_capacity_tokens"):
        assert getattr(ps, f) == getattr(rs, f), f
    if flags[1] == "draft":
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "max_seq_len", "qmode"):
            assert getattr(ps.draft_cfg, f) == getattr(rs.draft_cfg, f), f
        assert ps.draft_cfg.name.endswith("-smoke")      # reduced=True
        assert ps.draft_params is not None
    else:
        assert ps.draft_cfg is rs.draft_cfg is None


@pytest.mark.parametrize("flags", SPEC_FLAGS, ids=["ngram", "draft"])
def test_serve_spec_cpu_smoke(capsys, flags):
    assert torch_serve.main(["--arch", "qwen2-0.5b", "--reduced", "--device",
                             "cpu", "--qmode", "w8a8", "--batch", "2",
                             "--prompt-len", "20", "--steps", "6",
                             *flags]) == 0
    out = capsys.readouterr().out
    assert "[serve] spec: " in out and "verify steps" in out
    assert "generated (2, 6)" in out


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_serve_moe_cpu_smoke(capsys, arch):
    """The MoE architectures serve through the CLI at the reduced width,
    quantized experts included."""
    assert torch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--qmode", "w8a8", "--batch", "2",
                             "--prompt-len", "12", "--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "PTQ to w8a8" in out and "generated (2, 4)" in out


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-7b",
                                  "pixtral-12b"])
def test_serve_recurrent_and_frontend_cpu_smoke(capsys, arch):
    """The recurrent and float-embedding architectures serve through the
    CLI at the reduced width, on the dense-slab loop."""
    assert torch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--qmode", "w8a8", "--batch", "2",
                             "--prompt-len", "12", "--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "PTQ to w8a8" in out and "generated (2, 4)" in out


@pytest.mark.parametrize("arch", ["pixtral-12b", "jamba-v0.1-52b"])
def test_serve_prompt_matches_reference(monkeypatch, arch):
    """Both ``main`` functions hand ``generate`` a prompt of the same
    shape: a float (B, S, D) one for embedding inputs, as the reference's
    CLI builds it; and the layer-at-a-time build equals
    ``quantize_params(init_params(...))`` on the same generator."""
    from repro_torch.configs import get_config
    from repro_torch.models import (init_params, init_quantized_params,
                                    quantize_params)
    args = ["--arch", arch, "--reduced", "--qmode", "w8a8", "--batch",
            str(BATCH), "--prompt-len", str(PROMPT_LEN), "--steps",
            str(STEPS)]
    ref_calls, port_calls = [], []
    monkeypatch.setattr(jax_serve, "generate",
                        _recorder(ref_calls, lambda a: a))
    monkeypatch.setattr(torch_serve, "generate",
                        _recorder(port_calls, torch.from_numpy))
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    assert jax_serve.main() == 0
    assert torch_serve.main(args + ["--device", "cpu"]) == 0
    ref, port = ref_calls[0], port_calls[0]
    assert port["prompt_shape"] == ref["prompt_shape"]
    cfg = get_config(arch, reduced=True)
    assert len(port["prompt_shape"]) == (3 if cfg.embedding_inputs else 2)
    got = init_quantized_params(cfg, "w8a8", device="cpu",
                                generator=torch.Generator().manual_seed(1))
    want = quantize_params(init_params(
        cfg, device="cpu", generator=torch.Generator().manual_seed(1)),
        cfg, "w8a8")

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        if hasattr(tree, "q"):
            return [tree.q, tree.scale]
        return [tree]
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    assert len(leaves(got)) == len(leaves(want))


def _parser_of(main, argv, monkeypatch):
    """The ``argparse`` parser ``main`` builds, caught at ``parse_args``."""
    import argparse

    class Caught(Exception):
        pass
    seen = []

    def parse_args(self, args=None, namespace=None):
        seen.append(self)
        raise Caught
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(Caught):
        main() if not argv else main(argv)
    monkeypatch.undo()
    return {a.dest: a for a in seen[0]._actions}


@pytest.mark.parametrize("dest", ["tp", "tp_int8_reduce"])
def test_serve_tp_flags_match_reference(monkeypatch, dest):
    ref = _parser_of(jax_serve.main, [], monkeypatch)[dest]
    port = _parser_of(torch_serve.main, ["--reduced"], monkeypatch)[dest]
    assert port.option_strings == ref.option_strings
    for f in ("type", "default", "const", "nargs", "help"):
        assert getattr(port, f) == getattr(ref, f), f
    assert type(port) is type(ref)


def test_serve_tp_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_serve.main(["--reduced", "--steps", "1", "--tp", "2"])


def test_serve_tp_cpu_end_to_end(capfd):
    """``--tp 2 --device cpu``: two gloo ranks serve the reduced model end
    to end; rank 0 prints the mesh line and the tokens."""
    assert torch_serve.main(["--arch", "qwen2-0.5b", "--reduced", "--device",
                             "cpu", "--qmode", "w8a8", "--tp", "2",
                             "--tp-int8-reduce", "--batch", "2",
                             "--prompt-len", "16", "--steps", "4"]) == 0
    out = capfd.readouterr().out
    assert "[serve] mesh {'data': 1, 'model': 2}; kv-head sharding: " \
        "replicated" in out
    assert out.count("generated (2, 4)") == 1


@pytest.mark.parametrize("arch,flags", [
    ("moonshot-v1-16b-a3b", []),
    ("moonshot-v1-16b-a3b", ["--tp-int8-reduce"]),
    ("rwkv6-7b", [])], ids=["moonshot", "moonshot-int8-wire", "rwkv6"])
def test_serve_tp_every_family_cpu_end_to_end(capfd, arch, flags):
    """``--tp 2 --device cpu`` serves an MoE model with its experts split
    over the ranks, and a recurrent one on the dense slab, each rank on
    its shards (it prints their bytes beside the whole model's), printing
    the reference's mesh line."""
    assert torch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--qmode", "w8a8", "--tp", "2", *flags,
                             "--batch", "2", "--prompt-len", "16",
                             "--steps", "4"]) == 0
    out = capfd.readouterr().out
    assert "[serve] mesh {'data': 1, 'model': 2}; kv-head sharding: " in out
    assert out.count("generated (2, 4)") == 1
    slab = re.search(r"\[serve\] dense slab on shards: ([\d,]+) bytes a "
                     r"rank of ([\d,]+) whole", out)
    assert (slab is not None) == (arch == "rwkv6-7b")
    if slab:
        mine, whole = (int(g.replace(",", "")) for g in slab.groups())
        assert 0 < mine < whole
    assert "+ shard, a layer at a time" in out
