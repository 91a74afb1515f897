"""The port's ``serve`` command calls ``generate`` as the reference's does.

Both ``main`` functions run with the same arguments on the CPU, at the
reduced width, with ``generate`` replaced in each module by a stub that
records its keyword arguments and returns tokens of the right shape. The
KV page type each passes (``kv_dtype``, absent meaning the default: float
pages) must be the same, and so must the request's shape.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jax_serve  # noqa: E402
from repro_torch.launch import serve as torch_serve  # noqa: E402

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
