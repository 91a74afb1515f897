"""The port stands alone: it imports neither ``jax`` nor ``repro`` (nor do
``chip_smoke.py``, the port's examples under ``examples/torch/`` and the
tensor-parallel and sharded-training tests' rank modules); its
entry points need an explicit CPU request on a host without CUDA; and a
CPU tensor goes to a kernel's plain version without counting a launch."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]
for name in mods:
    importlib.import_module(name)
sys.path.insert(0, {root!r})
import chip_smoke
sys.path.insert(0, {tests!r})
import torch_tp_worker
import torch_fsdp_worker
import importlib.util, pathlib
for path in sorted(pathlib.Path({examples!r}).glob('*.py')):
    spec = importlib.util.spec_from_file_location('example_' + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    mods.append(spec.name)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'repro'
             or m.startswith('repro.'))
print(len(mods), bad)
"""


def test_port_and_chip_smoke_import_no_jax_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(
            root=str(ROOT), tests=str(ROOT / "tests"),
            examples=str(ROOT / "examples" / "torch"))],
        capture_output=True, text=True, env=env, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n_mods) >= 20
    assert bad == "[]", f"port imported {bad}"


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_params
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--steps", "1"])
    params = init_params(cfg, device="cpu")
    assert params["embedding"].device.type == "cpu"


def test_cpu_tensors_take_the_plain_versions():
    from repro_torch.core.quant import pack_int4
    from repro_torch.kernels import camp_gemm as k5
    from repro_torch.kernels import camp_gemm_fused as k1
    from repro_torch.kernels import camp_gemm_w4 as k6
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as k3
    from repro_torch.kernels import paged_prefill as k2
    from repro_torch.kernels import quantize as k7
    counters = ((k1, "launches"), (k1, "launches_w4a8"),
                (k1, "launches_w4a4"), (k5, "launches"), (k6, "launches_w4"),
                (k6, "launches_a4w4"), (k7, "launches"), (k2, "launches"),
                (k3, "launches"))
    before = [getattr(m, a) for m, a in counters]
    x = torch.randn(3, 64)
    w = torch.randint(-127, 128, (64, 8), dtype=torch.int8)
    w4 = pack_int4(torch.randint(-7, 8, (64, 8), dtype=torch.int8))
    s = torch.rand(1, 8)
    y = k1.camp_gemm_fused_w8a8(x, w, s)
    torch.testing.assert_close(y, k1.camp_gemm_fused_w8a8_ref(x, w, s),
                               rtol=0, atol=0)
    ops.gemm_i8_fused(x, w, s)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.gemm_i8_fused(x, w, s, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.gemm_i8_fused(x, w, s, impl="pallas")
    for fn, ref, b in ((k1.camp_gemm_fused_w4a8, k1.camp_gemm_fused_w4a8_ref,
                        w4),
                       (k1.camp_gemm_fused_w4a4, k1.camp_gemm_fused_w4a4_ref,
                        w4)):
        assert torch.equal(fn(x, b, s), ref(x, b, s))
    a_q, a_s = k7.quantize_rowwise_kernel(x)
    a4, a4_s = k7.quantize_rowwise_kernel(x, bits=4)
    a_p = pack_int4(a4.T).T.contiguous()
    assert torch.equal(k5.camp_gemm_i8(a_q, w, a_s, s),
                       k5.camp_gemm_i8_ref(a_q, w, a_s, s))
    assert torch.equal(k6.camp_gemm_w4(a_q, w4, a_s, s),
                       k6.camp_gemm_w4_ref(a_q, w4, a_s, s))
    assert torch.equal(k6.camp_gemm_a4w4(a_p, w4, a4_s, s),
                       k6.camp_gemm_a4w4_ref(a_p, w4, a4_s, s))
    for call in (lambda: ops.gemm_w4_fused(x, w4, s, impl="cuda"),
                 lambda: ops.gemm_i8(a_q, w, a_s, s, impl="cuda"),
                 lambda: ops.quantize_rowwise(x, impl="cuda")):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    pages = torch.randint(-127, 128, (4, 1, 8, 16), dtype=torch.int8)
    scales = torch.rand(4, 1, 8)
    k3.paged_attention_cuda(torch.randn(2, 1, 2, 16), pages, pages, scales,
                            scales, torch.tensor([[0, 1], [2, 3]],
                                                 dtype=torch.int32),
                            torch.tensor([3, 9], dtype=torch.int32))
    k2.paged_prefill_cuda(torch.randn(1, 5, 2, 16), pages, pages, scales,
                          scales, torch.tensor([1, 2], dtype=torch.int32),
                          q_start=4)
    assert [getattr(m, a) for m, a in counters] == before
