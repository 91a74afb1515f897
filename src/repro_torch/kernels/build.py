"""Build the CUDA C++ kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``csrc/build/<name>-<hash>.so`` (the directory is git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o csrc/build/<name>-<hash>.so csrc/<name>.cu

No ``--use_fast_math``: the kernels rely on IEEE division, ``rintf`` and
``expf``. The hash covers the source and every header in ``csrc/``, so an edited
kernel rebuilds and a stale library is never loaded. A library builds at
its first use; :func:`build_all` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("camp_gemm_fused", "camp_gemm", "quantize", "paged_prefill",
           "paged_attention", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one kernel; None when the library is up to date."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Compile every kernel library that is missing, all nvcc's at once."""
    names = list(names)
    started = {n: _start(n) for n in names}
    errors = []
    for n in names:
        try:
            _finish(n, started[n])
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the kernels' split
    plans size their grids by it)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count
