"""Build the package's CUDA sources with nvcc on first use and load them
with ctypes.

Each `csrc/<name>.cu` becomes `_build/lib<name>_<digest>.so`, where the
digest covers every source under csrc/ and the flags, so an edited source
is rebuilt and a built one is reused. The library has a plain C interface
(no PyTorch headers), so a build takes seconds. `_build/` is git-ignored.

Flags: sm_90a (Hopper), -O3, and --fmad=false so no product is fused into
an add: the kernels then do the arithmetic of their plain-torch twins in
the same order. No fast-math: sinf/cosf/sqrtf stay full precision.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# Per library: seconds the nvcc build took (0.0 when an existing build was
# loaded) and the ptxas report (registers, shared memory, spills).
build_seconds: dict[str, float] = {}
ptxas_report: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out = BUILD_DIR / f"lib{name}_{_digest()}.so"
    build_seconds[name] = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {name}:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        build_seconds[name] = time.perf_counter() - t0
        ptxas_report[name] = proc.stderr
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
