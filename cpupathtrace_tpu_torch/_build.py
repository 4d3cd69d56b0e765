"""Build the package's native sources on first use and load them with
ctypes.

CUDA: each `csrc/<name>.cu` becomes `_build/lib<name>_<digest>.so` with
nvcc. Host C++: each `csrc/<name>.cpp` becomes the same with g++. The
digest covers every source under csrc/ and the flags, so an edited source
is rebuilt and a built one is reused. The libraries have a plain C
interface (no PyTorch headers), so a build takes seconds. `_build/` is
git-ignored. `build_all` starts one compiler per source at once.

nvcc flags: sm_90a (Hopper), -O3, and --fmad=false so no product is fused
into an add: the kernels then do the arithmetic of their plain-torch twins
in the same order. No fast-math: sinf/cosf/sqrtf stay full precision.
g++ flags: -O3 and -ffp-contract=off (no FMA contraction), as the JAX
package's native library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")

_LIBS: dict[str, ctypes.CDLL] = {}
# Per library: seconds the build took (0.0 when an existing build was
# loaded) and, for CUDA, the ptxas report (registers, shared memory, spills).
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


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host libraries (csrc/*.cpp) need a C++ compiler")
    return path


def _digest(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _job(name: str):
    """(output path, compiler command) of csrc/<name>.cu or .cpp."""
    if (CSRC / f"{name}.cu").exists():
        out = BUILD_DIR / f"lib{name}_{_digest(NVCC_FLAGS)}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, str(CSRC / f"{name}.cu")]
    elif (CSRC / f"{name}.cpp").exists():
        out = BUILD_DIR / f"lib{name}_{_digest(GXX_FLAGS)}.so"
        cmd = [_gxx(), *GXX_FLAGS, str(CSRC / f"{name}.cpp")]
    else:
        raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")
    return out, cmd


def build_all(names) -> None:
    """Build the named libraries that are not built yet, one compiler
    process per source, all started together; raises if any fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    running = []
    for name in names:
        out, cmd = _job(name)
        build_seconds[name] = 0.0
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(cmd + ["-o", str(tmp)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    errors = []
    for name, out, tmp, proc, t0 in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name} ({proc.returncode}):\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        build_seconds[name] = time.perf_counter() - t0
        ptxas_report[name] = stderr
    if errors:
        raise RuntimeError("build failed for " + "\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu or .cpp, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out, _ = _job(name)
    if not out.exists():
        build_all([name])
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The host (g++) library of csrc/<name>.cpp; raises if it is not C++."""
    if not (CSRC / f"{name}.cpp").exists():
        raise FileNotFoundError(f"no host source csrc/{name}.cpp")
    return load(name)


# A kernel entry in ptxas's report: its mangled name after _Z or _ZN.
PTXAS_ENTRY = re.compile(r"entry function '_ZN?(\w+)'")
PTXAS_PROPS = re.compile(r"Function properties for _ZN?(\w+)")


def instance_name(mangled):
    """`megakernel_binned<-1, 0>` from the mangled entry name (after _ZN):
    the last length-prefixed name of the nested name, then its template
    arguments."""
    i, names = 0, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        names.append(mangled[j:j + n])
        i = j + n
    args = []
    if mangled[i:i + 1] == "I":  # literal template arguments: L <type> <value> E
        i += 1
        while mangled[i:i + 1] == "L":
            j = mangled.index("E", i)
            args.append(mangled[i + 2:j])
            i = j + 1
    name = names[-1] if names else mangled
    return name + (f"<{', '.join(a.replace('n', '-') for a in args)}>" if args else "")


def ptxas_instances(text):
    """Per kernel instance of a library's ptxas report: its registers and
    spill stores (its own, not those of a function it calls, whose
    properties ptxas prints after the instance's)."""
    out, cur, entry, own = {}, None, None, False
    for ln in text.splitlines():
        m = PTXAS_ENTRY.search(ln)
        if m:
            entry = m.group(1)
            cur = out.setdefault(instance_name(entry), {})
            continue
        props = PTXAS_PROPS.search(ln)
        if props:
            own = props.group(1) == entry
            continue
        if cur is None:
            continue
        r = re.search(r"Used (\d+) registers", ln)
        if r:
            cur["registers"] = int(r.group(1))
        sp = re.search(r"(\d+) bytes spill stores", ln)
        if sp and own:
            cur["spill_stores"] = int(sp.group(1))
    return out


def ptxas_summary(text):
    """A library's ptxas report on one line: per kernel instance its name
    (`smem_tables_kernel<1>`), then its registers, shared memory and
    spills."""
    out = []
    for ln in text.splitlines():
        m = PTXAS_ENTRY.search(ln)
        if m:
            out.append(instance_name(m.group(1)))
        elif "Used" in ln or "spill" in ln:
            out.append(ln.replace("ptxas info    :", "").strip())
    return " | ".join(out)
