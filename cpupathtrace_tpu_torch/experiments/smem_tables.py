"""X5: do constant tables cost per block?

Port of benchmarks/experiments/microbench_smemtables.py to the card: 256
blocks of 8 x 128 rays, each block staging 0 or 6 small constant tables
(the script's shapes, :50) and optionally a 128 x 128 table into shared
memory, as K1 stages its own (csrc/megakernel.cu), then writing
x + 1e-9 * (the sum of each table's [0, 0]). The kernel is
csrc/exp_smem_tables.cu; `smem_tables_reference` is the plain version.
`main()` prints the best of 5 launch times of the script's three
configurations and, the question put to this card's K1, the same kernel
with the box scene's real K1 tables (pack_tables) at K1's launch shape for
4,194,304 rays (16,384 blocks of 256 threads).

The timed inputs are the script's (x and every table all ones, so the
output is x whatever the kernel staged). The check inputs
(`check_configurations`) are seeded, so that 1e-9 times the tables' sum
survives the rounding, and the kernel also returns what each block staged
(`staged=True`), compared element by element.

    python -m cpupathtrace_tpu_torch.experiments.smem_tables
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..accel.kernel_traverse import check_tensor
from . import best_ms, card, need_cuda

ROWS, LANES, BLOCKS = 8, 128, 256
TABLE_SHAPES = ((14, 24), (1, 8), (4, 12), (1, 8), (2, 24), (1, 1))
VMEM_SHAPE = (128, 128)
K1_RAYS = 4194304
K1_THREADS = 256  # csrc/megakernel.cu kThreads
REPS = 5


def script_inputs(device):
    """x [8 * 256, 128] ones, the six tables and the 128 x 128 table (ones),
    as the TPU script makes them."""
    x = torch.ones((ROWS * BLOCKS, LANES), dtype=torch.float32, device=device)
    tables = [torch.ones(s, dtype=torch.float32, device=device) for s in TABLE_SHAPES]
    return x, tables, torch.ones(VMEM_SHAPE, dtype=torch.float32, device=device)


def configurations(device):
    """name -> (x, tables as (tensor, columns staged), threads per block)."""
    x, tables, vt = script_inputs(device)
    six = [(t, t.shape[1]) for t in tables]
    return {"no_tables": (x, [], LANES * ROWS), "six_tables": (x, six, LANES * ROWS),
            "six_tables_vmem": (x, six + [(vt, vt.shape[1])], LANES * ROWS)}


def check_configurations(device):
    """The configurations of `configurations` and K1's box tables with
    inputs from np.random.default_rng(2): x ~ 1e-6 N(0, 1) and the small
    tables uniform in [0.5, 1.5] (K1's box tables as they are)."""
    rng = np.random.default_rng(2)

    def seeded(t, scale, lo=0.0):
        v = rng.uniform(lo, lo + 1.0, t.shape) if lo else rng.normal(size=t.shape) * scale
        return torch.tensor(v, dtype=torch.float32, device=device)

    out = {}
    for name, (x, tables, threads) in configurations(device).items():
        out[name] = (seeded(x, 1e-6), [(seeded(t, 0.0, 0.5), c) for t, c in tables], threads)
    xk, tk, thk = k1_box_tables(device)
    out["k1_box_tables"] = (seeded(xk, 1e-6), tk, thk)
    return out


def k1_box_tables(device):
    """(x [4,194,304] ones, the tables K1 stages for the box) at K1's launch
    shape: the pair record (28 of its columns), spheres, materials, lights
    and emitters of pack_tables; tables without rows are left out."""
    from ..integrator.megakernel import pack_tables
    from ..models.scenes import bench_box_scene

    scene = bench_box_scene(device=device)
    _, sph, mat, lgt, em = pack_tables(scene)
    staged = [(scene.krn_big_pair, 28), (sph, sph.shape[1]), (mat, mat.shape[1]),
              (lgt, lgt.shape[1]), (em, em.shape[1])]
    x = torch.ones(K1_RAYS, dtype=torch.float32, device=device)
    return x, [(t.contiguous(), c) for t, c in staged if t.shape[0] > 0], K1_THREADS


def smem_tables_reference(x, tables, threads: int, staged: bool = False):
    """The plain version: x + 1e-9 * (sum of the tables' [0, 0], in order),
    or x + 0.0 without tables; with `staged`, also what each of the
    blocks of `threads` rays stages [blocks, floats]."""
    smem_tables_reference.calls += 1
    if not tables:
        out = x + 0.0
    else:
        acc = tables[0][0][0, 0]
        for t, _ in tables[1:]:
            acc = acc + t[0, 0]
        out = x + acc * 1e-9
    if not staged:
        return out
    flat = [t[:, :c].reshape(-1) for t, c in tables]
    row = torch.cat(flat) if flat else x.new_zeros(0)
    return out, row[None].expand(x.numel() // threads, -1)


smem_tables_reference.calls = 0


def _launch_fn():
    fn = _build.load("exp_smem_tables").ptx_smem_tables_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _c_array(ctype, vals):
    return (ctype * max(len(vals), 1))(*vals)


def smem_tables(x, tables, threads: int, staged: bool = False):
    """The kernel over x in blocks of `threads` rays, staging `tables` (a
    list of (tensor [rows, stride], columns staged)); with `staged`, also
    what each block staged [blocks, floats]. CPU tensors take the plain
    version."""
    dev = x.device
    if dev.type == "cpu":
        return smem_tables_reference(x, tables, threads, staged)
    if dev.type != "cuda":
        raise ValueError(f"smem_tables: no kernel for device {dev}")
    check_tensor("x", x, dev, torch.float32)
    n = x.numel()
    if n % threads or len(tables) > 8:
        raise ValueError(f"smem_tables: {n} rays in blocks of {threads}, {len(tables)} tables")
    for t, cols in tables:
        check_tensor("table", t, dev, torch.float32, (None, None))
        if not 0 < cols <= t.shape[1] or t.shape[0] == 0:
            raise ValueError(f"smem_tables: table {tuple(t.shape)} staging {cols} columns")
    ptrs = _c_array(ctypes.c_void_p, [t.data_ptr() for t, _ in tables])
    rows = _c_array(ctypes.c_int, [t.shape[0] for t, _ in tables])
    cols = _c_array(ctypes.c_int, [c for _, c in tables])
    strides = _c_array(ctypes.c_int, [t.shape[1] for t, _ in tables])
    o = torch.empty_like(x)
    st = (torch.empty((n // threads, table_bytes(tables) // 4), dtype=torch.float32, device=dev)
          if staged else None)
    with torch.cuda.device(dev):
        err = _launch_fn()(x.data_ptr(), o.data_ptr(), n // threads, threads, len(tables),
                           ptrs, rows, cols, strides, None if st is None else st.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"smem_tables launch failed: cudaError_t {err}")
    smem_tables.launches += 1
    return (o, st) if staged else o


smem_tables.launches = 0


def table_bytes(tables) -> int:
    return sum(t.shape[0] * c * 4 for t, c in tables)


def sweep(reps: int = REPS):
    """Best-of-`reps` launch ms of the script's three configurations and of
    the K1 box tables at K1's shape, with each call's bytes."""
    need_cuda()
    runs = dict(configurations("cuda"))
    runs["k1_box_tables"] = k1_box_tables("cuda")
    out = {}
    for name, (x, tables, threads) in runs.items():
        ms = best_ms(lambda x=x, tables=tables, threads=threads: smem_tables(x, tables, threads),
                     reps)
        out[name] = dict(ms=ms, blocks=x.numel() // threads, threads=threads,
                         tables=len(tables), bytes=x.numel() * 8 + table_bytes(tables))
    return out


def main():
    res = sweep()
    print(f"256 blocks: no tables {res['no_tables']['ms']:.4f} ms | 6 SMEM tables "
          f"{res['six_tables']['ms']:.4f} | +VMEM[128,128] {res['six_tables_vmem']['ms']:.4f}"
          f"  ({card()})", flush=True)
    k1 = res["k1_box_tables"]
    print(f"K1 box tables, {k1['blocks']} blocks of {k1['threads']}: {k1['ms']:.4f} ms "
          f"({k1['tables']} tables)  ({card()})", flush=True)


if __name__ == "__main__":
    main()
