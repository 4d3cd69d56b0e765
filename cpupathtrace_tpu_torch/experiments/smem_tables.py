"""X5: do constant tables cost per block?

Port of benchmarks/experiments/microbench_smemtables.py to the card: 256
blocks of 8 x 128 rays, each block staging 0 or 6 small constant tables
(the script's shapes, :50) and optionally a 128 x 128 table into shared
memory, then writing x + 1e-9 * (the sum of each table's [0, 0]). The
kernel is csrc/exp_smem_tables.cu, in two staging instances (STAGINGS):
"rows", K1's own loop (csrc/megakernel.cu, csrc/bounce.cu); "bulk", the
default, Hopper's bulk asynchronous copies (and 16-byte cp.async for
strided rows) on one mbarrier with the first ray loads in flight
meanwhile. `smem_tables_reference` is the plain version.

The launch shape is an argument: the rays in tiles of `threads`, block b of
`blocks` taking tiles b, b + blocks, ... (`block_tiles`). The default, one
block per tile, is K1's shape; `resident_blocks` gives the persistent grid
(SMs x blocks per SM), in which each block stages once.

`main()` prints the best launch times of the script's three configurations
and, the question put to this card's K1, the box scene's real K1 tables
(pack_tables) for 4,194,304 rays: each staging at K1's launch shape
(16,384 blocks of 256 threads) and on the persistent grid, the launch
shape without tables, and torch.add(x, s).

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
STAGINGS = ("rows", "bulk")
REPS = 10


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
    and emitters of kernel_scene; tables without rows are left out."""
    from ..integrator.megakernel import kernel_scene
    from ..models.scenes import bench_box_scene

    scene = bench_box_scene(device=device)
    _, sph, mat, lgt, em = kernel_scene(scene).tables
    staged = [(scene.krn_big_pair, 28), (sph, sph.shape[1]), (mat, mat.shape[1]),
              (lgt, lgt.shape[1]), (em, em.shape[1])]
    x = torch.ones(K1_RAYS, dtype=torch.float32, device=device)
    return x, [(t.contiguous(), c) for t, c in staged if t.shape[0] > 0], K1_THREADS


def k1_blocks(n: int, threads: int) -> int:
    """K1's launch shape: one block per tile of `threads` rays."""
    return -(-n // threads)


def block_tiles(n: int, tile: int, blocks: int):
    """The kernel's walk: per block b, the tiles it covers (b, b + blocks,
    b + 2 blocks, ... below ceil(n / tile)), tile t holding rays
    t * tile .. min(n, (t + 1) * tile) - 1."""
    return [range(b, k1_blocks(n, tile), blocks) for b in range(blocks)]


def smem_tables_reference(x, tables, threads: int, staged: bool = False, blocks=None):
    """The plain version: x + 1e-9 * (sum of the tables' [0, 0], in order),
    or x + 0.0 without tables; with `staged`, also what each of the
    `blocks` launched blocks (K1's shape by default) stages [blocks, floats]."""
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
    return out, row[None].expand(blocks or k1_blocks(x.numel(), threads), -1)


smem_tables_reference.calls = 0


def _lib():
    lib = _build.load("exp_smem_tables")
    if lib.ptx_smem_tables_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ptx_smem_tables_launch.argtypes = [i, p, p, ctypes.c_longlong, i, i, i, p, p, p, p, p,
                                               p]
        lib.ptx_smem_tables_launch.restype = ctypes.c_int
        lib.ptx_smem_tables_resident.argtypes = [i, i, i, p, p, p, p, p]
        lib.ptx_smem_tables_resident.restype = ctypes.c_int
    return lib


def _c_array(ctype, vals):
    return (ctype * max(len(vals), 1))(*vals)


def _table_args(tables, dev):
    """The tables as the C entry points take them: pointers, rows, columns
    staged, row strides."""
    if len(tables) > 8:
        raise ValueError(f"smem_tables: {len(tables)} tables, at most 8")
    for t, cols in tables:
        check_tensor("table", t, dev, torch.float32, (None, None))
        if not 0 < cols <= t.shape[1] or t.shape[0] == 0:
            raise ValueError(f"smem_tables: table {tuple(t.shape)} staging {cols} columns")
    return (_c_array(ctypes.c_void_p, [t.data_ptr() for t, _ in tables]),
            _c_array(ctypes.c_int, [t.shape[0] for t, _ in tables]),
            _c_array(ctypes.c_int, [c for _, c in tables]),
            _c_array(ctypes.c_int, [t.shape[1] for t, _ in tables]))


def _check_shape(threads: int, staging: str):
    if staging not in STAGINGS:
        raise ValueError(f"unknown staging {staging!r}: one of {STAGINGS}")
    if not (32 <= threads <= 1024 and threads % 32 == 0):
        raise ValueError(f"smem_tables: {threads} threads, need a multiple of 32 up to 1024")


def resident_blocks(x, tables, threads: int, staging: str = "bulk") -> int:
    """The persistent grid on x's card: SMs x the blocks of this launch
    that fit on one SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"resident_blocks: no card for device {dev}")
    _check_shape(threads, staging)
    args = _table_args(tables, dev)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = _lib().ptx_smem_tables_resident(STAGINGS.index(staging), threads, len(tables),
                                              *args, ctypes.byref(per_sm))
    if err or per_sm.value < 1:
        raise RuntimeError(f"smem_tables occupancy failed: cudaError_t {err}, {per_sm.value}")
    return torch.cuda.get_device_properties(dev).multi_processor_count * per_sm.value


def smem_tables(x, tables, threads: int, staged: bool = False, blocks=None,
                staging: str = "bulk"):
    """The kernel over x in tiles of `threads` rays on `blocks` blocks (K1's
    shape, one block per tile, by default), staging `tables` (a list of
    (tensor [rows, stride], columns staged)) the `staging` way; with
    `staged`, also what each block staged [blocks, floats]. CPU tensors take
    the plain version."""
    dev = x.device
    _check_shape(threads, staging)
    if blocks is not None and blocks < 1:
        raise ValueError(f"smem_tables: {blocks} blocks")
    if dev.type == "cpu":
        return smem_tables_reference(x, tables, threads, staged, blocks)
    if dev.type != "cuda":
        raise ValueError(f"smem_tables: no kernel for device {dev}")
    check_tensor("x", x, dev, torch.float32)
    if x.data_ptr() % 16:
        raise ValueError("smem_tables: x must start on a 16-byte boundary (float4 access)")
    args = _table_args(tables, dev)
    n = x.numel()
    blocks = blocks or k1_blocks(n, threads)
    o = torch.empty_like(x)
    st = (torch.empty((blocks, table_bytes(tables) // 4), dtype=torch.float32, device=dev)
          if staged else None)
    with torch.cuda.device(dev):
        err = _lib().ptx_smem_tables_launch(
            STAGINGS.index(staging), x.data_ptr(), o.data_ptr(), n, blocks, threads, len(tables),
            *args, None if st is None else st.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"smem_tables launch failed: cudaError_t {err}")
    smem_tables.launches += 1
    return (o, st) if staged else o


smem_tables.launches = 0


def table_bytes(tables) -> int:
    return sum(t.shape[0] * c * 4 for t, c in tables)


def sweep(reps: int = REPS):
    """Best-of-`reps` launch ms of the script's three configurations (bulk
    staging, one block per tile) and of K1's box tables (each staging at
    K1's shape and on the persistent grid, K1's shape without tables,
    torch.add of the same shift), each with its grid and bytes."""
    need_cuda()
    runs = {name: (x, tables, threads, None, "bulk")
            for name, (x, tables, threads) in configurations("cuda").items()}
    xk, tk, thk = k1_box_tables("cuda")
    for staging in STAGINGS:
        runs[f"k1_{staging}"] = (xk, tk, thk, None, staging)
        runs[f"k1_{staging}_persistent"] = (xk, tk, thk, resident_blocks(xk, tk, thk, staging),
                                            staging)
    runs["k1_no_tables"] = (xk, [], thk, None, "bulk")
    sms = torch.cuda.get_device_properties(xk.device).multi_processor_count
    out = {}
    for name, (x, tables, threads, blocks, staging) in runs.items():
        ms = best_ms(lambda a=(x, tables, threads), b=blocks, s=staging:
                     smem_tables(*a, blocks=b, staging=s), reps)
        grid = blocks or k1_blocks(x.numel(), threads)
        out[name] = dict(ms=ms, blocks=grid, threads=threads, staging=staging,
                         blocks_per_sm=grid / sms, tables=len(tables),
                         bytes=x.numel() * 8 + table_bytes(tables))
    shift = smem_tables_reference(xk[:1], tk, thk) - xk[:1]
    out["torch_add"] = dict(ms=best_ms(lambda: torch.add(xk, shift), reps),
                            bytes=xk.numel() * 8)
    return out


def main():
    res = sweep()
    name = card()
    print(f"256 blocks: no tables {res['no_tables']['ms']:.4f} ms | 6 SMEM tables "
          f"{res['six_tables']['ms']:.4f} | +VMEM[128,128] {res['six_tables_vmem']['ms']:.4f}"
          f"  ({name})", flush=True)
    for key, r in res.items():
        if key.startswith("k1_"):
            print(f"K1 box tables, {key[3:]}: {r['ms']:.4f} ms on {r['blocks']} blocks of "
                  f"{r['threads']} ({r['tables']} tables, {r['staging']} staging)  ({name})",
                  flush=True)
    print(f"K1 box tables, torch.add(x, s): {res['torch_add']['ms']:.4f} ms  ({name})", flush=True)


if __name__ == "__main__":
    main()
