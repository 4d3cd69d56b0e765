"""X4: the products of the pairwise record test in three formulations.

Port of benchmarks/experiments/exp_dot_formulations.py to the card: from
B [16, 512], A [8, 16, 128] and E [16, 128] (the script's seeded normals,
:76-79), C[j] = B^T A_j -> C [8, 512, 128]; R = the minimum over the middle
axis of C[:, :128] -> [8, 128]; X[j] = E onehot_j -> [8, 16, 128], onehot_j
selecting for each column the first row of C[j, :128] that holds the
minimum (:37-43). All float32. C in three forms (FORMS):
  * fma: float32 multiply and add on the CUDA cores, k in order;
  * tf32: one TF32 product on the tensor cores (about 3 decimal digits);
  * 3xtf32: the split product a_lo b_hi + a_hi b_lo + a_hi b_hi, about
    float32 accuracy (precision=HIGHEST on the TPU).
The kernel is csrc/exp_dot_formulations.cu; `dot_reference` is the plain
version of each form: fma sums in the kernel's order (bit-equal), the
TF32 forms round the operands to TF32 as the kernel does and sum the exact
products in float64 (the tensor cores' summation order and rounding are
not specified), so they are held within TOL_REL of sum_k |B_kq A_jkr|.
`tie_inputs` puts some columns' minimum in two rows.
R and X are the min and first argmin of each form's own C, gathered from
E (equal to the one-hot product bit for bit); `self_check` holds a
result to that exactly, `script_errors` gives the script's three figures
(:85-98) against numpy's float32 einsum.

`main()` prints, per form, the best launch ms (the card's work alone)
beside torch.matmul(B.T, A)'s, and the script's figures, with the card's
name and power limit (the script times one call).

    python -m cpupathtrace_tpu_torch.experiments.dot_formulations
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..accel.kernel_traverse import check_tensor
from . import best_ms, card, need_cuda

K, Q, R_COLS, J = 16, 512, 128, 8
Q_MIN = 128  # rows of C reduced for R and X
FORMS = ("fma", "tf32", "3xtf32")
# The TF32 forms against their emulation: |kernel - plain| <= TOL_REL *
# sum_k |B_kq A_jkr| (products exact, summation order unspecified).
TOL_REL = 1e-5
REPS = 20


def script_inputs(seed: int = 0):
    """(B [16, 512], A [8, 16, 128], E [16, 128]) float32 normals from
    np.random.default_rng(seed) in the script's order (:76-79)."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(K, Q)).astype(np.float32)
    a = rng.normal(size=(J, K, R_COLS)).astype(np.float32)
    e = rng.normal(size=(K, R_COLS)).astype(np.float32)
    return b, a, e


# Tie columns of `tie_inputs`: column -> (depth k of its one product, the
# two rows holding its minimum, that minimum). In the kernel rows 40 / 100
# and 30 / 90 lie in different warps, rows 16 / 24 in one thread.
TIES = {5: (0, (40, 100), 0.0), 77: (1, (30, 90), -2.5), 110: (2, (16, 24), -1.0)}


def tie_inputs(seed: int = 0):
    """The script's inputs of `seed` with three tie columns (TIES): A_j's
    column is 1 at depth k and 0 elsewhere, so C's column is B's row k; that
    row is positive over rows 0..127 but for two equal minima. The zero tie
    comes from -0.0 in the first row and +0.0 in the second (the forms may
    leave either sign in C). Every value is exact in TF32, so each form's R
    is the minimum and `first` the first of the two rows."""
    b, a, e = script_inputs(seed)
    for col, (k, rows, value) in TIES.items():
        a[:, :, col] = 0.0
        a[:, k, col] = 1.0
        b[k, :Q_MIN] = 1.0 + (np.arange(Q_MIN) % 16) / 4.0
        b[k, rows[0]] = -0.0 if value == 0.0 else value
        b[k, rows[1]] = value
    return b, a, e


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def _split(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def extract(c, e):
    """(R [8, 128], X [8, 16, 128]) from C: the minimum of each column of
    C[:, :128] and column `first` of E, the first row holding it."""
    q = c[:, :Q_MIN]
    r = q.amin(1)
    first = (q == r[:, None]).to(torch.int32).argmax(1)
    return r, e[:, first].permute(1, 0, 2).contiguous()


def products(b, a, form: str):
    """C [8, 512, 128] of a form, as the kernel computes it (fma) or
    emulates it (the TF32 forms)."""
    if form == "fma":
        c = torch.zeros((J, Q, R_COLS), dtype=torch.float32, device=b.device)
        for k in range(K):
            c = c + b[k][None, :, None] * a[:, k][:, None, :]
        return c
    if form == "tf32":
        c = torch.matmul(tf32_round(b).t()[None].to(torch.float64), tf32_round(a).to(torch.float64))
    elif form == "3xtf32":
        bh, bl = (v.t()[None].to(torch.float64) for v in _split(b))
        ah, al = (v.to(torch.float64) for v in _split(a))
        c = torch.matmul(bl, ah) + torch.matmul(bh, al) + torch.matmul(bh, ah)
    else:
        raise ValueError(f"unknown form {form}")
    return c.to(torch.float32)


def magnitude(b, a):
    """sum_k |B_kq A_jkr| [8, 512, 128], float64: the scale of TOL_REL."""
    return torch.matmul(b.abs().t()[None].to(torch.float64), a.abs().to(torch.float64))


def dot_reference(form: str, b, a, e):
    """The plain version of a form: (C, R, X)."""
    dot_reference.calls += 1
    c = products(b, a, form)
    r, x = extract(c, e)
    return c, r, x


dot_reference.calls = 0


def _launch_fn():
    fn = _build.load("exp_dot_formulations").ptx_dot_formulations_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def dot_formulation(form: str, b, a, e):
    """(C [8, 512, 128], R [8, 128], X [8, 16, 128]) of a form: CPU tensors
    take the plain version, CUDA tensors launch
    csrc/exp_dot_formulations.cu."""
    dev = b.device
    if dev.type == "cpu":
        return dot_reference(form, b, a, e)
    if dev.type != "cuda":
        raise ValueError(f"dot_formulation: no kernel for device {dev}")
    if form not in FORMS:
        raise ValueError(f"unknown form {form}")
    check_tensor("B", b, dev, torch.float32, (K, Q))
    check_tensor("A", a, dev, torch.float32, (J, K, R_COLS))
    check_tensor("E", e, dev, torch.float32, (K, R_COLS))
    c = torch.empty((J, Q, R_COLS), dtype=torch.float32, device=dev)
    r = torch.empty((J, R_COLS), dtype=torch.float32, device=dev)
    x = torch.empty((J, K, R_COLS), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _launch_fn()(FORMS.index(form), b.data_ptr(), a.data_ptr(), e.data_ptr(),
                           c.data_ptr(), r.data_ptr(), x.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"dot_formulation launch failed: cudaError_t {err}")
    dot_formulation.launches[form] += 1
    return c, r, x


# Launches per form.
dot_formulation.launches = dict.fromkeys(FORMS, 0)


def self_check(c, r, x, e) -> bool:
    """R and X are exactly the min and the first-argmin column of E of the
    result's own C (a near tie may legitimately move the argmin between
    forms)."""
    r2, x2 = extract(c, e)
    return bool(torch.equal(r, r2) and torch.equal(x, x2))


def ties_hold(r, x, e) -> bool:
    """On `tie_inputs`: every matrix's R at each tie column is the minimum
    and X its first row's column of E."""
    return all(bool((r[:, col] == value).all() and (x[:, :, col] == e[:, rows[0]]).all())
               for col, (_, rows, value) in TIES.items())


def within_tolerance(c, c_plain, b, a) -> bool:
    """|C - C_plain| <= TOL_REL * sum_k |B_kq A_jkr| everywhere."""
    err = (c.to(torch.float64) - c_plain.to(torch.float64)).abs()
    return bool((err <= TOL_REL * magnitude(b, a)).all())


def script_errors(b, a, e, c, r, x) -> dict:
    """The script's figures (:85-98): the matmul's max error relative to
    max |C_ref|, the reduce's and the extraction's max absolute errors,
    against numpy's float32 einsum and its first argmin."""
    b, a, e = (np.asarray(v.cpu()) for v in (b, a, e))
    c, r, x = (np.asarray(v.cpu()) for v in (c, r, x))
    c_ref = np.einsum("fq,jfr->jqr", b, a)
    q = c_ref[:, :Q_MIN, :]
    r_ref = q.min(axis=1)
    oh = q == r_ref[:, None, :]
    iota = np.arange(Q_MIN)[None, :, None]
    first = np.where(oh, iota, Q_MIN).min(axis=1)
    oh = oh & (iota == first[:, None, :])
    x_ref = np.einsum("ft,jtr->jfr", e, oh.astype(np.float32))
    return dict(matmul_rel_err=float(np.abs(c - c_ref).max() / np.abs(c_ref).max()),
                reduce_err=float(np.abs(r - r_ref).max()),
                extract_err=float(np.abs(x - x_ref).max()))


def io_bytes() -> int:
    """Bytes a call must move: B, A, E read once; C, R, X written once."""
    return 4 * (K * Q + J * K * R_COLS + K * R_COLS + J * Q * R_COLS + J * R_COLS
                + J * K * R_COLS)


def dot_ops(form: str) -> tuple[int, str]:
    """(operations of C, their type): 2 * 16 per element of C; three TF32
    products for 3xtf32. The reduction and the gather move bytes only."""
    n = 2 * K * J * Q * R_COLS
    return (n, "fp32") if form == "fma" else ((3 if form == "3xtf32" else 1) * n, "tf32")


def sweep(reps: int = REPS):
    """Per form on the card, on the script's inputs: the best launch ms of
    the card's work (`ms`) and the script's error figures; and
    torch.matmul(B.T, A), C alone in full float32, timed alike
    (`library_ms`)."""
    need_cuda()
    b, a, e = (torch.from_numpy(v).cuda() for v in script_inputs())
    bt = b.t()
    library_ms = best_ms(lambda: torch.matmul(bt, a), reps)
    out = {}
    for form in FORMS:
        def call(form=form):
            return dot_formulation(form, b, a, e)

        out[form] = dict(ms=best_ms(call, reps), library_ms=library_ms,
                         **script_errors(b, a, e, *call()))
    return out


def main():
    name = card()
    for form, r in sweep().items():
        print(f"# {form:7s} {r['ms']:8.4f} ms on the card  torch.matmul {r['library_ms']:.4f}  "
              f"matmul rel err {r['matmul_rel_err']:.2e}  "
              f"reduce err {r['reduce_err']:.2e}  extract err {r['extract_err']:.2e}  ({name})",
              flush=True)


if __name__ == "__main__":
    main()
