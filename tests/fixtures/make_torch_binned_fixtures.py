"""Regenerate tests/fixtures/torch_binned.npz: the JAX package's binned
wavefront kernels in interpret mode on the CPU, and its jnp wavefront on
binned and sweep scenes, on the inputs of tests/torch_util.py, which
tests/test_torch_binned_wavefront.py holds the port against without
paying the interpret-mode and while-loop compiles:

  * cand_<m>_<inside|outside>_round<k>_{rays,ids,ent}: K6 (`_cand_call`)
    on CAND_BLOCK rays, rounds 1 and 2, m in {1, 4};
  * isect_{rays,offs,t,prim}: K7 (`_isect_call`) on the pairs of the
    m = 4, inside, round-1 candidates, in the port's compact layout;
  * pipe_<case>_{t,p} and ref_<case>_{t,p}: `binned_intersect_tpu`
    (interpret) and `binned_intersect_ref` on BINNED_CASES;
  * trace_<case>_{spec,coll}: `trace` on TRACE_CASES; grad_<field>: the
    gradient of the mean radiance of the differentiable trace on the
    binned dragon without emitter NEE.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_binned_fixtures.py
"""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cpupathtrace_tpu.accel import pallas_traverse as jpt  # noqa: E402
from tests.torch_util import (  # noqa: E402
    BINNED_CASES,
    TRACE_CASES,
    binned_case_inputs,
    binned_dragon,
    jax_cand_inputs,
    jax_isect_pairs,
    jax_wavefront_trace,
)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_binned.npz")


def main():
    scene = binned_dragon("jax")
    out = {}
    for m in (1, 4):
        for inside in (False, True):
            name = f"cand_{m}_{'inside' if inside else 'outside'}"
            for rnd, (rows, ids, ent) in jax_cand_inputs(scene, inside, m).items():
                out.update({f"{name}_{rnd}_rays": rows, f"{name}_{rnd}_ids": ids,
                            f"{name}_{rnd}_ent": ent})
            print(name, flush=True)
    rows, ids, _ = jax_cand_inputs(scene, True, 4)["round1"]
    pairs, offs, t, p = jax_isect_pairs(scene, ids, rows, 4)
    out.update(isect_rays=pairs, isect_offs=offs, isect_t=t, isect_prim=p)
    print("isect", pairs.shape, int((p >= 0).sum()), flush=True)
    for case in BINNED_CASES:
        o, d, tm, lv, m, batch, any_hit = binned_case_inputs(case)
        o, d = jnp.asarray(o), jnp.asarray(d)
        tm = None if tm is None else jnp.asarray(tm)
        lv = None if lv is None else jnp.asarray(lv)
        t, p = jpt.binned_intersect_tpu(scene, o, d, t_max=tm, live=lv, any_hit=any_hit, m=m,
                                        batch=batch, interpret=True)
        tr, pr = jpt.binned_intersect_ref(scene, o, d, t_max=tm)
        out.update({f"pipe_{case}_t": np.asarray(t), f"pipe_{case}_p": np.asarray(p),
                    f"ref_{case}_t": np.asarray(tr), f"ref_{case}_p": np.asarray(pr)})
        print(case, int((np.asarray(p) >= 0).sum()), flush=True)
    for case in TRACE_CASES:
        spec, coll = jax_wavefront_trace(case)
        out.update({f"trace_{case}_spec": spec, f"trace_{case}_coll": coll})
        print(case, float(spec[:, :3].mean()), flush=True)
    for f, g in jax_wavefront_trace("binned_no_em", grads=True).items():
        out[f"grad_{f}"] = g
    np.savez_compressed(OUT, **out)


if __name__ == "__main__":
    main()
