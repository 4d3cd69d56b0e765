"""The OBJ loader at the real asset's scale: the stand-in dragon at
`--tris` (default 7,200,000, the reference's xyzrgb_dragon.obj) written as
OBJ text and loaded through `load_mesh` (the C++ parser and mesh
pipeline), timed by step on the host. Prints one JSON line with the
machine's card and power limit beside the figures:

    python -m cpupathtrace_tpu_torch.experiments.obj_load [--tris N] [--dir D]

The text goes to a temporary file under `--dir` (default build/, removed
after the run).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from .. import native
from ..models import scenes
from ..scene import mesh


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tris", type=int, default=scenes.DRAGON_FULL_TRIS)
    p.add_argument("--dir", default="build")
    args = p.parse_args(argv)
    from . import card

    out = {"card": card(), "target_tris": args.tris}
    t0 = time.perf_counter()
    text = scenes.standin_dragon_obj(args.tris)
    out.update(text_mb=len(text) / 1e6, text_s=time.perf_counter() - t0)
    os.makedirs(args.dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=args.dir) as tmp:
        path = os.path.join(tmp, "dragon.obj")
        t0 = time.perf_counter()
        with open(path, "w") as f:
            f.write(text)
        out["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        verts, faces = native.parse_obj_native(text)
        out.update(parse_s=time.perf_counter() - t0, verts=int(verts.shape[0]),
                   faces=int(faces.shape[0]))
        del text, verts, faces
        runs = dict(native.runs)
        t0 = time.perf_counter()
        tris = mesh.load_mesh(path, np.eye(4), cull_backface=False, smooth=True, as_batch=True)
        out.update(load_mesh_s=time.perf_counter() - t0, triangles=len(tris),
                   native_runs={k: native.runs[k] - runs[k] for k in runs})
    if out["native_runs"]["parse_obj"] != 1 or out["native_runs"]["mesh_pipeline"] != 1:
        raise RuntimeError(f"load_mesh did not take the C++ routes: {out}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
