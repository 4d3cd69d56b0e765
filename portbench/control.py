"""The controls of the comparison that decides `correct`, with the sound
readings beside them.

    python3 -m portbench.control --workload <cell> --seeds a,b,c [--sound N]

Render cells: the reference computed in bfloat16 (the precision below the
configurations' float32) is put in the program's place: its pixels of the
frames and pixels a check would draw are compared with the float32
reference's, by the cell's own numbers. Gradient cells: the program with
TF32 switched on for its matrix products (the replay's) on the card, and the
bfloat16 reference, each against the float32 reference. With --sound N the
program's own frames or passes of N further seeds are compared too, in the
same process, for the lower readings. Prints one JSON line per reading.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from .entries import GradEntry, RenderEntry, grad_numbers, render_numbers, step_seed
from .reference import film
from .run import SCENE_CACHE, Cell

CONTROL_FRAMES = 100  # frame indices a control draws its frames from


def render_control(cell, seed: int, device) -> dict:
    e = RenderEntry(cell, seed, device)
    e.outputs = [None] * CONTROL_FRAMES
    frames, pixels = e.sample()
    ref = e.reference_frames(frames, pixels)
    low = e.reference_frames(frames, pixels, dtype=torch.bfloat16)
    return render_numbers([x.cpu() for x in low], ref)


def render_sound(cell, seed: int, device, steps: int = 2) -> dict:
    e = RenderEntry(cell, seed, device)
    e.setup()
    for i in range(steps):
        e.step(i)
    e.release()
    return e.check()


def grad_control_bf16(cell, seed: int, device) -> dict:
    e = GradEntry(cell, seed, device)
    e.setup()
    e.release()
    ref = e.reference_pass(0)
    r, geo = e.reference(torch.bfloat16)
    loss, grads, _ = film.loss_and_grad(r, geo, e.cfg["camera"], e.width, e.height, e.spp,
                                        step_seed(e.seed, 0), e.params, e.target, e.max_depth,
                                        e.cfg["epsilon"], e.device, dtype=torch.bfloat16)
    return grad_numbers((loss, {k: v.cpu().numpy() for k, v in grads.items()}), ref)


def grad_program(cell, seed: int, device, tf32: bool) -> dict:
    """The program's pass 0 with TF32 on or off, against the reference."""
    e = GradEntry(cell, seed, device)
    e.setup()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        e.step(0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    e.release()
    return e.check()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sound", default="")
    args = ap.parse_args(argv)
    with open(Path.cwd() / "BENCHMARK.json") as f:
        cell = Cell(json.load(f), args.workload)
    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA device", file=sys.stderr)
        return 2
    cell.cache_dir = SCENE_CACHE
    dev = "cuda"
    render = cell.traffic["entry"] == "render"
    for s in (int(x) for x in args.seeds.split(",")):
        if render:
            print(json.dumps({"seed": s, "kind": "bf16", **render_control(cell, s, dev)}), flush=True)
        else:
            print(json.dumps({"seed": s, "kind": "tf32", **grad_program(cell, s, dev, True)}),
                  flush=True)
            print(json.dumps({"seed": s, "kind": "bf16", **grad_control_bf16(cell, s, dev)}),
                  flush=True)
    for s in (int(x) for x in args.sound.split(",") if x):
        nums = render_sound(cell, s, dev) if render else grad_program(cell, s, dev, False)
        print(json.dumps({"seed": s, "kind": "sound", **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
