"""The controls of the comparison that decides `correct`, with the sound
readings beside them.

    python3 -m portbench.control --workload <cell> --seeds a,b,c [--sound d,e,f]
        [--faults frozen_at_min,never_frozen]

Render cells: the reference computed in bfloat16 (the precision below the
configurations' float32) is put in the program's place: its pixels of the
frames and pixels a check would draw are compared with the float32
reference's, by the cell's own numbers; with --faults, the program's own
frames with each fault of faults.py planted, checked as a run checks them.
Gradient cells: the bfloat16 reference, and the program's pass with its
gradients rounded to bfloat16 (the vjp's output a precision lower), each
against the float32 reference. With --sound the program's own frames or
passes of further seeds are compared too, in the same process, for the
lower readings. Prints one JSON line per reading.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

from .entries import GradEntry, RenderEntry, grad_numbers, render_numbers
from .faults import planted
from .run import SCENE_CACHE, Cell

CONTROL_FRAMES = 100  # frame indices a control draws its frames from


def render_control(cell, seed: int, device) -> dict:
    e = RenderEntry(cell, seed, device)
    e.outputs = [None] * CONTROL_FRAMES
    frames, pixels = e.sample()
    ref = e.reference_frames(frames, pixels)
    low = e.reference_frames(frames, pixels, dtype=torch.bfloat16)
    return render_numbers([x.cpu() for x in low], ref)


def render_sound(cell, seed: int, device, steps: int = 2, fault: str | None = None) -> dict:
    """The program's first `steps` frames checked as a run checks them,
    with `fault` planted where one is named."""
    e = RenderEntry(cell, seed, device)
    e.setup()
    with planted(fault) if fault else contextlib.nullcontext():
        for i in range(steps):
            e.step(i)
    e.release()
    return e.check()


def grad_control_bf16(cell, seed: int, device) -> dict:
    e = GradEntry(cell, seed, device)
    e.setup()
    e.release()
    ref = e.reference_pass(0)
    loss, grads = e.reference_pass(0, dtype=torch.bfloat16)
    return grad_numbers((loss, {k: v.cpu().numpy() for k, v in grads.items()}), ref)


def grad_program(cell, seed: int, device, round_bf16: bool = False) -> dict:
    """The program's pass 0 against the reference; with `round_bf16` its
    gradients rounded to bfloat16 first."""
    e = GradEntry(cell, seed, device)
    e.setup()
    e.step(0)
    if round_bf16:
        loss, grads = e.outputs[0]
        e.outputs[0] = (loss, {k: torch.as_tensor(g).to(torch.bfloat16).float().numpy()
                               for k, g in grads.items()})
    e.release()
    return e.check()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sound", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    with open(Path.cwd() / "BENCHMARK.json") as f:
        cell = Cell(json.load(f), args.workload)
    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA device", file=sys.stderr)
        return 2
    cell.cache_dir = SCENE_CACHE
    dev = "cuda"
    render = cell.traffic["entry"] == "render"

    def say(seed, kind, nums):
        print(json.dumps({"seed": seed, "kind": kind, **nums}), flush=True)

    for s in (int(x) for x in args.seeds.split(",")):
        if render:
            say(s, "bf16", render_control(cell, s, dev))
            for fault in (x for x in args.faults.split(",") if x):
                say(s, fault, render_sound(cell, s, dev, fault=fault))
        else:
            say(s, "bf16", grad_control_bf16(cell, s, dev))
            say(s, "bf16_grad", grad_program(cell, s, dev, round_bf16=True))
    for s in (int(x) for x in args.sound.split(",") if x):
        say(s, "sound", render_sound(cell, s, dev) if render else grad_program(cell, s, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
