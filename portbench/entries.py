"""The entry points a cell's traffic drives, and the comparison that decides
`correct`.

A traffic file names its entry: "render" (frames through
`cpupathtrace_tpu_torch.render`, each image returned to the host) or "grad"
(passes through `cpupathtrace_tpu_torch.diff.render.loss_and_grad`, each
loss and gradient copied to the host). Frame or pass i draws from a torch
seed made of the run's seed and i, so the same seed gives the same work.

A render traffic file gives `spp`, or `min_spp` and `max_spp` with
min_spp < max_spp for adaptive frames (the film's stopping rule between
stats batches), and `allow_bias` (the film's biased candidate selection,
default false); `min_spp` and `max_spp` default to `spp`.

After the window a sample drawn from the seed is compared with the plain
reference (reference/), which traces the same paths from the configuration
and the seeds alone, through the configuration module's own reference
camera and tracer where it gives them.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from .reference import film
from .reference.scene import material_rows

# A pixel's gap is relative to its reference value plus this radiance, so
# that near-black pixels are judged on an absolute scale (the box's mean
# pixel is about 0.03).
PIXEL_FLOOR = 1e-3


def step_seed(seed: int, i: int) -> int:
    """The torch seed of frame or pass i of a run with `seed` (63 bits)."""
    h = hashlib.blake2b(f"portbench/{int(seed)}/{int(i)}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def sample_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def pixel_gaps(prog, ref):
    """Per pixel the largest relative gap over RGB ([n, 3] float64 each)."""
    prog = torch.as_tensor(prog, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64).to(prog.device)
    gap = ((prog - ref).abs() / (ref.abs() + PIXEL_FLOOR)).amax(1)
    return torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))


def render_numbers(prog_frames, ref_frames) -> dict:
    """The compared numbers of frames of sampled pixels: the median and 90th
    percentile of the pixel gaps, and the relative gap of the pixels' mean."""
    gaps = torch.cat([pixel_gaps(p, r) for p, r in zip(prog_frames, ref_frames)])
    p_sum = sum(float(torch.as_tensor(p, dtype=torch.float64).sum()) for p in prog_frames)
    r_sum = sum(float(torch.as_tensor(r, dtype=torch.float64).sum()) for r in ref_frames)
    mean_gap = abs(p_sum - r_sum) / max(abs(r_sum), 1e-30)
    return {"pixel_gap_median": float(gaps.median()),
            "pixel_gap_p90": float(torch.quantile(gaps, 0.9)),
            "mean_gap": mean_gap if np.isfinite(mean_gap) else float("inf")}


def grad_numbers(prog, ref) -> dict:
    """(loss, {leaf: grad}) of a pass against the reference's: the loss's
    relative gap, and the worst leaf's gap ||g - g_ref|| over the larger of
    its reference norm and the median leaf's."""
    loss_p, g_p = prog
    loss_r, g_r = ref
    norms = [float(torch.as_tensor(g).norm()) for g in g_r.values()]
    floor = float(np.median(norms))
    worst = 0.0
    for (k, gr), n in zip(g_r.items(), norms):
        diff = float((torch.as_tensor(g_p[k], dtype=torch.float64).to(gr.device) - gr).norm())
        worst = max(worst, diff / max(n, floor, 1e-30) if np.isfinite(diff) else float("inf"))
    loss_gap = abs(loss_p - loss_r) / max(abs(loss_r), 1e-30)
    return {"loss_gap": loss_gap if np.isfinite(loss_gap) else float("inf"), "grad_gap": worst}


class Entry:
    """What a run drives: set-up, one step of the window, the check."""

    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.cfg = cell.config
        self.tr = cell.traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.width, self.height = self.tr["width"], self.tr["height"]
        self.spp = self.tr.get("spp")
        self.min_spp = self.tr.get("min_spp", self.spp)
        self.max_spp = self.tr.get("max_spp", self.spp)
        self.allow_bias = bool(self.tr.get("allow_bias", False))
        if self.min_spp is None or self.max_spp is None or self.min_spp > self.max_spp:
            raise ValueError(f"traffic needs spp, or min_spp <= max_spp: {self.tr}")
        self.max_depth = self.tr.get("max_depth", self.cfg["max_depth"])
        self.outputs: list = []
        self.ref_entering: list[int] = []
        self._ref = None

    def setup(self):
        import cpupathtrace_tpu_torch as pt

        self.pt = pt
        self.scene, self.camera = self.cell.module.program_scene(self.cfg, self.device,
                                                                 str(self.cell.cache_dir))
        self.options = pt.RenderOptions(self.width, self.height, self.min_spp, self.max_spp,
                                        epsilon=self.cfg["epsilon"], allow_bias=self.allow_bias,
                                        max_depth=self.max_depth)

    def release(self):
        """Drop the program's scene: the reference runs after it."""
        self.scene = self.camera = None

    def reference(self, dtype=torch.float32):
        """The reference's scene (built once) and its tracer in `dtype`: the
        configuration module's `reference_tracer(cfg, scene, dtype)` where
        it has one, else the frozen triangle tracer."""
        if self._ref is None:
            self._ref = self.cell.module.reference_scene(self.cfg, self.device)
        own = getattr(self.cell.module, "reference_tracer", None)
        if own is not None:
            return self._ref, own(self.cfg, self._ref, dtype)
        return self._ref, film.triangle_tracer(self._ref, dtype)

    def reference_camera(self):
        """The configuration module's `reference_camera(cfg)` where it has
        one, else the frozen pinhole of the configuration's "camera"."""
        own = getattr(self.cell.module, "reference_camera", None)
        return own(self.cfg) if own is not None else film.Pinhole(self.cfg["camera"])


class RenderEntry(Entry):
    @property
    def adaptive(self) -> bool:
        """Does the film's stopping rule or candidate selection act?"""
        return self.min_spp < self.max_spp or self.allow_bias

    def work(self) -> int:
        """Rays of one frame (width x height x spp); for an adaptive frame
        width x height x min_spp, a constant of the traffic, whatever the
        film launched."""
        return self.width * self.height * self.min_spp

    def warm(self):
        self.pt.render(self.scene, self.camera, self.options, seed=step_seed(self.seed, -1))

    def step(self, i: int):
        self.outputs.append(self.pt.render(self.scene, self.camera, self.options,
                                           seed=step_seed(self.seed, i)))

    def sample(self):
        """(frames, pixels) to compare, drawn from the seed."""
        rng = sample_rng(self.seed, 2)
        n_pix = self.width * self.height
        frames = rng.choice(len(self.outputs), min(self.tr["check_frames"], len(self.outputs)),
                            replace=False)
        pixels = np.sort(rng.choice(n_pix, min(self.tr["check_pixels"], n_pix), replace=False))
        return [int(f) for f in frames], pixels

    def reference_frames(self, frames, pixels, dtype=torch.float32):
        _, tracer = self.reference(dtype)
        camera = self.reference_camera()
        pixel_major = self.cfg["stream"]["pixel_major_on_card"] and self.device.type == "cuda"
        rest = (pixels, self.cfg["stream"]["seed_layout"], pixel_major, self.max_depth,
                self.cfg["epsilon"], self.device)
        out = []
        for f in frames:
            if self.adaptive:
                val, ent = film.render_pixels_adaptive(
                    tracer, camera, self.width, self.height, self.min_spp, self.max_spp,
                    self.allow_bias, step_seed(self.seed, f), *rest)
            else:
                val, ent = film.render_pixels(tracer, camera, self.width, self.height,
                                              self.max_spp, step_seed(self.seed, f), *rest)
            out.append(val)
            self.ref_entering = film.add_counts(self.ref_entering, ent)
        return out

    def check(self) -> dict:
        frames, pixels = self.sample()
        if not frames:
            return {"pixel_gap_median": float("inf")}
        prog = [self.outputs[f].reshape(-1, 4)[pixels, :3].astype(np.float64) for f in frames]
        return render_numbers(prog, self.reference_frames(frames, pixels))

    def launch_plan(self, i: int):
        """Samples per launch of frame i. An adaptive frame's launches are
        those the program made: frame i is rendered once more and the
        film's counter of stats batches read around it."""
        if not self.adaptive:
            return film.launch_plan(self.max_spp, self.width, self.height)
        from cpupathtrace_tpu_torch.utils.profiling import counters

        before = counters()["film.stats_batches"]
        self.pt.render(self.scene, self.camera, self.options, seed=step_seed(self.seed, i))
        batches = counters()["film.stats_batches"] - before
        plan, c0 = [], 0
        for samples, kb in film.adaptive_plan(self.min_spp, self.max_spp, self.width,
                                              self.height):
            if kb and c0 >= batches:
                continue
            plan.append(samples)
            c0 += kb
        return plan

    def launch_rays(self, i: int):
        """The rays and path seed of each launch of frame i, as `render`
        makes them (for the counters of the metric readers)."""
        from cpupathtrace_tpu_torch.integrator import film as pfilm

        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(self.seed, i))
        x, y = film.pixel_coords(self.width, self.height)
        x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        perm = None
        if pfilm.use_pixel_order(self.scene, dev):
            perm = torch.as_tensor(film.morton_perm(self.width, self.height), device=dev)
        out = []
        for s in self.launch_plan(i):
            xs = x[perm].repeat_interleave(s) if perm is not None else x.repeat(s)
            ys = y[perm].repeat_interleave(s) if perm is not None else y.repeat(s)
            rays = self.pt.shoot_rays(self.camera, xs, ys, 1.0 / self.width, 1.0 / self.height,
                                      gen)
            seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device=dev, dtype=torch.int32)
            out.append((rays, seed))
        return out


class GradEntry(Entry):
    def setup(self):
        super().setup()
        rng = sample_rng(self.seed, 1)
        rows = material_rows(self.cfg["materials"])
        pert = self.tr["perturb"]
        self.params = {}
        for key, field in (("diffuse", "mat_diffuse"), ("specular", "mat_specular"),
                           ("emission", "mat_emission")):
            table = rows[key].astype(np.float32)
            lo, hi = pert.get(key, [1.0, 1.0])
            table[:, :3] *= rng.uniform(lo, hi, table[:, :3].shape).astype(np.float32)
            self.params[field] = table
        n_pix = self.width * self.height
        self.target = rng.uniform(0.0, self.tr["target_max"], (n_pix, 4)).astype(np.float32)
        self.params_dev = {k: torch.as_tensor(v, device=self.device)
                           for k, v in self.params.items()}
        self.target_dev = torch.as_tensor(self.target, device=self.device)

    def work(self) -> int:
        return 1

    def _pass(self, i: int):
        from cpupathtrace_tpu_torch.diff.render import loss_and_grad

        loss, grads = loss_and_grad(self.params_dev, self.scene, self.camera, self.options,
                                    self.target_dev, step_seed(self.seed, i), self.spp)
        return float(loss), {k: g.cpu().numpy() for k, g in grads.items()}

    def warm(self):
        self._pass(-1)

    def step(self, i: int):
        self.outputs.append(self._pass(i))

    def sample(self):
        rng = sample_rng(self.seed, 2)
        return [int(f) for f in rng.choice(len(self.outputs),
                                           min(self.tr["check_steps"], len(self.outputs)),
                                           replace=False)]

    def reference_pass(self, i: int, dtype=torch.float32):
        ref, tracer = self.reference(dtype)
        loss, grads, ent = film.loss_and_grad(
            tracer, self.reference_camera(), self.width, self.height, self.spp,
            step_seed(self.seed, i), self.params, self.target, self.max_depth,
            self.cfg["epsilon"], self.device)
        self.ref_entering = ent
        self.ref_em_k = ref.em_k
        return loss, grads

    def check(self) -> dict:
        passes = self.sample()
        if not passes:
            return {"loss_gap": float("inf")}
        worst: dict = {}
        for i in passes:
            for k, v in grad_numbers(self.outputs[i], self.reference_pass(i)).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst


ENTRIES = {"render": RenderEntry, "grad": GradEntry}
