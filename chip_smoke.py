"""Smoke run of the torch port (cpupathtrace_tpu_torch) on one CUDA card.

    python chip_smoke.py [--out DIR]

Phases, one line each; any failure exits non-zero:
  1. the card: torch's device name and nvidia-smi's name + power limit
  2. build the CUDA kernels from cpupathtrace_tpu_torch/csrc with nvcc,
     with ptxas's registers, shared memory and spills per kernel instance,
     and the resident blocks per SM of every instance of K1, K2 and K4 and
     of K7, K6 and K5 (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the
     walking ones at their rings alone, dense ones at the box's tables, K6
     on 512 clusters)
  3. kernel vs its plain-torch twin on the card, same rays and seed
  4. golden parity: the port's render_chunk at 32x32 against the C++
     reference images in tests/golden, with tests/test_parity.py's checks
  5. the main path at full size: render() of the renderSceneBox benchmark
     (128x128 @ 256 spp, max_depth 40), with the kernel's launch count,
     frame time in Mrays/s (w*h*spp / s), one frame traced with
     torch.profiler (device time by kernel, the device's busy share) and
     the kernel's time (whole calls, and `best_ms`) beside the twin's at
     that shape, bit-equal to the twin there and on a ragged count below
     one resident wave (NaN-filled output), with its refilling warps'
     occupancy and lane use (the counting instance's bounce steps) beside
     the lane use one path per thread would have had (from the twin's
     live counts per bounce)
  6. the demo scene without its dragon, 256x256 adaptive 16-64 spp, thin
     lens, post-processed, written as PNG and read back
  7. the binned build of renderSceneDragonBox (200k-triangle stand-in
     dragon), timed by stage (mesh, BVH and which builder ran, packing,
     upload), then the cluster query (K4) through its path (2 launches),
     and on 65,536 rays in the box and on the dragon frame's 262,144
     camera rays, nearest and any-hit: t, prim and the four counter
     columns equal to the plain version on every ray, whole calls and
     `best_ms`, the bound from the counters, lane use and distinct
     clusters per filled-row step from the counting instance's warp
     steps; ring depth, threads, registers and blocks per SM; a ragged
     count below one resident wave (17 past a multiple of 32) and the
     frame's rays with the first wave's inactive (whole claims ending at
     the root gate): no ray left NaN, equal to the plain version
  8. the bounce kernel (K2) against its twin: one bounce from the same
     state at depth 0 and 5 (all 18 planes), whole paths on 16,384 camera
     rays at max_depth 40, and the kernel's sorted and unsorted runs
  9. the binned main path at full size: render() of renderSceneDragonBox
     (128x128 @ 16 spp, max_depth 40) with K2's launch count, frame time
     and Mrays/s, K2 and sort+gather milliseconds per bounce on the frame's
     own sorted state and K2's sum over the frame (and the driver without
     the sort, for the host sync per bounce), the frame's bound from its
     counters, K2's ring depth, block size, registers, blocks per SM and
     lane utilisation from its warp steps, the frame through the twin's
     driver (time, spectra at the K1 bounds), one profiled frame, and, as
     a single-kernel reading, one bounce on a state the main path does not
     launch (depth 1 of the camera rays, unsorted) against the twin
 10. the demo scene with its 20k-triangle dragon (binned), as phase 6
 11. the dense query K5 against its plain version on 262,144 rays (the box
     frame's camera rays and one bounce's worth of random rays in the box):
     prim (int64), hit and t equal on every ray; K5's whole-call mean and
     its launch alone (`best_ms`), the plain version's ms, its instance
     (blocks per SM, threads, stage limit, ptxas); the same check and
     `best_ms` on the lean dragon frame's largest K5 input (one frame
     rendered with PTX_NO_MEGAKERNEL=1) and on random tables of 1,000
     triangles (staged) and past the stage limit (read through L1)
 12. the wavefront forward on the card (PTX_NO_MEGAKERNEL=1): golden parity
     at 32x32 with phase 4's checks, and the box at 128x128 @ 16 spp,
     max_depth 12 against K1's frame (mean within 4 standard errors), with
     K5's launch count > 0 and no plain calls
 13. K2's record form against its twin on the box (dense) and the 200k
     dragon (binned) at depths 0 and 5, a seeded third of the rays dead on
     entry at depth 5: the 18 planes and the record planes (NaN-filled
     before, so the kernel writes every column) equal on every ray, and
     the recording forward bit-equal to the plain
 14. renderSceneBoxGrad at full width (bench.py:253-260: 128x128 @ 16 spp,
     max_depth 12, zero target) through `loss_and_grad`: ms per pass
     (median of 3 batches of 5 after 2 warm passes), Mrays/s fwd+bwd, K2
     record launches, peak memory, one profiled pass; the same pass with
     PTX_DIFF_MEGAKERNEL=0 (the wavefront and K5); analytic vs finite
     difference gradients for both routes at 32x32 @ 8 spp, max_depth 4;
     K2's record form on one bounce of the pass's rays against its twin,
     timed as whole calls, as the launch alone (`best_ms`) and beside the
     two-kernel fill its wrapper no longer makes
 15. inverse_render: 10 Adam steps at 32x32 @ 8 spp on the card
 16. the binned wavefront's kernels against their plain versions on the
     200k dragon built with lean=False: the candidate scan K6 and the
     cluster-major intersect K7 on phase 7's 65,536 rays (round 1 and a
     round with a nonzero lower bound); K6 on every launch of one wavefront
     frame of the dragon (one line each: query, round, rays, pending rays,
     lanes a ray, `best_ms`, bound; ids equal and entries bit-equal) and the sums over
     the frame, on its largest input (the main path's shape, timed as the
     mean of 10 whole calls and as the best of 10 on the card alone) and
     on a synthetic table of 2,048 clusters at m = 1 and 4, with its lanes
     a ray, block, registers, spills and blocks per SM; K7 on the frame's
     largest input, timed the same way;
     K7 also on round 2's pairs, with where the dragon's padding rows sit
     (the rows up to each cluster's last filled group are tested), its
     lane use, registers and blocks per SM;
     the whole `binned_intersect` (nearest; any-hit with t_max and a live
     mask) against `binned_intersect_ref` on a chunk of rays and against
     the cluster query K4 on every ray; rounds per query and host reads
 17. K8's entry point (`binned_intersect_cluster_major`, its own kernel
     csrc/cluster_major.cu on the binned pairs) on the same rays: the
     compute stage against its plain version (t bit-equal, prim equal) on
     the stage's pairs and on planted ties at S = 1, 2, 4; one K8 launch a
     stage call and no K7; timed as whole calls, as the stage's card time
     and as the work list and launch on the binned pairs (`best_ms`, the
     span of the parent's K7-based figure); its host reads (torch's sync
     debug mode); S, grid, warps with work, lane use, blocks per SM and
     ptxas; its result against `binned_intersect`'s
 18. the binned wavefront at full width: render() of renderSceneDragonBox
     (128x128 @ 16 spp, max_depth 40) on the lean=False build with
     PTX_NO_MEGAKERNEL=1: frame time, K6 / K7 / K5 launches with no plain
     call, one profiled frame, the mean against the sorted driver's frame
     (within 4 standard errors); the scene rebuilt under PTX_KRN_MAX_TRIS
     below its small count (no kernel records) reaching the wavefront by
     the dispatch alone; the lean build through the wavefront (K4 + K5) at
     the same 128x128 @ 16 spp: frame time, launches, one profiled frame,
     its mean within 4 standard errors of the binned wavefront frame's;
     both profiles give the device time and launches of K4, K5, K6, K7 and
     the frame's kernel count
 19. gradients on the 200k dragon: loss_and_grad at 32x32 @ 8 spp,
     max_depth 4, through the wavefront (PTX_DIFF_MEGAKERNEL=0) and the
     record route, each against central differences
 20. K1's binned while-loop form against its twin on the first 16,384 of
     the dragon frame's camera rays: spectrum and collected bit-equal, the
     traversal counters (debug_visits) equal column by column; then the
     whole 262,144-ray chunk: no ray left unwritten (NaN), the kernel
     timed, counted and held against the twin, its ring depth, block size,
     registers, blocks per SM and lane utilisation from its warp steps;
     all of it again on the dragon rebuilt (lean) with PTX_KRN_CLUSTER=128,
     its K1 ms beside the ms at 56 rows
 21. the 200k dragon (128x128 @ 16 spp, max_depth 40) through render()
     with PTX_SORTED_WAVEFRONT=0 (K1's binned form) beside the default
     sorted driver, in turns: frame ms, Mrays/s, launches and host reads
     of each, the means within 4 standard errors, one profiled K1 frame;
     K2's bound over one counted sorted frame; the two walks side by side
     (K2's per-bounce and frame ms, K1's binned ms, each with its ring,
     block, registers, occupancy and lane utilisation)
 22. the box (128x128 @ 256 spp) through the sorted driver
     (PTX_SORTED_WAVEFRONT=1, K2's dense form): frame ms, its mean within 4
     standard errors of K1's frame
 23. the microbenchmarks X1-X5 (cpupathtrace_tpu_torch/experiments):
     each kernel against its plain version on check inputs whose output
     depends on the work (X1: flags that differ by block and every ray's
     least slab entry, equal, also where only one of a block's two CTAs
     has a ray that reaches a box, each block a cluster of 2 CTAs with all
     64 resident; X5: seeded x and tables and every launched
     block's staged copy, equal, in both staging instances at K1's
     launch shape and on the persistent grid; X3 on the script's inputs
     and on inputs whose row 0 starts 1e-5 in front of its triangles,
     each variant at its grid (blocks, chunks) within rtol 1e-6 serial /
     outer, 1e-5 matmul (the near row 0 of the matmul variants within a
     forward-error bound of the float64 plain version), its ray-record
     counts equal to the formula, also with more chunks than record
     tests, and the extraction moving at least 96 near row-0 rays and no
     other, by the plain versions' sum of corrections within 2 ulps;
     X2: tiles that take and skip the conditional updates, outputs
     and per-tile update counts equal in all four instances, each at its
     layout with all 64 tiles resident; X4 on seeds 0 and 1 and on tie inputs (the first of two
     rows holding a column's minimum): fma equal in C, R and X, the TF32
     forms within 1e-5 of sum |B A| of their emulation, R and X the min
     and first argmin of the kernel's own C), then each TPU script's
     sweep on the script's own
     inputs; X5 also K1's box tables with each staging at K1's shape and
     on the persistent grid (its blocks per SM),
     K1's shape without tables and torch.add; X4 each form beside
     torch.matmul; both beside the card's name and power limit
 24. renderSceneDragonBoxFull's scene (the 7.2M-triangle stand-in dragon,
     lean, PTX_KRN_MAX_TRIS 9e6 and PTX_KRN_CLUSTER 128 around the build:
     models/scenes.py:dragon_full_scene) through the scene cache in a fresh
     directory under build/: the cold miss (seconds by build stage, with
     the mesh pipeline and the pack in C++, csrc/mesh_native.cpp, beside
     the numpy route's stage seconds before it; save seconds, file GB), the hit with the file's pages dropped from the
     page cache and again cached (seconds, GB/s), every field of the
     loaded scene equal to the built one on the card (bits); the directory
     is removed at the end of phase 26
 25. its frames (128x128 @ 16 spp, max_depth 40) through render(): the
     default dispatch (the sorted driver, K2) and PTX_SORTED_WAVEFRONT=0
     (K1's binned form), each alone by its launch counts on a first
     frame, then three timed frames each in turns (frame seconds, Mrays/s,
     the ratio to the CPU reference's 0.217), the means within 4 standard
     errors, one profiled frame each; whether the tiers are staged or read
     from global memory; K2 and K1 against their twins on 16,384 of the
     frame's camera rays (spectrum bit-equal, counters equal), their card
     time on the frame's 262,144 rays by CUDA events (K2's launches, K1's
     launch), bounds from the counters, registers, occupancy and lane use
 26. render_resumable on that scene through the default tracer, 128x128 @
     16 spp in chunks of 4, a checkpoint after every chunk: stopped by its
     progress callback after chunk 2 and resumed (chunks 3 and 4 only, K2
     alone), bit-equal to the uninterrupted render; a camera moved by one
     ulp refused by the fingerprint; the fingerprint's seconds
 27. the C++ host pipeline against numpy at 7.2M: the mesh pipeline on the
     stand-in's arrays (six outputs bit-equal) and the packer on phase
     24's cluster arrays (the build's records bit-equal), each timed both
     ways
 28. the 200k dragon from OBJ text (written under build/, parsed by the
     C++ parser, `bench_dragon_scene(dragon_obj=path)`): text MB, seconds
     to write, parse and load; against phase 7's arrays-route build the
     same triangles, positions within 4 float32 ulps and normals within
     5e-4 (the parse reads float32); frames at 128x128 @ 16 spp through
     the default dispatch (K2) and PTX_SORTED_WAVEFRONT=0 (K1 binned),
     each alone by its launch counts, three timed frames each in turns
     (ms, Mrays/s, the ratio to the CPU reference's 0.308), each within 4
     standard errors of its tracer's arrays-route frame; K2 and K1 against
     their twins on 16,384 of the frame's rays as phase 25
 29. the demo app, `python -m cpupathtrace_tpu_torch.demo` at its defaults
     (256x256, 16-64 spp, the 20k dragon): rc 0, the PNG (256, 256, 4) and
     lit, its Mrays/s line
 30. the example, `python -m cpupathtrace_tpu_torch.examples.inverse_render`
     at its defaults: rc 0 (albedo error < 0.2), seconds, first and last
     loss, the recovered albedo
 31. the frame budget: each setting of the JAX package's ablation switches
     (base, PTX_ABLATE=nee, bigpair, prop, mat, and on binned scenes
     PTX_SKIP_TRAVERSE=1 alone and with nee; integrator/megakernel.py's
     attributes, set for the setting and restored after it, each setting
     inside trace_annotation("budget/<scene>/<tracer>/<setting>")) on the
     box through K1 dense (128x128 @ 256 spp), the 200k dragon and the
     7.2M dragon (read back from phase 24's cache) through K1 binned and the
     sorted driver (128x128 @ 16 spp): one line each with the kernel's time
     (K1's `best_ms` on the frame's rays, K2's launches of one frame by CUDA
     events), the median of TIMED_FRAMES frames through render(), the
     ray-bounces (counters, or the dense bounce steps), ns per ray-bounce
     and the frame mean (of its 1 + TIMED_FRAMES frames) with its standard
     error, which must move by more than 4 standard errors from base's
     (skip's is shown by its counters: the walks' columns zero, the
     nearest queries counted; nee's shadow columns zero); the ablation
     instances bit-equal to their twins (spectrum, collected, counters) on the box's first
     8,192 rays and 16,384 of the 200k dragon's; then each tracer's budget
     as shares of base's kernel time, raw and per ray-bounce (NEE = 1 -
     t(nee) / t(base), the nearest walk = (t(nee) - t(nee+skip)) /
     t(base), the floor = t(nee+skip) / t(base), the box's dense tests =
     1 - t(bigpair) / t(base)); diff_supported False and K2's record form
     refused under nee; the base 7.2M sorted frame through profile_to
     (with --out into DIR/trace_k2_7p2m): the file's size, the annotation
     and K2's kernel events in it
 32. the sharded paths (cpupathtrace_tpu_torch/parallel/), one rank: NCCL,
     a world of one on the card; render_sharded of the box (128x128 @ 256
     spp, max_depth 40) through K1, bit-equal to render_chunk with
     shard_seed(seed, 0, 0)'s generator, its frame ms and Mrays/s beside
     phase 5's render() frame, and beside render() in one interleaved
     loop with one frame of each profiled (wall, device busy, K1, the
     sharded frame's host pieces); render_resumable(mesh=) stopped after
     chunk 2 and resumed, bit-equal; the demo with --sharded by
     subprocess, its PNG read back
 33. two ranks sharing the card (spawned; gloo on CUDA tensors; labelled
     sharing, not scaling): the box at (dp, sp) = (2, 1) and (1, 2) and the
     200k dragon at (2, 1) through the sorted driver (K2), each bit-equal
     to the serial oracle (the same shards one after another in this
     process) and its mean within 4 standard errors of a render() frame,
     with each rank's frame wall ms and ms in collectives;
     train_step_sharded's loss and gradient on the box at (1, 2) (128x128
     @ 16 spp, max_depth 12, K2's record form) against the serial oracle's;
     the elastic failover (rank 1 loses its device after chunk 2, rank 0
     resumes alone: 5 chunk renders, 16 spp everywhere); with two or more
     cards, one NCCL rank a card on the box, and the failover's refusal of
     that NCCL mesh (else it says it did not run)
 34. geometry parallel, in the same two ranks: the lean 200k dragon split
     in two supercluster slices with their own tiers, 128x128 @ 16 spp
     through the wavefront (K4 + K5 on each shard, gp_combine between),
     bit-equal to the 1-rank gp render in this process; each shard's K4 on
     16,384 of the frame's camera rays equal to its plain version (t,
     prim, counters); the 7.2M dragon from phase 24's cache: each rank
     moves its half of the records and cluster bounds alone to the card
     (bytes, peak memory), and the combined query on 65,536 random rays is
     the unsharded K4 query bit for bit.
 35. the benchmark runner, `python -m cpupathtrace_tpu_torch.bench` at its
     defaults (every workload, the parity gate on) by subprocess, with
     PTX_SCENE_CACHE at phase 24's cache, after one of its box chunks
     (render_chunk, 128x128 @ 64 spp) is shown to make no host read (sync
     debug mode), so its frames overlap, and its box frame (4 chunks) and
     one of a single 256-spp chunk are timed in this process (the host's
     enqueue ms and the wall ms a frame, one frame profiled): rc 0;
     bench.py's four metric
     lines (renderSceneDragonBoxFull, renderSceneDragonBox,
     renderSceneBoxGrad, renderSceneBox last), each verified, without
     error, with a positive value, the three frame workloads with their
     rooflines; the lines, the runner's log and its seconds
With --parent, then every bound of phases 5-30 against the parent's.
Then the script's seconds (36), one JSON line with the kernels' figures
(the K2 and K1 binned rows also carry phase 25's 7.2M readings under
"dragon_full" and phase 28's under "obj_dragon"; the K1 and K2 rows the
budgets of phase 31 under "budget"; the K1, K2 and K2 record rows phases
32-33's under "sharded", the K4 and K5 rows phase 34's under "gp") and,
last, the result line. No
main-path profile may show an ablation kernel (`*_ablate`). Bounds of the traversal kernels (K1's binned form,
K2, K4) come from their counters: filled record rows tested x 64 + slab
tests below the root gate x 31 + per query the root test (31) + per
ray-bounce (the nearest queries) 300 and the dense part's tests x 64.
With --out, the demo PNGs and every measured figure are also written there
(chip_smoke.json). With --parent, a parent commit's chip_smoke.json from
the same machine, phase 2 holds the registers and spill stores of every
kernel instance that does not walk to the parent's (the walking ones,
WALK_INSTANCES, are listed beside the parent's, and those the main path
launches may not spill more or hold fewer blocks an SM), the end every bound of
phases 5-30 to the parent's, and phases 5, 7, 9, 11, 14, 16, 17, 18, 20,
21, 23 and 25 also print its K1 dense ms and box frame, its K4 ms, its K2
per-bounce times and sum, its K5 ms, its gradient pass and K2
record-form ms, its K6 and K7 ms, its K8 stage and launch ms, its frames'
kernel counts and K5 / K6 device time, its K1 binned ms, its walks' lane
use at a row and a slab step (200k and 7.2M), its 7.2M K1 binned and K2
ms, its X1 sweep and its X2 and X3 times. Phase 31's budget lines carry
the walks' ms in each binned tracer (t(base) - t(skip)) and their
counted bound.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The least time the card could take for a kernel's work (the larger of its
# bytes over HBM's rate and its operations over their peak) and the work
# model behind it: cpupathtrace_tpu_torch/utils/roofline.py.
from cpupathtrace_tpu_torch.utils.roofline import (
    SLAB_FLOPS,
    TEST_FLOPS,
    VERTEX_FLOPS,
    bound,
    frame_bound,
    ray_bounces,
    tests_per_vertex,
    traversal_flops,
    vertex_flops,
)

BOX_W = BOX_H = 128
BOX_SPP = 256
MAX_DEPTH = 40
TIMED_FRAMES = 3
# Kernel vs twin bounds: collected equal on every ray, the spectrum within
# (rtol, atol) on >= 99.9% of rays, the mean radiance within 1e-4. Both do
# the same IEEE float32 operations in the same order (the kernel is built
# with --fmad=false; sqrtf, rsqrtf, sinf, cosf are the functions torch's
# CUDA ops call), and on an H100 they measured bit-equal on every case.
COLL_FRAC, CLOSE_FRAC, RTOL, ATOL, MEAN_REL = 1.0, 0.999, 1e-5, 1e-7, 1e-4
# The binned path: the renderSceneDragonBox frame and the query/whole-path
# shapes of phases 7 and 8.
DRAGON_TRIS = 200000
DRAGON_W = DRAGON_H = 128
DRAGON_SPP = 16
QUERY_RAYS = 65536
PATH_RAYS = 16384
# K4 vs its plain version: t, prim and the counters equal on every ray. K2
# vs its twin: every state plane equal on >= PLANE_FRAC of the rays; whole
# paths at the K1 bounds above. Both kernels do their plain versions'
# float32 operations in the same order; on an H100 they measured equal on
# every ray.
PLANE_FRAC = 0.999
KERNELS = ("megakernel", "bounce", "cluster_query", "dense_query", "binned_cand",
           "binned_isect", "cluster_major", "bvh_build", "mesh_native", "exp_supscan",
           "exp_record_variants",
           "exp_smem_tables", "exp_cond_fat", "exp_dot_formulations")
# renderSceneBoxGrad (bench.py:253-260) and the FD / inverse-rendering
# checks on the card.
GRAD_W = GRAD_H = 128
GRAD_SPP = 16
GRAD_DEPTH = 12
K5_RAYS = 262144
# K5 reads a ray's origin and direction (24 bytes) and writes t and the
# int64 prim (12 bytes); its random table within the stage limit (96 KB).
K5_RAY_BYTES = 36
K5_BIG_ROWS = 1000
# The kernels whose device time and launches the profiled wavefront frames
# of phase 18 report: K4, K5, K6, K7.
FRAME_KERNELS = ("cluster_query_kernel", "dense_query", "binned_cand_kernel",
                 "binned_isect_kernel")
# The binned wavefront (phases 16-19): candidate slots per round, the
# share of rays on which the pipeline and the independent cluster query K4
# must give the same prim (they may differ only on exact-t ties between
# triangles), the rays of the oracle's chunk, and the work model of K6
# (csrc/binned_cand.cu): per scanned ray and cluster the slab test (12
# subtract / multiply, 10 min / max, the entry's compare and select, 7
# compares of the box, the best hit and the bound: 31 operations), and only
# for the clusters that pass it the insertion (per slot 3 compares and 4
# selects; 3 compares and 2 selects for the overflow row).
CAND_M = 4
K4_AGREE = 0.999
# X3's check and the record tests of its line in the kernels' JSON (the
# plain versions loop over records in Python).
X3_CHECK_RECORDS = 256
# X3 with more chunks than record tests (blocks with none).
X3_FEW_RECORDS = 5
X3_FEW_CHUNKS = 40
REF_RAYS = 8192
RAY_ROWS_BYTES = 36  # K6 reads 9 float planes per ray
# K1's binned form against its twin: the rays of the bit-equality and
# counter check (the twin's traversal is the slow part), and the record rows
# of the second build it runs on (bench.py's PTX_KRN_CLUSTER for 7.2M).
K1B_CHECK_RAYS = 16384
K1B_WIDE_CLUSTER = "128"
# renderSceneDragonBoxFull (phases 24-26): the CPU reference's rate on the
# 7.2M dragon (bench.py:39-41), and where the cold cache goes (build/ is
# git-ignored; the directory is removed at the end).
DRAGON_FULL_REF_MRAYS = 0.217
# The 7.2M cold build's numpy mesh and pack stages before they moved to
# C++ (two runs of phase 24 on an H100 host, PERF.md §5).
NUMPY_STAGES_S = {"mesh": [7.03, 8.85], "pack": [4.98, 5.94], "total": [17.1, 21.1]}
# The CPU reference's rate on the 200k dragon (bench.py:40), and the OBJ
# route's agreement with the arrays route (float32 parse, scene/mesh.py):
# positions in float32 ulps, normals absolute.
DRAGON_REF_MRAYS = 0.308
OBJ_POS_ULPS = 4
OBJ_NORMAL_ERR = 5e-4
ROOT = os.path.dirname(os.path.abspath(__file__))
# X2's check and the iterations of its line in the kernels' JSON (the
# sweep's longer run).
X2_ITERS = 1024
# Phase 31, the frame budget: the JAX package's ablation switches as the
# port reads them (integrator/megakernel.py `_ABLATE`, `_SKIP_TRAVERSE`),
# setting -> (the set, skip); the walk's settings run on binned scenes only.
# A setting takes a part of the bounce out, so 1 - t(setting) / t(base) is
# the share of the kernel's time that part took.
BUDGET_SETTINGS = {
    "base": (frozenset(), False),
    "nee": (frozenset({"nee"}), False),
    "bigpair": (frozenset({"bigpair"}), False),
    "prop": (frozenset({"prop"}), False),
    "mat": (frozenset({"mat"}), False),
    "skip": (frozenset(), True),
    "nee_skip": (frozenset({"nee"}), True),
}
WALK_SETTINGS = ("skip", "nee_skip")
# The rays each ablation instance is held bit for bit to its twin on: the
# box's first 8,192 (K1 dense), 16,384 of the 200k dragon's (K1 binned,
# K2); the 7.2M rows are timings only (the twins take ~10 s there).
BUDGET_BOX_CHECK_RAYS = 8192


def insert_flops(m):
    return 7 * m + 5


class SmokeFailure(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def line(phase, **fields):
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over `reps` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def compare(kernel_spec, twin_spec):
    k, t = kernel_spec.cpu().numpy(), twin_spec.cpu().numpy()
    coll = float((k[:, 3] == t[:, 3]).mean())
    close = float(np.isclose(k, t, rtol=RTOL, atol=ATOL).all(axis=1).mean())
    mk, mt = float(k[:, :3].mean()), float(t[:, :3].mean())
    mean_rel = abs(mk - mt) / max(abs(mt), 1e-12)
    return dict(collected_equal=coll, close=close, mean_rel=mean_rel,
                max_abs_err=float(np.abs(k - t).max()), mean=mk)


def check_agreement(name, res):
    need(res["collected_equal"] >= COLL_FRAC and res["close"] >= CLOSE_FRAC
         and res["mean_rel"] <= MEAN_REL, f"{name}: kernel disagrees with twin {res}")


def phase_kernel_vs_twin(mk, scenes, Rays, RenderOptions):
    from cpupathtrace_tpu_torch.models.golden import (
        sphere_point_light_scene,
        specular_box_scene,
    )

    rng = np.random.default_rng(0)
    n = 8192
    d = rng.normal(size=(n, 3))
    fwd = d.copy()
    fwd[:, 2] = np.abs(fwd[:, 2]) + 0.2
    dirs = {k: torch.tensor(v / np.linalg.norm(v, axis=1, keepdims=True),
                            dtype=torch.float32, device="cuda")
            for k, v in (("all", d), ("forward", fwd))}
    origin = torch.zeros((n, 3), device="cuda")
    cases = [
        ("box_d3", scenes.bench_box_scene(device="cuda"), "all", 3),
        ("box_d40", scenes.bench_box_scene(device="cuda"), "all", MAX_DEPTH),
        ("specular_point_light", specular_box_scene(point_light=True, device="cuda"),
         "all", MAX_DEPTH),
        ("sphere_table_form", sphere_point_light_scene(device="cuda"), "forward", MAX_DEPTH),
    ]
    results = {}
    for name, scene, kind, depth in cases:
        rays = Rays(origin, dirs[kind])
        opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=depth)
        k_spec, _ = mk.trace_megakernel(scene, rays, opts, 1234)
        sync()
        t_spec, _ = mk.trace_megakernel_reference(scene, rays, opts, 1234)
        res = compare(k_spec, t_spec)
        results[name] = res
        check_agreement(name, res)
    return results


def render_fixed(film, scene, camera, RenderOptions, size, spp, seed, chunk=64):
    """tests/test_parity.py:render_fixed through the port's render_chunk."""
    opts = RenderOptions(size, size, spp, spp, max_depth=MAX_DEPTH)
    xg, yg = np.meshgrid(np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32))
    x, y = film.pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    x = torch.tensor(x, device="cuda")
    y = torch.tensor(y, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tot = torch.zeros((size * size, 4), dtype=torch.float64, device="cuda")
    cnt = torch.zeros(size * size, dtype=torch.int64, device="cuda")
    for _ in range(spp // chunk):
        s, c = film.render_chunk(scene, camera, opts, x, y, gen, chunk)
        tot += s.double()
        cnt += c
    img = (tot / cnt.clamp_min(1)[:, None]).cpu().numpy()
    img[:, 3] = (cnt > 0).cpu().numpy().astype(np.float32)
    return img.reshape(size, size, 4).astype(np.float32)


def phase_golden(film, RenderOptions):
    from cpupathtrace_tpu_torch.models import golden

    results = {}
    for name, (fname, make_scene, make_cam, spp, seed) in golden.GOLDEN_CASES.items():
        ours = render_fixed(film, make_scene(device="cuda"), make_cam(device="cuda"),
                            RenderOptions, 32, spp, seed)
        res = golden.check_golden(name, ours, golden.read_golden(fname))
        results[name] = res
        need(res["ok"], f"golden {name} parity failed: {res}")
    return results


def phase_main_path(pt, mk, sw, scenes, best_ms):
    opts = pt.RenderOptions(BOX_W, BOX_H, BOX_SPP, BOX_SPP, epsilon=1e-3, max_depth=MAX_DEPTH)
    scene = scenes.bench_box_scene()
    camera = scenes.bench_camera()
    mk.trace_megakernel.launches = 0
    mk.trace_megakernel_reference.calls = 0
    image = pt.render(scene, camera, opts, seed=0, device="cuda")
    sync()
    launches = mk.trace_megakernel.launches
    twin_calls = mk.trace_megakernel_reference.calls
    need(launches > 0, "main path never launched the megakernel")
    need(twin_calls == 0, f"main path called the twin {twin_calls} times on the card")
    need(image.shape == (BOX_H, BOX_W, 4) and np.isfinite(image).all(), "non-finite image")
    need(bool((image[..., 3] == 1.0).all()), "closed box: alpha must be 1 everywhere")
    mean = float(image[..., :3].mean())
    need(0.01 < mean < 10.0, f"implausible box radiance {mean}")

    frames = []
    for seed in range(1, TIMED_FRAMES + 1):
        sync()
        t0 = time.perf_counter()
        pt.render(scene, camera, opts, seed=seed, device="cuda")
        sync()
        frames.append(time.perf_counter() - t0)
    frame_s = float(np.median(frames))
    mrays = BOX_W * BOX_H * BOX_SPP / frame_s / 1e6

    # The kernel alone and its twin, at the main path's shape: the frame's
    # 4.19M camera rays in one launch.
    from cpupathtrace_tpu_torch.camera.camera import shoot_rays
    from cpupathtrace_tpu_torch.integrator.film import pixel_camera_coords

    xg, yg = np.meshgrid(np.arange(BOX_W, dtype=np.float32), np.arange(BOX_H, dtype=np.float32))
    x, y = pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sc = scene.to("cuda")
    rays = shoot_rays(camera.to("cuda"), torch.tensor(x, device="cuda").repeat(BOX_SPP),
                      torch.tensor(y, device="cuda").repeat(BOX_SPP),
                      1.0 / BOX_W, 1.0 / BOX_H, gen)
    tables = mk.pack_tables(sc)
    k_spec, _ = mk.trace_megakernel(sc, rays, opts, 99, tables)
    kernel_ms = cuda_ms(lambda: mk.trace_megakernel(sc, rays, opts, 99, tables), 5)
    # The seed on the card: a host int would be copied from pageable memory,
    # which waits for the stream, and best_ms needs the host ahead.
    seed_t = torch.tensor([99], dtype=torch.int32, device="cuda")
    kernel_best_ms = best_ms(lambda: mk.trace_megakernel(sc, rays, opts, seed_t, tables), 5)
    plain_ms = cuda_ms(lambda: mk.trace_megakernel_reference(sc, rays, opts, 99, tables), 1)
    t_spec, _ = mk.trace_megakernel_reference(sc, rays, opts, 99, tables)
    agree = compare(k_spec, t_spec)
    agree["bit_equal"] = bits_equal(k_spec, t_spec)
    check_agreement("main-path shape", agree)
    need(agree["bit_equal"], f"K1 dense at the main path's shape is not bit-equal: {agree}")
    line("5 profile", **profile_frame(pt, scene, camera, opts))
    n = int(rays.origin.shape[0])
    ray_bounces, live = twin_ray_bounces(sw, sc, camera.to("cuda"), opts, n)
    k1_bound = bound(n * (24 + 16), ray_bounces * (
        tests_per_vertex(sc, sc.n_tri + sc.n_sph) * TEST_FLOPS + VERTEX_FLOPS))
    # The refilling warps: occupancy, lane use from the counting instance's
    # bounce steps (the prediction for one path per thread from the twin's
    # live counts beside it), and a ragged count below one resident wave
    # (not a multiple of 32 or of the block), each bit-equal to the twin.
    smem = mk.block_smem_bytes(sc, tables)
    per_sm, threads = mk.occupancy(smem, False, False, sc.krn_big_cull_mode)
    steps = torch.zeros(mk.BOUNCE_STEP_COLS, dtype=torch.int64, device="cuda")
    c_spec, _ = mk.trace_megakernel(sc, rays, opts, 99, tables, bounce_steps=steps)
    sync()
    need(bits_equal(c_spec, k_spec), "K1 dense: the counting instance differs from the plain one")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wave = sms * per_sm * threads
    ragged = wave // 3 // 32 * 32 + 17
    head = type(rays)(rays.origin[:ragged].contiguous(), rays.direction[:ragged].contiguous())
    r_spec, _ = mk.trace_megakernel(sc, head, opts, 99, tables)
    sync()
    need(not bool(torch.isnan(r_spec).any()), "K1 dense left a ray of the ragged count unwritten")
    need(bits_equal(r_spec, t_spec[:ragged]), "K1 dense on the ragged count is not bit-equal")
    refill = dict(threads=threads, blocks_per_sm=per_sm, warps_per_sm=per_sm * threads // 32,
                  resident_threads=wave, bounce_steps=int(steps[0]),
                  ray_bounces_counted=int(steps[1]), lane_use=mk.lane_use(steps.cpu()),
                  lane_use_one_path_per_thread=mk.predicted_lane_use(live),
                  ragged_rays=ragged, ragged_bit_equal=True)
    return dict(launches=launches, twin_calls=twin_calls, image_mean=mean,
                frame_s=frames, frame_median_s=frame_s, mrays_per_s=mrays,
                rays=n, kernel_ms=kernel_ms, kernel_best_ms=kernel_best_ms,
                twin_ms=plain_ms, kernel_mrays_per_s=n / kernel_ms / 1e3,
                agreement=agree, ray_bounces=ray_bounces, twin_live_per_bounce=live,
                refill=refill, **k1_bound)


def profile_frame(pt, scene, camera, opts, kernel="megakernel"):
    """One main-path frame under torch.profiler (see profile_run)."""
    return profile_run(lambda: pt.render(scene, camera, opts, seed=7, device="cuda"), kernel)


def profile_run(fn, kernel, names=()):
    """fn() under torch.profiler: device time by kernel name (top 6), the
    share of kernels named `kernel`, the device time and launches of the
    kernels whose name holds each of `names`, and the device's busy share
    of the wall time (the union of kernel intervals)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    need(kernels, "profiler recorded no device activity")
    ablated = sorted({e.name[:90] for e in kernels if "_ablate" in e.name})
    need(not ablated, f"the main path ran an ablation instance: {ablated}")
    by_name: dict = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    for e in kernels:
        key = e.name[:90]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    mine = sum(v for k, v in by_name.items() if kernel in k)
    named = {n: dict(us=sum(e.time_range.elapsed_us() for e in kernels if n in e.name),
                     launches=sum(1 for e in kernels if n in e.name)) for n in names}
    return dict(wall_us=wall_us, device_kernel_us=total, device_busy_us=busy,
                busy_share=busy / wall_us, **{f"{kernel}_share_of_device": mine / total},
                n_kernels=len(kernels),
                top_us=dict(top), **({"kernels": named} if names else {}))


def phase_demo(pt, scenes, out_dir, include_dragon=False):
    w = h = 256
    scene = scenes.cornell_demo_scene(include_dragon=include_dragon)
    camera = scenes.cornell_demo_camera(w, h)
    opts = scenes.cornell_demo_options(w, h)
    sync()
    t0 = time.perf_counter()
    image = pt.render(scene, camera, opts, seed=0, device="cuda")
    sync()
    frame_s = time.perf_counter() - t0
    need(np.isfinite(image).all() and image.shape == (h, w, 4), "demo image not finite")
    need(float(image[..., :3].mean()) > 0.01, "demo image is black")
    post = pt.post_process(torch.from_numpy(image).cuda()).cpu().numpy()
    need(np.isfinite(post).all(), "post-processed demo not finite")
    with tempfile.TemporaryDirectory() as tmp:
        name = "demo_dragon_torch.png" if include_dragon else "demo_torch.png"
        path = os.path.join(out_dir or tmp, name)
        pt.write_rgb_image(path, post)
        back = pt.read_rgb_image(path)
        size = os.path.getsize(path)
    want = np.clip(np.round(post * 255.0), 0, 255) / 255.0
    need(back.shape == (h, w, 4) and np.allclose(back, want, atol=1e-6), "PNG read-back differs")
    return dict(frame_s=frame_s, png_bytes=size, image_mean=float(image[..., :3].mean()),
                spp=f"{opts.min_sample_count}-{opts.max_sample_count}")


def phase_dragon_build(scenes):
    """Build renderSceneDragonBox on the card, timed by stage."""
    from cpupathtrace_tpu_torch.accel.build import build_bvh
    from cpupathtrace_tpu_torch.scene.scene import BUILD_SECONDS

    runs0 = dict(build_bvh.runs)
    t0 = time.perf_counter()
    scene = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, device="cuda")
    total = time.perf_counter() - t0
    ran = {k: build_bvh.runs[k] - runs0[k] for k in runs0}
    need(scene.accel == "binned" and scene.has_kernel_records, "dragon scene is not binned")
    need(ran["native"] >= 1, f"the C++ BVH builder did not run at {scene.n_tri} triangles: {ran}")
    return scene, dict(seconds=total, stages_s=dict(BUILD_SECONDS), bvh_builder_runs=ran,
                       n_tri=scene.n_tri, n_big=scene.n_big,
                       records=list(scene.krn_records.shape),
                       cl_bounds=list(scene.krn_cl_bounds.shape),
                       sup_bounds=list(scene.krn_sup_bounds.shape),
                       hyp_bounds=list(scene.krn_hyp_bounds.shape),
                       cull_modes=[scene.krn_cull_mode, scene.krn_big_cull_mode],
                       record_mb=scene.krn_records.numel() * 4 / 1e6)


def k4_check(kt, scene, o, d, lim, any_hit, what):
    """K4 against its plain version on the same rays: t and prim bit-equal
    on every ray, and the counting instance's four counter columns equal
    to the plain version's. Returns the figures, the counters and the
    counting run's warp steps."""
    t_k, p_k = kt.cluster_intersect(scene, o, d, lim, any_hit=any_hit)
    steps = torch.zeros(kt.QUERY_STEP_COLS, dtype=torch.int64, device="cuda")
    tc, pc, vis = kt.cluster_intersect(scene, o, d, lim, any_hit=any_hit, debug_visits=True,
                                       warp_steps=steps)
    sync()
    t0 = time.perf_counter()
    t_p, p_p, vis_p = kt.cluster_intersect_reference(scene, o, d, lim, any_hit=any_hit,
                                                     debug_visits=True)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    res = dict(rays=int(o.shape[0]), hits=int((p_p >= 0).sum()), plain_ms=plain_ms,
               t_equal=bits_equal(t_k, t_p) and bits_equal(tc, t_p),
               prim_equal=bool(torch.equal(p_k, p_p) and torch.equal(pc, p_p)),
               counters_equal=bool(torch.equal(vis, vis_p)), max_abs_err=max_err(t_k, t_p))
    need(res["t_equal"] and res["prim_equal"] and res["counters_equal"] and res["hits"] > 1000,
         f"cluster query {what} disagrees with its plain version: {res}")
    return res, vis, steps


def k4_bound(vis, n):
    """K4's bound from its counters on `n` rays: the walk's work and the
    root test per ray; 28 bytes of ray in and 8 out per ray."""
    flops, counts = traversal_flops(vis)
    return dict(counts=counts, **bound(n * (24 + 4 + 8), flops + n * SLAB_FLOPS))


def phase_cluster_query(kt, sw, scenes, scene, best_ms):
    """K4 through `cluster_intersect` (its path: counts zeroed just before,
    read just after), then, at phase 7's 65,536 rays in the box and at the
    dragon frame's 262,144 camera rays, nearest and any-hit: bit-equal to
    the plain traversal with its counters, timed (whole calls and the card
    alone), bounded from the counters, with the counting instance's lane
    use and distinct clusters per row step; and a ragged count below one
    resident wave into NaN-filled outputs."""
    from cpupathtrace_tpu_torch import _build

    o, d, lim = query_rays_phase7()
    kt.cluster_intersect.launches = 0
    kt.cluster_intersect_reference.calls = 0
    kt.cluster_intersect(scene, o, d)
    kt.cluster_intersect(scene, o, d, lim, any_hit=True)
    sync()
    launches = kt.cluster_intersect.launches
    need(launches == 2 and kt.cluster_intersect_reference.calls == 0,
         f"cluster query path: {launches} launches, "
         f"{kt.cluster_intersect_reference.calls} plain calls")
    frame = camera_state(sw, scenes.bench_camera(), _frame_options(), DRAGON_SPP, 3)[0]
    fo, fd = frame.origin.contiguous(), frame.direction.contiguous()
    flim = frame_limits(kt.cluster_intersect(scene, fo, fd)[0])
    layout = kt.walk_layout("cluster_query")
    smem = kt.query_smem_bytes(scene.krn_sup_bounds.shape[0])
    per_sm, threads = kt.query_occupancy(smem)
    inst = _build.ptxas_instances(_build.ptxas_report.get("cluster_query", ""))
    out = dict(launches=launches, ring_depth=layout.depth, threads=threads, smem_bytes=smem,
               blocks_per_sm=per_sm, warps_per_sm=per_sm * threads // 32,
               counting_blocks_per_sm=kt.query_occupancy(smem, True)[0],
               ptxas={k: v for k, v in inst.items() if "cluster_query" in k})
    for shape, (qo, qd, ql) in (("phase7", (o, d, lim)), ("frame", (fo, fd, flim))):
        for kind, any_hit in (("nearest", False), ("any_hit", True)):
            lim_q = ql if any_hit else None
            res, vis, steps = k4_check(kt, scene, qo, qd, lim_q, any_hit, f"{shape} {kind}")
            try:
                res["walk"] = kt.warp_utilisation(vis, steps)
            except ValueError as e:
                raise SmokeFailure(f"K4 {shape} {kind}: warp steps out of their bounds: {e}")
            res["ms"] = cuda_ms(lambda: kt.cluster_intersect(scene, qo, qd, lim_q,
                                                             any_hit=any_hit), 5)
            res["best_ms"] = best_ms(lambda: kt.cluster_intersect(scene, qo, qd, lim_q,
                                                                  any_hit=any_hit), 10)
            res.update(k4_bound(vis, res["rays"]))
            out[f"{shape}_{kind}"] = res
    # A ragged count below one resident wave, 17 past a multiple of 32.
    wave = per_sm * threads * torch.cuda.get_device_properties(0).multi_processor_count
    n = (wave // 2) // 32 * 32 + 17
    rag = {}
    for kind, any_hit in (("nearest", False), ("any_hit", True)):
        t_k, p_k = kt.cluster_intersect(scene, o[:n], d[:n], lim[:n], any_hit=any_hit)
        t_p, p_p = kt.cluster_intersect_reference(scene, o[:n], d[:n], lim[:n], any_hit=any_hit)
        rag[kind] = dict(nan_left=int(torch.isnan(t_k).sum()),
                         equal=bits_equal(t_k, t_p) and bool(torch.equal(p_k, p_p)))
        need(rag[kind]["nan_left"] == 0 and rag[kind]["equal"],
             f"K4 on {n} rays ({kind}): {rag[kind]}")
    out["ragged"] = dict(rays=n, resident_wave=wave, **rag)
    # Past one wave with whole claims ending at the root gate (t_lim 0 on
    # the first wave's rays, as a wavefront frame's camera rays end on the
    # box's front wall): the warps go on claiming, every ray is written.
    glim = flim.clone()
    glim[:wave] = 0.0
    gated = {}
    for kind, any_hit in (("nearest", False), ("any_hit", True)):
        t_k, p_k = kt.cluster_intersect(scene, fo, fd, glim, any_hit=any_hit)
        t_p, p_p = kt.cluster_intersect_reference(scene, fo, fd, glim, any_hit=any_hit)
        gated[kind] = dict(nan_left=int(torch.isnan(t_k).sum()), hits=int((p_p >= 0).sum()),
                           equal=bits_equal(t_k, t_p) and bool(torch.equal(p_k, p_p)))
        need(gated[kind]["nan_left"] == 0 and gated[kind]["equal"] and gated[kind]["hits"] > 0,
             f"K4 with gated claims ({kind}): {gated[kind]}")
    out["gated"] = dict(rays=int(fo.shape[0]), inactive=wave, **gated)
    p7 = out["phase7_nearest"]
    out.update(ms=p7["ms"], best_ms=p7["best_ms"], any_hit_ms=out["phase7_any_hit"]["ms"],
               plain_ms=p7["plain_ms"], bound_ms=p7["bound_ms"], bound_by=p7["bound_by"],
               max_abs_err=max(out[k]["max_abs_err"] for k in (
                   "phase7_nearest", "phase7_any_hit", "frame_nearest", "frame_any_hit")))
    return out


def frame_limits(t_near, seed=2):
    """Shadow limits for camera rays from their nearest hit `t_near` (-1 on
    a miss): half to one and a half times it, so about half the rays that
    hit are occluded; uniform in [0.05, 6] for the rays that miss (the
    camera is 2 units in front of the box)."""
    u = torch.tensor(np.random.default_rng(seed).uniform(0.5, 1.5, t_near.shape[0]),
                     dtype=torch.float32, device=t_near.device)
    return torch.where(t_near > 0, t_near * u, 0.05 + 5.95 * (u - 0.5))


def _frame_options():
    """The dragon frame's options (128x128 @ 16 spp, max_depth 40)."""
    from cpupathtrace_tpu_torch.core.config import RenderOptions

    return RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                         max_depth=MAX_DEPTH)


def camera_state(sw, camera, opts, spp, seed):
    """(rays, the sorted driver's fresh [18, R] state) of a frame of `spp`
    camera rays per pixel (sample-major), as render() shoots them."""
    from cpupathtrace_tpu_torch.camera.camera import shoot_rays
    from cpupathtrace_tpu_torch.integrator.film import pixel_camera_coords

    w, h = opts.image_width, opts.image_height
    xg, yg = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x, y = pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rays = shoot_rays(camera, torch.tensor(x, device="cuda").repeat(spp),
                      torch.tensor(y, device="cuda").repeat(spp), 1.0 / w, 1.0 / h, gen)
    return rays, sw.initial_state(rays.origin, rays.direction, seed)


def compare_planes(k_state, t_state):
    """Per state plane, the share of rays whose bits are equal, and the
    largest difference of the float planes (plane 0 holds rng bits)."""
    same = (k_state.view(torch.int32) == t_state.view(torch.int32)).float().mean(1)
    err = float((k_state[1:] - t_state[1:]).abs().nan_to_num(0.0).max())
    return dict(min_plane_equal=float(same.min()),
                planes_equal=[round(float(v), 6) for v in same], max_abs_err=err)


def phase_bounce_vs_twin(sw, mk, scenes, scene, RenderOptions):
    camera = scenes.bench_camera(device="cuda")
    opts = RenderOptions(DRAGON_W, DRAGON_H, 1, 1, epsilon=1e-3, max_depth=MAX_DEPTH)
    tables = mk.pack_tables(scene)
    rays, st = camera_state(sw, camera, opts, 1, 77)
    need(rays.origin.shape[0] == PATH_RAYS, "camera state size")
    out = {}
    for depth in (0, 5):
        k, t = st.clone(), st.clone()
        sw.bounce(scene, k, torch.tensor([77, depth], dtype=torch.int32, device="cuda"),
                  opts, tables)
        sw.bounce_reference(scene, t, depth, opts, tables)
        sync()
        res = compare_planes(k, t)
        res["alive_after"] = int((k[17] > 0.5).sum())
        out[f"bounce_depth{depth}"] = res
        need(res["min_plane_equal"] >= PLANE_FRAC, f"K2 at depth {depth} disagrees: {res}")
        st = k
    ks, _ = sw.trace_megakernel_sorted(scene, rays, opts, 5)
    ku, _ = sw.trace_megakernel_sorted(scene, rays, opts, 5, sort=False)
    tw, _ = sw.trace_megakernel_sorted(scene, rays, opts, 5, reference=True)
    sync()
    out["sorted_equals_unsorted"] = bool(torch.equal(ks.view(torch.int32), ku.view(torch.int32)))
    need(out["sorted_equals_unsorted"], "K2's sorted run differs from its unsorted run")
    out["paths"] = compare(ks, tw)
    check_agreement("K2 whole paths", out["paths"])
    return out


# The walk's figures phase 21 repeats for K1's binned form and K2.
WALK_KEYS = ("ring_depth", "threads", "registers", "spill_stores", "blocks_per_sm",
             "warps_per_sm", "lane_utilisation")


def phase_dragon_main_path(pt, sw, mk, kt, scenes, scene):
    opts = pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    camera = scenes.bench_camera(device="cuda")
    sw.bounce.launches = 0
    sw.bounce_reference.calls = 0
    mk.trace_megakernel.launches = 0
    image = pt.render(scene, camera, opts, seed=0, device="cuda")
    sync()
    launches = sw.bounce.launches
    twin_calls = sw.bounce_reference.calls
    need(launches > 0, "dragon main path never launched the bounce kernel")
    need(twin_calls == 0, f"dragon main path called the twin {twin_calls} times on the card")
    need(mk.trace_megakernel.launches == 0, "dragon main path ran the dense megakernel")
    need(image.shape == (DRAGON_H, DRAGON_W, 4) and np.isfinite(image).all(), "non-finite image")
    need(bool((image[..., 3] == 1.0).all()), "closed box: alpha must be 1 everywhere")
    mean = float(image[..., :3].mean())
    need(0.005 < mean < 10.0, f"implausible dragon-box radiance {mean}")

    frames = []
    for seed in range(1, TIMED_FRAMES + 1):
        sync()
        t0 = time.perf_counter()
        pt.render(scene, camera, opts, seed=seed, device="cuda")
        sync()
        frames.append(time.perf_counter() - t0)
    frame_s = float(np.median(frames))
    n_paths = DRAGON_W * DRAGON_H * DRAGON_SPP

    # The sorted driver alone on the frame's 262,144 camera rays: its wall
    # time, and K2 / sort+gather per bounce by CUDA events: K2's eight
    # launches on the frame's own (sorted) state.
    rays, st = camera_state(sw, camera, opts, DRAGON_SPP, 3)
    tables = mk.pack_tables(scene)
    sw.trace_megakernel_sorted(scene, rays, opts, 3, tables)
    sync()
    t0 = time.perf_counter()
    sw.trace_megakernel_sorted(scene, rays, opts, 3, tables)
    sync()
    driver_s = time.perf_counter() - t0
    timing: dict = {}
    spec, _ = sw.trace_megakernel_sorted(scene, rays, opts, 3, tables, timing=timing)
    events_ms = sum(timing["bounce_ms"]) + sum(timing["sort_ms"])
    # The same without the sort: its event time after each K2 is the one
    # host sync of the bounce (the alive count) with its two small kernels.
    sync()
    t0 = time.perf_counter()
    sw.trace_megakernel_sorted(scene, rays, opts, 3, tables, sort=False)
    sync()
    unsorted = dict(driver_wall_ms=(time.perf_counter() - t0) * 1e3)
    timing_u: dict = {}
    sw.trace_megakernel_sorted(scene, rays, opts, 3, tables, sort=False, timing=timing_u)
    unsorted.update(bounce_ms=timing_u["bounce_ms"], sync_ms=timing_u["sort_ms"])

    # The frame's bound from its counters (the counting form on the same
    # rays and seed, which visits the same states), its warp steps, and the
    # frame through the twin's driver: its time, and the spectra held at the
    # K1 bounds.
    steps = torch.zeros(kt.WARP_STEP_COLS, dtype=torch.int64, device="cuda")
    _, _, vis = sw.trace_megakernel_sorted(scene, rays, opts, 3, tables, debug_visits=True,
                                           warp_steps=steps)
    frame = frame_bound(vis, n_paths, scene)
    frame.update(walk_figures(kt, scene, tables, vis, steps, "bounce_binned_kernel"))
    frame["row_lane_use"], frame["slab_lane_use"] = row_lane_use(frame)
    sync()
    t0 = time.perf_counter()
    tspec, _ = sw.trace_megakernel_sorted(scene, rays, opts, 3, tables, reference=True)
    sync()
    frame_plain_ms = (time.perf_counter() - t0) * 1e3
    frame_agree = compare(spec, tspec)
    check_agreement("K2's frame against the twin's driver", frame_agree)
    k2_frame_ms = sum(timing["bounce_ms"])

    # A single-kernel reading and the per-plane check, on a state the main
    # path does not launch: depth 1 of the frame's camera rays after bounce
    # 0 in place, unsorted (the bounce that costs most).
    sw.bounce(scene, st, torch.tensor([3, 0], dtype=torch.int32, device="cuda"), opts, tables)
    sd = torch.tensor([3, 1], dtype=torch.int32, device="cuda")
    k = st.clone()
    sw.bounce(scene, k, sd, opts, tables)
    t = st.clone()
    sync()
    t0 = time.perf_counter()
    sw.bounce_reference(scene, t, 1, opts, tables)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    agree = compare_planes(k, t)
    agree["alive_in"] = int((st[17] > 0.5).sum())
    need(agree["min_plane_equal"] >= PLANE_FRAC, f"K2 at the main path's shape: {agree}")
    copies = iter([st.clone() for _ in range(5)])
    kernel_ms = cuda_ms(lambda: sw.bounce(scene, next(copies), sd, opts, tables), 5)
    profile = profile_frame(pt, scene, camera, opts, kernel="bounce_binned_kernel")
    line("9 profile", **profile)
    # That bounce's bound from its counters (the counting form on the same
    # state), held against the twin's counts.
    live = agree["alive_in"]
    n_blocks = -(-n_paths // 1024)
    vk = torch.zeros((n_blocks, sw.GEO_VISIT_COLS), dtype=torch.int32, device="cuda")
    vt = torch.zeros_like(vk)
    sw.bounce(scene, st.clone(), sd, opts, tables, visits=vk)
    sw.bounce_reference(scene, st.clone(), 1, opts, tables, visits=vt)
    need(torch.equal(vk, vt), "K2's counters differ from its twin's")
    need(ray_bounces(vk) == live, f"K2 counted {ray_bounces(vk)} nearest queries, {live} live")
    flops, counts = traversal_flops(vk)
    depth1 = dict(what="one bounce on a state the main path does not launch (depth 1 of the "
                       "camera rays after bounce 0 in place, unsorted)",
                  kernel_ms=kernel_ms, twin_ms=plain_ms, agreement=agree, counts=counts,
                  **bound(live * 144 + (n_paths - live) * 4, flops + live * vertex_flops(scene)))
    return dict(launches=launches, twin_calls=twin_calls, image_mean=mean, frame_s=frames,
                frame_median_s=frame_s, mrays_per_s=n_paths / frame_s / 1e6, paths=n_paths,
                bounces=len(timing["bounce_ms"]), bounce_ms=timing["bounce_ms"],
                k2_frame_ms=k2_frame_ms, k2_frame_plain_ms=frame_plain_ms,
                k2_frame_gap_ms=k2_frame_ms - frame["bound_ms"],
                k2_gap_per_launch_ms=(k2_frame_ms - frame["bound_ms"]) / len(timing["bounce_ms"]),
                frame=frame, frame_agreement=frame_agree,
                sort_gather_ms=timing["sort_ms"], driver_wall_ms=driver_s * 1e3,
                driver_events_ms=events_ms, unsorted=unsorted, depth1=depth1,
                max_abs_err=max(agree["max_abs_err"], frame_agree["max_abs_err"]),
                busy_share=profile["busy_share"])


def walk_figures(kt, scene, tables, vis, steps, kernel):
    """The walk's shape and resources for K1's binned form (`kernel`
    "megakernel_binned") or K2 ("bounce_binned_kernel"): ring depth,
    threads a block, the plain instance's registers and spills (ptxas),
    its resident blocks and warps a SM at the scene's shared memory, and
    the lane utilisation of the counted run's warp steps (within their
    bounds, kernel_traverse.warp_utilisation)."""
    from cpupathtrace_tpu_torch import _build
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw

    k1 = kernel == "megakernel_binned"
    layout = kt.walk_layout("megakernel" if k1 else "bounce")
    smem = mk.block_smem_bytes(scene, tables, layout)
    cull = int(scene.krn_big_cull_mode)
    blocks, threads = (mk.occupancy(smem, True, cull=cull) if k1
                       else sw.bounce_occupancy(smem, cull=cull))
    try:
        util = kt.warp_utilisation(vis, steps)
    except ValueError as e:
        raise SmokeFailure(f"{kernel}: warp steps out of their bounds: {e}")
    need(util["row_steps"] > 0 and util["slab_steps"] > 0, f"{kernel}: no warp steps counted")
    # ptxas reports only what this process built (phase 2 builds cold).
    inst = _build.ptxas_instances(_build.ptxas_report.get("megakernel" if k1 else "bounce", ""))
    plain = f"{kernel}<{cull}, 0>" if k1 else f"{kernel}<{cull}, 0, 0>"
    regs = inst.get(plain, {})
    need(threads == layout.threads, f"{kernel}: {threads} threads a block, laid out for "
                                    f"{layout.threads}")
    return dict(ring_depth=layout.depth, threads=threads, smem_bytes=smem,
                blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32, instance=plain,
                registers=regs.get("registers"), spill_stores=regs.get("spill_stores"),
                lane_utilisation=util)


def twin_ray_bounces(sw, scene, camera, opts, n_rays):
    """Executed ray-bounces of a K1 frame of `n_rays` paths, from the live
    counts of the twin's bounce at a reduced size (128x128 @ 1 spp, the
    same estimator and stopping rules), scaled to `n_rays`."""
    from cpupathtrace_tpu_torch.core.config import RenderOptions

    small = RenderOptions(128, 128, 1, 1, epsilon=opts.epsilon, max_depth=opts.max_depth)
    _, st = camera_state(sw, camera, small, 1, 3)
    counts = []
    for depth in range(int(opts.max_depth)):
        live = int((st[17] > 0.5).sum())
        if live == 0:
            break
        counts.append(live)
        sw.bounce_reference(scene, st, depth, opts)
    return sum(counts) * n_rays / st.shape[1], counts


def k5_check(oi, scene, o, d, tables, n_tri, what):
    """K5 on one input against its plain version: prim, hit and t equal
    on every ray, prim int64; with its instance (staged or read through
    L1) and the bound of this input's tests."""
    t_k, p_k = oi.dense_intersect(scene, o, d, tables, n_tri_rows=n_tri)
    sync()
    t_p, p_p = oi.dense_intersect_reference(scene, o, d, tables, n_tri_rows=n_tri)
    n, n_sph = o.shape[0], tables[1].shape[0]
    # The bound counts the tests of valid rows (padding rows are no work).
    tests = int((tables[0][:n_tri, 10] > 0.5).sum()) + int((tables[1][:, 4] > 0.5).sum())
    res = dict(rays=n, tri_rows=n_tri, sph_rows=n_sph, hits=int((p_p >= 0).sum()),
               prim_dtype=str(p_k.dtype).replace("torch.", ""),
               staged=oi.dense_occupancy(n_tri, n_sph)[2] > 0,
               prim_equal=float((p_k == p_p).float().mean()),
               hit_equal=float(((p_k >= 0) == (p_p >= 0)).float().mean()),
               t_equal=float((t_k == t_p).float().mean()),
               max_abs_err=float((t_k - t_p).abs().max()) if n else 0.0)
    need(res["prim_equal"] == res["hit_equal"] == res["t_equal"] == 1.0
         and p_k.dtype == torch.int64, f"K5 disagrees with its plain version ({what}): {res}")
    res.update(bound(n * K5_RAY_BYTES, n * tests * TEST_FLOPS))
    return res


def phase_dense_query(pt, oi, sw, tt, isw, scenes, lean, best_ms):
    """K5 through `dense_intersect` (counts zeroed just before, read just
    after), then against its plain version on the same 262,144 rays, timed
    as whole calls and as the launch alone; on the lean dragon frame's
    largest K5 input, and on random tables staged and past the stage
    limit."""
    scene = scenes.bench_box_scene()
    opts = pt.RenderOptions(GRAD_W, GRAD_H, 8, 8)
    rays, _ = camera_state(sw, scenes.bench_camera(), opts, 8, 11)
    n_cam = rays.origin.shape[0]
    rng = np.random.default_rng(2)
    d2 = rng.normal(size=(K5_RAYS - n_cam, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = torch.cat([rays.origin, torch.tensor(rng.uniform(-0.95, 0.95, (K5_RAYS - n_cam, 3)),
                                             dtype=torch.float32, device="cuda")])
    d = torch.cat([rays.direction, torch.tensor(d2, dtype=torch.float32, device="cuda")])
    oi.dense_intersect.launches = 0
    oi.dense_intersect_reference.calls = 0
    oi.dense_intersect(scene, o, d)
    sync()
    launches, plain_calls = oi.dense_intersect.launches, oi.dense_intersect_reference.calls
    need(launches == 1 and plain_calls == 0,
         f"dense query path: {launches} launches, {plain_calls} plain calls")
    tables = oi.dense_tables(scene)
    res = k5_check(oi, scene, o, d, tables, scene.n_tri, "the box")
    res.update(camera_rays=n_cam, launches=launches)
    # `ms`: the mean of 20 whole calls by events (the wrapper's host time
    # in); `best_ms`: the launch alone (experiments.best_ms).
    res["ms"] = cuda_ms(lambda: oi.dense_intersect(scene, o, d, tables), 20)
    res["best_ms"] = best_ms(lambda: oi.dense_intersect(scene, o, d, tables), 10)
    res["plain_ms"] = cuda_ms(lambda: oi.dense_intersect_reference(scene, o, d, tables), 5)
    from cpupathtrace_tpu_torch import _build

    per_sm, threads, smem, max_stage = oi.dense_occupancy(scene.n_tri, scene.n_sph)
    res["kernel"] = dict(blocks_per_sm=per_sm, threads=threads, smem_bytes=smem,
                         max_stage_bytes=max_stage,
                         ptxas=_build.ptxas_instances(_build.ptxas_report.get("dense_query", "")))
    # The lean dragon frame's largest K5 input (phase 18's frame).
    _, _, (lo, ld, ltables, lrows) = isw.frame_inputs(pt, tt, oi, lean, scenes.bench_camera())
    res["lean_frame"] = k5_check(oi, scene, lo, ld, ltables, lrows, "the lean frame's input")
    res["lean_frame"]["best_ms"] = best_ms(
        lambda: oi.dense_intersect(scene, lo, ld, ltables, n_tri_rows=lrows), 10)
    # Random tables: within the stage limit (staged) and past it (read
    # through L1).
    past = max_stage // (4 * oi.TRI_COLS) + 67
    for key, rows in (("staged_table", K5_BIG_ROWS), ("past_stage", past)):
        go, gd, gtables = isw.big_table(rows=rows)
        res[key] = k5_check(oi, scene, go, gd, gtables, rows, f"{rows} triangle rows")
        res[key]["best_ms"] = best_ms(
            lambda: oi.dense_intersect(scene, go, gd, gtables, n_tri_rows=rows), 5)
    need(res["staged_table"]["staged"] and not res["past_stage"]["staged"],
         "K5's big tables did not take both instances")
    res["max_abs_err"] = max([res["max_abs_err"]] + [
        res[k]["max_abs_err"] for k in ("lean_frame", "staged_table", "past_stage")])
    return res


def phase_wavefront(pt, film, oi, mk, scenes, RenderOptions):
    """The forward wavefront on the card (PTX_NO_MEGAKERNEL=1): golden
    parity, then the box frame against K1's."""
    opts = RenderOptions(GRAD_W, GRAD_H, GRAD_SPP, GRAD_SPP, epsilon=1e-3, max_depth=GRAD_DEPTH)
    scene, camera = scenes.bench_box_scene(), scenes.bench_camera()
    os.environ["PTX_NO_MEGAKERNEL"] = "1"
    try:
        oi.dense_intersect.launches = 0
        oi.dense_intersect_reference.calls = 0
        mk.trace_megakernel.launches = 0
        golden_res = phase_golden(film, RenderOptions)
        sync()
        t0 = time.perf_counter()
        img_w = pt.render(scene, camera, opts, seed=1, device="cuda")
        sync()
        frame_s = time.perf_counter() - t0
        k5, plain, k1 = (oi.dense_intersect.launches, oi.dense_intersect_reference.calls,
                         mk.trace_megakernel.launches)
    finally:
        del os.environ["PTX_NO_MEGAKERNEL"]
    need(k5 > 0 and plain == 0 and k1 == 0,
         f"wavefront path: K5 {k5} launches, {plain} plain calls, K1 {k1} launches")
    img_k = pt.render(scene, camera, opts, seed=2, device="cuda")
    need(np.isfinite(img_w).all() and bool((img_w[..., 3] == 1.0).all()), "wavefront box image")
    diff_px = img_w[..., :3].mean(-1).astype(np.float64) - img_k[..., :3].mean(-1)
    se = float(diff_px.std() / np.sqrt(diff_px.size))
    res = dict(golden=golden_res, k5_launches=k5, plain_calls=plain, box_frame_s=frame_s,
               box_mean_wavefront=float(img_w[..., :3].mean()),
               box_mean_k1=float(img_k[..., :3].mean()), mean_diff=float(diff_px.mean()),
               std_err=se)
    need(abs(res["mean_diff"]) <= 4 * se, f"wavefront box frame differs from K1's: {res}")
    return res


def compare_records(rk, rt):
    """Per record plane, the share of rays (dead ones included) whose bits
    are equal, and the largest difference."""
    same = (rk.view(torch.int32) == rt.view(torch.int32)).float().mean(1)
    return [round(float(v), 6) for v in same], max_err(rk, rt)


def nan_records(sw, scene, n):
    """K2's record planes for `n` rays, NaN-filled: the kernel writes every
    column itself, so a column it skipped shows."""
    nd = sw.n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
    return torch.full((nd, n), float("nan"), device="cuda")


def phase_records(sw, mk, scenes, dragon, RenderOptions):
    """K2's record form against its twin from the same state, dense (the
    box) and binned (the 200k dragon), with the record planes NaN-filled
    and compared on every ray; at depth 5 a seeded third of the rays enter
    dead, so the kernel writes their no-contribution encoding itself; the
    recording forward against the plain kernel."""
    camera = scenes.bench_camera()
    opts = RenderOptions(DRAGON_W, DRAGON_H, 1, 1, epsilon=1e-3, max_depth=MAX_DEPTH)
    out = {}
    for name, scene in (("box", scenes.bench_box_scene()), ("dragon", dragon)):
        tables = mk.pack_tables(scene)
        _, st = camera_state(sw, camera, opts, 1, 77)
        n = st.shape[1]
        for depth in (0, 5):
            if depth:
                gen = torch.Generator(device="cuda")
                gen.manual_seed(depth)
                st[17, torch.rand(n, generator=gen, device="cuda") < 1 / 3] = 0.0
            k, t, plain = st.clone(), st.clone(), st.clone()
            rk, rt = nan_records(sw, scene, n), nan_records(sw, scene, n)
            sd = torch.tensor([77, depth], dtype=torch.int32, device="cuda")
            sw.bounce(scene, k, sd, opts, tables, records=rk)
            sw.bounce(scene, plain, sd, opts, tables)
            sw.bounce_reference(scene, t, depth, opts, tables, records=rt)
            sync()
            res = compare_planes(k, t)
            res["records_equal"], res["records_max_abs_err"] = compare_records(rk, rt)
            res["recording_equals_plain"] = bool(torch.equal(k.view(torch.int32),
                                                             plain.view(torch.int32)))
            res["alive_in"] = int((st[17] > 0.5).sum())
            res["dead_in"] = n - res["alive_in"]
            out[f"{name}_depth{depth}"] = res
            need(res["min_plane_equal"] == 1.0 and min(res["records_equal"]) == 1.0
                 and res["recording_equals_plain"] and (res["dead_in"] > 0 or not depth),
                 f"K2 record form, {name} depth {depth}: {res}")
            st = k
    out["max_abs_err"] = max(max(v["max_abs_err"], v["records_max_abs_err"])
                             for v in out.values())
    return out


def grad_checks(diff, golden, RenderOptions, scene=None, cam=None, entries=None):
    """Analytic vs central-difference gradients on the card at 32x32 @ 8
    spp, max_depth 4 (test_diff.py:66's rtol 0.05, atol 1e-4), for the
    route PTX_DIFF_MEGAKERNEL currently selects; by default on the inward
    box, its wall albedo and its light's emission."""
    if scene is None:
        scene, cam = golden.inward_box_scene(), golden.box_camera()
    opts = RenderOptions(32, 32, 8, 8, max_depth=4)
    target = diff.render_image_diff(scene, cam, opts, 99, 8).detach()
    params = diff.get_material_params(scene)
    _, g = diff.loss_and_grad(params, scene, cam, opts, target, 0, 8)
    out = {}
    for field, idx in entries or (("mat_diffuse", (1, 0)), ("mat_emission", (2, 1))):
        fd = diff.finite_difference_grad(params, scene, cam, opts, target, 0, 8, field, idx,
                                         eps=2e-3)
        an = float(g[field][idx])
        out[f"{field}{list(idx)}"] = dict(analytic=an, fd=fd)
        need(np.isfinite(an) and abs(an - fd) <= 1e-4 + 0.05 * abs(fd),
             f"gradient vs FD on the card: {field}{idx} {an} vs {fd}")
    return out


def phase_box_grad(diff, sw, oi, scenes, golden, RenderOptions, best_ms):
    """renderSceneBoxGrad through loss_and_grad (bench.py:240-319), the
    record route and then the wavefront route."""
    scene, camera = scenes.bench_box_scene(), scenes.bench_camera()
    opts = RenderOptions(GRAD_W, GRAD_H, GRAD_SPP, GRAD_SPP, epsilon=1e-3, max_depth=GRAD_DEPTH)
    params = diff.get_material_params(scene)
    target = torch.zeros((GRAD_W * GRAD_H, 4), device="cuda")
    n_rays = GRAD_W * GRAD_H * GRAD_SPP

    def one(key):
        return diff.loss_and_grad(params, scene, camera, opts, target, key, GRAD_SPP)

    def counts_zero():
        sw.bounce.launches = sw.bounce.record_launches = sw.bounce_reference.calls = 0
        oi.dense_intersect.launches = oi.dense_intersect_reference.calls = 0

    def counts():
        return dict(k2=sw.bounce.launches, k2_records=sw.bounce.record_launches,
                    k2_twin=sw.bounce_reference.calls, k5=oi.dense_intersect.launches,
                    k5_plain=oi.dense_intersect_reference.calls)

    def run_route(batches, per_batch, warm):
        counts_zero()
        torch.cuda.reset_peak_memory_stats()
        loss, g = one(5)
        sync()
        res = dict(counts=counts(), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   loss=float(loss), grad_diffuse_wall=[float(v) for v in g["mat_diffuse"][1, :3]],
                   grad_emission_panel=[float(v) for v in g["mat_emission"][2, :3]])
        need(np.isfinite(res["loss"]) and all(torch.isfinite(v).all() for v in g.values())
             and float(g["mat_diffuse"][1].abs().sum()) > 0, f"gradient pass: {res}")
        for j in range(warm):
            one(1000 + j)
        sync()
        batch_ms, i = [], 0
        for _ in range(batches):
            t0 = time.perf_counter()
            for _ in range(per_batch):
                one(i)
                i += 1
            sync()
            batch_ms.append((time.perf_counter() - t0) / per_batch * 1e3)
        med = float(np.median(batch_ms))
        res.update(batch_ms_per_pass=batch_ms, ms_per_pass=med,
                   mrays_per_s_fwd_bwd=n_rays / med / 1e3)
        return res

    out = {"rays_per_pass": n_rays}
    out["replay"] = run_route(3, 5, 2)
    c = out["replay"]["counts"]
    need(c["k2_records"] > 0 and c["k2_twin"] == 0,
         f"renderSceneBoxGrad did not run K2's record form alone: {c}")
    out["replay"]["profile"] = profile_run(lambda: one(99), "bounce_kernel")
    out["replay"]["fd"] = grad_checks(diff, golden, RenderOptions)
    os.environ["PTX_DIFF_MEGAKERNEL"] = "0"
    try:
        out["wavefront"] = run_route(1, 3, 1)
        c = out["wavefront"]["counts"]
        need(c["k5"] > 0 and c["k5_plain"] == 0 and c["k2"] == 0,
             f"renderSceneBoxGrad's wavefront route: {c}")
        out["wavefront"]["profile"] = profile_run(lambda: one(98), "dense_query")
        out["wavefront"]["fd"] = grad_checks(diff, golden, RenderOptions)
    finally:
        del os.environ["PTX_DIFF_MEGAKERNEL"]

    # K2's record form alone on the pass's rays at depth 1, beside its twin.
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    tables = mk.pack_tables(scene)
    _, st = camera_state(sw, camera, opts, GRAD_SPP, 5)
    nd = sw.n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
    rec = torch.empty((nd, n_rays), device="cuda")
    sw.bounce(scene, st, torch.tensor([5, 0], dtype=torch.int32, device="cuda"), opts, tables,
              records=rec)
    sd = torch.tensor([5, 1], dtype=torch.int32, device="cuda")
    k, t = st.clone(), st.clone()
    rk, rt = nan_records(sw, scene, n_rays), nan_records(sw, scene, n_rays)
    sw.bounce(scene, k, sd, opts, tables, records=rk)
    sync()
    t0 = time.perf_counter()
    sw.bounce_reference(scene, t, 1, opts, tables, records=rt)
    sync()
    kr = dict(plain_ms=(time.perf_counter() - t0) * 1e3, alive_in=int((st[17] > 0.5).sum()))
    kr.update(compare_planes(k, t))
    kr["records_equal"], kr["records_max_abs_err"] = compare_records(rk, rt)
    need(kr["min_plane_equal"] == 1.0 and min(kr["records_equal"]) == 1.0,
         f"K2 record form at the gradient pass's shape: {kr}")
    # `ms`: whole calls (the wrapper's host work and the launch), as in
    # earlier runs; `kernel_ms`: the launch alone on the card (best_ms);
    # `fill_ms`: the two-kernel fill of the record planes that preceded
    # each launch until the kernel wrote every column itself.
    copies = iter([st.clone() for _ in range(5)])
    kr["ms"] = cuda_ms(lambda: sw.bounce(scene, next(copies), sd, opts, tables, records=rk), 5)
    copies = iter([st.clone() for _ in range(11)])
    kr["kernel_ms"] = best_ms(
        lambda: sw.bounce(scene, next(copies), sd, opts, tables, records=rk), 10)
    kr["fill_ms"] = best_ms(lambda: sw.clear_records(rk), 10)
    smem = mk.block_smem_bytes(scene, tables)
    kr["blocks_per_sm"], kr["threads"] = sw.bounce_occupancy(smem, False,
                                                             scene.krn_big_cull_mode, True)
    live = kr["alive_in"]
    kr.update(bound(live * 144 + (n_rays - live) * 4 + n_rays * nd * 4,
                    live * (tests_per_vertex(scene, scene.n_tri + scene.n_sph) * TEST_FLOPS
                            + VERTEX_FLOPS)))
    out["record_kernel"] = kr
    return out


def phase_inverse_render(diff, golden, RenderOptions):
    """A few Adam steps of inverse_render on the card: the wall albedo from
    0.3 toward the target's 1.0."""
    scene, cam = golden.inward_box_scene(), golden.box_camera()
    opts = RenderOptions(32, 32, 8, 8, max_depth=4)
    target = diff.render_image_diff(scene, cam, opts, 7, 16).detach()
    init = {"mat_diffuse": scene.mat_diffuse.clone()}
    init["mat_diffuse"][1, :3] = 0.3
    sync()
    t0 = time.perf_counter()
    rec, losses = diff.inverse_render(scene, cam, opts, target, init, steps=10,
                                      learning_rate=0.05, spp=8)
    sync()
    res = dict(seconds=time.perf_counter() - t0, losses=[float(v) for v in losses],
               albedo=[float(v) for v in rec["mat_diffuse"][1, :3]])
    need(np.isfinite(losses).all() and losses[-1] < losses[0]
         and min(res["albedo"]) > 0.3, f"inverse_render did not move: {res}")
    return res


def query_rays_phase7(n=QUERY_RAYS):
    """Phase 7's rays (origins uniform in the box, uniform directions) and
    its shadow limits, from the same seed."""
    rng = np.random.default_rng(1)
    o = torch.tensor(rng.uniform(-0.95, 0.95, (n, 3)), dtype=torch.float32, device="cuda")
    d = rng.normal(size=(n, 3))
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True), dtype=torch.float32,
                     device="cuda")
    lim = torch.tensor(rng.uniform(0.05, 1.5, n), dtype=torch.float32, device="cuda")
    return o, d, lim


def first_round_rays(tt, scene, o, d):
    """K6's ray planes in `binned_intersect`'s first round: the rays that
    enter the small partition's box before their dense-part hit, with that
    hit as their bound and no lower bound yet."""
    tables = tt.binned_tables(scene)
    t0, _ = tt._dense_part(scene, o, d, tables)
    entry = tt._root_entry(scene, o, d)
    idx = torch.nonzero((entry >= 0.0) & (entry < t0)).squeeze(1)
    ninf = torch.full((idx.numel(),), float("-inf"), device="cuda")
    return tt.pack_rays(o[idx], d[idx], t0[idx], ninf, ninf)


def bits_equal(a, b):
    return bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def max_err(a, b):
    """Largest |a - b| over the finite entries (0 for none)."""
    e = (a - b).nan_to_num(0.0, 0.0, 0.0).abs()
    return float(e.max()) if e.numel() else 0.0


def check_k6(tt, bounds, rays, m, what):
    ik, ek = tt.candidates(bounds, rays, m)
    sync()
    ip, ep = tt.candidates_reference(bounds, rays, m)
    res = dict(rays=int(rays.shape[1]), m=m, ids_equal=bool(torch.equal(ik, ip)),
               entries_equal=bits_equal(ek, ep), kept=int((ik[:m] >= 0).sum()),
               overflow=int((ik[m] >= 0).sum()),
               max_abs_err=max_err(ek, ep))
    need(res["ids_equal"] and res["entries_equal"], f"K6 {what} disagrees: {res}")
    return res, ik, ek


def check_k7(tt, blocks, pair_rays, offs, what):
    tk, pk = tt.isect(blocks, pair_rays, offs)
    sync()
    tp, pp = tt.isect_reference(blocks, pair_rays, offs)
    n = int(offs[-1])
    res = dict(pairs=n, hits=int((pk[:n] >= 0).sum()), t_equal=bits_equal(tk, tp),
               prim_equal=bool(torch.equal(pk, pp)),
               max_abs_err=max_err(tk[:n], tp[:n]))
    need(res["t_equal"] and res["prim_equal"] and res["hits"] > 0, f"K7 {what} disagrees: {res}")
    return res


def k6_bound(tt, bounds, rays, m):
    """K6's bound on this input: the slab test for each (scanned ray,
    cluster) pair, the insertion only for the pairs that pass the test
    (counted here with the plain version's slab arithmetic)."""
    c = bounds.shape[0]
    cf = torch.arange(c, device=rays.device, dtype=torch.float32)[:, None]
    scanned = passed = 0
    for a in range(0, rays.shape[1], 8192):
        ox, oy, oz, dx, dy, dz, best, t_lo, id_lo = rays[:, a:a + 8192]
        entry, box_ok = tt._slab_entries(bounds, ox, oy, oz, tt._inv_dir(dx), tt._inv_dir(dy),
                                         tt._inv_dir(dz))
        after = (entry > t_lo) | ((entry == t_lo) & (cf > id_lo))
        scan = t_lo < float("inf")  # the kernel skips the other rays
        scanned += int(scan.sum())
        passed += int((box_ok & (entry < best) & after & scan).sum())
    n = rays.shape[1]
    return dict(scanned=scanned, passed=passed,
                **bound(n * (RAY_ROWS_BYTES + 8 * (m + 1)) + c * 32,
                        scanned * c * SLAB_FLOPS + passed * insert_flops(m)))


def k7_bound(tt, blocks, n_pairs, counts):
    """K7's bound from a run's pairs (`counts` [C] per cluster): each pair
    tests only its cluster's triangles (the rows with a prim; padding rows
    are no triangles), and each cluster with pairs is read once."""
    rows = (blocks[..., tt.C_PRIM] >= 0).sum(1).long()
    counts = counts.long()
    tests = int((counts * rows).sum())
    read_rows = int(rows[counts > 0].sum())
    return dict(tests=tests, **bound(n_pairs * (24 + 8) + read_rows * 64, tests * TEST_FLOPS))


def k7_rows(tt, blocks):
    """Where the padding rows of `blocks` sit: per cluster the filled rows,
    the rows K7 tests (up to the last filled 8-row group) and the padding
    rows before that group (tested) and after it (skipped)."""
    filled = blocks[..., tt.C_PRIM] >= 0
    tested = tt.last_filled_groups(blocks).long() * tt.GROUP_ROWS
    n_filled = int(filled.sum())
    rows = int(tested.sum())
    return dict(clusters=int(blocks.shape[0]), cluster_rows=int(blocks.shape[1]),
                filled_rows=n_filled, tested_rows=rows,
                padding_tested=rows - n_filled,
                padding_skipped=int(blocks.shape[0] * blocks.shape[1]) - rows,
                clusters_with_inner_padding=int(((tested > 0) & (
                    filled.sum(1) < tested)).sum()))


def k7_lanes(tt, blocks, offs):
    """K7's lane use on a run's pairs (`offs` [C+1]): a warp tests one
    32-lane slot per 32 of its pairs (a cluster's pairs fill ceil(n / 32)
    slots), over the rows up to its cluster's last filled group; lane-row
    tests executed against the pairs' filled-row tests (the bound's work),
    and the same over every row, as the parent tested them."""
    counts = (offs[1:] - offs[:-1]).long()
    lanes = torch.div(counts + 31, 32, rounding_mode="floor") * 32
    tested = tt.last_filled_groups(blocks).long() * tt.GROUP_ROWS
    work = int((counts * (blocks[..., tt.C_PRIM] >= 0).sum(1).long()).sum())
    lane_tests = int((lanes * tested).sum())
    every_row = int(lanes.sum()) * int(blocks.shape[1])
    return dict(lane_row_tests=lane_tests, every_row_lane_tests=every_row, work_row_tests=work,
                lane_use=work / lane_tests if lane_tests else None,
                every_row_lane_use=work / every_row if every_row else None)


def k6_launches(tt, isw, bounds, k6_inputs, best_ms):
    """Every K6 launch of a frame (`isw.frame_inputs`) on its own input,
    held against the plain version and timed alone, one line each, with
    the lanes a ray the wrapper gives the launch."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for x in k6_inputs:
        rays, m = x["rays"], x["m"]
        what = f"query {x['query']} round {x['round']}"
        res, _, _ = check_k6(tt, bounds, rays, m, what)
        occ = tt.cand_occupancy(m, bounds.shape[0])
        res.update(query=x["query"], round=x["round"], pending=isw.pending(rays),
                   lanes=1 << tt.cand_grid(rays.shape[1], occ, sms)[1],
                   best_ms=best_ms(lambda: tt.candidates(bounds, rays, m), 10),
                   **k6_bound(tt, bounds, rays, m))
        line("16 K6 launch", **{k: res[k] for k in (
            "query", "round", "rays", "pending", "lanes", "best_ms", "bound_ms", "bound_by",
            "ids_equal", "entries_equal")})
        out.append(res)
    return out


def k6_kernel(tt, clusters, n):
    """K6's instance: block, dynamic shared memory (the staged bounds),
    blocks per SM and the lanes a ray of a launch of n rays at m = 1 and
    CAND_M for each cluster count, and its ptxas registers and spills."""
    from cpupathtrace_tpu_torch import _build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = dict(ptxas=_build.ptxas_instances(_build.ptxas_report.get("binned_cand", "")))
    for c in clusters:
        for m in (1, CAND_M):
            occ = tt.cand_occupancy(m, c)
            out[f"m{m} C{c}"] = dict(blocks_per_sm=occ[0], threads=occ[1], smem_bytes=occ[2],
                                     rays=n, lanes=1 << tt.cand_grid(n, occ, sms)[1])
    return out


def phase_binned_kernels(pt, tt, oi, isw, scenes, dragon, best_ms):
    """K6 and K7 against their plain versions (K6 on every launch of a
    wavefront frame), then the whole pipeline against its oracle and
    against K4."""
    o, d, lim = query_rays_phase7()
    c, l = dragon.trv_blocks.shape[0], dragon.trv_blocks.shape[1]
    out = dict(clusters=c, cluster_size=l)
    rays = first_round_rays(tt, dragon, o, d)
    for m in (1, CAND_M):
        out[f"k6_round1_m{m}"], ik, ek = check_k6(tt, dragon.trv_bounds, rays, m, f"m={m}")
    # A later round: the bound advanced past round 1's last valid slot.
    valid = ik[:CAND_M] >= 0
    last = valid.sum(0).clamp_min(1) - 1
    t_lo = torch.where(valid[0], ek.gather(0, last[None])[0], float("inf"))
    id_lo = torch.where(valid[0], ik.gather(0, last[None])[0].float(), float("inf"))
    later = rays.clone()
    later[7], later[8] = t_lo, id_lo
    out["k6_round2"], ik2, _ = check_k6(tt, dragon.trv_bounds, later, CAND_M, "round 2")
    need(out["k6_round2"]["kept"] > 0, "K6's later round kept no candidate")
    pair_rays, offs, _ = tt.bin_pairs(rays, ik, c, CAND_M)
    out["k7_round1"] = check_k7(tt, dragon.trv_blocks, pair_rays, offs, "round 1")
    pair_rays2, offs2, _ = tt.bin_pairs(later, ik2, c, CAND_M)
    out["k7_round2"] = check_k7(tt, dragon.trv_blocks, pair_rays2, offs2, "round 2")
    out["k7_rows"] = k7_rows(tt, dragon.trv_blocks)

    # The main path's shapes: every K6 input of a wavefront frame of the
    # dragon (phase 18's main path, rendered here once more) and the
    # largest K7 input; the largest K6 and K7 inputs timed beside their
    # plain versions. The frame's camera rays end on the box's two-sided
    # front wall, so the dragon is reached from bounce 2 on.
    k6_inputs, (fpairs, foffs), _ = isw.frame_inputs(pt, tt, oi, dragon, scenes.bench_camera())
    out["k6_launches"] = k6_launches(tt, isw, dragon.trv_bounds, k6_inputs, best_ms)
    runs = out["k6_launches"]
    out["k6_frame_launches"] = dict(
        launches=len(runs), rounds_1=sum(r["round"] == 1 for r in runs),
        best_ms_sum=sum(r["best_ms"] for r in runs),
        round1_best_ms_sum=sum(r["best_ms"] for r in runs if r["round"] == 1),
        later_best_ms_sum=sum(r["best_ms"] for r in runs if r["round"] > 1),
        bound_ms_sum=sum(r["bound_ms"] for r in runs))
    largest = max(k6_inputs, key=lambda x: x["rays"].shape[1])
    frays, fm = largest["rays"], largest["m"]
    # `ms`: the mean of 10 whole calls by events, the wrapper's host time
    # in; `best_ms`: the least of 10 calls timed on the card alone
    # (experiments.best_ms), as the microbenchmarks are.
    k6, _, _ = check_k6(tt, dragon.trv_bounds, frays, fm, "at the main path's shape")
    k6["ms"] = cuda_ms(lambda: tt.candidates(dragon.trv_bounds, frays, fm), 10)
    k6["best_ms"] = best_ms(lambda: tt.candidates(dragon.trv_bounds, frays, fm), 10)
    k6["plain_ms"] = cuda_ms(lambda: tt.candidates_reference(dragon.trv_bounds, frays, fm), 1)
    k6.update(k6_bound(tt, dragon.trv_bounds, frays, fm))
    out["k6_frame"] = k6
    # A synthetic table of 2,048 clusters in the dragon's box, on the same
    # rays, at m = 1 and CAND_M.
    synth = isw.synthetic_bounds(dragon)
    for m in (1, CAND_M):
        res, _, _ = check_k6(tt, synth, frays, m, f"2048 clusters, m = {m}")
        res["best_ms"] = best_ms(lambda: tt.candidates(synth, frays, m), 10)
        res.update(k6_bound(tt, synth, frays, m))
        out[f"k6_synthetic_m{m}"] = res
    out["k6_kernel"] = k6_kernel(tt, (dragon.trv_bounds.shape[0], synth.shape[0]),
                                 frays.shape[1])
    k7 = check_k7(tt, dragon.trv_blocks, fpairs, foffs, "at the main path's shape")
    k7["ms"] = cuda_ms(lambda: tt.isect(dragon.trv_blocks, fpairs, foffs), 10)
    k7["best_ms"] = best_ms(lambda: tt.isect(dragon.trv_blocks, fpairs, foffs), 10)
    k7["plain_ms"] = cuda_ms(lambda: tt.isect_reference(dragon.trv_blocks, fpairs, foffs), 1)
    k7.update(k7_bound(tt, dragon.trv_blocks, k7["pairs"], foffs[1:] - foffs[:-1]))
    k7.update(k7_lanes(tt, dragon.trv_blocks, foffs))
    out["k7_frame"] = k7
    from cpupathtrace_tpu_torch import _build

    per_sm, threads, item_pairs = tt.isect_occupancy()
    out["k7_kernel"] = dict(blocks_per_sm=per_sm, threads=threads, item_pairs=item_pairs,
                            ptxas=_build.ptxas_instances(
                                _build.ptxas_report.get("binned_isect", "")))
    need(item_pairs == tt.ITEM_PAIRS, f"K7 built with {item_pairs} pairs an item, the wrapper "
                                      f"cuts {tt.ITEM_PAIRS}")

    # The whole query: against the oracle on a chunk, against K4 on all.
    reads0, rounds0 = tt.binned_intersect.host_reads, tt.binned_intersect.rounds
    tb, pb = tt.binned_intersect(dragon, o, d, m=CAND_M)
    sync()
    out["rounds_per_query"] = tt.binned_intersect.rounds - rounds0
    out["host_reads_per_query"] = tt.binned_intersect.host_reads - reads0
    tr, pr = tt.binned_intersect_ref(dragon, o[:REF_RAYS], d[:REF_RAYS])
    tq, pq = tt.krn_intersect(dragon, o, d)
    out["nearest"] = dict(
        hits=int((pb >= 0).sum()),
        ref_rays=REF_RAYS, ref_prim_equal=float((pb[:REF_RAYS] == pr).float().mean()),
        ref_t_equal=float((tb[:REF_RAYS] == tr).float().mean()),
        k4_prim_equal=float((pb == pq).float().mean()),
        k4_t_equal=float((tb == tq).float().mean()))
    need(out["nearest"]["ref_prim_equal"] == 1.0 and out["nearest"]["k4_prim_equal"] >= K4_AGREE,
         f"binned_intersect (nearest) disagrees: {out['nearest']}")
    live = torch.tensor(np.random.default_rng(5).random(QUERY_RAYS) < 0.5, device="cuda")
    ta, pa = tt.binned_intersect(dragon, o, d, t_max=lim, live=live, any_hit=True, m=CAND_M)
    _, par = tt.binned_intersect_ref(dragon, o[:REF_RAYS], d[:REF_RAYS], t_max=lim[:REF_RAYS])
    _, paq = tt.krn_intersect(dragon, o, d, t_max=lim, live=live, any_hit=True)
    lc = live[:REF_RAYS]
    out["any_hit"] = dict(
        live=int(live.sum()), occluded=int(((pa >= 0) & live).sum()),
        ref_occlusion_equal=float(((pa[:REF_RAYS] >= 0) == (par >= 0))[lc].float().mean()),
        k4_occlusion_equal=float(((pa >= 0) == (paq >= 0))[live].float().mean()),
        hits_within_t_max=bool(((pa < 0) | (ta < lim))[live].all()))
    need(out["any_hit"]["ref_occlusion_equal"] == 1.0 and out["any_hit"]["hits_within_t_max"]
         and out["any_hit"]["k4_occlusion_equal"] >= K4_AGREE,
         f"binned_intersect (any-hit) disagrees: {out['any_hit']}")
    out["query_ms"] = cuda_ms(lambda: tt.binned_intersect(dragon, o, d, m=CAND_M), 3)
    out["k4_query_ms"] = cuda_ms(lambda: tt.krn_intersect(dragon, o, d), 3)
    out["max_abs_err"] = max([out[k]["max_abs_err"] for k in (
        "k6_round1_m1", "k6_round2", "k6_frame", "k6_synthetic_m1", f"k6_synthetic_m{CAND_M}")]
        + [r["max_abs_err"] for r in runs])
    out["k7_max_abs_err"] = max(out[k]["max_abs_err"] for k in ("k7_round1", "k7_round2",
                                                                "k7_frame"))
    return out, (tb, pb)


def k8_bound(tt, blocks, o, ids):
    """K8's bound on a query: its rays (24 bytes each) and candidate ids (8
    a slot) read once, (t, prim) written (12 bytes a slot), each cluster
    with pairs read once; 64 operations a pair and filled row of its
    cluster (the padding rows are no triangles)."""
    c = blocks.shape[0]
    flat = ids.reshape(-1)
    counts = torch.bincount(flat[flat >= 0], minlength=c).long()
    rows = (blocks[..., tt.C_PRIM] >= 0).sum(1).long()
    tests = int((counts * rows).sum())
    read_rows = int(rows[counts > 0].sum())
    return dict(tests=tests, **bound(o.shape[0] * 24 + flat.numel() * 20 + read_rows * 64,
                                     tests * TEST_FLOPS))


def phase_cluster_major(cm, cms, binned, tt, oi, dragon, nearest, best_ms):
    """K8's entry point: its compute stage (csrc/cluster_major.cu, one
    launch, no K7) against its plain version on the stage's pairs and on
    planted ties, timed three ways (whole calls, the stage's card time, the
    work list and launch on the binned pairs), with its host reads, S,
    grid, warps with work, lane use and instance; its result against
    binned_intersect's."""
    from cpupathtrace_tpu_torch import _build

    o, d, _ = query_rays_phase7()
    blocks = cm.cluster_blocks(dragon)
    need(cm.cluster_blocks(dragon) is blocks, "the stage's blocks were packed again")
    ids, _ = binned.generate_candidates(dragon, o, d, CAND_M)
    cm.test_candidates.launches = cm._test_candidates.calls = 0
    tt.isect.launches = tt.isect_reference.calls = 0
    tk, pk = cm.test_candidates(blocks, o, d, ids)
    sync()
    need(cm.test_candidates.launches == 1 and cm._test_candidates.calls == 0
         and tt.isect.launches == tt.isect_reference.calls == 0,
         "K8's compute stage did not launch its own kernel alone")
    tp, pp = cm._test_candidates(blocks, o, d, ids)
    pairs = int((ids >= 0).sum())
    res = dict(pairs=pairs, slots=int(ids.numel()), t_equal=bits_equal(tk, tp),
               prim_equal=bool(torch.equal(pk, pp)), max_abs_err=max_err(tk, tp),
               hits=int((pk >= 0).sum()))
    need(res["t_equal"] and res["prim_equal"], f"K8 disagrees with its plain version: {res}")
    tb_, to_, td_, ti_, prims = cms.planted_ties("cuda")
    tie_order, _, tie_offs = binned.bin_offsets(ti_, tb_.shape[0])
    ties = {}
    for splits in (1, 2, 4):
        t, p = cm.stage_run(tb_, to_, td_, tie_order, tie_offs, ti_.shape[1], splits)
        tpl, ppl = cm._test_candidates(tb_, to_, td_, ti_)
        ties[f"S{splits}"] = dict(prims=p.tolist(), t_equal=bits_equal(t, tpl),
                                  prim_equal=bool(torch.equal(p, ppl)))
        need(p.tolist() == prims and ties[f"S{splits}"]["t_equal"],
             f"K8 on the planted ties at S = {splits}: {ties}")
    res["ties"] = ties
    shape = cm.stage_shape(blocks, ids.numel())
    res.update(shape)
    res.update(cms.stage_figures(tt, blocks, ids, shape["splits"]))
    res["ptxas"] = _build.ptxas_instances(_build.ptxas_report.get("cluster_major", ""))
    # `ms`: whole calls (binning, work list and launch, host time in);
    # `stage_best_ms`: the same on the card alone; `best_ms`: the work list
    # and the launch on the binned pairs (`stage_run`), the span the
    # parent's K8 `best_ms` timed (K7's wrapper on the binned pairs: its
    # output fills, work list and launch).
    order, _, offs = binned.bin_offsets(ids, blocks.shape[0])
    res["ms"] = cuda_ms(lambda: cm.test_candidates(blocks, o, d, ids), 5)
    res["stage_best_ms"] = best_ms(lambda: cm.test_candidates(blocks, o, d, ids), 10)
    res["best_ms"] = best_ms(lambda: cm.stage_run(blocks, o, d, order, offs, CAND_M), 10)
    res["plain_ms"] = cuda_ms(lambda: cm._test_candidates(blocks, o, d, ids), 1)
    res["host_reads"] = cms.host_syncs(lambda: cm.test_candidates(blocks, o, d, ids))
    need(res["host_reads"] == 0, f"K8's stage reads the card from the host: {res['host_reads']}")
    res.update(k8_bound(tt, blocks, o, ids))
    cm.test_candidates.launches = tt.isect.launches = 0
    t8, p8 = cm.binned_intersect_cluster_major(dragon, o, d, CAND_M, blocks)
    sync()
    res["launches"] = cm.test_candidates.launches
    res["k7_launches"] = tt.isect.launches
    need(res["launches"] == 1 and res["k7_launches"] == 0,
         f"K8's entry point: {res['launches']} K8 launches, {res['k7_launches']} K7")
    # K8's entry point intersects the cluster blocks (the small partition)
    # and the spheres, not the big triangles: where binned_intersect's
    # nearest is not a big triangle the two give the same prim, and where
    # it is, K8 finds nothing nearer. Both are exact nearest-hit
    # intersectors, so they may differ only in which of two triangles at
    # exactly the same t they report. On a chunk, K8 against its own
    # oracle, the sweep over the same blocks.
    tb, pb = nearest
    big = torch.isin(pb, dragon.big_prim[dragon.big_prim >= 0].long())
    same = (p8 == pb) | (t8 == tb)
    ts, ps = oi.sweep_intersect(dragon, o[:REF_RAYS], d[:REF_RAYS])
    res.update(entry_small_rays=int((~big).sum()),
               entry_small_agree=float(same[~big].float().mean()),
               entry_small_prim_equal=float((p8 == pb)[~big].float().mean()),
               entry_big_not_nearer=bool(((p8 < 0) | (t8 >= tb))[big].all()),
               sweep_agree=float(((p8[:REF_RAYS] == ps) | (t8[:REF_RAYS] == ts)).float().mean()),
               sweep_prim_equal=float((p8[:REF_RAYS] == ps).float().mean()))
    need(res["entry_small_agree"] == 1.0 and res["entry_big_not_nearer"]
         and res["sweep_agree"] == 1.0 and res["entry_small_rays"] > 1000,
         f"K8's entry point disagrees with binned_intersect: {res}")
    return res


def binned_counts(tt, oi, sw, mk, kt):
    return dict(k6=tt.candidates.launches, k6_plain=tt.candidates_reference.calls,
                k7=tt.isect.launches, k7_plain=tt.isect_reference.calls,
                k5=oi.dense_intersect.launches, k5_plain=oi.dense_intersect_reference.calls,
                k4=kt.cluster_intersect.launches, k4_plain=kt.cluster_intersect_reference.calls,
                k2=sw.bounce.launches, k1=mk.trace_megakernel.launches)


def binned_counts_zero(tt, oi, sw, mk, kt):
    tt.candidates.launches = tt.candidates_reference.calls = 0
    tt.isect.launches = tt.isect_reference.calls = 0
    oi.dense_intersect.launches = oi.dense_intersect_reference.calls = 0
    kt.cluster_intersect.launches = kt.cluster_intersect_reference.calls = 0
    sw.bounce.launches = mk.trace_megakernel.launches = 0


def phase_binned_wavefront(pt, tt, oi, sw, mk, kt, scenes, dragon, lean):
    """renderSceneDragonBox through the binned wavefront (render(), the
    main path of this phase), then the dispatch to it without kernel
    records, then the lean build through K4."""
    opts = pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    camera = scenes.bench_camera()
    out = {}
    os.environ["PTX_NO_MEGAKERNEL"] = "1"
    try:
        binned_counts_zero(tt, oi, sw, mk, kt)
        reads0, rounds0 = tt.binned_intersect.host_reads, tt.binned_intersect.rounds
        sync()
        t0 = time.perf_counter()
        img_w = pt.render(dragon, camera, opts, seed=1, device="cuda")
        sync()
        frames = [time.perf_counter() - t0]
        counts = binned_counts(tt, oi, sw, mk, kt)
        out.update(counts=counts, host_reads=tt.binned_intersect.host_reads - reads0,
                   rounds=tt.binned_intersect.rounds - rounds0)
        for seed in (2, 3):
            sync()
            t0 = time.perf_counter()
            pt.render(dragon, camera, opts, seed=seed, device="cuda")
            sync()
            frames.append(time.perf_counter() - t0)
        out["profile"] = profile_run(
            lambda: pt.render(dragon, camera, opts, seed=7, device="cuda"), "binned_",
            FRAME_KERNELS)
    finally:
        del os.environ["PTX_NO_MEGAKERNEL"]
    c = out["counts"]
    need(c["k6"] > 0 and c["k7"] > 0 and c["k5"] > 0 and c["k6_plain"] == c["k7_plain"]
         == c["k5_plain"] == 0 and c["k2"] == c["k1"] == c["k4"] == 0,
         f"the binned wavefront's main path: {c}")
    need(img_w.shape == (DRAGON_H, DRAGON_W, 4) and np.isfinite(img_w).all()
         and bool((img_w[..., 3] == 1.0).all()), "binned wavefront image")
    img_k = pt.render(dragon, camera, opts, seed=4, device="cuda")  # K2, the sorted driver
    diff_px = img_w[..., :3].mean(-1).astype(np.float64) - img_k[..., :3].mean(-1)
    se = float(diff_px.std() / np.sqrt(diff_px.size))
    n_paths = DRAGON_W * DRAGON_H * DRAGON_SPP
    med = float(np.median(frames))
    out.update(frame_s=frames, frame_median_s=med, mrays_per_s=n_paths / med / 1e6,
               mean_wavefront=float(img_w[..., :3].mean()), mean_k2=float(img_k[..., :3].mean()),
               mean_diff=float(diff_px.mean()), std_err=se)
    need(abs(out["mean_diff"]) <= 4 * se, f"binned wavefront frame differs from K2's: {out}")

    # No kernel records: the scene rebuilt under PTX_KRN_MAX_TRIS below its
    # small count reaches the wavefront by the dispatch alone.
    os.environ["PTX_KRN_MAX_TRIS"] = "1000"
    try:
        bare = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS)
    finally:
        del os.environ["PTX_KRN_MAX_TRIS"]
    need(not bare.has_kernel_records and not mk.megakernel_supported(bare),
         "the scene built under PTX_KRN_MAX_TRIS still has kernel records")
    low = pt.RenderOptions(DRAGON_W, DRAGON_H, 4, 4, epsilon=1e-3, max_depth=MAX_DEPTH)
    binned_counts_zero(tt, oi, sw, mk, kt)
    t0 = time.perf_counter()
    img = pt.render(bare, camera, low, seed=5, device="cuda")
    sync()
    c = binned_counts(tt, oi, sw, mk, kt)
    out["no_records"] = dict(frame_s=time.perf_counter() - t0, counts=c,
                             mean=float(img[..., :3].mean()))
    need(c["k6"] > 0 and c["k7"] > 0 and c["k2"] == c["k1"] == 0 and c["k6_plain"] == 0
         and np.isfinite(img).all(), f"no-records dragon did not take the wavefront: {c}")

    # The lean build (main() built it after phase 7) through the wavefront
    # at the frame's full size: krn_intersect, K4 and K5; timed, then one
    # frame profiled.
    os.environ["PTX_NO_MEGAKERNEL"] = "1"
    try:
        binned_counts_zero(tt, oi, sw, mk, kt)
        sync()
        t0 = time.perf_counter()
        img = pt.render(lean, camera, opts, seed=6, device="cuda")
        sync()
        lean_frames = [time.perf_counter() - t0]
        c = binned_counts(tt, oi, sw, mk, kt)
        for seed in (8, 9):
            sync()
            t0 = time.perf_counter()
            pt.render(lean, camera, opts, seed=seed, device="cuda")
            sync()
            lean_frames.append(time.perf_counter() - t0)
        lean_profile = profile_run(
            lambda: pt.render(lean, camera, opts, seed=10, device="cuda"), "cluster_query",
            FRAME_KERNELS)
    finally:
        del os.environ["PTX_NO_MEGAKERNEL"]
    med = float(np.median(lean_frames))
    # The same frame as the binned wavefront's (another seed): the means
    # within 4 standard errors.
    lean_px = img[..., :3].mean(-1).astype(np.float64) - img_w[..., :3].mean(-1)
    lean_se = float(lean_px.std() / np.sqrt(lean_px.size))
    out["lean"] = dict(frame_s=lean_frames, frame_median_s=med,
                       mrays_per_s=n_paths / med / 1e6, counts=c,
                       mean=float(img[..., :3].mean()), mean_diff=float(lean_px.mean()),
                       std_err=lean_se, profile=lean_profile)
    need(c["k4"] > 0 and c["k5"] > 0 and c["k6"] == c["k7"] == c["k2"] == 0
         and c["k4_plain"] == 0 and np.isfinite(img).all(),
         f"lean dragon through the wavefront: {c}")
    need(abs(out["lean"]["mean_diff"]) <= 4 * lean_se,
         f"lean dragon frame differs from the binned wavefront's: {out['lean']}")
    return out


def phase_dragon_grad(diff, golden, sw, tt, scenes, dragon, RenderOptions):
    """Gradients on the 200k dragon against central differences: the
    wavefront route (the binned wavefront) and the record route (K2)."""
    camera = scenes.bench_camera()
    entries = (("mat_diffuse", (1, 0)), ("mat_emission", (2, 1)))  # box walls, light
    out = {}
    os.environ["PTX_DIFF_MEGAKERNEL"] = "0"
    try:
        tt.candidates.launches = sw.bounce.record_launches = 0
        out["wavefront"] = grad_checks(diff, golden, RenderOptions, dragon, camera, entries)
        out["wavefront"]["k6_launches"] = tt.candidates.launches
        need(tt.candidates.launches > 0 and sw.bounce.record_launches == 0,
             "the dragon's wavefront gradients did not run the binned wavefront")
    finally:
        del os.environ["PTX_DIFF_MEGAKERNEL"]
    sw.bounce.record_launches = 0
    out["record"] = grad_checks(diff, golden, RenderOptions, dragon, camera, entries)
    out["record"]["k2_record_launches"] = sw.bounce.record_launches
    need(sw.bounce.record_launches > 0, "the dragon's record-route gradients did not run K2")
    return out


def phase_k1_binned(mk, sw, scenes, dragon, RenderOptions):
    """K1's binned form against its twin on the dragon frame's camera rays,
    on phase 7's build (56-triangle records) and on the dragon rebuilt with
    PTX_KRN_CLUSTER=128 (lean: the megakernel tables alone)."""
    opts = RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                         max_depth=MAX_DEPTH)
    rays, _ = camera_state(sw, scenes.bench_camera(device="cuda"), opts, DRAGON_SPP, 21)
    out = k1_binned_run(mk, dragon, rays, opts)
    old = os.environ.get("PTX_KRN_CLUSTER")
    os.environ["PTX_KRN_CLUSTER"] = K1B_WIDE_CLUSTER
    try:
        t0 = time.perf_counter()
        wide = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, lean=True, device="cuda")
        build_s = time.perf_counter() - t0
    finally:
        os.environ.pop("PTX_KRN_CLUSTER")
        if old is not None:
            os.environ["PTX_KRN_CLUSTER"] = old
    rows = int(K1B_WIDE_CLUSTER)
    need(wide.krn_cluster_size == rows and wide.krn_records.shape[1] == rows,
         f"PTX_KRN_CLUSTER={rows} did not reach the records: {tuple(wide.krn_records.shape)}")
    out[f"cluster{rows}"] = dict(build_s=build_s, records=list(wide.krn_records.shape),
                                 ms_at_56=out["ms"], **k1_binned_run(mk, wide, rays, opts))
    return out


def k1_binned_run(mk, dragon, rays, opts, whole_chunk_plain=True):
    """K1's binned form against its twin on `rays`: the first
    K1B_CHECK_RAYS bit-equal with equal counters; the whole chunk timed,
    counted and (with `whole_chunk_plain`; else the plain version's time
    is the subset's) held against the twin at the K1 bounds."""
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    n = int(rays.origin.shape[0])
    tables = mk.pack_tables(dragon)
    sub = type(rays)(rays.origin[:K1B_CHECK_RAYS].contiguous(),
                     rays.direction[:K1B_CHECK_RAYS].contiguous())
    k, kc, kv = mk.trace_megakernel(dragon, sub, opts, 21, tables, debug_visits=True)
    sync()
    t0 = time.perf_counter()
    t, tc, tv = mk.trace_megakernel_reference(dragon, sub, opts, 21, tables, debug_visits=True)
    sync()
    subset_plain_ms = (time.perf_counter() - t0) * 1e3
    out = dict(check_rays=K1B_CHECK_RAYS, rays=n,
               spectrum_bit_equal=float((k.view(torch.int32) == t.view(torch.int32))
                                        .all(1).float().mean()),
               collected_equal=bool(torch.equal(kc, tc)), counters_equal=bool(torch.equal(kv, tv)),
               counters=kv.sum(0).tolist(), max_abs_err=max_err(k, t))
    need(out["spectrum_bit_equal"] == 1.0 and out["collected_equal"] and out["counters_equal"],
         f"K1's binned form disagrees with its twin: {out}")
    # The whole chunk: the main path's shape. The binned form's output
    # starts as NaN, so a ray its refilling warps missed shows.
    spec, _ = mk.trace_megakernel(dragon, rays, opts, 21, tables)
    sync()
    need(not bool(torch.isnan(spec).any()), "K1's binned form left rays unwritten (NaN)")
    out["ms"] = cuda_ms(lambda: mk.trace_megakernel(dragon, rays, opts, 21, tables), 3)
    steps = torch.zeros(kt.WARP_STEP_COLS, dtype=torch.int64, device="cuda")
    _, _, vis = mk.trace_megakernel(dragon, rays, opts, 21, tables, debug_visits=True,
                                    warp_steps=steps)
    sync()
    out["walk"] = walk_figures(kt, dragon, tables, vis, steps, "megakernel_binned")
    out["row_lane_use"], out["slab_lane_use"] = row_lane_use(out)
    flops, counts = traversal_flops(vis)
    rb = ray_bounces(vis)
    out.update(ray_bounces=rb, counts=counts,
               **bound(n * (24 + 16), flops + rb * vertex_flops(dragon)))
    out.update(plain_ms=subset_plain_ms, plain_rays=K1B_CHECK_RAYS)
    if whole_chunk_plain:
        t0 = time.perf_counter()
        tspec, _ = mk.trace_megakernel_reference(dragon, rays, opts, 21, tables)
        sync()
        out.update(plain_ms=(time.perf_counter() - t0) * 1e3, plain_rays=n)
        out["chunk"] = compare(spec, tspec)
        check_agreement("K1's binned form on the whole chunk", out["chunk"])
        out["max_abs_err"] = max(out["max_abs_err"], out["chunk"]["max_abs_err"])
    return out


def render_frames(pt, scene, camera, opts, flag, seeds):
    """Frames of `seeds` through render() under PTX_SORTED_WAVEFRONT=flag
    (None: unset): (images, seconds each)."""
    old = os.environ.pop("PTX_SORTED_WAVEFRONT", None)
    if flag is not None:
        os.environ["PTX_SORTED_WAVEFRONT"] = flag
    try:
        images, secs = [], []
        for seed in seeds:
            sync()
            t0 = time.perf_counter()
            images.append(pt.render(scene, camera, opts, seed=seed, device="cuda"))
            sync()
            secs.append(time.perf_counter() - t0)
    finally:
        os.environ.pop("PTX_SORTED_WAVEFRONT", None)
        if old is not None:
            os.environ["PTX_SORTED_WAVEFRONT"] = old
    return images, secs


def mean_gap(img_a, img_b):
    """Mean per-pixel difference of two frames and its standard error."""
    diff = img_a[..., :3].mean(-1).astype(np.float64) - img_b[..., :3].mean(-1)
    return float(diff.mean()), float(diff.std() / np.sqrt(diff.size))


def phase_dragon_k1_frame(pt, sw, mk, scenes, dragon):
    """renderSceneDragonBox through render() with PTX_SORTED_WAVEFRONT=0 (K1's
    binned form, this phase's main path) beside the default sorted driver,
    in turns; K2's bound over one counted sorted frame."""
    opts = pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    camera = scenes.bench_camera()
    n_paths = DRAGON_W * DRAGON_H * DRAGON_SPP
    routes = {"k1": "0", "sorted": None}
    out = {name: {} for name in routes}
    first = {}
    for name, flag in routes.items():
        mk.trace_megakernel.launches = sw.bounce.launches = 0
        mk.trace_megakernel_reference.calls = sw.bounce_reference.calls = 0
        sw.trace_megakernel_sorted.host_reads = 0
        images, secs = render_frames(pt, dragon, camera, opts, flag, [30])
        sync()
        out[name].update(first_frame_s=secs[0], launches=dict(
            k1=mk.trace_megakernel.launches, k2=sw.bounce.launches,
            k1_twin=mk.trace_megakernel_reference.calls, k2_twin=sw.bounce_reference.calls),
            host_reads=sw.trace_megakernel_sorted.host_reads)
        first[name] = images[0]
    c1, c2 = out["k1"]["launches"], out["sorted"]["launches"]
    need(c1["k1"] > 0 and c1["k2"] == c1["k1_twin"] == c1["k2_twin"] == 0,
         f"PTX_SORTED_WAVEFRONT=0: the dragon frame did not run K1's binned form alone: {c1}")
    need(c2["k2"] > 0 and c2["k1"] == c2["k1_twin"] == c2["k2_twin"] == 0,
         f"the default dragon frame did not run the sorted driver alone: {c2}")
    # Timed frames in turns: K1, sorted, sorted, K1, K1, sorted.
    for order, seed in zip(("k1", "sorted", "sorted", "k1", "k1", "sorted"), range(31, 37)):
        _, secs = render_frames(pt, dragon, camera, opts, routes[order], [seed])
        out[order].setdefault("frame_s", []).extend(secs)
    for name, img in first.items():
        need(img.shape == (DRAGON_H, DRAGON_W, 4) and np.isfinite(img).all()
             and bool((img[..., 3] == 1.0).all()), f"{name} dragon frame")
        med = float(np.median(out[name]["frame_s"]))
        out[name].update(frame_median_s=med, mrays_per_s=n_paths / med / 1e6,
                         mean=float(img[..., :3].mean()))
    out["mean_diff"], out["std_err"] = mean_gap(first["k1"], first["sorted"])
    need(abs(out["mean_diff"]) <= 4 * out["std_err"],
         f"K1's binned frame differs from the sorted driver's: {out}")
    os.environ["PTX_SORTED_WAVEFRONT"] = "0"
    try:
        out["k1"]["profile"] = profile_run(
            lambda: pt.render(dragon, camera, opts, seed=37, device="cuda"), "megakernel")
    finally:
        del os.environ["PTX_SORTED_WAVEFRONT"]
    # One counted sorted frame: K2's work over all its bounces.
    rays, _ = camera_state(sw, scenes.bench_camera(device="cuda"), opts, DRAGON_SPP, 38)
    _, _, vis = sw.trace_megakernel_sorted(dragon, rays, opts, 38, debug_visits=True)
    entering = [a for a in (ray_bounces(v) for v in vis) if a > 0]
    flops, counts = traversal_flops(vis)
    frame_bound = bound(sum(a * 144 + (n_paths - a) * 4 for a in entering),
                        flops + sum(entering) * vertex_flops(dragon))
    out["sorted"]["k2_frame"] = dict(bounces=len(entering), ray_bounces=sum(entering),
                                     counts=counts, **frame_bound)
    return out


def phase_box_sorted(pt, sw, mk, scenes):
    """The box (phase 5's frame) through the sorted driver with
    PTX_SORTED_WAVEFRONT=1 (K2's dense form) against K1's frame."""
    opts = pt.RenderOptions(BOX_W, BOX_H, BOX_SPP, BOX_SPP, epsilon=1e-3, max_depth=MAX_DEPTH)
    scene, camera = scenes.bench_box_scene(), scenes.bench_camera()
    mk.trace_megakernel.launches = sw.bounce.launches = sw.bounce_reference.calls = 0
    images, secs = render_frames(pt, scene, camera, opts, "1", [40, 41, 42])
    counts = dict(k2=sw.bounce.launches, k1=mk.trace_megakernel.launches,
                  k2_twin=sw.bounce_reference.calls)
    need(counts["k2"] > 0 and counts["k1"] == counts["k2_twin"] == 0,
         f"PTX_SORTED_WAVEFRONT=1: the box did not run the sorted driver alone: {counts}")
    k1_images, k1_secs = render_frames(pt, scene, camera, opts, None, [43])
    img = images[0]
    need(np.isfinite(img).all() and bool((img[..., 3] == 1.0).all()), "sorted box frame")
    mean_diff, se = mean_gap(img, k1_images[0])
    out = dict(counts=counts, frame_s=secs, frame_median_s=float(np.median(secs)),
               k1_frame_s=k1_secs[0], mean_sorted=float(img[..., :3].mean()),
               mean_k1=float(k1_images[0][..., :3].mean()), mean_diff=mean_diff, std_err=se)
    need(abs(mean_diff) <= 4 * se, f"the sorted box frame differs from K1's: {out}")
    return out


def phase_experiments(ss, rv, smt, cf, df, best_ms):
    """X1-X5: each kernel against its plain version on check inputs whose
    output depends on the work, then the TPU script's sweep on the script's
    inputs (the microbenchmarks' own main path: counts zeroed just before,
    read just after)."""
    out = {}
    big = dict(sp=max(ss.SWEEP_SP), rows=max(ss.SWEEP_ROWS), n_iter=max(ss.SWEEP_ITERS))
    checked = {}
    for half_cta in (False, True):
        for sp in ss.SWEEP_SP:
            xc_np, bc_np = ss.check_inputs(sp, half_cta)
            xc, bc = torch.from_numpy(xc_np).cuda(), torch.from_numpy(bc_np).cuda()
            for rows in ss.SWEEP_ROWS:
                n_iter = big["n_iter"] if (sp, rows) == (big["sp"], big["rows"]) else 3
                ko, ke = ss.supscan(bc, xc, n_iter, rows, entries=True)
                po, pe = ss.supscan_reference(bc, xc, n_iter, rows, entries=True)
                acc = (ko.reshape(ss.BLOCKS, 8, 128)
                       - xc.reshape(ss.BLOCKS, ss.X_ROWS, 128)[:, :8])[:, 0, 0]
                res = dict(n_iter=n_iter, blocks_counting=int((acc > 0.5).sum()),
                           finite_entries=int(torch.isfinite(ke).sum()),
                           max_abs_err=max_err(ko, po),
                           **ss.layout(rows, sp))
                name = f"{'half_cta ' if half_cta else ''}sp{sp}_rows{rows}"
                need(torch.equal(ko, po) and torch.equal(ke, pe)
                     and 0 < res["blocks_counting"] < ss.BLOCKS and res["finite_entries"] > 0
                     and res["ctas"] == ss.CTAS and res["resident_clusters"] >= ss.BLOCKS,
                     f"X1 differs from its plain version on {name}: {res}")
                checked[name] = res
    xb_np, bb_np = ss.check_inputs(big["sp"])
    xb, bb = torch.from_numpy(xb_np).cuda(), torch.from_numpy(bb_np).cuda()
    ss.supscan.launches = 0
    x1 = dict(check=checked, sweep=ss.sweep())
    x1["launches"] = ss.supscan.launches
    x1["ms"] = min(r["ms"][big["n_iter"]] for r in x1["sweep"]
                   if r["sp"] == big["sp"] and r["rows"] == big["rows"])
    x1["plain_ms"] = cuda_ms(
        lambda: ss.supscan_reference(bb, xb, big["n_iter"], big["rows"]), 1)
    x1["max_abs_err"] = max(r["max_abs_err"] for r in checked.values())
    x1["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    x1.update(config=big, **bound(xb.numel() * 4 + bb.numel() * 4 + ss.BLOCKS * 8 * 128 * 4,
                                  ss.slab_ops(big["sp"], big["rows"], big["n_iter"])))
    out["supscan"] = x1

    out["record_variants"] = phase_record_variants(rv)

    # X5 in every check configuration, every staging instance, both launch
    # shapes (K1's, one block per tile, and the persistent grid).
    x5_check = {}
    for name, (xs, tbl, threads) in smt.check_configurations("cuda").items():
        for staging in smt.STAGINGS:
            for shape, blocks in (("k1_shape", None),
                                  ("persistent", smt.resident_blocks(xs, tbl, threads, staging))):
                ko, kst = smt.smem_tables(xs, tbl, threads, staged=True, blocks=blocks,
                                          staging=staging)
                po, pst = smt.smem_tables_reference(xs, tbl, threads, staged=True, blocks=blocks)
                res = dict(moved=float((po != xs).float().mean()), blocks=kst.shape[0],
                           staged_floats=kst.shape[1], max_abs_err=max_err(ko, po))
                need(torch.equal(ko, po) and torch.equal(kst, pst)
                     and (res["moved"] > 0.99 or not tbl),
                     f"X5 {name} ({staging}, {shape}) differs from its plain version: {res}")
                x5_check[f"{name}_{staging}_{shape}"] = res
    xk, tk, thk = smt.check_configurations("cuda")["k1_box_tables"]
    smt.smem_tables.launches = 0
    x5 = dict(check=x5_check, sweep=smt.sweep())
    x5["launches"] = smt.smem_tables.launches
    sw5 = x5["sweep"]
    x5.update(ms=sw5["k1_bulk"]["ms"], k1_staging_ms=sw5["k1_rows"]["ms"],
              persistent_ms=sw5["k1_bulk_persistent"]["ms"],
              k1_staging_persistent_ms=sw5["k1_rows_persistent"]["ms"],
              persistent_blocks=sw5["k1_bulk_persistent"]["blocks"],
              blocks_per_sm=sw5["k1_bulk_persistent"]["blocks_per_sm"],
              no_tables_ms=sw5["k1_no_tables"]["ms"], k1_shape_blocks=sw5["k1_bulk"]["blocks"],
              max_abs_err=max(r["max_abs_err"] for r in x5_check.values()),
              plain_ms=best_ms(lambda: smt.smem_tables_reference(xk, tk, thk), 5),
              library_ms=sw5["torch_add"]["ms"], library="torch.add(x, s)",
              card=nvidia_smi_name_power(),
              **bound(sw5["k1_bulk"]["bytes"], xk.numel()))
    out["smem_tables"] = x5
    out["cond_fat"] = phase_cond_fat(cf, best_ms)
    out["dot_formulations"] = phase_dot_formulations(df, best_ms)
    return out


def phase_record_variants(rv):
    """X3 on the script's inputs and on the near inputs (row 0 1e-5 in front
    of its triangles), every variant at the wrapper's grid: held to its
    plain version (`rv.check`: rtol 1e-6 / 1e-5, the matmul variants' near
    row 0 within `rv.near_bound` of the float64 plain version) with the
    ray-record counts equal to the formula; the extraction moving row 0 of
    the near inputs by the plain versions' corrections (`rv.extraction`)
    and nothing else; each variant again with more chunks
    than record tests (empty blocks); then the 256-test timing and the
    sweep (counts zeroed just before, read just after)."""
    x3 = {}
    inputs = {"script": rv.inputs(), "near": rv.check_inputs()}
    for inp, (tables, rays_np) in inputs.items():
        rays = torch.from_numpy(rays_np).cuda()
        for v in rv.VARIANTS:
            table = torch.from_numpy(tables[v]).cuda()
            blocks, chunks = rv.record_grid(v, X3_CHECK_RECORDS)
            _, res = rv.check(v, table, rays, X3_CHECK_RECORDS, near=inp == "near")
            _, few = rv.check(v, table, rays, X3_FEW_RECORDS, near=inp == "near",
                              chunks=X3_FEW_CHUNKS)
            res.update(blocks=blocks, chunks=chunks, few_records=few)
            x3.setdefault(v, {})[inp] = res
        # On the script's inputs the corrections are below an ulp: row 0 then
        # has matmul's bits (its products and test are matmul's code).
        x3["matmul_extract"][inp]["extraction"] = rv.extraction(
            torch.from_numpy(tables["matmul"]).cuda(), rays, X3_CHECK_RECORDS, near=inp == "near")
    tables, rays_np = inputs["script"]
    rays = torch.from_numpy(rays_np).cuda()
    for v in rv.VARIANTS:
        table = torch.from_numpy(tables[v]).cuda()
        k = rv.record_variant(v, table, rays, X3_CHECK_RECORDS)
        sync()
        t0 = time.perf_counter()
        p = rv.variant_reference(v, table, rays, X3_CHECK_RECORDS)
        sync()
        ops, kind = rv.record_ops(v, X3_CHECK_RECORDS)
        x3[v].update(records=X3_CHECK_RECORDS, max_abs_err=max_err(k, p),
                     plain_ms=(time.perf_counter() - t0) * 1e3,
                     ms=cuda_ms(lambda: rv.record_variant(v, table, rays, X3_CHECK_RECORDS), 3),
                     occupancy=rv.occupancy(v),
                     **bound(table.numel() * 4 + rays.numel() * 4 + 1024 * 4,
                             (ops if kind == "fp32" else 0) +
                             rv.epilogue_ops(v, X3_CHECK_RECORDS),
                             ops if kind == "tf32" else 0))
    for v in rv.VARIANTS:
        rv.record_variant.launches[v] = 0
    sweep = rv.sweep()
    for v in rv.VARIANTS:
        x3[v].update(sweep=sweep[v], launches=rv.record_variant.launches[v],
                     best_ms=sweep[v]["check_ms"])
    return dict(variants=x3)


def phase_cond_fat(cf, best_ms):
    """X2 bit-equal to its plain version on the check inputs at X2_ITERS
    iterations, outputs and per-tile update counts, in all four instances
    (tiles that take and tiles that skip the updates), each at its layout
    (threads a CTA, CTAs a tile, all 64 tiles resident at once); then the
    script's sweep."""
    x = torch.from_numpy(cf.check_inputs()).cuda()
    checked = {}
    for n_live in cf.SWEEP_LIVE:
        for use_cond in cf.SWEEP_COND:
            name = cf.instance(n_live, use_cond)
            ko, kc = cf.cond_fat(x, X2_ITERS, n_live, use_cond, taken=True)
            sync()
            t0 = time.perf_counter()
            po, pc = cf.cond_fat_reference(x, X2_ITERS, n_live, use_cond, taken=True)
            sync()
            want = cf.expected_taken(x.cpu(), X2_ITERS, use_cond)
            res = dict(plain_ms=(time.perf_counter() - t0) * 1e3, max_abs_err=max_err(ko, po),
                       tiles_taking=int((kc > 0).sum()),
                       zero_tile_out=float(ko.reshape(cf.BLOCKS, -1)[0, 0]),
                       **cf.layout(n_live, use_cond))
            need(torch.equal(ko.view(torch.int32), po.view(torch.int32)) and torch.equal(kc, pc)
                 and bool((kc.cpu().numpy() == want).all())
                 and (0 < res["tiles_taking"] < cf.BLOCKS or not use_cond)
                 and res["resident_tiles"] >= cf.BLOCKS,
                 f"X2 {name} differs from its plain version: {res}")
            checked[name] = res
    for name in cf.INSTANCES:
        cf.cond_fat.launches[name] = 0
    sweep = cf.sweep()
    out = {}
    for r in sweep:
        name = cf.instance(r["n_live"], r["use_cond"])
        out[name] = dict(checked[name], sweep=r, launches=cf.cond_fat.launches[name],
                         ms=r["ms"][X2_ITERS], n_iter=X2_ITERS,
                         **bound(2 * x.numel() * 4,
                                 cf.cond_fat_ops(r["n_live"], r["use_cond"], X2_ITERS)))
    return out


def phase_dot_formulations(df, best_ms):
    """X4 on the script's inputs (seeds 0 and 1) and on the tie inputs: fma
    bit-equal to its plain version in C, R and X; the TF32 forms within TOL_REL of sum_k |B A| of
    their emulation; every form's R and X exactly the min and first argmin
    of its own C; the script's error figures (fma and 3xtf32 held to
    float32, tf32 reported); on the tie inputs the first of two rows
    holding a column's minimum (-0.0 / +0.0, equal negatives, in other
    warps and in one thread). Then the sweep, which times each form beside
    the one-call library yardstick torch.matmul(B.T, A) (C only, full
    float32)."""
    out = {f: dict(check={}) for f in df.FORMS}
    for case in (0, 1, "ties"):
        inputs = df.tie_inputs() if case == "ties" else df.script_inputs(case)
        b, a, e = (torch.from_numpy(v).cuda() for v in inputs)
        for form in df.FORMS:
            c, r, x = df.dot_formulation(form, b, a, e)
            pc, pr, px = df.dot_reference(form, b, a, e)
            errs = df.script_errors(b, a, e, c, r, x)
            res = dict(max_abs_err=max(max_err(c, pc), max_err(r, pr)),
                       own_argmin=df.self_check(c, r, x, e),
                       x_equal_plain=bool(torch.equal(x, px)), **errs)
            ok = res["own_argmin"] and (
                torch.equal(c, pc) and torch.equal(r, pr) and res["x_equal_plain"]
                if form == "fma" else df.within_tolerance(c, pc, b, a))
            if form != "tf32":
                ok = ok and errs["matmul_rel_err"] < 1e-6 and errs["extract_err"] == 0.0
            if case == "ties":
                res["ties_hold"] = df.ties_hold(r, x, e)
                ok = ok and res["ties_hold"]
            need(ok, f"X4 {form} ({case}) differs from its plain version: {res}")
            out[form]["check"][f"seed{case}" if case != "ties" else case] = res
    b, a, e = (torch.from_numpy(v).cuda() for v in df.script_inputs(0))
    for form in df.FORMS:
        df.dot_formulation.launches[form] = 0
    sweep = df.sweep()
    for form in df.FORMS:
        ops, kind = df.dot_ops(form)
        out[form].update(sweep=sweep[form], launches=df.dot_formulation.launches[form],
                         ms=sweep[form]["ms"],
                         plain_ms=best_ms(lambda form=form: df.dot_reference(form, b, a, e), 5),
                         library_ms=sweep[form]["library_ms"],
                         library="torch.matmul(B.T, A), C only",
                         max_abs_err=max(v["max_abs_err"] for v in out[form]["check"].values()),
                         card=nvidia_smi_name_power(),
                         **bound(df.io_bytes(), ops if kind == "fp32" else 0,
                                 ops if kind == "tf32" else 0))
    return out


def phase_dragon_full_cache(scenes, cache_mod, cache_dir, packed):
    """renderSceneDragonBoxFull's scene (7.2M triangles, lean) through the
    scene cache in a fresh directory: the cold miss (build stages, save,
    file size, the C++ host pipeline's runs beside the numpy route's stage
    seconds), then the hit (load_scene through the pinned buffers), every
    field of the loaded scene equal to the built one on the card. The cold
    build's C++ pack (its cluster arrays and records) goes to `packed`."""
    from cpupathtrace_tpu_torch import native
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
    from cpupathtrace_tpu_torch.accel.build import build_bvh
    from cpupathtrace_tpu_torch.integrator.megakernel import megakernel_supported
    from cpupathtrace_tpu_torch.scene.scene import BUILD_SECONDS

    need(not os.path.exists(cache_dir), f"{cache_dir} exists: the miss would not be cold")
    runs0 = dict(build_bvh.runs)
    native0 = dict(native.runs)
    pack = kt.pack_pair_records_native

    def capture(*args, out):
        packed.update(args=args, out=out)
        return pack(*args, out=out)

    BUILD_SECONDS.clear()
    kt.pack_pair_records_native = capture
    try:
        t0 = time.perf_counter()
        built, hit = scenes.dragon_full_scene(cache_dir, device="cuda")
        miss_s = time.perf_counter() - t0
    finally:
        kt.pack_pair_records_native = pack
    need(not hit, "the 7.2M build hit a cache in a fresh directory")
    routes = {k: native.runs[k] - native0[k] for k in native0}
    need(routes["mesh_pipeline"] >= 1 and routes["pack_pair_records"] == 1 and "out" in packed,
         f"the 7.2M cold build did not run the C++ mesh pipeline and packer: {routes}")
    steps = dict(cache_mod.cached_build.seconds)
    files = os.listdir(cache_dir)
    need(len(files) == 1 and files[0].endswith(cache_mod.SUFFIX), f"cache files {files}")
    nbytes = os.path.getsize(os.path.join(cache_dir, files[0]))
    need(built.n_tri >= scenes.DRAGON_FULL_TRIS * 0.99 and built.lean
         and built.krn_cluster_size == 128 and built.accel == "binned",
         f"not the lean 7.2M build: {built.n_tri} triangles, lean {built.lean}, "
         f"{built.krn_cluster_size} rows, {built.accel}")
    need(megakernel_supported(built), "megakernel_supported refuses the 7.2M scene")
    out = dict(n_tri=built.n_tri, n_big=built.n_big, miss_s=miss_s, stages_s=dict(BUILD_SECONDS),
               host_routes=dict(mesh="native", pack="native", native_runs=routes),
               numpy_stages_s=NUMPY_STAGES_S,
               cache_steps_s=steps, file_gb=nbytes / 1e9,
               bvh_builder_runs={k: build_bvh.runs[k] - runs0[k] for k in runs0},
               records=list(built.krn_records.shape), cl_bounds=list(built.krn_cl_bounds.shape),
               sup_bounds=list(built.krn_sup_bounds.shape),
               hyp_bounds=list(built.krn_hyp_bounds.shape),
               record_gb=built.krn_records.numel() * 4 / 1e9,
               cull_modes=[built.krn_cull_mode, built.krn_big_cull_mode])
    # The hit, first with the file's pages dropped from the page cache
    # (written back, then POSIX_FADV_DONTNEED: the disk's read), then again
    # with them cached.
    path = os.path.join(cache_dir, files[0])
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    for reading in ("hit", "hit_page_cached"):
        sync()
        t0 = time.perf_counter()
        loaded, hit = scenes.dragon_full_scene(cache_dir, device="cuda")
        sync()
        load_s = time.perf_counter() - t0
        need(hit, "a second 7.2M call missed the cache")
        out.update({f"{reading}_s": load_s, f"{reading}_gb_per_s": nbytes / 1e9 / load_s})
    unequal = []
    for f in dataclasses.fields(built):
        a, b = getattr(built, f.name), getattr(loaded, f.name)
        if isinstance(a, torch.Tensor):
            if not (b.device.type == "cuda" and a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a.reshape(-1).view(torch.uint8),
                                    b.reshape(-1).view(torch.uint8))):
                unequal.append(f.name)
        elif a != b:
            unequal.append(f.name)
    need(not unequal, f"the loaded 7.2M scene differs from the built one in {unequal}")
    out["fields_equal"] = len(dataclasses.fields(built))
    return loaded, out


def tiers_where(kt, scene):
    """'staged' when K1's and K2's blocks stage the scene's hyper and
    supercluster boxes in shared memory, 'global' when the tiers exceed
    the layouts' tier_floats and are read from global memory."""
    n_pages = scene.krn_sup_bounds.shape[0]
    where = {lib: "staged" if kt.tier_floats(n_pages, kt.walk_layout(lib)) else "global"
             for lib in ("megakernel", "bounce")}
    need(len(set(where.values())) == 1, f"K1 and K2 stage the tiers differently: {where}")
    floats = n_pages * (kt.BND_COLS + kt.GROUP2 * kt.BND_COLS)
    return dict(tiers=where["bounce"], tier_floats=floats,
                tier_floats_staged_max=kt.walk_layout("bounce").tier_floats)


def k2_sorted_run(sw, mk, kt, scene, rays, opts, n_paths):
    """K2 through the sorted driver against the twin's driver on the first
    K1B_CHECK_RAYS rays (spectrum bit-equal, per-bounce counters equal);
    then on the frame's rays K2's launches timed by CUDA events, the frame's
    bound from its counters and the walk's figures."""
    tables = mk.pack_tables(scene)
    sub = type(rays)(rays.origin[:K1B_CHECK_RAYS].contiguous(),
                     rays.direction[:K1B_CHECK_RAYS].contiguous())
    k, kc, kv = sw.trace_megakernel_sorted(scene, sub, opts, 21, tables, debug_visits=True)
    sync()
    t0 = time.perf_counter()
    t, tc, tv = sw.trace_megakernel_sorted(scene, sub, opts, 21, tables, reference=True,
                                           debug_visits=True)
    sync()
    out = dict(check_rays=K1B_CHECK_RAYS, plain_ms=(time.perf_counter() - t0) * 1e3,
               plain_rays=K1B_CHECK_RAYS,
               spectrum_bit_equal=float((k.view(torch.int32) == t.view(torch.int32))
                                        .all(1).float().mean()),
               collected_equal=bool(torch.equal(kc, tc)), counters_equal=bool(torch.equal(kv, tv)),
               max_abs_err=max_err(k, t))
    need(out["spectrum_bit_equal"] == 1.0 and out["collected_equal"] and out["counters_equal"],
         f"K2 disagrees with its twin on the 7.2M scene: {out}")
    sw.trace_megakernel_sorted(scene, rays, opts, 3, tables)
    timing: dict = {}
    spec, _ = sw.trace_megakernel_sorted(scene, rays, opts, 3, tables, timing=timing)
    sync()
    need(bool(torch.isfinite(spec).all()), "K2's 7.2M chunk has non-finite values")
    steps = torch.zeros(kt.WARP_STEP_COLS, dtype=torch.int64, device="cuda")
    _, _, vis = sw.trace_megakernel_sorted(scene, rays, opts, 3, tables, debug_visits=True,
                                           warp_steps=steps)
    sync()
    frame = frame_bound(vis, n_paths, scene)
    frame.update(walk_figures(kt, scene, tables, vis, steps, "bounce_binned_kernel"))
    out.update(bounces=len(timing["bounce_ms"]), bounce_ms=timing["bounce_ms"],
               sort_gather_ms=timing["sort_ms"], ms=sum(timing["bounce_ms"]), frame=frame,
               bound_ms=frame["bound_ms"], bound_by=frame["bound_by"])
    return out


def phase_dragon_full_frames(pt, sw, mk, kt, scenes, full):
    """renderSceneDragonBoxFull (128x128 @ 16 spp, max_depth 40) through
    render(): the default dispatch (the sorted driver, K2) and
    PTX_SORTED_WAVEFRONT=0 (K1's binned form), launches counted on a first
    frame each, then three timed frames each in turns; both kernels against
    their twins on 16,384 of the frame's camera rays, their card time on
    the frame's rays by CUDA events, bounds from the counters, one profiled
    frame each, the two routes' means within 4 standard errors."""
    opts = pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    camera = scenes.bench_camera()
    n_paths = DRAGON_W * DRAGON_H * DRAGON_SPP
    routes = {"sorted": None, "k1": "0"}
    out = {name: {} for name in routes}
    out.update(tiers_where(kt, full))
    first = {}
    for name, flag in routes.items():
        mk.trace_megakernel.launches = sw.bounce.launches = 0
        mk.trace_megakernel_reference.calls = sw.bounce_reference.calls = 0
        images, secs = render_frames(pt, full, camera, opts, flag, [50])
        sync()
        out[name].update(first_frame_s=secs[0], launches=dict(
            k1=mk.trace_megakernel.launches, k2=sw.bounce.launches,
            k1_twin=mk.trace_megakernel_reference.calls, k2_twin=sw.bounce_reference.calls))
        first[name] = images[0]
    c1, c2 = out["k1"]["launches"], out["sorted"]["launches"]
    need(c1["k1"] > 0 and c1["k2"] == c1["k1_twin"] == c1["k2_twin"] == 0,
         f"PTX_SORTED_WAVEFRONT=0: the 7.2M frame did not run K1's binned form alone: {c1}")
    need(c2["k2"] > 0 and c2["k1"] == c2["k1_twin"] == c2["k2_twin"] == 0,
         f"the default 7.2M frame did not run the sorted driver alone: {c2}")
    for order, seed in zip(("k1", "sorted", "sorted", "k1", "k1", "sorted"), range(51, 57)):
        _, secs = render_frames(pt, full, camera, opts, routes[order], [seed])
        out[order].setdefault("frame_s", []).extend(secs)
    for name, img in first.items():
        need(img.shape == (DRAGON_H, DRAGON_W, 4) and np.isfinite(img).all()
             and bool((img[..., 3] == 1.0).all()), f"{name} 7.2M frame")
        med = float(np.median(out[name]["frame_s"]))
        mrays = n_paths / med / 1e6
        out[name].update(frame_median_s=med, mrays_per_s=mrays,
                         vs_cpu_reference=mrays / DRAGON_FULL_REF_MRAYS,
                         mean=float(img[..., :3].mean()))
    out["mean_diff"], out["std_err"] = mean_gap(first["k1"], first["sorted"])
    need(abs(out["mean_diff"]) <= 4 * out["std_err"],
         f"K1's binned 7.2M frame differs from the sorted driver's: {out}")
    out["sorted"]["profile"] = profile_frame(pt, full, camera, opts, kernel="bounce_binned_kernel")
    os.environ["PTX_SORTED_WAVEFRONT"] = "0"
    try:
        out["k1"]["profile"] = profile_frame(pt, full, camera, opts, kernel="megakernel")
    finally:
        del os.environ["PTX_SORTED_WAVEFRONT"]
    rays, _ = camera_state(sw, scenes.bench_camera(device="cuda"), opts, DRAGON_SPP, 21)
    out["sorted"]["k2"] = k2_sorted_run(sw, mk, kt, full, rays, opts, n_paths)
    # The twin takes ~46 s on the whole 7.2M chunk on an H100: K1 is held
    # to it on the subset only.
    out["k1"]["k1"] = k1_binned_run(mk, full, rays, opts, whole_chunk_plain=False)
    return out


def phase_dragon_full_resume(pt, ck, sw, mk, scenes, full, cache_dir):
    """render_resumable on the 7.2M scene through the default tracer,
    128x128 @ 16 spp in chunks of 4, a checkpoint after every chunk:
    stopped by its progress callback after chunk 2 and resumed from the
    file (the resume renders chunks 3 and 4), equal bit for bit to the
    uninterrupted render; a camera moved by one ulp is refused by its
    fingerprint."""
    opts = pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    camera = scenes.bench_camera()
    kw = dict(spp=DRAGON_SPP, spp_chunk=4, seed=60, checkpoint_every=1)
    path = os.path.join(cache_dir, "film.npz")
    os.environ.pop("PTX_SORTED_WAVEFRONT", None)

    class Stop(Exception):
        pass

    def stop_after_2(done, total):
        if done == 2:
            raise Stop

    sync()
    t0 = time.perf_counter()
    fp = ck.render_fingerprint(full, camera)
    fingerprint_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = ck.render_resumable(full, camera, opts, **kw)
    whole_s = time.perf_counter() - t0
    try:
        ck.render_resumable(full, camera, opts, checkpoint_path=path,
                            progress_callback=stop_after_2, **kw)
        need(False, "the progress callback did not stop the render")
    except Stop:
        pass
    saved = ck.load_checkpoint(path)
    need(saved.chunks_done == 2 and saved.fingerprint == fp,
         f"checkpoint after the stop: {saved.chunks_done} chunks, fingerprint {saved.fingerprint}")
    done = []
    mk.trace_megakernel.launches = sw.bounce.launches = 0
    t0 = time.perf_counter()
    resumed = ck.render_resumable(full, camera, opts, checkpoint_path=path,
                                  progress_callback=lambda c, n: done.append(c), **kw)
    resume_s = time.perf_counter() - t0
    launches = dict(k2=sw.bounce.launches, k1=mk.trace_megakernel.launches)
    need(done == [3, 4], f"the resume rendered chunks {done}, not [3, 4]")
    need(launches["k2"] > 0 and launches["k1"] == 0,
         f"the resume did not run through the sorted driver alone: {launches}")
    equal = (np.array_equal(resumed.pixel_sum, whole.pixel_sum)
             and np.array_equal(resumed.sample_count, whole.sample_count))
    need(equal, "the resumed 7.2M render differs from the uninterrupted one")
    need(bool((whole.sample_count == DRAGON_SPP).all()) and np.isfinite(whole.pixel_sum).all(),
         "the resumable 7.2M render is not complete and finite")
    moved = dataclasses.replace(camera, origin=camera.origin.clone())
    moved.origin[0] = torch.nextafter(moved.origin[0], torch.ones_like(moved.origin[0]))
    try:
        ck.render_resumable(full, moved, opts, checkpoint_path=path, **kw)
        refused = None
    except ValueError as e:
        refused = str(e)
    need(refused is not None and "different scene/camera" in refused,
         f"a camera moved by one ulp was not refused: {refused}")
    return dict(scene="7.2M", fingerprint_s=fingerprint_s, uninterrupted_s=whole_s,
                resume_s=resume_s, resumed_chunks=done, resume_launches=launches,
                bit_equal=equal,
                mean=float(whole.image()[..., :3].mean()), moved_camera_refused=refused)


def phase_native_pipeline(scenes, packed):
    """The C++ host pipeline against its numpy versions at 7.2M: the mesh
    pipeline on the stand-in's arrays (all six outputs bit-equal, both
    timed), and the packer on the cluster arrays phase 24's cold build
    packed (the build's records and a second C++ pack bit-equal to the
    numpy packer's, both timed)."""
    from cpupathtrace_tpu_torch import native
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
    from cpupathtrace_tpu_torch.scene import mesh

    t0 = time.perf_counter()
    verts, faces = scenes.standin_dragon_arrays(scenes.DRAGON_FULL_TRIS)
    out = dict(faces=int(faces.shape[0]), arrays_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    got = native.mesh_pipeline_native(verts, faces, True)
    out["mesh_native_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = mesh._mesh_pipeline_numpy(verts, faces, True)
    out["mesh_numpy_s"] = time.perf_counter() - t0
    out["mesh_kept"] = int(got[0].shape[0])
    out["mesh_bit_equal"] = [g.dtype == w.dtype and bits_equal(torch.from_numpy(g),
                                                               torch.from_numpy(w))
                             for g, w in zip(got, want)]
    need(all(out["mesh_bit_equal"]), f"the C++ mesh pipeline differs from numpy at 7.2M: {out}")
    del got, want, verts, faces

    v0, v1, v2, cull, prim, mat, n0, n1, n2 = (np.asarray(a, np.float32)
                                               for a in packed["args"])
    built = packed["out"]
    fresh = np.zeros_like(built)
    t0 = time.perf_counter()
    native.pack_pair_records_native(v0, v1, v2, cull, prim, mat, n0, n1, n2, out=fresh)
    out["pack_native_s"] = time.perf_counter() - t0
    plain = np.zeros_like(built)
    t0 = time.perf_counter()
    kt._pack_pair_records_batch(v0, v1, v2, cull, prim, n0, n1, n2, mat, out=plain)
    out["pack_numpy_s"] = time.perf_counter() - t0
    out.update(pack_arrays="the 7.2M cold build's (phase 24)", records=list(built.shape),
               pack_bit_equal=bits_equal(torch.from_numpy(built), torch.from_numpy(plain))
               and bits_equal(torch.from_numpy(fresh), torch.from_numpy(plain)))
    need(out["pack_bit_equal"], "the C++ packer differs from numpy on the 7.2M clusters")
    return out


def phase_obj_dragon(pt, sw, mk, kt, scenes, dragon):
    """renderSceneDragonBox from an OBJ file: the 200k stand-in written as
    OBJ text under build/ and built on the card through load_mesh (the C++
    parser), held to phase 7's arrays-route build (triangles, positions,
    normals); three frames each through the default dispatch (the sorted
    driver, K2) and PTX_SORTED_WAVEFRONT=0 (K1 binned) in turns, each
    tracer's frame within 4 standard errors of its arrays-route frame; K2
    and K1 against their twins on 16,384 of the frame's camera rays."""
    from cpupathtrace_tpu_torch import native
    from cpupathtrace_tpu_torch.scene import mesh
    from cpupathtrace_tpu_torch.scene.scene import BUILD_SECONDS

    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    t0 = time.perf_counter()
    text = scenes.standin_dragon_obj(DRAGON_TRIS)
    out = dict(text_mb=len(text) / 1e6, text_s=time.perf_counter() - t0)
    need(len(text) > mesh.NATIVE_PARSE_MIN_BYTES, "the OBJ text is below the C++ parser's size")
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = os.path.join(tmp, "dragon.obj")
        t0 = time.perf_counter()
        with open(path, "w") as f:
            f.write(text)
        out["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.parse_obj_native(text)
        out["parse_s"] = time.perf_counter() - t0
        runs = native.runs["parse_obj"]
        BUILD_SECONDS.clear()
        t0 = time.perf_counter()
        scene = scenes.bench_dragon_scene(dragon_obj=path, device="cuda")
        out.update(build_s=time.perf_counter() - t0, stages_s=dict(BUILD_SECONDS),
                   load_mesh_s=BUILD_SECONDS["mesh"])
        need(native.runs["parse_obj"] == runs + 1, "the OBJ dragon did not take the C++ parser")
    need(scene.accel == "binned" and scene.has_kernel_records, "the OBJ dragon is not binned")

    # Against the arrays route (phase 7): the same triangles, positions
    # within OBJ_POS_ULPS float32 ulps, normals within OBJ_NORMAL_ERR.
    need(scene.n_tri == dragon.n_tri, f"OBJ route {scene.n_tri} triangles, arrays route "
                                      f"{dragon.n_tri}")
    ulps, moved, nerr = 0.0, 0, 0.0
    for k in range(3):
        a = getattr(scene, f"tri_v{k}").cpu().numpy()
        b = getattr(dragon, f"tri_v{k}").cpu().numpy()
        ulps = max(ulps, float((np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b))).max()))
        moved += int((a != b).sum())
        nerr = max(nerr, float((getattr(scene, f"tri_n{k}") - getattr(dragon, f"tri_n{k}"))
                               .abs().max()))
    out["vs_arrays_route"] = dict(n_tri=scene.n_tri, position_ulps=ulps,
                                  positions_moved=moved, normal_err=nerr)
    need(ulps <= OBJ_POS_ULPS and nerr <= OBJ_NORMAL_ERR,
         f"the OBJ route strays from the arrays route: {out['vs_arrays_route']}")

    opts = pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    camera = scenes.bench_camera()
    n_paths = DRAGON_W * DRAGON_H * DRAGON_SPP
    routes = {"sorted": None, "k1": "0"}
    first = {}
    for name, flag in routes.items():
        mk.trace_megakernel.launches = sw.bounce.launches = 0
        mk.trace_megakernel_reference.calls = sw.bounce_reference.calls = 0
        images, secs = render_frames(pt, scene, camera, opts, flag, [60])
        sync()
        out[name] = dict(first_frame_s=secs[0], launches=dict(
            k1=mk.trace_megakernel.launches, k2=sw.bounce.launches,
            k1_twin=mk.trace_megakernel_reference.calls, k2_twin=sw.bounce_reference.calls))
        first[name] = images[0]
    c1, c2 = out["k1"]["launches"], out["sorted"]["launches"]
    need(c1["k1"] > 0 and c1["k2"] == c1["k1_twin"] == c1["k2_twin"] == 0,
         f"PTX_SORTED_WAVEFRONT=0: the OBJ frame did not run K1's binned form alone: {c1}")
    need(c2["k2"] > 0 and c2["k1"] == c2["k1_twin"] == c2["k2_twin"] == 0,
         f"the default OBJ frame did not run the sorted driver alone: {c2}")
    for order, seed in zip(("k1", "sorted", "sorted", "k1", "k1", "sorted"), range(61, 67)):
        _, secs = render_frames(pt, scene, camera, opts, routes[order], [seed])
        out[order].setdefault("frame_s", []).extend(secs)
    for name, img in first.items():
        need(img.shape == (DRAGON_H, DRAGON_W, 4) and np.isfinite(img).all()
             and bool((img[..., 3] == 1.0).all()), f"{name} OBJ frame")
        med = float(np.median(out[name]["frame_s"]))
        mrays = n_paths / med / 1e6
        # An independent frame (another seed) of the arrays-route scene.
        arrays_img = render_frames(pt, dragon, camera, opts, routes[name], [70])[0][0]
        gap, err = mean_gap(img, arrays_img)
        out[name].update(frame_median_ms=med * 1e3, mrays_per_s=mrays,
                         vs_cpu_reference=mrays / DRAGON_REF_MRAYS,
                         mean=float(img[..., :3].mean()), vs_arrays_route=dict(
                             mean_diff=gap, std_err=err,
                             arrays_mean=float(arrays_img[..., :3].mean())))
        need(abs(gap) <= 4 * err, f"the {name} OBJ frame differs from the arrays route's: "
                                  f"{out[name]['vs_arrays_route']}")
    rays, _ = camera_state(sw, scenes.bench_camera(device="cuda"), opts, DRAGON_SPP, 21)
    out["sorted"]["k2"] = k2_sorted_run(sw, mk, kt, scene, rays, opts, n_paths)
    out["k1"]["k1"] = k1_binned_run(mk, scene, rays, opts, whole_chunk_plain=False)
    return out


def run_module(args, timeout, env=None):
    """`python -m <args>` from the checkout's root (in `env`, default this
    process's): (completed process, seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=timeout, env=env)
    return res, time.perf_counter() - t0


BENCH_METRICS = ("renderSceneDragonBoxFull_throughput", "renderSceneDragonBox_throughput",
                 "renderSceneBoxGrad_throughput", "renderSceneBox_throughput")


def phase_bench(pt, cms, scenes, cache_dir):
    """`python -m cpupathtrace_tpu_torch.bench` at its defaults (every
    workload, the parity gate on), the 7.2M scene from phase 24's cache:
    rc 0, bench.py's four metric lines with the box last, each verified,
    without error, with a positive value, the three frame workloads each
    with its roofline. Before it, one of the runner's box chunks (128x128
    @ 64 spp through render_chunk) makes no host read, so its frames
    overlap, and its box frame is timed as 4 chunks and as one
    (`bench_box_frame`)."""
    box, cam = scenes.bench_box_scene(), scenes.bench_camera()
    opts = pt.RenderOptions(BOX_W, BOX_H, BOX_SPP, BOX_SPP, epsilon=1e-3, max_depth=MAX_DEPTH)
    x = torch.linspace(-1, 1, BOX_W * BOX_H, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    pt.render_chunk(box, cam, opts, x, x.flip(0), gen, 64)
    chunk_syncs = cms.host_syncs(lambda: pt.render_chunk(box, cam, opts, x, x.flip(0), gen, 64))
    need(chunk_syncs == 0, f"a box chunk made {chunk_syncs} host reads")
    box_frames = {f"chunks_{n}": bench_box_frame(box, cam, opts, n) for n in (4, 1)}
    res, secs = run_module(["cpupathtrace_tpu_torch.bench"], 600,
                           env=dict(os.environ, PTX_SCENE_CACHE=cache_dir))
    need(res.returncode == 0, f"the benchmark runner exited {res.returncode}: "
                              f"{res.stdout[-2000:]} {res.stderr[-4000:]}")
    lines = [json.loads(s) for s in res.stdout.splitlines() if s.startswith("{")]
    need(tuple(r["metric"] for r in lines) == BENCH_METRICS,
         f"the benchmark runner's lines: {[r.get('metric') for r in lines]}")
    for r in lines:
        need(r.get("parity_verified") is True and "error" not in r and r["value"] > 0,
             f"the benchmark runner's line: {r}")
        need(r["metric"] == "renderSceneBoxGrad_throughput" or "roofline" in r,
             f"{r['metric']} has no roofline")
    return dict(seconds=secs, rc=res.returncode, box_chunk_host_reads=chunk_syncs,
                box_frames=box_frames, lines=lines,
                log=[s for s in res.stderr.splitlines() if s.startswith("# ")])


def bench_box_frame(box, cam, opts, n_chunks, frames=3):
    """The runner's box frame (`bench._frame_fn`) as `n_chunks` chunks: per
    frame the host's enqueue ms (the call's return; the chunks read nothing
    from the card) and the wall ms to its sync, then one frame profiled."""
    from cpupathtrace_tpu_torch import bench

    frame = bench._frame_fn(box, cam, opts, BOX_W, BOX_H, BOX_SPP // n_chunks, n_chunks, "cuda")
    frame(0)
    enqueue, wall = [], []
    for seed in range(1, frames + 1):
        sync()
        t0 = time.perf_counter()
        frame(seed)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
    return dict(enqueue_ms=enqueue, wall_ms=wall,
                profile=profile_run(lambda: frame(frames + 1), "megakernel"))


def phase_demo_cli(pt, out_dir):
    """`python -m cpupathtrace_tpu_torch.demo <png>` at its defaults (256x256,
    16-64 spp, the 20k stand-in dragon) on the card: rc 0, the PNG read back
    (256, 256, 4) and lit (`--sharded`: phase 32)."""
    import re

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        png = os.path.join(out_dir or tmp, "demo_cli_torch.png")
        res, secs = run_module(["cpupathtrace_tpu_torch.demo", png], 600)
        need(res.returncode == 0, f"the demo exited {res.returncode}: {res.stderr[-2000:]}")
        img = pt.read_rgb_image(png)
    need(img.shape == (256, 256, 4) and float(img[..., :3].mean()) > 0.01,
         f"the demo's PNG: {img.shape}, mean {float(img[..., :3].mean())}")
    rate = re.search(r"rendered in .*Mrays/s\)", res.stderr)
    scene = re.search(r"scene: .*", res.stderr)
    return dict(seconds=secs, rc=res.returncode, scene=scene.group(0) if scene else None,
                rendered=rate.group(0) if rate else None,
                image_mean=float(img[..., :3].mean()))


def phase_example():
    """`python -m cpupathtrace_tpu_torch.examples.inverse_render <dir>` at its
    defaults (60 Adam steps, 32x32 @ 16 spp) on the card: rc 0, so the
    recovered albedo is within 0.2 of the truth."""
    import re

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        res, secs = run_module(["cpupathtrace_tpu_torch.examples.inverse_render", tmp], 600)
    need(res.returncode == 0, f"inverse_render exited {res.returncode}: "
                              f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    loss = re.search(r"loss: (\S+) -> (\S+)", res.stdout)
    albedo = re.search(r"red wall albedo: .*", res.stdout)
    err = re.search(r"max albedo error: (\S+)", res.stdout)
    return dict(seconds=secs, rc=res.returncode,
                first_loss=float(loss.group(1)), last_loss=float(loss.group(2)),
                albedo=albedo.group(0), max_albedo_error=float(err.group(1)))


@contextlib.contextmanager
def ablation(mk, setting):
    """The switches of a BUDGET_SETTINGS setting on the port's module
    attributes for a `with` block, restored after it."""
    old = mk._ABLATE, mk._SKIP_TRAVERSE
    mk._ABLATE, mk._SKIP_TRAVERSE = BUDGET_SETTINGS[setting]
    try:
        yield
    finally:
        mk._ABLATE, mk._SKIP_TRAVERSE = old


def budget_run(pt, sw, mk, kt, scene, camera, opts, tracer, setting, rays, check_rays, seed,
               best_ms):
    """One scene, tracer ("k1": K1, dense or binned; "k2": the sorted
    driver) and setting (set by the caller): 1 + TIMED_FRAMES frames
    through render() (launches counted; the median time of all but the
    first; their pixels' mean radiance, [frames, pixels], returned, and its
    mean and standard error: `frame_stats`), the kernel's card time on the frame's rays (K1's `best_ms`; K2's launches
    of one frame by CUDA events), the ray-bounces (the counters, binned;
    the bounce steps, dense; on a binned scene the walks' columns must be
    zero under skip, the shadow walks' under nee) and, on `check_rays` of
    the rays, the kernel against its twin bit for bit (spectrum,
    collected, counters)."""
    binned = scene.has_kernel_records
    flag = "0" if tracer == "k1" and binned else None
    mk.trace_megakernel.launches = sw.bounce.launches = 0
    mk.trace_megakernel_reference.calls = sw.bounce_reference.calls = 0
    images, secs = render_frames(pt, scene, camera, opts, flag,
                                 range(seed, seed + 1 + TIMED_FRAMES))
    sync()
    launches = dict(k1=mk.trace_megakernel.launches, k2=sw.bounce.launches,
                    twins=mk.trace_megakernel_reference.calls + sw.bounce_reference.calls)
    other = "k2" if tracer == "k1" else "k1"
    need(launches[tracer] > 0 and launches[other] == 0 and launches["twins"] == 0,
         f"budget {tracer}: the frames did not run {tracer} alone: {launches}")
    frames = np.stack(images)
    need(frames.shape[1:] == (opts.image_height, opts.image_width, 4)
         and np.isfinite(frames).all(), f"budget {tracer}: non-finite frame")
    lum = frames[..., :3].mean(-1).reshape(len(images), -1).astype(np.float64)
    mean, std_err = frame_stats(lum)
    tables = mk.pack_tables(scene)
    if tracer == "k1":
        seed_t = torch.tensor([seed], dtype=torch.int32, device="cuda")
        if binned:
            _, _, vis = mk.trace_megakernel(scene, rays, opts, seed_t, tables, debug_visits=True)
            rb = ray_bounces(vis)
        else:
            steps = torch.zeros(mk.BOUNCE_STEP_COLS, dtype=torch.int64, device="cuda")
            mk.trace_megakernel(scene, rays, opts, seed_t, tables, bounce_steps=steps)
            rb = int(steps[1])
        kernel_ms = best_ms(lambda: mk.trace_megakernel(scene, rays, opts, seed_t, tables), 3)
    else:
        sw.trace_megakernel_sorted(scene, rays, opts, seed, tables)
        timing: dict = {}
        sw.trace_megakernel_sorted(scene, rays, opts, seed, tables, timing=timing)
        kernel_ms = sum(timing["bounce_ms"])
        _, _, vis = sw.trace_megakernel_sorted(scene, rays, opts, seed, tables, debug_visits=True)
        rb = ray_bounces(vis)
    need(rb > 0, f"budget {tracer}: no ray-bounce counted")
    if binned:
        cols = vis.reshape(-1, kt.GEO_VISIT_COLS).sum(0)
        ablate, skip = BUDGET_SETTINGS[setting]
        walked = cols[:kt.QUERY_COL] if skip else cols[kt.SHADOW_COLS] if "nee" in ablate else None
        need(walked is None or not bool(walked.any()),
             f"budget {tracer} {setting}: the walks it takes out were counted: {cols.tolist()}")
    out = dict(kernel_ms=kernel_ms, frame_median_ms=float(np.median(secs[1:])) * 1e3,
               ray_bounces=rb, ns_per_ray_bounce=kernel_ms * 1e6 / rb,
               frame_mean=mean, frame_std_err=std_err, frames=len(images), launches=launches)
    if binned:
        # The walks' counted work: K3's bound (slab tests and filled rows).
        flops, counts = traversal_flops(vis)
        out["walk_bound"] = dict(counts=counts, **bound(0, flops))
    if check_rays:
        sub = type(rays)(rays.origin[:check_rays].contiguous(),
                         rays.direction[:check_rays].contiguous())
        if tracer == "k1":
            k, kc, kv = mk.trace_megakernel(scene, sub, opts, 21, tables, debug_visits=True)
            t, tc, tv = mk.trace_megakernel_reference(scene, sub, opts, 21, tables,
                                                      debug_visits=True)
        else:
            k, kc, kv = sw.trace_megakernel_sorted(scene, sub, opts, 21, tables,
                                                   debug_visits=True)
            t, tc, tv = sw.trace_megakernel_sorted(scene, sub, opts, 21, tables, reference=True,
                                                   debug_visits=True)
        sync()
        out["twin"] = dict(rays=check_rays, spectrum_bit_equal=bits_equal(k, t),
                           collected_equal=bool(torch.equal(kc, tc)),
                           counters_equal=bool(torch.equal(kv, tv)), max_abs_err=max_err(k, t))
        need(out["twin"]["spectrum_bit_equal"] and out["twin"]["collected_equal"]
             and out["twin"]["counters_equal"],
             f"budget {tracer}: the ablation instance disagrees with its twin: {out['twin']}")
    return out, lum


def frame_stats(lum):
    """The mean radiance of frames [frames, pixels] (independent seeds) and
    its Monte Carlo standard error: each pixel's variance across the
    frames, averaged over the pixels, over frames x pixels. (The spread
    over the pixels of one image is its content, not its noise.)"""
    f, p = lum.shape
    return float(lum.mean()), float(np.sqrt(lum.var(axis=0, ddof=1).mean() / (f * p)))


def budget_shares(rows, dense):
    """A tracer's budget from its settings' rows: per setting the share of
    base's kernel time it took out (1 - t(setting) / t(base)), and NEE =
    1 - t(nee) / t(base), the nearest walk = (t(nee) - t(nee+skip)) /
    t(base), the floor = t(nee+skip) / t(base) (binned) or the dense tests
    = 1 - t(bigpair) / t(base) (dense): once from the kernel's ms and once
    from its ns per ray-bounce. Binned: also the walks' ms (K3's time,
    t(base) - t(skip), and the nearest walk's, t(nee) - t(nee+skip))."""
    out = {}
    for unit, key in (("frame", "kernel_ms"), ("per_ray_bounce", "ns_per_ray_bounce")):
        t = {name: r[key] for name, r in rows.items()}
        b = t["base"]
        shares = {f"removed_by_{name}": 1.0 - v / b for name, v in t.items() if name != "base"}
        shares["nee"] = 1.0 - t["nee"] / b
        if dense:
            shares["dense_tests"] = 1.0 - t["bigpair"] / b
        else:
            shares["nearest_walk"] = (t["nee"] - t["nee_skip"]) / b
            shares["floor"] = t["nee_skip"] / b
        out[unit] = shares
    if not dense:
        # K3's time inside the tracer: t(base) - t(skip), the nearest and
        # shadow walks.
        t = {name: r["kernel_ms"] for name, r in rows.items()}
        out["walks"] = dict(ms=t["base"] - t["skip"], nearest_ms=t["nee"] - t["nee_skip"])
    return out


def phase_frame_budget(pt, sw, mk, kt, scenes, dragon, cache_dir, out_dir, best_ms):
    """The frame budget on the card: every BUDGET_SETTINGS setting on the
    box (K1 dense, 128x128 @ 256 spp), the 200k dragon and the 7.2M dragon
    (K1 binned and the sorted driver, 128x128 @ 16 spp; the 7.2M scene from
    phase 24's cache, no rebuild), each inside trace_annotation("budget/
    <scene>/<tracer>/<setting>"); per tracer the budget, raw and per
    ray-bounce; every setting's frame mean (over its 1 + TIMED_FRAMES
    frames) more than 4 standard errors from base's, but skip's (it takes
    out the dragon alone, whose pixels at 7.2M are few and about as bright
    as the wall behind them: its counters show it instead); the ablation instances bit-equal to their twins (box, 200k);
    under "nee" diff_supported False and K2's record form refused; the base
    7.2M sorted frame through profile_to."""
    from cpupathtrace_tpu_torch.integrator.diff_megakernel import diff_supported
    from cpupathtrace_tpu_torch.utils.profiling import profile_to, trace_annotation

    full, hit = scenes.dragon_full_scene(cache_dir, device="cuda")
    need(hit, "the 7.2M scene was rebuilt, not read from phase 24's cache")
    box_opts = pt.RenderOptions(BOX_W, BOX_H, BOX_SPP, BOX_SPP, epsilon=1e-3, max_depth=MAX_DEPTH)
    dragon_opts = pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                                   max_depth=MAX_DEPTH)
    camera = scenes.bench_camera(device="cuda")
    cells = [("box", scenes.bench_box_scene(), box_opts, BOX_SPP, ("k1",),
              BUDGET_BOX_CHECK_RAYS),
             ("dragon_200k", dragon, dragon_opts, DRAGON_SPP, ("k1", "k2"), K1B_CHECK_RAYS),
             ("dragon_7p2m", full, dragon_opts, DRAGON_SPP, ("k1", "k2"), 0)]
    out: dict = {}
    seed = 70
    for name, scene, opts, spp, tracers, check in cells:
        rays, _ = camera_state(sw, camera, opts, spp, seed)
        dense = not scene.has_kernel_records
        settings = [s for s in BUDGET_SETTINGS if not (dense and s in WALK_SETTINGS)]
        for tracer in tracers:
            rows = {}
            for setting in settings:
                label = f"budget/{name}/{tracer}/{setting}"
                with trace_annotation(label), ablation(mk, setting):
                    rows[setting], _ = budget_run(pt, sw, mk, kt, scene, camera, opts, tracer,
                                                  setting, rays, check, seed, best_ms)
                    if setting != "base":
                        r, b = rows[setting], rows["base"]
                        gap = r["frame_mean"] - b["frame_mean"]
                        se = float(np.hypot(r["frame_std_err"], b["frame_std_err"]))
                        rows[setting].update(mean_gap=gap, mean_gap_std_err=se)
                        need(abs(gap) > 4 * se or setting == "skip",
                             f"{label}: the frame mean moved only {gap} ({se} standard error): "
                             f"was the switch applied?")
                    if name == "dragon_7p2m" and tracer == "k2" and setting == "base":
                        rows[setting]["profile"] = profile_trace(
                            pt, scene, camera, opts, seed, label, out_dir, profile_to,
                            trace_annotation)
                line(f"31 {label}", **rows[setting])
            budget = budget_shares(rows, dense)
            if not dense:
                # K3's bound: base's counted walk work.
                wb = rows["base"]["walk_bound"]
                budget["walks"].update(bound_ms=wb["bound_ms"], bound_by=wb["bound_by"],
                                       over_bound=budget["walks"]["ms"] / wb["bound_ms"])
            line(f"31 budget/{name}/{tracer}", **budget,
                 note="each setting changes the paths' lengths: read the per-ray-bounce shares")
            out[f"{name}/{tracer}"] = dict(rows=rows, budget=budget)
    del full
    # The gradient path refuses the switches: diff_supported reads
    # PTX_ABLATE at the call, K2's record form raises.
    old = os.environ.get("PTX_ABLATE")
    os.environ["PTX_ABLATE"] = "nee"
    try:
        refused = not diff_supported(dragon)
    finally:
        os.environ.pop("PTX_ABLATE")
        if old is not None:
            os.environ["PTX_ABLATE"] = old
    need(refused and diff_supported(dragon), "diff_supported did not refuse PTX_ABLATE=nee")
    st = sw.initial_state(rays.origin[:1024].contiguous(), rays.direction[:1024].contiguous(), 3)
    records = torch.empty((sw.n_diff_records(dragon.n_point_lights,
                                             dragon.emissive_sample_count), 1024), device="cuda")
    with ablation(mk, "nee"):
        try:
            sw.bounce(dragon, st, torch.tensor([3, 0], dtype=torch.int32, device="cuda"),
                      dragon_opts, records=records)
            raised = False
        except ValueError:
            raised = True
    need(raised, "K2's record form ran under PTX_ABLATE=nee")
    out["refusals"] = dict(diff_supported_under_nee=False, record_form_raises=True)
    return out


def profile_trace(pt, scene, camera, opts, seed, label, out_dir, profile_to, trace_annotation):
    """One frame through profile_to (out_dir/trace_k2_7p2m, or a directory
    under build/ removed after) inside trace_annotation(label + "/frame"):
    the trace file's size, the annotation's presence, its kernel events."""
    logdir = (os.path.join(out_dir, "trace_k2_7p2m") if out_dir
              else tempfile.mkdtemp(prefix="chip_smoke_trace_", dir=os.path.join(ROOT, "build")))
    try:
        with profile_to(logdir), trace_annotation(label + "/frame"):
            pt.render(scene, camera, opts, seed=seed, device="cuda")
        files = [os.path.join(logdir, f) for f in os.listdir(logdir)]
        need(len(files) == 1, f"profile_to wrote {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        names = {e.get("name") for e in events}
        out = dict(file=files[0] if out_dir else None, mb=os.path.getsize(files[0]) / 1e6,
                   annotation_present=label + "/frame" in names, kernel_events=len(kernels),
                   k2_events=sum(1 for e in kernels if "bounce_binned_kernel" in e["name"]))
        need(out["annotation_present"] and out["k2_events"] > 0,
             f"the profile lacks the annotation or K2: {out}")
        return out
    finally:
        if not out_dir:
            shutil.rmtree(logdir, ignore_errors=True)


def ptxas_registers(summary):
    """{instance: (registers, spill stores)} from a library's ptxas summary
    (_build.ptxas_summary: each instance's name, then its ptxas lines)."""
    import re

    out, cur = {}, None
    for part in summary.split(" | "):
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        if regs or spill:
            if cur is not None:
                reg, sp = out[cur]
                out[cur] = (int(regs.group(1)) if regs else reg,
                            int(spill.group(1)) if spill else sp)
        elif "bytes" not in part and "Function properties" not in part:
            cur = part.strip()
            out[cur] = (None, 0)
    return out


# The kernel instances that step the cluster walk (csrc/cluster_traverse.cuh
# `Walk`): K1's binned form, K2's binned instances and K4, their ablation
# instances too; for each, the place of its counting flag among its
# template arguments, None for the ablation instances (profiling only).
WALK_INSTANCES = {"megakernel_binned": 1, "megakernel_binned_ablate": None,
                  "bounce_binned_kernel": 2, "bounce_binned_kernel_ablate": None,
                  "cluster_query_kernel": 0}


def walk_plain(inst):
    """Whether a walking instance is one the main path launches: not an
    ablation instance, its counting flag 0 (K2's record form included)."""
    name, _, args = inst.partition("<")
    pos = WALK_INSTANCES.get(name)
    return pos is not None and int(args.rstrip(">").split(",")[pos]) == 0


def ptxas_against_parent(ptxas, parent_ptxas, occupancy=None, parent_occupancy=None):
    """Every kernel instance of the parent's ptxas report against this
    build's: registers and spill stores equal, instance by instance, but
    for the instances that walk (WALK_INSTANCES), whose (registers, spill
    stores) are listed beside the parent's, with the walking instances
    that only this build has. A walking instance that the main path
    launches (walk_plain) is a regression where it spills more than the
    parent's instance of its name (than nothing, where the parent has
    none), or where it holds fewer blocks an SM than the parent's (its
    registers past what its launch bounds allow), from the occupancy
    listings (kernel_occupancy) where given."""
    compared, differ, walking = 0, {}, {}
    for lib, summary in parent_ptxas.items():
        ours = ptxas_registers(ptxas.get(lib, ""))
        for inst, regs in ptxas_registers(summary).items():
            if inst.split("<")[0] in WALK_INSTANCES:
                walking[f"{lib}:{inst}"] = dict(parent=regs, ours=ours.get(inst))
                continue
            compared += 1
            if ours.get(inst) != regs:
                differ[f"{lib}:{inst}"] = dict(parent=regs, ours=ours.get(inst))
    regressed = {}
    for lib, summary in ptxas.items():
        theirs = ptxas_registers(parent_ptxas.get(lib, ""))
        for inst, regs in ptxas_registers(summary).items():
            if inst.split("<")[0] not in WALK_INSTANCES:
                continue
            walking.setdefault(f"{lib}:{inst}", dict(parent=None, ours=regs))
            if not walk_plain(inst):
                continue
            why = {}
            spill = theirs[inst][1] if inst in theirs else 0
            if regs[1] > spill:
                why["spill_stores"] = dict(ours=regs[1], parent=spill)
            if occupancy and parent_occupancy and inst in parent_occupancy:
                if occupancy[inst][0] < parent_occupancy[inst][0]:
                    why["blocks_per_sm"] = dict(ours=occupancy[inst][0],
                                                parent=parent_occupancy[inst][0])
            if why:
                regressed[f"{lib}:{inst}"] = why
    return dict(instances_compared=compared, differ=differ, walking=walking,
                walk_regressed=regressed)


def bounds_of(d, path=()):
    """Every bound_ms in a report, by its path of keys."""
    if isinstance(d, dict):
        for k, v in d.items():
            if k == "bound_ms":
                yield path, v
            else:
                yield from bounds_of(v, path + (k,))
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from bounds_of(v, path + (i,))


def bounds_against_parent(report, parent_report, phases):
    """The bound_ms of every phase in `phases` against the parent's report
    at the same path: equal, since both come from the same inputs and
    counters."""
    ours = dict(bounds_of({k: report[k] for k in phases if k in report}))
    theirs = dict(bounds_of({k: parent_report[k] for k in phases if k in parent_report}))
    common = sorted(set(ours) & set(theirs), key=str)
    differ = {"/".join(map(str, p)): dict(ours=ours[p], parent=theirs[p])
              for p in common if ours[p] != theirs[p]}
    return dict(compared=len(common), only_ours=len(set(ours) - set(theirs)),
                only_parent=len(set(theirs) - set(ours)), differ=differ)


def kernel_occupancy(mk, sw, kt, tt, oi, box, dense_smem, cand_clusters=512):
    """Resident blocks per SM (and threads per block) of every instance of
    K1, K2 and K4, and of K7: the walking ones at their rings alone (the
    tables of a scene add a few KB), the dense ones at `dense_smem` (the
    box's tables); K6 at m = 1 and CAND_M on `cand_clusters` clusters
    (blocks, threads, shared memory) and K5 on the box's tables (blocks,
    threads, shared memory, stage limit)."""
    layout = kt.walk_layout("megakernel")
    need(kt.walk_layout("bounce") == layout, "K1 and K2 were built with different walk layouts")
    ring = kt.kernel_smem_bytes(0, 0, layout)
    out = dict(ring_depth=layout.depth, walk_threads=layout.threads, ring_smem_bytes=ring,
               dense_smem_bytes=dense_smem)
    for cull in (-1, 0, 1):
        for count in (0, 1):
            out[f"megakernel_binned<{cull}, {count}>"] = mk.occupancy(ring, True, count, cull)
            out[f"megakernel<{cull}, {count}>"] = mk.occupancy(dense_smem, False, count, cull)
            out[f"megakernel_binned_ablate<{cull}, {count}>"] = mk.occupancy(
                ring, True, count, cull, ablate=True)
            out[f"megakernel_ablate<{cull}, {count}>"] = mk.occupancy(
                dense_smem, False, count, cull, ablate=True)
            out[f"bounce_binned_kernel_ablate<{cull}, {count}>"] = sw.bounce_occupancy(
                ring, True, cull, False, count, ablate=True)
        for rec, count in ((0, 0), (1, 0), (0, 1)):
            out[f"bounce_binned_kernel<{cull}, {rec}, {count}>"] = sw.bounce_occupancy(
                ring, True, cull, rec, count)
        for rec in (0, 1):
            out[f"bounce_kernel<{cull}, {rec}>"] = sw.bounce_occupancy(dense_smem, False, cull,
                                                                        rec)
        out[f"bounce_kernel_ablate<{cull}>"] = sw.bounce_occupancy(dense_smem, False, cull,
                                                                   ablate=True)
    q_layout = kt.walk_layout("cluster_query")
    q_ring = kt.kernel_smem_bytes(0, 0, q_layout)
    out.update(k4_ring_depth=q_layout.depth, k4_threads=q_layout.threads,
               k4_ring_smem_bytes=q_ring)
    for count in (0, 1):
        for any_hit in (0, 1):
            out[f"cluster_query_kernel<{count}, {any_hit}>"] = kt.query_occupancy(q_ring, count,
                                                                                   any_hit)
    out["binned_isect_kernel"] = tt.isect_occupancy()
    for m in (1, CAND_M):
        out[f"binned_cand_kernel<{m}>"] = tt.cand_occupancy(m, cand_clusters)
    out["dense_query_kernel"] = oi.dense_occupancy(box.n_tri, box.n_sph)
    return out


def row_lane_use(run):
    """(lane use at a filled-row step, at a slab step) of a run's walk
    figures (walk_figures, under "walk" or at the top)."""
    u = run.get("walk", run)["lane_utilisation"]
    return u["row_lane_utilisation"], u["slab_lane_utilisation"]


def parent_figures(parent):
    """The figures of phases 5, 7, 9, 11, 14, 16, 17, 18, 20, 21 and 23 in a
    parent's chip_smoke.json (its --out), run on the same machine, or
    None."""
    if parent is None:
        return None
    dm, k1, fr = parent["dragon_main_path"], parent["k1_binned"], parent["dragon_k1_frame"]
    depth1 = dm.get("depth1", dm)  # before the frame's K2 figures: at the top
    mp, gr = parent["main_path"], parent["box_grad"]
    q, k7 = parent["cluster_query"], parent["binned_kernels"]["k7_frame"]
    k6, k5, bw = parent["binned_kernels"]["k6_frame"], parent["dense_query"], \
        parent["binned_wavefront"]

    def frame_kernels(profile):
        ks = profile["kernels"]
        return dict(n_kernels=profile["n_kernels"],
                    k6_device_ms=ks["binned_cand_kernel"]["us"] / 1e3,
                    k6_launches=ks["binned_cand_kernel"]["launches"],
                    k5_device_ms=ks["dense_query"]["us"] / 1e3,
                    k5_launches=ks["dense_query"]["launches"])

    k8, x1 = parent["cluster_major"], parent["experiments"]["supscan"]
    ff = parent["dragon_full_frames"]
    x3, x2 = parent["experiments"]["record_variants"]["variants"], \
        parent["experiments"]["cond_fat"]
    return dict(device=parent.get("nvidia_smi"), k2_bounce_ms=dm["bounce_ms"],
                x3_ms={v: r["ms"] for v, r in x3.items()},
                x3_us_per_record={v: r["sweep"]["us_per_record"] for v, r in x3.items()},
                x2_ms={n: r["ms"] for n, r in x2.items()},
                x2_iter_us={n: r["sweep"]["iter_us"] for n, r in x2.items()},
                k8_ms=k8["ms"], k8_best_ms=k8["best_ms"], x1_sweep=x1["sweep"],
                x1_ms=x1["ms"],
                k6_ms=k6["ms"], k6_best_ms=k6["best_ms"], k5_ms=k5["ms"],
                k5_best_ms=k5.get("best_ms"), binned_frame=frame_kernels(bw["profile"]),
                lean_frame=frame_kernels(bw["lean"]["profile"]),
                k4_ms=q["ms"], k4_any_hit_ms=q["any_hit_ms"], k4_best_ms=q.get("best_ms"),
                k7_ms=k7["ms"], k7_best_ms=k7["best_ms"],
                k1_dense_ms=mp["kernel_ms"], box_frame_median_s=mp["frame_median_s"],
                grad_ms_per_pass=gr["replay"]["ms_per_pass"],
                k2_records_ms=gr["record_kernel"]["ms"],
                k2_frame_ms=sum(dm["bounce_ms"]), k2_depth1_unsorted_ms=depth1["kernel_ms"],
                k1_binned_ms=k1["ms"], k1_binned_ms_cluster128=k1["cluster128"]["ms"],
                k2_lane_use=row_lane_use(dm["frame"]), k1_binned_lane_use=row_lane_use(k1),
                k1_binned_lane_use_cluster128=row_lane_use(k1["cluster128"]),
                k2_7p2m_ms=ff["sorted"]["k2"]["ms"], k1_7p2m_ms=ff["k1"]["k1"]["ms"],
                k2_7p2m_lane_use=row_lane_use(ff["sorted"]["k2"]["frame"]),
                k1_7p2m_lane_use=row_lane_use(ff["k1"]["k1"]),
                sorted_frame_median_s=fr["sorted"]["frame_median_s"],
                k1_frame_median_s=fr["k1"]["frame_median_s"])


# ---------------------------------------------------------------------------
# Phases 32-34: the sharded paths (cpupathtrace_tpu_torch/parallel/).
# ---------------------------------------------------------------------------

SHARD_SEED = 11
SHARED_RANKS = 2
# A world of ranks on the card: the deadline of the whole world, and the
# timeout of each of its collectives.
RANK_DEADLINE_S = 600
RANK_TIMEOUT_S = 120
# The 7.2M gp query's random rays; the rays of the frame each gp shard's
# K4 is held to its plain version on.
GP_QUERY_RAYS = 65536
GP_CHECK_RAYS = 16384
# The sharded training gradient against the serial oracle's, relative to
# the largest entry: the record route's backward sums in its own order.
SHARD_GRAD_RTOL = 1e-4


def box_options(pt, spp=BOX_SPP):
    return pt.RenderOptions(BOX_W, BOX_H, spp, spp, epsilon=1e-3, max_depth=MAX_DEPTH)


def dragon_options(pt):
    return pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)


def grad_options(pt):
    return pt.RenderOptions(GRAD_W, GRAD_H, GRAD_SPP, GRAD_SPP, epsilon=1e-3,
                            max_depth=GRAD_DEPTH)


def gp_query_rays(n=GP_QUERY_RAYS, seed=5):
    """Random rays in the box (origins in [-0.9, 0.9]^3, uniform
    directions) on the card."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()


def timed(fn, frames):
    """(fn()'s first result, wall ms of `frames` further calls)."""
    first = fn()
    sync()
    ms = []
    for _ in range(frames):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return first, ms


class Interrupted(Exception):
    pass


def phase_sharded_one_rank(pt, mk, scenes, ck, main_path, out_dir):
    """One rank, NCCL, a world of one on the card: render_sharded of the box
    (128x128 @ 256 spp, max_depth 40) through K1, bit-equal to render_chunk
    with shard_seed(seed, 0, 0)'s generator, its frame beside phase 5's
    render() frame; render_resumable(mesh=) stopped after chunk 2 and
    resumed, bit-equal to the uninterrupted render; the demo with
    --sharded by subprocess, its PNG read back."""
    import re

    import torch.distributed as dist

    from cpupathtrace_tpu_torch.parallel import render as pr
    from cpupathtrace_tpu_torch.parallel.mesh import make_render_mesh

    mesh = make_render_mesh(device_type="cuda")
    need(dist.get_world_size() == 1 and dist.get_backend() == "nccl",
         f"one rank: world {dist.get_world_size()}, backend {dist.get_backend()}")
    box, cam = scenes.bench_box_scene(), scenes.bench_camera()
    opts = box_options(pt)
    mk.trace_megakernel.launches = mk.trace_megakernel_reference.calls = 0
    img, ms = timed(lambda: pr.render_sharded(box, cam, opts, mesh, seed=SHARD_SEED),
                    TIMED_FRAMES)
    launches, twin = mk.trace_megakernel.launches, mk.trace_megakernel_reference.calls
    need(launches == 1 + TIMED_FRAMES and twin == 0,
         f"render_sharded: {launches} K1 launches, {twin} twin calls")
    ref = pr.render_serial(box, cam, opts, (1, 1), seed=SHARD_SEED, device="cuda")
    need(np.array_equal(img, ref) and bool((img[..., 3] == 1.0).all()),
         "render_sharded on one rank is not render_chunk with shard_seed(seed, 0, 0)")
    frame_ms = float(np.median(ms))
    out = dict(mesh=tuple(mesh.shape), backend="nccl", bit_equal=True, k1_launches=launches,
               frame_ms=ms, frame_median_ms=frame_ms,
               mrays_per_s=BOX_W * BOX_H * BOX_SPP / frame_ms / 1e3,
               render_frame_median_ms=main_path["frame_median_s"] * 1e3,
               render_mrays_per_s=main_path["mrays_per_s"], image_mean=float(img[..., :3].mean()),
               beside_render=sharded_beside_render(pt, pr, box, cam, opts, mesh))

    ropts = box_options(pt, spp=16)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "sharded.ckpt")
        full = ck.render_resumable(box, cam, ropts, spp=16, seed=SHARD_SEED, spp_chunk=4,
                                   mesh=mesh)

        def stop(done, total):
            if done == 2:
                raise Interrupted

        try:
            ck.render_resumable(box, cam, ropts, spp=16, seed=SHARD_SEED, spp_chunk=4,
                                checkpoint_path=path, progress_callback=stop, mesh=mesh)
            stopped = False
        except Interrupted:
            stopped = True
        resumed = ck.render_resumable(box, cam, ropts, spp=16, seed=SHARD_SEED, spp_chunk=4,
                                      checkpoint_path=path, mesh=mesh)
    need(stopped and resumed.chunks_done == 4
         and np.array_equal(full.pixel_sum, resumed.pixel_sum)
         and np.array_equal(full.sample_count, resumed.sample_count),
         "render_resumable(mesh=) resumed is not the uninterrupted render")
    out["resume"] = dict(bit_equal=True, chunks=4, stopped_after=2)

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        png = os.path.join(out_dir or tmp, "demo_sharded_torch.png")
        res, secs = run_module(["cpupathtrace_tpu_torch.demo", png, "--sharded"], 600)
        need(res.returncode == 0, f"demo --sharded exited {res.returncode}: {res.stderr[-2000:]}")
        demo_img = pt.read_rgb_image(png)
    need(demo_img.shape == (256, 256, 4) and float(demo_img[..., :3].mean()) > 0.01,
         f"demo --sharded's PNG: {demo_img.shape}")
    found = {k: re.search(p, res.stderr) for k, p in
             (("mesh", r"mesh \(dp, sp\) = .*"), ("rendered", r"rendered in .*Mrays/s\)"))}
    out["demo"] = dict(seconds=secs, rc=res.returncode,
                       image_mean=float(demo_img[..., :3].mean()),
                       **{k: m.group(0) if m else None for k, m in found.items()})
    return out, mesh


def sharded_beside_render(pt, pr, box, cam, opts, mesh):
    """Where the one-rank sharded frame's time goes beside render()'s, the
    box at the main path's size: both timed in one interleaved loop
    (render, sharded, sharded, render, twice), then one frame of each
    under torch.profiler (wall, device busy, K1's device time, the other
    kernels), and the sharded frame's host pieces timed alone (the pixel
    grid built and copied to the card, the image copied back and
    normalised on the host)."""
    fns = {"render": lambda: pt.render(box, cam, opts, seed=SHARD_SEED, device="cuda"),
           "sharded": lambda: pr.render_sharded(box, cam, opts, mesh, seed=SHARD_SEED)}
    ms = {k: [] for k in fns}
    for k in ("render", "sharded", "sharded", "render") * 2:
        sync()
        t0 = time.perf_counter()
        fns[k]()
        sync()
        ms[k].append((time.perf_counter() - t0) * 1e3)
    prof = {k: profile_run(fn, "megakernel") for k, fn in fns.items()}

    def host_ms(fn, n=5):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        return (time.perf_counter() - t0) * 1e3 / n

    x, y, n = pr.pixel_coords(opts, 1, "cuda")
    s, c = pr.render_chunk_sharded(box, cam, opts, mesh, x, y, SHARD_SEED, 16)
    out = {k: dict(frame_ms=v, frame_median_ms=float(np.median(v))) for k, v in ms.items()}
    for k, p in prof.items():
        out[k].update(profiled_wall_ms=p["wall_us"] / 1e3, device_busy_ms=p["device_busy_us"] / 1e3,
                      k1_ms=sum(v for name, v in p["top_us"].items() if "megakernel" in name) / 1e3,
                      kernels=p["n_kernels"], top_us=p["top_us"],
                      host_only_ms=(p["wall_us"] - p["device_busy_us"]) / 1e3)
    out["sharded_host_pieces_ms"] = dict(
        pixel_coords=host_ms(lambda: pr.pixel_coords(opts, 1, "cuda")),
        image=host_ms(lambda: pr._image(s, c, n, BOX_H, BOX_W)))
    out["gap_ms"] = out["sharded"]["frame_median_ms"] - out["render"]["frame_median_ms"]
    return out


def _frames(pr, pd, mesh_barrier, mesh, scene, cam, opts, counters):
    """A sharded frame (its image and the launches of `counters`), then
    TIMED_FRAMES timed frames, each started together by the ranks: wall ms
    and ms in collectives (each collective timed after a card sync)."""
    for c in counters:
        c.launches = 0
    img = pr.render_sharded(scene, cam, opts, mesh, seed=SHARD_SEED)
    sync()
    launches = [c.launches for c in counters]
    ms, coll = [], []
    for _ in range(TIMED_FRAMES):
        mesh_barrier(mesh)
        sync()
        pd.collective_stats(reset=True)
        t0 = time.perf_counter()
        pr.render_sharded(scene, cam, opts, mesh, seed=SHARD_SEED)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        coll.append(pd.collective_stats()["seconds"] * 1e3)
    stats = pd.collective_stats(reset=True)
    return dict(image=img, frame_ms=ms, collective_ms=coll, launches=launches,
                collectives_per_frame=stats["calls"], collective_bytes_per_frame=stats["bytes"])


def shared_card_ranks(rank, world, files):
    """One of two ranks sharing the card through gloo on CUDA tensors: the
    work of phases 33 and 34 (the elastic failover last: rank 1 leaves)."""
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
    from cpupathtrace_tpu_torch.diff.render import get_material_params
    from cpupathtrace_tpu_torch.integrator import checkpoint as ck
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
    from cpupathtrace_tpu_torch.models import scenes
    from cpupathtrace_tpu_torch.ops import intersect as oi
    from cpupathtrace_tpu_torch.parallel import distributed as pd
    from cpupathtrace_tpu_torch.parallel import failover as pf
    from cpupathtrace_tpu_torch.parallel import geometry as pg
    from cpupathtrace_tpu_torch.parallel import render as pr
    from cpupathtrace_tpu_torch.parallel import train as ptr
    from cpupathtrace_tpu_torch.parallel.mesh import make_render_mesh, mesh_barrier
    from cpupathtrace_tpu_torch.scene.cache import load_scene
    from cpupathtrace_tpu_torch.scene.scene import KRN_FIELDS

    pd.time_collectives(True)
    dev = torch.device("cuda", torch.cuda.current_device())
    box, cam = scenes.bench_box_scene(), scenes.bench_camera()
    dragon = load_scene(files["dragon"])
    meshes = {"2x1": make_render_mesh(sample_axis=1, device_type="cuda"),
              "1x2": make_render_mesh(sample_axis=2, device_type="cuda")}
    alone = make_render_mesh([0], device_type="cuda")
    gp2 = pg.make_gp_mesh(device_type="cuda")
    out = {"backend": torch.distributed.get_backend(), "device": str(dev)}
    k1, k2 = mk.trace_megakernel, sw.bounce
    for name, scene, opts, shape, counters in (
            ("box", box, box_options(pt), "2x1", (k1, k2)),
            ("box", box, box_options(pt), "1x2", (k1, k2)),
            ("dragon", dragon, dragon_options(pt), "2x1", (k1, k2))):
        out[f"{name}_{shape}"] = _frames(pr, pd, mesh_barrier, meshes[shape], scene, cam, opts,
                                         counters)
    out["twin_calls"] = mk.trace_megakernel_reference.calls + sw.bounce_reference.calls

    gopts = grad_options(pt)
    x, y = ptr.pixel_grid(gopts, 1, device=dev)
    target = torch.zeros((x.shape[0], 4), device=dev)
    k2.record_launches = 0
    params = get_material_params(box)
    loss, grads = ptr.sharded_loss_and_grad(params, box, cam, gopts, meshes["1x2"], target, x, y,
                                            SHARD_SEED, GRAD_SPP)
    record_launches = k2.record_launches
    _, ms = timed(lambda: ptr.sharded_loss_and_grad(params, box, cam, gopts, meshes["1x2"],
                                                    target, x, y, SHARD_SEED, GRAD_SPP),
                  TIMED_FRAMES)
    out["train"] = dict(loss=float(loss), grads={k: v.cpu().numpy() for k, v in grads.items()},
                        record_launches=record_launches, pass_ms=ms)

    # Geometry parallel: the lean 200k dragon through the wavefront.
    lean = load_scene(files["lean"], device="cpu")
    prep = pg.shard_scene_kernel_geometry(lean, SHARED_RANKS)
    dopts = dragon_options(pt)
    kt.cluster_intersect.launches = oi.dense_intersect.launches = 0
    kt.cluster_intersect_reference.calls = oi.dense_intersect_reference.calls = 0
    pd.collective_stats(reset=True)
    img, ms = timed(lambda: pg.render_gp(prep, cam, dopts, gp2, seed=SHARD_SEED), 1)
    stats = pd.collective_stats(reset=True)
    out["gp_200k"] = dict(image=img, frame_ms=ms, k4_launches=kt.cluster_intersect.launches // 2,
                          k5_launches=oi.dense_intersect.launches // 2,
                          plain_calls=(kt.cluster_intersect_reference.calls
                                       + oi.dense_intersect_reference.calls),
                          collectives_per_frame=stats["calls"] // 2,
                          collective_ms_per_frame=stats["seconds"] * 1e3 / 2)
    shard = pg.scene_shard(prep, rank).to(dev)
    rays, _ = camera_state(sw, cam.to(dev), dopts, DRAGON_SPP, SHARD_SEED)
    o = rays.origin[:GP_CHECK_RAYS].contiguous()
    d = rays.direction[:GP_CHECK_RAYS].contiguous()
    t_k, p_k, v_k = kt.cluster_intersect(shard, o, d, debug_visits=True)
    t_r, p_r, v_r = kt.cluster_intersect_reference(shard, o, d, debug_visits=True)
    sync()
    out["gp_200k"]["k4_shard"] = dict(
        superclusters=int(shard.krn_cl_bounds.shape[0]), hyper_pages=int(shard.krn_sup_bounds.shape[0]),
        t_bit_equal=bits_equal(t_k, t_r), prim_equal=bool(torch.equal(p_k, p_r)),
        counters_equal=bool(torch.equal(v_k, v_r)), hits=int((p_k >= 0).sum()),
        max_abs_err=max_err(t_k, t_r),
        ms=cuda_ms(lambda: kt.cluster_intersect(shard, o, d), 5),
        plain_ms=cuda_ms(lambda: kt.cluster_intersect_reference(shard, o, d), 1))
    del lean, prep, shard

    # The 7.2M dragon from phase 24's cache: this rank's records and
    # cluster bounds alone go to the card.
    full, hit = scenes.dragon_full_scene(files["cache_dir"], device="cpu")
    prep = pg.shard_scene_kernel_geometry(full, SHARED_RANKS)
    del full
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    tables = {f: getattr(prep, f)[rank].to(dev) for f in KRN_FIELDS}
    sync()
    table_bytes = torch.cuda.max_memory_allocated(dev) - base
    shard = dataclasses.replace(pg.scene_shard(prep, rank, gp2.get_group("gp")),
                                **tables).to(dev)
    del prep
    o, d = gp_query_rays()
    kt.cluster_intersect.launches = 0
    t, p = oi.scene_intersect(shard, o, d)
    sync()
    out["gp_7p2m"] = dict(cache_hit=hit, t=t.cpu().numpy(), prim=p.cpu().numpy(),
                          table_bytes=int(table_bytes),
                          shard_tables_bytes=sum(int(v.numel()) * 4 for v in tables.values()),
                          k4_launches=kt.cluster_intersect.launches,
                          max_memory_allocated=int(torch.cuda.max_memory_allocated(dev)))
    del shard, tables

    # The elastic failover: rank 1 loses its device after chunk 2, rank 0
    # goes on alone from the checkpoint.
    calls = {"n": 0}
    render_chunk = pr.render_chunk

    def counting(*args, **kw):
        calls["n"] += 1
        return render_chunk(*args, **kw)

    pr.render_chunk = counting
    failovers = []

    def flaky(done, total):
        if rank == 1 and done == 2:
            raise RuntimeError("simulated device loss")

    t0 = time.perf_counter()
    try:
        st = pf.render_resumable_elastic(
            box, cam, box_options(pt, spp=16), spp=16,
            checkpoint_path=os.path.join(files["tmp"], "elastic.ckpt"),
            meshes=[meshes["2x1"], alone], seed=SHARD_SEED, spp_chunk=4,
            progress_callback=flaky, on_failover=lambda mi, e: failovers.append((mi, repr(e)[:300])))
        out["elastic"] = dict(result="done", chunks=st.chunks_done,
                              all_spp=bool((st.sample_count == 16).all()),
                              image_mean=float(st.image()[..., :3].mean()))
    except RuntimeError as e:
        out["elastic"] = dict(result="exhausted", error=str(e)[:300])
    out["elastic"].update(render_chunk_calls=calls["n"], failovers=failovers,
                          seconds=time.perf_counter() - t0)
    return out


def nccl_card_ranks(rank, world):
    """One rank a card under NCCL: the box at (2, 1), and the failover's
    refusal of an NCCL mesh."""
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.models import scenes
    from cpupathtrace_tpu_torch.parallel import failover as pf
    from cpupathtrace_tpu_torch.parallel import render as pr
    from cpupathtrace_tpu_torch.parallel.mesh import make_render_mesh

    mesh = make_render_mesh(sample_axis=1, device_type="cuda")
    box, cam = scenes.bench_box_scene(), scenes.bench_camera()
    img, ms = timed(lambda: pr.render_sharded(box, cam, box_options(pt), mesh, seed=SHARD_SEED),
                    TIMED_FRAMES)
    # The failover takes gloo meshes only: under NCCL a lost peer blocks
    # the collective until the watchdog ends the process.
    refused = {}
    for name, call in (("ping_mesh", lambda: pf.ping_mesh(mesh)),
                       ("render_resumable_elastic", lambda: pf.render_resumable_elastic(
                           box, cam, box_options(pt, spp=16), 16, "unused.ckpt", [mesh]))):
        try:
            call()
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    return dict(image=img, frame_ms=ms, device=str(torch.cuda.current_device()),
                failover_refused=refused)


def phase_shared_card(pt, scenes, dragon, lean, cache_dir, ch):
    """Phases 33 and 34: two ranks sharing the card (gloo on CUDA tensors),
    spawned once; their results held here against the serial oracles run
    on the card in this process (see the module docstring)."""
    import torch.distributed as dist

    from cpupathtrace_tpu_torch.accel.traverse import krn_intersect
    from cpupathtrace_tpu_torch.diff.render import get_material_params
    from cpupathtrace_tpu_torch.parallel import distributed as pd
    from cpupathtrace_tpu_torch.parallel import geometry as pg
    from cpupathtrace_tpu_torch.parallel import render as pr
    from cpupathtrace_tpu_torch.parallel import train as ptr
    from cpupathtrace_tpu_torch.scene.cache import save_scene

    build = os.path.join(ROOT, "build")
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        files = dict(dragon=os.path.join(tmp, "dragon.ptxt"), lean=os.path.join(tmp, "lean.ptxt"),
                     cache_dir=cache_dir, tmp=tmp)
        save_scene(dragon, files["dragon"])
        save_scene(lean, files["lean"])
        t0 = time.perf_counter()
        ranks = pd.spawn_ranks(shared_card_ranks, SHARED_RANKS, "gloo", args=(files,),
                               deadline_s=RANK_DEADLINE_S, timeout_s=RANK_TIMEOUT_S, threads=2)
        world_s = time.perf_counter() - t0
    label = "two ranks sharing one card (gloo on CUDA tensors): not scaling"
    box, cam = scenes.bench_box_scene(), scenes.bench_camera()
    shared = dict(label=label, ranks=SHARED_RANKS, backend=ranks[0]["backend"],
                  world_seconds=world_s, cases={})
    for key, scene, opts in (("box_2x1", box, box_options(pt)), ("box_1x2", box, box_options(pt)),
                             ("dragon_2x1", dragon, dragon_options(pt))):
        shape = tuple(int(v) for v in key.split("_")[1].split("x"))
        ref = pr.render_serial(scene, cam, opts, shape, seed=SHARD_SEED, device="cuda")
        ours = [r[key]["image"] for r in ranks]
        need(all(np.array_equal(img, ref) for img in ours),
             f"{key}: the two ranks' frame is not the serial oracle's")
        plain = pt.render(scene, cam, opts, seed=SHARD_SEED + 1, device="cuda")
        gap, se = mean_gap(ours[0], plain)
        need(abs(gap) <= 4 * se, f"{key}: frame mean {gap} from render()'s ({se} standard error)")
        spp = opts.max_sample_count
        shared["cases"][key] = dict(
            bit_equal_to_serial_oracle=True, mean_gap=gap, std_err=se,
            launches={"k1": ranks[0][key]["launches"][0], "k2": ranks[0][key]["launches"][1]},
            **{f"rank{i}": dict(frame_ms=r[key]["frame_ms"], collective_ms=r[key]["collective_ms"],
                                collectives_per_frame=r[key]["collectives_per_frame"],
                                collective_bytes_per_frame=r[key]["collective_bytes_per_frame"])
               for i, r in enumerate(ranks)},
            frame_median_ms=float(np.median(ranks[0][key]["frame_ms"])),
            mrays_per_s=BOX_W * BOX_H * spp / float(np.median(ranks[0][key]["frame_ms"])) / 1e3)
    need(all(r["twin_calls"] == 0 for r in ranks), "a rank called a twin on the card")
    c = shared["cases"]
    need(c["box_2x1"]["launches"]["k1"] > 0 and c["dragon_2x1"]["launches"]["k2"] > 0
         and c["box_2x1"]["launches"]["k2"] == 0, f"sharded launches: {c}")

    gopts = grad_options(pt)
    x, y = ptr.pixel_grid(gopts, 1, device="cuda")
    target = torch.zeros((x.shape[0], 4), device="cuda")
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in get_material_params(box).items()}
    loss = ptr.serial_image_loss(leaves, box, cam, gopts, (1, 2), target, x, y, SHARD_SEED,
                                 GRAD_SPP)
    loss.backward()
    errs = {}
    for i, r in enumerate(ranks):
        tr = r["train"]
        scale = max(float(v.grad.abs().max()) for v in leaves.values())
        err = max(float(np.abs(tr["grads"][k] - v.grad.cpu().numpy()).max())
                  for k, v in leaves.items())
        errs[i] = err
        need(err <= SHARD_GRAD_RTOL * scale and abs(tr["loss"] - float(loss.detach()))
             <= 1e-6 * abs(float(loss.detach())),
             f"rank {i}: the sharded gradient is {err} from the serial oracle's (scale {scale})")
    need(ranks[0]["train"]["record_launches"] > 0, "the sharded step did not run K2's record form")
    shared["train"] = dict(shape="1x2", loss=ranks[0]["train"]["loss"],
                           oracle_loss=float(loss.detach()), grad_max_abs_err=errs,
                           grad_scale=scale, record_launches=ranks[0]["train"]["record_launches"],
                           pass_ms=ranks[0]["train"]["pass_ms"])
    e0, e1 = ranks[0]["elastic"], ranks[1]["elastic"]
    need(e0["result"] == "done" and e0["chunks"] == 4 and e0["all_spp"]
         and e0["render_chunk_calls"] == 5 and [f[0] for f in e0["failovers"]] == [0]
         and e1["result"] == "exhausted" and e1["render_chunk_calls"] == 2,
         f"elastic failover: {e0} / {e1}")
    shared["elastic"] = dict(rank0=e0, rank1=e1)

    if torch.cuda.device_count() >= 2:
        res = pd.spawn_ranks(nccl_card_ranks, 2, "nccl", deadline_s=RANK_DEADLINE_S,
                             timeout_s=RANK_TIMEOUT_S)
        ref = pr.render_serial(box, cam, box_options(pt), (2, 1), seed=SHARD_SEED, device="cuda")
        need(all(np.array_equal(r["image"], ref) for r in res), "NCCL ranks: not the oracle")
        need(all(v is not None and "failover needs gloo" in v
                 for r in res for v in r["failover_refused"].values()),
             f"NCCL ranks: the failover did not refuse the NCCL mesh: {res[0]['failover_refused']}")
        shared["nccl_rank_per_card"] = dict(ran=True, frame_ms=[r["frame_ms"] for r in res],
                                            failover_refused=res[0]["failover_refused"])
    else:
        shared["nccl_rank_per_card"] = dict(ran=False, reason=f"{torch.cuda.device_count()} card")
    line(f"33 {label}", **shared)

    # 34: geometry parallel. The 1-rank render in this process's world of one.
    gp1 = pg.make_gp_mesh(device_type="cuda")
    need(dist.get_world_size() == 1, "phase 34's one-rank gp mesh")
    dopts = dragon_options(pt)
    lean_cpu = lean.to("cpu")
    one, one_ms = timed(lambda: pg.render_gp(pg.shard_scene_kernel_geometry(lean_cpu, 1), cam,
                                             dopts, gp1, seed=SHARD_SEED), 1)
    g = ranks[0]["gp_200k"]
    need(all(np.array_equal(r["gp_200k"]["image"], one) for r in ranks),
         "the 2-rank gp render is not the 1-rank one")
    need(np.isfinite(one).all() and bool((one[..., 3] == 1.0).all()), "gp frame")
    need(g["k4_launches"] > 0 and g["k5_launches"] > 0 and g["plain_calls"] == 0,
         f"the gp frame's launches: {g}")
    for i, r in enumerate(ranks):
        k = r["gp_200k"]["k4_shard"]
        need(k["t_bit_equal"] and k["prim_equal"] and k["counters_equal"],
             f"rank {i}: K4 on its shard differs from its plain version: {k}")
    full, hit = scenes.dragon_full_scene(cache_dir, device="cuda")
    need(hit, "phase 34's 7.2M scene was rebuilt")
    o, d = gp_query_rays()
    t, p = krn_intersect(full, o, d)
    t, p = t.cpu().numpy(), p.cpu().numpy()
    unsharded = int(full.krn_records.numel() + full.krn_cl_bounds.numel()) * 4
    del full
    for i, r in enumerate(ranks):
        q = r["gp_7p2m"]
        need(q["cache_hit"] and np.array_equal(q["t"], t) and np.array_equal(q["prim"], p),
             f"rank {i}: the 7.2M gp query is not the unsharded K4 query")
        need(0.45 * unsharded <= q["shard_tables_bytes"] <= 0.55 * unsharded,
             f"rank {i}: its records and cluster bounds are {q['shard_tables_bytes']} bytes of "
             f"{unsharded}")
    gp = dict(
        label="two ranks sharing one card (gloo on CUDA tensors)",
        dragon_200k_lean=dict(
            bit_equal_to_one_rank=True, frame_ms=[r["gp_200k"]["frame_ms"] for r in ranks],
            one_rank_frame_ms=one_ms, k4_launches=g["k4_launches"], k5_launches=g["k5_launches"],
            collectives_per_frame=g["collectives_per_frame"],
            collective_ms_per_frame=[r["gp_200k"]["collective_ms_per_frame"] for r in ranks],
            k4_shards=[r["gp_200k"]["k4_shard"] for r in ranks], image_mean=float(one[..., :3].mean())),
        dragon_7p2m=dict(
            rays=GP_QUERY_RAYS, bit_equal_to_unsharded_k4=True, hits=int((p >= 0).sum()),
            unsharded_records_and_bounds_bytes=unsharded,
            **{f"rank{i}": {k: v for k, v in r["gp_7p2m"].items() if k not in ("t", "prim")}
               for i, r in enumerate(ranks)}))
    line("34 geometry parallel on the card", **gp)
    dist.destroy_process_group()
    return shared, gp


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the demo PNGs and all figures here")
    ap.add_argument("--parent", help="a parent commit's chip_smoke.json (its --out), run on "
                                     "the same machine: phases 5, 7, 9, 11, 14, 16, 17, 18, "
                                     "20, 21, 23 and 25 print its figures; phase 2 holds the "
                                     "registers of the kernels that do not walk, the spills "
                                     "and occupancy of the main path's walking ones, and the end "
                                     "every bound of phases 5-30 to it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch import _build
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
    from cpupathtrace_tpu_torch.core.rays import Rays
    from cpupathtrace_tpu_torch.integrator import film
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
    from cpupathtrace_tpu_torch import diff
    from cpupathtrace_tpu_torch.models import golden, scenes
    from cpupathtrace_tpu_torch.ops import intersect as oi
    from cpupathtrace_tpu_torch.accel import binned, cluster_major as cm, traverse as tt
    from cpupathtrace_tpu_torch.experiments import best_ms
    from cpupathtrace_tpu_torch.experiments import cluster_major_sweep as cms
    from cpupathtrace_tpu_torch.experiments import intersect_sweep as isw
    from cpupathtrace_tpu_torch.experiments import cond_fat as cf
    from cpupathtrace_tpu_torch.experiments import dot_formulations as df
    from cpupathtrace_tpu_torch.experiments import record_variants as rv
    from cpupathtrace_tpu_torch.experiments import smem_tables as smt
    from cpupathtrace_tpu_torch.experiments import supscan as ss

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_name_power()
    report = {"device": kind, "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"[1 device] {kind} | count {torch.cuda.device_count()} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # Every kernel and the host BVH library, one compiler per source, all
    # started together.
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    for name in KERNELS:
        _build.load(name)
    ptxas = {name: _build.ptxas_summary(_build.ptxas_report.get(name, ""))
             for name in KERNELS if name not in ("bvh_build", "mesh_native")}
    box = scenes.bench_box_scene()
    report["build"] = dict(seconds=time.perf_counter() - t0,
                           compiler_seconds=dict(_build.build_seconds), ptxas=ptxas,
                           occupancy=kernel_occupancy(
                               mk, sw, kt, tt, oi, box,
                               mk.block_smem_bytes(box, mk.pack_tables(box))))
    parent_report = parent = None
    if args.parent:
        with open(args.parent) as f:
            parent_report = json.load(f)
        parent = parent_figures(parent_report)
        # The instances that do not walk stay as they were: every one of
        # the parent's build, register for register; the walking ones the
        # main path launches spill no more and hold as many blocks an SM.
        vs = ptxas_against_parent(ptxas, parent_report["build"]["ptxas"],
                                  report["build"]["occupancy"],
                                  parent_report["build"]["occupancy"])
        report["build"]["ptxas_vs_parent"] = vs
        need(not vs["differ"] and vs["instances_compared"] > 0,
             f"kernel instances differ from the parent's ptxas: {vs}")
        need(not vs["walk_regressed"],
             f"walking instances spill more or hold fewer blocks than the parent's: {vs}")
    line("2 build", **report["build"])

    report["kernel_vs_twin"] = phase_kernel_vs_twin(mk, scenes, Rays, pt.RenderOptions)
    line("3 kernel vs twin", **report["kernel_vs_twin"])
    report["golden"] = phase_golden(film, pt.RenderOptions)
    line("4 golden parity", **report["golden"])
    report["main_path"] = phase_main_path(pt, mk, sw, scenes, best_ms)
    if parent:
        report["main_path"]["parent"] = {k: parent[k] for k in (
            "device", "k1_dense_ms", "box_frame_median_s")}
    line("5 main path", **report["main_path"])
    report["demo"] = phase_demo(pt, scenes, args.out)
    line("6 demo", **report["demo"])

    dragon, report["dragon_build"] = phase_dragon_build(scenes)
    line("7 dragon build", **report["dragon_build"])
    # The lean build of the same dragon (K4's tables only): phase 11 holds
    # K5 to its frame's input, phase 18 renders it.
    t0 = time.perf_counter()
    lean = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, lean=True)
    report["dragon_build"]["lean_seconds"] = time.perf_counter() - t0
    report["cluster_query"] = phase_cluster_query(kt, sw, scenes, dragon, best_ms)
    if parent:
        report["cluster_query"]["parent"] = {k: parent[k] for k in (
            "device", "k4_ms", "k4_any_hit_ms")}
    line("7 cluster query vs plain", **report["cluster_query"])
    report["bounce_vs_twin"] = phase_bounce_vs_twin(sw, mk, scenes, dragon, pt.RenderOptions)
    line("8 bounce vs twin", **report["bounce_vs_twin"])
    report["dragon_main_path"] = phase_dragon_main_path(pt, sw, mk, kt, scenes, dragon)
    if parent:
        report["dragon_main_path"]["parent"] = {k: parent[k] for k in (
            "device", "k2_bounce_ms", "k2_frame_ms", "k2_depth1_unsorted_ms", "k2_lane_use")}
    line("9 dragon main path", **report["dragon_main_path"])
    sw.bounce.launches = 0
    sw.bounce_reference.calls = 0
    report["demo_dragon"] = phase_demo(pt, scenes, args.out, include_dragon=True)
    report["demo_dragon"].update(bounce_launches=sw.bounce.launches,
                                 twin_calls=sw.bounce_reference.calls)
    need(sw.bounce.launches > 0 and sw.bounce_reference.calls == 0,
         f"demo with dragon did not run the bounce kernel alone: {report['demo_dragon']}")
    line("10 demo with dragon", **report["demo_dragon"])

    report["dense_query"] = phase_dense_query(pt, oi, sw, tt, isw, scenes, lean, best_ms)
    if parent:
        report["dense_query"]["parent"] = {k: parent[k] for k in (
            "device", "k5_ms", "k5_best_ms")}
    line("11 dense query vs plain", **report["dense_query"])
    report["wavefront"] = phase_wavefront(pt, film, oi, mk, scenes, pt.RenderOptions)
    line("12 wavefront forward", **report["wavefront"])
    report["records"] = phase_records(sw, mk, scenes, dragon, pt.RenderOptions)
    line("13 record form vs twin", **report["records"])
    report["box_grad"] = phase_box_grad(diff, sw, oi, scenes, golden, pt.RenderOptions, best_ms)
    if parent:
        report["box_grad"]["parent"] = {k: parent[k] for k in (
            "device", "grad_ms_per_pass", "k2_records_ms")}
    line("14 renderSceneBoxGrad", **report["box_grad"])
    report["inverse_render"] = phase_inverse_render(diff, golden, pt.RenderOptions)
    line("15 inverse_render", **report["inverse_render"])

    # The binned wavefront needs the dragon's K6/K7 tables: phase 7 built
    # the scene with lean=False, the builder's default.
    need(dragon.trv_bounds.shape[0] > 1 and not dragon.lean, "the dragon has no K6/K7 tables")
    report["binned_kernels"], nearest = phase_binned_kernels(pt, tt, oi, isw, scenes, dragon,
                                                             best_ms)
    if parent:
        report["binned_kernels"]["parent"] = {k: parent[k] for k in (
            "device", "k7_ms", "k7_best_ms", "k6_ms", "k6_best_ms")}
    line("16 binned wavefront kernels vs plain", **report["binned_kernels"])
    report["cluster_major"] = phase_cluster_major(cm, cms, binned, tt, oi, dragon, nearest,
                                                  best_ms)
    if parent:
        report["cluster_major"]["parent"] = {k: parent[k] for k in (
            "device", "k8_ms", "k8_best_ms")}
    line("17 cluster-major entry (K8)", **report["cluster_major"])
    report["binned_wavefront"] = phase_binned_wavefront(pt, tt, oi, sw, mk, kt, scenes, dragon,
                                                        lean)
    if parent:
        report["binned_wavefront"]["parent"] = {k: parent[k] for k in (
            "device", "binned_frame", "lean_frame")}
    line("18 binned wavefront frame", **report["binned_wavefront"])
    report["dragon_grad"] = phase_dragon_grad(diff, golden, sw, tt, scenes, dragon,
                                              pt.RenderOptions)
    line("19 dragon gradients vs FD", **report["dragon_grad"])
    report["k1_binned"] = phase_k1_binned(mk, sw, scenes, dragon, pt.RenderOptions)
    if parent:
        report["k1_binned"]["parent"] = {k: parent[k] for k in (
            "device", "k1_binned_ms", "k1_binned_ms_cluster128", "k1_binned_lane_use",
            "k1_binned_lane_use_cluster128")}
    line("20 K1 binned form vs twin", **report["k1_binned"])
    report["dragon_k1_frame"] = phase_dragon_k1_frame(pt, sw, mk, scenes, dragon)
    # The two redesigned walks side by side: K2 on the sorted frame's own
    # state (phase 9), K1's binned kernel (phase 20).
    dm, k1w = report["dragon_main_path"], report["k1_binned"]
    report["dragon_k1_frame"]["walks"] = dict(
        k2=dict(bounce_ms=dm["bounce_ms"], frame_ms=dm["k2_frame_ms"],
                frame_bound_ms=dm["frame"]["bound_ms"], launches=dm["launches"],
                **{k: dm["frame"][k] for k in WALK_KEYS}),
        k1_binned=dict(ms=k1w["ms"], bound_ms=k1w["bound_ms"],
                       **{k: k1w["walk"][k] for k in WALK_KEYS}),
        parent=parent)
    line("21 dragon frame: K1 binned vs sorted driver", **report["dragon_k1_frame"])
    report["box_sorted"] = phase_box_sorted(pt, sw, mk, scenes)
    line("22 box through the sorted driver", **report["box_sorted"])
    report["experiments"] = phase_experiments(ss, rv, smt, cf, df, best_ms)
    if parent:
        report["experiments"]["supscan"]["parent"] = {k: parent[k] for k in (
            "device", "x1_ms", "x1_sweep")}
        report["experiments"]["record_variants"]["parent"] = {k: parent[k] for k in (
            "device", "x3_ms", "x3_us_per_record")}
        report["experiments"]["cond_fat_parent"] = {k: parent[k] for k in (
            "device", "x2_ms", "x2_iter_us")}
    line("23 microbenchmarks X1 X2 X3 X4 X5", **report["experiments"])

    from cpupathtrace_tpu_torch.integrator import checkpoint as ck
    from cpupathtrace_tpu_torch.scene import cache as cache_mod

    # The 7.2M scene's cache stays until phase 31 reads the scene back.
    cache_dir = os.path.join(ROOT, "build", f"chip_smoke_cache_{os.getpid()}")
    packed: dict = {}
    try:
        full, report["dragon_full_cache"] = phase_dragon_full_cache(scenes, cache_mod, cache_dir,
                                                                    packed)
        line("24 renderSceneDragonBoxFull: cold build, cache, load", **report["dragon_full_cache"])
        report["dragon_full_frames"] = phase_dragon_full_frames(pt, sw, mk, kt, scenes, full)
        if parent:
            report["dragon_full_frames"]["parent"] = {k: parent[k] for k in (
                "device", "k2_7p2m_ms", "k1_7p2m_ms", "k2_7p2m_lane_use", "k1_7p2m_lane_use")}
        line("25 renderSceneDragonBoxFull frames: sorted driver (K2) and K1 binned",
             **report["dragon_full_frames"])
        report["dragon_full_resume"] = phase_dragon_full_resume(pt, ck, sw, mk, scenes, full,
                                                                cache_dir)
        line("26 resume on the card", **report["dragon_full_resume"])
        del full
        report["native_pipeline"] = phase_native_pipeline(scenes, packed)
        del packed
        line("27 the C++ host pipeline against numpy at 7.2M", **report["native_pipeline"])
        report["obj_dragon"] = phase_obj_dragon(pt, sw, mk, kt, scenes, dragon)
        line("28 the OBJ dragon: C++ parse, sorted driver (K2) and K1 binned",
             **report["obj_dragon"])
        report["demo_cli"] = phase_demo_cli(pt, args.out)
        line("29 the demo app", **report["demo_cli"])
        report["example"] = phase_example()
        line("30 the inverse-rendering example", **report["example"])
        report["frame_budget"] = phase_frame_budget(pt, sw, mk, kt, scenes, dragon, cache_dir,
                                                    args.out, best_ms)
        # The sharded paths: one rank, then two ranks sharing the card.
        report["sharded_one_rank"], _ = phase_sharded_one_rank(pt, mk, scenes, ck,
                                                               report["main_path"], args.out)
        line("32 sharded render, one rank (NCCL, a world of one)", **report["sharded_one_rank"])
        report["sharded_shared"], report["gp"] = phase_shared_card(pt, scenes, dragon, lean,
                                                                   cache_dir, ck)
        # The benchmark runner in a process of its own, the 7.2M scene from
        # phase 24's cache.
        report["bench"] = phase_bench(pt, cms, scenes, cache_dir)
        line("35 the benchmark runner (python -m cpupathtrace_tpu_torch.bench)",
             **report["bench"])
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    if parent_report:
        # Phases 5-30 run the parent's work on the parent's inputs: every
        # bound they print is the parent's number.
        phases = [k for k in report if k not in ("device", "nvidia_smi", "torch", "cuda", "build",
                                                  "kernel_vs_twin", "golden", "frame_budget",
                                                  "sharded_one_rank", "sharded_shared", "gp",
                                                  "bench")]
        report["bounds_vs_parent"] = bounds_against_parent(report, parent_report, phases)
        line("31 bounds of phases 5-30 against the parent's", **report["bounds_vs_parent"])
        need(not report["bounds_vs_parent"]["differ"] and report["bounds_vs_parent"]["compared"],
             f"bounds differ from the parent's: {report['bounds_vs_parent']}")

    main_path = report["main_path"]
    dragon_path = report["dragon_main_path"]
    depth1 = dragon_path["depth1"]
    query = report["cluster_query"]
    k5 = report["dense_query"]
    grad = report["box_grad"]
    krec = grad["record_kernel"]
    bk = report["binned_kernels"]
    bw = report["binned_wavefront"]["counts"]
    lean = report["binned_wavefront"]["lean"]
    k8 = report["cluster_major"]
    k1b = report["k1_binned"]
    xp = report["experiments"]
    ff = report["dragon_full_frames"]
    fb = report["frame_budget"]

    def full_figures(route, run, kernel):
        """A kernel's 7.2M readings (phase 25) for its row."""
        r = ff[route]
        return dict(scene="renderSceneDragonBoxFull, 7.2M triangles (lean, 128-row records)",
                    tiers=ff["tiers"], launches=r["launches"][kernel], ms=run["ms"],
                    plain_ms=run["plain_ms"], plain_rays=run["plain_rays"],
                    bound_ms=run["bound_ms"], bound_by=run["bound_by"],
                    max_abs_err=run["max_abs_err"], frame_median_s=r["frame_median_s"],
                    mrays_per_s=r["mrays_per_s"])

    def figures(d):
        return {k: d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    obj = report["obj_dragon"]
    one, shared, gp = report["sharded_one_rank"], report["sharded_shared"], report["gp"]

    def shared_row(case):
        """A two-rank case of phase 33 for its kernel's row."""
        c = shared["cases"][case]
        return dict(label=shared["label"], launches=c["launches"],
                    frame_median_ms=c["frame_median_ms"], mrays_per_s=c["mrays_per_s"],
                    collective_ms=[c[f"rank{i}"]["collective_ms"] for i in range(SHARED_RANKS)],
                    bit_equal_to_serial_oracle=c["bit_equal_to_serial_oracle"])

    def obj_figures(route, kernel):
        """A kernel's readings on the OBJ-loaded 200k dragon (phase 28)."""
        r = obj[route]
        return dict(launches=r["launches"][kernel], frame_median_ms=r["frame_median_ms"],
                    mrays_per_s=r["mrays_per_s"],
                    **{k: r[kernel][k] for k in ("ms", "plain_ms", "plain_rays", "bound_ms",
                                                 "bound_by", "max_abs_err")})

    k3 = ("K3, cpupathtrace_tpu_torch/csrc/cluster_traverse.cuh "
          "(cpupathtrace_tpu/accel/kernel_traverse.py:1041,1106)")
    kernels = {"kernels": [{
        "name": "megakernel", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "cpupathtrace_tpu/integrator/pallas_megakernel.py:345",
        "launches": main_path["launches"],
        "max_abs_err": main_path["agreement"]["max_abs_err"],
        "ms": main_path["kernel_ms"], "plain_ms": main_path["twin_ms"],
        "bound_ms": main_path["bound_ms"], "bound_by": main_path["bound_by"],
        "library_ms": None,
        "lane_use": main_path["refill"]["lane_use"],
        "occupancy": main_path["refill"]["blocks_per_sm"],
        "budget": {"box": fb["box/k1"]["budget"]},
        "sharded": {"one_rank": {k: one[k] for k in ("frame_median_ms", "mrays_per_s",
                                                     "k1_launches", "bit_equal")},
                    "two_ranks_sharing_the_card": {k: shared_row(k) for k in
                                                   ("box_2x1", "box_1x2")}},
    }, {
        "name": "bounce", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/bounce.cu",
        "replaces": "cpupathtrace_tpu/integrator/sorted_wavefront.py:252",
        "inlines": k3,
        "launches": dragon_path["launches"],
        "max_abs_err": max(dragon_path["max_abs_err"], ff["sorted"]["k2"]["max_abs_err"],
                           obj["sorted"]["k2"]["max_abs_err"]),
        "ms": depth1["kernel_ms"], "plain_ms": depth1["twin_ms"],
        "bound_ms": depth1["bound_ms"], "bound_by": depth1["bound_by"],
        "per": "one launch: depth 1 of the frame's camera rays, unsorted",
        "library_ms": None,
        "frame_ms": dragon_path["k2_frame_ms"], "frame_bounce_ms": dragon_path["bounce_ms"],
        "frame_bound_ms": dragon_path["frame"]["bound_ms"],
        "dragon_full": full_figures("sorted", ff["sorted"]["k2"], "k2"),
        "obj_dragon": obj_figures("sorted", "k2"),
        "budget": {k: fb[f"{k}/k2"]["budget"] for k in ("dragon_200k", "dragon_7p2m")},
        "sharded": {"two_ranks_sharing_the_card": {"dragon_2x1": shared_row("dragon_2x1")}},
    }, {
        "name": "bounce_records", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/bounce.cu",
        "replaces": "cpupathtrace_tpu/integrator/sorted_wavefront.py:252",
        "launches": grad["replay"]["counts"]["k2_records"],
        "max_abs_err": max(report["records"]["max_abs_err"], krec["max_abs_err"],
                           krec["records_max_abs_err"]),
        **figures(krec), "library_ms": None, "kernel_ms": krec["kernel_ms"],
        "sharded": {"train_1x2_sharing_the_card": {k: shared["train"][k] for k in (
            "record_launches", "pass_ms", "grad_max_abs_err", "grad_scale")}},
    }, {
        "name": "cluster_query", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/cluster_query.cu",
        "replaces": "cpupathtrace_tpu/accel/kernel_traverse.py:1201",
        "inlines": k3,
        "launches": lean["counts"]["k4"],
        "launches_per": "the lean dragon frame through the wavefront (phase 18)",
        "max_abs_err": query["max_abs_err"],
        **figures(query), "best_ms": query["best_ms"], "library_ms": None,
        "frame_device_ms": lean["profile"]["kernels"]["cluster_query_kernel"]["us"] / 1e3,
        "gp": {"dragon_200k_lean_2_ranks": {k: gp["dragon_200k_lean"][k] for k in (
            "k4_launches", "frame_ms", "k4_shards")},
               "dragon_7p2m_2_ranks": gp["dragon_7p2m"]},
    }, {
        "name": "dense_intersect", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/dense_query.cu",
        "replaces": "cpupathtrace_tpu/ops/pallas_intersect.py:31",
        "launches": grad["wavefront"]["counts"]["k5"],
        "max_abs_err": k5["max_abs_err"],
        **figures(k5), "best_ms": k5["best_ms"], "library_ms": None,
        "gp": {"dragon_200k_lean_2_ranks": {"k5_launches": gp["dragon_200k_lean"]["k5_launches"]}},
    }, {
        "name": "binned_cand", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/binned_cand.cu",
        "replaces": "cpupathtrace_tpu/accel/pallas_traverse.py:121",
        "launches": bw["k6"],
        "max_abs_err": bk["max_abs_err"],
        **figures(bk["k6_frame"]), "best_ms": bk["k6_frame"]["best_ms"], "library_ms": None,
    }, {
        "name": "binned_isect", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/binned_isect.cu",
        "replaces": "cpupathtrace_tpu/accel/pallas_traverse.py:238",
        "launches": bw["k7"],
        "max_abs_err": bk["k7_max_abs_err"],
        **figures(bk["k7_frame"]), "best_ms": bk["k7_frame"]["best_ms"], "library_ms": None,
    }, {
        "name": "cluster_major", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/cluster_major.cu",
        "replaces": "cpupathtrace_tpu/accel/pallas_binned.py:62",
        "launches": k8["launches"],
        "max_abs_err": k8["max_abs_err"],
        **figures(k8), "best_ms": k8["best_ms"], "library_ms": None,
    }, {
        "name": "megakernel_binned", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "cpupathtrace_tpu/integrator/pallas_megakernel.py:1189",
        "inlines": k3,
        "launches": report["dragon_k1_frame"]["k1"]["launches"]["k1"],
        "max_abs_err": max(k1b["max_abs_err"], ff["k1"]["k1"]["max_abs_err"],
                           obj["k1"]["k1"]["max_abs_err"]),
        **figures(k1b), "library_ms": None,
        "dragon_full": full_figures("k1", ff["k1"]["k1"], "k1"),
        "obj_dragon": obj_figures("k1", "k1"),
        "budget": {k: fb[f"{k}/k1"]["budget"] for k in ("dragon_200k", "dragon_7p2m")},
    }, {
        "name": "supscan", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/exp_supscan.cu",
        "replaces": "benchmarks/experiments/microbench_supscan.py:46",
        "launches": xp["supscan"]["launches"],
        "max_abs_err": xp["supscan"]["max_abs_err"],
        **figures(xp["supscan"]), "library_ms": None,
    }] + [{
        "name": f"record_variants_{v}", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/exp_record_variants.cu",
        "replaces": "benchmarks/experiments/exp_record_variants.py:229",
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
        **figures(r), "best_ms": r["best_ms"], "library_ms": None,
    } for v, r in xp["record_variants"]["variants"].items()] + [{
        "name": "smem_tables", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/exp_smem_tables.cu",
        "replaces": "benchmarks/experiments/microbench_smemtables.py:41",
        "launches": xp["smem_tables"]["launches"],
        "max_abs_err": xp["smem_tables"]["max_abs_err"],
        **figures(xp["smem_tables"]), "library_ms": xp["smem_tables"]["library_ms"],
    }] + [{
        "name": f"cond_fat_{name}", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/exp_cond_fat.cu",
        "replaces": "benchmarks/experiments/microbench_cond_fat.py:39",
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
        **figures(r), "library_ms": None,
    } for name, r in xp["cond_fat"].items()] + [{
        "name": f"dot_formulations_{form}", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/exp_dot_formulations.cu",
        "replaces": "benchmarks/experiments/exp_dot_formulations.py:56",
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
        **figures(r), "library_ms": r["library_ms"],
    } for form, r in xp["dot_formulations"].items()]}
    report["seconds"] = time.perf_counter() - t_start
    line("36 total", seconds=report["seconds"])
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(report, **kernels), f, indent=1, default=float)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
