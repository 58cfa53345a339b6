#!/usr/bin/env python3
"""Smoke run of distance_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the kernels from
``distance_tpu_torch/csrc`` (K1 the counters, K2 the rel4/rel packs, K3
the diff rebuild, K4 the narrow/wide packs, K5 the features and K6 their
contraction, the cached-feature path that the engine's measure set,
``engine.CACHED_MEASURES``, sends the square's, the rectangle's and the
stream's blocks through where their caches fit, K7 the tn93 base count
and K8 the dry run's float32 estimate), holds each against its plain
PyTorch version, drives the port's CLI on SARS-CoV-2-scale synthetic
alignments made from a seed (29904 sites) in its three modes, in and out
of core, with diff-encoded uploads and the pack ladder on, checks the
output, and times the kernels beside their plain versions.  Phases:

1. environment: the card, torch, CUDA, nvcc; build the kernels and print
   ptxas's registers, shared memory and spills; the free device memory,
   the engine's auto budget and the square's in-core crossover for raw
   and tn93, and up to where the g cache engages in core;
2. K1 against its plain version, exactly, for all six measures:
   the truth table (code 0 and every Paradis code over 64 sites, on both
   sides, also against each counter's predicate table), shapes on either
   side of the kernel's tile edges (127/128/129 x 255/256/257 rows at
   31/32/33 and 4095 sites), ragged shapes, the stream's narrow widths
   (1, 3 and 129 sites, copied into 16-site rows by the wrapper), an
   empty side, a 512 x 512 block of the bench alignment, and the
   launches of the stream phase (2000 loaded rows against groups of 2000
   and 384 rows, and the benchmark's of 2096), of phase 9 (square blocks of 1024 x 1024, rectangle
   blocks of 512 x 1024, loaded super-rows of 3072 and 2048 rows against
   groups of 2000 and 96, and 4,194,305 loaded rows of 64 sites against
   8 and against the 1-row reference) and of phase 10's staged shard
   (loaded super-rows of 1024 and 976 rows against a group of 8000), the
   rel baselines (8192 and 2000 rows against the 1-row reference row, it
   against 8192 and 2096 rows, and itself), sites padded as the engine
   uploads them; and for raw and tn93 at 4,194,305 x 8 x 16, more x row
   tiles than one grid axis of 65535 blocks holds.  K2 (rel4 and rel)
   against its plain version, exactly: the square's 2048 x 2048 diagonal
   block with its self-pairs and padding masked and the stream's 2000 x
   2096 group, six measures, counters with chosen outliers (segments
   holding 0, 1, 2, 3 and many), and for each measure's G (1-4) rel4's
   segment edges (``edge_counters``: segments of 7, 8 and 2 cells, a
   byte across two segments, every cell out, the last segment partial,
   a residual of -2^31, no cells; baselines read in place as row slices);
   K3 against its plain version on the
   square's 8192 x 29952 upload (its rows equal to the dense upload, pad
   rows the reference row), with no diffs and capacity-many, and at the
   card tests' edges (``tests/test_torch_cuda.py::K3_EDGES``,
   ``K3_CARD_EDGES``: widths 128, 29952 and 65664, 0, 1 and 4,194,305
   rows, no diffs, a capacity all tail, a row all diffs, the first and
   last bytes of rows, tiles and words, an empty tile beside a full one,
   negative indices, a matrix just under 2^31 bytes); K4 (narrow
   and wide) byte-equal to its plain version for six measures on the
   square's block and the stream's group and on counters around the
   saturation points (254, 255, 256 in a lane, width - sum at 255) at
   widths 1, 29904 and 65535; and K2 and K4 at every packed block of
   phase 9's out-of-core runs and phase 10's staged shard
   (``OOC_LAYOUTS``, ``ooc_blocks``): K2 at the block's position with its
   out-of-core masks (valid rows of both sides, self-pair offset), K4 at
   its shape.  K5 byte-equal to its plain version for the six measures on
   both sides (``phase_cached_vs_plain``): the truth table (code 0 and
   every Paradis code at every offset of a 16-site piece), widths 16,
   4095 and 29952, 0 and 1 rows (``tests/test_torch_cuda.py::K5_EDGES``)
   and an output past 2^31 bytes; K6 equal to its plain version for the
   six measures in both plan forms (the JAX plan's channels and K1's
   folded ones): K1's tile edges and 1-row baselines
   (``K6_EDGES``), an empty side, a g-cache slice at j0 > 0 against an
   f-cache slice at i0 > 0 read at their strides, the main path's
   launches (a 2048-row strip against 2048-row slices of the square's
   8192-row g cache, its baselines, phase 12's out-of-core blocks and
   baselines, the stream's 2000-row f cache against its groups' g
   features of 2000, 384, 4000 (tn93), 2096 and 1712 rows and its
   baselines, phase 12's staged
   stream parts, ``STREAM_CACHED_LAUNCHES``) and a g cache past 2^31
   bytes.  K7 equal to its plain version at the card tests' edges
   (``tests/test_torch_cuda.py::K7_EDGES``) and at phase 14's uploads of
   the bench alignment; K8 bit for bit (NaN cells alike) at ``K8_SHAPES``
   for the six measures, as the whole-block call and over 1, 2 and 4
   site partials in each of ``K8_LAYOUTS`` (fresh tensors, inputs or
   inputs and output a cell past a 16-byte boundary, partials whose
   offsets differ, a window at col0 = 1 of a wider output whose other
   cells stay as they were), and at the dry run's stage-1 counters
   (``phase_count_and_estimate_vs_plain``);
3. the square path: the CLI on the 8192 x 29904 alignment, ``-m raw
   --backend cuda``; line count, 1200 random rows against the host
   oracle, each kernel's launch count in that run (10 blocks at rel4; 3
   baselines through K1, or through K6 one a strip (4) and 2 more; the
   refetches by rung, packed from the counters the first dispatch kept:
   K1 = K1 first dispatches + K1 baselines, K6 = K6 first dispatches + K6
   baselines, K5 = the feature builds, on every path,
   ``check_launches``), a ``torch.profiler`` split of a
   second run's device time, and the same square once more dense and
   without a reference row (DISTANCE_TPU_NO_DIFF_UPLOAD=1
   DISTANCE_TPU_NO_REL_PACK=1: the ladder narrow -> wide): same sha256,
   its launches per rung, wall and split;
4. all six measures end to end at 256 x 29904: ``--backend cuda`` and
   ``--backend torch`` write identical bytes;
5. K1 against its plain version and the int8-GEMM yardstick
   (each counter as one ``torch._int_mm`` on its folded features, built
   outside the timed window) at the square path's block shape (2048 x
   2048 x 29952 padded sites) for all six measures: equal, timed on the
   card in turns, beside the bound (2 m n L R int8 operations at 1,979
   TOP/s, L = 29904 real sites, R = the JAX plan's channels); K2 and K4
   at raw on the 2048 x 2048 block and the 2000 x 2096 group, reading
   their counters cold from a ring of copies larger than the L2
   (``cold_ring_ms``: the kernel's time by the profiler against its
   bound in bytes at 3.35 TB/s, and a call's by CUDA events), and K2's
   time a launch in phase 3's square run; K3 (``time_k3``) the same three
   ways, its inputs read cold, at the square's 8192 x 29952 upload, a
   stream group of 2096 records and an out-of-core super-row of 1024
   (``k3_uploads``), beside its bound (bytes written and read at 3.35
   TB/s), its plain version and its yardstick (``expand().clone()`` and
   ``index_put_``), and its time a launch in phase 3's square run; the
   numbers at the square's shapes go into the result line.  K6
   (``phase_cached_timing``) at the same 2048² x 29952 block for the six
   measures, in both plan forms, beside K1, its bound (the same
   operations as K1's, or its features read once at 3.35 TB/s), its plain
   version and both yardsticks (``torch._int_mm`` a folded counter, and
   one ``torch._int_mm`` a channel with the planes and the mix in torch),
   and K5 at the square's 8192 x 29952 g cache and a 2048-row strip
   beside its byte bound; then K6 at the stream's 2000 x 2096 group
   beside its bound and K1 at the same shape, and K5 at the group's
   2096-row g features and the 2000-row f cache;
6. the rectangle path: the CLI on 4096 x 8192 x 29904 (two files cut
   from one alignment), ``-m raw``; line count, 1200 random rows, launch
   count, and a ``torch.profiler`` split of a second run's device time
   into the kernel, H2D and D2H;
7. the stream path: 2000 loaded x 16384 streamed x 29904 with ``-b
   1000``, ``-m raw``: eight groups of 2000 records and one of 384 (the
   in-core group holds whole batches up to 2096 records, the engine's
   pairs cap at 2000 loaded, which the phase reads from the engine on
   the card: 4194 at tn93), so group ends are ragged and a pinned buffer is refilled; line count, 1200
   random rows, one K6 launch per group against the loaded rows' f
   cache (K5 once), each group's g features (K5 once a group), the
   baselines through K6 (``check_stream_cached``: no K1), the TSV's
   sha256, and the profiler split;
8. all six measures, ``--backend cuda`` against ``--backend torch``:
   identical bytes for a 128 x 256 rectangle and a 128-loaded x
   300-streamed stream with ``-b 7``;
9. out of core: the engine's device and host budgets (and tiles) are
   lowered in this process, the data keeps its full size.  K1's out-of-core
   path (the engine's measure set emptied in this process, as for a
   measure outside it or a cache that does not fit; phase 12 runs the
   cached one): the square of
   phase 3, the rectangle of phase 6 and a stream of 8192 loaded x 4096
   streamed records (``-b 1000``) run out of core, diff-uploaded and
   packed, with at least 3 X groups (the stream: 2 groups) and 3
   super-rows, the last of each ragged; its kernel launches have the
   shapes phase 2 checked (K1), its packed blocks the positions and masks
   of its layout and its K2/K4 launches ones phase 2 checked, each TSV's
   sha256 equals the in-core run's,
   the peak device memory stays within the budget, the K1 launches split
   into blocks by rung and baselines, the host diff encodes per super-row
   show the memo's hits, CUDA events time the K1 launches, and a
   profiled repeat splits the device time; the square once more dense
   and without a reference row (same sha256).  Then, with the engine's
   own measure set, the six measures out of core at small shapes
   (square 256, rectangle 128 x 256, stream 128 x 300 ``-b 7``) against
   the in-core ``--backend torch`` bytes, and an in-core stream of 8
   records against 4,194,305 loaded records of 64 sites (one K1 launch:
   its 9.66 GB f cache passes half of the feature-cache budget, so the
   stream takes K1; line count and 1200 random rows);
10. more than one process: the stream of phase 7 in two shards in this
   process, ``--shard 0/2`` in core (groups 0 and 2: 2 K6 launches) and
   ``--shard 1/2`` staged under a device budget of 600 MB (group 1
   against loaded super-rows of 1024 and 976 rows: 2 K1 launches, as
   the group's g features alone pass the budget), their
   ``.units`` sidecars, and ``--merge``, whose sha256 must be phase 7's;
   then as subprocesses on the same card, each TSV's sha256 against the
   single run's and each wall beside one single-process subprocess
   wall: ``--launch 2`` of the square of phase 3 and of the stream,
   ``--num-hosts 2 --host-id k`` of the stream (two processes), and
   ``--coordinator 127.0.0.1:<port>`` (a gloo rendezvous) of a 2048-row
   square (two processes);
11. the pack ladder: a square of 1024 random records (0.5% N) whose
   residuals saturate rel4 and rel, so its block is dispatched at rel4,
   rel and wide; the same square without a reference row, narrow and
   wide; and a square of 256 random records at 65600 sites, rel4, rel
   and int32; launches per rung, line count and 1200 random rows each;
12. the cached-feature path (``phase_cached``): the square of phase 3 and
   the rectangle of phase 6 for raw and tn93, with the engine's measure
   set holding the measure and then empty (K1): equal sha256, no K1
   launch in the cached run, K5 = 1 g cache + one f build a strip + 2
   for the reference row, K6 = first dispatches + baselines; and the
   square out of core for tn93 (``OOC_CACHED``: each X group with its f
   cache, each super-row with its g cache): the in-core sha256, K5's
   builds by kind, peak device memory within the budget; the stream of
   phase 7 for raw and tn93 through K5 + K6 and through K1
   (``DISTANCE_TPU_FEATCACHE_BUDGET=0``), and the tn93 stream of 8192
   loaded x 4096 records in core and staged with its caches
   (``STREAM_CACHED``: each super-row with its f cache, each group's g
   features once) and staged through K1: equal sha256 each;
13. more than one device (``phase_multi_device``): the engine's
   ``devices_of`` returns every card, or on a host of one card two
   logical devices on it (``SPLIT_DEVICES``), each with its own stream;
   the square of phase 3, the rectangle of phase 6, the stream of phase
   7 and the square for tn93 each run on one device and split (every
   block's columns, every stream group's records, over the devices):
   equal sha256, the split run's launches as ``check_split`` derives
   them from the one-device run's (a launch and a pack a part at the
   part shapes, K5 by part, K3 a part an upload, the row baselines once),
   the first strip's merged rel4 sidecars equal to the one-device run's,
   both walls (logical devices on one card: not a scaling figure); the
   out-of-core square of phase 9 split (its sha256, its launches against
   phase 9's); and ``parallel.mesh.sharded_counters`` on a (2, 2) grid
   of four logical devices against the plain version, six measures at
   2000 x 8000.
   Phase 2 holds every launch of the split runs against its plain
   version, six measures: K1 at the out-of-core square's parts (1024 x
   512 on two devices); K5 building each part's blocked g cache of the
   square and K6 of a strip against it at a nonzero offset, the loaded
   rows against each part of a stream group (2000 x 1048 and 2000 x
   952, and 2000 x 384) and the parts' column baselines; K2 rel4 (each part a window of
   its block, the merged sidecars against the whole block's) and rel on
   the parts of the square's diagonal block, of a stream group and of
   the out-of-core square's blocks at each of their positions and masks,
   and K4 at those parts' shape.

14. the JAX package's last device functions and its fuzzer's lattice
   (``phase_last_functions``): the tn93 square of phase 12 with
   DISTANCE_TPU_BASECOUNT_DEVICE_MIN=0 (its tallies by K7, 8 uploads; the
   sha256 of phase 12's host-count run), ``distance_tpu_torch.dryrun``'s
   ``dryrun_multichip`` on two logical devices of the first card and on
   every card (stage 1's sharded step: one K8 a grid row over the row's
   partials, with ``sharded_counters`` made to raise, so no (G, m, n)
   total; stage 2's split sweep against ``--backend torch``), and
   ``fuzz_one(seed, "cuda")`` of ``scripts/fuzz_differential_torch.py``
   for ``FUZZ_SEEDS`` (each configuration's knobs on the card against
   ``--backend torch``), its time printed; then K7 timed at the square's
   8192 x 29904 codes (a launch, and ``engine._count_bases_device`` with
   its uploads) beside its byte bound and plain version
   (``time_count_and_estimate``), and K8 (``time_k8``) at 2048² for each
   measure read cold from a ring (the profiler's kernel time, a CUDA
   graph's launch, a call) beside its byte bound, its plain version and,
   for n and n_high, ``counters[0].to(torch.float32)``; and the k80 step
   on a (1, 2) grid after its partials, fused (one K8 over both) and
   unfused (the total's zeros, adds, cat, then K8), each piece apart.

Phases 2-12 and 14 run the engine on the first card alone
(``engine_devices``; the dry run on its devices), their subprocesses
with ``CUDA_VISIBLE_DEVICES``
set to it: on a host of several cards phase 13 and phase 14's dry run
on every card are the only ones that split.

Every profiled run's split shows device time for each kernel it
launched.  K3's launches on each path of phases 3-11 must be
``K3_LAUNCHES``.
Any failed check raises, and the script exits non-zero without a result.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the ten kernels (``counters``, ``pack_rel4``, ``pack_rel``,
``pack_narrow``, ``pack_wide``, ``diff_rebuild``, ``features``,
``contract``, ``base_counts``, ``estimate``) with their launches per path
(``multi_device`` for phase 13's split runs, phase 14's by its runs),
errors, times and bounds.
Without a CUDA device, or without the package beside it, it fails.

    python3 chip_smoke.py --measure

builds the kernel and measures instead of checking: the rectangle and
the stream above for each of the six measures, the stream with ``-b 1``
and ``-b 100``, a stream of 131072 records (wall, host phase totals
and the profiler split), and phase 9's three runs in core and out of
core for each measure (with the K1 launches and their time by CUDA
events out of core).

    python3 chip_smoke.py --measure-ooc

measures that last part alone, and

    python3 chip_smoke.py --measure-k3

times K3 alone as phase 5 does, summing every kernel its calls launch.
Copied into another checkout and run there, it times that checkout's
K3, so that two versions compare in one call.

    python3 chip_smoke.py --measure-k8

times K8 alone as phase 14 does (``time_k8``); copied into another
checkout it times that checkout's K8 and unfused step (and the fused
step where that checkout has one).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None  # the port must never import jax

import numpy as np

N_BENCH = 8192
L_BENCH = 29904
BLOCK = 2048
SEED = 0
N_RECT = (4096, 8192)
N_STREAM = (2000, 16384)
STREAM_BATCH = 1000
# The in-core stream's group against N_STREAM[0] loaded records at raw:
# about engine.STREAM_GROUP_PAIRS pairs (``engine._stream_pairs_cap``), the
# group of the benchmark's stream cells (-b 1: 7 groups of 2096 records and
# one of 1712).  The kernels are held against their plain versions, and
# timed, at it.
STREAM_GROUP_ROWS = 2096
# The groups the stream phase forms: whole -b batches, up to
# STREAM_GROUP_ROWS records a group; tn93's plan of four counters takes
# twice the pairs (4194 records a group).
STREAM_GROUPS = (2000,) * 8 + (384,)
STREAM_GROUPS_TN93 = (4000,) * 4 + (384,)
# A shard's groups (phase 10): whole -b batches up to the engine's cap of
# 8192 records, the cut every shard makes whatever its card (a shard's
# group takes no pairs cap).
SHARD_GROUPS = (8000, 8000, 384)
N_STREAM_LONG = 131072
SAMPLES = 1200
# (x rows, y rows, sites) of the kernel's long-x check: more row tiles of
# 64 than a grid axis of 65535 blocks holds.
LONG_X = (4_194_305, 8, 16)
# Phase 9.  Each out-of-core run keeps its data at full size and lowers
# only the engine's budgets and tiles, in this process: (device budget,
# host budget, (TILE_I, TILE_J)).  At raw and 29904 sites they give 3 X
# groups (stream: 3 groups) and 3 or more super-rows, the last of each
# ragged:
#   square 8192:        groups 3072/3072/2048, super-rows 3072/3072/2048;
#   rectangle 4096 x 8192: groups 1536/1536/1024, super-rows 3072/3072/2048;
#   stream 8192 loaded x 4096 streamed, -b 1000: groups 2000/2000/96,
#                       loaded super-rows 1536 (5 of them) and 512.
OOC = {
    "square": (660_000_000, 450_000_000, (1024, 1024)),
    "rectangle": (450_000_000, 240_000_000, (512, 1024)),
    "stream": (230_000_000, 300_000_000, (512, 1024)),
}
N_OOC_STREAM = (8192, 4096)
# The (x rows, y rows) of the kernel launches these layouts make: the
# square's and the rectangle's (TILE_I, TILE_J) blocks, and each loaded
# super-row against each streamed group; then the baselines: each
# prepared X group (loaded super-row) against the reference row, it
# against each prepared super-row (streamed group), and itself.  A
# prepared matrix is padded to whole strips and one block more.
OOC_LAUNCHES = {
    "square": [(1024, 1024), (3072, 1), (2048, 1), (1, 3072), (1, 2048),
               (1, 1)],
    "rectangle": [(512, 1024), (1536, 1), (1024, 1), (1, 3584), (1, 2560),
                  (1, 1)],
    "stream": [(1536, 2000), (1536, 96), (512, 2000), (512, 96), (1536, 1),
               (512, 1), (1, 2000), (1, 96), (1, 1)],
}
# The six measures out of core at small shapes (square 256, rectangle
# 128 x 256, stream 128 x 300 with -b 7) against the in-core plain version.
OOC_SMALL = (6_000_000, 200_000, (64, 64))
OOC_SMALL_STREAM = (2_000_000, 200_000, (64, 64))
# The in-core stream of a few records against a long loaded side: one
# launch of LONG_STREAM[0] x rows.
LONG_STREAM = (4_194_305, 8, 64)
# Phase 10: the staged stream shard's (device budget, host budget, tiles),
# and the launches they give at raw: group 1 of the shards' cut
# (SHARD_GROUPS, 8000 records) against loaded super-rows of 1024 and 976
# rows, and the baselines.
SHARD_STAGED = (600_000_000, 4 << 30, (1024, 1024))
SHARD_STAGED_LAUNCHES = [(1024, 8000), (976, 8000)]
SHARD_STAGED_BASELINES = [(1024, 1), (976, 1), (1, 8000), (1, 1)]
# The X groups (stream groups) and Y super-rows (loaded super-rows) of
# phase 9's out-of-core runs and of phase 10's staged shard, as the
# comments above give them.  Every packed block these runs dispatch
# (``ooc_blocks``), at its position and with its out-of-core masks, is one
# at which phase 2 holds K2 and K4 against their plain versions.
OOC_LAYOUTS = {
    "square": ((3072, 3072, 2048), (3072, 3072, 2048)),
    "rectangle": ((1536, 1536, 1024), (3072, 3072, 2048)),
    "stream": ((2000, 2000, 96), (1536,) * 5 + (512,)),
    "stream-shard-staged": ((8000,), (1024, 976)),
}
N_COORD = 2048
# Phase 11: records of the diverse alignment whose residuals saturate, and
# the (records, sites) of its square past 2^16 sites.
N_LADDER = 1024
LADDER_UNPACKED = (256, 65600)
# Phase 12: the cached-feature square out of core at tn93, (device budget,
# host budget, (TILE_I, TILE_J)): below the in-core footprint at these
# tiles (1,497,658,640 B), X groups of 2048 rows, each with its f cache,
# against super-rows of 1024 rows, each with its g cache
# (engine._blocked_layout with the tn93 plan at 29904 sites: 1,265,043,216
# B).
OOC_CACHED = (1_400_000_000, 1_200_000_000, (1024, 1024))
# Phase 12: the tn93 stream of N_OOC_STREAM records (-b 1000) staged with
# its caches, (device budget, host budget, (TILE_I, TILE_J)): below the
# 411,733,392 B that the 8192 loaded rows need in core beside the least
# group (engine._stream_footprint), so staged, in groups of at most
# 1144 records (the host budget's half over 4 x 4 B x 8192 loaded rows),
# so 1000, 1000, 1000 and 1096, against 16 super-rows of 512 loaded rows,
# each with its f cache (engine._stream_layout with the tn93 plan at
# 29904 sites: 357,191,312 B with the caches; at a budget below that the
# stream takes K1, in super-rows of 3072 or 3584 rows).  In core the same
# stream takes groups of 2000, 2000 and 96 records (STREAM_CACHED_IN_CORE:
# tn93's pairs cap against 8192 loaded records falls below the floor of
# engine.STREAM_GROUP_FLOOR, 2048).  raw's group
# features, 18 B a site against tn93's 5, pass what the loaded codes
# leave at these shapes: a raw stream staged at them takes K1.
STREAM_CACHED = (400_000_000, 300_000_000, (512, 1024))
STREAM_CACHED_GROUPS = (1000, 1000, 1000, 1096)
STREAM_CACHED_IN_CORE = (2000, 2000, 96)
STREAM_CACHED_ROWS = 512
# The K6 launches of the cached stream, (x rows, y rows): the stream of
# phase 7 (its 2000 loaded rows against groups of 2000 and 384, and for
# tn93 of 4000, the loaded rows' baseline and the groups' against the
# reference row, and the reference row's own), the benchmark's (groups of
# STREAM_GROUP_ROWS and 1712) and the parts of STREAM_CACHED's staged
# stream (a 512-row super-row against each group, and their baselines).
STREAM_CACHED_LAUNCHES = [
    (2000, 2000), (2000, 384), (2000, 4000), (2000, STREAM_GROUP_ROWS),
    (2000, 1712), (2000, 1), (1, 2000), (1, 384), (1, 4000),
    (1, STREAM_GROUP_ROWS), (1, 1712), (1, 1), (512, 1000), (512, 1096),
    (512, 1), (1, 1000), (1, 1096)]
# Strips of the in-core square (8192 records, auto tiles of 2048) and of
# the rectangle (4096 x 8192): on the cached path each computes its rows'
# baseline with one K6 launch.
SQUARE_STRIPS = 4
RECT_STRIPS = 2
# Phase 13: the logical devices of a split run on a host of one card (on
# a host of several, every card), the group size of phase 7's stream (the
# engine's in-core group, the stream engine's column tile; each device
# takes SPLIT_GROUP / devices of a group's columns), and the (x rows, y
# rows) of the mesh's check.
SPLIT_DEVICES = 2
SPLIT_GROUP = STREAM_GROUP_ROWS
MESH_SHAPE = (2000, 8000)


def split_devices() -> list:
    """Phase 13's devices: every card of a host of several, else
    SPLIT_DEVICES logical devices on the one card."""
    import torch

    cards = torch.cuda.device_count()
    return ([torch.device("cuda", c) for c in range(cards)] if cards > 1
            else [torch.device("cuda", 0)] * SPLIT_DEVICES)


def part_bounds(span: int, width: int) -> list:
    """(first column, end column) of each part of ``width`` columns that
    takes columns of a block ``span`` wide (``_BlockEngine.bounds``)."""
    return [(c0, min(c0 + width, span)) for c0 in range(0, span, width)]


def split_parts(k: int) -> dict:
    """The (x rows, y rows) of phase 13's block parts on ``k`` devices:
    the square's and the rectangle's (BLOCK, BLOCK / k), the stream
    groups' (loaded rows, the group's records in a part of SPLIT_GROUP /
    k), and the out-of-core square's (TILE_I, TILE_J / k)."""
    ti, tj = OOC["square"][2]
    return {"square": {(BLOCK, BLOCK // k)},
            "stream": {(N_STREAM[0], c1 - c0) for bn in STREAM_GROUPS
                       for c0, c1 in part_bounds(bn, SPLIT_GROUP // k)},
            "square-ooc": {(ti, tj // k)}}


@contextlib.contextmanager
def engine_devices(devices):
    """The engine's cuda runs in this process on ``devices`` (the tests
    substitute ``engine.devices_of`` alike)."""
    from distance_tpu_torch import engine

    real = engine.devices_of
    engine.devices_of = (lambda backend: list(devices) if backend == "cuda"
                         else real(backend))
    try:
        yield
    finally:
        engine.devices_of = real
# Seconds a phase 10 subprocess may take before it is killed.
PROC_TIMEOUT_S = 300


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def make_alignment(n: int, width: int, seed: int = 0) -> np.ndarray:
    """Low-diversity alignment: shared ancestor + 40 mutations/seq,
    sprinkled with Ns and gaps (SARS-CoV-2-like).  The recipe of the JAX
    package's bench.make_alignment."""
    from distance_tpu_torch.encoding import A, C, G, GAP, N, T

    rng = np.random.default_rng(seed)
    bases = np.array([A, C, G, T], dtype=np.uint8)
    ancestor = rng.choice(bases, size=width)
    mat = np.tile(ancestor, (n, 1))
    n_mut = 40
    rows = np.repeat(np.arange(n), n_mut)
    cols = rng.integers(0, width, size=n * n_mut)
    vals = rng.choice(bases, size=n * n_mut)
    mat[rows, cols] = vals
    # ~0.5% N / gaps
    n_amb = int(0.005 * n * width / 100) * 100
    rows = rng.integers(0, n, size=n_amb)
    cols = rng.integers(0, width, size=n_amb)
    mat[rows, cols] = np.where(rng.random(n_amb) < 0.8, N, GAP).astype(np.uint8)
    return mat


def write_fasta(path: str, mat: np.ndarray, prefix: str = "seq") -> list:
    from distance_tpu_torch.encoding import CODE_TO_CHAR

    decode = np.zeros(256, dtype=np.uint8)
    for code, ch in CODE_TO_CHAR.items():
        decode[code] = ord(ch)
    ids = [f"{prefix}{i}" for i in range(mat.shape[0])]
    chars = decode[mat]
    with open(path, "wb") as f:
        for rid, row in zip(ids, chars):
            f.write(b">" + rid.encode() + b"\n" + row.tobytes() + b"\n")
    return ids


def read_tsv(path: str, n_lines: int):
    """The TSV's bytes and the offsets of its newlines, once its line
    count and header are checked."""
    with open(path, "rb") as f:
        data = f.read()
    nl = np.flatnonzero(np.frombuffer(data, dtype=np.uint8) == 10)
    check(len(nl) == n_lines, f"TSV has {len(nl)} lines, expected {n_lines}")
    check(data[: nl[0]] == b"sequence1\tsequence2\tdistance",
          "TSV header differs")
    return data, nl


def tsv_line(data: bytes, nl: np.ndarray, k: int) -> str:
    """Line k of the TSV, the header being line 0."""
    return data[nl[k - 1] + 1 : nl[k]].decode()


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_environment() -> str:
    import torch

    from distance_tpu_torch._native import get_lib
    from distance_tpu_torch.ops import _build

    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    names = ("counters", "packing", "diffup", "features", "contract",
             "basecount", "estimate")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc a source
        list(pool.map(_build.load, names))
    print(f"[1] kernels {', '.join(names)} built together and loaded in"
          f" {time.perf_counter() - t0:.3f} s")
    for name in names:
        for line in _build.PTXAS.get(name, "").splitlines():
            print(f"[1] {name}: {line}")
    t0 = time.perf_counter()
    check(get_lib() is not None, "the native host library did not build")
    print(f"[1] native host library built and loaded in"
          f" {time.perf_counter() - t0:.3f} s")
    print_crossover()
    return card


def print_crossover() -> None:
    """The device's free memory, the engine's auto budget (half of it), and
    the largest in-core square at the bench width with the card's auto
    tiles (whole strips) for raw and tn93."""
    import torch

    from distance_tpu_torch import engine
    from distance_tpu_torch.ops.features import get_plan

    dev = torch.device("cuda", 0)
    free, total = torch.cuda.mem_get_info()
    budget = engine._device_budget(dev)
    tile = engine._auto_tile(dev)
    print(f"[1] device memory: {free} B free of {total} B; auto budget"
          f" {budget} B")
    for measure in ("raw", "tn93"):
        plan = get_plan(measure)
        g = len(plan.counters)
        n = cached = 0
        while True:
            rows = engine._padded_shape(n + tile, L_BENCH, tile, tile)[0]
            fp = engine._blocked_footprint(0, rows, L_BENCH, g, tile, tile)
            if fp > budget:
                break
            n += tile
            if engine._cache_fits(plan, rows, L_BENCH, tile, tile, fp,
                                  budget):
                cached = n
        print(f"[1] {measure}: the square at {L_BENCH} sites and {tile}-row"
              f" tiles stays in core up to {n} records; its g cache"
              f" engages up to {cached}")


def phase_kernel_vs_plain(bench: np.ndarray) -> int:
    """Exact equality of the kernel and its plain version on the card;
    returns the largest absolute difference seen (0)."""
    import torch

    from distance_tpu_torch.encoding import ALL_CODES
    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops.counters import counters_cuda, counters_torch
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda", 0)

    def codes(rows, width):
        return rng.choice(ALL_CODES, size=(rows, width)).astype(np.uint8)

    def padded(rows: np.ndarray) -> np.ndarray:
        """Rows with their sites zero-padded to a multiple of 128, as the
        engine uploads them."""
        out = np.zeros((rows.shape[0], -(-rows.shape[1] // 128) * 128),
                       dtype=np.uint8)
        out[:, : rows.shape[1]] = rows
        return out

    l_pad = -(-bench.shape[1] // 128) * 128
    # the launches of the stream (phase 7) and of the out-of-core runs
    # (phase 9): bench rows as x, the last bench rows as y
    launches = [("stream", N_STREAM[0], rows) for rows in
                sorted(set(STREAM_GROUPS) | {STREAM_GROUP_ROWS})]
    launches += [(f"{mode}-ooc", m, n) for mode, shapes in OOC_LAUNCHES.items()
                 for m, n in shapes]
    launches += [("stream-shard-staged", m, n)
                 for m, n in SHARD_STAGED_LAUNCHES + SHARD_STAGED_BASELINES]
    # phase 13's out-of-core square: each part of a block
    launches += [("square-ooc split", m, n) for m, n in
                 split_parts(len(split_devices()))["square-ooc"]]
    path_cases = [(f"{tag} {m}x{n}x{l_pad}", padded(bench[:m]),
                   padded(bench[-n:])) for tag, m, n in launches]
    # the rel baselines: every prepared row against the reference row,
    # on either side, and the reference row against itself
    from distance_tpu_torch.ops.diffup import sampled_mode_row

    ref = padded(sampled_mode_row(bench)[None])
    path_cases += [(f"baseline {tag}", a, b) for tag, a, b in [
        (f"rows {N_BENCH}x1x{l_pad}", padded(bench), ref),
        (f"cols 1x{N_BENCH}x{l_pad}", ref, padded(bench)),
        (f"rows {N_STREAM[0]}x1x{l_pad}", padded(bench[: N_STREAM[0]]), ref),
        (f"cols 1x{STREAM_GROUP_ROWS}x{l_pad}", ref,
         padded(bench[-STREAM_GROUP_ROWS:])),
        (f"self 1x1x{l_pad}", ref, ref)]]
    # phase 9's long loaded side: every loaded row as x in one launch
    m, n, width = LONG_STREAM
    long_x, long_y = padded(codes(m, width)), padded(codes(n, width))
    long_ref = padded(codes(1, width))
    path_cases += [
        (f"long-loaded {m}x{n}x{width} padded to 128", long_x, long_y),
        (f"long-loaded baseline rows {m}x1x{width} padded to 128", long_x,
         long_ref),
        (f"long-loaded baseline cols 1x{n}x{width} padded to 128", long_ref,
         long_y)]
    cases = [
        ("13x7x200", codes(13, 200), codes(7, 200)),
        ("130x257x1000", codes(130, 1000), codes(257, 1000)),
        ("2000x383x1", codes(2000, 1), codes(383, 1)),
        ("77x1001x3", codes(77, 3), codes(1001, 3)),
        ("129x65x129", codes(129, 129), codes(65, 129)),
        ("0x5x128", codes(0, 128), codes(5, 128)),
        ("6x0x128", codes(6, 128), codes(0, 128)),
        ("bench 512x512x29904", bench[:512], bench[512:1024]),
        *path_cases,
    ]
    # the kernel's tiles are 128 x rows by 256 y rows, 64 sites a chunk
    # and 32 a k-step: shapes on either side of each edge
    cases += [(f"tile edge {m}x{n}x{width}", codes(m, width), codes(n, width))
              for m in (127, 128, 129) for n in (255, 256, 257)
              for width in (31, 32, 33, 4095)]
    truth_tables(dev)
    worst = 0
    for measure in MEASURES:
        plan = plan_to_torch(get_plan(measure), dev)
        for name, x, y in cases:
            xd = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            yd = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
            got = counters_cuda(xd, yd, plan)
            torch.cuda.synchronize()
            want = counters_torch(xd, yd, plan)
            torch.cuda.synchronize()
            check(got.shape == want.shape,
                  f"{measure} {name}: shape {tuple(got.shape)}"
                  f" != {tuple(want.shape)}")
            if got.numel():
                err = int((got.long() - want.long()).abs().max())
                worst = max(worst, err)
                check(err == 0, f"{measure} {name}: max |kernel - plain|"
                                f" = {err}")
        print(f"[2] {measure}: kernel == plain on {len(cases)} shapes")
    # more x rows than a grid axis of 65535 row tiles of 64 holds: the
    # in-core stream's one launch over a long loaded side
    m, n, width = LONG_X
    x = torch.from_numpy(codes(m, width)).to(dev)
    y = torch.from_numpy(codes(n, width)).to(dev)
    for measure in ("raw", "tn93"):
        plan = plan_to_torch(get_plan(measure), dev)
        got = counters_cuda(x, y, plan)
        torch.cuda.synchronize()
        err = int((got.long() - counters_torch(x, y, plan).long())
                  .abs().max())
        worst = max(worst, err)
        check(err == 0, f"{measure} {m}x{n}x{width}: max |kernel - plain|"
                        f" = {err}")
        print(f"[2] {measure}: kernel == plain at {m} x {n} x {width}")
    return worst


def phase_cached_vs_plain(bench: np.ndarray) -> int:
    """K5 byte-equal and K6 equal to their plain versions on the card, for
    the six measures (K6 in both plan forms), at the edges of
    ``tests/test_torch_cuda.py`` and the main path's launches; returns the
    largest absolute difference seen (0)."""
    import torch

    from distance_tpu_torch.encoding import ALL_CODES
    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops import cached
    from distance_tpu_torch.ops.counters import counters_torch
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import (cached_plan_to_torch,
                                             fold_cached, plan_to_torch)

    card = card_tests()
    rng = np.random.default_rng(SEED + 11)
    dev = torch.device("cuda", 0)
    k = len(split_devices())
    split = split_parts(k)

    def codes(rows, width):
        return torch.from_numpy(rng.choice(ALL_CODES, size=(rows, width))
                                .astype(np.uint8)).to(dev)

    every = np.concatenate([[0], ALL_CODES]).astype(np.uint8)
    truth = torch.from_numpy(np.stack([np.roll(every, k)[:16]
                                       for k in range(every.size)])).to(dev)
    k5_cases = [truth] + [codes(m, w) for m, w in card.K5_EDGES]
    l_pad = -(-bench.shape[1] // 128) * 128
    square = torch.zeros((N_BENCH, l_pad), dtype=torch.uint8, device=dev)
    square[:, : bench.shape[1]] = torch.from_numpy(bench).to(dev)
    ref = square[N_BENCH // 2 : N_BENCH // 2 + 1]
    worst = 0
    for measure in MEASURES:
        plan = cached_plan_to_torch(get_plan(measure), dev)
        for c in k5_cases:
            for side in ("f", "g"):
                got = cached.features_cuda(c, plan, side)
                torch.cuda.synchronize()
                check(torch.equal(got, cached.features_torch(c, plan, side)),
                      f"{measure} K5 {side} {tuple(c.shape)}: kernel !="
                      f" plain")
        # the main path's launches: a strip of the square against slices
        # of its g cache at j0 > 0, its baselines against the reference
        # row's features, and phase 12's out-of-core shapes
        g_cache = cached.features_cuda(square, plan, "g")
        f_cache = cached.features_cuda(square, plan, "f")
        f_strip = cached.features_cuda(square[2048:4096], plan, "f")
        f_ref, g_ref = (cached.features_cuda(ref, plan, s) for s in "fg")
        path = [("square block 2048 x 2048 at j0 4096", f_strip,
                 g_cache[:, 4096:6144]),
                ("rb 2048 x 1", f_strip, g_ref),
                (f"cb 1 x {N_BENCH}", f_ref, g_cache),
                ("cc 1 x 1", f_ref, g_ref),
                ("out-of-core block 1024 x 1024 at i0 1024, j0 1024",
                 f_cache[:, 1024:2048], g_cache[:, 1024:2048]),
                ("out-of-core rb 3072 x 1", f_cache[:, 3072:6144], g_ref),
                ("out-of-core cb 1 x 3072", f_ref, g_cache[:, 5120:])]
        # the cached stream's: an f cache of its loaded rows (or of a
        # super-row) against a group's g features, and their baselines,
        # each side built by K5 at its shape and held byte-equal; and
        # phase 13's, the loaded rows against each part of a group and
        # each part's column baseline
        built = {}
        for m, n in STREAM_CACHED_LAUNCHES + sorted(
                split["stream"] | {(1, n) for _, n in split["stream"]}):
            sides = []
            for rows, side, one in ((m, "f", f_ref), (n, "g", g_ref)):
                if rows == 1:
                    sides.append(one)
                    continue
                if (rows, side) not in built:
                    c = (square[N_BENCH - rows:] if side == "g"
                         else square[:rows])
                    feats = cached.features_cuda(c, plan, side)
                    torch.cuda.synchronize()
                    check(torch.equal(feats, cached.features_torch(
                        c, plan, side)),
                        f"{measure} K5 {side} {rows} rows: kernel != plain")
                    built[rows, side] = feats
                sides.append(built[rows, side])
            path.append((f"stream {m} x {n}", *sides))
        del built
        # phase 13's square: each part's g cache, its columns of every
        # block of BLOCK rows, block after block (``_BlockEngine._gpart``),
        # a strip against it at j0 4096 (its rows from 4096 / BLOCK x the
        # part's width on) and its column baseline
        (_, w), = split["square"]
        for d in range(k):
            c = (square.view(-1, BLOCK, l_pad)[:, d * w:(d + 1) * w]
                 .reshape(-1, l_pad))
            g_part = cached.features_cuda(c, plan, "g")
            torch.cuda.synchronize()
            check(torch.equal(g_part, cached.features_torch(c, plan, "g")),
                  f"{measure} K5 g of part {d} of {k}: kernel != plain")
            g0 = 4096 // BLOCK * w
            path += [(f"split square part {d} of {k}: {BLOCK} x {w} at j0"
                      f" 4096 (g0 {g0})", f_strip, g_part[:, g0:g0 + w]),
                     (f"split cb part {d} of {k}: 1 x {c.shape[0]}", f_ref,
                      g_part)]
        for form, make in (("jax", cached_plan_to_torch),
                           ("folded", fold_cached)):
            fplan = make(get_plan(measure), dev)
            kp = plan_to_torch(get_plan(measure), dev)
            cases = []
            for m, n, width in card.K6_EDGES:
                x, y = codes(m, width), codes(n, width)
                cases.append((f"{m} x {n} x {width}",
                              cached.features_torch(x, fplan, "f"),
                              cached.features_torch(y, fplan, "g"),
                              counters_torch(x, y, kp)))
            if form == "jax":
                cases += [(name, a, b, None) for name, a, b in path]
            for name, fx, gy, want_k1 in cases:
                got = cached.contract_cuda(fx, gy, fplan)
                torch.cuda.synchronize()
                want = cached.contract_torch(fx, gy, fplan)
                check(got.shape == want.shape,
                      f"{measure} K6 {form} {name}: shape")
                if got.numel():
                    err = int((got.long() - want.long()).abs().max())
                    worst = max(worst, err)
                    check(err == 0, f"{measure} K6 {form} {name}: max"
                                    f" |kernel - plain| = {err}")
                check(want_k1 is None or torch.equal(want, want_k1),
                      f"{measure} K6 {form} {name}: plain != K1's plain")
        print(f"[2] {measure}: K5 == plain on {len(k5_cases)} shapes, both"
              f" sides, at the stream's and on the split square's {k} part"
              f" g caches; K6 == plain on {len(card.K6_EDGES)} edges in both"
              f" plan forms (== K1's plain) and {len(path)} main-path"
              f" launches (phase 13's parts among them:"
              f" {sorted(split['square'] | split['stream'])})")
        del g_cache, f_cache, f_strip, path, cases, g_part
    # past 2^31 bytes: raw's g cache of 4096 x 29952, and K6 reading its
    # last rows
    plan = cached_plan_to_torch(get_plan("raw"), dev)
    c = square[:4096]
    g = cached.features_cuda(c, plan, "g")
    torch.cuda.synchronize()
    check(g.numel() > 1 << 31 and torch.equal(
        g, cached.features_torch(c, plan, "g")),
        "K5 past 2^31 bytes: kernel != plain")
    fx = cached.features_cuda(c[:129], plan, "f")
    got = cached.contract_cuda(fx, g[:, 3800:], plan)
    torch.cuda.synchronize()
    check(torch.equal(got, cached.contract_torch(fx, g[:, 3800:], plan)),
          "K6 past 2^31 bytes: kernel != plain")
    print(f"[2] raw: K5 == plain for a {g.numel()}-byte g cache, and K6 =="
          f" plain reading its rows 3800.. at offsets past 2^31")
    return worst


def bench_baselines(x, y, ref, plan):
    """K1 counters of x against y and the rel baselines against the
    reference row ``ref``: (c, rb, cb, cc)."""
    from distance_tpu_torch.ops.counters import counters_cuda

    r = ref[None]
    return (counters_cuda(x, y, plan), counters_cuda(x, r, plan)[:, :, 0],
            counters_cuda(r, y, plan)[:, 0, :],
            counters_cuda(r, r, plan)[:, 0, 0])


def outlier_counters(dev, g: int, m: int, n: int, seed: int):
    """Counters with zero baselines whose residuals lie in [-7, 7] but
    for chosen outliers (|res| > 7, -8 among them): a segment with none,
    one, two, three and many, on each side of a segment's edge."""
    import torch

    from distance_tpu_torch.ops.packing import REL4_SEGMENTS

    rng = np.random.default_rng(seed)
    c = rng.integers(-7, 8, size=(g, m, n)).astype(np.int32)
    flat = c.reshape(-1)
    seg = -(-flat.size // REL4_SEGMENTS)
    picks = {1: 1, 2: 2, 4: 3, 7: seg}  # segment -> outliers in it
    for s, k in picks.items():
        lo = s * seg
        cells = rng.choice(np.arange(lo, min(lo + seg, flat.size)),
                           size=min(k, max(0, min(seg, flat.size - lo))),
                           replace=False)
        flat[cells] = rng.choice([-8, 8, -300, 127, 128, -129, 9000],
                                 size=cells.size)
    if flat.size:
        flat[-1] = -8  # the last cell
    z = np.zeros
    return tuple(torch.from_numpy(a).to(dev) for a in
                 (c, z((g, m), np.int32), z((g, n), np.int32),
                  z(g, np.int32)))


def edge_counters(dev, g: int, m: int, n: int, seed: int, every: bool):
    """Counters and baselines whose residuals lie in [-7, 7] but for
    outliers on rel4's segment edges (segments of L cells): a segment with
    one, one with two and one with every cell out, both cells of the
    first byte that straddles two segments (odd L), two cells of the last
    segment holding cells, and a residual of exactly -2^31 (numpy's int32
    abs keeps it negative: no outlier); with ``every``, every cell out.
    Returns (c, rb, cb, cc) on ``dev``, rb and cb as row slices of wider
    tensors, which the kernels read in place."""
    import torch

    from distance_tpu_torch.ops.packing import REL4_SEGMENTS

    rng = np.random.default_rng(seed)
    c = rng.integers(-4, 5, size=(g, m, n)).astype(np.int32)
    rb = rng.integers(-1, 2, (g, m + 7)).astype(np.int32)
    cb = rng.integers(-1, 2, (g, n + 5)).astype(np.int32)
    cc = rng.integers(-1, 2, g).astype(np.int32)
    flat = c.reshape(-1)
    size = flat.size
    seg = -(-size // REL4_SEGMENTS)
    out = np.array([11, -11, 100, -300, 9000], dtype=np.int32)
    if every:
        flat[:] = rng.choice(out, size)
    elif size:
        for s, k in ((1, 1), (2, 2), (3, seg)):
            cells = rng.choice(np.arange(s * seg, min((s + 1) * seg, size)),
                               min(k, max(0, size - s * seg)), replace=False)
            flat[cells] = rng.choice(out, cells.size)
        s = 5 if seg % 2 else 4
        if s * seg < size:
            flat[[s * seg - 1, s * seg]] = rng.choice(out, 2)
        flat[[(size - 1) // seg * seg, size - 1]] = rng.choice(out, 2)
        shift = int(rb[0, 3]) + int(cb[0, 2]) - int(cc[0])
        c[0, 0, 0] = np.int64(-(1 << 31) + shift).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (c, rb, cb, cc)]
    return t[0], t[1][:, 3:3 + m], t[2][:, 2:2 + n], t[3]


def edge_shapes(g: int) -> list:
    """(m, n) of G = ``g`` counter blocks whose rel4 segments are of 7
    cells (odd: bytes straddle segments), 8 (even) and 2 (even, the last
    segment partial), and of 2048 x 2048 (the square's block) and no
    cells."""
    from distance_tpu_torch.ops.packing import REL4_SEGMENTS

    return [(7 * REL4_SEGMENTS // (g * 246), 246),
            (8 * REL4_SEGMENTS // (g * 256), 256),
            (2 * REL4_SEGMENTS // (g * 180), 180), (BLOCK, BLOCK), (0, 8)]


def phase_pack_and_rebuild(bench: np.ndarray) -> int:
    """K2 (rel4 and rel packs), K3 (the diff rebuild) and K4 (narrow and
    wide packs) against their plain versions, exactly.  K2 and K4 on the
    main path's blocks (the square's 2048 x 2048 diagonal block, under K2
    with its self-pairs and padding masked, and the stream's 2000 x 2096
    group) for all six measures; K2 on counters with chosen outliers
    (segments with 0, 1, 2, 3 and many, odd rows, odd columns under rel);
    K4 at widths 1, 29904 and 65535 and on counters around the narrow
    lanes' 255 (``chosen_lane_counters``); K3 on the square's 8192 x 29952
    upload of the bench alignment (and against its dense upload, whose
    pad rows are zero where the rebuild's hold the reference row), with
    no diffs, and with as many diffs as the capacity.  Returns the
    largest absolute difference seen (0)."""
    import torch

    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops import diffup, packing
    from distance_tpu_torch.ops.counters import counters_cuda
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch

    dev = torch.device("cuda", 0)
    l_pad = -(-bench.shape[1] // 128) * 128
    rows = np.zeros((bench.shape[0], l_pad), dtype=np.uint8)
    rows[:, : bench.shape[1]] = bench
    refp = np.zeros(l_pad, dtype=np.uint8)
    refp[: bench.shape[1]] = diffup.sampled_mode_row(bench)
    ref = torch.from_numpy(refp).to(dev)
    square = torch.from_numpy(rows[:BLOCK]).to(dev)
    loaded = torch.from_numpy(rows[: N_STREAM[0]]).to(dev)
    group = torch.from_numpy(rows[-STREAM_GROUP_ROWS:]).to(dev)

    def same(tag, got, want):
        for a, b in zip(got, want):
            check(a.shape == b.shape and torch.equal(a, b),
                  f"{tag}: kernel != plain")

    def both(tag, c, rb, cb, cc, i0=0, j0=0, nv=None, diag_off=None):
        mask4 = packing.block_mask(c.shape[1], c.shape[2], i0, j0,
                                   nv or (i0 + c.shape[1], j0 + c.shape[2]),
                                   diag_off, dev)
        mask = packing.block_mask(c.shape[1], c.shape[2], i0, j0, None,
                                  diag_off, dev)
        if c.shape[2] % 2 == 0:
            got = packing.pack_rel4_cuda(c, rb, cb, cc, i0, j0, nv, diag_off)
            torch.cuda.synchronize()
            same(f"rel4 {tag}", got,
                 packing.pack_rel4_torch(c, rb, cb, cc, mask4))
        got = packing.pack_rel_cuda(c, rb, cb, cc, i0, j0, diag_off)
        torch.cuda.synchronize()
        same(f"rel {tag}", [got], [packing.pack_rel_torch(c, rb, cb, cc,
                                                          mask)])

    outliers = 0
    for measure in MEASURES:
        plan = plan_to_torch(get_plan(measure), dev)
        both(f"{measure} square {BLOCK}x{BLOCK} diagonal block",
             *bench_baselines(square, square, ref, plan),
             nv=(BLOCK - 48, BLOCK - 100), diag_off=0)
        c, rb, cb, cc = bench_baselines(loaded, group, ref, plan)
        both(f"{measure} stream {N_STREAM[0]}x{STREAM_GROUP_ROWS}", c, rb,
             cb, cc, nv=(N_STREAM[0], STREAM_GROUP_ROWS))
        res = c - rb[:, :, None] - cb[:, None, :] + cc[:, None, None]
        outliers += int((res.abs() > 7).sum())
    print(f"[2] K2 == plain (rel4 and rel) on the square's {BLOCK} x {BLOCK}"
          f" diagonal block (self-pairs and padding masked) and the stream's"
          f" {N_STREAM[0]} x {STREAM_GROUP_ROWS} group, six measures;"
          f" {outliers} residuals of the stream groups outside [-7, 7]")

    def windows(tag, bounds, c, rb, cb, cc, i0=0, j0=0, nv=None,
                diag_off=None):
        """K2 rel4 and rel of each part of a block split over devices
        (rel4 the window of its columns ``bounds``, with the block's
        width) == plain, and the parts' rel4 lanes joined and sidecars
        merged == the whole block's launch.  Adds the parts' launches
        to CHECKED_PACKS."""
        g, m, n = c.shape
        nv = nv or (i0 + m, j0 + n)
        parts = []
        for c0, c1 in bounds:
            cs, cbs = c[:, :, c0:c1].contiguous(), cb[:, c0:c1]
            got = packing.pack_rel4_cuda(cs, rb, cbs, cc, i0, j0 + c0, nv,
                                         diag_off, c0, n)
            torch.cuda.synchronize()
            mask = packing.block_mask(m, c1 - c0, i0, j0 + c0, nv, diag_off,
                                      dev)
            same(f"rel4 columns {c0}..{c1} of {tag}", got,
                 packing.pack_rel4_torch(cs, rb, cbs, cc, mask, c0, n))
            parts.append(got)
            got = packing.pack_rel_cuda(cs, rb, cbs, cc, i0, j0 + c0,
                                        diag_off)
            torch.cuda.synchronize()
            mask = packing.block_mask(m, c1 - c0, i0, j0 + c0, None,
                                      diag_off, dev)
            same(f"rel columns {c0}..{c1} of {tag}", [got],
                 [packing.pack_rel_torch(cs, rb, cbs, cc, mask)])
            CHECKED_PACKS.update({
                ("rel4", m, c1 - c0, i0, j0 + c0, nv, diag_off, c0, n),
                ("rel", m, c1 - c0, i0, j0 + c0, diag_off)})
        whole = packing.pack_rel4_cuda(c, rb, cb, cc, i0, j0, nv, diag_off)
        merged = packing.merge_rel4_sidecars(
            torch.stack([p[1] for p in parts]),
            torch.stack([p[2] for p in parts]))
        same(f"rel4 parts of {tag} merged",
             (torch.cat([p[0] for p in parts], dim=-1), *merged), whole)

    k = len(split_devices())
    cols = STREAM_GROUPS[0]  # phase 13's stream group
    square_parts = part_bounds(BLOCK, BLOCK // k)
    stream_parts = part_bounds(cols, SPLIT_GROUP // k)
    for measure in MEASURES:
        plan = plan_to_torch(get_plan(measure), dev)
        windows(f"{measure} square {BLOCK}x{BLOCK} diagonal block",
                square_parts, *bench_baselines(square, square, ref, plan),
                nv=(BLOCK - 48, BLOCK - 100), diag_off=0)
        windows(f"{measure} stream {N_STREAM[0]}x{cols}", stream_parts,
                *bench_baselines(loaded, group[-cols:], ref, plan),
                nv=(N_STREAM[0], cols))
    for parts in (2, 4):
        windows(f"outliers 2x{BLOCK}x{BLOCK} in {parts} parts",
                part_bounds(BLOCK, BLOCK // parts),
                *outlier_counters(dev, 2, BLOCK, BLOCK, SEED + 25 + parts),
                3, 5, (BLOCK - 1, BLOCK - 2), diag_off=2)
    print(f"[2] K2 rel4 and rel == plain on the parts of the split blocks"
          f" (phase 13's part shapes on {k} devices: the square's {BLOCK} x"
          f" {BLOCK} diagonal block in parts {square_parts}, the stream's"
          f" {N_STREAM[0]} x {cols} group in parts {stream_parts}, six"
          f" measures; counters with chosen outliers in 2 and 4 parts):"
          f" each rel4 part a window of its block, their sidecars merged =="
          f" the whole block's launch")
    shapes = [(2, 2048, 2048), (4, 33, 66), (1, 1, 2), (3, 129, 258),
              (2, 31, 33), (4, 0, 8), (1, 5000, 3000)]
    for k, (g, m, n) in enumerate(shapes):
        c, rb, cb, cc = outlier_counters(dev, g, m, n, SEED + 20 + k)
        both(f"outliers {g}x{m}x{n}", c, rb, cb, cc, 3, 5,
             (m - 1, n - 2), diag_off=2)
        both(f"outliers {g}x{m}x{n} unmasked", c, rb, cb, cc)
    print(f"[2] K2 == plain on counters with chosen outliers (segments with"
          f" 0, 1, 2, 3 and many; the diagonal and padding masked and"
          f" not): {shapes}")
    for k, measure in enumerate(MEASURES):
        g = len(get_plan(measure).counters)
        for m, n in edge_shapes(g):
            seg = max(1, -(-g * m * n // packing.REL4_SEGMENTS))
            for every in (False, True):
                c, rb, cb, cc = edge_counters(dev, g, m, n,
                                              SEED + 60 + k, every)
                tag = (f"{measure} edges {g}x{m}x{n} (segments of {seg}"
                       f"{', every cell out' if every else ''})")
                both(tag, c, rb, cb, cc, 3, 1, (3 + m - 2, 1 + n - 3), 2)
                both(f"{tag} unmasked", c, rb, cb, cc)
        print(f"[2] K2 == plain at rel4's segment edges, {measure} (G ="
              f" {g}): {edge_shapes(g)} (segments of 7, 8, 2 cells; a byte"
              f" across two segments, 0, 1, 2 and every cell out, the last"
              f" segment partial, a residual of -2^31, every cell out, no"
              f" cells), baselines read in place as row slices")

    # K3 at the square's upload: the bench alignment, 8192 x 29952 (and
    # with 64 pad rows more)
    padded = np.zeros((N_BENCH + 64, l_pad), dtype=np.uint8)
    padded[: bench.shape[0], : bench.shape[1]] = bench
    up = diffup.DiffUploader(refp, dev)
    enc = up.encode(padded[:N_BENCH], n_real=bench.shape[0])
    check(enc is not None, "the bench alignment did not diff-encode")
    n_diff = int((enc[0] < N_BENCH * l_pad).sum())
    cases = [("square 8192x29952", enc, N_BENCH),
             ("square 8192x29952 and 64 pad rows",
              up.encode(padded, n_real=bench.shape[0]), N_BENCH + 64)]
    same_rows = np.repeat(refp[None], 300, axis=0)
    cases.append(("no diffs 300 rows", up.encode(same_rows, n_real=300), 300))
    cap = 4096
    flat = np.sort(np.random.default_rng(SEED + 30).choice(
        300 * l_pad, size=cap, replace=False)).astype(np.int32)
    cases.append(("capacity-many diffs", (flat, np.full(cap, 17, np.uint8)),
                  300))
    for tag, (idx, vals), nrows in cases:
        args = (ref, torch.from_numpy(idx).to(dev),
                torch.from_numpy(vals).to(dev), nrows)
        got = diffup.diff_rebuild_cuda(*args)
        torch.cuda.synchronize()
        want = diffup.diff_rebuild_torch(*args)
        check(torch.equal(got, want), f"K3 {tag}: kernel != plain")
        if nrows >= N_BENCH:
            check(np.array_equal(got[: bench.shape[0]].cpu().numpy(),
                                 padded[: bench.shape[0]]),
                  f"K3 {tag}: rows differ from the dense upload")
            check(bool((got[bench.shape[0]:] == ref).all()),
                  f"K3 {tag}: pad rows are not the reference row")
    print(f"[2] K3 == plain: the square's upload ({n_diff} diffs of"
          f" {N_BENCH * l_pad} codes, capacity {enc[0].size}; its real rows equal"
          f" the dense upload, pad rows the reference row), no diffs, and"
          f" capacity-many diffs")
    cases = card_tests()
    edges = cases.K3_EDGES + cases.K3_CARD_EDGES
    for name in edges:
        r, i, v, nrows = cases.k3_edge_case(name,
                                            np.random.default_rng(SEED + 31))
        args = (torch.from_numpy(r).to(dev), torch.from_numpy(i).to(dev),
                torch.from_numpy(v).to(dev), nrows)
        got = diffup.diff_rebuild_cuda(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, diffup.diff_rebuild_torch(*args)),
              f"K3 {name} ({nrows} x {r.size}, capacity {i.size}): kernel"
              f" != plain")
        del got, args
    print(f"[2] K3 == plain at its edges (the card tests' cases):"
          f" {', '.join(edges)}")

    # K4 on the main path's blocks and on counters around the saturation
    # points of the narrow lanes, at widths 1, the bench's and 2^16 - 1
    def lanes_equal(tag, measure, c, width):
        for kind, kern, plain in (
                ("narrow", lambda: packing.pack_narrow_cuda(measure, c, width),
                 lambda: packing.pack_narrow_torch(measure, c, width)),
                ("wide", lambda: packing.pack_wide_cuda(measure, c),
                 lambda: packing.pack_wide_torch(measure, c))):
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            check(got.dtype == want.dtype and torch.equal(got, want),
                  f"K4 {kind} {measure} {tag} width {width}: kernel != plain")

    widths = (1, bench.shape[1], (1 << 16) - 1)
    saturated = 0
    for measure in MEASURES:
        plan = plan_to_torch(get_plan(measure), dev)
        block = counters_cuda(square, square, plan)
        for width in widths:
            lanes_equal(f"square {BLOCK}x{BLOCK}", measure, block, width)
            lanes_equal(f"stream {N_STREAM[0]}x{STREAM_GROUP_ROWS}", measure,
                        counters_cuda(loaded, group, plan), width)
            for k, (m, n) in enumerate([(2, 3), (33, 65), (BLOCK, BLOCK)]):
                lanes_equal(f"chosen {m}x{n}", measure, chosen_lane_counters(
                    dev, plan.counters, m, n, width, SEED + 40 + k), width)
        narrow = packing.pack_narrow_cuda(measure, block, bench.shape[1])
        saturated += int((narrow.view(torch.uint8) == 255).any(0).sum())
    print(f"[2] K4 == plain (narrow and wide), six measures: the square's"
          f" {BLOCK} x {BLOCK} block and the stream's {N_STREAM[0]} x"
          f" {STREAM_GROUP_ROWS} group at widths {widths}, and chosen counters"
          f" around 255 (2 x 3, 33 x 65, {BLOCK} x {BLOCK}); {saturated}"
          f" pairs of the square's blocks saturate a narrow lane at"
          f" {bench.shape[1]} sites (six measures together)")
    ooc_packs_vs_plain(dev, rows, ref, both, windows, lanes_equal, widths)
    return 0


def card_tests():
    """``tests/test_torch_cuda.py`` of this checkout, loaded from its path
    (a package named ``tests`` installed elsewhere may shadow the
    checkout's)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_cuda.py")
    spec = importlib.util.spec_from_file_location("card_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cut(sizes) -> list:
    """(start, end) of consecutive spans of these sizes."""
    ends = np.cumsum(sizes).tolist()
    return list(zip([0] + ends[:-1], ends))


def ooc_blocks(mode: str) -> set:
    """(rows, cols, i0, j0, nv, diag_off) of every packed block the
    out-of-core run of ``mode`` dispatches, as
    ``_BlockEngine.pack_block`` gets them (``ooc_dispatches``)."""
    return set(ooc_dispatches(mode))


def ooc_dispatches(mode: str) -> list:
    """(rows, cols, i0, j0, nv, diag_off) of each block the out-of-core
    run of ``mode`` dispatches, once each, from ``OOC_LAYOUTS``: the
    blocked sweeps' (TILE_I, TILE_J) blocks of each strip of each X group
    against each super-row (the square's from the block holding its
    diagonal on), with the valid rows of both and, on the square, the
    self-pair offset g0 - q0; the staged stream's one block of each
    loaded super-row against each group."""
    xs, ys = OOC_LAYOUTS[mode]
    if mode.startswith("stream"):
        return [(q, bn, 0, 0, (q, bn), None) for q in ys for bn in xs]
    ti, tj = OOC[mode][2]
    square = mode == "square"
    blocks = []
    for g0, g1 in cut(xs):
        for q0, q1 in cut(ys):
            if q1 <= (g0 if square else 0):
                continue
            for i0 in range(0, g1 - g0, ti):
                lo = 0
                if square and q1 <= g0 + i0 + 1:
                    continue
                if square and q0 <= g0 + i0:
                    lo = (g0 + i0 - q0) // tj * tj
                for j0 in range(lo, q1 - q0, tj):
                    blocks.append((ti, tj, i0, j0, (g1 - g0, q1 - q0),
                                   g0 - q0 if square else None))
    return blocks


# The K2 and K4 launches phase 2 held against their plain versions at the
# out-of-core blocks and their split parts: ("rel4", rows, cols, i0, j0,
# nv, diag_off, col0, block columns), ("rel", rows, cols, i0, j0,
# diag_off), ("narrow", rows, cols) and ("wide", rows, cols), for all six
# measures.  Phases 9, 10 and 13 fail on a launch outside it.
CHECKED_PACKS: set = set()


def ooc_packs_vs_plain(dev, rows: np.ndarray, ref, both, windows,
                       lanes_equal, widths: tuple) -> None:
    """Phase 2 at every block of ``ooc_blocks``, for the six measures: K2
    (rel4 and rel) with the block's i0, j0, valid rows and self-pair
    offset, on counters whose residuals fill [-7, 7] with chosen outliers
    (zero baselines, so a cell masked wrongly shows), and on the bench
    alignment's counters and baselines at each block shape; K4 (narrow
    and wide) at each block shape on the bench alignment's counters at
    ``widths``.  Then the same for the parts of the square's blocks split
    as phase 13 splits them (``windows``: K2 on each part, rel4 a window
    of its block).  Fills CHECKED_PACKS."""
    import torch

    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch

    by_shape = {}
    for mode in OOC_LAYOUTS:
        for m, n, *mask in ooc_blocks(mode):
            by_shape.setdefault((m, n), set()).add(tuple(mask))
    for k, ((m, n), masks) in enumerate(sorted(by_shape.items())):
        x = torch.from_numpy(rows[:m]).to(dev)
        y = torch.from_numpy(rows[-n:]).to(dev)
        outliers = outlier_counters(dev, 4, m, n, SEED + 50 + k)
        for measure in MEASURES:
            plan = plan_to_torch(get_plan(measure), dev)
            g = plan.counters
            c, rb, cb, cc = bench_baselines(x, y, ref, plan)
            for i0, j0, nv, diag_off in sorted(masks, key=str):
                both(f"{measure} out-of-core {m}x{n} at ({i0}, {j0}) nv {nv}"
                     f" diag_off {diag_off}", *(t[:g] for t in outliers),
                     i0, j0, nv, diag_off)
                CHECKED_PACKS.update({
                    ("rel4", m, n, i0, j0, nv, diag_off, 0, n),
                    ("rel", m, n, i0, j0, diag_off)})
            i0, j0, nv, diag_off = min(masks, key=str)
            both(f"{measure} out-of-core {m}x{n} bench", c, rb, cb, cc, i0,
                 j0, nv, diag_off)
            for width in widths:
                lanes_equal(f"out-of-core {m}x{n}", measure, c, width)
        CHECKED_PACKS.update({("narrow", m, n), ("wide", m, n)})
        print(f"[2] K2 == plain (rel4, rel) at the {len(masks)} out-of-core"
              f" positions and masks of {m} x {n} blocks and K4 == plain"
              f" (narrow, wide) at that shape, six measures")
    k = len(split_devices())
    ti, tj = OOC["square"][2]
    bounds = part_bounds(tj, tj // k)
    masks = sorted({tuple(mask) for _, _, *mask in ooc_blocks("square")},
                   key=str)
    x = torch.from_numpy(rows[:ti]).to(dev)
    y = torch.from_numpy(rows[-tj:]).to(dev)
    outliers = outlier_counters(dev, 4, ti, tj, SEED + 70)
    for measure in MEASURES:
        plan = plan_to_torch(get_plan(measure), dev)
        g = plan.counters
        c, rb, cb, cc = bench_baselines(x, y, ref, plan)
        for i0, j0, nv, diag_off in masks:
            windows(f"{measure} split out-of-core {ti}x{tj} at ({i0}, {j0})"
                    f" nv {nv} diag_off {diag_off}",
                    bounds, *(t[:g] for t in outliers), i0, j0, nv, diag_off)
        windows(f"{measure} split out-of-core {ti}x{tj} bench", bounds, c, rb,
                cb, cc, *masks[0])
        for c0, c1 in bounds:
            for width in widths:
                lanes_equal(f"split out-of-core {ti}x{c1 - c0}", measure,
                            c[:, :, c0:c1].contiguous(), width)
    CHECKED_PACKS.update({(kind, ti, c1 - c0) for kind in ("narrow", "wide")
                          for c0, c1 in bounds})
    print(f"[2] K2 == plain (rel4 windows, rel) on the parts {bounds} of the"
          f" {ti} x {tj} blocks at the {len(masks)} out-of-core positions"
          f" and masks of phase 13's split square, and K4 == plain (narrow,"
          f" wide) at the parts' shapes, six measures")
    torch.cuda.synchronize()


def chosen_lane_counters(dev, g: int, m: int, n: int, width: int,
                         seed: int):
    """(g, m, n) int32 counters whose narrow lanes fall on either side of
    255: cells at 254, 255, 256, 0, the width, the width less 255 (and
    with it a lane of width - sum at 255), -1 and past 2^16, the rest
    random below the width."""
    import torch

    rng = np.random.default_rng(seed)
    c = rng.integers(0, min(width, 600) + 2, size=(g, m, n)).astype(np.int32)
    flat = c.reshape(g, -1)
    for k, v in enumerate([254, 255, 256, 0, width, width - 255, -1,
                           70000]):
        flat[:, k % flat.shape[1]] = v
    return torch.from_numpy(c).to(dev)


def truth_tables(dev) -> None:
    """Code 0 and every Paradis code, each repeated over 64 sites, on x
    against the same on y: the kernel gives 64 times each counter's
    256 x 256 predicate table at those codes, for all six measures, and
    equals its plain version."""
    import torch

    from distance_tpu_torch.encoding import ALL_CODES
    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops.counters import counters_cuda, counters_torch
    from distance_tpu_torch.ops.features import (get_plan,
                                                 reference_counter_matrix)
    from distance_tpu_torch.ops.plan import plan_to_torch

    codes = np.concatenate([[0], ALL_CODES]).astype(np.uint8)
    x = torch.from_numpy(np.repeat(codes[:, None], 64, axis=1)).to(dev)
    for measure in MEASURES:
        plan = get_plan(measure)
        kp = plan_to_torch(plan, dev)
        got = counters_cuda(x, x, kp)
        torch.cuda.synchronize()
        check(torch.equal(got, counters_torch(x, x, kp)),
              f"{measure} truth table: kernel != plain")
        for g, name in enumerate(plan.counters):
            want = 64 * reference_counter_matrix(name)[np.ix_(codes, codes)]
            check(np.array_equal(got[g].cpu().numpy(), want),
                  f"{measure} {name}: kernel != 64 x its truth table")
    print(f"[2] kernel == 64 x the truth table of every counter of the six"
          f" measures at code 0 and the {len(ALL_CODES)} Paradis codes")


# The kernels of the port, by the names of the result line.
KERNELS = ("counters", "pack_rel4", "pack_rel", "pack_narrow", "pack_wide",
           "diff_rebuild", "features", "contract", "base_counts", "estimate")


def reset_counts() -> None:
    """Every kernel's launch count, the engine's baseline contractions, its
    blocks by rung of the pack ladder and its feature builds set to 0."""
    from distance_tpu_torch import engine
    from distance_tpu_torch.ops import (basecount, cached, counters, diffup,
                                        estimate, packing)

    counters.LAUNCHES = packing.LAUNCHES_REL4 = packing.LAUNCHES_REL = 0
    basecount.LAUNCHES = estimate.LAUNCHES = 0
    packing.LAUNCHES_NARROW = packing.LAUNCHES_WIDE = 0
    diffup.LAUNCHES = engine.BASELINES = engine.K1_BLOCKS = 0
    cached.LAUNCHES_FEATURES = cached.LAUNCHES_CONTRACT = 0
    engine.K6_BLOCKS = engine.K6_BASELINES = 0
    for rung in engine.RUNG_BLOCKS:
        engine.RUNG_BLOCKS[rung] = 0
    for kind in engine.FEATURE_BUILDS:
        engine.FEATURE_BUILDS[kind] = 0


def read_counts() -> dict:
    """The counts ``reset_counts`` zeroes: kernel launches by name,
    ``baselines`` (contractions against the reference row, by K1 or K6),
    ``k6_baselines`` (those by K6), ``k1_blocks`` and ``k6_blocks``
    (counter blocks first dispatched through K1 and through K6),
    ``blocks`` (counter blocks packed, by rung: first dispatches and
    refetches) and ``builds`` (K5 feature builds by kind)."""
    from distance_tpu_torch import engine
    from distance_tpu_torch.ops import (basecount, cached, counters, diffup,
                                        estimate, packing)

    return {"counters": counters.LAUNCHES,
            "pack_rel4": packing.LAUNCHES_REL4,
            "pack_rel": packing.LAUNCHES_REL,
            "pack_narrow": packing.LAUNCHES_NARROW,
            "pack_wide": packing.LAUNCHES_WIDE,
            "diff_rebuild": diffup.LAUNCHES,
            "features": cached.LAUNCHES_FEATURES,
            "contract": cached.LAUNCHES_CONTRACT,
            "base_counts": basecount.LAUNCHES,
            "estimate": estimate.LAUNCHES,
            "baselines": engine.BASELINES,
            "k6_baselines": engine.K6_BASELINES,
            "k1_blocks": engine.K1_BLOCKS,
            "k6_blocks": engine.K6_BLOCKS,
            "blocks": dict(engine.RUNG_BLOCKS),
            "builds": dict(engine.FEATURE_BUILDS)}


def cached_path(measure: str = "raw") -> bool:
    """Whether the engine sends ``measure``'s square and rectangle blocks
    through the cached-feature path (its measure set and cache budget)."""
    from distance_tpu_torch import engine

    return engine._cached_plan_for(measure) is not None


@contextlib.contextmanager
def measure_set(measures):
    """The engine's set of cached measures replaced in this process."""
    from distance_tpu_torch import engine

    saved = engine.CACHED_MEASURES
    engine.CACHED_MEASURES = frozenset(measures)
    try:
        yield
    finally:
        engine.CACHED_MEASURES = saved


def run_cli(tag: str, args: list, measure: str = "raw") -> tuple:
    """One CLI run with --backend cuda: (wall s, launch counts of the run,
    as ``read_counts`` gives them), after printing the host phase totals
    and the counts."""
    from distance_tpu_torch import cli
    from distance_tpu_torch.utils import timing

    timing.reset()
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(args + ["-m", measure, "--backend", "cuda"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(rc == 0, f"{tag} exited {rc}")
    check(counts["counters"] + counts["contract"] > 0,
          f"{tag} launched no counter kernel")
    print(f"{tag} host phase totals (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(timing.totals().items())))
    print(f"{tag} launches: {counts}")
    return wall, counts


def check_packed_path(tag: str, counts: dict, blocks: int, baselines: int,
                      rebuilds: int = 1, group_baselines: bool = False) -> None:
    """A run of the in-core packed path: ``blocks`` counter blocks first
    dispatched at rel4; ``baselines`` K1 launches against the reference
    row, and with ``group_baselines`` (the stream) one more for each
    block first dispatched, whose group's rows are not kept; then
    ``check_launches``."""
    b = counts["blocks"]
    if group_baselines:
        baselines += blocks
    check(b["rel4"] == blocks and counts["baselines"] == baselines
          and counts["diff_rebuild"] >= rebuilds,
          f"{tag}: launches {counts}, expected {blocks} blocks at rel4,"
          f" {baselines} baselines and {rebuilds} rebuilds")
    check_launches(tag, counts, blocks)


def check_cached(tag: str, counts: dict, strips: int,
                 ref: bool = True) -> None:
    """A run whose blocks and baselines all went through K6: no K1 launch;
    K5 built one g cache, each strip's f features once and, with a
    reference row, its f and g features."""
    want = {"g": 1, "f": 0, "strip": strips, "ref": 2 if ref else 0,
            "group": 0}
    check(counts["counters"] == 0 and counts["builds"] == want,
          f"{tag}: launches {counts}, expected no K1 and feature builds"
          f" {want}")


def check_stream_cached(tag: str, counts: dict, groups: int,
                        f_builds: int = 1) -> None:
    """A stream whose blocks and baselines all went through K6: no K1
    launch; K5 built the loaded rows' f cache (``f_builds``: one in
    core, one a staging of a super-row), each group's g features once,
    and the reference row's f and g features."""
    want = {"g": 0, "f": f_builds, "strip": 0, "ref": 2, "group": groups}
    check(counts["counters"] == 0 and counts["k1_blocks"] == 0
          and counts["builds"] == want
          and counts["k6_baselines"] == counts["baselines"],
          f"{tag}: launches {counts}, expected no K1 and feature builds"
          f" {want}")


def check_launches(tag: str, counts: dict, first: int) -> None:
    """K1 = K1 first dispatches + K1 baselines, K6 = K6 first dispatches +
    K6 baselines: ``first`` counter blocks were dispatched (each strip,
    stream group or staged part once), each with one K1 or one K6 launch,
    and every other K1 or K6 launch was a baseline; a refetch packed the
    counters its first dispatch kept on the card and launched neither.
    K5 = the feature builds.  One K2 launch a block packed at rel4 or rel,
    and one K4 launch a block packed narrow or wide.  Prints the split."""
    b = counts["blocks"]
    packs = sum(b.values())
    k1_baselines = counts["baselines"] - counts["k6_baselines"]
    check(counts["counters"] == counts["k1_blocks"] + k1_baselines
          and counts["contract"] == counts["k6_blocks"]
          + counts["k6_baselines"]
          and counts["features"] == sum(counts["builds"].values())
          and counts["k1_blocks"] + counts["k6_blocks"] == first
          and packs >= first
          and counts["pack_rel4"] == b["rel4"]
          and counts["pack_rel"] == b["rel"]
          and counts["pack_narrow"] == b["narrow"]
          and counts["pack_wide"] == b["wide"],
          f"{tag}: launches {counts} do not add up to {first} first"
          f" dispatches")
    print(f"{tag} K1 {counts['counters']} = {counts['k1_blocks']} first"
          f" dispatches + {k1_baselines} baselines; K6 {counts['contract']}"
          f" = {counts['k6_blocks']} + {counts['k6_baselines']}; K5"
          f" {counts['features']} = feature builds {counts['builds']};"
          f" {packs - first} refetches"
          f" packed from kept counters; blocks packed by rung: rel4"
          f" {b['rel4']}, rel {b['rel']}, narrow {b['narrow']}, wide"
          f" {b['wide']}, int32 {b['none']}; K2 {counts['pack_rel4']} rel4"
          f" + {counts['pack_rel']} rel, K4 {counts['pack_narrow']} narrow +"
          f" {counts['pack_wide']} wide, K3 {counts['diff_rebuild']}")


def sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def phase_main_path(tmp: str, bench: np.ndarray) -> tuple:
    """The CLI at the bench shape; returns the kernel launches of the run
    and of its dense repeat, its TSV's sha256 and the profiler's split of
    its device time."""
    from distance_tpu_torch import measures
    from distance_tpu_torch.writer import format_float

    n = bench.shape[0]
    fasta = os.path.join(tmp, "bench.fasta")
    out = os.path.join(tmp, "bench_raw.tsv")
    t0 = time.perf_counter()
    ids = write_fasta(fasta, bench)
    print(f"[3] wrote {n} x {bench.shape[1]} FASTA in"
          f" {time.perf_counter() - t0:.3f} s")
    wall, counts = run_cli("[3]", [fasta, "-o", out])
    cached = cached_path()
    check_packed_path("[3]", counts, 10, SQUARE_STRIPS + 2 if cached else 3)
    if cached:
        check_cached("[3]", counts, SQUARE_STRIPS)
    pairs = n * (n - 1) // 2
    print(f"[3] main path: {pairs} pairs in {wall:.3f} s ="
          f" {pairs / wall:.6e} pairs/s end to end, {counts['counters']} K1,"
          f" {counts['contract']} K6 and {counts['features']} K5 launches"
          f" ({gpu_line()})")

    data, nl = read_tsv(out, 1 + pairs)
    rng = np.random.default_rng(SEED + 2)
    ii = rng.integers(0, n - 1, size=SAMPLES)
    jj = ii + 1 + (rng.random(SAMPLES) * (n - 1 - ii)).astype(np.int64)
    for i, j in zip(ii.tolist(), jj.tolist()):
        k = 1 + i * (2 * n - i - 1) // 2 + (j - i - 1)
        want = (f"{ids[i]}\t{ids[j]}\t"
                f"{format_float(measures.raw(bench[i], bench[j]))}")
        check(tsv_line(data, nl, k) == want, f"row ({i}, {j}):"
              f" {tsv_line(data, nl, k)!r} != {want!r}")
    print(f"[3] {1 + pairs} lines; {SAMPLES} random rows equal the host"
          " oracle")
    del data
    sha = sha256(out)
    split = profiled_run("[3]", [fasta, "-o", out])
    # the same square with dense uploads and no reference row: the ladder
    # narrow -> wide
    with dense_no_ref():
        wall0, counts0 = run_cli("[3] dense, no reference row",
                                 [fasta, "-o", out])
        check(sha256(out) == sha, "[3] dense, no reference row: TSV differs")
        b = counts0["blocks"]
        check(b["rel4"] == b["rel"] == b["none"] == 0 and b["narrow"] >= 1
              and counts0["baselines"] == counts0["diff_rebuild"] == 0,
              f"[3] dense, no reference row: launches {counts0}")
        if cached:
            check_cached("[3] dense, no reference row", counts0,
                         SQUARE_STRIPS, ref=False)
        check_launches("[3] dense, no reference row", counts0, 10)
        profiled_run("[3] dense, no reference row", [fasta, "-o", out])
    print(f"[3] square wall {wall:.3f} s with diff uploads and rel4,"
          f" {wall0:.3f} s dense and narrow -> wide"
          f" (DISTANCE_TPU_NO_DIFF_UPLOAD=1 DISTANCE_TPU_NO_REL_PACK=1);"
          f" sha256 equal ({gpu_line()})")
    return counts, counts0, sha, split


@contextlib.contextmanager
def dense_no_ref():
    """Diff uploads and rel packing switched off in this process, as
    their environment variables switch them off."""
    names = ("DISTANCE_TPU_NO_DIFF_UPLOAD", "DISTANCE_TPU_NO_REL_PACK")
    for name in names:
        os.environ[name] = "1"
    try:
        yield
    finally:
        for name in names:
            del os.environ[name]


def phase_six_measures(tmp: str, bench: np.ndarray) -> None:
    from distance_tpu_torch import cli
    from distance_tpu_torch.measures import MEASURES

    sub = bench[:256]
    fasta = os.path.join(tmp, "six.fasta")
    write_fasta(fasta, sub)
    for measure in MEASURES:
        outs = {}
        for backend in ("cuda", "torch"):
            outs[backend] = os.path.join(tmp, f"six_{measure}_{backend}.tsv")
            t0 = time.perf_counter()
            rc = cli.main([fasta, "-m", measure, "--backend", backend,
                           "-o", outs[backend]])
            check(rc == 0, f"{measure} --backend {backend} exited {rc}")
            print(f"[4] {measure} --backend {backend}:"
                  f" {time.perf_counter() - t0:.3f} s")
        with open(outs["cuda"], "rb") as a, open(outs["torch"], "rb") as b:
            check(a.read() == b.read(),
                  f"{measure}: cuda and torch TSVs differ")
        print(f"[4] {measure}: 256 x {sub.shape[1]} TSV byte-identical")


# The card's peak int8 tensor-core rate (NVIDIA's data sheet, H100 SXM,
# dense) and memory rate, for each kernel's bound.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def bound_ms(m: int, n: int, sites: int, channels: int, counters: int,
             padded: int) -> tuple:
    """The least time the card could take for one launch: 2 m n L R int8
    operations (L real sites, R the JAX plan's channels) at the peak int8
    rate, or the codes read once and the int32 counters written once at the
    memory rate, whichever is longer; and which of the two it is."""
    ops = 2.0 * m * n * sites * channels / PEAK_INT8_OPS
    moved = ((m + n) * padded + 4.0 * counters * m * n) / PEAK_BYTES
    return (max(ops, moved) * 1e3,
            "operations" if ops >= moved else "bytes")


def library_counters(x, y, plan):
    """The yardstick: each counter as one ``torch._int_mm`` on its folded
    features, built outside the timed window.  Returns the calls to time
    and a function of their results that gives the counters."""
    import torch

    from distance_tpu_torch.ops.counters import features_torch

    feats = []
    for g in range(plan.counters):
        lo, hi = plan.bounds[g], plan.bounds[g + 1]
        f = features_torch(x, plan.f_lut[lo:hi])  # (R_g, m, L) int8
        gy = features_torch(y, plan.g_lut[lo:hi])
        feats.append((f.permute(1, 0, 2).reshape(x.shape[0], -1)
                      .contiguous(),
                      gy.permute(1, 0, 2).reshape(y.shape[0], -1)
                      .contiguous()))

    def run():
        return [torch._int_mm(f, gy.t()) for f, gy in feats]

    def counters(outs):
        return torch.stack([o // d for o, d in zip(outs, plan.den)])

    return run, counters


def phase_timing(bench: np.ndarray):
    """The kernel against its plain version and the int8-GEMM yardstick at
    the main path's block shape (rows of the bench alignment, sites
    zero-padded to a multiple of 128 as the engine uploads them), for every
    measure: equal, and timed with CUDA events in turns (plain, kernel,
    library, library, kernel, plain), beside the bound.  Returns raw's
    numbers and the largest |kernel - plain|.
    """
    import torch

    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops.counters import counters_cuda, counters_torch
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch

    dev = torch.device("cuda", 0)
    l_pad = -(-bench.shape[1] // 128) * 128
    padded = np.zeros((2 * BLOCK, l_pad), dtype=np.uint8)
    padded[:, : bench.shape[1]] = bench[: 2 * BLOCK]
    x = torch.from_numpy(padded[:BLOCK]).to(dev)
    y = torch.from_numpy(padded[BLOCK:]).to(dev)
    pair_sites = BLOCK * BLOCK * bench.shape[1]

    def timed(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    times = {}
    worst = 0
    card = gpu_line()
    for measure in MEASURES:
        plan = plan_to_torch(get_plan(measure), dev)
        got = counters_cuda(x, y, plan)
        torch.cuda.synchronize()
        err = int((got.long() - counters_torch(x, y, plan).long())
                  .abs().max())
        worst = max(worst, err)
        check(err == 0, f"{measure} {BLOCK} x {BLOCK} x {l_pad}: max"
                        f" |kernel - plain| = {err}")
        lib_run, lib_counters = library_counters(x, y, plan)
        check(torch.equal(got, lib_counters(lib_run())),
              f"{measure}: kernel != torch._int_mm on its folded features")
        fns = {"plain": (lambda: counters_torch(x, y, plan), 1),
               "kernel": (lambda: counters_cuda(x, y, plan), 10),
               "library": (lib_run, 10)}
        ms = {k: [] for k in fns}
        for kind in ("plain", "kernel", "library", "library", "kernel",
                     "plain"):
            ms[kind].append(timed(*fns[kind]))
        del lib_run, lib_counters
        channels = get_plan(measure).total_channels
        bound, by = bound_ms(BLOCK, BLOCK, bench.shape[1], channels,
                             plan.counters, l_pad)
        mean = {k: float(np.mean(v)) for k, v in ms.items()}
        times[measure] = (mean["kernel"], mean["plain"], bound,
                          mean["library"], by)
        print(f"[5] {measure} {BLOCK} x {BLOCK} x {l_pad} (R = {channels},"
              f" {plan.channels} folded): kernel == plain == _int_mm;"
              f" bound {bound:.4f} ms ({by}); kernel {ms['kernel']} ms ="
              f" {bound / mean['kernel']:.4f} of the bound,"
              f" {pair_sites / mean['kernel'] / 1e9:.3f} T pair-sites/s;"
              f" plain {ms['plain']} ms; library {ms['library']} ms ({card})")
    return times["raw"], worst

def contract_bound_ms(m: int, n: int, sites: int, channels: int,
                      counters: int, padded: int) -> tuple:
    """K6's least time for one block: K1's 2 m n L R int8 operations at the
    peak int8 rate, or its features read once ((m + n) R padded bytes) and
    its int32 counters written once at the memory rate, whichever is
    longer; and which of the two it is."""
    ops = 2.0 * m * n * sites * channels / PEAK_INT8_OPS
    moved = ((m + n) * channels * padded + 4.0 * counters * m * n) / PEAK_BYTES
    return (max(ops, moved) * 1e3,
            "operations" if ops >= moved else "bytes")


def channel_yardstick(fx, gy, plan):
    """The second yardstick: one ``torch._int_mm`` a channel of the JAX
    plan's features, then the planes and a shared plan's mix in torch.
    Returns the call to time; its result is the counters."""
    import torch

    def run():
        o = [torch._int_mm(fx[k], gy[k].t()) for k in range(plan.channels)]
        planes = [sum(o[plan.bounds[p] : plan.bounds[p + 1]]) // d
                  for p, d in enumerate(plan.den)]
        if plan.mix_num is None:
            return torch.stack(planes)
        return torch.stack([sum(w * planes[k] for k, w in enumerate(row)
                                if w) // d
                            for row, d in zip(plan.mix_num, plan.mix_den)])

    return run


def phase_cached_timing(bench: np.ndarray):
    """K6 and K5 at the main path's shapes, on the card, for the six
    measures: K6 at the 2048 x 2048 x 29952 block in the JAX plan's form
    (the engine's) and in K1's folded form, equal to its plain version, to
    K1 and to both yardsticks, and timed with CUDA events in turns beside
    K1, its bound, its plain version and the yardsticks; K5 at the
    square's 8192 x 29952 g cache and a 2048-row f strip beside its bound
    (the codes read once and the features written once at the memory
    rate) and its plain version; then K6 at the stream's 2000 x 2096
    group (the loaded rows' f cache against the group's g features)
    beside its bound and K1, and K5 at both.  Returns raw's numbers for
    the result line and the largest |kernel - plain|."""
    import torch

    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops import cached
    from distance_tpu_torch.ops.counters import counters_cuda
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import (cached_plan_to_torch,
                                             fold_cached, plan_to_torch)

    dev = torch.device("cuda", 0)
    card = gpu_line()
    l_pad = -(-bench.shape[1] // 128) * 128
    padded = np.zeros((N_BENCH, l_pad), dtype=np.uint8)
    padded[:, : bench.shape[1]] = bench
    codes = torch.from_numpy(padded).to(dev)
    x, y = codes[:BLOCK], codes[BLOCK : 2 * BLOCK]
    out, worst = {}, 0
    for measure in MEASURES:
        jplan = get_plan(measure)
        plan = cached_plan_to_torch(jplan, dev)
        folded = fold_cached(jplan, dev)
        kp = plan_to_torch(jplan, dev)
        fx, gy = (cached.features_cuda(c, plan, s) for c, s in
                  ((x, "f"), (y, "g")))
        ffx, fgy = (cached.features_cuda(c, folded, s) for c, s in
                    ((x, "f"), (y, "g")))
        got = cached.contract_cuda(fx, gy, plan)
        torch.cuda.synchronize()
        err = int((got.long() - cached.contract_torch(fx, gy, plan).long())
                  .abs().max())
        worst = max(worst, err)
        lib_run, lib_counters = library_counters(x, y, kp)
        chan_run = channel_yardstick(fx, gy, plan)
        check(err == 0 and torch.equal(got, counters_cuda(x, y, kp))
              and torch.equal(got, cached.contract_cuda(ffx, fgy, folded))
              and torch.equal(got, lib_counters(lib_run()))
              and torch.equal(got, chan_run()),
              f"{measure}: K6 != plain, K1, its folded form or a yardstick"
              f" (max |kernel - plain| = {err})")
        ms = in_turns({
            "plain": (lambda: cached.contract_torch(fx, gy, plan), 1),
            "kernel": (lambda: cached.contract_cuda(fx, gy, plan), 10),
            "folded": (lambda: cached.contract_cuda(ffx, fgy, folded), 10),
            "K1": (lambda: counters_cuda(x, y, kp), 10),
            "library": (lib_run, 10),
            "channels": (chan_run, 10),
        }, ("plain", "kernel", "folded", "K1", "library", "channels",
            "channels", "library", "K1", "folded", "kernel", "plain"))
        del lib_run, lib_counters, chan_run, ffx, fgy
        r, g = jplan.total_channels, len(jplan.counters)
        bound, by = contract_bound_ms(BLOCK, BLOCK, bench.shape[1], r, g,
                                      l_pad)
        print(f"[5] K6 {measure} {BLOCK} x {BLOCK} x {l_pad} (R = {r}, folded"
              f" {folded.channels}): == plain == K1 == both yardsticks;"
              f" bound {bound:.4f} ms ({by}); kernel {ms['kernel']:.4f} ms ="
              f" {bound / ms['kernel']:.4f} of the bound; folded form"
              f" {ms['folded']:.4f} ms; K1 {ms['K1']:.4f} ms; plain"
              f" {ms['plain']:.4f} ms; torch._int_mm a folded counter"
              f" {ms['library']:.4f} ms, a channel + mix {ms['channels']:.4f}"
              f" ms ({card})")
        # K5: the square's g cache and a strip's f features
        k5 = {}
        for tag, c, side in (("g cache", codes, "g"), ("f strip", x, "f")):
            # the plain version's one indexing call, its LUT on the card
            # and its int64 codes made outside the timed window
            lut, index = cached._side_lut(plan, side), c.long()
            k5[tag] = in_turns({
                "plain": (lambda: cached.features_torch(c, plan, side), 1),
                "kernel": (lambda: cached.features_cuda(c, plan, side), 10),
                "library": (lambda: lut[:, index], 5),
            }, ("plain", "kernel", "library", "library", "kernel", "plain"))
            del lut, index
            k5_bound = (1 + r) * c.shape[0] * l_pad / PEAK_BYTES * 1e3
            k5[tag]["bound"] = k5_bound
            print(f"[5] K5 {measure} {tag} {c.shape[0]} x {l_pad}: kernel"
                  f" {k5[tag]['kernel']:.4f} ms, bound {k5_bound:.4f} ms"
                  f" (bytes) = {k5_bound / k5[tag]['kernel']:.4f} of the"
                  f" bound; plain {k5[tag]['plain']:.4f} ms; its indexing"
                  f" call lut[:, codes] on int64 codes"
                  f" {k5[tag]['library']:.4f} ms ({card})")
        # the stream's group: K6 of the 2000 loaded rows' f cache against
        # the in-core group's g features, beside K1 at the same shape, and
        # K5 at both
        sx = codes[: N_STREAM[0]]
        sy = codes[N_BENCH - STREAM_GROUP_ROWS:]
        sfx = cached.features_cuda(sx, plan, "f")
        sgy = cached.features_cuda(sy, plan, "g")
        got = cached.contract_cuda(sfx, sgy, plan)
        check(torch.equal(got, counters_cuda(sx, sy, kp)),
              f"{measure}: K6 != K1 at the stream's group")
        del got
        fns = {
            "kernel": (lambda: cached.contract_cuda(sfx, sgy, plan), 5),
            "K1": (lambda: counters_cuda(sx, sy, kp), 5),
            "f cache": (lambda: cached.features_cuda(sx, plan, "f"), 10),
            "group": (lambda: cached.features_cuda(sy, plan, "g"), 10),
        }
        for fn, _ in fns.values():
            fn()  # the allocator's first request of each output size
        sms = in_turns(fns, ("kernel", "K1", "f cache", "group", "group",
                             "f cache", "K1", "kernel"))
        del sfx, sgy
        sbound, sby = contract_bound_ms(sx.shape[0], sy.shape[0],
                                        bench.shape[1], r, g, l_pad)
        k5_stream = {tag: (1 + r) * c.shape[0] * l_pad / PEAK_BYTES * 1e3
                     for tag, c in (("f cache", sx), ("group", sy))}
        print(f"[5] K6 {measure} stream group {sx.shape[0]} x {sy.shape[0]}"
              f" x {l_pad}: == K1; bound {sbound:.4f} ms ({sby}); kernel"
              f" {sms['kernel']:.4f} ms = {sbound / sms['kernel']:.4f} of the"
              f" bound; K1 {sms['K1']:.4f} ms; K5 f cache {sx.shape[0]} rows"
              f" {sms['f cache']:.4f} ms (bound {k5_stream['f cache']:.4f}),"
              f" group g features {sy.shape[0]} rows {sms['group']:.4f} ms"
              f" (bound {k5_stream['group']:.4f}) ({card})")
        if measure == "raw":
            out["contract"] = dict(
                ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound,
                bound_by=by, library_ms=ms["library"],
                folded_ms=ms["folded"], channels_ms=ms["channels"],
                k1_ms=ms["K1"], stream_group_ms=sms["kernel"],
                stream_group_bound_ms=sbound,
                stream_group_k1_ms=sms["K1"])
            out["features"] = dict(
                ms=k5["g cache"]["kernel"], plain_ms=k5["g cache"]["plain"],
                bound_ms=k5["g cache"]["bound"], bound_by="bytes",
                library_ms=k5["g cache"]["library"],
                strip_ms=k5["f strip"]["kernel"],
                strip_library_ms=k5["f strip"]["library"],
                strip_bound_ms=k5["f strip"]["bound"],
                stream_group_ms=sms["group"],
                stream_group_bound_ms=k5_stream["group"],
                stream_f_cache_ms=sms["f cache"],
                stream_f_cache_bound_ms=k5_stream["f cache"])
        del fx, gy
    return out, worst


def cuda_timed(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns: dict, order: tuple) -> dict:
    """Each kind of ``fns`` ({kind: (fn, reps)}) timed in the given order;
    the mean ms of each kind."""
    ms = {k: [] for k in fns}
    for kind in order:
        ms[kind].append(cuda_timed(*fns[kind]))
    return {k: float(np.mean(v)) for k, v in ms.items()}


# The packs are timed on a ring of copies of their counters, more bytes
# than the card's 50 MB L2 holds, so that each launch reads its counters
# from device memory (a 2 x 2048 x 2048 block is 33.5 MB: launched again
# on the same tensor it would be read from L2).
RING_BYTES = 150_000_000
# Seconds of calls a profiled ring runs before its counted rounds.
PROFILE_PREROLL_S = 0.05


def cold_ring_ms(fn, c, kernel, reps: int, call_bytes: int = 0,
                 repeats: int = 1, copies: bool = False) -> dict:
    """``fn`` of each entry of a ring of copies of ``c`` (a tensor, or a
    tuple of tensors that ``fn`` takes), ``reps`` times round, timed three
    ways in ms: ``ms``, the device time of a call's kernels (those whose
    names hold ``kernel``, a name or a tuple of names; None: every kernel
    the calls launch; with ``copies`` the device copies too), each
    kernel's mean duration in a torch.profiler trace (over the rounds of
    its PROFILE_PREROLL_S too) times ``repeats`` (its launches a call),
    summed over the kernels (``seen`` of each kernel's launches are in the
    trace, ``names`` its kernels); ``graph_ms``, a call of the ring's calls
    captured in a CUDA graph and replayed back to back, by CUDA events;
    ``call_ms``, a call by CUDA events (the wrapper included).  The ring
    holds RING_BYTES or more: of ``c``, or ``call_bytes`` a call (the bytes
    a call reads and writes) where given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    parts = c if isinstance(c, tuple) else (c,)
    per_call = call_bytes or sum(t.nbytes for t in parts)
    ring = [tuple(t.clone() for t in parts)
            for _ in range(max(2, -(-RING_BYTES // per_call)))]
    for t in ring:
        fn(*t)
    out = {"call_ms": cuda_timed(lambda: [fn(*t) for t in ring], reps)
           / len(ring)}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for t in ring:
            fn(*t)
    graph.replay()
    out["graph_ms"] = cuda_timed(graph.replay, reps) / len(ring)
    del graph
    rounds = reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # late in a long process the trace can miss a profile's first
        # milliseconds of launches: rounds before the counted ones, for
        # PROFILE_PREROLL_S at least, are timed with them
        t_end = time.perf_counter() + PROFILE_PREROLL_S
        while time.perf_counter() < t_end:
            for t in ring:
                fn(*t)
            torch.cuda.synchronize()
            rounds += 1
        for _ in range(reps):
            for t in ring:
                fn(*t)
        torch.cuda.synchronize()
    path = os.path.join(tempfile.gettempdir(), f"ring_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    wanted = (kernel,) if isinstance(kernel, str) else kernel
    durs = {}
    for ev in events:
        name = ev.get("name", "")
        if ev.get("cat") in (("kernel", "gpu_memcpy") if copies
                             else ("kernel",)) and (
                wanted is None or any(k in name for k in wanted)):
            durs.setdefault(name, []).append(ev["dur"])
    launched = rounds * len(ring) * repeats
    check(bool(durs) and all(0 < len(d) <= launched for d in durs.values()),
          f"the profiler's trace holds {[len(d) for d in durs.values()]}"
          f" launches of {kernel} of {launched} launches")
    out.update(ms=sum(float(np.mean(d)) for d in durs.values()) * repeats
               / 1e3,
               seen=min(len(d) for d in durs.values()), launched=launched,
               names=sorted(durs))
    return out


def phase_pack_timing(bench: np.ndarray, square_split: dict,
                      square_counts: dict) -> dict:
    """K2, K4 and K3 timed on the card beside their plain versions, at the
    main path's shapes: K2 and K4 at raw on the square's 2048 x 2048 block
    and the stream's 2000 x 2096 group, K3 at ``k3_uploads`` (``time_k3``).
    K2 and K4 read their counters cold (``cold_ring_ms``): the kernel's
    device time by the profiler, as a share of its bound, beside the time
    a call by CUDA events; and K2's and K3's time a launch inside the
    square run of phase 3 (``square_split``, ``square_counts``).  Bounds
    in bytes at the card's memory rate (PEAK_BYTES): K2 and K4 read
    4 G m n B and write G m n / 2 (rel4), G m n (rel, narrow) or 4 m n
    (raw's wide words) B; K3 writes rows x l_pad B and reads 5 B a diff.
    Returns each kernel's numbers at the square's shapes."""
    import torch

    from distance_tpu_torch.ops import diffup, packing
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch

    dev = torch.device("cuda", 0)
    card = gpu_line()
    l_pad = -(-bench.shape[1] // 128) * 128
    rows = np.zeros((N_BENCH, l_pad), dtype=np.uint8)
    rows[:, : bench.shape[1]] = bench
    refp = np.zeros(l_pad, dtype=np.uint8)
    refp[: bench.shape[1]] = diffup.sampled_mode_row(bench)
    ref = torch.from_numpy(refp).to(dev)
    plan = plan_to_torch(get_plan("raw"), dev)
    out = {}
    in_run = {name: square_split[f"K2 {rung}"] / 1e3
              / max(1, square_counts[f"pack_{rung}"])
              for name, rung in (("pack_rel4", "rel4"), ("pack_rel", "rel"))}
    shapes = {"square block": (0, BLOCK, BLOCK, 2 * BLOCK),
              "stream group": (0, N_STREAM[0], N_BENCH - STREAM_GROUP_ROWS,
                               N_BENCH)}
    for tag, (a, b, c0, c1) in shapes.items():
        x = torch.from_numpy(rows[a:b]).to(dev)
        y = torch.from_numpy(rows[c0:c1]).to(dev)
        c, rb, cb, cc = bench_baselines(x, y, ref, plan)
        g, m, n = c.shape
        width = bench.shape[1]
        for name, kernel, kern, plain, out_bytes in [
            ("pack_rel4", "rel4_pack",
             lambda t: packing.pack_rel4_cuda(t, rb, cb, cc),
             lambda: packing.pack_rel4_torch(c, rb, cb, cc), g * m * n / 2),
            ("pack_rel", "rel_pack",
             lambda t: packing.pack_rel_cuda(t, rb, cb, cc),
             lambda: packing.pack_rel_torch(c, rb, cb, cc), g * m * n),
            ("pack_narrow", "narrow_lanes",
             lambda t: packing.pack_narrow_cuda("raw", t, width),
             lambda: packing.pack_narrow_torch("raw", c, width), g * m * n),
            ("pack_wide", "wide_words",
             lambda t: packing.pack_wide_cuda("raw", t),
             lambda: packing.pack_wide_torch("raw", c), 4 * m * n),
        ]:
            plain()
            plain_ms = cuda_timed(plain, 3)
            t = cold_ring_ms(kern, c, kernel, 8)
            bound = (4.0 * g * m * n + out_bytes) / PEAK_BYTES * 1e3
            k = "K4" if name in ("pack_narrow", "pack_wide") else "K2"
            run = (f"; in the square run of phase 3 {in_run[name]:.4f} ms a"
                   f" launch ({card})" if name in in_run
                   and tag == "square block" else "")
            print(f"[5] {k} {name} raw {tag} {g} x {m} x {n}, counters read"
                  f" cold: kernel {t['ms']:.4f} ms by the profiler"
                  f" ({t['seen']} of {t['launched']} launches in its trace),"
                  f" bound {bound:.4f} ms (bytes at {PEAK_BYTES:.3e} B/s) ="
                  f" {bound / t['ms']:.4f} of the bound ({card}); back to"
                  f" back in a CUDA graph {t['graph_ms']:.4f} ms a launch ="
                  f" {bound / t['graph_ms']:.4f} of the bound ({card}); a"
                  f" call {t['call_ms']:.4f} ms by CUDA events ({card});"
                  f" plain {plain_ms:.4f} ms; no single PyTorch call"
                  f" computes it{run}")
            if tag == "square block":
                out[name] = dict(ms=t["ms"], graph_ms=t["graph_ms"],
                                 call_ms=t["call_ms"], plain_ms=plain_ms,
                                 bound_ms=bound, bound_by="bytes",
                                 library_ms=None)
                if name in in_run:
                    out[name]["square_run_ms"] = in_run[name]
    k3 = time_k3(k3_uploads(bench), K3_KERNEL, card)["square"]
    k3["square_run_ms"] = (square_split["K3"] / 1e3
                           / max(1, square_counts["diff_rebuild"]))
    print(f"[5] K3 in the square run of phase 3: {k3['square_run_ms']:.4f}"
          f" ms a launch by the profiler ({card})")
    out["diff_rebuild"] = k3
    time_glue(rows, refp, card)
    return out


# K3's kernel, by the name the profiler gives it.
K3_KERNEL = "diff_rebuild_tiles"
# The rows of K3's out-of-core super-row timed in phase 5.
K3_SUPER_ROW = 1024


def k3_uploads(bench: np.ndarray) -> dict:
    """The diff uploads K3 is timed at, on the card, {tag: (ref, idx,
    vals, rows)}, each encoded as the engine encodes it: the square's
    8192 x 29952 (the bench alignment against its reference row), a
    STREAM_GROUP_ROWS-record group of phase 7's stream alignment against
    the loaded side's reference row, and an out-of-core super-row of
    K3_SUPER_ROW bench records."""
    import torch

    from distance_tpu_torch.ops import diffup

    dev = torch.device("cuda", 0)
    l_pad = -(-L_BENCH // 128) * 128

    def upload(mat: np.ndarray, ref_row: np.ndarray) -> tuple:
        padded = np.zeros((mat.shape[0], l_pad), dtype=np.uint8)
        padded[:, :L_BENCH] = mat
        refp = np.zeros(l_pad, dtype=np.uint8)
        refp[:L_BENCH] = ref_row
        enc = diffup.DiffUploader(refp, dev).encode(padded,
                                                    n_real=mat.shape[0])
        check(enc is not None, f"{mat.shape} did not diff-encode")
        return (torch.from_numpy(refp).to(dev),
                *(torch.from_numpy(a).to(dev) for a in enc), mat.shape[0])

    ref_row = diffup.sampled_mode_row(bench)
    stream = make_alignment(sum(N_STREAM), L_BENCH, SEED + 5)
    n1 = N_STREAM[0]
    return {
        "square": upload(bench, ref_row),
        "stream group": upload(stream[n1: n1 + STREAM_GROUP_ROWS],
                               diffup.sampled_mode_row(stream[:n1])),
        "super-row": upload(bench[:K3_SUPER_ROW], ref_row),
    }


def time_k3(uploads: dict, kernel, card: str) -> dict:
    """K3 on each upload of ``k3_uploads``: equal to its plain version,
    then timed as K2 and K4 are (``cold_ring_ms``: the kernel's device time
    by the profiler, summed over the kernels of a call, named by
    ``kernel``, None for every kernel the calls launch; a CUDA graph's
    back-to-back calls; a call by CUDA events), beside its bound (rows x
    l_pad B written and 5 B a diff read, at PEAK_BYTES), its plain version
    and its yardstick (``expand().clone()`` and ``index_put_`` of the
    in-range diffs, selected outside the timed window), both by CUDA
    events in turns.  The inputs of a call are read cold: the ring holds
    RING_BYTES of calls' inputs and outputs.  Returns the numbers by tag."""
    import torch

    from distance_tpu_torch.ops import diffup

    out = {}
    for tag, (ref, idx, vals, rows) in uploads.items():
        l_pad = ref.shape[0]
        total = rows * l_pad
        got = diffup.diff_rebuild_cuda(ref, idx, vals, rows)
        torch.cuda.synchronize()
        check(torch.equal(got, diffup.diff_rebuild_torch(ref, idx, vals,
                                                         rows)),
              f"K3 {tag}: kernel != plain")
        del got
        keep = (idx >= 0) & (idx < total)
        idx_in, vals_in = idx[keep].long(), vals[keep]
        n_diff = int(keep.sum())

        def library():
            o = ref.expand(rows, l_pad).clone()
            o.view(-1).index_put_((idx_in,), vals_in)
            return o

        def plain():
            return diffup.diff_rebuild_torch(ref, idx, vals, rows)

        library()
        plain()
        ms = in_turns({"plain": (plain, 3), "library": (library, 5)},
                      ("plain", "library", "library", "plain"))
        t = cold_ring_ms(
            lambda i, v: diffup.diff_rebuild_cuda(ref, i, v, rows),
            (idx, vals), kernel, 10,
            call_bytes=total + idx.nbytes + vals.nbytes)
        bound = (total + 5.0 * n_diff) / PEAK_BYTES * 1e3
        fits = (" (the output fits the 50 MB L2: calls back to back"
                " rewrite lines it holds)" if total < 50e6 else "")
        print(f"[5] K3 diff_rebuild {tag} {rows} x {l_pad}, {n_diff} diffs"
              f" (capacity {idx.numel()}){fits}: kernel {t['ms']:.4f} ms by"
              f" the profiler ({t['seen']} of {t['launched']} calls in its"
              f" trace; kernels {t['names']}), bound {bound:.4f} ms (bytes"
              f" at {PEAK_BYTES:.3e} B/s) = {bound / t['ms']:.4f} of the"
              f" bound ({card}); back to back in a CUDA graph"
              f" {t['graph_ms']:.4f} ms a call = {bound / t['graph_ms']:.4f}"
              f" of the bound ({card}); a call {t['call_ms']:.4f} ms by CUDA"
              f" events = {bound / t['call_ms']:.4f} of the bound ({card});"
              f" plain {ms['plain']:.4f} ms; library (expand().clone() +"
              f" index_put_) {ms['library']:.4f} ms ({card})")
        out[tag] = dict(ms=t["ms"], graph_ms=t["graph_ms"],
                        call_ms=t["call_ms"], plain_ms=ms["plain"],
                        bound_ms=bound, bound_by="bytes",
                        library_ms=ms["library"])
    return out


def time_glue(rows: np.ndarray, refp: np.ndarray, card: str) -> None:
    """Two device steps that are no kernel of their own, timed with CUDA
    events beside their bounds: ``bundle_sidecars`` (``torch.cat``) at the
    square's first strip (4 blocks of 2048 columns at rel4: cb (2, 8192),
    rb_cc (2, 2049), sidecars (4, 16384) twice; bytes read once and
    written once), and one in-core stream group as the port runs the JAX
    ``_jit_stream_fn`` (K3 rebuild of the group's diffs, then K1, the
    group's column baseline, K2 rel4 and the bundle, for 2000 loaded x
    2096 records at raw; bound: K1's 2 n1 bn L R int8 operations at the
    peak int8 rate, which outweigh its bytes)."""
    import torch

    from distance_tpu_torch import engine
    from distance_tpu_torch.ops import diffup, packing
    from distance_tpu_torch.ops.features import get_plan

    dev = torch.device("cuda", 0)
    g, ti, span, blocks = 2, BLOCK, 4 * BLOCK, 4
    z = torch.zeros
    cb = z((g, span), dtype=torch.int32, device=dev)
    rb_cc = z((g, ti + 1), dtype=torch.int32, device=dev)
    ei = z((blocks, packing.REL4_EXC_CAP), dtype=torch.int32, device=dev)
    ev = torch.ones_like(ei)
    moved = 4.0 * (cb.numel() + rb_cc.numel() + 2 * ei.numel()) + 4 * 6
    ms = cuda_timed(lambda: packing.bundle_sidecars(cb, rb_cc, ei, ev), 50)
    bound = 2 * moved / PEAK_BYTES * 1e3
    print(f"[5] bundle_sidecars, the square's first strip ({blocks} blocks):"
          f" {ms:.4f} ms, bound {bound:.5f} ms (bytes at {PEAK_BYTES:.3e}"
          f" B/s) = {bound / ms:.4f} of the bound ({card})")

    n1, bn = N_STREAM[0], STREAM_GROUP_ROWS
    width = L_BENCH
    eng = engine._BlockEngine("raw", [dev], 1, width, rel=True, tj=bn)
    m1 = eng.prepare(rows[:n1, :width], 1, diff_ref=refp[:width])
    group = rows[-bn:]
    codes, ref = eng.dispatch_stream(group, lambda: [
        diffup.to_device(group, dev)])
    enc = eng.diff_up.encode(group, n_real=bn)

    def step():
        c = eng.diff_up.upload_encoded(enc, bn) if enc is not None else codes
        return engine._Strip(eng, m1, c, 0, [0], n1, bn, (n1, bn), None,
                             ref)("rel4")

    step()
    ms = cuda_timed(step, 5)
    ops = 2.0 * n1 * bn * width * get_plan("raw").total_channels
    bound = ops / PEAK_INT8_OPS * 1e3
    print(f"[5] one in-core stream group (the JAX _jit_stream_fn) raw"
          f" {n1} x {bn} x {width}, {'diff' if enc is not None else 'dense'}"
          f" upload: {ms:.4f} ms, bound {bound:.4f} ms (operations at"
          f" {PEAK_INT8_OPS:.3e} int8 op/s) = {bound / ms:.4f} of the bound"
          f" ({card})")
    eng.release(m1)


def write_inputs(tmp: str, tag: str, n1: int, n2: int, seed: int,
                 prefix2: str) -> tuple:
    """Two FASTA files cut from one alignment, so they share ancestry as
    real inputs do: (alignment, ids1, ids2, path1, path2)."""
    t0 = time.perf_counter()
    mat = make_alignment(n1 + n2, L_BENCH, seed)
    f1 = os.path.join(tmp, "a.fasta")
    f2 = os.path.join(tmp, f"{prefix2}.fasta")
    ids1 = write_fasta(f1, mat[:n1], "a")
    ids2 = write_fasta(f2, mat[n1:], prefix2)
    print(f"{tag} wrote {n1} + {n2} x {L_BENCH} FASTA in"
          f" {time.perf_counter() - t0:.3f} s")
    return mat, ids1, ids2, f1, f2


def device_split(prof) -> dict:
    """Device time (us) of a profiled run by kind, and the union of the
    device's busy intervals."""
    from torch.autograd import DeviceType

    split = {"K1": 0.0, "K2 rel4": 0.0, "K2 rel": 0.0, "K3": 0.0,
             "K4": 0.0, "K5": 0.0, "K6": 0.0, "H2D": 0.0, "D2H": 0.0,
             "other": 0.0}
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end
        spans.append((t0, t1))
        kind = ("K1" if "counters_kernel" in ev.name
                else "K2 rel4" if "rel4_pack" in ev.name
                else "K2 rel" if "rel_pack" in ev.name
                else "K3" if K3_KERNEL in ev.name
                else "K4" if ("narrow_lanes" in ev.name
                              or "wide_words" in ev.name)
                else "K5" if "features_kernel" in ev.name
                else "K6" if ("contract_kernel" in ev.name
                              or "mix_kernel" in ev.name)
                else "H2D" if "HtoD" in ev.name
                else "D2H" if "DtoH" in ev.name else "other")
        split[kind] += t1 - t0
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    split["busy"] = busy
    return split


# The kinds of ``device_split`` by the launch counts of ``read_counts``.
SPLIT_COUNTS = {"K1": ("counters",), "K2 rel4": ("pack_rel4",),
                "K2 rel": ("pack_rel",), "K3": ("diff_rebuild",),
                "K4": ("pack_narrow", "pack_wide"), "K5": ("features",),
                "K6": ("contract",)}


def profiled_run(tag: str, args: list) -> dict:
    """One more ``-m raw`` CLI run under torch.profiler: its device time
    split into the kernels (K1-K6), H2D and D2H, and the device's busy
    share of the wall; every kernel the run launched shows device time of
    its own in the split, so that none falls into "other" unnamed.
    Returns the split (us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distance_tpu_torch import cli

    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli.main(args + ["-m", "raw", "--backend", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"{tag} profiled run exited {rc}")
    counts = read_counts()
    split = device_split(prof)
    check(split["K1"] + split["K6"] > 0,
          f"{tag} the profiler saw no counter kernel")
    for kind, names in SPLIT_COUNTS.items():
        launched = sum(counts[n] for n in names)
        check((split[kind] > 0) == (launched > 0),
              f"{tag}: {launched} {kind} launches ({names}) but"
              f" {split[kind]} us of {kind} in the profiler's split")
    total = sum(v for k, v in split.items() if k != "busy")
    print(f"{tag} profiled run: wall {wall:.3f} s; device time (ms):"
          f" K1 {split['K1'] / 1e3:.3f}, K2 {split['K2 rel4'] / 1e3:.3f}"
          f" rel4 + {split['K2 rel'] / 1e3:.3f} rel,"
          f" K3 {split['K3'] / 1e3:.3f}, K4 {split['K4'] / 1e3:.3f},"
          f" K5 {split['K5'] / 1e3:.3f}, K6 {split['K6'] / 1e3:.3f},"
          f" H2D {split['H2D'] / 1e3:.3f},"
          f" D2H {split['D2H'] / 1e3:.3f}, other {split['other'] / 1e3:.3f};"
          f" H2D share of device time {split['H2D'] / total:.4f}; device"
          f" busy {split['busy'] / 1e6:.3f} s ="
          f" {split['busy'] / 1e6 / wall:.4f} of the wall ({gpu_line()})")
    return split


def phase_rectangle(tmp: str) -> tuple:
    """The CLI on two files cut from one alignment; returns the kernel
    launches of the run and its TSV's sha256."""
    from distance_tpu_torch import measures
    from distance_tpu_torch.writer import format_float

    n1, n2 = N_RECT
    mat, ids1, ids2, f1, f2 = write_inputs(tmp, "[6]", n1, n2, SEED + 3, "b")
    args = [f1, f2, "-o", os.path.join(tmp, "rect.tsv")]
    wall, counts = run_cli("[6]", args)
    cached = cached_path()
    check_packed_path("[6]", counts, 8, RECT_STRIPS + 2 if cached else 3)
    if cached:
        check_cached("[6]", counts, RECT_STRIPS)
    pairs = n1 * n2
    print(f"[6] rectangle: {pairs} pairs in {wall:.3f} s ="
          f" {pairs / wall:.6e} pairs/s end to end, {counts['counters']} K1,"
          f" {counts['contract']} K6 and {counts['features']} K5 launches"
          f" ({gpu_line()})")
    data, nl = read_tsv(args[-1], 1 + pairs)
    rng = np.random.default_rng(SEED + 4)
    for i, j in zip(rng.integers(0, n1, SAMPLES).tolist(),
                    rng.integers(0, n2, SAMPLES).tolist()):
        want = (f"{ids1[i]}\t{ids2[j]}\t"
                f"{format_float(measures.raw(mat[i], mat[n1 + j]))}")
        got = tsv_line(data, nl, 1 + i * n2 + j)
        check(got == want, f"rectangle row ({i}, {j}): {got!r} != {want!r}")
    print(f"[6] {1 + pairs} lines; {SAMPLES} random rows equal the host"
          " oracle")
    del data
    profiled_run("[6]", args)
    return counts, sha256(args[-1])


def phase_stream(tmp: str) -> tuple:
    """The CLI streaming records against a loaded file, both cut from one
    alignment; returns the kernel launches of the run and its TSV's
    sha256."""
    from distance_tpu_torch import measures
    from distance_tpu_torch.writer import format_float

    import torch

    from distance_tpu_torch import engine

    n1, n2 = N_STREAM
    check(sum(STREAM_GROUPS) == n2, "STREAM_GROUPS do not cover the stream")
    # the in-core group on this card at raw and at tn93
    groups = {m: engine._stream_layout(n1, L_BENCH, m, torch.device(
        "cuda", 0), 128).group for m in ("raw", "tn93")}
    check(groups == {"raw": STREAM_GROUP_ROWS, "tn93": 4194},
          f"[7] in-core stream groups {groups}, expected"
          f" {STREAM_GROUP_ROWS} records at raw and 4194 at tn93")
    mat, ids1, ids2, f1, f2 = write_inputs(tmp, "[7]", n1, n2, SEED + 5, "s")
    args = [f1, "-s", f2, "-b", str(STREAM_BATCH),
            "-o", os.path.join(tmp, "stream.tsv")]
    wall, counts = run_cli("[7]", args)
    # one block a group; the baselines: the loaded rows and the reference
    # row once, and the group's rows with each packed block
    check_packed_path("[7]", counts, len(STREAM_GROUPS), 2,
                      group_baselines=True)
    if cached_path():
        check_stream_cached("[7]", counts, len(STREAM_GROUPS))
    pairs = n1 * n2
    print(f"[7] stream: {pairs} pairs in {wall:.3f} s ="
          f" {pairs / wall:.6e} pairs/s end to end, groups {STREAM_GROUPS},"
          f" {counts['contract']} K6 ({counts['k6_blocks']} blocks +"
          f" {counts['k6_baselines']} baselines), {counts['features']} K5"
          f" and {counts['counters']} K1 launches ({gpu_line()})")
    data, nl = read_tsv(args[-1], 1 + pairs)
    rng = np.random.default_rng(SEED + 6)
    for i, r in zip(rng.integers(0, n1, SAMPLES).tolist(),
                    rng.integers(0, n2, SAMPLES).tolist()):
        want = (f"{ids1[i]}\t{ids2[r]}\t"
                f"{format_float(measures.raw(mat[i], mat[n1 + r]))}")
        got = tsv_line(data, nl, 1 + r * n1 + i)
        check(got == want, f"stream pair ({i}, {r}): {got!r} != {want!r}")
    print(f"[7] {1 + pairs} lines; {SAMPLES} random rows equal the host"
          " oracle")
    del data
    sha = sha256(args[-1])
    profiled_run("[7]", args)
    return counts, sha


def phase_cuda_vs_torch(tmp: str, bench: np.ndarray) -> None:
    from distance_tpu_torch import cli
    from distance_tpu_torch.measures import MEASURES

    fa, fb, fs = (os.path.join(tmp, f"{k}.fasta") for k in "abs")
    write_fasta(fa, bench[:128], "a")
    write_fasta(fb, bench[128:384], "b")
    write_fasta(fs, bench[384:684], "s")
    modes = {"rectangle 128 x 256": [fa, fb],
             "stream 128 x 300 -b 7": [fa, "-s", fs, "-b", "7"]}
    for measure in MEASURES:
        for mode, args in modes.items():
            outs = {}
            for backend in ("cuda", "torch"):
                outs[backend] = os.path.join(tmp, f"{backend}.tsv")
                rc = cli.main(args + ["-m", measure, "--backend", backend,
                                      "-o", outs[backend]])
                check(rc == 0, f"{measure} {mode} --backend {backend}"
                               f" exited {rc}")
            with open(outs["cuda"], "rb") as a, open(outs["torch"], "rb") as b:
                check(a.read() == b.read(),
                      f"{measure} {mode}: cuda and torch TSVs differ")
        print(f"[8] {measure}: cuda and torch TSVs byte-identical for the"
              f" {' and the '.join(modes)}")


@contextlib.contextmanager
def out_of_core(budget: int, host: int, tiles: tuple):
    """Lower the engine's budgets and tiles in this process, and watch
    what its out-of-core steps do: the rows of each X-group upload, each
    super-row asked of a staged side (and the uploads among them), the
    host diff encodes made while a super-row is staged, by super-row, the
    records of each staged stream group, and the (x rows, y rows, padded
    sites) of each kernel launch, with CUDA events around each."""
    import torch

    from distance_tpu_torch import engine

    names = ("DEVICE_BUDGET", "HOST_BUF_BUDGET", "TILE_I", "TILE_J")
    saved = [getattr(engine, k) for k in names]
    real = (engine._StagedSide.get, engine._BlockEngine.prepare,
            engine._dispatch_stream_staged, engine.kernels.counters,
            engine._BlockEngine._encode, engine._BlockEngine.pack_block)
    packs = ("rel4", "rel", "narrow", "wide")
    real_packs = [getattr(engine.packing, f"pack_{k}") for k in packs]
    seen = {"x_rows": [], "spans": [], "stagings": 0, "groups": [],
            "launch_shapes": set(), "encodes": {}, "k1_events": [],
            "blocks": set(), "packs": set()}
    staging = []

    def get(side, q0, q1):
        seen["spans"].append((q0, q1))
        seen["stagings"] += side._key != (q0, q1)
        staging.append((q0, q1))
        try:
            return real[0](side, q0, q1)
        finally:
            staging.pop()

    def prepare(eng, matrix, max_block, **kw):
        if not staging:
            seen["x_rows"].append(matrix.shape[0])
        return real[1](eng, matrix, max_block, **kw)

    def staged(*args):
        seen["groups"].append(args[-1])  # the group's records
        return real[2](*args)

    def counters(x, y, plan):
        seen["launch_shapes"].add((x.shape[0], y.shape[0], x.shape[1]))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real[3](x, y, plan)
        end.record()
        seen["k1_events"].append((start, end))
        return out

    def encode(eng, matrix, n_pad, padded):
        # the engine's encode of a prepared matrix: in place, or from its
        # padded copy
        if staging:
            key = staging[-1]
            seen["encodes"][key] = seen["encodes"].get(key, 0) + 1
        return real[4](eng, matrix, n_pad, padded)

    def pack_block(eng, c, mode, i0, j0, bases=None, nv=None,
                   diag_off=None, *window):
        if mode != "none":
            seen["blocks"].add((*c.shape[1:], i0, j0, nv, diag_off))
        return real[5](eng, c, mode, i0, j0, bases, nv, diag_off, *window)

    def rel4(c, rb, cb, cc, i0=0, j0=0, nv=None, diag_off=None, col0=0,
             n_whole=None):
        seen["packs"].add(("rel4", *c.shape[1:], i0, j0, nv, diag_off, col0,
                           c.shape[2] if n_whole is None else n_whole))
        return real_packs[0](c, rb, cb, cc, i0, j0, nv, diag_off, col0,
                             n_whole)

    def rel(c, rb, cb, cc, i0=0, j0=0, diag_off=None):
        seen["packs"].add(("rel", *c.shape[1:], i0, j0, diag_off))
        return real_packs[1](c, rb, cb, cc, i0, j0, diag_off)

    def narrow(measure, c, width):
        seen["packs"].add(("narrow", *c.shape[1:]))
        return real_packs[2](measure, c, width)

    def wide(measure, c):
        seen["packs"].add(("wide", *c.shape[1:]))
        return real_packs[3](measure, c)

    for k, v in zip(names, (budget, host, *tiles)):
        setattr(engine, k, v)
    engine._StagedSide.get = get
    engine._BlockEngine.prepare = prepare
    engine._dispatch_stream_staged = staged
    engine.kernels.counters = counters
    engine._BlockEngine._encode = encode
    engine._BlockEngine.pack_block = pack_block
    for k, fn in zip(packs, (rel4, rel, narrow, wide)):
        setattr(engine.packing, f"pack_{k}", fn)
    try:
        yield seen
    finally:
        for k, v in zip(names, saved):
            setattr(engine, k, v)
        (engine._StagedSide.get, engine._BlockEngine.prepare,
         engine._dispatch_stream_staged, engine.kernels.counters,
         engine._BlockEngine._encode, engine._BlockEngine.pack_block) = real
        for k, fn in zip(packs, real_packs):
            setattr(engine.packing, f"pack_{k}", fn)


def check_packs(tag: str, seen: dict, mode: str) -> None:
    """The run dispatched packed blocks at exactly the positions and masks
    of ``ooc_blocks(mode)``, and launched K2 and K4 only where phase 2
    held them against their plain versions (CHECKED_PACKS)."""
    blocks = ooc_blocks(mode)
    check(seen["blocks"] == blocks,
          f"{tag}: packed blocks differ from the layout's at"
          f" {sorted(map(str, seen['blocks'] ^ blocks))[:6]}")
    unchecked = seen["packs"] - CHECKED_PACKS
    check(seen["packs"] and not unchecked,
          f"{tag}: K2/K4 launches phase 2 did not check:"
          f" {sorted(map(str, unchecked))[:6]}")
    print(f"{tag}: {len(blocks)} packed block positions, the layout's; K2/K4"
          f" launched at {len(seen['packs'])} (rung, shape, mask) keys, each"
          f" held against its plain version in phase 2")


def check_layout(tag: str, groups: list, spans: list, min_groups: int):
    """At least ``min_groups`` groups and 3 super-rows, the last of each
    ragged (shorter than the first)."""
    rows = sorted(set(spans))
    sizes = [q1 - q0 for q0, q1 in rows]
    check(len(groups) >= min_groups and groups[-1] < groups[0],
          f"{tag}: groups {groups}, want >= {min_groups} and a ragged last")
    check(len(rows) >= 3 and sizes[-1] < sizes[0],
          f"{tag}: super-rows {rows}, want >= 3 and a ragged last")
    return rows


def ooc_cli(tag: str, args: list, mode: str, in_core_sha: str,
            min_groups: int = 3, packed: bool = True) -> dict:
    """One CLI run out of core (budgets and tiles ``OOC[mode]``), checked
    and then profiled: its layout, its kernel launch shapes against those
    phase 2 holds against the plain version (``OOC_LAUNCHES[mode]``: the
    blocks alone when not ``packed``, which runs without a reference row
    and so without baselines), its TSV's sha256 against the in-core
    run's, its peak device memory against the budget, its launches by
    rung, the host diff encodes of each super-row against its stagings,
    and the K1 time by CUDA events.  K1's out-of-core path: the engine's
    measure set is emptied for both runs (phase 12 runs the cached one).
    Returns the launch counts of the checked run."""
    spec = OOC[mode]
    import torch

    out = args[-1]
    with out_of_core(*spec) as seen, measure_set(()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        wall, counts = run_cli(tag, args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    k1_ms = sum(a.elapsed_time(b) for a, b in seen["k1_events"])
    groups = seen["groups"] or seen["x_rows"]
    rows = check_layout(tag, groups, seen["spans"], min_groups)
    l_pad = -(-L_BENCH // 128) * 128
    want = {(m, n, l_pad) for m, n in OOC_LAUNCHES[mode]
            if packed or 1 not in (m, n)}
    check(seen["launch_shapes"] == want,
          f"{tag}: launch shapes {sorted(seen['launch_shapes'])}, phase 2"
          f" checked {sorted(want)}")
    check_packs(tag, seen, mode)
    check(peak <= spec[0], f"{tag}: peak device memory {peak} B over the"
                           f" budget {spec[0]} B")
    check(sha256(out) == in_core_sha, f"{tag}: TSV differs from in core")
    b = counts["blocks"]
    if packed:
        check(b["rel4"] >= 1 and b["none"] == 0 and counts["baselines"] >= 3
              and counts["diff_rebuild"] >= 1,
              f"{tag}: launches {counts}, expected packed blocks and diffs")
        # each super-row is encoded once however often it is staged (the
        # X groups' uploads are encoded apart)
        check(set(seen["encodes"].values()) == {1}
              and set(seen["encodes"]) == set(seen["spans"]),
              f"{tag}: host encodes per super-row {seen['encodes']}")
    else:
        check(b["narrow"] >= 1 and b["rel4"] == b["rel"] == b["none"] == 0
              and counts["baselines"] == counts["diff_rebuild"] == 0,
              f"{tag}: launches {counts}, expected narrow -> wide")
    check_launches(tag, counts, len(ooc_dispatches(mode)))
    encodes = sum(seen["encodes"].values())
    print(f"{tag} out of core: wall {wall:.3f} s,"
          f" {counts['counters']} K1 launches taking {k1_ms:.3f} ms by CUDA"
          f" events, groups {groups}, super-rows"
          f" {[q1 - q0 for q0, q1 in rows]}, {seen['stagings']} stagings of"
          f" {len(seen['spans'])} super-row sweeps, {encodes} of them"
          f" diff-encoded on the host (the rest kept encodings), peak device"
          f" memory {peak} B <= budget {spec[0]} B; TSV sha256 equals the"
          f" in-core run's ({gpu_line()})")
    with out_of_core(*spec), measure_set(()):
        profiled_run(tag, args)
    return counts


def phase_out_of_core(shas: dict) -> dict:
    """The square, rectangle and stream out of core at full size (only the
    budgets are cut), the six measures out of core at small shapes, and
    an in-core stream against a loaded side of 4,194,305 records.
    Returns the launch counts by path."""
    from distance_tpu_torch import cli
    from distance_tpu_torch.measures import MEASURES

    print("[9] budgets lowered in this process; the data keeps its size")
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "bench.fasta")
        write_fasta(fasta, make_alignment(N_BENCH, L_BENCH, SEED))
        args = [fasta, "-o", os.path.join(tmp, "ooc.tsv")]
        launches["square-ooc"] = ooc_cli("[9] square", args, "square",
                                         shas["square"])
        with dense_no_ref():
            launches["square-ooc-dense"] = ooc_cli(
                "[9] square, dense, no reference row", args, "square",
                shas["square"], packed=False)
    with tempfile.TemporaryDirectory() as tmp:
        n1, n2 = N_RECT
        *_, f1, f2 = write_inputs(tmp, "[9]", n1, n2, SEED + 3, "b")
        launches["rectangle-ooc"] = ooc_cli(
            "[9] rectangle", [f1, f2, "-o", os.path.join(tmp, "ooc.tsv")],
            "rectangle", shas["rectangle"])
    with tempfile.TemporaryDirectory() as tmp:
        n1, n2 = N_OOC_STREAM
        *_, f1, f2 = write_inputs(tmp, "[9]", n1, n2, SEED + 7, "s")
        args = [f1, "-s", f2, "-b", str(STREAM_BATCH), "-o"]
        ref = os.path.join(tmp, "in_core.tsv")
        wall, n = run_cli("[9] stream in core", args + [ref])
        print(f"[9] stream {n1} x {n2} in core: wall {wall:.3f} s,"
              f" {n['counters']} K1 and {n['contract']} K6 launches")
        launches["stream-staged"] = ooc_cli(
            "[9] stream", args + [os.path.join(tmp, "ooc.tsv")],
            "stream", sha256(ref), min_groups=2)

    bench = make_alignment(684, L_BENCH, SEED)
    with tempfile.TemporaryDirectory() as tmp:
        fq, fa, fb, fs = (os.path.join(tmp, f"{k}.fasta") for k in "qabs")
        write_fasta(fq, bench[:256])
        write_fasta(fa, bench[:128], "a")
        write_fasta(fb, bench[128:384], "b")
        write_fasta(fs, bench[384:684], "s")
        modes = {"square 256": ([fq], OOC_SMALL),
                 "rectangle 128 x 256": ([fa, fb], OOC_SMALL),
                 "stream 128 x 300 -b 7": ([fa, "-s", fs, "-b", "7"],
                                           OOC_SMALL_STREAM)}
        for measure in MEASURES:
            for mode, (args, spec) in modes.items():
                outs = {b: os.path.join(tmp, f"{b}.tsv")
                        for b in ("cuda", "torch")}
                with out_of_core(*spec) as seen:
                    rc = cli.main(args + ["-m", measure, "--backend", "cuda",
                                          "-o", outs["cuda"]])
                check(rc == 0 and len(set(seen["spans"])) >= 2,
                      f"{measure} {mode}: out-of-core cuda run exited {rc}"
                      f" after super-rows {sorted(set(seen['spans']))}")
                rc = cli.main(args + ["-m", measure, "--backend", "torch",
                                      "-o", outs["torch"]])
                check(rc == 0, f"{measure} {mode}: torch run exited {rc}")
                check(sha256(outs["cuda"]) == sha256(outs["torch"]),
                      f"{measure} {mode}: out-of-core cuda TSV differs from"
                      " the in-core torch TSV")
            print(f"[9] {measure}: out-of-core cuda == in-core torch for the"
                  f" {', the '.join(modes)}")

    with tempfile.TemporaryDirectory() as tmp:
        launches["stream-long-loaded"] = phase_long_loaded(tmp)
    print(f"[9] phase 9 passed in {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_long_loaded(tmp: str) -> dict:
    """A few records streamed in core against 4,194,305 loaded records of
    64 sites: one block launch over all of them as x rows (and their
    baseline); returns the launch counts."""
    from distance_tpu_torch import engine, measures
    from distance_tpu_torch.writer import format_float

    n1, n2, width = LONG_STREAM
    t0 = time.perf_counter()
    mat = make_alignment(n1 + n2, width, SEED + 8)
    f1, f2 = os.path.join(tmp, "long.fasta"), os.path.join(tmp, "s.fasta")
    ids1 = write_fasta(f1, mat[:n1], "a")
    ids2 = write_fasta(f2, mat[n1:], "s")
    print(f"[9] wrote {n1} + {n2} x {width} FASTA in"
          f" {time.perf_counter() - t0:.3f} s")
    out = os.path.join(tmp, "long.tsv")
    # the engine's own budgets and tiles: only the launches are watched
    with out_of_core(engine.DEVICE_BUDGET, engine.HOST_BUF_BUDGET,
                     (engine.TILE_I, engine.TILE_J)) as seen:
        wall, counts = run_cli("[9] long loaded",
                               [f1, "-s", f2, "-o", out])
    # 40 mutations in 64 sites: too diverse for diff uploads
    check_packed_path("[9] long loaded", counts, 1, 2, rebuilds=0,
                      group_baselines=True)
    # the loaded rows' f cache (R x n1 x 128 B, 9.66 GB at raw) passes
    # half of the feature-cache budget: the stream takes K1, decided
    # before any launch
    check(counts["k1_blocks"] == 1 and counts["contract"] == 0
          and counts["features"] == 0,
          f"[9] long loaded: launches {counts}, expected K1 and no K5/K6")
    l_pad = -(-width // 128) * 128
    # the group's block, and the baselines of the loaded rows, the
    # group's rows and the reference row
    want = {(n1, n2, l_pad), (n1, 1, l_pad), (1, n2, l_pad), (1, 1, l_pad)}
    check(seen["launch_shapes"] == want,
          f"long loaded: launch shapes {sorted(seen['launch_shapes'])},"
          f" phase 2 checked {sorted(want)}")
    pairs = n1 * n2
    print(f"[9] stream {n2} x {n1} loaded x {width}: {pairs} pairs in"
          f" {wall:.3f} s, one K1 block launch of {n1} x rows (its f cache"
          f" would pass half of the feature-cache budget) ({gpu_line()})")
    data, nl = read_tsv(out, 1 + pairs)
    rng = np.random.default_rng(SEED + 9)
    for i, r in zip(rng.integers(0, n1, SAMPLES).tolist(),
                    rng.integers(0, n2, SAMPLES).tolist()):
        want = (f"{ids1[i]}\t{ids2[r]}\t"
                f"{format_float(measures.raw(mat[i], mat[n1 + r]))}")
        got = tsv_line(data, nl, 1 + r * n1 + i)
        check(got == want, f"long stream pair ({i}, {r}): {got!r} !="
                           f" {want!r}")
    print(f"[9] {1 + pairs} lines; {SAMPLES} random rows equal the host"
          " oracle")
    return counts


def run_procs(tag: str, commands: list, env: dict) -> float:
    """Start the port's CLI with each argument list, all at once, in
    sessions of their own; wait for all of them (killing every process of
    those sessions after a failure or PROC_TIMEOUT_S) and return the
    wall."""
    import signal

    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "distance_tpu_torch.cli",
                               *args], env=env, start_new_session=True)
             for args in commands]
    try:
        for p in procs:
            p.wait(timeout=PROC_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    wall = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    check(rcs == [0] * len(procs), f"{tag}: exit codes {rcs}")
    return wall


def check_sha(tag: str, path: str, want: str) -> None:
    check(sha256(path) == want, f"{tag}: TSV differs from the single run's")
    os.remove(path)


def phase_multiprocess(shas: dict) -> int:
    """The stream of phase 7 in two shards in this process, one of them
    staged, and their merge; then ``--launch 2``, ``--num-hosts`` and
    ``--coordinator`` runs as processes on this card, each TSV against the
    single run's sha256 and each wall beside a single-process one.
    Returns the launches of each kernel in the two shards."""
    import torch

    from distance_tpu_torch import cli, engine

    t_phase = time.perf_counter()
    card = gpu_line()
    here = os.path.dirname(os.path.abspath(__file__))
    # the processes see the first card alone, as on a host of one card
    first = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]
    env = dict(os.environ, PYTHONPATH=here, CUDA_VISIBLE_DEVICES=first,
               DISTANCE_TPU_MERGE_TIMEOUT=str(PROC_TIMEOUT_S))
    l_pad = -(-L_BENCH // 128) * 128
    with tempfile.TemporaryDirectory() as tmp:
        n1, n2 = N_STREAM
        *_, f1, f2 = write_inputs(tmp, "[10]", n1, n2, SEED + 5, "s")
        args = [f1, "-s", f2, "-b", str(STREAM_BATCH)]
        parts = [os.path.join(tmp, f"shard{k}.tsv") for k in range(2)]
        wall0, c_in_core = run_cli("[10] shard 0/2",
                                   args + ["--shard", "0/2", "-o", parts[0]])
        # groups 0 and 2, the baselines of the loaded rows and the
        # reference row, and of each group's rows
        check_packed_path("[10] shard 0/2", c_in_core, 2, 2,
                          group_baselines=True)
        if cached_path():
            check_stream_cached("[10] shard 0/2", c_in_core, 2)
        n_in_core = c_in_core["blocks"]["rel4"]
        with out_of_core(*SHARD_STAGED) as seen:
            wall1, c_staged = run_cli(
                "[10] shard 1/2", args + ["--shard", "1/2", "-o", parts[1]])
        n_staged = c_staged["counters"]
        want = {(m, n, l_pad)
                for m, n in SHARD_STAGED_LAUNCHES + SHARD_STAGED_BASELINES}
        spans = sorted(set(seen["spans"]))
        blocks = c_staged["blocks"]
        check(seen["groups"] == [SHARD_GROUPS[1]]
              and [q1 - q0 for q0, q1 in spans] == [m for m, _ in
                                                    SHARD_STAGED_LAUNCHES]
              and seen["launch_shapes"] == want
              and blocks["rel4"] == 2 and c_staged["baselines"] == 4
              and c_staged["contract"] == c_staged["features"] == 0,
              f"shard 1/2: groups {seen['groups']}, super-rows {spans},"
              f" launch shapes {sorted(seen['launch_shapes'])}, launches"
              f" {c_staged}; expected one staged group against two"
              " super-rows at rel4 through K1 (the group's g features"
              " alone pass the budget), and 4 baselines")
        check_launches("[10] shard 1/2", c_staged,
                       len(SHARD_STAGED_LAUNCHES))
        check_packs("[10] shard 1/2", seen, "stream-shard-staged")
        units = []
        for p in parts:
            with open(p + ".units") as f:
                sidecar = json.load(f)
            units.append([g for g, _ in sidecar["units"]])
            # under a shard the group is the cap, whatever the memory
            check(sidecar["group"] == engine.STREAM_GROUP_CAP,
                  f"{p}: group {sidecar['group']}")
        check(units == [[0, 2], [1]], f"shard units {units}")
        merged = os.path.join(tmp, "merged.tsv")
        t0 = time.perf_counter()
        check(cli.main(["--merge", *parts, "-o", merged]) == 0,
              "--merge failed")
        merge_wall = time.perf_counter() - t0
        check_sha("[10] --merge of the shards", merged, shas["stream"])
        print(f"[10] stream {n1} x {n2} in two shards in this process:"
              f" shard 0/2 in core {wall0:.3f} s ({n_in_core} blocks:"
              f" {c_in_core['contract']} K6, {c_in_core['counters']} K1"
              f" launches, groups 0 and 2), shard 1/2 staged under"
              f" {SHARD_STAGED[0]} B {wall1:.3f} s ({n_staged} K1 launches:"
              f" group 1 against super-rows {[q1 - q0 for q0, q1 in spans]}"
              f" and 4 baselines);"
              f" --merge {merge_wall:.3f} s; sha256 equals phase 7's ({card})")
        for part in parts:
            os.remove(part)

        # the card's memory this process's allocator holds would shrink
        # the processes' budgets
        torch.cuda.empty_cache()
        args += ["-m", "raw", "--backend", "cuda"]
        out = os.path.join(tmp, "out.tsv")
        single = run_procs("[10] stream, one process", [args + ["-o", out]],
                           env)
        check_sha("[10] stream, one process", out, shas["stream"])
        launched = run_procs("[10] stream --launch 2",
                             [args + ["--launch", "2", "-o", out]], env)
        check_sha("[10] stream --launch 2", out, shas["stream"])
        hosts = run_procs("[10] stream --num-hosts 2", [
            args + ["--num-hosts", "2", "--host-id", str(k), "-o", out]
            for k in range(2)], env)
        check_sha("[10] stream --num-hosts 2", out, shas["stream"])
        print(f"[10] stream {n1} x {n2} as processes: one process"
              f" {single:.3f} s, --launch 2 {launched:.3f} s"
              f" ({launched / single:.3f} x), --num-hosts 2 (two processes)"
              f" {hosts:.3f} s ({hosts / single:.3f} x); sha256 equal"
              f" ({card})")

    with tempfile.TemporaryDirectory() as tmp:
        bench = make_alignment(N_BENCH, L_BENCH, SEED)
        fasta = os.path.join(tmp, "bench.fasta")
        write_fasta(fasta, bench)
        args = [fasta, "-m", "raw", "--backend", "cuda"]
        out = os.path.join(tmp, "out.tsv")
        single = run_procs("[10] square, one process", [args + ["-o", out]],
                           env)
        check_sha("[10] square, one process", out, shas["square"])
        launched = run_procs("[10] square --launch 2",
                             [args + ["--launch", "2", "-o", out]], env)
        check_sha("[10] square --launch 2", out, shas["square"])
        print(f"[10] square {N_BENCH} as processes: one process"
              f" {single:.3f} s, --launch 2 {launched:.3f} s"
              f" ({launched / single:.3f} x); sha256 equal ({card})")

        small = os.path.join(tmp, "small.fasta")
        write_fasta(small, bench[:N_COORD])
        del bench
        args = [small, "-m", "raw", "--backend", "cuda"]
        ref = os.path.join(tmp, "ref.tsv")
        check(cli.main(args + ["-o", ref]) == 0, "square 2048 failed")
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
        wall = run_procs("[10] --coordinator", [
            args + ["--coordinator", coordinator, "--num-hosts", "2",
                    "--host-id", str(k), "-o", out] for k in range(2)], env)
        check_sha("[10] --coordinator", out, sha256(ref))
        print(f"[10] square {N_COORD} over a gloo rendezvous at"
              f" {coordinator}: two processes {wall:.3f} s; sha256 equals"
              f" this process's run ({card})")
    print(f"[10] phase 10 passed in {time.perf_counter() - t_phase:.1f} s")
    return {k: c_in_core[k] + c_staged[k] for k in KERNELS}


def phase_ladder(tmp: str) -> dict:
    """Diverse alignments, random bases with 0.5% N, whose residuals
    against any reference row pass the nibble and the int8 ranges: the
    square of N_LADDER records at the bench width walks the pack ladder
    rel4 -> rel -> wide, the same without a reference row narrow -> wide
    (its lanes saturate), and a square past 2^16 sites
    (``LADDER_UNPACKED``), where no 16-bit field holds a counter, rel4 ->
    rel -> int32; a kernel launch is made at each rung.  Line count and
    1200 random rows against the host oracle each.  Returns the kernel
    launches of the three runs together."""
    from distance_tpu_torch.encoding import A, C, G, N, T

    rng = np.random.default_rng(SEED + 10)

    def diverse(n, width):
        mat = rng.choice(np.array([A, C, G, T], dtype=np.uint8),
                         size=(n, width))
        mat[rng.random(mat.shape) < 0.005] = N
        return mat

    mat = diverse(N_LADDER, L_BENCH)
    runs = [("[11]", mat, ("rel4", "rel", "wide")),
            ("[11] no reference row", mat, ("narrow", "wide")),
            (f"[11] {LADDER_UNPACKED[1]} sites", diverse(*LADDER_UNPACKED),
             ("rel4", "rel", "none"))]
    total = dict.fromkeys(KERNELS, 0)
    for tag, m, rungs in runs:
        with (dense_no_ref() if "rel4" not in rungs
              else contextlib.nullcontext()):
            counts = ladder_square(tmp, tag, m, rungs, rng)
        for k in KERNELS:
            total[k] += counts[k]
    return total


def ladder_square(tmp: str, tag: str, mat: np.ndarray, rungs: tuple,
                  rng) -> dict:
    """The square of ``mat``: every block first dispatched at ``rungs[0]``
    and refetched at each later rung, no other rung used; line count and
    1200 random rows.  Returns the launch counts."""
    from distance_tpu_torch import measures
    from distance_tpu_torch.writer import format_float

    fasta = os.path.join(tmp, "diverse.fasta")
    out = os.path.join(tmp, "diverse.tsv")
    ids = write_fasta(fasta, mat)
    wall, counts = run_cli(tag, [fasta, "-o", out])
    b = counts["blocks"]
    check(b[rungs[0]] >= 1
          and all(b[r] == b[rungs[0]] for r in rungs)
          and not any(v for r, v in b.items() if r not in rungs),
          f"{tag} launches {counts}: expected every block at {rungs}")
    check_launches(tag, counts, b[rungs[0]])
    n = mat.shape[0]
    pairs = n * (n - 1) // 2
    print(f"{tag} diverse square {n} x {mat.shape[1]}: {pairs} pairs in"
          f" {wall:.3f} s; blocks by rung {' -> '.join(rungs)}:"
          f" {[b[r] for r in rungs]} ({gpu_line()})")
    data, nl = read_tsv(out, 1 + pairs)
    ii = rng.integers(0, n - 1, size=SAMPLES)
    jj = ii + 1 + (rng.random(SAMPLES) * (n - 1 - ii)).astype(np.int64)
    for i, j in zip(ii.tolist(), jj.tolist()):
        k = 1 + i * (2 * n - i - 1) // 2 + (j - i - 1)
        want = (f"{ids[i]}\t{ids[j]}\t"
                f"{format_float(measures.raw(mat[i], mat[j]))}")
        check(tsv_line(data, nl, k) == want, f"{tag} row ({i}, {j}):"
              f" {tsv_line(data, nl, k)!r} != {want!r}")
    print(f"{tag} {1 + pairs} lines; {SAMPLES} random rows equal the host"
          " oracle")
    return counts


@contextlib.contextmanager
def featcache_off():
    """The cached-feature path switched off in this process, as
    DISTANCE_TPU_FEATCACHE_BUDGET=0 switches it off."""
    os.environ["DISTANCE_TPU_FEATCACHE_BUDGET"] = "0"
    try:
        yield
    finally:
        del os.environ["DISTANCE_TPU_FEATCACHE_BUDGET"]


def phase_cached(shas: dict) -> dict:
    """The cached-feature path against K1's on the main path's inputs: the
    square of phase 3 and the rectangle of phase 6 for raw and tn93, with
    the engine's measure set holding the measure (K5 and K6) and then
    empty (K1), and the square out of core for tn93 with its caches
    (``OOC_CACHED``); then the stream (``phase_cached_stream``).  Returns
    the launch counts by path."""
    import torch

    print("[12] the cached-feature path against K1's, in this process")
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "bench.fasta")
        write_fasta(fasta, make_alignment(N_BENCH, L_BENCH, SEED))
        *_, f1, f2 = write_inputs(tmp, "[12]", *N_RECT, SEED + 3, "b")
        runs = {"square": ([fasta], 10, SQUARE_STRIPS),
                "rectangle": ([f1, f2], 8, RECT_STRIPS)}
        in_core = {}
        for measure in ("raw", "tn93"):
            for mode, (inputs, blocks, strips) in runs.items():
                out = os.path.join(tmp, f"{mode}.tsv")
                tag = f"[12] {mode} {measure}"
                with measure_set({measure}):
                    wall, counts = run_cli(f"{tag} cached",
                                           inputs + ["-o", out], measure)
                check_packed_path(f"{tag} cached", counts, blocks, strips + 2)
                check_cached(f"{tag} cached", counts, strips)
                sha = in_core[mode, measure] = sha256(out)
                shas[f"{mode}-{measure}"] = sha
                with measure_set(()):
                    wall1, counts1 = run_cli(f"{tag} K1",
                                             inputs + ["-o", out], measure)
                check(counts1["contract"] == counts1["features"] == 0,
                      f"{tag} K1: launches {counts1}")
                check_packed_path(f"{tag} K1", counts1, blocks, 3)
                check(sha256(out) == sha, f"{tag}: K6 and K1 TSVs differ")
                check(measure != "raw" or sha == shas[mode],
                      f"{tag}: TSV differs from phase 3's or 6's")
                launches[f"{mode}-{measure}-cached"] = counts
                print(f"{tag}: sha256 equal through K5 + K6 (wall {wall:.3f}"
                      f" s, {counts['contract']} K6, {counts['features']} K5"
                      f" launches, no K1) and through K1 (wall {wall1:.3f} s,"
                      f" {counts1['counters']} K1 launches) ({gpu_line()})")
        budget = OOC_CACHED[0]
        args = [fasta, "-o", os.path.join(tmp, "ooc.tsv")]
        tag = "[12] square tn93 out of core"
        with out_of_core(*OOC_CACHED) as seen, measure_set({"tn93"}):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            wall, counts = run_cli(tag, args, "tn93")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        groups, spans = seen["x_rows"], sorted(set(seen["spans"]))
        b = counts["builds"]
        check(sha256(args[-1]) == in_core["square", "tn93"],
              f"{tag}: TSV differs from in core")
        check(peak <= budget, f"{tag}: peak device memory {peak} B over the"
                              f" budget {budget} B")
        check(counts["counters"] == 0 and len(groups) >= 2 and len(spans) >= 2
              and b == {"g": seen["stagings"], "f": len(groups), "strip": 0,
                        "ref": 2, "group": 0},
              f"{tag}: launches {counts} for groups {groups}, super-rows"
              f" {spans} ({seen['stagings']} stagings)")
        check_launches(tag, counts, counts["k6_blocks"])
        launches["square-ooc-cached"] = counts
        print(f"{tag}: wall {wall:.3f} s, groups {groups} each with its f"
              f" cache, super-rows {[q1 - q0 for q0, q1 in spans]} staged"
              f" {seen['stagings']} times each with its g cache, peak device"
              f" memory {peak} B <= budget {budget} B; TSV sha256 equals the"
              f" in-core run's ({gpu_line()})")
    launches.update(phase_cached_stream(shas))
    print(f"[12] phase 12 passed in {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_cached_stream(shas: dict) -> dict:
    """The stream of phase 7 for raw and tn93 through K5 + K6 (the engine's
    measure set holding the measure) and through K1
    (DISTANCE_TPU_FEATCACHE_BUDGET=0); then the tn93 stream of
    N_OOC_STREAM records in core through K5 + K6, staged with its caches
    (``STREAM_CACHED``) and staged through K1 (the measure set emptied):
    equal sha256, the launches and feature builds of each cached run,
    and the staged run's layout and peak device memory.  Returns the
    launch counts by path."""
    import torch

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        *_, f1, f2 = write_inputs(tmp, "[12]", *N_STREAM, SEED + 5, "s")
        args = [f1, "-s", f2, "-b", str(STREAM_BATCH), "-o",
                os.path.join(tmp, "stream.tsv")]
        for measure in ("raw", "tn93"):
            tag = f"[12] stream {measure}"
            groups = len(STREAM_GROUPS_TN93 if measure == "tn93"
                         else STREAM_GROUPS)
            with measure_set({measure}):
                wall, counts = run_cli(f"{tag} cached", args, measure)
            check_packed_path(f"{tag} cached", counts, groups, 2,
                              group_baselines=True)
            check_stream_cached(f"{tag} cached", counts, groups)
            sha = sha256(args[-1])
            with featcache_off():
                wall1, counts1 = run_cli(f"{tag} K1", args, measure)
            check(counts1["contract"] == counts1["features"] == 0,
                  f"{tag} K1: launches {counts1}")
            check_packed_path(f"{tag} K1", counts1, groups, 2,
                              group_baselines=True)
            check(sha256(args[-1]) == sha, f"{tag}: K6 and K1 TSVs differ")
            check(measure != "raw" or sha == shas["stream"],
                  f"{tag}: TSV differs from phase 7's")
            launches[f"stream-{measure}-cached"] = counts
            print(f"{tag}: sha256 equal through K5 + K6 (wall {wall:.3f} s,"
                  f" {counts['contract']} K6, {counts['features']} K5"
                  f" launches, no K1) and through K1 with"
                  f" DISTANCE_TPU_FEATCACHE_BUDGET=0 (wall {wall1:.3f} s,"
                  f" {counts1['counters']} K1 launches) ({gpu_line()})")

    with tempfile.TemporaryDirectory() as tmp:
        n1, n2 = N_OOC_STREAM
        *_, f1, f2 = write_inputs(tmp, "[12]", n1, n2, SEED + 7, "s")
        args = [f1, "-s", f2, "-b", str(STREAM_BATCH), "-o"]
        ref = os.path.join(tmp, "in_core.tsv")
        tag = "[12] stream tn93 8192 loaded"
        with measure_set({"tn93"}):
            wall0, counts0 = run_cli(f"{tag} in core", args + [ref], "tn93")
        # groups of STREAM_CACHED_IN_CORE
        check_stream_cached(f"{tag} in core", counts0,
                            len(STREAM_CACHED_IN_CORE))
        check_launches(f"{tag} in core", counts0, len(STREAM_CACHED_IN_CORE))
        sha = sha256(ref)
        out = os.path.join(tmp, "staged.tsv")
        budget = STREAM_CACHED[0]
        with out_of_core(*STREAM_CACHED) as seen, measure_set({"tn93"}):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            wall, counts = run_cli(f"{tag} staged", args + [out], "tn93")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        spans = sorted(set(seen["spans"]))
        rows = [q1 - q0 for q0, q1 in spans]
        check(seen["groups"] == list(STREAM_CACHED_GROUPS)
              and rows == [STREAM_CACHED_ROWS] * (n1 // STREAM_CACHED_ROWS)
              and not seen["launch_shapes"],
              f"{tag} staged: groups {seen['groups']}, super-rows {rows},"
              f" K1 launch shapes {sorted(seen['launch_shapes'])}")
        check_stream_cached(f"{tag} staged", counts,
                            len(STREAM_CACHED_GROUPS), seen["stagings"])
        # a part a super-row sweep; the baselines: each super-row's rows
        # once however often it is staged, each group's and the
        # reference row's
        check_launches(f"{tag} staged", counts, len(seen["spans"]))
        check(counts["baselines"] == len(spans) + len(seen["groups"]) + 1,
              f"{tag} staged: launches {counts}")
        check(peak <= budget, f"{tag} staged: peak device memory {peak} B"
                              f" over the budget {budget} B")
        check(sha256(out) == sha, f"{tag} staged: TSV differs from in core")
        with out_of_core(*STREAM_CACHED) as seen1, measure_set(()):
            wall1, counts1 = run_cli(f"{tag} staged K1", args + [out],
                                     "tn93")
        rows1 = sorted({q1 - q0 for q0, q1 in seen1["spans"]})
        check(counts1["contract"] == counts1["features"] == 0
              and seen1["groups"] == seen["groups"]
              and sha256(out) == sha,
              f"{tag} staged K1: launches {counts1}, groups"
              f" {seen1['groups']}, or its TSV differs")
        launches["stream-tn93-staged-cached"] = counts
        print(f"{tag}: sha256 equal in core through K5 + K6 (wall"
              f" {wall0:.3f} s, {counts0['contract']} K6), staged with its"
              f" caches (wall {wall:.3f} s, groups {seen['groups']} against"
              f" {len(spans)} super-rows of {STREAM_CACHED_ROWS} rows staged"
              f" {seen['stagings']} times, each with its f cache;"
              f" {counts['contract']} K6, {counts['features']} K5 launches,"
              f" no K1; peak device memory {peak} B <= budget {budget} B)"
              f" and staged through K1 (wall {wall1:.3f} s, super-rows of"
              f" {rows1} rows, {counts1['counters']} K1 launches)"
              f" ({gpu_line()})")
    return launches


@contextlib.contextmanager
def split_over(devices):
    """The engine's cuda runs on ``devices`` in this process (the tests
    substitute ``engine.devices_of`` alike), watched: the (x rows, y rows)
    of each K1 and K6 launch, each strip call's (rung, blocks, parts of a
    block), and the sidecar bundle of the first strip's first call."""
    from distance_tpu_torch import engine

    real = (engine.kernels.counters, engine.cached_ops.contract,
            engine._Strip.__call__)
    seen = {"shapes": [], "calls": [], "bundle": None}

    def counters(x, y, plan):
        seen["shapes"].append((x.shape[0], y.shape[0]))
        return real[0](x, y, plan)

    def contract(fx, gy, plan):
        seen["shapes"].append((fx.shape[1], gy.shape[1]))
        return real[1](fx, gy, plan)

    def call(strip, mode=None):
        first = strip._kept is None
        rung = mode or strip.eng.mode_for(strip.tj)
        out = real[2](strip, mode)
        seen["calls"].append((rung, first, len(strip.col_starts),
                              len(strip.eng.bounds(strip.tj)), strip.tj))
        if strip.i0 == 0 and first and seen["bundle"] is None and isinstance(
                out, tuple):
            seen["bundle"] = out[1].cpu().numpy()
        return out

    engine.kernels.counters = counters
    engine.cached_ops.contract = contract
    engine._Strip.__call__ = call
    try:
        with engine_devices(devices):
            yield seen
    finally:
        (engine.kernels.counters, engine.cached_ops.contract,
         engine._Strip.__call__) = real


def check_split(tag: str, one: dict, split: dict, seen1: dict, seen: dict,
                k: int, parts: set) -> None:
    """A split run's launches against its one-device run's: the same
    strips at the same rungs (the ladder's course is the one device's,
    the parts' sidecars merging into the whole blocks'), each block a
    launch and a pack a part (K6 or K1 and K2 or K4 at the part shapes
    ``parts``), the g caches, strip and f features built by each part and
    a stream group's g features by each part its records reach, the
    reference row's features and the row baselines and self-counter once,
    a K6 column baseline a part, and K3 once a part an upload."""
    rungs = [(rung, first, blocks) for rung, first, blocks, *_ in
             seen1["calls"]]
    check([(r, f, b) for r, f, b, *_ in seen["calls"]] == rungs,
          f"{tag}: strips {seen['calls']} against one device's {rungs}")
    packs = {rung: 0 for rung in split["blocks"]}
    first = groups = 0
    for rung, was_first, blocks, n_parts, _ in seen["calls"]:
        packs[rung] += blocks * n_parts
        first += was_first * blocks * n_parts
    b1 = one["builds"]
    groups = first if b1["group"] else 0
    want_builds = {"g": k * b1["g"], "f": k * b1["f"],
                   "strip": k * b1["strip"], "ref": b1["ref"],
                   "group": groups}
    extra = (k - 1) * b1["g"] + groups - b1["group"]
    check(split["blocks"] == packs and split["builds"] == want_builds
          and split["k1_blocks"] + split["k6_blocks"] == first
          and split["baselines"] == one["baselines"] + extra
          and split["diff_rebuild"] == k * one["diff_rebuild"],
          f"{tag}: launches {split}, expected packs {packs}, builds"
          f" {want_builds}, {first} block parts, {one['baselines'] + extra}"
          f" baselines and {k * one['diff_rebuild']} K3")
    check_launches(tag, split, first)
    shapes = {s for s in seen["shapes"] if 1 not in s}
    check(shapes == parts, f"{tag}: block launch shapes {sorted(shapes)},"
                           f" expected the parts {sorted(parts)}")


def check_mesh() -> None:
    """``parallel.mesh.sharded_counters`` on a (2, 2) grid of four
    logical devices (over every card, round-robin) against the plain
    version (and K1) on one device, six measures, both backends."""
    import torch

    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops.counters import counters_cuda, counters_torch
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch
    from distance_tpu_torch.parallel import mesh

    cards = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    x_rows, y_rows = MESH_SHAPE
    bench = make_alignment(N_BENCH, L_BENCH, SEED)
    l_pad = -(-L_BENCH // 128) * 128
    rows = np.zeros((N_BENCH, l_pad), dtype=np.uint8)
    rows[:, :L_BENCH] = bench
    x = torch.from_numpy(rows[:x_rows]).to(dev)
    y = torch.from_numpy(rows[-y_rows:]).to(dev)
    grid = mesh.make_mesh([torch.device("cuda", i % cards) for i in range(4)],
                          sp=2)
    for measure in MEASURES:
        plan = get_plan(measure)
        kplan = plan_to_torch(plan, dev)
        want = counters_torch(x, y, kplan)
        check(torch.equal(counters_cuda(x, y, kplan), want),
              f"[13] K1 {measure} != plain")
        for backend in mesh.BACKENDS:
            got = mesh.sharded_counters(x, y, plan, grid, backend)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"[13] sharded_counters {measure}"
                                          f" {backend} != plain")
    plan = get_plan("raw")
    r, g = plan.total_channels, len(plan.counters)
    step = lambda: mesh.sharded_counters(x, y, plan, grid)  # noqa: E731
    ms = cuda_timed(step, 3)
    bound, by = contract_bound_ms(x_rows, y_rows, L_BENCH, r, g, l_pad)
    print(f"[13] sharded_counters raw on the grid (its four devices' K5 and"
          f" K6 in turn, the partials' adds): {ms:.4f} ms"
          f" ({bound / ms:.3f} of the bound of the whole {x_rows} x {y_rows}"
          f" block, {bound:.4f} ms, {by}) ({gpu_line()})")
    print(f"[13] parallel.mesh.sharded_counters on a (2, 2) grid of"
          f" {grid} (y rows over dp, sites over sp, int32 partials summed)"
          f" == the plain version and K1 on one device, {x_rows} x {y_rows} x {L_BENCH}, six"
          f" measures, through K5 + K6 and through K1")


def time_split_parts() -> dict:
    """K6 at the split runs' part shapes, raw, by CUDA events beside the
    one-device block and their bounds: the square's (2048, 1024) part
    alone, the two parts of a 2048² block on two streams of one card, and
    the stream's 2000 x 1048 part; K2 rel4 on a (2048, 1024) part (a
    window of its block) cold, as phase 5 times it, beside its bound."""
    import torch

    from distance_tpu_torch.ops import cached, packing
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import cached_plan_to_torch

    dev = torch.device("cuda", 0)
    plan = get_plan("raw")
    cplan = cached_plan_to_torch(plan, dev)
    r, g = plan.total_channels, len(plan.counters)
    l_pad = -(-L_BENCH // 128) * 128
    rows = np.zeros((N_BENCH, l_pad), dtype=np.uint8)
    rows[:, :L_BENCH] = make_alignment(N_BENCH, L_BENCH, SEED)
    codes = torch.from_numpy(rows).to(dev)
    fx = cached.features(codes[:BLOCK], cplan, "f")
    gy = cached.features(codes[:BLOCK], cplan, "g")
    half = BLOCK // 2
    side = torch.cuda.Stream(dev)

    def two_parts():
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        cached.contract(fx, gy[:, :half], cplan)
        with torch.cuda.stream(side):
            cached.contract(fx, gy[:, half:], cplan)
        main.wait_stream(side)

    def block(n):
        return lambda: cached.contract(fx, gy[:, :n], cplan)

    for fn in (block(BLOCK), block(half), two_parts):
        fn()
    ms = in_turns({"block": (block(BLOCK), 20), "part": (block(half), 20),
                   "two": (two_parts, 20)},
                  ("block", "part", "two", "two", "part", "block"))
    out = {"k6_block_ms": ms["block"], "k6_part_ms": ms["part"],
           "k6_two_parts_ms": ms["two"]}
    bound_block = contract_bound_ms(BLOCK, BLOCK, L_BENCH, r, g, l_pad)[0]
    bound_part = contract_bound_ms(BLOCK, half, L_BENCH, r, g, l_pad)[0]
    fl = cached.features(codes[: N_STREAM[0]], cplan, "f")
    gg = cached.features(codes[-SPLIT_GROUP // 2:], cplan, "g")
    step = lambda: cached.contract(fl, gg, cplan)  # noqa: E731
    step()
    out["k6_stream_part_ms"] = cuda_timed(step, 10)
    bound_stream = contract_bound_ms(N_STREAM[0], SPLIT_GROUP // 2, L_BENCH,
                                     r, g, l_pad)[0]
    del fl, gg
    # a part's g cache on two devices: its half of every block's columns
    rows_part = N_BENCH // 2
    build = lambda: cached.features(codes[:rows_part], cplan, "g")  # noqa: E731
    build()
    out["k5_part_ms"] = cuda_timed(build, 10)
    bound_k5 = (1.0 + r) * rows_part * l_pad / PEAK_BYTES * 1e3
    c = cached.contract(fx, gy[:, :half], cplan)
    rb = torch.zeros((g, BLOCK), dtype=torch.int32, device=dev)
    cb = torch.zeros((g, half), dtype=torch.int32, device=dev)
    cc = torch.zeros(g, dtype=torch.int32, device=dev)
    ring = cold_ring_ms(lambda t: packing.pack_rel4_cuda(
        t, rb, cb, cc, 0, half, None, None, half, BLOCK), c, "rel4_pack", 20)
    bound_k2 = (4.0 * g * BLOCK * half + g * BLOCK * half / 2) / PEAK_BYTES * 1e3
    out.update(k2_part_ms=ring["ms"], k2_part_call_ms=ring["call_ms"],
               bounds={"k6_block": bound_block, "k6_part": bound_part,
                       "k6_stream_part": bound_stream, "k2_part": bound_k2,
                       "k5_part": bound_k5})
    print(f"[13] K6 raw at the split square's part ({BLOCK}, {half}):"
          f" {out['k6_part_ms']:.4f} ms ({bound_part / out['k6_part_ms']:.3f}"
          f" of its bound {bound_part:.4f} ms), the whole {BLOCK}² block"
          f" {out['k6_block_ms']:.4f} ms ({bound_block / out['k6_block_ms']:.3f}"
          f" of {bound_block:.4f}), its two parts on two streams of the card"
          f" {out['k6_two_parts_ms']:.4f} ms; at the stream's part"
          f" ({N_STREAM[0]}, {SPLIT_GROUP // 2}) {out['k6_stream_part_ms']:.4f}"
          f" ms ({bound_stream / out['k6_stream_part_ms']:.3f} of"
          f" {bound_stream:.4f}); K2 rel4 on the ({BLOCK}, {half}) part, a"
          f" window of its block, cold {out['k2_part_ms']:.4f} ms"
          f" ({bound_k2 / out['k2_part_ms']:.3f} of its bound"
          f" {bound_k2:.5f} ms, bytes), a call {out['k2_part_call_ms']:.4f}"
          f" ms; K5 raw of a part's g cache ({rows_part} rows: its half of"
          f" every block's columns) {out['k5_part_ms']:.4f} ms"
          f" ({bound_k5 / out['k5_part_ms']:.3f} of its bound"
          f" {bound_k5:.4f} ms, bytes) ({gpu_line()})")
    return out


def phase_multi_device(shas: dict, ooc_one: dict) -> dict:
    """The engine's column split over several devices (``devices_of``
    returning every card, or on a host of one card two logical devices
    on it, each with its own stream): the square of phase 3, the
    rectangle of phase 6, the stream of phase 7 and the square for tn93,
    each beside its one-device run (equal sha256, launches as
    ``check_split`` derives them, walls), the first strip's rel4 sidecar
    bundle equal to the one-device run's, and the out-of-core square of
    phase 9 (its sha256, its launches against phase 9's ``ooc_one``);
    then ``parallel.mesh.sharded_counters`` on a (2, 2) grid against the
    plain version on one device, six measures.  Returns the split runs'
    launches."""
    import torch

    from distance_tpu_torch.ops import packing

    cards = torch.cuda.device_count()
    one = [torch.device("cuda", 0)]
    devices = split_devices()
    k = len(devices)
    what = (f"{k} logical devices on one card, not a scaling figure"
            if cards == 1 else f"{k} cards")
    print(f"[13] the engine's blocks split over {what}")
    t_phase = time.perf_counter()
    totals = {name: 0 for name in KERNELS}
    split = split_parts(k)
    group_parts, square_parts = split["stream"], split["square"]
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [os.path.join(tmp, d) for d in "qrs"]
        for d in dirs:
            os.mkdir(d)
        fasta = os.path.join(dirs[0], "bench.fasta")
        write_fasta(fasta, make_alignment(N_BENCH, L_BENCH, SEED))
        *_, r1, r2 = write_inputs(dirs[1], "[13]", *N_RECT, SEED + 3, "b")
        *_, s1, s2 = write_inputs(dirs[2], "[13]", *N_STREAM, SEED + 5, "s")
        out = os.path.join(tmp, "split.tsv")
        cases = [("square", [fasta], "raw", shas["square"], square_parts),
                 ("rectangle", [r1, r2], "raw", shas["rectangle"],
                  square_parts),
                 ("stream", [s1, "-s", s2, "-b", str(STREAM_BATCH)], "raw",
                  shas["stream"], group_parts),
                 ("square tn93", [fasta], "tn93", None, square_parts)]
        for name, inputs, measure, want, parts in cases:
            tag = f"[13] {name}"
            with split_over(one) as seen1, measure_set({measure}):
                wall1, c1 = run_cli(f"{tag} one device", inputs + ["-o", out],
                                    measure)
            sha1 = sha256(out)
            with split_over(devices) as seen, measure_set({measure}):
                wall, c = run_cli(f"{tag} on {what}", inputs + ["-o", out],
                                  measure)
            sha = sha256(out)
            check(sha == sha1 and want in (None, sha),
                  f"{tag}: TSV on {what} differs from one device's")
            check_split(tag, c1, c, seen1, seen, k, parts)
            if name == "square":
                check(seen["bundle"] is not None and np.array_equal(
                    seen["bundle"], seen1["bundle"]),
                      f"{tag}: the first strip's sidecar bundle differs")
                exc = packing.unbundle_sidecars(seen["bundle"])[2]
                print(f"{tag}: the first strip's rel4 sidecars (4 blocks,"
                      f" {int((exc >= 0).sum())} outliers kept) merged from"
                      f" the parts equal the one-device run's, bundle and"
                      f" all")
            for kernel in KERNELS:
                totals[kernel] += c[kernel]
            print(f"{tag}: sha256 equal; wall {wall1:.3f} s on one device,"
                  f" {wall:.3f} s on {what}; K6 {c['contract']}, K1"
                  f" {c['counters']}, K5 {c['features']}, K2"
                  f" {c['pack_rel4'] + c['pack_rel']}, K3"
                  f" {c['diff_rebuild']} ({gpu_line()})")
        tag = "[13] square out of core"
        with out_of_core(*OOC["square"]) as ooc, measure_set(()), split_over(
                devices) as seen:
            wall, c = run_cli(tag, [fasta, "-o", out])
        check(sha256(out) == shas["square"], f"{tag}: TSV differs")
        ti, tj = OOC["square"][2]
        shapes = {s for s in seen["shapes"] if 1 not in s}
        check(c["k1_blocks"] == k * ooc_one["k1_blocks"]
              and c["baselines"] == ooc_one["baselines"]
              and c["blocks"] == {r: k * v
                                  for r, v in ooc_one["blocks"].items()}
              and c["diff_rebuild"] == k * ooc_one["diff_rebuild"]
              and shapes == split["square-ooc"],
              f"{tag}: launches {c} (block shapes {sorted(shapes)}) against"
              f" phase 9's {ooc_one} on {k} devices")
        check_launches(tag, c, c["k1_blocks"])
        blocks = {(ti, c1 - c0, i0, j0 + c0, nv, diag_off)
                  for _, _, i0, j0, nv, diag_off in ooc_dispatches("square")
                  for c0, c1 in part_bounds(tj, tj // k)}
        unchecked = ooc["packs"] - CHECKED_PACKS
        check(ooc["blocks"] == blocks and ooc["packs"] and not unchecked,
              f"{tag}: packed parts differ from the layout's at"
              f" {sorted(map(str, ooc['blocks'] ^ blocks))[:6]}, or K2/K4"
              f" launches phase 2 did not check:"
              f" {sorted(map(str, unchecked))[:6]}")
        print(f"{tag}: {len(blocks)} packed parts, the layout's blocks"
              f" split; K2/K4 launched at {len(ooc['packs'])} (rung, shape,"
              f" mask, window) keys, each held against its plain version in"
              f" phase 2")
        for kernel in KERNELS:
            totals[kernel] += c[kernel]
        print(f"{tag}: sha256 equals in core; wall {wall:.3f} s on {what};"
              f" K1 {c['counters']} = {k} x phase 9's"
              f" {ooc_one['k1_blocks']} blocks + {c['baselines']} baselines"
              f" ({gpu_line()})")
    check_mesh()
    time_split_parts()
    print(f"[13] phase 13 passed in {time.perf_counter() - t_phase:.1f} s")
    return {"multi_device": totals}


def measure_mode() -> None:
    """Walls and host phase totals of the rectangle and the stream for
    each measure and batch size, and of a longer stream; no checks."""
    from distance_tpu_torch.measures import MEASURES

    def timed(tag, args, pairs, measure="raw"):
        wall, counts = run_cli(tag, args, measure)
        print(f"{tag}: {pairs} pairs in {wall:.3f} s = {pairs / wall:.6e}"
              f" pairs/s, {counts['counters']} K1 launches")

    n1, n2 = N_RECT
    with tempfile.TemporaryDirectory() as tmp:
        _, _, _, f1, f2 = write_inputs(tmp, "[m]", n1, n2, SEED + 3, "b")
        for measure in MEASURES:
            timed(f"[m] rectangle {measure}",
                  [f1, f2, "-o", os.path.join(tmp, "o.tsv")], n1 * n2,
                  measure)
    for n1, n2 in (N_STREAM, (N_STREAM[0], N_STREAM_LONG)):
        with tempfile.TemporaryDirectory() as tmp:
            _, _, _, f1, f2 = write_inputs(tmp, "[m]", n1, n2, SEED + 5,
                                           "s")
            args = [f1, "-s", f2, "-o", os.path.join(tmp, "o.tsv")]
            tag = f"[m] stream {n1} x {n2}"
            if n2 == N_STREAM_LONG:
                timed(f"{tag} raw -b {STREAM_BATCH}",
                      args + ["-b", str(STREAM_BATCH)], n1 * n2)
                profiled_run(tag, args + ["-b", str(STREAM_BATCH)])
                continue
            for measure in MEASURES:
                timed(f"{tag} {measure} -b {STREAM_BATCH}",
                      args + ["-b", str(STREAM_BATCH)], n1 * n2, measure)
            for batch in (1, 100):
                timed(f"{tag} raw -b {batch}", args + ["-b", str(batch)],
                      n1 * n2)
    measure_out_of_core()


def measure_out_of_core() -> None:
    """Phase 9's three runs in core and out of core, one after the other,
    for each measure: their walls side by side, and out of core the K1
    launches (blocks and baselines) with their time by CUDA events."""
    from distance_tpu_torch.measures import MEASURES

    def inputs(tmp, mode):
        if mode == "square":
            fasta = os.path.join(tmp, "bench.fasta")
            write_fasta(fasta, make_alignment(N_BENCH, L_BENCH, SEED))
            return [fasta], N_BENCH * (N_BENCH - 1) // 2
        if mode == "rectangle":
            *_, f1, f2 = write_inputs(tmp, "[m]", *N_RECT, SEED + 3, "b")
            return [f1, f2], N_RECT[0] * N_RECT[1]
        *_, f1, f2 = write_inputs(tmp, "[m]", *N_OOC_STREAM, SEED + 7, "s")
        return ([f1, "-s", f2, "-b", str(STREAM_BATCH)],
                N_OOC_STREAM[0] * N_OOC_STREAM[1])

    for mode, spec in OOC.items():
        with tempfile.TemporaryDirectory() as tmp:
            args, pairs = inputs(tmp, mode)
            args += ["-o", os.path.join(tmp, "o.tsv")]
            for measure in MEASURES:
                ic, _ = run_cli(f"[m] {mode} {measure} in core", args,
                                measure)
                with out_of_core(*spec) as seen:
                    ooc, n = run_cli(f"[m] {mode} {measure} out of core",
                                     args, measure)
                if not seen["spans"]:
                    print(f"[m] {mode} {measure}: stayed in core under"
                          f" {spec[0]} B")
                    continue
                k1_ms = sum(a.elapsed_time(b) for a, b in seen["k1_events"])
                print(f"[m] {mode} {measure}: {pairs} pairs, in core"
                      f" {ic:.3f} s, out of core {ooc:.3f} s"
                      f" ({ooc / ic:.3f} x, {n['counters']} K1 launches ="
                      f" {sum(n['blocks'].values())} blocks +"
                      f" {n['baselines']} baselines, {k1_ms:.3f} ms by CUDA"
                      f" events) ({gpu_line()})")


# K3's launches on each path, as the diff uploads of these runs make them
# (one a diff-encoded upload: the in-core X side, stream group or staged
# super-row encoding; none where the uploads go dense).
K3_LAUNCHES = {"square": 1, "square-dense": 0, "rectangle": 2,
               "stream": 1 + len(STREAM_GROUPS),
               "square-ooc": 8, "square-ooc-dense": 0, "rectangle-ooc": 10,
               "stream-staged": 19, "stream-long-loaded": 0,
               "stream_shards": 6, "ladder": 0}


def k8_mismatch(got, want) -> float:
    """How far K8's output is from its plain version's: inf where a NaN
    cell differs, else the largest absolute difference of the other
    cells, 0 when their float32 bits are equal."""
    import torch

    nan = want.isnan()
    if not torch.equal(got.isnan(), nan):
        return float("inf")
    g, w = got[~nan], want[~nan]
    if torch.equal(g.view(torch.int32), w.view(torch.int32)):
        return 0.0
    return float((g.double() - w.double()).abs().nan_to_num(
        nan=float("inf")).max())


def phase_count_and_estimate_vs_plain(bench: np.ndarray) -> tuple:
    """K7 equal to its plain version on the card at the card tests' edges
    (``tests/test_torch_cuda.py::K7_EDGES``: widths 0, 1, 15-17, 4097 and
    29904, 0 and 1 rows, row slices at a stride past their width and off
    any boundary) and at phase 14's launches (the bench alignment in
    uploads of ``engine.H2D_CHUNK_BYTES`` rows); K8 bit for bit, NaN cells
    alike, at the card tests' shapes (``K8_SHAPES``: small and large
    counts, so that 0 / 0, jc69's p = 0.75 and k80's p = 0.5 occur), six
    measures, and at the dry run's launches (the k80 counters of its
    stage-1 inputs on one to four devices).  Returns K7's largest absolute
    difference and ``k8_mismatch``'s largest (0 and 0)."""
    import torch

    from distance_tpu_torch import dryrun, engine
    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops import basecount, estimate
    from distance_tpu_torch.ops.counters import counters_cuda
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch

    card = card_tests()
    dev = torch.device("cuda", 0)
    rows_per = engine.H2D_CHUNK_BYTES // bench.shape[1]
    cases = [card.k7_input(dev, *case, seed=sum(case))
             for case in card.K7_EDGES]
    cases += [torch.from_numpy(bench[r0 : r0 + rows_per]).to(dev)
              for r0 in range(0, bench.shape[0], rows_per)]
    err7 = 0
    for codes in cases:
        got = basecount.base_counts_cuda(codes)
        torch.cuda.synchronize()
        want = basecount.base_counts_torch(codes)
        check(got.shape == want.shape, f"[2] K7 shape {tuple(got.shape)}")
        if got.numel():
            err7 = max(err7, int((got.long() - want.long()).abs().max()))
    check(err7 == 0, f"[2] K7 != plain: max |kernel - plain| = {err7}")
    print(f"[2] K7 == plain exactly at {len(card.K7_EDGES)} edges"
          f" {card.K7_EDGES} and the {len(cases) - len(card.K7_EDGES)}"
          f" uploads of the tn93 square ({rows_per} rows of"
          f" {bench.shape[1]} sites each, the last ragged)")
    err8 = 0.0
    launches = estimate.LAUNCHES
    calls = 0
    for measure in MEASURES:
        for shape in card.K8_SHAPES:
            seed = shape[0] * 7 + shape[1]
            c = card.k8_counters(dev, measure, *shape, seed=seed)
            got = estimate.estimate_cuda(c, measure)
            torch.cuda.synchronize()
            err8 = max(err8, k8_mismatch(got, estimate.estimate_torch(
                c, measure)))
            calls += 1
            for sp in card.K8_SP:
                for layout in card.K8_LAYOUTS:
                    parts, out, col0, before = card.k8_case(c, sp, layout,
                                                            seed + sp)
                    got = estimate.estimate_partials_cuda(parts, measure,
                                                          out, col0)
                    torch.cuda.synchronize()
                    calls += 1
                    want = estimate.estimate_partials_torch(parts, measure)
                    err8 = max(err8, k8_mismatch(
                        got[:, col0 : col0 + shape[1]], want))
                    check(card.check_k8_case(got, before, col0, want),
                          f"[2] K8 {measure} {shape} sp {sp} {layout}: !="
                          f" plain, or a cell outside the window moved")
    check(estimate.LAUNCHES == launches + calls,
          f"[2] K8: {estimate.LAUNCHES - launches} launches of {calls}"
          f" calls")
    kplan = plan_to_torch(get_plan("k80"), dev)
    for dp, sp in ((1, 1), (1, 2), (2, 2)):
        x, y = (torch.from_numpy(a).to(dev) for a in dryrun._example_data(
            m=16, n=16 * dp, width=256 * sp, seed=1))
        c = counters_cuda(x, y, kplan)
        got = estimate.estimate_cuda(c, "k80")
        torch.cuda.synchronize()
        err8 = max(err8, k8_mismatch(got, estimate.estimate_torch(c, "k80")))
    check(err8 == 0, f"[2] K8 != plain: {err8}")
    print(f"[2] K8 == plain bit for bit (NaN cells alike), six measures at"
          f" {card.K8_SHAPES}: the whole-block call, and over"
          f" {card.K8_SP} partials in each of {card.K8_LAYOUTS} (one launch"
          f" a call, cells outside the window untouched); k80 at the dry"
          f" run's stage-1 counters on (1, 1), (1, 2) and (2, 2) grids")
    return err7, err8


# Phase 14's seeds of the fuzzer's lattice.
FUZZ_SEEDS = range(200)


def load_fuzzer():
    """``scripts/fuzz_differential_torch.py`` of this checkout."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "fuzz_differential_torch.py")
    spec = importlib.util.spec_from_file_location("fuzz_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_last_functions(shas: dict) -> dict:
    """The JAX package's last device functions, and its fuzzer's lattice:
    the tn93 square of phase 12 with its base tallies counted by K7
    (DISTANCE_TPU_BASECOUNT_DEVICE_MIN=0; the sha256 of phase 12's
    host-count run), the dry run on two logical devices of the first card
    and on every card (stage 1's estimate by K8), and ``fuzz_one(seed,
    "cuda")`` for FUZZ_SEEDS (each configuration's knobs on the card
    against --backend torch).  Returns the launches by path."""
    import torch

    from distance_tpu_torch import dryrun, engine
    from distance_tpu_torch.parallel import mesh

    print("[14] K7 on the tn93 square, the dry run (K8) and the fuzzer's"
          " lattice on the card")
    t_phase = time.perf_counter()
    launches = {}
    first = torch.device("cuda", 0)
    chunks = -(-N_BENCH // (engine.H2D_CHUNK_BYTES // L_BENCH))
    with tempfile.TemporaryDirectory() as tmp, engine_devices([first]):
        fasta = os.path.join(tmp, "bench.fasta")
        write_fasta(fasta, make_alignment(N_BENCH, L_BENCH, SEED))
        out = os.path.join(tmp, "square.tsv")
        tag = "[14] square tn93, bases counted by K7"
        os.environ["DISTANCE_TPU_BASECOUNT_DEVICE_MIN"] = "0"
        try:
            wall, counts = run_cli(tag, [fasta, "-o", out], "tn93")
        finally:
            del os.environ["DISTANCE_TPU_BASECOUNT_DEVICE_MIN"]
        check(counts["base_counts"] == chunks,
              f"{tag}: {counts['base_counts']} K7 launches, expected"
              f" {chunks}")
        check(sha256(out) == shas["square-tn93"],
              f"{tag}: TSV differs from phase 12's host-count run")
        launches["square-tn93-k7"] = counts
        print(f"{tag}: wall {wall:.3f} s, {chunks} K7 launches (uploads of"
              f" {engine.H2D_CHUNK_BYTES // L_BENCH} rows); sha256 equals"
              f" phase 12's host-count run ({gpu_line()})")
    cards = torch.cuda.device_count()

    def refuse(*args, **kwargs):
        raise AssertionError("sharded_step built the (G, m, n) total")

    for tag, devices in (
            ("dryrun", [first, first]),
            ("dryrun-cards", [torch.device("cuda", c) for c in range(cards)])):
        grid_rows = len(dryrun.stage1_mesh(devices))
        reset_counts()
        t0 = time.perf_counter()
        real = mesh.sharded_counters
        mesh.sharded_counters = refuse
        try:
            dryrun.dryrun_multichip(devices)
        finally:
            mesh.sharded_counters = real
        wall = time.perf_counter() - t0
        counts = read_counts()
        check(counts["estimate"] == grid_rows and counts["features"] > 0
              and counts["contract"] > 0,
              f"[14] {tag}: launches {counts}, expected {grid_rows} K8")
        launches[tag] = counts
        print(f"[14] {tag} on {devices}: stage 1 (k80 sharded_step, K8"
              f" {grid_rows} launch a grid row, no (G, m, n) total:"
              f" sharded_counters refused) and stage 2 (the split tn93 sweep"
              f" == --backend torch) passed in {wall:.3f} s; launches"
              f" {counts}")
    fuzz = load_fuzzer()
    reset_counts()
    t0 = time.perf_counter()
    modes = {}
    with engine_devices([first]):
        for seed in FUZZ_SEEDS:
            ok, cfg, detail = fuzz.fuzz_one(seed, "cuda")
            check(ok, f"[14] fuzz seed {seed}: {detail}; config {cfg}")
            modes[cfg["mode"]] = modes.get(cfg["mode"], 0) + 1
    counts = read_counts()
    launches["fuzz"] = counts
    print(f"[14] fuzz: {len(FUZZ_SEEDS)} seeds of the lattice (seeds"
          f" {FUZZ_SEEDS.start}-{FUZZ_SEEDS.stop - 1}; {modes}):"
          f" --backend"
          f" cuda under each configuration's knobs == --backend torch, in"
          f" {time.perf_counter() - t0:.1f} s; launches {counts}")
    print(f"[14] phase 14 passed in {time.perf_counter() - t_phase:.1f} s")
    return launches


def time_count_and_estimate(card: str) -> dict:
    """K7 at the tn93 square's codes (8192 x 29904, more bytes than the L2
    holds: every launch reads them from device memory), one launch, and
    the engine's ``_count_bases_device`` with its uploads from the host,
    beside its byte bound (m L + 16 m bytes), its plain version and the
    four ``(codes == v).sum(1)`` calls; then K8 (``time_k8``)."""
    import torch

    from distance_tpu_torch import engine
    from distance_tpu_torch.ops import basecount

    dev = torch.device("cuda", 0)
    bench = make_alignment(N_BENCH, L_BENCH, SEED)
    codes = torch.from_numpy(bench).to(dev)
    m, width = codes.shape
    bound7 = (m * width + 16.0 * m) / PEAK_BYTES * 1e3

    def library():
        return [(codes == v).sum(1) for v in basecount.BASES]

    t = in_turns({"plain": (lambda: basecount.base_counts_torch(codes), 3),
                  "kernel": (lambda: basecount.base_counts_cuda(codes), 50),
                  "library": (library, 3)},
                 ("plain", "kernel", "library", "library", "kernel", "plain"))
    chunks = -(-m // (engine.H2D_CHUNK_BYTES // width))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._count_bases_device(bench, dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[14] K7 at {m} x {width}: kernel {t['kernel']:.4f} ms"
          f" ({bound7 / t['kernel']:.1%} of its bound {bound7:.4f} ms,"
          f" bytes), plain {t['plain']:.4f} ms, the four (codes == v).sum(1)"
          f" {t['library']:.4f} ms; with its uploads"
          f" (engine._count_bases_device, {chunks} chunks)"
          f" {min(walls):.3f} ms, best of 3 ({card})")
    out = {"base_counts": dict(ms=t["kernel"], plain_ms=t["plain"],
                               bound_ms=bound7, bound_by="bytes",
                               library_ms=t["library"],
                               with_h2d_ms=min(walls))}
    del codes
    out.update(time_k8(card))
    return out


# K8's kernel, by the name the profiler gives it.
K8_KERNEL = "estimate_kernel"


def k8_bound_ms(cells: int, in_bytes: float) -> float:
    """K8's byte bound: ``in_bytes`` a cell read, 4 written."""
    return (in_bytes + 4.0) * cells / PEAK_BYTES * 1e3


def time_k8(card: str) -> dict:
    """K8 on the counters of a 2048 x 2048 block of the bench alignment
    (K1's) for each measure, read cold from a ring of copies larger than
    the L2 (``cold_ring_ms``: the profiler's kernel time, a CUDA graph's
    launch and a call by CUDA events), beside its byte bound (each counter
    row it reads and the output, 4 B a cell each), its plain version and,
    for n and n_high, ``counters[0].to(torch.float32)``, the one PyTorch
    call that computes it; then the k80 step on a (1, 2) grid of one card
    after its partials (K1 on each half of the sites): the fused step (one
    K8 over both partials into the output) against the unfused one (the
    total's zeros, two adds, the join's cat, then K8 on the total), each
    piece timed apart.  Times the tree's own kernel: copied into another
    checkout (``--measure-k8``) it times that checkout's K8, without the
    fused step where its ``ops/estimate.py`` has none.  Returns the
    numbers of k80 for the result line, with every measure's."""
    import torch

    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops import estimate
    from distance_tpu_torch.ops.counters import counters_cuda
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch
    from distance_tpu_torch.parallel.mesh import site_shards

    dev = torch.device("cuda", 0)
    bench = make_alignment(2 * BLOCK, L_BENCH, SEED)
    l_pad = -(-L_BENCH // 128) * 128
    rows = np.zeros((2 * BLOCK, l_pad), dtype=np.uint8)
    rows[:, :L_BENCH] = bench
    x = torch.from_numpy(rows[:BLOCK]).to(dev)
    y = torch.from_numpy(rows[BLOCK:]).to(dev)
    cells = BLOCK * BLOCK
    by_measure = {}
    for measure in MEASURES:
        plan = plan_to_torch(get_plan(measure), dev)
        c = counters_cuda(x, y, plan)
        reads = len(estimate.FORMS[measure][1])
        bound = k8_bound_ms(cells, 4.0 * reads)
        plain = lambda: estimate.estimate_torch(c, measure)  # noqa: E731
        plain()
        plain_ms = cuda_timed(plain, 5)
        t = cold_ring_ms(lambda t: estimate.estimate_cuda(t, measure), c,
                         K8_KERNEL, 20, call_bytes=(4 * reads + 4) * cells)
        lib = None
        if measure in ("n", "n_high"):
            lib = cold_ring_ms(lambda t: t[0].to(torch.float32), c, None,
                               20, call_bytes=8 * cells)
        by_measure[measure] = dict(
            ms=t["ms"], graph_ms=t["graph_ms"], call_ms=t["call_ms"],
            plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
            library_ms=None if lib is None else lib["ms"],
            library_graph_ms=None if lib is None else lib["graph_ms"],
            library_call_ms=None if lib is None else lib["call_ms"])
        yard = ("no one PyTorch call computes it" if lib is None else
                f"counters[0].to(torch.float32) {lib['ms']:.4f} ms by the"
                f" profiler, graph {lib['graph_ms']:.4f}, a call"
                f" {lib['call_ms']:.4f}")
        print(f"[14] K8 {measure} at {BLOCK}^2, {reads} counter rows read"
              f" cold: kernel {t['ms']:.4f} ms by the profiler"
              f" ({t['seen']} of {t['launched']} launches in its trace) ="
              f" {bound / t['ms']:.1%} of its bound {bound:.4f} ms (bytes);"
              f" graph {t['graph_ms']:.4f} ms a launch"
              f" ({bound / t['graph_ms']:.1%}); a call {t['call_ms']:.4f} ms"
              f" by CUDA events ({bound / t['call_ms']:.1%}); plain"
              f" {plain_ms:.4f} ms; {yard} ({card})")
        del c
    out = {"estimate": dict(by_measure["k80"], by_measure=by_measure)}
    # the k80 step on a (1, 2) grid of [cuda:0, cuda:0], after its partials
    plan = plan_to_torch(get_plan("k80"), dev)
    parts = tuple(counters_cuda(x[:, s0:s1].contiguous(),
                                y[:, s0:s1].contiguous(), plan)
                  for s0, s1 in site_shards(l_pad, 2))
    g = parts[0].shape[0]

    def zeros(*_):
        return torch.zeros((g, BLOCK, BLOCK), dtype=torch.int32, device=dev)

    def adds(p0, p1, total):
        # the sums grow (and wrap) from call to call: only the time counts
        total += p0.to(dev)
        total += p1.to(dev)

    def unfused(p0, p1):
        t = zeros()
        t += p0.to(dev)
        t += p1.to(dev)
        return estimate.estimate_cuda(torch.cat([t.to(dev)], dim=2), "k80")

    step_bytes = {"zeros": 4 * g, "adds": 2 * 12 * g, "cat": 8 * g,
                  "K8": 4 * g + 4}
    pieces = {
        "zeros": cold_ring_ms(zeros, parts, None, 20,
                              call_bytes=4 * g * cells),
        # each add reads the total and a partial and writes the total
        "adds": cold_ring_ms(adds, (*parts, torch.zeros_like(parts[0])),
                             None, 20, repeats=2),
        "cat": cold_ring_ms(lambda p0, p1: torch.cat([p0], dim=2), parts,
                            None, 20, copies=True),
        "K8": cold_ring_ms(lambda p0, p1: estimate.estimate_cuda(p0, "k80"),
                           parts, K8_KERNEL, 20),
    }
    whole = cold_ring_ms(unfused, parts, K8_KERNEL, 20)
    want = estimate.estimate_cuda(parts[0] + parts[1], "k80")
    unfused_bound = sum(step_bytes.values()) * cells / PEAK_BYTES * 1e3
    step = {"unfused_bound_ms": unfused_bound,
            "unfused_graph_ms": whole["graph_ms"],
            "unfused_call_ms": whole["call_ms"],
            "unfused_kernels_ms": sum(p["ms"] for p in pieces.values()),
            **{f"unfused_{k}_ms": p["ms"] for k, p in pieces.items()}}
    print(f"[14] k80 step on a (1, 2) grid at {BLOCK}^2 after its partials,"
          f" unfused: zeros {pieces['zeros']['ms']:.4f}, adds"
          f" {pieces['adds']['ms']:.4f}, cat {pieces['cat']['ms']:.4f}, K8"
          f" on the total {pieces['K8']['ms']:.4f} ms by the profiler (sum"
          f" {step['unfused_kernels_ms']:.4f} ms, bound"
          f" {unfused_bound:.4f} ms: 124 B a cell); the whole in a CUDA graph"
          f" {whole['graph_ms']:.4f} ms, a call {whole['call_ms']:.4f} ms"
          f" ({card})")
    if hasattr(estimate, "estimate_partials_cuda"):
        fused_out = torch.empty((BLOCK, BLOCK), dtype=torch.float32,
                                device=dev)

        def fused(p0, p1):
            return estimate.estimate_partials_cuda([p0, p1], "k80")

        got = fused(*parts)
        torch.cuda.synchronize()
        check(k8_mismatch(got, want) == 0
              and k8_mismatch(estimate.estimate_partials_cuda(
                  list(parts), "k80", fused_out), want) == 0,
              "[14] the fused k80 step != K8 of the summed partials")
        t = cold_ring_ms(fused, parts, K8_KERNEL, 20,
                         call_bytes=(12 * 2 + 4) * cells)
        fbound = k8_bound_ms(cells, 12.0 * 2)
        step.update(fused_ms=t["ms"], fused_graph_ms=t["graph_ms"],
                    fused_call_ms=t["call_ms"], fused_bound_ms=fbound)
        print(f"[14] k80 step on a (1, 2) grid at {BLOCK}^2 after its"
              f" partials, fused (one K8 over both partials): kernel"
              f" {t['ms']:.4f} ms by the profiler = {fbound / t['ms']:.1%}"
              f" of its bound {fbound:.4f} ms (28 B a cell); graph"
              f" {t['graph_ms']:.4f} ms, a call {t['call_ms']:.4f} ms;"
              f" against the unfused step's graph"
              f" {whole['graph_ms']:.4f} ms: {whole['graph_ms'] / t['graph_ms']:.2f}x"
              f" ({card})")
    out["estimate"]["step"] = step
    return out


def one_device_phases() -> tuple:
    """Phases 2-12 (the engine on one device): the kernels against their
    plain versions, the main path in its modes, in and out of core, and
    the timings.  Returns (launches by path, sha256 by mode, times by
    kernel, (K1's, K5/K6's, K2-K4's, K7's and K8's largest absolute
    difference))."""
    t0 = time.perf_counter()
    bench = make_alignment(N_BENCH, L_BENCH, SEED)
    print(f"[2] bench alignment {bench.shape} made in"
          f" {time.perf_counter() - t0:.3f} s")
    max_err = phase_kernel_vs_plain(bench)
    max_err_cached = phase_cached_vs_plain(bench)
    max_err_pack = phase_pack_and_rebuild(bench)
    errs_last = phase_count_and_estimate_vs_plain(bench)
    launches, shas = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        (launches["square"], launches["square-dense"], shas["square"],
         square_split) = phase_main_path(tmp, bench)
    with tempfile.TemporaryDirectory() as tmp:
        phase_six_measures(tmp, bench)
    (ms, plain_ms, bound, library_ms, bound_by), err = phase_timing(bench)
    max_err = max(max_err, err)
    times = {"counters": dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=bound_by, library_ms=library_ms)}
    times.update(phase_pack_timing(bench, square_split, launches["square"]))
    cached_times, err = phase_cached_timing(bench)
    max_err_cached = max(max_err_cached, err)
    times.update(cached_times)
    with tempfile.TemporaryDirectory() as tmp:
        launches["rectangle"], shas["rectangle"] = phase_rectangle(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        launches["stream"], shas["stream"] = phase_stream(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cuda_vs_torch(tmp, bench)
    del bench
    launches.update(phase_out_of_core(shas))
    launches["stream_shards"] = phase_multiprocess(shas)
    with tempfile.TemporaryDirectory() as tmp:
        launches["ladder"] = phase_ladder(tmp)
    launches.update(phase_cached(shas))
    return launches, shas, times, (max_err, max_err_cached, max_err_pack,
                                   *errs_last)


def main(argv: list) -> int:
    if argv not in ([], ["--measure"], ["--measure-ooc"], ["--measure-k3"],
                    ["--measure-k8"]):
        print("usage: chip_smoke.py [--measure | --measure-ooc |"
              " --measure-k3 | --measure-k8]", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "distance_tpu_torch")):
        print("chip_smoke: distance_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_environment()
    # every phase but 13 runs the engine on the first card alone, as on a
    # host of one card (a lone process would take every card)
    with engine_devices([torch.device("cuda", 0)]):
        if argv == ["--measure-k3"]:
            time_k3(k3_uploads(make_alignment(N_BENCH, L_BENCH, SEED)), None,
                    card)
        elif argv == ["--measure-k8"]:
            time_k8(card)
        elif argv:
            measure_mode() if argv == ["--measure"] else measure_out_of_core()
        else:
            launches, shas, times, errs = one_device_phases()
    if argv:
        print(f"chip_smoke --measure: done in"
              f" {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    max_err, max_err_cached, max_err_pack, max_err_k7, max_err_k8 = errs
    launches.update(phase_multi_device(shas, launches["square-ooc"]))
    launches.update(phase_last_functions(shas))
    times.update(time_count_and_estimate(card))
    k3 = {path: c["diff_rebuild"] for path, c in launches.items()
          if path in K3_LAUNCHES}
    check(k3 == K3_LAUNCHES, f"K3 launches by path {k3}, expected"
                             f" {K3_LAUNCHES}")
    print(f"K3 launches by path as expected: {k3}")
    print(f"chip_smoke: all phases passed in"
          f" {time.perf_counter() - t_start:.1f} s")
    print(card)
    sources = {
        "counters": ("distance_tpu_torch/csrc/counters.cu",
                     "distance_tpu/ops/pairwise_pallas.py:110", max_err),
        "pack_rel4": ("distance_tpu_torch/csrc/packing.cu",
                      "distance_tpu/ops/packing.py:189", max_err_pack),
        "pack_rel": ("distance_tpu_torch/csrc/packing.cu",
                     "distance_tpu/ops/packing.py:141", max_err_pack),
        "pack_narrow": ("distance_tpu_torch/csrc/packing.cu",
                        "distance_tpu/ops/packing.py:98", max_err_pack),
        "pack_wide": ("distance_tpu_torch/csrc/packing.cu",
                      "distance_tpu/ops/packing.py:49", max_err_pack),
        "diff_rebuild": ("distance_tpu_torch/csrc/diffup.cu",
                         "distance_tpu/ops/diffup.py:74", max_err_pack),
        "features": ("distance_tpu_torch/csrc/features.cu",
                     "distance_tpu/ops/features.py:320", max_err_cached),
        "contract": ("distance_tpu_torch/csrc/contract.cu",
                     "distance_tpu/ops/pairwise_xla.py:62", max_err_cached),
        "base_counts": ("distance_tpu_torch/csrc/basecount.cu",
                        "distance_tpu/ops/pairwise_xla.py:99", max_err_k7),
        "estimate": ("distance_tpu_torch/csrc/estimate.cu",
                     "distance_tpu/parallel/mesh.py:79", max_err_k8),
    }
    kernels = []
    for name in KERNELS:
        source, replaces, err = sources[name]
        by_path = {path: c[name] for path, c in launches.items()}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "max_abs_err": err,
                        **times[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
