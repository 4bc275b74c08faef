"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's wind-tunnel path, its XFOIL-replacement path, its
single-point analysis service, its polar and batch analyses, its
parser-robustness benchmark, paneling probe and flow field, its
multi-device paths, and its exact Joukowski anchor, headline bench records,
profiling utilities and heatmap, its native geometry library and its
service's entry point (``airfoil_tpu_torch``) on the card and
fails (non-zero exit, no result line) if any phase fails:

1. device  — a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them;
2. build   — builds the CUDA libraries (``lbm_steps``,
   ``lbm_steps_tiled``, ``bl_march``, ``field_b64``) from
   ``airfoil_tpu_torch/csrc`` afresh, one nvcc each, in parallel
   (``utils/compile_cache.py``, the server's warm-up's first stage), and
   logs ptxas's registers, stack frames and spills, the resident kernel's
   tiling and shared memory at the served grid and the tiled kernel's
   tile, shared memory and blocks per SM; every kernel must have a 0-byte
   stack frame and no spills;
3. kernel  — ``cell_word`` (one launch) equal to the plain word on every
   grid and mask below; ``lbm_steps`` (the lattice on chip for a whole
   call, one cooperative launch) against the plain torch step on the card,
   NACA 2412 at alpha=6 on 128x32, 384x192 and 640x384 after 1, 8 and 64
   steps: rtol 1e-5, atol 1e-6; one 64-step call traced by the profiler
   is exactly one kernel; past its capacity (1024x512, and the 2:1 grid
   one step of 8 rows past the largest it holds) it raises ValueError
   without a launch;
3b. field_b64 — ``api/field_b64.b64encode`` on card tensors at the served
   frames' field shapes (three 384x192 float32 fields, one 2048x1024),
   random payloads with NaN, +-inf, -0 and denormals: one launch a call,
   each string byte for byte ``binascii.b2a_base64`` of the same bytes;
   the launch timed by CUDA events and the profiler, the whole encode
   (launch, pinned copy, wait) and the path it replaced (a pageable copy
   and ``binascii`` a field) by the host's clock, beside the bytes' bound;
4. server  — the port's HTTP server on the card: /health, /lbm/start,
   20 /lbm/frame posts (one changes alpha), /lbm/stop; checks every
   decoded field, that the frames went through ``lbm_steps``, their
   fields through one ``field_b64`` launch a frame, each reply through
   one gather write (``minihttp.gather_writes``), and the three masks'
   words (start, alpha change) through ``cell_word``, and, from a
   ``torch.profiler`` trace of one frame, that a frame launches exactly
   one LBM kernel, no word kernel and at most one encode kernel;
5. tiled   — ``lbm_steps_tiled`` (K steps per launch, persistent,
   TMA-fed) against the plain step (rtol 1e-5, atol 1e-6) and, wherever
   ``lbm_steps`` holds the grid, against it (max abs 0: the two share
   their per-cell arithmetic) on 24x12 (a window larger than the grid),
   128x32, 384x192, 1000x600 (ragged tiles), 1002x600 (NX % 4 != 0: every
   window by the plain-load path), 2048x1024 and 4096x2048, after 1, 3, K,
   2K+1 and 64 steps, on the NACA mask and on one with solid cells on the
   grid's edges;
6. physics — a CUDA ``WindTunnel`` at 384x192 for 1500 steps at alpha 0
   and 10: finite, CD > 0, CL grows with alpha;
7. large   — a CUDA ``WindTunnel`` at 2048x1024 resolves to the tiled
   kernel and runs 1500 steps at alpha 0 and 10 through it alone (same
   checks); at the largest 2:1 grid ``lbm_steps`` holds, 1500 steps at
   alpha 10 through each kernel give the same CL and CD;
8. speed   — MLUPS at 640x384, 384x192, 2048x1024 and 4096x2048, the
   4-step call (CUDA events, and device time from the profiler) and the
   frame latency at 384x192 and 2048x1024, for the kernels (``lbm_steps``
   where it holds the grid) and the plain torch step.

Then the XFOIL-replacement path (paneling -> panel solver -> coupled
viscous solve), held to the JAX package's outputs in
``tests/golden/torch_viscous.json`` (written by
``tests/make_torch_goldens.py``):

9.  inviscid — ``build_operator`` + ``solve_inviscid`` on the card for
    NACA 0012, 2412 and 4412 at 160 panels, alpha 0 and 5: CL and Cm
    within rtol 1e-4 (atol 1e-5, for the zero-lift cases) of the goldens;
10. march    — the ``bl_march`` kernel against the plain torch march on the
    card: theta, dstar, hk, cf within rtol 1e-4, identical flags and
    x_transition, on every station of five flat-plate lanes (Blasius,
    tripped, free transition at 6e6 and 1e7, none at 2e5), of the NACA
    2412 sides at alpha 0 and 5 tripped at x 0.05 (where the plain
    march's own rounding ensemble must not spread), and of the inputs the
    main path gives the kernel: all 25 side-pair marches of a default
    solve tripped at x 0.05 (the ensemble may spread at the last station
    alone, which is then left out) and all 50 wake marches of that solve
    (whose ensemble must not spread) and of a free one (NACA 2412, alpha
    5), each launched at the shape the solve gives it (2 side lanes, 1
    wake lane) and bit-equal to its lanes of the batch. The free NACA 2412
    sides and the free solve's wakes are held up to the first station
    where the plain march's ensemble spreads, and the sides' x_transition
    must be one of that ensemble's. Then the physics anchors on the
    kernel alone;
11. viscous  — ``solve_viscous`` at its defaults (160 panels, 80 stations,
    24 wake stations, 24 passes) for NACA 2412 at alpha 0 and 5 and NACA
    0012 at 0, +-4 and 16, Re 1e6: CL within 0.025, CD within 5 %, Cm
    within 0.01 and x_transition within 0.05 c of the golden ensemble's
    range, ``converged`` one of its values (alpha 16 must not converge);
    and tripped at x 0.05 (NACA 2412 at alpha 0 and 5, 0012 at 4), where
    the reference is no knife edge, at the same bars around the nominal
    golden run and ``converged`` equal to it; exactly 2 x 25 march
    launches per solve (25 of ``march_side_kernel``, 25 of
    ``march_wake_kernel``); then the slow-tier anchors of
    ``tests/test_viscous.py`` (three more solves: 0012 at Re 5e5 and 5e6,
    and tripped at x 0.1);
12. viscous speed — the default solve's wall time, its split and a
    ``torch.profiler`` trace of it (device time of the march kernels and
    of all operations); one side-pair march at 80 stations with the
    kernel and the plain march (its device operations counted by the
    profiler over its first intervals); the side kernel at 1 lane (each
    side), 2, 62 (a 31-point polar's sides) and 1,914 lanes (the march
    phase's batch), and the wake kernel at 24 stations with its plain
    march.

Then the simultaneous-Newton path (``viscous.newton`` -> ``polar.analyze``
-> ``POST /upload_airfoil/``), held to ``tests/golden/torch_newton.json``
(``tests/make_torch_newton_goldens.py``) at the same bars, around the range
of the reference ensemble's members with the same ``converged``:

13. newton march — every side and wake march of a tripped (x 0.05) and a
    free default Newton solve (NACA 2412, alpha 4: 96 stations a side, 20
    in the wake), as the lanes of one batch with the plain march's
    rounding ensemble, held as in phase 10, and each launched at its own
    shape and bit-equal to its lanes of the batch;
14. newton — the default ``solve_viscous_newton`` at the five golden
    points, ``solve_polar_point`` at NACA 2412 alpha 8 and both
    continuation solves from the reference's donor state to alpha 10;
    exactly 10 side + 1 wake march launches a default solve (3 + 1 a
    continuation); one LM iteration, of one lane and of eight lanes side
    by side, under ``torch.cuda.set_sync_debug_mode("error")``: no host
    synchronisation;
15. analyze — ``analyze_airfoil`` (NACA 2412, 80 points a side) at alpha 4:
    viscous, the coefficients against the golden ensemble, the full
    boundary-layer schema; at alpha 19: inviscid, strategy 3, the warning,
    CD 0, CL and Cm as the reference's; the solver calls beside the
    reference's;
16. upload — ``POST /upload_airfoil/`` on the port's server on the card
    with the golden's file at Re 1e6, alpha 5: the reply's schema and
    coordinates as the reference's, the coefficients within the bars of
    its ensemble, one run log, the analysis counter up by one;
17. polar — ``solve_polar`` (NACA 2412, 80 points a side, alpha -2..6
    step 2, Re 1e6: 5 points in a bucket of 8 lanes), every program
    graphed as a user runs it, held to
    ``tests/golden/torch_polar.json`` (``tests/make_torch_polar_goldens.py``):
    each point's ``mode`` one of the reference ensemble's, CL, CD, Cm and
    x_transition within the bars of the members with its mode and
    ``converged``; its march launches and the walk's continuation and trip
    solves counted (the kernel line's ``polar_launches``, line 1 of phase
    30 and phase 27's one-process wall come from this run); then the same
    polar with the solver's programs eager (``recording``), equal to it
    bit for bit with the same launches and walk solves: its recorded
    marches give the lanes a launch (10 of 16 side lanes and 1 of 8 wakes
    a per-point or rescue pass, 3 of 2 and 1 of 1 a walk solve), and the
    per-point pass's marches are held to the plain march as in phase 13 (a
    free lane whose ensemble's x_transition takes several values may land
    between them: 160 free lanes meet that knife edge where the Newton
    phases' 40 did not); the
    per-point pass's wall, device time and busy share; one LM iteration
    at 1, 8 and 64 lanes (wall, device time); both march kernels at 64
    and 128 lanes with their bounds;
18. batch — ``solve_batch`` of NACA 2412 (80 a side) and 0012 (70) at
    alpha 2: each lane held to its golden ensemble, 10 + 1 launches;
19. served — ``POST /polar/`` with the same sweep equal to the library's
    polar to the JSON's rounding, ``POST /batch/`` with the two files (N
    parts named ``files``) equal to the library's batch, ``GET /stats``
    up by the three analyses served;
20. newton speed — median wall of 5 default solves, the LM iterations
    (graph replays) and host synchronisations of a solve, its device time
    and busy share; one eager LM iteration's dispatched operations, device
    kernels and time, the four batched Cholesky solves, ``_reproject_n``;
    the march kernels at 96 and 20 stations with their plain times and
    bounds; the analyze and upload wall times;
20a. graphs — the LM iteration's CUDA graphs (``viscous/graphs.py``; on
    the card every solve above replays them): (a) at 1, 8 and 32 lanes,
    each key (the operator shared by the lanes, and at 8 and 32 also
    stacked one a lane) captured at NACA 2412 alpha 4 Re 1e6 and replayed
    at NACA 0012 alpha 2 Re 3e5 and NACA 2412 alpha 8: ``_lm_rounds``
    (4 iterations a round, 2 rounds) equal to the eager round on the same
    inputs bit for bit, every round's state and damping, the best state,
    its rms and the rounds; one capture a key, none at a replay; one LM
    iteration's wall and device time graphed and eager at 1 and 32 lanes,
    a default graphed solve; (b) from an empty cache,
    ``warm_polar_kernels(p=32)`` captures 3 graphs (pass, walk, rescue),
    after which the headline's 31-point polar and a 25-point one capture
    none; (c) three threads solving one key (``solve_polar_point`` at
    alpha 2, 4, 6) at once each get their answer alone bit for bit; (d)
    ``POST /upload_airfoil/`` sent to a served port while
    ``start_warmup`` runs (its thread ``solver-warmup`` alive when the
    answer comes) is answered 200 and equal to the same upload after the
    warm-up, whose four stages logged and none failed; each key's graph
    pool. (b) counts the graphs of every program: ``warm_polar_kernels``
    captures 28 (five Newton programs at three keys, the walk's inviscid
    fill, the operator build's two graphs plain and smoothed at each of
    the three coordinate buckets), the polars none;
20b. solver graphs — the solver's other programs as CUDA graphs
    (``viscous/graphs.py``: the direct solve ``solve_viscous``, the Newton
    set-up, round and answer), from an empty cache: each graphed equals
    its eager body bit for bit with the same march launches, at the keys
    the main paths replay: the direct solve at the upload's last resort
    (1 lane, 160 panels, 80/24/24), the graft entry's (128 panels,
    48/16/12) and a parser chunk (32 lanes, 128 panels, 64/16/16, one lane
    an all-zero loop whose NaNs stay in it), at alpha 0 and 5; the Newton
    programs at the default solve's lane, the polar's points pass (32
    lanes), its walk's continuation (1 lane, 1 warm pass, a start state)
    and its rescue (8 lanes, smoothed), 3 points a key; one capture a key,
    none at a replay; each key's graph pool;
20c. program graphs — the operator build, the standalone inviscid solve
    and the frame diagnostics as CUDA graphs (``inviscid/programs.py``,
    ``lbm/diagnostics.py``), from an empty cache, each graphed equal to
    its eager body bit for bit, one capture a key and none at a replay:
    the operator at the polar's bucket (1 lane, 192 points, 160 panels,
    plain and smoothed), a parser chunk (32 lanes, 121 points, 128
    panels, an all-zero lane whose non-finite values stay in it), the
    batch's lanes (one loop a key) and the graft entry's ``fn`` (its
    operator and direct solve), two inputs a key; the inviscid solve at
    the walk's fill (32 angles) and strategy 3 (one angle); the frame at
    384x192 and 2048x1024 after 200 steps, then after a ``set_u0`` and
    after a ``set_alpha``, each also equal bit for bit to
    ``forces_and_separation`` and ``render_fields`` with the float ``u0``,
    then three of the tunnel's own frames replaying the key; each key's
    graph pool; whether ``torch.linalg.lu_factor_ex`` captures at one
    matrix of 161 and at the chunk's 32 of 129 (logged, not required).

The phases that record the marches a solve makes (``recording``: phases
10, 12, 13, and the second runs of 17 and 22) run the solver's programs
as their eager bodies (``eager_programs``), since a graph's replay calls
no Python wrapper; phases 17 and 22 first run graphed, as a user does,
and hold the eager run to that bit for bit. Every other launch count
counts each replay's captured launches (a capture's own are not
counted). Phase 21 captures its chunk's graph
afresh, with its shape recorder in place, before it times the benchmark.

Then the parser-robustness benchmark (``bench/parser_benchmark.py``: the
direct solve over chunks of 32 geometry lanes at Re 2e5, alpha 5), held to
``tests/golden/torch_bench.json`` (``tests/make_torch_bench_goldens.py``:
the JAX benchmark at Re (1 + k 2^-23), k = -1, 0, 1), the probe and the
flow field:

21. parser bench — ``run_benchmark`` over the golden's 500-file corpus on
    the card with the launch counts set to 0 just before: 17 side launches
    of 64 lanes and 17 wake launches of 32 a chunk, 32 chunks; O, the
    verdicts (of 1,000) off all three JAX members, at most S, the most on
    which one member differs from both others (with the probe's, below);
    raw, parsed, rescued and regressed within S of the nominal member's;
    the wall split into operators, lane solves and the rest;
22. parser tripped — the first raw and parsed chunks tripped at x 0.05,
    graphed: every lane whose three JAX members agree on the verdict and
    lie within a tenth of each bar (CL 0.025, CD 5 %, Cm 0.01, x_tr 0.05 c; all
    non-finite counts as agreeing) held to the nominal member at the bars
    with its verdict, a field non-finite in both agreeing; the same
    chunks with the solver's programs eager equal to them bit for bit, and
    every march call of those held to the plain march as in phase 13 (each
    lane up to where its ensemble spreads, x_transition in the ensemble or
    between its values, NaN agreeing with NaN);
23. parser speed — one chunk's wall (operators, solve) and its profile;
    the march kernels at the benchmark's shapes (64 x 64 sides, 32 x 16
    wakes) with their bounds;
24. probe — ``probe_strategies`` for NACA 2412 and the corpus's second
    file (``af0001_thick_te_lednicer.dat``):
    each row bit-equal to the port's own solve with its plan, its verdict
    counted toward O against the JAX probe members; CL and CD printed
    beside theirs;
25. flow field — ``compute_flow_field`` of NACA 2412 at alpha 5 (220 x 220)
    on the card against the port's CPU run: u and v within rtol 1e-4
    (atol 1e-6), CL within 1e-5, the same number of streamlines.

Then the multi-device paths (``airfoil_tpu_torch.parallel``,
``lbm/sharded.py``, ``graft_entry.py``), each through
``parallel.launch.run``: one process a rank, over 1 rank (an NCCL group;
one rank runs no collective: its halo exchange is a local copy and its
gather the block itself) and over 4 ranks sharing the card (gloo, every
exchange staged through pinned host memory), both built before any rank
starts:

26. sharded lbm — ``sharded_lbm_steps`` of NACA 2412 at alpha 6 on 640x384
    (every extended block held by ``lbm_steps``) and 2048x1024 (every one
    past it: ``lbm_steps_tiled``), 13 steps in rounds of 5 and 128 in
    rounds of 8, the launch counts set to 0 just before each run and read
    just after on every rank: one launch a round of the kernel that holds
    the extended block, none of the other, one ``cell_word`` a rank; the
    lattice gathered by ``gather_rows`` held to the plain step on the same
    inputs (rtol 2e-5, atol 2e-6) and, where it is not equal to the
    unsharded kernel's output bit for bit, the log says so; ms a round;
    whether gloo's ``all_gather`` takes CUDA tensors;
27. sharded polar — ``sharded_polar`` of phase 17's points at 1 and 4
    ranks, each point held jointly to one member of its ensemble in
    ``tests/golden/torch_parallel.json`` (``tests/make_torch_parallel_goldens.py``:
    the reference's ``sharded_polar`` on 1 and 4 devices at Re (1 + k
    2^-23), k = -4..4) with its mode and ``converged``; a point held by
    no member must share the verdicts of one and lie no farther from its
    nearest such member than the farthest of the reference's members lies
    from its own nearest other member at that point (``held_to_spread``);
    every block's lanes at the reference's own final states
    (``held_from_states``); each rank's
    march launches against its walk solves (10 side + 1 wake a pass, 3 + 1
    a walk solve), its points-pass, walk and rescue split; beside them the
    wall of phase 17's single-process ``solve_polar`` of the same points
    (the same geometry, alphas, Re and panels, required), not solved again;
28. graft entry — ``graft_entry.entry()`` on the card (NACA 2412, alpha 5,
    128 panels, 48 stations, 12 passes), its [cl, cd, cm] held jointly to
    one member of the reference's 9-member ensemble, 13 + 13 march
    launches; then ``dryrun_multichip(4, backend="gloo")``.

Then the exact Joukowski anchor, the headline bench
(``bench/headline.py``), the profiling utilities (``utils/profiling.py``)
and the heatmap (``ui/flowviz.py``):

29. models — the four exact Joukowski cases of ``tests/test_inviscid.py``
    (``models.joukowski``, 160 panels from the card's own ``repanel``):
    CL within 1.5 % of ``joukowski_exact`` (|CL| < 5e-3 at zero lift), Cp
    rms < 0.035 for x < 0.98, CL and Cm within 1e-4 relative + 1e-5 of the
    port's CPU solve of the same nodes;
30. headline — line 2's records (``bench_lbm``: 640x384 and 384x192
    through ``lbm_steps``, 2048x1024 through ``lbm_steps_tiled``, 128 steps
    a call), the launch counts set to 0 just before and read just after:
    each grid's kernel launched warm-up + n_calls times, the other none,
    one ``cell_word``; line 1's record from phase 17's ``solve_polar``
    result and wall (no new solve), its mode counts phase 17's modes;
    ``stage_timer`` around one 128-step call at 640x384 reads at least the
    call's CUDA-event time; ``profile_trace`` around one call writes a
    Chrome trace that names ``lbm_resident_kernel``;
31. flowviz — ``render_heatmap_png`` of phase 25's card field decodes as a
    PNG; without matplotlib (an optional package) the phase logs
    "skipped: no matplotlib".

Then the native geometry library (``native/fastgeo.cpp``) and the
service's entry point (``api/server.py``):

32. entry — (a) ``g++`` built ``libfastgeo`` in this run from the
    checkout's source into ``airfoil_tpu_torch/_build/``;
    ``rasterize_airfoil`` takes its scanline (``masks.rasteriser()`` is
    ``native``), whose masks equal the numpy scanline's element for
    element at 384x192 and 2048x1024 (5 alphas each), and its parse equals
    the Python parser's on phase 21's 500-file corpus (phase 8 logs both
    rasterisers' times); (b) ``python -m airfoil_tpu_torch.api.server``
    as a child process on a free ``PORT`` with no device named: it logs
    the minihttp transport (no FastAPI), ``/health`` names the card, and
    after its warm-up (the counts set to 0 then) golden (e)'s
    ``/upload_airfoil/`` is held as phase 16 holds it, one more run log
    and count; ``/lbm/start``, 5 ``/lbm/frame`` (one at a new alpha) and
    ``/lbm/stop`` give finite fields equal to the in-process server's bit
    for bit; the requests launched 5 ``lbm_steps``, no tiled kernel, the
    masks' ``cell_word`` and the upload's marches (read from the child);
    the child is then stopped.

Each kernel's bound is the larger of the bytes its call must move (inputs
read once, outputs written once) over the card's memory rate and the
operations of its plain version on the same inputs (pointwise torch
operations times elements, counted by a dispatch mode) over the card's
float32 rate; ``field_b64``'s is its bytes alone (n read, 4 ceil(n / 3)
written) at the 2048x1024 field, its ``plain_ms`` the host path it
replaced, and its ``viewer_*`` keys the same at the viewer's three fields
(``encode_ms``: launch, pinned copy and wait). No single PyTorch call
computes an LBM step, a cell word, a march or a base64, so ``library_ms``
is null. ``ms`` is the CUDA-event time of a
call among back-to-back calls, ``device_ms`` the profiler's device time
of the call's kernels.

The line before last is the card as nvidia-smi names it, the line before
that the kernel table (JSON; the march entries add ``newton_*`` keys: the
Newton path's launches and the kernels at its shapes, and ``polar_*``
keys: the polar's launches, lanes a launch, and the kernels at 64 and 128
lanes with their bounds, and ``parser_*`` keys: the parser benchmark's
launches, lanes a launch, the tripped chunks' largest difference from the
plain march, and the kernels at its shapes with their device time and
bounds; and ``sharded_launches_1_rank`` and ``sharded_launches_4_ranks``:
the launches of every rank of the sharded LBM's runs (LBM kernels) or of
the sharded polar's (march kernels); ``sharded_max_abs_err``: the sharded
lattices' largest difference from the unsharded kernel's;
``entry_launches``: the graft entry's; ``headline_launches``: line 2's
runs (LBM kernels) or the polar line 1 is built from (march kernels);
``server_entry_launches``: phase 32's requests to the server entry);
beside the kernels, ``lm_graphs``: the LM graphs' captures and replays in
the run, phase 20a's keys, pools, iteration and solve times, ``programs``:
every program's captures and replays, ``solver_graphs``: phase 20b's
cases and pools, ``program_graphs``: phase 20c's), and the last line the result (JSON). JAX is never imported, nor anything of
``airfoil_tpu``.
"""

from __future__ import annotations

import base64
import binascii
import contextlib
import csv
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-5, 1e-6
GRIDS = [(128, 32), (384, 192), (640, 384)]   # (nx, ny)
PAST_CAPACITY = (1024, 512)
STEP_COUNTS = (1, 8, 64)
TILED_GRIDS = [(24, 12), (128, 32), (384, 192), (1000, 600), (1002, 600),
               (2048, 1024), (4096, 2048)]
LARGE = (2048, 1024)
SPEED_GRIDS = [(640, 384), (384, 192), (2048, 1024), (4096, 2048)]
N_FRAMES = 20
PROFILE_PAD = 0.25   # seconds of idle time around a profiled region
KERNELS = {   # name: (source, the TPU code it replaces)
    "lbm_steps": ("airfoil_tpu_torch/csrc/lbm_steps.cu",
                  "airfoil_tpu/lbm/kernel.py:55"),     # lbm_steps_pallas
    "cell_word": ("airfoil_tpu_torch/csrc/lbm_steps.cu",
                  "airfoil_tpu/lbm/kernel.py:45"),     # its hoisted rolls
    "lbm_steps_tiled": ("airfoil_tpu_torch/csrc/lbm_steps_tiled.cu",
                        "airfoil_tpu/lbm/kernel.py:144"),
    "bl_march": ("airfoil_tpu_torch/csrc/bl_march.cu",
                 "airfoil_tpu/viscous/march.py:157"),  # march_side's scan
    "bl_march_wake": ("airfoil_tpu_torch/csrc/bl_march.cu",
                      "airfoil_tpu/viscous/march.py:352"),  # march_wake's
    # No TPU kernel: the JAX package base64-encodes a frame's fields on
    # the host.
    "field_b64": ("airfoil_tpu_torch/csrc/field_b64.cu", None),
}
# The served frames' fields a call encodes: the viewer's three 384x192
# fields and the 2048x1024 tunnel's one (float32, row-major (NY, NX)).
B64_FIELDS = {"viewer": [(192, 384)] * 3, "large": [(1024, 2048)]}
# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes
# per second and float32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
POLAR_ALPHAS = tuple(float(a) for a in range(-10, 21))   # 31 points
GOLDENS = os.path.join(ROOT, "tests", "golden", "torch_viscous.json")
NEWTON_GOLDENS = os.path.join(ROOT, "tests", "golden", "torch_newton.json")
N_PANELS = 160
MARCH_RTOL = 1e-4
ENSEMBLE_K = np.arange(-16, 17)
PROFILED_INTERVALS = 4
# (absolute, relative) bar of each viscous output around the golden range.
VISCOUS_BARS = {"cl": (0.025, 0.0), "cd": (0.0, 0.05), "cm": (0.01, 0.0),
                "xtr_upper": (0.05, 0.0), "xtr_lower": (0.05, 0.0)}
FLAT_PLATE = [(1e6, 30.0, 1.0), (1e6, 9.0, 0.05), (6e6, 9.0, 1.0),
              (1e7, 9.0, 1.0), (2e5, 9.0, 1.0)]    # (Re, n_crit, x_trip)
FALKNER_SKAN = [(0.0, 2.591), (-0.05, 2.676), (-0.10, 2.801),
                (-0.14, 2.963)]                    # (beta, H)


def log(msg: str):
    print(msg, flush=True)


def require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def naca4_coords(m=2, p=4, t=12, n=60) -> np.ndarray:
    """NACA 4-digit loop (open trailing edge, cosine spacing, Selig order
    TE -> upper -> LE -> lower -> TE) from the port's ``models.naca4``, the
    formula that made the golden outputs."""
    from airfoil_tpu_torch.models import naca4
    return naca4(m, p, t, n)


def noisy_state(core, cfg, dev, rng) -> torch.Tensor:
    """Freestream equilibrium with a seeded 1% perturbation."""
    f0 = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, dev)
    noise = rng.standard_normal(tuple(f0.shape)).astype(np.float32)
    return (f0 * (1.0 + 0.01 * torch.tensor(noise, device=dev))).contiguous()


def edge_solid(mask: np.ndarray) -> np.ndarray:
    """``mask`` plus solid cells along row 0, row NY-1, column 0 and the
    outlet column, so that edge cells bounce from wrapped neighbours."""
    m = mask.copy()
    m[0, ::3] = 1.0
    m[-1, 1::3] = 1.0
    m[::3, 0] = 1.0
    m[::5, -1] = 1.0
    return m


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, timed
    with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def count_ops(fn, *args, **kwargs) -> int:
    """Operations of ``fn`` on its inputs: the elements written by every
    pointwise torch operation it runs, one operation each."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    total = 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal total
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                total += sum(o.numel() for o in tree_leaves(out)
                             if torch.is_tensor(o))
            return out

    with Count():
        fn(*args, **kwargs)
    return total


def count_dispatches(fn, *args) -> int:
    """Torch operations that ``fn`` dispatches (views included): what the
    host issues, one by one."""
    from torch.utils._python_dispatch import TorchDispatchMode
    total = 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal total
            total += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn(*args)
    return total


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: int, ops: int) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take to move
    ``moved_bytes`` and do ``ops`` float32 operations."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def b64_bound(sizes) -> tuple[float, str]:
    """(ms, "bytes"): the least time the card could take to read fields of
    ``sizes`` bytes once and write their base64 (4 bytes a started 3)."""
    return bound(sum(n + 4 * -(-n // 3) for n in sizes), 0)


def kernel_name(mangled: str) -> str:
    """A mangled kernel name shortened to the function's:
    ``march_side_kernel``."""
    m = re.search(r"[A-Za-z_]+_kernel", mangled)
    return m.group(0) if m else mangled


def ptxas_usage(log_text: str) -> dict:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}} from
    ``nvcc -Xptxas -v`` output (names as ``kernel_name`` gives them)."""
    usage, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
            usage[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage


# ── phases ──────────────────────────────────────────────────────────────────
def phase_build(cuda_build, compile_cache, kernel):
    """The kernel libraries of ``cuda_build.LIBRARIES``, one nvcc each,
    started together (``utils/compile_cache.py``, which raises here what
    ``enable_persistent_compile_cache`` would only log)."""
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    compile_cache._build_libraries()
    log(f"[build] {', '.join(cuda_build.LIBRARIES)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in cuda_build.LIBRARIES:
        path = os.path.join(cuda_build.BUILD_DIR, f"lib{name}.log")
        with open(path) as fh:
            usage = ptxas_usage(fh.read())
        require(usage, f"{name}: ptxas reported no kernel")
        for fn, use in usage.items():
            log(f"[build] {name} ptxas: {fn}: {json.dumps(use)}")
            require(use.get("stack") == 0 and use.get("spill_stores") == 0
                    and use.get("spill_loads") == 0,
                    f"{fn} uses local memory: {use}")
    dev = torch.device("cuda")
    sm_count, smem = kernel.device_limits(dev)
    plan = kernel.resident_plan(192, 384, sm_count, smem)
    log(f"[build] lbm_steps at 384x192 on {sm_count} SMs ({smem} B of "
        f"shared memory a block): {plan.tiles_x}x{plan.tiles_y} blocks of "
        f"{kernel.RESIDENT_THREADS} threads on {plan.tile_w}x{plan.tile_h} "
        f"tiles, {plan.smem_bytes} B of dynamic shared memory a block, "
        f"{plan.exchange_floats * 4} B of exchange surfaces")
    shape = kernel.tiled_shape(dev)
    log(f"[build] lbm_steps_tiled: {shape['tile_x']}x{shape['tile_y']} tiles, "
        f"{shape['steps']} steps per launch, {shape['threads']} threads and "
        f"{shape['smem_bytes']} B of dynamic shared memory a block, "
        f"{shape['blocks_per_sm']} blocks an SM")
    return shape["steps"]


def largest_resident(kernel, dev) -> tuple[int, int]:
    """The largest 2:1 grid (nx, ny), ny a multiple of 8, that ``lbm_steps``
    holds on this card."""
    limits = kernel.device_limits(dev)
    ny = 8
    while not kernel.prefers_tiled(ny + 8, 2 * (ny + 8), *limits):
        ny += 8
    return 2 * ny, ny


@contextlib.contextmanager
def traced():
    """A ``torch.profiler`` trace of the card whose window is padded with
    PROFILE_PAD seconds of idle time on both sides: the profiler drops
    device records that it places (by its CPU-to-device clock alignment,
    which drifts over a long process) outside the window, so the work must
    not sit at its edges."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD)


def kernel_events(prof, *names) -> dict:
    """{name: (device kernels whose name holds it, their device us)} of a
    ``torch.profiler`` run, and under "all" every device kernel."""
    out = {name: [0, 0.0] for name in (*names, "all")}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if us <= 0.0:
            continue
        for name in out:
            if name == "all" or name in e.key:
                out[name][0] += e.count
                out[name][1] += us
    return {k: tuple(v) for k, v in out.items()}


def phase_kernel(dev, kernel, core, masks, cfg_cls):
    """``cell_word`` against the plain word, ``lbm_steps`` against the plain
    torch step; returns the largest abs diff of each (step, word)."""
    rng = np.random.default_rng(0)
    worst = 0.0
    word_worst = 0
    for nx, ny in sorted(set(GRIDS + TILED_GRIDS)):
        cfg = cfg_cls(nx=nx, ny=ny)
        naca = masks.rasterize_airfoil(naca4_coords(), 6.0, cfg)
        for mask in (naca, edge_solid(naca)):
            solid = torch.tensor(mask, device=dev)
            before = kernel.word_launches
            word = kernel.cell_word(solid)
            want = core.cell_word(solid)
            torch.cuda.synchronize()
            require(kernel.word_launches == before + 1,
                    "word launch counter did not advance")
            diff = int((word.to(torch.int32) - want.to(torch.int32)).abs().max())
            word_worst = max(word_worst, diff)
            require(diff == 0, f"cell_word != plain at {nx}x{ny}")
    log(f"[kernel] cell_word = plain word on {len(set(GRIDS + TILED_GRIDS))} "
        f"grids x 2 masks (max abs {word_worst})")
    for nx, ny in GRIDS:
        cfg = cfg_cls(nx=nx, ny=ny)
        solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0, cfg),
                             device=dev)
        word = kernel.cell_word(solid)
        f0 = noisy_state(core, cfg, dev, rng)
        for steps in STEP_COUNTS:
            before = kernel.launches
            got = kernel.lbm_steps(f0, solid, cfg.u0, cfg.tau, steps=steps,
                                   word=word)
            want = core.lbm_step(f0, solid, cfg.u0, cfg.tau, steps=steps)
            torch.cuda.synchronize()
            require(kernel.launches == before + 1,
                    f"launch counter did not advance at {nx}x{ny}")
            diff = (got - want).abs()
            max_abs = float(diff.max())
            max_rel = float((diff / want.abs().clamp(min=1e-30)).max())
            ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
            log(f"[kernel] {nx}x{ny} steps={steps}: max_abs={max_abs:.3e} "
                f"max_rel={max_rel:.3e} {'ok' if ok else 'FAIL'}")
            require(ok, f"kernel != plain at {nx}x{ny}, {steps} steps")
            require(bool(torch.isfinite(got).all()), "non-finite lattice")
            worst = max(worst, max_abs)
    for _ in range(3):     # a trace may drop its one record (see traced)
        with traced() as prof:
            kernel.lbm_steps(f0, solid, cfg.u0, cfg.tau, steps=64, word=word)
        ev = kernel_events(prof, "lbm_resident_kernel")
        log(f"[kernel] one 64-step lbm_steps call at {nx}x{ny}, profiled: "
            f"{ev['all'][0]} device kernels ({ev['lbm_resident_kernel'][0]} "
            f"lbm_resident_kernel, {ev['all'][1]:.2f} us)")
        require(ev["all"][0] == ev["lbm_resident_kernel"][0] <= 1,
                f"a 64-step lbm_steps call ran {ev}")
        if ev["all"][0] == 1:
            break
    require(ev["all"][0] == 1, "no traced call recorded its kernel")
    big = largest_resident(kernel, dev)
    for nx, ny in (PAST_CAPACITY, (big[0] + 16, big[1] + 8)):
        f = core.equilibrium_init(ny, nx, 0.06, dev)
        solid = torch.zeros((ny, nx), device=dev)
        before = (kernel.launches, kernel.word_launches)
        try:
            kernel.lbm_steps(f, solid, 0.06, 0.58, steps=4)
            raised = ""
        except ValueError as e:
            raised = str(e)
        require(raised and (kernel.launches, kernel.word_launches) == before,
                f"lbm_steps at {nx}x{ny} past capacity: {raised or 'ran'}")
        log(f"[kernel] {nx}x{ny} past capacity (largest 2:1 held: "
            f"{big[0]}x{big[1]}): ValueError, no launch: {raised}")
    return worst, float(word_worst)


def phase_tiled(dev, kernel, core, masks, cfg_cls, k):
    """Tiled kernel against the plain step and, where it holds the grid,
    ``lbm_steps``; returns the largest abs diff from the plain step."""
    rng = np.random.default_rng(0)
    limits = kernel.device_limits(dev)
    worst = 0.0
    for nx, ny in TILED_GRIDS:
        cfg = cfg_cls(nx=nx, ny=ny)
        naca = masks.rasterize_airfoil(naca4_coords(), 6.0, cfg)
        f0 = noisy_state(core, cfg, dev, rng)
        resident = not kernel.prefers_tiled(ny, nx, *limits)
        for mask_name, mask in (("naca", naca), ("edge-solid", edge_solid(naca))):
            solid = torch.tensor(mask, device=dev)
            word = kernel.cell_word(solid)
            for steps in (1, 3, k, 2 * k + 1, 64):
                before = kernel.tiled_launches
                got = kernel.lbm_steps_tiled(f0, solid, cfg.u0, cfg.tau,
                                             steps=steps, word=word)
                torch.cuda.synchronize()
                require(kernel.tiled_launches == before + 1,
                        f"tiled launch counter did not advance at {nx}x{ny}")
                want = core.lbm_step(f0, solid, cfg.u0, cfg.tau, steps=steps)
                diff = (got - want).abs()
                max_abs = float(diff.max())
                max_rel = float((diff / want.abs().clamp(min=1e-30)).max())
                ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
                vs_one = 0.0
                if resident:
                    one = kernel.lbm_steps(f0, solid, cfg.u0, cfg.tau,
                                           steps=steps, word=word)
                    vs_one = float((got - one).abs().max())
                log(f"[tiled] {nx}x{ny} {mask_name} steps={steps}: vs plain "
                    f"max_abs={max_abs:.3e} max_rel={max_rel:.3e}; vs "
                    f"lbm_steps "
                    f"{f'max_abs={vs_one:.3e}' if resident else 'past its capacity'}"
                    f" {'ok' if ok and vs_one == 0.0 else 'FAIL'}")
                require(ok, f"tiled != plain at {nx}x{ny}, {steps} steps")
                require(vs_one == 0.0, f"tiled != lbm_steps at {nx}x{ny}, "
                        f"{steps} steps: {vs_one}")
                require(bool(torch.isfinite(got).all()), "non-finite lattice")
                worst = max(worst, max_abs)
    return worst


def _tunnel_run(WindTunnel, dev, alpha, cfg=None, tiled=None):
    kwargs = {} if cfg is None else {"cfg": cfg}
    wt = WindTunnel(naca4_coords(), device=dev, tiled=tiled, **kwargs)
    wt.set_alpha(alpha)
    out = wt.frame(steps=1500)
    fields_ok = all(bool(torch.isfinite(v[wt.state.solid < 0.5]).all())
                    for v in out["fields"].values())
    log(f"[physics] {wt.cfg.nx}x{wt.cfg.ny} alpha={alpha:g} "
        f"{'tiled' if wt.tiled else 'one-step'} kernel, after {out['step']} "
        f"steps: CL={out['cl']!r} CD={out['cd']!r} "
        f"sep={out['separation']:.4f}")
    require(bool(torch.isfinite(wt.state.f).all()) and fields_ok,
            f"non-finite state at alpha={alpha}")
    require(np.isfinite(out["cl"]) and out["cd"] > 0.0,
            f"CD must be positive at alpha={alpha}")
    return wt, out


def phase_physics(dev, WindTunnel):
    cls = [_tunnel_run(WindTunnel, dev, alpha)[1]["cl"]
           for alpha in (0.0, 10.0)]
    require(cls[1] > cls[0], f"CL must grow with alpha: {cls}")


def phase_large(dev, kernel, WindTunnel, cfg_cls):
    """The large-grid tunnel through the library entry point; returns the
    tiled kernel's launches in that run."""
    cfg = cfg_cls(nx=LARGE[0], ny=LARGE[1])
    kernel.launches = 0
    kernel.tiled_launches = 0
    outs = []
    for alpha in (0.0, 10.0):
        wt, out = _tunnel_run(WindTunnel, dev, alpha, cfg)
        require(wt.tiled is True, f"{LARGE} must resolve to the tiled kernel")
        outs.append(out)
    launches, tiled = kernel.launches, kernel.tiled_launches
    log(f"[large] {LARGE[0]}x{LARGE[1]}: {tiled} tiled kernel calls, "
        f"{launches} one-step kernel calls")
    require(tiled == 2 and launches == 0,
            f"large tunnel: {tiled} tiled and {launches} one-step calls")
    require(outs[1]["cl"] > outs[0]["cl"],
            f"CL must grow with alpha: {[o['cl'] for o in outs]}")
    nx, ny = largest_resident(kernel, dev)
    held = cfg_cls(nx=nx, ny=ny)
    wt_r, res = _tunnel_run(WindTunnel, dev, 10.0, held)
    wt_t, til = _tunnel_run(WindTunnel, dev, 10.0, held, tiled=True)
    log(f"[large] {nx}x{ny}, the largest 2:1 grid lbm_steps holds, alpha 10, "
        f"1500 steps: lbm_steps CL={res['cl']!r} CD={res['cd']!r}; "
        f"lbm_steps_tiled CL={til['cl']!r} CD={til['cd']!r}")
    require(not wt_r.tiled and wt_t.tiled and res["cl"] == til["cl"]
            and res["cd"] == til["cd"]
            and torch.equal(wt_r.state.f, wt_t.state.f),
            f"lbm_steps CL/CD {res['cl']}/{res['cd']} != tiled "
            f"{til['cl']}/{til['cd']} at {nx}x{ny}")
    return tiled


def _post(url: str, fields: dict, files=None):
    """multipart/form-data POST; ``files`` maps a field to (filename,
    bytes), or is a list of (field, (filename, bytes)) parts (a field may
    repeat); returns (status, json)."""
    boundary = uuid.uuid4().hex
    parts = []
    for k, v in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"\r\n\r\n{v}\r\n'.encode())
    items = files.items() if isinstance(files, dict) else (files or [])
    for k, (fname, data) in items:
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"; filename="{fname}"\r\n'
                     f'Content-Type: application/octet-stream\r\n\r\n'
                     .encode() + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_server(kernel, field_b64, make_server, parse_upload, build_mask,
                 spf):
    """Drives the served /lbm/* path; returns ({kernel: its launches in the
    run}, median frame ms)."""
    from airfoil_tpu_torch.api import minihttp

    dat = "NACA 2412\n" + "\n".join(f" {x:.6f} {y:.6f}"
                                    for x, y in naca4_coords())
    dat = dat.encode()
    coords, _ = parse_upload("naca2412.dat", dat)
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        log(f"[server] /health: {health}")
        require(health["backend"] == "cuda" and health["accelerator"],
                "/health must report the CUDA device")

        kernel.launches = 0
        kernel.tiled_launches = 0
        kernel.word_launches = 0
        field_b64.launches = 0
        status, meta = _post(url + "/lbm/start", {"alpha": 6.0},
                             {"file": ("naca2412.dat", dat)})
        require(status == 200, f"/lbm/start -> {status} {meta}")
        sent = minihttp.gather_writes
        ny, nx = meta["grid"]
        lat = []
        alpha = 6.0
        for i in range(N_FRAMES):
            form = {"session": meta["session"],
                    "fields": "speed,cp,vorticity"}
            if i == N_FRAMES // 2:
                alpha = 10.0
                form["alpha"] = alpha
            t0 = time.perf_counter()
            status, fr = _post(url + "/lbm/frame", form)
            lat.append((time.perf_counter() - t0) * 1e3)
            require(status == 200, f"/lbm/frame -> {status} {fr}")
            require(fr["alpha"] == alpha, "alpha not applied")
            require(fr["step"] == (i + 1) * spf, f"step {fr['step']}")
            solid = build_mask(coords, alpha)[0].reshape(-1) > 0.5
            require(set(fr["fields"]) == {"speed", "cp", "vorticity"},
                    f"fields {set(fr['fields'])}")
            for name, field in fr["fields"].items():
                a = np.frombuffer(base64.b64decode(field["data"]), np.float32)
                require(a.size == ny * nx, f"{name} size {a.size}")
                require(bool(np.isnan(a[solid]).all()),
                        f"{name}: solid cells must be NaN")
                require(bool(np.isfinite(a[~solid]).all()),
                        f"{name}: fluid cells must be finite")
        launches, tiled = kernel.launches, kernel.tiled_launches
        words, encodes = kernel.word_launches, field_b64.launches
        gathers = minihttp.gather_writes - sent
        # More frames under the profiler, one trace each: the kernels a
        # frame launches. The counter shows one lbm_steps launch a frame; a
        # trace may drop a record, so up to three frames are traced, none
        # may show a tiled or word kernel or more than one resident one,
        # and one must show exactly one.
        for _ in range(3):
            before = (kernel.launches, field_b64.launches,
                      minihttp.gather_writes)
            with traced() as prof:
                status, _ = _post(url + "/lbm/frame",
                                  {"session": meta["session"],
                                   "fields": "speed"})
            require(status == 200 and (kernel.launches, field_b64.launches,
                                       minihttp.gather_writes)
                    == tuple(n + 1 for n in before),
                    f"profiled /lbm/frame -> {status}")
            ev = kernel_events(prof, "lbm_resident_kernel",
                               "lbm_tiled_kernel", "cell_word_kernel",
                               "field_b64_kernel")
            log(f"[server] one profiled frame: {ev['all'][0]} device "
                f"kernels, {ev['all'][1]:.1f} us; lbm_resident_kernel "
                f"{ev['lbm_resident_kernel'][0]} "
                f"({ev['lbm_resident_kernel'][1]:.2f} us), lbm_tiled_kernel "
                f"{ev['lbm_tiled_kernel'][0]}, cell_word_kernel "
                f"{ev['cell_word_kernel'][0]}, field_b64_kernel "
                f"{ev['field_b64_kernel'][0]} "
                f"({ev['field_b64_kernel'][1]:.2f} us)")
            require(ev["lbm_resident_kernel"][0] <= 1
                    and ev["lbm_tiled_kernel"][0] == 0
                    and ev["cell_word_kernel"][0] == 0
                    and ev["field_b64_kernel"][0] <= 1,
                    f"a served frame must launch one LBM kernel, no word "
                    f"kernel and one encode kernel: {ev}")
            if ev["lbm_resident_kernel"][0] == 1:
                break
        require(ev["lbm_resident_kernel"][0] == 1,
                "no traced frame recorded its LBM kernel")
        status, _ = _post(url + "/lbm/stop", {"session": meta["session"]})
        require(status == 200, "/lbm/stop failed")
        status, _ = _post(url + "/lbm/frame", {"session": meta["session"]})
        require(status == 404, f"frame after stop -> {status}, want 404")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    # Words: /lbm/start builds the mask twice (the tunnel's reset, then
    # the handler's set_alpha), the alpha change once more.
    require(launches == N_FRAMES and tiled == 0 and words == 3
            and encodes == N_FRAMES and gathers == N_FRAMES,
            f"{launches} lbm_steps, {tiled} tiled, {words} cell_word and "
            f"{encodes} field_b64 kernel calls and {gathers} gather writes "
            f"for {N_FRAMES} frames and 3 masks")
    med = statistics.median(lat)
    log(f"[server] {N_FRAMES} frames at {nx}x{ny} (alpha 6 -> 10), "
        f"{launches} lbm_steps launches, {words} cell_word launches, "
        f"{encodes} field_b64 launches (3 fields a frame), "
        f"{gathers} gather writes, "
        f"CL={fr['cl']} CD={fr['cd']}, median frame latency {med:.3f} ms "
        f"(HTTP round trip)")
    return {"lbm_steps": launches, "cell_word": words,
            "field_b64": encodes}, med


def device_ms(fn, n: int, name: str) -> float:
    """Device milliseconds per call of ``fn``, which launches one kernel
    whose name holds ``name``: the profiler's mean over the launches it
    recorded of ``n`` calls (it drops some records, up to half of them in
    a long process, and late in one now and then all of a window's: then
    up to two more windows are traced; the mean of those it keeps is the
    time)."""
    fn()
    for _ in range(3):
        with traced() as prof:
            for _ in range(n):
                fn()
                torch.cuda.synchronize()
        count, us = kernel_events(prof, name)[name]
        if count:
            break
    require(1 <= count <= n, f"{count} {name} records of {n} calls")
    return us / count / 1e3


def phase_field_b64(dev, card, field_b64) -> dict:
    """Phase 3b: ``field_b64.b64encode`` on card tensors at the served
    frames' field shapes (``B64_FIELDS``): random float32 payloads with
    NaN, +-inf, -0 and denormals at both ends, one launch a call, each
    string byte for byte ``binascii.b2a_base64`` of the same tensor's
    bytes. Then the launch alone (``ms`` by CUDA events, ``device_ms`` by
    the profiler), the whole encode (launch, pinned copy, wait: host
    wall), the path it replaced (``plain_ms``: a pageable ``.cpu()`` and
    ``binascii`` a field, host wall) and the bytes' bound. Returns {shape
    name: (ms, plain ms, device ms, encode ms, bound)}."""
    g = torch.Generator(device=dev).manual_seed(21)
    specials = torch.tensor([np.nan, np.inf, -np.inf, -0.0, 1e-45, -1e-40,
                             1.1754942e-38, 3.4028235e38], device=dev)
    out = {}
    for name, shapes in B64_FIELDS.items():
        tensors = [torch.randn(s, device=dev, generator=g) * 1e3
                   for s in shapes]
        for t in tensors:
            t.view(-1)[:8] = specials
            t.view(-1)[-8:] = specials
        before = field_b64.launches
        got = field_b64.b64encode(tensors)
        require(field_b64.launches == before + 1,
                f"{name}: {field_b64.launches - before} encode launches")
        want = [binascii.b2a_base64(t.cpu().numpy().view(np.uint8),
                                    newline=False) for t in tensors]
        require([bytes(d) for d in got] == want,
                f"{name}: the card's base64 is not binascii's")

        def old():
            return [binascii.b2a_base64(t.cpu().numpy().view(np.uint8),
                                        newline=False) for t in tensors]

        def wall_ms(fn, n=30):
            fn()
            t = []
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                t.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(t)

        run = lambda: field_b64._encode(tensors)
        ms = cuda_ms(run, 200)
        dms = device_ms(run, 20, "field_b64_kernel")
        torch.cuda.synchronize()
        enc = wall_ms(lambda: field_b64.b64encode(tensors))
        plain = wall_ms(old)
        bnd = b64_bound([t.numel() * 4 for t in tensors])
        log(f"[field_b64] {name}: {len(shapes)} x {shapes[0][1]}x"
            f"{shapes[0][0]} float32 fields in one launch, byte for byte "
            f"binascii's; the launch {ms * 1e3:.2f} us (CUDA events), device "
            f"{dms * 1e3:.2f} us (profiler), bound {bnd[0] * 1e3:.2f} us "
            f"({bnd[1]}); the whole encode {enc:.4f} ms (launch, pinned "
            f"copy, wait); the old path {plain:.4f} ms (pageable copy and "
            f"binascii a field) ({card})")
        out[name] = (ms, plain, dms, enc, bnd)
    return out


def phase_speed(dev, card, kernel, core, diagnostics, masks, cfg_cls,
                bench_mlups):
    """MLUPS, the 4-step call and the frame latency for the kernels and the
    plain step, in the order plain, kernels, kernels, plain; returns
    {kernel name: (ms, plain ms, device ms)} of the 4-step call (the mean of
    its two turns), the resident kernel's at 384x192 and the tiled kernel's
    at 2048x1024, and of ``cell_word`` at 384x192."""
    limits = kernel.device_limits(dev)
    for nx, ny in SPEED_GRIDS:
        big = nx * ny >= LARGE[0] * LARGE[1]
        # The plain step at the large grids takes fewer calls.
        plain = dict(steps_per_call=16, n_calls=2) if big else {}
        runs = [("plain", dict(kernel=False, **plain)),
                ("tiled", dict(kernel=True, tiled=True))]
        if not kernel.prefers_tiled(ny, nx, *limits):
            runs.append(("lbm_steps", dict(kernel=True, tiled=False)))
        runs = runs + runs[::-1]
        rates = {}
        for name, kw in runs:
            r = bench_mlups(nx=nx, ny=ny, device=dev, **kw)
            require(r["finite"] and r["platform"] == "gpu", str(r))
            ms_step = r["seconds"] * 1e3 / r["steps"]
            rates.setdefault(name, []).append(
                f"{r['mlups']:.1f} ({ms_step:.4f} ms/step over "
                f"{r['steps']} steps)")
        log(f"[speed] {nx}x{ny} MLUPS: " + "; ".join(
            f"{name} {', '.join(v)}" for name, v in rates.items())
            + f" ({card})")

    call_ms = {}
    for nx, ny in ((384, 192), LARGE):
        cfg = cfg_cls(nx=nx, ny=ny)
        solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0,
                                                     cfg), device=dev)
        word = kernel.cell_word(solid)
        f = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, dev)
        spf = cfg.steps_per_frame
        steppers = {"plain": core.lbm_step,
                    "tiled": lambda *a, **k: kernel.lbm_steps_tiled(
                        *a, word=word, **k)}
        if not kernel.prefers_tiled(ny, nx, *limits):
            steppers["lbm_steps"] = lambda *a, **k: kernel.lbm_steps(
                *a, word=word, **k)
        order = list(steppers)
        for name in order + order[::-1]:
            step = steppers[name]
            n = 50 if name == "plain" else 200
            run = lambda: step(f, solid, cfg.u0, cfg.tau, steps=spf)
            ms = cuda_ms(run, n)
            kern = {"tiled": "lbm_tiled_kernel",
                    "lbm_steps": "lbm_resident_kernel"}.get(name)
            dms = device_ms(run, 20, kern) if kern else float("nan")
            call_ms.setdefault((nx, ny, name), []).append((ms, dms))
            log(f"[speed] {nx}x{ny}, one {spf}-step call, {name}: {ms:.4f} ms "
                f"(CUDA events, back-to-back calls), device time "
                f"{dms * 1e3:.2f} us (profiler) ({card})")

        def frame(step):
            def run():
                g = step(f, solid, cfg.u0, cfg.tau, steps=spf)
                cl, cd, sep = diagnostics.forces_and_separation(
                    g, solid, cfg.u0, cfg.chord_cells)
                torch.stack([cl, cd, sep]).tolist()
                diagnostics.render_fields(g, solid, cfg.u0)[0].cpu()
            return run

        for name in order + order[::-1]:
            run = frame(steppers[name])
            run()
            t = []
            for _ in range(30):
                t0 = time.perf_counter()
                run()
                t.append((time.perf_counter() - t0) * 1e3)
            log(f"[speed] {nx}x{ny} frame (step + forces + one field to "
                f"host), {name}: median {statistics.median(t):.3f} ms "
                f"({card})")

    solid = torch.tensor(masks.rasterize_airfoil(
        naca4_coords(), 6.0, cfg_cls()), device=dev)
    word_ms = cuda_ms(lambda: kernel.cell_word(solid), 200)
    word_dev = device_ms(lambda: kernel.cell_word(solid), 20,
                         "cell_word_kernel")
    word_plain = cuda_ms(lambda: core.cell_word(solid), 50)
    log(f"[speed] 384x192 cell word: cell_word {word_ms:.4f} ms (CUDA events), "
        f"device {word_dev * 1e3:.2f} us; plain {word_plain:.4f} ms ({card})")
    mean = {key: tuple(statistics.fmean(r) for r in zip(*v))
            for key, v in call_ms.items()}
    return {"lbm_steps": (mean[(384, 192, "lbm_steps")][0],
                          mean[(384, 192, "plain")][0],
                          mean[(384, 192, "lbm_steps")][1]),
            "lbm_steps_tiled": (mean[LARGE + ("tiled",)][0],
                                mean[LARGE + ("plain",)][0],
                                mean[LARGE + ("tiled",)][1]),
            "cell_word": (word_ms, word_plain, word_dev)}


# ── the XFOIL-replacement path ──────────────────────────────────────────────
def load_goldens(path: str = GOLDENS) -> dict:
    with open(path) as fh:
        return json.load(fh)


def naca_operator(code: str, dev, paneling, inviscid):
    """The port's operator for a NACA 4-digit section at ``N_PANELS``,
    from the geometry the goldens were made from."""
    coords = naca4_coords(int(code[0]), int(code[1]), int(code[2:]), 100)
    xp, yp = paneling.repanel(coords, N_PANELS, device=dev)
    return inviscid.build_operator(paneling.panel_geometry(xp, yp))


def phase_inviscid(goldens, ops, inviscid):
    worst = 0.0
    for g in goldens["inviscid"]:
        sol = inviscid.solve_inviscid(ops[g["naca"]], g["alpha"])
        cl, cm = float(sol.cl), float(sol.cm)
        dcl, dcm = abs(cl - g["cl"]), abs(cm - g["cm"])
        ok = (dcl <= 1e-4 * abs(g["cl"]) + 1e-5
              and dcm <= 1e-4 * abs(g["cm"]) + 1e-5)
        log(f"[inviscid] NACA {g['naca']} alpha={g['alpha']:g}: CL={cl!r} "
            f"(golden {g['cl']!r}, diff {dcl:.3e}) Cm={cm!r} (golden "
            f"{g['cm']!r}, diff {dcm:.3e}) {'ok' if ok else 'FAIL'}")
        require(ok, f"inviscid NACA {g['naca']} alpha {g['alpha']}")
        worst = max(worst, dcl, dcm)
    return worst


def _close(a, b, nan_equal: bool = False) -> torch.Tensor:
    """``a`` within MARCH_RTOL of ``b``, elementwise; with ``nan_equal`` a
    NaN in both also agrees (a lane broken in both marches)."""
    ok = (a - b).abs() <= MARCH_RTOL * b.abs()
    return ok | (a.isnan() & b.isnan()) if nan_equal else ok


def _hold_march(got, want, name: str, stop=None,
                nan_equal: bool = False) -> float:
    """Kernel march ``got`` against plain march ``want`` ((L, M) fields),
    lane by lane on stations [0, stop[lane]) (NaN in both agreeing with
    ``nan_equal``); returns the largest abs difference."""
    lanes, m = want.theta.shape
    worst = 0.0
    for lane in range(lanes):
        k = m if stop is None else stop[lane]
        if k == 0:
            continue
        for f in ("theta", "dstar", "hk", "cf"):
            a = getattr(got, f)[lane, :k]
            b = getattr(want, f)[lane, :k]
            d = (a - b).abs()
            worst = max(worst, float(d.nan_to_num(0.0).max()))
            rel = d / b.abs()
            at = int(rel.nan_to_num(0.0).argmax())
            require(bool(_close(a, b, nan_equal).all()),
                    f"{name} lane {lane} {f}: max rel {float(rel.max()):.3e} "
                    f"at station {at} of {k} (kernel {float(a[at])!r}, plain "
                    f"{float(b[at])!r})")
        for f in ("turb", "separated"):
            require(torch.equal(getattr(got, f)[lane, :k],
                                getattr(want, f)[lane, :k]),
                    f"{name} lane {lane}: {f} flags differ")
    return worst


def ensemble_stop(ens: dict, fields=("theta", "dstar", "turb", "separated"),
                  rtol: float = MARCH_RTOL, nan_equal: bool = False) -> int:
    """First station at which a march's rounding ensemble spreads.

    ``ens`` maps each of ``fields`` to a (K, M) array (numpy or torch) of
    one lane's K ensemble members, the nominal member in row K // 2. A
    station spreads where a float field leaves ``rtol`` of the nominal
    member's or a flag differs from it (with ``nan_equal``, also where a
    member is NaN and the nominal one is not, or the other way round);
    returns M if none does.
    """
    spread = None
    for f in fields:
        v = ens[f]
        c = v[v.shape[0] // 2]
        flag = str(v.dtype) in ("bool", "torch.bool")
        out = v != c if flag else abs(v - c) > rtol * abs(c)
        if nan_equal and not flag:
            out = out | (v.isnan() != c.isnan())
        out = np.asarray(out.tolist()).any(0)
        spread = out if spread is None else spread | out
    return int(np.argmax(spread)) if spread.any() else len(spread)


@contextlib.contextmanager
def eager_programs():
    """The solver's programs (``viscous.graphs.run``: the direct solve, the
    Newton set-up, round and answer) run as their eager bodies on the
    card: every Python call in them runs, as a graph's replay does not.
    The LM iteration stays graphed (it makes no march)."""
    from airfoil_tpu_torch.viscous import graphs
    orig = graphs.run
    graphs.run = lambda program, key, body, flat: body(flat)
    try:
        yield
    finally:
        graphs.run = orig


@contextlib.contextmanager
def recording(mk):
    """Records (a copy of) the arguments of every ``march_side`` and
    ``march_wake`` call that reaches the kernel module ``mk``; the
    solver's programs run eagerly meanwhile (``eager_programs``), since a
    graph's replay calls no Python wrapper."""
    calls = {"march_side": [], "march_wake": []}
    originals = {name: getattr(mk, name) for name in calls}

    def wrap(name):
        def run(*args):
            calls[name].append([a.clone() if torch.is_tensor(a) else a
                                for a in args])
            return originals[name](*args)
        return run

    for name in calls:
        setattr(mk, name, wrap(name))
    try:
        with eager_programs():
            yield calls
    finally:
        for name, fn in originals.items():
            setattr(mk, name, fn)


def _stack_calls(calls, n_arrays: int) -> list:
    """Recorded march calls as the lanes of one call: their first
    ``n_arrays`` arguments ((L, M) or (M,)) stacked, the rest (numbers or
    0-d tensors, one per call) as per-lane tensors."""
    arrays = [torch.cat([c[i].reshape(-1, c[i].shape[-1]) for c in calls])
              for i in range(n_arrays)]
    params = []
    for i in range(n_arrays, len(calls[0])):
        params.append(torch.cat([
            torch.as_tensor(c[i], dtype=torch.float32, device=c[0].device)
            .expand(c[0].reshape(-1, c[0].shape[-1]).shape[0])
            for c in calls]))
    return [a.contiguous() for a in arrays + params]


def _rows(bl, rows):
    return type(bl)(*(a[rows] for a in bl))


def _same_bits(xs, ys) -> bool:
    """Equal bit for bit (NaNs included), tensor by tensor."""
    bits = lambda a: a.view(torch.int32) if a.dtype == torch.float32 else a
    return all(torch.equal(bits(a), bits(b)) for a, b in zip(xs, ys))


def _flat_plate_lanes(dev):
    n = len(FLAT_PLATE)
    s = torch.linspace(0.004, 1.0, 120, device=dev).expand(n, -1).contiguous()
    re, n_crit, x_trip = (torch.tensor(c, device=dev)
                          for c in zip(*FLAT_PLATE))
    return s, torch.ones_like(s), s, 1.0 / re, n_crit, x_trip


def _airfoil_sides(op, coupled, inviscid, alphas=(0.0, 5.0)):
    """The section's two sides at each of ``alphas`` from the port's own
    inviscid solve on the card: (s, ue, x) of 2 x len(alphas) lanes of 80
    stations, upper then lower."""
    pan = op.pan
    s_mid = 0.5 * (pan.s[:-1] + pan.s[1:])
    s_le = pan.s[torch.argmin(pan.xp)]
    rows = []
    for alpha in alphas:
        vt = inviscid.solve_inviscid(op, alpha).vt
        s0 = coupled._find_stagnation(s_mid, vt, s_le)
        for upper in (True, False):
            xi, _, ue, x, _ = coupled._side_stations(pan, vt, s0, upper, 80)
            rows.append((xi, ue, x))
    return [torch.stack(c).contiguous() for c in zip(*rows)]


def phase_march(dev, mk, plain, coupled, inviscid, op, trip_x):
    """The march kernel against the plain march, on made-up lanes, on the
    NACA 2412 sides and on the inputs the main path gives it; then the
    physics anchors on the kernel alone. Returns ({kernel: largest abs
    difference}, the free airfoil sides, the batch of 1,914 side lanes)."""
    before, before_w = mk.march_launches, mk.wake_launches
    args = _flat_plate_lanes(dev)
    t0 = time.perf_counter()
    want = plain.march_side(*args)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    got = mk.march_side(*args)
    torch.cuda.synchronize()
    worst = _hold_march(got, want, "flat plate")
    require(torch.equal(got.x_transition, want.x_transition),
            f"flat plate x_transition {got.x_transition.tolist()} != "
            f"{want.x_transition.tolist()}")
    log(f"[march] flat plate, 5 lanes x 120 stations: kernel = plain "
        f"(rtol {MARCH_RTOL}, flags and x_transition identical), max abs "
        f"{worst:.3e}; x_tr {got.x_transition.tolist()}; plain call "
        f"{t_plain:.2f} s")

    # The main path's own inputs: every march call of a default solve
    # tripped at trip_x and of a free one, as they reached the kernel;
    # with them, as two more calls of 4 lanes, the NACA 2412 sides at alpha
    # 0 and 5 tripped at trip_x and free. The tripped solve's side marches
    # and the tripped sides are strict (no laminar knife edge; a main-path
    # lane's last station may leave the Newton unconverged where ue falls
    # steeply into the trailing edge), the free sides are held up to where
    # the plain march's own ensemble spreads.
    with recording(mk) as calls:
        coupled.solve_viscous(op, 5.0, 1e6, x_forced_transition=trip_x)
        n_trip = len(calls["march_side"])
        n_trip_w = len(calls["march_wake"])
        coupled.solve_viscous(op, 5.0, 1e6)
    sides = _airfoil_sides(op, coupled, inviscid)
    full = lambda v: torch.full((sides[0].shape[0],), v, device=dev)
    naca = lambda xf: [*sides, full(1e-6), full(9.0), full(xf)]
    held, batch = hold_recorded_marches(
        dev, mk, plain,
        [naca(trip_x)] + calls["march_side"][:n_trip] + [naca(1.0)],
        calls["march_wake"], 1 + n_trip, n_trip_w,
        f"NACA 2412 sides tripped at {trip_x}, the tripped default "
        f"solve_viscous's side marches, the free sides; both solves' wakes",
        te_tail=1, stage="march")
    worst = max(worst, held["bl_march"])
    worst_w = held["bl_march_wake"]

    # Physics anchors (tests/test_viscous.py:24-116) on the kernel alone.
    fp = mk.march_side(*args)
    theta_exact = 0.664 / np.sqrt(1e6)
    require(abs(float(fp.theta[0, -1]) - theta_exact) / theta_exact < 0.02
            and abs(float(fp.hk[0, -1]) - 2.59) < 0.02, "Blasius anchor")
    require(0.0028 < float(fp.cf[1, -1]) < 0.0046
            and 1.25 < float(fp.hk[1, -1]) < 1.55, "tripped plate anchor")
    for lane, re in ((2, 6e6), (3, 1e7)):
        require(2.5e6 < re * float(fp.x_transition[lane]) < 3.6e6,
                f"transition Re_x at Re {re:g}")
    require(float(fp.x_transition[4]) >= 0.99, "no transition at Re 2e5")
    sw = torch.linspace(0.01, 1.0, 40, device=dev)
    got_w = mk.march_wake(sw, torch.full_like(sw, 0.9), 1e-6, 0.004, 0.008,
                          0.002)
    xf = torch.linspace(1e-3, 1.0, 256, device=dev)
    ue_fs = torch.stack([xf ** (b / (2.0 - b)) for b, _ in FALKNER_SKAN])
    fs = mk.march_side(xf.expand(len(FALKNER_SKAN), -1).contiguous(), ue_fs,
                       xf.expand(len(FALKNER_SKAN), -1).contiguous(),
                       1.0 / 5e5, 1e9, 2.0)
    hk_fs = (fs.dstar / fs.theta.clamp(min=1e-12))[:, 256 // 3: 2 * 256 // 3]
    for i, (beta, h_ref) in enumerate(FALKNER_SKAN):
        h = float(hk_fs[i].median())
        require(abs(h - h_ref) / h_ref < 0.01, f"Falkner-Skan beta {beta}")
    require(abs(float(got_w[0][-1]) - 0.004) <= 1e-3 * 0.004
            and float(got_w[2][-1]) < 1.3, "wake anchor")
    log(f"[march] physics on the kernel: Blasius theta "
        f"{float(fp.theta[0, -1]):.6e} (exact {theta_exact:.6e}), Re_x_tr "
        f"{6e6 * float(fp.x_transition[2]):.4g} and "
        f"{1e7 * float(fp.x_transition[3]):.4g}, Falkner-Skan H "
        f"{[round(float(h.median()), 4) for h in hk_fs]}, wake theta "
        f"{float(got_w[0][-1]):.6e}")
    require(mk.march_launches > before and mk.wake_launches > before_w,
            "march launch counters did not move")
    return {"bl_march": worst, "bl_march_wake": worst_w}, sides, batch


def held_to_members(rec: dict, golden: dict, bars=None) -> list:
    """What fails when ``rec`` is held to a Newton golden point: its
    ``converged`` must be one of the rounding ensemble's, and each barred
    field must lie within its bar of the range over the ensemble members
    that share that ``converged`` (a member off in another basin widens
    the range of only its own verdict)."""
    bars = VISCOUS_BARS if bars is None else bars
    members = [m for m in golden["members"]
               if m["converged"] == rec["converged"]]
    if not members:
        return [f"converged {rec['converged']} not among the ensemble's "
                f"{golden['ensemble']['converged']}"]
    fails = []
    for f, (abs_bar, rel_bar) in bars.items():
        lo = min(m[f] for m in members)
        hi = max(m[f] for m in members)
        if not (lo - abs_bar - rel_bar * abs(lo) <= rec[f]
                <= hi + abs_bar + rel_bar * abs(hi)):
            fails.append(f"{f} {rec[f]!r} outside [{lo}, {hi}] +- bar")
    return fails


def merged_record(out) -> dict:
    """A polar-point answer ((cl, cd, cdp, cm, converged, xtr_u, xtr_l,
    sep), (newton_converged, state)) as the golden record's fields."""
    merged, (nok, _state) = out
    names = ("cl", "cd", "cdp", "cm", "converged", "xtr_upper", "xtr_lower",
             "sep_fraction")
    rec = {f: (bool(v) if f == "converged" else float(v))
           for f, v in zip(names, merged)}
    rec["newton_converged"] = bool(nok)
    return rec


def _viscous_record(r) -> dict:
    return {"cl": float(r.cl), "cd": float(r.cd), "cdp": float(r.cdp),
            "cm": float(r.cm), "converged": bool(r.converged),
            "xtr_upper": float(r.upper.x_transition),
            "xtr_lower": float(r.lower.x_transition),
            "sep_fraction": float(r.sep_fraction)}


def phase_viscous(goldens, ops, coupled, mk):
    """The main path of this slice: default ``solve_viscous`` at the golden
    points, free and tripped; returns ({(section, alpha): free result},
    {kernel: its launches in the run})."""
    mk.march_launches = 0
    mk.wake_launches = 0
    results = {}
    points = [(g, {}, g["ensemble"]) for g in goldens["viscous"]]
    # Tripped near the leading edge the reference is no knife edge: held
    # to its nominal run, ``converged`` equal.
    points += [(g, {"x_forced_transition": goldens["trip_x"]},
                {**{f: [g[f], g[f]] for f in VISCOUS_BARS},
                 "converged": [g["converged"]]})
               for g in goldens["tripped"]]
    for g, kw, ens in points:
        before = mk.march_launches, mk.wake_launches
        t0 = time.perf_counter()
        r = coupled.solve_viscous(ops[g["naca"]], g["alpha"], g["re"], **kw)
        rec = _viscous_record(r)
        secs = time.perf_counter() - t0
        if not kw:
            results[g["naca"], g["alpha"]] = r
        n_side = mk.march_launches - before[0]
        n_wake = mk.wake_launches - before[1]
        n = n_side + n_wake
        fails = []
        for f, (abs_bar, rel_bar) in VISCOUS_BARS.items():
            lo, hi = ens[f]
            if not (lo - abs_bar - rel_bar * abs(lo) <= rec[f]
                    <= hi + abs_bar + rel_bar * abs(hi)):
                fails.append(f"{f} {rec[f]!r} outside [{lo}, {hi}]")
        if rec["converged"] not in ens["converged"]:
            fails.append(f"converged {rec['converged']}")
        if g["alpha"] >= 16.0 and rec["converged"]:
            fails.append("alpha 16 converged")
        trip = f", tripped at {kw['x_forced_transition']}" if kw else ""
        log(f"[viscous] NACA {g['naca']} alpha={g['alpha']:g} Re={g['re']:g}"
            f"{trip}: {json.dumps(rec)}; golden "
            f"{json.dumps({f: g[f] for f in rec})}; held to "
            f"{json.dumps(ens)}; {n} march launches, {secs:.3f} s "
            f"{'ok' if not fails else 'FAIL ' + str(fails)}")
        require(not fails, f"viscous NACA {g['naca']} alpha {g['alpha']}"
                f"{trip}: {fails}")
        require(n_side == 25 and n_wake == 25,
                f"{n_side} side and {n_wake} wake march launches, want "
                f"24 + 1 each")
    return results, {"bl_march": mk.march_launches,
                     "bl_march_wake": mk.wake_launches}


def phase_viscous_anchors(results, ops, coupled, inviscid, mk):
    """The slow-tier anchors of ``tests/test_viscous.py:131-196`` on the
    card, from the viscous phase's solves and three more (Re trend,
    forced transition)."""
    r0, r5 = results["2412", 0.0], results["2412", 5.0]
    z, p, m = (results["0012", a] for a in (0.0, 4.0, -4.0))
    f = float
    require(bool(r0.converged) and abs(f(r0.cl) - 0.24) < 0.04
            and 0.0050 < f(r0.cd) < 0.0080
            and 0.45 < f(r0.upper.x_transition) < 0.75, "2412 alpha 0 anchor")
    require(abs(f(r5.cl) - 0.755) < 0.08 and 0.0050 < f(r5.cd) < 0.0105
            and 0.15 < f(r5.upper.x_transition) < 0.45, "2412 alpha 5 anchor")
    cl_inv = f(inviscid.solve_inviscid(ops["2412"], 5.0).cl)
    require(f(r5.cl) < cl_inv, "viscous CL must be below inviscid")
    require(abs(f(p.cl) + f(m.cl)) < 0.03 and abs(f(z.cl)) < 0.01
            and 0.0045 < f(z.cd) < 0.0080, "symmetric 0012 anchor")
    require(not bool(results["0012", 16.0].converged),
            "0012 alpha 16 must not converge")
    for side in (r5.upper, r5.lower):
        require(bool((side.theta > 0).all())
                and bool((side.dstar >= side.theta * 0.99).all()),
                "2412 alpha 5 boundary-layer sanity")
    require(f(r5.upper.x_transition) < f(r5.lower.x_transition),
            "upper transition must lead at alpha 5")
    before = mk.march_launches + mk.wake_launches
    cd_lo = f(coupled.solve_viscous(ops["0012"], 0.0, 5e5).cd)
    cd_hi = f(coupled.solve_viscous(ops["0012"], 0.0, 5e6).cd)
    trip = coupled.solve_viscous(ops["0012"], 0.0, 1e6,
                                 x_forced_transition=0.1)
    n = mk.march_launches + mk.wake_launches - before
    require(n == 150, f"{n} march launches for 3 solves")
    require(cd_hi < cd_lo, f"CD must fall with Re: {cd_lo} -> {cd_hi}")
    require(f(trip.upper.x_transition) < 0.2 and f(trip.cd) > f(z.cd),
            "forced transition anchor")
    log(f"[viscous] slow-tier anchors hold: 2412 CL {f(r0.cl):.4f} / "
        f"{f(r5.cl):.4f} (inviscid {cl_inv:.4f} at alpha 5), 0012 CL(+4) + "
        f"CL(-4) {f(p.cl) + f(m.cl):.2e}, CD(Re 5e5) {cd_lo:.5f} > "
        f"CD(5e6) {cd_hi:.5f}, tripped at 0.1: x_tr "
        f"{f(trip.upper.x_transition):.4f}, CD {f(trip.cd):.5f} > "
        f"{f(z.cd):.5f}")


def _median_s(fn, n: int = 10) -> float:
    t = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    return statistics.median(t)


def side_march_bound(mk, plain, args) -> tuple:
    """((ms, what bounds it), operations) of one side march call ``args``
    (s, ue, x, then nu and the other per-lane parameters): its arrays and
    three per-lane parameters read once and its outputs written once; the
    operations of the plain march, which does the same at every interval,
    counted over PROFILED_INTERVALS of them and scaled to the call's."""
    s, ue, x, *params = args
    out = mk.march_side(*args)
    n_lanes, m = s.shape
    cut = [a[..., :PROFILED_INTERVALS + 1].contiguous() for a in (s, ue, x)]
    ops = count_ops(plain.march_side, *cut, *params) \
        * (m - 1) / PROFILED_INTERVALS
    return bound(nbytes(s, ue, x, *out) + 3 * 4 * n_lanes, ops), ops


def wake_march_bound(mk, plain, w) -> tuple:
    """As ``side_march_bound``, for one wake march call ``w`` (s, ue, nu,
    theta0, dstar0, ctau0): its four per-lane parameters read once."""
    mw = w[0].shape[-1]
    out = mk.march_wake(*w)
    cut = [w[0][..., :PROFILED_INTERVALS + 1],
           w[1][..., :PROFILED_INTERVALS + 1], *w[2:]]
    ops = count_ops(plain.march_wake, *cut) * (mw - 1) / PROFILED_INTERVALS
    lanes = w[0].reshape(-1, mw).shape[0]
    return bound(nbytes(*w[:2], *out) + 4 * 4 * lanes, ops), ops


def phase_viscous_speed(card, ops, inviscid, coupled, wake, mk, plain, sides,
                        batch):
    """Default solve and its split; one side-pair march at 80 stations and
    one 24-station wake march with the kernels and the plain march; the
    side kernel at 1, 2, 62 and 1,914 lanes. Returns ({kernel: (kernel ms,
    plain ms, device ms), each at its main-path shape}, {kernel: (bound ms,
    what bounds it)})."""
    op = ops["2412"]
    pan = op.pan
    coupled.solve_viscous(op, 5.0, 1e6)            # warm
    t_op = _median_s(lambda: inviscid.build_operator(pan))
    t_wake = _median_s(lambda: wake.build_wake_operator(op, 5.0, n_wake=24))
    t_solve = _median_s(lambda: coupled.solve_viscous(op, 5.0, 1e6))
    t_one = _median_s(lambda: coupled.solve_viscous(op, 5.0, 1e6,
                                                    coupling_iters=1))
    t_pass = (t_solve - t_one) / 23.0
    log(f"[viscous speed] NACA 2412 alpha 5 Re 1e6, default solve_viscous "
        f"(160 panels, 80/24/24), median of 10, synchronised: "
        f"{t_solve * 1e3:.3f} ms; build_operator {t_op * 1e3:.3f} ms; "
        f"build_wake_operator {t_wake * 1e3:.3f} ms; one coupling pass "
        f"{t_pass * 1e3:.3f} ms (from the 24- and 1-pass solves, "
        f"{t_one * 1e3:.3f} ms) ({card})")

    with traced() as prof:
        coupled.solve_viscous(op, 5.0, 1e6)
    events = prof.key_averages()
    dev_us = {"march_side": 0.0, "march_wake": 0.0, "all": 0.0}
    for e in events:
        us = getattr(e, "device_time_total", 0.0)
        dev_us["all"] += us
        for name in ("march_side", "march_wake"):
            if f"{name}_kernel" in e.key:
                dev_us[name] += us
    log(f"[viscous speed] profiled default solve: "
        f"{sum(e.count for e in events)} device operations, "
        f"{dev_us['all'] / 1e3:.3f} ms of device time, of which "
        f"march_side_kernel {dev_us['march_side'] / 1e3:.3f} ms and "
        f"march_wake_kernel {dev_us['march_wake'] / 1e3:.3f} ms; device "
        f"busy {dev_us['all'] / 1e3 / (t_solve * 1e3):.1%} of the median "
        f"solve's wall time ({card})")

    s, ue, x = (a[2:].contiguous() for a in sides)    # alpha 5 side pair
    k_ms = cuda_ms(lambda: mk.march_side(s, ue, x, 1e-6), 50)
    k_dev = device_ms(lambda: mk.march_side(s, ue, x, 1e-6), 20,
                      "march_side_kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.march_side(s, ue, x, 1e-6)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # The plain march issues the same operations at every station, so the
    # profiler traces its first PROFILED_INTERVALS intervals only (a whole
    # call is ~2 M device operations).
    cut = [a[:, :PROFILED_INTERVALS + 1].contiguous() for a in (s, ue, x)]
    t0 = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        plain.march_side(*cut, 1e-6)
        torch.cuda.synchronize()
    events = prof.key_averages()
    n_dev = sum(e.count for e in events)
    dev_us = sum(getattr(e, "device_time_total", 0.0) for e in events)
    per = n_dev / PROFILED_INTERVALS
    log(f"[viscous speed] one side-pair march, 2 lanes x 80 stations: "
        f"kernel {k_ms:.4f} ms (CUDA events, mean of 50; device "
        f"{k_dev:.4f} ms); plain {plain_ms:.1f}"
        f" ms (one call, host clock, synchronised); profiled plain march of "
        f"{PROFILED_INTERVALS} intervals: {n_dev} device operations "
        f"({per:.0f} a station interval, so {per * 79:.0f} for the 79 of the "
        f"call), {dev_us / 1e3:.2f} ms of device time; profiling took "
        f"{time.perf_counter() - t0:.1f} s ({card})")

    # The side kernel's time against its lane count: one block per lane, so
    # lanes run side by side until they share the SMs' issue slots.
    polar = _airfoil_sides(op, coupled, inviscid, POLAR_ALPHAS)
    cases = {"upper side (1 lane)": [a[2:3] for a in sides] + [1e-6],
             "lower side (1 lane)": [a[3:4] for a in sides] + [1e-6],
             "side pair (2 lanes)": [s, ue, x, 1e-6],
             f"{len(POLAR_ALPHAS)}-point polar's sides "
             f"({2 * len(POLAR_ALPHAS)} lanes)": polar + [1e-6],
             f"march phase batch ({batch[0].shape[0]} lanes)": batch}
    lane_ms = {}
    for name, args in cases.items():
        args = [a.contiguous() if torch.is_tensor(a) else a for a in args]
        lane_ms[name] = cuda_ms(lambda: mk.march_side(*args), 50)
    log(f"[viscous speed] march_side_kernel at 80 stations (CUDA events, mean "
        f"of 50): " + "; ".join(f"{n} {t:.4f} ms" for n, t in lane_ms.items())
        + f"; {2 * len(POLAR_ALPHAS)} lanes / 2 lanes "
        f"{list(lane_ms.values())[3] / k_ms:.3f} ({card})")

    # The wake march of the default solve's last pass.
    with recording(mk) as calls:
        coupled.solve_viscous(op, 5.0, 1e6)
    w = calls["march_wake"][-1]
    w_ms = cuda_ms(lambda: mk.march_wake(*w), 50)
    w_dev = device_ms(lambda: mk.march_wake(*w), 20, "march_wake_kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.march_wake(*w)
    torch.cuda.synchronize()
    w_plain_ms = (time.perf_counter() - t0) * 1e3
    mw = w[0].shape[-1]
    log(f"[viscous speed] one wake march, 1 lane x {mw} stations: kernel "
        f"{w_ms:.4f} ms (CUDA events, mean of 50; device {w_dev:.4f} ms); "
        f"plain {w_plain_ms:.1f} ms "
        f"(one call, host clock) ({card})")

    side_bound, side_ops = side_march_bound(mk, plain, [s, ue, x, 1e-6])
    wake_bound, wake_ops = wake_march_bound(mk, plain, w)
    log(f"[viscous speed] bounds: side pair {side_bound[0] * 1e3:.3f} us "
        f"({side_ops:.4g} operations), wake {wake_bound[0] * 1e3:.3f} us "
        f"({wake_ops:.4g} operations), set by {side_bound[1]} and "
        f"{wake_bound[1]}")
    return ({"bl_march": (k_ms, plain_ms, k_dev),
             "bl_march_wake": (w_ms, w_plain_ms, w_dev)},
            {"bl_march": side_bound, "bl_march_wake": wake_bound})


# ── the simultaneous-Newton path ────────────────────────────────────────────
NEWTON_POINT = ("2412", 4.0, 1e6)          # the speed phase's point
SOLVE_REPEATS = 5   # default Newton solves timed in the speed phase
TE_TAIL = 5     # trailing-edge stations where a tripped march may spread
# The fields a march lane is held on: a station is held while the plain
# march's rounding ensemble stays within MARCH_RTOL in each of them (cf
# nears zero at separation, where only the ensemble tells rounding from
# error).
HELD_FIELDS = ("theta", "dstar", "hk", "cf", "turb", "separated")
# solve_viscous_newton's defaults: stations a side, wake stations, warm
# passes, LM iterations a round.
NEWTON_SHAPE = {"n_stations": 96, "n_wake": 20, "warm_iters": 8,
                "newton_iters": 12}


def hold_recorded_marches(dev, mk, plain, side_calls, wake_calls,
                          n_strict_sides, n_strict_wakes, label,
                          te_tail=TE_TAIL, stage="newton march",
                          xtr_between=False, nan_equal=False):
    """The march kernels against the plain march on recorded main-path
    calls: all side calls as the lanes of one batch, all wake calls as
    those of another, each lane with the plain march's rounding ensemble
    (ue scaled by 1 + k 2^-23). A lane is held (rtol MARCH_RTOL, flags
    identical) up to the first station where its ensemble spreads, and its
    x_transition must be one of the ensemble's (with ``xtr_between``, where
    the ensemble's takes several values, anywhere between the least and
    the greatest of them: a free lane at a laminar knife edge, whose
    rounding moves transition by stations); the lanes of the first
    ``n_strict_sides`` side calls (tripped: no laminar knife edge) must
    have one x_transition over the ensemble and may spread only in their
    last ``te_tail`` stations, where ue falls steeply into the trailing
    edge, those of the first ``n_strict_wakes`` wake calls not at all.
    With ``nan_equal`` (lanes of broken geometries) a NaN agrees with a
    NaN: in a station, in x_transition, and between ensemble members.
    Each call is also launched at its own shape and must equal its lanes
    of the batch bit for bit. Returns ({kernel: largest abs difference},
    the batch of side lanes)."""
    k = len(ENSEMBLE_K)
    scale = (1.0 + torch.tensor(ENSEMBLE_K, dtype=torch.float64)
             * 2.0 ** -23).float().to(dev)

    def ensemble(lanes):
        n = lanes[0].shape[0]
        batch = [a.repeat_interleave(k, 0) for a in lanes]
        batch[1] = batch[1] * scale.repeat(n)[:, None]
        return [a.contiguous() for a in batch], n

    batch, n_l = ensemble(_stack_calls(side_calls, 3))
    m = batch[0].shape[1]
    t0 = time.perf_counter()
    want = plain.march_side(*batch)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    got = mk.march_side(*batch)
    torch.cuda.synchronize()
    nominal = torch.arange(n_l, device=dev) * k + k // 2
    strict = sum(c[0].reshape(-1, m).shape[0]
                 for c in side_calls[:n_strict_sides])
    stop = []
    between = 0
    for lane in range(n_l):
        rows = slice(lane * k, (lane + 1) * k)
        stop.append(ensemble_stop({f: getattr(want, f)[rows]
                                   for f in HELD_FIELDS}, HELD_FIELDS,
                                  nan_equal=nan_equal))
        xtrs = set(want.x_transition[rows].tolist())
        xk = float(got.x_transition[nominal[lane]])
        if nan_equal and np.isnan(xk) and any(np.isnan(x) for x in xtrs):
            xtrs = {x for x in xtrs if not np.isnan(x)} | {xk}
        if xtr_between and xk not in xtrs and len(xtrs) > 1 \
                and min(xtrs) <= xk <= max(xtrs):
            between += 1
        else:
            require(xk in xtrs, f"{label} side lane {lane}: x_tr {xk} not "
                    f"in the plain ensemble's {sorted(xtrs)}")
        require(lane >= strict or (len(xtrs) == 1 and stop[-1] >= m - te_tail),
                f"{label}: strict side lane {lane}: the plain ensemble "
                f"spreads from station {stop[-1]} of {m}, x_tr {sorted(xtrs)}")
    own = type(got)(*(torch.cat(f) for f in zip(*(
        mk.march_side(*c) for c in side_calls))))
    require(_same_bits(own, _rows(got, nominal)),
            f"{label}: a side march at its own shape differs from its lanes "
            f"of the batch")
    worst = _hold_march(own, _rows(want, nominal), f"{label} sides", stop,
                        nan_equal)

    wb, n_wl = ensemble(_stack_calls(wake_calls, 2))
    mw = wb[0].shape[1]
    want_w = plain.march_wake(*wb)
    got_w = mk.march_wake(*wb)
    torch.cuda.synchronize()
    wstop = [ensemble_stop({"theta": want_w[0][lane * k:(lane + 1) * k],
                            "dstar": want_w[1][lane * k:(lane + 1) * k]},
                           ("theta", "dstar"), nan_equal=nan_equal)
             for lane in range(n_wl)]
    require(all(t == mw for t in wstop[:n_strict_wakes]),
            f"{label}: strict wakes spread at {wstop[:n_strict_wakes]}")
    own_w = [torch.cat(f) for f in zip(*(
        [a.reshape(-1, mw) for a in mk.march_wake(*c)] for c in wake_calls))]
    w_rows = torch.arange(n_wl, device=dev) * k + k // 2
    require(_same_bits(own_w, [a[w_rows] for a in got_w]),
            f"{label}: a wake march at its own shape differs from its lane "
            f"of the batch")
    worst_w = 0.0
    for lane, stop_l in enumerate(wstop):
        for a, b, f in zip(own_w, want_w, ("theta", "dstar", "hk")):
            a, b = a[lane, :stop_l], b[w_rows[lane], :stop_l]
            d = (a - b).abs()
            worst_w = max(worst_w, float(d.nan_to_num(0.0).max())
                          if d.numel() else 0.0)
            require(bool(_close(a, b, nan_equal).all()),
                    f"{label} wake lane {lane} {f}: max rel "
                    f"{float((d / b.abs()).max()):.3e}")
    log(f"[{stage}] {label}: {len(side_calls)} side marches ({n_l} "
        f"lanes x {m} stations) and {len(wake_calls)} wake marches ({mw} "
        f"stations), each with its plain rounding ensemble of {k} and "
        f"launched alone at its own shape (bit-equal to the batch): side "
        f"lanes spread-free on all stations {sum(t == m for t in stop)} of "
        f"{n_l} (else held up to {[t for t in stop if t < m]}), wakes "
        f"{sum(t == mw for t in wstop)} of {n_wl}; kernel = plain there "
        f"(rtol {MARCH_RTOL}, flags and x_transition in the ensemble; "
        f"{between} knife-edge lanes' x_transition between the ensemble's "
        f"values), max "
        f"abs {worst:.3e} (sides), {worst_w:.3e} (wakes); plain batch call "
        f"{t_plain:.2f} s")
    return {"bl_march": worst, "bl_march_wake": worst_w}, batch


def phase_newton_march(dev, mk, plain, newton, op, trip_x):
    """Every march of a tripped and a free default Newton solve (NACA 2412,
    the speed point) against the plain march; returns ({kernel: largest abs
    difference}, one side call and one wake call of the free solve)."""
    code, alpha, re = NEWTON_POINT
    with recording(mk) as calls:
        newton.solve_viscous_newton(op, alpha, re,
                                    x_forced_transition=trip_x)
        n_trip, n_trip_w = len(calls["march_side"]), len(calls["march_wake"])
        newton.solve_viscous_newton(op, alpha, re)
    per = NEWTON_SHAPE["warm_iters"] + 2
    require(len(calls["march_side"]) == 2 * per
            and len(calls["march_wake"]) == 2,
            f"{len(calls['march_side'])} side and {len(calls['march_wake'])} "
            f"wake marches in two Newton solves, want {2 * per} and 2")
    worst, _batch = hold_recorded_marches(
        dev, mk, plain, calls["march_side"], calls["march_wake"], n_trip,
        n_trip_w, f"NACA {code} alpha {alpha:g} Newton solves tripped at "
        f"{trip_x} and free")
    return worst, calls["march_side"][n_trip], calls["march_wake"][-1]


def _held(label, rec, golden, n_side, n_wake, want_side, secs):
    fails = held_to_members(rec, golden)
    if (n_side, n_wake) != (want_side, 1):
        fails.append(f"{n_side} side and {n_wake} wake march launches, want "
                     f"{want_side} and 1")
    log(f"[newton] {label}: {json.dumps(rec)}; golden "
        f"{json.dumps({f: golden[f] for f in rec})}; ensemble "
        f"{json.dumps(golden['ensemble'])}; {n_side} + {n_wake} march "
        f"launches, {secs:.3f} s {'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"{label}: {fails}")


def phase_newton(dev, goldens, ops, newton, mk):
    """The main path of this slice's solver: the default Newton solve at
    each golden point, the polar point and both continuation solves from
    the reference's donor state; returns {kernel: its launches}."""
    mk.march_launches = 0
    mk.wake_launches = 0
    per = NEWTON_SHAPE["warm_iters"] + 2

    def run(fn):
        before = mk.march_launches, mk.wake_launches
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, mk.march_launches - before[0],
                mk.wake_launches - before[1], time.perf_counter() - t0)

    for g in goldens["newton"]:
        r, n_s, n_w, secs = run(lambda: newton.solve_viscous_newton(
            ops[g["naca"]], g["alpha"], g["re"]))
        _held(f"solve_viscous_newton NACA {g['naca']} alpha {g['alpha']:g}",
              _viscous_record(r), g, n_s, n_w, per, secs)
    c = goldens["continuation"]["default"]
    op = ops[c["naca"]]
    out, n_s, n_w, secs = run(lambda: newton.solve_polar_point(
        op, c["donor_alpha"], c["re"]))
    _held(f"solve_polar_point alpha {c['donor_alpha']:g}", merged_record(out),
          c["donor"], n_s, n_w, per, secs)
    st = c["donor"]["state"]
    donor = newton.state_from_numpy(st["zz"], st["xtr_u"], st["xtr_l"],
                                    device=dev)
    r, n_s, n_w, secs = run(lambda: newton.solve_viscous_newton_cont(
        op, c["cont_alpha"], c["re"], *donor))
    _held(f"solve_viscous_newton_cont alpha {c['donor_alpha']:g} -> "
          f"{c['cont_alpha']:g} from the reference's donor",
          _viscous_record(r), c["solve_viscous_newton_cont"], n_s, n_w, 3,
          secs)
    out, n_s, n_w, secs = run(lambda: newton.solve_polar_point_cont(
        op, c["cont_alpha"], c["re"], *donor))
    _held(f"solve_polar_point_cont alpha {c['donor_alpha']:g} -> "
          f"{c['cont_alpha']:g} from the reference's donor",
          merged_record(out), c["solve_polar_point_cont"], n_s, n_w, 3, secs)
    return {"bl_march": mk.march_launches, "bl_march_wake": mk.wake_launches}


def newton_system(dev, newton, op, alphas=None):
    """The Newton system at the speed point (or at ``alphas``, one lane
    each) after its warm start, the start state (P, n3) and the start
    damping (P,)."""
    code, alpha, re = NEWTON_POINT
    if alphas is not None:
        alpha = torch.tensor(alphas, dtype=torch.float32, device=dev)
    system, _sc, _ws, zz = newton._prepare(
        op, alpha, re, 9.0, 1.0, NEWTON_SHAPE["n_stations"],
        NEWTON_SHAPE["n_wake"], NEWTON_SHAPE["warm_iters"])
    return system, zz, torch.full((zz.shape[0],), 1e-3, device=dev)


def phase_lm_sync_free(dev, newton, op):
    """One LM iteration at the speed point, and one of eight lanes (a
    polar bucket's), under ``torch.cuda.set_sync_debug_mode("error")``:
    neither may synchronise with the host (after one warm iteration, which
    fills the device constant caches)."""
    for alphas in (None, [-2.0, 0.0, 2.0, 4.0, 6.0, 6.0, 6.0, 6.0]):
        system, zz, lam = newton_system(dev, newton, op, alphas)
        system.lm_step(zz, lam)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            zz2, lam2 = system.lm_step(zz, lam)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(zz2).all()) and bool((lam2 > 0.0).all()),
                "LM iteration result")
        log(f"[newton] one LM iteration ({zz.shape[0]} lane(s) of "
            f"{zz.shape[-1]} unknowns) ran under set_sync_debug_mode("
            f"'error'): no host synchronisation; damping "
            f"{lam.tolist()} -> {lam2.tolist()}")


@contextlib.contextmanager
def recorded_solvers(analyze_mod):
    """Records (solver, alpha, converged) of every solver call that
    ``analyze_airfoil`` makes."""
    calls = []
    names = ("solve_viscous_newton", "solve_polar_point",
             "solve_polar_point_cont", "solve_viscous_newton_cont",
             "solve_viscous")
    originals = {n: getattr(analyze_mod, n) for n in names}

    def wrap(name, fn):
        def run(op, alpha, *args, **kwargs):
            out = fn(op, alpha, *args, **kwargs)
            conv = out[1][0] if name in ("solve_polar_point",
                                         "solve_polar_point_cont") \
                else out.converged
            calls.append([name, float(alpha), bool(conv)])
            return out
        return run

    for n, fn in originals.items():
        setattr(analyze_mod, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in originals.items():
            setattr(analyze_mod, n, fn)


def _coefficients_held(c: dict, ens: dict) -> list:
    fails = []
    for key, f, (abs_bar, rel_bar) in (("CL", "cl", VISCOUS_BARS["cl"]),
                                       ("CD", "cd", VISCOUS_BARS["cd"]),
                                       ("Cm", "cm", VISCOUS_BARS["cm"])):
        lo, hi = ens[f]
        if not (lo - abs_bar - rel_bar * abs(lo) <= c[key]
                <= hi + abs_bar + rel_bar * abs(hi)):
            fails.append(f"{key} {c[key]} outside [{lo}, {hi}] +- bar")
    if c["mode"] not in ens["mode"]:
        fails.append(f"mode {c['mode']} not in {ens['mode']}")
    return fails


def _bl_schema(bl: dict, n: int) -> bool:
    row = {"x", "y", "dstar", "theta", "cf", "H"}
    return (set(bl) == {"upper", "lower", "transition_upper_x",
                        "transition_lower_x"}
            and len(bl["upper"]) == len(bl["lower"]) == n
            and all(set(r) == row for r in bl["upper"] + bl["lower"])
            and bl["upper"][0]["x"] > bl["upper"][-1]["x"]
            and bl["lower"][0]["x"] < bl["lower"][-1]["x"]
            and all(np.isfinite([r[k] for k in row]).all()
                    for r in bl["upper"] + bl["lower"]))


def phase_analyze(dev, goldens, polar, analyze_mod):
    """``analyze_airfoil`` on the card at golden (d)'s alphas; returns
    {alpha: wall seconds}."""
    walls = {}
    for g in goldens["analyze"]:
        with recorded_solvers(analyze_mod) as calls:
            t0 = time.perf_counter()
            res = polar.analyze_airfoil(naca4_coords(2, 4, 12, g["coords"]),
                                        g["re"], g["alpha"], device=dev)
            walls[g["alpha"]] = time.perf_counter() - t0
        c = res.coefficients
        fails = []
        if g["mode"] == "inviscid":
            if (res.mode, res.strategy, res.bl_data) != ("inviscid", 3, None):
                fails.append(f"mode {res.mode} strategy {res.strategy}")
            if c.get("warning") != polar.INVISCID_WARNING or c["CD"] != 0.0:
                fails.append(f"coefficients {c}")
            for key in ("CL", "Cm"):
                if abs(c[key] - g["coefficients"][key]) > 1e-4:
                    fails.append(f"{key} {c[key]} vs {g['coefficients'][key]}")
        else:
            if res.mode != "viscous" or "warning" in c:
                fails.append(f"mode {res.mode}, coefficients {c}")
            fails += _coefficients_held(c, g["ensemble"])
            if not (res.bl_data and _bl_schema(res.bl_data,
                                               NEWTON_SHAPE["n_stations"])):
                fails.append("bl_data schema")
        if len(res.cp_x) != len(res.cp_values) != N_PANELS:
            fails.append("cp length")
        log(f"[analyze] NACA 2412 ({g['coords']} points a side) alpha "
            f"{g['alpha']:g} Re {g['re']:g}: mode {res.mode}, strategy "
            f"{res.strategy}, {c}; golden {g['coefficients']} (strategy "
            f"{g['strategy']}); solver calls {calls}, the reference's "
            f"{g['calls']}; {walls[g['alpha']]:.3f} s "
            f"{'ok' if not fails else 'FAIL ' + str(fails)}")
        require(not fails, f"analyze alpha {g['alpha']}: {fails}")
    return walls


def upload_fails(status: int, body: dict, g: dict) -> list:
    """How the reply to golden (e)'s upload fails its hold: the schema,
    the coordinates and parser fixes, cp_x, the coefficients within the
    bars of the reference's ensemble, the boundary-layer schema."""
    want = g["reply"]
    if status != 200 or set(body) != set(want):
        return [f"status {status}, keys {sorted(body)}"]
    c = body["coefficients"]
    fails = _coefficients_held(c, g["ensemble"])
    for key in ("coords_before", "coords_after", "num_points",
                "parser_fixes"):
        if body[key] != want[key]:
            fails.append(f"{key} differs from the reference's")
    if not np.allclose(body["cp_x"], want["cp_x"], rtol=1e-5, atol=1e-6):
        fails.append("cp_x")
    if c["mode"] == "viscous" and not _bl_schema(
            body["bl_data"], NEWTON_SHAPE["n_stations"]):
        fails.append("bl_data schema")
    return fails


def phase_upload(goldens, make_server, run_log_dir, stats, analyze_mod):
    """``POST /upload_airfoil/`` on the port's server on the card with
    golden (e)'s file; returns the request's wall seconds."""
    g = goldens["upload"]
    want = g["reply"]
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    count0 = stats.get_analysis_count()
    try:
        with recorded_solvers(analyze_mod) as calls:
            t0 = time.perf_counter()
            status, body = _post(url + "/upload_airfoil/",
                                 {"reynolds": g["reynolds"],
                                  "alpha": g["alpha"]},
                                 {"file": (g["filename"], g["dat"].encode())})
            wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    fails = upload_fails(status, body, g)
    logs = os.listdir(run_log_dir)
    count = stats.get_analysis_count()
    if len(logs) != 1 or count != (count0 or 0) + 1:
        fails.append(f"{len(logs)} run logs, analysis count {count0} -> "
                     f"{count}")
    log(f"[upload] POST /upload_airfoil/ ({g['filename']}, Re "
        f"{g['reynolds']:g}, alpha {g['alpha']:g}) on the card: {status}, "
        f"{body.get('coefficients')}; golden {want['coefficients']}, "
        f"ensemble {g['ensemble']}; solver calls {calls}, the reference's "
        f"{g['calls']}; {len(logs)} run log, analysis count "
        f"{count}; {wall:.3f} s (HTTP round trip) "
        f"{'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"upload: {fails}")
    return wall


POLAR_GOLDENS = os.path.join(ROOT, "tests", "golden", "torch_polar.json")
# The sweep's per-point and continuation solves: warm passes, LM
# iterations a round; side marches a solve are warm passes + 2.
POINTS_SHAPE = {"warm_iters": 8, "newton_iters": 10}
CONT_SHAPE = {"warm_iters": 1, "newton_iters": 14}


def precise_dat(name: str, coords) -> str:
    """A .dat file whose coordinates parse back to the same float32
    values (9 significant digits)."""
    return name + "\n" + "\n".join(f" {x:.9g} {y:.9g}"
                                   for x, y in np.asarray(coords, np.float32))


def nearest_member(rec: dict, members, bars=None) -> tuple[float, int]:
    """(distance, index) of the member of ``members`` ((index, member)
    pairs) nearest ``rec`` jointly: a member's distance is the largest,
    over the barred fields, of |rec - member| in units of the field's bar
    around the member (at most 1: every field within its bar)."""
    bars = VISCOUS_BARS if bars is None else bars
    return min((max(abs(rec[f] - m[f]) / (a + r * abs(m[f]))
                    for f, (a, r) in bars.items()), i) for i, m in members)


def held_to_polar(rec: dict, golden: dict) -> tuple[list, str]:
    """A polar point or batch lane ``rec`` held jointly to one member of
    the reference's rounding ensemble. Its candidates are the members that
    share its verdict (``mode`` where it has one, and ``converged``); it
    is held when every barred field lies within its bar of one candidate.
    Where none holds it, rounding has moved the port's transition by a
    station or so off every member's, which moves CD most: it then passes
    only if every barred field but CD lies within its bar of one
    candidate (the reference's basin: its transitions, lift and moment),
    and the note names those candidates beside the nearest member. The
    lane's arithmetic, CD included, is held apart from its basin by the
    solve from the reference's own states (``held_from_states``). Returns
    (failures, note)."""
    flags = [f for f in ("mode", "converged") if f in rec]
    cands = [(i, m) for i, m in enumerate(golden["members"])
             if all(m[f] == rec[f] for f in flags)]
    if not cands:
        return [f"{ {f: rec[f] for f in flags} } not among the verdicts of "
                f"the ensemble's members"], ""
    d, i = nearest_member(rec, cands)
    note = f"nearest member {i} at {d:.3f} bars"
    if d <= 1.0:
        return [], note
    but_cd = {f: b for f, b in VISCOUS_BARS.items() if f != "cd"}
    basin = [j for j, m in cands
             if nearest_member(rec, [(j, m)], but_cd)[0] <= 1.0]
    if not basin:
        return [f"off every member jointly ({note}) and in no member's "
                f"basin"], note
    return [], (f"off every member jointly ({note}): a knife edge, all "
                f"but CD within the bars of members {basin}")


# The bars of a lane's answer at the reference's own final state: the
# same arithmetic on the same state, up to the card's rounding.
STATE_BARS = {"cl": (1e-4, 0.0), "cd": (0.0, 1e-4), "cm": (1e-4, 0.0),
              "xtr_upper": (1e-4, 0.0), "xtr_lower": (1e-4, 0.0)}


def held_from_states(newton, op, recs, reynolds, dev, label: str) -> float:
    """The lane-batched system at the reference's own final states
    (``points_pass``: its per-point pass of a polar, or its batch) in place
    of the LM rounds' result: set up as the solve sets it up (warm start,
    trip ceilings), each lane's residual, answer and verdicts are taken at
    the reference's state, so no basin is chosen. Every lane must give the
    reference's verdicts; every lane the reference solved, its answer
    within ``STATE_BARS``. (A lane whose Newton solve failed answers with
    the warm-start fallback, which the state does not reach: its verdicts
    hold it.) ``op`` is one operator or one a lane. Returns the largest
    distance, in units of ``STATE_BARS``."""
    zz, xu, xl = newton.state_from_numpy(
        [r["state"]["zz"] for r in recs], [r["state"]["xtr_u"] for r in recs],
        [r["state"]["xtr_l"] for r in recs], device=dev)
    alphas = torch.tensor([r["alpha"] for r in recs], device=dev)
    t0 = time.perf_counter()
    system, sc, warm_state, zz = newton._prepare(
        op, alphas, reynolds, 9.0, 1.0, 96, 20, POINTS_SHAPE["warm_iters"],
        init_state=(zz, xu, xl))
    rms = newton._rms(system.residual(zz))
    merged, (nok, _state) = newton._points_out(*newton._lane_answer(
        system, sc, warm_state, zz, rms))
    secs = time.perf_counter() - t0
    worst, fails = 0.0, []
    for i, want in enumerate(recs):
        rec = merged_record(([v[i] for v in merged], (nok[i], None)))
        flags = ("converged", "newton_converged")
        if any(rec[f] != want[f] for f in flags):
            fails.append(f"lane {i}: verdicts {[rec[f] for f in flags]}, "
                         f"the reference's {[want[f] for f in flags]}")
        elif want["newton_converged"]:
            d, _ = nearest_member(rec, [(0, want)], STATE_BARS)
            worst = max(worst, d)
            if d > 1.0:
                fails.append(f"lane {i} (alpha {want['alpha']:g}): "
                             f"{json.dumps(rec)} is {d:.3f} bars off the "
                             f"reference's {json.dumps({f: want[f] for f in STATE_BARS})}")
    log(f"[polar states] {label}: every lane's answer at the reference's "
        f"final state ({secs:.3f} s, residual rms "
        f"{[round(float(r), 6) for r in rms]}): the "
        f"{sum(r['newton_converged'] for r in recs)} lanes the reference "
        f"solved at most {worst:.4f} of their bars (CL, Cm, x_tr 1e-4; CD "
        f"1e-4 relative) {'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"{label}: {fails}")
    return worst


def polar_record(res, i: int) -> dict:
    return {"alpha": float(res.alpha[i]), "cl": float(res.cl[i]),
            "cd": float(res.cd[i]), "cdp": float(res.cdp[i]),
            "cm": float(res.cm[i]), "mode": int(res.mode[i]),
            "converged": bool(res.converged[i]),
            "xtr_upper": float(res.xtr_upper[i]),
            "xtr_lower": float(res.xtr_lower[i]),
            "sep_fraction": float(res.sep_fraction[i])}


@contextlib.contextmanager
def lm_rounds_recorded(newton):
    """Records (lanes, rounds each lane ran) of every LM round loop."""
    runs = []
    orig = newton._lm_rounds

    def counted(system, *args):
        out = orig(system, *args)
        runs.append((system.lanes[0], out[2].tolist()))
        return out

    newton._lm_rounds = counted
    try:
        yield runs
    finally:
        newton._lm_rounds = orig


def _lane_counts(calls) -> dict:
    out = {}
    for c in calls:
        n = c[0].reshape(-1, c[0].shape[-1]).shape[0]
        out[n] = out.get(n, 0) + 1
    return out


def program_counts(graphs) -> dict:
    """Each solver program's graph captures and replays so far."""
    return {prog: {"captures": graphs.total(graphs.captures, prog),
                   "replays": graphs.total(graphs.replays, prog)}
            for prog in graphs.PROGRAMS}


def _same_polar(a, b) -> bool:
    """Two ``PolarResult``s equal bit for bit, field by field."""
    return all(np.asarray(x).dtype == np.asarray(y).dtype
               and np.asarray(x).shape == np.asarray(y).shape
               and np.asarray(x).tobytes() == np.asarray(y).tobytes()
               for x, y in zip(a, b))


def phase_polar(dev, card, pgold, sweep, newton, graphs, mk, plain):
    """The main path of this slice: ``solve_polar`` of the golden polar on
    the card as a user runs it (every solver program graphed), every point
    held to the reference's ensemble, its marches (launches) and walk
    solves counted; then the same polar again with the solver's programs
    eager (``recording``), equal to it bit for bit with the same marches
    and walk solves, whose recorded marches give the lanes a launch and
    the per-point pass's marches held to the plain march; the pass's
    profile, and the march kernels at the polar path's 64 and 128 lanes.
    Returns (the graphed result, its wall seconds, {kernel: its
    launches}, {kernel: its lanes a launch}, the largest difference from
    the plain march, timings at 64 and 128 lanes, each program's graph
    captures and replays in the graphed polar)."""
    g = pgold["polar"]
    coords = np.asarray(naca4_coords(*g["naca"]), np.float32)

    def counted_polar():
        mk.march_launches = 0
        mk.wake_launches = 0
        sweep.walk_solves.update(cont=0, trip=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep.solve_polar(coords, g["alphas"], g["re"], device=dev)
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0,
                {"bl_march": mk.march_launches,
                 "bl_march_wake": mk.wake_launches}, dict(sweep.walk_solves))

    counts0 = program_counts(graphs)
    with lm_rounds_recorded(newton) as runs:
        res, wall, launches, walk = counted_polar()
    counts1 = program_counts(graphs)
    solver_graphs = {prog: {k: n - counts0[prog][k] for k, n in c.items()}
                     for prog, c in counts1.items()}
    with recording(mk) as calls:
        res_eager, wall_eager, launches_eager, walk_eager = counted_polar()
    same = _same_polar(res, res_eager)
    log(f"[polar] the same polar with the solver's programs eager (marches "
        f"recorded): {wall_eager:.3f} s wall, march launches "
        f"{launches_eager}, walk solves {walk_eager}; equal to the graphed "
        f"polar bit for bit: {same} {'ok' if same else 'FAIL'}")
    require(same and launches_eager == launches and walk_eager == walk,
            f"the eager polar: bit-equal {same}, launches {launches_eager} "
            f"(graphed {launches}), walk solves {walk_eager} (graphed "
            f"{walk})")
    n_walk = walk["cont"] + walk["trip"]
    p = sweep._bucket_size(len(g["alphas"]))
    sides = _lane_counts(calls["march_side"])
    wakes = _lane_counts(calls["march_wake"])
    per_pass = POINTS_SHAPE["warm_iters"] + 2
    per_cont = CONT_SHAPE["warm_iters"] + 2
    passes = wakes.get(p, 0)       # the per-point pass and the rescue
    require(passes in (1, 2) and sides.get(2 * p, 0) == per_pass * passes
            and sides.get(2, 0) == per_cont * n_walk
            and wakes.get(1, 0) == n_walk
            and sum(sides.values()) == launches["bl_march"]
            and sum(wakes.values()) == launches["bl_march_wake"],
            f"polar marches: side lanes {sides}, wake lanes {wakes}, "
            f"launches {launches}, walk solves {walk}")
    fails = []
    for i, pg in enumerate(g["points"]):
        rec = polar_record(res, i)
        f, note = held_to_polar(rec, pg)
        fails += [f"alpha {pg['alpha']:g}: {x}" for x in f]
        log(f"[polar] alpha {pg['alpha']:g}: {json.dumps(rec)}; golden mode "
            f"{pg['mode']} cl {pg['cl']:.4f} cd {pg['cd']:.5f}; ensemble "
            f"{json.dumps(pg['ensemble'])}; {note} "
            f"{'ok' if not f else 'FAIL'}")
    points_lanes, points_rounds = runs[0]
    lm_iters = max(points_rounds) * POINTS_SHAPE["newton_iters"]
    log(f"[polar] solve_polar NACA {''.join(map(str, g['naca'][:3]))} "
        f"({g['naca'][3]} points a side), alpha {g['alphas']} at Re "
        f"{g['re']:g}: {len(g['alphas'])} points in a bucket of {p} lanes, "
        f"{wall:.3f} s wall ({card}); per-point pass: {points_lanes} lanes, "
        f"rounds a lane {points_rounds}, {lm_iters} LM iterations; walk: "
        f"{walk['cont']} continuation and {walk['trip']} trip solves "
        f"(rounds {[r for _, r in runs[1:1 + n_walk]]}); rescue pass "
        f"{'run' if passes == 2 else 'not needed'}; march launches "
        f"{launches} (side lanes a launch: {sides}; wake: {wakes}); graph "
        f"captures and replays {json.dumps(solver_graphs)}; modes "
        f"{res.mode.tolist()} {'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"polar: {fails}")
    worst, _batch = hold_recorded_marches(
        dev, mk, plain, calls["march_side"][:per_pass],
        calls["march_wake"][:1], 0, 0,
        f"the polar's per-point pass ({p} lanes)", stage="polar march",
        xtr_between=True)

    # The per-point pass alone: wall, and device time from the profiler.
    op, _xp, _yp = sweep._op_kernel(sweep._pad_coords(
        torch.as_tensor(coords, device=dev)), N_PANELS)
    a_np = np.asarray(g["alphas"], np.float32)
    a_in = torch.as_tensor(np.concatenate(
        [a_np, np.repeat(a_np[-1:], p - len(a_np))]), device=dev)
    re_in = torch.full((p,), g["re"], dtype=torch.float32, device=dev)
    t_pass = _median_s(lambda: sweep._points_kernel(op, a_in, re_in), 2)
    with traced() as prof:
        sweep._points_kernel(op, a_in, re_in)
    ev = kernel_events(prof, "march_side_kernel", "march_wake_kernel")
    busy = ev["all"][1] / 1e3 / (t_pass * 1e3)
    log(f"[polar] the per-point pass alone ({p} lanes): {t_pass:.3f} s wall "
        f"(median of 2), profiled: {ev['all'][0]} device kernels, "
        f"{ev['all'][1] / 1e3:.3f} ms of device time (march_side_kernel "
        f"{ev['march_side_kernel'][0]} x, "
        f"{ev['march_side_kernel'][1] / 1e3:.3f} ms; march_wake_kernel "
        f"{ev['march_wake_kernel'][0]} x, "
        f"{ev['march_wake_kernel'][1] / 1e3:.3f} ms): device busy "
        f"{busy:.1%} of the wall ({card})")
    held_from_states(newton, op, g["points_pass"], g["re"], dev,
                     f"the polar's per-point pass ({p} lanes)")

    # One LM iteration as the lane count grows: its host issue stays one
    # solve's, its device time grows with the lanes.
    for lanes in (1, p, 64):
        alphas = np.linspace(-2.0, 6.0, lanes).tolist()
        system, zz, lam = newton_system(dev, newton, op, alphas)
        system.lm_step(zz, lam)
        lm_wall = _median_s(lambda: system.lm_step(zz, lam), 3)
        with traced() as prof:
            system.lm_step(zz, lam)
        ev_lm = kernel_events(prof)["all"]
        log(f"[polar] one LM iteration of {lanes} lane(s): {lm_wall * 1e3:.3f}"
            f" ms wall (median of 3, synchronised), {ev_lm[0]} device "
            f"kernels, {ev_lm[1] / 1e3:.3f} ms of device time "
            f"({ev_lm[1] / 1e3 / (lm_wall * 1e3):.1%} busy) ({card})")
        del system, zz, lam

    # The march kernels at the polar path's lane counts: 2P side lanes of
    # the 31-point (bucket 32) and 43-point (bucket 64) polars, P wakes.
    side0, wake0 = calls["march_side"][0], calls["march_wake"][0]
    at_lanes = {}
    for lanes in (64, 128):
        s_args = _stack_calls([side0] * (lanes // (2 * p)), 3)
        w_args = _stack_calls([wake0] * (lanes // p), 2)
        at_lanes[lanes] = {
            "bl_march": (cuda_ms(lambda: mk.march_side(*s_args), 20),
                         side_march_bound(mk, plain, s_args)[0]),
            "bl_march_wake": (cuda_ms(lambda: mk.march_wake(*w_args), 20),
                              wake_march_bound(mk, plain, w_args)[0])}
        log(f"[polar] march kernels at {lanes} lanes: side ({lanes} x "
            f"{side0[0].shape[-1]} stations) "
            f"{at_lanes[lanes]['bl_march'][0]:.4f} ms (CUDA events, mean of "
            f"20), bound {at_lanes[lanes]['bl_march'][1][0] * 1e3:.3f} us; "
            f"wake ({lanes} x {wake0[0].shape[-1]} stations) "
            f"{at_lanes[lanes]['bl_march_wake'][0]:.4f} ms, bound "
            f"{at_lanes[lanes]['bl_march_wake'][1][0] * 1e3:.3f} us ({card})")
    lanes_of = {"bl_march": sorted(sides), "bl_march_wake": sorted(wakes)}
    return res, wall, launches, lanes_of, worst, at_lanes, solver_graphs


def phase_batch(dev, pgold, polar, newton, mk):
    """``solve_batch`` of the golden pair on the card (one lane a file),
    each lane held to the reference's ensemble, then its lanes solved from
    the reference's own states; returns the result."""
    g = pgold["batch"]
    mk.march_launches = 0
    mk.wake_launches = 0
    coords = [np.asarray(naca4_coords(*spec), np.float32)
              for spec in g["files"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = polar.solve_batch(coords, g["re"], g["alpha"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    names = ("cl", "cd", "cdp", "cm", "converged", "xtr_upper", "xtr_lower",
             "sep_fraction")
    fails = []
    for i, lg in enumerate(g["lanes"]):
        rec = {f: (bool(getattr(res, f)[i]) if f == "converged"
                   else float(getattr(res, f)[i])) for f in names}
        f, note = held_to_polar(rec, lg)
        fails += [f"lane {i}: {x}" for x in f]
        log(f"[batch] lane {i} NACA {g['files'][i][:3]}: {json.dumps(rec)}; "
            f"golden cl {lg['cl']:.4f} cd {lg['cd']:.5f} converged "
            f"{lg['converged']}; ensemble {json.dumps(lg['ensemble'])}; "
            f"{note} {'ok' if not f else 'FAIL'}")
    per_pass = POINTS_SHAPE["warm_iters"] + 2
    if (mk.march_launches, mk.wake_launches) != (per_pass, 1):
        fails.append(f"{mk.march_launches} side and {mk.wake_launches} wake "
                     f"launches, want {per_pass} and 1")
    log(f"[batch] solve_batch of {len(coords)} files at alpha {g['alpha']:g},"
        f" Re {g['re']:g}: {wall:.3f} s wall, {mk.march_launches} side "
        f"launches of {2 * len(coords)} lanes, {mk.wake_launches} wake "
        f"launch of {len(coords)} "
        f"{'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"batch: {fails}")
    held_from_states(newton, polar.batch._batch_ops(coords, N_PANELS, dev),
                     g["points_pass"], g["re"], dev,
                     f"the batch ({len(coords)} lanes)")
    return res


def phase_served(pgold, make_server, parse_upload, stats, polar_res,
                 batch_res):
    """``POST /polar/`` (the golden sweep) and ``POST /batch/`` (the golden
    pair) on the port's server on the card, each equal to the library's
    answer to the JSON's rounding, then ``GET /stats``: the counter grows
    by the analyses served. Returns the requests' wall seconds."""
    g, gb = pgold["polar"], pgold["batch"]
    dat = precise_dat("NACA", naca4_coords(*g["naca"])).encode()
    parsed, fixes = parse_upload("polar.dat", dat)
    require(np.array_equal(np.asarray(parsed, np.float32), np.asarray(
        naca4_coords(*g["naca"]), np.float32)),
        f"the served .dat does not parse back to the library's loop "
        f"(parser fixes {fixes})")
    files = [("files", (f"naca{i}.dat",
                        precise_dat("NACA", naca4_coords(*spec)).encode()))
             for i, spec in enumerate(gb["files"])]
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    a = g["alphas"]
    try:
        count0 = stats.get_analysis_count() or 0
        t0 = time.perf_counter()
        status, body = _post(url + "/polar/", {
            "reynolds": g["re"], "alpha_start": a[0], "alpha_end": a[-1],
            "alpha_step": a[1] - a[0]}, {"file": ("polar.dat", dat)})
        t_polar = time.perf_counter() - t0
        t0 = time.perf_counter()
        b_status, b_body = _post(url + "/batch/", {
            "reynolds": gb["re"], "alpha": gb["alpha"]}, files)
        t_batch = time.perf_counter() - t0
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            s_status, s_body = r.status, json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    fails = []
    names = {0: "viscous", 1: "viscous_smoothed", 2: "inviscid"}
    if status != 200 or len(body.get("polar", [])) != len(a):
        fails.append(f"/polar/ {status} {str(body)[:200]}")
    else:
        for i, row in enumerate(body["polar"]):
            want = {"alpha": float(polar_res.alpha[i]),
                    "CL": round(float(polar_res.cl[i]), 4),
                    "CD": round(float(polar_res.cd[i]), 6),
                    "CDp": round(float(polar_res.cdp[i]), 6),
                    "Cm": round(float(polar_res.cm[i]), 4),
                    "mode": names[int(polar_res.mode[i])],
                    "converged": bool(polar_res.converged[i]),
                    "xtr_upper": round(float(polar_res.xtr_upper[i]), 4),
                    "xtr_lower": round(float(polar_res.xtr_lower[i]), 4),
                    "sep_fraction": round(float(polar_res.sep_fraction[i]),
                                          4)}
            if row != want:
                fails.append(f"/polar/ row {i} {row} != library {want}")
    rows = b_body.get("results", []) if b_status == 200 else []
    if len(rows) != len(gb["files"]):
        fails.append(f"/batch/ {b_status} {str(b_body)[:200]}")
    for i, row in enumerate(rows):
        for key, f, nd in (("CL", "cl", 4), ("CD", "cd", 6), ("CDp", "cdp", 6),
                           ("Cm", "cm", 4), ("xtr_upper", "xtr_upper", 4),
                           ("xtr_lower", "xtr_lower", 4)):
            if row.get(key) != round(float(getattr(batch_res, f)[i]), nd):
                fails.append(f"/batch/ row {i} {key} {row.get(key)}")
        if row.get("converged") != bool(batch_res.converged[i]):
            fails.append(f"/batch/ row {i} converged")
    served = 1 + len(gb["files"])
    if s_status != 200 or s_body.get("total_analyses") != count0 + served:
        fails.append(f"/stats {s_status} {s_body}, want {count0 + served}")
    log(f"[served] POST /polar/ ({len(a)} points) {status} in {t_polar:.3f} s"
        f", equal to the library's polar to the JSON's rounding; POST "
        f"/batch/ ({len(files)} files) {b_status} in {t_batch:.3f} s: "
        f"{rows}; GET /stats {s_status} {s_body} (was {count0}) "
        f"{'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"served: {fails}")
    return {"polar": t_polar, "batch": t_batch}


def phase_newton_speed(card, dev, newton, graphs, op, mk, plain, side_call,
                       wake_call):
    """The Newton solve's profile at the speed point: wall time, rounds and
    LM iterations, host synchronisations, device time and busy share; one
    LM iteration's launches and device time, the batched Cholesky solves,
    ``_reproject_n``'s station loop; the march kernels at the solve's
    shapes. Returns ({kernel: (ms, plain ms, device ms)}, {kernel: (bound
    ms, what bounds it)}) at those shapes."""
    code, alpha, re = NEWTON_POINT
    # The kernels first: late in a long process the profiler has dropped
    # every record of a short window that followed the long traces below.
    k_ms = cuda_ms(lambda: mk.march_side(*side_call), 50)
    k_dev = device_ms(lambda: mk.march_side(*side_call), 20,
                      "march_side_kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.march_side(*side_call)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    w_ms = cuda_ms(lambda: mk.march_wake(*wake_call), 50)
    w_dev = device_ms(lambda: mk.march_wake(*wake_call), 20,
                      "march_wake_kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.march_wake(*wake_call)
    torch.cuda.synchronize()
    w_plain_ms = (time.perf_counter() - t0) * 1e3
    side_bound, side_ops = side_march_bound(mk, plain, side_call)
    wake_bound, wake_ops = wake_march_bound(mk, plain, wake_call)
    m, mw = side_call[0].shape[-1], wake_call[0].shape[-1]
    log(f"[newton speed] the Newton solve's marches: side pair, 2 lanes x "
        f"{m} stations: kernel {k_ms:.4f} ms (CUDA events, mean of 50; "
        f"device {k_dev:.4f} ms), plain {plain_ms:.1f} ms (one call, host "
        f"clock), bound {side_bound[0] * 1e3:.3f} us ({side_ops:.4g} "
        f"operations, set by {side_bound[1]}); wake, 1 lane x {mw} stations: "
        f"kernel {w_ms:.4f} ms (device {w_dev:.4f} ms), plain "
        f"{w_plain_ms:.1f} ms, bound {wake_bound[0] * 1e3:.3f} us "
        f"({wake_ops:.4g} operations, set by {wake_bound[1]}) ({card})")

    def solve():
        return newton.solve_viscous_newton(op, alpha, re)

    solve()                                     # warm
    # The LM iterations are graph replays (viscous/graphs.py).
    replays0 = graphs.total(graphs.replays, "lm")
    r = solve()
    torch.cuda.synchronize()
    n_lm = [graphs.total(graphs.replays, "lm") - replays0]
    iters = NEWTON_SHAPE["newton_iters"]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solve()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    t_solve = _median_s(solve, SOLVE_REPEATS)
    with traced() as prof:
        solve()
    ev = kernel_events(prof, "march_side_kernel", "march_wake_kernel")
    log(f"[newton speed] NACA {code} alpha {alpha:g} Re {re:g}, default "
        f"solve_viscous_newton ({N_PANELS} panels, {json.dumps(NEWTON_SHAPE)}"
        f", <= 4 rounds): median of {SOLVE_REPEATS}, synchronised, "
        f"{t_solve * 1e3:.3f} ms; "
        f"{n_lm[0]} LM iterations ({n_lm[0] / iters:g} rounds), converged "
        f"{bool(r.converged)}; {syncs} host synchronisations in a solve; "
        f"profiled solve: {ev['all'][0]} device kernels, "
        f"{ev['all'][1] / 1e3:.3f} ms of device time (march_side_kernel "
        f"{ev['march_side_kernel'][0]} x, {ev['march_side_kernel'][1] / 1e3:.3f}"
        f" ms; march_wake_kernel {ev['march_wake_kernel'][0]} x, "
        f"{ev['march_wake_kernel'][1] / 1e3:.3f} ms); device busy "
        f"{ev['all'][1] / 1e3 / (t_solve * 1e3):.1%} of the median wall "
        f"({card})")

    system, zz, lam = newton_system(dev, newton, op)
    system.lm_step(zz, lam)
    rms, jtj, jtr = system.normal_equations(zz)
    ops = {"LM iteration": count_dispatches(system.lm_step, zz, lam),
           "residual": count_dispatches(system.residual, zz),
           "coloured Jacobian": count_dispatches(system.jacobian, zz),
           "candidate steps": count_dispatches(system.candidate_steps, jtj,
                                               jtr, lam),
           "_reproject_n": count_dispatches(system.reproject_n, zz)}
    log(f"[newton speed] torch operations dispatched: "
        + ", ".join(f"{k} {v}" for k, v in ops.items()))
    lm_wall = _median_s(lambda: system.lm_step(zz, lam), 10)
    with traced() as prof:
        system.lm_step(zz, lam)
    ev_lm = kernel_events(prof)["all"]
    chol_ms = cuda_ms(lambda: system.candidate_steps(jtj, jtr, lam), 20)
    with traced() as prof:
        system.candidate_steps(jtj, jtr, lam)
    ev_chol = kernel_events(prof)["all"]
    ne_wall = _median_s(lambda: system.normal_equations(zz), 10)
    rep_wall = _median_s(lambda: system.reproject_n(zz), 10)
    with traced() as prof:
        system.reproject_n(zz)
    ev_rep = kernel_events(prof)["all"]
    log(f"[newton speed] one LM iteration: {lm_wall * 1e3:.3f} ms wall "
        f"(median of 10, synchronised), {ev_lm[0]} device kernels, "
        f"{ev_lm[1] / 1e3:.3f} ms of device time "
        f"({ev_lm[1] / 1e3 / (lm_wall * 1e3):.1%} busy); of it the "
        f"residual, the coloured Jacobian, J^T J and J^T r "
        f"{ne_wall * 1e3:.3f} ms wall; the four damped "
        f"{zz.shape[-1]}^2 Cholesky "
        f"solves (batched cholesky_ex, two triangular solves, clip) "
        f"{chol_ms:.4f} ms (CUDA events, mean of 20), {ev_chol[0]} device "
        f"kernels, {ev_chol[1] / 1e3:.4f} ms of device time; "
        f"_reproject_n (a {NEWTON_SHAPE['n_stations'] - 1}-station loop of "
        f"two lanes) "
        f"{rep_wall * 1e3:.3f} ms wall, {ev_rep[0]} device kernels, "
        f"{ev_rep[1] / 1e3:.3f} ms of device time ({card})")

    return ({"bl_march": (k_ms, plain_ms, k_dev),
             "bl_march_wake": (w_ms, w_plain_ms, w_dev)},
            {"bl_march": side_bound, "bl_march_wake": wake_bound})


GRAPH_LANES = (1, 8, 32)
GRAPH_CAPTURE = ("2412", 4.0, 1e6)           # where each key is captured
GRAPH_REPLAYS = (("0012", 2.0, 3e5), ("2412", 8.0, 1e6))
# The rounds held graph against eager: the eager round issues every one
# of an iteration's ~15,300 operations from the host.
GRAPH_ROUNDS = {"newton_iters": 4, "outer_rounds": 2}
HEADLINE_ALPHAS = tuple(float(a) for a in range(-10, 21))     # 31 points
SECOND_ALPHAS = tuple(float(a) for a in range(-6, 19))        # 25 points
CONCURRENT_ALPHAS = (2.0, 4.0, 6.0)
UPLOAD_POINT = (1e6, 5.0)                    # Re, alpha


@contextlib.contextmanager
def eager_lm(graphs):
    """``graphs.run_lm`` replaced by the eager round (``_eager_lm``, the
    graph's plain version) on the card."""
    orig = graphs.run_lm
    graphs.run_lm = lambda key, body, flat, iters: graphs._eager_lm(
        body, flat, iters)
    try:
        yield
    finally:
        graphs.run_lm = orig


@contextlib.contextmanager
def lm_outputs(graphs):
    """Records the (zz, lam) of every ``graphs.run_lm`` call: a round's."""
    orig = graphs.run_lm
    outs = []

    def recorded(key, body, flat, iters):
        out = orig(key, body, flat, iters)
        outs.append(out)
        return out

    graphs.run_lm = recorded
    try:
        yield outs
    finally:
        graphs.run_lm = orig


def graph_counts(graphs) -> tuple[int, int]:
    """The LM iteration's graphs captured and iterations replayed."""
    return (graphs.total(graphs.captures, "lm"),
            graphs.total(graphs.replays, "lm"))


def _graph_case(dev, newton, graphs, ops, p, naca, alpha, re, stacked):
    """One key's rounds at one point, graphed and eager on the same
    inputs: (equal bit for bit, graphs captured, LM iterations replayed,
    rounds a lane, the lanes' best rms, the eager rounds' seconds)."""
    op = [ops[naca]] * p if stacked else ops[naca]
    alphas = torch.full((p,), alpha, dtype=torch.float32, device=dev)
    system, _sc, _ws, zz_i = newton._prepare(
        op, alphas, re, 9.0, 1.0, NEWTON_SHAPE["n_stations"],
        NEWTON_SHAPE["n_wake"], NEWTON_SHAPE["warm_iters"])
    args = (GRAPH_ROUNDS["newton_iters"], GRAPH_ROUNDS["outer_rounds"])
    c0, r0 = graph_counts(graphs)
    with lm_outputs(graphs) as g_out:
        got = newton._lm_rounds(system, zz_i, *args)
    c1, r1 = graph_counts(graphs)
    t0 = time.perf_counter()
    with eager_lm(graphs), lm_outputs(graphs) as e_out:
        want = newton._lm_rounds(system, zz_i, *args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    same = (_same_bits(got, want) and len(g_out) == len(e_out)
            and all(_same_bits(a, b) for a, b in zip(g_out, e_out)))
    return (same, c1 - c0, r1 - r0, got[2].tolist(),
            [float(x) for x in got[1]], secs)


def lm_iteration_times(newton, graphs, system, zz, lam) -> dict:
    """One LM iteration of ``system``, graphed (``run_lm(.., 1)``: the
    inputs' copy, one replay, the read-back) and eager (``lm_step``): wall
    (median, synchronised), device time (profiler's kernel sum) and, for
    the graph, its replay by CUDA events."""
    system.run_lm(zz, lam, 1)
    graph = graphs._GRAPHS["lm", newton.lm_key(system)].graph
    out = {"graph_wall_ms": _median_s(lambda: system.run_lm(zz, lam, 1),
                                      10) * 1e3,
           "graph_replay_ms": cuda_ms(graph.replay, 10)}
    with traced() as prof:
        graph.replay()
    out["graph_kernels"], us = kernel_events(prof)["all"]
    out["graph_device_ms"] = us / 1e3
    system.lm_step(zz, lam)
    out["eager_wall_ms"] = _median_s(lambda: system.lm_step(zz, lam),
                                     3) * 1e3
    with traced() as prof:
        system.lm_step(zz, lam)
    out["eager_kernels"], us = kernel_events(prof)["all"]
    out["eager_device_ms"] = us / 1e3
    return out


def phase_graphs(dev, card, newton, graphs, sweep, handlers, make_server,
                 ops):
    """Phase 20a: the LM iteration's CUDA graphs (``viscous.graphs``). (a)
    at 1, 8 and 32 lanes, each key (shared operator, and stacked one a
    lane at 8 and 32) captured at NACA 2412 alpha 4 Re 1e6 and replayed at
    NACA 0012 alpha 2 Re 3e5 (shared) and NACA 2412 alpha 8 (stacked where
    the key has it): ``_lm_rounds`` graphed equals the eager round on the
    same inputs bit for bit (every round's state and damping, the best
    state, its rms, the rounds); one LM iteration's wall and device time,
    graphed and eager, at 1 and 32 lanes; (b) after
    ``warm_polar_kernels(p=32)`` from an empty cache, the headline's
    31-point polar and a 25-point one capture no graph; (c) three threads
    solving one key at once each get their answer alone, bit for bit; (d)
    an upload sent to a served port while ``start_warmup`` runs is
    answered, equal to the same upload after the warm-up. Returns the
    graphs' counters for the kernel line, and the headline polar's wall
    seconds."""
    graphs._GRAPHS.clear()
    fails, cases = [], []
    for p in GRAPH_LANES:
        for stacked in ((False, True) if p > 1 else (False,)):
            for i, (naca, alpha, re) in enumerate((GRAPH_CAPTURE,
                                                   *GRAPH_REPLAYS)):
                same, n_cap, n_rep, rounds, rms, secs = _graph_case(
                    dev, newton, graphs, ops, p, naca, alpha, re, stacked)
                want_cap = 1 if i == 0 else 0
                ok = same and n_cap == want_cap and n_rep > 0
                label = (f"{p} lane(s), "
                         f"{'stacked' if stacked else 'shared'} operator, "
                         f"NACA {naca} alpha {alpha:g} Re {re:g}")
                cases.append(label)
                log(f"[graphs] (a) {label} ({'capture' if i == 0 else 'replay'}"
                    f"): graph {'==' if same else '!='} eager round bit for "
                    f"bit; {n_cap} capture(s), {n_rep} LM iterations "
                    f"replayed, rounds {rounds}, best rms "
                    f"{[f'{x:.4g}' for x in rms[:4]]}; the eager rounds "
                    f"{secs:.2f} s {'ok' if ok else 'FAIL'}")
                if not ok:
                    fails.append(label)
    require(not fails, f"graph != eager round, or wrong captures: {fails}")

    code, alpha, re = NEWTON_POINT
    times = {}
    for p in (1, 32):
        alphas = np.linspace(-2.0, 6.0, p).tolist() if p > 1 else None
        system, zz, lam = newton_system(dev, newton, ops[code], alphas)
        times[p] = lm_iteration_times(newton, graphs, system, zz, lam)
        log(f"[graphs] one LM iteration of {p} lane(s) (NACA {code}, "
            f"{NEWTON_SHAPE['n_stations']} stations): graphed "
            f"{times[p]['graph_wall_ms']:.3f} ms wall (median of 10, "
            f"synchronised; copy in, one replay, read-back), replay "
            f"{times[p]['graph_replay_ms']:.3f} ms (CUDA events, mean of "
            f"10), {times[p]['graph_kernels']} device kernels, "
            f"{times[p]['graph_device_ms']:.3f} ms of device time; eager "
            f"{times[p]['eager_wall_ms']:.3f} ms wall (median of 3), "
            f"{times[p]['eager_kernels']} device kernels, "
            f"{times[p]['eager_device_ms']:.3f} ms of device time ({card})")
        del system, zz, lam
    t_solve = _median_s(lambda: newton.solve_viscous_newton(
        ops[code], alpha, re), 3)
    log(f"[graphs] default solve_viscous_newton NACA {code} alpha {alpha:g} "
        f"Re {re:g}, graphed: {t_solve * 1e3:.3f} ms (median of 3, "
        f"synchronised) ({card})")

    # (b) A warmed bucket captures nothing. The march kernels run outside
    # the graphs (the warm starts, the verdicts): their launches counted.
    graphs._GRAPHS.clear()
    c0, _r = graph_counts(graphs)
    all0 = graphs.total(graphs.captures)
    zero_launch_counts()
    t0 = time.perf_counter()
    sweep.warm_polar_kernels(p=32, device=dev)
    t_warm = time.perf_counter() - t0
    c1, _r = graph_counts(graphs)
    all1 = graphs.total(graphs.captures)
    def march_counts():
        return {k: launch_counts()[k] for k in MARCH_KERNELS}

    marches = {"warm_polar_kernels": march_counts()}
    coords = np.asarray(naca4_coords(2, 4, 12, 100), np.float32)
    walls = {}
    for alphas in (HEADLINE_ALPHAS, SECOND_ALPHAS):
        c_a, r_a = graph_counts(graphs)
        all_a = graphs.total(graphs.captures)
        zero_launch_counts()
        t0 = time.perf_counter()
        res = sweep.solve_polar(coords, alphas, 1e6, device=dev)
        walls[len(alphas)] = time.perf_counter() - t0
        marches[f"polar_{len(alphas)}"] = march_counts()
        c_b, r_b = graph_counts(graphs)
        all_b = graphs.total(graphs.captures)
        ok = (c_b == c_a and all_b == all_a and r_b > r_a
              and len(res.cl) == len(alphas)
              and np.isfinite(res.cl).all()
              and all(marches[f"polar_{len(alphas)}"][k] > 0
                      for k in MARCH_KERNELS))
        log(f"[graphs] (b) solve_polar of {len(alphas)} points (bucket "
            f"{sweep._bucket_size(len(alphas))}) after warm_polar_kernels("
            f"p=32) ({t_warm:.2f} s, {c1 - c0} LM graphs and "
            f"{all1 - all0} graphs of every program captured, march "
            f"launches {marches['warm_polar_kernels']}): {all_b - all_a} "
            f"captures, {r_b - r_a} LM iterations replayed, march launches "
            f"{marches[f'polar_{len(alphas)}']}, "
            f"{walls[len(alphas)]:.3f} s wall, modes {res.mode.tolist()} "
            f"({card}) {'ok' if ok else 'FAIL'}")
        require(ok, f"a polar of {len(alphas)} points in a warmed bucket "
                    f"captured {all_b - all_a} graphs")
    # Three keys (the pass's 32 lanes, the walk's 1, the rescue's 8), five
    # programs at each (set-up, re-projection, LM iteration, settle,
    # answer); the walk's inviscid fill; the operator's two graphs, plain
    # and smoothed, at each of the three coordinate buckets.
    require(c1 - c0 == 3 and all1 - all0 == 28,
            f"warm_polar_kernels(p=32) captured {c1 - c0} LM graphs and "
            f"{all1 - all0} in all, want 3 (pass, walk, rescue) and 28")

    # (c) Three threads solve one key at once.
    op = ops["2412"]

    def solve(a):
        out = newton.solve_polar_point(op, a, 1e6)
        torch.cuda.synchronize()
        return [t for t in (*out[0], out[1][0], *out[1][1])]

    alone = [solve(a) for a in CONCURRENT_ALPHAS]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(len(CONCURRENT_ALPHAS)) as pool:
            together = [f.result(timeout=600) for f in
                        [pool.submit(solve, a) for a in CONCURRENT_ALPHAS]]
    finally:
        sys.setswitchinterval(interval)
    same = [_same_bits(a, b) for a, b in zip(alone, together)]
    log(f"[graphs] (c) solve_polar_point at alpha {list(CONCURRENT_ALPHAS)} "
        f"in three threads at once (one key): each equal to its solve alone "
        f"bit for bit {same} {'ok' if all(same) else 'FAIL'}")
    require(all(same), f"concurrent solves differ from solves alone: {same}")

    # (d) An upload while start_warmup runs.
    import logging
    graphs._GRAPHS.clear()
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    keep = Keep(logging.INFO)
    level = handlers.logger.level
    handlers.logger.addHandler(keep)
    handlers.logger.setLevel(logging.INFO)
    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device=dev)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/upload_airfoil/"
    dat = "NACA 2412\n" + "\n".join(f" {x:.6f} {y:.6f}"
                                    for x, y in naca4_coords())
    fields = {"reynolds": UPLOAD_POINT[0], "alpha": UPLOAD_POINT[1]}
    files = {"file": ("naca2412.dat", dat.encode())}
    try:
        t0 = time.perf_counter()
        warm = handlers.start_warmup(dev)
        during = _post(url, fields, files)
        alive = warm.is_alive()
        t_during = time.perf_counter() - t0
        warm.join(timeout=600)
        t_warm = time.perf_counter() - t0
        require(not warm.is_alive(), "start_warmup's thread did not end")
        after = _post(url, fields, files)
    finally:
        handlers.logger.removeHandler(keep)
        handlers.logger.setLevel(level)
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    msgs = [r.getMessage() for r in records]
    failed = [m for m in msgs if "warmup failed" in m]
    stages = [m for m in msgs if "warmup done in" in m]
    ok = (warm.name == "solver-warmup" and warm.daemon and alive
          and during[0] == 200 and during == after and not failed
          and len(stages) == 4)
    log(f"[graphs] (d) POST /upload_airfoil/ (NACA 2412, Re "
        f"{UPLOAD_POINT[0]:g}, alpha {UPLOAD_POINT[1]:g}) while start_warmup "
        f"ran (thread '{warm.name}', alive when answered: {alive}): "
        f"{during[0]} in {t_during:.2f} s, CL "
        f"{during[1].get('coefficients', {}).get('CL')}; the same after the "
        f"warm-up ({t_warm:.2f} s: {stages}): "
        f"{'equal' if during == after else 'DIFFERENT'}; warnings {failed} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, "upload during the warm-up")

    keys = {str(k[1][1:]): {"captures": graphs.captures.get(k, 0),
                            "replays": graphs.replays.get(k, 0),
                            "pool_bytes": v}
            for k, v in graphs.pool_bytes.items() if k[0] == "lm"}
    log(f"[graphs] an LM key ((lanes,), stations, wake, shared, panel nodes): "
        f"its captures and replays in this process, its graph pool's bytes: "
        f"{json.dumps(keys)} ({card})")
    return ({"keys": keys,
             "lm_iteration_ms": {str(p): t for p, t in times.items()},
             "solve_viscous_newton_ms": t_solve * 1e3,
             "headline_polar_s": walls[len(HEADLINE_ALPHAS)],
             "march_launches": marches},
            walls[len(HEADLINE_ALPHAS)])


DIRECT_ALPHAS = (0.0, 5.0)
PASS_POINTS = ((-10.0, 20.0, 1e6), (-6.0, 18.0, 1e6), (-10.0, 20.0, 3e5))
RESCUE_POINTS = ((-10.0, -3.0, 1e6), (10.0, 17.0, 1e6), (-2.0, 5.0, 6e5))
SINGLE_POINTS = (("2412", 4.0, 1e6), ("0012", 2.0, 3e5), ("2412", 8.0, 1e6))
CONT_LANES = (0, 10, 20)      # the pass's lanes the continuations start from


def _program_captures(graphs) -> dict:
    return {prog: c["captures"] for prog, c in program_counts(graphs).items()}


def _program_case(graphs, fn) -> dict:
    """``fn`` graphed, then with the solver's programs eager (the LM
    iteration graphed in both): equal bit for bit, the captures of each
    program, the march launches of each run, the walls."""
    from airfoil_tpu_torch.viscous import kernel as mk
    c0 = _program_captures(graphs)
    l0 = (mk.march_launches, mk.wake_launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    l1 = (mk.march_launches, mk.wake_launches)
    c1 = _program_captures(graphs)
    with eager_programs():
        t0 = time.perf_counter()
        want = fn()
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
    l2 = (mk.march_launches, mk.wake_launches)
    a, b = graphs.flatten(got)[0], graphs.flatten(want)[0]
    return {"same": len(a) == len(b) and _same_bits(a, b),
            "captures": {k: c1[k] - c0[k] for k in graphs.PROGRAMS
                         if c1[k] != c0[k]},
            "launches": [l1[0] - l0[0], l1[1] - l0[1]],
            "eager_launches": [l2[0] - l1[0], l2[1] - l1[1]],
            "graph_s": t_graph, "eager_s": t_eager, "out": got}


def phase_solver_graphs(dev, card, coupled, newton, graphs, sweep, pb, ops):
    """Phase 20b: the solver's other programs as CUDA graphs
    (``viscous.graphs``), from an empty cache. Each program graphed equals
    its eager body bit for bit on the card, with the same march launches,
    at the keys the main paths replay: the direct solve at the upload's
    last resort (1 lane, 160 panels, 80/24/24), the graft entry's (128
    panels, 48/16/12) and the parser benchmark's chunk (32 lanes, 128
    panels, 64/16/16, one lane an all-zero loop whose NaNs stay in it), at
    alpha 0 and 5; the Newton set-up, round and answer at the default
    solve's one lane, the polar's points pass (32 lanes), its walk's
    continuation (1 lane, 1 warm pass, a start state) and its rescue (8
    lanes, the smoothed operator), 3 points a key. One capture a key, none
    at a replay; each key's graph pool. Returns the record for the kernel
    line."""
    from airfoil_tpu_torch.models import naca4
    from airfoil_tpu_torch.inviscid import build_operator
    from airfoil_tpu_torch.paneling import panel_geometry, repanel
    graphs._GRAPHS.clear()
    before = dict(graphs.captures)
    cases, fails = {}, []

    def case(label, fn, first):
        out = _program_case(graphs, fn)
        want_caps = out["captures"] != {} if first else out["captures"] == {}
        ok = (out["same"] and want_caps
              and out["launches"] == out["eager_launches"])
        log(f"[solver graphs] {label}: graph {'==' if out['same'] else '!='} "
            f"eager bit for bit; captures {out['captures']}; march launches "
            f"{out['launches']} graphed, {out['eager_launches']} eager; "
            f"{out['graph_s'] * 1e3:.3f} ms graphed"
            f"{' (capture included)' if first else ''}, "
            f"{out['eager_s'] * 1e3:.3f} ms eager ({card}) "
            f"{'ok' if ok else 'FAIL'}")
        cases[label] = {k: v for k, v in out.items() if k != "out"}
        if not ok:
            fails.append(label)
        return out["out"]

    # The direct solve.
    coords60 = np.asarray(naca4(2, 4, 12, 60), np.float32)
    op128 = build_operator(panel_geometry(*repanel(
        torch.as_tensor(coords60, device=dev), 128)))
    loops = ([naca4(m, 4, t, 60) for m in (0, 2, 4) for t in range(6, 36, 3)]
             + [np.zeros((121, 2), np.float32), naca4(2, 4, 12, 60)])
    chunk_ops = pb.chunk_operators(pb.resample(loops)[0], dev)
    degenerate = len(loops) - 2
    direct = (("upload's last resort", ops["2412"], 1e6, {}),
              ("graft entry", op128, 1e6,
               {"n_stations": 48, "n_wake": 16, "coupling_iters": 12}),
              ("parser chunk", chunk_ops, pb.BENCH_REYNOLDS, pb.SOLVE_SHAPE))
    for name, op, re, kw in direct:
        for i, a in enumerate(DIRECT_ALPHAS):
            r = case(f"direct solve, {name}, alpha {a:g}",
                     lambda: coupled.solve_viscous(op, a, re, **kw), i == 0)
            if name == "parser chunk":
                finite = torch.isfinite(r.cl) & torch.isfinite(r.cd)
                nan_lane = [j for j, f in enumerate(finite.tolist()) if not f]
                if nan_lane != [degenerate]:
                    fails.append(f"chunk alpha {a:g}: non-finite lanes "
                                 f"{nan_lane}, want [{degenerate}]")

    # The Newton solve.
    for i, (code, a, re) in enumerate(SINGLE_POINTS):
        case(f"Newton default solve, NACA {code} alpha {a:g} Re {re:g}",
             lambda: newton.solve_viscous_newton(ops[code], a, re), i == 0)
    coords = sweep._pad_coords(torch.as_tensor(
        np.asarray(naca4(2, 4, 12, 95), np.float32), device=dev))
    op_p, _xp, _yp = sweep._op_kernel(coords, 160)
    op_s = sweep._op_kernel_smoothed(coords, 160)
    states = None
    for i, (lo, hi, re) in enumerate(PASS_POINTS):
        alphas = torch.linspace(lo, hi, 32, device=dev)
        res = torch.full((32,), re, device=dev)
        out = case(f"points pass, 32 lanes, alpha {lo:g}..{hi:g} Re {re:g}",
                   lambda: sweep._points_kernel(op_p, alphas, res), i == 0)
        if states is None:
            states = (alphas, res, out[1][1])
    alphas, res, st = states
    for i, j in enumerate(CONT_LANES):
        case(f"walk continuation, 1 lane, from lane {j} to alpha "
             f"{float(alphas[j]) + 1:g}",
             lambda: newton.solve_polar_point_cont(
                 op_p, alphas[j] + 1.0, res[j], *(x[j] for x in st),
                 n_stations=NEWTON_SHAPE["n_stations"]), i == 0)
    for i, (lo, hi, re) in enumerate(RESCUE_POINTS):
        a8 = torch.linspace(lo, hi, 8, device=dev)
        r8 = torch.full((8,), re, device=dev)
        case(f"rescue, 8 lanes (smoothed), alpha {lo:g}..{hi:g} Re {re:g}",
             lambda: sweep._rescue_kernel(op_s, a8, r8), i == 0)

    new = {k: graphs.captures[k] - before.get(k, 0) for k in graphs.captures
           if graphs.captures[k] != before.get(k, 0)}
    keys = {f"{k[0]} {k[1][1:]}": graphs.pool_bytes[k] for k in new}
    log(f"[solver graphs] captures a key in this phase (each 1): "
        f"{sorted(set(new.values()))}; graph pools, bytes by program and "
        f"key (lanes, ...): {json.dumps(keys)} ({card})")
    require(not fails, f"solver graphs: {fails}")
    require(set(new.values()) == {1}, f"captures a key: {new}")
    return {"cases": cases, "pool_bytes": keys}


def _lanes_not_finite(tensors) -> list:
    """The lanes (leading axis) in which any of ``tensors`` holds a value
    that is not finite."""
    bad = None
    for t in tensors:
        if t.dim() and t.is_floating_point():
            lane = ~torch.isfinite(t.reshape(t.shape[0], -1)).all(-1)
            bad = lane if bad is None else bad | lane
    return [i for i, b in enumerate(bad.tolist()) if b]


def lu_capture(dev, shape) -> str:
    """Whether ``torch.linalg.lu_factor_ex`` of a batch of ``shape``
    captures in a CUDA graph (one eager call on the capture's stream
    first), and if so whether a replay on new data equals the eager
    factor bit for bit: why the operator program factors between its two
    graphs."""
    gen = torch.Generator().manual_seed(0)
    n = shape[-1]

    def matrix():
        return (torch.randn(shape, generator=gen) + 20 * torch.eye(n)).to(dev)

    static = matrix()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            torch.linalg.lu_factor_ex(static)
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            out = torch.linalg.lu_factor_ex(static)
    except RuntimeError as e:
        torch.cuda.synchronize()
        return f"not captured ({type(e).__name__}: {str(e).splitlines()[0]})"
    a = matrix()
    static.copy_(a)
    graph.replay()
    want = torch.linalg.lu_factor_ex(a)
    same = _same_bits(out[:2], want[:2])
    return f"captured, a replay on new data {'==' if same else '!='} eager"


def phase_program_graphs(dev, card, graphs, sweep, pb, batch, programs,
                         graft_entry, kernel, diagnostics, WindTunnel,
                         cfg_cls, ops):
    """Phase 20c: the operator build, the standalone inviscid solve and the
    frame diagnostics as CUDA graphs (``viscous.graphs``), from an empty
    cache. Each graphed equals its eager body bit for bit, one capture a
    key and none at a replay: the operator at the polar's bucket (plain
    and smoothed), a parser chunk of 32 lanes with an all-zero lane, the
    batch's lanes and the graft entry's ``fn``; the inviscid solve at the
    walk's fill (32 angles) and at strategy 3 (one angle); the frame at
    384x192 and 2048x1024, after a ``set_u0`` and a ``set_alpha`` too,
    also equal to the float-``u0`` diagnostics, then the tunnel's own
    frames replaying the key. Returns the record for the kernel line."""
    from airfoil_tpu_torch.models import naca4
    graphs._GRAPHS.clear()
    before = dict(graphs.captures)
    cases, fails = {}, []

    def case(label, fn, first, check=None):
        out = _program_case(graphs, fn)
        want_caps = out["captures"] != {} if first else out["captures"] == {}
        wrong = check(out["out"]) if check else ""
        ok = out["same"] and want_caps and not wrong
        log(f"[program graphs] {label}: graph "
            f"{'==' if out['same'] else '!='} eager bit for bit; captures "
            f"{out['captures']}; {out['graph_s'] * 1e3:.3f} ms graphed"
            f"{' (capture included)' if first else ''}, "
            f"{out['eager_s'] * 1e3:.3f} ms eager{wrong} ({card}) "
            f"{'ok' if ok else 'FAIL'}")
        cases[label] = {k: v for k, v in out.items()
                        if k in ("same", "captures", "graph_s", "eager_s")}
        if not ok:
            fails.append(label)
        return out["out"]

    def loop(m, p, t, n=60):
        return torch.as_tensor(np.asarray(naca4(m, p, t, n), np.float32),
                               device=dev)

    # The operator: the polar's bucket, plain and smoothed.
    polar_loops = {"NACA 2412": sweep._pad_coords(loop(2, 4, 12, 95)),
                   "NACA 0015": sweep._pad_coords(loop(0, 0, 15, 95))}
    polar_ops = {}
    for smooth in (False, True):
        for i, (name, c) in enumerate(polar_loops.items()):
            fn = ((lambda: sweep._op_kernel_smoothed(c, N_PANELS)) if smooth
                  else (lambda: sweep._op_kernel(c, N_PANELS)))
            out = case(f"operator, polar bucket (192 points, 160 panels"
                       f"{', smoothed' if smooth else ''}), {name}", fn,
                       i == 0)
            if not smooth:
                polar_ops[name] = out[0]
    # A parser chunk: 32 lanes, one an all-zero loop.
    chunks = ([naca4(m, 4, t, 60) for m in (0, 2, 4) for t in range(6, 36, 3)]
              + [np.zeros((121, 2), np.float32), naca4(2, 4, 12, 60)],
              [naca4(m, 3, t, 60) for m in (1, 3, 5) for t in range(7, 37, 3)]
              + [np.zeros((121, 2), np.float32), naca4(0, 0, 12, 60)])
    degenerate = len(chunks[0]) - 2

    def in_its_lane(op):
        lanes = _lanes_not_finite(graphs.flatten(op)[0])
        return ("" if lanes == [degenerate] else
                f"; lanes not finite {lanes}, want [{degenerate}]")

    for i, loops in enumerate(chunks):
        case(f"operator, parser chunk {i + 1} (32 lanes, 121 points, 128 "
             f"panels, lane {degenerate} all zero)",
             lambda: pb.chunk_operators(pb.resample(loops)[0], dev), i == 0,
             in_its_lane)
    # The batch's lanes: one loop a key.
    for i, pair in enumerate(((naca4(2, 4, 12, 80), naca4(0, 0, 12, 80)),
                              (naca4(4, 4, 12, 80), naca4(2, 4, 15, 80)))):
        case(f"operator, batch pair {i + 1} (one loop of 161 points a key, "
             f"160 panels)", lambda: batch._batch_ops(pair, N_PANELS, dev),
             i == 0)
    # The graft entry's fn: its operator and direct solve.
    fn, args = graft_entry.entry(dev)
    for i, c in enumerate((args[0], loop(0, 0, 12))):
        case(f"graft entry fn (121 points, 128 panels), loop {i + 1}",
             lambda: fn(c, *args[1:]), i == 0)

    # The standalone inviscid solve: the walk's fill and strategy 3.
    for i, (name, lo, hi) in enumerate((("NACA 2412", -10.0, 20.0),
                                        ("NACA 0015", -6.0, 18.0))):
        a32 = torch.linspace(lo, hi, 32, device=dev)
        case(f"inviscid, the walk's fill ({name}, 32 angles "
             f"{lo:g}..{hi:g})",
             lambda: programs.inviscid_program(polar_ops[name], a32), i == 0)
    for i, (code, a) in enumerate((("2412", 19.0), ("0012", 14.0))):
        case(f"inviscid, strategy 3 (NACA {code}, alpha {a:g})",
             lambda: programs.inviscid_program(ops[code], a), i == 0)

    # The frame diagnostics, with a u0 change and a mask change between
    # replays, then the tunnel's own frames.
    for nx, ny in ((384, 192), LARGE):
        cfg = cfg_cls(nx=nx, ny=ny)
        wt = WindTunnel(naca4_coords(), cfg=cfg, device=dev)
        st = wt.state
        step = kernel.lbm_steps_tiled if wt.tiled else kernel.lbm_steps
        for i, change in enumerate(("", "set_u0", "set_alpha")):
            if change == "set_u0":
                wt.set_u0(0.8 * cfg.u0)
            elif change == "set_alpha":
                wt.set_alpha(10.0)
            st.f = step(st.f, st.solid, st.u0, cfg.tau,
                        steps=200 if i == 0 else 40, word=st.word)

            def floats(out):
                old = (*diagnostics.forces_and_separation(
                    st.f, st.solid, st.u0, cfg.chord_cells),
                    *diagnostics.render_fields(st.f, st.solid, st.u0))
                return ("" if _same_bits(graphs.flatten(out)[0], old) else
                        "; != the float-u0 diagnostics")

            case(f"frame {nx}x{ny}{', after ' + change if change else ''} "
                 f"(u0 {st.u0:g}, alpha {st.alpha:g})",
                 lambda: diagnostics.frame_fields(st.f, st.solid, st.u0,
                                                  cfg.chord_cells),
                 i == 0, floats)
        c0 = graphs.total(graphs.captures, "frame")
        r0 = graphs.total(graphs.replays, "frame")
        for _ in range(3):
            wt.frame()
        c1 = graphs.total(graphs.captures, "frame")
        r1 = graphs.total(graphs.replays, "frame")
        log(f"[program graphs] three WindTunnel.frame at {nx}x{ny}: "
            f"{c1 - c0} captures, {r1 - r0} frame replays "
            f"{'ok' if (c1, r1 - r0) == (c0, 3) else 'FAIL'}")
        if (c1, r1 - r0) != (c0, 3):
            fails.append(f"tunnel frames at {nx}x{ny}")
        del wt, st

    new = {k: graphs.captures[k] - before.get(k, 0) for k in graphs.captures
           if graphs.captures[k] != before.get(k, 0)}
    keys = {f"{k[0]} {k[1][1:]}": graphs.pool_bytes[k] for k in new}
    log(f"[program graphs] captures a key in this phase (each 1): "
        f"{sorted(set(new.values()))}; graph pools, bytes by program and "
        f"key: {json.dumps(keys)} ({card})")
    require(not fails, f"program graphs: {fails}")
    require(set(new.values()) == {1}, f"captures a key: {new}")
    require({k[0] for k in new} >= {"operator", "inviscid", "frame"},
            f"programs captured: {sorted({k[0] for k in new})}")
    lu = {str(shape): lu_capture(dev, shape)
          for shape in ((161, 161), (pb.CHUNK, 129, 129))}
    log(f"[program graphs] torch.linalg.lu_factor_ex in a CUDA graph, by "
        f"shape: {json.dumps(lu)} ({card})")
    return {"cases": cases, "pool_bytes": keys, "lu_factor_ex": lu}


def phase_mask_speed(dev, card, masks, cfg_cls, WindTunnel):
    """Host time of the solid mask that ``/lbm/start`` builds at the served
    384x192 and at 2048x1024, by the native scanline (the one
    ``rasterize_airfoil`` takes on this machine) and by the numpy one, and
    of a 2048x1024 ``WindTunnel``'s construction, mask included."""
    coords = naca4_coords()
    big = cfg_cls(nx=LARGE[0], ny=LARGE[1])
    t = {}
    for label, cfg, n in (("384x192", cfg_cls(), 20),
                          (f"{LARGE[0]}x{LARGE[1]}", big, 5)):
        xp, yp = masks._panelise(masks._rotate(coords.astype(np.float64),
                                               6.0))
        domain = (cfg.dx0, cfg.dx1, cfg.dy0, cfg.dy1)
        t[label] = (
            _median_s(lambda: masks.rasterize_airfoil(coords, 6.0, cfg), n),
            _median_s(lambda: masks.raster_mask_numpy(xp, yp, cfg.nx, cfg.ny,
                                                      domain), n))
    t_served = _median_s(lambda: masks.build_mask(coords, 6.0, cfg_cls()), 20)
    t_tunnel = _median_s(lambda: WindTunnel(coords, cfg=big, device=dev), 3)
    log(f"[speed] solid mask (median; rasterize_airfoil takes the "
        f"{masks.rasteriser()} scanline): "
        + ", ".join(f"{g} native {a * 1e3:.3f} ms, numpy {b * 1e3:.3f} ms"
                    for g, (a, b) in t.items())
        + f"; build_mask at 384x192 {t_served * 1e3:.3f} ms; WindTunnel "
        f"construction at {LARGE[0]}x{LARGE[1]} {t_tunnel * 1e3:.3f} ms "
        f"({card})")


def lbm_bound(dev, core, masks, cfg_cls, grid) -> tuple[float, str]:
    """Bound of one ``steps_per_frame``-step LBM call on ``grid``: the
    lattice read and written once and the cell word, which is what the
    kernels read of the mask, read once; the operations of the plain
    step."""
    cfg = cfg_cls(nx=grid[0], ny=grid[1])
    solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0, cfg),
                         device=dev)
    f = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, dev)
    ops = count_ops(core.lbm_step, f, solid, cfg.u0, cfg.tau,
                    steps=cfg.steps_per_frame)
    return bound(2 * nbytes(f) + nbytes(core.cell_word(solid)), ops)


def word_bound(dev, core, masks, cfg_cls) -> tuple[float, str]:
    """Bound of one cell word at the served grid: the mask read once and the
    word written once; the operations of the plain word."""
    solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0,
                                                 cfg_cls()), device=dev)
    return bound(nbytes(solid, core.cell_word(solid)),
                 count_ops(core.cell_word, solid))


BENCH_GOLDENS = os.path.join(ROOT, "tests", "golden", "torch_bench.json")
BENCH_PATHS = ("raw", "parsed")
BENCH_FIELDS = ("cl", "cd", "cm", "sep_fraction", "converged", "xtr_upper",
                "xtr_lower", "plausible")
PROBE_NACA = "2412"
FLOW_ALPHA = 5.0
FLOW_RTOL, FLOW_ATOL = 1e-4, 1e-6
FLOW_CL_TOL = 1e-5


def bench_records(r, plaus) -> dict:
    """One list a field over the lanes of a lane-batched solve."""
    vals = {"cl": r.cl, "cd": r.cd, "cm": r.cm,
            "sep_fraction": r.sep_fraction, "converged": r.converged,
            "xtr_upper": r.upper.x_transition,
            "xtr_lower": r.lower.x_transition, "plausible": plaus}
    return {f: v.cpu().tolist() for f, v in vals.items()}


def _concat(recs: list) -> dict:
    return {f: sum((r[f] for r in recs), []) for f in BENCH_FIELDS}


def flip_count(verdicts: list) -> list:
    """Per member (of three or more), the verdicts on which it differs from
    every other member."""
    return [sum(1 for n in range(len(v))
                if all(v[n] != o[n] for j, o in enumerate(verdicts)
                       if j != i))
            for i, v in enumerate(verdicts)]


def _brief(rec: dict, i: int) -> dict:
    return {f: rec[f][i] for f in ("cl", "cd", "sep_fraction", "converged")}


def phase_parser_bench(dev, card, bgold, pb, corpus, mk, work):
    """The parser benchmark through its entry point (``run_benchmark`` on
    the card) over the golden's corpus, held to the JAX members: O, the
    verdicts off all three members, at most S, the members' own flip rate;
    raw, parsed, rescued and regressed within S of the nominal member's.
    Returns (files, launches, S, O, {path: card records}, the chunk's
    side and wake call shapes, timings)."""
    files = corpus.generate_corpus(os.path.join(work, "corpus"),
                                   n=bgold["corpus"]["n"],
                                   seed=bgold["corpus"]["seed"])
    results, split, lanes = [], {"operators": 0.0, "solves": 0.0}, set()
    orig_ops, orig_solve = pb.chunk_operators, pb.solve_chunk
    orig_side, orig_wake = mk.march_side, mk.march_wake

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            if key == "solves":
                results.append(bench_records(out, pb.plausible(out)))
            return out
        return run

    def shapes(name, fn):
        def run(*args):
            lanes.add((name, tuple(args[0].shape)))
            return fn(*args)
        return run

    pb.chunk_operators = timed("operators", orig_ops)
    pb.solve_chunk = timed("solves", orig_solve)
    mk.march_side = shapes("side", orig_side)
    mk.march_wake = shapes("wake", orig_wake)
    out_dir = os.path.join(work, "parser_benchmark")
    try:
        # The chunk's graph (viscous.graphs) captured afresh with the shape
        # recorder in place, on the corpus's first chunk, before the counts
        # are set to 0 and the clock starts: a replay calls no Python
        # wrapper, and launches the shapes of its capture.
        from airfoil_tpu_torch.viscous import graphs
        for key in [k for k in graphs._GRAPHS
                    if k[0] == "direct" and k[1][1] == (pb.CHUNK,)]:
            del graphs._GRAPHS[key]
        first = [np.asarray(g) if len(g) >= 5 else None
                 for g in map(pb.raw_coords_from_file, files[:pb.CHUNK])]
        orig_solve(orig_ops(pb.resample(first)[0], dev))
        mk.march_launches = mk.wake_launches = 0
        t0 = time.perf_counter()
        summary = pb.run_benchmark(files, out_dir, device=dev)
        wall = time.perf_counter() - t0
        launches = {"bl_march": mk.march_launches,
                    "bl_march_wake": mk.wake_launches}
    finally:
        pb.chunk_operators, pb.solve_chunk = orig_ops, orig_solve
        mk.march_side, mk.march_wake = orig_side, orig_wake
    n_chunks = len(results)
    passes = pb.SOLVE_SHAPE["coupling_iters"] + 1
    require(n_chunks == 2 * -(-len(files) // pb.CHUNK),
            f"{n_chunks} chunks solved")
    require(launches == {"bl_march": passes * n_chunks,
                         "bl_march_wake": passes * n_chunks},
            f"launches {launches}, want {passes} of each a chunk")
    m, mw = pb.SOLVE_SHAPE["n_stations"], pb.SOLVE_SHAPE["n_wake"]
    require(lanes == {("side", (2 * pb.CHUNK, m)), ("wake", (pb.CHUNK, mw))},
            f"march shapes {sorted(lanes)}")
    require(summary["device"] == "cuda" and summary["card"] == card,
            f"summary device {summary['device']}, card {summary['card']}")
    with open(os.path.join(out_dir, "benchmark_results.csv")) as fh:
        rows = list(csv.DictReader(fh))
    require([r["name"] for r in rows] == bgold["names"],
            "the corpus's files differ from the golden's")
    verdict = {p: [r[f"{p}_converged"] == "True" for r in rows]
               for p in BENCH_PATHS}
    half = n_chunks // 2
    recs = {p: {f: v[:len(files)] for f, v in
                _concat(results[i * half:(i + 1) * half]).items()}
            for i, p in enumerate(BENCH_PATHS)}

    ks = [str(k) for k in bgold["members_k"]]
    members = [bgold["members"][k] for k in ks]
    nominal = bgold["members"]["0"]
    s_rate = max(flip_count([sum((mem[p]["verdict"] for p in BENCH_PATHS),
                                 []) for mem in members]))
    require(s_rate == bgold["flip_rate"]["S"], "the golden's S")
    off = []
    for p in BENCH_PATHS:
        for i, name in enumerate(bgold["names"]):
            if all(verdict[p][i] != mem[p]["verdict"][i] for mem in members):
                off.append(f"{name} {p}: card {_brief(recs[p], i)}, nominal "
                           f"member {_brief(nominal[p], i)}, members' "
                           f"verdicts {[mem[p]['verdict'][i] for mem in members]}")
    for line in off:
        log(f"[parser bench] off every member: {line}")
    counts = {key: (summary[key], nominal["summary"][key])
              for key in ("raw_converged", "parsed_converged", "rescued",
                          "regressed")}
    log(f"[parser bench] {len(files)} files through run_benchmark on the "
        f"card: raw {summary['raw_converged']} ({summary['raw_pct']} %), "
        f"parsed {summary['parsed_converged']} ({summary['parsed_pct']} %), "
        f"rescued {summary['rescued']}, regressed {summary['regressed']}, "
        f"multi-element {summary['n_multi_element']}, degenerate "
        f"{summary['degenerate_rejected']} (the JAX nominal member "
        f"{ {k: v[1] for k, v in counts.items()} }, the JAX run itself "
        f"raw {bgold['reference']['summary']['raw_converged']}, parsed "
        f"{bgold['reference']['summary']['parsed_converged']}); verdicts off "
        f"all three members O = {len(off)} of {2 * len(files)}, the "
        f"members' flip rate S = {s_rate} "
        f"({bgold['flip_rate']['per_member']}); wall {wall:.3f} s: "
        f"operators {split['operators']:.3f} s, lane solves "
        f"{split['solves']:.3f} s, the rest (corpus parse, resample, CSV) "
        f"{wall - split['operators'] - split['solves']:.3f} s; {n_chunks} "
        f"chunks of {pb.CHUNK} lanes, {launches['bl_march']} side launches "
        f"of {2 * pb.CHUNK} lanes and {launches['bl_march_wake']} wake "
        f"launches of {pb.CHUNK} ({card})")
    for key, (got, want) in counts.items():
        require(abs(got - want) <= s_rate,
                f"{key} {got}, the nominal member's {want}, S {s_rate}")
    return files, launches, s_rate, off, recs, wall


def _spread_free(vals: list, bars) -> bool:
    """Three members' values of one field within a tenth of its bar (all
    non-finite counts as agreeing)."""
    a = np.asarray(vals, np.float64)
    if not np.isfinite(a).any():
        return True
    if not np.isfinite(a).all():
        return False
    abs_bar, rel_bar = bars
    return bool(a.max() - a.min()
                <= 0.1 * (abs_bar + rel_bar * abs(a[len(a) // 2])))


def _held_lane(rec: dict, ref: dict, i: int) -> list:
    """What fails when lane ``i`` of ``rec`` is held to ``ref``'s at the
    VISCOUS_BARS, with the verdict equal (non-finite in both agrees)."""
    bad = []
    if rec["plausible"][i] != ref["plausible"][i]:
        bad.append(f"verdict {rec['plausible'][i]} != {ref['plausible'][i]}")
    for f, (abs_bar, rel_bar) in VISCOUS_BARS.items():
        a, b = rec[f][i], ref[f][i]
        if not (np.isfinite(a) or np.isfinite(b)):
            continue
        if not abs(a - b) <= abs_bar + rel_bar * abs(b):
            bad.append(f"{f} {a!r} vs {b!r}")
    return bad


def phase_parser_tripped(dev, card, bgold, pb, mk, plain, files):
    """The benchmark's first raw and first parsed chunk tripped at the
    golden's x, graphed as the benchmark solves them: every spread-free
    lane held to the nominal member at VISCOUS_BARS with its verdict; the
    same chunks with the solver's programs eager equal to them bit for
    bit, and every march call of those held to the plain march
    (``hold_recorded_marches``, NaN agreeing with NaN).
    Returns ({kernel: largest abs difference}, one side call, one wake
    call)."""
    from airfoil_tpu_torch.geometry import AirfoilParseError, parse_dat_file
    from airfoil_tpu_torch.viscous import graphs
    first = files[:pb.CHUNK]
    raw = [np.asarray(g) if len(g) >= 5 else None
           for g in map(pb.raw_coords_from_file, first)]
    parsed = []
    for path in first:
        try:
            parsed.append(np.asarray(parse_dat_file(path)[0]))
        except AirfoilParseError:
            parsed.append(None)
    trip = bgold["trip_x"]
    ops = {p: pb.chunk_operators(pb.resample(geoms)[0], dev)
           for p, geoms in zip(BENCH_PATHS, (raw, parsed))}
    recs, graphed = {}, {}
    for p in BENCH_PATHS:
        graphed[p] = pb.solve_chunk(ops[p], x_forced_transition=trip)
        recs[p] = bench_records(graphed[p], pb.plausible(graphed[p]))
    # The same chunks with the solver's programs eager, their marches
    # recorded: equal to the graphed chunks bit for bit.
    with recording(mk) as calls:
        eager = {p: pb.solve_chunk(ops[p], x_forced_transition=trip)
                 for p in BENCH_PATHS}
    flat = {p: (graphs.flatten(graphed[p])[0], graphs.flatten(eager[p])[0])
            for p in BENCH_PATHS}
    same = {p: len(a) == len(b) and _same_bits(a, b)
            for p, (a, b) in flat.items()}
    log(f"[parser tripped] the chunks graphed equal the same chunks with the "
        f"solver's programs eager (marches recorded) bit for bit: {same} "
        f"{'ok' if all(same.values()) else 'FAIL'}")
    require(all(same.values()), f"tripped chunks graphed != eager: {same}")
    held = spread = 0
    bad = []
    for p in BENCH_PATHS:
        members = [bgold["tripped"][str(k)][p] for k in bgold["members_k"]]
        nominal = bgold["tripped"]["0"][p]
        for i in range(pb.CHUNK):
            free = (len({mem["plausible"][i] for mem in members}) == 1
                    and all(_spread_free([mem[f][i] for mem in members],
                                         bars)
                            for f, bars in VISCOUS_BARS.items()))
            if not free:
                spread += 1
                continue
            held += 1
            bad += [f"{p} lane {i} ({os.path.basename(first[i])}): {b}"
                    for b in _held_lane(recs[p], nominal, i)]
    log(f"[parser tripped] the first raw and parsed chunks tripped at x "
        f"{trip}: {held} of {2 * pb.CHUNK} lanes spread-free over the JAX "
        f"members (held to the nominal member at the bars, verdict equal), "
        f"{spread} spread; {len(bad)} off" + (f": {bad}" if bad else ""))
    require(not bad, f"tripped lanes off the nominal member: {bad}")
    n_side = len(calls["march_side"])
    require(n_side == len(calls["march_wake"])
            == 2 * (pb.SOLVE_SHAPE["coupling_iters"] + 1),
            f"{n_side} side calls")
    abs_err, _ = hold_recorded_marches(
        dev, mk, plain, calls["march_side"], calls["march_wake"], 0, 0,
        "the tripped chunks' marches", stage="parser tripped",
        xtr_between=True, nan_equal=True)
    return abs_err, calls["march_side"][0], calls["march_wake"][0]


def phase_parser_speed(dev, card, pb, mk, plain, files, side_call,
                       wake_call):
    """One chunk's wall and device split; the march kernels at the
    benchmark's shapes with their bounds. Returns ({kernel: (ms,
    device ms)}, {kernel: (bound ms, bound by)})."""
    chunk = pb.resample([np.asarray(g) for g in
                         map(pb.raw_coords_from_file, files[:pb.CHUNK])
                         ])[0]

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops = pb.chunk_operators(chunk, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pb.plausible(pb.solve_chunk(ops)).cpu()
        return t1 - t0, time.perf_counter() - t1

    one()
    walls = [one() for _ in range(2)]
    t_ops = statistics.median(w[0] for w in walls)
    t_solve = statistics.median(w[1] for w in walls)
    with traced() as prof:
        one()
    ev = kernel_events(prof, "march_side_kernel", "march_wake_kernel")
    log(f"[parser speed] one chunk ({pb.CHUNK} lanes): operators "
        f"{t_ops:.3f} s, solve {t_solve:.3f} s (median of 2, synchronised); "
        f"profiled: {ev['all'][0]} device kernels, "
        f"{ev['all'][1] / 1e3:.3f} ms of device time (march_side_kernel "
        f"{ev['march_side_kernel'][0]} x, "
        f"{ev['march_side_kernel'][1] / 1e3:.3f} ms; march_wake_kernel "
        f"{ev['march_wake_kernel'][0]} x, "
        f"{ev['march_wake_kernel'][1] / 1e3:.3f} ms): device busy "
        f"{ev['all'][1] / 1e3 / ((t_ops + t_solve) * 1e3):.1%} of the "
        f"wall ({card})")
    times = {"bl_march": (cuda_ms(lambda: mk.march_side(*side_call), 20),
                          device_ms(lambda: mk.march_side(*side_call), 10,
                                    "march_side_kernel")),
             "bl_march_wake": (cuda_ms(lambda: mk.march_wake(*wake_call),
                                       20),
                               device_ms(lambda: mk.march_wake(*wake_call),
                                         10, "march_wake_kernel"))}
    bounds = {"bl_march": side_march_bound(mk, plain, side_call)[0],
              "bl_march_wake": wake_march_bound(mk, plain, wake_call)[0]}
    for name, shape in (("bl_march", tuple(side_call[0].shape)),
                        ("bl_march_wake", tuple(wake_call[0].shape))):
        log(f"[parser speed] {name} at {shape[0]} lanes x {shape[1]} "
            f"stations: {times[name][0]:.4f} ms (CUDA events, mean of 20), "
            f"device {times[name][1]:.4f} ms, bound "
            f"{bounds[name][0] * 1e3:.3f} us ({bounds[name][1]}) ({card})")
    return times, bounds


def phase_probe(dev, card, bgold, probe, naca4, parse_dat_file, files):
    """``probe_strategies`` on the card for NACA 2412 and the corpus's
    second file (af0001): each row bit-equal to the port's own solve with
    its plan; returns the rows' verdicts off all three JAX members."""
    targets = {"naca2412": np.asarray(naca4(2, 4, 12, 100))}
    targets[os.path.basename(files[1])] = np.asarray(
        parse_dat_file(files[1])[0])
    require(list(targets) == list(bgold["probe"]), "the probe's airfoils")
    off = []
    for name, coords in targets.items():
        solved = []
        orig = probe._solve_with

        def kept(*args, **kwargs):
            solved.append(orig(*args, **kwargs))
            return solved[-1]

        probe._solve_with = kept
        try:
            t0 = time.perf_counter()
            rows = probe.probe_strategies(coords, 5.0, 2e5, device=dev)
            wall = time.perf_counter() - t0
        finally:
            probe._solve_with = orig
        require([r["strategy"] for r in rows] == list(probe.STRATEGIES)
                 and len(solved) == len(rows), f"{name}: probe rows {rows}")
        members = bgold["probe"][name]
        parts = []
        for row, res in zip(rows, solved):
            st = row["strategy"]
            again = probe._solve_with(coords, 5.0, 2e5, device=dev,
                                      **probe.PLANS[st])
            fields = ("cl", "cd", "cm", "sep_fraction", "converged")
            require(_same_bits([getattr(res, f) for f in fields],
                               [getattr(again, f) for f in fields]),
                    f"{name} {st}: the row's solve differs from the plan's")
            require(row["CL"] == round(float(res.cl), 4)
                    and row["CD"] == round(float(res.cd), 5),
                    f"{name} {st}: row {row}")
            mem = [members[str(k)][st] for k in bgold["members_k"]]
            if all(row["converged"] != m["converged"] for m in mem):
                off.append(f"{name} {st}: card {row}, members "
                           f"{[(m['converged'], m['cl'], m['cd']) for m in mem]}")
            parts.append(
                f"{st} {row['converged']} CL {row['CL']} CD {row['CD']} "
                f"(members {[m['converged'] for m in mem]}, CL "
                f"{[round(m['cl'], 4) for m in mem]}, CD "
                f"{[round(m['cd'], 5) for m in mem]})")
        log(f"[probe] {name}: {wall:.3f} s for {len(rows)} strategies, each "
            f"row bit-equal to its plan's solve; " + "; ".join(parts)
            + f" ({card})")
    for line in off:
        log(f"[probe] off every member: {line}")
    return off


def phase_flow_field(dev, card, flowfield, naca4):
    """``compute_flow_field`` of NACA 2412 at alpha 5 on the card against
    the port's CPU run: u and v within FLOW_RTOL (FLOW_ATOL), CL within
    FLOW_CL_TOL, the same streamline count. Returns the card's field."""
    coords = np.asarray(naca4(2, 4, 12, 100))
    t0 = time.perf_counter()
    ff = flowfield.compute_flow_field(coords, FLOW_ALPHA, device=dev)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = flowfield.compute_flow_field(coords, FLOW_ALPHA, device="cpu")
    wall_cpu = time.perf_counter() - t0
    for f in ("u", "v"):
        a, b = getattr(ff, f), getattr(ref, f)
        require(np.array_equal(np.isnan(a), np.isnan(b))
                and np.allclose(a, b, rtol=FLOW_RTOL, atol=FLOW_ATOL,
                                equal_nan=True),
                f"flow field {f}: max abs "
                f"{np.nanmax(np.abs(a - b)):.3e}")
    require(abs(ff.cl - ref.cl) <= FLOW_CL_TOL, f"CL {ff.cl} vs {ref.cl}")
    require(len(ff.streamlines) == len(ref.streamlines),
            f"{len(ff.streamlines)} streamlines, CPU {len(ref.streamlines)}")
    g = len(ff.x)
    log(f"[flow field] NACA 2412 alpha {FLOW_ALPHA}, {g} x {g} grid: wall "
        f"{wall:.3f} s on the card (CPU run {wall_cpu:.3f} s); CL "
        f"{ff.cl:.6f} (CPU {ref.cl:.6f}), cp_min {ff.cp_min:.4f}, "
        f"{int(np.isnan(ff.u).sum())} masked points, {len(ff.streamlines)} "
        f"streamlines; u and v within rtol {FLOW_RTOL} (atol {FLOW_ATOL}) "
        f"of the CPU run's, max abs "
        f"{max(np.nanmax(np.abs(ff.u - ref.u)), np.nanmax(np.abs(ff.v - ref.v))):.3e} ({card})")
    return ff


# ── The multi-device paths (phases 26-28) ──────────────────────────────────

PARALLEL_GOLDENS = os.path.join(ROOT, "tests", "golden", "torch_parallel.json")
SHARDED_GRIDS = [(640, 384), (2048, 1024)]     # (nx, ny)
SHARDED_PLANS = [(13, 5), (128, 8)]             # (steps, halo_steps)
SHARDED_RANKS = [(1, "nccl"), (4, "gloo")]      # (ranks, backend)
SHARDED_SEED = 26
LBM_KERNELS = ("lbm_steps", "lbm_steps_tiled", "cell_word")
MARCH_KERNELS = ("bl_march", "bl_march_wake")
ENTRY_BARS = {f: VISCOUS_BARS[f] for f in ("cl", "cd", "cm")}


def launch_counts() -> dict:
    """This process's launch count of every kernel."""
    from airfoil_tpu_torch.api import field_b64
    from airfoil_tpu_torch.lbm import kernel
    from airfoil_tpu_torch.viscous import kernel as mk
    return {"lbm_steps": kernel.launches,
            "lbm_steps_tiled": kernel.tiled_launches,
            "cell_word": kernel.word_launches,
            "bl_march": mk.march_launches, "bl_march_wake": mk.wake_launches,
            "field_b64": field_b64.launches}


def zero_launch_counts():
    from airfoil_tpu_torch.api import field_b64
    from airfoil_tpu_torch.lbm import kernel
    from airfoil_tpu_torch.viscous import kernel as mk
    kernel.launches = kernel.tiled_launches = kernel.word_launches = 0
    mk.march_launches = mk.wake_launches = 0
    field_b64.launches = 0


def _ranks_synced(mesh):
    """Every rank's card idle and every rank here."""
    import torch.distributed as dist
    torch.cuda.synchronize(mesh.device)
    if mesh.size > 1:
        dist.barrier()


def _gathered(mesh, obj) -> list:
    import torch.distributed as dist
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def _sharded_lbm_cases(mesh) -> list:
    """Phase 26 on one rank: every grid and step plan through
    ``sharded_lbm_steps``, the launch counts set to 0 just before each
    run and read just after; a second run timed; the gathered lattice
    compared on rank 0 with the unsharded kernel's output and with the
    plain step's on the same inputs."""
    from airfoil_tpu_torch.config import LBMConfig
    from airfoil_tpu_torch.lbm import core, kernel, masks
    from airfoil_tpu_torch.lbm.sharded import gather_rows, sharded_lbm_steps

    dev = mesh.device
    cases = []
    for nx, ny in SHARDED_GRIDS:
        cfg = LBMConfig(nx=nx, ny=ny)
        solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0, cfg),
                             device=dev)
        f0 = noisy_state(core, cfg, dev, np.random.default_rng(SHARDED_SEED))
        rows = ny // mesh.size
        for steps, halo in SHARDED_PLANS:
            h = max(1, min(halo, steps, rows))
            n_rounds = steps // h + (1 if steps % h else 0)
            tiled = kernel.prefers_tiled(rows + 2 * h, nx,
                                         *kernel.device_limits(dev))

            def run():
                return sharded_lbm_steps(mesh, f0, solid, cfg.u0, cfg.tau,
                                         steps, halo_steps=h)
            _ranks_synced(mesh)
            zero_launch_counts()
            block = run()
            _ranks_synced(mesh)
            counts = launch_counts()
            t0 = time.perf_counter()
            run()
            _ranks_synced(mesh)
            wall = time.perf_counter() - t0
            full = gather_rows(mesh, block)
            rec = {"grid": [nx, ny], "steps": steps, "halo": h,
                   "rounds": n_rounds, "tiled": tiled,
                   "ms_round": wall * 1e3 / n_rounds,
                   "launches": _gathered(mesh, counts)}
            if mesh.rank == 0:
                whole = kernel.lbm_steps_tiled if kernel.prefers_tiled(
                    ny, nx, *kernel.device_limits(dev)) else kernel.lbm_steps
                ref = whole(f0, solid, cfg.u0, cfg.tau, steps)
                torch.cuda.synchronize()
                rec["equal"] = bool(torch.equal(full, ref))
                rec["max_abs"] = float((full - ref).abs().max())
                plain = core.lbm_step(f0, solid, cfg.u0, cfg.tau, steps)
                rec["plain_max_abs"] = float((full - plain).abs().max())
                rec["plain_held"] = bool(torch.allclose(
                    full, plain, rtol=2e-5, atol=2e-6))
                del ref, plain
            cases.append(rec)
            del block, full
    return cases


def _gloo_cuda_gather(mesh):
    """Whether gloo's ``all_gather`` takes CUDA tensors (the port stages
    them through host memory either way)."""
    import torch.distributed as dist
    if mesh.backend != "gloo":
        return None
    t = torch.full((2,), float(mesh.rank), device=mesh.device)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    try:
        dist.all_gather(parts, t)
    except Exception as exc:              # noqa: BLE001
        return f"refused: {type(exc).__name__}: {str(exc)[:160]}"
    torch.cuda.synchronize()
    ok = all(float(p[0]) == r for r, p in enumerate(parts))
    return f"taken, {'right' if ok else 'WRONG'} values"


def sharded_rank(mesh, polar_args):
    """One rank of phases 26 and 27: the sharded LBM cases, then the
    sharded polar (counts set to 0 just before, read just after), each
    rank's wall, stage split, walk solves and launches gathered."""
    from airfoil_tpu_torch.parallel import mesh as pmesh
    from airfoil_tpu_torch.polar import sweep

    lbm = _sharded_lbm_cases(mesh)
    coords, alphas, re = polar_args
    _ranks_synced(mesh)
    sweep.walk_solves.update(cont=0, trip=0)
    zero_launch_counts()
    t0 = time.perf_counter()
    out = pmesh.sharded_polar(mesh, coords, alphas, re)
    own = time.perf_counter() - t0
    counts = launch_counts()
    _ranks_synced(mesh)
    wall = time.perf_counter() - t0
    ranks = _gathered(mesh, {"rank": mesh.rank, "wall": own,
                             "split": dict(pmesh.stage_seconds),
                             "walk": dict(sweep.walk_solves),
                             "launches": counts})
    return {"lbm": lbm, "polar": out, "polar_wall": wall,
            "polar_ranks": ranks, "gloo_cuda_gather": _gloo_cuda_gather(mesh)}


VERDICTS = ("mode", "converged")


def members_spread(members) -> float:
    """The largest distance, in bars (``nearest_member``), from one of the
    reference's members at a point to the nearest other member with its
    verdicts: how far the reference's own rounding ensemble puts one run
    from all the others there. A member alone in its verdicts has no such
    neighbour and is passed over."""
    worst = 0.0
    for i, m in enumerate(members):
        rest = [(j, o) for j, o in enumerate(members)
                if j != i and all(o[f] == m[f] for f in VERDICTS)]
        if rest:
            worst = max(worst, nearest_member(m, rest)[0])
    return worst


def held_to_spread(rec: dict, golden: dict) -> tuple[list, str]:
    """A polar point ``rec`` against the reference's ensemble ``golden``:
    held by ``held_to_polar`` (jointly to one member with its verdicts, or
    the knife edge); else it must share the verdicts of one member and lie
    no farther from its nearest such member than ``members_spread``: a
    rounding basin no member reached, but no farther off the ensemble than
    the reference's own members lie off one another. Returns (failures,
    note)."""
    fails, note = held_to_polar(rec, golden)
    cands = [(i, m) for i, m in enumerate(golden["members"])
             if all(m[f] == rec[f] for f in VERDICTS)]
    if not fails or not cands:
        return fails, note
    d, i = nearest_member(rec, cands)
    spread = members_spread(golden["members"])
    note = (f"held by no member: nearest member {i} at {d:.3f} bars, the "
            f"members' own spread {spread:.3f} bars")
    if d <= spread:
        return [], note
    return [f"off every member by more than the members' spread ({note})"
            ], note


def _summed(per_rank: list) -> dict:
    return {k: sum(c[k] for c in per_rank) for k in per_rank[0]}


def phase_sharded_lbm(card, results) -> dict:
    """Phase 26: every sharded LBM case held to the plain step on the same
    inputs and compared bit for bit with the unsharded kernel's output,
    through the kernel that holds its extended block, one launch a round
    on every rank and one word launch a rank. Returns {kernel: {ranks:
    launches}} and the largest difference from the unsharded kernel."""
    launches = {k: {} for k in LBM_KERNELS}
    worst = 0.0
    for n, backend in SHARDED_RANKS:
        res = results[n]
        for k in LBM_KERNELS:
            launches[k][n] = 0
        for case in res["lbm"]:
            total = _summed(case["launches"])
            used = "lbm_steps_tiled" if case["tiled"] else "lbm_steps"
            other = "lbm_steps" if case["tiled"] else "lbm_steps_tiled"
            for k in LBM_KERNELS:
                launches[k][n] += total[k]
            nx, ny = case["grid"]
            label = (f"{nx}x{ny} over {n} rank(s) ({backend}), "
                     f"{case['steps']} steps in rounds of {case['halo']}")
            require(all(c[used] == case["rounds"] and c[other] == 0
                        and c["cell_word"] == 1 for c in case["launches"]),
                    f"sharded LBM {label}: launches a rank "
                    f"{case['launches']}, want {case['rounds']} of {used}, "
                    f"none of {other}, one cell word")
            worst = max(worst, case["max_abs"])
            require(case["plain_held"],
                    f"sharded LBM {label}: off the plain step (max abs "
                    f"{case['plain_max_abs']:.3e}; the unsharded kernel "
                    f"{case['max_abs']:.3e})")
            verdict = (f"within rtol 2e-5, atol 2e-6 of the plain step "
                       f"(max abs {case['plain_max_abs']:.3e}); "
                       + ("equal to the unsharded kernel bit for bit"
                          if case["equal"] else
                          f"NOT bit-equal to the unsharded kernel (max abs "
                          f"{case['max_abs']:.3e})"))
            log(f"[sharded lbm] {label}: {used} on every extended block "
                f"({ny // n + 2 * case['halo']}x{nx}), launches a rank "
                f"{[c[used] for c in case['launches']]} (+1 cell word), "
                f"{case['ms_round']:.3f} ms a round (wall of the second "
                f"call, synchronised); {verdict} ({card})")
        if backend == "gloo":
            log(f"[sharded lbm] gloo all_gather of CUDA tensors on {n} "
                f"rank(s): {res['gloo_cuda_gather']}")
        else:
            log(f"[sharded lbm] {n} rank ({backend}): no collective ran (the "
                f"halo exchange is a local copy, the gather the rank's own "
                f"block); only the group's set-up was {backend}'s")
    return launches, worst


def phase_sharded_polar(card, dev, results, gpar, sweep, newton, single,
                        single_wall) -> dict:
    """Phase 27: the sharded polar of the golden points at 1 and 4 ranks,
    each point held jointly to one member of the reference's ensemble on as
    many devices (``held_to_polar``); every block's lanes at the
    reference's own final states (``held_from_states``); each rank's
    launches against its walk solves; each rank's stage split; beside them
    ``single``, phase 17's single-process ``solve_polar`` of the same
    points, and its wall. Returns {kernel: {ranks: launches}}.

    With 9 members a point's joint hold is a draw: the reference's own
    members often lie off all their others. So a point that no member
    holds passes only with the verdicts of one member and within the
    members' own spread at that point (``held_to_spread``); every point's
    distance is logged."""
    g = gpar["polar"]
    coords = np.asarray(naca4_coords(*g["naca"]), np.float32)
    launches = {k: {} for k in MARCH_KERNELS}
    per_pass = POINTS_SHAPE["warm_iters"] + 2
    per_cont = CONT_SHAPE["warm_iters"] + 2
    fails = []
    for n, backend in SHARDED_RANKS:
        res = results[n]
        gm = g["meshes"][str(n)]
        for i, pg in enumerate(gm["points"]):
            rec = {"alpha": pg["alpha"]}
            for j, f in enumerate(("cl", "cd", "cdp", "cm", "mode",
                                   "converged", "xtr_upper", "xtr_lower",
                                   "sep_fraction")):
                v = res["polar"][j][i]
                rec[f] = (int(v) if f == "mode" else bool(v)
                          if f == "converged" else float(v))
            f, note = held_to_spread(rec, pg)
            fails += [f"{n} rank(s), alpha {pg['alpha']:g}: {x}" for x in f]
            log(f"[sharded polar] {n} rank(s), alpha {pg['alpha']:g}: "
                f"{json.dumps(rec)}; ensemble {json.dumps(pg['ensemble'])}; "
                f"{note} {'ok' if not f else 'FAIL'}")
        for k in MARCH_KERNELS:
            launches[k][n] = sum(r["launches"][k] for r in res["polar_ranks"])
        for r in res["polar_ranks"]:
            n_walk = r["walk"]["cont"] + r["walk"]["trip"]
            passes = r["launches"]["bl_march_wake"] - n_walk
            require(passes in (1, 2) and r["launches"]["bl_march"]
                    == per_pass * passes + per_cont * n_walk,
                    f"sharded polar, rank {r['rank']} of {n}: launches "
                    f"{r['launches']}, walk solves {r['walk']}")
            s = r["split"]
            log(f"[sharded polar] {n} rank(s) ({backend}), rank "
                f"{r['rank']}: {r['wall']:.3f} s (points pass "
                f"{s['points']:.3f}, walk {s['walk']:.3f}, rescue "
                f"{s['rescue']:.3f}{'' if passes == 2 else ' (skipped)'}, "
                f"select {s['select']:.3f}, gather {s['gather']:.3f}); walk "
                f"{r['walk']['cont']} continuation and {r['walk']['trip']} "
                f"trip solves; march launches {r['launches']['bl_march']} "
                f"side + {r['launches']['bl_march_wake']} wake ({card})")
        log(f"[sharded polar] {n} rank(s) ({backend}): {res['polar_wall']:.3f} "
            f"s wall (the slowest rank), modes "
            f"{res['polar'][4].tolist()} ({card})")
    op, _xp, _yp = sweep._op_kernel(torch.as_tensor(coords, device=dev),
                                    g["n_panels"])
    for n, _backend in SHARDED_RANKS:
        for b, block in enumerate(g["meshes"][str(n)]["blocks"]):
            held_from_states(newton, op, block, g["re"], dev,
                             f"the sharded polar's block {b} of {n}")
    require(not fails, f"sharded polar: {fails}")
    log(f"[sharded polar] single-process solve_polar of the same "
        f"{len(g['alphas'])} points (a bucket of "
        f"{sweep._bucket_size(len(g['alphas']))} lanes; phase 17's): "
        f"{single_wall:.3f} s wall, "
        f"modes {single.mode.tolist()}; sharded over 1 rank "
        f"{results[1]['polar_wall']:.3f} s, over 4 ranks sharing the card "
        f"{results[4]['polar_wall']:.3f} s ({card})")
    return launches


def phase_graft_entry(card, gpar, graft_entry):
    """Phase 28: ``graft_entry.entry()`` on the card, its [cl, cd, cm]
    held jointly to one member of the reference's ensemble, 13 + 13 march
    launches; then ``dryrun_multichip(4, backend="gloo")``. Returns the
    entry's launches."""
    ge = gpar["entry"]
    fn, args = graft_entry.entry()
    require(all(a.device.type == "cuda" for a in args),
            f"entry's arguments on {[str(a.device) for a in args]}")
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    rec = dict(zip(("cl", "cd", "cm"), out.tolist()))
    d, i = nearest_member(rec, list(enumerate(ge["members"])), ENTRY_BARS)
    n_pass = ge["coupling_iters"] + 1
    log(f"[graft entry] entry(): NACA 2412 alpha 5 at 128 panels, 48 "
        f"stations, 12 passes: {json.dumps(rec)} in {wall:.3f} s; ensemble "
        f"{json.dumps(ge['ensemble'])}; nearest member {i} at {d:.3f} bars "
        f"(CL 0.025, CD 5 %, Cm 0.01); march launches "
        f"{counts['bl_march']} side + {counts['bl_march_wake']} wake "
        f"{'ok' if d <= 1.0 else 'FAIL'} ({card})")
    require(d <= 1.0, f"graft entry {rec} off every member jointly "
            f"(nearest {i} at {d:.3f} bars)")
    require(counts["bl_march"] == n_pass and counts["bl_march_wake"] == n_pass,
            f"graft entry launches {counts}, want {n_pass} + {n_pass}")
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(4, backend="gloo")
    log(f"[graft entry] dryrun_multichip(4, backend='gloo'): "
        f"{time.perf_counter() - t0:.3f} s ({card})")
    return {k: counts[k] for k in MARCH_KERNELS}


# ── the models, the headline bench and the heatmap (phases 29-31) ─────────

# (mu_x, mu_y, alpha): tests/test_inviscid.py's exact Joukowski cases.
JOUKOWSKI_CASES = [(-0.08, 0.0, 0.0), (-0.08, 0.0, 5.0),
                   (-0.08, 0.04, 4.0), (-0.12, 0.06, 8.0)]
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# Phase 30's traced call, run by ``python -c TRACE_CHILD LOG_DIR`` from the
# checkout's root.
TRACE_CHILD = """
import sys
import torch
from airfoil_tpu_torch.config import LBMConfig
from airfoil_tpu_torch.lbm import core, kernel, masks
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.utils import profiling

cfg = LBMConfig(nx=640, ny=384)
dev = torch.device("cuda")
solid = torch.tensor(masks.rasterize_airfoil(naca4(2, 4, 12, 60), 6.0, cfg),
                     device=dev)
word = kernel.cell_word(solid)
f = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, dev)
kernel.lbm_steps(f, solid, cfg.u0, cfg.tau, steps=128, word=word)
torch.cuda.synchronize()
with profiling.profile_trace(log_dir=sys.argv[1]):
    kernel.lbm_steps(f, solid, cfg.u0, cfg.tau, steps=128, word=word)
    torch.cuda.synchronize()
"""


def phase_models(dev, card, models, paneling, inviscid):
    """Phase 29: the exact Joukowski cases on the card, 160 panels from the
    card's own ``repanel`` of the port's ``joukowski``: CL within 1.5 % of
    the closed form (|CL| < 5e-3 at zero lift), Cp rms < 0.035 for x <
    0.98, and CL and Cm within 1e-4 relative + 1e-5 of the port's CPU solve
    of the same nodes (at the cusp a 1-ulp move of a node moves CL by up to
    2.8e-4, so the CPU solve takes the card's nodes)."""
    for mx, my, alpha in JOUKOWSKI_CASES:
        xp, yp = paneling.repanel(models.joukowski(mx, my, 401), N_PANELS,
                                  device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        op = inviscid.build_operator(paneling.panel_geometry(xp, yp))
        sol = inviscid.solve_inviscid(op, alpha)
        cl = float(sol.cl)
        ms = (time.perf_counter() - t0) * 1e3
        cpu = inviscid.solve_inviscid(inviscid.build_operator(
            paneling.panel_geometry(xp.cpu(), yp.cpu())), alpha)
        ex = models.joukowski_exact(mx, my, alpha, n=2001)
        if abs(ex["cl"]) < 1e-6:
            exact_ok, cl_err = abs(cl) < 5e-3, abs(cl)
        else:
            cl_err = abs(cl / ex["cl"] - 1.0)
            exact_ok = cl_err < 0.015
        xm, ym = op.pan.xm.cpu().numpy(), op.pan.ym.cpu().numpy()
        d = np.hypot(ex["x"][None] - xm[:, None], ex["y"][None] - ym[:, None])
        err = sol.cp.cpu().numpy() - ex["cp"][d.argmin(1)]
        rms = float(np.sqrt(np.mean(err[xm < 0.98] ** 2)))
        diffs = {f: (float(getattr(sol, f)), float(getattr(cpu, f)))
                 for f in ("cl", "cm")}
        cpu_ok = all(abs(a - b) <= 1e-4 * abs(b) + 1e-5
                     for a, b in diffs.values())
        ok = exact_ok and rms < 0.035 and cpu_ok
        log(f"[models] Joukowski mu ({mx:g}, {my:g}) alpha {alpha:g}: CL "
            f"{cl:.6f} (exact {ex['cl']:.6f}, "
            f"{'abs' if abs(ex['cl']) < 1e-6 else 'rel'} error {cl_err:.3e}),"
            f" Cp rms {rms:.4f} for x < 0.98; CPU solve of the same nodes: "
            + ", ".join(f"{f} {b:.6f} (diff {abs(a - b):.2e})"
                        for f, (a, b) in diffs.items())
            + f"; operator + solve {ms:.1f} ms on the card "
            f"{'ok' if ok else 'FAIL'} ({card})")
        require(ok, f"Joukowski ({mx}, {my}, {alpha}): CL error {cl_err}, "
                    f"Cp rms {rms}, card vs CPU {diffs}")


def phase_headline(dev, card, headline, profiling, kernel, core, masks,
                   cfg_cls, polar_res, polar_wall, polar_launches,
                   polar_graphs, work):
    """Phase 30: the headline bench's two records on the card. Line 2 from
    ``bench_lbm`` at its three grids, each run through the kernel that
    holds the grid (``lbm_steps`` at 640x384 and 384x192,
    ``lbm_steps_tiled`` at 2048x1024) with warm-up + n_calls launches of it,
    none of the other and one ``cell_word``; line 1 from phase 17's
    ``solve_polar`` result and wall, no new solve, its mode counts those of
    phase 17's modes. Then ``stage_timer`` around one 128-step call at
    640x384 must read at least that call's CUDA-event time, and a
    ``profile_trace`` around one call (in a child process) must write a
    trace that names the resident LBM kernel. Returns {kernel: launches in line 2's runs}, the
    counts set to 0 just before them and read just after."""
    zero_launch_counts()
    runs = headline.bench_lbm(device=dev)
    counts = launch_counts()
    launches = dict.fromkeys((*LBM_KERNELS, "field_b64"), 0)
    for name, kw in headline.LBM_GRIDS:
        r = runs[name]
        used = "lbm_steps_tiled" if name == "tiled" else "lbm_steps"
        other = "lbm_steps" if name == "tiled" else "lbm_steps_tiled"
        want = {used: 1 + kw["n_calls"], other: 0, "cell_word": 1}
        require(r["finite"] and r["kernel"] and r["platform"] == "gpu"
                and r["tiled"] == (name == "tiled")
                and r["launches"] == want and r["launches"][used] > 0,
                f"headline LBM {name}: {r}, want launches {want}")
        for k, n in r["launches"].items():
            launches[k] += n
    require(counts == dict(launches, bl_march=0, bl_march_wake=0),
            f"headline LBM launches {counts}, its runs' {launches}")
    line2 = headline.lbm_record(runs, dev, card)
    log(f"[headline] line 2: {json.dumps(line2)}")
    modes = np.asarray(polar_res.mode)
    polar = dict(headline.polar_stats(polar_res, polar_wall), reps=1,
                 warmup_seconds=None, launches=polar_launches,
                 lm_graphs=polar_graphs["lm"], solver_graphs=polar_graphs)
    line1 = headline.polar_record(polar, dev, card)
    want_modes = {"viscous": int(np.sum(modes == 0)),
                  "viscous_smoothed": int(np.sum(modes == 1)),
                  "inviscid": int(np.sum(modes == 2))}
    require(line1["extra"]["mode_counts"] == want_modes
            and line1["extra"]["n_points"] == len(modes)
            and line1["extra"]["platform"] == "gpu"
            and all(n > 0 for n in polar_launches.values()),
            f"headline line 1 from phase 17: {line1}, modes {modes}")
    log(f"[headline] line 1 from phase 17's polar (no new solve): "
        f"{json.dumps(line1)}")

    cfg = cfg_cls(nx=640, ny=384)
    solid = torch.tensor(masks.rasterize_airfoil(naca4_coords(), 6.0, cfg),
                         device=dev)
    word = kernel.cell_word(solid)
    f = core.equilibrium_init(cfg.ny, cfg.nx, cfg.u0, dev)

    def call():
        return kernel.lbm_steps(f, solid, cfg.u0, cfg.tau, steps=128,
                                word=word)

    call()
    timings = profiling.Timings()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profiling.stage_timer(timings, "lbm_steps"):
        start.record()
        call()
        end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end)
    stage_ms = timings.stages["lbm_steps"] * 1e3
    log(f"[headline] stage_timer around one 128-step lbm_steps call at "
        f"640x384: {stage_ms:.4f} ms; CUDA events {event_ms:.4f} ms "
        f"{'ok' if stage_ms >= event_ms else 'FAIL'} ({card})")
    require(stage_ms >= event_ms,
            f"stage_timer {stage_ms} ms < CUDA events {event_ms} ms")
    # Late in this long process the profiler has dropped the kernel's record
    # from three padded windows of one call, which a young process traces:
    # the trace is taken in a child process.
    log_dir = os.path.join(work, "trace")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", TRACE_CHILD, log_dir],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
    require(child.returncode == 0, f"profile_trace child: {child.stderr}")
    paths = sorted(os.listdir(log_dir))
    require(len(paths) == 1 and paths[0].endswith(".json"),
            f"profile_trace wrote {paths}")
    with open(os.path.join(log_dir, paths[0])) as fh:
        events = json.load(fh)["traceEvents"]
    names = {str(e.get("name", "")) for e in events}
    named = any("lbm_resident_kernel" in n for n in names)
    log(f"[headline] profile_trace around one 128-step call at 640x384 (a "
        f"child process, {time.perf_counter() - t0:.1f} s): {paths[0]}, "
        f"{len(events)} events, kernels "
        f"{sorted(kernel_name(n) for n in names if '_kernel' in n)} "
        f"{'ok' if named else 'FAIL'} ({card})")
    require(named, "profile_trace's trace does not name the LBM kernel")
    return launches


def phase_flowviz(card, field):
    """Phase 31: ``render_heatmap_png`` of phase 25's card field must
    decode as a PNG. Without matplotlib (an optional package) the phase
    says so and checks nothing."""
    try:
        import matplotlib.image as mpimg
    except ImportError:
        log("[flowviz] skipped: no matplotlib")
        return
    from airfoil_tpu_torch.ui import flowviz
    t0 = time.perf_counter()
    b64 = flowviz.render_heatmap_png(field)
    wall = time.perf_counter() - t0
    png = base64.b64decode(b64)
    require(png[:8] == PNG_MAGIC, "the heatmap is not a PNG")
    pixels = mpimg.imread(io.BytesIO(png), format="png")
    colours = len(np.unique(pixels.reshape(-1, pixels.shape[-1]), axis=0))
    require(pixels.ndim == 3 and min(pixels.shape[:2]) > 100
            and colours > 50,
            f"heatmap of {pixels.shape} with {colours} colours")
    log(f"[flowviz] render_heatmap_png of phase 25's {len(field.x)} x "
        f"{len(field.x)} card field: {len(png)} B PNG, "
        f"{pixels.shape[1]} x {pixels.shape[0]} pixels, {colours} colours, "
        f"{wall:.3f} s ({card})")


# The server entry's child: ``airfoil_tpu_torch.api.server`` run as
# ``python -m`` runs it (``runpy``, as ``__main__``), with one addition: on
# SIGUSR1 its kernel launch counts are written to $CHIP_SMOKE_COUNTS and
# set to 0, so the parent reads the requests' launches apart from the
# warm-up's.
ENTRY_CHILD = r"""
import json, os, runpy, signal

def counts(signum, frame):
    from airfoil_tpu_torch.api import field_b64
    from airfoil_tpu_torch.lbm import kernel
    from airfoil_tpu_torch.viscous import kernel as mk
    out = {"lbm_steps": kernel.launches, "cell_word": kernel.word_launches,
           "lbm_steps_tiled": kernel.tiled_launches,
           "bl_march": mk.march_launches, "bl_march_wake": mk.wake_launches,
           "field_b64": field_b64.launches}
    kernel.launches = kernel.word_launches = kernel.tiled_launches = 0
    mk.march_launches = mk.wake_launches = field_b64.launches = 0
    path = os.environ["CHIP_SMOKE_COUNTS"]
    with open(path + ".tmp", "w") as fh:
        json.dump(out, fh)
    os.replace(path + ".tmp", path)

signal.signal(signal.SIGUSR1, counts)
runpy.run_module("airfoil_tpu_torch.api.server", run_name="__main__",
                 alter_sys=True)
"""
ENTRY_FRAMES = 5
ENTRY_WARMUP_S = 300


def _child_counts(child, path: str) -> dict:
    """The child's launch counts since the last call (SIGUSR1)."""
    if os.path.exists(path):
        os.remove(path)
    child.send_signal(signal.SIGUSR1)
    deadline = time.monotonic() + 30
    while not os.path.exists(path):
        require(child.poll() is None and time.monotonic() < deadline,
                "the server entry wrote no launch counts")
        time.sleep(0.05)
    with open(path) as fh:
        return json.load(fh)


def phase_native(card, masks, native, cfg_cls, parse_dat_text,
                 parse_error, files, t_start: float):
    """Phase 32a: ``g++`` built ``libfastgeo`` from the checkout's source
    into ``_build/`` in this run; ``rasterize_airfoil`` takes it; its masks
    equal the numpy scanline's element for element at 384x192 and
    2048x1024, and its parse the Python parser's on the 500-file corpus
    (error text, coordinates, fixes). Returns nothing; logs the times."""
    from airfoil_tpu_torch import cuda_build
    require(shutil.which("g++") is not None, "no g++ on this machine")
    require(native.native_available(), "the native library did not load")
    lib = os.path.join(cuda_build.BUILD_DIR, "libfastgeo.so")
    require(native.get_lib()._name == lib and
            os.path.getmtime(lib) >= t_start,
            f"libfastgeo not built in this run into {cuda_build.BUILD_DIR}")
    with open(os.path.join(cuda_build.BUILD_DIR, "libfastgeo.log")) as fh:
        cmd = fh.readline().strip()
    require(native._SRC in cmd, f"libfastgeo built from {cmd}")
    require(masks.rasteriser() == "native",
            f"rasterize_airfoil takes the {masks.rasteriser()} scanline")
    coords = naca4_coords().astype(np.float64)
    checked = 0
    for grid in ((384, 192), LARGE):
        cfg = cfg_cls(nx=grid[0], ny=grid[1])
        domain = (cfg.dx0, cfg.dx1, cfg.dy0, cfg.dy1)
        for alpha in (-7.5, 0.0, 6.0, 10.0, 18.0):
            xp, yp = masks._panelise(masks._rotate(coords, alpha))
            got = native.raster_mask_native(xp, yp, cfg.nx, cfg.ny, domain)
            want = masks.raster_mask_numpy(xp, yp, cfg.nx, cfg.ny, domain)
            require(np.array_equal(got, want) and 0 < got.sum(),
                    f"native mask != numpy at {grid} alpha {alpha}: "
                    f"{int((got != want).sum())} cells")
            require(np.array_equal(masks.rasterize_airfoil(
                coords, alpha, cfg), got), "rasterize_airfoil is not native")
            checked += 1

    def outcome(fn, text):
        try:
            c, fixes = fn(text)
        except parse_error as e:
            return "error", e.detail, None
        return "ok", fixes, c

    texts = []
    for path in files:
        with open(path, errors="ignore") as fh:
            texts.append(fh.read())
    t0 = time.perf_counter()
    nat = [outcome(native.parse_dat_native, t) for t in texts]
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = [outcome(parse_dat_text, t) for t in texts]
    t_py = time.perf_counter() - t0
    off = [os.path.basename(p) for p, a, b in zip(files, nat, py) if a != b]
    require(not off, f"native parse != Python parser: {off[:5]}")
    log(f"[native] libfastgeo built by g++ in this run ({cmd}); "
        f"rasterize_airfoil takes the native scanline; {checked} masks "
        f"(384x192 and {LARGE[0]}x{LARGE[1]}, 5 alphas) equal the numpy "
        f"scanline's; {len(files)} corpus files parse alike "
        f"({sum(o[0] == 'error' for o in nat)} refused): native "
        f"{t_nat * 1e3:.1f} ms, Python {t_py * 1e3:.1f} ms for all "
        f"({card})")


def _served(base: str, g: dict, pg: dict, frames: list) -> dict:
    """One pass of the service's routes at ``base``: ``GET /``, golden
    (e)'s ``/upload_airfoil/``, the golden polar's first three points on
    ``/polar/``, the golden batch on ``/batch/``, ``/lbm/start``, the
    ``frames`` forms on ``/lbm/frame``, ``/lbm/stop`` and ``GET /stats``.
    Returns {route: reply} with each reply's wall seconds and elapsed
    seconds and the session id taken out ({route + " s": seconds})."""
    out = {}

    def post(route, fields, files=None, key=None):
        t0 = time.perf_counter()
        status, body = _post(base + route, fields, files)
        out[f"{key or route} s"] = time.perf_counter() - t0
        require(status == 200, f"{route} -> {status} {str(body)[:300]}")
        body.pop("elapsed_seconds", None)
        out[key or route] = body
        return body

    with urllib.request.urlopen(base + "/", timeout=60) as r:
        out["/"] = json.loads(r.read())
    post("/upload_airfoil/", {"reynolds": g["reynolds"], "alpha": g["alpha"]},
         {"file": (g["filename"], g["dat"].encode())})
    a = pg["polar"]["alphas"][:3]
    post("/polar/", {"reynolds": pg["polar"]["re"], "alpha_start": a[0],
                     "alpha_end": a[-1], "alpha_step": a[1] - a[0]},
         {"file": ("polar.dat", precise_dat(
             "NACA", naca4_coords(*pg["polar"]["naca"])).encode())})
    gb = pg["batch"]
    post("/batch/", {"reynolds": gb["re"], "alpha": gb["alpha"]},
         [("files", (f"naca{i}.dat", precise_dat(
             "NACA", naca4_coords(*spec)).encode()))
          for i, spec in enumerate(gb["files"])])
    dat = ("NACA 2412\n" + "\n".join(
        f" {x:.6f} {y:.6f}" for x, y in naca4_coords())).encode()
    sid = post("/lbm/start", {"alpha": 6.0},
               {"file": ("naca2412.dat", dat)}).pop("session")
    for i, form in enumerate(frames):
        post("/lbm/frame", {"session": sid, **form}, key=f"/lbm/frame {i}")
    require(post("/lbm/stop", {"session": sid}) == {"stopped": sid},
            "/lbm/stop")
    out["/lbm/stop"] = {"stopped": "the session"}
    with urllib.request.urlopen(base + "/stats", timeout=60) as r:
        out["/stats"] = json.loads(r.read())
    return out


def _transport_expected() -> tuple[str, dict]:
    """The transport ``api/server.py``'s entry takes on this machine, and
    the versions of the packages that decide it (None: not installed)."""
    import importlib.metadata
    versions = {}
    for pkg in ("fastapi", "uvicorn", "slowapi", "python-multipart"):
        try:
            versions[pkg] = importlib.metadata.version(pkg)
        except importlib.metadata.PackageNotFoundError:
            versions[pkg] = None
    both = versions["fastapi"] and versions["uvicorn"]
    return ("FastAPI through uvicorn" if both else "minihttp"), versions


def phase_entry(card, ngold, pgold, make_server, stats, run_log_dir, work,
                spf) -> dict:
    """Phase 32b: ``python -m airfoil_tpu_torch.api.server`` as a child on
    the card (``ENTRY_CHILD``, a free ``PORT``, no device named). It logs
    the transport this machine's packages give it (FastAPI through uvicorn
    where both are installed, else minihttp); ``/health`` names the card;
    after its warm-up (the launch counts then set to 0) every route of
    ``_served`` answers: golden (e)'s upload held as phase 16 holds it
    (one more run log and count), and every reply equal to the in-process
    minihttp server's on the card (the wall times aside); the frames'
    fields finite; the requests' launches read from the child. Returns
    {kernel: the requests' launches}."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    counts_path = os.path.join(work, "entry_counts.json")
    log_path = os.path.join(work, "entry.log")
    env = dict(os.environ, PORT=str(port), CHIP_SMOKE_COUNTS=counts_path)
    env.pop("AIRFOIL_TPU_TORCH_DEVICE", None)
    url = f"http://127.0.0.1:{port}"
    frames = [{"fields": "speed,cp,vorticity"} for _ in range(ENTRY_FRAMES)]
    frames[ENTRY_FRAMES // 2]["alpha"] = 9.0
    g = ngold["upload"]
    t_spawn = time.perf_counter()
    with open(log_path, "w") as out:
        child = subprocess.Popen([sys.executable, "-c", ENTRY_CHILD],
                                 cwd=ROOT, env=env, stdout=out,
                                 stderr=subprocess.STDOUT)

    def child_log() -> str:
        with open(log_path, errors="replace") as fh:
            return fh.read()

    def n_logs() -> int:
        return (len(os.listdir(run_log_dir))
                if os.path.isdir(run_log_dir) else 0)

    try:
        deadline = time.monotonic() + 120
        while True:
            require(child.poll() is None,
                    f"the server entry exited: {child_log()[-2000:]}")
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except (urllib.error.URLError, ConnectionError):
                require(time.monotonic() < deadline,
                        "the server entry never answered /health")
                time.sleep(0.2)
        t_up = time.perf_counter() - t_spawn
        transport = re.search(r"transport: (FastAPI through uvicorn|minihttp)",
                              child_log())
        expected, versions = _transport_expected()
        require(transport is not None and transport.group(1) == expected,
                f"the entry's transport is not {expected} ({versions}): "
                f"{child_log()[-3000:]}")
        require(health["backend"] == "cuda" and health["accelerator"]
                and health["device"] == torch.cuda.get_device_name(0),
                f"/health {health} does not name the card")
        # The warm-up's last stage, then the counts set to 0.
        deadline = time.monotonic() + ENTRY_WARMUP_S
        while "direct solve warmup done" not in child_log():
            require("solver warmup failed" not in child_log(),
                    f"the entry's warm-up failed: {child_log()[-3000:]}")
            require(child.poll() is None and time.monotonic() < deadline,
                    f"the entry's warm-up did not end: {child_log()[-2000:]}")
            time.sleep(0.2)
        t_warm = time.perf_counter() - t_spawn
        stages = re.findall(r"(\w[\w ]*) warmup done in ([\d.]+)s",
                            child_log())
        warm_counts = _child_counts(child, counts_path)
        logs0, count0 = n_logs(), stats.get_analysis_count() or 0
        got = _served(url, g, pgold, frames)
        logs, count = n_logs(), stats.get_analysis_count()
        req_counts = _child_counts(child, counts_path)
        require(child.poll() is None, "the server entry exited early")
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGTERM)
        try:
            child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()

    fails = upload_fails(200, got["/upload_airfoil/"], g)
    n_batch = len(pgold["batch"]["files"])
    if logs != logs0 + 1 or count != count0 + 2 + n_batch:
        fails.append(f"run logs {logs0} -> {logs}, analysis count {count0} "
                     f"-> {count} (upload, polar, {n_batch} batch lanes)")
    log(f"[entry] the entry's POST /upload_airfoil/ ({g['filename']}, Re "
        f"{g['reynolds']:g}, alpha {g['alpha']:g}): "
        f"{got['/upload_airfoil/']['coefficients']}; ensemble "
        f"{g['ensemble']} {'ok' if not fails else 'FAIL ' + str(fails)}")
    require(not fails, f"entry upload: {fails}")
    ny, nx = got["/lbm/start"]["grid"]
    for i in range(ENTRY_FRAMES):
        fr = got[f"/lbm/frame {i}"]
        require(fr["step"] == (i + 1) * spf, f"frame step {fr['step']}")
        for name, field in fr["fields"].items():
            a = np.frombuffer(base64.b64decode(field["data"]), np.float32)
            require(a.size == ny * nx and np.isfinite(a).sum() > a.size // 2
                    and bool((np.isnan(a) | np.isfinite(a)).all()),
                    f"frame {i} {name}: not a finite field")

    httpd = make_server(host="127.0.0.1", port=0, rate_limit=False,
                        device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        want = _served(f"http://127.0.0.1:{httpd.server_address[1]}", g,
                       pgold, frames)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    differ = [k for k in want if not k.endswith(" s") and k != "/stats"
              and got[k] != want[k]]
    require(not differ, f"the entry's replies differ from the in-process "
            f"server's at {differ}")
    require(got["/stats"] == {"total_analyses": count},
            f"/stats {got['/stats']}, the counter {count}")
    # The requests' kernels: one lbm_steps launch a frame and none tiled,
    # the masks' cell words, and the solves' marches.
    require(req_counts["lbm_steps"] == ENTRY_FRAMES
            and req_counts["field_b64"] == ENTRY_FRAMES
            and req_counts["lbm_steps_tiled"] == 0
            and req_counts["cell_word"] >= 1
            and req_counts["bl_march"] >= 1
            and req_counts["bl_march_wake"] >= 1,
            f"the entry's requests launched {req_counts}")
    walls = {k[:-2]: round(got[k], 4) for k in got if k.endswith(" s")}
    frame_ms = statistics.median(walls[f"/lbm/frame {i}"]
                                 for i in range(ENTRY_FRAMES)) * 1e3
    log(f"[entry] python -m airfoil_tpu_torch.api.server on the card: "
        f"{transport.group(1)} ({versions}), /health {health['device']} after "
        f"{t_up:.1f} s, warm-up done after {t_warm:.1f} s ({stages}; its "
        f"launches {warm_counts}); every route's reply equal to the "
        f"in-process minihttp server's; {ENTRY_FRAMES} frames at {nx}x{ny}, "
        f"median {frame_ms:.3f} ms; walls (s, HTTP round trip) {walls}; "
        f"the requests' launches {req_counts} ({card})")
    return req_counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    import airfoil_tpu_torch
    pkg = os.path.dirname(os.path.abspath(airfoil_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        print(f"chip_smoke: airfoil_tpu_torch found at {pkg}, not in this "
              f"checkout ({ROOT})", file=sys.stderr)
        return 1
    # The upload phase's run log and analysis counter go to a scratch
    # directory of this run (the counter's path is read at import).
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    run_log_dir = os.path.join(work, "runs")
    os.environ["AIRFOIL_TPU_RUN_LOG_DIR"] = run_log_dir
    os.environ["AIRFOIL_TPU_STATS_PATH"] = os.path.join(work, "stats.db")
    try:
        return run(run_log_dir, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(run_log_dir: str, work: str) -> int:
    t_start = time.perf_counter()
    t_start_wall = time.time()
    from airfoil_tpu_torch import cuda_build
    from airfoil_tpu_torch.config import LBMConfig
    from airfoil_tpu_torch.api import field_b64
    from airfoil_tpu_torch.api.handlers import parse_upload
    from airfoil_tpu_torch.api.minihttp import make_server
    from airfoil_tpu_torch.device import resolve_device
    from airfoil_tpu_torch.lbm import core, diagnostics, kernel, masks
    from airfoil_tpu_torch.lbm.bench import bench_mlups
    from airfoil_tpu_torch.lbm.runner import WindTunnel
    from airfoil_tpu_torch import inviscid, paneling, polar
    from airfoil_tpu_torch.polar import analyze as analyze_mod
    from airfoil_tpu_torch.utils import compile_cache, stats
    from airfoil_tpu_torch.viscous import coupled, graphs, march, newton, wake
    from airfoil_tpu_torch.viscous import kernel as march_kernel

    dev = resolve_device("cuda")
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    k = phase_build(cuda_build, compile_cache, kernel)
    max_abs = dict(zip(("lbm_steps", "cell_word"),
                       phase_kernel(dev, kernel, core, masks, LBMConfig)))
    b64 = phase_field_b64(dev, card, field_b64)
    max_abs["field_b64"] = 0.0          # byte for byte, or the phase fails
    launches, _ = phase_server(kernel, field_b64, make_server, parse_upload,
                               masks.build_mask, LBMConfig().steps_per_frame)
    max_abs["lbm_steps_tiled"] = phase_tiled(dev, kernel, core, masks,
                                             LBMConfig, k)
    phase_physics(dev, WindTunnel)
    launches["lbm_steps_tiled"] = phase_large(dev, kernel, WindTunnel,
                                              LBMConfig)
    times = phase_speed(dev, card, kernel, core, diagnostics, masks,
                        LBMConfig, bench_mlups)
    phase_mask_speed(dev, card, masks, LBMConfig, WindTunnel)
    bounds = {"lbm_steps": lbm_bound(dev, core, masks, LBMConfig, (384, 192)),
              "cell_word": word_bound(dev, core, masks, LBMConfig),
              "lbm_steps_tiled": lbm_bound(dev, core, masks, LBMConfig, LARGE),
              "field_b64": b64["large"][4]}
    times["field_b64"] = b64["large"][:3]

    goldens = load_goldens()
    ops = {code: naca_operator(code, dev, paneling, inviscid)
           for code in ("0012", "2412", "4412")}
    phase_inviscid(goldens, ops, inviscid)
    march_abs, sides, batch = phase_march(dev, march_kernel, march, coupled,
                                          inviscid, ops["2412"],
                                          goldens["trip_x"])
    max_abs.update(march_abs)
    results, march_launches = phase_viscous(goldens, ops, coupled,
                                            march_kernel)
    launches.update(march_launches)
    phase_viscous_anchors(results, ops, coupled, inviscid, march_kernel)
    march_times, march_bounds = phase_viscous_speed(
        card, ops, inviscid, coupled, wake, march_kernel, march, sides, batch)
    times.update(march_times)
    bounds.update(march_bounds)

    # The simultaneous-Newton path: the solver, analyze_airfoil and the
    # served upload.
    ngold = load_goldens(NEWTON_GOLDENS)
    op = ops["2412"]
    newton_abs, side_call, wake_call = phase_newton_march(
        dev, march_kernel, march, newton, op, goldens["trip_x"])
    newton_launches = phase_newton(dev, ngold, ops, newton, march_kernel)
    phase_lm_sync_free(dev, newton, op)
    walls = phase_analyze(dev, ngold, polar, analyze_mod)
    walls["upload"] = phase_upload(ngold, make_server, run_log_dir, stats,
                                   analyze_mod)
    # The polar and batch path: the sweep, the batch, the served routes.
    from airfoil_tpu_torch.polar import sweep
    pgold = load_goldens(POLAR_GOLDENS)
    polar_res, polar_wall, polar_launches, polar_lanes, polar_abs, \
        at_lanes, polar_graphs = phase_polar(dev, card, pgold, sweep, newton,
                                             graphs, march_kernel, march)
    batch_res = phase_batch(dev, pgold, polar, newton, march_kernel)
    walls.update(phase_served(pgold, make_server, parse_upload, stats,
                              polar_res, batch_res))
    newton_times, newton_bounds = phase_newton_speed(
        card, dev, newton, graphs, op, march_kernel, march, side_call,
        wake_call)
    log(f"[newton speed] wall: analyze_airfoil alpha 4 {walls[4.0]:.3f} s, "
        f"alpha 19 {walls[19.0]:.3f} s; POST /upload_airfoil/ alpha 5 "
        f"{walls['upload']:.3f} s; POST /polar/ {walls['polar']:.3f} s; "
        f"POST /batch/ {walls['batch']:.3f} s ({card})")
    # The LM iteration's CUDA graphs: graph against eager, warmed buckets,
    # concurrency, an upload during the server's warm-up.
    from airfoil_tpu_torch.api import handlers
    t_graphs = time.perf_counter()
    lm_graphs, _headline_wall = phase_graphs(dev, card, newton, graphs,
                                             sweep, handlers, make_server,
                                             ops)
    log(f"[graphs] the graphs phase took "
        f"{time.perf_counter() - t_graphs:.1f} s")
    from airfoil_tpu_torch.bench import parser_benchmark as pb
    t_graphs = time.perf_counter()
    solver_graphs = phase_solver_graphs(dev, card, coupled, newton, graphs,
                                        sweep, pb, ops)
    log(f"[solver graphs] the solver graphs phase took "
        f"{time.perf_counter() - t_graphs:.1f} s")
    from airfoil_tpu_torch import graft_entry
    from airfoil_tpu_torch.inviscid import programs
    from airfoil_tpu_torch.polar import batch as batch_mod
    t_graphs = time.perf_counter()
    program_graphs = phase_program_graphs(
        dev, card, graphs, sweep, pb, batch_mod, programs, graft_entry,
        kernel, diagnostics, WindTunnel, LBMConfig, ops)
    log(f"[program graphs] the program graphs phase took "
        f"{time.perf_counter() - t_graphs:.1f} s")
    newton_keys = {name: {
        "newton_launches": newton_launches[name],
        "newton_max_abs_err": newton_abs[name],
        "newton_ms": newton_times[name][0],
        "newton_device_ms": newton_times[name][2],
        "newton_plain_ms": newton_times[name][1],
        "newton_bound_ms": newton_bounds[name][0],
        "newton_bound_by": newton_bounds[name][1]} for name in newton_abs}
    for name, err in newton_abs.items():
        max_abs[name] = max(max_abs[name], err, polar_abs[name])
    for name in newton_keys:
        newton_keys[name].update({
            "polar_launches": polar_launches[name],
            "polar_lanes": polar_lanes[name],
            "polar_max_abs_err": polar_abs[name],
            **{f"polar_{key}_{lanes}_lanes": v for lanes in (64, 128)
               for key, v in (("ms", at_lanes[lanes][name][0]),
                              ("bound_ms", at_lanes[lanes][name][1][0]))}})

    # The parser benchmark, its tripped chunks, the paneling probe and the
    # flow field.
    from airfoil_tpu_torch.bench import corpus as bench_corpus
    from airfoil_tpu_torch.bench import paneling_probe
    from airfoil_tpu_torch.geometry import parse_dat_file
    from airfoil_tpu_torch.inviscid import flowfield
    from airfoil_tpu_torch.models import naca4
    bgold = load_goldens(BENCH_GOLDENS)
    t_bench = time.perf_counter()
    files, parser_launches, s_rate, off, _recs, _wall = phase_parser_bench(
        dev, card, bgold, pb, bench_corpus, march_kernel, work)
    parser_abs, p_side, p_wake = phase_parser_tripped(
        dev, card, bgold, pb, march_kernel, march, files)
    parser_times, parser_bounds = phase_parser_speed(
        dev, card, pb, march_kernel, march, files, p_side, p_wake)
    off += phase_probe(dev, card, bgold, paneling_probe, naca4,
                       parse_dat_file, files)
    field = phase_flow_field(dev, card, flowfield, naca4)
    log(f"[parser bench] the parser-bench, tripped, speed, probe and flow "
        f"field phases took {time.perf_counter() - t_bench:.1f} s")
    require(len(off) <= s_rate,
            f"{len(off)} verdicts (parser benchmark and probe) off all three "
            f"JAX members, more than the members' own flip rate S {s_rate}")
    log(f"[parser bench] O = {len(off)} verdicts (benchmark and probe) off "
        f"all three JAX members, S = {s_rate}: held")
    for name in newton_keys:
        max_abs[name] = max(max_abs[name], parser_abs[name])
        newton_keys[name].update({
            "parser_launches": parser_launches[name],
            "parser_lanes": int((p_side if name == "bl_march" else p_wake
                                 )[0].shape[0]),
            "parser_max_abs_err": parser_abs[name],
            "parser_ms": parser_times[name][0],
            "parser_device_ms": parser_times[name][1],
            "parser_bound_ms": parser_bounds[name][0],
            "parser_bound_by": parser_bounds[name][1]})

    # The multi-device paths: the sharded LBM and the sharded polar at 1
    # rank (NCCL) and 4 ranks sharing the card (gloo), then the graft entry.
    from airfoil_tpu_torch.parallel import launch as par_launch
    gpar = load_goldens(PARALLEL_GOLDENS)
    gp = gpar["polar"]
    # Phase 27 sets phase 17's polar beside the sharded ones: the same
    # geometry, points, Re and panels.
    same = ("naca", "alphas", "re", "n_panels")
    require({k: gp[k] for k in same} == {k: pgold["polar"][k] for k in same},
            f"the sharded polar's points {[gp[k] for k in same]} are not "
            f"phase 17's {[pgold['polar'][k] for k in same]}")
    polar_args = (np.asarray(naca4_coords(*gp["naca"]), np.float32),
                  gp["alphas"], gp["re"])
    t_par = time.perf_counter()
    results = {}
    for n, backend in SHARDED_RANKS:
        t0 = time.perf_counter()
        results[n] = par_launch.run(sharded_rank, n, polar_args,
                                    backend=backend)
        log(f"[sharded] {n} rank(s) ({backend}): the sharded LBM cases and "
            f"polar in {time.perf_counter() - t0:.1f} s, start-up included")
    sharded_launches, sharded_abs = phase_sharded_lbm(card, results)
    sharded_launches.update(phase_sharded_polar(card, dev, results, gpar,
                                                sweep, newton, polar_res,
                                                polar_wall))
    entry_launches = phase_graft_entry(card, gpar, graft_entry)
    log(f"[sharded] the sharded LBM, sharded polar and graft entry phases "
        f"took {time.perf_counter() - t_par:.1f} s")

    # The exact Joukowski cases, the headline bench's records on the card,
    # the profiling utilities and the heatmap.
    from airfoil_tpu_torch import models
    from airfoil_tpu_torch.bench import headline
    from airfoil_tpu_torch.utils import profiling
    t_new = time.perf_counter()
    phase_models(dev, card, models, paneling, inviscid)
    headline_launches = phase_headline(
        dev, card, headline, profiling, kernel, core, masks, LBMConfig,
        polar_res, polar_wall, polar_launches, polar_graphs, work)
    headline_launches.update(polar_launches)
    phase_flowviz(card, field)
    log(f"[headline] the models, headline and flowviz phases took "
        f"{time.perf_counter() - t_new:.1f} s")

    # The native geometry library and the service's entry point.
    from airfoil_tpu_torch import native
    from airfoil_tpu_torch.geometry import AirfoilParseError, parse_dat_text
    t_new = time.perf_counter()
    phase_native(card, masks, native, LBMConfig, parse_dat_text,
                 AirfoilParseError, files, t_start_wall)
    entry_launches_32 = phase_entry(card, ngold, pgold, make_server, stats,
                                    run_log_dir, work,
                                    LBMConfig().steps_per_frame)
    log(f"[entry] the native and entry phases took "
        f"{time.perf_counter() - t_new:.1f} s")
    viewer = b64["viewer"]
    newton_keys["field_b64"] = {
        "encode_ms": b64["large"][3], "viewer_ms": viewer[0],
        "viewer_device_ms": viewer[2], "viewer_plain_ms": viewer[1],
        "viewer_encode_ms": viewer[3], "viewer_bound_ms": viewer[4][0]}
    for name in KERNELS:
        keys = newton_keys.setdefault(name, {})
        if name in sharded_launches:
            keys.update({f"sharded_launches_{n}_rank{'s' if n > 1 else ''}":
                         sharded_launches[name][n] for n, _b in SHARDED_RANKS})
        if name in ("lbm_steps", "lbm_steps_tiled"):
            keys["sharded_max_abs_err"] = sharded_abs
        if name in entry_launches:
            keys["entry_launches"] = entry_launches[name]
        keys["headline_launches"] = headline_launches[name]
        keys["server_entry_launches"] = entry_launches_32[name]

    log(f"[done] every phase in {time.perf_counter() - t_start:.1f} s")
    refused = [m for m in sys.modules
               if m.partition(".")[0] in ("jax", "airfoil_tpu")]
    require(not refused, f"the reference or jax was imported: {refused[:5]}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": max_abs[name],
        "ms": times[name][0], "device_ms": times[name][2],
        "plain_ms": times[name][1],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": None, **newton_keys.get(name, {})}
        for name, (source, replaces) in KERNELS.items()],
        "lm_graphs": dict(
            lm_graphs, captures=graphs.total(graphs.captures, "lm"),
            replays=graphs.total(graphs.replays, "lm"),
            programs={prog: {"captures": graphs.total(graphs.captures, prog),
                             "replays": graphs.total(graphs.replays, prog)}
                      for prog in graphs.PROGRAMS},
            solver_graphs=solver_graphs, program_graphs=program_graphs)}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
