#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH] [--profile PATH] [--phases LIST]

Run from the repository root.  Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the ``nvcc`` build of every kernel (one ``nvcc`` process per source,
   started together) with its ``-Xptxas -v`` report; for each of the
   persistent kernel's ten instantiations, at the main path's launch shape
   (2,048 slots per block, 512 threads; packed words of the paper design;
   two cells of 1,024 slots for several cells per block), the resident
   blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
   registers, local memory and spills.  It fails if the main path's
   instantiation (count spawn, exact selection) holds fewer than 2 blocks
   per SM, if any instantiation holds fewer than its launch bounds ask for,
   or if any spills; and the same numbers for the per-cell kernel at 256,
   128 and 64 threads per block (it fails if that kernel spills);
2. each kernel against its plain PyTorch version on the card, at the main
   path's per-cell width (paper design, 8 x 6 FoV x 3 wavelengths = 144
   cells, 2,048 slots, 100,000-iteration bound), in gens spawn with the
   main path's three generations per slot (one iteration of 5,000 rays a
   cell) and in count spawn with a target of 20,000; the histogram and the
   bounce and spawn counts must be identical; both are timed with CUDA
   events after a warm-up;
3. the main path at full width through the port's ``Simulator``, as
   ``simulate`` runs it with no flags: the paper design at the reference
   workload (100 x 75 FoV x 3 wavelengths, 5,000 rays per FoV x 4
   iterations, each a relaunch in gens spawn, 3 generations of 2,048 slots
   a cell, 80 x 120 eyebox bins), seeds hashed on the card, the histogram
   kept on the card and the perception and the float32 colorimetry with
   the eye-view image run there (``simulate``'s ``cli.run_options``, as
   every phase that runs what ``simulate`` runs), with launch counts reset
   just before it and read just after it; its layers: seeding (host and
   CUDA events), kernel, assembly, perception and colorimetry (CUDA
   events), the pull of the metrics and the image; the run's own stack
   through the host float64 colorimetry: delta E, FoV and eyebox uniformity
   within 1e-4 relative, the image within rtol 2e-3 / atol 1e-5 and the
   starved eye positions equal; then the same run at seeds 1 and 2 with
   seed 0's LUTs (efficiencies only);
3b. the same for the count-spawn folded path
   (``spawn_mode="count", fold_iterations=True``: the 4 iterations folded
   into one spawn target of 20,000 per cell), seeds 0, 1 and 2: the
   reference of phases 10, 14, 16 and 18;
4. only with ``--profile PATH``: one more run of the same ``Simulator``,
   as phase 3 runs it, under ``torch.profiler``, giving the device's busy
   time, the kernel's and the device-to-host copies' device time and the
   device's idle share of the run; the profiler's table goes to PATH;
5. the kernel against its plain version in the sweep's modes: the paper
   design swept over 3 coupler periods (D = 3 geometry rows, one launch tile
   per design, one shared seed block), 4 x 3 FoV x 3 wavelengths, 256 slots,
   in gens spawn saturated to iteration 256 (``ctrl = [1, 256]``), gens
   spawn with two generations (``[2, 0]``) and count spawn (target 256); the
   histogram and the bounce and spawn counts must be identical; both are
   timed with CUDA events;
6. the design sweep at full width through the port's
   ``run_design_sweep_persistent``, with launch counts reset just before
   each sweep and read just after it: the CLI's default sweep (8 coupler
   periods over 370-405 nm, 100 x 75 FoV x 3 wavelengths = 180,000 cells in
   one launch, 256 rays per FoV, gens spawn saturated to iteration 256,
   2,048-bounce bound) and the README's count sweep (16 periods, 360,000
   cells in one launch, 2,048 rays per FoV, count spawn), both with metrics;
   design 3 of each must equal its solo sweep bit for bit;
7. the per-cell kernel against its plain version on the card, at the cell
   engine's per-cell width (paper design, 8 x 6 FoV x 3 wavelengths = 144
   cells, 5,000 rays per cell = 40 rows of 128, 5,120 slots): (a) full mode
   with a 24-iteration budget, (b) resume mode from (a)'s outputs with the
   rest of the 100,000-iteration budget, (c) full mode with the whole
   budget; deposit codes, states, RNG streams, bounce counts and the 9
   float fields of every ray must be identical, and (a) + (b) must equal
   (c); both are timed with CUDA events.  Each call also reports its
   launch shape and the lane occupancy of the kernel's earlier design, one
   thread per ray (Σ bounces / Σ over warps of 32 consecutive rays of 32 x
   the warp's longest ray, from the plain version's per-ray iteration
   counts);
8. the cell engine at full width through ``Simulator(engine="cell")``: the
   paper design, 100 x 75 FoV x 3 wavelengths = 22,500 cells, 5,000 rays
   per cell (the blocks built on the card from the shared pupil points and
   the hashed ray index) in 11 batches of <= 2,048 cells, 80 x 120 bins,
   a 100,000-bounce bound, metrics on; one of the reference workload's four
   relaunches (``num_iter=1``: depth is cut, the per-cell width is not); once
   to the end in one launch per batch and once under the segment-and-compact
   scheduler, with launch counts reset just before each run and read just
   after it; beside each run's kernel time, the summed bound of its
   launches (:class:`CellLaunchBounds`, read in an untimed replay of the
   run that must trace the same bounces in as many launches).  The tail on
   the card, as ``simulate`` runs it; the monolithic run's histogram once
   more through the host tail (pulled, float64 colorimetry): phase 3's
   comparison.  The two histograms and bounce totals must be identical and
   the histogram's float64 sum on the card equal to the number of
   deposits.  Seeding's host and device time; two full batches (cells
   0-2,047 at iteration 0, 18,432-20,479 at iteration 3) built by the
   engine and seeded on the host, each timed, must be equal
   (``torch.equal``).  Every colour's efficiency must lie within 10 % of phase 3's
   (the efficiency bar below holds phase 3 to 1.5 %).  One more run at
   2,048 rays per cell holds the two
   kernels to each other: it must equal a one-design gens-spawn sweep of
   the persistent kernel with one generation per slot bit for bit (the
   same launch tile and seeds), and agree within 2 % with the efficiencies
   of ten generations per slot;
9. the persistent kernel's packed selection, transit jumps and several
   cells per block against the plain version on the card, at phase 2's
   fixture (144 cells, 100,000-iteration bound): (a) packed, count target
   20,000, 2,048 slots; (b) the same with jumps phased by squaring; (c) by
   cos / sin; (d) packed with two cells of 1,024 slots per block, in count
   spawn and in gens spawn ``[2, 0]``, each also against its own launch with
   one cell per block (tile, bounces and spawns equal per cell); (e) packed
   with jumps by squaring in gens spawn saturated to iteration 256 at 256
   slots (the sweep's width); (f) packed and (g) packed with jumps by
   squaring in gens spawn ``[10, 0]`` at 2,048 slots; (h) packed in gens
   spawn saturated to iteration 256 at 256 slots and (i) the same with four
   cells of 256 slots per block, also against one cell per block (the two
   launch shapes of phase 6c that no other row has).  Every mode must equal
   its plain version bit for bit.  (g) against (f), the same rays hop by hop:
   bounces within 0.2 %, deposits within 5 %, strictly fewer iterations.
   (b) against (a): count spawn respawns a slot the sooner the fewer
   iterations its rays live, and jumps shorten exactly the long transits, so
   the two runs weigh launch points differently: bounces per spawned ray
   within 1 %, deposits per spawned ray within 5 %, strictly fewer
   iterations;
10. the count-spawn, folded stack with packed selection and transit jumps at
   full width through ``Simulator(spawn_mode="count", fold_iterations=True,
   pers_accum_mode="packed", pers_transit_jump=True)``: the reference
   workload, uncut, the tail and every layer as in phase 3b, then the same
   with packed selection alone; launch counts reset just before each run
   and read just after it.  Each colour's efficiency must lie within 5 % of
   the exact mode's (phase 3b: the same seeds), bounces per traced ray
   within 1 %, and the jump run's summed iterations below the packed run's;
6c. phase 6's default sweep (8 periods, 180,000 cells, 256 slots, gens spawn
   saturated to iteration 256) with packed selection and transit jumps, with
   packed selection alone, and with packed selection and four cells per
   block, whose kept design must equal the one-cell-per-block run's bit for
   bit;
19. the rows' kernel (``csrc/cell_rows.cu``, which builds the kernel
   engines' cell rows of synthetic LUTs on the card) against its plain
   PyTorch version on the card and the host pipeline (synthetic LUTs ->
   cell tables -> rows), compared bitwise as int32 views: the reference
   workload (22,500 cells, LUT seed 1234, the host route ``Simulator``
   took), phase 6b's 16-design chunk (360,000 cells, 1.01 GB of rows) and
   6c's 8-design chunk (180,000 cells) with its packed selection words;
   the kernel's time (CUDA events, inputs on the card), the plain
   version's, the bound (rows written and inputs read once at 3.35 TB/s,
   or the float64 and float32 operations at 34 and 67 TFLOP/s), and the
   seconds of the host inputs and of the host pipeline;
20. the tail's kernels (``csrc/eye_tail.cu``) against their plain PyTorch
   versions on the card, on a seeded (3, 75, 100, 80, 120) histogram (the
   reference workload's; 20 % empty bins and an empty FoV corner): the
   perception (``pupil_window_sum``) bit for bit
   ``eye_perceived_reference`` at the sampled grid's stride (8, 12), at
   the dense scan's (1, 1), and on the sweep's per-design launch (6a's
   22,500 cells as tiles of 128 lanes cut to 120, each scaled by a seeded
   Wald factor), with ``F.conv2d``'s time at the unscaled shapes (the
   library call, TF32 off; its first call timed apart, the process's first
   cuDNN call when the script runs whole); for each case the kernel's
   launch shape (form, windows a thread, stages, threads, summing ones,
   blocks per SM, registers, local bytes, spills from this run's build,
   staging by bulk copies or loads), held to the Python rule
   ``eye_tail.window_sum_plan``, and its achieved GB/s; the colorimetry
   against ``_make_eval_core`` on the card for ``simulate``'s stack with
   the eye-view image (and phase 3's bars against the host float64
   colorimetry), an 8-design ``evaluate_batch`` stack and the dense scan's
   51 x 91 positions: metrics within 1e-5 relative, the image within rtol
   1e-5 / atol 1e-6, ``u_eb``'s zeros and the starved counts equal; each
   kernel's device time (CUDA events around calls queued behind device
   spin, so the host's launch cost is not counted), its plain version's
   and its bound (bytes read and written once at 3.35 TB/s, or the
   operations at 67 TFLOP/s; the perception's adds at one lane instruction
   each, 33.45e12 a second);
21. the per-cell splitting kernel (``csrc/split_cells.cu``: one launch per
   chunk runs every cell's wavefront loop, each cell on a cluster of 1, 2
   or 4 blocks) against its plain PyTorch version
   (``splitting.split_cells_reference``) on the same packed arguments
   (``split_cases``): a 256-cell chunk of ``simulate --engine
   splitting``'s README case (16 x 12 FoV, 8,192 slots, threshold 1e-6, 2
   launch seeds), 4 of its cells with shared and with per-cell seeds (each
   also against the plain version on the CPU), the 4 cells at 64 slots (it
   must truncate, and its peak pass 64), a 128-cell chunk of the 100 x 75
   grid at ``ExactTailHybrid``'s defaults (32,768 slots, threshold 1e-6, a
   pass of 4 pupil points, each launched TE and TM: 8 launch seeds) and the
   512-cell chunk ``simulate --tail-exact`` launches (``cli._tail_hybrid``:
   8,192 slots, one point a pass: 2 launch seeds); bars on the card: tiles
   bit for bit (on the CPU too), per-cell steps, peak and stepped widths
   equal, truncation equal where 0 and else within 1e-6, pruned and
   out-coupled weight within 1e-6 relative; the 4-cell chunk launched at
   every cluster size gives the same outputs bit for bit; each case prints
   the launch's cluster size, threads, resident blocks per SM, shared
   memory and the instantiation's registers and spills (spills must be 0,
   and a launch of one block a cell must hold 2 blocks an SM); the
   kernel's time (CUDA events), the plain version's, and the bound from
   the kernel's own sum of widths (88 B a stepped slot, and each cell's
   records, tile and seeds once, at 3.35 TB/s, or 200 float32 operations
   a stepped slot at 67 TFLOP/s);
22. the vector engine's kernel (``csrc/vector_trace.cu``: one launch per
   trace call runs every ray's whole bounce loop, a warp a bounce a round
   with lanes that take their block's next rays) against its plain
   PyTorch version (``trace_vector.vector_trace_reference``) on the same
   arguments, on the card: (a) a 2,048-cell batch of phase 12's case at
   full width (10.24 M rays, the whole 100,000-bounce budget); (b) the
   same rays in full mode with a 24-step budget, then in resume mode with
   the rest, which together must equal (a); (c) the CLI's default sweep's
   8 designs at its widths (180,000 cells x 256 rays in one call); (d) the
   polygon in-coupler test (512 cells of phase 12's case; (a) to (c) run
   the default, the circle).  Every ray field, the per-design bounces and
   the steps must be equal bit for bit; the kernel's registers, spills
   (none allowed) and resident blocks per SM; its time (CUDA events behind
   0.1 s of device spin), the plain version's (host clock), and the
   bound: each ray field read
   once and each output field written once (68 + 52 B a ray), the tables
   of the cells the rays touch, the geometry and grids once, at 3.35
   TB/s, or ``VEC_BOUNCE_OPS`` float32 operations a bounce and
   ``VEC_INIT_OPS`` a full-mode ray at 67 TFLOP/s;
23. the global splitting engine's kernels (``csrc/split_trace.cu``: the
   forward and its hand-written adjoint, one cooperative kernel a call
   each) against
   their plain PyTorch versions (``splitting.split_trace_reference``,
   ``splitting.split_trace_backward_reference``) on the same arguments, on
   the card: (a) ``optimize``'s README apodization case (16 x 12 FoV x 3
   wavelengths = 576 cells x 16 rays, 4,096 slots, 64 fixed steps, hard
   binning; it truncates, F6); (b) its joint case with soft binning (24 x
   18, 8 rays, 16,384 slots, 64 steps); (c) the global engine in stop-test
   mode (phase 13d's 18 cells x 4 positions, 32,768 slots, threshold 1e-5:
   every table entry's run is long); (d) phase 15's whole wavefront (16 x
   12, 2 rays, 262,144 slots, 64 fixed steps: wider than the co-resident
   grid).  Each call must launch one kernel; the grid, the resident blocks
   per SM and the barriers a step are printed.
   The forward's histogram, step count and tape (every kept slot's fields
   and provenance) must be equal bit for bit, the truncated, pruned and
   deposited weight within 1e-6 relative; the backward of a seeded
   histogram adjoint equal bit for bit in the three tables, and two
   backward runs identical.  Each kernel's time (CUDA events around whole
   calls), the plain version's (host clock), and the bound: the bytes of
   the stepped slots (``SPLIT_TRACE_BYTES``) with the tables, rays and
   histogram once at 3.35 TB/s, or ``SPLIT_TRACE_OPS`` float32 operations
   a stepped slot at 67 TFLOP/s;
11. the device tail and the run options at the reference workload's full
   width: the card's seed hash equal to the host's over phase 3's index
   range unfolded (4 x 22,500 cells x 2,048 slots, one batch of 2,048 cells
   at a time) and at the first and last batch of phase 6b's (360,000 cells);
   one count-spawn folded ``Simulator`` run three times, with the host
   tail, with the stack
   pulled and with device metrics and the dense scan (51 x 91 eye
   positions; its time and the run's peak device memory): histograms
   identical, efficiencies within 1e-6 relative, delta E, FoV and eyebox
   uniformity within 1e-4; ``wavelengths=(0, 2)``: rows 0 and 2 identical
   to the full run's, row 1 empty; unfolded count spawn with 4 jackknife
   groups: standard errors finite, those of the efficiencies and of delta E
   positive, each efficiency's below the efficiency; gens spawn unfolded
   (the default, phase 3's run), 4 relaunches: each efficiency within 1 %
   of phase 8's cell engine (both weigh launch points equally); and
   checkpoint and resume (count spawn, unfolded) at 20 x 15 FoV on each
   engine, 2 iterations
   checkpointed and resumed to 3 equal to 3 uninterrupted.  Launch counts
   are reset at its start and read at its end.
12. the vector engine at full width through ``Simulator(engine="vector")``
   as ``simulate --engine vector`` builds it (``cli.vector_segmented``):
   phase 8's workload (22,500 cells, 5,000 rays per cell,
   the ray state built on the card, in 11 batches, 80 x 120 bins, a
   100,000-bounce bound, metrics on, ``num_iter=1``, the tail on the card
   as ``simulate`` runs it), with its layers (setup, split into its
   ``setup_timings``: geometry, host tables, the kernel's build and bind,
   the vector tracer's build with its refined grids; seeding on the host
   and the card, the bounce loop, compaction, scatter, the tail's
   perception, colorimetry and pull), the steps and the reads from the
   device of each batch, the wall and the peak device memory, with launch
   counts reset just before the run and read just after it: one
   ``vector_trace`` launch per batch and segment and no K1 or K2; every
   colour's efficiency within 2 % of phase 8's cell engine (both weigh
   launch points equally); the histogram's digest, bounces, deposits and
   efficiencies printed for an A/B; phase 8's two batches built by the
   engine and seeded on the host, each timed, equal (``torch.equal``).
   The first batch again, to the end in one call and in segments of 24
   bounces, three times each in turns: the two must be equal bit for bit,
   and its per-ray deposits must agree with K2's (the cell engine, the
   same seeds) for at least 99.5 % of the rays (the two geometries are
   simplified at different tolerances).  Then the CLI's default sweep (8
   periods, 180,000 cells, 256 rays per cell) through ``run_design_sweep``,
   launch counts reset just before it and read just after (one
   ``vector_trace`` launch per segment), its wall (host prep and seeding
   apart) and peak memory beside phase 6a's, design 3's digest; design 3
   must equal its solo sweep bit for bit;
13. the exact splitting engine: (a) the README's case, 16 x 12 FoV x 3
   wavelengths = 576 cells, 64 launch positions per cell in 32 passes of 2,
   threshold 1e-6, 8,192-slot wavefronts per cell: nothing truncated, the
   histogram's sum equal to the deposited weight within 1e-5, and batches of
   256 and of 100 cells identical (4 passes), and its seeding's host time;
   (b) 4 of its cells on the card
   against the CPU: histograms within rtol 2e-4 / atol 1e-10, equal steps,
   peak widths and truncation, pruned and deposited weight within 1e-4 and
   1e-5; (c) 256 cells of the 100 x 75 grid at 16 positions (8 passes of
   2): ms per cell, the widest wavefront and the full grid's time this
   implies; (d) the global engine on 3 x 2 FoV x 3 wavelengths at 4
   positions, card against CPU within the same bars, through
   ``csrc/split_trace.cu``.  Phase 12 launches ``csrc/vector_trace.cu`` and
   neither K1 nor K2 (the K2 cross-check aside, counted apart); phase 13's
   per-cell runs launch ``csrc/split_cells.cu`` once per batch and pass
   (counted: 13a, 13b and 13c's batches x passes), 13d's run
   ``split_trace`` once (one kernel), and no trace kernel.
14. ``simulate --tail-boost`` at full width through
   ``engine.hybrid.TailBoostHybrid`` with the CLI's knobs (tau 30 / 20,
   tiers up to 1024x): the reference workload, count spawn with folding,
   launch counts reset just before the hybrid's run and read just after
   it (the pilot's and the bulk's batches and one launch per tier and
   chunk); the selected cells, tiers, tail rays and launches per tier, the
   tail's largest ``nb[:, 1]`` against the 100,000-iteration cap and the
   cells it stopped (ROADMAP F5), pilot, tail and bulk seconds, starved
   eye positions before (phase 3b's run) and after; it fails unless the
   starved positions fall and every patched metric is finite.  Then four
   cells of the top tier with their seeds (the tail's iteration tag) and
   spawn target: the kernel once to the end (each cell reaches its target
   or the cap), and kernel and plain version over the first 1,024
   iterations, bit for bit (the plain version takes about 8.5 ms an
   iteration; the whole ~75,000-iteration chain would take it minutes);
14g. ``simulate --tail-boost`` with no other flag: the hybrid around the
   default ``Simulator`` (gens spawn, unfolded) at the reference workload,
   launch counts reset just before its run and read just after it (the
   pilot's and the bulk's 44 launches each and one launch per tier and
   chunk): tiers and their launches, the tail's largest ``nb[:, 1]`` and
   the cells stopped at the 100,000-iteration cap short of their rays
   (ROADMAP F5; reported, not held), pilot, tail and bulk seconds, the
   splice on the card (perception, colorimetry, pull), starved
   eye positions before (phase 3's run) and after; it fails if a metric is
   not finite, an efficiency is not positive or the starved positions
   rise;
14b. ``simulate --tail-exact`` at 20 x 15 FoV (the grid cut from 100 x 75;
   the reference budget per cell) through ``ExactTailHybrid`` with the
   CLI's knobs: selected cells, pruned weight, pilot (timed twice: its first
   run holds the process's first uses of the splitting operations), tail
   and bulk seconds, starved positions; the bulk as ``simulate`` runs it
   (gens spawn, one launch per iteration), the pilot and the tail one
   ``split_cells`` launch per chunk and pass;
15. ``optimize``: the README's apodization case (16 x 12 FoV, 16 rays per
   FoV, 4,096 slots, 64 trace steps, 40 Adam steps) and its joint case
   (24 x 18, 8 rays, tied pitch and orientation with the apodization,
   ``pupil_bins=24``, 16,384 slots), each with its layers over two timed
   steps (forward, backward, Adam), its Adam steps cut to a time budget
   (printed), and the truncated and deposited weight of its first and last
   trace; both README cases truncate part of their wavefront (as in the
   JAX package), so the no-truncation check runs on a third case, the
   apodization grid at 2 rays per FoV in 262,144 slots.  The loss must fall
   in every case.  Launch counts are reset just before each run and read
   just after it: the run's traces go through ``split_trace`` (one call per
   Adam step and one for the final loss) and its gradients through
   ``split_trace_backward`` (one per Adam step), each call one kernel.
16. the mesh (``parallel/shard.py``; one H100, so no multi-GPU scaling is
   measured): (a) an NCCL process group of world size 1 in this process and
   ``Simulator(mesh=)`` at the reference workload in count spawn, folded:
   histogram (SHA-256 of its bytes), bounces, efficiencies and metrics bit
   for bit phase 3b's; (b) two
   spawned ranks on the one card over gloo run the same through
   ``Simulator(mesh=)``, each rank its half of every batch, the tiles
   gathered through host memory: every rank's result equal to phase 3b's;
   each rank's K1 time, gather time and wall; (c) four ranks on a 2 x 2
   ``(cells, samples)`` mesh at phase 2's size (144 cells, 2,048 slots,
   count target 10,000 per seed block): the sample-sharded trace and the
   2 x 2 trace equal the sums of the one-rank runs with the same seed
   blocks, and the cell-sharded trace with one shared launch tile equals it
   with per-cell copies and the one-rank run; (d) two ranks run phase 6a's
   sweep with a mesh: every design's efficiencies, bounces and metrics and
   design 3's kept histogram bitwise phase 6a's; (e) an NCCL group of two
   ranks on the one card: whether NCCL refuses it (recorded).  Launch counts
   are reset just before (a), (b) and (d) and read just after; (b) and (d)
   count in their ranks;
17. ``simulate --profile-dir`` through the CLI on the card at 20 x 15 FoV
   (the grid cut 25x): the ``torch.profiler`` trace must exist and name K1's
   CUDA kernel among its device events;
18. the reference workload in count spawn, folded, with
   ``TraceConfig(pupil_sampler="native")``: the native pupil sampler built
   by ``g++`` from the port's copy of ``host_sampler.cpp`` (its build
   time), launch counts reset just before the run and read just after;
   every colour's efficiency finite, positive and within 2 % of phase 3b's
   (the same count spawn and cell seeds, other pupil points).

Phases 3, 3b, 8, 10 and 14g print and record the ``Simulator``'s setup
split (geometry, the rows' host inputs, their upload and launch with the
kernel's CUDA-event time, trace geometry, the kernels' build), phases 6 and
6c the sweep's prep split (``prep_geometry_s``, ``prep_host_rows_s``,
``prep_rows_s`` with ``prep_rows_ms``, ``prep_tiles_s``); each run they
count must have launched the rows' kernel once per ``Simulator`` or chunk.
Phases 3, 3b, 6, 6c, 8 and 14g also hold each counted run to the tail's
kernels: one perception and one colorimetry per ``simulate`` run; in a
sweep one perception per design and one colorimetry of its stack; in
``--tail-boost`` one perception for the pilot, each tier chunk and the
bulk, and the splice's colorimetry.  Phase 6 also holds design 3's metrics
to its solo sweep's, bit for bit.

Phases 2, 3, 3b, 5, 6, 9, 10 and 6c also record the persistent kernel's
live fraction, ``sum(nb[:, 0]) / (slots per cell * sum(nb[:, 1]))``: the
share of slot-iterations that made a bounce (with transit jumps a skipped
hop counts as a bounce, so it may pass 1).  Phases 3, 3b and 10 also record
the kernel's bound over the whole run (:func:`simulate_bound_ms`).

After the phases, the efficiency bar: each colour's efficiency of phase 3,
phase 3b and the cell engine (phase 8) with the relative gaps, and over the
three seeds of phases 3 and 3b each colour's mean gap and spread; it fails
if a colour of phase 3 lies more than 1.5 % from the cell engine's (both
weigh launch points equally; count spawn weighs them by their rays' inverse
lifetime).  Without phase 3 or 8 it says that it was skipped and why.

Any failure exits non-zero without the result line.  On success the line
before the last is the kernels' JSON summary and the last line is
``{"ok": true, "device": {...}}``.  ``--record PATH`` also writes every
number measured to PATH as JSON.  ``--phases 2,3`` or ``--phases 9,10,6c`` runs only those phases
(phase 1 always runs) and prints neither summary nor result line: it serves
comparisons of two versions of one phase within one call.  The port's package ``__init__`` turns
transparent huge pages off for the process (``GRT_KEEP_THP=1`` keeps them),
so its host timings run with THP off.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import inspect
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PORT = "gpu_ray_tracing_for_waveguide_based_ar_display_torch"
JAX_PACKAGE = PORT[:-len("torch")] + "tpu"   # the reference, never imported
KERNELS = {   # name -> (source in the repo, the TPU kernel it replaces)
    "persistent_trace": (f"{PORT}/csrc/persistent_trace.cu",
                         f"{JAX_PACKAGE}/engine/trace_pallas_persistent.py:233"),
    "cell_trace": (f"{PORT}/csrc/cell_trace.cu",
                   f"{JAX_PACKAGE}/engine/trace_pallas.py:397"),
    # port-side: the host numpy row pipeline it replaces has no TPU kernel
    "cell_rows": (f"{PORT}/csrc/cell_rows.cu",
                  f"{PORT}/luts/packing.py:127 build_cell_tables + "
                  f"{PORT}/engine/trace_rows.py:79 build_kernel_cell_params "
                  "(host numpy, no TPU counterpart)"),
    # port-side: the JAX package's tail is jnp, with no Pallas counterpart
    "eye_perceive": (f"{PORT}/csrc/eye_tail.cu",
                     f"{JAX_PACKAGE}/eval/metrics.py:88 eye_perceived_jnp "
                     "(jnp, no Pallas counterpart)"),
    "colorimetry": (f"{PORT}/csrc/eye_tail.cu",
                    f"{JAX_PACKAGE}/eval/metrics.py:266 _make_eval_core "
                    "(jnp, no Pallas counterpart)"),
    # port-side: the JAX per-cell engine is jnp under lax.while_loop
    "split_cells": (f"{PORT}/csrc/split_cells.cu",
                    f"{JAX_PACKAGE}/engine/splitting.py:720 "
                    "make_splitting_cells_fn's trace (jnp under "
                    "lax.while_loop, no Pallas counterpart)"),
    # port-side: the JAX vector engine is jnp under lax.while_loop
    "vector_trace": (f"{PORT}/csrc/vector_trace.cu",
                     f"{JAX_PACKAGE}/engine/trace_jnp.py:140 "
                     "make_trace_fn_dynamic's trace_core (:378, jnp under "
                     "lax.while_loop :393, no Pallas counterpart)"),
    # port-side: the JAX global engine is jnp under lax.scan, its gradient
    # jax.value_and_grad of it
    "split_trace": (f"{PORT}/csrc/split_trace.cu",
                    f"{JAX_PACKAGE}/engine/splitting.py:466 "
                    "make_splitting_trace_fn's trace (jnp under lax.scan / "
                    "lax.while_loop, no Pallas counterpart)"),
    "split_trace_backward": (f"{PORT}/csrc/split_trace.cu",
                             f"{JAX_PACKAGE}/engine/splitting.py:466 "
                             "make_splitting_trace_fn under "
                             "jax.value_and_grad (no Pallas counterpart)"),
}
# the libraries of csrc/ the kernels live in, one nvcc process each
LIBRARIES = list(dict.fromkeys(Path(src).stem for src, _ in KERNELS.values()))
# one NVIDIA H100 SXM (data sheet, 700 W): FP32 and FP64 rates outside the
# tensor cores and HBM rate, for the bounds of the kernel line
PEAK_FP32_OPS = 67e12
PEAK_FP64_OPS = 34e12
# float32 adds: an add is one lane instruction, issued at 132 SMs x 128 lanes
# x 1.98 GHz (the SXM part's boost clock); PEAK_FP32_OPS counts an FMA as two
PEAK_FP32_ADDS = 132 * 128 * 1.98e9
# float64 lane instructions: 64 FP64 lanes an SM at the same clock (half
# the FP32 lanes; PEAK_FP64_OPS counts a DFMA as two)
PEAK_FP64_LANES = 132 * 64 * 1.98e9
PEAK_HBM_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_entry(line: str):
    """The label of the kernel instantiation an nvcc -Xptxas -v line starts,
    its template arguments (the persistent kernel's are GENS, SEL, MULTI),
    or None."""
    entry = re.search(r"Compiling entry function '(\S+)'", line)
    if not entry:
        return None
    targs = re.findall(r"L[bi](\d+)E", entry.group(1))
    return f"[{','.join(targs)}]" if targs else "[kernel]"


def ptxas_summary(log: str) -> str:
    """Registers, shared memory and spills from nvcc's -Xptxas -v output,
    each kernel instantiation under its label."""
    keep = []
    for ln in log.splitlines():
        label = ptxas_entry(ln)
        if label:
            keep.append(label)
        elif re.search(r"registers|spill|smem", ln):
            keep.append(re.sub(r"^ptxas info\s*:\s*", "", ln.strip()))
    return " | ".join(keep) if keep else "(no ptxas report)"


def ptxas_spills(log: str) -> dict:
    """Spill store and load bytes of each kernel instantiation in nvcc's
    -Xptxas -v output, keyed as :func:`ptxas_summary` labels them."""
    out, name = {}, None
    for ln in log.splitlines():
        name = ptxas_entry(ln) or name
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
        if spill and name is not None:
            out[name] = int(spill.group(1)) + int(spill.group(2))
    return out


def named_spills(log: str, name: str):
    """Spill store and load bytes of the kernel whose mangled name holds
    ``name`` in nvcc's -Xptxas -v output (None when the log has none)."""
    cur = None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            cur = entry.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
        if spill and cur is not None and name in cur:
            return int(spill.group(1)) + int(spill.group(2))
    return None


def live_fraction(nb, slots_per_cell: int) -> float:
    """Bounces per slot-iteration of a launch: sum(nb[:, 0]) / (slots per
    cell * sum(nb[:, 1])).  ``nb[:, 1]`` is each cell's block's iteration
    count, so with k cells per block this is sum(nb[:, 0]) / (block slots
    * summed block iterations)."""
    import numpy as np

    nb = np.asarray(nb.cpu() if hasattr(nb, "cpu") else nb).astype(np.int64)
    return float(nb[:, 0].sum()) / (slots_per_cell * float(nb[:, 1].sum()))


def cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """CUDA-event milliseconds per call of ``fn`` on the device alone: the
    calls are queued behind about 0.1 s of device spin, so the host's cost
    of launching them (more than a short kernel takes) is not counted."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(170_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(inputs, outputs, nb, n_r1: int, ops_per_edge: int = 4,
             hops_per_test: int = 1):
    """The least time the card could take for one launch, and what sets it.

    Bytes: every input read once and every output written once.  Operations:
    the float32 work every bounce does at least, the r1 containment test
    (two multiplies, an add and a compare: 4 operations per edge; the packed
    max chain: 3), times this run's bounces; the Jones products, strip
    selection and roulette of the bounces that interact are not counted, so
    the bound is a floor.  A transit jump's skipped hops are counted bounces
    without a test, and the kernel does not report how many it skipped: one
    test covers at most ``hops_per_test`` counted bounces (15 phased by
    squaring, 4,095 by cos / sin), so at least bounces / hops_per_test were
    tested."""
    import torch

    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    ops = (float(nb[:, 0].to(torch.int64).sum()) / hops_per_test
           * ops_per_edge * n_r1)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def run_shape(sim) -> tuple:
    """``(rays per cell and launch, launches per batch, slots, generations)``
    of a persistent ``Simulator.run()`` at its configuration's workload:
    folded, one launch per batch of ``num_iter * rays_per_fov`` rays per
    cell; otherwise one launch per batch and iteration."""
    cfg = sim.cfg
    if sim._fold_iterations and cfg.num_iter > 1:
        rpf, iters = cfg.rays_per_fov * cfg.num_iter, 1
    else:
        rpf, iters = cfg.rays_per_fov, cfg.num_iter
    return (rpf, iters) + tuple(sim._slots_gens(rpf))


def simulate_bound_ms(sim, res) -> tuple:
    """:func:`bound_ms` of a whole ``Simulator.run`` at its configuration's
    workload: the bytes every launch must move (cell rows, packed words,
    the shared launch tile and geometry row once per launch, the seeds, the
    histograms and ``nb``) and the r1 test of every bounce, with the
    selection's operations per edge and a jump's hops per test."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_rows,
    )

    tr = sim.tracer
    n = sim.L * sim.M * sim.N
    _, iters, slots, _ = run_shape(sim)
    ny, nx = tr.eyebox_bins
    packed = tr.accum_mode == "packed"
    words = tr.cell_params_packed.shape[1] if packed else 0
    launches = math.ceil(n / 2048) * iters
    nbytes = (iters * n * (trace_rows.PC + words + slots + ny * nx + 4) * 4
              + launches * (trace_rows.PG + 6 * slots + 2) * 4)
    hops = (15 if tr.jump_phase == "pow2" else 4095) if tr.transit_jump else 1
    ops = (res.total_bounces / hops * (3 if packed else 4)
           * tr.edge_counts[1])
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def jax_modules() -> list:
    """Modules of jax or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", JAX_PACKAGE)))


def profile_run(sim, path: str) -> dict:
    """One more ``sim.run()`` under ``torch.profiler``, as ``simulate`` runs
    it (:func:`simulate_options`): device busy time (sum of the device's
    self times), the kernel's and the device-to-host copies' share of it,
    and the idle share of the host-clock window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = sim.run(**simulate_options())
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ka = prof.key_averages()
    # device-side events only, as the profiler's own "Self CUDA time total"
    # counts them (host ops carry their children's device time as well)
    dev = {e.key: e.self_device_time_total / 1e6 for e in ka
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    busy = sum(dev.values())
    kernel = sum(t for k, t in dev.items() if "persistent_trace_kernel" in k)
    dtoh = sum(t for k, t in dev.items() if "Memcpy DtoH" in k)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(ka.table(sort_by="self_device_time_total",
                                   row_limit=25))
    if busy <= 0:
        fail("the profiler recorded no device time")
    return {"window_s": window, "trace_s": res.trace_seconds,
            "device_busy_s": busy, "kernel_device_s": kernel,
            "dtoh_copy_s": dtoh, "idle_share": 1.0 - busy / window,
            "timings": res.timings}


def digest(t) -> str:
    """SHA-256 of a tensor's or an array's bytes, on the host."""
    a = t.cpu().numpy() if hasattr(t, "cpu") else t
    return hashlib.sha256(a.tobytes()).hexdigest()


def simulate_options(*flags) -> dict:
    """``Simulator.run``'s keyword arguments as ``simulate`` passes them
    with these flags (``cli.run_options``), so that a phase runs what the
    CLI runs: the histogram kept on the card, perception and colorimetry
    with the eye-view image on the card."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli

    return cli.run_options(cli.build_parser().parse_args(["simulate",
                                                          *flags]))


def tail_text(tm: dict) -> str:
    """A run's device tail from its timings, for a phase's line."""
    return (f"tail {tm['metrics_s']:.3f} s (perception "
            f"{tm['perceive_ms']:.2f} ms, colorimetry "
            f"{tm['colorimetry_ms']:.2f} ms device, metrics and image pull "
            f"{tm['pull_s'] * 1e3:.2f} ms)")


def tail_check(phase: str, met, host) -> dict:
    """A run's device tail (``met``: float32 colorimetry on the card)
    against ``host``, the float64 host colorimetry of the same histogram:
    fails unless delta E, FoV and eyebox uniformity lie within 1e-4
    relative, the eye-view image within rtol 2e-3 / atol 1e-5 (the JAX
    package's own bar) and the starved eye positions are equal."""
    import numpy as np

    rel = {k: abs(getattr(met, k) - getattr(host, k))
           / max(abs(getattr(host, k)), 1e-30)
           for k in ("delta_e", "u_fov", "u_eyebox")}
    img_ok = bool(np.allclose(met.output_image, host.output_image,
                              rtol=2e-3, atol=1e-5))
    out = {"metrics_rel": rel, "image_within_bar": img_ok,
           "image_max_abs": float(np.abs(met.output_image
                                         - host.output_image).max()),
           "starved": [met.starved_eye_positions,
                       host.starved_eye_positions]}
    print(f"phase {phase}: the device tail against the host float64 tail: "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + f" relative; image max abs {out['image_max_abs']:.3g} "
          f"({'within' if img_ok else 'BEYOND'} rtol 2e-3, atol 1e-5); "
          f"starved eye positions {out['starved']}")
    if (max(rel.values()) > 1e-4 or not img_ok
            or out["starved"][0] != out["starved"][1]):
        fail(f"phase {phase}: the device tail differs from the host tail: "
             f"{out}")
    return out


def save_record(ctx) -> None:
    if ctx["record_path"]:
        path = Path(ctx["record_path"])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(ctx["record"], indent=2))


def trace_launches(launches: dict) -> dict:
    """The trace kernels' launch counts of ``launches`` (without the rows'
    and the tail's kernels, which a phase checks apart)."""
    return {k: launches[k] for k in ("persistent_trace", "cell_trace")}


def tail_launches(ctx, phase: str, launches: dict, perceive: int,
                  colorimetry: int) -> None:
    """Fails unless the tail's kernels launched ``perceive`` and
    ``colorimetry`` times in the counted run of ``phase``; adds them to the
    kernel line's counts."""
    got = (launches["eye_perceive"], launches["colorimetry"])
    if got != (perceive, colorimetry):
        fail(f"phase {phase}: {got[0]} eye_perceive and {got[1]} colorimetry "
             f"launches, expected {perceive} and {colorimetry} (the tail "
             "runs through csrc/eye_tail.cu on the card)")
    for k, n in zip(("eye_perceive", "colorimetry"), got):
        ctx.setdefault("tail_launches", {}).setdefault(k, 0)
        ctx["tail_launches"][k] += n


def rows_built(ctx, phase: str, launches: dict, want: int) -> None:
    """Fails unless the rows' kernel launched ``want`` times in the counted
    run of ``phase``; adds its launches to the kernel line's count."""
    got = launches["cell_rows"]
    if got != want:
        fail(f"phase {phase}: {got} cell_rows launches, expected {want} "
             "(the kernel engines' synthetic rows are built on the card)")
    ctx["rows_launches"] = ctx.get("rows_launches", 0) + got


def setup_text(sim) -> str:
    """A Simulator's setup split: geometry, the rows' host inputs, their
    upload and kernel (host seconds; the kernel's CUDA-event time), the
    trace geometry, the kernels' build and bind, and where the engine has
    them the host tables and the vector tracer's build."""
    st = sim.setup_timings
    return (f"setup {sim.setup_seconds:.3f} s [geometry "
            f"{st.get('geometry_s', 0.0):.3f} s, host row inputs "
            f"{st.get('host_rows_s', 0.0):.3f} s, rows upload + launch "
            f"{st.get('rows_s', 0.0):.4f} s (kernel "
            f"{st.get('rows_ms', float('nan')):.3f} ms), trace geometry "
            f"{st.get('trace_geometry_s', 0.0):.3f} s, kernel build and bind "
            f"{st.get('kernel_build_s', 0.0):.3f} s"
            + (f", host tables {st['host_tables_s']:.3f} s"
               if "host_tables_s" in st else "")
            + (f", vector tracer (tables, grids, subgrids) "
               f"{st['vector_tracer_s']:.3f} s" if "vector_tracer_s" in st
               else "") + "]")


def phase1(ctx) -> None:
    """The card, the versions, and every kernel's build."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import build

    record = ctx["record"]
    smi = nvidia_smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = build.build_all(LIBRARIES)
    both = time.perf_counter() - t0
    record.update(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  build_wall_seconds=both, build_seconds={}, ptxas={})
    for name, lib_path in zip(LIBRARIES, paths):
        info = build.build_info[name]
        if info["log"]:
            print(f"nvcc build {name}: {info['seconds']:.2f} s -> "
                  f"{lib_path.name}")
        else:
            print(f"nvcc build {name}: {lib_path.name} already built, not "
                  "rebuilt")
        print(f"ptxas {name}: {ptxas_summary(info['log'])}")
        record["build_seconds"][name] = info["seconds"]
        record["ptxas"][name] = ptxas_summary(info["log"])
    print(f"nvcc builds, side by side: {both:.2f} s")
    occupancy(ctx, build.build_info["persistent_trace"]["log"])
    cell_occupancy(ctx, build.build_info["cell_trace"]["log"])


def cell_occupancy(ctx, log: str) -> None:
    """Resident blocks per SM, registers and spills of the per-cell kernel
    at the widths its launch rule gives (128 threads, its launch bounds: the
    cell engine's batches, phase 7 and most resume tiles; 64: the segmented
    scheduler's 1-row tiles)."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_cell as tc,
    )

    spills = ptxas_spills(log).get("[kernel]")
    rows, faults = [], []
    for threads in (tc.BLOCK_THREADS, 64):
        occ = dict(tc.kernel_occupancy(threads), spill_bytes=spills)
        rows.append(occ)
        print(f"occupancy cell_trace, {threads} threads: "
              f"{occ['blocks_per_sm']} blocks per SM "
              f"({occ['blocks_per_sm'] * threads} threads), "
              f"{occ['registers']} registers, "
              f"{occ['local_bytes']} B local, spills "
              f"{spills if log else '(not rebuilt)'} B, static shared "
              f"{occ['static_smem']} B")
        if occ["blocks_per_sm"] < 1:
            faults.append(f"{threads} threads: no block fits an SM")
    # with a library built earlier there is no ptxas report: the run that
    # built it checked its spills
    if log and (spills is None or spills > 0):
        faults.append(f"ptxas reports spills {spills}")
    ctx["record"]["cell_occupancy"] = rows
    save_record(ctx)
    if faults:
        fail("cell_trace occupancy: " + "; ".join(faults))


def occupancy(ctx, log: str) -> None:
    """Resident blocks per SM, registers and spills of each instantiation of
    the persistent kernel at the main path's launch shape."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig, WaveguideDesign,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
        generate_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_persistent as tp, trace_rows,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
        build_trace_geometry,
    )

    cfg = TraceConfig()
    tg = build_trace_geometry(generate_geometry(
        WaveguideDesign(), cfg.num_fov_x, cfg.num_fov_y), 0.05)
    pw = (1 + tg.num_fc + tg.num_oc) * trace_rows.SEL_NW
    spills = ptxas_spills(log)
    rows, faults = [], []
    for spawn_mode in tp.SPAWN_MODES:
        for accum, k, jump, phase in (("fma", 1, False, "pow2"),
                                      ("packed", 1, False, "pow2"),
                                      ("packed", 2, False, "pow2"),
                                      ("packed", 1, True, "pow2"),
                                      ("packed", 1, True, "cos")):
            occ = tp.kernel_occupancy(
                2048, spawn_mode, accum, k, jump, phase,
                pw if accum == "packed" else 0)
            sel = tp.selection(accum, jump, phase)
            key = f"[{int(spawn_mode == 'gens')},{sel},{int(k > 1)}]"
            row = dict(occ, instantiation=key, spawn_mode=spawn_mode,
                       accum_mode=accum, cells_per_block=k,
                       transit_jump=jump, jump_phase=phase if jump else None,
                       spill_bytes=spills.get(key))
            rows.append(row)
            print(f"occupancy {key} {spawn_mode}, {accum}"
                  f"{' + jump ' + phase if jump else ''}, {k} cell(s) of "
                  f"{2048 // k} slots, {occ['threads']} threads: "
                  f"{occ['blocks_per_sm']} blocks per SM (launch bounds ask "
                  f"{occ['launch_bound_blocks']}), {occ['registers']} "
                  f"registers, {occ['local_bytes']} B local, spills "
                  f"{row['spill_bytes'] if log else '(not rebuilt)'} B, "
                  f"shared {occ['dynamic_smem']} + "
                  f"{occ['static_smem']} B")
            want = tp.shared_bytes(2048, k, pw if accum == "packed" else 0,
                                   jump, spawn_mode == "gens")
            if occ["dynamic_smem"] != want:
                faults.append(f"{key}: the kernel sizes its shared memory "
                              f"{occ['dynamic_smem']} B, the wrapper {want} B")
            if occ["static_smem"] > tp._STATIC_SMEM:
                faults.append(f"{key}: static shared memory "
                              f"{occ['static_smem']} B, the wrapper counts "
                              f"{tp._STATIC_SMEM} B")
            if occ["blocks_per_sm"] < occ["launch_bound_blocks"]:
                faults.append(f"{key}: {occ['blocks_per_sm']} blocks per SM, "
                              f"its launch bounds ask "
                              f"{occ['launch_bound_blocks']}")
            # with a library built earlier there is no ptxas report: the
            # run that built it checked its spills
            if log and (row["spill_bytes"] is None or row["spill_bytes"] > 0):
                faults.append(f"{key}: ptxas reports spills "
                              f"{row['spill_bytes']}")
    if rows[0]["blocks_per_sm"] < 2:
        faults.append(f"the main path's instantiation holds "
                      f"{rows[0]['blocks_per_sm']} block(s) per SM, not 2")
    ctx["record"]["occupancy"] = rows
    save_record(ctx)
    if faults:
        fail("occupancy: " + "; ".join(faults))


def phase2(ctx) -> None:
    """The persistent kernel against its plain version at the main path's
    per-cell width, in gens spawn (the default) and in count spawn."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, trace_persistent as tp,
    )

    cfg2 = TraceConfig(num_fov_x=8, num_fov_y=6, rays_per_fov=5000, num_iter=4)
    sim2 = pipeline.Simulator(cfg=cfg2, device=ctx["dev"], persistent_slots=2048)
    n2 = sim2.L * sim2.M * sim2.N
    target = cfg2.rays_per_fov * cfg2.num_iter
    # the main path's launch: one iteration of 5,000 rays a cell as gens of
    # 2,048 slots; the count-spawn folded path's: a target of 20,000 rays
    slots, gens = sim2._slots_gens(cfg2.rays_per_fov)
    rays_in, rng_in = sim2._device_ray_blocks(np.arange(n2), slots)
    tr = sim2.tracer
    kw = dict(num_fc=tr.num_fc, num_oc=tr.num_oc, edge_counts=tr.edge_counts,
              eyebox_bins=tr.eyebox_bins, max_iters=tr.max_iters)
    record = ctx["record"]["phase2"] = {}
    modes = []
    for mode, first in (("gens", gens), ("count", target)):
        ctrl = torch.tensor([first, 0], dtype=torch.int32, device=ctx["dev"])
        args = (tr.cell_params, tr.geom_row, rays_in, rng_in, ctrl)
        mkw = dict(kw, spawn_mode=mode)
        hk, nbk = tp.persistent_trace(*args, **mkw)            # warm-up
        torch.cuda.synchronize()
        hp, nbp = tp.persistent_trace_reference(*args, **mkw)  # warm-up
        torch.cuda.synchronize()
        ms_kernel = cuda_ms(lambda: tp.persistent_trace(*args, **mkw), 5)
        ms_plain = cuda_ms(
            lambda: tp.persistent_trace_reference(*args, **mkw), 1)
        max_abs = float((hk - hp).abs().max())
        bound2, bound_by2 = bound_ms(args, (hk, nbk), nbk, tr.edge_counts[1])
        same_hist = bool(torch.equal(hk, hp))
        same_nb = bool(torch.equal(nbk[:, [0, 2]], nbp[:, [0, 2]]))
        nbk_h = nbk.cpu().numpy()
        live2 = live_fraction(nbk_h, slots)
        print(f"phase 2 {mode}: {n2} cells x {slots} slots, ctrl "
              f"[{first}, 0]: kernel {ms_kernel:.3f} ms, plain "
              f"{ms_plain:.3f} ms, live fraction {live2:.4f}; deposits "
              f"{float(hk.sum()):.0f} vs {float(hp.sum()):.0f}, bounces "
              f"{int(nbk_h[:, 0].sum())} vs {int(nbp[:, 0].sum())}, spawned "
              f"{int(nbk_h[:, 2].sum())} vs {int(nbp[:, 2].sum())}, "
              f"iterations max {int(nbk_h[:, 1].max())}; max |hist diff| "
              f"{max_abs}")
        record[mode] = {
            "cells": n2, "slots": slots, "ctrl": [first, 0],
            "kernel_ms": ms_kernel, "plain_ms": ms_plain,
            "bound_ms": bound2, "bound_by": bound_by2,
            "deposits": float(hk.sum()), "bounces": int(nbk_h[:, 0].sum()),
            "spawned": int(nbk_h[:, 2].sum()),
            "max_iterations": int(nbk_h[:, 1].max()),
            "max_abs_err": max_abs, "hist_identical": same_hist,
            "nb_identical": same_nb,
            "bounces_per_s_kernel": int(nbk_h[:, 0].sum()) / (ms_kernel / 1e3),
            "live_fraction": live2,
        }
        save_record(ctx)
        if not (same_hist and same_nb):
            fail(f"phase 2 {mode}: kernel disagrees with its plain version "
                 f"(hist identical {same_hist}, bounces/spawned identical "
                 f"{same_nb}, max |diff| {max_abs})")
        if float(hk.sum()) <= 0:
            fail(f"phase 2 {mode} made no deposits")
        if mode == "gens" and int(nbk_h[:, 2].sum()) != n2 * slots * gens:
            fail(f"phase 2 gens: {int(nbk_h[:, 2].sum())} rays spawned, not "
                 f"{n2} x {slots} x {gens}")
        modes.append({"mode": mode, "ctrl": [first, 0], "designs": 1,
                      "cells": n2, "slots": slots, "ms": ms_kernel,
                      "plain_ms": ms_plain, "bound_ms": bound2,
                      "bound_by": bound_by2, "max_abs_err": max_abs,
                      "live_fraction": live2})
    # the first mode is the main path's: the kernel line's headline
    ctx["k1_modes"] = modes


# the count-spawn folded path: the faster option, which weighs launch
# points by their rays' inverse lifetime; the phases about it pin it
COUNT_FOLDED = {"spawn_mode": "count", "fold_iterations": True}
# phases 3 and 3b run these seeds beside --seed 0, each with seed 0's LUTs
# (the synthetic LUTs take their seed from --seed too): the Monte-Carlo
# spread of the efficiencies (ROADMAP F7)
EXTRA_SEEDS = (1, 2)
# the largest relative gap allowed between each colour's efficiency of
# phase 3 and the cell engine's (phase 8): both weigh launch points equally
EFFICIENCY_BAR = 0.015


def main_path(ctx, phase: str, **sim_kw):
    """The reference workload through the port's ``Simulator`` as
    ``simulate`` runs it (with ``sim_kw``), its layers, checks and record;
    launch counts reset just before it and read just after it.  Returns the
    Simulator, the result, its launches and the rays a cell is normalised
    to."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, trace_persistent as tp,
    )

    cfg = TraceConfig()   # reference workload: 100 x 75 x 3, 5,000 x 4 rays
    torch.cuda.reset_peak_memory_stats()
    tp.reset_launch_counts()
    t0 = time.perf_counter()
    sim = pipeline.Simulator(cfg=cfg, device=ctx["dev"], **sim_kw)
    res = sim.run(**simulate_options())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tp.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    n_cells = sim.L * sim.M * sim.N
    rpf, iters, slots, gens = run_shape(sim)
    count = sim._spawn_mode == "count"
    # rays a cell is normalised to: the count target, or every generation
    nominal = sim._pers_nominal(slots, gens, rpf) * iters
    batches = math.ceil(n_cells / 2048)
    met = res.metrics
    tm = res.timings
    live = live_fraction(res.cell_stats, slots)
    bound, bound_by = simulate_bound_ms(sim, res)
    mode = (f"{sim._spawn_mode} spawn, "
            f"{'folded' if sim._fold_iterations else 'unfolded'}")
    print(pipeline.format_report(res))
    print(f"phase {phase}: {mode}, {n_cells} cells, {nominal} rays/cell in "
          f"{iters} launch(es) per batch: wall "
          f"{wall:.3f} s ({setup_text(sim)}), trace "
          f"{res.trace_seconds:.3f} s, kernel "
          f"{tm['kernel_ms']:.1f} ms, seeding (device hash) "
          f"{tm['seed_s']:.3f} s host, {tm['seed_ms']:.1f} ms device, "
          f"assembly {tm['assemble_s']:.3f} s, {tail_text(tm)}; kernel "
          f"bound {bound:.4f} ms ({bound_by}); live fraction {live:.4f}; "
          "bounces "
          f"{res.total_bounces:,} ({res.bounces_per_second:.4g}/s), rays "
          f"{res.rays_traced:,}; launches {launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB; jax loaded: {'jax' in sys.modules}")
    ctx["record"][f"phase{phase}"] = {
        "spawn_mode": sim._spawn_mode,
        "fold_iterations": sim._fold_iterations,
        "cells": n_cells, "nominal_rays_per_cell": nominal, "wall_s": wall,
        "setup_s": sim.setup_seconds, "setup_timings": sim.setup_timings,
        "trace_s": res.trace_seconds,
        "timings": res.timings, "total_bounces": res.total_bounces,
        "bounces_per_s": res.bounces_per_second,
        "rays_traced": res.rays_traced, "efficiencies": res.efficiencies,
        "delta_e": met.delta_e, "u_fov": met.u_fov, "u_eyebox": met.u_eyebox,
        "starved_eye_positions": met.starved_eye_positions,
        "launches": launches, "batches": batches, "peak_bytes": peak,
        "max_iterations": int(res.cell_stats[:, 1].max()),
        "live_fraction": live, "bound_ms": bound, "bound_by": bound_by,
    }
    save_record(ctx)

    vals = list(res.efficiencies.values()) + [met.delta_e, met.u_fov,
                                              met.u_eyebox]
    if not all(math.isfinite(v) for v in vals):
        fail(f"phase {phase}: non-finite metric in {vals}")
    if not (isinstance(res.histogram, torch.Tensor) and res.histogram.is_cuda):
        fail(f"phase {phase}: the histogram left the card")
    # sums on the card, in float64
    per_colour = res.histogram.sum(dim=(1, 2, 3, 4),
                                   dtype=torch.float64).cpu().numpy()
    if (per_colour <= 0).any():
        fail(f"phase {phase}: a colour has no deposits: {per_colour}")
    spawned = res.cell_stats[:, 2]
    off = (spawned < nominal) if count else (spawned != nominal)
    if off.any():
        fail(f"phase {phase}: {int(off.sum())} cells spawned other than "
             f"{'at least ' if count else ''}{nominal} rays")
    want = sum(res.efficiencies.values()) / sim.L * nominal * n_cells
    got = float(per_colour.sum())
    if abs(got - want) > 1e-6 * want:
        fail(f"phase {phase}: histogram sum {got} vs efficiencies x rays "
             f"{want}")
    if trace_launches(launches) != {"persistent_trace": batches * iters,
                                    "cell_trace": 0}:
        fail(f"phase {phase}: launches {launches}, expected one "
             f"persistent_trace per batch and iteration ({batches * iters}) "
             "and no other trace kernel")
    rows_built(ctx, phase, launches, 1)
    tail_launches(ctx, phase, launches, 1, 1)
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    return sim, res, launches["persistent_trace"], nominal


def seed_efficiencies(ctx, phase: str, sim, res, **sim_kw) -> dict:
    """Each colour's efficiency of ``res`` (seed 0) and of the same run
    under :data:`EXTRA_SEEDS` with seed 0's geometry and LUTs, by seed."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, trace_persistent as tp,
    )

    out = {sim.cfg.seed: dict(res.efficiencies)}
    tp.reset_launch_counts()
    for seed in EXTRA_SEEDS:
        other = pipeline.Simulator(
            cfg=dataclasses.replace(sim.cfg, seed=seed), geom=sim.geom,
            luts=sim.luts, device=ctx["dev"], **sim_kw)
        out[seed] = dict(other.run(histogram_device=True,
                                   evaluate_metrics=False).efficiencies)
        del other
    torch.cuda.synchronize()
    ctx["k1_seed_launches"] = (ctx.get("k1_seed_launches", 0)
                               + tp.launch_counts["persistent_trace"])
    ctx["record"][f"phase{phase}"]["seeds"] = {str(k): v
                                               for k, v in out.items()}
    save_record(ctx)
    print(f"phase {phase} seeds (seed 0's LUTs): {json.dumps(out)}")
    return out


def phase3(ctx) -> None:
    """The main path at full width: the default, gens spawn without
    folding (and phase 4, the optional profile)."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        metrics,
    )

    sim, res, launches, nominal = main_path(ctx, "3")
    ctx["record"]["phase3"]["histogram_digest"] = digest(res.histogram)
    # the run's own stack through the host float64 colorimetry
    perc = metrics.eye_perceived_torch(res.histogram).cpu().numpy()
    ctx["record"]["phase3"]["host_tail"] = tail_check(
        "3", res.metrics,
        metrics.evaluate(None, perceive=perc.astype("float64") / nominal))
    del perc
    # ---- phase 4 (optional): where the device time of one run goes
    if ctx["profile_path"]:
        record = ctx["record"]
        record["profile"] = profile_run(sim, ctx["profile_path"])
        print(f"phase 4: {json.dumps(record['profile'])}")
        save_record(ctx)
    ctx["k1_main_launches"] = launches
    ctx["default_efficiencies"] = dict(res.efficiencies)
    ctx["default_starved"] = res.metrics.starved_eye_positions
    ctx["default_seeds"] = seed_efficiencies(ctx, "3", sim, res)


def phase3b(ctx) -> None:
    """The count-spawn folded path at full width, as phase 3 runs the
    default: what phases 10, 14, 16 and 18 are held to."""
    sim, res, launches, _ = main_path(ctx, "3b", **COUNT_FOLDED)
    met = res.metrics
    ctx["k1_count_main_launches"] = launches
    ctx["count_run"] = {"digest": digest(res.histogram),
                        "bounces": res.total_bounces,
                        "efficiencies": dict(res.efficiencies),
                        "metrics": [met.delta_e, met.u_fov, met.u_eyebox]}
    ctx["count_efficiencies"] = dict(res.efficiencies)
    ctx["count_starved"] = met.starved_eye_positions
    ctx["exact_run"] = stack_stats(res, run_shape(sim)[2])
    ctx["count_seeds"] = seed_efficiencies(ctx, "3b", sim, res,
                                           **COUNT_FOLDED)


def efficiency_bar(ctx) -> None:
    """Each colour's efficiency of phase 3 (the default), phase 3b (count
    spawn, folded) and the cell engine (phase 8), the relative gaps, and
    over phase 3's and 3b's seeds the mean gap and the spread; fails if a
    colour of phase 3 lies more than :data:`EFFICIENCY_BAR` from the cell
    engine's."""
    cell = ctx.get("cell_efficiencies")
    runs = {n: ctx.get(k) for n, k in (("3", "default_seeds"),
                                       ("3b", "count_seeds"))}
    if cell is None or runs["3"] is None:
        why = " and ".join(f"phase {n}" for n, v in (("3", runs["3"]),
                                                     ("8", cell)) if v is None)
        print(f"efficiency bar: skipped, {why} not in this run (the bar "
              "holds phase 3's efficiencies to the cell engine's)")
        return
    table = {}
    for name, seeds in runs.items():
        if seeds is None:
            continue
        rows = {}
        for k, ref in cell.items():
            vals = [e[k] for e in seeds.values()]
            mean = sum(vals) / len(vals)
            sd = math.sqrt(sum((v - mean) ** 2 for v in vals)
                           / (len(vals) - 1))
            rows[k] = {"efficiency": vals[0], "gap": vals[0] / ref - 1,
                       "seed_gaps": [v / ref - 1 for v in vals],
                       "mean_gap": mean / ref - 1, "spread_sd": sd / mean,
                       "spread_range": (max(vals) - min(vals)) / mean}
        table[name] = rows
    for k, ref in cell.items():
        parts = [f"cell engine {ref:.6f}"]
        for name, rows in table.items():
            r = rows[k]
            parts.append(
                f"phase {name} {r['efficiency']:.6f} ({r['gap']:+.4f}; seeds "
                + ", ".join(f"{g:+.4f}" for g in r["seed_gaps"])
                + f", mean {r['mean_gap']:+.4f}, spread sd "
                f"{r['spread_sd']:.4f}, range {r['spread_range']:.4f})")
        print(f"efficiency {k}: " + "; ".join(parts))
    worst = max(abs(r["gap"]) for r in table["3"].values())
    ctx["record"]["efficiency_bar"] = {"cell": cell, "runs": table,
                                       "bar": EFFICIENCY_BAR,
                                       "worst_gap": worst}
    save_record(ctx)
    if worst > EFFICIENCY_BAR:
        fail(f"phase 3's efficiencies lie up to {worst:.4f} from the cell "
             f"engine's, beyond the bar {EFFICIENCY_BAR}")
    print(f"efficiency bar: phase 3 within {worst:.4f} of the cell engine "
          f"in every colour (bar {EFFICIENCY_BAR})")


def stack_stats(res, slots: int) -> dict:
    """What phase 10 compares between the persistent engine's stacks (a run
    of ``slots`` slots per cell)."""
    return {"efficiencies": dict(res.efficiencies),
            "kernel_ms": res.timings.get("kernel_ms"),
            "trace_s": res.trace_seconds,
            "bounces": res.total_bounces, "rays": res.rays_traced,
            "bounces_per_ray": res.total_bounces / res.rays_traced,
            "iterations": int(res.cell_stats[:, 1].astype("int64").sum()),
            "max_iterations": int(res.cell_stats[:, 1].max()),
            "live_fraction": live_fraction(res.cell_stats, slots)}


def phase5(ctx) -> None:
    """The persistent kernel against its plain version in the sweep's modes."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig, WaveguideDesign,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_persistent as tp,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
        design_sweep,
    )

    dev = ctx["dev"]
    cfg5 = TraceConfig(num_fov_x=4, num_fov_y=3, rays_per_fov=256,
                       max_bounces=2048)
    designs5 = [dataclasses.replace(WaveguideDesign(), lambda_ic=p, lambda_oc=p)
                for p in (370.0, 387.5, 405.0)]
    rows5 = design_sweep.prepare_chunk(designs5, cfg5, 256, device=dev)
    inputs5 = (rows5.cell_params,
               torch.from_numpy(rows5.geom_rows).to(dev),
               torch.from_numpy(rows5.rays).to(dev),
               design_sweep.shared_seed_block(cfg5, 256, device=dev))
    kw5 = dict(num_fc=rows5.tgeoms[0].num_fc, num_oc=rows5.tgeoms[0].num_oc,
               edge_counts=rows5.edge_counts, eyebox_bins=cfg5.eyebox_bins,
               max_iters=cfg5.max_bounces)
    modes = []
    for mode, ctrl5 in (("gens", [1, 256]), ("gens", [2, 0]),
                        ("count", [256, 0])):
        a5 = inputs5 + (torch.tensor(ctrl5, dtype=torch.int32, device=dev),)
        kw = dict(kw5, spawn_mode=mode)
        hk, nbk = tp.persistent_trace(*a5, **kw)
        torch.cuda.synchronize()
        hp, nbp = tp.persistent_trace_reference(*a5, **kw)
        torch.cuda.synchronize()
        ms_k = cuda_ms(lambda: tp.persistent_trace(*a5, **kw), 5)
        ms_p = cuda_ms(lambda: tp.persistent_trace_reference(*a5, **kw), 1)
        err = float((hk - hp).abs().max())
        same = (torch.equal(hk, hp)
                and torch.equal(nbk[:, [0, 2]], nbp[:, [0, 2]]))
        b5, by5 = bound_ms(a5, (hk, nbk), nbk, kw5["edge_counts"][1])
        nbh = nbk.cpu().numpy()
        entry = {"mode": mode, "ctrl": ctrl5, "designs": 3,
                 "cells": int(nbh.shape[0]), "slots": 256, "ms": ms_k,
                 "plain_ms": ms_p, "bound_ms": b5, "bound_by": by5,
                 "max_abs_err": err, "identical": same,
                 "deposits": float(hk.sum()),
                 "bounces": int(nbh[:, 0].astype(np.int64).sum()),
                 "spawned": int(nbh[:, 2].astype(np.int64).sum()),
                 "max_iterations": int(nbh[:, 1].max()),
                 "live_fraction": live_fraction(nbh, 256)}
        modes.append(entry)
        print(f"phase 5: {json.dumps(entry)}")
        if not same:
            fail(f"kernel disagrees with its plain version in {mode} mode, "
                 f"ctrl {ctrl5} (max |diff| {err})")
        if entry["deposits"] <= 0:
            fail(f"phase 5 {mode} {ctrl5} made no deposits")
    ctx["record"]["phase5"] = modes
    ctx["k1_modes"] = ctx.get("k1_modes", []) + modes


def run_sweep(ctx, phase: str, name: str, argv, keep=(3,), **modes):
    """One full-width sweep from the CLI's arguments ``argv`` (and the
    kernel ``modes``), its launch count set to 0 just before and read just
    after; prints and records its layers and checks its outputs.  Returns
    ``(result, entry, designs, cfg, sweep keywords)``."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
        generate_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_persistent as tp, trace_rows,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
        build_trace_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
        design_sweep,
    )

    sargs = cli.build_parser().parse_args(argv)
    designs, _ = cli.sweep_designs(sargs)
    cfg6 = cli.sweep_config(sargs)
    kw6 = dict(spawn_iters=sargs.spawn_iters, spawn_mode=sargs.spawn_mode,
               slots=sargs.slots, evaluate_metrics=sargs.metrics,
               device=ctx["dev"], **modes)
    nbs = []   # each launch's nb, for the live fraction

    def traced(*args, **kw):
        hist, nb = trace(*args, **kw)
        nbs.append(nb)
        return hist, nb

    trace = tp.persistent_trace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tp.reset_launch_counts()
    tp.persistent_trace = traced
    try:
        t0 = time.perf_counter()
        r6 = design_sweep.run_design_sweep_persistent(
            designs, cfg6, keep_histograms=list(keep), **kw6)
        torch.cuda.synchronize()
        wall6 = time.perf_counter() - t0
    finally:
        tp.persistent_trace = trace
    n_launch = tp.launch_counts["persistent_trace"]
    n_rows = tp.launch_counts["cell_rows"]
    n_tail = {k: tp.launch_counts[k] for k in ("eye_perceive", "colorimetry")}
    peak6 = torch.cuda.max_memory_allocated()
    n_cells6 = len(designs) * 3 * cfg6.num_fov_x * cfg6.num_fov_y
    bounces6 = int(r6.bounces.sum())
    slots6 = min(cfg6.rays_per_fov, 2048)
    tgs = [build_trace_geometry(
        generate_geometry(d, cfg6.num_fov_x, cfg6.num_fov_y), 0.05)
        for d in designs]
    n_r1 = min(trace_rows.edge_counts(tg)[1] for tg in tgs)
    packed = modes.get("accum_mode") == "packed"
    jump = bool(modes.get("transit_jump"))
    words = ((1 + tgs[0].num_fc + tgs[0].num_oc) * trace_rows.SEL_NW
             if packed else 0)
    nbytes = (n_cells6 * (trace_rows.PC + words + cfg6.eyebox_bins[0]
                          * cfg6.eyebox_bins[1] + 4) * 4
              + len(designs) * (trace_rows.PG + 6 * slots6) * 4
              + n_cells6 // len(designs) * slots6 * 4 + 8)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    # the r1 test of every bounce (3 operations per edge in packed
    # selection); a jump by squaring covers at most 15 counted bounces
    t_ops = (bounces6 / (15 if jump else 1) * (3 if packed else 4) * n_r1
             / PEAK_FP32_OPS * 1e3)
    tm = r6.timings
    entry = {
        "designs": len(designs), "cells": n_cells6,
        "spawn_mode": sargs.spawn_mode, "spawn_iters": sargs.spawn_iters,
        "rays_per_fov": cfg6.rays_per_fov, "slots": slots6,
        "modes": {k: v for k, v in modes.items()},
        "wall_s": wall6, "host_prep_s": tm["prep_s"],
        "prep": {k: tm[k] for k in ("prep_geometry_s", "prep_host_rows_s",
                                    "prep_rows_s", "prep_rows_ms",
                                    "prep_tiles_s")},
        "rows_launches": n_rows, "tail_launches": n_tail,
        "seed_s": tm["seed_s"], "upload_s": tm["upload_s"],
        "keep_s": tm["keep_s"], "pull_s": tm["pull_s"],
        "metrics_s": tm.get("metrics_s"), "kernel_ms": tm["kernel_ms"],
        "reduce_ms": tm["reduce_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bounces": bounces6, "bounces_per_s": bounces6 / wall6,
        "kernel_bounces_per_s": bounces6 / (tm["kernel_ms"] / 1e3),
        "launches": n_launch, "peak_bytes": peak6,
        "live_fraction": live_fraction(torch.cat(nbs), slots6),
        "designs_per_hour": len(designs) / wall6 * 3600,
        "efficiencies": r6.efficiencies.tolist(),
        "delta_e": [m.delta_e for m in r6.metrics],
        "u_fov": [m.u_fov for m in r6.metrics],
        "u_eyebox": [m.u_eyebox for m in r6.metrics]}
    ctx["record"].setdefault(phase, {})[name] = entry
    save_record(ctx)
    print(f"phase {phase[5:]} {name}: {len(designs)} designs, {n_cells6:,} "
          f"cells in {n_launch} launch(es): wall {wall6:.3f} s (prep "
          f"{tm['prep_s']:.3f} s [geometry {tm['prep_geometry_s']:.3f} s, "
          f"host row inputs {tm['prep_host_rows_s']:.3f} s, rows upload + "
          f"launch {tm['prep_rows_s']:.4f} s (kernel "
          f"{tm['prep_rows_ms']:.3f} ms), tiles {tm['prep_tiles_s']:.3f} s],"
          f" seeds {tm['seed_s']:.3f} s, upload "
          f"{tm['upload_s']:.3f} s, kept histograms to the host "
          f"{tm['keep_s']:.3f} s, metrics "
          f"{tm.get('metrics_s', 0.0):.3f} s), kernel "
          f"{tm['kernel_ms']:.1f} ms, reduction and pupil integration "
          f"{tm['reduce_ms']:.1f} ms (kernel bound "
          f"{entry['bound_ms']:.3f} ms, "
          f"{entry['bound_by']}); bounces {bounces6:,} "
          f"({bounces6 / wall6:.4g}/s end to end, "
          f"{entry['kernel_bounces_per_s']:.4g}/s kernel); live fraction "
          f"{entry['live_fraction']:.4f}; peak device memory "
          f"{peak6 / 2**20:.1f} MiB; "
          f"{entry['designs_per_hour']:,.0f} designs/hour")
    eff = r6.efficiencies
    if eff.shape != (len(designs), 3) or not (np.isfinite(eff).all()
                                               and (eff > 0).all()):
        fail(f"phase {phase[5:]} {name}: efficiencies not all positive and "
             f"finite: {eff.tolist()}")
    mvals = entry["delta_e"] + entry["u_fov"] + entry["u_eyebox"]
    if len(r6.metrics) != len(designs) or not all(
            math.isfinite(v) for v in mvals):
        fail(f"phase {phase[5:]} {name}: non-finite metrics {mvals}")
    if n_launch != 1:
        fail(f"phase {phase[5:]} {name}: {n_launch} launches for one chunk")
    rows_built(ctx, f"{phase[5:]} {name}", {"cell_rows": n_rows}, 1)
    # one perception per design and one colorimetry of the sweep's stack
    tail_launches(ctx, f"{phase[5:]} {name}", n_tail, len(designs), 1)
    return r6, entry, designs, cfg6, kw6


def sweep_summary(r) -> dict:
    """What phase 16 holds a mesh sweep to: every design's efficiencies,
    bounces and metrics, and the kept histogram's digest."""
    return {"efficiencies": r.efficiencies.tolist(),
            "bounces": r.bounces.tolist(),
            "metrics": [[m.delta_e, m.u_fov, m.u_eyebox] for m in r.metrics],
            "kept": digest(r.histograms[0])}


def phase6(ctx) -> None:
    """The design sweep at full width."""
    import numpy as np
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
        design_sweep,
    )

    sweeps = (("cli_default", ["sweep", "--metrics"]),
              ("readme_count", ["sweep", "--num-designs", "16",
                                "--spawn-mode", "count", "--spawn-iters", "0",
                                "--rays-per-fov", "2048", "--metrics"]))
    sweep_launches = 0
    for name, argv in sweeps:
        r6, entry, designs, cfg6, kw6 = run_sweep(ctx, "phase6", name, argv)
        sweep_launches += entry["launches"]
        if name == "cli_default":
            ctx["sweep6a"] = sweep_summary(r6)
        solo = design_sweep.run_design_sweep_persistent(
            designs[3:4], cfg6, keep_histograms=True, **kw6)
        mets = [[m.delta_e, m.u_fov, m.u_eyebox, m.starved_eye_positions]
                for m in (r6.metrics[3], solo.metrics[0])]
        if not (np.array_equal(r6.histograms[0], solo.histograms[0])
                and r6.bounces[3] == solo.bounces[0]
                and np.array_equal(r6.efficiencies[3], solo.efficiencies[0])
                and mets[0] == mets[1]):
            fail(f"phase 6 {name}: design 3 differs from its solo sweep "
                 f"(metrics {mets})")
        del r6, solo
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    ctx["k1_sweep_launches"] = sweep_launches


def phase6c(ctx) -> None:
    """Phase 6's default sweep in the packed modes."""
    import numpy as np

    argv = ["sweep", "--metrics"]
    runs = {}
    for name, modes in (
            ("packed_jump", dict(accum_mode="packed", transit_jump=True)),
            ("packed", dict(accum_mode="packed")),
            ("packed_k4", dict(accum_mode="packed", cells_per_block=4))):
        r, entry, *_ = run_sweep(ctx, "phase6c", name, argv, **modes)
        runs[name] = (r.histograms[0], r.bounces.copy(),
                      r.efficiencies.copy(), entry)
        del r
    h1, b1, e1, _ = runs["packed"]
    h4, b4, e4, _ = runs["packed_k4"]
    if not (np.array_equal(h1, h4) and np.array_equal(b1, b4)
            and np.array_equal(e1, e4)):
        fail("phase 6c: four cells per block differ from one cell per block")
    print("phase 6c: four cells per block equal one cell per block (design "
          "3's histogram, every design's bounces and efficiencies); kernel "
          + ", ".join(f"{n} {runs[n][3]['kernel_ms']:.1f} ms "
                      f"({runs[n][3]['bounces']:,} bounces)" for n in runs))
    rel = np.abs(runs["packed_jump"][2] / e1 - 1).max()
    print(f"phase 6c: packed + jump efficiencies within {rel:.4f} of packed")
    # saturating spawn weighs launch points by their rays' inverse lifetime
    # in iterations, which jumps shorten: reported, and held to 10 %
    if rel > 0.10:
        fail(f"phase 6c: jump efficiencies {rel:.4f} away from packed's")
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    ctx["k1_packed_sweep_launches"] = sum(runs[n][3]["launches"] for n in runs)


def phase7(ctx) -> None:
    """The per-cell kernel against its plain version, both modes."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, trace_cell as tc,
    )

    cfg7 = TraceConfig(num_fov_x=8, num_fov_y=6, rays_per_fov=5000, num_iter=1)
    sim7 = pipeline.Simulator(cfg=cfg7, device=ctx["dev"], engine="cell")
    n7 = sim7.L * sim7.M * sim7.N
    cells = np.arange(n7)
    rays_in, rng_in = sim7._cell_blocks(cells, cfg7.rays_per_fov, 0)
    tr = sim7.tracer
    rows, n_r1 = tr.rows(cells), tr.kw["edge_counts"][1]
    first, budget = 24, cfg7.max_bounces

    def both(name, rays, rng, state, max_bounces):
        """Kernel and plain version on the same inputs: outputs, times and
        whether they are identical."""
        args = (rows, tr.geom_row, rays, rng, state)
        kw = dict(tr.kw, max_bounces=max_bounces)
        outk = tc.cell_trace(*args, **kw)             # warm-up + result
        torch.cuda.synchronize()
        # warm-up + result, with each ray's iteration count
        *outp, ray_its = tc.cell_trace_reference(*args, **kw,
                                                 ray_iterations=True)
        torch.cuda.synchronize()
        ms_k = cuda_ms(lambda: tc.cell_trace(*args, **kw), 5)
        ms_p = cuda_ms(lambda: tc.cell_trace_reference(*args, **kw), 1)
        dep, nb, ro, so, rgo = outk
        same = {"dep": torch.equal(dep, outp[0]), "nb": torch.equal(nb, outp[1]),
                "state": torch.equal(so, outp[3]),
                "rng": torch.equal(rgo, outp[4]),
                "all_fields": torch.equal(ro, outp[2])}
        err = max(float((dep - outp[0]).abs().max()),
                  float((nb - outp[1]).abs().max()),
                  float((so - outp[3]).abs().max()),
                  float((ro - outp[2]).abs().max()))
        inputs = args if state is not None else args[:4]
        b, by = bound_ms(inputs, outk, nb, n_r1)
        nbh = nb.cpu().numpy().astype(np.int64)
        C, S = rng.shape[0], int(rng[0].numel())
        threads, bpc = tc.launch_shape(C, S, tc._sm_count(rng.device))
        entry = {"mode": name, "cells": n7, "slots": S,
                 "max_bounces": max_bounces, "ms": ms_k, "plain_ms": ms_p,
                 "bound_ms": b, "bound_by": by, "max_abs_err": err,
                 "identical": same, "deposits": int((dep >= 0).sum()),
                 "bounces": int(nbh[:, 0].sum()),
                 "max_iterations": int(nbh[:, 1].max()),
                 "alive_after": int((so < 6).sum()),
                 "bounces_per_s_kernel": int(nbh[:, 0].sum()) / (ms_k / 1e3),
                 "threads": threads, "blocks_per_cell": bpc,
                 "one_thread_per_ray_lane_occupancy": tc.lane_occupancy(
                     ray_its)}
        print(f"phase 7: {json.dumps(entry)}")
        if not all(same.values()):
            fail(f"cell_trace disagrees with its plain version in {name}: "
                 f"{same} (max |diff| {err})")
        return outk, entry

    a, ea = both("full, 24 iterations", rays_in, rng_in, None, first)
    b, eb = both("resume, the rest of the budget", a[2], a[4], a[3],
                 budget - first)
    c, ec = both("full, the whole budget", rays_in, rng_in, None, budget)
    merged = torch.where(a[0] >= 0, a[0], b[0])
    whole = {"dep": torch.equal(merged, c[0]),
             "no ray deposits twice": not bool(((a[0] >= 0) & (b[0] >= 0)).any()),
             "bounces": torch.equal(a[1][:, 0] + b[1][:, 0], c[1][:, 0]),
             "state": torch.equal(b[3], c[3]), "rng": torch.equal(b[4], c[4]),
             "fields": torch.equal(b[2], c[2])}
    print(f"phase 7: full(24) + resume(rest) against full(whole): {whole}")
    ctx["record"]["phase7"] = {"modes": [ea, eb, ec], "segments_sum": whole}
    save_record(ctx)
    if not all(whole.values()):
        fail(f"full(24) + resume(rest) differs from full(whole): {whole}")
    if ec["deposits"] <= 0 or ea["alive_after"] <= 0:
        fail("phase 7 made no deposits, or no ray outlived the first segment")
    if ec["alive_after"] != 0:
        fail(f"{ec['alive_after']} rays outlived the whole budget")
    ctx["k2_modes"] = [ea, eb, ec]


class CellLaunchBounds:
    """Keeps what :func:`bound_ms` needs of every ``cell_trace`` launch in
    its ``with`` block (the bytes each launch moves and its ``nb``, left on
    the device so that recording adds no synchronisation), and sums the
    launches' bounds afterwards.  It wraps the wrapper where the cell engine
    and the segment scheduler call it, so it serves an untimed replay of a
    timed run; the wrapper alone counts launches."""

    def __init__(self, n_r1: int):
        self.n_r1, self.launches = n_r1, []

    def __enter__(self):
        from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
            cell_segments, trace_cell as tc,
        )

        self._mods = (tc, cell_segments)
        self._orig = tc.cell_trace

        def recorded(cell_params, geom_row, rays_in, rng_in, state_in=None,
                     **kw):
            out = self._orig(cell_params, geom_row, rays_in, rng_in,
                             state_in, **kw)
            ins = [cell_params, geom_row, rays_in, rng_in]
            ins += [] if state_in is None else [state_in]
            nbytes = sum(t.numel() * t.element_size() for t in (*ins, *out))
            self.launches.append((nbytes, out[1]))
            return out

        for mod in self._mods:
            mod.cell_trace = recorded
        return self

    def __exit__(self, *exc):
        for mod in self._mods:
            mod.cell_trace = self._orig

    def bound_ms(self) -> float:
        """Σ over the launches of max(bytes / HBM rate, r1-test operations
        / float32 rate), as :func:`bound_ms` counts one launch."""
        import torch

        total = 0.0
        for nbytes, nb in self.launches:
            ops = float(nb[:, 0].to(torch.int64).sum()) * 4 * self.n_r1
            total += max(nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_OPS) * 1e3
        return total


# the batches phases 8 and 12 build on the card and on the host: (batch of
# 2,048 cells, iteration); the second is a full batch at a later iteration
SEED_CHECK = ((0, 0), (9, 3))


def seeding_check(ctx, phase: str, device_build, host_build) -> dict:
    """:data:`SEED_CHECK`'s batches built by ``device_build(cells,
    iteration)`` (the engine's own build: on the card under the default
    config) and by ``host_build`` (every ray seeded on the host, as
    ``build_ray_batch`` seeds it), each timed; the two must be equal
    (``torch.equal``, field for field)."""
    import numpy as np
    import torch

    out = []
    for batch, it in SEED_CHECK:
        cells = np.arange(batch * 2048, (batch + 1) * 2048)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = host_build(cells, it)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        got = device_build(cells, it)
        end.record()
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        if isinstance(want, dict):
            same = list(got) == list(want) and all(
                got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
                for k in want)
        else:
            same = all(g.dtype == w.dtype and torch.equal(g, w)
                       for g, w in zip(got, want, strict=True))
        out.append({"cells": [int(cells[0]), int(cells[-1]) + 1],
                    "iteration": it, "equal": bool(same),
                    "host_build_s": host_s, "engine_build_s": dev_s,
                    "engine_build_ms": start.elapsed_time(end)})
        del want, got
        print(f"phase {phase} seeding: cells {cells[0]}-{cells[-1] + 1} at "
              f"iteration {it}: the engine's build {dev_s:.4f} s host, "
              f"{out[-1]['engine_build_ms']:.2f} ms device; the host build "
              f"{host_s:.3f} s; {'equal' if same else 'DIFFERENT'}")
        if not same:
            fail(f"phase {phase}: the engine's batch of cells {cells[0]}-"
                 f"{cells[-1] + 1} at iteration {it} differs from the host "
                 "build")
    torch.cuda.empty_cache()
    return out


def phase8(ctx) -> None:
    """The cell engine at full width, monolithic and segmented."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, seeding, trace_persistent as tp, trace_rows,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        metrics,
    )

    cfg = TraceConfig()   # 100 x 75 x 3 cells, 5,000 rays per cell and launch
    iters = 1             # one of the reference workload's four relaunches
    runs = {}
    for name, segmented in (("monolithic", False), ("segmented", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tp.reset_launch_counts()
        t0 = time.perf_counter()
        sim = pipeline.Simulator(cfg=cfg, device=ctx["dev"], engine="cell",
                                 segmented=segmented)
        res = sim.run(num_iter=iters, **simulate_options())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(tp.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        n_cells = sim.L * sim.M * sim.N
        batches = math.ceil(n_cells / 2048) * iters
        tm, met = res.timings, res.metrics
        kernel_s = tm["kernel_ms"] / 1e3
        entry = {
            "cells": n_cells, "rays_per_cell": cfg.rays_per_fov,
            "num_iter": iters, "segmented": segmented, "wall_s": wall,
            "setup_s": sim.setup_seconds, "setup_timings": sim.setup_timings,
            "trace_s": res.trace_seconds,
            "timings": tm, "total_bounces": res.total_bounces,
            "bounces_per_s": res.bounces_per_second,
            "kernel_bounces_per_s": res.total_bounces / kernel_s,
            "rays_traced": res.rays_traced, "deposits": res.deposits,
            "efficiencies": res.efficiencies, "delta_e": met.delta_e,
            "u_fov": met.u_fov, "u_eyebox": met.u_eyebox,
            "histogram_digest": digest(res.histogram),
            "launches": launches, "batches": batches, "peak_bytes": peak}
        ctx["record"].setdefault("phase8", {})[name] = entry
        save_record(ctx)
        print(pipeline.format_report(res))
        print(f"phase 8 {name}: {n_cells} cells x {cfg.rays_per_fov} rays, "
              f"num_iter {iters} of the workload's {cfg.num_iter}: wall "
              f"{wall:.3f} s ({setup_text(sim)}), trace "
              f"{res.trace_seconds:.3f} s, seeding {tm['seed_s']:.3f} s host, "
              f"{tm.get('seed_ms', float('nan')):.1f} ms device, "
              f"kernel {tm['kernel_ms']:.1f} ms, compaction "
              f"{tm.get('compact_ms', 0.0):.1f} ms, deposit scatter "
              f"{tm['scatter_ms']:.1f} ms, assembly (a synchronize) "
              f"{tm['assemble_s']:.3f} s, {tail_text(tm)}; "
              f"bounces {res.total_bounces:,} "
              f"({res.bounces_per_second:.4g}/s end to end, "
              f"{entry['kernel_bounces_per_s']:.4g}/s kernel), deposits "
              f"{res.deposits:,}; launches {launches}; peak device memory "
              f"{peak / 2**20:.1f} MiB")
        vals = list(res.efficiencies.values()) + [met.delta_e, met.u_fov,
                                                  met.u_eyebox]
        if not all(math.isfinite(v) for v in vals) or min(
                res.efficiencies.values()) <= 0:
            fail(f"phase 8 {name}: metric not finite or efficiency not "
                 f"positive in {vals}")
        # the float64 sum on the card
        got = float(res.histogram.sum(dtype=torch.float64))
        if got != res.deposits or res.deposits <= 0:
            fail(f"phase 8 {name}: histogram sum {got} vs {res.deposits} "
                 "deposits")
        if not segmented:
            # the host tail of the same histogram (pulled), as run() gives
            # it with histogram_device=False
            host = res.histogram.cpu().numpy() / (cfg.rays_per_fov * iters)
            th = time.perf_counter()
            entry["host_tail"] = tail_check("8", met, metrics.evaluate(host))
            entry["host_tail"]["host_tail_s"] = time.perf_counter() - th
            del host
        if res.rays_traced != n_cells * cfg.rays_per_fov * iters:
            fail(f"phase 8 {name}: {res.rays_traced} rays traced")
        n_launch = launches["cell_trace"]
        most = batches * math.ceil(cfg.max_bounces / 24)
        as_scheduled = (2 * batches <= n_launch <= most if segmented
                        else n_launch == batches)
        if launches["persistent_trace"] or not as_scheduled:
            fail(f"phase 8 {name}: launches {launches} for {batches} batches")
        rows_built(ctx, f"8 {name}", launches, 1)
        tail_launches(ctx, f"8 {name}", launches, 1, 1)
        ref = ctx.get("default_efficiencies")
        if ref is not None:
            # reported, and held to 10 % (the efficiency bar holds phase 3
            # to 1.5 % of the monolithic run; the cross-check below holds
            # the two kernels to each other exactly)
            rel = {k: v / ref[k] - 1 for k, v in res.efficiencies.items()}
            entry["efficiency_vs_persistent"] = rel
            print(f"phase 8 {name}: efficiencies relative to phase 3's: "
                  + ", ".join(f"{k} {r:+.4f}" for k, r in rel.items()))
            if max(abs(r) for r in rel.values()) > 0.10:
                fail(f"phase 8 {name}: efficiencies {res.efficiencies} are "
                     f"not within 10 % of the persistent engine's {ref}")
        runs[name] = (res.histogram, res.total_bounces, n_launch, sim)
        ctx.setdefault("cell_efficiencies", dict(res.efficiencies))
    if not (torch.equal(runs["monolithic"][0], runs["segmented"][0])
            and runs["monolithic"][1] == runs["segmented"][1]):
        fail("phase 8: the segmented run differs from the monolithic run")
    print("phase 8: segmented and monolithic histograms and bounces identical")
    mono = runs["monolithic"][3]
    rpc = cfg.rays_per_fov
    rt = -(-rpc // trace_rows.LANES)

    def host_blocks(cells, it):
        batch = seeding.build_ray_batch(mono.geom, cfg, cell_ids=cells,
                                        rays_per_cell=rpc, iteration=it)
        return trace_rows.blocks_to_device(
            *trace_rows.pack_ray_blocks(batch, len(cells), rpc, rt),
            ctx["dev"])

    ctx["record"]["phase8"]["seeding"] = seeding_check(
        ctx, "8", lambda cells, it: mono._cell_blocks(cells, rpc, it),
        host_blocks)
    save_record(ctx)
    for name, (_, bounces, n_launch, sim) in runs.items():
        with CellLaunchBounds(sim.tracer.kw["edge_counts"][1]) as rec:
            again = sim.run(num_iter=iters, evaluate_metrics=False)
        if again.total_bounces != bounces or len(rec.launches) != n_launch:
            fail(f"phase 8 {name}: the replay traced {again.total_bounces} "
                 f"bounces in {len(rec.launches)} launches, the run "
                 f"{bounces} in {n_launch}")
        entry = ctx["record"]["phase8"][name]
        entry["kernel_bound_ms"] = rec.bound_ms()
        print(f"phase 8 {name}: kernel {entry['timings']['kernel_ms']:.1f} ms,"
              f" bound of its {n_launch} launches "
              f"{entry['kernel_bound_ms']:.3f} ms")
    save_record(ctx)

    # ---- the two kernels against each other.  With 2,048 rays per cell
    # the cell engine traces exactly the rays of one generation of the
    # persistent kernel (the same launch tile, the same per-ray seeds), so a
    # one-design gens-spawn sweep with one generation per slot must give the
    # same histogram bit for bit.  Ten generations per slot estimate the same
    # efficiencies from the same pupil points: within 2 %.
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        WaveguideDesign,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
        design_sweep,
    )

    res = sim.run(rays_per_fov=2048, num_iter=1, evaluate_metrics=False)
    sweep_kw = dict(spawn_iters=0, spawn_mode="gens", slots=2048,
                    device=ctx["dev"])
    one = design_sweep.run_design_sweep_persistent(
        [WaveguideDesign()], dataclasses.replace(cfg, rays_per_fov=2048),
        keep_histograms=True, **sweep_kw)
    ten = design_sweep.run_design_sweep_persistent(
        [WaveguideDesign()], dataclasses.replace(cfg, rays_per_fov=20480),
        **sweep_kw)
    names = list(res.efficiencies)
    eff_cell = [res.efficiencies[k] for k in names]
    rel_ten = [float(t / c - 1) for t, c in zip(ten.efficiencies[0], eff_cell)]
    cross = {"rays_per_cell": 2048, "efficiencies": res.efficiencies,
             "total_bounces": res.total_bounces,
             "equals_gens1_sweep": bool(
                 np.array_equal(one.histograms[0], res.histogram)
                 and int(one.bounces[0]) == res.total_bounces),
             "gens10_sweep_vs_cell": dict(zip(names, rel_ten))}
    ref = ctx.get("count_efficiencies")
    if ref is not None:
        cross["cell_vs_count_spawn"] = {
            k: res.efficiencies[k] / ref[k] - 1 for k in names}
    ctx["record"]["phase8"]["cross_check"] = cross
    save_record(ctx)
    print(f"phase 8 cross-check: {json.dumps(cross)}")
    if not cross["equals_gens1_sweep"]:
        fail("phase 8: the cell engine at 2,048 rays per cell differs from "
             "the persistent kernel's one-generation sweep")
    if max(abs(r) for r in rel_ten) > 0.02:
        fail(f"phase 8: ten generations of the persistent kernel give "
             f"efficiencies {rel_ten} away from the cell engine's")
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    ctx["k2_main_launches"] = runs["monolithic"][2] + runs["segmented"][2]


def phase9(ctx) -> None:
    """Packed selection, transit jumps and several cells per block: the
    persistent kernel against its plain version."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, trace_persistent as tp,
    )

    dev = ctx["dev"]
    cfg9 = TraceConfig(num_fov_x=8, num_fov_y=6, rays_per_fov=5000, num_iter=4)
    sim9 = pipeline.Simulator(cfg=cfg9, device=dev, pers_accum_mode="packed")
    target = cfg9.rays_per_fov * cfg9.num_iter
    n9 = sim9.L * sim9.M * sim9.N
    cells = np.arange(n9)
    tr = sim9.tracer
    kw9 = dict(num_fc=tr.num_fc, num_oc=tr.num_oc, edge_counts=tr.edge_counts,
               eyebox_bins=tr.eyebox_bins, max_iters=tr.max_iters,
               accum_mode="packed", cell_params_packed=tr.cell_params_packed)

    def launch(slots, k, ctrl, spawn_mode, jump, phase, plain):
        """One launch of ``k`` cells of ``slots`` slots per block: its
        arguments, keywords and outputs, and the plain version's outputs."""
        rays_in, rng_in = sim9._device_ray_blocks(cells, slots, cpb=k)
        args = (tr.cell_params, tr.geom_row, rays_in, rng_in,
                torch.tensor(ctrl, dtype=torch.int32, device=dev))
        kw = dict(kw9, spawn_mode=spawn_mode, cells_per_block=k,
                  transit_jump=jump, jump_phase=phase)
        out = tp.persistent_trace(*args, **kw)
        torch.cuda.synchronize()
        ref, ms_p = None, None
        if plain:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            ref = tp.persistent_trace_reference(*args, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            ms_p = ev[0].elapsed_time(ev[1])
        return args, kw, out, ref, ms_p

    modes = []

    def both(name, slots, ctrl, spawn_mode="count", k=1, jump=False,
             phase="pow2"):
        args, kw, (hk, nbk), (hp, nbp), ms_p = launch(
            slots, k, ctrl, spawn_mode, jump, phase, True)
        ms_k = cuda_ms(lambda: tp.persistent_trace(*args, **kw), 5)
        err = float((hk - hp).abs().max())
        same = (torch.equal(hk, hp)
                and torch.equal(nbk[:, [0, 2]], nbp[:, [0, 2]])
                and torch.equal(nbk[:, 1], nbp[:, 1]))
        hops = {False: 1, True: 15 if phase == "pow2" else 4095}[jump]
        b, by = bound_ms((*args, tr.cell_params_packed), (hk, nbk), nbk,
                         tr.edge_counts[1], ops_per_edge=3, hops_per_test=hops)
        nbh = nbk.cpu().numpy().astype(np.int64)
        entry = {"mode": name, "ctrl": ctrl, "spawn_mode": spawn_mode,
                 "designs": 1, "cells": n9, "slots": slots,
                 "cells_per_block": k, "transit_jump": jump,
                 "jump_phase": phase if jump else None, "ms": ms_k,
                 "plain_ms": ms_p, "bound_ms": b, "bound_by": by,
                 "max_abs_err": err, "identical": same,
                 "deposits": float(hk.sum()), "bounces": int(nbh[:, 0].sum()),
                 "spawned": int(nbh[:, 2].sum()),
                 "iterations": int(nbh[:, 1].sum()) // k,
                 "max_iterations": int(nbh[:, 1].max()),
                 "bounces_per_s_kernel": int(nbh[:, 0].sum()) / (ms_k / 1e3),
                 "live_fraction": live_fraction(nbh, slots)}
        if k > 1:
            # the same cells, one per block, with the same seeds
            _, _, (h1, nb1), _, _ = launch(slots, 1, ctrl, spawn_mode, jump,
                                           phase, False)
            entry["equals_one_cell_per_block"] = bool(
                torch.equal(hk, h1)
                and torch.equal(nbk[:, [0, 2]], nb1[:, [0, 2]]))
        modes.append(entry)
        print(f"phase 9: {json.dumps(entry)}")
        if not same:
            fail(f"phase 9 {name}: the kernel disagrees with its plain "
                 f"version (max |hist diff| {err})")
        if entry["deposits"] <= 0:
            fail(f"phase 9 {name} made no deposits")
        if not entry.get("equals_one_cell_per_block", True):
            fail(f"phase 9 {name}: {k} cells per block differ from one")
        return entry

    a = both("packed, count", 2048, [target, 0])
    b = both("packed + jump pow2, count", 2048, [target, 0], jump=True)
    both("packed + jump cos, count", 2048, [target, 0], jump=True, phase="cos")
    both("packed, 2 cells per block, count", 1024, [target, 0], k=2)
    both("packed, 2 cells per block, gens", 1024, [2, 0], "gens", k=2)
    both("packed + jump pow2, gens saturated", 256, [1, 256], "gens",
         jump=True)
    f = both("packed, gens", 2048, [10, 0], "gens")
    g = both("packed + jump pow2, gens", 2048, [10, 0], "gens", jump=True)
    both("packed, gens saturated", 256, [1, 256], "gens")
    both("packed, 4 cells per block, gens saturated", 256, [1, 256], "gens",
         k=4)
    ctx["record"]["phase9"] = modes
    save_record(ctx)
    # gens spawn traces the same rays with and without jumps; count spawn
    # respawns by lifetimes in iterations, which jumps change, so its two
    # runs are compared per spawned ray, with the bar of the Simulators
    for what, one, jmp, per_ray, bar in (("gens", f, g, False, 0.002),
                                         ("count", a, b, True, 0.01)):
        n1, nj = ((one["spawned"], jmp["spawned"]) if per_ray else (1, 1))
        rel_b = abs(jmp["bounces"] / nj / (one["bounces"] / n1) - 1)
        rel_d = abs(jmp["deposits"] / nj / (one["deposits"] / n1) - 1)
        print(f"phase 9: jump against single hops, {what} spawn: bounces "
              f"{rel_b:.5f}, deposits {rel_d:.5f} apart"
              f"{' per spawned ray' if per_ray else ''}, iterations "
              f"{jmp['iterations']} against {one['iterations']}")
        if (rel_b > bar or rel_d > 0.05
                or jmp["iterations"] >= one["iterations"]):
            fail(f"phase 9, {what} spawn: jumps are not within {bar} of the "
                 "bounces and 5 % of the deposits of single hops with fewer "
                 "iterations")
    ctx["k1_modes"] = ctx.get("k1_modes", []) + modes


def phase10(ctx) -> None:
    """The count-spawn, folded, packed stack with and without transit jumps
    at full width."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, trace_persistent as tp,
    )

    cfg = TraceConfig()   # reference workload: 100 x 75 x 3, 5,000 x 4 rays
    target = cfg.rays_per_fov * cfg.num_iter
    exact = ctx.get("exact_run")
    if exact is None:
        # a partial run without phase 3b: the exact mode, same seeds, no
        # metrics
        sim = pipeline.Simulator(cfg=cfg, device=ctx["dev"], **COUNT_FOLDED)
        exact = stack_stats(sim.run(evaluate_metrics=False),
                            sim._slots_gens(target)[0])
    runs = {"exact": exact}
    launches10 = 0
    for name, kw in (("packed_jump", dict(pers_accum_mode="packed",
                                          pers_transit_jump=True)),
                     ("packed", dict(pers_accum_mode="packed"))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tp.reset_launch_counts()
        t0 = time.perf_counter()
        sim = pipeline.Simulator(cfg=cfg, device=ctx["dev"], **COUNT_FOLDED,
                                 **kw)
        res = sim.run(**simulate_options())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(tp.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        n_cells = sim.L * sim.M * sim.N
        batches = math.ceil(n_cells / 2048)
        tm, met = res.timings, res.metrics
        bound10, bound_by10 = simulate_bound_ms(sim, res)
        entry = dict(stack_stats(res, sim._slots_gens(target)[0]),
                     bound_ms=bound10, bound_by=bound_by10,
                     cells=n_cells, target=target,
                     wall_s=wall, setup_s=sim.setup_seconds, timings=tm,
                     delta_e=met.delta_e, u_fov=met.u_fov,
                     u_eyebox=met.u_eyebox, launches=launches,
                     batches=batches, peak_bytes=peak)
        rel = {k: v / exact["efficiencies"][k] - 1
               for k, v in res.efficiencies.items()}
        entry["efficiency_vs_exact"] = rel
        entry["bounces_per_ray_vs_exact"] = (
            entry["bounces_per_ray"] / exact["bounces_per_ray"] - 1)
        runs[name] = entry
        ctx["record"].setdefault("phase10", {})[name] = entry
        save_record(ctx)
        print(pipeline.format_report(res))
        print(f"phase 10 {name}: {n_cells} cells, target {target} rays/cell: "
              f"wall {wall:.3f} s (setup {sim.setup_seconds:.3f} s), trace "
              f"{res.trace_seconds:.3f} s, kernel {tm['kernel_ms']:.1f} ms "
              f"(bound {bound10:.4f} ms, {bound_by10}), "
              f"seeding (device hash) {tm['seed_s']:.3f} s host, "
              f"{tm['seed_ms']:.1f} ms device, assembly "
              f"{tm['assemble_s']:.3f} s, {tail_text(tm)}; "
              f"bounces {res.total_bounces:,}, rays {res.rays_traced:,}; "
              f"launches {launches}; peak device memory "
              f"{peak / 2**20:.1f} MiB; efficiencies relative to the exact "
              "mode's: " + ", ".join(f"{k} {r:+.4f}" for k, r in rel.items())
              + f"; bounces per ray {entry['bounces_per_ray_vs_exact']:+.5f}")
        vals = list(res.efficiencies.values()) + [met.delta_e, met.u_fov,
                                                  met.u_eyebox]
        if not all(math.isfinite(v) for v in vals):
            fail(f"phase 10 {name}: non-finite metric in {vals}")
        if (res.cell_stats[:, 2] < target).any():
            fail(f"phase 10 {name}: a cell spawned fewer than {target} rays")
        want = sum(res.efficiencies.values()) / sim.L * target * n_cells
        got = float(res.histogram.sum(dtype=torch.float64))
        if abs(got - want) > 1e-6 * want:
            fail(f"phase 10 {name}: histogram sum {got} vs efficiencies x "
                 f"rays {want}")
        if trace_launches(launches) != {"persistent_trace": batches,
                                        "cell_trace": 0}:
            fail(f"phase 10 {name}: launches {launches}, expected one "
                 f"persistent_trace per batch ({batches}) and no other "
                 "trace kernel")
        rows_built(ctx, f"10 {name}", launches, 1)
        if max(abs(r) for r in rel.values()) > 0.05:
            fail(f"phase 10 {name}: efficiencies {res.efficiencies} are not "
                 f"within 5 % of the exact mode's {exact['efficiencies']}")
        if abs(entry["bounces_per_ray_vs_exact"]) > 0.01:
            fail(f"phase 10 {name}: bounces per ray "
                 f"{entry['bounces_per_ray']} against the exact mode's "
                 f"{exact['bounces_per_ray']}")
        launches10 += launches["persistent_trace"]
        del sim, res
    print("phase 10: exact / packed / packed + jump: kernel "
          + " / ".join(f"{runs[n]['kernel_ms']:.1f}" for n in
                       ("exact", "packed", "packed_jump"))
          + " ms, iterations "
          + " / ".join(f"{runs[n]['iterations']:,}" for n in
                       ("exact", "packed", "packed_jump"))
          + ", bounces "
          + " / ".join(f"{runs[n]['bounces']:,}" for n in
                       ("exact", "packed", "packed_jump"))
          + ", live fraction "
          + " / ".join(f"{runs[n]['live_fraction']:.4f}" for n in
                       ("exact", "packed", "packed_jump")))
    ctx["record"]["phase10"]["exact"] = exact
    save_record(ctx)
    if runs["packed_jump"]["iterations"] >= runs["packed"]["iterations"]:
        fail("phase 10: jumps did not cut the summed iterations")
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    ctx["k1_packed_main_launches"] = launches10


def phase11(ctx) -> None:
    """The device tail against the host tail, and the run options, at the
    reference workload's full width."""
    import tempfile

    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, seeding, trace_persistent as tp,
    )

    dev = ctx["dev"]
    rec = ctx["record"].setdefault("phase11", {})
    t_phase = time.perf_counter()
    cfg = TraceConfig()   # reference workload: 100 x 75 x 3, 5,000 x 4 rays
    n_cells = 3 * cfg.num_fov_x * cfg.num_fov_y
    slots = 2048

    # ---- seeds: the device hash against the host's, one batch at a time,
    # over phase 3's index range unfolded (4 iterations) and at the first
    # and last batch of phase 6b's range (16 designs' cells)
    batches = 0
    for it in range(cfg.num_iter):
        for start in range(0, n_cells, 2048):
            cells = np.arange(start, min(start + 2048, n_cells))
            want = seeding.cell_seeds(cells, slots, it, n_cells, cfg.seed)
            got = seeding.cell_seeds_device(cells, slots, it, n_cells,
                                            cfg.seed, dev)
            if not torch.equal(got, torch.from_numpy(
                    want.view(np.int32)).to(dev)):
                fail(f"phase 11: device seeds differ at iteration {it}, "
                     f"cells {start}..")
            batches += 1
    n6b = 16 * n_cells
    for cells in (np.arange(2048), np.arange(n6b - 2048, n6b)):
        want = seeding.cell_seeds(cells, slots, 0, n6b, 0)
        got = seeding.cell_seeds_device(cells, slots, 0, n6b, 0, dev)
        if not torch.equal(got, torch.from_numpy(want.view(np.int32)).to(dev)):
            fail(f"phase 11: device seeds differ in phase 6b's range at "
                 f"cells {cells[0]}..")
    all_cells = np.arange(n_cells)
    seeding.cell_seeds_device(all_cells, slots, 0, n_cells, cfg.seed, dev)
    hash_ms = cuda_ms(lambda: seeding.cell_seeds_device(
        all_cells, slots, 0, n_cells, cfg.seed, dev), 3)
    rec["seeds"] = {"batches": batches + 2, "identical": True,
                    "hash_ms_per_iteration": hash_ms}
    print(f"phase 11 seeds: device = host over {batches} batches of phase "
          f"3's range (4 x {n_cells:,} cells x {slots} slots) and phase 6b's "
          f"first and last batch; hash of one iteration's {n_cells:,} x "
          f"{slots} seeds {hash_ms:.2f} ms")

    # ---- one Simulator, three tails (count spawn, folded)
    tp.reset_launch_counts()
    sim = pipeline.Simulator(cfg=cfg, device=dev, **COUNT_FOLDED)
    host = sim.run()
    stack = sim.run(histogram_device=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    on_dev = sim.run(histogram_device=True, metrics_device=True,
                     dense_metrics=True)
    torch.cuda.synchronize()
    peak_dense = torch.cuda.max_memory_allocated()
    host_hist = torch.from_numpy(host.histogram).to(dev)
    faults = []
    tails = {}
    for name, r in (("host", host), ("stack", stack), ("device", on_dev)):
        tm = r.timings
        tails[name] = {k: tm.get(k) for k in (
            "seed_s", "seed_ms", "kernel_ms", "assemble_s", "perceive_ms",
            "pull_s", "metrics_s", "dense_s")}
        tails[name].update(trace_s=r.trace_seconds,
                           efficiencies=r.efficiencies,
                           delta_e=r.metrics.delta_e, u_fov=r.metrics.u_fov,
                           u_eyebox=r.metrics.u_eyebox)
        if name == "host":
            continue
        if not torch.equal(r.histogram, host_hist):
            faults.append(f"{name}: histogram differs from the host tail's")
        for k, v in host.efficiencies.items():
            if abs(r.efficiencies[k] - v) > 1e-6 * abs(v):
                faults.append(f"{name}: efficiency {k} {r.efficiencies[k]} "
                              f"vs {v}")
        for k in ("delta_e", "u_fov", "u_eyebox"):
            a, b = getattr(r.metrics, k), getattr(host.metrics, k)
            if abs(a - b) > 1e-4 * abs(b):
                faults.append(f"{name}: {k} {a} vs {b}")
        tails[name]["max_rel_metric_gap"] = max(
            abs(getattr(r.metrics, k) / getattr(host.metrics, k) - 1)
            for k in ("delta_e", "u_fov") if getattr(host.metrics, k))
    d = on_dev.dense
    rec["tails"] = tails
    rec["dense"] = {"eye_positions": list(d.eye_luminance.shape),
                    "delta_e": d.delta_e, "u_fov": d.u_fov,
                    "u_eyebox": d.u_eyebox,
                    "starved": d.starved_eye_positions,
                    "dense_s": on_dev.timings["dense_s"],
                    "peak_bytes": peak_dense}
    def opt(v, f):
        return "-" if v is None else format(v, f)

    for name, t in tails.items():
        print(f"phase 11 tail {name}: trace {t['trace_s']:.3f} s (kernel "
              f"{t['kernel_ms']:.1f} ms, seeds {t['seed_ms']:.1f} ms device,"
              f" assembly and pull {t['assemble_s']:.3f} s), metrics "
              f"{t['metrics_s']:.3f} s (perception "
              f"{opt(t['perceive_ms'], '.2f')} ms device, stack pull "
              f"{opt(t['pull_s'], '.4f')} s); delta E {t['delta_e']:.6f}, "
              f"u_fov {t['u_fov']:.6f}")
    print(f"phase 11 dense: {d.eye_luminance.shape[0]} x "
          f"{d.eye_luminance.shape[1]} eye positions in "
          f"{on_dev.timings['dense_s']:.3f} s, delta E {d.delta_e:.4f}, "
          f"u_fov {d.u_fov:.6f}, starved {d.starved_eye_positions}; peak "
          f"device memory of that run {peak_dense / 2**20:.1f} MiB")
    if d.eye_luminance.shape != (51, 91) or not math.isfinite(d.delta_e):
        faults.append(f"dense scan {d.eye_luminance.shape}, {d.delta_e}")
    del host_hist, host, on_dev

    # ---- a wavelength subset: its rows are the full run's
    sub = sim.run(wavelengths=(0, 2), histogram_device=True,
                  evaluate_metrics=False)
    rows_same = (torch.equal(sub.histogram[0], stack.histogram[0])
                 and torch.equal(sub.histogram[2], stack.histogram[2])
                 and not bool(sub.histogram[1].any()))
    if not rows_same:
        faults.append("wavelengths=(0, 2): rows differ from the full run's")
    rec["subset"] = {"trace_s": sub.trace_seconds,
                     "kernel_ms": sub.timings["kernel_ms"],
                     "rows_identical": rows_same}
    print(f"phase 11 wavelengths (0, 2): rows 0 and 2 "
          f"{'equal' if rows_same else 'DIFFER FROM'} the full run's, row 1 "
          f"empty; kernel {sub.timings['kernel_ms']:.1f} ms")
    del sub, stack

    # ---- unfolded count spawn with error groups (4 jackknife groups)
    eg = sim.run(error_groups=True, histogram_device=True,
                 metrics_device=True)
    se = eg.metric_stderr
    rec["error_groups"] = {"stderr": se, "efficiencies": eg.efficiencies,
                           "trace_s": eg.trace_seconds,
                           "kernel_ms": eg.timings["kernel_ms"],
                           "perceive_ms": eg.timings["perceive_ms"],
                           "metrics_s": eg.timings["metrics_s"]}
    print(f"phase 11 error groups: {json.dumps(se)}; efficiencies "
          f"{json.dumps(eg.efficiencies)}; trace {eg.trace_seconds:.3f} s, "
          f"kernel {eg.timings['kernel_ms']:.1f} ms")
    if not all(math.isfinite(v) and v >= 0 for v in se.values()):
        faults.append(f"standard errors not finite and >= 0: {se}")
    for k, v in eg.efficiencies.items():
        if not 0 < se[f"eff_{k}"] < v:
            faults.append(f"eff_{k} standard error {se[f'eff_{k}']} vs {v}")
    if not se["delta_e"] > 0:
        faults.append(f"delta_e standard error {se['delta_e']}")
    del eg, sim

    # ---- gens spawn unfolded (the default, phase 3's path), 4 relaunches
    gsim = pipeline.Simulator(cfg=cfg, device=dev, spawn_mode="gens",
                              fold_iterations=False)
    g = gsim.run(histogram_device=True, metrics_device=True)
    cell_eff = ctx.get("cell_efficiencies")
    rel = ({k: g.efficiencies[k] / cell_eff[k] - 1 for k in cell_eff}
           if cell_eff else None)
    rec["gens"] = {"efficiencies": g.efficiencies, "vs_cell_engine": rel,
                   "rays_traced": g.rays_traced,
                   "total_bounces": g.total_bounces,
                   "trace_s": g.trace_seconds,
                   "kernel_ms": g.timings["kernel_ms"]}
    print(f"phase 11 gens spawn, unfolded: {g.rays_traced:,} rays, "
          f"{g.total_bounces:,} bounces, kernel {g.timings['kernel_ms']:.1f}"
          f" ms, trace {g.trace_seconds:.3f} s; efficiencies relative to "
          f"phase 8's cell engine: {json.dumps(rel)}")
    if rel is not None and max(abs(r) for r in rel.values()) > 0.01:
        faults.append(f"gens spawn efficiencies {g.efficiencies} not within "
                      f"1 % of the cell engine's {cell_eff}")
    del g, gsim

    # ---- checkpoint and resume at 20 x 15 FoV, on each engine
    cfg_s = TraceConfig(num_fov_x=20, num_fov_y=15)
    rec["resume"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for engine in ("persistent", "cell"):
            s = pipeline.Simulator(cfg=cfg_s, device=dev, engine=engine,
                                   spawn_mode="count", fold_iterations=False)
            path = str(Path(tmp) / f"{engine}.npz")
            kw = dict(evaluate_metrics=False)
            full = s.run(num_iter=3, **kw)
            part = s.run(num_iter=2, checkpoint_path=path, **kw)
            res = s.run(num_iter=3, checkpoint_path=path, **kw)
            same = (np.array_equal(res.histogram, full.histogram)
                    and res.total_bounces == full.total_bounces
                    and res.rays_traced == full.rays_traced)
            rec["resume"][engine] = {
                "identical": same, "bounces": full.total_bounces,
                "partial_bounces": part.total_bounces,
                "trace_s": [full.trace_seconds, part.trace_seconds,
                            res.trace_seconds]}
            print(f"phase 11 resume {engine}: 2 iterations checkpointed + 1 "
                  f"resumed {'equal' if same else 'DIFFER FROM'} 3 "
                  f"uninterrupted ({full.total_bounces:,} bounces)")
            if not same:
                faults.append(f"{engine}: resumed run differs")
    launches = dict(tp.launch_counts)
    wall = time.perf_counter() - t_phase
    rec.update(launches=launches, wall_s=wall)
    save_record(ctx)
    print(f"phase 11: launches {launches}; {wall:.1f} s")
    if faults:
        fail("phase 11: " + "; ".join(faults))
    if not (launches["persistent_trace"] and launches["cell_trace"]):
        fail(f"phase 11: launches {launches}")
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    ctx["k1_tail_launches"] = launches["persistent_trace"]
    ctx["k2_tail_launches"] = launches["cell_trace"]


def phase12(ctx) -> None:
    """The vector engine at full width, and the CLI's default sweep through
    the vector sweep."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, seeding, trace_persistent as tp, trace_vector as tv,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
        design_sweep,
    )

    dev = ctx["dev"]
    rec = ctx["record"].setdefault("phase12", {})
    faults = []
    cfg = TraceConfig()   # 100 x 75 x 3 cells, 5,000 rays per cell
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tp.reset_launch_counts()
    t0 = time.perf_counter()
    sim = pipeline.Simulator(cfg=cfg, device=dev, engine="vector",
                             segmented=cli.vector_segmented(dev))
    res = sim.run(num_iter=1, **simulate_options())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tp.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    tm, met = res.timings, res.metrics
    n_cells = sim.L * sim.M * sim.N
    entry = {
        "cells": n_cells, "rays_per_cell": cfg.rays_per_fov, "num_iter": 1,
        "segmented": sim._segmented,
        "segment_bounces": sim._segment_bounces, "wall_s": wall,
        "setup_s": sim.setup_seconds,
        "setup_timings": dict(sim.setup_timings),
        "trace_s": res.trace_seconds,
        "seed_s": tm["seed_s"], "seed_ms": tm.get("seed_ms"),
        "bounce_ms": tm.get("bounce_ms", 0.0), "compact_ms": tm.get("compact_ms"),
        "scatter_ms": tm.get("scatter_ms", 0.0), "assemble_s": tm["assemble_s"],
        "tail_s": tm["metrics_s"], "perceive_ms": tm["perceive_ms"],
        "colorimetry_ms": tm["colorimetry_ms"], "pull_s": tm["pull_s"],
        "batch_steps": tm["batch_steps"], "batch_syncs": tm["batch_syncs"],
        "syncs": tm["syncs"], "segments": tm.get("segments"),
        "total_bounces": res.total_bounces,
        "bounces_per_s": res.bounces_per_second,
        "rays_traced": res.rays_traced, "deposits": res.deposits,
        "efficiencies": res.efficiencies, "delta_e": met.delta_e,
        "u_fov": met.u_fov, "u_eyebox": met.u_eyebox,
        "histogram_digest": digest(res.histogram),
        "launches": launches, "peak_bytes": peak}
    rec["run"] = entry
    save_record(ctx)
    print(pipeline.format_report(res))
    schedule = (f"segments of {sim._segment_bounces}" if sim._segmented
                else "one trace call a batch")
    print(f"phase 12: {n_cells} cells x {cfg.rays_per_fov} rays, vector "
          f"engine, {schedule}: wall {wall:.3f} s "
          f"({setup_text(sim)}), trace {res.trace_seconds:.3f} "
          f"s, seeding {tm['seed_s']:.3f} s host, "
          f"{tm.get('seed_ms', float('nan')):.1f} ms device, bounce loop "
          f"{tm.get('bounce_ms', 0.0):.1f} ms, compaction "
          f"{tm.get('compact_ms', 0.0):.1f} ms, scatter "
          f"{tm.get('scatter_ms', 0.0):.1f} ms, assembly (a synchronize) "
          f"{tm['assemble_s']:.3f} s, {tail_text(tm)}; steps "
          f"per batch {tm['batch_steps']}, reads from the device per batch "
          f"{tm['batch_syncs']} ({tm['syncs']} in all), "
          f"{tm.get('segments', 0)} compactions, launches {launches}; "
          f"bounces {res.total_bounces:,} ({res.bounces_per_second:.4g}/s), "
          f"deposits {res.deposits:,}; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    print(f"phase 12 digests: histogram {entry['histogram_digest']}, "
          f"bounces {res.total_bounces}, deposits {res.deposits}, "
          f"efficiencies {res.efficiencies}")
    vals = list(res.efficiencies.values()) + [met.delta_e, met.u_fov,
                                              met.u_eyebox]
    if not all(math.isfinite(v) for v in vals) or min(
            res.efficiencies.values()) <= 0:
        faults.append(f"metric not finite or efficiency not positive: {vals}")
    if float(res.histogram.sum(dtype=torch.float64)) != res.deposits:
        faults.append("histogram sum is not the deposit count")
    if res.rays_traced != n_cells * cfg.rays_per_fov:
        faults.append(f"{res.rays_traced} rays traced")
    if launches["persistent_trace"] or launches["cell_trace"]:
        faults.append(f"the vector engine launched K1 or K2: {launches}")
    want = vector_launches(tm["batch_steps"], sim._segment_bounces
                           if sim._segmented else None)
    if launches["vector_trace"] != want:
        faults.append(f"{launches['vector_trace']} vector_trace launches, "
                      f"not {want}")
    ctx["vector_launches"] = launches["vector_trace"]
    ref = ctx.get("cell_efficiencies")
    if ref is not None:
        rel = {k: v / ref[k] - 1 for k, v in res.efficiencies.items()}
        entry["vs_cell_engine"] = rel
        print("phase 12: efficiencies relative to phase 8's cell engine: "
              + ", ".join(f"{k} {r:+.5f}" for k, r in rel.items()))
        if max(abs(r) for r in rel.values()) > 0.02:
            faults.append(f"efficiencies {res.efficiencies} not within 2 % "
                          f"of phase 8's {ref}")

    def host_state(cells, it):
        b = seeding.build_ray_batch(sim.geom, cfg, cell_ids=cells,
                                    rays_per_cell=cfg.rays_per_fov,
                                    iteration=it)
        return {k: v[None] for k, v in tv.make_ray_state(
            b["x"], b["y"], b["te"], b["tm"], b["cid"], b["idx"], b["rng"],
            device=dev).items()}

    rec["seeding"] = seeding_check(
        ctx, "12", lambda cells, it: sim._vector_rays(cells, cfg.rays_per_fov,
                                                      it), host_state)
    save_record(ctx)

    # ---- the first batch: monolithic against compacted (the same seeded
    # rays, seeding not timed), and against K2
    chunk = np.arange(2048)
    rays = sim._vector_rays(chunk, cfg.rays_per_fov, 0)
    hists = [torch.zeros((sim.L, sim.N, sim.M, *cfg.eyebox_bins),
                         dtype=torch.float32, device=dev) for _ in range(2)]

    def add(h):
        return lambda r: tv.add_deposits(h.view(-1), r["dep"], r["cid"],
                                         sim.M, sim.N, *cfg.eyebox_bins)

    def monolithic():
        hists[0].zero_()
        mono, b = sim.tracer(rays)
        add(hists[0])(mono)
        return mono, b

    def compacted():
        hists[1].zero_()
        return tv.trace_compacted(sim.tracer, rays, cfg.max_bounces,
                                  sim._segment_bounces, add(hists[1]))

    # each schedule three times, in turns (host clock, synchronised: what a
    # batch of simulate waits for)
    t_mono, t_comp = [], []
    for run in ("m", "c", "c", "m", "m", "c"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "m":
            mono, b_mono = monolithic()
        else:
            b_comp = compacted()
        torch.cuda.synchronize()
        (t_mono if run == "m" else t_comp).append(time.perf_counter() - t0)
    same = (torch.equal(hists[0], hists[1])
            and int(b_mono.sum()) == int(b_comp.sum()))
    dep_v = mono["dep"].reshape(len(chunk), -1)
    del rays, mono, hists
    tp.reset_launch_counts()
    cell = pipeline.Simulator(cfg=cfg, device=dev, engine="cell")
    rays_in, rng_in = cell._cell_blocks(chunk, cfg.rays_per_fov, 0)
    dep_k2 = cell.tracer(chunk, rays_in, rng_in)[0].reshape(
        len(chunk), -1)[:, :cfg.rays_per_fov]
    agree = float((dep_k2 == dep_v).float().mean())
    dep_rate = (float((dep_v >= 0).float().mean()),
                float((dep_k2 >= 0).float().mean()))
    del cell, rays_in, rng_in, dep_k2, dep_v
    rec["first_batch"] = {
        "monolithic_s": t_mono, "compacted_s": t_comp,
        "compacted_equals_monolithic": same,
        "bounces": int(b_comp.sum()), "k2_per_ray_agreement": agree,
        "deposit_rate_vector_k2": dep_rate,
        "k2_comparison_launches": dict(tp.launch_counts)}
    save_record(ctx)
    print(f"phase 12 first batch (2,048 cells x 5,000 rays): monolithic "
          f"{', '.join(f'{t:.4f}' for t in t_mono)} s, compacted "
          f"{', '.join(f'{t:.4f}' for t in t_comp)} s (in turns), "
          f"{'identical' if same else 'DIFFERENT'}; per-ray deposits equal "
          f"to K2's (the cell engine, the same seeds) for {agree:.5f} "
          f"of the rays (deposit rates {dep_rate[0]:.5f}, {dep_rate[1]:.5f})")
    if not same:
        faults.append("compacted first batch differs from monolithic")
    if agree < 0.995:
        faults.append(f"per-ray agreement with K2 {agree:.5f} < 0.995")
    del sim
    torch.cuda.empty_cache()

    # ---- the CLI's default sweep through the vector sweep
    sargs = cli.build_parser().parse_args(["sweep", "--engine", "vector"])
    designs, _ = cli.sweep_designs(sargs)
    cfg6 = cli.sweep_config(sargs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tp.reset_launch_counts()
    t0 = time.perf_counter()
    sw = design_sweep.run_design_sweep(designs, cfg6, device=dev,
                                       keep_histograms=(3,))
    torch.cuda.synchronize()
    wall6 = time.perf_counter() - t0
    launches6 = dict(tp.launch_counts)
    peak6 = torch.cuda.max_memory_allocated()
    solo = design_sweep.run_design_sweep(designs[3:4], cfg6, device=dev)
    solo_same = (np.array_equal(sw.histograms[0], solo.histograms[0])
                 and sw.bounces[3] == solo.bounces[0]
                 and np.array_equal(sw.efficiencies[3], solo.efficiencies[0]))
    p6 = ctx["record"].get("phase6", {}).get("cli_default", {})
    stm = sw.timings
    rec["sweep"] = {
        "designs": len(designs), "cells": len(designs) * n_cells,
        "rays_per_fov": cfg6.rays_per_fov, "wall_s": wall6,
        "peak_bytes": peak6, "timings": stm,
        "bounces": sw.bounces.tolist(),
        "efficiencies": sw.efficiencies.tolist(),
        "design3_digest": digest(sw.histograms[0]),
        "design3_equals_solo": solo_same, "launches": launches6,
        "phase6a_wall_s": p6.get("wall_s"),
        "phase6a_peak_bytes": p6.get("peak_bytes")}
    save_record(ctx)
    print(f"phase 12 sweep: {len(designs)} designs, "
          f"{len(designs) * n_cells:,} cells x {cfg6.rays_per_fov} rays "
          f"through the vector sweep: wall {wall6:.3f} s (host prep "
          f"{stm['prep_s']:.3f} s, seeding "
          f"{stm.get('seed_s', float('nan')):.3f} s host, "
          f"{stm.get('seed_ms', float('nan')):.1f} ms device, upload "
          f"{stm['upload_s']:.3f} s, bounce "
          f"loop {stm.get('bounce_ms', 0.0):.1f} ms, compaction "
          f"{stm.get('compact_ms', 0.0):.1f} ms, {stm['steps']} steps, "
          f"{stm['syncs']} reads from the device), peak device memory "
          f"{peak6 / 2**20:.1f} MiB; phase 6a (persistent kernel): wall "
          f"{p6.get('wall_s', float('nan')):.3f} s, peak "
          f"{p6.get('peak_bytes', float('nan')) / 2**20:.1f} MiB; design 3 "
          f"{'equals' if solo_same else 'DIFFERS FROM'} its solo sweep")
    print(f"phase 12 sweep digests: design 3 "
          f"{rec['sweep']['design3_digest']}, bounces {sw.bounces.tolist()}, "
          f"efficiencies {sw.efficiencies.tolist()}; launches {launches6}")
    eff = sw.efficiencies
    if not (np.isfinite(eff).all() and (eff > 0).all()):
        faults.append(f"sweep efficiencies {eff.tolist()}")
    seg6 = inspect.signature(design_sweep.run_design_sweep).parameters[
        "segment_bounces"].default   # what the CLI's sweep runs
    want6 = vector_launches([stm["steps"]], seg6)
    if (launches6["vector_trace"] != want6 or launches6["persistent_trace"]
            or launches6["cell_trace"]):
        faults.append(f"the sweep's launches {launches6}: not {want6} "
                      "vector_trace and no K1 or K2")
    ctx["vector_launches"] += launches6["vector_trace"]
    if not solo_same:
        faults.append("sweep design 3 differs from its solo sweep")
    if faults:
        fail("phase 12: " + "; ".join(faults))
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")


def phase13(ctx) -> None:
    """The exact splitting engine: the README's case, card against CPU, a
    timing chunk at the reference width, the global engine."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
        generate_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, seeding, splitting, trace_persistent as tp, trace_vector as tv,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
        build_trace_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts import (
        make_synthetic_luts,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.packing import (
        build_cell_tables,
    )

    dev = ctx["dev"]
    rec = ctx["record"].setdefault("phase13", {})
    faults = []
    tp.reset_launch_counts()
    t_phase = time.perf_counter()

    # ---- (a) the README's case: 16 x 12 x 3 cells, 64 launch positions per
    # cell in passes of 2 (the position batching of the repo's exact runs),
    # threshold 1e-6, 8,192-slot wavefronts per cell
    cfg = TraceConfig(num_fov_x=16, num_fov_y=12, rays_per_fov=2)
    sim = pipeline.Simulator(cfg=cfg, device=dev, engine="splitting")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sim.run(rays_per_fov=2, num_iter=32, **simulate_options())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = float(res.histogram.sum(dtype=torch.float64))
    out_w = sim.split_out_coupled
    met = res.metrics
    a = {"cells": 576, "positions": 64, "wall_s": wall,
         "setup_s": sim.setup_seconds,
         "setup_timings": dict(sim.setup_timings),
         "trace_s": res.trace_seconds,
         "seed_s": res.timings["seed_s"],
         "seed_ms": res.timings.get("seed_ms"),
         "tail": {k: res.timings[k] for k in ("metrics_s", "perceive_ms",
                                              "colorimetry_ms", "pull_s")},
         "histogram_digest": digest(res.histogram),
         "steps": res.total_bounces, "truncated": sim.split_truncated,
         "pruned": sim.split_pruned, "out_coupled": out_w,
         "histogram_sum": total, "peak_live": sim.split_peak_live,
         "efficiencies": res.efficiencies, "delta_e": met.delta_e,
         "u_fov": met.u_fov, "u_eyebox": met.u_eyebox,
         "peak_bytes": torch.cuda.max_memory_allocated()}
    ledgers = (sim.split_truncated, sim.split_pruned, sim.split_out_coupled)
    r4 = sim.run(rays_per_fov=2, num_iter=4, evaluate_metrics=False)
    r4b = sim.run(rays_per_fov=2, num_iter=4, cells_per_batch=100,
                  evaluate_metrics=False)
    # a batch's steps are its widest cell's, so only the histograms compare
    a["chunks_256_100_identical"] = bool(
        np.array_equal(r4.histogram, r4b.histogram))
    a["chunks_max_abs_diff"] = float(np.abs(r4.histogram
                                            - r4b.histogram).max())
    rec["readme"] = a
    save_record(ctx)
    st = sim.setup_timings
    print(f"phase 13a: 576 cells x 64 positions (32 passes of 2): wall "
          f"{wall:.3f} s (setup {sim.setup_seconds:.3f} s before it: "
          f"geometry {st.get('geometry_s', 0.0):.3f} s, host tables "
          f"{st.get('host_tables_s', 0.0):.3f} s, trace geometry "
          f"{st.get('trace_geometry_s', 0.0):.3f} s, kernel build and bind "
          f"{st.get('kernel_build_s', 0.0):.3f} s, the trace's tables and "
          f"region grid {st.get('split_tables_s', 0.0):.3f} s, synchronize "
          f"{st.get('sync_s', 0.0):.3f} s), seeding {a['seed_s']:.4f} s host, "
          f"{tail_text(res.timings)}, peak device memory "
          f"{a['peak_bytes'] / 2**20:.1f} MiB, "
          f"{res.total_bounces} steps; truncated "
          f"{ledgers[0]}, pruned {ledgers[1]:.6g}, out-coupled "
          f"{out_w:.8g}, histogram sum {total:.8g}, peak wavefront "
          f"{sim.split_peak_live} of 8,192; efficiencies "
          f"{json.dumps(res.efficiencies)}, delta E {met.delta_e:.4f}, "
          f"u_fov {met.u_fov:.5f}, u_eyebox {met.u_eyebox:.5f}; batches of "
          f"256 and of 100 cells "
          f"{'identical' if a['chunks_256_100_identical'] else 'DIFFER'}")
    if ledgers[0] != 0:
        faults.append(f"README case truncated {ledgers[0]}")
    if abs(total - out_w) > 1e-5 * out_w or out_w <= 0:
        faults.append(f"histogram sum {total} vs out-coupled {out_w}")
    if not a["chunks_256_100_identical"]:
        faults.append("two batch sizes give different histograms")
    del sim, res, r4, r4b

    # ---- (b) card against CPU on 4 of its cells (iteration 0's positions)
    cells4 = np.array([0, 191, 300, 575])
    got = {}
    for d in ("cpu", dev):
        s = pipeline.Simulator(cfg=cfg, device=d, engine="splitting")
        h, steps, _ = s.trace_batch(cells4, 2, 0)
        got[str(d)] = (h.cpu().numpy(), steps, s.split_peak_live,
                       s.split_truncated, s.split_pruned, s.split_out_coupled)
    c, g = got["cpu"], got[str(dev)]
    close = bool(np.allclose(g[0], c[0], rtol=2e-4, atol=1e-10))
    same_steps = (g[1], g[2], g[3]) == (c[1], c[2], c[3])
    pr_rel = abs(g[4] - c[4]) / max(c[4], 1e-30)
    ow_rel = abs(g[5] - c[5]) / max(c[5], 1e-30)
    rec["card_vs_cpu"] = {
        "cells": cells4.tolist(), "hist_within_bars": close,
        "hist_max_abs": float(np.abs(g[0] - c[0]).max()),
        "bitwise": bool(np.array_equal(g[0], c[0])),
        "steps": [g[1], c[1]], "peak_live": [g[2], c[2]],
        "truncated": [g[3], c[3]], "pruned_rel": pr_rel,
        "out_coupled_rel": ow_rel}
    save_record(ctx)
    print(f"phase 13b: card against CPU on cells {cells4.tolist()}: "
          f"histogram within rtol 2e-4 / atol 1e-10: {close} (bitwise "
          f"{rec['card_vs_cpu']['bitwise']}); steps {g[1]} / {c[1]}, peak "
          f"{g[2]} / {c[2]}, truncated {g[3]} / {c[3]}; pruned "
          f"{pr_rel:.2e}, out-coupled {ow_rel:.2e} relative apart")
    if not (close and same_steps and pr_rel <= 1e-4 and ow_rel <= 1e-5):
        faults.append(f"card and CPU differ: {rec['card_vs_cpu']}")

    # ---- (c) a timing chunk at the reference width: 256 cells of the
    # 100 x 75 grid, 16 positions (8 passes of 2), threshold 1e-6
    cfg_c = TraceConfig(rays_per_fov=2)
    sim = pipeline.Simulator(cfg=cfg_c, device=dev, engine="splitting")
    cells = np.arange(256)
    steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in range(8):
        _, st, _ = sim.trace_batch(cells, 2, it)
        steps.append(st)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    ms_cell = wall_c * 1e3 / len(cells)
    rec["timing_chunk"] = {
        "cells": len(cells), "positions": 16, "wall_s": wall_c,
        "ms_per_cell": ms_cell, "full_grid_s": ms_cell * 22500 / 1e3,
        "steps": steps, "peak_live": sim.split_peak_live,
        "truncated": sim.split_truncated, "pruned": sim.split_pruned}
    save_record(ctx)
    print(f"phase 13c: 256 cells of the 100 x 75 grid x 16 positions: "
          f"{wall_c:.3f} s, {ms_cell:.3f} ms per cell (the full 22,500-cell "
          f"grid: {ms_cell * 22.5:.1f} s); steps per pass {steps}, peak "
          f"wavefront {sim.split_peak_live}, truncated "
          f"{sim.split_truncated}")
    del sim

    # ---- (d) the global engine on the 3 x 2 fixture, card against CPU
    cfg_d = TraceConfig(num_fov_x=3, num_fov_y=2, rays_per_fov=4,
                        rng_mode="fast", seed=2)
    geom = generate_geometry(num_fov_x=3, num_fov_y=2)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom)
    b = seeding.build_ray_batch(geom, cfg_d)
    glob = {}
    for d in ("cpu", dev):
        rays = tv.make_ray_state(b["x"], b["y"], b["te"], b["tm"], b["cid"],
                                 b["idx"], b["rng"], device=d)
        t0 = time.perf_counter()
        glob[str(d)] = splitting.run_splitting(
            tables, tgeom, cfg_d, rays, capacity=1 << 15,
            weight_threshold=1e-5, max_steps=300, device=d)
        glob[str(d) + "_s"] = time.perf_counter() - t0
    c, g = glob["cpu"], glob[str(dev)]
    ok = (np.allclose(g.histogram, c.histogram, rtol=2e-4, atol=1e-10)
          and g.steps == c.steps and g.truncated == c.truncated == 0
          and abs(g.out_coupled - c.out_coupled) <= 1e-5 * c.out_coupled
          and abs(float(g.histogram.sum(dtype=np.float64)) - g.out_coupled)
          <= 1e-5 * g.out_coupled)
    rec["global"] = {"steps": g.steps, "out_coupled": [g.out_coupled,
                                                       c.out_coupled],
                     "pruned": [g.pruned, c.pruned], "ok": bool(ok),
                     "card_s": glob[str(dev) + "_s"],
                     "cpu_s": glob["cpu_s"]}
    save_record(ctx)
    print(f"phase 13d: the global engine on 18 cells x 4 positions: card "
          f"against CPU {'within the bars' if ok else 'OUTSIDE THE BARS'}; "
          f"{g.steps} steps, out-coupled {g.out_coupled:.8g} / "
          f"{c.out_coupled:.8g}; card {glob[str(dev) + '_s']:.3f} s")
    if not ok:
        faults.append(f"global engine: {rec['global']}")
    launches = dict(tp.launch_counts)
    rec["launches"] = launches
    rec["wall_s"] = time.perf_counter() - t_phase
    # one split_cells launch per batch and pass: 13a's run (32 passes) and
    # its two 4-pass runs in batches of 256 and 100 cells, 13b's card run
    # (one batch), 13c's 8 passes of one batch; one split_trace call for
    # 13d's card run
    per = pipeline.SPLIT_SLOT_BUDGET // 8192
    want = (math.ceil(576 / per) * (32 + 4) + math.ceil(576 / 100) * 4 + 1
            + math.ceil(256 / per) * 8)
    rec["split_cells_expected"] = want
    save_record(ctx)
    print(f"phase 13 launches: {launches} (split_cells expected {want}, "
          f"split_trace 1)")
    if launches["persistent_trace"] or launches["cell_trace"]:
        faults.append(f"the splitting engine launched the trace kernels: "
                      f"{launches}")
    if launches["split_cells"] != want:
        faults.append(f"{launches['split_cells']} split_cells launches, "
                      f"expected {want}")
    if (launches["split_trace"] != 1 or launches["split_trace_kernels"] != 1
            or launches["split_trace_backward"]):
        faults.append(f"13d's global engine: {launches['split_trace']} "
                      f"split_trace calls, expected 1, launching "
                      f"{launches['split_trace_kernels']} kernels, expected "
                      f"1, and {launches['split_trace_backward']} backward")
    ctx["split_launches"] = (ctx.get("split_launches", 0)
                             + launches["split_cells"])
    ctx["trace_launches"] = (ctx.get("trace_launches", 0)
                             + launches["split_trace"])
    if faults:
        fail("phase 13: " + "; ".join(faults))
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")


def _finite_metrics(res) -> bool:
    m = res.metrics
    vals = list(res.efficiencies.values()) + [m.delta_e, m.u_fov, m.u_eyebox]
    return all(math.isfinite(v) for v in vals)


def phase14(ctx) -> None:
    """``simulate --tail-boost`` at full width, and a top-tier tail chunk of
    the persistent kernel against its plain version."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        hybrid, pipeline, trace_persistent as tp,
    )

    dev = ctx["dev"]
    rec = ctx["record"].setdefault("phase14", {})
    cfg = TraceConfig()   # reference workload: 100 x 75 x 3, 5,000 x 4 rays
    sim = pipeline.Simulator(cfg=cfg, device=dev, **COUNT_FOLDED)
    before = ctx.get("count_starved")
    if before is None:   # phase 3b not run: the same run, its metrics
        before = sim.run(
            **simulate_options()).metrics.starved_eye_positions
    # the CLI's hybrid: tau_select 30, tau_target 20, max boost 1024
    hy = hybrid.TailBoostHybrid(sim)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tp.reset_launch_counts()
    t0 = time.perf_counter()
    res, d = hy.run(**simulate_options("--tail-boost"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tp.launch_counts)
    n_cells = sim.L * sim.M * sim.N
    batches = math.ceil(n_cells / 2048)
    budget = cfg.rays_per_fov * cfg.num_iter
    sel, rows, sums, frag = hy.tail
    met = res.metrics
    top = max(d.tiers) if d.tiers else 0
    rec.update(
        cells=n_cells, selected_cells=d.selected_cells,
        tiers={str(k): v for k, v in d.tiers.items()},
        tier_launches={str(k): v for k, v in d.tier_launches.items()},
        tail_rays=d.tail_rays, min_pilot_count=d.min_pilot_count,
        min_tail_expected=d.min_tail_expected,
        max_tail_iterations=d.max_tail_iterations,
        tail_cells_at_cap=d.tail_cells_at_cap,
        iteration_cap=cfg.max_bounces, pilot_s=d.pilot_seconds,
        tail_s=d.tail_seconds, bulk_s=d.mc_seconds, wall_s=wall,
        setup_s=sim.setup_seconds, launches=launches,
        starved_before=before, starved_after=met.starved_eye_positions,
        efficiencies=res.efficiencies, delta_e=met.delta_e, u_fov=met.u_fov,
        u_eyebox=met.u_eyebox, peak_bytes=torch.cuda.max_memory_allocated())
    save_record(ctx)
    tiers = ", ".join(f"{k}x: {v} groups in {d.tier_launches[k]} launch(es)"
                      for k, v in sorted(d.tiers.items()))
    print(f"phase 14: --tail-boost at {n_cells:,} cells, {budget:,} rays per "
          f"cell: {d.selected_cells:,} cells selected, tiers [{tiers}], "
          f"{d.tail_rays:,} tail rays (top tier {top * budget:,} rays per "
          f"cell); largest nb[:, 1] of the tail {d.max_tail_iterations:,} "
          f"of the {cfg.max_bounces:,}-iteration cap; pilot "
          f"{d.pilot_seconds:.3f} s, tail {d.tail_seconds:.3f} s, bulk "
          f"{d.mc_seconds:.3f} s, wall {wall:.3f} s; starved eye positions "
          f"{before} -> {met.starved_eye_positions}; u_eyebox "
          f"{met.u_eyebox:.5f}, delta E {met.delta_e:.4f}; launches "
          f"{launches}")
    faults = []
    want = 2 * batches + sum(d.tier_launches.values())
    if trace_launches(launches) != {"persistent_trace": want,
                                    "cell_trace": 0}:
        faults.append(f"launches {launches}, expected {want} persistent")
    if not met.starved_eye_positions < before:
        faults.append(f"starved eye positions {before} -> "
                      f"{met.starved_eye_positions}")
    if not _finite_metrics(res):
        faults.append("a patched metric is not finite")
    if d.tail_cells_at_cap:
        print(f"phase 14: {d.tail_cells_at_cap} tail cell(s) reached the "
              f"{cfg.max_bounces:,}-iteration cap before their spawn target "
              "(ROADMAP F5)")

    # ---- a chunk of the top tier: its cells, seeds (iteration tag) and
    # spawn target, once to the end (the kernel alone) and over the first
    # CUT iterations of both the kernel and its plain version
    cells = sel[frag["cell_tier"] == top][:4]
    rpc = int(top * budget)
    slots, gens = sim._slots_gens(rpc)
    rays_in, rng_in = sim._device_ray_blocks(
        cells, slots, hybrid.tail_iteration(rpc))
    tr = sim.tracer
    args = (tp.select_cells(tr.cell_params, cells).contiguous(),
            tr.geom_row, rays_in, rng_in, sim._pers_ctrl(rpc, gens))
    kw = dict(num_fc=tr.num_fc, num_oc=tr.num_oc, edge_counts=tr.edge_counts,
              eyebox_bins=tr.eyebox_bins)
    full_ms = cuda_ms(lambda: tp.persistent_trace(
        *args, max_iters=cfg.max_bounces, **kw), 1)
    hk, nbk = tp.persistent_trace(*args, max_iters=cfg.max_bounces, **kw)
    nb_full = nbk.cpu().numpy()
    cut = ctx.get("top_tier_cut", 1024)
    hc, nbc = tp.persistent_trace(*args, max_iters=cut, **kw)
    cut_ms = cuda_ms(lambda: tp.persistent_trace(*args, max_iters=cut, **kw),
                     1)
    bound_cut, bound_by_cut = bound_ms(args, (hc, nbc), nbc,
                                       tr.edge_counts[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp, nbp = tp.persistent_trace_reference(*args, max_iters=cut, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same = bool(torch.equal(hc, hp) and torch.equal(nbc, nbp))
    chunk = {
        "cells": [int(c) for c in cells], "rays_per_cell": rpc,
        "slots": slots, "iteration_tag": hybrid.tail_iteration(rpc),
        "full_ms": full_ms, "full_iterations": nb_full[:, 1].tolist(),
        "full_spawned": nb_full[:, 2].tolist(),
        "full_bounces": nb_full[:, 0].tolist(),
        "full_max_bin": float(hk.max()), "cut_iterations": cut,
        "cut_identical": same, "max_abs_err": float((hc - hp).abs().max()),
        "cut_ms": cut_ms, "cut_bound_ms": bound_cut,
        "cut_bound_by": bound_by_cut, "plain_cut_s": plain_s,
        "plain_full_estimate_s": plain_s * int(nb_full[:, 1].max()) / cut}
    rec["top_tier_chunk"] = chunk
    save_record(ctx)
    print(f"phase 14 top tier: {len(cells)} cells x {rpc:,} rays over "
          f"{slots} slots (tag {chunk['iteration_tag']}): the kernel to the "
          f"end {full_ms:.1f} ms, iterations {chunk['full_iterations']}, "
          f"spawned {chunk['full_spawned']}, bounces "
          f"{chunk['full_bounces']}, largest bin {chunk['full_max_bin']:.0f}; "
          f"kernel and plain version over the first {cut} iterations "
          f"{'identical' if same else 'DIFFER'} (kernel {cut_ms:.2f} ms, "
          f"bound {bound_cut:.4f} ms ({bound_by_cut}), plain "
          f"{plain_s:.2f} s; the plain version to the end about "
          f"{chunk['plain_full_estimate_s']:.0f} s)")
    if not same:
        faults.append("the top-tier chunk differs from the plain version")
    # a cell stops at its spawn target or at the iteration cap (F5: its
    # tile is renormalised by target / spawned, as in the JAX package)
    capped = nb_full[:, 1] >= cfg.max_bounces
    if ((nb_full[:, 2] < rpc) & ~capped).any():
        faults.append(f"top-tier chunk stopped early: {nb_full.tolist()}")
    if faults:
        fail("phase 14: " + "; ".join(faults))
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    ctx["k1_hybrid_launches"] = (ctx.get("k1_hybrid_launches", 0)
                                 + launches["persistent_trace"])
    ctx["k1_modes"] = ctx.get("k1_modes", []) + [{
        "mode": "count, top boost tier", "ctrl": [rpc, 0], "designs": 1,
        "cells": len(cells), "slots": slots, "max_iters": cut,
        "max_abs_err": chunk["max_abs_err"], "ms": cut_ms,
        "plain_ms": plain_s * 1e3, "bound_ms": bound_cut,
        "bound_by": bound_by_cut}]


def phase14g(ctx) -> None:
    """``simulate --tail-boost`` with no other flag at full width: the
    hybrid around the default ``Simulator`` (gens spawn, unfolded), so the
    pilot, the boost tiers and the bulk all run in gens spawn."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        hybrid, pipeline, trace_persistent as tp,
    )

    dev = ctx["dev"]
    rec = ctx["record"].setdefault("phase14g", {})
    cfg = TraceConfig()   # reference workload: 100 x 75 x 3, 5,000 x 4 rays
    sim = pipeline.Simulator(cfg=cfg, device=dev)
    before = ctx.get("default_starved")
    if before is None:   # phase 3 not run: the same run, its metrics
        before = sim.run(
            **simulate_options()).metrics.starved_eye_positions
    hy = hybrid.TailBoostHybrid(sim)   # the CLI's knobs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tp.reset_launch_counts()
    t0 = time.perf_counter()
    res, d = hy.run(**simulate_options("--tail-boost"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tp.launch_counts)
    batches = math.ceil(sim.L * sim.M * sim.N / 2048) * cfg.num_iter
    met = res.metrics
    rec.update(
        spawn_mode=sim._spawn_mode, fold_iterations=sim._fold_iterations,
        selected_cells=d.selected_cells,
        tiers={str(k): v for k, v in d.tiers.items()},
        tier_launches={str(k): v for k, v in d.tier_launches.items()},
        tail_rays=d.tail_rays, max_tail_iterations=d.max_tail_iterations,
        tail_cells_at_cap=d.tail_cells_at_cap, iteration_cap=cfg.max_bounces,
        pilot_s=d.pilot_seconds, tail_s=d.tail_seconds, bulk_s=d.mc_seconds,
        wall_s=wall, setup_s=sim.setup_seconds,
        setup_timings=sim.setup_timings, launches=launches,
        starved_before=before, starved_after=met.starved_eye_positions,
        efficiencies=res.efficiencies, delta_e=met.delta_e, u_fov=met.u_fov,
        u_eyebox=met.u_eyebox, peak_bytes=torch.cuda.max_memory_allocated(),
        splice={k: res.timings[k] for k in ("metrics_s", "perceive_ms",
                                            "colorimetry_ms", "pull_s")})
    save_record(ctx)
    tiers = ", ".join(f"{k}x: {v} groups in {d.tier_launches[k]} launch(es)"
                      for k, v in sorted(d.tiers.items()))
    print(f"phase 14g: --tail-boost with the defaults ({sim._spawn_mode} "
          f"spawn, {'folded' if sim._fold_iterations else 'unfolded'}): "
          f"{d.selected_cells:,} cells selected, tiers [{tiers}], "
          f"{d.tail_rays:,} tail rays; largest nb[:, 1] of the tail "
          f"{d.max_tail_iterations:,} of the {cfg.max_bounces:,}-iteration "
          f"cap, {d.tail_cells_at_cap} tail cell(s) stopped there short of "
          f"their rays (ROADMAP F5); pilot {d.pilot_seconds:.3f} s, tail "
          f"{d.tail_seconds:.3f} s, bulk {d.mc_seconds:.3f} s, splice "
          f"{tail_text(res.timings)}, wall {wall:.3f} s; starved eye "
          f"positions {before} -> {met.starved_eye_positions}; u_eyebox "
          f"{met.u_eyebox:.5f}, delta E {met.delta_e:.4f}; launches "
          f"{launches}; the bulk Simulator's {setup_text(sim)}")
    faults = []
    want = 2 * batches + sum(d.tier_launches.values())
    if trace_launches(launches) != {"persistent_trace": want,
                                    "cell_trace": 0}:
        faults.append(f"launches {launches}, expected {want} persistent")
    if met.starved_eye_positions > before:
        faults.append(f"starved eye positions {before} -> "
                      f"{met.starved_eye_positions}")
    if not _finite_metrics(res) or min(res.efficiencies.values()) <= 0:
        faults.append(f"metrics not finite or efficiencies not positive: "
                      f"{res.efficiencies}")
    if faults:
        fail("phase 14g: " + "; ".join(faults))
    # perception: the pilot's histogram, each tier chunk's tiles and the
    # bulk's histogram before the splice; colorimetry: the splice
    tail_launches(ctx, "14g", launches, 2 + sum(d.tier_launches.values()), 1)
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    ctx["k1_hybrid_launches"] = (ctx.get("k1_hybrid_launches", 0)
                                 + launches["persistent_trace"])


def phase14b(ctx) -> None:
    """``simulate --tail-exact`` at 20 x 15 FoV (the grid cut from 100 x 75;
    the reference budget per cell)."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        hybrid, pipeline, trace_persistent as tp,
    )

    dev = ctx["dev"]
    cfg = TraceConfig(num_fov_x=20, num_fov_y=15)
    sim = pipeline.Simulator(cfg=cfg, device=dev)
    before = sim.run(**simulate_options()).metrics.starved_eye_positions
    # the CLI's exact tail: tau 30, one launch point per pass, 8,192 slots
    hy = hybrid.ExactTailHybrid(sim, tau=30.0, points_per_pass=1,
                                capacity=8192, max_steps=1024)
    torch.cuda.synchronize()
    tp.reset_launch_counts()
    t0 = time.perf_counter()
    res, d = hy.run(**simulate_options("--tail-exact"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tp.launch_counts)
    # the pilot once more: its first run holds the process's first uses of
    # the splitting engine's operations
    t0 = time.perf_counter()
    hy.select()
    pilot_again = time.perf_counter() - t0
    met = res.metrics
    n_cells = sim.L * sim.M * sim.N
    rec = {"cells": n_cells, "selected_cells": d.selected_cells,
           "pilot_again_s": pilot_again,
           "min_expected": d.min_pilot_count, "pruned": d.exact_pruned,
           "pilot_s": d.pilot_seconds, "tail_s": d.tail_seconds,
           "bulk_s": d.mc_seconds, "wall_s": wall, "launches": launches,
           "starved_before": before,
           "starved_after": met.starved_eye_positions,
           "efficiencies": res.efficiencies, "delta_e": met.delta_e,
           "u_fov": met.u_fov, "u_eyebox": met.u_eyebox,
           "ms_per_selected_cell": (d.tail_seconds * 1e3
                                    / max(d.selected_cells, 1))}
    ctx["record"]["phase14b"] = rec
    save_record(ctx)
    print(f"phase 14b: --tail-exact at 20 x 15 FoV ({n_cells} cells): "
          f"{d.selected_cells} cells selected (expected worst window < 30), "
          f"pruned weight {d.exact_pruned:.4g}; pilot "
          f"{d.pilot_seconds:.3f} s (again: {pilot_again:.3f} s), exact "
          f"tail {d.tail_seconds:.3f} s "
          f"({rec['ms_per_selected_cell']:.2f} ms per cell at 16 points), "
          f"bulk {d.mc_seconds:.3f} s; starved eye positions {before} -> "
          f"{met.starved_eye_positions}; u_eyebox {met.u_eyebox:.5f}; "
          f"launches {launches}")
    faults = []
    # the bulk run, as simulate runs it: one launch per batch and iteration
    bulk = math.ceil(n_cells / 2048) * run_shape(sim)[1]
    if trace_launches(launches) != {"persistent_trace": bulk,
                                    "cell_trace": 0}:
        faults.append(f"launches {launches}, expected {bulk}")
    # the exact tail: one split_cells launch per chunk and pass of the
    # pilot (the coarse subgrid) and of the selected cells
    coarse = sim.L * math.prod(
        len(set(range(0, n, hy.stride)) | {n - 1}) for n in (sim.M, sim.N))
    want = sum(math.ceil(cells / hy._cpb)
               * math.ceil(pts / min(pts, hy.points_per_pass))
               for cells, pts in ((coarse, hy.pilot_points),
                                  (d.selected_cells, hy.exact_points)))
    rec["split_cells_expected"] = want
    if launches["split_cells"] != want:
        faults.append(f"{launches['split_cells']} split_cells launches, "
                      f"expected {want}")
    if not (d.selected_cells and met.starved_eye_positions <= before):
        faults.append(f"starved {before} -> {met.starved_eye_positions} "
                      f"with {d.selected_cells} cells selected")
    if not _finite_metrics(res):
        faults.append("a patched metric is not finite")
    if faults:
        fail("phase 14b: " + "; ".join(faults))
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    ctx["k1_hybrid_launches"] = (ctx.get("k1_hybrid_launches", 0)
                                 + launches["persistent_trace"])
    ctx["split_launches"] = (ctx.get("split_launches", 0)
                             + launches["split_cells"])


TIED = ("lambda_tied", "phi_tied")


def _optimize_case(ctx, name, grid, rays, steps_asked, budget_s, joint,
                   **kw):
    """One ``optimize`` case through ``optimize_apodization`` or (``joint``)
    ``optimize_grating`` with the tied knobs and the apodization: its
    layers over two timed steps (forward, backward, Adam step), the steps
    the time budget allows, the run, and the truncated and deposited weight
    of its first and last trace (every trace's ledger is read)."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
        generate_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        splitting, trace_persistent as tp,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
        build_trace_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.io import (
        load_or_synthesize,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.packing import (
        build_cell_tables,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.opt import (
        grating_opt as opt,
    )

    dev = ctx["dev"]
    M, N = grid
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=rays,
                      max_bounces=2048)
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    tables = build_cell_tables(geom, load_or_synthesize(geom))
    tgeom = build_trace_geometry(geom)
    lr = 0.01 if joint else 0.15

    # ---- layers: two steps by hand on the optimiser's own loss
    rays0 = opt._launch_rays(geom, cfg, rays, None, dev)
    theta = {k: torch.full((n,), 2.0, device=dev, requires_grad=True)
             for k, n in (("fc", tgeom.num_fc), ("oc", tgeom.num_oc))}
    if joint:
        loss, _ = opt.make_grating_loss(tables, tgeom, cfg, rays0,
                                        geom.design, opt_params=TIED,
                                        apodize=True, **kw)
        theta.update({k: torch.zeros((), device=dev, requires_grad=True)
                      for k in TIED})
    else:
        loss, _ = opt.make_apodization_loss(tables, tgeom, cfg, rays0, **kw)
    adam = opt._adam(theta, lr)
    layers = {"forward_ms": [], "backward_ms": [], "adam_ms": []}
    for _ in range(2):
        for v in theta.values():
            v.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with splitting.deterministic():
            val, _ = loss(theta)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            val.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adam.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        layers["forward_ms"].append((t1 - t0) * 1e3)
        layers["backward_ms"].append((t2 - t1) * 1e3)
        layers["adam_ms"].append((t3 - t2) * 1e3)
    del loss, theta, adam, val
    step_s = sum(v[-1] for v in layers.values()) / 1e3
    steps = max(2, min(steps_asked, int(budget_s / step_s)))

    # ---- the run, every trace's ledger recorded
    ledger = []
    make = splitting.make_splitting_trace_fn

    def recording(*a, **k):
        fn = make(*a, **k)

        def trace(*args):
            out = fn(*args)
            ledger.append((float(out[2].detach()), float(out[1].detach())))
            return out
        return trace

    torch.cuda.reset_peak_memory_stats()
    splitting.make_splitting_trace_fn = recording
    try:
        tp.reset_launch_counts()
        t0 = time.perf_counter()
        if joint:
            res = opt.optimize_grating(
                geom, tables, tgeom, cfg, opt_params=TIED, rays_per_fov=rays,
                steps=steps, learning_rate=lr, apodize=True, device=dev, **kw)
        else:
            res = opt.optimize_apodization(
                geom, tables, tgeom, cfg, rays_per_fov=rays, steps=steps,
                learning_rate=lr, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(tp.launch_counts)
    finally:
        splitting.make_splitting_trace_fn = make
    n0 = len(rays0["x"])
    (tr0, ow0), (tr1, ow1) = ledger[0], ledger[-1]
    out = {"grid": [M, N], "rays_per_fov": rays, "launch_rays": n0,
           "steps_asked": steps_asked, "steps": steps, "wall_s": wall,
           "s_per_step": wall / (steps + 1), "layers_ms": layers,
           "loss_history": np.asarray(res.loss_history).tolist(),
           "efficiency": list(res.efficiency),
           "nonuniformity": list(res.nonuniformity),
           "truncated_first_last": [tr0, tr1],
           "out_coupled_first_last": [ow0, ow1], "traces": len(ledger),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, **kw}
    if joint:
        out["params"] = res.params
    ctx["record"].setdefault("phase15", {})[name] = out
    save_record(ctx)
    h = res.loss_history
    cut = "" if steps == steps_asked else f" (cut from {steps_asked})"
    print(f"phase 15 {name}: {M} x {N} FoV x {rays} rays ({n0:,} launch "
          f"rays), capacity {kw['capacity']:,}, {kw['fixed_steps']} trace "
          f"steps: {steps} Adam steps{cut} in {wall:.2f} s; a step: forward "
          f"{layers['forward_ms'][-1]:.1f} ms, backward "
          f"{layers['backward_ms'][-1]:.1f} ms, Adam "
          f"{layers['adam_ms'][-1]:.2f} ms; loss {h[0]:.5f} -> {h[-1]:.5f}; "
          f"truncated weight {tr0:.4g} -> {tr1:.4g} of {n0:,} launched "
          f"(deposited {ow0:.4g} -> {ow1:.4g}); peak "
          f"{out['peak_bytes'] / 2**20:.0f} MiB; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return out


def phase15(ctx) -> None:
    """``optimize``: the README's apodization case and joint case (steps cut
    to the time budget), and a case whose wavefront holds every branch."""
    cases = [
        # the README's `optimize --fov-x 16 --fov-y 12 --steps 40` (the
        # CLI's defaults: 16 rays, 4,096 slots, 64 trace steps, lr 0.15)
        ("apodization", (16, 12), 16, 40, 48.0, False,
         dict(capacity=4096, fixed_steps=64)),
        # the README's joint design: 24 x 18, 8 rays, tied knobs with the
        # apodization, pupil_bins=24, 16,384 slots, 40 steps at lr 0.01
        ("joint", (24, 18), 8, 40, 20.0, True,
         dict(capacity=16384, fixed_steps=64, pupil_bins=24)),
        # the apodization grid at 2 rays per FoV in a wavefront that holds
        # every branch (262,144 slots)
        ("apodization_whole_wavefront", (16, 12), 2, 6, 10.0, False,
         dict(capacity=1 << 18, fixed_steps=64)),
    ]
    faults = []
    for name, grid, rays, steps, budget, joint, kw in cases:
        out = _optimize_case(ctx, name, grid, rays, steps, budget, joint,
                             **kw)
        h = out["loss_history"]
        if not (all(math.isfinite(v) for v in h) and h[-1] < h[0]):
            faults.append(f"{name}: loss {h[0]} -> {h[-1]}")
        if name.endswith("whole_wavefront") and any(
                out["truncated_first_last"]):
            faults.append(f"{name}: truncated {out['truncated_first_last']}")
        n = out["launches"]
        if (n["split_trace"] != out["steps"] + 1
                or n["split_trace_backward"] != out["steps"]):
            faults.append(f"{name}: {n['split_trace']} split_trace and "
                          f"{n['split_trace_backward']} backward launches "
                          f"for {out['steps']} Adam steps")
        for k in ("split_trace", "split_trace_backward"):
            if n[f"{k}_kernels"] != n[k]:
                faults.append(f"{name}: {n[k]} {k} calls launched "
                              f"{n[f'{k}_kernels']} kernels, not one each")
        ctx["trace_launches"] = (ctx.get("trace_launches", 0)
                                 + n["split_trace"])
        ctx["trace_backward_launches"] = (
            ctx.get("trace_backward_launches", 0) + n["split_trace_backward"])
    if faults:
        fail("phase 15: " + "; ".join(faults))
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")


# ---- phase 16: the mesh.  The ranks' functions are module-level: a spawned
# rank imports this file to find them


def _mesh_simulate_rank(rank: int, world: int) -> dict:
    """One rank of phase 16b: the reference workload through
    ``Simulator(mesh=)`` on a 1-D mesh over the one card."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, trace_persistent as tp,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.parallel import (
        shard,
    )

    mesh = shard.make_mesh((world,), ("cells",), "cuda")
    dev = shard.mesh_device(mesh)
    t0 = time.perf_counter()
    sim = pipeline.Simulator(cfg=TraceConfig(), device=dev, mesh=mesh,
                             **COUNT_FOLDED)
    torch.cuda.synchronize()
    tp.reset_launch_counts()
    t1 = time.perf_counter()
    res = sim.run(**simulate_options("--mesh", str(world)))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = tp.launch_counts["persistent_trace"]
    met = res.metrics
    tm = res.timings
    return {"mesh": shard.describe_mesh(mesh), "digest": digest(res.histogram),
            "bounces": res.total_bounces,
            "efficiencies": dict(res.efficiencies),
            "metrics": [met.delta_e, met.u_fov, met.u_eyebox],
            "wall_s": t2 - t0, "run_s": t2 - t1,
            "setup_s": sim.setup_seconds, "trace_s": res.trace_seconds,
            "kernel_ms": tm["kernel_ms"], "gather_ms": tm["gather_ms"],
            "gather_s": tm["gather_s"], "seed_ms": tm["seed_ms"],
            "metrics_s": tm["metrics_s"], "launches": launches,
            # what the rank sends: its tiles and nb rows of every batch
            "sent_bytes": (sim.L * sim.M * sim.N // world
                           * (res.histogram[0, 0, 0].numel() * 4 + 16))}


def _mesh_k1_rank(rank: int, world: int) -> dict:
    """One rank of phase 16c: K1 at phase 2's size on a 2 x 2 (cells,
    samples) mesh over the one card, each sharded form against the one-rank
    runs of this rank."""
    import functools

    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, trace_persistent as tp,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.ops import (
        rng as rng_ops,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.parallel import (
        shard,
    )

    mesh = shard.make_mesh((2, 2), ("cells", "samples"), "cuda")
    dev = shard.mesh_device(mesh)
    cfg2 = TraceConfig(num_fov_x=8, num_fov_y=6, rays_per_fov=5000,
                       num_iter=4)
    sim = pipeline.Simulator(cfg=cfg2, device=dev, persistent_slots=2048,
                             **COUNT_FOLDED)
    n2 = sim.L * sim.M * sim.N
    target = cfg2.rays_per_fov * cfg2.num_iter // 2   # a half per seed block
    slots, _ = sim._slots_gens(target)
    tile, rng = sim._device_ray_blocks(np.arange(n2), slots)
    tr = sim.tracer
    fn = functools.partial(
        tp.persistent_trace, num_fc=tr.num_fc, num_oc=tr.num_oc,
        edge_counts=tr.edge_counts, eyebox_bins=tr.eyebox_bins,
        max_iters=tr.max_iters, spawn_mode="count")
    ctrl = sim._pers_ctrl(target)
    # two distinct seed blocks: the seeds plus 7919 * (d + 1), in uint32
    blocks = torch.stack([rng_ops.as_int32_bits(
        (rng.to(torch.int64) + 7919 * (d + 1)) & 0xFFFFFFFF)
        for d in range(2)])
    one = [fn(tr.cell_params, tr.geom_row, tile, blocks[d], ctrl)
           for d in range(2)]
    sums = (one[0][0] + one[1][0], one[0][1] + one[1][1])
    out = {"mesh": shard.describe_mesh(mesh)}
    t, nb = shard.make_sample_sharded_cell_trace_fn(fn, mesh, "samples")(
        tr.cell_params, tr.geom_row, tile, blocks, ctrl)
    out["samples"] = bool(torch.equal(t, sums[0]) and torch.equal(nb, sums[1]))
    t, nb = shard.make_2d_sharded_cell_trace_fn(fn, mesh)(
        tr.cell_params, tr.geom_row, tile, blocks, ctrl)
    out["2x2"] = bool(torch.equal(t, sums[0]) and torch.equal(nb, sums[1]))
    cells = shard.make_sharded_cell_trace_fn(fn, mesh, "cells")
    ts, nbs = cells(tr.cell_params, tr.geom_row, tile, blocks[0], ctrl)
    copies = tile.expand(n2, -1, -1, -1).contiguous()
    tc, nbc = cells(tr.cell_params, tr.geom_row, copies, blocks[0], ctrl)
    out["shared_tile"] = bool(
        torch.equal(ts, tc) and torch.equal(nbs, nbc)
        and torch.equal(ts, one[0][0]) and torch.equal(nbs, one[0][1]))
    out["deposits"] = float(sums[0].sum())
    return out


def _mesh_sweep_rank(rank: int, world: int) -> dict:
    """One rank of phase 16d: phase 6a's sweep with a mesh over the one
    card."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_persistent as tp,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.parallel import (
        shard,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
        run_design_sweep_persistent,
    )

    mesh = shard.make_mesh((world,), ("designs",), "cuda")
    sargs = cli.build_parser().parse_args(["sweep", "--metrics"])
    designs, _ = cli.sweep_designs(sargs)
    torch.cuda.synchronize()
    tp.reset_launch_counts()
    t0 = time.perf_counter()
    r = run_design_sweep_persistent(
        designs, cli.sweep_config(sargs), spawn_iters=sargs.spawn_iters,
        spawn_mode=sargs.spawn_mode, slots=sargs.slots,
        evaluate_metrics=True, device=shard.mesh_device(mesh), mesh=mesh,
        keep_histograms=[3])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(sweep_summary(r), wall_s=wall,
                launches=tp.launch_counts["persistent_trace"],
                timings={k: v for k, v in r.timings.items()
                         if isinstance(v, (int, float))})


def _nccl_shared_card_rank(rank: int, world: int) -> list:
    """One rank of phase 16e: an NCCL group of every rank on the one card
    and one all_reduce in it; returns what happened."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        group = dist.new_group(list(range(world)), backend="nccl",
                               timeout=datetime.timedelta(seconds=60))
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        return ["accepted", x.tolist()]
    except Exception as e:   # the finding to record, whatever NCCL raises
        return ["refused", f"{type(e).__name__}: {e}"[:400]]


def _same_as_main(ctx, got: dict, what: str) -> list:
    """The faults of a mesh run against phase 3b's run."""
    want = ctx.get("count_run")
    if want is None:
        return []
    faults = [f"{what}: {k} {got[k]} != phase 3b's {want[k]}"
              for k in ("digest", "bounces", "efficiencies", "metrics")
              if got[k] != want[k]]
    return faults


def phase16(ctx) -> None:
    """The mesh: NCCL world 1, two gloo ranks on the card, the sample and
    2 x 2 traces on four ranks, the mesh sweep, and NCCL's answer to two
    ranks on one card."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, trace_persistent as tp,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.parallel import (
        shard,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.parallel.spawn import (
        run_ranks,
    )

    record = ctx["record"].setdefault("phase16", {})
    faults = []
    card = nvidia_smi()

    # ---- (a) NCCL, world size 1, in this process
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = shard.make_mesh((1,), ("cells",), "cuda")
            torch.cuda.synchronize()
            tp.reset_launch_counts()
            t0 = time.perf_counter()
            sim = pipeline.Simulator(cfg=TraceConfig(), device=ctx["dev"],
                                     mesh=mesh, **COUNT_FOLDED)
            res = sim.run(**simulate_options("--mesh", "1"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = tp.launch_counts["persistent_trace"]
            desc = shard.describe_mesh(mesh)
        finally:
            dist.destroy_process_group()
    met, tm = res.metrics, res.timings
    a = {"mesh": desc, "digest": digest(res.histogram),
         "bounces": res.total_bounces, "efficiencies": dict(res.efficiencies),
         "metrics": [met.delta_e, met.u_fov, met.u_eyebox], "wall_s": wall,
         "trace_s": res.trace_seconds, "kernel_ms": tm["kernel_ms"],
         "gather_ms": tm["gather_ms"], "launches": launches}
    del res, sim
    record["a_nccl_world_1"] = a
    print(f"phase 16a: {desc}: wall {wall:.3f} s, trace "
          f"{a['trace_s']:.3f} s, kernel {a['kernel_ms']:.1f} ms, gather "
          f"{a['gather_ms']:.2f} ms in {launches} launches; {card}")
    faults += _same_as_main(ctx, a, "16a")
    mesh_launches = launches

    # ---- (b) two ranks on the one card over gloo
    t0 = time.perf_counter()
    ranks = run_ranks(_mesh_simulate_rank, 2, timeout_s=600, threads=None)
    wall_b = time.perf_counter() - t0
    record["b_gloo_2_ranks"] = {"ranks": ranks, "spawn_wall_s": wall_b}
    for r, out in enumerate(ranks):
        print(f"phase 16b rank {r}: {out['mesh']}: K1 {out['kernel_ms']:.1f} "
              f"ms in {out['launches']} launches, gather of "
              f"{out['sent_bytes'] / 1e6:.1f} MB sent "
              f"{out['gather_ms']:.1f} ms device / {out['gather_s']:.3f} s "
              f"host, seeding {out['seed_ms']:.1f} ms, trace "
              f"{out['trace_s']:.3f} s, run {out['run_s']:.3f} s, wall "
              f"{out['wall_s']:.3f} s (setup {out['setup_s']:.3f} s); {card}")
        faults += _same_as_main(ctx, out, f"16b rank {r}")
        mesh_launches += out["launches"]
    print(f"phase 16b: two ranks spawned, run and joined in {wall_b:.1f} s "
          "(one card: the ranks share it; no multi-GPU scaling is measured)")

    # ---- (c) four ranks: sample, 2 x 2 and shared-tile forms
    t0 = time.perf_counter()
    ranks = run_ranks(_mesh_k1_rank, 4, timeout_s=600, threads=None)
    record["c_k1_4_ranks"] = {"ranks": ranks,
                              "wall_s": time.perf_counter() - t0}
    for r, out in enumerate(ranks):
        bad = [k for k in ("samples", "2x2", "shared_tile") if not out[k]]
        if bad:
            faults.append(f"16c rank {r}: {bad} differ from the one-rank runs")
    print(f"phase 16c: {ranks[0]['mesh']}: the sample-sharded trace and the "
          "2 x 2 trace equal the sums of the one-rank runs, the shared tile "
          f"equals per-cell copies, on every rank ({ranks[0]['deposits']:.0f} "
          f"deposits); {record['c_k1_4_ranks']['wall_s']:.1f} s")

    # ---- (d) phase 6a's sweep over two ranks
    ranks = run_ranks(_mesh_sweep_rank, 2, timeout_s=600, threads=None)
    record["d_sweep_2_ranks"] = ranks
    want = ctx.get("sweep6a")
    for r, out in enumerate(ranks):
        tm = out["timings"]
        print(f"phase 16d rank {r}: 8 designs, 4 on this rank: wall "
              f"{out['wall_s']:.3f} s (prep {tm['prep_s']:.3f} s, gathers "
              f"{tm['gather_s']:.3f} s), kernel {tm['kernel_ms']:.1f} ms in "
              f"{out['launches']} launch(es); {card}")
        if want is not None:
            faults += [f"16d rank {r}: {k} differ from phase 6a's"
                       for k in want if out[k] != want[k]]
        mesh_launches += out["launches"]

    # ---- (e) NCCL with two ranks on one card
    nccl = run_ranks(_nccl_shared_card_rank, 2, timeout_s=180, threads=None)
    record["e_nccl_2_ranks_1_card"] = nccl
    print(f"phase 16e: NCCL, two ranks on one card: {nccl[0][0]} "
          f"({nccl[0][1]})")
    save_record(ctx)
    if faults:
        fail("phase 16: " + "; ".join(faults))
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    ctx["k1_mesh_launches"] = mesh_launches


def phase17(ctx) -> None:
    """``simulate --profile-dir`` on the card: the trace names K1."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", PORT, "simulate", "--fov-x", "20",
               "--fov-y", "15", "--image", "", "--profile-dir", tmp]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"phase 17: {' '.join(cmd)} exited {out.returncode}:\n"
                 f"{out.stderr[-3000:]}")
        traces = sorted(Path(tmp).glob("*.pt.trace.json"))
        if len(traces) != 1:
            fail(f"phase 17: {len(traces)} trace files in the profile dir")
        events = json.loads(traces[0].read_text())["traceEvents"]
        size = traces[0].stat().st_size
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "persistent_trace_kernel" in e.get("name", "")]
    k1_ms = sum(e.get("dur", 0) for e in k1) / 1e3
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    entry = {"wall_s": wall, "trace_bytes": size, "events": len(events),
             "k1_events": len(k1), "k1_device_ms": k1_ms,
             "kernel_names": len(kernels)}
    ctx["record"]["phase17"] = entry
    save_record(ctx)
    print(f"phase 17: simulate --profile-dir at 20 x 15 FoV: {wall:.1f} s, "
          f"trace {size / 2**20:.1f} MiB, {len(events)} events, K1 "
          f"{len(k1)} kernel event(s), {k1_ms:.2f} ms on the device")
    if not k1:
        fail("phase 17: the profiler trace names no persistent_trace_kernel "
             "device event")


def phase18(ctx) -> None:
    """The reference workload with the native pupil sampler."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        native, pipeline, trace_persistent as tp,
    )

    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    tp.reset_launch_counts()
    t0 = time.perf_counter()
    sim = pipeline.Simulator(cfg=TraceConfig(pupil_sampler="native"),
                             device=ctx["dev"], **COUNT_FOLDED)
    res = sim.run(**simulate_options())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tp.launch_counts["persistent_trace"]
    eff = res.efficiencies
    ref = ctx.get("count_efficiencies")
    rel = ({k: eff[k] / ref[k] - 1 for k in eff} if ref else None)
    ctx["record"]["phase18"] = {
        "library": lib.name, "build_s": build_s, "wall_s": wall,
        "trace_s": res.trace_seconds, "efficiencies": eff,
        "relative_to_phase3b": rel, "launches": launches,
        "bounces": res.total_bounces}
    save_record(ctx)
    print(f"phase 18: native pupil sampler ({lib.name}, g++ {build_s:.2f} "
          f"s): wall {wall:.3f} s, trace {res.trace_seconds:.3f} s, "
          f"{launches} launches; efficiencies {eff}; relative to phase 3b's "
          f"{rel}")
    if not all(math.isfinite(v) and v > 0 for v in eff.values()):
        fail(f"phase 18: efficiencies {eff}")
    if rel is not None and max(abs(v) for v in rel.values()) > 0.02:
        fail(f"phase 18: efficiencies {rel} beyond 2 % of phase 3b's")
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    ctx["k1_native_launches"] = launches

# lane instructions of one (branch, cell) item of the rows' kernel: the
# scale's 2 multiplies and eight real-times-complex products of 6
# operations, one FP64 instruction each, with the fast paths of __ddiv_rn
# (16 instructions, 9 FP64) and __dsqrt_rn (15, 9 FP64) from their SASS
# (tools/cell_rows_phases.py, which counts them with tools/sass_paths.py;
# NVIDIA H100 80GB HBM3, CUDA 12.8); and of a cell's scalar columns, 11
# operations and three IEEE float32 divisions of 10
ROWS_ITEM_LANES = 50 + 16 + 15
ROWS_ITEM_FP64 = 50 + 9 + 9
ROWS_ROW_LANES = 11 + 3 * 10


def phase19(ctx) -> None:
    """The rows' kernel against its plain version and the host pipeline."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        WaveguideDesign,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
        generate_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build, cell_rows as cr, trace_rows,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.packing import (
        build_cell_tables, build_cell_tables_synthetic_batch,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.synthetic import (
        make_synthetic_luts,
    )

    dev = ctx["dev"]
    bins = (80, 120)
    seed = 1234   # simulate's (--seed 0) and the sweeps' LUT seed
    g = generate_geometry(WaveguideDesign(), 100, 75)
    cases = [("reference", [g], g.eyebox_range, lambda: (
        trace_rows.build_kernel_cell_params(
            build_cell_tables(g, make_synthetic_luts(g, seed=seed)),
            g.eyebox_range, bins)), False)]
    for name, argv, packed in (
            ("6b", ["sweep", "--num-designs", "16", "--spawn-mode", "count",
                    "--spawn-iters", "0", "--rays-per-fov", "2048"], False),
            ("6c", ["sweep"], True)):
        sargs = cli.build_parser().parse_args(argv)
        designs, _ = cli.sweep_designs(sargs)
        cfg = cli.sweep_config(sargs)
        geoms = [generate_geometry(d, cfg.num_fov_x, cfg.num_fov_y)
                 for d in designs]
        eb = np.stack([x.eyebox_range for x in geoms])
        cases.append((name, geoms, eb, lambda geoms=geoms, eb=eb: (
            trace_rows.build_kernel_cell_params(
                build_cell_tables_synthetic_batch(geoms, seed=seed), eb,
                bins)), packed))
    modes = []
    rec = ctx["record"].setdefault("phase19", {})
    for name, geoms, eb, host_build, packed in cases:
        t0 = time.perf_counter()
        host = host_build()
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        inputs = cr.synthetic_row_inputs(geoms, seed=seed, pinned=True)
        inputs_s = time.perf_counter() - t0
        args = cr.upload_inputs(inputs, eb, dev)
        rows = cr.launch_rows(args, inputs, bins)
        torch.cuda.synchronize()
        ms = device_ms(lambda: cr.launch_rows(args, inputs, bins), 10)
        plain = cr.cell_rows_reference(inputs, eb, bins, dev)
        torch.cuda.synchronize()
        plain_ms = cuda_ms(
            lambda: cr.cell_rows_reference(inputs, eb, bins, dev), 1)
        same_plain = bool(torch.equal(rows.view(torch.int32),
                                      plain.view(torch.int32)))
        diff = (rows - plain).abs()
        max_abs = float(torch.where(torch.isnan(diff), 0.0, diff).max())
        del plain, diff
        rows_h = rows.cpu().numpy()
        same_host = bool(np.array_equal(rows_h.view(np.int32),
                                        host.view(np.int32)))
        max_abs = max(max_abs, float(np.nanmax(np.abs(rows_h - host))))
        n = rows.shape[0]
        nbytes = rows.numel() * 4 + sum(a.numel() * a.element_size()
                                        for a in args)
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        # the FP64 lanes' instructions, or all of them at the issue rate
        items = len(inputs.table) * n
        t_ops = max(items * ROWS_ITEM_FP64 / PEAK_FP64_LANES,
                    (items * ROWS_ITEM_LANES + n * ROWS_ROW_LANES)
                    / PEAK_FP32_ADDS) * 1e3
        launch = cr.rows_shape(n)
        launch["grid_equal"] = launch["grid"] == cr.rows_grid(
            n, launch["blocks_per_sm"] * launch["sms"])
        launch["spill_bytes"] = named_spills(
            build.build_info.get("cell_rows", {}).get("log", ""),
            "cell_rows_kernel")
        entry = {"name": name, "designs": inputs.D, "cells": n,
                 "rows_bytes": rows.numel() * 4, "input_bytes":
                 nbytes - rows.numel() * 4, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "max_abs_err": max_abs, "identical_plain": same_plain,
                 "identical_host": same_host, "host_pipeline_s": host_s,
                 "host_inputs_s": inputs_s, "launch": launch,
                 "achieved_gb_s": nbytes / (ms * 1e-3) / 1e9}
        words = ""
        if packed:
            nf, no = inputs.num_fc, inputs.num_oc
            got = trace_rows.pack_selection_params(rows, nf, no).cpu().numpy()
            entry["identical_packed"] = bool(np.array_equal(
                got, trace_rows.pack_selection_params(host, nf, no)))
            words = (f"; packed words {got.shape} "
                     f"{'identical' if entry['identical_packed'] else 'DIFFER'}")
        rec[name] = entry
        modes.append(entry)
        save_record(ctx)
        spills = ("(not rebuilt)" if launch["spill_bytes"] is None
                  else launch["spill_bytes"])
        print(f"phase 19 {name}: {inputs.D} design(s), {n:,} cell rows "
              f"({rows.numel() * 4 / 1e6:.1f} MB, inputs "
              f"{entry['input_bytes'] / 1e6:.1f} MB): kernel {ms:.4f} ms "
              f"({entry['achieved_gb_s']:.0f} GB/s), plain {plain_ms:.3f} "
              f"ms, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
              f"operations {t_ops:.4f} ms); launch: grid {launch['grid']} "
              f"of {launch['threads']} threads, tiles of {launch['tile']} "
              f"rows in {launch['buffers']} buffers ({launch['smem']:,} B "
              f"shared), {launch['blocks_per_sm']} block(s) per SM, "
              f"{launch['registers']} registers, {launch['local_bytes']} B "
              f"local, spills {spills} B, grid = Python rule "
              f"{launch['grid_equal']}; host inputs {inputs_s:.3f} s, host "
              f"pipeline {host_s:.3f} s; kernel = plain "
              f"{same_plain}, kernel = host {same_host}, max |diff| "
              f"{max_abs}{words}")
        if (launch["spill_bytes"] or launch["local_bytes"]
                or not launch["grid_equal"]):
            fail(f"phase 19 {name}: the rows' kernel spills or its grid is "
                 f"not the Python rule's: {launch}")
        if not (same_plain and same_host and entry.get("identical_packed",
                                                       True)):
            fail(f"phase 19 {name}: the rows' kernel disagrees (plain "
                 f"{same_plain}, host {same_host}, packed "
                 f"{entry.get('identical_packed')}, max |diff| {max_abs})")
        del rows, rows_h, host, args, inputs
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")
    ctx["rows_modes"] = modes


# lane instructions of the colorimetry per (pixel, position), at the
# card's issue rate (PEAK_FP32_ADDS): csrc/eye_tail.cu's 159 operations
# (scaling 6, the XYZ product 15, Y's sums and tests 4, Lab 22, CIEDE2000
# 111, its sum 1), each of its 38 library calls (13 IEEE divisions, 5
# powf, 5 sqrtf, 4 hypotf, 4 cosf, 2 each of atan2f, fmodf and sinf, an
# expf) at its fast path's lane instructions from the SASS (division 10,
# powf 66, sqrtf 7, hypotf 25, cosf 26, sinf 25, atan2f 10, fmodf 10, expf
# 7) and every other operation at one; the eye views' 40 (the RGB product,
# clamp, gamma and peak 36, the normalisation 4) with their 3 powf and 3
# divisions so (tools/colorimetry_phases.py with tools/sass_paths.py;
# NVIDIA H100 80GB HBM3, CUDA 12.8).  A fast path is the shortest through
# the call's code, so the count is a floor
COLOR_OPS = 917
IMAGE_OPS = 262
# phase 20's histogram: the reference workload's (L, FoVy, FoVx, eby, ebx)
TAIL_HISTOGRAM = (3, 75, 100, 80, 120)


def window_spills(shape: dict, scaled: bool):
    """Spill bytes of the window sum's instantiation for ``shape``'s form
    in this run's build (None when the library was built earlier)."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build,
    )

    log = build.build_info.get("eye_tail", {}).get("log", "")
    return ptxas_spills(log).get(f"[{shape['form']},{int(scaled)}]")


def _perception_case(name: str, h, mask, stride, reps: int,
                     scale=None) -> dict:
    """The perception kernel against its plain version on ``h`` at
    ``stride`` (each image scaled by ``scale`` when given): bit for bit,
    times, the kernel's launch shape (its plan against the Python rule),
    bound and ``F.conv2d``'s time (the library call, unscaled only; its
    first call timed apart when it is the process's first)."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        eye_tail, metrics,
    )

    out = metrics.pupil_window_sum(h, mask, stride, scale)
    torch.cuda.synchronize()
    launch = dict(eye_tail.last_launch)
    launch["spill_bytes"] = window_spills(launch, scale is not None)
    plan = eye_tail.window_sum_plan(*h.shape[-2:], *np.shape(mask), *stride,
                                    smem_limit=launch["smem_limit"])
    launch["plan_equal"] = all(plan[k] == launch[k] for k in plan
                               if k in launch)
    plain = metrics.eye_perceived_reference(h, mask, stride, scale)
    torch.cuda.synchronize()
    same = bool(torch.equal(out.view(torch.int32), plain.view(torch.int32)))
    max_abs = float((out - plain).abs().max())
    del plain
    ms = device_ms(lambda: metrics.pupil_window_sum(h, mask, stride, scale),
                   reps)
    plain_ms = device_ms(lambda: metrics.eye_perceived_reference(
        h, mask, stride, scale), 1)
    e = {"name": name, "stride": list(stride), "shape": list(out.shape),
         "scaled": scale is not None, "identical_plain": same,
         "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
         "launch": launch, "library_ms": None}
    if scale is None:
        kernel = torch.as_tensor(mask, dtype=torch.float32, device=h.device)
        t0 = time.perf_counter()
        conv = metrics.pupil_conv(h, kernel, stride)
        torch.cuda.synchronize()
        e["library_first_ms"] = (time.perf_counter() - t0) * 1e3
        # cuDNN's algorithms leave rounding noise where a window is empty,
        # so its gap is taken against the largest window sum
        e["library_max_rel"] = float((conv - out).abs().max()
                                     / out.abs().max())
        del conv
        e["library_ms"] = device_ms(
            lambda: metrics.pupil_conv(h, kernel, stride), reps)
    # images read once (a strided view: the rows of ebx bins it holds) and
    # windows written once; an add is one lane instruction
    n_images = out.numel() // (out.shape[-2] * out.shape[-1])
    nbytes = (n_images * h.shape[-2] * h.shape[-1] + out.numel()) * 4
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = out.numel() * float(np.sum(mask)) / PEAK_FP32_ADDS * 1e3
    e.update(bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             achieved_gb_s=nbytes / (ms * 1e-3) / 1e9)
    return e


def _colorimetry_case(name: str, stack, inv_norm: float,
                      with_image: bool, reps: int, host=None) -> dict:
    """The colorimetry kernel against its plain version (``_make_eval_core``
    on the card) on a (D, 3, fy, fx, epy, epx) stack: metrics within 1e-5
    relative, the image within rtol 1e-5 / atol 1e-6, ``u_eb``'s zeros and
    the starved counts equal; with ``host`` (the float64 host colorimetry
    of design 0) also :func:`tail_check`'s bars against it.  Times and
    bound."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        eye_tail, metrics,
    )

    core = metrics._make_eval_core(with_image)
    got = metrics.colorimetry_stack(stack, inv_norm, with_image)
    torch.cuda.synchronize()
    want = core(stack, inv_norm)
    torch.cuda.synchronize()
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    rel = {}
    for k in ("delta_e", "ratio_sum", "u_eb"):
        rel[k] = float((np.abs(got[k] - want[k])
                        / np.maximum(np.abs(want[k]), 1e-30)).max())
    zeros_equal = bool(np.array_equal(got["u_eb"] == 0, want["u_eb"] == 0))
    starved = [int((got["u_eb"] == 0).sum()), int((want["u_eb"] == 0).sum())]
    max_abs = max(float(np.abs(got[k] - want[k]).max()) for k in got)
    img_ok = True
    if with_image:
        img_ok = bool(np.allclose(got["image"], want["image"], rtol=1e-5,
                                  atol=1e-6))
    entry = {"name": name, "shape": list(stack.shape), "image": with_image,
             "metrics_rel": rel, "image_within_bar": img_ok,
             "u_eb_zeros_equal": zeros_equal, "starved": starved,
             "max_abs_err": max_abs}
    if host is not None:
        n_epy, n_epx = stack.shape[4], stack.shape[5]
        met = metrics._eval_result_from_out(got, 0, n_epy, n_epx, with_image)
        entry["host_tail"] = tail_check(f"20 {name}", met, host)
    ms = device_ms(lambda: metrics.colorimetry_stack(stack, inv_norm,
                                                   with_image), reps)
    plain_ms = device_ms(lambda: core(stack, inv_norm), 1)
    D, _, fy, fx, epy, epx = stack.shape
    items = D * fy * fx * epy * epx
    nbytes = (stack.numel() + D * (2 + epy * epx)
              + (stack.numel() if with_image else 0)) * 4
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = (items * (COLOR_OPS + (IMAGE_OPS if with_image else 0))
             / PEAK_FP32_ADDS * 1e3)
    plan = eye_tail.colorimetry_plan(D, epy * epx, fy * fx)
    log = build.build_info.get("eye_tail", {}).get("log", "")
    launch = dict(eye_tail.colorimetry_shape(), splits=plan["S"],
                  chunk=plan["chunk"], grid=list(plan["grid"]),
                  units_spill_bytes=named_spills(log, "colorimetry_units"),
                  image_spill_bytes=named_spills(log, "colorimetry_image"))
    entry.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 launch=launch)
    spills = ("(not rebuilt)" if launch["units_spill_bytes"] is None else
              f"{launch['units_spill_bytes']} / "
              f"{launch['image_spill_bytes']}")
    print(f"phase 20 colorimetry {name}: stack {tuple(stack.shape)}"
          f"{' with the image' if with_image else ''}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}; bytes {t_bytes:.4f} ms); launch: "
          f"{plan['S']} splits of {plan['chunk']} pixels, units grid "
          f"{tuple(plan['grid'])} of 256 threads, "
          f"{launch['units_blocks_per_sm']} block(s) per SM, "
          f"{launch['units_registers']} registers, "
          f"{launch['units_local_bytes']} B local (the image pass "
          f"{launch['image_registers']} registers), spills {spills} B; "
          f"against the plain version: "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + f" relative, image {'within' if img_ok else 'BEYOND'} rtol 1e-5 "
          f"/ atol 1e-6, u_eb zeros equal {zeros_equal}, starved {starved}")
    if launch["units_spill_bytes"] or launch["image_spill_bytes"]:
        fail(f"phase 20 colorimetry {name}: the kernels spill: {launch}")
    if (max(rel.values()) > 1e-5 or not img_ok or not zeros_equal
            or starved[0] != starved[1]):
        fail(f"phase 20 colorimetry {name}: the kernel disagrees with its "
             f"plain version: {entry}")
    return entry


def phase20(ctx) -> None:
    """The tail's kernels against their plain versions, with the library
    call's time beside the perception's."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        eye_tail, metrics,
    )

    dev = ctx["dev"]
    rec = ctx["record"].setdefault("phase20", {})
    gen = torch.Generator(device=dev).manual_seed(20)
    # the reference workload's histogram shape, 20 % empty bins and a
    # starved FoV corner (eye position (0, 0) of FoV (0, 0) sees nothing)
    h = torch.rand(TAIL_HISTOGRAM, generator=gen, device=dev)
    h = torch.where(h < 0.2, 0.0, h)
    h[:, 0, 0, :40, :40] = 0.0
    mask = metrics.pupil_mask(30)
    perc_modes = []
    for stride, reps in (((8, 12), 20), ((1, 1), 3)):
        perc_modes.append(_perception_case(f"stride_{stride[0]}_{stride[1]}",
                                           h, mask, stride, reps))
    # the sweep's per-design launch (6a's cells): the 22,500 tiles of 128
    # lanes cut to 120, each scaled by its cell's Wald factor
    tiles = torch.zeros((h.numel() // (80 * 120), 80, 128), device=dev)
    tiles[:, :, :120] = h.reshape(-1, 80, 120)
    factor = 0.5 + torch.rand(tiles.shape[0], device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(21))
    perc_modes.append(_perception_case("sweep_6a_tiles", tiles[:, :, :120],
                                       mask, (8, 12), 20, factor))
    del tiles, factor
    for e in perc_modes:
        ln = e["launch"]
        form = eye_tail.FORMS[ln["form"]]
        spills = ("(not rebuilt)" if ln["spill_bytes"] is None
                  else ln["spill_bytes"])
        print(f"phase 20 perception {e['name']} at stride "
              f"{tuple(e['stride'])}{', scaled' if e['scaled'] else ''}: "
              f"{tuple(e['shape'])}: kernel {e['ms']:.4f} ms "
              f"({e['achieved_gb_s']:.0f} GB/s), plain {e['plain_ms']:.3f} ms"
              + (f", F.conv2d {e['library_ms']:.4f} ms loaded "
                 f"({e['library_first_ms']:.1f} ms its first call here, "
                 f"within {e['library_max_rel']:.3g} of the largest sum)"
                 if e["library_ms"] is not None else "")
              + f", bound {e['bound_ms']:.4f} ms ({e['bound_by']}); kernel "
              f"= plain {e['identical_plain']}, max |diff| "
              f"{e['max_abs_err']}; launch: {form}, {ln['k']} window(s) a "
              f"thread, {ln['stages']} stages of {ln['band_rows']} window "
              f"rows ({ln['bands']} a image), "
              f"{ln['active']} of {ln['consumers']} consumers summing "
              f"+ {eye_tail.PRODUCER} threads, "
              f"{ln['blocks_per_sm']} block(s) per SM, grid {ln['grid']}, "
              f"{ln['smem']:,} B shared, {ln['registers']} registers, "
              f"{ln['local_bytes']} B local, spills {spills} B, "
              f"{'bulk copies' if ln['bulk'] else 'loads'}; plan = Python "
              f"rule {ln['plan_equal']}")
        if not e["identical_plain"]:
            fail(f"phase 20: the perception kernel differs from its plain "
                 f"version ({e['name']})")
        if not ln["plan_equal"] or ln["spill_bytes"] or ln["local_bytes"]:
            fail(f"phase 20: the perception kernel's launch {ln}")
    rec["perception"] = perc_modes
    inv_norm = metrics._inv_norm(20000.0)
    perc = metrics.eye_perceived_torch(h)
    dense = metrics.eye_perceived_conv(h, stride=(1, 1))
    del h
    host = metrics.evaluate(None, perceive=perc.cpu().numpy().astype(
        "float64") * inv_norm)
    color_modes = [_colorimetry_case("simulate", perc[None], inv_norm,
                                     True, 20, host)]
    # an 8-design sweep stack: each design's cells scaled apart, design 5's
    # FoV (3, 7) empty at every eye position
    stack = perc[None] * torch.rand((8,) + TAIL_HISTOGRAM[:3] + (1, 1),
                                    generator=gen, device=dev)
    stack[5, :, 3, 7] = 0.0
    color_modes.append(_colorimetry_case("sweep", stack.contiguous(),
                                         inv_norm, False, 20))
    del stack
    color_modes.append(_colorimetry_case("dense", dense[None],
                                         inv_norm, False, 3))
    del dense
    rec["colorimetry"] = color_modes
    save_record(ctx)
    ctx["tail_modes"] = {"eye_perceive": perc_modes,
                         "colorimetry": color_modes}
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")


# bytes of one slot that a step of csrc/split_cells.cu must move: its 11
# fields read (44 B) and written once, as the child that it was (44 B).  A
# cell's interaction records are staged in shared memory once per block and
# counted once per cell (split_bytes), not per slot
SPLIT_SLOT_BYTES = 88
# float32 operations of one slot's step, counted from csrc/split_cells.cu
# with each comparison, division and square root one operation (the exact
# half-plane tests where the region grid leaves a position open are left
# out, so the bound is a floor): the grid lookup 6, the site and its strips
# 16, three Jones products 84, the efficiencies 20, the deposit 16, two
# children 52, the survivor 6
SPLIT_SLOT_OPS = 200


def split_bytes(a, work: int) -> int:
    """The bytes that the chunk ``a`` must move through HBM for ``work``
    stepped slots: each slot's fields read and written once, each cell's
    records, constants, direction rows and tile once, the seeds, the
    geometry and the refined region grid once, and the per-cell ledgers."""
    ny, nx = a.eyebox_bins
    once = sum(t.numel() * t.element_size()
               for t in (a.rec, a.cell, a.dirs, a.seeds, a.geom, a.fine,
                         a.sub_codes))
    # tile, trunc, pruned, peak, steps (4 B each) and work (8 B) per cell
    return work * SPLIT_SLOT_BYTES + once + a.C * (ny * nx * 4 + 24)


def split_bits_differ(x, y) -> dict:
    """The entries of each field of two :class:`SplitCellsOut` that differ
    in their bits."""
    import torch

    out = {}
    for f in ("tiles", "trunc", "pruned", "peak", "steps", "work"):
        u, v = getattr(x, f).contiguous(), getattr(y, f).contiguous()
        if u.dtype == torch.float32:
            u, v = u.view(torch.int32), v.view(torch.int32)
        out[f] = int((u != v).sum())
    return out


def split_compare(out, ref) -> dict:
    """The kernel's chunk ``out`` against the plain version's ``ref`` (both
    :class:`SplitCellsOut`, on one device): the phase-21 bars."""
    import torch

    k, p = out.tiles.double(), ref.tiles.double()
    diff = (k - p).abs()
    beyond = diff > 1e-12 + 1e-6 * p.abs()
    rel = torch.where(p != 0, diff / p.abs().clamp_min(1e-300), diff)

    def rel_err(a, b):
        a, b = a.double(), b.double()
        return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())

    tr_k, tr_p = out.trunc.double(), ref.trunc.double()
    ow_k, ow_p = k.sum(dim=(1, 2)), p.sum(dim=(1, 2))
    e = {"steps_equal": bool(torch.equal(out.steps.long(), ref.steps.long())),
         "peak_equal": bool(torch.equal(out.peak.long(), ref.peak.long())),
         "work_equal": bool(torch.equal(out.work.long(), ref.work.long())),
         "trunc_zero_equal": bool(torch.equal(tr_k == 0, tr_p == 0)),
         "trunc_rel": rel_err(tr_k, tr_p), "pruned_rel": rel_err(
             out.pruned, ref.pruned), "out_w_rel": rel_err(ow_k, ow_p),
         "tiles_beyond": int(beyond.sum()),
         "zeros_equal": bool(torch.equal(k == 0, p == 0)),
         "tiles_max_rel": float(rel.max()), "max_abs_err": float(diff.max()),
         "bits_differ": int((out.tiles.view(torch.int32)
                             != ref.tiles.view(torch.int32)).sum())}
    e["ok"] = bool(e["steps_equal"] and e["peak_equal"] and e["work_equal"]
                   and e["trunc_zero_equal"] and e["trunc_rel"] <= 1e-6
                   and e["pruned_rel"] <= 1e-6 and e["out_w_rel"] <= 1e-6
                   and e["tiles_beyond"] == 0 and e["zeros_equal"])
    return e


def _split_case(name: str, trace, cells, seeds, reps: int,
                against_cpu: bool = False) -> dict:
    """One phase-21 chunk: the kernel against its plain version on the card
    (and, with ``against_cpu``, on the CPU), the times and the bound from
    the kernel's own widths."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        splitting,
    )

    a = trace.args(cells, seeds)
    out = splitting.launch_split_cells(a)
    torch.cuda.synchronize()
    launch = dict(splitting.last_launch["split_cells"],
                  spill_bytes=split_spills(
                      splitting.last_launch["split_cells"]["cluster"]))
    ms = cuda_ms(lambda: splitting.launch_split_cells(a), reps)
    t0 = time.perf_counter()
    ref = splitting.split_cells_reference(a)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    e = {"name": name, "cells": a.C, "points": a.P, "capacity": a.capacity,
         "threshold": a.weight_threshold,
         "per_cell_seeds": a.seeds.dim() == 3, "ms": ms,
         "plain_ms": plain_ms, "launch": launch, **split_compare(out, ref)}
    if name == "readme_4_shared":
        # the cells' outputs at every cluster size, bit for bit
        e["clusters_equal"] = {
            q: not any(split_bits_differ(
                splitting.launch_split_cells(a, cluster=q), out).values())
            for q in splitting.CLUSTER_SIZES}
    work = int(out.work.sum())
    nbytes = split_bytes(a, work)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = work * SPLIT_SLOT_OPS / PEAK_FP32_OPS * 1e3
    e.update(work=work, bytes=nbytes, steps=int(out.steps.max()),
             peak=int(out.peak.max()), trunc=float(out.trunc.sum()),
             pruned=float(out.pruned.sum()),
             out_w=float(out.tiles.sum(dtype=torch.float64)),
             bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    if against_cpu:
        t0 = time.perf_counter()
        cpu = splitting.split_cells_reference(a.to("cpu"))
        e["cpu_plain_s"] = time.perf_counter() - t0
        got = splitting.SplitCellsOut(**{
            f: getattr(out, f).cpu()
            for f in ("tiles", "trunc", "pruned", "peak", "steps", "work")})
        c = split_compare(got, cpu)
        e["cpu"] = c
        e["cpu_bitwise"] = c["bits_differ"] == 0
    return e


def split_cases(dev):
    """Phase 21's chunks of the per-cell splitting engine, one at a time:
    ``(name, trace, cells, seeds, reps, against_cpu)``.  The main path's
    256-cell chunk of ``simulate --engine splitting``, 4 cells with shared
    and per-cell seeds (and at 64 slots, truncating), a 128-cell chunk of
    ``ExactTailHybrid``'s defaults and the 512-cell chunk that ``simulate
    --tail-exact`` launches (``cli._tail_hybrid``)."""
    import dataclasses as dc

    import numpy as np
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        hybrid, pipeline, splitting,
    )

    readme = TraceConfig(num_fov_x=16, num_fov_y=12, rays_per_fov=2)
    cells4 = np.array([0, 191, 300, 575])
    for shared in (True, False):
        cfg = dc.replace(readme, shared_pupil_samples=shared)
        sim = pipeline.Simulator(cfg=cfg, device=dev, engine="splitting")
        kw = dict(weight_threshold=1e-6, max_steps=1024, device=dev,
                  per_cell_seeds=not shared)
        trace = splitting.make_splitting_cells_fn(
            sim.tables, sim.tgeom, cfg, capacity=8192, **kw)
        if shared:
            # the main path's chunk: 256 cells of simulate --engine splitting
            cells = np.arange(256)
            yield ("readme_256", trace, cells, sim._split_seeds(cells, 2, 0),
                   3, False)
            small = splitting.make_splitting_cells_fn(
                sim.tables, sim.tgeom, cfg, capacity=64, **kw)
            yield ("readme_4_k64", small, cells4,
                   sim._split_seeds(cells4, 2, 0), 5, False)
        yield ("readme_4_" + ("shared" if shared else "per_cell"), trace,
               cells4, sim._split_seeds(cells4, 2, 0), 5, True)
        del sim, trace
    # --tail-exact's engine: ExactTailHybrid's defaults (32,768 slots, a
    # pass of 4 pupil points, each launched TE and TM: 8 launch seeds, a
    # chunk of 128 cells), then the CLI's (8,192 slots, one point a pass: 2
    # launch seeds, a chunk of 512 cells), both at threshold 1e-6 over the
    # 100 x 75 grid
    sim = pipeline.Simulator(cfg=TraceConfig(), device=dev,
                             engine="splitting")
    grid = sim.L * sim.M * sim.N
    hy = hybrid.ExactTailHybrid(sim)
    cells = np.linspace(0, grid - 1, hy._cpb).astype(np.int64)
    yield ("tail_exact_128", hy._trace, cells, hy._seeds(4, 1_000_003), 2,
           False)
    hy = hybrid.ExactTailHybrid(sim, points_per_pass=1, capacity=8192,
                                max_steps=1024)
    cells = np.linspace(0, grid - 1, hy._cpb).astype(np.int64)
    yield ("tail_exact_cli_512", hy._trace, cells, hy._seeds(1, 1_000_003),
           2, False)
    del sim, hy


def split_spills(cluster: int):
    """Spill bytes of ``split_cells_kernel<cluster>`` in this run's build
    (None when the library was built earlier)."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build,
    )

    log = build.build_info.get("split_cells", {}).get("log", "")
    return ptxas_spills(log).get(f"[{cluster}]")


def phase21(ctx) -> None:
    """The per-cell splitting kernel against its plain version."""
    dev = ctx["dev"]
    rec = ctx["record"].setdefault("phase21", {})
    cases = [_split_case(name, trace, cells, seeds, reps,
                         against_cpu=against_cpu)
             for name, trace, cells, seeds, reps, against_cpu
             in split_cases(dev)]
    faults = []
    for e in cases:
        rec[e["name"]] = e
        cpu = ""
        if "cpu" in e:
            cpu = (f"; against the plain version on the CPU: "
                   f"{e['cpu']['bits_differ']} tile entries differ in their "
                   f"bits ({e['cpu']['tiles_beyond']} beyond the bar), "
                   f"steps {e['cpu']['steps_equal']}, peak "
                   f"{e['cpu']['peak_equal']}, pruned "
                   f"{e['cpu']['pruned_rel']:.2e} apart (CPU plain "
                   f"{e['cpu_plain_s']:.2f} s)")
            if not e["cpu"]["ok"]:
                faults.append(f"{e['name']} against the CPU: {e['cpu']}")
        ln = e["launch"]
        print(f"phase 21 {e['name']}: {e['cells']} cells x {e['points']} "
              f"launch seeds, K {e['capacity']}: cluster {ln['cluster']} x "
              f"{ln['threads']} threads, {ln['blocks_per_sm']} blocks per SM "
              f"({ln['resident_blocks']} resident), {ln['smem']:,} B dynamic "
              f"shared, {ln['registers']} registers, {ln['local_bytes']} B "
              f"local, spills {ln['spill_bytes']} B; kernel {e['ms']:.3f} ms, "
              f"plain {e['plain_ms']:.1f} ms, bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}; {e['work']:,} slot-steps = the sum of the "
              f"widths, {e['bytes']:,} B); steps {e['steps']}, peak {e['peak']}, truncated "
              f"{e['trunc']:.6g}, pruned {e['pruned']:.6g}, out-coupled "
              f"{e['out_w']:.8g}; against the plain version on the card: "
              f"steps {e['steps_equal']}, peak {e['peak_equal']}, widths "
              f"{e['work_equal']}, truncated {e['trunc_rel']:.2e}, pruned "
              f"{e['pruned_rel']:.2e}, out-coupled {e['out_w_rel']:.2e} "
              f"apart, tiles {e['tiles_beyond']} beyond rtol 1e-6 / atol "
              f"1e-12 (max rel {e['tiles_max_rel']:.2e}, {e['bits_differ']} "
              f"differ in their bits), zeros equal {e['zeros_equal']}{cpu}")
        if not e["ok"] or e["bits_differ"]:
            faults.append(f"{e['name']}: {e}")
        if ln["spill_bytes"] or ln["local_bytes"]:
            faults.append(f"{e['name']}: {ln['local_bytes']} B local, ptxas "
                          f"reports {ln['spill_bytes']} B of spills")
        if ln["cluster"] == 1 and ln["blocks_per_sm"] < 2:
            faults.append(f"{e['name']}: {ln['blocks_per_sm']} block(s) "
                          "per SM")
        if "clusters_equal" in e:
            print(f"phase 21 {e['name']} at each cluster size, outputs "
                  f"equal bit for bit: {e['clusters_equal']}")
            if not all(e["clusters_equal"].values()):
                faults.append(f"{e['name']}: outputs differ between cluster "
                              f"sizes {e['clusters_equal']}")
        if "cpu" in e and not e["cpu_bitwise"]:
            faults.append(f"{e['name']}: the tiles differ from the CPU's")
    k64 = rec["readme_4_k64"]
    if not (k64["trunc"] > 0 and k64["peak"] > 64):
        faults.append(f"the 64-slot chunk did not truncate: {k64}")
    save_record(ctx)
    ctx["split_modes"] = cases
    if faults:
        fail("phase 21: " + "; ".join(faults))
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")


# float32 operations that every live bounce of csrc/vector_trace.cu does at
# least, counted from the kernel with each comparison, division, square root
# and floor one operation: the region grid's lookup 10, the record key with
# its strip bins and the out-coupler rectangle 24, a hop's phasor and step
# 8 (an interacting bounce does about 140: its two Jones products alone are
# 56); and the in-coupling of a full-mode ray, about 100.  The exact
# half-plane tests where the grid leaves a position open are left out, so
# the bound is a floor
VEC_BOUNCE_OPS = 42
VEC_INIT_OPS = 100


def vector_launches(batch_steps, segment_bounces) -> int:
    """The ``vector_trace`` launches of batches that took ``batch_steps``
    steps each: one a batch, or with segments (``trace_compacted``) one per
    segment begun, at least one."""
    if segment_bounces is None:
        return len(batch_steps)
    return sum(max(1, -(-s // segment_bounces)) for s in batch_steps)


def vector_bytes(a, out) -> int:
    """The bytes that the trace call ``a`` must move through HBM: every ray
    field read once (68 B a ray) and every output field written once (52 B),
    the bounces and steps, the tables of the (design, cell) pairs its rays
    touch, and the geometry rows and region grids once."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_vector as tv,
    )

    def size(t):
        return t.numel() * t.element_size()

    ins = sum(size(a.rays[k]) for k in tv.RAY_KEYS)
    outs = (sum(size(out.rays[k]) for k in tv.RAY_KEYS[:-2])
            + size(out.bounces) + size(out.steps))
    D = a.geom.shape[0]
    C = a.cell.shape[1] // D
    g = a.rays["cid"] + C * torch.arange(D, device=a.cell.device)[:, None]
    touched = int(torch.unique(g).numel())
    R2 = 2 * (1 + a.num_fc + a.num_oc)
    tables = touched * (a.rec.shape[0] * R2 + a.cell.shape[0]
                        + a.dirs.shape[0] * 4) * a.rec.element_size()
    return ins + outs + tables + size(a.geom) + size(a.grid)


def vector_compare(out, ref) -> dict:
    """The kernel's call ``out`` against the plain version's ``ref`` (both
    :class:`VectorTraceOut`, on one device): every field, the bounces and
    the steps, bit for bit."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_vector as tv,
    )

    differ, err = {}, 0.0
    for k in tv.RAY_KEYS:
        a, b = out.rays[k], ref.rays[k]
        if a.dtype != b.dtype:
            differ[k] = -1
            continue
        if a.is_floating_point():
            differ[k] = int((a.view(torch.int32)
                             != b.view(torch.int32)).sum())
            if a.numel():
                err = max(err, float((a - b).abs().max()))
        else:
            differ[k] = int((a != b).sum())
    e = {"fields_differ": {k: v for k, v in differ.items() if v},
         "bounces_equal": bool(torch.equal(out.bounces, ref.bounces)),
         "steps": int(out.steps), "steps_equal":
             int(out.steps) == int(ref.steps), "max_abs_err": err}
    e["ok"] = bool(not e["fields_differ"] and e["bounces_equal"]
                   and e["steps_equal"])
    return e


def _vector_case(name: str, a, reps: int) -> tuple:
    """One phase-22 call: the kernel against its plain version on the card,
    the kernel's CUDA-event time (``device_ms``: queued behind 0.1 s of
    device spin, so a card idle through the call's host setup has its
    clocks up), the plain version's (host clock, once) and the bound from
    this call's rays and bounces; returns (the record, the kernel's
    output)."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_vector as tv,
    )

    out = tv.launch_vector_trace(a)
    torch.cuda.synchronize()
    ms = device_ms(lambda: tv.launch_vector_trace(a), reps)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = tv.vector_trace_reference(a)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    D, R = a.rays["x"].shape
    bounces = int(out.bounces.sum())
    nbytes = vector_bytes(a, out)
    ops = bounces * VEC_BOUNCE_OPS + (D * R * VEC_INIT_OPS
                                      if a.mode == "full" else 0)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_OPS * 1e3
    e = {"name": name, "designs": D, "rays": D * R, "mode": a.mode,
         "max_bounces": a.max_bounces, "circle": a.circle, "ms": ms,
         "plain_ms": plain_ms,
         "plain_peak_bytes": torch.cuda.max_memory_allocated(),
         "bounces": bounces, "bounces_per_design": out.bounces.tolist(),
         "deposits": int((out.rays["dep"] >= 0).sum()), "bytes": nbytes,
         "ops": ops, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "library_ms": None, **vector_compare(out, ref)}
    return e, out


def vector_cases(dev):
    """Phase 22's trace calls, one at a time: yields ``(name,
    VectorTraceArgs, reps)``.  (a) a 2,048-cell batch of phase 12's case
    (simulate --engine vector); (b) the same rays in full mode with a
    24-step budget, then in resume mode with the rest (the resume call
    continues the kernel's own 24-step output); (c) the CLI's default
    sweep, 8 designs at its widths, as run_design_sweep packs them (one
    shared seed batch per in-coupler); (d) the other in-coupler test (the
    default is the circle): the polygon's half-planes, 512 cells of phase
    12's case."""
    import dataclasses as dc

    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
        generate_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline, trace_vector as tv,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
        build_trace_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts import (
        make_synthetic_luts,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.packing import (
        build_cell_tables,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
        design_sweep,
    )

    def args_of(tracer, cfg, rays, mode, budget):
        return tv.vector_trace_args(
            rays, tracer.tables(), tracer.geometry(), mode=mode,
            max_bounces=budget, num_fc=tracer.num_fc, num_oc=tracer.num_oc,
            eyebox_bins=cfg.eyebox_bins, circle=cfg.ic_test == "circle")

    cfg = TraceConfig()
    sim = pipeline.Simulator(cfg=cfg, device=dev, engine="vector")
    rays = sim._vector_rays(np.arange(2048), cfg.rays_per_fov, 0)
    yield "batch_2048", args_of(sim.tracer, cfg, rays, "full",
                                cfg.max_bounces), 3
    a24 = args_of(sim.tracer, cfg, rays, "full", 24)
    yield "batch_2048_full_24", a24, 3
    first = tv.launch_vector_trace(a24).rays
    yield "batch_2048_resume_rest", args_of(
        sim.tracer, cfg, first, "resume", cfg.max_bounces - 24), 3
    del sim, rays, a24, first
    torch.cuda.empty_cache()
    sargs = cli.build_parser().parse_args(["sweep", "--engine", "vector"])
    designs, _ = cli.sweep_designs(sargs)
    cfg6 = cli.sweep_config(sargs)
    tables, tgeoms, states = [], [], []
    for d in designs:
        geom = generate_geometry(d, cfg6.num_fov_x, cfg6.num_fov_y)
        tables.append(build_cell_tables(geom, make_synthetic_luts(
            geom, seed=1234)))
        tgeoms.append(build_trace_geometry(geom, simplify_tol=1e-3))
        states.append(design_sweep._ray_state(geom, cfg6, dev))
    tracer = tv.VectorTracer(tables, tgeoms, cfg6, device=dev)
    rays = tv.stack_ray_states(states)
    del states
    yield "sweep_8", args_of(tracer, cfg6, rays, "full",
                             cfg6.max_bounces), 2
    del tracer, rays
    torch.cuda.empty_cache()
    cfgc = dc.replace(TraceConfig(), ic_test="polygon")
    sim = pipeline.Simulator(cfg=cfgc, device=dev, engine="vector")
    rays = sim._vector_rays(np.arange(0, 22500, 44)[:512], cfgc.rays_per_fov,
                            0)
    yield "polygon_512", args_of(sim.tracer, cfgc, rays, "full",
                                 cfgc.max_bounces), 3
    del sim, rays
    torch.cuda.empty_cache()


def vector_occupancy() -> dict:
    """The vector kernel's resident blocks per SM, registers, local bytes
    and threads a block, and its spills in this run's build (None when the
    library was built earlier)."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build, trace_vector as tv,
    )

    log = build.build_info.get("vector_trace", {}).get("log", "")
    return dict(tv.kernel_occupancy(),
                spill_bytes=ptxas_spills(log).get("[kernel]") if log
                else None)


def phase22(ctx) -> None:
    """The vector engine's kernel against its plain version."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_vector as tv,
    )

    dev = ctx["dev"]
    rec = ctx["record"].setdefault("phase22", {})
    faults, cases, outs = [], [], {}
    for name, a, reps in vector_cases(dev):
        e, out = _vector_case(name, a, reps)
        cases.append(e)
        if name.startswith("batch_2048"):
            outs[name] = out
        del a, out
        if name == "batch_2048_resume_rest":
            # the 24-step call and the resume call together equal the whole
            whole, first, rest = (outs.pop(k) for k in (
                "batch_2048", "batch_2048_full_24", name))
            split_ok = (all(torch.equal(rest.rays[k], whole.rays[k])
                            for k in tv.RAY_KEYS)
                        and torch.equal(first.bounces + rest.bounces,
                                        whole.bounces))
            e["full_24_then_resume_equals_whole"] = split_ok
            if not split_ok:
                faults.append("full 24 + resume differs from the whole trace")
            del whole, first, rest
            torch.cuda.empty_cache()
    occ = vector_occupancy()
    rec["occupancy"] = occ
    print(f"phase 22 occupancy vector_trace: {occ['blocks_per_sm']} blocks "
          f"of {occ['threads']} threads per SM, {occ['registers']} "
          f"registers, {occ['local_bytes']} B local, spills "
          f"{occ['spill_bytes'] if occ['spill_bytes'] is not None else '(not rebuilt)'} "
          f"B, at most {occ['max_rays_per_block']} rays a block")
    if occ["spill_bytes"]:
        faults.append(f"ptxas reports {occ['spill_bytes']} B of spills")
    for e in cases:
        rec[e["name"]] = e
        print(f"phase 22 {e['name']}: {e['designs']} design(s), "
              f"{e['rays']:,} rays, {e['mode']} mode, budget "
              f"{e['max_bounces']}, in-coupler "
              f"{'circle' if e['circle'] else 'polygon'}: "
              f"kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.1f} ms "
              f"(peak {e['plain_peak_bytes'] / 2**20:.0f} MiB), bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}; {e['bytes']:,} B, "
              f"{e['ops']:,} operations); steps {e['steps']}, bounces "
              f"{e['bounces']:,}, deposits {e['deposits']:,}; against the "
              f"plain version on the card: fields differing "
              f"{e['fields_differ'] or 'none'}, bounces "
              f"{e['bounces_equal']}, steps {e['steps_equal']}")
        if not e["ok"]:
            faults.append(f"{e['name']}: {e}")
    save_record(ctx)
    ctx["vector_modes"] = cases
    if faults:
        fail("phase 22: " + "; ".join(faults))
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")

# the bytes a stepped slot of the global engine must move, forward: its 12
# words read (11 fields and its cell) and its kept child's 13 written to
# the tape (a kept child is a slot of the next step, so each stepped slot
# is counted once for each); backward: its tape row read (13 words), its
# adjoint written and read once by its parent (10 words each way)
SPLIT_TRACE_BYTES = {"forward": 48 + 52, "backward": 52 + 40 + 40}
# float32 operations of a stepped slot, counted from csrc/split_trace.cu
# with each comparison, division and square root one operation (floors:
# the exact half-plane tests are left out): forward as SPLIT_SLOT_OPS and
# the soft deposit's 30; backward the step recomputed (about 130), the two
# children's and the deposit's adjoints (about 120), three Jones adjoints
# (156), the survivor and the deposit's position (about 40)
SPLIT_TRACE_OPS = {"forward": 230, "backward": 450}


def _trace_bound(a, work: int, kind: str) -> tuple:
    """The least time of one forward or backward call of the global
    engine's kernels on ``a`` over ``work`` stepped slots: the slots'
    bytes, the tables, geometry and rays read once, the histogram (or its
    adjoint) and the ledgers (or the table gradients) once, at 3.35 TB/s;
    or the operations at 67 TFLOP/s."""
    once = sum(t.numel() * t.element_size()
               for t in (a.rec, a.cell, a.dirs, a.geom, a.grid, a.rays,
                         a.cid))
    nbytes = (work * SPLIT_TRACE_BYTES[kind] + once
              + a.hist_size * 4 + (once if kind == "backward" else 8))
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = work * SPLIT_TRACE_OPS[kind] / PEAK_FP32_OPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def _trace_case(name: str, a, reps: int) -> tuple:
    """One phase-23 case: the forward kernel against its plain version on
    the card (histogram, steps and tape bit for bit, ledgers within 1e-6),
    the backward kernel against the plain backward on a seeded histogram
    adjoint (bit for bit; two runs identical); one kernel a call, its grid
    and barriers; times and bounds.  Returns (forward record, backward
    record)."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        splitting,
    )

    def rel(x, y):
        x, y = float(x), float(y)
        return abs(x - y) / max(abs(y), 1e-300)

    def nbits(x, y):
        return int((x.contiguous().view(torch.int32)
                    != y.contiguous().view(torch.int32)).sum())

    def launched(what: str, steps: int) -> dict:
        """The last call's kernels, grid and barriers (a step: the total
        over the steps that ran, the launch rays' phases included)."""
        info = splitting.last_launch[what]
        barriers = int(info["counters"][splitting._CNT_BARRIERS])
        return {"kernels": info["kernels"], "grid": info["grid"],
                "blocks_per_sm": info["blocks_per_sm"],
                "barriers": barriers,
                "barriers_a_step": barriers / max(steps, 1)}

    out = splitting.launch_split_trace(a, keep_tape=True)
    torch.cuda.synchronize()
    ran = int((out.tape.widths[:-1] > 0).sum())
    f_launch = launched("split_trace", ran)
    ms = cuda_ms(lambda: splitting.launch_split_trace(a, keep_tape=True),
                 reps)
    t0 = time.perf_counter()
    ref = splitting.split_trace_reference(a, keep_tape=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    wk, wr = out.tape.widths.long().cpu(), ref.tape.widths.long().cpu()
    widths_equal = bool(torch.equal(wk, wr))
    tape_bits = -1
    if widths_equal:
        tape_bits = sum(nbits(out.tape.fields[t, :, :int(wr[t])],
                              ref.tape.fields[t, :, :int(wr[t])])
                        for t in range(len(wr)))
    work = int(wr[:-1].sum())
    diff = (out.hist - ref.hist).abs()
    f = {"name": name, "kind": "forward", "launch_rays": a.rays.shape[1],
         "capacity": a.capacity, "soft_binning": a.soft_binning,
         "fixed_steps": a.fixed_steps, "steps": out.steps,
         "steps_equal": out.steps == ref.steps, "widths_equal": widths_equal,
         "tape_bits": tape_bits, "hist_bits": nbits(out.hist, ref.hist),
         "trunc": float(out.trunc), "pruned": float(out.pruned),
         "out_w": float(out.hist.sum(dtype=torch.float64)),
         "trunc_rel": rel(out.trunc, ref.trunc),
         "pruned_rel": rel(out.pruned, ref.pruned),
         "out_w_rel": rel(out.hist.sum(dtype=torch.float64),
                          ref.hist.sum(dtype=torch.float64)),
         "max_abs_err": float(diff.max()), "work": work, "ms": ms,
         "plain_ms": plain_ms, "library_ms": None, **f_launch}
    f["bound_ms"], f["bound_by"], f["bytes"] = _trace_bound(a, work,
                                                            "forward")
    f["ok"] = bool(f["kernels"] == 1 and f["steps_equal"] and widths_equal
                   and tape_bits == 0
                   and f["hist_bits"] == 0 and f["trunc_rel"] <= 1e-6
                   and f["pruned_rel"] <= 1e-6 and f["out_w_rel"] <= 1e-6)
    rng = np.random.default_rng(23)
    gh = torch.from_numpy(rng.standard_normal(a.hist_size).astype(
        np.float32)).to(a.rec.device)
    dk = splitting.launch_split_trace_backward(a, out.tape, gh)
    torch.cuda.synchronize()
    b_launch = launched("split_trace_backward", ran)
    dk2 = splitting.launch_split_trace_backward(a, out.tape, gh)
    torch.cuda.synchronize()
    bms = cuda_ms(lambda: splitting.launch_split_trace_backward(
        a, out.tape, gh), reps)
    t0 = time.perf_counter()
    dr = splitting.split_trace_backward_reference(a, ref.tape, gh)
    torch.cuda.synchronize()
    bplain_ms = (time.perf_counter() - t0) * 1e3
    b = {"name": name, "kind": "backward", "launch_rays": a.rays.shape[1],
         "capacity": a.capacity, "soft_binning": a.soft_binning,
         "steps": out.steps, "work": work,
         "bits": {k: nbits(x, y) for k, x, y in zip(("rec", "cell", "dirs"),
                                                    dk, dr)},
         "again_bits": sum(nbits(x, y) for x, y in zip(dk, dk2)),
         "max_grad": {k: float(y.abs().max()) for k, y in
                      zip(("rec", "cell", "dirs"), dr)},
         "max_abs_err": max(float((x - y).abs().max())
                            for x, y in zip(dk, dr)),
         "ms": bms, "plain_ms": bplain_ms, "library_ms": None, **b_launch}
    b["bound_ms"], b["bound_by"], b["bytes"] = _trace_bound(a, work,
                                                            "backward")
    b["ok"] = bool(b["kernels"] == 1 and not any(b["bits"].values())
                   and b["again_bits"] == 0
                   and max(b["max_grad"].values()) > 0)
    return f, b


def trace_cases(dev) -> list:
    """Phase 23's traces of the global engine, as (name, SplitTraceArgs,
    timed calls): ``optimize``'s README apodization and joint cases and
    its whole wavefront, with the tables ``optimize`` starts from, and
    phase 13d's stop-tested trace."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
        generate_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        seeding, splitting, trace_vector as tv,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
        build_trace_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts import (
        make_synthetic_luts,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.io import (
        load_or_synthesize,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.packing import (
        build_cell_tables,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.opt import (
        grating_opt as opt,
    )

    cases = []
    for name, (M, N), rays, kw in (
            ("readme_apodization", (16, 12), 16,
             dict(capacity=4096, fixed_steps=64, weight_threshold=1e-4)),
            ("readme_joint_soft", (24, 18), 8,
             dict(capacity=16384, fixed_steps=64, weight_threshold=1e-4,
                  soft_binning=True)),
            # phase 15's whole wavefront: wider than the co-resident grid
            ("readme_whole_wavefront", (16, 12), 2,
             dict(capacity=1 << 18, fixed_steps=64, weight_threshold=1e-4))):
        cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=rays,
                          max_bounces=2048)
        geom = generate_geometry(num_fov_x=M, num_fov_y=N)
        tables = build_cell_tables(geom, load_or_synthesize(geom))
        tgeom = build_trace_geometry(geom)
        rays0 = opt._launch_rays(geom, cfg, rays, None, dev)
        trace = splitting.make_splitting_trace_fn(
            tables, tgeom, cfg, table_arg=True, device=dev, **kw)
        cases.append((name, trace.args(rays0, tv.as_tables(tables)), 3))
    # phase 13d's global engine, stop-tested; listed third
    cfg = TraceConfig(num_fov_x=3, num_fov_y=2, rays_per_fov=4,
                      rng_mode="fast", seed=2)
    geom = generate_geometry(num_fov_x=3, num_fov_y=2)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    b = seeding.build_ray_batch(geom, cfg)
    rays0 = tv.make_ray_state(b["x"], b["y"], b["te"], b["tm"], b["cid"],
                              b["idx"], b["rng"], device=dev)
    trace = splitting.make_splitting_trace_fn(
        tables, build_trace_geometry(geom), cfg, capacity=1 << 15,
        weight_threshold=1e-5, max_steps=300, table_arg=True, device=dev)
    cases.insert(2, ("stop_test_18_cells",
                     trace.args(rays0, tv.as_tables(tables)), 5))
    return cases


def phase23(ctx) -> None:
    """The global splitting engine's kernels against their plain versions."""
    rec = ctx["record"].setdefault("phase23", {})
    cases = [_trace_case(name, a, reps)
             for name, a, reps in trace_cases(ctx["dev"])]
    faults = []
    for f, bw in cases:
        rec[f["name"]] = {"forward": f, "backward": bw}
        print(f"phase 23 {f['name']}: {f['launch_rays']:,} launch rays, K "
              f"{f['capacity']:,}, {f['steps']} steps ({f['work']:,} "
              f"slot-steps), {'soft' if f['soft_binning'] else 'hard'} "
              f"binning: forward {f['ms']:.3f} ms (plain "
              f"{f['plain_ms']:.1f} ms, bound {f['bound_ms']:.4f} ms, "
              f"{f['bound_by']}; {f['kernels']} kernel, grid {f['grid']} "
              f"({f['blocks_per_sm']} a SM), {f['barriers']} barriers, "
              f"{f['barriers_a_step']:.2f} a step); histogram "
              f"{f['hist_bits']} bins and tape "
              f"{f['tape_bits']} words differ in their bits, steps "
              f"{f['steps_equal']}, widths {f['widths_equal']}; truncated "
              f"{f['trunc']:.6g} ({f['trunc_rel']:.1e}), pruned "
              f"{f['pruned']:.6g} ({f['pruned_rel']:.1e}), out-coupled "
              f"{f['out_w']:.8g} ({f['out_w_rel']:.1e}); backward "
              f"{bw['ms']:.3f} ms (plain {bw['plain_ms']:.1f} ms, bound "
              f"{bw['bound_ms']:.4f} ms, {bw['bound_by']}; {bw['kernels']} "
              f"kernel, grid {bw['grid']} ({bw['blocks_per_sm']} a SM), "
              f"{bw['barriers']} barriers, {bw['barriers_a_step']:.2f} a "
              f"step): bits differing "
              f"{bw['bits']}, two runs {bw['again_bits']} apart, max |grad| "
              f"{bw['max_grad']}")
        if not f["ok"]:
            faults.append(f"{f['name']} forward: {f}")
        if not bw["ok"]:
            faults.append(f"{f['name']} backward: {bw}")
    if not cases[0][0]["trunc"] > 0:
        faults.append("the README apodization case did not truncate")
    save_record(ctx)
    ctx["trace_modes"] = [f for f, _ in cases]
    ctx["trace_backward_modes"] = [bw for _, bw in cases]
    if faults:
        fail("phase 23: " + "; ".join(faults))
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")



# in running order; "6c" follows the phases whose results it needs none of
PHASES = {"1": phase1, "2": phase2, "3": phase3, "3b": phase3b,
          "5": phase5, "6": phase6,
          "7": phase7, "8": phase8, "9": phase9, "10": phase10,
          "6c": phase6c, "19": phase19, "20": phase20, "21": phase21,
          "22": phase22, "23": phase23, "11": phase11, "12": phase12, "13": phase13,
          "14": phase14, "14g": phase14g, "14b": phase14b, "15": phase15, "16": phase16,
          "17": phase17, "18": phase18}


def kernel_line(ctx) -> dict:
    """The kernels' summary; a kernel's headline numbers are those of the
    main path's mode: gens spawn (phase 2's first mode), full mode with
    the whole budget, the rows of the reference workload (phase 19's
    first case), the sampled perception and the colorimetry with the
    image of ``simulate`` (phase 20's first cases), the splitting
    engine's 256-cell chunk (phase 21's first case), the vector engine's
    2,048-cell batch (phase 22's first case) and the global splitting
    engine's README apodization trace (phase 23's first case)."""
    k1, k2 = ctx["k1_modes"], ctx["k2_modes"]
    out = []
    for name, modes, head, launches in (
            ("persistent_trace", k1, k1[0],
             ctx["k1_main_launches"] + ctx["k1_count_main_launches"]
             + ctx["k1_seed_launches"] + ctx["k1_sweep_launches"]
             + ctx["k1_packed_main_launches"]
             + ctx["k1_packed_sweep_launches"] + ctx["k1_tail_launches"]
             + ctx["k1_hybrid_launches"] + ctx["k1_mesh_launches"]
             + ctx["k1_native_launches"]),
            ("cell_trace", k2, k2[2],
             ctx["k2_main_launches"] + ctx["k2_tail_launches"])):
        source, replaces = KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(m["max_abs_err"] for m in modes),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "modes": modes})
    for name, modes, launches in (
            ("cell_rows", ctx["rows_modes"], ctx["rows_launches"]),
            ("eye_perceive", ctx["tail_modes"]["eye_perceive"],
             ctx["tail_launches"]["eye_perceive"]),
            ("colorimetry", ctx["tail_modes"]["colorimetry"],
             ctx["tail_launches"]["colorimetry"]),
            ("split_cells", ctx["split_modes"], ctx["split_launches"]),
            ("vector_trace", ctx["vector_modes"], ctx["vector_launches"]),
            ("split_trace", ctx["trace_modes"], ctx["trace_launches"]),
            ("split_trace_backward", ctx["trace_backward_modes"],
             ctx["trace_backward_launches"])):
        # the headline: the main path's shape (the reference workload's rows,
        # simulate's sampled perception and its colorimetry with the image,
        # a 256-cell chunk of simulate --engine splitting, a 2,048-cell
        # batch of simulate --engine vector, optimize's README apodization
        # trace)
        head = modes[0]
        source, replaces = KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(m["max_abs_err"] for m in modes),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head.get("library_ms"), "modes": modes})
    return {"kernels": out}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=None, metavar="PATH",
                        help="write every measured number here as JSON")
    parser.add_argument("--profile", default=None, metavar="PATH",
                        help="profile one more full run; table to PATH")
    parser.add_argument("--phases", default=None, metavar="LIST",
                        help="comma-separated phases to run (default: all); "
                             "a partial run prints no result line")
    opts = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no GPU to run on")
    if not (ROOT / PORT / "__init__.py").is_file():
        fail(f"the port package {PORT}/ is not next to chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    wanted = list(PHASES)
    if opts.phases:
        asked = {"1"} | {p.strip() for p in opts.phases.split(",")}
        if not asked <= set(PHASES):
            fail(f"--phases takes {list(PHASES)}, got {opts.phases!r}")
        wanted = [p for p in PHASES if p in asked]
    ctx = {"dev": torch.device("cuda"), "record": {},
           "record_path": opts.record, "profile_path": opts.profile}
    for n in wanted:
        PHASES[n](ctx)
        torch.cuda.empty_cache()
    efficiency_bar(ctx)
    save_record(ctx)
    if wanted != list(PHASES):
        print(f"chip_smoke: phases {wanted} passed (a partial run: no "
              "result line)")
        return 0
    print(json.dumps(kernel_line(ctx)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
