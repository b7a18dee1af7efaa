"""On-card smoke run of emspec_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and nvcc; exits nonzero without
them.  Phases, in order, one line each; the first failure ends the run:

1. device: the card's name and power limit; build the CUDA kernels from
   ``emspec_torch/csrc`` and time the build.
2. native: the host ingest runtime (``emspec_torch.native``, C++ built at
   first use with g++): its build and wall; the C++ ring against the numpy
   ring on random push sequences at 1 and 16 channels, bit for bit, and
   each ring's host µs a push and a read; the ring's seqlock under a
   lapping producer (``tests/torch_ring_race.cpp``, two threads in C++,
   1 and 16 channels, planar and interleaved pushes: no torn window
   returned as valid); the numpy ring's seqlock under a lapping producer
   thread (``race`` of ``tests/test_torch_ring_race_numpy.py``, 1 and 16
   channels, pushes below and past the capacity: no torn window, every
   read no push overlapped valid); ``frame_extract`` against
   ``frame_signal_np``; the native WAV decoder against ``_read_wav_py``
   on 5 minutes of 48 kHz stereo as PCM16, PCM24 and float32, bit for
   bit, both walls.  Every live phase after it reads its hops through
   the native ring, the default, and fails on the numpy one.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes (16 s of 48 kHz audio), with its time, the
   plain version's, one equivalent library call's where there is one
   (all CUDA events over back-to-back calls, host dispatch included),
   the device's own time per call of the kernel and of the library call
   (``device_ms``: CUDA events with the host's queueing hidden behind a
   device-side sleep), the kernels ranked by the ratio of the two, and
   its roofline bound: B1 deposits (its block route; device time also
   at b = 1, a live hop), B2 histogram at every path's real ids (batch,
   batch16, live, stress, stress live, north, north live, ext262144,
   wide, wide live), by its route and by each route forced, with
   ``index_add_`` as its library call, the routes in turns at the batch
   and north-live shapes, NaN/Inf behind dropped ids at
   every route and hot-cell cases (runs of 32 equal ids, a row in one
   cell, every deposit in one cell),
   B3 colormap lookup (enhanced 8192, hop 2048, 512 rows) in both forms,
   int32 indices (``lut_lookup``) and fused from float32 values
   (``lut_values``, what ``apply_lut`` runs), each on views offset by 0–3
   elements, the fused form beside the four-pass ``apply_lut`` it
   replaced and at one live column; B4 four-step
   steps 1–3 at n = 256, 1024, 4096, 8192, 16384 (the stress call's
   1,376 sequences), 32768 and 131072, each at a full batch and at b = 1
   (bit-equal to frame 0), with the kernel's and the plain version's
   error against a complex128 FFT, and its two routes timed in turns at
   16384; B5 triple windowing at the direct path's frames, from an
   aligned and a misaligned framing view; B1's cluster route at 32768
   (the stress call's 688 frames), with the clusters the card holds at
   once, timed in turns against the three-launch route it replaced
   (forced), both held to plain, both at b = 1; B1's cluster_large route
   (one launch, a frame a cluster of 8 or 16 CTAs) at 65536, 131072 and
   262144 (8 frames), held to plain and to the three-launch large route
   (forced), each also at b = 1, the two timed in turns (medians of
   three rounds; the route ``route_of`` takes must be the faster), and at
   65536 also at the bench's 184 frames, beside ``torch.fft.rfft`` of the
   raw and the t·h frames (the spectra alone); B6, the fused
   deposits histogram, by each route that takes the shape — the block
   route at the batch shape (372 × 8192), the cluster route (one launch:
   no pack, B4 or finish may launch) and the forced three-launch large
   route at the stress shape (688 × 32768), route cluster_large (one
   launch) in each design of its cells (a copy in each CTA, a band in
   each, forced) and the forced large route at the bench's configurations
   5–7 (184 × 65536, 8 × 131072, 8 × 262144 at 96 kHz) and at the north
   star (32768 at hop 800, 20,992 cells) — against its plain version
   and against B1 → B2 composed, with and without the streaming mask, b =
   1 against frame 0, and timed in turns with composed (medians of three
   rounds where cluster_large takes the shape: the design
   ``cluster_large_bands`` picks must be the fastest of the designs and
   the large route); the probe's B2 variants (each B2's own
   code with one stage taken out) at the probe's shape (688 × 16512 →
   2560, half the ids −1), the batch path's ids (both B2's row route)
   and the multires batch ids (1 × 2,267,934 → 3,039,744, the global
   route), its ``full`` timed in three rounds of turns with
   ``histogram()`` on the same ids, the medians within 3%; B1's windowed
   form (a bin window and a band weight) at each bank of the display
   default (8192/2048/512 at hop 128, 5,937 frames, and b = 1 bit-equal
   to frame 0) against its plain version, beside the pruned-DFT product
   that could replace it (``stft_triple_stencil_sliced``/``_blocks``, the
   spectra alone, and the blocks product's whole route to ids), with the
   B2 at the ``multires`` and ``multires_live`` ids; the batch scatters
   of the display default — (a) one relative B2 and the fold (P = 65), (b) the
   JAX package's mixed scatter, composed here, with each bank's
   relative-or-absolute choice timed here, (c) one absolute-grid B2 —
   and each bank's two options; the batch post chain's kernels: the
   chunk-parallel EMA scan (``ema_scan``) against its plain loop, bit for
   bit, at every batch path's shape (multires 5,937 × 512 at α 0.6 and at
   the default 0, batch16 372 × 8192, wide 1,437 × 512, the AGC series
   5,937 × 1 and 372 × 16, t = 0 and t = 1) and with W forced to 0 (every
   chunk repaired, counted), with both of its bounds (bytes; the chain of
   its longest chunk, beside the sequential walk's) and the chunks its
   speculation left to the repair, and the associative form's device time
   and largest relative difference; ``post_head`` and ``post_tail``
   against their plain versions, bit for bit, on the multires (smoothing
   0, 0.6, 0.9 and 0.99), batch (0 and 0.6) and batch16 paths' own
   power, the tail also with every chunk forced to repair (and in its
   pipelined form above smoothing 0.5 with none repaired), and the batch
   chain bit-equal to the live step's column-by-column chain on the same
   power; B2's sorted route at the single-bank
   raster's ids in both forms — the tiles form (the raster's: a tile of
   columns a block, the frames within R of it walked in order) and the
   global-sort form it replaced — each bit-equal to the plain sum, added
   into an output too, and the same on a second run, timed in turns
   (medians of three rounds; the tiles form must be the faster), beside
   the global route, ``index_add_`` and the deterministic
   ``index_put_(accumulate=True)``; B2's sorted route in its batch form
   (a CTA a tile of columns and a band of rows, its own deposits packed
   in order into shared memory and walked by the warps owning their rows)
   at the enhanced batch's ids at 8192, bit-equal to the plain sum, added
   into an output too, the same on a second run, beside its plain version
   and ``index_add_`` with the bytes' and the chain's bounds; B2's ring
   form (one live hop into
   the pending ring in place, each cell in bin order, its ring cells
   computed in the kernel from the relative ids and t) at the hop of
   each enhanced live cell (8192 mono and stereo, direct, the display
   default, the north star, stress 16 ch, wide), bit-equal to its plain
   version on the CPU into a ring of random values at t = 0 … P + 1 and
   far along, with NaN/Inf behind dropped and out-of-range ids, the same
   on a second run and at every cluster size the card holds, timed in
   turns with the atomic route the ``exact_sums=False`` hop takes
   (medians of three rounds) and by cluster size, beside ``index_add_``
   and ``index_put_(accumulate=True)``, and a default stream of 8
   columns bit-equal to the default batch; the real FFT kernel
   (``dsp.kernels.rfft``, where the JAX package calls XLA's rfft) at
   every size it holds (256–262144) on 100 frames of the signal as a
   strided framing view: within 2e-5·√(N/512)·peak of ``torch.fft.rfft``
   as a spectrum and as Hann power (a NaN, +Inf and −Inf frame scrubbed
   to 0), frame k of batches of 1, 2, 7 and 100 and alone bit-equal to
   the view's, its max and rms error against numpy's complex128 at most
   2× ``torch.fft.rfft``'s, every route that holds a size bit-equal to
   the default (16384–262144: route "cluster", a frame a thread-block
   cluster, against the block route below 65536 and the three-launch
   route above, forced); timed at 372 × 8192, 688 × 32768, 184 × 65536
   and 8 × 262144 (and b = 1) beside ``torch.fft.rfft`` and its bound;
   those shapes and b = 1 at every size timed in turns — the default
   route, each forced route, ``torch.fft.rfft``, medians of three rounds,
   failing where the default is the slower beyond 5% — and the kernels'
   phase split (``probes/rfft_phases.py``: ``clock64`` stamps a phase in
   a second build of the real FFT's sources).
4. batch: ``Pipeline.process`` on 16 s of mono audio, enhanced 8192
   (stencil) — the kernel launch counters must rise (its sum on B2's
   sorted batch form, the card's default); the result must match the
   port's CPU path.
5. batch16: the same on a 16-channel batch (its sum on the batch form
   too, 47-column tiles for its 16 lanes).
6. live: ``Stream`` fed in 1024-sample chunks (375 hops) then flushed; it
   must match the batch result; per-hop latency p50/p99.  Every live
   phase runs one CUDA graph replay a hop (one capture a stream, checked),
   and prints first the eager step's p50/p99 on 200 hops driven straight
   through ``Pipeline._stream_step_rolling`` (the A/B inside one run).
   Every enhanced live phase (live, direct_live, stress_live, north_live,
   wide_live, multires_live) runs the card's default, the ordered sums:
   B2's ring form once a hop and no other B2 route, its columns bit-equal
   in ``vis`` and ``rgba`` to a second run, to a run in 777-sample pushes
   and to the default ``Pipeline.process``; a whole atomic stream
   (``Stream(..., exact_sums=False)``: B2's row or global route) within
   1e-5 of ``process(..., exact_sums=False)``; and the default hop beside
   the atomic one in turns (atomic, default, default, atomic, three
   rounds; medians of host p50/p99 and device ms a replay).  Every
   enhanced batch phase holds five more calls to the first bit for bit,
   fails if its default call launched the global sort or an atomic
   route, holds its default sum and each of the three sorted forms
   (batch, tiles, the global sort) at the card's own ids bit-equal to
   the CPU plain sum, the sorted form it took (the one ``sorted_form``
   names) within 5% of each other form in turns (medians of three
   rounds), with ``index_add_`` and the bounds, and times B1 and its sum
   and the whole call against the atomic route in turns (medians of
   three rounds).
7. natural: P-natural batch — ``Settings(mode="natural",
   fft_impl="fourstep")``, the multires banks 8192/2048/512, hop 128,
   512 rows — on 16 s mono; B4 and B3 must launch; matches the CPU path.
8. natural_live: P-natural through ``Stream`` in 1024-sample pushes
   (5,937 hops of 128); must match its batch; p50/p99 per hop, and the
   p50 must be below the hop's 2.67 ms of audio.
9. direct: P-direct batch — enhanced, one bank of 8192, hop 2048,
   ``fft_method="direct"``, ``fft_impl="fourstep"`` — on 16 s mono; B5,
   B4, B2 and B3 must launch; matches the CPU path.
10. direct_live: P-direct through ``Stream``; must match its batch.
11. stress: ``BASELINE.json`` config 5 — enhanced 32768 at 96 kHz, hop
   8192, 16 channels, 4 s (688 frames a call) — batch; B1's cluster
   route, B2 and B3 must launch; matches the CPU path.
12. stress_live: the same settings through ``Stream``, 16 s of 16
   channels (186 hops); must match its batch (phase stress_live_batch,
   itself held to the CPU path).
13. north: the north star — enhanced 32768 at 48 kHz, hop 800 (60
   columns a second, R = 20) — batch on 16 s mono; matches the CPU path.
14. north_live: the same through ``Stream`` in 800-sample pushes (940
   hops); must match its batch; p50/p99 beside the 10 ms budget and the
   16.7 ms hop.
15. ext262144: enhanced 262144 at 96 kHz, hop 65536, 8 s mono (8
   frames) — batch; B1's cluster_large route, B2 and B3 must launch;
   matches the CPU path.
16. wide: enhanced 8192 at hop 64 (R = 64: 66,048 relative cells, above
   a block's shared memory), 2 s mono — batch, then through ``Stream``;
   B1, B2 (on its global route) and B3 must launch; the batch matches
   the CPU path and the stream matches the batch; the live p50 must be
   below the hop's 1.33 ms of audio.
17. multires: the display default ``Settings()`` — enhanced multires
   8192/2048/512, hop 128, 512 rows — batch on 16 s mono (5,937
   columns); B1 in its windowed form, B2 and B3 must launch; matches the
   CPU path.
18. multires_live: the same through ``Stream`` in 1024-sample pushes
   (5,937 hops of 128); must match its batch; p50/p99 per hop, and the
   p50 must be below the hop's 2.67 ms of audio.
18b. default_engine: the default engine (``fft_impl="auto"``: the real
   FFT kernel's spectra) at natural 4096 one bank (the CLI's default),
   natural multires, direct 32768 and 65536 at 96 kHz, and the display
   default with a 256 bank (8192/2048/256) — ``process`` (the kernel
   must launch) against the CPU path, two calls bit-equal, and a graphed
   ``Stream`` ≡ ``process`` bit for bit in vis and rgba, its p50 a hop
   below the hop's audio; device ms a call, host p50/p99 a hop.
19. raster: the single-bank raster (``render.raster.render_image``) on
   16 s mono, enhanced 8192 at hop 2048 (B5, B2's sorted route in its
   tiles form, the scan kernel and B3 must launch) and natural 2048 at
   hop 512; the image is
   the colormap of ``render_vis``, which is the same on a second run
   (and, measured beside it, how many pixels five more runs change when
   its sum takes B2's atomic global route instead); the power grid and
   vis match the port's CPU path; wall per call.
20. cli: ``python -m emspec_torch`` in subprocesses on a 16 s WAV written
   with the port's ``io.wav`` — render (8192; with the CLI's defaults
   twice and --multires twice, each pair byte-equal), export (``apply_lut``
   of its vis equals render's PNG pixel for pixel; with --multires, render
   --multires's), stream twice (byte-equal), stream --hop 16384 on the
   display default twice (47 columns at R = 0, byte-equal), stream
   --fft-size 65536 --no-multires over the first 4 s (8 columns, B2's
   ring form in windows), animate over the first 4 s at 10 fps (its last frame equals stream's
   PNG of the same 4 s) and note 443 — each must exit 0; walls; and render --multires
   --time-parallel (world size 1 under NCCL) twice, byte-equal, whose PNG
   must be render --multires's within one colormap step a pixel (the
   pairs started together).  Then in this process
   the display default's file render (``render_image_multires``, counted:
   its sum must take B2's sorted tiles): the image the same on two calls,
   its grid before the post chain bit-equal on two calls and to the CPU
   plain sum of its deposits, the global route's grid (``exact_sums=
   False``) on two calls (cells that differ), and the sum's device time,
   tiles against global, in turns.  At the end no driven path may have
   launched B2's atomic routes (row or global): they are opt-in.
21. app: the live app as a user opens it — ``ShellServer(Settings(),
   source="wav")`` on the card looping the 16 s signal over HTTP, a
   viewer polling ``/api/frame`` at 15 Hz, one continuous POST and two
   structural ones (4096 single-bank, then natural); in each window
   between them the columns painted must be ≥ 0.98 × the audio hops that
   arrived with no dropped frame, the kinds as expected (the slider
   re-captures nothing), every frame (512, 1024, 4); POST walls, the gap
   to a new stream's first column, drain-tick and ``/api/frame`` walls
   p50/p99.  Then ``EmSpecApp(Settings())`` fed the same WAV in 1024- and
   777-sample pushes: the columns it paints bit-equal to each other and
   to the default ``process`` of the WAV in ``vis`` and ``rgba``.
22. swap: ``EmSpecApp.apply_settings`` wall for natural, the display
   default and each dropdown size ≤ 32768, cold and prewarmed; ten swaps
   under a running background prewarm: one capture a new stream, none
   a slider move, reserved memory after swap 10 within one stream's of
   after swap 2.
23. live_cli: ``python -m emspec_torch`` live --capture (synthetic), live
   --fast on a 4 s WAV, presets add/show/delete, gui --duration 3
   --no-prewarm and doctor --kernels, each a subprocess exiting 0; walls.
   Doctor's kernels row must name B2's sorted batch, tiles and ring
   (local and cluster) forms, B1's windowed form and the real FFT's power
   and spectrum forms.  Then each new
   check of ``dsp/kernels/validate.py`` on the card with its form broken
   (``validate.perturbed``, the CPU tests' stand-ins) must raise.
24. ring_ab: the display default live and north live through graphed
   ``Stream``s on the numpy ring and on the native ring in turns (numpy,
   native, native, numpy, twice), p50/p99 host ms a hop of each and each
   run's p50.
25. examples: ``python -m emspec_torch.examples.<name>`` (the six
   examples) on the card, each a subprocess that must exit 0 and print;
   the time-parallel render within 1e-5 of one device; walls.  The
   sharded two under ``torchrun`` across every card where there are two
   or more (with one card the line says they did not run).
26. parallel: ``emspec_torch.parallel`` at world size 1 under NCCL, at
   full width, each against the port's unsharded path on the card (vis
   within 1e-5, rgba within one colormap step) with B1, B2, the scan (in
   batch) and B3 launching, its wall (CUDA events) beside the unsharded
   one and its collectives a call: ``ShardedPipeline`` on the stress
   configuration (4 s, 16 ch; with and without the global AGC),
   ``ShardedStream`` through ``stream_signal_sharded`` on it for 16 s,
   ``TimeParallelRenderer`` on the display default (16 s mono) and on a
   1×1 (ch × t) mesh over the 16-channel stress signal (global AGC); the
   time renderer's grid before the post chain bit-equal on two renders
   (its sum B2's sorted tiles), the sum timed in turns with the global
   route at the same ids.
27. checkpoint: a graphed ``Stream`` (the live phase's settings and
   signal) saved at hop 187 (``utils.checkpoint.save_stream``), loaded
   into a fresh graphed ``Stream``, which must not re-capture; its
   continuation within 1e-5 of the uninterrupted stream's.  Then the
   display default's graphed ``Stream`` fed by a producer thread at
   real-time pace in the web shell's feed blocks, saved every 0.5 s
   while it drains: no save may raise or store other samples than
   ``[ring_total − kept, ring_total)``, no frame may drop, its columns
   and those of a fresh graphed ``Stream`` loaded from the last file
   bit-equal (vis and rgba) to the default batch at every hop.  One save
   once the ring is full waits, just before its read of the whole ring,
   for the producer's next push: that read is lapped and the save keeps
   the span from the stream's first unread sample (its second span); its
   ``ring_data`` is exact and a fresh graphed ``Stream`` loaded from it
   ≡ the default batch too.
28. sparse_hop: hops at and past the largest frame (R = 0: the live
   window rolls min(hop, n_max) samples a hop) — the display default at
   hop 16384, enhanced 8192 at hop 12000 and at 8192, natural 2048 at
   hop 4096, the north star's 32768 and the stress cell's 16 channels at
   96 kHz at hop 40000 — each a graphed ``Stream`` on the card's defaults
   fed 8 s
   in 777-sample pushes and flushed: its columns bit-equal to
   ``Pipeline.process`` on the card in vis and rgba, the batch within
   the CPU path's tolerances, B2's ring form once a hop and the batch's
   sum in the form ``sorted_form`` names (no global sort, no atomic
   route), B2 at R = 0 bit-equal to its plain versions; host p50/p99 ms
   a hop beside the card's name and power limit.
29. live_large: live where B2's ring form stages the hop in windows
   (262144, 65536 and 131072 at 96 kHz, their default hops: 32,769 to
   131,073 deposits a hop) or cuts the ring into bands (8192 at hop 16
   and 32768 at hop 64 with 2,048 rows, 16384 at hop 16: 513 to 1,025
   slots) — each a graphed ``Stream`` fed in 777-sample pushes and
   flushed: one capture, no frame dropped, its columns bit-equal to
   ``Pipeline.process`` on the card in vis and rgba, the ring form in
   windows or bands once a hop, no global sort and no atomic route, the
   batch within the CPU path's tolerances (vis once float64 plain settles
   the deposits the card's B1 and the CPU path place apart; each it does
   not explain 60 dB below the loudest: ``settled_vis``), host p50 and
   p99 (the max under 100 pushes) ms a hop, reported, not held; and a
   kernel row each (``histogram_sorted_ring_<shape>``): the ring form at
   the hop's real ids bit-equal to its plain version at t = 0, 1 and
   mid, with NaN/Inf behind dropped ids, its device ms, bound, plain and
   ``index_add_`` times.
30. long_batch: the north star (32768, hop 800) on 37 minutes of seeded
   48 kHz audio, 2^31 deposits and more a lane: ``Pipeline.process`` on
   the card (B2's batch form, one launch) ≡ a graphed ``Stream`` of the
   same audio bit for bit in vis and rgba; B2's sum at those ids
   bit-equal to the plain sum in (frame, bin) order on the CPU, block by
   block of columns (frames c0 − R … c1 + R for columns [c0, c1)); B2's
   form, its device ms, bound and ``index_add_``'s device ms at the same
   ids, the card's peak reserved memory.
   ``long_batch_phase(dev, "wide")`` runs wide (8192 at hop 64) at 11.8
   minutes the same way, as a probe.
31. fuzz: ``emspec_torch.probes.settings_fuzz``: its fixed cases and the
   draws of ``FUZZ_SEEDS`` over the whole ``Settings`` surface, each
   ``process`` and a graphed ``Stream`` on the card against the port's
   CPU path (module docstring there); every case must pass — its stream
   ≡ its ``process`` bit for bit in every case — and each B1 route and
   form, B2 form and kernel the defaults launch (the real FFT kernel
   among them) must be reached; one line of coverage (cases a form).
32. trace: ``utils.tracing.trace`` around one batch call; the trace it
   writes must name B1's, B2's and the post chain's kernels (``post_head``,
   both scans' speculate and repair passes); the kernels one post chain
   call launches, read from the trace; and one live hop's kernels in
   launch order, on the default (B1 then B2's ring form at once: no
   ring-id launch between them) and on the atomic route; one default
   call and hop of each default_engine cell under torch.profiler, which
   must hold the real FFT kernel and no cuFFT kernel, no kernel of B4
   and no pack or unpack of the three-launch route.
33. bench: ``python -m emspec_torch bench`` as a user runs it, each a
   subprocess on the card that must exit 0 and print its JSON report:
   ``--soak --duration 30 --quick`` (while it runs, ``--sustained
   --duration 3`` and ``--trace DIR``), then ``--quick`` and ``--stages``
   alone on the card.  Every throughput configuration has columns/s and
   device ms a call above 0 and each roofline share in (0, 105]; the
   primary metric's device frames/s is within 10% of t_count over
   ``device_ms`` of the batch phase's cell timed here the same way; both
   sustained runs keep up (≥ 0.95); the soak's churn counts no error;
   the trace holds the card's kernels.  The primary metric is printed on
   its own line with the card's name and power limit.
34. breakdown: per-stage device times of the enhanced stencil batch
   paths (batch, batch16, stress, wide, multires; CUDA events), the
   device's busy time per kernel and idle share of every batch cell and
   of a live hop of each path and each raster (torch.profiler busy time
   over the unprofiled wall time).

Every batch phase also times the post chain alone in both forms
(sequential: ``post_head``, ``ema_scan``, ``post_tail``; associative:
⌈log2 t⌉ doubling passes) with its launches a call and the chunks its
scans repaired, beside the per-column loop's stage where PERF.md has it,
must launch the three post chain kernels,
and counts the pixels in which five more calls differ from the first
(B2's atomics: a measurement, not a check).

Every path is driven once with the launch counters set to 0 just before
and read just after; those counts are the ``launches`` of the per-kernel
JSON line.  Then that line, and as the last line
``{"ok": true, "device": {...}}``.

Tolerances (``emspec_torch.validate``): quantized power grids — total
energy ≤ 1e-4 relative, 3×3 max-filters within 1e-3·peak on all but 1e-4
of the cells (a float32 rounding flip moves a whole deposit one cell);
B1 (every route and form) additionally ≥ 99.99% equal ids, every other
valid deposit moved by one cell only, bins 0 and N/2 exact (where its
window holds them), and contrib within 1e-5·peak wherever both are
valid, and b = 1 bit-equal to frame 0 of the batch; the three batch
scatters of the display default against each other by the grid rule; B2 (each route; exact zeros), B6 (each route, against B1 → B2 composed, with
exact zeros below min_id) and the probe's ``full`` and ``no_merge``
(against B2) ≤ 1e-5 relative per nonzero bin; every probe variant within
1e-5·max of its own plain version; B3 (both forms), B5 and the post chain's three
kernels bit-equal;
B2's sorted route (its tiles, sort and ring forms) bit-equal to the plain
sum on the CPU; on the card's defaults every enhanced stream bit-equal to
itself on a second run, in other pushes, and to the batch (vis and rgba),
every enhanced batch call to the next; B4 (either route) within
2e-5·max|X| (the JAX package's four-step bound); natural power grids within 1e-4·peak per cell (not quantized; float32
FFT rounding only); ``vis`` 3×3 max-filters within 2/255 on all but 1e-4
of the cells; natural live vs batch within 1e-5 in ``vis`` (FFT batch
shapes reorder sums only), enhanced live ≡ batch bit for bit; the real
FFT kernel within 2e-5·√(N/512)·peak of ``torch.fft.rfft`` and bit-equal
across batches, the default engine's streams ≡ their batch bit for bit.
"""

from __future__ import annotations

import atexit
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from statistics import fmean, median
from pathlib import Path

import numpy as np
import torch

# the checkout holding this script, put on the path whatever the working
# directory and the interpreter's flags (``-P``/``-I`` leave the script's
# directory off it); a copy of the script without its package stops here
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
try:
    import emspec_torch  # noqa: F401
except ModuleNotFoundError as e:
    raise SystemExit(f"chip_smoke: FAILED: {e} (this script runs from a "
                     f"checkout of the repository, beside emspec_torch/)")

from emspec_torch import Settings, kernels_build
from emspec_torch.bench.measure import cuda_ms, device_ms
from emspec_torch.bench.roofline import (
    b1_bound, b1_window_bound, bound, dft_ops, frame_bytes, rfft_bound)
from emspec_torch.dsp import fourstep
from emspec_torch.dsp.frame import (
    frame_signal, frame_signal_np, signal_blocks)
from emspec_torch.dsp.kernels import ema
from emspec_torch.dsp.kernels import validate as kernel_validate
from emspec_torch.dsp.kernels.ema import ema_scan, ema_scan_plain
from emspec_torch.dsp.kernels.post import (
    pipelined, post_head, post_head_plain, post_tail, post_tail_plain)
from emspec_torch.dsp.kernels.deposits import (
    CLUSTER_LARGE_N, cluster_large_bands, cluster_large_occupancy,
    cluster_large_plan, cluster_occupancy, deposits_hist, deposits_hist_plain, deposits_ids,
    deposits_ids_cluster, deposits_ids_cluster_large, deposits_ids_large,
    deposits_ids_plain, hist_route_of, quantize_deposits)
from emspec_torch.dsp.kernels.deposits import route_of as b1_route_of
from emspec_torch.dsp.kernels.fourstep import (
    SMALL_MAX, device_radix_tables, fft4_steps123, fft4_steps123_plain)
from emspec_torch.dsp.kernels.lut import (
    lut_lookup, lut_lookup_plain, lut_values, lut_values_plain)
from emspec_torch.dsp.kernels.rfft import (
    CLUSTER_MIN_N as RFFT_CLUSTER_MIN_N, cluster_occupancy as
    rfft_cluster_occupancy, cluster_plan as rfft_cluster_plan, rfft_frames,
    rfft_frames_plain)
from emspec_torch.dsp.kernels.rfft import route_of as rfft_route_of
from emspec_torch.dsp.kernels.rfft import routes_of as rfft_routes_of
from emspec_torch.dsp.kernels.scatter import (
    ROUTES, SMEM_BINS, SORTED, SORTED_BATCH, SORTED_RING, SORTED_TILES,
    batch_plan, ring_offsets, histogram, histogram_plain, histogram_ring,
    histogram_ring_plain, ring_form, ring_ids, ring_occupancy, ring_plan,
    ring_plan_on, route_of, sorted_form, tile_plan)
from emspec_torch.dsp.kernels.window import (
    w3_table, windowed_frames, windowed_frames_plain)
from emspec_torch.dsp.stft import (
    hann_window, stft_triple_stencil_blocks, stft_triple_stencil_sliced,
    th_window)
from emspec_torch.dsp.reassign import (
    reassigned_bins, reassignment_corrections)
from emspec_torch.dsp.stft import stft_triple
from emspec_torch.io.ring import RingBuffer
from emspec_torch.io.wav import _read_wav_py, write_wav
from emspec_torch.native import lib as native
from emspec_torch.native.lib import NativeRingBuffer
from emspec_torch.pipeline import Pipeline, render_image_multires
from emspec_torch.post import chain
from emspec_torch.post.chain import PostState, postprocess_batch
from emspec_torch.post.colormap import apply_lut
from emspec_torch.render import raster
from emspec_torch.render.apng import read_apng
from emspec_torch.render.png import read_png
from emspec_torch.tables import lut
from emspec_torch.probes import rfft_phases, settings_fuzz
from emspec_torch.probes.scatter_ablation import (
    ROW_ONLY, VARIANTS, hist_variant, hist_variant_plain)
from emspec_torch.probes.settings_fuzz import UNEXPLAINED_BELOW, settled_vis
from emspec_torch.stream import Stream
from emspec_torch.validate import compare_grids, compare_vis

SR = 48_000
SECONDS = 16.0
SETTINGS = Settings(mode="enhanced", multires=False, fft_size=8192)
NATURAL = Settings(mode="natural", fft_impl="fourstep")
DIRECT = Settings(mode="enhanced", multires=False, fft_size=8192,
                  fft_method="direct", fft_impl="fourstep")
STRESS = Settings(mode="enhanced", multires=False, fft_size=32768,
                  sample_rate=96000, channels=16)
NORTH = Settings(mode="enhanced", multires=False, fft_size=32768, hop=800)
EXT = Settings(mode="enhanced", multires=False, fft_size=262144,
               sample_rate=96000)
WIDE = Settings(mode="enhanced", multires=False, fft_size=8192, hop=64)
MULTIRES = Settings()           # the display default: enhanced multires
RASTER = Settings(mode="enhanced", multires=False, fft_size=8192)  # hop 2048
RASTER_NATURAL = Settings(mode="natural", multires=False, fft_size=2048)
CHANNELS = 16
# live past one CTA's shared memory, B2's ring form in windows (a hop of
# 32,769–131,073 deposits above 32768 points) or in bands (a ring of more
# cells than 16 CTAs hold: a short hop, a tall raster): the path, its
# settings, seconds of its signal
LIVE_LARGE = (
    ("live_large_262144", EXT, 8.0),
    ("live_large_65536", Settings(mode="enhanced", multires=False,
                                  fft_size=65536, sample_rate=96000), 3.0),
    ("live_large_131072", Settings(mode="enhanced", multires=False,
                                   fft_size=131072, sample_rate=96000), 4.0),
    ("live_large_wide_hop16", WIDE.replace(hop=16, raster_height=2048), 0.5),
    ("live_large_north_hop64", NORTH.replace(hop=64, raster_height=2048),
     1.5),
    ("live_large_16384_hop16", Settings(mode="enhanced", multires=False,
                                        fft_size=16384, hop=16), 0.8))


def ring_row(path: str) -> str:
    """The kernel row of a ``LIVE_LARGE`` path: its ring form's shape."""
    return "histogram_sorted_ring_" + path.removeprefix("live_large_")


# a kernel row of one path's shape: its launches are that path's alone
ROW_PATH = {ring_row(path): path for path, _, _ in LIVE_LARGE}
STREAM_VIS_ATOL = 1e-5           # atomics / batch shapes reorder float32 sums
B4_TOL = 2e-5                    # · max|X|
NATURAL_POWER_TOL = 1e-4         # · peak
KERNELS = (
    ("deposits_ids", deposits_ids, "emspec_torch/csrc/deposits.cu",
     "emspec/dsp/pallas/fft4.py:404"),
    ("histogram", histogram, "emspec_torch/csrc/histogram.cu",
     "emspec/dsp/pallas/scatter.py:135"),
    ("lut_lookup", lut_lookup, "emspec_torch/csrc/lut.cu",
     "emspec/dsp/pallas/lut.py:43"),
    ("lut_values", lut_values, "emspec_torch/csrc/lut.cu",
     "emspec/dsp/pallas/lut.py:43"),
    ("fft4_steps123", fft4_steps123, "emspec_torch/csrc/fourstep.cu",
     "emspec/dsp/pallas/fft4.py:130"),
    ("windowed_frames", windowed_frames, "emspec_torch/csrc/window.cu",
     "emspec/dsp/pallas/window.py:41"),
    ("deposits_ids_cluster", deposits_ids_cluster,
     "emspec_torch/csrc/deposits.cu", "emspec/dsp/pallas/fft4.py:404"),
    ("deposits_ids_large", deposits_ids_large,
     "emspec_torch/csrc/deposits_large.cu", "emspec/dsp/pallas/fft4.py:404"),
    ("deposits_ids_cluster_large", deposits_ids_cluster_large,
     "emspec_torch/csrc/deposits_large.cu", "emspec/dsp/pallas/fft4.py:404"),
    ("histogram_sorted_tiles", histogram, "emspec_torch/csrc/histogram.cu",
     "emspec/dsp/pallas/scatter.py:135"),
    ("histogram_sorted", histogram, "emspec_torch/csrc/histogram.cu",
     "emspec/dsp/pallas/scatter.py:135"),
    ("histogram_sorted_batch", histogram,
     "emspec_torch/csrc/histogram_batch.cu",
     "emspec/dsp/pallas/scatter.py:135"),
    ("histogram_sorted_ring", histogram, "emspec_torch/csrc/histogram_ring.cu",
     "emspec/dsp/pallas/scatter.py:135"),
    ("deposits_hist", deposits_hist, "emspec_torch/csrc/deposits.cu",
     "emspec/dsp/pallas/fft4.py:616"),
    ("deposits_hist_cluster", deposits_hist, "emspec_torch/csrc/deposits.cu",
     "emspec/dsp/pallas/fft4.py:616"),
    ("deposits_hist_cluster_large", deposits_hist,
     "emspec_torch/csrc/deposits_large.cu", "emspec/dsp/pallas/fft4.py:616"),
    ("hist_variant", hist_variant, "emspec_torch/csrc/scatter_ablation.cu",
     "bench_probes/scatter_ablation.py:93"),
    ("deposits_ids_window", deposits_ids, "emspec_torch/csrc/deposits.cu",
     "emspec/dsp/pallas/fft4.py:404"),
    # the JAX batch post chain (XLA, not Pallas): the sequential lax.scan,
    # stages 1-3 with the row peak, stages 4-8 around the smoothing scan
    ("ema_scan", ema_scan, "emspec_torch/csrc/ema_scan.cu",
     "emspec/post/chain.py:89"),
    ("post_head", post_head, "emspec_torch/csrc/post_chain.cu",
     "emspec/post/chain.py:131"),
    ("post_tail", post_tail, "emspec_torch/csrc/post_chain.cu",
     "emspec/post/chain.py:149"),
    # XLA's jnp.fft.rfft (not Pallas): natural, the direct method, a 256
    # bank, the natural raster — batch-invariant, as XLA's is and cuFFT
    # is not
    ("rfft", rfft_frames, "emspec_torch/csrc/rfft.cu",
     "emspec/pipeline.py:311"),
    # its route "cluster" (16384–262144): a frame a thread-block cluster
    ("rfft_cluster", rfft_frames, "emspec_torch/csrc/rfft_cluster.cu",
     "emspec/pipeline.py:311"),
) + tuple((row, histogram, "emspec_torch/csrc/histogram_ring.cu",
           "emspec/dsp/pallas/scatter.py:135") for row in ROW_PATH)
# a kernel counted by another counter than its wrapper's ``launches``
COUNTS = {"deposits_ids_window": lambda: deposits_ids.form_launches["window"],
          "histogram_sorted_tiles":
              lambda: histogram.route_launches[SORTED_TILES],
          "histogram_sorted": lambda: histogram.route_launches[SORTED],
          "histogram_sorted_batch":
              lambda: histogram.route_launches[SORTED_BATCH],
          "histogram_sorted_ring":
              lambda: histogram.route_launches[SORTED_RING],
          "deposits_hist_cluster":
              lambda: deposits_hist.route_launches["cluster"],
          "deposits_hist_cluster_large":
              lambda: deposits_hist.route_launches["cluster_large"],
          "rfft_cluster": lambda: rfft_frames.route_launches["cluster"],
          # the ring form in windows or bands (``ring_form``)
          **{row: lambda: histogram.ring_form_launches["windows"]
             + histogram.ring_form_launches["bands"] for row in ROW_PATH}}
# the card's default sums are the ordered ones: every enhanced batch path
# sums through B2's sorted route with its bound — its batch form, or its
# tiles form where ``sorted_form`` says so by shape (no global sort) —
# every enhanced live hop through its ring form (``histogram`` counts each)
TILES = ("histogram", "histogram_sorted_tiles")
BATCH = ("histogram", "histogram_sorted_batch")
RING = ("histogram", "histogram_sorted_ring")
MULTIRES_B1 = ("deposits_ids", "deposits_ids_window")
CLUSTER_B1 = ("deposits_ids_cluster",)
SCAN = ("post_head", "ema_scan", "post_tail")   # every batch post chain
PATH_KERNELS = {        # kernels each path must launch
    "batch": ("deposits_ids",) + BATCH + ("lut_values",) + SCAN,
    "batch16": ("deposits_ids",) + BATCH + ("lut_values",) + SCAN,
    "live": ("deposits_ids",) + RING + ("lut_values",),
    "natural": ("fft4_steps123", "lut_values") + SCAN,
    "natural_live": ("fft4_steps123", "lut_values"),
    "direct": ("windowed_frames", "fft4_steps123") + BATCH
    + ("lut_values",) + SCAN,
    "direct_live": ("windowed_frames", "fft4_steps123") + RING
    + ("lut_values",),
    "stress": CLUSTER_B1 + BATCH + ("lut_values",) + SCAN,
    "stress_live_batch": CLUSTER_B1 + BATCH + ("lut_values",) + SCAN,
    "stress_live": CLUSTER_B1 + RING + ("lut_values",),
    "north": CLUSTER_B1 + BATCH + ("lut_values",) + SCAN,
    "north_live": CLUSTER_B1 + RING + ("lut_values",),
    "ext262144": ("deposits_ids_cluster_large",) + BATCH + ("lut_values",)
    + SCAN,
    "wide": ("deposits_ids",) + BATCH + ("lut_values",) + SCAN,
    "wide_live": ("deposits_ids",) + RING + ("lut_values",),
    "multires": MULTIRES_B1 + TILES + ("lut_values",) + SCAN,
    "multires_live": MULTIRES_B1 + RING + ("lut_values",),
    "raster": ("windowed_frames", "rfft", "histogram_sorted_tiles",
               "lut_values") + SCAN,
    "raster_natural": ("rfft", "lut_values") + SCAN,
    # the display default's file render: its sum on B2's sorted tiles
    "render_multires": MULTIRES_B1 + TILES + ("lut_values",) + SCAN,
    # the shell on the display default, then 4096 single-bank, then natural
    "app": MULTIRES_B1 + RING + ("lut_values",),
    "sharded_pipeline": CLUSTER_B1 + BATCH + ("lut_values",) + SCAN,
    "sharded_pipeline_agc": CLUSTER_B1 + BATCH + ("lut_values",) + SCAN,
    "sharded_stream": CLUSTER_B1 + RING + ("lut_values",),
    # the time renderer's chunk EMAs: the scan kernel alone, then a re-base
    "time_parallel": MULTIRES_B1 + TILES + ("lut_values", "ema_scan"),
    "time_parallel_2d": CLUSTER_B1 + BATCH + ("lut_values", "ema_scan"),
    "checkpoint": ("deposits_ids",) + RING + ("lut_values",),
    # the display default saved under a running producer, then resumed
    "checkpoint_live": MULTIRES_B1 + RING + ("lut_values",),
    # hops at and past the largest frame (R = 0), live then batch
    "sparse_display_16384": MULTIRES_B1 + RING + ("lut_values",),
    "sparse_display_16384_batch": MULTIRES_B1 + TILES + ("lut_values",)
    + SCAN,
    "sparse_enhanced_12000": ("deposits_ids",) + RING + ("lut_values",),
    "sparse_enhanced_12000_batch": ("deposits_ids",) + BATCH
    + ("lut_values",) + SCAN,
    "sparse_enhanced_8192": ("deposits_ids",) + RING + ("lut_values",),
    "sparse_enhanced_8192_batch": ("deposits_ids",) + BATCH
    + ("lut_values",) + SCAN,
    "sparse_natural_4096": ("rfft", "lut_values"),
    "sparse_natural_4096_batch": ("rfft", "lut_values") + SCAN,
    "sparse_north_40000": CLUSTER_B1 + RING + ("lut_values",),
    "sparse_north_40000_batch": CLUSTER_B1 + BATCH + ("lut_values",) + SCAN,
    "sparse_stress_40000": CLUSTER_B1 + RING + ("lut_values",),
    "sparse_stress_40000_batch": CLUSTER_B1 + BATCH + ("lut_values",)
    + SCAN,
    # the north star past 2^31 deposits a lane, batch (its live stream
    # after it, uncounted)
    "long_north": CLUSTER_B1 + BATCH + ("lut_values",) + SCAN,
    "long_wide": ("deposits_ids",) + BATCH + ("lut_values",) + SCAN,
    # the settings fuzz: every B1 route, B2 form and kernel the defaults
    # launch, across its cases
    "fuzz": ("deposits_ids", "deposits_ids_window", "deposits_ids_cluster",
             "deposits_ids_cluster_large", "histogram_sorted_tiles",
             "histogram_sorted_batch", "histogram_sorted_ring",
             "fft4_steps123", "windowed_frames", "rfft", "lut_values")
    + SCAN,
}


def _b1_of(s: Settings) -> tuple:
    """B1's kernel row on a single-bank enhanced path: by ``s.fft_size``."""
    return (("deposits_ids",) if s.fft_size <= 16384 else CLUSTER_B1
            if s.fft_size == 32768 else ("deposits_ids_cluster_large",))


# the default engine's cells (``fft_impl="auto"``): every spectrum of
# natural mode, the direct method and a 256 bank through the real FFT
# kernel — path, settings, seconds of the signal, its sample rate
DEFAULT_ENGINE = (
    ("natural_4096", Settings(mode="natural", multires=False,
                              fft_size=4096), 16.0, SR),
    ("natural_multires", Settings(mode="natural"), 16.0, SR),
    ("direct_32768", Settings(mode="enhanced", multires=False,
                              fft_size=32768, fft_method="direct",
                              sample_rate=96000), 8.0, 96000),
    ("direct_65536", Settings(mode="enhanced", multires=False,
                              fft_size=65536, fft_method="direct",
                              sample_rate=96000), 8.0, 96000),
    ("stencil_256_bank", Settings(multires_sizes=(8192, 2048, 256)), 8.0,
     SR))
for _path, _s, _, _ in DEFAULT_ENGINE:
    _b = (("rfft", "lut_values") if _s.mode == "natural"
          else ("windowed_frames", "rfft", "histogram", "lut_values")
          if _s.fft_method == "direct" else MULTIRES_B1
          + ("rfft", "histogram", "lut_values"))
    _cluster = ("rfft_cluster",) if _s.fft_size >= RFFT_CLUSTER_MIN_N else ()
    PATH_KERNELS[_path] = _b + _cluster + SCAN
    PATH_KERNELS[f"{_path}_live"] = tuple(
        k for k in _b if k != "histogram") + _cluster + (
        () if _s.mode == "natural" else ("histogram_sorted_ring",))
for _path, _s, _ in LIVE_LARGE:     # live: the ring form in windows or bands
    PATH_KERNELS[_path] = _b1_of(_s) + RING + ("lut_values", ring_row(_path))
    PATH_KERNELS[f"{_path}_batch"] = _b1_of(_s) + BATCH + ("lut_values",) \
        + SCAN
# the enhanced live phases: each default stream held bit for bit to a
# second run and to the default batch, its hop in turns with the atomic
# route's (``exact_sums=False``)
ENHANCED_LIVE = ("live", "direct_live", "stress_live", "north_live",
                 "wide_live", "multires_live")
# the post chain's stage on each batch path when it was a loop of two
# launches a column, before the scan kernel (PERF.md §5, the same card
# model and power limit), printed beside this run's
LOOP_POST_STAGE_MS = {"batch": 23.0, "batch16": 30.1, "stress": 4.2,
                     "north": 51.3, "wide": 85.6, "multires": 302.4}
LAUNCHES: dict = {}     # path → {kernel: launches in its one driven run}
SM_CLOCK_HZ = [0.0]     # the card's top SM clock (nvidia-smi), phase device
CARD = [""]             # the card's name and power limit (nvidia-smi)
STEP_CYCLES = 8         # one scan step: a dependent multiply and add
ROUTE_LAUNCHES: dict = {}   # path → {B2 route: launches in that run}
LIVE_TURNS = ("atomic", "default", "default", "atomic") * 3
EXACT: dict = {}        # the multires file render's sum (phase cli)
LIVE_AB: dict = {}      # live phase → its hop, default vs atomic, in turns
BATCH_AB: dict = {}     # batch phase → its sum's form, default vs atomic
HOP_CENSUS: dict = {}   # a live hop's kernels in launch order (trace)
EXACT_TP: dict = {}     # the time renderer's sum (phase parallel)
EXACT_TURNS = ("global", "tiles", "tiles", "global") * 3
BATCH_TURNS = ("atomic", "default", "default", "atomic") * 3
FORM_TOL = 0.05         # a batch's sorted form at most this over another
FORM_TURNS = ("sort", "tiles", "batch", "batch", "tiles", "sort") * 3
CHAIN_CYCLES = 4        # one dependent float add: a chain bound's step


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def signal(seconds: float, channels: int = 1, seed: int = 0,
           sr: int = SR) -> np.ndarray:
    """Linear chirp to 9 kHz (channel c starts at 100 + c·150 Hz), three
    tones of 0.1 and 1% Gaussian noise from ``seed``, at ``sr`` Hz."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    tones = sum(0.1 * np.sin(2 * np.pi * f * t) for f in (440.0, 880.0, 1320.0))
    out = []
    for c in range(channels):
        f0 = 100.0 + 150.0 * c
        chirp = 0.5 * np.sin(2 * np.pi * (f0 * t + 0.5 * (9000.0 - f0)
                                          / seconds * t * t))
        x = chirp + tones + 0.01 * rng.standard_normal(t.size)
        out.append(x.astype(np.float32))
    return out[0] if channels == 1 else np.stack(out)


def times(fn, plain, library=None, iters: int = 20, warmup: int = 3,
          calls: int = 20) -> dict:
    """The kernel's, its plain version's and the library call's ms by CUDA
    events over back-to-back calls (each call's host dispatch included),
    and the device's own time per call of the kernel and of the library
    call (``device_ms`` over ``calls`` calls, ``library_device_ms``)."""
    return dict(
        ms=cuda_ms(fn, iters, warmup), plain_ms=cuda_ms(plain, iters, warmup),
        library_ms=None if library is None else cuda_ms(library, iters,
                                                        warmup),
        device_ms=device_ms(fn, calls),
        library_device_ms=None if library is None else device_ms(library,
                                                                 calls))


def reset_counters() -> None:
    """Every wrapper's ``launches`` and each of its ``*_launches`` dicts
    (B2's by route, B1's by form, the scans' by pass) to 0."""
    for _, wrapper, _, _ in KERNELS:
        wrapper.launches = 0
        for name, counts in vars(wrapper).items():
            if name.endswith("_launches") and isinstance(counts, dict):
                counts.update(dict.fromkeys(counts, 0))


def counters() -> dict:
    return {name: COUNTS[name]() if name in COUNTS else wrapper.launches
            for name, wrapper, _, _ in KERNELS}


def drive(path: str, fn):
    """Run one path once with the counters set to 0 just before and read
    just after; fail unless each of the path's kernels launched."""
    reset_counters()
    out = fn()
    torch.cuda.synchronize()
    LAUNCHES[path] = counters()
    ROUTE_LAUNCHES[path] = dict(histogram.route_launches)
    missing = [k for k in PATH_KERNELS[path] if LAUNCHES[path][k] == 0]
    check(not missing, f"{path}: kernels of the path did not launch: "
          f"{missing} ({LAUNCHES[path]})")
    return out


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    SM_CLOCK_HZ[0] = float(clock[0]) * 1e6
    CARD[0] = smi
    t0 = time.perf_counter()
    # the real FFT's stamped build (its phase split) beside the kernels'
    RFFT_STAMPED[0] = rfft_phases.StampedBuild(kernels_build)
    atexit.register(RFFT_STAMPED[0].close)
    kernels_build.library()
    build_s = time.perf_counter() - t0
    print(smi, flush=True)
    print(f"device: {smi}  torch {torch.__version__} cuda "
          f"{torch.version.cuda}; kernels built in {build_s:.2f} s "
          f"({kernels_build.library_path().name})", flush=True)
    return torch.device("cuda")


def check_native_ring(label: str, st) -> None:
    """A live stream must read its hops through the native ring (the
    default), never the numpy ring it falls back to."""
    check(type(st.ring) is NativeRingBuffer,
          f"{label}: the stream's host ring is {type(st.ring).__name__}, "
          f"not the native ring ({native.build_error()})")


def ring_pair_matches(rng, channels: int, capacity: int, pushes: int) -> int:
    """The same random push sequence into the native and the numpy ring
    (giant pushes past the capacity, empty ones, mono given 1-D): equal
    counts, equal ``window_at`` reads, the same errors → reads compared."""
    a, b = NativeRingBuffer(capacity, channels), RingBuffer(capacity,
                                                            channels)
    reads = 0
    for _ in range(pushes):
        k = int(rng.integers(0, 2 * capacity if rng.uniform() < 0.05
                             else 4096))
        xk = rng.standard_normal((channels, k)).astype(np.float32)
        a.push(xk[0] if channels == 1 and rng.uniform() < 0.5 else xk)
        b.push(xk)
        check(a.total_written == b.total_written,
              f"native ring: total_written {a.total_written} ≠ "
              f"{b.total_written}")
        for _ in range(4):       # mostly live spans, some past either end
            start = max(a.total_written
                        - int(rng.integers(-4096, capacity + 4096)), 0)
            n = int(rng.integers(1, capacity + 64 if rng.uniform() < 0.05
                                 else 8192))
            try:
                want = b.window_at(start, n)
            except ValueError as e:
                try:
                    a.window_at(start, n)
                    fail(f"native ring: window_at({start}, {n}) read where "
                         f"the numpy ring raised {e}")
                except ValueError as g:
                    check(str(g) == str(e), f"native ring: {g} ≠ {e}")
                continue
            check(np.array_equal(a.window_at(start, n), want),
                  f"native ring ≠ numpy ring at {start}, {n}")
            reads += 1
    return reads


def per_op_us(fn, reps: int = 20000) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def wav_bytes(x: np.ndarray, fmt: str) -> bytes:
    """(channels, n) float samples → a RIFF/WAVE file, ``fmt`` "pcm24" or
    "f32" (``write_wav`` writes PCM16 only)."""
    import struct
    inter = np.ascontiguousarray(x.T).ravel()
    if fmt == "pcm24":
        pcm = np.clip(np.round(inter * 8388607.0), -8388608,
                      8388607).astype("<i4")
        body = pcm.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
        tag, bits = 1, 24
    else:
        body, tag, bits = inter.astype("<f4").tobytes(), 3, 32
    block = x.shape[0] * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", tag, x.shape[0], SR, SR * block,
                            block, bits)
    rest = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk + b"data"
            + struct.pack("<I", len(body)) + body)
    return b"RIFF" + struct.pack("<I", len(rest)) + rest


RACE = dict(capacity=1024, chunk=257, window=256, laps=2000)


def ring_race(tmp: str) -> dict:
    """The native ring's seqlock under a lapping producer: the race program
    ``tests/torch_ring_race.cpp`` built with the library's compiler and
    flags against its source, run at 1 and 16 channels with planar and
    interleaved pushes (``RACE``) → its counts by case.  Fails on a torn
    window returned as valid, or on a read that no push overlapped
    coming back other than valid."""
    exe = Path(tmp) / "torch_ring_race"
    r = subprocess.run([native._cxx(), *native.CXXFLAGS, "-pthread", "-o",
                        str(exe), str(ROOT / "tests" / "torch_ring_race.cpp"),
                        str(native.SOURCE)], capture_output=True, text=True,
                       timeout=300)
    check(r.returncode == 0, f"native: the race program did not build: "
          f"{r.stderr}")
    got = {}
    for ch in (1, 16):
        for push in ("planar", "interleaved"):
            r = subprocess.run([str(exe), str(ch), *map(str, RACE.values()),
                                push], capture_output=True, text=True,
                               timeout=120)
            check(r.returncode == 0, f"native: the race program failed at "
                  f"{ch} channels, {push}: {r.stderr}")
            c = json.loads(r.stdout)
            check(c["torn"] == 0 and c["quiet_valid"] == c["quiet"]
                  == RACE["laps"], f"native: ring race at {ch} channels, "
                  f"{push}: {c}")
            got[f"{ch}ch {push}"] = c
    return got


def numpy_ring_race() -> dict:
    """The numpy ring's seqlock under a lapping producer thread: the
    ``race`` of ``tests/test_torch_ring_race_numpy.py`` at its
    mono cases' shapes, below and past the capacity, at 1 and 16
    channels → its counts by case.  Fails on a torn window returned as
    valid, or on a read that no push overlapped coming back other than
    valid."""
    spec = importlib.util.spec_from_file_location(
        "numpy_ring_race", ROOT / "tests" / "test_torch_ring_race_numpy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {}
    for ch in (1, 16):
        for case in ("below", "past_capacity"):
            _, cap, chunks, window, offset = mod.CASES[f"1ch_{case}"]
            c = mod.race(RingBuffer(cap, ch), chunks, window, offset,
                         laps=4000, seconds=1.5)
            check(c["torn"] == 0 and c["quiet"] == c["waits"]
                  == c["quiet_valid"] >= 1, f"native: numpy ring race at "
                  f"{ch} channels, {case}: {c}")
            got[f"{ch}ch {case} (ring {cap}, pushes {chunks}, window "
                f"{window} at +{offset})"] = c
    return got


def native_phase() -> None:
    """The native ingest runtime (``emspec_torch.native``): its build at
    first use and its wall; the C++ ring against the numpy ring on random
    push sequences at 1 and 16 channels, and each ring's host µs a push
    and a ``window_at`` at the live phases' sizes; ``frame_extract``
    against ``frame_signal_np`` at the live shapes; the native WAV
    decoder against ``_read_wav_py`` on 5 minutes of 48 kHz stereo as
    PCM16, PCM24 and float32, bit for bit, with both walls; the ring's
    seqlock under a lapping producer (:func:`ring_race`), and the numpy
    ring's (:func:`numpy_ring_race`)."""
    had = native.BUILD_DIR.exists() and any(
        native.BUILD_DIR.glob("libemspec_native_*.so"))
    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    check(ok, f"native: the library did not build: {native.build_error()}")
    rng = np.random.default_rng(23)
    reads = {ch: ring_pair_matches(rng, ch, 4 * SR, 300) for ch in (1, 16)}
    ops = {}
    for name, ring in (("numpy", RingBuffer(4 * SR)),
                       ("native", NativeRingBuffer(4 * SR))):
        block = np.ones(1024, np.float32)
        ops[name] = (per_op_us(lambda: ring.push(block)),
                     per_op_us(lambda: ring.window_at(ring.total_written
                                                      - 128, 128)),
                     per_op_us(lambda: ring.window_at(ring.total_written
                                                      - 8192, 8192)))
    x = signal(SECONDS)
    frames = {}
    for n, hop in ((8192, 128), (8192, 2048), (32768, 800)):
        t0 = time.perf_counter()
        got = native.frame_extract(x, n, hop)
        nat_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = np.ascontiguousarray(frame_signal_np(x, n, hop))
        np_ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(got, want), f"native: frame_extract ≠ "
              f"frame_signal_np at {n}, hop {hop}")
        frames[f"{n}/{hop}"] = (got.shape[0], nat_ms, np_ms)
    audio = signal(300.0, 2, seed=21)
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fmt in ("pcm16", "pcm24", "f32"):
            path = Path(tmp) / f"{fmt}.wav"
            if fmt == "pcm16":
                write_wav(path, audio, SR)
            else:
                path.write_bytes(wav_bytes(audio, fmt))
            t0 = time.perf_counter()
            got, rate = native.read_wav(path)
            nat_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want, want_rate = _read_wav_py(path)
            py_s = time.perf_counter() - t0
            check(rate == want_rate == SR and got.shape == want.shape
                  == audio.shape and np.array_equal(got, want),
                  f"native: read_wav {fmt} ≠ _read_wav_py")
            walls[fmt] = (path.stat().st_size / 1e6, nat_s, py_s)
        race = ring_race(tmp)
    np_race = numpy_ring_race()
    print(f"numpy ring race on {os.uname().machine} (valid / torn / overrun"
          f" / quiet reads valid of the producer's waits, wall s): "
          + ", ".join(f"{k} {c['valid']} / {c['torn']} / {c['overrun']} / "
                      f"{c['quiet_valid']} of {c['waits']}, "
                      f"{c['seconds']:.4f}" for k, c in np_race.items()),
          flush=True)
    print(f"native race on {os.uname().machine}: {RACE['laps']} laps of a "
          f"{RACE['capacity']}-sample ring in pushes of {RACE['chunk']}, "
          f"windows of {RACE['window']} at the horizon (valid / torn / "
          f"overrun / quiet reads valid, wall s): " + ", ".join(
              f"{k} {c['valid']} / {c['torn']} / {c['overrun']} / "
              f"{c['quiet_valid']} of {c['quiet']}, {c['seconds']:.4f}"
              for k, c in race.items()), flush=True)
    print(f"native: {native.library_path().name} "
          f"{'found' if had else 'built'} in {build_s:.2f} s ({native._cxx()}"
          f" {' '.join(native.CXXFLAGS)}); ring ≡ numpy ring on 300 random "
          f"pushes at 1 and 16 channels ({reads[1]} and {reads[16]} reads "
          f"equal, the same errors); host µs a push of 1024 / window_at 128 "
          f"/ window_at 8192: " + ", ".join(
              f"{k} {a:.2f} / {b:.2f} / {c:.2f}" for k, (a, b, c) in
              ops.items())
          + "; frame_extract ≡ frame_signal_np (frames, native ms, numpy "
          "copy ms): " + ", ".join(f"{k} {f} {a:.1f} {b:.1f}" for k, (f, a, b)
                                   in frames.items())
          + "; read_wav ≡ _read_wav_py on 300 s of 48 kHz stereo (MB, native"
          " s, Python s): " + ", ".join(f"{k} {mb:.1f} {a:.3f} {b:.3f}"
                                        for k, (mb, a, b) in walls.items()),
          flush=True)


def check_b1(label: str, ik, ck, ip, cp, *, n: int, rows: int, R: int,
             k_lo: int = 0, band=None) -> float:
    """B1 (either route; bins k_lo … of its window) against its plain
    version → the largest contrib error.  Compared as histograms
    (DESIGN.md §9) and per deposit.  Invalid deposits carry contrib 0
    (the kernel's id is −1, the plain one's a clamped row); so do valid
    ones where the band weight is 0.  A float32 rounding flip may move a
    valid deposit one row or one column; its contrib = |X_h|²·band/N²
    must agree regardless."""
    S = (2 * R + 1) * rows
    g = compare_grids(histogram_plain(ip, cp, S).reshape(-1, 2 * R + 1, rows),
                      histogram_plain(ik, ck, S).reshape(-1, 2 * R + 1, rows))
    vk, vp = ck > 0, cp > 0
    both = vk & vp
    agree = (both & (ik == ip)) | (~vk & ~vp)
    id_agree = float(agree.float().mean())
    moved = (ik - ip).abs()[both & (ik != ip)]
    one_cell = bool(torch.isin(moved, torch.tensor(
        [1, rows - 1, rows, rows + 1], device=ik.device)).all())
    edges = [k - k_lo for k in (0, n // 2) if 0 <= k - k_lo < ik.shape[-1]]
    edges_exact = bool(agree[..., edges].all())   # Hermitian stencils
    err = float((ck - cp)[both].abs().max())
    peak = float(cp.max())
    invalid = ~vk if band is None else ~vk & (band != 0)
    check(g.ok and id_agree >= 0.9999 and one_cell and edges_exact
          and bool((ik[invalid] == -1).all()) and err <= 1e-5 * peak,
          f"{label} deposits vs plain: {g}, id agreement {id_agree}, moves "
          f"of one cell only {one_cell}, bins 0 and N/2 exact {edges_exact}, "
          f"contrib err {err} vs peak {peak}")
    print(f"{label}: ids equal {id_agree:.6f}, energy {g.energy_rel:.2e}, "
          f"maxf {g.maxf_rel:.2e}, contrib err {err / peak:.2e}·peak",
          flush=True)
    return err


def check_b1_single(label: str, frames, ik, ck, scal, kw, **route) -> None:
    """b = 1 (a live hop: the first frame as an (N,) window) must give
    frame 0 of the batch bit for bit: a frame's arithmetic does not
    depend on the batch."""
    n, k = kw["n"], ik.shape[-1]
    i1, c1 = deposits_ids(frames.reshape(-1, n)[0], *scal, **kw, **route)
    check(torch.equal(i1, ik.reshape(-1, k)[0])
          and torch.equal(c1, ck.reshape(-1, k)[0]),
          f"{label} n={n}: b = 1 differs from frame 0 of the batch")


def kernels_b123(dev, pipe: Pipeline, p) -> dict:
    n, hop, rows, R = pipe.n_max, pipe.hop, pipe.rows, pipe.reach
    S = (2 * R + 1) * rows
    x = torch.from_numpy(signal(SECONDS, seed=1)).to(dev)
    frames = frame_signal(x, n, hop)                       # (372, 8192)
    b = frames.shape[0]
    kw = dict(n=n, hop=hop, sr=float(SR), rows=rows, reach=R)
    scal = (p.logmap_a, p.logmap_b, p.power_floor)
    res = {}

    ik, ck = deposits_ids(frames, *scal, **kw)
    ip, cp = deposits_ids_plain(frames, *scal, **kw)
    err_b1 = check_b1("B1", ik, ck, ip, cp, n=n, rows=rows, R=R)
    check_b1_single("B1", frames, ik, ck, scal, kw)
    res["deposits_ids"] = dict(
        at=f"frames ({b}, {n})", max_abs_err=err_b1,
        **times(lambda: deposits_ids(frames, *scal, **kw),
                lambda: deposits_ids_plain(frames, *scal, **kw),
                spectra_alone(frames, n)),
        library="torch.fft.rfft of the raw and the t·h frames (the "
                "spectra alone)",
        **b1_bound(frames),
        device_ms_b1=device_ms(lambda: deposits_ids(frames[0], *scal, **kw)),
        bound_ms_b1=b1_bound(frames[0])["bound_ms"])

    res["histogram"] = kernels_b2(dev, ik, ck, S)

    res.update(kernels_b3(dev, p, b, rows))
    return res


def apply_lut_unfused(vis, table):
    """``apply_lut`` before B3 took over its quantization: four
    elementwise passes to an int32 index, then B3's int32 form."""
    idx = torch.clamp(torch.round(vis * 255).to(torch.int32), 0, 255)
    return lut_lookup(idx.contiguous(), table)


def kernels_b3(dev, p, b: int, rows: int) -> dict:
    """B3 at the batch raster (t, rows), both forms bit-equal to plain on
    aligned views and on views offset by 1–3 elements; the fused form
    also on the ties (k + 0.5)/255, values outside [0, 1], NaN and ±Inf.
    Times: both forms, the fused one also against the unfused
    ``apply_lut`` (four passes and B3) and at a live column."""
    rng = np.random.default_rng(2)
    idx_all = torch.from_numpy(rng.integers(
        0, 256, b * rows + 3).astype(np.int32)).to(dev)
    idx = idx_all[:b * rows].reshape(b, rows)
    probes = np.concatenate([(np.arange(256) + 0.5) / 255,
                             [0.0, 1.0, -0.5, 1.5, 1e6, np.nan, np.inf,
                              -np.inf]]).astype(np.float32)
    v = rng.uniform(-0.05, 1.05, b * rows + 3).astype(np.float32)
    v[:probes.size] = probes
    vals_all = torch.from_numpy(v).to(dev)
    vals = vals_all[:b * rows].reshape(b, rows)
    for k in range(4):
        iv, vv = idx_all[k:k + b * rows - 5], vals_all[k:k + b * rows - 5]
        check(torch.equal(lut_lookup(iv, p.lut), lut_lookup_plain(iv, p.lut))
              and torch.equal(lut_values(vv, p.lut),
                              lut_values_plain(vv, p.lut)),
              f"B3 differs from plain at an offset of {k} elements")
    lk, lp = lut_lookup(idx, p.lut), lut_lookup_plain(idx, p.lut)
    fk, fp = lut_values(vals, p.lut), lut_values_plain(vals, p.lut)
    check(torch.equal(lk, lp), "B3 lut_lookup differs from table[idx]")
    check(torch.equal(fk, fp), "B3 lut_values differs from its plain version")
    flat_idx = idx.reshape(-1)
    npix = b * rows
    col = vals[b // 2].clone()                       # one live column
    res = {}
    res["lut_lookup"] = dict(
        at=f"idx ({b}, {rows})",
        max_abs_err=float((lk.int() - lp.int()).abs().max()),
        **times(lambda: lut_lookup(idx, p.lut),
                lambda: lut_lookup_plain(idx, p.lut),
                lambda: torch.index_select(p.lut, 0, flat_idx)),
        **bound(4 * npix + 1024 + 4 * npix, 0.0))
    res["lut_values"] = dict(
        at=f"values ({b}, {rows})",
        max_abs_err=float((fk.int() - fp.int()).abs().max()),
        **times(lambda: lut_values(vals, p.lut),
                lambda: lut_values_plain(vals, p.lut),
                lambda: torch.index_select(p.lut, 0, flat_idx)),
        **bound(4 * npix + 1024 + 4 * npix, 0.0),
        unfused_apply_lut_ms=cuda_ms(lambda: apply_lut_unfused(vals, p.lut)),
        unfused_apply_lut_device_ms=device_ms(
            lambda: apply_lut_unfused(vals, p.lut)),
        device_ms_column=device_ms(lambda: lut_values(col, p.lut)),
        unfused_apply_lut_device_ms_column=device_ms(
            lambda: apply_lut_unfused(col, p.lut)),
        bound_ms_column=bound(8 * rows + 1024, 0.0)["bound_ms"])
    r = res["lut_values"]
    print(f"kernels B3: fused {r['ms']:.4f} ms / device {r['device_ms']:.4f}, "
          f"the unfused apply_lut {r['unfused_apply_lut_ms']:.4f} / device "
          f"{r['unfused_apply_lut_device_ms']:.4f}, index_select device "
          f"{r['library_device_ms']:.4f}, bound {r['bound_ms']:.5f} ms at "
          f"{npix} px; a {rows}-px column device {r['device_ms_column']:.4f} "
          f"against {r['unfused_apply_lut_device_ms_column']:.4f}; int32 "
          f"form device {res['lut_lookup']['device_ms']:.4f}; offsets 0-3 "
          f"bit-equal", flush=True)
    return res


# B2 at each path's real ids (rows × m → cells): the shape and the B1
# call that makes them.  The live hops take one frame of their batch.
B2_IN_TURNS = ("batch", "north_live")
B2_TURNS = ("global", "row", "row", "global")


def relative_ids(dev, settings: Settings, x: np.ndarray):
    """The path's B1 ids and contrib on ``x`` and its relative cells."""
    pipe = Pipeline(settings.replace(
        channels=1 if x.ndim == 1 else x.shape[0]), dev)
    xg = pipe.to_device(x)
    ids, contrib = pipe._deposit_ids_rel(
        pipe._bank_inputs(xg, pipe.num_columns(x.shape[-1])), pipe.params())
    return ids, contrib, (2 * pipe.reach + 1) * pipe.rows


def b2_cases(dev, ik, ck, S) -> list:
    """(label, ids, vals, cells) at every path's B2 shape."""
    mid = ik.shape[0] // 2
    cases = [("batch", ik, ck, S),
             ("batch16", *relative_ids(
                 dev, SETTINGS, signal(SECONDS, CHANNELS, seed=3))),
             ("live", ik[mid], ck[mid], S)]
    si, sc, ss = relative_ids(dev, STRESS,
                              signal(4.0, CHANNELS, seed=13, sr=96000))
    mid = si.shape[1] // 2
    cases += [("stress", si, sc, ss),
              ("stress_live", si[:, mid].contiguous(),
               sc[:, mid].contiguous(), ss)]
    ni, nc, ns = relative_ids(dev, NORTH, signal(SECONDS))
    mid = ni.shape[0] // 2
    cases += [("north", ni, nc, ns), ("north_live", ni[mid], nc[mid], ns)]
    cases.append(("ext262144", *relative_ids(
        dev, EXT, signal(8.0, seed=15, sr=96000))))
    wi, wc, ws = relative_ids(dev, WIDE, signal(2.0, seed=16))
    mid = wi.shape[0] // 2
    cases += [("wide", wi, wc, ws), ("wide_live", wi[mid], wc[mid], ws)]
    # the display default: the batch sums every bank's deposits into the
    # absolute (t, rows) grid in one row, a live hop one frame's into the
    # relative space
    mi, mc, ms = relative_ids(dev, MULTIRES, signal(SECONDS, seed=1))
    mid = mi.shape[0] // 2
    cases += [("multires", *multires_batch_ids(dev, mi, mc)),
              ("multires_live", mi[mid], mc[mid], ms)]
    return cases


def multires_batch_ids(dev, mi=None, mc=None):
    """The display default's batch B2 call: every bank's deposits of the
    16 s signal in one row of the absolute (t, rows) grid → (ids, vals,
    cells)."""
    pipe = Pipeline(MULTIRES, dev)
    t = pipe.num_columns(int(SECONDS * SR))
    if mi is None:
        mi, mc, _ = relative_ids(dev, MULTIRES, signal(SECONDS, seed=1))
    return (pipe._absolute_ids(mi, t, pipe.reach).reshape(-1),
            mc.reshape(-1), t * pipe.rows)


def check_b2(label: str, ids, vals, S: int, route=None) -> float:
    """B2 (the route by shape, or ``route``) against plain: 1e-5 relative
    per nonzero bin, exact zeros elsewhere → the largest abs error."""
    hk, hp = histogram(ids, vals, S, route=route), histogram_plain(ids, vals, S)
    nz = hp != 0
    rel = float(((hk - hp).abs()[nz] / hp[nz].abs()).max()) if nz.any() else 0.0
    check(rel <= 1e-5 and bool((hk[~nz] == 0).all())
          and bool(torch.isfinite(hk).all()),
          f"B2 {label} route {route or 'by shape'} vs plain: rel {rel}")
    return float((hk - hp).abs().max())


def check_b2_dropped(label: str, ids, vals, S: int, route) -> None:
    """A NaN or Inf behind a dropped id (−1, or ≥ the cells) must not land:
    the result stays finite and equal to plain."""
    i, v = ids.clone().reshape(-1), vals.clone().reshape(-1)
    i[::7], v[::7] = -1, float("nan")
    i[3::7], v[3::7] = S + 5, float("inf")
    check_b2(f"{label} dropped NaN/Inf", i.reshape(ids.shape),
             v.reshape(ids.shape), S, route)


def clustered_cases(dev, rows: int, m: int, S: int) -> list:
    """Hot cells: runs of 32 equal ids; row 0 all in one cell (the rest
    random); every deposit in one cell."""
    g = torch.Generator(device=dev).manual_seed(17)
    vals = torch.rand((rows, m), generator=g, device=dev)
    runs = torch.randint(0, S, (rows, -(-m // 32)), generator=g, device=dev,
                         dtype=torch.int32).repeat_interleave(32, 1)[:, :m]
    one_row = torch.randint(0, S, (rows, m), generator=g, device=dev,
                            dtype=torch.int32)
    one_row[0] = S // 3
    one = torch.full((rows, m), S // 3, dtype=torch.int32, device=dev)
    return [("runs32", runs.contiguous(), vals), ("one_cell_row", one_row,
                                                  vals), ("one_cell", one, vals)]


def kernels_b2(dev, ik, ck, S) -> dict:
    """B2 at every path's shape, by its route and by each route forced
    (each held to plain, and with NaN/Inf behind dropped ids); times,
    bound and ``index_add_`` per shape; the routes in turns at the batch
    and north-live shapes; hot-cell cases at the batch shape."""
    shapes, lines, worst = {}, [], 0.0
    for label, ids, vals, cells in b2_cases(dev, ik, ck, S):
        m = ids.shape[-1]
        rows = ids.numel() // m
        route = route_of(rows, m, cells)
        err = check_b2(label, ids, vals, cells)
        worst = max(worst, err)
        route_dev = {}
        for r in ROUTES:
            if r == "global" or cells <= SMEM_BINS:
                check_b2(label, ids, vals, cells, r)
                check_b2_dropped(label, ids, vals, cells, r)
                route_dev[r] = device_ms(
                    lambda: histogram(ids, vals, cells, route=r))
        ok_ids = (ids >= 0) & (ids < cells)
        flat = (torch.where(ok_ids, ids, cells).long().reshape(rows, m)
                + (torch.arange(rows, device=dev) * (cells + 1))[:, None]
                ).reshape(-1)
        vals0 = torch.where(ok_ids, vals, 0.0).reshape(-1)
        row = dict(
            at=f"ids ({rows}, {m}) → {cells} bins", hist_route=route,
            max_abs_err=err,
            **times(lambda: histogram(ids, vals, cells),
                    lambda: histogram_plain(ids, vals, cells),
                    lambda: torch.zeros(rows * (cells + 1),
                                        device=dev).index_add_(0, flat, vals0),
                    iters=10),
            **bound(8 * rows * m + 4 * rows * cells, float(ok_ids.sum())),
            route_device_ms=route_dev)
        if label in B2_IN_TURNS:
            turns = {}
            for r in B2_TURNS:
                turns.setdefault(r, []).append(device_ms(
                    lambda: histogram(ids, vals, cells, route=r)))
            row["in_turns_device_ms"] = turns
        shapes[label] = row
        lines.append(
            f"{label} ({rows} × {m} → {cells}): route {route}, device "
            f"{row['device_ms']:.4f} ms (each route: " + ", ".join(
                f"{r} {t:.4f}" for r, t in route_dev.items())
            + f"), bound {row['bound_ms']:.4f} {row['bound_by']}, index_add_ "
            f"device {row['library_device_ms']:.4f}, plain "
            f"{row['plain_ms']:.4f} ms, events {row['ms']:.4f} ms"
            + (f", in turns {row['in_turns_device_ms']}"
               if label in B2_IN_TURNS else ""))
    rows, m = ik.shape
    clustered = {}
    for label, ids, vals in clustered_cases(dev, rows, m, S):
        clustered[label] = {}
        for r in ROUTES:
            check_b2(f"{label} at {rows} × {m}", ids, vals, S, r)
            check_b2_dropped(label, ids, vals, S, r)
            clustered[label][r] = device_ms(
                lambda: histogram(ids, vals, S, route=r))
    lines.append(f"hot cells at {rows} × {m} → {S}, device ms by route: "
                 f"{clustered}")
    print("kernels B2 (each shape and route held to plain, NaN/Inf behind "
          "dropped ids at every route): " + "; ".join(lines), flush=True)
    return dict(shapes["batch"], max_abs_err=worst, shapes=shapes,
                clustered_device_ms=clustered)


# B4 sizes: the complex transform size n = N/2 of each path's real frames
# and the batch one 16 s call gives it (natural banks 8192/2048/512 at
# hop 128: 5,937 frames; direct 8192 at hop 2048: 3 × 372 windowed
# frames; the stress call's 2 × 688 packed sequences of 16384), plus 8192
# and 32768 (the north star's frame size, halved and whole) at 16 s of
# their hop N/4, and 131072 (B1's large route at 262144) at 16.
B4_CASES = ((256, 5937), (1024, 5937), (4096, 5937), (4096, 1116),
            (8192, 372), (16384, 1376), (32768, 93), (131072, 16))
B4_REPORTED = (4096, 5937)         # the natural 8192-bank call
B4_STRESS = (16384, 1376)          # inside B1's large route at the stress call


def f64_err(xr, xi, ref) -> float:
    """max |X − ref| / max |ref| of X[k1, k2] against ref, complex128."""
    return float(torch.maximum((xr.double() - ref.real).abs().max(),
                               (xi.double() - ref.imag).abs().max())
                 / ref.abs().max())


def kernels_b4(dev, rng) -> dict:
    """B4 at each of ``B4_CASES``, at the full batch and at b = 1 (frame 0,
    bit for bit): against its plain version (2e-5·max|X|) and, reported,
    both against a complex128 ``torch.fft.fft`` of the same input
    reindexed to [k1, k2]; at 16384 the two routes in turns."""
    res, lines = {}, []
    for n, full in B4_CASES:
        n1, n2 = fourstep._FACTORS[n]
        zr, zi = (torch.from_numpy(rng.standard_normal(
            (full, n1, n2)).astype(np.float32)).to(dev) for _ in range(2))
        kr, ki = fft4_steps123(zr, zi)
        pr, pi = fft4_steps123_plain(zr, zi)
        scale = float(torch.complex(pr, pi).abs().max())
        err = float(torch.maximum((kr - pr).abs().max(), (ki - pi).abs().max()))
        check(err <= B4_TOL * scale, f"B4 n={n} b={full}: max err {err} vs "
              f"{B4_TOL}·max|X| = {B4_TOL * scale}")
        sr, si = fft4_steps123(zr[:1].clone(), zi[:1].clone())
        p1r, p1i = fft4_steps123_plain(zr[:1], zi[:1])
        err1 = float(torch.maximum((sr - p1r).abs().max(),
                                   (si - p1i).abs().max()))
        check(err1 <= B4_TOL * float(torch.complex(p1r, p1i).abs().max()),
              f"B4 n={n} b=1: max err {err1}")
        check(torch.equal(sr, kr[:1]) and torch.equal(si, ki[:1]),
              f"B4 n={n}: b = 1 differs from frame 0 of the batch")
        ref = torch.fft.fft(torch.complex(zr.double(), zi.double()).reshape(
            full, n)).reshape(full, n2, n1).transpose(1, 2)
        f64 = dict(kernel=f64_err(kr, ki, ref), plain=f64_err(pr, pi, ref))
        del ref
        z = torch.complex(zr, zi).reshape(full, n)
        tab = sum(t.numel() for t in device_radix_tables(n1, n2, dev))
        row = dict(
            at=f"(b, n1, n2) = ({full}, {n1}, {n2})", max_abs_err=err,
            rel_err=err / scale, rel_err_f64=f64,
            **times(lambda: fft4_steps123(zr, zi),
                    lambda: fft4_steps123_plain(zr, zi),
                    lambda: torch.fft.fft(z)),
            **bound(16 * full * n + 4 * tab, full * dft_ops(n)))
        lines.append(f"n={n} b={full} {row['ms']:.4f} ms (device "
                     f"{row['device_ms']:.4f}, plain {row['plain_ms']:.4f}, "
                     f"torch.fft.fft {row['library_ms']:.4f} / device "
                     f"{row['library_device_ms']:.4f}, bound "
                     f"{row['bound_ms']:.4f} {row['bound_by']}; err vs plain "
                     f"{err / scale:.2e}·max|X|, vs complex128: kernel "
                     f"{f64['kernel']:.2e}, plain {f64['plain']:.2e})")
        if (n, full) == B4_STRESS:
            lr, li = fft4_steps123(zr, zi, route="large")
            err_l = float(torch.maximum((lr - pr).abs().max(),
                                        (li - pi).abs().max()))
            check(err_l <= B4_TOL * scale, f"B4 n={n} large route: {err_l}")
            routes = {}
            for r in ("small", "large", "large", "small"):      # in turns
                routes.setdefault(r, []).append(cuda_ms(
                    lambda: fft4_steps123(zr, zi, route=r)))
            row["route_ms"] = routes
            row["route_device_ms"] = {r: device_ms(
                lambda: fft4_steps123(zr, zi, route=r))
                for r in ("small", "large")}
            lines.append(f"n={n} routes in turns (small, large, large, "
                         f"small): {routes}, device {row['route_device_ms']}"
                         f" (threshold n1·n2 <= {SMALL_MAX} takes small)")
            res["fft4_steps123_stress"] = row
        if (n, full) == B4_REPORTED:
            res["fft4_steps123"] = row
    res["fft4_steps123"] = dict(res["fft4_steps123"],
                                at_stress=res.pop("fft4_steps123_stress"))
    print("kernels B4: " + "; ".join(lines) + "; every size also at b = 1, "
          "bit-equal to frame 0", flush=True)
    return res


def kernels_b5(dev) -> dict:
    res = {}
    # B5 at the direct path's frames: bit-equal, also on a 1-D window and
    # on the same framing 4 bytes into the signal (4-byte loads)
    x = torch.from_numpy(signal(SECONDS, seed=5)).to(dev)
    frames = frame_signal(x, DIRECT.fft_size, DIRECT.hop_samples)
    mis = frame_signal(x[1:], DIRECT.fft_size, DIRECT.hop_samples)
    check(frames.data_ptr() % 16 == 0 and mis.data_ptr() % 16 != 0,
          "B5: the aligned and misaligned views are not what they claim")
    wk, wp = windowed_frames(frames), windowed_frames_plain(frames)
    check(torch.equal(wk, wp), "B5 windowed_frames differs from frames·w3")
    check(torch.equal(windowed_frames(frames[3]),
                      windowed_frames_plain(frames[3])),
          "B5 windowed_frames differs on a single (N,) window")
    check(torch.equal(windowed_frames(mis), windowed_frames_plain(mis)),
          "B5 windowed_frames differs on a misaligned view")
    r, n = frames.shape
    w3 = w3_table(n, dev).reshape(3, 1, n)
    mis_t = times(lambda: windowed_frames(mis),
                  lambda: windowed_frames_plain(mis), lambda: mis[None] * w3)
    res["windowed_frames"] = dict(
        at=f"frames ({r}, {n})", max_abs_err=float((wk - wp).abs().max()),
        **times(lambda: windowed_frames(frames),
                lambda: windowed_frames_plain(frames),
                lambda: frames[None] * w3),
        **bound(frame_bytes(frames) + 12 * r * n + 12 * n, 3.0 * r * n),
        misaligned={k: mis_t[k] for k in ("ms", "device_ms", "library_ms",
                                          "library_device_ms")})
    print(f"kernels B5: aligned device {res['windowed_frames']['device_ms']:.4f}"
          f" ms (library {res['windowed_frames']['library_device_ms']:.4f}); "
          f"misaligned device {mis_t['device_ms']:.4f} ms (library "
          f"{mis_t['library_device_ms']:.4f}); bound "
          f"{res['windowed_frames']['bound_ms']:.4f} ms", flush=True)
    return res


# the real FFT kernel: every size it holds (batch-invariance, plain and
# complex128 errors on the script's signal) and the timed shapes (frames,
# N): natural 16 s at 8192, the stress call, the bench's configurations
# 5 and 7
RFFT_SIZES = tuple(1 << b for b in range(8, 19))          # 256 … 262144
RFFT_TIMED = ((372, 8192), (688, 32768), (184, 65536), (8, 262144))
RFFT_BATCHES = (1, 2, 7, 100)
RFFT_F64_FRAMES = 16    # frames of each size held to numpy's complex128
RFFT_F64_RATIO = 2.0    # the kernel's error at most this × torch.fft's


def rfft_tol(n: int) -> float:
    """DESIGN.md §9's spectrum bound, a share of the peak."""
    return 2e-5 * math.sqrt(n / 512)


def rfft_signal_frames(dev, count: int, n: int, seed: int):
    """``count`` frames of ``n`` points at hop n/4 of ``signal`` (chirp,
    tones, 1% noise): a strided framing view."""
    hop = n // 4
    x = torch.from_numpy(signal(((count - 1) * hop + n) / SR,
                                seed=seed)).to(dev)
    return frame_signal(x, n, hop)


def f64_errors(X: torch.Tensor, ref: np.ndarray) -> tuple:
    """(max, rms) of |X − ref| over max and rms |ref|, ref complex128."""
    d = np.abs(X.cpu().numpy().astype(np.complex128) - ref)
    a = np.abs(ref)
    return (float(d.max() / a.max()),
            float(np.sqrt(np.mean(d * d)) / np.sqrt(np.mean(a * a))))


def kernels_rfft(dev) -> dict:
    """The real FFT kernel at every size it holds: 100 frames of the
    signal as a strided framing view, against its plain version
    (``torch.fft.rfft``) within ``rfft_tol``·peak as a spectrum and, with
    Hann, as power (a NaN, +Inf and −Inf frame each scrubbed to 0); frame
    k of batches of 1, 2, 7 and 100 at two offsets and of the frame alone
    bit-equal to the view's; its max and rms error against numpy's
    complex128 rfft beside ``torch.fft.rfft``'s, at most
    ``RFFT_F64_RATIO`` × that.  Then at ``RFFT_TIMED`` its ms (spectrum),
    at b = 1, as Hann power at 8192, beside the plain version and
    ``torch.fft.rfft``, with the bound → the kernel's row."""
    sizes, lines = {}, []
    for n in RFFT_SIZES:
        fr = rfft_signal_frames(dev, RFFT_BATCHES[-1], n, seed=n % 97)
        hann = hann_window(n, dev)
        got, want = rfft_frames(fr), rfft_frames_plain(fr)
        err = float((got - want).abs().max()) / float(want.abs().max())
        check(err <= rfft_tol(n), f"rfft n={n}: {err:.2e} of the peak off "
              f"the plain version (> {rfft_tol(n):.2e})")
        bad = fr[:5].clone()
        for row, v in ((2, float("nan")), (3, float("inf")),
                       (4, -float("inf"))):
            bad[row, n // 3] = v
        pk = rfft_frames(bad, hann, power=True)
        pp = rfft_frames_plain(bad, hann, power=True)
        perr = float((pk - pp).abs().max()) / float(pp.max())
        check(bool(torch.isfinite(pk).all()) and not bool(pk[2:].any())
              and perr <= rfft_tol(n), f"rfft n={n} power: {perr:.2e} of "
              f"the peak, or a non-finite frame not scrubbed to 0")
        for power in (False, True):
            ref = rfft_frames(fr, hann, power=power)
            for b in RFFT_BATCHES:
                for k0 in sorted({0, min(3, 100 - b), 100 - b}):
                    part = rfft_frames(fr[k0:k0 + b].contiguous(), hann,
                                       power=power)
                    check(torch.equal(part, ref[k0:k0 + b]),
                          f"rfft n={n}: frames {k0}…{k0 + b - 1} as a "
                          f"batch of {b} differ from the 100-frame view "
                          f"({'power' if power else 'spectrum'})")
            check(torch.equal(rfft_frames(fr[57], hann, power=power),
                              ref[57]), f"rfft n={n}: frame 57 alone "
                  f"differs from the batch")
        ref64 = np.fft.rfft(fr[:RFFT_F64_FRAMES].cpu().numpy().astype(
            np.float64), axis=-1)
        e_k = f64_errors(got[:RFFT_F64_FRAMES], ref64)
        e_t = f64_errors(torch.fft.rfft(fr[:RFFT_F64_FRAMES]), ref64)
        check(e_k[0] <= RFFT_F64_RATIO * e_t[0]
              and e_k[1] <= RFFT_F64_RATIO * e_t[1],
              f"rfft n={n}: error against complex128 (max, rms) {e_k} over "
              f"{RFFT_F64_RATIO}× torch.fft.rfft's {e_t}")
        for other in rfft_routes_of(n)[1:]:       # the forced routes
            for power in (False, True):
                check(torch.equal(rfft_frames(fr, hann, power=power,
                                              route=other),
                                  rfft_frames(fr, hann, power=power)),
                      f"rfft n={n}: route {rfft_route_of(n)} differs from "
                      f"route {other} ({'power' if power else 'spectrum'})")
        sizes[n] = dict(route=rfft_route_of(n), plain_err=err,
                        power_plain_err=perr, f64_kernel=e_k,
                        f64_torch_fft=e_t, routes=rfft_routes_of(n),
                        clusters_at_once=(rfft_cluster_occupancy(n, dev)
                                          if "cluster" in rfft_routes_of(n)
                                          else None))
        lines.append(f"{n} ({rfft_route_of(n)}) vs plain {err:.1e}, power "
                     f"{perr:.1e}; vs complex128 max/rms kernel "
                     f"{e_k[0]:.1e}/{e_k[1]:.1e}, torch.fft "
                     f"{e_t[0]:.1e}/{e_t[1]:.1e}")
    timed = {}
    for frames, n in RFFT_TIMED:
        fr = (stress_frames(dev)[1] if n == 32768
              else rfft_signal_frames(dev, frames, n, seed=frames))
        check(fr.numel() // n == frames, f"rfft: {fr.shape} is not "
              f"{frames} frames of {n}")
        one = fr.reshape(-1, n)[:1].contiguous()
        row = dict(
            at=f"{frames} × {n}", fft_route=rfft_route_of(n),
            max_abs_err=float((rfft_frames(fr) - rfft_frames_plain(fr))
                              .abs().max()),
            **times(lambda: rfft_frames(fr), lambda: rfft_frames_plain(fr),
                    lambda: torch.fft.rfft(fr), iters=10, warmup=2),
            **rfft_bound(fr),
            b1_device_ms=device_ms(lambda: rfft_frames(one)),
            b1_library_device_ms=device_ms(lambda: torch.fft.rfft(one)))
        row["share"] = row["bound_ms"] / row["device_ms"]
        if n == 8192:
            hann = hann_window(n, dev)
            row["power"] = dict(
                device_ms=device_ms(lambda: rfft_frames(fr, hann,
                                                        power=True)),
                plain_device_ms=device_ms(lambda: rfft_frames_plain(
                    fr, hann, power=True)),
                **rfft_bound(fr, power=True))
        timed[n] = row
        lines.append(f"{frames} × {n}: device {row['device_ms']:.4f} ms "
                     f"(b = 1 {row['b1_device_ms']:.4f}), plain "
                     f"{row['plain_ms']:.4f}, torch.fft.rfft device "
                     f"{row['library_device_ms']:.4f} (b = 1 "
                     f"{row['b1_library_device_ms']:.4f}), bound "
                     f"{row['bound_ms']:.4f} {row['bound_by']} "
                     f"({row['share']:.1%})")
    print(f"kernels rfft ({CARD[0]}): every size within "
          f"2e-5·√(N/512)·peak of torch.fft.rfft, power with the scrub, "
          f"frames of batches {RFFT_BATCHES} and alone bit-equal to the "
          f"100-frame view, every route that holds a size bit-equal to "
          f"its default; " + "; ".join(lines), flush=True)
    turns = rfft_turns(dev)
    phases = rfft_phase_split()
    cluster = {n: dict(rfft_cluster_plan(n), b1=turns[f"1 × {n}"])
               for n in RFFT_SIZES if n >= RFFT_CLUSTER_MIN_N}
    return {"rfft": dict(timed[8192], sizes=sizes, timed=timed, turns=turns,
                         phases=phases),
            "rfft_cluster": dict(timed[65536], plans=cluster,
                                 turns=turns["184 × 65536"])}


RFFT_TURN_ROUNDS = 3
RFFT_TURN_SLACK = 1.05   # the default route no slower than a forced one


def rfft_turns(dev) -> dict:
    """``RFFT_TIMED``'s shapes and b = 1 at every size: the route
    ``route_of`` takes, every other that holds the size (``routes_of``:
    the cluster's parent routes, forced) and ``torch.fft.rfft``, device ms
    in turns (the order reversed every other round), medians of
    ``RFFT_TURN_ROUNDS`` rounds in this process; fails where the default
    route is slower than a forced one beyond ``RFFT_TURN_SLACK``."""
    out, lines = {}, []
    for b, n in [(1, n) for n in RFFT_SIZES] + list(RFFT_TIMED):
        fr = (stress_frames(dev)[1] if (b, n) == (688, 32768)
              else rfft_signal_frames(dev, b, n, seed=b + n % 97))
        if b == 1:
            fr = fr.reshape(-1, n)[0]               # one frame, 1-D
        forms = {r: (lambda r=r: rfft_frames(fr, route=r))
                 for r in rfft_routes_of(n)}
        forms["torch.fft.rfft"] = lambda: torch.fft.rfft(fr)
        got: dict = {}
        for i in range(RFFT_TURN_ROUNDS):
            for k in (list(forms) if i % 2 == 0 else list(forms)[::-1]):
                got.setdefault(k, []).append(device_ms(forms[k]))
        med = {k: float(np.median(v)) for k, v in got.items()}
        own = rfft_route_of(n)
        for other in rfft_routes_of(n)[1:]:
            check(med[own] <= RFFT_TURN_SLACK * med[other],
                  f"rfft {b} × {n}: route {own} {med[own]:.4f} ms is slower "
                  f"than the forced route {other} {med[other]:.4f} ms")
        out[f"{b} × {n}"] = dict(route=own, median_device_ms=med,
                                 turns_device_ms=got, **rfft_bound(fr))
        lines.append(f"{b} × {n} " + ", ".join(
            f"{k} {v:.4f}" for k, v in med.items()))
    print(f"kernels rfft in turns ({CARD[0]}; device ms, medians of "
          f"{RFFT_TURN_ROUNDS} rounds, the route_of route first): "
          + "; ".join(lines), flush=True)
    return out


# the phase split's shapes (probes/rfft_phases.py): b = 1 on each route,
# and the timed shapes
RFFT_PHASE_SHAPES = ((1, 512), (1, 2048), (1, 8192), (1, 16384),
                     (1, 32768), (1, 65536), (1, 262144)) + RFFT_TIMED


RFFT_STAMPED = [None]     # rfft_phases.StampedBuild, started by phase_device


def rfft_phase_split() -> list:
    """The real FFT's phases (``probes/rfft_phases.py``: its one-launch
    kernels rebuilt with ``clock64`` stamps, the three-launch route launch
    by launch) at ``RFFT_PHASE_SHAPES``, every route that holds each
    size → the cases, each printed."""
    cases = rfft_phases.split(RFFT_PHASE_SHAPES, with_routes=True,
                              build=RFFT_STAMPED[0])
    lines = []
    for c in cases:
        if "phases" in c:
            parts = ", ".join(f"{k} {v['us']:.2f}"
                              for k, v in c["phases"].items())
            lines.append(f"{c['at']} {c['route']} (device "
                         f"{c['device_ms'] * 1e3:.2f} µs, block span "
                         f"{c['span_us']:.2f}): {parts}")
        elif "launches" in c:
            lines.append(f"{c['at']} {c['route']} (device "
                         f"{c['device_ms'] * 1e3:.2f} µs): " + ", ".join(
                             f"{k} {v * 1e3:.2f}"
                             for k, v in c["launches"].items()))
    print(f"kernels rfft phases ({CARD[0]}; µs, medians over blocks at the "
          f"measured SM clock): " + "; ".join(lines), flush=True)
    return cases


# B1 above 16384: 32768 at the stress call (4 s of 16 channels at 96 kHz,
# hop 8192: 688 frames) on the cluster route, 65536–262144 at 8 frames of
# hop N/4 on the large route (262144: the ext262144 call)
LARGE_CASES = ((32768, None), (65536, 8), (131072, 8), (262144, 8))
CLUSTER_ROUTES = ("cluster", "large", "large", "cluster")     # in turns
LARGE_TURNS = ("large", "cluster_large", "cluster_large", "large") * 3


def stress_frames(dev, n: int = 32768, seconds: float = 4.0):
    pipe = Pipeline(STRESS.replace(channels=1, fft_size=n), dev)
    x = torch.from_numpy(signal(seconds, CHANNELS, seed=11, sr=96000)).to(dev)
    return pipe, frame_signal(x, n, pipe.hop)                # (16, 43, n)


def spectra_alone(frames, n: int):
    """B1's library yardstick: ``torch.fft.rfft`` of the raw and of the
    t·h-windowed frames, the two spectra alone (no stencil, no
    corrections, no deposits)."""
    th = th_window(n, frames.device)
    return lambda: (torch.fft.rfft(frames), torch.fft.rfft(frames * th))


def route_turns(frames, scal, kw, turns) -> dict:
    """B1's device ms by route, timed in ``turns``, and each route's
    median."""
    got: dict = {}
    for r in turns:
        got.setdefault(r, []).append(device_ms(
            lambda: deposits_ids(frames, *scal, **kw, route=r)))
    return dict(turns_device_ms=got, median={r: float(np.median(v))
                                             for r, v in got.items()})


def kernels_large(dev) -> dict:
    res, lines = {}, []
    for n, b in LARGE_CASES:
        if b is None:
            pipe, frames = stress_frames(dev, n)
        else:
            pipe = Pipeline(EXT.replace(fft_size=n), dev)
            x = torch.from_numpy(signal((b - 1) * (n // 4) / 96000 + n / 96000,
                                        seed=n % 97, sr=96000)).to(dev)
            frames = frame_signal(x, n, pipe.hop)
        p = pipe.params()
        scal = (p.logmap_a, p.logmap_b, p.power_floor)
        kw = dict(n=n, hop=pipe.hop, sr=96000.0, rows=pipe.rows,
                  reach=pipe.reach)
        flat = frames.reshape(-1, n)
        bf = flat.shape[0]
        ik, ck = deposits_ids(frames, *scal, **kw)
        ip, cp = deposits_ids_plain(frames, *scal, **kw)
        err = check_b1(f"B1 n={n} b={bf}", ik, ck, ip, cp, n=n,
                       rows=pipe.rows, R=pipe.reach)
        check_b1_single("B1", frames, ik, ck, scal, kw)
        row = dict(at=f"frames ({bf}, {n})", max_abs_err=err,
                   **times(lambda: deposits_ids(frames, *scal, **kw),
                           lambda: deposits_ids_plain(frames, *scal, **kw),
                           spectra_alone(frames, n), iters=5, warmup=2),
                   library="torch.fft.rfft of the raw and the t·h frames "
                           "(the spectra alone)",
                   **b1_bound(frames),
                   ms_b1=cuda_ms(lambda: deposits_ids(flat[0], *scal, **kw),
                                 10, 2),
                   device_ms_b1=device_ms(
                       lambda: deposits_ids(flat[0], *scal, **kw)),
                   bound_ms_b1=b1_bound(flat[0])["bound_ms"])
        lines.append(f"n={n} b={bf} {b1_route_of(n)} {row['ms']:.4f} ms "
                     f"(device {row['device_ms']:.4f}, b=1 {row['ms_b1']:.4f}"
                     f" / device {row['device_ms_b1']:.4f}, plain "
                     f"{row['plain_ms']:.4f}, rfft of both spectra device "
                     f"{row['library_device_ms']:.4f}, bound "
                     f"{row['bound_ms']:.4f} {row['bound_by']})")
        if n == 32768:
            # the three-launch route it replaced, forced: held to plain
            # and to b = 1, then both routes in turns
            il, cl = deposits_ids(frames, *scal, **kw, route="large")
            row["max_abs_err_large"] = check_b1(
                f"B1 forced large route n={n} b={bf}", il, cl, ip, cp, n=n,
                rows=pipe.rows, R=pipe.reach)
            check_b1_single("B1 forced large route", frames, il, cl, scal, kw,
                            route="large")
            route_ms, route_dev, route_dev1 = {}, {}, {}
            for r in CLUSTER_ROUTES:
                route_ms.setdefault(r, []).append(cuda_ms(
                    lambda: deposits_ids(frames, *scal, **kw, route=r), 5, 2))
                route_dev.setdefault(r, []).append(device_ms(
                    lambda: deposits_ids(frames, *scal, **kw, route=r)))
                route_dev1.setdefault(r, []).append(device_ms(
                    lambda: deposits_ids(flat[0], *scal, **kw, route=r)))
            row.update(route_ms=route_ms, route_device_ms=route_dev,
                       route_device_ms_b1=route_dev1,
                       clusters_at_once=cluster_occupancy(dev))
            lines.append(f"n={n} routes in turns {CLUSTER_ROUTES}: events "
                         f"{route_ms}, device {route_dev}, device at b = 1 "
                         f"{route_dev1}; {row['clusters_at_once']} two-CTA "
                         f"clusters at once")
            res["deposits_ids_cluster"] = row
            continue
        # cluster_large, the default at n: held to the three-launch route
        # it replaced (forced), which is held to plain and to b = 1 too;
        # the two in turns (and, at 65536, at the bench's 184 frames too)
        check(b1_route_of(n) == "cluster_large",
              f"B1 n={n} takes {b1_route_of(n)}, not cluster_large")
        il, cl = deposits_ids(frames, *scal, **kw, route="large")
        err_l = check_b1(f"B1 forced large route n={n} b={bf}", il, cl, ip,
                         cp, n=n, rows=pipe.rows, R=pipe.reach)
        check_b1_single("B1 forced large route", frames, il, cl, scal, kw,
                        route="large")
        check_b1(f"B1 cluster_large vs the large route n={n} b={bf}", ik, ck,
                 il, cl, n=n, rows=pipe.rows, R=pipe.reach)
        plan = cluster_large_plan(n)
        turns = route_turns(frames, scal, kw, LARGE_TURNS)
        row.update(turns, clusters=plan["ctas"], cta_smem=plan["smem"],
                   clusters_at_once=cluster_large_occupancy(n, dev),
                   bit_equal_to_large=bool(torch.equal(ik, il)
                                           and torch.equal(ck, cl)))
        check(row["bit_equal_to_large"],
              f"B1 n={n}: cluster_large is not bit-equal to the large route")
        med = turns["median"]
        check(med[b1_route_of(n)] <= min(med.values()),
              f"B1 n={n}: route_of takes {b1_route_of(n)}, slower than "
              f"another route by median device ms {med}")
        large = dict(at=row["at"], max_abs_err=err_l,
                     **times(lambda: deposits_ids(frames, *scal, **kw,
                                                  route="large"),
                             lambda: deposits_ids_plain(frames, *scal, **kw),
                             spectra_alone(frames, n), iters=5, warmup=2),
                     library=row["library"], **b1_bound(frames),
                     device_ms_b1=device_ms(lambda: deposits_ids(
                         flat[0], *scal, **kw, route="large")))
        lines.append(f"n={n} b={bf} cluster_large ({plan['ctas']} CTAs, "
                     f"{row['clusters_at_once']} clusters at once, bit-equal "
                     f"to large {row['bit_equal_to_large']}) vs large in turns "
                     f"{LARGE_TURNS}: medians {med}; large alone "
                     f"{large['ms']:.4f} ms (device {large['device_ms']:.4f},"
                     f" b=1 {large['device_ms_b1']:.4f})")
        if n == 65536:
            # bench configuration 5: 32 s at 96 kHz, 184 frames
            x = torch.from_numpy(signal(32.0, seed=5, sr=96000)).to(dev)
            f184 = frame_signal(x, n, pipe.hop)
            row["bench_config_5"] = dict(
                at=f"frames ({f184.shape[0]}, {n})",
                **route_turns(f184, scal, kw, LARGE_TURNS),
                **b1_bound(f184))
            med5 = row["bench_config_5"]["median"]
            check(med5["cluster_large"] <= med5["large"],
                  f"B1 n={n} at {f184.shape[0]} frames: cluster_large "
                  f"slower than large by median device ms {med5}")
            lines.append(f"n={n} b={f184.shape[0]} medians {med5}")
        res.setdefault("deposits_ids_cluster_large", {})
        res["deposits_ids_cluster_large"][n] = row
        res.setdefault("deposits_ids_large", {})[n] = large
    # each kernel's row at the extension cell's size, every size beside it
    for name in ("deposits_ids_cluster_large", "deposits_ids_large"):
        sizes = res[name]
        res[name] = dict(sizes[EXT.fft_size], sizes=sizes)
    print("kernels B1 above 16384: " + "; ".join(lines), flush=True)
    return res


# B6's routes at each shape, timed in turns with B1 → B2 composed; the
# probe's ``full`` in turns with B2 itself, the medians within PROBE_TOL
# of each other: three rounds, so that a slow spell over two neighbouring
# turns (one H100 run: both middle turns 27% slow, the outer two as in
# every other run; cause not known) moves neither median
B6_TURNS = {"block": ("composed", "block", "block", "composed"),
            "cluster": ("composed", "cluster", "large", "large", "cluster",
                        "composed"),
            "cluster_large": ("composed", "copies", "bands", "large",
                              "large", "bands", "copies", "composed") * 3}
B6_ROUTES = {"block": ("block",), "cluster": ("cluster", "large"),
             "cluster_large": ("copies", "bands", "large")}
# route cluster_large's two designs of its cells, each forced: a private
# copy in each CTA, or a band in each (``cluster_large_bands`` picks one)
B6_DESIGNS = {"copies": False, "bands": True}
B6_EXT = ((65536, 184), (131072, 8), (262144, 8))   # bench configs 5-7
PROBE_TURNS = ("histogram", "full", "full", "histogram") * 3
PROBE_TOL = 0.03


def check_b6(label: str, frames, scal, kw, route: str, ids, contrib,
             S: int) -> tuple:
    """B6 by ``route`` against B1 → B2 composed (1e-5 relative per nonzero
    bin, exact zeros, below min_id too) and against its plain version
    (the grid rule), with and without the streaming mask, and b = 1 ≡
    frame 0 (1e-5 relative, the same zeros); one launch of the route,
    and no pack, B4 or finish launch on the one-launch routes →
    (largest relative error, largest abs error)."""
    rel_worst, abs_worst = 0.0, 0.0
    force = dict(route=route)
    if route in B6_DESIGNS:
        force = dict(route="cluster_large", bands=B6_DESIGNS[route])
        route = "cluster_large"
    for min_id in (-2**30, 2 * kw["rows"]):
        before = (dict(deposits_hist.route_launches), fft4_steps123.launches)
        got = deposits_hist(frames, *scal, min_id, **kw, **force)
        torch.cuda.synchronize()
        after = (dict(deposits_hist.route_launches), fft4_steps123.launches)
        rises = {r: after[0][r] - before[0][r] for r in after[0]}
        check(rises == {r: int(r == route) for r in rises}
              and (route == "large" or after[1] == before[1]),
              f"B6 {label} route {route}: launches by route {rises}, B4 "
              f"launches {after[1] - before[1]} (the on-chip routes launch "
              f"no pack, B4 or finish)")
        want = histogram(torch.where(ids >= min_id, ids, -1), contrib, S)
        nz = want > 0
        rel = float(((got - want).abs()[nz] / want[nz]).max())
        rel_worst = max(rel_worst, rel)
        abs_worst = max(abs_worst, float((got - want).abs().max()))
        check(rel <= 1e-5 and bool((got[~nz] == 0).all())
              and (min_id < 0 or float(got[..., :min_id].abs().max()) == 0),
              f"B6 {label} route {route} min_id={min_id} vs B1 → B2: rel "
              f"{rel}")
        rows = kw["rows"]
        g = compare_grids(deposits_hist_plain(
            frames, *scal, min_id, **kw).reshape(-1, S // rows, rows),
            got.reshape(-1, S // rows, rows))
        check(g.ok, f"B6 {label} route {route} min_id={min_id} vs plain: {g}")
        one = deposits_hist(frames.reshape(-1, kw["n"])[:1], *scal, min_id,
                            **kw, **force)
        first = got.reshape(-1, S)[:1]
        nz1 = first != 0
        rel1 = float(((one - first).abs()[nz1] / first[nz1]).max()) \
            if bool(nz1.any()) else 0.0
        check(rel1 <= 1e-5 and bool((one[~nz1] == 0).all()),
              f"B6 {label} route {route} min_id={min_id}: b = 1 vs frame 0 "
              f"of the batch, rel {rel1}")
    return rel_worst, abs_worst


def kernels_b6(dev, pipe: Pipeline, p, x) -> dict:
    """B6 by each route that takes the shape, against plain and B1 → B2
    composed, at the batch shape, the stress shape, the bench's
    configurations 5–7 (``ext``: 184 × 65536, 8 × 131072, 8 × 262144 at
    96 kHz) and the north star (32768 at hop 800, 20,992 cells); times by
    route in turns with composed (medians of three rounds where route
    cluster_large takes the shape, which must be no slower than the
    three-launch route), and with every deposit masked (``min_id`` = the
    cell count: the kernel without its adds)."""
    res, lines = {}, []
    cases = [("batch", frame_signal(x, pipe.n_max, pipe.hop), p,
              dict(n=pipe.n_max, hop=pipe.hop, sr=float(SR), rows=pipe.rows,
                   reach=pipe.reach))]
    spipe, sframes = stress_frames(dev)
    cases.append(("stress", sframes, spipe.params(),
                  dict(n=32768, hop=spipe.hop, sr=96000.0, rows=spipe.rows,
                       reach=spipe.reach)))
    for n, b in B6_EXT:
        epipe = Pipeline(EXT.replace(fft_size=n), dev)
        xe = torch.from_numpy(signal(((b - 1) * epipe.hop + n) / 96000,
                                     seed=n % 89, sr=96000)).to(dev)
        cases.append((f"ext{n}", frame_signal(xe, n, epipe.hop),
                      epipe.params(),
                      dict(n=n, hop=epipe.hop, sr=96000.0, rows=epipe.rows,
                           reach=epipe.reach)))
    npipe = Pipeline(NORTH, dev)
    cases.append(("north", frame_signal(x, 32768, npipe.hop), npipe.params(),
                  dict(n=32768, hop=npipe.hop, sr=float(SR), rows=npipe.rows,
                       reach=npipe.reach)))
    for label, frames, pp, kw in cases:
        scal = (pp.logmap_a, pp.logmap_b, pp.power_floor)
        n = kw["n"]
        S = (2 * kw["reach"] + 1) * kw["rows"]
        b = frames.numel() // n
        first = hist_route_of(n, S)
        routes = B6_ROUTES[first]
        ids, contrib = deposits_ids(frames, *scal, **kw)
        errs = {r: check_b6(label, frames, scal, kw, r, ids, contrib, S)
                for r in routes}

        def composed():
            return histogram(*deposits_ids(frames, *scal, **kw), S)

        def fused(r, min_id=-2**30):
            force = (dict(route="cluster_large", bands=B6_DESIGNS[r])
                     if r in B6_DESIGNS else dict(route=r))
            return lambda: deposits_hist(frames, *scal, min_id, **kw,
                                         **force)

        turns = {}
        for who in B6_TURNS[first]:
            turns.setdefault(who, []).append(device_ms(
                composed if who == "composed" else fused(who)))
        med = {r: float(np.median(v)) for r, v in turns.items()}
        if first == "cluster_large":
            own = "bands" if cluster_large_bands(n, S) else "copies"
            med["cluster_large"] = med[own]
            check(med[own] <= min(med["large"], med["copies"],
                                  med["bands"]),
                  f"B6 {label} ({b} × {n} → {S}): route cluster_large "
                  f"({own}) slower than another route or design by median "
                  f"device ms {med}")
        bnd = bound(frame_bytes(frames) + 4 * b * S + 8 * n + 12,
                    b * (dft_ops(n) + n + 40 * (n // 2 + 1))
                    + float((contrib > 0).sum()))
        for r in routes:
            res[label, r] = dict(
                at=f"frames ({b}, {n}) → {S} bins", hist_route=r,
                max_abs_err=errs[r][1], max_rel_err=errs[r][0],
                **times(fused(r), lambda: deposits_hist_plain(
                    frames, *scal, -2**30, **kw), iters=5, warmup=2),
                composed_ms=cuda_ms(composed, 5, 2),
                composed_device_ms=fmean(turns["composed"]),
                in_turns_device_ms=turns, median_device_ms=med,
                masked_device_ms=device_ms(fused(r, S)), **bnd)
        lines.append(
            f"B6 {label} ({b} × {n} → {S}), device ms in turns {turns}, "
            f"medians {med}; "
            + ", ".join(f"{r}: device {res[label, r]['device_ms']:.4f} "
                        f"(every deposit masked "
                        f"{res[label, r]['masked_device_ms']:.4f}), events "
                        f"{res[label, r]['ms']:.4f}, rel err "
                        f"{errs[r][0]:.2e}" for r in routes)
            + f"; composed events {res[label, routes[0]]['composed_ms']:.4f}"
            f", plain {res[label, routes[0]]['plain_ms']:.4f}, bound "
            f"{bnd['bound_ms']:.4f} {bnd['bound_by']}")
    print("kernels B6: " + "; ".join(lines), flush=True)
    return dict(
        deposits_hist=dict(res["batch", "block"],
                           at_stress_large=res["stress", "large"]),
        deposits_hist_cluster=res["stress", "cluster"],
        deposits_hist_cluster_large=dict(
            res["north", "bands"],
            at_north_copies=res["north", "copies"],
            at_north_large=res["north", "large"],
            at_ext={label: dict(res[label, "copies"],
                                bands=res[label, "bands"],
                                large=res[label, "large"])
                    for label in (f"ext{n}" for n, _ in B6_EXT)}))


def kernels_probe(dev, pipe: Pipeline, p, x) -> dict:
    """The probe's variants at its three shapes, each against its plain
    version, ``full`` and ``no_merge`` against B2; each variant's device
    time and its gap to ``full``; ``full`` in turns with ``histogram()``
    on the same ids, the medians of three rounds within ``PROBE_TOL``."""
    rng = np.random.default_rng(0)
    b, m, S = 688, 16512, 2560                    # scatter_ablation.py:134-139
    pid = rng.integers(0, S, size=(b, m)).astype(np.int32)
    pid[rng.random((b, m)) < 0.5] = -1
    cases = [("probe", torch.from_numpy(pid).to(dev),
              torch.from_numpy(rng.random((b, m)).astype(np.float32)).to(dev),
              S)]
    n = pipe.n_max
    ik, ck = deposits_ids(frame_signal(x, n, pipe.hop), p.logmap_a,
                          p.logmap_b, p.power_floor, n=n, hop=pipe.hop,
                          sr=float(SR), rows=pipe.rows, reach=pipe.reach)
    cases.append(("batch ids", ik, ck, (2 * pipe.reach + 1) * pipe.rows))
    mi, mv, mcells = multires_batch_ids(dev)
    cases.append(("multires batch ids", mi.reshape(1, -1),
                  mv.reshape(1, -1), mcells))
    shapes, lines = {}, []
    for label, ids, vals, S in cases:
        rows, m = ids.shape
        route = route_of(rows, m, S)
        variant_dev, worst = {}, 0.0
        for variant in VARIANTS:
            if variant in ROW_ONLY and route != "row":
                continue
            got = hist_variant(ids, vals, S, variant)
            want = hist_variant_plain(ids, vals, S, variant)
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            check(err <= 1e-5 * scale, f"probe {variant} at {label}: "
                  f"{err} vs 1e-5·{scale}")
            if variant in ("full", "no_merge"):
                hb = histogram(ids, vals, S)
                nz = hb > 0
                rel = float(((got - hb).abs()[nz] / hb[nz]).max())
                check(rel <= 1e-5 and bool((got[~nz] == 0).all()),
                      f"probe {variant} at {label} vs B2: rel {rel}")
                worst = max(worst, float((got - hb).abs().max()))
            variant_dev[variant] = device_ms(
                lambda: hist_variant(ids, vals, S, variant))
        turns = {}
        for who in PROBE_TURNS:
            turns.setdefault(who, []).append(device_ms(
                (lambda: histogram(ids, vals, S)) if who == "histogram"
                else (lambda: hist_variant(ids, vals, S, "full")), 50))
        off = median(turns["full"]) / median(turns["histogram"]) - 1.0
        check(abs(off) <= PROBE_TOL, f"probe full at {label} is {off:+.2%} "
              f"off histogram()'s device time (turns {turns})")
        ok_ids = (ids >= 0) & (ids < S)
        shapes[label] = dict(
            at=f"ids ({rows}, {m}) → {S} bins", hist_route=route,
            max_abs_err=worst, variants_device_ms=variant_dev,
            gap_to_full_device_ms={v: variant_dev["full"] - t
                                   for v, t in variant_dev.items()
                                   if v != "full"},
            in_turns_device_ms=turns, full_off_histogram=off,
            **bound(8 * ids.numel() + 4 * rows * S, float(ok_ids.sum())))
        lines.append(
            f"probe at {label} ({rows} × {m} → {S}, route {route}): device "
            + ", ".join(f"{v} {t:.4f}" for v, t in variant_dev.items())
            + f" ms; full vs histogram() in turns {turns} ({off:+.2%}); "
            f"bound {shapes[label]['bound_ms']:.4f} "
            f"{shapes[label]['bound_by']}")
    ids, vals, S = cases[0][1:]
    ok_ids = (ids >= 0) & (ids < S)
    flat = (torch.where(ok_ids, ids, S).long()
            + (torch.arange(ids.shape[0], device=dev) * (S + 1))[:, None]
            ).reshape(-1)
    vals0 = torch.where(ok_ids, vals, 0.0).reshape(-1)
    print("kernels probe (B2 with one stage out): " + "; ".join(lines),
          flush=True)
    return dict(
        shapes["probe"],
        **times(lambda: hist_variant(ids, vals, S, "full"),
                lambda: hist_variant_plain(ids, vals, S, "full"),
                lambda: torch.zeros(ids.shape[0] * (S + 1),
                                    device=dev).index_add_(0, flat, vals0)),
        shapes=shapes)


def kernels_fused(dev, pipe: Pipeline, p) -> dict:
    """B6 by route, and the probe, on the 16 s signal's frames and ids."""
    x = torch.from_numpy(signal(SECONDS, seed=1)).to(dev)
    res = kernels_b6(dev, pipe, p, x)
    res["hist_variant"] = kernels_probe(dev, pipe, p, x)
    return res


def kernels_multires(dev) -> dict:
    """B1's windowed form at each bank of the display default (16 s, 5,937
    frames a bank) against its plain version (float64 plain deciding
    where float32 plain's rounding flipped a deposit) and at b = 1, and
    its window against the whole spectrum's slice bit for bit, beside the
    pruned-DFT product that could take its place: the spectra alone
    (``stft_triple_stencil_sliced`` on the frames, ``_blocks`` on the hop
    blocks, the library column) and the blocks product's whole route to
    ids (corrections and quantization in PyTorch)."""
    pipe = Pipeline(MULTIRES, dev)
    p = pipe.params()
    x = torch.from_numpy(signal(SECONDS, seed=1)).to(dev)
    t = pipe.num_columns(x.shape[-1])
    inputs = pipe._bank_inputs(x, t)
    scal = (p.logmap_a, p.logmap_b, p.power_floor)
    rows, R = pipe.rows, pipe.reach
    banks, lines = {}, []
    for b, (frames, n) in enumerate(zip(inputs, pipe.sizes)):
        k_lo, k_hi = pipe.k_slices[b]
        band = p.band_bins[b]
        kw = dict(n=n, hop=pipe.hop, sr=float(SR), rows=rows, reach=R,
                  k_lo=k_lo, k_hi=k_hi, band=band)
        ik, ck = deposits_ids(frames, *scal, **kw)
        ip, cp = deposits_ids_plain(frames, *scal, **kw)
        # where float32 plain's rounding flipped a deposit (the low bins'
        # rows are 2.7 to a bin, so a last-ulp f̂ moves a row), float64
        # plain decides, as in tests/test_torch_cuda.py
        i64, c64 = deposits_ids_plain(frames.double(), *scal, **kw)
        settled = (ik != ip) & (ik == i64) & ((ck > 0) == (c64 > 0))
        print(f"B1 window n={n}: {int((ik != ip).sum())} ids differ from "
              f"float32 plain, {int(settled.sum())} of them as float64 "
              f"plain has them", flush=True)
        ip = torch.where(settled, i64, ip)
        cp = torch.where(settled, c64.float(), cp)
        del i64, c64
        err = check_b1(f"B1 window [{k_lo}, {k_hi}) n={n} b={t}", ik, ck,
                       ip, cp, n=n, rows=rows, R=R, k_lo=k_lo, band=band)
        check_b1_single("B1 window", frames, ik, ck, scal, kw)
        whole = deposits_ids(frames, *scal, **dict(kw, k_lo=0, k_hi=None,
                                                  band=None))
        unweighted = deposits_ids(frames, *scal, **dict(kw, band=None))
        check(torch.equal(unweighted[0], whole[0][..., k_lo:k_hi])
              and torch.equal(unweighted[1], whole[1][..., k_lo:k_hi])
              and torch.equal(ik, unweighted[0]),
              f"B1 n={n}: the window is not the whole spectrum's slice")
        x2 = signal_blocks_of(pipe, x, b, t)
        one = frames[:1]

        def pruned_route():       # the JAX package's TPU route to ids
            row, delta, contrib = quantize_deposits(
                *reassignment_corrections(*stft_triple_stencil_blocks(
                    x2, t, n, k_lo, k_hi)), *scal, n=n, hop=pipe.hop,
                sr=float(SR), rows=rows, band=band, k_lo=k_lo)
            return (delta + R) * rows + row, contrib
        gi, gc = pruned_route()
        g = compare_grids(histogram_plain(ip, cp, (2 * R + 1) * rows).reshape(
            -1, 2 * R + 1, rows), histogram_plain(gi, gc, (
                2 * R + 1) * rows).reshape(-1, 2 * R + 1, rows))
        check(g.ok, f"pruned-DFT route n={n} vs plain B1: {g}")
        row = dict(
            at=f"frames ({t}, {n}), bins [{k_lo}, {k_hi})", max_abs_err=err,
            **times(lambda: deposits_ids(frames, *scal, **kw),
                    lambda: deposits_ids_plain(frames, *scal, **kw),
                    lambda: stft_triple_stencil_sliced(frames, k_lo, k_hi),
                    iters=5, warmup=2, calls=5),
            **b1_window_bound(frames, k_hi - k_lo),
            library="pruned-DFT product, the spectra alone "
                    "(stft_triple_stencil_sliced)",
            blocks_device_ms=device_ms(lambda: stft_triple_stencil_blocks(
                x2, t, n, k_lo, k_hi), calls=5),
            blocks_ms=cuda_ms(lambda: stft_triple_stencil_blocks(
                x2, t, n, k_lo, k_hi), 5, 2),
            pruned_route_device_ms=device_ms(pruned_route, calls=5),
            pruned_route_ms=cuda_ms(pruned_route, 5, 2),
            device_ms_b1=device_ms(lambda: deposits_ids(one, *scal, **kw)),
            library_device_ms_b1=device_ms(
                lambda: stft_triple_stencil_sliced(one, k_lo, k_hi)),
            bound_ms_b1=b1_window_bound(one, k_hi - k_lo)["bound_ms"])
        banks[n] = row
        lines.append(
            f"n={n} bins [{k_lo}, {k_hi}) b={t}: B1 device "
            f"{row['device_ms']:.4f} ms (events {row['ms']:.4f}, plain "
            f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"{row['bound_by']}); pruned DFT spectra alone device "
            f"{row['library_device_ms']:.4f} (sliced; events "
            f"{row['library_ms']:.4f}), {row['blocks_device_ms']:.4f} "
            f"(blocks; events {row['blocks_ms']:.4f}), its route to ids "
            f"{row['pruned_route_device_ms']:.4f} (events "
            f"{row['pruned_route_ms']:.4f}); b = 1: B1 "
            f"{row['device_ms_b1']:.4f}, sliced {row['library_device_ms_b1']:.4f}")
    print("kernels B1 windowed (display default): " + "; ".join(lines),
          flush=True)
    return dict(banks[max(banks)], banks=banks)


def signal_blocks_of(pipe: Pipeline, x, bank: int, t: int):
    """Bank ``bank``'s hop blocks of ``x`` (``signal_blocks``), the
    pruned-DFT product's input, over the samples of its frames."""
    n, off = pipe.sizes[bank], pipe.offsets[bank]
    return signal_blocks(x[..., off:off + (t - 1) * pipe.hop + n], n,
                         pipe.hop)


# the display default's batch scatters in turns, the one scatter="auto"
# takes within 5% of the fastest by the medians; three rounds, as the
# probe's turns and for the same reason
SCATTER_TURNS = ("a", "b", "c", "c", "b", "a") * 3


def multires_scatter(dev) -> dict:
    """The batch scatters of the display default on 16 s, each with the
    three B1 launches before it: (a) one relative B2 over 65 × 512 cells
    and the fold, (b) the JAX package's mixed scatter (``_scatter_mixed``,
    composed here from the pipeline's parts): each bank with its own
    reach R_b, summed per frame and folded where that measured faster
    here, the other banks into one absolute-grid B2, (c) one
    absolute-grid B2 over 5,937 × 512; each bank's two options, B1 aside
    (its cost is the same in both); and the one ``scatter="auto"`` runs,
    which must be the fastest in turns (within 5%: (b) with no relative
    bank runs (c)'s operations).  All held to (a) by the grid rule."""
    pipe = Pipeline(MULTIRES, dev)
    p = pipe.params()
    x = torch.from_numpy(signal(SECONDS, seed=1)).to(dev)
    t = pipe.num_columns(x.shape[-1])
    inputs = pipe._bank_inputs(x, t)
    R = pipe.reach
    reaches = [int(np.round(n / (2.0 * pipe.hop))) for n in pipe.sizes]
    per_bank = {}
    own = pipe._bank_ids(inputs, p, reaches)
    shared = pipe._bank_ids(inputs, p, [R] * len(pipe.sizes))
    for (oi, oc), (si, sc), n, R_b in zip(own, shared, pipe.sizes, reaches):
        per_bank[n] = dict(
            cells=(2 * R_b + 1) * pipe.rows,
            relative=device_ms(lambda: pipe._scatter_relative(
                oi, oc, t, R_b), calls=5),
            absolute=device_ms(lambda: pipe._scatter_absolute(
                pipe._absolute_ids(si, t, R), sc, t), calls=5))
    best = [v["relative"] < v["absolute"] for v in per_bank.values()]
    tpu_shaped = [(2 * R_b + 1) * pipe.rows <= 16384 for R_b in reaches]

    def mixed(relative):
        banks = [R_b if rel else R for R_b, rel in zip(reaches, relative)]
        banked = pipe._bank_ids(inputs, p, banks)
        parts = [pipe._scatter_relative(ids, c, t, R_b)
                 for (ids, c), R_b, rel in zip(banked, banks, relative)
                 if rel]
        absolute = [part for part, rel in zip(banked, relative) if not rel]
        if absolute:
            ids, c = (torch.cat(a, dim=-1) for a in zip(*absolute))
            parts.append(pipe._scatter_absolute(
                pipe._absolute_ids(ids, t, R), c, t))
        return sum(parts[1:], parts[0])

    def absolute():
        ids, c = pipe._deposit_ids_rel(inputs, p)
        return pipe._scatter_absolute(pipe._absolute_ids(ids, t, R), c, t)
    options = {
        "a": lambda: pipe._scatter_relative(
            *pipe._deposit_ids_rel(inputs, p), t),
        "b": lambda: mixed(best),
        "b_tpu_choice": lambda: mixed(tpu_shaped),
        "c": absolute,
    }
    want = options["a"]()
    for name, fn in options.items():
        g = compare_grids(want, fn())
        check(g.ok, f"multires scatter {name} vs (a): {g}")
    turns = {}
    for name in SCATTER_TURNS:
        turns.setdefault(name, []).append(device_ms(options[name], calls=5))
    median = {k: float(np.median(v)) for k, v in turns.items()}
    auto = "a" if pipe.use_relative_batch else "c"
    out = dict(per_bank=per_bank, best_relative=best,
               tpu_relative=tpu_shaped, in_turns_device_ms=turns,
               b_tpu_choice_device_ms=device_ms(options["b_tpu_choice"],
                                                calls=5),
               auto_takes=auto)
    print(f"multires batch scatter, B1 included (device ms, 16 s, in turns "
          f"a b c c b a, three rounds): {turns}; per bank, scatter alone {per_bank}; (b) "
          f"relative banks {best} (TPU choice {tpu_shaped}: "
          f"{out['b_tpu_choice_device_ms']:.4f}); scatter=\"auto\" with "
          f"exact_sums=False runs ({auto})", flush=True)
    check(median[auto] <= 1.05 * min(median.values()),
          f"scatter=\"auto\" runs ({auto}), medians in turns {median}")
    return out


# The batch post chain's two scans at each path's shape: (label, t, C, α,
# W forced), α the smoothing slider (a 0-d device tensor: 0.6, or the
# display default's 0) or the AGC's decay (a float): multires 16 s at hop
# 128, batch16 (16 channels × 512 rows), wide, the AGC series mono and at
# 16 channels, the edge cases, and W forced to 0 (every chunk repaired).
EMA_CASES = (("multires smoothing", 5937, 512, "slider", None),
             ("multires smoothing, α = 0", 5937, 512, "default", None),
             ("batch16 smoothing", 372, 16 * 512, "slider", None),
             ("wide smoothing", 1437, 512, "slider", None),
             ("multires AGC", 5937, 1, "agc", None),
             ("batch16 AGC", 372, 16, "agc", None),
             ("t = 0", 0, 512, "slider", None),
             ("t = 1", 1, 512, "slider", None),
             ("multires AGC, forced repair", 5937, 1, "agc", 0),
             ("wide smoothing, forced repair", 1437, 512, "slider", 0))
SLIDER = {"slider": 0.6, "default": 0.0}


def scan_chain_bound(t: int, c: int, alpha: float, window=None) -> float:
    """The chunk-parallel scan's chain bound in ms: its longest chunk's
    warm-up and own steps, min(W, s) + L dependent steps of
    ``STEP_CYCLES`` at the top SM clock (every chunk's own steps after a
    forced W = 0, the repair's walk not counted)."""
    if t == 0:
        return 0.0
    L = ema.chunk_len(t, c)
    s_last = (-(-t // L) - 1) * L
    w = ema.window_len(alpha, s_last, window) if s_last else 0
    return (min(L, t) + w) * STEP_CYCLES / SM_CLOCK_HZ[0] * 1e3


def repaired_during(dev, fn) -> int:
    """The chunks the scans repaired during one call of ``fn``."""
    counter = ema.repair_counter(dev)
    counter.zero_()
    fn()
    torch.cuda.synchronize()
    return int(counter.item())


def kernels_ema(dev) -> dict:
    """The scan kernel against its plain loop on the card, bit for bit, at
    every case; its time, the plain loop's, the bytes bound (b read and
    ys written once), the chain bound (``scan_chain_bound``) beside the
    sequential walk's (t steps), the chunks its speculation left to the
    repair, and the associative form's device time and largest difference
    from the sequential form relative to max|ys|."""
    rng = np.random.default_rng(11)
    shapes, lines, worst = {}, [], 0.0
    for label, t, c, kind, window in EMA_CASES:
        xs = torch.from_numpy(rng.uniform(0, 1, (t, c)).astype(
            np.float32)).to(dev)
        y0 = torch.from_numpy(rng.uniform(0, 1, c).astype(np.float32)).to(dev)
        a = SLIDER.get(kind, chain.AGC_DECAY)
        alpha = (torch.tensor(np.float32(a), device=dev) if kind in SLIDER
                 else a)
        b = (1.0 - alpha) * xs

        def run():
            return ema_scan(y0, alpha, b, window=window)
        repaired = repaired_during(dev, run)
        ys, fin = run()
        ps, pfin = ema_scan_plain(y0, alpha, b)
        check(torch.equal(ys, ps) and torch.equal(fin, pfin),
              f"ema_scan {label} ({t}, {c}) differs from its plain loop")
        check(window is None or repaired == (-(-t // ema.chunk_len(t, c))
                                             - 1) * c,
              f"ema_scan {label}: {repaired} chunks repaired, not every one")
        worst = max(worst, float((ys - ps).abs().max()) if t else 0.0)
        row = dict(
            at=f"b ({t}, {c}), α {kind}"
               + ("" if window is None else f", W forced {window}"),
            max_abs_err=0.0 if t == 0 else float((ys - ps).abs().max()),
            ms=cuda_ms(run),
            plain_ms=cuda_ms(lambda: ema_scan_plain(y0, alpha, b), iters=2,
                             warmup=1),
            library_ms=None, library_device_ms=None,
            device_ms=device_ms(run),
            **bound(8.0 * t * c + 8.0 * c, 2.0 * t * c),
            chain_bound_ms=scan_chain_bound(t, c, a, window),
            sequential_chain_bound_ms=t * STEP_CYCLES / SM_CLOCK_HZ[0] * 1e3,
            chunk_len=ema.chunk_len(t, c), repaired_chunks=repaired,
            boundaries=max(-(-t // ema.chunk_len(t, c)) - 1, 0) * c)
        if t > 1 and window is None:
            a_ys, _ = chain._ema_scan(y0, alpha, xs, True)
            s_ys, _ = chain._ema_scan(y0, alpha, xs, False)
            row["associative_device_ms"] = device_ms(
                lambda: chain._ema_scan(y0, alpha, xs, True), calls=5)
            row["associative_max_rel_diff"] = float(
                (a_ys - s_ys).abs().max() / s_ys.abs().max())
        shapes[label] = row
        lines.append(
            f"{label} ({t}, {c}): device {row['device_ms']:.4f} ms, bytes "
            f"bound {row['bound_ms']:.4f}, chain bound "
            f"{row['chain_bound_ms']:.4f} (sequential "
            f"{row['sequential_chain_bound_ms']:.4f}), L {row['chunk_len']}, "
            f"repaired {repaired} of {row['boundaries']} chunks, plain "
            f"{row['plain_ms']:.4f} ms"
            + (f", associative form device {row['associative_device_ms']:.4f}"
               f" ms, rel diff {row['associative_max_rel_diff']:.2e}"
               if "associative_device_ms" in row else ""))
    print("kernels ema_scan (bit-equal to the plain loop at every case): "
          + "; ".join(lines), flush=True)
    return dict(shapes["multires smoothing, α = 0"], max_abs_err=worst,
                shapes=shapes)


# The fused chain's kernels on each batch path's own power (16 s mono
# unless said): (label, settings, channels, smoothing); above 0.5 the
# tail's kernel takes its pipelined form
POST_CASES = (("multires", MULTIRES, 1, 0.0),
              ("multires, smoothing 0.6", MULTIRES, 1, 0.6),
              ("multires, smoothing 0.9", MULTIRES, 1, 0.9),
              ("multires, smoothing 0.99", MULTIRES, 1, 0.99),
              ("batch", SETTINGS, 1, 0.0),
              ("batch, smoothing 0.6", SETTINGS, 1, 0.6),
              ("batch16", SETTINGS, CHANNELS, 0.0))


def post_tail_chain_bound(t: int, c: int, smoothing: float) -> float:
    """``post_tail``'s chain bound in ms: the pipelined form's whole
    column, t steps of ``STEP_CYCLES``, above smoothing 0.5; else the
    chunk-parallel scan's (``scan_chain_bound``)."""
    if pipelined(smoothing):
        return t * STEP_CYCLES / SM_CLOCK_HZ[0] * 1e3
    return scan_chain_bound(t, c, smoothing)


def kernels_post(dev) -> dict:
    """``post_head`` and ``post_tail`` against their plain versions on the
    card, bit for bit, on each case's real power (the path's grid, columns
    first), ``post_tail`` also with W forced to 0 (the chunk-parallel form
    at every smoothing), and the batch chain against the live step's
    column by column, bit for bit (vis and both states); their times, the
    plain versions' (torch's eager stages), the bytes bounds (head: power
    read, the peak written; tail: power and refs read, vis written, the
    state read and written) and shares, the tail's form and chain bound
    (``post_tail_chain_bound``), and the chunks the tail's speculation
    left to the repair — none in the pipelined form (the run fails
    otherwise).  No PyTorch call computes either."""
    head, tail, lines = {}, {}, []
    for label, settings, channels, smoothing in POST_CASES:
        s = settings.replace(channels=channels, smoothing=smoothing)
        pipe = Pipeline(s, dev)
        pp = pipe.params()
        p = pp.post
        x = signal(SECONDS, channels, seed=5)
        xg = pipe.to_device(x)
        t = pipe.num_columns(x.shape[-1])
        cols = pipe._enhanced_power(xg, t, pp).movedim(-2, 0).contiguous()
        lead, rows = cols.shape[1:-1], cols.shape[-1]
        c = math.prod(cols.shape[1:])
        coef = 1.0 - chain.AGC_DECAY
        got = post_head(cols, p.low_end_ramp, p.gain, coef)
        want = post_head_plain(cols, p.low_end_ramp, p.gain, coef)
        check(torch.equal(got, want), f"post_head {label} differs from its "
              f"plain version")
        refs, _ = ema_scan(PostState.init(cols.shape[1:], dev).agc_ref,
                           chain.AGC_DECAY, got)
        y0 = torch.zeros(cols.shape[1:], device=dev)
        want_t = post_tail_plain(cols, refs, y0, p)
        counts = {}
        for window in (None, 0):
            def run():
                return post_tail(cols, refs, y0, p, window=window)
            counts[window] = repaired_during(dev, run)
            check(all(torch.equal(g, w) for g, w in zip(run(), want_t)),
                  f"post_tail {label} (W {window}) differs from its plain "
                  f"version")
        form = "pipelined" if pipelined(smoothing) else "chunk-parallel"
        check(form == "chunk-parallel" or counts[None] == 0,
              f"post_tail {label}: the pipelined form repaired "
              f"{counts[None]} chunks")
        # the batch chain against the live step's, column by column
        st0 = PostState.init(cols.shape[1:], dev)
        batch, bst = postprocess_batch(cols, st0, p, s.agc_global)
        st, outs = st0, []
        for i in range(t):
            out, st = chain.postprocess_column(cols[i], st, p, s.agc_global)
            outs.append(out)
        check(torch.equal(batch, torch.stack(outs))
              and torch.equal(bst.smooth, st.smooth)
              and torch.equal(bst.agc_ref, st.agc_ref),
              f"post chain {label}: batch differs from column by column")
        L = ema.chunk_len(t, c)
        head[label] = dict(
            at=f"power ({t}, {c}) → peak ({t}, {math.prod(lead)})",
            max_abs_err=0.0,
            **times(lambda: post_head(cols, p.low_end_ramp, p.gain, coef),
                    lambda: post_head_plain(cols, p.low_end_ramp, p.gain,
                                            coef)),
            **bound(4.0 * t * c + 4.0 * t * math.prod(lead) + 4.0 * rows,
                    6.0 * t * c))
        tail[label] = dict(
            at=f"power ({t}, {c}), smoothing {smoothing}", max_abs_err=0.0,
            **times(lambda: post_tail(cols, refs, y0, p),
                    lambda: post_tail_plain(cols, refs, y0, p), iters=5,
                    warmup=1),
            **bound(8.0 * t * c + 4.0 * t * math.prod(lead) + 8.0 * c,
                    14.0 * t * c),
            chain_bound_ms=post_tail_chain_bound(t, c, smoothing),
            form=form, chunk_len=L, repaired_chunks=counts[None],
            forced_repair_chunks=counts[0],
            forced_repair_device_ms=device_ms(
                lambda: post_tail(cols, refs, y0, p, window=0), calls=5),
            boundaries=(-(-t // L) - 1) * c)
        h, r = head[label], tail[label]
        lines.append(
            f"{label} ({t}, {c}): post_head device {h['device_ms']:.4f} ms "
            f"(bound {h['bound_ms']:.4f}, plain {h['plain_ms']:.4f}); "
            f"post_tail {form} device {r['device_ms']:.4f} ms (bytes bound "
            f"{r['bound_ms']:.4f}, share "
            f"{100.0 * r['bound_ms'] / r['device_ms']:.1f}%, chain bound "
            f"{r['chain_bound_ms']:.4f}, plain {r['plain_ms']:.4f}), L {L}, "
            f"repaired {counts[None]} of {r['boundaries']} chunks; forced "
            f"W = 0: {counts[0]} repaired, device "
            f"{r['forced_repair_device_ms']:.4f} ms")
    print("kernels post_head and post_tail (bit-equal to their plain "
          "versions on each path's power; the batch chain bit-equal to the "
          "column-by-column chain): " + "; ".join(lines), flush=True)
    return {"post_head": dict(head["multires"], shapes=head),
            "post_tail": dict(tail["multires"], shapes=tail)}


def raster_ids(dev, settings: Settings, x: np.ndarray):
    """The single-bank raster's absolute ids t_bin·K + f_bin (−1 where the
    deposit is dropped) and powers on ``x``, as ``dsp.reassign`` makes
    them on the card, and the grid's cell count."""
    n, hop = settings.fft_size, settings.hop_samples
    X = stft_triple(torch.from_numpy(x).to(dev), n, hop, "direct")
    t = X[0].shape[-2]
    t_bin, f_bin, p = reassigned_bins(*reassignment_corrections(*X), n, hop,
                                      t)
    ids = torch.where(p != 0, t_bin * (n // 2 + 1) + f_bin, -1)
    return ids.reshape(-1).contiguous(), p.reshape(-1).contiguous(), \
        t * (n // 2 + 1)


SORTED_TURNS = ("sort", "tiles", "tiles", "sort") * 3


def kernels_b2_batch(dev) -> dict:
    """B2's sorted route in its batch form at the main path's shape (the
    enhanced batch at 8192, mono, 16 s: the absolute (t, rows) grid of its
    B1 ids, R = the pipeline's reach): bit-equal to the plain sum on the
    CPU, added into an output too, the same on a second run; its time
    beside the plain version's and ``index_add_``'s, with the bytes' bound
    and the chain bound (the longest cell's run at ``CHAIN_CYCLES`` a
    dependent add).  Every batch cell's forms are timed in ``batch_ab``."""
    pipe = Pipeline(SETTINGS, dev)
    xg = pipe.to_device(signal(SECONDS, seed=23))
    t = pipe.num_columns(xg.shape[-1])
    ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_inputs(xg, t),
                                             pipe.params())
    ids = pipe._absolute_ids(ids_rel, t, pipe.reach).reshape(-1).contiguous()
    vals = contrib.reshape(-1).contiguous()
    k, cells = ids_rel.shape[-1], t * pipe.rows
    bound_kw = dict(route=SORTED, reach=pipe.reach, frame_len=k,
                    column_len=pipe.rows, form="batch")

    def batch(out=None):
        return histogram(ids, vals, cells, out=out, **bound_kw)
    before = histogram.route_launches[SORTED_BATCH]
    got = batch()
    check(histogram.route_launches[SORTED_BATCH] == before + 1,
          "B2 sorted batch: no launch of the batch form")
    want = histogram_plain(ids.cpu(), vals.cpu(), cells)
    check(torch.equal(got.cpu(), want),
          "B2 sorted batch differs from the plain sum in deposit order")
    check(torch.equal(batch(), got), "B2 sorted batch differs between two "
          "runs")
    base = torch.rand(cells, device=dev)
    check(torch.equal(batch(base.clone()).cpu(), histogram_plain(
        ids.cpu(), vals.cpu(), cells, out=base.cpu())),
          "B2 sorted batch added into an output differs from the plain sum")
    ok = (ids >= 0) & (ids < cells)
    flat = torch.where(ok, ids, cells).long()
    vals0 = torch.where(ok, vals, 0.0)
    run = int(torch.bincount(flat, minlength=cells + 1)[:cells].max())
    plan = batch_plan(t, k, pipe.reach, pipe.rows)
    row = dict(
        at=f"ids (1, {ids.numel()}) → {cells} cells, reach {pipe.reach}, "
           f"{k} deposits a frame into {pipe.rows} rows",
        max_abs_err=0.0,
        **times(batch, lambda: histogram_plain(ids, vals, cells),
                lambda: torch.zeros(cells + 1, device=dev).index_add_(
                    0, flat, vals0), iters=10),
        **bound(8.0 * ids.numel() + 4.0 * cells, float(ok.sum())),
        longest_run=run,
        chain_bound_ms=run * CHAIN_CYCLES / SM_CLOCK_HZ[0] * 1e3,
        plan=plan)
    print(f"kernels B2 sorted batch at the batch's ids ({row['at']}; "
          f"{plan['cols']}-column tiles, {plan['col_tiles']} of them, "
          f"{plan['bands']} row band(s), {plan['cap']} entries a piece): "
          f"bit-equal to the plain sum, "
          f"added into an output and run to run; device "
          f"{row['device_ms']:.4f} ms, index_add_ "
          f"{row['library_device_ms']:.4f}, plain {row['plain_ms']:.4f}, "
          f"bound {row['bound_ms']:.4f} (bytes), chain "
          f"{row['chain_bound_ms']:.4f} (run {run})", flush=True)
    return row


def kernels_b2_tiles(dev, ids, vals, cells: int, want) -> dict:
    """B2's sorted route in its tiles form (the raster's, at its reach)
    at the raster's ids: bit-equal to the plain sum on the CPU, added
    into an output too, the same on a second run; timed in turns with the
    global-sort form it replaced (medians of three rounds), which must be
    the slower."""
    n, hop = RASTER.fft_size, RASTER.hop_samples
    k, reach = n // 2 + 1, -(-n // (2 * hop))
    bound_kw = dict(reach=reach, frame_len=k)

    def tiles(out=None):
        return histogram(ids, vals, cells, route=SORTED, out=out, **bound_kw)
    before = histogram.route_launches[SORTED_TILES]
    got = tiles()
    check(histogram.route_launches[SORTED_TILES] == before + 1,
          "B2 sorted tiles: no launch of the tiles form")
    check(torch.equal(got.cpu(), want),
          "B2 sorted tiles differ from the plain sum in deposit order")
    check(torch.equal(tiles(), got), "B2 sorted tiles differ between two runs")
    base = torch.rand(cells, device=dev)
    check(torch.equal(tiles(base.clone()).cpu(), histogram_plain(
        ids.cpu(), vals.cpu(), cells, out=base.cpu())),
          "B2 sorted tiles added into an output differ from the plain sum")
    turns: dict = {}
    for r in SORTED_TURNS:
        turns.setdefault(r, []).append(device_ms(
            tiles if r == "tiles"
            else lambda: histogram(ids, vals, cells, route=SORTED)))
    med = {r: float(np.median(v)) for r, v in turns.items()}
    check(med["tiles"] < med["sort"],
          f"B2 sorted: the tiles form is not faster than the sort form "
          f"({med})")
    flat = torch.where(ids >= 0, ids, cells).long()
    vals0 = torch.where(ids >= 0, vals, 0.0)
    plan = tile_plan(cells // k, k, reach)
    row = dict(
        at=f"ids (1, {ids.numel()}) → {cells} bins, reach {reach}",
        max_abs_err=0.0,
        **times(tiles, lambda: histogram_plain(ids, vals, cells),
                lambda: torch.zeros(cells + 1, device=dev).index_add_(
                    0, flat, vals0), iters=10),
        **bound(8.0 * ids.numel() + 4.0 * cells, float((ids >= 0).sum())),
        turns_device_ms=turns, median=med,
        tile=f"{plan['cols']} × {plan['cells']}, {plan['col_tiles']} "
             f"tiles, {plan['walk']} frames walked")
    print(f"kernels B2 sorted tiles at the raster's ids ({ids.numel()} → "
          f"{cells}, reach {reach}, tiles {row['tile']}): bit-equal to the "
          f"plain sum, added into an output and run to run; device "
          f"{row['device_ms']:.4f} ms, in turns with the sort form "
          f"{SORTED_TURNS}: medians {med}; index_add_ "
          f"{row['library_device_ms']:.4f}, bound {row['bound_ms']:.4f}",
          flush=True)
    return row


def kernels_b2_sorted(dev) -> dict:
    """B2's sorted route at the raster's ids (8192, hop 2048, 16 s) in
    the global-sort form (no window bound): bit-equal to the plain sum on
    the CPU (each cell in deposit order), the same on a second run; its
    time beside the global route's (atomics: another order each run) and
    index_add_.  Then the tiles form (``kernels_b2_tiles``)."""
    ids, vals, cells = raster_ids(dev, RASTER, signal(SECONDS, seed=17))
    got = histogram(ids, vals, cells, route=SORTED)
    want = histogram_plain(ids.cpu(), vals.cpu(), cells)
    check(torch.equal(got.cpu(), want),
          "B2 sorted route differs from the plain sum in deposit order")
    check(torch.equal(histogram(ids, vals, cells, route=SORTED), got),
          "B2 sorted route differs between two runs")
    flat = torch.where(ids >= 0, ids, cells).long()
    vals0 = torch.where(ids >= 0, vals, 0.0)

    def index_put():
        return torch.zeros(cells + 1, device=dev).index_put_(
            (flat,), vals0, accumulate=True)
    put = index_put()[:cells]
    row = dict(
        at=f"ids (1, {ids.numel()}) → {cells} bins", max_abs_err=0.0,
        **times(lambda: histogram(ids, vals, cells, route=SORTED),
                lambda: histogram_plain(ids, vals, cells),
                lambda: torch.zeros(cells + 1, device=dev).index_add_(
                    0, flat, vals0), iters=10),
        **bound(8.0 * ids.numel() + 4.0 * cells, float((ids >= 0).sum())),
        global_route_device_ms=device_ms(
            lambda: histogram(ids, vals, cells, route="global")),
        # the deterministic library call (index_add_ sums in another order
        # each run): its time, and whether it gives the plain sum's bits
        index_put_ms=cuda_ms(index_put, iters=10),
        index_put_device_ms=device_ms(index_put),
        index_put_equals_plain=bool(torch.equal(put.cpu(), want)),
        index_put_repeats=bool(torch.equal(index_put()[:cells], put)))
    print(f"kernels B2 sorted route at the raster's ids ({ids.numel()} → "
          f"{cells}): bit-equal to the plain sum and run to run; device "
          f"{row['device_ms']:.4f} ms (global route "
          f"{row['global_route_device_ms']:.4f}, index_add_ "
          f"{row['library_device_ms']:.4f}, index_put_(accumulate=True) "
          f"{row['index_put_device_ms']:.4f}, events "
          f"{row['index_put_ms']:.4f}; equal to the plain sum "
          f"{row['index_put_equals_plain']}, to itself on a second run "
          f"{row['index_put_repeats']}), bound {row['bound_ms']:.4f} ms",
          flush=True)
    return row, kernels_b2_tiles(dev, ids, vals, cells, want)


# the live cells whose hops B2 sums: settings, the signal's channels,
# seconds and rate (``kernels_b2_ring``): one lane, two (a stereo live
# cell) and sixteen
RING_CELLS = (("live", SETTINGS, 1, SECONDS, SR),
              ("live_2ch", SETTINGS, 2, 4.0, SR),
              ("direct_live", DIRECT, 1, 4.0, SR),
              ("multires_live", MULTIRES, 1, 4.0, SR),
              ("north_live", NORTH, 1, 4.0, SR),
              ("stress_live", STRESS, CHANNELS, 4.0, 96000),
              ("wide_live", WIDE, 1, 2.0, SR))
B2_RING_TURNS = ("atomic", "ring", "ring", "atomic") * 3
RING_SHORT_HOPS = 8     # a stream this many columns long (and the 16 s runs)


def kernels_b2_ring(dev) -> dict:
    """B2's ring form at each live cell's hop (frame ``mid`` of the batch's
    B1 ids, bit-equal to B1 at b = 1, the relative ids the live step hands
    it, its ring cells computed in the kernel from them and ``t``):
    bit-equal to its plain version (``histogram_ring_plain`` of
    ``ring_ids``) on the CPU into a ring of random values at t = 0 … P + 1
    and far along (the drop of the columns below 0, the slot wrap), with
    NaN/Inf behind dropped and out-of-range ids, the same on a second run,
    at the plan's cluster size and every other one the card holds; its
    device time in turns with the atomic route the ``exact_sums=False``
    hop takes at the same hop (its relative histogram, medians of three
    rounds), and by cluster size; beside ``index_add_`` and the
    deterministic ``index_put_(accumulate=True)`` at the same ring
    offsets.  Then a default ``Stream`` of ``RING_SHORT_HOPS`` columns
    bit-equal to the default batch (the live phases run 16 s)."""
    shapes, lines = {}, []
    for name, s, ch, seconds, sr in RING_CELLS:
        ids_rel, contrib, S = relative_ids(dev, s, signal(
            seconds, ch, seed=21, sr=sr))
        pipe = Pipeline(s.replace(channels=ch), dev)
        mid = ids_rel.shape[-2] // 2
        rel = ids_rel[..., mid, :].contiguous()
        vals = contrib[..., mid, :].contiguous()
        P, C, k = 2 * pipe.reach + 1, pipe.rows, rel.shape[-1]
        lanes = rel[..., 0].numel()
        ring0 = torch.rand((P,) + rel.shape[:-1] + (C,), device=dev)
        rng = np.random.default_rng(len(name))
        pick = torch.from_numpy(rng.random(tuple(rel.shape)) < 0.1).to(dev)
        bad_ids = torch.where(pick, torch.where(rel % 2 == 0, -1, P * C + 7),
                              rel).to(torch.int32)
        bad_vals = torch.where(pick, torch.where(
            rel % 3 == 0, float("inf"), float("nan")), vals)
        plan = ring_plan(k, P, C, lanes=lanes, clusters16=ring_occupancy(
            k, P, C, 16, lanes) if ring_plan(k, P, C, 16, lanes)["fits"]
            else 0)
        sizes = [(c, local) for local in (False, True)
                 for c in (1, 2, 4, 8, 16)
                 if ring_plan(k, P, C, c, lanes, local=local)["fits"]
                 and (local or ring_occupancy(k, P, C, c, lanes) > 0)]
        checked = 0
        for t in sorted({0, 1, pipe.reach, P - 1, P, P + 1, mid, 100_003}):
            t_dev = torch.tensor(t, dtype=torch.int32, device=dev)
            for ids, v in ((rel, vals), (bad_ids, bad_vals)):
                want = histogram_ring_plain(ring_ids(ids.cpu(), t, P, C),
                                            v.cpu(), ring0.cpu().clone())
                for cluster, local in [(None, None)] + sizes:
                    before = histogram.route_launches[SORTED_RING]
                    got = histogram_ring(ids, v, ring0.clone(), t_dev,
                                         cluster=cluster, local=local)
                    check(histogram.route_launches[SORTED_RING]
                          == before + 1, f"B2 ring form at {name}: no "
                          f"launch of the ring form")
                    check(torch.equal(got.cpu(), want)
                          and bool(torch.isfinite(got).all()),
                          f"B2 ring form at {name}, t = {t}, "
                          f"{cluster or plan['cluster']} CTAs a lane, local "
                          f"{local}: differs from the "
                          f"plain sum in deposit order, or NaN/Inf behind "
                          f"a dropped id landed")
                    checked += 1
            first = histogram_ring(rel, vals, ring0.clone(), t_dev)
            check(torch.equal(histogram_ring(rel, vals, ring0.clone(),
                                             t_dev), first),
                  f"B2 ring form at {name} differs between two runs")
        t_dev = torch.tensor(mid, dtype=torch.int32, device=dev)
        ring = ring0.clone()
        rel_m = torch.where(rel >= max(pipe.reach - mid, 0) * C, rel, -1)
        turns: dict = {}
        for who in B2_RING_TURNS:
            turns.setdefault(who, []).append(device_ms(
                (lambda: histogram_ring(rel, vals, ring, t_dev))
                if who == "ring" else (lambda: histogram(rel_m, vals, S))))
        by_cluster = {f"{'local' if local else 'cluster'} {c}": device_ms(
            lambda: histogram_ring(rel, vals, ring, t_dev, cluster=c,
                                   local=local)) for c, local in sizes}
        # the plan's form against the other at the plan's CTAs, in turns
        other = ring_plan(k, P, C, plan["cluster"], lanes,
                          local=not plan["local"])
        forms: dict = {}
        if other["fits"]:
            for who in ("plan", "other", "other", "plan") * 3:
                forms.setdefault(who, []).append(device_ms(
                    lambda: histogram_ring(
                        rel, vals, ring, t_dev, cluster=plan["cluster"],
                        local=plan["local"] ^ (who == "other"))))
            fm = {w: float(np.median(v)) for w, v in forms.items()}
            check(fm["plan"] <= 1.05 * fm["other"], f"B2 ring form at "
                  f"{name}: the plan's form (local {plan['local']}) is not "
                  f"the faster: medians {fm}")
        med = {w: float(np.median(v)) for w, v in turns.items()}
        ids = ring_ids(rel, mid, P, C)
        flat = ring_offsets(ids, ring).reshape(-1)
        ok = flat >= 0
        safe = torch.where(ok, flat, ring.numel()).long()
        v0 = torch.where(ok, vals.reshape(-1), 0.0)
        spare = torch.zeros(ring.numel() + 1, device=dev)

        def index_put():
            return spare.index_put_((safe,), v0, accumulate=True)
        touched = int(torch.unique(flat[ok]).numel())
        # a stream RING_SHORT_HOPS columns long against the batch
        xs = signal(seconds, ch, seed=22, sr=sr)[
            ..., :pipe.n_max + (RING_SHORT_HOPS - 1) * pipe.hop]
        st = Stream(s.replace(channels=ch), dev)
        cols = st.push(xs) + st.flush()
        st.close()
        vis_b, rgba_b, _ = pipe.process(xs)
        check(len(cols) == RING_SHORT_HOPS and torch.equal(
            torch.stack([c.vis for c in cols]), vis_b) and torch.equal(
            torch.stack([c.rgba for c in cols]), rgba_b),
              f"{name}: a default stream of {RING_SHORT_HOPS} columns is "
              f"not the default batch bit for bit")
        row = dict(
            at=f"{name}: relative ids {tuple(rel.shape)} → a ring ({P}, "
               f"{lanes}, {C}), clusters of {plan['cluster']}",
            max_abs_err=0.0,
            **times(lambda: histogram_ring(rel, vals, ring, t_dev),
                    lambda: histogram_ring_plain(ids, vals, ring),
                    lambda: spare.index_add_(0, safe, v0), iters=10),
            **bound(8.0 * rel.numel() + 8.0 * touched, float(touched)),
            touched_cells=touched, plan=plan, checked_launches=checked,
            in_turns_device_ms=turns, median_device_ms=med,
            device_ms_by_cluster=by_cluster, forms_in_turns_device_ms=forms,
            index_put_ms=cuda_ms(index_put, iters=10),
            index_put_device_ms=device_ms(index_put))
        shapes[name] = row
        lines.append(
            f"{name} ({tuple(rel.shape)} → {P} × {C} a lane, {touched} "
            f"cells touched, clusters of {plan['cluster']}): device "
            f"{row['device_ms']:.4f} ms ({'local' if plan['local'] else 'a cluster'}; "
            f"the other form in turns {forms.get('other', ['-'])[0]}), in turns "
            f"with the atomic route at "
            f"the hop (medians) ring {med['ring']:.4f} vs atomic "
            f"{med['atomic']:.4f} ({'met' if med['ring'] <= med['atomic'] else 'not met'}); "
            f"by cluster size {by_cluster}; index_add_ "
            f"{row['library_device_ms']:.4f}, index_put_(accumulate=True) "
            f"{row['index_put_device_ms']:.4f}, plain {row['plain_ms']:.4f}"
            f" ms, bound {row['bound_ms']:.5f}; {checked} launches "
            f"bit-equal to plain; {RING_SHORT_HOPS}-column stream ≡ batch")
    print("kernels B2 ring form (each cell in bin order onto the ring, the "
          "ring cells computed in the kernel; bit-equal to plain, run to "
          "run, NaN/Inf behind dropped ids): " + "; ".join(lines),
          flush=True)
    return dict(shapes["multires_live"], shapes=shapes)


def phase_kernels(dev, pipe: Pipeline, p) -> dict:
    res = kernels_b123(dev, pipe, p)
    res["histogram"]["multires_scatter"] = multires_scatter(dev)
    res["deposits_ids_window"] = kernels_multires(dev)
    res.update(kernels_b4(dev, np.random.default_rng(7)))
    res.update(kernels_b5(dev))
    res.update(kernels_rfft(dev))
    res.update(kernels_large(dev))
    res.update(kernels_fused(dev, pipe, p))
    res["ema_scan"] = kernels_ema(dev)
    res.update(kernels_post(dev))
    res["histogram_sorted"], res["histogram_sorted_tiles"] = \
        kernels_b2_sorted(dev)
    res["histogram_sorted_batch"] = kernels_b2_batch(dev)
    res["histogram_sorted_ring"] = kernels_b2_ring(dev)
    torch.cuda.synchronize()
    print("kernels: " + "; ".join(
        f"{k} {v['ms']:.4f} ms at {v['at']} (device {v['device_ms']:.4f} ms, "
        f"plain {v['plain_ms']:.4f} ms"
        + (f", library {v['library_ms']:.4f} ms / device "
           f"{v['library_device_ms']:.4f} ms"
           if v['library_ms'] is not None else "")
        + f", bound {v['bound_ms']:.4f} ms by {v['bound_by']}, max abs err "
        f"{v['max_abs_err']:.3g})" for k, v in res.items()), flush=True)
    ranked = sorted(((v["device_ms"] / v["library_device_ms"], k)
                     for k, v in res.items() if v["library_device_ms"]),
                    reverse=True)
    print("kernels against their library call, device time: "
          + ", ".join(f"{k} {r:.3f}×" for r, k in ranked), flush=True)
    return res


def batch_phase(name: str, dev, settings: Settings, x: np.ndarray,
                iters: int):
    """Drive Pipeline.process on the card once (counters), check the
    result against the port's CPU path, then time it → (vis, ms)."""
    s = settings.replace(channels=1 if x.ndim == 1 else x.shape[0])
    gpu, cpu = Pipeline(s, dev), Pipeline(s, "cpu")
    p = gpu.params()
    xg = gpu.to_device(x)
    vis, rgba, _ = drive(name, lambda: gpu.process(xg, p))
    vis_c, rgba_c, _ = cpu.process(x)
    check(vis.shape == vis_c.shape and rgba.shape == rgba_c.shape
          and rgba.dtype == torch.uint8, f"{name}: shapes {vis.shape}")
    check(bool(torch.isfinite(vis).all()), f"{name}: non-finite vis")
    t = gpu.num_columns(x.shape[-1])
    if s.mode == "natural":
        want = cpu._natural_power(cpu.to_device(x), t, cpu.params())
        power = gpu._natural_power(xg, t, p)
        got = power.cpu()
        worst = float((got - want).abs().max()) / float(want.max())
        check(worst <= NATURAL_POWER_TOL, f"{name}: GPU vs CPU power "
              f"{worst}·peak > {NATURAL_POWER_TOL}")
        grid = f"power max diff {worst:.2e}·peak"
    else:
        power = gpu._enhanced_power(xg, t, p)
        g = compare_grids(cpu._enhanced_power(cpu.to_device(x), t,
                                              cpu.params()), power.cpu())
        check(g.ok, f"{name}: GPU vs CPU grid {g}")
        grid = f"energy {g.energy_rel:.2e}, grid maxf {g.maxf_rel:.2e}"
    post = post_stage(name, power, s, p, dev)
    vis_ok, vd, vshare = compare_vis(vis_c, vis.cpu())
    check(vis_ok, f"{name}: GPU vs CPU vis max-filter diff {vd} (share "
          f"over 2/255: {vshare})")
    again = repeat_pixels(lambda: gpu.process(xg, p)[1], rgba)
    ab = ""
    if s.mode == "enhanced":
        check(not any(again), f"{name}: five more default calls differ "
              f"from the first in {again} pixels")
        ab = "; " + batch_ab(name, gpu, xg, p, t)
    ms = cuda_ms(lambda: gpu.process(xg, p), iters=iters, warmup=2)
    frames = t * (1 if x.ndim == 1 else x.shape[0])
    print(f"{name}: {tuple(x.shape)} samples → vis {tuple(vis.shape)}; "
          f"{ms:.3f} ms/call, {frames / (ms / 1e3):.1f} frames/s ({frames} "
          f"frames/call, device-resident input); vs CPU path: {grid}, vis "
          f"maxf {vd:.2e} (share over 2/255 {vshare:.2e}); {post}; pixels "
          f"differing from the first call in {len(again)} more: {again}{ab}; "
          f"launches {LAUNCHES[name]}, B2 routes {ROUTE_LAUNCHES[name]}",
          flush=True)
    return vis, ms


def batch_ab(name: str, gpu: Pipeline, xg, p, t: int) -> str:
    """An enhanced batch cell's sum on the card's default (B2's sorted
    route with its bound, in the form ``sorted_form`` names by shape: the
    batch form or the tiles form, from the driven call's route counts,
    which must hold no global sort and no atomic route): the default sum
    and each of the three sorted forms — batch, tiles and the global sort
    (no bound) — at the card's own ids bit-equal to the CPU plain sum
    (``histogram_plain``) of those ids; the three in turns
    (``FORM_TURNS``, medians of three rounds), the chosen one within
    ``FORM_TOL`` of every other; ``index_add_`` at the same ids and the
    bounds (bytes: 8 a deposit, 4 a cell; chain: the longest cell's run at
    ``CHAIN_CYCLES`` a dependent add); then B2's atomic route
    (``exact_sums=False``: the route it takes, counted around one call)
    against the default, in turns (``BATCH_TURNS``): the device ms of
    ``_enhanced_power`` (B1 and the sum) and of the whole ``process``
    call → the line's part."""
    routes = ROUTE_LAUNCHES[name]
    form = [r for r in (SORTED_TILES, SORTED_BATCH, SORTED) if routes[r] > 0]
    ids_rel, contrib = gpu._deposit_ids_rel(gpu._bank_inputs(xg, t), p)
    ids = gpu._absolute_ids(ids_rel, t, gpu.reach)
    lead, k = ids.shape[:-2], ids.shape[-1]
    lanes = math.prod(lead)
    want = sorted_form(t, k, gpu.reach, gpu.rows, lanes)
    check(form == [SORTED_TILES if want == "tiles" else SORTED_BATCH]
          and routes["row"] == routes["global"] == routes[SORTED] == 0,
          f"{name}: the default batch's B2 routes {routes}, not the "
          f"sorted form {want!r} its shape takes")
    cells = t * gpu.rows
    fi = ids.reshape(lead + (-1,)).contiguous()
    fc = contrib.reshape(lead + (-1,)).contiguous()
    plain = histogram_plain(fi.cpu(), fc.cpu(), cells).reshape(
        lead + (t, gpu.rows))
    got = gpu._scatter_absolute(ids, contrib, t, exact=True)
    check(torch.equal(got.cpu(), plain), f"{name}: the default sum is not "
          f"the CPU plain sum of its deposits")
    passes = gpu.settings.scatter_passes
    bound_kw = dict(route=SORTED, reach=gpu.reach, frame_len=k,
                    column_len=gpu.rows)
    forms = {"batch": lambda: histogram(fi, fc, cells, passes, form="batch",
                                        **bound_kw),
             "tiles": lambda: histogram(fi, fc, cells, passes, form="tiles",
                                        **bound_kw),
             "sort": lambda: histogram(fi, fc, cells, passes, route=SORTED)}
    for who, fn in forms.items():
        check(torch.equal(fn().cpu().reshape(plain.shape), plain),
              f"{name}: B2's {who} form is not the CPU plain sum of the "
              f"default's deposits")
    form_turns: dict = {}
    for who in FORM_TURNS:
        form_turns.setdefault(who, []).append(device_ms(forms[who], 5))
    med_f = {k: float(np.median(v)) for k, v in form_turns.items()}
    slower = {k: v for k, v in med_f.items()
              if med_f[want] > (1 + FORM_TOL) * v}
    check(not slower, f"{name}: the chosen sorted form ({want}) "
          f"{med_f[want]:.4f} ms, over {FORM_TOL:.0%} above {slower}")
    ok = (fi >= 0) & (fi < cells)
    flat = (torch.where(ok, fi, cells).long() + torch.arange(
        lanes, device=fi.device).reshape(lead + (1,)) * (cells + 1)
            ).reshape(-1)
    vals0 = torch.where(ok, fc, 0.0).reshape(-1)
    run = int(torch.bincount(flat, minlength=lanes * (cells + 1)).reshape(
        lanes, cells + 1)[:, :cells].max())
    before = dict(histogram.route_launches)
    gpu._enhanced_power(xg, t, p, exact_sums=False)
    atomic = [r for r in histogram.route_launches
              if histogram.route_launches[r] > before[r]]
    power: dict = {}
    calls: dict = {}
    for who in BATCH_TURNS:
        exact = who == "default"
        power.setdefault(who, []).append(device_ms(
            lambda: gpu._enhanced_power(xg, t, p, exact_sums=exact), 5))
        calls.setdefault(who, []).append(device_ms(
            lambda: gpu.process(xg, p, exact_sums=exact), 5))
    med = {k: float(np.median(v)) for k, v in power.items()}
    med_c = {k: float(np.median(v)) for k, v in calls.items()}
    BATCH_AB[name] = dict(
        form=form[0], lanes=lanes, atomic_routes=atomic,
        at=f"ids {tuple(fi.shape)} → {lanes} × {cells} cells, R = "
           f"{gpu.reach}",
        batch_plan=batch_plan(t, k, gpu.reach, gpu.rows, lanes),
        form_turns_device_ms=form_turns, form_median_device_ms=med_f,
        index_add_device_ms=device_ms(
            lambda: torch.zeros(lanes * (cells + 1), device=fi.device)
            .index_add_(0, flat, vals0), 5),
        **bound(8.0 * fi.numel() + 4.0 * lanes * cells, float(ok.sum())),
        longest_run=run,
        chain_bound_ms=run * CHAIN_CYCLES / SM_CLOCK_HZ[0] * 1e3,
        power_turns_device_ms=power, process_turns_device_ms=calls,
        power_median_device_ms=med, process_median_device_ms=med_c)
    return (f"sum on B2's {form[0]} ({lanes} lanes; atomic: {atomic}), "
            f"bit-equal to the CPU plain sum, as are the batch, tiles and "
            f"sort forms; the sum alone in turns {FORM_TURNS[:6]} ×3 "
            f"(medians, device ms): batch {med_f['batch']:.4f}, tiles "
            f"{med_f['tiles']:.4f}, sort {med_f['sort']:.4f}; index_add_ "
            f"{BATCH_AB[name]['index_add_device_ms']:.4f}, bound "
            f"{BATCH_AB[name]['bound_ms']:.4f} (bytes), chain "
            f"{BATCH_AB[name]['chain_bound_ms']:.4f} (run {run}); in turns "
            f"{BATCH_TURNS[:4]} ×3: B1 and the sum default "
            f"{med['default']:.4f} vs atomic {med['atomic']:.4f} "
            f"(+{med['default'] - med['atomic']:.4f}), process default "
            f"{med_c['default']:.4f} vs atomic {med_c['atomic']:.4f}")


def repeat_pixels(fn, first, runs: int = 5) -> list:
    """Pixels (RGBA entries of any channel) in which each of ``runs`` more
    calls of ``fn`` differs from ``first``: B2's float atomics add a
    cell's deposits in another order each run, and the EMAs can carry a
    last-bit difference over a colormap edge.  A measurement, not a
    check: only the single-bank raster promises equal runs."""
    out = []
    for _ in range(runs):
        got = fn()
        out.append(int((got != first).reshape(-1, 4).any(-1).sum()))
    return out


def chain_census(fn) -> dict:
    """The post chain's kernel launches in one call of ``fn``, by wrapper
    and by pass (the scans' speculate and repair launches)."""
    names = ("post_head", "ema_scan", "post_tail")
    wrappers = (post_head, ema_scan, post_tail)

    def snap():
        return [w.launches for w in wrappers] + [
            w.pass_launches[k] for w in (ema_scan, post_tail)
            for k in ("speculate", "repair")]
    before = snap()
    fn()
    d = [a - b for a, b in zip(snap(), before)]
    return dict(zip(names, d[:3]), kernels=d[0] + sum(d[3:]),
                ema_scan_passes=d[3:5], post_tail_passes=d[5:7])


def post_stage(name: str, power, s: Settings, p, dev) -> str:
    """The batch post chain alone on a path's (..., t, rows) power: CUDA
    events over the stage in each form and the fused form's device time,
    its kernel launches a call (``chain_census``), the chunks its scans
    repaired, beside the per-column loop's stage where PERF.md has it."""
    cols = power.movedim(-2, 0).contiguous()
    st = PostState.init(cols.shape[1:], dev)

    def fused():
        return postprocess_batch(cols, st, p.post, s.agc_global)
    census = chain_census(fused)
    repaired = repaired_during(dev, fused)
    ms = {assoc: cuda_ms(lambda: postprocess_batch(
        cols, st, p.post, s.agc_global, associative=assoc), iters=5,
        warmup=1) for assoc in (False, True)}
    dms = device_ms(fused, calls=5)
    before = LOOP_POST_STAGE_MS.get(name)
    coupled = s.agc_global and cols.ndim > 2
    return (f"post chain stage {ms[False]:.4f} ms (device {dms:.4f}; "
            f"associative form {ms[True]:.4f}), {cols.shape[0]} columns, "
            f"launches a call {census} (torch ops besides: "
            f"{'amax and the product' if coupled else 'none'}), "
            f"chunks repaired {repaired}"
            + ("" if before is None else
               f"; the per-column loop's stage (PERF.md §5): {before} ms"))


def eager_hops(name: str, st: Stream, x: np.ndarray, hops: int = 200,
               settle: int = 5) -> tuple:
    """The step without the graph, for the A/B inside one run: ``hops``
    hops (after ``settle``) straight through ``_stream_step_rolling`` on a
    carry of its own, each staged with a plain copy as the stream did
    before its graph → host p50/p99 per hop (ms, push → synchronize)."""
    pipe = st.pipe
    n, hop, roll = pipe.n_max, pipe.hop, pipe.roll
    carry = pipe.init_roll_carry(x.shape[:-1])
    p = pipe.params(st.settings)
    hops = min(hops, (x.shape[-1] - n) // hop + 1 - settle)
    lat = []
    for f in range(settle + hops):
        t0 = time.perf_counter()
        block = torch.from_numpy(np.ascontiguousarray(
            x[..., f * hop + n - roll:f * hop + n])).to(st.device)
        carry, _ = pipe._stream_step_rolling(carry, block, p)
        torch.cuda.synchronize()
        if f >= settle:
            lat.append(time.perf_counter() - t0)
    p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
    print(f"{name} eager step (no graph): {hops} hops straight through "
          f"_stream_step_rolling, per-hop latency p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms (host clock, copy → synchronize)", flush=True)
    return p50, p99


def live_phase(name: str, dev, settings: Settings, x: np.ndarray,
               vis_batch: torch.Tensor, min_hops: int = 300,
               chunk: int = 1024, budget_ms: float | None = None,
               keep_up: bool = False) -> None:
    """Drive ``Stream`` on the card once (counters) in ``chunk``-sample
    pushes, then flush; it must match the batch result.  Per-hop latency
    p50/p99, beside ``budget_ms`` and the hop's own audio time; with
    ``keep_up`` the graphed p50 must be below the hop's audio time.  An
    earlier line gives the eager step's p50/p99 (``eager_hops``)."""
    st = Stream(settings.replace(channels=1 if x.ndim == 1 else x.shape[0]),
                dev)
    check(st.captures == 1, f"{name}: {st.captures} graph captures")
    check_native_ring(name, st)
    eager = eager_hops(name, st, x)
    lat = []

    def run():
        cols = []
        for i in range(0, x.shape[-1], chunk):
            t0 = time.perf_counter()
            got = st.push(x[..., i:i + chunk])
            if got:
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) / len(got))
            cols.extend(got)
        return cols + st.flush()

    cols = drive(name, run)
    hops = len(cols) + st.reach
    check(hops >= min_hops, f"{name}: only {hops} hops (want {min_hops})")
    check([c.index for c in cols] == list(range(vis_batch.shape[0])),
          f"{name}: column indices differ from the batch")
    vis_s = torch.stack([c.vis for c in cols])
    diff = float((vis_s - vis_batch).abs().max())
    check(diff <= STREAM_VIS_ATOL, f"{name} ≠ batch: max |Δvis| {diff}")
    check(name not in ENHANCED_LIVE or torch.equal(vis_s, vis_batch),
          f"{name} ≠ the default batch bit for bit: max |Δvis| {diff}")
    check(st.captures == 1, f"{name}: {st.captures} graph captures")
    p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
    hop_ms = st.pipe.hop / settings.sample_rate * 1e3
    budget = ("" if budget_ms is None else
              f", budget {budget_ms:.1f} ms: p99 "
              f"{'within' if p99 < budget_ms else 'OVER'} budget")
    print(f"{name}: {hops} hops of {st.pipe.hop} in {chunk}-sample pushes, "
          f"{len(cols)} columns, one graph replay a hop; max |vis − batch| "
          f"{diff:.3g}; per-hop latency p50 {p50:.3f} ms, p99 {p99:.3f} ms "
          f"against the hop's {hop_ms:.3f} ms of audio{budget} (host clock, "
          f"push → synchronize; eager step p50 {eager[0]:.3f}, p99 "
          f"{eager[1]:.3f}); launches {LAUNCHES[name]}, B2 routes "
          f"{ROUTE_LAUNCHES[name]}; host ring {type(st.ring).__name__}",
          flush=True)
    if keep_up:
        check(p50 < hop_ms, f"{name}: graphed p50 {p50:.3f} ms is not below "
              f"the hop's {hop_ms:.3f} ms of audio")
    if name in ENHANCED_LIVE:
        print(default_live(name, dev, settings, x, chunk, cols), flush=True)


def stream_run(st: Stream, x: np.ndarray, chunk: int, lat=None) -> list:
    """``x`` pushed through ``st`` in ``chunk``-sample pushes, then the
    flush → the columns; each push's host ms a column into ``lat``."""
    cols = []
    for i in range(0, x.shape[-1], chunk):
        t0 = time.perf_counter()
        got = st.push(x[..., i:i + chunk])
        if got and lat is not None:
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) / len(got))
        cols.extend(got)
    return cols + st.flush()


def hop_turns(streams: dict, x: np.ndarray, chunk: int, hops: int = 200
              ) -> dict:
    """The graphed hop of each stream, in the turns of ``LIVE_TURNS``: a
    turn pushes ``x`` on from the stream's own place (from its start again
    at its end) until ``hops`` columns came out → per stream and turn the
    host p50 / p99 a hop (push → synchronize) and the device ms a hop (its
    graph replayed, ``device_ms``)."""
    at = dict.fromkeys(streams, 0)
    out: dict = {k: dict(p50=[], p99=[], device_ms=[]) for k in streams}
    for who in LIVE_TURNS:
        st, lat = streams[who], []
        while len(lat) < hops:
            i = at[who]
            at[who] = i + chunk if i + chunk < x.shape[-1] else 0
            t0 = time.perf_counter()
            got = st.push(x[..., i:i + chunk])
            if got:
                torch.cuda.synchronize()
                lat += [(time.perf_counter() - t0) / len(got)] * len(got)
        out[who]["p50"].append(float(np.percentile(lat, 50)) * 1e3)
        out[who]["p99"].append(float(np.percentile(lat, 99)) * 1e3)
        out[who]["device_ms"].append(device_ms(lambda: st._graph.replay(),
                                               100))
    return out


def default_live(name: str, dev, settings: Settings, x: np.ndarray,
                 chunk: int, cols: list) -> str:
    """An enhanced live phase's default ``Stream`` (the ordered sums: B2's
    ring form once a hop and no other B2 route, counted in the driven
    run): its columns (``cols``) bit-equal in ``vis`` and ``rgba`` to a
    second run, to a run in 777-sample pushes and to the default
    ``Pipeline.process`` of the same audio; a whole atomic stream
    (``Stream(..., exact_sums=False)``: B2's row or global route) within
    ``STREAM_VIS_ATOL`` of ``process(..., exact_sums=False)``; then its
    graphed hop beside the atomic route's in turns (``hop_turns``,
    medians of three rounds) → the phase's line."""
    s = settings.replace(channels=1 if x.ndim == 1 else x.shape[0])
    routes = ROUTE_LAUNCHES[name]
    hops = len(cols) + Pipeline(s, dev).reach
    check(routes[SORTED_RING] == hops and all(
        n == 0 for r, n in routes.items() if r != SORTED_RING),
          f"{name}: B2 launched other than its ring form once a hop "
          f"({routes}, {hops} hops)")
    vis0 = torch.stack([c.vis for c in cols])
    rgba0 = torch.stack([c.rgba for c in cols])
    for label, push in (("a second run", chunk), ("777-sample pushes", 777)):
        st = Stream(s, dev)
        again = stream_run(st, x, push)
        st.close()
        differ = int((torch.stack([c.vis for c in again]) != vis0).sum())
        check(differ == 0 and torch.equal(
            torch.stack([c.rgba for c in again]), rgba0),
              f"{name}: {label} differs from the first in {differ} cells")
    vis_b, rgba_b, _ = Pipeline(s, dev).process(x)
    check(torch.equal(vis0, vis_b) and torch.equal(rgba0, rgba_b),
          f"{name} ≠ the default process bit for bit in vis or rgba")
    st = Stream(s, dev, exact_sums=False)
    before = dict(histogram.route_launches)
    loose = stream_run(st, x, chunk)
    st.close()
    loose_routes = [r for r in histogram.route_launches
                    if histogram.route_launches[r] > before[r]]
    vis_a = torch.stack([c.vis for c in loose])
    vis_pa = Pipeline(s, dev).process(x, exact_sums=False)[0]
    check(vis_a.shape == vis_pa.shape, f"{name}: the atomic stream's vis "
          f"{tuple(vis_a.shape)}, its batch's {tuple(vis_pa.shape)}")
    diff_a = float((vis_a - vis_pa).abs().max())
    check(diff_a <= STREAM_VIS_ATOL and loose_routes and all(
        r in ROUTES for r in loose_routes), f"{name}: the atomic stream "
          f"(B2 routes {loose_routes}) ≠ the atomic batch: max |Δvis| "
          f"{diff_a}")
    timed = {"default": Stream(s, dev),
             "atomic": Stream(s, dev, exact_sums=False)}
    before = dict(histogram.route_launches)
    turns = hop_turns(timed, x, chunk)
    atomic = [r for r in histogram.route_launches
              if histogram.route_launches[r] > before[r]
              and r != SORTED_RING]
    for st in timed.values():
        st.close()
    med = {who: {k: float(np.median(v)) for k, v in t.items()}
           for who, t in turns.items()}
    LIVE_AB[name] = dict(turns=turns, median=med, atomic_routes=atomic,
                         atomic_stream_vs_batch=diff_a)
    return (f"{name} default: the ring form {routes[SORTED_RING]} times and "
            f"no other B2 route; a second run, 777-sample pushes and "
            f"process bit-equal in vis and rgba ({tuple(vis_b.shape)}); "
            f"the atomic stream (B2 {loose_routes}) against the atomic "
            f"process: max |Δvis| {diff_a:.3g} (≤ {STREAM_VIS_ATOL}); a "
            f"hop in turns {LIVE_TURNS[:4]} ×3 (medians): default p50 "
            f"{med['default']['p50']:.3f} / p99 {med['default']['p99']:.3f}"
            f" ms, device {med['default']['device_ms']:.4f} ms; atomic "
            f"({atomic}) p50 {med['atomic']['p50']:.3f} / p99 "
            f"{med['atomic']['p99']:.3f} ms, device "
            f"{med['atomic']['device_ms']:.4f} ms")


def default_engine_phase(dev) -> dict:
    """``DEFAULT_ENGINE``'s cells on the default engine, where the card's
    spectra come from the real FFT kernel: ``Pipeline.process`` driven
    once (counters: the kernel and the path's others must launch), held
    to the port's CPU path (natural power within ``NATURAL_POWER_TOL``·
    peak; ``vis`` within ``compare_vis``, for the enhanced cells once
    float64 plain settles the deposits the two place apart where the raw
    comparison fails), two calls bit-equal; a graphed ``Stream`` in
    1024-sample pushes driven once, one capture, no frame dropped, its
    columns ≡ ``process`` bit for bit in vis and rgba, its graphed p50 a
    hop below the hop's audio time → per cell the device ms a call and
    the host p50/p99 a hop."""
    out = {}
    for name, s, seconds, sr in DEFAULT_ENGINE:
        x = signal(seconds, seed=41, sr=sr)
        gpu = Pipeline(s, dev)
        check(gpu.fft_impl == "xla" and s.fft_impl == "auto",
              f"{name}: not the default engine ({gpu.fft_impl})")
        p, xg = gpu.params(), gpu.to_device(x)
        t = gpu.num_columns(x.shape[-1])
        vis, rgba, _ = drive(name, lambda: gpu.process(xg, p))
        check(LAUNCHES[name]["fft4_steps123"] == 0, f"{name}: kernel B4 "
              f"launched on the default engine ({LAUNCHES[name]})")
        vis2, rgba2, _ = gpu.process(xg, p)
        check(torch.equal(vis, vis2) and torch.equal(rgba, rgba2),
              f"{name}: two process calls differ")
        check(bool(torch.isfinite(vis).all()), f"{name}: non-finite vis")
        cpu = Pipeline(s, "cpu")
        vis_c, _, _ = cpu.process(x)
        grid = ""
        if s.mode == "natural":
            want = cpu._natural_power(cpu.to_device(x), t, cpu.params())
            worst = float((gpu._natural_power(xg, t, p).cpu() - want)
                          .abs().max()) / float(want.max())
            check(worst <= NATURAL_POWER_TOL, f"{name}: GPU vs CPU power "
                  f"{worst}·peak > {NATURAL_POWER_TOL}")
            grid = f"power {worst:.2e}·peak, "
        vis_ok, vd, vshare = compare_vis(vis_c, vis.cpu())
        if not vis_ok and s.mode == "enhanced":
            ik, ck = (a.cpu() for a in gpu._deposit_ids_rel(
                gpu._bank_inputs(xg, t), p))
            vis_s, apart, explained, _, loud, odd = settled_vis(
                cpu, x, t, ik, ck)
            check(loud <= UNEXPLAINED_BELOW, f"{name}: of {apart} deposits "
                  f"placed apart float64 plain explains {explained}; one "
                  f"other is {loud:.2e} of the loudest: {odd}")
            vis_ok, vd, vshare = compare_vis(vis_s, vis.cpu())
            grid += f"settled {explained} of {apart} apart, "
        check(vis_ok, f"{name}: GPU vs CPU vis max-filter diff {vd} (share "
              f"over 2/255: {vshare})")
        st = Stream(s, dev)
        lat: list = []
        cols = drive(f"{name}_live", lambda: stream_run(st, x, 1024, lat))
        check(LAUNCHES[f"{name}_live"]["fft4_steps123"] == 0, f"{name}: "
              f"kernel B4 launched on the default engine's stream")
        check(st.captures == 1 and st.dropped_frames == 0,
              f"{name}: {st.captures} captures, {st.dropped_frames} dropped")
        st.close()
        check([c.index for c in cols] == list(range(t))
              and torch.equal(torch.stack([c.vis for c in cols]), vis)
              and torch.equal(torch.stack([c.rgba for c in cols]), rgba),
              f"{name}: the graphed Stream ≠ process bit for bit "
              f"({len(cols)} columns, {t} in the batch)")
        p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
        hop_ms = gpu.hop / s.sample_rate * 1e3
        check(p50 < hop_ms, f"{name}: graphed p50 {p50:.3f} ms is not below "
              f"the hop's {hop_ms:.3f} ms of audio")
        ms = device_ms(lambda: gpu.process(xg, p), calls=3)
        out[name] = dict(at=f"{gpu.sizes} at hop {gpu.hop}, {s.sample_rate} "
                         f"Hz, {seconds} s: {t} columns", device_ms=ms,
                         hop_p50_ms=p50, hop_p99_ms=p99, hop_audio_ms=hop_ms)
        print(f"default_engine {name} ({CARD[0]}): {out[name]['at']}; "
              f"process {ms:.4f} device ms a call, two calls bit-equal; vs "
              f"CPU path: {grid}vis maxf {vd:.2e} (share over 2/255 "
              f"{vshare:.2e}); graphed Stream ≡ process bit for bit in vis "
              f"and rgba ({len(cols)} columns, one capture), host p50 "
              f"{p50:.3f} ms, p99 {p99:.3f} ms a hop against its "
              f"{hop_ms:.3f} ms of audio; launches {LAUNCHES[name]}",
              flush=True)
    return out


def raster_phase(name: str, dev, settings: Settings, x: np.ndarray,
                 iters: int = 5) -> tuple:
    """The single-bank raster (``render.raster``) on the card, driven once
    through ``render_image`` (counters); its vis the same on a second run
    (B2's sorted route) and its image the colormap of that vis; the power
    grid and vis against the port's CPU path; wall by the host clock over
    ``iters`` calls (device-resident input, image copied to the host).
    → (the call for the breakdown, wall ms)."""
    xg = torch.from_numpy(x).to(dev)
    img = drive(name, lambda: raster.render_image(xg, settings, dev))
    n = settings.fft_size
    t = (x.size - n) // settings.hop_samples + 1
    check(img.shape == (n // 2 + 1, t, 4) and img.dtype == np.uint8,
          f"{name}: image {img.shape} {img.dtype}")
    vis = raster.render_vis(xg, settings, dev)
    check(np.array_equal(raster.render_vis(xg, settings, dev), vis),
          f"{name}: vis differs between two runs")
    own = apply_lut(torch.from_numpy(vis.T.copy()),
                    torch.from_numpy(lut(settings.colormap).copy())).numpy()
    check(np.array_equal(own.transpose(1, 0, 2)[::-1], img),
          f"{name}: the image is not the colormap of render_vis")
    check(bool(np.isfinite(vis).all()), f"{name}: non-finite vis")
    pc = raster.analyze(torch.from_numpy(x), settings)
    pg = raster.analyze(xg, settings).cpu()
    if settings.mode == "natural":
        worst = float((pg - pc).abs().max()) / float(pc.max())
        check(worst <= NATURAL_POWER_TOL, f"{name}: GPU vs CPU power "
              f"{worst}·peak > {NATURAL_POWER_TOL}")
        grid = f"power max diff {worst:.2e}·peak"
    else:
        g = compare_grids(pc, pg)
        check(g.ok, f"{name}: GPU vs CPU grid {g}")
        grid = f"energy {g.energy_rel:.2e}, grid maxf {g.maxf_rel:.2e}"
    vis_c = raster.render_vis(x, settings, "cpu")
    ok, vd, share = compare_vis(torch.from_numpy(vis_c.T.copy()),
                                torch.from_numpy(vis.T.copy()))
    check(ok, f"{name}: GPU vs CPU vis max-filter diff {vd} (share over "
          f"2/255: {share})")

    atomic = ""
    if settings.mode == "enhanced":
        # the same raster with B2's global route (atomics) for its sum:
        # what the sorted route is there to prevent
        ids, vals, cells = raster_ids(dev, settings, x)
        freqs, params, table = raster._tables(settings, str(dev))

        def with_atomics():
            grid = histogram(ids, vals, cells, route="global")
            v = raster.postprocess(grid.reshape(-1, n // 2 + 1), freqs,
                                   settings, params)
            return apply_lut(v, table)
        again = repeat_pixels(with_atomics, with_atomics())
        atomic = (f"; with B2's global route instead of the sorted one, "
                  f"pixels differing from the first run in 5 more: {again}")

    def call():
        return raster.render_image(xg, settings, dev)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    print(f"{name}: {settings.mode} {n} at hop {settings.hop_samples} on "
          f"{x.size} samples → image {img.shape}; wall {wall:.3f} ms/call "
          f"(host clock, image on the host); vs CPU path: {grid}, vis maxf "
          f"{vd:.2e} (share over 2/255 {share:.2e}); vis equal run to run"
          f"{atomic}; launches {LAUNCHES[name]}, B2 routes "
          f"{ROUTE_LAUNCHES[name]}", flush=True)
    return call, wall


def exact_sums(dev, x: np.ndarray) -> str:
    """The display default's file render (``render_image_multires``)
    driven once (counters: its sum must take B2's sorted tiles) and its
    image the same on a second call; its grid before the post chain
    (the default, ``exact_sums``) bit-equal on two calls and to the CPU
    plain sum of the same deposits; the atomic batch grid
    (``exact_sums=False``: B2's global route) on two calls, cells that
    differ counted; the sum's device ms, the tiles form against the global
    route at these ids, and the whole ``process`` call with and without
    ``exact_sums``, in turns (medians of three rounds) → the phase's
    line."""
    img = drive("render_multires",
                lambda: render_image_multires(x, MULTIRES, dev))
    check(np.array_equal(render_image_multires(x, MULTIRES, dev), img),
          "render_image_multires: the image differs between two calls")
    pipe = Pipeline(MULTIRES, dev)
    p = pipe.params()
    xg = torch.from_numpy(x).to(dev)
    t = pipe.num_columns(x.size)
    g1 = pipe._enhanced_power(xg, t, p, exact_sums=True)
    g2 = pipe._enhanced_power(xg, t, p, exact_sums=True)
    check(torch.equal(g1, g2), "multires file render: the grid differs "
          "between two calls")
    ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_inputs(xg, t), p)
    ids = pipe._absolute_ids(ids_rel, t, pipe.reach)
    cells = t * pipe.rows
    fi, fc = ids.reshape(-1).contiguous(), contrib.reshape(-1).contiguous()
    check(torch.equal(g1.reshape(-1).cpu(),
                      histogram_plain(fi.cpu(), fc.cpu(), cells)),
          "multires file render: the grid is not the CPU plain sum of its "
          "deposits")
    a1 = pipe._enhanced_power(xg, t, p, exact_sums=False)
    a2 = pipe._enhanced_power(xg, t, p, exact_sums=False)
    differ = int((a1 != a2).sum())
    bound = dict(route=SORTED, reach=pipe.reach, frame_len=ids.shape[-1],
                 column_len=pipe.rows)
    turns, calls = {}, {}
    for who in EXACT_TURNS:
        turns.setdefault(who, []).append(device_ms(
            (lambda: histogram(fi, fc, cells)) if who == "global"
            else (lambda: histogram(fi, fc, cells, **bound))))
        calls.setdefault(who, []).append(device_ms(
            lambda: pipe.process(xg, p, exact_sums=who == "tiles"), 5))
    med = {k: float(np.median(v)) for k, v in turns.items()}
    med_calls = {k: float(np.median(v)) for k, v in calls.items()}
    plan = tile_plan(t, ids.shape[-1], pipe.reach, column=pipe.rows)
    EXACT.update(at=f"ids ({t}, {ids.shape[-1]}) → {cells} cells, R = "
                 f"{pipe.reach}", plan=plan, turns_device_ms=turns,
                 median_device_ms=med, process_turns_device_ms=calls,
                 process_median_device_ms=med_calls,
                 global_route_cells_differing=differ,
                 **bound_of_sum(fi, fc, cells))
    return (f"multires file render: grid bit-equal on two calls and to the "
            f"CPU plain sum; the global route's grid differs in {differ} "
            f"cells between two calls; sum device ms (medians of three "
            f"rounds) tiles {med['tiles']:.4f} vs global "
            f"{med['global']:.4f} ({plan['cols']}-column tiles, "
            f"{plan['col_tiles']} of them); process device ms exact "
            f"{med_calls['tiles']:.4f} vs atomic {med_calls['global']:.4f};"
            f" launches {LAUNCHES['render_multires']}, B2 routes "
            f"{ROUTE_LAUNCHES['render_multires']}")


def bound_of_sum(ids, vals, cells: int) -> dict:
    """B2's bound: each deposit read once, each cell written once."""
    return bound(8 * ids.numel() + 4 * cells, ids.numel())


def cli_phase(dev, x: np.ndarray) -> None:
    """``python -m emspec_torch`` as a user runs it, each command a
    subprocess on the card that must exit 0: render (single bank 8192;
    with the CLI's defaults twice, byte-equal PNGs; --multires twice,
    byte-equal), export (its vis through the colormap must equal that
    render's PNG pixel for pixel; with --multires, equal to render
    --multires's), stream, animate over the first 4 s at 10 fps (its last
    frame must equal stream's PNG of the same 4 s), and note 443.  The
    WAVs are written with the port's io.wav.  Then ``exact_sums``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [q for q in [os.environ.get("PYTHONPATH")] if q]))
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        write_wav(d / "s16.wav", x, SR)
        write_wav(d / "s4.wav", x[:4 * SR], SR)
        runs = (("render", ["render", "s16.wav", "r.png", "--fft-size",
                            "8192"]),
                ("render --multires", ["render", "s16.wav", "m.png",
                                       "--multires"]),
                ("export", ["export", "s16.wav", "e.npz", "--fft-size",
                            "8192"]),
                ("stream 4 s", ["stream", "s4.wav", "s4.png"]),
                ("stream --fft-size 65536", ["stream", "s4.wav", "s64k.png",
                                             "--fft-size", "65536",
                                             "--no-multires"]),
                ("animate", ["animate", "s4.wav", "a.png", "--fps", "10"]),
                ("note", ["note", "443"]))
        walls, outs = {}, {}
        for label, args in runs:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "emspec_torch", *args],
                               cwd=d, env=env, capture_output=True, text=True,
                               timeout=600)
            walls[label] = time.perf_counter() - t0
            check(r.returncode == 0, f"cli {label}: exit {r.returncode}: "
                  f"{r.stderr[-2000:]}")
            outs[label] = r.stdout.strip()
        # the equal-run pairs, started together (each wall then shares the
        # host with the other three)
        together = (("render (defaults)", ["render", "s16.wav", "d1.png"]),
                    ("render (defaults), again", ["render", "s16.wav",
                                                  "d2.png"]),
                    ("render --multires, again", ["render", "s16.wav",
                                                  "m2.png", "--multires"]),
                    ("export --multires", ["export", "s16.wav", "em.npz",
                                           "--multires"]),
                    ("stream", ["stream", "s16.wav", "s.png"]),
                    ("stream, again", ["stream", "s16.wav", "s2.png"]),
                    ("stream --hop 16384", ["stream", "s16.wav", "h.png",
                                            "--hop", "16384"]),
                    ("stream --hop 16384, again",
                     ["stream", "s16.wav", "h2.png", "--hop", "16384"]),
                    ("render --multires --time-parallel",
                     ["render", "s16.wav", "tp.png", "--multires",
                      "--time-parallel"]),
                    ("render --multires --time-parallel, again",
                     ["render", "s16.wav", "tp2.png", "--multires",
                      "--time-parallel"]))
        t0 = time.perf_counter()
        procs = [(label, subprocess.Popen(
            [sys.executable, "-m", "emspec_torch", *args], cwd=d, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for label, args in together]
        for label, proc in procs:
            out, err = proc.communicate(timeout=600)
            walls[label + " (together)"] = time.perf_counter() - t0
            check(proc.returncode == 0, f"cli {label}: exit "
                  f"{proc.returncode}: {err[-2000:]}")
            outs[label] = out.strip()
        z = np.load(d / "e.npz", allow_pickle=False)
        s = json.loads(str(z["settings_json"]))
        rgba = apply_lut(torch.from_numpy(z["vis"].T.copy()),
                         torch.from_numpy(lut(s["colormap"]).copy())).numpy()
        check(np.array_equal(rgba.transpose(1, 0, 2)[::-1],
                             read_png(d / "r.png")),
              "cli: export's vis through the colormap differs from render's "
              "PNG")
        for a, b in (("d1.png", "d2.png"), ("m.png", "m2.png"),
                     ("s.png", "s2.png"), ("h.png", "h2.png"),
                     ("tp.png", "tp2.png")):
            check((d / a).read_bytes() == (d / b).read_bytes(),
                  f"cli: two runs of a file output differ ({a}, {b})")
        zm = np.load(d / "em.npz", allow_pickle=False)
        rgba_m = apply_lut(torch.from_numpy(zm["vis"].T.copy()),
                           torch.from_numpy(lut(s["colormap"]).copy())).numpy()
        check(np.array_equal(rgba_m.transpose(1, 0, 2)[::-1],
                             read_png(d / "m.png")),
              "cli: export --multires's vis through the colormap differs "
              "from render --multires's PNG")
        frames, fps = read_apng(d / "a.png")
        check(frames.shape[0] == 40 and fps == 10,
              f"cli animate: {frames.shape[0]} frames at {fps} fps")
        check(np.array_equal(frames[-1], read_png(d / "s4.png")),
              "cli: animate's last frame differs from stream's PNG")
        check("A4" in outs["note"], f"cli note: {outs['note']!r}")
        check("streamed 47 columns x1ch (reach=0 hops)"
              in outs["stream --hop 16384"],
              f"cli stream --hop 16384: {outs['stream --hop 16384']!r}")
        # a hop of 32,769 deposits: B2's ring form in windows
        check("streamed 8 columns x1ch (reach=2 hops)"
              in outs["stream --fft-size 65536"],
              f"cli stream --fft-size 65536: "
              f"{outs['stream --fft-size 65536']!r}")
        steps, share = lut_steps(torch.from_numpy(read_png(d / "tp.png")),
                                 torch.from_numpy(read_png(d / "m.png")),
                                 torch.from_numpy(lut("inferno").copy()))
        check(steps <= 1, f"cli: render --time-parallel is {steps} colormap "
              f"steps from render --multires")
    print("cli: python -m emspec_torch, each a subprocess that exited 0, "
          "wall s (process start, import and kernel library load included): "
          + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
          + "; export ≡ render pixel for pixel, and with --multires; two "
          "runs byte-equal (render with the defaults and --multires, stream, "
          "stream --hop 16384 on the display default, render --multires "
          "--time-parallel); animate's last frame "
          f"≡ stream's PNG; render --time-parallel vs --multires: at most "
          f"{steps} colormap step, {share:.2e} of the pixels; outputs: " + " | ".join(outs.values()), flush=True)
    print("cli: " + exact_sums(dev, x), flush=True)


SWAP_SIZES = (512, 1024, 2048, 4096, 8192, 16384, 32768)   # the dropdown
KEEP_UP = 0.98          # columns over audio hops in a window without swaps


def _percentiles(values) -> tuple:
    return tuple(float(np.percentile(values, q)) for q in (50, 99))


def app_columns(dev, wav: Path, chunk: int = 1024) -> tuple:
    """``EmSpecApp(Settings())`` on the card fed ``wav`` (read back with
    the port's ``io.wav``) in ``chunk``-sample pushes, as a capture feeds
    it → the (vis, rgba) of every column it paints, and the samples."""
    from emspec_torch.app import EmSpecApp
    from emspec_torch.io.wav import read_wav

    samples = read_wav(wav)[0][0]
    with tempfile.TemporaryDirectory() as ud:
        app = EmSpecApp(Settings(), user_dir=ud, device=dev)
        got, paint = [], app._paint

        def keep(cols):
            got.extend((c.vis.clone(), c.rgba.clone()) for c in cols)
            return paint(cols)
        app._paint = keep
        for i in range(0, samples.shape[-1], chunk):
            app.push_audio(samples[i:i + chunk])
        app.close()
    return (torch.stack([v for v, _ in got]),
            torch.stack([c for _, c in got]), samples)


def app_phase(dev, x: np.ndarray) -> None:
    """The live app as a user opens it: ``ShellServer(Settings(),
    source="wav")`` on the card looping the 16 s signal, driven over HTTP
    once (counters) while a viewer polls ``/api/frame`` at 15 Hz: a
    settle second, a 2.5 s window, a continuous POST (gain), 1.5 s, a
    structural POST (4096 single-bank), 3 s, a structural POST (natural),
    3 s.  In each window (no swap inside) the columns painted must be ≥
    ``KEEP_UP`` × the audio hops that arrived (both read under the shell's
    lock after a drain tick that painted, with no whole hop pending, at
    each end: within 5 s, else as they stand) and
    ``dropped_frames`` 0; the kinds must be as expected, the
    slider must re-capture nothing and each swap's stream capture once;
    every frame (512, 1024, 4).  Prints each POST's wall, the gap from a
    structural POST to its stream's first column, the drain ticks'
    p50/p99 wall and ``/api/frame``'s."""
    import threading
    import urllib.request

    from emspec_torch.shell import ShellServer

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        write_wav(d / "s16.wav", x, SR)
        res = {"windows": [], "posts": [], "frames": [], "shapes": set()}

        def run():
            srv = ShellServer(Settings(), port=0, source="wav",
                              wav_path=str(d / "s16.wav"),
                              user_dir=str(d / "ud"), device=dev)
            url = f"http://127.0.0.1:{srv.port}"
            stop = threading.Event()

            def viewer():
                while not stop.wait(1 / 15):
                    t0 = time.perf_counter()
                    with urllib.request.urlopen(url + "/api/frame",
                                                timeout=60) as r:
                        raw = r.read()
                    res["frames"].append((time.perf_counter() - t0) * 1e3)
                    h, w = (int.from_bytes(raw[i:i + 4], "big")
                            for i in (0, 4))
                    res["shapes"].add((h, w, (len(raw) - 8) / (h * w)))

            def snapshot():
                # after a drain tick that painted, under the lock, with no
                # whole hop of the audio read left to analyze: the columns
                # then account for all of it but less than a hop.  A tick
                # that stopped at DRAIN_HOLD_S, or feeder blocks pushed
                # since the tick, leave hops pending: wait for the next
                # tick (a stream slower than real time never drains, and
                # is read at the deadline with its backlog)
                deadline = time.perf_counter() + 5.0
                while True:
                    ticks = srv.columns_emitted
                    while (srv.columns_emitted == ticks
                           and time.perf_counter() < deadline):
                        time.sleep(0.0005)
                    with srv.lock:
                        st = srv.app.stream
                        written = st.ring.total_written
                        if (st.hop_pending()
                                and time.perf_counter() < deadline):
                            continue
                        check_native_ring("app", st)
                        return (st, srv.columns_emitted, written,
                                st.dropped_frames)

            def window(label, seconds):
                st0, c0, w0, _ = snapshot()
                time.sleep(seconds)
                st1, c1, w1, dropped = snapshot()
                check(st1 is st0, f"app {label}: the stream changed inside "
                      f"the window")
                hops = (w1 - w0) / st0.pipe.hop
                ratio = (c1 - c0) / hops
                res["windows"].append((label, c1 - c0, hops, ratio, dropped))
                check(ratio >= KEEP_UP and dropped == 0,
                      f"app {label}: {c1 - c0} columns for {hops:.1f} audio "
                      f"hops ({ratio:.4f} < {KEEP_UP}) or {dropped} dropped "
                      f"frames")

            def post(label, payload, kind):
                st = srv.app.stream
                caps = st.captures
                req = urllib.request.Request(
                    url + "/api/settings", data=json.dumps(payload).encode(),
                    method="POST")
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as r:
                    got = json.loads(r.read())["kind"]
                wall = (time.perf_counter() - t0) * 1e3
                new = srv.app.stream
                check(got == kind, f"app {label}: kind {got}, want {kind}")
                if kind == "continuous":
                    check(new is st and st.captures == caps,
                          f"app {label}: the slider re-captured or swapped")
                    gap = None
                else:
                    check(new is not st and new.captures == 1,
                          f"app {label}: {new.captures} captures")
                    while new.last_column() is None:
                        check(time.perf_counter() - t0 < 30,
                              f"app {label}: no column 30 s after the swap")
                        time.sleep(0.001)
                    gap = (time.perf_counter() - t0) * 1e3
                res["posts"].append((label, kind, wall, gap))

            srv.start()
            th = threading.Thread(target=viewer, daemon=True)
            th.start()
            try:
                time.sleep(1.0)
                window("display default", 2.5)
                post("gain 5", {"gain": 5.0}, "continuous")
                window("after the slider", 1.5)
                post("fft 4096 single-bank", {"multires": False,
                                              "fft_size": 4096}, "structural")
                time.sleep(0.3)
                window("4096 single-bank", 3.0)
                post("natural", {"mode": "natural"}, "structural")
                time.sleep(0.3)
                window("natural 4096", 3.0)
            finally:
                stop.set()
                th.join(timeout=60)
                srv.stop()
            res["ticks"] = list(srv.tick_ms)
            res["columns"] = srv.columns_emitted

        drive("app", run)
        # the app's own columns: two runs, and the default process of the
        # same WAV, bit for bit (the app paints all but the last R)
        vis_a, rgba_a, samples = app_columns(dev, d / "s16.wav")
        vis_a2, rgba_a2, _ = app_columns(dev, d / "s16.wav", chunk=777)
        vis_b, rgba_b, _ = Pipeline(MULTIRES, dev).process(samples)
        n = vis_a.shape[0]
        check(torch.equal(vis_a, vis_a2) and torch.equal(rgba_a, rgba_a2),
              "app: two runs of the app's pushes differ")
        check(n + Pipeline(MULTIRES, dev).reach == vis_b.shape[0]
              and torch.equal(vis_a, vis_b[:n])
              and torch.equal(rgba_a, rgba_b[:n]),
              f"app: the app's {n} columns are not process's bit for bit")
        res["app_columns"] = n
    check(res["shapes"] == {(512, 1024, 4)} and len(res["frames"]) >= 20,
          f"app: /api/frame shapes {res['shapes']}, {len(res['frames'])} GETs")
    t50, t99 = _percentiles(res["ticks"])
    f50, f99 = _percentiles(res["frames"])
    print("app: ShellServer(Settings()) on the card, a 16 s WAV looped at "
          "real time, driven over HTTP; keep-up by window (columns painted / "
          "audio hops, dropped frames): " + "; ".join(
              f"{lb} {c} / {h:.1f} = {r:.4f}, dropped {dr}"
              for lb, c, h, r, dr in res["windows"])
          + "; POST walls (and gap to the new stream's first column): "
          + "; ".join(f"{lb} ({k}) {w:.1f} ms"
                      + ("" if g is None else f" (gap {g:.1f} ms)")
                      for lb, k, w, g in res["posts"])
          + f"; drain tick wall p50 {t50:.3f} ms, p99 {t99:.3f} ms over "
          f"{len(res['ticks'])} ticks that painted ({res['columns']} "
          f"columns); /api/frame wall p50 {f50:.3f} ms, p99 {f99:.3f} ms "
          f"over {len(res['frames'])} GETs, each (512, 1024, 4); "
          f"EmSpecApp's {res['app_columns']} columns of the WAV (1024- and "
          f"777-sample pushes) bit-equal to each other and to process in "
          f"vis and rgba; launches "
          f"{LAUNCHES['app']}, B2 routes {ROUTE_LAUNCHES['app']}", flush=True)


def swap_stalls(mode: str) -> dict:
    """Run in a fresh process (``python3 chip_smoke.py swap-stalls
    MODE``): open the app on the display default as ``gui`` does, then
    swap once to each of natural, back to the display default, and each
    dropdown size ≤ 32768 single-bank → {"first": {name:
    (``EmSpecApp.apply_settings`` wall ms, its parts ms: ``_time_parts``)}};
    each new stream must paint.
    ``cold``: nothing warmed, so each swap but the one back to the display
    default is its variant's first use in the process (the pipeline's
    tables, cuFFT plans, the first launch of each kernel it runs, three
    eager hops, the capture); then the same swaps again ("again": every
    cache warm, the warm-up hops and the capture alone).  ``prewarmed``:
    first the app's own prewarm of the dropdown and the multires base, as
    ``gui`` starts it, and ``prewarm`` of the natural base (which ``gui``
    does not warm), finished."""
    from emspec_torch.app import EmSpecApp
    from emspec_torch.pipeline import prewarm

    _time_parts()
    dev = torch.device("cuda")
    base = Settings()
    natural = base.replace(mode="natural")
    audio = signal(1.5)               # a first column at every variant
    variants = [("natural", natural), ("multires", base)] + [
        (str(n), base.replace(multires=False, fft_size=n))
        for n in SWAP_SIZES]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        app = EmSpecApp(base, user_dir=tmp, device=dev,
                        prewarm_sizes=SWAP_SIZES if mode == "prewarmed"
                        else None)
        app.push_audio(audio)
        if mode == "prewarmed":
            app._warm_future.result(timeout=600)
            prewarm(natural, (4096,), background=False, device=dev)
        for label in ("first", "again") if mode == "cold" else ("first",):
            out[label] = {}
            for name, v in variants:
                out[label].update(swaps_one(app, name, v, audio))
        app.close()
    return out


def swap_phase(dev, x: np.ndarray) -> None:
    """The swap stall and memory across swaps.  ``swap_stalls`` cold and
    prewarmed, each in a process of its own.  Then, in this process, ten
    swaps while background prewarms of the dropdown (four, queued) run:
    each a new
    stream captured once, a continuous change between them capturing
    nothing; reserved memory after swap 10 must be within one stream's
    (the most that building one of the cycle's streams reserves on an
    emptied cache) of after swap 2."""
    from emspec_torch.app import EmSpecApp
    from emspec_torch.pipeline import _cached_pipeline, prewarm

    stalls = {}
    for mode in ("cold", "prewarmed"):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "swap-stalls", mode], capture_output=True,
                           text=True, timeout=900, cwd=ROOT)
        check(r.returncode == 0, f"swap-stalls {mode}: exit "
              f"{r.returncode}: {r.stderr[-3000:]}")
        stalls.update({f"{mode} {k}": v for k, v in json.loads(
            r.stdout.strip().splitlines()[-1]).items()})
        stalls[mode + " process s"] = time.perf_counter() - t0
    base = Settings()
    natural = base.replace(mode="natural")
    audio = x[:3 * SR // 2]        # a first column at every variant
    with tempfile.TemporaryDirectory() as tmp:
        app = EmSpecApp(base.replace(multires=False, fft_size=512),
                        user_dir=tmp, device=dev)
        cycle = [base.replace(multires=False, fft_size=4096), natural,
                 base.replace(multires=False, fft_size=8192), base,
                 base.replace(multires=False, fft_size=2048), natural,
                 base.replace(multires=False, fft_size=16384), base,
                 base.replace(multires=False, fft_size=1024), natural]
        pool = 0
        for v in dict.fromkeys(cycle):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            r0 = torch.cuda.memory_reserved(dev)
            st = Stream(v, dev)
            pool = max(pool, torch.cuda.memory_reserved(dev) - r0)
            st.close()
        # the dropdown four times over on the warmer: eager card work on
        # its thread through most of the swaps below
        _cached_pipeline.cache_clear()
        warms = [prewarm(base, SWAP_SIZES, device=dev) for _ in range(4)]
        reserved, during = [], 0
        for i, v in enumerate(cycle):
            during += not all(w.done() for w in warms)
            old = app.stream
            check(app.apply_settings(v) == "structural"
                  and app.stream is not old and app.stream.captures == 1,
                  f"swap {i + 1} under prewarm: {app.stream.captures} "
                  f"captures")
            app.push_audio(audio)
            st = app.stream
            check_native_ring(f"swap {i + 1}", st)
            check(app.set(gain=app.settings.gain + 0.5) == "continuous"
                  and app.stream is st and st.captures == 1,
                  f"swap {i + 1}: the slider re-captured")
            app.push_audio(audio)
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved(dev))
        for w in warms:
            w.result(timeout=300)
        app.close()
    check(during >= 1, "swap: the prewarm finished before the first swap")
    grew = reserved[9] - reserved[1]
    check(grew <= pool, f"swap: reserved grew {grew} B from swap 2 to swap "
          f"10, more than one stream's {pool} B ({reserved})")
    mib = 1 << 20
    print("swap: EmSpecApp.apply_settings wall, ms, cold / prewarmed / "
          "again (cold and prewarmed each a fresh process, again the cold "
          "one's second pass): "
          + ", ".join(f"{k} " + " / ".join(
              f"{stalls[m][k][0]:.1f}" for m in (
                  "cold first", "prewarmed first", "cold again"))
              for k in stalls["cold first"])
          + "; parts of each swap over 40 ms (ms: pipeline build, warm-up "
          "and capture, of it pinned buffers, the old stream's close, gc): "
          + ", ".join(f"{m.split()[0]} {k} {w:.1f} = " + " ".join(
              f"{part} {ms:.1f}" for part, ms in sorted(parts.items()))
              for m in ("cold first", "prewarmed first", "cold again")
              for k, (w, parts) in stalls[m].items() if w > 40)
          + f" (processes {stalls['cold process s']:.1f} s, "
          f"{stalls['prewarmed process s']:.1f} s); ten swaps under a running "
          f"prewarm ({during} of them before it finished): reserved MiB "
          f"after each {[round(r / mib, 1) for r in reserved]}, swap 2 → "
          f"10 {grew / mib:+.1f} MiB, one stream's memory up to "
          f"{pool / mib:.1f} MiB", flush=True)


SPLIT: dict = {}        # part of a swap → ms so far (``swap_stalls``)


def _add_ms(part: str, t0: float) -> None:
    SPLIT[part] = SPLIT.get(part, 0.0) + (time.perf_counter() - t0) * 1e3


def _time_parts() -> None:
    """Time the parts of a swap into ``SPLIT``: the pipeline build
    (``get_pipeline`` from ``Stream``), the warm-up hops and the capture
    (``Stream._capture``), the pinned staging buffers inside it, the old
    stream's ``close``, and Python's garbage collections."""
    import gc

    from emspec_torch import stream as stream_mod

    def timed(owner, name: str, part: str) -> None:
        fn = getattr(owner, name)

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                _add_ms(part, t0)
        setattr(owner, name, wrapper)

    timed(stream_mod, "get_pipeline", "pipeline")
    timed(stream_mod.Stream, "_capture", "capture")
    timed(stream_mod.Stream, "close", "close")
    empty = torch.empty

    def pinned_empty(*a, **kw):
        t0 = time.perf_counter()
        try:
            return empty(*a, **kw)
        finally:
            if kw.get("pin_memory"):
                _add_ms("pinned", t0)
    torch.empty = pinned_empty
    gc_t0 = [0.0]

    def gc_timer(phase: str, info: dict) -> None:
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            _add_ms("gc", gc_t0[0])
    gc.callbacks.append(gc_timer)


def swaps_one(app, name: str, v: Settings, audio) -> dict:
    """One timed structural swap of ``app`` to ``v`` (from a structurally
    different setting), whose new stream must paint → {name: (wall ms,
    {part: ms} of ``SPLIT`` within it)}."""
    if app.settings == v:
        app.apply_settings(v.replace(hop=v.hop_samples * 2))
    torch.cuda.synchronize()
    before = dict(SPLIT)
    t0 = time.perf_counter()
    check(app.apply_settings(v) == "structural", f"swap {name}: not "
          f"structural")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    parts = {k: v - before.get(k, 0.0) for k, v in SPLIT.items()
             if v - before.get(k, 0.0) > 0.05}
    check(app.push_audio(audio) > 0 and app.stream.captures == 1,
          f"swap {name}: the new stream painted nothing")
    return {name: (wall, parts)}


def live_cli_phase(x: np.ndarray) -> None:
    """The CLI's live commands as a user runs them, each a subprocess on
    the card that must exit 0: ``live --capture --backend synthetic
    --duration 2`` (the display default; it must report the synthetic
    backend), ``live <4 s WAV> --fast``, ``presets add/show/delete``,
    ``gui --duration 3 --no-prewarm`` (the web shell on auto capture: it
    must paint columns and drop none) and ``doctor --kernels``; walls."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [q for q in [os.environ.get("PYTHONPATH")] if q]))
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        write_wav(d / "s4.wav", x[:4 * SR], SR)
        runs = (("live --capture", ["live", "--capture", "--backend",
                                    "synthetic", "--duration", "2"]),
                ("live --fast", ["live", "s4.wav", "--fast"]),
                ("presets add", ["presets", "add", "--name", "Smoke",
                                 "--gain", "6", "--file", "p.json"]),
                ("presets show", ["presets", "show", "--name", "Smoke",
                                  "--file", "p.json"]),
                ("presets delete", ["presets", "delete", "--name", "Smoke",
                                    "--file", "p.json"]),
                ("gui", ["gui", "--duration", "3", "--no-prewarm", "--port",
                         "0", "--user-dir", "ud"]),
                ("doctor --kernels", ["doctor", "--kernels"]))
        walls, outs, stdout = {}, {}, {}
        for label, args in runs:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "emspec_torch", *args],
                               cwd=d, env=env, capture_output=True, text=True,
                               timeout=600)
            walls[label] = time.perf_counter() - t0
            check(r.returncode == 0, f"cli {label}: exit {r.returncode}: "
                  f"{r.stdout[-1500:]} {r.stderr[-2000:]}")
            stdout[label] = r.stdout.strip()
            outs[label] = (stdout[label].splitlines() or [""])[-1]
        outs["gui"] = " | ".join(stdout["gui"].splitlines())
        outs["presets show"] = stdout["presets show"].replace("\n", " ")
        shown = json.loads(stdout["presets show"])
        left = json.loads((d / "p.json").read_text())
    check(shown["gain"] == 6.0 and list(left) == ["Default"],
          f"cli presets: shown gain {shown['gain']}, left {list(left)}")
    check("synthetic capture" in outs["live --capture"],
          f"cli live --capture: {outs['live --capture']!r}")
    check("displayed" in outs["live --fast"], f"cli live --fast: "
          f"{outs['live --fast']!r}")
    stopped = outs["gui"].split("shell stopped: ")[-1].split()
    check(len(stopped) > 1 and int(stopped[0]) > 0
          and "0 dropped frames" in outs["gui"], f"cli gui: {outs['gui']!r}")
    check("all checks passed" in outs["doctor --kernels"],
          f"cli doctor: {outs['doctor --kernels']!r}")
    ring_row = [ln for ln in stdout["doctor --kernels"].splitlines()
                if " native ring " in ln]
    check(len(ring_row) == 1 and ring_row[0].startswith("ok"),
          f"cli doctor: native ring row {ring_row}")
    kernels_row = [ln for ln in stdout["doctor --kernels"].splitlines()
                   if " cuda kernels " in ln]
    check(len(kernels_row) == 1 and kernels_row[0].startswith("ok")
          and all(f in kernels_row[0] for f in DOCTOR_FORMS),
          f"cli doctor: the kernels row {kernels_row} does not name each "
          f"of {DOCTOR_FORMS}")
    print(f"live_cli: doctor --kernels wall {walls['doctor --kernels']:.2f} "
          f"s; its row: {kernels_row[0]}", flush=True)
    print("live_cli: python -m emspec_torch, each a subprocess that exited "
          "0, wall s: " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
          + "; last lines: " + " | ".join(outs.values()), flush=True)


# the forms doctor --kernels must name: B2's ordered forms, B1's windowed
DOCTOR_FORMS = ("sorted batch", "sorted tiles", "ring local", "ring cluster",
                "ring windows", "ring bands", "B1 whole, windowed",
                "rfft power, spectrum")


def validate_bites(dev) -> None:
    """Each new check of ``doctor --kernels`` on the card against the
    broken stand-ins of ``tests/test_torch_validate.py``
    (``validate.perturbed``: a cell one ulp off, the sum in reverse
    deposit order, an output's old values dropped, a NaN behind a dropped
    id landed; B1's ids moved a row, its band weight left out): the form's
    validator must raise ``AssertionError`` from that form's check each
    time.  The untouched kernels pass in ``live_cli``'s doctor."""
    t0 = time.perf_counter()
    refused = []
    for form, (name, hows) in kernel_validate.PERTURBATIONS.items():
        where = form if form.startswith(("B1", "rfft")) else f"B2 {form}"
        for how in hows:
            try:
                with kernel_validate.perturbed(form, how):
                    getattr(kernel_validate, name)(dev, quick=True)
            except AssertionError as e:
                check(str(e).startswith(where), f"validate: {name} with "
                      f"{form} broken ({how}) raised from another check: {e}")
                refused.append(f"{form} {how}")
                continue
            fail(f"validate: {name} passed with {form} broken ({how})")
    print(f"validate: {len(refused)} broken stand-ins, each refused by its "
          f"form's check on the card in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(refused)})", flush=True)


RING_TURNS = (False, True, True, False) * 2  # native_ring, in turns


def ring_ab_phase(dev, x: np.ndarray) -> None:
    """The host ring under the live path: the display default live and
    north live, each through a graphed ``Stream`` on the numpy ring
    (``native_ring=False``) and on the native ring, in turns (numpy,
    native, native, numpy, twice; a fresh stream each), the 16 s signal
    in the live phases' pushes → host p50/p99 ms a hop of each ring over
    its four runs, and each run's p50 for the spread (push →
    synchronize, as ``live_phase``)."""
    rows = []
    for name, s, chunk in (("multires_live", MULTIRES, 1024),
                           ("north_live", NORTH, 800)):
        lat = {False: [], True: []}
        turns = {False: [], True: []}
        for native_ring in RING_TURNS:
            st = Stream(s, dev, native_ring=native_ring)
            want = NativeRingBuffer if native_ring else RingBuffer
            check(type(st.ring) is want, f"ring A/B {name}: "
                  f"{type(st.ring).__name__}, want {want.__name__}")
            cols, run = 0, []
            for i in range(0, x.shape[-1], chunk):
                t0 = time.perf_counter()
                got = st.push(x[i:i + chunk])
                if got:
                    torch.cuda.synchronize()
                    run.append((time.perf_counter() - t0) / len(got))
                cols += len(got)
            lat[native_ring] += run
            turns[native_ring].append(float(np.percentile(run, 50)) * 1e3)
            check(cols + st.reach == st.pipe.num_columns(x.shape[-1]),
                  f"ring A/B {name}: {cols} columns")
            st.close()
        q = {k: _percentiles(np.asarray(v) * 1e3) for k, v in lat.items()}
        rows.append(
            f"{name} numpy p50 {q[False][0]:.4f} ms, p99 {q[False][1]:.4f} "
            f"ms; native p50 {q[True][0]:.4f} ms, p99 {q[True][1]:.4f} ms "
            f"({len(lat[True])} hops each; each run's p50, numpy "
            + " ".join(f"{v:.4f}" for v in turns[False]) + ", native "
            + " ".join(f"{v:.4f}" for v in turns[True]) + ")")
    print("ring_ab: graphed Stream per hop on each host ring, in turns "
          "numpy, native, native, numpy, twice (host clock, push → "
          "synchronize): " + "; ".join(rows), flush=True)


EXAMPLES = ("offline_render", "streaming", "animate", "export_arrays",
            "multichip_sharded", "time_parallel_render")
SHARDED_EXAMPLES = ("multichip_sharded", "time_parallel_render")


def examples_phase() -> None:
    """The port's examples as a user runs them, ``python -m
    emspec_torch.examples.<name>`` on the card, each a subprocess that
    must exit 0 and print; the time-parallel render within 1e-5 of one
    device in ``vis``.  The six start together (a process start is most
    of each wall); then the sharded two under ``torchrun`` across every
    card, where there are two or more."""
    from concurrent.futures import ThreadPoolExecutor

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [q for q in [os.environ.get("PYTHONPATH")] if q]))
    runs = [(name, [sys.executable, "-m", f"emspec_torch.examples.{name}"])
            for name in EXAMPLES]
    cards = torch.cuda.device_count()
    if cards >= 2:
        runs += [(f"{name} x{cards}",
                  [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc-per-node", str(cards), "-m",
                   f"emspec_torch.examples.{name}"])
                 for name in SHARDED_EXAMPLES]
    walls, lasts = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        def run(item):
            label, args = item
            cwd = Path(tmp) / label.replace(" ", "_")
            cwd.mkdir()
            t0 = time.perf_counter()
            r = subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                               text=True, timeout=600)
            return label, r, time.perf_counter() - t0

        with ThreadPoolExecutor(len(EXAMPLES)) as pool:
            done = list(pool.map(run, runs[:len(EXAMPLES)]))
        done += [run(item) for item in runs[len(EXAMPLES):]]
        for label, r, wall in done:
            walls[label] = wall
            check(r.returncode == 0 and r.stdout.strip(),
                  f"example {label}: exit {r.returncode}: "
                  f"{r.stdout[-1500:]} {r.stderr[-2000:]}")
            lasts[label] = " / ".join(r.stdout.strip().splitlines()[-2:])
            if label.startswith("time_parallel_render"):
                diffs = [float(ln.rsplit(": ", 1)[1])
                         for ln in r.stdout.splitlines()
                         if "vs single-device: " in ln]
                check(len(diffs) == 2 and max(diffs) <= STREAM_VIS_ATOL,
                      f"example {label}: max |Δvis| {diffs}")
    print("examples: python -m emspec_torch.examples.<name> on the card, "
          "each a subprocess that exited 0, the six started together, "
          "wall s: " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
          + f" (phase {time.perf_counter() - t_phase:.1f})"
          + ("" if cards >= 2 else "; under torchrun: not run (1 card)")
          + "; last lines: " + " | ".join(f"{k}: {v}"
                                          for k, v in lasts.items()),
          flush=True)


def lut_steps(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor):
    """RGBA (..., 4) of two renders and their colormap → (the largest
    difference of their colormap indices where they differ, the share of
    pixels that differ).  Adjacent entries differ by up to 5 a byte, so
    "rgba ±1" is held as one step of the colormap; a differing pixel that
    is no colormap entry fails."""
    dev = a.device
    weights = torch.tensor([1 << 24, 1 << 16, 1 << 8, 1], device=dev)
    key = lambda t: (t.to(torch.int64) * weights).sum(-1)
    keys, order = torch.sort(key(table.to(dev)))
    a, b = a.reshape(-1, 4), b.reshape(-1, 4)
    moved = (a != b).any(-1)

    def index(t):
        k = key(t[moved])
        pos = torch.searchsorted(keys, k).clamp(max=keys.numel() - 1)
        check(bool((keys[pos] == k).all()), "lut_steps: a differing pixel "
              "is no colormap entry")
        return order[pos]
    steps = (index(a) - index(b)).abs()
    return (int(steps.max()) if steps.numel() else 0,
            float(moved.double().mean()))


def hold_batch(name: str, got, want, table) -> str:
    """A sharded batch result against the unsharded one: vis within
    ``STREAM_VIS_ATOL``, rgba within one colormap step, the final state
    within the JAX package's bounds (smooth 1e-5, agc_ref 1e-4)."""
    vis, rgba, st = got
    vis1, rgba1, st1 = want
    check(vis.shape == vis1.shape and rgba.shape == rgba1.shape,
          f"{name}: shapes {tuple(vis.shape)} vs {tuple(vis1.shape)}")
    check(bool(torch.isfinite(vis).all()), f"{name}: non-finite vis")
    dv = float((vis - vis1).abs().max())
    steps, share = lut_steps(rgba, rgba1, table)
    ds = float((st.smooth - st1.smooth).abs().max())
    dr = float((st.agc_ref - st1.agc_ref).abs().max())
    check(dv <= STREAM_VIS_ATOL and steps <= 1 and ds <= 1e-5 and dr <= 1e-4,
          f"{name} ≠ unsharded: |Δvis| {dv}, colormap steps {steps}, "
          f"|Δsmooth| {ds}, |Δagc_ref| {dr}")
    return (f"max |Δvis| {dv:.3g}, colormap steps {steps} ({share:.2e} of "
            f"the pixels), |Δsmooth| {ds:.3g}, |Δagc_ref| {dr:.3g}")


def parallel_phase(dev, xs: np.ndarray, xs_live: np.ndarray, vis_sl,
                   x: np.ndarray, vis_m) -> None:
    """The sharded paths at world size 1 under NCCL (``emspec_torch.
    parallel``), each driven once (counters, the collectives of that
    call) and held to the unsharded path on the card, then timed beside
    it with CUDA events."""
    import torch.distributed as dist

    from emspec_torch import parallel as par

    created = par.init_group(dev)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"parallel: group {dist.get_backend()} of "
          f"{dist.get_world_size()}")
    mesh = par.channel_mesh(device=dev)
    table = torch.from_numpy(lut("inferno").copy()).to(dev)

    def census(path, fn):
        par.COLLECTIVES.clear()
        out = drive(path, fn)
        return out, dict(par.COLLECTIVES)

    for agc in (False, True):
        name = "sharded_pipeline" + ("_agc" if agc else "")
        s = STRESS.replace(agc_global=agc)
        gpu = Pipeline(s, dev)
        p, xg = gpu.params(), gpu.to_device(xs)
        sp = par.ShardedPipeline(s, mesh)
        got, coll = census(name, lambda: sp.process(xg, p))
        held = hold_batch(name, got, gpu.process(xg, p), table)
        ms = cuda_ms(lambda: sp.process(xg, p), iters=10)
        ms1 = cuda_ms(lambda: gpu.process(xg, p), iters=10)
        print(f"parallel {name}: {tuple(xs.shape)} samples, 1 rank of "
              f"{s.channels} channels; vs Pipeline.process: {held}; "
              f"{ms:.4f} ms/call (unsharded {ms1:.4f}; CUDA events, "
              f"device-resident input); collectives a call {coll}; "
              f"launches {LAUNCHES[name]}", flush=True)

    (vis, rgba), coll = census("sharded_stream", lambda:
                               par.stream_signal_sharded(xs_live, STRESS,
                                                         mesh))
    dv = float(np.abs(vis - vis_sl.cpu().numpy()).max())
    check(vis.shape == tuple(vis_sl.shape) and dv == 0.0,
          f"sharded_stream ≠ the default batch bit for bit: shapes "
          f"{vis.shape} {tuple(vis_sl.shape)}, max |Δvis| {dv}")
    hops = vis.shape[0] + Pipeline(STRESS, dev).reach
    steps = {}
    for agc in (False, True):
        s = STRESS.replace(agc_global=agc)
        st = par.ShardedStream(s, mesh)
        pipe = st.pipe
        st.reset_window(xs_live[:, :pipe.n_max])
        block = xs_live[:, pipe.n_max - pipe.roll:pipe.n_max]
        par.COLLECTIVES.clear()
        st.step(block)
        step_coll = dict(par.COLLECTIVES)
        blk = pipe.to_device(block)
        carry, p = pipe.init_roll_carry((s.channels,)), pipe.params()
        steps[agc] = (cuda_ms(lambda: st.step(block), iters=50),
                      cuda_ms(lambda: pipe._stream_step_rolling(
                          carry, blk, p), iters=50), step_coll)
    print(f"parallel sharded_stream: stream_signal_sharded of "
          f"{tuple(xs_live.shape)} samples, {hops} hops of "
          f"{Pipeline(STRESS, dev).hop}; ≡ the stress batch bit for bit; "
          f"collectives in the run {coll}; a hop (CUDA events, eager, the "
          f"block from the host): {steps[False][0]:.4f} ms (the unsharded "
          f"eager step {steps[False][1]:.4f}, block on the card), "
          f"collectives {steps[False][2]}; with the global AGC "
          f"{steps[True][0]:.4f} ms (unsharded {steps[True][1]:.4f}), "
          f"collectives {steps[True][2]}; launches "
          f"{LAUNCHES['sharded_stream']}", flush=True)

    for name, s, sig, m in (
            ("time_parallel", MULTIRES, x,
             par.channel_mesh(axis="t", device=dev)),
            ("time_parallel_2d", STRESS.replace(agc_global=True), xs,
             par.ch_time_mesh(1, device=dev))):
        r = par.TimeParallelRenderer(s, m)
        gpu = Pipeline(s, dev)
        p = gpu.params()
        got, coll = census(name, lambda: r.render(sig))
        want = gpu.process(sig, p)
        held = hold_batch(name, got, want, table)
        ms = cuda_ms(lambda: r.render(sig), iters=10)
        ms1 = cuda_ms(lambda: gpu.process(sig, p), iters=10)
        print(f"parallel {name}: {tuple(sig.shape)} samples → "
              f"{got[0].shape[0]} columns, mesh "
              f"{dict(zip(m.mesh_dim_names, m.shape))}; vs "
              f"Pipeline.process: {held}; {ms:.4f} ms/call (unsharded "
              f"{ms1:.4f}; CUDA events, host input); collectives a call "
              f"{coll}; launches {LAUNCHES[name]}", flush=True)
        if name == "time_parallel":
            dm = float((got[0] - vis_m).abs().max())
            check(dm <= STREAM_VIS_ATOL, f"{name} ≠ the multires phase's "
                  f"vis: {dm}")
            print(time_parallel_sums(r, sig), flush=True)
    if created:
        dist.destroy_process_group()


def time_parallel_sums(r, sig: np.ndarray) -> str:
    """Two ``render`` calls of the time renderer ``r``: its grid before
    the post chain (``_enhanced_power``, ``exact_sums``) bit-equal and its
    columns too; its sum (the ``histogram`` call it makes, B2's sorted
    tiles) against the global route at the same ids in turns (medians of
    three rounds) → the line."""
    from emspec_torch import pipeline as plm

    grids, sums, vis = [], [], []
    power, hist = r.pipe._enhanced_power, plm.histogram

    def keep_grid(*args, **kw):
        grids.append(power(*args, **kw))
        return grids[-1]

    def keep_sum(*args, **kw):
        sums.append((args, kw))
        return hist(*args, **kw)
    r.pipe._enhanced_power = keep_grid
    plm.histogram = keep_sum
    try:
        for _ in range(2):
            vis.append(r.render(sig)[0])
    finally:
        del r.pipe._enhanced_power
        plm.histogram = hist
    differ = int((grids[0] != grids[1]).sum())
    check(differ == 0 and torch.equal(vis[0], vis[1]), f"time_parallel: "
          f"two renders' grids differ in {differ} cells")
    (ids, vals, cells), kw = sums[0][0][:3], sums[0][1]
    check(kw.get("route") == SORTED and kw.get("reach") == r.pipe.reach,
          f"time_parallel: its sum is not B2's sorted tiles ({kw})")
    turns: dict = {}
    for who in EXACT_TURNS:
        turns.setdefault(who, []).append(device_ms(
            (lambda: histogram(ids, vals, cells)) if who == "global"
            else (lambda: histogram(ids, vals, cells, **kw))))
    med = {k: float(np.median(v)) for k, v in turns.items()}
    EXACT_TP.update(at=f"ids {tuple(ids.shape)} → {cells} cells, R = "
                    f"{r.pipe.reach}", turns_device_ms=turns,
                    median_device_ms=med, **bound_of_sum(ids, vals, cells))
    return (f"parallel time_parallel: grid bit-equal on two renders, "
            f"columns too; its sum ({tuple(ids.shape)} → {cells} cells) in "
            f"turns (medians): tiles {med['tiles']:.4f} vs the global "
            f"route {med['global']:.4f} ms")


def checkpoint_phase(dev, x: np.ndarray) -> None:
    """A graphed ``Stream`` saved at hop 187 and resumed in a fresh one."""
    from emspec_torch.utils.checkpoint import load_stream, save_stream

    hop, n = SETTINGS.hop_samples, SETTINGS.fft_size
    cut = 186 * hop + n                     # the window of hop 186 is in

    def push(st, lo, hi, chunk=1024):       # as the live phase feeds it
        return [c for i in range(lo, hi, chunk)
                for c in st.push(x[i:min(i + chunk, hi)])]
    ref = Stream(SETTINGS, dev)
    want = push(ref, 0, x.shape[-1]) + ref.flush()

    def run():
        a = Stream(SETTINGS, dev)
        cols = push(a, 0, cut)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            save_stream(Path(tmp) / "s.npz", a)
            save_s = time.perf_counter() - t0
            b = Stream(SETTINGS, dev)
            t0 = time.perf_counter()
            load_stream(Path(tmp) / "s.npz", b)
            load_s = time.perf_counter() - t0
        cols += push(b, cut, x.shape[-1]) + b.flush()
        return a, b, cols, save_s, load_s
    a, b, cols, save_s, load_s = drive("checkpoint", run)
    check(a._t == 187 and b.captures == 1,
          f"checkpoint: saved at hop {a._t}, {b.captures} captures")
    for st in (ref, a, b):
        check_native_ring("checkpoint", st)
    check([c.index for c in cols] == [c.index for c in want],
          "checkpoint: column indices differ from the uninterrupted run")
    diff = float((torch.stack([c.vis for c in cols])
                  - torch.stack([c.vis for c in want])).abs().max())
    check(diff <= STREAM_VIS_ATOL, f"checkpoint: resumed ≠ uninterrupted: "
          f"{diff}")
    print(f"checkpoint: graphed Stream saved at hop {a._t} of "
          f"{len(want) + ref.reach}, loaded into a fresh graphed Stream "
          f"(captures {b.captures}); max |vis − uninterrupted| {diff:.3g}; "
          f"save {save_s * 1e3:.1f} ms, load {load_s * 1e3:.1f} ms (host "
          f"clock); launches {LAUNCHES['checkpoint']}", flush=True)


CKPT_LIVE_SECONDS = 6.0     # of the signal: the producer laps the 4 s ring
CKPT_SAVE_EVERY = 0.5       # s between saves while the stream drains


def checkpoint_live(dev, x: np.ndarray) -> None:
    """The display default's graphed ``Stream`` (the default 4 s native
    ring) fed ``CKPT_LIVE_SECONDS`` of ``x`` by a producer thread at
    real-time pace in the web shell's feed blocks (``shell/feed.py``:
    rate // 50 samples), this thread draining 4 ms of hops at a time as
    the app's tick does and saving every ``CKPT_SAVE_EVERY`` s until the
    last second of audio is due: no save may raise, no frame drop, and
    each file's ``ring_data`` must be exactly ``x[ring_total − kept :
    ring_total]``.  A fresh graphed ``Stream`` loaded from the last file
    is fed the rest; the columns of both are the default batch's, bit for bit in
    ``vis`` and ``rgba``, at every hop.  The first save once the ring is
    full is lapped (``lap_next_read``): it must keep the span from the
    stream's first unread sample, exactly, and a fresh graphed ``Stream``
    loaded from it must give the default batch's columns too."""
    from emspec_torch.utils.checkpoint import load_stream, save_stream

    n = int(CKPT_LIVE_SECONDS * SR)
    xs = x[:n]
    block = SR // 50

    def lap_next_read(st, done) -> None:
        """The ring's next read waits, before it reads, for the producer's
        next push (at most 1 s): the whole-ring read a save starts with is
        lapped by a real push, as a push during that read would, and the
        save reads its second span."""
        read = st.ring.window_at

        def lapped(start, count):
            st.ring.window_at = read
            total, until = st.ring.total_written, time.perf_counter() + 1.0
            while (st.ring.total_written == total and not done.is_set()
                   and time.perf_counter() < until):
                time.sleep(0.0002)
            return read(start, count)
        st.ring.window_at = lapped

    def resume(z):
        """A fresh graphed Stream loaded from the saved ``z``, fed the
        rest of ``xs`` → (its columns, its stream)."""
        b = Stream(MULTIRES, dev)
        with tempfile.TemporaryDirectory() as tmp:
            np.savez(Path(tmp) / "saved.npz", **z)
            load_stream(Path(tmp) / "saved.npz", b)
        total = int(z["ring_total"])
        got = [c for i in range(total, n, block)
               for c in b.push(xs[i:min(i + block, n)])]
        return got + b._drain() + b.flush(), b

    def run():
        st = Stream(MULTIRES, dev)
        check_native_ring("checkpoint_live", st)
        done = threading.Event()

        def produce():
            t0 = time.perf_counter()
            for i in range(0, n, block):
                st.ring.push(xs[i:i + block])
                delay = t0 + (i + block) / SR - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            done.set()

        cols, files, save_ms, lapped = [], [], [], []
        producer = threading.Thread(target=produce)
        with tempfile.TemporaryDirectory() as tmp:
            producer.start()
            try:
                due = time.perf_counter() + CKPT_SAVE_EVERY
                while not done.is_set():
                    cols += st._drain(time.perf_counter() + 0.004)
                    if (time.perf_counter() >= due
                            and st.ring.total_written <= n - SR):
                        path = Path(tmp) / f"s{len(files)}.npz"
                        if not lapped and st.ring.total_written > \
                                st.ring.capacity + block:
                            lap_next_read(st, done)
                            lapped.append(len(files))
                        t0 = time.perf_counter()
                        try:
                            save_stream(path, st)
                        except ValueError as e:
                            fail(f"checkpoint_live: save {len(files)} under "
                                 f"the producer raised: {e}")
                        save_ms.append((time.perf_counter() - t0) * 1e3)
                        with np.load(path) as z:
                            files.append({k: z[k] for k in z.files})
                        due += CKPT_SAVE_EVERY
                    time.sleep(0.001)
            finally:
                producer.join()
        cols += st._drain() + st.flush()
        resumed, b = resume(files[-1])
        check(len(lapped) == 1, "checkpoint_live: no save came after the "
              "ring was full")
        resumed_lap, b_lap = resume(files[lapped[0]])
        return (st, b, b_lap, cols, resumed, resumed_lap, files, save_ms,
                lapped[0])

    (st, b, b_lap, cols, resumed, resumed_lap, files, save_ms,
     lap) = drive("checkpoint_live", run)
    cap = st.ring.capacity
    check(st.dropped_frames == 0 and len(files) >= 4 and b.captures == 1
          and b_lap.captures == 1,
          f"checkpoint_live: {st.dropped_frames} frames dropped, "
          f"{len(files)} saves, {b.captures}, {b_lap.captures} captures")
    short = []
    for i, z in enumerate(files):
        total, kept = int(z["ring_total"]), z["ring_data"].shape[-1]
        if kept < min(total, cap):
            short.append(i)
        check(0 < kept <= cap and np.array_equal(
            z["ring_data"][0], xs[total - kept:total]),
              f"checkpoint_live: save {i} stored other samples than "
              f"[{total} − {kept}, {total})")
    check(lap in short, f"checkpoint_live: the lapped save {lap} kept the "
          f"whole ring ({files[lap]['ring_data'].shape[-1]} of "
          f"{int(files[lap]['ring_total'])} samples): no second span")
    vis_b, rgba_b, _ = Pipeline(MULTIRES, dev).process(xs)
    t0 = int(files[-1]["t"]) - b.reach
    t_lap = int(files[lap]["t"]) - b.reach
    for label, got, first in (("the stream under the producer", cols, 0),
                              ("the resumed stream", resumed, t0),
                              (f"the stream resumed from lapped save {lap}",
                               resumed_lap, t_lap)):
        check([c.index for c in got] == list(range(first, vis_b.shape[0])),
              f"checkpoint_live: {label}'s columns are not "
              f"[{first}, {vis_b.shape[0]})")
        idx = torch.tensor([c.index for c in got], device=dev)
        check(torch.equal(torch.stack([c.vis for c in got]), vis_b[idx])
              and torch.equal(torch.stack([c.rgba for c in got]),
                              rgba_b[idx]),
              f"checkpoint_live: {label} ≠ the default batch bit for bit")
    print(f"checkpoint_live: the display default's graphed Stream fed "
          f"{CKPT_LIVE_SECONDS:g} s at real-time pace in blocks of {block} "
          f"by a producer thread (ring {cap}), {len(files)} saves while "
          f"draining, none raised, {len(short)} kept the span from the "
          f"first unread sample (a push lapped the whole-ring read: saves "
          f"{short}, save {lap} forced; kept "
          f"{files[lap]['ring_data'].shape[-1]} of ring_total "
          f"{int(files[lap]['ring_total'])}, exact, and a fresh graphed "
          f"Stream loaded from it gave its {len(resumed_lap)} columns ≡ the "
          f"batch), 0 dropped; "
          f"save ms min / median / max {min(save_ms):.2f} / "
          f"{median(save_ms):.2f} / {max(save_ms):.2f} (host clock); "
          f"its {len(cols)} columns and the {len(resumed)} of a fresh "
          f"graphed Stream loaded from save {len(files) - 1} (hop "
          f"{int(files[-1]['t'])}, ring_total {int(files[-1]['ring_total'])}"
          f") ≡ the default batch bit for bit in vis and rgba; launches "
          f"{LAUNCHES['checkpoint_live']}", flush=True)


# the kernels' names in a trace: B1 (block or cluster route), B2 (any
# route), the scan
TRACE_NAMES = {"B1": ("block_kernel", "cluster_kernel"),
               "B2": ("row_kernel", "global_kernel", "sorted_kernel",
                      "tiles_kernel", "batch_kernel"),
               "post_head": ("post_head_kernel",),
               "ema_scan": ("ema_speculate_kernel",),
               "post_tail": ("post_tail_speculate_kernel",),
               "repair": ("ema_repair_kernel",
                          "post_tail_repair_kernel")}


SPARSE_HOP = (          # hops at and past the largest frame: R = 0
    ("sparse_display_16384", Settings(hop=16384)),         # n_max 8192
    ("sparse_enhanced_12000", SETTINGS.replace(hop=12000)),
    ("sparse_enhanced_8192", SETTINGS.replace(hop=8192)),
    ("sparse_natural_4096", Settings(mode="natural", multires=False,
                                     fft_size=2048, hop=4096)),
    # the north star's 32768 and the stress cell's 16 channels at 96 kHz
    ("sparse_north_40000", NORTH.replace(hop=40000)),
    ("sparse_stress_40000", STRESS.replace(hop=40000)))
SPARSE_SECONDS = 8.0
SPARSE_PUSH = 777


def sparse_reach0(dev, name: str, pipe: Pipeline, x: np.ndarray) -> str:
    """B2 at R = 0 (a ring of one slot) against its plain versions: the
    ring form at frame ``mid``'s relative ids into a ring of random
    values at t = 0, 1 and mid (``histogram_ring_plain``), and the batch's
    bounded sorted form at reach 0 over all frames (``histogram_plain``),
    bit for bit, with NaN/Inf behind dropped and out-of-range ids; every
    lane (channel) of ``x`` its own."""
    ids_rel, contrib, _ = relative_ids(dev, pipe.settings, x)
    P, C = 2 * pipe.reach + 1, pipe.rows
    lead = tuple(ids_rel.shape[:-2])
    t_count, k = ids_rel.shape[-2], ids_rel.shape[-1]
    mid = t_count // 2
    rel = ids_rel[..., mid, :].contiguous()
    vals = contrib[..., mid, :].contiguous()
    pick = torch.from_numpy(np.random.default_rng(5).random(
        tuple(rel.shape)) < 0.1).to(dev)
    bad_ids = torch.where(pick, torch.where(rel % 2 == 0, -1, P * C + 7),
                          rel).to(torch.int32)
    bad_vals = torch.where(pick, torch.where(
        rel % 3 == 0, float("inf"), float("nan")), vals)
    ring0 = torch.rand((P,) + lead + (C,), device=dev)
    for t in (0, 1, mid):
        t_dev = torch.tensor(t, dtype=torch.int32, device=dev)
        for ids, v in ((rel, vals), (bad_ids, bad_vals)):
            want = histogram_ring_plain(ring_ids(ids.cpu(), t, P, C),
                                        v.cpu(), ring0.cpu().clone())
            got = histogram_ring(ids, v, ring0.clone(), t_dev)
            check(torch.equal(got.cpu(), want), f"{name}: B2's ring form at "
                  f"R = 0, t = {t} differs from its plain version")
    ids = pipe._absolute_ids(ids_rel, t_count, 0).reshape(
        lead + (-1,)).contiguous()
    flat_vals = contrib.reshape(lead + (-1,)).contiguous()
    form = sorted_form(t_count, k, 0, C, math.prod(lead))
    got = histogram(ids, flat_vals, t_count * C, route=SORTED, reach=0,
                    frame_len=k, column_len=C, form=form)
    check(torch.equal(got.cpu(), histogram_plain(
        ids.cpu(), flat_vals.cpu(), t_count * C)), f"{name}: B2's sorted "
          f"{form} form at R = 0 differs from the plain sum")
    return (f"B2 at R = 0 bit-equal to plain: the ring form (one slot, "
            f"{math.prod(lead)} lanes) at t = 0, 1, {mid} with and without "
            f"dropped ids, the {form} form over {t_count} frames of {k}")


def sparse_hop_phase(dev) -> None:
    """Each setting of ``SPARSE_HOP`` (a hop at or past the largest frame
    ``n_max``: the live window rolls by min(hop, n_max) samples) as a
    graph-captured ``Stream`` on the card's defaults, driven once
    (counters) in 777-sample pushes over 8 s, then flushed: its columns
    bit-equal to ``Pipeline.process`` on the card (driven once too) in
    vis and rgba; the batch against the port's CPU path (grid and vis as
    the batch phases hold them); on the enhanced settings B2's ring form
    once a hop and the bounded sorted form ``sorted_form`` names in the
    batch, no global sort and no atomic route, and B2 at R = 0 against its
    plain versions (``sparse_reach0``); p50/p99 host ms a hop."""
    for name, s in SPARSE_HOP:
        x = signal(SPARSE_SECONDS, s.channels, seed=24, sr=s.sample_rate)
        pipe = Pipeline(s, dev)
        check(pipe.reach == 0 and pipe.roll == pipe.n_max <= pipe.hop,
              f"{name}: reach {pipe.reach}, roll {pipe.roll}, n_max "
              f"{pipe.n_max}, hop {pipe.hop}")
        st = Stream(s, dev)
        check(st.captures == 1 and tuple(st._block.shape)
              == x.shape[:-1] + (pipe.roll,),
              f"{name}: {st.captures} graph captures, block "
              f"{tuple(st._block.shape)}")
        check_native_ring(name, st)
        lat: list = []
        cols = drive(name, lambda: stream_run(st, x, SPARSE_PUSH, lat))
        check(st.captures == 1, f"{name}: {st.captures} graph captures")
        st.close()
        xg = pipe.to_device(x)
        vis_b, rgba_b, _ = drive(f"{name}_batch", lambda: pipe.process(xg))
        t_count = pipe.num_columns(x.shape[-1])
        check([c.index for c in cols] == list(range(t_count)),
              f"{name}: column indices {[c.index for c in cols][:4]}… "
              f"differ from the batch's {t_count}")
        check(torch.equal(torch.stack([c.vis for c in cols]), vis_b)
              and torch.equal(torch.stack([c.rgba for c in cols]), rgba_b),
              f"{name}: the stream ≠ process on the card bit for bit")
        cpu = Pipeline(s, "cpu")
        vis_c, _, _ = cpu.process(x)
        check(bool(torch.isfinite(vis_b).all()), f"{name}: non-finite vis")
        if s.mode == "natural":
            want = cpu._natural_power(cpu.to_device(x), t_count,
                                      cpu.params())
            got = pipe._natural_power(xg, t_count, pipe.params()).cpu()
            worst = float((got - want).abs().max()) / float(want.max())
            check(worst <= NATURAL_POWER_TOL, f"{name}: GPU vs CPU power "
                  f"{worst}·peak > {NATURAL_POWER_TOL}")
            grid, sums = f"power max diff {worst:.2e}·peak", ""
        else:
            g = compare_grids(
                cpu._enhanced_power(cpu.to_device(x), t_count, cpu.params()),
                pipe._enhanced_power(xg, t_count, pipe.params()).cpu())
            check(g.ok, f"{name}: GPU vs CPU grid {g}")
            grid = f"energy {g.energy_rel:.2e}, grid maxf {g.maxf_rel:.2e}"
            live = ROUTE_LAUNCHES[name]
            batch = ROUTE_LAUNCHES[f"{name}_batch"]
            k = sum(hi - lo for lo, hi in pipe.k_slices)   # deposits a frame
            form = {"batch": SORTED_BATCH, "tiles": SORTED_TILES}[
                sorted_form(t_count, k, 0, pipe.rows, s.channels)]
            check(live[SORTED_RING] == t_count and all(
                n == 0 for r, n in live.items() if r != SORTED_RING),
                  f"{name}: the stream's B2 launches {live}, want its ring "
                  f"form once a hop ({t_count} hops)")
            check(batch[form] > 0 and all(
                n == 0 for r, n in batch.items() if r != form),
                  f"{name}: the batch's B2 launches {batch}, want its "
                  f"{form} form alone")
            sums = (f"; B2 routes live {live[SORTED_RING]}× the ring form, "
                    f"batch the {form} form; " + sparse_reach0(dev, name,
                                                               pipe, x))
        vis_ok, vd, vshare = compare_vis(vis_c.reshape(t_count, -1),
                                         vis_b.cpu().reshape(t_count, -1))
        check(vis_ok, f"{name}: GPU vs CPU vis max-filter diff {vd} (share "
              f"over 2/255: {vshare})")
        p50, p99 = _percentiles([v * 1e3 for v in lat])
        print(f"sparse_hop {name} ({CARD[0]}): {s.mode} n_max {pipe.n_max} "
              f"at hop {pipe.hop}, {s.channels} ch at {s.sample_rate} Hz "
              f"(R = 0, the window rolls {pipe.roll} "
              f"samples a hop, {pipe.hop - pipe.roll} skipped), "
              f"{SPARSE_SECONDS:.0f} s in {SPARSE_PUSH}-sample pushes: "
              f"{len(cols)} columns, one graph replay a hop, ≡ process on "
              f"the card bit for bit in vis and rgba; vs CPU path: {grid}, "
              f"vis maxf {vd:.2e} (share over 2/255 {vshare:.2e}); host ms "
              f"a hop p50 {p50:.3f}, p99 {p99:.3f} against the hop's "
              f"{pipe.hop / s.sample_rate * 1e3:.3f} ms of audio (push → "
              f"synchronize); launches {LAUNCHES[name]}{sums}", flush=True)


LIVE_LARGE_PUSH = 777
def live_large_phase(dev) -> dict:
    """Each setting of ``LIVE_LARGE`` (B2's ring form in windows or bands)
    as a graph-captured ``Stream`` on the card's defaults, driven once
    (counters) in 777-sample pushes, then flushed: one capture, no frame
    dropped, its columns bit-equal to ``Pipeline.process`` on the card
    (driven once too) in vis and rgba; B2's ring form once a hop, in its
    windows or bands form each time, no global sort and no atomic route
    live or in the batch; the batch against the port's CPU path (grid as
    the batch phases hold it, vis as they do once float64 plain settles
    the deposits placed apart: ``settled_vis``); p50/p99 host ms a hop
    (reported, not held: a hop of 16 is 0.333 ms of audio).  Then each
    setting's kernel row (``ring_large_row``) → {row: its JSON row}."""
    rows = {}
    for name, s, seconds in LIVE_LARGE:
        t0 = time.perf_counter()
        x = signal(seconds, seed=27, sr=s.sample_rate)
        pipe = Pipeline(s, dev)
        P, C, R = 2 * pipe.reach + 1, pipe.rows, pipe.reach
        st = Stream(s, dev)
        check(st.captures == 1, f"{name}: {st.captures} graph captures")
        check_native_ring(name, st)
        lat: list = []
        cols = drive(name, lambda: stream_run(st, x, LIVE_LARGE_PUSH, lat))
        check(st.captures == 1 and st.dropped_frames == 0,
              f"{name}: {st.captures} graph captures, {st.dropped_frames} "
              f"frames dropped")
        st.close()
        xg = pipe.to_device(x)
        vis_b, rgba_b, _ = drive(f"{name}_batch", lambda: pipe.process(xg))
        t_count = pipe.num_columns(x.shape[-1])
        check([c.index for c in cols] == list(range(t_count))
              and torch.equal(torch.stack([c.vis for c in cols]), vis_b)
              and torch.equal(torch.stack([c.rgba for c in cols]), rgba_b),
              f"{name}: the stream ≠ process on the card bit for bit "
              f"({len(cols)} columns, {t_count} in the batch)")
        hops = t_count + R                     # the flush steps R more
        live, batch = ROUTE_LAUNCHES[name], ROUTE_LAUNCHES[f"{name}_batch"]
        split = LAUNCHES[name][ring_row(name)]
        check(live[SORTED_RING] == split == hops and all(
            n == 0 for r, n in live.items() if r != SORTED_RING),
              f"{name}: the stream's B2 launches {live}, in windows or "
              f"bands {split}, want its ring form in windows or bands once "
              f"a hop ({hops} hops)")
        check(batch[SORTED] == batch["row"] == batch["global"] == 0,
              f"{name}: the batch's B2 launches {batch}")
        cpu = Pipeline(s, "cpu")
        vis_c, _, _ = cpu.process(x)
        g = compare_grids(
            cpu._enhanced_power(cpu.to_device(x), t_count, cpu.params()),
            pipe._enhanced_power(xg, t_count, pipe.params()).cpu())
        check(g.ok, f"{name}: GPU vs CPU grid {g}")
        _, vd_raw, vshare_raw = compare_vis(vis_c, vis_b.cpu())
        # a short hop samples Δt/hop's rounding boundaries finely, so the
        # two float32 paths place more deposits apart: float64 plain
        # settles them, and what it does not is held as compare_vis holds
        ik, ck = (a.cpu() for a in pipe._deposit_ids_rel(
            pipe._bank_inputs(xg, t_count), pipe.params()))
        vis_s, apart, explained, settled, loud, odd = settled_vis(
            cpu, x, t_count, ik, ck)
        del ik, ck
        check(loud <= UNEXPLAINED_BELOW, f"{name}: of {apart} deposits the "
              f"card and the CPU path place apart, float64 plain explains "
              f"{explained}, and one of the others is {loud:.2e} of the "
              f"loudest deposit; the first (frame, bin; id and contrib) "
              f"{odd}")
        vis_ok, vd, vshare = compare_vis(vis_s, vis_b.cpu())
        check(vis_ok, f"{name}: GPU vs CPU vis (settled by float64 plain) "
              f"max-filter diff {vd} (share over 2/255: {vshare}; "
              f"unsettled {vshare_raw})")
        check(bool(torch.isfinite(vis_b).all()), f"{name}: non-finite vis")
        ms = [v * 1e3 for v in lat]
        p50, p99 = _percentiles(ms)
        audio = pipe.hop / s.sample_rate * 1e3
        worst = p99 if len(ms) >= 100 else max(ms)    # p99 of few: the max
        plan = ring_plan_on(dev, pipe.n_max // 2 + 1, P, C)
        row = rows[ring_row(name)] = ring_large_row(dev, name, pipe, x)
        print(f"live_large {name} ({CARD[0]}): enhanced {pipe.n_max} at hop "
              f"{pipe.hop}, {s.sample_rate} Hz, {C} rows (ring {P} × {C}, "
              f"hop {pipe.n_max // 2 + 1} deposits: windows {plan['windows']}"
              f" × {plan['window']} chunks, bands {plan['bands']} × "
              f"{plan['band_slots']} slots, clusters of {plan['cluster']}), "
              f"{seconds} s in {LIVE_LARGE_PUSH}-sample pushes: "
              f"{len(cols)} columns, one capture, 0 dropped, ≡ process on "
              f"the card bit for bit in vis and rgba; the ring form "
              f"{split}× in windows or bands (one a hop); vs CPU path: "
              f"energy {g.energy_rel:.2e}, grid maxf {g.maxf_rel:.2e}, vis "
              f"maxf {vd_raw:.2e} (share over 2/255 {vshare_raw:.2e}); "
              f"deposits placed apart {apart} of "
              f"{t_count * (pipe.n_max // 2 + 1)}, float64 plain explains "
              f"{explained} (the card's {settled}; the loudest other "
              f"{loud:.1e} of the loudest deposit: {odd[:2]}); settled vis "
              f"maxf {vd:.2e} (share "
              f"{vshare:.2e}, allowed 1e-4); host ms a hop over "
              f"{len(ms)} pushes p50 {p50:.3f}, "
              f"{'p99' if len(ms) >= 100 else 'max (under 100 pushes)'} "
              f"{worst:.3f} against the hop's {audio:.3f} ms of audio "
              f"(push → synchronize; not held: "
              f"{'keeps up' if worst <= audio else 'falls behind'}); "
              f"the ring form alone {row['device_ms']:.4f} "
              f"device ms a hop (bound {row['bound_ms']:.5f} by "
              f"{row['bound_by']}, index_add_ {row['library_device_ms']:.4f}, "
              f"plain {row['plain_ms']:.4f} ms); {time.perf_counter() - t0:.1f}"
              f" s", flush=True)
        row.update(host_p50_ms=p50, host_p99_ms=p99, host_max_ms=max(ms),
                   host_pushes=len(ms), hop_audio_ms=audio,
                   columns=len(cols), launches_in_windows_or_bands=split,
                   deposits_apart=apart, apart_explained_by_float64=explained,
                   apart_unexplained_loudest=loud,
                   vis_share_unsettled=vshare_raw, vis_share_settled=vshare)
    return rows


def ring_large_row(dev, name: str, pipe: Pipeline, x: np.ndarray) -> dict:
    """B2's ring form at the hop of frame ``mid`` of ``x`` (B1's relative
    ids on the card, as the live step hands them) in windows or bands:
    bit-equal to ``histogram_ring_plain`` of ``ring_ids`` on the CPU into a
    ring of random values at t = 0, 1 and mid, with NaN/Inf behind dropped
    and out-of-range ids, finite; its time, the plain version's and
    ``index_add_``'s at the same ring offsets, and the byte bound (8 bytes
    a deposit, 8 a touched cell)."""
    ids_rel, contrib, _ = relative_ids(dev, pipe.settings, x)
    mid = ids_rel.shape[-2] // 2
    rel = ids_rel[..., mid, :].contiguous()
    vals = contrib[..., mid, :].contiguous()
    P, C, k = 2 * pipe.reach + 1, pipe.rows, rel.shape[-1]
    plan = ring_plan_on(dev, k, P, C)
    check(plan["fits"] and ring_form(plan) in ("windows", "bands"),
          f"{name}: the ring form's plan {plan}")
    pick = torch.from_numpy(np.random.default_rng(6).random(k) < 0.1).to(dev)
    bad_ids = torch.where(pick, torch.where(rel % 2 == 0, -1, P * C + 7),
                          rel).to(torch.int32)
    bad_vals = torch.where(pick, torch.where(
        rel % 3 == 0, float("inf"), float("nan")), vals)
    ring0 = torch.rand((P, C), device=dev)
    checked, form = 0, ring_form(plan)
    for t in (0, 1, mid):
        t_dev = torch.tensor(t, dtype=torch.int32, device=dev)
        for ids, v in ((rel, vals), (bad_ids, bad_vals)):
            want = histogram_ring_plain(ring_ids(ids.cpu(), t, P, C),
                                        v.cpu(), ring0.cpu().clone())
            before = histogram.ring_form_launches[form]
            got = histogram_ring(ids, v, ring0.clone(), t_dev).cpu()
            check(histogram.ring_form_launches[form] == before + 1,
                  f"{name}: no launch of the ring form in {form}")
            check(torch.equal(got, want) and bool(torch.isfinite(got).all()),
                  f"{name}: B2's ring form in windows or bands at t = {t} "
                  f"differs from its plain version, or a NaN/Inf behind a "
                  f"dropped id landed")
            checked += 1
    t_dev = torch.tensor(mid, dtype=torch.int32, device=dev)
    ring = ring0.clone()
    ids = ring_ids(rel, mid, P, C)
    flat = ring_offsets(ids, ring).reshape(-1)
    ok = flat >= 0
    safe = torch.where(ok, flat, ring.numel()).long()
    v0 = torch.where(ok, vals.reshape(-1), 0.0)
    spare = torch.zeros(ring.numel() + 1, device=dev)
    touched = int(torch.unique(flat[ok]).numel())
    return dict(
        at=f"{name}: relative ids {tuple(rel.shape)} → a ring ({P}, {C}), "
           f"windows {plan['windows']} × {plan['window']} chunks, bands "
           f"{plan['bands']} × {plan['band_slots']} slots, clusters of "
           f"{plan['cluster']}",
        max_abs_err=0.0,
        **times(lambda: histogram_ring(rel, vals, ring, t_dev),
                lambda: histogram_ring_plain(ids, vals, ring),
                lambda: spare.index_add_(0, safe, v0), iters=10),
        **bound(8.0 * rel.numel() + 8.0 * touched, float(touched)),
        touched_cells=touched, plan=plan, checked_launches=checked)


# past 2^31 deposits a lane (B2's batch form): name → (settings, minutes of
# 48 kHz audio); wide runs as a probe (``long_batch_phase(dev, "wide")``)
LONG_BATCH = {"north": (NORTH, 37.0), "wide": (WIDE, 11.8)}
LONG_BLOCK = 4096       # columns a block of the CPU plain sum
LONG_PUSH = SR          # samples a push of the long stream
FUZZ_SEEDS = range(28)  # the fuzz phase's draws (beside its fixed cases)


def long_batch_phase(dev, name: str = "north") -> dict:
    """``LONG_BATCH[name]`` on the card: more than 2^31 deposits a lane.
    ``Pipeline.process`` driven once (counters: B2's batch form once, no
    other B2 form or route) ≡ a graphed ``Stream`` of the same audio in
    ``LONG_PUSH``-sample pushes bit for bit in vis and rgba; B2's sum at
    the process's ids (``histogram`` with the pipeline's bound, the form
    ``sorted_form`` names) bit-equal to ``histogram_plain`` on the CPU in
    blocks of ``LONG_BLOCK`` columns (frames c0 − R … c1 + R for columns
    [c0, c1): every deposit that can land in them, in (frame, bin)
    order); its device ms, bound and the card's peak reserved memory →
    the row's dict."""
    settings, minutes = LONG_BATCH[name]
    t_start = time.perf_counter()
    x = signal(minutes * 60.0, seed=37)
    pipe = Pipeline(settings, dev)
    t, K, R, rows = (pipe.num_columns(x.size), pipe.n_max // 2 + 1,
                     pipe.reach, pipe.rows)
    check(t * K >= 2**31, f"long_{name}: {t} frames of {K} deposits are "
          f"below 2^31")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    xg = pipe.to_device(x)
    t0 = time.perf_counter()
    vis, rgba, _ = drive(f"long_{name}", lambda: pipe.process(xg))
    process_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved(dev)
    routes = ROUTE_LAUNCHES[f"long_{name}"]
    form = sorted_form(t, K, R, rows)
    check(form == "batch" and routes[SORTED_BATCH] == 1 and all(
        n == 0 for r, n in routes.items() if r != SORTED_BATCH),
          f"long_{name}: B2 launched {routes}, want its batch form once "
          f"(sorted_form: {form})")
    check(bool(torch.isfinite(vis).all()) and float(vis.max()) > 0,
          f"long_{name}: vis not finite or all zero")
    st = Stream(settings, dev)
    t0 = time.perf_counter()
    cols = stream_run(st, x, LONG_PUSH)
    stream_s = time.perf_counter() - t0
    check(st.captures == 1 and st.dropped_frames == 0,
          f"long_{name}: {st.captures} captures, {st.dropped_frames} "
          f"dropped")
    st.close()
    check([c.index for c in cols] == list(range(t))
          and torch.equal(torch.stack([c.vis for c in cols]), vis)
          and torch.equal(torch.stack([c.rgba for c in cols]), rgba),
          f"long_{name}: the graphed Stream ≠ process bit for bit "
          f"({len(cols)} columns, {t} in the batch)")
    del cols, vis, rgba
    torch.cuda.empty_cache()
    p = pipe.params()
    ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_inputs(xg, t), p)
    ids = pipe._absolute_ids(ids_rel, t, R).reshape(-1)
    del ids_rel
    vals = contrib.reshape(-1)
    kw = dict(route=SORTED, reach=R, frame_len=K, column_len=rows)
    before = histogram.route_launches[SORTED_BATCH]
    got = histogram(ids, vals, t * rows, **kw)
    check(histogram.route_launches[SORTED_BATCH] == before + 1,
          f"long_{name}: the sum did not launch B2's batch form")
    ms = device_ms(lambda: histogram(ids, vals, t * rows, **kw), calls=3)
    deposits = ids.numel()
    ids_h, vals_h, got_h = ids.cpu(), vals.cpu(), got.cpu()
    del got
    # the library call: index_add_ of the same deposits into the grid and
    # one cell more that takes the dropped ids (its own order each run)
    cells = t * rows
    ids.masked_fill_((ids < 0) | (ids >= cells), cells)
    grid = torch.zeros(cells + 1, device=dev)
    try:
        library_ms, library_error = device_ms(
            lambda: grid.index_add_(0, ids, vals), calls=3), None
    except RuntimeError as e:
        library_ms, library_error = None, str(e)[:300]
    del ids, vals, contrib, grid
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for c0 in range(0, t, LONG_BLOCK):
        c1 = min(t, c0 + LONG_BLOCK)
        s0, s1 = max(c0 - R, 0), min(c1 + R, t)
        want = histogram_plain(ids_h[s0 * K:s1 * K] - c0 * rows,
                               vals_h[s0 * K:s1 * K], (c1 - c0) * rows)
        check(torch.equal(want, got_h[c0 * rows:c1 * rows]),
              f"long_{name}: B2's sum ≠ the CPU plain sum in columns "
              f"[{c0}, {c1})")
    plain_s = time.perf_counter() - t0
    row = dict(
        at=f"{name}: {settings.fft_size} at hop {pipe.hop}, {minutes} min "
           f"of {SR} Hz audio: {t} frames × {K} deposits = {deposits} "
           f"(2^31 = {2**31}) → {t} × {rows} cells, R = {R}",
        form=form, plan=batch_plan(t, K, R, rows), device_ms=ms,
        library_device_ms=library_ms, library_error=library_error,
        **bound(8.0 * deposits + 4.0 * t * rows, float(deposits)),
        peak_reserved_gb=peak / 2**30, process_s=process_s,
        stream_s=stream_s, plain_blocks_s=plain_s)
    print(f"long_batch {name} ({CARD[0]}): {row['at']}; process ≡ a graphed "
          f"Stream ({LONG_PUSH}-sample pushes, one capture, 0 dropped) bit "
          f"for bit in vis and rgba; B2's {form} form (one launch) "
          f"bit-equal to the CPU plain sum in {-(-t // LONG_BLOCK)} blocks "
          f"of {LONG_BLOCK} columns; the sum alone {ms:.3f} device ms (bound "
          f"{row['bound_ms']:.3f} by {row['bound_by']}; index_add_ at the "
          f"same ids {library_ms} device ms"
          f"{'' if library_error is None else ': ' + library_error}"
          f"); peak reserved "
          f"{row['peak_reserved_gb']:.2f} GiB; process {process_s:.1f} s, "
          f"stream {stream_s:.1f} s, plain sums {plain_s:.1f} s, phase "
          f"{time.perf_counter() - t_start:.1f} s; launches "
          f"{LAUNCHES[f'long_{name}']}", flush=True)
    return row


def fuzz_phase(dev) -> dict:
    """``settings_fuzz.sweep`` of its fixed cases and ``FUZZ_SEEDS``,
    driven once (counters): every case must pass its checks, and every
    form of ``settings_fuzz.REQUIRED`` (each B1 route and form and B2 form
    the defaults launch) must be reached → the sweep's summary."""
    lines: list = []
    res = drive("fuzz", lambda: settings_fuzz.sweep(FUZZ_SEEDS, dev,
                                                    log=lines.append))
    check(not res["failed"], f"fuzz: {len(res['failed'])} cases failed: "
          f"{res['failed'][:3]}")
    missing = [f for f in settings_fuzz.REQUIRED if res["coverage"][f] == 0]
    check(not missing, f"fuzz: no case reached {missing}")
    slowest = max((json.loads(line) for line in lines),
                  key=lambda r: r["seconds"])
    print(f"fuzz ({CARD[0]}): {res['ran']} cases ({len(settings_fuzz.FIXED)} "
          f"fixed, the draws of seeds {FUZZ_SEEDS.start}–"
          f"{FUZZ_SEEDS.stop - 1}), {res['skipped']} draws skipped over the "
          f"budget (ring {settings_fuzz.RING_BUDGET >> 20} MiB, batch "
          f"{settings_fuzz.BATCH_BUDGET >> 20} MiB): {res['skipped_seeds']}; "
          f"every case passed (process and a graphed Stream ≡ each other "
          f"bit for bit in every case; vis within compare_vis of the CPU "
          f"path, finite in [0, 1]); coverage (cases a form): "
          + ", ".join(
              f"{k} {v}" for k, v in res["coverage"].items())
          + f"; slowest case {slowest['case']} {slowest['seconds']} s; "
          f"{res['seconds']} s; launches {LAUNCHES['fuzz']}", flush=True)
    return res


def trace_phase(dev, x: np.ndarray) -> None:
    """``utils.tracing.trace`` around one batch call of the batch phase's
    settings: the trace it writes must name B1's, B2's and the post
    chain's kernels (``post_head``, the scans' speculate and repair
    passes); then a census of the kernels that one post chain call
    launches, read from the trace (the launches inside its annotation),
    and of one live hop of the live phase's settings (the eager step,
    ``_stream_step_rolling``) on the default, in launch order: B1, then
    B2's ring form at once (its ring cells computed in the kernel: no
    launch between them), then the post chain — beside the atomic hop's
    (``exact_sums=False``)."""
    from emspec_torch.utils.tracing import annotation, trace

    pipe = Pipeline(SETTINGS, dev)
    p, xg = pipe.params(), pipe.to_device(x)
    pipe.process(xg, p)
    t = pipe.num_columns(x.shape[-1])
    cols = pipe._enhanced_power(xg, t, p).movedim(-2, 0).contiguous()
    st = PostState.init(cols.shape[1:], dev)
    postprocess_batch(cols, st, p.post)
    hop = pipe.hop
    carries = {exact: pipe.init_roll_carry() for exact in (True, False)}
    block = xg[pipe.n_max - pipe.roll:pipe.n_max].contiguous()
    for exact, carry in carries.items():         # past the first R hops
        for _ in range(pipe.reach + 2):
            carries[exact], _ = pipe._stream_step_rolling(
                carry, block, p, exact_sums=exact)
            carry = carries[exact]
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            with annotation("emspec_batch"):
                pipe.process(xg, p)
            torch.cuda.synchronize()
            with annotation("emspec_post"):
                postprocess_batch(cols, st, p.post)
            torch.cuda.synchronize()
            for exact in (True, False):
                with annotation(f"emspec_hop_{exact}"):
                    pipe._stream_step_rolling(carries[exact], block, p,
                                              exact_sums=exact)
                torch.cuda.synchronize()
        files = list(Path(tmp).glob("trace_*.json"))
        check(len(files) == 1, f"trace: {len(files)} files written")
        events = json.loads(files[0].read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    found = {k: sorted(n for n in kernels if any(w in n for w in want))
             for k, want in TRACE_NAMES.items()}
    missing = [k for k, v in found.items() if not v]
    check(not missing and any(e.get("name") == "emspec_batch"
                              for e in events),
          f"trace: no {missing} among the kernels {sorted(kernels)}")
    launched = sorted(n[:40] for n in launched_in(events, "emspec_post"))
    hops = {exact: launched_in(events, f"emspec_hop_{exact}")
            for exact in (True, False)}
    order = [("B1" if "block_kernel" in n else "ring" if "ring_kernel" in n
              else "other") for n in hops[True]]
    check("B1" in order and "ring" in order
          and order.index("ring") == len(order) - 1 - order[::-1].index(
              "B1") + 1 and order.count("ring") == 1,
          f"trace: the default live hop's kernels in launch order are not "
          f"B1 then B2's ring form at once: {hops[True]}")
    HOP_CENSUS.update({("default" if exact else "atomic"): [n[:60] for n in v]
                       for exact, v in hops.items()})
    print(f"trace: {len(events)} events, {len(kernels)} kernel names; "
          + "; ".join(f"{k}: {v[0][:60]}" for k, v in found.items())
          + f"; one post chain call at {tuple(cols.shape)} launched "
          f"{len(launched)} kernels: {launched}; one live hop ({hop} "
          f"samples, 8192) launched {len(hops[True])} kernels on the "
          f"default (B1, the ring form at once, the post chain: "
          f"{[n[:30] for n in hops[True]]}) and {len(hops[False])} on the "
          f"atomic route ({[n[:30] for n in hops[False]]})", flush=True)
    print("trace: " + no_cufft(dev), flush=True)


def no_cufft(dev) -> str:
    """One ``process`` call and one eager hop of each ``DEFAULT_ENGINE``
    cell under torch.profiler: fail if a kernel whose name holds "fft"
    (cuFFT's; no kernel of the port is named so) launched, or one of B4's
    or the three-launch route's pack and unpack (at 65536 the real FFT is
    one launch of its cluster kernel), or if the real FFT kernel's
    (``real_dft_*``) are not in the trace → the line's part."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    seen = {}
    for name, s, _, sr in DEFAULT_ENGINE:
        pipe = Pipeline(s, dev)
        x = pipe.to_device(signal((pipe.n_max + 20 * pipe.hop) / sr,
                                  seed=43, sr=sr))
        p, carry = pipe.params(), pipe.init_roll_carry()
        block = x[pipe.n_max - pipe.roll:pipe.n_max].contiguous()
        pipe.process(x, p)
        carry, _ = pipe._stream_step_rolling(carry, block, p)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            pipe.process(x, p)
            pipe._stream_step_rolling(carry, block, p)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type == cuda}
        fft = sorted(n for n in names if "fft" in n.lower())
        own = sorted(n for n in names if "real_dft_" in n)
        check(own and not fft, f"trace {name}: a default call and hop "
              f"launched cuFFT {fft} (the real FFT kernel's: {own})")
        # B4 and the three-launch route's pack and unpack: on no default
        # path since the cluster route
        b4 = sorted(n for n in names if re.search(
            r"\b(small|cols|rows)_kernel\b|real_dft_(pack|unpack)", n))
        check(not b4, f"trace {name}: a default call and hop launched "
              f"B4 or the three-launch route {b4}")
        seen[name] = len(own)
    return ("no cuFFT kernel in a default call and hop of " + ", ".join(
        f"{k} (real FFT kernels {v})" for k, v in seen.items()))


def launched_in(events: list, span_name: str) -> list:
    """The kernels launched inside the annotation ``span_name`` of a
    trace's events, in launch order."""
    span = [e for e in events if e.get("name") == span_name
            and e.get("cat") == "user_annotation"]
    if not span:
        return []
    lo, hi = span[0]["ts"], span[0]["ts"] + span[0].get("dur", 0)
    launch = {e.get("args", {}).get("correlation"): e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "Launch" in e.get("name", "") and lo <= e["ts"] <= hi}
    kern = [e for e in events if e.get("cat") == "kernel"
            and e.get("args", {}).get("correlation") in launch]
    return [e["name"] for e in sorted(
        kern, key=lambda e: launch[e["args"]["correlation"]])]


BENCH_KEEPUP = 0.95       # ``emspec/bench/harness.py:503-505``'s band
BENCH_DEVICE_TOL = 0.10


def bench_phase(dev, x: np.ndarray) -> None:
    """``python -m emspec_torch bench`` in subprocesses on the card (see
    the module docstring, phase 26); the soak runs beside the two runs
    that time no device work, the timed runs alone."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [q for q in [os.environ.get("PYTHONPATH")] if q]))
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        procs = []

        def start(args):
            p = subprocess.Popen(
                [sys.executable, "-m", "emspec_torch", "bench", *args],
                cwd=d, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            procs.append(p)
            return p

        def finish(label, p):
            t0 = time.perf_counter()
            try:
                out, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                fail(f"bench {label}: no exit within 300 s: {err[-2000:]}")
            check(p.returncode == 0,
                  f"bench {label}: exit {p.returncode}: {err[-2000:]}")
            try:
                rep = json.loads(out)
            except json.JSONDecodeError:
                fail(f"bench {label}: no JSON report: {out[-2000:]}")
            print(f"bench {label} (waited {time.perf_counter() - t0:.1f} "
                  f"s): {json.dumps(rep)}", flush=True)
            return rep

        try:
            soak = start(["--soak", "--duration", "30", "--quick"])
            sustained = finish("--sustained --duration 3", start(
                ["--sustained", "--duration", "3"]))
            traced = finish("--trace", start(["--trace", str(d / "trace")]))
            soaked = finish("--soak --duration 30 --quick", soak)
            quick = finish("--quick", start(["--quick"]))
            stages = finish("--stages", start(["--stages"]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        files = list((d / "trace").glob("trace_*.json"))
        check(len(files) == 1 and traced["profiler_trace"] == str(
            d / "trace"), f"bench --trace: {len(files)} trace files")
        events = json.loads(files[0].read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    check(bool(kernels), "bench --trace: the trace holds no CUDA kernel")

    configs = quick["configs"]
    for name, rep in configs.items():
        if "columns_per_sec" in rep:
            shares = [rep["roofline"][k] for k in ("pct_h100_f32_peak",
                                                   "pct_h100_hbm_peak")]
            check(rep["columns_per_sec"] > 0 and rep["device_ms_per_call"] > 0
                  and all(s is not None and 0 < s <= 105 for s in shares),
                  f"bench --quick {name}: columns/s "
                  f"{rep['columns_per_sec']}, device ms a call "
                  f"{rep['device_ms_per_call']}, roofline shares {shares}")
        else:
            check(rep["p50_ms"] > 0 and rep["device_scan_ms_per_hop"] > 0,
                  f"bench --quick {name}: {rep}")
    primary = quick["primary"]
    pipe = Pipeline(SETTINGS, dev)
    p, xg = pipe.params(), pipe.to_device(x)
    t = pipe.num_columns(x.shape[-1])
    state = [PostState.init((pipe.rows,), dev)]

    def chained():
        state[0] = pipe._batch_vis(xg, p, state[0], t)[2]
    own = t / (device_ms(chained, calls=10) / 1e3)
    rel = abs(primary["device_frames_per_sec"] - own) / own
    check(primary["t_count"] == t and rel <= BENCH_DEVICE_TOL,
          f"bench: primary device frames/s {primary['device_frames_per_sec']}"
          f" at t = {primary['t_count']} vs {own:.1f} at t = {t} here "
          f"({rel:.3f} apart)")
    for name, rep in sustained.items():
        check(rep["keepup_ratio"] >= BENCH_KEEPUP,
              f"bench --sustained {name}: keep-up {rep['keepup_ratio']}")
    check(soaked["churn"]["errors"] == 0 and soaked["final_frame_nonblack"],
          f"bench --soak: churn {soaked['churn']}, final frame non-black "
          f"{soaked['final_frame_nonblack']}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"bench primary ({smi}): {primary['metric']} {primary['value']} "
          f"{primary['unit']}, device {primary['device_frames_per_sec']} "
          f"(this script's batch cell by device_ms: {own:.1f}, "
          f"{rel:.3f} apart)", flush=True)
    print(f"bench: {len(configs)} configurations, stages "
          f"{ {k: v['stage_us'] for k, v in stages.items()} }, keep-up "
          f"{ {k: v['keepup_ratio'] for k, v in sustained.items()} }, soak "
          f"churn {soaked['churn']}, trace {len(kernels)} kernel names; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def device_busy(fn, reps: int):
    """Device busy time per call of ``fn`` (ms) and its split by kernel:
    the sums of kernel and copy times in torch.profiler (one stream, so
    none overlap).  A first, discarded profile absorbs start-up."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # acc_events: torch 2.11 warns on every profile without it
    with profile(activities=acts, acc_events=True):
        fn()
        torch.cuda.synchronize()
    with profile(activities=acts, acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {e.key: e.self_device_time_total / 1e3 / reps
               for e in prof.key_averages() if e.device_type == cuda}
    return sum(by_name.values()), by_name


def _top(by_name: dict, k: int = 4) -> str:
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
    return ", ".join(f"{name[:40]} {ms:.4f}" for name, ms in top)


def phase_breakdown(dev, batches: dict, lives: dict, calls: dict) -> None:
    """Where the time goes: per-stage device times (CUDA events) of the
    enhanced stencil batch paths; for every batch cell and a live hop of
    every path, the device busy time, its largest kernels and the idle
    share (1 − profiled busy time over the unprofiled wall time)."""
    for name, (settings, x, wall_ms) in batches.items():
        s = settings.replace(channels=1 if x.ndim == 1 else x.shape[0])
        pipe = Pipeline(s, dev)
        p, xg = pipe.params(), pipe.to_device(x)
        stages = ""
        if s.mode == "enhanced" and s.fft_method == "stencil":
            t = pipe.num_columns(x.shape[-1])
            inputs = pipe._bank_inputs(xg, t)
            ids, c = pipe._deposit_ids_rel(inputs, p)
            def scatter():          # the default: B2's sorted route
                return pipe._scatter_absolute(
                    pipe._absolute_ids(ids, t, pipe.reach), c, t,
                    exact=True)
            cols = scatter().movedim(-2, 0).contiguous()
            st = PostState.init(xg.shape[:-1] + (pipe.rows,), dev)

            def post():
                return postprocess_batch(cols, st, p.post, s.agc_global)
            vis, _ = post()
            stages = "stages (CUDA events) " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in {
                    "B1": cuda_ms(lambda: pipe._deposit_ids_rel(inputs, p),
                                  5, 2),
                    "B2 sorted route (absolute grid)": cuda_ms(scatter, 5,
                                                               2),
                    "post chain": cuda_ms(post, 5, 2),
                    "colormap": cuda_ms(lambda: apply_lut(vis, p.lut), 5, 2),
                }.items()) + "; "
        busy, by_name = device_busy(lambda: pipe.process(xg, p), 3)
        print(f"breakdown {name}: {stages}device busy {busy:.4f} of "
              f"{wall_ms:.4f} ms/call, idle share {1 - busy / wall_ms:.4f}; "
              f"largest (ms/call): {_top(by_name)}", flush=True)

    for name, (fn, wall_ms) in calls.items():
        busy, by_name = device_busy(fn, 3)
        print(f"breakdown {name}: device busy {busy:.4f} of {wall_ms:.4f} "
              f"ms/call, idle share {1 - busy / wall_ms:.4f}; largest "
              f"(ms/call): {_top(by_name)}", flush=True)

    # live: 20 hops to settle, then up to 100 profiled and as many on the
    # host clock alone (fewer where the signal is shorter)
    for name, (settings, x) in lives.items():
        st = Stream(settings.replace(
            channels=1 if x.ndim == 1 else x.shape[0]), dev)
        hop, pos = st.pipe.hop, st.pipe.n_max + 20 * st.pipe.hop
        reps = min(100, (x.shape[-1] - pos) // (2 * hop))
        st.push(x[..., :pos])

        def one_hop():
            nonlocal pos
            st.push(x[..., pos:pos + hop])
            pos += hop
        busy, by_name = device_busy(one_hop, reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            one_hop()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        print(f"breakdown {name}: device busy {busy:.4f} of {wall_ms:.4f} "
              f"ms/hop (host clock, {hop}-sample pushes, {reps} hops), idle "
              f"share {1 - busy / wall_ms:.4f}; largest (ms/hop): "
              f"{_top(by_name)}", flush=True)


def main() -> None:
    t_start = time.perf_counter()
    walls, last = {}, [t_start]

    def mark(name: str) -> None:        # the host wall since the last mark
        now = time.perf_counter()
        walls[name], last[0] = now - last[0], now
    dev = phase_device()
    native_phase()
    mark("device, native")
    pipe = Pipeline(SETTINGS, dev)
    res = phase_kernels(dev, pipe, pipe.params())
    mark("kernels")

    x = signal(SECONDS)
    vis, ms = batch_phase("batch", dev, SETTINGS, x, iters=10)
    x16 = signal(SECONDS, CHANNELS, seed=3)
    _, ms16 = batch_phase("batch16", dev, SETTINGS, x16, iters=5)
    live_phase("live", dev, SETTINGS, x, vis)
    vis_n, ms_n = batch_phase("natural", dev, NATURAL, x, iters=3)
    live_phase("natural_live", dev, NATURAL, x, vis_n, keep_up=True)
    vis_d, ms_d = batch_phase("direct", dev, DIRECT, x, iters=10)
    live_phase("direct_live", dev, DIRECT, x, vis_d)
    mark("batch, batch16, live, natural, direct")

    xs = signal(4.0, CHANNELS, seed=13, sr=96000)              # harness.py:435
    _, ms_s = batch_phase("stress", dev, STRESS, xs, iters=5)
    xs_live = signal(SECONDS, CHANNELS, seed=14, sr=96000)
    vis_sl, _ = batch_phase("stress_live_batch", dev, STRESS, xs_live,
                            iters=1)
    live_phase("stress_live", dev, STRESS, xs_live, vis_sl, min_hops=180)
    vis_no, ms_no = batch_phase("north", dev, NORTH, x, iters=3)
    live_phase("north_live", dev, NORTH, x, vis_no, min_hops=900, chunk=800,
               budget_ms=10.0)
    xe = signal(8.0, seed=15, sr=96000)                        # harness.py:479
    _, ms_e = batch_phase("ext262144", dev, EXT, xe, iters=3)
    xw = signal(2.0, seed=16)
    vis_w, ms_w = batch_phase("wide", dev, WIDE, xw, iters=3)
    live_phase("wide_live", dev, WIDE, xw, vis_w, min_hops=1400, keep_up=True)
    check(BATCH_AB["wide"]["atomic_routes"] == ["global"]
          and LIVE_AB["wide_live"]["atomic_routes"] == ["global"],
          f"wide: B2's atomic route is not the one above shared memory "
          f"({BATCH_AB['wide']['atomic_routes']}, "
          f"{LIVE_AB['wide_live']['atomic_routes']})")
    vis_m, ms_m = batch_phase("multires", dev, MULTIRES, x, iters=3)
    live_phase("multires_live", dev, MULTIRES, x, vis_m, keep_up=True)
    mark("stress, north, ext262144, wide, multires")
    res["rfft"]["default_engine"] = default_engine_phase(dev)
    mark("default_engine")
    rasters = {name: raster_phase(name, dev, s, x)
               for name, s in (("raster", RASTER),
                               ("raster_natural", RASTER_NATURAL))}
    mark("raster")
    cli_phase(dev, x)
    mark("cli")
    app_phase(dev, x)
    mark("app")
    swap_phase(dev, x)
    mark("swap")
    live_cli_phase(x)
    validate_bites(dev)
    mark("live_cli, validate")
    ring_ab_phase(dev, x)
    examples_phase()
    mark("ring_ab, examples")
    parallel_phase(dev, xs, xs_live, vis_sl, x, vis_m)
    mark("parallel")
    checkpoint_phase(dev, x)
    checkpoint_live(dev, x)
    mark("checkpoint")
    sparse_hop_phase(dev)
    mark("sparse_hop")
    res.update(live_large_phase(dev))
    mark("live_large")
    res["histogram_sorted_batch"]["long_batch"] = long_batch_phase(dev)
    mark("long_batch")
    res["histogram_sorted_batch"]["fuzz"] = fuzz_phase(dev)
    mark("fuzz")
    trace_phase(dev, x)
    bench_phase(dev, x)
    mark("trace, bench")
    phase_breakdown(
        dev, {"batch": (SETTINGS, x, ms), "batch16": (SETTINGS, x16, ms16),
              "natural": (NATURAL, x, ms_n), "direct": (DIRECT, x, ms_d),
              "stress": (STRESS, xs, ms_s), "north": (NORTH, x, ms_no),
              "ext262144": (EXT, xe, ms_e), "wide": (WIDE, xw, ms_w),
              "multires": (MULTIRES, x, ms_m)},
        {"live": (SETTINGS, x), "natural_live": (NATURAL, x),
         "direct_live": (DIRECT, x), "stress_live": (STRESS, xs_live),
         "north_live": (NORTH, x), "wide_live": (WIDE, xw),
         "multires_live": (MULTIRES, x)}, rasters)

    for path, routes in ROUTE_LAUNCHES.items():
        check(routes["row"] == routes["global"] == routes[SORTED] == 0,
              f"{path}: B2's atomic routes or its global sort launched on "
              f"a default path ({routes})")
    res["histogram_sorted_tiles"]["multires_file_render"] = EXACT
    res["histogram_sorted_tiles"]["time_parallel_render"] = EXACT_TP
    res["histogram_sorted_batch"]["batch_cells"] = BATCH_AB
    res["histogram_sorted_ring"]["live_hops"] = LIVE_AB
    res["histogram_sorted_ring"]["hop_census"] = HOP_CENSUS
    mark("breakdown")
    print("chip_smoke: phase walls, s (host clock): " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items()), flush=True)
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=(LAUNCHES[ROW_PATH[name]][name] if name in ROW_PATH
                       else sum(run[name] for run in LAUNCHES.values())),
             launches_by_path=({ROW_PATH[name]: LAUNCHES[ROW_PATH[name]][name]}
                               if name in ROW_PATH else
                               {path: run[name]
                                for path, run in LAUNCHES.items()}),
             **({"launches_by_route_and_path": ROUTE_LAUNCHES}
                if name == "histogram" else {}),
             **res[name])
        for name, _, src, rep in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["swap-stalls"]:       # the swap phase's helper
        print(json.dumps(swap_stalls(sys.argv[2])), flush=True)
        sys.exit(0)
    sys.exit(main())
