#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hpnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout.  It drives the port's main path on the
card at full width and fails (non-zero exit, no result line) on any
fault; no phase catches its own failure.  On a host of several cards
phases 1-28 hold the one-card routes on the first card: the process's
training decisions are pinned there (``api.device_slice``) and the child
processes of phases 1-27 see that card alone; phase 28's mesh,
phase 29's grid and phase 30's ranks span the cards.

1. Device: the ``nvidia-smi`` name and power limit, torch's CUDA version.
2. Build: every hand-written kernel from ``hpnn_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), with the build time and the
   compiler's register/spill report; fails when any entry of the tile
   kernel has a stack frame or spills (its design keeps nothing in local
   memory: a spill read after a grid barrier is an L2 round trip).
3. Each kernel against its plain torch version on the card, at the
   slice's shapes (784->300 with the activation, 300->10 without, 851->230
   and 230->230 with; B in {1, 3, 64, 512, 4096}; a ragged 13x37 at B=5)
   in float32, bfloat16 and float64, inputs from a seeded numpy generator
   in [-1, 1] and, for the MNIST input layer, at pixel scale [0, 255].
   Limits: float32 1e-5 ([-1, 1]) and 1e-4 (pixel scale), bfloat16 2e-2,
   float64 1e-12.
4. ``run_nn`` through the port's CLI on a seeded synthetic test dir in the
   reference's sample format: MNIST 784-300-10 ANN and SNN at float64,
   float32 and bfloat16, and XRD 851-230-230 ANN at float32, each with a
   kernel from ``generate_kernel(seed)`` dumped to a kernel file.  Each
   run must launch the kernel and match the plain path on the card within
   the limits of phase 3.
5. ``serve_nn`` on 127.0.0.1 (port 0, strict tier) with the MNIST ANN and
   SNN kernels at float32 and float64: requests of 1, 3 and 64 rows, then
   8 concurrent ones; every answer 200 and bit-identical to the rows run_nn
   computed (for SNN that covers the softmax after the kernel too).
6. Device times with CUDA events (median of 20 back-to-back runs of 10
   calls, host dispatch hidden behind a GPU spin) of the kernel, its plain
   version and ``torch.matmul`` + activation (the library yardstick the
   port never calls), beside the bound: the larger of the operations over
   the card's peak for the type and the bytes over 3.35 TB/s.
7. The training epoch kernel (``train_epoch``) against its plain torch
   version on the card at full width, on a seeded separable corpus (one
   bar per class): MNIST 784-300-10 ANN and SNN x BP and BPM x f64, f32 and
   bf16, XRD 851-230-230 ANN BPM at f64 and f32, native LNN 784-300-10 at
   f64, MNIST ANN BP f64 whose last output's target is 2^-30 below 1
   (in double not the target class; the exact 1 of class 0 or 1 is), and
   784-2304-10 ANN BP f64, more rows than the card holds warps at once (a
   plan must take several rows a warp); 2-8 samples a run (ANN and LNN samples from two classes: the first
   sample of each class is the one that takes thousands of iterations;
   XRD's two from one class, as its first takes tens of thousands,
   and the plain loop pays a host round trip per iteration; SNN from four:
   past about five classes at pixel scale, float32's exp range runs out in
   the softmax without max-subtraction and a sample runs to MAX_ITER with
   NaN weights, in the plain loop as in the kernel).  Limits: f64
   identical n_iter/first_ok/success, init_err and final dEp within 1e-12,
   weights within 1e-10; f32 identical first_ok/success, |dn_iter| <=
   max(4, 2%), weights within 5e-3; bf16 the f32 limits (both versions
   round every operation to bf16; only the order of the float32 sums
   differs).  Each run also goes through the kernel's other launch plan
   (W_0's rows resident in shared memory, or in device memory), which must
   give the same bits, and its grid barriers, as the kernel counts them,
   must be 2L - 2 an iteration.  Before the runs, the first launch of each
   dtype and plan is timed against a second (the one-off cost of loading
   the kernels); after them, a 30000-10-10 f64 net, whose staged vectors
   do not fit in a block's shared memory, must be refused with ValueError.
8. The resume contract: the f64 MNIST ANN BP epoch as launches under an
   iteration budget of 100 equals one launch bit for bit, in more than one
   launch.
9. ``train_nn`` end to end (``cli.train_nn_main``, the MNIST tutorial conf
   at the default f64, 512 training files), then ``run_nn`` of the trained
   ``kernel.opt`` on 512 test files: at least 80% PASS.  The epoch is then
   run again through the kernel alone for its device time, and through
   ``train_tile`` at tile 1, whose weights and stats must be bit-identical
   to ``train_epoch``'s.
10. The batched-tile epoch kernel (``train_tile``) against its plain torch
   version on the card: MNIST 784-300-10 ANN (two classes) and SNN (four)
   x BP and BPM x f64, f32 and bf16 at tile 8 over two groups and a ragged
   tail (19 samples), XRD 851-230-230 ANN BPM at f64 and f32 at tile 4,
   native LNN at f64, the weight storage modes "bf16" and "f32" under
   f32, and 784-2304-10 ANN BP f64 at tile 8 (more rows than the card
   holds warps: a block owns 18 rows of W_0), with phase 7's limits
   (f32/bf16 weights relative to the largest weight, ``TRAIN_LIMIT``'s
   note).  Each run's grid barriers, as the kernel counts them, must be
   2L - 2 a lockstep iteration; the 784-2304-10 run also goes through three
   other launch plans (W_0's rows in place; the inputs in lane chunks
   with the head's vectors off chip; the block's scratch in its workspace
   slice), which must give the same bits.  Then 784-4096-10 ANN BP f64 at
   tile 512 (512 samples, 3 iterations at most), where the plan itself
   puts the block's scratch in the workspace, held to the plain version.
   Last, a 30000-10-10 f64 net, whose one lane's input does not fit in a
   block's shared memory, must be refused with ValueError.
11. Its three bitwise contracts: tile=1 equals the ``train_epoch`` kernel
   (weights and stats) for ANN and LNN at f64, f32 and bf16 and SNN at f32
   and bf16, BP and BPM; a ragged tail's masked lanes are inert (tile 4
   over 6 samples equals the first group, then the two tail rows alone at
   tile 2); launches of one group equal one launch.
12. ``train_nn --tile 32`` end to end on phase 9's files and conf, then
   ``run_nn`` of its ``kernel.opt``: at least 80% PASS, ``train_tile``
   launched and ``train_epoch`` not.  The epoch is then run again through
   the kernel alone, twice, for its device time (the first and the second
   launch): lockstep iterations (a group runs as long as its slowest
   lane), lane-iterations (the sum of n_iter), grid barriers a lockstep
   iteration as the kernel counts them (2L - 2), and the rate beside
   phase 9's per-sample kernel on the same files.  Last, ``--tile auto``'s
   autotuner at that width measures its candidates once, a second call is
   a cache hit, and the epoch on the same files at each of its candidate
   tiles (one launch each) shows whether its choice is the fastest epoch.
13. ``fused_bpm_update`` against its plain version, bit for bit, at the
   MNIST and XRD layers (300x784, 10x300, 230x851, 230x230) and at
   4096x4096 (past the 50 MB L2), f64 and f32: its warm time (back-to-back
   calls on the same buffers), its cold time (calls rotating over copies
   of the inputs that together span twice the L2), an empty kernel's
   launch-to-launch time in the same loop (the floor) and the byte bound.
14. Batch invariance of ``fused_linear_act`` (run right after phase 3):
   at each of phase 3's four layers and each dtype, one seeded B=4096
   call, and the same rows in calls of B = 1, 3, 64 and 512, from row 0
   and from an odd row, bit for bit.  Those calls cross every launch plan
   the wrapper picks (tile shapes, stages split or not), so they hold the
   fixed summation order the strict serving tier rests on.
16. ``train_nn --epochs 3`` (run right after phase 12) on phase 9's files
   and conf, per sample and at ``--tile 32``, through the device-resident
   epoch pipeline: ``train_epoch`` (or ``train_tile``) launched exactly 3
   times, ``EPOCH_METRICS.h2d_bytes`` 3 * 512 * 4 (one int32 permutation an
   epoch), the stream and kernel.opt byte-identical to the
   ``HPNN_NO_EPOCH_PIPELINE=1`` route on the card, each epoch's device time
   and the run's wall time, and ``run_nn`` of kernel.opt at 80% PASS or
   more.
17. ``train_nn --resume`` (run right after phase 16) on phase 9's files
   and conf, per sample and at ``--tile 32``: ``--epochs 3 --ckpt-every 1
   --ckpt-dir ck --replicate-to rep``; the same killed at epoch 1
   (``HPNN_CKPT_KILL_AT_EPOCH=1``) and resumed with ``--resume``; that
   ``ck`` deleted and resumed again with ``--replicate-to rep`` (epoch 1
   restored from the replica).  kernel.opt of every run byte-identical to
   phase 16's checkpointing-off run; each resumed stream from EPOCH 2 on
   byte-identical to the first run's, the killed stream its prefix; the
   epoch kernel launched 3 times in the first run and 1 + 2 across the
   kill and the resume (2 in the replica resume), the resident route in
   every run; every bundle passes ``verify_bundle``, the manifests'
   generations and the replica blobs counted; ``run_nn --ckpt-dir ck`` of
   the resumed kernel.opt (>= 80% PASS) warns of no fingerprint mismatch,
   and of one after a digit of kernel.opt is changed, naming both paths.
   The runs' wall times beside phase 16's and the bundles' bytes.
18. The corpus pipeline (run right after phase 17): the native sample
   loader must be on.  ``run_nn`` of a generated MNIST 784-300-10 ANN f64
   and XRD 851-230-230 ANN f32 kernel on a fresh 4096-file dir each, in
   three load modes: cache off, serial, Python parser
   (``HPNN_NO_CORPUS_CACHE=1 HPNN_NO_PARALLEL_IO=1 HPNN_NO_NATIVE_IO=1``;
   MNIST's alone); cold (parallel native reads, the pack built); warm
   (from the pack).
   The streams must be byte-identical, the outputs bit-identical, each
   run must launch ``fused_linear_act`` and report its load mode; each
   load's time, each run's wall time and the pack's bytes are printed.
   Then ``train_nn --epochs 3`` on phase 9's files and conf with the
   cache off and warm (the test dir's pack removed first, so the warm
   run's prefetch builds it during the epochs): streams and kernel.opt
   byte-identical, each epoch's device time both ways; then ``run_nn`` of
   kernel.opt must load the test dir from the prefetched pack.
19. ``serve_nn``, the rest (run right after phase 18): MNIST 784-300-10
   ANN f64 (phase 9's trained kernel) and XRD 851-230-230 ANN f32 served
   with ``-b 64 --ab-fraction 0.25 --watch-ckpt mnist=D --watch-interval
   0.2 --auth-token T --no-warmup``; 8 client threads send 1-, 3- and
   64-row requests while a ``train_nn --epochs 3 --ckpt-every 1
   --ckpt-keep 3 --ckpt-dir D`` subprocess trains on phase 9's files, so
   its snapshots hot-reload into serving.  Then: a retained generation
   pinned with ``X-HPNN-Generation`` answers with its own weights, an
   unknown pin is 404, a reload without the token 401, a reload of a bad
   path 409 while the old weights keep answering, low/normal/high
   requests queued behind a paused batcher dispatch high first, an
   expired ``X-HPNN-Deadline-Ms`` is 504 with no launch, and a reload to
   784-100-10 serves the new shape.  Every answer must be bit-identical to
   the strict forward of the weights its ``generation`` label names (the
   kernel file that generation loaded), and ``fused_linear_act`` must have
   launched 2 times a batch ``/metrics`` counts.  Prints ``/metrics``
   p50/p99 by phase, each swap's wall time and the requests a second.
21. ``[model]`` row sharding (run right after phase 20).  At world 1 on
   the card the model axis clamps to one shard: ``train_nn`` of phase 9's
   conf and files with ``[model] 2``, ``-S 2`` and ``--model-parallel 2``
   each prints the JAX package's clamp warning, launches ``train_epoch``
   once, and gives the unsharded run's stream (minus the warning) and
   kernel.opt byte for byte; ``--epochs 3`` with ``[model] 2`` reports the
   ``tp-resident`` pipeline, ``tp_devices`` 1, 3 launches and phase 16's
   kernel.opt; ``run_nn`` of phase 4's MNIST ANN f64 conf with ``[model]
   2`` warns, launches ``fused_linear_act`` twice and gives phase 4's
   outputs and verdict lines.  The tp@K serving tier on a LocalMesh of the
   card repeated 2 and 4 times (``HPNN_EPOCH_DEVICE_BUDGET_MB=0``), ring
   and all-gather schedules: MNIST ANN f64 and XRD 851-230-230 ANN f32 at
   buckets 1, 3 and 64 against the strict tier (1e-12 f64, 1e-5 f32), each
   shard's first-layer rows bit-identical to the full layer's, the
   ``fused_linear_act`` launches a batch and the device ms a batch beside
   the strict tier's.  Meanwhile 2 gloo CPU ranks train ``[model] 2`` per
   sample on the first 64 of phase 9's files (from the kernel the earlier
   phases trained on them) and 4 ranks ``[batch] 32`` x
   ``[model] 2`` for 2 epochs on the 512, held to the card's one process
   (the lines equal; kernel.opt within 1e-12 per sample, 1e-11 on the
   grid).
22. The jobs service (run right after phase 21): ``serve_nn -b 64
   --ab-fraction 0.25 --jobs 2 --auto-promote`` (an in-process
   ``ServeApp``) serves a generated MNIST ANN f64 784-300-10 kernel to 8
   closed-loop clients of 1 and 64 rows.  Job A, a JSON submit of the
   tutorial conf (BP, f64, seed 10958) on phase 9's 512 files with its 512
   test files held out, 3 epochs, a snapshot each: ``done``, exactly 3
   ``train_epoch`` launches, at least 3 swaps, kernel.opt byte-identical to
   the port's offline ``train_nn --epochs 3 --ckpt-every 1`` of its
   generated conf, and its auto-promote decision printed with its eval
   requests.  Job B, 64 of those files uploaded in 4 chunks, 2 epochs: its
   pack equal to a ``ChunkedPackWriter`` of the same chunks.  Job C, job
   A's submit again, cancelled after its first epoch and resumed with
   ``resume_job`` to epoch 3: kernel.opt byte-identical to job A's.  A
   second server on the job dir reports the four jobs.  No reply other
   than 200, every answer bit-identical to the strict forward of the
   kernel file its generation loaded, and ``fused_linear_act`` launched 2
   times a batch.  Prints job A's epochs' device time beside phase 16's,
   the yield gate's wait an epoch, each swap's wall time, the 1-row client
   p50/p99 with no job and during job A, the launches, each job's submit
   to done and the phase's seconds.
23. Observability (run right after phase 22).  ``train_nn --epochs 3
   --profile-dir D`` on phase 9's files and conf with ``HPNN_TRACE=1
   HPNN_PROFILE=1 HPNN_DBG_TRACE=1``: the stream less its ``#PROF`` and
   ``#DBG`` lines, and kernel.opt, byte-identical to phase 16's untraced
   run; ``train_epoch`` launched exactly 3 times; the ``#PROF`` phases in
   the JAX package's order; each epoch's ``#DBG[train-in]`` sums the
   previous epoch's ``train-out``, the last ``train-out`` kernel.opt's
   sums (each weight rounded to 1e-15 in the file); D's Chrome trace
   holding 3 device events of ``train_epoch_kernel``, their durations
   printed beside phase 16's epoch events.  Then ``serve_nn -b 64 --trace
   --span-dir S --profile-dir P --jobs 1`` (in process) on phase 16's
   kernel.opt: 8 closed-loop clients of 1 and 64 rows, each request with
   its own ``X-HPNN-Trace-Id``, for 3 s, with ``POST /v1/debug/profile
   {"seconds": 2}`` inside: every answer bit-identical to the strict
   forward; sampled ids' ``/v1/debug/trace?trace=<id>`` trees
   ``serve.request`` -> {parse, queue_wait, batch_assembly, pad_h2d,
   device_launch, d2h, respond}; the capture's ``fused_linear_act``
   device events equal the wrapper's launches between the profiler's
   start and stop, 2 a batch (within one batch at each edge), and the
   capture, started on the endpoint's handler thread, holds ``cpu_op``
   rows of the batcher's thread (or its record says why the installed
   torch cannot give them); the search, critical and timeline endpoints' bodies equal ``obs.tool``'s
   stdout over S.  A job of 2 epochs on 64 of the files: ``?trace=job:<id>``
   holds ``jobs.run`` -> 2 ``train.epoch`` with ``ckpt.snapshot_write``
   and ``serve.hot_swap`` under them, ``?trace=events`` its slice grant
   and ``?timeline=1`` its ``job.state`` transitions; 2 ``train_epoch``
   launches.  Last, 8 clients of 1 row for 2 s each with tracing off, on
   and sampled at 0.1 (seeded): their p50/p99 printed.
24. The serve mesh (run right after phase 23): a generated MNIST
   784-300-10 ANN f64 kernel at ``-b 64``.  8 closed-loop clients of 1
   row against the plain server, then of 1 and 64 rows (the quota is a
   third of the rows a second it served them).  Then ``serve_nn
   --mesh-role router --workers 2`` with ``--slo-p99-ms``,
   ``--slo-availability``, ``--quota-rows``/``--quota-burst`` (in
   process) over worker A (in process, ``--require-router``: its
   ``fused_linear_act`` launches are read off the wrapper) and, after the
   one-worker window, worker B (``python -m hpnn_tpu_torch.cli serve_nn
   --mesh-role worker``, a process of its own, its own kernel dir): 1-row
   p50/p99 and requests a second for the plain server, the router with
   one worker and with two; keep-alive RPCs to worker A with and without
   TCP_NODELAY; a reload of a second kernel through the router under the
   1-and-64-row load (every reply bit-identical to the strict forward of
   the generation it names, every request sent after the reload served by
   the new one); worker B SIGKILLed under load (no non-200 reply, B
   ejected); worker C started in a dir holding only the first
   generation's files (the second's source path gone) catches up from
   the router's blob (one blob GET, sha-checked) and serves; a ninth
   client key flooding the router alone gets 429 ``quota_exceeded`` with
   Retry-After, the 8 load keys never; ``/healthz`` and ``/metrics``
   carry the SLO, quota, autoscale and mesh keys; worker A's launches
   exactly 2 a batch it served.  Prints the router's phases, worker B's
   start-to-registered and worker C's catch-up time and the phase's
   seconds (the swarm off and heartbeats at 0.3 s for the phase).
25. The standby router and the autoscaler (run right after phase 24):
   phase 24's kernel at ``-b 64``; a primary router (``--standby``,
   ``--autoscale 1:2 --autoscale-cooldown 2``), its standby
   (``--mesh-role standby --takeover-after 2``, polls every 0.2 s) and
   worker A, all in process.  8 closed-loop clients of 1 row make the
   supervisor spawn worker D (``python -m hpnn_tpu_torch.cli serve_nn
   --mesh-role worker --device cuda``; its spawn-to-registered time); the
   load stops and D is retired by drain, then SIGTERM (exit 0), with no
   non-200 reply; then the primary's listener is closed under the load,
   the standby takes over, every request that failed succeeds on one
   retry against it (the time from the primary's death to the standby's
   first 200), worker A's heartbeat follows it.  Every reply bit-identical
   to the strict forward; worker A's ``fused_linear_act`` exactly 2
   launches a batch (the routers launch none).
26. The host-streamed shard mode (run right after phase 25):
   ``train_nn --epochs 3`` on phase 9's files and conf with
   ``HPNN_EPOCH_SHARD_ROWS=128`` (4 ``train_epoch`` launches an epoch),
   ``HPNN_EPOCH_DEVICE_BUDGET_MB=1`` (shards of 1 MiB / 6,352 bytes a row
   / 2 = 82 rows: 7 launches an epoch) and ``--tile 32`` at 128 rows (4
   ``train_tile`` launches an epoch): the stream, kernel.tmp and
   kernel.opt of each byte-identical to phase 16's resident run, each
   epoch's device time beside it.
27. The C API (run right after phase 26): ``csrc/hpnn_shim.c`` built by
   the host compiler with this interpreter's embedding flags, and the
   unmodified ``native/train_nn.c`` and ``native/run_nn.c`` against it;
   the C ``train_nn -v -v`` and ``run_nn -v -v`` on phase 9's directory
   (``HPNN_DEVICE=cuda``) give the stdout, kernel.tmp and kernel.opt of
   ``python -m hpnn_tpu_torch.cli`` there, byte for byte (the walls of
   both printed); the port's ``apitest`` passes on the card; and
   ``_NN(init,all)``, ``_NN(train,kernel)`` and ``_NN(run,kernel)``
   through ``ctypes.PyDLL`` in this process launch ``train_epoch`` once
   and ``fused_linear_act`` twice.
28. The ``fast@meshN`` tier (``serve_nn --parity fast --mesh N``; run
   right after phase 27): a generated MNIST 784-300-10 ANN kernel at
   ``-b 256 --fast-threshold 64``, at float32, bfloat16 and float64, in
   a registry on a data mesh of 2 and of 4 shards (distinct cards where
   the host has them, else the one card repeated; the phase prints which)
   beside a single-device ``fast`` registry: requests of 64, 200 and 256
   rows, every float32/bfloat16 reply bit-identical to the ``fast``
   tier's and exactly 2N ``fused_linear_act`` launches a sharded batch
   (float64, a ``torch.matmul`` chain: 0 launches, the bits reported,
   held to 1e-12); the 256-row p50 of a synchronous registry call and its
   ``device`` phase beside the ``fast`` tier's, and B2's device time for
   one shard's block beside the whole bucket's.  Ten reloads under a
   client's 256-row load on the 4-shard float32 mesh: every reply
   bit-identical to the ``fast`` reply of the kernel file its generation
   loaded, 2N launches a batch.  ``python -m hpnn_tpu_torch.cli serve_nn
   --parity fast --mesh 4`` as a process: the JAX package's lines for the
   host (one card: no mesh, no warning), the 256-row bucket on the tier
   ``data_mesh(4)`` gives, a bit-identical 256-row answer, exit 0 on
   SIGTERM; ``--parity strict --mesh 2`` warns "inert".  Then
   ``fused_bpm_update`` at bfloat16 bit for bit against its plain version
   at phase 13's shapes, timed (warm, cold, floor, bound) at 300x784 and
   4096x4096.
29. Training on an in-process grid (run right after phase 28): MNIST
   784-300-10 at the tutorial conf on phase 9's 512 files, each run pinned
   to its devices with ``api.device_slice`` (distinct cards where the host
   has them, else the one card repeated; the phase prints which) and held
   to the one-shard run on the card: ``[batch] 32`` BP and BPM, ``--epochs
   2``, at 2 and 4 shards, resident and restaging (the ``TRAINING BATCH``
   lines equal, kernel.opt within 1e-11); the 2x2 ``[batch] 32`` x
   ``[model] 2`` grid against phase 21's four gloo ranks the same way;
   ``[model] 2`` per sample on phase 21's 64 files from its kernel (lines
   equal, 1e-12; B2 its kernel); ``[batch] 32`` + ``[tile] 4`` at 4
   shards on the first 256 of the files against the one-card
   ``train_tile`` route (lines equal, any
   other iteration count printed, 1e-11); ``[batch] 32`` CG on phase 20's
   [0, 1] bars at 4 shards (1e-9); ``run_nn`` of phase 21's ``[model] 2``
   conf over 2 shards (phase 4's lines and outputs, 4 B2 launches); a
   jobs server over the 4-shard grid's devices whose ``dp_devices: 2``
   job gives the offline 2-shard run's kernel.opt; on a host of several
   cards ``python -m hpnn_tpu_torch.cli train_nn`` as a process over every
   card.  B1 and B4 launch 0 times on the sharded routes.  Each run's
   epochs' device time, wall, launches and bytes a shard, then the
   ``[batch] 32`` BPM epoch of phase 20's 4096 files alone at 1 and 4
   shards: device and host ms, kernel launches (``torch.profiler``) and
   momentum bytes a shard.
30. Ranks that hold several devices (run right after phase 29): two
   ``HPNN_DISTRIBUTED`` ranks of two devices each, the (data x model)
   grid over every rank's devices, held to one process's 4-shard grid on
   the card.  On a host of four or more cards 2 NCCL ranks in torchrun's
   layout (``LOCAL_RANK``, ``LOCAL_WORLD_SIZE=2``) over the first four,
   rank 0 on cuda:0-1 and rank 1 on cuda:2-3, against one process over
   cuda:0-3; on fewer, 2 gloo ranks of 2 CPU shards each against one
   process over cuda:0 repeated (the phase prints which, with the card
   count).  MNIST 784-300-10: ``[batch] 32`` BPM f64 on phase 20's 4096
   files, ``[model] 2`` per sample (a replica of the group in each rank)
   and ``[model] 4`` (the group across the ranks) on phase 21's 64 files
   from its kernel, the 2x2 ``[batch] 32`` x ``[model] 2`` grid on phase
   9's 512 files, ``[batch] 32`` CG on phase 20's [0, 1] bars (4
   iterations an epoch): rank 0's lines equal the one process's, rank 1
   silent, kernel.opt within 1e-11 / 1e-12 / 1e-9; no B1 or B4 launch on
   a rank, and on cards B2 launched by each rank on the ``[model]`` and
   grid routes (the counts set to 0 just before each case, in each rank).
15. One JSON line of every kernel (launches on its main path, the largest
   kernel-vs-plain error over every cell and dtype, times and bound;
   ``fused_linear_act`` adds its B=1 cell and its worst ratio to the
   library call over phase 6's cells; ``train_epoch`` its grid barriers an
   iteration as its kernel counted them, its launch plan and shared bytes
   a block at phase 9's widths, and its first and second launch;
   ``train_tile`` the same for phase 12's epoch, the autotuner's tile and
   the epoch's time at each candidate tile, its build's stack frame and
   the wide run's workspace plan; both their launches and epoch times in
   phase 16 and their launches and wall times in phase 17
   (``ckpt_launches``, ``ckpt_wall_s``), and phase 18's epoch times
   (``corpus_epochs_device_ms``); ``fused_linear_act`` phase 18's
   launches (``corpus_launches``); both their launches in phase 22
   (``jobs_launches``) and job A's epoch times
   (``jobs_epochs_device_ms``); ``fused_bpm_update`` its warm, cold and
   floor times; ``train_epoch`` and ``fused_linear_act`` their launches on
   phase 21's paths, ``tp_launches``; phase 23's: ``train_epoch``'s
   launches and profiled durations (``obs_launches``,
   ``obs_profile_us``), ``fused_linear_act``'s profiled events and
   launches in the capture (``obs_profile_events``,
   ``obs_profile_launches``); ``fused_linear_act`` phase 24's and phase
   25's worker A launches and batches (``mesh_launches``,
   ``standby_launches``); ``train_epoch`` and ``train_tile`` their
   launches and epoch times in phase 26 (``shard_launches``,
   ``shard_epochs_device_ms``); ``train_epoch`` and ``fused_linear_act``
   their launches through phase 27's in-process C calls
   (``c_api_launches``); ``fused_linear_act`` its launches a sharded batch
   and under the reloads in phase 28 (``data_mesh_launches``,
   ``data_mesh_swap_launches``) and that phase's times
   (``data_mesh_ms``); ``fused_linear_act`` its launches by rank in phase
   30 (``rank_grid_launches``) and the branch that ran;
   ``fused_bpm_update`` its bfloat16 cells), a line
   of each phase's seconds, then the result line.

Main paths: ``fused_linear_act``'s is phases 4-5, ``train_epoch``'s phase 9
and ``train_tile``'s phase 12 (train_nn, then run_nn of its kernel, which
launches ``fused_linear_act`` too), phase 16's two ``--epochs`` runs,
phase 17's checkpointed, killed and resumed runs, phase 18's runs and
phase 19's server (``serve_rest_launches``), phase 21's TP routes
(``tp_launches``), phase 22's server and jobs (``jobs_launches``) and
phase 23's traced run and capture (``obs_*``), phase 24's worker A
(``mesh_launches``; the router launches nothing), phase 25's
(``standby_launches``), phase 26's sharded runs (``shard_launches``),
phase 27's C calls (``c_api_launches``) and phase 28's sharded batches
(``data_mesh_launches``, ``data_mesh_swap_launches``); every count is set to
0 just before a path and read
just after it.  ``fused_bpm_update`` has no caller on any
path, as in the JAX package: its ``launches`` are the paths' (0), its
``phase_launches`` phase 13's.  ``--json PATH`` also writes every cell's
numbers to PATH.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK = {"f32": 67e12, "f64": 67e12, "bf16": 989e12}   # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
LIMIT = {"f32": 1e-5, "f32-pixel": 1e-4, "bf16": 2e-2, "f64": 1e-12}
BATCHES = (1, 3, 64, 512, 4096)
TIMED_BATCHES = (1, 64, 512, 4096)
INVARIANCE_BATCHES = (1, 3, 64, 512)   # phase 14: against one B=4096 call
INVARIANCE_ROW = 1001                  # phase 14: the odd first row
SPIN_CYCLES = 10_000_000    # ~5 ms of GPU clock: covers one run's enqueue
# (label, N, M, act, input scale) -- the layers of the main path
LAYERS = (("784->300", 300, 784, True, "pixel"),
          ("300->10", 10, 300, False, "unit"),
          ("851->230", 230, 851, True, "unit"),
          ("230->230", 230, 230, True, "unit"))
N_FILES = 4096
MNIST = (784, [300], 10)
XRD = (851, [230], 230)
# phase 7: a hidden layer with more rows than an H100 holds warps at once
# (132 SMs x 8 warps x the blocks an SM holds), so the epoch kernel's grid
# is what the card holds and a warp takes several rows of a layer
WIDE = (784, [2304], 10)
# phase 7: an input layer too wide for the epoch kernel's staged vectors
# in one block's shared memory at f64, which the wrapper refuses
TOO_WIDE = (30000, [10], 10)
TRAIN_FILES = 512          # phase 9: training files, and as many test files
# phase 7 runs: (tag, topology, kind, momentum, dtype, classes, samples)
TRAIN_RUNS = (
    [("mnist", MNIST, k, m, d, (0, 1) if k == "ANN" else (0, 1, 2, 3), 8)
     for k in ("ANN", "SNN") for m in (False, True)
     for d in ("f64", "f32", "bf16")]
    + [("xrd", XRD, "ANN", True, d, (0,), 2) for d in ("f64", "f32")]
    + [("mnist", MNIST, "LNN", False, "f64", (0, 1), 8)]
    + [("near1", MNIST, "ANN", False, "f64", (0, 1), 2)]
    + [("wide", WIDE, "ANN", False, "f64", (0, 1), 2)])
# the "near1" run's last output target: 2^-30 below 1, so in double it is
# not the target class (the exact 1 of class 0 or 1 is), as in hpnn_tpu
NEAR_ONE = 1.0 - 2.0**-30
# kernel vs plain, per dtype: (n_iter slack: absolute, relative; weights).
# f32: the envelope of tests/test_pallas_convergence.py:35-57, with 2%
# where it has 1%: an XRD ANN BPM sample runs 20-37k iterations and its
# stop (dEp <= 1e-6) falls where the f32 error moves by a few ULPs an
# iteration, so the two sum orders stopped 1.08% apart on one sample (on
# the H100).  bf16 rounds every operation to bf16 in both versions, so
# only the order of the float32 sums differs, as at f32: it is held to the
# f32 limits (measured: identical n_iter and weights in all six runs).
TRAIN_LIMIT = {"f64": (0, 0.0, 1e-10), "f32": (4, 0.02, 5e-3),
               "bf16": (4, 0.02, 5e-3)}
# Phase 10 holds f32/bf16 weights to that limit times the largest plain
# weight (at least 1): MNIST SNN BPM f32 at tile 8 grows its first-layer
# weights to many times 1 in a few pixel-scale steps, and there two f32 sum
# orders of the same math end farther apart than 5e-3: the plain version
# run on the CPU and on the card does, by as much as the kernel and the
# card's plain version (on the H100), and the gap closes when the card's
# plain takes its three matrix products from the CPU.
# phase 10 runs: (tag, topology, kind, momentum, dtype, classes, samples,
# tile, storage)
TILE_RUNS = (
    [("mnist", MNIST, k, m, d, (0, 1) if k == "ANN" else (0, 1, 2, 3), 19,
      8, None) for k in ("ANN", "SNN") for m in (False, True)
     for d in ("f64", "f32", "bf16")]
    + [("xrd", XRD, "ANN", True, d, (0, 1), 4, 4, None) for d in ("f64",
                                                                  "f32")]
    + [("mnist", MNIST, "LNN", False, "f64", (0, 1), 19, 8, None)]
    + [("mnist", MNIST, "ANN", False, "f32", (0, 1), 19, 8, st)
       for st in ("bf16", "f32")]
    + [("wide", WIDE, "ANN", False, "f64", (0, 1), 19, 8, None)])
# phase 10: a hidden layer so wide that at tile 512 the tile kernel's block
# scratch (the lanes' deltas and a_0 of a block's 32 rows) does not fit in
# shared memory and goes to the block's workspace slice; a few lockstep
# iterations (max_iter) of one group of 512 samples
WIDE_SCRATCH = ((784, [4096], 10), 512, 3)
TRAIN_TILE = 32            # phase 12: train_nn --tile
# phase 13: the MNIST and XRD layers (N, M) and one past the 50 MB L2
BPM_SHAPES = ((300, 784), (10, 300), (230, 851), (230, 230), (4096, 4096))
BPM_COLD_BYTES = 100 << 20   # phase 13: the inputs a cold run rotates over
BPM_COLD_RUN = 256           # phase 13: the most launches a timed cold run
BPM_LR, BPM_ALPHA = 0.0005, 0.2   # phases 13 and 28: the update's scalars
SPIN_PER_LAUNCH = 100_000    # GPU cycles of spin per queued launch (~50 us)
EPOCHS = 3                   # phase 16: train_nn --epochs
KILL_AT = 1                  # phase 17: HPNN_CKPT_KILL_AT_EPOCH


def log(msg: str) -> None:
    print(msg, flush=True)


def _dtypes():
    import torch

    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "f64": torch.float64}


def _limit(dtype: str, scale: str) -> float:
    if dtype == "f32" and scale == "pixel":
        return LIMIT["f32-pixel"]
    return LIMIT[dtype]


def _inputs(rng, b, m, scale):
    if scale == "pixel":
        return rng.integers(0, 256, (b, m)).astype(np.float64)
    return rng.uniform(-1.0, 1.0, (b, m))


def _to_card(a, dtype):
    import torch

    return torch.as_tensor(a, dtype=torch.float64).cuda().to(dtype)


# --- phase 1-2 --------------------------------------------------------------

def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return card


def phase_build():
    """Build every kernel; fails when the compiler gives any kernel of the
    tile kernel's library a stack frame or spills (its design keeps nothing
    in local memory).  Returns how many it checked, and their frame and
    spill bytes (0)."""
    from hpnn_tpu_torch.ops import build
    from hpnn_tpu_torch.ops.convergence_tile_kernel import _ENTRY

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")
    frames = re.findall(
        r"Function properties for (\S+)\s+(\d+) bytes stack frame, (\d+) "
        r"bytes spill stores, (\d+) bytes spill loads",
        build.build_log("train_tile"))
    bad = [f for f in frames if any(map(int, f[1:]))]
    # each entry point compiled with its block scratch on chip and off
    if len(frames) < 2 * len(_ENTRY) or bad:
        raise AssertionError(f"train_tile: {len(frames)} kernels compiled; "
                             "with a stack frame or spills (bytes of frame, "
                             f"spill stores, spill loads): {bad}")
    return {"entries": len(frames), "stack_frame_bytes": 0,
            "spill_bytes": 0}


# --- phase 3 ----------------------------------------------------------------

def phase_kernel_vs_plain():
    import torch

    from hpnn_tpu_torch.ops.kernels import (fused_linear_act,
                                            fused_linear_act_plain)

    rng = np.random.default_rng(20260101)
    errs = {}
    cases = [(label, n, m, act, scale, b) for label, n, m, act, scale
             in LAYERS for b in BATCHES]
    cases += [("784->300", 300, 784, True, "unit", b) for b in BATCHES]
    cases.append(("37->13", 13, 37, True, "unit", 5))
    for label, n, m, act, scale, b in cases:
        w = rng.uniform(-1.0, 1.0, (n, m)) / np.sqrt(m)
        x = _inputs(rng, b, m, scale)
        for dname, dt in _dtypes().items():
            wt, xt = _to_card(w, dt), _to_card(x, dt)
            got = fused_linear_act(wt, xt, act=act)
            want = fused_linear_act_plain(wt, xt, act=act)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            lim = _limit(dname, scale)
            errs[(label, scale, dname, b)] = err
            if not err <= lim:
                raise AssertionError(
                    f"fused_linear_act {label} {dname} B={b} ({scale}): "
                    f"max |kernel - plain| = {err:.3e} > {lim:g}")
    worst = {d: max(e for k, e in errs.items() if k[2] == d)
             for d in _dtypes()}
    log(f"kernel vs plain: {len(errs)} cells within limits; worst "
        + ", ".join(f"{d} {e:.3e}" for d, e in worst.items()))
    return errs


# --- phase 14 ---------------------------------------------------------------

def phase_invariance():
    """Rows of one B=4096 call against the same rows in smaller calls,
    bit for bit, at every layer and dtype; returns the plans crossed."""
    import torch

    from hpnn_tpu_torch.ops.kernels import _plan, fused_linear_act

    def _plan_key(b, n, m, dt):
        plan = _plan(b, n, m, dt)
        return plan.tile, plan.per_group, plan.groups

    rng = np.random.default_rng(20260105)
    rows, plans = 0, set()
    for label, n, m, act, scale in LAYERS:
        w = rng.uniform(-1.0, 1.0, (n, m)) / np.sqrt(m)
        x = _inputs(rng, 4096, m, scale)
        for dname, dt in _dtypes().items():
            wt, xt = _to_card(w, dt), _to_card(x, dt)
            full = fused_linear_act(wt, xt, act=act)
            plans.add(_plan_key(4096, n, m, dt))
            for b in INVARIANCE_BATCHES:
                plans.add(_plan_key(b, n, m, dt))
                for lo in (0, INVARIANCE_ROW):
                    part = fused_linear_act(wt, xt[lo:lo + b], act=act)
                    torch.cuda.synchronize()
                    if not _bitwise(part, full[lo:lo + b]):
                        raise AssertionError(
                            f"fused_linear_act {label} {dname}: rows "
                            f"{lo}:{lo + b} of a B={b} call differ from "
                            "the same rows of the B=4096 call")
                    rows += b
    plans = sorted(plans)
    log(f"batch invariance: {rows} rows over {len(LAYERS)} layers x "
        f"{len(_dtypes())} dtypes bit-identical to the B=4096 calls, "
        f"across {len(plans)} plans (tile, stages a group, groups): "
        + ", ".join(f"{t}/{g}/{z}" for t, g, z in plans))
    return plans


# --- phase 4 ----------------------------------------------------------------

def _write_corpus(dirpath, n_in, n_out, scale, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath)
    for i in range(N_FILES):
        x = _inputs(rng, 1, n_in, scale)[0]
        label = int(rng.integers(n_out))
        with open(os.path.join(dirpath, f"s{i:05d}.txt"), "w") as fp:
            fp.write(f"[input] {n_in}\n")
            fp.write(" ".join(f"{v:7.5f}" for v in x) + "\n")
            fp.write(f"[output] {n_out}  #{label}\n")
            fp.write(" ".join("1.0" if j == label else "-1.0"
                              for j in range(n_out)) + "\n")


def _setup_runs(tmp):
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import generate_kernel

    runs = []
    for tag, (n_in, hid, n_out), scale, seed in (
            ("mnist", MNIST, "pixel", 10958), ("xrd", XRD, "unit", 851)):
        tests = os.path.join(tmp, f"{tag}_tests")
        _write_corpus(tests, n_in, n_out, scale, seed)
        kern, _ = generate_kernel(seed, n_in, hid, n_out)
        kpath = os.path.join(tmp, f"{tag}_kernel.opt")
        dump_kernel_to_path(kern, kpath)
        combos = ([(k, d) for k in ("ANN", "SNN") for d in
                   ("f64", "f32", "bf16")] if tag == "mnist"
                  else [("ANN", "f32")])
        for kind, dtype in combos:
            name = f"{tag}_{kind.lower()}_{dtype}"
            conf = os.path.join(tmp, f"{name}.conf")
            with open(conf, "w") as fp:
                fp.write(f"[name] {name}\n[type] {kind}\n[init] {kpath}\n"
                         f"[seed] 10958\n[input] {n_in}\n"
                         f"[hidden] {' '.join(map(str, hid))}\n"
                         f"[output] {n_out}\n[train] BP\n"
                         f"[test_dir] {tests}\n[dtype] {dtype}\n")
            runs.append((name, conf, kind, dtype, scale))
    return runs


def phase_run_nn(runs):
    import torch

    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.api import configure, dtype_of, load_tests
    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.kernels import (batched_forward_plain,
                                            fused_linear_act)

    results, rows_cache = {}, {}
    for name, conf, kind, dtype, scale in runs:
        before = fused_linear_act.launches
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda", conf])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        launched = fused_linear_act.launches - before
        if rc != 0 or outs is None:
            raise AssertionError(f"run_nn {name}: rc={rc}")
        if launched <= 0:
            raise AssertionError(f"run_nn {name}: no kernel launch")
        n_tested = text.count("TESTING FILE:")
        if n_tested != N_FILES or outs.shape[0] != N_FILES:
            raise AssertionError(f"run_nn {name}: {n_tested} files tested")
        if not np.all(np.isfinite(outs)):
            raise AssertionError(f"run_nn {name}: non-finite outputs")
        nn = configure(conf)
        key = nn.conf.tests
        if key not in rows_cache:
            from hpnn_tpu_torch.io.corpus import LAST_LOAD

            t0 = time.perf_counter()
            rows_cache[key] = load_tests(nn)[1]
            log(f"corpus {os.path.basename(key)}: {N_FILES} files loaded "
                f"on the host in {time.perf_counter() - t0:.2f} s "
                f"({LAST_LOAD['mode']}; native_io: {LAST_LOAD['native_io']})")
        xs = rows_cache[key]
        dt = dtype_of(nn.conf)
        weights = weights_to_torch(nn.kernel.weights, dt, "cuda")
        plain = batched_forward_plain(
            weights, torch.as_tensor(xs).cuda().to(dt), kind)
        err = float(np.max(np.abs(
            outs - plain.double().cpu().numpy())))
        lim = _limit(dtype, scale)
        if not err <= lim:
            raise AssertionError(f"run_nn {name}: max |kernel - plain| = "
                                 f"{err:.3e} > {lim:g}")
        log(f"run_nn {name}: {n_tested} files, PASS={text.count('[PASS]')}"
            f", launches={launched}, max |kernel - plain| = {err:.3e} "
            f"(limit {lim:g}), {wall:.2f} s")
        results[name] = (outs, xs)
    return results


# --- phase 5 ----------------------------------------------------------------

def _post(url, rows):
    body = json.dumps({"inputs": rows.tolist()}).encode()
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def phase_serve(runs, results):
    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.server import serve_in_thread

    confs = {name: conf for name, conf, *_ in runs}
    served = ("mnist_ann_f32", "mnist_ann_f64",
              "mnist_snn_f32", "mnist_snn_f64")
    before = fused_linear_act.launches
    app, _ = cli.serve_app(["-p", "0", "--device", "cuda",
                            "--warmup-mode", "sync",
                            *(confs[n] for n in served)])
    if app is None:
        raise AssertionError("serve_nn: no app")
    httpd, th = serve_in_thread(app, "127.0.0.1", 0)
    base = "http://%s:%d" % httpd.server_address[:2]
    n_req = 0
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            if r.status != 200:
                raise AssertionError(f"healthz {r.status}")
        for name in served:
            outs, xs = results[name]
            url = f"{base}/v1/kernels/{name}/infer"

            def check(lo, hi, url=url, outs=outs, xs=xs, name=name):
                status, body = _post(url, xs[lo:hi])
                got = np.asarray(body["outputs"], np.float64)
                if status != 200 or not np.array_equal(got, outs[lo:hi]):
                    raise AssertionError(
                        f"serve {name} rows {lo}:{hi}: status {status}, "
                        "answer not bit-identical to run_nn")

            for lo, hi in ((0, 1), (1, 4), (4, 68)):
                check(lo, hi)
                n_req += 1
            spans = [(100 + 9 * i, 100 + 9 * i + 1 + i) for i in range(8)]
            errors = []

            def one(lo, hi):
                try:
                    check(lo, hi)
                except Exception as exc:  # re-raised below, on this thread
                    errors.append(exc)

            threads = [threading.Thread(target=one, args=s) for s in spans]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                if t.is_alive():
                    raise AssertionError("serve: a request never returned")
            if errors:
                raise errors[0]
            n_req += len(spans)
        with urllib.request.urlopen(base + "/metrics?format=json",
                                    timeout=60) as r:
            snap = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close(drain=True)
        th.join(timeout=60)
    launched = fused_linear_act.launches - before
    if launched <= 0:
        raise AssertionError("serve: no kernel launch")
    log(f"serve_nn: {n_req} requests over {len(served)} kernels, all 200 "
        f"and bit-identical to run_nn; launches={launched}; batches="
        f"{snap['batches_total']}; cache={snap['compile_cache']}")


# --- phase 6 ----------------------------------------------------------------

def _device_ms(fn, launches=10, runs=20):
    """Device time of one call of ``fn``: the median over ``runs`` of a
    back-to-back run of ``launches`` calls between two CUDA events.  A GPU
    spin (``torch.cuda._sleep``) is queued first, so the host has enqueued
    the whole run before the first call starts and host overhead does not
    enter the measurement."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _bound(b, n, m, dtype):
    item = {"f32": 4, "bf16": 2, "f64": 8}[dtype]
    t_ops = 2.0 * b * n * m / PEAK[dtype]
    t_bytes = (b * m + n * m + b * n) * item / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_times():
    from hpnn_tpu_torch.ops.activations import ann_act
    from hpnn_tpu_torch.ops.kernels import (fused_linear_act,
                                            fused_linear_act_plain)

    import torch

    rng = np.random.default_rng(7)
    cells = []
    for label, n, m, act, scale in LAYERS:
        w = rng.uniform(-1.0, 1.0, (n, m)) / np.sqrt(m)
        for b in TIMED_BATCHES:
            x = _inputs(rng, b, m, scale)
            for dname, dt in _dtypes().items():
                wt, xt = _to_card(w, dt), _to_card(x, dt)

                def library(wt=wt, xt=xt, act=act):
                    z = torch.matmul(xt, wt.T)
                    return ann_act(z) if act else z

                def kernel(wt=wt, xt=xt, act=act):
                    return fused_linear_act(wt, xt, act=act)

                def plain(wt=wt, xt=xt, act=act):
                    return fused_linear_act_plain(wt, xt, act=act)

                ms = _device_ms(kernel)
                plain_ms = _device_ms(plain)
                library_ms = _device_ms(library)
                bound_ms, bound_by = _bound(b, n, m, dname)
                cells.append({"layer": label, "dtype": dname, "B": b,
                              "ms": ms, "plain_ms": plain_ms,
                              "library_ms": library_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by})
                log(f"time fused_linear_act {label} {dname} B={b}: "
                    f"ms={ms:.5f} plain_ms={plain_ms:.5f} "
                    f"library_ms={library_ms:.5f} "
                    f"bound_ms={bound_ms:.5f} ({bound_by})")
    return cells


# --- phase 7-9: the training epoch kernel ----------------------------------

def _bar_corpus(n, topology, classes, seed):
    """A separable corpus: class c lights one bar (60 pixels at 250 on the
    MNIST width, 3 inputs at 1.0 on the XRD width), plus one random input
    (tests/test_tutorials.py:26-31).  Returns (xs, ts, labels)."""
    n_in, _, n_out = topology
    mnist = n_in == 784
    width, value = (60, 250.0) if mnist else (3, 1.0)
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, n_in))
    ts = -np.ones((n, n_out))
    labels = [classes[i % len(classes)] for i in range(n)]
    for i, c in enumerate(labels):
        xs[i, c * width:(c + 1) * width] = value
        xs[i, rng.integers(0, n_in)] = (rng.integers(0, 256) if mnist
                                        else rng.uniform(0.0, 1.0))
        ts[i, c] = 1.0
    return xs, ts, labels


def _train_inputs(topology, dtype, classes, samples, seed=31):
    import torch

    from hpnn_tpu_torch.models.kernel import generate_kernel

    n_in, hid, n_out = topology
    xs, ts, _ = _bar_corpus(samples, topology, classes, seed)
    kern, _ = generate_kernel(10958, n_in, hid, n_out)
    dt = _dtypes()[dtype]
    wdt = torch.float32 if dt == torch.bfloat16 else dt
    return (tuple(_to_card(w, wdt) for w in kern.weights),
            _to_card(xs, dt), _to_card(ts, dt))


def _params(weights):
    return sum(w.shape[0] * w.shape[1] for w in weights)


def _train_bound(weights, momentum, iters, dtype, n_samples):
    """The least time of an epoch of ``iters`` iterations: the operations
    the kernel does per iteration (the update fused into the forward:
    BP 3 flops a weight, BPM 5, the forward's multiply-add 2; the hidden
    deltas 2 a weight of every layer but the first) over the card's peak,
    against the bytes of the epoch's inputs and outputs read and written
    once (weights in and out, samples, targets, stats; the weights stay on
    the chip between iterations) over 3.35 TB/s.  Returns (bound_ms,
    bound_by, flops_per_iteration)."""
    p = _params(weights)
    p_hidden = p - weights[0].shape[0] * weights[0].shape[1]
    flops_it = (7 if momentum else 5) * p + 2 * p_hidden
    item = {"f32": 4, "bf16": 2, "f64": 8}[dtype]
    witem = 4 if dtype == "bf16" else item
    n_in, n_out = weights[0].shape[1], weights[-1].shape[0]
    nbytes = 2 * p * witem + n_samples * (n_in + n_out) * item \
        + n_samples * 5 * 8
    t_ops = iters * flops_it / PEAK[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops_it)


def _check_train(tag, dtype, sk, sp, wk, wp, name="train_epoch",
                 scaled=False):
    """Kernel stats/weights against the plain version's; raises above the
    dtype's limits (``scaled``: f32/bf16 weights relative to the largest
    plain weight, as phase 10 holds them).  Returns (max weight diff, max
    |dn_iter|)."""
    k, p = sk.cpu().numpy(), sp.cpu().numpy()
    slack, rel, wlim = TRAIN_LIMIT[dtype]
    if scaled and dtype != "f64":
        wlim *= max(1.0, max(float(b.double().abs().max()) for b in wp))
    werr = max(float((a.double() - b.double()).abs().max())
               for a, b in zip(wk, wp))
    dn = np.abs(k[:, 2] - p[:, 2])
    bad = []
    if not np.array_equal(k[:, [1, 4]], p[:, [1, 4]]):
        bad.append("first_ok/success differ")
    if not np.all(dn <= np.maximum(slack, rel * p[:, 2])):
        bad.append(f"n_iter {k[:, 2].tolist()} vs {p[:, 2].tolist()}")
    if dtype == "f64":
        eerr = float(np.abs(k[:, [0, 3]] - p[:, [0, 3]]).max())
        if not eerr <= 1e-12:
            bad.append(f"init_err/final_dep differ by {eerr:.3e}")
    if not werr <= wlim:
        bad.append(f"weights differ by {werr:.3e} > {wlim:g}")
    if bad:
        raise AssertionError(f"{name} {tag}: " + "; ".join(bad))
    return werr, float(dn.max())


def phase_train_vs_plain():
    import torch

    from hpnn_tpu_torch.ops.convergence_kernel import (train_epoch_kernel,
                                                       train_epoch_plain)

    # a launch of each dtype and plan first, so that no timed run below
    # pays for loading the library and its kernels; each first launch is
    # timed (host clock) against a second on the same inputs, whose
    # difference is the one-off cost a fresh process pays
    first = {}
    for dtype in _dtypes():
        w, x, t = _train_inputs(MNIST, dtype, (0,), 1)
        for resident in (0, 1):
            ms = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_epoch_kernel(w, x, t, "ANN", False, _plan=resident)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            first[f"{dtype} {'resident' if resident else 'staged'}"] = {
                "first_ms": ms[0], "second_ms": ms[1]}
    log("train_epoch first launch, then a second on the same inputs (1 "
        "MNIST ANN BP sample), ms: " + ", ".join(
            f"{k} {v['first_ms']:.2f} then {v['second_ms']:.2f}"
            for k, v in first.items()))
    results = []
    for name, topo, kind, momentum, dtype, classes, n in TRAIN_RUNS:
        w, x, t = _train_inputs(topo, dtype, classes, n)
        if name == "near1":
            t[:, -1] = NEAR_ONE
        tag = (f"{name} {kind} {'BPM' if momentum else 'BP'} {dtype} "
               f"({n} samples)")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wk, sk = train_epoch_kernel(w, x, t, kind, momentum)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        plan = dict(train_epoch_kernel.plan)
        per_iter = _barriers_per_iter(w, sk)
        # the other plan (W_0 in device memory, or resident) on the same
        # inputs: the same bits
        wo, so = train_epoch_kernel(w, x, t, kind, momentum,
                                    _plan=0 if plan["resident"] else 1)
        torch.cuda.synchronize()
        if not (_bitwise(wk, wo) and _bitwise(sk, so)):
            raise AssertionError(f"train_epoch {tag}: the {plan} plan and "
                                 f"{train_epoch_kernel.plan} differ")
        if name == "wide" and max(plan["rows0"],
                                  train_epoch_kernel.plan["rows0"]) < 2:
            raise AssertionError(f"train_epoch {tag}: no plan took several "
                                 f"rows a warp ({plan}, "
                                 f"{train_epoch_kernel.plan})")
        t0 = time.perf_counter()
        wp, sp = train_epoch_plain(w, x, t, kind, momentum)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        werr, dn = _check_train(tag, dtype, sk, sp, wk, wp)
        k, p = sk.cpu().numpy(), sp.cpu().numpy()
        iters, p_iters = int(k[:, 2].sum()), int(p[:, 2].sum())
        bound_ms, bound_by, flops_it = _train_bound(w, momentum, iters,
                                                    dtype, n)
        same = int(np.sum((k[:, 1] == p[:, 1]) & (k[:, 4] == p[:, 4])))
        results.append({"run": tag, "dtype": dtype, "kind": kind,
                        "momentum": momentum, "samples": n,
                        "iters": iters, "plain_iters": p_iters,
                        "max_dn_iter": dn, "max_abs_err": werr,
                        "verdicts_equal": same, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "flops_per_iter": flops_it,
                        "plan": plan, "other_plan":
                            dict(train_epoch_kernel.plan),
                        "barriers_per_iter": per_iter,
                        "n_iter": k[:, 2].astype(int).tolist(),
                        "plain_n_iter": p[:, 2].astype(int).tolist()})
        log(f"train_epoch {tag}: iterations {iters} (plain {p_iters}), "
            f"max |dn_iter| {dn:g}, verdicts equal {same}/{n}, max |kernel - "
            f"plain| weights {werr:.3e}; kernel {ms:.2f} ms = "
            f"{ms * 1e3 / iters:.2f} us/iter on {plan['blocks']} blocks "
            f"x {plan['warps']} warps, {plan['rows0']} row(s) of W_0 a warp, "
            f"{'resident' if plan['resident'] else 'staged'} plan "
            f"({plan['smem_bytes']} shared bytes a block; the other plan "
            f"bit-identical), {per_iter:g} grid barriers an iteration, "
            f"plain {plain_ms * 1e3 / p_iters:.1f} us/iter, "
            f"bound {bound_ms * 1e6 / iters:.4f} ns/iter ({bound_by})")
    worst = {d: max((r["max_abs_err"] for r in results if r["dtype"] == d),
                    default=0.0) for d in _dtypes()}
    log("train_epoch vs plain: all runs within limits; worst weight error "
        + ", ".join(f"{d} {e:.3e}" for d, e in worst.items()))
    # widths whose staged vectors do not fit in a block's shared memory:
    # refused with a clear error, nothing launched
    w, x, t = _train_inputs(TOO_WIDE, "f64", (0, 1), 1)
    before = train_epoch_kernel.launches
    try:
        train_epoch_kernel(w, x, t, "ANN", False)
    except ValueError as exc:
        refusal = str(exc)
    else:
        raise AssertionError(f"train_epoch at {TOO_WIDE} f64 launched")
    if train_epoch_kernel.launches != before:
        raise AssertionError("train_epoch counted a refused launch")
    log(f"train_epoch at {TOO_WIDE} f64 refused: {refusal}")
    return results, first


def _barriers_per_iter(weights, stats):
    """The grid barriers the last epoch launch took an iteration, as its
    kernel counted them; raises unless that is 2L - 2 (L >= 2 layers; 1 for
    L = 1) and its iterations are those of its stats rows."""
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel

    in_iters, _, iters = train_epoch_kernel.syncs.tolist()
    n_iter = stats.n_iter if hasattr(stats, "n_iter") else stats[:, 2]
    trained = int(n_iter[n_iter >= 0].sum())
    layers = len(weights)
    want = 2 * layers - 2 if layers > 1 else 1
    if iters != trained or in_iters != want * iters:
        raise AssertionError(f"train_epoch: {in_iters} grid barriers in "
                             f"{iters} iterations ({trained} in the stats), "
                             f"not {want} an iteration")
    return in_iters / iters


def phase_resume():
    import torch

    from hpnn_tpu_torch.ops.convergence_kernel import (train_epoch_cuda,
                                                       train_epoch_kernel)

    w, x, t = _train_inputs(MNIST, "f64", (0, 1), 8)
    before = train_epoch_kernel.launches
    w1, s1 = train_epoch_cuda(w, x, t, "ANN", False)
    one = train_epoch_kernel.launches - before
    w2, s2 = train_epoch_cuda(w, x, t, "ANN", False, iter_budget=100)
    many = train_epoch_kernel.launches - before - one
    torch.cuda.synchronize()
    if one != 1 or many <= 1:
        raise AssertionError(f"resume: {one} launch(es) unbudgeted, {many} "
                             "budgeted")
    equal = all(np.array_equal(a.cpu().numpy(), b.cpu().numpy())
                for a, b in zip(w1, w2)) and all(
        np.array_equal(getattr(s1, f).numpy(), getattr(s2, f).numpy())
        for f in s1._fields)
    if not equal:
        raise AssertionError("resume: budgeted launches differ from one "
                             "launch")
    log(f"resume: f64 MNIST ANN BP epoch ({int(s1.n_iter.sum())} "
        f"iterations) in {many} launches at a budget of 100 iterations is "
        "bit-identical to 1 launch")
    return many


def _write_samples(dirpath, xs, ts, labels):
    os.makedirs(dirpath)
    for i, (x, t, c) in enumerate(zip(xs, ts, labels)):
        with open(os.path.join(dirpath, f"s{i:05d}.txt"), "w") as fp:
            fp.write(f"[input] {x.shape[0]}\n")
            fp.write(" ".join(f"{v:.1f}" for v in x) + "\n")
            fp.write(f"[output] {t.shape[0]}  #{c}\n")
            fp.write(" ".join(f"{v:.1f}" for v in t) + "\n")


def phase_train_nn(tmp):
    """train_nn on the MNIST tutorial conf (tutorials/mnist/tutorial.bash:
    36-48: ANN, BP, [init] generate, [seed] 10958, 784-300-10, f64), then
    run_nn of its kernel.opt."""
    from hpnn_tpu_torch import cli

    root = os.path.join(tmp, "train_nn")
    classes = tuple(range(10))
    for sub, seed in (("samples", 5), ("tests", 6)):
        xs, ts, labels = _bar_corpus(TRAIN_FILES, MNIST, classes, seed)
        _write_samples(os.path.join(root, sub), xs, ts, labels)
    conf = ("[name] mnist\n[type] ANN\n[init] generate\n[seed] 10958\n"
            "[input] 784\n[hidden] 300\n[output] 10\n[train] BP\n"
            "[sample_dir] ./samples\n[test_dir] ./tests\n")
    with open(os.path.join(root, "nn.conf"), "w") as fp:
        fp.write(conf)
    with open(os.path.join(root, "run.conf"), "w") as fp:
        fp.write(conf.replace("[init] generate", "[init] kernel.opt"))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.train_nn_main(["-v", "-v", "--device", "cuda",
                                    "nn.conf"])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        lines = [ln for ln in text.splitlines() if "TRAINING FILE:" in ln]
        iters = [int(m) for m in re.findall(r"N_ITER=\s*(\d+)", text)]
        if rc != 0 or len(lines) != TRAIN_FILES or len(iters) != TRAIN_FILES:
            raise AssertionError(f"train_nn: rc={rc}, {len(lines)} lines, "
                                 f"{len(iters)} with N_ITER")
        for f in ("kernel.tmp", "kernel.opt"):
            if not os.path.isfile(f):
                raise AssertionError(f"train_nn: {f} was not written")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda",
                                   "run.conf"])
        n_pass = out.getvalue().count("[PASS]")
        if rc != 0 or outs is None or not np.all(np.isfinite(outs)):
            raise AssertionError(f"run_nn of the trained kernel: rc={rc}")
        if n_pass < 0.8 * TRAIN_FILES:
            raise AssertionError(f"run_nn of the trained kernel: PASS "
                                 f"{n_pass}/{TRAIN_FILES} < 80%")
    finally:
        os.chdir(cwd)
    n_ok = text.count("SUCCESS!")
    log(f"train_nn: {TRAIN_FILES} files, {sum(iters)} iterations, "
        f"SUCCESS {n_ok}, wall {wall:.2f} s; run_nn of kernel.opt: PASS "
        f"{n_pass}/{TRAIN_FILES}")
    return {"root": root, "iters": sum(iters), "wall_s": wall,
            "success": n_ok, "pass": n_pass}


def phase_train_time(e2e):
    """Device time of phase 9's epoch: the same conf, shuffle and samples
    through the kernel alone, between two CUDA events; then the same epoch
    through ``train_tile`` at tile 1, which must give the same bits."""
    import torch

    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.convergence import stats_record
    from hpnn_tpu_torch.ops.convergence_kernel import (train_epoch_cuda,
                                                       train_epoch_kernel)
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    nn, xs, ts = _epoch_inputs(e2e["root"])
    w = weights_to_torch(nn.kernel.weights, torch.float64, "cuda")
    x, t = _to_card(xs, torch.float64), _to_card(ts, torch.float64)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    wk, st = train_epoch_cuda(w, x, t, "ANN", False)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    plan = dict(train_epoch_kernel.plan)
    per_iter = _barriers_per_iter(w, st)
    iters = int(st.n_iter.sum())
    if iters != e2e["iters"]:
        raise AssertionError(f"train_nn epoch replay: {iters} iterations, "
                             f"train_nn printed {e2e['iters']}")
    wt, stt = train_tile(w, x, t, "ANN", False, tile=1)
    stt = stats_record(stt, torch.float64)
    if not (_bitwise(tuple(wk), tuple(wt))
            and _bitwise(tuple(st), tuple(stt))):
        raise AssertionError("train_nn epoch: train_tile at tile 1 is not "
                             "bit-identical to train_epoch")
    bound_ms, bound_by, flops_it = _train_bound(w, False, iters, "f64",
                                                xs.shape[0])
    log(f"train_nn epoch on the card: {ms:.1f} ms device time, {iters} "
        f"iterations = {ms * 1e3 / iters:.2f} us/iter "
        f"({iters / ms * 1e3:.0f} iterations/s) on {plan['blocks']} blocks, "
        f"{'resident' if plan['resident'] else 'staged'} plan, "
        f"{plan['smem_bytes']} shared bytes a block, {per_iter:g} grid "
        f"barriers an iteration; bound {bound_ms:.4f} ms "
        f"({bound_by}, {flops_it} flops an iteration); train_tile at tile 1 "
        "bit-identical")
    return {"ms": ms, "iters": iters, "us_per_iter": ms * 1e3 / iters,
            "bound_ms": bound_ms, "bound_by": bound_by, "plan": plan,
            "barriers_per_iter": per_iter}


# --- phase 10-12: the batched-tile epoch kernel ----------------------------

def _lockstep(n_iter, tile):
    """Lockstep iterations of a tiled epoch: each group runs as long as its
    slowest lane, so the sum over groups of the largest n_iter."""
    n_iter = np.asarray(n_iter, dtype=np.int64)
    return int(sum(n_iter[g:g + tile].max()
                   for g in range(0, n_iter.shape[0], tile)))


def _tile_bound(weights, momentum, lockstep, lane_iters, dtype, n_samples):
    """The least time of a tiled epoch: per lockstep iteration with S live
    lanes about 4SP + 2SP_hidden + 2P flops for BP (each lane's update
    product and sum and its forward multiply-add, its hidden deltas, then
    lr*g and the add once a weight; BPM adds 3P for the momentum), summed
    over this run's iterations (the sum of S over them is the
    lane-iterations), over the card's peak; against the bytes of the
    epoch's inputs and outputs read and written once.  Returns (bound_ms,
    bound_by, flops)."""
    p = _params(weights)
    p_hidden = p - weights[0].shape[0] * weights[0].shape[1]
    flops = ((4 * p + 2 * p_hidden) * lane_iters
             + (5 if momentum else 2) * p * lockstep)
    item = {"f32": 4, "bf16": 2, "f64": 8}[dtype]
    witem = 4 if dtype == "bf16" else item
    n_in, n_out = weights[0].shape[1], weights[-1].shape[0]
    nbytes = 2 * p * witem + n_samples * (n_in + n_out) * item \
        + n_samples * 5 * 8
    t_ops = flops / PEAK[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def phase_tile_vs_plain():
    import torch

    from hpnn_tpu_torch.ops.convergence_tile import train_epoch_tiled_plain
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    results = []
    for name, topo, kind, momentum, dtype, classes, n, tile, storage \
            in TILE_RUNS:
        w, x, t = _train_inputs(topo, dtype, classes, n)
        tag = (f"{name} {kind} {'BPM' if momentum else 'BP'} {dtype} tile "
               f"{tile}" + (f" storage {storage}" if storage else "")
               + f" ({n} samples)")
        kw = dict(tile=tile, storage=storage)
        # a launch of two lockstep iterations first, so that the timed one
        # excludes the lazy load of this entry point's code
        train_tile(w, x, t, kind, momentum, max_iter=1, **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wk, sk = train_tile(w, x, t, kind, momentum, **kw)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        plan = dict(train_tile.plan)
        per_lock = _tile_barriers(w, sk, tile)
        if name == "wide":
            # other launch plans on the same inputs: W_0's rows in place (or
            # on chip), the inputs in lane chunks with the head's vectors
            # off chip, and the block's scratch in its workspace slice; the
            # same bits
            for force in ({"resident": not plan["resident"]},
                          {"x_lanes": 2, "head": False},
                          {"scratch": False}):
                wo, so = train_tile(w, x, t, kind, momentum, _plan=force,
                                    **kw)
                torch.cuda.synchronize()
                if not (_bitwise(wk, wo) and _bitwise(sk, so)):
                    raise AssertionError(f"train_tile {tag}: the {plan} plan "
                                         f"and {train_tile.plan} differ")
        t0 = time.perf_counter()
        wp, sp = train_epoch_tiled_plain(w, x, t, kind, momentum, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        werr, dn = _check_train(tag, dtype, sk, sp, wk, wp,
                                name="train_tile", scaled=True)
        k, p = sk.cpu().numpy(), sp.cpu().numpy()
        lanes, lock = int(k[:, 2].sum()), _lockstep(k[:, 2], tile)
        p_lock = _lockstep(p[:, 2], tile)
        bound_ms, bound_by, _ = _tile_bound(w, momentum, lock, lanes, dtype,
                                            n)
        results.append({"run": tag, "dtype": dtype, "kind": kind,
                        "momentum": momentum, "samples": n, "tile": tile,
                        "storage": storage, "lane_iters": lanes,
                        "lockstep": lock, "plain_lockstep": p_lock,
                        "max_dn_iter": dn, "max_abs_err": werr, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "plan": plan,
                        "barriers_per_lockstep": per_lock,
                        "n_iter": k[:, 2].astype(int).tolist(),
                        "plain_n_iter": p[:, 2].astype(int).tolist()})
        log(f"train_tile {tag}: lockstep iterations {lock} (plain "
            f"{p_lock}), lane-iterations {lanes}, max |dn_iter| {dn:g}, "
            f"max |kernel - plain| weights {werr:.3e}; kernel {ms:.2f} ms "
            f"= {ms * 1e3 / lock:.2f} us/lockstep iteration on "
            f"{plan['blocks']} blocks x {plan['warps']} warps, "
            f"{'resident' if plan['resident'] else 'staged'} W_0, "
            f"{plan['smem_bytes']} shared bytes a block, {per_lock:g} grid "
            f"barriers a lockstep iteration"
            + (", three other plans bit-identical" if name == "wide"
               else "")
            + f"; plain {plain_ms * 1e3 / p_lock:.1f} us/lockstep "
            f"iteration, bound {bound_ms * 1e3 / lock:.4f} us/lockstep "
            f"iteration ({bound_by})")
    worst = {d: max((r["max_abs_err"] for r in results if r["dtype"] == d),
                    default=0.0) for d in _dtypes()}
    log("train_tile vs plain: all runs within limits; worst weight error "
        + ", ".join(f"{d} {e:.3e}" for d, e in worst.items()))
    results.append(_tile_wide_scratch())
    # an input layer whose one lane's input does not fit in a block's
    # shared memory: refused with a clear error, nothing launched
    w, x, t = _train_inputs(TOO_WIDE, "f64", (0, 1), 2)
    before = train_tile.launches
    try:
        train_tile(w, x, t, "ANN", False, tile=8)
    except ValueError as exc:
        refusal = str(exc)
    else:
        raise AssertionError(f"train_tile at {TOO_WIDE} f64 launched")
    if train_tile.launches != before:
        raise AssertionError("train_tile counted a refused launch")
    log(f"train_tile at {TOO_WIDE} f64 refused: {refusal}")
    return results


def _tile_wide_scratch():
    """A hidden layer whose block scratch does not fit in shared memory at
    tile 512 (``WIDE_SCRATCH``): the plan puts it in the workspace, and a
    few lockstep iterations of one group hold to the plain version."""
    import torch

    from hpnn_tpu_torch.ops.convergence_tile import train_epoch_tiled_plain
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    topo, tile, max_iter = WIDE_SCRATCH
    w, x, t = _train_inputs(topo, "f64", (0, 1), tile)
    kw = dict(tile=tile, max_iter=max_iter)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    wk, sk = train_tile(w, x, t, "ANN", False, **kw)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    plan = dict(train_tile.plan)
    if plan["scratch_on_chip"] or not plan["ws_bytes"]:
        raise AssertionError(f"train_tile {topo} tile {tile}: plan {plan} "
                             "keeps the block scratch on chip")
    per_lock = _tile_barriers(w, sk, tile)
    wp, sp = train_epoch_tiled_plain(w, x, t, "ANN", False, **kw)
    torch.cuda.synchronize()
    tag = f"{topo[0]}-{topo[1][0]}-{topo[2]} ANN BP f64 tile {tile}"
    werr, dn = _check_train(tag, "f64", sk, sp, wk, wp, name="train_tile")
    k = sk.cpu().numpy()
    lanes, lock = int(k[:, 2].sum()), _lockstep(k[:, 2], tile)
    log(f"train_tile {tag} ({tile} samples, max_iter {max_iter}): block "
        f"scratch in the workspace ({plan['ws_bytes']} bytes a block, "
        f"{plan['smem_bytes']} shared), {lock} lockstep iterations, "
        f"{lanes} lane-iterations, max |kernel - plain| weights "
        f"{werr:.3e}, {per_lock:g} grid barriers a lockstep iteration; "
        f"kernel {ms:.2f} ms (first launch of this entry)")
    return {"run": tag, "dtype": "f64", "kind": "ANN", "momentum": False,
            "samples": tile, "tile": tile, "storage": None,
            "lane_iters": lanes, "lockstep": lock, "max_dn_iter": dn,
            "max_abs_err": werr, "ms": ms, "plan": plan,
            "barriers_per_lockstep": per_lock}


def _tile_barriers(weights, stats, tile):
    """The grid barriers the last tile launch took a lockstep iteration,
    as its kernel counted them; raises unless that is 2L - 2 (L >= 2
    layers; 1 for L = 1) and its lockstep iterations are those of its
    stats rows."""
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    in_iters, _, lock = train_tile.syncs.tolist()
    n_iter = stats[:, 2].cpu().numpy() if hasattr(stats, "cpu") else \
        np.asarray(stats.n_iter)
    trained = _lockstep(n_iter[n_iter >= 0], tile)
    layers = len(weights)
    want = 2 * layers - 2 if layers > 1 else 1
    if lock != trained or in_iters != want * lock:
        raise AssertionError(f"train_tile: {in_iters} grid barriers in "
                             f"{lock} lockstep iterations ({trained} in the "
                             f"stats), not {want} a lockstep iteration")
    return in_iters / lock


def _bitwise(a, b):
    """True when two tensors, or two sequences of tensors, hold the same
    bits."""
    import torch

    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.contiguous().view(torch.uint8),
                        y.contiguous().view(torch.uint8))
        for x, y in zip(a, b))


def phase_tile_contracts():
    """The three bitwise contracts of the tile kernel on the card."""
    import torch

    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.convergence_tile import train_epoch_tiled
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    n_tile1 = 0
    for kind, dtypes in (("ANN", ("f64", "f32", "bf16")),
                         ("LNN", ("f64", "f32", "bf16")),
                         ("SNN", ("f32", "bf16"))):
        classes = (0, 1, 2, 3) if kind == "SNN" else (0, 1)
        for dtype in dtypes:
            for momentum in (False, True):
                w, x, t = _train_inputs(MNIST, dtype, classes, 8)
                w1, s1 = train_epoch_kernel(w, x, t, kind, momentum)
                w2, s2 = train_tile(w, x, t, kind, momentum, tile=1)
                torch.cuda.synchronize()
                if not (_bitwise(w1, w2) and _bitwise(s1, s2)):
                    raise AssertionError(
                        f"tile=1 {kind} {'BPM' if momentum else 'BP'} "
                        f"{dtype}: not bit-identical to train_epoch")
                n_tile1 += 1
    masked = []
    for kind, momentum, dtype in (("ANN", False, "f64"),
                                  ("SNN", True, "f32")):
        classes = (0, 1, 2, 3) if kind == "SNN" else (0, 1)
        w, x, t = _train_inputs(MNIST, dtype, classes, 6)
        w_pad, s_pad = train_tile(w, x, t, kind, momentum, tile=4)
        w_a, s_a = train_tile(w, x[:4].contiguous(), t[:4].contiguous(),
                              kind, momentum, tile=4)
        w_b, s_b = train_tile(w_a, x[4:].contiguous(), t[4:].contiguous(),
                              kind, momentum, tile=2)
        torch.cuda.synchronize()
        if not (_bitwise(w_pad, w_b)
                and _bitwise(s_pad, torch.cat([s_a, s_b]))):
            raise AssertionError(f"masked lanes {kind} {dtype}: the ragged "
                                 "tail differs from its rows alone")
        masked.append(f"{kind} {'BPM' if momentum else 'BP'} {dtype}")
    w, x, t = _train_inputs(MNIST, "f64", (0, 1), 19)
    before = train_tile.launches
    w1, s1 = train_epoch_tiled(w, x, t, "ANN", True, tile=8)
    one = train_tile.launches - before
    w2, s2 = train_epoch_tiled(w, x, t, "ANN", True, tile=8,
                               launch_groups=1)
    many = train_tile.launches - before - one
    if one != 1 or many != 3:
        raise AssertionError(f"group budget: {one} launch(es) unbudgeted, "
                             f"{many} at one group each")
    if not (_bitwise(w1, w2) and _bitwise(tuple(s1), tuple(s2))):
        raise AssertionError("group budget: launches of one group differ "
                             "from one launch")
    log(f"train_tile contracts: tile=1 bit-identical to train_epoch in "
        f"{n_tile1} runs; masked tail lanes inert ({', '.join(masked)}); "
        f"3 launches of one group bit-identical to 1 launch "
        f"({int(s1.n_iter.sum())} lane-iterations)")
    return {"tile1_runs": n_tile1, "masked": masked, "budget_launches": many}


def phase_train_nn_tile(e2e):
    """train_nn --tile 32 on phase 9's files and conf, then run_nn of its
    kernel.opt."""
    from hpnn_tpu_torch import cli

    cwd = os.getcwd()
    os.chdir(e2e["root"])
    try:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.train_nn_main(["-v", "-v", "--device", "cuda",
                                    "--tile", str(TRAIN_TILE), "nn.conf"])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        iters = [int(m) for m in re.findall(r"N_ITER=\s*(\d+)", text)]
        if rc != 0 or len(iters) != TRAIN_FILES:
            raise AssertionError(f"train_nn --tile: rc={rc}, {len(iters)} "
                                 "lines with N_ITER")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda",
                                   "run.conf"])
        n_pass = out.getvalue().count("[PASS]")
        if rc != 0 or outs is None or not np.all(np.isfinite(outs)):
            raise AssertionError(f"run_nn of the tile-trained kernel: rc={rc}")
        if n_pass < 0.8 * TRAIN_FILES:
            raise AssertionError(f"run_nn of the tile-trained kernel: PASS "
                                 f"{n_pass}/{TRAIN_FILES} < 80%")
    finally:
        os.chdir(cwd)
    n_ok = text.count("SUCCESS!")
    log(f"train_nn --tile {TRAIN_TILE}: {TRAIN_FILES} files, {sum(iters)} "
        f"lane-iterations, SUCCESS {n_ok}, wall {wall:.2f} s; run_nn of "
        f"kernel.opt: PASS {n_pass}/{TRAIN_FILES}")
    return {"iters": sum(iters), "wall_s": wall, "success": n_ok,
            "pass": n_pass}


def _epoch_inputs(root):
    """Phase 9's conf, shuffle and samples, as the train path loads them."""
    from hpnn_tpu_torch.api import configure, shuffle_order
    from hpnn_tpu_torch.io.corpus import load_ordered
    from hpnn_tpu_torch.io.samples import list_sample_dir

    cwd = os.getcwd()
    os.chdir(root)
    try:
        nn = configure("nn.conf")
        names = list_sample_dir(nn.conf.samples)
        _, xs, ts = load_ordered(nn.conf.samples, names,
                                 shuffle_order(nn.conf, len(names)),
                                 "TRAINING", 784, 10)
    finally:
        os.chdir(cwd)
    return nn, xs, ts


def _tile_epoch(w, x, t, tile):
    """One launch of the tile kernel over the whole epoch, behind a GPU
    spin; returns (device ms between CUDA events, stats)."""
    import torch

    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    _, st = train_tile(w, x, t, "ANN", False, tile=tile)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), st


def phase_tile_time(e2e, tile_e2e, epoch):
    """Device time of phase 12's epoch: the same conf, shuffle and samples
    through one launch of the kernel, twice (the first and the second
    launch), with the grid barriers the kernel counted."""
    import torch

    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile

    nn, xs, ts = _epoch_inputs(e2e["root"])
    w = weights_to_torch(nn.kernel.weights, torch.float64, "cuda")
    x, t = _to_card(xs, torch.float64), _to_card(ts, torch.float64)
    first_ms, st = _tile_epoch(w, x, t, TRAIN_TILE)
    ms, st2 = _tile_epoch(w, x, t, TRAIN_TILE)
    if not _bitwise(st, st2):
        raise AssertionError("train_nn --tile epoch: two launches differ")
    plan = dict(train_tile.plan)
    per_lock = _tile_barriers(w, st, TRAIN_TILE)
    n_iter = st[:, 2].cpu().numpy()
    lanes, lock = int(n_iter.sum()), _lockstep(n_iter, TRAIN_TILE)
    if lanes != tile_e2e["iters"]:
        raise AssertionError(f"train_nn --tile epoch replay: {lanes} "
                             f"lane-iterations, train_nn printed "
                             f"{tile_e2e['iters']}")
    bound_ms, bound_by, flops = _tile_bound(w, False, lock, lanes, "f64",
                                            xs.shape[0])
    rate = lanes / ms * 1e3
    b1_rate = epoch["iters"] / epoch["ms"] * 1e3
    log(f"train_nn --tile {TRAIN_TILE} epoch on the card: {ms:.1f} ms "
        f"device time (first launch {first_ms:.1f} ms), {lock} lockstep "
        f"iterations ({ms * 1e3 / lock:.2f} us each), {lanes} "
        f"lane-iterations ({rate:.0f} a second; the per-sample kernel on "
        f"the same files: {b1_rate:.0f} iterations a second, "
        f"{rate / b1_rate:.2f}x) on {plan['blocks']} blocks x "
        f"{plan['warps']} warps, {'resident' if plan['resident'] else 'staged'}"
        f" W_0, {plan['smem_bytes']} shared bytes a block, {per_lock:g} grid "
        f"barriers a lockstep iteration; bound "
        f"{bound_ms * 1e3 / lock:.4f} us/lockstep iteration ({bound_by}, "
        f"{flops / lock:.0f} flops a lockstep iteration)")
    return {"ms": ms, "first_ms": first_ms, "lockstep": lock,
            "lane_iters": lanes, "us_per_lockstep": ms * 1e3 / lock,
            "lane_iters_per_s": rate, "b1_iters_per_s": b1_rate,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_us_per_lockstep": bound_ms * 1e3 / lock, "plan": plan,
            "barriers_per_lockstep": per_lock}


def phase_tile_auto(e2e, tuned, tile_epoch):
    """Phase 12's epoch, on the same files, at each tile ``--tile auto``
    tries (tile 32's from ``tile_epoch``, the others one launch each): the
    epoch's device time and lane-iterations a second, so the probe's
    choice is held to what wins on a real epoch."""
    import torch

    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.autotune import _DEFAULT_TILES

    nn, xs, ts = _epoch_inputs(e2e["root"])
    w = weights_to_torch(nn.kernel.weights, torch.float64, "cuda")
    x, t = _to_card(xs, torch.float64), _to_card(ts, torch.float64)
    epochs = {}
    for tile in _DEFAULT_TILES:
        if tile == TRAIN_TILE:
            epochs[tile] = {k: tile_epoch[k] for k in (
                "ms", "lockstep", "lane_iters", "us_per_lockstep",
                "lane_iters_per_s")}
            continue
        ms, st = _tile_epoch(w, x, t, tile)
        n_iter = st[:, 2].cpu().numpy()
        lanes, lock = int(n_iter.sum()), _lockstep(n_iter, tile)
        epochs[tile] = {"ms": ms, "lockstep": lock, "lane_iters": lanes,
                        "us_per_lockstep": ms * 1e3 / lock,
                        "lane_iters_per_s": lanes / ms * 1e3}
    chosen = int(tuned["tile"])
    fastest = min(epochs, key=lambda k: epochs[k]["ms"])
    ratio = epochs[chosen]["ms"] / epochs[fastest]["ms"]
    log("train_nn epoch by tile, on phase 12's files: " + "; ".join(
        f"tile {k}: {e['ms']:.1f} ms, {e['lockstep']} lockstep iterations "
        f"({e['us_per_lockstep']:.2f} us each), {e['lane_iters']} "
        f"lane-iterations ({e['lane_iters_per_s']:.0f} a second)"
        for k, e in epochs.items())
        + f". The autotuner chose tile {chosen}; the fastest epoch is tile "
        f"{fastest}" + (" (the probe's choice wins)" if chosen == fastest
                        else f" ({ratio:.2f}x faster than the probe's "
                             "choice)"))
    return {"tile": chosen, "fastest_tile": fastest,
            "by_tile": {str(k): e for k, e in epochs.items()},
            **{k: epochs[chosen][k] for k in ("ms", "lockstep", "lane_iters",
                                              "us_per_lockstep",
                                              "lane_iters_per_s")}}


def phase_autotune(tmp):
    """``--tile auto`` on the card: the autotuner times its candidates at
    phase 12's width and type (MNIST ANN BP f64), with its cache in a fresh
    directory; a second call must be a cache hit that measures nothing."""
    import torch

    from hpnn_tpu_torch.ops import autotune

    shapes = ((MNIST[1][0], MNIST[0]), (MNIST[2], MNIST[1][0]))
    saved = {k: os.environ.pop(k, None)
             for k in ("HPNN_AUTOTUNE_CACHE", "HPNN_NO_AUTOTUNE")}
    os.environ["HPNN_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune")
    try:
        autotune.clear_memo()
        t0 = time.perf_counter()
        dec = autotune.decide_tile(shapes, torch.float64, "ANN", False,
                                   device="cuda")
        wall = time.perf_counter() - t0
        autotune.clear_memo()   # a fresh process over the same cache file
        again = autotune.decide_tile(shapes, torch.float64, "ANN", False,
                                     device="cuda")
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    if dec["source"] != "measured" or again["source"] != "cache" \
            or (again["tile"], again["storage"]) != (dec["tile"],
                                                     dec["storage"]):
        raise AssertionError(f"autotune: {dec} then {again}")
    log(f"autotune (--tile auto) at MNIST ANN BP f64: tile {dec['tile']}, "
        f"storage {dec['storage']}, route {dec['route']}, measured in "
        f"{wall:.2f} s (lane-iterations a second: "
        + ", ".join(f"{k} {v:.0f}" for k, v in dec["cells"].items())
        + "); the second call was a cache hit")
    return {"tile": dec["tile"], "storage": dec["storage"],
            "route": dec["route"], "cells": dec["cells"], "wall_s": wall}


# --- phase 13: fused_bpm_update --------------------------------------------

def _bpm_arrays(rng, n, m):
    """w, dw, d, h of one seeded (n, m) update, float64 numpy."""
    return (rng.uniform(-1, 1, (n, m)) / np.sqrt(m),
            rng.uniform(-1e-3, 1e-3, (n, m)), rng.uniform(-1, 1, n),
            rng.uniform(0, 1, m))


def _bpm_sets(first, n, m, item):
    """``first`` and copies of it on the card, as many as make the inputs
    of consecutive calls span BPM_COLD_BYTES (twice the L2): a call finds
    none of its inputs in L2."""
    count = max(2, -(-BPM_COLD_BYTES // ((2 * n * m + n + m) * item)))
    return [first] + [tuple(v.clone() for v in first)
                      for _ in range(count - 1)]


def _rotating_ms(calls, runs=5):
    """Device time of one call when consecutive calls take consecutive
    entries of ``calls`` (cold caches): the median over ``runs`` of a
    back-to-back run of up to BPM_COLD_RUN launches between two CUDA
    events, behind a GPU spin long enough for the host to queue them."""
    import torch

    launches = min(max(len(calls), 10), BPM_COLD_RUN)
    for call in calls[:3]:
        call()
    torch.cuda.synchronize()
    times, k = [], 0
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES + launches * SPIN_PER_LAUNCH)
        start.record()
        for _ in range(launches):
            calls[k % len(calls)]()
            k += 1
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _bpm_bound_ms(n, m, item):
    """The byte bound: w, dw, d, h read and w', dw' written once."""
    return (4 * n * m + n + m) * item / HBM_BYTES_PER_S * 1e3


def _bpm_cell(n, m, dname, arrays, lr, alpha, floor_ms, timed=True):
    """One ``fused_bpm_update`` cell: bit for bit against the plain version
    on the card (inputs untouched), then, when ``timed``, its warm time
    (back-to-back calls on the same buffers), cold time (calls rotating
    over inputs twice the L2) and the plain version's, beside the empty
    kernel's floor and the byte bound."""
    import torch

    from hpnn_tpu_torch.ops.kernels import (fused_bpm_update,
                                            fused_bpm_update_plain)

    dt = _dtypes()[dname]
    item = {"f64": 8, "f32": 4, "bf16": 2}[dname]
    first = tuple(_to_card(a, dt) for a in arrays)
    before = tuple(v.clone() for v in first)
    got = fused_bpm_update(*first, lr, alpha)
    plan = fused_bpm_update.plan
    want = fused_bpm_update_plain(*first, lr, alpha)
    torch.cuda.synchronize()
    if not (_bitwise(got, want) and _bitwise(first, before)):
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
        raise AssertionError(f"fused_bpm_update {n}x{m} {dname}: "
                             f"not bit-identical to the plain "
                             f"version (max diff {err:.3e}), or "
                             "an input changed")
    del got, want, before
    cell = {"shape": f"{n}x{m}", "dtype": dname, "max_abs_err": 0.0,
            "plan": plan._asdict()}
    if not timed:
        log(f"fused_bpm_update {n}x{m} {dname}: bit-identical to plain; "
            f"plan {tuple(plan)}")
        return cell
    ms = _device_ms(lambda: fused_bpm_update(*first, lr, alpha))
    plain_ms = _device_ms(lambda: fused_bpm_update_plain(*first, lr, alpha))
    sets = _bpm_sets(first, n, m, item)
    cold_ms = _rotating_ms(
        [lambda v=v: fused_bpm_update(*v, lr, alpha) for v in sets])
    del sets
    bound_ms = _bpm_bound_ms(n, m, item)
    cell.update({"ms": ms, "cold_ms": cold_ms, "floor_ms": floor_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": "bytes"})
    log(f"fused_bpm_update {n}x{m} {dname}: bit-identical to plain; "
        f"warm ms={ms:.5f} cold ms={cold_ms:.5f} "
        f"floor ms={floor_ms:.5f} plain_ms={plain_ms:.5f} "
        f"bound_ms={bound_ms:.5f} (bytes, {bound_ms / cold_ms:.0%} "
        f"of it cold); plan {tuple(plan)}")
    return cell


def phase_bpm():
    """``fused_bpm_update`` against its plain version, bit for bit, at every
    shape in float64 and float32 (phase 28 adds bfloat16); its warm time,
    cold time, the empty kernel's floor in the same loop, and the byte
    bound."""
    from hpnn_tpu_torch.ops.kernels import empty_launch

    rng = np.random.default_rng(13)
    floor_ms = _device_ms(lambda: empty_launch("cuda"))
    cells = []
    for n, m in BPM_SHAPES:
        arrays = _bpm_arrays(rng, n, m)
        for dname in ("f64", "f32"):
            cells.append(_bpm_cell(n, m, dname, arrays, BPM_LR, BPM_ALPHA,
                                   floor_ms))
    return cells


# --- phase 16: train_nn --epochs -------------------------------------------

def _train_epochs(root, extra, env=None):
    """``train_nn -v -v --epochs 3`` (plus ``extra``) on the card in
    ``root``, with the launch counts set to 0 just before it; returns the
    run's stream, kernel.opt, wall time, launches and EPOCH_METRICS."""
    from hpnn_tpu_torch import api, cli
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile
    from hpnn_tpu_torch.ops.kernels import fused_bpm_update, fused_linear_act

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    cwd = os.getcwd()
    os.chdir(root)
    try:
        api.reset_epoch_metrics()
        for fn in (train_epoch_kernel, train_tile, fused_linear_act,
                   fused_bpm_update):
            fn.launches = 0
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.train_nn_main(["-v", "-v", "--device", "cuda",
                                    "--epochs", str(EPOCHS), *extra,
                                    "nn.conf"])
        wall = time.perf_counter() - t0
        launches = {"train_epoch": train_epoch_kernel.launches,
                    "train_tile": train_tile.launches,
                    "fused_linear_act": fused_linear_act.launches,
                    "fused_bpm_update": fused_bpm_update.launches}
        with open("kernel.opt") as fp:
            opt = fp.read()
        with open("kernel.tmp") as fp:
            tmp = fp.read()
    finally:
        os.chdir(cwd)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise AssertionError(f"train_nn --epochs {EPOCHS} {extra}: rc={rc}"
                             f"\n{err.getvalue()[-2000:]}")
    return {"out": out.getvalue(), "err": err.getvalue(), "opt": opt,
            "tmp": tmp,
            "wall_s": wall, "launches": launches,
            "metrics": dict(api.EPOCH_METRICS)}


def phase_train_epochs(e2e):
    """``train_nn --epochs 3`` on phase 9's files and conf, per sample and
    at ``--tile 32``: the epoch kernel launched once an epoch, one int32
    permutation uploaded an epoch, the stream and kernel.opt byte-identical
    to the ``HPNN_NO_EPOCH_PIPELINE=1`` route on the card, each epoch's
    device time beside the run's wall time, and ``run_nn`` of kernel.opt
    at 80% PASS or more."""
    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    runs = {}
    for tag, extra, kernel in (("per-sample", (), "train_epoch"),
                               (f"tile {TRAIN_TILE}",
                                ("--tile", str(TRAIN_TILE)), "train_tile")):
        restage = _train_epochs(e2e["root"], extra,
                                {"HPNN_NO_EPOCH_PIPELINE": "1"})
        res = _train_epochs(e2e["root"], extra)   # the path: counts from 0
        met = res["metrics"]
        if met["mode"] != "resident" or met["epochs"] != EPOCHS \
                or met["h2d_bytes"] != EPOCHS * TRAIN_FILES * 4:
            raise AssertionError(f"train_nn --epochs {EPOCHS} ({tag}): "
                                 f"EPOCH_METRICS {met}")
        if len(met["device_ms"]) != EPOCHS:
            raise AssertionError(f"train_nn --epochs {EPOCHS} ({tag}): "
                                 f"{len(met['device_ms'])} epoch times")
        n_iter = res["out"].count("N_ITER=")
        if n_iter != EPOCHS * TRAIN_FILES:
            raise AssertionError(f"train_nn --epochs {EPOCHS} ({tag}): "
                                 f"{n_iter} lines with N_ITER")
        if restage["metrics"]["mode"] != "restage":
            raise AssertionError(f"HPNN_NO_EPOCH_PIPELINE=1 ({tag}): "
                                 f"{restage['metrics']}")
        for part in ("out", "err", "opt"):
            if res[part] != restage[part]:
                raise AssertionError(f"train_nn --epochs {EPOCHS} ({tag}): "
                                     f"the resident route's {part} differs "
                                     "from the restaging route's")
        cwd = os.getcwd()
        os.chdir(e2e["root"])
        try:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda",
                                       "run.conf"])
        finally:
            os.chdir(cwd)
        n_pass = out.getvalue().count("[PASS]")
        if rc != 0 or outs is None or not np.all(np.isfinite(outs)) \
                or n_pass < 0.8 * TRAIN_FILES:
            raise AssertionError(f"run_nn after --epochs ({tag}): rc={rc}, "
                                 f"PASS {n_pass}/{TRAIN_FILES}")
        # the path's counts, read after its run_nn
        got = dict(res["launches"], fused_linear_act=fused_linear_act.launches)
        other = "train_tile" if kernel == "train_epoch" else "train_epoch"
        if got[kernel] != EPOCHS or got[other] != 0 \
                or got["fused_linear_act"] <= 0:
            raise AssertionError(f"train_nn --epochs {EPOCHS} ({tag}) + "
                                 f"run_nn: launches {got}, want {kernel} "
                                 f"{EPOCHS}, {other} 0, fused_linear_act > 0")
        iters = [sum(int(v) for v in re.findall(r"N_ITER=\s*(\d+)", block))
                 for block in res["out"].split("EPOCH ")[1:]]
        runs[tag] = {"launches": got, "wall_s": res["wall_s"],
                     "opt_sha256": hashlib.sha256(
                         res["opt"].encode()).hexdigest(),
                     "out_sha256": hashlib.sha256(
                         res["out"].encode()).hexdigest(),
                     "tmp_sha256": hashlib.sha256(
                         res["tmp"].encode()).hexdigest(),
                     "restage_wall_s": restage["wall_s"],
                     "epoch_device_ms": met["device_ms"],
                     "epoch_iters": iters,
                     "h2d_bytes": met["h2d_bytes"],
                     "setup_h2d_bytes": met["setup_h2d_bytes"],
                     "restage_h2d_bytes": restage["metrics"]["h2d_bytes"],
                     "stage_s": met["stage_s"], "shuffle_s": met["shuffle_s"],
                     "pass": n_pass}
        log(f"train_nn --epochs {EPOCHS} ({tag}) + run_nn: {kernel} "
            f"launched {got[kernel]} times, fused_linear_act "
            f"{got['fused_linear_act']}; epochs' device time "
            + ", ".join(f"{ms:.1f}" for ms in met["device_ms"])
            + f" ms ({', '.join(map(str, iters))} iterations); wall "
            f"{res['wall_s']:.2f} s (restaging route {restage['wall_s']:.2f} "
            f"s); H2D {met['h2d_bytes']} bytes over the epochs and "
            f"{met['setup_h2d_bytes']} once (restaging "
            f"{restage['metrics']['h2d_bytes']}); stream and kernel.opt "
            f"byte-identical to the restaging route; run_nn PASS "
            f"{n_pass}/{TRAIN_FILES}")
    return runs


# --- phase 17: train_nn --resume -------------------------------------------

def _ckpt_train(cwd, argv, env=None):
    """``train_nn -v -v --device cuda`` (plus ``argv``) in ``cwd`` with
    every launch count set to 0 just before it; returns the run's stream,
    kernel.opt's sha256, wall time, launches and EPOCH_METRICS."""
    from hpnn_tpu_torch import api, cli
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile
    from hpnn_tpu_torch.ops.kernels import fused_bpm_update, fused_linear_act

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    here = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        api.reset_epoch_metrics()
        for fn in (train_epoch_kernel, train_tile, fused_linear_act,
                   fused_bpm_update):
            fn.launches = 0
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.train_nn_main(["-v", "-v", "--device", "cuda", *argv])
        wall = time.perf_counter() - t0
        launches = {"train_epoch": train_epoch_kernel.launches,
                    "train_tile": train_tile.launches,
                    "fused_linear_act": fused_linear_act.launches,
                    "fused_bpm_update": fused_bpm_update.launches}
        with open("kernel.opt", "rb") as fp:
            sha = hashlib.sha256(fp.read()).hexdigest()
    finally:
        os.chdir(here)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise AssertionError(f"train_nn {argv} in {cwd}: rc={rc}\n"
                             f"{err.getvalue()[-2000:]}")
    return {"out": out.getvalue(), "err": err.getvalue(), "sha": sha,
            "wall_s": wall, "launches": launches,
            "metrics": dict(api.EPOCH_METRICS)}


def _ckpt_run_nn(cwd, argv):
    """``run_nn -v -v --device cuda`` (plus ``argv``) in ``cwd``: (rc,
    outputs, stdout)."""
    from hpnn_tpu_torch import cli

    here = os.getcwd()
    os.chdir(cwd)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda", *argv])
    finally:
        os.chdir(here)
    return rc, outs, out.getvalue()


def _ckpt_dir_check(ck, rep, tag, generation, blobs):
    """Three bundles, each passing ``verify_bundle``; the manifest at
    ``generation`` with ``ep00000003`` latest; ``blobs`` replicas in
    ``rep``.  Returns each bundle's bytes."""
    from hpnn_tpu_torch import ckpt
    from hpnn_tpu_torch.ckpt.replicate import read_scope_index, scope_for

    tags = sorted(t for t in os.listdir(ck) if t.startswith("ep"))
    want = [ckpt.snapshot_tag(e) for e in range(1, EPOCHS + 1)]
    if tags != want:
        raise AssertionError(f"{tag}: bundles {tags}, want {want}")
    sizes = {}
    for t in tags:
        ok, reason = ckpt.verify_bundle(os.path.join(ck, t))
        if not ok:
            raise AssertionError(f"{tag}: {t} fails verify_bundle: {reason}")
        sizes[t] = {f: os.path.getsize(os.path.join(ck, t, f))
                    for f in (ckpt.SNAPSHOT_KERNEL, ckpt.SNAPSHOT_STATE,
                              ckpt.SNAPSHOT_META)}
    man = ckpt.read_manifest(ck)
    if man["generation"] != generation or man["latest"] != want[-1]:
        raise AssertionError(f"{tag}: manifest generation "
                             f"{man['generation']} latest {man['latest']}, "
                             f"want {generation} and {want[-1]}")
    index = read_scope_index(os.path.join(rep, scope_for(ck)))
    n_blobs = len([f for f in os.listdir(os.path.join(rep, scope_for(ck)))
                   if f.endswith(".bundle")])
    if len(index) != blobs or n_blobs != blobs:
        raise AssertionError(f"{tag}: {n_blobs} replica blobs, "
                             f"{len(index)} indexed, want {blobs}")
    return sizes


def _flip_digit(path):
    """Change the last weight digit of a kernel file (it still loads)."""
    with open(path, "rb") as fp:
        data = bytearray(fp.read())
    i = max(i for i, c in enumerate(data) if chr(c).isdigit())
    data[i] = ord("1") if data[i] != ord("1") else ord("2")
    with open(path, "wb") as fp:
        fp.write(bytes(data))


def phase_ckpt_resume(e2e, epochs_runs):
    """``train_nn --resume`` on phase 9's files and conf, per sample and at
    ``--tile 32``: (1) ``--epochs 3 --ckpt-every 1 --ckpt-dir ck
    --replicate-to rep``; (2) the same killed at epoch 1
    (``HPNN_CKPT_KILL_AT_EPOCH``), resumed with ``--resume`` in the same
    directory; (3) its ``ck`` deleted and resumed again with
    ``--replicate-to rep``, which restores epoch 1 from the replica.
    kernel.opt of every run equals phase 16's checkpointing-off run's;
    each resumed stream from EPOCH 2 on equals run 1's, the killed one is
    its prefix; the epoch kernel launched 3 times in run 1, 1 + 2 across
    the kill and the resume, 2 in the replica resume, always resident;
    every bundle verified, the manifests and replicas counted; then
    ``run_nn --ckpt-dir ck`` of the resumed kernel.opt (>= 80% PASS, no
    fingerprint warning) and of the same file with one digit changed (the
    warning, naming both paths).  Records the wall times beside phase 16's
    and the bundles' bytes."""
    from hpnn_tpu_torch import ckpt

    src = e2e["root"]
    out = {}
    for tag, extra, kernel in (("per-sample", (), "train_epoch"),
                               (f"tile {TRAIN_TILE}",
                                ("--tile", str(TRAIN_TILE)), "train_tile")):
        other = "train_tile" if kernel == "train_epoch" else "train_epoch"
        root = os.path.join(src, "ckpt-" + tag.replace(" ", ""))
        os.makedirs(root)
        conf = os.path.join(root, "nn.conf")
        with open(os.path.join(src, "nn.conf")) as fp:
            text = fp.read().replace("./samples", os.path.join(src, "samples"))
        text = text.replace("./tests", os.path.join(src, "tests"))
        with open(conf, "w") as fp:
            fp.write(text)
        run_conf = os.path.join(root, "run.conf")
        with open(run_conf, "w") as fp:
            fp.write(text.replace("[init] generate", "[init] kernel.opt"))
        full_dir, part_dir = os.path.join(root, "full"), \
            os.path.join(root, "part")
        argv = ["--epochs", str(EPOCHS), "--ckpt-every", "1", "--ckpt-dir",
                "ck", "--replicate-to", "rep", *extra, conf]
        resume = ["--epochs", str(EPOCHS), "--resume", "--ckpt-dir", "ck",
                  *extra, conf]
        full = _ckpt_train(full_dir, argv)
        kill = _ckpt_train(part_dir, argv,
                           {"HPNN_CKPT_KILL_AT_EPOCH": str(KILL_AT)})
        res = _ckpt_train(part_dir, resume)
        shutil.rmtree(os.path.join(part_dir, "ck"))
        rep_res = _ckpt_train(part_dir, [*resume[:-1], "--replicate-to",
                                         "rep", conf])
        # (a) one trajectory, with or without snapshots and a kill
        want = epochs_runs[tag]["opt_sha256"]
        for name, run in (("run 1", full), ("the resume", res),
                          ("the replica resume", rep_res)):
            if run["sha"] != want:
                raise AssertionError(f"phase 17 ({tag}): {name}'s kernel.opt "
                                     "differs from phase 16's run's")
        # (b), (c) the streams
        mark = f"NN: EPOCH {2:8d}/{EPOCHS:8d}\n"
        tail = full["out"][full["out"].index(mark):]
        for name, run in (("the resume", res),
                          ("the replica resume", rep_res)):
            if mark not in run["out"] or \
                    run["out"][run["out"].index(mark):] != tail:
                raise AssertionError(f"phase 17 ({tag}): {name}'s stream "
                                     "from EPOCH 2 differs from run 1's")
        stop = "NN: CKPT: interrupted at epoch"
        if stop not in kill["out"] or not full["out"].startswith(
                kill["out"][:kill["out"].index(stop)]):
            raise AssertionError(f"phase 17 ({tag}): the killed run's stream "
                                 "is not a prefix of run 1's")
        # (d) launches and the route
        counts = [(name, run["launches"][kernel], n)
                  for name, run, n in (("run 1", full, EPOCHS),
                                       ("the killed run", kill, KILL_AT),
                                       ("the resume", res, EPOCHS - KILL_AT),
                                       ("the replica resume", rep_res,
                                        EPOCHS - KILL_AT))]
        for name, got, n in counts:
            if got != n:
                raise AssertionError(f"phase 17 ({tag}): {kernel} launched "
                                     f"{got} times in {name}, want {n}")
        for name, run in (("run 1", full), ("the killed run", kill),
                          ("the resume", res), ("the replica resume",
                                                rep_res)):
            if run["launches"][other] != 0 \
                    or run["metrics"]["mode"] != "resident":
                raise AssertionError(f"phase 17 ({tag}): {name}: launches "
                                     f"{run['launches']}, EPOCH_METRICS "
                                     f"{run['metrics']}")
        # (e) the checkpoint dirs: run 1's three snapshots and its final
        # stamp; the replica resume's restored epoch 1, 2 and 3 and stamp
        sizes = _ckpt_dir_check(os.path.join(full_dir, "ck"),
                                os.path.join(full_dir, "rep"),
                                f"{tag} run 1", EPOCHS + 1, EPOCHS)
        _ckpt_dir_check(os.path.join(part_dir, "ck"),
                        os.path.join(part_dir, "rep"),
                        f"{tag} replica resume", EPOCHS, EPOCHS)
        man = ckpt.read_manifest(os.path.join(part_dir, "ck"))
        if man["final_fingerprint"] != "sha256:" + rep_res["sha"]:
            raise AssertionError(f"phase 17 ({tag}): the manifest's final "
                                 "fingerprint is not kernel.opt's")
        # (f) run_nn's staleness guard, on the resumed kernel.opt
        rc, outs, text = _ckpt_run_nn(part_dir, ["--ckpt-dir", "ck",
                                                 run_conf])
        n_pass = text.count("[PASS]")
        if rc != 0 or outs is None or not np.all(np.isfinite(outs)) \
                or n_pass < 0.8 * TRAIN_FILES or "fingerprint" in text:
            raise AssertionError(f"phase 17 ({tag}): run_nn --ckpt-dir ck: "
                                 f"rc={rc}, PASS {n_pass}/{TRAIN_FILES}, "
                                 f"warned: {'fingerprint' in text}")
        kpath = os.path.join(part_dir, "kernel.opt")
        shutil.copyfile(kpath, kpath + ".orig")
        _flip_digit(kpath)
        rc, _, text = _ckpt_run_nn(part_dir, ["--ckpt-dir", "ck", run_conf])
        os.replace(kpath + ".orig", kpath)
        warn = (f"NN(WARN): kernel fingerprint mismatch: {kpath} does not "
                f"match the manifest {os.path.join(part_dir, 'ck')}"
                "/manifest.json (stale or modified weights?)\n")
        if rc != 0 or warn not in text:
            raise AssertionError(f"phase 17 ({tag}): run_nn of a changed "
                                 f"kernel.opt: rc={rc}, no warning")
        off = epochs_runs[tag]["wall_s"]
        bundle = sum(sizes["ep00000001"].values())
        out[tag] = {
            "launches": {"run": full["launches"][kernel],
                         "killed": kill["launches"][kernel],
                         "resumed": res["launches"][kernel],
                         "replica_resumed": rep_res["launches"][kernel]},
            "wall_s": {"run": full["wall_s"], "no_ckpt": off,
                       "killed": kill["wall_s"], "resumed": res["wall_s"],
                       "replica_resumed": rep_res["wall_s"]},
            "snapshot_cost_s": (full["wall_s"] - off) / EPOCHS,
            "epoch_device_ms": full["metrics"]["device_ms"],
            "bundle_bytes": sizes, "pass": n_pass,
            "fused_bpm_update": sum(r["launches"]["fused_bpm_update"]
                                    for r in (full, kill, res, rep_res))}
        log(f"train_nn --resume ({tag}): kernel.opt of run 1, the resume and "
            f"the replica resume identical to phase 16's; {kernel} launched "
            f"{full['launches'][kernel]}, {kill['launches'][kernel]} + "
            f"{res['launches'][kernel]}, {rep_res['launches'][kernel]}; wall "
            f"{full['wall_s']:.3f} s with a snapshot an epoch against "
            f"{off:.3f} s without (phase 16), "
            f"{(full['wall_s'] - off) / EPOCHS * 1e3:.1f} ms a snapshot; "
            f"killed run {kill['wall_s']:.3f} s, resume {res['wall_s']:.3f} "
            f"s, replica resume {rep_res['wall_s']:.3f} s; a bundle "
            f"{bundle} bytes ({', '.join(f'{k} {v}' for k, v in sizes['ep00000001'].items())}); "
            f"run_nn PASS {n_pass}/{TRAIN_FILES}, the fingerprint warning "
            "only on the changed kernel")
    return out


# --- phase 18: the corpus pipeline ------------------------------------------

# load mode -> (env, the mode load_ordered reports, native_io)
CORPUS_MODES = (("off", {"HPNN_NO_CORPUS_CACHE": "1", "HPNN_NO_PARALLEL_IO": "1",
                         "HPNN_NO_NATIVE_IO": "1"}, "serial", "off"),
                ("cold", {}, "parallel", "on"),
                ("warm", {}, "pack", "on"))


@contextlib.contextmanager
def _corpus_env(env):
    """``env`` set for the block (the native loader probed anew on entry
    and exit, as HPNN_NO_NATIVE_IO may change)."""
    from hpnn_tpu_torch.io import samples

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    samples._native_lib = None
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        samples._native_lib = None


def _corpus_run_nn(tag, topology, scale, seed, dtype, tmp,
                   modes=("off", "cold", "warm")):
    """``run_nn -v -v`` of a generated ANN kernel on a fresh 4096-file dir
    in each load mode of ``modes``: byte-identical streams, bit-identical
    outputs, and ``fused_linear_act`` launched each time (its count set to
    0 just before each run, read just after)."""
    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.io import corpus
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import generate_kernel
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    n_in, hid, n_out = topology
    tests = os.path.join(tmp, f"corpus_{tag}")
    t0 = time.perf_counter()
    _write_corpus(tests, n_in, n_out, scale, seed)
    write_s = time.perf_counter() - t0
    kern, _ = generate_kernel(seed, n_in, hid, n_out)
    kpath = os.path.join(tmp, f"corpus_{tag}_kernel.opt")
    dump_kernel_to_path(kern, kpath)
    conf = os.path.join(tmp, f"corpus_{tag}.conf")
    with open(conf, "w") as fp:
        fp.write(f"[name] corpus_{tag}\n[type] ANN\n[init] {kpath}\n"
                 f"[seed] 10958\n[input] {n_in}\n"
                 f"[hidden] {' '.join(map(str, hid))}\n[output] {n_out}\n"
                 f"[train] BP\n[test_dir] {tests}\n[dtype] {dtype}\n")
    if os.path.exists(corpus.pack_path(tests)):
        raise AssertionError(f"{tests}: a pack exists before the cold run")
    runs = {}
    for mode, env, want, native in CORPUS_MODES:
        if mode not in modes:
            continue
        with _corpus_env(env):
            fused_linear_act.launches = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda", conf])
            wall = time.perf_counter() - t0
            launched = fused_linear_act.launches
        load = dict(corpus.LAST_LOAD)
        if rc != 0 or outs is None or outs.shape != (N_FILES, n_out) \
                or not np.all(np.isfinite(outs)):
            raise AssertionError(f"corpus run_nn {tag} ({mode}): rc={rc}")
        if load["mode"] != want or load["native_io"] != native \
                or load["rows"] != N_FILES:
            raise AssertionError(f"corpus run_nn {tag} ({mode}): load {load}"
                                 f", want {want}, native_io {native}")
        if launched <= 0:
            raise AssertionError(f"corpus run_nn {tag} ({mode}): "
                                 "fused_linear_act was not launched")
        runs[mode] = {"out": out.getvalue(), "outs": outs, "wall_s": wall,
                      "load_s": load["seconds"], "launches": launched}
    first = modes[0]
    for mode in modes[1:]:
        if runs[mode]["out"] != runs[first]["out"]:
            raise AssertionError(f"corpus run_nn {tag}: the {mode} stream "
                                 f"differs from the {first} stream")
        if runs[mode]["outs"].tobytes() != runs[first]["outs"].tobytes():
            raise AssertionError(f"corpus run_nn {tag}: the {mode} outputs "
                                 f"differ from the {first} outputs")
    pack = os.path.getsize(corpus.pack_path(tests))
    data = N_FILES * (n_in + n_out) * 8
    if pack < data:
        raise AssertionError(f"corpus {tag}: pack of {pack} bytes < data "
                             f"region {data}")
    log(f"corpus run_nn {tag} ({n_in}-{'-'.join(map(str, hid))}-{n_out} ANN "
        f"{dtype}, {N_FILES} files written in {write_s:.2f} s): "
        + "; ".join(f"{m} load {r['load_s']:.3f} s, wall {r['wall_s']:.2f} s"
                    f", launches {r['launches']}" for m, r in runs.items())
        + f"; streams byte-identical, outputs bit-identical; pack {pack} "
        f"bytes (data region {data})")
    return {"pack_bytes": pack, "data_bytes": data, "write_s": write_s,
            **{m: {k: r[k] for k in ("load_s", "wall_s", "launches")}
               for m, r in runs.items()}}


def phase_corpus(e2e, tmp):
    """The corpus pipeline on the card (run after phase 17): the native
    loader on; MNIST 784-300-10 ANN f64 and XRD 851-230-230 ANN f32
    ``run_nn`` in three load modes (XRD in the cold and warm ones);
    ``train_nn --epochs 3`` on phase 9's
    files warm against ``HPNN_NO_CORPUS_CACHE=1`` (kernel.opt and streams
    byte-identical, each epoch's device time both ways) with the test
    dir's pack removed first, so that the warm run's prefetch builds it
    during the epochs; then ``run_nn`` of kernel.opt loads from that
    pack."""
    from hpnn_tpu_torch import api, cli
    from hpnn_tpu_torch.io import corpus, samples
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    with _corpus_env({}):
        if os.environ.get("HPNN_NO_NATIVE_IO") \
                or samples.native_io_status() != "on":
            raise AssertionError("the native sample loader is not on")
    res = {"run_nn": {
        "mnist": _corpus_run_nn("mnist", MNIST, "pixel", 1801, "f64", tmp),
        "xrd": _corpus_run_nn("xrd", XRD, "unit", 1802, "f32", tmp,
                              modes=("cold", "warm"))}}
    root = e2e["root"]
    samples_dir = os.path.join(root, "samples")
    tests_dir = os.path.join(root, "tests")
    off = _train_epochs(root, (), {"HPNN_NO_CORPUS_CACHE": "1"})
    off_load = dict(corpus.LAST_LOAD)
    corpus.prefetch_pack_async(samples_dir, MNIST[0], MNIST[2]).join()
    if os.path.exists(corpus.pack_path(tests_dir)):
        os.unlink(corpus.pack_path(tests_dir))
    warm = _train_epochs(root, ())
    warm_load = dict(corpus.LAST_LOAD)
    if api._prefetch_thread is not None:
        api._prefetch_thread.join()
    for part in ("out", "err", "opt"):
        if warm[part] != off[part]:
            raise AssertionError(f"train_nn --epochs {EPOCHS}: the warm "
                                 f"run's {part} differs from the cache-off "
                                 "run's")
    if off_load["mode"] != "parallel" or warm_load["mode"] != "pack":
        raise AssertionError(f"train_nn --epochs {EPOCHS} loads: off "
                             f"{off_load}, warm {warm_load}")
    for r in (off, warm):
        if r["launches"]["train_epoch"] != EPOCHS \
                or len(r["metrics"]["device_ms"]) != EPOCHS:
            raise AssertionError(f"train_nn --epochs {EPOCHS}: launches "
                                 f"{r['launches']}, epochs' device times "
                                 f"{r['metrics']['device_ms']}")
    if not os.path.isfile(corpus.pack_path(tests_dir)):
        raise AssertionError("the warm run's prefetch left no pack of the "
                             "test dir")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        fused_linear_act.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda",
                                   "run.conf"])
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    run_load = dict(corpus.LAST_LOAD)
    n_pass = out.getvalue().count("[PASS]")
    if rc != 0 or outs is None or run_load["mode"] != "pack" \
            or fused_linear_act.launches <= 0 or n_pass < 0.8 * TRAIN_FILES:
        raise AssertionError(f"run_nn after the prefetch: rc={rc}, load "
                             f"{run_load}, launches "
                             f"{fused_linear_act.launches}, PASS {n_pass}")
    res["train_nn_epochs"] = {
        m: {"wall_s": r["wall_s"], "epoch_device_ms": r["metrics"]
            ["device_ms"], "load_s": ld["seconds"], "load_mode": ld["mode"],
            "stage_s": r["metrics"]["stage_s"]}
        for m, r, ld in (("off", off, off_load), ("warm", warm, warm_load))}
    res["run_nn_after_prefetch"] = {"load_s": run_load["seconds"],
                                    "wall_s": wall, "pass": n_pass,
                                    "pack_bytes": os.path.getsize(
                                        corpus.pack_path(tests_dir))}
    log(f"train_nn --epochs {EPOCHS} on {TRAIN_FILES} files: cache off "
        f"(load {off_load['seconds']:.3f} s, {off_load['mode']}) epochs' "
        "device time " + ", ".join(f"{ms:.1f}" for ms in
                                   off["metrics"]["device_ms"])
        + f" ms, wall {off['wall_s']:.2f} s; warm (load "
        f"{warm_load['seconds']:.3f} s, pack; the test dir prefetched during "
        "the epochs) " + ", ".join(f"{ms:.1f}" for ms in
                                   warm["metrics"]["device_ms"])
        + f" ms, wall {warm['wall_s']:.2f} s; kernel.opt and streams "
        f"byte-identical; run_nn after it: load {run_load['seconds']:.3f} s "
        f"(pack), wall {wall:.2f} s, PASS {n_pass}/{TRAIN_FILES}")
    return res


# --- phase 19 ---------------------------------------------------------------

SERVE_CLIENTS = 8            # phase 19: client threads
SERVE_ROWS = (1, 3, 64)      # phase 19: request sizes, cycled
SERVE_POOL = 4096            # phase 19: distinct input rows a model
SERVE_TOKEN = "T"            # phase 19: serve_nn --auth-token
SERVE_WATCH_S = 0.2          # phase 19: --watch-interval
SHRUNK = (784, [100], 10)    # phase 19: the topology-changing reload


def _http(base, path, payload, headers=None, method="POST"):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _dump_generated(path, topology, seed):
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import generate_kernel

    n_in, hid, n_out = topology
    dump_kernel_to_path(generate_kernel(seed, n_in, hid, n_out)[0], path)


def _serve_conf(path, name, kernel, topology, dtype):
    n_in, hid, n_out = topology
    with open(path, "w") as fp:
        fp.write(f"[name] {name}\n[type] ANN\n[init] {kernel}\n"
                 f"[seed] 10958\n[input] {n_in}\n"
                 f"[hidden] {' '.join(map(str, hid))}\n[output] {n_out}\n"
                 f"[train] BP\n[dtype] {dtype}\n")


def _strict_pool(kernel_file, dtype, pool):
    """The strict forward of a kernel file's weights over the whole input
    pool on the card (one B=4096 call a layer; phase 14 holds rows of such
    a call bit for bit against every batch size the server uses)."""
    import torch

    from hpnn_tpu_torch.io.kernel_io import load_kernel
    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.kernels import batched_forward_fused

    w = weights_to_torch(load_kernel(kernel_file).weights, dtype, "cuda")
    x = torch.as_tensor(pool, dtype=torch.float64).cuda().to(dtype)
    return batched_forward_fused(w, x, "ANN").double().cpu().numpy()


def phase_serve_rest(e2e, tmp, card):
    """``serve_nn`` with generations, hot reload, A/B pinning, QoS lanes
    and the full metrics on the card, while ``train_nn --epochs 3
    --ckpt-every 1`` streams its snapshots into it (run after phase 18).
    Every answer must be bit-identical to the strict forward of the
    weights its generation label names; ``fused_linear_act`` must launch
    2 times a batch ``/metrics`` counts."""
    import torch

    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.ckpt import read_manifest
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.server import serve_in_thread

    root = os.path.join(tmp, "serve_rest")
    os.makedirs(root)
    for sub in ("samples", "tests"):
        os.symlink(os.path.join(e2e["root"], sub), os.path.join(root, sub))
    shutil.copy(os.path.join(e2e["root"], "nn.conf"), root)
    ck = os.path.join(root, "ck")
    mnist0 = os.path.join(root, "mnist0.opt")
    shutil.copy(os.path.join(e2e["root"], "kernel.opt"), mnist0)
    xrd_k = os.path.join(root, "xrd.opt")
    _dump_generated(xrd_k, XRD, 851)
    shrunk = os.path.join(root, "shrunk.opt")
    _dump_generated(shrunk, SHRUNK, 7)
    _serve_conf(os.path.join(root, "mnist.conf"), "mnist", mnist0, MNIST,
                "f64")
    _serve_conf(os.path.join(root, "xrd.conf"), "xrd", xrd_k, XRD, "f32")
    rng = np.random.default_rng(19)
    pools = {"mnist": _inputs(rng, SERVE_POOL, MNIST[0], "pixel"),
             "xrd": _inputs(rng, SERVE_POOL, XRD[0], "unit")}
    dtypes = {"mnist": torch.float64, "xrd": torch.float32}
    # generation -> the kernel file it served, copied when it loaded
    gen_files = {"mnist": {1: mnist0}, "xrd": {1: xrd_k}}
    swaps, reloads = [], {"busy": 0, "t_end": 0.0}

    fused_linear_act.launches = 0          # phase 19's path from here
    app, _ = cli.serve_app([
        "-p", "0", "--device", "cuda", "--no-warmup", "-b", "64", "-q",
        str(64 * SERVE_CLIENTS),
        "--ab-fraction", "0.25", "--watch-ckpt", f"mnist={ck}",
        "--watch-interval", str(SERVE_WATCH_S), "--auth-token", SERVE_TOKEN,
        os.path.join(root, "mnist.conf"), os.path.join(root, "xrd.conf")])
    if app is None:
        raise AssertionError("serve_nn (phase 19): no app")
    model = app.registry.get("mnist")
    real_reload, real_swap = app.reload_model, model.swap_kernel

    def reload_model(name, kernel_path=None, **kw):
        reloads["busy"] += 1
        try:
            res = real_reload(name, kernel_path, **kw)
            # copy what loaded at once, so the check reads those bytes
            keep = os.path.join(root, f"{name}-gen{res['generation']}.opt")
            shutil.copy(res["source"], keep)
            gen_files[name][res["generation"]] = keep
            return res
        finally:
            reloads["busy"] -= 1
            reloads["t_end"] = time.monotonic()

    def swap_kernel(*a, **kw):
        t0 = time.perf_counter()
        res = real_swap(*a, **kw)
        swaps.append(time.perf_counter() - t0)
        return res

    app.reload_model, model.swap_kernel = reload_model, swap_kernel
    httpd, th = serve_in_thread(app, "127.0.0.1", 0)
    base = "http://%s:%d" % httpd.server_address[:2]
    answers, failures = [], []
    stop = threading.Event()

    def client(i):
        name = "xrd" if i >= SERVE_CLIENTS - 2 else "mnist"
        k = i
        while not stop.is_set():
            rows = SERVE_ROWS[k % len(SERVE_ROWS)]
            lo = (97 * k + 31 * i) % (SERVE_POOL - rows)
            k += 1
            st, body = _http(base, f"/v1/kernels/{name}/infer",
                             {"inputs": pools[name][lo:lo + rows].tolist()})
            if st != 200:
                failures.append((name, st, body))
                return
            answers.append((name, lo, rows, body["generation"],
                            np.asarray(body["outputs"], np.float64)))

    trainer = None
    log_path = os.path.join(root, "train_nn.log")
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        t_traffic = time.perf_counter()
        for t in threads:
            t.start()
        with open(log_path, "w") as logf:
            trainer = subprocess.Popen(
                [sys.executable, "-m", "hpnn_tpu_torch.cli", "train_nn",
                 "-v", "-v", "--device", "cuda", "--epochs", str(EPOCHS),
                 "--ckpt-every", "1", "--ckpt-keep", "3", "--ckpt-dir", ck,
                 "nn.conf"], cwd=root, stdout=logf, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=ROOT))
            rc = trainer.wait(timeout=300)
        t_trained = time.monotonic()
        if rc != 0:
            raise AssertionError(f"train_nn (phase 19): rc={rc}\n"
                                 + open(log_path).read()[-2000:])
        # the watcher has caught up once no reload is running and a few
        # poll periods passed since the run's last manifest write
        end = time.monotonic() + 60
        while time.monotonic() < end and (
                reloads["busy"] or time.monotonic() - max(
                    t_trained, reloads["t_end"]) < 4 * SERVE_WATCH_S):
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=120)
            if t.is_alive():
                raise AssertionError("serve (phase 19): a client hung")
        traffic_s = time.perf_counter() - t_traffic
        if failures:
            raise AssertionError(f"serve (phase 19): non-200 answers "
                                 f"{failures[:3]}")
        manifest = read_manifest(ck)
        table = model.generation_table()
        snap0 = app.metrics.snapshot()
        if snap0["reloads"]["error"] or not table["retained"]:
            raise AssertionError(f"serve (phase 19): reloads "
                                 f"{snap0['reloads']}, table {table}")
        checks = []

        def infer(name, lo, rows, headers=None, want=200):
            st, body = _http(base, f"/v1/kernels/{name}/infer",
                             {"inputs": pools[name][lo:lo + rows].tolist()},
                             headers)
            if st != want:
                raise AssertionError(f"serve (phase 19) {headers}: status "
                                     f"{st}, wanted {want}: {body}")
            if st == 200:
                answers.append((name, lo, rows, body["generation"],
                                np.asarray(body["outputs"], np.float64)))
            return body

        # a pinned retained generation answers with its own weights
        old = table["retained"][0]
        body = infer("mnist", 5, 3, {"X-HPNN-Generation": str(old)})
        if body["generation"] != old:
            raise AssertionError(f"pin {old} answered generation "
                                 f"{body['generation']}")
        checks.append(f"pin {old} -> {old}")
        body = infer("mnist", 5, 3, {"X-HPNN-Generation": "999"}, want=404)
        checks.append(f"pin 999 -> 404 {body['reason']}")
        reload_url = "/v1/kernels/mnist/reload"
        auth = {"Authorization": f"Bearer {SERVE_TOKEN}"}
        st, body = _http(base, reload_url, {})
        if st != 401:
            raise AssertionError(f"reload without the token: {st}")
        checks.append("reload without token -> 401")
        gen_before = model.generation
        st, body = _http(base, reload_url,
                         {"kernel": os.path.join(root, "missing.opt")}, auth)
        if st != 409 or model.generation != gen_before:
            raise AssertionError(f"reload of a bad path: {st} {body}")
        body = infer("mnist", 7, 64)
        checks.append(f"bad path -> 409; generation {gen_before} still "
                      "answers")
        # QoS lanes: a paused batcher dispatches high, normal, low
        b = app.batchers["mnist"]
        lanes, real_dispatch = [], b.backend.dispatch

        def dispatch(xs, lane=None, **kw):
            lanes.append(lane)
            return real_dispatch(xs, lane=lane, **kw)

        b.backend.dispatch = dispatch
        b.pause()
        qos_threads = []
        for n, prio in enumerate(("low", "normal", "high")):
            t = threading.Thread(target=infer, args=(
                "mnist", 64 * n, 64, {"X-HPNN-Priority": prio}))
            t.start()
            qos_threads.append(t)
            end = time.monotonic() + 30
            while b.depth() < 64 * (n + 1) and time.monotonic() < end:
                time.sleep(0.005)
        b.resume()
        for t in qos_threads:
            t.join(timeout=60)
        b.backend.dispatch = real_dispatch
        if lanes != [0, 1, 2]:
            raise AssertionError(f"paused batcher dispatched lanes {lanes}"
                                 ", wanted high, normal, low")
        checks.append("low/normal/high queued -> dispatched high first")
        before = fused_linear_act.launches
        body = infer("mnist", 0, 1, {"X-HPNN-Deadline-Ms": "0"}, want=504)
        if fused_linear_act.launches != before:
            raise AssertionError("an expired deadline launched the kernel")
        checks.append(f"expired deadline -> 504 {body['reason']}, no launch")
        # a topology-changing reload serves the new shape
        st, body = _http(base, reload_url, {"kernel": shrunk}, auth)
        if st != 200 or not body["topology_changed"] \
                or body["topology"] != [SHRUNK[0], *SHRUNK[1], SHRUNK[2]]:
            raise AssertionError(f"topology-changing reload: {st} {body}")
        body = infer("mnist", 11, 3)
        if body["generation"] != model.generation:
            raise AssertionError("the new topology is not what answers")
        checks.append(f"reload to {'-'.join(map(str, model.topology))} "
                      f"-> generation {model.generation} serves it")
        snap = app.metrics.snapshot()
        launches = fused_linear_act.launches   # the path ends here
    finally:
        stop.set()
        if trainer is not None and trainer.poll() is None:
            trainer.kill()
            trainer.wait()
        httpd.shutdown()
        httpd.server_close()
        app.close(drain=True)
        th.join(timeout=60)
    if launches != 2 * snap["batches_total"]:
        raise AssertionError(f"fused_linear_act launched {launches} times "
                             f"for {snap['batches_total']} batches")
    # every answer against the strict forward of its generation's file
    refs, n_gens = {}, {}
    for name, lo, rows, gen, outs in answers:
        key = (name, gen)
        if key not in refs:
            refs[key] = _strict_pool(gen_files[name][gen], dtypes[name],
                                     pools[name])
        n_gens[key] = n_gens.get(key, 0) + 1
        if not np.array_equal(outs, refs[key][lo:lo + rows]):
            raise AssertionError(f"serve (phase 19): {name} generation "
                                 f"{gen} rows {lo}:{lo + rows} not "
                                 "bit-identical to its strict forward")
    phases = {p: {"p50_ms": h["p50_ms"], "p99_ms": h["p99_ms"],
                  "count": h["count"]} for p, h in snap["phases"].items()}
    res = {"requests": len(answers), "traffic_s": traffic_s,
           "requests_per_s": len(answers) / traffic_s,
           "answers_by_generation": {f"{n} {g}": c
                                     for (n, g), c in sorted(n_gens.items())},
           "manifest_generation": manifest["generation"],
           "reloads": snap["reloads"], "swap_s": swaps,
           "batches": snap["batches_total"], "launches": launches,
           "batch_fill_ratio": snap["batch_fill_ratio"],
           "latency": {k: snap["latency"][k] for k in ("p50_ms", "p99_ms")},
           "phases": phases, "checks": checks}
    log(f"serve_nn rest (phase 19): {len(answers)} answers over "
        f"{len(n_gens)} (kernel, generation) pairs, all 200 and "
        "bit-identical to the strict forward of their generation "
        f"({res['answers_by_generation']}); manifest generation "
        f"{manifest['generation']}, reloads {snap['reloads']}; swap "
        + ", ".join(f"{s * 1e3:.2f}" for s in swaps) + " ms; "
        f"{res['requests_per_s']:.1f} requests/s over {traffic_s:.2f} s; "
        f"batches {snap['batches_total']}, fused_linear_act launches "
        f"{launches} (2 a batch); fill {snap['batch_fill_ratio']}; "
        + "; ".join(checks))
    log(f"serve_nn rest (phase 19) p50/p99 ms ({card}): request "
        f"{snap['latency']['p50_ms']}/{snap['latency']['p99_ms']}, "
        + ", ".join(f"{p} {v['p50_ms']}/{v['p99_ms']}"
                    for p, v in sorted(phases.items())))
    return res


# --- phase 20: the batched trainers ----------------------------------------

BATCH_FILES = 4096          # phase 20: the [batch] runs' corpora
# phase 20's [batch] runs (corpus, dtype, batch, train): both batch sizes
# and both trainers at f64, one batch size each for bf16 and the XRD f32
# corpus (a cut of the full 3 x 2 x 2 grid, for the run's time limit)
DP_CELLS = (("mnist", "f64", 32, "BP"), ("mnist", "f64", 32, "BPM"),
            ("mnist", "f64", 128, "BP"), ("mnist", "f64", 128, "BPM"),
            ("mnist", "bf16", 32, "BP"), ("mnist", "bf16", 32, "BPM"),
            ("xrd", "f32", 128, "BP"), ("xrd", "f32", 128, "BPM"))
DIST_FILES = 128            # phase 20: the HPNN_DISTRIBUTED runs' files
CG_LIMIT = {"f64": 1e-9, "f32": 1e-2}   # batched search vs transcription
DIST_LIMIT_S = 120          # phase 20: each gloo rank's time limit


def _b_conf(root, kind, train, topology, samples, extra=""):
    """A generated-kernel conf over ``samples`` (an absolute dir) in
    ``root``, with no test dir (so no run prefetches one beside its
    epochs)."""
    n_in, hid, n_out = topology
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "nn.conf"), "w") as fp:
        fp.write(f"[name] batched\n[type] {kind}\n[init] generate\n"
                 f"[seed] 10958\n[input] {n_in}\n"
                 f"[hidden] {' '.join(map(str, hid))}\n[output] {n_out}\n"
                 f"[train] {train}\n[sample_dir] {samples}\n{extra}")
    return root


def _dp_replay(samples, bsz):
    """The [batch] BPM epoch of MNIST f64 alone on the card (no CLI, no
    other thread), median of 3 between CUDA events: (device ms, host ms
    of the launches)."""
    import torch

    from hpnn_tpu_torch.io.corpus import load_resident
    from hpnn_tpu_torch.io.samples import list_sample_dir
    from hpnn_tpu_torch.models.kernel import generate_kernel
    from hpnn_tpu_torch.parallel import dp

    rc = load_resident(samples, list_sample_dir(samples), 784, 10)
    kern, _ = generate_kernel(10958, 784, [300], 10)
    shapes = tuple(tuple(w.shape) for w in kern.weights)
    nb = rc.n_rows // bsz
    x = _to_card(np.asarray(rc.X[:nb * bsz]), torch.float64)
    t = _to_card(np.asarray(rc.T[:nb * bsz]), torch.float64)
    xb, tb = x.view(nb, bsz, -1), t.view(nb, bsz, -1)
    mb = torch.ones(nb, bsz, dtype=torch.float64, device="cuda")
    w = dp.dp_resident_carry([_to_card(v, torch.float64)
                              for v in kern.weights])
    got = []
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        dp.dp_epoch(w, xb, tb, mb, "ANN", True, 0.0005, 0.2, shapes)
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        got.append((start.elapsed_time(end), host))
    return sorted(got[1:])[1]


def _cg_module(tag, kind, dtype, xs, ts):
    """One CG epoch (8 iterations) of the generated MNIST kernel on the
    card, with the batched line search under
    ``set_sync_debug_mode("error")`` and with the transcribed one: device
    time of each, and the weights held to CG_LIMIT."""
    import torch

    from hpnn_tpu_torch.models.kernel import generate_kernel
    from hpnn_tpu_torch.train import cg

    kern, _ = generate_kernel(10958, 784, [300], 10)
    dt = _dtypes()[dtype]
    shapes = tuple(tuple(w.shape) for w in kern.weights)
    flat = torch.cat([_to_card(w, dt).reshape(-1) for w in kern.weights])
    x, t = _to_card(xs, dt), _to_card(ts, dt)
    z = torch.zeros_like(flat)

    def run(plain):
        args = (flat, z, z.clone(), torch.tensor(False, device="cuda"),
                torch.tensor(0, dtype=torch.int32, device="cuda"), x, t,
                kind, shapes, 8)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if not plain:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = cg.cg_epoch(*args, plain=plain)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out

    run(False)                                  # warm the libraries
    ms, dev = run(False)
    plain_ms, pl = run(True)
    scale = max(1.0, float(pl[0].abs().max()))
    err = float((dev[0] - pl[0]).abs().max())
    e0, e1 = float(dev[3]), float(dev[4])
    if not (err <= CG_LIMIT[dtype] * scale and np.isfinite(e1) and e1 <= e0):
        raise AssertionError(f"CG {tag}: batched vs transcribed search "
                             f"{err:.3e} (limit {CG_LIMIT[dtype]} x "
                             f"{scale:g}), E0 {e0} E1 {e1}")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bitwise": bool(torch.equal(dev[0], pl[0])), "E0": e0, "E1": e1}


def phase_batched(e2e, tmp):
    """Phase 20: the CG trainer, [batch] data parallelism, [batch]+[tile],
    HPNN_DISTRIBUTED and their kill + --resume, on the card."""
    import torch

    from hpnn_tpu_torch.ops.convergence_tile import (train_epoch_tiled,
                                                     train_epoch_tiled_plain)
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile
    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.train import cg

    root = os.path.join(tmp, "batched")
    mnist512 = os.path.join(e2e["root"], "samples")
    res = {"cg": {}, "dp": {}, "tile": {}, "dist": {}, "resume": {},
           "part_wall_s": {}}
    t_part = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        res["part_wall_s"][name] = now - t_part[0]
        t_part[0] = now
    # --- CG: batched search vs transcription, then train_nn --trainer cg.
    # The MNIST bars scaled to [0, 1] (pixel / 255): at pixel scale a
    # probe saturates hidden units past exp's range, and the autograd of
    # the literal 2/(1+exp(-x))-1 is then 0 * inf = NaN -- in the JAX
    # package's jax.value_and_grad as in torch (measured on the CPU, both
    # packages NaN after one epoch); SNN and the native LNN take 0/1
    # targets (with -1 targets the SNN loss has no lower bound)
    xs, ts, labels = _bar_corpus(TRAIN_FILES, MNIST, tuple(range(10)), 5)
    xs = np.round(xs / 255.0, 1)
    cg_dirs = {"pm1": (ts, os.path.join(root, "cg_pm1")),
               "01": ((ts + 1.0) / 2.0, os.path.join(root, "cg_01"))}
    for cts, d in cg_dirs.values():
        _write_samples(d, xs, cts, labels)
    cg_cases = (("mnist ANN f64", "ANN", "f64", "", "pm1"),
                ("mnist SNN f64", "SNN", "f64", "", "01"),
                ("mnist LNN-native f64", "LNN", "f64", "[lnn] native\n",
                 "01"),
                ("mnist ANN f32", "ANN", "f32", "[dtype] f32\n", "pm1"))
    for tag, kind, dtype, extra, tgt in cg_cases:
        cts, cdir = cg_dirs[tgt]
        mod = _cg_module(tag, kind, dtype, xs, cts)
        cwd = _b_conf(os.path.join(root, "cg", tag.replace(" ", "_")),
                      kind, "CG", MNIST, cdir, extra)
        cg.CG_METRICS.update(epochs=0, iters=0, device_ms=[])
        run = _ckpt_train(cwd, ["--trainer", "cg", "--epochs", str(EPOCHS),
                                "nn.conf"], {"HPNN_CG_SYNC_DEBUG": "error"})
        lines = re.findall(r"E0=\s*(\S+) E1=\s*(\S+)", run["out"])
        if len(lines) != EPOCHS or len(cg.CG_METRICS["device_ms"]) != EPOCHS \
                or not all(np.isfinite(float(b)) and float(b) <= float(a)
                           for a, b in lines):
            raise AssertionError(f"train_nn --trainer cg ({tag}): {lines}, "
                                 f"{cg.CG_METRICS}")
        dms = list(cg.CG_METRICS["device_ms"])
        res["cg"][tag] = {**mod, "epoch_device_ms": dms,
                          "ms_per_iter": [m / 8 for m in dms],
                          "evals_per_iter": cg.EVALS_PER_ITER,
                          "wall_s": run["wall_s"],
                          "E": [[float(a), float(b)] for a, b in lines]}
        log(f"CG {tag}: batched search {mod['ms']:.2f} ms an epoch of 8 "
            f"iterations with no host synchronisation, transcribed "
            f"{mod['plain_ms']:.2f} ms, weights "
            f"{'bit-identical' if mod['bitwise'] else 'within'} "
            f"({mod['max_abs_err']:.3e}); train_nn --trainer cg --epochs "
            f"{EPOCHS}: epochs' device time "
            + ", ".join(f"{m:.2f}" for m in dms) + f" ms "
            f"({dms[-1] / 8:.3f} ms an iteration, {cg.EVALS_PER_ITER} loss "
            f"evaluations an iteration), E1 {lines[-1][1]}")
    done("cg")
    # --- [batch] B on 4096 files
    dirs = {}
    for name, topo, classes, seed in (("mnist", MNIST, tuple(range(10)), 7),
                                      ("xrd", XRD, tuple(range(230)), 8)):
        bx, bt, bl = _bar_corpus(BATCH_FILES, topo, classes, seed)
        dirs[name] = os.path.join(root, f"{name}{BATCH_FILES}")
        _write_samples(dirs[name], bx, bt, bl)
    done("write_4096")
    for corpus, dtype, bsz, train in DP_CELLS:
        topo = MNIST if corpus == "mnist" else XRD
        tag = f"{corpus} {dtype} batch {bsz} {train}"
        cwd = _b_conf(os.path.join(root, "dp", tag.replace(" ", "_")),
                      "ANN", train, topo, dirs[corpus],
                      f"[batch] {bsz}\n[dtype] {dtype}\n")
        run = _ckpt_train(cwd, ["--epochs", str(EPOCHS), "nn.conf"])
        met = run["metrics"]
        nb = -(-BATCH_FILES // bsz)
        errs = [float(v) for v in
                re.findall(r"TRAINING BATCH\s+\d+\t err=\s*(\S+)",
                           run["out"])]
        if met["mode"] != "dp-resident" \
                or met["h2d_bytes"] != EPOCHS * nb * bsz * 4 \
                or len(met["device_ms"]) != EPOCHS \
                or len(errs) != EPOCHS * nb \
                or not np.all(np.isfinite(errs)) \
                or sum(run["launches"].values()) != 0:
            raise AssertionError(f"[batch] {tag}: {met}, "
                                 f"{len(errs)} batch lines, "
                                 f"launches {run['launches']}")
        dms = met["device_ms"]
        res["dp"][tag] = {
            "epoch_device_ms": dms, "wall_s": run["wall_s"],
            "samples_per_s": BATCH_FILES * EPOCHS / sum(dms) * 1e3,
            "h2d_bytes": met["h2d_bytes"],
            "setup_h2d_bytes": met["setup_h2d_bytes"],
            "first_err": errs[0], "last_epoch_mean_err":
                float(np.mean(errs[-nb:]))}
        log(f"[batch] {tag}: epochs' device time "
            + ", ".join(f"{m:.1f}" for m in dms) + " ms = "
            f"{res['dp'][tag]['samples_per_s']:.0f} samples/s; "
            f"H2D {met['h2d_bytes']} bytes over the epochs (the "
            f"slot maps) and {met['setup_h2d_bytes']} once; wall "
            f"{run['wall_s']:.2f} s")
        if tag == "mnist f64 batch 32 BPM":
            re_run = _ckpt_train(cwd, ["--epochs", str(EPOCHS),
                                       "nn.conf"],
                                 {"HPNN_NO_EPOCH_PIPELINE": "1"})
            if (re_run["out"], re_run["sha"]) != (run["out"],
                                                  run["sha"]):
                raise AssertionError(f"[batch] {tag}: the restaging "
                                     "route differs")
            res["dp"][tag]["restage_wall_s"] = re_run["wall_s"]
    replay_ms, replay_host = _dp_replay(dirs["mnist"], 32)
    res["dp_replay"] = {"cell": "mnist f64 batch 32 BPM, one epoch",
                        "ms": replay_ms, "host_ms": replay_host}
    log(f"[batch] mnist f64 batch 32 BPM epoch alone on the card: "
        f"{replay_ms:.1f} ms between events, {replay_host:.1f} ms of host "
        "launches (median of 3)")
    done("dp")
    # --- [batch] 32 + [tile] T: launches, invariance, the plain version
    tile_root = _b_conf(os.path.join(root, "tile"), "ANN", "BP", MNIST,
                        mnist512, "[batch] 32\n")
    groups = -(-TRAIN_FILES // 32)
    tile_runs = {}
    for t in (4, 1):
        run = _ckpt_train(tile_root, ["--epochs", "2", "--tile", str(t),
                                      "nn.conf"])
        want = 2 * -(-groups // t)
        if run["launches"]["train_tile"] != want \
                or run["launches"]["train_epoch"] != 0 \
                or run["out"].count("N_ITER=") != 2 * TRAIN_FILES:
            raise AssertionError(f"[batch] 32 --tile {t}: launches "
                                 f"{run['launches']}, want train_tile {want}")
        tile_runs[t] = run
    if (tile_runs[4]["out"], tile_runs[4]["sha"]) != (tile_runs[1]["out"],
                                                      tile_runs[1]["sha"]):
        raise AssertionError("[batch] 32: --tile 4 and --tile 1 differ")
    nn, exs, ets = _epoch_inputs(tile_root)
    w = weights_to_torch(nn.kernel.weights, torch.float64, "cuda")
    x, t = _to_card(exs, torch.float64), _to_card(ets, torch.float64)
    train_tile.launches = 0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    wk, sk = train_epoch_tiled(w, x, t, "ANN", False, tile=32,
                               launch_groups=4, defer_stats=True)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    tile_launches = train_tile.launches
    wp, sp = train_epoch_tiled_plain(w, x, t, "ANN", False, tile=32)
    werr, dn = _check_train("[batch] 32 tile 4", "f64", sk, sp, wk, wp,
                            name="train_tile", scaled=True)
    lane_iters = int(sk[:, 2].sum().item())
    iters_cli = sum(int(v) for v in re.findall(
        r"N_ITER=\s*(\d+)", tile_runs[4]["out"].split("EPOCH ")[1]))
    if iters_cli != lane_iters:
        raise AssertionError(f"[batch] 32 tile 4: train_nn's first epoch "
                             f"ran {iters_cli} lane iterations, the replay "
                             f"{lane_iters}")
    bitwise = _bitwise(tuple(wk), tuple(wp)) and _bitwise(sk, sp)
    res["tile"] = {"launches": {t: r["launches"]["train_tile"]
                                for t, r in tile_runs.items()},
                   "replay_launches": tile_launches, "epoch_ms": ms,
                   "lane_iters": lane_iters,
                   "lane_iters_per_s": lane_iters / ms * 1e3,
                   "max_abs_err": werr, "bitwise": bitwise}
    log(f"[batch] 32 + --tile 4 / --tile 1: train_tile launched "
        f"{tile_runs[4]['launches']['train_tile']} / "
        f"{tile_runs[1]['launches']['train_tile']} times in 2 epochs, "
        f"streams and kernel.opt identical; the epoch replayed in "
        f"{tile_launches} launches: {ms:.1f} ms, {lane_iters} lane "
        f"iterations = {lane_iters / ms * 1e3:.0f} lane-iterations/s, "
        f"against train_epoch_tiled_plain "
        f"{'bit-identical' if bitwise else f'within {werr:.3e}'}")
    done("tile")
    # --- HPNN_DISTRIBUTED: world 1 on NCCL, 2 gloo ranks, the bailout
    dist_files = os.path.join(root, f"mnist{DIST_FILES}")
    _write_samples(dist_files, *_bar_corpus(DIST_FILES, MNIST,
                                            tuple(range(10)), 5))
    dist_root = _b_conf(os.path.join(root, "dist"), "ANN", "BPM", MNIST,
                        dist_files, "[batch] 32\n")
    argv = ["-v", "-v", "-v", "--epochs", "2", "nn.conf"]
    one = _ckpt_train(dist_root, argv)
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    nccl = _ckpt_train(dist_root, argv, {
        "HPNN_DISTRIBUTED": "1", "HPNN_COORDINATOR": f"127.0.0.1:{port}",
        "HPNN_NUM_PROCESSES": "1", "HPNN_PROCESS_ID": "0"})
    strip = lambda o: "".join(ln for ln in o.splitlines(True)   # noqa: E731
                              if not ln.startswith("NN(DBG):"))
    if "rank 0 of 1 (nccl)" not in nccl["out"] \
            or strip(nccl["out"]) != strip(one["out"]) \
            or nccl["sha"] != one["sha"]:
        raise AssertionError("HPNN_DISTRIBUTED=1 at world 1 on NCCL is not "
                             "bit-identical to one process")
    with open(os.path.join(dist_root, "kernel.opt")) as fp:
        ref = fp.read()
    gloo = _gloo_ranks(2, dist_root, ["-v", "-v", "--epochs", "2"])
    with open(os.path.join(dist_root, "kernel.opt")) as fp:
        got = fp.read()
    gerr = _kernel_diff(ref, got)
    batch_lines = lambda o: re.findall(r"TRAINING BATCH[^\n]*", o)  # noqa
    if any(r[0] != 0 for r in gloo) or gerr > 1e-11 \
            or batch_lines(gloo[0][1]) != batch_lines(one["out"]):
        raise AssertionError(f"2 gloo ranks: rcs {[r[0] for r in gloo]}, "
                             f"weights {gerr:.3e} from one process")
    bad = os.path.join(dist_root, "bad.conf")
    with open(os.path.join(dist_root, "nn.conf")) as fp:
        text = fp.read()
    with open(bad, "w") as fp:
        fp.write(text.replace(dist_files, dist_files + "_missing"))
    t0 = time.perf_counter()
    bail = _gloo_ranks(2, dist_root, ["-v", "-v"], confs=["nn.conf",
                                                          "bad.conf"])
    bail_s = time.perf_counter() - t0
    if any(r[0] == 0 for r in bail) or "coordinated bailout" not in bail[0][2]:
        raise AssertionError(f"a missing sample dir on rank 1: rcs "
                             f"{[r[0] for r in bail]}")
    res["dist"] = {"nccl_world1_bitwise": True, "gloo2_max_abs_err": gerr,
                   "bailout_s": bail_s}
    log(f"HPNN_DISTRIBUTED: world 1 on NCCL bit-identical to one process; "
        f"2 gloo CPU ranks within {gerr:.3e} of the card's one process; a "
        f"missing sample dir on rank 1 ended both ranks non-zero in "
        f"{bail_s:.1f} s")
    done("dist")
    # --- kill at epoch 1 + --resume: CG and [batch] 32 BPM
    for tag, kind, train, extra, flags, sdir in (
            ("cg", "ANN", "CG", "", ["--trainer", "cg"],
             cg_dirs["pm1"][1]),
            ("batch 32 BPM", "ANN", "BPM", "[batch] 32\n", [], mnist512)):
        base = os.path.join(root, "resume", tag.replace(" ", "_"))
        ck = ["--epochs", str(EPOCHS), "--ckpt-every", "1", "--ckpt-dir",
              "ck", *flags, "nn.conf"]
        full = _ckpt_train(_b_conf(base + "_full", kind, train, MNIST,
                                   sdir, extra), ck)
        part = _b_conf(base + "_part", kind, train, MNIST, sdir, extra)
        _ckpt_train(part, ck, {"HPNN_CKPT_KILL_AT_EPOCH": str(KILL_AT)})
        resumed = _ckpt_train(part, ["--epochs", str(EPOCHS), "--resume",
                                     "--ckpt-dir", "ck", *flags, "nn.conf"])
        if resumed["sha"] != full["sha"]:
            raise AssertionError(f"--resume ({tag}): kernel.opt differs from "
                                 "the uninterrupted run's")
        res["resume"][tag] = {"full_wall_s": full["wall_s"],
                              "resume_wall_s": resumed["wall_s"]}
        log(f"kill at epoch {KILL_AT} + --resume ({tag}): kernel.opt "
            f"byte-identical to the uninterrupted run; wall "
            f"{resumed['wall_s']:.2f} s (uninterrupted {full['wall_s']:.2f})")
    done("resume")
    log("phase 20 wall by part: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in res["part_wall_s"].items()))
    return res


TP_WARN = "NN(WARN): [model] 2 > 1 visible device(s); using 1\n"
TP_FILES = 64              # phase 21: the per-sample gloo run's files
TP_SERVE_BUCKETS = (1, 3, 64)
TP_LIMIT = {"f64": 1e-12, "f32": 1e-5}   # tp@K answers vs the strict tier


def _tp_train(cwd, argv, base, launches, tag):
    """A phase 21 ``train_nn`` at world 1 (the counts set to 0 just before
    it): the clamp warning once an epoch before that epoch's lines, the
    stream without it equal to ``base``'s, and ``train_epoch`` launched
    ``launches`` times."""
    run = _ckpt_train(cwd, argv)
    warn = run["out"].count(TP_WARN)
    epochs = max(1, run["out"].count("EPOCH "))
    got = run["launches"]
    if warn != epochs or run["out"].index(TP_WARN) > run["out"].index(
            "TRAINING FILE") or got["train_epoch"] != launches \
            or got["train_tile"] != 0:
        raise AssertionError(f"{tag}: {warn} clamp warnings in {epochs} "
                             f"epoch(s), launches {got}")
    if base is not None and (run["out"].replace(TP_WARN, "") != base["out"]
                             or run["sha"] != base["sha"]):
        raise AssertionError(f"{tag}: the stream or kernel.opt differs from "
                             "the unsharded run's")
    return run


def _tp_serve(runs, results):
    """The tp@K serving tier on a LocalMesh of the one card repeated K
    times (every kernel over a zero budget): answers against the strict
    tier, each shard's first-layer rows against the full layer's, B2
    launches and device ms a batch beside the strict tier's."""
    import torch

    from hpnn_tpu_torch import ops
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.parallel import LocalMesh, tp
    from hpnn_tpu_torch.serve.registry import ModelRegistry

    confs = {name: (conf, dtype) for name, conf, _, dtype, _ in runs}
    strict = ModelRegistry(max_batch=64, device="cuda")
    cells = {}
    old = {k: os.environ.get(k) for k in ("HPNN_EPOCH_DEVICE_BUDGET_MB",
                                          "HPNN_NO_TP_OVERLAP")}
    os.environ["HPNN_EPOCH_DEVICE_BUDGET_MB"] = "0"
    try:
        for name in ("mnist_ann_f64", "xrd_ann_f32"):
            conf, dtype = confs[name]
            ref_model = strict.register_conf(conf, name=name)
            xs = results[name][1]
            for k in (2, 4):
                mesh = LocalMesh([torch.device("cuda", 0)] * k)
                for sched in ("ring", "gather"):
                    if sched == "gather":
                        os.environ["HPNN_NO_TP_OVERLAP"] = "1"
                    else:
                        os.environ.pop("HPNN_NO_TP_OVERLAP", None)
                    reg = ModelRegistry(max_batch=64, device="cuda",
                                        tp_mesh=mesh)
                    m = reg.register_conf(conf, name=name)
                    if reg.route_for(m) != f"tp@{k}":
                        raise AssertionError(f"tp@{k} {name}: route "
                                             f"{reg.route_for(m)}")
                    tag = f"{name} tp@{k} {sched}"
                    cell = {"launches_per_batch": {}, "max_abs_err": 0.0,
                            "ms": {}, "strict_ms": {}}
                    for b in TP_SERVE_BUCKETS:
                        rows = xs[:b]
                        fused_linear_act.launches = 0   # the batch's path
                        h = reg.dispatch(m, rows)
                        got = reg.collect(h)
                        cell["launches_per_batch"][b] = \
                            fused_linear_act.launches
                        want = strict.forward(ref_model, rows)
                        err = float(np.abs(got - want).max())
                        if h.tier != f"tp@{k}" or not err <= TP_LIMIT[dtype]:
                            raise AssertionError(
                                f"{tag} B={b}: tier {h.tier}, {err:.3e} "
                                f"from the strict tier")
                        cell["max_abs_err"] = max(cell["max_abs_err"], err)
                        carry, _ = m.tp_weights(mesh)
                        dt = m.dtype
                        x = torch.as_tensor(rows).cuda().to(dt)
                        fn, _ = ops.select_run_batch(dt, device="cuda",
                                                     model_mesh=mesh)
                        # four calls a timed run: the spin covers their
                        # enqueue (2K + 2 launches and the adds each)
                        cell["ms"][b] = _device_ms(
                            lambda: fn(carry, x, m.kind), launches=4,
                            runs=10)
                        sw = ref_model.mlp.weights
                        sfn, _ = ops.select_run_batch(dt, device="cuda")
                        cell["strict_ms"][b] = _device_ms(
                            lambda: sfn(sw, x, m.kind), launches=4,
                            runs=10)
                    # a shard's first-layer block is the full layer's rows
                    w0 = ref_model.mlp.weights[0]
                    x = torch.as_tensor(xs[:64]).cuda().to(m.dtype)
                    full = fused_linear_act(w0, x, True)
                    blocks = torch.cat([fused_linear_act(s_[0], x, True)
                                        for s_ in carry.shards], dim=1)
                    if not torch.equal(blocks[:, :w0.shape[0]], full):
                        raise AssertionError(f"{tag}: a row block's rows "
                                             "differ from the full layer's")
                    cell["blocks_bitwise"] = True
                    cell["weight_bytes_per_shard"] = tp.carry_bytes(carry)
                    cells[tag] = cell
                    log(f"serve {tag}: answers within "
                        f"{cell['max_abs_err']:.3e} of the strict tier "
                        f"(limit {TP_LIMIT[dtype]:g}), row blocks "
                        f"bit-identical to the full layer's rows; "
                        f"fused_linear_act a batch "
                        f"{cell['launches_per_batch']}; device ms a batch "
                        + ", ".join(f"B={b} {cell['ms'][b]:.4f} (strict "
                                    f"{cell['strict_ms'][b]:.4f})"
                                    for b in TP_SERVE_BUCKETS))
    finally:
        for kk, v in old.items():
            if v is None:
                os.environ.pop(kk, None)
            else:
                os.environ[kk] = v
    return cells


def phase_tp(e2e, tmp, runs, results, epochs_runs):
    """Phase 21: ``[model]`` row sharding.  At world 1 on the card the
    model axis clamps to one shard and the TP routes run the existing
    kernels; the tp@K serving tier puts K row blocks on the one card; 2
    and 4 gloo CPU ranks run the sharded engines against the card's one
    process."""
    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    res = {"train": {}, "run_nn": {}, "serve": {}, "gloo": {},
           "part_wall_s": {}}
    t_part = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        res["part_wall_s"][name] = now - t_part[0]
        t_part[0] = now

    root = os.path.join(tmp, "tp")
    mnist512 = os.path.join(e2e["root"], "samples")
    # --- the card's one-process references of the gloo runs, then the
    # gloo ranks in the background (CPU only) while the card works.  The
    # per-sample run starts from a kernel trained on these files (the
    # one the earlier phases left), so its 64 samples take tens of
    # iterations each, not thousands: on the CPU every iteration pays
    # three collectives
    s64 = os.path.join(root, "samples64")
    os.makedirs(s64)
    for f in sorted(os.listdir(mnist512))[:TP_FILES]:
        shutil.copy(os.path.join(mnist512, f), s64)
    pre = os.path.join(root, "pre.opt")
    shutil.copy(os.path.join(e2e["root"], "kernel.opt"), pre)
    gloo = {}
    for tag, world, samples, extra, flags, init in (
            ("per-sample [model] 2", 2, s64, "[model] 2\n", [], pre),
            ("[batch] 32 x [model] 2", 4, mnist512,
             "[batch] 32\n[model] 2\n", ["--epochs", "2"], None)):
        dirs = []
        for side in ("card", "gloo"):
            d = _b_conf(os.path.join(root, tag.replace(" ", "_") + side),
                        "ANN", "BP", MNIST, samples, extra)
            if init:
                path = os.path.join(d, "nn.conf")
                with open(path) as fp:
                    text = fp.read()
                with open(path, "w") as fp:
                    fp.write(text.replace("[init] generate",
                                          f"[init] {init}"))
            dirs.append(d)
        ref, cwd = dirs
        card = _ckpt_train(ref, [*flags, "nn.conf"])
        with open(os.path.join(ref, "kernel.opt")) as fp:
            card_opt = fp.read()
        t0 = time.perf_counter()
        procs = _gloo_start(world, cwd, ["-v", "-v", *flags])
        gloo[tag] = (world, cwd, card, card_opt, procs, t0)
    done("gloo_start")
    # --- train_nn at world 1: [model] 2, -S 2, --model-parallel 2
    here = e2e["root"]
    with open(os.path.join(here, "nn.conf")) as fp:
        conf = fp.read()
    with open(os.path.join(here, "tp.conf"), "w") as fp:
        fp.write(conf + "[model] 2\n")
    base = _ckpt_train(here, ["nn.conf"])
    iters = sum(int(v) for v in re.findall(r"N_ITER=\s*(\d+)", base["out"]))
    if base["launches"]["train_epoch"] != 1:
        raise AssertionError(f"phase 21's unsharded run: {base['launches']}")
    for tag, argv in (("[model] 2", ["tp.conf"]),
                      ("-S 2", ["-S", "2", "nn.conf"]),
                      ("--model-parallel 2",
                       ["--model-parallel", "2", "nn.conf"])):
        run = _tp_train(here, argv, base, 1, f"train_nn {tag}")
        res["train"][tag] = {"launches": run["launches"],
                             "wall_s": run["wall_s"],
                             "mode": run["metrics"]["mode"],
                             "tp_devices": run["metrics"]["tp_devices"]}
    ep = _tp_train(here, ["--epochs", str(EPOCHS), "tp.conf"], None, EPOCHS,
                   f"train_nn --epochs {EPOCHS} [model] 2")
    met = ep["metrics"]
    if met["mode"] != "tp-resident" or met["tp_devices"] != 1 \
            or ep["sha"] != epochs_runs["per-sample"]["opt_sha256"] \
            or len(met["device_ms"]) != EPOCHS:
        raise AssertionError(f"train_nn --epochs {EPOCHS} [model] 2: "
                             f"{met}, kernel.opt differs from phase 16's: "
                             f"{ep['sha'] != epochs_runs['per-sample']['opt_sha256']}")
    res["train"][f"--epochs {EPOCHS} [model] 2"] = {
        "launches": ep["launches"], "wall_s": ep["wall_s"],
        "mode": met["mode"], "tp_devices": met["tp_devices"],
        "epoch_device_ms": met["device_ms"],
        "weight_bytes_per_device": met["weight_bytes_per_device"]}
    log(f"train_nn [model] 2, -S 2, --model-parallel 2 at world 1: the "
        f"clamp warning, train_epoch launched once each, streams and "
        f"kernel.opt byte-identical to the unsharded run ({iters} "
        f"iterations; phase 9: {e2e['iters']}); --epochs {EPOCHS}: "
        f"{met['mode']}, tp_devices {met['tp_devices']}, train_epoch "
        f"{ep['launches']['train_epoch']} launches, epochs' device time "
        + ", ".join(f"{m:.1f}" for m in met["device_ms"])
        + " ms, kernel.opt byte-identical to phase 16's")
    done("train")
    # --- run_nn [model] 2: the warning, 2 B2 launches, phase 4's verdicts
    name = "mnist_ann_f64"
    conf_path = next(c for n, c, *_ in runs if n == name)
    with open(conf_path) as fp:
        text = fp.read()
    tp_conf = conf_path.replace(".conf", "_model2.conf")
    with open(tp_conf, "w") as fp:
        fp.write(text + "[model] 2\n")
    outs_txt = {}
    for tag, path in (("plain", conf_path), ("[model] 2", tp_conf)):
        fused_linear_act.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda", path])
        outs_txt[tag] = (rc, outs, out.getvalue(),
                         fused_linear_act.launches)
    rc, outs, text_tp, launched = outs_txt["[model] 2"]
    if rc != 0 or launched != 2 or text_tp.count(TP_WARN) != 1 \
            or text_tp.replace(TP_WARN, "") != outs_txt["plain"][2] \
            or not np.array_equal(outs, results[name][0]):
        raise AssertionError(f"run_nn [model] 2: rc={rc}, launches "
                             f"{launched}, warning "
                             f"{text_tp.count(TP_WARN)}, outputs equal to "
                             f"phase 4's: "
                             f"{np.array_equal(outs, results[name][0])}")
    res["run_nn"] = {"launches": launched, "pass": text_tp.count("[PASS]")}
    log(f"run_nn [model] 2 ({name}): the clamp warning, fused_linear_act "
        f"launched {launched} times, verdict lines and outputs identical to "
        f"phase 4's (PASS {text_tp.count('[PASS]')}/{N_FILES})")
    done("run_nn")
    # --- the tp@K serving tier on one card
    res["serve"] = _tp_serve(runs, results)
    done("serve")
    # --- the gloo ranks against the card's one process
    for tag, (world, cwd, card, card_opt, procs, t0) in gloo.items():
        ranks = _gloo_wait(procs)
        wall = time.perf_counter() - t0
        with open(os.path.join(cwd, "kernel.opt")) as fp:
            got = fp.read()
        err = _kernel_diff(card_opt, got)
        limit = 1e-11 if "batch" in tag else 1e-12
        key = "TRAINING BATCH" if "batch" in tag else "TRAINING FILE"
        lines = lambda o: re.findall(key + r"[^\n]*", o)  # noqa: E731
        if any(r[0] != 0 for r in ranks) or err > limit \
                or lines(ranks[0][1]) != lines(card["out"]) \
                or not lines(card["out"]):
            raise AssertionError(
                f"{world} gloo ranks ({tag}): rcs {[r[0] for r in ranks]}, "
                f"weights {err:.3e} from the card (limit {limit:g}), lines "
                f"equal {lines(ranks[0][1]) == lines(card['out'])}\n"
                f"{ranks[0][2][-1500:]}")
        n_iter = sum(int(v) for v in re.findall(r"N_ITER=\s*(\d+)",
                                                ranks[0][1]))
        res["gloo"][tag] = {"world": world, "max_abs_err": err,
                            "wall_s": wall, "iters": n_iter,
                            "card_wall_s": card["wall_s"], "cwd": cwd,
                            "lines": lines(ranks[0][1])}
        log(f"{world} gloo CPU ranks, {tag}: {key} lines equal to the "
            f"card's one process, kernel.opt within {err:.3e} (limit "
            f"{limit:g}); wall {wall:.1f} s from the ranks' start, "
            "process start and corpus load included"
            + (f" ({n_iter} iterations)" if n_iter else "")
            + f"; the card's one process {card['wall_s']:.2f} s")
    done("gloo_wait")
    log("phase 21 wall by part: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in res["part_wall_s"].items()))
    return res


def _kernel_diff(a: str, b: str) -> float:
    """Largest weight difference of two kernel texts."""
    va = np.array([float(v) for v in re.findall(r"-?\d+\.\d+", a)])
    vb = np.array([float(v) for v in re.findall(r"-?\d+\.\d+", b)])
    if va.shape != vb.shape:
        return float("inf")
    return float(np.abs(va - vb).max()) if va.size else 0.0


def _gloo_start(world, cwd, argv, confs=None):
    """Start ``train_nn --device cpu`` as ``world`` gloo ranks in ``cwd``
    (no card visible to them); :func:`_gloo_wait` collects them.  One
    intra-op thread a rank: at two, the ranks' sums vary from run to run
    (up to 1e-11 in kernel.opt over phase 21's 2x2 grid on the CPU), and
    a printed digit of a batch's error can then differ from the card's."""
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, HPNN_DISTRIBUTED="1",
                   HPNN_COORDINATOR=f"127.0.0.1:{port}",
                   HPNN_NUM_PROCESSES=str(world), HPNN_PROCESS_ID=str(r),
                   HPNN_DIST_TIMEOUT_S="60", OMP_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "hpnn_tpu_torch.cli", "train_nn", *argv,
             "--device", "cpu", confs[r] if confs else "nn.conf"],
            cwd=cwd, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    return procs


def _gloo_wait(procs):
    """Each rank's (rc, stdout, stderr), each with a time limit; a rank
    past it is killed, and so are the others."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=DIST_LIMIT_S)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _gloo_ranks(world, cwd, argv, confs=None):
    """``train_nn --device cpu`` as ``world`` gloo ranks in ``cwd``, each
    with a time limit: a list of (rc, stdout, stderr)."""
    return _gloo_wait(_gloo_start(world, cwd, argv, confs))


# --- phase 22: the jobs service -------------------------------------------

JOB_CLIENTS = 8             # phase 22: closed-loop client threads
JOB_ROWS = (1, 64)          # phase 22: request sizes, alternated
JOB_QUIET_S = 2.0           # phase 22: traffic alone, before job A
JOB_B_FILES = 64            # phase 22: job B's uploaded files
JOB_B_CHUNKS = 4            # phase 22: ... in this many chunks
JOB_B_EPOCHS = 2


def _post_body(base, path, body, ctype):
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _multipart(params, files, boundary="hpnnPhase22"):
    """A multipart/form-data body: an optional ``params`` JSON field and
    one part a (name, bytes) corpus file; returns (body, content type)."""
    parts = []
    if params is not None:
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="params"\r\n\r\n{json.dumps(params)}\r\n'
                     .encode())
    for name, data in files:
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="corpus"; filename="{name}"\r\n'
                     'Content-Type: application/octet-stream\r\n\r\n'
                     .encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def _job_wait(base, jid, done=("done", "failed", "cancelled",
                               "interrupted"), key="status",
              timeout_s=600.0):
    """Poll GET /v1/jobs/<id> until ``key`` is in ``done`` (or, for a
    callable ``done``, until it holds); returns the record."""
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        st, snap = _http(base, f"/v1/jobs/{jid}", None, method="GET")
        if st != 200:
            raise AssertionError(f"GET /v1/jobs/{jid}: {st} {snap}")
        if (done(snap) if callable(done) else snap[key] in done):
            return snap
        time.sleep(0.005)
    raise AssertionError(f"job {jid} stalled: {snap}")


def _pctl(xs, p):
    return float(np.percentile(xs, p)) if xs else float("nan")


def phase_jobs(e2e, epochs_runs, tmp, card, device="cuda"):
    """Phase 22: ``serve_nn --jobs 2 --auto-promote`` serves an MNIST ANN
    f64 784-300-10 kernel to 8 closed-loop clients while job A trains the
    tutorial conf on phase 9's files (3 epochs, a snapshot each, held out
    on phase 9's test files), job B trains 64 files uploaded in 4 chunks,
    and job C, job A's submit again, is cancelled after its first epoch
    and resumed to epoch 3; then a second server on the same job dir
    reports the history."""
    from hpnn_tpu_torch import api, cli
    from hpnn_tpu_torch.io.corpus import ChunkedPackWriter, pack_path
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.server import serve_in_thread

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "jobs_phase")
    os.makedirs(root)
    served = os.path.join(root, "mnist0.opt")
    _dump_generated(served, MNIST, 10958)
    conf = os.path.join(root, "mnist.conf")
    _serve_conf(conf, "mnist", served, MNIST, "f64")
    job_dir = os.path.join(root, "jobs")
    pool = _inputs(np.random.default_rng(22), SERVE_POOL, MNIST[0], "pixel")
    samples = os.path.join(e2e["root"], "samples")
    job_a = {"epochs": EPOCHS, "seed": 10958, "train": "BP", "dtype": "f64",
             "hidden": MNIST[1], "samples": samples, "ckpt_every": 1,
             "test_samples": os.path.join(e2e["root"], "tests")}
    gen_files = {1: served}     # generation -> the kernel file it serves
    swaps, yields = [], []      # (job, wall s) of each swap / gate wait
    serve_argv = ["-p", "0", "--device", device, "--no-warmup", "-b", "64",
                  "-q", str(64 * JOB_CLIENTS), "--ab-fraction", "0.25",
                  "--jobs", "2", "--auto-promote", "--job-dir", job_dir,
                  conf]

    fused_linear_act.launches = 0          # phase 22's path from here
    banner = io.StringIO()
    with contextlib.redirect_stdout(banner):
        app, _ = cli.serve_app(serve_argv)
    if app is None or "SERVE: online training enabled (queue=2, job-dir=" \
            f"{job_dir}, ab-fraction=0.25, auth=OFF (pass --auth-token), " \
            "auto-promote)\n" not in banner.getvalue():
        raise AssertionError(f"serve_nn --jobs (phase 22): {banner.getvalue()}")
    model, sched = app.registry.get("mnist"), app.jobs
    real_reload, real_rollback = app.reload_model, model.rollback
    real_into, real_yield = sched._reload_into_serving, sched._yield_to_eval

    def reload_model(name, kernel_path=None, **kw):
        res = real_reload(name, kernel_path, **kw)
        # copy what loaded at once, so the check reads those bytes
        keep = os.path.join(root, f"gen{res['generation']}.opt")
        shutil.copy(res["source"], keep)
        gen_files[res["generation"]] = keep
        return res

    def rollback(gen=None):
        res = real_rollback(gen)
        gen_files[res["generation"]] = gen_files[res["rolled_back_to"]]
        return res

    def reload_into(job, ckpt_dir, state):
        g0, t0 = model.generation, time.perf_counter()
        real_into(job, ckpt_dir, state)
        if model.generation != g0:
            swaps.append((job.job_id, time.perf_counter() - t0))

    def yield_to_eval(stop):
        t0 = time.perf_counter()
        real_yield(stop)
        yields.append(time.perf_counter() - t0)

    app.reload_model, model.rollback = reload_model, rollback
    sched._reload_into_serving = reload_into
    sched._yield_to_eval = yield_to_eval
    httpd, th = serve_in_thread(app, "127.0.0.1", 0)
    base = "http://%s:%d" % httpd.server_address[:2]
    answers, failures, lat = [], [], []
    stop = threading.Event()

    def client(i):
        k = i
        while not stop.is_set():
            rows = JOB_ROWS[k % len(JOB_ROWS)]
            lo = (97 * k + 31 * i) % (SERVE_POOL - rows)
            k += 1
            t0 = time.time()
            st, body = _http(base, "/v1/kernels/mnist/infer",
                             {"inputs": pool[lo:lo + rows].tolist()})
            t1 = time.time()
            if st != 200:
                failures.append((st, body))
                return
            answers.append((lo, rows, body["generation"],
                            np.asarray(body["outputs"], np.float64)))
            lat.append((t0, t1 - t0, rows))

    jobs, walls = {}, {}

    def submit(tag, params):
        t0 = time.perf_counter()
        st, job = _http(base, "/v1/kernels/mnist/train", params)
        if st != 202:
            raise AssertionError(f"job {tag} (phase 22): {st} {job}")
        return job["job_id"], t0

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(JOB_CLIENTS)]
    try:
        for t in threads:
            t.start()
        t_quiet = time.time()
        time.sleep(JOB_QUIET_S)
        quiet = (t_quiet, time.time())
        # job A: the tutorial conf, 3 epochs, a snapshot and a swap each
        train_epoch_kernel.launches = 0
        api.reset_epoch_metrics()
        n_yield = len(yields)
        jid, t0 = submit("A", job_a)
        jobs["A"] = _job_wait(base, jid)
        walls["A"] = time.perf_counter() - t0
        b1_launches = train_epoch_kernel.launches
        device_ms = list(api.EPOCH_METRICS["device_ms"])
        yields_a = yields[n_yield:]
        jobs["A"] = _job_wait(base, jid, lambda s: s["auto_promote"])
        # job B: 64 files uploaded in 4 chunks, 2 epochs
        names = sorted(os.listdir(samples))[:JOB_B_FILES]
        per = JOB_B_FILES // JOB_B_CHUNKS
        chunks = [names[i:i + per] for i in range(0, JOB_B_FILES, per)]

        def files(chunk):
            return [(n, open(os.path.join(samples, n), "rb").read())
                    for n in chunk]

        t0 = time.perf_counter()
        st, job = _post_body(base, "/v1/kernels/mnist/train/chunked",
                             *_multipart({"epochs": JOB_B_EPOCHS,
                                          "seed": 10958, "train": "BP",
                                          "ckpt_every": 1},
                                         files(chunks[0])))
        if st != 202:
            raise AssertionError(f"job B (phase 22): {st} {job}")
        jid_b = job["job_id"]
        for n, chunk in enumerate(chunks[1:], 2):
            final = "?final=1" if n == len(chunks) else ""
            st, out = _post_body(base, f"/v1/jobs/{jid_b}/corpus{final}",
                                 *_multipart(None, files(chunk)))
            if st != 200 or out != {"job": jid_b, "chunks": n,
                                    "complete": bool(final)}:
                raise AssertionError(f"job B chunk {n}: {st} {out}")
        jobs["B"] = _job_wait(base, jid_b)
        walls["B"] = time.perf_counter() - t0
        # job C: job A's submit, cancelled after its first epoch, resumed
        jid, t0 = submit("C", job_a)
        _job_wait(base, jid, lambda s: s["epoch"] >= 1)
        st, body = _http(base, f"/v1/jobs/{jid}/cancel", {})
        jobs["C"] = _job_wait(base, jid)
        walls["C"] = time.perf_counter() - t0
        if st != 200 or jobs["C"]["status"] != "cancelled" \
                or not 1 <= jobs["C"]["epoch"] < EPOCHS \
                or not jobs["C"]["resumable"]:
            raise AssertionError(f"job C (phase 22): cancel {st}, "
                                 f"{jobs['C']}")
        jid, t0 = submit("C'", {"resume_job": jid, "epochs": EPOCHS})
        jobs["C'"] = _job_wait(base, jid)
        walls["C'"] = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join(timeout=120)
            if t.is_alive():
                raise AssertionError("jobs (phase 22): a client hung")
        snap = app.metrics.snapshot()
        launches = fused_linear_act.launches   # the path ends here
    finally:
        stop.set()
        httpd.shutdown()
        httpd.server_close()
        app.close(drain=True)
        th.join(timeout=60)
    if failures:
        raise AssertionError(f"jobs (phase 22): non-200 answers "
                             f"{failures[:3]}")
    for tag in ("A", "B", "C'"):
        if jobs[tag]["status"] != "done":
            raise AssertionError(f"job {tag} (phase 22): {jobs[tag]}")
    a, b = jobs["A"], jobs["B"]
    if b1_launches != EPOCHS or len(a["generations"]) < 3:
        raise AssertionError(f"job A (phase 22): train_epoch launched "
                             f"{b1_launches} times, generations "
                             f"{a['generations']}")
    if device == "cuda" and len(device_ms) != EPOCHS:
        raise AssertionError(f"job A (phase 22): epoch times {device_ms}")
    if launches != 2 * snap["batches_total"]:
        raise AssertionError(f"fused_linear_act launched {launches} times "
                             f"for {snap['batches_total']} batches")

    def opt(rec):
        with open(os.path.join(rec["path"], "kernel.opt"), "rb") as fp:
            return fp.read()

    # job A against the offline train_nn of its own conf
    offline = os.path.join(root, "offline")
    os.makedirs(offline)
    cwd = os.getcwd()
    os.chdir(offline)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.train_nn_main(
                ["-v", "-v", "--device", device, "--epochs", str(EPOCHS),
                 "--ckpt-every", "1", "--ckpt-dir", "ck",
                 os.path.join(a["path"], "nn.conf")])
        with open("kernel.opt", "rb") as fp:
            offline_opt = fp.read()
    finally:
        os.chdir(cwd)
    if rc != 0 or opt(a) != offline_opt:
        raise AssertionError(f"job A (phase 22): kernel.opt differs from "
                             f"the offline train_nn (rc {rc})")
    if opt(jobs["C'"]) != opt(a):
        raise AssertionError("job C (phase 22): the cancelled and resumed "
                             "job's kernel.opt differs from job A's")
    # job B's pack: a ChunkedPackWriter of the same chunks of its files
    cdir = os.path.join(b["path"], "corpus")
    with open(pack_path(cdir), "rb") as fp:
        pack = fp.read()
    os.unlink(pack_path(cdir))
    writer = ChunkedPackWriter(cdir, MNIST[0], MNIST[2])
    for chunk in chunks:
        writer.add_sample_files(chunk)
    if not writer.finalize() or open(pack_path(cdir), "rb").read() != pack:
        raise AssertionError("job B (phase 22): the upload's pack differs "
                             "from a ChunkedPackWriter of its chunks")
    # a second server on the job dir reports the history
    with contextlib.redirect_stdout(io.StringIO()):
        app2, _ = cli.serve_app(serve_argv)
    try:
        history = {j["job_id"]: j["status"] for j in app2.jobs.list()}
    finally:
        app2.close(drain=True)
    want = {jobs[t]["job_id"]: jobs[t]["status"] for t in jobs}
    if history != want:
        raise AssertionError(f"restart (phase 22): history {history}, "
                             f"wanted {want}")
    # every answer against the strict forward of its generation's file
    refs, n_gens = {}, {}
    for lo, rows, gen, outs in answers:
        if gen not in refs:
            refs[gen] = _strict_pool(gen_files[gen], _dtypes()["f64"], pool)
        n_gens[gen] = n_gens.get(gen, 0) + 1
        if not np.array_equal(outs, refs[gen][lo:lo + rows]):
            raise AssertionError(f"jobs (phase 22): generation {gen} rows "
                                 f"{lo}:{lo + rows} not bit-identical to "
                                 "its strict forward")
    one_row = {k: [s for t0, s, r in lat if r == 1 and lo <= t0 <= hi]
               for k, (lo, hi) in (("no job", quiet),
                                   ("job A", (a["started"],
                                              a["finished"])))}
    rec, resumed = a["auto_promote"], "C'"
    res = {"answers": len(answers),
           "answers_by_generation": {str(g): c
                                     for g, c in sorted(n_gens.items())},
           "b1_launches": b1_launches, "b2_launches": launches,
           "batches": snap["batches_total"],
           "epoch_device_ms": device_ms,
           "phase16_epoch_device_ms": epochs_runs["per-sample"]
           ["epoch_device_ms"],
           "yield_s": yields_a,
           "swap_s": {t: [s for j, s in swaps if j == jobs[t]["job_id"]]
                      for t in jobs},
           "one_row_ms": {k: {"p50": _pctl(v, 50) * 1e3,
                              "p99": _pctl(v, 99) * 1e3, "n": len(v)}
                          for k, v in one_row.items()},
           "submit_to_done_s": walls,
           "generations": {t: jobs[t]["generations"] for t in jobs},
           "auto_promote": rec,
           "cancelled_at_epoch": jobs["C"]["epoch"],
           "pack_bytes": len(pack),
           "seconds": time.perf_counter() - t_phase}
    log(f"jobs (phase 22): {len(answers)} answers over generations "
        f"{res['answers_by_generation']}, all 200 and bit-identical to the "
        "strict forward of their generation; job A done in "
        f"{walls['A']:.2f} s, train_epoch launched {b1_launches} times "
        f"(one an epoch), generations {a['generations']}, kernel.opt "
        f"byte-identical to the offline train_nn; job B ({JOB_B_FILES} "
        f"files in {JOB_B_CHUNKS} chunks) done in "
        f"{walls['B']:.2f} s, pack ({len(pack)} bytes) equal to a "
        "ChunkedPackWriter's; job C cancelled at epoch "
        f"{jobs['C']['epoch']} and resumed to {EPOCHS} in "
        f"{walls['C'] + walls[resumed]:.2f} s, kernel.opt "
        "byte-identical to job A's; restart reports "
        f"{len(history)} jobs; fused_linear_act launched {launches} "
        f"times ({snap['batches_total']} batches)")
    log(f"jobs (phase 22) auto-promote: {rec['action']} candidate gen "
        f"{rec['candidate']} err {rec['candidate_err']} vs baseline gen "
        f"{rec['baseline']} err {rec['baseline_err']}, "
        f"{rec['eval_requests']} eval requests over {rec['test_rows']} "
        "test rows")
    log(f"jobs (phase 22) times ({card}): job A epochs' device time "
        + ", ".join(f"{ms:.1f}" for ms in device_ms) + " ms (phase 16: "
        + ", ".join(f"{ms:.1f}" for ms in res["phase16_epoch_device_ms"])
        + " ms); yield gate " + ", ".join(f"{s:.3f}" for s in yields_a)
        + " s an epoch; swaps " + ", ".join(
            f"{s:.3f}" for s in res["swap_s"]["A"]) + " s; 1-row p50/p99 "
        + ", ".join(f"{k} {v['p50']:.1f}/{v['p99']:.1f} ms (n={v['n']})"
                    for k, v in res["one_row_ms"].items())
        + "; submit to done " + ", ".join(
            f"{t} {s:.2f} s" for t, s in walls.items())
        + f"; phase {res['seconds']:.1f} s")
    return res


# --- phase 23: observability ------------------------------------------------

OBS_CLIENTS = 8             # phase 23: closed-loop client threads
OBS_ROWS = (1, 64)          # phase 23: request sizes, alternated
OBS_LOAD_S = 3.0            # phase 23: traced load, the capture inside it
OBS_PROFILE_S = 2.0         # phase 23: POST /v1/debug/profile seconds
OBS_COST_S = 1.0            # phase 23: a tracing mode's 1-row window
# phase 23: the windows, in turns (each mode 2 s in all), after one
# untraced window before any profile in the server's life
OBS_COST_MODES = ("off", "on", "sample 0.1", "sample 0.1", "on", "off")
OBS_JOB_FILES = 64          # phase 23: the traced job's files
OBS_JOB_EPOCHS = 2
OBS_TREE = {"parse", "queue_wait", "batch_assembly", "pad_h2d",
            "device_launch", "d2h", "respond"}
B1_NAME = re.compile(r"\btrain_epoch_kernel\b")
B2_NAME = re.compile(r"\b(simt_kernel|direct_simt|mma_kernel|direct_mma)\b")
B2_SUM = re.compile(r"\bstage_sum_kernel\b")


def _profile_kernels(trace_file):
    """The device-kernel events of a ``torch.profiler`` Chrome trace:
    (name, start us, duration us), in start order."""
    with open(trace_file) as fp:
        events = json.load(fp)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                  for e in events
                  if e.get("cat") == "kernel" and e.get("ph") == "X")


def _dbg_sums(text, tag):
    """The ``#DBG[<tag> W<i>]`` sums of a stream, in order."""
    return [(int(i), float(v)) for i, v in re.findall(
        rf"^#DBG\[{tag} W(\d+)\]: acc=(-?[0-9.]+)$", text, re.M)]


def _obs_train(e2e, epochs_runs, root):
    """Part A: ``train_nn --epochs 3 --profile-dir D`` on phase 9's files
    with ``HPNN_TRACE=1 HPNN_PROFILE=1 HPNN_DBG_TRACE=1``."""
    from hpnn_tpu_torch.io.kernel_io import load_kernel
    from hpnn_tpu_torch.obs import trace as obs_trace

    from hpnn_tpu_torch.obs import profiler

    prof_dir = os.path.join(root, "train_profile")
    records, real_stop = [], profiler.stop

    def stop():
        records.append(real_stop())
        return records[-1]

    profiler.stop = stop
    try:
        run = _train_epochs(e2e["root"], ("--profile-dir", prof_dir),
                            {"HPNN_TRACE": "1", "HPNN_PROFILE": "1",
                             "HPNN_DBG_TRACE": "1"})
    finally:
        profiler.stop = real_stop
    spans = obs_trace.snapshot()
    obs_trace.disable()
    base = epochs_runs["per-sample"]
    kept = "".join(ln for ln in run["out"].splitlines(True)
                   if not ln.startswith(("#PROF: ", "#DBG[")))
    if hashlib.sha256(kept.encode()).hexdigest() != base["out_sha256"] \
            or hashlib.sha256(run["opt"].encode()).hexdigest() \
            != base["opt_sha256"]:
        raise AssertionError("traced train_nn (phase 23): the stream less "
                             "its #PROF/#DBG lines, or kernel.opt, differs "
                             "from phase 16's untraced run")
    if run["launches"]["train_epoch"] != EPOCHS \
            or run["launches"]["train_tile"] != 0:
        raise AssertionError(f"traced train_nn (phase 23): launches "
                             f"{run['launches']}, want train_epoch {EPOCHS}")
    prof = re.findall(r"^#PROF: (\S+) [0-9.]+s$", run["out"], re.M)
    want = ["init_all", "configure"] \
        + ["warmup", "load_samples", "train_epoch"] * EPOCHS \
        + ["train_kernel"]
    if prof != want:
        raise AssertionError(f"traced train_nn (phase 23): #PROF phases "
                             f"{prof}, want {want}")
    # the checksums: each epoch's train-in is the previous train-out, and
    # the last train-out is kernel.opt's sums (each weight in the file is
    # rounded to 1e-15 by %17.15f, the printed sum to 1e-15 by %.15f)
    ins, outs = _dbg_sums(run["out"], "train-in"), \
        _dbg_sums(run["out"], "train-out")
    n_w = len(MNIST[1]) + 1
    if len(ins) != EPOCHS * n_w or len(outs) != EPOCHS * n_w \
            or ins[n_w:] != outs[:-n_w]:
        raise AssertionError(f"traced train_nn (phase 23): #DBG lines "
                             f"{ins} {outs}")
    with tempfile.NamedTemporaryFile("w", suffix=".opt") as fp:
        fp.write(run["opt"])
        fp.flush()
        weights = load_kernel(fp.name).weights
    dbg_err = []
    for (i, acc), w in zip(outs[-n_w:], weights):
        tol = w.size * 5e-16 + 1e-15
        dbg_err.append(abs(acc - float(np.sum(np.asarray(w, np.float64)))))
        if dbg_err[-1] > tol:
            raise AssertionError(f"traced train_nn (phase 23): #DBG W{i} "
                                 f"{acc!r} vs kernel.opt's sum, off by "
                                 f"{dbg_err[-1]:.3e} > {tol:.3e}")
    names = [s["name"] for s in spans]
    if names.count("train.epoch") != EPOCHS \
            or names.count("train_epoch") != EPOCHS:
        raise AssertionError(f"traced train_nn (phase 23): spans {names}")
    files = [os.path.join(prof_dir, n) for n in os.listdir(prof_dir)
             if n.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"train_nn --profile-dir (phase 23): {files}")
    kernels = _profile_kernels(files[0])
    b1 = [k for k in kernels if B1_NAME.search(k[0])]
    if len(b1) != EPOCHS:
        raise AssertionError(
            f"train_nn --profile-dir (phase 23): {len(b1)} events of "
            f"train_epoch_kernel, want {EPOCHS}; kernel names "
            f"{sorted({k[0] for k in kernels})[:8]}")
    return {"launches": run["launches"], "wall_s": run["wall_s"],
            "profiler": {k: records[0][k] for k in ("start_s", "seconds",
                                                    "stop_s")},
            "prof_phases": len(prof), "dbg_max_err": max(dbg_err),
            "spans": len(spans), "b1_name": b1[0][0],
            "b1_profile_us": [k[2] for k in b1],
            "phase16_epoch_device_ms": base["epoch_device_ms"],
            "kernel_events": len(kernels),
            "trace_bytes": os.path.getsize(files[0])}


def _obs_load(base, pool, rows_cycle, traced, seconds, during=None):
    """``OBS_CLIENTS`` closed-loop clients for ``seconds`` (traced: each
    request with its own ``X-HPNN-Trace-Id``), ``during()`` called half a
    second in; returns (answers, latencies, during's result).  Answers are
    (first row, rows, echoed trace id, outputs); any non-200 fails."""
    answers, lat, failures = [], [], []
    stop = threading.Event()

    def client(i):
        k = i
        while not stop.is_set():
            rows = rows_cycle[k % len(rows_cycle)]
            lo = (97 * k + 31 * i) % (SERVE_POOL - rows)
            k += 1
            hdr = {"X-HPNN-Trace-Id": f"req-{i}-{k}"} if traced else None
            t0 = time.time()
            st, body = _http(base, "/v1/kernels/mnist/infer",
                             {"inputs": pool[lo:lo + rows].tolist()}, hdr)
            t1 = time.time()
            if st != 200:
                failures.append((st, body))
                return
            answers.append((lo, rows, body.get("trace"),
                            np.asarray(body["outputs"], np.float64)))
            lat.append((t1 - t0, rows))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(OBS_CLIENTS)]
    out = None
    for t in threads:
        t.start()
    try:
        if during is not None:
            time.sleep(0.5)
            t0 = time.perf_counter()
            out = during()
            time.sleep(max(0.0, seconds - 0.5 - (time.perf_counter() - t0)))
        else:
            time.sleep(seconds)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    if any(t.is_alive() for t in threads) or failures:
        raise AssertionError(f"observability (phase 23): clients "
                             f"{failures[:3]}")
    return answers, lat, out


def _get_raw(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _tool_stdout(argv):
    """``python -m hpnn_tpu_torch.obs.tool`` in this process: (rc,
    stdout bytes)."""
    from hpnn_tpu_torch.obs import tool

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = tool.main(argv)
    return rc, out.getvalue().encode()


def phase_observability(e2e, epochs_runs, tmp, card):
    """Phase 23: the training run traced and profiled, a traced server
    with a live profile capture, a traced job, and what tracing costs."""
    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.obs import profiler
    from hpnn_tpu_torch.obs import trace as obs_trace
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.server import serve_in_thread

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "obs_phase")
    os.makedirs(root)
    served = os.path.join(root, "mnist.opt")
    _dump_generated(served, MNIST, 10958)
    conf = os.path.join(root, "mnist.conf")
    _serve_conf(conf, "mnist", served, MNIST, "f64")
    span_dir = os.path.join(root, "spans")
    pool = _inputs(np.random.default_rng(23), SERVE_POOL, MNIST[0], "pixel")
    with contextlib.redirect_stdout(io.StringIO()):
        app, _ = cli.serve_app([
            "-p", "0", "--device", "cuda", "--no-warmup", "-b", "64",
            "-q", str(64 * OBS_CLIENTS), "--trace", "--span-dir", span_dir,
            "--profile-dir", os.path.join(root, "serve_profile"),
            "--jobs", "1", "--job-dir", os.path.join(root, "jobs"), conf])
    if app is None or not obs_trace.enabled() or obs_trace.get_role() \
            != "local" or app.span_exporter is None:
        raise AssertionError("serve_nn --trace --span-dir (phase 23)")
    httpd, th = serve_in_thread(app, "127.0.0.1", 0)
    base = "http://%s:%d" % httpd.server_address[:2]
    res = {}
    try:
        # the 1-row client untraced, before any profile in this server
        obs_trace.disable()
        _, lat, _ = _obs_load(base, pool, (1,), False, OBS_COST_S)
        res["before_profiles_one_row_ms"] = {
            "p50": _pctl([s * 1e3 for s, _ in lat], 50),
            "p99": _pctl([s * 1e3 for s, _ in lat], 99), "n": len(lat)}
        # A: the training run traced and profiled, the server idle and
        # its spool detached
        obs_trace.set_exporter(None)
        t0 = time.perf_counter()
        res["train"] = _obs_train(e2e, epochs_runs, root)
        res["train_s"] = time.perf_counter() - t0
        obs_trace.enable()                 # the server's --trace again
        obs_trace.set_exporter(app.span_exporter)
        # B + C: traced clients, a live capture inside their window; the
        # wrapper's launches and the batches are read where the profiler
        # starts and stops
        marks = {}
        real_start, real_stop = profiler._start_trace, profiler._stop_trace

        def start_trace():
            prof = real_start()
            marks["start"] = (fused_linear_act.launches,
                              app.metrics.batches_total)
            return prof

        def stop_trace(prof, out_dir):
            marks["stop"] = (fused_linear_act.launches,
                             app.metrics.batches_total)
            return real_stop(prof, out_dir)

        profiler._start_trace, profiler._stop_trace = start_trace, stop_trace
        try:
            answers, lat, capture = _obs_load(
                base, pool, OBS_ROWS, True, OBS_LOAD_S, lambda: _http(
                    base, "/v1/debug/profile", {"seconds": OBS_PROFILE_S}))
        finally:
            profiler._start_trace, profiler._stop_trace = real_start, \
                real_stop
        if capture[0] != 200:
            raise AssertionError(f"POST /v1/debug/profile (phase 23): "
                                 f"{capture}")
        if profiler.active() is not None:
            raise AssertionError("profile capture (phase 23) left running")
        ref = _strict_pool(served, _dtypes()["f64"], pool)
        for lo, rows, tid, outs in answers:
            if not np.array_equal(outs, ref[lo:lo + rows]) or not tid:
                raise AssertionError(f"traced serving (phase 23): rows "
                                     f"{lo}:{lo + rows} ({tid}) not "
                                     "bit-identical to the strict forward")
        for _lo, _rows, tid, _outs in answers[::max(1, len(answers) // 8)]:
            st, raw = _get_raw(base, f"/v1/debug/trace?trace={tid}")
            spans = [json.loads(ln) for ln in raw.decode().splitlines()]
            roots = [s for s in spans if s["name"] == "serve.request"]
            kids = {s["name"] for s in spans
                    if roots and s["parent"] == roots[0]["span"]}
            if st != 200 or len(roots) != 1 or kids != OBS_TREE \
                    or len(spans) != len(OBS_TREE) + 1:
                raise AssertionError(f"/v1/debug/trace?trace={tid} (phase "
                                     f"23): {st} {[s['name'] for s in spans]}")
        kernels = _profile_kernels(capture[1]["trace_file"])
        b2 = [k for k in kernels if B2_NAME.search(k[0])]
        b2_sum = [k for k in kernels if B2_SUM.search(k[0])]
        l0, n0 = marks["start"]
        l1, n1 = marks["stop"]
        launches, batches = l1 - l0, n1 - n0
        # a batch's two layer launches may straddle the start or the stop
        if not (batches > 0 and abs(launches - 2 * batches) <= 2
                and abs(len(b2) - launches) <= 2):
            raise AssertionError(
                f"POST /v1/debug/profile (phase 23): {len(b2)} "
                f"fused_linear_act kernel events ({len(b2_sum)} stage "
                f"sums), the wrapper launched {launches} times over "
                f"{batches} batches; kernel names "
                f"{sorted({k[0] for k in kernels})[:8]}")
        # the capture started on the endpoint's handler thread holds the
        # batcher thread's host operators too (profile_all_threads), or
        # its record says why the installed torch cannot give them
        with open(capture[1]["trace_file"]) as fp:
            events = json.load(fp)["traceEvents"]
        batcher_tid = app.batchers["mnist"]._thread.native_id
        batcher_ops = sum(1 for e in events if e.get("cat") == "cpu_op"
                          and e.get("tid") == batcher_tid)
        threads = capture[1].get("threads")
        if threads == "all" and batcher_ops == 0:
            raise AssertionError(
                "POST /v1/debug/profile (phase 23): no cpu_op rows from "
                f"the batcher's thread {batcher_tid}")
        if threads != "all":
            log(f"observability (phase 23): the capture is {threads}")
        del events
        one = [s * 1e3 for s, r in lat if r == 1]
        res["serve"] = {
            "answers": len(answers),
            "one_row_ms": {"p50": _pctl(one, 50), "p99": _pctl(one, 99)},
            "profile": {"seconds": capture[1]["seconds"],
                        "start_s": capture[1]["start_s"],
                        "stop_s": capture[1]["stop_s"],
                        "b2_events": len(b2), "stage_sum_events":
                        len(b2_sum), "launches": launches,
                        "batches": batches,
                        "b2_names": sorted({k[0] for k in b2}),
                        "threads": threads,
                        "batcher_cpu_ops": batcher_ops,
                        "b2_us_per_batch": sum(k[2] for k in b2)
                        / max(1, batches),
                        "kernel_events": len(kernels),
                        "trace_bytes": os.path.getsize(
                            capture[1]["trace_file"])}}
        # the endpoints' bodies against the offline tool over the spool
        live = [_get_raw(base, "/v1/debug/trace/search?kernel=mnist")[1],
                _get_raw(base, "/v1/debug/trace/critical?kernel=mnist")[1],
                _get_raw(base, "/v1/debug/trace?timeline=1")[1]]
        offline = [_tool_stdout(["search", "--span-dir", span_dir,
                                 "--kernel", "mnist"]),
                   _tool_stdout(["critical", "--span-dir", span_dir,
                                 "--kernel", "mnist"]),
                   _tool_stdout(["timeline", "--span-dir", span_dir])]
        if [o for _, o in offline] != live or any(rc for rc, _ in offline):
            raise AssertionError("obs.tool (phase 23): the offline stdout "
                                 "differs from the endpoints' bodies")
        crit = json.loads(live[1])
        res["critical"] = {"traces": crit["traces_analyzed"],
                           "top_phase": crit["top_phase"],
                           "share_p99": {p: v["share_p99"] for p, v in
                                         crit["phases"].items()}}
        # D: a traced job of 2 epochs on 64 of phase 9's files
        samples = os.path.join(e2e["root"], "samples")
        jsrc = os.path.join(root, "job_samples")
        os.makedirs(jsrc)
        for n in sorted(os.listdir(samples))[:OBS_JOB_FILES]:
            shutil.copy(os.path.join(samples, n), jsrc)
        train_epoch_kernel.launches = 0
        t0 = time.perf_counter()
        st, job = _http(base, "/v1/kernels/mnist/train", {
            "epochs": OBS_JOB_EPOCHS, "seed": 10958, "train": "BP",
            "dtype": "f64", "hidden": MNIST[1], "samples": jsrc,
            "ckpt_every": 1})
        if st != 202 or job["status"] != "queued":
            raise AssertionError(f"traced job (phase 23): {st} {job}")
        jid = job["job_id"]
        done = _job_wait(base, jid)
        job_s = time.perf_counter() - t0
        if done["status"] != "done" \
                or train_epoch_kernel.launches != OBS_JOB_EPOCHS:
            raise AssertionError(f"traced job (phase 23): {done}, "
                                 f"{train_epoch_kernel.launches} launches")
        st, raw = _get_raw(base, f"/v1/debug/trace?trace=job:{jid}")
        spans = [json.loads(ln) for ln in raw.decode().splitlines()]
        byid = {s["span"]: s for s in spans}
        run = [s for s in spans if s["name"] == "jobs.run"]
        epochs = [s for s in spans if s["name"] == "train.epoch"
                  and run and s["parent"] == run[0]["span"]]
        under = {s["name"] for s in spans
                 if byid.get(s["parent"], {}).get("name") == "train.epoch"}
        if len(run) != 1 or len(epochs) != OBS_JOB_EPOCHS \
                or not {"ckpt.snapshot_write", "serve.hot_swap"} <= under:
            raise AssertionError(f"?trace=job:{jid} (phase 23): "
                                 f"{[s['name'] for s in spans]}")
        states = [(s["previous"], s["status"]) for s in spans
                  if s["name"] == "job.state"]
        st, raw = _get_raw(base, "/v1/debug/trace?trace=events")
        events = [json.loads(ln) for ln in raw.decode().splitlines()]
        st2, raw = _get_raw(base, "/v1/debug/trace?timeline=1")
        timeline = [(e["detail"]["previous"], e["detail"]["status"])
                    for e in map(json.loads, raw.decode().splitlines())
                    if e["name"] == "job.state"
                    and e["detail"].get("job") == jid]
        if st != 200 or st2 != 200 or timeline != states \
                or states[0] != ("", "queued") \
                or states[-1] != ("running", "done") \
                or not any(e["name"] == "event.job_slice_granted"
                           and e.get("job") == jid for e in events):
            raise AssertionError(f"job {jid} transitions (phase 23): "
                                 f"{states} / timeline {timeline} / "
                                 f"events {[e['name'] for e in events]}")
        res["job"] = {"seconds": job_s, "spans": len(spans),
                      "transitions": len(states),
                      "generations": done["generations"]}
        # E: what tracing costs the 1-row client: off, on (ring + spool),
        # head-sampled at 0.1 (seeded), in turns; no request carries an id
        cost = {}
        for mode in OBS_COST_MODES:
            if mode == "off":
                obs_trace.disable()
            else:
                obs_trace.enable()
                obs_trace.set_sample_rate(0.1 if mode != "on" else None,
                                          seed=23)
            n_spans = obs_trace.last_seq()
            answers, lat, _ = _obs_load(base, pool, (1,), False,
                                        OBS_COST_S)
            c = cost.setdefault(mode, {"ms": [], "traced": 0, "spans": 0,
                                       "windows_p50": []})
            ms = [s * 1e3 for s, _ in lat]
            c["ms"] += ms
            c["windows_p50"].append(_pctl(ms, 50))
            c["traced"] += sum(1 for a in answers if a[2])
            c["spans"] += obs_trace.last_seq() - n_spans \
                if mode != "off" else 0
            st = obs_trace.sample_stats()   # a fresh sampler a window
            if st is not None:
                c["sampled"] = c.get("sampled", 0) + st["sampled_total"]
                c["dropped"] = c.get("dropped", 0) + st["dropped_total"]
        for c in cost.values():
            ms = c.pop("ms")
            c.update(p50=_pctl(ms, 50), p99=_pctl(ms, 99), n=len(ms))
        res["cost_one_row_ms"] = cost
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close(drain=True)
        th.join(timeout=60)
        obs_trace.disable()
        obs_trace.set_sample_rate(None)
    res["seconds"] = time.perf_counter() - t_phase
    tr, sv = res["train"], res["serve"]
    bp = res["before_profiles_one_row_ms"]
    log(f"observability (phase 23): traced+profiled train_nn --epochs "
        f"{EPOCHS}: stream (less {tr['prof_phases']} #PROF and the #DBG "
        f"lines) and kernel.opt byte-identical to phase 16, train_epoch "
        f"launched {tr['launches']['train_epoch']} times, #DBG train-out "
        f"within {tr['dbg_max_err']:.2e} of kernel.opt's sums, "
        f"{tr['spans']} spans; the profile names {EPOCHS} "
        f"'{tr['b1_name']}' events; wall {tr['wall_s']:.2f} s, the "
        f"profiler's start {tr['profiler']['start_s']:.3f} s and stop "
        f"{tr['profiler']['stop_s']:.3f} s")
    log(f"observability (phase 23) times ({card}): B1 profiled "
        + ", ".join(f"{us / 1e3:.1f}" for us in tr["b1_profile_us"])
        + " ms an epoch (phase 16 events: "
        + ", ".join(f"{ms:.1f}" for ms in tr["phase16_epoch_device_ms"])
        + f" ms); 1-row p50/p99 before any profile {bp['p50']:.2f}/"
        f"{bp['p99']:.2f} ms (n={bp['n']}); traced serving "
        f"{sv['answers']} answers bit-identical, "
        f"trees complete, 1-row p50/p99 {sv['one_row_ms']['p50']:.2f}/"
        f"{sv['one_row_ms']['p99']:.2f} ms; live capture "
        f"{sv['profile']['seconds']:.2f} s (start "
        f"{sv['profile']['start_s']:.3f} s, stop "
        f"{sv['profile']['stop_s']:.3f} s): {sv['profile']['b2_events']} "
        f"fused_linear_act events ({sv['profile']['stage_sum_events']} "
        f"stage sums) for {sv['profile']['launches']} launches over "
        f"{sv['profile']['batches']} batches, "
        f"{sv['profile']['b2_us_per_batch']:.1f} us a batch, "
        f"{sv['profile']['batcher_cpu_ops']} cpu_op rows from the "
        f"batcher's thread (threads: {sv['profile']['threads']}); obs.tool "
        "search/critical/timeline == the endpoints; critical top phase "
        f"{res['critical']['top_phase']}; job {res['job']['seconds']:.2f} s,"
        f" {res['job']['transitions']} transitions; tracing cost 1-row "
        "p50/p99 " + ", ".join(
            f"{m} {c['p50']:.2f}/{c['p99']:.2f} ms (n={c['n']}; window "
            f"p50s " + "/".join(f"{v:.2f}" for v in c["windows_p50"]) + ")"
            for m, c in res["cost_one_row_ms"].items())
        + f"; phase {res['seconds']:.1f} s")
    return res


MESH_CLIENTS = 8            # phase 24: closed-loop client threads
MESH_ROWS = (1, 64)         # phase 24: request sizes, alternated
MESH_LAT_S = 2.0            # phase 24: each 1-row latency window
MESH_LOAD_S = 2.0           # phase 24: each mixed window (reload, kill)
MESH_QUOTA_SHARE = 3.0      # phase 24: --quota-rows = plain rows/s / this
MESH_QUOTA_BURST = 256.0    # phase 24: --quota-burst
MESH_NINTH = 32             # phase 24: the over-quota key's threads
MESH_RPCS = 200             # phase 24: keep-alive RPCs a NODELAY turn
MESH_HEARTBEAT_S = "0.3"    # phase 24: HPNN_MESH_HEARTBEAT_S


def _mesh_load(base, pool, rows_cycle, seconds, during=None,
               clients=MESH_CLIENTS, key="load"):
    """``clients`` closed-loop clients for ``seconds``, each with its own
    ``X-HPNN-Client`` (``<key>-<i>``); ``during()`` is called half a second
    in, and the load goes on at least a second after it returns.  Returns (answers, latencies, failures, during's result); an
    answer is (first row, rows, generation, outputs, request start)."""
    answers, lat, failures = [], [], []
    stop = threading.Event()

    def client(i):
        k = i
        hdr = {"X-HPNN-Client": f"{key}-{i}"}
        while not stop.is_set():
            rows = rows_cycle[k % len(rows_cycle)]
            lo = (97 * k + 31 * i) % (SERVE_POOL - rows)
            k += 1
            t0 = time.monotonic()
            st, body = _http(base, "/v1/kernels/mnist/infer",
                             {"inputs": pool[lo:lo + rows].tolist()}, hdr)
            t1 = time.monotonic()
            if st != 200:
                failures.append((st, body))
                continue
            answers.append((lo, rows, body["generation"],
                            np.asarray(body["outputs"], np.float64), t0))
            lat.append((t1 - t0, rows))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    out = None
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    try:
        if during is not None:
            time.sleep(0.5)
            out = during()
            seconds = max(seconds, time.perf_counter() - t_start + 1.0)
        time.sleep(max(0.0, seconds - (time.perf_counter() - t_start)))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    if any(t.is_alive() for t in threads):
        raise AssertionError("serve mesh (phase 24): a client hung")
    return answers, lat, failures, out


def _mesh_check(tag, answers, failures, refs):
    """Every reply 200 and bit-identical to the strict forward of the
    generation it names (a reply mixing two generations matches
    neither)."""
    if failures:
        raise AssertionError(f"serve mesh (phase 24) {tag}: "
                             f"{len(failures)} non-200 replies, e.g. "
                             f"{failures[:2]}")
    for lo, rows, gen, outs, _t in answers:
        ref = refs.get(gen)
        if ref is None or not np.array_equal(outs, ref[lo:lo + rows]):
            raise AssertionError(f"serve mesh (phase 24) {tag}: rows "
                                 f"{lo}:{lo + rows} of generation {gen} "
                                 "not bit-identical to its strict forward")


def _lat_stats(lat, seconds):
    ms = [s * 1e3 for s, _ in lat]
    return {"p50": _pctl(ms, 50), "p99": _pctl(ms, 99), "n": len(ms),
            "rps": len(ms) / seconds}


def _mesh_table(base):
    st, tbl = _http(base, "/v1/mesh/workers", None, method="GET")
    if st != 200:
        raise AssertionError(f"GET /v1/mesh/workers (phase 24): {st}")
    return tbl


def _mesh_wait(base, pred, what, timeout_s=120.0):
    """Poll the router's worker table until ``pred(table)``; returns the
    seconds it took."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if pred(_mesh_table(base)):
            return time.monotonic() - t0
        time.sleep(0.05)
    raise AssertionError(f"serve mesh (phase 24): {what} not within "
                         f"{timeout_s:.0f} s: {_mesh_table(base)}")


def _mesh_worker_proc(wdir, router, env, device):
    """``serve_nn --mesh-role worker`` as a process of its own in
    ``wdir`` (its conf and kernel there)."""
    logf = open(os.path.join(wdir, "serve_nn.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "hpnn_tpu_torch.cli", "serve_nn", "-p", "0",
         "--device", device, "--no-warmup", "-b", "64", "-q",
         str(64 * MESH_CLIENTS), "--mesh-role", "worker", "--router",
         router, "--require-router", "mnist.conf"],
        cwd=wdir, stdout=logf, stderr=subprocess.STDOUT, env=env)
    proc.log_file = logf
    return proc


def _mesh_nodelay(addr, body, token):
    """Keep-alive RPCs straight to worker A, with and without
    TCP_NODELAY on the client socket, in turns: p50/p99 ms each."""
    from hpnn_tpu_torch.serve.mesh import transport

    hdr = {"Content-Type": "application/json", "X-HPNN-Router": token}
    out = {}
    for nodelay in (False, True, False, True):
        pool = transport.ConnectionPool(enabled=True, nodelay=nodelay)
        ms = []
        try:
            for _ in range(MESH_RPCS):
                t0 = time.perf_counter()
                st, _raw, _ = transport.request(
                    addr, "POST", "/v1/kernels/mnist/infer", body=body,
                    headers=hdr, timeout_s=30.0, pool=pool)
                ms.append((time.perf_counter() - t0) * 1e3)
                if st != 200:
                    raise AssertionError(f"keep-alive RPC (phase 24): {st}")
        finally:
            pool.close()
        out.setdefault("nodelay" if nodelay else "default", []).extend(
            ms[10:])
    return {k: {"p50": _pctl(v, 50), "p99": _pctl(v, 99), "n": len(v)}
            for k, v in out.items()}


def phase_mesh(tmp, card, device="cuda"):
    """Phase 24: the serve mesh on the card.  A router (in process) with
    SLOs and quotas over worker A (in process: its ``fused_linear_act``
    launches are read off the wrapper) and worker B (a process of its
    own); 8 closed-loop clients of 1 and 64 rows with their own client
    keys; a fleet-coherent reload under load, B killed under load, worker
    C catching up from the router's blob, a ninth key over its quota."""
    import torch

    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.obs import trace as obs_trace
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.server import serve_in_thread

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "mesh_phase")
    router_only = os.path.join(root, "router_only")
    os.makedirs(router_only)
    gen1 = os.path.join(root, "mesh1.opt")
    gen2 = os.path.join(router_only, "mesh2.opt")
    _dump_generated(gen1, MNIST, 24)
    _dump_generated(gen2, MNIST, 2424)
    conf = os.path.join(root, "mnist.conf")
    _serve_conf(conf, "mnist", gen1, MNIST, "f64")
    wdirs = {}
    for w in ("A", "B", "C"):
        d = wdirs[w] = os.path.join(root, f"worker{w}")
        os.makedirs(d)
        shutil.copy(gen1, os.path.join(d, "mnist.opt"))
        _serve_conf(os.path.join(d, "mnist.conf"), "mnist",
                    os.path.join(d, "mnist.opt"), MNIST, "f64")
    pool = _inputs(np.random.default_rng(24), SERVE_POOL, MNIST[0], "pixel")
    refs = {1: _strict_pool(gen1, torch.float64, pool),
            2: _strict_pool(gen2, torch.float64, pool)}
    with open(gen2, "rb") as fp:
        gen2_sha = hashlib.sha256(fp.read()).hexdigest()
    env_keep = {k: os.environ.get(k) for k in ("HPNN_MESH_HEARTBEAT_S",
                                               "HPNN_MESH_SWARM")}
    # short heartbeats; the swarm off, so a catch-up reads the router's
    # blob and no peer's
    os.environ.update(HPNN_MESH_HEARTBEAT_S=MESH_HEARTBEAT_S,
                      HPNN_MESH_SWARM="0")
    wenv = dict(os.environ, PYTHONPATH=ROOT)
    res, procs, servers = {}, {}, []
    serve_args = ["-p", "0", "--device", device, "--no-warmup", "-b", "64",
                  "-q", str(64 * MESH_CLIENTS)]
    try:
        # (a) the plain server on the same kernel: 8 clients of 1 row,
        # then of 1 and 64 rows; the quota is a share of the rows a second
        # it served those, so that one load key stays far under it and a
        # ninth key flooding the router alone goes over
        with contextlib.redirect_stdout(io.StringIO()):
            plain, _ = cli.serve_app([*serve_args, conf])
        httpd, th = serve_in_thread(plain, "127.0.0.1", 0)
        pbase = "http://%s:%d" % httpd.server_address[:2]
        try:
            answers, lat, failures, _ = _mesh_load(pbase, pool, (1,),
                                                   MESH_LAT_S)
            _mesh_check("plain", answers, failures, refs)
            res["plain_one_row"] = _lat_stats(lat, MESH_LAT_S)
            answers, lat, failures, _ = _mesh_load(pbase, pool, MESH_ROWS,
                                                   MESH_LAT_S / 2)
            _mesh_check("plain", answers, failures, refs)
        finally:
            httpd.shutdown()
            httpd.server_close()
            plain.close(drain=True)
        res["plain_mixed_rows_per_s"] = sum(r for _, r in lat) \
            / (MESH_LAT_S / 2)
        res["quota_rows"] = max(64.0, res["plain_mixed_rows_per_s"]
                                / MESH_QUOTA_SHARE)
        # the router and worker A; fused_linear_act counts A's launches
        # from here (the router launches nothing: its backend is remote)
        fused_linear_act.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            router, _ = cli.serve_app([
                *serve_args, "--mesh-role", "router", "--workers", "2",
                "--mesh-health-interval", "0.2", "--slo-p99-ms", "500",
                "--slo-availability", "0.99",
                "--quota-rows", f"{res['quota_rows']:.1f}",
                "--quota-burst", str(MESH_QUOTA_BURST), conf])
        rhttpd, _ = serve_in_thread(router, "127.0.0.1", 0)
        servers.append((rhttpd, router))
        raddr = "%s:%d" % rhttpd.server_address[:2]
        base = f"http://{raddr}"
        with contextlib.redirect_stdout(io.StringIO()):
            wa, wa_args = cli.serve_app([
                *serve_args, "--mesh-role", "worker", "--router", raddr,
                "--require-router", os.path.join(wdirs["A"], "mnist.conf")])
        ahttpd, _ = serve_in_thread(wa, "127.0.0.1", 0)
        servers.append((ahttpd, wa))
        aaddr = "%s:%d" % ahttpd.server_address[:2]
        with contextlib.redirect_stdout(io.StringIO()):
            cli.start_mesh_worker(wa, wa_args, ahttpd.server_address[1])
        _mesh_wait(base, lambda t: t["live"] == 1, "worker A live")
        # (b) the router with one worker
        answers, lat, failures, _ = _mesh_load(base, pool, (1,),
                                               MESH_LAT_S)
        _mesh_check("one worker", answers, failures, refs)
        res["router_one_worker_one_row"] = _lat_stats(lat, MESH_LAT_S)
        # worker B joins, a process of its own
        t0 = time.monotonic()
        procs["B"] = _mesh_worker_proc(wdirs["B"], raddr, wenv, device)
        _mesh_wait(base, lambda t: t["live"] == 2, "worker B live")
        res["worker_b_start_to_registered_s"] = time.monotonic() - t0
        baddr = next(a for a in _mesh_table(base)["workers"]
                     if a != aaddr)
        # (c) the router with two
        answers, lat, failures, _ = _mesh_load(base, pool, (1,),
                                               MESH_LAT_S)
        _mesh_check("two workers", answers, failures, refs)
        res["router_two_workers_one_row"] = _lat_stats(lat, MESH_LAT_S)
        # a keep-alive RPC's latency with and without TCP_NODELAY
        res["rpc_ms"] = _mesh_nodelay(
            aaddr, json.dumps({"inputs": pool[:1].tolist()}).encode(),
            router.mesh_router.router_token)
        # a fleet-coherent reload of the second kernel under load
        reload_res = {}

        def do_reload():
            t0 = time.perf_counter()
            reload_res["reply"] = _http(base, "/v1/kernels/mnist/reload",
                                        {"kernel": gen2})
            reload_res["s"] = time.perf_counter() - t0
            reload_res["done"] = time.monotonic()

        answers, lat, failures, _ = _mesh_load(base, pool, MESH_ROWS,
                                               MESH_LOAD_S, do_reload)
        st, rb = reload_res["reply"]
        if st != 200 or rb["generation"] != 2 \
                or rb["mesh"]["workers_failed"] \
                or len(rb["mesh"]["workers_reloaded"]) != 2:
            raise AssertionError(f"mesh reload (phase 24): {st} {rb}")
        _mesh_check("reload", answers, failures, refs)
        late = [a for a in answers if a[4] > reload_res["done"]]
        if not late or any(a[2] != 2 for a in late):
            raise AssertionError("mesh reload (phase 24): a request sent "
                                 "after the reload returned was not "
                                 "served by generation 2")
        res["reload"] = {"s": reload_res["s"], "answers": len(answers),
                         "gen1": sum(1 for a in answers if a[2] == 1),
                         "gen2": sum(1 for a in answers if a[2] == 2),
                         "blob": rb["mesh"]["blob"]}
        if rb["mesh"]["blob"]["sha256"] != gen2_sha:
            raise AssertionError(f"mesh reload (phase 24): blob {rb}")
        # the second kernel's file leaves the host's shared view: a later
        # worker can only have it from the router's blob
        os.rename(router_only, router_only + ".gone")
        # worker B killed under load
        kill = {}

        def do_kill():
            kill["t"] = time.monotonic()
            procs["B"].kill()
            procs["B"].wait(timeout=60)

        answers, lat, failures, _ = _mesh_load(base, pool, MESH_ROWS,
                                               MESH_LOAD_S, do_kill)
        _mesh_check("kill", answers, failures, refs)
        if any(a[2] != 2 for a in answers):
            raise AssertionError("mesh kill (phase 24): a generation-1 "
                                 "reply after the reload")
        _mesh_wait(base, lambda t: t["workers"][baddr]["state"] == "dead",
                   "worker B ejected", timeout_s=10.0)
        res["kill"] = {"answers": len(answers),
                       "failovers": router.mesh_router.pool.failovers_total}
        # worker C: only the first generation's files in its dir; it
        # registers and catches up from the router's blob
        serves0 = router.mesh_router.blobs.stats()["serves_total"]
        cblobs = os.path.join(wdirs["C"], "blobs")
        t0 = time.monotonic()
        procs["C"] = _mesh_worker_proc(
            wdirs["C"], raddr, dict(wenv, HPNN_MESH_BLOB_DIR=cblobs), device)

        def c_current(t):
            rows = [w for a, w in t["workers"].items()
                    if a not in (aaddr, baddr)]
            return bool(rows) and rows[0]["state"] == "live" and \
                rows[0]["kernels"].get("mnist", {}).get("generation") == 2

        _mesh_wait(base, c_current, "worker C caught up")
        res["worker_c_catch_up_s"] = time.monotonic() - t0
        caddr = next(a for a in _mesh_table(base)["workers"]
                     if a not in (aaddr, baddr))
        landed = os.path.join(cblobs, f"{gen2_sha}.opt")
        with open(landed, "rb") as fp:
            if hashlib.sha256(fp.read()).hexdigest() != gen2_sha:
                raise AssertionError("worker C (phase 24): its blob does "
                                     "not hash to the broadcast sha")
        if router.mesh_router.blobs.stats()["serves_total"] != serves0 + 1:
            raise AssertionError("worker C (phase 24): not one blob GET "
                                 "from the router")
        routed0 = _mesh_table(base)["workers"][caddr]["routed"]
        answers, lat, failures, _ = _mesh_load(base, pool, MESH_ROWS,
                                               MESH_LOAD_S / 2)
        _mesh_check("catch-up", answers, failures, refs)
        if _mesh_table(base)["workers"][caddr]["routed"] <= routed0:
            raise AssertionError("worker C (phase 24) served no batch")
        # a ninth key over its quota
        ninth = []
        t_over = time.monotonic() + 10.0
        body64 = json.dumps({"inputs": pool[:64].tolist()}).encode()

        def over():
            while time.monotonic() < t_over:
                req = urllib.request.Request(
                    base + "/v1/kernels/mnist/infer", data=body64,
                    headers={"X-HPNN-Client": "ninth"})
                try:
                    with urllib.request.urlopen(req, timeout=120) as r:
                        r.read()
                        ninth.append((r.status, None, None))
                except urllib.error.HTTPError as exc:
                    reason = json.loads(exc.read()).get("reason")
                    ninth.append((exc.code, reason,
                                  exc.headers.get("Retry-After")))
                    return

        threads = [threading.Thread(target=over) for _ in range(MESH_NINTH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        refused = [n for n in ninth if n[0] != 200]
        if not refused or any(n[:2] != (429, "quota_exceeded") or not n[2]
                              for n in refused):
            raise AssertionError(f"quota (phase 24): the ninth key "
                                 f"{refused[:3]} after "
                                 f"{len(ninth) - len(refused)} 200s")
        res["quota"] = {"ninth_ok": len(ninth) - len(refused),
                        "ninth_429": len(refused),
                        "retry_after": sorted({n[2] for n in refused})}
        # the gauges
        _st, hz = _http(base, "/healthz", None, method="GET")
        snap = router.metrics.snapshot()
        text = router.metrics.render_prometheus()
        if not {"slo_burning", "shed_engaged", "mesh"} <= set(hz) \
                or not {"slo", "quota", "autoscale", "mesh"} <= set(snap) \
                or not all(f in text for f in (
                    "hpnn_slo_burn_rate", "hpnn_serve_quota_clients",
                    "hpnn_serve_desired_workers", "hpnn_mesh_workers")):
            raise AssertionError(f"gauges (phase 24): {sorted(hz)} "
                                 f"{sorted(snap)}")
        res["router_phases_ms"] = {p: {"p50": h["p50_ms"], "p99": h["p99_ms"]}
                                   for p, h in snap["phases"].items()}
        res["autoscale"] = snap["autoscale"]
        res["slo"] = snap["slo"]["kernels"]
        res["routed"] = {w: r["routed"]
                         for w, r in _mesh_table(base)["workers"].items()}
        # worker A's launches: exactly 2 a batch it served
        res["worker_a"] = {"launches": fused_linear_act.launches,
                           "batches": wa.metrics.batches_total}
        if res["worker_a"]["launches"] != 2 * res["worker_a"]["batches"] \
                or res["worker_a"]["batches"] <= 0:
            raise AssertionError(f"worker A (phase 24): {res['worker_a']}")
        res["router_batches"] = router.metrics.batches_total
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()   # a graceful drain: the goodbye
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            proc.log_file.close()
        for httpd, app in reversed(servers):
            httpd.shutdown()
            httpd.server_close()
            app.close(drain=True)
        obs_trace.set_role(None)
        for k, v in env_keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    res["seconds"] = time.perf_counter() - t_phase
    one = ", ".join(
        f"{tag} p50/p99 {r['p50']:.2f}/{r['p99']:.2f} ms, "
        f"{r['rps']:.0f} req/s (n={r['n']})"
        for tag, r in (("plain", res["plain_one_row"]),
                       ("router+1", res["router_one_worker_one_row"]),
                       ("router+2", res["router_two_workers_one_row"])))
    log(f"serve mesh (phase 24) ({card}): 8 clients of 1 row: {one}")
    log(f"serve mesh (phase 24) ({card}): router phases p50/p99 ms "
        + ", ".join(f"{p} {v['p50']:.3f}/{v['p99']:.3f}"
                    for p, v in sorted(res["router_phases_ms"].items()))
        + "; keep-alive RPC to worker A p50/p99 ms "
        + ", ".join(f"{k} {v['p50']:.3f}/{v['p99']:.3f}"
                    for k, v in res["rpc_ms"].items()))
    log(f"serve mesh (phase 24): worker B start-to-registered "
        f"{res['worker_b_start_to_registered_s']:.2f} s; reload "
        f"{res['reload']['s']:.3f} s under load ({res['reload']['gen1']} "
        f"gen-1 + {res['reload']['gen2']} gen-2 replies, each "
        "bit-identical to its generation's strict forward); B killed "
        f"under load: {res['kill']['answers']} replies, 0 non-200, "
        f"{res['kill']['failovers']} failover(s); worker C caught up from "
        f"the router's blob in {res['worker_c_catch_up_s']:.2f} s; ninth "
        f"key 429 quota_exceeded after {res['quota']['ninth_ok']} 200s "
        f"(Retry-After {res['quota']['retry_after']}; --quota-rows "
        f"{res['quota_rows']:.1f} = plain 1+64-row "
        f"{res['plain_mixed_rows_per_s']:.0f} rows/s / {MESH_QUOTA_SHARE:g},"
        f" --quota-burst {MESH_QUOTA_BURST:g}); routed "
        f"{res['routed']}; worker A fused_linear_act "
        f"{res['worker_a']['launches']} launches = 2 x "
        f"{res['worker_a']['batches']} batches; phase "
        f"{res['seconds']:.1f} s")
    return res


# --- phase 25: the standby router and the autoscaler -----------------------

SBY_CLIENTS = 8             # phase 25: closed-loop clients of 1 row
SBY_TAKEOVER_AFTER = 2      # phase 25: --takeover-after
SBY_POLL_S = "0.2"          # phase 25: HPNN_MESH_STANDBY_POLL_S
SBY_COOLDOWN_S = 2.0        # phase 25: --autoscale-cooldown
SBY_LOAD_S = 2.0            # phase 25: the load after the takeover


def _free_port() -> int:
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        return so.getsockname()[1]


def _failover_load(bases, pool, seconds, during, ready):
    """``SBY_CLIENTS`` closed-loop clients of 1 row against ``bases[0]``;
    ``during()`` is called half a second in (it kills the primary).  A
    request that fails (no connection, or a 503) is retried ONCE against
    ``bases[1]`` after ``ready()``, and the client stays there: the
    documented client contract of a router pair.  Returns (answers,
    failures, retries, the monotonic time of the first 200 from
    ``bases[1]``)."""
    import http.client

    answers, failures, retries, first = [], [], [], []
    stop = threading.Event()

    def post(base, lo):
        try:
            return _http(base, "/v1/kernels/mnist/infer",
                         {"inputs": pool[lo:lo + 1].tolist()})
        except (OSError, http.client.HTTPException) as exc:
            return -1, repr(exc)

    def client(i):
        base, k = bases[0], i
        while not stop.is_set():
            lo = (97 * k + 31 * i) % (SERVE_POOL - 1)
            k += 1
            st, body = post(base, lo)
            if st != 200 and base == bases[0] and st in (-1, 503):
                ready()
                base = bases[1]
                st, body = post(base, lo)
                retries.append((i, st))
            if st != 200:
                failures.append((base, st, body))
                continue
            if base == bases[1] and not first:
                first.append(time.monotonic())
            answers.append((lo, 1, body["generation"],
                            np.asarray(body["outputs"], np.float64), 0.0))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SBY_CLIENTS)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.5)
        during()
        time.sleep(seconds)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    if any(t.is_alive() for t in threads):
        raise AssertionError("standby (phase 25): a client hung")
    return answers, failures, retries, first[0] if first else None


def phase_standby_autoscale(tmp, card, device="cuda"):
    """Phase 25: a primary router (``--standby``, ``--autoscale 1:2``),
    its passive standby and worker A in process on the card, serving the
    generated MNIST 784-300-10 ANN f64 kernel at ``-b 64``.  A backlog of 8
    closed-loop clients of 1 row makes the supervisor spawn worker D (a
    ``hpnn_tpu_torch.cli`` process on the card); the load stops and D is
    retired by drain, then SIGTERM; then the primary's listener is closed
    under load, the standby takes over after ``--takeover-after`` missed
    polls, every failed request succeeds on one retry against it, and
    worker A's heartbeat follows.  Every reply bit-identical to the strict
    forward; worker A's ``fused_linear_act`` 2 launches a batch, the
    routers' none."""
    import torch

    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.obs import trace as obs_trace
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.server import serve_in_thread

    t_phase = time.perf_counter()
    parts, t_part = {}, [time.monotonic()]

    def done(name):
        now = time.monotonic()
        parts[name] = now - t_part[0]
        t_part[0] = now

    root = os.path.join(tmp, "standby_phase")
    os.makedirs(root)
    gen1 = os.path.join(root, "mnist.opt")
    _dump_generated(gen1, MNIST, 24)
    conf = os.path.join(root, "mnist.conf")
    _serve_conf(conf, "mnist", gen1, MNIST, "f64")
    pool = _inputs(np.random.default_rng(25), SERVE_POOL, MNIST[0], "pixel")
    refs = {1: _strict_pool(gen1, torch.float64, pool)}
    env = {"HPNN_MESH_HEARTBEAT_S": MESH_HEARTBEAT_S, "HPNN_MESH_SWARM": "0",
           "HPNN_MESH_STANDBY_POLL_S": SBY_POLL_S,
           "HPNN_AUTOSCALE_POLL_S": "0.2",
           # any backlog asks for the second worker: the card drains a
           # queued row in far less than the default 1 s target
           "HPNN_MESH_TARGET_DRAIN_S": "1e-6"}
    env_keep = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    serve_args = ["-p", "0", "--device", device, "--no-warmup", "-b", "64",
                  "-q", str(64 * MESH_CLIENTS)]
    res, servers = {}, []
    sport = _free_port()
    saddr = f"127.0.0.1:{sport}"
    spawned = {}
    try:
        fused_linear_act.launches = 0       # worker A's from here
        with contextlib.redirect_stdout(io.StringIO()):
            primary, pargs = cli.serve_app([
                *serve_args, "--mesh-role", "router", "--workers", "1",
                "--mesh-health-interval", "0.2", "--standby", saddr,
                "--autoscale", "1:2", "--autoscale-cooldown",
                str(SBY_COOLDOWN_S), conf])
        phttpd, _ = serve_in_thread(primary, "127.0.0.1", 0)
        servers.append((phttpd, primary))
        pport = phttpd.server_address[1]
        paddr, pbase = f"127.0.0.1:{pport}", f"http://127.0.0.1:{pport}"
        with contextlib.redirect_stdout(io.StringIO()):
            standby, sargs = cli.serve_app([
                *serve_args, "--mesh-role", "standby", "--primary", paddr,
                "--takeover-after", str(SBY_TAKEOVER_AFTER),
                "--mesh-health-interval", "0.2", conf])
        shttpd, _ = serve_in_thread(standby, "127.0.0.1", sport)
        servers.append((shttpd, standby))
        with contextlib.redirect_stdout(io.StringIO()):
            cli.start_mesh(standby, sargs, sport)
            wa, wa_args = cli.serve_app([*serve_args, "--mesh-role",
                                         "worker", "--router", paddr, conf])
        ahttpd, _ = serve_in_thread(wa, "127.0.0.1", 0)
        servers.append((ahttpd, wa))
        aaddr = "127.0.0.1:%d" % ahttpd.server_address[1]
        with contextlib.redirect_stdout(io.StringIO()):
            cli.start_mesh_worker(wa, wa_args, ahttpd.server_address[1])
        _mesh_wait(pbase, lambda t: t["live"] == 1, "worker A live")
        # the supervisor after A: at its floor of 1 it spawns nothing
        # until a backlog asks for a second worker
        with contextlib.redirect_stdout(io.StringIO()):
            cli.start_mesh(primary, pargs, pport)
        sup = primary.autoscaler
        spawn = sup._spawn_subprocess
        done("servers")

        def timed_spawn():
            spawned["t0"] = time.monotonic()
            m = spawned["managed"] = spawn()
            return m

        sup._spawn_subprocess = timed_spawn

        def d_live():
            t_end = time.monotonic() + 180.0
            while time.monotonic() < t_end:
                tbl = _mesh_table(pbase)["workers"]
                live = [a for a, w in tbl.items()
                        if a != aaddr and w["state"] == "live"]
                if live:
                    spawned["live_t"] = time.monotonic()
                    return live[0]
                time.sleep(0.05)
            raise AssertionError("autoscale (phase 25): worker D never "
                                 f"registered: {sup.snapshot()}")

        # (1) the backlog spawns worker D
        answers, lat, failures, daddr = _mesh_load(pbase, pool, (1,),
                                                   1.0, d_live)
        _mesh_check("autoscale spawn", answers, failures, refs)
        if sup.spawns_total != 1 or "managed" not in spawned:
            raise AssertionError(f"autoscale (phase 25): {sup.snapshot()}")
        proc = spawned["managed"].proc
        cmd = proc.args
        if cmd[1:5] != ["-u", "-m", "hpnn_tpu_torch.cli", "serve_nn"] \
                or cmd[cmd.index("--device") + 1] != device:
            raise AssertionError(f"autoscale (phase 25): spawned {cmd}")
        res["spawn_to_registered_s"] = spawned["live_t"] - spawned["t0"]
        res["d_routed"] = _mesh_table(pbase)["workers"][daddr]["routed"]
        done("spawn")
        res["backlog_answers"] = len(answers)
        # (2) the load stops: D retired by drain, then SIGTERM
        t0 = time.monotonic()
        _mesh_wait(pbase, lambda t: daddr not in t["workers"],
                   "worker D retired")
        res["retire_s"] = time.monotonic() - t0
        if sup.retires_total != 1 or proc.wait(timeout=60) != 0:
            raise AssertionError(f"autoscale (phase 25): retire "
                                 f"{sup.snapshot()}, rc {proc.returncode}")
        res["supervisor"] = sup.snapshot()
        _mesh_wait(f"http://{saddr}", lambda t: aaddr in t["workers"],
                   "the standby's mirror of worker A")
        done("retire")

        # (3) the primary's listener closed under load; (4) one retry
        death = {}

        def kill_primary():
            death["t"] = time.monotonic()
            phttpd.shutdown()
            phttpd.abort_connections()
            phttpd.server_close()
            primary.close(drain=False)

        def standby_ready():
            t_end = time.monotonic() + 60.0
            while time.monotonic() < t_end:
                try:
                    st, _ = _http(f"http://{saddr}", "/healthz", None,
                                  method="GET")
                except OSError:
                    st = -1
                if st == 200:
                    return
                time.sleep(0.02)
            raise AssertionError("standby (phase 25): never ready")

        answers, failures, retries, first = _failover_load(
            (pbase, f"http://{saddr}"), pool, SBY_LOAD_S, kill_primary,
            standby_ready)
        servers.remove((phttpd, primary))
        _mesh_check("takeover", answers, failures, refs)
        mon = standby.mesh_standby
        if mon.passive or mon.takeovers_total != 1 or first is None \
                or any(st != 200 for _, st in retries):
            raise AssertionError(f"standby (phase 25): {mon.info()}, "
                                 f"retries {retries[:4]}")
        agent = wa.mesh_worker
        t_end = time.monotonic() + 30.0
        while (agent.current != saddr or not agent.registered) \
                and time.monotonic() < t_end:
            time.sleep(0.05)
        if agent.current != saddr or not agent.registered:
            raise AssertionError("worker A (phase 25): its heartbeat did "
                                 f"not follow the standby: {agent.info()}")
        res["takeover"] = {"death_to_first_200_s": first - death["t"],
                           "answers": len(answers),
                           "retries": len(retries),
                           "misses": mon.misses,
                           "takeover_after": mon.takeover_after}
        res["worker_a"] = {"launches": fused_linear_act.launches,
                           "batches": wa.metrics.batches_total}
        if res["worker_a"]["launches"] != 2 * res["worker_a"]["batches"] \
                or res["worker_a"]["batches"] <= 0:
            raise AssertionError(f"worker A (phase 25): {res['worker_a']}")
        res["router_batches"] = {"primary": primary.metrics.batches_total,
                                 "standby": standby.metrics.batches_total}
        done("takeover")
    finally:
        managed = spawned.get("managed")
        if managed is not None and managed.proc.poll() is None:
            managed.proc.kill()
            managed.proc.wait()
        for httpd, app in reversed(servers):
            httpd.shutdown()
            httpd.server_close()
            app.close(drain=True)
        obs_trace.set_role(None)
        for k, v in env_keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    done("teardown")
    res["part_wall_s"] = parts
    res["seconds"] = time.perf_counter() - t_phase
    tk = res["takeover"]
    log(f"standby + autoscale (phase 25) ({card}): worker D spawn-to-"
        f"registered {res['spawn_to_registered_s']:.2f} s (routed "
        f"{res['d_routed']} batches), retired by drain then SIGTERM "
        f"{res['retire_s']:.2f} s after the load stopped, 0 non-200 in "
        f"{res['backlog_answers']} replies; primary closed under load: "
        f"standby's first 200 {tk['death_to_first_200_s']:.3f} s after, "
        f"{tk['retries']} requests retried once, {tk['answers']} replies "
        f"bit-identical to the strict forward; worker A fused_linear_act "
        f"{res['worker_a']['launches']} launches = 2 x "
        f"{res['worker_a']['batches']} batches; phase "
        f"{res['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return res


# --- phase 26: the host-streamed shard mode ---------------------------------

SHARD_ROW_BYTES = (MNIST[0] + MNIST[2]) * 8    # 6,352 bytes a f64 row
# (tag, train_nn arguments, environment, kernel, launches an epoch, the
# phase-16 run it equals)
SHARD_RUNS = (
    ("per sample, 128-row shards", (), {"HPNN_EPOCH_SHARD_ROWS": "128"},
     "train_epoch", 4, "per-sample"),
    ("per sample, 1 MiB budget", (), {"HPNN_EPOCH_DEVICE_BUDGET_MB": "1"},
     "train_epoch", 7, "per-sample"),
    (f"tile {TRAIN_TILE}, 128-row shards", ("--tile", str(TRAIN_TILE)),
     {"HPNN_EPOCH_SHARD_ROWS": "128"}, "train_tile", 4,
     f"tile {TRAIN_TILE}"))


def phase_shard(e2e, epochs_runs):
    """Phase 26: ``train_nn --epochs 3`` in the host-streamed shard mode on
    phase 9's files and conf: each epoch's rows uploaded a shard at a time
    on the io pool while the previous shard trains; one ``train_epoch``
    (or ``train_tile``) launch a shard.  Stream, kernel.tmp and kernel.opt
    byte-identical to phase 16's resident run; each epoch's device time
    beside it."""
    out = {}
    for tag, extra, env, kernel, per_epoch, base in SHARD_RUNS:
        res = _train_epochs(e2e["root"], extra, env)
        met, ref = res["metrics"], epochs_runs[base]
        other = "train_tile" if kernel == "train_epoch" else "train_epoch"
        if met["mode"] != "sharded" or met["epochs"] != EPOCHS \
                or res["launches"][kernel] != per_epoch * EPOCHS \
                or res["launches"][other] != 0 \
                or met["h2d_bytes"] != EPOCHS * TRAIN_FILES * SHARD_ROW_BYTES \
                or len(met["device_ms"]) != EPOCHS:
            raise AssertionError(f"shard mode (phase 26) {tag}: launches "
                                 f"{res['launches']}, EPOCH_METRICS {met}")
        for part, key in (("out", "out_sha256"), ("opt", "opt_sha256"),
                          ("tmp", "tmp_sha256")):
            if hashlib.sha256(res[part].encode()).hexdigest() != ref[key]:
                raise AssertionError(f"shard mode (phase 26) {tag}: {part} "
                                     f"differs from phase 16's {base} run")
        out[tag] = {"launches": res["launches"][kernel],
                    "epoch_device_ms": met["device_ms"],
                    "resident_epoch_device_ms": ref["epoch_device_ms"],
                    "wall_s": res["wall_s"], "resident_wall_s": ref["wall_s"],
                    "h2d_bytes": met["h2d_bytes"], "stage_s": met["stage_s"]}
        log(f"shard mode (phase 26) {tag}: {kernel} launched "
            f"{res['launches'][kernel]} times in {EPOCHS} epochs; epochs' "
            f"device time " + ", ".join(f"{m:.1f}" for m in met["device_ms"])
            + " ms (resident " + ", ".join(
                f"{m:.1f}" for m in ref["epoch_device_ms"])
            + f" ms); H2D {met['h2d_bytes']} bytes; wall {res['wall_s']:.2f}"
            f" s (resident {ref['wall_s']:.2f} s); stream, kernel.tmp and "
            "kernel.opt byte-identical to phase 16's")
    return out


# --- phase 27: the C API -----------------------------------------------------

def _c_run(cmd, cwd, env):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)
    return proc, time.perf_counter() - t0


def _apitest_corpus(root):
    """apitest's corpus: one 6-input, 3-output sample at samples/s00."""
    os.makedirs(os.path.join(root, "samples"))
    os.makedirs(os.path.join(root, "tests"))
    x = np.random.default_rng(4242).uniform(-1, 1, 6)
    x[0] += 2.0
    with open(os.path.join(root, "samples", "s00"), "w") as fp:
        fp.write("[input] 6\n" + " ".join(f"{v:7.5f}" for v in x)
                 + "\n[output] 3\n1.0 -1.0 -1.0\n")


def phase_c_api(e2e, tmp, card, device="cuda"):
    """Phase 27: the C API on the card.  ``csrc/hpnn_shim.c`` built into
    ``libhpnn_tpu_torch-<sha16>.so`` and the unmodified
    ``native/{train_nn,run_nn}.c`` against it; the C ``train_nn -v -v`` and
    ``run_nn -v -v`` on phase 9's directory (its listing order) give the
    stdout, kernel.tmp and kernel.opt of ``python -m hpnn_tpu_torch.cli``
    there, byte for byte; the port's ``apitest`` passes; and
    ``_NN(init,all)``, ``_NN(train,kernel)`` and ``_NN(run,kernel)`` driven
    in process through ``ctypes.PyDLL`` launch ``train_epoch`` once and
    ``fused_linear_act`` twice."""
    import ctypes

    from hpnn_tpu_torch import cli, runtime
    from hpnn_tpu_torch.ops import build
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    t_phase = time.perf_counter()
    res = {}
    t0 = time.perf_counter()
    lib = build.shim_library()
    progs = {n: build.c_program(n) for n in build.C_PROGRAMS}
    res["build_s"] = time.perf_counter() - t0
    root = e2e["root"]
    keep = {}
    for f in ("kernel.tmp", "kernel.opt"):
        with open(os.path.join(root, f), "rb") as fp:
            keep[f] = fp.read()
    env = dict(os.environ, PYTHONPATH=ROOT, HPNN_DEVICE=device)

    def files():
        got = {}
        for f in ("kernel.tmp", "kernel.opt"):
            with open(os.path.join(root, f), "rb") as fp:
                got[f] = fp.read()
        return got

    try:
        py, py_s = _c_run([sys.executable, "-m", "hpnn_tpu_torch.cli",
                           "train_nn", "-v", "-v", "--device", device,
                           "nn.conf"], root, env)
        py_files = files()
        c, c_s = _c_run([progs["train_nn"], "-v", "-v", "nn.conf"], root,
                        env)
        if py.returncode != 0 or c.returncode != 0:
            raise AssertionError(f"C API (phase 27) train_nn: rc python "
                                 f"{py.returncode}, C {c.returncode}\n"
                                 f"{c.stderr[-2000:]}{py.stderr[-2000:]}")
        if c.stdout != py.stdout or files() != py_files \
                or c.stdout.count("N_ITER=") != TRAIN_FILES:
            raise AssertionError("C API (phase 27): the C train_nn's stdout, "
                                 "kernel.tmp or kernel.opt differ from "
                                 "python -m hpnn_tpu_torch.cli's")
        res["train_nn_wall_s"] = {"c": c_s, "python": py_s}
        rc, rc_s = _c_run([progs["run_nn"], "-v", "-v", "run.conf"], root,
                          env)
        pr, pr_s = _c_run([sys.executable, "-m", "hpnn_tpu_torch.cli",
                           "run_nn", "-v", "-v", "--device", device,
                           "run.conf"], root, env)
        n_pass = rc.stdout.count("[PASS]")
        if rc.returncode != 0 or pr.returncode != 0 \
                or rc.stdout != pr.stdout or n_pass < 0.8 * TRAIN_FILES:
            raise AssertionError(f"C API (phase 27) run_nn: rc C "
                                 f"{rc.returncode}, python {pr.returncode}, "
                                 f"PASS {n_pass}, streams equal "
                                 f"{rc.stdout == pr.stdout}")
        res["run_nn_wall_s"] = {"c": rc_s, "python": pr_s}
        res["pass"] = n_pass
        # the port's apitest: the whole _NN surface on the card
        api_dir = os.path.join(tmp, "apitest")
        _apitest_corpus(api_dir)
        at, at_s = _c_run([progs["apitest"]], api_dir, env)
        if at.returncode != 0 or not at.stdout.endswith("APITEST PASS\n"):
            raise AssertionError(f"C API (phase 27) apitest: rc "
                                 f"{at.returncode}\n{at.stdout[-1000:]}"
                                 f"{at.stderr[-1000:]}")
        res["apitest_wall_s"] = at_s
        # in process: the interpreter lock held across each call
        cwd = os.getcwd()
        os.chdir(root)
        old_dev = os.environ.get("HPNN_DEVICE")
        os.environ["HPNN_DEVICE"] = device
        try:
            pl = ctypes.PyDLL(lib)
            pl.nn_load_conf.restype = ctypes.c_void_p
            pl.nn_load_conf.argtypes = [ctypes.c_char_p]
            for fn in ("nn_train_kernel", "nn_run_kernel", "nn_free_conf"):
                getattr(pl, fn).argtypes = [ctypes.c_void_p]
            cuda_bit = 1 << 2     # NN_CAP_CUDA: a GPU is visible
            if pl.nn_init_all(0) != 0 or (device == "cuda") != bool(
                    pl.nn_return_capabilities() & cuda_bit):
                raise AssertionError("C API (phase 27): _NN(init,all) on "
                                     "the card failed")
            conf = pl.nn_load_conf(b"nn.conf")
            train_epoch_kernel.launches = fused_linear_act.launches = 0
            ok = pl.nn_train_kernel(conf)
            b1 = train_epoch_kernel.launches
            pl.nn_run_kernel(conf)
            b2 = fused_linear_act.launches
            pl.nn_free_conf(conf)
            pl.nn_deinit_all()
        finally:
            os.chdir(cwd)
            if old_dev is None:
                os.environ.pop("HPNN_DEVICE", None)
            else:
                os.environ["HPNN_DEVICE"] = old_dev
            runtime.pin_full_float32()
        if ok != 1 or b1 != 1 or b2 != 2:
            raise AssertionError(f"C API (phase 27) in process: train "
                                 f"{ok}, train_epoch {b1} launches, "
                                 f"fused_linear_act {b2}")
        res["in_process"] = {"train_epoch": b1, "fused_linear_act": b2}
    finally:
        for f, data in keep.items():
            with open(os.path.join(root, f), "wb") as fp:
                fp.write(data)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"C API (phase 27) ({card}): library and 3 programs built in "
        f"{res['build_s']:.1f} s; C train_nn -v -v wall "
        f"{res['train_nn_wall_s']['c']:.2f} s (python -m "
        f"hpnn_tpu_torch.cli {res['train_nn_wall_s']['python']:.2f} s), "
        f"C run_nn {res['run_nn_wall_s']['c']:.2f} s (python "
        f"{res['run_nn_wall_s']['python']:.2f} s): stdout, kernel.tmp and "
        f"kernel.opt byte-identical, run_nn PASS {res['pass']}/{TRAIN_FILES};"
        f" apitest passed ({res['apitest_wall_s']:.2f} s); in process "
        f"through ctypes.PyDLL: train_epoch {b1} launch, fused_linear_act "
        f"{b2}; phase {res['seconds']:.1f} s")
    return res


PHASE_SECONDS: dict[str, float] = {}   # phase -> wall seconds, in run order


# --- phase 28: the data-mesh fast tier (serve_nn --mesh N) ------------------

DMESH_SIZES = (2, 4)            # phase 28: shards of the data mesh
DMESH_ROWS = (64, 200, 256)     # phase 28: requests (buckets 64 and 256)
DMESH_CALLS = 200               # phase 28: timed 256-row registry calls
DMESH_SWAPS = 10                # phase 28: reloads under load
# phase 28: fused_bpm_update at bfloat16, timed at the MNIST input layer
# and past the L2; the other shapes are checked bit for bit only
DMESH_BPM_TIMED = ((300, 784), (4096, 4096))


def _dmesh_timing(reg, model, xs):
    """Median wall ms of one synchronous 256-row registry call (pad, copy
    in, the forward, copy out) and median ms of its ``device`` phase."""
    for _ in range(20):
        reg.forward(model, xs)
    walls, dev = [], []
    for _ in range(DMESH_CALLS):
        t0 = time.perf_counter()
        h = reg.dispatch(model, xs)
        reg.collect(h)
        walls.append((time.perf_counter() - t0) * 1e3)
        dev.append(h.device_s * 1e3)
    return statistics.median(walls), statistics.median(dev)


def _dmesh_swap_load(root, k1, k2, mesh, pool):
    """A client thread sends 256-row batches through a ``fast@meshN``
    registry while the main thread reloads k2, k1, ... DMESH_SWAPS times
    (one client: the wrapper's count is not a lock-protected counter):
    every reply bit-identical to the single-device fast tier's reply of
    the kernel file its generation loaded; ``fused_linear_act`` 2N
    launches a batch."""
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.registry import ModelRegistry

    refs = {}
    for tag, kf in (("k1", k1), ("k2", k2)):
        conf = os.path.join(root, f"swap_{tag}.conf")
        _serve_conf(conf, "mnist", kf, MNIST, "f32")
        fast = ModelRegistry(max_batch=256, parity="fast",
                             fast_threshold=64, device="cuda")
        refs[kf] = fast.forward(fast.register_conf(conf), pool)
    reg = ModelRegistry(max_batch=256, parity="fast", fast_threshold=64,
                        device="cuda", mesh=mesh)
    model = reg.register_conf(os.path.join(root, "swap_k1.conf"))
    reg.forward(model, pool)                       # places the copies
    gens = {1: k1}
    seen, errors = [], []
    stop = threading.Event()

    def client():
        try:
            while not stop.is_set():
                h = reg.dispatch(model, pool)
                seen.append((h.served_gen, h.tier, reg.collect(h)))
        except Exception as exc:  # re-raised below, on this thread
            errors.append(exc)

    fused_linear_act.launches = 0              # the swap path
    loader = threading.Thread(target=client)
    loader.start()
    walls = []
    try:
        for i in range(DMESH_SWAPS):
            time.sleep(0.05)
            path = (k2, k1)[i % 2]
            t0 = time.perf_counter()
            res, why = reg.reload("mnist", path)
            walls.append((time.perf_counter() - t0) * 1e3)
            if res is None:
                raise AssertionError(f"data mesh swap (phase 28): {why}")
            gens[res["generation"]] = path
        time.sleep(0.05)
    finally:
        stop.set()
        loader.join(timeout=120)
    launches = fused_linear_act.launches
    if loader.is_alive():
        raise AssertionError("data mesh swap (phase 28): the client hung")
    if errors:
        raise errors[0]
    n = mesh.n_data
    bad = [g for g, tier, out in seen
           if tier != f"fast@mesh{n}" or not np.array_equal(out,
                                                            refs[gens[g]])]
    served = sorted({g for g, _, _ in seen})
    if bad or len(served) < 3 or launches != 2 * n * len(seen):
        raise AssertionError(
            f"data mesh swap (phase 28): {len(bad)} of {len(seen)} replies "
            f"not the fast tier's reply of their generation's kernel, "
            f"generations served {served}, fused_linear_act {launches} "
            f"launches for {len(seen)} batches")
    return {"batches": len(seen), "generations_served": len(served),
            "swaps": DMESH_SWAPS, "launches": launches,
            "swap_wall_ms": statistics.median(walls)}


def _dmesh_cli(root, conf, pool, want):
    """``python -m hpnn_tpu_torch.cli serve_nn --parity fast --mesh 4`` as a
    process of its own: it starts with the JAX package's lines for this
    host (on one card no mesh and no warning; a power-of-two floor warns),
    its warmup's 256-row bucket takes the tier ``data_mesh(4)`` gives, and
    a 256-row request answers bit-identically to ``want``.  Then
    ``serve_nn --parity strict --mesh 2`` in process warns "inert"."""
    import signal

    import torch

    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.parallel.mesh import data_mesh
    from hpnn_tpu_torch.utils import nn_log

    mesh = data_mesh(4, "cuda")
    tier = f"fast@mesh{mesh.n_data}" if mesh is not None else "fast"
    n = min(4, torch.cuda.device_count())
    floored = n >= 2 and n & (n - 1) != 0
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "hpnn_tpu_torch.cli", "serve_nn", "-v", "-v",
         "-v", "-p", "0", "--device", "cuda", "--parity", "fast", "--mesh",
         "4", "-b", "256", "--fast-threshold", "64", "--warmup-mode", "sync",
         conf], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=ROOT))
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout))
    reader.start()
    base = None
    try:
        while base is None and time.perf_counter() - t0 < 300:
            if proc.poll() is not None:
                break
            for line in list(lines):
                if line.startswith("SERVE: listening on http://"):
                    base = "http://" + line.split("http://", 1)[1].strip()
            time.sleep(0.05)
        if base is None:
            raise AssertionError("serve_nn --mesh 4 (phase 28) did not "
                                 "start:\n" + "".join(lines[-20:]))
        start_s = time.perf_counter() - t0
        status, body = _post(base + "/v1/kernels/mnist/infer", pool)
        got = np.asarray(body["outputs"], np.float64)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=60)
    out = "".join(lines)
    miss = f"bucket=256 tier={tier} path=fused"
    if status != 200 or not np.array_equal(got, want) or rc != 0 \
            or miss not in out or "inert" in out \
            or ("data mesh floored" in out) != floored:
        raise AssertionError(f"serve_nn --mesh 4 (phase 28): status "
                             f"{status}, rc {rc}, bit-identical "
                             f"{np.array_equal(got, want)}, '{miss}' "
                             f"{miss in out}:\n{out[-3000:]}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        app, args = cli.serve_app(["-v", "--parity", "strict", "--mesh",
                                   "2", "--device", "cuda", "--no-warmup",
                                   conf])
    try:
        inert = [ln for ln in buf.getvalue().splitlines() if "inert" in ln]
        if app is None or app.registry.mesh is not None or inert != [
                "NN(WARN): serve: --mesh is inert under parity=strict (the "
                "bit-parity GEMV scan never shards); pass --parity fast to "
                "enable sharded serving"]:
            raise AssertionError(f"serve_nn --parity strict --mesh 2 "
                                 f"(phase 28): {buf.getvalue()[-2000:]}")
    finally:
        if app is not None:
            app.close(drain=False)
        nn_log.set_verbosity(0)
    log(f"data mesh (phase 28): serve_nn --parity fast --mesh 4 started in "
        f"{start_s:.1f} s on {torch.cuda.device_count()} card(s): the "
        f"256-row bucket on {tier}"
        + (", floored with the JAX package's warning" if floored else
           ", no mesh warning") + ", a 256-row answer bit-identical; "
        "--parity strict --mesh 2 warns inert")
    return {"tier": tier, "start_s": start_s, "floored": floored}


def phase_data_mesh(tmp, card):
    """Phase 28: the ``fast@meshN`` tier.  A generated MNIST 784-300-10 ANN
    kernel (``-b 256 --fast-threshold 64``) at float32, bfloat16 and
    float64 on a data mesh of 2 and 4 shards (distinct cards when the host
    has them, else the one card repeated): requests of 64, 200 and 256
    rows, each reply against the single-device fast tier's (float32 and
    bfloat16 bit for bit, float64 reported and held to 1e-12), and
    ``fused_linear_act`` exactly 2N launches a sharded batch (0 at float64,
    a ``torch.matmul`` chain); the 256-row p50 of both tiers, their
    ``device`` phase and B2's device time per shard.  Then reloads under
    load, the CLI, and ``fused_bpm_update`` at bfloat16."""
    import torch

    from hpnn_tpu_torch.ops.kernels import (batched_forward_fused,
                                            empty_launch, fused_linear_act)
    from hpnn_tpu_torch.parallel.mesh import DataMesh
    from hpnn_tpu_torch.serve.registry import ModelRegistry

    root = os.path.join(tmp, "dmesh")
    os.makedirs(root)
    k1, k2 = os.path.join(root, "k1.opt"), os.path.join(root, "k2.opt")
    _dump_generated(k1, MNIST, 10958)
    _dump_generated(k2, MNIST, 10959)
    cards = torch.cuda.device_count()
    pool = _inputs(np.random.default_rng(28), 256, MNIST[0], "pixel")
    res = {"cards": cards, "cells": {}}
    launches = {}
    meshes = {k: DataMesh([torch.device("cuda", i if cards >= k else 0)
                           for i in range(k)]) for k in DMESH_SIZES}
    for dname in ("f32", "bf16", "f64"):
        conf = os.path.join(root, f"mnist_{dname}.conf")
        _serve_conf(conf, "mnist", k1, MNIST, dname)
        fast = ModelRegistry(max_batch=256, parity="fast", fast_threshold=64,
                             device="cuda")
        fm = fast.register_conf(conf)
        fast_p50, fast_dev = _dmesh_timing(fast, fm, pool)
        x = torch.as_tensor(pool, dtype=torch.float64).cuda().to(fm.dtype)
        whole_ms = (_device_ms(lambda: batched_forward_fused(
            fm.mlp.weights, x, "ANN")) if dname != "f64" else None)
        for k, mesh in meshes.items():
            reg = ModelRegistry(max_batch=256, parity="fast",
                                fast_threshold=64, device="cuda", mesh=mesh)
            m = reg.register_conf(conf)
            tag = f"{dname} fast@mesh{k}"
            cell = {"devices": [str(d) for d in mesh.devices],
                    "distinct_cards": len(mesh.distinct()),
                    "launches_per_batch": {}, "bitwise": {},
                    "max_abs_err": 0.0}
            for rows in DMESH_ROWS:
                xs = pool[:rows]
                want = fast.forward(fm, xs)
                fused_linear_act.launches = 0   # the sharded batch's path
                h = reg.dispatch(m, xs)
                got = reg.collect(h)
                n_l = fused_linear_act.launches
                launches[f"{tag} {rows} rows"] = n_l
                err = float(np.abs(got - want).max())
                same = bool(np.array_equal(got, want))
                if h.tier != f"fast@mesh{k}" or h.served_gen != 1 \
                        or n_l != (0 if dname == "f64" else 2 * k) \
                        or not err <= LIMIT["f64"] \
                        or not (same or dname == "f64"):
                    raise AssertionError(
                        f"{tag} {rows} rows (phase 28): tier {h.tier}, "
                        f"generation {h.served_gen}, {n_l} launches, "
                        f"bit-identical {same}, {err:.3e} from fast")
                cell["launches_per_batch"][rows] = n_l
                cell["bitwise"][rows] = same
                cell["max_abs_err"] = max(cell["max_abs_err"], err)
            cell["p50_ms"], cell["device_ms"] = _dmesh_timing(reg, m, pool)
            cell["fast_p50_ms"], cell["fast_device_ms"] = fast_p50, fast_dev
            if dname != "f64":
                copies, _ = m.mesh_weights(mesh)
                blk = x[:256 // k].to(mesh.devices[0])
                with torch.cuda.device(mesh.devices[0]):
                    cell["shard_ms"] = _device_ms(
                        lambda: batched_forward_fused(copies[0], blk, "ANN"))
                cell["whole_ms"] = whole_ms
            res["cells"][tag] = cell
            log(f"data mesh {tag} on {cell['devices']}: replies "
                + ("bit-identical to" if all(cell["bitwise"].values())
                   else f"within {cell['max_abs_err']:.3e} of")
                + f" the fast tier's; fused_linear_act a batch "
                f"{cell['launches_per_batch']}; 256 rows p50 "
                f"{cell['p50_ms']:.4f} ms (fast {fast_p50:.4f}), device "
                f"phase {cell['device_ms']:.4f} ms (fast {fast_dev:.4f})"
                + (f"; B2 a shard {cell['shard_ms']:.4f} ms (the whole "
                   f"bucket {whole_ms:.4f})" if dname != "f64" else ""))
    res["launches"] = launches
    res["swap"] = _dmesh_swap_load(root, k1, k2, meshes[4], pool)
    log(f"data mesh swaps under load (phase 28): {res['swap']}")
    conf = os.path.join(root, "mnist_f32.conf")
    fast = ModelRegistry(max_batch=256, parity="fast", fast_threshold=64,
                         device="cuda")
    res["cli"] = _dmesh_cli(root, conf, pool,
                            fast.forward(fast.register_conf(conf), pool))
    rng = np.random.default_rng(2813)
    floor_ms = _device_ms(lambda: empty_launch("cuda"))
    res["bpm_bf16"] = [
        _bpm_cell(n, m, "bf16", _bpm_arrays(rng, n, m), BPM_LR, BPM_ALPHA,
                  floor_ms, timed=(n, m) in DMESH_BPM_TIMED)
        for n, m in BPM_SHAPES]
    return res


GRID_SHARDS = (2, 4)            # phase 29: data shards of the grid runs
GRID_LIMIT = {"batch": 1e-11, "sample": 1e-12, "cg": 1e-9}
GRID_TILE_FILES = 256           # phase 29: the [batch]+[tile] route's files


def _grid_devices(k):
    """k shards: distinct cards where the host has them, else cuda:0
    repeated (the shards then run in turn)."""
    import torch

    cards = torch.cuda.device_count()
    return [torch.device("cuda", i if cards >= k else 0) for i in range(k)]


def _grid_train(cwd, argv, k, env=None):
    """``_ckpt_train`` with the thread pinned to a k-shard grid (the
    counts set to 0 just before the run)."""
    from hpnn_tpu_torch import api

    with api.device_slice(_grid_devices(k)):
        return _ckpt_train(cwd, argv, env)


def _train_lines(out, key):
    return re.findall(key + r"[^\n]*", out)


def _grid_opt(cwd):
    with open(os.path.join(cwd, "kernel.opt")) as fp:
        return fp.read()


def _grid_held(tag, run, ref, key, limit, cwd, ref_cwd, grid, kernels=()):
    """A grid run held to its one-shard reference: the ``key`` lines
    equal, kernel.opt within ``limit``, no hand-written kernel launched
    but ``kernels``, and the ``EPOCH_METRICS`` entries ``grid`` names.
    Returns the run's record."""
    met = run["metrics"]
    err = _kernel_diff(_grid_opt(ref_cwd), _grid_opt(cwd))
    got, want = _train_lines(run["out"], key), _train_lines(ref["out"], key)
    stray = {n: v for n, v in run["launches"].items()
             if v and n not in kernels}
    if got != want or not want or err > limit or stray \
            or any(met[k] != v for k, v in grid.items()):
        raise AssertionError(
            f"{tag} (phase 29): {key} lines equal {got == want} "
            f"({len(got)}), kernel.opt {err:.3e} from the one-shard run "
            f"(limit {limit:g}), launches {run['launches']}, metrics "
            f"{ {k: met[k] for k in grid} } (want {grid})")
    rec = {"wall_s": run["wall_s"], "ref_wall_s": ref["wall_s"],
           "max_abs_err": err, "launches": run["launches"],
           "mode": met["mode"], "epoch_device_ms": met["device_ms"],
           "ref_epoch_device_ms": ref["metrics"]["device_ms"],
           "opt_state_bytes_per_device":
               met["opt_state_bytes_per_device"],
           "weight_bytes_per_device": met["weight_bytes_per_device"]}
    log(f"grid {tag}: {len(got)} {key} lines equal to the one-shard run's, "
        f"kernel.opt within {err:.3e}; {met['mode']}; wall "
        f"{run['wall_s']:.2f} s (one shard {ref['wall_s']:.2f}); epochs' "
        f"device ms {[round(m, 2) for m in met['device_ms']]} (one shard "
        f"{[round(m, 2) for m in ref['metrics']['device_ms']]}); update "
        f"state {met['opt_state_bytes_per_device']} bytes a shard; "
        f"launches {run['launches']}")
    return rec


def _grid_replay(x, t, k):
    """The [batch] 32 BPM f64 epoch of phase 20's 4096 MNIST files (``x``,
    ``t``: (batches, 32, n) float64) on a k-shard grid alone
    (``dp_epoch``, no CLI): device ms between events on the first shard's
    card and host ms of the launches (median of 3), the kernel launches
    of one epoch (``torch.profiler``) and the update state's bytes a
    shard."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hpnn_tpu_torch.models.kernel import generate_kernel
    from hpnn_tpu_torch.parallel import DataMesh, dp
    from hpnn_tpu_torch.parallel.mesh import shard_bounds

    devs = _grid_devices(k)
    kern, _ = generate_kernel(10958, 784, [300], 10)
    shapes = tuple(tuple(w.shape) for w in kern.weights)
    nb, bsz = x.shape[:2]
    cuts = [shard_bounds(bsz, k, d) for d in range(k)]
    xb = [_to_card(np.ascontiguousarray(x[:, lo:hi]),
                   torch.float64).to(dev) for (lo, hi), dev in zip(cuts, devs)]
    tb = [_to_card(np.ascontiguousarray(t[:, lo:hi]),
                   torch.float64).to(dev) for (lo, hi), dev in zip(cuts, devs)]
    mb = [torch.ones(nb, hi - lo, dtype=torch.float64, device=dev)
          for (lo, hi), dev in zip(cuts, devs)]
    w = dp.dp_resident_carry([_to_card(v, torch.float64).to(devs[0])
                              for v in kern.weights], k)
    mesh = DataMesh(devs) if k > 1 else None

    def epoch():
        if mesh is None:
            return dp.dp_epoch(w, xb[0], tb[0], mb[0], "ANN", True, 0.0005,
                               0.2, shapes)
        return dp.dp_epoch(w, xb, tb, mb, "ANN", True, 0.0005, 0.2, shapes,
                           mesh=mesh)

    got = []
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = epoch()
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        got.append((start.elapsed_time(end), host))
    ms, host = sorted(got[1:])[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        epoch()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith("cu") and "Launch" in e.key)
    dw = out[1] if isinstance(out[1], list) else [out[1]]
    return {"shards": k, "devices": [str(d) for d in devs], "ms": ms,
            "host_ms": host, "launches": launches, "batches": nb,
            "opt_state_bytes_per_device": max(v.numel() * v.element_size()
                                              for v in dw)}


def _grid_launches(grid_res, name):
    """A kernel's launches in each of phase 29's sharded training runs."""
    out = {tag: r["launches"][name] for tag, r in grid_res["batch"].items()}
    for part in ("hybrid", "model", "tile", "cg"):
        out[part] = grid_res[part]["launches"][name]
    return out


def phase_grid(e2e, tmp, runs, results, tp_res, card):
    """Phase 29: training on an in-process grid.  MNIST 784-300-10 at the
    tutorial conf on phase 9's 512 bar files, each grid run pinned to its
    devices with ``api.device_slice`` (distinct cards where the host has
    them, else the one card repeated) and held to the one-shard run on the
    card: ``[batch] 32`` BP and BPM at 2 and 4 shards, resident and
    restage; the 2x2 ``[batch] 32`` x ``[model] 2`` grid against phase
    21's four gloo ranks; ``[model] 2`` per sample on phase 21's 64 files;
    ``[batch] 32`` + ``[tile] 4`` at 4 shards on 256 of the files against
    the one-card ``train_tile`` route; ``[batch] 32`` CG on phase 20's [0, 1] bars at 4
    shards; ``run_nn`` of phase 21's ``[model] 2`` conf over 2 shards; a
    jobs server over the 4-shard grid's devices running a ``dp_devices:
    2`` job; on a host of several cards ``python -m hpnn_tpu_torch.cli
    train_nn`` as a process over every card.  Then the [batch] 32 BPM
    epoch alone at 1 and 4 shards: device and host time, kernel
    launches, update-state bytes a shard."""
    import torch

    from hpnn_tpu_torch import api, cli
    from hpnn_tpu_torch.io.corpus import load_resident
    from hpnn_tpu_torch.io.samples import list_sample_dir
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.server import ServeApp, serve_in_thread
    from hpnn_tpu_torch.train import cg

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "grid")
    mnist512 = os.path.join(e2e["root"], "samples")
    cards = torch.cuda.device_count()
    res = {"cards": cards, "devices": {k: [str(d) for d in _grid_devices(k)]
                                       for k in GRID_SHARDS},
           "batch": {}, "part_wall_s": {}}
    log(f"grid (phase 29), {cards} x {card}: "
        + ", ".join(f"{k} shards on {res['devices'][k]}"
                    for k in GRID_SHARDS)
        + (" (distinct cards)" if cards >= max(GRID_SHARDS)
           else " (the card repeated)"))
    t_part = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        res["part_wall_s"][name] = now - t_part[0]
        t_part[0] = now

    one = [torch.device("cuda", 0)]
    # --- [batch] 32 BP/BPM at 2 and 4 shards, resident and restage
    batch_dirs = {}
    for train in ("BP", "BPM"):
        ref_cwd = _b_conf(os.path.join(root, f"b32_{train}_1"), "ANN", train,
                          MNIST, mnist512, "[batch] 32\n")
        with api.device_slice(one):
            ref = _ckpt_train(ref_cwd, ["--epochs", "2", "nn.conf"])
        for k in GRID_SHARDS:
            for route, env in (("resident", None),
                               ("restage", {"HPNN_NO_EPOCH_PIPELINE": "1"})):
                tag = f"[batch] 32 {train} {k} shards {route}"
                cwd = _b_conf(os.path.join(root, tag.replace(" ", "_")),
                              "ANN", train, MNIST, mnist512, "[batch] 32\n")
                run = _grid_train(cwd, ["--epochs", "2", "nn.conf"], k, env)
                res["batch"][tag] = _grid_held(
                    tag, run, ref, "TRAINING BATCH", GRID_LIMIT["batch"],
                    cwd, ref_cwd, {"dp_devices": k, "tp_devices": 1})
                batch_dirs[(train, k, route)] = cwd
    done("batch")
    # --- the 2x2 grid against phase 21's four gloo ranks
    gtag = "[batch] 32 x [model] 2"
    gloo = tp_res["gloo"][gtag]
    cwd = _b_conf(os.path.join(root, "hybrid"), "ANN", "BP", MNIST, mnist512,
                  "[batch] 32\n[model] 2\n")
    run = _grid_train(cwd, ["--epochs", "2", "nn.conf"], 4)
    err = _kernel_diff(_grid_opt(gloo["cwd"]), _grid_opt(cwd))
    lines = _train_lines(run["out"], "TRAINING BATCH")
    met = run["metrics"]
    b2 = run["launches"]["fused_linear_act"]
    if lines != gloo["lines"] or err > GRID_LIMIT["batch"] \
            or "DP: hybrid mesh 2x2" not in run["out"] or b2 <= 0 \
            or any(v for n, v in run["launches"].items()
                   if n != "fused_linear_act") \
            or (met["dp_devices"], met["tp_devices"]) != (2, 2):
        raise AssertionError(f"{gtag} on the 2x2 grid (phase 29): lines "
                             f"equal {lines == gloo['lines']}, kernel.opt "
                             f"{err:.3e} from 4 gloo ranks, launches "
                             f"{run['launches']}, metrics {met}")
    res["hybrid"] = {"wall_s": run["wall_s"], "gloo_wall_s": gloo["wall_s"],
                     "max_abs_err": err, "mode": met["mode"],
                     "launches": run["launches"],
                     "epoch_device_ms": met["device_ms"],
                     "weight_bytes_per_device":
                         met["weight_bytes_per_device"],
                     "opt_state_bytes_per_device":
                         met["opt_state_bytes_per_device"]}
    log(f"grid {gtag} on 2x2: TRAINING BATCH lines equal to phase 21's 4 "
        f"gloo ranks', kernel.opt within {err:.3e}; wall "
        f"{run['wall_s']:.2f} s (gloo {gloo['wall_s']:.1f}); epochs' device "
        f"ms {[round(m, 2) for m in met['device_ms']]}; weights "
        f"{met['weight_bytes_per_device']} bytes a shard; fused_linear_act "
        f"{b2} launches ({b2 // 32} a batch: the ring's products)")
    done("hybrid")
    # --- [model] 2 per sample on phase 21's 64 files, from its kernel
    s64 = os.path.join(tmp, "tp", "samples64")
    pre = os.path.join(tmp, "tp", "pre.opt")
    tp_dirs = []
    for side in ("one", "grid"):
        d = _b_conf(os.path.join(root, f"model2_{side}"), "ANN", "BP", MNIST,
                    s64, "[model] 2\n")
        path = os.path.join(d, "nn.conf")
        with open(path) as fp:
            text = fp.read()
        with open(path, "w") as fp:
            fp.write(text.replace("[init] generate", f"[init] {pre}"))
        tp_dirs.append(d)
    with api.device_slice(one):
        ref = _ckpt_train(tp_dirs[0], ["nn.conf"])
    run = _grid_train(tp_dirs[1], ["nn.conf"], 2)
    b2 = run["launches"]["fused_linear_act"]
    res["model"] = _grid_held("[model] 2 per sample 2 shards", run, ref,
                              "TRAINING FILE", GRID_LIMIT["sample"],
                              tp_dirs[1], tp_dirs[0], {"tp_devices": 2},
                              kernels=("fused_linear_act",))
    iters = sum(int(v) for v in re.findall(r"N_ITER=\s*(\d+)", run["out"]))
    res["model"].update(b2_launches=b2, iters=iters)
    if b2 <= 0 or ref["launches"]["train_epoch"] != 1:
        raise AssertionError(f"[model] 2 per sample (phase 29): B2 {b2}, "
                             f"the one-shard run {ref['launches']}")
    log(f"grid [model] 2 per sample: {iters} iterations, fused_linear_act "
        f"launched {b2} times ({b2 / max(1, iters):.1f} an iteration)")
    done("model")
    # --- [batch] 32 + [tile] 4 at 4 shards against the one-card route, on
    # the first GRID_TILE_FILES of the files
    tile_files = os.path.join(root, f"samples{GRID_TILE_FILES}")
    os.makedirs(tile_files)
    for f in sorted(os.listdir(mnist512))[:GRID_TILE_FILES]:
        shutil.copy(os.path.join(mnist512, f), tile_files)
    tile_dirs = []
    for side in ("one", "grid"):
        tile_dirs.append(_b_conf(os.path.join(root, f"tile_{side}"), "ANN",
                                 "BP", MNIST, tile_files,
                                 "[batch] 32\n[tile] 4\n"))
    with api.device_slice(one):
        ref = _ckpt_train(tile_dirs[0], ["--epochs", "2", "nn.conf"])
    run = _grid_train(tile_dirs[1], ["--epochs", "2", "nn.conf"], 4)
    want = re.findall(r"N_ITER=\s*(\d+)", ref["out"])
    got = re.findall(r"N_ITER=\s*(\d+)", run["out"])
    diff = [(i, int(a), int(b)) for i, (a, b) in enumerate(zip(want, got))
            if a != b]
    log(f"grid [batch] 32 + [tile] 4 at 4 shards: {len(diff)} sample(s) of "
        f"{len(want)} with another iteration count than the one-card "
        f"train_tile route" + (f": {diff[:8]}" if diff else ""))
    b4_want = 2 * -(-GRID_TILE_FILES // 32 // 4)     # 2 epochs, 4 groups
    if "mesh=4)" not in run["out"] \
            or ref["launches"]["train_tile"] != b4_want:
        raise AssertionError(f"[batch] 32 + [tile] 4 (phase 29): banner "
                             f"{'mesh=4)' in run['out']}, one-card "
                             f"train_tile launches {ref['launches']}")
    res["tile"] = _grid_held("[batch] 32 + [tile] 4 4 shards", run, ref,
                             "TRAINING FILE", GRID_LIMIT["batch"],
                             tile_dirs[1], tile_dirs[0],
                             {"dp_devices": 4, "mode": "dp-tiled-resident"})
    res["tile"]["iter_diffs"] = len(diff)
    res["tile"]["lane_iters"] = sum(int(v) for v in got)
    done("tile")
    # --- [batch] 32 CG on phase 20's [0, 1] bars at 4 shards
    cg_dir = os.path.join(tmp, "batched", "cg_pm1")
    cg_dirs = [_b_conf(os.path.join(root, f"cg_{side}"), "ANN", "CG", MNIST,
                       cg_dir, "[batch] 32\n") for side in ("one", "grid")]
    argv = ["--trainer", "cg", "--epochs", "2", "nn.conf"]
    cg_ms = []
    for d, k in zip(cg_dirs, (1, 4)):
        cg.CG_METRICS.update(epochs=0, iters=0, device_ms=[])
        with api.device_slice(_grid_devices(k)):
            runs_cg = _ckpt_train(d, argv)
        cg_ms.append(list(cg.CG_METRICS["device_ms"]))
        if k == 1:
            ref = runs_cg
    res["cg"] = _grid_held("[batch] 32 CG 4 shards", runs_cg, ref,
                           "TRAINING CG", GRID_LIMIT["cg"], cg_dirs[1],
                           cg_dirs[0], {"mode": "restage-cg"})
    res["cg"].update(epoch_device_ms=cg_ms[1], ref_epoch_device_ms=cg_ms[0])
    log(f"grid [batch] 32 CG: epochs' device ms "
        f"{[round(m, 2) for m in cg_ms[1]]} at 4 shards, "
        f"{[round(m, 2) for m in cg_ms[0]]} at one")
    done("cg")
    # --- run_nn of phase 21's [model] 2 conf over 2 shards
    name = "mnist_ann_f64"
    conf_path = next(c for n, c, *_ in runs if n == name)
    tp_conf = conf_path.replace(".conf", "_model2.conf")
    texts = {}
    for tag, path, k in (("plain", conf_path, 1), ("[model] 2", tp_conf, 2)):
        fused_linear_act.launches = 0
        out = io.StringIO()
        with api.device_slice(_grid_devices(k)), \
                contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda", path])
        texts[tag] = (rc, outs, out.getvalue(), fused_linear_act.launches)
    rc, outs, text, launched = texts["[model] 2"]
    err = float(np.abs(outs - results[name][0]).max())
    if rc != 0 or launched != 4 or "visible device" in text \
            or text != texts["plain"][2] or err > LIMIT["f64"]:
        raise AssertionError(f"run_nn [model] 2 over 2 shards (phase 29): "
                             f"rc={rc}, launches {launched}, lines equal "
                             f"{text == texts['plain'][2]}, {err:.3e} from "
                             "phase 4's outputs")
    res["run_nn"] = {"launches": launched, "max_abs_err": err}
    log(f"grid run_nn [model] 2 over 2 shards: the ring engine, "
        f"fused_linear_act launched {launched} times for the {N_FILES}-row "
        f"batch, verdict lines equal to phase 4's, outputs within {err:.3e}")
    done("run_nn")
    # --- a jobs server over the 4-shard grid's devices: a dp_devices 2 job
    jroot = os.path.join(root, "jobs")
    os.makedirs(jroot)
    served = os.path.join(jroot, "mnist0.opt")
    _dump_generated(served, MNIST, 10958)
    conf = os.path.join(jroot, "mnist.conf")
    _serve_conf(conf, "mnist", served, MNIST, "f64")
    app = ServeApp(max_batch=64, device="cuda")
    if app.add_model(conf, warmup=False) is None:
        raise AssertionError("phase 29's jobs server: add_model failed")
    app.enable_jobs(os.path.join(jroot, "jobs"), capacity=2,
                    devices=_grid_devices(4))
    httpd, _ = serve_in_thread(app, "127.0.0.1", 0)
    base = "http://%s:%d" % httpd.server_address[:2]
    try:
        st, job = _http(base, "/v1/kernels/mnist/train", {
            "epochs": 2, "seed": 10958, "train": "BP", "dtype": "f64",
            "hidden": MNIST[1], "samples": mnist512, "ckpt_every": 1,
            "batch": 32, "dp_devices": 2})
        if st != 202:
            raise AssertionError(f"job submit (phase 29): {st} {job}")
        snap = _job_wait(base, job["job_id"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close(drain=True)
    with open(os.path.join(snap["path"], "kernel.opt"), "rb") as fp:
        job_sha = hashlib.sha256(fp.read()).hexdigest()
    with open(os.path.join(batch_dirs[("BP", 2, "resident")], "kernel.opt"),
              "rb") as fp:
        want_sha = hashlib.sha256(fp.read()).hexdigest()
    if snap["status"] != "done" or snap["slice"]["size"] != 2 \
            or job_sha != want_sha:
        raise AssertionError(f"dp_devices 2 job (phase 29): {snap['status']}"
                             f", slice {snap['slice']}, kernel.opt equal to "
                             f"the offline 2-shard run's {job_sha == want_sha}")
    res["job"] = {"slice": snap["slice"],
                  "wall_s": snap["finished"] - snap["started"]}
    log(f"grid job over {res['devices'][4]}: a [batch] 32 job with "
        f"dp_devices 2 on slice {snap['slice']['devices']}, done in "
        f"{res['job']['wall_s']:.2f} s, kernel.opt byte-identical to the "
        "offline 2-shard run's")
    done("job")
    # --- a train_nn process takes every card of its host
    if cards >= 2:
        cwd = _b_conf(os.path.join(root, "process"), "ANN", "BP", MNIST,
                      mnist512, "[batch] 32\n")
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        p = subprocess.run([sys.executable, "-m", "hpnn_tpu_torch.cli",
                            "train_nn", "-v", "-v", "-v", "--epochs", "2",
                            "--device", "cuda", "nn.conf"], cwd=cwd, env=env,
                           text=True, capture_output=True, timeout=300)
        mark = f"mesh={cards}x1"
        ok = p.returncode == 0 and mark in p.stdout
        if ok and cards in GRID_SHARDS:
            ref = batch_dirs[("BP", cards, "resident")]
            ok = _kernel_diff(_grid_opt(ref), _grid_opt(cwd)) == 0.0
        if not ok:
            raise AssertionError(f"train_nn as a process on {cards} cards "
                                 f"(phase 29): rc={p.returncode}, "
                                 f"'{mark}' in its stream {mark in p.stdout}"
                                 f"\n{p.stderr[-1500:]}")
        res["process"] = {"cards": cards}
        log(f"grid: python -m hpnn_tpu_torch.cli train_nn took all {cards} "
            f"cards ({mark})")
    else:
        res["process"] = None
        log("grid: one card, so the train_nn process over every card is "
            "not run")
    done("process")
    # --- the [batch] 32 BPM epoch alone at 1 and 4 shards
    samples = os.path.join(tmp, "batched", f"mnist{BATCH_FILES}")
    rc = load_resident(samples, list_sample_dir(samples), 784, 10)
    nb = rc.n_rows // 32
    x = np.asarray(rc.X[:nb * 32]).reshape(nb, 32, -1)
    t = np.asarray(rc.T[:nb * 32]).reshape(nb, 32, -1)
    res["replay"] = [_grid_replay(x, t, k) for k in (1, GRID_SHARDS[-1])]
    for r in res["replay"]:
        log(f"grid replay, [batch] 32 BPM f64 epoch of {r['batches']} "
            f"batches at {r['shards']} shard(s): {r['ms']:.2f} ms between "
            f"events, {r['host_ms']:.2f} ms of host launches, "
            f"{r['launches']} kernel launches, "
            f"{r['opt_state_bytes_per_device']} bytes of momentum a shard")
    done("replay")
    res["wall_s"] = time.perf_counter() - t_phase
    log("phase 29 wall by part: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in res["part_wall_s"].items()))
    return res


# --- phase 30: ranks that hold several devices ----------------------------

RANK_SHARDS = 2          # phase 30: devices each of the 2 ranks holds
RANK_CG_ITERS = "4"      # phase 30: CG iterations an epoch
RANK_LIMIT_S = 420       # phase 30: the ranks' time limit, every case
# phase 30's cases: (tag, [train], corpus, conf lines, argv before the
# conf, env, the lines compared, the kernel.opt bound, B2 launched on a
# card by each rank)
RANK_CASES = (
    ("[batch] 32 BPM", "BPM", "mnist4096", "[batch] 32\n", ["--epochs", "2"],
     {}, "TRAINING BATCH", GRID_LIMIT["batch"], False),
    ("[model] 2", "BP", "s64", "[model] 2\n", [], {}, "TRAINING FILE",
     GRID_LIMIT["sample"], True),
    ("[model] 4", "BP", "s64", "[model] 4\n", [], {}, "TRAINING FILE",
     GRID_LIMIT["sample"], True),
    ("[batch] 32 x [model] 2", "BP", "mnist512", "[batch] 32\n[model] 2\n",
     ["--epochs", "2"], {}, "TRAINING BATCH", GRID_LIMIT["batch"], True),
    ("[batch] 32 CG", "CG", "cg", "[batch] 32\n",
     ["--trainer", "cg", "--epochs", "2"], {"HPNN_CG_ITERS": RANK_CG_ITERS},
     "TRAINING CG", GRID_LIMIT["cg"], False),
)

# one process a rank runs every case's train_nn in turn, each case its own
# process group (a coordinator port a case), the launch counts set to 0
# just before each and read just after
RANK_WORKER = r"""
import contextlib, io, json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from hpnn_tpu_torch import api, cli
from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile
from hpnn_tpu_torch.ops.kernels import fused_linear_act
out_path, shards, device = sys.argv[2], int(sys.argv[3]), sys.argv[4]
rank = os.environ["HPNN_PROCESS_ID"]
res = []
for cwd, port, argv, env in json.loads(sys.argv[5]):
    os.chdir(cwd)
    os.environ.update(env, HPNN_COORDINATOR="127.0.0.1:%d" % port)
    for fn in (train_epoch_kernel, train_tile, fused_linear_act):
        fn.launches = 0
    out, err = io.StringIO(), io.StringIO()
    pin = (api.device_slice([torch.device("cpu")] * shards) if shards
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    with pin, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli.train_nn_main(["-v", "-v", *argv[:-1], "--device", device,
                                argv[-1]])
    res.append({"rc": rc, "wall_s": time.perf_counter() - t0,
                "out": out.getvalue(), "err": err.getvalue()[-3000:],
                "launches": {"fused_linear_act": fused_linear_act.launches,
                             "train_epoch": train_epoch_kernel.launches,
                             "train_tile": train_tile.launches}})
    for k in env:
        os.environ.pop(k)
    if rc != 0:
        break
with open(out_path + "." + rank, "w") as fp:
    json.dump(res, fp)
"""


def _rank_corpora(e2e, tmp):
    """Phase 30's corpora: phase 20's 4096 MNIST bars and its [0, 1] CG
    bars, phase 9's 512 files, phase 21's 64 files and the kernel the
    earlier phases trained on them; each written here when the phase that
    makes it did not run."""
    mnist512 = os.path.join(e2e["root"], "samples")
    got = {"mnist512": mnist512,
           "mnist4096": os.path.join(tmp, "batched", f"mnist{BATCH_FILES}"),
           "cg": os.path.join(tmp, "batched", "cg_pm1"),
           "s64": os.path.join(tmp, "tp", "samples64"),
           "pre": os.path.join(tmp, "tp", "pre.opt")}
    if not os.path.isdir(got["mnist4096"]):
        _write_samples(got["mnist4096"], *_bar_corpus(
            BATCH_FILES, MNIST, tuple(range(10)), 7))
    if not os.path.isdir(got["cg"]):
        xs, ts, labels = _bar_corpus(TRAIN_FILES, MNIST, tuple(range(10)), 5)
        _write_samples(got["cg"], np.round(xs / 255.0, 1), ts, labels)
    if not os.path.isdir(got["s64"]):
        os.makedirs(got["s64"])
        for f in sorted(os.listdir(mnist512))[:TP_FILES]:
            shutil.copy(os.path.join(mnist512, f), got["s64"])
        shutil.copy(os.path.join(e2e["root"], "kernel.opt"), got["pre"])
    return got


def phase_rank_grid(e2e, tmp, card):
    """Phase 30: two ranks (``HPNN_DISTRIBUTED``) of two devices each, the
    (data x model) grid over every rank's devices, against the one-process
    4-shard grid on the card.  On a host of four or more cards: 2 NCCL
    ranks, torchrun's layout (``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` 2) over
    the first four cards, so rank 0 holds cuda:0-1 and rank 1 cuda:2-3,
    held to one process over cuda:0-3.  On fewer: NCCL cannot put two
    ranks on one card, so 2 gloo ranks of 2 CPU shards each
    (``device_slice``), held to one process over cuda:0 repeated 4 times.
    MNIST 784-300-10: ``[batch] 32`` BPM f64 on phase 20's 4096 files
    (``--epochs 2``), ``[model] 2`` per sample (each rank a replica of
    the model group within it) and ``[model] 4`` (the group across the
    ranks) on phase 21's 64 files from its kernel, the 2x2 ``[batch] 32``
    x ``[model] 2`` grid on phase 9's 512 files (``--epochs 2``) and
    ``[batch] 32`` CG on phase 20's [0, 1] bars (``--epochs 2``, 4
    iterations an epoch): rank 0's lines equal the one process's, rank 1
    prints nothing, kernel.opt within 1e-11 ``[batch]`` and grid, 1e-12
    per sample, 1e-9 CG; B1 and B4 launch on no rank, and on cards B2
    launches on each rank where the route's products are its."""
    import torch

    from hpnn_tpu_torch import api

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "rank_grid")
    cards = torch.cuda.device_count()
    nccl = cards >= 2 * RANK_SHARDS
    corpora = _rank_corpora(e2e, tmp)
    ref_devs = _grid_devices(2 * RANK_SHARDS)
    res = {"cards": cards, "branch": "nccl" if nccl else "gloo",
           "reference_devices": [str(d) for d in ref_devs], "cases": {}}
    log(f"rank grid (phase 30), {cards} x {card}: "
        + (f"2 NCCL ranks of {RANK_SHARDS} cards (cuda:0-1, cuda:2-3)"
           if nccl else f"2 gloo ranks of {RANK_SHARDS} CPU shards (one "
           "card: NCCL cannot put two ranks on it)")
        + f", held to one process over {res['reference_devices']}")
    dirs = []
    for tag, train, corpus, extra, *_ in RANK_CASES:
        pair = []
        for side in ("one", "ranks"):
            d = _b_conf(os.path.join(root, tag.replace(" ", "_") + side),
                        "ANN", train, MNIST, corpora[corpus], extra)
            if corpus == "s64":
                path = os.path.join(d, "nn.conf")
                with open(path) as fp:
                    text = fp.read()
                with open(path, "w") as fp:
                    fp.write(text.replace("[init] generate",
                                          f"[init] {corpora['pre']}"))
            pair.append(d)
        dirs.append(pair)
    cases = [(d[1], _free_port(), [*c[4], "nn.conf"], c[5])
             for d, c in zip(dirs, RANK_CASES)]
    out_path = os.path.join(root, "ranks.json")
    env = dict(os.environ, HPNN_DISTRIBUTED="1", HPNN_NUM_PROCESSES="2",
               HPNN_DIST_TIMEOUT_S="120",
               PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    if nccl:
        vis = os.environ.get("CUDA_VISIBLE_DEVICES")
        first = (vis.split(",") if vis else
                 [str(i) for i in range(cards)])[:2 * RANK_SHARDS]
        env.update(CUDA_VISIBLE_DEVICES=",".join(first),
                   LOCAL_WORLD_SIZE="2")
    else:
        # one intra-op thread a rank, as _gloo_start: reproducible sums
        env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = []
    for r in range(2):
        renv = dict(env, HPNN_PROCESS_ID=str(r), LOCAL_RANK=str(r)) if nccl \
            else dict(env, HPNN_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_WORKER, ROOT, out_path,
             "0" if nccl else str(RANK_SHARDS), "cuda" if nccl else "cpu",
             json.dumps(cases)], cwd=root, env=renv, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    # the one process's references while the ranks run
    refs = []
    for c, (one, _) in zip(RANK_CASES, dirs):
        with api.device_slice(ref_devs):
            refs.append(_ckpt_train(one, [*c[4], "nn.conf"], c[5]))
    try:
        done = [p.communicate(timeout=RANK_LIMIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res["ranks_wall_s"] = time.perf_counter() - t0
    ranks = []
    for r, (p, (o, e)) in enumerate(zip(procs, done)):
        path = f"{out_path}.{r}"
        got = json.load(open(path)) if os.path.exists(path) else []
        if p.returncode != 0 or len(got) != len(RANK_CASES) \
                or any(c["rc"] != 0 for c in got):
            bad = next((c for c in got if c["rc"] != 0), None)
            raise AssertionError(
                f"rank {r} (phase 30, {res['branch']}): exit "
                f"{p.returncode}, {len(got)} of {len(RANK_CASES)} cases ran"
                + (f"; failed case's stderr:\n{bad['err']}" if bad else
                   f"\n{e[-3000:]}"))
        ranks.append(got)
    for i, (tag, *_, key, limit, b2_path) in enumerate(RANK_CASES):
        ref, one_dir, rank_dir = refs[i], dirs[i][0], dirs[i][1]
        r0, r1 = ranks[0][i], ranks[1][i]
        want = _train_lines(ref["out"], key)
        got = _train_lines(r0["out"], key)
        quiet = "".join(ln for ln in r1["out"].splitlines(True)
                        if not ln.startswith("NN(DBG)"))
        err = _kernel_diff(_grid_opt(one_dir), _grid_opt(rank_dir))
        b2 = [r0["launches"]["fused_linear_act"],
              r1["launches"]["fused_linear_act"]]
        stray = [r["launches"][k] for r in (r0, r1)
                 for k in ("train_epoch", "train_tile")]
        if got != want or not want or quiet or err > limit or any(stray) \
                or (nccl and b2_path and min(b2) <= 0):
            raise AssertionError(
                f"{tag} (phase 30, {res['branch']}): {key} lines equal "
                f"{got == want} ({len(got)} / {len(want)}), rank 1 printed "
                f"{quiet[:200]!r}, kernel.opt {err:.3e} from the one "
                f"process (limit {limit:g}), B2 launches by rank {b2}, B1/B4 "
                f"{stray}")
        res["cases"][tag] = {
            "lines": len(got), "max_abs_err": err, "b2_launches": b2,
            "wall_s": [r0["wall_s"], r1["wall_s"]],
            "one_wall_s": ref["wall_s"],
            "one_b2_launches": ref["launches"]["fused_linear_act"]}
        log(f"rank grid {tag}: {len(got)} {key} lines equal to the one "
            f"process's, kernel.opt within {err:.3e}; B2 launches by rank "
            f"{b2} (one process {ref['launches']['fused_linear_act']}); "
            f"wall by rank {[round(r0['wall_s'], 2), round(r1['wall_s'], 2)]}"
            f" s, one process {ref['wall_s']:.2f} s")
    res["wall_s"] = time.perf_counter() - t_phase
    return res


@contextlib.contextmanager
def _children_on_first_card():
    """The child processes started inside see the first visible card alone
    (``CUDA_VISIBLE_DEVICES``), as on a one-card host; a no-op on one
    card.  This process's CUDA context, made first, keeps every card."""
    import torch

    torch.cuda.init()
    if torch.cuda.device_count() < 2:
        yield
        return
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    first = (old or "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = first
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


def _phase(name, fn, *args):
    """Run one phase, its wall seconds kept under ``name``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) \
            + time.perf_counter() - t0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write every cell's numbers to PATH")
    json_path = ap.parse_args(argv).json
    try:
        import torch
    except ImportError:
        sys.stderr.write("chip_smoke: torch is not installed\n")
        return 1
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device is visible "
                         "(torch.cuda.is_available() is False)\n")
        return 1
    if not os.path.isdir(os.path.join(ROOT, "hpnn_tpu_torch")):
        sys.stderr.write("chip_smoke: run it from a checkout of the repo "
                         "(hpnn_tpu_torch/ is missing)\n")
        return 1
    sys.path.insert(0, ROOT)
    from hpnn_tpu_torch import api, runtime
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.convergence_tile_kernel import train_tile
    from hpnn_tpu_torch.ops.kernels import fused_bpm_update, fused_linear_act

    def reset_counts():
        fused_linear_act.launches = 0
        train_epoch_kernel.launches = 0
        train_tile.launches = 0
        fused_bpm_update.launches = 0

    t_start = time.perf_counter()
    runtime.pin_full_float32()
    # phases 1-28 hold the one-card routes: on a host of several cards
    # this process's training decisions stay on cuda:0, and the child
    # processes of phases 1-27 see that card alone (phase 28's CLI
    # process spans the cards, phase 29 pins each run to its grid)
    with tempfile.TemporaryDirectory(prefix="hpnn_chip_smoke_") as tmp, \
            contextlib.ExitStack() as pin, \
            contextlib.ExitStack() as children:
        pin.enter_context(api.device_slice([torch.device("cuda", 0)]))
        children.enter_context(_children_on_first_card())
        card = _phase("1 device", phase_device)
        built = _phase("2 build", phase_build)
        errs = _phase("3 kernel vs plain", phase_kernel_vs_plain)
        invariance_plans = _phase("14 invariance", phase_invariance)
        train, first_launch = _phase("7 train_epoch vs plain",
                                     phase_train_vs_plain)
        resume_launches = _phase("8 resume contract", phase_resume)
        tile_runs = _phase("10 train_tile vs plain", phase_tile_vs_plain)
        contracts = _phase("11 tile contracts", phase_tile_contracts)
        runs = _phase("4 corpora", _setup_runs, tmp)
        reset_counts()                         # fused_linear_act's path
        results = _phase("4 run_nn", phase_run_nn, runs)
        _phase("5 serve_nn", phase_serve, runs, results)
        launches = fused_linear_act.launches
        bpm_path = fused_bpm_update.launches   # no path calls it
        reset_counts()                         # train_epoch's path
        e2e = _phase("9 train_nn", phase_train_nn, tmp)
        train_launches = train_epoch_kernel.launches
        train_path_fused = fused_linear_act.launches
        bpm_path += fused_bpm_update.launches
        if train_launches <= 0 or train_path_fused <= 0:
            raise AssertionError(
                f"train_nn + run_nn: train_epoch launched "
                f"{train_launches} times, fused_linear_act "
                f"{train_path_fused}")
        log(f"train path launches: train_epoch {train_launches}, "
            f"fused_linear_act {train_path_fused}")
        epoch = _phase("9 epoch time", phase_train_time, e2e)
        reset_counts()                         # train_tile's path
        tile_e2e = _phase("12 train_nn --tile", phase_train_nn_tile, e2e)
        tile_launches = train_tile.launches
        tile_path = {"train_tile": tile_launches,
                     "train_epoch": train_epoch_kernel.launches,
                     "fused_linear_act": fused_linear_act.launches}
        bpm_path += fused_bpm_update.launches
        if tile_launches <= 0 or tile_path["train_epoch"] != 0 \
                or tile_path["fused_linear_act"] <= 0:
            raise AssertionError(f"train_nn --tile + run_nn launches: "
                                 f"{tile_path}")
        log("tile path launches: " + ", ".join(
            f"{k} {v}" for k, v in tile_path.items()))
        # from here each path's run sets the counts to 0 itself
        epochs_runs = _phase("16 --epochs", phase_train_epochs, e2e)
        bpm_path += sum(r["launches"]["fused_bpm_update"]
                        for r in epochs_runs.values())
        ckpt_runs = _phase("17 --resume", phase_ckpt_resume, e2e,
                           epochs_runs)
        bpm_path += sum(r["fused_bpm_update"] for r in ckpt_runs.values())
        corpus_res = _phase("18 corpus", phase_corpus, e2e, tmp)
        serve_rest = _phase("19 serve_nn rest", phase_serve_rest, e2e,
                            tmp, card)
        tile_epoch = _phase("12 tile time", phase_tile_time, e2e,
                            tile_e2e, epoch)
        tuned = _phase("12 autotune", phase_autotune, tmp)
        tile_auto = _phase("12 tile auto", phase_tile_auto, e2e, tuned,
                           tile_epoch)
        batched = _phase("20 batched", phase_batched, e2e, tmp)
        tp_res = _phase("21 [model]", phase_tp, e2e, tmp, runs, results,
                        epochs_runs)
        jobs_res = _phase("22 jobs", phase_jobs, e2e, epochs_runs, tmp,
                          card)
        obs_res = _phase("23 observability", phase_observability, e2e,
                         epochs_runs, tmp, card)
        mesh_res = _phase("24 mesh", phase_mesh, tmp, card)
        sby_res = _phase("25 standby + autoscale",
                         phase_standby_autoscale, tmp, card)
        shard_res = _phase("26 shard mode", phase_shard, e2e, epochs_runs)
        capi_res = _phase("27 C API", phase_c_api, e2e, tmp, card)
        children.close()
        dmesh_res = _phase("28 data mesh", phase_data_mesh, tmp, card)
        pin.close()
        grid_res = _phase("29 grid", phase_grid, e2e, tmp, runs, results,
                          tp_res, card)
        rank_res = _phase("30 rank grid", phase_rank_grid, e2e, tmp, card)
    cells = _phase("6 device times", phase_times)
    bpm = _phase("13 fused_bpm_update", phase_bpm)
    rep = next(c for c in cells if c["layer"] == "784->300"
               and c["dtype"] == "f32" and c["B"] == 4096)
    rep1 = next(c for c in cells if c["layer"] == "784->300"
                and c["dtype"] == "f32" and c["B"] == 1)
    worst = max(cells, key=lambda c: c["ms"] / c["library_ms"])
    cell = next(r for r in train if r["run"].startswith("mnist ANN BP f64"))
    first_cell = next(iter(first_launch))   # the library's first launch
    tcell = next(r for r in tile_runs
                 if r["run"].startswith("mnist ANN BP f64 tile 8"))
    bcell = next(c for c in bpm if c["shape"] == "300x784"
                 and c["dtype"] == "f32")
    bpm_bf16 = dmesh_res["bpm_bf16"]
    ep_b1 = epochs_runs["per-sample"]
    ep_b4 = epochs_runs[f"tile {TRAIN_TILE}"]
    ck_b1 = ckpt_runs["per-sample"]
    ck_b4 = ckpt_runs[f"tile {TRAIN_TILE}"]
    kernels = {"kernels": [{
        "name": "fused_linear_act", "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/fused_linear_act.cu",
        "replaces": "hpnn_tpu/ops/pallas_kernels.py:84",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_dtype": {d: max(e for k, e in errs.items()
                                        if k[2] == d) for d in _dtypes()},
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "timed_cell": "784->300 f32 B=4096 (the run_nn MNIST input "
                      "layer)",
        "b1_ms": rep1["ms"], "b1_plain_ms": rep1["plain_ms"],
        "b1_library_ms": rep1["library_ms"], "b1_bound_ms": rep1["bound_ms"],
        "b1_cell": "784->300 f32 B=1 (a strict serving bucket)",
        "worst_library_ratio": worst["ms"] / worst["library_ms"],
        "worst_library_ratio_cell": f"{worst['layer']} {worst['dtype']} "
                                    f"B={worst['B']}",
        "invariance_plans": len(invariance_plans),
        "serve_rest_launches": serve_rest["launches"],
        "serve_rest_batches": serve_rest["batches"],
        "corpus_launches": {f"{tag} {m}": r[m]["launches"]
                            for tag, r in corpus_res["run_nn"].items()
                            for m in ("off", "cold", "warm") if m in r},
        "tp_launches": {
            "run_nn [model] 2": tp_res["run_nn"]["launches"],
            **{f"{tag} B={b}": c["launches_per_batch"][b]
               for tag, c in tp_res["serve"].items()
               for b in TP_SERVE_BUCKETS}},
        "jobs_launches": jobs_res["b2_launches"],
        "jobs_batches": jobs_res["batches"],
        "obs_profile_events": obs_res["serve"]["profile"]["b2_events"],
        "obs_profile_launches": obs_res["serve"]["profile"]["launches"],
        "obs_profile_us_per_batch":
            obs_res["serve"]["profile"]["b2_us_per_batch"],
        "mesh_launches": mesh_res["worker_a"],
        "standby_launches": sby_res["worker_a"],
        "c_api_launches": capi_res["in_process"]["fused_linear_act"],
        "data_mesh_launches": dmesh_res["launches"],
        "data_mesh_swap_launches": dmesh_res["swap"]["launches"],
        "data_mesh_swap_batches": dmesh_res["swap"]["batches"],
        "data_mesh_ms": {
            tag: {k: c.get(k) for k in ("p50_ms", "fast_p50_ms",
                                        "device_ms", "fast_device_ms",
                                        "shard_ms", "whole_ms")}
            for tag, c in dmesh_res["cells"].items()},
        "grid_launches": {
            "run_nn [model] 2 over 2 shards": grid_res["run_nn"]["launches"],
            "train_nn [model] 2 per sample over 2 shards":
                grid_res["model"]["b2_launches"],
            "train_nn [batch] 32 x [model] 2 on 2x2":
                grid_res["hybrid"]["launches"]["fused_linear_act"]},
        "rank_grid_branch": rank_res["branch"],
        "rank_grid_launches": {tag: c["b2_launches"]
                               for tag, c in rank_res["cases"].items()}}, {
        "name": "train_epoch", "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/train_epoch.cu",
        "replaces": "hpnn_tpu/ops/convergence_pallas.py:208",
        "launches": train_launches,
        "max_abs_err": max(r["max_abs_err"] for r in train),
        "max_abs_err_by_dtype": {d: max(r["max_abs_err"] for r in train
                                        if r["dtype"] == d)
                                 for d in _dtypes()},
        "ms": cell["ms"], "plain_ms": cell["plain_ms"],
        "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
        "library_ms": None,
        "us_per_iter": cell["ms"] * 1e3 / cell["iters"],
        "plain_us_per_iter": cell["plain_ms"] * 1e3 / cell["plain_iters"],
        "bound_us_per_iter": cell["bound_ms"] * 1e3 / cell["iters"],
        "timed_cell": f"{cell['run']}, one epoch of {cell['iters']} "
                      "iterations",
        "train_nn_epoch_ms": epoch["ms"],
        "train_nn_us_per_iter": epoch["us_per_iter"],
        "train_nn_iters": epoch["iters"],
        "barriers_per_iter": epoch["barriers_per_iter"],
        "first_launch_cell": f"{first_cell}, 1 MNIST ANN BP sample",
        "first_launch_ms": first_launch[first_cell]["first_ms"],
        "second_launch_ms": first_launch[first_cell]["second_ms"],
        "smem_bytes_per_block": epoch["plan"]["smem_bytes"],
        "resident_plan": epoch["plan"]["resident"],
        "blocks": epoch["plan"]["blocks"],
        "budgeted_launches": resume_launches,
        "epochs_launches": ep_b1["launches"]["train_epoch"],
        "epochs_device_ms": ep_b1["epoch_device_ms"],
        "epochs_wall_s": ep_b1["wall_s"],
        "ckpt_launches": ck_b1["launches"],
        "ckpt_wall_s": ck_b1["wall_s"],
        "corpus_epochs_device_ms": {
            m: r["epoch_device_ms"]
            for m, r in corpus_res["train_nn_epochs"].items()},
        "tp_launches": {f"train_nn {tag}": r["launches"]["train_epoch"]
                        for tag, r in tp_res["train"].items()},
        "jobs_launches": jobs_res["b1_launches"],
        "jobs_epochs_device_ms": jobs_res["epoch_device_ms"],
        "obs_launches": obs_res["train"]["launches"]["train_epoch"],
        "obs_profile_us": obs_res["train"]["b1_profile_us"],
        "shard_launches": {t: r["launches"] for t, r in shard_res.items()
                           if not t.startswith("tile")},
        "shard_epochs_device_ms": {
            t: r["epoch_device_ms"] for t, r in shard_res.items()
            if not t.startswith("tile")},
        "c_api_launches": capi_res["in_process"]["train_epoch"],
        "grid_launches": _grid_launches(grid_res, "train_epoch")}, {
        "name": "train_tile", "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/train_tile.cu",
        "replaces": "hpnn_tpu/ops/convergence_tile.py:423",
        "launches": tile_launches,
        "max_abs_err": max(r["max_abs_err"] for r in tile_runs),
        "max_abs_err_by_dtype": {d: max(r["max_abs_err"] for r in tile_runs
                                        if r["dtype"] == d)
                                 for d in _dtypes()},
        "ms": tcell["ms"], "plain_ms": tcell["plain_ms"],
        "bound_ms": tcell["bound_ms"], "bound_by": tcell["bound_by"],
        "library_ms": None,
        "us_per_lockstep": tcell["ms"] * 1e3 / tcell["lockstep"],
        "plain_us_per_lockstep": (tcell["plain_ms"] * 1e3
                                  / tcell["plain_lockstep"]),
        "timed_cell": f"{tcell['run']}, one epoch of {tcell['lockstep']} "
                      f"lockstep iterations",
        "train_nn_epoch_ms": tile_epoch["ms"],
        "train_nn_lockstep": tile_epoch["lockstep"],
        "train_nn_lane_iters": tile_epoch["lane_iters"],
        "train_nn_us_per_lockstep": tile_epoch["us_per_lockstep"],
        "train_nn_lane_iters_per_s": tile_epoch["lane_iters_per_s"],
        "train_epoch_iters_per_s": tile_epoch["b1_iters_per_s"],
        "train_nn_bound_us_per_lockstep":
            tile_epoch["bound_us_per_lockstep"],
        "barriers_per_lockstep": tile_epoch["barriers_per_lockstep"],
        "plan": {k: tile_epoch["plan"][k] for k in ("blocks", "warps",
                                                     "scratch_on_chip",
                                                     "resident",
                                                     "smem_bytes")},
        "first_launch_ms": tile_epoch["first_ms"],
        "second_launch_ms": tile_epoch["ms"],
        "auto_tile": tile_auto["tile"],
        "auto_tile_us_per_lockstep": tile_auto["us_per_lockstep"],
        "auto_tile_lane_iters_per_s": tile_auto["lane_iters_per_s"],
        "fastest_epoch_tile": tile_auto["fastest_tile"],
        "epoch_ms_by_tile": {k: e["ms"]
                             for k, e in tile_auto["by_tile"].items()},
        "stack_frame_bytes": built["stack_frame_bytes"],
        "spill_bytes": built["spill_bytes"],
        "scratch_plan": {k: tile_runs[-1]["plan"][k] for k in (
            "scratch_on_chip", "smem_bytes", "ws_bytes")},
        "contracts": contracts,
        "epochs_launches": ep_b4["launches"]["train_tile"],
        "epochs_device_ms": ep_b4["epoch_device_ms"],
        "epochs_wall_s": ep_b4["wall_s"],
        "ckpt_launches": ck_b4["launches"],
        "ckpt_wall_s": ck_b4["wall_s"],
        "batch_tile_launches": batched["tile"]["launches"],
        "batch_tile_epoch_ms": batched["tile"]["epoch_ms"],
        "batch_tile_lane_iters_per_s": batched["tile"]["lane_iters_per_s"],
        "batch_tile_vs_plain_bitwise": batched["tile"]["bitwise"],
        "batch_tile_max_abs_err": batched["tile"]["max_abs_err"],
        "shard_launches": {t: r["launches"] for t, r in shard_res.items()
                           if t.startswith("tile")},
        "shard_epochs_device_ms": {
            t: r["epoch_device_ms"] for t, r in shard_res.items()
            if t.startswith("tile")},
        "grid_launches": _grid_launches(grid_res, "train_tile")}, {
        "name": "fused_bpm_update", "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/fused_bpm_update.cu",
        "replaces": "hpnn_tpu/ops/pallas_kernels.py:141",
        "launches": bpm_path,
        "phase_launches": fused_bpm_update.launches,
        "max_abs_err": max(c["max_abs_err"] for c in bpm + bpm_bf16),
        "max_abs_err_by_dtype": {d: max(c["max_abs_err"]
                                        for c in bpm + bpm_bf16
                                        if c["dtype"] == d)
                                 for d in ("f64", "f32", "bf16")},
        "ms": bcell["ms"], "plain_ms": bcell["plain_ms"],
        "bound_ms": bcell["bound_ms"], "bound_by": bcell["bound_by"],
        "library_ms": None,
        "timed_cell": "300x784 f32 (the MNIST input layer), warm",
        "warm_ms": bcell["ms"], "cold_ms": bcell["cold_ms"],
        "floor_ms": bcell["floor_ms"],
        "by_shape": {f"{c['shape']} {c['dtype']}": {
            k: c[k] for k in ("ms", "cold_ms", "bound_ms")}
            for c in bpm + bpm_bf16 if "ms" in c}}]}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as fp:
            json.dump({"card": card, "kernels": kernels["kernels"],
                       "cells": cells, "train_runs": train,
                       "train_first_launch": first_launch,
                       "train_nn": {**e2e, "epoch": epoch},
                       "tile_runs": tile_runs, "tile_contracts": contracts,
                       "train_nn_tile": {**tile_e2e, "epoch": tile_epoch,
                                         "launches": tile_path},
                       "autotune": tuned, "tile_auto": tile_auto,
                       "train_nn_epochs": epochs_runs,
                       "train_nn_resume": ckpt_runs,
                       "corpus": corpus_res,
                       "serve_rest": serve_rest,
                       "batched": batched,
                       "tp": tp_res,
                       "jobs": jobs_res,
                       "observability": obs_res,
                       "mesh": mesh_res,
                       "standby_autoscale": sby_res,
                       "shard": shard_res,
                       "c_api": capi_res,
                       "data_mesh": dmesh_res,
                       "grid": grid_res,
                       "rank_grid": rank_res,
                       "phase_seconds": PHASE_SECONDS,
                       "invariance_plans": invariance_plans,
                       "bpm": bpm,
                       "errors": [{"layer": k[0], "scale": k[1],
                                   "dtype": k[2], "B": k[3],
                                   "max_abs_err": v}
                                  for k, v in errs.items()]}, fp, indent=1)
    log("chip_smoke: phase seconds " + json.dumps(
        {k: round(v, 3) for k, v in PHASE_SECONDS.items()}))
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
