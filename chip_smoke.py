#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--breakdown]

Phases (each prints its own lines; any mismatch exits nonzero):

1. device: the card's name and power limit (``nvidia-smi``); no CUDA
   device -> exit 1 before anything else.
2. build: compile every kernel of the served path (``nvcc``, one process
   per source, started together) and print the build time; count the
   FP64 instructions of ``erf``, ``exp`` and a division in the SASS of one
   call of each (``cuobjdump -sass``), for ``alert_select``'s second
   bound.
3. kernel vs plain: ``alert_select`` v2 on the card against its plain
   PyTorch version on the same inputs, at S in {1, 4097, 65536} lanes of a
   seeded K=12 x L=8 table (mixed goals, dead lanes holding garbage, both
   energy modes, predictions on and off); then K x L in {1x1, 4x4, 5x7,
   12x8, 32x4} at S in {1, 7, 257, 4097} (none a multiple of the lanes a
   block takes, but 1) with live lanes whose mu is NaN and lanes whose
   every Eq. 7 CDF is 0, on the engine's tables and on tables that force
   tied scores, +0.0 and -0.0 scores, and NaN cells.  Every output must
   be bitwise equal (NaN equal to NaN).  Times the kernel and the plain
   version at S=65536 with CUDA events and prints the bound and a second
   bound that counts every FP64 instruction of a cell.
4. serve (``blocks`` nest backend): ``alert-anytime-120m`` at full width
   and ``SERVE_DEPTH`` = 4 of its 12 layers in bf16 with weights from a
   seed-0 ``torch.Generator`` on the card,
   behind a ``FleetAlertServer`` (8 streams, batch 4, prompt 8, 4 new
   tokens) profiled on the card, for 4 ticks of Eq. 4 and Eq. 5 tenants
   with one retire/admit; the engine replays one CUDA graph per level
   (prefill per prompt length, decode), captured while the server
   profiles.  Checks every live lane's result, the tokens,
   that ``alert_select``'s launch counter grew by one per tick and that
   ``nested_matmul`` never launched; then holds ``alert_select`` to its
   plain version on the server's own lane state.  Before that, the port's
   model on the card is held to the same model on the CPU at a reduced
   size.  After it, the same server with the engine's steps run eagerly
   (the yardstick for the tick times), and the graphed engine against the
   eager one at every level over three rounds of level switches: tokens
   bitwise equal, ``n_compiles()`` flat, the launches a replay counts
   equal to the eager call's and to the kernel nodes read back from each
   graph.  Times ``alert_select`` at the main-path shape back to back and
   as device time (CUDA graph), and one ``select`` call's host time.
5. ``nested_matmul`` kernel vs plain: the model's three projection
   geometries (768x768, 768x3072, 3072x768, 4 pow2 levels) at every level,
   M in {4, 32}, bf16 and float32, a level-prefix view of ``x`` and the
   full ``w``, within ``NM_TOL``.  Times every geometry at every level,
   M in {4, 32}, as device time (CUDA graph, weights rotated beyond L2)
   beside the library call, the bound and its share, with the grid and
   cluster each call launched read back from a CUDA graph of it (they
   must be the split plan's); the deepest level of each geometry at
   forced split counts beside the plan's, each read back the same way;
   the deepest level in one launch against its low stripes and its top
   stripe launched apart (what the idle blocks of a uniform split
   cost); then the d->d_ff
   geometry at level 4
   (M=32 and M=4) and one level-4 forward's 84 projections: the kernel,
   its plain version, the ``blocks`` backend and a dense matmul on the
   block-masked weight (the library call) as device time (CUDA graph),
   back to back, and the wrapper's host cost per call, beside the bound.
   None of these calls (M <= 32) may take v4.  Then the scoring
   prefill's shapes: M = 512 at Mistral-7B's four geometries (4096x4096,
   4096x1024, 4096x14336, 14336x4096) at every level, v4 checked against
   its plain version and timed beside it, the library call and the
   bound, each launch read back (the v4 plan's grid and cluster); v4
   against the plain version also at M = 520 (a partial row tile) and on
   stripes no multiple of 64 or 128; and v3 against v4 forced in turn at
   M = 32 .. 512 over both models' geometries (the crossover).
6. the reduced float32 model with the ``kernel`` nest backend on the card
   against the same model with ``blocks`` on the CPU, within 1e-4.
7. serve (``kernel`` nest backend): phase 4 again with
   ``nest_backend="kernel"``; ``nested_matmul`` must launch 28 times per
   forward pass (7 projections x 4 layers; one forward per generated
   token) and ``alert_select`` once per tick; graphed against eager as in
   phase 4.
8. ``flash_attention`` and ``decode_attention`` kernel vs plain, bf16 and
   float32, within ``ATT_TOL``: (a) the served shapes (prefill B=4,
   S=T=8, h=kv in {1, 2, 4, 8}, hd=96; decode over the 12-slot cache at
   cache_len 9-12, by value and per row); (b) the model at a 2048-token
   prompt (prefill B=4, S=T=2048, h=kv=8, causal; decode B=4 over a 2048
   cache with ragged per-row lengths); (c) gemma3-1b's attention geometry
   (h=4, kv=1, hd=256: prefill B=1, S=T=4096, causal with window 512, and
   once more with softcap 50; decode B=4 over a 32768 cache, global and
   with window 512); then the split and padding paths (decode at B=1
   over a 32768 cache with 8 query heads on one kv head, ragged rows
   [32768, 31, 0, 4097], a window over per-row lengths; prefill at hd 8,
   40, 72 and 128, a ragged causal S=100, a window at S=1000, and at hd
   96 past one key tile (the ``wgmma`` kernel) with softcap 50 and
   without the causal mask).  Each decode call's kernels are read back
   from a CUDA graph of the call (names and grids through the driver
   API), printed with the splits and blocks they show, and must be the
   split plan's: the split kernel, and the combine exactly when the plan
   splits.  Times (b) and (c) in bf16 as device time (a CUDA graph of
   calls over input sets rotated beyond the 50 MB L2): kernel and
   ``scaled_dot_product_attention`` (the library yardstick, which the
   port never calls), both also back to back (host work between calls),
   the plain version back to back, the bound, and the TFLOP/s or GB/s
   reached with its share of the bound; and the served shapes as device
   time.  Then the dense family's served geometries, timed the same way
   beside the bound and ``scaled_dot_product_attention``
   (``DENSE_FLASH``, ``DENSE_DECODE``): qwen2.5-14b's prefill B=4, S=8,
   h=40, kv=8, hd=128 and decode over the 12-slot cache at per-row
   lengths (g=5: the second block of a KV head has one live head);
   stablelm-12b's h=32, kv=8, hd=160; gemma3-1b's served prefill B=4,
   S=8, h=4, kv=1, hd=256 and decode over the 12-slot cache at per-row
   lengths, both with window 512, and its 1024-token prompt and
   1024-position cache with window 512 (scalar and per-row lengths); g=5
   decode with window 512 over per-row lengths; the MoE family's served
   prefill B=4, S=8 and decode over the 12-slot cache at per-row lengths:
   olmoe-1b-7b's h=kv=16, hd=128 (g=1) and qwen3-moe-30b-a3b's h=32,
   kv=4, hd=128 (g=8: two 4-head decode blocks a KV head); and the same
   for jamba-v0.1-52b's h=32, kv=8, hd=128 (g=4) and qwen2-vl-2b's h=12,
   kv=2, hd=128 (g=6: the second decode block of a KV head has two live
   heads); and the encoder-decoder's shapes (``WHISPER_FLASH``,
   ``WHISPER_DECODE``; whisper-tiny's h=kv=6, hd 64, B=4): S=4 queries
   over T=1500 frames, the encoder's non-causal S=T=1500, S=1 over
   T=1500 and S=37 over T=100 (the first callers with S != T and of the
   hd-64 instance; a ragged last key tile at T=1500), the decoder's
   causal self-attention over the S=T=4 prompt, and decode over the 1500
   frames, all live.
9. the reduced float32 model with the ``kernel`` nest backend and
   ``attn_backend="kernel"`` on the card against the same model with
   ``blocks``/``ref`` on the CPU, within 1e-4 (head_dim 8).
10. serve with every kernel on the path: phase 4 again at the full 12
    layers with both kernel backends; ``alert_select`` once per tick,
    ``nested_matmul`` 84 times
    per forward, ``flash_attention`` 12 times per prefill forward and
    ``decode_attention`` 12 times per decode forward; graphed against
    eager as in phase 4.  Then the per-level ``generate`` latency (the
    staircase) of the graphed and the eager engine through the profiling
    harness (``profile_anytime_measured(engine_level_fns(...))``), in
    turns; the staircase of both engines from the profile that builds
    ALERT's table (``serve_level_latencies``: the levels interleaved
    round by round), two repeated profiles from the halves of its rounds
    and their spread (a graphed staircase that does not rise by more
    than that spread fails); the device time of
    one prefill and one decode forward at levels 1 and 4 (CUDA events
    around one replay of the engine's graph) beside its launch floor (its
    kernel nodes times the device time of a near-empty graph node); and
    the tick times of every served configuration, graphed and eager.
11. ``rwkv_scan`` v3 kernel vs plain, bf16 and float32 with s0 and u
    nonzero, y and the final state within ``RS_TOL``: (a) rwkv6-3b's
    served shapes (B=4, H=40, hd=64, an 8-token prefill and a 1-token
    decode step), a ragged S=77 at hd 16, 32 and 64 (strided views at
    64), plans forced to 1, 2, 3 and 7 segments (ragged segments, and
    S < P), (b) a 2048-token prompt (B=4) and (c) ``RWKV_LONG`` = 32768
    tokens (B=1).  Every call is made twice and must be bitwise equal,
    and the kernels of each float32 call, read from a CUDA graph of it,
    must be its plan's.  Times (b) and (c) in float32 with CUDA events at
    the plan's segments and at other counts, and the served shapes as
    device time (CUDA graph), beside the bound and the plain version.
12. the reduced float32 RWKV-6 model on the card (the kernel) against the
    same model on the CPU (the plain scan): prefill logits and states,
    then 3 decode steps, within 1e-4.
13. serve ``rwkv6-3b`` at full width and depth (32 layers, d=2560) in
    bf16, weights from a seed-0 generator on the card, behind the fleet
    server as in phase 4 with its one level (power adapts only):
    ``rwkv_scan`` 32 times per forward (prefill and decode),
    ``alert_select`` once per tick, the other three kernels never;
    graphed against eager as in phase 4, and one graphed forward's device
    time beside the time to read the model's weights.
14. the reduced float32 ``qwen2.5-14b`` and ``gemma3-1b`` (q/k/v biases
    non-zero, a 12-token prompt past gemma3's window of 8) with
    ``attn_backend="kernel"`` on the card (the attention kernels) against
    the same model on the CPU (their plain versions): prefill logits and
    KV caches, then 3 decode steps, within 1e-4.
15. serve ``qwen2.5-14b`` at full width and depth (48 layers, d=5120,
    40 query heads over 8 KV heads of 128, q/k/v biases) in bf16, weights
    from a seed-0 generator on the card, with ``attn_backend="kernel"``,
    behind the fleet server as in phase 13: ``flash_attention`` 48 times
    per prefill forward, ``decode_attention`` 48 times per decode forward,
    ``alert_select`` once per tick, ``nested_matmul`` and ``rwkv_scan``
    never; graphed against eager as in phase 4; one graphed forward's
    device time beside its launch floor and beside the time to read the
    weights a decode step reads, and ``torch.cuda.max_memory_allocated``;
    with ``--breakdown``, also its device time by kind of kernel
    (``torch.profiler`` over three graph replays: a diagnostic that no
    check reads).
    The model is freed before the next phase.
16. serve ``gemma3-1b`` the same way (26 layers, 22 of them local with
    window 512); then, in float32 on the card, a 1024-token prompt (B=2)
    and 4 decode steps with ``attn_backend="kernel"`` against ``"ref"``,
    within 1e-4 (set from readings; the reason is in
    ``gemma_window_kernel_vs_ref``), and the same prefill with a window
    of 511, which must move the logits by more than that (a fault at the
    window's edge would show), and with the window off, by more than 10x
    that (the window bites).
17. serve ``stablelm-12b`` at full width (d=5120, hd 160) and
    ``STABLELM_DEPTH`` = 8 of its 40 layers, as phase 15.
18. the reduced float32 ``olmoe-1b-7b`` and ``qwen3-moe-30b-a3b`` with
    ``attn_backend="kernel"`` on the card against the same model on the
    CPU, as phase 14, and every MoE layer's routed expert ids of every
    step equal; then reduced ``olmoe-1b-7b`` at capacity factor
    ``MOE_DROP_FACTOR``, whose prefill must drop assignments (the number
    is printed), so the drop path runs on the card.
19. serve ``olmoe-1b-7b`` at full width and depth (16 layers, d=2048, 16
    query heads over 16 KV heads of 128, 64 experts of d_ff 1024, top-8)
    as phase 15; beside the weight read of a decode step (every expert:
    the one-hot dispatch reads them all), the read of only the experts the
    step's tokens were routed to (ids read in an eager step after the
    timed replays), and the assignments the prefill dropped.
20. serve ``qwen3-moe-30b-a3b`` the same way, at full width and depth
    (48 layers, 32 query heads over 4 KV heads of 128, 128 experts of
    d_ff 768, top-8; 61 GB of weights).  Its model is freed before phase
    21.
21. the reduced float32 ``jamba-v0.1-52b`` (7 Mamba layers, one
    attention layer, MoE on odd layers) and ``qwen2-vl-2b`` (given three
    distinct M-RoPE position streams in every forward) with
    ``attn_backend="kernel"`` on the card against the same model on the
    CPU, as phase 14: prefill logits and every cache (KV and
    ``MambaState``), then 3 decode steps, within 1e-4; every routed expert
    id equal; the attention kernels launched once per attention layer a
    forward.
22. serve ``jamba-v0.1-52b`` at full width and ``JAMBA_DEPTH`` = 16 of
    its 32 layers (two periods: 14 Mamba layers of d_inner 8192 and
    d_state 16, 2 attention layers of 32 query heads over 8 KV heads of
    128, 8 MoE layers of 16 experts of d_ff 14336 with top-2; 52.1 GB of
    weights) as phase 19: ``flash_attention`` and ``decode_attention`` 2
    times a forward; beside the weight reads, every expert's and the
    routed experts' bytes, and one Mamba layer alone (block and
    recurrence, decode and prefill, device time) with the Mamba layers'
    share of a forward.
23. serve ``qwen2-vl-2b`` at full width and depth (28 layers, 12 query
    heads over 2 KV heads of 128, q/k/v biases) text-only, as phase 15.
24. the reduced float32 ``whisper-tiny`` (2 encoder and 2 decoder
    layers, hd 16) with ``attn_backend="kernel"`` on the card against the
    same model on the CPU: 45 frames, a 12-token prompt, then 3 decode
    steps at per-row lengths; prefill logits, self caches and cross k/v,
    then each step's logits and caches, within 1e-4; ``flash_attention``
    6 times in the prefill, ``decode_attention`` 4 times a step.
25. ``whisper-tiny`` at full width and depth (4 encoder and 4 decoder
    layers, d=384, 6 heads of 64) in float32 on the card, B=4, T=1500
    frames (Whisper's 30-second window), the 4-token start-of-transcript
    prompt (3 tokens in two rows) and 4 decode steps at per-row lengths,
    ``attn_backend="kernel"`` against ``"ref"``, within 1e-4.
26. ``whisper-tiny`` in bf16 with ``attn_backend="kernel"`` (weights from
    a seed-0 generator on the card): the same batch, a 448-slot self
    cache (Whisper's text context) and 16 greedy decode steps, prefill and
    decode captured as CUDA graphs over static buffers (one request's
    cross k/v, a ``[B]`` device ``cache_len``) and replayed, then run
    eagerly: tokens bitwise equal, ``flash_attention`` 12 times a prefill
    forward (4 encoder, 4 decoder self, 4 cross) and ``decode_attention``
    8 times a decode forward (4 self, 4 cross), equal to each graph's
    kernel nodes; the device time of one prefill and one decode replay
    beside the decode step's reads and launch floor,
    ``max_memory_allocated``, and the attention kernels at the model's
    shapes (the encoder's B=4, S=T=1500 non-causal; the cross prefill's
    S=4 over T=1500; the decoder's causal S=T=4; decode over the 1500
    frames and over the self cache at per-row lengths) beside ``scaled_dot_product_attention`` and the
    bound; with ``--breakdown``, each replay's device time by kind of
    kernel.
27. serve ``qwen2.5-32b`` at full width and depth (64 layers, d=5120, 40
    query heads over 8 KV heads of 128, q/k/v biases; 65.5 GB of weights)
    with its short cache, as phase 15; freed before phase 28.
28. ``qwen2-vl-2b`` at full width and depth in float32 on the card with
    three distinct M-RoPE streams (an 8-token text, a 16 x 16-patch image,
    an 8-token text: 272 prompt tokens, B=2), one prefill and 3 decode
    steps, ``attn_backend="kernel"`` against ``"ref"`` within 1e-4; text-
    only RoPE must move the prefill logits by more than 10x that.
29. the fleet simulator's golden scenario (``golden_table()``: K=9
    candidates of the image family from their roofline terms, L=8; the
    middle of three deadlines, E_goal = 170 W x T_goal): ``FleetSim`` on
    the card over the seed-1 default, cpu and memory traces must give
    ``tests/golden_traces.json``'s alert mean energy, mean error and miss
    rate exactly, with one ``alert_select`` launch a tick, and
    ``InferenceSim.run_oracle`` its oracle numbers to rtol 1e-9; all
    seven schemes on the memory trace under both goals, on the card and
    on the CPU, bitwise equal.
30. a fleet of ``FLEET_LANES`` = 65536 churning streams on the same
    table (three environments, both goals, five deadlines, arrivals at
    ticks 0-99, 400 inputs each: T = 499 ticks) through ``run_fleet`` on
    the card: ``alert_select`` launched exactly T times; one stream of
    every 256, run on the CPU as a fleet of its own, bitwise equal to
    its rows; ``deliver_step`` on the card bitwise equal to
    ``deliver_tick`` at 16 recorded ticks; the mid-run tick's ``select``
    on the card bitwise equal to the CPU's over all 65536 lanes.  Prints
    the trace building and run seconds, the median tick, the card's busy
    time and idle share a tick over 5 ticks of the run (torch.profiler),
    and at the mid-run tick's inputs the medians of ``select``,
    ``deliver_tick``, ``deliver_step`` and the feedback step, each with its
    share of the tick.
31. the session gateway (``SessionGateway``: many sessions paged over
    few lanes, EDF admission, one ``select`` a served round) on the card,
    on the reference's recorded traffic cells.  (a) The golden overload
    workload (24 sessions over 8 lanes) must give
    ``tests/golden_traces.json``'s ``gateway`` summary with ``==``, and the
    straggler workload its ``straggler`` trip set, time and latency, with
    no trip without the fault.  (b) ``bench_traffic``'s 1024 Eq. 4
    sessions over 256 lanes at loads 0.5, 2, 8 and 24, under the
    controller and a fixed config, each run again with every select's
    kernel launch held to ``alert_select_plain`` on the same device
    tensors (picks, feasibility and relaxed codes bitwise on every lane),
    as are the runs of (a), (c) and (d); at loads 2 and 24 each run held
    to the port's host logic on the CPU (``hold_to_cpu``): driven with the
    card's decisions, the CPU sees bitwise the card's inputs at every
    select and ends bitwise equal, and where its own plain version picked
    otherwise the two picks' accuracies lie within 2 ulp on an active
    relaxed Eq. 4 lane (float64 ``torch.erf`` differs between the CPU and
    CUDA in the last bit).  (c) At load 8, a device loss (lanes 192-255
    quarantined) and a brownout; the brownout run killed and resumed
    from its checkpoint, bitwise equal to the uninterrupted run.  (d)
    ``bench_obs``'s 20,000 sessions over 1,024 lanes, held to the CPU as
    in (b): the median round, the mid-run round's paging, ``select``,
    ``deliver_tick`` and feedback (medians of synced calls), and the
    card's busy time and idle share over 5 rounds (torch.profiler).
    ``alert_select`` must launch once a served round under the controller
    and never under the fixed config.  Also prints at how many of 200,001
    points of [-8, 8] float64 ``torch.erf`` on the card differs from the
    CPU's.
32. the megatick (``MegatickGateway``: the gateway's round clock as one
    CUDA graph a chunk over ``alert_select``): (a) the golden workload
    with ``==``; (b) ``bench_megatick``'s 100,000 sessions over 4,096
    lanes, timed, bitwise against the host gateway, ``graphs=False`` and
    the CPU; (c) ``bench_obs`` bare, with the recorder disabled and
    instrumented, bitwise; (d) both faults; (e) the load sweep.
33. training (the joint anytime train step) and the trained weights
    served: (a) ``alert-anytime-120m`` at full width and depth (bf16
    params, float32 moments, ``blocks``/``ref``, remat "full") trained
    ``TRAIN_STEPS`` = 30 steps on 8 x 1024 synthetic tokens through the
    launcher's ``train`` and its ``Supervisor`` (a checkpoint every 10
    steps): the median step (CUDA events), tokens/s, TFLOP/s (counted from
    the live blocks) against 989, ``max_memory_allocated``; every loss
    finite and the mean of the last five below the first; (b) the trained
    weights, detached, with ``nest_backend="kernel"`` and
    ``attn_backend="kernel"``: each level's graphed prefill logits against
    ``train_logits(level=k)`` within ``TRAIN_SERVE_TOL`` of the largest
    logit, then 4 ticks of ``FleetAlertServer`` over 8 streams with the
    held-out accuracies (``alert_select``, ``nested_matmul``,
    ``flash_attention``, ``decode_attention``); (c)
    ``examples/serve_alert_torch.py`` with its defaults, its checks
    holding; (d) 3 float32 train steps of the reduced anytime LM,
    ``qwen2.5-14b``, ``olmoe-1b-7b`` (routed ids equal), ``jamba-v0.1-52b``,
    ``whisper-tiny`` and ``rwkv6-3b`` (its chunk scan) on the card against
    the CPU: step 1's gradients leaf by leaf within ``GRAD_TOL`` of each
    leaf's largest (``grads_close``, which names the leaves where the two
    differ in sign), then the parameters (``params_close``: 0.1 lr, 2 lr a
    step on those leaves); (e) the reduced anytime LM killed at step 7 and
    resumed from its step-6 checkpoint, bitwise the uninterrupted run,
    under deterministic algorithms.
34. RWKV training: (a) ``rwkv6-3b`` at full width (d 2560, 40 heads of
    64, d_ff 8960, vocab 65536), bf16 params, float32 moments, at the
    depth whose AdamW update fits under 70 GB (16 of 32 layers:
    ``rwkv_train_depth`` prints the reckoning), ``RWKV_TRAIN_STEPS`` = 6
    steps of ``make_train_step`` at B=4 x S=256 (the chunk scan, each
    128-token chunk recomputed): the median step (CUDA events),
    tokens/s, ``max_memory_allocated``, the losses (finite, the last below
    the first); (b) the trained weights: the graphed prefill on
    ``rwkv_scan`` against ``train_logits`` (the chunk scan) within
    ``RWKV_SERVE_ULPS`` bf16 ulps of each row's largest logit, then 4
    ticks of ``FleetAlertServer`` over them (``rwkv_scan`` must launch).
35. the serving launcher, ``repro_torch.launch.serve`` at its defaults:
    its report line, ``nested_matmul``, ``flash_attention``,
    ``decode_attention`` and ``alert_select`` launched.
36. the examples ``examples/*_torch.py`` but ``serve_alert_torch.py``
    (phase 33 (c)), each at its defaults (``live_profile_demo_torch.py``
    with ``--measured``): each prints its ``OK`` line, and launches the
    kernels ``EXAMPLES`` names for it.
37. the lane-sharded decision plane, shards laid on the card by
    ``make_lane_mesh(n, device=...)``, each launching its own
    ``alert_select`` on its contiguous block: (a) the golden scenario on
    1, 4 and 8 shards (S=1 padded) equal to the fixture with ``==`` and
    bitwise ``mesh=None``; (b) phase 30's fleet on 4 shards bitwise the
    unsharded run, 4 launches a tick, at the mid-run tick each shard's
    launch bitwise its plain version on its block; (c) phase 10's
    full-width ``alert-anytime-120m`` behind ``FleetAlertServer(
    n_streams=6)`` on 4 shards (capacity 8, one retire and admit) bitwise
    ``mesh=None`` in picks, tokens and lane state; (d) ``bench_traffic``
    on a 4-shard ``SessionGateway`` killed and resumed on 2 shards and on
    ``mesh=None``, both bitwise the uninterrupted run; (e) phase 32's
    ``bench_megatick`` on 4 shards bitwise, 4 ``alert_select`` nodes a
    round in its graph; (f) ``run_fleet_dryrun`` over ``make_lane_mesh()``
    and over 8 shards on the card, parity and nothing built under churn.
38. the data plane's (data, model) grid: (a) every arch at its full
    config with its AdamW state on ``meta`` (nothing placed), the
    sharding rules on ``make_production_mesh(device="meta")`` and its
    2x16x16 twin: every spec of rank at most its leaf's, each arch's
    per-device bytes (``shard_shape``), each cell's ``cell_supported``
    and projected memory term; (b) ``alert-anytime-120m`` whole, bf16,
    ``GRID_STEPS`` = 3 steps of phase 33's data and loss on a (2, 2)
    grid of shards on the card (``make_host_mesh(2, devices=[dev] *
    4)``), the loss and every leaf bitwise the unsharded
    ``microbatches=2`` step after each step (deterministic algorithms),
    each shard's bytes and the step times; (c) that run checkpointed
    after step 2 and resumed on ``remesh``'s (2, 1) grid and on no
    grid, step 3 bitwise; (d) the grid-trained weights joined on the
    card: graphed prefill logits against ``train_logits`` as phase 33
    (b), then 4 ticks of ``FleetAlertServer`` (``nested_matmul``,
    ``flash_attention``, ``decode_attention``, ``alert_select``); (e)
    the reference's mini dry run: reduced ``gemma3-1b``,
    ``jamba-v0.1-52b`` and ``rwkv6-3b`` on a (4, 2) grid, losses finite
    and not rising, bitwise the unsharded ``microbatches=4`` step.
39. the data plane's dry run (``launch/dryrun.py``): (a) its counter
    over the real step of ``alert-anytime-120m`` at full width on the
    plain paths on the card, train at B=8 x S=512 and prefill and decode
    at phase 10's served sizes, on a grid of 1: FLOPs, bytes and argument
    bytes equal to the ``meta`` count, op by op (``DRYRUN_PINNED`` names
    any op the two devices may differ by); (b) the prefill and decode
    records through ``roofline.analyze`` (the H100's constants), the same
    steps on the kernels' path timed with CUDA events: measured / bound
    printed and at least ``DRYRUN_BOUND_FLOOR``, ``nested_matmul``,
    ``flash_attention`` and ``decode_attention`` launched; (c)
    ``run_cell`` over every cell of ``DRYRUN_MESHES``'s grids, no
    ``fail``, the skips ``cell_supported``'s, the seconds printed.
40. the last lines: one JSON object per kernel (``launches``: the sum
    over every ``serve`` run, graphed and eager, of phases 4, 7, 10, 13,
    15-17, 19, 20, 22, 23 and 27, over phase 26's two runs, over the
    fleet and gateway runs of phases 29-32, over phase 33's serve run
    and example, phase 34's serve run, the launcher, the examples and
    the runs of phases 37-39; ``launches_by_run`` by phase), the
    ``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.

Each phase prints its seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: FP64 (non-tensor-core) 34 TFLOP/s, bf16
# dense tensor cores 989 TFLOP/s, HBM3 3.35 TB/s, all at the full 700 W
# power limit.  alert_select issues plain FP64 instructions, not the FP64
# tensor-core DMMA path; nested_matmul's bound uses the bf16 rate.
H100_FP64_FLOPS = 34e12
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/alert_select.cu"
KERNEL_REPLACES = "src/repro/kernels/alert_select.py:164"
KERNEL_CU = ROOT / KERNEL_SOURCE
NM_SOURCE = "src/repro_torch/kernels/csrc/nested_matmul.cu"
NM_REPLACES = "src/repro/kernels/nested_matmul.py:81"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:86"
DA_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
DA_REPLACES = "src/repro/kernels/decode_attention.py:74"
FA_VERSION = ("v2: bf16 on the tensor cores (FlashAttention-2 design, "
              "2-stage cp.async ring): wgmma at hd 72-96 past one key "
              "tile, mma.sync otherwise; float32 on the CUDA cores as v1")
NM_VERSION = ("v4 from M = 128 (bf16, 16-byte aligned rows): wgmma on "
              "256/128 x 128 tiles fed by TMA through a 4-6 stage mbarrier "
              "ring, one producer warpgroup and two consumers, the longest "
              "k first, long tiles split in k across a cluster with a "
              "fixed-order sum; v3 below: bf16 on the tensor cores "
              "(mma.sync), 64-column tiles split in k across a "
              "thread-block cluster, 4-stage cp.async ring, fixed-order sum "
              "through distributed shared memory; float32 and unaligned "
              "bf16 on the CUDA-core kernel (v2)")
DA_VERSION = ("v4: split-K flash-decoding (runs of whole tiles across "
              "blocks, then a combine kernel); one split at the served "
              "shapes")
RS_SOURCE = "src/repro_torch/kernels/csrc/rwkv_scan.cu"
RS_REPLACES = "src/repro/kernels/rwkv_scan.py:59"
RS_VERSION = ("v3: each sequence cut into the plan's segments (states "
              "pass from zero, a fold in segment order, then every "
              "segment rerun for y), a 16 x 4 state tile a thread, a "
              "2-stage cp.async ring; one segment at the served shapes, "
              "a decode step without shared memory")
SELECT_VERSION = ("v2: a warp per lane (several lanes a warp where "
                  "K*L <= 16), the F grid in shared memory, accuracy and "
                  "energy in registers, shuffle reductions; outputs in "
                  "one int32 [4,S] and one float64 [3,S] buffer")
# float32 FMAs outside the tensor cores (NVIDIA H100 SXM data sheet), the
# type of rwkv_scan's arithmetic.
H100_FP32_FLOPS = 67e12
# nested_matmul vs its plain version: both accumulate in float32 in
# different orders.  bf16: one bf16 ulp (rtol 2^-7) plus 2^-15 * max|plain|
# for sums that cancel towards zero; float32 (TF32 off): rtol 1e-5 plus
# 1e-5 * max|plain|.
NM_TOL = {"bfloat16": (2.0 ** -7, 2.0 ** -15), "float32": (1e-5, 1e-5)}
# Attention kernels vs their plain versions, element by element:
# |kernel - plain| <= rtol * |plain| + vtol * A(|v|), where A(|v|) is the
# plain version run on |v| in float32 (sum_j p_j |v_j| / sum_j p_j, the
# output's own scale, small where a long cache averages v away).  Both
# round p to the input type, at different maxima (the kernel's running
# max, the plain version's row max), so in bf16 each weight may be off by
# one rounding (2^-8 relative) on each side, which moves the output by at
# most 2^-7 * A(|v|); the output's own rounding may then differ by one ulp
# (2^-7 relative).  float32 (TF32 off): other summation orders and exp
# implementations, 1e-5 of each.
ATT_TOL = {"bfloat16": (2.0 ** -7, 2.0 ** -7), "float32": (1e-5, 1e-5)}
# rwkv_scan against its plain version, element by element:
# |kernel - plain| <= rtol * |plain| + atol * A, A the plain version run on
# |r|, |k|, |v|, w, |u| and |s0| (the sum of the magnitudes of the terms
# each output adds up).  Both compute in float32 in other orders; against
# a float64 loop the plain version's error was at most 1.4e-7 A (y) and
# 4e-7 A (state) at S=256..2048, w = sigmoid(normal) and w near 1, so
# atol 1e-5 is 25x that.  bf16 inputs: y is rounded to bf16 (8
# significant bits) from float32 values that differ by d <= 1e-5 A, so
# |kernel - plain| <= 2^-8 (|y_kernel| + |y_plain|) + d, in terms of the
# rounded plain value at most 2^-7 / (1 - 2^-8) |plain| + (1 + 2^-8) d:
# one ulp where the two round apart (next to a power of two that is all
# of the rtol, so the ratio there reads about 0.99).  The state stays
# float32.
RS_TOL = {"bfloat16": (2.0 ** -7 / (1 - 2.0 ** -8), 1.01e-5),
          "float32": (1e-5, 1e-5)}
L2_BYTES = 50e6                    # H100 L2; timed inputs exceed it twice
# Mistral-7B-v0.3's projections (name, k_in, n), nested in 4 levels: the
# benchmark's scoring prefill runs them at WIDE_M rows (B=4 x 128 tokens).
MISTRAL_GEOMETRIES = (("d->q", 4096, 4096), ("d->kv", 4096, 1024),
                      ("d->d_ff", 4096, 14336), ("d_ff->d", 14336, 4096))
WIDE_M = 512
# Input and output stripe boundaries that are no multiple of 64 or of
# v4's 128-column tile, over input prefixes none of the 64-row step.
ODD_SPECS = ((0, 40, 100, 200, 328), (0, 24, 72, 176, 264))
# Rows at which nested_crossover times v3 against v4.
CROSS_MS = (32, 64, 96, 128, 192, 256, 384, 512)
LEVEL_ACCURACIES = [0.62, 0.71, 0.78, 0.83]
N_TICKS = 4
# Layers of the earlier serve phases 4 and 7, cut from 12 to keep the run
# short; phase 10 serves the model at its full depth.
SERVE_DEPTH = 4
# Layers of stablelm-12b that phase 17 serves (of 40, at full width), to
# keep the run short; qwen2.5-14b (phase 15) and gemma3-1b (phase 16) are
# served at full depth.
STABLELM_DEPTH = 8
# Tokens of rwkv_scan's long-context case (c), the length this family's
# O(1) state is for.
RWKV_LONG = 32768
# Capacity factor of phase 18's drop case: low enough that the reduced
# olmoe-1b-7b's prefill (24 tokens, 8 experts, top-2: capacity 2) drops
# assignments, so the drop path runs on the card.
MOE_DROP_FACTOR = 0.25
# Layers of jamba-v0.1-52b that phase 22 serves (of 32, at full width): two
# whole periods of 8, every layer kind twice (26.05e9 parameters, 52.1 GB
# in bf16); the whole model's 103.1 GB does not fit one 80 GB card.
JAMBA_DEPTH = 16


class SmokeFailure(RuntimeError):
    """A phase found a mismatch."""


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, launches: int, rounds: int = 5, warmup: int = 3) -> float:
    """Per-call time on the card: CUDA events around ``launches``
    back-to-back calls, divided by the count; the median of ``rounds``
    such runs.  Where a call's host work outlasts its device work the card
    waits between calls and this measures the host side.  The inputs stay
    in L2 (S=65536 lanes of 96 B are 6.3 MB)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def host_ms(fn, reps: int = 20) -> float:
    """Median host wall time of ``fn`` (which must end in a host copy)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def graph_ms(fn, calls: int = 48, rounds: int = 5) -> float:
    """Per-call device time: ``calls`` calls captured in one CUDA graph,
    replayed ``rounds`` times between CUDA events; the median over the
    count.  No host work between the calls, so this is the card's time
    for the work alone (what back-to-back eager calls cannot show when
    the host is slower than the card)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host time to issue one call, in microseconds: ``calls`` calls
    without a sync in between (the card keeps up, so nothing waits on
    it), then one sync outside the clock."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def graph_kernels(graph, cluster: bool = False) -> list[tuple]:
    """``(function name, grid)`` of each kernel node of a captured
    ``torch.cuda.CUDAGraph(keep_graph=True)``, read back through the
    driver API (``cuGraphGetNodes`` and each kernel node's parameters):
    what the graph really launches, not what its caller planned.  With
    ``cluster``, ``(name, grid, cluster dims)``: the node's thread-block
    cluster attribute, ``(0, 0, 0)`` when it was launched without one."""
    import ctypes

    class NodeParams(ctypes.Structure):     # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3),
                    ("shared_mem_bytes", ctypes.c_uint),
                    ("kernel_params", ctypes.c_void_p),
                    ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                    ("ctx", ctypes.c_void_p)]

    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc: int, what: str) -> None:
        if rc != 0:
            raise SmokeFailure(f"{what}: CUDA driver error {rc}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
          "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:                      # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        par = NodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               ctypes.byref(par)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if par.func:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(par.func)), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(par.kern)),
                  "cuKernelGetName")
        entry = (name.value.decode(), tuple(par.grid))
        if cluster:
            val = (ctypes.c_uint * 16)()     # CUlaunchAttributeValue
            check(cu.cuGraphKernelNodeGetAttribute(
                ctypes.c_void_p(node), 4, ctypes.byref(val)),
                "cuGraphKernelNodeGetAttribute(CLUSTER_DIMENSION)")
            entry += (tuple(val[:3]),)
        out.append(entry)
    return out


def captured_kernels(fn, cluster: bool = False) -> list[tuple]:
    """``(function name, grid)`` of each kernel that one ``fn()`` call
    launches, read from a CUDA graph of that call (:func:`graph_kernels`;
    with ``cluster``, the cluster dims too)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    out = graph_kernels(graph, cluster)
    del graph
    return out


# --------------------------------------------------------------------- #
# phase 3: kernel vs plain                                               #
# --------------------------------------------------------------------- #
def fleet_inputs(table, s: int, seed: int, device):
    """Seeded mixed-goal lane state as the engine hands it to the kernel:
    ``[S]`` f64 vectors (sigma floored), int32 goal codes and lane mask,
    10% dead lanes holding NaN/inf/huge garbage."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    med_lat = float(np.median(table.latency))
    med_en = float(np.median(table.run_power)) * med_lat
    vals = [rng.uniform(0.5, 3.0, s), rng.uniform(0.01, 0.5, s),
            rng.uniform(0.05, 0.8, s), rng.uniform(0.1, 3.0, s) * med_lat,
            rng.uniform(0.2, 1.1, s), rng.uniform(0.0, 2.5, s) * med_en]
    goal_kind = rng.integers(0, 2, s)
    active = rng.random(s) >= 0.1
    garbage = rng.choice([np.nan, np.inf, -np.inf, 1e300], size=s)
    for v in vals:
        v[~active] = garbage[~active]
    f64 = [torch.as_tensor(v, dtype=torch.float64, device=device)
           for v in vals]
    f64[1] = torch.clamp_min(f64[1], 1e-6)
    ints = [torch.as_tensor(x.astype(np.int32), device=device)
            for x in (goal_kind, active)]
    return f64 + ints


SELECT_NAMES = ("model_index", "power_index", "predicted_latency",
                "predicted_accuracy", "predicted_energy", "feasible",
                "relaxed_code")
# (n_single, n_levels, n_power) of the tables phase 3 holds the kernel to:
# K x L = 1x1, 4x4 (the served table), 5x7, 12x8 and 32x4 (the limits).
SELECT_TABLES = ((1, 0, 1), (0, 4, 4), (3, 2, 7), (8, 4, 8), (28, 4, 4))


def compare(got, want, what: str) -> float:
    """Every output of the kernel bitwise equal to the plain version's
    (dtype, shape and bits; NaN equal to NaN); returns 0.0, the largest
    absolute prediction difference."""
    import torch

    for name, g, w in zip(SELECT_NAMES, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise SmokeFailure(f"{what}: {name} is {g.dtype} "
                               f"{tuple(g.shape)}, the plain version's "
                               f"{w.dtype} {tuple(w.shape)}")
        if g.dtype == torch.float64:
            same = (g.view(torch.int64) == w.view(torch.int64)) | (
                torch.isnan(g) & torch.isnan(w))
        else:
            same = g == w
        if not bool(same.all()):
            bad = torch.nonzero(~same).flatten()[:8].tolist()
            raise SmokeFailure(f"{what}: {name} differs on "
                               f"{int((~same).sum())} lanes (first {bad})")
    return 0.0


def kernel_vs_plain(device, sizes=(1, 4097, 65536), time_s=65536,
                    counts=None):
    """Phase 3; returns (max_abs_err, timing dict at ``time_s``, with the
    second bound from ``counts``)."""
    import torch

    from repro_torch.core.batched import BatchedAlertEngine
    from repro_torch.core.profiles import synthetic_table
    from repro_torch.kernels import alert_select as ks

    table = synthetic_table(0)
    k, l = table.latency.shape
    overhead = 0.05 * float(table.latency.min())
    eng = BatchedAlertEngine(table, None, overhead=overhead, device=device)
    consts = dict(latency=eng._latency, run_power=eng._run_power,
                  weights=eng._weights, q_fail=eng._q_fail,
                  overhead=overhead)
    err = 0.0
    timing = {}
    for s in sizes:
        args = fleet_inputs(table, s, seed=s, device=device)
        for paper in (True, False):
            for pred in (True, False):
                kw = dict(consts, paper_faithful_energy=paper,
                          predictions=pred)
                got = ks.alert_select(*args, **kw)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                want = ks.alert_select_plain(*args, **kw)
                what = f"S={s} paper_faithful={paper} predictions={pred}"
                err = max(err, compare(got, want, what))
                say(f"  ok {what}: bitwise")
        if s == time_s:
            kw = dict(consts, paper_faithful_energy=True, predictions=True)
            timing = time_select(ks, args, kw, s, k, l, device, counts)
    return err, timing


def edge_tables(eng):
    """Variants of an engine's tables that force the argmin's edge cases:
    ``ties``, power columns 0 and 1 equal (equal scores in one row, the
    lower cell must win); ``zeros``, weights of mixed sign and q_fail =
    -0.0, so a lane whose every Eq. 7 CDF is 0 scores +0.0 and -0.0
    (equal); ``nan``, one latency cell NaN (some scores NaN: the pick is
    K*L)."""
    import numpy as np
    import torch

    k, l = eng._latency.shape
    base = dict(latency=eng._latency, run_power=eng._run_power,
                weights=eng._weights, q_fail=eng._q_fail,
                overhead=eng.overhead)
    out = {}
    if l > 1:
        lat, pw = eng._latency.clone(), eng._run_power.clone()
        lat[:, 1], pw[:, 1] = lat[:, 0], pw[:, 0]
        out["ties"] = dict(base, latency=lat, run_power=pw)
    sign = np.where(np.random.default_rng(k * l).random((k, k)) < 0.5, -1.0,
                    1.0)
    sign[0] = -1.0                       # one row whose sum is -0.0
    out["zeros"] = dict(base, weights=eng._weights.abs() * torch.as_tensor(
        sign, device=eng._weights.device) + 0.01 * torch.as_tensor(
        sign, device=eng._weights.device), q_fail=-0.0)
    lat = eng._latency.clone()
    lat[k // 2, l // 2] = float("nan")
    out["nan"] = dict(base, latency=lat)
    return out


def edge_lanes(table, s: int, seed: int, device):
    """``fleet_inputs`` lanes (mixed goals, 10% dead lanes holding
    garbage) with every fifth live lane's deadline at 1e-9 s and sigma at
    0.01 (every Eq. 7 CDF is 0, so Eq. 4 lanes relax on accuracy) and
    every seventh live lane's mu NaN."""
    import torch

    args = fleet_inputs(table, s, seed, device)
    idx = torch.arange(s, device=device)
    live = args[7] != 0
    late = live & (idx % 5 == 1)
    args[3] = torch.where(late, 1e-9, args[3])
    args[1] = torch.where(late, 0.01, args[1])
    args[0] = torch.where(live & (idx % 7 == 3), float("nan"), args[0])
    return args


def select_cases(device, sizes=(1, 7, 257, 4097),
                 tables=SELECT_TABLES) -> int:
    """Phase 3, beyond the 12 x 8 sizes of :func:`kernel_vs_plain`: every
    table of ``tables`` at every S of ``sizes`` (none a multiple of
    the lanes a block takes, but 1), both energy modes, predictions on and
    off, with :func:`edge_lanes`, on the engine's tables and on each of
    :func:`edge_tables`; the kernel bitwise equal to the plain version.
    Returns the number of cases."""
    import torch

    from repro_torch.core.batched import BatchedAlertEngine
    from repro_torch.core.profiles import synthetic_table
    from repro_torch.kernels import alert_select as ks

    n = 0
    for single, levels, power in tables:
        i = SELECT_TABLES.index((single, levels, power))
        table = synthetic_table(i, n_single=single, n_levels=levels,
                                n_power=power)
        k, l = table.latency.shape
        eng = BatchedAlertEngine(table, None,
                                 overhead=0.05 * float(table.latency.min()),
                                 device=device)
        variants = {"engine": dict(
            latency=eng._latency, run_power=eng._run_power,
            weights=eng._weights, q_fail=eng._q_fail,
            overhead=eng.overhead)}
        variants.update(edge_tables(eng))
        for s in sizes:
            args = edge_lanes(table, s, seed=1000 * i + s, device=device)
            for name, consts in variants.items():
                for paper in (True, False):
                    for pred in (True, False):
                        kw = dict(consts, paper_faithful_energy=paper,
                                  predictions=pred)
                        got = ks.alert_select(*args, **kw)
                        if device.type == "cuda":
                            torch.cuda.synchronize(device)
                        compare(got, ks.alert_select_plain(*args, **kw),
                                f"K={k} L={l} S={s} {name} "
                                f"paper_faithful={paper} predictions={pred}")
                        n += 1
        say(f"  ok K={k} L={l}: S in {list(sizes)}, tables "
            f"{list(variants)}, both energy modes, predictions on and off: "
            f"bitwise")
    return n


# One call of each FP64 function alert_select runs per cell, compiled
# alone so its instructions can be counted in the SASS: the kernel's own
# alert_erf and alert_exp (appended to its source, which the probe file
# includes) and a division.
FP64_PROBES = r"""
extern "C" __global__ void probe_erf(const double* x, double* y) {
  y[threadIdx.x] = alert_erf(x[threadIdx.x]);
}
extern "C" __global__ void probe_exp(const double* x, double* y) {
  y[threadIdx.x] = alert_exp(x[threadIdx.x]);
}
extern "C" __global__ void probe_div(const double* x, double* y) {
  y[threadIdx.x] = __ddiv_rn(x[threadIdx.x], x[threadIdx.x + 32]);
}
"""
# SASS opcodes that run on the FP64 pipe (MUFU.RCP64H and MUFU.RSQ64H
# seed a division or a root on the MUFU unit, not on this pipe).
FP64_OPCODES = ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX")
# H100 SXM FP64 instructions per second: 34 TFLOP/s counts a DFMA as 2.
H100_FP64_INSTR_S = H100_FP64_FLOPS / 2


def sass_fp64_paths(body: str) -> tuple[int, int]:
    """(fewest, most) FP64 instructions on a path from the first
    instruction of one function's SASS (``cuobjdump -sass``) to an
    ``EXIT``.  A branch (``BRA``, predicated or not) leads to its target
    and, when predicated, to the next instruction; a ``CALL`` (a
    division's out-of-line slow path) is passed over; a predicated
    instruction other than a branch counts, since it still takes its
    slot.  One evaluation runs one path, so the fewest is what any input
    needs at least."""
    import functools
    import re

    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z0-9.]+)([^;]*);", body)
    if not ins:
        raise SmokeFailure("no instructions in the SASS")
    at = {int(addr, 16): i for i, (addr, *_rest) in enumerate(ins)}

    def successors(i: int) -> list[int]:
        _, pred, op, rest = ins[i]
        nxt = [i + 1] if i + 1 < len(ins) else []
        if op == "EXIT":
            return [-1] + (nxt if pred else [])
        if op.startswith(("BRA", "JMP")):
            target = re.search(r"0x([0-9a-f]+)", rest)
            if target is None or int(target.group(1), 16) not in at:
                raise SmokeFailure(f"SASS branch without a target: "
                                   f"{op}{rest}")
            return [at[int(target.group(1), 16)]] + (nxt if pred else [])
        if op.startswith(("RET", "BRX", "JMX")):
            raise SmokeFailure(f"SASS path reaches {op}{rest}")
        return nxt

    on_path: set[int] = set()

    @functools.lru_cache(maxsize=None)
    def walk(i: int) -> tuple[int, int]:
        if i == -1:
            return 0, 0
        if i in on_path:
            raise SmokeFailure("a loop in the SASS of one call")
        on_path.add(i)
        ends = [walk(j) for j in successors(i)]
        on_path.discard(i)
        if not ends:
            raise SmokeFailure("a SASS path that ends without EXIT")
        own = int(ins[i][2].startswith(FP64_OPCODES))
        return (own + min(e[0] for e in ends),
                own + max(e[1] for e in ends))

    return walk(0)


def fp64_instruction_counts() -> dict:
    """FP64 instructions of ``alert_erf``, ``alert_exp`` (the kernel's,
    from ``csrc/alert_select.cu``) and ``__ddiv_rn`` on sm_90a, read from
    the SASS of one call of each (``nvcc -cubin``,
    ``cuobjdump -sass``): for each, the fewest and the most on a path of
    the inline code to ``EXIT`` (:func:`sass_fp64_paths`; the
    out-of-line slow path of the division does not count)."""
    import re
    import tempfile

    from repro_torch.kernels.build import nvcc_path

    nvcc = Path(nvcc_path())
    with tempfile.TemporaryDirectory(dir=SRC / "repro_torch" / "kernels"
                                     / "_build") as tmp:
        src, cubin = Path(tmp) / "probe.cu", Path(tmp) / "probe.cubin"
        src.write_text(f'#include "{KERNEL_CU}"\n' + FP64_PROBES)
        subprocess.run([str(nvcc), "-cubin", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-o",
                        str(cubin), str(src)], check=True,
                       capture_output=True, timeout=300)
        sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                               str(cubin)], check=True, capture_output=True,
                              text=True, timeout=300).stdout
    counts = {}
    for name, body in re.findall(
            r"Function : probe_(\w+)(.*?)(?=Function :|$)", sass, re.S):
        fewest, most = sass_fp64_paths(body)
        counts[name] = {"fewest": fewest, "most": most}
    if sorted(counts) != ["div", "erf", "exp"]:
        raise SmokeFailure(f"probes found in the SASS: {sorted(counts)}")
    return counts


def select_instructions(k: int, counts: dict, paper_faithful=True,
                        path: str = "fewest") -> int:
    """FP64 instructions of one ``[K, L]`` cell in ``alert_select.cu``:
    Eq. 7 (2 multiplies, a max, a subtraction, 2 divisions, ``erf``, an add
    and a multiply), the Eq. 10 sum (``2 K``), Eq. 9 energy (8, or 15 and
    ``exp`` with E[min(t, T)]), feasibility and score (4); ``erf``, ``exp``
    and a division at their ``path`` count (:func:`sass_fp64_paths`)."""
    div, erf, exp = (counts[f][path] for f in ("div", "erf", "exp"))
    eq7 = 6 + 2 * div + erf
    energy = 8 if paper_faithful else 15 + div + exp
    return eq7 + 2 * k + energy + 4


def time_select(ks, args, kw, s, k, l, device, counts=None) -> dict:
    """Kernel and plain-version medians (CUDA events) and the bound; with
    ``counts`` (:func:`fp64_instruction_counts`) a second bound that
    counts every FP64 instruction of a cell, ``erf`` and the divisions on
    their cheapest path through the SASS, at the FP64 instruction rate
    (and, beside it, the same at their dearest path)."""
    if device.type != "cuda":
        return {}
    ms = cuda_ms(lambda: ks.alert_select(*args, **kw), launches=100)
    plain_ms = cuda_ms(lambda: ks.alert_select_plain(*args, **kw),
                       launches=10, rounds=3)
    cost = ks.alert_select_cost(s, k, l, predictions=kw["predictions"])
    t_ops = cost["flops"] / H100_FP64_FLOPS * 1e3
    t_bytes = cost["bytes_accessed"] / H100_HBM_BYTES_S * 1e3
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=cost["flops"], bytes=cost["bytes_accessed"],
               erf=cost["transcendentals"], shape=f"S={s},K={k},L={l}")
    say(f"  time S={s} K={k} L={l}: kernel {ms:.6f} ms, plain "
        f"{plain_ms:.6f} ms, bound {out['bound_ms']:.6f} ms by "
        f"{out['bound_by']} ({cost['flops']:.4g} FP64 ops at 34 TFLOP/s = "
        f"{t_ops:.6f} ms; {cost['bytes_accessed']:.4g} B at 3.35 TB/s = "
        f"{t_bytes:.6f} ms; the {cost['transcendentals']:.4g} erf calls "
        f"are counted as 0 FP64 ops, so the bound is low)")
    if counts:
        per_cell, most = (select_instructions(
            k, counts, kw["paper_faithful_energy"], path)
            for path in ("fewest", "most"))
        out.update(fp64_instructions_per_cell=per_cell,
                   fp64_instructions_per_cell_most=most,
                   fp64_sass_counts=counts,
                   instruction_bound_ms=s * k * l * per_cell
                   / H100_FP64_INSTR_S * 1e3)
        say(f"  second bound, every FP64 instruction on the cheapest "
            f"path: {per_cell} a cell (erf {counts['erf']['fewest']}, a "
            f"division {counts['div']['fewest']}, from the SASS) x "
            f"{s * k * l} cells at 17e12 FP64 instructions/s = "
            f"{out['instruction_bound_ms']:.6f} ms; the kernel is "
            f"{out['instruction_bound_ms'] / ms:.3f} of it (on the dearest "
            f"path, {most} a cell: "
            f"{s * k * l * most / H100_FP64_INSTR_S * 1e3:.6f} ms)")
    return out


# --------------------------------------------------------------------- #
# phase 5: nested_matmul kernel vs plain                                 #
# --------------------------------------------------------------------- #
def projection_geometries(cfg):
    """The three nested projection shapes of ``cfg``: (name, in spec, out
    spec) for d->d (wq/wk/wv/wo), d->d_ff (w_gate/w_up), d_ff->d
    (w_down)."""
    from repro_torch.core.nesting import StripeSpec

    d = StripeSpec.pow2(cfg.d_model, cfg.nest_levels)
    f = StripeSpec.pow2(cfg.d_ff, cfg.nest_levels)
    return [("d->d", d, d), ("d->d_ff", d, f), ("d_ff->d", f, d)]


def nested_close(got, want, dtype_name: str) -> tuple[float, float]:
    """(max abs error, worst error / tolerance) of the kernel's output
    against the plain version's under ``NM_TOL``; raises past 1."""
    import torch

    rtol, atol_frac = NM_TOL[dtype_name]
    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise SmokeFailure(f"nested_matmul {dtype_name}: shape {g.shape} "
                           f"vs {w.shape} or non-finite output")
    diff = (g - w).abs()
    tol = rtol * w.abs() + atol_frac * float(w.abs().max())
    return float(diff.max()), float((diff / tol).max())


def nested_vs_plain(device, cfg) -> float:
    """Phase 5 check: the kernel against its plain version on the card at
    ``cfg``'s three projection geometries, every level, M in {4, 32}
    (decode and prefill of batch 4, prompt 8), bf16 and float32, with a
    level-prefix view of a full-width ``x`` and the full ``w``.  Returns
    the largest absolute error."""
    import torch

    from repro_torch.kernels import nested_matmul as nm

    ms = (4, 32)
    gen = torch.Generator(device=device).manual_seed(0)
    worst = 0.0
    for name, si, so in projection_geometries(cfg):
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            w = (torch.randn(si.total, so.total, generator=gen, device=device)
                 * si.total ** -0.5).to(dtype)
            err, ratio = 0.0, 0.0
            for m in ms:
                x = torch.randn(m, si.total, generator=gen,
                                device=device).to(dtype)
                for level in range(1, so.levels + 1):
                    xk = x[:, :si.width(min(level, si.levels))]
                    got = nm.nested_matmul(xk, w, si, so, level)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    want = nm.nested_matmul_plain(xk, w, si, so, level)
                    e, r = nested_close(got, want, dt)
                    if r > 1.0:
                        raise SmokeFailure(
                            f"nested_matmul {name} {dt} M={m} level "
                            f"{level}: max abs err {e:.3e}, {r:.3f}x the "
                            f"tolerance")
                    err, ratio = max(err, e), max(ratio, r)
            worst = max(worst, err)
            say(f"  ok {name} {si.total}x{so.total} {dt}, levels "
                f"1-{so.levels}, M in {list(ms)}: max abs err {err:.3e} "
                f"({ratio:.3f} of the tolerance)")
    return worst


def time_nested(device, cfg, m: int) -> dict:
    """Phase 5 timing of the d->d_ff geometry at the deepest level in
    bf16 with ``m`` rows: the kernel, its plain version, the blocks
    backend and one dense matmul on the block-masked weight (the library
    call), each as graph-replayed device time over 12 weights in turn
    (57 MB, more than the 50 MB L2 holds, as in a forward); the kernel
    and the blocks backend also back to back with host work between
    calls, and their host cost per call."""
    import torch

    from repro_torch.core.nesting import (block_triangular_mask,
                                          nested_linear_blocks)
    from repro_torch.kernels import nested_matmul as nm

    _, si, so = projection_geometries(cfg)[1]
    level = so.levels
    n_weights = 12
    gen = torch.Generator(device=device).manual_seed(1)
    ws = [(torch.randn(si.total, so.total, generator=gen, device=device)
           * si.total ** -0.5).to(torch.bfloat16) for _ in range(n_weights)]
    mask = torch.as_tensor(block_triangular_mask(si, so), device=device,
                           dtype=torch.bfloat16)
    masked = [w * mask for w in ws]
    x = torch.randn(m, si.total, generator=gen,
                    device=device).to(torch.bfloat16)
    n_cols = so.width(level)

    def cycling(call):
        state = {"i": 0}

        def fn():
            i = state["i"] = (state["i"] + 1) % n_weights
            return call(i)
        return fn

    kern = cycling(lambda i: nm.nested_matmul(x, ws[i], si, so, level))
    plain = cycling(lambda i: nm.nested_matmul_plain(x, ws[i], si, so,
                                                     level))
    blocks = cycling(lambda i: nested_linear_blocks(x, ws[i], si, so, level))
    library = cycling(lambda i: torch.matmul(x, masked[i][:, :n_cols]))
    out = {
        "ms": graph_ms(kern), "plain_ms": graph_ms(plain),
        "blocks_ms": graph_ms(blocks), "library_ms": graph_ms(library),
        "eager_ms": cuda_ms(kern, launches=200),
        "blocks_eager_ms": cuda_ms(blocks, launches=200),
        "host_us_per_call": host_us_per_call(kern),
        "blocks_host_us_per_call": host_us_per_call(blocks)}
    cost = nm.nested_matmul_cost(m, si, so, level, torch.bfloat16)
    t_ops = cost["flops"] / H100_BF16_FLOPS * 1e3
    t_bytes = cost["bytes_accessed"] / H100_HBM_BYTES_S * 1e3
    out.update(bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=cost["flops"], bytes=cost["bytes_accessed"],
               shape=f"M={m},K_in={si.total},N={so.total},level={level},"
                     f"bf16")
    say(f"  time d->d_ff M={m} level {level} bf16 (device time, CUDA "
        f"graph): kernel {out['ms']:.6f} ms, plain {out['plain_ms']:.6f} "
        f"ms, blocks {out['blocks_ms']:.6f} ms, library (dense matmul on "
        f"the masked weight) {out['library_ms']:.6f} ms; bound "
        f"{out['bound_ms']:.6f} ms by {out['bound_by']} "
        f"({cost['flops']:.4g} flop at 989 TFLOP/s = {t_ops:.6f} ms, "
        f"{cost['bytes_accessed']:.4g} B at 3.35 TB/s = {t_bytes:.6f} ms)")
    say(f"    back to back (host work between calls): kernel "
        f"{out['eager_ms']:.6f} ms, blocks {out['blocks_eager_ms']:.6f} ms; "
        f"host cost per call: kernel wrapper "
        f"{out['host_us_per_call']:.2f} us, blocks backend "
        f"{out['blocks_host_us_per_call']:.2f} us")
    return out


def nested_launched(call, what: str, want_splits: int | None = None,
                    want_plan=None) -> dict:
    """The kernel one ``nested_matmul`` call launched, read from a CUDA
    graph of the call: its grid and cluster.  Without ``want_plan``,
    raises unless it is one v3 launch whose cluster spans its splits
    (grid: splits, column tiles, row tiles), and, given ``want_splits``,
    has that many; with ``want_plan`` (a v4 ``WidePlan``), unless it is
    one v4 launch of the plan's blocks in clusters of the plan's size."""
    launched = captured_kernels(call, cluster=True)
    kind = "nested_matmul_v3" if want_plan is None else "nested_matmul_v4"
    if len(launched) != 1 or kind not in launched[0][0]:
        raise SmokeFailure(f"nested_matmul {what} launched {launched}, not "
                           f"one {kind[-2:]} kernel")
    _, grid, clus = launched[0]
    if want_plan is not None:
        want = want_plan.cluster
        if grid != (want_plan.blocks, 1, 1) or clus != (want, 1, 1):
            raise SmokeFailure(f"nested_matmul {what} launched grid {grid} "
                               f"in clusters of {clus}, the v4 plan "
                               f"{want_plan.blocks} blocks in clusters of "
                               f"{want_plan.cluster}")
        return {"blocks": grid[0], "grid": grid, "cluster": want}
    if clus != (grid[0], 1, 1) or (want_splits is not None
                                   and grid[0] != want_splits):
        raise SmokeFailure(f"nested_matmul {what} launched grid {grid} in "
                           f"clusters of {clus}, not {want_splits} splits "
                           f"in one cluster per tile")
    return {"splits": grid[0], "blocks": math.prod(grid), "grid": grid,
            "cluster": clus[0]}


def time_nested_levels(device, cfg) -> list[dict]:
    """Phase 5 table: the kernel at each projection geometry of ``cfg``,
    level and M in {4, 32}, in bf16, as device time (a CUDA graph of calls
    over weights rotated beyond twice the L2), beside the library call on
    the same inputs (a dense matmul of the level-prefix ``x`` on the
    block-masked weight's live rows and columns), the bound and the share
    of it reached."""
    import torch

    from repro_torch.core.nesting import block_triangular_mask
    from repro_torch.kernels import nested_matmul as nm

    gen = torch.Generator(device=device).manual_seed(5)
    rows = []
    for name, si, so in projection_geometries(cfg):
        n_w = math.ceil(2 * L2_BYTES / (2 * si.total * so.total))
        ws = [(torch.randn(si.total, so.total, generator=gen, device=device)
               * si.total ** -0.5).to(torch.bfloat16) for _ in range(n_w)]
        mask = torch.as_tensor(block_triangular_mask(si, so), device=device,
                               dtype=torch.bfloat16)
        masked = [w * mask for w in ws]
        for m in (4, 32):
            x = torch.randn(m, si.total, generator=gen,
                            device=device).to(torch.bfloat16)
            for level in range(1, so.levels + 1):
                k_need = si.width(min(level, si.levels))
                n_cols = so.width(level)
                xk = x[:, :k_need]
                sets = list(zip(ws, masked))
                ms = graph_ms(rotating(lambda w, mw: nm.nested_matmul(
                    xk, w, si, so, level), sets))
                lib = graph_ms(rotating(lambda w, mw: torch.matmul(
                    xk, mw[:k_need, :n_cols]), sets))
                cost = nm.nested_matmul_cost(m, si, so, level, torch.bfloat16)
                b_ms, b_by = bound(cost)
                plan = nm.nested_split_plan(m, n_cols, k_need,
                                            nm.sm_count(device))
                got = nested_launched(
                    lambda: nm.nested_matmul(xk, ws[0], si, so, level),
                    f"{name} level {level} M={m}", plan[0])
                if got["grid"] != (plan[0], plan[2], plan[1]):
                    raise SmokeFailure(f"nested_matmul {name} level {level} "
                                       f"M={m} launched grid {got['grid']}, "
                                       f"the plan is {plan}")
                row = {"geometry": name, "level": level, "m": m, "ms": ms,
                       "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                       "bound_share": b_ms / ms, "bytes": cost[
                           "bytes_accessed"],
                       "blocks": got["blocks"], "splits": got["splits"]}
                rows.append(row)
                say(f"  time {name} level {level} M={m} bf16 (device time, "
                    f"CUDA graph, {n_w} weights in turn): kernel {ms:.6f} ms "
                    f"(launched: grid {got['grid']}, clusters of "
                    f"{got['cluster']}), library "
                    f"{lib:.6f} ms; bound {b_ms:.6f} ms by {b_by} "
                    f"({cost['bytes_accessed']:.4g} B), "
                    f"{row['bound_share']:.3f} of it")
        del ws, masked
    return rows


def mistral_geometries():
    """Mistral-7B-v0.3's four projection geometries (hidden 4096, 8 KV
    heads of 128, intermediate 14336) in 4 power-of-2 levels, as (name,
    in spec, out spec): the benchmark's scoring prefill runs them at
    ``WIDE_M`` rows."""
    from repro_torch.core.nesting import StripeSpec

    return [(name, StripeSpec.pow2(k_in, 4), StripeSpec.pow2(n, 4))
            for name, k_in, n in MISTRAL_GEOMETRIES]


def wide_vs_plain(xk, w, si, so, level, what: str) -> tuple[float, float]:
    """One v4 call against its plain version (``nested_close`` in bf16):
    (max abs error, worst error / tolerance); raises unless the call took
    v4, once, and is within the tolerance."""
    import torch

    from repro_torch.kernels import nested_matmul as nm

    before = nm.nested_matmul.v4_launches
    got = nm.nested_matmul(xk, w, si, so, level)
    torch.cuda.synchronize(xk.device)
    if nm.nested_matmul.v4_launches != before + 1:
        raise SmokeFailure(f"nested_matmul {what} did not take v4 once")
    e, r = nested_close(got, nm.nested_matmul_plain(xk, w, si, so, level),
                        "bfloat16")
    if r > 1.0:
        raise SmokeFailure(f"nested_matmul v4 {what}: max abs err {e:.3e}, "
                           f"{r:.3f}x the tolerance")
    return e, r


def nested_wide_odd(device) -> float:
    """Phase 5 check of v4 beyond the timed shapes: ``WIDE_M`` + 8 rows
    (a partial row tile) at Mistral-7B's four geometries, and stripes
    that are no multiple of 64 or of the 128-column tile (``ODD_SPECS``)
    at M in {128, 520}, every level, a level-prefix view of a full-width
    ``x`` and the full ``w``, against the plain version.  Returns the
    largest absolute error."""
    import torch

    from repro_torch.core.nesting import StripeSpec

    gen = torch.Generator(device=device).manual_seed(10)
    odd = tuple(StripeSpec(b) for b in ODD_SPECS)
    cases = [(n, si, so, (WIDE_M + 8,)) for n, si, so in mistral_geometries()]
    cases.append(("odd", *odd, (128, WIDE_M + 8)))
    worst = 0.0
    for name, si, so, ms in cases:
        w = (torch.randn(si.total, so.total, generator=gen, device=device)
             * si.total ** -0.5).to(torch.bfloat16)
        err, ratio = 0.0, 0.0
        for m in ms:
            x = torch.randn(m, si.total, generator=gen,
                            device=device).to(torch.bfloat16)
            for level in range(1, so.levels + 1):
                e, r = wide_vs_plain(x[:, :si.width(min(level, si.levels))],
                                     w, si, so, level,
                                     f"{name} level {level} M={m}")
                err, ratio = max(err, e), max(ratio, r)
        worst = max(worst, err)
        say(f"  ok v4 {name} {si.total}x{so.total} bf16, levels "
            f"1-{so.levels}, M in {list(ms)}: max abs err {err:.3e} "
            f"({ratio:.3f} of the tolerance)")
    return worst


def time_nested_wide(device) -> list[dict]:
    """Phase 5 table at the scoring prefill's shapes: ``WIDE_M`` rows at
    Mistral-7B's four geometries and every level, in bf16: the kernel
    (v4), its plain version and the library call (a dense matmul of the
    level-prefix ``x`` on the block-masked weight's live rows and
    columns, a yardstick only) as device time (CUDA graph, weights
    rotated beyond twice the L2) beside the bound and its share; each
    call checked against the plain version (``wide_vs_plain``: it took
    v4 once, within the tolerance) and its launch read back from a CUDA
    graph of it (one v4 kernel, the plan's grid and cluster)."""
    import torch

    from repro_torch.core.nesting import block_triangular_mask
    from repro_torch.kernels import nested_matmul as nm

    gen = torch.Generator(device=device).manual_seed(8)
    rows = []
    for name, si, so in mistral_geometries():
        n_w = math.ceil(2 * L2_BYTES / (2 * si.total * so.total))
        ws = [(torch.randn(si.total, so.total, generator=gen, device=device)
               * si.total ** -0.5).to(torch.bfloat16) for _ in range(n_w)]
        mask = torch.as_tensor(block_triangular_mask(si, so), device=device,
                               dtype=torch.bfloat16)
        sets = [(w, w * mask) for w in ws]
        x = torch.randn(WIDE_M, si.total, generator=gen,
                        device=device).to(torch.bfloat16)
        for level in range(1, so.levels + 1):
            k_need = si.width(min(level, si.levels))
            n_cols = so.width(level)
            xk = x[:, :k_need]
            err, ratio = wide_vs_plain(xk, ws[0], si, so, level,
                                       f"{name} level {level} M={WIDE_M}")
            ms = graph_ms(rotating(lambda w, mw: nm.nested_matmul(
                xk, w, si, so, level), sets))
            lib = graph_ms(rotating(lambda w, mw: torch.matmul(
                xk, mw[:k_need, :n_cols]), sets))
            plain = graph_ms(rotating(lambda w, mw: nm.nested_matmul_plain(
                xk, w, si, so, level), sets), calls=8)
            cost = nm.nested_matmul_cost(WIDE_M, si, so, level,
                                         torch.bfloat16)
            b_ms, b_by = bound(cost)
            plan = nm.nested_wide_plan(
                WIDE_M, nm.wide_tile_limits(tuple(si.boundaries),
                                            tuple(so.boundaries), level),
                nm.sm_count(device))
            got = nested_launched(
                lambda: nm.nested_matmul(xk, ws[0], si, so, level),
                f"{name} level {level} M={WIDE_M}", want_plan=plan)
            row = {"geometry": name, "level": level, "m": WIDE_M, "ms": ms,
                   "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                   "bound_by": b_by, "bound_share": b_ms / ms,
                   "tflops": cost["flops"] / ms / 1e9,
                   "blocks": got["blocks"], "cluster": got["cluster"],
                   "plan_steps": plan.makespan, "max_abs_err": err,
                   "tol_ratio": ratio}
            rows.append(row)
            say(f"  time {name} level {level} M={WIDE_M} bf16 (device time, "
                f"CUDA graph, {n_w} weights in turn): kernel {ms:.6f} ms "
                f"(v4: {got['blocks']} blocks in clusters of "
                f"{got['cluster']}), plain {plain:.6f} ms, library "
                f"{lib:.6f} ms; bound {b_ms:.6f} ms by {b_by}, "
                f"{row['bound_share']:.3f} of it "
                f"({row['tflops']:.1f} TFLOP/s); max abs err against plain "
                f"{err:.3e} ({ratio:.3f} of the tolerance)")
        del ws, sets
    return rows


def nested_crossover(device, ms=CROSS_MS) -> dict:
    """Phase 5: where v4 overtakes v3.  At the anytime LM's three
    geometries and Mistral-7B's four, every level, bf16, M in ``ms``:
    the call with its path forced to v3 and to v4 in turn
    (``nested_path`` replaced), as device time (CUDA graph, weights
    rotated beyond L2).  Returns ``{"sums": {M: {"v3": ms, "v4": ms}},
    "calls": [...]}``: each path's time summed over the geometries and
    levels, and each call's (geometry, level, M, n_cols, k_end, v3, v4,
    the path ``nested_path`` picks), from which ``WIDE_MIN_M`` is set."""
    import torch

    from repro_torch.configs.alert_anytime import CONFIG
    from repro_torch.kernels import nested_matmul as nm

    gen = torch.Generator(device=device).manual_seed(9)
    geos = [(f"anytime {n}", si, so)
            for n, si, so in projection_geometries(CONFIG)]
    geos += [(f"mistral {n}", si, so) for n, si, so in mistral_geometries()]
    chosen = nm.nested_path
    sums = {m: {"v3": 0.0, "v4": 0.0} for m in ms}
    calls = []
    try:
        for name, si, so in geos:
            n_w = math.ceil(2 * L2_BYTES / (2 * si.total * so.total))
            sets = [((torch.randn(si.total, so.total, generator=gen,
                                  device=device) * si.total ** -0.5)
                     .to(torch.bfloat16),) for _ in range(n_w)]
            for m in ms:
                x = torch.randn(m, si.total, generator=gen,
                                device=device).to(torch.bfloat16)
                for level in range(1, so.levels + 1):
                    k_end = si.width(min(level, si.levels))
                    xk = x[:, :k_end]
                    row = {"geometry": name, "level": level, "m": m,
                           "n_cols": so.width(level), "k_end": k_end,
                           "picked": chosen(xk, sets[0][0])}
                    for path in ("v3", "v4"):
                        nm.nested_path = lambda *a, p=path: p
                        row[path] = graph_ms(rotating(
                            lambda w: nm.nested_matmul(xk, w, si, so,
                                                       level), sets),
                            calls=16)
                        sums[m][path] += row[path]
                    calls.append(row)
                mine = calls[-so.levels:]
                say(f"  crossover {name} M={m}, levels 1-{so.levels} "
                    f"(device time, CUDA graph, ms): v3 "
                    f"{[round(r['v3'], 6) for r in mine]}, v4 "
                    f"{[round(r['v4'], 6) for r in mine]}")
            del sets
    finally:
        nm.nested_path = chosen
    for m in ms:
        say(f"  crossover M={m}, all geometries and levels: v3 "
            f"{sums[m]['v3']:.6f} ms, v4 {sums[m]['v4']:.6f} ms")
    picked = sum(r[r["picked"]] for r in calls)
    best = sum(min(r["v3"], r["v4"]) for r in calls)
    say(f"  crossover, every call at the path nested_path picks: "
        f"{picked:.6f} ms, at the faster of the two: {best:.6f} ms")
    return {"sums": sums, "calls": calls}


def nested_split_sweep(device, cfg, m: int = 32) -> dict:
    """Phase 5: the kernel at each geometry's deepest level with the split
    count forced to 1, 2, 4, 8 and 16 (as far as the k range has steps)
    beside the plan's own, as device time (CUDA graph, weights rotated
    beyond L2): how near the plan, made from the shapes alone, comes to
    the best split."""
    import torch

    from repro_torch.kernels import nested_matmul as nm

    gen = torch.Generator(device=device).manual_seed(6)
    planned = nm.nested_split_plan
    out = {}
    try:
        for name, si, so in projection_geometries(cfg):
            level = so.levels
            k_need = si.width(min(level, si.levels))
            n_w = math.ceil(2 * L2_BYTES / (2 * si.total * so.total))
            sets = [((torch.randn(si.total, so.total, generator=gen,
                                  device=device) * si.total ** -0.5)
                     .to(torch.bfloat16),) for _ in range(n_w)]
            x = torch.randn(m, k_need, generator=gen,
                            device=device).to(torch.bfloat16)
            plan = planned(m, so.width(level), k_need, nm.sm_count(device))
            steps = -(-k_need // nm.STEP_K)
            def call(x=x, w=sets[0][0], si=si, so=so, level=level):
                return nm.nested_matmul(x, w, si, so, level)

            nm.nested_split_plan = planned
            planned_splits = nested_launched(call, f"{name} level {level}",
                                             plan[0])["splits"]
            row = {}
            for splits in sorted({1, 2, 4, 8, 16, plan[0]}):
                if splits > steps:
                    continue
                nm.nested_split_plan = lambda *a, s=splits: (s,) + plan[1:]
                got = nested_launched(call, f"{name} forced to {splits} "
                                      f"splits", splits)["splits"]
                row[got] = graph_ms(rotating(
                    lambda w: nm.nested_matmul(x, w, si, so, level), sets))
            out[name] = {"plan": planned_splits, "ms_by_splits": row}
            say(f"  split sweep {name} level {level} M={m} bf16 (device "
                f"time, CUDA graph; each split count read from a graph of "
                f"the call): " + ", ".join(
                    f"{s} split(s) {t:.6f} ms" for s, t in row.items())
                + f"; the plan launched {planned_splits}")
    finally:
        nm.nested_split_plan = planned
    return out


def nested_live_split(device, cfg) -> dict:
    """Phase 5: what the idle blocks of v3's uniform split cost.  One
    launch gives every tile the same split count, sized from the longest
    k range, so the tiles of the low stripes get blocks with no steps.
    At each geometry's deepest level L and M in {4, 32}, bf16, device time
    (CUDA graph, weights rotated beyond L2): the one call against the low
    stripes (a level L-1 call) and the top stripe (a one-level call on
    its columns) launched separately, each with its own plan; the two
    outputs together are checked against the plain version."""
    import torch

    from repro_torch.core.nesting import StripeSpec
    from repro_torch.kernels import nested_matmul as nm

    gen = torch.Generator(device=device).manual_seed(7)
    out = {}
    for name, si, so in projection_geometries(cfg):
        lvl = so.levels
        k_top, k_low = si.width(min(lvl, si.levels)), si.width(
            min(lvl - 1, si.levels))
        c_low = so.width(lvl - 1)
        top_in, top_out = StripeSpec((0, k_top)), StripeSpec(
            (0, so.width(lvl) - c_low))
        n_w = math.ceil(2 * L2_BYTES / (2 * si.total * so.total))
        sets = [((torch.randn(si.total, so.total, generator=gen,
                              device=device) * si.total ** -0.5)
                 .to(torch.bfloat16),) for _ in range(n_w)]
        for m in (4, 32):
            x = torch.randn(m, k_top, generator=gen,
                            device=device).to(torch.bfloat16)

            def apart(w):
                return (nm.nested_matmul(x[:, :k_low], w, si, so, lvl - 1),
                        nm.nested_matmul(x, w[:, c_low:], top_in, top_out, 1))

            got = torch.cat(apart(sets[0][0]), dim=1)
            e, r = nested_close(got, nm.nested_matmul_plain(
                x, sets[0][0], si, so, lvl), "bfloat16")
            if r > 1.0:
                raise SmokeFailure(f"nested_matmul {name} stripes apart "
                                   f"M={m}: max abs err {e:.3e}")
            one = graph_ms(rotating(
                lambda w: nm.nested_matmul(x, w, si, so, lvl), sets))
            two = graph_ms(rotating(apart, sets))
            splits, m_tiles, n_tiles = nm.nested_split_plan(
                m, so.width(lvl), k_top, nm.sm_count(device))
            idle = m_tiles * sum(
                max(0, splits - -(-nm_tile_limit(si, so, lvl, t)
                                  // nm.STEP_K)) for t in range(n_tiles))
            out[f"{name},M={m}"] = {"one_launch_ms": one,
                                    "stripes_apart_ms": two}
            say(f"  live triangle {name} level {lvl} M={m} bf16 (device "
                f"time, CUDA graph): one launch {one:.6f} ms (by its plan "
                f"{idle} of {splits * m_tiles * n_tiles} blocks have no "
                f"k steps), low stripes and top stripe launched apart "
                f"{two:.6f} ms")
        del sets
    return out


def nm_tile_limit(si, so, level: int, tile: int) -> int:
    """The k range of v3's ``tile``-th column tile at ``level``: the input
    prefix of its last column's stripe (``column_limit`` of the source)."""
    from repro_torch.kernels import nested_matmul as nm

    last = min((tile + 1) * nm.TILE_N, so.width(level)) - 1
    stripe = next(i for i in range(1, level + 1) if last < so.width(i))
    return si.width(min(stripe, si.levels))


def time_forward_projections(device, cfg, m: int) -> dict:
    """The 7 * n_layers nested projections of one deepest-level forward
    with ``m`` rows (84 for alert-anytime-120m), in bf16 over per-layer
    random weights: kernel, blocks backend, plain version and dense
    masked matmuls, as device time (CUDA graph) and the kernel and blocks
    back to back; plus the bound of the whole set."""
    import torch

    from repro_torch.core.nesting import (block_triangular_mask,
                                          nested_linear_blocks)
    from repro_torch.kernels import nested_matmul as nm

    geo = projection_geometries(cfg)
    gen = torch.Generator(device=device).manual_seed(2)
    # per layer: wq, wk, wv, wo (d->d), w_gate, w_up (d->d_ff), w_down
    plan = [0, 0, 0, 0, 1, 1, 2]
    layers = []
    for _ in range(cfg.n_layers):
        layers.append([(torch.randn(geo[g][1].total, geo[g][2].total,
                                    generator=gen, device=device)
                        * geo[g][1].total ** -0.5).to(torch.bfloat16)
                       for g in plan])
    masks = [torch.as_tensor(block_triangular_mask(si, so), device=device,
                             dtype=torch.bfloat16) for _, si, so in geo]
    masked = [[w * masks[g] for w, g in zip(ws, plan)] for ws in layers]
    xs = [torch.randn(m, geo[g][1].total, generator=gen,
                      device=device).to(torch.bfloat16) for g in range(3)]
    level = cfg.nest_levels

    def run(call):
        def fn():
            for ws, mws in zip(layers, masked):
                for j, g in enumerate(plan):
                    call(xs[g], ws[j], mws[j], geo[g][1], geo[g][2])
        return fn

    kern = run(lambda x, w, mw, si, so: nm.nested_matmul(x, w, si, so,
                                                         level))
    blocks = run(lambda x, w, mw, si, so: nested_linear_blocks(x, w, si, so,
                                                               level))
    plain = run(lambda x, w, mw, si, so: nm.nested_matmul_plain(x, w, si,
                                                                so, level))
    library = run(lambda x, w, mw, si, so: torch.matmul(x, mw))
    before = nm.nested_matmul.launches
    kern()
    n_launch = nm.nested_matmul.launches - before
    out = {"launches": n_launch,
           "ms": graph_ms(kern, calls=4), "plain_ms": graph_ms(plain,
                                                                calls=4),
           "blocks_ms": graph_ms(blocks, calls=4),
           "library_ms": graph_ms(library, calls=4),
           "eager_ms": cuda_ms(kern, launches=5),
           "blocks_eager_ms": cuda_ms(blocks, launches=5)}
    flops = bytes_ = 0.0
    for g in plan:
        c = nm.nested_matmul_cost(m, geo[g][1], geo[g][2], level,
                                  torch.bfloat16)
        flops += c["flops"] * cfg.n_layers
        bytes_ += c["bytes_accessed"] * cfg.n_layers
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = bytes_ / H100_HBM_BYTES_S * 1e3
    out.update(bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=flops, bytes=bytes_)
    say(f"  one level-{level} forward's {n_launch} projections, M={m}, "
        f"bf16 (device time, CUDA graph): kernel {out['ms']:.6f} ms, "
        f"plain {out['plain_ms']:.6f} ms, blocks {out['blocks_ms']:.6f} ms, "
        f"library {out['library_ms']:.6f} ms; bound {out['bound_ms']:.6f} "
        f"ms by {out['bound_by']} ({flops:.4g} flop, {bytes_:.4g} B); back "
        f"to back: kernel {out['eager_ms']:.6f} ms, blocks "
        f"{out['blocks_eager_ms']:.6f} ms")
    if n_launch != 7 * cfg.n_layers:
        raise SmokeFailure(f"a forward's projections launched {n_launch} "
                           f"kernels, expected {7 * cfg.n_layers}")
    return out


# --------------------------------------------------------------------- #
# phase 8: attention kernels vs plain                                    #
# --------------------------------------------------------------------- #
def attention_close(got, want, vscale, dtype_name: str,
                    what: str) -> tuple[float, float]:
    """(max abs error, worst error / tolerance) of an attention kernel's
    output against its plain version's under ``ATT_TOL``, ``vscale`` the
    plain version's output on |v| in float32; raises past 1 or on a
    non-finite output."""
    import torch

    rtol, vtol = ATT_TOL[dtype_name]
    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise SmokeFailure(f"{what}: shape {tuple(g.shape)} vs "
                           f"{tuple(w.shape)} or non-finite output")
    diff = (g - w).abs()
    tol = rtol * w.abs() + vtol * vscale
    ratio = float(torch.where(diff > 0, diff / tol, 0.0).max())
    if ratio > 1.0:
        raise SmokeFailure(f"{what}: max abs err {float(diff.max()):.3e}, "
                           f"{ratio:.3f}x the tolerance")
    return float(diff.max()), ratio


def randn_sets(gen, shapes, dtype, device, n_sets: int):
    """``n_sets`` tuples of standard-normal tensors of ``shapes``."""
    import torch

    return [tuple(torch.randn(sh, generator=gen, device=device).to(dtype)
                  for sh in shapes) for _ in range(n_sets)]


def rotating(fn, sets):
    """A call of ``fn(*set)`` that moves to the next input set each time
    (inputs beyond the L2 cache, as a forward finds them)."""
    state = {"i": 0}

    def call():
        i = state["i"] = (state["i"] + 1) % len(sets)
        return fn(*sets[i])
    return call


def bound(cost: dict) -> tuple[float, str]:
    """max(flops / 989 TFLOP/s, bytes / 3.35 TB/s) in ms, and which."""
    t_ops = cost["flops"] / H100_BF16_FLOPS * 1e3
    t_bytes = cost["bytes_accessed"] / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def achieved(cost: dict, timing: dict) -> dict:
    """The rates a timed case reached: TFLOP/s and GB/s of its cost over
    the kernel's time, and the bound's share of that time."""
    ms = timing["ms"]
    return {"tflop_s": cost["flops"] / ms / 1e9,
            "gb_s": cost["bytes_accessed"] / ms / 1e6,
            "bound_share": timing["bound_ms"] / ms}


def sdpa_prefill(q, k, v, causal, window):
    """``scaled_dot_product_attention`` on the port's layout, as the
    library yardstick: heads moved in front by views made here (outside
    the timed call), the window as a boolean mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import live_mask

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if window is not None:
        mask = live_mask(q.shape[1], k.shape[1], causal, window, q.device)
    gqa = q.shape[2] != k.shape[2]

    def call():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=gqa)
    return call


def sdpa_decode(q, k, v, lens, window):
    """The library yardstick for decode: one query position over the
    cache with a boolean mask of the live positions."""
    import torch
    import torch.nn.functional as F

    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    live = pos < lens[:, None]
    if window is not None:
        live = live & (pos >= lens[:, None] - window)
    mask = live[:, None, None, :]
    qt, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    gqa = q.shape[1] != k.shape[2]

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=gqa)
    return call


def flash_case(device, what, b, s, h, kv, hd, *, t=None, causal=True,
               window=None, softcap=None, timed=False, seed=0) -> dict:
    """Phase 8, prefill: ``flash_attention`` against its plain version at
    one geometry (S queries over T = ``t`` keys, default S) in bf16 and
    float32; with ``timed``, the kernel, the plain version and
    ``scaled_dot_product_attention`` (None with a softcap) in bf16 over
    input sets rotated beyond L2, and the bound."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    t = s if t is None else t
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = [(b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)]
    kw = dict(causal=causal, window=window, softcap=softcap)
    rows = f"S=T={s}" if t == s else f"S={s},T={t}"
    out = {"shape": f"B={b},{rows},h={h},kv={kv},hd={hd},causal={causal},"
                    f"window={window},softcap={softcap}", "err": 0.0,
           "ratio": 0.0}
    for dt in ("bfloat16", "float32"):
        q, k, v = randn_sets(gen, shapes, getattr(torch, dt), device, 1)[0]
        got = fa.flash_attention(q, k, v, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        want = fa.flash_attention_plain(q, k, v, **kw)
        vscale = fa.flash_attention_plain(q.float(), k.float(),
                                          v.float().abs(), **kw)
        err, ratio = attention_close(got, want, vscale, dt,
                                     f"flash_attention {what} {dt}")
        out["err"] = max(out["err"], err)
        out["ratio"] = max(out["ratio"], ratio)
        say(f"  ok flash_attention {what} {out['shape']} {dt}: max abs err "
            f"{err:.3e} ({ratio:.3f} of the tolerance)")
        del q, k, v, got, want, vscale
    if not timed or device.type != "cuda":
        return out
    dtype = torch.bfloat16
    per_set = 2 * (b * s * h * hd + 2 * b * t * kv * hd)
    sets = randn_sets(gen, shapes, dtype, device,
                      max(1, math.ceil(2 * L2_BYTES / per_set)))
    out["ms"] = graph_ms(rotating(lambda q, k, v: fa.flash_attention(
        q, k, v, **kw), sets), calls=12)
    out["eager_ms"] = cuda_ms(rotating(lambda q, k, v: fa.flash_attention(
        q, k, v, **kw), sets), launches=10)
    out["plain_ms"] = cuda_ms(rotating(lambda q, k, v:
                                       fa.flash_attention_plain(
                                           q, k, v, **kw), sets),
                              launches=3, rounds=3)
    out["library_ms"] = None
    if softcap is None:
        lib_sets = [(sdpa_prefill(*x, causal, window),) for x in sets]
        out["library_ms"] = graph_ms(rotating(lambda f: f(), lib_sets),
                                     calls=12)
        out["library_eager_ms"] = cuda_ms(rotating(lambda f: f(), lib_sets),
                                          launches=10)
    cost = fa.flash_attention_cost(b, s, t, h, kv, hd, dtype, causal=causal,
                                   window=window)
    out["bound_ms"], out["bound_by"] = bound(cost)
    out.update(flops=cost["flops"], bytes=cost["bytes_accessed"],
               input_sets=len(sets), **achieved(cost, out))
    say(f"  time flash_attention {what} bf16 ({len(sets)} input sets in "
        f"turn, device time in a CUDA graph): kernel {out['ms']:.6f} ms "
        f"({out['tflop_s']:.1f} TFLOP/s, {out['bound_share']:.3f} of the "
        f"bound), plain {out['plain_ms']:.6f} ms (back to back), "
        f"scaled_dot_product_attention {out['library_ms']} ms; bound "
        f"{out['bound_ms']:.6f} ms by {out['bound_by']} "
        f"({cost['flops']:.4g} flop, {cost['bytes_accessed']:.4g} B); back "
        f"to back (host work between calls): kernel {out['eager_ms']:.6f} "
        f"ms, scaled_dot_product_attention "
        f"{out.get('library_eager_ms')} ms")
    return out


def decode_case(device, what, b, s, h, kv, hd, lens, *, window=None,
                timed=False, seed=0) -> dict:
    """Phase 8, decode: ``decode_attention`` against its plain version
    over a ``[B,S,kv,hd]`` cache in bf16 and float32, ``lens`` an int
    (passed by value) or a per-row list (an int32 tensor on the card);
    with ``timed``, kernel, plain version and library in bf16 as in
    :func:`flash_case`."""
    import torch

    from repro_torch.kernels import decode_attention as da

    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = [(b, h, hd), (b, s, kv, hd), (b, s, kv, hd)]
    cache_len = lens if isinstance(lens, int) else torch.tensor(
        lens, dtype=torch.int32, device=device)
    out = {"shape": f"B={b},S={s},h={h},kv={kv},hd={hd},cache_len={lens},"
                    f"window={window}", "err": 0.0, "ratio": 0.0}
    for dt in ("bfloat16", "float32"):
        q, k, v = randn_sets(gen, shapes, getattr(torch, dt), device, 1)[0]
        got = da.decode_attention(q, k, v, cache_len, window=window)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            out.update(decode_launched(
                device, f"{what} {out['shape']} {dt}", b, s, h, kv, window,
                lambda: da.decode_attention(q, k, v, cache_len,
                                            window=window)))
        want = da.decode_attention_plain(q, k, v, cache_len, window=window)
        vscale = da.decode_attention_plain(q.float(), k.float(),
                                           v.float().abs(), cache_len,
                                           window=window)
        err, ratio = attention_close(got, want, vscale, dt,
                                     f"decode_attention {what} {dt}")
        out["err"] = max(out["err"], err)
        out["ratio"] = max(out["ratio"], ratio)
        say(f"  ok decode_attention {what} {out['shape']} {dt}: max abs err "
            f"{err:.3e} ({ratio:.3f} of the tolerance)")
        del q, k, v, got, want, vscale
    if not timed or device.type != "cuda":
        return out
    dtype = torch.bfloat16
    lens_t = torch.tensor(lens if isinstance(lens, list) else [lens] * b,
                          dtype=torch.int32, device=device)
    cost = da.decode_attention_cost(b, s, h, kv, hd, dtype, lens_t,
                                    window=window)
    sets = randn_sets(gen, shapes, dtype, device, max(1, math.ceil(
        2 * L2_BYTES / (2 * 2 * b * s * kv * hd))))
    out["ms"] = graph_ms(rotating(lambda q, k, v: da.decode_attention(
        q, k, v, cache_len, window=window), sets), calls=20)
    out["eager_ms"] = cuda_ms(rotating(lambda q, k, v: da.decode_attention(
        q, k, v, cache_len, window=window), sets), launches=20)
    out["plain_ms"] = cuda_ms(rotating(lambda q, k, v:
                                       da.decode_attention_plain(
                                           q, k, v, lens_t, window=window),
                                       sets), launches=5, rounds=3)
    lib_sets = [(sdpa_decode(*x, lens_t, window),) for x in sets]
    out["library_ms"] = graph_ms(rotating(lambda f: f(), lib_sets),
                                 calls=20)
    out["library_eager_ms"] = cuda_ms(rotating(lambda f: f(), lib_sets),
                                      launches=20)
    out["bound_ms"], out["bound_by"] = bound(cost)
    out.update(flops=cost["flops"], bytes=cost["bytes_accessed"],
               input_sets=len(sets), **achieved(cost, out))
    say(f"  time decode_attention {what} bf16 ({len(sets)} caches in turn, "
        f"device time in a CUDA graph): kernel {out['ms']:.6f} ms "
        f"({out['gb_s']:.1f} GB/s, {out['bound_share']:.3f} of the bound), "
        f"plain {out['plain_ms']:.6f} ms (back to back), "
        f"scaled_dot_product_attention {out['library_ms']:.6f} ms; bound "
        f"{out['bound_ms']:.6f} ms by {out['bound_by']} "
        f"({cost['flops']:.4g} flop, {cost['bytes_accessed']:.4g} B); back "
        f"to back (host work between calls): kernel {out['eager_ms']:.6f} "
        f"ms, scaled_dot_product_attention {out['library_eager_ms']:.6f} ms")
    return out


def decode_launched(device, what, b, s, h, kv, window, call) -> dict:
    """The kernels one ``decode_attention`` call launched (read from a
    CUDA graph of the call): the split kernel's grid gives the splits and
    blocks; raises unless they are the plan's, with the combine launched
    exactly when the plan splits, and nothing else launched."""
    from repro_torch.kernels import decode_attention as da

    plan, most = da.decode_split_plan(b, kv, h // kv, s, window,
                                      da.sm_count(device))
    launched = captured_kernels(call)
    main = [grid for name, grid in launched
            if "decode_attention_kernel" in name]
    combine = [grid for name, grid in launched
               if "decode_attention_combine" in name]
    splits = main[0][0] // kv if len(main) == 1 else None
    say(f"  launched decode_attention {what}: {len(launched)} CUDA "
        f"launch(es), {[name[:40] for name, _ in launched]}, grids "
        f"{[grid for _, grid in launched]}; {splits} split(s) (the plan: "
        f"{plan} of at most {most} tile(s) each)")
    if len(main) != 1 or splits != plan or len(combine) != (plan > 1) \
            or len(launched) != 1 + (plan > 1):
        raise SmokeFailure(f"decode_attention {what} launched {launched}, "
                           f"not the plan's {plan} split(s)")
    return {"splits": splits, "blocks": math.prod(main[0]),
            "cuda_launches": len(launched)}


def time_main_path_attention(device, cfg) -> dict:
    """The served shapes at the deepest level (B=4, 8-token prompt, a
    12-slot cache at cache_len 11, all heads), bf16: each kernel as device
    time (CUDA graph) and back to back, its plain version and the library
    call as device time, and the bound."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    b, s, slots, n = 4, 8, 12, cfg.n_heads
    hd, dtype = cfg.head_dim, torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(3)
    q, k, v = randn_sets(gen, [(b, s, n, hd)] * 3, dtype, device, 1)[0]
    qd, kc, vc = randn_sets(gen, [(b, n, hd), (b, slots, n, hd),
                                  (b, slots, n, hd)], dtype, device, 1)[0]
    lens = torch.full((b,), slots - 1, dtype=torch.int32, device=device)
    pre = {"ms": graph_ms(lambda: fa.flash_attention(q, k, v)),
           "eager_ms": cuda_ms(lambda: fa.flash_attention(q, k, v),
                               launches=200),
           "plain_ms": graph_ms(lambda: fa.flash_attention_plain(q, k, v)),
           "library_ms": graph_ms(sdpa_prefill(q, k, v, True, None))}
    pre["bound_ms"], pre["bound_by"] = bound(fa.flash_attention_cost(
        b, s, s, n, n, hd, dtype))
    dec = {"ms": graph_ms(lambda: da.decode_attention(qd, kc, vc, slots - 1)),
           "eager_ms": cuda_ms(lambda: da.decode_attention(qd, kc, vc,
                                                           slots - 1),
                               launches=200),
           "plain_ms": graph_ms(lambda: da.decode_attention_plain(
               qd, kc, vc, lens)),
           "library_ms": graph_ms(sdpa_decode(qd, kc, vc, lens, None))}
    dec["bound_ms"], dec["bound_by"] = bound(da.decode_attention_cost(
        b, slots, n, n, hd, dtype, slots - 1))
    pre["shape"] = f"B={b},S=T={s},h=kv={n},hd={hd},bf16"
    dec["shape"] = (f"B={b},S={slots},h=kv={n},cache_len={slots - 1},"
                    f"hd={hd},bf16")
    for name, r in (("flash_attention", pre), ("decode_attention", dec)):
        r["bound_share"] = r["bound_ms"] / r["ms"]
        say(f"  time {name} main path {r['shape']} (device time, CUDA "
            f"graph): kernel {r['ms']:.6f} ms ({r['bound_share']:.4f} of "
            f"the bound), plain {r['plain_ms']:.6f} ms, "
            f"scaled_dot_product_attention {r['library_ms']:.6f} ms; bound "
            f"{r['bound_ms']:.9f} ms by {r['bound_by']}; back to back "
            f"(host work between calls) {r['eager_ms']:.6f} ms")
    return {"flash_attention": pre, "decode_attention": dec}


# The dense family's attention geometries (phase 8, timed): the served
# prefill (B=4, an 8-token prompt) and decode (B=4 over the 12-slot cache)
# of qwen2.5-14b (40 query heads over 8 KV heads of 128: g=5, so the
# decode kernel's second block of a KV head carries one live head of its
# four slots; per-row lengths) and stablelm-12b (hd 160: the prefill
# kernel's hd-192 instance with zeroed padding, 20 decode lanes a row);
# gemma3-1b's served prefill and decode (h=4, kv=1, hd 256, window 512:
# an 8-token prompt shorter than one tile, decode over the 12-slot cache at
# per-row lengths), its one 1024-token prompt (B=1) and a 1024-position
# cache (B=4), both with window 512 (per-row lengths put the window's start
# inside a 32-position tile); g=5 decode with window 512 over per-row
# lengths, one of them shorter than a tile; and the MoE family's served
# prefill and decode at per-row lengths: olmoe-1b-7b's MHA (g=1, 16 KV
# heads of 128) and qwen3-moe-30b-a3b's g=8 (32 query heads over 4 KV heads
# of 128: two 4-head decode blocks a KV head); the hybrid's jamba-v0.1-52b
# (g=4: 32 query heads over 8 KV heads of 128, one 4-head decode block a KV
# head) and the vision-language decoder qwen2-vl-2b (g=6: 12 query heads
# over 2 KV heads of 128, the second decode block of a KV head with two live
# heads of its four).
DENSE_FLASH = (
    ("qwen2.5-14b", (4, 8, 40, 8, 128), {}),
    ("stablelm-12b", (4, 8, 32, 8, 160), {}),
    ("gemma3-1b", (4, 8, 4, 1, 256), {"window": 512}),
    ("gemma3-1b_1024_window", (1, 1024, 4, 1, 256), {"window": 512}),
    ("olmoe-1b-7b", (4, 8, 16, 16, 128), {}),
    ("qwen3-moe-30b-a3b", (4, 8, 32, 4, 128), {}),
    ("jamba-v0.1-52b", (4, 8, 32, 8, 128), {}),
    ("qwen2-vl-2b", (4, 8, 12, 2, 128), {}))
DENSE_DECODE = (
    ("qwen2.5-14b_rows", (4, 12, 40, 8, 128, [9, 10, 11, 12]), {}),
    ("olmoe-1b-7b_rows", (4, 12, 16, 16, 128, [9, 10, 11, 12]), {}),
    ("qwen3-moe-30b-a3b_rows", (4, 12, 32, 4, 128, [9, 10, 11, 12]), {}),
    ("jamba-v0.1-52b_rows", (4, 12, 32, 8, 128, [9, 10, 11, 12]), {}),
    ("qwen2-vl-2b_rows", (4, 12, 12, 2, 128, [9, 10, 11, 12]), {}),
    ("stablelm-12b", (4, 12, 32, 8, 160, 11), {}),
    ("gemma3-1b_rows", (4, 12, 4, 1, 256, [9, 10, 11, 12]),
     {"window": 512}),
    ("gemma3-1b_1024_window", (4, 1024, 4, 1, 256, 1024), {"window": 512}),
    ("gemma3-1b_1024_window_rows", (4, 1024, 4, 1, 256,
                                    [1024, 1001, 600, 515]),
     {"window": 512}),
    ("g5_window_rows", (4, 2048, 40, 8, 128, [2048, 1500, 700, 3]),
     {"window": 512}))


# The encoder-decoder's attention (whisper-tiny: h=kv=6, hd 64, no RoPE in
# cross-attention), the first callers of flash_attention with S != T and
# of its hd-64 instance: the prompt's S=4 queries over T=1500 encoder
# frames (Whisper's 30-second window: a ragged last 64-key tile), the
# encoder's non-causal S=T=1500 (a ragged last query tile too), one query
# over the frames (flash_attention's single-row case; the model's decode
# runs decode_attention there), a ragged S=37 over T=100, and the
# decoder's causal self-attention over the S=T=4 prompt (the hd-64
# instance's diagonal tile); and decode_attention over the T=1500 frames
# with every frame live (g=1).
WHISPER_FLASH = (
    ("whisper_cross_s4_t1500", (4, 4, 6, 6, 64), {"t": 1500,
                                                   "causal": False}),
    ("whisper_encoder_s1500", (4, 1500, 6, 6, 64), {"causal": False}),
    ("whisper_cross_s1_t1500", (4, 1, 6, 6, 64), {"t": 1500,
                                                   "causal": False}),
    ("whisper_s37_t100", (2, 37, 6, 6, 64), {"t": 100, "causal": False}),
    ("whisper_decoder_self_s4", (4, 4, 6, 6, 64), {}))
WHISPER_DECODE = (
    ("whisper_cross_t1500", (4, 1500, 6, 6, 64, 1500), {}),)


def attention_vs_plain(device, cfg, full: bool = True) -> dict:
    """Phase 8: both attention kernels against their plain versions at
    (a) the served shapes of ``cfg`` (prefill B=4, S=T=8, h=kv in {1, 2, 4,
    8}; decode over the 12-slot cache at cache_len 9-12, by value and per
    row), and with ``full`` (b) ``cfg`` at a 2048-token prompt and (c)
    gemma3-1b's attention geometry (h=4, kv=1, hd=256, window 512; shapes
    only), timed; then untimed, the split and padding paths: decode with
    many splits at B=1 (h=8, kv=1), ragged rows with an empty one and a
    window over per-row lengths; prefill at head dims 8, 40, 72 and 128
    (zero padding in shared memory), a ragged causal S=100, a window at
    S=1000, softcap 50 and no causal mask at S=200 (the wgmma path at hd
    96); the dense family's served shapes, timed (``DENSE_FLASH``,
    ``DENSE_DECODE``); the encoder-decoder's S != T, non-causal, hd-64
    shapes (``WHISPER_FLASH``, ``WHISPER_DECODE``; timed in phase 26).
    Returns the cases by name."""
    hd, heads = cfg.head_dim, [2 ** i for i in range(cfg.nest_levels)]
    res = {"fa": {}, "da": {}}
    for n in heads:
        res["fa"][f"a_h{n}"] = flash_case(device, "(a)", 4, 8, n, n, hd,
                                          seed=n)
        for lens in (9, 10, 11, 12, [9, 10, 11, 12]):
            res["da"][f"a_h{n}_{lens}"] = decode_case(
                device, "(a)", 4, 12, n, n, hd, lens, seed=n)
    if not full:
        return res
    res["fa"]["b"] = flash_case(device, "(b)", 4, 2048, cfg.n_heads,
                                cfg.n_kv_heads, hd, timed=True)
    res["da"]["b"] = decode_case(device, "(b)", 4, 2048, cfg.n_heads,
                                 cfg.n_kv_heads, hd, [2048, 1500, 1024, 517],
                                 timed=True)
    res["fa"]["c_window"] = flash_case(device, "(c)", 1, 4096, 4, 1, 256,
                                       window=512, timed=True)
    res["fa"]["c_softcap"] = flash_case(device, "(c)", 1, 4096, 4, 1, 256,
                                        window=512, softcap=50.0, timed=True)
    res["da"]["c_global"] = decode_case(device, "(c)", 4, 32768, 4, 1, 256,
                                        32768, timed=True)
    res["da"]["c_window"] = decode_case(device, "(c)", 4, 32768, 4, 1, 256,
                                        32768, window=512, timed=True)
    for name, args, kw in (
            ("split_b1", (1, 32768, 8, 1, 128, 32768), {}),
            ("split_ragged", (4, 32768, 4, 1, 256, [32768, 31, 0, 4097]),
             {}),
            ("split_window_rows", (4, 32768, 4, 1, 256,
                                   [32768, 3000, 600, 1]), {"window": 512})):
        res["da"][name] = decode_case(device, name, *args, **kw)
    for name, args, kw in (("pad_hd8", (2, 100, 2, 2, 8), {}),
                           ("pad_hd40", (2, 100, 4, 2, 40), {}),
                           ("pad_hd72", (2, 150, 4, 2, 72), {}),
                           ("hd128", (2, 300, 4, 4, 128), {}),
                           ("ragged_s100", (2, 100, 8, 8, hd), {}),
                           ("window_s1000", (1, 1000, 2, 1, hd),
                            {"window": 100}),
                           ("softcap_s200", (2, 200, 4, 2, hd),
                            {"softcap": 50.0}),
                           ("bidirectional_s200", (2, 200, 4, 2, hd),
                            {"causal": False})):
        res["fa"][name] = flash_case(device, name, *args, **kw)
    for name, args, kw in DENSE_FLASH:
        res["fa"][name] = flash_case(device, name, *args, timed=True, **kw)
    for name, args, kw in DENSE_DECODE:
        res["da"][name] = decode_case(device, name, *args, timed=True, **kw)
    for name, args, kw in WHISPER_FLASH:
        res["fa"][name] = flash_case(device, name, *args, **kw)
    for name, args, kw in WHISPER_DECODE:
        res["da"][name] = decode_case(device, name, *args, **kw)
    return res


# --------------------------------------------------------------------- #
# phase 11: rwkv_scan kernel vs plain                                    #
# --------------------------------------------------------------------- #
def rwkv_inputs(gen, b, s, h, hd, device, strided=False):
    """float32 inputs of one scan: r, k, v standard normal, w =
    sigmoid(normal) in (0, 1), u = sigmoid(normal) / 2, s0 normal / 10.
    With ``strided`` r, k, v and w are views of one ``[B, S, 4*H*hd]``
    tensor (token stride 4*H*hd), as projections of ``[B, S, d]`` are."""
    import torch

    shape = (b, s, 4 * h * hd) if strided else (4, b, s, h, hd)
    x = torch.randn(shape, generator=gen, device=device)
    if strided:
        r, k, v, w = (x[..., i * h * hd:(i + 1) * h * hd].view(b, s, h, hd)
                      for i in range(4))
    else:
        r, k, v, w = x.unbind(0)
    w.copy_(torch.sigmoid(w))
    u = torch.sigmoid(torch.randn((h, hd), generator=gen,
                                  device=device)) * 0.5
    s0 = torch.randn((b, h, hd, hd), generator=gen, device=device) * 0.1
    return [r, k, v, w, u, s0]


def rwkv_close(got, want, scale, dtype_name: str,
               what: str) -> tuple[float, float]:
    """(max abs error, worst error / tolerance) of one output of the kernel
    against the plain version's under ``RS_TOL``, ``scale`` the plain
    version's output on the absolute inputs; raises past 1 or on a
    non-finite output."""
    import torch

    rtol, atol = RS_TOL[dtype_name]
    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise SmokeFailure(f"{what}: shape {tuple(g.shape)} vs "
                           f"{tuple(w.shape)} or non-finite output")
    diff = (g - w).abs()
    tol = rtol * w.abs() + atol * scale
    ratio = float(torch.where(diff > 0, diff / tol, 0.0).max())
    if ratio > 1.0:
        raise SmokeFailure(f"{what}: max abs err {float(diff.max()):.3e}, "
                           f"{ratio:.3f}x the tolerance")
    return float(diff.max()), ratio


def rwkv_bound(b, s, h, hd, itemsize) -> tuple[float, str, dict]:
    """max(flops / 67 TFLOP/s (float32 outside the tensor cores), bytes /
    3.35 TB/s) in ms, which of the two, and the cost."""
    from repro_torch.kernels.rwkv_scan import rwkv_scan_cost

    cost = rwkv_scan_cost(b, s, h, hd, itemsize)
    t_ops = cost["flops"] / H100_FP32_FLOPS * 1e3
    t_bytes = cost["bytes_accessed"] / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), cost


@contextlib.contextmanager
def forced_segments(segments: int | None):
    """``rwkv_scan``'s plan replaced by ``segments`` for every call inside
    (``None``: the plan itself)."""
    from repro_torch.kernels import rwkv_scan as rs

    plan = rs.rwkv_scan_plan
    if segments is not None:
        rs.rwkv_scan_plan = lambda *shape: segments
    try:
        yield
    finally:
        rs.rwkv_scan_plan = plan


# The kernels of one rwkv_scan call: the states pass and the fold only
# when the call runs more than one segment; a one-token call of one
# segment runs the decode kernel alone.
RS_NODES = ("rwkv_scan_states", "rwkv_scan_fold", "rwkv_scan_kernel",
            "rwkv_scan_decode")


def rwkv_launched(what, b, s, h, segments: int, call) -> dict:
    """The kernels one ``rwkv_scan`` call on ``[b, s, h, hd]`` launched,
    read from a CUDA graph of the call; raises unless they are
    ``segments``' (one ``rwkv_scan_kernel`` of grid (H, B, 1) for one
    segment, ``rwkv_scan_decode`` (H, B, 1) for one token; else the states
    pass (H, B, P-1), the fold (H, B, 1) and the y pass (H, B, P)) and
    nothing else launched.  ``segments`` in the result is the y pass's
    grid depth as read from the graph."""
    launched = captured_kernels(call)
    got = sorted((next((n for n in RS_NODES if n in name), name), grid)
                 for name, grid in launched)
    last = "rwkv_scan_decode" if s == 1 and segments == 1 else \
        "rwkv_scan_kernel"
    want = [(last, (h, b, segments))]
    if segments > 1:
        want += [("rwkv_scan_fold", (h, b, 1)),
                 ("rwkv_scan_states", (h, b, segments - 1))]
    if got != sorted(want):
        raise SmokeFailure(f"rwkv_scan {what} launched {got}, not the "
                           f"{segments}-segment plan's {sorted(want)}")
    return {"segments": next(g[2] for n, g in got if n == last),
            "cuda_launches": len(launched)}


def rwkv_case(device, what, b, s, h, hd, *, strided=False, timed=False,
              seed=0, segments=None) -> dict:
    """Phase 11: ``rwkv_scan`` against its plain version on the same
    inputs, in bf16 and float32, y and the final state within ``RS_TOL``;
    the float32 plain run is timed once with CUDA events.  ``segments``
    forces the kernel's plan (``None``: ``rwkv_scan_plan``'s).  On the
    card every call is made twice (bitwise equal) and the float32 call's
    kernels are read from a graph of it (the plan's).  With ``timed``, the
    kernel in float32 with CUDA events (the inputs of (b) and (c) are
    over 400 MB, beyond the 50 MB L2), beside the bound."""
    import torch

    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.kernels.checks import sm_count

    gen = torch.Generator(device=device).manual_seed(seed)
    x = rwkv_inputs(gen, b, s, h, hd, device, strided=strided)
    absx = [t.abs() for t in x]
    scale_y, scale_s = rs.rwkv_scan_plain(*absx)
    del absx
    on_card = device.type == "cuda"
    plan = segments if segments is not None else (
        rs.rwkv_scan_plan(b, s, h, sm_count(device)) if on_card else 1)
    out = {"shape": f"B={b},S={s},H={h},hd={hd},strided={strided}",
           "segments": plan, "err": 0.0, "ratio": 0.0}
    for dt in ("bfloat16", "float32"):
        xd = [t.to(getattr(torch, dt)) for t in x[:4]] + x[4:]
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        want_y, want_s = rs.rwkv_scan_plain(*xd)
        if on_card:
            torch.cuda.synchronize(device)
        if dt == "float32":
            out["plain_ms"] = (time.perf_counter() - t0) * 1e3
        with forced_segments(segments):
            got_y, got_s = rs.rwkv_scan(*xd)
            if on_card:
                again_y, again_s = rs.rwkv_scan(*xd)
                if not (torch.equal(got_y, again_y)
                        and torch.equal(got_s, again_s)):
                    raise SmokeFailure(f"rwkv_scan {what} {dt}: two "
                                       f"identical calls differ")
                del again_y, again_s
                if dt == "float32":
                    out.update(rwkv_launched(what, b, s, h, plan,
                                             lambda: rs.rwkv_scan(*xd)))
        if on_card:
            torch.cuda.synchronize(device)
        label = f"rwkv_scan {what} {dt}"
        ey, ry = rwkv_close(got_y, want_y, scale_y, dt, f"{label} y")
        es, r_s = rwkv_close(got_s, want_s, scale_s, "float32",
                             f"{label} state")
        out["err"] = max(out["err"], ey, es)
        out["ratio"] = max(out["ratio"], ry, r_s)
        say(f"  ok {label} {out['shape']}, {plan} segment(s): max abs err "
            f"y {ey:.3e} ({ry:.3f} of the tolerance), state {es:.3e} "
            f"({r_s:.3f}){'; bitwise equal twice' if on_card else ''}")
        del xd, want_y, want_s, got_y, got_s
    if not timed or not on_card:
        return out
    out["ms"] = rwkv_ms(x, what, segments)[1]
    out["library_ms"] = None
    out["bound_ms"], out["bound_by"], cost = rwkv_bound(b, s, h, hd, 4)
    out.update(flops=cost["flops"], bytes=cost["bytes_accessed"])
    say(f"  time rwkv_scan {what} float32 {out['shape']}, {plan} "
        f"segment(s) (CUDA events): kernel {out['ms']:.6f} ms, plain (one "
        f"run) {out['plain_ms']:.3f} ms; bound {out['bound_ms']:.6f} ms by "
        f"{out['bound_by']} ({cost['flops']:.4g} flop at 67 TFLOP/s, "
        f"{cost['bytes_accessed']:.4g} B at 3.35 TB/s); no single PyTorch "
        f"call computes it")
    if segments is None:
        out["segment_sweep"] = {
            str(read): ms for read, ms in (
                rwkv_ms(x, what, p)
                for p in sorted({1, max(1, plan // 2), plan * 2} - {plan}))}
        say(f"  time rwkv_scan {what} float32 at other segment counts "
            f"(ms): {out['segment_sweep']} (the plan's {plan}: "
            f"{out['ms']:.6f})")
    return out


def rwkv_ms(x, what, segments: int | None) -> tuple[int, float]:
    """One float32 ``rwkv_scan`` call on ``x`` with the plan forced to
    ``segments`` (``None``: the plan's): the segments its kernels ran, read
    from a CUDA graph of the call (:func:`rwkv_launched`, which raises
    unless they are the forced plan's), and its device time (CUDA events
    around back-to-back calls)."""
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.kernels.checks import sm_count

    b, s, h, _ = x[0].shape
    with forced_segments(segments):
        plan = segments if segments is not None else rs.rwkv_scan_plan(
            b, s, h, sm_count(x[0].device))
        read = rwkv_launched(f"{what} timed", b, s, h, plan,
                             lambda: rs.rwkv_scan(*x))["segments"]
        return read, cuda_ms(lambda: rs.rwkv_scan(*x),
                             launches=20 if s <= 4096 else 3, rounds=3,
                             warmup=1)


def time_main_path_rwkv(device, cfg) -> dict:
    """The served shapes (B=4, ``rwkv_n_heads`` heads of
    ``rwkv_head_dim``; an 8-token prefill and a 1-token decode step) in
    float32, as the model calls the scan: the kernel as device time (a
    CUDA graph of 480 calls, 11 replays: the steps are a few microseconds,
    so fewer calls leave a spread of several percent) and back to back,
    the plain version as device time, and the bound."""
    import torch

    from repro_torch.kernels import rwkv_scan as rs

    b, h, hd = 4, cfg.rwkv_n_heads, cfg.rwkv_head_dim
    gen = torch.Generator(device=device).manual_seed(4)
    res = {}
    for name, s in (("prefill", 8), ("decode", 1)):
        x = rwkv_inputs(gen, b, s, h, hd, device)
        r = {"shape": f"B={b},S={s},H={h},hd={hd},float32"}
        r["ms"] = graph_ms(lambda: rs.rwkv_scan(*x), calls=480, rounds=11)
        r["eager_ms"] = cuda_ms(lambda: rs.rwkv_scan(*x), launches=200)
        r["plain_ms"] = graph_ms(lambda: rs.rwkv_scan_plain(*x), calls=8)
        r["library_ms"] = None
        r["bound_ms"], r["bound_by"], _ = rwkv_bound(b, s, h, hd, 4)
        say(f"  time rwkv_scan main path {name} {r['shape']} (device time, "
            f"CUDA graph): kernel {r['ms']:.6f} ms, plain "
            f"{r['plain_ms']:.6f} ms; bound "
            f"{r['bound_ms']:.6f} ms by {r['bound_by']}; back to back "
            f"(host work between calls) {r['eager_ms']:.6f} ms")
        res[name] = r
    return res


# Phase 11's forced plans: (segments, B, S, H, hd, strided): ragged
# segments at every head dim, and S < P.
RS_FORCED = ((1, 2, 77, 3, 64, True), (2, 2, 77, 3, 16, False),
             (3, 2, 77, 3, 32, False), (7, 2, 77, 3, 64, True),
             (7, 1, 5, 2, 32, False), (3, 2, 2, 3, 16, False),
             (2, 4, 300, 40, 64, False))


def rwkv_vs_plain(device, cfg, full: bool = True) -> dict:
    """Phase 11: ``rwkv_scan`` against its plain version at (a) the served
    shapes of ``cfg`` (B=4, an 8-token prefill and a 1-token decode step),
    a ragged length no chunk divides, strided views and head dims 16 and
    32, the plans of ``RS_FORCED``, and with ``full`` (b) a 2048-token
    prompt (B=4) and (c) a 32768-token sequence (B=1), timed with the
    plan and at other segment counts."""
    h, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    res = {"a_prefill": rwkv_case(device, "(a)", 4, 8, h, hd),
           "a_decode": rwkv_case(device, "(a)", 4, 1, h, hd)}
    for i, dim in enumerate((16, 32, 64)):
        res[f"ragged_hd{dim}"] = rwkv_case(device, "ragged", 2, 77, 3, dim,
                                           strided=dim == 64, seed=i + 1)
    for i, (p, b, s, nh, dim, strided) in enumerate(RS_FORCED):
        res[f"forced_{p}_{b}x{s}x{nh}x{dim}"] = rwkv_case(
            device, f"forced P={p}", b, s, nh, dim, strided=strided,
            seed=10 + i, segments=p)
    if full:
        res["b"] = rwkv_case(device, "(b)", 4, 2048, h, hd, timed=True)
        res["c"] = rwkv_case(device, "(c)", 1, RWKV_LONG, h, hd,
                             timed=True)
    return res


def param_tensors(params) -> list:
    """Every tensor of the port's parameter tree (dicts and per-layer
    lists: an LM's ``layers``, an encoder-decoder's ``encoder`` and
    ``decoder``; a tied model has no ``unembed``)."""
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, list):
        return [w for p in params for w in param_tensors(p)]
    return [params]


def copy_params(params, device):
    """The port's parameter tree with every tensor copied to ``device``."""
    if isinstance(params, dict):
        return {k: copy_params(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [copy_params(v, device) for v in params]
    return params.to(device)


def rwkv_model_cpu_vs_card(device) -> float:
    """The reduced float32 RWKV-6 model with the same weights on the CPU
    (plain scan) and on the card (the kernel): prefill logits and every
    state leaf, then 3 decode steps, within 1e-4 (float32, TF32 off; the
    card sums in another order).  Returns the largest logit difference."""
    import numpy as np
    import torch

    from repro_torch.configs.rwkv6_3b import reduced
    from repro_torch.models import transformer as tfm

    cfg = reduced().replace(dtype="float32")
    cpu = torch.device("cpu")
    params = tfm.init_lm(cfg, torch.Generator().manual_seed(0), device=cpu)
    on_card = copy_params(params, device)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 11))
    worst = 0.0
    with torch.inference_mode():
        a = tfm.lm_apply(params, cfg, torch.as_tensor(toks[:, :8]))
        b = tfm.lm_apply(on_card, cfg, torch.as_tensor(toks[:, :8],
                                                       device=device))
        for i in range(4):
            pairs = [(a.logits, b.logits)] + [
                (x, y) for sa, sb in zip(a.caches, b.caches)
                for x, y in zip(sa, sb)]
            for x, y in pairs:
                y = y.cpu()
                worst = max(worst, float((x - y).abs().max()))
                if not torch.allclose(x, y, rtol=1e-4, atol=1e-4):
                    raise SmokeFailure(
                        f"reduced RWKV model, step {i}: card differs from "
                        f"CPU by {float((x - y).abs().max())}")
            if i == 3:
                break
            tok = toks[:, 8 + i:9 + i]
            a = tfm.lm_apply(params, cfg, torch.as_tensor(tok),
                             mode="decode", caches=a.caches,
                             cache_len=8 + i)
            b = tfm.lm_apply(on_card, cfg, torch.as_tensor(tok,
                                                           device=device),
                             mode="decode", caches=b.caches,
                             cache_len=8 + i)
    say(f"  reduced RWKV model (hd {cfg.rwkv_head_dim}), card (kernel) vs "
        f"CPU (plain), prefill and 3 decode steps, logits and states: ok "
        f"(max abs diff {worst:.3e})")
    return worst


# --------------------------------------------------------------------- #
# phases 4, 6, 7, 9 and 10: the model and the server                    #
# --------------------------------------------------------------------- #
def model_cpu_vs_card(device, backend: str = "blocks",
                      attn_backend: str = "ref") -> float:
    """The reduced float32 model with the same weights on the CPU (nest
    backend ``blocks``, attention ``ref``) and on the card (nest backend
    ``backend``, attention ``attn_backend``): per-level prefill logits,
    and one KV-cached decode step against the full forward, within 1e-4
    (float32, TF32 off; the card sums in another order)."""
    import numpy as np
    import torch

    from repro_torch.configs.alert_anytime import reduced
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.models.registry import build_model

    cfg = reduced().replace(dtype="float32")
    card_cfg = cfg.replace(nest_backend=backend, attn_backend=attn_backend)
    cpu = torch.device("cpu")
    params = tfm.init_lm(cfg, torch.Generator().manual_seed(0), device=cpu)
    on_card = copy_params(params, device)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
    worst = 0.0
    with torch.inference_mode():
        for level in range(1, cfg.nest_levels + 1):
            a = tfm.lm_apply(params, cfg, torch.as_tensor(toks[:, :8]),
                             level=level).logits
            b = tfm.lm_apply(on_card, card_cfg,
                             torch.as_tensor(toks[:, :8], device=device),
                             level=level).logits.cpu()
            worst = max(worst, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                raise SmokeFailure(f"level {level}: card logits differ from "
                                   f"CPU by {float((a - b).abs().max())}")
            eng = ServeEngine(build_model(card_cfg), max_len=12,
                              batch_size=2, device=device)
            t = torch.as_tensor(toks, device=device)
            full = tfm.lm_apply(on_card, card_cfg, t,
                                level=level).logits[:, 8]
            pre = tfm.lm_apply(on_card, card_cfg, t[:, :8], level=level)
            caches = eng._merge(eng.init_caches(level), pre.caches)
            step = tfm.lm_apply(on_card, card_cfg, t[:, 8:9], mode="decode",
                                caches=caches, cache_len=8,
                                level=level).logits[:, 0]
            if not torch.allclose(step, full, rtol=1e-4, atol=1e-4):
                raise SmokeFailure(f"level {level}: decode step differs from "
                                   f"the full forward")
    say(f"  reduced model, card ({backend} nest, {attn_backend} attention) "
        f"vs CPU (blocks, ref) and decode vs forward: ok (max abs logit "
        f"diff {worst:.3e})")
    return worst


# --------------------------------------------------------------------- #
# phases 14-23: the dense, MoE, hybrid and vision-language families     #
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def recording_routes():
    """Records the expert ids of every ``route_topk`` call the MoE blocks
    make while it is open (eager calls only: a graph replay runs no
    Python), one ``[T, top_k]`` tensor per call in call order."""
    from repro_torch.models import moe as moe_mod

    seen = []
    plain = moe_mod.route_topk

    def rec(logits, top_k):
        out = plain(logits, top_k)
        seen.append(out[1])
        return out
    moe_mod.route_topk = rec
    try:
        yield seen
    finally:
        moe_mod.route_topk = plain


def dropped_assignments(ids, cfg) -> int:
    """Assignments ``moe`` drops for the routed ids ``[T, top_k]`` of one
    call: per group (``MOE_GROUP_SIZE`` tokens, or all of them), each
    expert's assignments past the group's capacity."""
    import torch

    from repro_torch.models.moe import MOE_GROUP_SIZE, capacity

    t = ids.shape[0]
    sg = min(MOE_GROUP_SIZE, t)
    c = capacity(sg, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    per_group = ids.reshape(t // sg, -1).cpu()
    loads = torch.stack([torch.bincount(g, minlength=cfg.n_experts)
                         for g in per_group])
    return int((loads - c).clamp(min=0).sum())


def reduced_cpu_vs_card(device, cfg, pos3d: bool = False) -> dict:
    """Phases 14, 18 and 21: ``cfg`` (a reduced float32 model without
    nesting, ``attn_backend="kernel"``) with the same weights (non-zero
    q/k/v biases where it has them) on the card, where the attention
    kernels run, and on the CPU, where their plain versions run: prefill
    logits and every cache (KV, and the ``MambaState`` of a Mamba layer),
    then 3 decode steps, within 1e-4 (float32, TF32 off; the card sums in
    another order), as phase 12; in a MoE model every layer's routed
    expert ids of every step must be equal.  The 12-token prompt is longer
    than gemma3's reduced window of 8, so the window masks in prefill and
    in decode.  With ``pos3d`` every forward gets three distinct M-RoPE
    position streams (``[3, B, 12]``, then ``[3, B, 1]``).  The card must
    launch ``flash_attention`` once per attention layer in prefill and
    ``decode_attention`` once per attention layer a decode step.  Returns
    the largest difference, the launches and the assignments the prefill
    dropped (summed over its MoE layers)."""
    import numpy as np
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServeEngine

    cpu = torch.device("cpu")
    params = tfm.init_lm(cfg, torch.Generator().manual_seed(0), device=cpu)
    gen = torch.Generator().manual_seed(1)
    for layer in params["layers"]:
        for name in ("bq", "bk", "bv"):
            if name in layer["mixer"]:
                layer["mixer"][name].normal_(0.0, 0.5, generator=gen)
    sides = ((params, cpu), (copy_params(params, device), device))
    engines = [ServeEngine(build_model(cfg), max_len=15, batch_size=2,
                           device=dev, graphs=False) for _, dev in sides]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 15))
    base = np.arange(15)[None].repeat(2, 0)
    streams = np.stack([base, base // 2 + rng.integers(0, 3, (2, 15)),
                        base % 5 + rng.integers(0, 4, (2, 15))])
    n0 = (fa.flash_attention.launches, da.decode_attention.launches)
    worst = 0.0

    def forward(i):
        """Both sides' outputs of step ``i`` (-1: the prefill), with the
        routes each side took."""
        outs, routes = [], []
        span = slice(0, 12) if i < 0 else slice(12 + i, 13 + i)
        for (p, dev), c in zip(sides, caches):
            kw = {} if i < 0 else dict(mode="decode", caches=c,
                                       cache_len=12 + i)
            if pos3d:
                kw["pos3d"] = torch.as_tensor(streams[:, :, span],
                                              device=dev)
            with recording_routes() as seen:
                outs.append(tfm.lm_apply(
                    p, cfg, torch.as_tensor(toks[:, span], device=dev),
                    **kw))
            routes.append(seen)
        if len(routes[0]) != len(routes[1]) or not all(
                torch.equal(a, b.cpu()) for a, b in zip(*routes)):
            raise SmokeFailure(f"reduced {cfg.name}, step {i}: the card "
                               f"routed tokens to other experts than the "
                               f"CPU")
        return outs, routes[0]

    with torch.inference_mode():
        caches = [None, None]
        outs, routes = forward(-1)
        dropped = sum(dropped_assignments(ids, cfg) for ids in routes)
        n_routes = len(routes)
        caches = [eng._merge(eng.init_caches(None), o.caches)
                  for eng, o in zip(engines, outs)]
        for i in range(4):
            pairs = [(outs[0].logits, outs[1].logits)] + [
                (x, y) for ca, cb in zip(*caches) for x, y in zip(ca, cb)]
            for x, y in pairs:
                y = y.cpu()
                worst = max(worst, float((x - y).abs().max()))
                if not torch.allclose(x, y, rtol=1e-4, atol=1e-4):
                    raise SmokeFailure(
                        f"reduced {cfg.name}, step {i}: card differs from "
                        f"CPU by {float((x - y).abs().max())}")
            if i == 3:
                break
            outs, routes = forward(i)
            n_routes += len(routes)
            caches = [o.caches for o in outs]
    counts = (fa.flash_attention.launches - n0[0],
              da.decode_attention.launches - n0[1])
    n_attn = attention_layers(cfg)
    want = (n_attn, 3 * n_attn) if device.type == "cuda" else (0, 0)
    if counts != want:
        raise SmokeFailure(f"reduced {cfg.name} on the card launched "
                           f"flash_attention {counts[0]} and decode_attention "
                           f"{counts[1]} times, expected {want}")
    n_moe = sum(f == "moe" for _, f in cfg.layer_plan())
    if n_routes != 4 * n_moe:
        raise SmokeFailure(f"reduced {cfg.name}: {n_routes} routings in 4 "
                           f"forwards of {n_moe} MoE layers")
    moe_note = (f"; routed expert ids equal in all {n_routes} MoE calls, "
                f"capacity factor {cfg.capacity_factor}, prefill dropped "
                f"{dropped} assignments" if n_moe else "")
    n_mamba = sum(m == "mamba" for m, _ in cfg.layer_plan())
    kinds = (f"{n_attn} attention and {n_mamba} Mamba layers" if n_mamba
             else f"{n_attn} attention layers")
    say(f"  reduced {cfg.name} (hd {cfg.head_dim}, window "
        f"{cfg.sliding_window}, {kinds}"
        f"{', three distinct pos3d streams' if pos3d else ''}), card "
        f"(kernels) vs CPU (plain versions), prefill and 3 decode steps, "
        f"logits and caches: ok (max abs diff {worst:.3e}; launches "
        f"{counts}{moe_note})")
    return {"max_abs_diff": worst, "launches": list(counts),
            "moe_calls": n_routes, "prefill_dropped": dropped}


def dense_model_cpu_vs_card(device, arch: str) -> float:
    """Phase 14: ``arch``'s reduced float32 model on the card against the
    CPU (:func:`reduced_cpu_vs_card`).  Returns the largest difference."""
    from repro_torch.configs import get_reduced

    return reduced_cpu_vs_card(device, get_reduced(arch).replace(
        dtype="float32", attn_backend="kernel"))["max_abs_diff"]


def moe_model_cpu_vs_card(device, arch: str,
                          capacity_factor: float | None = None) -> dict:
    """Phase 18: ``arch``'s reduced float32 MoE model on the card against
    the CPU (:func:`reduced_cpu_vs_card`), routed ids equal in every layer
    and step; with ``capacity_factor`` the prefill must drop assignments,
    so the drop path runs on the card."""
    from repro_torch.configs import get_reduced

    cfg = get_reduced(arch).replace(dtype="float32", attn_backend="kernel")
    if capacity_factor is not None:
        cfg = cfg.replace(capacity_factor=capacity_factor)
    out = reduced_cpu_vs_card(device, cfg)
    if capacity_factor is not None and not out["prefill_dropped"]:
        raise SmokeFailure(f"reduced {arch} at capacity factor "
                           f"{capacity_factor} dropped nothing: the drop "
                           f"path did not run")
    return out


# Kinds of kernel in a dense model's graphs, by name fragments: cuBLAS's
# products (nvjet, gemm and split-k reduce kernels) and the two attention
# kernels.
KERNEL_KINDS = (("matmul (cuBLAS)", ("nvjet", "gemm", "cublas", "cutlass",
                                     "xmma")),
                ("flash_attention", ("flash_attention",)),
                ("decode_attention", ("decode_attention",)))


def device_breakdown(engine, kind: str, prompt_len: int,
                     reps: int = 3) -> dict:
    """Device time of one replay of the engine's ``kind`` ("prefill" or
    "decode") graph at its one level, by kind of kernel
    (:func:`graph_breakdown`)."""
    import torch

    step = engine.steps[(kind, None, prompt_len) if kind == "prefill"
                        else (kind, None)]
    with torch.inference_mode():
        engine._buffers[None].cache_len.fill_(prompt_len)
    return graph_breakdown(step.graph, reps)


def graph_breakdown(graph, reps: int = 3) -> dict:
    """Device time of one replay of ``graph`` by kind of kernel: the self
    device time of every kernel that ``torch.profiler`` (CUDA activity)
    records over ``reps`` replays, over ``reps``, in ms; kernels not
    named in ``KERNEL_KINDS`` (elementwise, reductions, copies,
    concatenations) are "other".  ``busy_ms`` is their sum: the replay's
    time less it is time the card spent between kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in KERNEL_KINDS}
    out["other"] = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if not us or ev.key.startswith(("aten::", "cuda")):
            continue
        kind_name = next((name for name, pats in KERNEL_KINDS
                          if any(p in ev.key for p in pats)), "other")
        out[kind_name] += us / reps / 1e3
    out = {k: v for k, v in out.items() if v}
    out["busy_ms"] = sum(out.values())
    return out


def moe_routing(engine, params, prompt_len: int) -> dict:
    """Where the served MoE model's tokens went, off the timed path: one
    eager prefill of the engine's last prompt and one eager decode step
    at the state the timed decode replays start from (``cache_len`` at
    ``prompt_len``, the engine's next tokens, copies of its caches),
    recording every layer's routed ids.  Returns the distinct experts each
    MoE layer's decode tokens were routed to, the bytes of every expert
    and of those routed to (expert sizes read from the first MoE layer: a
    hybrid's layer 0 is dense), the bytes a decode step reads when it
    reads only the routed experts (every other weight but the embedding
    table, as the one-hot dispatch reads them all), and the assignments
    the prefill dropped."""
    import torch

    from repro_torch.models import transformer as tfm

    cfg = engine.model.cfg
    buf = engine._buffers[None]
    with torch.inference_mode():
        with recording_routes() as pre:
            tfm.lm_apply(params, cfg, buf.prompts[prompt_len])
        caches = [type(c)(*(x.clone() for x in c)) for c in buf.caches]
        with recording_routes() as dec:
            tfm.lm_apply(params, cfg, buf.next_tok, mode="decode",
                         caches=caches, cache_len=prompt_len)
    experts = [int(ids.unique().numel()) for ids in dec]
    first = next(layer["ffn"] for layer, (_, f) in zip(
        params["layers"], cfg.layer_plan()) if f == "moe")
    per_expert = sum(first[n][0].numel()
                     for n in ("w_gate", "w_up", "w_down")) * \
        first["w_gate"].element_size()
    n_moe = sum(f == "moe" for _, f in cfg.layer_plan())
    read = sum(t.numel() * t.element_size() for t in param_tensors(params)) \
        - params["embed"].numel() * params["embed"].element_size()
    unread = sum(cfg.n_experts - n for n in experts) * per_expert
    return {"decode_routed_experts": experts,
            "decode_tokens": int(dec[0].shape[0]),
            "expert_bytes": n_moe * cfg.n_experts * per_expert,
            "routed_expert_bytes": sum(experts) * per_expert,
            "routed_read_bytes": read - unread,
            "routed_read_ms": (read - unread) / H100_HBM_BYTES_S * 1e3,
            "prefill_dropped": sum(dropped_assignments(ids, cfg)
                                   for ids in pre),
            "prefill_assignments": sum(ids.numel() for ids in pre)}


def mamba_share(device, cfg, params, fwd: dict, prompt_len: int = 8,
                batch: int = 4) -> dict:
    """Phase 22: the served model's first Mamba layer alone, at the served
    shapes (``batch`` rows, a decode step from a state and a
    ``prompt_len``-token prefill): the device time of the whole block and
    of its recurrence alone (``_ssm_scan``), each as calls captured in one
    CUDA graph, the block's kernel nodes (read from a graph of one call),
    and what the model's Mamba layers take of one graphed forward
    (``fwd``'s decode and prefill times) at that rate.  The recurrence is
    plain PyTorch, as the reference's ``lax.scan`` is XLA's."""
    import torch

    from repro_torch.models import mamba as mb

    plan = cfg.layer_plan()
    n_mamba = sum(m == "mamba" for m, _ in plan)
    p = params["layers"][next(i for i, (m, _) in enumerate(plan)
                              if m == "mamba")]["mixer"]
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    gen = torch.Generator(device=device).manual_seed(5)
    dtype = getattr(torch, cfg.dtype)

    def randn(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dt)

    state = mb.MambaState(randn(batch, di, ds),
                          randn(batch, cfg.mamba_d_conv - 1, di, dt=dtype))
    a = -torch.exp(p["a_log"])
    out = {"layers": n_mamba}
    with torch.inference_mode():
        for kind, s, calls in (("decode", 1, 24), ("prefill", prompt_len, 8)):
            x = randn(batch, s, cfg.d_model, dt=dtype)
            st = state if kind == "decode" else None
            delta = torch.rand((batch, s, di), generator=gen, device=device)
            xs = [randn(batch, s, n) for n in (ds, ds, di)]
            block = lambda: mb.mamba(p, x, cfg, state=st)
            scan = lambda: mb._ssm_scan(state.ssm, delta, *xs, a, s)
            out[f"{kind}_block_ms"] = graph_ms(block, calls=calls)
            out[f"{kind}_scan_ms"] = graph_ms(scan, calls=calls)
            out[f"{kind}_block_nodes"] = len(captured_kernels(block))
            out[f"{kind}_scan_nodes"] = len(captured_kernels(scan))
            for part in ("block", "scan"):
                out[f"{kind}_{part}_share"] = n_mamba * \
                    out[f"{kind}_{part}_ms"] / fwd[f"{kind}_ms"]
    say(f"  {cfg.name}: one Mamba layer alone (device time, calls in a "
        f"CUDA graph; B={batch}, d_inner {di}, d_state {ds}): decode step "
        f"{out['decode_block_ms']:.6f} ms ({out['decode_block_nodes']} "
        f"kernel nodes), its recurrence {out['decode_scan_ms']:.6f} ms "
        f"({out['decode_scan_nodes']} nodes); {prompt_len}-token prefill "
        f"{out['prefill_block_ms']:.6f} ms ({out['prefill_block_nodes']} "
        f"nodes), its recurrence {out['prefill_scan_ms']:.6f} ms "
        f"({out['prefill_scan_nodes']} nodes); x {n_mamba} layers: the "
        f"blocks {out['decode_block_share']:.4f} of a decode forward "
        f"(the recurrence {out['decode_scan_share']:.4f}), "
        f"{out['prefill_block_share']:.4f} of a prefill forward (the "
        f"recurrence {out['prefill_scan_share']:.4f})")
    return out


def serve_dense(device, cfg, floor_ms: float,
                breakdown: bool = False) -> dict:
    """Phases 15-17, 19, 20, 22, 23 and 27: ``cfg`` (a dense, MoE, hybrid
    or vision-language model without nesting, ``attn_backend="kernel"``,
    bf16, weights from a seed-0 generator on the card; the vision-language
    model served text-only, as the reference's engine serves it) behind
    the fleet server as phase 13 serves ``rwkv6-3b``, graphed and then
    eagerly; ``serve`` checks every tick's launches (``flash_attention``
    once per attention layer a prefill forward, ``decode_attention`` once
    per attention layer a decode forward, none in a Mamba layer,
    ``alert_select`` once per tick, ``nested_matmul`` and ``rwkv_scan``
    never).  Then the graphed engine against the eager one (tokens bitwise
    equal, each graph's kernel nodes equal to its counted launches), one
    graphed forward's device time beside the time to read the weights a
    decode step reads (all but the embedding table, of which it gathers B
    rows; for a MoE model that is every expert, as the one-hot dispatch
    reads them, and beside it the read of only the experts the step's
    tokens were routed to, :func:`moe_routing`) at 3.35 TB/s and beside
    its launch floor (kernel nodes x ``floor_ms``), for a hybrid model
    what its Mamba layers take of it (:func:`mamba_share`), with
    ``breakdown`` its
    device time by kind of kernel (:func:`device_breakdown`), and the peak
    ``torch.cuda.max_memory_allocated`` of the phase.  Frees the model
    before it returns."""
    import gc

    import torch

    say(f"  nvidia-smi: {nvidia_smi_line()}")
    torch.cuda.reset_peak_memory_stats(device)
    run = serve(device, cfg)
    run_e = serve(device, cfg, params=run["params"], graphs=False)
    graphs = engine_graphs_vs_eager(run["engine"], run["params"], 8, 4)
    fwd = forward_device_ms(run["engine"], run["params"], None, 8)
    if breakdown:
        fwd["breakdown"] = {kind: device_breakdown(run["engine"], kind, 8)
                            for kind in ("decode", "prefill")}
    params = run["params"]
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in param_tensors(params))
    read = weight_bytes - params["embed"].numel() * \
        params["embed"].element_size()
    fwd.update(decode_read_bytes=read,
               weight_read_ms=read / H100_HBM_BYTES_S * 1e3,
               decode_launch_floor_ms=fwd["decode_kernel_nodes"] * floor_ms,
               prefill_launch_floor_ms=fwd["prefill_kernel_nodes"]
               * floor_ms)
    if cfg.n_experts:
        fwd["moe"] = moe_routing(run["engine"], params, 8)
    peak = torch.cuda.max_memory_allocated(device)
    if any(m == "mamba" for m, _ in cfg.layer_plan()):
        fwd["mamba"] = mamba_share(device, cfg, params, fwd)
    say(f"  {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}) forward, "
        f"device time (one graph replay): decode {fwd['decode_ms']:.6f} ms "
        f"({fwd['decode_kernel_nodes']} kernel nodes, launch floor "
        f"{fwd['decode_launch_floor_ms']:.6f} ms), prefill "
        f"{fwd['prefill_ms']:.6f} ms ({fwd['prefill_kernel_nodes']} nodes); "
        f"a decode step reads {read / 1e9:.3f} GB of weights: "
        f"{fwd['weight_read_ms']:.6f} ms at 3.35 TB/s; "
        f"max_memory_allocated {peak / 1e9:.3f} GB")
    if cfg.n_experts:
        m = fwd["moe"]
        say(f"  {cfg.name} routing (eager, off the timed path): a decode "
            f"step's {m['decode_tokens']} tokens went to "
            f"{min(m['decode_routed_experts'])}-"
            f"{max(m['decode_routed_experts'])} of {cfg.n_experts} experts "
            f"a MoE layer; every expert is {m['expert_bytes'] / 1e9:.3f} GB "
            f"({m['expert_bytes'] / H100_HBM_BYTES_S * 1e3:.6f} ms at 3.35 "
            f"TB/s), the routed ones {m['routed_expert_bytes'] / 1e9:.3f} "
            f"GB; reading only those: "
            f"{m['routed_read_bytes'] / 1e9:.3f} GB, "
            f"{m['routed_read_ms']:.6f} ms at 3.35 TB/s (the one-hot "
            f"dispatch reads all: {read / 1e9:.3f} GB); the prefill dropped "
            f"{m['prefill_dropped']} of {m['prefill_assignments']} "
            f"assignments at capacity factor {cfg.capacity_factor}")
    for kind, parts in fwd.get("breakdown", {}).items():
        say(f"  {cfg.name} {kind} replay by kind of kernel (torch.profiler, "
            f"self device time, ms): "
            + ", ".join(f"{k} {v:.6f}" for k, v in parts.items()))
    say(f"  tick times (s), graphs / eager: "
        f"{[round(t, 4) for t in run['tick_s']]} / "
        f"{[round(t, 4) for t in run_e['tick_s']]}; profiled generate "
        f"latency at full power {run['server'].table.latency[0, -1]:.6f} / "
        f"{run_e['server'].table.latency[0, -1]:.6f} s")
    out = {"model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "counts": [run_counts(run),
                                               run_counts(run_e)],
           "tick_s": run["tick_s"], "eager_tick_s": run_e["tick_s"],
           "profiled_latency_s": float(run["server"].table.latency[0, -1]),
           "eager_profiled_latency_s": float(
               run_e["server"].table.latency[0, -1]),
           "forward_device_ms": fwd, "engine_graphs": graphs,
           "weight_bytes": weight_bytes, "max_memory_allocated_bytes": peak}
    del run, run_e, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_kernel_vs_ref(device, cfg, params, toks, prompt_len: int,
                     steps: int, pos3d=None, tol: float = 1e-4):
    """``cfg`` (float32) on the card with ``attn_backend="kernel"`` against
    ``attn_backend="ref"`` on the same ``params`` and ``toks [B, prompt_len
    + steps]``: a ``prompt_len``-token prefill, then ``steps`` decode
    steps, logits of every step and every layer's KV cache, within rtol =
    atol = ``tol``, through ``build_model``'s ``prefill`` and
    ``decode_step``.  ``pos3d [3, B, prompt_len + steps]`` (M-RoPE's
    streams) are sliced per forward when given.  Returns the worst
    differences by kind and the kernel run's prefill logits."""
    import torch

    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServeEngine

    batch = toks.shape[0]

    def inputs(span):
        out = {"tokens": toks[:, span]}
        if pos3d is not None:
            out["pos3d"] = pos3d[:, :, span]
        return out

    def run(c):
        model = build_model(c)
        eng = ServeEngine(model, max_len=prompt_len + steps,
                          batch_size=batch, device=device, graphs=False)
        logits, caches = model.prefill(params, inputs(slice(0, prompt_len)))
        out = [logits]
        caches = eng._merge(eng.init_caches(None), caches)
        for i in range(steps):
            j = prompt_len + i
            logits, caches = model.decode_step(params, {
                **inputs(slice(j, j + 1)), "cache_len": j}, caches)
            out.append(logits)
        return out, caches

    worst = {"prefill": 0.0, "decode": 0.0, "caches": 0.0}
    with torch.inference_mode():
        got, got_c = run(cfg.replace(attn_backend="kernel"))
        want, want_c = run(cfg.replace(attn_backend="ref"))
        pairs = [("prefill", got[0], want[0])] + [
            ("decode", a, b) for a, b in zip(got[1:], want[1:])] + [
            ("caches", x, y) for ca, cb in zip(got_c, want_c)
            for x, y in zip(ca, cb)]
        for what, a, b in pairs:
            diff = (a - b).abs()
            worst[what] = max(worst[what], float(diff.max()))
            if bool((diff > tol + tol * b.abs()).any()):
                raise SmokeFailure(f"{cfg.name} float32, kernel vs ref "
                                   f"{what}: max abs diff "
                                   f"{float(diff.max()):.3e} past rtol = atol"
                                   f" = {tol}")
    return worst, got[0]


def gemma_window_kernel_vs_ref(device, cfg=None, prompt_len: int = 1024,
                               steps: int = 4, batch: int = 2) -> dict:
    """Phase 16: ``gemma3-1b`` (``cfg``, default its full config) at full
    width and depth in float32 (weights from a seed-1 generator on the
    card): a ``prompt_len``-token prefill,
    then ``steps`` decode steps, with ``attn_backend="kernel"`` against
    ``attn_backend="ref"`` on the card, logits of every step and every
    layer's KV cache (:func:`lm_kernel_vs_ref`).  The 22 local layers'
    window of 512 masks half of the prompt's keys for its last rows and in
    every decode step.

    Tolerance rtol = atol = 1e-4, set from readings: the two runs share
    weights, tokens and every other operation (the same float32
    ``torch.matmul``, TF32 off); only the attention differs, the kernels
    against the ref backend's chunked softmax, and the worst difference
    read on an H100 over the logits and caches was 1.9e-5, which 1e-4
    holds with a margin of 5.  The tolerance must stay below what a
    fault at the window's edge moves: the same prefill with a window of
    ``sliding_window - 1`` (one key fewer in each row past the window)
    must move the logits by more than the tolerance, and with the window
    off by more than 10x it, or the check fails.
    """
    import gc

    import torch

    from repro_torch.configs.gemma3_1b import CONFIG
    from repro_torch.models import transformer as tfm

    tol = 1e-4
    cfg = (cfg or CONFIG).replace(dtype="float32")
    gen = torch.Generator(device=device).manual_seed(1)
    params = tfm.init_lm(cfg, gen, device=device)
    toks = torch.randint(0, cfg.vocab, (batch, prompt_len + steps),
                         generator=gen, device=device)
    worst, got = lm_kernel_vs_ref(device, cfg, params, toks, prompt_len,
                                  steps, tol=tol)
    moved = {}
    with torch.inference_mode():
        for what, window in (("edge", cfg.sliding_window - 1),
                             ("off", None)):
            other = tfm.lm_apply(params, cfg.replace(
                attn_backend="kernel", sliding_window=window),
                toks[:, :prompt_len]).logits
            moved[what] = float((other - got).abs().max())
        del other
    edge, bite = moved["edge"], moved["off"]
    if bite <= 10 * tol:
        raise SmokeFailure(f"{cfg.name}: the window off moved the prefill "
                           f"logits by {bite:.3e} only; the window did not "
                           f"bite")
    if edge <= tol:
        raise SmokeFailure(f"{cfg.name}: a window of "
                           f"{cfg.sliding_window - 1} moved the prefill "
                           f"logits by {edge:.3e}, within the tolerance "
                           f"{tol}: the check cannot see a fault at the "
                           f"window's edge")
    say(f"  {cfg.name} float32, {batch} x {prompt_len}-token prompt + {steps} "
        f"decode steps, attn_backend kernel vs ref on the card: max abs "
        f"diff prefill logits {worst['prefill']:.3e}, decode logits "
        f"{worst['decode']:.3e}, KV caches {worst['caches']:.3e} (rtol = "
        f"atol = {tol}); with a window of {cfg.sliding_window - 1} the "
        f"prefill logits move by {edge:.3e}, with the window off by "
        f"{bite:.3e}")
    del params, got
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {**worst, "window_edge_diff": edge, "window_off_diff": bite,
            "tolerance": tol,
            "shape": f"B={batch},prompt={prompt_len},decode={steps},float32"}


def image_streams(batch: int, text: int, grid: int, steps: int, device):
    """M-RoPE's ``[3, B, S]`` position streams of a prompt as qwen2-vl
    numbers it (arXiv:2409.12191 §2.1): ``text`` tokens (three equal
    streams 0..text-1), a ``grid`` x ``grid`` image of patches (temporal
    stream constant at ``text``, height and width streams ``text`` plus
    the patch's row and column), ``text`` more tokens, then ``steps``
    decode positions; text after the image continues from the largest
    position so far plus one.  S = 2 * text + grid**2 + steps."""
    import torch

    first = torch.arange(text).expand(3, text)
    r, c = torch.meshgrid(torch.arange(grid), torch.arange(grid),
                          indexing="ij")
    image = torch.stack([torch.full((grid * grid,), text),
                         text + r.reshape(-1), text + c.reshape(-1)])
    after = int(image.max()) + 1 + torch.arange(text + steps).expand(
        3, text + steps)
    one = torch.cat([first, image, after], dim=1)
    return one[:, None].expand(3, batch, one.shape[1]).to(device)


def mrope_kernel_vs_ref(device, cfg=None, text: int = 8, grid: int = 16,
                        steps: int = 3, batch: int = 2) -> dict:
    """Phase 28: ``qwen2-vl-2b`` (``cfg``, default its full config) at full
    width and depth in float32 (weights from a seed-2 generator on the
    card) with three distinct M-RoPE streams (:func:`image_streams`: a
    16 x 16-patch image between two 8-token texts, 272 prompt tokens),
    one prefill and ``steps`` decode steps through ``build_model`` with
    ``attn_backend="kernel"`` against ``"ref"`` on the card
    (:func:`lm_kernel_vs_ref`), within rtol = atol = 1e-4 as phase 16
    holds gemma3's window.  The same prefill with the streams made equal
    (text-only RoPE) must move the logits by more than 10x that, or the
    streams did not reach the attention."""
    import gc

    import torch

    from repro_torch.configs.qwen2_vl_2b import CONFIG
    from repro_torch.models import transformer as tfm

    tol = 1e-4
    cfg = (cfg or CONFIG).replace(dtype="float32")
    gen = torch.Generator(device=device).manual_seed(2)
    params = tfm.init_lm(cfg, gen, device=device)
    for layer in params["layers"]:
        for name in ("bq", "bk", "bv"):
            if name in layer["mixer"]:
                layer["mixer"][name].normal_(0.0, 0.5, generator=gen)
    pos3d = image_streams(batch, text, grid, steps, device)
    prompt_len = pos3d.shape[2] - steps
    toks = torch.randint(0, cfg.vocab, (batch, prompt_len + steps),
                         generator=gen, device=device)
    worst, got = lm_kernel_vs_ref(device, cfg, params, toks, prompt_len,
                                  steps, pos3d=pos3d, tol=tol)
    with torch.inference_mode():
        flat = tfm.lm_apply(params, cfg.replace(attn_backend="kernel"),
                            toks[:, :prompt_len]).logits
        moved = float((flat - got).abs().max())
    if moved <= 10 * tol:
        raise SmokeFailure(f"{cfg.name}: equal streams moved the prefill "
                           f"logits by {moved:.3e} only; the three streams "
                           f"did not reach the attention")
    say(f"  {cfg.name} float32, {batch} x {prompt_len}-token prompt ({text} "
        f"text, {grid}x{grid} image patches, {text} text; three distinct "
        f"pos3d streams) + {steps} decode steps, attn_backend kernel vs ref "
        f"on the card: max abs diff prefill logits {worst['prefill']:.3e}, "
        f"decode logits {worst['decode']:.3e}, KV caches "
        f"{worst['caches']:.3e} (rtol = atol = {tol}); text-only RoPE "
        f"moves the prefill logits by {moved:.3e}")
    del params, got, flat
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {**worst, "equal_streams_diff": moved, "tolerance": tol,
            "shape": f"B={batch},prompt={prompt_len},decode={steps},"
                     f"float32,pos3d"}


# --------------------------------------------------------------------- #
# phases 24-26: the encoder-decoder (whisper-tiny)                       #
# --------------------------------------------------------------------- #
WHISPER_FRAMES = 1500      # Whisper's 30-second window after its conv stem
WHISPER_SLOTS = 448        # Whisper's text context
# Whisper's start-of-transcript sequence: <|startoftranscript|> <|en|>
# <|transcribe|> <|notimestamps|>; rows 1 and 3 of the batch leave out
# <|notimestamps|> (3 tokens), so the batch is ragged and decodes at
# per-row lengths.
WHISPER_SOT = (50258, 50259, 50359, 50363)
WHISPER_ROWS = (4, 3, 4, 3)


def whisper_launches(cfg) -> tuple[int, int]:
    """(``flash_attention`` launches of a prefill forward,
    ``decode_attention`` launches of a decode forward) of an
    encoder-decoder on the ``kernel`` backend: each encoder layer's
    self-attention and each decoder layer's self- and cross-attention
    in prefill; each decoder layer's self- and cross-attention in
    decode."""
    return cfg.encoder_layers + 2 * cfg.n_layers, 2 * cfg.n_layers


def whisper_decode_caches(cfg, prefill_caches, slots: int, device) -> dict:
    """Decode caches after a prefill: the prompt's self k/v in front of
    zeroed ``slots``-slot buffers, the cross k/v as the prefill made
    them."""
    from repro_torch.models.whisper import init_decoder_caches

    self_c = init_decoder_caches(cfg, prefill_caches["cross"][0].k.shape[0],
                                 slots, device=device)
    for buf, new in zip(self_c, prefill_caches["self"]):
        n = new.k.shape[1]
        buf.k[:, :n].copy_(new.k)
        buf.v[:, :n].copy_(new.v)
    return {"self": self_c, "cross": prefill_caches["cross"]}


def whisper_run(model, params, frames, toks, prompt_len: int, rows,
                steps: int, device) -> list:
    """``build_model``'s prefill of ``frames`` and ``toks[:, :prompt_len]``,
    then ``steps`` decode steps of ``toks`` at per-row lengths ``rows +
    i`` (a ``[B]`` tensor): every output in order, the prefill's logits,
    self k/v and cross k/v, then each step's logits and self caches."""
    import torch

    cfg = model.cfg
    logits, c = model.prefill(params, {"frames": frames,
                                       "tokens": toks[:, :prompt_len]})
    outs = [logits] + [x for kv in c["self"] + c["cross"] for x in kv]
    caches = whisper_decode_caches(cfg, c, prompt_len + steps, device)
    lens = torch.as_tensor(rows, dtype=torch.int32, device=device)
    for i in range(steps):
        j = prompt_len + i
        logits, caches = model.decode_step(params, {
            "tokens": toks[:, j:j + 1], "cache_len": lens + i}, caches)
        outs += [logits] + [x for kv in caches["self"] for x in kv]
    return outs


def whisper_cpu_vs_card(device, frames: int = 45, prompt_len: int = 12,
                        steps: int = 3) -> dict:
    """Phase 24: reduced float32 ``whisper-tiny`` with
    ``attn_backend="kernel"`` and the same weights on the card (the
    kernels) and on the CPU (their plain versions): ``frames`` encoder
    frames, a ``prompt_len``-token prompt, then ``steps`` decode steps at
    per-row lengths (the second row two positions behind), prefill
    logits, self caches and cross k/v, then each step's logits and self
    caches, within 1e-4 (float32, TF32 off; the card sums in another
    order), as phase 14.  The card must launch ``flash_attention`` once
    per encoder layer and twice per decoder layer in the prefill, and
    ``decode_attention`` twice per decoder layer a step.  Returns the
    largest difference and the launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import build_model
    from repro_torch.models.whisper import init_encdec

    cfg = get_reduced("whisper-tiny").replace(dtype="float32",
                                              attn_backend="kernel")
    cpu = torch.device("cpu")
    params = init_encdec(cfg, torch.Generator().manual_seed(0), device=cpu)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (2, prompt_len + steps))
    rows = [prompt_len, prompt_len - 2]
    model = build_model(cfg)
    n0 = (fa.flash_attention.launches, da.decode_attention.launches)
    with torch.inference_mode():
        want = whisper_run(model, params, torch.as_tensor(x),
                           torch.as_tensor(toks), prompt_len, rows, steps,
                           cpu)
        got = whisper_run(model, copy_params(params, device),
                          torch.as_tensor(x, device=device),
                          torch.as_tensor(toks, device=device), prompt_len,
                          rows, steps, device)
    worst = 0.0
    for a, b in zip(want, got):
        b = b.cpu()
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            raise SmokeFailure(f"reduced {cfg.name}: card differs from CPU "
                               f"by {float((a - b).abs().max())}")
    counts = (fa.flash_attention.launches - n0[0],
              da.decode_attention.launches - n0[1])
    per_prefill, per_step = whisper_launches(cfg)
    want_counts = ((per_prefill, steps * per_step) if device.type == "cuda"
                   else (0, 0))
    if counts != want_counts:
        raise SmokeFailure(f"reduced {cfg.name} on the card launched "
                           f"flash_attention {counts[0]} and "
                           f"decode_attention {counts[1]} times, expected "
                           f"{want_counts}")
    say(f"  reduced {cfg.name} ({cfg.encoder_layers} encoder + "
        f"{cfg.n_layers} decoder layers, hd {cfg.head_dim}, {frames} "
        f"frames), card (kernels) vs CPU (plain versions), prefill and "
        f"{steps} decode steps at per-row lengths, logits, self caches and "
        f"cross k/v: ok (max abs diff {worst:.3e}; launches {counts})")
    return {"max_abs_diff": worst, "launches": list(counts)}


def whisper_kernel_vs_ref(device, cfg=None, frames: int = WHISPER_FRAMES,
                          steps: int = 4, tol: float = 1e-4) -> dict:
    """Phase 25: ``whisper-tiny`` (``cfg``, default its full config: 4
    encoder and 4 decoder layers, d 384) in float32 on the card (weights
    and frames from a seed-1 generator there), B=4 rows of ``frames``
    frames and the start-of-transcript prompt (``WHISPER_ROWS`` tokens a
    row), then ``steps`` decode steps at per-row lengths, with
    ``attn_backend="kernel"`` against ``"ref"``: every output of
    :func:`whisper_run` within rtol = atol = ``tol`` = 1e-4, as phase 16
    holds gemma3's window (the runs differ only in the attention; the
    encoder's 1500 frames are 24 key tiles, the last one ragged)."""
    import gc

    import torch

    from repro_torch.configs.whisper_tiny import CONFIG
    from repro_torch.models.registry import build_model
    from repro_torch.models.whisper import init_encdec

    cfg = (cfg or CONFIG).replace(dtype="float32")
    gen = torch.Generator(device=device).manual_seed(1)
    params = init_encdec(cfg, gen, device=device)
    x = torch.randn((len(WHISPER_ROWS), frames, cfg.d_model), generator=gen,
                    device=device)
    prompt_len = max(WHISPER_ROWS)
    toks = torch.randint(0, cfg.vocab, (len(WHISPER_ROWS),
                                        prompt_len + steps), generator=gen,
                         device=device)
    toks[:, :prompt_len] = torch.tensor(WHISPER_SOT) % cfg.vocab
    with torch.inference_mode():
        got, want = (whisper_run(build_model(cfg.replace(attn_backend=b)),
                                 params, x, toks, prompt_len, WHISPER_ROWS,
                                 steps, device) for b in ("kernel", "ref"))
        n_self = 2 * cfg.n_layers
        kinds = (["prefill"] + ["caches"] * n_self + ["cross"] * n_self
                 + (["decode"] + ["caches"] * n_self) * steps)
        worst = dict.fromkeys(("prefill", "decode", "caches", "cross"), 0.0)
        for what, a, b in zip(kinds, got, want):
            diff = (a - b).abs()
            worst[what] = max(worst[what], float(diff.max()))
            if bool((diff > tol + tol * b.abs()).any()):
                raise SmokeFailure(f"{cfg.name} float32, kernel vs ref "
                                   f"{what}: max abs diff "
                                   f"{float(diff.max()):.3e} past rtol = atol"
                                   f" = {tol}")
    say(f"  {cfg.name} float32, B={len(WHISPER_ROWS)}, {frames} frames, "
        f"prompt rows {list(WHISPER_ROWS)} + {steps} decode steps at per-row "
        f"lengths, attn_backend kernel vs ref on the card: max abs diff "
        f"prefill logits {worst['prefill']:.3e}, decode logits "
        f"{worst['decode']:.3e}, self caches {worst['caches']:.3e}, cross "
        f"k/v {worst['cross']:.3e} (rtol = atol = {tol})")
    del params, got, want
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {**worst, "tolerance": tol,
            "shape": f"B={len(WHISPER_ROWS)},T={frames},"
                     f"prompt={list(WHISPER_ROWS)},decode={steps},float32"}


def whisper_serve(device, cfg=None, frames: int = WHISPER_FRAMES,
                  slots: int = WHISPER_SLOTS, steps: int = 16,
                  floor_ms: float = 0.0, breakdown: bool = False) -> dict:
    """Phase 26: ``whisper-tiny`` (``cfg``, default its full config) in bf16
    with ``attn_backend="kernel"``, weights and frames from a seed-0
    generator on the card: B=4 rows of ``frames`` frames with the
    start-of-transcript prompt (``WHISPER_ROWS`` tokens a row), greedy
    decode for ``steps`` steps over a ``slots``-slot self cache, as two
    steps over static buffers (the frames, the prompt, the self caches,
    the cross k/v of one request, the next token and a ``[B]`` int32
    ``cache_len`` on the device):

    * prefill: encoder, cross k/v, decoder prefill; the prompt's k/v into
      the front of the self caches (the tail zeroed), the cross k/v into
      their buffers, each row's argmax at its last prompt position,
      ``cache_len`` set to the rows' lengths;
    * decode: one ``decode_step`` at ``cache_len``, the argmax, ``cache_len
      + 1``, all on the device.

    On the card each step is captured as a CUDA graph (``Step``, as the
    serving engine captures its steps; a host read in either would fail
    the capture) and replayed; the same steps run eagerly after, on the
    same buffers.  Every launch counter starts at 0 before each of the
    two runs and is read after it (the main path): ``flash_attention``
    ``whisper_launches(cfg)[0]`` times (12) and ``decode_attention``
    ``steps`` x ``whisper_launches(cfg)[1]`` times (8 a step), the other
    kernels never.  Tokens of the two runs must be bitwise equal, and each
    graph's kernel nodes must equal its counted launches.  Then (card
    only) the device time of one prefill and one decode replay (CUDA
    events, the median of 20) beside the decode step's reads and its
    launch floor (kernel nodes x ``floor_ms``), ``max_memory_allocated``,
    and the attention kernels at the model's shapes, timed against
    ``scaled_dot_product_attention`` and the bound (:func:`flash_case`,
    :func:`decode_case`); with ``breakdown``, each replay's device time
    by kind of kernel (:func:`graph_breakdown`).  Frees the model before
    it returns."""
    import gc

    import torch

    from repro_torch.configs.whisper_tiny import CONFIG
    from repro_torch.kernels import alert_select as ks
    from repro_torch.models.attention import KVCache
    from repro_torch.models.registry import build_model
    from repro_torch.models.whisper import init_decoder_caches, init_encdec
    from repro_torch.serving.engine import COUNTED, Step

    cfg = (cfg or CONFIG).replace(attn_backend="kernel")
    card = device.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    say(f"  nvidia-smi: {nvidia_smi_line()}" if card else "  (CPU)")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_encdec(cfg, gen, device=device)
    model = build_model(cfg)
    dtype = getattr(torch, cfg.dtype)
    b, s0 = len(WHISPER_ROWS), max(WHISPER_ROWS)
    kv_shape = (b, frames, cfg.n_kv_heads, cfg.head_dim)
    x = torch.randn((b, frames, cfg.d_model), generator=gen,
                    device=device).to(dtype)
    prompt = (torch.tensor(WHISPER_SOT, device=device) % cfg.vocab).expand(
        b, s0).contiguous()
    rows = torch.tensor(WHISPER_ROWS, dtype=torch.int32, device=device)
    self_c = init_decoder_caches(cfg, b, slots, device=device)
    cross = [KVCache(torch.zeros(kv_shape, dtype=dtype, device=device),
                     torch.zeros(kv_shape, dtype=dtype, device=device))
             for _ in range(cfg.n_layers)]
    next_tok = torch.zeros((b, 1), dtype=torch.long, device=device)
    cache_len = torch.zeros(b, dtype=torch.int32, device=device)
    last = (rows.long() - 1).view(b, 1, 1)

    def prefill():
        logits, c = model.prefill(params, {"frames": x, "tokens": prompt})
        for buf, new in zip(self_c, c["self"]):
            for dst, src in zip(buf, new):
                dst[:, :s0].copy_(src)
                dst[:, s0:].zero_()
        for buf, new in zip(cross, c["cross"]):
            for dst, src in zip(buf, new):
                dst.copy_(src)
        at_last = logits.gather(1, last.expand(b, 1, logits.shape[2]))
        next_tok.copy_(torch.argmax(at_last, dim=-1))
        cache_len.copy_(rows)

    def decode():
        logits, _ = model.decode_step(params, {
            "tokens": next_tok, "cache_len": cache_len},
            {"self": self_c, "cross": cross})
        next_tok.copy_(torch.argmax(logits[:, -1:], dim=-1))
        cache_len.add_(1)

    counters = (ks.alert_select,) + COUNTED

    def generate(pre, dec) -> tuple:
        for w in counters:               # main path starts here
            w.launches = 0
        with torch.inference_mode():
            pre()
            toks = [next_tok.clone()]
            for _ in range(steps):
                dec()
                toks.append(next_tok.clone())
            out = torch.cat(toks, dim=1).cpu()
        counts = {w.__name__: w.launches for w in counters}
        return out, counts                # main path ends here

    with torch.inference_mode():
        graphed = (Step(prefill, device, card), Step(decode, device, card))
        eager = (Step(prefill, device, False), Step(decode, device, False))
    got, counts = generate(*graphed)
    want, counts_e = generate(*eager)
    if not torch.equal(got, want):
        raise SmokeFailure(f"{cfg.name}: graphed tokens {got.tolist()} != "
                           f"eager {want.tolist()}")
    if int(got.min()) < 0 or int(got.max()) >= cfg.vocab:
        raise SmokeFailure(f"{cfg.name}: tokens out of range")
    per_prefill, per_step = whisper_launches(cfg)
    want_counts = {w.__name__: 0 for w in counters}
    if card:
        want_counts.update(flash_attention=per_prefill,
                           decode_attention=steps * per_step)
    for name, c in (("graphed", counts), ("eager", counts_e)):
        if c != want_counts:
            raise SmokeFailure(f"{cfg.name} {name}: launches {c}, expected "
                               f"{want_counts}")
    out = {"model": cfg.name, "counts": [counts, counts_e],
           "tokens": got.tolist(), "shape":
               f"B={b},T={frames},prompt={list(WHISPER_ROWS)},"
               f"slots={slots},decode={steps},{cfg.dtype}"}
    say(f"  {cfg.name} ({cfg.encoder_layers} encoder + {cfg.n_layers} "
        f"decoder layers, d={cfg.d_model}, {cfg.dtype}), B={b}, {frames} "
        f"frames, prompt rows {list(WHISPER_ROWS)}, {steps} decode steps "
        f"over {slots} slots: graphed tokens bitwise equal to eager ones; "
        f"launches a run {counts}")
    if card:
        steps_by_kind = (("prefill", graphed[0]), ("decode", graphed[1]))
        nodes = {kind: check_step_nodes(step, f"{cfg.name} {kind}")
                 for kind, step in steps_by_kind}
        times = {kind: replay_ms(step.graph,
                                 lambda: cache_len.copy_(rows + 8))
                 for kind, step in steps_by_kind}

        def nbytes(tensors):
            return sum(t.numel() * t.element_size() for t in tensors)

        # a decode step reads the decoder's weights but the cross wk/wv
        # (which made the cross k/v), the final norm, unembed, and the
        # cross k/v; not the encoder, nor the embedding table (B rows)
        dec = nbytes(param_tensors([params["final_norm"],
                                    params["unembed"]] + [
            {k: w for k, w in lp.items() if k != "cross"}
            for lp in params["decoder"]] + [
            {k: w for k, w in lp["cross"].items() if k not in ("wk", "wv")}
            for lp in params["decoder"]]))
        cross_bytes = nbytes(t for kv in cross for t in kv)
        read = dec + cross_bytes
        peak = torch.cuda.max_memory_allocated(device)
        out.update(prefill_ms=times["prefill"], decode_ms=times["decode"],
                   prefill_kernel_nodes=nodes["prefill"],
                   decode_kernel_nodes=nodes["decode"],
                   graph_launches={"prefill": graphed[0].launches,
                                   "decode": graphed[1].launches},
                   decode_read_bytes=read, cross_kv_bytes=cross_bytes,
                   decode_read_ms=read / H100_HBM_BYTES_S * 1e3,
                   decode_launch_floor_ms=nodes["decode"] * floor_ms,
                   max_memory_allocated_bytes=peak)
        say(f"  {cfg.name} device time (CUDA events around one graph "
            f"replay): prefill (encoder, cross k/v, decoder prefill) "
            f"{times['prefill']:.6f} ms ({nodes['prefill']} kernel nodes, "
            f"flash_attention {graphed[0].launches[1]} of them), decode "
            f"step {times['decode']:.6f} ms ({nodes['decode']} kernel "
            f"nodes, launch floor {nodes['decode'] * floor_ms:.6f} ms; "
            f"decode_attention {graphed[1].launches[2]}); a decode step "
            f"reads {read / 1e6:.3f} MB (decoder weights and unembed "
            f"{dec / 1e6:.3f} MB, cross k/v {cross_bytes / 1e6:.3f} MB): "
            f"{out['decode_read_ms']:.6f} ms at 3.35 TB/s; "
            f"max_memory_allocated {peak / 1e9:.3f} GB")
        if breakdown:
            out["breakdown"] = {}
            for kind, step in steps_by_kind:
                with torch.inference_mode():
                    cache_len.copy_(rows + 8)
                parts = out["breakdown"][kind] = graph_breakdown(step.graph)
                say(f"  {cfg.name} {kind} replay by kind of kernel "
                    f"(torch.profiler, self device time, ms): "
                    + ", ".join(f"{k} {v:.6f}" for k, v in parts.items()))
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        final = [r + steps for r in WHISPER_ROWS]
        out["fa"] = {
            "whisper_encoder": flash_case(device, "whisper encoder", b,
                                          frames, h, kv, hd, causal=False,
                                          timed=True),
            "whisper_cross_prefill": flash_case(
                device, "whisper cross prefill", b, s0, h, kv, hd,
                t=frames, causal=False, timed=True),
            "whisper_decoder_self": flash_case(
                device, "whisper decoder self", b, s0, h, kv, hd,
                timed=True)}
        out["da"] = {
            "whisper_cross_decode": decode_case(
                device, "whisper cross decode", b, frames, h, kv, hd,
                frames, timed=True),
            "whisper_self_rows": decode_case(
                device, "whisper self decode", b, slots, h, kv, hd, final,
                timed=True)}
    del params, graphed, eager, self_c, cross, x
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# phases 29-30: the fleet simulator                                      #
# --------------------------------------------------------------------- #
SCHEMES = ("alert", "alert_plus", "alert_trad", "alert_dnn", "alert_power",
           "oracle", "oracle_static")
# Phase 30: the fleet's lanes (phase 3's S), the streams held to the CPU
# (every FLEET_CHECK-th), the ticks whose delivery inputs are recorded,
# and the repeats of each timed piece.
FLEET_LANES = 65536
FLEET_CHECK = 256
FLEET_RECORDED = 16
FLEET_REPS = 20
# The ticks of phase 30's run traced by torch.profiler for the card's busy
# time: FLEET_PROFILED ticks from the middle.
FLEET_PROFILED = 5


def counted_run(fn, runs: list):
    """Run ``fn`` with every launch counter at 0 and append the launches
    it counted, by kernel, to ``runs``."""
    from repro_torch.kernels import alert_select as ks
    from repro_torch.serving.engine import COUNTED

    counters = (ks.alert_select,) + COUNTED
    for w in counters:                    # main path starts here
        w.launches = 0
    out = fn()
    runs.append({w.__name__: w.launches for w in counters})
    return out                            # main path ends here


def same_result(got, want, fields, what: str) -> None:
    """Fails unless every field of ``got`` is bitwise equal to ``want``'s
    (None equal to None)."""
    import numpy as np

    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if (a is None) != (b is None) or (
                a is not None and not np.array_equal(a, b)):
            raise SmokeFailure(f"{what}: {f} differs")


def fleet_goldens(device, golden_path=None) -> dict:
    """Phase 29: the golden scenario on ``device``.  ``FleetSim`` on each
    of the three seed-1 traces must give ``tests/golden_traces.json``'s
    alert numbers exactly, launching ``alert_select`` once a tick on the
    card, and ``InferenceSim.run_oracle`` its oracle numbers to rtol 1e-9,
    atol 1e-12.  Then every scheme on the memory trace under both goals,
    on ``device`` and on the CPU: the results must be bitwise equal."""
    import torch

    from repro_torch.core.controller import Constraints, Goal
    from repro_torch.serving.scenarios import (GOLDEN_BUDGET_W, GOLDEN_SEED,
                                               golden_deadline, golden_table)
    from repro_torch.serving.sim import (ENVS, EnvironmentTrace, FleetSim,
                                         InferenceSim)

    path = Path(golden_path or ROOT / "tests" / "golden_traces.json")
    golden = json.loads(path.read_text())
    table = golden_table()
    deadline = float(golden_deadline(table, 3)[1])
    cons = Constraints.from_power_budget(deadline, GOLDEN_BUDGET_W)
    card = device.type == "cuda"
    runs, out = [], {}
    for env in ("default", "cpu", "memory"):
        trace = EnvironmentTrace(ENVS[env], seed=GOLDEN_SEED)
        t0 = time.perf_counter()
        res = counted_run(lambda: FleetSim(table, [trace], device=device)
                          .run_alert(Goal.MAXIMIZE_ACCURACY, cons), runs)
        secs = time.perf_counter() - t0
        got = {k: getattr(res, k)
               for k in ("mean_energy", "mean_error", "miss_rate")}
        if got != golden["envs"][env]["alert"]:
            raise SmokeFailure(f"golden {env}/alert: {got} != "
                               f"{golden['envs'][env]['alert']}")
        n_sel = runs[-1]["alert_select"]
        if n_sel != (trace.n if card else 0):
            raise SmokeFailure(f"golden {env}: alert_select launched "
                               f"{n_sel} times over {trace.n} ticks")
        oracle = InferenceSim(table, trace, device=device).run_oracle(
            Goal.MAXIMIZE_ACCURACY, cons)
        for key, want in golden["envs"][env]["oracle"].items():
            have = getattr(oracle, key)
            if not abs(have - want) <= 1e-12 + 1e-9 * abs(want):
                raise SmokeFailure(f"golden {env}/oracle/{key}: {have} "
                                   f"!= {want}")
        out[env] = {**got, "ticks": trace.n, "alert_select": n_sel,
                    "seconds": secs}
        say(f"  golden {env}: alert {got} equal to the fixture, "
            f"alert_select launched {n_sel} times in {trace.n} ticks "
            f"({secs:.3f} s); oracle within rtol 1e-9")
    trace = EnvironmentTrace(ENVS["memory"], seed=GOLDEN_SEED)
    goals = {Goal.MINIMIZE_ENERGY: Constraints(deadline=deadline,
                                               accuracy_goal=0.8),
             Goal.MAXIMIZE_ACCURACY: cons}
    cpu = torch.device("cpu")
    fields = ("energy", "accuracy", "latency", "missed", "budget",
              "config")
    for goal, c in goals.items():
        for scheme in SCHEMES:
            got = counted_run(lambda: InferenceSim(
                table, trace, device=device).run_scheme(scheme, goal, c),
                runs)
            want = InferenceSim(table, trace, device=cpu).run_scheme(
                scheme, goal, c)
            same_result(got, want, fields, f"{scheme} {goal.value}")
            adaptive = scheme.startswith("alert")
            n_sel = runs[-1]["alert_select"]
            if n_sel != (trace.n if card and adaptive else 0):
                raise SmokeFailure(f"{scheme} {goal.value}: alert_select "
                                   f"launched {n_sel} times")
    say(f"  {len(SCHEMES)} schemes x 2 goals on the memory trace: "
        f"{device.type} bitwise equal to the CPU")
    out["counts"] = runs
    return out


class FleetRecorder:
    """Reads a ``FleetSim`` or ``SessionGateway`` run from outside: while
    active it wraps the names ``module`` looks up (the engine class,
    ``deliver_tick``, ``observe_fleet``, the goal bank class; by default in
    ``repro_torch.serving.sim``, and ``repro_torch.traffic.gateway`` looks
    up the same four) so that each ``select`` notes its start time, and
    the ticks (a gateway's served rounds) in ``record`` keep their
    delivery inputs, and tick ``mid`` its select arguments and its
    feedback objects.  The ticks of ``profiled`` (a range, on the card)
    run under ``torch.profiler``: ``window_s`` is their host time, from the
    first one's ``select`` to the card's end of the last.  Neither class
    is changed."""

    def __init__(self, record, mid: int, profiled=range(0), module=None):
        self.record, self.mid, self.profiled = set(record), mid, profiled
        self.module = module
        self.stamps, self.inputs = [], {}
        self.engine = self.select_args = self.feedback = None
        self.bank = self.delivered = self.prof = self.window_s = None

    def _profile(self, n: int) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if not self.profiled or n not in (self.profiled.start,
                                          self.profiled.stop):
            return
        torch.cuda.synchronize()
        if n == self.profiled.start:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        else:
            self.window_s = time.perf_counter() - self.stamps[
                self.profiled.start]
            self.prof.__exit__(None, None, None)

    def __enter__(self):
        from repro_torch.serving import sim

        sim = self.module or sim
        rec = self
        saved = {n: getattr(sim, n) for n in (
            "BatchedAlertEngine", "deliver_tick", "observe_fleet",
            "WindowedGoalBank")}
        self._saved = saved

        class Engine(saved["BatchedAlertEngine"]):
            def select(self, *args, **kw):
                n = len(rec.stamps)
                if n == rec.mid:
                    rec.engine, rec.select_args = self, (args, kw)
                rec._profile(n)
                rec.stamps.append(time.perf_counter())
                return super().select(*args, **kw)

        class Bank(saved["WindowedGoalBank"]):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                rec.bank = self

        def deliver(table, st, i_glob, j_act, scale, dvec, *rest):
            n = len(rec.stamps) - 1
            if n in rec.record:
                rec.inputs[n] = tuple(x.copy() for x in (
                    i_glob, j_act, scale, dvec, rest[-1]))
            d = saved["deliver_tick"](table, st, i_glob, j_act, scale, dvec,
                                      *rest)
            if n == rec.mid:
                rec.delivered = (d, rest, scale, dvec, i_glob, j_act)
            return d

        def observe(slow, idle, *args, **kw):
            if len(rec.stamps) - 1 == rec.mid:
                rec.feedback = (slow, idle, args, kw)
            return saved["observe_fleet"](slow, idle, *args, **kw)

        sim.BatchedAlertEngine, sim.WindowedGoalBank = Engine, Bank
        sim.deliver_tick, sim.observe_fleet = deliver, observe
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import sim

        for name, obj in self._saved.items():
            setattr(self.module or sim, name, obj)
        return False

    def device_split(self) -> dict:
        """The profiled ticks' device work, a tick: busy ms (every kernel
        and copy), ``alert_select``'s ms, the other kernels' ms and count,
        the copies' ms and count; ``host_ms``, the window's host time a
        tick, and ``idle_share``, the share of it the card was not busy.
        Empty where the profiler recorded no device time."""
        ticks = len(self.profiled)
        out = {k: v / ticks for k, v in device_time(self.prof).items()}
        if not out["busy_ms"]:
            return {}
        out["host_ms"] = self.window_s * 1e3 / ticks
        out["idle_share"] = 1.0 - out["busy_ms"] / out["host_ms"]
        return out


def device_time(*profs) -> dict:
    """The device work ``torch.profiler`` recorded in ``profs``:
    ``alert_select``'s ms, the other kernels' ms and count, the copies' ms
    and count, and ``busy_ms``, their sum."""
    out = {"select_ms": 0.0, "kernels_ms": 0.0, "kernels": 0,
           "copies_ms": 0.0, "copies": 0}
    for prof in profs:
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            if not us or ev.key.startswith(("aten::", "cuda")):
                continue
            if "alert_select" in ev.key:
                out["select_ms"] += us / 1e3
            elif ev.key.startswith(("Memcpy", "Memset")):
                out["copies_ms"] += us / 1e3
                out["copies"] += ev.count
            else:
                out["kernels_ms"] += us / 1e3
                out["kernels"] += ev.count
    out["busy_ms"] = out["select_ms"] + out["kernels_ms"] + out["copies_ms"]
    return out


def sync_ms(fn, sync, reps: int = FLEET_REPS) -> float:
    """Median host time of ``fn`` with ``sync`` before and after each
    call (one untimed call first)."""
    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fleet_full(device, lanes: int = FLEET_LANES,
               check_every: int = FLEET_CHECK) -> dict:
    """Phase 30: ``run_fleet`` over ``lanes`` churning streams
    (:func:`fleet_specs`) on ``device``.  ``alert_select`` must launch
    once a tick on the card; every ``check_every``-th stream, run again on
    the CPU as a fleet of its own, must give rows bitwise equal to the
    card's; ``deliver_step`` on the device must be bitwise equal to
    ``deliver_tick`` on ``FLEET_RECORDED`` recorded ticks; at one mid-run
    tick's inputs, ``select`` on the device must be bitwise equal to a CPU
    engine's over every lane.  Prints the run's seconds, the median tick,
    the card's busy time a tick over ``FLEET_PROFILED`` ticks of the run
    (``torch.profiler``) and, at the mid-run tick's inputs, the medians of
    ``select``, ``deliver_tick``, ``deliver_step`` and the feedback step
    (``observe_fleet``, ``record``, ``current_goal``)."""
    import numpy as np
    import torch

    from repro_torch.serving import sim
    from repro_torch.serving.scenarios import fleet_specs, golden_table

    card = device.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    table = golden_table()
    t0 = time.perf_counter()
    specs = fleet_specs(table, lanes)
    trace_s = time.perf_counter() - t0
    n_ticks = max(sp.arrival + sp.trace.n for sp in specs)
    mid = n_ticks // 2
    record = np.linspace(0, n_ticks - 1, FLEET_RECORDED).astype(int)
    profiled = range(mid + 1, mid + 1 + FLEET_PROFILED) if card else range(0)
    runs = []
    with FleetRecorder(record, mid, profiled) as rec:
        t0 = time.perf_counter()
        res = counted_run(lambda: sim.run_fleet(table, specs, device=device),
                          runs)
        run_s = time.perf_counter() - t0
    n_sel = runs[-1]["alert_select"]
    if n_sel != (n_ticks if card else 0) or len(rec.stamps) != n_ticks:
        raise SmokeFailure(f"fleet: alert_select launched {n_sel} times, "
                           f"{len(rec.stamps)} selects, in {n_ticks} ticks")
    for f in ("energy", "accuracy", "latency"):
        x = getattr(res, f)
        if x.shape != (lanes, n_ticks) or not np.isfinite(x).all():
            raise SmokeFailure(f"fleet: {f} is not finite [S, T]")
    if res.active.sum() != sum(sp.trace.n for sp in specs):
        raise SmokeFailure("fleet: live cells do not add up to the traces")
    ticks_s = t0 + run_s - rec.stamps[0]
    # Tick n lasts from its select to the next; the profiled ticks and the
    # one before them (which starts the profiler) are left out.
    tick_ms = [(b - a) * 1e3 for n, (a, b) in enumerate(
        zip(rec.stamps, rec.stamps[1:])) if n + 1 not in profiled
        and n not in profiled]

    # Check 2: one stream of every check_every, as a CPU fleet of its own:
    # the first of each block, or the second in every other block, so that
    # Eq. 4 (even) and Eq. 5 (odd) lanes are both held.
    blocks = np.arange(0, lanes, check_every)
    lanes_chk = blocks + np.arange(len(blocks)) % 2
    sub = sim.run_fleet(table, [specs[s] for s in lanes_chk],
                        device=torch.device("cpu"))
    t_sub = sub.energy.shape[1]
    for f in ("energy", "accuracy", "latency", "missed", "budget",
              "active"):
        rows = getattr(res, f)[lanes_chk]
        # Past the sub-fleet's last tick every lane is dead: zero, but for
        # the budget grid, which holds E_goal there.
        tail_ok = f == "budget" or not rows[:, t_sub:].any()
        if not (np.array_equal(rows[:, :t_sub], getattr(sub, f))
                and tail_ok):
            raise SmokeFailure(f"fleet: lanes one in {check_every} differ "
                               f"from their CPU run in {f}")

    # Check 3: deliver_step on the device against deliver_tick.
    st = table.staircase_tensors()
    consts = dict(latency_kl=table.latency, run_power_kl=table.run_power,
                  q_fail=table.q_fail, lvl_lat_kml=st.lvl_lat,
                  lvl_valid_km=st.lvl_valid, lvl_acc_km=st.lvl_acc)
    is_any = np.zeros(len(table.candidates), bool)
    for g in table.anytime_groups().values():
        is_any[g] = True
    dev_consts = {k: torch.as_tensor(v, device=device)
                  if isinstance(v, np.ndarray) else v
                  for k, v in consts.items()}
    dev_consts["is_anytime_k"] = torch.as_tensor(is_any, device=device)

    def step_on_device(i_glob, j_act, scale, dvec):
        return sim.deliver_step(
            *(torch.as_tensor(x, device=device)
              for x in (i_glob, j_act, scale, dvec)), 0.25, **dev_consts)

    fields = [f.name for f in dataclasses.fields(sim.DeliveredTick)]
    for n, (i_glob, j_act, scale, dvec, prof) in sorted(rec.inputs.items()):
        want = sim.deliver_tick(table, st, i_glob, j_act, scale, dvec, 0.25,
                                is_any, prof)
        if not np.array_equal(prof, table.latency[i_glob, j_act]):
            raise SmokeFailure(f"fleet tick {n}: profiled pick is not the "
                               f"executed config's")
        got = step_on_device(i_glob, j_act, scale, dvec)
        for f, g in zip(fields, got):
            if not np.array_equal(g.cpu().numpy(), getattr(want, f)):
                raise SmokeFailure(f"fleet tick {n}: deliver_step {f} "
                                   f"differs from deliver_tick")

    # Check 4: tick `mid`'s select over every lane, on the device and on
    # the CPU's plain version.
    cpu = torch.device("cpu")
    args, kw = rec.select_args
    eng = rec.engine
    got = sim.BatchedAlertEngine.select(eng, *args, **kw)
    want = sim.BatchedAlertEngine(
        eng.table, eng.goal, overhead=eng.overhead,
        paper_faithful_energy=eng.paper_faithful_energy, device=cpu).select(
        *(x.to(cpu) if torch.is_tensor(x) else x for x in args),
        **{k: x.to(cpu) if torch.is_tensor(x) else x for k, x in kw.items()})
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if a.shape != (lanes,) or not np.array_equal(a, b):
            raise SmokeFailure(f"fleet tick {mid}: select {f.name} differs "
                               f"from the CPU's in {int((a != b).sum())} "
                               f"of {lanes} lanes")

    # The pieces of one tick at tick `mid`'s inputs.
    select_ms = sync_ms(lambda: sim.BatchedAlertEngine.select(
        rec.engine, *args, **kw), sync)
    d, rest, scale, dvec, i_glob, j_act = rec.delivered
    deliver_ms = sync_ms(lambda: sim.deliver_tick(
        table, st, i_glob, j_act, scale, dvec, *rest), sync)
    dev_in = [torch.as_tensor(x, device=device)
              for x in (i_glob, j_act, scale, dvec)]
    step_ms = sync_ms(lambda: sim.deliver_step(
        *dev_in, 0.25, **dev_consts), sync)
    slow, idle, fb_args, fb_kw = rec.feedback
    mask = fb_kw["mask"]

    def feedback():
        sim.observe_fleet(slow, idle, *fb_args, **fb_kw)
        rec.bank.record(d.accuracy, mask=mask)
        rec.bank.current_goal()

    feedback_ms = sync_ms(feedback, sync)
    tick_med = statistics.median(tick_ms)
    smi = nvidia_smi_line() if card else "cpu"
    busy = rec.device_split() if card else {}
    split = {"select_ms": select_ms, "deliver_tick_ms": deliver_ms,
             "feedback_ms": feedback_ms}
    out = {"lanes": lanes, "ticks": n_ticks, "trace_build_s": trace_s,
           "run_s": run_s, "setup_s": run_s - ticks_s, "ticks_s": ticks_s,
           "tick_median_ms": tick_med, "tick_min_ms": min(tick_ms),
           "tick_max_ms": max(tick_ms), **split,
           "deliver_step_ms": step_ms,
           "shares": {k[:-3]: v / tick_med for k, v in split.items()},
           "checked_lanes": len(lanes_chk),
           "recorded_ticks": len(rec.inputs), "alert_select": n_sel,
           "device_tick": busy, "nvidia_smi": smi, "counts": runs,
           "_keep": {"table": table, "specs": specs, "result": res}}
    say(f"  fleet S={lanes}, T={n_ticks}: traces built in {trace_s:.3f} s; "
        f"run_fleet {run_s:.3f} s (set-up {run_s - ticks_s:.3f} s, ticks "
        f"{ticks_s:.3f} s); alert_select launched {n_sel} times; "
        f"{len(lanes_chk)} lanes bitwise equal to their CPU run; "
        f"deliver_step bitwise equal to deliver_tick on "
        f"{len(rec.inputs)} ticks; tick {mid}'s select bitwise equal to the "
        f"CPU's on all {lanes} lanes [{smi}]")
    say(f"  one tick, median over the run: {tick_med:.6f} ms (min "
        f"{min(tick_ms):.6f}, max {max(tick_ms):.6f}); at tick {mid}'s "
        f"inputs, medians of {FLEET_REPS} synced calls: select "
        f"{select_ms:.6f} ms, deliver_tick {deliver_ms:.6f} ms, "
        f"deliver_step on the {device.type} {step_ms:.6f} ms, feedback "
        f"(observe_fleet + record + current_goal) {feedback_ms:.6f} ms; "
        f"shares of the tick: " + ", ".join(
            f"{k} {v:.4f}" for k, v in out["shares"].items())
        + f" [{smi}]")
    if busy:
        say(f"  the card over ticks {profiled.start}-{profiled.stop - 1} "
            f"(torch.profiler), a tick: busy {busy['busy_ms']:.6f} ms of "
            f"{busy['host_ms']:.6f} ms on the host clock (idle share "
            f"{busy['idle_share']:.4f}): alert_select {busy['select_ms']:.6f}"
            f" ms, {busy['kernels']:.1f} other kernels "
            f"{busy['kernels_ms']:.6f} ms, {busy['copies']:.1f} copies "
            f"{busy['copies_ms']:.6f} ms [{smi}]")
    elif card:
        say("  the card's busy time: not measured (torch.profiler recorded "
            "no device time)")
    return out


# Phase 31: the session gateway over the reference's recorded traffic
# cells (``repro_torch.serving.scenarios``): ``bench_traffic``'s 1024
# Poisson Eq. 4 sessions over 256 lanes at loads 0.5-24, tick T_goal/4,
# a queue of 4 x lanes; ``bench_obs``'s 20,000 such sessions over 1,024
# lanes at the rate that fills them, tick T_goal, 24 T_goal, seed 11.
# Loads whose card runs are held to the CPU.
GW_CPU_LOADS = (2.0, 24.0)
# The faulted runs: the load, the iteration the brownout run is killed
# at and the checkpoint cadence (its checkpoint is taken at iteration 48).
GW_FAULT_LOAD = 8.0
GW_KILL_AT, GW_CKPT_EVERY = 61, 16
SCALE_SESSIONS, SCALE_LANES = 20_000, 1024
SCALE_ROUNDS, SCALE_SEED = 24, 11
# Served rounds of the scale run traced by torch.profiler.
SCALE_PROFILED = 5
GATEWAY_FIELDS = ("sid", "index", "arrival", "status", "start", "latency",
                  "sojourn", "missed", "accuracy", "energy", "model_index",
                  "power_index")


def same_gateway_result(got, want, what: str) -> None:
    """Fails unless every per-request array, the round count, the paging
    counters and the horizon of ``got`` equal ``want``'s bitwise."""
    same_result(got, want, GATEWAY_FIELDS, what)
    for f in ("n_rounds", "pages_in", "pages_out", "horizon"):
        if getattr(got, f) != getattr(want, f):
            raise SmokeFailure(f"{what}: {f} {getattr(got, f)} != "
                               f"{getattr(want, f)}")


@contextlib.contextmanager
def select_log(gw, inject=None, hold_plain: bool = False):
    """While active, ``gw``'s engine keeps, for each ``select``, host
    copies of the eight lane vectors it hands the kernel in
    ``log["inputs"]`` and its decisions in ``log["outs"]``.  With
    ``hold_plain`` every launch is held to ``alert_select_plain`` on the
    same device tensors: the int32 results (model, power, feasible,
    relaxed code) must be bitwise equal on every lane.  With ``inject``
    (another run's ``log["outs"]``) each ``select`` returns that run's
    decisions; ``log["outs"]`` keeps the engine's own."""
    import torch

    from repro_torch.kernels import alert_select as ks

    log = {"inputs": [], "outs": []}
    eng = gw.engine
    kernel, select = eng._kernel, type(eng).select

    def held(*lanes, **kw):
        ints, f64 = kernel.alert_select_packed(*lanes, **kw)
        log["inputs"].append([x.cpu().numpy().copy() for x in lanes])
        if hold_plain:
            i, j, _, _, _, feas, rel = ks.alert_select_plain(*lanes, **kw)
            want = torch.stack([i, j, feas.to(torch.int32), rel])
            if not torch.equal(ints, want):
                bad = (ints != want).any(dim=0).nonzero().flatten()
                raise SmokeFailure(
                    f"select {len(log['outs'])}: the kernel's picks differ "
                    f"from its plain version's on the same "
                    f"{lanes[0].device.type} tensors at lanes "
                    f"{bad[:8].tolist()}")
        return ints, f64

    def noted(*args, **kw):
        n = len(log["outs"])
        log["outs"].append(select(eng, *args, **kw))
        if inject is None:
            return log["outs"][-1]
        if n >= len(inject):
            raise SmokeFailure(f"select {n} has no decisions to inject")
        return inject[n]

    eng._kernel = types.SimpleNamespace(
        **{**vars(kernel), "alert_select_packed": held})
    eng.select = noted
    try:
        yield log
    finally:
        del eng.select
        eng._kernel = kernel


def held_run(gw, run, runs: list):
    """``run(gw)`` (counted, :func:`counted_run`) with every select of
    ``gw`` held to the plain version: ``(result, select_log)``."""
    with select_log(gw, hold_plain=True) as log:
        res = counted_run(lambda: run(gw), runs)
    return res, log


def hold_to_cpu(make, run, got, log: dict, what: str) -> dict:
    """Holds the card's gateway run ``got`` (``log``, its
    :func:`select_log`) to the port's host logic on the CPU: a fresh CPU
    gateway (``make(cpu)``) driven by ``run`` with the card's decisions
    injected must see bitwise the card's lane inputs at every select and
    end bitwise equal to ``got``.  Where the CPU's plain version decided
    otherwise than the card's kernel (a pick or a relaxed code), the pick
    contract must hold: an active ``RELAXED_ACCURACY`` lane on both whose
    two picks' accuracies, as the CPU estimates them at the common
    inputs, lie within 2 ulp.  With the port's own ``erf`` on both
    devices no decision differs; the contract stays as the check's
    fallback.  ``bitwise``: no decision differed, so the CPU's own run is
    the card's."""
    import numpy as np
    import torch

    from repro_torch.core.batched import RELAXED_ACCURACY

    g = make(torch.device("cpu"))
    with select_log(g, inject=log["outs"]) as mine:
        res = run(g)
    same_gateway_result(got, res, what + ": the CPU with the card's "
                        "decisions injected")
    if len(mine["outs"]) != len(log["outs"]):
        raise SmokeFailure(f"{what}: {len(mine['outs'])} selects on the "
                           f"CPU, {len(log['outs'])} on the card")
    differ, n_lanes, worst = [], 0, 0.0
    for n, (a_in, b_in, a, b) in enumerate(zip(
            log["inputs"], mine["inputs"], log["outs"], mine["outs"])):
        if not all(np.array_equal(x, y) for x, y in zip(a_in, b_in)):
            raise SmokeFailure(f"{what}: the inputs of select {n} differ "
                               f"between the card and the CPU")
        lanes = np.nonzero((a.model_index != b.model_index)
                           | (a.power_index != b.power_index)
                           | (a.relaxed_code != b.relaxed_code))[0]
        if not len(lanes):
            continue
        mu, sigma, phi, dl = (x[lanes] for x in a_in[:4])
        if not (a_in[7][lanes].all()
                and (a.relaxed_code[lanes] == RELAXED_ACCURACY).all()
                and (b.relaxed_code[lanes] == RELAXED_ACCURACY).all()):
            raise SmokeFailure(f"{what}: select {n} decided differently "
                               f"on lanes {lanes.tolist()}, not all active "
                               f"relaxed Eq. 4 lanes")
        acc = g.engine.estimate(
            mu, sigma, phi, np.maximum(dl - g.engine.overhead, 1e-9)).accuracy
        r = np.arange(len(lanes))
        x = acc[r, a.model_index[lanes], a.power_index[lanes]]
        y = acc[r, b.model_index[lanes], b.power_index[lanes]]
        ulp = np.abs(x - y) / np.spacing(np.maximum(np.abs(x), np.abs(y)))
        if not (ulp <= 2).all():
            raise SmokeFailure(f"{what}: select {n}'s picks on lanes "
                               f"{lanes.tolist()} break the pick contract: "
                               f"accuracies {x.tolist()} on the card's, "
                               f"{y.tolist()} on the CPU's")
        differ.append(n)
        n_lanes += len(lanes)
        worst = max(worst, float(ulp.max()))
    return {"bitwise": not differ, "selects": len(log["outs"]),
            "differing_selects": differ, "differing_lanes": n_lanes,
            "max_ulp": worst}


def check_select_launches(res, counts: dict, device, what: str,
                          rounds: int | None = None,
                          policy: str = "alert") -> None:
    """Fails unless ``alert_select`` launched once a served round on the
    card under ``policy="alert"`` (``rounds``, default the result's), and
    never otherwise, by the result's count and by the counter's."""
    n = res.n_rounds if rounds is None else rounds
    want = n if device.type == "cuda" and policy == "alert" else 0
    if res.select_launches != want or counts["alert_select"] != want:
        raise SmokeFailure(
            f"{what}: alert_select launched {res.select_launches} times "
            f"(counter {counts['alert_select']}) over {n} served rounds")


def gateway_goldens(device, runs: list, golden_path=None) -> dict:
    """Phase 31 (a): the gateway's goldens on ``device``.  The golden
    overload workload's summary must equal ``tests/golden_traces.json``'s
    ``gateway`` entry with ``==``; on the straggler workload the detector
    must trip exactly the golden's lanes at its time and latency in
    rounds, and never on the same workload without the fault.  Every
    select is held to the plain version (:func:`held_run`)."""
    import numpy as np

    from repro_torch.serving.scenarios import (gateway_summary,
                                               golden_gateway_workload,
                                               golden_table,
                                               straggler_workload)
    from repro_torch.traffic import (KalmanLaneDetector, SessionGateway,
                                     generate_requests)

    golden = json.loads(Path(golden_path or ROOT / "tests" /
                             "golden_traces.json").read_text())
    table = golden_table()
    sessions, n_lanes, dl = golden_gateway_workload(table)
    gw = SessionGateway(table, n_lanes, tick=dl, max_queue=4 * n_lanes,
                        device=device)
    res, _ = held_run(gw, lambda g: g.run(sessions,
                                          generate_requests(sessions)), runs)
    got = gateway_summary(res)
    if got != golden["gateway"]:
        raise SmokeFailure(f"gateway golden: {got} != {golden['gateway']}")
    check_select_launches(res, runs[-1], device, "gateway golden")
    launches = [res.select_launches]
    sessions, n_lanes, dl, faults = straggler_workload(table)
    g = golden["straggler"]
    dets = []
    for fs in (faults, None):
        det = KalmanLaneDetector(n_lanes)
        res, _ = held_run(
            SessionGateway(table, n_lanes, tick=dl, device=device),
            lambda g: g.run(sessions, generate_requests(sessions),
                            faults=fs, detector=det), runs)
        check_select_launches(res, runs[-1], device, "straggler run")
        launches.append(res.select_launches)
        dets.append(det)
    det, clean = dets
    lane = g["fault_lane"]
    got_s = {"tripped_lanes": [int(x) for x in np.nonzero(det.tripped)[0]],
             "first_trip_time_s": float(det.first_trip_time[lane]),
             "detection_latency_rounds": det.detection_latency(
                 lane, g["fault_start_rounds"] * dl) / dl,
             "clean_false_positives": int(clean.tripped.sum())}
    for key, have in got_s.items():
        if have != g[key]:
            raise SmokeFailure(f"straggler golden {key}: {have} != {g[key]}")
    say(f"  golden gateway (24 sessions over 8 lanes): {got} equal to the "
        f"fixture with ==; straggler: {got_s} equal to the fixture; "
        f"alert_select launched {launches} times, once a served round")
    return {"gateway": got, "straggler": got_s, "select_launches": launches}


def gateway_row(res) -> dict:
    """The numbers phase 31 prints for one gateway run."""
    return {"offered": res.offered, "served": int(res.served.sum()),
            "rejected_infeasible": int((res.status == 1).sum()),
            "rejected_backpressure": int((res.status == 2).sum()),
            "goodput_rps": res.goodput,
            "served_miss_rate": res.served_miss_rate,
            "p99_sojourn_s": res.percentile_sojourn(99),
            "energy_per_good_j": res.energy_per_good,
            "pages_in": res.pages_in, "pages_out": res.pages_out,
            "rounds": res.n_rounds, "select_launches": res.select_launches}


def gateway_traffic(device, runs: list, loads=None,
                    cpu_loads=GW_CPU_LOADS) -> dict:
    """Phase 31 (b): ``bench_traffic``'s workload on ``device`` at each
    of ``loads`` (default all four), under ``policy="alert"`` and
    ``policy="static"`` (the hindsight-static config of a seed-5 trace,
    the reference load sweep's baseline).  Each run is timed, then run
    again with every select held to the plain version, bitwise equal;
    at ``cpu_loads`` that run is held to the CPU (:func:`hold_to_cpu`)."""
    import torch

    from repro_torch.core.controller import Goal
    from repro_torch.serving.scenarios import (TRAFFIC_LANES,
                                               TRAFFIC_LOADS, TRAFFIC_SEED,
                                               TRAFFIC_SESSIONS,
                                               golden_table, traffic_mix,
                                               traffic_sessions)
    from repro_torch.serving.sim import CPU_ENV, EnvironmentTrace, InferenceSim
    from repro_torch.traffic import SessionGateway, generate_requests

    table = golden_table()
    _, dl, cons = traffic_mix(table, TRAFFIC_SESSIONS, TRAFFIC_LANES, 0.5)
    static = InferenceSim(table, EnvironmentTrace(CPU_ENV, seed=TRAFFIC_SEED),
                          device=torch.device("cpu")).run_oracle_static(
        Goal.MINIMIZE_ENERGY, cons).config

    def gateway(dev):
        return SessionGateway(table, TRAFFIC_LANES, tick=dl / 4,
                              max_queue=4 * TRAFFIC_LANES, device=dev)

    out = {"static_config": list(static), "loads": {}}
    for load in TRAFFIC_LOADS if loads is None else loads:
        sessions, _, _ = traffic_sessions(table, load)
        row = {}
        for policy in ("alert", "static"):
            kw = dict(policy=policy,
                      static_config=static if policy == "static" else None)

            def run(gw):
                return gw.run(sessions, generate_requests(sessions), **kw)

            what = f"traffic load {load} {policy}"
            gw = gateway(device)
            t0 = time.perf_counter()
            res = counted_run(lambda: run(gw), runs)
            secs = time.perf_counter() - t0
            check_select_launches(res, runs[-1], device, what,
                                  policy=policy)
            again, log = held_run(gateway(device), run, runs)
            same_gateway_result(again, res, what + " run again, held to "
                                "the plain version")
            check_select_launches(again, runs[-1], device, what,
                                  policy=policy)
            row[policy] = {**gateway_row(res), "run_s": secs}
            if load in cpu_loads:
                row[policy]["cpu"] = hold_to_cpu(gateway, run, again, log,
                                                 what)
            say(f"  load {load} {policy}: " + ", ".join(
                f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row[policy].items()))
        out["loads"][str(load)] = row
    return out


def gateway_faults(device, runs: list, load: float = GW_FAULT_LOAD) -> dict:
    """Phase 31 (c): ``bench_traffic``'s workload at ``load`` on
    ``device`` under ``scenario("device_loss", n_devices=4)`` (the last
    device's lanes, 192-255 of 256, must end quarantined and the run must
    differ from the clean one) and ``scenario("brownout")``; the brownout
    run killed at iteration ``GW_KILL_AT`` and resumed from its checkpoint
    must equal the uninterrupted run bitwise.  Every select is held to
    the plain version (:func:`held_run`)."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.runtime.elastic import dead_lane_mask
    from repro_torch.runtime.ft import InjectedFailure
    from repro_torch.serving.scenarios import (TRAFFIC_LANES, golden_table,
                                               traffic_sessions)
    from repro_torch.traffic import (SessionGateway, generate_requests,
                                     scenario)

    lanes = TRAFFIC_LANES
    table = golden_table()
    sessions, dl, _ = traffic_sessions(table, load)

    def gateway():
        return SessionGateway(table, lanes, tick=dl / 4,
                              max_queue=4 * lanes, device=device)

    def run(fs=None, **kw):
        return lambda g: g.run(sessions, generate_requests(sessions),
                               faults=fs, **kw)

    gw = gateway()
    clean, _ = held_run(gw, run(), runs)
    check_select_launches(clean, runs[-1], device, "clean run")
    out, faulted = {}, {}
    for kind in ("device_loss", "brownout"):
        fs = scenario(kind, lanes, start=4 * dl, horizon=30 * dl, seed=11,
                      n_devices=4)
        res, _ = held_run(gw, run(fs), runs)
        check_select_launches(res, runs[-1], device, kind)
        if all(np.array_equal(getattr(res, f), getattr(clean, f))
               for f in GATEWAY_FIELDS):
            raise SmokeFailure(f"{kind}: the run equals the clean run")
        faulted[kind] = fs, res
        out[kind] = gateway_row(res)
        if kind == "device_loss":
            dead = np.nonzero(gw._dead)[0]
            if not np.array_equal(gw._dead,
                                  dead_lane_mask(lanes, 4, [3])):
                raise SmokeFailure(f"device_loss: lanes {dead.tolist()} "
                                   f"quarantined")
            out[kind]["quarantined"] = [int(dead[0]), int(dead[-1])]
        say(f"  {kind} at load {load}: {out[kind]}")
    fs, want = faulted["brownout"]
    with tempfile.TemporaryDirectory() as td:
        ck = str(Path(td) / "ck")

        def killed(g):
            try:
                run(fs, checkpoint_dir=ck, checkpoint_every=GW_CKPT_EVERY,
                    kill_at_round=GW_KILL_AT)(g)
            except InjectedFailure:
                return True
            return False

        if not held_run(gateway(), killed, runs)[0]:
            raise SmokeFailure("brownout: the run was not killed")
        tree, step = ckpt_io.restore_tree(ck)
        before = int(tree["meta"]["n_rounds"])
        got, _ = held_run(gateway(), lambda g: g.resume(
            sessions, generate_requests(sessions), checkpoint_dir=ck,
            faults=fs), runs)
    same_gateway_result(got, want, "brownout killed and resumed")
    check_select_launches(got, runs[-1], device, "resumed run",
                          rounds=got.n_rounds - before)
    out["resumed_from_iteration"] = step
    say(f"  brownout killed at iteration {GW_KILL_AT}, resumed from the "
        f"checkpoint of iteration {step} ({before} rounds served): "
        f"bitwise equal to the uninterrupted run")
    return out


def gateway_scale(device, runs: list, n_sessions: int = SCALE_SESSIONS,
                  n_lanes: int = SCALE_LANES,
                  rounds: int = SCALE_ROUNDS) -> dict:
    """Phase 31 (d): ``bench_obs``'s workload through the host gateway on
    ``device``.  The timed run carries no check; a second run, with every
    select held to the plain version, must equal it bitwise and is held
    to the CPU (:func:`hold_to_cpu`).  Prints the
    median round (one ``select`` start to the next), at the mid-run
    round's inputs the medians of ``FLEET_REPS`` synced calls of its
    paging (the evictees' ``export_lanes`` and the paged-in sessions'
    ``import_lanes`` on the three banks), ``select``, ``deliver_tick`` and
    the feedback (``observe_fleet`` and ``record``), and on the card its
    busy time and idle share over ``SCALE_PROFILED`` rounds
    (``torch.profiler``)."""
    import torch

    from repro_torch.serving.scenarios import golden_table, traffic_mix
    from repro_torch.traffic import build_sessions, gateway

    card = device.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    table = golden_table()
    mix, dl, _ = traffic_mix(table, n_sessions, n_lanes, 1.0)
    t0 = time.perf_counter()
    sessions = build_sessions(mix, rounds * dl, seed=SCALE_SEED)
    build_s = time.perf_counter() - t0
    mid = rounds // 2
    profiled = range(mid + 1, mid + 1 + SCALE_PROFILED) if card \
        else range(0)
    paging = {}

    class Gateway(gateway.SessionGateway):
        """Notes the lanes the mid-run round pages out and in."""

        def _page_in(self, sids, sess, round_k, now):
            if len(rec.stamps) != mid:
                return super()._page_in(sids, sess, round_k, now)
            before = self._resident.copy()
            paged = [s for s in sids if s in self._store]
            lanes = super()._page_in(sids, sess, round_k, now)
            paging["out"] = [ln for ln, s in enumerate(before)
                             if s >= 0 and int(s) not in self._lane_of]
            paging["in"] = [self._lane_of[s] for s in paged]
            paging["fresh"] = len(sids) - len(paged) - sum(
                before[self._lane_of[s]] == s for s in sids)
            return lanes

    def make(dev):
        return gateway.SessionGateway(table, n_lanes, tick=dl,
                                      max_queue=4 * n_lanes, device=dev)

    def run(g):
        return g.run(sessions, gateway.generate_requests(sessions))

    with FleetRecorder((), mid, profiled, module=gateway) as rec:
        gw = Gateway(table, n_lanes, tick=dl, max_queue=4 * n_lanes,
                     device=device)
        requests = gateway.generate_requests(sessions)
        t0 = time.perf_counter()
        res = counted_run(lambda: gw.run(sessions, requests), runs)
        run_s = time.perf_counter() - t0
    check_select_launches(res, runs[-1], device, "scale run")
    if len(rec.stamps) != res.n_rounds or (card and rec.window_s is None):
        raise SmokeFailure(f"scale run: {len(rec.stamps)} selects in "
                           f"{res.n_rounds} rounds; profiled window "
                           f"{'missed' if rec.window_s is None else 'ok'}")
    again, log = held_run(make(device), run, runs)
    same_gateway_result(again, res, "scale run again, held to the plain "
                        "version")
    check_select_launches(again, runs[-1], device, "scale run again")
    cpu_check = hold_to_cpu(make, run, again, log, "scale run")
    round_ms = [(b - a) * 1e3 for n, (a, b) in enumerate(
        zip(rec.stamps, rec.stamps[1:])) if n + 1 not in profiled
        and n not in profiled]
    banks = (gw.slow, gw.idle, gw.goal_bank)
    snaps = [b.export_lanes(paging["in"]) for b in banks]

    def page():
        for b in banks:
            b.export_lanes(paging["out"])
        for b, snap in zip(banks, snaps):
            b.import_lanes(paging["in"], snap)

    args, kw = rec.select_args
    d, rest, scale, dvec, i_glob, j_act = rec.delivered
    slow, idle, fb_args, fb_kw = rec.feedback

    def feedback():
        gateway.observe_fleet(slow, idle, *fb_args, **fb_kw)
        rec.bank.record(d.accuracy, mask=fb_kw["mask"])

    split = {
        "page_ms": sync_ms(page, sync),
        "select_ms": sync_ms(lambda: gateway.BatchedAlertEngine.select(
            rec.engine, *args, **kw), sync),
        "deliver_tick_ms": sync_ms(lambda: gateway.deliver_tick(
            table, gw._st, i_glob, j_act, scale, dvec, *rest), sync),
        "feedback_ms": sync_ms(feedback, sync)}
    round_med = statistics.median(round_ms)
    smi = nvidia_smi_line() if card else "cpu"
    busy = rec.device_split() if card else {}
    out = {"sessions": n_sessions, "lanes": n_lanes,
           "offered": res.offered, "served": int(res.served.sum()),
           "rounds": res.n_rounds, "pages_in": res.pages_in,
           "pages_out": res.pages_out, "build_s": build_s, "run_s": run_s,
           "round_median_ms": round_med, "round_min_ms": min(round_ms),
           "round_max_ms": max(round_ms), "mid_round": mid,
           "mid_round_paged": {"out": len(paging["out"]),
                               "in": len(paging["in"]),
                               "fresh": int(paging["fresh"])},
           **split, "shares": {k[:-3]: v / round_med
                               for k, v in split.items()},
           "rest_share": 1.0 - sum(split.values()) / round_med,
           "device_round": busy, "cpu": cpu_check, "nvidia_smi": smi}
    say(f"  scale: {n_sessions} sessions over {n_lanes} lanes, "
        f"{res.offered} requests, {out['served']} served in {res.n_rounds} "
        f"rounds ({res.pages_in} pages in, {res.pages_out} out); sessions "
        f"built in {build_s:.3f} s, run {run_s:.3f} s; against the CPU: "
        f"{cpu_check} [{smi}]")
    say(f"  one round, median over the run: {round_med:.6f} ms (min "
        f"{min(round_ms):.6f}, max {max(round_ms):.6f}); at round {mid} "
        f"({len(paging['out'])} lanes paged out, {len(paging['in'])} in, "
        f"{int(paging['fresh'])} fresh), medians of {FLEET_REPS} synced "
        f"calls: paging {split['page_ms']:.6f} ms, select "
        f"{split['select_ms']:.6f} ms, deliver_tick "
        f"{split['deliver_tick_ms']:.6f} ms, feedback (observe_fleet + "
        f"record) {split['feedback_ms']:.6f} ms; shares of the round: "
        + ", ".join(f"{k} {v:.4f}" for k, v in out["shares"].items())
        + f", the rest (the round's Python: EDF pops, page-in bookkeeping, "
        f"lane fill, result scatter) {out['rest_share']:.4f} [{smi}]")
    if busy:
        say(f"  the card over rounds {profiled.start}-{profiled.stop - 1} "
            f"(torch.profiler), a round: busy {busy['busy_ms']:.6f} ms of "
            f"{busy['host_ms']:.6f} ms on the host clock (idle share "
            f"{busy['idle_share']:.4f}): alert_select "
            f"{busy['select_ms']:.6f} ms, {busy['kernels']:.1f} other "
            f"kernels {busy['kernels_ms']:.6f} ms, {busy['copies']:.1f} "
            f"copies {busy['copies_ms']:.6f} ms [{smi}]")
    elif card:
        say("  the card's busy time: not measured (torch.profiler recorded "
            "no device time)")
    return out


def erf_disagreement(device, n: int = 200_001) -> dict:
    """Float64 ``torch.erf`` on ``device`` against the CPU's at ``n``
    points of [-8, 8] (the Eq. 7 range): how many differ and by how many
    ulp at most; then the port's own ``erf`` (``kernels/alert_select.py``,
    what the plain version and the kernel run), which must differ at no
    point: it is one sequence of correctly rounded operations on both."""
    import numpy as np
    import torch

    from repro_torch.kernels import alert_select as ks

    z = torch.linspace(-8.0, 8.0, n, dtype=torch.float64)
    got = torch.erf(z.to(device)).cpu().numpy()
    want = torch.erf(z).numpy()
    ulp = np.abs(got - want) / np.spacing(np.abs(want))
    mine = ks.erf(z.to(device)).cpu().view(torch.int64)
    port_differ = int((mine != ks.erf(z).view(torch.int64)).sum())
    out = {"points": n, "differ": int((got != want).sum()),
           "max_ulp": float(ulp.max()), "port_differ": port_differ}
    say(f"  float64 torch.erf on the {device.type} against the CPU at {n} "
        f"points of [-8, 8]: {out['differ']} differ, at most "
        f"{out['max_ulp']:.3g} ulp; the port's erf: {port_differ} differ")
    if port_differ:
        raise SmokeFailure(f"the port's erf differs between the "
                           f"{device.type} and the CPU at {port_differ} "
                           f"points")
    return out


def gateway_phase(device) -> dict:
    """Phase 31: (a)-(d) on ``device``, and ``torch.erf`` on it against
    the CPU; ``counts`` holds the launches of every gateway run on it."""
    runs = []
    return {"erf": erf_disagreement(device),
            "goldens": gateway_goldens(device, runs),
            "traffic": gateway_traffic(device, runs),
            "faults": gateway_faults(device, runs),
            "scale": gateway_scale(device, runs), "counts": runs}


# --------------------------------------------------------------------- #
# phase 32: the megatick on the card                                     #
# --------------------------------------------------------------------- #
# (c)'s timed repetitions (the reference's bench_obs takes 3) and (b)'s.
MT_OBS_REPS = 3
MT_REPS = 2
# (d) and (e): bench_traffic's cell at the megatick's tick (T_goal).
MT_SWEEP_SCHEMES = ("alert", "oracle_static")


def megatick_golden(device, runs: list) -> dict:
    """Phase 32 (a): the gateway golden's workload through
    ``MegatickGateway`` on ``device`` (chunks of 4 rounds, so the run
    replays one graph three times and runs no pad round): the summary
    must equal ``tests/golden_traces.json``'s ``gateway`` entry with
    ``==``, with one ``alert_select`` launch a round."""
    from repro_torch.serving.scenarios import (gateway_summary,
                                               golden_gateway_workload,
                                               golden_table)
    from repro_torch.traffic import MegatickGateway, generate_requests

    golden = json.loads((ROOT / "tests" / "golden_traces.json").read_text())
    table = golden_table()
    sessions, n_lanes, dl = golden_gateway_workload(table)
    gw = MegatickGateway(table, n_lanes, tick=dl, max_queue=4 * n_lanes,
                         chunk=4, device=device)
    res = counted_run(lambda: gw.run(sessions, generate_requests(sessions)),
                      runs)
    got = gateway_summary(res)
    if got != golden["gateway"]:
        raise SmokeFailure(f"megatick golden: {got} != {golden['gateway']}")
    check_select_launches(res, runs[-1], device, "megatick golden")
    nodes = [len(graph_kernels(g)) for g in gw.chunk_graphs()] \
        if device.type == "cuda" else []
    say(f"  golden gateway through the megatick: equal to the fixture with "
        f"==; {res.n_rounds} rounds, alert_select launched "
        f"{res.select_launches} times; n_compiles {gw.n_compiles()}; "
        f"kernel nodes of the 4-round graph {nodes}")
    return {"summary": got, "select_launches": res.select_launches,
            "n_compiles": list(gw.n_compiles()), "graph_kernel_nodes": nodes}


def megatick_profiled(gw, run):
    """``run(gw)`` with its chunk dispatches (the host's buffer fill,
    copies in, replay, copies out) under ``torch.profiler``: ``(result,
    device split)``, the split the card's busy ms (kernels and copies)
    over the dispatches' host time (timed inside the profiler, without
    its start and stop) and the idle share; empty where no device time
    was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    base = gw._dispatch
    window = [0.0]
    profs = []

    def dispatch(ch, plan, lo):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys = base(ch, plan, lo)          # ends in a sync
            window[0] += time.perf_counter() - t0
        profs.append(prof)
        return ys

    gw._dispatch = dispatch
    try:
        res = run(gw)
    finally:
        del gw._dispatch
    out = device_time(*profs)
    if not out["busy_ms"]:
        return res, {}
    out["window_ms"] = window[0] * 1e3
    out["idle_share"] = 1.0 - out["busy_ms"] / out["window_ms"]
    out["dispatches"] = len(profs)
    return res, out


def megatick_scale(device, runs: list) -> dict:
    """Phase 32 (b): the reference's ``bench_megatick`` cell at full size
    (100,000 sessions over 4096 lanes, 48 rounds of T_goal, one chunk of
    48): the megatick on ``device`` (its first run captures the graph,
    then ``MT_REPS`` timed runs, the least kept), ``graphs=False`` on the
    same device, the megatick on the CPU and the host gateway on the
    device: every result bitwise equal to the graphed run's.  Prints
    ``plan_s``, ``scan_s``, the rates, the graph's kernel nodes, the
    card's busy time and idle share over a profiled run's replay and
    ``n_compiles``."""
    import torch

    from repro_torch.serving.scenarios import (MEGATICK_LANES,
                                               MEGATICK_ROUNDS,
                                               MEGATICK_SEED,
                                               MEGATICK_SESSIONS,
                                               golden_table,
                                               saturating_sessions)
    from repro_torch.traffic import (MegatickGateway, SessionGateway,
                                     generate_requests)

    card = device.type == "cuda"
    table = golden_table()
    n_lanes, rounds = MEGATICK_LANES, MEGATICK_ROUNDS
    t0 = time.perf_counter()
    sessions, dl = saturating_sessions(table, MEGATICK_SESSIONS, n_lanes,
                                       rounds, MEGATICK_SEED)
    requests = generate_requests(sessions)
    build_s = time.perf_counter() - t0

    def make(dev, graphs=True):
        return MegatickGateway(table, n_lanes, tick=dl,
                               max_queue=4 * n_lanes, chunk=rounds,
                               device=dev, graphs=graphs)

    def run(g):
        return g.run(sessions, requests)

    mega = make(device)
    t0 = time.perf_counter()
    first = counted_run(lambda: run(mega), runs)
    first_s = time.perf_counter() - t0
    check_select_launches(first, runs[-1], device, "megatick first run")
    plan_s = scan_s = float("inf")
    for _ in range(MT_REPS):
        res = counted_run(lambda: run(mega), runs)
        check_select_launches(res, runs[-1], device, "megatick run")
        same_gateway_result(res, first, "megatick run again")
        plan_s = min(plan_s, mega.last_plan_s)
        scan_s = min(scan_s, mega.last_scan_s)
    busy = {}
    if card:
        res, busy = megatick_profiled(mega, run)
        same_gateway_result(res, first, "megatick profiled run")
    nodes = graph_kernels(mega.chunk_graphs()[0]) if card else []
    n_select_nodes = sum("alert_select" in name for name, _ in nodes)
    if card and n_select_nodes != rounds:
        raise SmokeFailure(f"the megatick graph holds {n_select_nodes} "
                           f"alert_select nodes for {rounds} rounds")
    checks = {}
    for name, g in (("graphs=False", make(device, graphs=False)),
                    ("cpu", make(torch.device("cpu")))):
        t0 = time.perf_counter()
        got = counted_run(lambda: run(g), runs)
        checks[name] = {"run_s": time.perf_counter() - t0,
                        "scan_s": g.last_scan_s}
        same_gateway_result(got, first, f"megatick {name}")
        check_select_launches(got, runs[-1], g.device, f"megatick {name}")
    host = SessionGateway(table, n_lanes, tick=dl, max_queue=4 * n_lanes,
                          device=device)
    t0 = time.perf_counter()
    got = counted_run(lambda: run(host), runs)
    host_s = time.perf_counter() - t0
    same_gateway_result(got, first, "the host gateway")
    check_select_launches(got, runs[-1], device, "the host gateway")
    smi = nvidia_smi_line() if card else "cpu"
    n = first.n_rounds
    out = {"sessions": len(sessions), "lanes": n_lanes, "rounds": n,
           "offered": first.offered, "served": int(first.served.sum()),
           "pages_in": first.pages_in, "pages_out": first.pages_out,
           "build_s": build_s, "first_run_s": first_s, "plan_s": plan_s,
           "scan_s": scan_s, "round_ms": scan_s / n * 1e3,
           "round_clock_rounds_per_s": n / scan_s,
           "end_to_end_rounds_per_s": n / (plan_s + scan_s),
           "host_s": host_s, "host_rounds_per_s": n / host_s,
           "speedup_round_clock": host_s / scan_s,
           "speedup_end_to_end": host_s / (plan_s + scan_s),
           "graph_kernel_nodes": len(nodes),
           "graph_select_nodes": n_select_nodes,
           "n_compiles": list(mega.n_compiles()), "checks": checks,
           "device": busy, "nvidia_smi": smi,
           "_keep": {"table": table, "tick": dl, "sessions": sessions,
                     "requests": requests, "result": first}}
    say(f"  bench_megatick: {len(sessions)} sessions over {n_lanes} lanes, "
        f"{first.offered} requests, {out['served']} served in {n} rounds "
        f"({first.pages_in} pages in, {first.pages_out} out); sessions "
        f"built in {build_s:.3f} s; first run (capture) {first_s:.3f} s")
    say(f"  plan_s {plan_s:.6f}, scan_s {scan_s:.6f} (least of {MT_REPS}): "
        f"a round {out['round_ms']:.6f} ms on the round clock, "
        f"{out['round_clock_rounds_per_s']:.3f} rounds/s, end to end "
        f"{out['end_to_end_rounds_per_s']:.3f} rounds/s; the host gateway "
        f"on the {device.type} {host_s:.3f} s, "
        f"{out['host_rounds_per_s']:.3f} rounds/s (round clock "
        f"{out['speedup_round_clock']:.2f}x, end to end "
        f"{out['speedup_end_to_end']:.2f}x) [{smi}]")
    say(f"  bitwise equal: two timed runs, graphs=False "
        f"({checks['graphs=False']['run_s']:.3f} s), the CPU "
        f"({checks['cpu']['run_s']:.3f} s), the host gateway; graph: "
        f"{len(nodes)} kernel nodes, {n_select_nodes} alert_select; "
        f"n_compiles {mega.n_compiles()}")
    if busy:
        say(f"  the card over the replay (torch.profiler, "
            f"{busy['dispatches']} dispatch): busy {busy['busy_ms']:.6f} ms "
            f"of {busy['window_ms']:.6f} ms on the host clock (idle share "
            f"{busy['idle_share']:.4f}): alert_select "
            f"{busy['select_ms']:.6f} ms, {busy['kernels']} other kernels "
            f"{busy['kernels_ms']:.6f} ms, {busy['copies']} copies "
            f"{busy['copies_ms']:.6f} ms [{smi}]")
    elif card:
        say("  the card's busy time: not measured (torch.profiler recorded "
            "no device time)")
    return out


def megatick_obs(device, runs: list) -> dict:
    """Phase 32 (c): the reference's ``bench_obs`` cell (20,000 sessions
    over 1024 lanes, 24 rounds, one chunk of 24) through three megatick
    gateways on ``device``: bare, a disabled recorder and a full one, each
    run once (capture) and ``MT_OBS_REPS`` times more, interleaved.
    Every result bitwise equal to the bare run; the ring has seen
    ``(1 + reps) x rounds`` rounds; prints the least scan times and the
    overhead ratios."""
    from repro_torch.obs import FlightRecorder
    from repro_torch.serving.scenarios import (OBS_LANES, OBS_ROUNDS,
                                               OBS_SEED, OBS_SESSIONS,
                                               golden_table,
                                               saturating_sessions)
    from repro_torch.traffic import MegatickGateway, generate_requests

    table = golden_table()
    sessions, dl = saturating_sessions(table, OBS_SESSIONS, OBS_LANES,
                                       OBS_ROUNDS, OBS_SEED)
    requests = generate_requests(sessions)
    recorders = {"bare": None, "disabled": FlightRecorder(enabled=False),
                 "instrumented": FlightRecorder()}
    gws = {name: MegatickGateway(table, OBS_LANES, tick=dl,
                                 max_queue=4 * OBS_LANES, chunk=OBS_ROUNDS,
                                 device=device, obs=obs)
           for name, obs in recorders.items()}
    results = {}
    scan_s = {name: float("inf") for name in gws}
    for rep in range(1 + MT_OBS_REPS):
        for name, gw in gws.items():
            results[name] = counted_run(
                lambda: gw.run(sessions, requests), runs)
            check_select_launches(results[name], runs[-1], device,
                                    f"bench_obs {name}")
            if rep:
                scan_s[name] = min(scan_s[name], gw.last_scan_s)
    for name in ("disabled", "instrumented"):
        same_gateway_result(results[name], results["bare"],
                            f"bench_obs {name}")
    ring = recorders["instrumented"].ring
    n = results["bare"].n_rounds
    if ring.n_seen != (1 + MT_OBS_REPS) * n:
        raise SmokeFailure(f"bench_obs: the ring saw {ring.n_seen} rounds, "
                           f"not {(1 + MT_OBS_REPS) * n}")
    out = {"sessions": len(sessions), "lanes": OBS_LANES, "rounds": n,
           "offered": results["bare"].offered, "scan_s": scan_s,
           "overhead_ratio": scan_s["instrumented"] / scan_s["bare"],
           "disabled_overhead_ratio": scan_s["disabled"] / scan_s["bare"],
           "ring_rounds_seen": ring.n_seen,
           "n_metrics": len(recorders["instrumented"].metrics),
           "n_spans": len(recorders["instrumented"].spans),
           "n_compiles": {k: list(g.n_compiles()) for k, g in gws.items()}}
    say(f"  bench_obs: {len(sessions)} sessions over {OBS_LANES} lanes, "
        f"{n} rounds; bare, disabled and instrumented bitwise equal; the "
        f"ring saw {ring.n_seen} rounds; least scan_s of {MT_OBS_REPS}: "
        + ", ".join(f"{k} {v:.6f}" for k, v in scan_s.items())
        + f"; overhead ratio {out['overhead_ratio']:.4f} (disabled "
        f"{out['disabled_overhead_ratio']:.4f})")
    return out


def megatick_faults(device, runs: list, load: float = GW_FAULT_LOAD) -> dict:
    """Phase 32 (d): ``bench_traffic``'s workload at ``load`` at the
    megatick's tick (T_goal) under ``scenario("device_loss")`` and
    ``scenario("brownout")``, through the megatick and the host gateway on
    ``device``: bitwise equal."""
    from repro_torch.serving.scenarios import (TRAFFIC_LANES, golden_table,
                                               traffic_sessions)
    from repro_torch.traffic import (MegatickGateway, SessionGateway,
                                     generate_requests, scenario)

    table = golden_table()
    lanes = TRAFFIC_LANES
    sessions, dl, _ = traffic_sessions(table, load)
    # 30 T_goal at tick T_goal: 30 rounds, one chunk, no pad round.
    mega = MegatickGateway(table, lanes, tick=dl, max_queue=4 * lanes,
                           chunk=30, device=device)
    host = SessionGateway(table, lanes, tick=dl, max_queue=4 * lanes,
                          device=device)
    out = {}
    for kind in ("device_loss", "brownout"):
        fs = scenario(kind, lanes, start=4 * dl, horizon=30 * dl, seed=11,
                      n_devices=4)
        got = counted_run(lambda: mega.run(
            sessions, generate_requests(sessions), faults=fs), runs)
        check_select_launches(got, runs[-1], device, f"megatick {kind}",
                              rounds=-(-got.n_rounds // 30) * 30)
        want = counted_run(lambda: host.run(
            sessions, generate_requests(sessions), faults=fs), runs)
        same_gateway_result(got, want, f"megatick {kind} against the host "
                            f"gateway")
        out[kind] = gateway_row(got)
        say(f"  {kind} at load {load}, tick T_goal: megatick bitwise equal "
            f"to the host gateway: {out[kind]}")
    return out


def megatick_sweep(device, runs: list) -> dict:
    """Phase 32 (e): ``sweep_loads`` over ``bench_traffic``'s cell (1024
    sessions over 256 lanes, loads 0.5, 2, 8 and 24, 30 T_goal, seed 5)
    at tick T_goal, ``alert`` and ``oracle_static``, with
    ``gateway="megatick"`` and ``gateway="host"`` on ``device``: the
    records equal float for float but for the ``gateway`` tag and the
    program count, which stays flat, one program a scheme.  The sweep's
    megatick runs the default chunk, so its ``alert_select`` launches are
    its rounds padded to a chunk multiple (the pad rounds run with every
    lane dead)."""
    import inspect

    from repro_torch.traffic import MegatickGateway
    from repro_torch.serving.scenarios import (TRAFFIC_LANES, TRAFFIC_LOADS,
                                               TRAFFIC_SEED,
                                               TRAFFIC_SESSIONS,
                                               golden_table, traffic_mix)
    from repro_torch.traffic import sweep_loads

    table = golden_table()
    mix, dl, _ = traffic_mix(table, TRAFFIC_SESSIONS, TRAFFIC_LANES, 0.5)
    kw = dict(n_lanes=TRAFFIC_LANES, horizon=30 * dl, seed=TRAFFIC_SEED,
              max_queue=4 * TRAFFIC_LANES, tick=dl,
              schemes=MT_SWEEP_SCHEMES, device=device)
    rows, secs = {}, {}
    for gateway in ("megatick", "host"):
        t0 = time.perf_counter()
        rows[gateway] = counted_run(lambda: sweep_loads(
            table, mix, TRAFFIC_LOADS, gateway=gateway, **kw), runs)
        secs[gateway] = time.perf_counter() - t0
        chunk = inspect.signature(MegatickGateway).parameters[
            "chunk"].default if gateway == "megatick" else 1
        served = sum(-(-r["schemes"]["alert"]["n_rounds"] // chunk) * chunk
                     for r in rows[gateway])
        want = served if device.type == "cuda" else 0
        if runs[-1]["alert_select"] != want:
            raise SmokeFailure(f"sweep {gateway}: alert_select launched "
                               f"{runs[-1]['alert_select']} times over "
                               f"{served} alert rounds run")

    def strip(rs):
        return [{**r, "schemes": {s: {k: v for k, v in rec.items()
                                      if k not in ("gateway", "n_compiles")}
                                  for s, rec in r["schemes"].items()}}
                for r in rs]

    if strip(rows["megatick"]) != strip(rows["host"]):
        raise SmokeFailure("sweep: the megatick's records differ from the "
                           "host gateway's")
    compiles = {s: [r["schemes"][s]["n_compiles"] for r in rows["megatick"]]
                for s in MT_SWEEP_SCHEMES}
    for s, c in compiles.items():
        if any(x != [0, 1] for x in c):
            raise SmokeFailure(f"sweep {s}: n_compiles {c}, not flat at "
                               f"[0, 1]")
    out = {"loads": list(TRAFFIC_LOADS), "seconds": secs,
           "n_compiles": compiles,
           "rows": {str(r["load"]): {s: {k: r["schemes"][s][k] for k in (
               "goodput_rps", "served_miss_rate", "p99_sojourn_s",
               "energy_per_good_j", "n_rounds")} for s in MT_SWEEP_SCHEMES}
               for r in rows["megatick"]}}
    say(f"  sweep_loads at loads {list(TRAFFIC_LOADS)} (tick T_goal): "
        f"megatick records equal to the host gateway's float for float; "
        f"n_compiles {compiles}; megatick {secs['megatick']:.3f} s, host "
        f"{secs['host']:.3f} s")
    for load, rec in out["rows"].items():
        say(f"    load {load}: " + "; ".join(
            f"{s} " + ", ".join(f"{k} {v:.6g}" for k, v in r.items())
            for s, r in rec.items()))
    return out


def megatick_phase(device) -> dict:
    """Phase 32: (a)-(e) on ``device``; ``counts`` holds the launches of
    every run.  (f), the pick-contract fallback, is not needed: the port's
    erf and exp give the same bits on the CPU and the card, so the CPU is
    held to the card bitwise."""
    runs = []
    out = {"golden": megatick_golden(device, runs),
           "scale": megatick_scale(device, runs),
           "obs": megatick_obs(device, runs),
           "faults": megatick_faults(device, runs),
           "sweep": megatick_sweep(device, runs), "counts": runs}
    say("  (f) the pick-contract fallback is not used: the port's erf and "
        "exp are bitwise equal on the CPU and the card (phase 31), so (b)'s "
        "CPU run is held to the card bitwise")
    return out


# --------------------------------------------------------------------- #
# phase 37: the lane-sharded decision plane                              #
# --------------------------------------------------------------------- #
# The golden scenario's meshes (S=1 padded to the mesh size), and the
# shard count of (b)-(e): shards laid on one card by
# make_lane_mesh(n, device=...), each launching its own alert_select.
MESH_GOLDEN_SHARDS = (1, 4, 8)
MESH_SHARDS = 4
# (d): bench_traffic's workload at this load, killed at this iteration
# with a checkpoint every MESH_CKPT_EVERY iterations.
MESH_GW_LOAD, MESH_KILL_AT, MESH_CKPT_EVERY = 2.0, 61, 16
# (f): run_fleet_dryrun(streams, ticks, churn), over every visible card
# and over MESH_DRYRUN_SHARDS shards on one.
MESH_DRYRUN = (4096, 12, 64)
MESH_DRYRUN_SHARDS = 8
FLEET_RESULT_FIELDS = ("energy", "accuracy", "latency", "missed", "budget",
                       "active")


def check_mesh_launches(n: int, want: int, device, what: str) -> None:
    """Fails unless ``alert_select`` launched ``want`` times on the card
    (never on the CPU)."""
    want = want if device.type == "cuda" else 0
    if n != want:
        raise SmokeFailure(f"{what}: alert_select launched {n} times, "
                           f"expected {want}")


def mesh_goldens(device, runs: list) -> dict:
    """Phase 37 (a): the golden scenario under meshes of
    ``MESH_GOLDEN_SHARDS`` shards on ``device`` (S=1 padded with dead
    lanes): the fixture's alert numbers with ``==``, every [S, T] array
    bitwise the unsharded run's, ``alert_select`` launched once a shard a
    tick."""
    from repro_torch.core.controller import Constraints, Goal
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.serving.scenarios import (GOLDEN_BUDGET_W, GOLDEN_SEED,
                                               golden_deadline, golden_table)
    from repro_torch.serving.sim import ENVS, EnvironmentTrace, FleetSim

    golden = json.loads((ROOT / "tests" / "golden_traces.json").read_text())
    table = golden_table()
    cons = Constraints.from_power_budget(float(golden_deadline(table, 3)[1]),
                                         GOLDEN_BUDGET_W)
    out = {}
    for env in ("default", "cpu", "memory"):
        trace = EnvironmentTrace(ENVS[env], seed=GOLDEN_SEED)
        want = FleetSim(table, [trace], device=device).run_alert(
            Goal.MAXIMIZE_ACCURACY, cons)
        row = {}
        for n in MESH_GOLDEN_SHARDS:
            mesh = make_lane_mesh(n, device=device)
            t0 = time.perf_counter()
            res = counted_run(lambda: FleetSim(table, [trace],
                                               device=device).run_alert(
                Goal.MAXIMIZE_ACCURACY, cons, mesh=mesh), runs)
            secs = time.perf_counter() - t0
            got = {k: getattr(res.stream(0), k)
                   for k in ("mean_energy", "mean_error", "miss_rate")}
            if got != golden["envs"][env]["alert"]:
                raise SmokeFailure(f"golden {env} on {n} shards: {got} != "
                                   f"{golden['envs'][env]['alert']}")
            same_result(res, want, FLEET_RESULT_FIELDS,
                        f"golden {env} on {n} shards against mesh=None")
            check_mesh_launches(runs[-1]["alert_select"], n * trace.n,
                                device, f"golden {env} on {n} shards")
            row[n] = {"seconds": secs, "alert_select":
                      runs[-1]["alert_select"]}
        out[env] = row
        say(f"  golden {env} on " + ", ".join(
            f"{n} shards ({r['alert_select']} launches, "
            f"{r['seconds']:.3f} s)" for n, r in row.items())
            + ": equal to the fixture with ==, bitwise mesh=None's")
    return out


def mesh_fleet(device, runs: list, keep: dict, phase30: dict) -> dict:
    """Phase 37 (b): phase 30's fleet (its specs and result in ``keep``)
    under a ``MESH_SHARDS``-shard mesh on ``device``: every [S, T] array
    bitwise the unsharded run's, ``alert_select`` launched ``MESH_SHARDS``
    times a tick, and at the mid-run tick each shard's launch bitwise its
    plain version on the shard's block (a view of the lane vector at the
    block's offset) and the whole select bitwise the unsharded engine's.
    Prints the median tick beside phase 30's and the kernel's device time
    on a shard's block beside one launch over all lanes."""
    import torch

    from repro_torch.kernels import alert_select as ks
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.serving import sim

    table, specs, want = keep["table"], keep["specs"], keep["result"]
    lanes, n_ticks = want.energy.shape
    mid = n_ticks // 2
    mesh = make_lane_mesh(MESH_SHARDS, device=device)
    with FleetRecorder((), mid) as rec:
        t0 = time.perf_counter()
        res = counted_run(lambda: sim.run_fleet(table, specs, device=device,
                                                mesh=mesh), runs)
        run_s = time.perf_counter() - t0
    if len(rec.stamps) != n_ticks:
        raise SmokeFailure(f"sharded fleet: {len(rec.stamps)} selects in "
                           f"{n_ticks} ticks")
    check_mesh_launches(runs[-1]["alert_select"], MESH_SHARDS * n_ticks,
                        device, "sharded fleet")
    same_result(res, want, FLEET_RESULT_FIELDS,
                f"the fleet on {MESH_SHARDS} shards against mesh=None")
    tick_ms = [(b - a) * 1e3 for a, b in zip(rec.stamps, rec.stamps[1:])]

    # Tick `mid`: each shard's launch against its plain version.
    eng = rec.engine
    args, kw = rec.select_args
    calls = []
    packed = ks.alert_select_packed

    def recording(*blocks, **k):
        calls.append((blocks, k))
        return packed(*blocks, **k)

    before = ks.alert_select.launches
    ks.alert_select_packed = recording
    try:
        got = sim.BatchedAlertEngine.select(eng, *args, **kw)
    finally:
        ks.alert_select_packed = packed
    if len(calls) != MESH_SHARDS or (
            device.type == "cuda"
            and ks.alert_select.launches - before != MESH_SHARDS):
        raise SmokeFailure(f"tick {mid}: {len(calls)} shard calls, "
                           f"{ks.alert_select.launches - before} launches")
    block = lanes // MESH_SHARDS
    for k, (blocks, kk) in enumerate(calls):
        # The deadline is a row of the host values' one copy: shard k's
        # block is a view of it at the block's offset.
        if blocks[0].shape != (block,) or \
                blocks[3].storage_offset() % lanes != k * block:
            raise SmokeFailure(f"tick {mid}, shard {k}: the deadline is not "
                               f"a view of lanes {k * block}-"
                               f"{(k + 1) * block}")
        ints, f64 = packed(*blocks, **kk)
        i, j, lat, acc, en, feas, rel = ks.alert_select_plain(*blocks, **kk)
        if not (torch.equal(ints, torch.stack([i, j, feas.to(torch.int32),
                                               rel]))
                and torch.equal(f64, torch.stack([lat, acc, en]))):
            raise SmokeFailure(f"tick {mid}, shard {k}: the kernel differs "
                               f"from its plain version on its block")
    one = sim.BatchedAlertEngine(
        eng.table, eng.goal, overhead=eng.overhead,
        paper_faithful_energy=eng.paper_faithful_energy, device=device)
    same_result(got, one.select(*args, **kw),
                [f.name for f in dataclasses.fields(got)],
                f"tick {mid}'s select on {MESH_SHARDS} shards against one "
                f"launch")
    out = {"lanes": lanes, "ticks": n_ticks, "shards": MESH_SHARDS,
           "run_s": run_s, "tick_median_ms": statistics.median(tick_ms),
           "phase30_tick_median_ms": phase30["tick_median_ms"],
           "alert_select": runs[-1]["alert_select"]}
    smi = nvidia_smi_line() if device.type == "cuda" else "cpu"
    if device.type == "cuda":
        blocks, kk = calls[0]
        whole = [torch.cat([c[0][n] for c in calls]) for n in range(8)]
        out["shard_kernel_ms"] = graph_ms(lambda: packed(*blocks, **kk))
        out["whole_kernel_ms"] = graph_ms(lambda: packed(*whole, **kk))
        out["nvidia_smi"] = smi
    say(f"  fleet S={lanes}, T={n_ticks} on {MESH_SHARDS} shards: run "
        f"{run_s:.3f} s, bitwise the unsharded run; alert_select launched "
        f"{out['alert_select']} times ({MESH_SHARDS} a tick); tick {mid}: "
        f"each shard's launch on a view of its block bitwise its plain "
        f"version, the select bitwise one launch over all lanes")
    say(f"  one tick, median: {out['tick_median_ms']:.6f} ms on "
        f"{MESH_SHARDS} shards, {phase30['tick_median_ms']:.6f} ms "
        f"unsharded (phase 30)" + (
            f"; the kernel's device time (CUDA graph): "
            f"{out['shard_kernel_ms']:.6f} ms a shard of {block} lanes, "
            f"{out['whole_kernel_ms']:.6f} ms for one launch over "
            f"{lanes} [{smi}]" if device.type == "cuda" else ""))
    return out


class SteppingClock:
    """A fake clock for ``ServeEngine.generate``: each read advances it by
    a seeded draw from [step/2, 3 step/2), so two servers that read it in
    the same order see the same latencies, and the levels' profiled
    latencies differ."""

    def __init__(self, step: float = 0.004, seed: int = 0):
        import numpy as np

        self.t, self.step = 0.0, step
        self.rng = np.random.default_rng(seed)

    def __call__(self) -> float:
        t = self.t
        self.t += self.step * (0.5 + self.rng.random())
        return t


def mesh_served(device, engine, params, runs: list) -> dict:
    """Phase 37 (c): ``FleetAlertServer(n_streams=6)`` over phase 10's
    engine (alert-anytime-120m at full width and depth, every kernel on
    the path) with a ``MESH_SHARDS``-shard mesh and with ``mesh=None``,
    both reading a stepping fake clock: capacity 8 with the two pad lanes
    dead, one retire and admit, picks, tokens and lane state bitwise
    equal, ``alert_select`` launched ``MESH_SHARDS`` times a tick."""
    import functools

    import numpy as np

    from repro_torch.core.batched import BatchedAlertEngine
    from repro_torch.core.controller import Goal
    from repro_torch.kernels import alert_select as ks
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.serving.alert_server import FleetAlertServer

    mesh = make_lane_mesh(MESH_SHARDS, device=device)
    plain_generate = engine.generate
    levels = engine.levels
    results = {}
    table = None
    try:
        for name, m in (("none", None), ("mesh", mesh)):
            tokens = []

            def recording(*a, _gen=functools.partial(
                    plain_generate, clock=SteppingClock()), **k):
                r = _gen(*a, **k)
                tokens.append(r["tokens"])
                return r

            engine.generate = recording
            srv = FleetAlertServer(
                engine, params, LEVEL_ACCURACIES[:len(levels)],
                Goal.MINIMIZE_ENERGY, n_streams=6, profile_iters=1,
                prompt_len=8, gen_tokens=4, start_active=False, mesh=m)
            if table is None:
                table = srv.table
            srv.table = table            # one table for both servers
            srv.scoring = BatchedAlertEngine(table, srv.goal, mesh=m,
                                             device=device)
            people = tenants(table)[:6]
            for goal, cons in people:
                srv.admit(goal, cons)
            if m is not None and (srv.n_streams != 8 or srv.active[6:].any()):
                raise SmokeFailure(f"sharded server: capacity "
                                   f"{srv.n_streams}, pad lanes live "
                                   f"{srv.active[6:].tolist()}")
            rng = np.random.default_rng(0)
            del tokens[:]
            outs, per_tick = [], []

            def ticks():
                for tick in range(N_TICKS):
                    if tick == 2:
                        srv.retire(4)
                        if srv.admit(*people[1]) != 4:
                            raise SmokeFailure("the admit did not reuse "
                                               "lane 4")
                    # Eight prompts a tick for both servers (the mesh's
                    # capacity); the unsharded one takes the first six.
                    prompts = [rng.integers(0, engine.model.cfg.vocab,
                                            (4, 8)).astype(np.int32)
                               for _ in range(8)][:srv.n_streams]
                    n0 = ks.alert_select.launches
                    outs.append(srv.serve_tick(prompts)[:6])
                    per_tick.append(ks.alert_select.launches - n0)

            counted_run(ticks, runs)
            state = {n: np.asarray(getattr(b, n).cpu()) for b, names in (
                (srv.slowdown, ("mu", "sigma", "n_updates")),
                (srv.idle_power, ("phi",))) for n in names}
            state["goal"] = np.asarray(srv._goal_bank.current_goal().cpu())
            results[name] = (outs, [np.array(t) for t in tokens],
                             per_tick, {k: v[:6] for k, v in state.items()})
    finally:
        engine.generate = plain_generate
    (o1, t1, p1, s1), (o2, t2, p2, s2) = results["none"], results["mesh"]
    if o1 != o2:
        raise SmokeFailure("sharded server: served inputs differ from "
                           "mesh=None's")
    if len(t1) != len(t2) or any(not np.array_equal(a, b)
                                 for a, b in zip(t1, t2)):
        raise SmokeFailure("sharded server: tokens differ from mesh=None's")
    for k in s1:
        if not np.array_equal(s1[k], s2[k]):
            raise SmokeFailure(f"sharded server: lane state {k} differs")
    card = device.type == "cuda"
    if p2 != [MESH_SHARDS if card else 0] * N_TICKS or \
            p1 != [1 if card else 0] * N_TICKS:
        raise SmokeFailure(f"sharded server: alert_select launches a tick "
                           f"{p2} (mesh=None {p1})")
    levels_seen = sorted({o.level for row in o2 for o in row if o})
    say(f"  FleetAlertServer(n_streams=6) over {engine.model.cfg.name} "
        f"({engine.model.cfg.n_layers} layers, d={engine.model.cfg.d_model},"
        f" {engine.model.cfg.dtype}) on {MESH_SHARDS} shards: capacity 8, "
        f"pad lanes dead, lane 4 retired and readmitted; {N_TICKS} ticks, "
        f"{len(t2)} generations, levels {levels_seen}: picks, tokens and "
        f"lane state bitwise mesh=None's; alert_select a tick {p2}")
    return {"ticks": N_TICKS, "generations": len(t2), "launches": p2,
            "levels": levels_seen}


def mesh_gateway_restore(device, runs: list) -> dict:
    """Phase 37 (d): ``bench_traffic``'s workload at ``MESH_GW_LOAD`` on
    a ``SessionGateway`` with a ``MESH_SHARDS``-shard mesh, checkpointed
    and killed at iteration ``MESH_KILL_AT``, then resumed on half the
    shards (``remesh_lanes``) and on ``mesh=None``: both bitwise the
    uninterrupted unsharded run, each launch count the rounds it served
    times its shards."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.runtime.elastic import remesh_lanes
    from repro_torch.runtime.ft import InjectedFailure
    from repro_torch.serving.scenarios import (TRAFFIC_LANES, golden_table,
                                               traffic_sessions)
    from repro_torch.traffic import SessionGateway, generate_requests

    table = golden_table()
    sessions, dl, _ = traffic_sessions(table, MESH_GW_LOAD)
    four = make_lane_mesh(MESH_SHARDS, device=device)
    half = remesh_lanes(four.devices[:MESH_SHARDS // 2])

    def gateway(mesh):
        return SessionGateway(table, TRAFFIC_LANES, tick=dl / 4,
                              max_queue=4 * TRAFFIC_LANES, device=device,
                              mesh=mesh)

    def run(g, **kw):
        return g.run(sessions, generate_requests(sessions), **kw)

    want = counted_run(lambda: run(gateway(None)), runs)
    check_mesh_launches(runs[-1]["alert_select"], want.n_rounds, device,
                        "uninterrupted run")
    out = {"load": MESH_GW_LOAD, "rounds": want.n_rounds}
    with tempfile.TemporaryDirectory() as td:
        ck = str(Path(td) / "ck")

        def killed():
            try:
                run(gateway(four), checkpoint_dir=ck,
                    checkpoint_every=MESH_CKPT_EVERY,
                    kill_at_round=MESH_KILL_AT)
            except InjectedFailure:
                return True
            return False

        if not counted_run(killed, runs):
            raise SmokeFailure("the sharded gateway was not killed")
        tree, step = ckpt_io.restore_tree(ck)
        before = int(tree["meta"]["n_rounds"])
        for name, mesh in (("2 shards", half), ("mesh=None", None)):
            # A resumed run checkpoints as it goes: each resumes from its
            # own copy of the killed run's checkpoint.
            mine = str(Path(td) / f"ck-{name}")
            shutil.copytree(ck, mine)
            g = gateway(mesh)
            got = counted_run(lambda: g.resume(
                sessions, generate_requests(sessions), checkpoint_dir=mine),
                runs)
            same_gateway_result(got, want, f"resumed on {name}")
            check_mesh_launches(runs[-1]["alert_select"],
                                (got.n_rounds - before)
                                * (1 if mesh is None else mesh.size),
                                device, f"resumed on {name}")
    out.update(resumed_from_iteration=step, rounds_before_kill=before)
    say(f"  bench_traffic at load {MESH_GW_LOAD} ({len(sessions)} sessions, "
        f"{TRAFFIC_LANES} lanes, {want.n_rounds} rounds) on {MESH_SHARDS} "
        f"shards killed at iteration {MESH_KILL_AT}, resumed from the "
        f"checkpoint of iteration {step} ({before} rounds served) on "
        f"{MESH_SHARDS // 2} shards and on mesh=None: both bitwise equal "
        f"to the uninterrupted run")
    return out


def mesh_megatick(device, runs: list, keep: dict, phase32: dict) -> dict:
    """Phase 37 (e): phase 32 (b)'s ``bench_megatick`` cell (its
    workload and graphed result in ``keep``, itself bitwise the host
    gateway's) through a megatick with a ``MESH_SHARDS``-shard mesh:
    bitwise, ``MESH_SHARDS`` ``alert_select`` nodes a round in the graph
    and launches a round.  Prints ``plan_s``, ``scan_s`` and rounds/s
    beside phase 32's."""
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.serving.scenarios import MEGATICK_ROUNDS
    from repro_torch.traffic import MegatickGateway

    card = device.type == "cuda"
    sessions, requests = keep["sessions"], keep["requests"]
    want, table, dl = keep["result"], keep["table"], keep["tick"]
    n_lanes, rounds = phase32["lanes"], MEGATICK_ROUNDS
    gw = MegatickGateway(table, n_lanes, tick=dl, max_queue=4 * n_lanes,
                         chunk=rounds, device=device,
                         mesh=make_lane_mesh(MESH_SHARDS, device=device))
    plan_s = scan_s = float("inf")
    for rep in range(2):                # the first run captures the graph
        res = counted_run(lambda: gw.run(sessions, requests), runs)
        same_gateway_result(res, want, f"the megatick on {MESH_SHARDS} "
                            f"shards against the unsharded one")
        scheduled = -(-res.n_rounds // rounds) * rounds   # pad rounds too
        check_mesh_launches(runs[-1]["alert_select"],
                            MESH_SHARDS * scheduled, device,
                            f"the megatick on {MESH_SHARDS} shards")
        if res.select_launches != runs[-1]["alert_select"]:
            raise SmokeFailure("the megatick's launch count disagrees with "
                               "the counter")
        if rep:
            plan_s, scan_s = gw.last_plan_s, gw.last_scan_s
    nodes = graph_kernels(gw.chunk_graphs()[0]) if card else []
    n_sel = sum("alert_select" in name for name, _ in nodes)
    if card and n_sel != MESH_SHARDS * rounds:
        raise SmokeFailure(f"the sharded megatick graph holds {n_sel} "
                           f"alert_select nodes for {rounds} rounds")
    smi = nvidia_smi_line() if card else "cpu"
    out = {"rounds": res.n_rounds, "plan_s": plan_s, "scan_s": scan_s,
           "round_clock_rounds_per_s": rounds / scan_s,
           "end_to_end_rounds_per_s": rounds / (plan_s + scan_s),
           "graph_kernel_nodes": len(nodes), "graph_select_nodes": n_sel,
           "phase32": {k: phase32[k] for k in (
               "plan_s", "scan_s", "round_clock_rounds_per_s",
               "end_to_end_rounds_per_s", "graph_kernel_nodes")},
           "nvidia_smi": smi}
    say(f"  bench_megatick on {MESH_SHARDS} shards: bitwise the unsharded "
        f"megatick (itself bitwise the host gateway, phase 32); graph "
        f"{len(nodes)} kernel nodes, {n_sel} alert_select "
        f"({MESH_SHARDS} a round)")
    say(f"  plan_s {plan_s:.6f}, scan_s {scan_s:.6f}: "
        f"{out['round_clock_rounds_per_s']:.3f} rounds/s on the round "
        f"clock, {out['end_to_end_rounds_per_s']:.3f} end to end; phase 32 "
        f"unsharded: plan_s {phase32['plan_s']:.6f}, scan_s "
        f"{phase32['scan_s']:.6f}, "
        f"{phase32['round_clock_rounds_per_s']:.3f} and "
        f"{phase32['end_to_end_rounds_per_s']:.3f} rounds/s, "
        f"{phase32['graph_kernel_nodes']} kernel nodes [{smi}]")
    return out


def mesh_dryrun(device, runs: list) -> dict:
    """Phase 37 (f): ``run_fleet_dryrun(*MESH_DRYRUN)`` over a mesh of
    every visible card and over ``MESH_DRYRUN_SHARDS`` shards on
    ``device``: parity with the single-device engine and nothing built
    under churn, both records printed."""
    from repro_torch.launch.fleet_dryrun import run_fleet_dryrun

    out = {}
    cases = [("make_lane_mesh()", {})] if device.type == "cuda" else \
        [(f"one shard on {device}", {"device": device})]
    cases.append((f"{MESH_DRYRUN_SHARDS} shards on {device}",
                  {"n_devices": MESH_DRYRUN_SHARDS, "device": device}))
    for name, kw in cases:
        rec = counted_run(lambda: run_fleet_dryrun(*MESH_DRYRUN, **kw), runs)
        if not (rec["picks_match_single_device"]
                and rec["builds_flat_under_churn"]):
            raise SmokeFailure(f"fleet dry run over {name}: {rec}")
        n_sel = (MESH_DRYRUN[1] + 1) * rec["n_devices"] + 1
        check_mesh_launches(runs[-1]["alert_select"], n_sel, device,
                            f"fleet dry run over {name}")
        out[name] = rec
        say(f"  fleet dry run over {name}: {json.dumps(rec)}")
    return out


def mesh_phase(device, fleet_keep, fleet_out, served, mega_keep,
               mega_out) -> dict:
    """Phase 37: (a)-(f) on ``device``; ``counts`` holds the launches of
    every run."""
    runs = []
    out = {"goldens": mesh_goldens(device, runs),
           "fleet": mesh_fleet(device, runs, fleet_keep, fleet_out),
           "served": mesh_served(device, served["engine"], served["params"],
                                 runs),
           "gateway": mesh_gateway_restore(device, runs),
           "megatick": mesh_megatick(device, runs, mega_keep, mega_out),
           "dryrun": mesh_dryrun(device, runs), "counts": runs}
    return out


# --------------------------------------------------------------------- #
# phase 33: training                                                    #
# --------------------------------------------------------------------- #
# (a): alert-anytime-120m at full width and depth, bf16 params, float32
# moments, the joint anytime loss over 8 x 1024 synthetic tokens a step.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 30, 8, 1024
TRAIN_LR, TRAIN_CKPT_EVERY = 3e-3, 10
# (b): the trained weights served graphed on the kernels must give each
# level's logits of train_logits (blocks projections, ref attention, both
# bf16) on the same prompts within this share of the level's largest
# logit, 4 bf16 ulps of it: the two paths round activations to bf16 at
# other places (flash_attention's P, the fused projections' outputs)
# over 12 layers (under one ulp of it seen, run a1 of PERF.md).
TRAIN_SERVE_TOL = 2.0 ** -5
# (d): the reduced families trained 3 steps in float32 on the card and on
# the CPU, step 1's gradients first held leaf by leaf to GRAD_TOL of each
# leaf's largest magnitude (as tests/test_torch_train_grads.py holds the
# port to the reference); (e): kill at step 7 and resume from the step-6
# checkpoint.
TRAIN_ARCHS = ("alert-anytime-120m", "qwen2.5-14b", "olmoe-1b-7b",
               "jamba-v0.1-52b", "whisper-tiny", "rwkv6-3b")
GRAD_TOL = 2e-5
RESUME_STEPS, RESUME_FAIL_AT, RESUME_CKPT_EVERY = 10, 7, 3
BF16_PEAK_FLOPS = 989e12


def train_step_flops(cfg, batch: int, seq: int) -> float:
    """Operations of one joint anytime train step of the width-nested
    ``cfg`` under full remat, counted from the work the step runs: each
    projection's live stripe blocks (``nested_matmul_flops``, the
    ``blocks`` backend's products), the ``ref`` attention's full S x T
    scores and values (its mask skips no work), and every level's
    unembedding.  The layers run three times forward (the forward and the
    backward's recompute, then twice that for the backward's two
    products), the unembeddings once forward and twice backward."""
    from repro_torch.core.nesting import StripeSpec
    from repro_torch.kernels.nested_matmul import nested_matmul_flops
    from repro_torch.models.attention import head_stripe_specs
    from repro_torch.models.mlp import mlp_stripe_specs

    m = batch * seq
    d_spec, q_spec, kv_spec = head_stripe_specs(cfg)
    _, f_spec = mlp_stripe_specs(cfg)
    proj = (nested_matmul_flops(m, d_spec, q_spec)
            + 2 * nested_matmul_flops(m, d_spec, kv_spec)
            + nested_matmul_flops(m, q_spec, d_spec)
            + 2 * nested_matmul_flops(m, d_spec, f_spec)
            + nested_matmul_flops(m, f_spec, d_spec))
    attn = 4 * batch * seq * seq * cfg.n_heads * cfg.head_dim
    layers = cfg.n_layers * (proj + attn)
    spec = StripeSpec.pow2(cfg.d_model, cfg.nest_levels)
    unembed = sum(2 * m * spec.width(k) * cfg.vocab
                  for k in range(1, cfg.nest_levels + 1))
    return float(4 * layers + 3 * unembed)


def leaf_names(tree, prefix: str = "") -> list[str]:
    """The ``/``-joined path of each leaf of ``tree``, in leaf order."""
    from repro_torch.tree import children

    if tree is None:
        return []
    if isinstance(tree, (dict, list, tuple)):
        return [n for name, child in children(tree)
                for n in leaf_names(child, f"{prefix}/{name}" if prefix
                                    else name)]
    return [prefix]


def grads_close(got, want, names, what: str) -> dict:
    """Step 1's gradients on the card (``got``) against the CPU's
    (``want``), before AdamW acts: every leaf within ``GRAD_TOL`` of its
    largest magnitude (float32 sums in other orders).  Returns the worst
    ratio to that bound and, by leaf, the elements whose two gradients
    differ in sign (zero counting as a sign): gradients below what float32
    resolves in that leaf, rounding noise, which AdamW's first step turns
    into a step of ``lr`` either way."""
    import torch

    from repro_torch.tree import tree_leaves

    worst, noise = 0.0, {}
    for name, a, b in zip(names, tree_leaves(got), tree_leaves(want)):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        bound = GRAD_TOL * float(b.abs().max()) + 1e-12
        err = float((a - b).abs().max())
        if not err <= bound:
            raise SmokeFailure(f"{what}: step-1 gradient of {name} differs "
                               f"by {err:.3e}, past {bound:.3e}")
        worst = max(worst, err / bound)
        flips = int((torch.sign(a) != torch.sign(b)).sum())
        if flips:
            noise[name] = flips
    return {"worst_ratio": worst, "sign_differs": noise}


def params_close(got, want, lr: float, steps: int, what: str, names,
                 noise_leaves=()) -> dict:
    """Two runs' parameters after ``steps`` AdamW steps at peak rate
    ``lr``: at most 0.05 % of the elements more than 2e-6 apart; every
    element within ``0.1 * lr``, but in ``noise_leaves`` within ``2 * lr *
    steps``.  AdamW moves an element by about ``lr * g / (|g| +
    eps)``, so where a gradient is rounding noise the runs step by noise,
    up to ``lr`` each way a step: ``noise_leaves`` are the leaves where
    step 1's gradients on the card and the CPU differ in sign
    (:func:`grads_close`).  Returns, by leaf, the elements beyond 2e-6."""
    from repro_torch.tree import tree_leaves

    n = off = 0
    worst, worst_other, beyond = 0.0, 0.0, {}
    for name, a, b in zip(names, tree_leaves(got), tree_leaves(want)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise SmokeFailure(f"{what}: {name}'s dtype or shape differs")
        d = (a.double().cpu() - b.double().cpu()).abs()
        worst = max(worst, float(d.max()))
        if name not in noise_leaves:
            worst_other = max(worst_other, float(d.max()))
        far = int((d > 2e-6).sum())
        if far:
            beyond[name] = far
        off += far
        n += d.numel()
    if worst > 2 * lr * steps or worst_other > 0.1 * lr or \
            off > 5e-4 * n:
        raise SmokeFailure(f"{what}: params differ by up to {worst:.3e} "
                           f"(bound {2 * lr * steps:.1e} on {noise_leaves}), "
                           f"{worst_other:.3e} elsewhere (bound "
                           f"{0.1 * lr:.1e}), {off} of {n} beyond "
                           f"2e-6 (at most {int(5e-4 * n)}) in {beyond}")
    return {"max_abs_diff": worst, "max_abs_diff_other": worst_other,
            "beyond_2e-6": off, "elements": n, "beyond_by_leaf": beyond}


def train_full(device, cfg=None, steps: int = TRAIN_STEPS,
               batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """Phase 33 (a): ``cfg`` (default ``alert-anytime-120m`` at full width
    and depth, bf16) trained ``steps`` steps through the launcher's
    :func:`~repro_torch.launch.train.train` (the ``Supervisor``, a
    checkpoint every ``TRAIN_CKPT_EVERY`` steps into a temporary
    directory, removed after) with the joint anytime loss on
    ``SyntheticLM(cfg.vocab, seq, batch)``, ``AdamW(cosine_schedule(
    3e-3, warmup=steps // 10, total=steps))``, remat "full",
    ``blocks``/``ref``.
    Prints the median step (CUDA events), tokens/s, TFLOP/s against 989,
    ``max_memory_allocated`` and the losses; fails on a loss that is not
    finite or a mean of the last five not below the first."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.alert_anytime import CONFIG
    from repro_torch.launch.train import train

    cfg = CONFIG if cfg is None else cfg
    card = device.type == "cuda"
    if card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_")
    t0 = time.perf_counter()
    try:
        run = train(cfg, steps=steps, batch=batch, seq=seq, lr=TRAIN_LR,
                    anytime=True, ckpt_dir=os.path.join(ckpt, "ck"),
                    ckpt_every=TRAIN_CKPT_EVERY, device=device)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if card else None
    losses = run.losses
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"training: {len(losses)} losses for {steps} "
                           f"steps, or one not finite: {losses}")
    last5 = statistics.fmean(losses[-5:])
    if not last5 < losses[0]:
        raise SmokeFailure(f"training: the loss did not fall ({losses[0]} "
                           f"at the first step, {last5} over the last 5)")
    med = statistics.median(run.step_ms)
    flops = train_step_flops(cfg, batch, seq)
    n_params = sum(p.numel() for p in param_tensors(run.state.params))
    out = {"model": cfg.name, "params": n_params, "dtype": cfg.dtype,
           "steps": steps, "batch": batch, "seq": seq,
           "median_step_ms": med, "first_step_ms": run.step_ms[0],
           "step_ms": run.step_ms, "tokens_per_s": batch * seq / med * 1e3,
           "flops_per_step": flops, "tflop_s": flops / med / 1e9,
           "share_of_989": flops / med / 1e9 / (BF16_PEAK_FLOPS / 1e12),
           "max_memory_allocated_gb": None if peak is None else peak / 1e9,
           "loss_first": losses[0], "loss_last5_mean": last5,
           "losses": losses, "wall_s": wall,
           "checkpoints": steps // TRAIN_CKPT_EVERY + 1}
    say(f"  {cfg.name} trained {steps} steps ({n_params} parameters, "
        f"{cfg.dtype}, float32 moments, remat {cfg.remat_policy}, B={batch} "
        f"x S={seq}): median step {med:.3f} ms (CUDA events; first "
        f"{run.step_ms[0]:.3f}), {out['tokens_per_s']:.0f} tokens/s, "
        f"{flops / 1e12:.3f} TFLOP a step: {out['tflop_s']:.2f} TFLOP/s "
        f"({out['share_of_989']:.4f} of 989); max_memory_allocated "
        + (f"{peak / 1e9:.3f} GB" if peak is not None else "not measured")
        + f"; loss {losses[0]:.4f} at the first step, {last5:.4f} over the "
          f"last five; {wall:.1f} s with {out['checkpoints']} checkpoints")
    if card:
        out["breakdown"] = train_step_breakdown(cfg, run, steps)
    out["state"], out["model_api"], out["data"] = run.state, run.model, \
        run.data
    return out


def train_step_breakdown(cfg, run, step_index: int) -> dict:
    """One more joint anytime step from ``run``'s state (its result
    dropped) under ``torch.profiler`` (CPU and CUDA activity): the
    step's time between CUDA events, the card's busy time by kind of
    kernel (cuBLAS products, softmax, the rest) and its idle share, and
    the five kernels with the most device time.  The profiler slows the
    host, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import batch_fn
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_anytime_loss_fn, make_train_step

    step = make_train_step(run.model, cfg, AdamW(lr=TRAIN_LR),
                           loss_fn=make_anytime_loss_fn(run.model, cfg))
    batch = batch_fn(run.data, run.state.params["embed"].device)(step_index)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        new_state, _ = step(run.state, batch)
        b.record()
        torch.cuda.synchronize()
    del new_state
    kinds = {"matmul (cuBLAS)": 0.0, "softmax": 0.0, "other": 0.0}
    per_kernel = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if not us or ev.key.startswith(("aten::", "cuda")):
            continue
        kind = "matmul (cuBLAS)" if any(
            p in ev.key for p in KERNEL_KINDS[0][1]) else "softmax" \
            if "softmax" in ev.key.lower() else "other"
        kinds[kind] += us / 1e3
        per_kernel.append((us / 1e3, ev.count, ev.key[:80]))
    busy = sum(kinds.values())
    step_ms = a.elapsed_time(b)
    top = sorted(per_kernel, reverse=True)[:5]
    out = {"step_ms_profiled": step_ms, "busy_ms": busy,
           "idle_share": 1 - busy / step_ms, "by_kind_ms": kinds,
           "kernels": len(per_kernel),
           "launches": sum(c for _, c, _ in per_kernel),
           "top": [{"ms": t, "count": c, "name": n} for t, c, n in top]}
    say(f"  one more step under torch.profiler: {step_ms:.3f} ms, the card "
        f"busy {busy:.3f} ms (idle {out['idle_share']:.4f}, an upper "
        f"bound: the profiler slows the host): "
        + ", ".join(f"{k} {v:.3f}" for k, v in kinds.items())
        + f" ms; {out['launches']} kernel launches; the most time: "
        + "; ".join(f"{n} x{c} {t:.3f} ms" for t, c, n in top))
    return out


def level_accuracies(model, params, data, device, batches: int = 2,
                     first: int = 10_000) -> list[float]:
    """Each level's token accuracy over ``batches`` held-out batches of
    ``data`` (steps ``first`` on), with ``train_logits(level=k)``."""
    import torch

    from repro_torch.launch.train import batch_fn
    from repro_torch.train.losses import token_accuracy

    batch_at = batch_fn(data, device)
    cfg = model.cfg
    accs = [0.0] * cfg.nest_levels
    with torch.no_grad():
        for b in range(batches):
            evalb = batch_at(first + b)
            for k in range(1, cfg.nest_levels + 1):
                logits, _ = model.train_logits(params, evalb, level=k)
                accs[k - 1] += float(token_accuracy(
                    logits, evalb["labels"])) / batches
    return accs


def graphed_call(device, fn):
    """``fn()``'s result, on the card from a CUDA graph of it (a warm-up
    call on a side stream, the capture, one replay), else called eagerly."""
    import torch

    if device.type != "cuda":
        return fn()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    graph.replay()
    torch.cuda.synchronize(device)
    return got


def served_logits_vs_train(device, model, params, prompts,
                           tol: float = TRAIN_SERVE_TOL) -> dict:
    """Phase 33 (b): for each level, the serving prefill forward
    (``nest_backend="kernel"``, ``attn_backend="kernel"``) captured in a
    CUDA graph on the card and replayed, against ``model.train_logits
    (level=k)`` (``blocks``/``ref``) on the same ``prompts``: within
    ``tol`` of the level's largest logit, and the last position's argmax
    counted where it agrees."""
    import torch

    from repro_torch.models import transformer as tfm

    cfg = model.cfg.replace(nest_backend="kernel", attn_backend="kernel")
    out = {}
    with torch.inference_mode():
        static = prompts.clone()
        for k in range(1, cfg.nest_levels + 1):
            want, _ = model.train_logits(params, {"tokens": prompts},
                                         level=k)

            got = graphed_call(device, lambda k=k: tfm.lm_apply(
                params, cfg, static, mode="prefill", level=k).logits)
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            same = float((got[:, -1].argmax(-1) == want[:, -1].argmax(-1))
                         .float().mean())
            out[f"level_{k}"] = {"max_abs_diff": err, "max_abs_logit": scale,
                                 "last_argmax_agree": same}
            if not err <= tol * scale:
                raise SmokeFailure(f"level {k}: the served logits differ "
                                   f"from train_logits by {err:.4e}, past "
                                   f"{tol} x {scale:.4e}")
    say("  served (kernels, graphed prefill) vs train_logits (blocks/ref), "
        "bf16, B=%d S=%d: " % tuple(prompts.shape) + "; ".join(
            f"L{k[-1]} max diff {v['max_abs_diff']:.4e} of "
            f"{v['max_abs_logit']:.3f}, argmax {v['last_argmax_agree']:.2f}"
            for k, v in out.items()) + f" (tolerance {tol} of the largest)")
    return out


def kernel_counts(reset: bool = False) -> dict:
    """The four model kernels' and ``alert_select``'s launch counters (set
    to 0 first with ``reset``)."""
    from repro_torch.kernels import alert_select as ks
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nested_matmul as nm
    from repro_torch.kernels import rwkv_scan as rs

    fns = {"alert_select": ks.alert_select,
           "nested_matmul": nm.nested_matmul,
           "flash_attention": fa.flash_attention,
           "decode_attention": da.decode_attention,
           "rwkv_scan": rs.rwkv_scan}
    if reset:
        for f in fns.values():
            f.launches = 0
    return {name: f.launches for name, f in fns.items()}


def example_run(device, train_steps: int = 200, requests: int = 60) -> dict:
    """Phase 33 (c): ``examples/serve_alert_torch.py`` with its defaults
    (its two checks raise); the kernels' launches counted over the run."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "serve_alert_torch", ROOT / "examples" / "serve_alert_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernel_counts(reset=True)              # this run starts here
    t0 = time.perf_counter()
    out = mod.main(["--train-steps", str(train_steps), "--requests",
                    str(requests), "--device", str(device)])
    counts = kernel_counts()               # and ends here
    out["counts"], out["wall_s"] = counts, time.perf_counter() - t0
    if device.type == "cuda" and not all(
            counts[k] for k in ("alert_select", "nested_matmul",
                                "flash_attention", "decode_attention")):
        raise SmokeFailure(f"serve_alert_torch: a kernel never launched: "
                           f"{counts}")
    say(f"  serve_alert_torch: loss {out['losses'][0]:.3f} -> "
        f"{out['losses'][-1]:.3f} in {train_steps} steps, accuracies "
        f"{[round(a, 3) for a in out['accuracies']]}, mean level loose / "
        f"tight {out['mean_level'][0]:.2f} / {out['mean_level'][1]:.2f}, "
        f"launches {counts}, {out['wall_s']:.1f} s")
    return out


def train_batches(cfg, steps: int, batch: int = 4, seq: int = 16) -> list:
    """``steps`` synthetic batches (numpy); an encoder-decoder's carry
    seeded frames ``[batch, 10, d]``."""
    import numpy as np

    from repro_torch.data.synthetic import SyntheticLM

    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    out = []
    for i in range(steps):
        b = data.batch_at(i)
        if cfg.encoder_layers:
            b["frames"] = np.random.default_rng(i).standard_normal(
                (batch, 10, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def train_cpu_vs_card(device, archs=TRAIN_ARCHS, steps: int = 3) -> dict:
    """Phase 33 (d): each reduced config of ``archs`` in float32, the same
    seed-0 weights, ``steps`` train steps (the joint anytime loss for the
    anytime LM) on the card and on the CPU; step 1's gradients held leaf
    by leaf by :func:`grads_close`, then the parameters by
    :func:`params_close`, the 2-lr bound kept for the leaves whose step-1
    gradients differ in sign; olmoe's routed expert ids equal in every
    call."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import (init_train_state, make_anytime_loss_fn,
                                        make_loss_fn, make_train_step,
                                        value_and_grad)

    cpu = torch.device("cpu")
    out = {}
    for arch in archs:
        cfg = get_reduced(arch).replace(dtype="float32")
        model = build_model(cfg)
        loss_fn = make_anytime_loss_fn(model, cfg) if cfg.nest_levels > 1 \
            else make_loss_fn(model, cfg)
        batches = train_batches(cfg, steps)
        states, routes, grads = [], [], []
        for dev in (cpu, device):
            opt = AdamW(lr=cosine_schedule(TRAIN_LR, 1, steps))
            params = copy_params(model.init(torch.Generator().manual_seed(0),
                                            device=cpu), dev)
            on_dev = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                      for b in batches]
            _, g = value_and_grad(loss_fn, params, on_dev[0])
            grads.append(g)
            state = init_train_state(model, cfg, opt, params=params)
            step = make_train_step(model, cfg, opt, loss_fn=loss_fn)
            with recording_routes() as seen:
                for b in on_dev:
                    state, _ = step(state, b)
            states.append(state)
            routes.append([r.cpu() for r in seen])
        if len(routes[0]) != len(routes[1]) or not all(
                torch.equal(a, b) for a, b in zip(*routes)):
            raise SmokeFailure(f"{arch}: routed expert ids differ between "
                               f"the CPU and the card")
        names = leaf_names(states[0].params)
        g = grads_close(grads[1], grads[0], names,
                        f"{arch} step-1 gradients card vs CPU")
        noise = sorted(g["sign_differs"])
        o = out[arch] = params_close(states[1].params, states[0].params,
                                     TRAIN_LR, steps,
                                     f"{arch} card vs CPU", names, noise)
        o["route_calls"], o["grads"] = len(routes[0]), g
        say(f"  {arch} reduced, float32: step-1 gradients card vs CPU "
            f"within {GRAD_TOL} of each leaf's largest (worst "
            f"{g['worst_ratio']:.3f} of the bound), differing in sign at "
            f"{g['sign_differs'] or 'no element'}; after {steps} train "
            f"steps params max diff {o['max_abs_diff']:.3e} (bound "
            f"{2 * TRAIN_LR * steps:.1e} on those leaves, "
            f"{0.1 * TRAIN_LR:.1e} elsewhere: "
            f"{o['max_abs_diff_other']:.3e}), {o['beyond_2e-6']} of "
            f"{o['elements']} beyond 2e-6, in "
            f"{o['beyond_by_leaf'] or 'no leaf'}"
            + (f", routed ids equal in {len(routes[0])} calls"
               if routes[0] else ""))
    beyond = sorted({f"{a}:{n}" for a, o in out.items()
                     for n in o["beyond_by_leaf"]})
    noise = sorted({f"{a}:{n}" for a, o in out.items()
                    for n in o["grads"]["sign_differs"]})
    say(f"  evidence: the elements beyond 2e-6 lie in {len(beyond)} leaves "
        f"({', '.join(beyond) or 'none'}); step 1's gradients differ in "
        f"sign only in {', '.join(noise) or 'no leaf'}; every other leaf "
        f"within 0.1 lr = {0.1 * TRAIN_LR:.1e} (largest "
        f"{max(o['max_abs_diff_other'] for o in out.values()):.3e})")
    return out


def train_resume(device) -> dict:
    """Phase 33 (e): the reduced anytime LM (bf16) trained
    ``RESUME_STEPS`` steps through the launcher, once whole and once
    crashed at step ``RESUME_FAIL_AT`` with a checkpoint every
    ``RESUME_CKPT_EVERY`` steps, under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (the
    embedding's backward accumulates with atomics otherwise; cuBLAS's
    workspace is fixed by ``CUBLAS_WORKSPACE_CONFIG``, set before it
    starts): the end states bitwise equal."""
    import shutil
    import tempfile
    import warnings

    import torch

    from repro_torch.configs.alert_anytime import reduced
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves

    cfg = reduced()
    tmp = tempfile.mkdtemp(prefix="resume_ckpt_")
    before = torch.are_deterministic_algorithms_enabled()
    runs = []
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name, fail in (("whole", None), ("crashed", RESUME_FAIL_AT)):
                runs.append(train(cfg, steps=RESUME_STEPS, batch=4, seq=32,
                                  lr=8e-3, anytime=True,
                                  ckpt_dir=os.path.join(tmp, name),
                                  ckpt_every=RESUME_CKPT_EVERY,
                                  fail_at=fail, device=device,
                                  log_every=0))
    finally:
        torch.use_deterministic_algorithms(before)
        shutil.rmtree(tmp, ignore_errors=True)
    nondet = sorted({str(w.message).split("\n")[0][:120] for w in caught
                     if "deterministic" in str(w.message)})
    whole, crashed = runs
    leaves = list(zip(tree_leaves(whole.state), tree_leaves(crashed.state)))
    equal = all(torch.equal(a, b) for a, b in leaves)
    rerun = len(crashed.losses) - len(whole.losses)
    say(f"  reduced anytime LM (bf16), crash at step {RESUME_FAIL_AT}, "
        f"checkpoint every {RESUME_CKPT_EVERY}: {rerun} steps rerun, end "
        f"state {'bitwise equal' if equal else 'NOT equal'} to the "
        f"uninterrupted run's over {len(leaves)} leaves; ops without a "
        f"deterministic CUDA version: {nondet or 'none'}")
    if not equal or crashed.end != whole.end or \
            crashed.losses[-3:] != whole.losses[-3:]:
        raise SmokeFailure("kill and resume on the card is not bitwise the "
                           "uninterrupted run")
    return {"bitwise": equal, "rerun_steps": rerun,
            "nondeterministic_ops": nondet}


def training_phase(device, full_cfg=None, steps: int = TRAIN_STEPS,
                   seq: int = TRAIN_SEQ, example_steps: int = 200) -> dict:
    """Phase 33, (a)-(e), on ``device``; ``counts`` holds the launches of
    (b)'s fleet run and of (c)."""
    import torch

    from repro_torch.tree import tree_map

    out = {}
    say("  (a) full-width training")
    a = train_full(device, full_cfg, steps=steps, seq=seq)
    state, model, data = a.pop("state"), a.pop("model_api"), \
        a.pop("data")
    out["train"] = a
    say("  (b) the trained weights served on the kernels")
    params = tree_map(lambda t: t.detach(), state.params)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    accs = level_accuracies(model, params, data, device)
    say(f"  held-out accuracies by level: {[round(x, 5) for x in accs]}")
    prompts = torch.from_numpy(data.batch_at(20_000)["tokens"][:4, :8]).to(
        device)
    out["served_vs_train"] = served_logits_vs_train(device, model, params,
                                                    prompts)
    serve_cfg = model.cfg.replace(nest_backend="kernel",
                                  attn_backend="kernel")
    run = serve(device, serve_cfg, params=params, level_accuracies=accs,
                expect_kernel=device.type == "cuda")
    out["serve"] = {"accuracies": accs, "tick_s": run["tick_s"],
                    "alert_select_launches": run["launches"]}
    counts = [run_counts(run)]
    del run, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    say("  (c) examples/serve_alert_torch.py")
    ex = example_run(device, train_steps=example_steps)
    counts.append(ex.pop("counts"))
    out["example"] = {k: ex[k] for k in ("losses", "accuracies",
                                         "mean_level", "wall_s")}
    out["example"]["losses"] = [ex["losses"][0], ex["losses"][-1]]
    say("  (d) reduced families, card vs CPU")
    out["cpu_vs_card"] = train_cpu_vs_card(device)
    say("  (e) kill and resume")
    out["resume"] = train_resume(device)
    out["counts"] = counts
    return out


# --------------------------------------------------------------------- #
# phase 38: the data plane's (data, model) grid                         #
# --------------------------------------------------------------------- #
# (b)-(c): the full-width anytime LM on a (2, 2) grid of shards on the
# card, GRID_STEPS steps of phase 33's data (B=8 x S=1024); (e): the
# reference's mini dry run (tests/test_distributed.py) on a (4, 2) grid.
GRID_STEPS = 3
GRID_MP, GRID_SHARDS = 2, 4
GRID_ARCHS = ("gemma3-1b", "jamba-v0.1-52b", "rwkv6-3b")
GRID_DRYRUN_MP, GRID_DRYRUN_SHARDS, GRID_DRYRUN_BATCH = 2, 8, (8, 32)


def grid_state_bytes(state, mesh) -> list[int]:
    """Each grid coordinate's bytes of the state's blocks, in the grid's
    row-major order."""
    import numpy as np

    from repro_torch.tree import tree_leaves

    return [sum(leaf.parts[idx].numel() * leaf.parts[idx].element_size()
                for leaf in tree_leaves(state))
            for idx in np.ndindex(mesh.shape)]


def grid_rules() -> dict:
    """Phase 38 (a): every arch of ``ALL_IDS`` at its full config with its
    AdamW state on ``meta`` (nothing placed), ``param_shardings`` on
    ``make_production_mesh(device="meta")`` and ``multi_pod=True``: every
    spec of rank at most its leaf's; the per-device bytes of params plus
    AdamW state reckoned by ``shard_shape``; each (arch, shape) cell's
    ``cell_supported`` and ``projected_memory_bytes`` memory term at 3.35
    TB/s."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES, cell_supported
    from repro_torch.launch import roofline
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_production_mesh, shard_shape
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves, tree_map_with_path

    meshes = {"16x16": make_production_mesh(device="meta"),
              "2x16x16": make_production_mesh(multi_pod=True,
                                              device="meta")}
    out = {}
    for arch in configs.ALL_IDS:
        cfg = configs.get_config(arch)
        params = build_model(cfg).init(device="meta")
        state = (params, AdamW().init(params))
        rec = out[arch] = {"params": sum(p.numel()
                                         for p in tree_leaves(params))}
        leaves = tree_leaves(state)
        if any(x.device.type != "meta" for x in leaves):
            raise SmokeFailure(f"{arch}: abstract state allocated a leaf")
        for name, mesh in meshes.items():
            places = tree_leaves(sh.param_shardings(cfg, mesh, state))
            bad = []

            def rank_ok(path, leaf):
                if len(sh.spec_for(cfg, path, leaf)) > leaf.dim():
                    bad.append("/".join(path))

            tree_map_with_path(rank_ok, state)
            if bad:
                raise SmokeFailure(f"{arch} on {name}: specs of rank past "
                                   f"their leaf's: {bad}")
            rec[f"bytes_per_device_{name}"] = int(sum(
                int(np.prod(shard_shape(p.spec, mesh, x.shape)))
                * x.element_size() for p, x in zip(places, leaves)))
            rec[f"sharded_leaves_{name}"] = sum(
                any(e is not None for e in p.spec) for p in places)
        cells = {}
        for sname, shape in SHAPES.items():
            ok, _ = cell_supported(cfg, shape)
            cells[sname] = {"supported": ok, "memory_ms": None if not ok
                            else roofline.projected_memory_bytes(
                                cfg, shape, 256) / roofline.HBM_BW * 1e3}
        rec["cells"] = cells
        say(f"  {arch}: {rec['params']} params; params + AdamW state a "
            f"device {rec['bytes_per_device_16x16'] / 1e9:.4f} GB on "
            f"16x16, {rec['bytes_per_device_2x16x16'] / 1e9:.4f} GB on "
            f"2x16x16 (shard_shape); projected memory term at 3.35 TB/s "
            f"on 256: " + ", ".join(
                f"{s} {c['memory_ms']:.4f} ms" if c["supported"]
                else f"{s} skipped" for s, c in cells.items()))
    return out


def grid_train(device, cfg=None, steps: int = GRID_STEPS,
               batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """Phase 38 (b)-(c): ``cfg`` (default ``alert-anytime-120m`` whole,
    bf16) with weights from a seed-0 generator on ``device``, ``steps``
    steps of the joint anytime loss on ``SyntheticLM(cfg.vocab, seq,
    batch)`` with phase 33's optimizer, on ``make_host_mesh(GRID_MP,
    devices=[device] * GRID_SHARDS)`` (2 x 2) beside the unsharded
    ``microbatches=2`` step, under deterministic algorithms: the loss and
    every leaf bitwise after each step.  (c): the grid run checkpointed
    after step 2, restored onto ``remesh([device] * 2, 1)`` (2 x 1) by
    ``restore(shardings=param_shardings(...))`` and onto no grid, step 3
    run on each: bitwise the uninterrupted run.  Returns the results and,
    under ``_keep``, the joined params, the model and the data."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs.alert_anytime import CONFIG
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import batch_fn
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.elastic import remesh
    from repro_torch.train.step import (init_train_state, make_anytime_loss_fn,
                                        make_grid_train_step, make_train_step)
    from repro_torch.tree import tree_leaves, tree_map

    cfg = CONFIG if cfg is None else cfg
    card = device.type == "cuda"
    model = build_model(cfg)
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, warmup=steps // 10,
                                   total=steps))
    loss_fn = make_anytime_loss_fn(model, cfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    batch_at = batch_fn(data, device)
    state = init_train_state(model, cfg, opt, torch.Generator(
        device=device).manual_seed(0), device=device)
    mesh = make_host_mesh(GRID_MP, devices=[device] * GRID_SHARDS)
    grid = tree_map(lambda leaf, where: where.place(leaf), state,
                    sh.param_shardings(cfg, mesh, state))
    per_shard = grid_state_bytes(grid, mesh)
    g_step = make_grid_train_step(model, cfg, opt, mesh, loss_fn=loss_fn)
    u_step = make_train_step(model, cfg, opt, microbatches=GRID_MP,
                             loss_fn=loss_fn)
    names = leaf_names(state)

    def timed(fn, *args):
        if not card:
            t0 = time.perf_counter()
            out = fn(*args)
            return out, (time.perf_counter() - t0) * 1e3
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fn(*args)
        b.record()
        torch.cuda.synchronize(device)
        return out, a.elapsed_time(b)

    def differing(got, want) -> dict:
        """The leaves of two states that are not bitwise equal, each with
        its largest difference."""
        out = {}
        for name, x, y in zip(names, tree_leaves(got), tree_leaves(want)):
            x = x.full(device) if hasattr(x, "full") else x
            if not torch.equal(x, y):
                out[name] = float((x.double() - y.double()).abs().max())
        return out

    tmp = tempfile.mkdtemp(prefix="grid_ckpt_")
    ckpt = os.path.join(tmp, "ck")
    before = torch.are_deterministic_algorithms_enabled()
    grid_ms, plain_ms, losses, diffs = [], [], [], []
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        for i in range(steps):
            b = batch_at(i)
            (grid, gm), g_ms = timed(g_step, grid, b)
            (state, um), u_ms = timed(u_step, state, b)
            grid_ms.append(g_ms)
            plain_ms.append(u_ms)
            losses.append(float(gm["loss"]))
            d = differing(grid, state)
            if not torch.equal(gm["loss"], um["loss"]):
                d["loss"] = abs(float(gm["loss"]) - float(um["loss"]))
            diffs.append(d)
            if i == steps - 2:
                ckpt_io.save(ckpt, grid, step=i + 1)
        if not all(math.isfinite(x) for x in losses):
            raise SmokeFailure(f"grid training: a loss is not finite: "
                               f"{losses}")
        if any(diffs):
            say(f"  NOT bitwise: the leaves differing from the unsharded "
                f"microbatches={GRID_MP} step, with their largest "
                f"difference, by step: {diffs}; held to phase 33 (d)'s "
                f"bounds")
            params_close(tree_map(lambda s: s.full(device), grid.params),
                         state.params, TRAIN_LR, steps, "grid vs unsharded",
                         leaf_names(state.params))
        say(f"  {cfg.name} on a {mesh.shape} grid of shards on {device} "
            f"(bf16 params, float32 moments, B={batch} x S={seq}), "
            f"{steps} steps: loss and every one of {len(names)} leaves "
            + ("bitwise equal" if not any(diffs) else "within bounds")
            + f" to the unsharded microbatches={GRID_MP} step after each "
              f"step; losses {[round(x, 4) for x in losses]}; a shard's "
              f"bytes of state {per_shard}; step "
              f"{[round(t, 3) for t in grid_ms]} ms on the grid, "
              f"{[round(t, 3) for t in plain_ms]} ms unsharded "
              f"(deterministic algorithms; phase 33's step 370.8-595.6 ms)")

        # (c): resume the step-2 checkpoint on the survivors' grid and on
        # no grid
        abstract = init_train_state(model, cfg, opt, device="meta")
        survivors = remesh([device] * 2, model_parallel=1)
        last = batch_at(steps - 1)
        resumed, at = ckpt_io.restore(ckpt, abstract, shardings=
                                      sh.param_shardings(cfg, survivors,
                                                         abstract))
        resumed, _ = make_grid_train_step(model, cfg, opt, survivors,
                                          loss_fn=loss_fn)(resumed, last)
        on_remesh = differing(resumed, state)
        del resumed
        plain, _ = ckpt_io.restore(ckpt, abstract, shardings=tree_map(
            lambda _: device, abstract))
        plain, _ = u_step(plain, last)
        on_none = differing(plain, state)
        del plain
    finally:
        torch.use_deterministic_algorithms(before)
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"  resumed from the step-{at} checkpoint on remesh's "
        f"{survivors.shape} grid and on no grid (microbatches={GRID_MP}): "
        f"step {steps} "
        + ("bitwise equal" if not (on_remesh or on_none) else
           f"differs: {on_remesh} / {on_none}")
        + " to the uninterrupted run")
    if on_remesh or on_none:
        raise SmokeFailure("the grid run resumed on another grid or none is "
                           "not bitwise the uninterrupted run")
    params = tree_map(lambda s: s.full(device), grid.params)
    del grid, state
    return {"model": cfg.name, "grid": list(mesh.shape), "steps": steps,
            "batch": batch, "seq": seq, "losses": losses,
            "bitwise": not any(diffs), "differing_by_step": diffs,
            "grid_step_ms": grid_ms, "plain_step_ms": plain_ms,
            "shard_state_bytes": per_shard, "resumed_on": list(
                survivors.shape), "resume_bitwise": True,
            "_keep": (model, params, data)}


def grid_served(device, model, params, data) -> dict:
    """Phase 38 (d): the grid-trained weights, joined on ``device``, with
    both kernel backends: each level's graphed prefill logits against
    ``train_logits`` (``served_logits_vs_train``, phase 33's tolerance),
    then 4 ticks of ``FleetAlertServer`` (``serve``), in which
    ``nested_matmul``, ``flash_attention``, ``decode_attention`` and
    ``alert_select`` must launch."""
    import torch

    prompts = torch.from_numpy(data.batch_at(20_000)["tokens"][:4, :8]).to(
        device)
    out = {"served_vs_train": served_logits_vs_train(device, model, params,
                                                     prompts)}
    run = serve(device, model.cfg.replace(nest_backend="kernel",
                                          attn_backend="kernel"),
                params=params, expect_kernel=device.type == "cuda")
    counts = run_counts(run)
    if device.type == "cuda" and not all(
            counts[k] for k in ("alert_select", "nested_matmul",
                                "flash_attention", "decode_attention")):
        raise SmokeFailure(f"the grid-trained weights: a kernel never "
                           f"launched: {counts}")
    say(f"  grid-trained weights served 4 ticks: launches {counts}")
    out.update(tick_s=run["tick_s"], counts=counts)
    return out


def grid_mini_dryrun(device) -> dict:
    """Phase 38 (e): the reference's mini dry run
    (``tests/test_distributed.py``): ``GRID_ARCHS`` reduced, float32,
    vocab 64, a seeded ``[8, 32]`` batch, ``AdamW(lr=1e-3)``, 3 steps on
    a (4, 2) grid of shards on ``device`` beside the unsharded
    ``microbatches=4`` step, under deterministic algorithms: every loss
    finite, the last not above the first, and each step bitwise."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import (init_train_state,
                                        make_grid_train_step, make_train_step)
    from repro_torch.tree import tree_leaves, tree_map

    mesh = make_host_mesh(GRID_DRYRUN_MP,
                          devices=[device] * GRID_DRYRUN_SHARDS)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 64, GRID_DRYRUN_BATCH)
                                 .astype(np.int32)).to(device)
             for k in ("tokens", "labels")}
    out = {}
    before = torch.are_deterministic_algorithms_enabled()
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        for arch in GRID_ARCHS:
            cfg = get_reduced(arch).replace(dtype="float32", vocab=64)
            model, opt = build_model(cfg), AdamW(lr=1e-3)
            state = init_train_state(model, cfg, opt, torch.Generator(
                device=device).manual_seed(0), device=device)
            grid = tree_map(lambda leaf, where: where.place(leaf), state,
                            sh.param_shardings(cfg, mesh, state))
            g_step = make_grid_train_step(model, cfg, opt, mesh)
            u_step = make_train_step(model, cfg, opt,
                                     microbatches=mesh.axis_size("data"))
            losses, equal = [], True
            for _ in range(3):
                grid, gm = g_step(grid, batch)
                state, um = u_step(state, batch)
                losses.append(float(gm["loss"]))
                equal &= torch.equal(gm["loss"], um["loss"]) and all(
                    torch.equal(a.full(device), b) for a, b in
                    zip(tree_leaves(grid), tree_leaves(state)))
            ok = all(math.isfinite(x) for x in losses) and \
                losses[-1] < losses[0] + 1e-6
            out[arch] = {"losses": losses, "bitwise": equal}
            say(f"  {arch} reduced on a {mesh.shape} grid: losses "
                f"{[round(x, 5) for x in losses]}"
                + (", finite and not rising" if ok else ", FAILED")
                + f"; {'bitwise equal' if equal else 'NOT equal'} to the "
                  f"unsharded microbatches={mesh.axis_size('data')} step")
            if not (ok and equal):
                raise SmokeFailure(f"{arch} on the grid: {out[arch]}")
    finally:
        torch.use_deterministic_algorithms(before)
    return out


def grid_phase(device) -> dict:
    """Phase 38, (a)-(e), on ``device``; ``counts`` holds (d)'s launches."""
    import torch

    say("  (a) the sharding rules over the zoo at full size, on meta")
    out = {"rules": grid_rules()}
    say("  (b) the grid train step at full width, (c) elastic resume")
    t = grid_train(device)
    model, params, data = t.pop("_keep")
    out["train"] = t
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    say("  (d) the grid-trained weights served on the kernels")
    served = grid_served(device, model, params, data)
    out["counts"] = [served.pop("counts")]
    out["served"] = served
    del params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    say("  (e) the reference's mini dry run on a grid of shards")
    out["mini_dryrun"] = grid_mini_dryrun(device)
    return out


# --------------------------------------------------------------------- #
# phase 39: the data plane's dry run                                     #
# --------------------------------------------------------------------- #
# (a) the count of alert-anytime-120m at full width on meta and on the
# card: train at DRYRUN_TRAIN (batch x tokens), prefill and decode at
# phase 10's served sizes (batch 4, an 8-token prompt, a 12-slot cache).
DRYRUN_TRAIN = (8, 512)
DRYRUN_SERVED = (4, 8, 12)
# The ops the two devices' counts may differ by, by step kind: op ->
# (FLOPs, bytes) of the card's count less meta's.  None has shown.
DRYRUN_PINNED: dict = {"train": {}, "prefill": {}, "decode": {}}
# (b) the kernel path's steps timed back to back, ``cuda_ms``'s rounds.
DRYRUN_TIMED_CALLS = 10
# No card beats its roofline bound: measured / bound below this fails.
DRYRUN_BOUND_FLOOR = 0.95
# (c) ``--all --mesh both`` took 75 s on one core of an Intel Xeon, over
# the 60 s this phase allows it, so the phase counts the 16x16 grid only
# (57 s on that core).
DRYRUN_MESHES = (False,)


def dryrun_shapes():
    from repro_torch.configs.shapes import ShapeSpec

    b, s = DRYRUN_TRAIN
    sb, prompt, cache = DRYRUN_SERVED
    return {"train": ShapeSpec(f"train_{b}x{s}", s, b, "train"),
            "prefill": ShapeSpec(f"served_prefill_{sb}x{prompt}", prompt,
                                 sb, "prefill"),
            "decode": ShapeSpec(f"served_decode_{sb}x{cache}", cache, sb,
                                "decode")}


def dryrun_on_device(device, cfg=None) -> dict:
    """Phase 39 (a): the dry run's counter over the real step of ``cfg``
    (default ``alert-anytime-120m``; seeded weights and batch) on
    ``device`` on the plain paths, on a grid of 1, against the same count
    on ``meta``: the FLOPs, bytes and argument bytes must be equal, each
    op's count equal but for ``DRYRUN_PINNED``."""
    import numpy as np

    from repro_torch.configs.alert_anytime import CONFIG
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import GridMesh

    cfg = CONFIG if cfg is None else cfg

    def grid(dev):
        return GridMesh(np.array([[dev]], dtype=object), ("data", "model"))

    out = {}
    for kind, shape in dryrun_shapes().items():
        meta = dr.count_step(cfg, shape, grid("meta"))
        card = dr.count_step(cfg, shape, grid(device), device=device)
        zero = [0, 0, 0]
        diff = {op: (card["by_op"].get(op, zero)[0]
                     - meta["by_op"].get(op, zero)[0],
                     card["by_op"].get(op, zero)[1]
                     - meta["by_op"].get(op, zero)[1])
                for op in sorted(set(meta["by_op"]) | set(card["by_op"]))}
        diff = {op: d for op, d in diff.items() if d != (0, 0)}
        pinned = {op: tuple(d) for op, d in DRYRUN_PINNED[kind].items()}
        if diff != pinned:
            raise SmokeFailure(f"dry run {kind}: the {device} count differs "
                               f"from meta's by op (FLOPs, bytes) {diff}, "
                               f"pinned {pinned}")
        moved = (card["flops"] - meta["flops"], card["bytes"] - meta["bytes"],
                 card["memory"]["argument_size"]
                 - meta["memory"]["argument_size"])
        if moved != (sum(d[0] for d in diff.values()),
                     sum(d[1] for d in diff.values()), 0):
            raise SmokeFailure(f"dry run {kind}: the {device} count less "
                               f"meta's is {moved} (FLOPs, bytes, argument "
                               f"bytes)")
        say(f"  {kind} {shape.name}: FLOPs {meta['flops']:.0f}, bytes "
            f"{meta['bytes']:.0f}, argument bytes "
            f"{meta['memory']['argument_size']:.0f}, on meta and on "
            f"{device}: equal ({len(meta['by_op'])} kinds of op; count "
            f"{meta['compile_s']:.2f} s on meta, {card['compile_s']:.2f} s "
            f"on {device})")
        out[kind] = {"shape": shape.name, "flops": meta["flops"],
                     "bytes": meta["bytes"],
                     "product_flops": meta["product_flops"],
                     "memory": meta["memory"], "equal": True,
                     "count_s_meta": meta["compile_s"],
                     "count_s_device": card["compile_s"],
                     "_record": meta}
    return out


def dryrun_roofline(device, records: dict) -> dict:
    """Phase 39 (b): (a)'s prefill and decode records through
    ``roofline.analyze`` (the H100's constants), and the same steps on the
    kernels' path (``nested_matmul``, ``flash_attention``,
    ``decode_attention``) timed with CUDA events, ``DRYRUN_TIMED_CALLS``
    back to back: measured / bound must be at least
    ``DRYRUN_BOUND_FLOOR``, and each kernel must launch."""
    import torch

    from repro_torch.configs.alert_anytime import CONFIG
    from repro_torch.launch import roofline
    from repro_torch.models.registry import build_model

    shapes = dryrun_shapes()
    cfg = CONFIG.replace(nest_backend="kernel", attn_backend="kernel")
    model = build_model(cfg)
    params = model.init(generator=torch.Generator(device=device)
                        .manual_seed(0), device=device)
    sb, prompt, cache = DRYRUN_SERVED
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (sb, prompt), generator=gen,
                         device=device)
    caches = model.init_caches(sb, cache, device=device)
    dec = {"tokens": toks[:, -1:].contiguous(),
           "cache_len": torch.tensor(prompt, dtype=torch.int32,
                                     device=device)}
    calls = {"prefill": lambda: model.prefill(params, {"tokens": toks}),
             "decode": lambda: model.decode_step(params, dec, caches)}
    kernel_counts(reset=True)
    with torch.no_grad():
        for fn in calls.values():
            fn()
    torch.cuda.synchronize()
    counts = kernel_counts()
    for name in ("nested_matmul", "flash_attention", "decode_attention"):
        if not counts[name]:
            raise SmokeFailure(f"dry run (b): the kernel path did not "
                               f"launch {name}: {counts}")
    out = {"counts": counts, "launches": {k: counts[k] for k in (
        "nested_matmul", "flash_attention", "decode_attention")}}
    for kind in ("prefill", "decode"):
        rec = records[kind]
        shape = shapes[kind]
        tokens = shape.global_batch * (shape.seq_len if kind == "prefill"
                                       else 1)
        a = roofline.analyze({
            "arch": CONFIG.name, "shape": shape.name, "kind": kind,
            "mesh": "1x1", "n_devices": 1, "tokens": tokens,
            "flops_per_device": rec["flops"],
            "bytes_per_device": rec["bytes"],
            "collective_bytes_per_device": rec["coll_detail"],
            "memory": rec["memory"],
            "active_param_count": CONFIG.active_param_count()})
        with torch.no_grad():
            ms = cuda_ms(calls[kind], DRYRUN_TIMED_CALLS)
        ratio = ms / (a["bound_s"] * 1e3)
        say(f"  {kind} {shape.name} on the kernels: {ms:.4f} ms; roofline "
            f"bound {a['bound_s'] * 1e3:.4f} ms ({a['dominant']}: compute "
            f"{a['compute_s'] * 1e3:.4f} ms, memory {a['memory_s'] * 1e3:.4f}"
            f" ms); measured / bound {ratio:.2f}")
        if ratio < DRYRUN_BOUND_FLOOR:
            raise SmokeFailure(f"dry run (b) {kind}: measured {ms} ms is "
                               f"under {DRYRUN_BOUND_FLOOR} of the bound "
                               f"{a['bound_s'] * 1e3} ms")
        out[kind] = {"ms": ms, "bound_ms": a["bound_s"] * 1e3,
                     "dominant": a["dominant"],
                     "compute_ms": a["compute_s"] * 1e3,
                     "memory_ms": a["memory_s"] * 1e3,
                     "measured_over_bound": ratio}
    say(f"  launches of one prefill and one decode step: "
        f"{out['launches']}")
    return out


def dryrun_all() -> dict:
    """Phase 39 (c): ``run_cell`` over every ``ARCH_IDS`` x ``SHAPES``
    cell on the grids of ``DRYRUN_MESHES``: no cell may fail; the skips
    are ``cell_supported``'s."""
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES, cell_supported
    from repro_torch.launch import dryrun as dr

    meshes = DRYRUN_MESHES
    if meshes == (False,):
        say("  the 16x16 grid only (the whole run took over 60 s on one "
            "CPU core)")
    tally = {"ok": 0, "skip": 0, "fail": 0}
    wrong, slowest, t0 = [], (0.0, ""), time.perf_counter()
    for arch in configs.ARCH_IDS:
        for shape in SHAPES.values():
            for multi in meshes:
                t = time.perf_counter()
                try:
                    rec = dr.run_cell(arch, shape, multi)
                except Exception as exc:   # tallied, then the phase fails
                    rec = {"status": "fail", "error": repr(exc)}
                cell = f"{arch} {shape.name} {'2x16x16' if multi else '16x16'}"
                slowest = max(slowest, (time.perf_counter() - t, cell))
                tally[rec["status"]] += 1
                ok, _ = cell_supported(configs.get_config(arch), shape)
                if rec["status"] != ("ok" if ok else "skip"):
                    wrong.append((cell, rec))
    seconds = time.perf_counter() - t0
    say(f"  {tally['ok']} ok, {tally['skip']} skip, {tally['fail']} fail "
        f"in {seconds:.1f} s (slowest {slowest[1]}: {slowest[0]:.1f} s)")
    if wrong:
        raise SmokeFailure(f"dry run (c): {len(wrong)} cells not as "
                           f"cell_supported decides: {wrong[:3]}")
    return {"cells": tally, "seconds": seconds,
            "meshes": ["2x16x16" if m else "16x16" for m in meshes]}


def dryrun_phase(device) -> dict:
    """Phase 39, (a)-(c), on ``device``; ``counts`` holds (b)'s
    launches."""
    say("  (a) the count on meta and on the card")
    a = dryrun_on_device(device)
    say("  (b) the roofline bound against the kernels' path")
    b = dryrun_roofline(device, {k: v.pop("_record") for k, v in a.items()})
    say("  (c) the whole dry run")
    c = dryrun_all()
    return {"device_count": a, "roofline": b, "all": c,
            "counts": [b.pop("counts")]}


# --------------------------------------------------------------------- #
# Phase 34: rwkv6-3b at full width (d 2560, 40 heads of 64, d_ff 8960,
# vocab 65536), bf16 params and float32 moments, trained with the plain LM
# loss through make_train_step (its recurrence the chunk scan, a token
# loop), then served graphed on rwkv_scan.
RWKV_TRAIN_STEPS, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ = 6, 4, 256
RWKV_TRAIN_LR = 3e-4
# The data: SyntheticLM over the first 1024 token ids of the 65536 (as
# the live profile trains on a sub-range): the logits stay 65536 wide, and
# the loss falls within a few steps as the model learns which ids occur
# (over all 65536 ids a step's 1024 tokens teach too little to show in 6
# steps: at lr 1e-3 the loss went 11.62 to 11.70).
RWKV_TRAIN_DATA_VOCAB = 1024
RWKV_TRAIN_MEMORY = 70e9
# At the functional AdamW's update a parameter holds 26 bytes at once: the
# old bf16 params, bf16 grads, their float32 clipped copy, old and new
# float32 moments, and the new bf16 params (2 + 2 + 4 + 8 + 8 + 2).
ADAMW_PEAK_BYTES = 26
RWKV_TRAIN_DEPTHS = (32, 16)
# The served (rwkv_scan, graphed) prefill logits against train_logits
# (the chunk scan) on the same prompts, both bf16: within this many bf16
# ulps of each row's largest logit.  The two recurrences sum in other
# orders in float32, so y, rounded to bf16, may flip an ulp here and
# there, and the flips spread through the layers.
RWKV_SERVE_ULPS = 8


def rwkv_param_total(cfg) -> int:
    """The parameters ``init_lm`` draws for the RWKV ``cfg``: embedding,
    unembedding, final norm, and ``rwkv_param_shapes`` a layer."""
    from repro_torch.models.rwkv import rwkv_param_shapes

    layer = sum(math.prod(s) for s in rwkv_param_shapes(cfg).values())
    return 2 * cfg.vocab * cfg.d_model + cfg.d_model + cfg.n_layers * layer


def rwkv_train_depth(cfg) -> tuple[int, list[str]]:
    """The deepest of ``RWKV_TRAIN_DEPTHS`` whose update peak
    (``ADAMW_PEAK_BYTES`` a parameter) stays under ``RWKV_TRAIN_MEMORY``,
    and the reckoning of each depth tried."""
    notes = []
    for depth in RWKV_TRAIN_DEPTHS:
        n = rwkv_param_total(cfg.replace(n_layers=depth))
        peak = n * ADAMW_PEAK_BYTES
        notes.append(f"{depth} layers: {n} parameters x "
                     f"{ADAMW_PEAK_BYTES} B = {peak / 1e9:.1f} GB")
        if peak < RWKV_TRAIN_MEMORY:
            return depth, notes
    raise SmokeFailure("rwkv6-3b: no depth fits " + "; ".join(notes))


def row_ulps(got, want) -> float:
    """The largest ``|got - want|`` over each row of ``want`` (the last
    axis), in bf16 ulps of that row's largest magnitude."""
    import torch

    g, w = got.float(), want.float()
    top = w.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return float(((g - w).abs().amax(-1) / ulp).max())


def rwkv_train_full(device, cfg=None, steps: int = RWKV_TRAIN_STEPS,
                    batch: int = RWKV_TRAIN_BATCH,
                    seq: int = RWKV_TRAIN_SEQ) -> dict:
    """Phase 34 (a): ``cfg`` (default ``rwkv6-3b`` at full width, at the
    depth of :func:`rwkv_train_depth`) from seed-0 weights, ``steps``
    steps of ``make_train_step`` (the plain LM loss, remat "full", each
    ``rwkv_chunk`` of the recurrence recomputed) on
    ``SyntheticLM(RWKV_TRAIN_DATA_VOCAB, seq, batch)`` with
    ``AdamW(cosine_schedule(RWKV_TRAIN_LR, 1, steps))``.  Prints the
    median step (CUDA events), tokens/s, ``max_memory_allocated`` and the
    losses; fails on a loss that is not finite or a last loss not below
    the first."""
    import torch

    from repro_torch.configs.rwkv6_3b import CONFIG as RWKV_CONFIG
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.train import StepTimer, batch_fn
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state, make_train_step

    notes = []
    if cfg is None:
        depth, notes = rwkv_train_depth(RWKV_CONFIG)
        cfg = RWKV_CONFIG.replace(n_layers=depth)
        say(f"  the update's peak: " + "; ".join(notes) + f" -> {depth} of "
            f"{RWKV_CONFIG.n_layers} layers (under "
            f"{RWKV_TRAIN_MEMORY / 1e9:.0f} GB)")
    card = device.type == "cuda"
    if card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg)
    opt = AdamW(lr=cosine_schedule(RWKV_TRAIN_LR, 1, steps))
    state = init_train_state(model, cfg, opt, torch.Generator(
        device=device).manual_seed(0), device=device)
    data = SyntheticLM(vocab=min(RWKV_TRAIN_DATA_VOCAB, cfg.vocab),
                       seq_len=seq, global_batch=batch)
    batch_at = batch_fn(data, device)
    step = StepTimer(make_train_step(model, cfg, opt), device)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = step(state, batch_at(i))
        losses.append(metrics["loss"])
    step_ms = step.finish()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated(device) if card else None
    n_params = sum(p.numel() for p in param_tensors(state.params))
    med = statistics.median(step_ms)
    out = {"model": cfg.name, "n_layers": cfg.n_layers,
           "depth_reckoning": notes, "params": n_params, "dtype": cfg.dtype,
           "data_vocab": data.vocab,
           "steps": steps, "batch": batch, "seq": seq,
           "rwkv_chunk": cfg.rwkv_chunk, "median_step_ms": med,
           "first_step_ms": step_ms[0], "step_ms": step_ms,
           "tokens_per_s": batch * seq / med * 1e3,
           "max_memory_allocated_gb": None if peak is None else peak / 1e9,
           "losses": losses, "wall_s": wall}
    say(f"  {cfg.name} at {cfg.n_layers} layers trained {steps} steps "
        f"({n_params} parameters, {cfg.dtype}, float32 moments, chunk "
        f"{cfg.rwkv_chunk}, B={batch} x S={seq}): median step {med:.3f} ms "
        f"(CUDA events; first {step_ms[0]:.3f}), "
        f"{out['tokens_per_s']:.1f} tokens/s; max_memory_allocated "
        + (f"{peak / 1e9:.3f} GB" if peak is not None else "not measured")
        + f"; losses {[round(x, 4) for x in losses]} (data over "
          f"{data.vocab} ids); {wall:.1f} s")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise SmokeFailure(f"rwkv6-3b training: a loss not finite, or the "
                           f"last not below the first: {losses}")
    out["state"], out["model_api"], out["data"] = state, model, data
    return out


def rwkv_served_vs_train(device, model, params, prompts,
                         ulps: int = RWKV_SERVE_ULPS) -> dict:
    """Phase 34 (b): the serving prefill forward (``rwkv_scan``, a CUDA
    graph on the card) against ``model.train_logits`` (the chunk scan) on
    the same ``prompts``: within ``ulps`` bf16 ulps of each row's largest
    logit."""
    import torch

    from repro_torch.models import transformer as tfm

    cfg = model.cfg
    with torch.inference_mode():
        want, _ = model.train_logits(params, {"tokens": prompts})
        static = prompts.clone()
        got = graphed_call(device, lambda: tfm.lm_apply(
            params, cfg, static, mode="prefill").logits)
    err = row_ulps(got, want)
    same = float((got[:, -1].argmax(-1) == want[:, -1].argmax(-1))
                 .float().mean())
    out = {"max_row_ulps": err, "max_abs_diff": float(
        (got.float() - want.float()).abs().max()),
        "max_abs_logit": float(want.float().abs().max()),
        "last_argmax_agree": same}
    say(f"  served (rwkv_scan, graphed prefill) vs train_logits (chunk "
        f"scan), {cfg.dtype}, B=%d S=%d: at most {err:.2f} bf16 ulps of a "
        f"row's largest logit (tolerance {ulps}), max abs diff "
        f"{out['max_abs_diff']:.4e} of {out['max_abs_logit']:.3f}, last "
        f"argmax agrees {same:.2f}" % tuple(prompts.shape))
    if not err <= ulps:
        raise SmokeFailure(f"rwkv6-3b: the served logits differ from "
                           f"train_logits by {err:.2f} bf16 ulps of a row's "
                           f"largest, past {ulps}")
    return out


def rwkv_training_phase(device, cfg=None, steps: int = RWKV_TRAIN_STEPS,
                        batch: int = RWKV_TRAIN_BATCH,
                        seq: int = RWKV_TRAIN_SEQ) -> dict:
    """Phase 34: (a) :func:`rwkv_train_full`; (b) the trained weights,
    detached, held by :func:`rwkv_served_vs_train`, then 4 ticks of
    ``FleetAlertServer`` over them, its engine graphed on ``rwkv_scan``
    (which must launch on the card); ``counts`` holds that run's
    launches."""
    import torch

    from repro_torch.tree import tree_map

    out = {}
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    say("  (a) full-width training")
    a = rwkv_train_full(device, cfg, steps=steps, batch=batch, seq=seq)
    state, model, data = a.pop("state"), a.pop("model_api"), a.pop("data")
    out["train"] = a
    say("  (b) the trained weights served on rwkv_scan")
    params = tree_map(lambda t: t.detach(), state.params)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prompts = torch.from_numpy(data.batch_at(20_000)["tokens"][:4, :8]).to(
        device)
    out["served_vs_train"] = rwkv_served_vs_train(device, model, params,
                                                  prompts)
    run = serve(device, model.cfg, params=params,
                expect_kernel=device.type == "cuda")
    if device.type == "cuda" and not run["rs_launches"]:
        raise SmokeFailure("rwkv6-3b: serving the trained weights launched "
                           "no rwkv_scan")
    out["serve"] = {"tick_s": run["tick_s"],
                    "rwkv_scan_launches": run["rs_launches"]}
    out["counts"] = [run_counts(run)]
    del run, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# Phases 35-36: the serving launcher and the examples, each at its
# defaults (and with the arguments named here), its kernels counted.
# Each example with the kernels it must launch on the card.
EXAMPLES = (
    ("quickstart_torch", (), ("flash_attention", "decode_attention")),
    ("train_anytime_torch", (), ()),
    ("live_profile_demo_torch", ("--measured",),
     ("nested_matmul", "flash_attention", "decode_attention",
      "alert_select")),
    ("traffic_demo_torch", (), ("alert_select",)),
    ("faults_demo_torch", (), ("alert_select",)),
    ("obs_demo_torch", (), ("alert_select",)),
    ("kernel_demo_torch", (), ("alert_select",)))
LAUNCHER_KERNELS = ("nested_matmul", "flash_attention", "decode_attention",
                    "alert_select")


def captured_main(main, argv, what: str) -> tuple[dict, list[str]]:
    """``main(argv)``'s result and the lines it printed (printed here
    whole if it raises)."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = main(list(argv))
    except BaseException:
        say(f"  {what} failed; its output:\n" + buf.getvalue())
        raise
    return out, buf.getvalue().splitlines()


def launcher_run(device) -> dict:
    """Phase 35: ``python -m repro_torch.launch.serve`` at its defaults
    (``main`` with no argument but the device): on the card its engine
    must launch ``LAUNCHER_KERNELS``; prints its report line."""
    from repro_torch.launch import serve as launch_serve

    kernel_counts(reset=True)              # this run starts here
    t0 = time.perf_counter()
    out, lines = captured_main(launch_serve.main, ["--device", device.type],
                               "repro_torch.launch.serve")
    counts = kernel_counts()               # and ends here
    wall = time.perf_counter() - t0
    report = [ln for ln in lines if ln.startswith("[serve]")]
    say("  " + "\n  ".join(report))
    say(f"  launches {counts}, {wall:.1f} s")
    if device.type == "cuda" and not all(counts[k] for k in
                                         LAUNCHER_KERNELS):
        raise SmokeFailure(f"repro_torch.launch.serve: a kernel never "
                           f"launched: {counts}")
    if out["requests"] != 40 or not report:
        raise SmokeFailure(f"repro_torch.launch.serve: {out['requests']} "
                           f"requests, report {report}")
    return {"summary": {k: out[k] for k in (
        "arch", "nest_backend", "attn_backend", "accuracies",
        "table_latency", "requests", "delivered_acc", "miss_rate",
        "mean_energy")}, "wall_s": wall, "counts": counts}


def examples_run(device, settings=None) -> dict:
    """Phase 36: each of ``EXAMPLES`` (``examples/<name>.py``) with its
    arguments (``settings`` maps a name to other ones, for a rehearsal on
    the CPU) on ``device``: its ``OK`` line printed, its kernels launched
    on the card."""
    import importlib.util

    settings = settings or {}
    out = {}
    for name, argv, kernels in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        argv = list(settings.get(name, argv)) + ["--device", device.type]
        kernel_counts(reset=True)          # this run starts here
        t0 = time.perf_counter()
        _, lines = captured_main(mod.main, argv, name)
        counts = kernel_counts()           # and ends here
        wall = time.perf_counter() - t0
        ok = [ln for ln in lines if ln.startswith("OK")]
        say(f"  {name} {' '.join(argv)}: {ok[-1] if ok else 'no OK line'} "
            f"({wall:.1f} s, launches "
            f"{ {k: v for k, v in counts.items() if v} })")
        if not ok:
            raise SmokeFailure(f"{name} printed no OK line")
        if device.type == "cuda" and not all(counts[k] for k in kernels):
            raise SmokeFailure(f"{name}: a kernel never launched: {counts}")
        out[name] = {"argv": argv, "ok": ok[-1], "wall_s": wall,
                     "counts": counts}
    return out


def attention_layers(cfg) -> int:
    """The layers of ``cfg`` that hold attention (``"attn"`` or
    ``"attn_local"``), each one ``flash_attention`` launch a prefill
    forward and one ``decode_attention`` launch a decode forward."""
    return sum(m in ("attn", "attn_local") for m, _ in cfg.layer_plan())


def run_counts(run: dict) -> dict:
    """The launches one ``serve`` run counted, by kernel."""
    return {"alert_select": run["launches"],
            "nested_matmul": run["nm_launches"],
            "flash_attention": run["fa_launches"],
            "decode_attention": run["da_launches"],
            "rwkv_scan": run["rs_launches"]}


def tenants(table):
    """Eight tenants, Eq. 4 and Eq. 5 mixed, with deadlines and goals
    placed against the profiled latencies so picks vary."""
    from repro_torch.core.controller import Constraints, Goal

    lat = table.latency[:, -1]
    base = [lat[min(i, len(lat) - 1)] for i in range(4)]
    top_w = float(table.run_power[0, -1])
    mk_e = lambda dl, acc: (Goal.MINIMIZE_ENERGY,
                            Constraints(deadline=dl, accuracy_goal=acc))
    mk_a = lambda dl, frac: (Goal.MAXIMIZE_ACCURACY,
                             Constraints(deadline=dl,
                                         energy_goal=frac * top_w * dl))
    return [mk_e(3.0 * base[3], 0.8), mk_e(1.5 * base[1], 0.7),
            mk_a(3.0 * base[3], 0.9), mk_a(2.0 * base[2], 0.5),
            mk_e(1.2 * base[0], 0.6), mk_a(1.5 * base[1], 0.8),
            mk_e(2.0 * base[2], 0.75), mk_a(0.8 * base[0], 0.9)]


def serve(device, cfg, n_streams=8, batch_size=4, prompt_len=8,
          gen_tokens=4, expect_kernel=True, params=None,
          graphs=True, level_accuracies=None) -> dict:
    """Phases 4, 7, 10, 13, 15-17, 19, 20, 22, 23, 27 and 33: the fleet
    server over ``cfg`` on ``device``, its engine replaying one CUDA graph
    per level and prompt length (``graphs``; False runs the same steps
    eagerly, the yardstick),
    with ``params`` or weights drawn from a seed-0 generator, and
    ``level_accuracies`` (default ``LEVEL_ACCURACIES``) for its table.  Every
    launch counter starts at 0 here and is read after the last tick.  With ``expect_kernel`` the scoring kernel must launch
    once per tick.  On the card, with ``cfg.nest_backend == "kernel"``,
    ``nested_matmul`` must launch 7 * n_layers times per forward pass (one
    per generated token), with ``cfg.attn_backend == "kernel"``
    ``flash_attention`` once per attention layer (``"attn"`` or
    ``"attn_local"`` in ``cfg.layer_plan()``; a Mamba layer has none) a
    prefill forward and ``decode_attention`` once per attention layer a
    decode forward, and for an RWKV model ``rwkv_scan`` n_layers times per
    forward; otherwise they must not launch at all."""
    import numpy as np
    import torch

    from repro_torch.core.controller import Goal
    from repro_torch.kernels import alert_select as ks
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nested_matmul as nm
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving.alert_server import FleetAlertServer
    from repro_torch.serving.engine import ServeEngine

    t0 = time.perf_counter()
    if params is None:
        params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    n_params = sum(p.numel() for p in param_tensors(params))
    say(f"  model {cfg.name}: {n_params} parameters, {cfg.dtype}, "
        f"{cfg.n_layers} layers, d={cfg.d_model}, init "
        f"{time.perf_counter() - t0:.3f} s")
    engine = ServeEngine(build_model(cfg), max_len=prompt_len + gen_tokens,
                         batch_size=batch_size, device=device, graphs=graphs)

    ks.alert_select.launches = 0           # main path starts here
    nm.nested_matmul.launches = 0
    fa.flash_attention.launches = 0
    da.decode_attention.launches = 0
    rs.rwkv_scan.launches = 0
    card = device.type == "cuda"
    per_forward = 7 * cfg.n_layers if (cfg.nest_backend == "kernel"
                                       and card) else 0
    attn_per_forward = attention_layers(cfg) if (
        cfg.attn_backend == "kernel" and card) else 0
    rwkv_per_forward = cfg.n_layers if (cfg.rwkv and card) else 0
    t0 = time.perf_counter()
    if level_accuracies is None:
        level_accuracies = LEVEL_ACCURACIES[:cfg.nest_levels]
    srv = FleetAlertServer(engine, params,
                           level_accuracies=level_accuracies,
                           goal=Goal.MINIMIZE_ENERGY, n_streams=n_streams,
                           prompt_len=prompt_len, gen_tokens=gen_tokens,
                           start_active=False)
    say(f"  profiled on {device.type} ({'CUDA graphs' if graphs and card else 'eager'}"
        f") in {time.perf_counter() - t0:.3f} s; "
        f"per-level latency at full power (s): "
        + ", ".join(f"L{i + 1}={x:.6f}"
                    for i, x in enumerate(srv.table.latency[:, -1])))
    people = tenants(srv.table)
    for goal, cons in people:
        srv.admit(goal, cons)

    tokens_seen = []
    plain_generate = engine.generate

    def recording_generate(*args, **kwargs):
        r = plain_generate(*args, **kwargs)
        tokens_seen.append(r["tokens"])
        return r

    engine.generate = recording_generate
    rng = np.random.default_rng(0)
    counts = []
    tick_s = []
    for tick in range(N_TICKS):
        if tick == 2:
            srv.retire(5)
            lane = srv.admit(*people[2])
            say(f"  tick {tick}: retired lane 5, admitted lane {lane}")
        prompts = [rng.integers(0, cfg.vocab, (batch_size, prompt_len))
                   .astype(np.int32) for _ in range(srv.n_streams)]
        n_tok = len(tokens_seen)
        nm_before = nm.nested_matmul.launches
        fa_before = fa.flash_attention.launches
        da_before = da.decode_attention.launches
        rs_before = rs.rwkv_scan.launches
        t1 = time.perf_counter()
        outs = srv.serve_tick(prompts)
        dt = time.perf_counter() - t1
        tick_s.append(dt)
        counts.append(ks.alert_select.launches)
        forwards = sum(t.shape[1] for t in tokens_seen[n_tok:])
        prefills = len(tokens_seen) - n_tok      # one per generate call
        nm_tick = nm.nested_matmul.launches - nm_before
        fa_tick = fa.flash_attention.launches - fa_before
        da_tick = da.decode_attention.launches - da_before
        rs_tick = rs.rwkv_scan.launches - rs_before
        if rs_tick != rwkv_per_forward * forwards:
            raise SmokeFailure(f"tick {tick}: rwkv_scan launched {rs_tick} "
                               f"times for {forwards} forward passes, "
                               f"expected {rwkv_per_forward} each")
        if nm_tick != per_forward * forwards:
            raise SmokeFailure(f"tick {tick}: nested_matmul launched "
                               f"{nm_tick} times for {forwards} forward "
                               f"passes, expected {per_forward} each")
        if (fa_tick, da_tick) != (attn_per_forward * prefills,
                                  attn_per_forward * (forwards - prefills)):
            raise SmokeFailure(
                f"tick {tick}: flash_attention launched {fa_tick} times for "
                f"{prefills} prefill forwards and decode_attention "
                f"{da_tick} times for {forwards - prefills} decode "
                f"forwards, expected {attn_per_forward} each")
        live = np.nonzero(srv.active)[0]
        for s in live:
            o = outs[s]
            if o is None:
                raise SmokeFailure(f"tick {tick}: live lane {s} not served")
            nums = (o.power_cap, o.latency, o.accuracy, o.energy)
            if not all(math.isfinite(x) for x in nums) or o.latency <= 0:
                raise SmokeFailure(f"tick {tick}: lane {s} bad result {o}")
        for toks in tokens_seen[n_tok:]:
            if toks.shape[0] != batch_size or not 1 <= toks.shape[1] <= \
                    gen_tokens or toks.min() < 0 or toks.max() >= cfg.vocab:
                raise SmokeFailure(f"tick {tick}: tokens out of range")
        if len(tokens_seen) - n_tok != len(live):
            raise SmokeFailure(f"tick {tick}: {len(live)} live lanes, "
                               f"{len(tokens_seen) - n_tok} generations")
        say(f"  tick {tick}: {dt:.4f} s, levels "
            + " ".join(str(outs[s].level) if outs[s] else "-"
                       for s in range(srv.n_streams))
            + ", missed " + " ".join(str(int(outs[s].missed)) if outs[s]
                                     else "-" for s in range(srv.n_streams))
            + f", alert_select launches {ks.alert_select.launches}, "
              f"nested_matmul launches {nm_tick} for {forwards} forwards, "
              f"flash_attention {fa_tick} for {prefills} prefills, "
              f"decode_attention {da_tick} for {forwards - prefills} "
              f"decode steps, rwkv_scan {rs_tick}")
    launches = ks.alert_select.launches   # main path ends here
    nm_launches = nm.nested_matmul.launches
    fa_launches = fa.flash_attention.launches
    da_launches = da.decode_attention.launches
    rs_launches = rs.rwkv_scan.launches
    if expect_kernel and counts != list(range(1, N_TICKS + 1)):
        raise SmokeFailure(f"alert_select launch counts per tick {counts}, "
                           f"expected one launch per tick")
    backends = "RWKV-6" if cfg.rwkv else (
        f"{cfg.nest_backend} nest backend" if cfg.nest_levels > 1
        else "no nesting") + f", {cfg.attn_backend} attention"
    say(f"  served {N_TICKS} ticks of {cfg.name} ({backends}); "
        f"alert_select launches {launches}, "
        f"nested_matmul {nm_launches}, flash_attention {fa_launches}, "
        f"decode_attention {da_launches}, rwkv_scan {rs_launches} "
        f"(profiling included)")
    return {"server": srv, "engine": engine, "params": params,
            "launches": launches, "nm_launches": nm_launches,
            "fa_launches": fa_launches, "da_launches": da_launches,
            "rs_launches": rs_launches, "tick_s": tick_s}


def harness_latencies(engines, params) -> dict:
    """Per-level ``generate`` latency of each engine in ``engines`` (name
    -> ServeEngine over the same ``params``) through the profiling
    harness, ``profile_anytime_measured(engine_level_fns(...))``, in
    turns A, B, B, A; returns name -> list of per-turn level latencies
    (seconds, full-power column)."""
    from repro_torch.core.power import PowerModel
    from repro_torch.profiling import (engine_level_fns,
                                       profile_anytime_measured)

    names = list(engines)
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        eng = engines[n]
        table = profile_anytime_measured(
            engine_level_fns(eng, params), LEVEL_ACCURACIES[
                :eng.model.cfg.nest_levels], PowerModel(),
            n_power_buckets=4, warmup=3, iters=15,
            sync=None if eng.device.type == "cuda" else (lambda v: v))
        lat = [float(x) for x in table.latency[:, -1]]
        out[n].append(lat)
        say(f"  harness, {n} backend: per-level generate latency (s) "
            + ", ".join(f"L{i + 1}={x:.6f}" for i, x in enumerate(lat)))
    return out


# The kernel wrappers the engine counts (serving.engine.COUNTED, in its
# order) and the kernel-node names one launch of them adds to a graph,
# one of each tuple (decode_attention's combine node comes only with a
# split call; a one-token rwkv_scan call runs rwkv_scan_decode).
WRAPPER_NODES = (("nested_matmul", ("nested_matmul",)),
                 ("flash_attention", ("flash_attention",)),
                 ("decode_attention", ("decode_attention_kernel",)),
                 ("rwkv_scan", ("rwkv_scan_kernel", "rwkv_scan_decode")))


def check_step_nodes(step, what: str) -> int:
    """Fails unless the CUDA graph of ``step`` holds, for each counted
    wrapper (``WRAPPER_NODES``), as many kernel nodes as one replay adds to
    that wrapper's count; returns the graph's kernel nodes."""
    names = [name for name, _ in graph_kernels(step.graph)]
    counted = tuple(sum(any(p in n for p in pats) for n in names)
                    for _, pats in WRAPPER_NODES)
    if counted != step.launches:
        raise SmokeFailure(f"{what}: its graph holds {counted} kernel nodes "
                           f"of {[w for w, _ in WRAPPER_NODES]}, its replay "
                           f"counts {step.launches}")
    return len(names)


def replay_ms(graph, reset, reps: int = 20) -> float:
    """Device time of one replay of ``graph``: CUDA events around single
    replays, ``reset()`` (under inference mode) before each so every replay
    does the same work; the median of ``reps`` after two warm-ups."""
    import torch

    times = []
    for _ in range(reps + 2):
        with torch.inference_mode():
            reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[2:])


def engine_graphs_vs_eager(engine, params, prompt_len: int,
                           gen_tokens: int, rounds: int = 3) -> dict:
    """A graphed engine against the same steps run eagerly on the card,
    over the same weights: after one warm-up per level, ``rounds`` rounds
    of level switches (the order turned each round) must give bitwise
    equal tokens, add to every launch counter what the eager call adds,
    and leave ``n_compiles()`` flat; each graph's kernel nodes, read back
    from the graph, must match what its replay adds to each counter."""
    import numpy as np

    from repro_torch.serving.engine import COUNTED, ServeEngine

    eager = ServeEngine(engine.model, max_len=engine.max_len,
                        batch_size=engine.batch_size, device=engine.device,
                        graphs=False)
    engine.warmup(params, prompt_len)
    compiles = engine.n_compiles()
    levels = list(engine.levels)
    if compiles != (len(levels), len(levels)):
        raise SmokeFailure(f"warm-up made {compiles} steps for "
                           f"{len(levels)} levels")
    nodes = {}
    for key, step in engine.steps.items():
        if step.graph is None:
            raise SmokeFailure(f"step {key} was not captured")
        nodes["/".join(str(k) for k in key)] = {
            "kernel_nodes": check_step_nodes(step, f"step {key}"),
            "launches": dict(zip((w for w, _ in WRAPPER_NODES),
                                 step.launches))}
    prompt = np.random.default_rng(9).integers(
        0, engine.model.cfg.vocab, (engine.batch_size, prompt_len)).astype(
            np.int32)
    for r in range(rounds):
        for lvl in levels[r % len(levels):] + levels[:r % len(levels)]:
            before = [w.launches for w in COUNTED]
            got = engine.generate(params, prompt, gen_tokens, level=lvl)
            mid = [w.launches for w in COUNTED]
            want = eager.generate(params, prompt, gen_tokens, level=lvl)
            after = [w.launches for w in COUNTED]
            if not np.array_equal(got["tokens"], want["tokens"]):
                raise SmokeFailure(f"level {lvl}, round {r}: graphed tokens "
                                   f"{got['tokens'].tolist()} != eager "
                                   f"{want['tokens'].tolist()}")
            graphed = [b - a for a, b in zip(before, mid)]
            eagerly = [b - a for a, b in zip(mid, after)]
            if graphed != eagerly:
                raise SmokeFailure(f"level {lvl}: replays counted {graphed} "
                                   f"launches, the eager call {eagerly}")
    if engine.n_compiles() != compiles:
        raise SmokeFailure(f"n_compiles went from {compiles} to "
                           f"{engine.n_compiles()} over {rounds} rounds of "
                           f"level switches")
    say(f"  graphs vs eager ({engine.model.cfg.name}, levels {levels}): "
        f"tokens bitwise equal over {rounds} rounds of level switches, "
        f"n_compiles {compiles} before and after, launches per replay "
        f"equal to the eager call's and to each graph's kernel nodes: "
        + ", ".join(f"{k} {v['kernel_nodes']} nodes {v['launches']}"
                    for k, v in nodes.items()))
    return {"levels": [str(x) for x in levels], "n_compiles": list(compiles),
            "rounds": rounds, "graphs": nodes}


def node_floor_ms(device) -> float:
    """Device time per node of a CUDA graph of one-element adds: what one
    launch costs the card when its kernel does almost nothing."""
    import torch

    t = torch.zeros(1, device=device)
    return graph_ms(lambda: t.add_(1.0), calls=200)


def forward_device_ms(engine, params, level, prompt_len: int,
                      reps: int = 20) -> dict:
    """Device time of one prefill and one decode forward at ``level``:
    CUDA events around single replays of the engine's own graphs, the
    median of ``reps``; ``cache_len`` is set back before each decode
    replay so every replay decodes the same position."""
    engine.warmup(params, prompt_len)
    buf = engine._buffers[level]
    out = {}
    for kind, step in (("prefill", engine.steps["prefill", level,
                                               prompt_len]),
                       ("decode", engine.steps["decode", level])):
        out[f"{kind}_ms"] = replay_ms(
            step.graph, lambda: buf.cache_len.fill_(prompt_len), reps)
        out[f"{kind}_kernel_nodes"] = len(graph_kernels(step.graph))
    return out


def staircase(name: str, samples) -> dict:
    """The staircase of one engine from the samples of the profile that
    builds ALERT's table (``serve_level_latencies``, ``[levels, rounds]``
    seconds, the levels interleaved round by round).  The medians of the
    first and of the second half of the rounds are two repeated profiles;
    their largest per-level gap is the spread.  The staircase "rises" when
    each level's median is at least the one below it less the spread, and
    the deepest exceeds the first by more than the spread."""
    rounds = samples.shape[1]
    med = [statistics.median(row) for row in samples.tolist()]
    halves = [[statistics.median(row[h * rounds // 2:(h + 1) * rounds // 2])
               for row in samples.tolist()] for h in (0, 1)]
    spread = max(abs(a - b) for a, b in zip(*halves))
    rising = bool(all(med[i + 1] >= med[i] - spread
                      for i in range(len(med) - 1))
                  and med[-1] - med[0] > spread)
    say(f"  staircase, {name} engine (serve_level_latencies, {rounds} "
        f"interleaved rounds, median per level, s): "
        + ", ".join(f"L{i + 1}={x:.6f}" for i, x in enumerate(med))
        + f"; halves {[[round(x, 6) for x in h] for h in halves]}; "
          f"spread {spread:.6f} s; {'rising' if rising else 'NOT rising'}")
    return {"median_s": med, "halves_s": halves, "spread_s": spread,
            "rising": rising}


def main_path_inputs(srv):
    """The kernel's inputs for the server's next tick, built with the
    scoring engine's own conversions (as ``serve_tick`` builds them)."""
    import numpy as np

    from repro_torch.core.batched import GOAL_MAX_ACCURACY

    eng = srv.scoring
    s = srv.n_streams
    deadlines, e_goals = np.ones(s), np.zeros(s)
    for lane in np.nonzero(srv.active)[0]:
        c = srv.lane_constraints[lane]
        deadlines[lane] = c.deadline
        if srv.goal_kinds[lane] == GOAL_MAX_ACCURACY:
            e_goals[lane] = c.energy_goal
    args = [eng._vec(srv.slowdown.mu, s),
            eng._vec(srv.slowdown.sigma, s, floor=1e-6),
            eng._vec(srv.idle_power.phi, s), eng._vec(deadlines, s),
            eng._vec(srv._goal_bank.current_goal(), s),
            eng._vec(e_goals, s), eng._lane_ints(srv.goal_kinds),
            eng._lane_ints(srv.active)]
    kw = dict(latency=eng._latency, run_power=eng._run_power,
              weights=eng._weights, q_fail=eng._q_fail,
              overhead=eng.overhead, paper_faithful_energy=True,
              predictions=True)
    return args, kw


class Phases:
    """Prints each phase's banner and, when the next one starts, the
    seconds it took."""

    def __init__(self):
        self.name, self.t0 = None, 0.0

    def start(self, title: str | None) -> None:
        if self.name is not None:
            say(f"  ({self.name}: {time.perf_counter() - self.t0:.1f} s)")
        self.name, self.t0 = (title.split(":")[0] if title else None,
                              time.perf_counter())
        if title:
            say(f"== {title}")


def attention_entry(name, version, source, replaces, launches, cases,
                    headline, main_path) -> dict:
    """The ``kernels`` line's entry of one attention kernel: headline
    numbers of the ``headline`` case, the other timed cases and the
    main-path times beside them."""
    h = cases[headline]
    keys = ("shape", "ms", "eager_ms", "plain_ms", "library_ms",
            "library_eager_ms", "bound_ms", "bound_by", "flops", "bytes",
            "input_sets", "tflop_s", "gb_s", "bound_share", "splits",
            "blocks", "cuda_launches")
    return {
        "name": name, "version": version, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(c["err"] for c in cases.values()),
        "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
        "bound_by": h["bound_by"], "library_ms": h["library_ms"],
        "shape": h["shape"],
        "max_tolerance_ratio": max(c["ratio"] for c in cases.values()),
        **{f: h[f] for f in ("eager_ms", "library_eager_ms", "tflop_s",
                             "gb_s", "bound_share", "splits", "blocks",
                             "cuda_launches") if f in h},
        "other_shapes": {k: {f: c[f] for f in keys if f in c}
                         for k, c in cases.items()
                         if "ms" in c and k != headline},
        "main_path": main_path}


def main() -> int:
    import argparse

    # Phase 33 (e) runs under deterministic algorithms, whose cuBLAS needs
    # a fixed workspace, read when cuBLAS starts (this is Hopper's default
    # size, so no other phase changes).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one GPU "
                                 "and check it.")
    ap.add_argument("--breakdown", action="store_true",
                    help="also break each dense model's and whisper-tiny's "
                    "graphed forwards down by kind of kernel with "
                    "torch.profiler")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        say("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        say(f"FAIL: the port's sources are not under {SRC}")
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.alert_anytime import CONFIG
    from repro_torch.configs import get_reduced
    from repro_torch.configs.gemma3_1b import CONFIG as GEMMA_CONFIG
    from repro_torch.configs.jamba_v01_52b import CONFIG as JAMBA_CONFIG
    from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_CONFIG
    from repro_torch.configs.qwen3_moe_30b_a3b import \
        CONFIG as QWEN3_MOE_CONFIG
    from repro_torch.configs.qwen2_5_14b import CONFIG as QWEN_CONFIG
    from repro_torch.configs.qwen2_5_32b import CONFIG as QWEN32_CONFIG
    from repro_torch.configs.qwen2_vl_2b import CONFIG as QWEN2VL_CONFIG
    from repro_torch.configs.rwkv6_3b import CONFIG as RWKV_CONFIG
    from repro_torch.configs.stablelm_12b import CONFIG as STABLELM_CONFIG
    from repro_torch.kernels import alert_select as ks
    from repro_torch.kernels.build import build
    from repro_torch.serving.alert_server import serve_level_latencies

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase = Phases()

    phase.start("phase 1: device")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {kind}, count {torch.cuda.device_count()}")
    say(f"  nvidia-smi: {smi}")

    phase.start("phase 2: build")
    built = build(["alert_select", "nested_matmul", "flash_attention",
                   "decode_attention", "rwkv_scan"])
    for name, b in built.items():
        say(f"  {name}: {'reused' if b.reused else 'built'} in "
            f"{b.seconds:.3f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                say(f"    ptxas: {line.strip()}")

    fp64_counts = fp64_instruction_counts()
    say(f"  FP64 instructions in the SASS of one call, the fewest and the "
        f"most on a path of the inline code to EXIT: {fp64_counts}")

    phase.start("phase 3: alert_select kernel vs plain version on the card")
    err, timing = kernel_vs_plain(device, counts=fp64_counts)
    n_select_cases = select_cases(device)

    phase.start("phase 4: serve (blocks nest backend)")
    err_model = model_cpu_vs_card(device)
    cfg4 = CONFIG.replace(n_layers=SERVE_DEPTH)
    run = serve(device, cfg4)
    run_e = serve(device, cfg4, params=run["params"], graphs=False)
    graphs = {"blocks": engine_graphs_vs_eager(run["engine"], run["params"],
                                               8, 4)}
    args, kw = main_path_inputs(run["server"])
    got = ks.alert_select(*args, **kw)
    torch.cuda.synchronize(device)
    err = max(err, compare(got, ks.alert_select_plain(*args, **kw),
                           "main-path shape S=%d K=%d L=%d"
                           % ((args[0].shape[0],) + tuple(kw["latency"]
                                                          .shape))))
    mp_ms = cuda_ms(lambda: ks.alert_select(*args, **kw), launches=200)
    mp_graph_ms = graph_ms(lambda: ks.alert_select(*args, **kw))
    mp_plain = cuda_ms(lambda: ks.alert_select_plain(*args, **kw),
                       launches=50)
    srv = run["server"]
    select_ms = host_ms(lambda: srv.scoring.select(
        *args[:4], accuracy_goal=args[4], energy_goal=args[5],
        goal_kind=args[6], active=args[7]))
    s_mp, (k_mp, l_mp) = args[0].shape[0], kw["latency"].shape
    cost = ks.alert_select_cost(s_mp, k_mp, l_mp, predictions=True)
    mp_bound = max(cost["flops"] / H100_FP64_FLOPS,
                   cost["bytes_accessed"] / H100_HBM_BYTES_S) * 1e3
    say(f"  main-path shape S={s_mp} K={k_mp} L={l_mp}: kernel "
        f"{mp_ms:.6f} ms back to back, {mp_graph_ms:.6f} ms device time "
        f"(CUDA graph), plain {mp_plain:.6f} ms, bound {mp_bound:.9f} ms; "
        f"one BatchedAlertEngine.select call (host wall, results on the "
        f"host) {select_ms:.6f} ms")
    say(f"  reduced-model max abs logit diff {err_model:.3e}")

    phase.start("phase 5: nested_matmul kernel vs plain version on the card")
    from repro_torch.kernels.nested_matmul import nested_matmul as nm_call

    v4_before = nm_call.v4_launches
    nm_err = nested_vs_plain(device, CONFIG)
    nm_levels = time_nested_levels(device, CONFIG)
    nm_sweep = nested_split_sweep(device, CONFIG)
    nm_live = nested_live_split(device, CONFIG)
    nm_time = {m: time_nested(device, CONFIG, m) for m in (32, 4)}
    fwd = {m: time_forward_projections(device, CONFIG, m) for m in (32, 4)}
    if nm_call.v4_launches != v4_before:
        raise SmokeFailure(f"{nm_call.v4_launches - v4_before} nested_matmul "
                           f"calls at M <= 32 took v4")
    say("  v4 launches at M <= 32 (the served shapes above): 0")
    nm_wide = time_nested_wide(device)
    nm_wide_err = max(max(r["max_abs_err"] for r in nm_wide),
                      nested_wide_odd(device))
    nm_cross = nested_crossover(device)

    phase.start("phase 6: reduced model, kernel nest backend")
    err_model_k = model_cpu_vs_card(device, backend="kernel")

    phase.start("phase 7: serve (kernel nest backend)")
    cfg7 = CONFIG.replace(nest_backend="kernel", n_layers=SERVE_DEPTH)
    run_k = serve(device, cfg7)
    run_ke = serve(device, cfg7, params=run_k["params"], graphs=False)
    graphs["kernel"] = engine_graphs_vs_eager(run_k["engine"],
                                              run_k["params"], 8, 4)

    phase.start("phase 8: attention kernels vs plain versions on the card")
    att = attention_vs_plain(device, CONFIG)
    att_mp = time_main_path_attention(device, CONFIG)

    phase.start("phase 9: reduced model, kernel nest and attention backends")
    err_model_a = model_cpu_vs_card(device, backend="kernel",
                                    attn_backend="kernel")

    phase.start("phase 10: serve with every kernel on the path")
    all_cfg = CONFIG.replace(nest_backend="kernel", attn_backend="kernel")
    run_a = serve(device, all_cfg)
    run_ae = serve(device, all_cfg, params=run_a["params"], graphs=False)
    graphs["all-kernel"] = engine_graphs_vs_eager(run_a["engine"],
                                                  run_a["params"], 8, 4)
    harness = harness_latencies({"graphs": run_a["engine"],
                                 "eager": run_ae["engine"]},
                                run_a["params"])
    stairs = {name: staircase(name, serve_level_latencies(
        r["engine"], r["params"], rounds=16))
        for name, r in (("graphs", run_a), ("eager", run_ae))}
    say(f"  ALERT's table (profile_serve_table at startup), graphs engine, "
        f"full power (s): {run_a['server'].table.latency[:, -1].tolist()}")
    floor_ms = node_floor_ms(device)
    fwd_dev = {}
    for lvl in (1, all_cfg.nest_levels):
        f = fwd_dev[lvl] = forward_device_ms(run_a["engine"],
                                             run_a["params"], lvl, 8)
        say(f"  level {lvl} forward, device time (CUDA events around one "
            f"graph replay): prefill {f['prefill_ms']:.6f} ms "
            f"({f['prefill_kernel_nodes']} kernel nodes, launch floor "
            f"{f['prefill_kernel_nodes'] * floor_ms:.6f} ms), decode "
            f"{f['decode_ms']:.6f} ms ({f['decode_kernel_nodes']} nodes, "
            f"floor {f['decode_kernel_nodes'] * floor_ms:.6f} ms); "
            f"{floor_ms * 1e3:.3f} us per near-empty graph node")
    if not stairs["graphs"]["rising"]:
        raise SmokeFailure("the graphed staircase does not rise: a level's "
                           "generate is faster than the one below it, or "
                           "the deepest is not slower than level 1, by more "
                           "than the spread of repeated profiles")
    say(f"  tick times (s), graphs / eager: blocks "
        f"{[round(t, 4) for t in run['tick_s']]} / "
        f"{[round(t, 4) for t in run_e['tick_s']]} and kernel nest "
        f"{[round(t, 4) for t in run_k['tick_s']]} / "
        f"{[round(t, 4) for t in run_ke['tick_s']]} at {SERVE_DEPTH} "
        f"layers; all-kernel {[round(t, 4) for t in run_a['tick_s']]} / "
        f"{[round(t, 4) for t in run_ae['tick_s']]} at {CONFIG.n_layers}")

    phase.start("phase 11: rwkv_scan kernel vs plain version on the card")
    rwkv = rwkv_vs_plain(device, RWKV_CONFIG)
    rwkv_mp = time_main_path_rwkv(device, RWKV_CONFIG)

    phase.start("phase 12: reduced RWKV-6 model on the card")
    err_model_r = rwkv_model_cpu_vs_card(device)

    phase.start("phase 13: serve rwkv6-3b")
    say(f"  nvidia-smi: {nvidia_smi_line()}")
    run_r = serve(device, RWKV_CONFIG)
    run_re = serve(device, RWKV_CONFIG, params=run_r["params"], graphs=False)
    graphs["rwkv6-3b"] = engine_graphs_vs_eager(run_r["engine"],
                                                run_r["params"], 8, 4)
    rwkv_fwd = forward_device_ms(run_r["engine"], run_r["params"], None, 8)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in param_tensors(run_r["params"]))
    rwkv_fwd["weight_read_ms"] = weight_bytes / H100_HBM_BYTES_S * 1e3
    say(f"  rwkv6-3b forward, device time (one graph replay): decode "
        f"{rwkv_fwd['decode_ms']:.6f} ms ({rwkv_fwd['decode_kernel_nodes']} "
        f"kernel nodes), prefill {rwkv_fwd['prefill_ms']:.6f} ms; reading "
        f"its {weight_bytes / 1e9:.3f} GB of weights takes "
        f"{rwkv_fwd['weight_read_ms']:.6f} ms at 3.35 TB/s")
    say(f"  tick times (s), graphs / eager: "
        f"{[round(t, 4) for t in run_r['tick_s']]} / "
        f"{[round(t, 4) for t in run_re['tick_s']]}; profiled generate "
        f"latency at full power {run_r['server'].table.latency[0, -1]:.6f} "
        f"/ {run_re['server'].table.latency[0, -1]:.6f} s")
    rwkv_serve = {"model": RWKV_CONFIG.name,
                  "alert_select_launches": run_r["launches"],
                  "tick_s": run_r["tick_s"], "eager_tick_s": run_re["tick_s"],
                  "profiled_latency_s": float(
                      run_r["server"].table.latency[0, -1]),
                  "eager_profiled_latency_s": float(
                      run_re["server"].table.latency[0, -1]),
                  "forward_device_ms": rwkv_fwd}
    counted = {"phase 4": [run_counts(run), run_counts(run_e)],
               "phase 7": [run_counts(run_k), run_counts(run_ke)],
               "phase 10": [run_counts(run_a), run_counts(run_ae)],
               "phase 13": [run_counts(run_r), run_counts(run_re)]}
    del run_r, run_re                 # free rwkv6-3b's 6 GB of weights
    gc.collect()
    torch.cuda.empty_cache()

    phase.start("phase 14: reduced dense models on the card")
    err_dense = {arch: dense_model_cpu_vs_card(device, arch)
                 for arch in ("qwen2.5-14b", "gemma3-1b")}

    dense = {}
    phase.start("phase 15: serve qwen2.5-14b")
    dense["qwen2.5-14b"] = serve_dense(device, QWEN_CONFIG.replace(
        attn_backend="kernel"), floor_ms, opts.breakdown)

    phase.start("phase 16: serve gemma3-1b")
    dense["gemma3-1b"] = serve_dense(device, GEMMA_CONFIG.replace(
        attn_backend="kernel"), floor_ms, opts.breakdown)
    dense["gemma3-1b"]["window_kernel_vs_ref"] = gemma_window_kernel_vs_ref(
        device)

    phase.start("phase 17: serve stablelm-12b")
    dense["stablelm-12b"] = serve_dense(device, STABLELM_CONFIG.replace(
        attn_backend="kernel", n_layers=STABLELM_DEPTH), floor_ms,
        opts.breakdown)

    phase.start("phase 18: reduced MoE models on the card")
    err_moe = {arch: moe_model_cpu_vs_card(device, arch)
               for arch in ("olmoe-1b-7b", "qwen3-moe-30b-a3b")}
    err_moe["olmoe-1b-7b_drops"] = moe_model_cpu_vs_card(
        device, "olmoe-1b-7b", capacity_factor=MOE_DROP_FACTOR)

    moe = {}
    phase.start("phase 19: serve olmoe-1b-7b")
    moe["olmoe-1b-7b"] = serve_dense(device, OLMOE_CONFIG.replace(
        attn_backend="kernel"), floor_ms, opts.breakdown)

    phase.start("phase 20: serve qwen3-moe-30b-a3b")
    moe["qwen3-moe-30b-a3b"] = serve_dense(device, QWEN3_MOE_CONFIG.replace(
        attn_backend="kernel"), floor_ms, opts.breakdown)

    phase.start("phase 21: reduced hybrid and vision-language models on "
                "the card")
    err_hybrid = {arch: reduced_cpu_vs_card(device, get_reduced(
        arch).replace(dtype="float32", attn_backend="kernel"),
        pos3d=arch == "qwen2-vl-2b")
        for arch in ("jamba-v0.1-52b", "qwen2-vl-2b")}

    phase.start(f"phase 22: serve jamba-v0.1-52b ({JAMBA_DEPTH} of "
                f"{JAMBA_CONFIG.n_layers} layers)")
    hybrid = {"jamba-v0.1-52b": serve_dense(device, JAMBA_CONFIG.replace(
        attn_backend="kernel", n_layers=JAMBA_DEPTH), floor_ms,
        opts.breakdown)}

    phase.start("phase 23: serve qwen2-vl-2b")
    vlm = {"qwen2-vl-2b": serve_dense(device, QWEN2VL_CONFIG.replace(
        attn_backend="kernel"), floor_ms, opts.breakdown)}

    phase.start("phase 24: reduced whisper-tiny on the card")
    whisper = {"reduced_cpu_vs_card": whisper_cpu_vs_card(device)}

    phase.start("phase 25: whisper-tiny float32, kernel vs ref backend")
    whisper["kernel_vs_ref"] = whisper_kernel_vs_ref(device)

    phase.start("phase 26: whisper-tiny bf16, graphed decode")
    whisper["served"] = whisper_serve(device, floor_ms=floor_ms,
                                      breakdown=opts.breakdown)
    att["fa"].update(whisper["served"].pop("fa"))
    att["da"].update(whisper["served"].pop("da"))
    counted["whisper-tiny (phase 26)"] = whisper["served"].pop("counts")

    phase.start("phase 27: serve qwen2.5-32b")
    dense["qwen2.5-32b"] = serve_dense(device, QWEN32_CONFIG.replace(
        attn_backend="kernel"), floor_ms, opts.breakdown)

    phase.start("phase 28: qwen2-vl-2b float32 with three pos3d streams, "
                "kernel vs ref backend")
    vlm["qwen2-vl-2b"]["mrope_kernel_vs_ref"] = mrope_kernel_vs_ref(device)
    for name, d in (dense | moe | hybrid | vlm).items():
        counted[f"{name} ({d['n_layers']} layers)"] = d.pop("counts")

    phase.start("phase 29: the fleet simulator's golden traces and schemes "
                "on the card")
    fleet_golden = fleet_goldens(device)
    counted["phase 29"] = fleet_golden.pop("counts")

    phase.start(f"phase 30: a fleet of {FLEET_LANES} streams on the card")
    fleet = fleet_full(device)
    counted["phase 30"] = fleet.pop("counts")
    fleet_keep = fleet.pop("_keep")       # phase 37 (b) reruns it sharded

    phase.start("phase 31: the session gateway on the card")
    gateway = gateway_phase(device)
    counted["phase 31"] = gateway.pop("counts")

    phase.start("phase 32: the megatick on the card")
    megatick = megatick_phase(device)
    counted["phase 32"] = megatick.pop("counts")
    mega_keep = megatick["scale"].pop("_keep")   # and phase 37 (e) this

    phase.start("phase 33: training, then the trained weights served")
    training = training_phase(device)
    counted["phase 33"] = training.pop("counts")

    phase.start("phase 34: rwkv6-3b trained at full width, then served on "
                "rwkv_scan")
    say(f"  nvidia-smi: {nvidia_smi_line()}")
    rwkv_training = rwkv_training_phase(device)
    counted["phase 34"] = rwkv_training.pop("counts")

    phase.start("phase 35: the serving launcher")
    launcher = launcher_run(device)
    counted["phase 35"] = [launcher.pop("counts")]

    phase.start("phase 36: the examples")
    examples = examples_run(device)
    counted["phase 36"] = [e.pop("counts") for e in examples.values()]

    phase.start("phase 37: the lane-sharded decision plane")
    say(f"  nvidia-smi: {nvidia_smi_line()}")
    lane_mesh = mesh_phase(device, fleet_keep, fleet, run_a, mega_keep,
                           megatick["scale"])
    counted["phase 37"] = lane_mesh.pop("counts")
    del fleet_keep, mega_keep

    phase.start("phase 38: the data plane's (data, model) grid")
    say(f"  nvidia-smi: {nvidia_smi_line()}")
    data_plane = grid_phase(device)
    counted["phase 38"] = data_plane.pop("counts")

    phase.start("phase 39: the data plane's dry run")
    say(f"  nvidia-smi: {nvidia_smi_line()}")
    dry_run = dryrun_phase(device)
    counted["phase 39"] = dry_run.pop("counts")
    phase.start(None)
    say(f"== done in {time.perf_counter() - t_start:.1f} s")

    launches = {name: sum(c[name] for runs in counted.values() for c in runs)
                for name in counted["phase 4"][0]}
    by_run = {name: {path: [c[name] for c in runs]
                     for path, runs in counted.items()}
              for name in launches}
    kernels = [{
        "name": "alert_select", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches["alert_select"],
        "max_abs_err": err, "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": None,
        "shape": timing["shape"], "main_path_shape":
            f"S={s_mp},K={k_mp},L={l_mp}",
        "main_path_ms": mp_ms, "main_path_graph_ms": mp_graph_ms,
        "main_path_plain_ms": mp_plain,
        "main_path_bound_ms": mp_bound, "main_path_select_ms": select_ms,
        "version": SELECT_VERSION, "bitwise_cases": n_select_cases,
        "fleet_goldens": fleet_golden, "fleet": fleet, "gateway": gateway,
        "megatick": megatick, "training": training, "launcher": launcher,
        "examples": examples, "lane_mesh": lane_mesh,
        "data_plane": data_plane, "dry_run": dry_run,
        **{f: timing[f] for f in ("instruction_bound_ms",
                                  "fp64_instructions_per_cell",
                                  "fp64_instructions_per_cell_most",
                                  "fp64_sass_counts") if f in timing}}]
    t32 = nm_time[32]
    kernels.append({
        "name": "nested_matmul", "route": "cuda", "source": NM_SOURCE,
        "replaces": NM_REPLACES, "launches": launches["nested_matmul"],
        "max_abs_err": nm_err, "v4_max_abs_err": nm_wide_err,
        "ms": t32["ms"], "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
        "library_ms": t32["library_ms"], "shape": t32["shape"],
        "blocks_ms": t32["blocks_ms"], "eager_ms": t32["eager_ms"],
        "host_us_per_call": t32["host_us_per_call"],
        "blocks_host_us_per_call": t32["blocks_host_us_per_call"],
        "decode_m4": {k: nm_time[4][k] for k in (
            "shape", "ms", "plain_ms", "blocks_ms", "library_ms",
            "bound_ms", "bound_by", "eager_ms", "host_us_per_call")},
        "forward": {f"M={m}": {k: fwd[m][k] for k in (
            "launches", "ms", "plain_ms", "blocks_ms", "library_ms",
            "bound_ms", "bound_by", "eager_ms", "blocks_eager_ms")}
            for m in fwd},
        "version": NM_VERSION, "levels": nm_levels, "split_sweep": nm_sweep,
        "live_triangle": nm_live, "scoring_m512": nm_wide,
        "crossover": {f"M={m}": v for m, v in nm_cross["sums"].items()},
        "crossover_calls": nm_cross["calls"],
        "reduced_model_max_abs_diff": err_model_k,
        "phase7_launches": run_k["nm_launches"],
        "tick_s": {f"blocks_{SERVE_DEPTH}_layers": run["tick_s"],
                   f"kernel_{SERVE_DEPTH}_layers": run_k["tick_s"],
                   "all-kernel": run_a["tick_s"]},
        "eager_tick_s": {f"blocks_{SERVE_DEPTH}_layers": run_e["tick_s"],
                         f"kernel_{SERVE_DEPTH}_layers": run_ke["tick_s"],
                         "all-kernel": run_ae["tick_s"]},
        "generate_s_by_level": harness, "staircase": stairs,
        "forward_device_ms": {f"level_{k}": v for k, v in fwd_dev.items()},
        "node_floor_ms": floor_ms, "engine_graphs": graphs})
    kernels.append(attention_entry(
        "flash_attention", FA_VERSION, FA_SOURCE, FA_REPLACES,
        launches["flash_attention"], att["fa"], "b",
        att_mp["flash_attention"]))
    kernels.append(attention_entry(
        "decode_attention", DA_VERSION, DA_SOURCE, DA_REPLACES,
        launches["decode_attention"], att["da"], "b",
        att_mp["decode_attention"]))
    kernels[-1]["reduced_model_max_abs_diff"] = err_model_a
    kernels[-1]["reduced_dense_max_abs_diff"] = err_dense
    kernels[-1]["served_dense"] = dense
    kernels[-1]["reduced_moe"] = err_moe
    kernels[-1]["served_moe"] = moe
    kernels[-1]["served_hybrid"] = hybrid
    kernels[-1]["served_vlm"] = vlm
    for k in kernels[-2:]:
        k["reduced_hybrid_vlm"] = err_hybrid
        k["whisper"] = whisper
    b_case = rwkv["b"]
    kernels.append({
        "name": "rwkv_scan", "route": "cuda", "source": RS_SOURCE,
        "replaces": RS_REPLACES, "launches": launches["rwkv_scan"],
        "max_abs_err": max(c["err"] for c in rwkv.values()),
        "ms": b_case["ms"], "plain_ms": b_case["plain_ms"],
        "bound_ms": b_case["bound_ms"], "bound_by": b_case["bound_by"],
        "library_ms": None, "shape": b_case["shape"] + ",float32",
        "version": RS_VERSION, "segments": b_case["segments"],
        "segment_sweep": b_case["segment_sweep"],
        "max_tolerance_ratio": max(c["ratio"] for c in rwkv.values()),
        "c_tolerance_ratio": rwkv["c"]["ratio"],
        "cases": {k: {f: c[f] for f in ("shape", "segments", "ratio")}
                  for k, c in rwkv.items()},
        "other_shapes": {"c": {k: v for k, v in rwkv["c"].items()
                               if k not in ("err",)}},
        "main_path": rwkv_mp,
        "reduced_model_max_abs_diff": err_model_r,
        "serve": rwkv_serve, "training": rwkv_training})
    for k in kernels:
        k["launches_by_run"] = by_run[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        say(f"FAIL: {exc}")
        sys.exit(1)
