#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

The main path is RoCoIn's runtime phase: the continuous-batching
``ServingEngine`` closes micro-batches of CIFAR-10 images and the
``QuorumServer`` serves each one — the K student portion forwards, the
per-row failure mask, and ONE launch of the hand-written CUDA kernel
``quorum_aggregate`` (``src/repro_torch/kernels/csrc/quorum_aggregate.cu``)
that merges the portions into logits. The students are full-width
WRN-16-1s sized to the knowledge partitions that the planner cuts from a
256-filter final conv (WRN-16-4's) for the paper's 8-device fleet; the
weights are random, drawn from a seed.

Phases (each raises on failure, and the script then exits non-zero with no
result line):

1. device: the card's name and power limit, capability (9, 0), TF32 off;
2. build the kernel from the checkout's source (nvcc, sm_90a);
3. kernel vs its plain PyTorch version on the card over a sweep of shapes
   and masks, each case also through three views of its portions (the
   output-coded path's transposed stack, a base off 16 bytes, a ragged row
   stride) bit-equal to the contiguous call; timings at the main-path
   shape (per call, and device ms in fp32 and int8, at B = 1, per
   ``block_batch`` and at the sweep's widest merge, each beside
   einsum + bias);
4. fused serve: the K=8 uniform ensemble through the engine; kernel
   launches == dispatched batches + warm-up calls; every batch's logits vs
   the same server built on the CPU;
5. legacy serve: the K=6 mixed-width ensemble, the per-slot loop;
6. int8: phase 4 with ``quantize="int8"``, also held to the fp32 server
   with the JAX package's int8 bounds;
7. ``coded_decode`` (``src/repro_torch/kernels/csrc/coded_decode.cu``) vs
   its plain version over a sweep of shapes, masks and decode rows (R at
   and past the kernel's compile-time bound 16 among them), with NaN and
   Inf in dead shares' rows (held to the plain version on those rows
   zeroed), and as views (the recovery path's transposed stack, an
   unaligned base, an unaligned row stride) bit-equal to the contiguous
   call; timings at the fused output-coded shape in fp32 and int8 (per
   call and device ms beside the einsum; device ms per ``block_batch``)
   and at B = 1;
8. coded serving, three plans through the engine, each held batch by
   batch to the same server on the CPU (quorum fields and share times
   equal, logits within SERVE_TOL), with ``coded_decode`` launched on the
   card exactly as often as the CPU replay decoded: ``coded-fused`` (four
   64-filter slots coded (6,4)), ``coded-legacy`` (the coding benchmark's
   12-device fleet, five slots of 50-52 filters coded (8,5), mixed widths)
   and ``compute-fused`` (two 128-filter slots compute-coded (5,3));
9. repair: a systematic device of the ``coded-fused`` server is removed
   for good, the controller re-encodes its share onto a spare and the
   server migrates; its answers stay within 5e-4 of the pre-loss ones and
   within SERVE_TOL of a CPU twin that went through the same cycle.

The dense-LM serving path (``repro_torch.launch.serve``: prefill, then
greedy decode over a KV cache) runs three more hand-written kernels,
``rmsnorm``, ``flash_attention`` and ``decode_attention``
(``src/repro_torch/kernels/csrc/*.cu``):

10. each held to its plain version over a sweep of shapes in fp32 (rtol/atol
    3e-5) and bf16 (3e-2), the tile edges of the tensor-core flash kernel,
    decode lengths below the number of splits, and rmsnorm at the LM
    paths' widths, ragged widths and bases off 16 bytes among them, and
    timed at llama3.2-1b's serving shapes (batch 4, prompt 512, bf16)
    beside its plain version and one PyTorch call, also by device time
    (``time_callable``); flash also at moonshot's and jamba's D 128
    shapes; rmsnorm and ``F.rms_norm`` also at 2048 rows of each path's
    width and at the decode shape (4, 2048), warm and cold;
11. card vs CPU: llama3.2-1b at full width cut to 2 layers, fp32, weights
    drawn once on the CPU; prompt 64 x batch 4 and 8 decode steps through
    the ``greedy_decode`` helper on both; logits within 1e-3, greedy tokens
    equal, launches exactly 2L+1 / L / L per call;
12. full-width llama3.2-1b (all 16 layers, bf16, random weights from a seed
    on the card) served through ``generate(tiny=False)``: prompt 512 x batch
    4, 32 tokens; launches exactly 1056 / 16 / 496; logits finite; a decode
    step against a prefill of the same tokens; a profile of one prefill and
    of 8 decode steps.

The SSM, MoE and hybrid LM families (``mamba2-130m``,
``moonshot-v1-16b-a3b``, ``jamba-v0.1-52b``) run two more hand-written
kernels, ``ssd_scan`` (the SSM prefill's chunked scan) and ``topk_gating``
(the MoE router), beside the three above:

13. both held to their plain versions over sweeps (ssd_scan: (P, N, Q) at
    mamba2's, jamba's and two tiny sizes, 2, 4 and 16 chunks and one short
    ragged chunk, contiguous rows and the model's strided views, fp32 (the
    CUDA-core kernel) and bf16 (the tensor-core kernel, also with four
    heads under each head group its plan takes; at the tiny N 8 the
    CUDA-core kernel), y in x's dtype and in fp32, the final
    state; topk_gating: N rows, E experts and k; indices equal, weights
    within 1e-5; the scan within the JAX package's own 2e-3 in fp32, and
    for fp32 y and the state from bf16 inputs, and 3e-2 for bf16 y), and
    timed at the serving shapes beside their plain versions (ssd_scan at
    mamba2's and jamba's, also by device time and by head group; the
    gating also beside the PyTorch softmax → topk → renormalise sequence
    and by device time, at moonshot's prefill (2048, 64, 6), jamba's
    (2048, 16, 2) and the decode steps' (4, 64, 6) and (4, 16, 2));
14. card vs CPU, fp32, TF32 off: mamba2-130m at all 24 layers, moonshot at
    full width cut to 2 layers, and the tiny jamba; prompt 256 x batch 2
    and 8 decode steps through ``greedy_decode`` on both; launches exact.
    Router rows that pick other experts on the two sides (near ties summed
    in other orders) are counted and must stay under 1%; logits (within
    1e-3) and tokens (equal) are held in the batch rows where no routing
    differs;
15. full-width bf16 serving, prompt 512 x batch 4, 32 tokens: mamba2-130m
    (24 layers) through ``generate(tiny=False)``, moonshot-v1-16b-a3b cut
    to 16 of its 48 layers and one full-width period (8 layers) of
    jamba-v0.1-52b through ``greedy_decode``; launches exact; logits
    finite; a decode step against a prefill of the same tokens (255 + 1
    against 256 where the scan runs, the MoE at a capacity that drops
    nothing); a profile of one prefill and of 8 decode steps.

The measured cost model and the autotuner (``repro_torch.launch.microbench``,
``repro_torch.kernels.autotune``) run the last two hand-written kernels,
``dequant_matmul`` (the tuner's int8 weight-dequant product) and
``coded_matmul`` (compute coding's shard products):

16. both held to their plain versions (rtol/atol 1e-5) over the JAX tests'
    shapes, ragged and degenerate tiles, B = 0, per-tensor and
    per-channel scales; ``dequant_matmul``'s tensor route (past D 64) at
    ragged shapes and D 2048, where kernel and plain version are each held
    to the fp32 random-walk bound of the fp64 product, each shape's route
    printed; each distinct launch of ``dequant_matmul``'s candidate tiles
    on both routes, and every ``block_batch`` of ``quorum_aggregate`` and ``coded_decode``
    over phases 3 and 7's sweeps, bit for bit against the default; both
    timed beside their plain versions and one PyTorch call, also by device
    time, with the bound of the route each shape takes;
17. the measured path: portion forwards timed on the card and fitted into
    a ``DeviceSpec``; the paper's 8-device fleet planned on measured
    latency (``latency_source == "measured"``) beside the declared plan;
    the three tuners into a fresh table at the serving shapes of phases 4
    and 7 and at bench_roofline's six; the measured plan served through
    the engine with admission on and that table installed, against a CPU
    twin; ``shard_linear_weights`` → ``coded_matmul`` → ``coded_decode``
    for all 10 erasure patterns of a (5, 3) code within 1e-6 × the decode
    gain of ``x @ W``; the table written to a temporary directory.

RoCoIn's offline phase (``repro_torch.core.pipeline``: teacher training,
activation graph, planning, distillation, the FC head, failout) runs no
hand-written kernel; what it trains is served through ``quorum_aggregate``:

18. ``build_rocoin`` at the JAX package's defaults (WRN-16-4 teacher, 150
    teacher and 150 student steps at batch 128, the rocoin planner on
    ``make_fleet(8, seed=1)``, ``FailoutConfig()``) from seed 0 on the
    card: each stage's wall time and steps/s, the plan; teacher and
    all-alive ensemble accuracy within ±0.05 of the JAX package's run at
    the same budget; the first teacher steps' losses card vs CPU; the
    failout stage run twice under deterministic cuDNN, bit-equal; the
    robustness curve into ``thin_replicas``; then the trained ensemble
    served (all-alive logits vs ``Ensemble.predict`` within 1e-5), through
    a traced ``ServingEngine`` (launches = batches + warm-up, critical-path
    segments summing to each latency, ``tracer=None`` giving the same rows)
    and a two-tenant ``FleetEngine``.

Dense-LM training (``repro_torch.launch.train``: AdamW over an fp32 master
copy, ``SyntheticTokens`` batches, checkpoints) differentiates through
``rmsnorm`` and ``flash_attention``, whose backwards are two more
hand-written kernels, ``rmsnorm_bwd`` and ``flash_attention_bwd``
(``src/repro_torch/kernels/csrc/*_bwd.cu``):

19. both backward kernels held to their plain versions (fp32 3e-5, bf16
    3e-2) over sweeps (rmsnorm at the LM widths 768-8192, ragged D and
    bases off 16 bytes; flash at D 32/64/96/128, G 1 to 4, causal and
    not, Sq != Skv, both routes' tile edges, strided q and dO, each case's
    route printed: bf16 at D 64/128 on the tensor cores, the rest on the
    CUDA cores), each case run twice and bit-equal; timed at llama3.2-1b's
    training shapes (batch 4 x 512, bf16; flash also at its students'
    G 2, and on the CUDA-core route for the record) beside their bounds,
    their plain versions and one PyTorch call (``F.rms_norm``'s and SDPA's
    autograd backward); each of the five serving-only wrappers (no
    backward) raises under grad;
20. card vs CPU training: llama3.2-1b at full width cut to 2 layers, fp32,
    weights drawn once on the CPU, 2 AdamW steps on the same batches
    (batch 4 x 64): losses within 1e-3 relative, step-1 gradients within
    1e-3 leaf by leaf, every gradient finite and nonzero, launches exactly
    2L+1 / 2L+1 / L / L a step (rmsnorm, rmsnorm_bwd, flash, flash_bwd);
21. full-width bf16 llama3.2-1b cut to 4 of its 16 layers (0.76 B
    parameters) through ``train.run(tiny=False, steps=20, batch=4,
    seq=512, ckpt_every=10)``: launches exact, loss finite and falling, every
    layer's step-1 gradient nonzero, the step-10 checkpoint restored and
    stepped to 20 bit-equal to the run's state; step ms, tokens/s and a
    profile of one step;
22. RoCoIn at LM scale: ``plan_lm_rocoin`` on a full-width llama3.2-1b
    teacher over ``make_fleet(4, seed=1)``, two students distilled (3 steps
    each at batch 4 x 512) and failout-tuned (2 steps) on the card through
    the kernels and their backwards; the merged portions through the
    teacher's head finite with either slot lost.

Training the SSM, MoE and hybrid families differentiates through
``ssd_scan`` and ``topk_gating`` too, whose backwards are the last two
hand-written kernels, ``ssd_scan_bwd`` and ``topk_gating_bwd``:

23. both held to their plain backward versions: the scan at mamba2-130m's
    and jamba's training shapes (batch 4 x 512, chunk 256) and small ones
    (a ragged chunk count on each route, L below the chunk), fp32 and
    bf16 (bf16 at the models' (P, N) on the tensor route), the final
    state's gradient zero and not, B and C head-shared (B, L, N), expanded
    over the heads with stride 0, and per head, and the tensor route at
    chunk 256 with dt = softplus(0) (the reference's NaN); every fp32
    gradient within 2e-3 of its largest entry (the forward's bound), a
    bf16 one also within one bf16 step of each value; the gating at
    moonshot's (2048, 64, 6), jamba's (2048, 16, 2), a decode step's (4,
    64, 6), N = 0, tied rows and near-zero weights, within 1e-5; every
    case run twice and bit-equal; both timed at the training shapes by
    device time beside their bounds, their plain versions and autograd of
    their plain forwards (no one PyTorch call computes either backward),
    the scan also beside its tensor route's own bound;
24. card vs CPU training, tiny fp32 mamba2-130m, moonshot-v1-16b-a3b and
    jamba-v0.1-52b (TF32 off): one step's loss and every gradient leaf
    within 1e-3, the eight training kernels' launches exact;
25. full width: mamba2-130m uncut, bf16, through ``train.run(tiny=False,
    steps=20, batch=4, seq=512, ckpt_every=10)`` (loss falling, every
    layer's step-1 gradient finite and nonzero, the step-10 checkpoint
    stepped to 20 bit-equal, step ms, tokens/s, a profile with the scan
    backward's launches apart);
    moonshot-v1-16b-a3b cut to 2 layers through ``train.run`` for 10 steps
    without checkpoints (loss falling, every leaf's step-1 gradient finite
    and nonzero); one period (8 layers) of jamba-v0.1-52b through one
    ``loss_and_grads`` at batch 4 x 512 (every leaf finite and nonzero,
    peak memory); each with the eight kernels' launches exact.

The VLM (qwen2-vl-7b: precomputed patch embeddings, M-RoPE, 28 heads
padded to 32 over 4 kv heads) and the enc-dec (whisper-medium: 1500
encoder frames, LayerNorm, sinusoidal positions) reach ``flash_attention``,
its backward and ``decode_attention`` at routes no earlier phase runs from
a model: a group of 8 at D 128, non-causal self-attention over 1500 keys,
cross-attention of Sq decoder rows over Skv encoder rows, a decode step
over a fixed-length cross cache:

26. those kernels at those shapes against their plain versions, each
    case twice and bit-equal (qwen2-vl causal (4, 4, 8, 512, 128);
    whisper's encoder (4, 16, 1, 1500, 64) and its cross-attention, Sq 64
    and 512 over Skv 1500 and 512, non-causal; decode at G 8 / D 128 over
    a 544-row cache and over the 1500-row cross cache; the tiny configs'
    fp32 D 32 at G 16 and G 2), the bf16 ones timed by device time beside
    their bounds, their plain versions and SDPA (forward and autograd
    backward);
27. card vs CPU, tiny fp32 qwen2-vl-7b (M-RoPE over three distinct
    streams) and whisper-medium (24 frames, a 15-token prompt), TF32 off:
    a prefill and 8 greedy decode steps within 1e-3 of the CPU's, tokens
    equal; one ``loss_and_grads`` within 1e-3 leaf by leaf; launches of
    rmsnorm, rmsnorm_bwd, flash, flash_bwd and decode exact;
28. full width, bf16: qwen2-vl-7b uncut (7.72 B parameters) through
    ``generate(tiny=False, prompt_len=512, gen=32, batch=4)`` and one
    ``loss_and_grads`` on 4 x 512 patch embeddings (every layer's gradient
    finite and nonzero, the unused token embedding's zero; peak memory),
    then cut to 4 layers through ``train.run`` for 10 steps without
    checkpoints (loss falling); whisper-medium uncut through
    ``generate(tiny=False, prompt_len=64, gen=32, batch=4, frames=1500)``
    and ``train.run(tiny=False, steps=10, batch=4, seq=512)`` (loss
    falling, every layer's step-1 gradient finite and nonzero, a rerun
    bit-equal; no checkpoint: phase 21's use most of a call's disk
    writes); launches exact throughout, prefill ms, decode ms/token, step
    ms and tokens/s, each with a profile.

The multi-device tooling (``repro_torch.launch.{mesh,steps,dryrun,
roofline}``, ``parallel.*``) on the one card:

29. a one-process NCCL group and a (1, 1) ``DeviceMesh``; full-width
    llama3.2-1b cut to 4 layers (phase 21's depth), batch 4 x 512, bf16
    over fp32 master: two ``mesh_step``
    train steps (ZeRO-1 on) bit-equal to two ``make_train_step`` steps
    (losses, every param and master leaf), a mesh prefill and 8 mesh
    serve steps bit-equal to ``greedy_decode`` (tokens and logits), the
    five LM kernels' launches in that window each above 0; the mesh state
    snapshotted to host as ``CheckpointManager.save`` snapshots it
    (``ckpt.checkpoint.snapshot``; no file is written: phase 21's two
    checkpoints write and read the format at this width), restored from the snapshot onto
    the mesh with placements (``from_snapshot``, ``restore``'s code after
    the file read) and stepped bit-equal to the off-mesh third step; then
    ``dryrun.run_cell`` at one chip on ``H100_SXM`` for the train and prefill cells of llama3.2-1b and
    mamba2-130m cut to batch 4 x 512 (llama's train cell to phase 21's
    4 layers), each bound (ms, dominant term)
    printed beside the step phases 12, 15, 21 and 25 measured there, its
    share of the measured wall time at most 1.05.

Tensor parallelism (``repro_torch.parallel.tensor``; ``mesh_step`` and
``greedy_decode`` on a mesh with ``model`` > 1):

30. ``flash_attention`` and ``decode_attention`` at the ranks' shapes at
    ``model`` 2 against their plain versions, each twice bit-equal:
    llama3.2-1b's 4 of 8 kv heads, granite-20b's 24 heads over its one kv
    head (flash, D 128) and all 48 heads over a rank's block of 272
    cached positions (decode with its log-sum-exp: lse within 1e-4,
    o = 0 and lse = -inf at length 0, o without the lse the same bits),
    timed beside their bounds, plain versions and SDPA; then two spawned
    ranks sharing the one card over gloo (NCCL refuses two ranks of one
    group on one device) on a (1, 2) mesh: llama3.2-1b at full width cut
    to 2 layers in fp32 (every logit within rtol/atol 1e-3), then in bf16
    llama3.2-1b and granite-20b at full width cut to 4 layers (the whole
    granite, ~55 GB, cannot share the card with its two halves; each
    logit within 3e-2 of its row's largest |logit|: a rank
    rounds its share of a product before the sum), random weights that
    each rank draws whole and cuts (``shard_params``), prompt 4 x 512 and
    32 decode steps teacher-forced with the one-process run's tokens on
    the same card, the greedy tokens equal counted, each
    rank's launches of rmsnorm, flash and decode exact, prefill and decode
    times per rank and the collectives' share (timed between
    synchronisations), none a multi-card speed.
31. the MoE on a ``model`` axis, as the reference's
    ``_moe_apply_shard_map`` splits it: ``flash_attention`` and
    ``decode_attention`` at moonshot-v1-16b-a3b's rank shapes (8 of 16 kv
    heads, D 128; checked and timed in phase 30's kernel pass), then two
    ranks on the (1, 2) mesh as in phase 30: moonshot at full width cut to
    2 layers in fp32 (expert-parallel: 32 of 64 experts a rank; every
    logit within rtol/atol 1e-3), then again to 2 of its 48 layers in
    bf16 (~3.6 GB whole; each logit within 3e-2 of its row's largest
    |logit|), each rank's routes recorded beside the one-process run's:
    only logit rows at or past a position whose route differs may pass
    the bound (printed), and differing router rows stay under 1%; then
    four ranks on a (2, 2) mesh serving tiny moonshot with 3 experts in
    fp32 (every logit within 1e-3): no published config has an expert
    count that two ranks fail to divide, so this is the card's run of the
    ff-sharded experts, their d cut over ``data``, the prefill's weight
    gather and the 2-D decode. Launches of rmsnorm, flash, decode and
    ``topk_gating`` exact per rank; times per rank and the collectives'
    share as in phase 30.
32. the SSM and hybrid families on a ``model`` axis (a mamba mixer's SSM
    heads, or every head's block of channels, as the decode state's spec
    places them; the gated norm's sums of squares and ``out_proj``
    summed over ``model``): ``ssd_scan`` at the ranks' shapes at
    ``model`` 2 (mamba2-130m's 12 of 24 heads, jamba's 64 of 128) against
    its plain version within 2e-3, twice bit-equal, timed by device time
    beside its bound; then two ranks on the (1, 2) mesh: mamba2-130m
    at 12 of its 24 layers in fp32 (every logit within rtol/atol 1e-3, greedy tokens
    equal) and in bf16 (3e-2 of each row's largest |logit|), one
    full-width jamba-v0.1-52b period in bf16 (~26.5 GB whole: the ranks
    draw it in turn behind a barrier, each cutting its ~13.3 GB block
    before the next draws), held on the ranks' routes replayed in one
    process (the unreplayed rows past 3e-2 printed); then four ranks on
    a (1, 4) mesh in fp32 (within 1e-3, tokens equal): tiny jamba (its 2
    kv heads over 4 ranks: the MQA fallbacks beside the mamba split) and
    a tiny SSM of 3 heads of 64 channels (the head-dim split, ``in_proj``
    whole). Launches of rmsnorm (one fewer per mamba layer per call: the
    split gated norm runs in plain ops around its all-reduce), flash,
    decode, ``ssd_scan`` and ``topk_gating`` exact per rank; times per
    rank and the collectives' share as in phase 30.
33. the VLM and the enc-dec on a ``model`` axis: ``flash_attention`` and
    ``decode_attention`` at the ranks' shapes at ``model`` 2 (qwen2-vl's
    16 of 32 heads over 2 kv heads; whisper-medium's encoder over 1500
    frames, its cross-attention and its self and 1500-row cross caches)
    against their plain versions, timed beside SDPA; then two ranks on
    the (1, 2) mesh: qwen2-vl-7b at full width cut to 2 layers in fp32
    (every logit within rtol/atol 1e-3, tokens equal) and 4 in bf16
    (patch embeddings with M-RoPE streams that differ; its 4 inert heads
    on the last rank), whisper-medium at 8 of its 24 encoder and
    decoder layers in fp32 (1500 frames, a 64-token decoder prompt; the
    cross cache holds the encoder's rows)
    and in bf16 cut to ``ENCDEC_TP_BF16_LAYERS`` encoder and decoder
    layers, where one process's own bf16 lies within 3e-2 of its fp32
    function (both distances printed); bf16 within 3e-2 of each row's
    largest |logit|; then four ranks on a (1, 4) mesh serving the tiny
    configs in fp32 (within 1e-3, tokens equal): qwen2-vl's ranks past the
    first hold only inert heads, whisper's 2 kv heads over 4 ranks take
    wk/wv cut on d at prefill and sequence-sharded self and cross caches.
    Launches of flash and decode (and the VLM's rmsnorm) exact per rank;
    times per rank and the collectives' share as in phase 30.
34. the dense family's train step on a ``model`` axis (``mesh_step`` of
    kind train with ``model`` > 1: the sums autograd sees, the
    vocabulary-parallel cross-entropy, the clip's norm over both axes):
    ``rmsnorm``, ``flash_attention`` and their backward kernels at the
    ranks' shapes (llama3.2-1b's 4 of 8 kv heads in fp32 and bf16,
    granite-20b's 24 of 48 heads over its one kv head in fp32; the norms
    at D 2048 and 6144) against their plain versions, twice bit-equal,
    timed beside their bounds, ``F.rms_norm`` / SDPA and those calls'
    autograd backward; then two ranks on the (1, 2) mesh, each run held
    to its one-process run on the card (``make_train_step``, the same
    TP_SEED weights and batches, run first and freed, its results in
    host memory), 3 AdamW steps of 4 x 512 with warmup 1 and the clip
    acting: llama3.2-1b at 2 layers and granite-20b at 1 (the MQA's
    wk/wv cut on d) in fp32 (losses and grad norms within 1e-4 relative,
    every leaf of the gathered master copy and moments within 1e-3, the
    params the master's bits), llama3.2-1b at 4 layers in bf16 over the
    fp32 master (losses 1e-2, grad norms and first-step gradients 3e-2
    of each leaf's largest: readings printed, a miss written, not
    raised); then four ranks on a (2, 2) mesh training tiny llama in fp32
    (ZeRO-1 over ``data`` beside the split, held as the fp32 runs). Rank
    0 streams the gathered leaves (``launch.steps.gathered``) to the
    parent through its pipe, which holds each to the reference as it
    arrives. The leaves replicated on ``model`` bit-equal across the
    ranks after every step; launches of rmsnorm, rmsnorm_bwd, flash and
    flash_bwd exact per rank and step (2L+1, 2L+1, L, L); per rank step
    ms and collectives a step (timed between synchronisations), none a
    multi-card speed.
35. the MoE family's train step on a ``model`` axis (the router's
    gradient summed over ``model``, an expert matrix cut on d over
    ``data`` gathered by an all-gather whose backward reduce-scatters
    its gradient, its ZeRO-1 block that block): ``flash_attention`` and
    its backward at moonshot-v1-16b-a3b's rank shape (8 of 16 heads, D
    128) in fp32 and bf16 against their plain versions, twice bit-equal,
    timed beside their bounds and SDPA (the norms' and the router's rank
    shapes are phase 34's and phase 13's / 23's); then, in the spawns of
    phases 30-34, two ranks on the (1, 2) mesh training
    moonshot-v1-16b-a3b at full width cut to 2 of 48 layers,
    expert-parallel (32 of 64 experts a rank), 3 AdamW steps of 4 x 512:
    in fp32 held as phase 34's fp32 runs (losses and grad norms 1e-4
    relative of the one-process run, the gathered master copy of the
    router, the experts and the norms within 1e-3 elementwise) with under
    1% of router rows picking other experts than the one-process run; in
    bf16 held as phase 34's bf16 run (readings printed, a miss written)
    against the one-process run replayed on the ranks' experts, its
    weights recomputed from its own logits so that the router's gradient
    flows, the unreplayed router rows that differ printed; then four ranks
    training tiny moonshot in fp32 with 3 experts on (2, 2) (ff-sharded, d
    over ``data``: the FSDP leaves, ZeRO-1) and with 4 on (1, 4) (one
    expert a rank), held as the fp32 runs. The leaves replicated on
    ``model`` (the router among them) bit-equal across the ranks after
    every step; launches of rmsnorm, rmsnorm_bwd, flash, flash_bwd,
    topk_gating and topk_gating_bwd exact per rank and step (2L+1, 2L+1,
    L, L, L, L); per rank step ms and collectives a step, none a
    multi-card speed.

Each phase's wall seconds are printed on a line of their own
(``phase <function>: <s> s``).

The last two lines of standard output are the ``kernels`` JSON line
(thirteen entries) and the ``ok`` JSON line. Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import fcntl
import io
import itertools
import json
import multiprocessing
import os
import queue
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.ckpt.checkpoint import (CheckpointManager,  # noqa: E402
                                         flatten_with_keys, from_snapshot,
                                         snapshot)
from repro_torch.coding.codes import decode_matrix, make_generator  # noqa: E402
from repro_torch.coding.compute import (ComputeRuntime,  # noqa: E402
                                        shard_linear_weights)
from repro_torch.coding.planner import select_redundancy  # noqa: E402
from repro_torch.coding.runtime import CodedRuntime  # noqa: E402
from repro_torch.core import lm_students as LMS  # noqa: E402
from repro_torch.core import ncut as NC  # noqa: E402
from repro_torch.core import pipeline as PP  # noqa: E402
from repro_torch.core import planner as PL  # noqa: E402
from repro_torch.core.assignment import StudentArch  # noqa: E402
from repro_torch.core.grouping import Device  # noqa: E402
from repro_torch.core.pipeline import Ensemble  # noqa: E402
from repro_torch.core.plan_ir import (PlanIR, device_matrix,  # noqa: E402
                                      eq1a_latency, student_matrix)
from repro_torch.core.failout import FailoutConfig  # noqa: E402
from repro_torch.core.scenarios import PoissonArrivals  # noqa: E402
from repro_torch.core.simulator import FailureModel, make_fleet  # noqa: E402
from repro_torch.data.images import (ImageTaskConfig,  # noqa: E402
                                     SyntheticImages)
from repro_torch.data.tokens import (SyntheticTokens,  # noqa: E402
                                     TokenTaskConfig)
from repro_torch.compat import local  # noqa: E402
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import coded_matmul as ops_cm  # noqa: E402
from repro_torch.kernels import decode_attention as ops_da  # noqa: E402
from repro_torch.kernels import dequant_matmul as ops_dq  # noqa: E402
from repro_torch.kernels import flash_attention as ops_fa  # noqa: E402
from repro_torch.kernels._layout import num_sms  # noqa: E402
from repro_torch.kernels import ssd_scan as SS  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import microbench as MB  # noqa: E402
from repro_torch.launch.roofline import (H100_SXM,  # noqa: E402
                                         H100_SXM_FP32_FLOPS)
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402
from repro_torch.launch.serve import (generate, greedy_decode,  # noqa: E402
                                      random_prompt, splice)
from repro_torch.models import api, cnn, hybrid  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.obs.report import critical_path, request_paths  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compression import quantize_weight  # noqa: E402
from repro_torch.parallel import tensor as TP  # noqa: E402
from repro_torch.runtime.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.runtime.fleet import (FleetEngine, FleetRouter,  # noqa: E402
                                       SLOClass, TenantSpec)
from repro_torch.runtime.serving import server_from_ensemble  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_to  # noqa: E402

KERNELS = ("quorum_aggregate", "coded_decode", "rmsnorm", "flash_attention",
           "decode_attention", "ssd_scan", "topk_gating", "dequant_matmul",
           "coded_matmul", "rmsnorm_bwd", "flash_attention_bwd",
           "ssd_scan_bwd", "topk_gating_bwd")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/quorum_aggregate.cu"
TPU_KERNEL = "src/repro/kernels/quorum_aggregate.py:33"
DECODE_SOURCE = "src/repro_torch/kernels/csrc/coded_decode.cu"
DECODE_TPU_KERNEL = "src/repro/kernels/coded_decode.py:37"
HBM_BYTES_PER_S = H100_SXM.hbm_bw      # device memory
FP32_FLOPS = H100_SXM_FP32_FLOPS       # fp32 outside the tensor cores
BF16_FLOPS = H100_SXM.peak_flops       # bf16 tensor cores, dense
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# GPU (cuDNN, TF32 off) vs CPU (oneDNN) fp32: the same 16 conv layers summed
# in other orders, and cuDNN may pick Winograd or FFT algorithms. On the
# CPU these logits (|x| < 5) sit within 1e-6 of their fp64 values; the
# bound leaves room for the card's algorithms, far below a wrong merge
SERVE_TOL = dict(rtol=1e-3, atol=1e-3)
# int8 vs fp32 deployment: the JAX package's bounds
# (tests/test_fastpath.py::test_int8_masks_failures_like_fp32)
INT8_TOL = dict(rtol=0.1, atol=0.05)
INT8_MIN_AGREEMENT = 0.95
# coded recovery vs the pre-loss answer: the JAX package's own bound
# (tests/test_coding.py::test_coded_serving_recovers_clean_logits)
RECOVER_TOL = dict(rtol=5e-4, atol=5e-4)
MAIN_SHAPE = dict(K=8, B=256, Dk=32, C=10)
WIDE_SHAPE = dict(K=8, B=1000, Dk=640, C=100)   # the sweep's widest merge
# the fused output-coded step's decode: B rows, R = K + P shares, F = Dk
DECODE_SHAPE = dict(B=256, R=6, K=4, F=64)
# (R, K, F) of the decode sweeps: the serving codes' (6,4), (8,5) and
# (5,3), a wide slot, and R at and past the kernel's compile-time bound 16
CD_SWEEP = ((6, 4, 64), (8, 5, 52), (5, 3, 43), (12, 8, 640), (16, 10, 64),
            (17, 10, 64))
N_REQUESTS = 64                 # per serving phase, Poisson at 200/s
MAX_REQUEST_ROWS = 32           # request sizes uniform in 1..32 images
PROFILE_ROWS, PROFILE_CALLS = 256, 5
# the dense-LM serving path
LM_ARCH = "llama3.2-1b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 512, 32
LM_DECODE_LENGTH = 528          # the middle of the run's 513..543 fills
LM_SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu"
              for k in ("rmsnorm", "flash_attention", "decode_attention")}
LM_TPU = {"rmsnorm": "src/repro/kernels/rmsnorm.py:13",
          "flash_attention": "src/repro/kernels/flash_attention.py:28",
          "decode_attention": "src/repro/kernels/decode_attention.py:21"}
# the JAX package's own kernel tolerances (tests/test_kernels.py:11-13)
LM_KERNEL_TOL = {torch.float32: dict(rtol=3e-5, atol=3e-5),
                 torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
# a bf16 decode step vs a bf16 prefill of the same tokens: bf16 rounds at
# other places on the two paths; relative to each row's largest |logit|
LM_STEP_TOL = 5e-2
# rmsnorm's sweep: the registry's widths, the paths' (768, 1536, 4096, 8192)
# and ragged ones (the scalar route); its timed shapes: 2048 rows of a
# prefill at each path's width, and a decode step's 4 rows
RMS_SWEEP_D = (128, 768, 1536, 2048, 3072, 4096, 6144, 8192, 100, 1000, 2047)
RMS_TIMED = ((2048, 768), (2048, 1536), (2048, 2048), (2048, 4096),
             (2048, 8192), (4, 2048))
COLD_BYTES = 100 * 2 ** 20      # twice the L2: a rotation's inputs
# the SSM, MoE and hybrid serving paths
LM_KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "ssd_scan",
              "topk_gating")
SSM_MOE_SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu"
                   for k in ("ssd_scan", "topk_gating")}
SSM_MOE_TPU = {"ssd_scan": "src/repro/kernels/ssd_scan.py:24",
               "topk_gating": "src/repro/kernels/topk_gating.py:19"}
MOE_ARCH = "moonshot-v1-16b-a3b"
# (arch, depth cut or None): phase 15's models, full width (moonshot cut
# to 16 of its 48 layers, ~10 GB, and jamba to one period: the call's
# time limit)
SSM_MOE_SERVE = (("mamba2-130m", None), (MOE_ARCH, 16),
                 ("jamba-v0.1-52b", 8))
# the JAX package's gating bounds (tests/test_kernels.py::test_topk_gating)
GATE_TOL = dict(rtol=1e-5, atol=1e-5)
# ssd_scan in fp32: the JAX package's own bound for this kernel
# (tests/test_kernels.py::test_ssd_scan, 2e-3). The scan takes
# exp(cum_t - cum_s) of fp32 cumulative sums that reach |cum| ~ 10^3 over a
# 256-step chunk (A down to -e^3), where one rounding is ~1e-4: kernel and
# plain version sum in other orders and differ by that much relative
SSD_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
           torch.bfloat16: LM_KERNEL_TOL[torch.bfloat16]}
MAX_ROUTE_DIFF = 0.01           # share of router rows that may differ


# -- the planner benchmarks' fleet definition (benchmarks/common.py) -----------

def paper_students():
    """The three-tier student cost zoo the planner benchmarks share."""
    return [StudentArch("small", 5e6, 0.6e6, 64, 0.15e6),
            StudentArch("mid", 2e7, 1.5e6, 64, 0.4e6),
            StudentArch("big", 5e7, 3.5e6, 64, 1.2e6)]


def affinity_graph(M: int, seed: int = 0) -> np.ndarray:
    """Synthetic filter-affinity graph with the benchmarks' shared spectrum."""
    rng = np.random.default_rng(seed)
    a = np.abs(rng.normal(size=(2 * M, M)))
    A = (a.T @ a) * np.abs(a.mean(0)[:, None] - a.mean(0)[None, :])
    np.fill_diagonal(A, 0)
    return 0.5 * (A + A.T)


# -- helpers -------------------------------------------------------------------

def max_err(out: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float
            ) -> float:
    """Max abs error; raises when any element is outside atol + rtol·|ref|."""
    if out.shape != ref.shape:
        raise AssertionError(f"shape {tuple(out.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite output")
    diff = (out - ref).abs()
    if (diff > atol + rtol * ref.abs()).any():
        raise AssertionError(f"max abs err {diff.max().item():.3e} outside "
                             f"rtol {rtol} atol {atol}")
    return float(diff.max()) if diff.numel() else 0.0


def cuda_ms(fn, iters: int = 200, warm: int = 20) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_pair(kernel, library) -> dict:
    """Device ms per call (``time_callable``: the calls queued behind a spin
    kernel, so the host's launch work is out of the time) of a kernel and
    of its library yardstick."""
    return dict(device_ms=MB.time_callable(kernel, repeats=200,
                                           warmup=3) * 1e3,
                library_device_ms=MB.time_callable(library, repeats=200,
                                                   warmup=3) * 1e3)


def qa_operands(K, B, Dk, C, mask, int8, gen, dev):
    """Merge operands shaped like the serving path's: pooled ReLU features
    in [0, 1) and FC slices of scale 1/sqrt(K·Dk)."""
    p = torch.rand((K, B, Dk), generator=gen, device=dev)
    b = torch.randn((C,), generator=gen, device=dev)
    m = torch.as_tensor(mask, dtype=torch.int32, device=dev)
    if int8:
        w = torch.randint(-127, 128, (K, Dk, C), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (0.5 + torch.rand((K,), generator=gen, device=dev)) \
            / (127 * (K * Dk) ** 0.5)
    else:
        w = torch.randn((K, Dk, C), generator=gen, device=dev) \
            / (K * Dk) ** 0.5
        s = None
    return p, w, b, m, s


def qa_bound(K, B, Dk, C, mask, int8) -> tuple:
    """(bound_ms, bound_by) of one merge: the bytes it must move (arrived
    slots' portions and weights, bias, mask, scales, the logits) over the
    HBM rate vs its flops over the fp32 rate."""
    alive = int(np.count_nonzero(mask))
    nbytes = (alive * B * Dk * 4 + alive * Dk * C * (1 if int8 else 4)
              + C * 4 + K * 4 + (K * 4 if int8 else 0) + B * C * 4)
    flops = 2 * alive * B * Dk * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def merge_views(p: torch.Tensor) -> dict:
    """Views holding ``p``'s (K, B, Dk) values with unit stride along Dk:
    the output-coded path's transposed (B, K, Dk) stack, a base 4 bytes
    past 16, and a row stride that 4 does not divide."""
    K, B, Dk = p.shape
    off = torch.empty(p.numel() + 1, device=p.device)[1:].view(K, B, Dk)
    wide = torch.empty((K, B, Dk + 1), device=p.device)[..., :Dk]
    off.copy_(p)
    wide.copy_(p)
    return {"transposed": p.transpose(0, 1).contiguous().transpose(0, 1),
            "base+4": off, "row stride": wide}


def merge_device_times(args) -> dict:
    """Device ms of the merge and of einsum + bias on the same operands
    (int8 weights expanded by their scales beforehand for the einsum)."""
    p, w, b, m, s = args
    wf = w.float() * s[:, None, None] if s is not None else w
    return device_pair(lambda: ops.quorum_aggregate(p, w, b, m, s),
                       lambda: torch.einsum("kbd,kdc->bc", p, wf) + b)


# -- phases ----------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability (9, 0)), "
                           f"got {cap}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: off (cudnn.allow_tf32 = cuda.matmul.allow_tf32 = False); "
          "convolutions and matmuls run in full fp32")
    return line


def phase_build() -> float:
    """One nvcc per kernel source, all started together, then dlopen."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.build, KERNELS))
    for name in KERNELS:
        build.load(name)
    secs = time.perf_counter() - t0
    print(f"build: {', '.join(build.library_path(n).name for n in KERNELS)}"
          f" in {secs:.2f} s")
    return secs


def phase_kernel(dev) -> dict:
    """Kernel vs plain version over the sweep; timings at the main shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    n_cases = n_views = 0
    for int8 in (False, True):
        for K in (6, 8):
            masks = {"ones": np.ones(K, np.int32),
                     "mixed": (np.arange(K) % 3 != 1).astype(np.int32),
                     "zeros": np.zeros(K, np.int32)}
            for Dk in (32, 43, 640):
                for C in (10, 100):
                    errs = []
                    for B in (0, 1, 7, 256, 1000):
                        for mname, mask in masks.items():
                            p, w, b, m, s = qa_operands(K, B, Dk, C, mask,
                                                        int8, gen, dev)
                            out = ops.quorum_aggregate(p, w, b, m, s)
                            ref = ops.quorum_aggregate_ref(p, w, b, m, s)
                            for vname, view in merge_views(p).items():
                                if not same_bits(ops.quorum_aggregate(
                                        view, w, b, m, s), out):
                                    raise AssertionError(
                                        f"quorum_aggregate K={K} B={B} "
                                        f"Dk={Dk} C={C} {vname} view: bits "
                                        f"differ from the contiguous call")
                                n_views += 1
                            torch.cuda.synchronize()
                            e = max_err(out, ref, **KERNEL_TOL)
                            errs.append(f"B{B}/{mname}:{e:.1e}")
                            worst = max(worst, e)
                            n_cases += 1
                    print(f"kernel {'int8' if int8 else 'fp32'} K={K} "
                          f"Dk={Dk} C={C}: " + " ".join(errs))
    print(f"kernel vs plain: {n_cases} cases within rtol/atol 1e-5, "
          f"max abs err {worst:.3e}; {n_views} view launches bit-equal to "
          f"the contiguous call")

    K, B, Dk, C = (MAIN_SHAPE[k] for k in ("K", "B", "Dk", "C"))
    mask = np.ones(K, np.int32)
    p, w, b, m, s = qa_operands(K, B, Dk, C, mask, False, gen, dev)
    ms = cuda_ms(lambda: ops.quorum_aggregate(p, w, b, m))
    plain_ms = cuda_ms(lambda: ops.quorum_aggregate_ref(p, w, b, m))
    library_ms = cuda_ms(lambda: torch.einsum("kbd,kdc->bc", p, w) + b)
    bound_ms, bound_by = qa_bound(K, B, Dk, C, mask, False)
    print(f"timing at K={K} B={B} Dk={Dk} C={C} fp32: kernel {ms:.5f} ms, "
          f"plain {plain_ms:.5f} ms, einsum+bias {library_ms:.5f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by})")
    device = {}
    for name, (KBDC, int8) in {
            "fp32": ((K, B, Dk, C), False), "int8": ((K, B, Dk, C), True),
            "fp32 B1": ((K, 1, Dk, C), False),
            "fp32 widest": (tuple(WIDE_SHAPE.values()), False)}.items():
        mk = np.ones(KBDC[0], np.int32)
        args = qa_operands(*KBDC, mk, int8, gen, dev)
        device[name] = t = merge_device_times(args)
        print(f"device ms at (K,B,Dk,C)={KBDC} {name}: kernel "
              f"{t['device_ms']:.5f}, einsum+bias "
              f"{t['library_device_ms']:.5f}, bound "
              f"{qa_bound(*KBDC, mk, int8)[0]:.6f}")
    per_bb = {c["block_batch"]: MB.time_callable(
        lambda c=c: ops.quorum_aggregate(p, w, b, m, **c), repeats=200,
        warmup=3) * 1e3 for c in AT._configs("quorum_aggregate")}
    print(f"device ms at the serving shape fp32 by block_batch: "
          + ", ".join(f"{bb}: {t:.5f}" for bb, t in sorted(per_bb.items())))
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                device_ms=device["fp32"]["device_ms"])


def device_breakdown(prof, calls: int) -> tuple:
    """(kernel launches seen, kernel name → ms per call, device-busy ms per
    call) of a ``torch.profiler`` run over ``calls`` calls. Busy is the
    union of the kernels' intervals on the device timeline: kernels on
    several streams may overlap, so their sum can exceed it."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name = {}
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / calls
    busy_us, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        if e.time_range.end > start:
            busy_us += e.time_range.end - start
        end = max(end, e.time_range.end)
    return len(events), per_name, busy_us / 1e3 / calls


def phase_profile(ens: Ensemble, dev, label: str = "fused",
                  failure: FailureModel = None) -> None:
    """Where one fused batch's time goes: ``torch.profiler`` over a few
    ``serve_batch`` calls of PROFILE_ROWS images (after warm-up), clean
    unless ``failure`` says otherwise. Prints wall and device-busy time per
    batch, the two kernels' shares, and the kernels that take the most
    device time."""
    rows, calls = PROFILE_ROWS, PROFILE_CALLS
    srv = server_from_ensemble(ens, failure=failure
                               or FailureModel(outages=False), device=dev)
    x = torch.randn((rows, 32, 32, 3), device=dev)
    for _ in range(3):
        srv.serve_batch([x])[0].block_until_ready()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            srv.serve_batch([x])[0].block_until_ready()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    n_events, per_name, busy = device_breakdown(prof, calls)
    if not n_events:
        print(f"profile: {label} batch of {rows}: wall {wall_ms:.3f} ms; "
              f"device time not measured (the profiler saw no kernels)")
        return
    total = sum(per_name.values())
    merge = sum(t for k, t in per_name.items() if "quorum_aggregate" in k)
    decode = sum(t for k, t in per_name.items() if "coded_decode" in k)
    top = "; ".join(f"{k[:60]} {t:.4f} ms" for k, t in
                    sorted(per_name.items(), key=lambda kv: -kv[1])[:5])
    print(f"profile: {label} batch of {rows}: wall {wall_ms:.3f} ms, device "
          f"busy {busy:.3f} ms ({busy / wall_ms:.1%} of wall; kernel times "
          f"sum to {total:.3f} ms over {n_events // calls} launches), "
          f"merge kernel {merge:.4f} ms, decode kernel {decode:.4f} ms; "
          f"top: {top}")


def ensemble(mem_range=None, seed: int = 0) -> Ensemble:
    """WRN-16-1 students over the planner's cut of a 256-filter final conv
    for the paper's 8-device fleet, random weights from ``seed``."""
    kw = {} if mem_range is None else {"mem_range": mem_range}
    ir = PL.tune_d_th_ir(make_fleet(8, seed=1, **kw), affinity_graph(256),
                         paper_students(), p_th=0.25)
    return ensemble_for(ir, seed)


def ensemble_for(ir: PlanIR, seed: int = 0) -> Ensemble:
    """Full-width WRN-16-1 students for the partitions of ``ir`` and an FC
    head over their portions, random weights from ``seed``."""
    dims = [int(d) for d in ir.partition.sum(1)]
    gen = torch.Generator().manual_seed(seed)
    students = [cnn.make_student(gen, "wrn-16-1", 10, d) for d in dims]
    fc = {"kernel": torch.randn((sum(dims), 10), generator=gen)
          / sum(dims) ** 0.5,
          "bias": 0.1 * torch.randn((10,), generator=gen)}
    return Ensemble(ir.to_plan(), students, fc, dims, float("nan"), ir=ir)


def record_calls(server) -> list:
    """Wrap ``server.serve_batch`` to keep each call's inputs, failure model,
    a copy of its generator, and results, for replay on another server."""
    calls = []
    serve = server.serve_batch

    def recorded(xs, *, rng=None):
        entry = (list(xs), server.failure, copy.deepcopy(rng))
        out = serve(xs, rng=rng)
        calls.append(entry + (out,))
        return out
    server.serve_batch = recorded
    return calls


def warmup_calls(sizes: np.ndarray, cfg: EngineConfig, server) -> int:
    """serve_batch calls of ``ServingEngine._warmup``: every power-of-two
    row bucket up to max(sizes)·max_batch, clean and — when slot 0 has
    replica devices to force down — with slot 0 down."""
    buckets, b = 1, 1
    while b < int(sizes.max()) * cfg.max_batch:
        b <<= 1
        buckets += 1
    arrays = server.arrays
    passes = 2 if arrays.n_slots and len(arrays.slot_cols[0]) else 1
    return passes * buckets


@contextlib.contextmanager
def counting_plain_decodes():
    """Count the ``coded_decode`` calls made while the block runs (the CPU
    replay's plain-version calls, which the launch counter leaves alone)."""
    calls = []
    plain = ops.coded_decode

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return plain(*args, **kw)
    ops.coded_decode = counted
    try:
        yield calls
    finally:
        ops.coded_decode = plain


def decode_gain(server, share_times) -> float:
    """The largest row abs-sum of the decode weights a request was served
    with (1 when no decode ran): how much the decode can magnify the
    card-vs-CPU difference of the portions it reads (reported beside the
    error; the check is SERVE_TOL itself)."""
    if share_times is None:
        return 1.0
    rt = server._coded_runtime(server.ir)
    if rt is not None:
        decs = [rt.decode_weights(np.isfinite(share_times)[None])]
    else:
        decs, _ = server._compute_runtime(server.ir).decode_weights(
            share_times[None])
    return max([1.0] + [float(np.abs(d).sum(-1).max()) for d in decs])


def phase_serve(name: str, ens: Ensemble, dev, *, quantize="none",
                fused: bool, seed: int = 0, fp32_twin=None,
                coded: bool = False, admission: bool = False) -> dict:
    """Serve a Poisson trace through the engine on ``dev``; hold every
    batch to the same server built on the CPU (and, for int8, to the fp32
    server on ``dev``). A coded phase replays every call, warm-up included,
    and holds the card's ``coded_decode`` launches to the replay's decodes.
    ``admission`` turns on the engine's SLO admission control, which sheds
    on the plan's ``objective()``. Returns the phase's counts and errors,
    and both servers."""
    failure = FailureModel(crash_prob=0.05, outages=True)
    srv = server_from_ensemble(ens, failure=failure, seed=seed,
                               quantize=quantize, device=dev)
    cpu = server_from_ensemble(ens, failure=failure, seed=seed,
                               quantize=quantize, device="cpu")
    if srv.fastpath_active is not fused:
        raise AssertionError(f"{name}: fused path active = "
                             f"{srv.fastpath_active}, expected {fused}")
    calls = record_calls(srv)
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1 / 200.0, N_REQUESTS))
    sizes = rng.integers(1, MAX_REQUEST_ROWS + 1, N_REQUESTS)
    cfg = EngineConfig(max_batch=8, max_wait=0.01, slo=1.0, seed=seed,
                       admission=admission)

    def images(r, rows):
        x = r.standard_normal((rows, 32, 32, 3)).astype(np.float32)
        return torch.from_numpy(x).to(dev)

    engine = ServingEngine(srv, cfg, make_input=images)
    ops.quorum_aggregate.launches = 0           # the main path's window
    ops.coded_decode.launches = 0
    t0 = time.perf_counter()
    report = engine.run(times, sizes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.quorum_aggregate.launches
    decodes = ops.coded_decode.launches

    warm = warmup_calls(sizes, cfg, srv)
    if not (launches == len(calls) == len(report.batches) + warm):
        raise AssertionError(
            f"{name}: {launches} kernel launches for {len(calls)} "
            f"serve_batch calls = {len(report.batches)} batches + {warm} "
            f"warm-up calls")
    summary = report.summary()
    if summary["n"] + summary["rejected"] != N_REQUESTS:
        raise AssertionError(f"{name}: served {summary['n']} and shed "
                             f"{summary['rejected']} of {N_REQUESTS} "
                             f"requests")

    worst = max_gain = 0.0
    agree, total, worst_int8 = 0, 0, 0.0
    with counting_plain_decodes() as cpu_decodes:
        for xs, fm, rng_b, out in calls[0 if coded else warm:]:
            cpu.failure = fm
            ref = cpu.serve_batch([x.cpu() for x in xs],
                                  rng=copy.deepcopy(rng_b))
            twin = None
            if fp32_twin is not None:
                fp32_twin.failure = fm
                twin = fp32_twin.serve_batch(xs, rng=copy.deepcopy(rng_b))
            for i, (a, b) in enumerate(zip(out, ref)):
                if not ((a.arrived == b.arrived).all()
                        and a.latency == b.latency
                        and a.degraded == b.degraded
                        and (a.share_times is None) == (b.share_times is None)
                        and (a.share_times is None or np.array_equal(
                            a.share_times, b.share_times))):
                    raise AssertionError(f"{name}: quorum fields differ "
                                         f"from the CPU server")
                la = torch.from_numpy(a.logits)
                if la.shape != (xs[i].shape[0], 10):
                    raise AssertionError(f"{name}: logits "
                                         f"{tuple(la.shape)}")
                max_gain = max(max_gain, decode_gain(cpu, b.share_times))
                worst = max(worst, max_err(la, torch.from_numpy(b.logits),
                                           **SERVE_TOL))
                if twin is not None:
                    lf = torch.from_numpy(twin[i].logits)
                    worst_int8 = max(worst_int8, max_err(la, lf, **INT8_TOL))
                    agree += int((la.argmax(-1) == lf.argmax(-1)).sum())
                    total += la.shape[0]
    if coded and not (decodes == len(cpu_decodes) and decodes > 0):
        raise AssertionError(
            f"{name}: {decodes} coded_decode launches on the card, "
            f"{len(cpu_decodes)} decodes in the CPU replay")
    rows = int(sum(b.rows for b in report.batches))
    line = (f"{name}: {summary['n']} requests, {rows} rows in "
            f"{len(report.batches)} batches, degraded share "
            f"{summary['degraded_rate']:.3f}, wall {wall:.3f} s, "
            f"launches {launches} (= {len(report.batches)} batches + {warm} "
            f"warm-up), max abs err vs CPU {worst:.3e}")
    if admission:
        line += (f", admission on: {summary['admitted']} admitted, "
                 f"{summary['rejected']} shed at objective "
                 f"{srv.ir.objective():.3e} s")
    if coded:
        line += (f", coded_decode launches {decodes} (= CPU replay's "
                 f"{len(cpu_decodes)}), share futures "
                 f"{summary['share_futures']}, cancelled shares "
                 f"{summary['cancelled_shares']}, largest decode gain "
                 f"{max_gain:.1f}")
    out = dict(launches=launches, decodes=decodes, max_abs_err=worst,
               server=srv, cpu=cpu)
    if fp32_twin is not None:
        share = agree / total
        if share < INT8_MIN_AGREEMENT:
            raise AssertionError(f"{name}: int8 top-1 agreement {share:.3f}"
                                 f" < {INT8_MIN_AGREEMENT}")
        line += (f", int8 vs fp32: top-1 agreement {share:.4f}, max abs "
                 f"err {worst_int8:.3e}")
    print(line)
    return out


# -- coded serving ---------------------------------------------------------------

def replicated_ir(pairs: int, spares: int, p_out: float, M: int,
                  speed) -> PlanIR:
    """The coding tests' fixture: ``pairs`` pair-replicated slots of
    ``M / pairs`` filters each, plus unassigned spare devices
    (tests/test_coding.py, tests/test_coded_compute.py)."""
    n = 2 * pairs + spares
    devs = [Device(f"d{i}", speed(i), 2e6, 500, p_out) for i in range(n)]
    names, dcaps = device_matrix(devs)
    snames, scaps = student_matrix([StudentArch("s", 5e6, 0.6e6, 64, 0.15e6)])
    member = np.zeros((pairs, n), bool)
    part = np.zeros((pairs, M), bool)
    for k in range(pairs):
        member[k, 2 * k:2 * k + 2] = True
        part[k, (M // pairs) * k:(M // pairs) * (k + 1)] = True
    return PlanIR(names, dcaps, snames, scaps, member, part,
                  np.zeros(pairs, np.int64), np.arange(pairs, dtype=np.int64),
                  eq1a_latency(scaps, dcaps), np.zeros((M, M)), 1.0, 0.5)


def coded_plans() -> dict:
    """The three coded plans of the coded-serving phases, over a 256-filter
    final conv, each from the port's own ``select_redundancy``."""
    fleet = make_fleet(12, seed=0, mem_range=(1e6, 4e6), success_prob=0.8)
    rep = PL.tune_d_th_ir(fleet, affinity_graph(256), paper_students(),
                          p_th=0.05, seed=0)
    plans = {
        "coded-fused": select_redundancy(
            replicated_ir(4, 2, 0.25, 256, lambda i: (1 + i % 3) * 1e7),
            code_k=4, parity=2),
        "coded-legacy": select_redundancy(rep, code_k=5),
        "compute-fused": select_redundancy(
            replicated_ir(2, 6, 0.1, 256, lambda i: 1e7 * (1 + 0.01 * i)),
            code_k=3, parity=2, mode="compute"),
    }
    want = {"coded-fused": "coded(6,4)", "coded-legacy": "coded(8,5)",
            "compute-fused": "coded_compute(5,3)"}
    for name, ir in plans.items():
        if set(ir.redundancy_modes()) != {want[name]}:
            raise AssertionError(f"{name}: modes {ir.redundancy_modes()}")
        print(f"plan {name}: K={ir.K}, widths "
              f"{sorted(set(int(d) for d in ir.partition.sum(1)))}, modes "
              f"{want[name]} x {ir.K}")
    return plans


def erasures(rng, B: int, n: int, k: int) -> np.ndarray:
    """(B, n) arrival patterns with 1 to n - k erased shares per row."""
    arrived = np.ones((B, n), bool)
    for b in range(B):
        dead = rng.choice(n, int(rng.integers(1, n - k + 1)), replace=False)
        arrived[b, dead] = False
    return arrived


def pinv_rows(R: int, K: int, B: int, rng, plans: dict) -> np.ndarray:
    """(B, K, R) pseudo-inverse decode rows for random recoverable erasure
    patterns, from the serving runtimes of the coded plans where one has
    this (R, K), else from the codes' own decode matrix."""
    if (R, K) == (6, 4):
        return CodedRuntime(plans["coded-fused"]).decode_weights(
            erasures(rng, B, R, K))
    if (R, K) == (8, 5):
        return CodedRuntime(plans["coded-legacy"]).decode_weights(
            erasures(rng, B, R, K))
    if (R, K) == (5, 3):
        rt = ComputeRuntime(plans["compute-fused"])
        e = rt.entries[0]
        share_t = rng.exponential(1.0, (B, int(rt.entries[-1].ids[-1]) + 1))
        share_t[:, e.ids] = np.where(erasures(rng, B, R, K),
                                     share_t[:, e.ids], np.inf)
        return rt.decode_weights(share_t)[0][0]
    G = make_generator(R, K)
    rows = [decode_matrix(G, a) for a in erasures(rng, B, R, K)]
    return np.array(rows, np.float32).reshape(B, K, R)


def cd_operands(B, R, K, F, mask_kind, dec_kind, int8, gen, dev, rng, plans):
    """Decode operands: shares, decode rows of one kind, an arrival mask."""
    if int8:
        sh = torch.randint(-127, 128, (B, R, F), generator=gen, device=dev,
                           dtype=torch.int8)
        s = (0.5 + torch.rand((R,), generator=gen, device=dev)) / 127
    else:
        sh = torch.randn((B, R, F), generator=gen, device=dev)
        s = None
    if dec_kind == "identity":
        dec = np.broadcast_to(np.eye(K, R, dtype=np.float32), (B, K, R))
    elif dec_kind == "pinv":
        dec = pinv_rows(R, K, B, rng, plans)
    else:
        dec = np.zeros((B, K, R), np.float32)
    mask = {"ones": np.ones((B, R)), "zeros": np.zeros((B, R)),
            "mixed": rng.random((B, R)) > 0.3}[mask_kind].astype(np.int32)
    dec = torch.from_numpy(np.array(dec, np.float32, order="C")).to(dev)
    return sh, dec, torch.from_numpy(mask).to(dev), s


def cd_bound(B, R, K, F, mask, int8, scales) -> tuple:
    """(bound_ms, bound_by) of one decode: the bytes it must move (the
    arrived shares' payload, dec, mask, scales when given, the output) over
    the HBM rate vs its flops over the fp32 rate."""
    live = int(np.count_nonzero(mask))         # arrived (row, share) pairs
    nbytes = (live * F * (1 if int8 else 4) + B * K * R * 4 + B * R * 4
              + (R * 4 if scales else 0) + B * K * F * 4)
    flops = 2 * K * live * F
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def dead_garbage(sh: torch.Tensor, m: torch.Tensor) -> tuple:
    """(shares with NaN and Inf, or for int8 -128, in every dead share's
    row; the same shares with those rows zeroed)."""
    dead = (m == 0)[:, :, None].expand_as(sh)
    if sh.dtype == torch.int8:
        garbage = torch.full_like(sh, -128)
    else:
        garbage = torch.full_like(sh, float("nan"))
        garbage[..., ::2] = float("inf")
    return (torch.where(dead, garbage, sh),
            torch.where(dead, torch.zeros_like(sh), sh))


def share_views(sh: torch.Tensor) -> dict:
    """The shares as views: an (R, B, F) stack transposed (the recovery
    path's layout, read in place), a base one element off and a row stride
    of F + 1 (both off the 4-column access: the scalar route)."""
    B, R, F = sh.shape
    off = torch.empty(sh.numel() + 1, dtype=sh.dtype, device=sh.device)
    off[1:].copy_(sh.reshape(-1))
    wide = torch.zeros((B, R, F + 1), dtype=sh.dtype, device=sh.device)
    wide[..., :F] = sh
    return {"stack": sh.transpose(0, 1).contiguous().transpose(0, 1),
            "base": off[1:].view(B, R, F), "stride": wide[..., :F]}


def phase_decode_kernel(dev, plans: dict) -> dict:
    """coded_decode vs its plain version over the sweep (R at and past the
    kernel's compile-time bound among it), with NaN and Inf in dead shares'
    rows, and as the views the recovery path and the scalar route take;
    timings at the fused output-coded shape (fp32 and int8, each
    ``block_batch`` candidate, and B = 1)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    worst, n_cases, n_dead, n_views = 0.0, 0, 0, 0
    for int8 in (False, True):
        for R, K, F in CD_SWEEP:
            errs = []
            for B in (0, 1, 7, 256, 1000):
                e_b = 0.0
                for mname in ("ones", "mixed", "zeros"):
                    for dname in ("identity", "pinv", "zero"):
                        sh, dec, m, s = cd_operands(B, R, K, F, mname, dname,
                                                    int8, gen, dev, rng,
                                                    plans)
                        out = ops.coded_decode(sh, dec, m, s)
                        ref = ops.coded_decode_ref(sh, dec, m, s)
                        torch.cuda.synchronize()
                        e_b = max(e_b, max_err(out, ref, **KERNEL_TOL))
                        n_cases += 1
                        for name, v in share_views(sh).items():
                            if not same_bits(ops.coded_decode(v, dec, m, s),
                                             out):
                                raise AssertionError(
                                    f"coded_decode {name} view B={B} R={R} "
                                    f"K={K} F={F}: bits differ")
                            n_views += 1
                    # garbage in dead shares never reaches the sum
                    sh, dec, m, s = cd_operands(B, R, K, F, mname, "pinv",
                                                int8, gen, dev, rng, plans)
                    bad, clean = dead_garbage(sh, m)
                    out = ops.coded_decode(bad, dec, m, s)
                    torch.cuda.synchronize()
                    e_b = max(e_b, max_err(out, ops.coded_decode_ref(
                        clean, dec, m, s), **KERNEL_TOL))
                    n_dead += 1
                worst = max(worst, e_b)
                errs.append(f"B{B}:{e_b:.1e}")
            print(f"decode kernel {'int8' if int8 else 'fp32'} R={R} K={K} "
                  f"F={F}: " + " ".join(errs))
    print(f"decode kernel vs plain: {n_cases} cases and {n_dead} with NaN/"
          f"Inf (int8: -128) in dead shares' rows within rtol/atol 1e-5, "
          f"max abs err {worst:.3e}; {n_views} view launches (stack, base, "
          f"stride) bit-equal to the contiguous call")

    B, R, K, F = (DECODE_SHAPE[k] for k in ("B", "R", "K", "F"))
    t = {}
    for int8 in (False, True):
        sh, dec, m, s = cd_operands(B, R, K, F, "ones", "pinv", int8, gen,
                                    dev, rng, plans)
        w = dec * m[:, None, :] * (s if int8 else 1.0)   # dec · mask · s
        shf = sh.float()
        kind = "int8" if int8 else "fp32"
        t[kind] = dict(
            ms=cuda_ms(lambda: ops.coded_decode(sh, dec, m, s)),
            plain_ms=cuda_ms(lambda: ops.coded_decode_ref(sh, dec, m, s)),
            library_ms=cuda_ms(lambda: torch.einsum("bkr,brf->bkf", w, shf)),
            **device_pair(lambda: ops.coded_decode(sh, dec, m, s),
                          lambda: torch.einsum("bkr,brf->bkf", w, shf)))
        t[kind]["bound_ms"], t[kind]["bound_by"] = cd_bound(
            B, R, K, F, m.cpu().numpy(), int8, int8)
        print(f"decode timing at B={B} R={R} K={K} F={F} {kind}, all shares "
              f"arrived: kernel {t[kind]['ms']:.5f} ms, plain "
              f"{t[kind]['plain_ms']:.5f} ms, einsum "
              f"{t[kind]['library_ms']:.5f} ms per call, bound "
              f"{t[kind]['bound_ms']:.6f} ms ({t[kind]['bound_by']}); device: "
              f"kernel {t[kind]['device_ms']:.5f} ms, einsum "
              f"{t[kind]['library_device_ms']:.5f} ms")
        if not int8:
            per_bb = {c["block_batch"]: MB.time_callable(
                lambda c=c: ops.coded_decode(sh, dec, m, **c), repeats=200,
                warmup=3) * 1e3 for c in AT._configs("coded_decode")}
            print(f"decode device ms by block_batch at B={B} fp32: "
                  + ", ".join(f"{bb}: {v:.5f}"
                              for bb, v in sorted(per_bb.items())))
    sh, dec, m, _ = cd_operands(1, R, K, F, "ones", "pinv", False, gen, dev,
                                rng, plans)
    w = dec * m[:, None, :]
    floor = device_pair(lambda: ops.coded_decode(sh, dec, m),
                        lambda: torch.einsum("bkr,brf->bkf", w, sh))
    print(f"decode floor at B=1 R={R} K={K} F={F} fp32: device kernel "
          f"{floor['device_ms']:.5f} ms, einsum "
          f"{floor['library_device_ms']:.5f} ms; bound "
          f"{cd_bound(1, R, K, F, m.cpu().numpy(), False, False)[0]:.6f} ms")
    return dict(max_abs_err=worst, **{k: t["fp32"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "device_ms")})


def phase_repair(name: str, srv, cpu) -> dict:
    """Permanent loss of a systematic device on the coded-fused server
    (and its CPU twin): the controller re-encodes the share onto a spare,
    the server migrates, and the answers stay within RECOVER_TOL of the
    pre-loss ones — served clean, and with another systematic device down
    so the re-encoded plan decodes."""
    x = torch.randn((64, 32, 32, 3), generator=torch.Generator().manual_seed(5))
    for server in (srv, cpu):
        server.failure = FailureModel(outages=False)
    before = srv.serve_batch([x], rng=np.random.default_rng(0))[0].logits
    ir = srv.ir
    victim = ir.device_names[int(np.flatnonzero(ir.member[0])[0])]
    out = srv.remove_device(victim)
    cpu_out = cpu.remove_device(victim)
    if out.kind != "reencode" or not out.reencoded_shares:
        raise AssertionError(f"{name}: repair outcome {out.kind} "
                             f"{out.reencoded_shares}, expected a re-encode")
    if (cpu_out.kind, cpu_out.reencoded_shares, cpu_out.moved_devices) != \
            (out.kind, out.reencoded_shares, out.moved_devices):
        raise AssertionError(f"{name}: the CPU twin repaired differently")
    worst = worst_cpu = 0.0
    dead = srv.ir.device_names[int(np.flatnonzero(srv.ir.member[1])[0])]
    launches = decodes = 0
    for failure in (FailureModel(outages=False),
                    FailureModel(forced_failures=[dead], outages=False)):
        srv.failure = cpu.failure = failure
        ops.quorum_aggregate.launches = 0       # the repaired path's window
        ops.coded_decode.launches = 0
        a = srv.serve_batch([x], rng=np.random.default_rng(1))[0]
        torch.cuda.synchronize()
        launches += ops.quorum_aggregate.launches
        decodes += ops.coded_decode.launches
        b = cpu.serve_batch([x], rng=np.random.default_rng(1))[0]
        if not (a.arrived.all() and not a.degraded
                and (a.arrived == b.arrived).all()):
            raise AssertionError(f"{name}: degraded after the repair")
        la = torch.from_numpy(a.logits)
        worst = max(worst, max_err(la, torch.from_numpy(before),
                                   **RECOVER_TOL))
        worst_cpu = max(worst_cpu, max_err(la, torch.from_numpy(b.logits),
                                           **SERVE_TOL))
    if launches != 2 or decodes != 1:
        raise AssertionError(f"{name}: {launches} merges and {decodes} "
                             f"decodes for 2 serves, one of them decoded")
    print(f"{name}: {victim} removed, share(s) {out.reencoded_shares} "
          f"re-encoded onto {out.moved_devices}; clean and {dead}-down "
          f"answers within {worst:.3e} of the pre-loss logits and "
          f"{worst_cpu:.3e} of the CPU twin; launches {launches} merges, "
          f"{decodes} decode")
    return dict(launches=launches, decodes=decodes)


# -- dense-LM serving: rmsnorm, flash_attention, decode_attention -------------------

def roofline(nbytes: float, flops: float, dtype) -> tuple:
    """(bound_ms, bound_by): bytes over the HBM rate vs operations over the
    peak rate for the inputs' type, whichever is larger."""
    rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rmsnorm_bound(rows, D, dtype) -> tuple:
    """Read x and the scale once, write the output once; 4 flops per
    element (square, sum, and two products)."""
    e = torch.finfo(dtype).bits // 8
    return roofline(2 * rows * D * e + D * e, 4 * rows * D, dtype)


def attention_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """(query, key) pairs a call must score: ``j <= i`` when causal."""
    if not causal:
        return Sq * Skv
    return sum(min(i + 1, Skv) for i in range(Sq))


def flash_bound(B, KV, G, Sq, Skv, D, causal, dtype) -> tuple:
    """q, k, v read once and o written once; 2·D flops for q·k and 2·D for
    p·v per scored pair."""
    e = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * KV * G * Sq * D + 2 * B * KV * Skv * D) * e
    flops = 4 * D * B * KV * G * attention_pairs(Sq, Skv, causal)
    return roofline(nbytes, flops, dtype)


def decode_bound(B, KV, G, length, D, dtype, lse: bool = False) -> tuple:
    """The K and V rows below ``length`` read once, q read and o written
    once (and the fp32 lse, with ``lse``); 4·D flops per (query head,
    position)."""
    e = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * KV * length * D + 2 * B * KV * G * D) * e
    return roofline(nbytes + 4 * B * KV * G * lse,
                    4 * D * B * KV * G * length, dtype)


def flash_operands(B, KV, G, S, D, dtype, strided, gen, dev, Skv=None):
    """q as a view of a (B, S, KV, G, D) projection and k, v of (B, Skv,
    KV, D) ones (Skv = S by default), as the model passes them (or
    contiguous copies)."""
    Skv = S if Skv is None else Skv
    qm = torch.randn((B, S, KV, G, D), generator=gen, device=dev).to(dtype)
    km = torch.randn((B, Skv, KV, D), generator=gen, device=dev).to(dtype)
    vm = torch.randn((B, Skv, KV, D), generator=gen, device=dev).to(dtype)
    q, k, v = qm.permute(0, 2, 3, 1, 4), km.permute(0, 2, 1, 3), \
        vm.permute(0, 2, 1, 3)
    if strided:
        return q, k, v
    return q.contiguous(), k.contiguous(), v.contiguous()


def decode_operands(B, KV, G, S, D, dtype, gen, dev):
    """q as a view of a (B, 1, H, D) projection, caches as views of
    (B, S, KV, D) ones, as the model passes them."""
    q = torch.randn((B, 1, KV * G, D), generator=gen, device=dev).to(dtype)
    kc = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dtype)
    vc = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dtype)
    return q.view(B, KV, G, D), kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)


def lm_check(out, ref, dtype) -> float:
    return max_err(out.float(), ref.float(), **LM_KERNEL_TOL[dtype])


def phase_lm_kernels(dev) -> dict:
    """rmsnorm, flash_attention and decode_attention vs their plain
    versions over sweeps of shapes in fp32 and bf16; each timed at the
    serving shapes of llama3.2-1b (batch 4, prompt 512, bf16)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    dtypes = (torch.float32, torch.bfloat16)
    worst = {k: 0.0 for k in LM_SOURCES}
    cases = {k: 0 for k in LM_SOURCES}
    for dtype in dtypes:
        for D in RMS_SWEEP_D:
            errs = []
            for rows in (0, 1, 4, 7, 2048, 4097):
                x = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
                sc = torch.randn((D,), generator=gen, device=dev).to(dtype)
                out = ops.rmsnorm(x, sc)
                torch.cuda.synchronize()
                e = lm_check(out, ops.rmsnorm_ref(x, sc), dtype)
                if rows in (4, 2048):   # a base off 16 bytes: scalar route
                    xo = unaligned_copy(x)
                    e = max(e, lm_check(ops.rmsnorm(xo, sc),
                                        ops.rmsnorm_ref(xo, sc), dtype))
                    cases["rmsnorm"] += 1
                worst["rmsnorm"] = max(worst["rmsnorm"], e)
                cases["rmsnorm"] += 1
                errs.append(f"rows{rows}:{e:.1e}")
            print(f"rmsnorm {str(dtype)[6:]} D={D}: " + " ".join(errs))
    flash_shapes = ((1, 1, 1, 128, 64), (2, 2, 4, 256, 64), (1, 4, 2, 128, 128),
                    (4, 8, 4, 512, 64), (1, 1, 4, 7, 64), (2, 8, 4, 509, 64),
                    # the tensor-core kernel's tile edges (64 keys a tile,
                    # 128 rows a block), grok's G = 6, MQA past one kv tile,
                    # and the CUDA-core kernel's head dims
                    (1, 2, 1, 63, 64), (2, 1, 2, 65, 64), (1, 2, 1, 127, 128),
                    (1, 1, 1, 129, 64), (1, 2, 6, 100, 128),
                    (1, 1, 48, 130, 128), (1, 2, 3, 33, 96), (1, 2, 2, 5, 32),
                    # D 128 past the 3-stage K/V ring (5 and 8 kv tiles)
                    (1, 2, 1, 300, 128), (4, 16, 1, 512, 128))
    for dtype in dtypes:
        for B, KV, G, S, D in flash_shapes:
            errs = []
            for causal in (True, False):
                for strided in (False, True):
                    q, k, v = flash_operands(B, KV, G, S, D, dtype, strided,
                                             gen, dev)
                    out = ops.flash_attention(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    e = lm_check(out, ops.flash_attention_ref(
                        q, k, v, causal=causal), dtype)
                    worst["flash_attention"] = max(worst["flash_attention"], e)
                    cases["flash_attention"] += 1
                    errs.append(f"{'causal' if causal else 'full'}/"
                                f"{'strided' if strided else 'contig'}:{e:.1e}")
            print(f"flash {str(dtype)[6:]} (B,KV,G,S,D)=({B},{KV},{G},{S},{D})"
                  f": " + " ".join(errs))
    for dtype in dtypes:
        for B, KV, G, D in ((4, 8, 4, 64), (1, 1, 48, 128), (2, 32, 1, 96),
                            (4, 16, 1, 128)):
            errs = []
            for S in (1, 256, 544):
                # 2 and 3 leave splits past ``length`` empty
                for length in sorted({min(n, S) for n in
                                      (1, 2, 3, (S + 1) // 2, S)}):
                    q, kc, vc = decode_operands(B, KV, G, S, D, dtype, gen, dev)
                    ref = ops.decode_attention_ref(q, kc, vc, length)
                    e = 0.0
                    for n in (length, torch.tensor([length], dtype=torch.int32,
                                                   device=dev)):
                        out = ops.decode_attention(q, kc, vc, n)
                        torch.cuda.synchronize()
                        e = max(e, lm_check(out, ref, dtype))
                        cases["decode_attention"] += 1
                    worst["decode_attention"] = max(worst["decode_attention"], e)
                    errs.append(f"S{S}/len{length}:{e:.1e}")
            print(f"decode {str(dtype)[6:]} (B,KV,G,D)=({B},{KV},{G},{D}): "
                  + " ".join(errs))
    for k in LM_SOURCES:
        print(f"{k} vs plain: {cases[k]} cases within rtol/atol 3e-5 (fp32) "
              f"and 3e-2 (bf16), max abs err {worst[k]:.3e}")

    # timings at the serving shapes, bf16, the operands as the model has them
    cfg = get_config(LM_ARCH)
    bf = torch.bfloat16
    B, S, d = LM_BATCH, LM_PROMPT, cfg.d_model
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // KV
    F = torch.nn.functional
    timing = {}
    x = torch.randn((B, S, d), generator=gen, device=dev).to(bf)
    sc = (1 + 0.1 * torch.randn((d,), generator=gen, device=dev)).to(bf)
    timing["rmsnorm"] = dict(
        ms=cuda_ms(lambda: ops.rmsnorm(x, sc)),
        plain_ms=cuda_ms(lambda: ops.rmsnorm_ref(x, sc)),
        library_ms=cuda_ms(lambda: F.rms_norm(x, (d,), sc, 1e-6)),
        shape=f"x ({B}, {S}, {d}) bf16",
        **device_pair(lambda: ops.rmsnorm(x, sc),
                      lambda: F.rms_norm(x, (d,), sc, 1e-6)))
    timing["rmsnorm"]["bound_ms"], timing["rmsnorm"]["bound_by"] = \
        rmsnorm_bound(B * S, d, bf)
    worst["rmsnorm"] = max(worst["rmsnorm"], rmsnorm_widths(gen, dev))
    # llama3.2-1b's shape (D 64), then moonshot's and jamba's (D 128); each
    # timed shape's output is also held to the plain version
    more = []
    for i, (Bf, KVf, Gf, Df) in enumerate(((B, KV, G, hd), (B, 16, 1, 128),
                                           (B, 8, 4, 128))):
        q, k, v = flash_operands(Bf, KVf, Gf, S, Df, bf, True, gen, dev)
        e = lm_check(ops.flash_attention(q, k, v, causal=True),
                     ops.flash_attention_ref(q, k, v, causal=True), bf)
        worst["flash_attention"] = max(worst["flash_attention"], e)
        print(f"flash bf16 timed shape (B,KV,G,S,D)=({Bf},{KVf},{Gf},{S},"
              f"{Df}) causal/strided vs plain: {e:.1e}")
        qh = q.reshape(Bf, KVf * Gf, S, Df)         # (B, H, S, D), h = kv·G + g
        kh, vh = k.contiguous(), v.contiguous()
        t = attention_timing(
            lambda: ops.flash_attention(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                   enable_gqa=Gf > 1),
            f"(B,KV,G,S,D)=({Bf},{KVf},{Gf},{S},{Df}) bf16 causal, strided "
            f"views", flash_bound(Bf, KVf, Gf, S, S, Df, True, bf))
        if i == 0:
            t["plain_ms"] = cuda_ms(lambda: ops.flash_attention_ref(
                q, k, v, causal=True), iters=20, warm=3)
            timing["flash_attention"] = t
        else:
            more.append(t)
    Smax, n = LM_PROMPT + LM_GEN, LM_DECODE_LENGTH
    q, kc, vc = decode_operands(B, KV, G, Smax, hd, bf, gen, dev)
    qd = q.reshape(B, KV * G, 1, hd)
    kd, vd = kc[:, :, :n].contiguous(), vc[:, :, :n].contiguous()
    e = lm_check(ops.decode_attention(q, kc, vc, n),
                 ops.decode_attention_ref(q, kc, vc, n), bf)
    worst["decode_attention"] = max(worst["decode_attention"], e)
    print(f"decode bf16 timed shape (B,KV,G,D)=({B},{KV},{G},{hd}), cache "
          f"{Smax}, length {n} vs plain: {e:.1e}")
    t = attention_timing(
        lambda: ops.decode_attention(q, kc, vc, n),
        lambda: F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True),
        f"(B,KV,G,D)=({B},{KV},{G},{hd}) bf16, cache {Smax}, length {n}",
        decode_bound(B, KV, G, n, hd, bf))
    t["plain_ms"] = cuda_ms(lambda: ops.decode_attention_ref(q, kc, vc, n))
    timing["decode_attention"] = t
    for name, t in timing.items():
        t["max_abs_err"] = worst[name]
        report_timing(name, t)
    for t in more:
        report_timing("flash_attention", t)
    return timing


def unaligned_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous view whose base is one element off 16 bytes."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x.reshape(-1))
    return buf[1:].view(x.shape)


def rotation(rows: int, D: int, dtype, gen, dev):
    """(one input, a callable returning the next of inputs that together
    exceed COLD_BYTES, so each call finds its input out of the L2)."""
    n = max(2, -(-COLD_BYTES // (rows * D * torch.finfo(dtype).bits // 8)))
    buf = torch.randn((n * rows, D), generator=gen, device=dev).to(dtype)
    xs = itertools.cycle(buf.view(n, rows, D).unbind(0))
    return buf[:rows], lambda: next(xs)


def rmsnorm_widths(gen, dev) -> float:
    """rmsnorm and ``F.rms_norm`` in bf16 at the LM paths' widths (2048
    rows of a prefill) and at the decode shape (4 rows): device ms warm
    (one input, which the L2 holds) and cold (inputs rotated past the L2),
    ms per call back to back, each shape held to the plain version.
    Returns the largest error."""
    F = torch.nn.functional
    bf = torch.bfloat16
    worst = 0.0
    for rows, D in RMS_TIMED:
        x, nxt = rotation(rows, D, bf, gen, dev)
        sc = (1 + 0.1 * torch.randn((D,), generator=gen, device=dev)).to(bf)
        worst = max(worst, lm_check(ops.rmsnorm(x, sc),
                                    ops.rmsnorm_ref(x, sc), bf))
        warm = device_pair(lambda: ops.rmsnorm(x, sc),
                           lambda: F.rms_norm(x, (D,), sc, 1e-6))
        cold = device_pair(lambda: ops.rmsnorm(nxt(), sc),
                           lambda: F.rms_norm(nxt(), (D,), sc, 1e-6))
        ms = cuda_ms(lambda: ops.rmsnorm(x, sc))
        lib_ms = cuda_ms(lambda: F.rms_norm(x, (D,), sc, 1e-6))
        bound_ms, bound_by = rmsnorm_bound(rows, D, bf)
        print(f"rmsnorm timing at ({rows}, {D}) bf16: device warm "
              f"{warm['device_ms']:.5f} ms (F.rms_norm "
              f"{warm['library_device_ms']:.5f}), cold "
              f"{cold['device_ms']:.5f} ms (F.rms_norm "
              f"{cold['library_device_ms']:.5f}), bound {bound_ms:.6f} ms "
              f"({bound_by}), cold at {100 * bound_ms / cold['device_ms']:.1f}"
              f"% of it; per call back to back {ms:.5f} ms (F.rms_norm "
              f"{lib_ms:.5f})")
    return worst


def attention_timing(kernel, library, shape: str, bound: tuple) -> dict:
    """ms per call back to back (``cuda_ms``) and device ms per call
    (``time_callable``: the calls queued behind a spin kernel, so the
    host's launch work is out of the time) of an attention kernel and of
    its SDPA yardstick."""
    t = dict(ms=cuda_ms(kernel), library_ms=cuda_ms(library), shape=shape,
             **device_pair(kernel, library))
    t["bound_ms"], t["bound_by"] = bound
    return t


def report_timing(name: str, t: dict) -> None:
    """One line of a timing; takes ``shape`` and ``library_device_ms`` out
    of ``t`` (the kernels line keeps its own keys)."""
    dev_part = ""
    if "device_ms" in t:
        dev_part = (f"; device {t['device_ms']:.5f} ms, library device "
                    f"{t.pop('library_device_ms'):.5f} ms")
    plain = f"plain {t['plain_ms']:.5f} ms, " if "plain_ms" in t else ""
    print(f"{name} timing at {t.pop('shape')}: kernel {t['ms']:.5f} ms, "
          f"{plain}library {t['library_ms']:.5f} ms, bound "
          f"{t['bound_ms']:.6f} ms ({t['bound_by']}){dev_part}")


def lm_launches() -> tuple:
    """Launches of the five LM kernels, in ``LM_KERNELS`` order."""
    return tuple(getattr(ops, k).launches for k in LM_KERNELS)


def zero_lm_launches() -> None:
    for k in LM_KERNELS:
        getattr(ops, k).launches = 0


def phase_lm_card_vs_cpu(dev) -> None:
    """llama3.2-1b at full width cut to 2 layers, fp32: the same weights
    (drawn once on the CPU) and prompt through ``greedy_decode`` on the
    CPU and on the card; logits within SERVE_TOL, tokens equal, and the
    card's kernel launches exactly 2L+1 / L / L per call."""
    cfg = get_config(LM_ARCH).with_(n_layers=2, param_dtype=torch.float32,
                                    compute_dtype=torch.float32)
    L, P, steps = cfg.n_layers, 64, 8
    params = api.init(torch.Generator().manual_seed(3), cfg)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, P),
                         generator=torch.Generator().manual_seed(4))
    t0 = time.perf_counter()
    cpu = greedy_decode(params, cfg, toks, steps + 1, keep_logits=True)
    cpu_s = time.perf_counter() - t0
    gparams = tree_to(params, dev)
    zero_lm_launches()
    card = greedy_decode(gparams, cfg, toks.to(dev), steps + 1,
                         keep_logits=True)
    launches = lm_launches()
    want = ((2 * L + 1) * (steps + 1), L, L * steps, 0, 0)
    if launches != want:
        raise AssertionError(f"card-vs-cpu: launches {LM_KERNELS} "
                             f"{launches}, expected {want}")
    if not np.array_equal(card.tokens, cpu.tokens):
        raise AssertionError(f"card-vs-cpu: greedy tokens differ:\n"
                             f"{card.tokens}\n{cpu.tokens}")
    worst = max(max_err(a.cpu(), b, **SERVE_TOL)
                for a, b in zip(card.logits, cpu.logits))
    scale = max(float(b.abs().max()) for b in cpu.logits)
    print(f"card-vs-cpu: {LM_ARCH} full width, {L} layers, fp32, prompt {P} x "
          f"batch {LM_BATCH}, {steps} decode steps: tokens equal, logits max "
          f"abs err {worst:.3e} (largest |logit| {scale:.2f}), launches "
          f"{launches[:3]} = (2L+1, L, L) per call; CPU run {cpu_s:.1f} s")


SCAN_LAUNCH = re.compile(r"ssd_bwd_\w+")     # a scan backward launch's name


def lm_profile(label: str, fn, calls: int) -> dict:
    """Wall and device-busy ms per call over ``calls`` calls of ``fn``
    under ``torch.profiler``, the five longest kernels and the LM
    kernels' shares of the busy time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    n_events, per_name, busy = device_breakdown(prof, calls)
    if not n_events:
        print(f"profile: {label}: wall {wall:.3f} ms; device time not "
              f"measured (the profiler saw no kernels)")
        return dict(wall_ms=wall)
    share = {k: sum(t for n, t in per_name.items()
                    if any(p in n for p in pats) and "coded_decode" not in n)
             for k, pats in (("rmsnorm", ("rmsnorm_kernel",)),
                             ("flash_attention", ("flash_kernel",)),
                             ("decode_attention", ("decode_kernel",)),
                             # the CUDA-core kernel, the tensor-core pair
                             ("ssd_scan", ("ssd_kernel", "ssd_chunk_")),
                             ("topk_gating", ("topk_gating_kernel",)),
                             ("rmsnorm_bwd", ("rmsnorm_bwd_kernel",
                                              "rmsnorm_dscale_kernel")),
                             ("flash_attention_bwd", ("stats_kernel",
                                                      "dkdv_kernel",
                                                      "dq_kernel")),
                             ("ssd_scan_bwd", ("ssd_bwd_",)),
                             ("topk_gating_bwd", ("topk_gating_bwd_kernel",
                                                  )))}
    top = "; ".join(f"{k[:70]} {t:.4f} ms" for k, t in
                    sorted(per_name.items(), key=lambda kv: -kv[1])[:5])
    # the scan backward's launches apart (states, fold, tiles, scan, sum)
    scan = "".join(f"; {SCAN_LAUNCH.search(n).group(0)} {t:.4f} ms"
                   for n, t in per_name.items() if SCAN_LAUNCH.search(n))
    print(f"profile: {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall:.1%} of wall) over {n_events // calls} launches; "
          + ", ".join(f"{k} {t:.4f} ms ({t / busy:.1%})"
                      for k, t in share.items() if t) + f"; top: {top}"
          + (f"; ssd_scan_bwd by launch{scan}" if scan else ""))
    return dict(wall_ms=wall, busy_ms=busy, **share)


def phase_lm_serve(dev) -> dict:
    """The slice's main path: full-width llama3.2-1b served through
    ``generate`` on the card, with exact launch counts; then, on the same
    weights and prompt, a warm second run, a decode step
    against a prefill of the same tokens, and a profile of one prefill and
    of 8 decode steps."""
    cfg = get_config(LM_ARCH)
    L, B, P, n = cfg.n_layers, LM_BATCH, LM_PROMPT, LM_GEN
    zero_lm_launches()                          # the main path's window
    res = generate(LM_ARCH, tiny=False, prompt_len=P, gen=n, batch=B, seed=0,
                   device=dev, keep_logits=True)
    launches = lm_launches()
    want = ((2 * L + 1) * n, L, L * (n - 1), 0, 0)
    if launches != want:
        raise AssertionError(f"serve: launches {LM_KERNELS} {launches}, "
                             f"expected {want}")
    if res.tokens.shape != (B, n) or not all(
            bool(torch.isfinite(x).all()) and x.shape == (B, cfg.vocab)
            for x in res.logits):
        raise AssertionError("serve: tokens or logits malformed")
    print(f"serve: {LM_ARCH} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}), {str(cfg.compute_dtype)[6:]}, "
          f"prompt {P} x batch {B}, "
          f"{n} tokens: prefill {res.prefill_ms:.3f} ms, decode "
          f"{res.decode_ms_per_token:.3f} ms/token; launches {launches[:3]} "
          f"(rmsnorm, flash, decode); all logits finite")
    tokens = res.tokens
    del res

    g = torch.Generator(device=dev).manual_seed(0)    # generate's weights
    params = api.init(g, cfg)
    print(f"serve: {api.param_count(params):,} parameters, peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    toks = torch.randint(0, cfg.vocab, (B, P), generator=g, device=dev)
    warm = greedy_decode(params, cfg, toks, n)
    print(f"serve (warm, same weights and prompt): prefill "
          f"{warm.prefill_ms:.3f} ms, decode {warm.decode_ms_per_token:.3f} "
          f"ms/token; tokens equal to the first run's: "
          f"{np.array_equal(warm.tokens, tokens)}")
    step_vs_prefill(params, cfg, toks, "serve")
    prefill, decode = profile_serving(params, cfg, toks, "")
    return dict(launches=dict(zip(LM_KERNELS, launches)), prefill=prefill,
                decode=decode)


def step_vs_prefill(params, cfg, toks: torch.Tensor, label: str) -> None:
    """A decode step after a prefill of ``toks`` (B, P) against a prefill
    of the same P + 1 tokens, relative to each row's largest |logit|;
    raises above LM_STEP_TOL."""
    B, P = toks.shape
    cache = api.init_cache(cfg, B, P + 1, device=toks.device)
    logits, pcache = api.prefill(params, cfg, {"tokens": toks})
    for name, c in cache.items():
        splice(c, pcache[name])
    nxt = logits[:, -1:].argmax(-1)
    step, _ = api.decode_step(params, cfg, {"tokens": nxt}, cache, P)
    full, _ = api.prefill(params, cfg, {"tokens": torch.cat([toks, nxt], 1)})
    a, b = step[:, -1].float(), full[:, -1].float()
    rel = float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())
    if not rel <= LM_STEP_TOL:
        raise AssertionError(f"{label}: decode step vs prefill differ by "
                             f"{rel:.3e} of the row's largest |logit|")
    print(f"{label}: decode step at {P} vs prefill of the same {P + 1} "
          f"tokens: max |diff| {rel:.3e} of the row's largest |logit| (bound "
          f"{LM_STEP_TOL})")


def profile_serving(params, cfg, toks: torch.Tensor, label: str,
                    extra: dict = None) -> tuple:
    """``lm_profile`` of one prefill of ``toks`` (B, P) (with the
    ``embeds`` and ``positions`` in ``extra``) and of 8 decode steps
    after it."""
    B, P = toks.shape
    prompt = {"tokens": toks, **(extra or {})}
    prefill = lm_profile(
        f"{label}prefill of {P} x batch {B}",
        lambda: api.prefill(params, cfg, prompt), 1)
    steps = 8
    enc_len = prompt["embeds"].shape[1] if cfg.family == "encdec" else None
    cache = api.init_cache(cfg, B, P + steps, enc_len=enc_len,
                           device=toks.device)
    logits, pcache = api.prefill(params, cfg, prompt)
    for name, c in cache.items():
        splice(c, pcache[name])
    state = {"t": 0, "cur": logits[:, -1:].argmax(-1)}

    def decode_step():
        lg, _ = api.decode_step(params, cfg, {"tokens": state["cur"]}, cache,
                                P + state["t"])
        state["cur"] = lg[:, -1:].argmax(-1)
        state["t"] += 1
    decode = lm_profile(f"{label}decode step (batch {B}, fill {P}+)",
                        decode_step, steps)
    return prefill, decode


# -- SSM, MoE and hybrid serving: ssd_scan, topk_gating -----------------------------

def ssd_operands(Bsz, H, L, P, N, dtype, strided, gen, dev):
    """Scan operands as the model passes them (x a view of (B, L, H, P), dt
    of (B, L, H), B/C of (B, L, N) expanded over heads with stride 0) or as
    contiguous (B·H)-row copies. B and C are scaled to unit-variance scores
    C·B, as a normalised model's are: with unit-variance B and C the fp32
    sums of N-term products lose more than 3e-5 relative even in the plain
    version (against fp64)."""
    x = torch.randn((Bsz, L, H, P), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((Bsz, L, H), generator=gen, device=dev))
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev))
    Bm, Cm = (torch.randn((Bsz, L, N), generator=gen, device=dev)
              .div(N ** 0.5).to(dtype) for _ in "BC")
    views = (x.permute(0, 2, 1, 3), dt.permute(0, 2, 1), A.expand(Bsz, H),
             Bm[:, None].expand(Bsz, H, L, N), Cm[:, None].expand(Bsz, H, L, N))
    if strided:
        return views
    return tuple(t.reshape(Bsz * H, *t.shape[2:]).contiguous() for t in views)


def ssd_bound(Bsz, H, L, P, N, Q, dtype, out_dtype) -> tuple:
    """x, dt, A, B and C read once (B and C once per batch row: the heads
    share them), y and the final fp32 state written once; the operations of
    the chunked form these inputs need: per chunk the causal (t, s) pairs'
    C·B (once per batch row) and P-wide products, and the inter-chunk and
    state products (2·Q·P·N flops each) per head."""
    e = torch.finfo(dtype).bits // 8
    eo = torch.finfo(out_dtype).bits // 8
    nbytes = (Bsz * L * H * P * e + Bsz * L * H * 4 + H * 4
              + 2 * Bsz * L * N * e + Bsz * L * H * P * eo
              + Bsz * H * P * N * 4)
    pairs = Q * (Q + 1) // 2
    flops = (L // Q) * (Bsz * pairs * 2 * N
                        + Bsz * H * (pairs * 2 * P + 4 * Q * P * N))
    return roofline(nbytes, flops, dtype)


def gating_bound(N, E, k) -> tuple:
    """The logits read once, the weights and indices written once; per
    element a max, an exponential, a sum and a division, and k rounds of
    compares."""
    return roofline(N * E * 4 + N * k * 8, N * E * (4 + k), torch.float32)


def gating_chain(logits: torch.Tensor, k: int) -> tuple:
    """The gating as PyTorch calls: softmax → topk → renormalise."""
    w, i = torch.softmax(logits, -1).topk(k, dim=-1)
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9), i


# SMs the scan's plan is told the card has, so that it picks each head
# group: with none every grid has blocks to spare, with a million none does
GROUP_SMS = {1: 10 ** 6, 4: 0}


@contextlib.contextmanager
def scan_head_group(group: int):
    """``ssd_scan`` planned as if the card had ``GROUP_SMS[group]`` SMs, so
    that its tensor-core kernel runs heads in groups of ``group`` where it
    can take them."""
    real = SS.num_sms
    SS.num_sms = lambda index: GROUP_SMS[group]
    try:
        yield
    finally:
        SS.num_sms = real


def phase_ssm_moe_kernels(dev) -> dict:
    """ssd_scan and topk_gating vs their plain versions over sweeps; each
    timed at its serving shape."""
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = {k: 0.0 for k in SSM_MOE_SOURCES}
    cases = {k: 0 for k in SSM_MOE_SOURCES}
    for dtype in (torch.float32, torch.bfloat16):
        # bf16 at N 8 takes the CUDA-core kernel, as fp32 does everywhere
        for P, N, Q in ((64, 128, 256), (64, 16, 256), (32, 16, 32),
                        (32, 8, 32)):
            errs = []
            # 2, 4 and 16 chunks; L < chunk (one ragged chunk of Q = L)
            for L in (2 * Q, 4 * Q, 16 * Q, Q // 2 + 4):
                for strided in (False, True):
                    args = ssd_operands(2, 3, L, P, N, dtype, strided, gen,
                                        dev)
                    y = ops.ssd_scan(*args, chunk=Q)
                    y32, h = ops.ssd_scan(*args, chunk=Q, return_state=True,
                                          out_dtype=torch.float32)
                    torch.cuda.synchronize()
                    ry32, rh = ops.ssd_scan_ref(*args, chunk=Q,
                                                return_state=True,
                                                out_dtype=torch.float32)
                    # fp32 outputs of the same (rounded) inputs: fp32 bound
                    f32 = SSD_TOL[torch.float32]
                    e = max(max_err(y.float(), ry32.to(dtype).float(),
                                    **SSD_TOL[dtype]),
                            max_err(y32, ry32, **f32), max_err(h, rh, **f32))
                    worst["ssd_scan"] = max(worst["ssd_scan"], e)
                    cases["ssd_scan"] += 2
                    errs.append(f"L{L}/{'strided' if strided else 'contig'}"
                                f":{e:.1e}")
            print(f"ssd_scan {str(dtype)[6:]} (P,N,Q)=({P},{N},{Q}): "
                  + " ".join(errs))
    # the tensor-core kernel's head groups: four heads sharing B and C
    for P, N, Q in ((64, 128, 256), (64, 16, 256), (32, 16, 32)):
        errs = []
        for L in (2 * Q, 4 * Q, Q // 2 + 4):
            args = ssd_operands(2, 4, L, P, N, torch.bfloat16, True, gen, dev)
            ry32, rh = ops.ssd_scan_ref(*args, chunk=Q, return_state=True,
                                        out_dtype=torch.float32)
            for g in GROUP_SMS:
                with scan_head_group(g):
                    y = ops.ssd_scan(*args, chunk=Q)
                    y32, h = ops.ssd_scan(*args, chunk=Q, return_state=True,
                                          out_dtype=torch.float32)
                torch.cuda.synchronize()
                f32 = SSD_TOL[torch.float32]
                e = max(max_err(y.float(), ry32.to(y.dtype).float(),
                                **SSD_TOL[torch.bfloat16]),
                        max_err(y32, ry32, **f32), max_err(h, rh, **f32))
                worst["ssd_scan"] = max(worst["ssd_scan"], e)
                cases["ssd_scan"] += 2
                errs.append(f"L{L}/group{g}:{e:.1e}")
        print(f"ssd_scan bf16 (P,N,Q)=({P},{N},{Q}), 4 heads, strided, by "
              f"head group: " + " ".join(errs))
    for E, ks in ((4, (1, 2)), (16, (1, 2, 6, 8)), (64, (1, 2, 6, 8))):
        errs = []
        for k in ks:
            e = 0.0
            for N in (1, 4, 77, 2048, 4096):
                logits = torch.randn((N, E), generator=gen, device=dev)
                w, i = ops.topk_gating(logits, k)
                torch.cuda.synchronize()
                rw, ri = ops.topk_gating_ref(logits, k)
                if not torch.equal(i, ri):
                    raise AssertionError(f"topk_gating N={N} E={E} k={k}: "
                                         f"indices differ from the plain "
                                         f"version's")
                e = max(e, max_err(w, rw, **GATE_TOL))
                cases["topk_gating"] += 1
            worst["topk_gating"] = max(worst["topk_gating"], e)
            errs.append(f"k{k}:{e:.1e}")
        print(f"topk_gating E={E}, N in (1, 4, 77, 2048, 4096): "
              + " ".join(errs))
    print(f"ssd_scan vs plain: {cases['ssd_scan']} cases within rtol/atol "
          f"2e-3 (fp32) and 3e-2 (bf16), max abs err "
          f"{worst['ssd_scan']:.3e}; topk_gating vs plain: "
          f"{cases['topk_gating']} cases, indices equal, weights within "
          f"1e-5, max abs err {worst['topk_gating']:.3e}")

    bf = torch.bfloat16
    timing = {}
    B, L = LM_BATCH, LM_PROMPT
    for arch in ("mamba2-130m", "jamba-v0.1-52b"):    # the JSON keeps mamba2
        cfg = get_config(arch)
        H, P, N, Q = (cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_chunk)
        args = ssd_operands(B, H, L, P, N, bf, True, gen, dev)
        kw = dict(chunk=Q, return_state=True, out_dtype=torch.float32)
        # the timed shape's output, held to the plain version
        (y, h), (ry, rh) = (ops.ssd_scan(*args, **kw),
                            ops.ssd_scan_ref(*args, **kw))
        f32 = SSD_TOL[torch.float32]
        e = max(max_err(y, ry, **f32), max_err(h, rh, **f32))
        worst["ssd_scan"] = max(worst["ssd_scan"], e)
        t = dict(
            ms=cuda_ms(lambda: ops.ssd_scan(*args, **kw)),
            device_ms=MB.time_callable(lambda: ops.ssd_scan(*args, **kw),
                                       repeats=200, warmup=3) * 1e3,
            plain_ms=cuda_ms(lambda: ops.ssd_scan_ref(*args, **kw), iters=20,
                             warm=3),
            library_ms=None, bound=ssd_bound(B, H, L, P, N, Q, bf,
                                             torch.float32))
        timing.setdefault("ssd_scan", t)
        plan = SS.mma_plan(B, H, L, P, N, Q, True,
                           torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
        groups = {}
        for g in GROUP_SMS:
            with scan_head_group(g):
                groups[g] = MB.time_callable(lambda: ops.ssd_scan(*args, **kw),
                                             repeats=200, warmup=3) * 1e3
        print(f"ssd_scan timing at {arch}'s (B,L,H,P,N,Q)=({B},{L},{H},{P},"
              f"{N},{Q}), bf16 x/B/C strided views, y and state fp32 (vs "
              f"plain {e:.1e}): kernel {t['ms']:.5f} ms, device "
              f"{t['device_ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, bound "
              f"{t['bound'][0]:.6f} ms ({t['bound'][1]}); tensor-core path, 2 "
              f"CUDA launches per call, plan {plan}; device ms by head group "
              + ", ".join(f"{g}: {v:.5f}" for g, v in groups.items()))
    cfg = get_config(MOE_ARCH)
    N, E, k = LM_BATCH * LM_PROMPT, cfg.n_experts, cfg.top_k
    jamba = get_config("jamba-v0.1-52b")
    for shape in ((LM_BATCH, E, k), (LM_BATCH, jamba.n_experts, jamba.top_k),
                  (N, jamba.n_experts, jamba.top_k)):
        x = torch.randn(shape[:2], generator=gen, device=dev)
        t = device_pair(lambda: ops.topk_gating(x, shape[2]),
                        lambda: gating_chain(x, shape[2]))
        print(f"topk_gating device ms at (N,E,k)={shape}: kernel "
              f"{t['device_ms']:.5f}, softmax→topk→renormalise "
              f"{t['library_device_ms']:.5f}, bound "
              f"{gating_bound(*shape)[0]:.6f}")
    logits = torch.randn((N, E), generator=gen, device=dev)

    def library():
        return gating_chain(logits, k)
    timing["topk_gating"] = t = dict(
        ms=cuda_ms(lambda: ops.topk_gating(logits, k)),
        plain_ms=cuda_ms(lambda: ops.topk_gating_ref(logits, k)),
        library_ms=cuda_ms(library), bound=gating_bound(N, E, k),
        **device_pair(lambda: ops.topk_gating(logits, k), library))
    print(f"topk_gating timing at N={N} E={E} k={k} fp32: kernel "
          f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, softmax→topk→"
          f"renormalise {t['library_ms']:.5f} ms, bound {t['bound'][0]:.6f} "
          f"ms ({t['bound'][1]}); device: kernel {t['device_ms']:.5f} ms, "
          f"softmax→topk→renormalise {t.pop('library_device_ms'):.5f} ms")
    for name, t in timing.items():
        t["bound_ms"], t["bound_by"] = t.pop("bound")
        t["max_abs_err"] = worst[name]
    return timing


def expected_launches(cfg, steps: int) -> tuple:
    """Launches of the ``LM_KERNELS`` in one prefill and ``steps`` decode
    steps, from the model's layers: a norm before every mixer and every
    FFN (an SSM block has no FFN), one gated norm per mamba mixer and the
    output norm per call; one
    flash_attention per attention layer per prefill, one decode_attention
    per attention layer per step; one ssd_scan per mamba mixer per prefill
    (a decode step runs the recurrence in PyTorch); one topk_gating per MoE
    layer per call."""
    calls, L = steps + 1, cfg.n_layers
    if cfg.family == "encdec":
        # LayerNorm (no rmsnorm); the encoder's self-attention and the
        # decoder's self and cross attention in a prefill, the decoder's
        # two in a step
        dec = 2 * cfg.n_dec_layers
        return 0, cfg.n_enc_layers + dec, dec * steps, 0, 0
    if cfg.family == "hybrid":
        kinds = hybrid._layer_kinds(cfg)
        attn = hybrid.n_periods(cfg) * sum(a for a, _ in kinds)
        moe = hybrid.n_periods(cfg) * sum(m for _, m in kinds)
        mamba = L - attn
    else:
        attn = L if cfg.family in ("dense", "moe", "vlm") else 0
        mamba = L if cfg.family == "ssm" else 0
        moe = L if cfg.family == "moe" else 0
    norms = (L if cfg.family == "ssm" else 2 * L) + mamba + 1
    return norms * calls, attn, attn * steps, mamba, moe * calls


@contextlib.contextmanager
def recording_routes(weights: list = None):
    """Record the experts each ``topk_gating`` call picks while the block
    runs ((N, k) int32 on the CPU, in call order), and their weights in
    ``weights`` where given. The launch counters are read after the
    block."""
    routes = []
    gate = ops.topk_gating

    def recorded(logits, k):
        w, i = gate(logits, k)
        routes.append(i.cpu())
        if weights is not None:
            weights.append(w.cpu())
        return w, i
    ops.topk_gating = recorded
    try:
        yield routes
    finally:
        ops.topk_gating = gate


@contextlib.contextmanager
def replaying_routes(weights: list, routes: list, dev):
    """``topk_gating`` returns another run's recorded (weights, experts),
    call after call, while the block runs (no launch): that run's routing
    decisions, so that what differs is the arithmetic alone."""
    gate = ops.topk_gating
    calls = iter(zip(weights, routes))

    def replayed(logits, k):
        w, i = next(calls)
        return torch.from_numpy(w).to(dev), torch.from_numpy(i).to(dev)
    ops.topk_gating = replayed
    try:
        yield
    finally:
        ops.topk_gating = gate
    if next(calls, None) is not None:
        raise AssertionError("the replayed run made fewer router calls")


def phase_ssm_moe_card_vs_cpu(dev) -> None:
    """mamba2-130m (24 layers), moonshot at full width cut to 2 layers and
    the tiny jamba, fp32: the same weights (drawn once) and prompt through
    ``greedy_decode`` on the CPU and on the card; exact launches; router
    rows that differ (near ties summed in other orders) under 1%; logits
    within SERVE_TOL and tokens equal in the batch rows no differing route
    touched (a route changes its token's FFN output, and through attention
    and the row's capacity positions the rest of its row)."""
    B, P, steps = 2, 256, 8
    f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
    models = (("mamba2-130m", get_config("mamba2-130m").with_(**f32)),
              (MOE_ARCH, get_config(MOE_ARCH).with_(n_layers=2, **f32)),
              ("jamba-v0.1-52b tiny", tiny_version(get_config(
                  "jamba-v0.1-52b"))))
    for name, cfg in models:
        params = api.init(torch.Generator(device=dev).manual_seed(3), cfg)
        cpu_params = tree_to(params, torch.device("cpu"))
        toks = torch.randint(0, cfg.vocab, (B, P),
                             generator=torch.Generator().manual_seed(4))
        t0 = time.perf_counter()
        with recording_routes() as cpu_routes:
            cpu = greedy_decode(cpu_params, cfg, toks, steps + 1,
                                keep_logits=True)
        cpu_s = time.perf_counter() - t0
        zero_lm_launches()
        with recording_routes() as card_routes:
            card = greedy_decode(params, cfg, toks.to(dev), steps + 1,
                                 keep_logits=True)
        launches, want = lm_launches(), expected_launches(cfg, steps)
        if launches != want:
            raise AssertionError(f"card-vs-cpu {name}: launches {LM_KERNELS} "
                                 f"{launches}, expected {want}")
        if len(card_routes) != len(cpu_routes):
            raise AssertionError(f"card-vs-cpu {name}: router calls differ")
        n_rows = n_diff = 0
        row_hit = np.zeros(B, bool)
        for a, b in zip(card_routes, cpu_routes):
            diff = (a != b).any(-1).numpy()
            n_rows, n_diff = n_rows + diff.size, n_diff + int(diff.sum())
            row_hit |= diff.reshape(B, -1).any(-1)
        if n_diff > MAX_ROUTE_DIFF * max(n_rows, 1):
            raise AssertionError(f"card-vs-cpu {name}: {n_diff} of {n_rows} "
                                 f"router rows pick other experts")
        keep = ~row_hit
        if not np.array_equal(card.tokens[keep], cpu.tokens[keep]):
            raise AssertionError(f"card-vs-cpu {name}: greedy tokens differ:"
                                 f"\n{card.tokens}\n{cpu.tokens}")
        worst = max((max_err(a.cpu()[keep], b[keep], **SERVE_TOL)
                     for a, b in zip(card.logits, cpu.logits)), default=0.0)
        scale = max(float(b.abs().max()) for b in cpu.logits)
        print(f"card-vs-cpu: {name} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}), fp32, prompt {P} x batch {B}, {steps} decode "
              f"steps: router rows differing {n_diff} of {n_rows}, batch rows "
              f"held {int(keep.sum())} of {B}: tokens equal, logits max abs "
              f"err {worst:.3e} (largest |logit| {scale:.2f}); launches "
              f"{dict(zip(LM_KERNELS, launches))}; CPU run {cpu_s:.1f} s")
        del params, cpu_params
        torch.cuda.empty_cache()


def phase_ssm_moe_serve(dev) -> dict:
    """The slice's main paths at full width, bf16: mamba2-130m uncut
    through ``generate(tiny=False)``, moonshot-v1-16b-a3b cut to 16 of its
    48 layers and one period of jamba-v0.1-52b through ``greedy_decode``
    (SSM_MOE_SERVE); exact launches, finite
    logits; then on the same weights and prompt a decode step against a
    prefill of the same tokens, and a profile of one prefill and of 8
    decode steps. Each model is freed before the next is drawn."""
    B, P, n = LM_BATCH, LM_PROMPT, LM_GEN
    totals = dict.fromkeys(LM_KERNELS, 0)
    out = {}
    for arch, depth in SSM_MOE_SERVE:
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats(dev)
        if depth is None:
            zero_lm_launches()                  # the main path's window
            res = generate(arch, tiny=False, prompt_len=P, gen=n, batch=B,
                           seed=0, device=dev, keep_logits=True)
            launches = lm_launches()
            g = torch.Generator(device=dev).manual_seed(0)  # generate's draw
            params = api.init(g, cfg)
            toks = torch.randint(0, cfg.vocab, (B, P), generator=g,
                                 device=dev)
        else:
            cfg = cfg.with_(n_layers=depth)
            g = torch.Generator(device=dev).manual_seed(0)
            params = api.init(g, cfg)
            toks = torch.randint(0, cfg.vocab, (B, P), generator=g,
                                 device=dev)
            zero_lm_launches()                  # the main path's window
            res = greedy_decode(params, cfg, toks, n, keep_logits=True)
            launches = lm_launches()
        want = expected_launches(cfg, n - 1)
        if launches != want:
            raise AssertionError(f"serve {arch}: launches {LM_KERNELS} "
                                 f"{launches}, expected {want}")
        if res.tokens.shape != (B, n) or not all(
                bool(torch.isfinite(x).all()) and x.shape == (B, cfg.vocab)
                for x in res.logits):
            raise AssertionError(f"serve {arch}: tokens or logits malformed")
        per_call = expected_launches(cfg, 0)
        print(f"serve: {arch} full width ({cfg.n_layers} layers"
              f"{'' if depth is None else ', depth cut'}, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab}), "
              f"{str(cfg.compute_dtype)[6:]}, {api.param_count(params):,} "
              f"parameters, prompt {P} x batch {B}, {n} tokens: prefill "
              f"{res.prefill_ms:.3f} ms, decode {res.decode_ms_per_token:.3f} "
              f"ms/token; launches {dict(zip(LM_KERNELS, launches))} (per "
              f"prefill {dict(zip(LM_KERNELS, per_call))}); all logits "
              f"finite; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        del res
        # a one-token step never drops a slot: give the MoE room for all
        ccfg = (cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
                if cfg.n_experts else cfg)
        # where the scan runs, P - 1 and P tokens keep L % min(chunk, L) == 0
        pre = toks[:, :P // 2 - 1] if cfg.family in ("ssm", "hybrid") \
            else toks
        step_vs_prefill(params, ccfg, pre, f"serve {arch}")
        prefill, decode = profile_serving(params, cfg, toks, f"{arch} ")
        for k, v in zip(LM_KERNELS, launches):
            totals[k] += v
        out[arch] = dict(prefill=prefill, decode=decode)
        del params
        torch.cuda.empty_cache()
    return dict(launches=totals, **out)


# -- the measured cost model and the autotuner: dequant_matmul, coded_matmul --

MEASURED_SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu"
                    for k in ("dequant_matmul", "coded_matmul")}
MEASURED_TPU = {"dequant_matmul": "src/repro/kernels/dequant_matmul.py:23",
                "coded_matmul": "src/repro/kernels/coded_matmul.py:29"}
# dequant_matmul's sweep: the JAX tests' shapes (tests/test_fastpath.py),
# then its ragged and degenerate tiles (B, D, N, block_batch, block_n)
DQ_SHAPES = ((1, 8, 5), (7, 16, 11), (130, 8, 300), (0, 4, 3))
DQ_TILED = ((7, 16, 13, 4, 8), (33, 8, 257, 32, 64), (1, 8, 1, 128, 256),
            (250, 32, 100, 128, 256), (5, 8, 6, 0, 0), (5, 8, 6, -5, 4),
            (5, 8, 6, 4096, 4096))
# (B, D, N) whose rows start on 16 bytes: the CUDA-core route's 16-byte
# staging at D 40, then the tensor route (D > 64) at ragged B and N with D
# 72 (a zero-padded k-tile), 96, 2048 and 2052, where the fp64 product
# holds both kernel and plain version
DQ_ALIGNED = ((100, 40, 144), (100, 72, 144), (65, 96, 272),
              (300, 2048, 272), (130, 2052, 1040))
# (B, D, N): bench_roofline's two shapes (benchmarks/bench_roofline.py) and
# llama3.2-1b's gate projection over 2048 rows, where the kernel sets the time
DQ_TIMED = ((1024, 64, 256), (64, 64, 512), (2048, 2048, 8192))
# coded_matmul (B, D, F, n, k): the JAX tests' cases, then the timed ones:
# the compute-fused plan's (5, 3) slot over the serving batch (64 features
# of WRN-16-1's last stage → its 128-filter portion) and (8, 5) over a
# (1024, 1000) layer
CM_SHAPES = ((9, 6, 13, 5, 3), (4, 6, 12, 3, 2), (37, 16, 40, 8, 5),
             (0, 6, 13, 5, 3))
CM_TIMED = ((256, 64, 128, 5, 3), (256, 1024, 1000, 8, 5))
ROUND_TRIP_TOL = 1e-6           # × the decode gain (test_torch_coded_serving)
# bench_roofline's six cells (benchmarks/bench_roofline.py:36-78)
ROOFLINE_QA = ((4, 1024, 16, 10), (4, 64, 16, 10))       # K, B, Dk, C
ROOFLINE_CD = ((1024, 6, 4, 16), (64, 6, 4, 16))         # B, R, K, F
ROOFLINE_DQ = ((1024, 64, 256), (64, 64, 512))           # B, D, N


def dq_operands(B, D, N, per_channel, gen, dev):
    """x ~ N(0, 1) and an int8 weight quantized from N(0, 1) by the port's
    quantize_weight (per tensor or per output channel), as the JAX tests
    draw them."""
    x = torch.randn((B, D), generator=gen, device=dev)
    wq = quantize_weight(torch.randn((D, N), generator=gen, device=dev),
                         axis=1 if per_channel else None)
    return x, wq.q.contiguous(), wq.scale.reshape(-1 if per_channel else ())


def dq_bound(B, D, N, per_channel) -> tuple:
    """(bound_ms, bound_by, fp32_ms) of the route the shape takes: x, q and
    the scales read once, y written once, against its operations: on the
    tensor route three bf16 products (3 · 2·B·D·N at the bf16 rate), on the
    CUDA-core route 2·B·D·N fp32 FMAs. ``fp32_ms`` is the CUDA-core bound,
    printed beside the tensor route's."""
    nbytes = 4 * B * D + D * N + 4 * (N if per_channel else 1) + 4 * B * N
    fp32 = roofline(nbytes, 2 * B * D * N, torch.float32)
    if ops_dq.route(B, D, N) == "tensor":
        return (*roofline(nbytes, 3 * 2 * B * D * N, torch.bfloat16), fp32[0])
    return (*fp32, fp32[0])


def dq_fp64_errors(x, q, sc, out) -> tuple:
    """(kernel, plain, bound): the kernel's and the plain version's largest
    distance from the fp64 product, and the walk bound they must stay in;
    raises past it."""
    exact = x.double() @ (q.double() * sc.double())
    tol = dq_walk_bound(x.shape[1], exact)
    errs = tuple(float((y.double() - exact).abs().max())
                 for y in (out, ops.dequant_matmul_ref(x, q, sc)))
    for who, err in zip(("kernel", "plain"), errs):
        if err > tol:
            raise AssertionError(f"dequant_matmul {tuple(x.shape)} x "
                                 f"{tuple(q.shape)}: {who} {err:.3e} from "
                                 f"the fp64 product, beyond the fp32 bound "
                                 f"{tol:.3e}")
    return (*errs, tol)


def dq_walk_bound(D: int, exact: torch.Tensor) -> float:
    """The largest distance from the fp64 product that fp32 accumulation
    over D terms may show under a random-walk model, 8 · 2^-24 · √D ·
    max|y| (tests/test_torch_hopper.py); a wrong sum is off by O(|y|)."""
    return 8 * 2.0 ** -24 * D ** 0.5 * float(exact.abs().max())


def cm_bound(B, D, w, n) -> tuple:
    """x and the n shards read once, the (n, B, w) products written once."""
    return roofline(4 * (B * D + n * D * w + n * B * w), 2 * n * B * D * w,
                    torch.float32)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def phase_matmul_kernels(dev, plans: dict) -> dict:
    """dequant_matmul and coded_matmul vs their plain versions (rtol/atol
    1e-5) over the JAX tests' shapes, ragged and degenerate tiles, B = 0,
    both scale kinds; each distinct launch of dequant_matmul's candidate
    tiles, and every candidate of quorum_aggregate and coded_decode at phases 3 and 7's sweeps, bit for bit
    against the default; then each new kernel timed at its shapes."""
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = {"dequant_matmul": 0.0, "coded_matmul": 0.0}
    n_cases, n_tiles = 0, 0
    routes = {"tensor": 0, "cuda_cores": 0}
    fp64 = {"kernel": 0.0, "plain": 0.0, "share": 0.0}
    for per_channel in (False, True):
        cases = [(B, D, N, None, None)
                 for B, D, N in DQ_SHAPES + DQ_ALIGNED] + list(DQ_TILED)
        errs = []
        for B, D, N, bb, bn in cases:
            x, q, sc = dq_operands(B, D, N, per_channel, gen, dev)
            out = ops.dequant_matmul(x, q, sc, block_batch=bb, block_n=bn)
            ref = ops.dequant_matmul_ref(x, q, sc)
            torch.cuda.synchronize()
            r = ops_dq.route(B, D, N)
            if r == "cuda_cores":
                e = max_err(out, ref, **KERNEL_TOL)
                tag = f"{e:.1e}"
            else:                      # the walk bound of the fp64 product
                e = float((out - ref).abs().max())
                ek, ep, tol = dq_fp64_errors(x, q, sc, out)
                fp64["kernel"] = max(fp64["kernel"], ek)
                fp64["plain"] = max(fp64["plain"], ep)
                fp64["share"] = max(fp64["share"], ek / tol, ep / tol)
                tag = f"fp64 {ek:.2e}/{ep:.2e} of {tol:.2e}"
            worst["dequant_matmul"] = max(worst["dequant_matmul"], e)
            n_cases += 1
            routes[r] += 1
            tiles = ops_dq.candidates(B, D, N, num_sms(0))
            base = ops.dequant_matmul(x, q, sc, **tiles[0])
            for c in tiles[1:]:
                if not same_bits(ops.dequant_matmul(x, q, sc, **c), base):
                    raise AssertionError(f"dequant_matmul ({B},{D},{N}) "
                                         f"{r} route tile {c}: bits differ "
                                         f"from the default")
                n_tiles += 1
            if not same_bits(out, base):
                raise AssertionError(f"dequant_matmul ({B},{D},{N}) tile "
                                     f"{bb} x {bn}: bits differ from the "
                                     f"default")
            errs.append(f"({B},{D},{N})" + (f"/{bb}x{bn}" if bb is not None
                                             else "") + f" {r}:{tag}")
        kind = "per-channel" if per_channel else "per-tensor"
        print(f"dequant_matmul {kind}: " + " ".join(errs))
    print(f"dequant_matmul on the tensor route: worst distance from the "
          f"fp64 product "
          f"{fp64['kernel']:.3e} (kernel), {fp64['plain']:.3e} (plain), at "
          f"most {fp64['share']:.3f} of the walk bound; {routes['tensor']} "
          f"cases on the tensor route, {routes['cuda_cores']} on the CUDA "
          f"cores")
    errs = []
    for B, D, F, n, k in CM_SHAPES + CM_TIMED:
        W = torch.randn((D, F), generator=gen, device=dev) / D ** 0.5
        sh = torch.from_numpy(shard_linear_weights(W.cpu().numpy(), n, k)
                              ).to(dev)
        x = torch.randn((B, D), generator=gen, device=dev)
        out = ops.coded_matmul(x, sh)
        torch.cuda.synchronize()
        e = max_err(out, ops.coded_matmul_ref(x, sh), **KERNEL_TOL)
        worst["coded_matmul"] = max(worst["coded_matmul"], e)
        n_cases += 1
        w = sh.shape[2]
        errs.append(f"B{B}/D{D}/({n},{k})w{w}/plan "
                    f"{ops_cm.PLANS[ops_cm.plan(n, B, w, num_sms(0))]}:"
                    f"{e:.1e}")
    print("coded_matmul: " + " ".join(errs))
    print(f"matmul kernels vs plain: {n_cases} cases within rtol/atol 1e-5 "
          f"(on the tensor route, the walk bound of the fp64 product); "
          f"{n_tiles} dequant_matmul tile launches bit-equal to the default "
          f"(each distinct launch of {len(AT._configs('dequant_matmul'))} "
          f"candidates)")

    # every candidate block_batch of the two serving kernels, bit for bit
    qa_tiles = cd_tiles = 0
    rng = np.random.default_rng(4)
    for int8 in (False, True):
        for K in (6, 8):
            for Dk in (32, 43, 640):
                for C in (10, 100):
                    for B in (0, 1, 7, 256, 1000):
                        mask = (np.arange(K) % 3 != 1).astype(np.int32)
                        p, w, b, m, s = qa_operands(K, B, Dk, C, mask, int8,
                                                    gen, dev)
                        base = ops.quorum_aggregate(p, w, b, m, s)
                        for c in AT._configs("quorum_aggregate"):
                            if not same_bits(ops.quorum_aggregate(
                                    p, w, b, m, s, **c), base):
                                raise AssertionError(
                                    f"quorum_aggregate K={K} B={B} Dk={Dk} "
                                    f"C={C} tile {c}: bits differ")
                            qa_tiles += 1
        for R, K, F in CD_SWEEP:
            for B in (0, 1, 7, 256, 1000):
                for mname in ("ones", "mixed", "zeros"):
                    sh, dec, m, s = cd_operands(B, R, K, F, mname, "pinv",
                                                int8, gen, dev, rng, plans)
                    base = ops.coded_decode(sh, dec, m, s)
                    for c in AT._configs("coded_decode"):
                        if not same_bits(ops.coded_decode(sh, dec, m, s, **c),
                                         base):
                            raise AssertionError(
                                f"coded_decode B={B} R={R} K={K} F={F} "
                                f"tile {c}: bits differ")
                        cd_tiles += 1
    print(f"tiles: {qa_tiles} quorum_aggregate launches over "
          f"{len(AT._configs('quorum_aggregate'))} block_batch candidates and "
          f"{cd_tiles} coded_decode launches over "
          f"{len(AT._configs('coded_decode'))}, each bit-equal to its default")

    timing = {}
    for B, D, N in DQ_TIMED:
        x, q, sc = dq_operands(B, D, N, True, gen, dev)
        it = dict(iters=20, warm=3) if B * D * N > 1e9 else {}
        t = dict(ms=cuda_ms(lambda: ops.dequant_matmul(x, q, sc), **it),
                 plain_ms=cuda_ms(lambda: ops.dequant_matmul_ref(x, q, sc),
                                  **it),
                 library_ms=cuda_ms(lambda: x @ (q.float() * sc), **it))
        dev_t = device_pair(lambda: ops.dequant_matmul(x, q, sc),
                            lambda: x @ (q.float() * sc))
        t["bound_ms"], t["bound_by"], fp32_ms = dq_bound(B, D, N, True)
        out = ops.dequant_matmul(x, q, sc)
        ref = ops.dequant_matmul_ref(x, q, sc)
        torch.cuda.synchronize()
        r = ops_dq.route(B, D, N)
        if r == "cuda_cores":
            e = max_err(out, ref, **KERNEL_TOL)
            held = "within rtol/atol 1e-5"
        else:
            e = float((out - ref).abs().max())
            ek, ep, tol = dq_fp64_errors(x, q, sc, out)
            held = (f"kernel {ek:.3e} and plain {ep:.3e} from the fp64 "
                    f"product, within {tol:.3e}")
        worst["dequant_matmul"] = max(worst["dequant_matmul"], e)
        tile = ops_dq.default_tile(B, D, N, num_sms(0))
        print(f"dequant_matmul timing at (B,D,N)=({B},{D},{N}) per-channel, "
              f"{r} route, default tile {tile}: kernel {t['ms']:.5f} ms, "
              f"plain {t['plain_ms']:.5f} ms, x @ (q.float() * scale) "
              f"{t['library_ms']:.5f} ms, bound of the {r} route "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}; fp32 CUDA-core "
              f"bound {fp32_ms:.6f} ms); device: kernel "
              f"{dev_t['device_ms']:.5f} ms, x @ (q.float() * scale) "
              f"{dev_t['library_device_ms']:.5f} ms; max abs diff vs plain "
              f"{e:.3e} of max |y| {float(ref.abs().max()):.3e}, {held}")
        # the kernels line takes the first shape, the tuner's main path's
        timing.setdefault("dequant_matmul", t)
    for B, D, F, n, k in CM_TIMED:
        W = torch.randn((D, F), generator=gen, device=dev) / D ** 0.5
        sh = torch.from_numpy(shard_linear_weights(W.cpu().numpy(), n, k)
                              ).to(dev)
        x = torch.randn((B, D), generator=gen, device=dev)
        xb = x.expand(n, B, D)
        t = dict(ms=cuda_ms(lambda: ops.coded_matmul(x, sh)),
                 plain_ms=cuda_ms(lambda: ops.coded_matmul_ref(x, sh)),
                 library_ms=cuda_ms(lambda: torch.bmm(xb, sh)))
        dev_t = device_pair(lambda: ops.coded_matmul(x, sh),
                            lambda: torch.bmm(xb, sh))
        t["bound_ms"], t["bound_by"] = cm_bound(B, D, sh.shape[2], n)
        tiles = ops_cm.PLANS[ops_cm.plan(n, B, sh.shape[2], num_sms(0))]
        print(f"coded_matmul timing at B={B} D={D} ({n},{k}) w={sh.shape[2]}"
              f" ({tiles[0]} x {tiles[1]} outputs a thread):"
              f" kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, bmm "
              f"{t['library_ms']:.5f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}); device: kernel {dev_t['device_ms']:.5f} "
              f"ms, bmm {dev_t['library_device_ms']:.5f} ms")
        # the kernels line takes the first shape, the round trip's
        timing.setdefault("coded_matmul", t)
    for name, t in timing.items():
        t["max_abs_err"] = worst[name]
    return timing


def tuning_cells(gen, dev) -> list:
    """(kernel, args, flops, bytes, tag) cells the tuners search: the
    serving shapes of phases 4 and 7, then bench_roofline's six, drawn on
    the card as bench_roofline draws them."""
    qa = [(*MAIN_SHAPE.values(), "serve")] + \
        [(*c, f"B{c[1]}") for c in ROOFLINE_QA]
    cd = [(*DECODE_SHAPE.values(), "serve")] + \
        [(*c, f"B{c[0]}") for c in ROOFLINE_CD]
    cells = []
    for K, B, Dk, C, tag in qa:
        p, w, b, m, _ = qa_operands(K, B, Dk, C, np.ones(K, np.int32), False,
                                    gen, dev)
        cells.append(("quorum_aggregate", (p, w, b, m), 2.0 * K * B * Dk * C,
                      4.0 * (K * B * Dk + K * Dk * C + C + B * C), tag))
    for B, R, K, F, tag in cd:
        sh = torch.randn((B, R, F), generator=gen, device=dev)
        dec = torch.randn((B, K, R), generator=gen, device=dev)
        m = torch.ones((B, R), dtype=torch.int32, device=dev)
        cells.append(("coded_decode", (sh, dec, m), 2.0 * B * K * R * F,
                      4.0 * (B * R * F + B * K * R + B * R + B * K * F), tag))
    for B, D, N in ROOFLINE_DQ:
        x = torch.randn((B, D), generator=gen, device=dev)
        q = torch.randint(-127, 128, (D, N), generator=gen, device=dev,
                          dtype=torch.int8)
        sc = 0.01 + 0.09 * torch.rand((N,), generator=gen, device=dev)
        cells.append(("dequant_matmul", (x, q, sc), 2.0 * B * D * N,
                      4.0 * B * D + D * N + 4.0 * N + 4.0 * B * N,
                      f"B{B}xN{N}"))
    return cells


def phase_measured(dev) -> dict:
    """The measured path on the card: fit the card's spec from timed
    portion forwards, plan the paper's fleet on it, tune the three kernels
    into a fresh table at the serving shapes and bench_roofline's, serve the
    measured plan through the engine (admission on) with that table
    installed against a CPU twin, run the compute-coding round trip for
    every erasure pattern, and write the table to a temporary directory."""
    for k in ("quorum_aggregate", "coded_decode", *MEASURED_SOURCES):
        getattr(ops, k).launches = 0        # the measured path's window

    # 1-3: the fitted spec and the plan on it
    samples = MB.portion_forward_samples(device=dev)
    spec = MB.fit_host_spec(samples, name=torch.cuda.get_device_name(0))
    print(f"microbench: {len(samples)} portion forwards, wall "
          f"{min(s.wall_s for s in samples) * 1e6:.1f}-"
          f"{max(s.wall_s for s in samples) * 1e6:.1f} us; fitted "
          f"peak_flops {spec.peak_flops:.4e} FLOP/s, peak_bw "
          f"{spec.peak_bw:.4e} B/s, latency_floor "
          f"{spec.latency_floor * 1e6:.3f} us")
    # the paper's 8-device fleet as the legacy phase draws it: the plain
    # draw (seed 1) leaves a slot without a student (objective inf), which
    # admission would shed whole
    fleet = make_fleet(8, seed=1, mem_range=(1e6, 4e6))
    A, students = affinity_graph(256), paper_students()
    declared = PL.tune_d_th_ir(fleet, A, students, p_th=0.25)
    specs = MB.fleet_specs_from_microbench(fleet, samples)
    # the planner's d_th sweep, each candidate through
    # make_plan_ir(..., device_specs=specs), on measured latency
    measured = PL.tune_d_th_ir(fleet, A, students, p_th=0.25,
                               device_specs=specs)
    if measured.latency_source != "measured" or \
            declared.latency_source != "declared":
        raise AssertionError(f"latency sources {declared.latency_source} / "
                             f"{measured.latency_source}")
    print(f"plan on measured latency: K={measured.K}, d_th "
          f"{measured.d_th}, objective {measured.objective():.6e} s, widths "
          f"{measured.partition.sum(1).tolist()}; declared plan K="
          f"{declared.K}, d_th {declared.d_th}, objective "
          f"{declared.objective():.6e} s")

    # 4: the three tuners into a fresh table
    gen = torch.Generator(device=dev).manual_seed(5)
    table = AT.TuningTable()
    AT.set_table(table)
    cells = tuning_cells(gen, dev)
    tuners = {"quorum_aggregate": AT.tune_quorum_aggregate,
              "coded_decode": AT.tune_coded_decode,
              "dequant_matmul": AT.tune_dequant_matmul}
    keys = {"quorum_aggregate": AT.key_quorum_aggregate,
            "coded_decode": AT.key_coded_decode,
            "dequant_matmul": AT.key_dequant_matmul}
    rows, worst = [], dict.fromkeys(tuners, 0.0)
    for kernel, args, flops, nbytes, tag in cells:
        fn = getattr(ops, kernel)
        shape, dtype = keys[kernel](args[0], args[1])
        default = (ops_dq.default_tile(*shape, num_sms(0))
                   if kernel == "dequant_matmul" else
                   AT.defaults(kernel, shape))
        t_default = MB.time_callable(lambda: fn(*args, **default),
                                     repeats=20)
        timings = tuners[kernel](table, *args, repeats=20)
        blocks = table.get(kernel, shape, dtype)
        dkey = ",".join(f"{k}={v}" for k, v in sorted(default.items()))
        rival = min((k for k in timings if k != dkey), key=timings.get,
                    default=dkey)
        t_tuned = t_default if blocks == default else \
            MB.time_callable(lambda: fn(*args), repeats=20)
        # the tuned call against its plain version: a check, not the path
        before = fn.launches
        out = fn(*args)
        fn.launches = before
        ref = getattr(ops, f"{kernel}_ref")(*args)
        torch.cuda.synchronize()
        e = max_err(out, ref, **KERNEL_TOL)
        worst[kernel] = max(worst[kernel], e)
        bound = float(spec.latency(flops, nbytes))
        rows.append((kernel, tag, t_default, t_tuned))
        tile = "/".join(f"{k}={v}" for k, v in sorted(blocks.items()))
        print(f"tune {kernel} {tag}: default {t_default * 1e3:.5f} ms, tuned "
              f"{t_tuned * 1e3:.5f} ms ({tile}), fastest other tile "
              f"{rival} at {timings[rival] * 1e3:.5f} ms in the search, "
              f"speedup {t_default / t_tuned:.3f}, fitted-spec bound "
              f"{bound * 1e3:.5f} ms, efficiency {bound / t_tuned:.4f}; "
              f"tuned tile vs plain {e:.3e} (rtol/atol 1e-5)")
    slower = [(k, t) for k, t, td, tt in rows if tt > td * 1.15]
    best = max(td / tt for _, _, td, tt in rows)
    print(f"tuning: {len(table)} entries; bench_roofline's gates (reported, "
          f"not enforced: set for the TPU's tile grid): no regression "
          f"beyond 1.15x {'ok' if not slower else slower}, best speedup "
          f"{best:.3f} "
          f"({'> 1.05' if best > 1.05 else 'not > 1.05'})")

    # 5: the measured plan served with the table installed, admission on
    ens = ensemble_for(measured, seed=6)
    served = phase_serve("measured", ens, dev, seed=6, admission=True,
                         fused=ens.fused_export() is not None)

    # 6: the compute-coding round trip, every erasure pattern of (5, 3);
    # x and W on a dyadic grid, so every product and sum of x @ W is exact
    # in fp32 whatever its order and the bound measures the decode alone
    n, k = 5, 3
    B, D, F = CM_TIMED[0][:3]
    x = (torch.randint(-16, 17, (B, D), generator=gen, device=dev) / 16.0)
    W = (torch.randint(-32, 33, (D, F), generator=gen, device=dev) / 256.0)
    shards = torch.from_numpy(shard_linear_weights(W.cpu().numpy(), n, k)
                              ).to(dev)
    parts = ops.coded_matmul(x, shards)                     # (n, B, w)
    shares = parts.transpose(0, 1).contiguous()             # (B, n, w)
    want = (x.double() @ W.double()).float()
    G = make_generator(n, k)
    worst_rt, gains = 0.0, []
    for dead in itertools.combinations(range(n), n - k):
        arrived = np.ones(n, bool)
        arrived[list(dead)] = False
        d = decode_matrix(G, arrived).astype(np.float32)    # (k, n)
        gain = float(np.abs(d).sum(-1).max())
        dec = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(d, (B, k, n)))).to(dev)
        mask = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            arrived.astype(np.int32), (B, n)))).to(dev)
        rec = ops.coded_decode(shares, dec, mask)
        y = rec.reshape(B, -1)[:, :F]
        tol = ROUND_TRIP_TOL * gain
        worst_rt = max(worst_rt, max_err(y, want, rtol=tol, atol=tol) / gain)
        gains.append(gain)
    torch.cuda.synchronize()
    print(f"compute-coding round trip ({n},{k}), x ({B}, {D}) @ W ({D}, {F}):"
          f" {len(gains)} erasure patterns within {ROUND_TRIP_TOL} x decode "
          f"gain (gains {min(gains):.2f}-{max(gains):.2f}), largest "
          f"error / gain {worst_rt:.3e}")

    # 7: the table goes to a temporary directory, never into the repo
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tuning_table.json"
        table.save(path)
        if AT.TuningTable.load(path).entries != table.entries:
            raise AssertionError("the tuning table did not round-trip")
        print(f"tuning table: {len(table)} entries written to a temporary "
              f"directory and read back")
    AT.set_table(AT.TuningTable())
    launches = {k: getattr(ops, k).launches for k in (
        "quorum_aggregate", "coded_decode", *MEASURED_SOURCES)}
    print(f"measured path launches: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the measured path never "
                             f"launched: {launches}")
    return dict(launches=launches, serve=served, max_abs_err=worst)


# -- 18: the offline phase -------------------------------------------------------

# build_rocoin at the JAX package's defaults: the paper's WRN-16-4 teacher,
# the CIFAR-10 zoo, the rocoin planner on make_fleet(8, seed=1), failout
OFFLINE = dict(n_classes=10, teacher_depth=16, teacher_widen=4,
               teacher_steps=150, student_steps=150, batch=128)
# the JAX package's own run of the same call from jax.random.key(0), on the
# CPU: PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_offline_reference.py
# (teacher over 5 × 256 held-out images, ensemble all alive over 4 × 256)
JAX_TEACHER_ACC = 0.996875
JAX_ENSEMBLE_ACC = 0.998046875
ACC_BAND = 0.05                 # ~3.5σ of a 1280-image accuracy at p = 0.5
CARD_CPU_STEPS = 5
# the first teacher steps' losses, card vs CPU: 2.6e-6 apart at most on
# the first run (H100 80GB HBM3, 700 W), held at 1e-4
CARD_CPU_RTOL = 1e-4
PREDICT_TOL = dict(rtol=1e-5, atol=1e-5)   # served logits vs Ensemble.predict
N_OFFLINE_REQUESTS = 64


def same_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def flat_images(ens: Ensemble) -> Ensemble:
    """The ensemble behind a fleet lane, whose requests are flat (rows,
    3072) vectors: each student forward reads them as 32×32×3 images."""
    def reshaped(fwd):
        return lambda p, cfg, x, **kw: fwd(
            p, cfg, x.reshape(x.shape[0], 32, 32, 3), **kw)
    return dataclasses.replace(ens, students=[
        (cfg, p, reshaped(fwd)) for cfg, p, fwd in ens.students])


def report_rows(report) -> list:
    return ([dataclasses.astuple(r) for r in report.records],
            [dataclasses.astuple(b) for b in report.batches])


def phase_offline(dev) -> dict:
    """RoCoIn's offline phase on the card, then its ensemble served: stage
    times, accuracy against the JAX package, card vs CPU, a bit-equal
    failout rerun, the robustness curve into ``thin_replicas``, and the
    trained ensemble behind the server, a traced engine and a fleet."""
    data = SyntheticImages(ImageTaskConfig(n_classes=10))
    t0 = time.perf_counter()
    for s in range(20):
        data.batch(OFFLINE["batch"], 900_000 + s)
    batch_ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"offline: SyntheticImages.batch({OFFLINE['batch']}) "
          f"{batch_ms:.3f} ms on the host")

    # the call build_rocoin(gen, **OFFLINE, failout=FailoutConfig()), in its
    # three parts: the teacher from the first of gen's three splits, the
    # plan and students, then failout (tests/test_torch_offline.py holds
    # the parts to the whole)
    times: dict = {}
    t_all = time.perf_counter()
    teacher = PP.prepare_teacher(
        PP.split_generator(torch.Generator().manual_seed(0), 3)[0],
        n_classes=OFFLINE["n_classes"],
        teacher_depth=OFFLINE["teacher_depth"],
        teacher_widen=OFFLINE["teacher_widen"],
        teacher_steps=OFFLINE["teacher_steps"], batch=OFFLINE["batch"],
        data=data, device=dev, timings=times)
    base = PP.build_rocoin(torch.Generator().manual_seed(0), **OFFLINE,
                           planner="rocoin", teacher=teacher, device=dev,
                           timings=times)
    fo = FailoutConfig()
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        t0 = time.perf_counter()
        ens = PP.failout_finetune(base, teacher, fo, batch=OFFLINE["batch"],
                                  device=dev)
        torch.cuda.synchronize()
        times["failout"] = time.perf_counter() - t0
        wall = time.perf_counter() - t_all
        again = PP.failout_finetune(base, teacher, fo,
                                    batch=OFFLINE["batch"], device=dev)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    if not (same_trees(ens.fc, again.fc) and all(
            same_trees(a, b) for (_, a, _), (_, b, _) in
            zip(ens.students, again.students))):
        raise AssertionError("offline: two failout_finetune runs from one "
                             "ensemble differ under deterministic cuDNN")

    K = len(ens.students)
    fc_steps = max(OFFLINE["student_steps"] // 2, 10)
    steps = {"teacher": OFFLINE["teacher_steps"], "fc": fc_steps,
             "failout": fo.steps,
             **{f"student{k}": OFFLINE["student_steps"] for k in range(K)}}
    print(f"offline: whole phase {wall:.3f} s (wall, card synchronised at "
          f"each stage's end)")
    for name, secs in times.items():
        rate = (f", {steps[name] / secs:.1f} steps/s ({steps[name]} steps)"
                if name in steps else "")
        print(f"offline stage {name}: {secs:.3f} s{rate}")
    print(f"offline: host batches ≈ {batch_ms * sum(steps.values()) / 1e3:.3f}"
          f" s of the training stages' {sum(times[k] for k in steps):.3f} s")
    print(f"offline plan: K={K}, widths {ens.part_dims}, students "
          f"{[c.name for c, _, _ in ens.students]}, replicas per slot "
          f"{ens.ir.member.sum(1).tolist()}, student_of "
          f"{ens.ir.student_of.tolist()}, d_th {ens.ir.d_th:.4g}")
    print(f"offline: the last stage ran twice under cudnn.deterministic: "
          f"students and head bit-equal")

    acc = ens.accuracy(data)
    base_acc = base.accuracy(data)
    print(f"offline accuracy: teacher {teacher.acc:.4f} (JAX package "
          f"{JAX_TEACHER_ACC:.4f}), ensemble all alive {acc:.4f} (JAX "
          f"package {JAX_ENSEMBLE_ACC:.4f}; before failout {base_acc:.4f}),"
          f" band ±{ACC_BAND}")
    if not (abs(teacher.acc - JAX_TEACHER_ACC) <= ACC_BAND
            and abs(acc - JAX_ENSEMBLE_ACC) <= ACC_BAND):
        raise AssertionError("offline: accuracy outside the band around "
                             "the JAX package's run")
    curve = ens.robustness_curve(data, max_losses=2)
    print(f"offline robustness curve: losses {curve.losses.tolist()}, mean "
          f"{np.round(curve.accuracy, 4).tolist()}, worst "
          f"{np.round(curve.worst, 4).tolist()}")
    thin = PL.thin_replicas(ens.ir, curve)
    print(f"offline thin_replicas: replicas per slot "
          f"{ens.ir.member.sum(1).tolist()} -> "
          f"{thin.member.sum(1).tolist()} (tolerated losses at 1%: "
          f"{curve.tolerated(0.01)})")

    # card vs CPU: the first teacher steps from one CPU draw, TF32 off
    tcfg = teacher.cfg
    t0 = time.perf_counter()
    _, on_card = PP.train_teacher(torch.Generator().manual_seed(1), tcfg,
                                  data, steps=CARD_CPU_STEPS,
                                  batch=OFFLINE["batch"], device=dev)
    t1 = time.perf_counter()
    _, on_cpu = PP.train_teacher(torch.Generator().manual_seed(1), tcfg,
                                 data, steps=CARD_CPU_STEPS,
                                 batch=OFFLINE["batch"], device="cpu")
    t2 = time.perf_counter()
    a, b = np.asarray(on_card["losses"]), np.asarray(on_cpu["losses"])
    rel = np.abs(a - b) / np.abs(b)
    print(f"offline card vs CPU: {CARD_CPU_STEPS} teacher steps, losses "
          f"card {a.tolist()} CPU {b.tolist()}, largest relative distance "
          f"{rel.max():.3e} (bound {CARD_CPU_RTOL}); card {t1 - t0:.3f} s, "
          f"CPU {t2 - t1:.3f} s")
    if not rel.max() <= CARD_CPU_RTOL:
        raise AssertionError("offline: card and CPU teacher losses differ")

    # serving what was trained
    # every device alive: each slot the planner gave a student arrives (a
    # slot without one never does, on the server as in Ensemble.predict)
    ops.quorum_aggregate.launches = 0           # the main path's window
    srv = server_from_ensemble(ens, failure=FailureModel(outages=False),
                               device=dev)
    servable = ens.ir.student_of >= 0
    worst = 0.0
    for rows in (1, 7, 64, 256):
        x = torch.from_numpy(data.batch(rows, 20_000 + rows)[0]).to(dev)
        (res,) = srv.serve_batch([x])
        if not np.array_equal(res.arrived, servable):
            raise AssertionError(f"offline: all devices alive, slots "
                                 f"{res.arrived.tolist()} arrived")
        worst = max(worst, max_err(torch.from_numpy(res.logits),
                                   ens.predict(x, res.arrived).cpu(),
                                   **PREDICT_TOL))
    checks = ops.quorum_aggregate.launches
    print(f"offline serve: {'fused' if srv.fastpath_active else 'legacy'} "
          f"path, 4 batches with every device alive ({int(servable.sum())} "
          f"of {len(servable)} slots have a student), logits vs "
          f"Ensemble.predict max abs err {worst:.3e}")

    failure = FailureModel(crash_prob=0.05, outages=True)
    rng = np.random.default_rng(7)
    times_r = np.cumsum(rng.exponential(1 / 200.0, N_OFFLINE_REQUESTS))
    sizes = rng.integers(1, MAX_REQUEST_ROWS + 1, N_OFFLINE_REQUESTS)

    def images(r, rows):
        x = r.standard_normal((rows, 32, 32, 3)).astype(np.float32)
        return torch.from_numpy(x).to(dev)

    cfg = EngineConfig(max_batch=8, max_wait=0.01, slo=1.0, seed=7)
    srv = server_from_ensemble(ens, failure=failure, seed=7, device=dev)
    tr, metrics = Tracer(), MetricsRegistry()
    before = ops.quorum_aggregate.launches
    report = ServingEngine(srv, cfg, make_input=images, tracer=tr,
                           metrics=metrics).run(times_r, sizes)
    torch.cuda.synchronize()
    traced = ops.quorum_aggregate.launches - before
    warm = warmup_calls(sizes, cfg, srv)
    if traced != len(report.batches) + warm:
        raise AssertionError(f"offline engine: {traced} launches for "
                             f"{len(report.batches)} batches + {warm} "
                             f"warm-up calls")
    latency = {r.rid: r.latency for r in report.records}
    paths = request_paths(tr.events)
    seg_err = max(abs(sum(d for _, d in p.segments) - latency[p.rid])
                  for p in paths)
    if len(paths) != report.summary()["n"] or seg_err > 1e-9:
        raise AssertionError(f"offline engine: {len(paths)} traced paths, "
                             f"segments miss latency by {seg_err:.3e}")
    if metrics.counter("requests_served").value != report.summary()["n"]:
        raise AssertionError("offline engine: metrics miscount requests")
    cp = critical_path(tr.events, q=99.0)
    print(f"offline engine (traced, wall clock): {report.summary()['n']} "
          f"requests in {len(report.batches)} batches, launches {traced} "
          f"(= batches + {warm} warm-up), {len(tr.events)} trace events, "
          f"segments sum to each latency within {seg_err:.1e} s, p99 "
          f"critical path rid {cp.path.rid}: "
          f"{[(n, round(d, 6)) for n, d in cp.path.segments]}")

    # tracing off changes no row (a modelled service time: no host clock)
    modelled = dataclasses.replace(cfg, service_model=(2e-3, 1e-4), seed=8)
    rows = []
    for tracer in (Tracer(), None):
        s2 = server_from_ensemble(ens, failure=failure, seed=8, device=dev)
        rows.append(report_rows(ServingEngine(
            s2, modelled, make_input=images, tracer=tracer).run(
                times_r, sizes)))
    for x, y in zip(*rows):
        np.testing.assert_equal(x, y)
    print(f"offline engine: tracer=None gives the traced run's "
          f"{len(rows[0][0])} request rows and {len(rows[0][1])} batch rows")

    # a two-tenant fleet over the trained server
    flat = flat_images(ens)
    tenants = [TenantSpec(
        name, server_from_ensemble(flat, failure=failure, seed=10 + i,
                                   device=dev),
        slo=SLOClass(name, 1.0, weight),
        config=EngineConfig(max_batch=8, max_wait=0.01, slo=1.0,
                            input_dim=32 * 32 * 3, seed=10 + i))
        for i, (name, weight) in enumerate((("gold", 4.0), ("bulk", 1.0)))]
    traces = [PoissonArrivals(200.0, sizes=(1, 4, 16)).generate(
        np.random.default_rng(20 + i), 0.2) for i in range(2)]
    ftr = Tracer()
    before = ops.quorum_aggregate.launches
    frep = FleetEngine(tenants, router=FleetRouter("predicted"), seed=0,
                       tracer=ftr, metrics=MetricsRegistry()).run(traces)
    torch.cuda.synchronize()
    fleet_launches = ops.quorum_aggregate.launches - before
    fwarm = sum(warmup_calls(np.asarray(sz), t.config, t.server)
                for t, (_, sz) in zip(tenants, traces))
    fbatches = sum(len(r.batches) for r in frep.reports)
    if fleet_launches != fbatches + fwarm:
        raise AssertionError(f"offline fleet: {fleet_launches} launches for "
                             f"{fbatches} batches + {fwarm} warm-up calls")
    fs = frep.summary()
    print(f"offline fleet: tenants {list(frep.tenants)}, "
          f"{[r.summary()['n'] for r in frep.reports]} requests, "
          f"{fbatches} batches, launches {fleet_launches} (= batches + "
          f"{fwarm} warm-up), p99 per tenant "
          f"{[round(p, 6) for p in fs['p99_per_tenant']]} s, "
          f"{len(request_paths(ftr.events))} traced requests")
    launches = ops.quorum_aggregate.launches
    print(f"offline: quorum_aggregate launches {launches} ({checks} checks "
          f"+ {traced} traced + {launches - checks - traced - fleet_launches}"
          f" modelled + {fleet_launches} fleet)")
    return dict(launches=launches, max_abs_err=worst)


# -- dense-LM training: rmsnorm_bwd, flash_attention_bwd ---------------------------

TRAIN_SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu"
                 for k in ("rmsnorm_bwd", "flash_attention_bwd")}
# no TPU kernel: the JAX package differentiates these plain functions
TRAIN_REPLACES = {"rmsnorm_bwd": "src/repro/models/layers.py:66",
                  "flash_attention_bwd": "src/repro/models/transformer.py:85"}
TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                 "flash_attention_bwd")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, CKPT_EVERY = 4, 512, 20, 10
# phase 21's and 29's llama3.2-1b depth: 4 of 16 layers (the call's time
# limit: uncut, phase 21's two checkpoints wrote 42 GB in ~50 s)
TRAIN_LAYERS = 4
# 2 AdamW steps (3 before phase 35 joined the call: the CPU's ~10 s a step)
CARD_CPU_TRAIN_STEPS, CARD_CPU_TRAIN_SEQ = 2, 64
TRAIN_TOL = 1e-3                # card vs CPU: losses and step-1 gradients
# (B, KV, G, Sq, Skv, D) of the flash backward sweep: every head dim, G 1,
# 2, 3 and 4, Sq != Skv both ways, the CUDA-core route's 32-row/key tile
# edges and the tensor route's 64-row/key ones (bf16 at D 64 and 128: Sq
# and Skv 1-2 off a multiple of 64, keys past Sq, a 64-row tile of G 3
# that splits a position's heads), and the students' widths (G 2)
FLASH_BWD_SWEEP = ((1, 1, 1, 64, 64, 64), (2, 2, 4, 100, 100, 64),
                   (1, 4, 2, 128, 128, 128), (1, 2, 4, 33, 33, 96),
                   (1, 2, 1, 5, 5, 32), (2, 8, 4, 512, 512, 64),
                   (1, 2, 4, 31, 65, 64), (1, 2, 1, 97, 33, 128),
                   (1, 1, 4, 1, 40, 32), (1, 2, 1, 129, 1, 96),
                   (1, 2, 4, 32, 32, 32), (1, 1, 1, 65, 96, 64),
                   (1, 8, 2, 512, 512, 64), (2, 2, 2, 66, 130, 64),
                   (1, 1, 2, 63, 129, 128), (1, 2, 3, 130, 190, 64))
RMS_BWD_ROWS = (1, 7, 2048, 4097)
LM_STUDENTS = 2                 # phase 22's K
DISTILL_STEPS, FAILOUT_STEPS = 3, 2


def rmsnorm_bwd_bound(rows, D, dtype) -> tuple:
    """Read x, g and the scale once, write dx and dscale once; about 10
    flops per element (two sums, dx, the scale's sum)."""
    e = torch.finfo(dtype).bits // 8
    return roofline(3 * rows * D * e + 2 * D * e, 10 * rows * D, dtype)


def flash_bwd_bound(B, KV, G, Sq, Skv, D, causal, dtype) -> tuple:
    """q, o, dO read and dq written (4 of B·KV·G·Sq·D), k, v read and dk,
    dv written (4 of B·KV·Skv·D); five products of 2·D flops per scored
    pair (q·k, dO·v, P·dO, dS·q, dS·k)."""
    e = torch.finfo(dtype).bits // 8
    nbytes = (4 * B * KV * G * Sq * D + 4 * B * KV * Skv * D) * e
    flops = 10 * D * B * KV * G * attention_pairs(Sq, Skv, causal)
    return roofline(nbytes, flops, dtype)


def flash_bwd_operands(B, KV, G, Sq, Skv, D, dtype, strided, gen, dev):
    """q, k, v and dO as the model hands them to the backward (views of
    (B, S, KV, G, D) and (B, S, KV, D) memory), or contiguous copies."""
    qm = torch.randn((B, Sq, KV, G, D), generator=gen, device=dev).to(dtype)
    km = torch.randn((B, Skv, KV, D), generator=gen, device=dev).to(dtype)
    vm = torch.randn((B, Skv, KV, D), generator=gen, device=dev).to(dtype)
    dm = torch.randn((B, Sq, KV, G, D), generator=gen, device=dev).to(dtype)
    ts = (qm.permute(0, 2, 3, 1, 4), km.permute(0, 2, 1, 3),
          vm.permute(0, 2, 1, 3), dm.permute(0, 2, 3, 1, 4))
    return ts if strided else tuple(t.contiguous() for t in ts)


def bwd_check(got, want, dtype, label: str) -> float:
    """Each gradient within the LM bounds of its plain version."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{label}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        try:
            e = max_err(a.float(), b.float(), **LM_KERNEL_TOL[b.dtype])
        except AssertionError as err:
            raise AssertionError(f"{label}: {err}") from err
        worst = max(worst, e)
    return worst


def rmsnorm_bwd_exact(x, sc, g) -> tuple:
    """The plain backward on fp64 copies, rounded to the kernel's dtypes:
    dscale sums every row, and two fp32 sums of thousands of rows in other
    orders differ by more than 3e-5 where the terms cancel."""
    dx, ds = ops.rmsnorm_bwd_ref(x.double(), sc.double(), g.double())
    return dx.to(x.dtype), ds.to(sc.dtype)


def same_twice(fn, label: str):
    """``fn()`` twice: every output bit-equal (no atomics in the sums)."""
    a, b = fn(), fn()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{label}: a second run differs")
    return a


def guarded_calls(dev) -> dict:
    """One call of each serving-only kernel (no backward), its first float
    operand passed through ``t`` (which makes it need a gradient)."""
    r = lambda *s: torch.rand(s, device=dev)  # noqa: E731
    q, kc, vc = decode_operands(1, 2, 2, 8, 64, torch.float32,
                                torch.Generator(device=dev).manual_seed(0),
                                dev)
    ones = lambda *s: torch.ones(s, dtype=torch.int32, device=dev)  # noqa
    return {
        "decode_attention": lambda t: ops.decode_attention(t(q), kc, vc, 3),
        "quorum_aggregate": lambda t: ops.quorum_aggregate(
            t(r(2, 4, 8)), r(2, 8, 3), r(3), ones(2)),
        "coded_decode": lambda t: ops.coded_decode(t(r(4, 3, 8)),
                                                   r(4, 2, 3), ones(4, 3)),
        "dequant_matmul": lambda t: ops.dequant_matmul(
            t(r(4, 8)), torch.ones((8, 5), dtype=torch.int8, device=dev),
            torch.tensor(0.1, device=dev)),
        "coded_matmul": lambda t: ops.coded_matmul(t(r(4, 8)), r(3, 8, 5)),
    }


def backward_timing(fwd, inputs, grad_out) -> callable:
    """A callable running only the autograd backward of ``fwd(*inputs)``
    for ``grad_out`` (the forward taped once, its graph kept)."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fwd(*leaves)
    return lambda: torch.autograd.grad(out, leaves, grad_out,
                                       retain_graph=True)


def phase_train_kernels(dev) -> dict:
    """rmsnorm_bwd and flash_attention_bwd vs their plain versions over
    sweeps, each case twice and bit-equal; timed at llama3.2-1b's training
    shapes; the five serving-only wrappers raise under grad."""
    gen = torch.Generator(device=dev).manual_seed(19)
    dtypes = (torch.float32, torch.bfloat16)
    worst = {k: 0.0 for k in TRAIN_SOURCES}
    cases = {k: 0 for k in TRAIN_SOURCES}
    launches = ops.rmsnorm_bwd.launches
    for dtype in dtypes:
        for D in RMS_SWEEP_D:
            errs = []
            for rows in RMS_BWD_ROWS:
                x = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
                sc = (1 + 0.1 * torch.randn((D,), generator=gen,
                                            device=dev)).to(dtype)
                g = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
                views = [(x, g)]
                if rows in (7, 2048):   # bases off 16 bytes: scalar route
                    views.append((unaligned_copy(x), unaligned_copy(g)))
                for xv, gv in views:
                    got = same_twice(lambda: ops.rmsnorm_bwd(xv, sc, gv),
                                     f"rmsnorm_bwd D={D} rows={rows}")
                    torch.cuda.synchronize()
                    e = bwd_check(got, rmsnorm_bwd_exact(xv, sc, gv), dtype,
                                  f"rmsnorm_bwd {dtype} D={D} rows={rows}")
                    worst["rmsnorm_bwd"] = max(worst["rmsnorm_bwd"], e)
                    cases["rmsnorm_bwd"] += 1
                errs.append(f"rows{rows}:{e:.1e}")
            print(f"rmsnorm_bwd {str(dtype)[6:]} D={D}: " + " ".join(errs))
    if ops.rmsnorm_bwd.launches - launches != 2 * cases["rmsnorm_bwd"]:
        raise AssertionError("rmsnorm_bwd: launches do not match the calls")
    copies = ops.flash_attention_bwd.copies
    for dtype in dtypes:
        for B, KV, G, Sq, Skv, D in FLASH_BWD_SWEEP:
            errs = []
            for causal in (True, False):
                for strided in (False, True):
                    q, k, v, do = flash_bwd_operands(B, KV, G, Sq, Skv, D,
                                                     dtype, strided, gen, dev)
                    o = ops.flash_attention_ref(q, k, v, causal=causal)
                    got = same_twice(
                        lambda: ops.flash_attention_bwd(q, k, v, o, do,
                                                        causal=causal),
                        f"flash_attention_bwd {(B, KV, G, Sq, Skv, D)}")
                    torch.cuda.synchronize()
                    e = bwd_check(got, ops.flash_attention_bwd_ref(
                        q, k, v, o, do, causal), dtype,
                        f"flash_attention_bwd {dtype} "
                        f"{(B, KV, G, Sq, Skv, D)} causal={causal}")
                    worst["flash_attention_bwd"] = max(
                        worst["flash_attention_bwd"], e)
                    cases["flash_attention_bwd"] += 1
                    errs.append(f"{'causal' if causal else 'full'}/"
                                f"{'strided' if strided else 'contig'}:"
                                f"{e:.1e}")
            route = ops_fa.bwd_route(dtype, D)
            print(f"flash_bwd {str(dtype)[6:]} (B,KV,G,Sq,Skv,D)=({B},{KV},"
                  f"{G},{Sq},{Skv},{D}) {route}: " + " ".join(errs))
    if ops.flash_attention_bwd.copies != copies:
        raise AssertionError("flash_attention_bwd copied a strided operand")
    for k in TRAIN_SOURCES:
        print(f"{k} vs plain: {cases[k]} cases within rtol/atol 3e-5 (fp32) "
              f"and 3e-2 (bf16), each run twice bit-equal, max abs err "
              f"{worst[k]:.3e}")

    # timings at llama3.2-1b's training shapes (batch 4 x 512, bf16)
    cfg = get_config(LM_ARCH)
    bf = torch.bfloat16
    B, S, d = TRAIN_BATCH, TRAIN_SEQ, cfg.d_model
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // KV
    F = torch.nn.functional
    timing = {}
    x = torch.randn((B * S, d), generator=gen, device=dev).to(bf)
    sc = (1 + 0.1 * torch.randn((d,), generator=gen, device=dev)).to(bf)
    g = torch.randn((B * S, d), generator=gen, device=dev).to(bf)
    e = bwd_check(ops.rmsnorm_bwd(x, sc, g), rmsnorm_bwd_exact(x, sc, g),
                  bf, "rmsnorm_bwd timed shape")
    worst["rmsnorm_bwd"] = max(worst["rmsnorm_bwd"], e)
    lib = backward_timing(lambda a, s: F.rms_norm(a, (d,), s, 1e-6),
                          (x, sc), g)
    timing["rmsnorm_bwd"] = dict(
        ms=cuda_ms(lambda: ops.rmsnorm_bwd(x, sc, g)),
        plain_ms=cuda_ms(lambda: ops.rmsnorm_bwd_ref(x, sc, g)),
        library_ms=cuda_ms(lib), shape=f"x, g ({B * S}, {d}) bf16",
        **device_pair(lambda: ops.rmsnorm_bwd(x, sc, g), lib))
    timing["rmsnorm_bwd"]["bound_ms"], timing["rmsnorm_bwd"]["bound_by"] = \
        rmsnorm_bwd_bound(B * S, d, bf)
    q, k, v, do = flash_bwd_operands(B, KV, G, S, S, hd, bf, True, gen, dev)
    o = ops.flash_attention(q, k, v, causal=True)
    e = bwd_check(ops.flash_attention_bwd(q, k, v, o, do, causal=True),
                  ops.flash_attention_bwd_ref(q, k, v, o, do, True), bf,
                  "flash_attention_bwd timed shape")
    worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"], e)
    qh = q.reshape(B, KV * G, S, hd)
    kh, vh = k.contiguous(), v.contiguous()
    lib = backward_timing(
        lambda a, b_, c: F.scaled_dot_product_attention(
            a, b_, c, is_causal=True, enable_gqa=G > 1),
        (qh, kh, vh), do.reshape(B, KV * G, S, hd))
    t = attention_timing(
        lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=True), lib,
        f"(B,KV,G,S,D)=({B},{KV},{G},{S},{hd}) bf16 causal, strided views",
        flash_bwd_bound(B, KV, G, S, S, hd, True, bf))
    t["plain_ms"] = cuda_ms(lambda: ops.flash_attention_bwd_ref(
        q, k, v, o, do, True), iters=10, warm=2)
    timing["flash_attention_bwd"] = t
    plan = ops_fa.bwd_plan(bf, B, KV, G, S, S, hd, True)
    # the CUDA-core route at the same shape, for the record
    cores = MB.time_callable(lambda: ops_fa._bwd(
        q, k, v, o, do, True, cuda_cores=True), repeats=20, warmup=2) * 1e3
    for name, t in timing.items():
        t["max_abs_err"] = worst[name]
        report_timing(name, t)
    print(f"flash_attention_bwd route at (B,KV,G,S,D)=({B},{KV},{G},{S},"
          f"{hd}) bf16: {plan.route} ({plan.launches} launches); the "
          f"CUDA-core route there: device {cores:.5f} ms")
    # the students' widths (phase 22): half the query heads, G 2
    scfg = LMS.student_config(cfg, cfg.d_model // LM_STUDENTS)
    sG = scfg.n_heads // scfg.n_kv_heads
    sq, sk, sv, sdo = flash_bwd_operands(B, scfg.n_kv_heads, sG, S, S,
                                         scfg.head_dim, bf, True, gen, dev)
    so = ops.flash_attention(sq, sk, sv, causal=True)
    e = bwd_check(ops.flash_attention_bwd(sq, sk, sv, so, sdo, causal=True),
                  ops.flash_attention_bwd_ref(sq, sk, sv, so, sdo, True), bf,
                  "flash_attention_bwd student shape")
    timing["flash_attention_bwd"]["max_abs_err"] = max(
        timing["flash_attention_bwd"]["max_abs_err"], e)
    slib = backward_timing(
        lambda a, b_, c: F.scaled_dot_product_attention(
            a, b_, c, is_causal=True, enable_gqa=sG > 1),
        (sq.reshape(B, scfg.n_heads, S, scfg.head_dim), sk.contiguous(),
         sv.contiguous()), sdo.reshape(B, scfg.n_heads, S, scfg.head_dim))
    sroute = ops_fa.bwd_route(bf, scfg.head_dim)
    st = attention_timing(
        lambda: ops.flash_attention_bwd(sq, sk, sv, so, sdo, causal=True),
        slib, f"(B,KV,G,S,D)=({B},{scfg.n_kv_heads},{sG},{S},"
        f"{scfg.head_dim}) bf16 causal (the students' widths), {sroute}",
        flash_bwd_bound(B, scfg.n_kv_heads, sG, S, S, scfg.head_dim, True,
                        bf))
    report_timing("flash_attention_bwd", st)

    calls = guarded_calls(dev)
    for name, call in calls.items():
        try:
            call(lambda t: t.clone().requires_grad_())
        except RuntimeError as err:
            if "no backward kernel" not in str(err):
                raise
        else:
            raise AssertionError(f"{name}: launched under grad on an "
                                 f"operand that needs a gradient")
        with torch.no_grad():
            call(lambda t: t.clone().requires_grad_())
        call(lambda t: t)
    torch.cuda.synchronize()
    print(f"guard: {', '.join(calls)} raise under grad on operands that "
          f"need a gradient and launch under no_grad or on plain operands")
    return timing


def train_launches() -> tuple:
    """Calls of the training path's four kernels, ``TRAIN_KERNELS``
    order."""
    return tuple(getattr(ops, k).launches for k in TRAIN_KERNELS)


def zero_train_launches() -> None:
    for k in TRAIN_KERNELS:
        getattr(ops, k).launches = 0


def layer_slices(tree) -> list:
    """(key, tensor) for every leaf, the stacked layer leaves (an
    enc-dec's encoder and decoder layers too) cut into one entry per
    layer."""
    out = []
    for key, t in flatten_with_keys(tree):
        if key.startswith(("['layers']", "['enc_layers']", "['dec_layers']")):
            out += [(f"{key}[{i}]", t[i]) for i in range(t.shape[0])]
        else:
            out.append((key, t))
    return out


def unused_leaves(cfg) -> tuple:
    """Keys of the leaves the loss does not reach: the VLM's token
    embedding, which its patch embeddings replace."""
    if cfg.embed_inputs and cfg.family != "encdec":
        return ("['embed']['embedding']",)
    return ()


def check_gradients(grads, label: str, zero: tuple = ()) -> None:
    """Every leaf's (every layer's) gradient finite and nonzero, except
    the leaves in ``zero``, whose gradients are all zero."""
    for key, g in layer_slices(grads):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: gradient of {key} not finite")
        if bool(g.abs().sum() > 0) == (key in zero):
            raise AssertionError(f"{label}: gradient of {key} is "
                                 f"{'non' if key in zero else ''}zero")


def token_batches(cfg, batch: int, seq: int, steps: int, dev, seed: int = 0,
                  start: int = 0) -> list:
    """``train.run``'s batches for global steps ``start`` … ``start +
    steps - 1``: the token data's, and for an ``embed_inputs`` config its
    embeddings (``train.embed_batch``)."""
    data = SyntheticTokens(TokenTaskConfig(vocab=cfg.vocab, seq_len=seq,
                                           seed=seed))
    out = []
    for i, (t, lb) in enumerate(data.epoch(batch, steps, start=start)):
        b = {"tokens": torch.from_numpy(t).to(dev),
             "labels": torch.from_numpy(lb).to(dev)}
        if cfg.embed_inputs:
            b["embeds"] = TR.embed_batch(cfg, batch, seq, seed, start + i,
                                         torch.device(dev))
        out.append(b)
    return out


def phase_train_card_vs_cpu(dev) -> None:
    """llama3.2-1b at full width cut to 2 layers, fp32: the same weights
    (drawn once on the CPU) and batches through CARD_CPU_TRAIN_STEPS
    AdamW steps on the CPU
    and on the card; losses within 1e-3 relative, step-1 gradients within
    1e-3, every gradient finite and nonzero, launches exact per step."""
    cfg = get_config(LM_ARCH).with_(n_layers=2, param_dtype=torch.float32,
                                    compute_dtype=torch.float32)
    L = cfg.n_layers
    opt = adamw.AdamWConfig(warmup_steps=1, total_steps=CARD_CPU_TRAIN_STEPS)
    params = api.init(torch.Generator().manual_seed(5), cfg)
    cpu_b = token_batches(cfg, TRAIN_BATCH, CARD_CPU_TRAIN_SEQ,
                          CARD_CPU_TRAIN_STEPS, torch.device("cpu"), seed=5)

    def train(p, batches):
        st = ST.TrainState(p, adamw.init(opt, p))
        losses, first, counts = [], None, []
        for b in batches:
            zero_train_launches()
            loss, grads = ST.loss_and_grads(st.params, cfg, b)
            counts.append(train_launches())
            first = grads if first is None else first
            st = ST.TrainState(*adamw.apply_updates(opt, st.params, grads,
                                                    st.opt)[:2])
            losses.append(float(loss))
        return losses, first, counts

    t0 = time.perf_counter()
    cpu_losses, cpu_g, _ = train(tree_map(torch.clone, params), cpu_b)
    cpu_s = time.perf_counter() - t0
    card_losses, card_g, counts = train(
        tree_to(params, dev), [tree_to(b, dev) for b in cpu_b])
    want = (2 * L + 1, 2 * L + 1, L, L)
    if any(c != want for c in counts):
        raise AssertionError(f"train card-vs-cpu: launches {TRAIN_KERNELS} "
                             f"per step {counts}, expected {want}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    if not rel <= TRAIN_TOL:
        raise AssertionError(f"train card-vs-cpu: losses {card_losses} vs "
                             f"{cpu_losses} (rel {rel:.2e})")
    check_gradients(card_g, "train card-vs-cpu")
    worst = 0.0
    for (key, a), (_, b) in zip(flatten_with_keys(card_g),
                                flatten_with_keys(cpu_g)):
        scale = float(b.abs().max())
        err = float((a.cpu() - b).abs().max()) / scale
        if not err <= TRAIN_TOL:
            raise AssertionError(f"train card-vs-cpu: step-1 gradient of "
                                 f"{key} differs by {err:.2e} of its largest")
        worst = max(worst, err)
    print(f"train card-vs-cpu: {LM_ARCH} full width, {L} layers, fp32, "
          f"batch {TRAIN_BATCH} x {CARD_CPU_TRAIN_SEQ}, "
          f"{CARD_CPU_TRAIN_STEPS} AdamW steps: losses {[round(v, 6) for v in card_losses]} (CPU "
          f"{[round(v, 6) for v in cpu_losses]}, max rel {rel:.2e}); step-1 "
          f"gradients within {worst:.2e} of each leaf's largest, all finite "
          f"and nonzero; launches {want} a step; CPU run {cpu_s:.1f} s")


def train_profile(step, state, batch, arch: str) -> dict:
    """``lm_profile`` of one train step, with the backward kernels'
    shares."""
    box = {"state": state}

    def one():
        box["state"], _ = step(box["state"], batch)
    return lm_profile(f"{arch} train step {TRAIN_BATCH} x {TRAIN_SEQ}", one,
                      1)


def phase_train_full(dev) -> dict:
    """The dense slice's main path: full-width bf16 llama3.2-1b cut to
    TRAIN_LAYERS layers trained through ``train.run`` for 20 steps with
    checkpoints every 10 (``train_full``)."""
    return train_full(LM_ARCH, TRAIN_LAYERS, TRAIN_STEPS, CKPT_EVERY, dev)


def train_full(arch: str, layers, n: int, ckpt, dev, rerun: bool = False
               ) -> dict:
    """``arch`` at full width (cut to ``layers`` layers, or uncut) trained
    through ``train.run`` for ``n`` steps, with checkpoints every ``ckpt``
    (or none): every leaf's (every layer's) step-1 gradient finite and
    nonzero (the VLM's unused token embedding zero), the eight training
    kernels' launches exact, the loss falling; with checkpoints the
    step-``ckpt`` one restored and stepped to ``n`` bit-equal to the run's
    state; with ``rerun`` a second run's losses and state bit-equal to the
    first's; step ms and tokens/s over 3 steps, and a profile of one
    step."""
    cfg = get_config(arch)
    cfg = cfg.with_(n_layers=layers) if layers else cfg
    torch.cuda.reset_peak_memory_stats(dev)
    # step 1's gradient, from run's own weights (seed 0) and first batch
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = api.param_count(params)
    first = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev)[0]
    _, grads = ST.loss_and_grads(params, cfg, first)
    check_gradients(grads, f"train {arch} step 1", unused_leaves(cfg))
    del params, grads
    torch.cuda.empty_cache()
    dtype = str(cfg.param_dtype)[6:]
    with depth_cut(arch, layers), tempfile.TemporaryDirectory() as tmp:
        zero_ssm_train_launches()
        t0 = time.perf_counter()
        state, losses = TR.run(arch, tiny=False, steps=n, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ, ckpt_dir=tmp if ckpt else None,
                               ckpt_every=ckpt or n, verbose=False,
                               device=dev)
        run_s = time.perf_counter() - t0
        launches, want = ssm_train_launches(), train_expected(cfg, n)
        if launches != want:
            raise AssertionError(f"train {arch}: launches "
                                 f"{SSM_TRAIN_KERNELS} {launches}, expected "
                                 f"{want}")
        q = max(1, n // 4)
        head, tail = np.mean(losses[:q]), np.mean(losses[-q:])
        if not (np.isfinite(losses).all() and tail < head):
            raise AssertionError(f"train {arch}: losses {losses} not falling")
        ckpt_gb = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                      if f.is_file()) / 1e9
        saves = (f"checkpoints every {ckpt} included, {ckpt_gb:.2f} GB on "
                 f"disk" if ckpt else "no checkpoints")
        print(f"train: {arch} full width ({cfg.n_layers} layers"
              f"{'' if layers is None else ' after a depth cut'}, "
              f"{n_params:,} parameters, {dtype}), batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}, {n} steps through train.run in {run_s:.1f} s "
              f"({saves}): loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean "
              f"of first {q} {head:.4f}, last {q} {tail:.4f}); step-1 "
              f"gradient finite and nonzero in every leaf of all "
              f"{cfg.n_layers} layers; launches "
              f"{dict(zip(SSM_TRAIN_KERNELS, launches))}; peak device "
              f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
              f"GiB")
        if rerun:
            again, losses2 = TR.run(arch, tiny=False, steps=n,
                                    batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                    verbose=False, device=dev)
            for (key, a), (_, b) in zip(flatten_with_keys(again),
                                        flatten_with_keys(state)):
                if not torch.equal(a, b):
                    raise AssertionError(f"train {arch}: a rerun's {key} "
                                         f"differs at step {n}")
            if losses2 != losses:
                raise AssertionError(f"train {arch}: a rerun's losses "
                                     f"{losses2} differ from {losses}")
            print(f"train: {arch} rerun of the {n} steps: losses and state "
                  f"(params, master, m, v, step) bit-equal")
            del again
        opt = adamw.AdamWConfig(lr=3e-4, total_steps=n,
                                warmup_steps=max(n // 10, 1))
        step = ST.make_train_step(cfg, opt)
        if ckpt:
            t0 = time.perf_counter()
            resumed = CheckpointManager(tmp).restore(ckpt, state)
            restore_s = time.perf_counter() - t0
            if int(resumed.opt.step) != ckpt:
                raise AssertionError(f"train {arch}: restored step "
                                     f"{int(resumed.opt.step)}")
            for b in token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, n - ckpt, dev,
                                   start=ckpt):
                resumed, _ = step(resumed, b)
            for (key, a), (_, b) in zip(flatten_with_keys(resumed),
                                        flatten_with_keys(state)):
                if not torch.equal(a, b):
                    raise AssertionError(f"train {arch}: resumed {key} "
                                         f"differs at step {n}")
            print(f"train: {arch} step-{ckpt} checkpoint restored in "
                  f"{restore_s:.1f} s (params, master, m, v, step) and "
                  f"stepped to {n}: bit-equal to the run's state")
            del state
            state = resumed
    batch = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev, start=n)[0]
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        state, m = step(state, batch)
    float(m["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3 / reps
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    print(f"train: {arch} step {step_ms:.3f} ms ({tok_s:,.0f} tokens/s) at "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, {dtype}, mean of {reps} steps")
    out = dict(launches=dict(zip(SSM_TRAIN_KERNELS, launches)),
               step_ms=step_ms, tokens_per_s=tok_s,
               profile=train_profile(step, state, batch, arch))
    del state, m
    torch.cuda.empty_cache()
    return out


def phase_lm_rocoin(dev) -> dict:
    """RoCoIn at LM scale on the card: the plan on a full-width llama3.2-1b
    teacher's 2048 final channels, two students distilled and failout-tuned
    through the training kernels, the merged portions through the
    teacher's head finite with either slot lost."""
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(22)
    teacher = api.init(gen, cfg)
    val = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev, seed=22)[0]
    zero_train_launches()
    t0 = time.perf_counter()
    plan, A = LMS.plan_lm_rocoin(make_fleet(4, seed=1), teacher, cfg,
                                 val["tokens"])
    plan_s = time.perf_counter() - t0
    parts = [g.filters for g in plan.groups]
    source = "the plan's groups"
    if len(parts) != LM_STUDENTS:
        parts = NC.ncut_partition(A, K=LM_STUDENTS)
        source = f"Ncut of the graph (the plan has {len(plan.groups)} groups)"
    print(f"lm-rocoin: graph {A.shape} over {cfg.name}'s final channels, "
          f"plan d_th {plan.d_th:.4g}, {len(plan.groups)} groups of "
          f"{[len(g.devices) for g in plan.groups]} devices in {plan_s:.1f} "
          f"s; students on {source}: partitions of "
          f"{[len(p) for p in parts]} channels")

    def batches(seed):
        def it():
            data = SyntheticTokens(TokenTaskConfig(
                vocab=cfg.vocab, seq_len=TRAIN_SEQ, seed=seed))
            for t, _ in data.epoch(TRAIN_BATCH, 10 ** 6):
                yield t
        return it

    t0 = time.perf_counter()
    students = LMS.distill_lm_students(gen, teacher, cfg, parts,
                                       batches(23), steps=DISTILL_STEPS)
    distill_s = time.perf_counter() - t0
    fcfg = FailoutConfig(max_losses=1, seed=9, steps=FAILOUT_STEPS)
    t0 = time.perf_counter()
    tuned = LMS.failout_finetune_lm(students, teacher, cfg, batches(24), fcfg)
    failout_s = time.perf_counter() - t0
    launches = train_launches()
    if not all(launches):
        raise AssertionError(f"lm-rocoin: launches {TRAIN_KERNELS} "
                             f"{launches}: a kernel did not run")
    toks = val["tokens"]
    inv = torch.as_tensor(LMS.merge_order(tuned, cfg.d_model), device=dev)
    with torch.no_grad():
        merged = torch.cat([LMS.student_portion(st, toks) for st in tuned],
                           -1)[..., inv]
        for lost in range(LM_STUDENTS):
            mask = torch.ones(cfg.d_model, device=dev)
            mask[torch.as_tensor(tuned[lost].partition, device=dev)] = 0.0
            logits = T._lm_head(teacher, cfg,
                                    (merged * mask).to(cfg.compute_dtype))
            if logits.shape != (*toks.shape, cfg.vocab) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"lm-rocoin: logits with slot {lost} "
                                     f"lost malformed")
    st = tuned[0].cfg
    print(f"lm-rocoin: {LM_STUDENTS} students ({st.n_layers} layers, d_model "
          f"{st.d_model}, {api.param_count(tuned[0].params):,} parameters "
          f"each) distilled {DISTILL_STEPS} steps each in {distill_s:.1f} s "
          f"and failout-tuned {FAILOUT_STEPS} steps in {failout_s:.1f} s at "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}; launches {launches}; merged "
          f"logits finite with either slot lost")
    return dict(launches=dict(zip(TRAIN_KERNELS, launches)))


# -- SSM, MoE and hybrid training: ssd_scan_bwd, topk_gating_bwd -------------------

SSM_TRAIN_SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu"
                     for k in ("ssd_scan_bwd", "topk_gating_bwd")}
# no TPU kernel: the JAX package differentiates these plain functions
SSM_TRAIN_REPLACES = {"ssd_scan_bwd": "src/repro/models/ssm.py:76",
                      "topk_gating_bwd": "src/repro/models/transformer.py:230"}
SSM_TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                     "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd",
                     "topk_gating", "topk_gating_bwd")
# (B, H, L, P, N, Q) of the scan backward's sweep: mamba2-130m's and
# jamba's training shapes, the tiny configs', L below the chunk, a ragged
# chunk count (64-row tiles of a 48-step chunk) on each route, N 8 and a
# 100-step chunk; bf16 at the models' (P, N) takes the tensor route
SCAN_BWD_SWEEP = ((4, 24, 512, 64, 128, 256), (4, 128, 512, 64, 16, 256),
                  (2, 8, 64, 32, 16, 32), (2, 3, 20, 32, 16, 32),
                  (1, 4, 96, 16, 32, 48), (2, 2, 200, 32, 8, 100),
                  (1, 4, 96, 64, 16, 48))
# (N, E, k) of the gating backward's sweep: moonshot's and jamba's
# training rows, decode steps' rows, N = 0, ragged E, E 256 and k = E
GATE_BWD_SWEEP = ((2048, 64, 6), (2048, 16, 2), (4, 64, 6), (4, 16, 2),
                  (0, 64, 6), (77, 100, 5), (33, 256, 8), (6, 3, 3))
# the scan backward in fp32: the forward's bound (SSD_TOL), relative to
# each gradient's largest entry, since its sums of thousands of products
# cancel; a bf16 gradient may also sit one bf16 step (2^-7 of its value)
# away, the kernel and the plain version each rounding an fp32 sum
SCAN_BWD_TOL = 2e-3
BF16_STEP = 2.0 ** -7
# phase 25's runs: (arch, depth cut or None, steps, checkpoint interval)
# moonshot at 4 layers (2.95 B parameters) ran out of an H100's 80 GB in
# AdamW's per-leaf temporaries (5.5 GiB a temporary of the stacked expert
# leaf, over 47 GB of state): cut to 2
SSM_TRAIN_RUNS = (("mamba2-130m", None, TRAIN_STEPS, CKPT_EVERY),
                  (MOE_ARCH, 2, 10, None))
JAMBA_TRAIN_LAYERS = 8           # one period


def scan_bwd_operands(Bsz, H, L, P, N, dtype, layout, gen, dev):
    """The scan's operands as the model gives them, with B and C (B, L, N)
    shared by the heads ("shared"), expanded over the heads with stride 0
    ("stride0"), or per head ("per_head")."""
    x, dt, A, Bm, Cm = ssd_operands(Bsz, H, L, P, N, dtype, True, gen, dev)
    if layout == "shared":
        Bm, Cm = Bm[:, 0], Cm[:, 0]
    elif layout == "per_head":
        Bm, Cm = ((t.float() + 0.1 * torch.randn(t.shape, generator=gen,
                                                 device=dev)).to(dtype)
                  for t in (Bm, Cm))
    return x, dt, A, Bm, Cm


def scan_bwd_check(got, want, label: str) -> tuple:
    """(max abs err, max err over the largest entry): every gradient in its
    operand's shape and dtype within SCAN_BWD_TOL of its largest entry,
    plus one bf16 step of each value for bf16 gradients."""
    worst = rel = 0.0
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{label} {name}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        a, b = a.double(), b.double()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label} {name}: not finite")
        top = float(b.abs().max())
        step = BF16_STEP if got[0].dtype == torch.bfloat16 and name in (
            "dx", "dB", "dC") else 0.0
        diff = (a - b).abs()
        if bool((diff > SCAN_BWD_TOL * top + step * b.abs()).any()):
            raise AssertionError(f"{label} {name}: max abs err "
                                 f"{float(diff.max()):.3e} of largest "
                                 f"{top:.3e}")
        worst = max(worst, float(diff.max()))
        rel = max(rel, float(diff.max()) / max(top, 1e-30))
    return worst, rel


def ssd_bwd_bound(Bsz, H, L, P, N, Q, dtype, shared) -> tuple:
    """x, dt, A, B, C and dy (fp32) read once, dx, ddt, dA, dB and dC
    written once (B, C and their gradients once per batch row where the
    heads share them); the chunked backward's operations, at the fp32
    rate (dy and every factor are fp32): per chunk the causal (t, s)
    pairs' C·B and the products of their summed weights with B and C
    (6·N flops a pair, once per batch row where B and C are shared), dy·xb
    and the x gradient (4·P a pair a head), and five (Q, P, N) products a
    head (the chunk's state and its gradient, and their three terms)."""
    e = torch.finfo(dtype).bits // 8
    bc = Bsz * L * N * (1 if shared else H)
    nbytes = (2 * Bsz * L * H * P * e + 2 * Bsz * L * H * 4 + H * 4
              + Bsz * H * 4 + 4 * bc * e + Bsz * L * H * P * 4)
    pairs = Q * (Q + 1) // 2
    flops = (L // Q) * (bc // L * pairs * 6 + Bsz * H * (
        pairs * 4 * P + 10 * Q * P * N))
    return roofline(nbytes, flops, torch.float32)


def gating_bwd_bound(N, E, k) -> tuple:
    """The logits read and dlogits written once, the k indices, weights and
    their gradients read once; per element the softmax again (max, exp,
    sum, division), k compares and the two products."""
    return roofline(2 * N * E * 4 + 3 * N * k * 4, N * E * (7 + k),
                    torch.float32)


def phase_ssm_train_kernels(dev) -> dict:
    """ssd_scan_bwd and topk_gating_bwd vs their plain backward versions
    over sweeps, each case twice and bit-equal (the scan's route printed
    per shape; chunk 256 at dt = softplus(0), the reference's NaN, finite
    on the tensor route); timed at the training shapes beside their
    bounds, their plain versions and autograd of the plain forwards, the
    scan's tensor route also beside its own bound (its bf16
    operations)."""
    gen = torch.Generator(device=dev).manual_seed(23)
    worst = {k: 0.0 for k in SSM_TRAIN_SOURCES}
    cases = {k: 0 for k in SSM_TRAIN_SOURCES}
    launches = ops.ssd_scan_bwd.launches
    for B, H, L, P, N, Q in SCAN_BWD_SWEEP:
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            rel = 0.0
            for layout in ("shared", "stride0", "per_head"):
                for with_dh in (False, True):
                    args = scan_bwd_operands(B, H, L, P, N, dtype, layout,
                                             gen, dev)
                    dy = torch.randn(args[0].shape, generator=gen,
                                     device=dev)
                    dh = (torch.randn((B, H, P, N), generator=gen, device=dev)
                          if with_dh else None)
                    label = (f"ssd_scan_bwd {(B, H, L, P, N, Q)} "
                             f"{str(dtype)[6:]} {layout} dh={with_dh}")
                    got = same_twice(lambda: ops.ssd_scan_bwd(
                        *args, dy, dh, chunk=Q), label)
                    torch.cuda.synchronize()
                    e, r = scan_bwd_check(got, ops.ssd_scan_bwd_ref(
                        *args, dy, dh, chunk=Q), label)
                    worst["ssd_scan_bwd"] = max(worst["ssd_scan_bwd"], e)
                    rel = max(rel, r)
                    cases["ssd_scan_bwd"] += 1
            errs.append(f"{str(dtype)[6:]} ({SS.bwd_route(dtype, P, N)}):"
                        f"{rel:.1e}")
        print(f"ssd_scan_bwd (B,H,L,P,N,Q)=({B},{H},{L},{P},{N},{Q}), "
              f"shared/stride-0/per-head B and C, dh zero and not, largest "
              f"error over largest entry: " + " ".join(errs))
    for P, N in SS.BWD_MMA_SHAPES:      # no positive exponent at chunk 256
        x, dt, A, Bm, Cm = scan_bwd_operands(2, 4, 512, P, N, torch.bfloat16,
                                             "shared", gen, dev)
        args = (x, torch.full_like(dt, float(np.log(2.0))),
                -torch.ones_like(A), Bm, Cm)
        dy = torch.randn(x.shape, generator=gen, device=dev)
        label = f"ssd_scan_bwd chunk 256 at dt = softplus(0), (P, N) {P, N}"
        got = same_twice(lambda: ops.ssd_scan_bwd(*args, dy, chunk=256),
                         label)
        torch.cuda.synchronize()
        e, r = scan_bwd_check(got, ops.ssd_scan_bwd_ref(*args, dy, chunk=256),
                              label)
        worst["ssd_scan_bwd"] = max(worst["ssd_scan_bwd"], e)
        cases["ssd_scan_bwd"] += 1
        print(f"{label}, A = -1 (the reference's NaN): every gradient "
              f"finite, largest error over largest entry {r:.1e}")
    if ops.ssd_scan_bwd.launches - launches != 2 * cases["ssd_scan_bwd"]:
        raise AssertionError("ssd_scan_bwd: launches do not match the calls")
    launches = ops.topk_gating_bwd.launches
    launched = 0
    for N, E, k in GATE_BWD_SWEEP:
        e = 0.0
        for aligned in (True, False):
            logits = 2 * torch.randn((N, E), generator=gen, device=dev)
            if N > 2:
                logits[0] = 0.0                     # a row of ties
                logits[1, [E - 1, 0]] = 3.0         # tied maxima
                logits[2] = -20.0                   # near-zero weights
                logits[2, 0] = 20.0
            if not aligned:                         # the scalar route
                logits = unaligned_copy(logits)
            w, idx = ops.topk_gating(logits, k)
            dw = torch.randn((N, k), generator=gen, device=dev)
            got = same_twice(lambda: (ops.topk_gating_bwd(logits, idx, w,
                                                          dw),),
                             f"topk_gating_bwd {(N, E, k)}")[0]
            torch.cuda.synchronize()
            e = max(e, max_err(got, ops.topk_gating_bwd_ref(logits, idx, w,
                                                            dw), **GATE_TOL))
            cases["topk_gating_bwd"] += 1
            launched += 2 if N else 0
        worst["topk_gating_bwd"] = max(worst["topk_gating_bwd"], e)
        print(f"topk_gating_bwd (N,E,k)=({N},{E},{k}), 16-byte and scalar "
              f"route, tied rows and near-zero weights: max abs err {e:.1e}")
    if ops.topk_gating_bwd.launches - launches != launched:
        raise AssertionError("topk_gating_bwd: launches do not match the "
                             "calls")
    print(f"ssd_scan_bwd vs plain: {cases['ssd_scan_bwd']} cases, every "
          f"gradient within {SCAN_BWD_TOL} of its largest entry (bf16 ones "
          f"also one bf16 step), max abs err {worst['ssd_scan_bwd']:.3e}; "
          f"topk_gating_bwd vs plain: {cases['topk_gating_bwd']} cases "
          f"within 1e-5, max abs err {worst['topk_gating_bwd']:.3e}; each "
          f"run twice bit-equal")

    timing = {}
    f32 = torch.float32
    for arch in ("mamba2-130m", "jamba-v0.1-52b"):   # the JSON keeps mamba2
        cfg = get_config(arch)
        H, P, N, Q = (cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_chunk)
        B, L = TRAIN_BATCH, TRAIN_SEQ
        args = scan_bwd_operands(B, H, L, P, N, torch.bfloat16, "shared",
                                 gen, dev)
        dy = torch.randn(args[0].shape, generator=gen, device=dev)
        e, _ = scan_bwd_check(ops.ssd_scan_bwd(*args, dy, chunk=Q),
                              ops.ssd_scan_bwd_ref(*args, dy, chunk=Q),
                              f"ssd_scan_bwd timed at {arch}'s shape")
        worst["ssd_scan_bwd"] = max(worst["ssd_scan_bwd"], e)

        def kernel():
            return ops.ssd_scan_bwd(*args, dy, chunk=Q)
        auto = backward_timing(lambda *a: ops.ssd_scan_ref(
            *a, chunk=Q, out_dtype=f32), args, dy)
        plan = SS.bwd_plan(torch.bfloat16, B, H, L, P, N, Q, True,
                           num_sms(dev.index or 0))
        t = dict(ms=cuda_ms(kernel, iters=20, warm=3),
                 device_ms=MB.time_callable(kernel, repeats=20,
                                            warmup=2) * 1e3,
                 plain_ms=cuda_ms(lambda: ops.ssd_scan_bwd_ref(
                     *args, dy, chunk=Q), iters=5, warm=1),
                 autograd_ms=MB.time_callable(auto, repeats=5,
                                              warmup=1) * 1e3,
                 library_ms=None,
                 bound=ssd_bwd_bound(B, H, L, P, N, Q, torch.bfloat16, True),
                 route_bound_ms=(SS.bwd_mma_flops(B, H, L, P, N, Q)
                                 / BF16_FLOPS * 1e3
                                 if plan.route == "mma" else None))
        timing.setdefault("ssd_scan_bwd", t)
        route = ("" if t["route_bound_ms"] is None else
                 f", the {plan.route} route's own bound (its bf16 "
                 f"operations) {t['route_bound_ms']:.6f} ms")
        print(f"ssd_scan_bwd timing at {arch}'s (B,L,H,P,N,Q)=({B},{L},{H},"
              f"{P},{N},{Q}), bf16 x/B/C as the model's views, dy fp32: "
              f"kernel {t['ms']:.5f} ms, device {t['device_ms']:.5f} ms, "
              f"plain {t['plain_ms']:.5f} ms, autograd of the plain forward "
              f"device {t['autograd_ms']:.5f} ms, bound {t['bound'][0]:.6f} "
              f"ms ({t['bound'][1]}){route}; no one PyTorch call computes "
              f"it; plan {plan}")
    for N, E, k in ((TRAIN_BATCH * TRAIN_SEQ, get_config(MOE_ARCH).n_experts,
                     get_config(MOE_ARCH).top_k),
                    (TRAIN_BATCH * TRAIN_SEQ, 16, 2), (LM_BATCH, 64, 6)):
        logits = torch.randn((N, E), generator=gen, device=dev)
        w, idx = ops.topk_gating(logits, k)
        dw = torch.randn((N, k), generator=gen, device=dev)

        def kernel():
            return ops.topk_gating_bwd(logits, idx, w, dw)
        auto = backward_timing(lambda a: ops.topk_gating_ref(a, k)[0],
                               (logits,), dw)
        t = dict(ms=cuda_ms(kernel),
                 device_ms=MB.time_callable(kernel, repeats=200,
                                            warmup=3) * 1e3,
                 plain_ms=cuda_ms(lambda: ops.topk_gating_bwd_ref(
                     logits, idx, w, dw)),
                 autograd_ms=MB.time_callable(auto, repeats=200,
                                              warmup=3) * 1e3,
                 library_ms=None, bound=gating_bwd_bound(N, E, k),
                 route_bound_ms=None)
        timing.setdefault("topk_gating_bwd", t)
        print(f"topk_gating_bwd timing at (N,E,k)=({N},{E},{k}): kernel "
              f"{t['ms']:.5f} ms, device {t['device_ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f} ms, autograd of the plain forward device "
              f"{t['autograd_ms']:.5f} ms, bound {t['bound'][0]:.7f} ms "
              f"({t['bound'][1]}); no one PyTorch call computes it")
    for name, t in timing.items():
        t["bound_ms"], t["bound_by"] = t.pop("bound")
        t["max_abs_err"] = worst[name]
    return timing


def ssm_train_launches() -> tuple:
    """Calls of the eight training kernels, ``SSM_TRAIN_KERNELS`` order."""
    return tuple(getattr(ops, k).launches for k in SSM_TRAIN_KERNELS)


def zero_ssm_train_launches() -> None:
    for k in SSM_TRAIN_KERNELS:
        getattr(ops, k).launches = 0


def train_expected(cfg, steps: int = 1) -> tuple:
    """``SSM_TRAIN_KERNELS`` launches of ``steps`` train steps: each norm,
    attention layer, mamba mixer and router of the forward
    (``expected_launches`` of one call) once forward and once backward."""
    norms, attn, _, mamba, moe = expected_launches(cfg, 0)
    return tuple(v * steps for v in (norms, norms, attn, attn, mamba, mamba,
                                     moe, moe))


def phase_ssm_train_card_vs_cpu(dev) -> None:
    """The tiny fp32 mamba2-130m, moonshot-v1-16b-a3b and jamba-v0.1-52b
    (weights drawn once on the CPU): one step's loss and every gradient
    leaf on the card within TRAIN_TOL of the CPU's, launches exact."""
    cpu = torch.device("cpu")
    for arch in ("mamba2-130m", MOE_ARCH, "jamba-v0.1-52b"):
        cfg = tiny_version(get_config(arch))
        params = api.init(torch.Generator().manual_seed(24), cfg)
        batch = token_batches(cfg, TRAIN_BATCH, CARD_CPU_TRAIN_SEQ, 1, cpu,
                              seed=24)[0]
        t0 = time.perf_counter()
        cpu_loss, cpu_g = ST.loss_and_grads(params, cfg, batch)
        cpu_s = time.perf_counter() - t0
        zero_ssm_train_launches()
        loss, grads = ST.loss_and_grads(tree_to(params, dev), cfg,
                                        tree_to(batch, dev))
        launches, want = ssm_train_launches(), train_expected(cfg)
        if launches != want:
            raise AssertionError(f"train card-vs-cpu {arch}: launches "
                                 f"{SSM_TRAIN_KERNELS} {launches}, expected "
                                 f"{want}")
        rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
        if not rel <= TRAIN_TOL:
            raise AssertionError(f"train card-vs-cpu {arch}: loss "
                                 f"{float(loss)} vs {float(cpu_loss)}")
        check_gradients(grads, f"train card-vs-cpu {arch}")
        err = 0.0
        for (key, a), (_, b) in zip(flatten_with_keys(grads),
                                    flatten_with_keys(cpu_g)):
            e = float((a.cpu() - b).abs().max()) / float(b.abs().max())
            if not e <= TRAIN_TOL:
                raise AssertionError(f"train card-vs-cpu {arch}: gradient "
                                     f"of {key} differs by {e:.2e} of its "
                                     f"largest")
            err = max(err, e)
        print(f"train card-vs-cpu: {arch} tiny ({cfg.n_layers} layers, "
              f"d_model {cfg.d_model}), fp32, batch {TRAIN_BATCH} x "
              f"{CARD_CPU_TRAIN_SEQ}: loss {float(loss):.6f} (CPU "
              f"{float(cpu_loss):.6f}, rel {rel:.2e}); {len(tree_leaves(grads))}"
              f" gradient leaves within {err:.2e} of each leaf's largest, all "
              f"finite and nonzero; launches "
              f"{dict(zip(SSM_TRAIN_KERNELS, launches))}; CPU step "
              f"{cpu_s:.1f} s")


@contextlib.contextmanager
def depth_cut(arch: str, layers):
    """``train.run`` builds its config from the name: while the block runs,
    ``arch`` comes full width with ``layers`` layers (None: uncut)."""
    real = TR.get_config

    def cut(name):
        cfg = real(name)
        return cfg.with_(n_layers=layers) if name == arch and layers else cfg
    TR.get_config = cut
    try:
        yield
    finally:
        TR.get_config = real


def phase_ssm_train_full(dev) -> dict:
    """The slice's main path at full width, bf16: mamba2-130m uncut through
    ``train.run`` with checkpoints (the step-10 checkpoint stepped to 20
    bit-equal), moonshot cut to 2 layers through ``train.run`` without
    checkpoints, one jamba period through one ``loss_and_grads``; each
    with its step-1 gradient finite and nonzero in every leaf (every
    layer) and the eight kernels' launches exact."""
    totals = dict.fromkeys(SSM_TRAIN_KERNELS, 0)
    out = {}
    for arch, layers, n, ckpt in SSM_TRAIN_RUNS:
        out[arch] = train_full(arch, layers, n, ckpt, dev)
        for k, v in out[arch].pop("launches").items():
            totals[k] += v

    arch = "jamba-v0.1-52b"
    cfg = get_config(arch).with_(n_layers=JAMBA_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev)[0]
    zero_ssm_train_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = ST.loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, want = ssm_train_launches(), train_expected(cfg)
    if launches != want:
        raise AssertionError(f"train {arch}: launches {SSM_TRAIN_KERNELS} "
                             f"{launches}, expected {want}")
    if not np.isfinite(float(loss)):
        raise AssertionError(f"train {arch}: loss {float(loss)}")
    check_gradients(grads, f"train {arch}")
    for k, v in zip(SSM_TRAIN_KERNELS, launches):
        totals[k] += v
    print(f"train: {arch} full width, one period ({cfg.n_layers} layers, "
          f"{api.param_count(params):,} parameters, "
          f"{str(cfg.param_dtype)[6:]}): one "
          f"loss_and_grads at batch {TRAIN_BATCH} x {TRAIN_SEQ} in "
          f"{secs:.2f} s, loss {float(loss):.4f}, every leaf's gradient "
          f"finite and nonzero; launches "
          f"{dict(zip(SSM_TRAIN_KERNELS, launches))}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (AdamW's "
          f"fp32 master and moments, ~160 GB, fit no card)")
    del params, grads
    torch.cuda.empty_cache()
    return dict(launches=totals, **out)


# -- the VLM and enc-dec families: M-RoPE, embedding inputs, non-causal and
# -- cross attention, the fixed-length cross cache -------------------------------

VLM_ARCH, ENCDEC_ARCH = "qwen2-vl-7b", "whisper-medium"
WHISPER_FRAMES, WHISPER_PROMPT = 1500, 64   # its 30-second window; a prompt
VLM_TRAIN_LAYERS, VLM_TRAIN_STEPS = 4, 10
# whisper-medium's steps through train.run, each run twice (20 before phase
# 35 joined the call: its time)
ENCDEC_TRAIN_STEPS = 10
# (B, KV, G, Sq, Skv, D, causal, what): phase 26's timed flash shapes, bf16
NEW_FLASH = ((4, 4, 8, 512, 512, 128, True, "qwen2-vl-7b self"),
             (4, 16, 1, 1500, 1500, 64, False, "whisper-medium encoder"),
             (4, 16, 1, 64, 1500, 64, False, "whisper-medium cross, "
              "prompt 64"),
             (4, 16, 1, 512, 512, 64, False, "whisper-medium cross, 512 "
              "over 512"))
# the tiny configs' fp32 routes (D 32): qwen2-vl's G 16, whisper's cross
NEW_FLASH_FP32 = ((2, 2, 16, 16, 16, 32, True), (2, 2, 2, 16, 24, 32, False))
# (B, KV, G, S, D, length, what): the decode shapes, bf16 then the tiny fp32
NEW_DECODE = ((4, 4, 8, 544, 128, 528, "qwen2-vl-7b self cache"),
              (4, 16, 1, WHISPER_FRAMES, 64, WHISPER_FRAMES,
               "whisper-medium cross cache"))
NEW_DECODE_FP32 = ((2, 2, 16, 25, 32, 17), (2, 2, 2, 24, 32, 24))
SERVE_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
VLM_TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                     "flash_attention_bwd", "decode_attention")


def phase_vlm_encdec_kernels(dev) -> dict:
    """flash_attention forward and backward and decode_attention at the
    new routes and shapes against their plain versions, each case twice
    bit-equal: qwen2-vl-7b's causal G 8 at D 128, whisper-medium's
    non-causal encoder over 1500 frames and its cross-attention (Sq 64
    and 512 over Skv 1500 and 512), decode at G 8 / D 128 over a 544-row
    cache and over whisper's 1500-row cross cache, and the tiny configs'
    fp32 D 32; the bf16 shapes timed beside their bounds, their plain
    versions and SDPA (forward, autograd backward)."""
    gen = torch.Generator(device=dev).manual_seed(26)
    F = torch.nn.functional
    bf = torch.bfloat16
    worst = dict.fromkeys(("flash_attention", "flash_attention_bwd",
                           "decode_attention"), 0.0)
    timings = []
    flash = [(*s[:7], bf, s[7]) for s in NEW_FLASH] + \
        [(*s, torch.float32, "tiny fp32") for s in NEW_FLASH_FP32]
    for B, KV, G, Sq, Skv, D, causal, dtype, what in flash:
        q, k, v, do = flash_bwd_operands(B, KV, G, Sq, Skv, D, dtype, True,
                                         gen, dev)
        o = same_twice(lambda: (ops.flash_attention(q, k, v, causal=causal),),
                       f"flash {what}")[0]
        ef = lm_check(o, ops.flash_attention_ref(q, k, v, causal=causal),
                      dtype)
        got = same_twice(lambda: ops.flash_attention_bwd(q, k, v, o, do,
                                                         causal=causal),
                         f"flash_attention_bwd {what}")
        eb = bwd_check(got, ops.flash_attention_bwd_ref(q, k, v, o, do,
                                                        causal),
                       dtype, f"flash_attention_bwd {what}")
        worst["flash_attention"] = max(worst["flash_attention"], ef)
        worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"], eb)
        shape = (f"(B,KV,G,Sq,Skv,D)=({B},{KV},{G},{Sq},{Skv},{D}) "
                 f"{str(dtype)[6:]} {'causal' if causal else 'full'}")
        print(f"flash {what} {shape}: forward vs plain {ef:.1e}, backward "
              f"({ops_fa.bwd_route(dtype, D)}) {eb:.1e}, reruns bit-equal")
        if dtype != bf:
            continue
        H = KV * G
        qh = q.reshape(B, H, Sq, D)
        kh, vh = k.contiguous(), v.contiguous()

        def sdpa(a, b_, c):
            return F.scaled_dot_product_attention(a, b_, c, is_causal=causal,
                                                  enable_gqa=G > 1)
        t = attention_timing(
            lambda: ops.flash_attention(q, k, v, causal=causal),
            lambda: sdpa(qh, kh, vh), f"{what} {shape}",
            flash_bound(B, KV, G, Sq, Skv, D, causal, bf))
        t["plain_ms"] = cuda_ms(lambda: ops.flash_attention_ref(
            q, k, v, causal=causal), iters=10, warm=2)
        timings.append(("flash_attention", t))
        lib = backward_timing(sdpa, (qh, kh, vh), do.reshape(B, H, Sq, D))
        t = attention_timing(
            lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=causal),
            lib, f"{what} {shape}",
            flash_bwd_bound(B, KV, G, Sq, Skv, D, causal, bf))
        t["plain_ms"] = cuda_ms(lambda: ops.flash_attention_bwd_ref(
            q, k, v, o, do, causal), iters=10, warm=2)
        timings.append(("flash_attention_bwd", t))
        del q, k, v, do, o, got, qh, kh, vh, lib
    decode = [(*s[:6], bf, s[6]) for s in NEW_DECODE] + \
        [(*s, torch.float32, "tiny fp32") for s in NEW_DECODE_FP32]
    for B, KV, G, S, D, n, dtype, what in decode:
        q, kc, vc = decode_operands(B, KV, G, S, D, dtype, gen, dev)
        out = same_twice(lambda: (ops.decode_attention(q, kc, vc, n),),
                         f"decode {what}")[0]
        e = lm_check(out, ops.decode_attention_ref(q, kc, vc, n), dtype)
        worst["decode_attention"] = max(worst["decode_attention"], e)
        shape = (f"(B,KV,G,D)=({B},{KV},{G},{D}) {str(dtype)[6:]}, cache "
                 f"{S}, length {n}")
        print(f"decode {what} {shape} vs plain: {e:.1e}, rerun bit-equal "
              f"({ops_da.split_plan(B, KV, G, S, num_sms(dev.index or 0))} "
              f"splits)")
        if dtype != bf:
            continue
        qd = q.reshape(B, KV * G, 1, D)
        kd, vd = kc[:, :, :n].contiguous(), vc[:, :, :n].contiguous()
        t = attention_timing(
            lambda: ops.decode_attention(q, kc, vc, n),
            lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                   enable_gqa=G > 1),
            f"{what} {shape}", decode_bound(B, KV, G, n, D, bf))
        t["plain_ms"] = cuda_ms(lambda: ops.decode_attention_ref(q, kc, vc,
                                                                 n))
        timings.append(("decode_attention", t))
    for name, t in timings:
        report_timing(name, t)
    for k, e in worst.items():
        print(f"{k} at the VLM and enc-dec shapes vs plain: within rtol/atol "
              f"3e-5 (fp32) and 3e-2 (bf16), max abs err {e:.3e}")
    return worst


def grid_prompt(cfg, batch: int, seq: int, gen: torch.Generator) -> dict:
    """A prompt of ``seq`` patch embeddings (× 0.02) with M-RoPE positions
    over a grid, three distinct streams (temporal fixed, height and width
    8 patches wide); for the enc-dec ``seq`` frames beside ``seq // 2 + 3``
    decoder tokens."""
    emb = torch.randn((batch, seq, cfg.d_model), generator=gen) * 0.02
    if cfg.family == "encdec":
        toks = torch.randint(0, cfg.vocab, (batch, seq // 2 + 3),
                             generator=gen)
        return {"tokens": toks, "embeds": emb}
    i = torch.arange(seq)
    pos = torch.stack([torch.full_like(i, 2), i // 8, i % 8])
    return {"tokens": torch.randint(0, cfg.vocab, (batch, seq),
                                    generator=gen),
            "embeds": emb, "positions": pos[:, None].expand(3, batch, seq)}


def vlm_encdec_launches() -> tuple:
    return tuple(getattr(ops, k).launches for k in VLM_TRAIN_KERNELS)


def zero_vlm_encdec_launches() -> None:
    for k in VLM_TRAIN_KERNELS:
        getattr(ops, k).launches = 0


def serve_expected(cfg, steps: int) -> tuple:
    """``VLM_TRAIN_KERNELS`` launches of a prefill and ``steps`` decode
    steps (``expected_launches``; no backward)."""
    norms, flash, dec, _, _ = expected_launches(cfg, steps)
    return norms, 0, flash, 0, dec


def phase_vlm_encdec_card_vs_cpu(dev) -> None:
    """Tiny fp32 qwen2-vl-7b (M-RoPE over distinct streams, 4 heads padded
    to 32) and whisper-medium (24 frames, a 15-token decoder prompt), the
    same weights (drawn once on the CPU) and prompt: a prefill and 8
    greedy decode steps on the card within SERVE_TOL of the CPU's (TF32
    off), tokens equal; one ``loss_and_grads`` within TRAIN_TOL, leaf by
    leaf; the five kernels' launches exact."""
    cpu = torch.device("cpu")
    steps = 8
    for arch in (VLM_ARCH, ENCDEC_ARCH):
        cfg = tiny_version(get_config(arch))
        params = api.init(torch.Generator().manual_seed(27), cfg)
        prompt = grid_prompt(cfg, LM_BATCH, 24,
                             torch.Generator().manual_seed(28))
        t0 = time.perf_counter()
        ref = greedy_decode(params, cfg, prompt["tokens"], steps + 1,
                            embeds=prompt["embeds"],
                            positions=prompt.get("positions"),
                            keep_logits=True)
        gparams, gprompt = tree_to(params, dev), tree_to(prompt, dev)
        zero_vlm_encdec_launches()
        card = greedy_decode(gparams, cfg, gprompt["tokens"], steps + 1,
                             embeds=gprompt["embeds"],
                             positions=gprompt.get("positions"),
                             keep_logits=True)
        launches, want = vlm_encdec_launches(), serve_expected(cfg, steps)
        if launches != want:
            raise AssertionError(f"vlm/encdec card-vs-cpu {arch}: launches "
                                 f"{VLM_TRAIN_KERNELS} {launches}, expected "
                                 f"{want}")
        if not np.array_equal(card.tokens, ref.tokens):
            raise AssertionError(f"vlm/encdec card-vs-cpu {arch}: tokens "
                                 f"differ:\n{card.tokens}\n{ref.tokens}")
        err = max(max_err(a.cpu(), b, **SERVE_TOL)
                  for a, b in zip(card.logits, ref.logits))
        labels = torch.randint(0, cfg.vocab, prompt["tokens"].shape,
                               generator=torch.Generator().manual_seed(29))
        batch = {**prompt, "labels": labels}
        cpu_loss, cpu_g = ST.loss_and_grads(params, cfg, batch)
        cpu_s = time.perf_counter() - t0
        zero_vlm_encdec_launches()
        loss, grads = ST.loss_and_grads(gparams, cfg, tree_to(batch, dev))
        tl, tw = vlm_encdec_launches(), train_expected(cfg)[:4] + (0,)
        if tl != tw:
            raise AssertionError(f"vlm/encdec card-vs-cpu {arch}: train "
                                 f"launches {VLM_TRAIN_KERNELS} {tl}, "
                                 f"expected {tw}")
        rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
        if not rel <= TRAIN_TOL:
            raise AssertionError(f"vlm/encdec card-vs-cpu {arch}: loss "
                                 f"{float(loss)} vs {float(cpu_loss)}")
        check_gradients(grads, f"vlm/encdec card-vs-cpu {arch}",
                        unused_leaves(cfg))
        gerr = 0.0
        for (key, a), (_, b) in zip(flatten_with_keys(grads),
                                    flatten_with_keys(cpu_g)):
            scale = float(b.abs().max())
            e = float((a.cpu() - b).abs().max()) / scale if scale else \
                float(a.abs().max())
            if not e <= TRAIN_TOL:
                raise AssertionError(f"vlm/encdec card-vs-cpu {arch}: "
                                     f"gradient of {key} differs by {e:.2e} "
                                     f"of its largest")
            gerr = max(gerr, e)
        print(f"vlm/encdec card-vs-cpu: {arch} tiny ({cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, {cfg.heads_padded} query heads over "
              f"{cfg.n_kv_heads}), fp32, batch {LM_BATCH}, a prompt of "
              f"{prompt['embeds'].shape[1]} embeddings and "
              f"{prompt['tokens'].shape[1]} tokens: prefill and {steps} "
              f"decode steps' logits within {err:.3e} of the CPU's, tokens "
              f"equal; launches {dict(zip(VLM_TRAIN_KERNELS, launches))}; "
              f"loss_and_grads loss {float(loss):.6f} (CPU "
              f"{float(cpu_loss):.6f}, rel {rel:.2e}), "
              f"{len(tree_leaves(grads))} gradient leaves within {gerr:.2e} "
              f"of each leaf's largest; launches "
              f"{dict(zip(VLM_TRAIN_KERNELS, tl))}; CPU {cpu_s:.1f} s")


def serve_full(arch: str, dev, prompt_len: int, frames=None) -> dict:
    """``generate(arch, tiny=False)`` at batch 4 and 32 tokens, launches
    exact and logits finite; then, on its weights and prompt, a warm
    second run and a profile of one prefill and of 8 decode steps.
    Returns the launches and the profiles."""
    cfg = get_config(arch)
    B, n = LM_BATCH, LM_GEN
    torch.cuda.reset_peak_memory_stats(dev)
    zero_vlm_encdec_launches()                  # the main path's window
    res = generate(arch, tiny=False, prompt_len=prompt_len, gen=n, batch=B,
                   seed=0, verbose=False, device=dev, keep_logits=True,
                   frames=frames)
    launches, want = vlm_encdec_launches(), serve_expected(cfg, n - 1)
    if launches != want:
        raise AssertionError(f"serve {arch}: launches {VLM_TRAIN_KERNELS} "
                             f"{launches}, expected {want}")
    if res.tokens.shape != (B, n) or not all(
            bool(torch.isfinite(x).all()) and x.shape == (B, cfg.vocab)
            for x in res.logits):
        raise AssertionError(f"serve {arch}: tokens or logits malformed")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    g = torch.Generator(device=dev).manual_seed(0)    # generate's draws
    params = api.init(g, cfg)
    prompt = random_prompt(cfg, B, prompt_len, g, frames=frames)
    enc = (f"{prompt['embeds'].shape[1]} encoder frames and a "
           f"{prompt_len}-token decoder prompt" if cfg.family == "encdec"
           else f"a {prompt_len}-patch embedding prompt, M-RoPE")
    print(f"serve: {arch} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.heads_padded} query heads over "
          f"{cfg.n_kv_heads}, vocab {cfg.vocab}), "
          f"{str(cfg.compute_dtype)[6:]}, {api.param_count(params):,} "
          f"parameters, batch {B}, {enc}, {n} tokens: prefill "
          f"{res.prefill_ms:.3f} ms, decode {res.decode_ms_per_token:.3f} "
          f"ms/token; launches {dict(zip(SERVE_KERNELS, launches[::2]))}; "
          f"all logits finite; peak device memory {peak:.2f} GiB")
    warm = greedy_decode(params, cfg, prompt["tokens"], n,
                         embeds=prompt.get("embeds"),
                         positions=prompt.get("positions"))
    print(f"serve {arch} (warm, same weights and prompt): prefill "
          f"{warm.prefill_ms:.3f} ms, decode {warm.decode_ms_per_token:.3f} "
          f"ms/token; tokens equal to the first run's: "
          f"{np.array_equal(warm.tokens, res.tokens)}")
    del res, warm
    toks = prompt.pop("tokens")
    prefill, decode = profile_serving(params, cfg, toks, f"{arch} ", prompt)
    del params
    torch.cuda.empty_cache()
    return dict(launches=dict(zip(VLM_TRAIN_KERNELS, launches)),
                prefill=prefill, decode=decode)


def vlm_grads_full(dev) -> dict:
    """One ``loss_and_grads`` of the uncut qwen2-vl-7b on a batch of 4 x
    512 patch embeddings: the loss finite, every layer's gradient finite
    and nonzero (the token embedding's zero), launches exact, peak
    memory."""
    cfg = get_config(VLM_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev)[0]
    zero_vlm_encdec_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = ST.loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, want = vlm_encdec_launches(), train_expected(cfg)[:4] + (0,)
    if launches != want:
        raise AssertionError(f"train {VLM_ARCH}: launches "
                             f"{VLM_TRAIN_KERNELS} {launches}, expected "
                             f"{want}")
    if not np.isfinite(float(loss)):
        raise AssertionError(f"train {VLM_ARCH}: loss {float(loss)}")
    check_gradients(grads, f"train {VLM_ARCH}", unused_leaves(cfg))
    pad = float(grads["layers"]["attn"]["wo"][:, cfg.n_heads:].abs().max())
    print(f"train: {VLM_ARCH} full width, uncut ({cfg.n_layers} layers, "
          f"{api.param_count(params):,} parameters, "
          f"{str(cfg.param_dtype)[6:]}): one loss_and_grads at batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} patch embeddings in {secs:.2f} s, "
          f"loss {float(loss):.4f}, every layer's gradient finite and "
          f"nonzero (the token embedding's zero; the padded heads' wo "
          f"slices up to {pad:.3e}); launches "
          f"{dict(zip(VLM_TRAIN_KERNELS, launches))}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del params, grads
    torch.cuda.empty_cache()
    return dict(zip(VLM_TRAIN_KERNELS, launches))


def phase_vlm_encdec_full(dev) -> dict:
    """The slice's main paths at full width, bf16: qwen2-vl-7b uncut
    served (batch 4, a 512-patch prompt, 32 tokens) and through one
    ``loss_and_grads``, then cut to 4 layers through ``train.run`` (10
    steps, no checkpoints); whisper-medium uncut served (batch 4, 1500
    encoder frames, a 64-token prompt, 32 tokens) and through
    ``train.run`` (ENCDEC_TRAIN_STEPS steps, no checkpoints, rerun
    bit-equal); launches
    exact throughout, profiles of prefill, decode and a train step."""
    totals = dict.fromkeys(VLM_TRAIN_KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            totals[k] += v
    out = {VLM_ARCH: serve_full(VLM_ARCH, dev, LM_PROMPT)}
    add(out[VLM_ARCH].pop("launches"))
    add(vlm_grads_full(dev))
    out[f"{VLM_ARCH} train"] = train_full(VLM_ARCH, VLM_TRAIN_LAYERS,
                                          VLM_TRAIN_STEPS, None, dev)
    out[ENCDEC_ARCH] = serve_full(ENCDEC_ARCH, dev, WHISPER_PROMPT,
                                  frames=WHISPER_FRAMES)
    add(out[ENCDEC_ARCH].pop("launches"))
    out[f"{ENCDEC_ARCH} train"] = train_full(ENCDEC_ARCH, None,
                                             ENCDEC_TRAIN_STEPS, None, dev,
                                             rerun=True)
    for key in (f"{VLM_ARCH} train", f"{ENCDEC_ARCH} train"):
        add({k: v for k, v in out[key].pop("launches").items()
             if k in totals})
    return dict(launches=totals, **out)


# -- the multi-device tooling: a mesh step on one card, the roofline ------------

MESH_STEPS = 2                   # mesh train steps before the checkpoint
MESH_SERVE = 8                   # mesh serve steps after the prefill
MESH_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                "flash_attention_bwd", "decode_attention")
SHARE_LIMIT = 1.05               # bound / measured above this: a wrong count
# (arch, dry-run shape, kind, depth cut or None): the cells timed by
# phases 12, 15, 21 and 25
ROOF_CELLS = (("llama3.2-1b", "train_4k", "train", TRAIN_LAYERS),
              ("llama3.2-1b", "prefill_32k", "prefill", None),
              ("mamba2-130m", "train_4k", "train", None),
              ("mamba2-130m", "prefill_32k", "prefill", None))


def same_tree(a, b, label: str) -> None:
    """Every leaf of ``a`` (DTensors read locally) bit-equal to ``b``'s."""
    for (key, x), (_, y) in zip(flatten_with_keys(a), flatten_with_keys(b)):
        x = x.to_local() if hasattr(x, "to_local") else x
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: {key} differs")


def phase_mesh(dev, measured: dict) -> dict:
    """29: llama3.2-1b at full width on a one-process NCCL (1, 1) mesh:
    ``mesh_step`` train steps (ZeRO-1 on) bit-equal to ``make_train_step``
    steps, a mesh prefill and serve steps bit-equal to ``greedy_decode``,
    the mesh state snapshotted as a checkpoint saves it and restored from
    that snapshot onto the mesh with placements
    and stepped bit-equal to the off-mesh third step; then the dry run's
    one-chip roofline of the cells that phases 12, 15, 21 and 25 time,
    each bound beside the measured step, whose share must stay under
    ``SHARE_LIMIT``."""
    import torch.distributed as dist
    MESH.init_group(dev)
    mesh = MESH.make_mesh((1, 1), ("data", "model"), device=dev)
    cfg = get_config(LM_ARCH).with_(n_layers=TRAIN_LAYERS)
    opt = adamw.AdamWConfig(lr=3e-4, total_steps=100, warmup_steps=1)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    batches = token_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, MESH_STEPS + 1, dev,
                            seed=29)

    def fresh():
        params = api.init(torch.Generator(device=dev).manual_seed(29), cfg)
        return ST.TrainState(params, adamw.init(opt, params))

    ref, rstep = fresh(), ST.make_train_step(cfg, opt)
    ref_losses = []
    for b in batches[:MESH_STEPS]:
        ref, m = rstep(ref, b)
        ref_losses.append(float(m["loss"]))
    toks = batches[0]["tokens"]
    B, P = toks.shape
    want = greedy_decode(ref.params, cfg, toks, MESH_SERVE + 1,
                         keep_logits=True)
    plan = ST.mesh_plan(cfg, mesh)
    state = ST.mesh_state(fresh(), plan)
    step = ST.mesh_step(cfg, shape, mesh, opt)
    for k in MESH_KERNELS:
        getattr(ops, k).launches = 0
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[:MESH_STEPS]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    step_ms = (time.perf_counter() - t0) * 1e3 / MESH_STEPS
    if losses != ref_losses:
        raise AssertionError(f"mesh: losses {losses} vs {ref_losses}")
    same_tree(state.params, ref.params, "mesh train params")
    same_tree(state.opt.master, ref.opt.master, "mesh train master")

    # serve on the trained weights: prefill and greedy steps on the mesh
    prefill = ST.mesh_step(cfg, ShapeConfig("p", P, B, "prefill"), mesh)
    serve = ST.mesh_step(cfg, ShapeConfig("d", P + MESH_SERVE, B, "decode"),
                         mesh)
    logits, pcache = prefill(state.params, {"tokens": toks})
    cache = ST.mesh_cache(api.init_cache(cfg, B, P + MESH_SERVE, device=dev),
                          mesh)
    for name, c in cache.items():
        splice(c.to_local(), pcache[name].to_local())
    got = [logits.to_local()[:, -1]]
    cur = got[0][:, None].argmax(-1)
    tokens = [cur]
    for t in range(MESH_SERVE):
        logits, cache = serve(state.params, cache, {"tokens": cur}, P + t)
        got.append(logits.to_local()[:, -1])
        cur = got[-1][:, None].argmax(-1)
        tokens.append(cur)
    if not (np.array_equal(torch.cat(tokens, 1).cpu().numpy(), want.tokens)
            and all(torch.equal(a, b) for a, b in zip(got, want.logits))):
        raise AssertionError("mesh: prefill/serve differ from greedy_decode")
    launches = {k: getattr(ops, k).launches for k in MESH_KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"mesh: a kernel did not launch: {launches}")
    print(f"mesh: {LM_ARCH} full width on a (1, 1) NCCL mesh, "
          f"{str(cfg.param_dtype)[6:]} over fp32 master, batch {B} x {P}: "
          f"{MESH_STEPS} mesh_step train steps (ZeRO-1) bit-equal to "
          f"make_train_step's (losses {losses}, every param and master "
          f"leaf), {step_ms:.3f} ms a step; a mesh prefill and "
          f"{MESH_SERVE} serve steps bit-equal to greedy_decode (tokens and "
          f"logits); launches {launches}")

    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(ref.params) + tree_leaves(
                     ref.opt.master) * 3)
    t0 = time.perf_counter()
    host = snapshot(state)
    save_s = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state = from_snapshot(host, ref, ST.state_shardings(cfg, opt, mesh))
    restore_s = time.perf_counter() - t0
    del host
    ref, rm = rstep(ref, batches[MESH_STEPS])
    state, m = step(state, batches[MESH_STEPS])
    if float(m["loss"]) != float(rm["loss"]):
        raise AssertionError("mesh: the restored third step's loss differs")
    same_tree(state.params, ref.params, "mesh restored step params")
    same_tree(state.opt.m, ref.opt.m, "mesh restored step m")
    print(f"mesh: the mesh state ({nbytes / 1e9:.2f} GB) snapshotted to host "
          f"as a checkpoint saves it in {save_s:.1f} s (no file: phase 21 "
          f"writes and reads the format at this width), restored from it "
          f"onto the mesh with placements in "
          f"{restore_s:.1f} s, its third step bit-equal to the off-mesh "
          f"third step (loss {float(m['loss']):.6f}, every param and m "
          f"leaf)")
    del state, ref, want, cache, pcache, logits
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rows = []
    for arch, name, kind, layers in ROOF_CELLS:
        cut = ShapeConfig(name, TRAIN_SEQ, TRAIN_BATCH, kind)
        rec = DR.run_cell(arch, name, False, mesh=(1, 1), shape=cut,
                          verbose=False, layers=layers)
        roof = rec["roofline"]
        bound = rec["bound_s"] * 1e3
        wall, busy = measured[(arch, kind)]
        share = bound / wall
        depth = "" if layers is None else f", {layers} layers"
        print(f"roofline: {arch} {kind} at {TRAIN_BATCH} x {TRAIN_SEQ}{depth} (the "
              f"{name} cell cut to the measured batch and length) on "
              f"{H100_SXM.name} ({smi}): {roof['flops']:.4e} FLOPs, "
              f"{roof['bytes']:.4e} bytes, bound {bound:.3f} ms "
              f"({roof['dominant']}: compute {roof['compute_s'] * 1e3:.3f} "
              f"ms, memory {roof['memory_s'] * 1e3:.3f} ms); measured "
              f"{wall:.3f} ms wall"
              + (f", {busy:.3f} ms device busy (share {bound / busy:.3f})"
                 if busy else "")
              + f": share of the bound {share:.3f}")
        if not share <= SHARE_LIMIT:
            raise AssertionError(f"roofline {arch} {kind}: bound {bound:.3f}"
                                 f" ms over {wall:.3f} ms measured")
        rows.append(dict(arch=arch, kind=kind, bound_ms=bound, wall_ms=wall,
                         busy_ms=busy, share=share))
    return dict(launches=launches, roofline=rows)


# -- tensor-parallel serving on a model axis: two ranks sharing the card ------

# (arch, depth cut or None, dtype): full-width llama3.2-1b cut to 2 layers
# in fp32 holds the split's arithmetic to SERVE_TOL on the card; then the
# bf16 models, llama3.2-1b and granite-20b (~55 GB whole) cut to 4 layers
# (16 and 8 before: the call's time limit)
TP_SERVE = (("llama3.2-1b", 2, torch.float32),
            ("llama3.2-1b", 4, torch.bfloat16),
            ("granite-20b", 4, torch.bfloat16))
# in bf16 each rank rounds its share of a row-parallel product before the
# sum, where one process rounds the whole product once: the logits are
# held to the LM bf16 bound, 3e-2, of each row's largest |logit| (phase
# 12's relative form; elementwise they differ as two bf16 runs do)
TP_ROW_TOL = LM_KERNEL_TOL[torch.bfloat16]["rtol"]
TP_MESH = (1, 2)                 # (data, model)
TP_GEN = 33                      # the prompt's token, then 32 decode steps
TP_SEED = 30
TP_TIMEOUT = 600.0               # the ranks' seconds, their start included
TP_COLLECTIVES = ("all_reduce", "all_gather")
# (B, KV, G, Sq, Skv, D, causal, what): the ranks' prefill attention at
# model 2
TP_FLASH = ((4, 4, 4, 512, 512, 64, True, "llama3.2-1b rank: 4 of 8 kv "
             "heads"),
            (4, 1, 24, 512, 512, 128, True, "granite-20b rank: 24 of 48 "
             "heads"),
            (4, 8, 1, 512, 512, 128, True, "moonshot-v1-16b-a3b rank: 8 of "
             "16 kv heads"))
# (B, KV, G, S, D, lengths, what): the ranks' decode attention at model 2,
# the first length timed (the middle of the run's fills)
TP_DECODE = ((4, 4, 4, 544, 64, (528, 513, 1, 0),
              "llama3.2-1b rank: 4 of 8 kv heads, whole cache"),
             (4, 1, 48, 272, 128, (256, 272, 241, 1, 0),
              "granite-20b rank: all 48 heads over a block of 272"),
             (4, 8, 1, 544, 128, (528, 513, 1, 0),
              "moonshot-v1-16b-a3b rank: 8 of 16 kv heads, whole cache"))
# the kernels a tensor-parallel rank launches (topk_gating: the MoE's
# router, replicated on every rank; ssd_scan: an SSM prefill's scan)
TP_KERNELS = SERVE_KERNELS + ("ssd_scan", "topk_gating")
# (arch, depth cut, dtype) of phase 31 on the (1, 2) mesh: moonshot's 64
# experts split 32 a rank; bf16 at 2 of 48 layers (4 before phase 35
# joined the call: its time)
MOE_TP_SERVE = ((MOE_ARCH, 2, torch.float32),
                (MOE_ARCH, 2, torch.bfloat16))
MOE_TP_SMALL_MESH = (2, 2)       # (data, model): tiny moonshot's 3 experts
MOE_TP_SMALL_EXPERTS = 3         # divide no model axis: ff-sharded


def tp_config(arch: str, layers, dtype):
    """``arch`` at full width in ``dtype``, cut to ``layers`` (an enc-dec's
    encoder and decoder each) where given."""
    cfg = get_config(arch).with_(param_dtype=dtype, compute_dtype=dtype)
    if layers is None:
        return cfg
    if cfg.family == "encdec":
        return cfg.with_(n_enc_layers=layers, n_dec_layers=layers)
    return cfg.with_(n_layers=layers)


def tp_prompt(cfg, dev) -> dict:
    """A tensor-parallel run's prompt, drawn from TP_SEED + 1 on ``dev``
    (``random_prompt``): LM_BATCH x LM_PROMPT tokens; a VLM's patch
    embeddings beside them, with M-RoPE streams that differ (temporal 2,
    height and width over a grid 32 patches wide); an enc-dec's
    WHISPER_FRAMES encoder frames beside a WHISPER_PROMPT-token decoder
    prompt (phase 28's)."""
    g = torch.Generator(device=dev).manual_seed(TP_SEED + 1)
    if cfg.family == "encdec":
        return random_prompt(cfg, LM_BATCH, WHISPER_PROMPT, g,
                             frames=WHISPER_FRAMES)
    prompt = random_prompt(cfg, LM_BATCH, LM_PROMPT, g)
    if cfg.pos == "mrope":
        i = torch.arange(LM_PROMPT, dtype=torch.int32, device=dev)
        prompt["positions"] = torch.stack(
            [torch.full_like(i, 2), i // 32, i % 32])[:, None].expand(
                3, LM_BATCH, LM_PROMPT)
    return prompt


def tp_prompt_of(cfg) -> str:
    """What :func:`tp_prompt` gives ``cfg``, in words."""
    if cfg.family == "encdec":
        return (f"{WHISPER_FRAMES} frames and a {WHISPER_PROMPT}-token "
                f"decoder prompt x batch {LM_BATCH}")
    what = "patch embeddings, M-RoPE streams that differ" \
        if cfg.pos == "mrope" else "tokens"
    return f"prompt {LM_PROMPT} x batch {LM_BATCH} ({what})"


def prompt_host(prompt: dict) -> dict:
    """A prompt as numpy arrays for the rank processes (floats in fp32,
    which holds bf16 exactly)."""
    return {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
            for k, v in prompt.items()}


def prompt_on(prompt: dict, cfg, dev) -> dict:
    """:func:`prompt_host`'s arrays back on ``dev``, floats in the config's
    ``compute_dtype``."""
    out = {}
    for k, a in prompt.items():
        t = torch.from_numpy(a).to(dev)
        out[k] = t.to(cfg.compute_dtype) if t.is_floating_point() else t
    return out


def tp_serve(params, cfg, prompt: dict, gen: int = None, **kw):
    """``greedy_decode`` of ``gen`` tokens (TP_GEN by default) on
    ``prompt`` (its tokens, and embeddings and positions where it has
    them)."""
    return greedy_decode(params, cfg, prompt["tokens"], gen or TP_GEN,
                         embeds=prompt.get("embeds"),
                         positions=prompt.get("positions"), **kw)


def tp_check(logits: torch.Tensor, ref: torch.Tensor, dtype, label: str
             ) -> tuple:
    """(max abs err, largest |diff| over its row's largest |logit|) of the
    ranks' logits against the one-process run's: fp32 within SERVE_TOL
    elementwise, bf16 within TP_ROW_TOL of each row's largest |logit|."""
    if dtype == torch.float32:
        err = max_err(logits, ref, **SERVE_TOL)
    elif not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: non-finite logits")
    else:
        err = float((logits - ref).abs().max())
    rel = row_rel(logits, ref)
    if dtype != torch.float32 and not rel <= TP_ROW_TOL:
        raise AssertionError(f"{label}: logits differ by {rel:.3e} of their "
                             f"row's largest |logit| (bound {TP_ROW_TOL})")
    return err, rel


def tp_expected(cfg, ssm=None) -> dict:
    """A rank's launches of one prefill and TP_GEN - 1 decode steps: each
    rank runs every layer on its blocks and routes all of its rows, so it
    launches what one process does (``expected_launches``), less one
    rmsnorm per mamba layer per call where its mixer is split (``ssm``,
    the rank's ``TP.SSM``: its gated norm runs in plain ops around the
    all-reduce of its sums of squares)."""
    norms, flash, decode, scan, gating = expected_launches(cfg, TP_GEN - 1)
    if ssm is not None and ssm.split:
        norms -= scan * TP_GEN
    return {"rmsnorm": norms, "flash_attention": flash,
            "decode_attention": decode, "ssd_scan": scan,
            "topk_gating": gating}


def tp_weights(cfg, dev) -> tuple:
    """Phase 30's bf16 weights, drawn from TP_SEED on the card (every
    process on the card draws the same), and a checksum of them."""
    params = api.init(torch.Generator(device=dev).manual_seed(TP_SEED), cfg)
    return params, sum(float(t.sum(dtype=torch.float32))
                       for t in tree_leaves(params))


@contextlib.contextmanager
def timed_collectives(spent: list):
    """Each ``parallel.tensor`` collective timed between two
    synchronisations of the card (its seconds appended to ``spent``)."""
    orig = {k: getattr(TP, k) for k in TP_COLLECTIVES}

    def timed(fn):
        def call(t, *args, **kw):
            sync(t.device)
            t0 = time.perf_counter()
            out = fn(t, *args, **kw)
            sync(t.device)
            spent.append(time.perf_counter() - t0)
            return out
        return call
    for k, fn in orig.items():
        setattr(TP, k, timed(fn))
    try:
        yield
    finally:
        for k, fn in orig.items():
            setattr(TP, k, fn)


def tp_blocks(mesh, dev, cfg, in_turn: bool) -> tuple:
    """This rank's blocks of the TP_SEED weights (``shard_params``, the
    decode layout) and the whole's checksum. Each rank draws the whole and
    cuts it; ``in_turn``, one rank at a time behind a barrier (each frees
    the whole before the next draws): a model whose whole and blocks on
    every rank at once would not fit the card they share."""
    import torch.distributed as dist

    def draw():
        whole, check = tp_weights(cfg, dev)
        params = TP.shard_params(whole, cfg, mesh, "decode")
        del whole
        torch.cuda.empty_cache()
        return params, check
    if not in_turn:
        return draw()
    out = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            out = draw()
        dist.barrier()
    return out


def tp_rank_run(mesh, dev, cfg, prompt: dict,
                forced: np.ndarray, in_turn: bool) -> dict:
    """One model on this rank: the whole weights drawn and cut to its
    blocks (:func:`tp_blocks`), then one teacher-forced ``greedy_decode``
    run on the mesh, counted (launches, tokens, this rank's batch rows and
    vocabulary columns of the logits, an MoE's routes) and timed, its
    collectives timed between synchronisations (its prefill and decode
    times include them and an MoE's route recording; a spawn's first run
    its warm-up: one run, where two were, keeps the call in its time)."""
    gen = forced.shape[1]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params, check = tp_blocks(mesh, dev, cfg, in_turn)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    prompt = prompt_on(prompt, cfg, dev)
    teach = torch.from_numpy(forced).to(dev)
    for k in TP_KERNELS:
        getattr(ops, k).launches = 0
    gates: list = []
    spent: list = []
    with recording_routes(gates) as routes, timed_collectives(spent):
        sync(dev)
        t0 = time.perf_counter()
        res = tp_serve(params, cfg, prompt, gen, keep_logits=True, mesh=mesh,
                       forced=teach)
        sync(dev)
        wall = time.perf_counter() - t0
    launches = {k: getattr(ops, k).launches for k in TP_KERNELS}
    logits = torch.stack(res.logits).float().cpu().numpy()
    out = dict(tokens=res.tokens, logits=logits, launches=launches,
               vocab_split=logits.shape[-1] != cfg.vocab,
               ssm=TP.ssm_of(cfg, mesh),
               routes=[r.numpy() for r in routes],
               gates=[w.numpy() for w in gates],
               checksum=check, bytes=nbytes, prefill_ms=res.prefill_ms,
               decode_ms=res.decode_ms_per_token,
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else 0.0),
               collectives=len(spent), collective_ms=sum(spent) * 1e3,
               timed_ms=wall * 1e3)
    del params
    torch.cuda.empty_cache()
    return out


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tp_rank(rank: int, world: int, store: str, device: str, runs: list,
            out) -> None:
    """The rank process of phases 30–35: joins the group on ``device``
    (gloo: the ranks share the one card) and runs each run on a mesh of
    its (data, model) shape, each shape's mesh built once: a serving run
    (config, prompt, forced tokens and whether the ranks draw in turn) or
    a train run of phase 34 or 35 (config, batches, checksum), which streams leaves
    to the parent through ``out``, the rank's end of its pipe, as the
    results go at the end. A failure raises here and ends the process with
    a non-zero exit code, which fails the phase."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False    # as phase_device sets them
    dev = MESH.join_group(store, rank, world, device)
    meshes, done = {}, []
    for k, (shape, train, run) in enumerate(runs):
        if shape not in meshes:
            meshes[shape] = MESH.make_mesh(shape, ("data", "model"),
                                           device=dev)
        done.append(tp_train_rank_run(meshes[shape], dev, out, k, *run)
                    if train else tp_rank_run(meshes[shape], dev, *run))
    out.send(("done", dist.get_backend(), done))
    dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, on_leaf=None) -> list:
    """``fn(rank, world, store, *args, conn)`` in ``world`` spawned
    processes (a ``FileStore`` in a temporary directory), ``conn`` the
    sending end of the rank's own pipe; their results by rank (what each
    sends as ``("done", *payload)``). A streamed leaf (``send_leaf``) is
    handed to ``on_leaf(rank, run, key, tensor)`` as it arrives, so that
    the parent holds one at a time. A rank that exits with an error (its
    pipe closes first), or ranks still running after TP_TIMEOUT, fail the
    phase; every process is joined or killed."""
    from multiprocessing.connection import wait
    ctx = multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
    for r, _ in pipes:                 # 1 MiB a pipe (Linux; 64 KiB else)
        with contextlib.suppress(OSError, AttributeError):
            fcntl.fcntl(r.fileno(), getattr(fcntl, "F_SETPIPE_SZ", 1031),
                        1 << 20)
    box: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=fn, args=(r, world, store, *args,
                                              pipes[r][1]))
                 for r in range(world)]
        for p in procs:
            p.start()
        for _, w in pipes:
            w.close()
        readers = {pipes[r][0]: r for r in range(world)}
        deadline = time.monotonic() + TP_TIMEOUT
        got = {}
        try:
            while len(got) < world:
                if time.monotonic() > deadline:
                    raise AssertionError(f"ranks did not finish within "
                                         f"{TP_TIMEOUT} s")
                for conn in wait(list(readers), timeout=1.0):
                    rank = readers[conn]
                    try:
                        msg = conn.recv()
                    except EOFError:
                        raise AssertionError(
                            f"rank {rank} ended without its results: exit "
                            f"codes {[p.exitcode for p in procs]}") from None
                    if msg[0] == "done":
                        got[rank] = list(msg[1:])
                        del readers[conn]
                        continue
                    _, k, key, dtype, shape, n = msg
                    dtype = getattr(torch, dtype.split(".")[1])
                    on_leaf(rank, k, key, recv_raw(conn, n, box).view(
                        dtype).view(shape))
        finally:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"a rank failed: exit codes {codes}")
    return [got[r] for r in range(world)]


def tp_kernels(dev, flash=TP_FLASH, decode=TP_DECODE, seed=TP_SEED
               ) -> dict:
    """flash_attention and decode_attention at the ranks' shapes (``flash``,
    ``decode``; by default phases 30-31's: the bf16 flash at G 24 over
    one kv head, D 128, and decode at G 48 / D 128 over a block of
    positions, with its log-sum-exp, that no earlier phase launched, and
    llama3.2-1b's and moonshot's rank shapes), against their plain
    versions, each twice bit-equal; decode's lse within 1e-4 of the plain
    version's, o = 0 and lse = −inf at length 0, o without the lse the same
    bits as with it; the first length of each timed beside its bound, the
    plain version and SDPA."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    F = torch.nn.functional
    bf = torch.bfloat16
    worst = dict(flash_attention=0.0, decode_attention=0.0)
    timings = []
    for B, KV, G, Sq, Skv, D, causal, what in flash:
        q, k, v = flash_operands(B, KV, G, Sq, D, bf, True, gen, dev, Skv)
        o = same_twice(lambda: (ops.flash_attention(q, k, v, causal=causal),),
                       f"flash {what}")[0]
        e = lm_check(o, ops.flash_attention_ref(q, k, v, causal=causal), bf)
        worst["flash_attention"] = max(worst["flash_attention"], e)
        shape = (f"(B,KV,G,S,D)=({B},{KV},{G},{Sq},{D}) bf16 causal"
                 if causal and Sq == Skv else
                 f"(B,KV,G,Sq,Skv,D)=({B},{KV},{G},{Sq},{Skv},{D}) bf16 "
                 f"{'causal' if causal else 'full'}")
        print(f"flash {what} {shape} vs plain: {e:.1e}, rerun bit-equal")
        qh = q.reshape(B, KV * G, Sq, D)
        kh, vh = k.contiguous(), v.contiguous()
        t = attention_timing(
            lambda: ops.flash_attention(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal, enable_gqa=G > 1),
            f"{what} {shape}", flash_bound(B, KV, G, Sq, Skv, D, causal, bf))
        t["plain_ms"] = cuda_ms(lambda: ops.flash_attention_ref(
            q, k, v, causal=causal), iters=10, warm=2)
        timings.append(("flash_attention", t))
    for B, KV, G, S, D, lengths, what in decode:
        q, kc, vc = decode_operands(B, KV, G, S, D, bf, gen, dev)
        for n in lengths:
            o, lse = same_twice(lambda: ops.decode_attention(
                q, kc, vc, n, return_lse=True), f"decode {what} at {n}")
            ro, rlse = ops.decode_attention_ref(q, kc, vc, n,
                                                return_lse=True)
            if not torch.equal(ops.decode_attention(q, kc, vc, n), o):
                raise AssertionError(f"decode {what} at {n}: o without the "
                                     f"lse differs from o with it")
            if n == 0:
                if o.any() or not torch.isneginf(lse).all():
                    raise AssertionError(f"decode {what}: length 0 gave o "
                                         f"!= 0 or a finite lse")
                print(f"decode {what} at length 0: o = 0, lse = -inf")
                continue
            e = lm_check(o, ro, bf)
            el = max_err(lse, rlse, rtol=1e-5, atol=1e-4)
            worst["decode_attention"] = max(worst["decode_attention"], e)
            print(f"decode {what} (B,KV,G,D)=({B},{KV},{G},{D}) bf16, cache "
                  f"{S}, length {n} vs plain: o {e:.1e}, lse {el:.1e}, "
                  f"reruns bit-equal, o without the lse bit-equal")
        n = lengths[0]
        qd = q.reshape(B, KV * G, 1, D)
        kd, vd = kc[:, :, :n].contiguous(), vc[:, :, :n].contiguous()
        lse_on = KV == 1
        t = attention_timing(
            lambda: ops.decode_attention(q, kc, vc, n, return_lse=lse_on),
            lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                   enable_gqa=G > 1),
            f"{what}, length {n}{', with lse' if lse_on else ''}",
            decode_bound(B, KV, G, n, D, bf, lse=lse_on))
        t["plain_ms"] = cuda_ms(lambda: ops.decode_attention_ref(
            q, kc, vc, n, return_lse=lse_on))
        timings.append(("decode_attention", t))
    for name, t in timings:
        report_timing(name, t)
    return worst


def tp_reference(cfg, dev) -> tuple:
    """The one-process run on the card that the ranks are held to: the
    weights drawn from TP_SEED, the prompt (:func:`tp_prompt`), TP_GEN
    greedy tokens with their logits, an MoE's routes and the run's times
    (its route recording included). Returns (that record, the ranks' run:
    config, prompt (:func:`prompt_host`), forced tokens)."""
    params, check = tp_weights(cfg, dev)
    prompt = tp_prompt(cfg, dev)
    with recording_routes() as routes:
        ref = tp_serve(params, cfg, prompt, keep_logits=True)
    out = dict(logits=torch.stack(ref.logits).float().cpu(),
               tokens=ref.tokens, checksum=check,
               routes=[r.numpy() for r in routes],
               bytes=sum(t.numel() * t.element_size()
                         for t in tree_leaves(params)),
               prefill_ms=ref.prefill_ms, decode_ms=ref.decode_ms_per_token)
    run = (cfg, prompt_host(prompt), ref.tokens)
    del params, ref, prompt
    torch.cuda.empty_cache()
    return out, run


def tp_launches(label: str, cfg, got: list, ref: dict, launches: dict
                ) -> None:
    """Every rank drew the one-process run's weights and launched exactly
    ``tp_expected`` (of its mamba mixers' ``TP.SSM``); its launches are
    added to ``launches``."""
    for rank, r in enumerate(got):
        want = tp_expected(cfg, r["ssm"])
        if r["checksum"] != ref["checksum"]:
            raise AssertionError(f"{label}: rank {rank} drew other weights")
        if r["launches"] != want:
            raise AssertionError(f"{label}: rank {rank} launches "
                                 f"{r['launches']}, expected {want}")
        for k, v in r["launches"].items():
            launches[k] += v


def tp_logits(got: list, shape: tuple) -> torch.Tensor:
    """The ranks' logits (steps, B_r, V_r), rank r at mesh coordinates
    (r // model, r % model), whole: the vocabulary columns joined over
    ``model`` where it splits them (each rank holds them all where it
    does not: whisper-medium's 51865 divide no axis), the batch rows over
    ``data``."""
    m = shape[1]

    def rows(ranks):
        if not ranks[0]["vocab_split"]:
            return ranks[0]["logits"]
        return np.concatenate([r["logits"] for r in ranks], axis=-1)
    return torch.from_numpy(np.concatenate(
        [rows(got[d * m:(d + 1) * m]) for d in range(shape[0])], axis=1))


def tp_report(label: str, what: str, cfg, dtype, got: list, ref: dict,
              err: float, rel: float, backend: str, shape: tuple,
              keep: np.ndarray = None) -> None:
    """Phases 30-33's lines for one model (``label``, described by
    ``what``): the check and its bound, the tokens (those of the (step,
    batch row) pairs in ``keep``, all by default), each rank's times and
    the one-process run's."""
    toks, want = got[0]["tokens"], ref["tokens"]
    keep = np.ones(want.shape[::-1], bool) if keep is None else keep
    same = [np.array_equal(r["tokens"], toks) for r in got]
    held = keep.T[:, 1:]
    equal = int((toks[:, 1:] == want[:, 1:])[held].sum())
    first = bool((toks[:, 0] == want[:, 0])[keep[0]].all())
    bound = "rtol/atol 1e-3" if dtype == torch.float32 else TP_ROW_TOL
    print(f"{label} {what}, {str(cfg.compute_dtype)[6:]}, "
          f"{tp_prompt_of(cfg)}, {TP_GEN - 1} decode steps teacher-forced, "
          f"on a {shape} mesh ({len(got)} ranks sharing one card over "
          f"{backend}): logits vs the one-process run max abs err "
          f"{err:.3e}, largest |diff| {rel:.3e} of its row's largest "
          f"|logit| (bound: "
          f"{bound}); greedy tokens equal {equal}/{int(held.sum())} of the "
          f"decode "
          f"steps' held (prefill's equal: {first}), ranks agree: "
          f"{all(same)}; launches per rank {got[0]['launches']} (exact); "
          f"params {ref['bytes'] / 2 ** 30:.2f} GiB whole, "
          f"{[round(r['bytes'] / 2 ** 30, 2) for r in got]} GiB a rank")
    for rank, r in enumerate(got):
        print(f"{label} rank {rank} ({len(got)} ranks sharing one card over "
              f"gloo; not a multi-card speed), its collectives timed "
              f"between synchronisations: prefill {r['prefill_ms']:.3f} ms, "
              f"decode {r['decode_ms']:.3f} ms/token; {r['collectives']} "
              f"collectives in one prefill and {TP_GEN - 1} steps, "
              f"{r['collective_ms']:.3f} ms of that run's "
              f"{r['timed_ms']:.3f} ms (share "
              f"{r['collective_ms'] / r['timed_ms']:.3f}); peak device "
              f"memory {r['peak_gib']:.2f} GiB")
    print(f"{label} one process on the same card: prefill "
          f"{ref['prefill_ms']:.3f} ms, decode {ref['decode_ms']:.3f} "
          f"ms/token")


def tp_runs() -> list:
    """Every rank run of phases 30–35, in order: (phase, arch, depth cut
    or None, config, (data, model) mesh shape)."""
    runs = [("tp", arch, layers, tp_config(arch, layers, dtype), TP_MESH)
            for arch, layers, dtype in TP_SERVE]
    runs += [("moe", arch, layers, tp_config(arch, layers, dtype), TP_MESH)
             for arch, layers, dtype in MOE_TP_SERVE]
    runs.append(("moe", MOE_ARCH, None, tiny_version(get_config(
        MOE_ARCH)).with_(n_experts=MOE_TP_SMALL_EXPERTS), MOE_TP_SMALL_MESH))
    runs += [("ssm", arch, layers, tp_config(arch, layers, dtype), TP_MESH)
             for arch, layers, dtype in SSM_TP_SERVE]
    runs += [("ssm", arch, None, tiny_version(get_config(arch)).with_(**kw),
              SSM_TP_SMALL_MESH) for arch, kw in SSM_TP_SMALL]
    runs += [("vlmenc", arch, layers, tp_config(arch, layers, dtype), TP_MESH)
             for arch, layers, dtype in VLM_ENCDEC_TP_SERVE]
    runs += [("vlmenc", arch, None, tiny_version(get_config(arch)),
              VLM_ENCDEC_TP_SMALL_MESH) for arch in VLM_ENCDEC_TP_SMALL]
    runs += [("train", arch, layers, tp_config(arch, layers, dtype), TP_MESH)
             for arch, layers, dtype in TP_TRAIN]
    runs.append(("train", LM_ARCH, None, tiny_version(get_config(LM_ARCH)),
                 TP_TRAIN_SMALL_MESH))
    runs += [("moetrain", arch, layers, tp_config(arch, layers, dtype),
              TP_MESH) for arch, layers, dtype in MOE_TRAIN]
    runs += [("moetrain", MOE_ARCH, None, tiny_version(get_config(
        MOE_ARCH)).with_(n_experts=E), shape) for E, shape in MOE_TRAIN_SMALL]
    return runs


def phase_tp_ranks(dev) -> dict:
    """The ranks of phases 30–35 (:func:`tp_runs`): each run's one-process
    reference on the card (``tp_reference``: weights from TP_SEED, the
    prompt, TP_GEN greedy tokens; a train run's ``train_reference``), then
    one set of spawned ranks per world size, two on the (1, 2) mesh and
    four on their (2, 2) and (1, 4) meshes, each running its runs in turn
    (``tp_rank``): one process start per world size where each phase
    would take its own. The two sets run side by side (a thread each), so
    a rank's times include the other set's load on the card and the host.
    A hybrid's ranks draw its weights in turn (``tp_blocks``). A train run's streamed leaves are held to the
    reference's as they arrive (``leaf_reading``), each reference leaf
    freed after. Returns, by phase, its runs (arch, depth cut, config,
    mesh shape, reference, every rank's result, a train run's readings by
    leaf; a bf16 MoE's gradients, which its reference replays after the
    ranks, kept whole in host memory), the gloo backend's name and the
    sets' seconds."""
    runs = tp_runs()
    refs, args = [], []
    for phase, _, _, cfg, shape in runs:
        if phase in ("train", "moetrain"):
            ref, run = train_reference(cfg, dev)
            args.append((shape, True, run))
        else:
            ref, run = tp_reference(cfg, dev)
            args.append((shape, False,
                         (*run, cfg.family == SSM_TP_DRAW_IN_TURN)))
        refs.append(ref)
    got, backend, seconds = [None] * len(runs), None, {}
    readings = [{} for _ in runs]

    def spawn(world):
        mine = [i for i, r in enumerate(runs) if r[4][0] * r[4][1] == world]

        def on_leaf(rank, k, key, t):
            i = mine[k]
            readings[i][key] = t.clone() if refs[i].get("hold") else \
                leaf_reading(key, t, refs[i]["leaves"].pop(key))
        t0 = time.perf_counter()
        ranks = spawn_ranks(tp_rank, world, dev.type, [args[i] for i in mine],
                            on_leaf=on_leaf)
        return world, mine, ranks, time.perf_counter() - t0
    worlds = sorted({a * b for *_, (a, b) in runs})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(worlds)) as pool:     # the sets side by side
        for world, mine, ranks, secs in pool.map(spawn, worlds):
            seconds[world] = secs
            backend = ranks[0][0]
            for k, i in enumerate(mine):
                got[i] = [r[1][k] for r in ranks]
    print(f"tp ranks: {len(runs)} runs of phases 30-35; the two ranks' "
          f"processes ran {seconds.get(2, 0.0):.1f} s, the four ranks' "
          f"{seconds.get(4, 0.0):.1f} s, side by side in "
          f"{time.perf_counter() - t0:.1f} s, their start, weight draws and "
          f"streamed leaves included")
    out = {}
    for (phase, arch, layers, cfg, shape), ref, g, rd in zip(
            runs, refs, got, readings):
        out.setdefault(phase, []).append(
            dict(arch=arch, layers=layers, cfg=cfg, shape=shape, ref=ref,
                 got=g, backend=backend, readings=rd))
    return out


def phase_tp(dev, ranks: dict) -> dict:
    """30: tensor-parallel serving on a (1, 2) mesh's ``model`` axis, two
    spawned ranks sharing the one card over gloo (NCCL refuses two ranks
    of one group on one device; :func:`phase_tp_ranks`): llama3.2-1b cut
    to 2 layers in fp32, then in bf16 cut to 4 (its 8 kv heads split) and
    granite-20b at full width cut to 4 of its 52 layers (MQA: wk/wv whole
    and the decode cache sequence-sharded, merged by log-sum-exp), prompt
    4 x 512 and 32 decode steps teacher-forced with the one-process run's
    tokens; the logits held to that run on the same card (``tp_check``),
    each rank's launches of rmsnorm, flash and decode exact, prefill and
    decode times per rank and the collectives' share. Returns the
    launches (both ranks) and the kernels' worst errors at the ranks'
    shapes (phase 31's shapes among them)."""
    worst = tp_kernels(dev)
    launches = dict.fromkeys(TP_KERNELS, 0)
    for r in ranks["tp"]:
        arch, layers, cfg, ref, got = (r[k] for k in ("arch", "layers", "cfg",
                                                      "ref", "got"))
        dtype = cfg.compute_dtype
        tp_launches(f"tp {arch}", cfg, got, ref, launches)
        err, rel = tp_check(tp_logits(got, TP_MESH), ref["logits"], dtype,
                            f"tp {arch}")
        cut = "uncut" if layers is None else \
            f"cut to {layers} of {get_config(arch).n_layers} layers"
        tp_report(f"tp: {arch}", f"full width, {cut}", cfg, dtype, got,
                  ref, err, rel, r["backend"], TP_MESH)
    return dict(launches=launches, worst=worst)


def route_divergence(routes: list, ref: list, L: int, B: int, P: int
                     ) -> tuple:
    """A run's routes (``recording_routes``: each call's L router calls in
    MoE-layer order, the prefill's (B·P, k) rows then each decode step's
    (B, k)) against the one-process run's, a token's experts compared as a
    set (their order within the token moves no slot): (router rows, rows
    whose experts differ, each batch row's first position where one
    differs, inf where none does)."""
    if len(routes) != len(ref):
        raise AssertionError(f"{len(routes)} router calls, the one-process "
                             f"run made {len(ref)}")
    first = np.full(B, np.inf)
    n_rows = n_diff = 0
    for c, (a, b) in enumerate(zip(routes, ref)):
        diff = (np.sort(a, -1) != np.sort(b, -1)).any(-1)
        n_rows, n_diff = n_rows + diff.size, n_diff + int(diff.sum())
        call = c // L
        if call == 0:
            for row, d in enumerate(diff.reshape(B, P)):
                hit = np.flatnonzero(d)
                if hit.size:
                    first[row] = min(first[row], hit[0])
        else:
            for row in np.flatnonzero(diff):
                first[row] = min(first[row], P + call - 1)
    return n_rows, n_diff, first


def moe_tp_check(label: str, cfg, dtype, got: list, ref: dict) -> tuple:
    """Phase 31's check of a (1, 2) run against the one-process run. The
    ranks route alike; their routes are set beside the one-process run's
    (in fp32 differing router rows stay under MAX_ROUTE_DIFF; in bf16 a
    rank's rounding of its share of a product flips near-tied experts, so
    the share is printed). Each logit row (step, batch row) is held to
    ``tp_check``'s bound; only rows at or past a position where that
    batch row's route differs may pass it, fewer than MAX_ROUTE_DIFF of
    the router rows, and each is printed. Returns (max abs err and
    row-relative err over the rows
    within the bound, the (step, batch row) mask no differing route
    reaches)."""
    for rank, r in enumerate(got[1:], 1):
        if len(r["routes"]) != len(got[0]["routes"]) or not all(
                np.array_equal(a, b) for a, b in zip(r["routes"],
                                                      got[0]["routes"])):
            raise AssertionError(f"{label}: rank {rank} routed otherwise "
                                 f"than rank 0")
    n_rows, n_diff, first = route_divergence(
        got[0]["routes"], ref["routes"], expected_launches(cfg, 0)[4],
        LM_BATCH, LM_PROMPT)
    print(f"{label}: router rows whose experts differ from the one-process "
          f"run's {n_diff} of {n_rows} ({n_diff / n_rows:.4%}; bound "
          f"{MAX_ROUTE_DIFF:.0%} in fp32); each batch row's first such "
          f"position {first.tolist()}")
    if dtype == torch.float32 and n_diff > MAX_ROUTE_DIFF * n_rows:
        raise AssertionError(f"{label}: {n_diff} of {n_rows} router rows "
                             f"pick other experts")
    logits, want = tp_logits(got, TP_MESH), ref["logits"]
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: non-finite logits")
    diff = (logits - want).abs()
    rel = diff.amax(-1) / want.abs().amax(-1)                  # (steps, B)
    if dtype == torch.float32:
        past = (diff > SERVE_TOL["atol"] + SERVE_TOL["rtol"] * want.abs()
                ).any(-1).numpy()
    else:
        past = (rel > TP_ROW_TOL).numpy()
    pos = LM_PROMPT - 1 + np.arange(TP_GEN)
    keep = pos[:, None] < first[None, :]
    for t, b in zip(*np.nonzero(past)):
        print(f"{label}: logit row of step {t}, batch row {b} (position "
              f"{pos[t]}; the row's first differing route at "
              f"{first[b]}) past the bound: max abs err "
              f"{float(diff[t, b].max()):.3e}, {float(rel[t, b]):.3e} of "
              f"its largest |logit|")
    if (past & keep).any():
        raise AssertionError(f"{label}: logit rows past the bound that no "
                             f"differing route reaches")
    if past.sum() >= MAX_ROUTE_DIFF * n_rows:
        raise AssertionError(f"{label}: {int(past.sum())} logit rows past "
                             f"the bound")
    held = torch.from_numpy(~past)
    if not held.any():
        return float("nan"), float("nan"), keep
    return float(diff[held].max()), float(rel[held].max()), keep


def upcast_(tree: dict) -> dict:
    """Every leaf of a params tree in fp32, in place, one leaf at a time
    (the cache emptied after each): a bf16 model's exact function without
    its bf16 and fp32 copies on the card at once."""
    for k, v in tree.items():
        if isinstance(v, dict):
            upcast_(v)
        else:
            tree[k] = v.float()
            del v
            if tree[k].is_cuda:
                torch.cuda.empty_cache()
    return tree


def replayed_logits(label: str, cfg, got: list, ref: dict, dev,
                    exact: bool = False) -> tuple:
    """The one-process run's logits (steps, B, V) on the ranks' routing
    decisions (rank 0's weights and experts, ``replaying_routes``; a
    config without experts routes nothing) with the ranks' forced tokens;
    with ``exact`` also those of the same bf16 weights upcast to fp32
    after it (``upcast_``: one draw), the function that bf16 rounds.
    Returns (logits, the exact logits or None)."""
    params, check = tp_weights(cfg, dev)
    if check != ref["checksum"]:
        raise AssertionError(f"{label}: the replay drew other weights")
    prompt = tp_prompt(cfg, dev)

    def run(params, cfg):
        replay = replaying_routes(got[0]["gates"], got[0]["routes"], dev) \
            if cfg.n_experts else contextlib.nullcontext()
        with replay:
            rep = tp_serve(params, cfg, prompt, keep_logits=True,
                           forced=torch.from_numpy(ref["tokens"]).to(dev))
        return torch.stack(rep.logits).float().cpu()
    out = run(params, cfg)
    high = run(upcast_(params), cfg.with_(
        param_dtype=torch.float32, compute_dtype=torch.float32)) \
        if exact else None
    del params
    torch.cuda.empty_cache()
    return out, high


def replayed_check(label: str, cfg, got: list, ref: dict, dev) -> tuple:
    """A bf16 run's logits against the one-process run on the ranks'
    routing decisions (``replayed_logits``): every row within TP_ROW_TOL
    of its largest |logit| (``tp_check``): the split's arithmetic alone."""
    return tp_check(tp_logits(got, TP_MESH),
                    replayed_logits(label, cfg, got, ref, dev)[0],
                    cfg.compute_dtype, f"{label} (replayed routes)")


def row_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a − b| of a row over that row's largest |b|, the
    largest over the rows."""
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def bf16_readings(label: str, cfg, got: list, ref: dict, dev) -> tuple:
    """A bf16 run's logits against the one-process run on the ranks'
    routes (``replayed_logits``; a config without experts routes nothing)
    and both against the fp32 function of the same bf16 weights, printed.
    Returns (the ranks' logits, the one-process logits)."""
    logits = tp_logits(got, TP_MESH)
    one, exact = replayed_logits(label, cfg, got, ref, dev, exact=True)
    print(f"{label}: bf16 logits' largest |diff| over their row's largest "
          f"|logit|: the ranks against one process {row_rel(logits, one):.3e}"
          f"; against the fp32 function of the same bf16 weights one "
          f"process {row_rel(one, exact):.3e}, the ranks "
          f"{row_rel(logits, exact):.3e}")
    return logits, one


def phase_moe_tp(dev, ranks: dict) -> dict:
    """31: the MoE on a ``model`` axis (the reference's
    ``_moe_apply_shard_map``'s paths; the ranks of
    :func:`phase_tp_ranks`). Two ranks sharing the card over gloo on the
    (1, 2) mesh: moonshot-v1-16b-a3b at full width cut to 2 layers in fp32
    and in bf16, expert-parallel (32 of 64 experts a rank),
    held to the one-process run (``moe_tp_check``); then four ranks on the
    (2, 2) mesh serving tiny moonshot with 3 experts in fp32 (ff-sharded,
    d over ``data``: the prefill's weight gather and the 2-D decode),
    every logit within 1e-3 and every token equal. Launches exact per rank
    (topk_gating L a call beside rmsnorm, flash, decode). Returns the
    launches (all ranks)."""
    launches = dict.fromkeys(TP_KERNELS, 0)
    for r in ranks["moe"]:
        arch, layers, cfg, ref, got, shape = (
            r[k] for k in ("arch", "layers", "cfg", "ref", "got", "shape"))
        dtype = cfg.compute_dtype
        if shape != TP_MESH:
            label = f"moe tp {cfg.name} ({cfg.n_experts} experts)"
            tp_launches(label, cfg, got, ref, launches)
            err, rel = tp_check(tp_logits(got, shape), ref["logits"],
                                torch.float32, label)
            if not all(np.array_equal(g["tokens"], ref["tokens"])
                       for g in got):
                raise AssertionError(f"{label}: greedy tokens differ from "
                                     f"the one-process run's")
            tp_report(f"moe tp: {cfg.name} E {cfg.n_experts}",
                      f"(d {cfg.d_model}, ff {cfg.d_ff}; no published config "
                      f"has experts that two ranks fail to divide, so this "
                      f"tiny one is the card's run of the ff-sharded "
                      f"experts, d over data, the weight gather and the 2-D "
                      f"decode)", cfg, torch.float32, got, ref, err, rel,
                      r["backend"], shape)
            continue
        label = f"moe tp {arch}"
        tp_launches(label, cfg, got, ref, launches)
        err, rel, keep = moe_tp_check(label, cfg, dtype, got, ref)
        if dtype == torch.float32 and not np.array_equal(
                got[0]["tokens"][keep.T], ref["tokens"][keep.T]):
            raise AssertionError(f"{label}: greedy tokens differ from the "
                                 f"one-process run's")
        if dtype != torch.float32:
            print(f"{label}: logits vs the one-process run, held rows: max "
                  f"abs err {err:.3e}, {rel:.3e} of a row's largest |logit|")
            err, rel = replayed_check(label, cfg, got, ref, dev)
            print(f"{label}: on the ranks' routes (replayed) every logit row "
                  f"within {rel:.3e} of its largest |logit| (bound "
                  f"{TP_ROW_TOL}), max abs err {err:.3e}")
        tp_report(f"moe tp: {arch} at {layers} layers",
                  f"(full width, cut from {get_config(arch).n_layers}), "
                  f"expert-parallel ({cfg.n_experts // TP_MESH[1]} of "
                  f"{cfg.n_experts} experts a rank)", cfg, dtype, got, ref,
                  err, rel, r["backend"], TP_MESH,
                  keep if dtype == torch.float32 else None)
    return dict(launches=launches)


# -- the SSM and hybrid families on a model axis ------------------------------

# (arch, depth cut or None, dtype) of phase 32 on the (1, 2) mesh:
# mamba2-130m in fp32 (SERVE_TOL elementwise, tokens equal) and in
# bf16 cut to 2 layers, and one jamba period in bf16 on the ranks' routes
# replayed; a bf16 run is held to TP_ROW_TOL of each row's largest
# |logit|. Two correct bf16 runs of random mamba2-130m's 24 layers lie
# further apart than TP_ROW_TOL (each layer adds its rounding to the
# residual's): the JAX package's own bf16 lies 1.6e-1 from its fp32 at 24
# tiny layers and 3.5e-2 at 4 (tests/test_torch_ssm_tensor_parallel.py::
# test_bf16_lies_from_fp32_as_far_as_the_references_own); on the card one
# process's bf16 lies 2.5e-2 from fp32 at 2 layers, 5.1e-2 at 4, 1.9e-1
# at 24, so the split is held at 2 (the uncut bf16 readings:
# tools/tp_bf16_depths.py)
# mamba2-130m's fp32 run cut to 12 of its 24 layers (uncut before phase
# 34 joined the call: its time)
SSM_TP_SERVE = (("mamba2-130m", 12, torch.float32),
                ("mamba2-130m", 2, torch.bfloat16),
                ("jamba-v0.1-52b", 8, torch.bfloat16))
SSM_TP_DRAW_IN_TURN = "hybrid"   # the family whose ranks draw one at a time
SSM_TP_SMALL_MESH = (1, 4)       # (data, model)
# the four ranks' tiny fp32 configs: jamba (its 2 kv heads over 4 ranks:
# the MQA fallbacks beside the mamba split) and an SSM of 3 heads of 64
# channels, which no axis divides while their channels do (the head-dim
# split; in_proj's 419 columns split over no axis: the rank holds it whole)
SSM_TP_SMALL = (("jamba-v0.1-52b", {}),
                ("mamba2-130m", dict(d_model=96, ssm_head_dim=64)))
# (B, L, H, P, N, Q, what): the ranks' scan at model 2 (bf16 x/B/C views,
# y and state fp32, as the model calls it)
SSM_TP_SCAN = ((4, 512, 12, 64, 128, 256, "mamba2-130m rank: 12 of 24 heads"),
               (4, 512, 64, 64, 16, 256, "jamba-v0.1-52b rank: 64 of 128 "
                "heads"))


def ssm_tp_kernels(dev) -> float:
    """``ssd_scan`` at the ranks' shapes at ``model`` 2 against its plain
    version (y and the state within SSD_TOL's fp32 2e-3), twice bit-equal,
    timed by device time beside its bound and the plain version. Returns
    the worst error."""
    gen = torch.Generator(device=dev).manual_seed(TP_SEED + 2)
    bf, f32 = torch.bfloat16, torch.float32
    worst = 0.0
    for B, L, H, P, N, Q, what in SSM_TP_SCAN:
        args = ssd_operands(B, H, L, P, N, bf, True, gen, dev)
        kw = dict(chunk=Q, return_state=True, out_dtype=f32)
        y, h = same_twice(lambda: ops.ssd_scan(*args, **kw),
                          f"ssd_scan {what}")
        ry, rh = ops.ssd_scan_ref(*args, **kw)
        e = max(max_err(y, ry, **SSD_TOL[f32]), max_err(h, rh, **SSD_TOL[f32]))
        worst = max(worst, e)
        device_ms = MB.time_callable(lambda: ops.ssd_scan(*args, **kw),
                                     repeats=200, warmup=3) * 1e3
        plain_ms = cuda_ms(lambda: ops.ssd_scan_ref(*args, **kw), iters=10,
                           warm=2)
        bound, by = ssd_bound(B, H, L, P, N, Q, bf, f32)
        plan = SS.mma_plan(B, H, L, P, N, Q, True,
                           torch.cuda.get_device_properties(dev)
                           .multi_processor_count) \
            if dev.type == "cuda" else None
        print(f"ssd_scan {what} (B,L,H,P,N,Q)=({B},{L},{H},{P},{N},{Q}) bf16 "
              f"x/B/C strided views, y and state fp32: vs plain {e:.1e} "
              f"(bound rtol/atol 2e-3), rerun bit-equal; device "
              f"{device_ms:.5f} ms, bound {bound:.6f} ms ({by}), plain "
              f"{plain_ms:.5f} ms; plan {plan}")
    return worst


def phase_ssm_tp(dev, ranks: dict) -> dict:
    """32: the SSM and hybrid families on a ``model`` axis (the ranks of
    :func:`phase_tp_ranks`). ``ssd_scan`` at the ranks' shapes
    (:func:`ssm_tp_kernels`); two ranks sharing the card over gloo on the
    (1, 2) mesh: mamba2-130m at 12 layers in fp32 (every logit within 1e-3,
    tokens equal) and in bf16 cut to 2 layers (every row within
    TP_ROW_TOL of its largest |logit|), one jamba-v0.1-52b period in bf16, its ranks having drawn it in turn,
    within TP_ROW_TOL on their routes replayed in one process (the
    routes' divergence printed); each bf16 run's distance from the fp32
    function printed beside one process's (``bf16_readings``); then four
    ranks on (1, 4) serving
    tiny jamba and a tiny head-dim SSM in fp32 (within 1e-3, tokens
    equal). Launches exact per rank. Returns the launches (all ranks) and
    the scan's worst error."""
    worst = ssm_tp_kernels(dev)
    launches = dict.fromkeys(TP_KERNELS, 0)
    for r in ranks["ssm"]:
        arch, layers, cfg, ref, got, shape = (
            r[k] for k in ("arch", "layers", "cfg", "ref", "got", "shape"))
        dtype, H = cfg.compute_dtype, cfg.n_ssm_heads
        if shape != TP_MESH:
            label = f"ssm tp {cfg.name} (d {cfg.d_model}, {H} SSM heads " \
                f"of {cfg.ssm_head_dim})"
        else:
            label = f"ssm tp {arch}"
        tp_launches(label, cfg, got, ref, launches)
        if cfg.n_experts and dtype != torch.float32:
            n_rows, n_diff, first = route_divergence(
                got[0]["routes"], ref["routes"], expected_launches(cfg, 0)[4],
                LM_BATCH, LM_PROMPT)
            print(f"{label}: router rows whose experts differ from the "
                  f"one-process run's {n_diff} of {n_rows} "
                  f"({n_diff / n_rows:.4%}); each batch row's first such "
                  f"position {first.tolist()}; logits on their own routes "
                  f"{row_rel(tp_logits(got, TP_MESH), ref['logits']):.3e} "
                  f"of a row's largest |logit| from the one-process run's")
            label += " (replayed routes)"
        if dtype == torch.float32:
            err, rel = tp_check(tp_logits(got, shape), ref["logits"], dtype,
                                label)
            if not all(np.array_equal(g["tokens"], ref["tokens"])
                       for g in got):
                raise AssertionError(f"{label}: greedy tokens differ from "
                                     f"the one-process run's")
        else:
            logits, one = bf16_readings(label, cfg, got, ref, dev)
            err, rel = tp_check(logits, one, dtype, label)
        (h0, h1), (p0, p1) = got[0]["ssm"].heads, got[0]["ssm"].head_dim
        Pd = cfg.ssm_head_dim
        how = (f"SSM heads split ({h1 - h0} of {H} a rank)" if h1 - h0 < H
               else f"SSM head channels split ({p1 - p0} of each head's "
                    f"{Pd} a rank)" if p1 - p0 < Pd
               else "the mixer whole on every rank")
        if shape != TP_MESH:
            tp_report(f"ssm tp: {cfg.name} d {cfg.d_model}", f"(tiny, {how})",
                      cfg, dtype, got, ref, err, rel, r["backend"], shape)
            continue
        cut = "uncut" if layers is None else \
            f"cut to {layers} of {get_config(arch).n_layers} layers"
        tp_report(f"ssm tp: {arch}", f"full width, {cut}, {how}", cfg, dtype,
                  got, ref, err, rel, r["backend"], shape)
    return dict(launches=launches, worst=worst)


# -- the VLM and the enc-dec on a model axis ----------------------------------

# (arch, depth cut or None, dtype) of phase 33 on the (1, 2) mesh:
# qwen2-vl-7b at full width cut to 2 layers in fp32 (SERVE_TOL, tokens
# equal) and to 4 in bf16; whisper-medium in fp32 and in bf16 cut to
# ENCDEC_TP_BF16_LAYERS encoder and decoder layers, a depth where one
# process's own bf16 lies within TP_ROW_TOL of its fp32 function; a bf16
# run is held to TP_ROW_TOL of each row's largest |logit|. Measured first
# on the card (tools/tp_bf16_depths.py --vlm-encdec): one process's bf16
# whisper lies 6.5e-3, 8.4e-3, 9.5e-3 and 1.69e-2 from its fp32 function at
# 2, 4, 8 and 24 encoder and decoder layers, the ranks 7.7e-3, 8.7e-3,
# 1.01e-2 and 1.57e-2 from one process; 8 keeps a third of the depth at a
# third of the uncut run's time (117 against 250 ms a decode step a rank)
ENCDEC_TP_BF16_LAYERS = 8
# whisper-medium's fp32 run cut to 8 of its 24 encoder and decoder layers
# (uncut before phase 34 joined the call: its time)
ENCDEC_TP_FP32_LAYERS = 8
VLM_ENCDEC_TP_SERVE = ((VLM_ARCH, 2, torch.float32),
                       (VLM_ARCH, 4, torch.bfloat16),
                       (ENCDEC_ARCH, ENCDEC_TP_FP32_LAYERS, torch.float32),
                       (ENCDEC_ARCH, ENCDEC_TP_BF16_LAYERS, torch.bfloat16))
# the four ranks' tiny fp32 configs: qwen2-vl-7b's (4 heads padded to 32:
# every rank past the first holds only inert heads) and whisper-medium's
# (its 2 kv heads over 4 ranks: wk/wv cut on d at prefill, the self and
# cross caches sequence-sharded and merged by log-sum-exp)
VLM_ENCDEC_TP_SMALL_MESH = (1, 4)
VLM_ENCDEC_TP_SMALL = (VLM_ARCH, ENCDEC_ARCH)
# (B, KV, G, Sq, Skv, D, causal, what): the ranks' prefill attention at
# model 2
VLM_ENCDEC_TP_FLASH = (
    (4, 2, 8, 512, 512, 128, True, "qwen2-vl-7b rank: 16 of 32 heads over "
     "2 of 4 kv heads"),
    (4, 8, 1, WHISPER_FRAMES, WHISPER_FRAMES, 64, False, "whisper-medium "
     "rank's encoder: 8 of 16 heads"),
    (4, 8, 1, WHISPER_PROMPT, WHISPER_FRAMES, 64, False, "whisper-medium "
     "rank's cross-attention: the decoder prompt over the frames"))
# (B, KV, G, S, D, lengths, what): the ranks' decode attention at model 2,
# the first length timed
VLM_ENCDEC_TP_DECODE = (
    (4, 2, 8, LM_PROMPT + TP_GEN - 1, 128, (528, 513, 1, 0),
     "qwen2-vl-7b rank: 2 of 4 kv heads, whole cache"),
    (4, 8, 1, WHISPER_PROMPT + TP_GEN - 1, 64, (80, 65, 1, 0),
     "whisper-medium rank's self cache: 8 of 16 kv heads"),
    (4, 8, 1, WHISPER_FRAMES, 64, (WHISPER_FRAMES, 750, 1, 0),
     "whisper-medium rank's cross cache: 8 of 16 kv heads"))


def tp_heads_of(cfg, m: int) -> str:
    """How ``model`` = ``m`` ranks split ``cfg``'s attention, in words."""
    Hp, KV = cfg.heads_padded, cfg.n_kv_heads
    inert = (f" ({cfg.n_heads} real: the last {Hp - cfg.n_heads} inert)"
             if Hp > cfg.n_heads else "")
    kv = (f"{KV // m} of {KV} kv heads a rank" if KV % m == 0 else
          f"{KV} kv heads divide no rank: wk/wv cut on d at prefill, whole "
          f"at decode, the caches' positions split and merged by "
          f"log-sum-exp")
    return f"{Hp // m} of {Hp} query heads a rank{inert}, {kv}"


def phase_vlm_encdec_tp(dev, ranks: dict) -> dict:
    """33: the VLM and the enc-dec on a ``model`` axis (the ranks of
    :func:`phase_tp_ranks`). ``flash_attention`` and ``decode_attention``
    at the ranks' shapes at ``model`` 2 (:func:`tp_kernels`: qwen2-vl's 16
    of 32 heads over 2 kv heads, whisper-medium's encoder and
    cross-attention over 1500 frames and its self and cross caches)
    against their plain versions, timed beside SDPA; then two ranks on the
    (1, 2) mesh: qwen2-vl-7b at full width cut to 2 layers in fp32 and 4
    in bf16 (patch embeddings with M-RoPE streams that differ; its 4 inert
    heads on the last rank), whisper-medium at 8 layers in fp32 (1500 frames,
    phase 28's 64-token decoder prompt) and in bf16 cut to
    ENCDEC_TP_BF16_LAYERS, where one process's own bf16 lies within
    TP_ROW_TOL of its fp32 function (held here too, and printed beside
    the ranks' distance: ``bf16_readings``); fp32 within rtol/atol 1e-3
    of the one-process run with tokens equal, bf16 within TP_ROW_TOL of
    each row's largest |logit|; then four ranks on (1, 4) serving the tiny
    configs in fp32 (within 1e-3, tokens equal). Launches exact per rank
    (the enc-dec's norms are LayerNorm: no rmsnorm). Returns the launches
    (all ranks) and the kernels' worst errors."""
    worst = tp_kernels(dev, VLM_ENCDEC_TP_FLASH, VLM_ENCDEC_TP_DECODE,
                       TP_SEED + 3)
    launches = dict.fromkeys(TP_KERNELS, 0)
    for r in ranks["vlmenc"]:
        arch, layers, cfg, ref, got, shape = (
            r[k] for k in ("arch", "layers", "cfg", "ref", "got", "shape"))
        dtype = cfg.compute_dtype
        label = f"vlm/encdec tp {arch}" + ("" if shape == TP_MESH
                                           else " (tiny)")
        tp_launches(label, cfg, got, ref, launches)
        if dtype == torch.float32:
            err, rel = tp_check(tp_logits(got, shape), ref["logits"], dtype,
                                label)
            if not all(np.array_equal(g["tokens"], ref["tokens"])
                       for g in got):
                raise AssertionError(f"{label}: greedy tokens differ from "
                                     f"the one-process run's")
        else:
            logits, one = bf16_readings(label, cfg, got, ref, dev)
            err, rel = tp_check(logits, one, dtype, label)
        heads = tp_heads_of(cfg, shape[1])
        if shape != TP_MESH:
            tp_report(f"vlm/encdec tp: {cfg.name} tiny", f"(d {cfg.d_model}, "
                      f"{heads})", cfg, dtype, got, ref, err, rel,
                      r["backend"], shape)
            continue
        full = get_config(arch)
        depth = (f"{full.n_enc_layers} encoder and {full.n_dec_layers} "
                 f"decoder layers" if cfg.family == "encdec"
                 else f"{full.n_layers} layers")
        cut = f"uncut ({depth})" if layers is None else \
            f"cut to {layers} of {depth}"
        tp_report(f"vlm/encdec tp: {arch}", f"full width, {cut}, {heads}",
                  cfg, dtype, got, ref, err, rel, r["backend"], shape)
    return dict(launches=launches, worst=worst)


# -- tensor-parallel training on a model axis (phase 34) ---------------------

# (arch, depth cut, dtype) on the (1, 2) mesh, TP_TRAIN_STEPS steps each at
# TRAIN_BATCH x TRAIN_SEQ: llama3.2-1b at 2 layers in fp32 (the split's
# parity), at TRAIN_LAYERS in bf16 over the fp32 master (the training path
# as phase 21 runs it), granite-20b at 1 layer in fp32 (the MQA's wk/wv
# cut on their input dimension; 2 before phase 35 joined the call: its
# 20.0 GB stream took ~38 s of it). Memory: granite's layer and vocabulary
# leaves hold 1.13 B parameters, 16 bytes of state each (params, master,
# m, v: 18.1 GB) and 4 of gradients (4.5 GB) in the one-process
# reference; it is freed before the ranks start, its master copy and
# moments kept in host memory (13.6 GB) until the ranks' gathered state
# has streamed past them; each rank draws the whole 4.5 GB of weights,
# cuts its half and frees the whole, then holds half the state and
# gradients (~11.3 GB) and its activations
TP_TRAIN = (("llama3.2-1b", 2, torch.float32),
            ("llama3.2-1b", TRAIN_LAYERS, torch.bfloat16),
            ("granite-20b", 1, torch.float32))
TP_TRAIN_SMALL_MESH = (2, 2)     # tiny llama: ZeRO-1 over data beside the split
TP_TRAIN_STEPS = 3
TP_TRAIN_OPT = adamw.AdamWConfig(warmup_steps=1)
TP_TRAIN_TOL = 1e-4              # fp32 losses and grad norms, relative
TP_STATE_TOL = 1e-3              # fp32 gathered state, elementwise
# bf16 bounds: losses (relative), grad norms (relative), first-step
# gradients (of each leaf's largest |g|); a reading past one is printed as
# missed, not raised
TP_TRAIN_BF16 = dict(loss=1e-2, grad_norm=3e-2, grads=3e-2)
# (B, KV, G, S, D, dtype, what): the ranks' attention at model 2
TP_TRAIN_FLASH = (
    (4, 4, 4, 512, 64, torch.float32, "llama3.2-1b rank: 4 of 8 kv heads"),
    (4, 4, 4, 512, 64, torch.bfloat16, "llama3.2-1b rank: 4 of 8 kv heads"),
    (4, 1, 24, 512, 128, torch.float32, "granite-20b rank: 24 of 48 heads"))
# (rows, D, dtype): the ranks' norms, every rank norming all its rows
TP_TRAIN_NORM = ((2048, 2048, torch.float32), (2048, 2048, torch.bfloat16),
                 (2048, 6144, torch.float32))


def tp_train_kernels(dev, flash=TP_TRAIN_FLASH, norms=TP_TRAIN_NORM,
                     seed=TP_SEED + 4) -> dict:
    """rmsnorm, flash_attention and their backward kernels at the ranks'
    shapes (``flash``, ``norms``; phase 34's by default) against their
    plain versions, each twice bit-equal, timed beside their bounds, the
    plain versions, F.rms_norm / SDPA and those calls' autograd backward.
    Returns each kernel's worst error."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    F = torch.nn.functional
    worst = dict.fromkeys(TRAIN_KERNELS, 0.0)

    def note(name, e):
        worst[name] = max(worst[name], e)
    for B, KV, G, S, D, dtype, what in flash:
        q, k, v, do = flash_bwd_operands(B, KV, G, S, S, D, dtype, True, gen,
                                         dev)
        o = same_twice(lambda: (ops.flash_attention(q, k, v, causal=True),),
                       f"flash {what}")[0]
        note("flash_attention", lm_check(o, ops.flash_attention_ref(
            q, k, v, causal=True), dtype))
        got = same_twice(lambda: ops.flash_attention_bwd(q, k, v, o, do,
                                                         causal=True),
                         f"flash_bwd {what}")
        note("flash_attention_bwd", bwd_check(
            got, ops.flash_attention_bwd_ref(q, k, v, o, do, True), dtype,
            f"flash_bwd {what}"))
        shape = (f"(B,KV,G,S,D)=({B},{KV},{G},{S},{D}) {str(dtype)[6:]} "
                 f"causal, {what}")
        qh = q.reshape(B, KV * G, S, D)
        kh, vh = k.contiguous(), v.contiguous()
        t = attention_timing(
            lambda: ops.flash_attention(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=G > 1), shape,
            flash_bound(B, KV, G, S, S, D, True, dtype))
        t["plain_ms"] = cuda_ms(lambda: ops.flash_attention_ref(
            q, k, v, causal=True), iters=10, warm=2)
        report_timing("flash_attention", t)
        lib = backward_timing(
            lambda a, b_, c: F.scaled_dot_product_attention(
                a, b_, c, is_causal=True, enable_gqa=G > 1),
            (qh, kh, vh), do.reshape(B, KV * G, S, D))
        t = attention_timing(
            lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=True),
            lib, f"{shape}, {ops_fa.bwd_route(dtype, D)} route, beside "
            f"SDPA's autograd backward",
            flash_bwd_bound(B, KV, G, S, S, D, True, dtype))
        t["plain_ms"] = cuda_ms(lambda: ops.flash_attention_bwd_ref(
            q, k, v, o, do, True), iters=10, warm=2)
        report_timing("flash_attention_bwd", t)
    for rows, D, dtype in norms:
        x = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
        sc = (1 + 0.1 * torch.randn((D,), generator=gen, device=dev)).to(
            dtype)
        g = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
        shape = f"({rows}, {D}) {str(dtype)[6:]}"
        y = same_twice(lambda: (ops.rmsnorm(x, sc),), f"rmsnorm {shape}")[0]
        note("rmsnorm", lm_check(y, ops.rmsnorm_ref(x, sc), dtype))
        got = same_twice(lambda: ops.rmsnorm_bwd(x, sc, g),
                         f"rmsnorm_bwd {shape}")
        note("rmsnorm_bwd", bwd_check(got, rmsnorm_bwd_exact(x, sc, g),
                                      dtype, f"rmsnorm_bwd {shape}"))
        fwd = lambda: F.rms_norm(x, (D,), sc, 1e-6)  # noqa: E731
        t = dict(ms=cuda_ms(lambda: ops.rmsnorm(x, sc)),
                 plain_ms=cuda_ms(lambda: ops.rmsnorm_ref(x, sc)),
                 library_ms=cuda_ms(fwd), shape=f"{shape}, beside F.rms_norm",
                 **device_pair(lambda: ops.rmsnorm(x, sc), fwd))
        t["bound_ms"], t["bound_by"] = rmsnorm_bound(rows, D, dtype)
        report_timing("rmsnorm", t)
        lib = backward_timing(lambda a, s: F.rms_norm(a, (D,), s, 1e-6),
                              (x, sc), g)
        t = dict(ms=cuda_ms(lambda: ops.rmsnorm_bwd(x, sc, g)),
                 plain_ms=cuda_ms(lambda: ops.rmsnorm_bwd_ref(x, sc, g)),
                 library_ms=cuda_ms(lib),
                 shape=f"x, g {shape}, beside F.rms_norm's autograd backward",
                 **device_pair(lambda: ops.rmsnorm_bwd(x, sc, g), lib))
        t["bound_ms"], t["bound_by"] = rmsnorm_bwd_bound(rows, D, dtype)
        report_timing("rmsnorm_bwd", t)
    return worst


def tp_train_batches(cfg) -> list:
    """Phase 34's TP_TRAIN_STEPS batches of TRAIN_BATCH x TRAIN_SEQ tokens
    and labels (``token_batches`` from TP_SEED), as numpy arrays."""
    return [{k: v.numpy() for k, v in b.items()} for b in token_batches(
        cfg, TRAIN_BATCH, TRAIN_SEQ, TP_TRAIN_STEPS, torch.device("cpu"),
        seed=TP_SEED)]


def tp_train_streams(cfg) -> str:
    """What a run's rank 0 streams to the parent process to be held to
    the one-process run: the first step's gradients, gathered, in bf16
    (its bound is on them); the gathered master copy and moments after the
    steps in fp32 (its params equal the master bit for bit, checked on the
    ranks), those :func:`streamed_state` picks."""
    return "grads" if cfg.compute_dtype == torch.bfloat16 else "state"


def streamed_state(cfg, key: str) -> bool:
    """Whether rank 0 streams the gathered state leaf ``key`` (a
    ``flatten_with_keys`` key of the train state) of an fp32 run: every
    leaf of the master copy and moments of a dense model (phase 34); of
    an MoE (phase 35) the master copy of its MoE leaves (router, ``wi``,
    ``wo``) and its norms, which phase 35 compares: ~4.4 GB of
    moonshot's 2 layers, of its ~29 GB of state."""
    if not key.startswith(".opt.") or key == ".opt.step":
        return False
    return not cfg.n_experts or key.startswith(".opt.master") and (
        "['ffn']" in key or "norm" in key)


def routed(fn):
    """``fn()`` with the experts of each ``topk_gating`` call recorded
    (``recording_routes``): (its result, the routes, (N, k) int32 numpy
    arrays in call order)."""
    with recording_routes() as routes:
        out = fn()
    return out, [r.numpy() for r in routes]


def batches_on(host: list, dev) -> list:
    return [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            for b in host]


def train_reference(cfg, dev) -> tuple:
    """The one-process run on the card that the ranks of phases 34 and 35
    are held to: the TP_SEED weights through TP_TRAIN_STEPS
    ``make_train_step`` steps of TP_TRAIN_OPT on ``tp_train_batches``; its
    losses, grad norms, step times and an MoE's routes each step, and in
    host memory what the ranks stream (``tp_train_streams``), keyed as
    they send it. A bf16 MoE's gradients are not taken here: the parent
    holds the ranks' (``hold``) for :func:`replayed_train`, on their
    routes. The state is freed. Returns (that record, the ranks' run:
    config, batches, checksum)."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params, check = tp_weights(cfg, dev)
    host = tp_train_batches(cfg)
    batches = batches_on(host, dev)
    kind = tp_train_streams(cfg)
    hold = kind == "grads" and bool(cfg.n_experts)
    leaves = {}
    if kind == "grads" and not hold:
        _, g = ST.loss_and_grads(params, cfg, batches[0])
        leaves = {f"grads{k}": t.cpu() for k, t in flatten_with_keys(g)}
        del g
    keys = [f"grads{k}" for k, _ in flatten_with_keys(params)] if hold \
        else None
    state = ST.TrainState(params, adamw.init(TP_TRAIN_OPT, params))
    step = ST.make_train_step(cfg, TP_TRAIN_OPT)
    losses, norms, ms, routes = [], [], [], []
    for b in batches:
        sync(dev)
        t0 = time.perf_counter()
        (state, m), r = routed(lambda: step(state, b))
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        routes.append(r)
    if kind == "state":
        leaves = {f"state{k}": t.cpu() for k, t in flatten_with_keys(state)
                  if streamed_state(cfg, k)}
    out = dict(checksum=check, losses=losses, norms=norms, step_ms=ms,
               leaves=leaves, keys=keys or list(leaves), hold=hold,
               routes=routes, n_params=sum(t.numel() for t in
                                           tree_leaves(params)),
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else 0.0))
    del state, params, batches
    torch.cuda.empty_cache()
    return out, (cfg, host, check)


def leaf_reading(key: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A streamed leaf against the one-process run's (both in host
    memory): a gradient's largest |diff| over its largest |g|, a state
    leaf's largest |diff|."""
    a, b = got.float(), want.float()
    if a.shape != b.shape or not bool(torch.isfinite(a).all()):
        raise AssertionError(f"streamed {key}: shape {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}, or not finite")
    d = float((a - b).abs().max())
    return d / max(float(b.abs().max()), 1e-30) if key.startswith(
        "grads") else d


@contextlib.contextmanager
def timed_dist(spent: list):
    """Every ``torch.distributed`` collective the train step calls (the
    ``model`` axis's sums and gathers, the clip's norm, the data axis's
    gradient mean or ZeRO-1 reduce-scatter and gather) timed between two
    synchronisations of the card, its seconds appended to ``spent``."""
    import torch.distributed as dist
    names = ["all_reduce",
             "all_gather_single" if hasattr(dist, "all_gather_single")
             else "all_gather_into_tensor",
             "reduce_scatter_single" if hasattr(dist, "reduce_scatter_single")
             else "reduce_scatter_tensor"]
    orig = {k: getattr(dist, k) for k in names}

    def timed(fn):
        def call(t, *args, **kw):
            sync(t.device)
            t0 = time.perf_counter()
            out = fn(t, *args, **kw)
            sync(t.device)
            spent.append(time.perf_counter() - t0)
            return out
        return call
    for k, fn in orig.items():
        setattr(dist, k, timed(fn))
    try:
        yield
    finally:
        for k, fn in orig.items():
            setattr(dist, k, fn)


def staging(box: dict, n: int, pin: bool) -> torch.Tensor:
    """``box``'s host buffer of at least ``n`` bytes (pinned with
    ``pin``), grown as needed and reused: its first ``n`` bytes."""
    if box.get("buf") is None or box["buf"].numel() < n:
        box["buf"] = None
        box["buf"] = torch.empty(n, dtype=torch.uint8, pin_memory=pin)
    return box["buf"][:n]


def send_leaf(conn, k: int, key: str, t: torch.Tensor, box: dict) -> None:
    """One whole leaf of run ``k`` to the parent process: a header, then
    its raw bytes written to the pipe, through ``box``'s pinned staging
    buffer (:class:`LeafSender` calls it). Not ``Connection.send_bytes``:
    its reader takes a message of gigabytes in small reads, each into a
    new buffer, many times slower than :func:`recv_raw`'s reads into one
    buffer."""
    n = t.numel() * t.element_size()
    host = staging(box, n, t.device.type == "cuda")
    host.view(t.dtype).view(t.shape).copy_(t)
    conn.send(("leaf", k, key, str(t.dtype), tuple(t.shape), n))
    view, fd = memoryview(host.numpy()), conn.fileno()
    while len(view):
        view = view[os.write(fd, view):]


class LeafSender:
    """``send_leaf`` from a background thread, so that rank 0 gathers the
    next leaf over gloo while the last one is staged and written (both
    release the interpreter lock): at most one leaf waits. A failed write
    is raised at the next :meth:`put` or at :meth:`close`."""

    def __init__(self, conn, k: int):
        self.queue: queue.Queue = queue.Queue(maxsize=1)
        self.error = None
        self.thread = threading.Thread(target=self._run, args=(conn, k),
                                       daemon=True)
        self.thread.start()

    def _run(self, conn, k: int) -> None:
        box: dict = {}
        while (item := self.queue.get()) is not None:
            if self.error is None:
                try:
                    send_leaf(conn, k, *item, box)
                except BaseException as err:        # noqa: BLE001
                    self.error = err

    def put(self, key: str, t: torch.Tensor) -> None:
        if self.error is not None:
            raise self.error
        self.queue.put((key, t))

    def close(self) -> None:
        self.queue.put(None)
        self.thread.join()
        if self.error is not None:
            raise self.error


def recv_raw(conn, n: int, box: dict) -> torch.Tensor:
    """The ``n`` raw bytes ``send_leaf`` wrote after its header, read
    straight into ``box``'s host buffer (valid until the next call)."""
    out = staging(box, n, False)
    view = memoryview(out.numpy())
    f, got = io.FileIO(conn.fileno(), "rb", closefd=False), 0
    while got < n:
        k = f.readinto(view[got:])
        if not k:
            raise EOFError("a rank's pipe closed inside a leaf")
        got += k
    return out


def replicated_equal(state, plan) -> int:
    """The leaves replicated on ``model`` (params, master copy, moments)
    gathered over the ``model`` ranks of this data row and compared bit
    for bit; raises if any differs, else returns how many were."""
    n = 0
    split = tree_leaves(plan.model.split)
    for tree in (state.params, *state.opt[1:]):
        for t, s in zip(tree_leaves(tree), split):
            if s:
                continue
            every = TP.all_gather(local(t).contiguous(), plan.model.group,
                                  plan.model.size)
            if not all(torch.equal(every[0], x) for x in every[1:]):
                raise AssertionError("a leaf replicated on model differs "
                                     "across the model ranks")
            n += 1
    return n


def tp_train_rank_run(mesh, dev, conn, k: int, cfg, host: list,
                      check: float) -> dict:
    """The run ``k`` of phase 34 or 35 on this rank: the TP_SEED weights
    drawn whole, cut to the rank's train blocks (``shard_params``) and
    laid out with a fresh optimiser state (``mesh_state``), then
    TP_TRAIN_STEPS ``mesh_step`` train steps, each counted, timed (its
    collectives timed between synchronisations; an MoE's routes recorded)
    and followed by the replicated leaves' check; rank 0 streams
    ``tp_train_streams``' leaves, gathered whole, to the parent
    (``send_leaf``). In bf16 the first step's gradients come from
    ``mesh_grads`` (counted as a step is) before the steps."""
    import torch.distributed as dist
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    start, stages = time.perf_counter(), {}

    def stage(name):
        stages[name] = round(time.perf_counter() - start, 1)
    plan = ST.mesh_plan(cfg, mesh)
    whole, got = tp_weights(cfg, dev)
    blocks = TP.shard_params(whole, cfg, mesh, "train")
    del whole
    torch.cuda.empty_cache()
    state = ST.mesh_state(ST.TrainState(blocks, adamw.init(TP_TRAIN_OPT,
                                                           blocks)), plan)
    del blocks
    stage("laid out")
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        [tree_map(local, tr) for tr in (state.params, *state.opt[1:])]))
    batches = batches_on(host, dev)
    lead, kind = dist.get_rank() == 0, tp_train_streams(cfg)
    out = dict(checksum=got, launches=[], losses=[], norms=[], step_ms=[],
               collectives=[], collective_ms=[], replicated=[], bytes=nbytes,
               routes=[], grad_routes=None)
    if kind == "grads":
        zero_ssm_train_launches()
        (_, g), routes = routed(lambda: ST.mesh_grads(
            cfg, plan, state.params, batches[0]))
        out["grad_routes"] = [routes]
        out["launches"].append(ssm_train_launches())
        g = ST.gather_params(g, plan)
        if lead:
            sender = LeafSender(conn, k)
            for key, t in flatten_with_keys(g):
                sender.put("grads" + key, t)
            sender.close()
        del g
        stage("gradients streamed")
    step = ST.mesh_step(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"), mesh, TP_TRAIN_OPT)
    for b in batches:
        spent: list = []
        zero_ssm_train_launches()
        with timed_dist(spent):
            sync(dev)
            t0 = time.perf_counter()
            (state, m), routes = routed(lambda: step(state, b))
            sync(dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(ssm_train_launches())
        out["routes"].append(routes)
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
        out["collectives"].append(len(spent))
        out["collective_ms"].append(sum(spent) * 1e3)
        out["replicated"].append(replicated_equal(state, plan))
        stage(f"step {len(out['losses'])}")
    if cfg.param_dtype == torch.float32:       # params are the master's bits
        z = plan.zero1
        out["params_are_master"] = all(
            torch.equal(adamw.block(local(p), d, z), local(mst))
            for p, mst, d in zip(tree_leaves(state.params),
                                 tree_leaves(state.opt.master),
                                 tree_leaves(z.dims)))
    if kind == "state":
        sender = LeafSender(conn, k) if lead else None
        for key, t in ST.gathered(state, plan,
                                  only=lambda key: streamed_state(cfg, key)):
            if lead:
                sender.put("state" + key, t)
        if lead:
            sender.close()
        stage("state streamed")
    out["stages"] = stages
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if dev.type == "cuda" else 0.0)
    del state, step
    torch.cuda.empty_cache()
    return out


def phase_tp_train(dev, ranks: dict) -> dict:
    """34: the dense family's train step on a ``model`` axis
    (``mesh_step`` of kind train on a (1, 2) mesh, two ranks sharing the
    card over gloo, :func:`phase_tp_ranks`): the kernels at the ranks'
    shapes (``tp_train_kernels``), then each TP_TRAIN run held to its
    one-process run on the same card (``train_reference``;
    :func:`train_run_check`); then tiny llama on a (2, 2) mesh, ZeRO-1
    over ``data`` beside the split, held as the fp32 runs. Returns the
    launches (every rank) and the kernels' worst errors."""
    worst = tp_train_kernels(dev)
    launches = dict.fromkeys(SSM_TRAIN_KERNELS, 0)
    for r in ranks["train"]:
        for name, v in train_run_check(r).items():
            launches[name] += v
    return dict(launches=launches, worst=worst)


def train_run_check(r: dict, note: str = "") -> dict:
    """One train run of phase 34 or 35 against its one-process run: fp32
    losses and grad norms within 1e-4 relative and every streamed leaf of
    the gathered state within 1e-3 (the params the master's bits); bf16
    losses, grad norms and first-step gradients read against their bounds
    (a miss printed); the ranks' checksums, losses and norms equal; each
    rank's launches exact per step; per-rank step times and collectives
    printed (``note`` added to the run's line). Returns the launches of
    every rank, by kernel."""
    cfg, shape, ref, got, readings = (r[k] for k in (
        "cfg", "shape", "ref", "got", "readings"))
    label = f"tp train {cfg.name} ({cfg.n_layers} layers, d " \
            f"{cfg.d_model}, {str(cfg.compute_dtype)[6:]}, {shape} mesh)"
    # a rank norms all of its rows, runs every layer's attention on its
    # heads and routes all of its rows (the router is replicated), as one
    # process does
    want = train_expected(cfg)
    launches = dict.fromkeys(SSM_TRAIN_KERNELS, 0)
    for rank, g in enumerate(got):
        if g["checksum"] != ref["checksum"]:
            raise AssertionError(f"{label}: rank {rank} drew other "
                                 f"weights")
        if any(c != want for c in g["launches"]):
            raise AssertionError(f"{label}: rank {rank} launches "
                                 f"{SSM_TRAIN_KERNELS} {g['launches']}, "
                                 f"expected {want} a step")
        for c in g["launches"]:
            for name, v in zip(SSM_TRAIN_KERNELS, c):
                launches[name] += v
        if g["losses"] != got[0]["losses"] or \
                g["norms"] != got[0]["norms"]:
            raise AssertionError(f"{label}: the ranks' losses or grad "
                                 f"norms differ")
        if g.get("params_are_master") is False:
            raise AssertionError(f"{label}: rank {rank}'s fp32 params "
                                 f"are not its master's bits")
    g = got[0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(g["losses"], ref["losses"]))
    norm_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(g["norms"], ref["norms"]))
    clip = ref["norms"][0] > TP_TRAIN_OPT.grad_clip
    kind = tp_train_streams(cfg)
    if len(readings) != len(ref["keys"]):
        raise AssertionError(f"{label}: {len(readings)} leaves streamed "
                             f"of {len(ref['keys'])}")
    worst_leaf = max(readings.items(), key=lambda kv: kv[1])
    if kind == "state":
        if not (loss_rel <= TP_TRAIN_TOL and norm_rel <= TP_TRAIN_TOL):
            raise AssertionError(
                f"{label}: losses {g['losses']} vs {ref['losses']}, "
                f"grad norms {g['norms']} vs {ref['norms']}")
        if not worst_leaf[1] <= TP_STATE_TOL:
            raise AssertionError(f"{label}: gathered {worst_leaf[0]} "
                                 f"differs by {worst_leaf[1]:.3e}")
        what = "master copy and moments" if not cfg.n_experts else \
            "master copy's MoE leaves and norms"
        held = (f"losses within {loss_rel:.3e} and grad norms within "
                f"{norm_rel:.3e} relative (bound {TP_TRAIN_TOL}); every "
                f"leaf of the gathered {what} within "
                f"{worst_leaf[1]:.3e} elementwise (bound {TP_STATE_TOL}; "
                f"largest at {worst_leaf[0]}), the params the master's "
                f"bits")
    else:
        bounds = TP_TRAIN_BF16
        marks = {k: ("met" if v <= bounds[k] else "NOT MET")
                 for k, v in (("loss", loss_rel), ("grad_norm", norm_rel),
                              ("grads", worst_leaf[1]))}
        held = (f"losses within {loss_rel:.3e} relative (bound "
                f"{bounds['loss']}: {marks['loss']}), grad norms within "
                f"{norm_rel:.3e} (bound {bounds['grad_norm']}: "
                f"{marks['grad_norm']}); first-step gradients within "
                f"{worst_leaf[1]:.3e} of each leaf's largest |g| (bound "
                f"{bounds['grads']}: {marks['grads']}; largest at "
                f"{worst_leaf[0]}); every leaf's reading: "
                + ", ".join(f"{k[5:]} {v:.2e}"
                            for k, v in readings.items()))
    print(f"{label}: {TP_TRAIN_STEPS} AdamW steps (warmup 1, the clip "
          f"{'acting' if clip else 'NOT acting'}: step-1 norm "
          f"{ref['norms'][0]:.4f} over {TP_TRAIN_OPT.grad_clip}) of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} on {len(got)} ranks sharing one "
          f"card over {r['backend']}{note}: losses {g['losses']} (one "
          f"process {ref['losses']}), grad norms {g['norms']} (one process "
          f"{ref['norms']}); {held}; leaves replicated on model "
          f"bit-equal across the ranks after every step "
          f"({g['replicated'][0]} a step); launches {SSM_TRAIN_KERNELS} "
          f"{want} per rank a step, exact; {ref['n_params']:,} "
          f"params, state "
          f"{[round(x['bytes'] / 2 ** 30, 2) for x in got]} GiB a rank")
    for rank, x in enumerate(got):
        print(f"{label} rank {rank} (ranks sharing one H100 over gloo, "
              f"not a multi-card speed): step ms "
              f"{[round(v, 3) for v in x['step_ms']]}, collectives a "
              f"step {x['collectives']} taking "
              f"{[round(v, 3) for v in x['collective_ms']]} ms (timed "
              f"between synchronisations); peak device memory "
              f"{x['peak_gib']:.2f} GiB; seconds into the run at each "
              f"stage {x['stages']}")
    print(f"{label} one process on the same card: step ms "
          f"{[round(v, 3) for v in ref['step_ms']]}, peak device "
          f"memory {ref['peak_gib']:.2f} GiB")
    return launches


# -- MoE training on a model axis (phase 35) ----------------------------------

# (arch, depth cut, dtype) of phase 35 on the (1, 2) mesh: moonshot's 64
# experts split 32 a rank, 2 of its 48 layers (~1.81 B parameters: 1.11
# B of experts, 0.67 B of embedding and lm_head; phase 34's granite-20b
# at 2 layers is this scale and fits: each rank draws the whole weights,
# cuts its half and frees the whole)
MOE_TRAIN = ((MOE_ARCH, 2, torch.float32), (MOE_ARCH, 2, torch.bfloat16))
# (experts, mesh) of tiny fp32 moonshot on four ranks: 3 experts divide
# no model axis (ff-sharded, d over data at (2, 2): the FSDP leaves, and
# ZeRO-1); 4 on (1, 4), one expert a rank
MOE_TRAIN_SMALL = ((MOE_TP_SMALL_EXPERTS, (2, 2)), (4, (1, 4)))
# (B, KV, G, S, D, dtype, what): the ranks' attention at model 2
MOE_TRAIN_FLASH = (
    (4, 8, 1, 512, 128, torch.float32, "moonshot-v1-16b-a3b rank: 8 of 16 "
     "heads"),
    (4, 8, 1, 512, 128, torch.bfloat16, "moonshot-v1-16b-a3b rank: 8 of 16 "
     "heads"))


@contextlib.contextmanager
def replaying_experts(routes: list, dev):
    """``topk_gating`` picks another run's recorded experts, call after
    call, while the block runs (no launch), and weighs them from this
    run's own logits as the kernel's plain version does (softmax,
    gathered at those experts, renormalised), so that the router's
    gradient flows (``replaying_routes``' recorded weights would cut
    it)."""
    gate = ops.topk_gating
    calls = iter(routes)

    def replayed(logits, k):
        i = torch.from_numpy(next(calls)).to(dev)
        t = torch.softmax(logits.float(), dim=-1).gather(-1, i.long())
        return t / t.sum(-1, keepdim=True).clamp_min(1e-9), i
    ops.topk_gating = replayed
    try:
        yield
    finally:
        ops.topk_gating = gate
    if next(calls, None) is not None:
        raise AssertionError("the replayed run made fewer router calls")


def replayed_train(cfg, dev, grad_routes: list, step_routes: list,
                   check: float) -> dict:
    """The one-process run of a bf16 MoE on the ranks' experts
    (:func:`replaying_experts`): the first step's gradients on the
    ``mesh_grads`` call's routes and TP_TRAIN_STEPS steps, each on its
    step's; losses, grad norms and the gradients in host memory, keyed as
    the ranks stream them."""
    params, got = tp_weights(cfg, dev)
    if got != check:
        raise AssertionError(f"{cfg.name}: the replay drew other weights")
    batches = batches_on(tp_train_batches(cfg), dev)
    with replaying_experts(grad_routes, dev):
        _, g = ST.loss_and_grads(params, cfg, batches[0])
    leaves = {f"grads{k}": t.cpu() for k, t in flatten_with_keys(g)}
    del g
    state = ST.TrainState(params, adamw.init(TP_TRAIN_OPT, params))
    step = ST.make_train_step(cfg, TP_TRAIN_OPT)
    losses, norms = [], []
    for b, routes in zip(batches, step_routes):
        with replaying_experts(routes, dev):
            state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del state, params, batches
    torch.cuda.empty_cache()
    return dict(losses=losses, norms=norms, leaves=leaves)


def mesh_routes(got: list, shape: tuple, key: str = "routes") -> list:
    """The ranks' routes (per forward, per router call) whole: each call's
    rows joined over the data rows of ranks, the ``model`` ranks of a row
    routing alike (raised otherwise)."""
    m = shape[1]
    for rank, g in enumerate(got):
        lead = got[rank - rank % m][key]
        if len(g[key]) != len(lead) or not all(
                np.array_equal(a, b) for f, h in zip(g[key], lead)
                for a, b in zip(f, h)):
            raise AssertionError(f"rank {rank} routed otherwise than the "
                                 f"first rank of its data row")
    return [[np.concatenate([got[d * m][key][f][c] for d in range(
        shape[0])]) for c in range(len(got[0][key][f]))]
        for f in range(len(got[0][key]))]


def route_share(routes: list, ref: list) -> tuple:
    """(router rows, rows whose experts differ as a set) of two runs'
    routes, per forward and per call."""
    n = diff = 0
    for f, h in zip(routes, ref):
        for a, b in zip(f, h):
            d = (np.sort(a, -1) != np.sort(b, -1)).any(-1)
            n, diff = n + d.size, diff + int(d.sum())
    return n, diff


def phase_moe_train(dev, ranks: dict) -> dict:
    """35: the MoE family's train step on a ``model`` axis (the ranks of
    :func:`phase_tp_ranks`): flash and its backward at moonshot's rank
    shape (``tp_train_kernels``), then each run held to its one-process
    run on the card (:func:`train_run_check`): moonshot-v1-16b-a3b at 2
    layers on (1, 2) in fp32, under 1% of its router rows picking other
    experts than the one-process run's, and in bf16 against the
    one-process run replayed on the ranks' experts
    (:func:`replayed_train`), the unreplayed rows that differ printed;
    tiny moonshot with 3 experts on (2, 2) (ff-sharded, d over ``data``)
    and with 4 on (1, 4) in fp32. Returns the launches (every rank) and
    the kernels' worst errors."""
    worst = tp_train_kernels(dev, MOE_TRAIN_FLASH, (), TP_SEED + 5)
    launches = dict.fromkeys(SSM_TRAIN_KERNELS, 0)
    for r in ranks["moetrain"]:
        cfg, shape, ref, got = (r[k] for k in ("cfg", "shape", "ref", "got"))
        routes = mesh_routes(got, shape)
        n, diff = route_share(routes, ref["routes"])
        share = f"{diff} of {n} ({diff / n:.4%})"
        if cfg.compute_dtype == torch.float32:
            if diff > MAX_ROUTE_DIFF * n:
                raise AssertionError(f"{cfg.name} on {shape}: {share} router "
                                     f"rows pick other experts")
            note = (f"; router rows picking other experts than the "
                    f"one-process run {share} (bound {MAX_ROUTE_DIFF:.0%})")
        else:
            rep = replayed_train(cfg, dev, mesh_routes(got, shape,
                                                       "grad_routes")[0],
                                 routes, ref["checksum"])
            readings = {k: leaf_reading(k, t, rep["leaves"].pop(k))
                        for k, t in r["readings"].items()}
            note = (f", held to the one-process run replayed on the ranks' "
                    f"experts (unreplayed, {share} router rows pick other "
                    f"experts: bf16 rounding flips near-tied ones; "
                    f"unreplayed losses {ref['losses']}, grad norms "
                    f"{ref['norms']})")
            r = dict(r, readings=readings, ref=dict(
                ref, losses=rep["losses"], norms=rep["norms"]))
        for name, v in train_run_check(r, note).items():
            launches[name] += v
    return dict(launches=launches, worst=worst)


def timed(fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds printed on a line of their
    own (``phase <function>[ <name>]: <s> s``)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    name = f" {args[0]}" if args and isinstance(args[0], str) else ""
    print(f"phase {fn.__name__}{name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = timed(phase_device)
    timed(phase_build)
    timing = timed(phase_kernel, dev)

    uniform = ensemble()
    mixed = ensemble(mem_range=(1e6, 4e6))
    for name, ens in (("fused", uniform), ("legacy", mixed)):
        # a slot the planner gave no student never arrives: every answer
        # of such a plan is degraded
        print(f"plan {name}: K={len(ens.part_dims)}, widths "
              f"{sorted(set(ens.part_dims))}, replicas per slot "
              f"{ens.ir.member.sum(1).tolist()}, slots without a student "
              f"{int((ens.ir.student_of < 0).sum())}")
    timed(phase_profile, uniform, dev)
    phases = [
        timed(phase_serve, "fused", uniform, dev, fused=True),
        timed(phase_serve, "legacy", mixed, dev, fused=False, seed=1),
        timed(phase_serve, "int8", uniform, dev, quantize="int8",
              fused=True, seed=2, fp32_twin=server_from_ensemble(
                  uniform, seed=2, device=dev)),
    ]

    plans = coded_plans()
    decode_timing = timed(phase_decode_kernel, dev, plans)
    coded = {name: ensemble_for(ir, seed=3) for name, ir in plans.items()}
    sysdev = plans["coded-fused"].device_names[
        int(np.flatnonzero(plans["coded-fused"].member[0])[0])]
    timed(phase_profile, coded["coded-fused"], dev,
          label="coded-fused decode",
          failure=FailureModel(forced_failures=[sysdev], outages=False))
    coded_phases = [
        timed(phase_serve, "coded-fused", coded["coded-fused"], dev,
              fused=True, seed=3, coded=True),
        timed(phase_serve, "coded-legacy", coded["coded-legacy"], dev,
              fused=False, seed=4, coded=True),
        timed(phase_serve, "compute-fused", coded["compute-fused"], dev,
              fused=True, seed=5, coded=True),
    ]
    coded_phases.append(timed(phase_repair, "repair",
                              coded_phases[0]["server"],
                              coded_phases[0]["cpu"]))
    phases += coded_phases

    kernel = dict(name="quorum_aggregate", route="cuda",
                  source=KERNEL_SOURCE, replaces=TPU_KERNEL,
                  launches=sum(p["launches"] for p in phases),
                  max_abs_err=timing["max_abs_err"], ms=timing["ms"],
                  plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
                  bound_by=timing["bound_by"],
                  library_ms=timing["library_ms"],
                  device_ms=timing["device_ms"])
    decode = dict(name="coded_decode", route="cuda", source=DECODE_SOURCE,
                  replaces=DECODE_TPU_KERNEL,
                  launches=sum(p["decodes"] for p in coded_phases),
                  max_abs_err=decode_timing["max_abs_err"],
                  ms=decode_timing["ms"], plain_ms=decode_timing["plain_ms"],
                  bound_ms=decode_timing["bound_ms"],
                  bound_by=decode_timing["bound_by"],
                  library_ms=decode_timing["library_ms"],
                  device_ms=decode_timing["device_ms"])

    lm_timing = timed(phase_lm_kernels, dev)
    timed(phase_lm_card_vs_cpu, dev)
    lm = timed(phase_lm_serve, dev)
    lm_timing.update(timed(phase_ssm_moe_kernels, dev))
    timed(phase_ssm_moe_card_vs_cpu, dev)
    ssm_moe = timed(phase_ssm_moe_serve, dev)
    matmul_timing = timed(phase_matmul_kernels, dev, plans)
    measured = timed(phase_measured, dev)
    offline = timed(phase_offline, dev)
    train_timing = timed(phase_train_kernels, dev)
    timed(phase_train_card_vs_cpu, dev)
    train = timed(phase_train_full, dev)
    rocoin = timed(phase_lm_rocoin, dev)
    ssm_train_timing = timed(phase_ssm_train_kernels, dev)
    timed(phase_ssm_train_card_vs_cpu, dev)
    ssm_train = timed(phase_ssm_train_full, dev)
    new_worst = timed(phase_vlm_encdec_kernels, dev)
    timed(phase_vlm_encdec_card_vs_cpu, dev)
    vlm_encdec = timed(phase_vlm_encdec_full, dev)["launches"]
    mesh = timed(phase_mesh, dev, {
        ("llama3.2-1b", "train"): (train["step_ms"],
                                   train["profile"].get("busy_ms")),
        ("llama3.2-1b", "prefill"): (lm["prefill"]["wall_ms"],
                                     lm["prefill"].get("busy_ms")),
        ("mamba2-130m", "train"): (
            ssm_train["mamba2-130m"]["step_ms"],
            ssm_train["mamba2-130m"]["profile"].get("busy_ms")),
        ("mamba2-130m", "prefill"): (
            ssm_moe["mamba2-130m"]["prefill"]["wall_ms"],
            ssm_moe["mamba2-130m"]["prefill"].get("busy_ms"))})["launches"]
    for k, v in mesh.items():
        vlm_encdec[k] = vlm_encdec.get(k, 0) + v
    ranks = timed(phase_tp_ranks, dev)
    tp = timed(phase_tp, dev, ranks)
    moe_tp = timed(phase_moe_tp, dev, ranks)
    ssm_tp = timed(phase_ssm_tp, dev, ranks)
    vlm_encdec_tp = timed(phase_vlm_encdec_tp, dev, ranks)
    tp_train = timed(phase_tp_train, dev, ranks)
    moe_train = timed(phase_moe_train, dev, ranks)
    for k in TP_KERNELS:
        vlm_encdec[k] = (vlm_encdec.get(k, 0) + tp["launches"][k]
                         + moe_tp["launches"][k] + ssm_tp["launches"][k]
                         + vlm_encdec_tp["launches"][k])
    for k in SSM_TRAIN_KERNELS:
        vlm_encdec[k] = (vlm_encdec.get(k, 0) + tp_train["launches"][k]
                         + moe_train["launches"][k])
    for name, e in (*tp["worst"].items(), *vlm_encdec_tp["worst"].items(),
                    ("ssd_scan", ssm_tp["worst"])):
        lm_timing[name]["max_abs_err"] = max(lm_timing[name]["max_abs_err"],
                                             e)
    for phase in (tp_train, moe_train):
        new_worst = {k: max(v, phase["worst"].get(k, 0.0))
                     for k, v in new_worst.items()}
        for k, v in phase["worst"].items():
            new_worst.setdefault(k, v)
    train_launch = {k: train["launches"].get(k, 0)
                    + rocoin["launches"].get(k, 0)
                    + ssm_train["launches"][k] + vlm_encdec.get(k, 0)
                    for k in SSM_TRAIN_KERNELS}
    for name, e in new_worst.items():
        timing_of = train_timing if name in TRAIN_SOURCES else lm_timing
        timing_of[name]["max_abs_err"] = max(timing_of[name]["max_abs_err"],
                                             e)
    for entry in (kernel, decode):
        entry["launches"] += measured["launches"][entry["name"]]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   measured["max_abs_err"][entry["name"]])
    kernel["launches"] += offline["launches"]
    matmul_timing["dequant_matmul"]["max_abs_err"] = max(
        matmul_timing["dequant_matmul"]["max_abs_err"],
        measured["max_abs_err"]["dequant_matmul"])
    matmul_kernels = [dict(name=name, route="cuda",
                           source=MEASURED_SOURCES[name],
                           replaces=MEASURED_TPU[name],
                           launches=measured["launches"][name],
                           **{k: matmul_timing[name][k] for k in (
                               "max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")})
                      for name in MEASURED_SOURCES]

    sources = {**LM_SOURCES, **SSM_MOE_SOURCES}
    tpu = {**LM_TPU, **SSM_MOE_TPU}
    lm_kernels = [dict(name=name, route="cuda", source=sources[name],
                       replaces=tpu[name],
                       launches=lm["launches"][name]
                       + ssm_moe["launches"][name],
                       **{k: lm_timing[name][k] for k in (
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms", "device_ms")
                          if k in lm_timing[name]})
                  for name in LM_KERNELS]
    for entry in lm_kernels:
        entry["launches"] += (train_launch.get(entry["name"], 0)
                              if entry["name"] in SSM_TRAIN_KERNELS
                              else vlm_encdec.get(entry["name"], 0))
    train_kernels = [dict(name=name, route="cuda",
                          source=TRAIN_SOURCES[name],
                          replaces=TRAIN_REPLACES[name],
                          launches=train_launch[name],
                          **{k: train_timing[name][k] for k in (
                              "max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "device_ms")})
                     for name in TRAIN_SOURCES]
    ssm_train_kernels = [dict(name=name, route="cuda",
                              source=SSM_TRAIN_SOURCES[name],
                              replaces=SSM_TRAIN_REPLACES[name],
                              launches=train_launch[name],
                              **{k: ssm_train_timing[name][k] for k in (
                                  "max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "device_ms",
                                  "autograd_ms", "route_bound_ms")})
                         for name in SSM_TRAIN_SOURCES]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [kernel, decode] + lm_kernels
                      + matmul_kernels + train_kernels
                      + ssm_train_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
