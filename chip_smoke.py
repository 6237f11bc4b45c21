#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py        (from the root of a checkout; needs one CUDA card)
    python3 chip_smoke.py --k3-draws 0:64      (K3's bf16 check alone on those draws)
    python3 chip_smoke.py --dp-rank RANK PORT DIR   (one of phase 20.3's two ranks; phase 20
                                                     starts them itself)
    python3 chip_smoke.py --routing     (phase 16.1 alone: K1's routing at every head dim)
    python3 chip_smoke.py --matcher     (phases 21.1-21.2 alone: both matcher kernels)

Phases, each printing its own line; the first failure exits non-zero with no
result:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``explainable_spatial_vqa_tpu_torch/csrc`` with
   ``nvcc`` into ``explainable_spatial_vqa_tpu_torch/_build/``; for each
   kernel function its registers and spills (ptxas) and its HGMMA (wgmma)
   and HMMA (mma.sync) instructions (``cuobjdump -sass``): the attention
   kernels must hold HMMA, the block GEMM HGMMA in bf16 and in float32
   (``gemm_tf32_wgmma``, 3xTF32), and ptxas's notes on serialized wgmma are
   printed, and the one-pass K1 kernel's on a line of its own; K1 must be
   built, every function with HMMA, at every head dim of ``EXACT_HEAD_DIMS``
   (every multiple of 8 up to 128), the one-pass kernel at each up to 64,
   and the padded kernels (every other head dim up to 256) at every depth of
   ``PADDED_DEPTHS``, each on a line of its own; the head-dim-256 kernels
   (``attention_wide.cuh``: ``attention_kernel_split_f32`` to float and bf16
   with HMMA, ``attention_kernel_wgmma`` with HGMMA) on a line of their own;
   the deep float32 kernel (every head dim of 257-512:
   ``attention_kernel_deep_f32``) at each padded depth past 256 in K1's
   library and at head dims 384 and 512 in the block library, the short
   kernels (``attention_kernel_short[_f32]``, L <= 16) at every padded depth
   past 128 in K1's and at 256-512 in the block library's, the one-pass
   wgmma kernels at every padded depth past 128 (``attention_kernel_wgmma``
   to 256, ``attention_kernel_wgmma_deep`` past it, K3's at 384 and 512 in
   the block library), the two-pass wgmma kernel past depth 128
   (``attention_kernel_wgmma_2pass_deep``, with and without the narrow
   copies) at every padded depth past 128 (K3's at 256-512 in the block
   library), and K1's C library's head-dim ceiling equal to
   ``MAX_HEAD_DIM``; the build's wall time beside the parent's and the
   single-unit build's and each translation unit's (K1's head dims and
   padded depths, and the block library's attention at each head dim,
   compile in units of their own, all started together); the SASS is listed
   while phases 3-4 run, and its checks print after them
   (``kernel_checks``);
3. each kernel against its plain PyTorch version on the card, in bf16 and in
   float32 (TF32 off), with each error beside its tolerance: K1, whose bf16
   outputs are held by ``attention_agreement`` (against float64 scores and
   softmax, weights rounded to bf16: any float32 score order passes), with
   beside it ``esv_attention_fma_scores`` (its scores in FMA chains on the
   CUDA cores, a variant no wrapper launches) held the same way on three
   L=210 draws and at L=10 (the shipped tensor-core form fails the phase if
   it misses a draw; the other's verdict is printed), both timed through the
   same call, by events and by the kernel's device time; K1 at head dims
   24, 48 and 64 at the models' lengths and where the bf16 paths split
   (``k1_head_dims``: L = 8, 17, 208, 224, 225, 243, 246, 256, 257, both
   types; each call's kernel function read from the C library's launch
   counts and held to ``K1_CHECK_LENGTHS``'s, the two-pass wgmma kernel at
   L=257 also named by a profile), and at every other head dim
   (``K1_NEW_DIMS``) at L = 8, 16, 17, 208, 256, 257, masked and not, both
   types, each call's kernel read the same way; then checked the same way
   and timed at each model's shape and, at each other head dim, at the
   protocol's shapes at d_model 4 D (the fusion encoder, L=208, in both
   types; the box decoder, L=8), the one-pass kernel and the wgmma kernel
   named by a profile at their bf16 shapes (the ring they replaced is
   timed beside them by ``measure/attention_variants.py``'s variant
   ``ring``); K1 on
   the padded kernels (``k1_padded_dims``) at ``K1_PADDED_DIMS`` (ragged
   head dims and 136-256, one or more at each padded depth) at L = 8, 17,
   208 and 1025, and every K1 kernel past the old 1024-key cap at
   ``K1_LONG_ROWS`` (1025 and 4096 keys; float32 within ``k1_f32_tol``),
   then checked and timed at ``K1_NEW_SHAPES`` (the protocol at d_model 100
   and 1024, serving at 1024, rows of 1025 and 4096 keys); the head-dim-256
   kernels (``wide_kernels``) at ``WIDE_DIMS`` (256, and 232 with zero
   columns), bf16 at L = 17, 64, 208, 210, 224, 256 and float32 at 208,
   1025, 4096, ragged and unmasked, in K1's layout and (at 256) K2's and
   K3's strided (B, L, 3d) buffer through ``esv_block_attention``, each
   call's kernel read from the C libraries' counts, then timed at
   ``measure/attention_variants.py``'s ``WIDE_CASES`` beside the plain
   version, SDPA and the bound (the padded kernels they replace are timed
   beside them by that driver's variant ``padded``); the bf16 wgmma kernels
   at head dims up to 128 (``wgmma_kernels``): ``attention_kernel_wgmma`` at
   D = 72-128 (every multiple of 8) and L = 17, 208, 224, 256,
   ``attention_kernel_wgmma_2pass`` at D = 8, 64, 72, 128 and L = 257, 1025,
   4096, ragged and unmasked, in K1's layout and a (B, L, 3d) buffer's,
   none on the ring (the C libraries' counts), a negative control (the
   weights rounded before they are normalised, ``rounded_first``) that
   must fail the bf16 check, and K3's attention at head dim 128 (L = 224
   and 304) timed; the deep kernels (``deep_kernels``) at ``DEEP_DIMS`` (a
   head dim or more at each padded depth past 256) and L = 8, 16, 17, 208,
   256, 1025 and MAX_LEN in both types, K2's and K3's attention at head
   dims 384 and 512 in the (B, L, 3d) buffer, K1 on a buffer's strides, a
   negative control that must fail the bf16 check, and ``DEEP_TIMED``
   (phase 24's shapes) timed beside the plain version, SDPA (its backend
   named by a profile) and the bound; ``attention_kernel_wide_f32``
   (``f32_wide_kernels``: float32 past 16 keys at the padded depths 160-224
   and 288-512) at ``F32_WIDE_DIMS`` (a head dim or more at each of those
   depths) and L = 17, 208, 256, 257, 1025 and 4096, ragged and unmasked,
   K2's attention at head dims 384 and 512 on the (B, L, 3d) buffer's
   strides, a negative control (one TF32 pass) that must miss the float32
   tolerance, and ``F32_WIDE_TIMED`` (d_model 768's and 1280's float32
   fusion encoders) timed the same way; the wgmma kernels past depth 128
   (``wgmma_padded_kernels``: one pass up to 256 keys, two past them on
   ``attention_kernel_wgmma_2pass_deep``) at ``WGMMA_PADDED_DIMS`` (a head
   dim or more at every padded depth 160-512) and L = 17, 64, 208, 224,
   256, 257, 1025 and 4096 (256 too past 256 keys), ragged and unmasked,
   and, in rows that are not whole 16-byte chunks (the producer's narrow
   copies), at ``WGMMA_NARROW_DIMS`` (odd and even head dims at every
   padded depth 160-512) and L = 17, 208, 256, 257, 1025, on a buffer's
   strides at 208 and 1025 keys, K3's attention at head dim 256 past 256
   keys, no call on ``attention_kernel_padded``, a negative control, and
   ``WGMMA_PADDED_TIMED`` (d_model 768's and 1280's
   fusion encoders, K3's attention at d_model 2048) timed the same way; the
   short kernels (``short_kernels``) at ``SHORT_DIMS`` (a head dim at every
   padded depth past 128) and L = 8, 10, 16 in both types, K2's and K3's
   attention at head dim 256 on 8 and 10 keys, and ``SHORT_TIMED`` (the d
   768 and 1280 box decoders) timed with the device time by profile (as
   are ``DEEP_TIMED`` and ``WGMMA_PADDED_TIMED``); K2's own float32
   attention on the (B, L, 3d) projection buffer (3xTF32); the block
   GEMM alone (``block_gemm``) at K2's four product shapes, in bf16 and in
   float32 (3xTF32), with a negative control for the float32 tolerance (one
   TF32 pass, ``torch.matmul`` with TF32 on, must miss it); K2 at the fusion
   encoder's shape on the draws ``BLOCK_DRAWS``; K3 at the block bench's
   (L=224, ``batch_tile=2, ffn_chunks=2``) on ``K3_DRAWS``; both again at
   head dim 256 (``BLOCK_HD256``: d_model 1024, 4 heads, ffn 4096) and 512
   (``BLOCK_HD512``: d_model 2048, 4 heads, ffn 8192) on ``BLOCK_DRAWS``,
   K3's exact q/k/v held there too.  In bf16, every
   element and the mean error are held (``bf16_agreement``), and each block
   kernel's check has a negative control that must fail it: the other block
   kernel's plain version (K3 rounds q, k and v to bf16, K2 keeps them
   float32); K3's own q, k and v must equal its plain version's (``k3_qkv``,
   which also prints how far its compensated sums lie from the exact ones);
   each block also takes a float32 x with its bf16 weights (x rounded to
   bf16 in a pass of its own); K2 also at the Transformer IQAP's encoder
   shape at d 512 (B=64, L=243, no mask, ``K2_IQAP_SHAPE``) and at
   ``HierarchicalGenerator``'s (B=128, L=196, no mask, ``K2_HIER_SHAPE``);
4. times at those shapes: kernel, plain version, one PyTorch library call
   computing the same function (a yardstick the port never calls), and the
   least time the card could take (its bound: ``bound_ms``, ``dot_ops``);
   K1 at the box decoders' shapes through its wrapper beside the kernel's
   device time and SDPA (``k1_wrapper_times``);
5. the block-bench path: ``bench_block.main`` at B=128, which launches K3
   through its entry point beside K2 and the unfused ``EncoderBlock``, at
   L=224 and at 304 (K3's attention on ``attention_kernel_wgmma`` and on
   ``attention_kernel_wgmma_2pass``, by the block library's counts);
6. the main path at full width (bench.py's widths, bf16, ``box_roi`` and
   per-function thresholds): ``InferencePipeline.run`` end to end through the
   128-slot pool on synthetic questions, timed over a few repeats.  The
   generator's random weights emit programs that mostly do not parse, so the
   generator runs at its full cost and the pipeline is handed the synthetic
   CLEVR-shaped programs, which it decodes, parses and executes.  Checks every
   program and answer and that the kernels carried the executor; then one
   more run under ``torch.profiler`` for the card's busy share, the host's
   waits on the card and the kernels by device time;
7. the same pipeline in the ``"sorted"`` (the default) and ``"bucketed"``
   chain modes: questions/s over the same repeats and how many answers agree
   with the pool's;
8. one float32 executor forward on the card against the same module on the CPU;
9. the chain modes in float32 on 64 of the questions: ``"sorted"``,
   ``"bucketed"`` and ``"pool"`` must give equal answers;
10. the ``executor_roi_sim_count`` configuration (``roi_sim`` with 4 match
    maps and ``count_embed``, random non-zero weights): a float32 forward on
    the card against the CPU, and one ``"sorted"`` pipeline run in bf16;
11. generator training: the ``generator`` preset at full width, bf16, batch
    64, on ``bench_data``'s questions and programs: ms per step, and the
    loss of one fixed batch after 25 updates below 0.8 of its first;
12. executor training: ``executor_roi`` at full width, bf16, through
    ``executor_pipeline_from_arrays`` and ``Trainer.fit`` for one epoch (K1
    and K2 launch in no train forward, and 3 and 2 times in each
    validation forward); ms per step at batch 16 and 128 in parts
    (forward, loss, the matcher's host round trip, backward, optimizer) and
    the peak memory; a fixed batch's loss below 0.8 of its first within 40
    updates; an eval forward after a step equal, bit for bit, to a fresh
    module's loaded with the stepped weights;
13. one float32 training step of ``executor_roi`` and ``generator`` on the
    card against the CPU: loss, every gradient, the assignments;
14. evaluation at full width, bf16: ``beam_generate`` at beam 4 on 512
    questions (beam 1 equal to ``generate`` up to its first <END>; in
    float32 each beam's score its tokens' log-probability); ``evaluate_executor_steps`` over
    800 executor steps (K2 3 and K1 2 launches per forward); ``run_tally``,
    the CLI's ``tally`` on arrays, on 512 ``synth_annotated`` questions with
    per-function calibration (a chain run, the map, a second run gated by
    it; each run's wall time and launches per forward); then in float32 on
    64 questions, with phase 12's trained executor (whose boxes match some
    ground truth: the phase fails without a true positive, and prints the
    functions whose threshold moved off the grid's first), the first chain
    run's decisions and the threshold map on the card equal to the CPU's;
15. scheduled training: ``executor_scheduled`` at full width, bf16, batch
    16, through ``executor_scheduled_pipeline_from_arrays`` and
    ``Trainer.fit`` for one epoch at ``p_sample`` 0.5; the K2 and K1
    launches of one train step (3 and 2 per chained position, none in the
    loss pass); the step's parts (the chained pass, the loss forward,
    backward, optimizer), peak memory and busy share; the chained pass after
    an optimizer step equal, bit for bit, to a fresh module's; a fixed
    batch's loss below 0.8 of its first within 30 updates; one float32 step
    at p=1 on the card against the CPU;
16. the CoGenT A->B protocol (``run_cogent_protocol``, float32): eval
    forwards of the protocol's executor at every d_model of 4 heads of a K1
    head dim with kernels of its own (32 to 480: head dims 8 to 120) and of
    ``K1_ROUTING_PADDED`` (d_model 100 to 768: head dims 25 to 192) launch K1
    once per fusion and box-decoder layer and no K2, at 512 and 1024 K2 and
    K1, the C libraries' counts naming the padded kernels at every head dim
    without kernels of its own; the protocol at its flagship
    width (d_model 192, 3 layers, ``box_roi``, cosine; an eighth of the CLI's steps) with each part's wall
    time, the median ms per train step, its K1 launches (in the
    evaluations only), the four cells and accuracy by
    type; its fine-tuned models evaluated on valA on the card (K1 at head
    dim 48) and on the CPU, equal; the protocol at d_model 512, whose evaluations launch K2 and
    K1, and its fine-tuned models on valA, card against CPU, equal;
17. the baselines (``baselines``) on the CLEVR factory's questions and
    chains: ``eval-iqap``'s path (``run_eval_iqap``, ``transformer_iqap``,
    bf16 and float32: questions/s, encode and decode apart, kernels per
    decode step, busy share; K1 once per encoder layer, head dim 64) and
    float32 card vs CPU; ``infer-chain``'s
    path (``Seq2SeqChainRunner.run`` and ``run_bucketed_seq2seq``,
    ``step_seq2seq``: chains/s, encodes and decode steps; K1 once per
    encoder layer of each encode) and float32 runs
    equal to each other and to the CPU; both at d 512, where each encode
    launches K2 once per layer, each block held against K2's plain version,
    and their float32 decisions card vs CPU; one train step each of
    ``transformer_iqap``, ``lstm_iqap`` and ``step_seq2seq`` (ms, peak
    GiB, kernels per step, a fixed batch's falling loss; each family built
    and stepped under global generators seeded for it, ``own_rng``, as
    phase 18's fixed batches are, so that no phase before changes them);
18. the chain-of-thought IQAP and the prototype step models
    (``cot_and_prototypes``) on the CLEVR factory's questions, in memory:
    ``transformer_iqap_cot`` (a bf16 train step at batch 64: ms, peak GiB,
    kernels, busy share; a fixed batch's falling loss; a float32 step card
    vs CPU, loss and gradients; the greedy decode of the combined sequence
    and its IoU report, float32 tokens card vs CPU); each of the eight
    prototype presets (a bf16 step at its batch, a falling fixed batch, a
    float32 loss card vs CPU, an eval forward's launches: K1 four times in
    ``hierarchical`` at its preset's head dim 64, none elsewhere; the CoT's
    decode K1 once); ``HierarchicalGenerator`` at d 512 (head dim
    128), whose eval forward launches K2 once per encoder layer and K1 once
    per decoder layer (the one-token start query), each held against its
    plain version, float32 card vs CPU, and whose train step launches
    neither; K2 at its encoder shape (``K2_HIER_SHAPE``) in phases 3-4;
19. data preparation (``data_prep``) on seeded uint8 320x480 images in
    memory: ``cubic_resize`` (the JAX package's antialiased Keys cubic) on
    the card against the CPU, down to 224x224 and up 20x30 -> 32x32; the
    ResNet-101 stage-3 extractor at full depth in float32 (TF32 off, as the
    CLI runs it), seeded random weights scaled as tests/test_vision.py
    scales them, card against CPU on 2 images; images/s of
    ``extract_to_sink`` (the loop of ``extract_features``, copies both ways)
    at batch 128, median of 5 runs, beside the bound from the convolutions'
    operations, peak GiB and the busy share of one profiled batch; the
    forward alone in float32, with cuDNN's TF32 allowed and in bf16; the
    first batch's features as (128, 196, 1024) tokens through ``run_tally``
    on 512 CLEVR-factory questions (``executor_roi``, bf16, per-function
    calibration: K2 3 and K1 2 launches per forward), and in float32 with
    phase 12's trained executor, card against CPU;
20. the last module slice (``last_slice``): the native CLEVR engine (built
    with g++ in phase 2) against the Python executor on phase 17's 512
    questions, both timed in alternating rounds, the engine's packing, C
    call and decoding apart; one rank over NCCL: the data-parallel
    ``Trainer`` step of ``executor_roi`` (full width, batch 16, float32)
    equal to the plain step, its validation forward on K2 and K1,
    ``run_pool`` on a one-rank mesh (bf16 and float32) and ``run_tally``
    through ``--data_parallel``'s path equal to unsharded; two ranks
    sharing the card over gloo (this script started twice with
    ``--dp-rank``): the sharded float32 ``run_pool`` against the one-rank
    decisions, a data-parallel step of 2 x 8 rows against the 16-row step
    (float32: the loss, with the ReLU inputs that cuBLAS rounds otherwise at
    8-row batches counted; float64 compute: loss, gradients and parameters
    within 1e-6); ``ops.lowp``'s serving opt-in off and on (questions/s,
    equal decisions, launches per forward); a ``utils.profiling`` trace
    that must name its ``annotate`` regions and the ``esv::`` kernels;
21. the matcher kernel and the demos (``demos``): 21.1
    ``csrc/hungarian.cu`` (JAX's in-jit exact matcher) against its plain
    version on 10,240 problems at five (Q, T) shapes, half of them with
    tied optima (equal assignments; matched costs at scipy's optimum), a
    call under ``torch.cuda.set_sync_debug_mode("error")`` (no host
    synchronisation; scipy's round trip, the control, must raise), times at
    B=64 (Q=T=8, the demos' steps) and B=16, 128, 2560 (Q=T=10) beside the
    plain version, scipy's host round trip and the bytes bound; the same for
    the block kernel (one block a problem, m + 1 > 32;
    ``block_matcher_kernel``): against its plain version at
    ``BLOCK_MATCHER_SHAPES`` (32x32 to 300x300, a third of the problems
    tied integers and a third integers with NaNs; the C library's counts
    showing the block kernel ran), once with its state in global memory,
    under the sync check too, and timed at (B, Q, T) = (64, 32, 32), (64,
    100, 100), (2, 300, 300); 21.2 one
    ``executor_roi`` train step at full width, bf16, batch 16 and 128, with
    ``matcher="auto"`` (the kernel) and ``"hungarian"`` (scipy), in
    alternating rounds, with the host's waits per step and a falling fixed
    batch; then ``executor_roi`` with 40 queries (``wide_queries_step``:
    its step launches the block kernel, its loss is finite and its fixed
    batch's falls); 21.3 ``demos.accuracy_table`` at d_model 512 (K2 and K1 in its
    chain runs, one matcher launch per executor step) with its section
    printed, its trained executor's float32 predicted-chain decisions card
    vs CPU, and every other demo of ``demos/`` once at a reduced size;
22. the measurement drivers (``measurement_drivers``), in this process: the
    port bench (``python -m explainable_spatial_vqa_tpu_torch.bench``) in the
    ``pool`` and ``sorted`` modes at ``BENCH_N`` 1024 (each run's
    float32 baseline on 4 questions, ``BENCH_BASELINE_N``), then
    ``measure.profile_pipeline``, ``profile_segments``,
    ``mfu_decomposition`` and ``roofline_step`` at their defaults, each
    driver's output printed; each last line parses with its driver's keys,
    times are finite and positive, 0 < MFU <= 1, no program is truncated,
    and K1 and K2 launch in each bench run and K3 in none;
23. the paths at the head dims without kernels of their own (``new_widths``):
    ``run_cogent_protocol`` as ``cogent-protocol --d_model 100`` and
    ``--d_model 1024`` run it (float32, ``NEW_WIDTH_PROTOCOL``'s sizes and
    steps): K1 on the padded kernel at head dim 25 and the short kernel at
    256 (the box decoders' 8 keys), K2 at 256 with its attention on
    ``attention_kernel_split_f32``, no self-attention K1 takes on the plain
    path, valA card vs CPU equal; bf16 serving (``InferencePipeline.run``)
    with the executor at d_model 1024, questions/s: K2 3 and K1 2 launches a
    forward, K2's attention on ``attention_kernel_split_f32``; the block
    bench at d_model 1024, K2's and K3's ms, K3's attention on
    ``attention_kernel_wgmma``: the head-dim-256 and short kernels' launches
    by the C libraries' counts;
24. the paths past head dim 256 (``past_256``): bf16 serving
    (``InferencePipeline.run``) with the executor at d_model 2048 (4 heads
    of 512), questions/s, K2 3 and K1 2 launches a forward;
    ``run_cogent_protocol`` as ``cogent-protocol --d_model 1536`` runs it
    (float32, 4 heads of 384), valA card vs CPU equal; an executor eval
    forward at d_model 1100 (4 heads of 275, no K2) in float32 (card vs CPU)
    and bf16, K1 on every fusion and box-decoder layer; the block bench at
    d_model 2048: K2's attention on ``attention_kernel_wide_f32``, the
    float32 fusion layers' K1 at d 1100 (rows of 1100 bytes) on
    ``attention_kernel_deep_f32``, the bf16 ones' and K3's attention on
    ``attention_kernel_wgmma_deep``, the box decoders on the short kernels,
    by the C libraries' counts, no eligible self-attention on the plain
    path;
25. the one-pass wgmma kernels past depth 128 on the executor
    (``wgmma_padded_paths``): bf16 serving (``InferencePipeline.run``) with
    the executor at d_model 768 (4 heads of 192) and 1280 (4 heads of
    320), questions/s, no K2, K1 on every fusion layer on
    ``attention_kernel_wgmma`` and ``attention_kernel_wgmma_deep`` and on
    the box decoder on the short kernel by the C library's counts, no
    eligible self-attention on the plain path; then one float32 executor
    eval forward at each width, card vs CPU, K1's fusion layers on
    ``attention_kernel_wide_f32`` and its box decoder on
    ``attention_kernel_short_f32``.

The line before the last is a JSON object with one entry per kernel
(``kernels``: K1, K2, K3 and the matcher, with its launches on the main path
(the matcher's: phase 21.3's accuracy table) and, under
``launches_by_path``, on phases 14-22's paths; the block matcher
(``hungarian_assignment_device_block``) with its launches in 21.2's
40-query run and its times under ``at_shapes``; K2's entry also holds its
times at the IQAP's and ``HierarchicalGenerator``'s encoder shapes under
``at_shapes``; the padded kernels at the ragged head dims and at 136-256
(``fused_attention_padded_ragged``, ``_wide``) and K2 and K3 at head dim 256
(``fused_encoder_block_hd256``, ``fused_encoder_block_tiled_hd256``), with
their launches on phases 16.1 and 23's paths, the head-dim-256 kernels
(``attention_kernel_split_f32``: K2's attention at d 1024, L=210;
``attention_kernel_wgmma``: K3's at L=224; K1's layout under
``at_shapes``) with their launches on phase 23's paths
by the C libraries' counts, and K1's rows past 1024 keys
under ``long_rows``; the deep float32 kernel (``attention_kernel_deep_f32``: K1
at d 1100's float32 fusion encoder;
``attention_kernel_wgmma_2pass_deep``: a 1025-key row at D = 512, D = 256
under ``at_shapes``, its launches K3's in phase 24.4's block bench at L =
304, ``off_path``: no model sends such rows), ``attention_kernel_wide_f32`` (K2's attention at d 2048, at
d 1536 and K1's float32 fusion encoders at d_model 544, 768 and 1280 under
``at_shapes``, its launches on phases 24 and 25's paths) and K2 and K3 at
head dim 512 (``fused_encoder_block_hd512``,
``fused_encoder_block_tiled_hd512``) with their launches on phase 24's
paths; the one-pass wgmma kernels past depth 128
(``attention_kernel_wgmma_past_depth_128``: d_model 768's fusion encoder;
``attention_kernel_wgmma_deep``: K3's attention at d 2048, d_model 1280's
and 1100's under ``at_shapes``) with their launches on phases 24.3, 24.4
and 25's paths; the short kernels (``attention_kernel_short``: serving's
d 2048 box decoder, the d 768-1280 ones under ``at_shapes``;
``attention_kernel_short_f32``: the d 1536 protocol's) with their launches
on phases 23-25's paths;
then K1 at every head dim below 128 (``fused_attention_d{D}``),
each at its first model's encoder shape (the protocol's fusion encoder at
d_model 4 D for the head dims no preset has) with the rest under
``at_shapes`` and its launches through the models by phase, which must not
be 0; then K1's one-pass kernel,
``fused_attention_onepass``, at the Transformer IQAP's encoder shape with
the other bf16 shapes under ``at_shapes`` and its launches through the
models by phase, as the C library counted them, which must not be 0) and
one per piece timed apart
(``parts``: K2's float32 attention and four products, and the tensor-score
variant); before it, the seconds each phase took; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent

# four K2 products at the fusion encoder's shape (B=128, L=210, d=512, ffn
# 2048): name, N, K, ReLU, output type (bf16 for FFN1's hidden)
K2_GEMMS = (("qkv", 1536, 512, False, "fp32"), ("out", 512, 512, False, "fp32"),
            ("ffn1", 2048, 512, True, "bf16"), ("ffn2", 512, 2048, False, "fp32"))
GEMM_REL_TOL = 2e-5  # float32 GEMM outputs, of the largest |ref|

# seeds of the blocks' inputs (block_inputs): bf16 on each, float32 on the
# first.  K3 also takes (0, 1184), seed 0's stream from offset 1184: on it
# K3's q/k/v, rounded from compensated float32 sums, put one output an ulp
# outside the bf16 check, and so did the plain arithmetic on those q/k/v
# (PERF.md §6); correctly rounded q/k/v pass.
BLOCK_DRAWS = (0, 1, 2)
K3_DRAWS = BLOCK_DRAWS + ((0, 1184),)

# K1 at the head dims below 128: each in both types at the lengths the models
# run (phase 3, B=128, H=4), then timed at each model's shape in its type
# (phase 4): label, head dim, B, L, key mask, type
# The bf16 paths split at 16 (one warp), 256 (the one-pass kernels' longest
# row) and 257 (the two-pass kernel): the lengths around each and at the
# models' rows, with the kernel function each bf16 call must launch (read
# from the C library's launch counts; float32 takes attention_kernel_f32 at
# every length)
ONE_PASS, RING = "attention_kernel_onepass", "attention_kernel"
PADDED, PADDED_F32 = "attention_kernel_padded", "attention_kernel_padded_f32"
# the float32 padded kernel past depth 256 (csrc/attention_padded.cuh): the
# head dims of 257-512 in rows that are not whole 16-byte chunks (D = 275)
DEEP_F32 = "attention_kernel_deep_f32"
# and its short kernels: rows of at most 16 keys past padded depth 128 (the
# box decoders at d_model 768-2048; K2's and K3's attention at 256-512)
SHORT, SHORT_F32 = "attention_kernel_short", "attention_kernel_short_f32"
# csrc/attention_wide.cuh: the head dims at padded depth 256 past 16 keys
# (split_f32, float32 rows of whole 16-byte chunks), bf16 of 17-256 keys at
# head dims 72-128 and, in rows of any width, at padded depths 160-256
# (wgmma) and 288-512 (wgmma_deep), and bf16 at every multiple of 8 up to
# 128 past 256 keys (2pass)
SPLIT_F32, WGMMA = "attention_kernel_split_f32", "attention_kernel_wgmma"
WGMMA_DEEP = "attention_kernel_wgmma_deep"
# csrc/attention_f32_wide.cuh: float32 rows of whole 16-byte chunks past 16
# keys at the padded depths past 128 but 256 (the padded and deep float32
# kernels keep the other rows)
WIDE_F32 = "attention_kernel_wide_f32"
WIDE_F32_DEPTHS = (160, 192, 224, 288, 336, 384, 448, 512)
WGMMA_2PASS = "attention_kernel_wgmma_2pass"
# bf16 past 256 keys at the padded depths past 128, rows of any width (K3's
# attention at 256-512 too): the padded and deep bf16 kernels before
WGMMA_2PASS_DEEP = "attention_kernel_wgmma_2pass_deep"
WGMMA_DEPTHS = (80, 96, 112, 128, 160, 192, 224, 256)  # attention_kernel_wgmma's padded depths
WGMMA_DEEP_DEPTHS = (288, 336, 384, 448, 512)  # attention_kernel_wgmma_deep's
WGMMA_2PASS_DEPTHS = (16, 32, 48, 64, 80, 96, 112, 128)  # and the two-pass kernels'
WGMMA_2PASS_DEEP_DEPTHS = WGMMA_DEPTHS[4:] + WGMMA_DEEP_DEPTHS
K1_CHECK_LENGTHS = ((8, False, RING), (17, True, ONE_PASS), (208, True, ONE_PASS),
                    (224, False, ONE_PASS), (225, True, ONE_PASS), (243, True, ONE_PASS),
                    (246, True, ONE_PASS), (256, False, ONE_PASS), (257, True, WGMMA_2PASS))
# head dim and length where phase 3 also names the two-pass kernel from a profile
TWO_PASS_PROFILE = (64, 257)
# every bf16 shape here must launch the one-pass kernel, named by its launch
# count and by a profile in phase 4
K1_MODEL_SHAPES = (
    ("protocol d 96 box decoder", 24, 128, 8, False, "fp32"),
    ("protocol d 96 fusion encoder", 24, 128, 208, True, "fp32"),
    ("protocol d 192 box decoder", 48, 128, 8, False, "fp32"),
    ("protocol d 192 fusion encoder", 48, 128, 208, True, "fp32"),
    ("transformer_iqap encoder", 64, 512, 243, False, "bf16"),
    ("step_seq2seq encoder", 64, 512, 246, True, "bf16"),
    ("hierarchical encoder", 64, 32, 196, False, "bf16"),
    ("protocol d 192 fusion encoder bf16", 48, 128, 208, True, "bf16"),
)
# K1 at the head dims no preset has (every other multiple of 8 up to 128):
# phase 3 holds each at these lengths (L <= 16 one warp, 17-256 one pass:
# attention_kernel_onepass at D <= 64, attention_kernel_wgmma past it; 257
# attention_kernel_wgmma_2pass), masked and not, in both types, at B =
# K1_NEW_DIM_BATCH (wgmma_kernels also holds the wgmma kernels at 17, 224,
# 256 and past 256 keys, in a (B, L, 3d) buffer too); phase 4 times each at
# the protocol's shapes at d_model 4 D: the box decoder (L=8, float32) and
# the fusion encoder (B=128, L=208, ragged) in float32 and bf16
K1_MODEL_DIMS = (24, 48, 64)
K1_NEW_DIMS = (8, 16, 32, 40, 56, 72, 80, 88, 96, 104, 112, 120)
K1_NEW_DIM_LENGTHS = (8, 16, 17, 208, 256, 257)
K1_NEW_DIM_BATCH = 32
K1_MODEL_SHAPES += tuple(
    shape for d in K1_NEW_DIMS for shape in (
        (f"protocol d {4 * d} fusion encoder", d, 128, 208, True, "fp32"),
        (f"protocol d {4 * d} box decoder", d, 128, 8, False, "fp32"),
        (f"protocol d {4 * d} fusion encoder bf16", d, 128, 208, True, "bf16")))


def wide_kernel(d_head: int, length: int, name: str):
    """The ``attention_wide.cuh`` or ``attention_f32_wide.cuh`` kernel a
    call of type ``name`` at a head dim without kernels of its own launches
    (``launch_attention_padded``'s ``wide_takes``), or None where the padded
    kernels keep it: past 16 keys at a padded depth past 128, bf16 in rows
    of any width (up to 256 keys the one-pass wgmma kernel, past depth 256
    as ``attention_kernel_wgmma_deep``; past 256 keys
    ``attention_kernel_wgmma_2pass_deep``), float32 in rows of whole 16-byte
    chunks (with aligned bases and strides, as the wrappers' tensors are:
    the head dims that are multiples of 4) at any length,
    ``attention_kernel_split_f32`` at depth 256 (228-256) and
    ``attention_kernel_wide_f32`` at every other depth."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import padded_depth

    depth = padded_depth(d_head)
    if depth <= 128 or length <= 16:
        return None
    if name == "bf16":
        return WGMMA_2PASS_DEEP if length > 256 else WGMMA_DEEP if depth > 256 else WGMMA
    if d_head * 4 % 16:
        return None
    return SPLIT_F32 if depth == 256 else WIDE_F32


def short_kernel(d_head: int, length: int, name: str):
    """The short kernel a call of type ``name`` at a head dim without
    kernels of its own launches (``launch_attention_padded``): rows of at
    most 16 keys past padded depth 128; else None."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import padded_depth

    if padded_depth(d_head) <= 128 or length > 16:
        return None
    return SHORT if name == "bf16" else SHORT_F32


def padded_kernel(d_head: int, name: str) -> str:
    """The padded kernel a call of type ``name`` at a head dim without
    kernels of its own launches where ``short_kernel`` and ``wide_kernel``
    do not take it (``launch_padded_r``): bf16 the padded one (head dims up
    to 128: past them ``wide_kernel`` takes every bf16 row past 16 keys),
    float32 the padded one up to 256 and the deep one past it."""
    if name == "bf16":
        return PADDED
    return DEEP_F32 if d_head > 256 else PADDED_F32


def k1_bf16_kernel(d_head: int, length: int) -> str:
    """The kernel function a bf16 K1 call launches (``launch_attention_dim``'s
    routing): one warp's ring kernel at L <= 16; up to 256 keys one pass, the
    one-pass kernel at D <= 64 and ``attention_kernel_wgmma`` past it; past
    256 keys ``attention_kernel_wgmma_2pass``; at a head dim without kernels
    of its own the kernel ``short_kernel`` names (``attention_kernel_short``
    at L <= 16 past depth 128) or ``wide_kernel`` does
    (``attention_kernel_wgmma``, past depth 256
    ``attention_kernel_wgmma_deep``, past 256 keys
    ``attention_kernel_wgmma_2pass_deep``), else the padded kernel
    (``launch_attention_padded``: ``padded_kernel``)."""
    if d_head % 8 or d_head > 128:
        return (short_kernel(d_head, length, "bf16") or wide_kernel(d_head, length, "bf16")
                or padded_kernel(d_head, "bf16"))
    if length <= 16:
        return RING
    if length > 256:
        return WGMMA_2PASS
    return ONE_PASS if d_head <= 64 else WGMMA


def k1_kernel(d_head: int, length: int, name: str) -> str:
    """The kernel function a K1 call of type ``name`` ("bf16" or "fp32")
    launches."""
    if name == "bf16":
        return k1_bf16_kernel(d_head, length)
    if d_head % 8 or d_head > 128:
        return (short_kernel(d_head, length, name) or wide_kernel(d_head, length, name)
                or padded_kernel(d_head, name))
    return "attention_kernel_f32"


def block_attention_kernel(d_head: int, length: int, name: str) -> str:
    """The kernel function the attention of K2 (``name`` "fp32": float32 q,
    k, v) or K3 ("bf16") launches (``launch_block_attention``): K1's at head
    dims 128 (``launch_attention_dim``: ``attention_kernel_f32``; in bf16 the
    ring at L <= 16, the wgmma kernels past it), 256, 384 and 512 (the short
    kernels at L <= 16, past it the wide ones, float32 at 256 the split one;
    bf16 past 256 keys ``attention_kernel_wgmma_2pass_deep``)."""
    return k1_kernel(d_head, length, name)


def k1_f32_tol(length: int) -> float:
    """K1's float32 tolerance against the plain version: 1e-5 up to 511
    keys, and 1e-5 for each 256 keys past that.  A 3xTF32 score carries
    ~2^-22 of its products' magnitudes, which moves a weight by as much;
    the longest rows hold the most extreme scores (at D = 1 a score is one
    product q k, up to ~16 among 1025 normal draws), which took the float32
    kernels at head dims 1 and 4 past 1e-5 on draws of 1025 keys (PERF.md
    §6)."""
    return 1e-5 * max(1, length // 256)


def k1_f32_tol_text(length: int) -> str:
    return "1e-5" if length < 512 else f"{length // 256} x 1e-5"
# K1 at the head dims without kernels of their own: the padded kernels
# (csrc/attention_padded.cuh), at least one head dim at each padded depth
# (16, 32, ..., 128 ragged; 160-256 two warps a row group).  Phase 3 holds
# each at K1_PADDED_LENGTHS in both types (ragged masks; unmasked too at
# 208), at B = K1_NEW_DIM_BATCH, the kernel function read from the C
# library's counts
K1_PADDED_DIMS = (1, 4, 12, 25, 36, 60, 70, 90, 100, 127, 136, 144, 176, 192, 200, 232, 255,
                  256)
K1_PADDED_LENGTHS = (8, 17, 208, 1025)
# rows past the old 1024-key cap, up to MAX_LEN (4096): head dim, B, L, in
# both types, ragged masks: the models' head dims on their kernels, a ragged
# and the widest padded one
K1_LONG_ROWS = ((24, 4, 1025), (48, 4, 1025), (64, 4, 1025), (128, 4, 1025), (25, 4, 1025),
                (256, 4, 1025), (64, 1, 4096), (128, 1, 4096), (25, 1, 4096), (256, 1, 4096))
# phase 4 at the new paths' shapes (label, head dim, B, L, key mask, type):
# the protocol at --d_model 100 (head dim 25) and 1024 (256; its fusion
# layers run K2, so L = 208 is timed as d_model 1024 with 4 heads would run
# it without K2), serving at d_model 1024 (the box decoder's L = 10),
# d_model 544 (136), and rows past 1024 keys
K1_NEW_SHAPES = (
    ("protocol d 100 fusion encoder", 25, 128, 208, True, "fp32"),
    ("protocol d 100 box decoder", 25, 128, 8, False, "fp32"),
    ("protocol d 100 fusion encoder bf16", 25, 128, 208, True, "bf16"),
    ("serving d 1024 box decoder bf16", 256, 128, 10, False, "bf16"),
    ("protocol d 1024 box decoder", 256, 128, 8, False, "fp32"),
    ("d 1024 encoder", 256, 128, 208, True, "fp32"),
    ("d 1024 encoder bf16", 256, 128, 208, True, "bf16"),
    ("d 544 encoder", 136, 128, 208, True, "fp32"),
    ("1025-key row bf16", 128, 16, 1025, True, "bf16"),
    ("1025-key row", 64, 16, 1025, True, "fp32"),
    ("4096-key row", 256, 4, 4096, True, "fp32"),
)
# K1 past head dim 256, on the deep float32 kernel (csrc/attention_padded.cuh)
# and the kernels that took the deep kernels' calls since (k1_kernel names
# each call's; bf16 past 256 keys attention_kernel_wgmma_2pass_deep):
# phase 3 holds head dims at every deep depth (288: 257, 275; 336: 300, 336;
# 384: 350, 384; 448: 385, 400, 448; 512: 449, 500, 512) at DEEP_LENGTHS in
# both types (ragged masks; unmasked too at 208) at B = 8 (2 past 256
# keys), and DEEP_LONG at MAX_LEN keys; K2's and K3's attention at head dims
# 384 and 512 in the (B, L, 3d) buffer at DEEP_BLOCK_LENGTHS; K1 on a (B,
# L, 3d) buffer's strides at DEEP_STRIDED (275 in bf16: rows of 550 bytes,
# loaded element by element)
DEEP_DIMS = (257, 275, 300, 336, 350, 384, 385, 400, 448, 449, 500, 512)
DEEP_LENGTHS = (8, 16, 17, 208, 256, 1025)
DEEP_LONG = (275, 300, 384, 400, 512)  # one at each deep depth
DEEP_BLOCK_LENGTHS = (8, 10, 17, 210, 224, 256, 257, 1025)
DEEP_STRIDED = (275, 400)
# the head dims phase 24 runs through the models: 275 (d_model 1100), 384
# (1536) and 512 (2048), each at 4 heads
DEEP_MODEL_DIMS = (275, 384, 512)
DEEP_NEGATIVE = ((512, 8, 208), (275, 2, 1025))  # head dim, B, L
# phase 4 at phase 24's shapes past depth 256: label, layout ("K1": the
# wrapper; "block": esv_block_attention on the thirds of a (B, L, 3d)
# buffer), head dim, B, L, key mask, q/k/v type, output type; each timed,
# DEEP_PROFILED's with its device time by profile.  The box decoders (8 and
# 10 keys) take the short kernels, d 1100's bf16 fusion encoder
# attention_kernel_wgmma_deep (rows of 550 bytes), and bf16 rows past 256
# keys (no model sends them) attention_kernel_wgmma_2pass_deep, timed at D =
# 512 and 256 (K3's attention at d 2048, bf16 of 224 keys, is
# attention_kernel_wgmma_deep's: WGMMA_PADDED_TIMED)
DEEP_TIMED = (
    ("K2 attention d 2048", "block", 512, 128, 210, True, "fp32", "bf16"),  # 24.1
    ("K2 attention d 1536 fp32", "block", 384, 128, 208, True, "fp32", "fp32"),  # 24.2
    ("serving d 2048 box decoder", "K1", 512, 128, 10, False, "bf16", "bf16"),  # 24.1
    ("protocol d 1536 box decoder", "K1", 384, 128, 8, False, "fp32", "fp32"),  # 24.2
    ("d 1100 encoder", "K1", 275, 128, 210, True, "fp32", "fp32"),  # 24.3
    ("d 1100 encoder bf16", "K1", 275, 128, 210, True, "bf16", "bf16"),  # 24.3
    ("rows past 256 keys d 2048 bf16", "K1", 512, 16, 1025, True, "bf16", "bf16"),
    ("rows past 256 keys d 1024 bf16", "K1", 256, 16, 1025, True, "bf16", "bf16"),
)
# the DEEP_TIMED shapes also named by a profile, which gives their device time
DEEP_PROFILED = ("K2 attention d 2048", "K2 attention d 1536 fp32", "serving d 2048 box decoder",
                 "protocol d 1536 box decoder", "d 1100 encoder", "d 1100 encoder bf16",
                 "rows past 256 keys d 2048 bf16", "rows past 256 keys d 1024 bf16")
# attention_kernel_wide_f32 (csrc/attention_f32_wide.cuh: float32 rows of
# whole 16-byte chunks past 16 keys at the padded depths past 128 but 256),
# phases 3-4 (f32_wide_kernels): K1 through the wrapper at a head dim of
# every depth it takes (136 and 160 at 160, 192, 200 at 224, 264 at 288, 320
# at 336, 384, 400 and 448 at 448, 512) at F32_WIDE_LENGTHS, ragged and
# unmasked, and at F32_WIDE_LONG; K2's attention on the (B, L, 3d) buffer's
# strides at 384 and 512 (esv_block_attention, float32 and bf16 out) at
# F32_WIDE_BLOCK_LENGTHS, with a negative control (the same attention in one
# TF32 pass) that must miss the tolerance; then F32_WIDE_TIMED (the float32
# fusion encoders at d_model 768 and 1280, phase 25's) checked and timed with
# the device time by profile beside the plain version, SDPA and the bound
# (K2's attention at d 2048 and 1536: DEEP_TIMED; d 544's: K1_NEW_SHAPES)
F32_WIDE_DIMS = (136, 160, 192, 200, 264, 320, 384, 400, 448, 512)
F32_WIDE_LENGTHS = (17, 208, 256, 257, 1025)
F32_WIDE_LONG = ((192, 4096), (512, 4096))  # head dim, L
F32_WIDE_BLOCK_LENGTHS = (17, 208, 210, 257)
F32_WIDE_TIMED = (
    ("d 768 encoder", "K1", 192, 128, 208, True, "fp32", "fp32"),  # 25.3
    ("d 1280 encoder", "K1", 320, 128, 208, True, "fp32", "fp32"),  # 25.4
)
# The one-pass wgmma kernels at the padded depths past 128
# (csrc/attention_wide.cuh: attention_kernel_wgmma at 160-256,
# attention_kernel_wgmma_deep at 288-512), phases 3-4 (wgmma_padded_kernels):
# K1 through the wrapper at a head dim of every depth (most of them not the
# depth itself: 136 and 160 at 160, 176 and 192 at 192, 200 at 224, 264 at
# 288, 320 at 336, 360 and 384 at 384, 392 at 448, 456 and 512 at 512) and
# the lengths from 17 to 256 keys and past them (the two-pass kernel,
# attention_kernel_wgmma_2pass_deep: 257, and with 256 at TWO_PASS_LENGTHS'
# 257, 1025 and MAX_LEN), ragged and unmasked; K1 on a (B, L, 3d) buffer's
# strides at WGMMA_STRIDED (208 and 1025 keys); K3's attention at head dim
# 256 past 256 keys (WGMMA_2PASS_BLOCK_LENGTHS); the negative control at
# WGMMA_NEGATIVE; then WGMMA_PADDED_TIMED checked and timed beside the plain
# version, SDPA and the bound.  K3's attention at 384 and 512 is held in
# deep_kernels (esv_block_attention at DEEP_BLOCK_LENGTHS).
WGMMA_PADDED_DIMS = (136, 160, 176, 192, 200, 264, 320, 360, 384, 392, 456, 512)
WGMMA_PADDED_LENGTHS = (17, 64, 208, 224, 256, 257)
# and on rows that are not whole 16-byte chunks (the producer's narrow
# copies): a head dim at every padded depth past 128, odd ones (every other
# head starts 2 bytes off a 4-byte boundary: 151 and 255 at 160 and 256, 275
# at 288, ...) and even ones (150, 300, 500: 4-byte aligned heads)
WGMMA_NARROW_DIMS = (150, 151, 181, 211, 255, 275, 300, 301, 351, 391, 500, 501)
WGMMA_NARROW_LENGTHS = (17, 208, 256, 257, 1025)
WGMMA_STRIDED = (192, 275, 320, 512)
WGMMA_STRIDED_LENGTHS = (208, 1025)
WGMMA_2PASS_BLOCK_LENGTHS = (257, 1025)
WGMMA_NEGATIVE = ((192, 32, 208), (320, 32, 208), (256, 2, 1025))  # head dim, B, L
WGMMA_PADDED_TIMED = (
    ("d 768 encoder bf16", "K1", 192, 128, 208, True, "bf16", "bf16"),  # 25.1
    ("d 1280 encoder bf16", "K1", 320, 128, 208, True, "bf16", "bf16"),  # 25.2
    ("K3 attention d 2048", "block", 512, 128, 224, False, "bf16", "bf16"),  # 24.4
)
# The short kernels (csrc/attention_padded.cuh: rows of at most 16 keys past
# padded depth 128), phases 3-4 (short_kernels): K1 at a head dim of every
# padded depth past 128 (the models' 192, 256, 320 and 512, and odd ones,
# whose odd bf16 heads load element by element) at SHORT_LENGTHS, ragged and
# unmasked, in both types; K2's and K3's attention at head dim 256 on 8 and
# 10 keys (at 384 and 512: deep_kernels, DEEP_BLOCK_LENGTHS); then
# SHORT_TIMED, the box decoders of phase 25, checked and timed with the
# device time by profile (the others: DEEP_TIMED, K1_NEW_SHAPES)
SHORT_DIMS = (151, 192, 211, 256, 275, 320, 351, 391, 512)
SHORT_LENGTHS = (8, 10, 16)
SHORT_TIMED = (
    ("serving d 768 box decoder bf16", "K1", 192, 128, 10, False, "bf16", "bf16"),  # 25.1
    ("serving d 1280 box decoder bf16", "K1", 320, 128, 10, False, "bf16", "bf16"),  # 25.2
)
# K2 and K3 at head dim 512: d_model 2048, 4 heads, ffn 8192 (the executor at
# d_model 2048), on BLOCK_DRAWS each
BLOCK_HD512 = dict(d=2048, h=4, ffn=8192)
# phase 16.1's widths past the head dims with kernels of their own: d_model
# 4 D at these head dims (the protocol's --d_model 100, 144, 400, 544, 768
# and 1024; at 1024 the fusion layers run K2 at head dim 256)
K1_ROUTING_PADDED = (25, 36, 100, 136, 192, 256)
# K2 and K3 at head dim 256: d_model 1024, 4 heads, ffn 4096 (the executor at
# d_model 1024), on BLOCK_DRAWS each
BLOCK_HD256 = dict(d=1024, h=4, ffn=4096)
# K1 through its wrapper at the box decoders' shapes, where the host's work
# around the launch costs more than the kernel: head dim, B, L, type
K1_WRAPPER_SHAPES = ((24, 128, 8, "fp32"), (48, 128, 8, "fp32"), (128, 128, 10, "bf16"))
# phase 2's build of the same three libraries on the H100 when K1 was one
# translation unit at 4 head dims, and before the wgmma kernels took the
# padded depths past 128 (PERF.md §6), printed beside this build's
SINGLE_UNIT_BUILD_S = 71.4
PARENT_BUILD_S = 86.1

MAIN_QUESTIONS = 512
SLOTS = 128  # the pool's default, as InferencePipeline.run uses it
REPEATS = 5  # of the timed InferencePipeline.run
MODE_QUESTIONS = 64  # of the float32 comparison of the chain modes
K3_TILING = dict(batch_tile=2, ffn_chunks=2)
GENERATOR_STEPS = 25  # updates of phase 11's fixed batch (its timing takes steps 3-22)
EXECUTOR_ROWS = 800  # phase 12's synthetic steps: 640 train (40 steps of 16), 80 validation
EXECUTOR_STEPS = 40  # updates of phases 12's and 21.2's fixed batches
CARD_VS_CPU_ROWS = 4  # phase 13's and phase 15's float32 batch
EVAL_QUESTIONS = 512  # phase 14's beam search and tally
EVAL_STEPS = 800  # phase 14's executor steps, in batches of EVAL_BATCH
EVAL_BATCH = 128
FP32_QUESTIONS = 64  # phase 14's float32 tally run, card against the CPU
SCHEDULED_QUESTIONS = 160  # phase 15: 128 train (8 steps of 16), 16 validation
SCHEDULED_STEPS = 30  # phase 15's fixed batch: most updates to fall below 0.8
SCORE_ROUNDS = 10  # alternating timing rounds of the two bf16 score forms
# phase 16: the CoGenT protocol at its flagship width (the CLI's sizes, an
# eighth of its 400/500/150 steps: the run times the protocol and holds its
# models card against CPU), and at d_model 512 with fewer steps; the names
# of our kernels in a profiler trace
COGENT_FLAGSHIP = dict(d_model=192, encoder_layers=3, box_roi=True, lr_schedule="cosine",
                       gen_steps=50, exe_steps=63, ft_steps=20)
COGENT_KERNEL_PATH = dict(d_model=512, encoder_layers=2, box_roi=True, lr_schedule="cosine",
                          gen_steps=50, exe_steps=50, ft_steps=15)
OUR_KERNELS = ("attention_kernel", "gemm_bf16_wgmma", "gemm_tf32_wgmma", "add_layernorm")
# phase 17: the baselines on the CLEVR factory's questions (4 per scene)
BASELINE_SCENES = 128
BASELINE_IMAGE = (196, 1024)  # image tokens and features of the presets' models
BASELINE_FP32 = 64  # questions and chains of the float32 card-vs-CPU checks
BASELINE_D512_CHAINS = 32  # chains of the d 512 step seq2seq's float32 check
BASELINE_UPDATES = 30  # fixed-batch updates of each baseline's train step
BASELINE_REPEATS = 2  # timed runs of phase 17's eval paths (each a median)
NEAR_TIE = 1e-4  # a top-2 logit gap below which card and CPU decisions may part
K2_IQAP_SHAPE = (64, 243)  # B, L: the IQAP encoder at d 512 (1 + 196 + 46 tokens), no mask
# phase 18: the chain-of-thought IQAP and the prototype step models on the
# CLEVR factory's questions (4 per scene)
PROTO_SCENES = 128
PROTO_UPDATES = 30  # fixed-batch updates of each phase 18 train step
PROTO_FP32_ROWS = 8  # rows of phase 18's float32 card-vs-CPU steps
COT_DECODE_FP32 = 64  # questions of the CoT's float32 greedy decode, card vs CPU
HIER_D512 = dict(d_model=512, num_heads=4, num_layers=2)  # head dim 128: K2 in eval
K2_HIER_SHAPE = (128, 196)  # B, L: HierarchicalGenerator's encoder at d 512, no mask
DP_TIMEOUT = 300  # s, each of phase 20.3's two ranks
# phase 19: the feature extractor at the CLI's batch on CLEVR-sized images
PREP_BATCH = 128
PREP_IMAGE = (320, 480)
PREP_RUN_BATCHES = 8  # batches of each timed run of the extraction loop


def fail(message: str) -> None:
    print(f"FAIL: {message}", flush=True)
    sys.exit(1)


# Launches on the main path by kind and phase: K2's with float32 weights
# ("K2 fp32") and K1's by head dim ("K1 D=24", ...).  main_path counts them on
# the model's references to the wrappers into "pending" (``note``), and
# ``say`` puts them down to the next phase that prints (a phase prints after
# its work).
TALLIES = {}


def note(kind: str, launches: int) -> None:
    TALLIES.setdefault(kind, {"pending": 0, "by_phase": {}})["pending"] += launches


def by_phase(kind: str) -> dict:
    return dict(sorted(TALLIES.get(kind, {"by_phase": {}})["by_phase"].items()))


# seconds by phase: the time from the previous line printed to a "phase N"
# line goes to phase N (a phase prints after its work); printed at the end
T_START = time.perf_counter()
PHASE_SECONDS = {}
_LAST_SAID = [T_START]


def say(message: str) -> None:
    print(message, flush=True)
    found = re.match(r"phase (\d+)", message)
    now = time.perf_counter()
    if found:
        phase = int(found.group(1))
        PHASE_SECONDS[phase] = PHASE_SECONDS.get(phase, 0.0) + now - _LAST_SAID[0]
        _LAST_SAID[0] = now
    for tally in TALLIES.values() if found else ():
        if tally["pending"]:
            phase = int(found.group(1))
            tally["by_phase"][phase] = tally["by_phase"].get(phase, 0) + tally["pending"]
            tally["pending"] = 0


def timed_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def peaks():
    """The H100 SXM's operations/s by type and HBM bytes/s, from the package
    (``device.PEAK_OPS``, ``device.PEAK_BYTES``).  A float32 dot product's
    least time is its 3xTF32 form's: see ``dot_ops``."""
    from explainable_spatial_vqa_tpu_torch.device import PEAK_BYTES, PEAK_OPS

    return PEAK_OPS, PEAK_BYTES


def bound_ms(ops: dict, nbytes: float):
    """The larger of the operations' time (each type's count, {"bf16": n, ...},
    over that type's peak rate, summed) and the bytes over the memory rate, in
    ms, and which of the two it is."""
    PEAK_OPS, PEAK_BYTES = peaks()
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items()) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def dot_ops(kind: str, n: float) -> dict:
    """``n`` operations of dot products whose operands are of ``kind`` ("bf16"
    or "fp32") as ``bound_ms`` counts them: float32 as 3xTF32, three TF32
    products for each."""
    return {"tf32": 3.0 * n} if kind == "fp32" else {kind: n}


def dot_text(kind: str, n: float) -> str:
    """How ``dot_ops`` counts ``n`` operations of ``kind``, and their time."""
    ms = sum(c / peaks()[0][k] for k, c in dot_ops(kind, n).items()) * 1e3
    how = "in 3xTF32 (3 x at the TF32 rate)" if kind == "fp32" else f"at the {kind} rate"
    return f"{how} {ms:.4f} ms"


def device_profile(torch, fn):
    """Run ``fn`` once under torch.profiler: (wall s, (share of the wall time in
    which a kernel or copy ran on the card, [(name, device ms)] by time, the
    number of times the host waited for the card, the number of kernels and
    copies)), or None for the profile when the profiler saw no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return wall, None
    busy, end = 0.0, -math.inf
    for start, stop in spans:  # union of the device intervals, in us
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(((n, us / 1e3) for n, us in by_name.items()), key=lambda t: -t[1])
    syncs = sum(1 for e in prof.events()
                if e.device_type != DeviceType.CUDA and "Synchronize" in e.name)
    return wall, (busy / 1e6 / wall, top, syncs, len(spans))


MEAN_ULPS = 0.05  # bf16 check: the largest mean error, in ulps of the reference


def bf16_agreement(torch, out, ref, rms_rounded: bool = False) -> dict:
    """How far a bf16 output lies from its bf16 plain version.

    The kernel and the plain version round the same float32 values, summed
    in another order, so an element differs only where a rounding, in it or
    in an operand on its way, fell on the other side: rarely, by one or two
    ulps of the element, and through a row's LayerNorm by about an ulp of a
    typical element.  So every element must be within 2 ulp(|ref|) +
    ulp(rms(ref)), and the mean error within ``MEAN_ULPS`` of the mean
    ulp(|ref|): other arithmetic (q, k, v rounded to bf16, say) moves most
    elements a little, and shows in the mean before it does in the largest.
    Returns the largest error, the largest excess over the element-wise
    limit, the number of elements over it, and the mean error in ulps.

    With ``rms_rounded`` the rms is rounded to bf16 before its ulp is taken:
    the rms of a LayerNorm's output at unit scale lies a hair under 1.0,
    where ulp(rms) is half that of the typical element of magnitude ~1
    (phase 17.4; phase 3's draws, with scales 1 + 0.1 N(0, 1), sit above 1)."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    _, exp = torch.frexp(ref)
    ulp = torch.where(ref == 0, 0.0, torch.ldexp(torch.ones_like(ref), exp - 8))
    rms = ref.square().mean().sqrt()
    _, rms_exp = torch.frexp(rms.bfloat16().float() if rms_rounded else rms)
    limit = 2 * ulp + 2.0 ** (int(rms_exp) - 8)
    return dict(max_abs=float(err.max()), excess=float((err - limit).max()),
                outside=int((err > limit).sum()), mean_ulps=float(err.mean() / ulp.mean()))


def bf16_ok(stats: dict, mean_ulps: float = MEAN_ULPS) -> bool:
    return stats["excess"] <= 0 and stats["mean_ulps"] <= mean_ulps


def bf16_text(stats: dict, mean_ulps: float = MEAN_ULPS) -> str:
    return (f"max_abs_err {stats['max_abs']:.3g}, largest excess over "
            f"{stats.get('limit', '2 ulp(|ref|) + ulp(rms)')} {stats['excess']:.3g} (tol 0), "
            f"mean error {stats['mean_ulps']:.4f} ulp (tol {mean_ulps:.4g})")


def block_mean_ulps(d: int) -> float:
    """The bf16 block checks' mean-error limit at width d: ``MEAN_ULPS`` at
    d 512, the width it was set at, times sqrt(d / 512) past it.  The block's
    float32 sums run over d (and 4 d) products, and a sum taken in another
    order moves a bf16 rounding the other way at a rate that grows as the
    square root of its length: K2's mean error was 0.021 ulp at d 512 and
    0.0484-0.0489 at d 1024 (PERF.md §6), where the negative control
    (the other block's arithmetic) stays at 0.23."""
    return MEAN_ULPS * math.sqrt(max(1.0, d / 512))


def attention_agreement(torch, out, q, k, v, mask, ref=None) -> dict:
    """How far a bf16 attention output lies from the plain version with its
    scores and softmax in float64, its weights then rounded to bf16 (the TPU
    kernel normalises, then rounds) and P V summed in float64 and rounded
    once: no float32 score order is baked into the reference.  A score a few
    float32 ulps off moves a weight by at most one bf16 ulp, so each output
    may lie within sum_j ulp(w_j) |v_j| (every weight one ulp off) +
    ulp(|ref|) (the output's rounding) + ulp(rms(ref)) of it, for any float32
    score order; and the mean error within ``MEAN_ULPS`` of the mean
    ulp(|ref|).  With ``ref`` (another output of the TPU kernel's arithmetic,
    JAX's kernel's, say) ``out`` is held against it instead, within the same
    limit: two float32 score orders round a weight to one of the same two
    neighbouring bf16 values.  The keys of ``bf16_agreement``."""
    import numpy as np

    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    w = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    del scores
    w = (w / (w.sum(dim=-1, keepdim=True) + 1e-30)).to(q.dtype)
    if ref is None:
        ref = torch.einsum("bhqk,bkhd->bqhd", w.double(), v.double()).float().to(q.dtype)
    ref = ref.float()
    _, w_exp = torch.frexp(w.float())
    w_ulp = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w, dtype=torch.float64),
                                                 w_exp - 8))
    room = torch.einsum("bhqk,bkhd->bqhd", w_ulp, v.double().abs()).float()
    del w, w_ulp
    err = (out.float() - ref).abs()
    _, exp = torch.frexp(ref)
    ulp = torch.where(ref == 0, 0.0, torch.ldexp(torch.ones_like(ref), exp - 8))
    _, rms_exp = torch.frexp(ref.square().mean().sqrt())
    limit = room + ulp + 2.0 ** (int(rms_exp) - 8)
    return dict(max_abs=float(err.max()), excess=float((err - limit).max()),
                outside=int((err > limit).sum()), mean_ulps=float(err.mean() / ulp.mean()),
                limit="sum ulp(w)|v| + ulp(|ref|) + ulp(rms)")


def k3_qkv(torch, x, keep, w, heads) -> dict:
    """K3 rounds its float32 QKV sums to bf16, and a key or value rounded the
    other way moves the attention of every query of its sequence, so the
    kernel adds its tensor-core slices with Kahan's compensation.  One more
    launch keeps the kernel's own q, k and v (its scratch) for: the share of
    them rounded the other way from the float64 sum (the plain version's),
    beside that of float32 sums (cuBLAS, TF32 off); the kernel's output
    against the plain arithmetic on its own q, k and v (``rest``: what the
    kernels after the QKV product add); and that plain output against the
    plain version (``qkv``: what the q/k/v roundings alone move)."""
    from explainable_spatial_vqa_tpu_torch.ops import fused_block
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import DTYPE_CODES

    batch, length, d = x.shape
    rows, ffn, wdt = batch * length, w.ffn1.shape[0], w.qkv.dtype
    scratch = fused_block.block_scratch(x, w, tiled=True, ffn_chunks=K3_TILING["ffn_chunks"])
    out = fused_block._launch(
        fused_block.fused_encoder_block_tiled, "esv_encoder_block_tiled", x, keep, w, None,
        scratch,
        (batch, length, d, heads, ffn, K3_TILING["ffn_chunks"], DTYPE_CODES[x.dtype],
         DTYPE_CODES[wdt]))
    xr = x.reshape(rows, d)
    exact = ((xr.double() @ w.qkv.double().t()).float() + w.qkv_bias).to(wdt)
    f32 = (xr.float() @ w.qkv.float().t() + w.qkv_bias).to(wdt)
    after = fused_block.tiled_plain_after_qkv(x, keep, w, heads, scratch[0], **K3_TILING)
    plain = fused_block.tiled_plain_after_qkv(x, keep, w, heads, exact, **K3_TILING)
    found = dict(kernel_share=float((scratch[0] != exact).float().mean()),
                 f32_share=float((f32 != exact).float().mean()),
                 rest=bf16_agreement(torch, out, after), qkv=bf16_agreement(torch, after, plain))
    del scratch, out, after, plain, f32, exact
    found.update(compensated_sums(torch, xr.to(wdt), w))
    return found


K3_SUM_SLACK = 2.0 ** -18  # csrc/fused_block.cu kSumSlack


def k3_qkv_times(torch, a, w, near_share: float) -> None:
    """Phase 4 for K3's QKV product alone (``block_gemm``): correctly rounded
    to bf16 as K3 takes it (compensated sums, the exact ones near a bf16
    tie), the compensated sums alone in float32, and the uncompensated
    product in float32 (K2's), beside ``torch.matmul`` in bf16 and the
    bound of the correctly rounded product: its bf16 product, plus the
    float64 dot products of the ``near_share`` of outputs the fix-up takes
    again, at the float64 rate; a, the weights and the bias read once, the
    bf16 output written once."""
    from explainable_spatial_vqa_tpu_torch.ops.block_gemm import block_gemm

    b = w.qkv_bias
    rows, n, k = a.shape[0], w.qkv.shape[0], a.shape[1]
    exact = timed_ms(torch, lambda: block_gemm(a, w.qkv, b, False, torch.bfloat16, True))
    comp = timed_ms(torch, lambda: block_gemm(a, w.qkv, b, False, torch.float32, True))
    plain = timed_ms(torch, lambda: block_gemm(a, w.qkv, b, False, torch.float32))
    lib = timed_ms(torch, lambda: torch.matmul(a, w.qkv.t()))
    fixup = near_share * rows * n * 2.0 * k
    bnd, by = bound_ms({"bf16": 2.0 * rows * n * k, "fp64": fixup},
                       (rows * k + n * k) * 2 + n * 4 + rows * n * 2)
    say(f"phase 4 K3 QKV product {rows}x{n}x{k}: correctly rounded to bf16 {exact:.4f} ms, "
        f"compensated sums in float32 {comp:.4f} ms, uncompensated in float32 {plain:.4f} ms, "
        f"torch.matmul bf16 {lib:.4f} ms; bound {bnd:.4f} ms ({by}; the fix-up's "
        f"{fixup / 1e9:.3f} GFLOP of float64 dot products for {near_share:.2e} of the outputs "
        f"{fixup / peaks()[0]['fp64'] * 1e3:.4f} ms of it)")


def compensated_sums(torch, a, w) -> dict:
    """How far K3's compensated QKV sums (``block_gemm(compensated=True)``
    with a float32 output: the sums before any exact one is taken) lie from
    the exact sums, at most, in units of max|a row| max|w row|, against the
    kernel's slack; and the share of q, k and v close enough to a bf16 tie
    that the kernel takes their exact sums."""
    from explainable_spatial_vqa_tpu_torch.ops.block_gemm import block_gemm

    sums = block_gemm(a, w.qkv, torch.zeros_like(w.qkv_bias), compensated=True).double()
    exact = a.double() @ w.qkv.double().t()
    scale = a.float().abs().amax(1).double()[:, None] * w.qkv.float().abs().amax(1).double()
    worst = float(((sums - exact).abs() / scale).max())
    del sums
    v = exact.float() + w.qkv_bias
    _, e = torch.frexp(v)
    tie = ((v.view(torch.int32) & 0xFFFF) - 0x8000).abs().double() * torch.ldexp(
        torch.ones_like(exact), e.long() - 24)
    near = tie <= K3_SUM_SLACK * scale + 2.0 ** -20 * v.abs().double()
    return dict(worst_log2=math.log2(worst) if worst > 0 else -math.inf,
                near_share=float(near.float().mean()))


def k3_qkv_text(found: dict) -> str:
    return (f"q/k/v rounded to bf16 the other way from the float64 sum: kernel "
            f"{found['kernel_share']:.2e} of them, float32 sums {found['f32_share']:.2e}; "
            f"compensated sums within 2^{found['worst_log2']:.2f} of max|x row| max|W row| "
            f"of the exact ones (the kernel's slack 2^{math.log2(K3_SUM_SLACK):.0f}), "
            f"{found['near_share']:.2e} of q/k/v within the slack of a bf16 tie (taken "
            f"exactly); the "
            f"kernel against the plain arithmetic on its own q/k/v: {bf16_text(found['rest'])}; "
            f"that against the plain version (the q/k/v roundings alone): "
            f"{bf16_text(found['qkv'])}")


def block_inputs(torch, dev, draw, length: int, dtype, batch: int = SLOTS, d: int = 512,
                 ffn: int = 2048):
    """One block's inputs drawn from a generator seeded ``draw`` (a seed, or
    (seed, offset) to start at that offset of the seed's stream): a ragged
    key mask over the last 13 keys, weights in ``dtype`` (matrices at
    1/sqrt(fan in), biases and LayerNorm parameters float32) and x in
    ``dtype``."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import BlockWeights

    seed, offset = draw if isinstance(draw, tuple) else (draw, 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if offset:
        gen.set_offset(offset)

    def randn(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)

    keep = torch.ones(batch, length, dtype=torch.bool, device=dev)
    keep[:, length - 13:] = torch.rand(batch, 13, generator=gen, device=dev) < 0.6
    w = BlockWeights(
        randn(3 * d, d, scale=d ** -0.5, dt=dtype), randn(3 * d, scale=0.02),
        randn(d, d, scale=d ** -0.5, dt=dtype), randn(d, scale=0.02),
        randn(ffn, d, scale=d ** -0.5, dt=dtype), randn(ffn, scale=0.02),
        randn(d, ffn, scale=ffn ** -0.5, dt=dtype), randn(d, scale=0.02),
        1 + randn(d, scale=0.1), randn(d, scale=0.1), 1 + randn(d, scale=0.1),
        randn(d, scale=0.1))
    return keep, w, randn(batch, length, d, dt=dtype)


def parse_draws(spec: str) -> list:
    """Items joined by commas: ``START:STOP`` (those seeds), ``SEED`` or
    ``SEED@OFFSET``."""
    draws = []
    for item in spec.split(","):
        if ":" in item:
            start, stop = (int(s) for s in item.split(":"))
            draws += range(start, stop)
        else:
            draws.append(tuple(int(s) for s in item.split("@")) if "@" in item else int(item))
    return draws


def k3_draws(draws) -> None:
    """``chip_smoke.py --k3-draws SPEC`` (``parse_draws``): K3 in bf16 at the
    block bench's shape (B=128, L=224, ``K3_TILING``) against its plain
    version on the inputs of each draw (``block_inputs``), one line per draw
    with the bf16 check's numbers, then the draws that fail it.  It runs the
    kernel of the checkout it lies in, so a copy of this file in an older
    checkout holds that checkout's kernel on the same inputs."""
    if not (REPO / "explainable_spatial_vqa_tpu_torch" / "csrc").is_dir():
        fail(f"no checkout of the repository next to {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import torch

    from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
        fused_encoder_block_tiled,
        fused_encoder_block_tiled_plain,
    )

    from explainable_spatial_vqa_tpu_torch.ops import fused_block

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    failing = []
    for draw in draws:
        keep, w, x = block_inputs(torch, dev, draw, 224, torch.bfloat16)
        out = fused_encoder_block_tiled(x, keep, w, 4, **K3_TILING)
        stats = bf16_agreement(torch, out, fused_encoder_block_tiled_plain(x, keep, w, 4,
                                                                           **K3_TILING))
        say(f"K3 bf16 draw {draw}: {bf16_text(stats)}: {'passes' if bf16_ok(stats) else 'FAILS'}")
        if hasattr(fused_block, "tiled_plain_after_qkv"):  # not in checkouts before it
            say(f"K3 bf16 draw {draw}: {k3_qkv_text(k3_qkv(torch, x, keep, w, 4))}")
        if not bf16_ok(stats):
            failing.append(draw)
    say(f"K3 bf16: {len(failing)} of {len(draws)} draws fail {failing}")


def kernel_report(libs: dict) -> dict:
    """Per kernel function of the built libraries: its registers and spilled
    bytes from ptxas's report (the build logs) and its count of HGMMA (wgmma)
    and HMMA (mma.sync) instructions in the SASS (``cuobjdump -sass``)."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    from explainable_spatial_vqa_tpu_torch.measure.variants import ptxas_usage
    from explainable_spatial_vqa_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    filt = Path(_build._nvcc()).with_name("cu++filt")
    with ThreadPoolExecutor(len(libs)) as by_lib, ThreadPoolExecutor(SASS_PROCESSES) as pool:
        sass = dict(zip(libs, by_lib.map(lambda lib: library_sass(cuobjdump, lib, pool),
                                         libs.values())))
    out = {}
    for name, lib in libs.items():
        for fn, (registers, spill) in ptxas_usage(
                (_build.BUILD_DIR / f"{name}.log").read_text()).items():
            out.setdefault(fn, dict(registers=0, spill=0, HGMMA=0, HMMA=0)).update(
                registers=registers, spill=spill)
        for fn, body in re.findall(r"Function : (\S+)(.*?)(?=\n\s*Function : |\Z)",
                                   sass[name], re.S):
            entry = out.setdefault(fn, dict(registers=0, spill=0, HGMMA=0, HMMA=0))
            entry["HGMMA"] = len(re.findall(r"\bHGMMA\.", body))
            entry["HMMA"] = len(re.findall(r"\bHMMA\.", body))
    names = list(out)
    shorts = names
    if filt.is_file():
        shorts = subprocess.run([str(filt)], input="\n".join(names), capture_output=True,
                                text=True, timeout=60).stdout.splitlines()
    for name, short in zip(names, shorts):
        out[name]["short"] = short.replace("esv::", "").replace("__nv_bfloat16", "bf16")
    return out


def launch_counter(torch):
    """``counted(fn)``: ``fn()`` with every wrapper's launch count (K1, K2,
    K3 and the matcher) set to 0 just before it, and the counts just after:
    (its value, {kernel: launches})."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
        fused_encoder_block,
        fused_encoder_block_tiled,
    )
    from explainable_spatial_vqa_tpu_torch.ops.matching import hungarian_assignment_device

    wrappers = {w.__name__: w for w in (fused_attention, fused_encoder_block,
                                        fused_encoder_block_tiled, hungarian_assignment_device)}

    def counted(fn):
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        value = fn()
        return value, {name: w.launches for name, w in wrappers.items()}

    return counted


def alone(which: str) -> None:
    """``chip_smoke.py --routing``: phase 16.1 alone (the models' routing to
    K1 at every head dim, K2 at 128); ``--matcher``: phases 21.1-21.2 alone
    (both matcher kernels against their plain version, their times, the
    train steps with either matcher and at 40 queries).  Each builds the
    libraries it needs first and ends with ``ok`` on its last line."""
    if not (REPO / "explainable_spatial_vqa_tpu_torch" / "csrc").is_dir():
        fail(f"no checkout of the repository next to {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from explainable_spatial_vqa_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = _build.build(["fused_attention", "fused_block", "hungarian"])
    say(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(sorted(libs))}")
    counted = launch_counter(torch)
    if which == "routing":
        head_dim_routing(torch, dev, counted)
    else:
        matcher, block = matcher_kernel(torch, np, dev)
        step_counts, block["launches"] = matcher_step_times(torch, np, dev, counted)
        say(json.dumps({"matcher": matcher, "block_matcher": block,
                        "executor_train_step": step_counts}))
    say("ok")


def k1_functions_missing(kernels: dict) -> list:
    """K1's kernel functions (``kernel_report``'s entries) that each head dim
    of ``EXACT_HEAD_DIMS`` must have, as (head dim, kernel, output type,
    warps), that are not built or run no HMMA: ``attention_kernel_f32`` to
    float and bf16 at 1 and 14 warps, ``attention_kernel<bf16, bf16, D, 1,
    0>`` (L <= 16; past it bf16 runs on the one-pass and wgmma kernels, and
    the 8-warp ring is built only for the FMA-chain variant at 128), and
    ``attention_kernel_onepass<bf16, D, 4>`` up to 64."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import EXACT_HEAD_DIMS

    built = {}
    for k in kernels.values():
        found = re.search(r"(attention_kernel(?:_f32|_onepass)?)<([^>]*)>", k["short"])
        if not found:
            continue
        # cu++filt writes a template's int and bool arguments as (int)128, (bool)0
        kind = found.group(1)
        args = [re.sub(r"^\((?:int|bool)\)", "", a.strip()) for a in found.group(2).split(",")]
        if kind == "attention_kernel":
            if args[4] not in ("0", "false"):
                continue  # the FMA-chain variant
            to, dim, warps = args[1], args[2], args[3]
        else:
            to, dim, warps = args
        built[int(dim), kind, to, warps] = k["HMMA"] > 0
    missing = []
    for d in EXACT_HEAD_DIMS:
        want = [(d, "attention_kernel_f32", to, w) for to in ("float", "bf16") for w in ("1", "14")]
        want += [(d, "attention_kernel", "bf16", "1")]
        want += [(d, "attention_kernel_onepass", "bf16", "4")] if d <= 64 else []
        missing += [key for key in want if not built.get(key)]
    return missing


def padded_group(depth: int) -> int:
    """The warps sharing a 16-row group at a padded depth
    (``attention_padded.cuh: padded_group``): one up to 128, then one for
    each 128 columns or part of them."""
    return -(-depth // 128) if depth > 128 else 1


def padded_rows(depth: int, name: str) -> int:
    """The row groups a block of the padded kernels past 16 keys
    (``attention_padded.cuh: padded_rows``): 8 warps up to depth 256, past
    it 2 groups, 3 for float32 at three warps a group (depths 288-384)."""
    g = padded_group(depth)
    return 3 if name == "fp32" and g == 3 else 8 // g


def k1_padded_missing(kernels: dict) -> list:
    """The padded kernels (``csrc/attention_padded.cuh``) that each depth of
    ``PADDED_DEPTHS`` must have, as (kernel, output type, per-warp depth,
    warps a row group[, row groups a block]), that are not built or run no
    HMMA: ``attention_kernel_padded_f32`` to float and bf16 (past depth 256
    the deep one), each with 8 warps (past 256 ``padded_rows`` groups) and,
    up to depth 128, with one row group (L <= 16), and up to depth 128
    ``attention_kernel_padded`` to bf16 likewise (past it the wgmma kernels
    take bf16 past 16 keys: ``kernel_checks``); past 128, where the short
    kernels take L <= 16, ``attention_kernel_short_f32`` to float and bf16
    and ``attention_kernel_short`` to bf16."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import PADDED_DEPTHS

    built = {}
    for k in kernels.values():
        found = re.search(r"(attention_kernel_(?:padded|deep|short)(?:_f32)?)<([^>]*)>",
                          k["short"])
        if found:
            args = [re.sub(r"^\((?:int|bool)\)", "", a.strip()) for a in found.group(2).split(",")]
            built[(found.group(1), *args)] = k["HMMA"] > 0
    missing = []
    for depth in PADDED_DEPTHS:
        g = padded_group(depth)
        f32 = DEEP_F32 if depth > 256 else PADDED_F32
        for name, kernel, outs in (("fp32", f32, ("float", "bf16")), ("bf16", PADDED, ("bf16",))):
            groups = ("1", "8") if depth <= 128 else (str(padded_rows(depth, name)),)
            want = ([(kernel, to, str(depth // g), str(g), r) for to in outs for r in groups]
                    if name == "fp32" or depth <= 128 else [])
            if depth > 128:
                want += [(SHORT_F32 if name == "fp32" else SHORT, to, str(depth // g), str(g))
                         for to in outs]
            missing += [key for key in want if not built.get(key)]
    return missing


def block_deep_missing() -> list:
    """The deep and short kernels the block library must build for K2's and
    K3's attention at head dims 384 and 512 (``launch_block_attention``), as
    (kernel, output type, per-warp depth, warps a row group[, row groups a
    block]), that its ptxas report does not name: float32 q/k/v to float
    and bf16 (K2; K3 with float32 weights) and, for the short kernels, bf16
    to bf16 (K3); the deep float32 kernel (past 16 keys), the short ones
    (``attention_kernel_short[_f32]``, L <= 16; at 256 too); and
    ``attention_kernel_wgmma_deep`` (K3, bf16, 17-256 keys) at each depth
    and ``attention_kernel_wgmma_2pass_deep`` (K3, bf16, past 256 keys) at
    256 too, as (kernel, output type, depth)."""
    from explainable_spatial_vqa_tpu_torch.measure.variants import ptxas_usage
    from explainable_spatial_vqa_tpu_torch.ops import _build

    built = set()
    for fn in ptxas_usage((_build.BUILD_DIR / "fused_block.log").read_text()):
        found = re.search(r"(attention_kernel_(?:deep|short)(?:_f32)?)I(f|13__nv_bfloat16)"
                          r"((?:Li\d+E)+)", fn)
        if found:
            kind, to, ints = found.groups()
            built.add((kind, "float" if to == "f" else "bf16", *re.findall(r"Li(\d+)E", ints)))
        found = re.search(r"(attention_kernel_wgmma(?:_2pass)?_deep)I13__nv_bfloat16Li(\d+)E", fn)
        if found:
            built.add((found.group(1), "bf16", found.group(2)))
    missing = [(WGMMA_DEEP, "bf16", str(depth)) for depth in (384, 512)
               if (WGMMA_DEEP, "bf16", str(depth)) not in built]
    missing += [(WGMMA_2PASS_DEEP, "bf16", str(depth)) for depth in (256, 384, 512)
                if (WGMMA_2PASS_DEEP, "bf16", str(depth)) not in built]
    for depth in (256, 384, 512):
        g = padded_group(depth)
        shape = (str(depth // g), str(g))
        want = [(SHORT_F32, "float", *shape), (SHORT_F32, "bf16", *shape), (SHORT, "bf16", *shape)]
        if depth > 256:
            rows = {name: str(padded_rows(depth, name)) for name in ("fp32", "bf16")}
            want += [(DEEP_F32, "float", *shape, rows["fp32"]),
                     (DEEP_F32, "bf16", *shape, rows["fp32"])]
        missing += [key for key in want if key not in built]
    return missing


SASS_PROCESSES = 6  # cuobjdump processes at once, of the chip host's 8 cores


def library_sass(cuobjdump, lib, pool) -> str:
    """The SASS of every kernel in ``lib`` (``cuobjdump -sass``).  A library
    linked from several translation units holds one cubin each (K1's
    head-dim units, the block library's attention units): they are extracted
    (``-xelf all``) and disassembled by one process each, on ``pool``'s
    threads (``SASS_PROCESSES`` at once), which takes a fraction of one pass
    over the whole library."""
    import tempfile

    def disassemble(target):
        done = subprocess.run([str(cuobjdump), "-sass", str(target)], capture_output=True,
                              text=True, timeout=300)
        if done.returncode != 0:
            fail(f"cuobjdump -sass failed on {target}: {done.stderr.strip()[-500:]}")
        return done.stdout

    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([str(cuobjdump), "-xelf", "all", str(lib)], cwd=tmp, capture_output=True,
                       timeout=300)
        return "\n".join(pool.map(disassemble, sorted(Path(tmp).glob("*.cubin")) or [Path(lib)]))


def postfix_ids(chains, token_ids: dict, function_ids: dict, length: int):
    """Each chain's program as the generator spells one: its nodes in postfix
    order (children first, then the node), <END>, then <NULL> padding."""
    import numpy as np

    names = {i: name for name, i in function_ids.items()}
    out = np.zeros((len(chains.num_steps), length), np.int64)
    for i, steps in enumerate(chains.num_steps):
        order = []

        def visit(step):
            for dep in chains.deps[i, step]:
                if dep >= 0:
                    visit(dep)
            order.append(step)

        visit(steps - 1)
        ids = [token_ids[names[chains.functions[i, s]]] for s in order] + [token_ids["<END>"]]
        out[i, :min(len(ids), length)] = ids[:length]
    return out


def scripted_programs(torch, generator, program_ids):
    """The generator, whose random weights emit programs that mostly do not
    parse, as a module that runs its greedy decode on the card at its full
    cost and then hands the pipeline the synthetic ``program_ids`` instead,
    which parse into CLEVR-shaped chains."""

    class ScriptedPrograms(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.generator = generator

        def generate(self, questions):
            decoded = self.generator.generate(questions)
            return torch.as_tensor(program_ids, device=decoded.device)

    return ScriptedPrograms()


def main() -> None:
    if not (REPO / "explainable_spatial_vqa_tpu_torch" / "csrc").is_dir():
        fail(f"no checkout of the repository next to {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor

    from explainable_spatial_vqa_tpu_torch.ops import _build
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention

    dev = torch.device("cuda")

    # ---- 1. the card ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(smi.stdout.strip().splitlines()[0])
    say(f"phase 1 torch {torch.__version__}, CUDA {torch.version.cuda}, Python "
        f"{sys.version.split()[0]}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    libs = _build.build(["fused_attention", "fused_block", "hungarian"])
    build_s = time.perf_counter() - t0
    say(f"phase 2 build: {build_s:.1f} s for {', '.join(sorted(libs))} (the same three libraries "
        f"before the wgmma kernels past depth 128: {PARENT_BUILD_S} s; with K1 at 4 head dims "
        f"in one nvcc process: {SINGLE_UNIT_BUILD_S} s)")
    for name in sorted(libs):  # each unit's nvcc wall time, all started together
        heads = re.findall(r"^--- (.*): exit (-?\d+), ([0-9.]+) s ---$",
                           (_build.BUILD_DIR / f"{name}.log").read_text(), re.M)
        say(f"phase 2 {name} units: " + "; ".join(f"{what} {sec} s" for what, _, sec in heads))
    # the SASS listing (cuobjdump: tens of seconds of the host's cores) runs
    # while phases 3-4 run on the card; its checks (kernel_checks) follow them
    listing = ThreadPoolExecutor(1)
    report = listing.submit(kernel_report, libs)

    from explainable_spatial_vqa_tpu_torch.clevr import native

    t0 = time.perf_counter()
    say(f"phase 2 native CLEVR engine (g++): {native.build_library().name}")
    results = {"native_build_s": time.perf_counter() - t0}

    # ---- 3 and 4. kernels against their plain versions; times ----
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def ragged_keep(batch, length, tail):
        """Key mask keeping all but a random subset of the last ``tail`` keys."""
        keep = torch.ones(batch, length, dtype=torch.bool, device=dev)
        keep[:, length - tail:] = torch.rand(batch, tail, generator=gen, device=dev) < 0.6
        return keep

    parts = []
    names = {torch.bfloat16: "bf16", torch.float32: "fp32"}

    # K1 at the box decoder's shape (L=10, no mask: the main path) and the fusion
    # encoder's (L=210, ragged masks), bf16 and fp32
    b, h, d_head = SLOTS, 4, 128
    for length, masked in ((10, False), (10, True), (210, True)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn(b, length, h, d_head, dtype=dtype) for _ in range(3))
            mask = ragged_keep(b, length, min(length, 13))[:, None, None, :] if masked else None
            out = fused_attention(q, k, v, mask)
            ref = dot_product_attention(q, k, v, mask)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            head = (f"phase 3 K1 fused_attention {names[dtype]} B={b} H={h} L={length} "
                    f"D={d_head} mask={'ragged' if masked else 'none'}:")
            if dtype == torch.bfloat16:
                stats = attention_agreement(torch, out, q, k, v, mask)
                say(f"{head} {bf16_text(stats)}")
                ok = bf16_ok(stats)
            else:
                say(f"{head} max_abs_err {err:.3g} (tol 1e-5)")
                ok = err <= 1e-5
            if not ok:
                fail("K1 disagrees with its plain version")
            if not (dtype == torch.bfloat16 and (length, masked) in ((10, False), (210, True))):
                continue  # time the main path's calls: bf16, L=10 unmasked and L=210 masked
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            ms = timed_ms(torch, lambda: fused_attention(q, k, v, mask))
            plain = timed_ms(torch, lambda: dot_product_attention(q, k, v, mask))
            lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
            elems = b * length * h * d_head
            bnd, by = bound_ms({"bf16": 4.0 * b * h * length * length * d_head},
                               4 * elems * 2 + (b * length * 4 if masked else 0))
            say(f"phase 4 K1 fused_attention bf16 L={length}: kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, "
                f"bound {bnd:.4f} ms ({by})")
            results[f"K1_L{length}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                                            bound_by=by, library_ms=lib)
            if length == 10:
                l10_inputs = (q, k, v)
            else:
                score_forms(torch, dev, l10_inputs, (q, k, v, mask), results, parts)

    k1_head_dims(torch, F, dev, results)
    k1_padded_dims(torch, F, dev, results)
    wide_kernels(torch, F, dev, results, parts)
    wgmma_kernels(torch, F, dev, results, parts)
    deep_kernels(torch, F, dev, results, parts)
    f32_wide_kernels(torch, F, dev, results, parts)
    wgmma_padded_kernels(torch, F, dev, results, parts)
    short_kernels(torch, F, dev, results, parts)
    k1_wrapper_times(torch, F, dev, results)
    k2_attention(torch, F, dev, randn, ragged_keep, parts)
    k2_gemms(torch, dev, randn, parts)

    block_checks(torch, dev, results, d=512, h=4, ffn=2048, k3_draws=K3_DRAWS)
    block_checks(torch, dev, results, **BLOCK_HD256, k3_draws=BLOCK_DRAWS, suffix="_hd256")
    block_checks(torch, dev, results, **BLOCK_HD512, k3_draws=BLOCK_DRAWS, suffix="_hd512")
    k2_at_iqap_shape(torch, dev, results)
    k2_at_iqap_shape(torch, dev, results, K2_HIER_SHAPE, "K2_bf16_hier",
                     "HierarchicalGenerator's encoder shape")
    kernel_checks(report.result(), libs)
    listing.shutdown()
    torch.cuda.empty_cache()
    main_path(torch, np, dev, results, parts)


def kernel_checks(kernels: dict, libs: dict) -> None:
    """Phase 2's checks of the built kernels (``kernel_report``'s registers,
    spills and SASS counts): each kernel's line, the one-pass, padded, deep
    and attention_wide.cuh kernels built at every head dim and depth they
    must take, each attention kernel and GEMM on the tensor cores, and
    ptxas's notes on wgmma it serialised.  Fails on a missing kernel or one
    without its tensor-core instructions."""
    from explainable_spatial_vqa_tpu_torch.ops import _build
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
        EXACT_HEAD_DIMS,
        MAX_HEAD_DIM,
        PADDED_DEPTHS,
    )

    say(f"phase 2 kernels: {len(kernels)} in {', '.join(sorted(libs))}, at most "
        f"{max(k['registers'] for k in kernels.values())} registers, "
        f"{max(k['spill'] for k in kernels.values())} bytes spilled (the SASS listed while "
        f"phases 3-4 ran)")
    for name, k in sorted(kernels.items()):
        say(f"phase 2 kernel {k['short']}: {k['registers']} registers, {k['spill']} bytes "
            f"spilled, SASS {k['HGMMA']} HGMMA (wgmma) and {k['HMMA']} HMMA (mma.sync)")
    onepass = sorted((re.search(r"attention_kernel_onepass<([^>]*)>", k["short"]).group(1), k)
                     for n, k in kernels.items() if "attention_kernel_onepass" in n)
    say("phase 2 one-pass K1 (attention_kernel_onepass<output type, head dim, warps>, up to "
        "256 keys' scores a warp): " + "; ".join(
            f"<{args}> {k['registers']} registers, {k['spill']} bytes spilled, {k['HMMA']} HMMA"
            for args, k in onepass))
    onepass_dims = sorted(int(re.sub(r"\D", "", args.split(",")[1])) for args, _ in onepass)
    if onepass_dims != [d for d in EXACT_HEAD_DIMS if d <= 64]:
        fail(f"phase 2: the one-pass kernel is built at head dims {onepass_dims}, not at every "
             f"head dim up to 64 of {EXACT_HEAD_DIMS}")
    missing = k1_functions_missing(kernels)
    say(f"phase 2 K1 at head dims {EXACT_HEAD_DIMS[0]}-{EXACT_HEAD_DIMS[-1]} (every multiple of "
        f"8): each "
        f"built as attention_kernel_f32<float|bf16, "
        f"D, 1|14>, attention_kernel<bf16, bf16, D, 1, 0> and, up to 64, "
        f"attention_kernel_onepass<bf16, D, 4>, every one with HMMA: "
        f"{'yes' if not missing else f'NO, missing or without HMMA {missing}'}")
    if missing:
        fail("phase 2: K1 is not built with HMMA at every head dim of EXACT_HEAD_DIMS")
    padded = sorted((k["short"].split("(const")[0].replace("void ", ""), k)
                    for n, k in kernels.items()
                    if any(f"attention_kernel_{kind}" in n for kind in ("padded", "deep", "short")))
    say("phase 2 padded K1 (attention_kernel_padded[_f32]<output type, per-warp depth, warps a "
        "16-row group, groups a block>, every other head dim up to 256, bf16 up to 128; past "
        "256 attention_kernel_deep_f32, the same code; past 128 at L <= 16 "
        "attention_kernel_short[_f32]<output type, per-warp depth, warps>): " + "; ".join(
            f"{name} {k['registers']} registers, {k['spill']} bytes spilled, {k['HMMA']} HMMA"
            for name, k in padded))
    missing = k1_padded_missing(kernels)
    say(f"phase 2 padded K1 at the depths {PADDED_DEPTHS}, to float and bf16 from float32 (and "
        f"to bf16 from bf16 up to 128), 8 warps a block (past 256 2 groups, 3 in float32 at "
        f"288-384) and one group up to 128, the short kernels past 128, every one with "
        f"HMMA: {'yes' if not missing else f'NO, missing or without HMMA {missing}'}")
    if missing:
        fail("phase 2: K1's padded kernels are not built with HMMA at every depth of "
             "PADDED_DEPTHS")
    missing = block_deep_missing()
    max_head_dim = _build.entry("fused_attention", "esv_attention_max_head_dim", ())()
    say(f"phase 2 the block library's deep and short kernels (K2's and K3's attention at head "
        f"dims 384 and 512, K3's on attention_kernel_wgmma_deep too; the short ones and K3's on "
        f"attention_kernel_wgmma_2pass_deep at 256 too) built: "
        f"{'yes' if not missing else f'NO, missing {missing}'}; K1's C library "
        f"takes head dims up to {max_head_dim} (MAX_HEAD_DIM {MAX_HEAD_DIM})")
    if missing or max_head_dim != MAX_HEAD_DIM:
        fail("phase 2: the deep kernels are not all built, or the C library's head-dim ceiling "
             "is not MAX_HEAD_DIM")
    # the one-pass wgmma kernels past depth 128 are built twice, the second
    # (kNarrow, "(bool)1") with the producer's narrow copies: one name each
    wide = sorted([(re.sub(r"\(int\)|, \(bool\)[01]", "",
                           k["short"].split("(const")[0].replace("void ", "")), k)
                   for n, k in kernels.items() if SPLIT_F32 in n or WGMMA in n],
                  key=lambda e: e[0])
    say("phase 2 attention_wide.cuh's kernels (float32 K1 and K2 at head dim 256; bf16 K1 and "
        "K3 on wgmma at 72-128 and at the padded depths 160-512 up to 256 keys, past 256 as "
        "attention_kernel_wgmma_deep, and past 256 keys at every head dim up to 128 "
        "(attention_kernel_wgmma_2pass) and every padded depth 160-512 "
        "(attention_kernel_wgmma_2pass_deep); built into fused_attention and fused_block): "
        + "; ".join(
            f"{name} {k['registers']} registers, {k['spill']} bytes spilled, {k['HGMMA']} HGMMA, "
            f"{k['HMMA']} HMMA" for name, k in wide))
    # the float32 kernel on mma.sync (HMMA) to float and bf16, the bf16 ones on
    # wgmma at each padded depth that launch_attention_dim and
    # launch_attention_wide reach
    want_wide = {f"{SPLIT_F32}<float>": "HMMA", f"{SPLIT_F32}<bf16>": "HMMA"}
    want_wide.update({f"{WGMMA}<bf16, {dp}>": "HGMMA" for dp in WGMMA_DEPTHS})
    want_wide.update({f"{WGMMA_DEEP}<bf16, {dp}>": "HGMMA" for dp in WGMMA_DEEP_DEPTHS})
    want_wide.update({f"{WGMMA_2PASS}<bf16, {dp}>": "HGMMA" for dp in WGMMA_2PASS_DEPTHS})
    want_wide.update({f"{WGMMA_2PASS_DEEP}<bf16, {dp}>": "HGMMA"
                      for dp in WGMMA_2PASS_DEEP_DEPTHS})
    for fn, unit in want_wide.items():
        found = [k for name, k in wide if name == fn]
        if not found or not all(k[unit] > 0 for k in found):
            fail(f"phase 2: {fn} is not built with {unit}: {found}")
    f32_wide = sorted(
        [(re.sub(r"\(int\)", "", k["short"].split("(const")[0].replace("void ", "")), k)
         for n, k in kernels.items() if WIDE_F32 in n], key=lambda e: e[0])
    say("phase 2 attention_f32_wide.cuh's kernel (float32 K1 past 16 keys at the padded depths "
        "160-224 and 288-512, K2's attention at 384 and 512; built into fused_attention and "
        "fused_block): " + "; ".join(
            f"{name} {k['registers']} registers, {k['spill']} bytes spilled, {k['HMMA']} HMMA"
            for name, k in f32_wide))
    for fn in (f"{WIDE_F32}<{to}, {dp}>" for dp in WIDE_F32_DEPTHS for to in ("float", "bf16")):
        found = [k for name, k in f32_wide if name == fn]
        if not found or not all(k["HMMA"] > 0 for k in found):
            fail(f"phase 2: {fn} is not built with HMMA: {found}")
    narrow = {kernel: sorted({int(m.group(1)) for n, k in kernels.items()
                              if k["short"].startswith(f"void {kernel}<")
                              for m in [re.search(r"<bf16, \(int\)(\d+), \(bool\)1>",
                                                  k["short"])] if m})
              for kernel in (WGMMA, WGMMA_DEEP, WGMMA_2PASS_DEEP)}
    say(f"phase 2 the wgmma kernels with the producer's narrow copies (rows that are not whole "
        f"16-byte chunks) built at the padded depths {narrow}")
    if (narrow[WGMMA] + narrow[WGMMA_DEEP] != list(WGMMA_2PASS_DEEP_DEPTHS)
            or narrow[WGMMA_2PASS_DEEP] != list(WGMMA_2PASS_DEEP_DEPTHS)):
        fail("phase 2: the narrow-copy wgmma kernels are not built at every padded depth past 128")
    tf32_gemms = sorted(k["short"] for n, k in kernels.items() if "gemm_tf32_wgmma" in n)
    say(f"phase 2 float32 GEMM instantiations (3xTF32): {', '.join(tf32_gemms) or 'none'}")
    for name in libs:  # ptxas notes a wgmma it had to wait on before the next
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "wgmma" in line and "serialized" in line:
                say(f"phase 2 ptxas ({name}): {line.strip()}")
    tensor_core_checks = {
        "every attention kernel runs HMMA (HGMMA: attention_kernel_wgmma)": all(
            k["HGMMA" if WGMMA in n else "HMMA"] > 0
            for n, k in kernels.items() if "attention_kernel" in n),
        "every wgmma GEMM runs HGMMA": all(
            k["HGMMA"] > 0 for n, k in kernels.items() if "gemm_bf16_wgmma" in n),
        "every float32 GEMM runs HGMMA": bool(tf32_gemms) and all(
            k["HGMMA"] > 0 for n, k in kernels.items() if "gemm_tf32_wgmma" in n),
        "both are built": (any("attention_kernel" in n for n in kernels)
                           and any("gemm_bf16_wgmma" in n for n in kernels)),
    }
    for name, ok in tensor_core_checks.items():
        if not ok:
            fail(f"phase 2 check failed: {name}")


def block_checks(torch, dev, results: dict, d: int, h: int, ffn: int, k3_draws,
                 suffix: str = "") -> None:
    """Phases 3-4 for K2 at the fusion encoder's shape (B=128, L=210) and K3
    at the block bench's (L=224, ``K3_TILING``) at width d, h heads, ffn:
    each against its plain version in bf16 on its draws (K2 on
    ``BLOCK_DRAWS``, K3 on ``k3_draws``) and in float32 on the first, with
    each bf16 check's negative control, K3's own q/k/v (``k3_qkv``) and a
    float32 x with bf16 weights (the mean error within ``block_mean_ulps``); then timed beside
    ``nn.TransformerEncoderLayer`` and the bound.  Results go to
    ``results["K2_bf16" + suffix]`` and the like."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
        fused_encoder_block,
        fused_encoder_block_plain,
        fused_encoder_block_tiled,
        fused_encoder_block_tiled_plain,
        split_block_weights,
    )

    # K2 at the fusion encoder's shape and K3 at the block bench's, bf16 on
    # each of their draws (block_inputs), fp32 on the first; the first draw's
    # inputs are timed.  Each block kernel's bf16 check has a negative
    # control, the other kernel's plain version: K3's arithmetic rounds q, k
    # and v to bf16 after the bias, K2's keeps them float32; the check must
    # see the difference.
    def k3(x, keep, w, h, split=None):
        return fused_encoder_block_tiled(x, keep, w, h, **K3_TILING, split=split)

    def k3_plain(x, keep, w, h):
        return fused_encoder_block_tiled_plain(x, keep, w, h, **K3_TILING)

    b, mean = SLOTS, block_mean_ulps(d)  # the bf16 checks' mean-error limit
    names = {torch.bfloat16: "bf16", torch.float32: "fp32"}
    blocks = (
        # name, kernel, plain, control, L, attention on float32 q/k/v, bf16 draws
        ("K2", "fused_encoder_block", fused_encoder_block, fused_encoder_block_plain, k3_plain,
         210, True, BLOCK_DRAWS),
        ("K3", f"fused_encoder_block_tiled {K3_TILING}", k3, k3_plain, fused_encoder_block_plain,
         224, False, k3_draws),
    )
    for key, label, kernel, plain_fn, control_fn, length, f32_attention, draws in blocks:
        for dtype in (torch.bfloat16, torch.float32):
            for draw in draws if dtype == torch.bfloat16 else draws[:1]:
                keep, w, x = block_inputs(torch, dev, draw, length, dtype, d=d, ffn=ffn)
                # float32 weights' split, made once as the model keeps it
                out = kernel(x, keep, w, h, split=split_block_weights(w))
                ref = plain_fn(x, keep, w, h)
                torch.cuda.synchronize()
                if draw == draws[0]:
                    err = float((out.float() - ref.float()).abs().max())
                head = (f"phase 3 {key} {label} {names[dtype]} B={b} L={length} d={d} H={h} "
                        f"ffn={ffn} mask=ragged, draw {draw}:")
                if dtype == torch.float32:
                    # sums of up to ffn products taken in another order,
                    # through four chained products and two LayerNorms
                    say(f"{head} max_abs_err {err:.3g} (tol 1e-4)")
                    if not err <= 1e-4:
                        fail(f"{key} disagrees with its plain version")
                    continue
                stats = bf16_agreement(torch, out, ref)
                say(f"{head} {bf16_text(stats, mean)}")
                if not bf16_ok(stats, mean):
                    fail(f"{key} disagrees with its plain version on draw {draw}")
                control = bf16_agreement(torch, control_fn(x, keep, w, h), ref)
                other = "K3" if key == "K2" else "K2"
                say(f"phase 3 {key} negative control, {other}'s plain version "
                    f"({'bf16' if key == 'K2' else 'float32'} q/k/v): {bf16_text(control, mean)}: "
                    f"{'passes' if bf16_ok(control, mean) else 'fails'}")
                if bf16_ok(control, mean):
                    fail(f"the bf16 check cannot tell {other}'s arithmetic from {key}'s")
                if key == "K3":
                    found = k3_qkv(torch, x, keep, w, h)
                    say(f"phase 3 K3 draw {draw}: {k3_qkv_text(found)}")
                    if found["kernel_share"] > 0:
                        fail("K3 rounds q/k/v otherwise than the correctly rounded float32 sum")
                    if draw == draws[0]:
                        k3_qkv_times(torch, x.reshape(-1, d), w, found["near_share"])
                if draw == draws[0]:
                    # float32 x with the bf16 weights: the kernel rounds x to
                    # bf16 in a pass of its own for the QKV product's TMA loads
                    x32 = torch.randn(b, length, d, generator=torch.Generator(
                        device=dev).manual_seed(100), device=dev)
                    stats = bf16_agreement(torch, kernel(x32, keep, w, h).bfloat16(),
                                           plain_fn(x32, keep, w, h).bfloat16())
                    say(f"phase 3 {key} float32 x, bf16 weights, outputs rounded to bf16: "
                        f"{bf16_text(stats, mean)}")
                    if not bf16_ok(stats, mean):
                        fail(f"{key} with float32 x disagrees with its plain version")
                    del x32
            keep, w, x = block_inputs(torch, dev, draws[0], length, dtype, d=d, ffn=ffn)
            split = split_block_weights(w)
            ref = plain_fn(x, keep, w, h)
            layer = library_layer(torch, w, d, h, ffn, dtype)
            pad = ~keep

            def library():
                with torch.no_grad():
                    return layer(x, src_key_padding_mask=pad)

            lib_out = library()
            lib_err = (bf16_text(bf16_agreement(torch, lib_out, ref)) if dtype == torch.bfloat16
                       else f"max_abs_err {float((lib_out - ref).abs().max()):.3g}")
            del lib_out
            ms = timed_ms(torch, lambda: kernel(x, keep, w, h, split=split), iters=10)
            plain = timed_ms(torch, lambda: plain_fn(x, keep, w, h), iters=10)
            lib = timed_ms(torch, library, iters=10)
            esize = 2 if dtype == torch.bfloat16 else 4
            rows = b * length
            # the four products in the weights' type, the attention in q, k
            # and v's (float32 for K2), each type's dot products at its
            # least time (dot_ops)
            gemm_ops = rows * (2.0 * d * 3 * d + 2 * d * d + 4 * d * ffn)
            attn_ops = 4.0 * b * h * length * length * (d // h)
            attn_type = "fp32" if f32_attention else names[dtype]
            ops = dot_ops(names[dtype], gemm_ops)
            for kind, n in dot_ops(attn_type, attn_ops).items():
                ops[kind] = ops.get(kind, 0.0) + n
            nbytes = (2 * rows * d * esize + (4 * d * d + 2 * d * ffn) * esize
                      + (3 * d + d + ffn + d + 4 * d) * 4 + rows * 4)
            bnd, by = bound_ms(ops, nbytes)
            width = f" d={d} H={h}" if suffix else ""
            say(f"phase 4 {key} {label}{width} {names[dtype]} L={length}: kernel {ms:.3f} ms, "
                f"plain {plain:.3f} ms, nn.TransformerEncoderLayer {lib:.3f} ms (against the "
                f"plain version: {lib_err}), bound {bnd:.4f} ms ({by}; {gemm_ops / 1e9:.1f} "
                f"GFLOP of products {dot_text(names[dtype], gemm_ops)}, {attn_ops / 1e9:.1f} "
                f"GFLOP of attention {dot_text(attn_type, attn_ops)}), "
                f"{(gemm_ops + attn_ops) / ms / 1e9:.1f} TFLOP/s")
            results[f"{key}_{names[dtype]}{suffix}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib)
            del layer, x, out, ref, w, split


PROFILE_TRIES = 3  # profiles of one K1 call (k1_launched) or one 16.1 forward before giving up


def k1_launched(torch, fn, calls: int = 20):
    """The kernel functions whose name holds ``attention_kernel`` that
    ``calls`` calls of ``fn`` ran on the card (torch.profiler), and their
    device ms per call.  A profile that sees no device activity at all
    (CUPTI returned none now and then in a run of many profiles) is taken
    again, up to ``PROFILE_TRIES`` times, and said; then the phase fails."""
    for attempt in range(1, PROFILE_TRIES + 1):
        _, prof = device_profile(torch, lambda: [fn() for _ in range(calls)])
        if prof is not None:
            break
        say(f"torch.profiler saw no device activity in profile {attempt} of {PROFILE_TRIES}")
    else:
        fail("torch.profiler saw no device activity: K1's kernel cannot be named")
    found = [(name, ms) for name, ms in prof[1] if "attention_kernel" in name]
    return {re.search(r"(attention_kernel\w*)", n).group(1) for n, _ in found}, \
        sum(ms for _, ms in found) / calls


def k1_kernel_ran(before: dict) -> str:
    """The K1 kernel function that the one call since ``before`` (a reading
    of ``ops.fused_attention.kernel_launches``) launched; fails unless
    exactly one kernel was launched once."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import kernel_launches

    moved = {n: c - before[n] for n, c in kernel_launches().items() if c != before[n]}
    if list(moved.values()) != [1]:
        fail(f"one K1 call launched {moved}, not one kernel once")
    return next(iter(moved))


def k1_checked(torch, name, q, k, v, mask, want, head):
    """One K1 wrapper call: fail unless it launched ``want`` and agrees with
    the plain version (bf16: ``attention_agreement``; float32: within
    ``k1_f32_tol``); the output and its largest error against the plain
    version."""
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
        fused_attention,
        kernel_launches,
    )

    before = kernel_launches()
    out = fused_attention(q, k, v, mask)
    ran = k1_kernel_ran(before)
    ref = dot_product_attention(q, k, v, mask)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    if name == "bf16":
        stats = attention_agreement(torch, out, q, k, v, mask)
        say(f"{head} ({ran}): {bf16_text(stats)}, {stats['outside']} outside")
        ok = bf16_ok(stats)
    else:
        length = q.shape[1]
        say(f"{head} ({ran}): max_abs_err {err:.3g} (tol {k1_f32_tol_text(length)})")
        ok = err <= k1_f32_tol(length)
    if ran != want:
        fail(f"{head} launched {ran}, not {want}")
    if not ok:
        fail(f"{head}: K1 disagrees with its plain version")
    return out, err


def k1_profiled(torch, q, k, v, mask, want, where):
    """Fail unless a profile of the wrapper's calls names ``want`` alone;
    its device ms a call."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention

    ran, ms = k1_launched(torch, lambda: fused_attention(q, k, v, mask))
    say(f"{where}: the profile names {', '.join(sorted(ran))} ({ms:.4f} ms of device time "
        f"a call)")
    if ran != {want}:
        fail(f"{where}: the profile names {sorted(ran)}, not {want}")
    return ms


def k1_timed_shape(torch, F, randn, ragged_keep, results: dict, shape, profile: bool) -> None:
    """Phase 4 for K1 at one shape (label, head dim, B, L, key mask, type,
    as ``K1_MODEL_SHAPES``): ``k1_checked``, then the kernel through its
    wrapper, the plain version and ``scaled_dot_product_attention`` timed,
    beside the bound (4 L^2 D operations a head, counted by ``dot_ops``; q,
    k, v, the output and the mask each moved once); with ``profile`` the
    kernel named by a profile, which gives its device time.  The result goes
    to ``results["K1_D{d}_{label}"]``."""
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention

    label, d_head, b, length, masked, name = shape
    h = 4
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[name]
    q, k, v = (randn(b, length, h, d_head, dtype=dtype) for _ in range(3))
    mask = ragged_keep(b, length, 13)[:, None, None, :] if masked else None
    head = (f"phase 4 K1 fused_attention {name} D={d_head} at the {label}'s shape (B={b} "
            f"H={h} L={length} mask={'ragged' if masked else 'none'})")
    want = k1_kernel(d_head, length, name)
    out, err = k1_checked(torch, name, q, k, v, mask, want, head)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = timed_ms(torch, lambda: fused_attention(q, k, v, mask))
    plain = timed_ms(torch, lambda: dot_product_attention(q, k, v, mask))
    lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    esize = 2 if name == "bf16" else 4
    bnd, by = bound_ms(dot_ops(name, 4.0 * b * h * length * length * d_head),
                       4 * b * length * h * d_head * esize + (b * length * 4 if masked else 0))
    say(f"{head}: kernel {ms:.4f} ms, plain {plain:.4f} ms, scaled_dot_product_attention "
        f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}); max_abs_err {err:.3g}")
    results[f"K1_D{d_head}_{label}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                            bound_ms=bnd, bound_by=by, library_ms=lib,
                                            kernel=want)
    if profile:
        results[f"K1_D{d_head}_{label}"]["device_ms"] = k1_profiled(torch, q, k, v, mask, want,
                                                                   head)


def k1_head_dims(torch, F, dev, results: dict) -> None:
    """Phases 3-4 for K1 at head dims 24, 48 and 64 (``K1_MODEL_DIMS``): the
    kernel against its plain version (``dot_product_attention``) at every
    length of ``K1_CHECK_LENGTHS`` in float32 (within 1e-5) and bf16
    (``attention_agreement``), each call's kernel function read from the C
    library's launch counts (``ops.fused_attention.kernel_launches``) and
    held to the table's (the one-pass kernel's edges 17 and 256, the
    two-pass kernel at 257), and at ``TWO_PASS_PROFILE`` from a profile too;
    the same at the head dims no preset has (``K1_NEW_DIMS``) at
    ``K1_NEW_DIM_LENGTHS``, masked and not, on draws of their own; then at
    each shape of ``K1_MODEL_SHAPES`` the same check, the kernel through its
    wrapper, the plain version and ``scaled_dot_product_attention`` timed,
    beside the bound (4 L^2 D operations a head, counted by ``dot_ops``; q,
    k, v, the output and the mask each moved once), and at the models' bf16
    shapes the one-pass kernel named by its launch count and by a profile,
    which gives its device time.  Results go to
    ``results["K1_D{d}_{label}"]``.  The inputs come from generators of their
    own, so the draws of the phases after these are what they were without
    them."""
    gen = torch.Generator(device=dev).manual_seed(14)
    gen_new = torch.Generator(device=dev).manual_seed(16)  # phase 3 at the new head dims
    t0 = time.perf_counter()

    def randn(*shape, dtype, g=gen):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def ragged_keep(batch, length, tail, g=gen):
        """Key mask keeping all but a random subset of the last ``tail`` keys."""
        keep = torch.ones(batch, length, dtype=torch.bool, device=dev)
        keep[:, length - tail:] = torch.rand(batch, tail, generator=g, device=dev) < 0.6
        return keep

    types = {"bf16": torch.bfloat16, "fp32": torch.float32}
    b, h = SLOTS, 4
    for d_head in K1_MODEL_DIMS:
        for length, masked, bf16_kernel in K1_CHECK_LENGTHS:
            for name, dtype in types.items():
                q, k, v = (randn(b, length, h, d_head, dtype=dtype) for _ in range(3))
                mask = ragged_keep(b, length, 13)[:, None, None, :] if masked else None
                head = (f"phase 3 K1 fused_attention {name} B={b} H={h} L={length} D={d_head} "
                        f"mask={'ragged' if masked else 'none'}")
                want = bf16_kernel if name == "bf16" else "attention_kernel_f32"
                out, _ = k1_checked(torch, name, q, k, v, mask, want, head)
                if name == "bf16" and (d_head, length) == TWO_PASS_PROFILE:
                    k1_profiled(torch, q, k, v, mask, want, head)
                del q, k, v, out
    t_new = time.perf_counter()
    b = K1_NEW_DIM_BATCH
    for d_head in K1_NEW_DIMS:
        for length in K1_NEW_DIM_LENGTHS:
            for masked in (False, True):
                for name, dtype in types.items():
                    q, k, v = (randn(b, length, h, d_head, dtype=dtype, g=gen_new)
                               for _ in range(3))
                    mask = (ragged_keep(b, length, min(length, 13), g=gen_new)[:, None, None, :]
                            if masked else None)
                    head = (f"phase 3 K1 fused_attention {name} B={b} H={h} L={length} "
                            f"D={d_head} mask={'ragged' if masked else 'none'}")
                    want = (k1_bf16_kernel(d_head, length) if name == "bf16"
                            else "attention_kernel_f32")
                    out, _ = k1_checked(torch, name, q, k, v, mask, want, head)
                    del q, k, v, out
    say(f"phase 3 K1 at the head dims {K1_NEW_DIMS}: {len(K1_NEW_DIMS)} x "
        f"{len(K1_NEW_DIM_LENGTHS)} lengths x 2 masks x 2 types checked in "
        f"{time.perf_counter() - t_new:.1f} s")
    for shape in K1_MODEL_SHAPES:  # the models' bf16 shapes and the wgmma kernel's: a profile too
        k1_timed_shape(torch, F, randn, ragged_keep, results, shape,
                       profile=shape[5] == "bf16" and (shape[1] in K1_MODEL_DIMS
                                                       or k1_bf16_kernel(*shape[1:4:2]) == WGMMA))
    say(f"phases 3-4 K1 at head dims {K1_MODEL_DIMS} and {K1_NEW_DIMS} took "
        f"{time.perf_counter() - t0:.1f} s")


def k1_padded_dims(torch, F, dev, results: dict) -> None:
    """Phases 3-4 for K1 on the padded kernels (``attention_kernel_padded``
    in bf16, ``attention_kernel_padded_f32`` in float32: every head dim up
    to 256 without kernels of its own) and past the old 1024-key cap: each
    head dim of ``K1_PADDED_DIMS`` at ``K1_PADDED_LENGTHS`` in both types
    (ragged masks; at 208 unmasked too), then ``K1_LONG_ROWS`` (1025 and
    4096 keys), each call's kernel function read from the C library's
    launch counts and held by ``k1_checked``; then ``K1_NEW_SHAPES`` checked
    and timed by ``k1_timed_shape``, the kernel also named by a profile at
    the protocol's and serving's shapes.  Draws from a generator of their
    own."""
    gen = torch.Generator(device=dev).manual_seed(17)
    t0 = time.perf_counter()

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def ragged_keep(batch, length, tail):
        """Key mask keeping all but a random subset of the last ``tail`` keys."""
        keep = torch.ones(batch, length, dtype=torch.bool, device=dev)
        keep[:, length - tail:] = torch.rand(batch, tail, generator=gen, device=dev) < 0.6
        return keep

    types = {"bf16": torch.bfloat16, "fp32": torch.float32}
    h, checks = 4, 0
    for d_head in K1_PADDED_DIMS:
        for length in K1_PADDED_LENGTHS:
            b = K1_NEW_DIM_BATCH if length <= 256 else 8
            for masked in (False, True) if length == 208 else (True,):
                for name, dtype in types.items():
                    q, k, v = (randn(b, length, h, d_head, dtype=dtype) for _ in range(3))
                    mask = (ragged_keep(b, length, min(length, 13))[:, None, None, :]
                            if masked else None)
                    head = (f"phase 3 K1 fused_attention {name} B={b} H={h} L={length} "
                            f"D={d_head} mask={'ragged' if masked else 'none'}")
                    out, _ = k1_checked(torch, name, q, k, v, mask,
                                        k1_kernel(d_head, length, name), head)
                    checks += 1
                    del q, k, v, out
    say(f"phase 3 K1 on the padded kernels at the head dims {K1_PADDED_DIMS}: {checks} calls "
        f"at L = {K1_PADDED_LENGTHS} checked in {time.perf_counter() - t0:.1f} s")
    t_long = time.perf_counter()
    for d_head, b, length in K1_LONG_ROWS:
        for name, dtype in types.items():
            q, k, v = (randn(b, length, h, d_head, dtype=dtype) for _ in range(3))
            mask = ragged_keep(b, length, 13)[:, None, None, :]
            head = (f"phase 3 K1 fused_attention {name} B={b} H={h} L={length} D={d_head} "
                    f"mask=ragged")
            out, _ = k1_checked(torch, name, q, k, v, mask, k1_kernel(d_head, length, name), head)
            del q, k, v, out
    say(f"phase 3 K1 past 1024 keys (up to MAX_LEN) at {len(K1_LONG_ROWS)} shapes x 2 types "
        f"checked in {time.perf_counter() - t_long:.1f} s")
    for shape in K1_NEW_SHAPES:
        k1_timed_shape(torch, F, randn, ragged_keep, results, shape,
                       profile=(shape[3] <= 208 and shape[1] in (25, 136, 256))
                       or k1_kernel(*shape[1:4:2], shape[5]) == WGMMA_2PASS)
    say(f"phases 3-4 K1 on the padded kernels and past 1024 keys took "
        f"{time.perf_counter() - t0:.1f} s")


# The head-dim-256 kernels (csrc/attention_wide.cuh), phases 3-4: each held
# against its plain version at WIDE_DIMS (256, and 232: padded depth 256 with
# zero columns) at these lengths, ragged and unmasked, in K1's (B, L, H, D)
# layout through the wrapper and, at 256, in K2's and K3's strided (B, L, 3d)
# buffer through the block library's esv_block_attention; then timed at
# measure/attention_variants.py's WIDE_CASES beside the plain version, SDPA
# and the bound
WIDE_DIMS = (256, 232)
WIDE_BF16_LENGTHS = (17, 64, 208, 210, 224, 256)
WIDE_F32_LENGTHS = (208, 1025, 4096)


def wide_batch(length: int) -> int:
    return 32 if length <= 256 else 8 if length <= 1024 else 2


def block_called(torch, fn, name, q, k, v, mask, out_dtype, head, want, counts=None):
    """One call of the blocks' attention alone (``esv_block_attention``, bound
    as ``fn``; or K1's ``esv_attention`` with ``counts`` its library's
    ``kernel_launches``) on q, k, v, the thirds of a (B, L, 3d) buffer of 4
    heads: fail unless it launched ``want`` (the library's counts, by default
    the block library's) and agrees with the plain version (float32 outputs
    within ``k1_f32_tol``; bf16 outputs of float32 q/k/v by
    ``bf16_agreement`` against the plain version rounded, of bf16 q/k/v by
    ``attention_agreement``).  The output and its largest error."""
    from explainable_spatial_vqa_tpu_torch.ops import fused_block
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import call_rows

    counts = counts or fused_block.kernel_launches
    b, length, d = q.shape
    heads = [t.reshape(b, length, 4, d // 4) for t in (q, k, v)]
    before = counts()
    out = call_rows(fn, q, k, v, mask, 4, out_dtype)
    moved = {n: c - before[n] for n, c in counts().items() if c != before[n]}
    ref = dot_product_attention(*heads, mask).reshape(b, length, d)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    if out_dtype == torch.float32:
        text = f"max_abs_err {err:.3g} (tol {k1_f32_tol_text(length)})"
        ok = err <= k1_f32_tol(length)
    else:
        stats = (bf16_agreement(torch, out, ref.bfloat16()) if name == "fp32" else
                 attention_agreement(torch, out.reshape(b, length, 4, d // 4), *heads, mask))
        text, ok = bf16_text(stats), bf16_ok(stats)
    say(f"{head} ({moved}): {text}")
    if moved != {want: 1}:
        fail(f"{head} launched {moved}, not {want} once")
    if not ok:
        fail(f"{head}: the blocks' attention disagrees with its plain version")
    return out, err


def attention_case(torch, F, randn, ragged, block_fn, case, source: str, results: dict,
                   parts: list, prefix: str, profile: bool = False) -> None:
    """Phase 4 for one attention shape ``case`` (label, layout, head dim, B,
    L, key mask, q/k/v type, output type; layout "K1": the wrapper on (B,
    L, H, D) tensors, "block": ``esv_block_attention``, bound as
    ``block_fn``, on the thirds of a (B, L, 3d) buffer, the attention of K2
    (float32 q/k/v) or K3 (bf16)), 4 heads: checked by ``k1_checked`` or
    ``block_called``, then timed beside the plain version,
    ``scaled_dot_product_attention`` (its backend named, ``sdpa_backend``)
    and the bound (4 L^2 D operations a head by ``dot_ops``; q, k, v, the
    output and the mask each moved once); with ``profile`` the kernel named
    by a profile, which gives its device time (``device_ms``).  The result
    goes to ``results[prefix + " " + label]`` and, for a block layout, to
    ``parts`` with ``source``.  ``randn(*shape, dtype=)`` and ``ragged(B,
    L)`` draw the inputs."""
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import call_rows, fused_attention

    label, layout, d_head, b, length, masked, name, out_name = case
    types = {"bf16": torch.bfloat16, "fp32": torch.float32}
    d, h = 4 * d_head, 4
    dtype, out_dtype = types[name], types[out_name]
    mask = ragged(b, length) if masked else None
    where = f"B={b} H={h} L={length} D={d_head} {'ragged' if masked else 'no mask'}"
    if layout == "K1":
        q, k, v = (randn(b, length, d, dtype=dtype) for _ in range(3))
    else:
        q, k, v = randn(b, length, 3 * d, dtype=dtype).split(d, dim=-1)
    heads = [t.reshape(b, length, h, d_head) for t in (q, k, v)]
    want = (k1_kernel if layout == "K1" else block_attention_kernel)(d_head, length, name)
    if layout == "K1":  # the wrapper the models call
        out, err = k1_checked(torch, name, *heads, mask, want,
                              f"phase 4 K1 fused_attention {name} {label} {where}")
        call = lambda: fused_attention(*heads, mask)  # noqa: E731
    else:
        out, err = block_called(torch, block_fn, name, q, k, v, mask, out_dtype,
                                f"phase 4 {label} {where}", want)
        call = lambda: call_rows(block_fn, q, k, v, mask, h, out_dtype)  # noqa: E731
    ms = timed_ms(torch, call)
    plain = timed_ms(torch, lambda: dot_product_attention(*heads, mask).to(out_dtype))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in heads)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
    lib = timed_ms(torch, sdpa)
    backend = sdpa_backend(torch, sdpa)
    esize, osize = (2 if name == "bf16" else 4), (2 if out_name == "bf16" else 4)
    bnd, by = bound_ms(dot_ops(name, 4.0 * b * h * length * length * d_head),
                       3 * b * length * d * esize + b * length * d * osize
                       + (b * length * 4 if masked else 0))
    device = None
    if profile:
        ran, device = k1_launched(torch, call)
        if ran != {want}:
            fail(f"phase 4 {label} ({where}): the profile names {sorted(ran)}, not {want}")
    say(f"phase 4 {label} ({where}, {name} q/k/v, {out_name} out, {want}): kernel "
        f"{ms:.4f} ms" + (f" (device time {device:.4f} ms by profile)" if profile else "")
        + f", plain {plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms "
        f"(backend {backend}), bound {bnd:.4f} ms ({by}); max_abs_err {err:.3g}")
    key = f"{prefix} {label}"
    results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                        library_ms=lib, library=backend, kernel=want, shape=where)
    if profile:
        results[key]["device_ms"] = device
    if layout == "block":
        parts.append(dict(
            name=f"attention_{name}_hd{d_head}_L{length}", route="cuda", source=source,
            replaces=("explainable_spatial_vqa_tpu/ops/pallas_block.py:135" if name == "fp32"
                      else "explainable_spatial_vqa_tpu/ops/pallas_block.py:232"),
            inside=("fused_encoder_block" if name == "fp32" else "fused_encoder_block_tiled"),
            **results[key]))


def wide_kernels(torch, F, dev, results: dict, parts: list) -> None:
    """Phases 3-4 for ``attention_kernel_split_f32`` (float32 q, k, v past 16
    keys) and ``attention_kernel_wgmma`` (bf16, 17-256 keys) at head dim 256:
    the checks above ``WIDE_DIMS``, each call's kernel read from the C
    libraries' counts, then each of ``WIDE_CASES`` timed through the
    wrapper (K1) or ``esv_block_attention`` (K2's and K3's attention) beside
    the plain version, ``scaled_dot_product_attention`` and the bound.
    Results go to ``results["wide <label>"]`` and, for K2's and K3's, to
    ``parts``."""
    from explainable_spatial_vqa_tpu_torch.measure.attention_variants import WIDE_CASES
    from explainable_spatial_vqa_tpu_torch.ops import _build
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import bind_entry

    gen = torch.Generator(device=dev).manual_seed(18)
    t0 = time.perf_counter()
    types = {"bf16": torch.bfloat16, "fp32": torch.float32}
    block_fn = bind_entry(_build.load("fused_block"), "esv_block_attention")

    def ragged(b, length):
        keep = torch.ones(b, length, dtype=torch.bool, device=dev)
        keep[:, length - 13:] = torch.rand(b, 13, generator=gen, device=dev) < 0.6
        return keep[:, None, None, :]

    checks = 0
    for d_head in WIDE_DIMS:
        for name, lengths in (("bf16", WIDE_BF16_LENGTHS), ("fp32", WIDE_F32_LENGTHS)):
            dtype = types[name]
            for length in lengths:
                b = wide_batch(length)
                for masked in (True, False):
                    mask = ragged(b, length) if masked else None
                    where = f"B={b} H=4 L={length} D={d_head} mask={'ragged' if masked else 'none'}"
                    q, k, v = (torch.randn(b, length, 4, d_head, generator=gen, device=dev)
                               .to(dtype) for _ in range(3))
                    k1_checked(torch, name, q, k, v, mask, k1_kernel(d_head, length, name),
                               f"phase 3 K1 fused_attention {name} {where}")
                    checks += 1
                    del q, k, v
                    if d_head != 256:
                        continue
                    d = 4 * d_head
                    qkv = torch.randn(b, length, 3 * d, generator=gen, device=dev).to(dtype)
                    outs = (torch.bfloat16, torch.float32) if name == "fp32" else (torch.bfloat16,)
                    for out_dtype in outs:
                        block_called(torch, block_fn, name, *qkv.split(d, dim=-1), mask, out_dtype,
                                     f"phase 3 {'K2' if name == 'fp32' else 'K3'} attention "
                                     f"{name} q/k/v from the (B, L, 3d) buffer, "
                                     f"{'fp32' if out_dtype == torch.float32 else 'bf16'} out, "
                                     f"{where}",
                                     block_attention_kernel(d_head, length, name))
                        checks += 1
                    del qkv
    say(f"phase 3 the head-dim-256 kernels: {checks} calls at D = {WIDE_DIMS}, bf16 L = "
        f"{WIDE_BF16_LENGTHS}, float32 L = {WIDE_F32_LENGTHS} checked in "
        f"{time.perf_counter() - t0:.1f} s")

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for label, layout, name, out_name, b, length in WIDE_CASES:
        attention_case(torch, F, randn, ragged, block_fn,
                       (label, layout, 256, b, length, True, name, out_name),
                       "explainable_spatial_vqa_tpu_torch/csrc/attention_wide.cuh", results,
                       parts, "wide")
    say(f"phases 3-4 the head-dim-256 kernels took {time.perf_counter() - t0:.1f} s")


# The bf16 wgmma kernels at head dims up to 128 (csrc/attention_wide.cuh),
# phases 3-4: attention_kernel_wgmma at each head dim of WGMMA_DIMS and
# length of WGMMA_LENGTHS, attention_kernel_wgmma_2pass at TWO_PASS_DIMS x
# TWO_PASS_LENGTHS, ragged and unmasked, in K1's (B, L, H, D) layout through
# the wrapper and in K3's (B, L, 3d) buffer of 4 heads (esv_block_attention
# at head dim 128, K1's esv_attention on the buffer's strides at the
# others); the negative control at NEGATIVE_SHAPES; then K3's attention at
# head dim 128 timed at K3_HD128_TIMED beside the plain version, SDPA and the
# bound
WGMMA_DIMS = tuple(range(72, 129, 8))
WGMMA_LENGTHS = (17, 208, 224, 256)
TWO_PASS_DIMS = (8, 64, 72, 128)
TWO_PASS_LENGTHS = (257, 1025, 4096)
NEGATIVE_SHAPES = ((72, 32, 208), (128, 8, 1025))  # head dim, B, L
K3_HD128_TIMED = ((128, 224), (128, 304))  # B, L: the block bench's rows, past 256 keys at 304


def rounded_first(torch, q, k, v, mask):
    """The negative control of the bf16 check: the attention with its
    weights rounded to bf16 before they are normalised (exp(s - max) rounded,
    P V summed in float32 and then divided by the sum + 1e-30), which the
    TPU kernel does not compute; (B, L, H, D) in and out."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", e.to(q.dtype).float(), v.float())
    return (out / (e.sum(-1) + 1e-30).transpose(1, 2)[..., None]).to(q.dtype)


def wgmma_kernels(torch, F, dev, results: dict, parts: list) -> None:
    """Phases 3-4 for ``attention_kernel_wgmma`` (bf16, head dims 72-128,
    17-256 keys) and ``attention_kernel_wgmma_2pass`` (bf16, every multiple
    of 8 up to 128, past 256 keys): the checks above ``K3_HD128_TIMED``,
    each call's kernel read from the C libraries' counts, where the ring must
    not run; the negative control (``rounded_first``) must fail the bf16
    check; then K3's attention at head dim 128 at ``K3_HD128_TIMED`` through
    ``esv_block_attention`` beside the plain version,
    ``scaled_dot_product_attention`` and the bound.  Results go to
    ``results["wgmma <label>"]`` and ``parts``."""
    from explainable_spatial_vqa_tpu_torch.ops import _build
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
        bind_entry,
        call_rows,
        kernel_launches,
    )

    gen = torch.Generator(device=dev).manual_seed(19)
    t0 = time.perf_counter()
    block_fn = bind_entry(_build.load("fused_block"), "esv_block_attention")
    k1_fn = bind_entry(_build.load("fused_attention"))

    def ragged(b, length):
        keep = torch.ones(b, length, dtype=torch.bool, device=dev)
        keep[:, length - 13:] = torch.rand(b, 13, generator=gen, device=dev) < 0.6
        return keep[:, None, None, :]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    checks = 0
    shapes = ([(d, length) for d in WGMMA_DIMS for length in WGMMA_LENGTHS]
              + [(d, length) for d in TWO_PASS_DIMS for length in TWO_PASS_LENGTHS])
    for d_head, length in shapes:
        b = wide_batch(length)
        want = k1_bf16_kernel(d_head, length)
        if want not in (WGMMA, WGMMA_2PASS):
            fail(f"the routing mirror names {want} for bf16 at D={d_head}, L={length}, not a "
                 f"wgmma kernel")
        for masked in (True, False):
            mask = ragged(b, length) if masked else None
            where = (f"B={b} H=4 L={length} D={d_head} mask={'ragged' if masked else 'none'}")
            q, k, v = (randn(b, length, 4, d_head) for _ in range(3))
            k1_checked(torch, "bf16", q, k, v, mask, want, f"phase 3 K1 fused_attention bf16 {where}")
            del q, k, v
            d = 4 * d_head
            q, k, v = randn(b, length, 3 * d).split(d, dim=-1)
            if d_head == 128:
                block_called(torch, block_fn, "bf16", q, k, v, mask, torch.bfloat16,
                             f"phase 3 K3 attention bf16 q/k/v from the (B, L, 3d) buffer, {where}",
                             block_attention_kernel(d_head, length, "bf16"))
            else:
                block_called(torch, k1_fn, "bf16", q, k, v, mask, torch.bfloat16,
                             f"phase 3 K1 esv_attention bf16 on a (B, L, 3d) buffer's strides, "
                             f"{where}", want, counts=kernel_launches)
            checks += 2
            del q, k, v
    say(f"phase 3 the wgmma kernels at head dims up to 128: {checks} calls (attention_kernel_wgmma "
        f"at D = {WGMMA_DIMS[0]}-{WGMMA_DIMS[-1]}, L = {WGMMA_LENGTHS}; "
        f"attention_kernel_wgmma_2pass at D = {TWO_PASS_DIMS}, L = {TWO_PASS_LENGTHS}; ragged "
        f"and unmasked; K1's layout and a (B, L, 3d) buffer) checked, none on the ring, in "
        f"{time.perf_counter() - t0:.1f} s")
    for d_head, b, length in NEGATIVE_SHAPES:
        q, k, v = (randn(b, length, 4, d_head) for _ in range(3))
        mask = ragged(b, length)
        stats = attention_agreement(torch, rounded_first(torch, q, k, v, mask), q, k, v, mask)
        say(f"phase 3 negative control, weights rounded to bf16 before they are normalised, "
            f"B={b} H=4 L={length} D={d_head} ragged: {bf16_text(stats)}, {stats['outside']} "
            f"outside: {'fails the check, as it must' if not bf16_ok(stats) else 'PASSES'}")
        if bf16_ok(stats):
            fail("the bf16 attention check passes weights rounded before they are normalised")
        del q, k, v

    for b, length in K3_HD128_TIMED:
        label = f"K3 attention bf16 hd128 L={length}"
        d, mask = 512, ragged(b, length)
        q, k, v = randn(b, length, 3 * d).split(d, dim=-1)
        heads = [t.reshape(b, length, 4, 128) for t in (q, k, v)]
        want = block_attention_kernel(128, length, "bf16")
        out, err = block_called(torch, block_fn, "bf16", q, k, v, mask, torch.bfloat16,
                                f"phase 4 {label} B={b} H=4 D=128", want)
        ms = timed_ms(torch, lambda: call_rows(block_fn, q, k, v, mask, 4, torch.bfloat16))
        plain = timed_ms(torch, lambda: dot_product_attention(*heads, mask))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in heads)
        lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        bnd, by = bound_ms(dot_ops("bf16", 4.0 * b * 4 * length * length * 128),
                           4 * b * length * d * 2 + b * length * 4)
        say(f"phase 4 {label} (B={b} H=4 D=128 ragged, {want}): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, bound {bnd:.4f} ms "
            f"({by}); max_abs_err {err:.3g}")
        results[f"wgmma {label}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                         bound_ms=bnd, bound_by=by, library_ms=lib, kernel=want,
                                         shape=f"B={b} H=4 L={length} D=128 ragged")
        parts.append(dict(name=f"attention_bf16_hd128_L{length}", route="cuda",
                          source="explainable_spatial_vqa_tpu_torch/csrc/attention_wide.cuh",
                          replaces="explainable_spatial_vqa_tpu/ops/pallas_block.py:232",
                          inside="fused_encoder_block_tiled", **results[f"wgmma {label}"]))
        del q, k, v, heads, qt, kt, vt, out
    say(f"phases 3-4 the wgmma kernels at head dims up to 128 took "
        f"{time.perf_counter() - t0:.1f} s")


def sdpa_backend(torch, call) -> str:
    """Which of ``scaled_dot_product_attention``'s backends one call of
    ``call`` ran, named from the kernels a profile of it saw: cudnn, flash,
    efficient (the memory-efficient CUTLASS kernels), or math (its plain
    matmuls and softmax), with the longest kernel's name.  A profile that
    sees no device activity is taken again, up to ``PROFILE_TRIES`` times."""
    for _ in range(PROFILE_TRIES):
        _, prof = device_profile(torch, call)
        if prof is not None:
            break
    else:
        return "not measured (the profile saw no device activity)"
    names = [name for name, _ in prof[1]]
    kind = next((label for key, label in (("cudnn", "cudnn"), ("flash", "flash"),
                                          ("fmha", "efficient"), ("efficient", "efficient"),
                                          ("mem_eff", "efficient"))
                 if any(key in n.lower() for n in names)), "math")
    return f"{kind} ({names[0][:60] if names else 'no kernel'})"


def deep_kernels(torch, F, dev, results: dict, parts: list) -> None:
    """Phases 3-4 for the head dims past 256 (``attention_kernel_deep_f32``,
    and the kernels that took the deep kernels' calls since:
    ``attention_kernel_wide_f32`` float32 rows of whole 16-byte chunks past
    16 keys, the wgmma kernels (bf16 past 256 keys
    ``attention_kernel_wgmma_2pass_deep``) and the short ones; K2's and K3's
    attention at 384 and 512), each call's kernel as ``k1_kernel`` names
    it: K1 at ``DEEP_DIMS`` x
    ``DEEP_LENGTHS`` and at
    MAX_LEN keys, K2's and K3's attention at ``DEEP_BLOCK_LENGTHS`` through
    ``esv_block_attention`` (float32 q/k/v to bf16 and to float32, bf16 to
    bf16), K1 on a (B, L, 3d) buffer's strides, ragged and unmasked, each
    call's kernel read from the C libraries' counts; the negative control
    (``rounded_first``) must fail the bf16 check; then ``DEEP_TIMED``
    checked and timed beside the plain version, ``scaled_dot_product_attention``
    (its backend named) and the bound.  Results go to ``results["deep
    <label>"]`` and, for K2's and K3's, to ``parts``."""
    from explainable_spatial_vqa_tpu_torch.ops import _build
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
        MAX_LEN,
        bind_entry,
        kernel_launches,
    )

    gen = torch.Generator(device=dev).manual_seed(20)
    t0 = time.perf_counter()
    types = {"bf16": torch.bfloat16, "fp32": torch.float32}
    block_fn = bind_entry(_build.load("fused_block"), "esv_block_attention")
    k1_fn = bind_entry(_build.load("fused_attention"))

    def ragged(b, length):
        keep = torch.ones(b, length, dtype=torch.bool, device=dev)
        tail = min(length, 13)
        keep[:, length - tail:] = torch.rand(b, tail, generator=gen, device=dev) < 0.6
        return keep[:, None, None, :]

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    checks = 0
    shapes = [(d, length) for d in DEEP_DIMS for length in DEEP_LENGTHS]
    shapes += [(d, MAX_LEN) for d in DEEP_LONG]
    for d_head, length in shapes:
        b = 8 if length <= 256 else 2 if length <= 1024 else 1
        for masked in (True, False) if length == 208 else (True,):
            mask = ragged(b, length) if masked else None
            where = f"B={b} H=4 L={length} D={d_head} mask={'ragged' if masked else 'none'}"
            for name, dtype in types.items():
                q, k, v = (randn(b, length, 4, d_head, dtype=dtype) for _ in range(3))
                k1_checked(torch, name, q, k, v, mask, k1_kernel(d_head, length, name),
                           f"phase 3 K1 fused_attention {name} {where}")
                checks += 1
                del q, k, v
    say(f"phase 3 K1 on the deep kernels at D = {DEEP_DIMS}, L = {DEEP_LENGTHS} and at D = "
        f"{DEEP_LONG}, L = {MAX_LEN}: {checks} calls checked in {time.perf_counter() - t0:.1f} s")
    t_block, checks = time.perf_counter(), 0
    for d_head in (384, 512):
        d = 4 * d_head
        for length in DEEP_BLOCK_LENGTHS:
            b = 8 if length <= 256 else 2
            for masked in (True, False):
                mask = ragged(b, length) if masked else None
                where = f"B={b} H=4 L={length} D={d_head} mask={'ragged' if masked else 'none'}"
                for name, outs in (("fp32", (torch.bfloat16, torch.float32)),
                                   ("bf16", (torch.bfloat16,))):
                    qkv = randn(b, length, 3 * d, dtype=types[name])
                    for out_dtype in outs:
                        block_called(torch, block_fn, name, *qkv.split(d, dim=-1), mask,
                                     out_dtype,
                                     f"phase 3 {'K2' if name == 'fp32' else 'K3'} attention "
                                     f"{name} q/k/v from the (B, L, 3d) buffer, "
                                     f"{'fp32' if out_dtype == torch.float32 else 'bf16'} out, "
                                     f"{where}", block_attention_kernel(d_head, length, name))
                        checks += 1
                    del qkv
    for d_head in DEEP_STRIDED:
        d, b, length = 4 * d_head, 8, 208
        mask = ragged(b, length)
        for name, dtype in types.items():
            q, k, v = randn(b, length, 3 * d, dtype=dtype).split(d, dim=-1)
            block_called(torch, k1_fn, name, q, k, v, mask, dtype,
                         f"phase 3 K1 esv_attention {name} on a (B, L, 3d) buffer's strides, "
                         f"B={b} H=4 L={length} D={d_head} mask=ragged",
                         k1_kernel(d_head, length, name), counts=kernel_launches)
            checks += 1
            del q, k, v
    say(f"phase 3 K2's and K3's attention on the deep kernels at D = 384 and 512, L = "
        f"{DEEP_BLOCK_LENGTHS}, and K1 on a (B, L, 3d) buffer's strides at D = {DEEP_STRIDED}: "
        f"{checks} calls checked in {time.perf_counter() - t_block:.1f} s")
    for d_head, b, length in DEEP_NEGATIVE:
        q, k, v = (randn(b, length, 4, d_head, dtype=torch.bfloat16) for _ in range(3))
        mask = ragged(b, length)
        stats = attention_agreement(torch, rounded_first(torch, q, k, v, mask), q, k, v, mask)
        say(f"phase 3 negative control, weights rounded to bf16 before they are normalised, "
            f"B={b} H=4 L={length} D={d_head} ragged: {bf16_text(stats)}, {stats['outside']} "
            f"outside: {'fails the check, as it must' if not bf16_ok(stats) else 'PASSES'}")
        if bf16_ok(stats):
            fail("the bf16 attention check passes weights rounded before they are normalised")
        del q, k, v

    for case in DEEP_TIMED:
        attention_case(torch, F, randn, ragged, block_fn, case,
                       "explainable_spatial_vqa_tpu_torch/csrc/attention_padded.cuh", results,
                       parts, "deep", profile=case[0] in DEEP_PROFILED)
    say(f"phases 3-4 the deep kernels took {time.perf_counter() - t0:.1f} s")


def one_tf32_pass(torch, q, k, v, mask):
    """The plain attention with TF32 on for its products (one TF32 pass, as
    torch.matmul takes them with ``allow_tf32``): the float32 kernels' negative
    control, which must miss ``k1_f32_tol``."""
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return dot_product_attention(q, k, v, mask)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def f32_wide_kernels(torch, F, dev, results: dict, parts: list) -> None:
    """Phases 3-4 for ``attention_kernel_wide_f32`` (float32 q, k, v past 16
    keys at the padded depths 160-224 and 288-512, rows of whole 16-byte
    chunks): K1 at ``F32_WIDE_DIMS`` x ``F32_WIDE_LENGTHS`` and at
    ``F32_WIDE_LONG``, ragged and unmasked, K2's attention at 384 and 512
    through ``esv_block_attention`` on the (B, L, 3d) buffer's strides
    (float32 q/k/v to float32 and bf16), each call's kernel read from the C
    libraries' counts and held within ``k1_f32_tol`` (bf16 out: the bf16
    check against the plain version rounded); the negative control
    (``one_tf32_pass``) must miss the tolerance; then ``F32_WIDE_TIMED``
    checked and timed beside the plain version, SDPA and the bound, the
    kernel named by a profile (its device time).  Results go to
    ``results["f32wide <label>"]``."""
    from explainable_spatial_vqa_tpu_torch.ops import _build
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import bind_entry

    gen = torch.Generator(device=dev).manual_seed(23)
    t0 = time.perf_counter()
    block_fn = bind_entry(_build.load("fused_block"), "esv_block_attention")

    def ragged(b, length):
        keep = torch.ones(b, length, dtype=torch.bool, device=dev)
        tail = min(length, 13)
        keep[:, length - tail:] = torch.rand(b, tail, generator=gen, device=dev) < 0.6
        return keep[:, None, None, :]

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    checks = 0
    shapes = [(d, length) for d in F32_WIDE_DIMS for length in F32_WIDE_LENGTHS]
    for d_head, length in shapes + list(F32_WIDE_LONG):
        b = 8 if length <= 256 else 2 if length <= 1025 else 1
        for masked in (True, False):
            mask = ragged(b, length) if masked else None
            where = f"B={b} H=4 L={length} D={d_head} mask={'ragged' if masked else 'none'}"
            q, k, v = (randn(b, length, 4, d_head) for _ in range(3))
            want = k1_kernel(d_head, length, "fp32")
            if want != WIDE_F32:
                fail(f"phase 3: K1 float32 at D={d_head}, L={length} is not routed to {WIDE_F32}")
            k1_checked(torch, "fp32", q, k, v, mask, want,
                       f"phase 3 K1 fused_attention fp32 {where}")
            checks += 1
            del q, k, v
    for d_head in (384, 512):
        d = 4 * d_head
        for length in F32_WIDE_BLOCK_LENGTHS:
            b = 8
            mask = ragged(b, length)
            where = f"B={b} H=4 L={length} D={d_head} mask=ragged"
            q, k, v = randn(b, length, 3 * d).split(d, dim=-1)
            for out_dtype in (torch.float32, torch.bfloat16):
                block_called(torch, block_fn, "fp32", q, k, v, mask, out_dtype,
                             f"phase 3 K2 attention fp32 q/k/v from the (B, L, 3d) buffer, "
                             f"{'fp32' if out_dtype == torch.float32 else 'bf16'} out, {where}",
                             block_attention_kernel(d_head, length, "fp32"))
                checks += 1
            if length == 210:  # the negative control on the same inputs
                heads = [t.reshape(b, length, 4, d_head) for t in (q, k, v)]
                err = float((one_tf32_pass(torch, *heads, mask)
                             - dot_product_attention(*heads, mask)).abs().max())
                say(f"phase 3 negative control, K2's attention at D={d_head} in one TF32 pass, "
                    f"{where}: max_abs_err {err:.3g} against the plain version (tol "
                    f"{k1_f32_tol_text(length)}): "
                    f"{'misses it, as it must' if err > k1_f32_tol(length) else 'PASSES'}")
                if err <= k1_f32_tol(length):
                    fail("the float32 attention tolerance passes one TF32 pass")
            del q, k, v
    say(f"phase 3 attention_kernel_wide_f32: K1 at D = {F32_WIDE_DIMS}, L = {F32_WIDE_LENGTHS} "
        f"and at {F32_WIDE_LONG}, K2's attention at D = 384 and 512, L = "
        f"{F32_WIDE_BLOCK_LENGTHS}: {checks} calls checked in {time.perf_counter() - t0:.1f} s")
    for case in F32_WIDE_TIMED:
        attention_case(torch, F, randn, ragged, block_fn, case,
                       "explainable_spatial_vqa_tpu_torch/csrc/attention_f32_wide.cuh", results,
                       parts, "f32wide", profile=True)
    say(f"phases 3-4 attention_kernel_wide_f32 took {time.perf_counter() - t0:.1f} s")


def wgmma_padded_kernels(torch, F, dev, results: dict, parts: list) -> None:
    """Phases 3-4 for the wgmma kernels at the padded depths past 128 (one
    pass up to 256 keys: ``attention_kernel_wgmma`` at 160-256,
    ``attention_kernel_wgmma_deep`` at 288-512; two past them:
    ``attention_kernel_wgmma_2pass_deep`` at 160-512): K1 at
    ``WGMMA_PADDED_DIMS`` x ``WGMMA_PADDED_LENGTHS``, those and 256 at
    ``TWO_PASS_LENGTHS`` (257, 1025, 4096: MAX_LEN) and, in rows that are not whole
    16-byte chunks, at ``WGMMA_NARROW_DIMS`` x ``WGMMA_NARROW_LENGTHS``,
    ragged and unmasked, on a (B, L, 3d) buffer's strides at
    ``WGMMA_STRIDED`` x ``WGMMA_STRIDED_LENGTHS``, and K3's attention at
    head dim 256 at ``WGMMA_2PASS_BLOCK_LENGTHS`` (``esv_block_attention``),
    each call's kernel read from the C libraries' counts (no call on
    ``attention_kernel_padded``); the negative control (``rounded_first``) at
    ``WGMMA_NEGATIVE`` must fail the bf16 check; then ``WGMMA_PADDED_TIMED``
    checked and timed beside the plain version,
    ``scaled_dot_product_attention`` (its backend named) and the bound.
    Results go to ``results["wgmma padded <label>"]`` and, for K3's
    attention, to ``parts``."""
    from explainable_spatial_vqa_tpu_torch.ops import _build, fused_block
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
        bind_entry,
        kernel_launches,
        padded_depth,
    )

    gen = torch.Generator(device=dev).manual_seed(21)
    t0 = time.perf_counter()
    block_fn = bind_entry(_build.load("fused_block"), "esv_block_attention")
    k1_fn = bind_entry(_build.load("fused_attention"))

    def ragged(b, length):
        keep = torch.ones(b, length, dtype=torch.bool, device=dev)
        keep[:, length - 13:] = torch.rand(b, 13, generator=gen, device=dev) < 0.6
        return keep[:, None, None, :]

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    checks, by_kernel, narrow = 0, {}, {}
    padded_before = (kernel_launches().get(PADDED, 0), fused_block.kernel_launches().get(PADDED, 0))
    shapes = [(d, length) for d in WGMMA_PADDED_DIMS for length in WGMMA_PADDED_LENGTHS]
    shapes += [(d, length) for d in WGMMA_PADDED_DIMS + (256,)
               for length in TWO_PASS_LENGTHS if (d, length) not in shapes]
    shapes += [(d, length) for d in WGMMA_NARROW_DIMS for length in WGMMA_NARROW_LENGTHS]
    for d_head, length in shapes:
        b = wide_batch(length)
        want = k1_bf16_kernel(d_head, length)
        if want != ((WGMMA, WGMMA_DEEP)[padded_depth(d_head) > 256] if length <= 256
                    else WGMMA_2PASS_DEEP):
            fail(f"the routing mirror names {want} for bf16 at D={d_head}, L={length}")
        for masked in (True, False):
            mask = ragged(b, length) if masked else None
            where = f"B={b} H=4 L={length} D={d_head} mask={'ragged' if masked else 'none'}"
            q, k, v = (randn(b, length, 4, d_head) for _ in range(3))
            k1_checked(torch, "bf16", q, k, v, mask, want,
                       f"phase 3 K1 fused_attention bf16 (padded depth "
                       f"{padded_depth(d_head)}, rows of {2 * d_head} bytes) {where}")
            by_kernel.setdefault(want, set()).add(padded_depth(d_head))
            if d_head % 8:
                narrow.setdefault(want, set()).add(padded_depth(d_head))
            checks += 1
            del q, k, v
    for d_head in WGMMA_STRIDED:
        for length in WGMMA_STRIDED_LENGTHS:
            d, b = 4 * d_head, wide_batch(length)
            q, k, v = randn(b, length, 3 * d).split(d, dim=-1)
            block_called(torch, k1_fn, "bf16", q, k, v, ragged(b, length), torch.bfloat16,
                         f"phase 3 K1 esv_attention bf16 on a (B, L, 3d) buffer's strides, B={b} "
                         f"H=4 L={length} D={d_head} mask=ragged", k1_bf16_kernel(d_head, length),
                         counts=kernel_launches)
            checks += 1
            del q, k, v
    for length in WGMMA_2PASS_BLOCK_LENGTHS:  # K3's attention at head dim 256 past 256 keys
        d, b = 4 * 256, wide_batch(length)
        for masked in (True, False):
            q, k, v = randn(b, length, 3 * d).split(d, dim=-1)
            block_called(torch, block_fn, "bf16", q, k, v, ragged(b, length) if masked else None,
                         torch.bfloat16,
                         f"phase 3 K3 attention bf16 q/k/v from the (B, L, 3d) buffer, B={b} H=4 "
                         f"L={length} D=256 mask={'ragged' if masked else 'none'}",
                         block_attention_kernel(256, length, "bf16"))
            checks += 1
            del q, k, v
    padded_calls = [c.get(PADDED, 0) - was for c, was in zip(
        (kernel_launches(), fused_block.kernel_launches()), padded_before)]
    depths = {kernel: sorted(found) for kernel, found in sorted(by_kernel.items())}
    narrow = {kernel: sorted(found) for kernel, found in sorted(narrow.items())}
    say(f"phase 3 the wgmma kernels at the padded depths past 128: {checks} calls (K1 at D = "
        f"{WGMMA_PADDED_DIMS}, L = {WGMMA_PADDED_LENGTHS}, those and 256 at L = "
        f"{TWO_PASS_LENGTHS}, and in rows that are not whole 16-byte chunks at "
        f"D = {WGMMA_NARROW_DIMS}, L = {WGMMA_NARROW_LENGTHS}, ragged and unmasked; on a (B, L, "
        f"3d) buffer at D = {WGMMA_STRIDED}, L = {WGMMA_STRIDED_LENGTHS}; K3's attention at head "
        f"dim 256, L = {WGMMA_2PASS_BLOCK_LENGTHS}) checked, the padded depths by kernel "
        f"{depths}, those of the rows not whole 16-byte chunks {narrow}; "
        f"{PADDED} launches by the two C libraries {padded_calls}, in "
        f"{time.perf_counter() - t0:.1f} s")
    if not (set(depths.get(WGMMA, ())) >= {160, 192, 224}
            and depths.get(WGMMA_DEEP) == list(WGMMA_DEEP_DEPTHS)
            and depths.get(WGMMA_2PASS_DEEP) == list(WGMMA_2PASS_DEEP_DEPTHS)
            and narrow == {WGMMA: [160, 192, 224, 256], WGMMA_DEEP: list(WGMMA_DEEP_DEPTHS),
                           WGMMA_2PASS_DEEP: list(WGMMA_2PASS_DEEP_DEPTHS)}):
        fail("phase 3: the wgmma kernels were not held at every padded depth past 128, in rows "
             "of whole 16-byte chunks and in others")
    if padded_calls != [0, 0]:
        fail(f"phase 3: bf16 calls past depth 128 launched {PADDED}")
    for d_head, b, length in WGMMA_NEGATIVE:
        q, k, v = (randn(b, length, 4, d_head) for _ in range(3))
        mask = ragged(b, length)
        stats = attention_agreement(torch, rounded_first(torch, q, k, v, mask), q, k, v, mask)
        say(f"phase 3 negative control, weights rounded to bf16 before they are normalised, "
            f"B={b} H=4 L={length} D={d_head} ragged: {bf16_text(stats)}, {stats['outside']} "
            f"outside: {'fails the check, as it must' if not bf16_ok(stats) else 'PASSES'}")
        if bf16_ok(stats):
            fail("the bf16 attention check passes weights rounded before they are normalised")
        del q, k, v

    def randn_typed(*shape, dtype):
        return randn(*shape, dtype=dtype)

    for case in WGMMA_PADDED_TIMED:
        attention_case(torch, F, randn_typed, ragged, block_fn, case,
                       "explainable_spatial_vqa_tpu_torch/csrc/attention_wide.cuh", results,
                       parts, "wgmma padded")
    say(f"phases 3-4 the wgmma kernels at the padded depths past 128 took "
        f"{time.perf_counter() - t0:.1f} s")


def short_kernels(torch, F, dev, results: dict, parts: list) -> None:
    """Phases 3-4 for the short kernels (``attention_kernel_short_f32``,
    ``attention_kernel_short``: rows of at most 16 keys past padded depth
    128): K1 at ``SHORT_DIMS`` x ``SHORT_LENGTHS``, ragged and unmasked, in
    both types, and K2's and K3's attention at head dim 256 on 8 and 10 keys
    through ``esv_block_attention`` (float32 q/k/v to bf16 and to float32,
    bf16 to bf16), each call's kernel read from the C libraries' counts;
    fails unless both kernels were held at every padded depth past 128; then
    ``SHORT_TIMED`` checked and timed beside the plain version,
    ``scaled_dot_product_attention`` and the bound, with the device time by
    profile.  Results go to ``results["short <label>"]``."""
    from explainable_spatial_vqa_tpu_torch.ops import _build
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import bind_entry, padded_depth

    gen = torch.Generator(device=dev).manual_seed(22)
    t0 = time.perf_counter()
    types = {"bf16": torch.bfloat16, "fp32": torch.float32}
    block_fn = bind_entry(_build.load("fused_block"), "esv_block_attention")

    def ragged(b, length):
        keep = torch.ones(b, length, dtype=torch.bool, device=dev)
        tail = min(length, 13)
        keep[:, length - tail:] = torch.rand(b, tail, generator=gen, device=dev) < 0.6
        return keep[:, None, None, :]

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    checks, held = 0, {}
    for d_head in SHORT_DIMS:
        for length in SHORT_LENGTHS:
            for masked in (True, False):
                mask = ragged(K1_NEW_DIM_BATCH, length) if masked else None
                where = (f"B={K1_NEW_DIM_BATCH} H=4 L={length} D={d_head} "
                         f"mask={'ragged' if masked else 'none'}")
                for name, dtype in types.items():
                    want = k1_kernel(d_head, length, name)
                    if want not in (SHORT, SHORT_F32):
                        fail(f"the routing mirror names {want} for {name} at D={d_head}, "
                             f"L={length}")
                    q, k, v = (randn(K1_NEW_DIM_BATCH, length, 4, d_head, dtype=dtype)
                               for _ in range(3))
                    k1_checked(torch, name, q, k, v, mask, want,
                               f"phase 3 K1 fused_attention {name} (padded depth "
                               f"{padded_depth(d_head)}) {where}")
                    held.setdefault(want, set()).add(padded_depth(d_head))
                    checks += 1
                    del q, k, v
    for length in (8, 10):
        b, d = 8, 4 * 256
        for masked in (True, False):
            mask = ragged(b, length) if masked else None
            where = f"B={b} H=4 L={length} D=256 mask={'ragged' if masked else 'none'}"
            for name, outs in (("fp32", (torch.bfloat16, torch.float32)),
                               ("bf16", (torch.bfloat16,))):
                qkv = randn(b, length, 3 * d, dtype=types[name])
                for out_dtype in outs:
                    block_called(torch, block_fn, name, *qkv.split(d, dim=-1), mask, out_dtype,
                                 f"phase 3 {'K2' if name == 'fp32' else 'K3'} attention {name} "
                                 f"q/k/v from the (B, L, 3d) buffer, "
                                 f"{'fp32' if out_dtype == torch.float32 else 'bf16'} out, {where}",
                                 block_attention_kernel(256, length, name))
                    checks += 1
                del qkv
    held = {kernel: sorted(found) for kernel, found in sorted(held.items())}
    say(f"phase 3 the short kernels: {checks} calls (K1 at D = {SHORT_DIMS}, L = {SHORT_LENGTHS}, "
        f"ragged and unmasked, both types; K2's and K3's attention at head dim 256, L = 8 and 10) "
        f"checked, the padded depths by kernel {held}, in {time.perf_counter() - t0:.1f} s")
    depths = sorted(WGMMA_DEPTHS[4:] + WGMMA_DEEP_DEPTHS)  # 160-512
    if held != {SHORT: depths, SHORT_F32: depths}:
        fail("phase 3: the short kernels were not held at every padded depth past 128")
    for case in SHORT_TIMED:
        attention_case(torch, F, randn, ragged, block_fn, case,
                       "explainable_spatial_vqa_tpu_torch/csrc/attention_padded.cuh", results,
                       parts, "short", profile=True)
    say(f"phases 3-4 the short kernels took {time.perf_counter() - t0:.1f} s")


def k1_wrapper_times(torch, F, dev, results: dict) -> None:
    """Phase 4 for K1 at the box decoders' shapes (``K1_WRAPPER_SHAPES``),
    where the host's work around the launch costs more than the kernel: the
    call through the wrapper (CUDA events around 50 calls), the kernel's
    device time (torch.profiler) and ``scaled_dot_product_attention``'s
    (events).  Results go to ``results["K1_wrapper_D{d}_L{L}"]``."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention

    gen = torch.Generator(device=dev).manual_seed(15)
    types = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for d_head, b, length, name in K1_WRAPPER_SHAPES:
        q, k, v = (torch.randn(b, length, 4, d_head, generator=gen, device=dev).to(types[name])
                   for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        wrapper = timed_ms(torch, lambda: fused_attention(q, k, v), iters=50)
        _, device = k1_launched(torch, lambda: fused_attention(q, k, v), calls=50)
        lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=50)
        say(f"phase 4 K1 fused_attention {name} D={d_head} B={b} H=4 L={length}, no mask: "
            f"through the wrapper {wrapper:.4f} ms, the kernel's device time {device:.4f} ms, "
            f"scaled_dot_product_attention {lib:.4f} ms")
        results[f"K1_wrapper_D{d_head}_L{length}"] = dict(wrapper_ms=wrapper, device_ms=device,
                                                          library_ms=lib)


def score_forms(torch, dev, l10, first, results: dict, parts) -> None:
    """Phases 3-4 for the two forms of the bf16 attention's scores: sums on
    the tensor cores (K1 and K3, the shipped form) and float32 FMA chains on
    the CUDA cores (``esv_attention_fma_scores``, which no wrapper
    launches).  Both are held by ``attention_agreement`` on three draws at
    L=210 (K1's inputs and two more) and at L=10 (the box decoder's shape):
    the shipped form fails the phase if it misses any; the other's verdict
    is printed beside it.  Both are timed at L=10 and L=210 through the same
    ctypes call (the wrapper's checks cost the host more than an L=10
    kernel takes), in alternating rounds: CUDA events around 50 calls, and
    the kernel's own device time from torch.profiler."""
    from explainable_spatial_vqa_tpu_torch.ops import fused_attention as fa
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention

    def direct(entry):
        fn = fa._esv_attention(entry)
        return lambda q, k, v, mask: fa.call_entry(fn, q, k, v, mask)

    tensor_call, chains_call = direct("esv_attention"), direct("esv_attention_fma_scores")
    b, length, h, d_head = first[0].shape
    inputs = [first]
    for draw in (1, 2):
        gen = torch.Generator(device=dev).manual_seed(10 + draw)
        q, k, v = (torch.randn(b, length, h, d_head, generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        keep = torch.ones(b, length, dtype=torch.bool, device=dev)
        keep[:, length - 13:] = torch.rand(b, 13, generator=gen, device=dev) < 0.6
        inputs.append((q, k, v, keep[:, None, None, :]))
    inputs.append((*l10, None))
    chains_passes = 0
    for draw, (q, k, v, mask) in enumerate(inputs):
        shape = f"L={q.shape[1]}{'' if mask is None else ' ragged mask'}"
        tensor = attention_agreement(torch, fa.fused_attention(q, k, v, mask), q, k, v, mask)
        chains = attention_agreement(torch, chains_call(q, k, v, mask), q, k, v, mask)
        chains_passes += bf16_ok(chains)
        say(f"phase 3 bf16 attention {shape} draw {draw}, {q.numel()} outputs: tensor-core "
            f"scores (K1, shipped) {bf16_text(tensor)}, {tensor['outside']} outside: "
            f"{'passes' if bf16_ok(tensor) else 'FAILS'}; FMA-chain scores "
            f"(esv_attention_fma_scores) {bf16_text(chains)}, {chains['outside']} outside: "
            f"{'passes' if bf16_ok(chains) else 'fails'}")
        if not bf16_ok(tensor):
            fail(f"K1's shipped score form misses the bf16 attention check on draw {draw}")
    q, k, v, mask = first
    err = float((chains_call(q, k, v, mask).float()
                 - dot_product_attention(q, k, v, mask).float()).abs().max())
    ms = timed_ms(torch, lambda: chains_call(q, k, v, mask))
    parts.append(dict(name="attention_bf16_fma_scores_L210", route="cuda",
                      source="explainable_spatial_vqa_tpu_torch/csrc/attention.cuh",
                      replaces="explainable_spatial_vqa_tpu/ops/pallas_attention.py:45",
                      inside=None, max_abs_err=err, ms=ms,
                      **{key: results["K1_L210"][key] for key in (
                          "plain_ms", "bound_ms", "bound_by", "library_ms")}))

    def kernel_ms(call, q, k, v, mask, calls=50):
        """The attention kernel's device time per call, by torch.profiler."""
        _, prof = device_profile(torch, lambda: [call(q, k, v, mask) for _ in range(calls)])
        if prof is None:
            return math.nan
        return sum(t for name, t in prof[1] if "attention_kernel" in name) / calls

    timings = []
    for q, k, v, mask in (inputs[-1], first):
        found = {measure: ([], []) for measure in ("events", "device")}
        for r in range(SCORE_ROUNDS):  # alternating: F T, T F, F T, ...
            for i in ((0, 1) if r % 2 == 0 else (1, 0)):
                call = (chains_call, tensor_call)[i]
                found["events"][i].append(timed_ms(torch, lambda: call(q, k, v, mask), iters=50,
                                                   warmup=2))
                found["device"][i].append(kernel_ms(call, q, k, v, mask))
        mid = SCORE_ROUNDS // 2
        for measure, (chains_ms, tensor_ms) in found.items():
            wins = sum(t < c for t, c in zip(tensor_ms, chains_ms))
            timings.append(f"L={q.shape[1]} {measure}: FMA chains {sorted(chains_ms)[mid]:.4f} ms, "
                           f"tensor cores {sorted(tensor_ms)[mid]:.4f} ms, the tensor cores "
                           f"faster in {wins} of {SCORE_ROUNDS} rounds")
    say(f"phase 4 bf16 attention score forms, through the same call, medians of {SCORE_ROUNDS} "
        f"alternating rounds of 50 calls (events: CUDA events around the calls; device: the "
        f"kernel's device time per call, torch.profiler): {'; '.join(timings)}; the "
        f"FMA-chain form passes {chains_passes} of {len(inputs)} draws")


def k2_attention(torch, F, dev, randn, ragged_keep, parts) -> None:
    """Phases 3-4 for K2's own attention: float32 q, k, v read out of the
    (B, L, 3d) projection buffer at the main path's shape, in 3xTF32.  Checked
    with a float32 output at the float32 tolerance and with the bf16 output K2
    writes for its out projection by ``bf16_agreement``; timed in that form."""
    from explainable_spatial_vqa_tpu_torch.ops import fused_attention as fa
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention

    b, length, h, d_head = SLOTS, 210, 4, 128
    d = h * d_head
    qkv = randn(b, length, 3 * d)
    keep = ragged_keep(b, length, 13)
    mask = keep[:, None, None, :]
    mask_f = keep.float().contiguous()
    q, k, v = (t.reshape(b, length, h, d_head) for t in qkv.split(d, dim=-1))
    fn = fa._esv_attention()

    def kernel(out):
        status = fn(qkv.data_ptr(), qkv.data_ptr() + 4 * d, qkv.data_ptr() + 8 * d,
                    mask_f.data_ptr(), out.data_ptr(), b, h, length, d_head, length * 3 * d, 3 * d,
                    length * d, d, fa.DTYPE_CODES[torch.float32], fa.DTYPE_CODES[out.dtype],
                    torch.cuda.current_stream().cuda_stream)
        if status:
            fail(f"K2's attention failed with CUDA error {status}")
        return out

    out32 = kernel(torch.empty(b, length, d, device=dev))
    out16 = kernel(torch.empty(b, length, d, dtype=torch.bfloat16, device=dev))
    ref = dot_product_attention(q, k, v, mask).reshape(b, length, d)
    torch.cuda.synchronize()
    err = float((out32 - ref).abs().max())
    stats = bf16_agreement(torch, out16, ref.bfloat16())
    say(f"phase 3 K2 attention fp32 q/k/v (3xTF32) B={b} H={h} L={length} D={d_head} "
        f"mask=ragged, read from the (B, L, 3d) buffer: float32 out max_abs_err {err:.3g} "
        f"(tol 1e-5); bf16 out (K2's) {bf16_text(stats)}")
    if not (err <= 1e-5 and bf16_ok(stats)):
        fail("K2's attention disagrees with its plain version")
    qt, kt, vt = (t.transpose(1, 2) for t in (q.contiguous(), k.contiguous(), v.contiguous()))
    ms = timed_ms(torch, lambda: kernel(out16))
    plain = timed_ms(torch, lambda: dot_product_attention(q, k, v, mask).bfloat16())
    lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    elems = b * length * d
    bnd, by = bound_ms(dot_ops("fp32", 4.0 * b * h * length * length * d_head),
                       3 * elems * 4 + elems * 2 + b * length * 4)
    say(f"phase 4 K2 attention fp32 q/k/v, bf16 out, L={length}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, scaled_dot_product_attention fp32 {lib:.4f} ms, bound {bnd:.4f} ms "
        f"({by}: 3 x {4.0 * b * h * length * length * d_head / 1e9:.1f} GFLOP at the TF32 rate)")
    parts.append(dict(name="attention_fp32_L210", route="cuda",
                      source="explainable_spatial_vqa_tpu_torch/csrc/attention.cuh",
                      replaces="explainable_spatial_vqa_tpu/ops/pallas_block.py:135",
                      inside="fused_encoder_block", max_abs_err=err, ms=ms, plain_ms=plain,
                      bound_ms=bnd, bound_by=by, library_ms=lib))


def k2_gemms(torch, dev, randn, parts) -> None:
    """Phases 3-4 for the block GEMM alone (``block_gemm``, the blocks' own
    kernel) at K2's four product shapes, bf16 operands: checked against the
    plain version (float32 sums, TF32 off; float32 outputs within
    ``GEMM_REL_TOL`` of the largest |ref|, sums of up to 2048 products taken
    in another order; bf16 outputs by ``bf16_agreement``), then timed beside
    ``torch.matmul`` in bf16 and the bound.  Then the same four with float32
    operands (``k2_gemms_fp32``)."""
    from explainable_spatial_vqa_tpu_torch.ops.block_gemm import block_gemm, block_gemm_plain

    rows = SLOTS * 210
    total = 0.0
    for name, n, k, relu, out_name in K2_GEMMS:
        out_dtype = torch.bfloat16 if out_name == "bf16" else torch.float32
        a = randn(rows, k, dtype=torch.bfloat16)
        w = randn(n, k, scale=k ** -0.5, dtype=torch.bfloat16)
        bias = randn(n, scale=0.02)
        out = block_gemm(a, w, bias, relu, out_dtype)
        ref = block_gemm_plain(a, w, bias, relu, out_dtype)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        if out_dtype == torch.bfloat16:
            stats = bf16_agreement(torch, out, ref)
            text, ok = bf16_text(stats), bf16_ok(stats)
        else:
            rel = err / float(ref.abs().max())
            text, ok = f"max_abs_err {err:.3g}, {rel:.3g} of max|ref| (tol {GEMM_REL_TOL})", (
                rel <= GEMM_REL_TOL)
        shape = f"{rows}x{n}x{k}{' ReLU' if relu else ''} -> {out_name}"
        say(f"phase 3 block_gemm {name} {shape}: {text}")
        if not ok:
            fail(f"block_gemm {name} disagrees with its plain version")
        ms = timed_ms(torch, lambda: block_gemm(a, w, bias, relu, out_dtype))
        plain = timed_ms(torch, lambda: block_gemm_plain(a, w, bias, relu, out_dtype), iters=5)
        lib = timed_ms(torch, lambda: torch.matmul(a, w.t()))
        flops = 2.0 * rows * n * k
        bnd, by = bound_ms({"bf16": flops}, (rows * k + n * k) * 2 + n * 4
                           + rows * n * out.element_size())
        total += ms
        say(f"phase 4 block_gemm {name} {shape}: kernel {ms:.4f} ms = {flops / ms / 1e9:.1f} "
            f"TFLOP/s, plain {plain:.4f} ms, torch.matmul bf16 {lib:.4f} ms, bound {bnd:.4f} ms "
            f"({by})")
        parts.append(dict(name=f"block_gemm_{name}", route="cuda",
                          source="explainable_spatial_vqa_tpu_torch/csrc/fused_block.cu",
                          replaces="explainable_spatial_vqa_tpu/ops/pallas_block.py:126",
                          inside="fused_encoder_block", max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bnd, bound_by=by, library_ms=lib))
        del a, w, out, ref
    say(f"phase 4 block_gemm: K2's four products {total:.4f} ms together")
    k2_gemms_fp32(torch, randn, parts)


def k2_gemms_fp32(torch, randn, parts) -> None:
    """Phases 3-4 for the block GEMM at K2's four product shapes with float32
    a and w, as K2 runs them with float32 weights (3xTF32, every output
    float32, the weights split once as the model keeps them): each within
    ``GEMM_REL_TOL`` of the largest |ref| of the plain version (float32 sums,
    TF32 off), timed beside ``torch.matmul`` in float32 with TF32 off and
    the bound (``dot_ops``: three TF32 products a term).  Negative control:
    the same product in one TF32 pass (``torch.matmul`` with
    ``allow_tf32``, restored after) must miss ``GEMM_REL_TOL``, or the
    tolerance could not tell 3xTF32 from TF32."""
    from explainable_spatial_vqa_tpu_torch.ops.block_gemm import block_gemm, block_gemm_plain
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import split_tf32

    rows = SLOTS * 210
    total = 0.0
    for name, n, k, relu, _ in K2_GEMMS:
        a = randn(rows, k)
        w = randn(n, k, scale=k ** -0.5)
        bias = randn(n, scale=0.02)
        split = split_tf32(w)
        out = block_gemm(a, w, bias, relu, split=split)
        ref = block_gemm_plain(a, w, bias, relu)
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            one_pass = torch.matmul(a, w.t()) + bias
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
        one_pass = torch.relu(one_pass) if relu else one_pass
        torch.cuda.synchronize()
        top = float(ref.abs().max())
        err = float((out - ref).abs().max())
        rel, control = err / top, float((one_pass - ref).abs().max()) / top
        shape = f"{rows}x{n}x{k}{' ReLU' if relu else ''} -> fp32"
        say(f"phase 3 block_gemm {name} fp32 (3xTF32) {shape}: max_abs_err {err:.3g}, {rel:.3g} "
            f"of max|ref| (tol {GEMM_REL_TOL}); negative control, one TF32 pass "
            f"(torch.matmul, allow_tf32): {control:.3g} of max|ref|: "
            f"{'passes' if control <= GEMM_REL_TOL else 'fails'}")
        if not rel <= GEMM_REL_TOL:
            fail(f"block_gemm {name} in float32 disagrees with its plain version")
        if control <= GEMM_REL_TOL:
            fail("the float32 GEMM tolerance cannot tell 3xTF32 from one TF32 pass")
        del one_pass
        ms = timed_ms(torch, lambda: block_gemm(a, w, bias, relu, split=split))
        plain = timed_ms(torch, lambda: block_gemm_plain(a, w, bias, relu), iters=5)
        lib = timed_ms(torch, lambda: torch.matmul(a, w.t()))
        flops = 2.0 * rows * n * k
        bnd, by = bound_ms(dot_ops("fp32", flops), (rows * k + n * k + n + rows * n) * 4)
        total += ms
        say(f"phase 4 block_gemm {name} fp32 (3xTF32) {shape}: kernel {ms:.4f} ms = "
            f"{flops / ms / 1e9:.1f} TFLOP/s useful, {3 * flops / ms / 1e9:.1f} at the TF32 "
            f"rate (of 495), plain {plain:.4f} ms, torch.matmul fp32 (TF32 off) {lib:.4f} ms, "
            f"bound {bnd:.4f} ms ({by})")
        parts.append(dict(name=f"block_gemm_{name}_fp32", route="cuda",
                          source="explainable_spatial_vqa_tpu_torch/csrc/fused_block.cu",
                          replaces="explainable_spatial_vqa_tpu/ops/pallas_block.py:126",
                          inside="fused_encoder_block", max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bnd, bound_by=by, library_ms=lib))
        del a, w, split, out, ref
    say(f"phase 4 block_gemm fp32: K2's four products {total:.4f} ms together")


def main_path(torch, np, dev, results, parts) -> None:
    """Phases 5 to 10, then the result lines."""
    from explainable_spatial_vqa_tpu_torch import bench_block
    from explainable_spatial_vqa_tpu_torch.bench_data import FUNCTION_IDS, synth_questions
    from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, GeneratorConfig
    from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
    from explainable_spatial_vqa_tpu_torch.infer.pipeline import (
        InferencePipeline,
        decode_program_ids,
        programs_to_chains,
    )
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.models import layers
    from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
        EXACT_HEAD_DIMS,
        fused_attention,
        kernel_launches,
    )
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import fused_encoder_block

    def k2_observed(x, mask, weights, num_heads, **options):
        """The model's K2 call, its float32 launches noted ("K2 fp32")."""
        before = fused_encoder_block.launches
        out = fused_encoder_block(x, mask, weights, num_heads, **options)
        if weights.qkv.dtype == torch.float32:
            note("K2 fp32", fused_encoder_block.launches - before)
        return out

    def k1_observed(q, k, v, mask=None):
        """The model's K1 call, its launches noted by head dim ("K1 D=...")
        and by the kernel function the C library counted ("K1
        attention_kernel...")."""
        before, by_kernel = fused_attention.launches, kernel_launches()
        out = fused_attention(q, k, v, mask)
        note(f"K1 D={q.shape[-1]}", fused_attention.launches - before)
        for kernel, count in kernel_launches().items():
            if count != by_kernel[kernel]:
                note(f"K1 {kernel}", count - by_kernel[kernel])
        return out

    layers.fused_encoder_block = k2_observed
    layers.fused_attention = k1_observed

    counted = launch_counter(torch)

    # ---- 5. the block-bench path: K3 through its entry point ----
    # K2's attention at head dim 128 on float32 q/k/v (attention_kernel_f32),
    # K3's on bf16: attention_kernel_wgmma at L = 224, attention_kernel_
    # wgmma_2pass past 256 keys (the C library's counts; none on the ring)
    block_bench = {}
    for length, argv in ((224, ["--batches", "128", "--iters", "5"]),
                         (304, ["--batches", "128", "--iters", "2", "--tiles", "2", "--length",
                                "304"])):
        read = c_counts(torch)
        rows, launches = counted(lambda: bench_block.main(argv))
        _, block_c = read()
        say(f"phase 5 block bench, bench_block.main {' '.join(argv)} (bf16, L={length}, no "
            f"mask): " + "; ".join(f"{name} {ms:.3f} ms {tflops:.1f} TFLOP/s"
                                   for _b, name, ms, tflops in rows)
            + f"; launches {launches}; the blocks' attention by the C library's counts {block_c}")
        want = block_attention_kernel(128, length, "bf16")
        if not (launches["fused_encoder_block_tiled"] > 0
                and block_c == {"attention_kernel_f32": launches["fused_encoder_block"],
                                want: launches["fused_encoder_block_tiled"]}):
            fail(f"the block bench at L={length} did not launch K3, its attention on {want}")
        block_bench[length] = (rows, launches, block_c)
    bench_rows, bench_launches, _ = block_bench[224]

    # ---- 6. the main path at full width ----
    gen_cfg = GeneratorConfig(vocab_size=96, program_vocab_size=45, program_len=27)
    exe_cfg = ExecutorConfig(vocab_size=64, token_classes=32, box_roi=True)
    dtype = torch.bfloat16
    generator = init_parameters(ProgramGenerator(gen_cfg, dtype, device=dev), seed=1)
    executor = init_parameters(ProgramExecutor(exe_cfg, dtype, device=dev), seed=2)
    thresholds = np.random.RandomState(3).uniform(0.3, 0.7, exe_cfg.vocab_size).astype(np.float32)
    runner = ExecutorChainRunner(executor, exe_cfg, max_steps=27, conf_thresholds=thresholds,
                                 device=dev)
    idx_to_token = dict(enumerate(["<NULL>", "<START>", "<END>"] + sorted(FUNCTION_IDS)))
    token_ids = {t: i for i, t in idx_to_token.items()}
    features, questions, chains = synth_questions(MAIN_QUESTIONS, exe_cfg, max_steps=27, seed=0)
    scripted = postfix_ids(chains, token_ids, FUNCTION_IDS, gen_cfg.program_len)
    pipeline = InferencePipeline(scripted_programs(torch, generator, scripted), runner,
                                 idx_to_token, FUNCTION_IDS, device=dev)
    features_dev = torch.from_numpy(features).to(dev)
    questions_dev = torch.from_numpy(questions).to(dev)
    forwards = [0]

    def count_forwards(module, *_):
        forwards[0] += 1

    def repeats(mode):
        """``REPEATS`` timed runs of the pipeline in ``mode`` after a warm-up
        (the first call also sets up cuBLAS and the allocator's pools): the
        results, the host-clock seconds of each (run returns numpy, so its
        work is done), the executor forwards and the launches."""
        pipeline.run(questions, features_dev, chains.image_index, chain_mode=mode)
        forwards[0] = 0
        seconds = []

        def timed_runs():
            out = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                out.append(pipeline.run(questions, features_dev, chains.image_index,
                                        chain_mode=mode))
                seconds.append(time.perf_counter() - t0)
            return out

        runs, counts = counted(timed_runs)
        return runs, seconds, forwards[0], counts

    def launch_checks(counts, n_forwards, cfg):
        return {
            "K2 launches == 3 x executor forwards": (
                counts["fused_encoder_block"] == cfg.encoder_layers * n_forwards),
            "K1 launches == 2 x executor forwards (box decoder self-attention)": (
                counts["fused_attention"] == cfg.box_decoder_layers * n_forwards > 0),
        }

    def median(seconds):
        return sorted(seconds)[len(seconds) // 2]

    hook = executor.register_forward_hook(count_forwards)
    results_run, run_s, main_forwards, launches = repeats("pool")
    result = results_run[0]

    # the same work in its parts, once, for where the time goes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    program_ids = generator.generate(questions_dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    parsed = programs_to_chains(decode_program_ids(scripted, idx_to_token), chains.image_index,
                                FUNCTION_IDS, runner.max_steps)
    t2 = time.perf_counter()
    out = runner.run_pool(features_dev, parsed)  # the pipeline's default: SLOTS
    t3 = time.perf_counter()

    n = MAIN_QUESTIONS
    useful = int(chains.num_steps.sum())
    iterations = main_forwards // REPEATS
    checks = {
        "the generator's ids (N, 27) in the program vocabulary": (
            tuple(program_ids.shape) == (n, 27) and 0 <= int(program_ids.min())
            and int(program_ids.max()) < gen_cfg.program_vocab_size),
        "every program parses into its chain: same depth and functions, none cut": (
            np.array_equal(parsed.num_steps, chains.num_steps)
            and np.array_equal(np.sort(parsed.functions, 1), np.sort(chains.functions, 1))
            and all(r.truncated == 0 and np.array_equal(r.program_ids, scripted)
                    for r in results_run)),
        "every answer equal across repeats and to run_pool on the parsed chains": all(
            np.array_equal(r.answers, out["final_tokens"])
            and np.array_equal(r.answer_valid, out["final_is_token"]) for r in results_run),
        "one answer per question in the token vocabulary": (
            out["final_tokens"].shape == (n,) and 0 <= out["final_tokens"].min()
            and out["final_tokens"].max() < exe_cfg.token_classes),
        "finite boxes and confidences in [0, 1]": all(
            np.isfinite(out[k]).all() and 0 <= out[k].min() and out[k].max() <= 1
            for k in ("box_cache", "conf_cache")),
        "pool iterations cover every chain step": (
            iterations * REPEATS == main_forwards and iterations >= math.ceil(useful / SLOTS)),
        **launch_checks(launches, main_forwards, exe_cfg),
    }
    say(f"phase 6 main path: InferencePipeline.run (pool, {SLOTS} slots) on {n} questions, "
        f"{useful} chain steps (mean depth {useful / n:.2f}), {REPEATS} repeats: median "
        f"{median(run_s):.3f} s = {n / median(run_s):.1f} questions/s (all, s: "
        f"{', '.join(f'{t:.3f}' for t in run_s)}); its parts, once: generate {t1 - t0:.3f} s, "
        f"decode + parse {t2 - t1:.3f} s, run_pool {t3 - t2:.3f} s; {iterations} pool "
        f"iterations; {int(result.answer_valid.sum())} token answers, "
        f"{int(out['token_branch'].sum())} steps routed to the token branch; launches "
        f"{launches} for {main_forwards} executor forwards")
    for name, ok in checks.items():
        if not ok:
            fail(f"main path check failed: {name}")

    # where the time goes: one more run under the profiler (its counts of
    # launches are not the main path's and are not read)
    wall, prof = device_profile(
        torch, lambda: pipeline.run(questions, features_dev, chains.image_index,
                                    chain_mode="pool"))
    if prof is None:
        say(f"phase 6 profile: InferencePipeline.run {wall:.3f} s under the profiler; device "
            f"time not measured (the profiler saw no device activity)")
    else:
        busy, top, syncs, _ = prof
        total = sum(ms for _, ms in top)
        say(f"phase 6 profile: InferencePipeline.run {wall:.3f} s under the profiler, device "
            f"busy {busy:.3f} of it ({total:.1f} ms of kernels and copies), {syncs} host waits "
            f"on the card ({syncs / iterations:.2f} per pool iteration); by device time: "
            + "; ".join(f"{name[:70]} {ms:.1f} ms" for name, ms in top[:10]))

    # ---- 7. the sorted (default) and bucketed chain modes, bf16 ----
    for mode in ("sorted", "bucketed"):
        runs, seconds, mode_forwards, counts = repeats(mode)
        agree = int(np.sum((runs[0].answers == result.answers)
                           & (runs[0].answer_valid == result.answer_valid)))
        say(f"phase 7 {mode}: InferencePipeline.run on {n} questions, {REPEATS} repeats: median "
            f"{median(seconds):.3f} s = {n / median(seconds):.1f} questions/s (all, s: "
            f"{', '.join(f'{t:.3f}' for t in seconds)}); {mode_forwards // REPEATS} executor "
            f"forwards per run; {agree} of {n} answers agree with the pool's (bf16: batches of "
            f"other sizes may round differently); launches {counts}")
        mode_checks = {
            "every answer equal across repeats": all(
                np.array_equal(r.answers, runs[0].answers)
                and np.array_equal(r.answer_valid, runs[0].answer_valid) for r in runs),
            "one answer per question in the token vocabulary": (
                runs[0].answers.shape == (n,) and 0 <= runs[0].answers.min()
                and runs[0].answers.max() < exe_cfg.token_classes),
            **launch_checks(counts, mode_forwards, exe_cfg),
        }
        for name, ok in mode_checks.items():
            if not ok:
                fail(f"{mode} check failed: {name}")
    hook.remove()
    del runner, pipeline, executor
    torch.cuda.empty_cache()

    # ---- 8. float32 forward on the card against the CPU ----
    rng = np.random.RandomState(5)
    lo = rng.rand(4, exe_cfg.max_input_boxes, 2) * 0.6
    inputs = [
        rng.rand(4, exe_cfg.num_image_tokens, exe_cfg.image_feature_dim).astype(np.float32),
        np.concatenate([lo, lo + rng.rand(4, exe_cfg.max_input_boxes, 2) * 0.4], -1).astype(
            np.float32),
        rng.rand(4, exe_cfg.max_input_boxes) < 0.5,
        rng.randint(0, exe_cfg.vocab_size, (4, 3)),
        np.array([[1, 1, 0], [1, 0, 1], [1, 1, 1], [1, 0, 0]], bool),
    ]

    def card_vs_cpu(model):
        """The largest difference over every output of one float32 forward
        on the card and on the CPU (only the order of sums differs)."""
        cpu_model = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            on_card = model(*(torch.from_numpy(a).to(dev) for a in inputs))
            on_cpu = cpu_model(*(torch.from_numpy(a) for a in inputs))
        return max(float((on_card[k].cpu() - on_cpu[k]).abs().max()) for k in on_cpu), on_cpu

    executor = init_parameters(ProgramExecutor(exe_cfg, torch.float32, device=dev), seed=4).eval()
    worst, on_cpu = card_vs_cpu(executor)
    say(f"phase 8 fp32 executor forward, card vs CPU: max_abs_err {worst:.3g} (tol 1e-4) over "
        f"{', '.join(sorted(on_cpu))}")
    if not worst <= 1e-4:
        fail(f"fp32 forward on the card disagrees with the CPU: {worst}")

    # ---- 9. the chain modes agree in float32 ----
    m_features, m_questions, m_chains = synth_questions(MODE_QUESTIONS, exe_cfg, max_steps=27,
                                                        seed=6)
    m_runner = ExecutorChainRunner(executor, exe_cfg, max_steps=27, conf_thresholds=thresholds,
                                   device=dev)
    m_pipeline = InferencePipeline(
        scripted_programs(torch, generator, postfix_ids(m_chains, token_ids, FUNCTION_IDS,
                                                        gen_cfg.program_len)),
        m_runner, idx_to_token, FUNCTION_IDS, device=dev)
    m_features_dev = torch.from_numpy(m_features).to(dev)
    by_mode = {mode: m_pipeline.run(m_questions, m_features_dev, m_chains.image_index,
                                    chain_mode=mode) for mode in ("sorted", "bucketed", "pool")}
    per_question = m_features_dev[torch.as_tensor(m_chains.image_index, device=dev).long()]
    steps = {"sorted": m_runner.run_sorted(per_question, m_chains),
             "bucketed": m_runner.run_bucketed(per_question, m_chains),
             "pool": m_runner.run_pool(m_features_dev, m_chains)}
    pool_answers, pool_steps = by_mode["pool"], steps["pool"]
    answers_equal = all(np.array_equal(r.answers, pool_answers.answers)
                        and np.array_equal(r.answer_valid, pool_answers.answer_valid)
                        for r in by_mode.values())
    decisions_equal = all(np.array_equal(o[k], pool_steps[k]) for o in steps.values()
                          for k in ("token_branch", "token_cache", "box_mask"))
    box_err = max(float(np.abs(o[k] - pool_steps[k]).max()) for o in steps.values()
                  for k in ("box_cache", "conf_cache"))
    say(f"phase 9 fp32 chain modes on {MODE_QUESTIONS} questions "
        f"({int(m_chains.num_steps.sum())} steps): sorted, bucketed and pool answers "
        f"{'equal' if answers_equal else 'DIFFER'} ({int(pool_answers.answer_valid.sum())} token "
        f"answers); per-step decisions (routing, tokens, box masks: "
        f"{int(pool_steps['token_branch'].sum())} token steps, "
        f"{int(pool_steps['box_mask'].sum())} confident boxes) "
        f"{'equal' if decisions_equal else 'DIFFER'}; boxes and confidences within "
        f"{box_err:.3g} (tol 1e-4)")
    if not (answers_equal and decisions_equal and box_err <= 1e-4):
        fail("the chain modes disagree in float32")
    del executor, m_runner, m_pipeline, m_features_dev, per_question
    torch.cuda.empty_cache()

    # ---- 10. the executor_roi_sim_count configuration ----
    rs_cfg = ExecutorConfig(vocab_size=64, token_classes=32, box_roi=True, roi_sim=True,
                            roi_sim_heads=4, count_embed=True)
    rs_executor = init_parameters(ProgramExecutor(rs_cfg, torch.float32, device=dev),
                                  seed=7).eval()
    if not (rs_executor.sim_embed.weight.abs().sum() > 0
            and rs_executor.count_embed.weight.abs().sum() > 0):
        fail("the roi_sim and count_embed channels are zero")
    worst, on_cpu = card_vs_cpu(rs_executor)
    say(f"phase 10 executor_roi_sim_count fp32 forward, card vs CPU: max_abs_err {worst:.3g} "
        f"(tol 1e-4) over {', '.join(sorted(on_cpu))}")
    if not worst <= 1e-4:
        fail(f"the roi_sim_count forward on the card disagrees with the CPU: {worst}")
    del rs_executor
    rs_executor = init_parameters(ProgramExecutor(rs_cfg, dtype, device=dev), seed=7)
    rs_runner = ExecutorChainRunner(rs_executor, rs_cfg, max_steps=27,
                                    conf_thresholds=thresholds, device=dev)
    rs_pipeline = InferencePipeline(scripted_programs(torch, generator, scripted), rs_runner,
                                    idx_to_token, FUNCTION_IDS, device=dev)
    forwards[0] = 0
    hook = rs_executor.register_forward_hook(count_forwards)
    t0 = time.perf_counter()
    rs_result, rs_counts = counted(
        lambda: rs_pipeline.run(questions, features_dev, chains.image_index))
    rs_s = time.perf_counter() - t0
    hook.remove()
    say(f"phase 10 executor_roi_sim_count bf16: InferencePipeline.run (default mode, sorted) on "
        f"{n} questions, one run with no warm-up: {rs_s:.3f} s; {forwards[0]} executor "
        f"forwards; {int(rs_result.answer_valid.sum())} token answers; launches {rs_counts}")
    rs_checks = {
        "one answer per question in the token vocabulary": (
            rs_result.answers.shape == (n,) and 0 <= rs_result.answers.min()
            and rs_result.answers.max() < rs_cfg.token_classes),
        **launch_checks(rs_counts, forwards[0], rs_cfg),
    }
    for name, ok in rs_checks.items():
        if not ok:
            fail(f"executor_roi_sim_count check failed: {name}")

    del rs_runner, rs_pipeline, rs_executor, generator, features_dev, questions_dev
    torch.cuda.empty_cache()
    generator_training(torch, dev)
    trained = executor_training(torch, np, dev)
    card_vs_cpu_step(torch, np, dev)
    by_path = {**evaluation(torch, np, dev, counted, trained),
               **scheduled_training(torch, np, dev, counted),
               **cogent(torch, np, dev, counted), **baselines(torch, np, dev, counted),
               **cot_and_prototypes(torch, np, dev, counted),
               **data_prep(torch, np, dev, counted, trained),
               **last_slice(torch, np, dev, counted, results)}
    matcher, block_matcher, demo_paths = demos(torch, np, dev, counted)
    by_path.update(demo_paths)
    by_path.update(measurement_drivers(torch, counted))
    new_paths, wide_launches = new_widths(torch, np, dev, counted)
    by_path.update(new_paths)
    past_paths, deep_launches = past_256(torch, np, dev, counted)
    by_path.update(past_paths)
    wgmma_paths, wgmma_padded_launches = wgmma_padded_paths(torch, np, dev, counted)
    by_path.update(wgmma_paths)
    # the matcher's main path is the demos' executor training: phase 21.3's run
    matcher_launches = demo_paths["demo_accuracy_table_d512"]
    layers.fused_encoder_block = fused_encoder_block
    layers.fused_attention = fused_attention
    fp32_k2 = by_phase("K2 fp32")
    say(f"K2 launches with float32 weights (3xTF32 products) on the main path, by phase: "
        f"{fp32_k2}, {sum(fp32_k2.values())} in all")
    # the head dims the models run on the card: every one with kernels of its
    # own (phases 16-18, 21) and those of phases 16.1 and 23 on the padded
    # ones, 24 on the deep ones
    model_dims = sorted(set(EXACT_HEAD_DIMS + K1_ROUTING_PADDED + DEEP_MODEL_DIMS))
    k1_dims = {d: by_phase(f"K1 D={d}") for d in model_dims}
    say("K1 launches through the models by head dim, by phase: "
        + "; ".join(f"D={d} {c}, {sum(c.values())} in all" for d, c in k1_dims.items()))

    sources = (
        ("fused_attention", "explainable_spatial_vqa_tpu_torch/csrc/fused_attention.cu",
         "explainable_spatial_vqa_tpu/ops/pallas_attention.py:45", "K1_L10", launches),
        ("fused_encoder_block", "explainable_spatial_vqa_tpu_torch/csrc/fused_block.cu",
         "explainable_spatial_vqa_tpu/ops/pallas_block.py:113", "K2_bf16", launches),
        ("fused_encoder_block_tiled", "explainable_spatial_vqa_tpu_torch/csrc/fused_block.cu",
         "explainable_spatial_vqa_tpu/ops/pallas_block.py:197", "K3_bf16", bench_launches),
        ("hungarian_assignment_device", "explainable_spatial_vqa_tpu_torch/csrc/hungarian.cu",
         "explainable_spatial_vqa_tpu/ops/matching.py:312", "matcher", matcher_launches),
    )
    results["matcher"] = matcher
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep, launches=counts[name],
                    **results[key],
                    launches_by_path={path: c[name] for path, c in by_path.items()})
               for name, src, rep, key, counts in sources]
    kernels[1]["at_shapes"] = {"iqap_encoder_d512": results["K2_bf16_iqap"],
                               "hierarchical_encoder_d512": results["K2_bf16_hier"]}
    kernels[1]["launches_fp32_by_phase"] = fp32_k2
    # the matcher past 31 columns: one block a problem; its path is 21.2's
    # executor of WIDE_QUERIES queries, its launches the C library's count
    kernels.append(dict(name="hungarian_assignment_device_block", route="cuda",
                        source="explainable_spatial_vqa_tpu_torch/csrc/hungarian.cu",
                        replaces="explainable_spatial_vqa_tpu/ops/matching.py:312",
                        kernel="hungarian_block_kernel", **block_matcher))
    if not block_matcher["launches"]:
        fail("the block matcher never launched on its path")
    # K1's instantiations at the new head dims, each with its first model
    # shape's numbers and the rest under at_shapes; their paths are phases
    # 16-18 (and the demos at d 96): launches through the models, by phase
    for d_head in sorted({d for _, d, *_ in K1_MODEL_SHAPES}):
        shapes = [f"K1_D{d_head}_{label}" for label, d, *_ in K1_MODEL_SHAPES if d == d_head]
        encoder = next(key for key in shapes if "encoder" in key)
        kernels.append(dict(
            name=f"fused_attention_d{d_head}", route="cuda",
            source="explainable_spatial_vqa_tpu_torch/csrc/fused_attention.cu",
            replaces="explainable_spatial_vqa_tpu/ops/pallas_attention.py:45",
            launches=sum(k1_dims[d_head].values()), **results[encoder],
            shape=encoder.split("_", 2)[2],
            at_shapes={key.split("_", 2)[2]: results[key] for key in shapes if key != encoder},
            launches_by_phase=k1_dims[d_head]))
    # the one-pass kernel (bf16 rows of 17-256 keys at head dims up to 64):
    # the Transformer IQAP's shape's numbers, the other bf16 shapes under
    # at_shapes, its launches through the models by phase (17-18)
    onepass_shapes = [f"K1_D{d}_{label}" for label, d, *_ in K1_MODEL_SHAPES
                      if results[f"K1_D{d}_{label}"]["kernel"] == ONE_PASS]
    onepass_launches = by_phase(f"K1 {ONE_PASS}")
    say(f"K1's one-pass kernel launches through the models, by phase: {onepass_launches}, "
        f"{sum(onepass_launches.values())} in all")
    kernels.append(dict(
        name="fused_attention_onepass", route="cuda",
        source="explainable_spatial_vqa_tpu_torch/csrc/attention.cuh",
        replaces="explainable_spatial_vqa_tpu/ops/pallas_attention.py:45",
        launches=sum(onepass_launches.values()), **results[onepass_shapes[0]],
        shape=onepass_shapes[0].split("_", 2)[2],
        at_shapes={key.split("_", 2)[2]: results[key] for key in onepass_shapes[1:]},
        launches_by_phase=onepass_launches))
    kernels[0]["wrapper_at_shapes"] = {key[len("K1_wrapper_"):]: value
                                       for key, value in results.items()
                                       if key.startswith("K1_wrapper_")}
    # the padded kernels: K1 at the ragged head dims (the protocol at d_model
    # 100, its fusion encoder's shape first) and at 136-256 (serving at
    # d_model 1024, its box decoder's shape first), each with its launches
    # through the models by phase as the C library counted them; K2 and K3
    # at head dim 256 (d_model 1024), their launches on phase 23's serving
    # and block-bench paths
    padded_launches = {kind: by_phase(f"K1 {kind}") for kind in (PADDED, PADDED_F32)}
    say(f"K1's padded kernels' launches through the models, by phase: {padded_launches}")
    for name, takes, first in (
            ("fused_attention_padded_ragged", lambda d: d % 8 != 0 and d < 128,
             "K1_D25_protocol d 100 fusion encoder"),
            ("fused_attention_padded_wide", lambda d: 128 < d <= 256,
             "K1_D256_serving d 1024 box decoder bf16")):
        dims = [d for d in model_dims if takes(d)]
        shapes = [f"K1_D{d}_{label}" for label, d, _b, length, *_ in K1_NEW_SHAPES
                  if takes(d) and length <= 1024 and f"K1_D{d}_{label}" != first]
        kernels.append(dict(
            name=name, route="cuda",
            source="explainable_spatial_vqa_tpu_torch/csrc/attention_padded.cuh",
            replaces="explainable_spatial_vqa_tpu/ops/pallas_attention.py:45",
            launches=sum(sum(k1_dims[d].values()) for d in dims), **results[first],
            shape=first.split("_", 2)[2], head_dims=dims,
            at_shapes={key.split("_", 2)[2]: results[key] for key in shapes},
            launches_by_head_dim={d: k1_dims[d] for d in dims}))
    # rows past 1024 keys, on the kernels their head dims take
    kernels[0]["long_rows"] = {f"D{d}_{label}": results[f"K1_D{d}_{label}"]
                               for label, d, _b, length, *_ in K1_NEW_SHAPES if length > 1024}
    for name, src_name, key, path in (
            ("fused_encoder_block_hd256", "fused_encoder_block", "K2_bf16_hd256", "serving_d1024"),
            ("fused_encoder_block_tiled_hd256", "fused_encoder_block_tiled", "K3_bf16_hd256",
             "block_bench_d1024")):
        kernels.append(dict(
            name=name, route="cuda", source="explainable_spatial_vqa_tpu_torch/csrc/fused_block.cu",
            replaces=("explainable_spatial_vqa_tpu/ops/pallas_block.py:113" if "tiled" not in name
                      else "explainable_spatial_vqa_tpu/ops/pallas_block.py:197"),
            launches=new_paths[path][src_name], **results[key], shape=f"d=1024 H=4 ({path})",
            at_shapes={"fp32": results[key.replace("bf16", "fp32")]},
            launches_by_path={p: c[src_name] for p, c in new_paths.items()}))
    # the head-dim-256 kernels (attention_wide.cuh): their launches on phase
    # 23's paths by the C libraries' counts (split_f32: K2's attention in the
    # d 1024 protocol and serving; wgmma: K3's in the block bench), the
    # numbers of K2's and K3's attention alone, K1's layout under at_shapes
    for kernel, main_key, other_key in (
            (SPLIT_F32, "wide K2 attention fp32 L=210, bf16 out", "wide K1 fp32 L=208"),
            (WGMMA, "wide K3 attention bf16 L=224", "wide K1 bf16 L=208")):
        by_wide = {path: c[kernel] for path, c in wide_launches.items()}
        kernels.append(dict(
            name=kernel, route="cuda",
            source="explainable_spatial_vqa_tpu_torch/csrc/attention_wide.cuh",
            replaces=("explainable_spatial_vqa_tpu/ops/pallas_block.py:135" if kernel == SPLIT_F32
                      else "explainable_spatial_vqa_tpu/ops/pallas_block.py:232"),
            also_replaces="explainable_spatial_vqa_tpu/ops/pallas_attention.py:45",
            launches=sum(by_wide.values()), **results[main_key],
            at_shapes={other_key[len("wide "):]: results[other_key]},
            launches_by_path=by_wide))
    say("the head-dim-256 kernels: " + "; ".join(
        f"{k['name']} {k['ms']:.4f} ms (scaled_dot_product_attention {k['library_ms']:.4f}, bound {k['bound_ms']:.4f}), "
        f"{k['launches']} launches on phase 23's paths" for k in kernels[-2:]))
    unlaunched = [d for d in model_dims if not sum(k1_dims[d].values())]
    if unlaunched:
        fail(f"K1 at head dims {unlaunched} never launched through the models")
    if not sum(onepass_launches.values()):
        fail("K1's one-pass kernel never launched through the models")
    if not all(k["launches"] for k in kernels[-6:]):
        fail("a padded kernel, K2 or K3 at head dim 256, or a head-dim-256 attention kernel "
             "never launched on its path")
    # the wgmma kernels at head dims up to 128 (attention_wide.cuh): their
    # launches in phase 5's block bench (K3's attention at head dim 128, the
    # block library's counts) and through the models (K1 in phase 16.1's
    # bf16 forwards at d_model 288-480, the K1 library's counts); K3's
    # attention alone at L = 224 (one pass) and 304 (two passes), K1's shapes
    # under at_shapes
    for kernel, length, at_keys in (
            (WGMMA, 224, [f"K1_D{d}_protocol d {4 * d} fusion encoder bf16"
                          for d in WGMMA_DIMS if d < 128] + ["K1_L210"]),
            (WGMMA_2PASS, 304, [f"K1_D128_{label}" for label, d, _b, length_, *_ in K1_NEW_SHAPES
                                if d == 128 and length_ > 256])):
        by_k1 = by_phase(f"K1 {kernel}")
        in_bench = block_bench[length][2].get(kernel, 0)
        kernels.append(dict(
            name=f"{kernel}_hd128", route="cuda",
            source="explainable_spatial_vqa_tpu_torch/csrc/attention_wide.cuh",
            replaces="explainable_spatial_vqa_tpu/ops/pallas_block.py:232",
            also_replaces="explainable_spatial_vqa_tpu/ops/pallas_attention.py:45",
            launches=in_bench + sum(by_k1.values()),
            **results[f"wgmma K3 attention bf16 hd128 L={length}"],
            at_shapes={key[len("K1_"):]: results[key] for key in at_keys},
            launches_by_path={f"block_bench_L{length}": in_bench, "K1_by_phase": by_k1}))
    say("the wgmma kernels at head dims up to 128: " + "; ".join(
        f"{k['name']} {k['ms']:.4f} ms (scaled_dot_product_attention "
        f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f}), {k['launches']} launches "
        f"{k['launches_by_path']}" for k in kernels[-2:]))
    if not all(k["launches"] for k in kernels[-2:]):
        fail("a wgmma kernel at head dims up to 128 never launched on its path")
    # the deep float32 kernel (attention_padded.cuh past depth 256: K1 in
    # float32 at d 1100's fusion layers, rows of 1100 bytes) and the two-pass
    # wgmma kernel past depth 128 (attention_wide.cuh: bf16 past 256 keys, K3's
    # attention in the d 2048 block bench at L = 304; no model sends such
    # rows): their launches on phase 24's paths by the C libraries' counts,
    # the numbers at d 1100 and at a 1025-key row of D = 512 (D = 256's under
    # at_shapes); then K2 and K3 at head dim 512 (d_model 2048), their
    # launches on phase 24's serving and block-bench paths
    for kernel, main_key, other_keys in (
            (DEEP_F32, "d 1100 encoder", ()),
            (WGMMA_2PASS_DEEP, "rows past 256 keys d 2048 bf16",
             ("rows past 256 keys d 1024 bf16",))):
        by_deep = {path: c[kernel] for path, c in deep_launches.items()}
        kernels.append(dict(
            name=kernel, route="cuda",
            source=("explainable_spatial_vqa_tpu_torch/csrc/attention_padded.cuh"
                    if kernel == DEEP_F32 else
                    "explainable_spatial_vqa_tpu_torch/csrc/attention_wide.cuh"),
            replaces=("explainable_spatial_vqa_tpu/ops/pallas_block.py:135" if kernel == DEEP_F32
                      else "explainable_spatial_vqa_tpu/ops/pallas_attention.py:45"),
            also_replaces=("explainable_spatial_vqa_tpu/ops/pallas_attention.py:45"
                           if kernel == DEEP_F32
                           else "explainable_spatial_vqa_tpu/ops/pallas_block.py:232"),
            launches=sum(by_deep.values()), **results[f"deep {main_key}"],
            at_shapes={key: results[f"deep {key}"] for key in other_keys},
            launches_by_path=by_deep))
    kernels[-1]["off_path"] = ("bf16 rows past 256 keys at padded depths 160-512: no model sends "
                               "them; its launches are K3's attention in phase 24.4's block "
                               "bench at L = 304 only (phase 3 holds it at 257, 1025 and 4096 "
                               "keys)")
    # attention_kernel_wide_f32 (attention_f32_wide.cuh): its launches on
    # phase 24's paths (K2's attention at d 2048 and 1536) and phase 25's
    # float32 forwards (K1's fusion layers at d 768 and 1280) by the C
    # libraries' counts, the numbers of K2's attention at d 2048, the other
    # shapes under at_shapes
    on_f32_wide = {path: c.get(WIDE_F32, 0)
                   for path, c in {**deep_launches, **wgmma_padded_launches}.items()}
    kernels.append(dict(
        name=WIDE_F32, route="cuda",
        source="explainable_spatial_vqa_tpu_torch/csrc/attention_f32_wide.cuh",
        replaces="explainable_spatial_vqa_tpu/ops/pallas_block.py:135",
        also_replaces="explainable_spatial_vqa_tpu/ops/pallas_attention.py:45",
        launches=sum(on_f32_wide.values()), **results["deep K2 attention d 2048"],
        at_shapes={"K2 attention d 1536 fp32": results["deep K2 attention d 1536 fp32"],
                   "d 544 encoder": results["K1_D136_d 544 encoder"],
                   **{label: results[f"f32wide {label}"] for label, *_ in F32_WIDE_TIMED}},
        launches_by_path=on_f32_wide))
    for name, src_name, key, path in (
            ("fused_encoder_block_hd512", "fused_encoder_block", "K2_bf16_hd512", "serving_d2048"),
            ("fused_encoder_block_tiled_hd512", "fused_encoder_block_tiled", "K3_bf16_hd512",
             "block_bench_d2048")):
        kernels.append(dict(
            name=name, route="cuda", source="explainable_spatial_vqa_tpu_torch/csrc/fused_block.cu",
            replaces=("explainable_spatial_vqa_tpu/ops/pallas_block.py:113" if "tiled" not in name
                      else "explainable_spatial_vqa_tpu/ops/pallas_block.py:197"),
            launches=past_paths[path][src_name], **results[key], shape=f"d=2048 H=4 ({path})",
            at_shapes={"fp32": results[key.replace("bf16", "fp32")]},
            launches_by_path={p: c[src_name] for p, c in past_paths.items()}))
    say("the deep float32 kernel, the two-pass wgmma kernel past depth 128, "
        "attention_kernel_wide_f32 and K2 and K3 at head dim 512: " + "; ".join(
        f"{k['name']} {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, library "
        f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f}), {k['launches']} launches on phases "
        f"24-25's paths" for k in kernels[-5:]))
    if not all(k["launches"] for k in kernels[-5:]):
        fail("the deep float32 kernel, the two-pass wgmma kernel past depth 128, "
             "attention_kernel_wide_f32, or K2 or K3 at head dim 512, never launched on its path")
    # the one-pass wgmma kernels past depth 128 (attention_wide.cuh): their
    # launches on phases 24.3, 24.4 and 25 by the C libraries' counts (wgmma
    # at depths 160-224: K1 in serving's fusion layers at d 768; wgmma_deep:
    # K3's attention in the d 2048 block bench, K1 in serving's fusion layers
    # at d 1280 and in bf16 at d 1100's, rows of 550 bytes), the numbers at d
    # 768 and of K3's attention at d 2048
    on_wgmma = {**wgmma_padded_launches,
                **{path: deep_launches[path]
                   for path in ("block_bench_d2048", "executor_d1100_bf16")}}
    for kernel, main_key, other_keys in (
            (WGMMA, "wgmma padded d 768 encoder bf16", ()),
            (WGMMA_DEEP, "wgmma padded K3 attention d 2048", ("wgmma padded d 1280 encoder bf16",
                                                              "deep d 1100 encoder bf16"))):
        on_paths = {path: c.get(kernel, 0) for path, c in on_wgmma.items()}
        kernels.append(dict(
            name=f"{kernel}_past_depth_128" if kernel == WGMMA else kernel, route="cuda",
            source="explainable_spatial_vqa_tpu_torch/csrc/attention_wide.cuh",
            replaces="explainable_spatial_vqa_tpu/ops/pallas_attention.py:45",
            also_replaces=("explainable_spatial_vqa_tpu/ops/pallas_block.py:232"
                           if kernel == WGMMA_DEEP else None),
            launches=sum(on_paths.values()), **results[main_key],
            at_shapes={key.split(" ", 1)[1].removeprefix("padded "): results[key]
                       for key in other_keys},
            launches_by_path=on_paths))
    say("the one-pass wgmma kernels past depth 128: " + "; ".join(
        f"{k['name']} {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, scaled_dot_product_attention "
        f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f}), {k['launches']} launches "
        f"{k['launches_by_path']}" for k in kernels[-2:]))
    if not all(k["launches"] for k in kernels[-2:]):
        fail("a one-pass wgmma kernel past depth 128 never launched on its path")
    # the short kernels (attention_padded.cuh, rows of at most 16 keys past
    # depth 128): their launches on phases 23-25 by the C libraries' counts
    # (short: the bf16 serving box decoders at d 768-2048 and K1 in bf16 at
    # d 1100's; short_f32: the float32 box decoders of the d 1024 and 1536
    # protocols and of d 1100), the numbers at serving's d 2048 box decoder
    # and the d 1536 protocol's, the other box decoders under at_shapes
    on_short = {**wide_launches, **deep_launches, **wgmma_padded_launches}
    for kernel, main_key, other_keys in (
            (SHORT, "deep serving d 2048 box decoder",
             ("K1_D256_serving d 1024 box decoder bf16", "short serving d 768 box decoder bf16",
              "short serving d 1280 box decoder bf16")),
            (SHORT_F32, "deep protocol d 1536 box decoder",
             ("K1_D256_protocol d 1024 box decoder",))):
        on_paths = {path: c.get(kernel, 0) for path, c in on_short.items()}
        kernels.append(dict(
            name=kernel, route="cuda",
            source="explainable_spatial_vqa_tpu_torch/csrc/attention_padded.cuh",
            replaces="explainable_spatial_vqa_tpu/ops/pallas_attention.py:45",
            also_replaces=("explainable_spatial_vqa_tpu/ops/pallas_block.py:232" if kernel == SHORT
                           else "explainable_spatial_vqa_tpu/ops/pallas_block.py:135"),
            launches=sum(on_paths.values()), **results[main_key],
            at_shapes={key.split(" ", 1)[1] if key.startswith("short ") else key[len("K1_"):]:
                       results[key] for key in other_keys},
            launches_by_path=on_paths))
    say("the short kernels: " + "; ".join(
        f"{k['name']} {k['ms']:.4f} ms (device "
        + (f"{k['device_ms']:.4f}" if "device_ms" in k else "not measured")
        + f", plain {k['plain_ms']:.4f}, scaled_dot_product_attention {k['library_ms']:.4f}, "
        f"bound {k['bound_ms']:.4f}), {k['launches']} launches {k['launches_by_path']}"
        for k in kernels[-2:]))
    if not all(k["launches"] for k in kernels[-2:]):
        fail("a short kernel never launched on its path")
    total = sum(PHASE_SECONDS.values())
    say("seconds by phase: " + ", ".join(f"{p} {sec:.1f}" for p, sec in sorted(
        PHASE_SECONDS.items())) + f"; {total:.1f} s in all, {time.perf_counter() - T_START:.1f} s "
        f"since the script started")
    say(json.dumps({"kernels": kernels, "parts": parts}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def step_profile(torch, name: str, fn) -> None:
    """One training step under torch.profiler: its wall time, the card's busy
    share of it and its count of kernels and copies."""
    wall, prof = device_profile(torch, fn)
    if prof is None:
        say(f"{name} profile: {wall * 1e3:.1f} ms under the profiler; device time not measured "
            f"(the profiler saw no device activity)")
        return
    busy, top, _syncs, launches = prof
    say(f"{name} profile: one step {wall * 1e3:.1f} ms under the profiler, device busy "
        f"{busy:.3f} of it, {launches} kernels and copies; by device time: "
        + "; ".join(f"{n[:60]} {ms:.2f} ms" for n, ms in top[:5]))


def generator_training(torch, dev) -> None:
    """Phase 11: the ``generator`` preset at full width (3+3 LSTM layers,
    hidden 512), bf16, batch 64, teacher forcing 0.5 and dropout 0.3, on
    ``bench_data``'s questions and programs: ``GENERATOR_STEPS`` + 1 updates
    of one fixed batch through ``Trainer.train_step``, each between CUDA
    events.  The loss at step ``GENERATOR_STEPS`` must be below 0.8 of step
    0's; the step time is the median of 20 steps after 3 warm-ups."""
    from explainable_spatial_vqa_tpu_torch.bench_data import synth_generator_batch
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.train.pipelines import generator_pipeline_from_arrays
    from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cfg = get_preset("generator")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, log_every=0))
    pipe = generator_pipeline_from_arrays(cfg, *synth_generator_batch(128, cfg.model, seed=11),
                                          device=dev)
    trainer = Trainer(pipe.loss_fn, pipe.model, cfg.optim, cfg.train, pipe.steps_per_epoch,
                      checkpoint_dir=False, device=dev)
    batch = to_device(next(iter(pipe.train_batches(0))), dev)
    gen = torch.Generator().manual_seed(0)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(GENERATOR_STEPS + 1)]
    losses = []
    for start, end in marks:
        start.record()
        losses.append(trainer.train_step(batch, gen)["loss_sum"])
        end.record()
    losses = torch.stack(losses).tolist()  # waits for the card
    ms = sorted(start.elapsed_time(end) for start, end in marks[3:23])[10]
    say(f"phase 11 generator training ({cfg.model.encoder_layers}+{cfg.model.decoder_layers} "
        f"LSTM layers, hidden {cfg.model.hidden_dim}, bf16, batch {cfg.train.batch_size}, "
        f"teacher forcing {cfg.model.teacher_forcing}, dropout {cfg.model.dropout}, lr "
        f"{cfg.optim.learning_rate}): {ms:.2f} ms per step (median of 20 after 3 warm-ups); "
        f"fixed-batch loss step 0 {losses[0]:.4f}, step {GENERATOR_STEPS} {losses[-1]:.4f} "
        f"({losses[-1] / losses[0]:.3f} of step 0, tol 0.8); {time.perf_counter() - t0:.1f} s")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < 0.8 * losses[0]):
        fail("the generator's fixed-batch loss did not fall below 0.8 of its first value")
    step_profile(torch, "phase 11 generator train step", lambda: trainer.train_step(batch, gen))
    del trainer, pipe, batch
    torch.cuda.empty_cache()


def executor_training(torch, np, dev):
    """Phase 12: the ``executor_roi`` preset at full width, bf16, on
    ``bench_data``'s executor steps (features on the card):

    - ``Trainer.fit`` for one epoch (about 40 steps at the preset's batch
      16, then a validation pass), with the kernels' launches counted per
      forward by mode: none in train mode, K2 3 and K1 2 per eval forward;
    - a separate timed loop at batch 16 and 128: each step's forward, loss
      (with the matcher), backward and optimizer between CUDA events, the
      matcher's host round trip alone on the step's cost, and the peak
      memory at 128;
    - ``EXECUTOR_STEPS`` updates of one fixed batch of 16 at the preset's
      learning rate: the loss must fall below 0.8 of its first value;
    - after an optimizer step, an eval forward equal, bit for bit, to that
      of a fresh ``ProgramExecutor`` loaded with the stepped ``state_dict``.

    Returns the fixed batch's trained executor as (its config, its
    ``state_dict`` on the host), for phase 14's float32 tally.
    """
    from explainable_spatial_vqa_tpu_torch.bench_data import synth_executor_steps
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.ops.matching import hungarian_assignment
    from explainable_spatial_vqa_tpu_torch.train.losses import executor_set_loss, matching_cost
    from explainable_spatial_vqa_tpu_torch.train.pipelines import executor_pipeline_from_arrays
    from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cfg = get_preset("executor_roi")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=1, log_every=0))
    arrays, features = synth_executor_steps(EXECUTOR_ROWS, cfg.model, seed=12)
    features = torch.from_numpy(features).to(dev)

    def pipeline():
        return executor_pipeline_from_arrays(cfg, arrays, features, device=dev)

    def trainer_of(pipe):
        return Trainer(pipe.loss_fn, pipe.model, cfg.optim, cfg.train, pipe.steps_per_epoch,
                       checkpoint_dir=False, device=dev)

    pipe = pipeline()
    model = pipe.model
    trainer = trainer_of(pipe)
    log = ForwardLaunches(model)
    t1 = time.perf_counter()
    history = trainer.fit(pipe.train_batches, pipe.val_batches, pipe.monitor, num_epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    log.remove()
    train, val = history["train"][0], history["val"][0]
    tr, ev = log.tally(training=True), log.tally(training=False)
    say(f"phase 12 executor training, Trainer.fit one epoch (executor_roi, d={cfg.model.d_model}, "
        f"{cfg.model.encoder_layers}+{cfg.model.box_decoder_layers} layers, bf16, batch "
        f"{cfg.train.batch_size}, {EXECUTOR_ROWS} synthetic steps, "
        f"{float(arrays['is_box_branch'].mean()):.3f} spatial): {fit_s:.2f} s for "
        f"{int(train['batches'])} train steps and {int(val['batches'])} validation batches; "
        f"train loss {train['loss_sum'] / train['batches']:.4f}, validation loss "
        f"{val['loss_sum'] / val['batches']:.4f}, routing accuracy "
        f"{val['routing_correct'] / val['routing_total']:.3f}; launches in train forwards "
        f"{tr}, in eval forwards {ev}")
    launch_checks = {
        "K1 and K2 launch zero times in train steps": (
            tr["forwards"] == train["batches"] and tr["K2"] == 0 and tr["K1"] == 0),
        "K2 3 and K1 2 launches per validation forward": (
            ev["forwards"] == val["batches"] > 0 and ev["K2"] == 3 * ev["forwards"]
            and ev["K1"] == 2 * ev["forwards"]),
    }
    for name, ok in launch_checks.items():
        if not ok:
            fail(f"executor training check failed: {name}")

    # fresh weights in eval: the model's kept weights were filled by the
    # validation pass; one more step must not leave them stale
    val_batch = to_device(next(iter(pipe.val_batches())), dev)
    inputs = [val_batch[k] for k in ("image", "input_boxes", "input_box_mask", "text",
                                     "text_mask")]

    def eval_forward(m):
        m.eval()
        with torch.no_grad():
            return m(*inputs)

    stale = eval_forward(model)
    trainer.train_step(val_batch, torch.Generator().manual_seed(1))
    after = eval_forward(model)
    fresh = ProgramExecutor(cfg.model, model.dtype, device=dev)
    fresh.load_state_dict(model.state_dict())
    reference = eval_forward(fresh)
    equal = all(torch.equal(after[k], reference[k]) for k in reference)
    moved = not torch.equal(after["pred_boxes"], stale["pred_boxes"])
    say(f"phase 12 eval forward after an optimizer step: {'equal' if equal else 'NOT EQUAL'} "
        f"to a fresh ProgramExecutor loaded with the stepped state_dict, bit for bit "
        f"({'moved' if moved else 'did NOT move'} from the forward before the step)")
    if not (equal and moved):
        fail("an eval forward after an optimizer step does not use the stepped weights")
    del fresh, trainer, pipe, model

    # each step's parts, at batch 16 and 128, in a loop of their own
    for batch_size in (16, 128):
        pipe = pipeline()
        trainer = trainer_of(pipe)
        model = pipe.model
        batch = to_device({k: v[:batch_size] for k, v in arrays.items()}, dev)
        batch["image"] = features[batch["image_index"].long()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks = [[torch.cuda.Event(enable_timing=True) for _ in range(7)] for _ in range(23)]
        model.train()
        for ev_ in marks:
            ev_[0].record()
            out = model(batch["image"], batch["input_boxes"], batch["input_box_mask"],
                        batch["text"], batch["text_mask"])
            ev_[1].record()
            loss = executor_set_loss(out, batch["target_boxes"], batch["target_box_mask"],
                                     batch["token_target"], batch["is_box_branch"],
                                     cfg.model)["loss"]
            ev_[2].record()
            trainer.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            ev_[3].record()
            trainer.apply_gradients()
            ev_[4].record()
            cost = matching_cost(out["pred_boxes"].detach(), out["pred_conf"].detach(),
                                 batch["target_boxes"], cfg.model)
            ev_[5].record()
            hungarian_assignment(cost, batch["target_box_mask"])
            ev_[6].record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        def med(i, j):
            ms = sorted(e[i].elapsed_time(e[j]) for e in marks[3:])
            return ms[len(ms) // 2]

        parts = dict(step=med(0, 4), forward=med(0, 1), loss=med(1, 2), backward=med(2, 3),
                     optimizer=med(3, 4), matcher=med(5, 6))
        say(f"phase 12 executor train step, batch {batch_size}: {parts['step']:.2f} ms (median "
            f"of 20 after 3 warm-ups); parts: forward {parts['forward']:.2f} ms, loss with the "
            f"matcher {parts['loss']:.2f} ms (the matcher's host round trip alone "
            f"{parts['matcher']:.2f} ms), backward {parts['backward']:.2f} ms, optimizer "
            f"{parts['optimizer']:.2f} ms; peak memory {peak:.2f} GiB")
        if not math.isfinite(float(loss.detach())):
            fail(f"the executor's loss at batch {batch_size} is not finite")
        step_profile(torch, f"phase 12 executor train step, batch {batch_size},",
                     lambda: trainer.train_step(batch, torch.Generator().manual_seed(0)))
        del trainer, pipe, model, batch, out, loss, cost
        torch.cuda.empty_cache()

    # the loss of one fixed batch of 16 at the preset's learning rate
    pipe = pipeline()
    trainer = trainer_of(pipe)
    batch = to_device(next(iter(pipe.train_batches(0))), dev)
    gen = torch.Generator().manual_seed(2)
    losses = torch.stack([trainer.train_step(batch, gen)["loss_sum"]
                          for _ in range(EXECUTOR_STEPS + 1)]).tolist()
    below = [i for i, x in enumerate(losses) if x < 0.8 * losses[0]]
    say(f"phase 12 executor fixed-batch loss (batch {cfg.train.batch_size}, lr "
        f"{cfg.optim.learning_rate}): step 0 {losses[0]:.4f}, step {EXECUTOR_STEPS} "
        f"{losses[-1]:.4f}, lowest {min(losses):.4f}; first below 0.8 of step 0 at step "
        f"{below[0] if below else None}; phase 12 took {time.perf_counter() - t0:.1f} s")
    if not (all(math.isfinite(x) for x in losses) and below):
        fail(f"the executor's fixed-batch loss did not fall below 0.8 of its first value within "
             f"{EXECUTOR_STEPS} steps")
    trained = (cfg.model, {k: v.detach().cpu() for k, v in pipe.model.state_dict().items()})
    del trainer, pipe, batch, features
    torch.cuda.empty_cache()
    return trained


def card_vs_cpu_step(torch, np, dev) -> None:
    """Phase 13: one float32 training step (TF32 off, dropout 0) of
    ``executor_roi`` and of ``generator`` at full width, the same weights
    and batch on the card and on the CPU: the loss within 1e-5 relative,
    every gradient within 1e-4 of its tensor's max |g|, and the executor's
    Hungarian assignments equal.  An attention key bias's exact gradient is
    zero (the softmax ignores a constant added to a query's scores); those
    are held within 1e-6 of the model's largest gradient instead."""
    from explainable_spatial_vqa_tpu_torch.bench_data import (
        synth_executor_steps,
        synth_generator_batch,
    )
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.train.losses import executor_set_loss
    from explainable_spatial_vqa_tpu_torch.train.pipelines import (
        executor_pipeline_from_arrays,
        generator_pipeline_from_arrays,
    )
    from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device

    t0 = time.perf_counter()
    cpu = torch.device("cpu")

    def step(model, batch, run):
        model.train()
        model.zero_grad(set_to_none=True)
        loss, extra = run(model, to_device(batch, next(model.parameters()).device))
        loss.backward()
        return (float(loss.detach()), extra,
                {n: p.grad.detach().cpu() for n, p in model.named_parameters()})

    def compare(name, model, batch, run):
        cpu_model = copy.deepcopy(model).to(cpu)
        loss, extra, grads = step(model, batch, run)
        cpu_loss, cpu_extra, cpu_grads = step(cpu_model, batch, run)
        largest = max(float(g.abs().max()) for g in cpu_grads.values())
        worst, worst_name = 0.0, None
        for key, g in cpu_grads.items():
            diff = float((grads[key] - g).abs().max())
            if key.endswith(".k.bias"):
                ok = max(float(grads[key].abs().max()), float(g.abs().max())) <= 1e-6 * largest
                rel = 0.0 if ok else math.inf
            else:
                rel = diff / max(float(g.abs().max()), 1e-30)
            if rel > worst:
                worst, worst_name = rel, key
        rel_loss = abs(loss - cpu_loss) / abs(cpu_loss)
        same = extra is None or torch.equal(extra.cpu(), cpu_extra.cpu())
        say(f"phase 13 {name} fp32 train step, card vs CPU: loss {loss:.6f} vs {cpu_loss:.6f} "
            f"({rel_loss:.2e} relative, tol 1e-5); largest gradient difference "
            f"{worst:.2e} of its tensor's max |g| ({worst_name}; tol 1e-4) over "
            f"{len(grads)} tensors" + ("" if extra is None else
                                      f"; Hungarian assignments {'equal' if same else 'DIFFER'}"))
        if not (rel_loss <= 1e-5 and worst <= 1e-4 and same):
            fail(f"the {name} fp32 training step on the card disagrees with the CPU")

    cfg = get_preset("executor_roi")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0),
                      train=dataclasses.replace(cfg.train, dtype="float32"))
    arrays, features = synth_executor_steps(CARD_VS_CPU_ROWS, cfg.model, seed=13)
    pipe = executor_pipeline_from_arrays(cfg, arrays, features, device=dev)
    batch = {k: v[:CARD_VS_CPU_ROWS] for k, v in arrays.items()}
    batch["image"] = features[batch["image_index"]]

    def run_executor(model, b):
        out = model(b["image"], b["input_boxes"], b["input_box_mask"], b["text"], b["text_mask"])
        losses = executor_set_loss(out, b["target_boxes"], b["target_box_mask"],
                                   b["token_target"], b["is_box_branch"], cfg.model)
        return losses["loss"], losses["assignment"]

    compare("executor_roi", pipe.model, batch, run_executor)
    del pipe

    cfg = get_preset("generator")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0),
                      train=dataclasses.replace(cfg.train, dtype="float32"))
    questions, programs, image_index = synth_generator_batch(CARD_VS_CPU_ROWS, cfg.model, seed=13)
    pipe = generator_pipeline_from_arrays(cfg, questions, programs, image_index, device=dev)

    def run_generator(model, b):
        # teacher forcing 0.5: the same coins on both sides
        loss, _ = pipe.loss_fn(model, b, torch.Generator().manual_seed(3), True)
        return loss, None

    compare("generator", pipe.model, {"questions": questions, "programs": programs},
            run_generator)
    say(f"phase 13 took {time.perf_counter() - t0:.1f} s")


class ForwardLaunches:
    """Hooks on an executor that record, for each forward, when it returned
    (``time.perf_counter()``), its mode and the K2 and K1 launches made
    inside it."""

    def __init__(self, module):
        from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention
        from explainable_spatial_vqa_tpu_torch.ops.fused_block import fused_encoder_block

        self.wrappers = (fused_encoder_block, fused_attention)
        self.records = []  # (end time, training, K2, K1)
        self._before = None
        self._hooks = [module.register_forward_pre_hook(self._pre),
                       module.register_forward_hook(self._post)]

    def _pre(self, _module, _args):
        self._before = [w.launches for w in self.wrappers]

    def _post(self, module, _args, _out):
        self.records.append((time.perf_counter(), module.training,
                             *(w.launches - n for w, n in zip(self.wrappers, self._before))))

    def remove(self):
        for hook in self._hooks:
            hook.remove()

    def tally(self, start=-math.inf, end=math.inf, training=None) -> dict:
        """Forwards and launches of the forwards that returned in [start, end]
        (in ``training`` mode, or either)."""
        rows = [r for r in self.records
                if start <= r[0] <= end and (training is None or r[1] == training)]
        return dict(forwards=len(rows), K2=sum(r[2] for r in rows), K1=sum(r[3] for r in rows))


def per_forward_ok(c: dict, cfg) -> bool:
    """K2 once per fusion layer and K1 once per box-decoder layer in each forward."""
    return (c["forwards"] > 0 and c["K2"] == cfg.encoder_layers * c["forwards"]
            and c["K1"] == cfg.box_decoder_layers * c["forwards"])


def evaluation(torch, np, dev, counted, trained) -> dict:
    """Phase 14, evaluation at full width (generator preset: hidden 512, 3+3
    layers; executor: d=512, 4 heads, 3 fusion and 2 box-decoder layers, 196
    image tokens of 1024 features, 10 queries, ``box_roi``), bf16, random
    weights from seeds:

    - ``beam_generate`` at beam 4 on ``EVAL_QUESTIONS`` questions, timed
      beside ``generate``; beam 1 must equal ``generate`` up to and including
      its first <END>; in float32 on ``FP32_QUESTIONS`` questions each beam's
      score must be its tokens' log-probability under a teacher-forced
      forward.  How often the best of 4 beams scores below beam 1 is printed:
      beam search is not monotone in its width (nor is the JAX package's);
    - ``evaluate_executor_steps`` over ``EVAL_STEPS`` executor steps in
      batches of ``EVAL_BATCH``: 3 K2 and 2 K1 launches per forward;
    - ``run_tally`` (the CLI's ``tally`` on arrays) on ``EVAL_QUESTIONS``
      ``synth_annotated`` questions in the ``"sorted"`` mode with per-function
      calibration: each executor run's wall time, forwards and launches (3
      and 2 per forward), the map;
    - float32 on ``FP32_QUESTIONS`` questions, with ``trained``, phase 12's
      trained executor (its boxes have the data's sizes, so some match a
      ground-truth box; random weights match none and put every function
      at the grid's first threshold): the first chain run's decisions and
      the per-function map on the card equal to the CPU's (where a map
      entry differs, the confidences within 1e-4 of the deciding thresholds
      are printed, and the phase fails if there are none); the true
      positives and the functions whose threshold moved off 0.05 are
      printed, and the phase fails without a true positive.

    Returns the launches of each path, for the result line."""
    from explainable_spatial_vqa_tpu_torch.bench_data import (
        FUNCTION_IDS,
        PROGRAM_TOKENS,
        postfix_ids,
        synth_annotated,
        synth_executor_steps,
        synth_generator_batch,
    )
    from explainable_spatial_vqa_tpu_torch.cli.main import run_chains, run_tally
    from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, get_preset
    from explainable_spatial_vqa_tpu_torch.core.vocab import canonicalize
    from explainable_spatial_vqa_tpu_torch.evalsuite.executor_eval import (
        _collect_chain_detections,
        calibrate_chain_conf_thresholds_per_function,
        evaluate_executor_steps,
    )
    from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.train.datasets import chain_arrays

    t_phase = time.perf_counter()
    dtype = torch.bfloat16
    n = EVAL_QUESTIONS

    # ---- beam search ----
    gen_cfg = get_preset("generator").model
    questions, _programs, _index = synth_generator_batch(n, gen_cfg, seed=14)
    generator = init_parameters(ProgramGenerator(gen_cfg, dtype, device=dev), seed=14)
    q = torch.from_numpy(questions).to(dev)
    generator.beam_generate(q[:16], 4)  # first calls: cuBLAS set-up, the allocator's pools
    generator.generate(q[:16])

    def timed_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (tokens, scores), beam_s = timed_s(lambda: generator.beam_generate(q, 4))
    greedy, greedy_s = timed_s(lambda: generator.generate(q))
    single, single_scores = generator.beam_generate(q, 1)
    tokens, scores, single, single_scores, greedy = (
        t.cpu().numpy() for t in (tokens, scores, single[:, 0], single_scores[:, 0], greedy))

    def until_end(row):
        hits = np.flatnonzero(row == PROGRAM_TOKENS.index("<END>"))
        return row[:hits[0] + 1] if len(hits) else row

    same = sum(np.array_equal(until_end(a), until_end(b)) for a, b in zip(single, greedy))
    worse = int((scores[:, 0] < single_scores - 1e-5).sum())

    # float32: each beam's score is its tokens' log-probability, rescored by
    # a teacher-forced forward (nothing after the first <END> but padding,
    # at no cost)
    gen32 = init_parameters(ProgramGenerator(gen_cfg, torch.float32, device=dev), seed=14).eval()
    q32 = q[:FP32_QUESTIONS]
    toks32, scores32 = gen32.beam_generate(q32, 4)
    flat = toks32.reshape(-1, gen_cfg.program_len)
    with torch.no_grad():
        logits = gen32(q32.repeat_interleave(4, dim=0), flat, teacher_forcing=1.0)["logits"]
    logp = torch.log_softmax(logits.float(), -1).gather(-1, flat[..., None])[..., 0]
    is_end = (flat == PROGRAM_TOKENS.index("<END>")).long()
    after_end = (torch.cumsum(is_end, 1) - is_end) > 0
    rescored = torch.where(after_end, 0.0, logp).sum(-1).reshape(scores32.shape)
    rescore_err = float((rescored - scores32).abs().max())
    del gen32, logits
    beam_checks = {
        "beam tokens (N, 4, 27) in the program vocabulary, finite scores best first": (
            tokens.shape == (n, 4, gen_cfg.program_len) and 0 <= tokens.min()
            and tokens.max() < gen_cfg.program_vocab_size and np.isfinite(scores).all()
            and (np.diff(scores, axis=1) <= 0).all()),
        "beam 1 equal to generate up to and including its first <END>": same == n,
        "float32: every beam's score its tokens' teacher-forced log-probability (1e-3), "
        "only padding after <END>": (
            rescore_err <= 1e-3 and not bool(flat[after_end].any())),
    }
    say(f"phase 14 beam_generate, beam 4, on {n} questions (bf16, hidden {gen_cfg.hidden_dim}, "
        f"{gen_cfg.encoder_layers}+{gen_cfg.decoder_layers} layers, {gen_cfg.program_len} "
        f"steps): {beam_s * 1e3:.1f} ms = {n / beam_s:.1f} questions/s (generate: "
        f"{greedy_s * 1e3:.1f} ms = {n / greedy_s:.1f} questions/s); beam 1 equal to generate "
        f"on {same} of {n}; mean best score {scores[:, 0].mean():.4f}, beam 1's "
        f"{single_scores.mean():.4f}, the best beam below beam 1's on {worse} (beam search is "
        f"not monotone in the beam's width, in the JAX package too: "
        f"tests/test_torch_generator.py); float32 on {FP32_QUESTIONS} questions: scores within "
        f"{rescore_err:.2e} of the teacher-forced log-probabilities (tol 1e-3)")
    for name, ok in beam_checks.items():
        if not ok:
            fail(f"beam search check failed: {name}")

    # ---- evaluate_executor_steps ----
    exe_cfg = ExecutorConfig(vocab_size=64, token_classes=32, box_roi=True)
    executor = init_parameters(ProgramExecutor(exe_cfg, dtype, device=dev), seed=15)
    arrays, features = synth_executor_steps(EVAL_STEPS, exe_cfg, seed=15)
    features_dev = torch.from_numpy(features).to(dev)
    batches = []
    for start in range(0, EVAL_STEPS, EVAL_BATCH):
        part = {k: v[start:start + EVAL_BATCH] for k, v in arrays.items()}
        part["image"] = features_dev[torch.as_tensor(part["image_index"], device=dev).long()]
        batches.append(part)
    names = {i: name for name, i in FUNCTION_IDS.items()}
    evaluate_executor_steps(executor, batches[:1], names, device=dev)  # first calls
    log = ForwardLaunches(executor)
    (tally, eval_counts), eval_s = timed_s(
        lambda: counted(lambda: evaluate_executor_steps(executor, batches, names, device=dev)))
    log.remove()
    steps = log.tally()
    spatial = int(arrays["is_box_branch"].sum())
    eval_checks = {
        "one forward per batch, K2 3 and K1 2 launches per forward": (
            steps["forwards"] == len(batches) and per_forward_ok(steps, exe_cfg)
            and steps["K2"] == eval_counts["fused_encoder_block"]
            and steps["K1"] == eval_counts["fused_attention"]),
        "every step tallied: all target boxes, every token step": (
            sum(tally.box_gt.values()) == int(arrays["target_box_mask"].sum())
            and sum(tally.token_total.values()) == EVAL_STEPS - spatial),
    }
    say(f"phase 14 evaluate_executor_steps on {EVAL_STEPS} steps ({spatial} spatial) in "
        f"{len(batches)} batches: {eval_s:.3f} s, {steps['forwards']} forwards, launches "
        f"{eval_counts}; {sum(tally.box_pred.values())} boxes kept at 0.5 against "
        f"{sum(tally.box_gt.values())} targets, {sum(tally.box_tp.values())} true positives")
    for name, ok in eval_checks.items():
        if not ok:
            fail(f"evaluate_executor_steps check failed: {name}")

    # ---- run_tally with per-function calibration ----
    records, feats, fv, vv = synth_annotated(n, exe_cfg, seed=16)
    chains = chain_arrays(records, fv)
    gt_programs = postfix_ids(chains, gen_cfg.program_len, start=True).astype(np.int32)
    gt_answers = np.asarray([vv[canonicalize(r["answer"])] for r in records])
    image_tokens = torch.from_numpy(feats).to(dev)
    log = ForwardLaunches(executor)
    out, tally_counts = counted(lambda: run_tally(
        generator, executor, exe_cfg, questions, image_tokens, chains.image_index,
        dict(enumerate(PROGRAM_TOKENS)), fv, vv, gt_answers=gt_answers, programs=gt_programs,
        annotated=records, chain_mode="sorted", calibrate_conf_per_function=True, device=dev))
    log.remove()
    runs = []
    for run in out.runs:
        c = log.tally(run["start"], run["start"] + run["seconds"])
        runs.append(c)
        say(f"phase 14 run_tally run '{run['name']}': {run['seconds']:.3f} s, {c['forwards']} "
            f"executor forwards, K2 {c['K2']}, K1 {c['K1']} launches")
    thr_map = out.conf_threshold
    total = log.tally()
    tally_checks = {
        "three runs: the pipeline, the chains, the chains gated by the map": (
            [r["name"] for r in out.runs]
            == ["pipeline", "chains", "chains, per-function thresholds"]),
        "K2 3 and K1 2 launches per forward in each run, every forward in a run": (
            all(per_forward_ok(c, exe_cfg) for c in runs)
            and sum(c["forwards"] for c in runs) == total["forwards"]
            and total["K2"] == tally_counts["fused_encoder_block"]
            and total["K1"] == tally_counts["fused_attention"]),
        "a per-function map with its global fallback, from the grid": (
            isinstance(thr_map, dict) and "__global__" in thr_map
            and all(abs(v * 20 - round(v * 20)) < 1e-9 for v in thr_map.values())),
        "a per-step tally of every annotated function": (
            len(out.payload["per_function_box_pr"]) > 0
            and len(out.payload["per_function_token_acc"]) > 0
            and out.payload["truncated_gt_programs"] == 0),
        "answers and accuracy by type": (
            out.pipeline.answers.shape == (n,) and out.accuracy is not None
            and 0 <= out.accuracy["overall"] <= 1),
    }
    say(f"phase 14 run_tally on {n} synth_annotated questions ({int(chains.num_steps.sum())} "
        f"steps), sorted, per-function calibration: map "
        f"{ {k: round(v, 2) for k, v in sorted(thr_map.items())} }; launches {tally_counts}; "
        f"box P/R "
        + ", ".join(f"{fn} {pr['precision']:.2f}/{pr['recall']:.2f}"
                    for fn, pr in out.payload["per_function_box_pr"].items()))
    for name, ok in tally_checks.items():
        if not ok:
            fail(f"run_tally check failed: {name}")
    del executor, generator, features_dev, batches, image_tokens
    torch.cuda.empty_cache()

    # ---- float32, card against the CPU, with phase 12's trained executor ----
    t0 = time.perf_counter()
    trained_cfg, trained_state = trained
    exe32 = ProgramExecutor(trained_cfg, torch.float32, device=dev)
    exe32.load_state_dict(trained_state)
    cpu32 = copy.deepcopy(exe32).to("cpu")
    sub = records[:FP32_QUESTIONS]
    sub_chains = chain_arrays(sub, fv)

    def first_run(model, device, feats_t):
        run_out = run_chains(ExecutorChainRunner(model, trained_cfg, 28, device=device), feats_t,
                             sub_chains, "sorted")
        return run_out, calibrate_chain_conf_thresholds_per_function(run_out, sub, fv, vv)[0]

    card_out, card_map = first_run(exe32, dev, torch.from_numpy(feats).to(dev))
    cpu_out, cpu_map = first_run(cpu32, torch.device("cpu"), torch.from_numpy(feats))
    decisions = all(np.array_equal(card_out[k], cpu_out[k])
                    for k in ("box_mask", "token_branch", "token_cache"))
    box_err = max(float(np.abs(card_out[k] - cpu_out[k]).max()) for k in ("box_cache",
                                                                        "conf_cache"))
    conf = cpu_out["conf_cache"][cpu_out["conf_cache"] > 0]
    hits = [int(np.sum(_collect_chain_detections(o, sub, fv, vv, 0.5, 28)[1]))
            for o in (card_out, cpu_out)]
    moved = sorted(fn for fn, v in card_map.items() if abs(v - 0.05) > 1e-9)
    say(f"phase 14 fp32 tally with phase 12's trained executor: {hits[0]} true positives on "
        f"the card, {hits[1]} on the CPU (IoU 0.5, every chained box prediction); thresholds "
        f"off 0.05: {len(moved)} of {len(card_map)} ({', '.join(moved)})")
    if not hits[1]:
        fail("phase 14: the float32 tally has no true positive; its maps cannot tell a "
             "calibration from the grid's first threshold")
    say(f"phase 14 fp32 run_chains + per-function calibration on {FP32_QUESTIONS} questions "
        f"({int(sub_chains.num_steps.sum())} steps), card vs CPU: decisions "
        f"{'equal' if decisions else 'DIFFER'} ({int(card_out['box_mask'].sum())} confident "
        f"boxes, {int(card_out['token_branch'].sum())} token steps; the confidence nearest 0.5 "
        f"is {float(np.abs(conf - 0.5).min()):.2e} from it), boxes and confidences within "
        f"{box_err:.3g} (tol 1e-4); maps {'equal' if card_map == cpu_map else 'DIFFER'}: "
        f"{ {k: round(v, 2) for k, v in sorted(card_map.items())} }; {time.perf_counter() - t0:.1f} s")
    if not (decisions and box_err <= 1e-4):
        fail("the float32 chain run on the card disagrees with the CPU")
    if card_map != cpu_map:
        confs, _tps, fns, _gt = _collect_chain_detections(cpu_out, sub, fv, vv, 0.5, 28)
        confs, fns = np.asarray(confs), np.asarray(fns)
        for fn in sorted(set(card_map) | set(cpu_map)):
            if card_map.get(fn) == cpu_map.get(fn):
                continue
            pick = np.ones(len(fns), bool) if fn == "__global__" else fns == fn
            thresholds = np.asarray([t for t in (card_map.get(fn), cpu_map.get(fn)) if t])
            near = confs[pick][np.abs(confs[pick][:, None] - thresholds[None]).min(1) < 1e-4]
            say(f"phase 14 map entry {fn}: card {card_map.get(fn)}, CPU {cpu_map.get(fn)}; "
                f"confidences within 1e-4 of them: {near.tolist()}")
            if not len(near):
                fail(f"the threshold maps differ at {fn} with no confidence near the thresholds")
    say(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    del exe32, cpu32
    torch.cuda.empty_cache()
    return {"evaluate_executor_steps": eval_counts, "tally": tally_counts}


def scheduled_training(torch, np, dev, counted) -> dict:
    """Phase 15, chain-level scheduled sampling: the ``executor_scheduled``
    preset at full width, bf16, batch 16, ``max_steps`` 28, on
    ``synth_annotated``'s chain arrays (``executor_chain_step_arrays``):

    - ``Trainer.fit`` for one epoch on the batches of the ramp's last epoch
      (``p_sample`` = ``scheduled_p_max`` = 0.5), launches counted by mode;
    - one train step's launches: K2 3 and K1 2 per chained position, none in
      the loss pass (its forwards are in train mode);
    - the step's parts between CUDA events (the image projection, the
      chained pass with the mixture, the loss forward, backward, optimizer),
      the median over a few steps, the peak memory, and one profiled step;
    - after an optimizer step, the chained pass equal, bit for bit, to that
      of a fresh module loaded with the stepped weights;
    - a fixed batch's loss below 0.8 of its first within
      ``SCHEDULED_STEPS`` updates;
    - float32 (TF32 off), dropout 0, p=1: one step on the card against the
      CPU, the loss within 1e-6 relative and every gradient within 1e-5 of
      its tensor's max |g| (an attention key bias's, exactly zero, within
      1e-6 of the largest gradient).

    Returns the train step's launches, for the result line."""
    from explainable_spatial_vqa_tpu_torch.bench_data import synth_annotated
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.infer.chain import chained_forward
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.train.datasets import executor_chain_step_arrays
    from explainable_spatial_vqa_tpu_torch.train.pipelines import (
        executor_scheduled_pipeline_from_arrays,
    )
    from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device
    from explainable_spatial_vqa_tpu_torch.train.scheduled import (
        mixed_chain_state,
        scheduled_step_loss,
    )
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cfg = get_preset("executor_scheduled")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=1, log_every=0))
    mcfg = cfg.model
    records, feats, fv, vv = synth_annotated(SCHEDULED_QUESTIONS, mcfg, seed=18)
    arrays = executor_chain_step_arrays(records, fv, vv, max_steps=28,
                                        max_output_boxes=mcfg.num_queries)
    features = torch.from_numpy(feats).to(dev)
    ramped = mcfg.scheduled_ramp_epochs  # the epoch whose p is p_max

    def pipeline():
        return executor_scheduled_pipeline_from_arrays(cfg, arrays, features, device=dev)

    def trainer_of(pipe):
        return Trainer(pipe.loss_fn, pipe.model, cfg.optim, cfg.train, pipe.steps_per_epoch,
                       checkpoint_dir=False, device=dev)

    pipe = pipeline()
    model = pipe.model
    trainer = trainer_of(pipe)
    log = ForwardLaunches(model)
    t0 = time.perf_counter()
    history = trainer.fit(lambda _epoch: pipe.train_batches(ramped), pipe.val_batches,
                          pipe.monitor, num_epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    log.remove()
    train, val = history["train"][0], history["val"][0]
    in_train, in_eval = log.tally(training=True), log.tally(training=False)
    p = float(next(iter(pipe.train_batches(ramped)))["p_sample"])
    say(f"phase 15 scheduled training, Trainer.fit one epoch (executor_scheduled, d={mcfg.d_model}, "
        f"{mcfg.encoder_layers}+{mcfg.box_decoder_layers} layers, bf16, batch "
        f"{cfg.train.batch_size}, p_sample {p}, {len(arrays['num_steps'])} synth_annotated "
        f"questions, {int(arrays['step_valid'].sum())} steps): {fit_s:.2f} s for "
        f"{int(train['batches'])} train steps and {int(val['batches'])} validation batches; "
        f"train loss {train['loss_sum'] / train['batches']:.4f}, validation loss "
        f"{val['loss_sum'] / val['batches']:.4f}, routing accuracy "
        f"{val['routing_correct'] / val['routing_total']:.3f}; forwards and launches in train "
        f"mode {in_train}, in eval mode (chained passes, validation) {in_eval}")
    if not (p > 0 and in_train["forwards"] > 0 and in_train["K2"] == 0 and in_train["K1"] == 0
            and per_forward_ok(in_eval, mcfg)):
        fail("scheduled training check failed: p_sample > 0, no K1/K2 launch in train-mode "
             "forwards, 3 and 2 per eval-mode forward")

    # one train step's launches
    batch = to_device(next(iter(pipe.train_batches(ramped))), dev)
    depth = int(batch["num_steps"].max())
    gen = torch.Generator().manual_seed(1)
    log = ForwardLaunches(model)
    _, step_counts = counted(lambda: trainer.train_step(batch, gen))
    log.remove()
    chained, loss_pass = log.tally(training=False), log.tally(training=True)
    say(f"phase 15 one train step, batch {cfg.train.batch_size}, deepest chain {depth}: "
        f"chained pass {chained}, loss pass {loss_pass}; launches {step_counts}")
    if not (chained["forwards"] == depth and loss_pass["forwards"] == depth
            and step_counts["fused_encoder_block"] == mcfg.encoder_layers * depth
            and step_counts["fused_attention"] == mcfg.box_decoder_layers * depth
            and loss_pass["K2"] == 0 and loss_pass["K1"] == 0):
        fail("a scheduled train step's launches are not 3 K2 and 2 K1 per chained position, "
             "none in the loss pass")

    # the step's parts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(6)] for _ in range(4)]
    model.train()
    for ev in marks:
        ev[0].record()
        image = model.precompute_image(batch["image"])
        ev[1].record()
        state = mixed_chain_state(model, batch, image, mcfg, gen, depth)
        ev[2].record()
        loss, _ = scheduled_step_loss(model, batch, image, state, mcfg, gen, True, depth)
        ev[3].record()
        trainer.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[4].record()
        trainer.apply_gradients()
        ev[5].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def med(i, j):
        ms = sorted(e[i].elapsed_time(e[j]) for e in marks[1:])
        return ms[len(ms) // 2]

    say(f"phase 15 scheduled train step, batch {cfg.train.batch_size}, {depth} positions: "
        f"{med(0, 5):.1f} ms (median of 3 after a warm-up); parts: image projection "
        f"{med(0, 1):.2f} ms, chained pass with the mixture {med(1, 2):.1f} ms, loss forward "
        f"(with the matcher) {med(2, 3):.1f} ms, backward {med(3, 4):.1f} ms, optimizer "
        f"{med(4, 5):.2f} ms; peak memory {peak:.2f} GiB")
    if not math.isfinite(float(loss.detach())):
        fail("the scheduled loss is not finite")
    step_profile(torch, "phase 15 scheduled train step", lambda: trainer.train_step(batch, gen))

    # the chained pass after an optimizer step uses the stepped weights
    def chain(m):
        return chained_forward(m, batch["image"], batch["functions"], batch["deps"],
                               batch["num_steps"], mcfg, 28)

    before = chain(model)
    trainer.train_step(batch, gen)
    after = chain(model)
    fresh = ProgramExecutor(mcfg, model.dtype, device=dev)
    fresh.load_state_dict(model.state_dict())
    reference = chain(fresh)
    equal = all(torch.equal(a, b) for a, b in zip(after, reference))
    moved = not torch.equal(after.box_cache, before.box_cache)
    say(f"phase 15 chained pass after an optimizer step: {'equal' if equal else 'NOT EQUAL'} "
        f"to a fresh ProgramExecutor's loaded with the stepped state_dict, bit for bit "
        f"({'moved' if moved else 'did NOT move'} from the pass before the step)")
    if not (equal and moved):
        fail("the chained pass after an optimizer step does not use the stepped weights")
    del trainer, pipe, model, fresh, state, image, loss

    # a fixed batch's loss
    pipe = pipeline()
    trainer = trainer_of(pipe)
    losses = []
    while len(losses) <= SCHEDULED_STEPS:  # the same draws of the mixture each step
        losses.append(float(trainer.train_step(batch, torch.Generator().manual_seed(2))[
            "loss_sum"]))
        if losses[-1] < 0.8 * losses[0]:
            break
    say(f"phase 15 fixed-batch loss (batch {cfg.train.batch_size}, p_sample {p}, lr "
        f"{cfg.optim.learning_rate}): step 0 {losses[0]:.4f}, step {len(losses) - 1} "
        f"{losses[-1]:.4f} ({losses[-1] / losses[0]:.3f} of step 0, tol 0.8 within "
        f"{SCHEDULED_STEPS} updates)")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < 0.8 * losses[0]):
        fail(f"the scheduled fixed-batch loss did not fall below 0.8 of its first within "
             f"{SCHEDULED_STEPS} updates")
    del trainer, pipe, features
    torch.cuda.empty_cache()

    # float32, p=1, card against the CPU, in two parts.  The chained pass
    # (K2, K1): equal decisions, boxes and confidences within 1e-4.  The
    # loss pass and backward on the CPU's mixed caches, with the CPU's
    # branch decisions replayed: its matcher assignments (a near-tie in a
    # cost matrix sends a query's gradient to another target) and the side
    # each ReLU took (an input within a rounding of 0 flips its unit's
    # gradient); how many of the card's own decisions differ is printed.
    # Its own caches' ~1e-6 differences would move every loss-pass input,
    # and a gradient summed over 10^4 token positions with cancellation
    # would carry them far above the arithmetic's own differences.
    from explainable_spatial_vqa_tpu_torch.train import losses as losses_module

    cfg32 = cfg.replace(model=dataclasses.replace(mcfg, dropout=0.0),
                        train=dataclasses.replace(cfg.train, dtype="float32"))
    model = executor_scheduled_pipeline_from_arrays(cfg32, arrays, feats, device=dev).model
    rows = {k: v[:CARD_VS_CPU_ROWS] for k, v in arrays.items()}
    rows["image"] = feats[rows["image_index"]]
    rows["p_sample"] = np.float32(1.0)
    assign = losses_module.assign_targets
    recorded = {"assignments": [], "signs": [], "state": None}
    differs = {"assignments": [], "signs": 0}

    def relu_inputs(m):
        """The layers whose outputs go through a ReLU."""
        return [mod.fc1 for mod in m.modules() if type(mod).__name__ == "FeedForward"] + [
            m.box_mlp_1, m.box_decoder.head_hidden]

    def step(m, replay):
        device = next(m.parameters()).device
        assignments, signs = iter(recorded["assignments"]), iter(recorded["signs"])

        def assign_targets(cost, mask, config):
            got = assign(cost, mask, config)
            if not replay:
                recorded["assignments"].append(got.cpu())
                return got
            ref = next(assignments)
            differs["assignments"].append(not torch.equal(got.cpu(), ref))
            return ref.to(device)

        def relu_side(mod, _inputs, out):
            """In the loss pass: record each unit's side, or move the
            card's input by a hair onto the CPU's side."""
            if not mod.training:
                return None
            if not replay:
                recorded["signs"].append((out > 0).cpu())
                return None
            side = next(signs).to(device)
            other = side != (out > 0)
            differs["signs"] += int(other.sum())
            # a hair on the CPU's side, with the input's own gradient
            hair = out - out.detach() + torch.where(side, 1e-30, -1e-30)
            return torch.where(other, hair, out)

        losses_module.assign_targets = assign_targets
        hooks = [layer.register_forward_hook(relu_side) for layer in relu_inputs(m)]
        try:
            m.train()
            m.zero_grad(set_to_none=True)
            b = to_device(rows, device)
            depth_ = int(b["num_steps"].max())
            image_ = m.precompute_image(b["image"])
            state_ = mixed_chain_state(m, b, image_, cfg32.model, torch.Generator().manual_seed(3),
                                       depth_)
            own = [t.cpu() for t in state_]
            if replay:
                state_ = type(state_)(*(t.to(device) for t in recorded["state"]))
            else:
                recorded["state"] = own
            loss_, _ = scheduled_step_loss(m, b, image_, state_, cfg32.model,
                                           torch.Generator().manual_seed(3), True, depth_)
            loss_.backward()
        finally:
            losses_module.assign_targets = assign
            for hook in hooks:
                hook.remove()
        return (float(loss_.detach()), {n_: p_.grad.detach().cpu() for n_, p_ in
                                        m.named_parameters()}, own)

    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_loss, cpu_grads, cpu_state = step(cpu_model, replay=False)
    loss, grads, card_state = step(model, replay=True)
    decisions = all(torch.equal(a, b) for a, b in zip(card_state, cpu_state)
                    if a.dtype in (torch.bool, torch.int32))
    chain_err = max(float((a - b).abs().max()) for a, b in zip(card_state, cpu_state)
                    if a.dtype == torch.float32)
    largest = max(float(g.abs().max()) for g in cpu_grads.values())
    rels = {}
    for key, g in cpu_grads.items():
        if key.endswith(".k.bias"):
            ok = max(float(grads[key].abs().max()), float(g.abs().max())) <= 1e-6 * largest
            rels[key] = 0.0 if ok else math.inf
        else:
            rels[key] = float((grads[key] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
    top = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    worst = top[0][1]
    rel_loss = abs(loss - cpu_loss) / abs(cpu_loss)
    units = sum(int(t.numel()) for t in recorded["signs"])
    say(f"phase 15 fp32 scheduled train step at p=1 (batch {CARD_VS_CPU_ROWS}), card vs CPU: "
        f"chained pass: decisions {'equal' if decisions else 'DIFFER'}, boxes and confidences "
        f"within {chain_err:.3g} (tol 1e-4); on the CPU's caches, the card's own decisions "
        f"that differed and were replayed from the CPU: matcher assignments at "
        f"{sum(differs['assignments'])} of {len(differs['assignments'])} positions, ReLU sides "
        f"of {differs['signs']} of {units} units; loss {loss:.6f} vs {cpu_loss:.6f} "
        f"({rel_loss:.2e} relative, tol 1e-6); largest gradient differences, of each tensor's "
        f"max |g| (tol 1e-5): " + ", ".join(f"{k} {v:.2e}" for k, v in top)
        + f" over {len(grads)} tensors; phase 15 took {time.perf_counter() - t_phase:.1f} s")
    if not (decisions and chain_err <= 1e-4 and rel_loss <= 1e-6 and worst <= 1e-5):
        fail("the float32 scheduled train step on the card disagrees with the CPU")
    return {"scheduled_train_step": step_counts}


K1_AB_ROUNDS = 3  # alternating rounds of phases 16-17's K1-on/off timings


def k1_on_off(torch, label: str, fn, profile: bool = False) -> None:
    """``fn()`` with the models' K1 routing on and off, in ``K1_AB_ROUNDS``
    rounds that alternate which goes first, after a warm-up of each: off,
    ``models.layers``' K1 gate refuses every head dim, so each call K1 would
    take runs the plain path, as before K1 took the head dims 24, 48 and 64.
    Host-clock ms after a synchronize; medians, the pairs K1 won and every
    round.  With ``profile``, one run of each under torch.profiler: the
    device's busy share and time, and K1's.  The launches of these runs are
    not put down to the phase's tallies."""
    from explainable_spatial_vqa_tpu_torch.models import layers

    gate, pending = layers.head_dim_built, {k: t["pending"] for k, t in TALLIES.items()}
    times, profiles = {True: [], False: []}, {}

    def run(on):
        layers.head_dim_built = gate if on else (lambda d_model, num_heads: False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    try:
        for on in (True, False):
            run(on)
        for r in range(K1_AB_ROUNDS):
            for on in ((True, False) if r % 2 == 0 else (False, True)):
                times[on].append(run(on))
        for on in (True, False) if profile else ():
            layers.head_dim_built = gate if on else (lambda d_model, num_heads: False)
            profiles[on] = device_profile(torch, fn)
    finally:
        layers.head_dim_built = gate
        for kind, tally in TALLIES.items():
            tally["pending"] = pending.get(kind, 0)
    on, off = statistics.median(times[True]), statistics.median(times[False])
    won = sum(a < b for a, b in zip(times[True], times[False]))
    text = (f"{label}, K1 on / off (the plain path): {on:.2f} / {off:.2f} ms (medians of "
            f"{K1_AB_ROUNDS} alternating rounds; K1 faster in {won} of {K1_AB_ROUNDS} pairs; "
            f"on {', '.join(f'{t:.2f}' for t in times[True])}; off "
            f"{', '.join(f'{t:.2f}' for t in times[False])})")
    for on, (wall, prof) in profiles.items():
        if prof is None:
            text += f"; profiled K1 {'on' if on else 'off'}: device time not measured"
            continue
        busy, top, _, kernels = prof
        k1 = sum(ms for name, ms in top if "attention_kernel" in name)
        text += (f"; profiled K1 {'on' if on else 'off'}: {wall * 1e3:.1f} ms, busy {busy:.3f}, "
                 f"{sum(ms for _, ms in top):.2f} ms of {kernels} kernels and copies, K1 "
                 f"{k1:.2f} ms; by device time: "
                 + ", ".join(f"{name[:48]} {ms:.2f}" for name, ms in top[:4]))
    say(text)


def protocol_card_vs_cpu(torch, np, evaluated: dict, label: str, phase: int = 16) -> None:
    """Phase 16's float32 check of a protocol run's final models: the
    recorded ``evaluate_pipeline_synthetic`` call (valA after the fine-tune)
    again on the card and on deep copies of the models on the CPU (the plain
    path).  The generated programs, answers, tally and accuracy by type
    must be equal; a program that differs must come from a near-tie of the
    generator's logits (within 1e-4 at the first differing token, printed),
    and then the answers are compared on the rest.  Fails otherwise."""
    from explainable_spatial_vqa_tpu_torch.core.artifacts import encode_questions
    from explainable_spatial_vqa_tpu_torch.infer import pipeline as pipeline_mod
    from explainable_spatial_vqa_tpu_torch.train import synthetic_protocol as sp

    t0 = time.perf_counter()
    generator, executor, exe_cfg, questions, features = evaluated["args"][:5]
    rest = evaluated["args"][5:]
    runs = []  # the card's pipeline result, then the CPU's

    class Recorded(pipeline_mod.InferencePipeline):
        def run(self, *args, **kwargs):
            out = super().run(*args, **kwargs)
            runs.append(out)
            return out

    real = sp.InferencePipeline
    sp.InferencePipeline = Recorded
    try:
        card = sp.evaluate_pipeline_synthetic(generator, executor, exe_cfg, questions,
                                              features, *rest, **evaluated["kwargs"])
        cpu_kwargs = dict(evaluated["kwargs"], device="cpu")
        cpu_gen, cpu_exe = copy.deepcopy(generator).to("cpu"), copy.deepcopy(executor).to("cpu")
        cpu = sp.evaluate_pipeline_synthetic(cpu_gen, cpu_exe, exe_cfg, questions,
                                             features.cpu(), *rest, **cpu_kwargs)
    finally:
        sp.InferencePipeline = real
    card_run, cpu_run = runs
    differ = np.flatnonzero((card_run.program_ids != cpu_run.program_ids).any(1))
    encoded = encode_questions(questions, rest[0]).questions
    margins = []
    for i in differ:
        t = int(np.flatnonzero(card_run.program_ids[i] != cpu_run.program_ids[i])[0])
        q = torch.as_tensor(encoded[i:i + 1])
        with torch.no_grad():
            logits = cpu_gen.eval()(q, torch.as_tensor(cpu_run.program_ids[i:i + 1]),
                                    teacher_forcing=1.0)["logits"][0, t]
        margins.append(float(logits[cpu_run.program_ids[i, t]]
                             - logits[card_run.program_ids[i, t]]))
    same = np.ones(len(questions), bool)
    same[differ] = False
    answers_equal = (np.array_equal(card_run.answers[same], cpu_run.answers[same])
                     and np.array_equal(card_run.answer_valid[same], cpu_run.answer_valid[same]))
    whole = len(differ) == 0
    tally_equal = dataclasses.asdict(card[0]) == dataclasses.asdict(cpu[0])
    say(f"phase {phase} {label}: fp32 evaluate_pipeline_synthetic on valA ({len(questions)} "
        f"questions), card vs CPU: programs {'equal' if whole else f'differ at {len(differ)}'}"
        + (f" (logit margins at the first differing token {margins})" if margins else "")
        + f"; answers {'equal' if answers_equal else 'DIFFER'}"
        f"{'' if whole else ' on the questions whose programs agree'}; tally "
        f"{'equal' if tally_equal else 'differs'} ({card[0]} vs {cpu[0]}); accuracy by type "
        f"{'equal' if card[1] == cpu[1] else 'differs'}; {time.perf_counter() - t0:.1f} s")
    if not answers_equal or any(abs(m) > 1e-4 for m in margins):
        fail(f"phase {phase} {label}: the float32 evaluation on the card disagrees with the CPU")
    if whole and not (tally_equal and card[1] == cpu[1]):
        fail(f"phase {phase} {label}: the float32 tally or accuracy on the card differs from "
             f"the CPU's")


def head_dim_routing(torch, dev, counted) -> None:
    """Phase 16.1: eval forwards of the protocol's executor
    (``make_protocol_executor_config``, 4 heads, 2 fusion layers,
    ``box_roi``) at d_model 4 D for every K1 head dim D with kernels of its
    own and those of ``K1_ROUTING_PADDED``, in float32 and bf16: K1 once per
    fusion and box-decoder layer and no K2, but at head dims 128 and 256 K2
    once per fusion layer and K1 once (the wrappers' counts, and
    ``attention_kernel`` in a ``torch.profiler`` trace); the C libraries'
    counts name the kernel functions, the padded ones at every head dim
    without kernels of its own; outputs finite."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.ops import fused_block
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
        EXACT_HEAD_DIMS,
        kernel_launches,
    )
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import block_head_dim_built
    from explainable_spatial_vqa_tpu_torch.train import synthetic_protocol as sp

    t0 = time.perf_counter()
    vocabs = {"function": {f"f{i}": i for i in range(40)},
              "other": {f"o{i}": i for i in range(30)}}
    gen = torch.Generator(device=dev).manual_seed(160)
    batch = 64
    corner = torch.rand(batch, 8, 2, generator=gen, device=dev) * 0.5
    inputs = (torch.randn(batch, 196, 64, generator=gen, device=dev),
              torch.cat([corner, corner + 0.4], -1),
              torch.rand(batch, 8, generator=gen, device=dev) < 0.6,
              torch.randint(1, 40, (batch, 3), generator=gen, device=dev),
              torch.ones(batch, 3, dtype=torch.bool, device=dev))
    routing = {}
    # every K1 head dim with kernels of its own and the padded ones of
    # K1_ROUTING_PADDED, 4 heads; K2 at 512 and 1024
    for d_model in [4 * d for d in EXACT_HEAD_DIMS + K1_ROUTING_PADDED]:
        for dtype in (torch.float32, torch.bfloat16):
            cfg = sp.make_protocol_executor_config(vocabs, d_model=d_model, encoder_layers=2,
                                                   box_roi=True)
            layers_per_forward = (cfg.encoder_layers, cfg.box_decoder_layers)
            model = init_parameters(ProgramExecutor(cfg, dtype, dev), seed=d_model).eval()

            def forward():
                with torch.no_grad():
                    return model(*inputs)

            before = (kernel_launches(), fused_block.kernel_launches())
            out, counts = counted(forward)
            ran = [{n: c - was[n] for n, c in now.items() if c != was[n]}
                   for was, now in zip(before, (kernel_launches(), fused_block.kernel_launches()))]
            for attempt in range(1, PROFILE_TRIES + 1):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    forward()
                    torch.cuda.synchronize()
                names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
                if any("attention_kernel" in n for n in names):
                    break
                # CUPTI returns no device activity now and then in a run of
                # many profiles, or some of it (a float32 forward's trace
                # once held none of its three K1 launches): take it again,
                # and say so
                say(f"phase 16 routing: torch.profiler saw {len(names)} kernels and no "
                    f"attention kernel in profile {attempt} of {PROFILE_TRIES} at d_model "
                    f"{d_model}")
            ours = sorted({n[:40] for n in names if any(k in n for k in OUR_KERNELS)})
            finite = all(bool(torch.isfinite(v.float()).all()) for v in out.values())
            key = f"d{d_model} {str(dtype).split('.')[-1]}"
            routing[key] = (counts, ours, finite, ran)
            say(f"phase 16 routing: eval forward, d_model {d_model} (head dim {d_model // 4}), "
                f"{key.split()[1]}, batch {batch}: K2 {counts['fused_encoder_block']}, K1 "
                f"{counts['fused_attention']} launches; our kernels in its trace: "
                f"{ours or 'none'}; the C libraries' counts: K1 {ran[0]}, K2's attention "
                f"{ran[1]}; outputs {'finite' if finite else 'NOT FINITE'}")
            del model
    fusion, box_decoder = layers_per_forward
    for key, (counts, ours, finite, ran) in routing.items():
        # K2 on every fusion layer at head dims 128 and 256, else K1 in each
        # plain block; K1 on each box-decoder layer's query self-attention;
        # each K1 launch on the kernel the mirror names for the fusion
        # encoder's 208 keys and the box decoder's 8 (where the head dim has
        # no kernels of its own: bf16 at 136 and 192 on attention_kernel_wgmma,
        # float32 there on attention_kernel_wide_f32, the rest on the padded
        # kernels), K2's attention at 256 (float32
        # q/k/v in both types, past 16 keys) on attention_kernel_split_f32
        d_model, name = int(key.split()[0][1:]), "bf16" if key.endswith("bfloat16") else "fp32"
        k2 = block_head_dim_built(d_model, 4)
        want = (fusion, box_decoder) if k2 else (0, fusion + box_decoder)
        got = (counts["fused_encoder_block"], counts["fused_attention"])
        exact = d_model // 4 in EXACT_HEAD_DIMS
        by_kernel = {}
        for length, calls in ((208, want[1] - box_decoder), (8, box_decoder)):
            kernel = k1_kernel(d_model // 4, length, name)
            by_kernel[kernel] = by_kernel.get(kernel, 0) + calls
        if (got != want or not any("attention_kernel" in n for n in ours)
                or not finite or sum(ran[0].values()) != got[1]
                or ran[0] != {n: c for n, c in by_kernel.items() if c}
                or (not exact and k2 and ran[1] != {SPLIT_F32: got[0]})):
            fail(f"phase 16 routing check failed at {key}: K2/K1 launches {got}, expected "
                 f"{want}; kernels in the trace {ours}; the C libraries' counts {ran}")
    say(f"phase 16.1 routing at {len(routing)} widths and types took "
        f"{time.perf_counter() - t0:.1f} s")


def cogent(torch, np, dev, counted) -> dict:
    """Phase 16, the CoGenT A->B protocol (thesis §4.2.2, Table 4.6) through
    ``evalsuite.cogent.run_cogent_protocol``, float32 as the JAX package
    trains it (TF32 off):

    1. the routing on the card at every K1 head dim
       (:func:`head_dim_routing`);
    2. the protocol at its flagship width (``COGENT_FLAGSHIP``: d_model 192,
       3 fusion layers, ``box_roi``, cosine) at the CLI's sizes (80 A
       scenes, 20 per val, a pool of 40 B scenes, 6 questions each) with
       an eighth of its steps (50 generator, 63 executor and 20 fine-tune
       steps of the CLI's 400, 500 and 150), recorded by
       ``bench_cogent.ProtocolParts``: the wall time of each part (the card
       synchronized only at each part's start and end), the median ms per
       generator and executor train step (CUDA events between optimizer
       steps), the four cells, accuracy by type and the sizes, K1's
       launches per part; every cell in [0, 1], every tally over the val
       questions, the executor's last A-phase loss below its first (the
       first step's loss, from the same call cut to one step), K1 launched
       in the evaluations (float32, head dim 48) and nowhere else, K2 never;
    3. those fine-tuned models on the CPU (:func:`protocol_card_vs_cpu`):
       valA, card (K1 at head dim 48) against CPU, equal; that evaluation
       timed with K1 on and off and profiled (:func:`k1_on_off`);
    4. the kernel path: the protocol at d_model 512 (``COGENT_KERNEL_PATH``,
       fewer steps), whose evaluations launch K2 (float32, L=208) and K1
       (float32, the box decoder's 8 queries), each counted and printed,
       its four cells, and its fine-tuned models on valA against the CPU as
       in 3, which holds K2 and K1 against the plain path at exactly these
       shapes.

    Returns the launches of phase 16's two protocol runs, for the result
    line."""
    from explainable_spatial_vqa_tpu_torch.bench_cogent import ProtocolParts, part_rows
    from explainable_spatial_vqa_tpu_torch.evalsuite.cogent import run_cogent_protocol
    from explainable_spatial_vqa_tpu_torch.train import synthetic_protocol as sp

    t_phase = time.perf_counter()

    # ---- 16.1 routing by head dim ----
    head_dim_routing(torch, dev, counted)

    # ---- 16.2 the protocol at the flagship width ----
    t0 = time.perf_counter()
    with ProtocolParts() as parts:
        result, flagship_counts = counted(lambda: run_cogent_protocol(**COGENT_FLAGSHIP,
                                                                      device=dev))
    wall = time.perf_counter() - t0
    report, sizes = result["report"], result["sizes"]
    rows = part_rows(parts)
    exes = parts.of("train_executor_synthetic")
    say(f"phase 16 CoGenT protocol, flagship width ({COGENT_FLAGSHIP}), float32, at the CLI's "
        f"sizes (80 A scenes, 20 per val, 40 B-pool scenes, 6 questions each; steps cut from "
        f"the CLI's 400/500/150): {wall:.1f} s; sizes {sizes}")
    say(f"phase 16 {report.report()}")
    for row, call in zip(rows, parts.calls):
        if row["steps"]:
            say(f"phase 16 part {row['part']}: {row['seconds']:.2f} s, {row['steps']} steps, "
                f"median {row['median_step_ms']:.2f} ms a step, last loss "
                f"{call['result'][2]:.4f}, K1 {row['K1']} launches")
        else:
            say(f"phase 16 part {row['part']}: {row['seconds']:.2f} s, K2 {row['K2']}, K1 "
                f"{row['K1']} launches; {call['result'][0]}")
    say(f"phase 16 {'cell':<24}{'overall':>9}{'count':>9}{'exist':>9}{'cmp_num':>9}"
        f"{'cmp_attr':>9}{'query':>9}")
    for cell, acc in result["by_type"].items():
        say(f"phase 16 {cell:<24}" + "".join(
            f"{acc[k]:>9.3f}" for k in ("overall", "count", "exist", "compare_number",
                                        "compare_attribute", "query_attribute")))
    first_call = exes[0]
    first_kwargs = dict(first_call["kwargs"], steps=1, lr_schedule="constant")
    first_loss = parts.originals["train_executor_synthetic"](*first_call["args"],
                                                            **first_kwargs)[2]
    last_loss = first_call["result"][2]
    say(f"phase 16 executor loss on A: first step {first_loss:.4f}, last step {last_loss:.4f}")
    flagship_checks = {
        "every cell in [0, 1]": all(v is not None and 0.0 <= v <= 1.0
                                    for v in report.as_dict().values()),
        "each tally over the val questions": all(
            t.total == sizes["val_questions"] for t in result["tallies"].values()),
        "the executor's last loss below its first": last_loss < first_loss,
        "K1 in the evaluations and only there, at head dim 48, and no K2": (
            all(r["K1"] > 0 for r in rows if r["part"].startswith("evaluation"))
            and flagship_counts["fused_attention"] == sum(r["K1"] for r in rows)
            and not any(r["K1"] for r in rows if not r["part"].startswith("evaluation"))
            and not flagship_counts["fused_encoder_block"]
            and not flagship_counts["fused_encoder_block_tiled"]),
    }
    for name, ok in flagship_checks.items():
        if not ok:
            fail(f"phase 16 check failed: {name}")

    # ---- 16.3 float32, card against the CPU, on valA ----
    protocol_card_vs_cpu(torch, np, parts.of("evaluate_pipeline_synthetic")[2],
                         "flagship (d_model 192, K1 at head dim 48)")
    evaluated = parts.of("evaluate_pipeline_synthetic")[2]
    k1_on_off(torch, "phase 16 flagship evaluate_pipeline_synthetic on valA (float32, d 192)",
              lambda: sp.evaluate_pipeline_synthetic(*evaluated["args"], **evaluated["kwargs"]),
              profile=True)
    del result, parts, evaluated
    torch.cuda.empty_cache()

    # ---- 16.4 the kernel path: head dim 128 ----
    t0 = time.perf_counter()
    with ProtocolParts() as parts:
        result, kernel_counts = counted(lambda: run_cogent_protocol(**COGENT_KERNEL_PATH,
                                                                    device=dev))
    rows = [r for r in part_rows(parts) if r["part"].startswith("evaluation")]
    say(f"phase 16 CoGenT protocol, kernel path ({COGENT_KERNEL_PATH}; steps cut from the "
        f"CLI's 400/500/150), float32: {time.perf_counter() - t0:.1f} s; "
        f"{result['report'].report()}; launches over the run {kernel_counts}; per evaluation "
        + ", ".join(f"{r['part'].split()[1]} K2 {r['K2']} K1 {r['K1']}" for r in rows))
    if not (all(r["K2"] > 0 and r["K1"] > 0 for r in rows)
            and kernel_counts["fused_encoder_block"] == sum(r["K2"] for r in rows)
            and kernel_counts["fused_attention"] == sum(r["K1"] for r in rows)
            and all(0.0 <= v <= 1.0 for v in result["report"].as_dict().values())):
        fail("phase 16 check failed: the d_model 512 protocol's evaluations launch K2 and K1, "
             "and only they")
    protocol_card_vs_cpu(torch, np, parts.of("evaluate_pipeline_synthetic")[2],
                         "kernel path (d_model 512, K2 and K1)")
    say(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {"cogent_protocol_d192": flagship_counts, "cogent_protocol_d512": kernel_counts}


# ---------------------------------------------------------------------------
# phase 17: the baselines
# ---------------------------------------------------------------------------


def baseline_data(torch, np, dev) -> dict:
    """Phase 17's inputs from the CLEVR factory: ``BASELINE_SCENES`` scenes
    with 4 questions each (hops and chains on), encoded to 46-token
    questions and 27-token postfix programs for the IQAP; the same questions
    annotated in the "full" style, in the joint vocabulary, as chains (the
    CLI's identity function ids) for ``infer-chain`` and as
    ``flatten_steps``' records for the step seq2seq's training; seeded
    random ``BASELINE_IMAGE`` (196 x 1024) features per image, on the card."""
    from explainable_spatial_vqa_tpu_torch.clevr import annotate as ann
    from explainable_spatial_vqa_tpu_torch.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu_torch.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu_torch.cli.main import identity_function_vocab
    from explainable_spatial_vqa_tpu_torch.core import vocab as voc
    from explainable_spatial_vqa_tpu_torch.core.artifacts import encode_questions
    from explainable_spatial_vqa_tpu_torch.train.datasets import chain_arrays, flatten_steps

    def width(a, n):
        out = np.zeros((len(a), n), np.int64)
        out[:, :min(n, a.shape[1])] = a[:, :n]
        return out

    scenes_raw, questions = syn.synthesize_dataset(BASELINE_SCENES, 4, seed=17, hop_prob=0.5,
                                                   chain_prob=0.5)
    enc = encode_questions(questions, voc.build_clevr_vocab([questions]))
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    annotated = [ann.annotate_question_full(q, scenes[q["image_index"]]) for q in questions]
    joint = voc.build_joint_vocab(annotated)
    annotated = [voc.apply_joint_vocab(q, joint) for q in annotated]
    gen = torch.Generator(device=dev).manual_seed(17)
    return dict(
        questions=width(enc.questions, 46), programs=width(enc.programs, 27),
        answers=np.asarray(enc.answers), image_index=np.asarray(enc.image_idxs),
        annotated=annotated, joint_size=len(joint) + 3,
        chains=chain_arrays(annotated, identity_function_vocab(annotated), max_steps=28),
        steps=flatten_steps(annotated),
        features=torch.rand(len(scenes_raw), *BASELINE_IMAGE, generator=gen, device=dev))


def encoder_blocks_agreement(torch, counted, encoder, run):
    """``counted(run)``, with each of ``encoder``'s blocks' bf16 outputs on
    the card (K2) held against K2's plain version on the block's own input
    and key mask, under phase 3's rule (printed) and under it with the rms
    rounded to bf16 (which decides: the block ends in a unit-scale
    LayerNorm, see ``bf16_agreement``); beside them, the plain version on
    the card against the plain version on the CPU, which sums in another
    order.  Returns ((run's value, launches), a text per block, whether
    every block agrees)."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
        fuse_encoder_params,
        fused_encoder_block_plain,
    )

    seen = []
    hooks = [b.register_forward_hook(lambda m, args, out: seen.append((m, args, out)))
             for b in encoder.blocks]
    try:
        result = counted(run)
    finally:
        for h in hooks:
            h.remove()
    texts, ok = [], True
    for i, (block, args, out) in enumerate(seen):
        x, mask = args[0], args[1] if len(args) > 1 else None
        key_mask = None if mask is None else mask[:, 0, 0, :]
        x = x.to(block.dtype).contiguous()
        weights = fuse_encoder_params(block, dtype=block.dtype)
        ref = fused_encoder_block_plain(x, key_mask, weights, block.num_heads)
        on_cpu = fused_encoder_block_plain(
            x.cpu(), None if key_mask is None else key_mask.cpu(),
            type(weights)(*(t.cpu() for t in weights)), block.num_heads)
        rule = bf16_agreement(torch, out, ref)
        stats = bf16_agreement(torch, out, ref, rms_rounded=True)
        control = bf16_agreement(torch, ref, on_cpu.to(ref.device))
        ok = ok and bf16_ok(stats)
        texts.append(f"block {i}: phase 3's rule {bf16_text(rule)}, {rule['outside']} "
                     f"elements outside; with the rms rounded to bf16 {bf16_text(stats)}, "
                     f"{stats['outside']} outside; plain card vs CPU "
                     f"{bf16_text(control)}, {control['outside']} outside")
    return result, texts, ok


def decision_gaps(np, card_tokens, cpu_tokens, cpu_logits) -> list:
    """For each row whose greedy tokens (B, T) differ between card and CPU,
    the CPU logits' top-2 gap at its first differing step: the step before
    which both saw the same inputs, up to rounding."""
    gaps = []
    for row in np.flatnonzero((card_tokens != cpu_tokens).any(-1)):
        t = int(np.flatnonzero(card_tokens[row] != cpu_tokens[row])[0])
        top = np.sort(cpu_logits[row, t])[-2:]
        gaps.append(float(top[1] - top[0]))
    return gaps


def chain_gaps(np, a_out: dict, b_out: dict, logits: list, steps: int) -> list:
    """For each chain whose step outputs differ between two chain runs, the
    top-2 gap of run a's logits at the origin of the difference: the first
    differing (position k, token t) in order (a position reads only earlier
    ones), which was decode call k * ``steps`` + t of run a."""
    gaps = []
    diff = a_out["step_outputs"] != b_out["step_outputs"]
    for row in np.flatnonzero(diff.any((1, 2))):
        k, t = (int(i[0]) for i in np.nonzero(diff[row]))
        top = np.sort(logits[k * steps + t][row])[-2:]
        gaps.append(float(top[1] - top[0]))
    return gaps


class LogitsRecorder:
    """A forward hook on a model's output layer keeping each call's float32
    logits on the host, in call order."""

    def __init__(self, layer):
        self.calls = []
        self._hook = layer.register_forward_hook(
            lambda _m, _i, out: self.calls.append(out.detach().float().reshape(
                out.shape[0], -1).cpu().numpy()))

    def remove(self):
        self._hook.remove()


def baselines(torch, np, dev, counted) -> dict:
    """Phase 17, the baselines (thesis Table 4.2's Transformer IQAP, the
    step seq2seq of ``infer-chain``, the LSTM IQAP) at their presets'
    widths, random weights from seeds, on ``baseline_data``:

    1. ``eval-iqap``'s path: ``cli.main.run_eval_iqap`` with
       ``transformer_iqap`` (d 256, 4 heads, 2+2 layers) in bf16 and float32
       on all questions, its encoder's self-attention on K1 (head dim 64,
       once per layer) and nothing else of ours, the encode+answer and the
       whole run also timed with K1 on and off (:func:`k1_on_off`):
       questions/s (the median of ``BASELINE_REPEATS`` after a
       warm-up), encode+answer and the 27-step greedy decode timed apart by
       CUDA events, the kernels and copies of one decode, the card's busy
       share of a run under the profiler;
    2. float32 on ``BASELINE_FP32`` questions, card against the CPU: answers
       and programs equal (a row that differs must come from a near-tie,
       within ``NEAR_TIE`` at its first differing step, printed), the
       largest logit error within 1e-4;
    3. ``infer-chain``'s path: ``step_seq2seq`` (d 256) in bf16 on every
       question's chain through ``Seq2SeqChainRunner.run`` and
       ``run_bucketed_seq2seq``, K1 once per encoder layer of each encode and
       nothing else, the run also with K1 on and off: chains/s each (median of ``BASELINE_REPEATS``), the
       encodes and decode steps of a run, the share of chains whose outputs
       the two agree on; in float32 on ``BASELINE_FP32`` chains the two runs
       equal on the card, and the card equal to the CPU (a chain that
       differs must trace to a near-tie);
    4. K2 on this path: both models at d 512, 4 heads, ffn 2048: K2 once per
       encoder layer per encode (the wrappers' counts; the phase fails on
       none), each block's bf16 output against K2's plain version on the
       same input under phase 3's rule, the float32 decisions card against
       CPU (``BASELINE_FP32`` questions, ``BASELINE_D512_CHAINS`` chains);
       the launches of ``run_eval_iqap`` on every question and of a chain
       run of the first 128 chains (the result line's ``eval_iqap_d512`` and
       ``infer_chain_d512``);
    5. one train step of ``transformer_iqap`` (batch 64, its greedy decode
       inside the loss), ``lstm_iqap`` (batch 64, a 200,704 x 512
       ``image_fc``) and ``step_seq2seq`` (batch 32) in bf16 through their
       ``*_pipeline_from_arrays`` and ``Trainer.train_step`` on one fixed
       batch: ms per step (the median of CUDA events over the updates after
       3), peak GiB, kernels and copies per step under the profiler; the
       batch's loss must fall below 0.8 of its first within
       ``BASELINE_UPDATES`` updates.

    Returns the launches of the d 512 paths, for the result line."""
    from explainable_spatial_vqa_tpu_torch.cli.main import run_eval_iqap
    from explainable_spatial_vqa_tpu_torch.core.config import IQAPConfig, StepSeq2SeqConfig
    from explainable_spatial_vqa_tpu_torch.infer.chain import (
        Seq2SeqChainRunner,
        run_bucketed_seq2seq,
    )
    from explainable_spatial_vqa_tpu_torch.models.iqap import TransformerIQAP, generate_programs
    from explainable_spatial_vqa_tpu_torch.models.layers import eval_mode, init_parameters
    from explainable_spatial_vqa_tpu_torch.models.step_executor import StepExecutorSeq2Seq

    t_phase = time.perf_counter()
    data = baseline_data(torch, np, dev)
    questions, programs, answers = data["questions"], data["programs"], data["answers"]
    chains, features = data["chains"], data["features"]
    n = len(questions)
    say(f"phase 17 data: {n} questions of {BASELINE_SCENES} CLEVR factory scenes (46-token "
        f"questions, 27-token programs); {len(chains.num_steps)} chains, depth "
        f"{int(chains.num_steps.min())}-{int(chains.num_steps.max())} (mean "
        f"{float(chains.num_steps.mean()):.2f}, {chains.truncated} cut at 28); "
        f"{len(data['steps']['src'])} seq2seq step records; joint vocabulary "
        f"{data['joint_size']} ids; {time.perf_counter() - t_phase:.1f} s")
    tokens, width = BASELINE_IMAGE
    iqap_cfg = IQAPConfig(vocab_size=max(96, int(questions.max()) + 1),
                          program_vocab_size=max(45, int(programs.max()) + 1),
                          num_answer_classes=max(32, int(answers.max()) + 1),
                          num_image_tokens=tokens, image_feature_dim=width)
    seq_cfg = StepSeq2SeqConfig(vocab_size=max(128, data["joint_size"]),
                                num_image_tokens=tokens, image_feature_dim=width)
    iqap_len = 1 + tokens + iqap_cfg.max_question_len
    q_dev = torch.from_numpy(questions).to(dev)
    images = features.index_select(0, torch.as_tensor(data["image_index"], device=dev))
    chain_tokens = features.index_select(0, torch.as_tensor(chains.image_index, device=dev))
    by_path = {}

    def median_s(fn):
        fn()  # warm-up
        seconds = []
        for _ in range(BASELINE_REPEATS):
            t0 = time.perf_counter()
            fn()
            seconds.append(time.perf_counter() - t0)
        return statistics.median(seconds)

    def iqap_decisions(model_card, rows, label):
        """Float32 answers and greedy programs of ``rows`` questions, card
        against a CPU copy of ``model_card``."""
        cpu = TransformerIQAP(model_card.config, torch.float32, "cpu")
        cpu.load_state_dict(model_card.state_dict())
        outs = []
        for model, device in ((model_card, dev), (cpu, torch.device("cpu"))):
            with torch.no_grad(), eval_mode(model):
                out = model(images[:rows].to(device), q_dev[:rows].to(device))
                tokens, logits = generate_programs(model, out["memory"])
            outs.append((out["answer_logits"].cpu().numpy(), tokens.cpu().numpy(),
                         logits.cpu().numpy()))
        (a_card, t_card, l_card), (a_cpu, t_cpu, l_cpu) = outs
        answer_gaps = decision_gaps(np, a_card.argmax(-1)[:, None], a_cpu.argmax(-1)[:, None],
                                    a_cpu[:, None])
        gaps = decision_gaps(np, t_card, t_cpu, l_cpu)
        same = ~(t_card != t_cpu).any(-1)
        err = max(float(np.abs(a_card - a_cpu).max()),
                  float(np.abs(l_card[same] - l_cpu[same]).max()) if same.any() else 0.0)
        say(f"phase 17 {label}: float32 on {rows} questions, card vs CPU: answers "
            f"{'equal' if not answer_gaps else f'differ at {len(answer_gaps)} (gaps {answer_gaps})'}"
            f"; programs {'equal' if not gaps else f'differ at {len(gaps)} (near-ties, top-2 gaps {gaps})'}"
            f"; max logit error {err:.3g} (tol 1e-4; over the rows that agree)")
        if err > 1e-4 or any(g > NEAR_TIE for g in answer_gaps + gaps):
            fail(f"phase 17 {label}: the float32 IQAP on the card disagrees with the CPU")

    # ---- 17.1 eval-iqap, preset width ----
    fp32_iqap = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        model = init_parameters(TransformerIQAP(iqap_cfg, dtype, dev), seed=171)

        def run():
            return run_eval_iqap(model, questions, features, data["image_index"], answers,
                                 programs, device=dev)

        seconds = median_s(run)
        (summary, pred_answers, pred_programs), counts = counted(run)
        split = []
        with torch.no_grad(), eval_mode(model):
            for _ in range(BASELINE_REPEATS):
                marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                marks[0].record()
                out = model(images, q_dev)
                torch.argmax(out["answer_logits"], -1)
                marks[1].record()
                generate_programs(model, out["memory"])
                marks[2].record()
                marks[2].synchronize()
                split.append((marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])))
            _, decode_prof = device_profile(torch, lambda: generate_programs(model,
                                                                             out["memory"]))
        _, run_prof = device_profile(torch, run)
        enc_ms = statistics.median(s[0] for s in split)
        dec_ms = statistics.median(s[1] for s in split)
        per_step = ("not measured" if decode_prof is None
                    else f"{decode_prof[3] / iqap_cfg.program_len:.1f}")
        busy = "not measured" if run_prof is None else f"{run_prof[0]:.3f}"
        say(f"phase 17.1 eval-iqap, transformer_iqap (d {iqap_cfg.embed_dim}, "
            f"{iqap_cfg.num_heads} heads, {iqap_cfg.encoder_layers}+{iqap_cfg.decoder_layers} "
            f"layers, L={iqap_len}), {name}, run_eval_iqap on {n} questions: "
            f"{n / seconds:.1f} questions/s (median of {BASELINE_REPEATS}: {seconds * 1e3:.1f} ms); "
            f"encode+answer {enc_ms:.2f} ms, {iqap_cfg.program_len}-step greedy decode "
            f"{dec_ms:.2f} ms (CUDA events, median of {BASELINE_REPEATS}); {per_step} kernels and "
            f"copies per decode step; card busy {busy} of a run; launches {counts}; "
            f"answer accuracy {summary['answer_accuracy']:.3f}, program exact match "
            f"{summary['exact_match']:.3f} (random weights)")
        # K1 once per encoder layer (one encode of every question), and
        # nothing from the decoder's causal self-attention or cross-attention
        want = dict.fromkeys(counts, 0)
        want["fused_attention"] = iqap_cfg.encoder_layers
        if not (pred_answers.shape == (n,) and pred_programs.shape == (n, 27)
                and counts == want):
            fail(f"phase 17.1 check failed: an answer and a program per question, and K1 once "
                 f"per encoder layer at head dim 64 and nothing else: launches {counts}")
        with torch.no_grad(), eval_mode(model):
            k1_on_off(torch, f"phase 17.1 {name} encode+answer (B={n}, L={iqap_len})",
                      lambda: model(images, q_dev)["answer_logits"])
        k1_on_off(torch, f"phase 17.1 {name} run_eval_iqap on {n} questions", run)
        if dtype == torch.float32:
            fp32_iqap = model
        del model
    # ---- 17.2 float32, card vs CPU ----
    iqap_decisions(fp32_iqap, BASELINE_FP32, "17.2 eval-iqap d 256")
    del fp32_iqap

    # ---- 17.3 infer-chain, preset width ----
    def chain_run(model, rows, bucketed=False):
        """The first ``rows`` chains (all with None) through the runner on
        the model's device."""
        device = next(model.parameters()).device
        runner = Seq2SeqChainRunner(model, model.config, max_steps=28, device=device)
        sub = chains if rows is None else type(chains)(
            chains.image_index[:rows], chains.functions[:rows], chains.deps[:rows],
            chains.num_steps[:rows], [])
        tokens = (chain_tokens if rows is None else chain_tokens[:rows]).to(device)
        if bucketed:
            return run_bucketed_seq2seq(runner, tokens, sub)
        return runner.run(tokens, sub)

    calls = {"encode": 0, "decode_step": 0}

    def counting(model):
        for name in calls:
            def wrapped(*a, _f=getattr(model, name), _n=name, **k):
                calls[_n] += 1
                return _f(*a, **k)
            setattr(model, name, wrapped)

    seq = init_parameters(StepExecutorSeq2Seq(seq_cfg, torch.bfloat16, dev), seed=173)
    counting(seq)
    outs, rates = {}, {}
    for mode in ("run", "bucketed"):
        seconds = median_s(lambda: chain_run(seq, None, mode == "bucketed"))
        for key in calls:
            calls[key] = 0
        outs[mode], counts = counted(lambda: chain_run(seq, None, mode == "bucketed"))
        rates[mode] = (len(chains.num_steps) / seconds, seconds, dict(calls), counts)
    agree = float((outs["run"]["step_outputs"] == outs["bucketed"]["step_outputs"])
                  .all((1, 2)).mean())
    say(f"phase 17.3 infer-chain, step_seq2seq (d {seq_cfg.d_model}, {seq_cfg.num_heads} heads, "
        f"{seq_cfg.encoder_layers}+{seq_cfg.decoder_layers} layers, ffn {seq_cfg.ffn_dim}, "
        f"{seq_cfg.max_tgt_len}-token decodes), bf16, {len(chains.num_steps)} chains: "
        + "; ".join(f"{mode} {r[0]:.1f} chains/s (median of {BASELINE_REPEATS}: {r[1] * 1e3:.1f} ms), "
                    f"{r[2]['encode']} encodes and {r[2]['decode_step']} decode steps a run, "
                    f"launches {r[3]}" for mode, r in rates.items())
        + f"; the two runs' step outputs agree on {agree:.3f} of the chains (bf16)")
    for mode, (_, _, mode_calls, counts) in rates.items():
        # K1 once per encoder layer of every encode, and nothing else
        want = dict.fromkeys(counts, 0)
        want["fused_attention"] = seq_cfg.encoder_layers * mode_calls["encode"]
        if counts != want or not mode_calls["encode"]:
            fail(f"phase 17.3 check failed: {mode} must launch K1 once per encoder layer of "
                 f"each of its {mode_calls['encode']} encodes at head dim 64 and nothing else: "
                 f"launches {counts}")
    if not (outs["run"]["step_outputs"] != 0).any():
        fail("phase 17.3 check failed: no decoded output")
    k1_on_off(torch, f"phase 17.3 Seq2SeqChainRunner.run, bf16, {len(chains.num_steps)} chains",
              lambda: chain_run(seq, None))
    del seq

    def chains_fp32(cfg, rows, seed, label):
        """Float32 chain runs of ``rows`` chains: run against bucketed on the
        card, and the card against a CPU copy."""
        card = init_parameters(StepExecutorSeq2Seq(cfg, torch.float32, dev), seed=seed)
        cpu = StepExecutorSeq2Seq(cfg, torch.float32, "cpu")
        cpu.load_state_dict(card.state_dict())
        rec_card, rec_cpu = LogitsRecorder(card.output), LogitsRecorder(cpu.output)
        on_card, counts = counted(lambda: chain_run(card, rows))
        on_cpu = chain_run(cpu, rows)
        rec_card.remove()
        rec_cpu.remove()
        bucketed = chain_run(card, rows, bucketed=True)
        steps = cfg.max_tgt_len
        run_gaps = chain_gaps(np, on_card, bucketed, rec_card.calls, steps)
        cpu_gaps = chain_gaps(np, on_cpu, on_card, rec_cpu.calls, steps)
        say(f"phase 17 {label}: float32, {rows} chains: run vs bucketed on the card "
            f"{'equal' if not run_gaps else f'differ at {len(run_gaps)} (near-ties {run_gaps})'}"
            f"; card vs CPU {'equal' if not cpu_gaps else f'differ at {len(cpu_gaps)} (near-ties {cpu_gaps})'}"
            f"; launches on the card {counts}")
        if any(g > NEAR_TIE for g in run_gaps + cpu_gaps):
            fail(f"phase 17 {label}: float32 chain outputs differ beyond a near-tie")
        return counts

    chains_fp32(seq_cfg, BASELINE_FP32, 174, "17.3 infer-chain d 256")

    # ---- 17.4 K2 on this path: d 512 ----
    iqap512 = dataclasses.replace(iqap_cfg, embed_dim=512)
    seq512 = dataclasses.replace(seq_cfg, d_model=512, ffn_dim=2048)
    model = init_parameters(TransformerIQAP(iqap512, torch.bfloat16, dev), seed=175)
    seq = init_parameters(StepExecutorSeq2Seq(seq512, torch.bfloat16, dev), seed=176)

    def block_agreement(model, encode, label):
        (_, counts), texts, ok = encoder_blocks_agreement(torch, counted, model.encoder, encode)
        layers = len(model.encoder.blocks)
        say(f"phase 17.4 {label}, bf16 eval encode: K2 {counts['fused_encoder_block']} launches "
            f"({layers} layers), K1 {counts['fused_attention']}; against K2's plain version: "
            + "; ".join(texts))
        if counts["fused_encoder_block"] != layers or not ok:
            fail(f"phase 17.4 {label}: K2 must run once per encoder layer and agree with its "
                 "plain version")

    with torch.no_grad(), eval_mode(model), eval_mode(seq):
        block_agreement(model, lambda: model.encode(images[:BASELINE_FP32],
                                                    q_dev[:BASELINE_FP32]),
                        f"transformer_iqap d 512 (B={BASELINE_FP32}, L={iqap_len}, no mask)")
        src = torch.from_numpy(data["steps"]["src"][:BASELINE_FP32]).to(dev)
        step_images = features.index_select(0, torch.as_tensor(
            data["steps"]["image_index"][:BASELINE_FP32], device=dev))
        block_agreement(seq, lambda: seq.encode(step_images, src, src != 0),
                        f"step_seq2seq d 512 (B={BASELINE_FP32}, "
                        f"L={tokens + seq_cfg.max_src_len}, flatten_steps' ragged src mask)")
    t0 = time.perf_counter()
    _, by_path["eval_iqap_d512"] = counted(
        lambda: run_eval_iqap(model, questions, features, data["image_index"], answers,
                              programs, device=dev))
    iqap_s = time.perf_counter() - t0
    calls.update(encode=0, decode_step=0)
    counting(seq)
    rows = min(128, len(chains.num_steps))
    t0 = time.perf_counter()
    _, by_path["infer_chain_d512"] = counted(lambda: chain_run(seq, rows))
    chain_s = time.perf_counter() - t0
    say(f"phase 17.4 d 512 bf16 paths: run_eval_iqap on {n} questions {iqap_s:.3f} s (no "
        f"warm-up), launches {by_path['eval_iqap_d512']}; Seq2SeqChainRunner.run on {rows} chains "
        f"{chain_s:.3f} s, {calls['encode']} encodes (K2 {seq512.encoder_layers} each: "
        f"{seq512.encoder_layers * calls['encode']}), launches {by_path['infer_chain_d512']}")
    if not (by_path["eval_iqap_d512"]["fused_encoder_block"] == iqap512.encoder_layers
            and by_path["infer_chain_d512"]["fused_encoder_block"]
            == seq512.encoder_layers * calls["encode"] > 0):
        fail("phase 17.4: K2 must run once per encoder layer of every encode on the d 512 paths")
    del model, seq
    torch.cuda.empty_cache()
    iqap_decisions(init_parameters(TransformerIQAP(iqap512, torch.float32, dev), seed=177),
                   BASELINE_FP32, "17.4 eval-iqap d 512 (K2 float32)")
    chains_fp32(seq512, BASELINE_D512_CHAINS, 178, "17.4 infer-chain d 512 (K2 float32)")
    torch.cuda.empty_cache()

    # ---- 17.5 train steps ----
    baseline_training(torch, np, dev, data)
    say(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return by_path


@contextlib.contextmanager
def own_rng(torch, seed: int):
    """The global CPU and CUDA generators (the models' dropout draws from
    them) seeded with ``seed`` for the block and restored after it, so that
    a model built and trained inside draws the same numbers whatever the
    phases before it drew (fewer draws upstream once gave phase 17.5's
    ``lstm_iqap`` other dropout masks and a diverging fixed batch)."""
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        torch.manual_seed(seed)
        yield


def baseline_training(torch, np, dev, data) -> None:
    """Phase 17.5: one fixed batch of each baseline family at its preset's
    width and batch, bf16, through ``Trainer.train_step``, each family with
    the global generators of its own (``own_rng``, its preset's seed)."""
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.train import pipelines

    features = data["features"]
    tokens, width = BASELINE_IMAGE
    side = math.isqrt(tokens)
    image = dict(num_image_tokens=tokens, image_feature_dim=width)
    iqap_arrays = {"questions": data["questions"], "answers": data["answers"],
                   "programs": data["programs"], "image_index": data["image_index"]}
    vocabs = dict(vocab_size=max(96, int(data["questions"].max()) + 1),
                  program_vocab_size=max(45, int(data["programs"].max()) + 1),
                  num_answer_classes=max(32, int(data["answers"].max()) + 1))
    grid = features.transpose(1, 2).reshape(len(features), width, side, side)
    families = (
        ("transformer_iqap", pipelines.iqap_pipeline_from_arrays, iqap_arrays, features,
         dict(vocabs, **image)),
        ("lstm_iqap", pipelines.lstm_iqap_pipeline_from_arrays, iqap_arrays, grid,
         dict(vocabs, image_feature_dim=width, image_spatial=(side, side))),
        ("step_seq2seq", pipelines.step_seq2seq_pipeline_from_arrays, data["steps"], features,
         dict(vocab_size=max(128, data["joint_size"]), **image)),
    )
    for preset, build, arrays, feats, sizes in families:
        t0 = time.perf_counter()
        cfg = get_preset(preset)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **sizes),
                          train=dataclasses.replace(cfg.train, log_every=0))
        with own_rng(torch, cfg.train.seed):
            baseline_fixed_batch(torch, dev, preset, build, cfg, arrays, feats, t0)


def baseline_fixed_batch(torch, dev, preset, build, cfg, arrays, feats, t0) -> None:
    """Phase 17.5 for one family: its fixed batch's updates, timed."""
    from explainable_spatial_vqa_tpu_torch.train import pipelines
    from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

    pipe = build(cfg, arrays, feats, device=dev)
    trainer = Trainer(pipe.loss_fn, pipe.model, cfg.optim, cfg.train, pipe.steps_per_epoch,
                      checkpoint_dir=False, device=dev)
    batch = to_device(next(iter(pipe.train_batches(0))), dev)
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(BASELINE_UPDATES + 1)]
    losses = []
    for start, end in marks:
        start.record()
        losses.append(trainer.train_step(batch, gen)["loss_sum"])
        end.record()
    losses = torch.stack(losses).tolist()  # waits for the card
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(start.elapsed_time(end) for start, end in marks[3:])
    wall, prof = device_profile(torch, lambda: trainer.train_step(batch, gen))
    kernels = "not measured" if prof is None else f"{prof[3]}"
    busy = "not measured" if prof is None else f"{prof[0]:.3f}"
    ratios = [x / losses[0] for x in losses]
    below = next((i for i, r in enumerate(ratios) if r < 0.8), None)
    params = sum(p.numel() for p in pipe.model.parameters())
    say(f"phase 17.5 {preset} training ({str(pipelines.model_dtype(cfg, dev)).split('.')[-1]}, batch {cfg.train.batch_size}, lr "
        f"{cfg.optim.learning_rate}, {params / 1e6:.1f}M parameters): {ms:.2f} ms per step "
        f"(median of {BASELINE_UPDATES - 2} after 3, CUDA events); peak {peak:.2f} GiB; "
        f"{kernels} kernels and copies per step, busy {busy} (one step under the profiler, "
        f"{wall * 1e3:.1f} ms); fixed-batch loss step 0 {losses[0]:.4f}, step "
        f"{BASELINE_UPDATES} {losses[-1]:.4f} ({ratios[-1]:.3f} of step 0), below 0.8 "
        f"at update {below}; {time.perf_counter() - t0:.1f} s")
    if not (all(math.isfinite(x) for x in losses) and below is not None):
        fail(f"phase 17.5: the {preset} fixed batch's loss did not fall below 0.8 of its "
             f"first within {BASELINE_UPDATES} updates")
    del trainer, pipe, batch
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 18: the chain-of-thought IQAP and the prototype step models
# ---------------------------------------------------------------------------


def proto_data(torch, np, dev) -> dict:
    """Phase 18's inputs from the CLEVR factory: ``PROTO_SCENES`` scenes with
    4 questions each (hops and chains on), annotated as single strings and
    mapped to the CoT's sequences (20-token questions, programs padded to
    100), and annotated in v3 to ``executor_step_arrays``' step records (18
    input and 10 output box slots) in their split vocabulary; seeded random
    (N, 1024, 14, 14) features (and the same as (N, 196, 1024) tokens) and
    224 px pixels in [0, 1] per image, on the card.  In memory: no h5, no
    PNG."""
    from explainable_spatial_vqa_tpu_torch.clevr import annotate as ann
    from explainable_spatial_vqa_tpu_torch.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu_torch.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu_torch.core import vocab as voc
    from explainable_spatial_vqa_tpu_torch.core.annotated_strings import build_mapped_sequences
    from explainable_spatial_vqa_tpu_torch.train.datasets import executor_step_arrays

    scenes_raw, questions = syn.synthesize_dataset(PROTO_SCENES, 4, seed=18, hop_prob=0.5,
                                                   chain_prob=0.5)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    mapped, token_to_id = build_mapped_sequences(
        [ann.annotate_question_string(q, scenes[q["image_index"]]) for q in questions])
    annotated = ann.annotate_questions(questions, scenes)
    vocabs = voc.build_split_vocab(annotated)
    steps = executor_step_arrays(annotated, vocabs["function"], vocabs["other"],
                                 max_input_boxes=18, max_output_boxes=10)
    gen = torch.Generator(device=dev).manual_seed(18)
    n = len(scenes_raw)
    grid = torch.rand(n, 1024, 14, 14, generator=gen, device=dev)
    return dict(mapped=mapped, token_to_id=token_to_id, steps=steps, vocabs=vocabs, grid=grid,
                tokens=grid.flatten(2).transpose(1, 2).contiguous(),
                pixels=torch.rand(n, 224, 224, 3, generator=gen, device=dev))


def timed_fixed_batch(torch, dev, trainer, batch, updates: int) -> dict:
    """``updates`` + 1 ``Trainer.train_step``s of one fixed batch, each
    between CUDA events: the median ms of 5 after the first (a warm-up), the
    peak GiB, the losses and the first update below 0.8 of the first loss;
    then one step under the profiler (kernels and copies, busy share).  The
    steps draw from global generators of their own (``own_rng``, seed 0)."""
    with own_rng(torch, 0):
        return fixed_batch_steps(torch, trainer, batch, updates)


def fixed_batch_steps(torch, trainer, batch, updates: int) -> dict:
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(updates + 1)]
    losses = []
    for start, end in marks:
        start.record()
        losses.append(trainer.train_step(batch, gen)["loss_sum"])
        end.record()
    losses = torch.stack(losses).tolist()  # waits for the card
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(start.elapsed_time(end) for start, end in marks[1:6])
    wall, prof = device_profile(torch, lambda: trainer.train_step(batch, gen))
    below = next((i for i, x in enumerate(losses) if x < 0.8 * losses[0]), None)
    return dict(ms=ms, peak=peak, losses=losses, below=below, wall=wall,
                kernels="not measured" if prof is None else f"{prof[3]}",
                busy="not measured" if prof is None else f"{prof[0]:.3f}",
                finite=all(math.isfinite(x) for x in losses))


def card_vs_cpu_loss(torch, dev, pipe, train: bool, grads: bool) -> dict:
    """A float32 pipeline's first training batch: its loss (and, with
    ``grads``, every gradient) on the card against a copy of the model on
    the CPU, each with a generator of the same seed.  Returns the relative
    loss error, the largest gradient error over its tensor's max |g|, and
    the largest attention key-bias gradient (exactly zero: softmax ignores
    a shift of the scores) over the largest gradient of all."""
    from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device

    batch = to_device(next(iter(pipe.train_batches(0))), dev)
    cpu_model = copy.deepcopy(pipe.model).to("cpu")
    out = []
    for model, b in ((pipe.model, batch),
                     (cpu_model, {k: v.cpu() if isinstance(v, torch.Tensor) else v
                                  for k, v in batch.items()})):
        model.train(train)
        model.zero_grad(set_to_none=True)
        loss, _ = pipe.loss_fn(model, b, torch.Generator().manual_seed(0), train)
        if grads:
            loss.backward()
        out.append((float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}))
    (card, card_g), (cpu, cpu_g) = out
    worst, key_bias = 0.0, 0.0
    if grads:
        largest = max(float(g.abs().max()) for g in cpu_g.values() if g is not None)
        for name, g in cpu_g.items():
            if g is None or not float(g.abs().max()):
                continue
            if name.endswith(".k.bias"):
                key_bias = max(key_bias, float(g.abs().max()) / largest,
                               float(card_g[name].abs().max()) / largest)
                continue
            worst = max(worst, float((card_g[name].cpu() - g).abs().max() / g.abs().max()))
    del cpu_model
    return dict(card=card, cpu=cpu, rel=abs(card - cpu) / max(abs(cpu), 1e-30), grad=worst,
                key_bias=key_bias)


def cot_and_prototypes(torch, np, dev, counted) -> dict:
    """Phase 18, the chain-of-thought IQAP and the eight prototype presets at
    their presets' widths, random weights from seeds, on ``proto_data``:

    1. ``transformer_iqap_cot`` (d 256, 1+1 layers, the string vocabulary):
       one bf16 train step at batch 64 through
       ``iqap_cot_pipeline_from_arrays`` and ``Trainer.train_step`` (ms, the
       median of 5 after a warm-up by CUDA events; peak GiB; kernels and
       copies; busy share); the fixed batch's loss below 0.8 of its first
       within ``PROTO_UPDATES`` updates; a float32 step (deterministic) on
       the card against the CPU (loss within 1e-5 relative, every gradient
       within 1e-4 of its tensor's max |g|); greedy decoding of the combined
       sequence (``generate_programs`` at ``program_len``) for every
       question in bf16 (ms by CUDA events) and ``mean_sequential_iou``;
       in float32 on ``COT_DECODE_FP32`` questions the tokens equal to the
       CPU's (a row that differs must come from a near-tie);
    2. the eight prototype presets through
       ``prototype_step_pipeline_from_arrays`` (``multihead`` with its
       200,704 x 256 ``image_fc``, ``yolo_bb`` at 224 px): a bf16 step at
       the preset's batch (ms, peak GiB), a fixed batch's loss below 0.8
       of its first within ``PROTO_UPDATES`` updates, a float32 step on the
       card against the CPU (loss within 1e-5 relative);
       Each preset's eval forward (its loss in eval mode, no autograd) is
       counted: K1 once per encoder layer and once per decoder layer in
       ``hierarchical`` (d 256, head dim 64), nothing in the others, which
       hold no attention; the CoT's decode launches K1 once per encoder
       layer;
    3. K2 on a new path: ``HierarchicalGenerator`` at d 512, 4 heads (head
       dim 128), 2 layers, batch 128, 196 image tokens, no mask: an eval
       forward in bf16 launches K2 once per encoder layer and K1 once per
       decoder layer (the self-attention on the one-token start query: same
       length, a (1, 1, 1, 1) mask, JAX's rule), each block held against
       K2's plain version and the start query's attention against K1's
       plain version; in float32 ``type_logits``' argmax and ``pred_boxes``
       on the card against the CPU (1e-4); a train step of the module in
       train mode launches neither.

    Returns the eval forward's launches, for the result line."""
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.models.cot import mean_sequential_iou
    from explainable_spatial_vqa_tpu_torch.models.iqap import generate_programs
    from explainable_spatial_vqa_tpu_torch.models.layers import eval_mode, init_parameters
    from explainable_spatial_vqa_tpu_torch.models.prototypes import HierarchicalGenerator
    from explainable_spatial_vqa_tpu_torch.ops.attention import (
        dot_product_attention,
        make_causal_mask,
    )
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention
    from explainable_spatial_vqa_tpu_torch.train import pipelines
    from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    data = proto_data(torch, np, dev)
    mapped, steps = data["mapped"], data["steps"]
    lengths = (mapped["program_tokens"] != 0).sum(1)
    say(f"phase 18 data: {len(mapped['image_index'])} questions of {PROTO_SCENES} CLEVR factory "
        f"scenes; CoT sequences {mapped['question_tokens'].shape[1]}-token questions, programs "
        f"of {int(lengths.min())}-{int(lengths.max())} tokens (mean {float(lengths.mean()):.1f}) "
        f"padded to {mapped['program_tokens'].shape[1]}, string vocabulary "
        f"{len(data['token_to_id'])} ids; {len(steps['is_box_branch'])} v3 step records "
        f"({float(steps['is_box_branch'].mean()):.3f} spatial); {time.perf_counter() - t_phase:.1f} s")

    def trainer_of(cfg, pipe):
        return Trainer(pipe.loss_fn, pipe.model, cfg.optim, cfg.train, pipe.steps_per_epoch,
                       checkpoint_dir=False, device=dev)

    def with_train(cfg, **kw):
        return cfg.replace(train=dataclasses.replace(cfg.train, log_every=0, **kw))

    def step_text(r):
        return (f"{r['ms']:.2f} ms per step (median of 5 after a warm-up, CUDA events); peak "
                f"{r['peak']:.2f} GiB; {r['kernels']} kernels and copies per step, busy "
                f"{r['busy']} (one step under the profiler, {r['wall'] * 1e3:.1f} ms); "
                f"fixed-batch loss step 0 {r['losses'][0]:.4f}, step {PROTO_UPDATES} "
                f"{r['losses'][-1]:.4f}, below 0.8 at update {r['below']}")

    # ---- 18.1 the chain-of-thought IQAP ----
    t0 = time.perf_counter()
    cot = with_train(get_preset("transformer_iqap_cot"))
    pipe = pipelines.iqap_cot_pipeline_from_arrays(cot, mapped, data["token_to_id"],
                                                   data["tokens"], device=dev)
    mcfg = pipe.model.config
    trainer = trainer_of(cot, pipe)
    r = timed_fixed_batch(torch, dev, trainer, to_device(next(iter(pipe.train_batches(0))), dev),
                          PROTO_UPDATES)
    say(f"phase 18.1 transformer_iqap_cot training (bf16, d {mcfg.embed_dim}, "
        f"{mcfg.encoder_layers}+{mcfg.decoder_layers} layers, vocabulary {mcfg.vocab_size}, "
        f"programs {mcfg.program_len}, batch {cot.train.batch_size}): {step_text(r)}")
    if not (r["finite"] and r["below"] is not None):
        fail(f"phase 18.1: the CoT fixed batch's loss did not fall below 0.8 of its first "
             f"within {PROTO_UPDATES} updates")
    model = pipe.model
    questions = torch.from_numpy(mapped["question_tokens"]).to(dev)
    images = data["tokens"].index_select(0, torch.as_tensor(mapped["image_index"], device=dev))
    idx_to_token = {v: k for k, v in data["token_to_id"].items()}

    def decode(m, rows, device):
        with torch.no_grad(), eval_mode(m):
            out = m(images[:rows].to(device), questions[:rows].to(device))
            return generate_programs(m, out["memory"], max_len=mcfg.program_len)

    decode(model, 16, dev)  # first calls
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    (tokens, _), cot_launches = counted(lambda: decode(model, len(questions), dev))
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end)
    iou = mean_sequential_iou(tokens.cpu().numpy(), mapped["program_tokens"], idx_to_token)
    del trainer, pipe, model

    cot32 = with_train(cot, dtype="float32", batch_size=PROTO_FP32_ROWS)
    pipe = pipelines.iqap_cot_pipeline_from_arrays(cot32, mapped, data["token_to_id"],
                                                   data["tokens"], device=dev)
    agree = card_vs_cpu_loss(torch, dev, pipe, train=False, grads=True)
    model32 = pipe.model
    cpu32 = copy.deepcopy(model32).to("cpu")
    (t_card, _), (t_cpu, l_cpu) = (decode(model32, COT_DECODE_FP32, dev),
                                   decode(cpu32, COT_DECODE_FP32, torch.device("cpu")))
    gaps = decision_gaps(np, t_card.cpu().numpy(), t_cpu.numpy(), l_cpu.numpy())
    say(f"phase 18.1 CoT greedy decode of the combined sequence, bf16, {len(questions)} "
        f"questions x {mcfg.program_len} steps: {decode_ms:.2f} ms (CUDA events), launches "
        f"{cot_launches} (K1 {mcfg.encoder_layers} expected: the encoder's self-attention at "
        f"head dim {mcfg.embed_dim // mcfg.num_heads}, once per layer); "
        f"mean_sequential_iou {iou['mean_iou']:.4f} over {int(iou['evaluated'])} rows with "
        f"boxes; float32 step card vs CPU ({PROTO_FP32_ROWS} rows, deterministic): loss "
        f"{agree['card']:.6f} vs {agree['cpu']:.6f} (rel {agree['rel']:.2e}, tol 1e-5), "
        f"gradients within {agree['grad']:.2e} of their tensor's max |g| (tol 1e-4), the "
        f"key biases' (zero) within {agree['key_bias']:.2e} of the largest (tol 1e-6); "
        f"float32 decode on "
        f"{COT_DECODE_FP32} questions: tokens "
        f"{'equal' if not gaps else f'differ at {len(gaps)} (near-ties, top-2 gaps {gaps})'}; "
        f"{time.perf_counter() - t0:.1f} s")
    if (agree["rel"] > 1e-5 or agree["grad"] > 1e-4 or agree["key_bias"] > 1e-6
            or any(g > NEAR_TIE for g in gaps)):
        fail("phase 18.1: the float32 CoT step or decode on the card disagrees with the CPU")
    if cot_launches != dict(dict.fromkeys(cot_launches, 0), fused_attention=mcfg.encoder_layers):
        fail(f"phase 18.1: the CoT decode must launch K1 once per encoder layer and nothing "
             f"else: {cot_launches}")
    del pipe, model32, cpu32
    torch.cuda.empty_cache()

    # ---- 18.2 the prototype presets ----
    fv, vv = data["vocabs"]["function"], data["vocabs"]["other"]
    proto_launches, proto_k1 = {}, {}
    for preset in ("token_only", "bb_only", "bb_only_iou", "yolo_bb", "multitask_bb", "bbinout",
                   "multihead", "hierarchical"):
        t0 = time.perf_counter()
        cfg = with_train(get_preset(preset))
        feats = data["pixels"] if cfg.model.kind == "yolo" else data["grid"]
        pipe = pipelines.prototype_step_pipeline_from_arrays(cfg, steps, fv, vv, feats,
                                                             device=dev)
        params = sum(p.numel() for p in pipe.model.parameters())
        batch = to_device(next(iter(pipe.train_batches(0))), dev)
        with torch.no_grad(), eval_mode(pipe.model):  # an eval forward's launches
            _, proto_launches[preset] = counted(lambda: pipe.loss_fn(
                pipe.model, batch, torch.Generator().manual_seed(0), False))
        if cfg.model.kind == "hierarchical":
            proto_k1[preset] = len(pipe.model.encoder.blocks) + len(pipe.model.decoder.blocks)
        r = timed_fixed_batch(torch, dev, trainer_of(cfg, pipe), batch, PROTO_UPDATES)
        del pipe, batch
        cfg32 = with_train(cfg, dtype="float32", batch_size=PROTO_FP32_ROWS)
        agree = card_vs_cpu_loss(torch, dev, pipelines.prototype_step_pipeline_from_arrays(
            cfg32, steps, fv, vv, feats, device=dev), train=True, grads=False)
        say(f"phase 18.2 {preset} ({cfg.model.kind}, bf16, batch {cfg.train.batch_size}, lr "
            f"{cfg.optim.learning_rate}, {params / 1e6:.2f}M parameters): {step_text(r)}; "
            f"float32 step card vs CPU ({PROTO_FP32_ROWS} rows): loss {agree['card']:.6f} vs "
            f"{agree['cpu']:.6f} (rel {agree['rel']:.2e}, tol 1e-5); an eval forward's "
            f"launches {proto_launches[preset]}; {time.perf_counter() - t0:.1f} s")
        if not (r["finite"] and r["below"] is not None):
            fail(f"phase 18.2: the {preset} fixed batch's loss did not fall below 0.8 of its "
                 f"first within {PROTO_UPDATES} updates")
        if agree["rel"] > 1e-5:
            fail(f"phase 18.2: the {preset} float32 loss on the card disagrees with the CPU")
        torch.cuda.empty_cache()
    # only HierarchicalGenerator holds attention: at its preset (d 256, head
    # dim 64) K1 once per encoder layer and once per decoder layer's
    # start-query self-attention, and no K2
    for preset, launches_ in proto_launches.items():
        want = dict(fused_attention=proto_k1.get(preset, 0), fused_encoder_block=0,
                    fused_encoder_block_tiled=0)
        if any(launches_[k] != n for k, n in want.items()):
            fail(f"phase 18.2: {preset}'s eval forward launched {launches_}, not {want}")

    # ---- 18.3 K2 on a new path: HierarchicalGenerator at d 512 ----
    t0 = time.perf_counter()
    b = K2_HIER_SHAPE[0]
    rows = np.flatnonzero(steps["is_box_branch"])[:b]
    image = data["tokens"].index_select(0, torch.as_tensor(steps["image_index"][rows],
                                                           device=dev))
    boxes = torch.from_numpy(steps["target_boxes"][rows]).to(dev)
    hier = init_parameters(HierarchicalGenerator(**HIER_D512, dtype=torch.bfloat16, device=dev),
                           seed=183)
    with torch.no_grad(), eval_mode(hier):
        hier(image, boxes)  # first calls
        (_, launches), texts, ok = encoder_blocks_agreement(
            torch, counted, hier.encoder, lambda: hier(image, boxes))
        attn = hier.decoder.blocks[0].self_attn
        start = hier.start_query.expand(b, 1, 512).to(torch.bfloat16)
        q, k, v = (attn._heads(p, start).contiguous() for p in (attn.q, attn.k, attn.v))
        mask = make_causal_mask(1, dev)
        k1 = attention_agreement(torch, fused_attention(q, k, v, mask), q, k, v, mask)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        for s_, e_ in zip(starts, ends):
            s_.record()
            hier(image, boxes)
            e_.record()
        torch.cuda.synchronize()
        forward_ms = statistics.median(s_.elapsed_time(e_) for s_, e_ in zip(starts[1:],
                                                                                ends[1:]))
    layers = HIER_D512["num_layers"]
    say(f"phase 18.3 HierarchicalGenerator d 512, 4 heads, {layers}+{layers} layers, bf16 eval "
        f"forward at B={b}, L={image.shape[1]}, no mask: {forward_ms:.2f} ms (median of 5 "
        f"after a warm-up); launches {launches} (K2 {layers} expected, one per encoder layer; "
        f"K1 {layers}, one per decoder layer's start-query self-attention); against K2's plain "
        f"version: " + "; ".join(texts) + f"; K1 at B={b}, L=1, H=4, D=128 against its plain "
        f"version: {bf16_text(k1)}")
    if not (launches["fused_encoder_block"] == layers and launches["fused_attention"] == layers
            and ok and bf16_ok(k1)):
        fail("phase 18.3: the eval forward must run K2 once per encoder layer and K1 once per "
             "decoder layer, each agreeing with its plain version")

    hier32 = HierarchicalGenerator(**HIER_D512, dtype=torch.float32, device=dev)
    hier32.load_state_dict(hier.state_dict())
    cpu32 = copy.deepcopy(hier32).to("cpu")
    outs = []
    for m, device in ((hier32, dev), (cpu32, torch.device("cpu"))):
        with torch.no_grad(), eval_mode(m):
            out = m(image.to(device), boxes.to(device))
        outs.append({key: val.cpu() for key, val in out.items()})
    (card, cpu), err = outs, {}
    for key in ("type_logits", "pred_boxes", "stop_logits", "nonspatial_value"):
        err[key] = float((card[key] - cpu[key]).abs().max())
    same_type = bool(torch.equal(card["type_logits"].argmax(-1), cpu["type_logits"].argmax(-1)))
    top2 = cpu["type_logits"].sort(-1).values
    gap = float((top2[:, -1] - top2[:, -2]).min())
    del cpu32, hier32

    cfg = with_train(get_preset("hierarchical"), batch_size=32)
    pipe = pipelines.prototype_step_pipeline_from_arrays(cfg, steps, fv, vv, data["grid"],
                                                         device=dev)
    trainer = Trainer(pipe.loss_fn, hier, cfg.optim, cfg.train, checkpoint_dir=False,
                      device=dev)
    batch = to_device(next(iter(pipe.train_batches(0))), dev)
    (metrics, train_launches) = counted(
        lambda: trainer.train_step(batch, torch.Generator().manual_seed(0)))
    train_loss = float(metrics["loss_sum"])
    say(f"phase 18.3 float32 eval forward, card (K2, K1) vs CPU: type_logits argmax "
        f"{'equal' if same_type else 'DIFFER'} (smallest top-2 gap {gap:.3g}), max errors "
        + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in err.items()) + " (tol 1e-4); a bf16 train "
        f"step in train mode (batch {cfg.train.batch_size}, loss {train_loss:.4f}): launches "
        f"{train_launches}; 18.3 took {time.perf_counter() - t0:.1f} s")
    if not (same_type and max(err.values()) <= 1e-4):
        fail("phase 18.3: the float32 HierarchicalGenerator on the card disagrees with the CPU")
    if any(train_launches.values()) or not math.isfinite(train_loss):
        fail("phase 18.3: a train step in train mode must launch neither K2 nor K1")
    del trainer, pipe, hier, batch, data
    torch.cuda.empty_cache()
    say(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return {"hierarchical_d512": launches}


def scaled_resnet(torch, model, seed: int):
    """``model`` (a ``ResNetFeatures``) with seeded random weights scaled as
    tests/test_vision.py scales them: convolutions x 0.5 and batch-norm
    statistics and affine near the identity, so activations stay tame over
    30 blocks and a float32 comparison means something."""
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.vision.resnet import FrozenBatchNorm

    init_parameters(model, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(0.5)
            elif isinstance(m, FrozenBatchNorm):
                n = m.weight.shape
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.05)
                m.running_var.copy_(0.8 + 0.4 * torch.rand(n, generator=gen))
                m.weight.copy_(1.0 + 0.05 * torch.randn(n, generator=gen))
                m.bias.copy_(0.05 * torch.randn(n, generator=gen))
    return model


def conv_flops(torch, model, size) -> float:
    """Operations (2 per multiply-add) of ``model``'s convolutions on one
    image of ``size``, from each convolution's output shape."""
    total = [0.0]

    def hook(conv, _args, out):
        kh, kw = conv.kernel_size
        total[0] += 2.0 * out[0].numel() * conv.in_channels * kh * kw / conv.groups

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    dev = next(model.parameters()).device
    with torch.no_grad():
        model(torch.zeros(1, 3, *size, device=dev))
    for h in hooks:
        h.remove()
    return total[0]


def data_prep(torch, np, dev, counted, trained) -> dict:
    """Phase 19, data preparation on the card: ResNet-101 stage 3 (seeded
    random weights, ``scaled_resnet``) after the antialiased cubic resize, on
    seeded uint8 320x480 images, then its features through ``run_tally``:

    - 19.1 ``cubic_resize`` on the card against the same function on the CPU,
      320x480 -> 224x224 and 20x30 -> 32x32, within 1e-3 on 0-255 values;
    - 19.2 ``make_extract_fn`` at full depth in float32 on 2 images, card
      against CPU, within 1e-4 * max(|ref|, 1); images/s of
      ``extract_to_sink`` (the loop of ``extract_features``, the
      device-to-host copies included) at batch ``PREP_BATCH``, median of
      ``REPEATS`` runs of ``PREP_RUN_BATCHES`` batches by CUDA events after a
      warm-up, beside the bound from the convolutions' operations; peak GiB;
      the busy share of one profiled batch; the forward alone at batch
      ``PREP_BATCH`` in float32, with cuDNN's TF32 allowed and in bf16;
    - 19.3 the first batch's features as (128, 196, 1024) tokens, in the
      tally's order, into ``run_tally`` on 512 CLEVR-factory questions over
      those 128 images at bench widths (``executor_roi``, bf16, per-function
      calibration): K2 3 and K1 2 launches per forward, every answer well
      formed; then in float32 on ``FP32_QUESTIONS`` questions with phase 12's
      trained executor, the first chain run's decisions and the per-function
      map on the card equal to the CPU's on the same features, held as phase
      14 holds them (its true positives are printed; phase 12 trained on
      other features, so none are required here).

    No h5py, PIL or matplotlib: the images and questions are in memory."""
    from explainable_spatial_vqa_tpu_torch.clevr import annotate as ann
    from explainable_spatial_vqa_tpu_torch.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu_torch.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu_torch.cli.main import run_chains, run_tally
    from explainable_spatial_vqa_tpu_torch.core import vocab as voc
    from explainable_spatial_vqa_tpu_torch.core.artifacts import encode_questions
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.evalsuite.executor_eval import (
        _collect_chain_detections,
        calibrate_chain_conf_thresholds_per_function,
    )
    from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.train.datasets import chain_arrays
    from explainable_spatial_vqa_tpu_torch.vision.extract import (
        cubic_resize,
        extract_to_sink,
        make_extract_fn,
    )
    from explainable_spatial_vqa_tpu_torch.vision.resnet import ResNetFeatures

    t_phase = time.perf_counter()
    rng = np.random.RandomState(19)
    n_run = PREP_BATCH * PREP_RUN_BATCHES
    images = rng.randint(0, 256, (n_run, *PREP_IMAGE, 3), dtype=np.uint8)

    # ---- 19.1 the resize ----
    for shape, size in (((8, *PREP_IMAGE, 3), (224, 224)), ((8, 20, 30, 3), (32, 32))):
        x = torch.from_numpy(rng.randint(0, 256, shape).astype(np.float32))
        on_card = cubic_resize(x.to(dev), size).cpu()
        err = float((on_card - cubic_resize(x, size)).abs().max())
        say(f"phase 19.1 cubic_resize {shape[1]}x{shape[2]} -> {size[0]}x{size[1]}, card vs CPU: "
            f"max_abs_err {err:.3g} (tol 1e-3, 0-255 values)")
        if not err <= 1e-3:
            fail("phase 19.1: the resize on the card disagrees with the CPU")
    batch = torch.from_numpy(images[:PREP_BATCH]).to(dev)
    resize_ms = timed_ms(torch, lambda: cubic_resize(batch.float(), (224, 224)), iters=10)
    say(f"phase 19.1 cubic_resize of {PREP_BATCH} images, uint8 to float32 and two matmuls: "
        f"{resize_ms:.3f} ms")

    # ---- 19.2 the extractor at full depth ----
    cpu_model = scaled_resnet(torch, ResNetFeatures(device="cpu"), 19)
    model = ResNetFeatures(device=dev)
    model.load_state_dict(cpu_model.state_dict())
    extract = make_extract_fn(model)
    on_card = extract(torch.from_numpy(images[:2]).to(dev)).cpu()
    ref = make_extract_fn(cpu_model)(torch.from_numpy(images[:2]))
    err = float((on_card - ref).abs().max())
    scale = float(ref.abs().max())
    say(f"phase 19.2 ResNet-101 stage 3 float32 (TF32 off), 2 images 320x480 -> 224, card vs "
        f"CPU: max_abs_err {err:.3g}, max |ref| {scale:.3g} (tol 1e-4 * max(|ref|, 1) = "
        f"{1e-4 * max(scale, 1.0):.3g})")
    if not (tuple(on_card.shape) == (2, 1024, 14, 14) and err <= 1e-4 * max(scale, 1.0)):
        fail("phase 19.2: the extractor on the card disagrees with the CPU")
    del cpu_model, on_card, ref

    flops = conv_flops(torch, model, (224, 224))
    weight_bytes = sum(p.numel() * 4 for p in model.parameters())
    nbytes = PREP_BATCH * (PREP_IMAGE[0] * PREP_IMAGE[1] * 3 + 1024 * 14 * 14 * 4) + weight_bytes
    bounds = {kind: bound_ms({kind: flops * PREP_BATCH}, nbytes)
              for kind in ("fp32", "tf32", "bf16")}
    kept = []

    def loop(n):
        extract_to_sink(list(range(n)), lambda i: images[i], extract,
                        lambda a: kept.append(a.shape), dev, batch_size=PREP_BATCH)

    loop(PREP_BATCH)  # warm-up: cuDNN's algorithm choice, the pinned pools
    torch.cuda.reset_peak_memory_stats()
    run_ms = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loop(n_run)
        end.record()
        end.synchronize()
        run_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_image = statistics.median(run_ms) / n_run
    wall, prof = device_profile(torch, lambda: loop(PREP_BATCH))
    busy = "not measured (the profiler saw no device activity)" if prof is None else (
        f"{prof[0]:.3f} ({prof[3]} kernels and copies; by device time: "
        + "; ".join(f"{name[:60]} {ms:.1f} ms" for name, ms in prof[1][:4]) + ")")
    fp32_bound, by = bounds["fp32"]
    say(f"phase 19.2 extract_to_sink, {REPEATS} runs of {n_run} images in batches of "
        f"{PREP_BATCH} (uint8 up from pinned memory, resize, normalize, ResNet float32, features "
        f"down on a side stream): median {statistics.median(run_ms):.1f} ms = "
        f"{1e3 / per_image:.1f} images/s (all, ms: {', '.join(f'{t:.1f}' for t in run_ms)}); "
        f"peak {peak:.2f} GiB; one batch under the profiler {wall * 1e3:.1f} ms, device busy "
        f"{busy}; bound {fp32_bound:.2f} ms a batch = {PREP_BATCH / fp32_bound * 1e3:.0f} "
        f"images/s ({by}: {flops / 1e9:.2f} GFLOP of convolutions an image, "
        f"{flops * PREP_BATCH / 1e12:.3f} TFLOP a batch, at 67 TFLOP/s on the CUDA cores)")
    if not (len(kept) == 1 + REPEATS * PREP_RUN_BATCHES + 1
            and all(k == (PREP_BATCH, 1024, 14, 14) for k in kept)):
        fail("phase 19.2: the extraction loop did not sink every batch")

    normalized = torch.randn(PREP_BATCH, 3, 224, 224, generator=torch.Generator(
        device=dev).manual_seed(19), device=dev)
    bf16_model = ResNetFeatures(dtype=torch.bfloat16, device=dev)
    bf16_model.load_state_dict(model.state_dict())
    forwards = {}
    with torch.no_grad():
        forwards["fp32"] = timed_ms(torch, lambda: model(normalized), iters=5, warmup=2)
        torch.backends.cudnn.allow_tf32 = True
        forwards["tf32"] = timed_ms(torch, lambda: model(normalized), iters=5, warmup=2)
        torch.backends.cudnn.allow_tf32 = False
        forwards["bf16"] = timed_ms(torch, lambda: bf16_model(normalized), iters=5, warmup=2)
    say("phase 19.2 the forward alone at batch " + str(PREP_BATCH) + ", by CUDA events: "
        + "; ".join(f"{kind} {ms:.2f} ms = {PREP_BATCH / ms * 1e3:.0f} images/s (bound "
                    f"{bounds[kind][0]:.2f} ms, {bounds[kind][1]}; "
                    f"{flops * PREP_BATCH / ms / 1e9:.1f} TFLOP/s)"
                    for kind, ms in forwards.items())
        + "; the CLI and this phase's checks run float32 with TF32 off")
    del bf16_model, normalized

    # ---- 19.3 the features through the tally ----
    t0 = time.perf_counter()
    grid = extract(torch.from_numpy(images[:PREP_BATCH]).to(dev))
    n, c, h, w = grid.shape
    tokens = grid.reshape(n, c, h * w).transpose(1, 2).contiguous()  # as the tally reads h5
    del model, extract
    scenes_raw, questions = syn.synthesize_dataset(PREP_BATCH, 4, seed=19, hop_prob=0.5,
                                                   chain_prob=0.5)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    records = ann.annotate_questions(questions, scenes)
    vocabs = voc.build_split_vocab(records)
    fv, vv = vocabs["function"], vocabs["other"]
    clevr_vocab = voc.build_clevr_vocab([questions])
    enc = encode_questions(questions, clevr_vocab)
    program_inv = voc.invert_vocab(clevr_vocab["program_token_to_idx"])
    answer_inv = voc.invert_vocab(clevr_vocab["answer_token_to_idx"])
    gt_answers = np.asarray([vv.get(voc.canonicalize(answer_inv[int(a)]), -2)
                             for a in enc.answers])
    gen_cfg = dataclasses.replace(
        get_preset("generator").model, vocab_size=len(clevr_vocab["question_token_to_idx"]),
        program_vocab_size=len(clevr_vocab["program_token_to_idx"]),
        program_len=enc.programs.shape[1])
    exe_preset = get_preset("executor_roi").model
    exe_cfg = dataclasses.replace(exe_preset, vocab_size=max(exe_preset.vocab_size, len(fv) + 1),
                                  token_classes=max(exe_preset.token_classes, len(vv) + 1))
    dtype = torch.bfloat16
    generator = init_parameters(ProgramGenerator(gen_cfg, dtype, device=dev), seed=19)
    executor = init_parameters(ProgramExecutor(exe_cfg, dtype, device=dev), seed=19)
    chains = chain_arrays(records, fv)
    log = ForwardLaunches(executor)
    t1 = time.perf_counter()
    out, launches = counted(lambda: run_tally(
        generator, executor, exe_cfg, enc.questions, tokens, enc.image_idxs, program_inv, fv, vv,
        gt_answers=gt_answers, programs=enc.programs, annotated=records, chain_mode="sorted",
        calibrate_conf_per_function=True, device=dev))
    tally_s = time.perf_counter() - t1
    log.remove()
    runs = [log.tally(r["start"], r["start"] + r["seconds"]) for r in out.runs]
    total = log.tally()
    answers = out.pipeline.answers
    checks = {
        "features (128, 1024, 14, 14) float32, finite": (
            tuple(grid.shape) == (PREP_BATCH, 1024, 14, 14) and grid.dtype == torch.float32
            and bool(torch.isfinite(grid).all())),
        "three runs: the pipeline, the chains, the chains gated by the map": (
            [r["name"] for r in out.runs]
            == ["pipeline", "chains", "chains, per-function thresholds"]),
        "K2 3 and K1 2 launches per forward in each run, every forward in a run": (
            all(per_forward_ok(c_, exe_cfg) for c_ in runs)
            and sum(c_["forwards"] for c_ in runs) == total["forwards"]
            and total["K2"] == launches["fused_encoder_block"]
            and total["K1"] == launches["fused_attention"]),
        "one answer per question in the token vocabulary, accuracy in [0, 1]": (
            answers.shape == (len(questions),) and 0 <= answers.min()
            and answers.max() < exe_cfg.token_classes and out.accuracy is not None
            and 0 <= out.accuracy["overall"] <= 1),
        "a per-step tally of the annotated functions, no chain cut": (
            len(out.payload["per_function_box_pr"]) > 0
            and out.payload["truncated_gt_programs"] == 0),
    }
    say(f"phase 19.3 run_tally on the extracted features of {PREP_BATCH} images ((128, 196, 1024) "
        f"tokens, |x| up to {float(tokens.abs().max()):.3g}), {len(questions)} CLEVR-factory "
        f"questions ({int(chains.num_steps.sum())} steps), executor_roi bf16, sorted, "
        f"per-function calibration: {tally_s:.3f} s ("
        + ", ".join(f"{r['name']} {r['seconds']:.3f} s, {c_['forwards']} forwards"
                    for r, c_ in zip(out.runs, runs))
        + f"); launches {launches}; accuracy {out.accuracy['overall']:.3f}; map "
        f"{ {k: round(v, 2) for k, v in sorted(out.conf_threshold.items())} }")
    for name, ok in checks.items():
        if not ok:
            fail(f"phase 19.3 check failed: {name}")
    del generator, executor

    trained_cfg, trained_state = trained
    exe32 = ProgramExecutor(trained_cfg, torch.float32, device=dev)
    exe32.load_state_dict(trained_state)
    cpu32 = copy.deepcopy(exe32).to("cpu")
    sub = records[:FP32_QUESTIONS]
    sub_chains = chain_arrays(sub, fv)

    def first_run(model, device, feats_t):
        run_out = run_chains(ExecutorChainRunner(model, trained_cfg, 28, device=device), feats_t,
                             sub_chains, "sorted")
        return run_out, calibrate_chain_conf_thresholds_per_function(run_out, sub, fv, vv)[0]

    card_out, card_map = first_run(exe32, dev, tokens)
    cpu_out, cpu_map = first_run(cpu32, torch.device("cpu"), tokens.cpu())
    decisions = all(np.array_equal(card_out[k], cpu_out[k])
                    for k in ("box_mask", "token_branch", "token_cache"))
    box_err = max(float(np.abs(card_out[k] - cpu_out[k]).max()) for k in ("box_cache",
                                                                        "conf_cache"))
    hits = [int(np.sum(_collect_chain_detections(o, sub, fv, vv, 0.5, 28)[1]))
            for o in (card_out, cpu_out)]
    conf = cpu_out["conf_cache"][cpu_out["conf_cache"] > 0]
    say(f"phase 19.3 fp32 run_chains + per-function calibration with phase 12's trained executor "
        f"on {FP32_QUESTIONS} questions ({int(sub_chains.num_steps.sum())} steps) over the "
        f"extracted features, card vs CPU: decisions {'equal' if decisions else 'DIFFER'} "
        f"({int(card_out['box_mask'].sum())} confident boxes, "
        f"{int(card_out['token_branch'].sum())} token steps; the confidence nearest 0.5 is "
        f"{float(np.abs(conf - 0.5).min()) if conf.size else float('nan'):.2e} from it), boxes "
        f"and confidences within {box_err:.3g} (tol 1e-4); {hits[0]} true positives on the "
        f"card, {hits[1]} on the CPU; maps {'equal' if card_map == cpu_map else 'DIFFER'}: "
        f"{ {k: round(v, 2) for k, v in sorted(card_map.items())} }; "
        f"{time.perf_counter() - t0:.1f} s for 19.3")
    if not (decisions and box_err <= 1e-4):
        fail("phase 19.3: the float32 chain run on the card disagrees with the CPU")
    if card_map != cpu_map:
        confs, _tps, fns, _gt = _collect_chain_detections(cpu_out, sub, fv, vv, 0.5, 28)
        confs, fns = np.asarray(confs), np.asarray(fns)
        for fn in sorted(set(card_map) | set(cpu_map)):
            if card_map.get(fn) == cpu_map.get(fn):
                continue
            pick = np.ones(len(fns), bool) if fn == "__global__" else fns == fn
            thresholds = np.asarray([t for t in (card_map.get(fn), cpu_map.get(fn)) if t])
            near = confs[pick][np.abs(confs[pick][:, None] - thresholds[None]).min(1) < 1e-4]
            say(f"phase 19.3 map entry {fn}: card {card_map.get(fn)}, CPU {cpu_map.get(fn)}; "
                f"confidences within 1e-4 of them: {near.tolist()}")
            if not len(near):
                fail(f"phase 19.3: the threshold maps differ at {fn} with no confidence near "
                     f"the thresholds")
    del exe32, cpu32, grid, tokens
    torch.cuda.empty_cache()
    say(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return {"data_prep_tally": launches}


def k2_at_iqap_shape(torch, dev, results: dict, shape=None, key: str = "K2_bf16_iqap",
                     label: str = "the IQAP shape") -> None:
    """Phase 3 and 4 for K2 at a d 512 encoder shape of a model that runs it,
    bf16, no mask: by default the Transformer IQAP's (``K2_IQAP_SHAPE``:
    B=64, L=1+196+46=243), else ``shape`` (B, L) (``HierarchicalGenerator``'s,
    ``K2_HIER_SHAPE``): against its plain version (phase 3's rule), timed
    beside it, one ``nn.TransformerEncoderLayer`` call and its bound, kept
    under ``results[key]``."""
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
        fused_encoder_block,
        fused_encoder_block_plain,
    )

    b, length = shape or K2_IQAP_SHAPE
    d, h, ffn = 512, 4, 2048
    _keep, w, x = block_inputs(torch, dev, 3, length, torch.bfloat16, batch=b)
    out = fused_encoder_block(x, None, w, h)
    ref = fused_encoder_block_plain(x, None, w, h)
    stats = bf16_agreement(torch, out, ref)
    err = float((out.float() - ref.float()).abs().max())
    say(f"phase 3 K2 fused_encoder_block bf16 at {label} B={b} L={length} d={d} H={h} "
        f"ffn={ffn} mask=none: {bf16_text(stats)}")
    if not bf16_ok(stats):
        fail(f"K2 disagrees with its plain version at {label}")
    layer = library_layer(torch, w, d, h, ffn, torch.bfloat16)

    def library():
        with torch.no_grad():
            return layer(x)

    ms = timed_ms(torch, lambda: fused_encoder_block(x, None, w, h), iters=10)
    plain = timed_ms(torch, lambda: fused_encoder_block_plain(x, None, w, h), iters=10)
    lib = timed_ms(torch, library, iters=10)
    rows = b * length
    gemm_ops = rows * (2.0 * d * 3 * d + 2 * d * d + 4 * d * ffn)
    attn_ops = 4.0 * b * h * length * length * (d // h)
    ops = dot_ops("bf16", gemm_ops)
    for kind, count in dot_ops("fp32", attn_ops).items():
        ops[kind] = ops.get(kind, 0.0) + count
    nbytes = (2 * rows * d * 2 + (4 * d * d + 2 * d * ffn) * 2 + (3 * d + d + ffn + d + 4 * d) * 4)
    bnd, by = bound_ms(ops, nbytes)
    say(f"phase 4 K2 fused_encoder_block bf16 at {label} (B={b}, L={length}, no mask): "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms, nn.TransformerEncoderLayer {lib:.3f} ms, "
        f"bound {bnd:.4f} ms ({by}), {(gemm_ops + attn_ops) / ms / 1e9:.1f} TFLOP/s")
    results[key] = dict(shape=f"B={b} L={length} d={d} no mask", max_abs_err=err,
                                   ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                   library_ms=lib)
    del layer, x, out, ref, w


def library_layer(torch, w, d: int, h: int, ffn: int, dtype):
    """``nn.TransformerEncoderLayer`` (post-LN, ReLU, eps 1e-6) holding a
    block's weights ``w``, in ``dtype`` on their device: the library call
    that computes K2's function."""
    layer = torch.nn.TransformerEncoderLayer(
        d, h, ffn, dropout=0.0, activation="relu", batch_first=True, norm_first=False,
        layer_norm_eps=1e-6).eval()
    with torch.no_grad():
        layer.self_attn.in_proj_weight.copy_(w.qkv.float())
        layer.self_attn.in_proj_bias.copy_(w.qkv_bias)
        layer.self_attn.out_proj.weight.copy_(w.out.float())
        layer.self_attn.out_proj.bias.copy_(w.out_bias)
        layer.linear1.weight.copy_(w.ffn1.float())
        layer.linear1.bias.copy_(w.ffn1_bias)
        layer.linear2.weight.copy_(w.ffn2.float())
        layer.linear2.bias.copy_(w.ffn2_bias)
        layer.norm1.weight.copy_(w.ln1_scale)
        layer.norm1.bias.copy_(w.ln1_bias)
        layer.norm2.weight.copy_(w.ln2_scale)
        layer.norm2.bias.copy_(w.ln2_bias)
    return layer.to(device=w.qkv.device, dtype=dtype)


# ---------------------------------------------------------------------------
# phase 20: the last module slice
# ---------------------------------------------------------------------------


NATIVE_ROUNDS = 5  # phase 20.1's alternating timing rounds


def native_engine(np, results: dict) -> None:
    """Phase 20.1: the native CLEVR engine (``clevr/native.py``, g++ at first
    use; phase 2 built it and timed the build) on phase 17's 512 CLEVR-factory
    questions over 128 scenes: each question's outputs and relevant-object
    sets through the engine (``annotate._execute_with_poisoning``) and
    through the Python executor (``annotate._execute_python``) must be
    equal, and the engine must have run every program.  Both are timed over
    all the questions in ``NATIVE_ROUNDS`` rounds that alternate which goes
    first, with the engine's packing (scene and program), C call and
    decoding timed apart in a third pass of each round, and the batched
    call (one per scene, packing outside) beside them; medians, as totals
    for all the questions and per question."""
    from explainable_spatial_vqa_tpu_torch.clevr import annotate as ann
    from explainable_spatial_vqa_tpu_torch.clevr import native
    from explainable_spatial_vqa_tpu_torch.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu_torch.clevr.scenes import Scene

    scenes_raw, questions = syn.synthesize_dataset(BASELINE_SCENES, 4, seed=17, hop_prob=0.5,
                                                   chain_prob=0.5)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    runs = [(scenes[q["image_index"]], q["program"]) for q in questions]
    t0 = time.perf_counter()
    if not native.native_available():  # loads the library built in phase 2
        fail("phase 20.1: the native engine did not load")
    load_s = time.perf_counter() - t0

    def engine():
        return [ann._execute_with_poisoning(scene, program) for scene, program in runs]

    def python():
        return [ann._execute_python(scene, program) for scene, program in runs]

    def engine_parts():
        """execute_native's own timing of its three parts, each summed over
        the programs the engine runs: packing, the C call, decoding."""
        native.execute_native.parts = [0.0, 0.0, 0.0]
        try:
            engine()
            return native.execute_native.parts
        finally:
            native.execute_native.parts = None

    def timed(fn):
        t0 = time.perf_counter()
        value = fn()
        return value, time.perf_counter() - t0

    native.execute_native.programs = 0
    native_s, python_s, parts = [], [], []
    for r in range(NATIVE_ROUNDS):
        for which in (("engine", "python") if r % 2 else ("python", "engine")):
            if which == "engine":
                on_engine, seconds = timed(engine)
                native_s.append(seconds)
                if r == 0:
                    programs = native.execute_native.programs
            else:
                on_python, seconds = timed(python)
                python_s.append(seconds)
        parts.append(engine_parts())
    by_scene = {}
    for scene, program in runs:
        by_scene.setdefault(scene.image_index, (scene, []))[1].append(program)
    packed = [(native.PackedScene(scene), [native.pack_program(p) for p in progs])
              for scene, progs in by_scene.values()]
    t0 = time.perf_counter()
    for scene_packed, steps in packed:
        native.execute_batch_native(scene_packed, steps)
    batch_s = time.perf_counter() - t0
    equal = sum(a == b for a, b in zip(on_engine, on_python))
    n = len(runs)
    engine_med, python_med = statistics.median(native_s), statistics.median(python_s)
    pack_med, call_med, decode_med = (statistics.median(p[i] for p in parts) for i in range(3))
    say(f"phase 20.1 native engine: g++ build {results['native_build_s']:.2f} s (phase 2), "
        f"load {load_s * 1e3:.1f} ms; "
        f"{n} CLEVR-factory questions over {len(scenes)} scenes, {programs} programs on "
        f"the engine; outputs and relevant-object sets equal to the Python executor's on "
        f"{equal} of {n}; medians of {NATIVE_ROUNDS} alternating rounds, for all {n} "
        f"questions (per question): engine {engine_med * 1e3:.2f} ms "
        f"({engine_med / n * 1e3:.4f}), Python {python_med * 1e3:.2f} ms "
        f"({python_med / n * 1e3:.4f}), {python_med / engine_med:.2f}x; the engine's parts: "
        f"packing {pack_med * 1e3:.2f} ms, C call {call_med * 1e3:.2f} ms, decoding "
        f"{decode_med * 1e3:.2f} ms; every round, ms: engine "
        f"{', '.join(f'{t * 1e3:.2f}' for t in native_s)}, Python "
        f"{', '.join(f'{t * 1e3:.2f}' for t in python_s)}; batched, one call per scene "
        f"(packing outside): {batch_s * 1e3:.3f} ms ({python_med / batch_s:.1f}x)")
    if programs == 0:
        fail("phase 20.1: no program ran on the native engine")
    if equal != n:
        fail("phase 20.1: the native engine disagrees with the Python executor")


def dp_executor_config(seed: int, dtype: str):
    """Phase 20's data-parallel training configuration: ``executor_roi`` at
    full width and its preset's batch, computing in ``dtype`` and without
    dropout (two ranks' dropout draws are not one process's), from
    ``seed``."""
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset

    cfg = get_preset("executor_roi")
    return cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0),
                       train=dataclasses.replace(cfg.train, dtype=dtype, seed=seed,
                                                 num_epochs=1, log_every=0))


DP_DTYPES = ("float32", "float64")  # compute types of phase 20's data-parallel steps


def dp_batch(np, cfg):
    """(step arrays, features, one batch of the preset's size): phase 12's
    synthetic executor steps, the batch ordered so that the two halves hold
    different counts of box rows and of target boxes."""
    from explainable_spatial_vqa_tpu_torch.bench_data import synth_executor_steps

    arrays, features = synth_executor_steps(EXECUTOR_ROWS, cfg.model, seed=12)
    box = np.flatnonzero(arrays["is_box_branch"])
    token = np.flatnonzero(~arrays["is_box_branch"])
    half = cfg.train.batch_size // 2
    idx = np.concatenate([box[:half - 1], token[:1], box[half - 1:half + 3], token[1:half - 3]])
    batch = {k: v[idx] for k, v in arrays.items()}
    batch["image"] = features[batch["image_index"]]
    return arrays, features, batch


def step_agreement(torch, model, got_loss, grads, ref: dict) -> dict:
    """A data-parallel step's loss, gradients and parameters against one
    process's (``ref``): the loss's relative error, the gradients' largest
    error over max|g|, the parameters' over max|p| (the attention's key
    biases apart: their exact gradient is 0, so Adam's first step, g / (|g|
    + eps), moves them by rounding noise scaled up to the learning rate in
    either run), and those biases' largest move apart."""
    state = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    key_bias = {k for k in state if k.endswith("attn.k.bias")}
    g_scale = max(float(g.abs().max()) for g in ref["grads"].values())
    p_scale = max(float(v.abs().max()) for v in ref["state"].values())
    g_err = {k: float((grads[k].float().cpu() - g).abs().max()) for k, g in ref["grads"].items()}
    p_err = {k: float((state[k] - v).abs().max()) for k, v in ref["state"].items()
             if k not in key_bias}
    g_worst, p_worst = max(g_err, key=g_err.get), max(p_err, key=p_err.get)
    return dict(
        loss=got_loss, ref_loss=ref["loss"],
        loss_rel=abs(got_loss - ref["loss"]) / abs(ref["loss"]),
        grad_rel=g_err[g_worst] / g_scale, grad_worst=g_worst,
        grad_worst_scale=float(ref["grads"][g_worst].abs().max()) / g_scale,
        param_rel=p_err[p_worst] / p_scale, param_worst=p_worst,
        key_bias_apart=max(float((state[k] - ref["state"][k]).abs().max()) for k in key_bias),
        key_bias_grad=max(float(ref["grads"][k].abs().max()) for k in key_bias) / g_scale)


def step_ok(found: dict, lr: float) -> bool:
    return (found["loss_rel"] <= 1e-6 and found["grad_rel"] <= 1e-6
            and found["param_rel"] <= 1e-6 and found["key_bias_apart"] <= 2 * lr)


def step_text(found: dict) -> str:
    return (f"loss {found['loss']:.7f} vs {found['ref_loss']:.7f} (rel {found['loss_rel']:.2e}, "
            f"tol 1e-6); gradients within {found['grad_rel']:.2e} of max|g| (at "
            f"{found['grad_worst']}, whose max|g| is {found['grad_worst_scale']:.2e} of the "
            f"largest), parameters within {found['param_rel']:.2e} of max|p| (at "
            f"{found['param_worst']}); the key biases (gradient {found['key_bias_grad']:.1e} of "
            f"max|g|) apart by {found['key_bias_apart']:.2e}")


def serving_inputs(torch, np, dev):
    """Phase 6's serving inputs at bench.py's widths: the executor config,
    per-function thresholds, per-image features on the card and the
    synthetic chains of ``MAIN_QUESTIONS`` questions."""
    from explainable_spatial_vqa_tpu_torch.bench_data import synth_questions
    from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig

    exe_cfg = ExecutorConfig(vocab_size=64, token_classes=32, box_roi=True)
    thresholds = np.random.RandomState(3).uniform(0.3, 0.7, exe_cfg.vocab_size).astype(np.float32)
    features, questions, chains = synth_questions(MAIN_QUESTIONS, exe_cfg, max_steps=27, seed=0)
    return exe_cfg, thresholds, torch.from_numpy(features).to(dev), questions, chains


DECISIONS = ("token_branch", "token_cache", "box_mask")


def decision_differences(np, out: dict, ref: dict, thresholds, chains) -> list:
    """Each chain whose decisions differ between two pool runs: (row, first
    differing step, what differs, the reference's margin there: |conf -
    threshold| of the nearest box decision, or None for a routing or token
    decision, whose logits a run does not keep)."""
    found = []
    differ = np.zeros(out["token_branch"].shape, bool)
    for k in DECISIONS:
        d = out[k] != ref[k]
        differ |= d.reshape(d.shape[0], d.shape[1], -1).any(-1)
    for row in np.flatnonzero(differ.any(1)):
        step = int(np.flatnonzero(differ[row])[0])
        what = [k for k in DECISIONS
                if np.any(np.asarray(out[k][row, step]) != np.asarray(ref[k][row, step]))]
        margin = None
        if what == ["box_mask"]:
            thr = thresholds[chains.functions[row, step]]
            margin = float(np.abs(ref["conf_cache"][row, step] - thr).min())
        found.append((int(row), step, what, margin))
    return found


def last_slice(torch, np, dev, counted, results) -> dict:
    """Phase 20, the last module slice, on the card:

    - 20.1 ``native_engine``;
    - 20.2 one rank over NCCL (``parallel.multihost.initialize`` on a free
      localhost port, one process): the data-parallel ``Trainer`` step of
      ``executor_roi`` at full width and its batch of 16, float32, against
      the plain ``Trainer``'s step taken before the group existed
      (``step_agreement``), and its validation forward (K2 3 and K1 2
      launches); ``run_pool`` on a one-rank mesh at bench.py's widths on
      ``MAIN_QUESTIONS`` questions in bf16 and float32, decisions equal to
      the unsharded ``run_pool``'s, K2 3 and K1 2 launches per forward, both
      timed; ``run_tally`` (sorted mode is the CLI's; here the pool) through
      ``--data_parallel``'s ``_serve_mesh`` (one process: it warns and
      serves unsharded) and on the one-rank mesh, equal;
    - 20.3 two ranks sharing the card over gloo (``dp_rank``, this script
      started twice): the sharded float32 ``run_pool`` against 20.2's
      float32 decisions (differences listed with their margins), and one
      data-parallel step of 2 x 8 rows against 20.2's plain 16-row step;
    - 20.4 ``ops.lowp``'s serving opt-in: ``InferencePipeline.run`` (pool)
      on ``MAIN_QUESTIONS`` questions in bf16 with lowp off and on, in
      turns, questions/s as the median of ``REPEATS``, the share of equal
      answers and of equal per-step decisions, K2 and K1 launches per
      forward (equal either way);
    - 20.5 ``utils.profiling``: ``trace`` around a pipeline run and a pool
      run in ``annotate`` regions; the trace must name both regions and the
      ``esv::`` kernels; ``phase_report`` of the phase's timers.

    Returns the launches of each path, for the result line."""
    import argparse
    import tempfile

    import torch.distributed as dist

    from explainable_spatial_vqa_tpu_torch.bench_data import (
        FUNCTION_IDS,
        PROGRAM_TOKENS,
        postfix_ids as program_ids,
        synth_annotated,
        synth_generator_batch,
    )
    from explainable_spatial_vqa_tpu_torch.cli.main import _serve_mesh, run_tally
    from explainable_spatial_vqa_tpu_torch.core.config import GeneratorConfig, get_preset
    from explainable_spatial_vqa_tpu_torch.core.vocab import canonicalize
    from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
    from explainable_spatial_vqa_tpu_torch.infer.pipeline import InferencePipeline
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.ops import lowp
    from explainable_spatial_vqa_tpu_torch.parallel import multihost
    from explainable_spatial_vqa_tpu_torch.parallel.mesh import make_mesh
    from explainable_spatial_vqa_tpu_torch.train.datasets import chain_arrays
    from explainable_spatial_vqa_tpu_torch.train.pipelines import executor_pipeline_from_arrays
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer
    from explainable_spatial_vqa_tpu_torch.utils.profiling import (
        annotate,
        phase,
        phase_report,
        reset_phases,
        trace,
    )

    t_phase = time.perf_counter()
    reset_phases()
    by_path = {}
    native_engine(np, results)
    workdir = Path(tempfile.mkdtemp(prefix="phase20-"))

    # ---- 20.2 the plain references, before any process group ----
    cfg = dp_executor_config(0, "float32")
    arrays, features, batch = dp_batch(np, cfg)
    features = torch.from_numpy(features).to(dev)

    def dp_step(trainer, rows):
        acc = trainer.train_epoch([rows], seed=0, epoch=0)
        grads = {n: p.grad.detach().float().cpu() for n, p in trainer.model.named_parameters()
                 if p.grad is not None}
        return acc.totals["loss_sum"], grads

    def plain_trainer(dtype):
        config = dp_executor_config(0, dtype)
        pipe = executor_pipeline_from_arrays(config, arrays, features, device=dev)
        return Trainer(pipe.loss_fn, pipe.model, config.optim, config.train,
                       checkpoint_dir=False, device=dev)

    for dtype in DP_DTYPES:
        trainer = plain_trainer(dtype)
        loss, grads = dp_step(trainer, batch)
        reference = {"loss": loss, "grads": grads, "state": {
            k: v.detach().float().cpu() for k, v in trainer.model.state_dict().items()}}
        torch.save(reference, workdir / f"step_{dtype}.pt")
        # the same step on the same rows in reverse order: how far sums taken
        # in another order move one process's step
        trainer = plain_trainer(dtype)
        loss, grads = dp_step(trainer, {k: v[::-1].copy() for k, v in batch.items()})
        say(f"phase 20.2 the plain {dtype} step on its rows in reverse order, against the plain "
            f"step: {step_text(step_agreement(torch, trainer.model, loss, grads, reference))}")
    # a float32 forward on the 16 rows and on their two halves of 8: cuBLAS
    # takes other kernels at 8 x 210 rows than at 16 x 210, so the FFN's
    # ReLU inputs round otherwise and those within a rounding of 0 flip
    model = plain_trainer("float32").model.train()
    taken = []
    hooks = [blk.ffn.fc1.register_forward_hook(lambda _m, _i, o: taken.append(o.detach()))
             for blk in model.fusion.blocks]
    rows = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
    names_in = ("image", "input_boxes", "input_box_mask", "text", "text_mask")
    with torch.no_grad():
        model(*(rows[k] for k in names_in))
        half = len(batch["text"]) // 2
        for part in (slice(0, half), slice(half, None)):
            model(*(rows[k][part] for k in names_in))
    for h in hooks:
        h.remove()
    layers = len(model.fusion.blocks)
    whole, halves = taken[:layers], [torch.cat(p) for p in zip(taken[layers:2 * layers],
                                                               taken[2 * layers:])]
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(whole, halves))
    units = sum(a.numel() for a in whole)
    apart = max(float((a - b).abs().max()) for a, b in zip(whole, halves))
    say(f"phase 20.2 float32 train forward on the 16 rows against its two 8-row halves: FFN "
        f"inputs to ReLU apart by up to {apart:.2e}, {flips} of {units} on the other side of 0")
    del model, trainer

    exe_cfg, thresholds, feats_dev, questions, chains = serving_inputs(torch, np, dev)
    executors = {dt: init_parameters(ProgramExecutor(exe_cfg, dt, device=dev), seed=2)
                 for dt in (torch.bfloat16, torch.float32)}
    names = {torch.bfloat16: "bf16", torch.float32: "float32"}
    plain_pool = {}
    for dt, executor in executors.items():
        runner = ExecutorChainRunner(executor, exe_cfg, 27, thresholds, device=dev)
        runner.run_pool(feats_dev, chains)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_pool[dt] = (runner.run_pool(feats_dev, chains), time.perf_counter() - t0)
    np.savez(workdir / "pool_float32.npz", **plain_pool[torch.float32][0])

    # ---- 20.2 one rank over NCCL ----
    port = free_port()
    multihost.initialize(f"localhost:{port}", num_processes=1, process_id=0)
    try:
        mesh = make_mesh()
        say(f"phase 20.2 process group: {dist.get_backend()}, world {dist.get_world_size()}, "
            f"mesh {mesh}")
        pipe = executor_pipeline_from_arrays(cfg, arrays, features, device=dev)
        trainer = Trainer(pipe.loss_fn, pipe.model, cfg.optim, cfg.train, checkpoint_dir=False,
                          device=dev)
        if trainer.mesh is None or trainer.mesh.shape != {"data": 1}:
            fail(f"phase 20.2: the trainer took no mesh from the process group: {trainer.mesh}")
        with phase("20.2 data-parallel step"):
            loss, grads = dp_step(trainer, batch)
        found = step_agreement(torch, pipe.model, loss, grads,
                               torch.load(workdir / "step_float32.pt", weights_only=False))
        say(f"phase 20.2 data-parallel Trainer step, one rank, executor_roi float32 batch "
            f"{len(batch['text'])}, against the plain step: {step_text(found)}")
        if not (found["loss_rel"] == found["grad_rel"] == found["param_rel"] == 0.0):
            fail("phase 20.2: the one-rank data-parallel step differs from the plain step")
        log = ForwardLaunches(pipe.model)
        _acc, val_counts = counted(lambda: trainer.evaluate([batch]))
        log.remove()
        val = log.tally()
        say(f"phase 20.2 data-parallel validation: {val['forwards']} forward(s), launches "
            f"{val_counts}")
        if not per_forward_ok(val, pipe.model.config):
            fail("phase 20.2: the data-parallel validation forward missed K2 or K1")
        by_path["dp_validation"] = val_counts
        del pipe, trainer

        for dt, executor in executors.items():
            runner = ExecutorChainRunner(executor, exe_cfg, 27, thresholds, device=dev,
                                         mesh=mesh)
            runner.run_pool(feats_dev, chains)  # warm-up
            log = ForwardLaunches(executor)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, counts = counted(lambda: runner.run_pool(feats_dev, chains))
            mesh_s = time.perf_counter() - t0
            log.remove()
            c = log.tally()
            ref, plain_s = plain_pool[dt]
            equal = all(np.array_equal(out[k], ref[k]) for k in DECISIONS + ("final_tokens",))
            say(f"phase 20.2 run_pool on a one-rank mesh, {names[dt]}, {MAIN_QUESTIONS} "
                f"questions: {mesh_s:.3f} s against {plain_s:.3f} s unsharded; decisions "
                f"{'equal' if equal else 'DIFFER'}; {c['forwards']} forwards, launches {counts}")
            if not (equal and per_forward_ok(c, exe_cfg)
                    and c["K2"] == counts["fused_encoder_block"]):
                fail(f"phase 20.2: the one-rank mesh's {names[dt]} pool run differs or missed "
                     "a kernel")
            if dt == torch.bfloat16:
                by_path["dp_pool_one_rank"] = counts

        # run_tally through --data_parallel's path, in pool mode
        gen_cfg = get_preset("generator").model
        gen_questions, _p, _i = synth_generator_batch(MAIN_QUESTIONS, gen_cfg, seed=14)
        generator = init_parameters(ProgramGenerator(gen_cfg, torch.bfloat16, device=dev),
                                    seed=14)
        records, t_feats, fv, vv = synth_annotated(MAIN_QUESTIONS, exe_cfg, seed=16)
        t_chains = chain_arrays(records, fv)
        gt_programs = program_ids(t_chains, gen_cfg.program_len, start=True).astype(np.int32)
        gt_answers = np.asarray([vv[canonicalize(r["answer"])] for r in records])
        t_image = torch.from_numpy(t_feats).to(dev)
        serve_mesh = _serve_mesh(argparse.Namespace(data_parallel=True))

        def tally(mesh_):
            return run_tally(generator, executors[torch.bfloat16], exe_cfg, gen_questions,
                             t_image, t_chains.image_index, dict(enumerate(PROGRAM_TOKENS)),
                             fv, vv, gt_answers=gt_answers, programs=gt_programs,
                             annotated=records, chain_mode="pool",
                             calibrate_conf_per_function=True, device=dev, mesh=mesh_)

        plain_tally = tally(None)
        (served, served_counts) = counted(lambda: tally(serve_mesh))
        on_mesh, mesh_counts = counted(lambda: tally(mesh))
        same = all(
            np.array_equal(t.pipeline.answers, plain_tally.pipeline.answers)
            and t.conf_threshold == plain_tally.conf_threshold
            and t.payload["per_function_box_pr"] == plain_tally.payload["per_function_box_pr"]
            for t in (served, on_mesh))
        say(f"phase 20.2 run_tally (pool mode, per-function calibration) through "
            f"--data_parallel's _serve_mesh (one process: {serve_mesh}, served unsharded) and "
            f"on the one-rank mesh: {' + '.join('%.3f' % r['seconds'] for r in on_mesh.runs)} s; "
            f"answers, thresholds and box P/R {'equal' if same else 'DIFFER'} to unsharded; "
            f"launches {mesh_counts}")
        if not (same and serve_mesh is None and mesh_counts["fused_encoder_block"] > 0
                and mesh_counts["fused_attention"] > 0):
            fail("phase 20.2: run_tally on the mesh differs from unsharded or missed a kernel")
        by_path["dp_tally_one_rank"] = mesh_counts
        del generator, t_image
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- 20.3 two ranks sharing the card over gloo ----
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                               str(rank), str(port), str(workdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=DP_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        fail(f"phase 20.3: a rank ran past {DP_TIMEOUT} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, text) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            fail(f"phase 20.3: rank {rank} exited {proc.returncode}:\n{text[-3000:]}")
    reports = [json.loads((workdir / f"rank{rank}.json").read_text()) for rank in range(2)]
    for r in reports:
        diffs = r["differences"]
        say(f"phase 20.3 rank {r['rank']} of 2 (gloo, one card): sharded run_pool float32 on "
            f"{r['rows']} of {MAIN_QUESTIONS} questions in {r['pool_s']:.3f} s (one rank on the "
            f"card: {plain_pool[torch.float32][1]:.3f} s), {r['forwards']} forwards, launches "
            f"{r['counts']}; decisions against 20.2's: "
            + ("equal" if not diffs else f"{len(diffs)} chains differ: " + "; ".join(
                f"row {row} step {step} {what} margin "
                + ("not kept" if m is None else f"{m:.2e}") for row, step, what, m in diffs)))
        for dtype in DP_DTYPES:
            say(f"phase 20.3 rank {r['rank']}: data-parallel {dtype} step of {r['step_rows']} "
                f"rows ({r['box_rows']} box rows, {r['target_boxes']} target boxes) against "
                f"the 16-row step: {step_text(r['step_' + dtype])}")
    counts = {k: sum(r["counts"][k] for r in reports) for k in reports[0]["counts"]}
    if reports[0]["box_rows"] == reports[1]["box_rows"]:
        fail("phase 20.3: the ranks' halves hold equal counts of box rows")
    for r in reports:
        near = all(what == ["box_mask"] and m is not None and m < 1e-5
                   for _row, _step, what, m in r["differences"])
        # float32: the loss; float64 (no ReLU input lies within its rounding
        # of 0 at either batch shape): the loss, gradients and parameters
        if not (near and r["per_forward_ok"] and r["step_float32"]["loss_rel"] <= 1e-6
                and step_ok(r["step_float64"], cfg.optim.learning_rate)):
            fail(f"phase 20.3: rank {r['rank']} disagrees with one process beyond a near-tie, or "
                 "missed a kernel")
    by_path["dp_pool_two_ranks"] = counts

    # ---- 20.4 lowp serving ----
    gen_cfg = GeneratorConfig(vocab_size=96, program_vocab_size=45, program_len=27)
    generator = init_parameters(ProgramGenerator(gen_cfg, torch.bfloat16, device=dev), seed=1)
    idx_to_token = dict(enumerate(["<NULL>", "<START>", "<END>"] + sorted(FUNCTION_IDS)))
    token_ids = {t: i for i, t in idx_to_token.items()}
    scripted = postfix_ids(chains, token_ids, FUNCTION_IDS, gen_cfg.program_len)
    executor = executors[torch.bfloat16]
    runner = ExecutorChainRunner(executor, exe_cfg, 27, thresholds, device=dev)
    pipeline = InferencePipeline(scripted_programs(torch, generator, scripted), runner,
                                 idx_to_token, FUNCTION_IDS, device=dev)

    def serve():
        return pipeline.run(questions, feats_dev, chains.image_index, chain_mode="pool")

    seconds = {False: [], True: []}
    answers, steps, counts, per_forward = {}, {}, {}, {}
    try:
        for on in (False, True):
            lowp.use_lowp_serving(on)
            serve()  # warm-up
            log = ForwardLaunches(executor)
            answers[on], counts[on] = counted(serve)
            log.remove()
            c = log.tally()
            per_forward[on] = (c["K2"] / c["forwards"], c["K1"] / c["forwards"])
            steps[on] = runner.run_pool(feats_dev, chains)
        for _ in range(REPEATS):
            for on in (False, True):
                lowp.use_lowp_serving(on)
                with phase(f"20.4 pipeline run, lowp {'on' if on else 'off'}"):
                    t0 = time.perf_counter()
                    serve()
                    seconds[on].append(time.perf_counter() - t0)
    finally:
        lowp.use_lowp_serving(False)
    qps = {on: MAIN_QUESTIONS / statistics.median(s) for on, s in seconds.items()}
    same_answers = float(np.mean((answers[True].answers == answers[False].answers)
                                 & (answers[True].answer_valid == answers[False].answer_valid)))
    active = np.arange(steps[False]["token_branch"].shape[1])[None] < chains.num_steps[:, None]
    same_steps = {k: float(np.mean(np.all(
        (steps[True][k] == steps[False][k]).reshape(*active.shape, -1), -1)[active]))
        for k in DECISIONS}
    say(f"phase 20.4 lowp serving, InferencePipeline.run (pool) on {MAIN_QUESTIONS} questions, "
        f"bf16, median of {REPEATS} in turns: off {qps[False]:.1f} questions/s, on "
        f"{qps[True]:.1f} ({qps[True] / qps[False] - 1:+.1%}); runs off "
        f"{', '.join(f'{t:.3f}' for t in seconds[False])} s, on "
        f"{', '.join(f'{t:.3f}' for t in seconds[True])} s; answers equal on {same_answers:.4f}; "
        f"per-step decisions equal on " + ", ".join(f"{k} {v:.4f}" for k, v in same_steps.items())
        + f"; K2, K1 per forward off {per_forward[False]}, on {per_forward[True]}; launches "
        f"off {counts[False]}, on {counts[True]}")
    if not (per_forward[True] == per_forward[False]
            == (exe_cfg.encoder_layers, exe_cfg.box_decoder_layers)):
        fail("phase 20.4: lowp changed the kernels' launches per forward")
    by_path["lowp_serving"] = counts[True]

    # ---- 20.5 the profiler ----
    trace_dir = workdir / "trace"
    with phase("20.5 traced pipeline and pool runs"):
        t0 = time.perf_counter()
        with trace(str(trace_dir)) as trace_path:
            with annotate("phase20.pipeline_run"):
                serve()
            with annotate("phase20.run_pool"):
                runner.run_pool(feats_dev, chains)
            torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    event_names = {e.get("name", "") for e in events}
    ours = sorted({n.split("(")[0][:60] for n in event_names if "esv::" in n})
    regions = {"phase20.pipeline_run", "phase20.run_pool"} & event_names
    size_mb = Path(trace_path).stat().st_size / 1e6
    untraced = statistics.median(seconds[False]) + plain_pool[torch.bfloat16][1]
    say(f"phase 20.5 trace: {Path(trace_path).name}, {size_mb:.1f} MB, {len(events)} events "
        f"in {traced_s:.3f} s (the two runs untraced: {untraced:.3f} s); regions "
        f"{sorted(regions)}; esv:: kernels {ours}")
    if len(regions) != 2 or not ours:
        fail("phase 20.5: the trace misses an annotated region or the esv:: kernels")
    for line in phase_report().splitlines():
        say(f"phase 20.5 {line}")
    shutil.rmtree(workdir)
    say(f"phase 20 done in {time.perf_counter() - t_phase:.1f} s")
    return by_path



# phase 21: the matcher kernel and the demos
MATCHER_SHAPES = ((10, 10), (8, 8), (10, 4), (7, 10), (12, 5))  # (Q, T)
MATCHER_PROBLEMS = 2048  # per shape: 10,240 in all
MATCHER_TIMED = ((64, 8, 8), (16, 10, 10), (128, 10, 10), (2560, 10, 10))  # (B, Q, T)
MATCHER_COST_TOL = 1e-5  # matched cost against scipy's optimum, relative: float32 potentials
# the block kernel (m + 1 > 32): (Q, T, problems) held against the plain
# version, with NaNs among the costs; then (B, Q, T) timed and held again
# (the timed call of the plain version gives the reference: at 300 columns
# one takes ~30 s, as it waits on the card at every step); a shape held
# once more with its state in global memory (the shared-memory cap set to 0)
BLOCK_MATCHER_SHAPES = ((32, 32, 192), (33, 12, 192), (12, 40, 192), (64, 64, 96))
BLOCK_MATCHER_TIMED = ((64, 32, 32), (64, 100, 100), (2, 300, 300))
BLOCK_MATCHER_GLOBAL = (64, 64)
WIDE_QUERIES = 40  # 21.2's executor_roi step past the warp kernel's 31 columns
STEP_ROUNDS = 3  # alternating timing rounds of 21.2's two matchers
STEPS_PER_ROUND = 5
# 21.3: the accuracy table at d 512 (K2 and K1 in its chain runs) and each
# other demo once, at sizes cut to keep the script within its time limit
DEMO_D512 = dict(DEMO_SCENES="40", DEMO_QPS="4", DEMO_GEN_STEPS="30", DEMO_EXE_STEPS="30",
                 DEMO_DMODEL="512", DEMO_LAYERS="3", DEMO_LR_SCHEDULE="cosine")
DEMO_SMALL = {
    "end_to_end": dict(DEMO_SCENES="20", DEMO_GEN_STEPS="15", DEMO_EXE_STEPS="15"),
    "data_efficiency": {},  # no knobs: its STEPS is cut below
    "executor_data_efficiency": dict(DEMO_SCENES="20", DEMO_QPS="3", DEMO_SIZES="10,40",
                                     DEMO_EXE_STEPS="15"),
    "scheduled_sampling": dict(DEMO_SCENES="12", DEMO_GEN_STEPS="10", DEMO_EXE_STEPS="10"),
    "scheduled_stats": dict(DEMO_SEEDS="2", DEMO_SCENES="8", DEMO_GEN_STEPS="6",
                            DEMO_EXE_STEPS="6", DEMO_EVAL_SCENES="4", DEMO_EVAL_QPS="3"),
    "scheduled_at_scale": dict(DEMO_SEEDS="2", DEMO_SCENES="8", DEMO_GEN_STEPS="6",
                               DEMO_EXE_STEPS="6", DEMO_EVAL_SCENES="4", DEMO_DMODEL="96",
                               DEMO_LAYERS="2"),
    "diag_box_roi": dict(DIAG_SCENES="20", DIAG_QPS="3", DIAG_STEPS="15"),
    "diag_roi_sim": dict(DIAG_SCENES="20", DIAG_QPS="3", DIAG_STEPS="15"),
    "diag_count_embed": dict(DIAG_SCENES="20", DIAG_QPS="3", DIAG_STEPS="15"),
}
DEMO_DATA_EFFICIENCY_STEPS = 10


def matcher_problems(np, seed: int, q: int, t: int, n: int):
    """``n`` problems at (Q, T): the first half of costs uniform in [0, 30),
    the second integers in {0, 1, 2} (many tied optima); masks empty on
    every 8th problem, full on the next, scattered otherwise."""
    rng = np.random.RandomState(seed)
    cost = (rng.rand(n, q, t) * 30.0).astype(np.float32)
    cost[n // 2:] = rng.randint(0, 3, (n - n // 2, q, t))
    mask = rng.rand(n, t) < rng.rand(n, 1)
    mask[0::8] = False
    mask[1::8] = True
    return cost, mask


def block_matcher_problems(np, seed: int, q: int, t: int, n: int):
    """``n`` problems at (Q, T) for the block kernel: a third of the costs
    uniform in [0, 30), a third integers in {0, 1, 2} (tied optima), a third
    such integers with 1% NaN; masks as ``matcher_problems``'s; and which
    problems hold a NaN."""
    cost, mask = matcher_problems(np, seed, q, t, n)
    rng = np.random.RandomState(seed + 1)
    third = n // 3
    cost[third:] = rng.randint(0, 3, (n - third, q, t))
    nan = np.zeros(n, bool)
    nan[2 * third:] = True
    cost[2 * third:][rng.rand(n - 2 * third, q, t) < 0.01] = np.nan
    return cost, mask, nan & np.isnan(cost).any((1, 2))


def matched_costs(np, cost, assign):
    """Each problem's matched cost in float64: the sum of cost[q, assign[q]]
    over its matched queries."""
    rows = np.arange(cost.shape[1])
    picked = cost[np.arange(len(cost))[:, None], rows, np.clip(assign, 0, None)]
    return np.where(assign >= 0, picked.astype(np.float64), 0.0).sum(1)


def matcher_kernel(torch, np, dev) -> tuple:
    """Phase 21.1: ``csrc/hungarian.cu`` against its plain version on the
    card on ``MATCHER_PROBLEMS`` problems at each of ``MATCHER_SHAPES``
    (assignments equal, and each matched cost equal to scipy's optimum
    within ``MATCHER_COST_TOL``); a call under
    ``torch.cuda.set_sync_debug_mode("error")`` (the host matcher under it
    must raise, the control); times by CUDA events at ``MATCHER_TIMED``
    beside the plain version, scipy's host round trip and the bytes bound;
    then the block kernel (:func:`block_matcher_kernel`).  Returns the warp
    kernel's kernels-line entry at the demos' shape (B=64, Q=T=8) with the
    others under ``at_shapes``, and the block kernel's."""
    from explainable_spatial_vqa_tpu_torch.ops.matching import (
        hungarian_assignment,
        hungarian_assignment_device,
        hungarian_assignment_device_plain,
    )

    t0 = time.perf_counter()
    problems = differ_scipy = 0
    worst_gap = worst_index = 0.0
    mismatched = []
    for shape_i, (q, t) in enumerate(MATCHER_SHAPES):
        cost, mask = matcher_problems(np, 2100 + shape_i, q, t, MATCHER_PROBLEMS)
        c, m = torch.from_numpy(cost).to(dev), torch.from_numpy(mask).to(dev)
        got = hungarian_assignment_device(c, m).cpu().numpy()
        ref = hungarian_assignment_device_plain(c, m).cpu().numpy()
        host = hungarian_assignment(c, m).cpu().numpy()
        bad = np.flatnonzero((got != ref).any(1))
        mismatched += [(q, t, int(b)) for b in bad[:3]]
        worst_index = max(worst_index, float(np.abs(got - ref).max()))
        optimum = matched_costs(np, cost, host)
        gap = np.abs(matched_costs(np, cost, got) - optimum) / np.maximum(1.0, optimum)
        worst_gap = max(worst_gap, float(gap.max()))
        same_count = np.array_equal((got >= 0).sum(1), (host >= 0).sum(1))
        if not same_count:
            fail(f"phase 21.1: the kernel matches another number of queries than scipy at {q}x{t}")
        problems += len(cost)
        differ_scipy += int((got != host).any(1).sum())
    say(f"phase 21.1 matcher kernel against its plain version on the card: {problems} problems "
        f"at (Q, T) {MATCHER_SHAPES}, half with integer costs in {{0, 1, 2}}: assignments "
        f"{'equal' if not mismatched else f'DIFFER {mismatched}'} (max index difference "
        f"{worst_index:g}); matched cost against scipy's optimum within {worst_gap:.3g} relative "
        f"(tol {MATCHER_COST_TOL}); scipy picks another optimal assignment on {differ_scipy} of "
        f"them (ties); {time.perf_counter() - t0:.1f} s")
    if mismatched or not worst_gap <= MATCHER_COST_TOL:
        fail("phase 21.1: the matcher kernel disagrees with its plain version or scipy's optimum")
    block = block_matcher_kernel(torch, np, dev)

    # no host synchronisation in a call of either kernel; scipy's round trip
    # is the control
    cost, mask = matcher_problems(np, 2199, 10, 10, 128)
    c, m = torch.from_numpy(cost).to(dev), torch.from_numpy(mask).to(dev)
    wide = [torch.from_numpy(a).to(dev) for a in block_matcher_problems(np, 2198, 300, 300, 4)[:2]]
    hungarian_assignment_device(c, m)
    hungarian_assignment_device(*wide)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hungarian_assignment_device(c, m)
        hungarian_assignment_device(*wide)
        try:
            hungarian_assignment(c, m)
            control = "did NOT raise"
        except RuntimeError:
            control = "raised"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    say(f"phase 21.1 under set_sync_debug_mode('error'): hungarian_assignment_device made no "
        f"host synchronisation at Q=T=10 (the warp kernel) or Q=T=300 (the block kernel); the "
        f"control, scipy's hungarian_assignment, {control}")
    if control != "raised":
        fail("phase 21.1: the sync check cannot see a host synchronisation")

    rows = {}
    for b, q, t in MATCHER_TIMED:
        cost, mask = matcher_problems(np, 2200 + b, q, t, b)
        c, m = torch.from_numpy(cost).to(dev), torch.from_numpy(mask).to(dev)
        ms = timed_ms(torch, lambda: hungarian_assignment_device(c, m), iters=200, warmup=10)
        plain = timed_ms(torch, lambda: hungarian_assignment_device_plain(c, m), iters=3,
                         warmup=1)
        scipy_ms = timed_ms(torch, lambda: hungarian_assignment(c, m), iters=10, warmup=2)
        got = hungarian_assignment_device(c, m)
        err = float((got - hungarian_assignment_device_plain(c, m)).abs().max())
        nbytes = b * q * t * 4 + b * t + b * q * 8
        bnd, by = bound_ms({}, nbytes)
        say(f"phase 21.1 matcher B={b} Q={q} T={t}: kernel {ms:.4f} ms through the wrapper, "
            f"plain {plain:.3f} ms, scipy's host round trip {scipy_ms:.3f} ms (no PyTorch call "
            f"computes it), bound {bnd:.6f} ms ({by}, {nbytes} bytes)")
        rows[(b, q, t)] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                               library_ms=None, scipy_round_trip_ms=scipy_ms)
    main_shape = rows.pop(MATCHER_TIMED[0])
    main_shape["at_shapes"] = {f"B{b}_Q{q}_T{t}": r for (b, q, t), r in rows.items()}
    return main_shape, block


def block_matcher_kernel(torch, np, dev) -> dict:
    """Phase 21.1 for the block kernel (m + 1 > 32, ``hungarian_block_kernel``):
    against its plain version on the card at ``BLOCK_MATCHER_SHAPES`` (a
    third of the problems uniform, a third tied integers, a third integers
    with NaNs) and at ``BLOCK_MATCHER_TIMED`` (half uniform, half tied
    integers), with assignments equal, the C library's counts showing one
    block launch a call and no warp launch, and each matched cost of a
    problem with no NaN within ``MATCHER_COST_TOL`` of scipy's optimum; once
    more at ``BLOCK_MATCHER_GLOBAL`` with the state in global memory; times
    at ``BLOCK_MATCHER_TIMED`` beside the plain version (one call: it waits
    on the card at every step), scipy's host round trip and the bytes bound.
    Returns the kernels-line entry at the first timed shape with the others
    under ``at_shapes``."""
    from explainable_spatial_vqa_tpu_torch.ops.matching import (
        hungarian_assignment,
        hungarian_assignment_device,
        hungarian_assignment_device_plain,
        kernel_launches,
        set_shared_limit,
    )

    t0 = time.perf_counter()
    found = dict(problems=0, nans=0, worst_gap=0.0, mismatched=[])

    def launched(fn):
        before = kernel_launches()
        out = fn()
        return out, {k: c - before[k] for k, c in kernel_launches().items() if c != before[k]}

    def held(cost, mask, has_nan, got, ref, plain_s):
        """Fail unless ``got`` is ``ref`` and, where no cost is NaN, at
        scipy's optimum with as many queries matched; one line."""
        q, t = cost.shape[1:]
        bad = np.flatnonzero((got != ref).any(1))
        found["mismatched"] += [(q, t, int(b)) for b in bad[:3]]
        finite = ~has_nan
        host = hungarian_assignment(torch.from_numpy(cost[finite]),
                                    torch.from_numpy(mask[finite])).numpy()
        optimum = matched_costs(np, cost[finite], host)
        gap = np.abs(matched_costs(np, cost[finite], got[finite]) - optimum) / np.maximum(
            1.0, optimum)
        found["worst_gap"] = max(found["worst_gap"], float(gap.max()))
        if not np.array_equal((got[finite] >= 0).sum(1), (host >= 0).sum(1)):
            fail(f"phase 21.1: the block kernel matches another number of queries than scipy "
                 f"at {q}x{t}")
        found["problems"] += len(cost)
        found["nans"] += int(has_nan.sum())
        say(f"phase 21.1 block matcher {len(cost)} problems at Q={q} T={t} ({int(has_nan.sum())} "
            f"with a NaN): assignments {'equal' if not len(bad) else f'DIFFER on {len(bad)}'}; "
            f"matched cost within {float(gap.max()):.3g} of scipy's optimum on the "
            f"{int(finite.sum())} without one; the plain version took {plain_s:.2f} s")

    for shape_i, (q, t, n) in enumerate(BLOCK_MATCHER_SHAPES):
        cost, mask, has_nan = block_matcher_problems(np, 2300 + shape_i, q, t, n)
        c, m = torch.from_numpy(cost).to(dev), torch.from_numpy(mask).to(dev)
        got, moved = launched(lambda: hungarian_assignment_device(c, m))
        if moved != {"hungarian_block_kernel": 1}:
            fail(f"phase 21.1: a {q}x{t} call launched {moved}, not the block kernel once")
        t1 = time.perf_counter()
        ref = hungarian_assignment_device_plain(c, m).cpu().numpy()
        held(cost, mask, has_nan, got.cpu().numpy(), ref, time.perf_counter() - t1)
    q, t = BLOCK_MATCHER_GLOBAL
    cost, mask, _ = block_matcher_problems(np, 2399, q, t, 96)
    c, m = torch.from_numpy(cost).to(dev), torch.from_numpy(mask).to(dev)
    old = set_shared_limit(0)
    try:
        got, global_moved = launched(lambda: hungarian_assignment_device(c, m))
    finally:
        set_shared_limit(old)
    global_equal = bool((got == hungarian_assignment_device_plain(c, m)).all())
    say(f"phase 21.1 block matcher with its state in global memory (shared-memory cap 0) at "
        f"Q={q} T={t}, 96 problems: launches {global_moved}; assignments "
        f"{'equal' if global_equal else 'DIFFER'} to the plain version's")

    rows = {}
    for b, q, t in BLOCK_MATCHER_TIMED:
        cost, mask = matcher_problems(np, 2400 + b + q, q, t, b)
        c, m = torch.from_numpy(cost).to(dev), torch.from_numpy(mask).to(dev)
        got, moved = launched(lambda: hungarian_assignment_device(c, m))
        if moved != {"hungarian_block_kernel": 1}:
            fail(f"phase 21.1: a {q}x{t} call launched {moved}, not the block kernel once")
        ms = timed_ms(torch, lambda: hungarian_assignment_device(c, m), iters=20, warmup=2)
        plain_out = []
        plain = timed_ms(torch, lambda: plain_out.append(hungarian_assignment_device_plain(c, m)),
                         iters=1, warmup=0)
        held(cost, mask, np.zeros(b, bool), got.cpu().numpy(), plain_out[0].cpu().numpy(),
             plain / 1e3)
        scipy_ms = timed_ms(torch, lambda: hungarian_assignment(c, m), iters=3, warmup=1)
        err = float((got - plain_out[0]).abs().max())
        nbytes = b * q * t * 4 + b * t + b * q * 8
        bnd, by = bound_ms({}, nbytes)
        say(f"phase 21.1 block matcher B={b} Q={q} T={t}: kernel {ms:.4f} ms through the "
            f"wrapper, plain {plain:.3f} ms (one call), scipy's host round trip {scipy_ms:.3f} "
            f"ms (no PyTorch call computes it), bound {bnd:.6f} ms ({by}, {nbytes} bytes)")
        rows[(b, q, t)] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                               library_ms=None, scipy_round_trip_ms=scipy_ms)
    mismatched = found["mismatched"]
    say(f"phase 21.1 block matcher against its plain version on the card: {found['problems']} "
        f"problems at (Q, T, problems) {BLOCK_MATCHER_SHAPES} and (B, Q, T) "
        f"{BLOCK_MATCHER_TIMED}, tied integer costs among them and NaNs in {found['nans']}: "
        f"assignments {'equal' if not mismatched else f'DIFFER {mismatched}'}; matched cost "
        f"against scipy's optimum within {found['worst_gap']:.3g} relative (tol "
        f"{MATCHER_COST_TOL}); {time.perf_counter() - t0:.1f} s")
    if (mismatched or not found["worst_gap"] <= MATCHER_COST_TOL or not global_equal
            or global_moved != {"hungarian_block_kernel": 1,
                                "hungarian_block_kernel_global_state": 1}):
        fail("phase 21.1: the block matcher disagrees with its plain version or scipy's optimum")
    main_shape = rows.pop(BLOCK_MATCHER_TIMED[0])
    main_shape["shape"] = "B{}_Q{}_T{}".format(*BLOCK_MATCHER_TIMED[0])
    main_shape["at_shapes"] = {f"B{b}_Q{q}_T{t}": r for (b, q, t), r in rows.items()}
    return main_shape


def matcher_step_times(torch, np, dev, counted) -> dict:
    """Phase 21.2: one ``executor_roi`` train step at full width, bf16, at
    batch 16 and 128 with ``matcher="auto"`` (the kernel) and
    ``"hungarian"`` (scipy on the host): ms per step by CUDA events in
    alternating rounds, the host's waits per step from the profiler, the
    matcher's launches per step; then the kernel's fixed batch of 16 must
    fall below 0.8 of its first loss within ``EXECUTOR_STEPS`` updates.
    Returns the launches of one kernel step at batch 16."""
    from explainable_spatial_vqa_tpu_torch.bench_data import synth_executor_steps
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.train.pipelines import executor_pipeline_from_arrays
    from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    base = get_preset("executor_roi")
    arrays, features = synth_executor_steps(EXECUTOR_ROWS, base.model, seed=21)
    features = torch.from_numpy(features).to(dev)

    def trainer(matcher):
        cfg = base.replace(model=dataclasses.replace(base.model, matcher=matcher))
        pipe = executor_pipeline_from_arrays(cfg, arrays, features, device=dev)
        return Trainer(pipe.loss_fn, pipe.model, cfg.optim, cfg.train, pipe.steps_per_epoch,
                       checkpoint_dir=False, device=dev), pipe

    step_counts = None
    for batch_size in (16, 128):
        batch = to_device({k: v[:batch_size] for k, v in arrays.items()}, dev)
        batch["image"] = features[batch["image_index"].long()]
        trainers = {m: trainer(m)[0] for m in ("auto", "hungarian")}
        gen = torch.Generator().manual_seed(0)
        for tr in trainers.values():
            for _ in range(3):
                tr.train_step(batch, gen)
        times = {m: [] for m in trainers}
        for r in range(STEP_ROUNDS):
            for m in (("auto", "hungarian") if r % 2 == 0 else ("hungarian", "auto")):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                for _ in range(STEPS_PER_ROUND):
                    trainers[m].train_step(batch, gen)
                end.record()
                end.synchronize()
                times[m].append(start.elapsed_time(end) / STEPS_PER_ROUND)
        waits, launches = {}, {}
        for m, tr in trainers.items():
            _wall, prof = device_profile(torch, lambda: tr.train_step(batch, gen))
            waits[m] = None if prof is None else prof[2]
            _, launches[m] = counted(lambda: tr.train_step(batch, gen))
        # where the kernel's step still synchronises (none of it the matcher's)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                trainers["auto"].train_step(batch, gen)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs_at = sorted({f"{Path(w.filename).name}:{w.lineno}" for w in caught
                           if "synchronizing" in str(w.message)})
        med = {m: statistics.median(v) for m, v in times.items()}
        say(f"phase 21.2 executor_roi train step, bf16, batch {batch_size}: matcher='auto' (the "
            f"kernel) {med['auto']:.2f} ms, matcher='hungarian' (scipy) {med['hungarian']:.2f} "
            f"ms per step (median of {STEP_ROUNDS} alternating rounds of {STEPS_PER_ROUND}; all, "
            f"ms: auto {[round(x, 2) for x in times['auto']]}, hungarian "
            f"{[round(x, 2) for x in times['hungarian']]}); host waits per profiled step, the "
            f"profiler's closing synchronize included: auto {waits['auto']}, hungarian "
            f"{waits['hungarian']}; the kernel step's host synchronisations "
            f"(set_sync_debug_mode('warn')) at {syncs_at}; launches per step: auto "
            f"{launches['auto']}, hungarian {launches['hungarian']}")
        checks = {
            "one matcher launch per kernel step": (
                launches["auto"]["hungarian_assignment_device"] == 1),
            "no matcher launch per scipy step": (
                launches["hungarian"]["hungarian_assignment_device"] == 0),
            "the kernel's step waits less on the card than scipy's": (
                waits["auto"] is None or waits["auto"] < waits["hungarian"]),
        }
        for name, ok in checks.items():
            if not ok:
                fail(f"phase 21.2 check failed: {name}")
        if step_counts is None:
            step_counts = launches["auto"]
        del trainers, batch
        torch.cuda.empty_cache()

    tr, pipe = trainer("auto")
    batch = to_device(next(iter(pipe.train_batches(0))), dev)
    gen = torch.Generator().manual_seed(2)
    losses = torch.stack([tr.train_step(batch, gen)["loss_sum"]
                          for _ in range(EXECUTOR_STEPS + 1)]).tolist()
    below = [i for i, x in enumerate(losses) if x < 0.8 * losses[0]]
    say(f"phase 21.2 fixed-batch loss with the kernel matcher (batch {base.train.batch_size}): "
        f"step 0 {losses[0]:.4f}, step {EXECUTOR_STEPS} {losses[-1]:.4f}; first below 0.8 of "
        f"step 0 at step {below[0] if below else None}; {time.perf_counter() - t0:.1f} s")
    if not (all(math.isfinite(x) for x in losses) and below):
        fail("phase 21.2: the fixed batch's loss did not fall with the kernel matcher")
    del tr, pipe, batch, features
    torch.cuda.empty_cache()
    return step_counts, wide_queries_step(torch, dev, counted)


def wide_queries_step(torch, dev, counted) -> int:
    """Phase 21.2 past the warp kernel: ``executor_roi`` with ``WIDE_QUERIES``
    queries (and as many target slots: (Q, T) = (40, 40) problems, which
    JAX's matcher solves in its train step), bf16, at its batch of 16: one
    counted train step must launch the block kernel once (the C library's
    counts) and the warp kernel never, its loss finite; then the fixed
    batch's loss must fall below 0.8 of its first within ``EXECUTOR_STEPS``
    updates.  Returns the block kernel's launches over the run."""
    from explainable_spatial_vqa_tpu_torch.bench_data import synth_executor_steps
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.ops.matching import kernel_launches
    from explainable_spatial_vqa_tpu_torch.train.pipelines import executor_pipeline_from_arrays
    from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    base = get_preset("executor_roi")
    cfg = base.replace(model=dataclasses.replace(base.model, num_queries=WIDE_QUERIES))
    arrays, features = synth_executor_steps(EXECUTOR_ROWS, cfg.model, seed=23)
    features = torch.from_numpy(features).to(dev)
    pipe = executor_pipeline_from_arrays(cfg, arrays, features, device=dev)
    tr = Trainer(pipe.loss_fn, pipe.model, cfg.optim, cfg.train, pipe.steps_per_epoch,
                 checkpoint_dir=False, device=dev)
    batch = to_device(next(iter(pipe.train_batches(0))), dev)
    gen = torch.Generator().manual_seed(4)
    start = kernel_launches()
    first, counts = counted(lambda: tr.train_step(batch, gen)["loss_sum"])
    torch.cuda.synchronize()
    step = {k: c - start[k] for k, c in kernel_launches().items() if c != start[k]}
    losses = [float(first)] + torch.stack([tr.train_step(batch, gen)["loss_sum"]
                                           for _ in range(EXECUTOR_STEPS)]).tolist()
    block = kernel_launches()["hungarian_block_kernel"] - start["hungarian_block_kernel"]
    below = [i for i, x in enumerate(losses) if x < 0.8 * losses[0]]
    say(f"phase 21.2 executor_roi with {WIDE_QUERIES} queries (Q = T = {WIDE_QUERIES}, past the "
        f"warp kernel's 31), bf16, batch {cfg.train.batch_size}: one train step's launches "
        f"{counts}, by matcher kernel (the C library's counts) {step}; fixed-batch loss step 0 "
        f"{losses[0]:.4f}, step {EXECUTOR_STEPS} {losses[-1]:.4f}, first below 0.8 of step 0 at "
        f"step {below[0] if below else None}; the block kernel launched {block} times; "
        f"{time.perf_counter() - t0:.1f} s")
    checks = {
        "one block-kernel launch and no warp-kernel launch in the step": (
            step == {"hungarian_block_kernel": 1} and counts["hungarian_assignment_device"] == 1),
        "every loss finite": all(math.isfinite(x) for x in losses),
        "the fixed batch's loss falls below 0.8 of its first": bool(below),
    }
    for name, ok in checks.items():
        if not ok:
            fail(f"phase 21.2 check failed at {WIDE_QUERIES} queries: {name}")
    del tr, pipe, batch, features
    torch.cuda.empty_cache()
    return block


class DemoEnv:
    """The demos' knobs set for one run (``DEMO_OUT`` and a fresh
    ``DEMO_CKPT``, files of its own under ``workdir``), the environment
    restored after; the demo's standard output goes to
    ``workdir/<name>.log``."""

    def __init__(self, workdir: Path, name: str, knobs: dict):
        self.log = workdir / f"{name}.log"
        self.env = {"DEMO_DEVICE": "cuda", "DEMO_OUT": str(workdir / f"{name}.md"),
                    "DEMO_CKPT": str(workdir / f"{name}_ckpt.json"), **knobs}
        Path(self.env["DEMO_CKPT"]).unlink(missing_ok=True)  # resume nothing

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        self.stack = contextlib.ExitStack()
        self.stack.enter_context(contextlib.redirect_stdout(self.stack.enter_context(
            open(self.log, "w"))))
        return self

    def __exit__(self, *exc):
        self.stack.close()
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def chain_decision_gaps(np, card: dict, cpu: dict, cpu_calls: list, thr: float) -> list:
    """For each chain whose decisions (routing, token, box mask) differ
    between the card's and the CPU's plain-mode runs, the CPU's margin at
    the first differing step k (forward call k of the run; an earlier step
    saw the same inputs up to rounding): the routing logits' gap, the token
    logits' top-2 gap, or the closest confidence to the threshold."""
    gaps = []
    diff = ((card["token_branch"] != cpu["token_branch"])
            | (card["token_cache"] != cpu["token_cache"])
            | (card["box_mask"] != cpu["box_mask"]).any(-1))
    for row in np.flatnonzero(diff.any(1)):
        k = int(np.flatnonzero(diff[row])[0])
        out = cpu_calls[k]
        if card["token_branch"][row, k] != cpu["token_branch"][row, k]:
            routing = out["routing_logits"][row]
            gaps.append(("routing", float(abs(routing[0] - routing[1]))))
        elif card["token_cache"][row, k] != cpu["token_cache"][row, k]:
            top = np.sort(out["token_logits"][row])[-2:]
            gaps.append(("token", float(top[1] - top[0])))
        else:
            gaps.append(("box_mask", float(np.abs(out["pred_conf"][row] - thr).min())))
    return gaps


def demos(torch, np, dev, counted) -> tuple:
    """Phase 21: the matcher kernel (21.1 ``matcher_kernel``), the executor
    train step with either matcher (21.2 ``matcher_step_times``), and the
    demos on the card (21.3): the accuracy table at ``DEMO_D512``,
    with K2, K1 and matcher launches counted and its section printed; its
    trained models' float32 predicted-chain decisions (the plain chain mode,
    GT program structure) on the card against deep copies on the CPU, equal
    but for printed near-ties; then every other demo once at
    ``DEMO_SMALL``'s sizes, each writing its marked section.  Returns (the
    warp matcher's kernels-line entry, the block matcher's with its launches
    in 21.2's wide run, launches by path)."""
    import importlib

    from explainable_spatial_vqa_tpu_torch.demos import accuracy_table
    from explainable_spatial_vqa_tpu_torch.evalsuite.executor_eval import tally_predicted_chains
    from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner

    t_phase = time.perf_counter()
    matcher, block_matcher = matcher_kernel(torch, np, dev)
    step_counts, block_matcher["launches"] = matcher_step_times(torch, np, dev, counted)

    import tempfile

    workdir = Path(tempfile.mkdtemp(prefix="phase21-"))
    with DemoEnv(workdir, "accuracy_table_d512", DEMO_D512):
        ckpt = Path(accuracy_table.ckpt_path())
        ckpt.unlink(missing_ok=True)
        t0 = time.perf_counter()
        state, d512_counts = counted(accuracy_table.run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ckpt.unlink(missing_ok=True)
    exe_steps = int(DEMO_D512["DEMO_EXE_STEPS"])
    say(f"phase 21.3 demos.accuracy_table at {DEMO_D512} on the card: {wall:.1f} s; launches "
        f"{d512_counts}; its section:")
    for line in state["section"].splitlines():
        say(f"phase 21.3 | {line}")
    d512_checks = {
        "K2 and K1 launched in the chain runs": (
            d512_counts["fused_encoder_block"] > 0 and d512_counts["fused_attention"] > 0),
        "K2 3 times per K1 (3 encoder layers, 1 box-decoder layer)": (
            d512_counts["fused_encoder_block"] == 3 * d512_counts["fused_attention"]),
        "one matcher launch per executor train step": (
            d512_counts["hungarian_assignment_device"] == exe_steps),
    }
    for name, ok in d512_checks.items():
        if not ok:
            fail(f"phase 21.3 accuracy table check failed: {name}")

    # float32 predicted-chain decisions, card against CPU (plain mode: forward
    # call k is step k of every chain)
    exe_cfg, chains = state["exe_cfg"], state["chains"]
    runs, calls = {}, {}
    for where, model, images in (
            ("card", state["executor"], state["image_tokens"]),
            ("cpu", copy.deepcopy(state["executor"]).to("cpu"), state["image_tokens"].cpu())):
        calls[where] = []
        hook = model.register_forward_hook(lambda _m, _i, out, sink=calls[where]: sink.append(
            {k: out[k].float().cpu().numpy() for k in ("routing_logits", "token_logits",
                                                       "pred_conf")}))
        runner = ExecutorChainRunner(model, exe_cfg, max_steps=state["max_steps"],
                                     device=images.device)
        runs[where] = runner.run(images, chains)
        hook.remove()
    card, cpu = runs["card"], runs["cpu"]
    gaps = chain_decision_gaps(np, card, cpu, calls["cpu"], exe_cfg.conf_threshold)
    decisions_equal = not gaps
    vocabs = state["split_vocab"]
    tallies = [tally_predicted_chains(r, state["eval_annotated"], vocabs["function"],
                                      vocabs["other"], max_steps=state["max_steps"])
               for r in (card, cpu)]
    tally_equal = dataclasses.asdict(tallies[0]) == dataclasses.asdict(tallies[1])
    say(f"phase 21.3 fp32 predicted-chain decisions of the trained d 512 executor, card vs CPU, "
        f"{len(chains.num_steps)} chains ({int(chains.num_steps.sum())} steps): "
        + ("equal" if decisions_equal else f"differ on {len(gaps)} chains, the CPU's margin at "
           f"the first differing step {gaps}")
        + f"; per-function tally {'equal' if tally_equal else 'differs'}")
    if any(gap > NEAR_TIE for _, gap in gaps) or (decisions_equal and not tally_equal):
        fail("phase 21.3: the float32 chain decisions on the card disagree with the CPU")
    del state, runs, calls
    torch.cuda.empty_cache()

    walls = {"accuracy_table_d512": round(wall, 1)}
    for name, knobs in DEMO_SMALL.items():
        module = importlib.import_module(f"explainable_spatial_vqa_tpu_torch.demos.{name}")
        saved_steps = getattr(module, "STEPS", None)
        if name == "data_efficiency":
            module.STEPS = DEMO_DATA_EFFICIENCY_STEPS
        # executor_data_efficiency resumes the points kept under results/
        rows = REPO / "results" / f"dataeff_rows_torch_{knobs.get('DEMO_EXE_STEPS')}.json"
        rows.unlink(missing_ok=True)
        with DemoEnv(workdir, name, knobs) as env:
            t0 = time.perf_counter()
            module.main()
            torch.cuda.synchronize()
            walls[name] = round(time.perf_counter() - t0, 1)
        rows.unlink(missing_ok=True)
        if saved_steps is not None:
            module.STEPS = saved_steps
        out = Path(env.env["DEMO_OUT"])
        text = out.read_text() if out.exists() else ""
        if hasattr(module, "BEGIN"):  # a marked section
            wrote = module.BEGIN in text and module.END in text
        elif name == "end_to_end":  # its whole report, when DEMO_OUT is set
            wrote = text.startswith("# End-to-end demonstration")
        else:  # data_efficiency prints its sweep only
            wrote = "held-out program EM" in env.log.read_text()
        if not wrote:
            fail(f"phase 21.3 {name} wrote no section ({out}, {env.log})")
    say(f"phase 21.3 every other demo once on the card at reduced sizes (sections under "
        f"{workdir}): wall s {walls}; phase 21 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(workdir)
    return matcher, block_matcher, {"demo_accuracy_table_d512": d512_counts,
                                    "executor_train_step": step_counts}


# phase 22: the measurement drivers at their defaults (bench.py's widths,
# BENCH_N 1024), but the bench's float32 batch-1 baseline, which runs on 4
# questions in each mode, not bench.py's 32 (~26 s on the chip host's CPU
# at ~2.5 questions/s, and slower hosts): it only times, for vs_baseline
BENCH_BASELINE_N = {"pool": 4, "sorted": 4}


def captured_main(main, argv, knobs: dict, label: str, counted):
    """``main(argv)`` with the environment ``knobs`` set and its launches
    counted; its standard output printed after it, each line prefixed with
    ``label``, whether it returns or raises.  Returns (its value, its
    launches, its last printed line)."""
    import io

    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            value, counts = counted(lambda: main(argv))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for line in out.getvalue().splitlines():
            say(f"{label} | {line}")
    lines = out.getvalue().strip().splitlines()
    return value, counts, lines[-1] if lines else ""


def finite_positive(*values) -> bool:
    return all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0 for v in values)


def measurement_drivers(torch, counted) -> dict:
    """Phase 22: the port bench (``bench.main``) in the ``pool`` and
    ``sorted`` modes at ``BENCH_N`` 1024 (the baseline's size from
    ``BENCH_BASELINE_N``), then each driver of ``measure/`` at its defaults,
    all in this process, each driver's output printed with a prefix.  Each
    last line must parse as JSON with its driver's ``KEYS`` (the JAX
    counterpart's, pinned by the CPU tests) and equal what ``main``
    returned; every time finite and positive; 0 < each MFU <= 1; no
    truncated program; K1 and K2 launched in each bench run and K3 in none.
    Returns the launches of each run, by path."""
    from explainable_spatial_vqa_tpu_torch import bench
    from explainable_spatial_vqa_tpu_torch.measure import (
        mfu_decomposition,
        profile_pipeline,
        profile_segments,
        roofline_step,
    )

    t_phase = time.perf_counter()
    by_path, results = {}, {}
    for mode in ("pool", "sorted"):
        knobs = {"BENCH_N": "1024", "BENCH_MODE": mode,
                 "BENCH_BASELINE_N": str(BENCH_BASELINE_N[mode])}
        if BENCH_BASELINE_N[mode] != 32:
            say(f"phase 22 bench {mode}: BENCH_BASELINE_N {BENCH_BASELINE_N[mode]} (bench.py's "
                f"default 32)")
        t0 = time.perf_counter()
        results[f"bench_{mode}"], by_path[f"bench_{mode}"], last = captured_main(
            bench.main, [], knobs, f"phase 22 bench {mode}", counted)
        say(f"phase 22 bench {mode}: {time.perf_counter() - t0:.1f} s, launches "
            f"{by_path[f'bench_{mode}']}")
        results[f"bench_{mode}_line"] = last
    drivers = (("profile_pipeline", profile_pipeline, []),
               ("profile_segments", profile_segments, []),
               ("mfu_decomposition", mfu_decomposition, []),
               ("roofline_step", roofline_step, []))
    for name, module, argv in drivers:
        t0 = time.perf_counter()
        results[name], by_path[name], results[f"{name}_line"] = captured_main(
            module.main, argv, {}, f"phase 22 {name}", counted)
        say(f"phase 22 {name}: {time.perf_counter() - t0:.1f} s, launches {by_path[name]}")
        torch.cuda.empty_cache()

    def parses(name, keys):
        try:
            line = json.loads(results[f"{name}_line"])
        except ValueError:
            return False
        return line == results[name] and set(line) == set(keys)

    pool, sorted_, pipe, seg, mfu, roof = (results[k] for k in (
        "bench_pool", "bench_sorted", "profile_pipeline", "profile_segments",
        "mfu_decomposition", "roofline_step"))
    checks = {
        "every last line parses with its driver's keys": all(
            parses(f"bench_{m}", bench.KEYS) for m in ("pool", "sorted")) and all(
            parses(name, module.KEYS) for name, module, _ in drivers),
        "no truncated program": pool["truncated_programs"] == sorted_["truncated_programs"] == 0,
        "the bench's rates finite and positive": all(finite_positive(
            r["value"], r["vs_baseline"], r["baseline_qps"], r["gflops_per_question"])
            for r in (pool, sorted_)),
        "0 < mfu <= 1": all(0 < r <= 1 for r in (
            pool["mfu"], sorted_["mfu"], seg["fwd_mfu_default"], seg["fwd_mfu_lowp"],
            mfu["measured_e2e_mfu"], mfu["mfu_step_executed"])),
        "K1 and K2 launched in each bench run, K3 in none": all(
            by_path[f"bench_{m}"]["fused_attention"] > 0
            and by_path[f"bench_{m}"]["fused_encoder_block"] > 0
            and by_path[f"bench_{m}"]["fused_encoder_block_tiled"] == 0
            for m in ("pool", "sorted")),
        "the pipeline profile's times finite and positive": finite_positive(
            *(pipe[k] for k in ("generator_ms", "executor_forward_ms", "chain_ms",
                                "questions_per_s"))),
        "the segment profile's times finite and positive": finite_positive(
            seg["dispatch_ms"], seg["generator_ms"], *seg["chain_ms"].values(),
            *seg["fwd_ms"].values()),
        "the MFU factors' times finite and positive, their product the measured MFU": (
            finite_positive(mfu["t_generator_s"], mfu["t_chain_s"], mfu["t_total_s"])
            and math.isclose(mfu["predicted_e2e_mfu_product"], mfu["measured_e2e_mfu"],
                             rel_tol=1e-9)),
        "the roofline's times finite and positive": finite_positive(
            roof["composite_bound_ms"], roof["composite_bound_k2_ms"], roof["measured_step_ms"],
            *(c["ms_per_step"] for c in roof["classes"]), *roof["k2_gemm_ms"].values()),
    }
    for name, ok in checks.items():
        if not ok:
            fail(f"phase 22 check failed: {name}")
    say(f"phase 22 measurement drivers: pool {pool['value']} and sorted {sorted_['value']} "
        f"questions/s, mfu {pool['mfu']} and {sorted_['mfu']}, vs_baseline "
        f"{pool['vs_baseline']} and {sorted_['vs_baseline']}; phase 22 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return by_path


# ---------------------------------------------------------------------------
# phase 23: the paths at the head dims without kernels of their own
# ---------------------------------------------------------------------------

# the CoGenT protocol as ``cogent-protocol --d_model N`` runs it (the CLI's
# defaults: 2 fusion layers, no box_roi, constant lr), its sizes and steps
# cut so that the d_model 1024 executor's valA evaluation also runs on the
# CPU within seconds
NEW_WIDTH_PROTOCOL = dict(num_scenes_a=20, num_scenes_val=2, num_scenes_b_pool=10,
                          gen_steps=10, exe_steps=10, ft_steps=4)
NEW_WIDTH_QUESTIONS = 256  # serving at d_model 1024


@contextlib.contextmanager
def plain_self_attention_count():
    """A list that counts the self-attention calls ``MultiHeadAttention``
    takes in eval mode without an autograd graph, same length for queries
    and keys, a key-padding mask or none: the calls K1 takes, so that a path
    on which this count equals K1's launches ran no such call on the plain
    attention."""
    from explainable_spatial_vqa_tpu_torch.models import layers

    forward, calls = layers.MultiHeadAttention.forward, []

    def counted_forward(self, query, keyvalue, mask=None):
        import torch

        if (not self.training and not torch.is_grad_enabled()
                and query.shape[1] == keyvalue.shape[1]
                and (mask is None or (mask.ndim == 4 and mask.shape[1] == mask.shape[2] == 1))):
            calls.append(query.shape)
        return forward(self, query, keyvalue, mask)

    layers.MultiHeadAttention.forward = counted_forward
    try:
        yield calls
    finally:
        layers.MultiHeadAttention.forward = forward


def c_counts(torch):
    """``read()``: the attention launches of K1's and the block library's C
    counters, by kernel function, since ``c_counts`` was called."""
    from explainable_spatial_vqa_tpu_torch.ops import fused_block
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import kernel_launches

    torch.cuda.synchronize()
    before = (kernel_launches(), fused_block.kernel_launches())

    def read():
        now = (kernel_launches(), fused_block.kernel_launches())
        return tuple({n: c - was[n] for n, c in cur.items() if c != was[n]}
                     for was, cur in zip(before, now))

    return read


def serving_run(torch, np, dev, counted, d_model: int) -> dict:
    """bf16 serving, ``InferencePipeline.run`` (pool) at bench.py's widths with
    the executor at ``d_model`` (4 heads) on ``NEW_WIDTH_QUESTIONS`` synthetic
    questions: a warm-up, one run counted (its answers, the wrappers'
    launches, the C libraries' counts and the self-attention calls K1 takes,
    ``plain_self_attention_count``), then three timed on the host's clock.
    Returns them by name, with the executor forwards of one run and the
    executor's config."""
    from explainable_spatial_vqa_tpu_torch.bench_data import FUNCTION_IDS, synth_questions
    from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, GeneratorConfig
    from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
    from explainable_spatial_vqa_tpu_torch.infer.pipeline import InferencePipeline
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters

    gen_cfg = GeneratorConfig(vocab_size=96, program_vocab_size=45, program_len=27)
    exe_cfg = ExecutorConfig(vocab_size=64, token_classes=32, box_roi=True, d_model=d_model,
                             num_heads=4)
    generator = init_parameters(ProgramGenerator(gen_cfg, torch.bfloat16, device=dev), seed=1)
    executor = init_parameters(ProgramExecutor(exe_cfg, torch.bfloat16, device=dev), seed=2)
    thresholds = np.random.RandomState(3).uniform(0.3, 0.7, exe_cfg.vocab_size).astype(np.float32)
    runner = ExecutorChainRunner(executor, exe_cfg, max_steps=27, conf_thresholds=thresholds,
                                 device=dev)
    idx_to_token = dict(enumerate(["<NULL>", "<START>", "<END>"] + sorted(FUNCTION_IDS)))
    token_ids = {t: i for i, t in idx_to_token.items()}
    features, questions, chains = synth_questions(NEW_WIDTH_QUESTIONS, exe_cfg, max_steps=27,
                                                  seed=0)
    scripted = postfix_ids(chains, token_ids, FUNCTION_IDS, gen_cfg.program_len)
    pipeline = InferencePipeline(scripted_programs(torch, generator, scripted), runner,
                                 idx_to_token, FUNCTION_IDS, device=dev)
    features_dev = torch.from_numpy(features).to(dev)
    forwards = [0]
    hook = executor.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))

    def run():
        return pipeline.run(questions, features_dev, chains.image_index, chain_mode="pool")

    run()  # warm-up
    forwards[0] = 0
    read = c_counts(torch)
    with plain_self_attention_count() as eligible:
        served, counts = counted(run)
    found = read()
    seconds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    hook.remove()
    return dict(served=served, counts=counts, c_counts=found, eligible=len(eligible),
                forwards=forwards[0] // 4, seconds=seconds, config=exe_cfg)


def serving_text(run: dict) -> str:
    """``serving_run``'s result in words: its widths, questions/s (the median
    of the three timed runs), forwards, launches and counts."""
    cfg, seconds, n = run["config"], run["seconds"], NEW_WIDTH_QUESTIONS
    median = sorted(seconds)[1]
    k1_c, block_c = run["c_counts"]
    return (f"InferencePipeline.run (pool) at bench.py's widths with the executor at d_model "
            f"{cfg.d_model} (4 heads of {cfg.d_model // 4}) on {n} questions: median of 3 runs "
            f"{median:.3f} s = {n / median:.1f} questions/s (s: "
            f"{', '.join(f'{t:.3f}' for t in seconds)}); {run['forwards']} executor forwards a "
            f"run; launches {run['counts']}; the C libraries' counts: K1 {k1_c}, K2's attention "
            f"{block_c}; eligible self-attention calls {run['eligible']}; "
            f"{int(run['served'].answer_valid.sum())} token answers")


def new_widths(torch, np, dev, counted) -> dict:
    """Phase 23, the paths at the head dims without kernels of their own:

    1. ``run_cogent_protocol`` (the CLI's ``cogent-protocol``) at d_model 100
       (4 heads of 25), float32: its evaluations launch K1 on the padded
       kernel in every fusion layer (the plain block's self-attention, L =
       208) and in the box decoder (L = 8), and no K2;
    2. the same at d_model 1024 (4 heads of 256): K2 on every fusion layer,
       its attention on ``attention_kernel_split_f32``, and K1 on the short
       kernel in the box decoder (8 keys);
       each at ``NEW_WIDTH_PROTOCOL``'s sizes and steps, the launches read
       from the wrappers and the C libraries' counters, no eligible
       self-attention on the plain path (``plain_self_attention_count``),
       and its fine-tuned models' valA evaluation on the card equal to the
       CPU's (``protocol_card_vs_cpu``);
    3. bf16 serving, ``InferencePipeline.run`` at bench.py's widths but the
       executor at d_model 1024 (4 heads): K2 3 and K1 2 launches a forward,
       K2's attention on ``attention_kernel_split_f32``, K1 on the short
       kernel (10 keys), on ``NEW_WIDTH_QUESTIONS`` synthetic questions;
       questions/s, median of 3 runs after a warm-up;
    4. ``bench_block.main`` at d_model 1024 (B=128, K3 at one tiling), which
       launches K2 and K3 through the block bench's entry point, K2's
       attention on ``attention_kernel_split_f32`` and K3's on
       ``attention_kernel_wgmma``; K2's and K3's ms printed.

    Returns each path's wrapper launches, for the result line, and each
    path's launches of the head-dim-256 and short kernels by the C
    libraries' counts."""
    from explainable_spatial_vqa_tpu_torch import bench_block
    from explainable_spatial_vqa_tpu_torch.bench_cogent import ProtocolParts, part_rows
    from explainable_spatial_vqa_tpu_torch.evalsuite.cogent import run_cogent_protocol

    t_phase = time.perf_counter()
    paths, wide = {}, {}

    def wide_of(*counts):  # the head-dim-256 and short kernels' launches among C counts
        return {n: sum(c.get(n, 0) for c in counts) for n in (SPLIT_F32, WGMMA, SHORT, SHORT_F32)}

    for d_model in (100, 1024):
        t0 = time.perf_counter()
        read = c_counts(torch)
        with ProtocolParts() as parts, plain_self_attention_count() as eligible:
            result, counts = counted(lambda: run_cogent_protocol(
                **NEW_WIDTH_PROTOCOL, d_model=d_model, device=dev))
        k1_c, block_c = read()
        rows = [r for r in part_rows(parts) if r["part"].startswith("evaluation")]
        k2 = d_model % 128 == 0
        say(f"phase 23 cogent-protocol --d_model {d_model} (4 heads of {d_model // 4}), float32, "
            f"{NEW_WIDTH_PROTOCOL}: {time.perf_counter() - t0:.1f} s; "
            f"{result['report'].report()}; launches {counts}; per evaluation "
            + ", ".join(f"{r['part'].split()[1]} K2 {r['K2']} K1 {r['K1']}" for r in rows)
            + f"; the C libraries' counts: K1 {k1_c}, K2's attention {block_c}; eligible "
            f"self-attention calls {len(eligible)}")
        # the box decoders' 8 keys: the padded kernel at d 100, the short one at 1024
        want_k1 = {k1_kernel(d_model // 4, 8, "fp32"): counts["fused_attention"]}
        if not (all(r["K1"] > 0 and (r["K2"] > 0) == k2 for r in rows)
                and counts["fused_attention"] == sum(r["K1"] for r in rows)
                and counts["fused_encoder_block"] == sum(r["K2"] for r in rows)
                and k1_c == want_k1 and len(eligible) == counts["fused_attention"]
                and block_c == ({SPLIT_F32: counts["fused_encoder_block"]} if k2 else {})):
            fail(f"phase 23 check failed at d_model {d_model}: the evaluations launch K1 on "
                 f"{list(want_k1)}{', K2 with attention_kernel_split_f32,' if k2 else ''} and "
                 f"only they, and no self-attention K1 takes runs the plain path")
        protocol_card_vs_cpu(torch, np, parts.of("evaluate_pipeline_synthetic")[2],
                             f"cogent-protocol --d_model {d_model}", phase=23)
        paths[f"cogent_protocol_d{d_model}"] = counts
        wide[f"cogent_protocol_d{d_model}"] = wide_of(k1_c, block_c)
        del result, parts
        torch.cuda.empty_cache()

    # ---- 23.3 bf16 serving with the executor at d_model 1024 ----
    run = serving_run(torch, np, dev, counted, 1024)
    served, counts, (k1_c, block_c), once, exe_cfg = (run[k] for k in (
        "served", "counts", "c_counts", "forwards", "config"))
    n = NEW_WIDTH_QUESTIONS
    say(f"phase 23 bf16 serving, {serving_text(run)}")
    serving_checks = {
        "K2 3 and K1 2 launches a forward": (
            counts["fused_encoder_block"] == exe_cfg.encoder_layers * once
            and counts["fused_attention"] == exe_cfg.box_decoder_layers * once > 0),
        "K1 on the short kernel (10 keys), K2's attention (float32 q/k/v) on "
        "attention_kernel_split_f32": (
            k1_c == {SHORT: counts["fused_attention"]}
            and block_c == {SPLIT_F32: counts["fused_encoder_block"]}),
        "no self-attention K1 takes on the plain path": run["eligible"] == counts["fused_attention"],
        "one answer per question in the token vocabulary": (
            served.answers.shape == (n,) and 0 <= served.answers.min()
            and served.answers.max() < exe_cfg.token_classes),
    }
    for name, ok in serving_checks.items():
        if not ok:
            fail(f"phase 23 serving check failed: {name}")
    paths["serving_d1024"] = counts
    wide["serving_d1024"] = wide_of(k1_c, block_c)
    torch.cuda.empty_cache()

    # ---- 23.4 the block bench at d_model 1024: K3 at head dim 256 ----
    read = c_counts(torch)
    rows, counts = counted(lambda: bench_block.main(
        ["--batches", "128", "--iters", "2", "--tiles", "2", "--d_model", "1024", "--heads", "4"]))
    _, block_c = read()
    say("phase 23 block bench at d_model 1024, 4 heads (bench_block.main --batches 128 --iters 2 "
        "--tiles 2 --d_model 1024 --heads 4, bf16, L=224, no mask): "
        + "; ".join(f"{name} {ms:.3f} ms {tflops:.1f} TFLOP/s" for _b, name, ms, tflops in rows)
        + f"; launches {counts}; K2's and K3's attention by the C library's counts {block_c}")
    # K2's attention on float32 q/k/v (attention_kernel_split_f32), K3's on
    # bf16 (L = 224: attention_kernel_wgmma)
    if not (counts["fused_encoder_block_tiled"] > 0
            and block_c == {SPLIT_F32: counts["fused_encoder_block"],
                            WGMMA: counts["fused_encoder_block_tiled"]}):
        fail("phase 23: the block bench at d_model 1024 did not launch K2's attention on "
             "attention_kernel_split_f32 and K3's on attention_kernel_wgmma")
    paths["block_bench_d1024"] = counts
    wide["block_bench_d1024"] = wide_of(block_c)
    say(f"phase 23 the head-dim-256 and short kernels' launches by path (the C libraries' "
        f"counts): {wide}")
    say(f"phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return paths, wide


# ---------------------------------------------------------------------------
# phase 24: the paths past head dim 256 (the deep kernels)
# ---------------------------------------------------------------------------

PAST_256_ROWS = 4  # 24.3's batch, card against the CPU in float32 (phase 8's inputs)
# 24.4's K3 at d_model 2048 on the H100 with its attention on
# attention_kernel_deep, before attention_kernel_wgmma_deep took it (PERF.md
# §6, row "K3 hd 512"), printed beside this run's
PARENT_K3_HD512_MS = {"K3 tiled TB=2 fc=1": 11.386, "K3 tiled TB=2 fc=2": 10.949}


def executor_forward(torch, np, dev, counted, d_model: int, dtype, phase: str):
    """One executor eval forward at ``d_model`` (4 heads, box RoI, a head dim
    that is not a multiple of 128, so no K2) in ``dtype`` on ``PAST_256_ROWS``
    synthetic rows: fails unless K1 ran on every fusion layer (L = 210,
    ragged) and every box-decoder layer (10 keys) on the kernels
    ``k1_kernel`` names, by the C library's counts, with no eligible
    self-attention on the plain path and finite outputs, in float32 equal to
    the CPU's within 1e-4.  Returns the wrapper launches and the C library's
    counts."""
    from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters

    exe_cfg = ExecutorConfig(vocab_size=64, token_classes=32, box_roi=True, d_model=d_model,
                             num_heads=4)
    d_head = d_model // 4
    rng = np.random.RandomState(5)
    lo = rng.rand(PAST_256_ROWS, exe_cfg.max_input_boxes, 2) * 0.6
    inputs = [
        rng.rand(PAST_256_ROWS, exe_cfg.num_image_tokens, exe_cfg.image_feature_dim).astype(
            np.float32),
        np.concatenate([lo, lo + rng.rand(PAST_256_ROWS, exe_cfg.max_input_boxes, 2) * 0.4],
                       -1).astype(np.float32),
        rng.rand(PAST_256_ROWS, exe_cfg.max_input_boxes) < 0.5,
        rng.randint(0, exe_cfg.vocab_size, (PAST_256_ROWS, 3)),
        np.array([[1, 1, 0], [1, 0, 1], [1, 1, 1], [1, 0, 0]], bool),
    ]
    per_forward = exe_cfg.encoder_layers + exe_cfg.box_decoder_layers
    name = "fp32" if dtype == torch.float32 else "bf16"
    # the fusion layers' 210 keys and the box decoder's 10
    kernels = {k1_kernel(d_head, 210, name): exe_cfg.encoder_layers,
               k1_kernel(d_head, 10, name): exe_cfg.box_decoder_layers}
    model = init_parameters(ProgramExecutor(exe_cfg, dtype, device=dev), seed=6).eval()
    read = c_counts(torch)
    with plain_self_attention_count() as eligible, torch.no_grad():
        out, counts = counted(lambda: model(*(torch.from_numpy(a).to(dev) for a in inputs)))
    k1_c, block_c = read()
    text = (f"phase {phase} {name} executor eval forward at d_model {d_model} (4 heads of "
            f"{d_head}, B={PAST_256_ROWS}, fusion L = 210 ragged): launches {counts}; the C "
            f"libraries' counts: K1 {k1_c}, K2's attention {block_c}; eligible self-attention "
            f"calls {len(eligible)}")
    ok = (counts["fused_attention"] == per_forward and counts["fused_encoder_block"] == 0
          and k1_c == kernels and not block_c
          and len(eligible) == per_forward
          and all(torch.isfinite(v.float()).all() for v in out.values()))
    if dtype == torch.float32:
        cpu_model = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            on_cpu = cpu_model(*(torch.from_numpy(a) for a in inputs))
        worst = max(float((out[k].cpu() - on_cpu[k]).abs().max()) for k in on_cpu)
        text += f"; card vs CPU max_abs_err {worst:.3g} (tol 1e-4) over {', '.join(on_cpu)}"
        ok = ok and worst <= 1e-4
        del cpu_model, on_cpu
    say(text)
    if not ok:
        fail(f"phase {phase} check failed in {name}: K1 {kernels} at the fusion and "
             f"box-decoder layers, no K2, no eligible self-attention on the plain path, "
             f"finite outputs (float32: equal to the CPU's within 1e-4)")
    del model, out
    return counts, k1_c


def past_256(torch, np, dev, counted) -> tuple:
    """Phase 24, the paths past head dim 256, each driven through the entry
    point a user calls, its launches read from the wrappers and from the C
    libraries' counts (``c_counts``), which must name the kernels past depth
    256 (the deep, wgmma and short ones) and only them:

    1. bf16 serving, ``InferencePipeline.run`` (pool) at bench.py's widths
       with the executor at d_model 2048 (4 heads of 512, ffn 8192) on
       ``NEW_WIDTH_QUESTIONS`` synthetic questions: K2 3 and K1 2 launches a
       forward, K2's attention (float32 q/k/v) on
       ``attention_kernel_wide_f32``, K1 (the box decoder's 10 keys) on
       ``attention_kernel_short``; questions/s, median of 3 runs after a
       warm-up;
    2. ``run_cogent_protocol`` as ``cogent-protocol --d_model 1536`` runs it
       (float32, 4 heads of 384, ``NEW_WIDTH_PROTOCOL``'s sizes and steps):
       its evaluations launch K2 on every fusion layer, its attention on
       ``attention_kernel_wide_f32``, and K1 on the box decoder, on
       ``attention_kernel_short_f32``, no eligible self-attention on the
       plain path, and its fine-tuned models' valA evaluation on the card
       equal to the CPU's (``protocol_card_vs_cpu``);
    3. an executor eval forward at d_model 1100 (4 heads of 275, where K2
       does not route) in float32 and in bf16 on phase 8's inputs: K1 on
       every fusion layer (L = 210, ragged: ``attention_kernel_deep_f32``,
       in bf16 ``attention_kernel_wgmma_deep``, rows of 550 bytes) and on
       the box decoder (the short kernels); the float32 outputs against the
       CPU's within 1e-4;
    4. ``bench_block.main`` at d_model 2048 (B=128, L=224, K3 at one
       tiling): K2's attention on ``attention_kernel_wide_f32``, K3's on
       ``attention_kernel_wgmma_deep``; K2's and K3's ms printed, K3's beside
       its time on the deep kernel (``PARENT_K3_HD512_MS``); then at L=304,
       K3's attention on ``attention_kernel_wgmma_2pass_deep``.

    Returns each path's wrapper launches and each path's launches of the
    kernels past depth 256 (deep_f32, wide_f32, wgmma_deep, wgmma_2pass_deep,
    short) by the C libraries' counts."""
    from explainable_spatial_vqa_tpu_torch import bench_block
    from explainable_spatial_vqa_tpu_torch.bench_cogent import ProtocolParts, part_rows
    from explainable_spatial_vqa_tpu_torch.evalsuite.cogent import run_cogent_protocol

    t_phase = time.perf_counter()
    paths, deep = {}, {}

    def deep_of(*counts):  # the kernels past depth 256's launches among C counts
        return {n: sum(c.get(n, 0) for c in counts)
                for n in (DEEP_F32, WIDE_F32, WGMMA_DEEP, WGMMA_2PASS_DEEP, SHORT, SHORT_F32)}

    # ---- 24.1 bf16 serving with the executor at d_model 2048 ----
    run = serving_run(torch, np, dev, counted, 2048)
    served, counts, (k1_c, block_c), once, exe_cfg = (run[k] for k in (
        "served", "counts", "c_counts", "forwards", "config"))
    n = NEW_WIDTH_QUESTIONS
    say(f"phase 24.1 bf16 serving (ffn 8192), {serving_text(run)}")
    serving_checks = {
        "K2 3 and K1 2 launches a forward": (
            counts["fused_encoder_block"] == exe_cfg.encoder_layers * once
            and counts["fused_attention"] == exe_cfg.box_decoder_layers * once > 0),
        "K1 (10 keys, bf16) on attention_kernel_short, K2's attention (float32 q/k/v) on "
        "attention_kernel_wide_f32": (
            k1_c == {SHORT: counts["fused_attention"]}
            and block_c == {block_attention_kernel(512, 210, "fp32"):
                            counts["fused_encoder_block"]}),
        "no self-attention K1 takes on the plain path": run["eligible"] == counts["fused_attention"],
        "one answer per question in the token vocabulary": (
            served.answers.shape == (n,) and 0 <= served.answers.min()
            and served.answers.max() < exe_cfg.token_classes),
    }
    for name, ok in serving_checks.items():
        if not ok:
            fail(f"phase 24.1 serving check failed: {name}")
    paths["serving_d2048"] = counts
    deep["serving_d2048"] = deep_of(k1_c, block_c)
    torch.cuda.empty_cache()

    # ---- 24.2 cogent-protocol --d_model 1536 ----
    t0 = time.perf_counter()
    read = c_counts(torch)
    with ProtocolParts() as parts, plain_self_attention_count() as eligible:
        result, counts = counted(lambda: run_cogent_protocol(
            **NEW_WIDTH_PROTOCOL, d_model=1536, device=dev))
    k1_c, block_c = read()
    rows = [r for r in part_rows(parts) if r["part"].startswith("evaluation")]
    say(f"phase 24.2 cogent-protocol --d_model 1536 (4 heads of 384), float32, "
        f"{NEW_WIDTH_PROTOCOL}: {time.perf_counter() - t0:.1f} s; {result['report'].report()}; "
        f"launches {counts}; per evaluation "
        + ", ".join(f"{r['part'].split()[1]} K2 {r['K2']} K1 {r['K1']}" for r in rows)
        + f"; the C libraries' counts: K1 {k1_c}, K2's attention {block_c}; eligible "
        f"self-attention calls {len(eligible)}")
    if not (rows and all(r["K1"] > 0 and r["K2"] > 0 for r in rows)
            and counts["fused_attention"] == sum(r["K1"] for r in rows)
            and counts["fused_encoder_block"] == sum(r["K2"] for r in rows)
            and k1_c == {SHORT_F32: counts["fused_attention"]}
            and block_c == {block_attention_kernel(384, 208, "fp32"):
                            counts["fused_encoder_block"]}
            and len(eligible) == counts["fused_attention"]):
        fail("phase 24.2 check failed at d_model 1536: the evaluations launch K2, its attention "
             "on attention_kernel_wide_f32, and K1 on attention_kernel_short_f32, only there, "
             "and no self-attention K1 takes runs the plain path")
    protocol_card_vs_cpu(torch, np, parts.of("evaluate_pipeline_synthetic")[2],
                         "cogent-protocol --d_model 1536", phase=24)
    paths["cogent_protocol_d1536"] = counts
    deep["cogent_protocol_d1536"] = deep_of(k1_c, block_c)
    del result, parts
    torch.cuda.empty_cache()

    # ---- 24.3 K1 alone past 16 keys: the executor at d_model 1100 ----
    forward_counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "fp32" if dtype == torch.float32 else "bf16"
        forward_counts[name], k1_c = executor_forward(torch, np, dev, counted, 1100, dtype,
                                                      "24.3")
        deep[f"executor_d1100_{name}"] = deep_of(k1_c)
    paths["executor_d1100"] = {k: sum(c[k] for c in forward_counts.values())
                               for k in forward_counts["fp32"]}
    torch.cuda.empty_cache()

    # ---- 24.4 the block bench at d_model 2048: K3 at head dim 512 ----
    # at L = 224 (K3's attention on attention_kernel_wgmma_deep) and 304
    # (past 256 keys: attention_kernel_wgmma_2pass_deep)
    for length, path in ((224, "block_bench_d2048"), (304, "block_bench_d2048_L304")):
        argv = ["--batches", "128", "--iters", "2", "--tiles", "2", "--d_model", "2048",
                "--heads", "4"] + (["--length", str(length)] if length != 224 else [])
        read = c_counts(torch)
        rows, counts = counted(lambda: bench_block.main(argv))
        _, block_c = read()
        say(f"phase 24.4 block bench at d_model 2048, 4 heads (bench_block.main {' '.join(argv)}, "
            f"bf16, L={length}, no mask): "
            + "; ".join(f"{name} {ms:.3f} ms {tflops:.1f} TFLOP/s" for _b, name, ms, tflops in rows)
            + f"; launches {counts}; K2's and K3's attention by the C library's counts {block_c}"
            + ("; with K3's attention on attention_kernel_deep before (PERF.md §6): " + ", ".join(
                f"{name} {ms} ms" for name, ms in PARENT_K3_HD512_MS.items())
               if length == 224 else ""))
        want = block_attention_kernel(512, length, "bf16")
        if not (counts["fused_encoder_block_tiled"] > 0
                and block_c == {block_attention_kernel(512, length, "fp32"):
                                counts["fused_encoder_block"],
                                want: counts["fused_encoder_block_tiled"]}):
            fail(f"phase 24.4: the block bench at d_model 2048, L={length}, did not launch K2's "
                 f"attention on attention_kernel_wide_f32 and K3's on {want}")
        paths[path] = counts
        deep[path] = deep_of(block_c)
    say(f"phase 24 the kernels past depth 256's launches by path (the C libraries' counts): "
        f"{deep}")
    say(f"phase 24 took {time.perf_counter() - t_phase:.1f} s")
    return paths, deep


# ---------------------------------------------------------------------------
# phase 25: the executor at d_model 768 and 1280 (the one-pass wgmma kernels
# at padded depths 192 and 336)
# ---------------------------------------------------------------------------

# d_model (4 heads), the kernel of the fusion layers' self-attention (L = 210)
# and of the box decoder's (10 keys)
WGMMA_PADDED_WIDTHS = ((768, WGMMA, SHORT), (1280, WGMMA_DEEP, SHORT))


def wgmma_padded_paths(torch, np, dev, counted) -> tuple:
    """Phase 25, bf16 serving (``serving_run``: ``InferencePipeline.run``,
    pool, at bench.py's widths on ``NEW_WIDTH_QUESTIONS`` synthetic
    questions) with the executor at each width of ``WGMMA_PADDED_WIDTHS``:
    25.1 at d_model 768 (4 heads of 192, padded depth 192), 25.2 at 1280 (4
    heads of 320, padded depth 336).  Their head dims are not multiples of
    128, so no K2: K1 on the 3 fusion layers of every forward (210 keys,
    ragged) on ``attention_kernel_wgmma`` or ``attention_kernel_wgmma_deep``
    and on the 2 box-decoder layers (10 keys) on the short kernel,
    by the C library's counts, and no eligible self-attention on the plain
    path; questions/s, the median of 3 runs after a warm-up.  Then 25.3 and
    25.4, one float32 executor eval forward at each width
    (``executor_forward``): K1's fusion layers on
    ``attention_kernel_wide_f32``, its box decoder on
    ``attention_kernel_short_f32``, card against the CPU.  Returns each
    path's wrapper launches and its launches by kernel (the C libraries'
    counts)."""
    t_phase = time.perf_counter()
    paths, by_kernel = {}, {}
    for part, (d_model, fusion, decoder) in enumerate(WGMMA_PADDED_WIDTHS, 1):
        run = serving_run(torch, np, dev, counted, d_model)
        served, counts, (k1_c, block_c), once, cfg = (run[k] for k in (
            "served", "counts", "c_counts", "forwards", "config"))
        n = NEW_WIDTH_QUESTIONS
        say(f"phase 25.{part} bf16 serving, {serving_text(run)}")
        checks = {
            "no K2, K1 5 launches a forward": (
                counts["fused_encoder_block"] == 0 and not block_c and once > 0
                and counts["fused_attention"] == (cfg.encoder_layers
                                                  + cfg.box_decoder_layers) * once),
            f"K1 on {fusion} in the fusion layers (210 keys), on {decoder} in the box decoder "
            f"(10 keys)": k1_c == {fusion: cfg.encoder_layers * once,
                                   decoder: cfg.box_decoder_layers * once},
            "no self-attention K1 takes on the plain path": (
                run["eligible"] == counts["fused_attention"]),
            "one answer per question in the token vocabulary": (
                served.answers.shape == (n,) and 0 <= served.answers.min()
                and served.answers.max() < cfg.token_classes),
        }
        for name, ok in checks.items():
            if not ok:
                fail(f"phase 25.{part} serving check failed at d_model {d_model}: {name}")
        paths[f"serving_d{d_model}"] = counts
        by_kernel[f"serving_d{d_model}"] = k1_c
        del run, served
        torch.cuda.empty_cache()
    # float32: the fusion layers on attention_kernel_wide_f32, the box decoder
    # on attention_kernel_short_f32
    for part, (d_model, _, _) in enumerate(WGMMA_PADDED_WIDTHS, len(WGMMA_PADDED_WIDTHS) + 1):
        counts, k1_c = executor_forward(torch, np, dev, counted, d_model, torch.float32,
                                        f"25.{part}")
        paths[f"executor_d{d_model}_fp32"] = counts
        by_kernel[f"executor_d{d_model}_fp32"] = k1_c
    torch.cuda.empty_cache()
    say(f"phase 25 the executor at d_model 768 and 1280, launches by path (the C library's "
        f"counts): {by_kernel}; phase 25 took {time.perf_counter() - t_phase:.1f} s")
    return paths, by_kernel


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_rank(rank: int, port: int, workdir: str) -> None:
    """Phase 20.3's rank ``rank`` of 2 (``chip_smoke.py --dp-rank RANK PORT
    DIR``): joins the gloo group, runs the sharded float32 ``run_pool`` at
    bench.py's widths (from weights of its own seed: the runner broadcasts
    rank 0's) and one data-parallel ``executor_roi`` step on its half of
    phase 20.2's batch (from weights of its own seed: the trainer
    broadcasts rank 0's), and writes its findings against phase 20.2's
    references in ``DIR`` to ``DIR/rank<RANK>.json``."""
    if not (REPO / "explainable_spatial_vqa_tpu_torch" / "csrc").is_dir():
        fail(f"no checkout of the repository next to {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
        fused_encoder_block,
        fused_encoder_block_tiled,
    )
    from explainable_spatial_vqa_tpu_torch.ops.matching import hungarian_assignment_device
    from explainable_spatial_vqa_tpu_torch.parallel import multihost
    from explainable_spatial_vqa_tpu_torch.parallel.mesh import make_mesh
    from explainable_spatial_vqa_tpu_torch.train.pipelines import executor_pipeline_from_arrays
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

    workdir = Path(workdir)
    dev = torch.device("cuda")
    multihost.initialize(f"localhost:{port}", num_processes=2, process_id=rank, backend="gloo")
    mesh = make_mesh()
    wrappers = (fused_attention, fused_encoder_block, fused_encoder_block_tiled,
                hungarian_assignment_device)
    report = {"rank": rank}

    exe_cfg, thresholds, feats_dev, _questions, chains = serving_inputs(torch, np, dev)
    executor = init_parameters(ProgramExecutor(exe_cfg, torch.float32, device=dev),
                               seed=2 + rank)
    runner = ExecutorChainRunner(executor, exe_cfg, 27, thresholds, device=dev, mesh=mesh)
    runner.run_pool(feats_dev, chains)  # warm-up: this process's first calls
    log = ForwardLaunches(executor)
    for w in wrappers:
        w.launches = 0
    torch.distributed.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.run_pool(feats_dev, chains)
    report["pool_s"] = time.perf_counter() - t0
    report["counts"] = {w.__name__: w.launches for w in wrappers}
    log.remove()
    c = log.tally()
    report["forwards"] = c["forwards"]
    report["per_forward_ok"] = per_forward_ok(c, exe_cfg)
    report["rows"] = len(chains.num_steps[rank::2])
    ref = dict(np.load(workdir / "pool_float32.npz"))
    report["differences"] = decision_differences(np, out, ref, thresholds, chains)

    for dtype in DP_DTYPES:
        cfg = dp_executor_config(rank, dtype)
        arrays, features, batch = dp_batch(np, cfg)
        half = len(batch["text"]) // 2
        mine = {k: v[rank * half:(rank + 1) * half] for k, v in batch.items()}
        pipe = executor_pipeline_from_arrays(cfg, arrays, torch.from_numpy(features).to(dev),
                                             device=dev)
        trainer = Trainer(pipe.loss_fn, pipe.model, cfg.optim, cfg.train, checkpoint_dir=False,
                          device=dev)
        if not trainer.data_parallel:
            fail(f"rank {rank}: the trainer is not data parallel")
        acc = trainer.train_epoch([mine], seed=0, epoch=0)
        grads = {n: p.grad for n, p in pipe.model.named_parameters() if p.grad is not None}
        reference = torch.load(workdir / f"step_{dtype}.pt", weights_only=False)
        report["step_" + dtype] = step_agreement(torch, pipe.model, acc.totals["loss_sum"],
                                                 grads, reference)
    report["step_rows"] = half
    report["box_rows"] = int(mine["is_box_branch"].sum())
    report["target_boxes"] = int(mine["target_box_mask"].sum())
    (workdir / f"rank{rank}.json").write_text(json.dumps(report))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--k3-draws"] and len(sys.argv) == 3:
        k3_draws(parse_draws(sys.argv[2]))
    elif sys.argv[1:2] == ["--dp-rank"] and len(sys.argv) == 5:
        dp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:] in (["--routing"], ["--matcher"]):
        alone(sys.argv[1][2:])
    elif len(sys.argv) > 1:
        fail(f"usage: {sys.argv[0]} [--k3-draws START:STOP | SEED[@OFFSET],... | "
             "--dp-rank RANK PORT DIR | --routing | --matcher]")
    else:
        main()
