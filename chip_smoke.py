"""On-card smoke test of the PyTorch/CUDA port (``aaclip_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Phases, each of which fails the run:
 1. the card's name and power limit (nvidia-smi);
 2. build every kernel from the sources in ``aaclip_tpu_torch/kernels/
    csrc``, one nvcc per source started together, and print nvcc's
    register and spill report for every instantiation, with ptxas's
    C75xx notes on serialized wgmma products;
 3. hold each kernel against its plain PyTorch version on the card, at the
    main paths' shapes, at ragged sequence lengths, at the edges of the
    TMA + wgmma kernels' 128-row tiles (S 128, 129, 256, valid_len 128 of
    200, a batch of 3 at S 200) and at head dim 16, in bf16 and fp32: the
    forward attention, its logsumexp output against ``torch.logsumexp`` of
    the plain scores, the backward kernel's dq, dk and dv (and two runs of
    it bit for bit), a batch whose image 1 is NaN (images 0 and 2 as with
    image 1 zero, bit for bit, in every attention launch), and the bf16
    ``matmul_f32`` gradients against fp64; then the 3-pass mode (fp32 under
    precision "high"; at head dim 64 the split kernel ``split2`` and the
    ``*_3pass_wgmma`` TMA + wgmma kernels, at 16 the mma.sync kernels) of
    the forward, its logsumexp, the backward (twice bit for bit), the V-V
    mode and B4 against their plain 3-pass versions at the predict's and
    the step's fp32 batch 8, ragged S, valid_len < S and head dim 16, the
    NaN image, each launch and split counted; the 6-pass route (fp32 at
    head dim 64 under "highest" or None: the split kernel ``split3`` and
    the ``*_6pass`` TMA + wgmma kernels) through every fp32 check above,
    each launch's route counted, both split kernels bit for bit against
    ``split3_plain`` and ``split2_plain`` (and ``split2``'s planes against
    ``split3_plain``'s first two), and each fp32 route's distance from
    fp64 (6-pass within 4e-6 of each output's max, 3-pass within 1.8e-5,
    what the mma.sync kernels it replaced read, beside the head-dim-16 FMA
    kernels');
 4. the inference path (ViT-L-14-336 @ 518 px, random weights from a seed)
    through ``make_predict_fn``: bf16 with uint8 inputs at batch 8 and fp32
    at batch 2, each against the same predictor with the plain attention,
    counting kernel launches (fp32's all on the 6-pass route, each after a
    ``split3`` launch); bf16 against fp32 on the same images (printed,
    the scale of bf16's own rounding); and tiny-test on the card against
    the CPU;
 5. the stage-2 training step (the same model, bf16) through
    ``make_stage2_step``: at batch 2 with remat, the kernel step against the
    plain-attention step from the same adapter (loss and every adapter
    gradient), counting 47 forward and 23 backward launches; the same
    step under selective remat, 24 forward and 23 backward launches (no
    attention forward rerun), bit for bit against the full-remat step (or,
    if not, phase 5's bars against the plain step, naming whether the
    forward or the backward differs); five kernel steps at batch 8 each
    without remat, with full and with selective remat, counting launches,
    losses finite, peak device memory and images/s printed;
    tiny-test fp32 steps on the card against the CPU;
 5b. the fp32 paths that run the 6-pass backward and V-V launches: the
    stage-2 step at batch 2 with remat against the plain-attention step
    (phase 5's bars; 47 forward and 23 backward launches, all 6-pass) and
    spatial stage-1 features at batch 2 against plain (phase 7's bars;
    24 + 19 launches, all 6-pass);
 6. time, with CUDA events: the forward kernel, its plain version and
    torch's SDPA at the predict's attention shape, and the predict in
    maps/s with the kernel and with the plain attention; the backward
    kernel, its plain version and the backward of SDPA at the training
    step's shape, and the step in images/s at batch 8;
 7. the stage-1 path (the same model, bf16, VisA's 12 classes through the
    12-layer text tower): (a) spatial features at batch 2 with the kernels
    against the same features with both attentions plain, counting 24
    standard and 19 V-V launches per call; (b) batch-mode features, 24
    standard and 0 V-V launches; (c) five iterations at batch 16 from
    spatial features, losses finite, peak device memory printed; (d) one
    step from kernel features against one from plain features, from the
    same text adapter (loss, each gradient's cosine and norm); (e)
    tiny-test fp32 features and step on the card against the CPU; then
    the V-V kernel, its plain version and SDPA on the V views at the
    bench's [16, 1370, 1024], and stage-1 images/s at batch 16 in both
    V-V modes.
 8. the fused-block path (``ops/fused_block.py``, ``fused_block.cu``; bf16
    on the TMA + wgmma GEMM, fp32 under "high" on its 3-pass mode, fp32
    under "highest" on its 6-pass mode): (a) ``ln_linear``
    (B5, to 3D and D columns), ``linear_residual`` (B6) and ``mlp_fused``
    (B7, under each activation) against their plain versions in bf16 and
    fp32, each kernel run twice bit for bit, at the predict's batch-32
    rows, a ragged row count, the GEMM's 128-row tile edges (128, 129 and
    255 rows), ViT-B-16's width 768 (hidden 3072) and width 128, fp32's
    6-pass calls counted (3 / 2 / 4 kernels per call) and held within
    SIX_FP64_MAX_REL and SIX_FUSED_FP64_MAX_REL of fp64 (the plain
    version's distance printed beside); then one NaN row of x (and of
    B6's input) in a [3, 200, 1024] batch, which must leave every other
    row of each output bit for bit as with that row zero; (b)
    ``attention_kernel`` (B4, the forward kernel on the [B, H, S, hd]
    layout) against its plain version at [32, 16, 1370, 64], ragged S
    with valid_len < S and head dim 16, and bit for bit against
    ``attention_packed`` on the same values packed; (c)
    the predict with ``block_fn=make_block_fn(...)`` (bf16 uint8 at batch
    8, fp32 at batch 8) against the same predictor on the plain-version
    block with phase 4's bars, 24 launches per call of each of
    ``ln_linear``, ``attention_packed``, ``linear_residual`` and
    ``mlp_fused`` (fp32's all 6-pass, 24 x 9 fused_block kernels) and
    none of ``attention_kernel``, and (printed) its distance from the
    unfused predictor, the fused fp32 predict's maps/s beside the unfused
    one's;
    (d) ``encode_image`` with ``block_fn`` and ``vv_block_fn`` from
    ``vv_start`` 5 (bf16, batch 2) against the plain blocks, counting 24
    ``ln_linear`` (5 to 3072 columns, 19 to 1024), 5 standard + 19 V-V
    attention, 24 ``linear_residual`` and 24 ``mlp_fused`` launches, and a
    width-128 3-layer tower in fp32 on the card against the CPU; (e) CUDA-
    event times at the batch-32 shapes of each kernel, its plain version
    and the library yardstick (the unfused sequence the predict runs for
    B5-B7, SDPA for B4), each bf16 GEMM with output tiles of the source's
    own width, of 128 and of 256 columns (ms per call, and per GEMM launch
    from torch.profiler), and the fused predict's maps/s beside the
    unfused one's; (f-i) the same under fp32_high, the kernels' 3-pass
    mode (B8): B5-B7 against their plain 3-pass versions and fp64 at batch
    8 and the GEMM's edges, 3 / 2 / 4 kernels per call; the fused fp32_high
    predict at batch 8, staged and unstaged, against the plain-block and
    the unfused predicts at phase 11's bars, 24 3-pass calls of each
    wrapper, maps/s beside the unfused ones; the kernels' times at batch 8
    beside their bounds, plain versions and the unfused sequence; and
    ``bench --mode block --precision fp32_high --batch_size 8`` (see the
    notes before ``HIGH_FUSED_CASES``); (j-k) the same under fp32 (the
    6-pass mode): each kernel's ms at batch 8 and 32 beside its bounds
    (six bf16 passes, and one fp32 pass at the FMA rate), its plain
    version and the unfused fp32 sequence, and ``bench --mode block
    --precision fp32 --batch_size 8``.
 9. the evaluation CLI from checkpoints (``python -m aaclip_tpu_torch.test``
    through ``main``): a seeded ViT-L-14-336 at its native 336 px saved as
    an OpenAI-layout state dict (the loader resizes the positional
    embedding 24 -> 37), an npz image adapter and a reference ``.pth``
    text adapter, a synthetic MVTec set (2 classes, 16 normal and 32
    anomalous 1024 px images each); the CLI at bf16 batch 32 and at fp32
    batch 8 with ``--csv --dump_scores``, each held to (a) 24 forward
    kernel launches per predict batch and no other kernel (fp32's on the
    6-pass route, each after a ``split3`` launch), (b) its
    ``scores_1.csv`` bit for bit against a direct ``make_predict_fn`` on
    the same loaded towers and batches, (c) the same loop on the plain
    attention (maps, scores and the metric table, both tables printed);
    then (d) the 3-pass ``M q Mᵀ`` against fp64; with the CLI's logged
    maps/s, the host's decode+resize ms per image and the checkpoint's
    save and load seconds. The host library (``native/``): the metrics
    library must build and be the path the CLI logs; the image library
    (libjpeg/libpng) is held bit for bit against the numpy decode on the
    sample files, or the line naming why it did not build is printed;
    per class, ``metrics_eval`` on the kernel's bf16 maps through the
    library and through numpy, raw AUROC/AP within 1e-10 and the rows
    equal, timed, and ``label_components`` against scipy on one class's
    masks; the bf16 CLI once more in a child process with
    ``AACLIP_NO_NATIVE`` (the numpy metrics and decode), run beside the
    fp32 run's direct checks (its work is the host's), its table equal
    to the library run's, its maps/s and metrics seconds beside them.
10. the training CLI (``python -m aaclip_tpu_torch.train`` through
    ``main``) from phase 9's checkpoint on a synthetic MVTec training set
    (2 classes of 16 images at 1024 px), bf16, at the CLI's batches (16
    text, 2 image), remat auto (selective on the card): the host path (1
    text and 2 image epochs) held to (a) 24 forward launches per stage-1
    features call, 24 forward and 23 backward per stage-2 step and no
    other kernel, (b)
    each stage's step-1 loss against the same update on the plain
    attention (phases 7 and 5's bars), (c) its checkpoints loading into
    fresh adapters and Adam and saving again bit for bit, (d) a resumed
    run (--image_epoch 3) training image epoch 2 only, and (e) the
    evaluation CLI on the trained checkpoints; the host colour jitter
    against the installed Pillow, the card's jitter chain and geometric
    augment against the host's bit for bit; the device path
    (--device_augment --cache_device, one stage-2 epoch) four times, in
    turns without and with --fused_assemble (every epoch's losses bit for
    bit the first's), and
    the spatial V-V mode (one stage-1 epoch, 19 V-V launches per features
    call), with each epoch's logged img/s and host-loop shares beside the
    steps' own rates.
11. fp32_high (3-pass products, the first 6 vision blocks at bf16 on the
    inference path, the attention kernels' 3-pass mode) at ViT-L/518: (a)
    the predict at batch 8, staged and at ``bf16_until`` 0, against the
    same predictor with the plain 3-pass attention (phase 4's fp32 bars;
    6 bf16 + 18 and 0 + 24 three-pass launches per call) and, printed, its
    distance from the fp32 predict; (b) the stage-2 step at batch 2 with
    remat against the plain-attention step (phase 5's bars; 47 forward and
    23 backward launches, all 3-pass); (c) spatial stage-1 features at
    batch 2 against plain (phase 7's bars; 24 + 19 launches, all 3-pass);
    (d) the evaluation CLI at batch 8 from phase 9's checkpoint on one
    class of phase 9's set, its scores bit for bit against a direct
    predict; (e) the training CLI, one text and one image epoch on phase
    10's set (remat auto: selective, 24 forward and 23 backward launches
    per stage-2 step), its step-1 losses against the plain attention
    (phase 10's bars); every 3-pass launch at head dim 64 after its
    ``split2``
    launches (one per forward, two per backward); (f), run after phase
    8e and before phase 9, CUDA-event times of
    each 3-pass kernel (``split2`` included) and its plain 3-pass version,
    each 6-pass kernel (``split3`` included) and the plain fp32 version,
    ``split3`` and ``split2`` alone, and SDPA on the same fp32 inputs, and the
    fp32_high predict's maps/s and stage-2 step's images/s beside fp32's
    (every fp32 launch of those timed runs counted on the 6-pass route).
12. serving and the memory bank at ViT-L/518, bf16, uint8 inputs: (a) the
    mb predict (``eval/memory_bank.py``, 4 seeded support images, a test
    batch of 8) at ``bank_weight`` 0 against ``make_predict_fn`` bit for
    bit, at 0.5 against the same predictor on the plain attention (phase
    4's bars), the support images against their own bank, 24 B1 launches
    per features batch and per mb predict, its maps/s beside the
    predict's at batch 8 and 32 and the seconds per bank build; (b) the
    evaluation CLI with ``--memory_bank --shot 4`` from phase 9's
    checkpoint on phase 9's first class, its scores bit for bit against a
    direct mb predict; (c) the serving engine (``serve/server.py``) from
    phase 9's checkpoint and npz adapters, max_batch 8, the anchor cache in
    a temporary directory (a second engine must read it: no text forward,
    anchors bit for bit), 8 concurrent PNG ``/predict`` requests over 3
    classes (json, f16, u8, map_stride 2) held against a direct predict at
    phase 4's bars plus each encoding's rounding, the stride-2 map against
    the full map sliced exactly, ``/healthz``, ``/classes``, ``/statz``,
    and B1's launches 24 x (the batches ``/statz`` counts + 4 warm-up
    buckets), with the start-up split, each request's latency and the
    phase split printed; (d) ``bench --mode serve`` in-process: closed
    loop with 8 clients of SERVE_CLOSED_REQUESTS requests each (``--steps``
    counts a closed-loop client's requests, as JAX's bench does; exactly
    that many served), open loop at half its rate for 10 s, the closed
    loop with ``--map_stride 4``, no error in any.
13. int8 inference and the exported serving artifact at ViT-L/518: (a)
    the int8 predict (``--precision int8``, uint8 inputs) at batch 32
    against the same int8 trunk on the plain attention (scores at phase
    4's bar, the map at 4e-2 of its span: the per-token int8 scale spreads
    the kernel's ulp differences over whole rows, see the phase's notes),
    24 B1 launches and 96 ``qdot`` calls per predict, 48 at
    ``int8_until`` 12, and (printed) its distance from the bf16 and fp32
    predicts; (b) int8, bf16 and int8_until 12 maps/s at batch 32 and one
    fc product's parts (``dyn_quant``, ``_int_mm`` with either weight
    layout, the dequant, the bf16 GEMM); (c) ``deploy.py``'s export from
    phase 9's checkpoint, bf16 at buckets 1-8 and int8 at 8 (in a child,
    ``chip_smoke.py --export-artifact``, beside the bf16 export), each
    reloaded artifact bit for bit against the live predictor at batch 8
    (or within 1e-4 of the span, printed), and the bf16 artifact's every
    bucket against the live predictor at that batch,
    ``aaclip::attention_packed`` in every program and 24 B1 launches per
    artifact call, every ``.pt2`` under 5% of ``params.npz``, export and
    load seconds; (d) the serving
    engine on the bf16 artifact: start-up beside phase 12's, 8 concurrent
    requests within 1.2e-3 of the span of a direct artifact predict,
    ``bench --mode serve --artifact`` closed loop beside 12d's; (e) ``test
    --artifact`` on one synthetic class, its scores bit for bit a direct
    artifact predict's, and ``test --precision int8`` on the same class.
14. data, tensor and sequence parallelism (``aaclip_tpu_torch/parallel``)
    at ViT-L/518: (a) rank 0 of a world of 1 on NCCL (torchrun's
    variables set here): the DP predict (bf16, B=32, maps/s beside the
    single-process one), two DP stage-2 steps (B=8), DP stage-1 features
    in both V-V modes and a step from them (B=16) and the DP memory bank
    (4-shot, B=8), each bit for bit its single-process path (or within
    1e-6, printed), launches counted; (b) B1, B2 and B3 at the per-rank
    geometries of tensor parallelism at tp 2 and 4 (8 and 4 heads of 64,
    B=8) on the bf16, 6-pass and 3-pass routes, against their plain
    versions at phases 3-4's bars, ms per call beside 16 heads; (c) two
    ranks on the one card, gloo on CUDA tensors: the TP = 2 predict with
    and without SP (bf16 and fp32, B=4) against the single-process predict
    at phase 4's bars (fp32's) and a TP = 2 stage-2 step (B=4; fp32 with
    and without SP) at phase 5's; (d) under
    ``python -m torch.distributed.run --nproc_per_node 1`` (one child
    running ``chip_smoke.py --parallel-clis``): ``test --data_parallel``
    on a 16-image class, its table and scores bit for bit the
    single-process CLI's, ``train --data_parallel`` (one text and one
    image epoch), its per-step losses bit for bit (each data rank loads,
    decodes and predicts only its rows, which at world 1 are all of
    them), and ``bench
    --data_parallel`` beside the plain bench; (e) the serving engine with
    ``data_parallel=True`` (one replica), every answer bit for bit the
    engine's without it, live and (inside 13d) on the bf16 artifact.
15. the GPipe pipeline (``parallel/pipeline.py``), the panels of ``test
    --visualize`` and the object facades at ViT-L/518: (a-c) two ranks on
    the one card, gloo on CUDA tensors (a hop through a pinned host
    buffer), pp = 2: the predict at B=8 with 2 and 4 microbatches, bf16 at
    phase 4's bars and fp32 within 1e-5 of the map's span and 1e-5 on the
    scores, against the single-process predict on the same float images,
    12 x n_micro B1 launches per rank, the ms per call and per hop
    printed; the stage-2 step (2 microbatches) in bf16 at B=8, remat off
    and full, and in fp32 at B=4, against the single-process step with
    ``grad_accum`` 2 (loss and gradients at phase 5's and 14c's bars,
    every updated entry within 2 lr), B1 and B2 launches per rank (24 /
    24 and 22 / 24; 46 / 48 B1 under full remat); the stage-1 features in
    bf16 at B=4, spatial against the single process and batch mode
    against it per microbatch (phase 7's bars), 24 / 24 B1 and 14 / 24
    B3 (spatial) per rank; (d) both CLIs' ``--pipeline_parallel 2`` in one
    process exit as JAX's, and ``test --visualize`` on a synthetic class of
    8 images writes 8 panels of [3 x 518, 518, 3] whose image and mask
    rows are cv2's bit for bit, then ``visualize`` on random maps, every
    panel cv2's bit for bit (where cv2 imports); (e) ``AdaptedCLIP.create``
    on the card, its forward bit for bit ``adapted_forward``, 24 B1
    launches.
16. the practitioner tools and examples (``aaclip_tpu_torch/tools``,
    ``aaclip_tpu_torch/examples``) through their ``main``: (a)
    ``predict_folder`` at ViT-L/518, bf16, batch 8, on 12 seeded PNGs of
    mixed sizes from phase 9's checkpoint and seeded npz adapters, every
    ``scores.csv`` row bit for bit the direct predict's on the same
    decoded batch, 24 B1 launches per batch, a heatmap per image, images/s
    over the whole run; (b) ``predict_folder --artifact`` on phase 13's
    ViT-L int8 artifact, bit for bit its ``predict_class``; (c)
    ``zero_shot`` at ViT-L/518, its printed score the direct predict's;
    (d) ``few_shot_soak`` at tiny-test (``--shots 2 4 --memory_bank``, one
    epoch each), B1 and B2 launched; (e) ``precision_ab`` at tiny-test,
    bf16 against int8, its verdict passed and its margins printed; (f)
    ``serve_smoke`` against the port's server in a child process on the
    card, started first and run beside (a-e).
17. the packed attention at head dims 80 and 128 and open_clip's
    ViT-H-14 @ 518: (a) B1 (and its logsumexp), B3 and B4 at head dim 80
    (16 heads, ViT-H-14's) and 128 (8 heads, a ViT-L width) on the bf16,
    6-pass and 3-pass routes, at S 1370 for batches 8 and 32 and at ragged
    S and valid_len, against their plain versions at phase 3's bars, B3
    and B4 bit for bit B1 on the same values, the fp32 routes within
    SIX_FP64_MAX_REL and HIGH_FP64_MAX_REL of fp64, the NaN image (the
    backward too), every launch counted on the route's TMA + wgmma
    kernel (and its splits); each kernel's ms beside its plain version,
    SDPA and its bound; (b) ViT-H-14 from a JSON config that
    ``AACLIP_MODEL_CONFIGS`` names (random weights from seeds): the
    predict in bf16 at batch 32, fp32 and fp32_high (staged) at 8 against
    the same predictor on the plain attention (phases 4 and 11's bars), 24
    B1 launches a call (the blocks up to the last tap), maps/s; the
    spatial stage-1 features at batch 2 (phase 7's bars, 19 B3 launches);
    ``bench --model_name ViT-H-14`` in
    the three precisions; the fused bf16 predict at
    ViT-L in 8 heads of 128 (the gate admits it) against the unfused one
    at phase 8e's bars; (c) B2 at head dims 80 and 128 on the three
    routes, at the step's batch 8 x S 1370 and at ragged S and valid_len,
    against its plain version at phase 3's bars (phase 11's in the 3-pass
    mode) and the fp32 routes against fp64, two runs bit-equal, every
    launch on the route's pair and splits, its ms beside its plain
    version, SDPA's backward and its bound; (d) ViT-H-14's stage-2 step at
    batch 8 in bf16, fp32 and fp32_high under remat off, full and
    selective (24 B1 launches, 47 under full remat, and 23 B2, all on the
    precision's route) against the step on the plain attention at phase
    5's bars, images/s each; the same bf16 step at ViT-L in 8 heads of
    128; the training CLI at ViT-H-14 (one text and one image epoch on two
    synthetic classes, bf16, from a seeded ViT-H-14 checkpoint) and the
    evaluation CLI on what it trained (a synthetic evaluation set of the
    same two classes), its table and maps/s printed and its scores bit for
    bit a direct predict's with the trained adapters;
    the serving engine's answers against its own predict; the int8
    predict against the plain attention's (phase 13's bars) and, printed,
    the bf16 predict; the memory bank and banked predict (phase 12a's
    bars); the DP step at world 1 against the single-process step.
18. the packed attention at head dims 88 and 104 and open_clip's
    ViT-g-14 and ViT-bigG-14 @ 518: (a) 17a's checks at head dims 88 and
    104 (16 heads each), with NaN and Inf in the odd heads' Q, K and V
    columns leaving each even head's output and logsumexp bit for bit
    (Q K^T's last k-step there reads 8 columns past the head, which must
    be zeros; 17a runs it too), SDPA's backend named; (b) both towers
    from their published JSON configs (random weights from seeds): the
    architecture read, the fused gate None, the predict in bf16 at batch
    32 (the kernel's map against the plain attention's at phase 4's bar,
    or past it within VS_SDPA_MEAN / VS_SDPA_MAX of SDPA's distance, as
    phase 9 holds the evaluation CLI's; the fp32 map's distance printed),
    fp32 and fp32_high at 8 (phases 4 and 11's bars), 24 B1 launches a
    call; ``bench --model_name`` at each in bf16; at ViT-g-14 the spatial
    stage-1 features; at ViT-bigG-14 the serving
    engine's answers against its own predict; (c) 17c's checks of the
    backward at 88 and 104 on the three routes, and NaN and Inf in the odd
    heads' Q, K, V columns (NaN in their dO columns) leaving each even
    head's dQ, dK and dV bit for bit (the last k-step of S, dP, S^T and
    dP^T reads 8 columns past the head, and each gradient's last chunk
    ends at the head dim); (d) both towers' stage-2 step at batch 8 in
    bf16, fp32 and fp32_high (remat off; 24 B1 and 23 B2 launches a step
    on the precision's route) against the step on the plain attention at
    phase 5's bars, images/s and peak memory each; the DP step at world 1
    at ViT-bigG-14; the training CLI at ViT-g-14 (one text and one image
    epoch from a seeded fp16 checkpoint) and the evaluation CLI on what it
    trained, its scores bit for bit a direct predict's with the trained
    adapters.
Phase 3 also holds the V-V mode of the forward kernel (B3) against its
plain version, in bf16 and fp32, at [16, 1370, 1024], ragged S and head
dim 16, and against the standard mode on the value section tripled.
Then it prints the whole script's time and the kernel table as one JSON
line (the 3-pass and 6-pass modes, ``split3`` and ``split2`` as rows of
their own; B5-B7's 3-pass rows with their distance from fp64;
each 6-pass row's ``calls`` are the fp32 paths' launches, its
``launches`` phase 4's fp32 predict's for B1 and ``split3``, phase 5b's
for B2 and B3) (``launches`` counts the
wrapper's calls on the main path; B4's is read after the fused predict,
where it must be 0, since no path runs B4; ``calls`` gives B1's, B2's
and B3's launches on each path that runs them, the training CLI's runs
and phase 12's paths included; ``ms`` is per call;
``kernels_per_call`` is counted at the library's launch sites in one call
at the timed shape, and torch.profiler must see no device operation but
those kernels in three calls, no cast or copy, and each of them at least
once in up to DEVICE_OPS_TRACES traces: 1 for the forward, 2 for the
backward (a dQ and a dK/dV kernel), 2 for ``ln_linear`` (row
statistics, GEMM), 1 for ``linear_residual``, 3 for ``mlp_fused``
(statistics, fc, proj), and on the 3-pass mode 3, 2 and 4 (the splits
into planes before the GEMMs); the fp32 attention routes add their
splits), the card
line, and the result line ``{"ok":
true, "device": {...}}`` last. Exits non-zero without a result
when there is no card.
"""

from __future__ import annotations

import copy
import functools
import json
import math
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

# bf16 kernel vs plain: P is rounded to bf16 against the running max of
# the online softmax, not the row's final max, and the output is rounded
# to bf16 (2^-8 relative): entries may differ by a few output ulps.
BF16_MAX_ABS, BF16_MEAN_ABS = 2e-2, 2e-3
# fp32 kernel vs plain: both fp32 end to end; only the summation order and
# the online rescaling differ, ~1e-6 relative.
FP32_MAX_ABS = 1e-4
# logsumexp, fp32 in both: __expf's approximation and another summation
# order move the row sum by ~1e-6 relative, lse (~10) by ~1e-5.
LSE_MAX_ABS = 1e-4
# backward kernel vs plain, relative to each gradient's max |value|. bf16:
# both round P for dV, dS, and the outputs to bf16 at the same points, but
# P = exp(s - lse) and e / sum(e) differ by fp32 ulps, so a rounding may
# flip by one bf16 ulp (2^-8) and the output by one ulp of its binade:
# max 2^-6 of the max (two top-binade ulps, with room for the flipped
# terms' sums), mean 2^-10. fp32: the same arithmetic in another order
# over ~1370-term sums, ~1e-6 relative: max 2e-5 of the max.
BWD_BF16_MAX_REL, BWD_BF16_MEAN_REL = 2 ** -6, 2 ** -10
BWD_FP32_MAX_REL = 2e-5
# bf16 matmul_f32 gradients against fp64 of the same bf16 operands: the
# card rounds the cotangent to bf16 and then each gradient to bf16, two
# roundings of 2^-8 relative each: 2^-6 of the gradient's max.
MM_GRAD_MAX_REL = 2 ** -6
# predict, bf16: the attention rounding above moves each of 24 blocks'
# bf16 residual stream by a few ulps; the map may move by a fraction of a
# percent of its span and the scores by well under 5e-3.
PIX_SPAN_FRAC_BF16, SCORE_ATOL_BF16 = 1e-2, 5e-3
# predict, fp32: the kernel's ~1e-6 relative error carried through 24 fp32
# blocks, the projections and the 100x similarity scale.
PIX_ATOL_FP32, PIX_RTOL_FP32, SCORE_ATOL_FP32 = 1e-3, 1e-4, 1e-4
# tiny-test, card (kernel, cuBLAS fp32) vs CPU (plain), fp32 parity policy.
TINY_ATOL, TINY_RTOL = 1e-4, 1e-5
# stage-2 step, bf16 ViT-L, kernel vs plain attention from one adapter:
# the forward and backward kernels each differ from their plain versions
# by about one bf16 ulp per block (phase 3), carried through 24 bf16
# blocks both ways. Read on an NVIDIA H100 80GB HBM3, 700 W: loss 2.8e-5
# relative, every adapter gradient's cosine >= 0.99995 and norm within
# 3.9e-3. Bars about 10x above: loss 5e-4 relative, cosine >= 0.9995
# (1 - cos ten times the reading's), norm within 2e-2.
STEP_LOSS_RTOL, STEP_GRAD_COS, STEP_GRAD_NORM_RTOL = 5e-4, 0.9995, 2e-2
# tiny-test stage-2 step, fp32, card vs CPU: the same fp32 math through
# kernels and cuBLAS in another summation order.
TINY_STEP_LOSS_RTOL, TINY_STEP_GRAD_REL = 1e-5, 1e-4

# stage-1 spatial features, bf16 ViT-L at batch 2, kernels vs both
# attentions plain: each kernel is within about a bf16 ulp of its plain
# version, carried through 24 standard and 19 V-V blocks (the features are
# a unit patch vector plus the unit CLS vector). Read on an NVIDIA H100
# 80GB HBM3, 700 W: max |d| 3.346e-3, least per-token cosine 0.99991481.
# Bars about 10x above: max |d| 3.3e-2, 1 - cosine 1e-3.
S1_FEAT_MAX_ABS, S1_FEAT_COS = 3.3e-2, 0.999
# stage-1 step from kernel features vs from plain features, same adapter:
# the 100x similarity scores carry that feature difference into the loss.
# Read on the same card: loss 2.803e-3 relative, each text-adapter
# gradient's cosine >= 0.99981563 and norm within 3.032e-2. Bars about 10x
# above: loss 3e-2 relative, 1 - cosine 2e-3, norm within 0.3.
S1_STEP_LOSS_RTOL, S1_STEP_GRAD_COS, S1_STEP_GRAD_NORM_RTOL = 3e-2, 0.998, 0.3
# tiny-test stage-1, fp32, card vs CPU: features as TINY_*; the step as
# TINY_STEP_*.

# Phase 8. B5-B7 kernel vs plain, bf16: both round the normalised rows,
# the MLP's hidden and the output to bf16 at the same points and sum in
# fp32 in another order (~1e-6 relative), which can flip an output
# rounding by one bf16 ulp (at most 2^-7 of the value); a flipped rounding
# inside (a normalised or hidden element) moves the output by a small
# fraction of that. Per element |d| <= 2^-7 |plain| + 2^-10 max |plain|,
# mean |d| <= 2^-10 mean |plain|. (Read on an NVIDIA H100 80GB HBM3,
# 700 W, on the TMA + wgmma GEMM at the batch-32 rows: ln_linear max
# 1.562e-2, one ulp at [2, 4), mean 8.2e-7; mlp_fused max 3.125e-2, one
# ulp at [4, 8), mean 2.7e-6; linear_residual 0: it sums in cuBLAS's order
# there. The tile edges, ragged rows and width 768 read no more.)
FUSED_BF16_REL, FUSED_BF16_OF_MAX, FUSED_BF16_MEAN = 2 ** -7, 2 ** -10, \
    2 ** -10
# fp32: the 6-pass mode's six bf16 products (dropping terms of ~2^-24
# relative) against cuBLAS's fp32 SGEMM, each summing 128-4096 terms in
# its own order, and erff/tanhf/expf against torch's (an ulp or two):
# ~1e-6 of the output's max |value| (read on an NVIDIA H100 80GB HBM3,
# 700 W: at most 2.0e-6 of it, the kernel 2.7-3.3e-7 of it from fp64 and
# the plain version 1.0-2.0e-6; the FMA kernels it replaced read 1.8e-6);
# bar 1e-5 of it.
FUSED_FP32_OF_MAX = 1e-5
# The fused 6-pass kernels' own distance from fp64, which tells the
# "highest" mode from the "high" one: on an NVIDIA H100 80GB HBM3, 700 W,
# the 6-pass kernels read 1.0-3.3e-7 of each output's max at every
# FUSED_CASES shape, the 3-pass kernels 5.2e-6 / 3.3e-6 / 3.6e-6 (B5 / B6
# / B7) at batch 8. Bar 1e-6 of the output's max: 3x the largest 6-pass
# reading, a third of the smallest 3-pass one, so a 6-pass route that ran
# three passes or dropped the mid terms fails it. SIX_FP64_MAX_REL (the
# 6-pass attention's bar) is held as well.
SIX_FUSED_FP64_MAX_REL = 1e-6
# B4 against its plain version: the bars of the forward kernel (BF16_*,
# FP32_MAX_ABS), whose arithmetic it is; against attention_packed on the
# same values: bit for bit. The fused predict against the plain-block
# predict: phase 4's bars (PIX_*, SCORE_*; read on the same card: bf16 map
# 7.763e-3 of its span, scores 1.9e-5). That bar cannot tell the fused
# chain from the unfused one, and no bar on the map can: 24 bf16 blocks
# spread any moved rounding over the whole map, so the fused and unfused
# predicts sit about as far from the plain-block one (max 7.763e-3 against
# 8.850e-3 of the span, mean 1.307e-3 against 1.511e-3). It catches gross
# faults only; the per-kernel bars of 8a and the encode_image cosines
# carry the check. encode_image, fused blocks against
# plain blocks: the kernels' ulp-level differences through 24 blocks, as
# the stage-1 features (S1_FEAT_COS): every tap token's and the pooled
# embedding's cosine >= 0.999 (read: least 0.99988777); the width-128
# tower in fp32, card vs CPU: TINY_*.
ENC_COS = 0.999

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12  # HBM3
TRAIN_BATCH = 8
STAGE1_BATCH = 16  # the reference's text batch (train.py:35)
STAGE1_SURGERY_UNTIL = 20  # train.py's default: V-V from block 5 of 24


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ops(fn, calls: int = 1) -> dict:
    """The device operations (kernels, copies, fills) of ``calls`` calls of
    ``fn`` under torch.profiler: {name: (count, device microseconds)}.
    One call runs first, untraced, as a warm-up. No profiler schedule: on
    the card's machine a scheduled trace (a warm-up step, then the active
    ones) now and then came back empty several times in a row, and an
    unscheduled one did not in as many traces (NVIDIA H100 80GB HBM3)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation}


# (fn, want, what) of every kernels_per_call, for check_device_ops
DEVICE_OPS_CHECKS = []
# {what: {kernel: device microseconds per call}} of every row
# check_device_ops confirmed, for the phases that read them later (17c,
# 18c: which kernels a backward call launched)
DEVICE_OPS_SEEN = {}
# torch.profiler on the card's machine can return a trace with some or all
# of its device operations missing: torch's own elementwise kernels as well
# as the ctypes libraries' kernels, whether those link the CUDA runtime
# statically (nvcc's default) or shared (-cudart shared). Read on an NVIDIA
# H100 80GB HBM3: few or none came back short in a fresh process, while at
# the end of this script every other trace came back empty (traces then
# ran under a profiler schedule, which device_ops no longer uses).
# check_device_ops traces a function again, up to this many times, until
# every kernel its launch counter names has been seen.
DEVICE_OPS_TRACES = 8


def kernels_per_call(fn, lib, want: dict, what: str) -> int:
    """The kernels one call of ``fn`` launches, counted by library ``lib``
    (a name, or a tuple of names whose counts are summed: the 6-pass
    backward's splits run in the forward's library) at its launch sites
    (``kernels_launched``), which must be ``want``'s total ({a kernel
    name's part: launches per call}); queues ``fn`` for
    ``check_device_ops``."""
    import torch

    from aaclip_tpu_torch.kernels.build import kernels_launched

    libs = (lib,) if isinstance(lib, str) else lib
    before = sum(kernels_launched(n) for n in libs)
    fn()
    torch.cuda.synchronize()
    n = sum(kernels_launched(n) for n in libs) - before
    print(f"{what}: {n} kernels per call (counted at the launch sites)")
    expect(n == sum(want.values()),
           f"{what} launches {n} kernels per call, not {want}")
    DEVICE_OPS_CHECKS.append((fn, want, what))
    return n


def check_device_ops() -> None:
    """The device operations of three calls of each function
    ``kernels_per_call`` counted, under torch.profiler: each must be one of
    its kernels, so that no cast, copy or fill rides along, and every
    kernel the launch counter names must be seen at least once, in up to
    DEVICE_OPS_TRACES traces (the profiler drops events); a row it cannot
    confirm fails. The library counts and the profiler only names. Run
    after the kernels' timings and before the CLIs (phases 9-11): after
    those, the profiler on the card's machine returned empty traces for
    whole rows. The host-bound stage-1 and stage-2 rates read 2-5% lower in
    runs that had traced before them, so phases 5-7 run first; phase 8e
    traces too, so phases 9-11 always ran after a trace."""
    for fn, want, what in DEVICE_OPS_CHECKS:
        seen, us, traces = {}, {}, 0
        while set(seen) != set(want) and traces < DEVICE_OPS_TRACES:
            traces += 1
            for name, (count, t) in device_ops(fn, 3).items():
                part = next((p for p in want if p in name), name)
                seen[part] = seen.get(part, 0) + count
                us[part] = us.get(part, 0.0) + t
            expect(set(seen) <= set(want),
                   f"{what} runs {sorted(set(seen) - set(want))} beside its "
                   f"kernels")
        print(f"{what}: device operations of {3 * traces} calls in {traces} "
              f"trace(s) (profiler): {seen}")
        # each kernel's mean device time times its launches per call
        per_call = {p: us[p] / seen[p] * want[p] for p in want if p in seen}
        total = sum(per_call.values())
        print(f"{what}: device ms per call by kernel (profiler): " + ", ".join(
            f"{p} {t / 1e3:.4f} ({t / total:.1%})"
            for p, t in per_call.items()))
        expect(set(seen) == set(want),
               f"{what}: the profiler saw {sorted(seen)} of {sorted(want)} "
               f"in {traces} traces")
        DEVICE_OPS_SEEN[what] = per_call
    DEVICE_OPS_CHECKS.clear()


def expect(cond: bool, what: str) -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not cond:
        raise AssertionError(what)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    return max((flops / H100_BF16_FLOPS * 1e3, "operations"),
               (nbytes / H100_BYTES_PER_S * 1e3, "bytes"))


def random_qkv(B, S, H, hd, dtype, gen):
    import torch

    x = torch.randn(B, S, 3 * H * hd, generator=gen, device="cuda")
    return x.to(dtype)


# (B, S, heads, head dim, valid_len)
KERNEL_CASES = [
    (2, 1370, 16, 64, 1370),   # ViT-L/518
    (8, 1370, 16, 64, 1370),   # ViT-L/518 at the predict and train batch
    (2, 77, 16, 64, 77),       # ragged: one partial tile
    (2, 257, 16, 64, 257),     # ragged: 4 full tiles + 1 row
    (2, 257, 16, 64, 200),     # keys past valid_len masked
    (3, 26, 4, 16, 26),        # tiny-test geometry, head dim 16
    (2, 257, 2, 16, 257),      # head dim 16, ragged
    # the 128-row tiles of the TMA + wgmma kernels (64-row streamed tiles
    # in the backward): exactly one tile, one row over, two tiles, keys
    # masked at a tile edge, and a batch of 3 whose images' tail tiles end
    # mid-tile (TAIL_CASE below also poisons image 1)
    (2, 128, 16, 64, 128),
    (2, 129, 16, 64, 129),
    (2, 256, 16, 64, 256),
    (2, 200, 16, 64, 128),
    (3, 200, 16, 64, 200),
]
# B, S, heads, head dim, valid_len of the tail check: image 1 is NaN, and
# images 0 and 2 must come out bit for bit as with image 1 zero.
TAIL_CASE = (3, 200, 16, 64, 200)
DTYPES = ("bf16", "fp32")


def torch_dtype(name: str):
    import torch

    return {"bf16": torch.bfloat16, "fp32": torch.float32}[name]


def expect_routed(wrapper, before: int, calls: int, dtype_name: str,
                  hd: int, what: str, precision=None) -> None:
    """The ``calls`` launches of ``wrapper`` since its ``launches_6pass``
    read ``before`` all took the 6-pass route if fp32 at a TMA head dim
    (64, 80, 88, 104, 128) under "highest" or None, and none did
    otherwise."""
    from aaclip_tpu_torch.ops.attention import TMA_HEAD_DIMS

    six = (dtype_name == "fp32" and hd in TMA_HEAD_DIMS
           and precision is None)
    got = wrapper.launches_6pass - before
    expect(got == (calls if six else 0),
           f"{what}: {got} of {calls} launches on the 6-pass route")


def check_kernel(dtype_name: str) -> float:
    """Forward kernel vs plain, and its logsumexp vs ``torch.logsumexp``
    of the plain scores, on the card; returns the largest max |delta| of
    the output at the main path's shape."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_plain)

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = list(KERNEL_CASES)
    if dtype_name == "bf16":  # the timed predict's shape (phase 6)
        cases.append((32, 1370, 16, 64, 1370))
    worst_main = 0.0
    for B, S, H, hd, valid in cases:
        qkv = random_qkv(B, S, H, hd, dtype, gen)
        before = attention_packed.launches_6pass
        got = attention_packed(qkv, H, valid)
        want = attention_packed_plain(qkv, H, valid)
        out2, lse = attention_packed(qkv, H, valid, return_lse=True)
        torch.cuda.synchronize()
        expect_routed(attention_packed, before, 2, dtype_name, hd,
                      "attention_packed")
        d = (got.float() - want.float()).abs()
        mx, mean = d.max().item(), d.mean().item()
        finite = bool(torch.isfinite(got).all())
        same = torch.equal(got, out2)
        lse_err = lse_vs_logsumexp(qkv, H, valid, lse)
        del got, want, d, out2, lse, qkv
        print(f"kernel {dtype_name} B={B} S={S} H={H} hd={hd} "
              f"valid={valid}: max|d|={mx:.3e} mean|d|={mean:.3e} "
              f"finite={finite}; lse max|d|={lse_err:.3e}, out with lse "
              f"identical={same}")
        expect(finite, "kernel output not finite")
        expect(same, "the lse output changed the forward's output")
        expect(lse_err <= LSE_MAX_ABS, f"lse off: {lse_err}")
        if dtype_name == "bf16":
            expect(mx <= BF16_MAX_ABS and mean <= BF16_MEAN_ABS,
                   f"bf16 kernel off: max {mx}, mean {mean}")
        else:
            expect(mx <= FP32_MAX_ABS, f"fp32 kernel off: max {mx}")
        if S == 1370:
            worst_main = max(worst_main, mx)
    return worst_main


def lse_vs_logsumexp(qkv, H, valid, lse) -> float:
    """max |lse - logsumexp(scaled, masked fp32 scores)| over heads in
    chunks of images (the plain scores are [B, H, S, S] fp32)."""
    import torch

    B, S, width = qkv.shape
    hd = width // 3 // H
    worst = 0.0
    for b in range(B):
        q, k = (qkv[b, :, off:off + H * hd].reshape(S, H, hd)
                .transpose(0, 1).float() for off in (0, H * hd))
        s = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        want = torch.logsumexp(s[..., :valid], dim=-1)
        worst = max(worst, (lse[b] - want).abs().max().item())
    return worst


# V-V kernel vs plain, bf16: each row's own key dominates its softmax (the
# self-score |v|^2 hd^-1/2 stands far above the rest), so an output is
# about v itself, up to ~5 in size rather than an average near 0, and one
# flipped bf16 rounding there is an ulp of up to 2^-7 of the value: the
# bar is per element, 2^-7 of the plain output plus 2^-10, mean as above.
# (Read on an NVIDIA H100 80GB HBM3, 700 W: max 1.562e-2 at values in
# [2, 4), mean 2.2e-5.)
VV_BF16_REL, VV_BF16_ABS = 2 ** -7, 2 ** -10

# V-V mode: (B, S, heads, head dim); valid_len is S
VV_CASES = [
    (STAGE1_BATCH, 1370, 16, 64),  # ViT-L/518 at the stage-1 bench's batch
    (2, 1370, 16, 64),             # the features check's batch
    (2, 77, 16, 64),               # ragged: one partial tile
    (2, 257, 16, 64),              # ragged: 4 full tiles + 1 row
    (3, 26, 4, 16),                # tiny-test geometry, head dim 16
    (2, 257, 2, 16),               # head dim 16, ragged
    (2, 128, 16, 64),              # the wgmma kernel's tile edges
    (2, 129, 16, 64),
    (2, 256, 16, 64),
    (3, 200, 16, 64),
]


def check_vv_kernel(dtype_name: str) -> float:
    """The forward kernel's V-V mode vs ``attention_packed_vv_plain`` on
    the card, and vs the standard mode on ``[v, v, v]`` (the same
    arithmetic, bit for bit); returns the largest max |delta| at S 1370."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_vv,
                                                attention_packed_vv_plain)

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst_main = 0.0
    for B, S, H, hd in VV_CASES:
        v = torch.randn(B, S, H * hd, generator=gen, device="cuda").to(dtype)
        before = attention_packed_vv.launches_6pass
        got = attention_packed_vv(v, H, S)
        want = attention_packed_vv_plain(v, H, S)
        torch.cuda.synchronize()
        expect_routed(attention_packed_vv, before, 1, dtype_name, hd,
                      "attention_packed_vv")
        d = (got.float() - want.float()).abs()
        mx, mean = d.max().item(), d.mean().item()
        over = (d - VV_BF16_REL * want.float().abs()).max().item()
        finite = bool(torch.isfinite(got).all())
        del want, d
        same = None
        if B <= 3:
            same = torch.equal(got, attention_packed(
                torch.cat([v, v, v], dim=-1).contiguous(), H, S))
        print(f"V-V kernel {dtype_name} B={B} S={S} H={H} hd={hd}: "
              f"max|d|={mx:.3e} mean|d|={mean:.3e} finite={finite}"
              + ("" if same is None else
                 f"; equals the standard mode on [v, v, v]: {same}"))
        expect(finite, "V-V kernel output not finite")
        expect(same is not False, "V-V mode differs from the standard mode "
               "on the tripled value section")
        if dtype_name == "bf16":
            expect(over <= VV_BF16_ABS and mean <= BF16_MEAN_ABS,
                   f"bf16 V-V kernel off: max {mx} ({over} over 2^-7 of "
                   f"the output), mean {mean}")
        else:
            expect(mx <= FP32_MAX_ABS, f"fp32 V-V kernel off: max {mx}")
        if S == 1370:
            worst_main = max(worst_main, mx)
        del v, got
    return worst_main


def check_bwd_kernel(dtype_name: str) -> float:
    """Backward kernel vs ``attention_packed_bwd_plain`` on the card,
    dq/dk/dv separately, relative to each gradient's max |value|; returns
    the largest max |delta| at the training step's shape."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_bwd_plain)

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst_main = 0.0
    for B, S, H, hd, valid in KERNEL_CASES:
        qkv = random_qkv(B, S, H, hd, dtype, gen)
        d_out = torch.randn(B, S, H * hd, generator=gen,
                            device="cuda").to(dtype)
        _, lse = attention_packed(qkv, H, valid, return_lse=True)
        before = attention_packed_bwd.launches_6pass
        got = attention_packed_bwd(qkv, d_out, lse, H, valid)
        again = attention_packed_bwd(qkv, d_out, lse, H, valid)
        want = attention_packed_bwd_plain(qkv, d_out, H, valid)
        torch.cuda.synchronize()
        expect_routed(attention_packed_bwd, before, 2, dtype_name, hd,
                      "attention_packed_bwd")
        expect(got.dtype == dtype and got.shape == qkv.shape,
               f"d(qkv) {got.dtype} {tuple(got.shape)}")
        # deterministic: no atomics, every element written once
        expect(torch.equal(got, again), "two backward runs differ")
        del again
        expect(bool(torch.isfinite(got).all()), "d(qkv) not finite")
        parts = []
        dm = H * hd
        for i, name in enumerate(("dq", "dk", "dv")):
            g = got[..., i * dm:(i + 1) * dm].float()
            w = want[..., i * dm:(i + 1) * dm].float()
            scale = w.abs().max().item()
            d = (g - w).abs()
            mx, mean = d.max().item(), d.mean().item()
            parts.append(f"{name} max|d|={mx:.3e} ({mx / scale:.2e} of "
                         f"max {scale:.3e}) mean|d|={mean:.3e}")
            if dtype_name == "bf16":
                expect(mx <= BWD_BF16_MAX_REL * scale
                       and mean <= BWD_BF16_MEAN_REL * scale,
                       f"bf16 backward {name} off: max {mx}, mean {mean}, "
                       f"scale {scale}")
            else:
                expect(mx <= BWD_FP32_MAX_REL * scale,
                       f"fp32 backward {name} off: max {mx}, scale {scale}")
            if S == 1370 and B == TRAIN_BATCH:
                worst_main = max(worst_main, mx)
        if valid < S:  # keys past valid_len get no gradient
            tail = got[:, valid:, dm:].float().abs().max().item()
            expect(tail == 0.0, f"dk/dv past valid_len: {tail}")
        del qkv, d_out, lse, got, want
        print(f"backward {dtype_name} B={B} S={S} H={H} hd={hd} "
              f"valid={valid}: " + "; ".join(parts)
              + "; two runs bit-equal")
    return worst_main


def check_tail_isolation(dtype_name: str, precision=None,
                         case=TAIL_CASE) -> None:
    """At ``case`` (TAIL_CASE), image 1 NaN against image 1 zero: a kernel
    whose tail tile of one image read the next image's rows (on [B, H, S,
    hd], image 0's last head reading image 1's first) would carry the NaN
    into images 0 and 2 (a masked key's P = 0 times NaN is NaN). The
    forward and its lse, the backward, the V-V mode and B4 must give
    images 0 and 2 bit for bit the same in both runs, and finite;
    ``precision="high"`` checks the 3-pass mode."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_kernel,
                                                attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_vv)

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, S, H, hd, valid = case
    dm = H * hd
    qkv = random_qkv(B, S, H, hd, dtype, gen)
    d_out = torch.randn(B, S, dm, generator=gen, device="cuda").to(dtype)
    runs = []
    wrappers = (attention_packed, attention_packed_vv, attention_kernel,
                attention_packed_bwd)
    before = [w.launches_6pass for w in wrappers]
    for fill in (float("nan"), 0.0):
        x, g = qkv.clone(), d_out.clone()
        x[1], g[1] = fill, fill
        kw = dict(precision=precision)
        out, lse = attention_packed(x, H, valid, return_lse=True, **kw)
        heads = [x[..., i * dm:(i + 1) * dm].reshape(B, S, H, hd)
                 .transpose(1, 2).contiguous() for i in range(3)]
        runs.append((out, lse,
                     attention_packed_vv(x[..., 2 * dm:].contiguous(), H,
                                         valid, **kw),
                     attention_kernel(*heads, valid, **kw),
                     attention_packed_bwd(x, g, lse, H, valid, **kw)))
    torch.cuda.synchronize()
    for w, b in zip(wrappers, before):
        expect_routed(w, b, 2, dtype_name, hd, f"tail {w.__name__}",
                      precision)
    names = ("forward", "lse", "V-V", "attention_kernel", "backward")
    for name, got, clean in zip(names, *runs):
        same = torch.equal(got[[0, 2]], clean[[0, 2]])
        finite = bool(torch.isfinite(got[[0, 2]]).all())
        print(f"tail {dtype_name}{' 3-pass' if precision else ''} B={B} "
              f"S={S} hd={hd} {name}: images 0 and 2"
              f" with image 1 NaN equal image 1 zero: {same}, finite: "
              f"{finite}")
        expect(same and finite, f"{name} read across images")


def check_matmul_f32_grad() -> None:
    """bf16 ``matmul_f32`` gradients on the card against fp64 products of
    the same bf16 operands and cotangent, at the trunk's fc shape."""
    import torch

    from aaclip_tpu_torch.models.layers import matmul_f32

    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn(2 * 1370, 1024, generator=gen, device="cuda")
    w = torch.randn(1024, 4096, generator=gen, device="cuda") * 0.03
    a = a.to(torch.bfloat16).requires_grad_()
    w = w.to(torch.bfloat16).requires_grad_()
    g = torch.randn(2 * 1370, 4096, generator=gen, device="cuda")
    y = matmul_f32(a, w)
    expect(y.dtype == torch.float32, f"matmul_f32 output {y.dtype}")
    da, dw = torch.autograd.grad(y, (a, w), g)
    expect(da.dtype == dw.dtype == torch.bfloat16,
           f"gradient dtypes {da.dtype}, {dw.dtype}")
    want_a = g.double() @ w.double().t()
    want_w = a.double().t() @ g.double()
    for name, got, want in (("da", da, want_a), ("dw", dw, want_w)):
        scale = want.abs().max().item()
        err = (got.double() - want).abs().max().item()
        print(f"matmul_f32 bf16 backward {name}: max|d|={err:.3e} "
              f"({err / scale:.2e} of max {scale:.3e})")
        expect(err <= MM_GRAD_MAX_REL * scale, f"matmul_f32 {name} off")


def run_predict(predict, adapter, images, anchors, M):
    import torch

    from aaclip_tpu_torch.ops.attention import attention_packed

    zero_counts()
    pix, score = predict(adapter, images, anchors, M)
    torch.cuda.synchronize()
    return pix, score, attention_packed.launches


def phase_predict(vit, adapter, cfg, acfg, anchors, M, card, gen):
    """Phases 4 and 6a: the inference path and its timings; returns
    (forward launches per predict, forward ms, plain ms, SDPA ms).

    ``gen`` draws the images and the timed qkv in the order slice 1's
    script drew them after the anchors, so its readings repeat."""
    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy, get_config
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_plain,
                                                make_attn_fn)
    from aaclip_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix

    heads, img, n_layers = cfg.vision.heads, cfg.vision.image_size, \
        cfg.vision.layers
    bf16 = DtypePolicy.bf16()
    predict_k = make_predict_fn(vit, cfg, acfg, policy=bf16,
                                uint8_inputs=True)
    predict_p = make_predict_fn(
        vit, cfg, acfg, policy=bf16, uint8_inputs=True,
        attn_fn=make_attn_fn(heads, bf16, attention=attention_packed_plain))
    u8 = torch.randint(0, 256, (8, 3, img, img), generator=gen,
                       device="cuda", dtype=torch.uint8)
    pix_k, score_k, main_launches = run_predict(predict_k, adapter, u8,
                                                anchors, M)
    pix_p, score_p, plain_launches = run_predict(predict_p, adapter, u8,
                                                 anchors, M)
    expect(pix_k.shape == (8, img, img) and score_k.shape == (8,),
           f"shapes {pix_k.shape}, {score_k.shape}")
    expect(bool(torch.isfinite(pix_k).all() and torch.isfinite(score_k).all()),
           "bf16 predict output not finite")
    expect(main_launches == n_layers, f"{main_launches} kernel launches")
    expect(plain_launches == 0, f"plain path launched {plain_launches}")
    span = (pix_p.max() - pix_p.min()).item()
    dpix = (pix_k - pix_p).abs().max().item()
    dscore = (score_k - score_p).abs().max().item()
    print(f"predict bf16 B=8: launches={main_launches} per call; map span "
          f"{span:.4f}, max|d map| {dpix:.3e} ({dpix / span:.3e} of span), "
          f"max|d score| {dscore:.3e}")
    expect(dpix <= PIX_SPAN_FRAC_BF16 * span, f"map off: {dpix} of {span}")
    expect(dscore <= SCORE_ATOL_BF16, f"scores off: {dscore}")

    fp32 = DtypePolicy.fp32()
    predict_k32 = make_predict_fn(vit, cfg, acfg, policy=fp32)
    predict_p32 = make_predict_fn(
        vit, cfg, acfg, policy=fp32,
        attn_fn=make_attn_fn(heads, fp32, attention=attention_packed_plain))
    # bf16's own deviation from fp32 on the same weights and images, the
    # scale against which the bf16 kernel-vs-plain bar above is read
    mean = torch.from_numpy(CLIP_MEAN).cuda()[:, None, None]
    std = torch.from_numpy(CLIP_STD).cuda()[:, None, None]
    pix_32, score_32, _ = run_predict(predict_k32, adapter,
                                      (u8.float() / 255.0 - mean) / std,
                                      anchors, M)
    dpix32 = (pix_k - pix_32).abs().max().item()
    span32 = (pix_32.max() - pix_32.min()).item()
    print(f"predict bf16 vs fp32 B=8 (kernel both, same weights and images):"
          f" max|d map| {dpix32:.3e} ({dpix32 / span32:.3e} of the fp32 "
          f"span {span32:.4f}), max|d score| "
          f"{(score_k - score_32).abs().max().item():.3e}")
    del pix_32, score_32

    f32 = torch.randn(2, 3, img, img, generator=gen, device="cuda")
    pix_k, score_k, launches32 = run_predict(predict_k32, adapter, f32,
                                             anchors, M)
    expect_6pass((launches32, 0, 0), "predict fp32 B=2")
    pix_p, score_p, _ = run_predict(predict_p32, adapter, f32, anchors, M)
    expect(launches32 == n_layers, f"{launches32} fp32 kernel launches")
    print(f"predict fp32 B=2: launches={launches32} per call; max|d map| "
          f"{(pix_k - pix_p).abs().max().item():.3e}, max|d score| "
          f"{(score_k - score_p).abs().max().item():.3e}")
    torch.testing.assert_close(pix_k, pix_p, atol=PIX_ATOL_FP32,
                               rtol=PIX_RTOL_FP32)
    torch.testing.assert_close(score_k, score_p, atol=SCORE_ATOL_FP32,
                               rtol=0)
    del predict_k32, predict_p32, pix_k, pix_p

    tiny = get_config("tiny-test")
    tacfg = tiny_acfg()
    outs = []
    for dev in ("cuda", "cpu"):
        tvit = init_vision_params(tiny, seed=0, device="cpu").to(dev)
        tad = init_image_adapter(tiny, tacfg, seed=1, device="cpu").to(dev)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((3, 3, 70, 70)).astype(np.float32)
        a = rng.standard_normal((tiny.embed_dim, 2)).astype(np.float32)
        a /= np.linalg.norm(a, axis=0, keepdims=True)
        tM = fused_postproc_matrix(tiny.vision.grid, 70, "Industrial")
        tp = make_predict_fn(tvit, tiny, tacfg, policy=fp32, device=dev)
        outs.append([t.cpu() for t in tp(tad, torch.from_numpy(x),
                                         torch.from_numpy(a),
                                         torch.from_numpy(tM))])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=TINY_ATOL, rtol=TINY_RTOL)
    print("predict tiny-test fp32: card (kernel, hd 16) matches the CPU")

    # timings at the predict's attention shape
    B, S, hd = 32, cfg.vision.seq_len, cfg.vision.head_dim
    qkv = random_qkv(B, S, heads, hd, torch.bfloat16, gen)
    fwd = functools.partial(attention_packed, qkv, heads, S)
    ms_kernel = cuda_ms(fwd, 20)
    per_call = kernels_per_call(fwd, "attention_packed", {"attn_fwd_wgmma": 1},
                                "attention_packed")
    ms_plain = cuda_ms(lambda: attention_packed_plain(qkv, heads, S), 5)
    q, k, v = qkv.view(B, S, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    ms_sdpa = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 20)
    flops = 4 * B * heads * S * S * hd
    bound_ms, bound_by = bound(flops, B * S * (3 + 1) * heads * hd *
                               qkv.element_size())
    for name, ms in (("kernel", ms_kernel), ("plain", ms_plain),
                     ("sdpa", ms_sdpa)):
        print(f"time attention {name} [{B},{S},{3 * heads * hd}] bf16: "
              f"{ms:.4f} ms/launch ({flops / ms / 1e9:.1f} TFLOP/s; bound "
              f"{bound_ms:.4f} ms by {bound_by}) on {card}")
    del qkv, q, k, v

    u8 = torch.randint(0, 256, (32, 3, img, img), generator=gen,
                       device="cuda", dtype=torch.uint8)
    ms_pred = cuda_ms(lambda: predict_k(adapter, u8, anchors, M), 5)
    ms_pred_p = cuda_ms(lambda: predict_p(adapter, u8, anchors, M), 3)
    for name, ms in (("kernel", ms_pred), ("plain", ms_pred_p)):
        print(f"time predict bf16 B=32 ViT-L/518 ({name} attention): "
              f"{ms:.2f} ms/call, {32 / ms * 1e3:.2f} maps/s on {card}")
    return (main_launches, per_call, ms_kernel, ms_plain, ms_sdpa, bound_ms,
            bound_by)


def tiny_acfg():
    from aaclip_tpu_torch.core.config import AdapterConfig

    return AdapterConfig(levels=(1, 2), image_adapt_until=1)


def train_batch(B, img, gen):
    """Random float images, mask > 0.9, random labels and classes, all
    valid: the JAX package's stage-2 bench batch, made on the card."""
    import torch

    images = torch.randn(B, 3, img, img, generator=gen, device="cuda")
    mask = (torch.rand(B, img, img, generator=gen, device="cuda")
            > 0.9).float()
    label = torch.randint(0, 2, (B,), generator=gen, device="cuda")
    cidx = torch.randint(0, 2, (B,), generator=gen, device="cuda")
    return images, mask, label, cidx, torch.ones(B, device="cuda")


def unit_table(embed_dim, gen, device="cuda"):
    """A random 2-class table of unit anchors [2, D, 2]."""
    import torch

    t = torch.randn(2, embed_dim, 2, generator=gen, device=device)
    return t / t.norm(dim=1, keepdim=True)


def train_step_once(vit, cfg, acfg, adapter, batch, table, *, policy,
                    attn_fn=None, remat, device=None):
    """One stage-2 step from a copy of ``adapter``; returns (loss, {name:
    grad}, forward launches, backward launches, the updated copy)."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_bwd)
    from aaclip_tpu_torch.train.optim import make_image_optimizer
    from aaclip_tpu_torch.train.steps import make_stage2_step

    ad = copy.deepcopy(adapter)
    opt, sched = make_image_optimizer(ad.parameters())
    step = make_stage2_step(vit, cfg, acfg, (opt, sched), table,
                            policy=policy, attn_fn=attn_fn, remat=remat,
                            device=device)
    attention_packed.launches = attention_packed_bwd.launches = 0
    loss = step(ad, *batch)
    if loss.is_cuda:
        torch.cuda.synchronize()
    fwd, bwd = attention_packed.launches, attention_packed_bwd.launches
    grads = {n: p.grad.detach().clone() for n, p in ad.named_parameters()}
    return loss.item(), grads, fwd, bwd, (ad, opt, sched, step)


# the steps' ``remat`` values by name
REMAT_NAMES = {False: "off", True: "full", "selective": "selective"}


def check_selective_step(vit, cfg, acfg, adapter, batch, table, policy,
                         loss_full, g_full, loss_plain, g_plain) -> None:
    """Phase 5, selective remat: the stage-2 step at batch 2 from the same
    adapter launches 24 forward and 23 backward kernels (the backward
    reruns no attention forward) and equals the full-remat kernel step
    (``loss_full``, ``g_full``) bit for bit: the same kernels and products
    on the same operands, only where each is recomputed differs. If it
    does not, it is held to phase 5's bars against the plain-attention step
    (``loss_plain``, ``g_plain``) and the forward's outputs under both
    remat modes are compared, to say whether the forward or the backward
    differs."""
    import numpy as np
    import torch

    n_layers = cfg.vision.layers
    zero_counts()
    loss_s, g_s, fwd, bwd, _ = train_step_once(
        vit, cfg, acfg, adapter, batch, table, policy=policy,
        remat="selective")
    print(f"train bf16 B=2 remat selective: kernel launches forward {fwd}, "
          f"backward {bwd}; loss {loss_s:.6f} (full remat {loss_full:.6f})")
    expect(fwd == n_layers and bwd == n_layers - 1,
           f"selective remat step launches {fwd}, {bwd}")
    same = loss_s == loss_full and all(torch.equal(g, g_full[n])
                                       for n, g in g_s.items())
    if same:
        print("train bf16 B=2: the selective-remat step equals the "
              "full-remat step bit for bit (loss and every adapter "
              "gradient)")
        return
    worst = max((g - g_full[n]).abs().max().item() for n, g in g_s.items())
    from aaclip_tpu_torch.core.params import cast_block_matrices
    from aaclip_tpu_torch.models.vit import adapted_forward
    from aaclip_tpu_torch.ops.attention import make_attn_fn

    outs = []
    for remat in (True, "selective"):  # the step's forward, as it runs it
        seg, det = adapted_forward(
            cast_block_matrices(vit, policy), copy.deepcopy(adapter), cfg,
            batch[0], image_adapt_weight=acfg.image_adapt_weight,
            levels=acfg.levels, proj_relu=acfg.proj_relu, policy=policy,
            remat=remat, attn_fn=make_attn_fn(cfg.vision.heads, policy,
                                              differentiable=True))
        outs.append(torch.cat([t.flatten() for t in seg] + [det.flatten()]))
    where = "the forward" if not torch.equal(*outs) else "the backward"
    cos = min(torch.nn.functional.cosine_similarity(
        g.flatten().double(), g_plain[n].flatten().double(), dim=0).item()
        for n, g in g_s.items())
    norm = max(abs(g.norm().item() / g_plain[n].norm().item() - 1.0)
               for n, g in g_s.items())
    rel = abs(loss_s - loss_plain) / abs(loss_plain)
    print(f"train bf16 B=2: the selective-remat step differs from the "
          f"full-remat one in {where} (loss {loss_s} vs {loss_full}, max "
          f"|d gradient| {worst:.3e}); against the plain step: loss "
          f"{rel:.3e} relative, min cosine {cos:.8f}, max |norm ratio - 1| "
          f"{norm:.3e}")
    expect(np.isfinite(loss_s) and rel <= STEP_LOSS_RTOL
           and cos >= STEP_GRAD_COS and norm <= STEP_GRAD_NORM_RTOL,
           f"selective remat step off: loss {rel}, cosine {cos}, norm "
           f"{norm}")


def phase_train(vit, adapter, cfg, acfg, card):
    """Phases 5 and 6b: the stage-2 step; returns {remat: (forward,
    backward) launches per step} at batch 8."""
    import gc

    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy, get_config
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.ops.attention import (attention_packed_diff_plain,
                                                make_attn_fn)

    n_layers, img = cfg.vision.layers, cfg.vision.image_size
    gen = torch.Generator(device="cuda").manual_seed(5)
    table = unit_table(cfg.embed_dim, gen)
    bf16 = DtypePolicy.bf16()
    batch2 = train_batch(2, img, gen)
    loss_k, g_k, fwd_r, bwd_r, _ = train_step_once(
        vit, cfg, acfg, adapter, batch2, table, policy=bf16, remat=True)
    plain = make_attn_fn(cfg.vision.heads, bf16,
                         attention=attention_packed_diff_plain)
    loss_p, g_p, fwd_p, bwd_p, _ = train_step_once(
        vit, cfg, acfg, adapter, batch2, table, policy=bf16, attn_fn=plain,
        remat=True)
    print(f"train bf16 B=2 remat: kernel launches forward {fwd_r}, backward "
          f"{bwd_r}; plain step launches {fwd_p}, {bwd_p}; loss kernel "
          f"{loss_k:.6f} plain {loss_p:.6f} (rel "
          f"{abs(loss_k - loss_p) / abs(loss_p):.3e})")
    expect(fwd_r == 2 * n_layers - 1 and bwd_r == n_layers - 1,
           f"remat step launches {fwd_r}, {bwd_r}")
    expect(fwd_p == bwd_p == 0, "the plain step launched a kernel")
    expect(np.isfinite(loss_k), "kernel step loss not finite")
    expect(abs(loss_k - loss_p) <= STEP_LOSS_RTOL * abs(loss_p),
           f"step loss off: {loss_k} vs {loss_p}")
    worst_cos, worst_norm = 1.0, 0.0
    for name, gk in g_k.items():
        gp = g_p[name]
        cos = torch.nn.functional.cosine_similarity(
            gk.flatten().double(), gp.flatten().double(), dim=0).item()
        norm = abs(gk.norm().item() / gp.norm().item() - 1.0)
        worst_cos, worst_norm = min(worst_cos, cos), max(worst_norm, norm)
        expect(cos >= STEP_GRAD_COS and norm <= STEP_GRAD_NORM_RTOL,
               f"gradient of {name} off: cosine {cos}, norm {norm}")
    print(f"train bf16 B=2 kernel vs plain gradients over {len(g_k)} "
          f"adapter leaves: min cosine {worst_cos:.6f}, max |norm ratio - 1| "
          f"{worst_norm:.3e}")
    check_selective_step(vit, cfg, acfg, adapter, batch2, table, bf16,
                         loss_k, g_k, loss_p, g_p)
    del g_k, g_p, batch2

    batch8 = train_batch(TRAIN_BATCH, img, gen)
    by_remat = {}
    for remat in (False, True, "selective"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loss0, _, fwd, bwd, (ad, opt, sched, step) = train_step_once(
            vit, cfg, acfg, adapter, batch8, table, policy=bf16, remat=remat)
        losses = [loss0] + [step(ad, *batch8).item() for _ in range(4)]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        what = REMAT_NAMES[remat]
        print(f"train bf16 B={TRAIN_BATCH} remat {what}: launches forward "
              f"{fwd}, backward {bwd} per step; losses over 5 steps "
              + ", ".join(f"{l:.6f}" for l in losses)
              + f"; peak device memory {peak:.2f} GiB on {card}")
        want_fwd = S2_FWD_PER_STEP_REMAT if remat is True else n_layers
        expect(fwd == want_fwd and bwd == n_layers - 1,
               f"step launches {fwd}, {bwd} under remat {what}")
        expect(all(np.isfinite(losses)), "a training loss is not finite")
        ms_step = cuda_ms(lambda: step(ad, *batch8), 5, warmup=1)
        print(f"time train step bf16 B={TRAIN_BATCH} ViT-L/518 remat "
              f"{what}: {ms_step:.2f} ms/step, "
              f"{TRAIN_BATCH / ms_step * 1e3:.2f} images/s, peak "
              f"{peak:.2f} GiB on {card}")
        by_remat[what] = (fwd, bwd)
        del ad, opt, sched, step
    del batch8
    gc.collect()
    torch.cuda.empty_cache()

    tiny = get_config("tiny-test")
    tacfg = tiny_acfg()
    runs = []
    for dev in ("cuda", "cpu"):
        tvit = init_vision_params(tiny, seed=0, device="cpu").to(dev)
        tad = init_image_adapter(tiny, tacfg, seed=1, device="cpu").to(dev)
        rng = np.random.default_rng(6)
        batch = (torch.from_numpy(rng.standard_normal((4, 3, 70, 70))
                                  .astype(np.float32)),
                 torch.from_numpy((rng.random((4, 70, 70)) > 0.8)
                                  .astype(np.float32)),
                 torch.tensor([0, 1, 0, 1]), torch.tensor([0, 1, 1, 0]),
                 torch.tensor([1.0, 1.0, 1.0, 0.0]))
        ttable = unit_table(tiny.embed_dim, torch.Generator().manual_seed(7),
                            device="cpu")
        loss, grads, *_ = train_step_once(
            tvit, tiny, tacfg, tad, batch, ttable,
            policy=DtypePolicy.fp32(), remat=False, device=dev)
        runs.append((loss, {n: g.cpu() for n, g in grads.items()}))
    (loss_c, g_c), (loss_h, g_h) = runs
    expect(abs(loss_c - loss_h) <= TINY_STEP_LOSS_RTOL * abs(loss_h),
           f"tiny step loss card {loss_c} vs CPU {loss_h}")
    for name, gc in g_c.items():
        err = (gc - g_h[name]).abs().max().item()
        expect(err <= TINY_STEP_GRAD_REL * g_h[name].abs().max().item(),
               f"tiny step gradient {name} off by {err}")
    print(f"train tiny-test fp32: card (kernels, hd 16) matches the CPU "
          f"(loss {loss_c:.6f} vs {loss_h:.6f})")
    return by_remat


def time_bwd(cfg, card):
    """Phase 6c: the backward kernel, its plain version and SDPA's
    backward at the training step's attention shape."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_bwd_plain)

    B, S, H, hd = TRAIN_BATCH, cfg.vision.seq_len, cfg.vision.heads, \
        cfg.vision.head_dim
    gen = torch.Generator(device="cuda").manual_seed(8)
    qkv = random_qkv(B, S, H, hd, torch.bfloat16, gen)
    d_out = torch.randn(B, S, H * hd, generator=gen,
                        device="cuda").to(torch.bfloat16)
    _, lse = attention_packed(qkv, H, S, return_lse=True)
    bwd = functools.partial(attention_packed_bwd, qkv, d_out, lse, H, S)
    ms_kernel = cuda_ms(bwd, 10)
    per_call = kernels_per_call(
        bwd, "attention_packed_bwd",
        {"attn_bwd_dq_wgmma": 1, "attn_bwd_dkdv_wgmma": 1},
        "attention_packed_bwd")
    ms_plain = cuda_ms(lambda: attention_packed_bwd_plain(qkv, d_out, H, S),
                       3)
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(B, S, 3, H, hd).permute(2, 0, 3, 1, 4).unbind(0))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    g = d_out.view(B, S, H, hd).transpose(1, 2)
    ms_sdpa = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g,
                                                  retain_graph=True), 10)
    # the TPU kernel's five S^2*hd products; each input read once, each
    # output written once
    flops = 10 * B * H * S * S * hd
    own_flops = 18 * B * H * S * S * hd  # the kernel pair's nine products
    nbytes = (2 * qkv.numel() + d_out.numel()) * qkv.element_size() + \
        lse.numel() * 4
    bound_ms, bound_by = bound(flops, nbytes)
    for name, ms in (("kernel", ms_kernel), ("plain", ms_plain),
                     ("sdpa backward", ms_sdpa)):
        own = (f", {own_flops / ms / 1e9:.1f} TFLOP/s of its own nine "
               f"products" if name == "kernel" else "")
        print(f"time attention backward {name} [{B},{S},{3 * H * hd}] bf16: "
              f"{ms:.4f} ms/call ({flops / ms / 1e9:.1f} TFLOP/s of the "
              f"TPU kernel's five products{own}; bound {bound_ms:.4f} ms by "
              f"{bound_by}) on {card}")
    return per_call, ms_kernel, ms_plain, ms_sdpa, bound_ms, bound_by


def stage1_batch(B, img, gen):
    """The JAX package's stage-1 bench batch made on the card: normal
    images, mask > 0.9, classes among VisA's 12, all valid."""
    import torch

    images = torch.randn(B, 3, img, img, generator=gen, device="cuda")
    mask = (torch.rand(B, img, img, generator=gen, device="cuda")
            > 0.9).float()
    cidx = torch.randint(0, 12, (B,), generator=gen, device="cuda")
    return images, mask, cidx, torch.ones(B, device="cuda")


def counts():
    """(standard forward, V-V, backward) launch counts."""
    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_vv)

    return (attention_packed.launches, attention_packed_vv.launches,
            attention_packed_bwd.launches)


def counts_3pass():
    """(standard forward, V-V, backward) launches of the 3-pass mode."""
    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_vv)

    return (attention_packed.launches_3pass,
            attention_packed_vv.launches_3pass,
            attention_packed_bwd.launches_3pass)


def counts_6pass():
    """(standard forward, V-V, backward) launches of the 6-pass route."""
    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_vv)

    return (attention_packed.launches_6pass,
            attention_packed_vv.launches_6pass,
            attention_packed_bwd.launches_6pass)


def zero_counts() -> None:
    from aaclip_tpu_torch.ops.attention import (attention_kernel,
                                                attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_vv, split2,
                                                split3)

    for wrapper in (attention_packed, attention_packed_vv,
                    attention_packed_bwd, attention_kernel):
        wrapper.launches = wrapper.launches_3pass = 0
        wrapper.launches_6pass = 0
    split3.launches = split2.launches = 0


# {path: ((standard, V-V, backward) 6-pass launches, split3 launches)} of
# every fp32 ViT-L path expect_6pass held, for the kernel line
SIX_PASS_CALLS = {}


def expect_6pass(counted: tuple, what: str) -> None:
    """Every launch of ``counted`` ((standard, V-V, backward) launches as
    ``counts()``, since the last ``zero_counts``) went through the 6-pass
    route, each after its ``split3`` launches (one per forward, two per
    backward), and none through B4's: an fp32 ViT-L path at head dim 64.
    Records the path in SIX_PASS_CALLS."""
    from aaclip_tpu_torch.ops.attention import attention_kernel, split3

    six, splits = counts_6pass(), split3.launches
    want_splits = counted[0] + counted[1] + 2 * counted[2]
    print(f"{what}: 6-pass launches {six} of {counted}, split3 {splits}")
    expect(six == counted and splits == want_splits
           and attention_kernel.launches == 0,
           f"{what}: 6-pass launches {six} of {counted}, split3 {splits} "
           f"not {want_splits}, B4 {attention_kernel.launches}")
    SIX_PASS_CALLS[what] = (six, splits)


def step_vs_plain(loss_k: float, g_k: dict, loss_p: float, g_p: dict,
                  what: str) -> tuple:
    """A kernel step's loss and adapter gradients against the plain
    step's, at phase 5's bars (loss within STEP_LOSS_RTOL, every leaf's
    cosine and norm within STEP_GRAD_*); returns (relative loss distance,
    least cosine, largest |norm ratio - 1|)."""
    import numpy as np
    import torch

    cos = min(torch.nn.functional.cosine_similarity(
        g.flatten().double(), g_p[n].flatten().double(), dim=0).item()
        for n, g in g_k.items())
    norm = max(abs(g.norm().item() / g_p[n].norm().item() - 1.0)
               for n, g in g_k.items())
    rel = abs(loss_k - loss_p) / abs(loss_p)
    expect(np.isfinite(loss_k) and rel <= STEP_LOSS_RTOL
           and cos >= STEP_GRAD_COS and norm <= STEP_GRAD_NORM_RTOL,
           f"{what} off: loss {rel}, cosine {cos}, norm {norm}")
    return rel, cos, norm


def check_step_vs_plain(vit, cfg, acfg, adapter, batch, table, policy,
                        what: str, check_counts) -> tuple:
    """Phase 5's comparison under ``policy``: one stage-2 step with remat,
    the kernels against the plain attention from the same adapter (loss
    within STEP_LOSS_RTOL, every adapter gradient's cosine and norm within
    STEP_GRAD_*). ``check_counts(counts())`` runs right after the kernel
    step; returns those (standard, V-V, backward) launches."""
    zero_counts()
    loss_k, g_k, _, _, _ = train_step_once(
        vit, cfg, acfg, adapter, batch, table, policy=policy, remat=True)
    launched = counts()
    check_counts(launched)
    loss_p, g_p, fwd_p, bwd_p, _ = train_step_once(
        vit, cfg, acfg, adapter, batch, table, policy=policy, remat=True,
        attn_fn=make_attn_fn_plain(cfg.vision.heads, policy,
                                   differentiable=True))
    expect(fwd_p == bwd_p == 0, f"{what}: the plain step launched a kernel")
    rel, worst_cos, worst_norm = step_vs_plain(loss_k, g_k, loss_p, g_p,
                                               what)
    print(f"{what}: launches {launched}; plain step {fwd_p}, {bwd_p}; loss "
          f"{loss_k:.6f} vs plain {loss_p:.6f} ({rel:.3e} relative); "
          f"gradients over {len(g_k)} leaves: min cosine {worst_cos:.8f}, "
          f"max |norm ratio - 1| {worst_norm:.3e}")
    return launched


def check_features_vs_plain(vit, cfg, policy, x, what: str,
                            check_counts) -> tuple:
    """Phase 7's comparison under ``policy``: spatial stage-1 features
    with the kernels against the same with both attentions plain (max |d|
    within S1_FEAT_MAX_ABS, every token's cosine within S1_FEAT_COS).
    ``check_counts(counts())`` runs right after the kernel call; returns
    those (standard, V-V, backward) launches."""
    import torch

    from aaclip_tpu_torch.train.steps import stage1_features_fn

    heads = cfg.vision.heads
    zero_counts()
    feats_k = stage1_features_fn(vit, cfg, policy=policy,
                                 vv_mode="spatial")(x)
    torch.cuda.synchronize()
    launched = counts()
    check_counts(launched)
    zero_counts()
    feats_p = stage1_features_fn(
        vit, cfg, policy=policy, vv_mode="spatial",
        attn_fn=make_attn_fn_plain(heads, policy),
        vv_attn_fn=make_attn_fn_plain(heads, policy, vv=True))(x)
    torch.cuda.synchronize()
    plain = counts()
    dmax = (feats_k - feats_p).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        feats_k.double(), feats_p.double(), dim=-1).min().item()
    print(f"{what}: launches {launched} (plain {plain}); kernel vs plain "
          f"max|d| {dmax:.3e}, least per-token cosine {cos:.8f}")
    expect(plain == (0, 0, 0), f"{what}: the plain features launched")
    expect(dmax <= S1_FEAT_MAX_ABS and cos >= S1_FEAT_COS,
           f"{what} off: {dmax}, {cos}")
    return launched


def phase_fp32_paths(vit, adapter, cfg, acfg) -> None:
    """Phase 5b: the fp32 ViT-L paths that run the 6-pass backward and V-V
    launches, end to end: the stage-2 step at batch 2 with remat against
    the plain-attention step (phase 5's bars; 47 forward and 23 backward
    launches, all 6-pass) and spatial stage-1 features at batch 2 against
    both attentions plain (phase 7's bars; 24 standard and 19 V-V, all
    6-pass)."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy

    n_layers, img = cfg.vision.layers, cfg.vision.image_size
    fp32 = DtypePolicy.fp32()
    gen = torch.Generator(device="cuda").manual_seed(23)
    table = unit_table(cfg.embed_dim, gen)
    what = "train fp32 B=2 remat"
    launched = check_step_vs_plain(
        vit, cfg, acfg, adapter, train_batch(2, img, gen), table, fp32, what,
        lambda c: expect_6pass(c, what))
    expect(launched == (S2_FWD_PER_STEP_REMAT, 0, n_layers - 1),
           f"{what}: launches {launched}")
    what = "stage-1 spatial features fp32 B=2"
    launched = check_features_vs_plain(
        vit, cfg, fp32, stage1_batch(2, img, gen)[0], what,
        lambda c: expect_6pass(c, what))
    expect(launched == (n_layers, STAGE1_SURGERY_UNTIL - 1, 0),
           f"{what}: launches {launched}")


def stage1_step_once(text, cfg, acfg, adapter, tokens, feats, batch, *,
                     policy, device="cuda"):
    """One stage-1 step from a copy of ``adapter``; returns (loss, {name:
    grad}, (the copy, its step))."""
    import torch

    from aaclip_tpu_torch.train.optim import make_text_optimizer
    from aaclip_tpu_torch.train.steps import make_stage1_step

    ad = copy.deepcopy(adapter)
    step = make_stage1_step(text, cfg, acfg,
                            make_text_optimizer(ad.parameters()), tokens,
                            policy=policy, device=device)
    _, mask, cidx, valid = batch
    loss = step(ad, feats, mask, cidx, valid)
    if loss.is_cuda:
        torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in ad.named_parameters()}
    return loss.item(), grads, (ad, step)


def phase_stage1(vit, cfg, card):
    """Phase 7: the stage-1 path and its timings; returns (V-V launches
    per spatial features call, V-V kernel ms, plain ms, SDPA ms, bound ms,
    bound_by)."""
    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (init_text_adapter,
                                              init_text_params,
                                              init_vision_params)
    from aaclip_tpu_torch.ops.attention import (attention_packed_plain,
                                                attention_packed_vv,
                                                attention_packed_vv_plain,
                                                make_attn_fn)
    from aaclip_tpu_torch.text.anchors import dataset_prompt_tokens
    from aaclip_tpu_torch.train.steps import stage1_features_fn

    heads, img, n_layers = cfg.vision.heads, cfg.vision.image_size, \
        cfg.vision.layers
    vv_start = n_layers - (STAGE1_SURGERY_UNTIL - 1)
    bf16 = DtypePolicy.bf16()
    acfg = AdapterConfig()
    text = init_text_params(cfg, seed=3)
    adapter = init_text_adapter(cfg, acfg, seed=4)
    tokens = dataset_prompt_tokens("VisA")                  # [12, 16, 77]
    gen = torch.Generator(device="cuda").manual_seed(10)

    # (a) spatial features, kernels vs plain, batch 2
    feats_k_fn = stage1_features_fn(vit, cfg, policy=bf16, vv_mode="spatial")
    feats_p_fn = stage1_features_fn(
        vit, cfg, policy=bf16, vv_mode="spatial",
        attn_fn=make_attn_fn(heads, bf16, attention=attention_packed_plain),
        vv_attn_fn=make_attn_fn(heads, bf16, vv=True,
                                attention=attention_packed_vv_plain))
    batch2 = stage1_batch(2, img, gen)
    zero_counts()
    feats_k = feats_k_fn(batch2[0])
    torch.cuda.synchronize()
    main_std, main_vv, main_bwd = counts()
    zero_counts()
    feats_p = feats_p_fn(batch2[0])
    torch.cuda.synchronize()
    plain_counts = counts()
    n_patches = cfg.vision.num_patches
    expect(feats_k.shape == (2, n_patches, cfg.embed_dim)
           and feats_k.dtype == torch.float32, f"features {feats_k.shape}")
    expect(bool(torch.isfinite(feats_k).all()), "features not finite")
    expect((main_std, main_vv, main_bwd)
           == (vv_start + (n_layers - vv_start), n_layers - vv_start, 0),
           f"spatial features launches {main_std}, {main_vv}, {main_bwd}")
    expect(plain_counts == (0, 0, 0), f"plain features launched "
           f"{plain_counts}")
    dmax = (feats_k - feats_p).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(feats_k.double(),
                                                feats_p.double(), dim=-1)
    print(f"stage-1 spatial features bf16 B=2: launches {main_std} standard"
          f" + {main_vv} V-V per call (plain: {plain_counts}); kernel vs "
          f"plain max|d| {dmax:.3e}, least per-token cosine "
          f"{cos.min().item():.8f}, mean {cos.mean().item():.8f}")
    expect(dmax <= S1_FEAT_MAX_ABS and cos.min().item() >= S1_FEAT_COS,
           f"spatial features off: max {dmax}, cosine {cos.min().item()}")

    # (d) one step from kernel features vs one from plain features
    loss_k, g_k, _ = stage1_step_once(text, cfg, acfg, adapter, tokens,
                                      feats_k, batch2, policy=bf16)
    loss_p, g_p, _ = stage1_step_once(text, cfg, acfg, adapter, tokens,
                                      feats_p, batch2, policy=bf16)
    print(f"stage-1 step bf16 B=2 from kernel vs plain features: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel "
          f"{abs(loss_k - loss_p) / abs(loss_p):.3e})")
    expect(np.isfinite(loss_k), "stage-1 loss not finite")
    expect(abs(loss_k - loss_p) <= S1_STEP_LOSS_RTOL * abs(loss_p),
           f"stage-1 step loss off: {loss_k} vs {loss_p}")
    for name, gk in g_k.items():
        gp = g_p[name]
        c = torch.nn.functional.cosine_similarity(
            gk.flatten().double(), gp.flatten().double(), dim=0).item()
        norm = abs(gk.norm().item() / gp.norm().item() - 1.0)
        print(f"  gradient {name}: cosine {c:.8f}, |norm ratio - 1| "
              f"{norm:.3e}")
        expect(c >= S1_STEP_GRAD_COS and norm <= S1_STEP_GRAD_NORM_RTOL,
               f"stage-1 gradient of {name} off: cosine {c}, norm {norm}")
    del feats_k, feats_p, feats_p_fn, g_k, g_p

    # (b) batch-mode features at batch 16
    feats_b_fn = stage1_features_fn(vit, cfg, policy=bf16)
    batch16 = stage1_batch(STAGE1_BATCH, img, gen)
    zero_counts()
    feats_b = feats_b_fn(batch16[0], batch16[3])
    torch.cuda.synchronize()
    b_counts = counts()
    print(f"stage-1 batch-mode features bf16 B={STAGE1_BATCH}: launches "
          f"{b_counts[0]} standard + {b_counts[1]} V-V per call; finite "
          f"{bool(torch.isfinite(feats_b).all())}")
    expect(b_counts == (n_layers, 0, 0), f"batch-mode launches {b_counts}")
    expect(bool(torch.isfinite(feats_b).all()), "batch features not finite")
    del feats_b

    # (c) five iterations at batch 16 from spatial features
    torch.cuda.reset_peak_memory_stats()
    loss0, _, (ad, step) = stage1_step_once(
        text, cfg, acfg, adapter, tokens, feats_k_fn(batch16[0]), batch16,
        policy=bf16)
    losses = [loss0] + [step(ad, feats_k_fn(batch16[0]), *batch16[1:]).item()
                        for _ in range(4)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"stage-1 bf16 B={STAGE1_BATCH} spatial: losses over 5 iterations "
          + ", ".join(f"{l:.6f}" for l in losses)
          + f"; peak device memory {peak:.2f} GiB")
    expect(all(np.isfinite(losses)), "a stage-1 loss is not finite")

    # (e) tiny-test fp32, card vs CPU
    tiny = get_config("tiny-test")
    tacfg = AdapterConfig(levels=(1, 2), image_adapt_until=1,
                          text_adapt_until=1)
    fp32 = DtypePolicy.fp32()
    runs = []
    for dev in ("cuda", "cpu"):
        tvit = init_vision_params(tiny, seed=0, device="cpu").to(dev)
        ttext = init_text_params(tiny, seed=0, device="cpu").to(dev)
        tad = init_text_adapter(tiny, tacfg, seed=1, device="cpu").to(dev)
        rng = np.random.default_rng(11)
        x = torch.from_numpy(rng.standard_normal((4, 3, 70, 70))
                             .astype(np.float32)).to(dev)
        tb = (x, torch.from_numpy((rng.random((4, 70, 70)) > 0.8)
                                  .astype(np.float32)).to(dev),
              torch.tensor([0, 1, 1, 0], device=dev),
              torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev))
        f = stage1_features_fn(tvit, tiny, surgery_until_layer=2,
                               policy=fp32, vv_mode="spatial",
                               device=dev)(x)
        loss, grads, _ = stage1_step_once(
            ttext, tiny, tacfg, tad, dataset_prompt_tokens(
                "MVTec", ["bottle", "cable"]), f, tb, policy=fp32,
            device=dev)
        runs.append((f.cpu(), loss, {n: g.cpu() for n, g in grads.items()}))
    (f_c, loss_c, g_c), (f_h, loss_h, g_h) = runs
    torch.testing.assert_close(f_c, f_h, atol=TINY_ATOL, rtol=TINY_RTOL)
    expect(abs(loss_c - loss_h) <= TINY_STEP_LOSS_RTOL * abs(loss_h),
           f"tiny stage-1 loss card {loss_c} vs CPU {loss_h}")
    for name, gc in g_c.items():
        err = (gc - g_h[name]).abs().max().item()
        expect(err <= TINY_STEP_GRAD_REL * g_h[name].abs().max().item(),
               f"tiny stage-1 gradient {name} off by {err}")
    print(f"stage-1 tiny-test fp32: card (kernels, hd 16) matches the CPU "
          f"(features, loss {loss_c:.6f} vs {loss_h:.6f}, gradients)")

    # timings: the V-V kernel at the bench's shape
    B, S, hd = STAGE1_BATCH, cfg.vision.seq_len, cfg.vision.head_dim
    v = torch.randn(B, S, heads * hd, generator=gen,
                    device="cuda").to(torch.bfloat16)
    vv = functools.partial(attention_packed_vv, v, heads, S)
    ms_kernel = cuda_ms(vv, 20)
    per_call = kernels_per_call(vv, "attention_packed", {"attn_fwd_wgmma": 1},
                                "attention_packed_vv")
    ms_plain = cuda_ms(lambda: attention_packed_vv_plain(v, heads, S), 3)
    q = v.view(B, S, heads, hd).transpose(1, 2)
    ms_sdpa = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, q, q), 20)
    flops = 4 * B * heads * S * S * hd
    bound_ms, bound_by = bound(flops, 2 * v.numel() * v.element_size())
    for name, ms in (("kernel", ms_kernel), ("plain", ms_plain),
                     ("sdpa", ms_sdpa)):
        print(f"time V-V attention {name} [{B},{S},{heads * hd}] bf16: "
              f"{ms:.4f} ms/launch ({flops / ms / 1e9:.1f} TFLOP/s; bound "
              f"{bound_ms:.4f} ms by {bound_by}) on {card}")
    del v, q

    # timings: whole stage-1 iterations at batch 16
    for mode, fn in (("spatial", feats_k_fn), ("batch", feats_b_fn)):
        def iteration():
            return step(ad, fn(batch16[0], batch16[3]), *batch16[1:])

        ms = cuda_ms(iteration, 3, warmup=1)
        print(f"time stage-1 iteration bf16 B={STAGE1_BATCH} ViT-L/518 "
              f"(features + step, vv {mode}): {ms:.2f} ms, "
              f"{STAGE1_BATCH / ms * 1e3:.2f} images/s on {card}")
    return main_vv, per_call, ms_kernel, ms_plain, ms_sdpa, bound_ms, bound_by


def fused_inputs(B, S, D, F, dtype, gen):
    """x [B, S, D] ~ N(0, 1), LayerNorm affine near (1, 0), w [F, D] at
    CLIP's fc scale, biases ~ 0.02, on the card in ``dtype`` (the vectors
    too, as the predictor casts a block's leaves)."""
    import torch

    def n(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * s).to(
            dtype)

    return dict(x=n(B, S, D), g=(1 + torch.randn(D, generator=gen,
                                                 device="cuda") * 0.1
                                 ).to(dtype),
                b=n(D, s=0.1), w=n(F, D, s=D ** -0.5), bias=n(F, s=0.02),
                w2=n(D, F, s=F ** -0.5), bias2=n(D, s=0.02))


def fused_err(got, want, dtype_name: str, what: str) -> float:
    """Max |got - want| after checking it against the phase-8 bars."""
    import torch

    expect(got.shape == want.shape and got.dtype == want.dtype,
           f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
           f"{tuple(want.shape)}")
    expect(bool(torch.isfinite(got).all()), f"{what}: not finite")
    g, w = got.float(), want.float()
    d = (g - w).abs()
    mx, mean = d.max().item(), d.mean().item()
    top = w.abs().max().item()
    if dtype_name == "bf16":
        over = (d - FUSED_BF16_REL * w.abs()).max().item()
        ok = (over <= FUSED_BF16_OF_MAX * top
              and mean <= FUSED_BF16_MEAN * w.abs().mean().item())
    else:
        ok = mx <= FUSED_FP32_OF_MAX * top
    print(f"  {what}: max|d|={mx:.3e} mean|d|={mean:.3e} (max|plain| "
          f"{top:.3f})")
    expect(ok, f"{what} off: max {mx}, mean {mean}, max|plain| {top}")
    return mx


# (B, S, D, hidden F): the predict's batch-32 rows, ragged rows, the bf16
# GEMM's 128-row tile edges (one tile, one row over, one short of two),
# ViT-B-16's width at 224 px, and width 128 (N 384 and 128 take the
# 128-column tile)
FUSED_CASES = [(32, 1370, 1024, 4096), (3, 37, 1024, 4096),
               (1, 128, 1024, 4096), (1, 129, 1024, 4096),
               (1, 255, 1024, 4096), (2, 197, 768, 3072), (2, 21, 128, 512)]
# the NaN-row check: x [B, S, D], hidden F, and the poisoned row
NAN_ROW_CASE = (3, 200, 1024, 4096, 300)


def twice(fn, what: str):
    """``fn()`` run twice; the two outputs must be equal bit for bit."""
    import torch

    first, second = fn(), fn()
    expect(torch.equal(first, second), f"{what}: two runs differ")
    return first


def fused_calls(FB, t, y, policy, acts, plain=False):
    """{name: call} of B5 (to 3D columns, the QKV projection, and to D, the
    V-V value third), B6 and B7 under each activation of ``acts``, on the
    inputs of ``fused_inputs`` and the out-projection input y: FB's
    wrappers, or with ``plain`` their plain versions."""
    def op(name):
        return getattr(FB, f"{name}_plain" if plain else name)

    x, g, b = t["x"], t["g"], t["b"]
    D = x.shape[-1]
    wo, bo = t["w"][:D].contiguous(), t["bias"][:D].contiguous()
    calls = {f"ln_linear F={n}": (lambda n=n: op("ln_linear")(
        x, g, b, t["w"][:n], t["bias"][:n], policy)) for n in (3 * D, D)}
    calls["linear_residual"] = lambda: op("linear_residual")(x, y, wo, bo,
                                                             policy)
    for act in acts:
        calls[f"mlp_fused {act.__name__}"] = lambda act=act: op("mlp_fused")(
            x, g, b, t["w"], t["bias"], t["w2"], t["bias2"], act, policy)
    return calls


def check_fused_kernels(dtype_name: str) -> dict:
    """B5-B7 against their plain versions on the card, each kernel run
    twice bit for bit; fp32 calls (the 6-pass mode) counted, 3 / 2 / 4
    kernels each, and held within SIX_FP64_MAX_REL and
    SIX_FUSED_FP64_MAX_REL of fp64. Returns the
    largest max |d| of each at the batch-32 shape, and under fp32 also
    ``{"fp64": {name: the largest distance from fp64}}``."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.kernels.build import kernels_launched
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.ops import fused_block as FB

    dtype = torch_dtype(dtype_name)
    policy = DtypePolicy(dtype, dtype_name == "bf16")
    six = dtype_name == "fp32"
    gen = torch.Generator(device="cuda").manual_seed(20)
    worst = {"ln_linear": 0.0, "linear_residual": 0.0, "mlp_fused": 0.0}
    fp64 = {}
    acts = (L.gelu, L.gelu_tanh, L.quick_gelu)
    for B, S, D, F in FUSED_CASES:
        t = fused_inputs(B, S, D, F, dtype, gen)
        y = torch.randn(B, S, D, generator=gen, device="cuda").to(dtype)
        print(f"fused kernels {dtype_name}{' (6-pass)' if six else ''} x "
              f"[{B},{S},{D}], hidden {F}:")
        plain = fused_calls(FB, t, y, policy, acts, plain=True)
        errs = {}
        for name, fn in fused_calls(FB, t, y, policy, acts).items():
            key = name.split()[0]
            wrapper = getattr(FB, key)
            before = (wrapper.launches_6pass, kernels_launched("fused_block"))
            got = twice(fn, name)
            torch.cuda.synchronize()
            if six:
                n6 = wrapper.launches_6pass - before[0]
                nk = kernels_launched("fused_block") - before[1]
                expect(n6 == 2 and nk == 2 * SPLIT_KERNELS[key],
                       f"{name}: {n6} 6-pass calls, {nk} kernels in two "
                       f"calls")
            want = plain[name]()
            errs[name] = fused_err(got, want, dtype_name, name)
            if six:
                act = next((a for a in acts
                            if name.split()[-1] == a.__name__), None)
                exact = fused_fp64(name, t, y, act)
                top = exact.abs().max().item()
                rel = (got.double() - exact).abs().max().item() / top
                rel_plain = (want.double() - exact).abs().max().item() / top
                print(f"    from fp64: kernel {rel:.3e}, plain version "
                      f"{rel_plain:.3e} of the output's max")
                expect(rel <= min(SIX_FP64_MAX_REL, SIX_FUSED_FP64_MAX_REL),
                       f"{name} (6-pass) off fp64: {rel}")
                fp64[key] = max(fp64.get(key, 0.0), rel)
                del exact
            del got, want
        torch.cuda.synchronize()
        if B == 32:
            for name in worst:
                worst[name] = max(v for k, v in errs.items()
                                  if k.startswith(name))
        del t, y, plain
        torch.cuda.empty_cache()
    return {**worst, "fp64": fp64} if six else worst


def check_fused_nan_row(dtype_name: str) -> None:
    """One row of x (and of the out-projection's input) NaN: every other
    row of each B5-B7 output is bit for bit the output with that row 0."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.ops import fused_block as FB

    B, S, D, F, row = NAN_ROW_CASE
    dtype = torch_dtype(dtype_name)
    policy = DtypePolicy(dtype, dtype_name == "bf16")
    gen = torch.Generator(device="cuda").manual_seed(26)
    t = fused_inputs(B, S, D, F, dtype, gen)
    y = torch.randn(B, S, D, generator=gen, device="cuda").to(dtype)
    outs = []
    for fill in (float("nan"), 0.0):
        t["x"].view(-1, D)[row] = fill
        y.view(-1, D)[row] = fill
        calls = fused_calls(FB, t, y, policy, (L.gelu_tanh,))
        outs.append({k: fn().view(B * S, -1) for k, fn in calls.items()})
    torch.cuda.synchronize()
    keep = torch.arange(B * S, device="cuda") != row
    for name, poisoned in outs[0].items():
        clean = outs[1][name]
        expect(bool(torch.isnan(poisoned[row]).all()),
               f"{name}: the NaN row did not come out NaN")
        expect(torch.equal(poisoned[keep], clean[keep]),
               f"{name}: the NaN row moved other rows")
    print(f"fused kernels {dtype_name}, row {row} of x [{B},{S},{D}] NaN: "
          f"every other row of {', '.join(outs[0])} equals the output with "
          f"the row 0, bit for bit")


# B4: (B, H, S, head dim, valid_len)
BHSD_CASES = [(32, 16, 1370, 64, 1370), (2, 16, 257, 64, 200),
              (3, 4, 26, 16, 26), (2, 2, 77, 16, 50),
              # the wgmma kernel's tile edges
              (2, 16, 128, 64, 128), (2, 16, 129, 64, 129),
              (2, 16, 256, 64, 256), (2, 16, 200, 64, 128),
              (3, 16, 200, 64, 200)]


def check_attention_kernel(dtype_name: str) -> float:
    """B4 against its plain version and bit for bit against
    ``attention_packed`` on the same values packed [B, S, 3D]; returns the
    max |d| at the batch-32 shape."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_kernel,
                                                attention_kernel_plain,
                                                attention_packed)

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(21)
    worst = 0.0
    for B, H, S, hd, valid in BHSD_CASES:
        q, k, v = (torch.randn(B, H, S, hd, generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        before = attention_kernel.launches_6pass
        got = attention_kernel(q, k, v, valid)
        expect_routed(attention_kernel, before, 1, dtype_name, hd,
                      "attention_kernel")
        want = attention_kernel_plain(q, k, v, valid)
        packed = torch.cat([t.transpose(1, 2).reshape(B, S, H * hd)
                            for t in (q, k, v)], dim=-1).contiguous()
        same = torch.equal(got.transpose(1, 2).reshape(B, S, H * hd),
                           attention_packed(packed, H, valid))
        torch.cuda.synchronize()
        expect(got.shape == q.shape and got.dtype == dtype,
               f"attention_kernel {got.dtype} {tuple(got.shape)}")
        d = (got.float() - want.float()).abs()
        mx, mean = d.max().item(), d.mean().item()
        finite = bool(torch.isfinite(got).all())
        del want, d, packed, q, k, v, got
        print(f"attention_kernel {dtype_name} [{B},{H},{S},{hd}] valid="
              f"{valid}: max|d|={mx:.3e} mean|d|={mean:.3e} finite={finite};"
              f" equals attention_packed on the packed values: {same}")
        expect(finite, "attention_kernel output not finite")
        expect(same, "attention_kernel differs from attention_packed")
        if dtype_name == "bf16":
            expect(mx <= BF16_MAX_ABS and mean <= BF16_MEAN_ABS,
                   f"bf16 attention_kernel off: max {mx}, mean {mean}")
        else:
            expect(mx <= FP32_MAX_ABS, f"fp32 attention_kernel off: {mx}")
        if B == 32:
            worst = max(worst, mx)
    return worst


FUSED_COUNTED = ("ln_linear", "attention_packed", "attention_packed_vv",
                 "linear_residual", "mlp_fused", "attention_kernel")


def fused_counts():
    """The launch counts of FUSED_COUNTED, in its order."""
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import (attention_kernel,
                                                attention_packed,
                                                attention_packed_vv)

    return (FB.ln_linear.launches, attention_packed.launches,
            attention_packed_vv.launches, FB.linear_residual.launches,
            FB.mlp_fused.launches, attention_kernel.launches)


def zero_fused_counts() -> None:
    from aaclip_tpu_torch.ops import fused_block as FB

    zero_counts()
    for wrapper in (FB.ln_linear, FB.linear_residual, FB.mlp_fused):
        wrapper.launches = wrapper.launches_3pass = 0
        wrapper.launches_6pass = 0


def fused_counts_3pass():
    """The 3-pass launches of ``ln_linear``, ``linear_residual``,
    ``mlp_fused``, ``attention_packed`` and ``attention_packed_vv``, and
    ``split2``'s launches."""
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_vv, split2)

    return (FB.ln_linear.launches_3pass, FB.linear_residual.launches_3pass,
            FB.mlp_fused.launches_3pass, attention_packed.launches_3pass,
            attention_packed_vv.launches_3pass, split2.launches)


def plain_block_fn(heads: int, policy, act, vv: bool = False):
    """``make_block_fn`` on the plain versions: the reference block."""
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import (attention_packed_plain,
                                                attention_packed_vv_plain)

    return FB.make_block_fn(
        heads, policy, act=act, vv=vv, ln=FB.ln_linear_plain,
        attention=attention_packed_vv_plain if vv else attention_packed_plain,
        residual=FB.linear_residual_plain, mlp=FB.mlp_fused_plain)


def phase_fused_predict(vit, adapter, cfg, acfg, anchors, M, card):
    """Phase 8c and the predict timings of 8e (and of the fp32 predicts at
    batch 8): returns ({kernel: launches per bf16 predict call}, {wrapper:
    its 6-pass launches per fp32 predict call})."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.kernels.build import kernels_launched
    from aaclip_tpu_torch.models.layers import config_act
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.fused_block import make_block_fn

    heads, img, n_layers = cfg.vision.heads, cfg.vision.image_size, \
        cfg.vision.layers
    gen = torch.Generator(device="cuda").manual_seed(22)
    for name, B in (("bf16", 8), ("fp32", TRAIN_BATCH)):
        policy = DtypePolicy.bf16() if name == "bf16" else DtypePolicy.fp32()
        act = config_act(cfg, policy)
        kw = dict(policy=policy, uint8_inputs=name == "bf16")
        fused = make_predict_fn(vit, cfg, acfg, block_fn=make_block_fn(
            heads, policy, act=act), **kw)
        plain = make_predict_fn(vit, cfg, acfg, block_fn=plain_block_fn(
            heads, policy, act), **kw)
        unfused = make_predict_fn(vit, cfg, acfg, **kw)
        if name == "bf16":
            images = torch.randint(0, 256, (B, 3, img, img), generator=gen,
                                   device="cuda", dtype=torch.uint8)
        else:
            images = torch.randn(B, 3, img, img, generator=gen,
                                 device="cuda")
        zero_fused_counts()
        k0 = kernels_launched("fused_block")
        pix_f, score_f = fused(adapter, images, anchors, M)
        torch.cuda.synchronize()
        c = fused_counts()
        if name == "fp32":
            expect_6pass((c[1], c[2], 0), f"fused predict fp32 B={B}")
            six = tuple(getattr(FB, w).launches_6pass for w in FP32_ROWS)
            nk = kernels_launched("fused_block") - k0
            print(f"fused predict fp32 B={B}: 6-pass calls {six}, {nk} "
                  f"fused_block kernels")
            expect(six == (n_layers,) * 3
                   and nk == n_layers * sum(SPLIT_KERNELS.values()),
                   f"fused predict fp32: 6-pass calls {six}, kernels {nk}")
            fp32_calls = dict(zip(FP32_ROWS, six))
        zero_fused_counts()
        pix_p, score_p = plain(adapter, images, anchors, M)
        torch.cuda.synchronize()
        c_plain = fused_counts()
        pix_u, score_u = unfused(adapter, images, anchors, M)
        expect(pix_f.shape == (B, img, img) and score_f.shape == (B,),
               f"fused predict shapes {pix_f.shape}, {score_f.shape}")
        expect(bool(torch.isfinite(pix_f).all()
                    and torch.isfinite(score_f).all()),
               "fused predict not finite")
        expect(c == (n_layers, n_layers, 0, n_layers, n_layers, 0),
               f"fused predict launches {dict(zip(FUSED_COUNTED, c))}")
        expect(c_plain == (0,) * len(FUSED_COUNTED),
               f"plain-block predict launched {c_plain}")
        span = (pix_p.max() - pix_p.min()).item()
        d = (pix_f - pix_p).abs()
        dpix, dmean = d.max().item(), d.mean().item()
        dscore = (score_f - score_p).abs().max().item()
        u = (pix_f - pix_u).abs()
        upix, umean = u.max().item(), u.mean().item()
        print(f"fused predict {name} B={B}: launches per call ln_linear "
              f"{c[0]}, attention_packed {c[1]}, linear_residual {c[3]}, "
              f"mlp_fused {c[4]}, attention_kernel {c[5]}; vs the "
              f"plain-block predict: max|d map| {dpix:.3e} ({dpix / span:.3e}"
              f" of span {span:.4f}), mean|d map| {dmean:.3e} "
              f"({dmean / span:.3e} of span), max|d score| {dscore:.3e}; vs "
              f"the unfused predict (printed, not barred): max|d map| "
              f"{upix:.3e} ({upix / span:.3e} of span), mean|d map| "
              f"{umean:.3e} ({umean / span:.3e} of span), max|d score| "
              f"{(score_f - score_u).abs().max().item():.3e}")
        del d, u
        if name == "bf16":
            expect(dpix <= PIX_SPAN_FRAC_BF16 * span,
                   f"fused map off: {dpix} of {span}")
            expect(dscore <= SCORE_ATOL_BF16, f"fused scores off: {dscore}")
            launches = dict(zip(FUSED_COUNTED, c))
            fused_bf16, unfused_bf16 = fused, unfused
        else:
            torch.testing.assert_close(pix_f, pix_p, atol=PIX_ATOL_FP32,
                                       rtol=PIX_RTOL_FP32)
            torch.testing.assert_close(score_f, score_p,
                                       atol=SCORE_ATOL_FP32, rtol=0)
            for what, fn in (("fused", fused), ("unfused", unfused)):
                ms = cuda_ms(lambda fn=fn: fn(adapter, images, anchors, M),
                             3, warmup=1)
                print(f"time predict fp32 B={B} ViT-L/518 ({what} block): "
                      f"{ms:.2f} ms/call, {B / ms * 1e3:.2f} maps/s on "
                      f"{card}")
        del fused, plain, unfused, pix_f, pix_p, pix_u, images

    u8 = torch.randint(0, 256, (32, 3, img, img), generator=gen,
                       device="cuda", dtype=torch.uint8)
    ms_f = cuda_ms(lambda: fused_bf16(adapter, u8, anchors, M), 5)
    ms_u = cuda_ms(lambda: unfused_bf16(adapter, u8, anchors, M), 5)
    for name, ms in (("fused block", ms_f), ("unfused block", ms_u)):
        print(f"time predict bf16 B=32 ViT-L/518 ({name}): {ms:.2f} ms/call,"
              f" {32 / ms * 1e3:.2f} maps/s on {card}")
    return launches, fp32_calls


def phase_encode_image(vit, cfg):
    """Phase 8d: ``encode_image`` with fused standard and V-V blocks
    against plain blocks, the launch counts, and a width-128 3-layer tower
    in fp32 on the card against the CPU."""
    import torch

    from aaclip_tpu_torch.core.config import (CLIPConfig, DtypePolicy,
                                              VisionConfig)
    from aaclip_tpu_torch.core.params import (cast_matmul_weights,
                                              init_vision_params)
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.models.vit import encode_image
    from aaclip_tpu_torch.ops import fused_block as FB

    heads, n_layers = cfg.vision.heads, cfg.vision.layers
    vv_start = L.surgery_vv_start(n_layers, STAGE1_SURGERY_UNTIL)
    bf16 = DtypePolicy.bf16()
    act = L.config_act(cfg, bf16)
    visual = cast_matmul_weights(vit, bf16)
    gen = torch.Generator(device="cuda").manual_seed(23)
    images = torch.randn(2, 3, cfg.vision.image_size, cfg.vision.image_size,
                         generator=gen, device="cuda")
    taps_at = (6, 12, 18, 24)

    widths = []

    def recording_ln_linear(x, *args):
        out = FB.ln_linear(x, *args)
        widths.append(out.shape[-1])
        return out

    fns = {vv: FB.make_block_fn(heads, bf16, act=act, vv=vv,
                                ln=recording_ln_linear)
           for vv in (False, True)}
    plain = {vv: plain_block_fn(heads, bf16, act, vv) for vv in (False, True)}
    with torch.inference_mode():
        zero_fused_counts()
        pooled_f, taps_f = encode_image(
            visual, cfg, images, taps_at, vv_start=vv_start, policy=bf16,
            block_fn=fns[False], vv_block_fn=fns[True])
        torch.cuda.synchronize()
        c = fused_counts()
        pooled_p, taps_p = encode_image(
            visual, cfg, images, taps_at, vv_start=vv_start, policy=bf16,
            block_fn=plain[False], vv_block_fn=plain[True])
    n_std = sum(w == 3 * cfg.vision.width for w in widths)
    print(f"encode_image bf16 B=2 vv_start={vv_start}: launches ln_linear "
          f"{c[0]} ({n_std} to {3 * cfg.vision.width} columns, "
          f"{len(widths) - n_std} to {cfg.vision.width}), attention "
          f"{c[1]} standard + {c[2]} V-V, linear_residual {c[3]}, "
          f"mlp_fused {c[4]}")
    expect(c == (n_layers, vv_start, n_layers - vv_start, n_layers,
                 n_layers, 0), f"encode_image launches {c}")
    expect(n_std == vv_start and len(widths) == n_layers,
           f"ln_linear widths {widths}")
    expect(pooled_f.shape == (2, cfg.embed_dim), f"pooled {pooled_f.shape}")
    for name, got, want in [("pooled", pooled_f[:, None], pooled_p[:, None])]\
            + [(f"tap {d}", t, tp) for d, t, tp in zip(taps_at, taps_f,
                                                       taps_p)]:
        expect(bool(torch.isfinite(got).all()), f"encode_image {name}")
        cos = torch.nn.functional.cosine_similarity(
            got.double(), want.double(), dim=-1).min().item()
        d = (got.float() - want.float()).abs().max().item()
        print(f"  encode_image {name}: fused vs plain blocks max|d| "
              f"{d:.3e}, least cosine {cos:.8f}")
        expect(cos >= ENC_COS, f"encode_image {name} off: cosine {cos}")
    del pooled_f, taps_f, pooled_p, taps_p, visual

    # width 128, 2 heads x 64, 3 layers, fp32: card (kernels) vs CPU
    small = CLIPConfig(embed_dim=64, vision=VisionConfig(
        image_size=28, patch_size=14, width=128, layers=3, heads=2))
    fp32 = DtypePolicy.fp32()
    outs = []
    for dev in ("cuda", "cpu"):
        sv = init_vision_params(small, seed=4, device="cpu")
        cpu_gen = torch.Generator().manual_seed(24)
        with torch.no_grad():
            for p in sv.parameters():  # no parameter the trivial 0 or 1
                p.add_(torch.randn(p.shape, generator=cpu_gen) * 0.05)
        sv = sv.to(dev)
        x = torch.randn(2, 3, 28, 28, generator=cpu_gen).to(dev)
        fns = {vv: FB.make_block_fn(2, fp32, act=L.gelu, vv=vv)
               for vv in (False, True)}
        with torch.inference_mode():
            pooled, taps = encode_image(sv, small, x, (2, 3), vv_start=2,
                                        policy=fp32, block_fn=fns[False],
                                        vv_block_fn=fns[True])
        outs.append([t.cpu() for t in (pooled, *taps)])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=TINY_ATOL, rtol=TINY_RTOL)
    print("encode_image width 128 fp32 (fused blocks, standard and V-V): "
          "card (kernels) matches the CPU")


def compare_tile_widths(FB, calls: dict, card) -> None:
    """Phase 8e: the bf16 wrappers at the batch-32 shapes with every GEMM
    on output tiles of fused_block.cu's own width (``rule``), then of 128
    and of 256 columns (``gemm_tile_width``): ms per call by CUDA events,
    and each GEMM's device ms per launch by the profiler, under its
    kernel's name, which carries the tile width (``gemm_wgmma<BN, LN,
    EPI>``: B5 is ln_linear's, B6 linear_residual's; fc is mlp_fused's LN
    GEMM, proj its other)."""
    for bn in (0, 128, 256):
        FB.gemm_tile_width(bn)
        try:
            for name, fn in calls.items():
                ms = cuda_ms(fn, 20)
                gemms = "; ".join(
                    f"{k[k.index('gemm_wgmma'):].split('(')[0]} "
                    f"{us / n / 1e3:.4f} ms"
                    for k, (n, us) in sorted(device_ops(fn, 10).items())
                    if "gemm_wgmma" in k)
                print(f"tile {bn or 'rule'}: {name} {ms:.4f} ms per call; "
                      f"per GEMM launch (profiler): {gemms} on {card}")
        finally:
            FB.gemm_tile_width(0)


def time_fused(cfg, card):
    """Phase 8e: each fused kernel, its plain version and the library
    yardstick at the batch-32 shapes, with the device operations of one
    call (the profiler's count, which must be the kernels' own) and the
    GEMM's tile widths against each other; returns {name: (ms, plain ms,
    library ms, bound ms, bound_by, kernels per call)}."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import (attention_kernel,
                                                attention_kernel_plain)

    bf16 = DtypePolicy.bf16()
    D, F, B, S = cfg.vision.width, int(cfg.vision.width *
                                       cfg.vision.mlp_ratio), 32, \
        cfg.vision.seq_len
    R = B * S
    gen = torch.Generator(device="cuda").manual_seed(25)
    t = fused_inputs(B, S, D, F, torch.bfloat16, gen)
    x, g, b = t["x"], t["g"], t["b"]
    wqkv = torch.randn(3 * D, D, generator=gen, device="cuda").mul(
        D ** -0.5).to(torch.bfloat16)
    bqkv = torch.randn(3 * D, generator=gen, device="cuda").mul(0.02).to(
        torch.bfloat16)
    y = torch.randn(B, S, D, generator=gen, device="cuda").to(torch.bfloat16)
    wo, bo = t["w"][:D].contiguous(), t["bias"][:D].contiguous()
    act = L.gelu_tanh
    e = 2  # bytes of a bf16 element

    def unfused_ln_linear():
        h = L.layer_norm(x, g, b)
        return L.linear(h, wqkv, bqkv, bf16).to(bf16.compute_dtype)

    def unfused_linear_residual():
        return x + L.linear(y, wo, bo, bf16).to(x.dtype)

    mlp_p = SimpleNamespace(
        c_fc=SimpleNamespace(weight=t["w"], bias=t["bias"]),
        c_proj=SimpleNamespace(weight=t["w2"], bias=t["bias2"]))

    def unfused_mlp():
        return x + L.mlp(L.layer_norm(x, g, b), mlp_p, act, bf16)

    cases = {
        "ln_linear": (
            functools.partial(FB.ln_linear, x, g, b, wqkv, bqkv, bf16),
            lambda: FB.ln_linear_plain(x, g, b, wqkv, bqkv, bf16),
            unfused_ln_linear, 2 * R * D * 3 * D,
            (R * D + 3 * D * D + 3 * D + 2 * D + R * 3 * D) * e),
        "linear_residual": (
            functools.partial(FB.linear_residual, x, y, wo, bo, bf16),
            lambda: FB.linear_residual_plain(x, y, wo, bo, bf16),
            unfused_linear_residual, 2 * R * D * D,
            (3 * R * D + D * D + D) * e),
        "mlp_fused": (
            functools.partial(FB.mlp_fused, x, g, b, t["w"], t["bias"],
                              t["w2"], t["bias2"], act, bf16),
            lambda: FB.mlp_fused_plain(x, g, b, t["w"], t["bias"], t["w2"],
                                       t["bias2"], act, bf16),
            unfused_mlp, 4 * R * D * F,
            (2 * R * D + 2 * D * F + F + 3 * D) * e),
    }
    per_call = {"ln_linear": {"row_stats_kernel": 1, "gemm_wgmma": 1},
                "linear_residual": {"gemm_wgmma": 1},
                "mlp_fused": {"row_stats_kernel": 1, "gemm_wgmma": 2}}
    out = {}
    with torch.inference_mode():
        for name, (kern, plain, lib, flops, nbytes) in cases.items():
            ms = cuda_ms(kern, 20)
            n = kernels_per_call(kern, "fused_block", per_call[name], name)
            ms_plain = cuda_ms(plain, 5)
            ms_lib = cuda_ms(lib, 20)
            bound_ms, bound_by = bound(flops, nbytes)
            out[name] = (ms, ms_plain, ms_lib, bound_ms, bound_by, n)
            print(f"time {name} [{B},{S},{D}] bf16: kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain {ms_plain:.4f}, "
                  f"unfused sequence {ms_lib:.4f}; bound {bound_ms:.4f} ms "
                  f"by {bound_by} on {card}")
        del t, x, y, wqkv
        H, hd = cfg.vision.heads, cfg.vision.head_dim
        q, k, v = (torch.randn(B, H, S, hd, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        b4 = functools.partial(attention_kernel, q, k, v, S)
        ms = cuda_ms(b4, 20)
        n = kernels_per_call(b4, "attention_packed", {"attn_fwd_wgmma": 1},
                             "attention_kernel")
        ms_plain = cuda_ms(lambda: attention_kernel_plain(q, k, v, S), 5)
        ms_lib = cuda_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(q, k, v), 20)
        flops = 4 * B * H * S * S * hd
        bound_ms, bound_by = bound(flops, 4 * q.numel() * q.element_size())
        out["attention_kernel"] = (ms, ms_plain, ms_lib, bound_ms, bound_by,
                                   n)
        print(f"time attention_kernel [{B},{H},{S},{hd}] bf16: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{ms_plain:.4f}, sdpa {ms_lib:.4f}; bound {bound_ms:.4f} ms by "
              f"{bound_by} on {card}")
        # last: it traces, and a traced process times host-bound work
        # slower (check_device_ops)
        compare_tile_widths(FB, {name: c[0] for name, c in cases.items()},
                            card)
    return out


# Phase 8f-8i, the fused block under fp32_high (fp32 operands, precision
# "high"): B5-B7's 3-pass mode (fused_block.cu's split_kernel,
# ln_split_kernel and gemm_planes_wgmma on two planes). (f) Each kernel
# against its plain version (the same split into bf16 halves, the three products as cuBLAS
# bf16 GEMMs in matmul_3pass) at FUSED_FP32_OF_MAX of the output's max:
# the two differ only in the order of the fp32 sums and in erff against
# torch's erf; twice bit for bit; against fp64 at HIGH_FP64_MAX_REL of the
# output's max, the attention 3-pass kernels' bar (the plain version's own
# distance printed beside), at the fp32 parity batch 8 (10,960 rows) on
# the QKV and the V-V value third, and at the GEMM's edges (one row over a
# 128-row tile; width 128, where N 384 and 128 take one or three tiles).
# (g) The fused fp32_high predict at batch 8 (24 calls of each wrapper,
# every one 3-pass, and 24 3-pass attention launches after their split2
# launches): staged (bf16_until 6, the policy's default, whose six prefix
# blocks the fused block also runs 3-pass, as JAX's block_fn does) against
# the predict on the plain-version blocks, and unstaged against the
# unfused unstaged predict, both at phase 11's bars (PIX_*_FP32,
# SCORE_ATOL_FP32); the staged fused predict against the unfused staged
# one is printed (the unfused runs its prefix at bf16); maps/s of all
# four. (h) Each kernel's ms, plain ms and the unfused sequence's ms
# (LayerNorm, matmul_3pass, bias / activation / residual) at batch 8
# beside its bound (three bf16 passes at 989 TFLOP/s). (i) ``bench --mode
# block --precision fp32_high --batch_size 8``.
HIGH_FUSED_CASES = [(TRAIN_BATCH, 1370, 1024, 4096), (1, 129, 1024, 4096),
                    (2, 21, 128, 512)]
# kernels per call of each wrapper on a split-plane mode, 3-pass or 6-pass
# (ln_split_kernel first: the profiler's names are matched by substring)
PLANES_PER_CALL = {"ln_linear": {"ln_split_kernel": 1, "split_kernel": 1,
                                 "gemm_planes_wgmma": 1},
                   "linear_residual": {"split_kernel": 1,
                                       "gemm_planes_wgmma": 1},
                   "mlp_fused": {"ln_split_kernel": 1, "split_kernel": 1,
                                 "gemm_planes_wgmma": 2}}
SPLIT_KERNELS = {k: sum(v.values()) for k, v in PLANES_PER_CALL.items()}
FP32_ROWS = ("ln_linear", "linear_residual", "mlp_fused")


def fused_fp64(name: str, t: dict, y, act):
    """The exact value of one of ``fused_calls``' outputs, in fp64 from
    the same fp32 inputs."""
    import torch

    x, g, b = (t[k].double() for k in ("x", "g", "b"))
    D = x.shape[-1]

    def ln(v):
        m = v.mean(-1, keepdim=True)
        var = (v - m).square().mean(-1, keepdim=True)
        return (v - m) / torch.sqrt(var + 1e-5) * g + b

    w, bias = t["w"].double(), t["bias"].double()
    if name.startswith("ln_linear F="):
        n = int(name.split("=")[1])
        return ln(x) @ w[:n].T + bias[:n]
    if name == "linear_residual":
        return x + (y.double() @ w[:D].T + bias[:D])
    h = act(ln(x) @ w.T + bias)
    return x + h @ t["w2"].double().T + t["bias2"].double()


def check_fused_kernels_3pass() -> dict:
    """Phase 8f; returns {name: max |d| against the plain version} at
    batch 8 and {name: distance from fp64} as {"err": ..., "fp64": ...}."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.kernels.build import kernels_launched
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.ops import fused_block as FB

    high = DtypePolicy.fp32_high()
    gen = torch.Generator(device="cuda").manual_seed(27)
    out = {"err": {}, "fp64": {}}
    acts = (L.gelu, L.quick_gelu, L.gelu_tanh)
    with torch.inference_mode():
        for B, S, D, F in HIGH_FUSED_CASES:
            t = fused_inputs(B, S, D, F, torch.float32, gen)
            y = torch.randn(B, S, D, generator=gen, device="cuda")
            print(f"fused kernels fp32_high (3-pass) x [{B},{S},{D}], hidden "
                  f"{F}:")
            plain = fused_calls(FB, t, y, high, acts, plain=True)
            for name, fn in fused_calls(FB, t, y, high, acts).items():
                wrapper = getattr(FB, name.split()[0])
                before = (wrapper.launches_3pass,
                          kernels_launched("fused_block"))
                got = twice(fn, name)
                torch.cuda.synchronize()
                n3 = wrapper.launches_3pass - before[0]
                nk = kernels_launched("fused_block") - before[1]
                expect(n3 == 2 and nk == 2 * SPLIT_KERNELS[name.split()[0]],
                       f"{name}: {n3} 3-pass calls, {nk} kernels in two "
                       f"calls")
                want = plain[name]()
                err = fused_err(got, want, "fp32", f"{name} (3-pass)")
                if B != TRAIN_BATCH:
                    continue
                act = next((a for a in acts
                            if name.split()[-1] == a.__name__), None)
                exact = fused_fp64(name, t, y, act)
                top = exact.abs().max().item()
                rel = (got.double() - exact).abs().max().item() / top
                rel_plain = (want.double() - exact).abs().max().item() / top
                print(f"    from fp64: kernel {rel:.3e}, plain version "
                      f"{rel_plain:.3e} of the output's max")
                expect(rel <= HIGH_FP64_MAX_REL,
                       f"{name} (3-pass) off fp64: {rel}")
                key = name.split()[0]
                out["err"][key] = max(out["err"].get(key, 0.0), err)
                out["fp64"][key] = max(out["fp64"].get(key, 0.0), rel)
                del exact, got, want
            del t, y, plain
            torch.cuda.empty_cache()
    return out


def phase_fused_predict_3pass(vit, adapter, cfg, acfg, anchors, M,
                              card) -> dict:
    """Phase 8g: returns {"calls": {predict: {wrapper: its 3-pass
    launches}}, "rates": {predict: maps/s}} of the fused fp32_high
    predicts."""
    import dataclasses
    import gc

    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.kernels.build import kernels_launched
    from aaclip_tpu_torch.models.layers import config_act
    from aaclip_tpu_torch.ops.fused_block import make_block_fn

    heads, img, n_layers = cfg.vision.heads, cfg.vision.image_size, \
        cfg.vision.layers
    gen = torch.Generator(device="cuda").manual_seed(28)
    images = torch.randn(TRAIN_BATCH, 3, img, img, generator=gen,
                         device="cuda")
    high = DtypePolicy.fp32_high()
    rates, calls = {}, {}
    for pol in (high, dataclasses.replace(high, bf16_until=0)):
        K = pol.bf16_until
        act = config_act(cfg, pol)
        fused = make_predict_fn(vit, cfg, acfg, policy=pol,
                                block_fn=make_block_fn(heads, pol, act=act))
        ref = make_predict_fn(vit, cfg, acfg, policy=pol,
                              block_fn=plain_block_fn(heads, pol, act))
        unfused = make_predict_fn(vit, cfg, acfg, policy=pol)
        zero_fused_counts()
        k0 = kernels_launched("fused_block")
        pix_f, score_f = fused(adapter, images, anchors, M)
        torch.cuda.synchronize()
        c, c3 = fused_counts(), fused_counts_3pass()
        nk = kernels_launched("fused_block") - k0
        what = f"fused predict fp32_high bf16_until {K} B={TRAIN_BATCH}"
        print(f"{what}: launches per call ln_linear {c[0]}, attention_packed"
              f" {c[1]}, linear_residual {c[3]}, mlp_fused {c[4]}; 3-pass "
              f"{c3[:4]}, split2 {c3[5]}; {nk} fused_block kernels")
        expect(c == (n_layers, n_layers, 0, n_layers, n_layers, 0)
               and c3 == (n_layers,) * 4 + (0, n_layers)
               and nk == n_layers * (3 + 2 + 4),
               f"{what}: launches {c}, 3-pass {c3}, kernels {nk}")
        expect(pix_f.shape == (TRAIN_BATCH, img, img)
               and bool(torch.isfinite(pix_f).all()
                        and torch.isfinite(score_f).all()),
               f"{what}: output {pix_f.shape} not finite")
        zero_fused_counts()
        pix_r, score_r = ref(adapter, images, anchors, M)
        pix_u, score_u = unfused(adapter, images, anchors, M)
        torch.cuda.synchronize()
        expect(fused_counts()[0] == 0, f"{what}: the plain blocks launched")
        span = (pix_u.max() - pix_u.min()).item()
        for name, pix, score in (("plain-block", pix_r, score_r),
                                 ("unfused", pix_u, score_u)):
            d = (pix_f - pix).abs().max().item()
            ds = (score_f - score).abs().max().item()
            print(f"  vs the {name} predict: max|d map| {d:.3e} "
                  f"({d / span:.3e} of span {span:.4f}), max|d score| "
                  f"{ds:.3e}")
        torch.testing.assert_close(pix_f, pix_r, atol=PIX_ATOL_FP32,
                                   rtol=PIX_RTOL_FP32)
        torch.testing.assert_close(score_f, score_r, atol=SCORE_ATOL_FP32,
                                   rtol=0)
        if not K:  # unstaged: the unfused predict runs the same products
            torch.testing.assert_close(pix_f, pix_u, atol=PIX_ATOL_FP32,
                                       rtol=PIX_RTOL_FP32)
            torch.testing.assert_close(score_f, score_u,
                                       atol=SCORE_ATOL_FP32, rtol=0)
        calls[f"fused fp32_high predict, bf16_until {K}"] = dict(
            zip(("ln_linear", "linear_residual", "mlp_fused"), c3[:3]))
        for name, fn in (("fused", fused), ("unfused", unfused)):
            rates[f"{name} fp32_high, bf16_until {K}"] = TRAIN_BATCH / \
                cuda_ms(lambda: fn(adapter, images, anchors, M), 3,
                        warmup=1) * 1e3
        del fused, ref, unfused, pix_f, pix_r, pix_u
        gc.collect()
        torch.cuda.empty_cache()
    for name, r in rates.items():
        print(f"time predict {name} B={TRAIN_BATCH} ViT-L/518: {r:.2f} "
              f"maps/s on {card}")
    return {"calls": calls, "rates": rates}


def time_fused_3pass(cfg, card) -> dict:
    """Phase 8h: {name: (ms, plain ms, library ms, bound ms, bound_by,
    kernels per call)} of each 3-pass wrapper at batch 8."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.ops import fused_block as FB

    high = DtypePolicy.fp32_high()
    D, F, B, S = cfg.vision.width, int(cfg.vision.width *
                                       cfg.vision.mlp_ratio), TRAIN_BATCH, \
        cfg.vision.seq_len
    R = B * S
    gen = torch.Generator(device="cuda").manual_seed(29)
    t = fused_inputs(B, S, D, F, torch.float32, gen)
    x, g, b = t["x"], t["g"], t["b"]
    wqkv = torch.randn(3 * D, D, generator=gen, device="cuda") * D ** -0.5
    bqkv = torch.randn(3 * D, generator=gen, device="cuda") * 0.02
    y = torch.randn(B, S, D, generator=gen, device="cuda")
    wo, bo = t["w"][:D].contiguous(), t["bias"][:D].contiguous()
    act = L.config_act(cfg, high)
    e = 4  # bytes of an fp32 element
    mlp_p = SimpleNamespace(
        c_fc=SimpleNamespace(weight=t["w"], bias=t["bias"]),
        c_proj=SimpleNamespace(weight=t["w2"], bias=t["bias2"]))
    cases = {
        "ln_linear": (
            functools.partial(FB.ln_linear, x, g, b, wqkv, bqkv, high),
            lambda: FB.ln_linear_plain(x, g, b, wqkv, bqkv, high),
            lambda: L.linear(L.layer_norm(x, g, b), wqkv, bqkv, high),
            3 * 2 * R * D * 3 * D,
            (R * D + 3 * D * D + 3 * D + 2 * D + R * 3 * D) * e),
        "linear_residual": (
            functools.partial(FB.linear_residual, x, y, wo, bo, high),
            lambda: FB.linear_residual_plain(x, y, wo, bo, high),
            lambda: x + L.linear(y, wo, bo, high),
            3 * 2 * R * D * D, (3 * R * D + D * D + D) * e),
        "mlp_fused": (
            functools.partial(FB.mlp_fused, x, g, b, t["w"], t["bias"],
                              t["w2"], t["bias2"], act, high),
            lambda: FB.mlp_fused_plain(x, g, b, t["w"], t["bias"], t["w2"],
                                       t["bias2"], act, high),
            lambda: x + L.mlp(L.layer_norm(x, g, b), mlp_p, act, high),
            3 * 4 * R * D * F, (2 * R * D + 2 * D * F + F + 3 * D) * e),
    }
    out = {}
    with torch.inference_mode():
        for name, (kern, plain, lib, flops, nbytes) in cases.items():
            ms = cuda_ms(kern, 20)
            n = kernels_per_call(kern, "fused_block", PLANES_PER_CALL[name],
                                 f"{name} (3-pass)")
            ms_plain = cuda_ms(plain, 5)
            ms_lib = cuda_ms(lib, 5)
            bound_ms, bound_by = bound(flops, nbytes)
            out[name] = (ms, ms_plain, ms_lib, bound_ms, bound_by, n)
            print(f"time {name} (3-pass) [{B},{S},{D}] fp32_high: kernel "
                  f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of bf16 "
                  f"passes), plain {ms_plain:.4f}, unfused sequence "
                  f"{ms_lib:.4f}; bound {bound_ms:.4f} ms by {bound_by} "
                  f"on {card}")
    return out


def bench_block(card, precision: str) -> dict:
    """Phases 8i and 8k: one in-process ``python -m aaclip_tpu_torch.bench
    --mode block --precision <precision> --batch_size 8`` run's JSON
    line."""
    import contextlib
    import gc
    import io

    import torch

    from aaclip_tpu_torch import bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(["--mode", "block", "--precision", precision,
                    "--batch_size", str(TRAIN_BATCH)])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"bench --mode block --precision {precision} --batch_size "
          f"{TRAIN_BATCH}: {json.dumps(line)}")
    expect(line["metric"] == "fused_block_trunk_ms" and line["value"] > 0
           and f"{precision}," in line["unit"]
           and math.isfinite(line["max_rel_dev"]),
           f"bench --mode block {precision}: {line}")
    gc.collect()
    torch.cuda.empty_cache()
    return line


# Phase 8j-8k, the fused block under fp32 (precision "highest", the parity
# policy): B5-B7's 6-pass mode (split_kernel, ln_split_kernel and
# gemm_planes_wgmma on three planes). (j) Each wrapper's ms at the fp32
# parity batch 8 and at 8e's batch 32 (ln_linear to 3072 columns, the QKV
# projection, and to 1024, the V-V value third; linear_residual;
# mlp_fused under the config's activation), beside its plain version (true
# fp32: cuBLAS SGEMMs with TF32 off, LayerNorm, bias, activation and
# residual in torch), the unfused fp32 sequence the predict runs
# (``L.layer_norm`` and ``L.linear`` under ``DtypePolicy.fp32()``), and two
# bounds: six bf16 passes at 989 TFLOP/s (the TPU's native form, the bound
# every fp32 row of PERF.md takes) and, printed beside, one fp32 pass at the
# FMA rate (67 TFLOP/s). (k) ``bench --mode block --precision fp32
# --batch_size 8``.
FP32_BLOCK_BATCHES = (TRAIN_BATCH, 32)


def time_fused_fp32(cfg, card) -> dict:
    """Phase 8j: {batch: {name: (ms, plain ms, library ms, bound ms,
    bound_by, kernels per call, FMA-rate bound ms)}}, each wrapper's
    kernels per call held to the 6-pass mode's (and queued for
    check_device_ops)."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.ops import fused_block as FB

    fp32 = DtypePolicy.fp32()
    D, F, S = cfg.vision.width, int(cfg.vision.width * cfg.vision.mlp_ratio), \
        cfg.vision.seq_len
    act = L.config_act(cfg, fp32)
    e = 4  # bytes of an fp32 element
    out = {}
    for B in FP32_BLOCK_BATCHES:
        R = B * S
        gen = torch.Generator(device="cuda").manual_seed(30 + B)
        t = fused_inputs(B, S, D, F, torch.float32, gen)
        x, g, b = t["x"], t["g"], t["b"]
        wqkv = torch.randn(3 * D, D, generator=gen, device="cuda") * D ** -0.5
        bqkv = torch.randn(3 * D, generator=gen, device="cuda") * 0.02
        wv, bv = wqkv[2 * D:].contiguous(), bqkv[2 * D:].contiguous()
        y = torch.randn(B, S, D, generator=gen, device="cuda")
        wo, bo = t["w"][:D].contiguous(), t["bias"][:D].contiguous()
        mlp_p = SimpleNamespace(
            c_fc=SimpleNamespace(weight=t["w"], bias=t["bias"]),
            c_proj=SimpleNamespace(weight=t["w2"], bias=t["bias2"]))

        def ln_case(w, bias):
            n = w.shape[0]
            return (functools.partial(FB.ln_linear, x, g, b, w, bias, fp32),
                    lambda: FB.ln_linear_plain(x, g, b, w, bias, fp32),
                    lambda: L.linear(L.layer_norm(x, g, b), w, bias, fp32),
                    2 * R * D * n,
                    (R * D + n * D + n + 2 * D + R * n) * e)

        cases = {
            "ln_linear": ln_case(wqkv, bqkv),
            "ln_linear F=1024": ln_case(wv, bv),
            "linear_residual": (
                functools.partial(FB.linear_residual, x, y, wo, bo, fp32),
                lambda: FB.linear_residual_plain(x, y, wo, bo, fp32),
                lambda: x + L.linear(y, wo, bo, fp32),
                2 * R * D * D, (3 * R * D + D * D + D) * e),
            "mlp_fused": (
                functools.partial(FB.mlp_fused, x, g, b, t["w"], t["bias"],
                                  t["w2"], t["bias2"], act, fp32),
                lambda: FB.mlp_fused_plain(x, g, b, t["w"], t["bias"],
                                           t["w2"], t["bias2"], act, fp32),
                lambda: x + L.mlp(L.layer_norm(x, g, b), mlp_p, act, fp32),
                4 * R * D * F, (2 * R * D + 2 * D * F + F + 3 * D) * e),
        }
        out[B] = {}
        with torch.inference_mode():
            for name, (kern, plain, lib, flops, nbytes) in cases.items():
                ms = cuda_ms(kern, 10)
                what = f"{name} fp32 B={B}"
                key = name.split()[0]
                n = kernels_per_call(kern, "fused_block",
                                     PLANES_PER_CALL[key], what)
                ms_plain = cuda_ms(plain, 5)
                ms_lib = cuda_ms(lib, 5)
                bound_ms, bound_by = bound(6 * flops, nbytes)
                fma_ms = flops / H100_FP32_FMA_FLOPS * 1e3
                out[B][name] = (ms, ms_plain, ms_lib, bound_ms, bound_by, n,
                                fma_ms)
                print(f"time {name} [{B},{S},{D}] fp32: kernel {ms:.4f} ms "
                      f"({6 * flops / ms / 1e9:.1f} TFLOP/s of six bf16 "
                      f"passes), plain {ms_plain:.4f}, unfused sequence "
                      f"{ms_lib:.4f}; bound {bound_ms:.4f} ms by {bound_by} "
                      f"in six bf16 passes, {fma_ms:.4f} in one fp32 pass "
                      f"at the FMA rate on {card}")
        del t, x, y, wqkv, bqkv, wv, wo, cases
        torch.cuda.empty_cache()
    return out


# Phase 9, the evaluation CLI from checkpoints, on a synthetic MVTec set
# whose classes are sized like the small real ones: two classes of 48
# test images (16 normal, 32 anomalous) at 1024 px (MVTec AD's classes
# hold 42-167 test images of 700-1024 px; cut from three classes of 150
# for the script's time, phase 9 being its longest, ~100 s a class on the
# card's host, then to 48 a class when phase 18 came), so the CLI's
# logged rate, which leaves out the first class, covers 48 maps. (b) the
# CLI against a direct predict on the same loaded towers and batches:
# bit for bit (the same kernels and products at the same shapes). (c) the
# kernel run against the same loop on the plain attention: phase 4's
# bars on the scores, at fp32 on the maps too. The fp32 table is held
# within 0.01 points (a rounding may flip) of the table the same loop
# gives with the attention in fp64 (the exact attention
# through the same fp32 trunk), and the plain fp32 attention's table is
# printed beside it: the image AUROC/AP rank each class's images by half
# the min-max-normalised map maximum plus half the score, and two fp32
# attentions can order a near-tied normal/anomalous pair differently; on
# the 150-image set the plain fp32 attention's rounding did so for one
# carpet pair, so its table's carpet image AUROC lay 0.02 points (one of
# 5000 pairs) from both the exact attention's and the 6-pass kernel's,
# which agreed (read on an NVIDIA H100 80GB HBM3, 700 W). The bf16
# map and table are held against a second bf16 attention, the
# library's (SDPA through the same projections): phase 4's bar (kernel
# within 1e-2 of the plain map's span) is below what any two bf16
# attentions agree to on these flat maps (plain span 0.629-0.672). Read
# on an NVIDIA H100 80GB HBM3, 700 W, over the four classes, as fractions
# of the span: max |kernel - plain| 1.525-1.930e-2, max |SDPA - plain|
# 1.634-2.236e-2; mean 2.552-2.799e-3 and 2.540-2.823e-3; max from the
# fp32 map: kernel 2.226-2.733e-2, plain 2.245-3.092e-2, SDPA
# 2.340-3.005e-2. So the kernel's mean distance from the plain map may be
# at most 1.1x SDPA's (read: 1.005x at most) and its max distance 1.5x
# SDPA's (read: 1.165x; a max over 40M pixels scatters more) or phase
# 4's bar. The bf16 table: each cell within 1.0 point of the plain table
# beyond SDPA's distance from it in the same cell. The image AUROC/AP
# rank a class's near-tied images by half their map's maximum, which that
# scatter moves, so one cell can jump by a point: read (150 images a
# class), the kernel's
# table lies up to 1.06 points from plain (cable's image AP, where SDPA
# lies 0.46 from plain), SDPA's up to 0.54, the two up to 0.60 apart.
# (d) the 3-pass M q Mᵀ (JAX's precision "high") against fp64: 1e-5 of the
# map's span, JAX's stated error (read on an NVIDIA H100 80GB HBM3, 700 W:
# 7.375e-6; true fp32 1.142e-7).
EVAL_TABLE_ATOL = {"fp32": 0.01, "bf16": 1.0}
VS_SDPA_MEAN, VS_SDPA_MAX = 1.1, 1.5
PP_3PASS_SPAN_FRAC = 1e-5
EVAL_CLASSES, EVAL_NORMAL, EVAL_ANOMALOUS, EVAL_PX = 2, 16, 32, 1024
EVAL_RUNS = (("bf16", 32), ("fp32", 8))
DECODE_SAMPLE = 8  # images and masks timed one at a time on the host
# the host library's AUROC/AP against numpy's on the same arrays: another
# summation order of the same float64 sums (tests/test_metrics.py's bar)
METRICS_RAW_ATOL = 1e-10


def attention_packed_fp64(qkv, num_heads: int, valid_len: int,
                          precision=None):
    """The exact attention (``attention_fp64``) of a packed fp32 qkv, cast
    back to its dtype, in ``attention_packed_plain``'s signature: phase
    9's fp32 table reference."""
    return attention_fp64(qkv, num_heads, valid_len).to(qkv.dtype)


def sdpa_packed(qkv, num_heads: int, valid_len: int, precision=None):
    """The library's attention (``scaled_dot_product_attention``) on a
    packed [B, S, 3*D] qkv, in ``attention_packed_plain``'s signature
    (``precision`` unused: phase 9 runs it on bf16)."""
    import torch

    B, S, D3 = qkv.shape
    expect(valid_len == S, f"sdpa_packed takes no padding ({valid_len}/{S})")
    hd = D3 // 3 // num_heads
    q, k, v = qkv.view(B, S, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2).reshape(B, S, D3 // 3)


def time_host_decode(images, masks, tmp, img, card) -> None:
    """Decode and resize ``DECODE_SAMPLE`` images and masks one at a time:
    the files as written (every row filter None: the row-by-row unfilter)
    and the same pixels rewritten with every row Paeth (the anti-diagonal
    unfilter, which files with Average or Paeth rows take: libpng's and
    Pillow's adaptive filtering write them)."""
    import os

    import numpy as np

    from aaclip_tpu_torch.data.image import (encode_png, load_gray, load_rgb,
                                             resize_bicubic, resize_nearest)

    from aaclip_tpu_torch.native import build_info
    from aaclip_tpu_torch.native import image as nimage

    sample = images[:DECODE_SAMPLE]
    paeth_dir = os.path.join(tmp, "paeth")
    os.makedirs(paeth_dir)
    paeth = []
    for i, f in enumerate(sample):
        paeth.append(os.path.join(paeth_dir, f"{i:03d}.png"))
        with open(paeth[-1], "wb") as out:
            out.write(encode_png(load_rgb(f), 4))
    native = nimage.image_native_available()
    if not native:
        print(f"eval CLI host: no image library, the CLI decodes with "
              f"data/image.py: {build_info().get('fast_image')}")
    for what, files in (("filter None (rows)", sample),
                        ("filter Paeth (anti-diagonals)", paeth)):
        t0 = time.perf_counter()
        decoded = [load_rgb(f) for f in files]
        dec_ms = (time.perf_counter() - t0) / len(files) * 1e3
        t0 = time.perf_counter()
        resized = [resize_bicubic(x, img) for x in decoded]
        res_ms = (time.perf_counter() - t0) / len(files) * 1e3
        print(f"eval CLI host, one thread, {EVAL_PX} px RGB PNG, {what}: "
              f"decode {dec_ms:.2f} + bicubic resize to {img} px "
              f"{res_ms:.2f} = {dec_ms + res_ms:.2f} ms per image in numpy "
              f"on {card}")
        if files is paeth:
            expect(all(np.array_equal(load_rgb(a), b)
                       for a, b in zip(sample, decoded)),
                   "Paeth-filtered files decode to other pixels")
        if native:
            t0 = time.perf_counter()
            got = [nimage.load_rgb_resize_chw(f, img) for f in files]
            nat_ms = (time.perf_counter() - t0) / len(files) * 1e3
            expect(all(g is not None and np.array_equal(
                g, np.ascontiguousarray(r.transpose(2, 0, 1)))
                for g, r in zip(got, resized)),
                f"native decode + resize differs from numpy's ({what})")
            print(f"eval CLI host, one thread, {what}: the image library "
                  f"{nat_ms:.2f} ms per image, bit for bit the numpy "
                  f"path's ({(dec_ms + res_ms) / nat_ms:.1f}x) on {card}")
    mask_files = masks[:DECODE_SAMPLE]
    t0 = time.perf_counter()
    want = [resize_nearest(load_gray(f), img) for f in mask_files]
    mask_ms = (time.perf_counter() - t0) / DECODE_SAMPLE * 1e3
    print(f"eval CLI host, one thread: {EVAL_PX} px mask decode + nearest "
          f"resize {mask_ms:.2f} ms per mask in numpy on {card}")
    if native:
        t0 = time.perf_counter()
        got = [nimage.load_gray_resize_nearest(f, img) for f in mask_files]
        nat_ms = (time.perf_counter() - t0) / DECODE_SAMPLE * 1e3
        expect(all(g is not None and np.array_equal(g, w)
                   for g, w in zip(got, want)),
               "native mask decode differs from numpy's")
        print(f"eval CLI host, one thread: masks through the image library "
              f"{nat_ms:.2f} ms per mask, bit for bit on {card}")


def openai_state_dict(vit, text) -> dict:
    """The towers as an OpenAI-layout CLIP state dict on the host (what
    ``core/params.py::load_openai_checkpoint`` reads)."""
    import math

    import torch

    def blocks(tower, prefix):
        return {f"{prefix}.{i}.{k}": v for i, blk in enumerate(tower.blocks)
                for k, v in blk.state_dict().items()}

    v = {k: t for k, t in vit.state_dict().items()
         if not k.startswith("blocks.")}
    w = v.pop("conv1.weight")
    sd = {"visual." + k: t for k, t in v.items()}
    sd["visual.conv1.weight"] = w.reshape(w.shape[0], 3, 14, 14)
    sd.update(blocks(vit, "visual.transformer.resblocks"))
    sd.update({k: t for k, t in text.state_dict().items()
               if not k.startswith("blocks.")})
    sd.update(blocks(text, "transformer.resblocks"))
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    return {k: t.detach().cpu().contiguous() for k, t in sd.items()}


def table_distance(rows_a, rows_b) -> float:
    """The largest difference of two tables' cells, in points (the rows'
    class names must agree)."""
    expect([r[0] for r in rows_a] == [r[0] for r in rows_b],
           "the tables' classes differ")
    return max(abs(a - b) for ra, rb in zip(rows_a, rows_b)
               for a, b in zip(ra[1:], rb[1:]))


def read_csv(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def metrics_both_paths(masks, labels, preds, preds_image, cls: str):
    """``metrics_eval`` of one class through the host library, then with
    the library switched off (the numpy path): (rows, seconds, the largest
    difference of the raw AUROC/AP values the two computed)."""
    from aaclip_tpu_torch import native
    from aaclip_tpu_torch.eval import metrics

    base, saved = metrics.auroc_ap, (native.auroc_ap,
                                     native.label_components)
    raw, rows, secs = [], [], []

    def recording(lab, scores):
        raw[-1].append(base(lab, scores))
        return raw[-1][-1]

    metrics.auroc_ap = recording
    try:
        for numpy_path in (False, True):
            if numpy_path:
                native.auroc_ap = native.label_components = \
                    lambda *a: None
            raw.append([])
            t0 = time.perf_counter()
            rows.append(metrics.metrics_eval(masks, labels, preds,
                                             preds_image, cls, "Industrial"))
            secs.append(time.perf_counter() - t0)
    finally:
        metrics.auroc_ap = base
        native.auroc_ap, native.label_components = saved
    expect(len(raw[0]) == len(raw[1]) > 0, f"{cls}: metrics calls differ")
    d = max(abs(a - b) for x, y in zip(*raw) for a, b in zip(x, y))
    return rows, secs, d


def check_label_components(masks) -> None:
    """The host library's connected components of each mask against
    ``scipy.ndimage.label`` (the same raster-order numbering)."""
    import numpy as np
    from scipy import ndimage

    from aaclip_tpu_torch import native

    m = np.asarray(masks).reshape(len(masks), *np.shape(masks)[-2:]) != 0
    t0 = time.perf_counter()
    got = [native.label_components(x) for x in m]
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = [ndimage.label(x) for x in m]
    sci_s = time.perf_counter() - t0
    expect(all(g[1] == w[1] and np.array_equal(g[0], w[0])
               for g, w in zip(got, want)),
           "label_components differs from scipy.ndimage.label")
    print(f"eval CLI host: label_components on {len(m)} masks equals "
          f"scipy.ndimage.label ({sum(w[1] for w in want)} regions; "
          f"{nat_s:.3f} s against scipy's {sci_s:.3f} s)")


def write_seeded_checkpoint(tmp: str, card) -> str:
    """A seeded ViT-L-14-336 at its native 336 px grid, saved as an
    OpenAI-layout state dict under ``tmp`` (the loaders resize the
    positional embedding 24 -> 37 at 518 px); phases 9 and 10 load it."""
    import os

    import torch

    from aaclip_tpu_torch.core.config import get_config
    from aaclip_tpu_torch.core.params import (init_text_params,
                                              init_vision_params)

    native = get_config("ViT-L-14-336", img_size=336)
    sd = openai_state_dict(init_vision_params(native, seed=7),
                           init_text_params(native, seed=8))
    expect(sd["visual.positional_embedding"].shape == (577, 1024),
           "the checkpoint is not at the 24x24 grid")
    path = os.path.join(tmp, "ViT-L-14-336.pt")
    t0 = time.perf_counter()
    torch.save(sd, path)
    save_s = time.perf_counter() - t0
    print(f"eval CLI: checkpoint {os.path.getsize(path) / 1e9:.3f} GB saved "
          f"in {save_s:.2f} s on {card}")
    return path


def eval_log(log: str, name: str):
    """(maps/s, the host-paths line, metrics_eval seconds per class) of an
    evaluation CLI's test.log."""
    import re

    rate = float(re.search(r"eval throughput: ([\d.]+) maps/s",
                           log).group(1))
    host = re.findall(r"host paths: (.*)", log)
    expect(len(host) == 1, f"eval CLI {name}: {len(host)} host-path lines")
    mtimes = [float(t) for t in re.findall(r"metrics_eval: ([\d.]+) s",
                                           log)]
    expect(len(mtimes) == EVAL_CLASSES,
           f"eval CLI {name}: {len(mtimes)} metrics_eval lines")
    return rate, host[0], mtimes


def start_eval_cli_numpy_path(native_save, ckpt_path, adapters, B) -> dict:
    """The bf16 evaluation CLI again, in a child process with
    ``AACLIP_NO_NATIVE`` set (the numpy metrics and decode), started and
    left running: phase 9's fp32 checks go on beside it (its work is on the
    host: a numpy decode at ~9 maps/s). ``finish_eval_cli_numpy_path``
    waits for it and checks it. Its output goes to files beside its save
    path, so no pipe can fill."""
    import gc
    import os
    import subprocess
    import threading

    import torch

    save = native_save + "_numpy"
    shutil.copytree(adapters, save)
    gc.collect()
    torch.cuda.empty_cache()
    out = open(save + ".out", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "aaclip_tpu_torch.test", "--clip_checkpoint",
         ckpt_path, "--save_path", save, "--precision", "bf16",
         "--batch_size", str(B), "--csv"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, "AACLIP_NO_NATIVE": "1"}, stdout=out,
        stderr=subprocess.STDOUT, text=True)
    child = {"proc": proc, "save": save, "native_save": native_save,
             "B": B, "out": out, "t0": t0, "ended": []}
    # the process's own wall, whenever the parent comes to collect it
    threading.Thread(target=lambda: (proc.wait(), child["ended"].append(
        time.perf_counter())), daemon=True).start()
    return child


def finish_eval_cli_numpy_path(child, native_rate, native_mtimes,
                               card) -> None:
    """Waits for ``start_eval_cli_numpy_path``'s child: its log must say it
    ran the numpy paths, its table must equal the native run's, and its
    maps/s and metrics_eval seconds per class print beside the native
    run's (read while the parent's fp32 checks ran)."""
    import os
    import subprocess

    proc = child["proc"]
    try:
        proc.wait(timeout=1200)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    child["out"].close()
    while not child["ended"]:
        time.sleep(0.01)
    wall = child["ended"][0] - child["t0"]
    save, native_save = child["save"], child["native_save"]
    expect(proc.returncode == 0, f"eval CLI, numpy path: exit "
           f"{proc.returncode}: {open(save + '.out').read()[-2000:]}")
    rate, host_line, mtimes = eval_log(
        open(os.path.join(save, "test.log")).read(), "bf16 numpy")
    expect(host_line.startswith("metrics numpy")
           and "decode native 0, " in host_line,
           f"eval CLI, numpy path: {host_line}")
    same = read_csv(os.path.join(save, "results_1.csv")) == \
        read_csv(os.path.join(native_save, "results_1.csv"))
    print(f"eval CLI bf16 B={child['B']}, child process with "
          f"AACLIP_NO_NATIVE, beside the fp32 run's direct checks: "
          f"{host_line}; {rate:.2f} maps/s logged against {native_rate:.2f} "
          f"on the host library (run alone); metrics_eval per class "
          f"{', '.join(f'{t:.2f}' for t in mtimes)} s against "
          f"{', '.join(f'{t:.2f}' for t in native_mtimes)} s; tables equal "
          f"{same}; {wall:.1f} s for the process on {card}")
    expect(same, "eval CLI: the numpy path's table differs from the host "
           "library's")


def phase_eval_cli(card, ckpt_path: str) -> None:
    """Phase 9: ``aaclip_tpu_torch.test.main`` at ViT-L-14-336 @ 518 from
    the saved OpenAI-layout checkpoint ``ckpt_path``, an npz image adapter
    and a reference ``.pth`` text adapter, on a synthetic MVTec set of real
    size, once per ``EVAL_RUNS`` entry, held to (a) 24 kernel launches per
    predict batch and no other kernel, (b), (c) and (d) above; the host's
    decode and resize timed beside it."""
    import gc
    import os
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from aaclip_tpu_torch import test as cli
    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              init_image_adapter,
                                              init_text_adapter,
                                              text_adapter_from_jax,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.data.datasets import BatchLoader, get_test_datasets
    from aaclip_tpu_torch.data.registry import CLASS_NAMES
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.eval.metrics import metrics_eval
    from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                               make_predict_fn,
                                               run_class_predictions)
    from aaclip_tpu_torch.kernels.build import kernels_launched
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import (attention_kernel,
                                                attention_packed_plain,
                                                make_attn_fn)
    from aaclip_tpu_torch.ops.similarity import (apply_postproc_matrix,
                                                 fused_postproc_matrix)
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors
    from aaclip_tpu_torch.train import checkpoint as ckpt

    cfg = get_config("ViT-L-14-336", img_size=518)
    img, grid, n_layers = (cfg.vision.image_size, cfg.vision.grid,
                           cfg.vision.layers)
    acfg = AdapterConfig()
    tmp = tempfile.mkdtemp(prefix="aaclip_eval_cli_")
    env_before = {k: os.environ.get(k) for k in ("AACLIP_DATA",
                                                 "AACLIP_METADATA")}
    numpy_child = None
    try:
        # the host libraries: the metrics one must build here; the image
        # one needs libjpeg and libpng headers, which the host may lack
        from aaclip_tpu_torch import native
        from aaclip_tpu_torch.native import image as nimage

        metrics_native = native.native_available()
        image_native = nimage.image_native_available()
        print(f"eval CLI host libraries: {native.build_info()}")
        expect(metrics_native, f"the metrics library did not build: "
               f"{native.build_info().get('fast_metrics')}")
        # the adapters: npz image snapshot, reference .pth text adapter
        ad_tree = adapter_to_jax(init_image_adapter(cfg, acfg, seed=9,
                                                    device="cpu"))
        text_sd, _ = ckpt.adapters_to_torch_state_dicts(
            {"text": text_adapter_to_jax(init_text_adapter(
                cfg, acfg, seed=10, device="cpu")), "image": ad_tree},
            proj_relu=False)
        adapters = os.path.join(tmp, "adapters")
        ckpt.save_adapter_checkpoint(
            os.path.join(adapters, "image_adapter_1.npz"), 1, ad_tree)
        torch.save({"epoch": 0, "text_adapter": text_sd},
                   os.path.join(adapters, "text_adapter.pth"))
        # the synthetic dataset
        classes = CLASS_NAMES["MVTec"][:EVAL_CLASSES]
        per_class = EVAL_NORMAL + EVAL_ANOMALOUS
        t0 = time.perf_counter()
        data_root, meta_root = make_synthetic_dataset(
            os.path.join(tmp, "synthetic"), class_names=classes,
            n_normal=EVAL_NORMAL, n_anomalous=EVAL_ANOMALOUS, img_px=EVAL_PX,
            hard=True)
        os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
        files = sorted(os.path.join(d, f) for d, _, fs in
                       os.walk(data_root) for f in fs)
        images = [f for f in files if not f.endswith("_mask.png")]
        masks = [f for f in files if f.endswith("_mask.png")]
        expect(len(images) == EVAL_CLASSES * per_class
               and len(masks) == EVAL_CLASSES * EVAL_ANOMALOUS,
               f"{len(images)} synthetic images, {len(masks)} masks")
        print(f"eval CLI: synthetic MVTec {', '.join(classes)}: "
              f"{len(images)} images of {EVAL_PX} px, {len(masks)} masks, "
              f"{sum(map(os.path.getsize, files)) / 1e9:.3f} GB written in "
              f"{time.perf_counter() - t0:.1f} s")
        time_host_decode(images, masks, tmp, img, card)

        # the direct path's towers, loaded as the CLI loads them
        t0 = time.perf_counter()
        vit, text = create_clip_towers(cfg, checkpoint=ckpt_path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"eval CLI: checkpoint loaded into the towers on the card in "
              f"{load_s:.2f} s (pos embed {tuple(vit.positional_embedding.shape)})"
              f" on {card}")
        image_adapter = adapter_from_jax(ad_tree, cfg, acfg)
        _, tree = ckpt.load_reference_checkpoint(
            os.path.join(adapters, "text_adapter.pth"), "text",
            n_adapt=acfg.text_adapt_until)
        text_adapter = text_adapter_from_jax(tree, cfg, acfg)

        for name, B in EVAL_RUNS:
            policy = DtypePolicy.from_name(name)
            save = os.path.join(tmp, f"run_{name}")
            shutil.copytree(adapters, save)
            zero_fused_counts()
            before = kernels_launched("attention_packed")
            t0 = time.perf_counter()
            cli.main(["--clip_checkpoint", ckpt_path, "--save_path", save,
                      "--precision", name, "--batch_size", str(B), "--csv",
                      "--dump_scores"])
            wall = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            # (a) 24 launches per predict batch, no other kernel
            n_batches = EVAL_CLASSES * -(-per_class // B)
            n_lib = kernels_launched("attention_packed") - before
            counts_now = dict(zip(("standard", "vv", "bwd"), counts()))
            # fp32: each launch on the 6-pass route after a split3 launch
            per_launch = 2 if name == "fp32" else 1
            if name == "fp32":
                expect_6pass(counts(), f"eval CLI {name}")
            others = {"attention_kernel": attention_kernel.launches,
                      "ln_linear": FB.ln_linear.launches,
                      "linear_residual": FB.linear_residual.launches,
                      "mlp_fused": FB.mlp_fused.launches}
            print(f"eval CLI {name} B={B}: {n_batches} predict batches, "
                  f"attention_packed {counts_now['standard']} launches "
                  f"({n_lib} kernels counted by the library), V-V "
                  f"{counts_now['vv']}, backward {counts_now['bwd']}, "
                  f"{others}")
            expect(counts_now["standard"] == n_layers * n_batches
                   and n_lib == per_launch * counts_now["standard"],
                   f"eval CLI {name}: {counts_now['standard']} launches, "
                   f"{n_lib} kernels, not {n_layers} x {n_batches}")
            expect(counts_now["vv"] == counts_now["bwd"] == 0
                   and not any(others.values()),
                   f"eval CLI {name}: other kernels ran: {counts_now}, "
                   f"{others}")
            log = open(os.path.join(save, "test.log")).read()
            rate, host_line, mtimes = eval_log(log, name)
            expect(host_line.startswith("metrics native")
                   and (not image_native or ", fallback 0 " in host_line),
                   f"eval CLI {name}: not on the host library: {host_line}")
            print(f"eval CLI {name} B={B}: {rate:.2f} maps/s logged (eval "
                  f"throughput, the first class excluded); {wall:.2f} s "
                  f"for the whole main(); metrics_eval per class "
                  f"{', '.join(f'{t:.2f}' for t in mtimes)} s on {card}")
            if name == "bf16":  # the numpy path's child, started below
                native_run = (save, rate, mtimes, B)
            else:
                numpy_child = start_eval_cli_numpy_path(
                    native_run[0], ckpt_path, adapters, native_run[3])

            # (b) the CLI's scores equal a direct predict, bit for bit
            uint8 = name == "bf16"
            heads = cfg.vision.heads
            kernel = make_predict_fn(vit, cfg, acfg, policy=policy,
                                     uint8_inputs=uint8)
            plain = make_predict_fn(
                vit, cfg, acfg, policy=policy, uint8_inputs=uint8,
                attn_fn=make_attn_fn(heads, policy,
                                     attention=attention_packed_plain))
            library = make_predict_fn(
                vit, cfg, acfg, policy=policy, uint8_inputs=uint8,
                attn_fn=make_attn_fn(heads, policy, attention=sdpa_packed))
            exact = make_predict_fn(vit, cfg, acfg,
                                    policy=DtypePolicy.fp32(),
                                    uint8_inputs=uint8)
            exact_attention = make_predict_fn(
                vit, cfg, acfg, policy=policy, uint8_inputs=uint8,
                attn_fn=make_attn_fn(heads, policy,
                                     attention=attention_packed_fp64))
            anchors = encode_dataset_anchors(
                make_anchor_encoder(text, cfg, acfg, text_adapter,
                                    policy=policy), "MVTec")
            scores = read_csv(os.path.join(save, "scores_1.csv"))[1:]
            table = read_csv(os.path.join(save, "results_1.csv"))
            plain_rows, lib_rows, exact_rows, both_paths = [], [], [], []
            dpix_rel = dscore = 0.0
            bf16_maps = {}
            host_s = {"loader": [], "metrics": []}
            for cls, ds in get_test_datasets("MVTec", img,
                                             uint8=uint8).items():
                if len(ds) == 0:
                    continue
                t0 = time.perf_counter()
                batches = list(BatchLoader(ds, B, num_workers=4))
                host_s["loader"].append(time.perf_counter() - t0)
                got = run_class_predictions(kernel, image_adapter, batches,
                                            anchors[cls], "Industrial", img,
                                            grid)
                mine = [r for r in scores if r[0] == cls]
                expect([r[1] for r in mine] == got[4]
                       and [int(r[2]) for r in mine] == got[1].tolist(),
                       f"eval CLI {name} {cls}: files or labels differ")
                expect([float(r[3]) for r in mine]
                       == [float(x) for x in got[3]],
                       f"eval CLI {name} {cls}: scores differ from the "
                       f"direct predict")
                if name == "bf16":
                    (nat_row, num_row), secs, d = metrics_both_paths(
                        got[0], got[1], got[2], got[3], cls)
                    print(f"eval CLI bf16 {cls}: metrics_eval through the "
                          f"host library {secs[0]:.3f} s, numpy "
                          f"{secs[1]:.3f} s; raw AUROC/AP max |d| {d:.3e} "
                          f"(bar {METRICS_RAW_ATOL}); rows equal "
                          f"{nat_row == num_row}")
                    expect(d <= METRICS_RAW_ATOL and nat_row == num_row,
                           f"eval CLI {cls}: the metric paths differ: "
                           f"{nat_row} vs {num_row}")
                    both_paths.append(secs)
                    if len(both_paths) == 1:
                        check_label_components(got[0])
                # (c) the plain attention on the same batches
                ref = run_class_predictions(plain, image_adapter, batches,
                                            anchors[cls], "Industrial", img,
                                            grid)
                span = float(ref[2].max() - ref[2].min())
                dpix = float(np.abs(got[2] - ref[2]).max())
                dpix_rel = max(dpix_rel, dpix / span)
                dscore = max(dscore, float(np.abs(got[3] - ref[3]).max()))
                if name == "bf16":
                    lib = run_class_predictions(
                        library, image_adapter, batches, anchors[cls],
                        "Industrial", img, grid)
                    f32 = run_class_predictions(
                        exact, image_adapter, batches, anchors[cls],
                        "Industrial", img, grid)[2]
                    span32 = float(f32.max() - f32.min())
                    r = {"span": span, "kernel-plain": dpix / span,
                         "sdpa-plain": float(np.abs(lib[2] - ref[2]).max())
                         / span,
                         "kernel-plain mean": float(np.abs(got[2] - ref[2])
                                                    .mean()) / span,
                         "sdpa-plain mean": float(np.abs(lib[2] - ref[2])
                                                  .mean()) / span}
                    for k, m in (("kernel", got[2]), ("plain", ref[2]),
                                 ("sdpa", lib[2])):
                        r[f"{k}-fp32"] = float(np.abs(m - f32).max()) / span32
                    bf16_maps[cls] = r
                    expect(dscore <= SCORE_ATOL_BF16,
                           f"eval CLI bf16 {cls}: scores off by {dscore}")
                else:
                    torch.testing.assert_close(
                        torch.from_numpy(got[2]), torch.from_numpy(ref[2]),
                        atol=PIX_ATOL_FP32, rtol=PIX_RTOL_FP32)
                    torch.testing.assert_close(
                        torch.from_numpy(got[3]), torch.from_numpy(ref[3]),
                        atol=SCORE_ATOL_FP32, rtol=0)
                t0 = time.perf_counter()
                row = metrics_eval(ref[0], ref[1], ref[2], ref[3], cls,
                                   "Industrial")
                host_s["metrics"].append(time.perf_counter() - t0)
                plain_rows.append([cls] + [float(row[c])
                                           for c in table[0][1:]])
                if name == "bf16":
                    row = metrics_eval(ref[0], ref[1], lib[2], lib[3], cls,
                                       "Industrial")
                    lib_rows.append([cls] + [float(row[c])
                                             for c in table[0][1:]])
                else:
                    e64 = run_class_predictions(
                        exact_attention, image_adapter, batches,
                        anchors[cls], "Industrial", img, grid)
                    row = metrics_eval(ref[0], ref[1], e64[2], e64[3], cls,
                                       "Industrial")
                    exact_rows.append([cls] + [float(row[c])
                                               for c in table[0][1:]])
                    del e64
            for rows in (plain_rows, lib_rows, exact_rows):
                if rows:
                    rows.append(["Average"] + [
                        sum(r[i] for r in rows) / len(rows)
                        for i in range(1, len(table[0]))])
            print(f"eval CLI {name} host, per class of {per_class} images: "
                  f"the loader (the CLI's, 4 threads) "
                  f"{', '.join(f'{t:.2f}' for t in host_s['loader'])} s, "
                  f"metrics_eval (pixel and image AUROC/AP) "
                  f"{', '.join(f'{t:.2f}' for t in host_s['metrics'])} s "
                  + ("" if name == "bf16" else "(the numpy path's child "
                     "beside them) ") + f"on {card}")
            print(f"eval CLI {name}: the CLI's scores equal the direct "
                  f"predict's bit for bit; kernel vs plain attention: max|d "
                  f"map| {dpix_rel:.3e} of the span, max|d score| "
                  f"{dscore:.3e}")
            for cls, r in bf16_maps.items():
                print(f"eval CLI bf16 {cls}: plain map span {r['span']:.4f}; "
                      f"max|d map| of the span: kernel vs plain "
                      f"{r['kernel-plain']:.3e} (phase 4's bar "
                      f"{PIX_SPAN_FRAC_BF16}), SDPA vs plain "
                      f"{r['sdpa-plain']:.3e}; mean: kernel vs plain "
                      f"{r['kernel-plain mean']:.3e}, SDPA vs plain "
                      f"{r['sdpa-plain mean']:.3e}; vs the fp32 map: kernel "
                      f"{r['kernel-fp32']:.3e}, plain {r['plain-fp32']:.3e}, "
                      f"SDPA {r['sdpa-fp32']:.3e}")
            for cls, r in bf16_maps.items():
                expect(r["kernel-plain mean"]
                       <= VS_SDPA_MEAN * r["sdpa-plain mean"]
                       and r["kernel-plain"] <= max(
                           PIX_SPAN_FRAC_BF16,
                           VS_SDPA_MAX * r["sdpa-plain"]),
                       f"eval CLI bf16 {cls}: the kernel's map lies "
                       f"{r['kernel-plain mean']} (mean) and "
                       f"{r['kernel-plain']} (max) of the span from the "
                       f"plain map, SDPA's {r['sdpa-plain mean']} and "
                       f"{r['sdpa-plain']}")
            kernel_rows = [[r[0]] + [float(x) for x in r[1:]]
                           for r in table[1:]]
            print(f"eval CLI {name}: the CLI's table (kernel attention):\n"
                  + cli.format_table(table[0], kernel_rows))
            print(f"eval CLI {name}: the same loop on the plain attention:\n"
                  + cli.format_table(table[0], plain_rows))
            dtable = table_distance(kernel_rows, plain_rows)
            print(f"eval CLI {name}: the kernel's table differs from the "
                  f"plain one by at most {dtable:.4f} points")
            if lib_rows:
                print(f"eval CLI {name}: the same loop on SDPA:\n"
                      + cli.format_table(table[0], lib_rows))
                print(f"eval CLI {name}: SDPA's table differs from the "
                      f"plain one by at most "
                      f"{table_distance(lib_rows, plain_rows):.4f} points, "
                      f"from the kernel's by at most "
                      f"{table_distance(lib_rows, kernel_rows):.4f}")
                dtable = max(abs(k - p) - abs(q - p) for rk, rp, rq in
                             zip(kernel_rows, plain_rows, lib_rows)
                             for k, p, q in zip(rk[1:], rp[1:], rq[1:]))
                print(f"eval CLI {name}: beyond SDPA's distance from the "
                      f"plain table in the same cell, the kernel's lies at "
                      f"most {dtable:.4f} points from it")
            if exact_rows:
                print(f"eval CLI {name}: the same loop with the attention in "
                      f"fp64:\n" + cli.format_table(table[0], exact_rows))
                dtable = table_distance(kernel_rows, exact_rows)
                print(f"eval CLI {name}: the kernel's table differs from the "
                      f"fp64-attention one by at most {dtable:.4f} points, "
                      f"the plain attention's by at most "
                      f"{table_distance(plain_rows, exact_rows):.4f}")
            expect(dtable <= EVAL_TABLE_ATOL[name],
                   f"eval CLI {name}: tables differ by {dtable} points (bar "
                   f"{EVAL_TABLE_ATOL[name]})")
            del kernel, plain, library, exact, exact_attention
            gc.collect()
            torch.cuda.empty_cache()
        finish_eval_cli_numpy_path(numpy_child, native_run[1],
                                   native_run[2], card)

        # (d) the 3-pass M q Mᵀ against fp64
        gen = torch.Generator(device="cuda").manual_seed(9)
        q = torch.randn(32, grid, grid, generator=gen, device="cuda") * 10 + 2
        M = torch.from_numpy(fused_postproc_matrix(grid, img,
                                                   "Industrial")).cuda()
        exact = torch.einsum("Ig,bgh,Jh->bIJ", M.double(), q.double(),
                             M.double())
        span = (exact.max() - exact.min()).item()
        errs = {p: (apply_postproc_matrix(q, M, p).double() - exact).abs()
                .max().item() / span for p in ("high", "highest")}
        print(f"M q Mᵀ on the card vs fp64 [32, {img}, {img}]: 3-pass "
              f"{errs['high']:.3e} of the span (bar {PP_3PASS_SPAN_FRAC}), "
              f"fp32 {errs['highest']:.3e}")
        expect(errs["high"] <= PP_3PASS_SPAN_FRAC,
               f"3-pass M q Mᵀ off by {errs['high']} of the span")
    finally:
        if numpy_child is not None and numpy_child["proc"].poll() is None:
            numpy_child["proc"].kill()
            numpy_child["proc"].wait()
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 10, the training CLI (``python -m aaclip_tpu_torch.train`` through
# ``main``) at ViT-L-14-336 @ 518 from phase 9's checkpoint, on a
# synthetic MVTec training set of 2 classes of 16 images at 1024 px (8
# normal, 8 anomalous: a real class's pixel size, MVTec AD's training
# classes hold 60-391 images), bf16, at the CLI's own batch sizes (16 text,
# 2 image), remat auto (selective on the card for both stages, and the log
# says so), full shot. (a) Launch counts: B1 24 per stage-1 features call
# and 24 per stage-2 step (selective remat reruns no attention forward;
# phase 5 counts the same), B2 23 per step, B3 19 per spatial features
# call, no fused-block kernel. (b) Each
# stage's first update, done again from the same batch, adapter and
# anchors on the plain attention: the CLI's step-1 loss within phase 7's
# bar (S1_STEP_LOSS_RTOL, stage 1) and phase 5's (STEP_LOSS_RTOL, stage
# 2), which hold the same kernel-vs-plain difference at batch 2 (read on
# an NVIDIA H100 80GB HBM3, 700 W: 1.229e-4 and 1.084e-5 relative, as
# phases 7 and 5 read 2.8e-3 and 2.8e-5); every later loss finite. (c)
# The checkpoints, loaded into fresh adapters and Adam and saved again,
# give the same files bit for bit (adapters,
# moments, counts, the schedule's count, epoch and step). (d) A run
# resumed with --image_epoch 3 trains image epoch 2 only and continues the
# counts. (e) The evaluation CLI on the trained checkpoints gives the full
# table, finite. The device path (--device_augment --cache_device, one
# stage-2 epoch): the card's jitter chain and geometric augment on 16 of
# the cached 518 px images, with drawn parameters, equal the host's numpy
# functions bit for bit (CUDA divides by a Python scalar through its
# reciprocal, an ulp off numpy: ops/augment.py divides by device tensors);
# the host's jitter equals the installed Pillow's on random and fixed
# factors. The device path runs four times, unfused, with --fused_assemble
# (batch k+1 assembled on a second CUDA stream while step k runs) twice,
# unfused: every epoch's losses equal the first's bit for bit. Rates are
# printed, not held: no gain is claimed. The phase took
# 88-124 s on an NVIDIA H100 80GB HBM3, 700 W (phase 9: 317-326 s).
# (12 normal and 12 anomalous a class, from 24 when phase 17 was added:
# on a host 25% slower than usual the whole script ran 1348 s with this
# phase at 215 s, past a 1200 s limit for the run; 8 and 8 since phase 18
# came, when a host ~1.3x slower ran the whole script 1198 s with this
# phase at 129 s.)
TRAIN_CLI_CLASSES, TRAIN_CLI_PER_KIND, TRAIN_CLI_PX = 2, 8, 1024
TRAIN_CLI_SEED = 111  # the CLI's default --seed
# forward launches per stage-2 step under full remat: 24, and the 23
# blocks whose input carries a gradient again in the backward
S2_FWD_PER_STEP_REMAT = 47


def pil_jitter(img, factors):
    """Pillow's ImageEnhance chain on uint8 [H, W, 3] (1.0 skips)."""
    import numpy as np
    from PIL import Image, ImageEnhance

    p = Image.fromarray(img)
    for enhancer, f in zip((ImageEnhance.Brightness, ImageEnhance.Contrast,
                            ImageEnhance.Color), factors):
        if f != 1.0:
            p = enhancer(p).enhance(f)
    return np.asarray(p)


def check_jitter_vs_pillow(images) -> None:
    """The host colour jitter against the installed Pillow: 300 random
    images at seeded factors, every triple of 0.5, 1.0 and 1.5, and the
    synthetic 1024 px ``images`` at drawn factors."""
    import itertools

    import PIL
    import numpy as np

    from aaclip_tpu_torch.data import transforms as T
    from aaclip_tpu_torch.data.image import load_rgb

    rng = np.random.default_rng(0)
    n = 0
    for i in range(300):
        h, w = (int(v) for v in rng.integers(1, 65, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 2:
            img = (img // 8 + rng.integers(0, 224)).astype(np.uint8)
        cases = [T.jitter_factors(rng)]
        if i < 3:
            cases += list(itertools.product((0.5, 1.0, 1.5), repeat=3))
        for f in cases:
            expect(np.array_equal(T.jitter_chain(img, *f),
                                  pil_jitter(img, f)),
                   f"colour jitter differs from Pillow at {f}")
            n += 1
    for i, path in enumerate(images):
        img = load_rgb(path)
        f = T.jitter_factors(np.random.default_rng(i))
        expect(np.array_equal(T.jitter_chain(img, *f), pil_jitter(img, f)),
               f"colour jitter differs from Pillow on {path} at {f}")
    print(f"train CLI: the host colour jitter equals Pillow "
          f"{PIL.__version__}'s bit for bit in {n} cases on 300 random "
          f"images and on {len(images)} of {TRAIN_CLI_PX} px")


def check_device_augment_vs_host(ds, n: int) -> None:
    """The card's jitter chain and geometric augment on ``n`` cached
    (resized, pre-jitter) images of ``ds`` with drawn parameters, against
    the host's numpy functions: bit for bit."""
    import os

    import numpy as np
    import torch

    from aaclip_tpu_torch.data import transforms as T
    from aaclip_tpu_torch.ops import augment as aug

    raw = [T.preprocess_train(
        os.path.join(ds.spec.data_path, r.image_path),
        os.path.join(ds.spec.data_path, r.mask_path) if r.mask_path
        else None, ds.img_size, r.label, None, True, geometric=False,
        uint8=True) for r in ds.records[::len(ds) // n][:n]]
    imgs = torch.from_numpy(np.stack([r[0] for r in raw])).cuda()
    masks = torch.from_numpy(np.stack([r[1][0] for r in raw])).cuda()
    H = W = ds.img_size
    gen = aug.augment_generator(TRAIN_CLI_SEED, 2, 0, 0, "cuda")
    fb, fc, fs = aug.jitter_params(gen, n)
    params = aug.geometric_params(gen, n, H, W)
    jit = aug.jitter_chain(imgs, fb, fc, fs)
    img_d, mask_d, valid = aug.geometric_augment_u8(jit, masks, params)
    img_d = aug.normalize_valid(img_d, valid).cpu()
    mask_d = (mask_d.float() * valid.float()).cpu()
    jit = jit.cpu().numpy()
    angle, ty, tx, hflip, vflip = (t.cpu() for t in params)
    expect(bool((angle != 0).any() and (tx != 0).any() and hflip.any()
                and vflip.any() and (fc != 1).any()),
           "the drawn parameters leave a transform out")
    for b in range(n):
        host = T.jitter_chain(raw[b][0].transpose(1, 2, 0), float(fb[b]),
                              float(fc[b]), float(fs[b]))
        expect(np.array_equal(jit[b], host.transpose(2, 0, 1)),
               f"the card's jitter differs from the host's on sample {b}")
        want = T.apply_geometric(
            np.concatenate([T.normalize_uint8_chw(jit[b]),
                            raw[b][1].astype(np.float32)]),
            float(angle[b]), float(ty[b]), float(tx[b]), bool(hflip[b]),
            bool(vflip[b]))
        got = img_d[b].numpy()
        expect(np.array_equal(got.view(np.int32), want[:3].view(np.int32))
               and np.array_equal(mask_d[b].numpy(), want[3]),
               f"the card's geometric augment differs from the host's on "
               f"sample {b} ({float(angle[b])}, {float(ty[b])}, "
               f"{float(tx[b])}, {bool(hflip[b])}, {bool(vflip[b])}): "
               f"{int((got != want[:3]).sum())} values, max |d| "
               f"{float(np.abs(got - want[:3]).max())}, masks "
               f"{int((mask_d[b].numpy() != want[3]).sum())}")
    print(f"train CLI: the card's jitter chain and geometric augment equal "
          f"the host's bit for bit on {n} cached {H} px images (angles "
          f"{angle.abs().max().item():.2f} deg at most, "
          f"{int((angle != 0).sum())} rotated, {int((tx != 0).sum())} "
          f"translated)")


def epoch_reports(log: str) -> list:
    """(stage, epoch, img/s, {phase: % of the accounted host wall}) per
    logged epoch of a train.log."""
    import re

    out = []
    for block in re.split(r"INFO:aaclip\.train:training ", log)[1:]:
        m = re.match(r"(text|image) epoch (\d+):", block)
        rate = float(re.search(r"throughput: ([\d.]+) img/s",
                               block).group(1))
        shares = {k: float(v) for k, v in re.findall(
            r"\n  (\w+)\s+[\d.]+ ms/step\s+\(\s*([\d.]+)% of accounted",
            block)}
        out.append((m.group(1), int(m.group(2)), rate, shares))
    return out


def train_cli_losses(argv) -> list:
    """``aaclip_tpu_torch.train.cli.main(argv)`` with each epoch's per-step
    losses recorded (``ThrottledLossDrain.drain`` wrapped); returns them,
    one list per epoch."""
    import torch

    import aaclip_tpu_torch.utils.profiling as profiling
    from aaclip_tpu_torch.train import cli

    losses = []
    base = profiling.ThrottledLossDrain

    class Recording(base):
        def drain(self):
            vals = super().drain()
            losses.append(vals)
            return vals

    profiling.ThrottledLossDrain = Recording
    try:
        cli.main(argv)
    finally:
        profiling.ThrottledLossDrain = base
    torch.cuda.synchronize()
    return losses


def plain_first_losses(vit, text, cfg, acfg, policy, save_path, text_ds,
                       image_ds):
    """Each stage's first update of a training-CLI run (seed
    ``TRAIN_CLI_SEED``, batches 16 and 2, its first shuffled batches and
    seeded adapters) again under ``policy`` on the plain attention, the
    stage-2 anchors from the run's ``text_adapter.npz`` under
    ``save_path``: returns (stage-1 loss, stage-2 loss)."""
    import os

    import torch

    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_text_adapter,
                                              text_adapter_from_jax,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.data.datasets import BatchLoader
    from aaclip_tpu_torch.data.registry import CLASS_NAMES
    from aaclip_tpu_torch.eval.predict import make_anchor_encoder
    from aaclip_tpu_torch.ops.attention import (attention_packed_diff_plain,
                                                attention_packed_plain,
                                                make_attn_fn)
    from aaclip_tpu_torch.text.anchors import (dataset_prompt_tokens,
                                               encode_dataset_anchors)
    from aaclip_tpu_torch.train import checkpoint as ckpt
    from aaclip_tpu_torch.train.optim import (make_image_optimizer,
                                              make_text_optimizer)
    from aaclip_tpu_torch.train.steps import (make_stage1_step,
                                              make_stage2_step,
                                              stage1_features_fn)

    heads, seed = cfg.vision.heads, TRAIN_CLI_SEED

    def first_batch(ds, B, loader_seed):
        b = next(iter(BatchLoader(ds, B, shuffle=True, seed=loader_seed)))
        return (torch.as_tensor(b["image"], device="cuda"),
                torch.as_tensor(b["mask"][:, 0], device="cuda"),
                torch.as_tensor(b["label"], device="cuda").long(),
                torch.tensor([CLASS_NAMES["MVTec"].index(c)
                              for c in b["class_name"]], device="cuda"),
                torch.ones(B, device="cuda"))

    images, mask, _, cidx, valid = first_batch(text_ds, 16, seed)
    feats = stage1_features_fn(
        vit, cfg, surgery_until_layer=STAGE1_SURGERY_UNTIL, policy=policy,
        vv_mode="batch",
        attn_fn=make_attn_fn(heads, policy,
                             attention=attention_packed_plain))(
        images, valid)
    tad = init_text_adapter(cfg, acfg, seed=seed + 1)
    s1 = make_stage1_step(text, cfg, acfg,
                          make_text_optimizer(tad.parameters(), 1e-5),
                          dataset_prompt_tokens("MVTec"), policy=policy)
    plain1 = s1(tad, feats, mask, cidx, valid).item()
    del feats, s1, tad
    _, tree, _ = ckpt.load_adapter_checkpoint(
        os.path.join(save_path, "text_adapter.npz"),
        text_adapter_to_jax(init_text_adapter(cfg, acfg, device="cpu")))
    anchors = encode_dataset_anchors(make_anchor_encoder(
        text, cfg, acfg, text_adapter_from_jax(tree, cfg, acfg),
        policy=policy), "MVTec")
    table = torch.stack([anchors[c] for c in CLASS_NAMES["MVTec"]])
    iad = init_image_adapter(cfg, acfg, seed=seed)
    s2 = make_stage2_step(
        vit, cfg, acfg, make_image_optimizer(iad.parameters(), 5e-4),
        table, policy=policy, remat=True,
        attn_fn=make_attn_fn(heads, policy,
                             attention=attention_packed_diff_plain))
    plain2 = s2(iad, *first_batch(image_ds, 2, seed + 1)).item()
    return plain1, plain2


def phase_train_cli(card, ckpt_path: str) -> dict:
    """Phase 10: the training CLI on the card; returns {run: (B1, B3, B2
    launches)} for the kernel line."""
    import gc
    import os

    import numpy as np
    import torch

    from aaclip_tpu_torch import test as eval_cli
    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              init_image_adapter,
                                              init_text_adapter,
                                              text_adapter_from_jax,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.data.datasets import get_train_datasets
    from aaclip_tpu_torch.data.registry import CLASS_NAMES
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.kernels.build import kernels_launched
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import attention_kernel
    from aaclip_tpu_torch.text.anchors import dataset_prompt_tokens
    from aaclip_tpu_torch.train import checkpoint as ckpt
    from aaclip_tpu_torch.train.optim import (make_image_optimizer,
                                              make_text_optimizer)
    from aaclip_tpu_torch.train.steps import (make_stage1_step,
                                              make_stage2_step,
                                              stage1_features_fn)

    t_phase = time.perf_counter()
    cfg = get_config("ViT-L-14-336", img_size=518)
    img, n_layers, heads = (cfg.vision.image_size, cfg.vision.layers,
                            cfg.vision.heads)
    vv_layers = STAGE1_SURGERY_UNTIL - 1
    acfg = AdapterConfig()
    bf16 = DtypePolicy.bf16()
    seed = TRAIN_CLI_SEED
    tmp = tempfile.mkdtemp(prefix="aaclip_train_cli_")
    env_before = {k: os.environ.get(k) for k in ("AACLIP_DATA",
                                                 "AACLIP_METADATA")}
    launches = {}

    def run(name, argv, *, feats, steps, vv):
        """``cli.main(argv)`` with each epoch's per-step losses recorded;
        holds its launches to ``feats`` features calls and ``steps``
        stage-2 steps (under ``--remat auto``, selective on the card: 24
        forward launches per step); returns (losses per epoch,
        train.log)."""
        zero_fused_counts()
        lib0 = {n: kernels_launched(n) for n in ("attention_packed",
                                                 "attention_packed_bwd",
                                                 "fused_block")}
        t0 = time.perf_counter()
        losses = train_cli_losses(argv)
        wall = time.perf_counter() - t0
        std, vvn, bwd = counts()
        lib = {n: kernels_launched(n) - v for n, v in lib0.items()}
        others = {"attention_kernel": attention_kernel.launches,
                  "ln_linear": FB.ln_linear.launches,
                  "linear_residual": FB.linear_residual.launches,
                  "mlp_fused": FB.mlp_fused.launches}
        want = (n_layers * feats + n_layers * steps,
                vv_layers * feats if vv else 0, (n_layers - 1) * steps)
        print(f"train CLI {name}: {feats} features calls, {steps} stage-2 "
              f"steps: attention_packed {std}, V-V {vvn}, backward {bwd} "
              f"launches (want {want}); kernels counted by the libraries "
              f"{lib}; {others}; {wall:.1f} s for main()")
        expect((std, vvn, bwd) == want,
               f"train CLI {name}: launches {(std, vvn, bwd)}, not {want}")
        expect(lib == {"attention_packed": std + vvn,
                       "attention_packed_bwd": 2 * bwd, "fused_block": 0}
               and not any(others.values()),
               f"train CLI {name}: library counts {lib}, {others}")
        expect(all(np.isfinite(v).all() for v in losses),
               f"train CLI {name}: a loss is not finite")
        launches[name] = (std, vvn, bwd)
        gc.collect()
        torch.cuda.empty_cache()
        with open(os.path.join(argv[argv.index("--save_path") + 1],
                               "train.log")) as f:
            log = f.read()
        expect("remat auto: stage 1 (text tower) selective, stage 2 "
               "selective" in log, f"train CLI {name}: remat not resolved "
               f"to selective")
        return losses, log

    try:
        classes = CLASS_NAMES["MVTec"][:TRAIN_CLI_CLASSES]
        t0 = time.perf_counter()
        data_root, meta_root = make_synthetic_dataset(
            os.path.join(tmp, "synthetic"), class_names=classes,
            n_normal=TRAIN_CLI_PER_KIND, n_anomalous=TRAIN_CLI_PER_KIND,
            img_px=TRAIN_CLI_PX, hard=True)
        os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
        n_img = TRAIN_CLI_CLASSES * 2 * TRAIN_CLI_PER_KIND
        print(f"train CLI: synthetic MVTec {', '.join(classes)}: {n_img} "
              f"images of {TRAIN_CLI_PX} px written in "
              f"{time.perf_counter() - t0:.1f} s")
        text_ds, image_ds = get_train_datasets("MVTec", img, -1, seed=seed)
        check_jitter_vs_pillow([os.path.join(image_ds.spec.data_path,
                                             r.image_path)
                                for r in image_ds.records[:2]])
        n_feat = -(-n_img // 16)
        n_step = -(-n_img // 2)
        common = ["--clip_checkpoint", ckpt_path, "--dataset", "MVTec",
                  "--training_mode", "full_shot", "--precision", "bf16",
                  "--profile_input"]

        # the host path: 1 text epoch, 2 image epochs
        host = os.path.join(tmp, "host")
        losses, log = run("host run", common + [
            "--save_path", host, "--text_epoch", "1", "--image_epoch", "2"],
            feats=n_feat, steps=2 * n_step, vv=False)
        expect([len(e) for e in losses] == [n_feat, n_step, n_step],
               f"host run: {[len(e) for e in losses]} steps per epoch")
        reports = epoch_reports(log)

        # (b) each stage's first update again, on the plain attention
        vit, text = create_clip_towers(cfg, checkpoint=ckpt_path)
        plain1, plain2 = plain_first_losses(vit, text, cfg, acfg, bf16,
                                            host, text_ds, image_ds)
        r1 = abs(losses[0][0] - plain1) / abs(plain1)
        r2 = abs(losses[1][0] - plain2) / abs(plain2)
        print(f"train CLI: step-1 losses, kernels vs plain attention: "
              f"stage 1 {losses[0][0]:.6f} vs {plain1:.6f} ({r1:.3e} "
              f"relative, bar {S1_STEP_LOSS_RTOL}), stage 2 "
              f"{losses[1][0]:.6f} vs {plain2:.6f} ({r2:.3e}, bar "
              f"{STEP_LOSS_RTOL}); epoch means "
              f"{[round(float(np.mean(e)), 6) for e in losses]}")
        expect(r1 <= S1_STEP_LOSS_RTOL and r2 <= STEP_LOSS_RTOL,
               f"train CLI: step-1 losses off by {r1}, {r2}")

        # the step alone, at the CLI's batches
        gen = torch.Generator(device="cuda").manual_seed(12)
        iad = init_image_adapter(cfg, acfg, seed=1)
        s2 = make_stage2_step(vit, cfg, acfg,
                              make_image_optimizer(iad.parameters()),
                              unit_table(cfg.embed_dim, gen), policy=bf16,
                              remat="selective")
        batch = train_batch(2, img, gen)
        ms2 = cuda_ms(lambda: s2(iad, *batch), 20)
        del s2, iad
        feats_fn = stage1_features_fn(
            vit, cfg, surgery_until_layer=STAGE1_SURGERY_UNTIL, policy=bf16)
        tad = init_text_adapter(cfg, acfg, seed=2)
        s1 = make_stage1_step(text, cfg, acfg,
                              make_text_optimizer(tad.parameters()),
                              dataset_prompt_tokens("MVTec"), policy=bf16)
        images, mask, cidx, valid = stage1_batch(16, img, gen)
        ms1 = cuda_ms(lambda: s1(tad, feats_fn(images, valid), mask, cidx,
                                 valid), 5, warmup=1)
        del s1, tad, feats_fn, vit, text
        gc.collect()
        torch.cuda.empty_cache()
        print(f"train CLI: the steps alone, bf16: stage 1 (batch-mode "
              f"features + update) at batch 16 {16e3 / ms1:.2f} img/s, "
              f"stage 2 (remat selective) at batch 2 {2e3 / ms2:.2f} img/s "
              f"on {card}")

        # (c) the checkpoints load back and save again bit for bit
        for name, make, to_jax, from_jax in (
                ("text_adapter.npz", init_text_adapter, text_adapter_to_jax,
                 text_adapter_from_jax),
                ("image_adapter.npz", init_image_adapter, adapter_to_jax,
                 adapter_from_jax)):
            mod = make(cfg, acfg, seed=0)
            if name.startswith("image"):
                opt, sched = make_image_optimizer(mod.parameters())
            else:
                opt, sched = make_text_optimizer(mod.parameters()), None
            path = os.path.join(host, name)
            epoch, tree, step = ckpt.load_adapter_checkpoint(
                path, to_jax(mod))
            opt_tree = ckpt.load_optimizer_state(
                path, ckpt.adam_state_tree(opt, mod, to_jax, sched))
            with torch.no_grad():
                for p, q in zip(mod.parameters(), from_jax(
                        tree, cfg, acfg, device="cpu").parameters()):
                    p.copy_(q)
            ckpt.load_adam_state(
                opt, mod, opt_tree,
                lambda t: from_jax(t, cfg, acfg, device="cpu"), sched)
            again = os.path.join(tmp, "again_" + name)
            ckpt.save_adapter_checkpoint(
                again, epoch, to_jax(mod), step=step,
                opt_state=ckpt.adam_state_tree(opt, mod, to_jax, sched))
            with np.load(path) as a, np.load(again) as b:
                expect(sorted(a.files) == sorted(b.files) and all(
                    a[k].dtype == b[k].dtype
                    and a[k].tobytes() == b[k].tobytes() for k in a.files),
                    f"train CLI: {name} does not round-trip")
                n_up = n_feat if sched is None else 2 * n_step
                counts_ = [int(a[k]) for k in sorted(a.files)
                           if k.endswith(".count")] + [int(a["__step__"])]
                expect(counts_ == [n_up] * len(counts_)
                       and int(a["__epoch__"]) == (1 if sched is None
                                                   else 2),
                       f"train CLI: {name} counts {counts_}")
        print(f"train CLI: text_adapter.npz and image_adapter.npz load into "
              f"fresh adapters and Adam (and MultiStepLR) on the card and "
              f"save again bit for bit; counts {n_feat} and {2 * n_step}")

        # (d) resumed with --image_epoch 3
        losses3, log = run("resumed run", common + [
            "--save_path", host, "--text_epoch", "1", "--image_epoch", "3"],
            feats=0, steps=n_step, vv=False)
        expect([len(e) for e in losses3] == [n_step]
               and log.count("training image epoch 2:") == 1
               and log.count("training image epoch 1:") == 1
               and log.count("training text epoch 0:") == 1,
               "train CLI: the resumed run did not train image epoch 2 "
               "only")
        with np.load(os.path.join(host, "image_adapter_3.npz")) as a:
            got = [int(a[k]) for k in ("__epoch__", "__step__",
                                       "opt_state/0/.count",
                                       "opt_state/1/.count")]
        expect(got == [3] + [3 * n_step] * 3,
               f"train CLI: resumed checkpoint at {got}")
        reports += epoch_reports(log)[len(reports):]
        print(f"train CLI: resumed at image epoch 2 from the saved state: "
              f"epoch, step and counts {got}; loss "
              f"{np.mean(losses3[0]):.6f}")

        # (e) the evaluation CLI on what was trained
        evald = os.path.join(tmp, "eval")
        os.makedirs(evald)
        for f in ("text_adapter.npz", "image_adapter_3.npz"):
            shutil.copy(os.path.join(host, f), os.path.join(evald, f))
        zero_fused_counts()
        eval_cli.main(["--clip_checkpoint", ckpt_path, "--save_path", evald,
                       "--precision", "bf16", "--batch_size", "32", "--csv"])
        rows = read_csv(os.path.join(evald, "results_3.csv"))
        cells = [float(x) for r in rows[1:] for x in r[1:]]
        n_eval = TRAIN_CLI_CLASSES * -(-2 * TRAIN_CLI_PER_KIND // 32)
        print(f"train CLI: the evaluation CLI's table (above) on the "
              f"trained checkpoints, {n_eval} predict batches")
        expect([r[0] for r in rows[1:]] == list(classes) + ["Average"]
               and all(np.isfinite(cells)) and all(0 <= c <= 100
                                                   for c in cells),
               f"train CLI: evaluation table {rows}")
        expect(counts()[0] == n_layers * n_eval,
               f"train CLI: evaluation launched {counts()[0]}")
        gc.collect()
        torch.cuda.empty_cache()

        # the device path: one stage-2 epoch from the set on the card
        check_device_augment_vs_host(image_ds, 16)
        # unfused, fused, fused, unfused: the two in turns on one card,
        # each epoch's losses bit for bit the first's
        dev_reports = {False: [], True: []}
        dev_losses = None
        for k, fused in enumerate((False, True, True, False)):
            name = ("device run, fused assembly" if fused else "device run") \
                + f" ({k + 1} of 4)"
            losses, log = run(name, common + [
                "--save_path", os.path.join(tmp, f"device{k}"),
                "--text_epoch", "0", "--image_epoch", "1",
                "--device_augment", "--cache_device"]
                + (["--fused_assemble"] if fused else []),
                feats=0, steps=n_step, vv=False)
            expect(len(losses) == 1, f"{name}: epochs")
            expect(("on a second CUDA stream while step k runs" if fused
                    else "each batch assembles before its step") in log,
                   f"{name}: the log does not say how assembly runs")
            dev_losses = dev_losses or losses
            expect(losses == dev_losses,
                   f"{name}: the losses differ from the first device run's")
            dev_reports[fused] += epoch_reports(log)
        print(f"train CLI device path: the fused-assembly epochs' "
              f"{len(dev_losses[0])} losses equal the unfused epochs' bit "
              f"for bit")

        # the spatial V-V mode: one stage-1 epoch
        _, log = run("spatial run", common + [
            "--save_path", os.path.join(tmp, "spatial"), "--text_epoch", "1",
            "--image_epoch", "0", "--vv_mode", "spatial"],
            feats=n_feat, steps=0, vv=True)
        sp_reports = epoch_reports(log)

        for path, reps in (("host", reports),
                           ("device", dev_reports[False]),
                           ("device, fused assembly", dev_reports[True]),
                           ("host, spatial V-V", sp_reports)):
            for stage, epoch, rate, shares in reps:
                top = ", ".join(f"{k} {v:.1f}%" for k, v in sorted(
                    shares.items(), key=lambda kv: -kv[1]))
                print(f"train CLI {path} path, {stage} epoch {epoch}: "
                      f"{rate:.2f} img/s logged; host loop: {top} on "
                      f"{card}")
        print(f"train CLI: phase 10 took {time.perf_counter() - t_phase:.0f}"
              f" s")
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# The 3-pass mode of the attention kernels (fp32 under precision "high",
# fp32_high's attention; _kdot's F32_AS_3BF16 in the TPU kernels). Kernel
# vs its plain 3-pass version: both split the same fp32 operands into the
# same bf16 halves and accumulate in fp32; the summation order and the
# online rescaling (P split against the running max, not the final one)
# differ, ~1e-6 relative as in fp32, so the forward, V-V mode and B4 keep
# FP32_MAX_ABS and LSE_MAX_ABS. The backward: two 3-pass forms (the plain
# version against JAX's interpret-mode kernel) read 1.13e-5 of a
# gradient's max apart on the CPU, where dP - dsum cancels; bar 5e-5 of
# each gradient's max.
HIGH = "high"
HIGH_BWD_MAX_REL = 5e-5
# (B, S, heads, head dim, valid_len): the predict's and the step's fp32
# shape, ragged S, keys past valid_len, the wgmma tile edges' batch of 3,
# head dim 16
HIGH_CASES = [
    (TRAIN_BATCH, 1370, 16, 64, 1370),
    (2, 77, 16, 64, 77),
    (2, 257, 16, 64, 200),
    (3, 200, 16, 64, 200),
    (3, 26, 4, 16, 26),
    (2, 257, 2, 16, 257),
]


def attention_fp64(qkv, H, valid, d_out=None):
    """Softmax attention of a packed fp32 qkv in fp64, and with ``d_out``
    its d(qkv) (the exact function the kernels approximate)."""
    import torch

    B, S, width = qkv.shape
    dm = width // 3
    hd = dm // H

    def heads(t):
        return t.reshape(B, S, H, hd).transpose(1, 2).double()

    q, k, v = (heads(qkv[..., i * dm:(i + 1) * dm]) for i in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
    s[..., valid:] = float("-inf")
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, v)
    if d_out is None:
        return o.transpose(1, 2).reshape(B, S, dm)
    do = heads(d_out)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * hd ** -0.5
    dq, dk = torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q)
    return torch.cat([g.transpose(1, 2).reshape(B, S, dm)
                      for g in (dq, dk, dv)], dim=-1)


def check_kernels_3pass() -> dict:
    """Phase 3, the 3-pass mode on fp32: B1 and its logsumexp, B2 (twice
    bit for bit), B3 (and bit for bit the standard mode on [v, v, v]) and
    B4 (and bit for bit B1 on the same values packed) against their plain
    3-pass versions at HIGH_CASES; every launch counted in the wrappers'
    ``launches_3pass``; then the NaN image (check_fp64_distances gives the
    mode's distance from fp64). Returns {kernel: the largest max |d| at
    the predict's and the step's shape}."""
    import torch

    from aaclip_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(14)
    worst = {"fwd": 0.0, "bwd": 0.0, "vv": 0.0, "b4": 0.0}
    for B, S, H, hd, valid in HIGH_CASES:
        main = (B, S) == (TRAIN_BATCH, 1370)
        dm = H * hd
        qkv = random_qkv(B, S, H, hd, torch.float32, gen)
        d_out = torch.randn(B, S, dm, generator=gen, device="cuda")
        before = [w.launches_3pass for w in (A.attention_packed,
                                             A.attention_packed_bwd,
                                             A.attention_packed_vv,
                                             A.attention_kernel)]
        splits = A.split2.launches
        got, lse = A.attention_packed(qkv, H, valid, return_lse=True,
                                      precision=HIGH)
        again = A.attention_packed(qkv, H, valid, precision=HIGH)
        want = A.attention_packed_plain(qkv, H, valid, precision=HIGH)
        torch.cuda.synchronize()
        fwd = (got - want).abs().max().item()
        lse_err = lse_vs_logsumexp(qkv, H, valid, lse)
        expect(bool(torch.isfinite(got).all()) and torch.equal(got, again),
               "3-pass forward not finite or its lse output changed it")
        expect(fwd <= FP32_MAX_ABS and lse_err <= LSE_MAX_ABS,
               f"3-pass forward off: {fwd}, lse {lse_err}")
        del want
        g1 = A.attention_packed_bwd(qkv, d_out, lse, H, valid,
                                    precision=HIGH)
        g2 = A.attention_packed_bwd(qkv, d_out, lse, H, valid,
                                    precision=HIGH)
        gw = A.attention_packed_bwd_plain(qkv, d_out, H, valid,
                                          precision=HIGH)
        torch.cuda.synchronize()
        expect(torch.equal(g1, g2), "two 3-pass backward runs differ")
        expect(bool(torch.isfinite(g1).all()), "3-pass d(qkv) not finite")
        rel = []
        for i in range(3):
            sl = slice(i * dm, (i + 1) * dm)
            scale = gw[..., sl].abs().max().item()
            d = (g1[..., sl] - gw[..., sl]).abs().max().item()
            rel.append(d / scale)
            expect(d <= HIGH_BWD_MAX_REL * scale,
                   f"3-pass backward {'qkv'[i]} off: {d} of {scale}")
            if main:
                worst["bwd"] = max(worst["bwd"], d)
        if valid < S:
            expect(g1[:, valid:, dm:].abs().max().item() == 0.0,
                   "3-pass dk/dv past valid_len")
        del g1, g2, gw
        v = qkv[..., 2 * dm:].contiguous()
        gv = A.attention_packed_vv(v, H, S, precision=HIGH)
        wv = A.attention_packed_vv_plain(v, H, S, precision=HIGH)
        same_vv = torch.equal(gv, A.attention_packed(
            torch.cat([v, v, v], dim=-1).contiguous(), H, S, precision=HIGH))
        vv = (gv - wv).abs().max().item()
        del gv, wv
        heads = [qkv[..., i * dm:(i + 1) * dm].reshape(B, S, H, hd)
                 .transpose(1, 2).contiguous() for i in range(3)]
        g4 = A.attention_kernel(*heads, valid, precision=HIGH)
        w4 = A.attention_kernel_plain(*heads, valid, precision=HIGH)
        b4 = (g4 - w4).abs().max().item()
        same_b4 = torch.equal(g4.transpose(1, 2).reshape(B, S, dm)[:, :valid],
                              got[:, :valid])
        torch.cuda.synchronize()
        after = [w.launches_3pass for w in (A.attention_packed,
                                            A.attention_packed_bwd,
                                            A.attention_packed_vv,
                                            A.attention_kernel)]
        expect([a - b for a, b in zip(after, before)] == [3, 2, 1, 1],
               f"3-pass launches {before} -> {after}")
        # at head dim 64 one split2 per forward operand, two per backward:
        # 3 standard, 2 x 2 backward, 1 V-V, 3 for B4's q, k and v
        splits = A.split2.launches - splits
        expect(splits == (11 if hd == 64 else 0),
               f"3-pass split2 launches {splits}")
        expect(vv <= FP32_MAX_ABS and b4 <= FP32_MAX_ABS and same_vv
               and same_b4, f"3-pass V-V {vv} (equal to the standard mode: "
               f"{same_vv}), B4 {b4} (equal to B1: {same_b4})")
        if main:
            worst["fwd"] = max(worst["fwd"], fwd)
            worst["vv"] = max(worst["vv"], vv)
            worst["b4"] = max(worst["b4"], b4)
        print(f"3-pass kernels fp32 B={B} S={S} H={H} hd={hd} "
              f"valid={valid}: forward max|d|={fwd:.3e} (lse {lse_err:.3e});"
              f" backward dq/dk/dv {', '.join(f'{r:.2e}' for r in rel)} of "
              f"each max, two runs bit-equal; V-V {vv:.3e} (= standard "
              f"mode on [v, v, v] bit for bit); B4 {b4:.3e} (= B1 bit for "
              f"bit)")
        del qkv, d_out, lse, got, again, heads, g4, w4

    check_tail_isolation("fp32", HIGH)
    return worst


# The 6-pass route (fp32 at head dim 64 under "highest" or None, the CLIs'
# default --precision fp32). The split kernel against split3_plain bit for
# bit: both round with the card's bf16 conversion and subtract in fp32, at
# the step's qkv shape, over fp32's binades, on powers of two, near the
# largest and the smallest normals (and under the exact domain, where both
# drop the same bits), on zeros of both signs and on counts that leave a
# one-by-one tail; NaN stays NaN in every plane. The kernels' distance from
# fp64: the six passes drop terms of about 2^-24 relative, the small ones
# are summed first and each tile's sum joins the running one in fp32
# registers, so they sit at the FMA kernels' level (those read 1.2-1.9e-6
# of each output's max, the 6-pass kernels 0.6-1.0e-6, on an NVIDIA H100
# 80GB HBM3, 700 W); bar 4e-6 of each output's max. Against the plain
# fp32 versions they keep the fp32 bars (FP32_MAX_ABS, LSE_MAX_ABS,
# BWD_FP32_MAX_REL) through check_kernel and its siblings.
SIX_FP64_MAX_REL = 4e-6
# The 3-pass kernels' distance from fp64, held to what the mma.sync 3-pass
# kernels they replaced read at [2, 1370, 3072]: the largest of forward,
# V-V, B4, dq, dk, dv as a fraction of each output's max, 1.785e-5 (V-V;
# forward 1.016e-5, dq 1.441e-5, dk 1.299e-5, dv 1.245e-5), on an NVIDIA
# H100 80GB HBM3, 700 W. The redesign may come no farther from fp64. Both
# sit at the 3-pass form's own error (the dropped lo.lo and lo's rounding,
# about 2^-16 relative per product), far above the tensor cores'
# truncation of each chain's sum.
HIGH_FP64_MAX_REL = 1.8e-5


def check_split3() -> None:
    """Phase 3: ``split3`` and ``split2`` (the split kernels of the 6-pass
    and 3-pass routes) against ``split3_plain`` and ``split2_plain`` on
    the card, bit for bit, and ``split2``'s planes against planes 0 and 1
    of ``split3_plain``'s."""
    import torch

    from aaclip_tpu_torch.ops.attention import (split2, split2_plain, split3,
                                                split3_plain)

    gen = torch.Generator(device="cuda").manual_seed(16)
    wide = torch.randn(1 << 20, generator=gen, device="cuda") * torch.exp2(
        torch.randint(-120, 120, (1 << 20,), generator=gen, device="cuda")
        .float())
    pow2 = torch.exp2(torch.arange(-126, 128, device="cuda").float())
    top = torch.tensor(float.fromhex("0x1.fcp127"), device="cuda")
    near_top = top * (1 - torch.arange(256, device="cuda") * 2.0 ** -20)
    low = torch.exp2(torch.tensor(-126.0, device="cuda")) * (
        1 + torch.arange(4096, device="cuda") * 2.0 ** -12)
    special = torch.cat([pow2, near_top, low, wide[wide.abs() < top]])
    special = torch.cat([special, -special, torch.tensor([0.0, -0.0],
                                                         device="cuda")])
    cases = {"step qkv [8,1370,3072]": random_qkv(TRAIN_BATCH, 1370, 16, 64,
                                                   torch.float32, gen),
             "binades, powers of two, extreme normals, zeros": special}
    for n in (1, 7, 1001):  # the one-by-one tail
        cases[f"{n} values"] = torch.randn(n, generator=gen, device="cuda")
    def bits(t):
        return t.view(torch.int16)

    for what, x in cases.items():
        got, want = split3(x), split3_plain(x)
        got2, want2 = split2(x), split2_plain(x)
        torch.cuda.synchronize()
        same = torch.equal(bits(got), bits(want))
        same2 = torch.equal(bits(got2), bits(want2))
        first2 = torch.equal(bits(got2), bits(want[:2]))
        exact = torch.equal(got.double().sum(0), x.double())
        print(f"split3 {what} ({x.numel()} values): bit for bit the plain "
              f"version's: {same}; hi + mid + lo == x in fp64: {exact}; "
              f"split2 bit for bit its plain version's: {same2}, and "
              f"split3_plain's planes 0-1: {first2}")
        expect(same and got.shape == (3, *x.shape),
               f"split3 {what}: differs from split3_plain")
        expect(same2 and first2 and got2.shape == (2, *x.shape),
               f"split2 {what}: differs from split2_plain or split3_plain")
    for split in (split3, split2):
        nan = split(torch.full((8,), float("nan"), device="cuda"))
        expect(bool(torch.isnan(nan.float()).all()),
               f"{split.__name__}: NaN not kept")


def fp64_distances(qkv, H: int, d_out, precision) -> dict:
    """Each kernel's max |d| from fp64, as a fraction of its output's max:
    the forward, V-V (on the value section), B4 (on the heads) and the
    backward's dq, dk, dv at ``precision``."""
    import torch

    from aaclip_tpu_torch.ops import attention as A

    B, S, width = qkv.shape
    dm = width // 3
    hd = dm // H
    v = qkv[..., 2 * dm:].contiguous()
    heads = [qkv[..., i * dm:(i + 1) * dm].reshape(B, S, H, hd)
             .transpose(1, 2).contiguous() for i in range(3)]
    out, lse = A.attention_packed(qkv, H, S, return_lse=True,
                                  precision=precision)
    got = {"forward": out,
           "V-V": A.attention_packed_vv(v, H, S, precision=precision),
           "B4": A.attention_kernel(*heads, S, precision=precision)
           .transpose(1, 2).reshape(B, S, dm)}
    g = A.attention_packed_bwd(qkv, d_out, lse, H, S, precision=precision)
    exact = attention_fp64(qkv, H, S)
    exact_vv = attention_fp64(torch.cat([v, v, v], dim=-1), H, S)
    exact_g = attention_fp64(qkv, H, S, d_out)
    want = {"forward": exact, "V-V": exact_vv, "B4": exact}
    for i, name in enumerate(("dq", "dk", "dv")):
        got[name] = g[..., i * dm:(i + 1) * dm]
        want[name] = exact_g[..., i * dm:(i + 1) * dm]
    return {name: ((got[name].double() - want[name]).abs().max()
                   / want[name].abs().max()).item() for name in got}


def check_fp64_distances() -> None:
    """Phase 3: each fp32 route's distance from fp64 at [2, 1370, 3072]
    (the 6-pass kernels, held to SIX_FP64_MAX_REL, and the 3-pass ones,
    held to HIGH_FP64_MAX_REL), beside the head-dim-16 FMA kernels' at
    [2, 1370, 768]."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(17)
    for mode, hd, prec in (("6-pass", 64, None), ("3-pass", 64, HIGH),
                           ("FMA, head dim 16,", 16, None)):
        qkv = random_qkv(2, 1370, 16, hd, torch.float32, gen)
        d_out = torch.randn(2, 1370, 16 * hd, generator=gen, device="cuda")
        errs = fp64_distances(qkv, 16, d_out, prec)
        print(f"distance from fp64 {list(qkv.shape)}, {mode} kernels: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + " of each output's max")
        if mode == "6-pass":
            expect(max(errs.values()) <= SIX_FP64_MAX_REL,
                   f"6-pass kernels off fp64: {errs}")
        if mode == "3-pass":
            expect(max(errs.values()) <= HIGH_FP64_MAX_REL,
                   f"3-pass kernels off fp64: {errs}")



H100_FP32_FMA_FLOPS = 67e12  # fp32 outside the tensor cores, data sheet


def time_kernels_fp32(card) -> dict:
    """Phase 11f: CUDA-event times of the fp32 attention kernels on the
    same fp32 inputs (TF32 off), at the predict's and the step's batch 8
    (B1, B2, B4) and the stage-1 bench's batch 16 (B3): each 3-pass kernel
    (precision "high") beside its plain 3-pass version, each 6-pass kernel
    (precision None: ``split3`` and the kernel, as a call runs them) beside
    the plain fp32 version, SDPA (its backward for B2), and ``split3`` and
    ``split2`` alone on the step's qkv (the inputs stay alive:
    check_device_ops calls the timed functions again). Each kernel of
    either mode is timed with its splits, as a call runs them. Returns
    {"3pass": {kernel: (ms, plain ms, SDPA ms, bound ms, bound_by, kernels
    per call)}, "6pass": {...}, "split3": (...), "split2": (...), SDPA
    None}. The bounds: the 3-pass rows three bf16 passes and the 6-pass
    rows six of the TPU kernel's products."""
    import torch

    from aaclip_tpu_torch.ops import attention as A

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, H, hd = TRAIN_BATCH, 1370, 16, 64
    dm = H * hd
    gen = torch.Generator(device="cuda").manual_seed(15)
    out = {"3pass": {}, "6pass": {}}
    fwd_lib, bwd_libs = "attention_packed", ("attention_packed",
                                             "attention_packed_bwd")

    def report(name, shape, call, plain3, plain, ms_sdpa, flops, nbytes,
               iters, libs, want3, want6):
        """Time ``call(precision)`` under "high" and None; ``plain3`` and
        ``plain`` are the two plain versions."""
        k3, k6 = (functools.partial(call, p) for p in (HIGH, None))
        ms3, ms6 = cuda_ms(k3, iters), cuda_ms(k6, iters)
        per3 = kernels_per_call(k3, libs, want3, f"{name} 3-pass")
        per6 = kernels_per_call(k6, libs, want6, f"{name} 6-pass")
        ms_p3, ms_p = cuda_ms(plain3, 2, warmup=1), cuda_ms(plain, 2,
                                                            warmup=1)
        for mode, passes, ms, ms_plain, per in (
                ("3pass", 3, ms3, ms_p3, per3), ("6pass", 6, ms6, ms_p, per6)):
            bound_ms, bound_by = bound(passes * flops, nbytes)
            out[mode][name] = (ms, ms_plain, ms_sdpa, bound_ms, bound_by,
                               per)
            print(f"time {name} {mode} kernel {shape} fp32: {ms:.4f} ms/call "
                  f"({passes * flops / ms / 1e9:.1f} TFLOP/s of the {passes} "
                  f"bf16 passes; bound {bound_ms:.4f} ms by {bound_by}, one "
                  f"fp32 pass at the FMA rate "
                  f"{flops / H100_FP32_FMA_FLOPS * 1e3:.4f} ms); its plain "
                  f"version {ms_plain:.4f} ms on {card}")
        print(f"time {name} SDPA fp32 {shape}: {ms_sdpa:.4f} ms/call on "
              f"{card}")

    qkv = random_qkv(B, S, H, hd, torch.float32, gen)
    q, k, v = qkv.view(B, S, 3, H, hd).permute(2, 0, 3, 1, 4).unbind(0)
    report("attention_packed", f"[{B},{S},{3 * dm}]",
           lambda p: A.attention_packed(qkv, H, S, precision=p),
           lambda: A.attention_packed_plain(qkv, H, S, precision=HIGH),
           lambda: A.attention_packed_plain(qkv, H, S),
           cuda_ms(lambda: sdpa(q, k, v), 5),
           4 * B * H * S * S * hd, 4 * B * S * dm * 4, 10, fwd_lib,
           {"split2_kernel": 1, "attn_fwd_3pass_wgmma": 1},
           {"split3_kernel": 1, "attn_fwd_6pass": 1})

    for name, planes in (("split3", 3), ("split2", 2)):
        split = functools.partial(getattr(A, name), qkv)
        plain = functools.partial(getattr(A, f"{name}_plain"), qkv)
        ms = cuda_ms(split, 20)
        per_call = kernels_per_call(split, fwd_lib, {f"{name}_kernel": 1},
                                    name)
        ms_plain = cuda_ms(plain, 5)
        nbytes = qkv.numel() * (4 + planes * 2)  # fp32 in, bf16 planes out
        bound_ms, bound_by = bound(0, nbytes)
        out[name] = (ms, ms_plain, None, bound_ms, bound_by, per_call)
        print(f"time {name} [{B},{S},{3 * dm}] fp32: {ms:.4f} ms/call "
              f"({nbytes / ms / 1e9:.1f} TB/s; bound {bound_ms:.4f} ms by "
              f"{bound_by}); its plain version {ms_plain:.4f} ms on {card}")

    d_out = torch.randn(B, S, dm, generator=gen, device="cuda")
    lse = {p: A.attention_packed(qkv, H, S, return_lse=True,
                                 precision=p)[1] for p in (HIGH, None)}
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    o = sdpa(qg, kg, vg)
    g = d_out.view(B, S, H, hd).transpose(1, 2)
    report("attention_packed_bwd", f"[{B},{S},{3 * dm}]",
           lambda p: A.attention_packed_bwd(qkv, d_out, lse[p], H, S,
                                            precision=p),
           lambda: A.attention_packed_bwd_plain(qkv, d_out, H, S,
                                                precision=HIGH),
           lambda: A.attention_packed_bwd_plain(qkv, d_out, H, S),
           cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), g,
                                               retain_graph=True), 5),
           10 * B * H * S * S * hd,
           (2 * qkv.numel() + d_out.numel() + B * H * S) * 4, 5, bwd_libs,
           {"split2_kernel": 2, "attn_bwd_dq_3pass_wgmma": 1,
            "attn_bwd_dkdv_3pass_wgmma": 1},
           {"split3_kernel": 2, "attn_bwd_dq_6pass": 1,
            "attn_bwd_dkdv_6pass": 1})

    heads = [t.contiguous() for t in (q, k, v)]
    report("attention_kernel", f"[{B},{H},{S},{hd}]",
           lambda p: A.attention_kernel(*heads, S, precision=p),
           lambda: A.attention_kernel_plain(*heads, S, precision=HIGH),
           lambda: A.attention_kernel_plain(*heads, S),
           cuda_ms(lambda: sdpa(*heads), 5),
           4 * B * H * S * S * hd, 4 * B * S * dm * 4, 10, fwd_lib,
           {"split2_kernel": 3, "attn_fwd_3pass_wgmma": 1},
           {"split3_kernel": 3, "attn_fwd_6pass": 1})

    B = STAGE1_BATCH
    v = torch.randn(B, S, dm, generator=gen, device="cuda")
    qv = v.view(B, S, H, hd).transpose(1, 2)
    report("attention_packed_vv", f"[{B},{S},{dm}]",
           lambda p: A.attention_packed_vv(v, H, S, precision=p),
           lambda: A.attention_packed_vv_plain(v, H, S, precision=HIGH),
           lambda: A.attention_packed_vv_plain(v, H, S),
           cuda_ms(lambda: sdpa(qv, qv, qv), 5),
           4 * B * H * S * S * hd, 2 * v.numel() * 4, 10, fwd_lib,
           {"split2_kernel": 1, "attn_fwd_3pass_wgmma": 1},
           {"split3_kernel": 1, "attn_fwd_6pass": 1})
    return out


# Phase 11, fp32_high at ViT-L/14-336 @ 518. (a) the predict, against the
# same predictor with the plain 3-pass attention (the staged blocks keep
# the bf16 kernel on both sides, so the 3-pass kernel is what differs):
# phase 4's fp32 bars. (b) the stage-2 step at batch 2 with remat against
# the plain-attention step: phase 5's bars. (c) spatial stage-1 features
# at batch 2 against both attentions plain: phase 7's bars. (d) the
# evaluation CLI's scores bit for bit against a direct predict, on one
# class of phase 9's set (48 images at 1024 px) and phase 9's checkpoint,
# (e) the training CLI's step-1 losses against the plain attention on
# phase 10's set: phase 10's bars.


def phase_fp32_high(vit, adapter, cfg, acfg, anchors, M, card,
                    ckpt_path: str) -> dict:
    """Phase 11; returns the 3-pass launches per path and the kernels'
    times for the kernel line."""
    import dataclasses
    import gc
    import os

    import numpy as np
    import torch

    from aaclip_tpu_torch import test as eval_cli
    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              init_image_adapter)
    from aaclip_tpu_torch.data.datasets import (BatchLoader,
                                                get_test_datasets,
                                                get_train_datasets)
    from aaclip_tpu_torch.data.registry import CLASS_NAMES
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                               make_predict_fn,
                                               run_class_predictions)
    from aaclip_tpu_torch.ops import attention as A
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors
    from aaclip_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    heads, img, n_layers = cfg.vision.heads, cfg.vision.image_size, \
        cfg.vision.layers
    high = DtypePolicy.fp32_high()
    fp32 = DtypePolicy.fp32()
    staged = high.bf16_until
    gen = torch.Generator(device="cuda").manual_seed(13)
    # 3-pass launches per call on each path, by wrapper (and split2's)
    calls = {"attention_packed": {}, "attention_packed_bwd": {},
             "attention_packed_vv": {}, "attention_kernel": {}, "split2": {}}
    rates = {}

    # (a) the predict at batch 8, staged and unstaged
    images = torch.randn(TRAIN_BATCH, 3, img, img, generator=gen,
                         device="cuda")
    exact = make_predict_fn(vit, cfg, acfg, policy=fp32)
    pix32, score32, _ = run_predict(exact, adapter, images, anchors, M)
    span32 = (pix32.max() - pix32.min()).item()
    rates["fp32"] = TRAIN_BATCH / cuda_ms(
        lambda: exact(adapter, images, anchors, M), 3, warmup=1) * 1e3
    # 5 calls: run_predict's, a warm-up and 3 timed
    expect(counts() == (5 * n_layers, 0, 0),
           f"timed fp32 predict launches {counts()}")
    expect_6pass(counts(), "timed fp32 predict, 5 calls")
    del exact
    for K in (staged, 0):
        pol = dataclasses.replace(high, bf16_until=K)
        kernel = make_predict_fn(vit, cfg, acfg, policy=pol)
        plain = make_predict_fn(
            vit, cfg, acfg, policy=pol,
            attn_fn=make_attn_fn_plain(heads, pol))
        zero_counts()
        pix_k, score_k = kernel(adapter, images, anchors, M)
        torch.cuda.synchronize()
        n, n3 = A.attention_packed.launches, A.attention_packed.launches_3pass
        n_split = A.split2.launches
        zero_counts()
        pix_p, score_p = plain(adapter, images, anchors, M)
        torch.cuda.synchronize()
        p, p3 = A.attention_packed.launches, A.attention_packed.launches_3pass
        what = f"predict fp32_high bf16_until {K} B={TRAIN_BATCH}"
        print(f"{what}: launches {n - n3} bf16 + {n3} 3-pass per call "
              f"(plain-attention predictor: {p - p3} bf16 + {p3} 3-pass); "
              f"max|d map| vs plain {(pix_k - pix_p).abs().max().item():.3e}"
              f", max|d score| {(score_k - score_p).abs().max().item():.3e};"
              f" from the fp32 predict on the same images: max|d map| "
              f"{(pix_k - pix32).abs().max().item() / span32:.3e} of its "
              f"span {span32:.4f}, max|d score| "
              f"{(score_k - score32).abs().max().item():.3e}")
        expect(pix_k.shape == (TRAIN_BATCH, img, img)
               and bool(torch.isfinite(pix_k).all()
                        and torch.isfinite(score_k).all()),
               f"{what}: output {pix_k.shape} not finite")
        expect((n, n3, p, p3) == (n_layers, n_layers - K, K, 0)
               and n_split == n3,
               f"{what}: launches {n}, {n3} (plain {p}, {p3}), split2 "
               f"{n_split}")
        torch.testing.assert_close(pix_k, pix_p, atol=PIX_ATOL_FP32,
                                   rtol=PIX_RTOL_FP32)
        torch.testing.assert_close(score_k, score_p, atol=SCORE_ATOL_FP32,
                                   rtol=0)
        calls["attention_packed"][f"fp32_high predict, bf16_until {K}"] = n3
        calls["split2"][f"fp32_high predict, bf16_until {K}"] = n_split
        rates[f"fp32_high, bf16_until {K}"] = TRAIN_BATCH / cuda_ms(
            lambda: kernel(adapter, images, anchors, M), 3, warmup=1) * 1e3
        del kernel, plain, pix_k, pix_p
    for name, r in rates.items():
        print(f"time predict {name} B={TRAIN_BATCH} ViT-L/518: {r:.2f} "
              f"maps/s on {card}")
    del images, pix32

    # (b) the stage-2 step at batch 2 with remat, kernel vs plain
    table = unit_table(cfg.embed_dim, gen)
    what = "train fp32_high B=2 remat"

    def all_3pass(c):
        # one split2 per forward, two per backward, all at head dim 64
        splits = A.split2.launches
        expect(counts_3pass() == c and splits == c[0] + c[1] + 2 * c[2],
               f"{what}: 3-pass launches {counts_3pass()} of {c}, split2 "
               f"{splits}")
        calls["split2"][what] = splits

    fwd, _, bwd = check_step_vs_plain(vit, cfg, acfg, adapter,
                                      train_batch(2, img, gen), table, high,
                                      what, all_3pass)
    expect((fwd, bwd) == (S2_FWD_PER_STEP_REMAT, n_layers - 1),
           f"fp32_high step launches {fwd}, {bwd}")
    calls["attention_packed"]["fp32_high stage-2 step (remat)"] = fwd
    calls["attention_packed_bwd"]["fp32_high stage-2 step (remat)"] = bwd
    batch8 = train_batch(TRAIN_BATCH, img, gen)
    for name, pol in (("fp32_high", high), ("fp32", fp32)):
        zero_counts()
        _, _, _, _, (ad, opt, sched, step) = train_step_once(
            vit, cfg, acfg, adapter, batch8, table, policy=pol, remat=False)
        ms = cuda_ms(lambda: step(ad, *batch8), 3, warmup=1)
        if name == "fp32":  # 5 steps: the first, a warm-up and 3 timed
            expect(counts() == (5 * n_layers, 0, 5 * (n_layers - 1)),
                   f"timed fp32 step launches {counts()}")
            expect_6pass(counts(), "timed fp32 stage-2 step, 5 steps")
        rates[f"stage-2 {name}"] = TRAIN_BATCH / ms * 1e3
        print(f"time train step {name} B={TRAIN_BATCH} ViT-L/518 no remat: "
              f"{ms:.2f} ms/step, {rates[f'stage-2 {name}']:.2f} images/s "
              f"on {card}")
        del ad, opt, sched, step
        gc.collect()
        torch.cuda.empty_cache()
    del batch8

    # (c) spatial stage-1 features at batch 2
    what = "stage-1 spatial features fp32_high B=2"
    k3 = check_features_vs_plain(vit, cfg, high, stage1_batch(2, img, gen)[0],
                                 what, all_3pass)
    expect(k3 == (n_layers, STAGE1_SURGERY_UNTIL - 1, 0),
           f"fp32_high features launches {k3}")
    calls["attention_packed"]["fp32_high stage-1 spatial features"] = k3[0]
    calls["attention_packed_vv"]["fp32_high stage-1 spatial features"] = \
        k3[1]

    # (d) the evaluation CLI, one class, against a direct predict
    tmp = tempfile.mkdtemp(prefix="aaclip_fp32_high_")
    env_before = {k: os.environ.get(k) for k in ("AACLIP_DATA",
                                                 "AACLIP_METADATA")}
    try:
        data_root, meta_root = make_synthetic_dataset(
            os.path.join(tmp, "eval_set"), class_names=["bottle"],
            n_normal=EVAL_NORMAL, n_anomalous=EVAL_ANOMALOUS,
            img_px=EVAL_PX, hard=True)
        os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
        ad_tree = adapter_to_jax(init_image_adapter(cfg, acfg, seed=9,
                                                    device="cpu"))
        save = os.path.join(tmp, "eval")
        ckpt.save_adapter_checkpoint(
            os.path.join(save, "image_adapter_1.npz"), 1, ad_tree)
        zero_fused_counts()
        eval_cli.main(["--clip_checkpoint", ckpt_path, "--save_path", save,
                       "--precision", "fp32_high", "--batch_size",
                       str(TRAIN_BATCH), "--dump_scores"])
        n_batches = -(-(EVAL_NORMAL + EVAL_ANOMALOUS) // TRAIN_BATCH)
        std, std3 = A.attention_packed.launches, \
            A.attention_packed.launches_3pass
        expect((std, std3, A.split2.launches)
               == (n_layers * n_batches, (n_layers - staged) * n_batches,
                   (n_layers - staged) * n_batches),
               f"eval CLI fp32_high launches {std}, {std3}, split2 "
               f"{A.split2.launches}")
        calls["split2"]["fp32_high evaluation CLI"] = A.split2.launches
        vit_l, text = create_clip_towers(cfg, checkpoint=ckpt_path)
        direct = make_predict_fn(vit_l, cfg, acfg, policy=high)
        cls_anchors = encode_dataset_anchors(make_anchor_encoder(
            text, cfg, acfg, policy=high), "MVTec")["bottle"]
        ds = get_test_datasets("MVTec", img)["bottle"]
        got = run_class_predictions(direct, adapter_from_jax(
            ad_tree, cfg, acfg), list(BatchLoader(ds, TRAIN_BATCH)),
            cls_anchors, "Industrial", img, cfg.vision.grid)
        rows = read_csv(os.path.join(save, "scores_1.csv"))[1:]
        expect([r[1] for r in rows] == got[4]
               and [float(r[3]) for r in rows] == [float(x) for x in got[3]],
               "eval CLI fp32_high: scores differ from the direct predict")
        print(f"eval CLI fp32_high B={TRAIN_BATCH}: {n_batches} batches, "
              f"{std - std3} bf16 + {std3} 3-pass launches; the CLI's "
              f"scores equal the direct predict's bit for bit")
        calls["attention_packed"]["fp32_high evaluation CLI"] = std3
        del vit_l, text, direct
        gc.collect()
        torch.cuda.empty_cache()

        # (e) the training CLI, one text and one image epoch
        data_root, meta_root = make_synthetic_dataset(
            os.path.join(tmp, "train_set"),
            class_names=CLASS_NAMES["MVTec"][:TRAIN_CLI_CLASSES],
            n_normal=TRAIN_CLI_PER_KIND, n_anomalous=TRAIN_CLI_PER_KIND,
            img_px=TRAIN_CLI_PX, hard=True)
        os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
        train_dir = os.path.join(tmp, "train")
        n_img = TRAIN_CLI_CLASSES * 2 * TRAIN_CLI_PER_KIND
        zero_fused_counts()
        losses = train_cli_losses([
            "--clip_checkpoint", ckpt_path, "--dataset", "MVTec",
            "--training_mode", "full_shot", "--precision", "fp32_high",
            "--save_path", train_dir, "--text_epoch", "1",
            "--image_epoch", "1"])
        n_feat, n_step = -(-n_img // STAGE1_BATCH), -(-n_img // 2)
        got_counts, got3 = counts(), counts_3pass()
        calls["split2"]["fp32_high training CLI"] = A.split2.launches
        # no path runs B4: its 3-pass count, zeroed with the others
        calls["attention_kernel"]["fp32_high training CLI"] = \
            A.attention_kernel.launches_3pass
        expect(A.attention_kernel.launches == 0,
               "the training CLI launched attention_kernel")
        # --remat auto: selective on the card, 24 forward launches a step
        want = (n_layers * n_feat + n_layers * n_step, 0,
                (n_layers - 1) * n_step)
        want_split = want[0] + want[1] + 2 * want[2]
        expect([len(e) for e in losses] == [n_feat, n_step]
               and all(np.isfinite(v).all() for v in losses)
               and got_counts == got3 == want
               and calls["split2"]["fp32_high training CLI"] == want_split,
               f"train CLI fp32_high: {[len(e) for e in losses]} steps, "
               f"launches {got_counts} (3-pass {got3}), not {want}; split2 "
               f"{calls['split2']['fp32_high training CLI']} of {want_split}")
        vit_l, text = create_clip_towers(cfg, checkpoint=ckpt_path)
        text_ds, image_ds = get_train_datasets("MVTec", img, -1,
                                               seed=TRAIN_CLI_SEED)
        plain1, plain2 = plain_first_losses(vit_l, text, cfg, acfg, high,
                                            train_dir, text_ds, image_ds)
        r1 = abs(losses[0][0] - plain1) / abs(plain1)
        r2 = abs(losses[1][0] - plain2) / abs(plain2)
        print(f"train CLI fp32_high: {n_img} images, {n_feat} features "
              f"calls and {n_step} stage-2 steps, launches {got_counts} all "
              f"3-pass; step-1 losses vs plain attention: stage 1 "
              f"{losses[0][0]:.6f} vs {plain1:.6f} ({r1:.3e}), stage 2 "
              f"{losses[1][0]:.6f} vs {plain2:.6f} ({r2:.3e})")
        expect(r1 <= S1_STEP_LOSS_RTOL and r2 <= STEP_LOSS_RTOL,
               f"train CLI fp32_high: step-1 losses off by {r1}, {r2}")
        calls["attention_packed"]["fp32_high training CLI"] = got3[0]
        calls["attention_packed_bwd"]["fp32_high training CLI"] = got3[2]
        del vit_l, text
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)

    print(f"phase 11 (fp32_high) took {time.perf_counter() - t_phase:.0f} s")
    return {"calls": calls, "rates": rates}


# Phase 12, serving and the memory bank at ViT-L-14-336 @ 518, bf16, uint8
# inputs, after phase 11. (a) The memory bank on the weights of phases 4-8:
# 4 seeded support images, a test batch of 8; the mb predict at
# bank_weight 0 against make_predict_fn bit for bit (the same ops in the
# same order, and 0 * q_bank adds +0); at 0.5 against the same predictor
# on the plain attention (its bank from plain features): scores at phase
# 4's bar, the map at MB_PIX_SPAN_FRAC, twice phase 4's: the bank term
# 50 (1 - max cos) per level carries two feature deviations, the test
# image's and the bank's, where the text term carries one (read on an
# NVIDIA H100 80GB HBM3, 700 W: 1.044e-2 and 1.115e-2 of the span, the
# banks' features 2.5e-3 apart; phase 4's text-only map 9.1e-3 in the same
# run);
# each support image's own patches against its bank below MB_SELF_MAX
# (unit fp32 vectors against themselves: |1 - x.x| is a few fp32 ulps per
# level, times 50 per level, summed over 4; read on an NVIDIA H100 80GB
# HBM3, 700 W: 1.401e-4, so the CPU test's bar 1e-3 stands at 7x it); 24
# B1 launches per features batch and per mb predict. (b) The evaluation CLI
# with --memory_bank --shot 4 from phase 9's checkpoint on phase 9's first
# class (regenerated: the same seed draws the same images), its scores bit
# for bit against a direct mb predict of the same images and bank. (c) The
# serving engine from phase 9's checkpoint and a trained-looking adapter
# directory (npz image and text adapters), max_batch 8, the anchor cache in
# a temporary directory; a second engine on the same cache reads it (no
# text forward) and gives bit-equal anchors; 8 concurrent PNG /predict
# requests over 3 classes (one f16, one u8, one map_stride 2) held against
# a direct call of the engine's make_predict_fn at batch 8 on the same
# decoded images and anchors at phase 4's bars, plus each encoding's own
# rounding (JSON 5e-5, f16 half an ulp, u8 half its scale); a stride-2 map
# against the same image's full map sliced, exactly (both served alone,
# bucket 1); B1's launches 24 x (the batches /statz counts + the 4
# warm-up buckets). (d) ``python -m aaclip_tpu_torch.bench --mode serve``
# in-process: closed loop, 8 clients of SERVE_CLOSED_REQUESTS requests each
# (``--steps`` counts a closed-loop client's requests, as in JAX's bench:
# exactly 8 x that many served); open loop at half that rate, 10 s; the
# closed loop again with --map_stride 4; no error in any.
MB_SUPPORT, MB_BATCH, MB_SHOT = 4, 8, 4
MB_SELF_MAX = 1e-3
MB_PIX_SPAN_FRAC = 2 * PIX_SPAN_FRAC_BF16
SERVE_CLASSES = ("bottle", "cable", "capsule")
SERVE_REQUESTS, SERVE_PNG_PX, SERVE_SECONDS = 8, 700, 10
SERVE_CLOSED_REQUESTS = 100  # per client: ~6 s at ~130 maps/s
WARMUP_BUCKETS = 4  # 1, 2, 4, 8 at max_batch 8


def check_memory_bank(vit, adapter, cfg, acfg, anchors, M, gen,
                      what: str) -> dict:
    """Phase 12a's checks, at any tower (launches counted by the blocks up
    to the last tap, ``max(acfg.levels)``): MB_SUPPORT seeded support
    images' bank, its shape and B1 launches a features batch; the banked
    predict (MB_BATCH seeded images) at weight 0 bit for bit the predict,
    at 0.5 against the plain attention's within MB_PIX_SPAN_FRAC of the
    span and SCORE_ATOL_BF16 (the plain predictor launching nothing); the
    support images against their own bank below MB_SELF_MAX. Returns the
    predict, the 0.5 predictor, the images, the bank and the launches per
    features batch and per banked predict."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.eval import memory_bank as mb
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.ops.attention import attention_packed

    heads, img = cfg.vision.heads, cfg.vision.image_size
    depth, L = max(acfg.levels), cfg.vision.grid ** 2
    bf16 = DtypePolicy.bf16()
    kw = dict(policy=bf16, uint8_inputs=True)
    plain = make_predict_fn(vit, cfg, acfg, **kw)
    mb0 = mb.make_mb_predict_fn(vit, cfg, acfg, bank_weight=0.0, **kw)
    mb5 = mb.make_mb_predict_fn(vit, cfg, acfg, bank_weight=0.5, **kw)
    mb5_plain = mb.make_mb_predict_fn(
        vit, cfg, acfg, bank_weight=0.5,
        attn_fn=make_attn_fn_plain(heads, bf16), **kw)
    support = torch.randint(0, 256, (MB_SUPPORT, 3, img, img), generator=gen,
                            device="cuda", dtype=torch.uint8)
    test = torch.randint(0, 256, (MB_BATCH, 3, img, img), generator=gen,
                         device="cuda", dtype=torch.uint8)

    zero_counts()
    bank = mb.collect_bank(mb5.features_fn, adapter, support,
                           batch_size=MB_SUPPORT)
    torch.cuda.synchronize()
    feat_launches = attention_packed.launches
    expect(feat_launches == depth,
           f"{what} bank features: {feat_launches} B1 launches, not {depth}")
    expect(tuple(bank.shape) == (len(acfg.levels), MB_SUPPORT * L,
                                 cfg.embed_dim),
           f"{what} bank shape {tuple(bank.shape)}")

    # 1. bank_weight 0: the plain predict's output, bit for bit
    pix0, s0 = plain(adapter, test, anchors, M)
    pix_w0, s_w0 = mb0(adapter, test, anchors, M, bank)
    same = bool(torch.equal(pix0, pix_w0) and torch.equal(s0, s_w0))
    print(f"{what} mb predict bank_weight 0 vs make_predict_fn B={MB_BATCH}:"
          f" bit for bit {same} (max|d map| "
          f"{(pix0 - pix_w0).abs().max().item():.3e})")
    expect(same, f"{what} mb predict at bank_weight 0 differs from the "
           f"predict")

    # 2. bank_weight 0.5, kernel against the plain attention
    zero_counts()
    pix_k, s_k = mb5(adapter, test, anchors, M, bank)
    torch.cuda.synchronize()
    mb_launches = attention_packed.launches
    expect(mb_launches == depth,
           f"{what} mb predict: {mb_launches} B1 launches, not {depth}")
    bank_p = mb.collect_bank(mb5_plain.features_fn, adapter, support,
                             batch_size=MB_SUPPORT)
    pix_p, s_p = mb5_plain(adapter, test, anchors, M, bank_p)
    expect(attention_packed.launches == depth,
           f"{what}: the plain-attention mb predictor launched the kernel")
    expect(bool(torch.isfinite(pix_k).all() and torch.isfinite(s_k).all()),
           f"{what} mb predict output not finite")
    span = (pix_p.max() - pix_p.min()).item()
    dpix = (pix_k - pix_p).abs().max().item()
    dscore = (s_k - s_p).abs().max().item()
    print(f"{what} mb predict bank_weight 0.5 B={MB_BATCH}, kernel vs plain "
          f"attention: map span {span:.4f}, max|d map| {dpix:.3e} "
          f"({dpix / span:.3e} of span, bar {MB_PIX_SPAN_FRAC}), "
          f"max|d score| {dscore:.3e} (bar {SCORE_ATOL_BF16}); bank "
          f"max|d| {(bank - bank_p).abs().max().item():.3e}")
    expect(dpix <= MB_PIX_SPAN_FRAC * span, f"{what} mb map off: {dpix}")
    expect(dscore <= SCORE_ATOL_BF16, f"{what} mb scores off: {dscore}")
    del bank_p, pix_p, pix_w0, pix0, mb0, mb5_plain

    # 3. the support images against their own bank
    seg, _ = mb5.features_fn(adapter, support)
    self_max = mb.bank_grid_scores(seg, bank).abs().max().item()
    print(f"{what} memory bank: support images against their own bank, max "
          f"score {self_max:.3e} (bar {MB_SELF_MAX})")
    expect(self_max < MB_SELF_MAX, f"{what} self-support score {self_max}")
    return {"plain": plain, "mb5": mb5, "support": support, "test": test,
            "bank": bank, "feat": feat_launches, "mb": mb_launches}


def phase_memory_bank(vit, adapter, cfg, acfg, anchors, M, card, gen):
    """Phase 12a; returns the plain predict's maps/s at batch 8 and 32 and
    the launches per features batch and per mb predict."""
    import torch

    from aaclip_tpu_torch.eval import memory_bank as mb

    img = cfg.vision.image_size
    r = check_memory_bank(vit, adapter, cfg, acfg, anchors, M, gen,
                          "ViT-L")
    plain, mb5, support, test, bank = (r[k] for k in (
        "plain", "mb5", "support", "test", "bank"))
    feat_launches, mb_launches = r["feat"], r["mb"]
    bank_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        mb.collect_bank(mb5.features_fn, adapter, support,
                        batch_size=MB_SUPPORT)
        torch.cuda.synchronize()
        bank_s.append(time.perf_counter() - t0)

    # rates in one call: the plain predict at 8 and 32, the mb predict
    ms_plain = cuda_ms(lambda: plain(adapter, test, anchors, M), 10)
    ms_mb = cuda_ms(lambda: mb5(adapter, test, anchors, M, bank), 10)
    test32 = torch.randint(0, 256, (32, 3, img, img), generator=gen,
                           device="cuda", dtype=torch.uint8)
    ms_plain32 = cuda_ms(lambda: plain(adapter, test32, anchors, M), 5)
    rates = {"predict B=8": MB_BATCH * 1e3 / ms_plain,
             "mb predict B=8": MB_BATCH * 1e3 / ms_mb,
             "predict B=32": 32 * 1e3 / ms_plain32}
    # the serving engine's smaller buckets: what a lightly loaded server's
    # batches cost
    ms_small = {b: cuda_ms(lambda b=b: plain(adapter, test[:b], anchors, M),
                           10) for b in (1, 2, 4)}
    print("predict bf16 ms per call by bucket: "
          + ", ".join(f"B={b} {ms:.2f}" for b, ms in ms_small.items())
          + f", B={MB_BATCH} {ms_plain:.2f}, B=32 {ms_plain32:.2f} on {card}")
    print(f"memory bank ({MB_SUPPORT}-shot, bank [{bank.shape[0]}, "
          f"{bank.shape[1]}, {bank.shape[2]}] fp32, chunk 1024): mb predict "
          f"{rates['mb predict B=8']:.2f} maps/s against the predict's "
          f"{rates['predict B=8']:.2f} at B={MB_BATCH} "
          f"({ms_mb / ms_plain:.3f}x the time), predict "
          f"{rates['predict B=32']:.2f} maps/s at B=32; bank build "
          f"{', '.join(f'{t:.3f}' for t in bank_s)} s on {card}")
    del plain, mb5, bank, test32, r
    return rates, feat_launches, mb_launches


def phase_mb_eval_cli(card, ckpt_path: str) -> int:
    """Phase 12b; returns the CLI's B1 launches."""
    import gc
    import os

    import torch

    from aaclip_tpu_torch import test as eval_cli
    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              init_image_adapter)
    from aaclip_tpu_torch.data.datasets import BatchLoader, get_test_datasets
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.eval import memory_bank as mb
    from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                               run_class_predictions)
    from aaclip_tpu_torch.ops.attention import attention_packed
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors
    from aaclip_tpu_torch.train import checkpoint as ckpt

    cfg = get_config("ViT-L-14-336", img_size=518)
    img, n_layers = cfg.vision.image_size, cfg.vision.layers
    acfg = AdapterConfig()
    bf16 = DtypePolicy.bf16()
    B = 32
    tmp = tempfile.mkdtemp(prefix="aaclip_mb_cli_")
    env_before = {k: os.environ.get(k) for k in ("AACLIP_DATA",
                                                 "AACLIP_METADATA")}
    try:
        data_root, meta_root = make_synthetic_dataset(
            os.path.join(tmp, "eval_set"), class_names=["bottle"],
            n_normal=EVAL_NORMAL, n_anomalous=EVAL_ANOMALOUS,
            img_px=EVAL_PX, hard=True)
        os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
        ad_tree = adapter_to_jax(init_image_adapter(cfg, acfg, seed=9,
                                                    device="cpu"))
        save = os.path.join(tmp, "eval")
        ckpt.save_adapter_checkpoint(
            os.path.join(save, "image_adapter_1.npz"), 1, ad_tree)
        zero_counts()
        t0 = time.perf_counter()
        eval_cli.main(["--clip_checkpoint", ckpt_path, "--save_path", save,
                       "--precision", "bf16", "--batch_size", str(B),
                       "--memory_bank", "--shot", str(MB_SHOT),
                       "--dump_scores", "--csv"])
        cli_s = time.perf_counter() - t0
        n_batches = -(-(EVAL_NORMAL + EVAL_ANOMALOUS) // B)
        launches = attention_packed.launches
        expect(launches == n_layers * (n_batches + 1),
               f"mb eval CLI: {launches} B1 launches, not {n_layers} x "
               f"({n_batches} batches + 1 bank batch)")
        log = open(os.path.join(save, "test.log")).read()
        expect(f"memory bank: {MB_SHOT * cfg.vision.grid ** 2} patch "
               f"vectors/level x 4 levels ({MB_SHOT}-shot)" in log,
               "mb eval CLI: no bank line in the log")
        vit_l, text = create_clip_towers(cfg, checkpoint=ckpt_path)
        mbp = mb.make_mb_predict_fn(vit_l, cfg, acfg, policy=bf16,
                                    uint8_inputs=True)
        ad = adapter_from_jax(ad_tree, cfg, acfg)
        support = mb.collect_support_sets("MVTec", MB_SHOT, img,
                                          uint8=True)["bottle"]
        bank = mb.collect_bank(mbp.features_fn, ad, support, batch_size=B)

        def fn(ia, im, an, M):
            return mbp(ia, im, an, M, bank)
        fn.device = mbp.device
        cls_anchors = encode_dataset_anchors(make_anchor_encoder(
            text, cfg, acfg, policy=bf16), "MVTec")["bottle"]
        ds = get_test_datasets("MVTec", img, uint8=True)["bottle"]
        got = run_class_predictions(fn, ad, list(BatchLoader(ds, B)),
                                    cls_anchors, "Industrial", img,
                                    cfg.vision.grid)
        rows = read_csv(os.path.join(save, "scores_1.csv"))[1:]
        same = [r[1] for r in rows] == got[4] and \
            [float(r[3]) for r in rows] == [float(x) for x in got[3]]
        table = read_csv(os.path.join(save, "results_1.csv"))
        print(f"mb eval CLI bf16 B={B} --memory_bank --shot {MB_SHOT}: "
              f"{len(rows)} images, {launches} B1 launches ({n_batches} "
              f"batches + the bank's); scores equal the direct mb predict's "
              f"bit for bit: {same}; table {table[1]}; {cli_s:.1f} s for "
              f"the CLI on {card}")
        expect(same, "mb eval CLI: scores differ from the direct mb predict")
        del vit_l, text, mbp, bank
        gc.collect()
        torch.cuda.empty_cache()
        return launches
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


def http_call(url: str, data=None):
    """(status, headers, body, seconds) of one GET or POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            out = (r.status, r.headers, r.read())
    except urllib.error.HTTPError as e:
        out = (e.code, e.headers, e.read())
    return out + (time.perf_counter() - t0,)


def served_map(status, headers, body):
    """(map as float32, score, the encoding's own rounding bound) of a
    /predict response."""
    import numpy as np

    expect(status == 200, f"/predict answered {status}: {body[:300]}")
    kind = headers.get("X-Map-Dtype")
    if kind is None:
        payload = json.loads(body)
        return (np.asarray(payload["anomaly_map"], np.float32),
                payload["image_score"], 5e-5)
    shape = tuple(int(x) for x in headers["X-Map-Shape"].split(","))
    score = float(headers["X-Image-Score"])
    if kind == "float16":
        m = np.frombuffer(body, "<f2").reshape(shape).astype(np.float32)
        return m, score, float(np.spacing(np.float16(np.abs(m).max()))) / 2
    scale = float(headers["X-Map-Scale"])
    m = float(headers["X-Map-Offset"]) + scale * np.frombuffer(
        body, np.uint8).reshape(shape).astype(np.float32)
    return m, score, scale / 2


def phase_serve(card, ckpt_path: str) -> dict:
    """Phase 12c; returns B1's launches per served micro-batch."""
    import gc
    import os
    import threading

    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import AdapterConfig, get_config
    from aaclip_tpu_torch.core.params import (adapter_to_jax,
                                              init_image_adapter,
                                              init_text_adapter,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.data.image import encode_png
    from aaclip_tpu_torch.ops.attention import attention_packed
    from aaclip_tpu_torch.serve import server
    from aaclip_tpu_torch.text import anchors as anchors_mod
    from aaclip_tpu_torch.train import checkpoint as ckpt

    cfg = get_config("ViT-L-14-336", img_size=518)
    img, n_layers = cfg.vision.image_size, cfg.vision.layers
    acfg = AdapterConfig()
    tmp = tempfile.mkdtemp(prefix="aaclip_serve_")
    engine = httpd = None
    try:
        adapters = os.path.join(tmp, "adapters")
        ckpt.save_adapter_checkpoint(
            os.path.join(adapters, "image_adapter_1.npz"), 1,
            adapter_to_jax(init_image_adapter(cfg, acfg, seed=9,
                                              device="cpu")))
        ckpt.save_adapter_checkpoint(
            os.path.join(adapters, "text_adapter.npz"), 0,
            text_adapter_to_jax(init_text_adapter(cfg, acfg, seed=10,
                                                  device="cpu")))
        cache = os.path.join(tmp, "anchor_cache")
        kw = dict(model_name="ViT-L-14-336", img_size=img,
                  datasets=("MVTec",), save_path=adapters, precision="bf16",
                  max_batch=8, clip_checkpoint=ckpt_path,
                  anchor_cache=cache)
        zero_counts()
        t0 = time.perf_counter()
        engine = server.InferenceEngine(**kw)
        start_s = time.perf_counter() - t0
        warm_launches = attention_packed.launches
        print(f"serve: engine up in {start_s:.2f} s ("
              + ", ".join(f"{k} {v:.2f} s" for k, v in
                          engine.startup_s.items())
              + "; the kernels were built in phase 2), "
              f"{warm_launches} B1 launches in the warm-up; untrained "
              f"{engine.untrained} on {card}")
        expect(not engine.untrained, "serve: the engine found no adapters")
        expect(warm_launches == n_layers * WARMUP_BUCKETS,
               f"serve warm-up: {warm_launches} B1 launches")
        expect(len(os.listdir(cache)) == 1, "serve: no anchor-cache entry")

        # a second engine on the same cache: no text forward
        calls = []
        real = anchors_mod.encode_dataset_anchors

        def counting(*a, **k):
            calls.append(1)
            return real(*a, **k)

        anchors_mod.encode_dataset_anchors = counting
        try:
            t0 = time.perf_counter()
            second = server.InferenceEngine(**kw, precompile=False)
            second_s = time.perf_counter() - t0
        finally:
            anchors_mod.encode_dataset_anchors = real
        second.shutdown()
        same = all(np.array_equal(second.anchors["MVTec"][c], a)
                   for c, a in engine.anchors["MVTec"].items())
        print(f"serve: a second engine on the same anchor cache: "
              f"{len(calls)} text forwards, anchors bit for bit {same}, "
              f"anchors {second.startup_s['anchors']:.3f} s against "
              f"{engine.startup_s['anchors']:.3f} s uncached; up in "
              f"{second_s:.2f} s without the warm-up")
        expect(not calls and same, "serve: the second engine did not read "
               "the anchor cache")
        del second
        gc.collect()
        torch.cuda.empty_cache()

        httpd = server.serve(engine, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        rng = np.random.default_rng(12)
        pngs = [encode_png(rng.integers(0, 256, (SERVE_PNG_PX, SERVE_PNG_PX,
                                                 3), dtype=np.uint8))
                for _ in range(SERVE_REQUESTS)]
        classes = [SERVE_CLASSES[i % 3] for i in range(SERVE_REQUESTS)]
        query = {5: "&map_encoding=f16", 6: "&map_encoding=u8",
                 7: "&map_stride=2"}
        results = [None] * SERVE_REQUESTS

        def fire(i):
            results[i] = http_call(
                f"{base}/predict?dataset=MVTec&class_name={classes[i]}"
                + query.get(i, ""), pngs[i])

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(SERVE_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # the stride-2 request's image alone, full and at stride 2
        alone = [http_call(f"{base}/predict?dataset=MVTec&class_name="
                           f"{classes[7]}{q}", pngs[7])
                 for q in ("", "&map_stride=2")]
        gets = {p: http_call(base + p) for p in
                ("/healthz", "/classes?dataset=MVTec", "/statz")}
        for p, (code, _, body, _) in gets.items():
            expect(code == 200, f"GET {p}: {code}")
        stats = json.loads(gets["/statz"][2])
        launches = attention_packed.launches
        expect(launches == n_layers * (stats["batches"] + WARMUP_BUCKETS),
               f"serve: {launches} B1 launches for {stats['batches']} "
               f"batches + {WARMUP_BUCKETS} warm-up buckets")
        expect(stats["errors"] == 0 and stats["rejected"] == 0,
               f"serve: /statz counts errors {stats}")
        health = json.loads(gets["/healthz"][2])
        expect(health["untrained"] is False and health["img_size"] == img,
               f"/healthz {health}")
        n_cls = len(json.loads(gets["/classes?dataset=MVTec"][2])["classes"])
        expect(n_cls == 15, f"/classes lists {n_cls} classes")

        # a direct call of the engine's make_predict_fn on the same decoded
        # images and anchors
        imgs = np.stack([server._decode_image(p, img) for p in pngs])
        anch = np.stack([engine.anchors["MVTec"][c] for c in classes])
        with torch.inference_mode():
            pix_d, s_d = engine._predict(
                engine.image_adapter, torch.from_numpy(imgs).cuda(),
                torch.from_numpy(anch).cuda(),
                engine._postproc_dev["MVTec"])
        pix_d, s_d = pix_d.cpu().numpy(), s_d.cpu().numpy()
        span = float(pix_d.max() - pix_d.min())
        worst_map = worst_score = 0.0
        for i, (code, headers, body, _) in enumerate(results):
            m, score, rounding = served_map(code, headers, body)
            stride = 2 if i == 7 else 1
            want = pix_d[i, ::stride, ::stride]
            expect(m.shape == want.shape, f"request {i}: map {m.shape}")
            dm = float(np.abs(m - want).max())
            worst_map = max(worst_map, dm / span)
            worst_score = max(worst_score, abs(score - float(s_d[i])))
            expect(dm <= PIX_SPAN_FRAC_BF16 * span + rounding,
                   f"request {i}: map off by {dm} (span {span}, rounding "
                   f"{rounding})")
            expect(abs(score - float(s_d[i])) <= SCORE_ATOL_BF16,
                   f"request {i}: score {score} vs {s_d[i]}")
        full, _, _ = served_map(*alone[0][:3])
        strided, _, _ = served_map(*alone[1][:3])
        expect(np.array_equal(strided, full[::2, ::2]),
               "serve: the stride-2 map is not the full map sliced")
        lat = sorted(r[3] * 1e3 for r in results)
        print(f"serve: {SERVE_REQUESTS} concurrent PNG /predict requests "
              f"({SERVE_PNG_PX} px, {', '.join(SERVE_CLASSES)}; json, f16, "
              f"u8, map_stride 2) against the direct predict at B=8: max|d "
              f"map| {worst_map:.3e} of the span (bar "
              f"{PIX_SPAN_FRAC_BF16} + the encoding's rounding), max|d "
              f"score| {worst_score:.3e} (bar {SCORE_ATOL_BF16}); stride 2 "
              f"equals the full map sliced: True; latencies "
              f"{', '.join(f'{x:.1f}' for x in lat)} ms")
        print(f"serve /statz: {stats['requests']} requests in "
              f"{stats['batches']} batches (occupancy "
              f"{stats['mean_batch_occupancy']}), latency p50 "
              f"{stats['latency_ms']['p50']} ms, p95 "
              f"{stats['latency_ms']['p95']} ms; B1 launches {launches} = "
              f"{n_layers} x ({stats['batches']} + {WARMUP_BUCKETS} warm-up)")
        for name, row in stats["phases"].items():
            print(f"  phase {name}: n {row['n']}, total {row['total_s']} s, "
                  f"mean {row['mean_ms']} ms, p50 {row['p50_ms']} ms, p95 "
                  f"{row['p95_ms']} ms")
        return {"launches_per_batch": (launches // (stats["batches"]
                                                    + WARMUP_BUCKETS)),
                "start_s": start_s}
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if engine is not None:
            engine.shutdown()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)


def bench_serve_line(argv, requests: int = SERVE_CLOSED_REQUESTS) -> dict:
    """One in-process ``python -m aaclip_tpu_torch.bench --mode serve``
    run's JSON line: the closed loop (``--clients``) ``requests`` requests
    per client, all of them served, the open loop (``--open_loop``)
    SERVE_SECONDS of arrivals; no request may fail."""
    import contextlib
    import gc
    import io

    import torch

    from aaclip_tpu_torch import bench

    closed = "--open_loop" not in argv
    steps = requests if closed else SERVE_SECONDS
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(["--mode", "serve", "--steps", str(steps)] + argv)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    expect(line["errors"] == 0 and line["served"] > 0,
           f"bench --mode serve {' '.join(argv)}: {line}")
    if closed:
        clients = int(argv[argv.index("--clients") + 1])
        expect(line["served"] == clients * steps
               and f"x {steps} requests" in line["unit"],
               f"bench --mode serve {' '.join(argv)}: served "
               f"{line['served']}, not {clients} x {steps} requests")
    gc.collect()
    torch.cuda.empty_cache()
    return line


def phase_bench_serve(card, rates: dict) -> dict:
    """Phase 12d: the serve bench closed, open at half the closed rate, and
    closed with --map_stride 4; printed beside the predict's maps/s."""
    closed = bench_serve_line(["--clients", "8"])
    half = closed["value"] / 2
    open_ = bench_serve_line(["--open_loop", f"{half:.3f}"])
    strided = bench_serve_line(["--clients", "8", "--map_stride", "4"])
    for name, line in (("closed, 8 clients", closed),
                       (f"open loop {half:.2f} rps", open_),
                       ("closed, 8 clients, map_stride 4", strided)):
        lat = line["latency_ms"]
        print(f"bench --mode serve {name}: {line['value']} maps/s, p50 "
              f"{lat['p50']} ms, p95 {lat['p95']} ms, occupancy "
              f"{line['mean_batch_occupancy']}, served {line['served']}, "
              f"rejected {line['rejected']}, errors {line['errors']}")
    print(f"serve maps/s {closed['value']} (stride 4: {strided['value']}) "
          f"against the predict's {rates['predict B=8']:.2f} at B=8 and "
          f"{rates['predict B=32']:.2f} at B=32 (phase 12a) on {card}")
    return {"closed": closed, "open": open_, "stride4": strided}


def phase_serving(vit, adapter, cfg, acfg, anchors, M, card, gen,
                  ckpt_path: str) -> dict:
    """Phase 12: 12a-d above; returns B1's launches per path."""
    t_phase = time.perf_counter()
    rates, feat_launches, mb_launches = phase_memory_bank(
        vit, adapter, cfg, acfg, anchors, M, card, gen)
    cli_launches = phase_mb_eval_cli(card, ckpt_path)
    served = phase_serve(card, ckpt_path)
    bench = phase_bench_serve(card, rates)
    print(f"phase 12 (serving and the memory bank) took "
          f"{time.perf_counter() - t_phase:.0f} s")
    SERVE_READINGS.update(start_s=served["start_s"],
                          closed=bench["closed"]["value"])
    return {"memory-bank features batch": feat_launches,
            "memory-bank predict": mb_launches,
            "memory-bank evaluation CLI": cli_launches,
            "served micro-batch": served["launches_per_batch"]}


# the live engine's start-up seconds and closed-loop maps/s (phase 12),
# read beside the artifact engine's in phase 13
SERVE_READINGS = {}


# Phase 13, int8 inference and the exported serving artifact at
# ViT-L-14-336 @ 518, after phase 12. (a) The int8 predict (--precision
# int8, uint8 inputs) at batch 32 against the same int8 trunk with the
# plain attention: scores at phase 4's bar, the map at INT8_PIX_SPAN_FRAC.
# The kernel's one-ulp differences from the plain attention reach the
# out-projection's per-token int8 scale: an ulp moved in a row's largest
# value rescales the whole row and flips its int8 roundings (a step of
# 1/127 of that value), where under bf16 it moves one element by 2^-8 of
# itself; read on an NVIDIA H100 80GB HBM3, 700 W: 2.09e-2 of the span,
# scores 6.3e-5, so the map bar stands at twice that reading, and the bf16
# predict's own kernel-vs-plain distance on the same images is printed
# beside it; 24 B1 launches and 96 qdot calls per predict, 48 at
# int8_until 12;
# printed, without a gate, its map correlation and deviation from the bf16
# and fp32 predictors (random ViT-L weights are not a task: the task gate
# is the CPU test's). (b) CUDA-event times of the int8, bf16 and int8_until
# 12 predicts at batch 32, and of one fc product's parts at the predict's
# rows (dyn_quant, _int_mm with the weight as the [in, out] column-major
# view and as a contiguous [in, out] copy, the dequant, the bf16 GEMM).
# (c) Export (deploy.py) from phase 9's checkpoint: bf16 at buckets 1 and
# 8 (the smallest and the engine's max_batch: each program more adds ~5 s
# of torch.export.load to every load of the artifact, and 13 loads it four
# times) and int8 at 8 (the int8 export in a child process beside the
# bf16 one: both are host work); each reloaded artifact against the live
# predictor at batch 8, and the bf16 artifact at each bucket's batch
# against the live predictor built here as deploy.py builds it, bit for
# bit, or, if an exported op's form moves the bits on the card, within
# ART_SPAN_FRAC of the map's span, printed; every program's graph holds
# aaclip::attention_packed and each artifact call launches B1 24 times;
# every .pt2 under ART_GRAPH_FRAC of params.npz; export seconds per
# program and the load seconds printed. (d)
# The serving engine from the bf16 artifact (max_batch 8): start-up
# against phase 12's live engine, 8 concurrent requests against a direct
# artifact predict of the same images within SERVE_ART_SPAN_FRAC of the
# span (phase 12's reading for one batch composition against another),
# and ``bench --mode serve --artifact`` closed loop, 8 clients of
# ART_SERVE_REQUESTS requests, beside phase 12d's live reading. (e) The
# evaluation CLI with --artifact (the int8 artifact: one program, whose
# load takes seconds where the bf16 artifact's take ~10-20) on one
# synthetic MVTec class, its scores bit
# for bit against a direct artifact predict of the same batches, and with
# --precision int8 from phase 9's checkpoint on the same class: it runs
# and prints its table.
INT8_PIX_SPAN_FRAC = 4e-2
ART_SPAN_FRAC = 1e-4
ART_GRAPH_FRAC = 0.05
SERVE_ART_SPAN_FRAC = 1.2e-3
INT8_BATCH, INT8_UNTIL = 32, 12
ART_BUCKETS = (1, 8)
# 13d's closed-loop serve bench on the bf16 artifact: requests per client
# (8 clients; 12d's live bench serves SERVE_CLOSED_REQUESTS each)
ART_SERVE_REQUESTS = 25
ART_EVAL_NORMAL, ART_EVAL_ANOMALOUS = 4, 12


def check_int8(vit, adapter, cfg, acfg, images, anchors, M,
               what: str) -> tuple:
    """Phase 13a's check, at any tower: the int8 predict (``uint8``
    ``images``) against the same int8 trunk on the plain attention at
    INT8_PIX_SPAN_FRAC of the span and SCORE_ATOL_BF16, finite; four int8
    weights a block of the tower, B1 launches and four ``qdot`` calls a
    block up to the last tap (``max(acfg.levels)``), none from the plain
    predictor. Returns (the predictor, its maps and scores, launches,
    qdot calls)."""
    import gc

    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.ops.attention import attention_packed
    from aaclip_tpu_torch.ops.quant import qdot

    heads, depth = cfg.vision.heads, max(acfg.levels)
    int8 = DtypePolicy.int8()
    kw = dict(uint8_inputs=True)
    p8 = make_predict_fn(vit, cfg, acfg, policy=int8, **kw)
    p8_plain = make_predict_fn(vit, cfg, acfg, policy=int8,
                               attn_fn=make_attn_fn_plain(heads, int8), **kw)
    n_q = sum(1 for v in p8.visual.values() if v.dtype == torch.int8)
    expect(n_q == 4 * cfg.vision.layers,
           f"{what} int8 predictor: {n_q} int8 weights")

    zero_counts()
    qdot.launches = 0
    pix_k, s_k = p8(adapter, images, anchors, M)
    torch.cuda.synchronize()
    launches, q_calls = attention_packed.launches, qdot.launches
    expect(launches == depth, f"{what} int8 predict: {launches} B1 launches")
    expect(q_calls == 4 * depth, f"{what} int8 predict: {q_calls} qdot "
           f"calls")
    pix_p, s_p = p8_plain(adapter, images, anchors, M)
    expect(attention_packed.launches == depth,
           f"{what}: the plain-attention int8 predictor launched the kernel")
    expect(bool(torch.isfinite(pix_k).all() and torch.isfinite(s_k).all()),
           f"{what} int8 predict output not finite")
    span = (pix_p.max() - pix_p.min()).item()
    dpix = (pix_k - pix_p).abs().max().item()
    dscore = (s_k - s_p).abs().max().item()
    print(f"{what} int8 predict B={images.shape[0]}, kernel vs plain "
          f"attention: map span {span:.4f}, max|d map| {dpix:.3e} "
          f"({dpix / span:.3e} of span, bar {INT8_PIX_SPAN_FRAC}), max|d "
          f"score| {dscore:.3e} (bar {SCORE_ATOL_BF16}); {launches} B1 "
          f"launches, {q_calls} qdot calls per predict")
    expect(dpix <= INT8_PIX_SPAN_FRAC * span, f"{what} int8 map off: {dpix}")
    expect(dscore <= SCORE_ATOL_BF16, f"{what} int8 scores off: {dscore}")
    del p8_plain, pix_p, s_p
    gc.collect()
    torch.cuda.empty_cache()
    return p8, pix_k, s_k, launches, q_calls


def int8_distances(pix_k, s_k, outs: dict) -> None:
    """Prints the int8 predict's distance from each of ``outs`` ({name:
    (maps, scores)} on the same images): map correlation, max |d map| of
    the other's span, max |d score|; no bar (random weights are not a
    task: the task gate is the CPU test's)."""
    import torch

    for name, (pix, s) in outs.items():
        a, b = pix_k.double().flatten(), pix.double().flatten()
        corr = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
        sp = (pix.max() - pix.min()).item()
        print(f"int8 predict against {name}: map correlation {corr:.6f}, "
              f"max|d map| {(pix_k - pix).abs().max().item() / sp:.3e} of "
              f"its span, max|d score| {(s_k - s).abs().max().item():.3e}")


def phase_int8(vit, adapter, cfg, acfg, anchors, M, card, gen) -> dict:
    """Phase 13a-b; returns the launches per int8 predict and the rates."""
    import dataclasses
    import gc

    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.ops.quant import dyn_quant, qdot, quantize_weight

    heads, img = cfg.vision.heads, cfg.vision.image_size
    int8_k = dataclasses.replace(DtypePolicy.int8(), int8_until=INT8_UNTIL)
    kw = dict(uint8_inputs=True)
    B = INT8_BATCH
    images = torch.randint(0, 256, (B, 3, img, img), generator=gen,
                           device="cuda", dtype=torch.uint8)
    p8, pix_k, s_k, launches, q_calls = check_int8(
        vit, adapter, cfg, acfg, images, anchors, M, "ViT-L")
    # the bf16 predict's own kernel-vs-plain distance on these images
    bf16 = DtypePolicy.bf16()
    pb = make_predict_fn(vit, cfg, acfg, policy=bf16, **kw)
    pb_plain = make_predict_fn(vit, cfg, acfg, policy=bf16,
                               attn_fn=make_attn_fn_plain(heads, bf16), **kw)
    pix_b, _ = pb(adapter, images, anchors, M)
    pix_bp, _ = pb_plain(adapter, images, anchors, M)
    span_b = (pix_bp.max() - pix_bp.min()).item()
    print(f"bf16 predict B={B} on the same images, kernel vs plain "
          f"attention: max|d map| "
          f"{(pix_b - pix_bp).abs().max().item() / span_b:.3e} of span")
    del pb_plain, pix_b, pix_bp
    gc.collect()
    torch.cuda.empty_cache()

    pk = make_predict_fn(vit, cfg, acfg, policy=int8_k, **kw)
    qdot.launches = 0
    pk(adapter, images, anchors, M)
    torch.cuda.synchronize()
    expect(qdot.launches == 4 * INT8_UNTIL,
           f"int8_until {INT8_UNTIL}: {qdot.launches} qdot calls")
    n_qk = sum(1 for v in pk.visual.values() if v.dtype == torch.int8)
    expect(n_qk == 4 * INT8_UNTIL, f"int8_until {INT8_UNTIL}: {n_qk} int8 "
           "weights")
    print(f"int8_until {INT8_UNTIL}: {qdot.launches} qdot calls per "
          f"predict, {n_qk} int8 weights (blocks 0-{INT8_UNTIL - 1})")

    # the deviation of int8 from the bf16 and fp32 predictors (printed)
    with torch.inference_mode():
        out = {"bf16": pb(adapter, images, anchors, M)}
        pf = make_predict_fn(vit, cfg, acfg, policy=DtypePolicy.fp32(), **kw)
        out["fp32"] = pf(adapter, images, anchors, M)
        del pf
        out["int8_until"] = pk(adapter, images, anchors, M)
    int8_distances(pix_k, s_k, out)
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # 13b: the predicts' times in one call
    ms = {"int8": cuda_ms(lambda: p8(adapter, images, anchors, M), 10),
          "bf16": cuda_ms(lambda: pb(adapter, images, anchors, M), 10),
          f"int8_until {INT8_UNTIL}": cuda_ms(
              lambda: pk(adapter, images, anchors, M), 10)}
    rates = {k: B * 1e3 / v for k, v in ms.items()}
    print("predict B=32 maps/s: " + ", ".join(
        f"{k} {v:.2f} ({ms[k]:.2f} ms)" for k, v in rates.items())
        + f"; int8 / bf16 {rates['int8'] / rates['bf16']:.3f} on {card}")

    # one fc product's parts at the predict's rows
    rows, D, F = B * cfg.vision.seq_len, cfg.vision.width, 4 * \
        cfg.vision.width
    x = torch.randn(rows, D, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(F, D, generator=gen, device="cuda") * 0.02
    wq, ws = quantize_weight(w)
    q, m = dyn_quant(x)
    y = torch._int_mm(q, wq.t())
    wq_in_out = wq.t().contiguous()
    w16 = w.to(torch.bfloat16)
    parts = {
        "dyn_quant": cuda_ms(lambda: dyn_quant(x), 10),
        "_int_mm, weight [out, in] as w.t()": cuda_ms(
            lambda: torch._int_mm(q, wq.t()), 10),
        "_int_mm, weight contiguous [in, out]": cuda_ms(
            lambda: torch._int_mm(q, wq_in_out), 10),
        "dequant": cuda_ms(lambda: y.float() * (m * ws), 10),
        "qdot": cuda_ms(lambda: qdot(x, wq, ws), 10),
        "bf16 GEMM (matmul_f32)": cuda_ms(
            lambda: torch.mm(x, w16.t(), out_dtype=torch.float32), 10),
    }
    expect(torch.equal(torch._int_mm(q, wq.t()),
                       torch._int_mm(q, wq_in_out)),
           "_int_mm differs between the two weight layouts")
    print(f"fc product [{rows}, {D}] x [{D}, {F}] by part: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in parts.items()) + f" on {card}")
    del p8, pk, pb, x, w, wq, q, y, wq_in_out, w16
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "qdot": q_calls, "rates": rates,
            "parts": parts}


def graph_has_attention_op(ep) -> bool:
    import torch

    return any(n.target is torch.ops.aaclip.attention_packed.default
               for n in ep.graph.nodes)


def check_artifact(name: str, art, card) -> int:
    """The loaded artifact's programs (each holds aaclip::attention_packed)
    and one call of its b=8 program (24 B1 launches, finite), timed;
    returns the launches per call."""
    import numpy as np
    import torch

    from aaclip_tpu_torch.ops.attention import attention_packed

    for b, ep in art.programs.items():
        expect(graph_has_attention_op(ep),
               f"artifact {name} b={b}: no aaclip::attention_packed")
    n_op = sum(1 for n in art.programs[8].graph.nodes
               if n.target is torch.ops.aaclip.attention_packed.default)
    img = art.img_size
    imgs = np.random.default_rng(3).integers(0, 256, (8, 3, img, img),
                                             dtype=np.uint8)
    cls = sorted(art.anchors["MVTec"])[0]
    art.predict_class(imgs, "MVTec", cls)
    zero_counts()
    maps, scores = art.predict_class(imgs, "MVTec", cls)
    torch.cuda.synchronize()
    calls = attention_packed.launches
    expect(calls == n_op == 24, f"artifact {name}: {calls} B1 launches per "
           f"call, {n_op} nodes")
    expect(bool(np.isfinite(maps).all() and np.isfinite(scores).all()),
           f"artifact {name}: not finite")
    ms = cuda_ms(lambda: art.predict_class(imgs, "MVTec", cls), 5)
    print(f"artifact {name}: load " + ", ".join(
        f"{k} {v:.2f} s" for k, v in art.load_s.items())
        + f"; {n_op} aaclip::attention_packed nodes in the b=8 program, "
        f"{calls} B1 launches per call; predict_class B=8 {ms:.2f} ms "
        f"({8e3 / ms:.2f} maps/s, host copies included) on {card}")
    return calls


def check_buckets_vs_live(art, ckpt_path: str, adapters: str) -> None:
    """13c: the loaded bf16 artifact at each exported bucket's batch (the
    engine pads nothing then) against the live predictor on the same
    seeded images, built from the checkpoint and ``adapters`` as
    ``deploy.export_serving_artifact`` builds it: bit for bit, or within
    ART_SPAN_FRAC of the map's span."""
    import gc

    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              init_image_adapter)
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.train import checkpoint as ckpt

    cfg = get_config("ViT-L-14-336", img_size=art.img_size)
    acfg = AdapterConfig()
    vit, _ = create_clip_towers(cfg, checkpoint=ckpt_path)
    template = adapter_to_jax(init_image_adapter(cfg, acfg, device="cpu"))
    tree, _, path, _ = ckpt.discover_serving_adapters(adapters, template,
                                                      None)
    expect(path is not None, f"13c: no image adapter under {adapters}")
    image_adapter = adapter_from_jax(tree, cfg, acfg)
    live = make_predict_fn(vit, cfg, acfg, policy=DtypePolicy.bf16(),
                           uint8_inputs=True)
    cls = sorted(art.anchors["MVTec"])[0]
    M = torch.from_numpy(art.postproc["MVTec"]).cuda()
    rng = np.random.default_rng(15)
    readings = []
    for b in art.batch_sizes:
        imgs = rng.integers(0, 256, (b, 3, art.img_size, art.img_size),
                            dtype=np.uint8)
        maps, scores = art.predict_class(imgs, "MVTec", cls)
        anc = np.broadcast_to(art.anchors["MVTec"][cls],
                              (b,) + art.anchors["MVTec"][cls].shape)
        with torch.inference_mode():
            pix, score = live(image_adapter, torch.from_numpy(imgs).cuda(),
                              torch.from_numpy(np.array(anc)).cuda(), M)
        pix, score = pix.cpu().numpy(), score.cpu().numpy()
        span = float(pix.max() - pix.min())
        same = bool(np.array_equal(maps, pix)
                    and np.array_equal(scores, score))
        dm = float(np.abs(maps - pix).max())
        readings.append(f"B={b} " + ("bit for bit" if same else
                                     f"max|d map| {dm / span:.3e} of the "
                                     f"span"))
        expect(same or dm <= ART_SPAN_FRAC * span,
               f"artifact bf16 bucket {b}: off the live predictor by {dm} "
               f"of {span}")
    print(f"artifact bf16 against the live predictor at each bucket's batch:"
          f" {', '.join(readings)}")
    del vit, image_adapter, live
    gc.collect()
    torch.cuda.empty_cache()


def start_export_child(path: str, precision: str, ckpt_path: str,
                       adapters: str, buckets) -> dict:
    """13c's export of one artifact in a child (``chip_smoke.py
    --export-artifact``), started and left running: the other artifact's
    export goes on here beside it (both are host work: torch.export's
    tracing, the save, the digests, the reload). Its output goes to a
    file."""
    import os
    import subprocess

    out = open(path + ".out", "w")
    spec = {"out_dir": path, "precision": precision,
            "clip_checkpoint": ckpt_path, "save_path": adapters,
            "datasets": ["MVTec"], "batch_sizes": list(buckets),
            "verify": 8}
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--export-artifact",
         json.dumps(spec)], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=out, stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "out": out}


def finish_export_child(child) -> dict:
    """Waits for ``start_export_child``'s child; returns the manifest's
    parts it printed (``export_artifact_main``)."""
    import subprocess

    proc = child["proc"]
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    child["out"].close()
    with open(child["out"].name) as f:
        log = f.read()
    lines = [ln for ln in log.splitlines()
             if ln.startswith("ARTIFACT_MANIFEST ")]
    expect(proc.returncode == 0 and len(lines) == 1,
           f"the export child: exit {proc.returncode}:\n{log[-3000:]}")
    return json.loads(lines[0].split(" ", 1)[1])


def phase_artifact(card, ckpt_path: str, serve_readings: dict,
                   keep_int8: str = None) -> dict:
    """Phase 13c-e; returns B1's launches per artifact call. With
    ``keep_int8`` the int8 artifact is moved there at the end (phase 16b
    reads it)."""
    import gc
    import os
    import threading

    import numpy as np
    import torch

    from aaclip_tpu_torch import deploy
    from aaclip_tpu_torch import test as eval_cli
    from aaclip_tpu_torch.core.config import AdapterConfig, get_config
    from aaclip_tpu_torch.core.params import adapter_to_jax, init_image_adapter
    from aaclip_tpu_torch.data.datasets import BatchLoader, get_test_datasets
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.ops.attention import attention_packed
    from aaclip_tpu_torch.serve import server
    from aaclip_tpu_torch.train import checkpoint as ckpt

    cfg = get_config("ViT-L-14-336", img_size=518)
    img, n_layers = cfg.vision.image_size, cfg.vision.layers
    acfg = AdapterConfig()
    tmp = tempfile.mkdtemp(prefix="aaclip_artifact_")
    env_before = {k: os.environ.get(k) for k in ("AACLIP_DATA",
                                                 "AACLIP_METADATA")}
    child = None
    try:
        adapters = os.path.join(tmp, "adapters")
        ckpt.save_adapter_checkpoint(
            os.path.join(adapters, "image_adapter_1.npz"), 1,
            adapter_to_jax(init_image_adapter(cfg, acfg, seed=9,
                                              device="cpu")))
        paths, calls = {}, {}
        # the int8 export runs in a child beside the bf16 export here
        paths["int8"] = os.path.join(tmp, "artifact_int8")
        child = start_export_child(paths["int8"], "int8", ckpt_path,
                                   adapters, (8,))
        for name, precision, buckets in (("bf16", "bf16", ART_BUCKETS),
                                         ("int8", "int8", (8,))):
            path = paths[name] = os.path.join(tmp, f"artifact_{name}")
            if name == "int8":
                m = finish_export_child(child)
                wall = m["wall"]
                where = " in a child, beside the bf16 export"
            else:
                t0 = time.perf_counter()
                m = deploy.export_serving_artifact(
                    path, precision=precision, clip_checkpoint=ckpt_path,
                    save_path=adapters, datasets=("MVTec",),
                    batch_sizes=buckets, verify=8)
                wall, where = time.perf_counter() - t0, ""
            v = m["verify"]
            sizes = {f: os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path)}
            params = sizes["params.npz"]
            print(f"artifact {name}: exported{where} in {wall:.1f} s "
                  f"(programs "
                  + ", ".join(f"{k} {s:.1f} s" for k, s in
                              m["export_s"].items())
                  + f"; the towers, anchors, save and verify the rest), "
                  f"params.npz {params / 1e6:.1f} MB, programs "
                  + ", ".join(f"{f} {s / 1e6:.2f} MB" for f, s in
                              sorted(sizes.items()) if f.endswith(".pt2"))
                  + f"; native_kernels {m['native_kernels']}, untrained "
                  f"{m['untrained']} on {card}")
            expect(m["native_kernels"] is True and not m["untrained"],
                   f"artifact {name}: manifest {m['native_kernels']}, "
                   f"{m['untrained']}")
            for f, s in sizes.items():
                if f.endswith(".pt2"):
                    expect(s < ART_GRAPH_FRAC * params,
                           f"{f}: {s} bytes against params {params}")
            print(f"artifact {name} against the live predictor at B="
                  f"{v['batch']}: bit for bit {v['bit_equal']} (max|d map| "
                  f"{v['max_abs_map']:.3e}, span {v['span']:.4f}, max|d "
                  f"score| {v['max_abs_score']:.3e}); loaded in "
                  f"{v['load_s']:.2f} s")
            expect(v["bit_equal"] or v["max_abs_map"]
                   <= ART_SPAN_FRAC * v["span"],
                   f"artifact {name}: off the live predictor {v}")
            gc.collect()
            torch.cuda.empty_cache()
        art8 = deploy.load_serving_artifact(paths["int8"])
        calls["artifact call (int8, b=8)"] = check_artifact("int8", art8,
                                                            card)

        # 13d: the engine from the bf16 artifact (its artifact serves the
        # checks of 13c too: each bf16 load costs ~20 s)
        t0 = time.perf_counter()
        engine = server.InferenceEngine(artifact=paths["bf16"], max_batch=8)
        start_s = time.perf_counter() - t0
        try:
            art = engine._artifact
            calls["artifact call (bf16, b=8)"] = check_artifact("bf16", art,
                                                                card)
            check_buckets_vs_live(art, ckpt_path, adapters)
            live = serve_readings["start_s"]
            print(f"serve from the artifact: up in {start_s:.2f} s ("
                  + ", ".join(f"{k} {v:.2f} s" for k, v in
                              engine.startup_s.items())
                  + f") against the live engine's {live:.2f} s (phase 12c)"
                  f" on {card}")
            rng = np.random.default_rng(14)
            imgs = rng.integers(0, 256, (8, 3, img, img), dtype=np.uint8)
            classes = [SERVE_CLASSES[i % 3] for i in range(8)]
            results = [None] * 8

            def fire(i):
                results[i] = engine.submit(imgs[i], "MVTec", classes[i],
                                           timeout=120)

            threads = [threading.Thread(target=fire, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            anch = np.stack([art.anchors["MVTec"][c] for c in classes])
            pix_d, s_d = art.predict(imgs, anch, "MVTec")
            span = float(pix_d.max() - pix_d.min())
            dm = max(float(np.abs(r[0] - pix_d[i]).max())
                     for i, r in enumerate(results))
            ds = max(abs(r[1] - float(s_d[i])) for i, r in enumerate(results))
            stats = engine.stats()
            print(f"serve from the artifact: 8 concurrent requests in "
                  f"{stats['batches']} batches against a direct artifact "
                  f"predict at B=8: max|d map| {dm / span:.3e} of the span "
                  f"(bar {SERVE_ART_SPAN_FRAC}), max|d score| {ds:.3e}")
            expect(dm <= SERVE_ART_SPAN_FRAC * span and ds <= SCORE_ATOL_BF16,
                   f"served artifact maps off: {dm} / {span}, {ds}")
            # 14e, the artifact half: the same artifact served with
            # data_parallel=True over two replicas of its programs on the
            # card, whole micro-batches round-robin
            solo, ms_one = par_timed_answers(engine, imgs[:6], classes[:6])
            dp_engine = server.InferenceEngine(
                artifact=paths["bf16"], max_batch=8, data_parallel=True,
                device=["cuda:0", "cuda:0"])
            try:
                expect(len(dp_engine._replicas) == 2, "14e replicas")
                got, ms_two = par_timed_answers(dp_engine, imgs[:6],
                                                classes[:6])
                par_same_answers(got, solo, "bf16 artifact engine, two "
                                 f"replicas on cuda:0, on {card}")
                print(f"14e bf16 artifact engine: dispatch {ms_two:.2f} ms "
                      f"per micro-batch (bucket 1) over two replicas against "
                      f"{ms_one:.2f} on one card, on {card}")
            finally:
                dp_engine.shutdown()
                del dp_engine
        finally:
            engine.shutdown()
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        closed = bench_serve_line(["--clients", "8", "--artifact",
                                   paths["bf16"]], ART_SERVE_REQUESTS)
        lat = closed["latency_ms"]
        print(f"bench --mode serve --artifact closed, 8 clients: "
              f"{closed['value']} maps/s, p50 {lat['p50']} ms, p95 "
              f"{lat['p95']} ms, occupancy {closed['mean_batch_occupancy']}"
              f" against the live engine's {serve_readings['closed']} "
              f"(phase 12d) on {card}")

        # 13e: the evaluation CLI with --artifact (the int8 artifact, whose
        # one program loads in seconds) and with --precision int8
        data_root, meta_root = make_synthetic_dataset(
            os.path.join(tmp, "eval_set"), class_names=["bottle"],
            n_normal=ART_EVAL_NORMAL, n_anomalous=ART_EVAL_ANOMALOUS,
            img_px=EVAL_PX, hard=True)
        os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
        B = 8
        save = os.path.join(tmp, "eval_artifact")
        zero_counts()
        eval_cli.main(["--artifact", paths["int8"], "--save_path", save,
                       "--batch_size", str(B), "--dump_scores"])
        n_batches = -(-(ART_EVAL_NORMAL + ART_EVAL_ANOMALOUS) // B)
        expect(attention_packed.launches == n_layers * n_batches,
               f"artifact eval CLI: {attention_packed.launches} B1 launches")
        rows = read_csv(os.path.join(save, "scores_artifact.csv"))[1:]
        ds_ = get_test_datasets("MVTec", img, uint8=True)["bottle"]
        direct = []
        for batch in BatchLoader(ds_, B):
            n = batch["n_valid"]
            _, sc = art8.predict_class(batch["image"], "MVTec", "bottle")
            direct += [float(x) for x in sc[:n]]
        same = [float(r[3]) for r in rows] == direct
        print(f"eval CLI --artifact (int8) B={B}: {len(rows)} images, "
              f"{n_batches * n_layers} B1 launches; scores equal a direct "
              f"artifact predict's bit for bit: {same}")
        expect(same, "artifact eval CLI: scores differ from the direct "
               "artifact predict")
        del art8
        save8 = os.path.join(tmp, "eval_int8")
        ckpt.save_adapter_checkpoint(
            os.path.join(save8, "image_adapter_1.npz"), 1,
            adapter_to_jax(init_image_adapter(cfg, acfg, seed=9,
                                              device="cpu")))
        t0 = time.perf_counter()
        eval_cli.main(["--clip_checkpoint", ckpt_path, "--save_path", save8,
                       "--precision", "int8", "--batch_size", str(B)])
        print(f"eval CLI --precision int8 B={B}: ran in "
              f"{time.perf_counter() - t0:.1f} s on {card}")
        gc.collect()
        torch.cuda.empty_cache()
        if keep_int8:
            shutil.move(paths["int8"], keep_int8)
        return calls
    finally:
        if child is not None and child["proc"].poll() is None:
            child["proc"].kill()
            child["proc"].wait()
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


def phase_int8_artifact(vit, adapter, cfg, acfg, anchors, M, card, gen,
                        ckpt_path: str, serve_readings: dict,
                        keep_int8: str = None) -> dict:
    """Phase 13: 13a-e above; returns B1's launches per path."""
    t_phase = time.perf_counter()
    int8 = phase_int8(vit, adapter, cfg, acfg, anchors, M, card, gen)
    calls = phase_artifact(card, ckpt_path, serve_readings, keep_int8)
    print(f"phase 13 (int8 and the artifact) took "
          f"{time.perf_counter() - t_phase:.0f} s")
    return {"int8 predict": int8["launches"], **calls}


# ---------------------------------------------------------------------------
# Phase 14: data, tensor and sequence parallelism (aaclip_tpu_torch/parallel)

# 14a's bar where a loss or an update sums its global counts in another
# order than the single-process path: 1e-6 relative on a loss, 1e-6 of
# each adapter's max |value|. At world size 1 every collective is a copy,
# so bit for bit is what 14a expects first.
PAR_REL = 1e-6
PAR_PREDICT_BATCH, PAR_TRAIN_BATCH, PAR_S1_BATCH = 32, TRAIN_BATCH, \
    STAGE1_BATCH
PAR_MB_SHOT, PAR_MB_BATCH = 4, 8
# 14b: B1/B2/B3 at the per-rank geometries of tensor parallelism at tp 2
# and 4 (ViT-L's 16 heads of 64 -> 8 and 4), batch 8, beside tp 1
PAR_TP, PAR_KERNEL_BATCH = (1, 2, 4), 8
# 14c: two ranks on the one card (gloo on CUDA tensors). bf16 at phases
# 4-5's bars cannot tell a fault from rounding, so the same TP = 2 and
# TP = 2 + SP paths also run in fp32 (allow_tf32 off), where the ranks'
# products and the single-process ones differ only in summation order
# (column parts of one GEMM, two half-K partial sums added by the
# all-reduce): ~1e-6 relative per product, carried through 24 blocks.
# Bars: the map within 1e-4 of its span, the scores within 1e-4
# (SCORE_ATOL_FP32), the step's loss within 1e-5 relative
# (TINY_STEP_LOSS_RTOL) and each adapter gradient's difference within
# 1e-3 of its norm. The last is ten times the fp32 floor of the same
# step in one process, kernels against the plain attention (another
# summation order alone), which 14c reads beside the ranks' distance
# (~1e-4, PERF.md). Against each gradient's max |value| that floor
# reads several 1e-4 on the deep layer adapters, whose gradients are
# sums that largely cancel, so the max is not the bar. Batch 4 for the
# predicts and the steps: gloo carries each of the ranks' all-reduces of
# the [B, 1370, 1024] stream through the host, so 14c's time goes with B.
PAR_TP_PREDICT_BATCH, PAR_TP_STEP_BATCH = 4, 4
PAR_TP_FP32_SPAN_FRAC, PAR_TP_FP32_GRAD_NORM_REL = 1e-4, 1e-3
# 14d: the CLIs' small synthetic set (one class) and batches
PAR_CLI_NORMAL, PAR_CLI_ANOMALOUS, PAR_CLI_PX, PAR_CLI_BATCH = 8, 8, 256, 8
PAR_CHILD_TIMEOUT = 300
# 14e: the direct dispatch timings' micro-batch and calls
PAR_DISPATCH_BATCH, PAR_DISPATCH_CALLS = 8, 10


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def par_same(got, want, what: str) -> str:
    """``got`` against ``want`` (floats, or lists of tensors): "bit for
    bit", or within PAR_REL ("within 1e-6"); fails otherwise."""
    import torch

    if isinstance(want, float):
        if got == want:
            return "bit for bit"
        rel = abs(got - want) / max(abs(want), 1e-30)
        expect(rel <= PAR_REL, f"{what}: {got} vs {want} ({rel:.3e} rel)")
        return f"within {rel:.1e} relative"
    if all(torch.equal(g, w) for g, w in zip(got, want)):
        return "bit for bit"
    worst = max(((g.float() - w.float()).abs().max()
                 / w.float().abs().max().clamp_min(1e-30)).item()
                for g, w in zip(got, want))
    expect(worst <= PAR_REL, f"{what}: {worst:.3e} of the max")
    return f"within {worst:.1e} of the max"


def dp_step_world1(vit, cfg, acfg, adapter, mesh, batch, table,
                   what: str) -> tuple:
    """14a's stage-2 step check at world size 1, at any tower: two bf16
    steps (remat off) through ``mesh`` and two without it, each from a
    copy of ``adapter``, the losses and the adapters after them bit for
    bit (or within PAR_REL, printed), one B1 launch a block up to the last
    tap and one B2 fewer a step. Returns the launches per step."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.train.optim import make_image_optimizer
    from aaclip_tpu_torch.train.steps import make_stage2_step

    depth = max(acfg.levels)
    runs = {}
    for name, m in (("dp", mesh), ("single", None)):
        ad = copy.deepcopy(adapter)
        step = make_stage2_step(vit, cfg, acfg,
                                make_image_optimizer(ad.parameters()),
                                table, policy=DtypePolicy.bf16(),
                                remat=False, mesh=m)
        zero_counts()
        losses = [float(step(ad, *batch)) for _ in range(2)]
        torch.cuda.synchronize()
        runs[name] = (losses, [p.detach().clone()
                               for p in ad.parameters()], counts())
        del ad, step
    per_step = tuple(c // 2 for c in runs["dp"][2])
    how_l = [par_same(a, b, f"{what} loss")
             for a, b in zip(runs["dp"][0], runs["single"][0])]
    how_a = par_same(runs["dp"][1], runs["single"][1], f"{what} adapters")
    print(f"{what} bf16 B={batch[0].shape[0]} remat off, two steps at world "
          f"1: losses {runs['dp'][0]} ({', '.join(how_l)}), adapters "
          f"{how_a} the single-process step's; launches per step "
          f"{per_step}")
    expect(per_step == (depth, 0, depth - 1),
           f"{what} launches {per_step}")
    return per_step


def par_world1(vit, adapter, cfg, acfg, anchors, M, card, gen) -> dict:
    """14a: each parallel path at world size 1 on NCCL (rank 0 of 1 on
    cuda:0, torchrun's variables set here) against its single-process
    path; returns {path: (forward, V-V, backward) launches}."""
    import os

    import torch
    import torch.distributed as dist

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.core.params import (init_text_adapter,
                                              init_text_params)
    from aaclip_tpu_torch.eval import memory_bank as mb
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.parallel import sharding as sh
    from aaclip_tpu_torch.text.anchors import dataset_prompt_tokens
    from aaclip_tpu_torch.train.optim import make_text_optimizer
    from aaclip_tpu_torch.train.steps import (make_stage1_step,
                                              stage1_features_fn)

    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    env_before = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    calls = {}
    img, n_layers = cfg.vision.image_size, cfg.vision.layers
    vv_layers = STAGE1_SURGERY_UNTIL - 1
    bf16 = DtypePolicy.bf16()
    try:
        expect(sh.initialize_multihost(), "no process group")
        mesh = sh.make_data_mesh()
        expect(dist.get_backend() == "nccl" and mesh.dp == 1
               and mesh.device == torch.device("cuda:0"),
               f"world-1 mesh {dist.get_backend()} {mesh}")

        # the predict, bf16 uint8 at batch 32, timed beside the plain one
        p_dp = make_predict_fn(vit, cfg, acfg, policy=bf16,
                               uint8_inputs=True, mesh=mesh)
        p_1 = make_predict_fn(vit, cfg, acfg, policy=bf16, uint8_inputs=True)
        u8 = torch.randint(0, 256, (PAR_PREDICT_BATCH, 3, img, img),
                           generator=gen, device="cuda", dtype=torch.uint8)
        zero_counts()
        got = p_dp(adapter, u8, anchors, M)
        torch.cuda.synchronize()
        calls["DP predict (world 1)"] = counts()
        want = p_1(adapter, u8, anchors, M)
        how = par_same(list(got), list(want), "DP predict")
        expect(how == "bit for bit", f"DP predict {how}")
        ms_dp = cuda_ms(lambda: p_dp(adapter, u8, anchors, M), 5)
        ms_1 = cuda_ms(lambda: p_1(adapter, u8, anchors, M), 5)
        print(f"14a DP predict bf16 B={PAR_PREDICT_BATCH} at world 1 (NCCL):"
              f" {how} the single-process predict; launches "
              f"{calls['DP predict (world 1)']}; {PAR_PREDICT_BATCH / ms_dp * 1e3:.2f}"
              f" maps/s against {PAR_PREDICT_BATCH / ms_1 * 1e3:.2f} "
              f"(single-process, same call) on {card}")
        expect(calls["DP predict (world 1)"] == (n_layers, 0, 0),
               "DP predict launches")
        del p_dp, p_1, u8, got, want

        # the stage-2 step, bf16 at batch 8, remat off, two steps
        batch = train_batch(PAR_TRAIN_BATCH, img, gen)
        table = unit_table(cfg.embed_dim, gen)
        calls["DP stage-2 step (world 1), per step"] = dp_step_world1(
            vit, cfg, acfg, adapter, mesh, batch, table,
            "14a DP stage-2 step")
        del batch

        # stage 1 at batch 16: features in both V-V modes, then a step
        images, mask, cidx, valid = stage1_batch(PAR_S1_BATCH, img, gen)
        cidx = cidx % 2
        text = init_text_params(cfg, seed=3)
        tokens = dataset_prompt_tokens("MVTec", ["bottle", "cable"])
        for vv_mode in ("spatial", "batch"):
            f_dp = stage1_features_fn(vit, cfg, policy=bf16, vv_mode=vv_mode,
                                      mesh=mesh)
            f_1 = stage1_features_fn(vit, cfg, policy=bf16, vv_mode=vv_mode)
            zero_counts()
            feats = f_dp(images, valid)
            torch.cuda.synchronize()
            key = f"DP stage-1 {vv_mode} features (world 1)"
            calls[key] = counts()
            want = f_1(images, valid)
            how_f = par_same([feats], [want], f"DP {vv_mode} features")
            res = {}
            for name, m in (("dp", mesh), ("single", None)):
                tad = init_text_adapter(cfg, acfg, seed=4)
                step = make_stage1_step(text, cfg, acfg,
                                        make_text_optimizer(tad.parameters()),
                                        tokens, policy=bf16, mesh=m)
                loss = float(step(tad, want, mask, cidx, valid))
                res[name] = (loss, [p.detach().clone()
                                    for p in tad.parameters()])
            how_l = par_same(res["dp"][0], res["single"][0], "DP s1 loss")
            how_a = par_same(res["dp"][1], res["single"][1], "DP s1 adapters")
            print(f"14a DP stage-1 {vv_mode} features B={PAR_S1_BATCH} at "
                  f"world 1: {how_f}; launches {calls[key]}; the step's loss"
                  f" {res['dp'][0]:.6f} {how_l}, text adapters {how_a}")
            expect(calls[key] == (n_layers, vv_layers if vv_mode ==
                                  "spatial" else 0, 0),
                   f"{key} launches {calls[key]}")
            expect(how_f == "bit for bit", f"DP {vv_mode} features {how_f}")
            del f_dp, f_1, feats, want
        del text, images, mask

        # the memory bank, 4-shot, queries at batch 8
        support = torch.randint(0, 256, (PAR_MB_SHOT, 3, img, img),
                                generator=gen, device="cuda",
                                dtype=torch.uint8)
        q = torch.randint(0, 256, (PAR_MB_BATCH, 3, img, img), generator=gen,
                          device="cuda", dtype=torch.uint8)
        outs = {}
        for name, m in (("dp", mesh), ("single", None)):
            fn = mb.make_mb_predict_fn(vit, cfg, acfg, policy=bf16,
                                       uint8_inputs=True, mesh=m)
            bank = mb.collect_bank(fn.features_fn, adapter, support,
                                   batch_size=PAR_MB_BATCH)
            zero_counts()
            outs[name] = [bank, *fn(adapter, q, anchors, M, bank)]
            torch.cuda.synchronize()
            if m is not None:
                calls["DP memory-bank predict (world 1)"] = counts()
            del fn
        how = par_same(outs["dp"], outs["single"], "DP mb predict")
        print(f"14a DP memory-bank predict {PAR_MB_SHOT}-shot B="
              f"{PAR_MB_BATCH} at world 1: bank and answers {how}")
        expect(how == "bit for bit", f"DP mb predict {how}")
        del outs
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return calls


def par_kernel_case(route: str, dtype, precision, H: int, gen) -> dict:
    """14b: one route's B1 (forward), B2 (backward) and B3 (V-V) at ``H``
    heads of 64, batch 8, S 1370, against their plain versions at phases
    3-4's bars; returns {kernel: (ms per call, launches)}."""
    import torch

    from aaclip_tpu_torch.ops import attention as A

    B, S, hd = PAR_KERNEL_BATCH, 1370, 64
    dm = H * hd
    qkv = random_qkv(B, S, H, hd, dtype, gen)
    d_out = torch.randn(B, S, dm, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, dm, generator=gen, device="cuda").to(dtype)
    zero_counts()
    got, lse = A.attention_packed(qkv, H, S, return_lse=True,
                                  precision=precision)
    g = A.attention_packed_bwd(qkv, d_out, lse, H, S, precision=precision)
    gv = A.attention_packed_vv(v, H, S, precision=precision)
    torch.cuda.synchronize()
    launched, six, three = counts(), counts_6pass(), counts_3pass()
    expect(launched == (1, 1, 1), f"14b {route} H={H}: launches {launched}")
    expect(six == ((1, 1, 1) if route == "fp32" else (0, 0, 0))
           and three == ((1, 1, 1) if route == "fp32_high" else (0, 0, 0)),
           f"14b {route} H={H}: 6-pass {six}, 3-pass {three}")
    fwd = (got.float() - A.attention_packed_plain(
        qkv, H, S, precision=precision).float()).abs()
    gw = A.attention_packed_bwd_plain(qkv, d_out, H, S, precision=precision)
    vw = A.attention_packed_vv_plain(v, H, S, precision=precision).float()
    dv = (gv.float() - vw).abs()
    bwd_rel = max(((g[..., i * dm:(i + 1) * dm].float()
                    - gw[..., i * dm:(i + 1) * dm].float()).abs().max()
                   / gw[..., i * dm:(i + 1) * dm].float().abs().max()).item()
                  for i in range(3))
    if route == "bf16":
        expect(fwd.max().item() <= BF16_MAX_ABS
               and fwd.mean().item() <= BF16_MEAN_ABS, f"14b B1 {route}")
        expect(bwd_rel <= BWD_BF16_MAX_REL, f"14b B2 {route}: {bwd_rel}")
        expect((dv - VV_BF16_REL * vw.abs()).max().item() <= VV_BF16_ABS
               and dv.mean().item() <= BF16_MEAN_ABS, f"14b B3 {route}")
    else:
        expect(fwd.max().item() <= FP32_MAX_ABS, f"14b B1 {route}")
        expect(bwd_rel <= (BWD_FP32_MAX_REL if route == "fp32"
                           else HIGH_BWD_MAX_REL), f"14b B2 {route}")
        expect(dv.max().item() <= FP32_MAX_ABS, f"14b B3 {route}")
    errs = (fwd.max().item(), bwd_rel, dv.max().item())
    del fwd, gw, vw, dv
    ms = (cuda_ms(lambda: A.attention_packed(qkv, H, S, precision=precision),
                  10),
          cuda_ms(lambda: A.attention_packed_bwd(qkv, d_out, lse, H, S,
                                                 precision=precision), 10),
          cuda_ms(lambda: A.attention_packed_vv(v, H, S,
                                                precision=precision), 10))
    return {"errs": errs, "ms": ms}


def par_kernels(card) -> dict:
    """14b; returns {route: {tp: case}}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(41)
    out = {}
    for route, dtype, precision in (("bf16", torch.bfloat16, None),
                                    ("fp32", torch.float32, None),
                                    ("fp32_high", torch.float32, HIGH)):
        out[route] = {}
        for tp in PAR_TP:
            H = 16 // tp
            case = out[route][tp] = par_kernel_case(route, dtype, precision,
                                                    H, gen)
            print(f"14b {route} tp={tp} ({H} heads, packed width "
                  f"{3 * H * 64}, V width {H * 64}) B={PAR_KERNEL_BATCH}: "
                  f"B1 max|d| {case['errs'][0]:.3e}, B2 {case['errs'][1]:.3e}"
                  f" of max, B3 max|d| {case['errs'][2]:.3e}; ms per call "
                  f"B1 {case['ms'][0]:.4f}, B2 {case['ms'][1]:.4f}, B3 "
                  f"{case['ms'][2]:.4f} (tp=1: "
                  + ", ".join(f"{x:.4f}" for x in out[route][1]['ms'])
                  + f"); 1 launch of each on {card}")
    return out


def _tp_rank(rank: int, port: int, payload: dict, out) -> None:
    """14c: one of two ranks on cuda:0, gloo on CUDA tensors: the TP = 2
    predict (with and without SP) and one TP = 2 stage-2 step in bf16, and
    the same predicts and a step with and without SP in fp32; puts each
    result and its launch counts in ``out``, as numpy (a torch tensor
    sent through the queue would be shared memory the exiting rank takes
    with it)."""
    import os
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        import torch
        import torch.distributed as dist

        from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                                  get_config)
        from aaclip_tpu_torch.core.params import (init_image_adapter,
                                                  init_vision_params)
        from aaclip_tpu_torch.eval.predict import make_predict_fn
        from aaclip_tpu_torch.parallel import sharding as sh
        from aaclip_tpu_torch.train.optim import make_image_optimizer
        from aaclip_tpu_torch.train.steps import make_stage2_step

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # NCCL refuses two ranks on one device: the group is gloo's, on
        # CUDA tensors, and initialize_multihost finds it up
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=2)
        mesh = sh.make_mesh_2d(2, device="cuda:0")
        cfg = get_config("ViT-L-14-336", img_size=518)
        acfg = AdapterConfig()
        vit = init_vision_params(cfg, seed=0)
        adapter = init_image_adapter(cfg, acfg, seed=1)
        t = {k: torch.from_numpy(v).cuda() for k, v in payload.items()}
        batch = [t[k] for k in ("images", "mask", "label", "cidx", "valid")]
        res = {}
        for name, policy in (("bf16", DtypePolicy.bf16()),
                             ("fp32", DtypePolicy.fp32())):
            for sp in (False, True):
                fn = make_predict_fn(vit, cfg, acfg, policy=policy,
                                     uint8_inputs=True, mesh=mesh,
                                     sequence_parallel=sp)
                zero_counts()
                pix, score = fn(adapter, t["u8"], t["anchors"], t["M"])
                torch.cuda.synchronize()
                res[f"{name} predict sp={sp}"] = (
                    pix.cpu().numpy(), score.cpu().numpy(), counts())
                del fn, pix, score
            for sp in ((False,) if name == "bf16" else (False, True)):
                ad = copy.deepcopy(adapter)
                step = make_stage2_step(
                    vit, cfg, acfg, make_image_optimizer(ad.parameters()),
                    t["table"], policy=policy, remat=False, mesh=mesh,
                    sequence_parallel=sp)
                zero_counts()
                loss = float(step(ad, *batch))
                res[f"{name} step sp={sp}"] = (
                    loss, {n: p.grad.cpu().numpy() for n, p in
                           ad.named_parameters()}, counts())
                del step, ad
                torch.cuda.empty_cache()
        dist.destroy_process_group()
        out.put((rank, "ok", res))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def grad_distance(got: dict, want: dict) -> tuple:
    """The largest |got - want| / |want| (norms) over the leaves, its
    leaf's name, and the largest max |got - want| / max |want|."""
    rows = []
    for n, g in got.items():
        g, w = g.double().cpu(), want[n].double().cpu()
        rows.append((((g - w).norm() / w.norm().clamp_min(1e-30)).item(), n,
                     ((g - w).abs().max()
                      / w.abs().max().clamp_min(1e-30)).item()))
    worst = max(rows)
    return worst[0], worst[1], max(r[2] for r in rows)


def par_two_ranks(vit, adapter, cfg, acfg, anchors, M, card, gen) -> dict:
    """14c: TP = 2 (and SP) on two ranks of the one card against the
    single-process predict (phase 4's bars) and step (phase 5's bars) in
    bf16, and against the single-process fp32 predict and step at fp32's
    bars (PAR_TP_FP32_*); returns {path: launches per rank}."""
    import multiprocessing as mp

    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.eval.predict import make_predict_fn

    img = cfg.vision.image_size
    policies = {"bf16": DtypePolicy.bf16(), "fp32": DtypePolicy.fp32()}
    u8 = torch.randint(0, 256, (PAR_TP_PREDICT_BATCH, 3, img, img),
                       generator=gen, device="cuda", dtype=torch.uint8)
    batch = train_batch(PAR_TP_STEP_BATCH, img, gen)
    table = unit_table(cfg.embed_dim, gen)
    images, mask, label, cidx, valid = batch
    payload = {k: v.cpu().numpy() for k, v in dict(
        u8=u8, anchors=anchors, M=M, images=images, mask=mask, label=label,
        cidx=cidx, valid=valid, table=table).items()}
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_tp_rank, args=(r, port, payload, q))
             for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, status, res = q.get(timeout=PAR_CHILD_TIMEOUT)
            expect(status == "ok", f"14c rank {rank} failed:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    calls = {}
    for name, policy in policies.items():
        pix_1, score_1 = make_predict_fn(vit, cfg, acfg, policy=policy,
                                         uint8_inputs=True)(adapter, u8,
                                                            anchors, M)
        pix_1, score_1 = pix_1.cpu(), score_1.cpu()
        span = (pix_1.max() - pix_1.min()).item()
        frac, score_bar = ((PIX_SPAN_FRAC_BF16, SCORE_ATOL_BF16)
                           if name == "bf16" else
                           (PAR_TP_FP32_SPAN_FRAC, SCORE_ATOL_FP32))
        for sp in (False, True):
            key = f"{name} predict sp={sp}"
            expect(np.array_equal(results[1][key][0], results[0][key][0]),
                   f"14c {key}: the ranks' maps differ")
            pix, score, c = results[0][key]
            pix, score = torch.from_numpy(pix), torch.from_numpy(score)
            dpix = (pix - pix_1).abs().max().item()
            dscore = (score - score_1).abs().max().item()
            print(f"14c TP=2{' + SP' if sp else ''} predict {name} B="
                  f"{PAR_TP_PREDICT_BATCH} on two gloo ranks of the card: "
                  f"max|d map| {dpix:.3e} ({dpix / span:.3e} of the span, "
                  f"bar {frac:g}), max|d score| {dscore:.3e} (bar "
                  f"{score_bar:g}) against the single-process predict; "
                  f"launches per rank {c}")
            expect(dpix <= frac * span and dscore <= score_bar,
                   f"14c {key} off")
            expect(c == (cfg.vision.layers, 0, 0), f"14c {key} launches {c}")
            calls[f"TP=2{' SP' if sp else ''} predict {name}, per rank"] = c
        loss_1, g_1, _, _, _ = train_step_once(
            vit, cfg, acfg, adapter, batch, table, policy=policy, remat=False)
        if name == "fp32":
            # the floor: the same step in one process on the plain
            # attention, another summation order alone
            loss_p, g_p, _, _, _ = train_step_once(
                vit, cfg, acfg, adapter, batch, table, policy=policy,
                remat=False, attn_fn=make_attn_fn_plain(
                    cfg.vision.heads, policy, differentiable=True))
            floor = grad_distance(g_p, g_1)
            print(f"14c fp32 floor, the single-process step "
                  f"B={PAR_TP_STEP_BATCH} on the plain attention against "
                  f"the kernels: loss "
                  f"{abs(loss_p - loss_1) / abs(loss_1):.3e} relative, "
                  f"gradient |d| / |g| {floor[0]:.3e} ({floor[1]}), max "
                  f"|d| {floor[2]:.3e} of its max, on {card}")
            del g_p
        for sp in ((False,) if name == "bf16" else (False, True)):
            key = f"{name} step sp={sp}"
            loss, grads, c = results[0][key]
            grads = {n: torch.from_numpy(g) for n, g in grads.items()}
            rel = abs(loss - loss_1) / abs(loss_1)
            what = (f"14c TP=2{' + SP' if sp else ''} stage-2 step {name} "
                    f"B={PAR_TP_STEP_BATCH} remat off on two gloo ranks: "
                    f"loss {rel:.3e} "
                    f"relative")
            if name == "bf16":
                cos = min(torch.nn.functional.cosine_similarity(
                    g.flatten().double(), g_1[n].cpu().flatten().double(),
                    dim=0).item() for n, g in grads.items())
                norm = max(abs(g.norm().item() / g_1[n].norm().item() - 1.0)
                           for n, g in grads.items())
                print(f"{what}, min gradient cosine {cos:.8f}, max |norm "
                      f"ratio - 1| {norm:.3e} against the single-process "
                      f"step; launches per rank {c}")
                ok = (rel <= STEP_LOSS_RTOL and cos >= STEP_GRAD_COS
                      and norm <= STEP_GRAD_NORM_RTOL)
            else:
                worst, leaf, of_max = grad_distance(grads, g_1)
                print(f"{what} (bar {TINY_STEP_LOSS_RTOL:g}), gradient |d| / "
                      f"|g| {worst:.3e} ({leaf}; bar "
                      f"{PAR_TP_FP32_GRAD_NORM_REL:g}, floor {floor[0]:.3e})"
                      f", max |d| {of_max:.3e} of its max, against the "
                      f"single-process step; launches per rank {c}")
                ok = (rel <= TINY_STEP_LOSS_RTOL
                      and worst <= PAR_TP_FP32_GRAD_NORM_REL)
            expect(ok, f"14c {key} off")
            expect(c == (cfg.vision.layers, 0, cfg.vision.layers - 1),
                   f"14c {key} launches {c}")
            calls[f"TP=2{' SP' if sp else ''} stage-2 step {name}, "
                  f"per rank"] = c
        del g_1
        torch.cuda.empty_cache()
    print(f"14c: {wall:.0f} s for both ranks (start-up included, untimed)")
    return calls


def torchrun(args: list, what: str) -> str:
    """``python -m torch.distributed.run --nproc_per_node 1`` ``args`` in
    a child process from the repo root; returns its standard output."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           "1", "--master_addr", "127.0.0.1", "--master_port",
           str(free_port())] + args
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=PAR_CHILD_TIMEOUT)
    expect(out.returncode == 0, f"{what} under torchrun failed "
           f"({out.returncode}):\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout


def par_clis(card, ckpt_path: str) -> None:
    """14d: the evaluation and training CLIs and the bench under
    ``torchrun --nproc_per_node 1`` (one child running all three,
    ``cli_ranks_main``) against the single-process runs."""
    import contextlib
    import gc
    import io
    import os

    import torch

    from aaclip_tpu_torch import bench
    from aaclip_tpu_torch import test as eval_cli
    from aaclip_tpu_torch.core.config import AdapterConfig, get_config
    from aaclip_tpu_torch.core.params import adapter_to_jax, init_image_adapter
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.train import checkpoint as ckpt

    cfg = get_config("ViT-L-14-336", img_size=518)
    tmp = tempfile.mkdtemp(prefix="aaclip_parallel_cli_")
    env_before = {k: os.environ.get(k) for k in ("AACLIP_DATA",
                                                 "AACLIP_METADATA")}
    try:
        data_root, meta_root = make_synthetic_dataset(
            os.path.join(tmp, "set"), class_names=["bottle"],
            n_normal=PAR_CLI_NORMAL, n_anomalous=PAR_CLI_ANOMALOUS,
            img_px=PAR_CLI_PX, hard=True)
        os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
        tree = adapter_to_jax(init_image_adapter(cfg, AdapterConfig(),
                                                 seed=9, device="cpu"))
        save = {}
        for k in ("single", "dp"):
            save[k] = os.path.join(tmp, f"eval_{k}")
            ckpt.save_adapter_checkpoint(
                os.path.join(save[k], "image_adapter_1.npz"), 1, tree)
        argv = ["--clip_checkpoint", ckpt_path, "--precision", "bf16",
                "--batch_size", str(PAR_CLI_BATCH), "--csv",
                "--dump_scores"]
        targv = ["--clip_checkpoint", ckpt_path, "--dataset", "MVTec",
                 "--training_mode", "full_shot", "--text_epoch", "1",
                 "--image_epoch", "1", "--text_batch_size",
                 str(PAR_CLI_BATCH), "--image_batch_size",
                 str(PAR_CLI_BATCH), "--precision", "bf16"]
        bargv = ["--steps", "5"]
        t0 = time.perf_counter()
        out = torchrun([os.path.abspath(__file__), "--parallel-clis",
                        json.dumps({
                            "test": argv + ["--data_parallel", "--save_path",
                                            save["dp"]],
                            "train": targv + ["--data_parallel",
                                              "--save_path",
                                              os.path.join(tmp, "t_dp")],
                            "bench": bargv + ["--data_parallel"]})],
                       "the CLIs")
        child_s = time.perf_counter() - t0
        lines = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1])
                 for ln in out.splitlines()
                 if ln.startswith(("CLI_LOSSES ", "BENCH_LINE "))}

        eval_cli.main(argv + ["--save_path", save["single"]])
        same = {f: read_csv(os.path.join(save["dp"], f))
                == read_csv(os.path.join(save["single"], f))
                for f in ("results_1.csv", "scores_1.csv")}
        print(f"14d test --data_parallel under torchrun (1 rank), bf16 B="
              f"{PAR_CLI_BATCH}, one class of "
              f"{PAR_CLI_NORMAL + PAR_CLI_ANOMALOUS} images: table and "
              f"scores bit for bit the single-process CLI's: {same}")
        expect(all(same.values()), f"14d test --data_parallel: {same}")
        gc.collect()
        torch.cuda.empty_cache()

        single = train_cli_losses(targv + ["--save_path",
                                           os.path.join(tmp, "t_single")])
        dp = lines["CLI_LOSSES"]
        expect([len(e) for e in dp] == [len(e) for e in single],
               f"14d train: steps {dp} vs {single}")
        how = [par_same(a, b, "14d train loss") for a, b in
               zip(sum(dp, []), sum(single, []))]
        print(f"14d train --data_parallel under torchrun (1 rank), one text"
              f" and one image epoch, bf16 batch {PAR_CLI_BATCH}: per-step "
              f"losses {dp} against {single}: "
              f"{'bit for bit' if set(how) == {'bit for bit'} else how}")
        gc.collect()
        torch.cuda.empty_cache()

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench.main(bargv)
        plain = json.loads(buf.getvalue().strip().splitlines()[-1])
        line = lines["BENCH_LINE"]
        print(f"14d bench --data_parallel under torchrun (1 rank): "
              f"{line['value']} maps/s/card ({line['unit']}) beside the "
              f"plain bench's {plain['value']} maps/s; the torchrun child "
              f"ran the three in {child_s:.0f} s on {card}")
        expect(line["value"] > 0 and "dp=1 cards" in line["unit"],
               f"14d bench line {line}")
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


def par_engine_answers(engine, imgs, classes) -> list:
    """Each image submitted alone (one bucket-1 batch each), in order."""
    return [engine.submit(im, "MVTec", c, timeout=120)
            for im, c in zip(imgs, classes)]


def par_timed_answers(engine, imgs, classes) -> tuple:
    """``par_engine_answers`` and the engine's mean dispatch ms (its /statz
    "dispatch" phase: the host's upload and launch of a micro-batch) over
    the batches these requests made."""
    def total():  # /statz rounds its total to ms: read the sum itself
        with engine._stats_lock:
            return list(engine._phase_total.get("dispatch", (0, 0.0)))

    n0, ms0 = total()
    answers = par_engine_answers(engine, imgs, classes)
    n1, ms1 = total()
    return answers, (ms1 - ms0) / (n1 - n0)


def par_same_answers(got, want, what: str) -> None:
    import numpy as np

    same = all(np.array_equal(g[0], w[0]) and g[1] == w[1]
               for g, w in zip(got, want))
    print(f"14e {what}: {len(got)} answers bit for bit the engine's without "
          f"data_parallel: {same}")
    expect(same, f"14e {what}: answers differ")


def par_dispatch_ms(engine, imgs, split: bool = False) -> float:
    """The median host ms of one micro-batch's dispatch (upload and
    launches, not waited on; the card synchronised between calls) over
    PAR_DISPATCH_CALLS after 3 warm-up calls: ``engine._dispatch``, or
    with ``split`` the micro-batch halved over the engine's two replicas
    and concatenated, as JAX's live engine splits it."""
    import statistics

    import numpy as np
    import torch

    from aaclip_tpu_torch.serve import server

    a0 = np.asarray(next(iter(engine.anchors["MVTec"].values())))
    anch = np.tile(a0[None], (len(imgs), 1, 1))

    def split_dispatch():
        outs, h = [], len(imgs) // 2
        for i, d in enumerate(engine._replicas):
            part = slice(i * h, (i + 1) * h)
            with server._device_context(d):
                outs.append(engine._replica_fns[i](
                    engine._upload(imgs[part], d),
                    engine._upload(anch[part], d),
                    engine._postproc_rep[i]["MVTec"]))
        return tuple(torch.cat([o[k] for o in outs]) for k in (0, 1))

    fn = split_dispatch if split else \
        (lambda: engine._dispatch(imgs, anch, "MVTec"))
    times = []
    with engine._device_guard(), torch.inference_mode():
        for k in range(3 + PAR_DISPATCH_CALLS):
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
            torch.cuda.synchronize()
            if k >= 3:
                times.append(dt * 1e3)
    return statistics.median(times)


def par_serving(card, ckpt_path: str) -> None:
    """14e, the live half: the engine with ``data_parallel=True`` on one
    replica and on two replicas of the card (``device=["cuda:0",
    "cuda:0"]``: whole micro-batches round-robin) against the engine
    without it, every answer bit for bit; prints each engine's dispatch ms
    per micro-batch, served (bucket 1) and direct at PAR_DISPATCH_BATCH,
    and, on the two replicas, what a split micro-batch's dispatch costs."""
    import gc

    import numpy as np
    import torch

    from aaclip_tpu_torch.serve import server

    rng = np.random.default_rng(15)
    imgs = rng.integers(0, 256, (6, 3, 518, 518), dtype=np.uint8)
    classes = [SERVE_CLASSES[i % 3] for i in range(6)]
    batch = rng.integers(0, 256, (PAR_DISPATCH_BATCH, 3, 518, 518),
                         dtype=np.uint8)
    answers, ms, direct = {}, {}, {}
    for name, n_rep, kw in (
            ("one card", None, {}),
            ("one replica", 1, {"data_parallel": True}),
            ("two replicas on cuda:0", 2,
             {"data_parallel": True, "device": ["cuda:0", "cuda:0"]})):
        engine = server.InferenceEngine(
            clip_checkpoint=ckpt_path, precision="bf16", max_batch=4,
            anchor_cache=None, **kw)
        try:
            expect(n_rep is None or len(engine._replicas) == n_rep,
                   "14e replicas")
            answers[name], ms[name] = par_timed_answers(engine, imgs,
                                                        classes)
            direct[name] = par_dispatch_ms(engine, batch)
            if n_rep == 2:
                direct["split over the two replicas"] = par_dispatch_ms(
                    engine, batch, split=True)
        finally:
            engine.shutdown()
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    for name in ("one replica", "two replicas on cuda:0"):
        par_same_answers(answers[name], answers["one card"],
                         f"live engine, {name}, on {card}")
    print("14e live engine dispatch ms per micro-batch (bucket 1, "
          f"{len(imgs)} requests alone): "
          + ", ".join(f"{n} {v:.2f}" for n, v in ms.items()) + f" on {card}")
    print(f"14e live engine dispatch ms of a micro-batch of "
          f"{PAR_DISPATCH_BATCH} (median of {PAR_DISPATCH_CALLS}): "
          + ", ".join(f"{n} {v:.2f}" for n, v in direct.items())
          + f" on {card}")


def phase_parallel(vit, adapter, cfg, acfg, anchors, M, card, gen,
                   ckpt_path: str) -> dict:
    """Phase 14 (14e's artifact half runs in phase 13d, where its artifact
    lives); returns {kernel: {path: launches}}."""
    t_phase = time.perf_counter()
    world1 = par_world1(vit, adapter, cfg, acfg, anchors, M, card, gen)
    print(f"[{time.perf_counter() - t_phase:.0f} s] 14b")
    par_kernels(card)
    print(f"[{time.perf_counter() - t_phase:.0f} s] 14c")
    two = par_two_ranks(vit, adapter, cfg, acfg, anchors, M, card, gen)
    print(f"[{time.perf_counter() - t_phase:.0f} s] 14d")
    par_clis(card, ckpt_path)
    print(f"[{time.perf_counter() - t_phase:.0f} s] 14e")
    par_serving(card, ckpt_path)
    print(f"phase 14 (parallel) took {time.perf_counter() - t_phase:.0f} s")
    calls = {"attention_packed": {}, "attention_packed_vv": {},
             "attention_packed_bwd": {}}
    for path, (fwd, vv, bwd) in {**world1, **two}.items():
        for name, n in (("attention_packed", fwd),
                        ("attention_packed_vv", vv),
                        ("attention_packed_bwd", bwd)):
            if n:
                calls[name][path] = n
    return calls


# ---------------------------------------------------------------------------
# Phase 15: the GPipe pipeline (aaclip_tpu_torch/parallel/pipeline.py), the
# visualization panels and the object facades

# 15a-c: two ranks on the one card (gloo on CUDA tensors; a hop goes
# through a pinned host buffer), pp = 2 at ViT-L/518, full depth. bf16
# paths at phases 4, 5 and 7's bars. The fp32 predict differs from the
# single-process one only where it sums the level maps (two stage halves
# added by the all-reduce) and in the microbatches' GEMM shapes (cuBLAS
# may pick another kernel at batch 4 than at 8): ~1e-7 relative, so the
# bar, set before the first run, is 1e-5 of the span (14c's TP map, whose
# products split, read 1.9e-6) and scores within 1e-5.
PP_BATCH, PP_MICRO = 8, (2, 4)
PP_FP32_SPAN_FRAC, PP_FP32_SCORE_ATOL = 1e-5, 1e-5
PP_STEP_BATCH, PP_FP32_STEP_BATCH, PP_S1_BATCH = 8, 4, 4
# one Adam step moves an entry by at most lr (its first update is lr times
# g / (|g| + eps)), so two steps whose gradients' signs differ on a
# near-zero entry end at most 2 lr apart
PP_LR = 5e-4
PP_TIMED_CALLS, PP_HOPS = 5, 10
# 15d: the visualization run's synthetic class (8 images)
PP_VIS_NORMAL, PP_VIS_ANOMALOUS, PP_VIS_PX = 4, 4, 256


def _pp_rank(rank: int, port: int, payload: dict, out) -> None:
    """15a-c: one of two ranks on cuda:0 (gloo on CUDA tensors): the pp =
    2 predicts, stage-2 steps and stage-1 features, each with its launches
    per rank, the ms per timed predict and per hop; puts numpy results in
    ``out``."""
    import os
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        import torch
        import torch.distributed as dist

        from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                                  get_config)
        from aaclip_tpu_torch.core.params import (init_image_adapter,
                                                  init_vision_params)
        from aaclip_tpu_torch.parallel import pipeline as ppl
        from aaclip_tpu_torch.train.optim import make_image_optimizer

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=2)
        mesh = ppl.make_pp_mesh(2, device="cuda:0")
        cfg = get_config("ViT-L-14-336", img_size=518)
        acfg = AdapterConfig()
        vit = init_vision_params(cfg, seed=0)
        adapter = init_image_adapter(cfg, acfg, seed=1)
        t = {k: torch.from_numpy(v).cuda() for k, v in payload.items()}
        pols = {"bf16": DtypePolicy.bf16(), "fp32": DtypePolicy.fp32()}
        res = {}
        for name, policy in pols.items():
            for n_micro in PP_MICRO:
                fn = ppl.make_pipeline_predict_fn(
                    vit, cfg, acfg, pp=2, n_micro=n_micro, policy=policy,
                    mesh=mesh)
                zero_counts()
                pix, score = fn(adapter, t["images"], t["anchors"], t["M"])
                torch.cuda.synchronize()
                res[f"predict {name} n_micro={n_micro}"] = (
                    pix.cpu().numpy(), score.cpu().numpy(), counts())
                if name == "bf16" and n_micro == PP_MICRO[0]:
                    ms = []
                    for _ in range(PP_TIMED_CALLS):
                        dist.barrier()
                        t0 = time.perf_counter()
                        fn(adapter, t["images"], t["anchors"], t["M"])
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t0) * 1e3)
                    res["predict ms"] = sorted(ms)[len(ms) // 2]
                del fn, pix, score
        # one hop of a microbatch's bf16 and fp32 stream, both ways
        hops = ppl._Hops(mesh)
        S = cfg.vision.grid ** 2 + 1
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(PP_BATCH // 2, S, cfg.vision.width,
                            device="cuda").to(dt)
            ms = []
            for _ in range(PP_HOPS):
                dist.barrier()
                t0 = time.perf_counter()
                if rank == 0:
                    hops.send(x, 1)
                    x = hops.recv(x.shape, dt, 1)
                else:
                    x = hops.recv(x.shape, dt, 0)
                    hops.send(x, 0)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3 / 2)
            res[f"hop ms {str(dt)[6:]}"] = sorted(ms)[len(ms) // 2]
        for name, remat, rows in (("bf16", False, PP_STEP_BATCH),
                                  ("bf16", True, PP_STEP_BATCH),
                                  ("fp32", False, PP_FP32_STEP_BATCH)):
            ad = copy.deepcopy(adapter)
            step = ppl.make_pp_stage2_step(
                vit, cfg, acfg, make_image_optimizer(ad.parameters(),
                                                     lr=PP_LR),
                t["table"], pp=2, n_micro=2, policy=pols[name],
                remat=remat, mesh=mesh)
            zero_counts()
            loss = float(step(ad, *(t[k][:rows] for k in (
                "images", "mask", "label", "cidx", "valid"))))
            res[f"step {name} remat={remat}"] = (
                loss, {n: p.grad.cpu().numpy() for n, p in
                       ad.named_parameters()},
                {n: p.detach().cpu().numpy() for n, p in
                 ad.named_parameters()}, counts())
            del step, ad
            torch.cuda.empty_cache()
        for mode in ("spatial", "batch"):
            fn = ppl.make_pp_stage1_features_fn(
                vit, cfg, pp=2, n_micro=2, policy=pols["bf16"],
                vv_mode=mode, mesh=mesh)
            zero_counts()
            feats = fn(t["images"][:PP_S1_BATCH])
            torch.cuda.synchronize()
            res[f"features {mode}"] = (feats.cpu().numpy(), counts())
            del fn, feats
        res["coords"] = (mesh.stage_rank, mesh.data_rank)
        dist.destroy_process_group()
        out.put((rank, "ok", res))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def pp_reference_step(vit, cfg, acfg, adapter, batch, table, policy):
    """The single-process stage-2 step with ``grad_accum = 2`` from a copy
    of ``adapter`` (the pipeline's reference): (loss, grads, updated
    entries)."""
    from aaclip_tpu_torch.train.optim import make_image_optimizer
    from aaclip_tpu_torch.train.steps import make_stage2_step

    ad = copy.deepcopy(adapter)
    step = make_stage2_step(vit, cfg, acfg,
                            make_image_optimizer(ad.parameters(), lr=PP_LR),
                            table, policy=policy, remat=False, grad_accum=2)
    loss = float(step(ad, *batch))
    return loss, {n: p.grad.detach().cpu() for n, p in
                  ad.named_parameters()}, \
        {n: p.detach().cpu() for n, p in ad.named_parameters()}


def pp_two_ranks(vit, adapter, cfg, acfg, anchors, M, card, gen) -> dict:
    """15a-c: the pp = 2 paths on two ranks of the card against their
    single-process paths; returns {path: launches per rank (rank 0's,
    rank 1's)}."""
    import multiprocessing as mp

    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.train.steps import stage1_features_fn

    img, L = cfg.vision.image_size, cfg.vision.layers
    batch = train_batch(PP_BATCH, img, gen)
    table = unit_table(cfg.embed_dim, gen)
    images, mask, label, cidx, valid = batch
    payload = {k: v.cpu().numpy() for k, v in dict(
        images=images, anchors=anchors, M=M, mask=mask, label=label,
        cidx=cidx, valid=valid, table=table).items()}
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_pp_rank, args=(r, port, payload, q))
             for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, status, res = q.get(timeout=PAR_CHILD_TIMEOUT)
            expect(status == "ok", f"15 rank {rank} failed:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    expect([results[r]["coords"] for r in (0, 1)] == [(0, 0), (1, 0)],
           "15: rank d * pp + s is not stage s")
    pols = {"bf16": DtypePolicy.bf16(), "fp32": DtypePolicy.fp32()}
    calls = {}

    def per_rank(key, idx=-1):
        return tuple(results[r][key][idx] for r in (0, 1))

    # 15a: the predicts
    for name, policy in pols.items():
        fn = make_predict_fn(vit, cfg, acfg, policy=policy)
        pix_1, score_1 = fn(adapter, images, anchors, M)
        torch.cuda.synchronize()
        if name == "bf16":
            ms1 = []
            for _ in range(PP_TIMED_CALLS):
                t1 = time.perf_counter()
                fn(adapter, images, anchors, M)
                torch.cuda.synchronize()
                ms1.append((time.perf_counter() - t1) * 1e3)
            ms_single = sorted(ms1)[len(ms1) // 2]
        del fn
        pix_1, score_1 = pix_1.cpu(), score_1.cpu()
        span = (pix_1.max() - pix_1.min()).item()
        frac, score_bar = ((PIX_SPAN_FRAC_BF16, SCORE_ATOL_BF16)
                           if name == "bf16" else
                           (PP_FP32_SPAN_FRAC, PP_FP32_SCORE_ATOL))
        for n_micro in PP_MICRO:
            key = f"predict {name} n_micro={n_micro}"
            expect(np.array_equal(results[1][key][0], results[0][key][0])
                   and np.array_equal(results[1][key][1],
                                      results[0][key][1]),
                   f"15a {key}: the ranks' results differ")
            pix, score = (torch.from_numpy(a) for a in results[0][key][:2])
            dpix = (pix - pix_1).abs().max().item()
            dscore = (score - score_1).abs().max().item()
            c = per_rank(key)
            print(f"15a pp=2 predict {name} B={PP_BATCH} n_micro={n_micro} "
                  f"on two gloo ranks of the card: max|d map| {dpix:.3e} "
                  f"({dpix / span:.3e} of the span, bar {frac:g}), max|d "
                  f"score| {dscore:.3e} (bar {score_bar:g}) against the "
                  f"single-process predict; launches (fwd, V-V, bwd) per "
                  f"rank {c}")
            expect(dpix <= frac * span and dscore <= score_bar,
                   f"15a {key} off")
            want = (L // 2 * n_micro, 0, 0)
            expect(c == (want, want), f"15a {key} launches {c}")
            calls[f"pp=2 predict {name} n_micro={n_micro}, per rank"] = \
                want[0]
    print(f"15a pp=2 bf16 predict B={PP_BATCH} n_micro={PP_MICRO[0]}: "
          f"{results[0]['predict ms']:.2f} ms a call (median of "
          f"{PP_TIMED_CALLS}, both ranks on the one card, hops through the "
          f"host) against {ms_single:.2f} ms in one process; one hop of a "
          f"[{PP_BATCH // 2}, {cfg.vision.grid ** 2 + 1}, "
          f"{cfg.vision.width}] stream {results[0]['hop ms bfloat16']:.3f} "
          f"ms bf16, {results[0]['hop ms float32']:.3f} ms fp32 (median of "
          f"{PP_HOPS} round trips / 2) on {card}; readings, not claims")

    # 15b: the stage-2 steps against grad_accum = 2 in one process
    for name, remat, rows in (("bf16", False, PP_STEP_BATCH),
                              ("bf16", True, PP_STEP_BATCH),
                              ("fp32", False, PP_FP32_STEP_BATCH)):
        key = f"step {name} remat={remat}"
        sub = tuple(x[:rows] for x in batch)
        if not remat:
            ref = pp_reference_step(vit, cfg, acfg, adapter, sub, table,
                                    pols[name])
        loss, grads, params, _ = results[0][key]
        expect(results[1][key][0] == loss, f"15b {key}: the ranks' losses")
        grads = {n: torch.from_numpy(g) for n, g in grads.items()}
        rel = abs(loss - ref[0]) / abs(ref[0])
        moved = max((torch.from_numpy(p) - ref[2][n]).abs().max().item()
                    for n, p in params.items())
        c = per_rank(key)
        what = (f"15b pp=2 stage-2 step {name} B={rows} n_micro=2 remat "
                f"{'full' if remat else 'off'}: loss {rel:.3e} relative")
        if name == "bf16":
            cos = min(torch.nn.functional.cosine_similarity(
                g.flatten().double(), ref[1][n].flatten().double(),
                dim=0).item() for n, g in grads.items())
            norm = max(abs(g.norm().item() / ref[1][n].norm().item() - 1.0)
                       for n, g in grads.items())
            print(f"{what}, min gradient cosine {cos:.8f}, max |norm ratio "
                  f"- 1| {norm:.3e}, updated entries within {moved:.3e} "
                  f"(bar {2 * PP_LR:g}) of the single-process grad_accum=2 "
                  f"step's; launches per rank {c}")
            ok = (rel <= STEP_LOSS_RTOL and cos >= STEP_GRAD_COS
                  and norm <= STEP_GRAD_NORM_RTOL)
        else:
            worst, leaf, of_max = grad_distance(grads, ref[1])
            print(f"{what} (bar {TINY_STEP_LOSS_RTOL:g}), gradient |d| / |g| "
                  f"{worst:.3e} ({leaf}; bar {PAR_TP_FP32_GRAD_NORM_REL:g}), "
                  f"max |d| {of_max:.3e} of its max, updated entries within "
                  f"{moved:.3e} (bar {2 * PP_LR:g}) of the single-process "
                  f"grad_accum=2 step's; launches per rank {c}")
            ok = (rel <= TINY_STEP_LOSS_RTOL
                  and worst <= PAR_TP_FP32_GRAD_NORM_REL)
        expect(ok and moved <= 2 * PP_LR * 1.001, f"15b {key} off")
        # stage 0: block 0's input carries no gradient (23 = 24 - 1 in one
        # process); full remat reruns each block whose input carries one
        fwd0, fwd1 = ((L // 2 + (L // 2 - 1 if remat else 0)) * 2,
                      (L // 2 + (L // 2 if remat else 0)) * 2)
        want = ((fwd0, 0, (L // 2 - 1) * 2), (fwd1, 0, L // 2 * 2))
        expect(c == want, f"15b {key} launches {c}, want {want}")
        calls[f"pp=2 stage-2 step {name} remat "
              f"{'full' if remat else 'off'}, per rank"] = c
        torch.cuda.empty_cache()

    # 15c: the stage-1 features (bf16) against the single process
    x = images[:PP_S1_BATCH]
    policy = pols["bf16"]
    want_f = {
        "spatial": stage1_features_fn(vit, cfg, policy=policy,
                                      vv_mode="spatial")(x),
        "batch": torch.cat([stage1_features_fn(vit, cfg, policy=policy)(h)
                            for h in x.chunk(2)])}
    vv_start = 5  # surgery_vv_start(24, 20)
    for mode, ref in want_f.items():
        key = f"features {mode}"
        got = torch.from_numpy(results[0][key][0]).cuda()
        expect(np.array_equal(results[1][key][0], results[0][key][0]),
               f"15c {key}: the ranks' features differ")
        dmax = (got - ref).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(
            got.double(), ref.double(), dim=-1).min().item()
        c = per_rank(key)
        # stage 0: the shared blocks and both tails' first blocks; stage 1
        # both tails whole; batch mode's V-V is plain
        vv0, vv1 = ((L // 2 - vv_start) * 2, L // 2 * 2) \
            if mode == "spatial" else (0, 0)
        want = ((L // 2 * 2, vv0, 0), (L // 2 * 2, vv1, 0))
        print(f"15c pp=2 stage-1 features {mode} bf16 B={PP_S1_BATCH} "
              f"n_micro=2: max|d| {dmax:.3e}, least per-token cosine "
              f"{cos:.8f} (phase 7's bars {S1_FEAT_MAX_ABS:g}, "
              f"{S1_FEAT_COS:g}) against the single process"
              + (" run per microbatch" if mode == "batch" else "")
              + f"; launches per rank {c}")
        expect(dmax <= S1_FEAT_MAX_ABS and cos >= S1_FEAT_COS,
               f"15c {key} off")
        expect(c == want, f"15c {key} launches {c}, want {want}")
        calls[f"pp=2 stage-1 features {mode}, per rank"] = c
    print(f"15a-c: {wall:.0f} s for both ranks (start-up included)")
    return calls


def cv2_panel(cv2, np, path: str, gt_u8, pr_u8):
    """The JAX package's panel through cv2 (``aaclip_tpu/eval/
    visualize.py``'s read, resize, colour map and blend)."""
    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    img = cv2.resize(img, (gt_u8.shape[1], gt_u8.shape[0]))

    def over(m):
        c = cv2.applyColorMap(cv2.cvtColor(m, cv2.COLOR_GRAY2RGB),
                              cv2.COLORMAP_JET)
        return (0.5 * img + 0.5 * c).astype(np.uint8)

    return np.vstack([img, over(gt_u8), over(pr_u8)])


def pp_clis(card, ckpt_path: str) -> None:
    """15d: both CLIs' ``--pipeline_parallel 2`` in one process (JAX's
    exit), then ``test --visualize`` on a synthetic class of 8 images: one
    panel each, the image and mask rows bit for bit cv2's; and
    ``visualize`` on random maps, each whole panel bit for bit cv2's."""
    import os

    import numpy as np

    from aaclip_tpu_torch import test as eval_cli
    from aaclip_tpu_torch.core.config import AdapterConfig, get_config
    from aaclip_tpu_torch.core.params import adapter_to_jax, init_image_adapter
    from aaclip_tpu_torch.data.registry import DATASETS
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.data.transforms import load_mask_binarized
    from aaclip_tpu_torch.eval.visualize import visualize
    from aaclip_tpu_torch.train import cli as train_cli

    for name, module in (("test", eval_cli), ("train", train_cli)):
        try:
            module.main(["--pipeline_parallel", "2", "--save_path",
                         "/nonexistent/pp"])
            expect(False, f"15d {name} --pipeline_parallel 2 ran at world 1")
        except SystemExit as e:
            expect("exceeds the 1 available devices" in str(e),
                   f"15d {name}: {e}")
            print(f"15d {name} --pipeline_parallel 2 in one process exits "
                  f"as JAX's: {e}")
    cfg = get_config("ViT-L-14-336", img_size=518)
    img = cfg.vision.image_size
    tmp = tempfile.mkdtemp(prefix="aaclip_visualize_")
    env_before = {k: os.environ.get(k) for k in ("AACLIP_DATA",
                                                 "AACLIP_METADATA")}
    try:
        data_root, meta_root = make_synthetic_dataset(
            os.path.join(tmp, "set"), class_names=["bottle"],
            n_normal=PP_VIS_NORMAL, n_anomalous=PP_VIS_ANOMALOUS,
            img_px=PP_VIS_PX, hard=True)
        os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
        save = os.path.join(tmp, "eval")
        ckpt_tree = adapter_to_jax(init_image_adapter(cfg, AdapterConfig(),
                                                      seed=9, device="cpu"))
        from aaclip_tpu_torch.train import checkpoint as ckpt

        ckpt.save_adapter_checkpoint(
            os.path.join(save, "image_adapter_1.npz"), 1, ckpt_tree)
        t0 = time.perf_counter()
        eval_cli.main(["--clip_checkpoint", ckpt_path, "--precision", "bf16",
                       "--batch_size", "8", "--visualize", "--save_path",
                       save])
        cli_s = time.perf_counter() - t0
        out = os.path.join(save, "visualization", "MVTec", "bottle")
        names = sorted(os.listdir(out))
        n_img = PP_VIS_NORMAL + PP_VIS_ANOMALOUS
        expect(len(names) == n_img, f"15d --visualize wrote {names}")
        try:
            import cv2
        except ImportError:
            cv2 = None
        base = DATASETS["MVTec"].data_path
        rels = []
        for rel_dir in ("bottle/test/good", "bottle/test/defect"):
            d = os.path.join(base, rel_dir)
            if os.path.isdir(d):
                rels += [f"{rel_dir}/{f}" for f in sorted(os.listdir(d))]
        expect(sorted(r.replace("/", "_") for r in rels) == names,
               f"15d panel names {names} vs {rels}")
        from aaclip_tpu_torch.data.image import load_rgb

        rows_equal = 0
        for rel in rels:
            panel = load_rgb(os.path.join(out, rel.replace("/", "_")))
            expect(panel.shape == (3 * img, img, 3),
                   f"15d panel {rel} {panel.shape}")
            if cv2 is None:
                continue
            got = cv2.imread(os.path.join(out, rel.replace("/", "_")))
            mpath = os.path.join(base, rel.replace("/test/", "/ground_truth/")
                                 .replace(".png", "_mask.png"))
            gt = (load_mask_binarized(mpath, img)[0] * 255).astype(np.uint8) \
                if os.path.exists(mpath) else np.zeros((img, img), np.uint8)
            want = cv2_panel(cv2, np, os.path.join(base, rel), gt, gt)
            expect(np.array_equal(got[:2 * img], want[:2 * img]),
                   f"15d {rel}: the image or mask rows differ from cv2's")
            rows_equal += 1
        # every row of a panel against cv2's, on random maps
        rng = np.random.default_rng(0)
        preds = rng.random((n_img, img, img)).astype(np.float32)
        masks = (rng.random((n_img, img, img)) > 0.9).astype(np.float32)
        vdir = os.path.join(tmp, "direct")
        visualize(masks, preds, rels, vdir, "MVTec", "bottle")
        whole = 0
        if cv2 is not None:
            p8 = (preds.astype(np.float64) - preds.min()) \
                / (preds.max() - preds.min())
            p8 = (p8 * 255).astype(np.uint8)
            for i, rel in enumerate(rels):
                got = cv2.imread(os.path.join(vdir, "visualization", "MVTec",
                                              "bottle",
                                              rel.replace("/", "_")))
                want = cv2_panel(cv2, np, os.path.join(base, rel),
                                 ((masks[i] != 0) * 255).astype(np.uint8),
                                 p8[i])
                expect(np.array_equal(got, want),
                       f"15d {rel}: the panel differs from cv2's")
                whole += 1
        print(f"15d test --visualize (bf16, batch 8) on a class of {n_img} "
              f"synthetic images at {PP_VIS_PX} px: {len(names)} panels of "
              f"{(3 * img, img, 3)}, the image and mask rows of "
              f"{rows_equal} bit for bit cv2's, and {whole} whole panels of "
              f"random maps bit for bit cv2's"
              + ("" if cv2 else " (cv2 does not import here: not compared)")
              + f"; the CLI ran in {cli_s:.1f} s on {card}")
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


def pp_facades(cfg, card) -> dict:
    """15e: ``AdaptedCLIP.create`` at ViT-L/518 on the card: ``forward``
    bit for bit ``adapted_forward`` on its own towers, 24 B1 launches."""
    import torch

    from aaclip_tpu_torch.core.config import AdapterConfig
    from aaclip_tpu_torch.models.clip import AdaptedCLIP
    from aaclip_tpu_torch.models.vit import adapted_forward

    acfg = AdapterConfig()
    model = AdaptedCLIP.create(cfg, acfg, seed=3)
    x = torch.randn(2, 3, cfg.vision.image_size, cfg.vision.image_size,
                    generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    zero_counts()
    seg, det = model(x)
    torch.cuda.synchronize()
    c = counts()
    with torch.no_grad():
        seg_f, det_f = adapted_forward(
            model.clip.visual, model.adapters["image"], cfg, x,
            image_adapt_weight=acfg.image_adapt_weight, levels=acfg.levels)
    same = all(torch.equal(a, b) for a, b in zip(seg, seg_f)) \
        and torch.equal(det, det_f)
    scale = float(model.clip.logit_scale)
    print(f"15e AdaptedCLIP.create at ViT-L/518: forward bit for bit "
          f"adapted_forward: {same}; launches {c}; logit_scale "
          f"{scale:.6f} on {card}")
    expect(same and c == (cfg.vision.layers, 0, 0), f"15e off: {same} {c}")
    expect(abs(scale - 1 / 0.07) < 1e-4, f"15e logit_scale {scale}")
    del model
    torch.cuda.empty_cache()
    return {"AdaptedCLIP.forward": c}


def phase_pipeline(vit, adapter, cfg, acfg, anchors, M, card, gen,
                   ckpt_path: str) -> dict:
    """Phase 15; returns {kernel: {path: launches}}."""
    t_phase = time.perf_counter()
    two = pp_two_ranks(vit, adapter, cfg, acfg, anchors, M, card, gen)
    print(f"[{time.perf_counter() - t_phase:.0f} s] 15d")
    pp_clis(card, ckpt_path)
    print(f"[{time.perf_counter() - t_phase:.0f} s] 15e")
    facade = pp_facades(cfg, card)
    print(f"phase 15 (pipeline, visualization, facades) took "
          f"{time.perf_counter() - t_phase:.0f} s")
    calls = {"attention_packed": {}, "attention_packed_vv": {},
             "attention_packed_bwd": {}}
    for path, c in {**two, **facade}.items():
        if isinstance(c, int):  # the predicts' B1 launches per rank
            calls["attention_packed"][path] = c
            continue
        per = c if isinstance(c[0], tuple) else (c,)
        for i, name in enumerate(("attention_packed", "attention_packed_vv",
                                  "attention_packed_bwd")):
            ns = tuple(r[i] for r in per)
            if any(ns):
                calls[name][path] = ns if len(ns) > 1 else ns[0]
    return calls


# Phase 16: the practitioner tools and examples (aaclip_tpu_torch/tools,
# aaclip_tpu_torch/examples), each through its main() as a user runs it
# with ``python -m``. (a) predict_folder at ViT-L-14-336 @ 518, bf16,
# batch 8, on 12 seeded PNGs of TOOL_SIZES (the last batch padded, as the
# tool pads it), from phase 9's seeded checkpoint (AACLIP_CKPT) and seeded
# npz adapters under --save_path: every scores.csv row bit for bit the
# score of a direct make_predict_fn on the same loaded towers, adapters,
# anchors and decoded batch; 24 B1 launches per batch and no other kernel;
# a [518, 518, 3] heatmap per image; images/s over the whole main()
# (start-up included: the towers, the anchors, the decode, the heatmaps).
# (b) predict_folder --artifact on phase 13's ViT-L int8 artifact (bucket
# 8, seeded adapters; one program, so each of its two loads here takes
# ~8 s, less than the bf16 artifact's): every row bit
# for bit the artifact's predict_class on the same batch, 24 B1 launches
# per call. (c) zero_shot at ViT-L @ 518 on one image: its printed score
# equals the direct predict's, formatted alike. (d) few_shot_soak at
# tiny-test, --shots 2 4 --memory_bank (a bank is built from the normal
# images of the K-shot file, and the tool's 1-shot draw holds no normal
# bottle), one text and one image epoch each: FEW-SHOT SOAK OK, B1 and B2
# launched. (e) precision_ab at tiny-test, bf16 against int8 (the tool's
# 2 classes of 16 + 16 images, one epoch of each stage): PRECISION A/B OK,
# each column's distance printed beside its allowance. It passes with no
# margin (image AUC 3 flips of 3), the same bits in every run; a size with
# margin does not exist for this pair: the allowance is 3 flips whatever
# the size while the flips grow with the pairs, and at the tool's defaults
# (ViT-L) int8 fails the gate (PERF.md, Findings). (f) serve_smoke against
# the port's server in a child process on the card (ViT-L @ 518, bf16,
# random weights, its anchor cache in a temporary directory): SERVE HTTP
# SMOKE OK.
TOOL_SIZES = [(518, 518), (1024, 1024), (700, 900), (333, 480), (800, 600),
              (1024, 768), (256, 256), (600, 600), (900, 900), (480, 640),
              (1000, 500), (518, 700)]
TOOL_BATCH = 8


def tool_output(fn, argv, what: str, **kw) -> str:
    """``fn(argv, **kw)``'s standard output, captured, and its last line
    printed; all of it printed when ``fn`` raises."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            fn(argv, **kw)
    except BaseException:
        print(f"{what} failed; its output:\n{buf.getvalue()}")
        raise
    out = buf.getvalue()
    print(f"{what}: {out.strip().splitlines()[-1] if out.strip() else ''}")
    return out


def start_serve_smoke(tmp: str, ckpt_path: str) -> dict:
    """16f's ``python -m aaclip_tpu_torch.tools.serve_smoke``, started and
    left running (its server's start-up is host work; 16a-e run beside
    it), in a session of its own so that a failure can stop the tool and
    its server together; its output goes to a file."""
    import os
    import subprocess

    out = open(os.path.join(tmp, "serve_smoke.out"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "aaclip_tpu_torch.tools.serve_smoke",
         "--port", str(free_port()), "--startup_timeout", "300"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, "AACLIP_CKPT": ckpt_path,
             "AACLIP_ANCHOR_CACHE": os.path.join(tmp, "anchors")},
        stdout=out, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    return {"proc": proc, "out": out, "t0": t0}


def stop_serve_smoke(child) -> None:
    """Stops ``start_serve_smoke``'s tool and its server, if still up."""
    import os
    import signal

    proc = child["proc"]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    child["out"].close()


def finish_serve_smoke(child, card) -> None:
    """Waits for ``start_serve_smoke``'s tool: it exits 0 with SERVE HTTP
    SMOKE OK last; its health, request and 4xx lines printed."""
    import subprocess

    proc = child["proc"]
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        pass
    wall = time.perf_counter() - child["t0"]
    rc = proc.poll()
    stop_serve_smoke(child)
    with open(child["out"].name) as f:
        smoke = f.read()
    for line in smoke.splitlines():
        if line.startswith(("healthz", "req", "unknown")):
            print(f"16f serve_smoke: {line}")
    print(f"16f serve_smoke: exit {rc}, "
          f"{smoke.strip().splitlines()[-1] if smoke.strip() else ''}; "
          f"{wall:.1f} s until collected (the child's start-up included; "
          f"16a-e ran beside it) on {card}")
    expect(rc == 0 and smoke.strip().endswith("SERVE HTTP SMOKE OK"),
           f"16f serve_smoke did not pass; its output:\n{smoke[-3000:]}")


def phase_tools(card, ckpt_path: str, int8_artifact: str) -> dict:
    """Phase 16; ``int8_artifact`` is phase 13's ViT-L int8 artifact.
    Returns {kernel: {path: launches}}."""
    import gc
    import os

    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              init_image_adapter,
                                              init_text_adapter,
                                              text_adapter_from_jax,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.data.image import encode_png, load_rgb
    from aaclip_tpu_torch.data.transforms import load_rgb_chw
    from aaclip_tpu_torch.deploy import load_serving_artifact
    from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                               make_predict_fn)
    from aaclip_tpu_torch.examples import zero_shot
    from aaclip_tpu_torch.kernels.build import kernels_launched
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import attention_kernel
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors
    from aaclip_tpu_torch.tools import (few_shot_soak, precision_ab,
                                        predict_folder)
    from aaclip_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    cfg = get_config("ViT-L-14-336", img_size=518)
    img, n_layers = cfg.vision.image_size, cfg.vision.layers
    acfg = AdapterConfig()
    bf16 = DtypePolicy.bf16()
    tmp = tempfile.mkdtemp(prefix="aaclip_tools_")
    keys = ("AACLIP_CKPT", "AACLIP_DATA", "AACLIP_METADATA",
            "AACLIP_ANCHOR_CACHE")
    env_before = {k: os.environ.get(k) for k in keys}
    calls = {"attention_packed": {}, "attention_packed_bwd": {}}
    smoke = None
    try:
        # -- 16f starts first, in a child: serve_smoke against the port's
        # server in a child of its own, collected after 16e
        smoke = start_serve_smoke(tmp, ckpt_path)
        # the folder: seeded PNGs of mixed sizes (smooth fields + noise)
        folder = os.path.join(tmp, "images")
        os.makedirs(folder)
        rng = np.random.default_rng(16)
        for i, (h, w) in enumerate(TOOL_SIZES):
            yy, xx = np.mgrid[0:h, 0:w]
            base = 128 + 60 * np.sin(xx / (17 + i)) * np.cos(yy / (23 + i))
            px = base[..., None] + rng.normal(0, 12, (h, w, 3))
            with open(os.path.join(folder, f"img_{i:02d}.png"), "wb") as f:
                f.write(encode_png(np.clip(px, 0, 255).astype(np.uint8)))
        files = sorted(os.listdir(folder))
        # seeded adapters: an npz image snapshot and a text adapter
        save = os.path.join(tmp, "adapters")
        ad_tree = adapter_to_jax(init_image_adapter(cfg, acfg, seed=21,
                                                    device="cpu"))
        text_tree = text_adapter_to_jax(init_text_adapter(cfg, acfg,
                                                          seed=22,
                                                          device="cpu"))
        ckpt.save_adapter_checkpoint(
            os.path.join(save, "image_adapter_1.npz"), 1, ad_tree)
        ckpt.save_adapter_checkpoint(
            os.path.join(save, "text_adapter.npz"), 0, text_tree)
        os.environ["AACLIP_CKPT"] = ckpt_path

        # -- 16a. predict_folder, live, ViT-L @ 518 bf16
        out = os.path.join(tmp, "out")
        zero_counts()
        zero_fused_counts()
        before = kernels_launched("attention_packed")
        t0 = time.perf_counter()
        tool_output(predict_folder.main, [
            folder, "--class_name", "bottle", "--save_path", save,
            "--batch_size", str(TOOL_BATCH), "--heatmaps", "--out", out],
            "16a predict_folder")
        wall = time.perf_counter() - t0
        n_batches = -(-len(files) // TOOL_BATCH)
        launches, n_lib = counts(), kernels_launched("attention_packed") \
            - before
        others = {"attention_kernel": attention_kernel.launches,
                  "ln_linear": FB.ln_linear.launches,
                  "linear_residual": FB.linear_residual.launches,
                  "mlp_fused": FB.mlp_fused.launches}
        print(f"16a predict_folder bf16 B={TOOL_BATCH}: {len(files)} images "
              f"in {n_batches} batches, attention_packed {launches[0]} "
              f"launches ({n_lib} kernels counted by the library), V-V "
              f"{launches[1]}, backward {launches[2]}, {others}")
        expect(launches == (n_layers * n_batches, 0, 0)
               and n_lib == launches[0] and not any(others.values()),
               f"16a predict_folder: launches {launches}, {n_lib} kernels, "
               f"{others}")
        calls["attention_packed"][f"predict_folder ({n_batches} batches "
                                  f"of {TOOL_BATCH})"] = launches[0]
        rows = read_csv(os.path.join(out, "scores.csv"))
        expect(rows[0] == ["file", "image_score"]
               and [r[0] for r in rows[1:]] == files,
               f"16a predict_folder: scores.csv rows {rows[:3]}")
        heatmaps = sorted(f for f in os.listdir(out)
                          if f.endswith("_heatmap.png"))
        expect(len(heatmaps) == len(files)
               and all(load_rgb(os.path.join(out, f)).shape == (img, img, 3)
                       for f in heatmaps),
               f"16a predict_folder: heatmaps {heatmaps}")
        print(f"16a predict_folder: {len(files)} images in {wall:.2f} s, "
              f"{len(files) / wall:.2f} images/s over the whole main() "
              f"(the towers from the checkpoint, the anchors, the host "
              f"decode and the {len(heatmaps)} heatmaps included) on {card}")
        # the direct predict on the same towers, adapters and batches
        vit, text = create_clip_towers(cfg, checkpoint=ckpt_path)
        image_adapter = adapter_from_jax(ad_tree, cfg, acfg)
        predict = make_predict_fn(vit, cfg, acfg, policy=bf16,
                                  uint8_inputs=True)
        anchors = encode_dataset_anchors(make_anchor_encoder(
            text, cfg, acfg, text_adapter_from_jax(text_tree, cfg, acfg),
            policy=bf16), "MVTec")["bottle"]
        M = torch.from_numpy(fused_postproc_matrix(cfg.vision.grid, img,
                                                   "Industrial"))
        want = []
        for start in range(0, len(files), TOOL_BATCH):
            batch = np.stack([load_rgb_chw(os.path.join(folder, f), img,
                                           uint8=True)
                              for f in files[start:start + TOOL_BATCH]])
            n = len(batch)
            batch = np.concatenate([batch, np.repeat(
                batch[-1:], TOOL_BATCH - n, axis=0)])
            want += [float(s) for s in predict(
                image_adapter, torch.from_numpy(batch), anchors,
                M)[1].cpu().numpy()[:n]]
        got = [float(r[1]) for r in rows[1:]]
        print(f"16a predict_folder: scores.csv against the direct predict: "
              f"bit for bit {got == want} (max|d| "
              f"{max(abs(a - b) for a, b in zip(got, want)):.3e}; scores "
              f"{min(got):.4f}..{max(got):.4f})")
        expect(got == want, "16a predict_folder: scores differ from the "
               "direct predict")

        # -- 16c. zero_shot on one image, ViT-L @ 518 bf16
        one = os.path.join(folder, files[1])
        zero_counts()
        t0 = time.perf_counter()
        printed = tool_output(zero_shot.main, [one, "--save_path", save],
                              "16c zero_shot")
        zs_wall = time.perf_counter() - t0
        zs_launches = counts()
        frozen = encode_dataset_anchors(make_anchor_encoder(
            text, cfg, acfg, policy=bf16), "MVTec")["bottle"]
        score = predict(image_adapter, torch.from_numpy(load_rgb_chw(
            one, img, uint8=True)[None]), frozen, M)[1]
        line = printed.strip().splitlines()[0]
        print(f"16c zero_shot: printed {line!r}, the direct predict's "
              f"{float(score[0]):.4f}; launches {zs_launches}; "
              f"{zs_wall:.2f} s for the whole main() on {card}")
        expect(line == f"image score: {float(score[0]):.4f}"
               and zs_launches == (n_layers, 0, 0),
               f"16c zero_shot: {line!r}, launches {zs_launches}")
        calls["attention_packed"]["zero_shot (one image)"] = zs_launches[0]
        del vit, text, predict, image_adapter
        gc.collect()
        torch.cuda.empty_cache()

        # -- 16b. predict_folder --artifact on phase 13's ViT-L int8
        # artifact
        out_art = os.path.join(tmp, "out_artifact")
        zero_counts()
        t0 = time.perf_counter()
        tool_output(predict_folder.main, [
            folder, "--class_name", "bottle", "--artifact", int8_artifact,
            "--batch_size", str(TOOL_BATCH), "--out", out_art],
            "16b predict_folder --artifact")
        art_wall = time.perf_counter() - t0
        art_launches = counts()
        rows = read_csv(os.path.join(out_art, "scores.csv"))
        art = load_serving_artifact(int8_artifact)
        want = []
        for start in range(0, len(files), TOOL_BATCH):
            batch = np.stack([load_rgb_chw(os.path.join(folder, f),
                                           art.img_size, uint8=True)
                              for f in files[start:start + TOOL_BATCH]])
            want += [float(s) for s in
                     art.predict_class(batch, "MVTec", "bottle")[1]]
        del art
        gc.collect()
        torch.cuda.empty_cache()
        got = [float(r[1]) for r in rows[1:]]
        print(f"16b predict_folder --artifact (ViT-L int8, bucket "
              f"{TOOL_BATCH}): launches {art_launches}; scores.csv against "
              f"predict_class bit for bit {got == want}; {art_wall:.2f} s "
              f"for the whole main() (the artifact's load included) on "
              f"{card}")
        expect(got == want and [r[0] for r in rows[1:]] == files,
               "16b predict_folder --artifact: scores differ from "
               "predict_class")
        expect(art_launches == (n_layers * n_batches, 0, 0),
               f"16b predict_folder --artifact: launches {art_launches}")
        calls["attention_packed"][
            f"predict_folder --artifact (int8, {n_batches} batches of "
            f"{TOOL_BATCH})"] = art_launches[0]

        gc.collect()
        torch.cuda.empty_cache()
        os.environ.pop("AACLIP_CKPT")  # the tiny-test runs below

        # -- 16d. few_shot_soak, tiny-test
        tiny = ["--model_name", "tiny-test", "--img_size", "70",
                "--levels", "1", "2", "--text_adapt_until", "1",
                "--image_adapt_until", "1"]
        zero_counts()
        t0 = time.perf_counter()
        soak = tool_output(few_shot_soak.main, [
            "--workdir", os.path.join(tmp, "soak"), "--shots", "2", "4",
            "--memory_bank", "--surgery_until_layer", "2",
            "--text_epoch", "1", "--image_epoch", "1"] + tiny,
            "16d few_shot_soak")
        soak_launches = counts()
        summary = soak.split("=== few-shot soak summary ===")[-1]
        print("16d few_shot_soak summary:" + summary.rstrip()
              + f"\n16d few_shot_soak: launches {soak_launches}, "
              f"{time.perf_counter() - t0:.1f} s on {card}")
        expect("FEW-SHOT SOAK OK" in soak and summary.count("-shot") == 4
               and soak_launches[0] > 0 and soak_launches[2] > 0,
               f"16d few_shot_soak: launches {soak_launches}")
        calls["attention_packed"]["few_shot_soak (tiny-test)"] = \
            soak_launches[0]
        calls["attention_packed_bwd"]["few_shot_soak (tiny-test)"] = \
            soak_launches[2]

        # -- 16e. precision_ab, tiny-test, bf16 against int8
        zero_counts()
        t0 = time.perf_counter()
        ab = tool_output(precision_ab.main, [
            "--workdir", os.path.join(tmp, "ab"), "--baseline", "bf16",
            "--candidate", "int8"] + tiny, "16e precision_ab")
        ab_launches = counts()
        for line in ab.splitlines():
            if line.startswith("  ") and ("(allowed" in line
                                          or "Spearman" in line):
                print(f"16e precision_ab: {line.strip()}")
        print(f"16e precision_ab (tiny-test, bf16 against int8): launches "
              f"{ab_launches}, {time.perf_counter() - t0:.1f} s on {card}")
        expect("PRECISION A/B OK" in ab and ab_launches[0] > 0
               and ab_launches[2] > 0,
               f"16e precision_ab: launches {ab_launches}")
        calls["attention_packed"]["precision_ab (tiny-test)"] = \
            ab_launches[0]
        calls["attention_packed_bwd"]["precision_ab (tiny-test)"] = \
            ab_launches[2]

        # -- 16f. serve_smoke, started first
        finish_serve_smoke(smoke, card)
        print(f"phase 16 (tools and examples) took "
              f"{time.perf_counter() - t_phase:.0f} s")
    finally:
        if smoke is not None:
            stop_serve_smoke(smoke)
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    return calls


# ---------------------------------------------------------------------------
# Phase 17: the packed-attention forward at head dims 80 and 128 (B1, B3
# and B4 on the bf16, 6-pass and 3-pass routes) and open_clip's ViT-H-14 @
# 518 through the serving and evaluation path

# open_clip's published ViT-H-14 (its model_configs/ViT-H-14.json), written
# at run time into a temporary directory that AACLIP_MODEL_CONFIGS names:
# 32 vision blocks of width 1280 in 16 heads of 80, patch 14, MLP 5120;
# text width 1024, 16 heads, 24 blocks; embed_dim 1024. Random weights from
# seeds; at 518 px 37 x 37 patches, S 1370.
VIT_H_14 = {
    "embed_dim": 1024,
    "vision_cfg": {"image_size": 224, "layers": 32, "width": 1280,
                   "head_width": 80, "patch_size": 14},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 1024,
                 "heads": 16, "layers": 24},
}
# 17a: (head dim, heads) of ViT-H-14 and of a ViT-L width in heads of 128,
# the batches of the predicts at S 1370 (B3 at the stage-1 batch) and the
# ragged cases (B, S, valid_len): one partial tile, 64- and 32-key tile
# edges, keys masked mid-tile, a batch of 3 with a tail tile
HD_GEOMETRIES = ((80, 16), (128, 8))
HD_BATCHES = (8, 32)
HD_RAGGED = ((2, 77, 77), (2, 256, 200), (3, 129, 129), (2, 200, 150))
# (route, dtype name, precision): bf16, fp32 "highest" (6-pass), "high"
HD_ROUTES = (("bf16", "bf16", None), ("6-pass", "fp32", None),
             ("3-pass", "fp32", HIGH))
# the kernels each call launches, counted at the library's launch sites:
# by route, B1 and B3 (split + kernel on the fp32 routes) and B4 (three
# splits)
HD_KERNELS = {"bf16": ("attn_fwd_wgmma", None),
              "6-pass": ("attn_fwd_6pass", "split3_kernel"),
              "3-pass": ("attn_fwd_3pass_wgmma", "split2_kernel")}
# 17d and 18d: the evaluation CLI's two synthetic classes at ViT-H-14 and
# ViT-g-14 (a class must follow the first for the CLI to log its maps/s);
# 17b and 18b: the bench's timed calls
VIT_H_EVAL_CLASSES, VIT_H_EVAL_NORMAL, VIT_H_EVAL_ANOMALOUS = 2, 8, 24
VIT_H_EVAL_PX, VIT_H_BENCH_STEPS = 512, 5


def chunked(fn, *args, step: int = 8, **kw):
    """``fn`` over images ``step`` at a time (every tensor argument cut
    along its first dimension), concatenated: the plain versions at batch
    32 hold [B, H, S, S] fp32 scores."""
    import torch

    return torch.cat([fn(*(a[i:i + step] if torch.is_tensor(a) else a
                           for a in args), **kw)
                      for i in range(0, args[0].shape[0], step)])


def hd_route_counts(route: str, wrapper, before: tuple, calls: int,
                    splits_per_call: int, what: str) -> None:
    """``calls`` launches of ``wrapper`` since ``before`` (its launches,
    launches_6pass, launches_3pass and split3/split2's launches) all on
    ``route``'s TMA + wgmma kernel, after ``splits_per_call`` split
    launches each on the fp32 routes."""
    from aaclip_tpu_torch.ops import attention as A

    now = (wrapper.launches, wrapper.launches_6pass, wrapper.launches_3pass,
           A.split3.launches, A.split2.launches)
    got = tuple(a - b for a, b in zip(now, before))
    split = calls * splits_per_call
    want = {"bf16": (calls, 0, 0, 0, 0), "6-pass": (calls, calls, 0, split, 0),
            "3-pass": (calls, 0, calls, 0, split)}[route]
    expect(got == want, f"{what}: launches, 6-pass, 3-pass, split3, split2 "
           f"{got}, not {want}")


def hd_before(wrapper) -> tuple:
    from aaclip_tpu_torch.ops import attention as A

    return (wrapper.launches, wrapper.launches_6pass, wrapper.launches_3pass,
            A.split3.launches, A.split2.launches)


def hd_phase(hd: int, part: str = "a") -> str:
    """The phase that checks the kernels at head dim ``hd``: 17a (the
    forward; ``part`` "c", the backward: 17c) at 80 and 128, 18a (18c) at
    88 and 104."""
    return ("17" if hd in (80, 128) else "18") + part


def hd_check(hd: int, H: int, route: str, dtype_name: str, precision,
             gen) -> dict:
    """17a and 18a at one head dim and route: B1 (and its logsumexp), B3
    (and bit for bit B1 on [v, v, v]) and B4 (and bit for bit B1 on the
    same values packed) against their plain versions at HD_BATCHES x S
    1370 and HD_RAGGED, with phase 3's bars; the fp32 routes' distance
    from fp64 on two images of batch 8 (SIX_FP64_MAX_REL,
    HIGH_FP64_MAX_REL); every launch counted on the route's kernel.
    Returns {kernel: the largest max |d| at S 1370}."""
    import torch

    from aaclip_tpu_torch.ops import attention as A

    dtype = torch_dtype(dtype_name)
    kw = dict(precision=precision)
    worst = {"attention_packed": 0.0, "attention_packed_vv": 0.0,
             "attention_kernel": 0.0}
    cases = [(B, 1370, 1370) for B in HD_BATCHES] + list(HD_RAGGED)
    for B, S, valid in cases:
        what = f"{hd_phase(hd)} hd {hd} {route} B={B} S={S} valid={valid}"
        dm = H * hd
        qkv = random_qkv(B, S, H, hd, dtype, gen)
        before = hd_before(A.attention_packed)
        got, lse = A.attention_packed(qkv, H, valid, return_lse=True, **kw)
        again = A.attention_packed(qkv, H, valid, **kw)
        torch.cuda.synchronize()
        hd_route_counts(route, A.attention_packed, before, 2, 1, what)
        want = chunked(A.attention_packed_plain, qkv, H, valid, **kw)
        d = (got.float() - want.float()).abs()
        mx, mean = d.max().item(), d.mean().item()
        lse_err = lse_vs_logsumexp(qkv, H, valid, lse)
        del want, d, lse
        v = qkv[..., 2 * dm:].contiguous()
        before = hd_before(A.attention_packed_vv)
        gv = A.attention_packed_vv(v, H, S, **kw)
        torch.cuda.synchronize()
        hd_route_counts(route, A.attention_packed_vv, before, 1, 1, what)
        wv = chunked(A.attention_packed_vv_plain, v, H, S, **kw).float()
        dv = (gv.float() - wv).abs()
        vmax, vmean = dv.max().item(), dv.mean().item()
        vover = (dv - VV_BF16_REL * wv.abs()).max().item()
        del wv, dv
        same_vv = None
        if B <= 8:
            same_vv = torch.equal(gv, A.attention_packed(
                torch.cat([v, v, v], dim=-1).contiguous(), H, S, **kw))
        heads = [qkv[..., i * dm:(i + 1) * dm].reshape(B, S, H, hd)
                 .transpose(1, 2).contiguous() for i in range(3)]
        before = hd_before(A.attention_kernel)
        g4 = A.attention_kernel(*heads, valid, **kw)
        torch.cuda.synchronize()
        hd_route_counts(route, A.attention_kernel, before, 1, 3, what)
        same4 = torch.equal(g4.transpose(1, 2).reshape(B, S, dm), got)
        w4 = chunked(A.attention_kernel_plain, heads[0], heads[1], heads[2],
                     valid, **kw)
        d4 = (g4.float() - w4.float()).abs()
        b4max, b4mean = d4.max().item(), d4.mean().item()
        del w4, d4
        finite = bool(torch.isfinite(got).all() and torch.isfinite(gv).all()
                      and torch.isfinite(g4).all())
        fp64 = ""
        if dtype_name == "fp32" and B == 8 and S == 1370:
            x2 = qkv[:2]
            exact = attention_fp64(x2, H, valid)
            exact_vv = attention_fp64(torch.cat([v[:2]] * 3, dim=-1), H, S)
            rel = max(((t.double() - e).abs().max() / e.abs().max()).item()
                      for t, e in ((got[:2], exact), (gv[:2], exact_vv)))
            bar = SIX_FP64_MAX_REL if precision is None else HIGH_FP64_MAX_REL
            fp64 = f"; from fp64 {rel:.3e} of the max (bar {bar})"
            expect(rel <= bar, f"{what}: {rel} from fp64")
            del exact, exact_vv
        print(f"{what}: B1 max|d| {mx:.3e} mean {mean:.3e} (lse {lse_err:.3e},"
              f" with lse bit for bit {torch.equal(got, again)}); B3 max|d| "
              f"{vmax:.3e} mean {vmean:.3e}" + (
                  "" if same_vv is None else
                  f" (= B1 on [v, v, v]: {same_vv})")
              + f"; B4 max|d| {b4max:.3e} (= B1: {same4}); finite {finite}"
              + fp64)
        expect(finite and torch.equal(got, again) and same4
               and same_vv is not False, f"{what}: not finite, or a mode "
               f"differs from B1 on the same values")
        expect(lse_err <= LSE_MAX_ABS, f"{what}: lse off {lse_err}")
        if dtype_name == "bf16":
            expect(mx <= BF16_MAX_ABS and mean <= BF16_MEAN_ABS
                   and b4max <= BF16_MAX_ABS and b4mean <= BF16_MEAN_ABS,
                   f"{what}: B1 {mx}, {mean}; B4 {b4max}, {b4mean}")
            expect(vover <= VV_BF16_ABS and vmean <= BF16_MEAN_ABS,
                   f"{what}: B3 {vmax} ({vover} over 2^-7 of it), {vmean}")
        else:
            expect(max(mx, vmax, b4max) <= FP32_MAX_ABS,
                   f"{what}: B1 {mx}, B3 {vmax}, B4 {b4max}")
        if S == 1370:
            for name, e in (("attention_packed", mx),
                            ("attention_packed_vv", vmax),
                            ("attention_kernel", b4max)):
                worst[name] = max(worst[name], e)
        del qkv, got, again, gv, g4, heads, v
    check_tail_isolation(dtype_name, precision, case=(3, 200, H, hd, 200))
    return worst


def sdpa_backend(q, k, v) -> str:
    """Which of PyTorch's SDPA backends the default call on ``q, k, v``
    ran: the first one that, forced alone, gives the default call's output
    bit for bit (each backend's forward is deterministic)."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    want = sdpa(q, k, v)
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            # a backend that does not take the inputs warns, then raises
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = sdpa(q, k, v)
        except RuntimeError:
            continue
        if torch.equal(got, want):
            return backend.name.lower()
    return "unknown"


def hd_times(hd: int, H: int, route: str, dtype_name: str, precision,
             card, gen) -> dict:
    """17a's and 18a's times at one head dim and route: each of B1, B3 and
    B4 (with its splits on the fp32 routes, as a call runs them) at the
    predict's batch (32 bf16, 8 fp32; B3 at the stage-1 batch 16) beside
    its plain version, SDPA on the same inputs (its backend named) and its
    bound (the route's bf16 passes at 989 TFLOP/s, or the bytes); the
    kernels per call counted at the launch sites. Returns {kernel: (ms,
    plain ms, SDPA ms, bound ms, bound_by, kernels per call, SDPA
    backend)}."""
    import torch

    from aaclip_tpu_torch.kernels.build import kernels_launched
    from aaclip_tpu_torch.ops import attention as A

    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtype = torch_dtype(dtype_name)
    esize = torch.tensor([], dtype=dtype).element_size()
    kw = dict(precision=precision)
    passes = {"bf16": 1, "6-pass": 6, "3-pass": 3}[route]
    kernel, split = HD_KERNELS[route]
    S, dm = 1370, H * hd
    out = {}

    def row(name, B, call, plain, library, n_out, n_splits, sdpa_in):
        ms = cuda_ms(call, 10)
        ms_plain = cuda_ms(plain, 2, warmup=1)
        ms_lib = cuda_ms(library, 10)
        backend = sdpa_backend(*sdpa_in)
        before = kernels_launched("attention_packed")
        call()
        torch.cuda.synchronize()
        per_call = kernels_launched("attention_packed") - before
        want = 1 + (n_splits if split else 0)
        expect(per_call == want, f"{hd_phase(hd)} {name} hd {hd} {route}: "
               f"{per_call} kernels per call, not {want} ({kernel}, "
               f"{split})")
        flops = passes * 4 * B * H * S * S * hd
        bound_ms, bound_by = bound(flops, (n_out + 1) * B * S * dm * esize)
        out[name] = (ms, ms_plain, ms_lib, bound_ms, bound_by, per_call,
                     backend)
        print(f"time {hd_phase(hd)} {name} hd {hd} {route} B={B} ({H} heads): "
              f"{ms:.4f} ms/call ({flops / ms / 1e9:.1f} TFLOP/s of the "
              f"{passes} bf16 pass(es); bound {bound_ms:.4f} ms by "
              f"{bound_by}); plain {ms_plain:.4f}; SDPA ({backend}) "
              f"{ms_lib:.4f}; {per_call} kernel(s) per call on {card}")

    B = 32 if dtype_name == "bf16" else TRAIN_BATCH
    qkv = random_qkv(B, S, H, hd, dtype, gen)
    q, k, v = (t.contiguous() for t in
               qkv.view(B, S, 3, H, hd).permute(2, 0, 3, 1, 4).unbind(0))
    row("attention_packed", B,
        lambda: A.attention_packed(qkv, H, S, **kw),
        lambda: A.attention_packed_plain(qkv, H, S, **kw),
        lambda: sdpa(q, k, v), 3, 1, (q, k, v))
    row("attention_kernel", B,
        lambda: A.attention_kernel(q, k, v, S, **kw),
        lambda: A.attention_kernel_plain(q, k, v, S, **kw),
        lambda: sdpa(q, k, v), 3, 3, (q, k, v))
    del qkv, q, k, v
    B = STAGE1_BATCH
    vv = torch.randn(B, S, dm, generator=gen, device="cuda").to(dtype)
    qv = vv.view(B, S, H, hd).transpose(1, 2)
    row("attention_packed_vv", B,
        lambda: A.attention_packed_vv(vv, H, S, **kw),
        lambda: chunked(A.attention_packed_vv_plain, vv, H, S, **kw),
        lambda: sdpa(qv, qv, qv), 1, 1, (qv, qv, qv))
    del vv, qv
    return out


def check_neighbour_heads(hd: int, H: int, route: str, dtype_name: str,
                          precision) -> None:
    """17a and 18a: NaN and Inf written into the odd heads' columns of Q, K
    and V (every row: NaN in even rows, +Inf and -Inf in odd ones) leave
    each even head's output and logsumexp bit for bit as with those heads
    clean, for B1, B3 (on the value section) and B4 (on [B, H, S, hd]).
    The per-head tensor maps give a 64-column chunk's columns past the head
    dim as zeros: at 88 and 104 Q K^T's last k-step multiplies 8 of them
    in Q and in K, and a kernel that read the next head's columns there
    would carry its NaN into this head (0 * NaN is NaN)."""
    import torch

    from aaclip_tpu_torch.ops import attention as A

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(59)
    B, S, valid = 2, 200, 150
    dm = H * hd
    kw = dict(precision=precision)
    clean = random_qkv(B, S, H, hd, dtype, gen)
    poisoned = clean.clone()
    odd = poisoned.view(B, S, 3, H, hd)[:, :, :, 1::2]
    odd[:, 0::2] = float("nan")
    odd[:, 1::2, ..., :hd // 2] = float("inf")
    odd[:, 1::2, ..., hd // 2:] = float("-inf")

    what = f"{hd_phase(hd)} hd {hd} {route} neighbour heads"

    def counted(wrapper, splits, *args, **kwargs):
        before = hd_before(wrapper)
        out = wrapper(*args, **kwargs)
        hd_route_counts(route, wrapper, before, 1, splits,
                        f"{what} {wrapper.__name__}")
        return out

    def runs(x):
        out, lse = counted(A.attention_packed, 1, x, H, valid,
                           return_lse=True, **kw)
        vv = counted(A.attention_packed_vv, 1,
                     x[..., 2 * dm:].contiguous(), H, S, **kw)
        heads = [x[..., i * dm:(i + 1) * dm].reshape(B, S, H, hd)
                 .transpose(1, 2).contiguous() for i in range(3)]
        b4 = counted(A.attention_kernel, 3, *heads, valid, **kw)
        even = (lambda t: t.view(B, S, H, hd)[:, :, 0::2])
        return {"B1": even(out), "B1 lse": lse[:, 0::2], "B3": even(vv),
                "B4": b4[:, 0::2]}

    got, want = runs(poisoned), runs(clean)
    torch.cuda.synchronize()
    same = {k: torch.equal(got[k], want[k]) for k in want}
    finite = all(bool(torch.isfinite(t).all()) for t in got.values())
    print(f"{what}: NaN / +-Inf in the odd heads' Q, K and V columns; each "
          f"even head bit for bit as clean {same}, finite {finite}")
    expect(all(same.values()) and finite,
           f"{what}: a head read its neighbour's columns: {same}")


def phase_head_dims_kernels(card, geometries=HD_GEOMETRIES,
                            phase: str = "17a") -> dict:
    """17a (18a at ``WIDE_GEOMETRIES``); returns {(kernel, hd, route): (ms,
    plain ms, SDPA ms, bound ms, bound_by, kernels per call, max |d|, SDPA
    backend)}."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(51)
    rows = {}
    for hd, H in geometries:
        for route, dtype_name, precision in HD_ROUTES:
            worst = hd_check(hd, H, route, dtype_name, precision, gen)
            check_neighbour_heads(hd, H, route, dtype_name, precision)
            times = hd_times(hd, H, route, dtype_name, precision, card, gen)
            for name, t in times.items():
                rows[(name, hd, route)] = (*t[:6], worst[name], t[6])
            gc.collect()
            torch.cuda.empty_cache()
    print(f"{phase} took {time.perf_counter() - t_phase:.0f} s")
    return rows


def bf16_yardstick(vit, cfg, acfg, adapter, images, anchors, M, pix_k,
                   pix_p) -> dict:
    """18b's reading of a bf16 map ``pix_k`` (the kernels) beside the
    plain-attention map ``pix_p`` on the same uint8 ``images``: the same
    predict on SDPA's attention and in fp32, and each map's max and mean
    distance as fractions of the plain map's (or the fp32 map's) span."""
    import gc

    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.ops import attention as A

    bf16, heads = DtypePolicy.bf16(), cfg.vision.heads
    library = make_predict_fn(vit, cfg, acfg, policy=bf16, uint8_inputs=True,
                              attn_fn=A.make_attn_fn(heads, bf16,
                                                     attention=sdpa_packed))
    pix_l = library(adapter, images, anchors, M)[0]
    del library
    exact = make_predict_fn(vit, cfg, acfg, policy=DtypePolicy.fp32(),
                            uint8_inputs=True)
    pix_f = exact(adapter, images, anchors, M)[0]
    del exact
    gc.collect()
    torch.cuda.empty_cache()
    span = (pix_p.max() - pix_p.min()).item()
    span32 = (pix_f.max() - pix_f.min()).item()
    r = {"kernel-plain": (pix_k - pix_p).abs().max().item() / span,
         "sdpa-plain": (pix_l - pix_p).abs().max().item() / span,
         "kernel-plain mean": (pix_k - pix_p).abs().mean().item() / span,
         "sdpa-plain mean": (pix_l - pix_p).abs().mean().item() / span}
    for k, m in (("kernel", pix_k), ("plain", pix_p), ("sdpa", pix_l)):
        r[f"{k}-fp32"] = (m - pix_f).abs().max().item() / span32
    return r


def tower_predicts(phase: str, name: str, cfg, acfg, card,
                   features: bool = True,
                   sdpa_yardstick: bool = False) -> dict:
    """The predicts of phase 17b (ViT-H-14) and 18b (ViT-g-14, ViT-bigG-14)
    at 518 px (random towers from seeds): bf16 uint8 at batch 32, fp32 and
    fp32_high (staged, ``bf16_until`` 6) at batch 8, each against the same
    predictor on the plain attention at phase 4's bars (fp32_high: phase
    11's), one B1 launch per block up to the last tap (24 of the tower's
    32, 40 or 48) on its route; with ``features``, spatial stage-1 features
    at batch 2 against both attentions plain (phase 7's bars, B3's
    launches); maps/s of each predict on both attentions. With
    ``sdpa_yardstick`` (18b) the bf16 map is also read against a second
    bf16 attention, the library's (SDPA through the same projections), and
    against the fp32 predict: where it lies past phase 4's 1e-2 of the
    span from the plain map, it is held as phase 9 holds the evaluation
    CLI's map, its mean distance at most VS_SDPA_MEAN and its max at most
    VS_SDPA_MAX times SDPA's. Returns {path: B1 (or B3) launches}."""
    import gc

    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.ops import attention as A
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix

    heads, img, n_layers = (cfg.vision.heads, cfg.vision.image_size,
                            cfg.vision.layers)
    # the predict runs the blocks up to its last tap: 24 of ViT-H-14's 32
    # (ViT-g-14's 40, ViT-bigG-14's 48) at the default levels (6, 12, 18,
    # 24), as JAX's does
    depth = max(acfg.levels)
    gen = torch.Generator(device="cuda").manual_seed(52)
    vit = init_vision_params(cfg, seed=0)
    adapter = init_image_adapter(cfg, acfg, seed=1)
    anchors = torch.randn(cfg.embed_dim, 2, generator=gen, device="cuda")
    anchors = anchors / anchors.norm(dim=0, keepdim=True)
    M = torch.from_numpy(fused_postproc_matrix(cfg.vision.grid, img,
                                               "Industrial")).cuda()
    calls = {}
    high = DtypePolicy.fp32_high()
    for prec, policy, B in (("bf16", DtypePolicy.bf16(), 32),
                            ("fp32", DtypePolicy.fp32(), TRAIN_BATCH),
                            ("fp32_high", high, TRAIN_BATCH)):
        u8 = prec == "bf16"
        kernel = make_predict_fn(vit, cfg, acfg, policy=policy,
                                 uint8_inputs=u8)
        plain = make_predict_fn(vit, cfg, acfg, policy=policy,
                                uint8_inputs=u8,
                                attn_fn=make_attn_fn_plain(heads, policy))
        if u8:
            images = torch.randint(0, 256, (B, 3, img, img), generator=gen,
                                   device="cuda", dtype=torch.uint8)
        else:
            images = torch.randn(B, 3, img, img, generator=gen,
                                 device="cuda")
        zero_counts()
        pix_k, score_k = kernel(adapter, images, anchors, M)
        torch.cuda.synchronize()
        got = (A.attention_packed.launches, A.attention_packed.launches_6pass,
               A.attention_packed.launches_3pass, A.split3.launches,
               A.split2.launches)
        staged = high.bf16_until if prec == "fp32_high" else 0
        n = depth - staged
        want = {"bf16": (depth, 0, 0, 0, 0),
                "fp32": (depth, depth, 0, depth, 0),
                "fp32_high": (depth, 0, n, 0, n)}[prec]
        what = f"{phase} {name} predict {prec} B={B}"
        expect(got == want, f"{what}: B1 launches, 6-pass, 3-pass, split3, "
               f"split2 {got}, not {want}")
        zero_counts()
        pix_p, score_p = plain(adapter, images, anchors, M)
        torch.cuda.synchronize()
        p = A.attention_packed.launches
        expect(pix_k.shape == (B, img, img) and score_k.shape == (B,)
               and bool(torch.isfinite(pix_k).all()
                        and torch.isfinite(score_k).all()),
               f"{what}: output {tuple(pix_k.shape)} not finite")
        expect(p == staged, f"{what}: the plain predictor launched {p}")
        span = (pix_p.max() - pix_p.min()).item()
        dpix = (pix_k - pix_p).abs().max().item()
        dscore = (score_k - score_p).abs().max().item()
        ms_k = cuda_ms(lambda: kernel(adapter, images, anchors, M), 3,
                       warmup=1)
        ms_p = cuda_ms(lambda: plain(adapter, images, anchors, M), 2,
                       warmup=1)
        print(f"{what}: {got[0]} B1 launches per call ({got[1]} 6-pass, "
              f"{got[2]} 3-pass); kernel vs plain attention max|d map| "
              f"{dpix:.3e} ({dpix / span:.3e} of span {span:.4f}), max|d "
              f"score| {dscore:.3e}; {B / ms_k * 1e3:.2f} maps/s "
              f"({ms_k:.2f} ms/call), plain attention {B / ms_p * 1e3:.2f} "
              f"maps/s on {card}")
        if prec == "bf16" and sdpa_yardstick:
            r = bf16_yardstick(vit, cfg, acfg, adapter, images, anchors, M,
                               pix_k, pix_p)
            print(f"{what}: max|d map| of the span: kernel vs plain "
                  f"{r['kernel-plain']:.3e} (phase 4's bar "
                  f"{PIX_SPAN_FRAC_BF16}), SDPA vs plain "
                  f"{r['sdpa-plain']:.3e}; mean: kernel vs plain "
                  f"{r['kernel-plain mean']:.3e}, SDPA vs plain "
                  f"{r['sdpa-plain mean']:.3e}; vs the fp32 map: kernel "
                  f"{r['kernel-fp32']:.3e}, plain {r['plain-fp32']:.3e}, "
                  f"SDPA {r['sdpa-fp32']:.3e}")
            expect(dscore <= SCORE_ATOL_BF16
                   and (r["kernel-plain"] <= PIX_SPAN_FRAC_BF16
                        or (r["kernel-plain mean"]
                            <= VS_SDPA_MEAN * r["sdpa-plain mean"]
                            and r["kernel-plain"]
                            <= VS_SDPA_MAX * r["sdpa-plain"])),
                   f"{what}: map {r}, scores {dscore}")
        elif prec == "bf16":
            expect(dpix <= PIX_SPAN_FRAC_BF16 * span
                   and dscore <= SCORE_ATOL_BF16,
                   f"{what}: map {dpix} of {span}, scores {dscore}")
        else:
            torch.testing.assert_close(pix_k, pix_p, atol=PIX_ATOL_FP32,
                                       rtol=PIX_RTOL_FP32)
            torch.testing.assert_close(score_k, score_p,
                                       atol=SCORE_ATOL_FP32, rtol=0)
        calls[f"{name} predict {prec}"] = got[0] - staged \
            if prec == "fp32_high" else got[0]
        del kernel, plain, images, pix_k, pix_p
        gc.collect()
        torch.cuda.empty_cache()
    if features:
        what = f"{phase} {name} stage-1 spatial features bf16 B=2"
        launched = check_features_vs_plain(
            vit, cfg, DtypePolicy.bf16(), stage1_batch(2, img, gen)[0], what,
            lambda c: None)
        expect(launched == (n_layers, STAGE1_SURGERY_UNTIL - 1, 0),
               f"{what}: launches {launched}")
        calls[f"{name} stage-1 spatial features bf16"] = launched[1]
    del vit, adapter
    gc.collect()
    torch.cuda.empty_cache()
    return calls


def model_bench(phase: str, name: str, card,
                runs=(("bf16", 32), ("fp32", TRAIN_BATCH),
                      ("fp32_high", TRAIN_BATCH))) -> dict:
    """``python -m aaclip_tpu_torch.bench --model_name <name>`` in process
    at each (precision, batch) of ``runs`` (17b: ViT-H-14, bf16 at batch
    32, fp32 and fp32_high (staged) at 8; 18b: ViT-g-14 and ViT-bigG-14 in
    bf16 at 32); returns {precision: maps/s}."""
    import contextlib
    import gc
    import io

    import torch

    from aaclip_tpu_torch import bench

    rates = {}
    for precision, B in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench.main(["--model_name", name, "--precision", precision,
                        "--batch_size", str(B), "--steps",
                        str(VIT_H_BENCH_STEPS), "--warmup", "2"])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"{phase} bench --model_name {name} --precision {precision} "
              f"--batch_size {B}: {json.dumps(line)}")
        expect(line["value"] > 0 and name in line["unit"],
               f"bench {name} {precision}: {line}")
        rates[precision] = line["value"]
        gc.collect()
        torch.cuda.empty_cache()
    return rates


def write_model_checkpoint(phase: str, name: str, tmp: str, card,
                           half: bool = False) -> str:
    """A seeded ``name`` (ViT-H-14, ViT-g-14) saved as an OpenAI-layout
    state dict at its native 224 px (the loader resizes the positional
    embedding 16 -> 37) under ``tmp``, in fp16 with ``half`` (as OpenAI
    publishes its checkpoints; the loader reads them as fp32); returns its
    path."""
    import os

    import torch

    from aaclip_tpu_torch.core.config import get_config
    from aaclip_tpu_torch.core.params import (init_text_params,
                                              init_vision_params)

    native = get_config(name, img_size=224)
    sd = openai_state_dict(init_vision_params(native, seed=7),
                           init_text_params(native, seed=8))
    if half:
        sd = {k: v.half() for k, v in sd.items()}
    expect(sd["visual.positional_embedding"].shape
           == (257, native.vision.width),
           f"the {name} checkpoint is not at its 16 x 16 grid")
    ckpt_path = os.path.join(tmp, f"{name}.pt")
    t0 = time.perf_counter()
    torch.save(sd, ckpt_path)
    del sd
    print(f"{phase}: {name} checkpoint "
          f"{os.path.getsize(ckpt_path) / 1e9:.3f} GB "
          f"({'fp16' if half else 'fp32'}) saved in "
          f"{time.perf_counter() - t0:.2f} s on {card}")
    return ckpt_path


def model_eval_cli(phase: str, name: str, cfg, acfg, card, tmp: str,
                   ckpt_path: str, save: str) -> int:
    """17d (ViT-H-14), 18d (ViT-g-14): ``python -m aaclip_tpu_torch.test
    --model_name <name>`` (bf16, batch 32) from the seeded checkpoint at
    ``ckpt_path`` and the adapters ``model_train_cli`` trained into
    ``save`` (its image snapshot and its text adapter), on
    VIT_H_EVAL_CLASSES synthetic MVTec classes: its table printed, finite
    and in [0, 100], its maps/s printed, one B1 launch per block up to the
    last tap and batch, and its scores bit for bit a direct predict's on
    the towers and adapters loaded as the CLI loads them (the anchors
    encoded with the trained text adapter). Returns the B1 launches."""
    import gc
    import os
    import re

    import numpy as np
    import torch

    from aaclip_tpu_torch import test as eval_cli
    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              init_image_adapter,
                                              init_text_adapter,
                                              text_adapter_from_jax,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.data.datasets import BatchLoader, get_test_datasets
    from aaclip_tpu_torch.data.registry import CLASS_NAMES
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                               make_predict_fn,
                                               run_class_predictions)
    from aaclip_tpu_torch.ops import attention as A
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors
    from aaclip_tpu_torch.train import checkpoint as ckpt

    img, B = cfg.vision.image_size, 32
    depth = max(acfg.levels)  # the blocks up to the last tap
    classes = CLASS_NAMES["MVTec"][:VIT_H_EVAL_CLASSES]
    data_root, meta_root = make_synthetic_dataset(
        os.path.join(tmp, f"eval_set_{name}"), class_names=classes,
        n_normal=VIT_H_EVAL_NORMAL, n_anomalous=VIT_H_EVAL_ANOMALOUS,
        img_px=VIT_H_EVAL_PX, hard=True)
    os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
    ad_tree, text_tree, image_path, text_path = \
        ckpt.discover_serving_adapters(
            save, adapter_to_jax(init_image_adapter(cfg, acfg,
                                                    device="cpu")),
            text_adapter_to_jax(init_text_adapter(cfg, acfg, device="cpu")))
    expect(image_path is not None and text_path is not None
           and image_path.endswith("image_adapter_1.npz"),
           f"{phase} eval CLI: adapters under {save}: {image_path}, "
           f"{text_path}")
    zero_fused_counts()
    t0 = time.perf_counter()
    eval_cli.main(["--model_name", name, "--clip_checkpoint",
                   ckpt_path, "--save_path", save, "--precision", "bf16",
                   "--batch_size", str(B), "--dump_scores", "--csv"])
    wall = time.perf_counter() - t0
    per_class = VIT_H_EVAL_NORMAL + VIT_H_EVAL_ANOMALOUS
    n_batches = VIT_H_EVAL_CLASSES * -(-per_class // B)
    launched = counts()
    expect(launched == (depth * n_batches, 0, 0)
           and A.attention_kernel.launches == 0,
           f"{phase} eval CLI: launches {launched}, not {depth} x "
           f"{n_batches}")
    log = open(os.path.join(save, "test.log")).read()
    rate = float(re.search(r"eval throughput: ([\d.]+) maps/s",
                           log).group(1))
    table = log[log.rindex("class name"):] if "class name" in log else ""
    expect(table.count("Average") == 1,
           f"{phase} eval CLI: no table in test.log")
    rows = read_csv(os.path.join(save, "results_1.csv"))
    cells = [float(x) for r in rows[1:] for x in r[1:]]
    expect([r[0] for r in rows[1:]] == list(classes) + ["Average"]
           and all(np.isfinite(cells)) and all(0 <= c <= 100
                                               for c in cells),
           f"{phase} eval CLI: table {rows}")
    print(f"{phase} eval CLI {name} bf16 B={B}: {n_batches} batches, "
          f"{launched[0]} B1 launches; {rate:.2f} maps/s logged (the first "
          f"class excluded), {wall:.2f} s for the whole main() on {card}; "
          f"its table:\n{table.rstrip()}")
    vit, text = create_clip_towers(cfg, checkpoint=ckpt_path)
    bf16 = DtypePolicy.bf16()
    # the CLI's bf16 path: uint8 batches, the normalisation folded into
    # the patch embedding
    direct = make_predict_fn(vit, cfg, acfg, policy=bf16, uint8_inputs=True)
    anchors = encode_dataset_anchors(make_anchor_encoder(
        text, cfg, acfg, text_adapter_from_jax(text_tree, cfg, acfg),
        policy=bf16), "MVTec")
    rows = read_csv(os.path.join(save, "scores_1.csv"))[1:]
    for cls, ds in get_test_datasets("MVTec", img, uint8=True).items():
        if len(ds) == 0:  # the classes the synthetic set does not hold
            continue
        got = run_class_predictions(direct, adapter_from_jax(ad_tree, cfg,
                                                             acfg),
                                    list(BatchLoader(ds, B)), anchors[cls],
                                    "Industrial", img, cfg.vision.grid)
        mine = [r for r in rows if r[0] == cls]
        expect([r[1] for r in mine] == got[4]
               and [float(r[3]) for r in mine] == [float(x) for x in got[3]],
               f"{phase} eval CLI {cls}: scores differ from the direct "
               f"predict")
    print(f"{phase} eval CLI {name}: every score bit for bit the direct "
          f"predict's")
    del vit, text, direct
    gc.collect()
    torch.cuda.empty_cache()
    return launched[0]


def hd128_fused_predict(card) -> int:
    """17b: ViT-L-14-336 @ 518 in 8 heads of 128, which JAX's gate and the
    port's admit: the fused bf16 predict (``maybe_make_block_fn``) at
    batch 8 against the unfused one at phase 8e's bars, one launch of each
    fused kernel and of B1 per block. Returns B1's launches."""
    import gc

    import torch

    from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix

    cfg = vit_l_hd128_config()
    expect(cfg.vision.head_dim == 128 and FB.reference_gate(cfg),
           "17b: the head-dim-128 ViT-L geometry")
    acfg = AdapterConfig()
    img, n_layers = cfg.vision.image_size, cfg.vision.layers
    gen = torch.Generator(device="cuda").manual_seed(53)
    vit = init_vision_params(cfg, seed=0)
    adapter = init_image_adapter(cfg, acfg, seed=1)
    anchors = torch.randn(cfg.embed_dim, 2, generator=gen, device="cuda")
    anchors = anchors / anchors.norm(dim=0, keepdim=True)
    M = torch.from_numpy(fused_postproc_matrix(cfg.vision.grid, img,
                                               "Industrial")).cuda()
    bf16 = DtypePolicy.bf16()
    block_fn = FB.maybe_make_block_fn(cfg, bf16)
    expect(callable(block_fn), "17b: the gate gave no fused block at hd 128")
    fused = make_predict_fn(vit, cfg, acfg, policy=bf16, uint8_inputs=True,
                            block_fn=block_fn)
    unfused = make_predict_fn(vit, cfg, acfg, policy=bf16, uint8_inputs=True)
    images = torch.randint(0, 256, (8, 3, img, img), generator=gen,
                           device="cuda", dtype=torch.uint8)
    zero_fused_counts()
    pix_f, score_f = fused(adapter, images, anchors, M)
    torch.cuda.synchronize()
    c = fused_counts()
    pix_u, score_u = unfused(adapter, images, anchors, M)
    torch.cuda.synchronize()
    span = (pix_u.max() - pix_u.min()).item()
    dpix = (pix_f - pix_u).abs().max().item()
    dscore = (score_f - score_u).abs().max().item()
    print(f"17b fused predict bf16 B=8, ViT-L in 8 heads of 128: launches "
          f"{dict(zip(FUSED_COUNTED, c))}; vs the unfused predict max|d "
          f"map| {dpix:.3e} ({dpix / span:.3e} of span {span:.4f}), max|d "
          f"score| {dscore:.3e} on {card}")
    expect(c == (n_layers, n_layers, 0, n_layers, n_layers, 0),
           f"17b fused predict hd 128: launches {c}")
    expect(bool(torch.isfinite(pix_f).all() and torch.isfinite(score_f).all())
           and dpix <= PIX_SPAN_FRAC_BF16 * span
           and dscore <= SCORE_ATOL_BF16,
           f"17b fused predict hd 128: map {dpix} of {span}, scores "
           f"{dscore}")
    del vit, adapter, fused, unfused
    gc.collect()
    torch.cuda.empty_cache()
    return c[1]


# 17c's 3-pass backward against fp64. The 3-pass form's own distance from
# fp64 varies with the data around HIGH_FP64_MAX_REL, which one reading
# at head dim 64 set: on this phase's inputs at 80 the plain 3-pass
# backward itself read 2.467e-5 of a gradient's max, and the kernel
# 2.474e-5 (NVIDIA H100 80GB HBM3, 700 W). So at 80 and 128 the 3-pass
# pair may come no farther from fp64 than HIGH_FP64_MAX_REL or
# HIGH_FP64_PLAIN_FACTOR times the plain version's own distance on the
# same inputs, whichever is larger (kernel and plain version compute the
# same 3-pass form and differ by their sums' order, within
# HIGH_BWD_MAX_REL), and never farther than HIGH_FP64_CEILING, the CPU
# tests' bar for the 3-pass backward against JAX's (5e-5 of each
# gradient's max), which the plain version is held to as well: an error
# that kernel and plain version shared could not widen the bar past it.
HIGH_FP64_PLAIN_FACTOR = 1.5
HIGH_FP64_CEILING = 5e-5
# 17c and 18c: the backward (B2) at head dims 80 and 128 (88 and 104) by
# route, its bar against the plain version (phase 3's for bf16 and
# 6-pass, phase 11's for the 3-pass mode) and, by route and head dim, the
# two kernels a call must launch (after two splits, of qkv and of dO, on
# the fp32 routes): the query-outer / key-outer pair, and at 88 and 104 in
# bf16 the dsum pre-pass and the key-outer kernel. queue_hd_bwd_plans
# holds the profiler's names to it; BWD_PRODUCTS counts the S^2 hd
# products of the kernels the profiler saw
HD_BWD_BARS = {"bf16": BWD_BF16_MAX_REL, "6-pass": BWD_FP32_MAX_REL,
               "3-pass": HIGH_BWD_MAX_REL}
HD_BWD_KERNELS = {
    **{("bf16", hd): (("attn_bwd_dq_wgmma", "attn_bwd_dkdv_wgmma"), None)
       for hd in (80, 128)},
    **{("bf16", hd): (("attn_bwd_dsum_wgmma", "attn_bwd_kv_wgmma"), None)
       for hd in (88, 104)},
    **{("6-pass", hd): (("attn_bwd_dq_6pass", "attn_bwd_dkdv_6pass"),
                        "split3_kernel") for hd in (80, 88, 104, 128)},
    **{("3-pass", hd): (("attn_bwd_dq_3pass_wgmma",
                         "attn_bwd_dkdv_3pass_wgmma"), "split2_kernel")
       for hd in (80, 88, 104, 128)}}
# S^2 hd products per kernel, by the start of its name: the pair's query-
# outer kernel 5 (S and dP for dsum, then S, dP and dQ), its key-outer one
# 4 (S^T, dP^T, dV, dK); the dsum pre-pass 2, the key-outer kernel 5 (its
# fifth, each query tile's dQ partial)
BWD_PRODUCTS = {"attn_bwd_dq_": 5, "attn_bwd_dkdv_": 4,
                "attn_bwd_dsum_": 2, "attn_bwd_kv_": 5}


def bwd_products(kernels) -> int:
    """The S^2 hd products of the backward kernels named ``kernels`` (the
    splits do none)."""
    return sum(n for name in kernels for start, n in BWD_PRODUCTS.items()
               if name.startswith(start))


def hd_bwd_plan(hd: int, route: str) -> str:
    """The name of 17c's (18c's) traced B2 row at ``hd`` on ``route``."""
    return f"{hd_phase(hd, 'c')} attention_packed_bwd hd {hd} {route}"


def queue_hd_bwd_plans() -> None:
    """17c and 18c, traced early: B2 at the step's [8, 1370, 3D] at every
    head dim of HD_GEOMETRIES and WIDE_GEOMETRIES on every route, queued
    for check_device_ops with the kernels HD_BWD_KERNELS names (and two
    splits on the fp32 routes). check_device_ops then fails unless the
    profiler sees each of them, and nothing else, and keeps each kernel's
    device time per call (DEVICE_OPS_SEEN), which hd_bwd_times reads: the
    launch counter counts launches, not which kernel ran, and phases 17 and
    18 run after the CLIs, when the profiler may return empty traces."""
    import torch

    from aaclip_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(57)
    for hd, H in HD_GEOMETRIES + WIDE_GEOMETRIES:
        for route, dtype_name, precision in HD_ROUTES:
            pair, split = HD_BWD_KERNELS[route, hd]
            dtype = torch_dtype(dtype_name)
            qkv = random_qkv(TRAIN_BATCH, 1370, H, hd, dtype, gen)
            d_out = torch.randn(TRAIN_BATCH, 1370, H * hd, generator=gen,
                                device="cuda").to(dtype)
            _, lse = A.attention_packed(qkv, H, 1370, return_lse=True,
                                        precision=precision)
            kernels_per_call(
                functools.partial(A.attention_packed_bwd, qkv, d_out, lse, H,
                                  1370, precision=precision),
                ("attention_packed", "attention_packed_bwd"),
                {**dict.fromkeys(pair, 1), **({split: 2} if split else {})},
                hd_bwd_plan(hd, route))


# 17d: the training CLI's synthetic set at ViT-H-14 (two classes), its
# images' side, and the precisions of the stage-2 step with their routes
VIT_H_TRAIN_PER_KIND = 4
VIT_H_STEP_ROUTES = (("bf16", "bf16"), ("fp32", "6-pass"),
                     ("fp32_high", "3-pass"))


def hd_bwd_check(hd: int, H: int, route: str, dtype_name: str, precision,
                 gen) -> float:
    """17c (18c at 88 and 104) at one head dim and route: B2 against its
    plain version at the step's batch 8 x S 1370 and at HD_RAGGED, each
    gradient's max |d| within HD_BWD_BARS of its max |value| (and bf16's
    mean within
    BWD_BF16_MEAN_REL); three runs bit-equal, the third after a call at
    another shape (the key-outer plan's counters are the call's own: a
    count left from another call would show); finite; no dK or dV past
    valid_len; the fp32 routes within SIX_FP64_MAX_REL of fp64 on two
    images of batch 8 (the 3-pass route within HIGH_FP64_MAX_REL, or
    HIGH_FP64_PLAIN_FACTOR times its plain version's own distance, at most
    HIGH_FP64_CEILING); every launch on the route's pair, after its two
    splits on the fp32 routes. Returns the largest max |d| at S 1370."""
    import torch

    from aaclip_tpu_torch.ops import attention as A

    dtype = torch_dtype(dtype_name)
    kw = dict(precision=precision)
    bar = HD_BWD_BARS[route]
    worst = 0.0
    # the call at another shape between the second and the third run
    o_qkv = random_qkv(1, 77, H, hd, dtype, gen)
    o_d = torch.randn(1, 77, H * hd, generator=gen, device="cuda").to(dtype)
    _, o_lse = A.attention_packed(o_qkv, H, 60, return_lse=True, **kw)
    for B, S, valid in [(TRAIN_BATCH, 1370, 1370)] + list(HD_RAGGED):
        what = f"{hd_phase(hd, 'c')} hd {hd} {route} B={B} S={S} valid={valid}"
        dm = H * hd
        qkv = random_qkv(B, S, H, hd, dtype, gen)
        d_out = torch.randn(B, S, dm, generator=gen, device="cuda").to(dtype)
        _, lse = A.attention_packed(qkv, H, valid, return_lse=True, **kw)
        before = hd_before(A.attention_packed_bwd)
        got = A.attention_packed_bwd(qkv, d_out, lse, H, valid, **kw)
        again = A.attention_packed_bwd(qkv, d_out, lse, H, valid, **kw)
        A.attention_packed_bwd(o_qkv, o_d, o_lse, H, 60, **kw)
        third = A.attention_packed_bwd(qkv, d_out, lse, H, valid, **kw)
        torch.cuda.synchronize()
        hd_route_counts(route, A.attention_packed_bwd, before, 4, 2, what)
        want = chunked(A.attention_packed_bwd_plain, qkv, d_out, H, valid,
                       **kw)
        parts = []
        for i, name in enumerate(("dq", "dk", "dv")):
            g = got[..., i * dm:(i + 1) * dm].float()
            w = want[..., i * dm:(i + 1) * dm].float()
            scale = w.abs().max().item()
            d = (g - w).abs()
            mx, mean = d.max().item(), d.mean().item()
            parts.append(f"{name} {mx / scale:.2e} (mean {mean / scale:.1e})")
            expect(mx <= bar * scale, f"{what}: {name} max|d| {mx} of "
                   f"{scale}")
            if dtype_name == "bf16":
                expect(mean <= BWD_BF16_MEAN_REL * scale,
                       f"{what}: {name} mean|d| {mean} of {scale}")
            if S == 1370:
                worst = max(worst, mx)
        same = torch.equal(got, again) and torch.equal(got, third)
        finite = bool(torch.isfinite(got).all())
        expect(same and finite, f"{what}: three runs differ, or not finite")
        if valid < S:  # keys past valid_len get no gradient
            tail = got[:, valid:, dm:].float().abs().max().item()
            expect(tail == 0.0, f"{what}: dk/dv past valid_len: {tail}")
        fp64 = ""
        if dtype_name == "fp32" and B == TRAIN_BATCH:
            exact = attention_fp64(qkv[:2], H, valid, d_out[:2])

            def from_fp64(t):
                return max(((t[:2, :, i * dm:(i + 1) * dm].double()
                             - exact[..., i * dm:(i + 1) * dm]).abs().max()
                            / exact[..., i * dm:(i + 1) * dm].abs().max()
                            ).item() for i in range(3))

            rel, rel_plain = from_fp64(got), from_fp64(want)
            fbar = SIX_FP64_MAX_REL if precision is None else min(
                HIGH_FP64_CEILING, max(HIGH_FP64_MAX_REL,
                                       HIGH_FP64_PLAIN_FACTOR * rel_plain))
            fp64 = (f"; from fp64 {rel:.3e} of the max (the plain version "
                    f"{rel_plain:.3e}; bar {fbar:.3e})")
            expect(rel <= fbar, f"{what}: {rel} from fp64 (bar {fbar})")
            expect(precision is None or rel_plain <= HIGH_FP64_CEILING,
                   f"{what}: the plain 3-pass backward {rel_plain} from fp64"
                   f" (ceiling {HIGH_FP64_CEILING})")
            del exact
        del want
        print(f"{what}: B2 max|d| of each gradient's max {', '.join(parts)} "
              f"(bar {bar}); three runs bit-equal (the third after a call "
              f"at [1, 77]) {same}; finite {finite}" + fp64)
        del qkv, d_out, lse, got, again, third
    return worst


def hd_bwd_times(hd: int, H: int, route: str, dtype_name: str, precision,
                 card, gen) -> tuple:
    """17c's (18c's) times at one head dim and route, at the step's [8,
    1370, 3D]:
    B2 (with its splits on the fp32 routes, as a call runs them) beside
    its plain version, SDPA's backward on the same inputs and its bound
    (the TPU kernel's five S^2 hd products in the route's bf16 passes at
    989 TFLOP/s, or the bytes; beside it the products of the kernels the
    profiler saw a call launch, queue_hd_bwd_plans' trace: nine for the
    pair, seven for the dsum pre-pass and the key-outer kernel); the
    kernels per call counted at the launch sites of both libraries; each
    kernel's device time per call from that trace; on bf16, the source's
    workspace query agreeing with the traced plan. Returns (ms, plain ms,
    SDPA ms, bound ms, bound_by, kernels per call, SDPA's backend: its
    forward's, whose backward autograd runs, the traced kernels' own
    products' bound ms, {traced kernel: device ms per call})."""
    import torch

    from aaclip_tpu_torch.kernels.build import kernels_launched
    from aaclip_tpu_torch.ops import attention as A

    dtype = torch_dtype(dtype_name)
    kw = dict(precision=precision)
    passes = {"bf16": 1, "6-pass": 6, "3-pass": 3}[route]
    pair, split = HD_BWD_KERNELS[route, hd]
    # the kernels the profiler saw (check_device_ops held them to pair and
    # split), each with its device ms per call
    traced = {k: us / 1e3 for k, us in
              DEVICE_OPS_SEEN[hd_bwd_plan(hd, route)].items()
              if k.startswith("attn_bwd_")}
    expect(all(t > 0 for t in traced.values()),
           f"{hd_phase(hd, 'c')} hd {hd} {route}: device time {traced}")
    own = bwd_products(traced)
    B, S, dm = TRAIN_BATCH, 1370, H * hd
    if route == "bf16":  # the workspace query takes the traced plan
        tiles = A._bwd_workspace_tiles()(1, hd, S)
        expect((tiles > 0) == ("attn_bwd_kv_wgmma" in traced),
               f"{hd_phase(hd, 'c')} hd {hd}: workspace {tiles} query "
               f"tiles for kernels {sorted(traced)}")
    qkv = random_qkv(B, S, H, hd, dtype, gen)
    d_out = torch.randn(B, S, dm, generator=gen, device="cuda").to(dtype)
    _, lse = A.attention_packed(qkv, H, S, return_lse=True, **kw)

    def call():
        return A.attention_packed_bwd(qkv, d_out, lse, H, S, **kw)

    ms = cuda_ms(call, 10)
    ms_plain = cuda_ms(lambda: A.attention_packed_bwd_plain(
        qkv, d_out, H, S, **kw), 2, warmup=1)
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(B, S, 3, H, hd).permute(2, 0, 3, 1, 4).unbind(0))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    g = d_out.view(B, S, H, hd).transpose(1, 2)
    ms_lib = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g,
                                                 retain_graph=True), 10)
    with torch.no_grad():
        backend = sdpa_backend(q, k, v)
    libs = ("attention_packed", "attention_packed_bwd")
    before = sum(kernels_launched(n) for n in libs)
    call()
    torch.cuda.synchronize()
    per_call = sum(kernels_launched(n) for n in libs) - before
    want = 2 + (2 if split else 0)
    expect(per_call == want, f"{hd_phase(hd, 'c')} hd {hd} {route}: "
           f"{per_call} kernels per call, not {want} ({pair}, {split})")
    flops = passes * 10 * B * H * S * S * hd
    nbytes = (2 * qkv.numel() + d_out.numel()) * qkv.element_size() + \
        lse.numel() * 4
    bound_ms, bound_by = bound(flops, nbytes)
    own_ms = own / 5 * flops / H100_BF16_FLOPS * 1e3
    print(f"time {hd_phase(hd, 'c')} attention_packed_bwd hd {hd} {route} "
          f"B={B} ({H} heads): {ms:.4f} ms/call ({flops / ms / 1e9:.1f} "
          f"TFLOP/s of the TPU kernel's five products in {passes} bf16 "
          f"pass(es), {own / 5 * flops / ms / 1e9:.1f} of the traced "
          f"kernels' own {own}; bound {bound_ms:.4f} ms by {bound_by}, "
          f"{own} products {own_ms:.4f}); plain {ms_plain:.4f}; SDPA "
          f"backward ({backend}) {ms_lib:.4f}; {per_call} kernels per call; "
          f"device ms per call (profiler, traced before phase 9) "
          + ", ".join(f"{k} {t:.4f}" for k, t in traced.items())
          + f" on {card}")
    del qkv, d_out, lse, q, k, v, out
    return (ms, ms_plain, ms_lib, bound_ms, bound_by, per_call, backend,
            own_ms, traced)


def check_neighbour_heads_bwd(hd: int, H: int, route: str, dtype_name: str,
                              precision) -> None:
    """18c: NaN and Inf written into the odd heads' columns of Q, K, V
    (as check_neighbour_heads writes them) and NaN into their columns of
    dO leave each even head's dQ, dK and dV finite and bit for bit as with
    those heads clean. At 88 and 104 the last k-step of S, dP, S^T and dP^T
    multiplies 8 columns past the head in both operands, which the
    per-head tensor maps give as zeros, and each gradient's last chunk is
    stored up to the head dim and not past it: a kernel that read the next
    head's columns there, or wrote into them, would show here."""
    import torch

    from aaclip_tpu_torch.ops import attention as A

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(61)
    B, S, valid = 2, 200, 150
    dm = H * hd
    kw = dict(precision=precision)
    clean = random_qkv(B, S, H, hd, dtype, gen)
    d_clean = torch.randn(B, S, dm, generator=gen, device="cuda").to(dtype)
    poisoned, d_poisoned = clean.clone(), d_clean.clone()
    odd = poisoned.view(B, S, 3, H, hd)[:, :, :, 1::2]
    odd[:, 0::2] = float("nan")
    odd[:, 1::2, ..., :hd // 2] = float("inf")
    odd[:, 1::2, ..., hd // 2:] = float("-inf")
    d_poisoned.view(B, S, H, hd)[:, :, 1::2] = float("nan")
    what = f"{hd_phase(hd, 'c')} hd {hd} {route} neighbour heads"

    def even_grads(x, d):
        _, lse = A.attention_packed(x, H, valid, return_lse=True, **kw)
        before = hd_before(A.attention_packed_bwd)
        g = A.attention_packed_bwd(x, d, lse, H, valid, **kw)
        hd_route_counts(route, A.attention_packed_bwd, before, 1, 2, what)
        return g.view(B, S, 3, H, hd)[:, :, :, 0::2]

    got = even_grads(poisoned, d_poisoned)
    want = even_grads(clean, d_clean)
    torch.cuda.synchronize()
    same = [torch.equal(got[:, :, i], want[:, :, i]) for i in range(3)]
    finite = bool(torch.isfinite(got).all())
    print(f"{what}: NaN / +-Inf in the odd heads' Q, K, V columns and NaN "
          f"in their dO columns; each even head's dQ, dK, dV bit for bit as "
          f"clean {same}, finite {finite}")
    expect(all(same) and finite,
           f"{what}: a head's gradients read or wrote its neighbour's "
           f"columns: {same}, finite {finite}")


def phase_head_dims_bwd(card, geometries=HD_GEOMETRIES,
                        phase: str = "17c") -> dict:
    """17c (18c at ``WIDE_GEOMETRIES``, with the neighbour-head check);
    returns {("attention_packed_bwd", hd, route): (ms, plain ms, SDPA ms,
    bound ms, bound_by, kernels per call, max |d|, SDPA's backend, the
    bound of the traced kernels' own products in ms, {traced kernel:
    device ms per call})}."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(54)
    rows = {}
    for hd, H in geometries:
        for route, dtype_name, precision in HD_ROUTES:
            worst = hd_bwd_check(hd, H, route, dtype_name, precision, gen)
            if hd % 16:  # the per-head maps' padded k-step
                check_neighbour_heads_bwd(hd, H, route, dtype_name,
                                          precision)
            times = hd_bwd_times(hd, H, route, dtype_name, precision, card,
                                 gen)
            rows[("attention_packed_bwd", hd, route)] = (*times[:6], worst,
                                                         *times[6:])
            gc.collect()
            torch.cuda.empty_cache()
    print(f"{phase} took {time.perf_counter() - t_phase:.0f} s")
    return rows


def step_launches() -> tuple:
    """(B1, its 6-pass, its 3-pass, B2, its 6-pass, its 3-pass, split3,
    split2) launches since the last ``zero_counts``."""
    from aaclip_tpu_torch.ops import attention as A

    f, b = A.attention_packed, A.attention_packed_bwd
    return (f.launches, f.launches_6pass, f.launches_3pass, b.launches,
            b.launches_6pass, b.launches_3pass, A.split3.launches,
            A.split2.launches)


def want_step_launches(route: str, fwd: int, bwd: int) -> tuple:
    """``step_launches`` of ``fwd`` B1 and ``bwd`` B2 launches all on
    ``route``, after one split per forward and two per backward on the
    fp32 routes."""
    split = fwd + 2 * bwd
    return {"bf16": (fwd, 0, 0, bwd, 0, 0, 0, 0),
            "6-pass": (fwd, fwd, 0, bwd, bwd, 0, split, 0),
            "3-pass": (fwd, 0, fwd, bwd, 0, bwd, 0, split)}[route]


def tower_steps(phase: str, model: str, cfg, acfg, card,
                remats=(False, True, "selective"),
                dp: bool = False) -> dict:
    """17d (ViT-H-14, every remat mode) and 18d (ViT-g-14, ViT-bigG-14,
    remat off): ``model`` @ 518's stage-2 step at batch 8 (random towers
    from seeds; the blocks up to the last tap, 24) in bf16, fp32 and
    fp32_high (the steps run it unstaged), each with every remat mode of
    ``remats``: 24 B1 (47 under full remat) and 23 B2 launches a step, all
    on the precision's route after its splits; each against the step on
    the plain attention (remat off) from the same adapter at phase 5's
    bars (loss, every adapter gradient's cosine and norm); with remat off
    images/s and the kernel step's ``torch.cuda.max_memory_allocated``.
    With ``dp`` also the DP stage-2 step at world 1 (``dp_world1``) on the
    same tower. Returns {path: (B1, B2) launches}."""
    import gc

    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)

    heads, img = cfg.vision.heads, cfg.vision.image_size
    depth = max(acfg.levels)
    gen = torch.Generator(device="cuda").manual_seed(55)
    vit = init_vision_params(cfg, seed=0)
    adapter = init_image_adapter(cfg, acfg, seed=1)
    table = unit_table(cfg.embed_dim, gen)
    batch = train_batch(TRAIN_BATCH, img, gen)
    calls = {}
    for name, route in VIT_H_STEP_ROUTES:
        policy = DtypePolicy.from_name(name)
        loss_p, g_p, fwd_p, bwd_p, _ = train_step_once(
            vit, cfg, acfg, adapter, batch, table, policy=policy,
            attn_fn=make_attn_fn_plain(heads, policy, differentiable=True),
            remat=False)
        expect(fwd_p == bwd_p == 0, f"{phase} {name}: the plain step "
               f"launched")
        for remat in remats:
            what = (f"{phase} {model} stage-2 step {name} B={TRAIN_BATCH} "
                    f"remat {REMAT_NAMES[remat]}")
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            loss_k, g_k, _, _, (ad, opt, sched, step) = train_step_once(
                vit, cfg, acfg, adapter, batch, table, policy=policy,
                remat=remat)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            got = step_launches()
            want = want_step_launches(
                route, S2_FWD_PER_STEP_REMAT if remat is True else depth,
                depth - 1)
            expect(got == want, f"{what}: B1, 6-pass, 3-pass, B2, 6-pass, "
                   f"3-pass, split3, split2 {got}, not {want}")
            rel, cos, norm = step_vs_plain(loss_k, g_k, loss_p, g_p, what)
            rate = ""
            if remat is False:  # the other modes are checked, not timed
                ms = cuda_ms(lambda: step(ad, *batch), 2, warmup=1)
                rate = (f"; {ms:.2f} ms/step, {TRAIN_BATCH / ms * 1e3:.2f} "
                        f"images/s, the kernel step's peak "
                        f"{peak:.2f} GiB allocated on {card}")
            print(f"{what}: launches {got}; loss {loss_k:.6f} vs plain "
                  f"{loss_p:.6f} ({rel:.3e} relative); gradients over "
                  f"{len(g_k)} leaves: min cosine {cos:.8f}, max |norm "
                  f"ratio - 1| {norm:.3e}" + rate)
            calls[f"{model} stage-2 step {name}, remat "
                  f"{REMAT_NAMES[remat]}"] = (got[0], got[3])
            del ad, opt, sched, step, g_k
            gc.collect()
            torch.cuda.empty_cache()
        del g_p
    if dp:
        per_step = dp_world1(phase, model, vit, cfg, acfg, adapter, gen)
        calls[f"{model} DP stage-2 step (world 1), per step"] = per_step
    del vit, adapter, batch
    gc.collect()
    torch.cuda.empty_cache()
    return calls


def vit_l_hd128_config():
    """ViT-L-14-336 @ 518 with its 1024 columns in 8 heads of 128 (the
    geometry JAX's gate and the port's fused gate admit)."""
    import dataclasses

    from aaclip_tpu_torch.core.config import get_config

    base = get_config("ViT-L-14-336", img_size=518)
    return dataclasses.replace(base, vision=dataclasses.replace(
        base.vision, heads=8))


def hd128_step(card) -> tuple:
    """17d: the stage-2 step at ViT-L in 8 heads of 128, bf16, batch 8,
    remat off, against the plain-attention step at phase 5's bars; 24 B1
    and 23 B2 launches on the bf16 route. Returns (B1, B2) launches."""
    import gc

    import torch

    from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)

    cfg = vit_l_hd128_config()
    acfg = AdapterConfig()
    n_layers, img = cfg.vision.layers, cfg.vision.image_size
    gen = torch.Generator(device="cuda").manual_seed(56)
    vit = init_vision_params(cfg, seed=0)
    adapter = init_image_adapter(cfg, acfg, seed=1)
    table = unit_table(cfg.embed_dim, gen)
    batch = train_batch(TRAIN_BATCH, img, gen)
    bf16 = DtypePolicy.bf16()
    loss_p, g_p, *_ = train_step_once(
        vit, cfg, acfg, adapter, batch, table, policy=bf16,
        attn_fn=make_attn_fn_plain(8, bf16, differentiable=True),
        remat=False)
    zero_counts()
    loss_k, g_k, _, _, (ad, _, _, step) = train_step_once(
        vit, cfg, acfg, adapter, batch, table, policy=bf16, remat=False)
    got = step_launches()
    what = (f"17d stage-2 step bf16 B={TRAIN_BATCH}, ViT-L in 8 heads of "
            f"128, remat off")
    expect(got == want_step_launches("bf16", n_layers, n_layers - 1),
           f"{what}: launches {got}")
    rel, cos, norm = step_vs_plain(loss_k, g_k, loss_p, g_p, what)
    ms = cuda_ms(lambda: step(ad, *batch), 2, warmup=1)
    print(f"{what}: launches {got}; loss {loss_k:.6f} vs plain "
          f"{loss_p:.6f} ({rel:.3e} relative); min cosine {cos:.8f}, max "
          f"|norm ratio - 1| {norm:.3e}; {TRAIN_BATCH / ms * 1e3:.2f} "
          f"images/s on {card}")
    del vit, adapter, ad, step
    gc.collect()
    torch.cuda.empty_cache()
    return got[0], got[3]


def model_train_cli(phase: str, model: str, cfg, card, tmp: str,
                    ckpt_path: str) -> tuple:
    """17d (ViT-H-14), 18d (ViT-g-14): ``python -m aaclip_tpu_torch.train
    --model_name <model>`` in bf16 from the seeded checkpoint, one text
    and one image epoch on two synthetic MVTec classes of
    VIT_H_TRAIN_PER_KIND normal and anomalous images (batches 16 and 2,
    ``--remat auto``: selective): one B1 launch a block in a features
    call, 24 B1 and 23 B2 a step, every loss finite, each epoch's logged
    img/s. Returns (its save path, whose checkpoints ``model_eval_cli``
    evaluates, and {path: (B1, B2) launches})."""
    import gc
    import os

    import numpy as np
    import torch

    from aaclip_tpu_torch.data.registry import CLASS_NAMES
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset

    n_layers, depth = cfg.vision.layers, 24
    classes = CLASS_NAMES["MVTec"][:2]
    data_root, meta_root = make_synthetic_dataset(
        os.path.join(tmp, "train_set"), class_names=classes,
        n_normal=VIT_H_TRAIN_PER_KIND, n_anomalous=VIT_H_TRAIN_PER_KIND,
        img_px=VIT_H_EVAL_PX, hard=True)
    os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
    n_img = 2 * 2 * VIT_H_TRAIN_PER_KIND
    n_feat, n_step = -(-n_img // 16), -(-n_img // 2)
    save = os.path.join(tmp, f"train_{model}")
    common = ["--model_name", model, "--clip_checkpoint", ckpt_path,
              "--dataset", "MVTec", "--precision", "bf16", "--save_path",
              save]
    zero_counts()
    t0 = time.perf_counter()
    losses = train_cli_losses(common + ["--training_mode", "full_shot",
                                        "--text_epoch", "1",
                                        "--image_epoch", "1"])
    wall = time.perf_counter() - t0
    got = counts()
    want = (n_layers * n_feat + depth * n_step, 0, (depth - 1) * n_step)
    with open(os.path.join(save, "train.log")) as f:
        log = f.read()
    reports = epoch_reports(log)
    print(f"{phase} training CLI {model} bf16: {n_feat} features call(s), "
          f"{n_step} stage-2 steps: attention_packed, V-V, backward "
          f"launches {got} (want {want}); epoch means "
          f"{[round(float(np.mean(e)), 6) for e in losses]}; "
          + "; ".join(f"{stage} epoch {epoch} {rate:.2f} img/s logged"
                      for stage, epoch, rate, _ in reports)
          + f"; {wall:.1f} s for main() on {card}")
    expect(got == want, f"{phase} training CLI: launches {got}, not {want}")
    expect([len(e) for e in losses] == [n_feat, n_step]
           and all(np.isfinite(v).all() for v in losses),
           f"{phase} training CLI: steps {[len(e) for e in losses]}, or a "
           f"loss is not finite")
    expect("stage 2 selective" in log, f"{phase} training CLI: remat not "
           "selective")
    gc.collect()
    torch.cuda.empty_cache()
    return save, {f"{model} training CLI bf16": (got[0], got[2])}


def model_engine(phase: str, name: str, cfg, card) -> int:
    """17d (ViT-H-14), 18b (ViT-bigG-14): the serving engine at ``name`` @
    518 (bf16, seeded towers and adapters, max_batch 8): eight concurrent
    ``submit`` calls against the engine's own predict on the same images
    and anchors at phase 12's bars (PIX_SPAN_FRAC_BF16 of the map's span,
    SCORE_ATOL_BF16), 24 B1 launches a served batch. Returns B1's launches
    per batch."""
    import gc
    import threading

    import numpy as np
    import torch

    from aaclip_tpu_torch.ops.attention import attention_packed
    from aaclip_tpu_torch.serve import server

    img, depth = cfg.vision.image_size, 24
    engine = server.InferenceEngine(model_name=name, img_size=img,
                                    datasets=("MVTec",), precision="bf16",
                                    max_batch=8, precompile=False)
    try:
        rng = np.random.default_rng(57)
        imgs = rng.integers(0, 256, (8, 3, img, img), dtype=np.uint8)
        classes = [SERVE_CLASSES[i % 3] for i in range(8)]
        results = [None] * 8

        def fire(i):
            results[i] = engine.submit(imgs[i], "MVTec", classes[i])

        zero_counts()
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batches = engine.stats()["batches"]
        launches = attention_packed.launches
        anch = np.stack([engine.anchors["MVTec"][c] for c in classes])
        with torch.inference_mode():
            pix, score = engine._predict(
                engine.image_adapter, torch.from_numpy(imgs).cuda(),
                torch.from_numpy(anch).cuda(), engine._postproc_dev["MVTec"])
        pix, score = pix.cpu().numpy(), score.cpu().numpy()
        span = float(pix.max() - pix.min())
        dmap = max(float(np.abs(m - pix[i]).max())
                   for i, (m, _) in enumerate(results))
        dscore = max(abs(float(s) - float(score[i]))
                     for i, (_, s) in enumerate(results))
        print(f"{phase} serving engine {name} bf16: 8 concurrent requests in "
              f"{batches} batch(es), {launches} B1 launches; against the "
              f"engine's predict at B=8: max|d map| {dmap / span:.3e} of the "
              f"span (bar {PIX_SPAN_FRAC_BF16}), max|d score| {dscore:.3e} "
              f"(bar {SCORE_ATOL_BF16}) on {card}")
        expect(launches == depth * batches,
               f"{phase} engine: {launches} B1 launches for {batches} "
               f"batches")
        expect(dmap <= PIX_SPAN_FRAC_BF16 * span
               and dscore <= SCORE_ATOL_BF16,
               f"{phase} engine: map {dmap} of {span}, scores {dscore}")
        return launches // batches
    finally:
        engine.shutdown()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def dp_world1(phase: str, model: str, vit, cfg, acfg, adapter,
              gen) -> tuple:
    """17d (ViT-H-14), 18d (ViT-bigG-14): the DP stage-2 step at world 1
    (NCCL), two steps bf16 at batch 8 (``dp_step_world1``), in a process
    group of one this process starts and ends. Returns the (B1, B2)
    launches per step."""
    import os

    import torch.distributed as dist

    from aaclip_tpu_torch.parallel import sharding as sh

    img = cfg.vision.image_size
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    env_before = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    try:
        expect(sh.initialize_multihost(), f"{phase}: no process group")
        per_step = dp_step_world1(
            vit, cfg, acfg, adapter, sh.make_data_mesh(),
            train_batch(TRAIN_BATCH, img, gen),
            unit_table(cfg.embed_dim, gen),
            f"{phase} DP stage-2 step {model} (NCCL)")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return per_step[0], per_step[2]


def vit_h_int8_and_bank(cfg, acfg, card) -> dict:
    """17d at ViT-H-14 @ 518 (random towers from seeds), through the
    checks phases 12a, 13a and 14a hold at ViT-L: (a) the int8 predict at
    batch 8 (``check_int8``), its distance from the bf16 predict printed as
    phase 13 prints it; (b) the memory bank (``check_memory_bank``); (c)
    the DP stage-2 step at world 1 (``dp_world1``). Returns {path: (B1,
    B2) launches}."""
    import gc

    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix

    img = cfg.vision.image_size
    gen = torch.Generator(device="cuda").manual_seed(58)
    vit = init_vision_params(cfg, seed=0)
    adapter = init_image_adapter(cfg, acfg, seed=1)
    anchors = torch.randn(cfg.embed_dim, 2, generator=gen, device="cuda")
    anchors = anchors / anchors.norm(dim=0, keepdim=True)
    M = torch.from_numpy(fused_postproc_matrix(cfg.vision.grid, img,
                                               "Industrial")).cuda()
    calls = {}
    images = torch.randint(0, 256, (MB_BATCH, 3, img, img), generator=gen,
                           device="cuda", dtype=torch.uint8)

    # (a) int8
    p8, pix_k, s_k, launched, _ = check_int8(
        vit, adapter, cfg, acfg, images, anchors, M, "17d ViT-H-14")
    pb = make_predict_fn(vit, cfg, acfg, policy=DtypePolicy.bf16(),
                         uint8_inputs=True)
    int8_distances(pix_k, s_k, {"bf16": pb(adapter, images, anchors, M)})
    calls["ViT-H-14 int8 predict"] = (launched, 0)
    del p8, pb, pix_k, s_k
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the memory bank
    r = check_memory_bank(vit, adapter, cfg, acfg, anchors, M, gen,
                          "17d ViT-H-14")
    calls["ViT-H-14 memory-bank features batch"] = (r["feat"], 0)
    calls["ViT-H-14 memory-bank predict"] = (r["mb"], 0)
    del r
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the DP stage-2 step at world 1
    calls["ViT-H-14 DP stage-2 step (world 1), per step"] = dp_world1(
        "17d", "ViT-H-14", vit, cfg, acfg, adapter, gen)
    del vit, adapter
    gc.collect()
    torch.cuda.empty_cache()
    return calls


def phase_head_dims(card) -> dict:
    """Phase 17; returns {"kernels": 17a's and 17c's rows, "calls": {path:
    B1 launches} of 17b and 17d's evaluation CLI, "steps": {path: (B1, B2)
    launches} of 17d, "rates": {precision: maps/s}}."""
    import os
    import shutil
    import tempfile

    from aaclip_tpu_torch.core import config as C
    from aaclip_tpu_torch.core.config import AdapterConfig, get_config

    t_phase = time.perf_counter()
    rows = phase_head_dims_kernels(card)
    rows.update(phase_head_dims_bwd(card))
    tmp = tempfile.mkdtemp(prefix="aaclip_vit_h_")
    env = {k: os.environ.get(k) for k in ("AACLIP_MODEL_CONFIGS",
                                          "AACLIP_DATA", "AACLIP_METADATA")}
    try:
        configs = os.path.join(tmp, "configs")
        os.makedirs(configs)
        with open(os.path.join(configs, "ViT-H-14.json"), "w") as f:
            json.dump(VIT_H_14, f)
        os.environ["AACLIP_MODEL_CONFIGS"] = configs
        C._scan_json_configs()
        cfg = get_config("ViT-H-14", img_size=518)
        v = cfg.vision
        expect((v.layers, v.width, v.heads, v.head_dim, v.seq_len,
                cfg.embed_dim) == (32, 1280, 16, 80, 1370, 1024),
               f"17b: ViT-H-14 read as {v}")
        acfg = AdapterConfig()
        print(f"[{time.perf_counter() - t_phase:.0f} s] 17b")
        calls = tower_predicts("17b", "ViT-H-14", cfg, acfg, card)
        rates = model_bench("17b", "ViT-H-14", card)
        calls["fused predict bf16, ViT-L in 8 heads of 128"] = \
            hd128_fused_predict(card)
        t_d = time.perf_counter()
        print(f"[{t_d - t_phase:.0f} s] 17d")
        steps = tower_steps("17d", "ViT-H-14", cfg, acfg, card)
        steps["stage-2 step bf16, ViT-L in 8 heads of 128"] = \
            hd128_step(card)
        ckpt_path = write_model_checkpoint("17d", "ViT-H-14", tmp, card)
        save, trained = model_train_cli("17d", "ViT-H-14", cfg, card, tmp,
                                        ckpt_path)
        steps.update(trained)
        calls["ViT-H-14 evaluation CLI bf16"] = model_eval_cli(
            "17d", "ViT-H-14", cfg, acfg, card, tmp, ckpt_path, save)
        steps["ViT-H-14 serving engine, per batch"] = (
            model_engine("17d", "ViT-H-14", cfg, card), 0)
        steps.update(vit_h_int8_and_bank(cfg, acfg, card))
        print(f"17d took {time.perf_counter() - t_d:.0f} s")
    finally:
        for k, val in env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        C.MODEL_CONFIGS.pop("ViT-H-14", None)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 17 (head dims 80 and 128, ViT-H-14) took "
          f"{time.perf_counter() - t_phase:.0f} s")
    return {"kernels": rows, "calls": calls, "steps": steps, "rates": rates}


# ---------------------------------------------------------------------------
# Phase 18: the packed attention at head dims 88 and 104 (the forward B1,
# B3 and B4, and the backward B2, on the bf16, 6-pass and 3-pass routes)
# and open_clip's ViT-g-14 and ViT-bigG-14 @ 518 through the predict, the
# evaluation CLI, the serving engine, stage-1's spatial features, the
# stage-2 step, the training CLI and the DP step

# open_clip's published ViT-g-14 and ViT-bigG-14 (its
# model_configs/ViT-g-14.json and ViT-bigG-14.json), written at run time
# into a temporary directory that AACLIP_MODEL_CONFIGS names. ViT-g-14: 40
# vision blocks of width 1408 in 16 heads of 88, MLP 6144 (mlp_ratio
# 4.3637); text width 1024, 16 heads, 24 blocks; embed 1024. ViT-bigG-14:
# 48 blocks of 1664 in 16 heads of 104, MLP 8192 (4.9231); text 1280, 20
# heads, 32 blocks; embed 1280. Patch 14; random weights from seeds, the
# vision towers seeded on the card; at 518 px S 1370.
VIT_G_14 = {
    "embed_dim": 1024,
    "vision_cfg": {"image_size": 224, "layers": 40, "width": 1408,
                   "head_width": 88, "mlp_ratio": 4.3637, "patch_size": 14},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 1024,
                 "heads": 16, "layers": 24},
}
VIT_BIGG_14 = {
    "embed_dim": 1280,
    "vision_cfg": {"image_size": 224, "layers": 48, "width": 1664,
                   "head_width": 104, "mlp_ratio": 4.9231, "patch_size": 14},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 1280,
                 "heads": 20, "layers": 32},
}
WIDE_CONFIGS = {"ViT-g-14": VIT_G_14, "ViT-bigG-14": VIT_BIGG_14}
# (layers, width, heads, head dim, MLP width, S at 518, embed) each must
# read as
WIDE_ARCH = {"ViT-g-14": (40, 1408, 16, 88, 6144, 1370, 1024),
             "ViT-bigG-14": (48, 1664, 16, 104, 8192, 1370, 1280)}
# 18a: (head dim, heads) of the two towers
WIDE_GEOMETRIES = ((88, 16), (104, 16))


def phase_wide_head_dims(card) -> dict:
    """Phase 18: 18a (the forward kernels at 88 and 104), 18c (the
    backward's), 18b (both towers' predicts, bench, the engine at
    ViT-bigG-14, ViT-g-14's spatial features, the gate) and 18d (both
    towers' stage-2 steps in bf16, fp32 and fp32_high at batch 8, remat
    off; the DP step at world 1 at ViT-bigG-14; the training CLI at
    ViT-g-14 from a seeded fp16 checkpoint, then the evaluation CLI on its
    checkpoints, its scores bit for bit a direct predict's). Returns
    {"kernels": 18a's and 18c's rows, "calls": {path: B1 (or B3)
    launches} of 18b and the evaluation CLI, "steps": {path: (B1, B2)
    launches} of 18d, "rates": {model: bf16 maps/s}}."""
    import os
    import shutil
    import tempfile

    import torch

    from aaclip_tpu_torch.core import config as C
    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.ops import fused_block as FB

    t_phase = time.perf_counter()
    rows = phase_head_dims_kernels(card, WIDE_GEOMETRIES, "18a")
    rows.update(phase_head_dims_bwd(card, WIDE_GEOMETRIES, "18c"))
    tmp = tempfile.mkdtemp(prefix="aaclip_wide_")
    env = {k: os.environ.get(k) for k in ("AACLIP_MODEL_CONFIGS",
                                          "AACLIP_DATA", "AACLIP_METADATA")}
    calls, rates = {}, {}
    try:
        configs = os.path.join(tmp, "configs")
        os.makedirs(configs)
        for name, payload in WIDE_CONFIGS.items():
            with open(os.path.join(configs, f"{name}.json"), "w") as f:
                json.dump(payload, f)
        os.environ["AACLIP_MODEL_CONFIGS"] = configs
        C._scan_json_configs()
        t_b = time.perf_counter()
        print(f"[{t_b - t_phase:.0f} s] 18b")
        acfg = AdapterConfig()
        cfgs = {}
        for name in WIDE_CONFIGS:
            cfg = cfgs[name] = get_config(name, img_size=518)
            v = cfg.vision
            arch = (v.layers, v.width, v.heads, v.head_dim,
                    int(v.width * v.mlp_ratio), v.seq_len, cfg.embed_dim)
            expect(arch == WIDE_ARCH[name], f"18b: {name} read as {arch}")
            block = FB.maybe_make_block_fn(cfg, DtypePolicy.bf16())
            print(f"18b {name}: (layers, width, heads, head dim, MLP, S, "
                  f"embed) {arch}; text {cfg.text.layers} x "
                  f"{cfg.text.width} in {cfg.text.heads} heads; the fused "
                  f"block's gate gives {block} (JAX's gate refuses 2 x "
                  f"{v.head_dim} columns)")
            expect(block is None and not FB.reference_gate(cfg),
                   f"18b {name}: the fused-block gate gave {block}")
            calls.update(tower_predicts("18b", name, cfg, acfg, card,
                                        features=name == "ViT-g-14",
                                        sdpa_yardstick=True))
            rates.update({f"{name} {k}": r for k, r in model_bench(
                "18b", name, card, runs=(("bf16", 32),)).items()})
        calls["ViT-bigG-14 serving engine, per batch"] = model_engine(
            "18b", "ViT-bigG-14", cfgs["ViT-bigG-14"], card)
        t_d = time.perf_counter()
        print(f"18b took {t_d - t_b:.0f} s")
        print(f"[{t_d - t_phase:.0f} s] 18d")
        steps = tower_steps("18d", "ViT-g-14", cfgs["ViT-g-14"], acfg, card,
                            remats=(False,))
        steps.update(tower_steps("18d", "ViT-bigG-14", cfgs["ViT-bigG-14"],
                                 acfg, card, remats=(False,), dp=True))
        ckpt_path = write_model_checkpoint("18d", "ViT-g-14", tmp, card,
                                           half=True)
        save, trained = model_train_cli("18d", "ViT-g-14", cfgs["ViT-g-14"],
                                        card, tmp, ckpt_path)
        steps.update(trained)
        calls["ViT-g-14 evaluation CLI bf16"] = model_eval_cli(
            "18d", "ViT-g-14", cfgs["ViT-g-14"], acfg, card, tmp, ckpt_path,
            save)
        os.remove(ckpt_path)
        print(f"18d took {time.perf_counter() - t_d:.0f} s")
    finally:
        for k, val in env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        for name in WIDE_CONFIGS:
            C.MODEL_CONFIGS.pop(name, None)
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"phase 18 (head dims 88 and 104, ViT-g-14 and ViT-bigG-14) took "
          f"{time.perf_counter() - t_phase:.0f} s")
    return {"kernels": rows, "calls": calls, "steps": steps, "rates": rates}


def head_dim_rows(head_dims: dict, wide: dict) -> list:
    """Phase 17's and 18's rows of the kernel line: each kernel at head
    dims 80 and 128 (``head_dims``, phase 17) and 88 and 104 (``wide``,
    phase 18) on each route, with its launches on the paths of that head
    dim and route (B1: the ViT-H-14, ViT-g-14 and ViT-bigG-14 predicts,
    3-pass counting the staged predict's 3-pass blocks, and at 128 the
    fused bf16 predict; the evaluation CLIs, engines, 17d's and 18d's
    steps, int8 and bank paths; B3 bf16 at 80 and 88: the spatial
    features; B2: 17d's and 18d's steps, training CLIs and DP steps; none
    for B4 and the fp32 V-V, which no path of these phases runs),
    ``launches`` the first path's."""
    hc17 = {**head_dims["calls"], **wide["calls"]}
    st17 = {**head_dims["steps"], **wide["steps"]}
    h14 = "ViT-H-14 stage-2 step"
    g14, bigg = "ViT-g-14 stage-2 step", "ViT-bigG-14 stage-2 step"
    step_paths = {
        (80, "bf16"): [f"{h14} bf16, remat {r}" for r in REMAT_NAMES.values()]
        + ["ViT-H-14 training CLI bf16",
           "ViT-H-14 DP stage-2 step (world 1), per step"],
        (80, "6-pass"): [f"{h14} fp32, remat {r}"
                         for r in REMAT_NAMES.values()],
        (80, "3-pass"): [f"{h14} fp32_high, remat {r}"
                         for r in REMAT_NAMES.values()],
        (128, "bf16"): ["stage-2 step bf16, ViT-L in 8 heads of 128"],
        (88, "bf16"): [f"{g14} bf16, remat off", "ViT-g-14 training CLI bf16"],
        (88, "6-pass"): [f"{g14} fp32, remat off"],
        (88, "3-pass"): [f"{g14} fp32_high, remat off"],
        (104, "bf16"): [f"{bigg} bf16, remat off",
                        "ViT-bigG-14 DP stage-2 step (world 1), per step"],
        (104, "6-pass"): [f"{bigg} fp32, remat off"],
        (104, "3-pass"): [f"{bigg} fp32_high, remat off"]}
    b1_paths = {
        ("attention_packed", 80, "bf16"): (
            "ViT-H-14 predict bf16", "ViT-H-14 evaluation CLI bf16"),
        ("attention_packed", 80, "6-pass"): ("ViT-H-14 predict fp32",),
        ("attention_packed", 80, "3-pass"): ("ViT-H-14 predict fp32_high",),
        ("attention_packed_vv", 80, "bf16"): (
            "ViT-H-14 stage-1 spatial features bf16",),
        ("attention_packed", 128, "bf16"): (
            "fused predict bf16, ViT-L in 8 heads of 128",),
        ("attention_packed", 88, "bf16"): (
            "ViT-g-14 predict bf16", "ViT-g-14 evaluation CLI bf16"),
        ("attention_packed", 88, "6-pass"): ("ViT-g-14 predict fp32",),
        ("attention_packed", 88, "3-pass"): ("ViT-g-14 predict fp32_high",),
        ("attention_packed_vv", 88, "bf16"): (
            "ViT-g-14 stage-1 spatial features bf16",),
        ("attention_packed", 104, "bf16"): (
            "ViT-bigG-14 predict bf16",
            "ViT-bigG-14 serving engine, per batch"),
        ("attention_packed", 104, "6-pass"): ("ViT-bigG-14 predict fp32",),
        ("attention_packed", 104, "3-pass"): (
            "ViT-bigG-14 predict fp32_high",)}
    b1_steps = {(80, "bf16"): [
        "ViT-H-14 serving engine, per batch", "ViT-H-14 int8 predict",
        "ViT-H-14 memory-bank features batch",
        "ViT-H-14 memory-bank predict"]}
    replaces17 = {"attention_packed": "aaclip_tpu/ops/flash_attention.py:190",
                  "attention_packed_vv":
                      "aaclip_tpu/ops/flash_attention.py:190",
                  "attention_kernel": "aaclip_tpu/ops/flash_attention.py:94",
                  "attention_packed_bwd":
                      "aaclip_tpu/ops/flash_attention.py:302"}
    hd_rows = []
    for (name, hd, route), t in {**head_dims["kernels"],
                                 **wide["kernels"]}.items():
        if name == "attention_packed_bwd":
            paths = {p: st17[p][1] for p in step_paths.get((hd, route), ())}
        else:
            paths = {p: hc17[p] for p in b1_paths.get((name, hd, route), ())}
            if name == "attention_packed":
                paths.update({p: st17[p][0] for p in
                              step_paths.get((hd, route), [])
                              + b1_steps.get((hd, route), [])})
        source = ("attention_packed_bwd.cu" if name == "attention_packed_bwd"
                  else "attention_packed.cu")
        hd_rows.append({
            "name": f"{name} (hd {hd}"
                    + ("" if route == "bf16" else f", {route}") + ")",
            "route": "cuda",
            "source": f"aaclip_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces17[name],
            "launches": next(iter(paths.values()), 0),
            "calls": paths,
            "kernels_per_call": t[5],
            "max_abs_err": t[6],
            "ms": t[0],
            "plain_ms": t[1],
            "bound_ms": t[3],
            "bound_by": t[4],
            "library_ms": t[2],
            "library": ("SDPA backward" if name == "attention_packed_bwd"
                        else "SDPA") + f" ({t[7]})",
        })
        if name == "attention_packed_bwd":  # the traced kernels
            hd_rows[-1].update(kernels=t[9], own_products=bwd_products(t[9]),
                               own_bound_ms=t[8])
    return hd_rows


def export_artifact_main(spec: str) -> int:
    """``chip_smoke.py --export-artifact JSON``:
    ``deploy.export_serving_artifact`` with the keyword arguments ``JSON``
    gives it (phase 13c's int8 export, beside the bf16 one), TF32 off as
    in ``main``; prints the manifest's ``verify``, ``export_s``,
    ``native_kernels`` and ``untrained``, and the export's seconds, as an
    ``ARTIFACT_MANIFEST`` line."""
    import torch

    from aaclip_tpu_torch import deploy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = json.loads(spec)
    out_dir = kw.pop("out_dir")
    kw["datasets"] = tuple(kw["datasets"])
    kw["batch_sizes"] = tuple(kw["batch_sizes"])
    t0 = time.perf_counter()
    m = deploy.export_serving_artifact(out_dir, **kw)
    wall = time.perf_counter() - t0
    print("ARTIFACT_MANIFEST " + json.dumps(
        {**{k: m[k] for k in ("verify", "export_s", "native_kernels",
                              "untrained")}, "wall": wall}), flush=True)
    return 0


def cli_ranks_main(spec: str) -> int:
    """``chip_smoke.py --parallel-clis JSON``: one rank (under torchrun) of
    the evaluation CLI, the training CLI and the bench, each with the argv
    ``JSON`` gives it (phase 14d); prints the training CLI's per-step
    losses as a ``CLI_LOSSES`` line and the bench's JSON as a
    ``BENCH_LINE`` line."""
    import contextlib
    import io

    from aaclip_tpu_torch import bench
    from aaclip_tpu_torch import test as eval_cli

    argv = json.loads(spec)
    eval_cli.main(argv["test"])
    losses = train_cli_losses(argv["train"])
    print("CLI_LOSSES " + json.dumps(losses), flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(argv["bench"])
    print("BENCH_LINE " + buf.getvalue().strip().splitlines()[-1],
          flush=True)
    return 0


def make_attn_fn_plain(heads: int, policy, *, vv: bool = False,
                       differentiable: bool = False):
    """``make_attn_fn`` on the plain attention of its kind."""
    from aaclip_tpu_torch.ops import attention as A

    plain = (A.attention_packed_vv_plain if vv else
             A.attention_packed_diff_plain if differentiable else
             A.attention_packed_plain)
    return A.make_attn_fn(heads, policy, vv=vv, differentiable=differentiable,
                          attention=plain)


def main() -> int:
    import os

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from aaclip_tpu_torch.core.config import AdapterConfig, get_config
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.device import card_line
    from aaclip_tpu_torch.kernels.build import KERNELS, build_all
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")

    # -- 2. build
    t0 = time.perf_counter()
    built = build_all()
    print(f"built {', '.join(p.name for p, _ in built.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        for line in built[name][1].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "(C75")):  # C75xx: wgmma notes
                print(f"  nvcc {name}:", line.strip())

    # -- 3. kernels vs plain
    print(f"[{time.perf_counter() - t0:.0f} s] kernels vs plain")
    # {dtype: the largest max |d| at the main paths' shapes}; fp32 at head
    # dim 64 is the 6-pass route
    err_fwd = {d: check_kernel(d) for d in DTYPES}
    err_bwd = {d: check_bwd_kernel(d) for d in DTYPES}
    for d in DTYPES:
        check_tail_isolation(d)
    check_matmul_f32_grad()
    err_vv = {d: check_vv_kernel(d) for d in DTYPES}
    err_high = check_kernels_3pass()
    check_split3()
    check_fp64_distances()

    cfg = get_config("ViT-L-14-336", img_size=518)
    acfg = AdapterConfig()
    vit = init_vision_params(cfg, seed=0)
    adapter = init_image_adapter(cfg, acfg, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    anchors = torch.randn(cfg.embed_dim, 2, generator=gen, device="cuda")
    anchors = anchors / anchors.norm(dim=0, keepdim=True)
    M = torch.from_numpy(fused_postproc_matrix(cfg.vision.grid, 518,
                                               "Industrial")).cuda()

    # -- 4, 6a. inference path
    print(f"[{time.perf_counter() - t0:.0f} s] inference path")
    (fwd_launches, fwd_per_call, ms_fwd, ms_fwd_plain, ms_sdpa, fwd_bound,
     fwd_bound_by) = phase_predict(vit, adapter, cfg, acfg, anchors, M, card,
                                   gen)
    # -- 5, 6b. stage-2 training step
    print(f"[{time.perf_counter() - t0:.0f} s] stage-2 step")
    train_steps = phase_train(vit, adapter, cfg, acfg, card)
    train_fwd, train_bwd = train_steps["off"]
    expect(train_fwd == fwd_launches, "forward launches differ by path")
    # -- 5b. the fp32 step and spatial features on the 6-pass kernels
    print(f"[{time.perf_counter() - t0:.0f} s] fp32 step and features")
    phase_fp32_paths(vit, adapter, cfg, acfg)
    # -- 6c. backward timings
    print(f"[{time.perf_counter() - t0:.0f} s] backward timings")
    (bwd_per_call, ms_bwd, ms_bwd_plain, ms_sdpa_bwd, bwd_bound,
     bwd_bound_by) = time_bwd(cfg, card)

    # -- 7. stage-1 path
    print(f"[{time.perf_counter() - t0:.0f} s] stage-1 path")
    (vv_launches, vv_per_call, ms_vv, ms_vv_plain, ms_vv_sdpa, vv_bound,
     vv_bound_by) = phase_stage1(vit, cfg, card)

    # -- 8. fused-block path
    print(f"[{time.perf_counter() - t0:.0f} s] fused-block path")
    err_fused = {d: check_fused_kernels(d) for d in DTYPES}
    for d in DTYPES:
        check_fused_nan_row(d)
    err_b4 = {d: check_attention_kernel(d) for d in DTYPES}
    fused_launches, fp32_calls = phase_fused_predict(
        vit, adapter, cfg, acfg, anchors, M, card)
    expect(fused_launches["attention_packed"] == fwd_launches,
           "the fused predict's attention launches differ from the "
           "predict's")
    phase_encode_image(vit, cfg)
    # -- 8f-8i. the fused block under fp32_high (the 3-pass mode, B8)
    print(f"[{time.perf_counter() - t0:.0f} s] fused block fp32_high")
    high_fused = check_fused_kernels_3pass()
    high_predict = phase_fused_predict_3pass(vit, adapter, cfg, acfg,
                                             anchors, M, card)
    fused_times = time_fused(cfg, card)
    fused_high_times = time_fused_3pass(cfg, card)
    bench_block(card, "fp32_high")
    # -- 8j-8k. the fused block under fp32 (the 6-pass mode)
    print(f"[{time.perf_counter() - t0:.0f} s] fused block fp32 (6-pass)")
    fp32_block_times = time_fused_fp32(cfg, card)
    bench_block(card, "fp32")
    # -- 11f. the fp32 kernels' times, then every traced check while the
    # profiler still returns whole traces
    fp32_times = time_kernels_fp32(card)
    queue_hd_bwd_plans()
    check_device_ops()

    # -- 9, 10. the evaluation and training CLIs from one saved checkpoint
    ckpt_dir = tempfile.mkdtemp(prefix="aaclip_smoke_ckpt_")
    try:
        ckpt_path = write_seeded_checkpoint(ckpt_dir, card)
        print(f"[{time.perf_counter() - t0:.0f} s] evaluation CLI")
        phase_eval_cli(card, ckpt_path)
        print(f"[{time.perf_counter() - t0:.0f} s] training CLI")
        train_cli = phase_train_cli(card, ckpt_path)
        # -- 11. fp32_high
        print(f"[{time.perf_counter() - t0:.0f} s] fp32_high")
        high = phase_fp32_high(vit, adapter, cfg, acfg, anchors, M, card,
                               ckpt_path)
        # -- 12. serving and the memory bank
        print(f"[{time.perf_counter() - t0:.0f} s] serving and the memory "
              f"bank")
        serving_calls = phase_serving(vit, adapter, cfg, acfg, anchors, M,
                                      card, gen, ckpt_path)
        # -- 13. int8 and the exported artifact
        print(f"[{time.perf_counter() - t0:.0f} s] int8 and the artifact")
        int8_artifact = os.path.join(ckpt_dir, "artifact_int8")
        serving_calls.update(phase_int8_artifact(
            vit, adapter, cfg, acfg, anchors, M, card, gen, ckpt_path,
            SERVE_READINGS, keep_int8=int8_artifact))
        # -- 14. data, tensor and sequence parallelism
        print(f"[{time.perf_counter() - t0:.0f} s] parallel")
        par_calls = phase_parallel(vit, adapter, cfg, acfg, anchors, M,
                                   card, gen, ckpt_path)
        # -- 15. the pipeline, the visualization and the facades
        print(f"[{time.perf_counter() - t0:.0f} s] pipeline")
        for name, paths in phase_pipeline(vit, adapter, cfg, acfg, anchors,
                                          M, card, gen, ckpt_path).items():
            par_calls[name].update(paths)
        # -- 16. the practitioner tools and examples
        print(f"[{time.perf_counter() - t0:.0f} s] tools and examples")
        for name, paths in phase_tools(card, ckpt_path,
                                       int8_artifact).items():
            par_calls[name].update(paths)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    # -- 17. the forward at head dims 80 and 128, ViT-H-14
    print(f"[{time.perf_counter() - t0:.0f} s] head dims 80 and 128")
    head_dims = phase_head_dims(card)
    # -- 18. the forward at head dims 88 and 104, ViT-g-14 and ViT-bigG-14
    print(f"[{time.perf_counter() - t0:.0f} s] head dims 88 and 104")
    wide = phase_wide_head_dims(card)

    print(f"[{time.perf_counter() - t0:.0f} s] done: the whole script took "
          f"{time.perf_counter() - t_start:.0f} s")
    # (name, source, replaces, launches, max |d|)
    fused_rows = [
        ("attention_kernel", "attention_packed.cu",
         "aaclip_tpu/ops/flash_attention.py:94",
         fused_launches["attention_kernel"], err_b4["bf16"]),
        ("ln_linear", "fused_block.cu", "aaclip_tpu/ops/fused_block.py:124",
         fused_launches["ln_linear"], err_fused["bf16"]["ln_linear"]),
        ("linear_residual", "fused_block.cu",
         "aaclip_tpu/ops/fused_block.py:179",
         fused_launches["linear_residual"],
         err_fused["bf16"]["linear_residual"]),
        ("mlp_fused", "fused_block.cu", "aaclip_tpu/ops/fused_block.py:244",
         fused_launches["mlp_fused"], err_fused["bf16"]["mlp_fused"]),
    ]
    # B5-B7's 6-pass mode: launches and calls on the fused fp32 predict,
    # times at batch 8 (ln_linear's to 3072 columns)
    fused_fp32 = fp32_block_times[TRAIN_BATCH]
    hc = high["calls"]
    # B5-B7's 3-pass mode: launches on the fused fp32_high predict (staged,
    # the policy's default), calls on both fused fp32_high predicts
    high_fused_rows = [
        (name, replaces, {k: v[name] for k, v in
                          high_predict["calls"].items()})
        for name, replaces in (
            ("ln_linear", "aaclip_tpu/ops/fused_block.py:124"),
            ("linear_residual", "aaclip_tpu/ops/fused_block.py:179"),
            ("mlp_fused", "aaclip_tpu/ops/fused_block.py:244"))]
    # (name, source, replaces, launches on the main path, calls per path,
    # max |d|): B1's on the staged predict, B2's on the stage-2 step, B3's
    # on the spatial features, B4 on no path (at head dim 64 each on the
    # 3-pass TMA + wgmma kernels, after its split2 launches)
    high_rows = [
        ("attention_packed", "attention_packed.cu",
         "aaclip_tpu/ops/flash_attention.py:190",
         hc["attention_packed"]["fp32_high predict, bf16_until 6"],
         hc["attention_packed"], err_high["fwd"]),
        ("attention_packed_bwd", "attention_packed_bwd.cu",
         "aaclip_tpu/ops/flash_attention.py:302",
         hc["attention_packed_bwd"]["fp32_high stage-2 step (remat)"],
         hc["attention_packed_bwd"], err_high["bwd"]),
        ("attention_packed_vv", "attention_packed.cu",
         "aaclip_tpu/ops/flash_attention.py:190",
         hc["attention_packed_vv"]["fp32_high stage-1 spatial features"],
         hc["attention_packed_vv"], err_high["vv"]),
        ("attention_kernel", "attention_packed.cu",
         "aaclip_tpu/ops/flash_attention.py:94",
         hc["attention_kernel"]["fp32_high training CLI"],
         hc["attention_kernel"], err_high["b4"]),
    ]
    # (name, source, replaces, launches on the main path, calls per path,
    # max |d|, times): the fp32 ViT-L paths' 6-pass launches as
    # expect_6pass recorded them (standard, V-V, backward; split3), B1's on
    # phase 4's fp32 predict, B2's on phase 5b's step, B3's on 5b's
    # features, B4 on no path, split3's beside B1's on the predict
    six = fp32_times["6pass"]

    def six_calls(i):
        return {k: (v[1] if i is None else v[0][i])
                for k, v in SIX_PASS_CALLS.items()
                if (v[1] if i is None else v[0][i])}

    six_rows = [
        ("attention_packed", "attention_packed.cu",
         "aaclip_tpu/ops/flash_attention.py:190",
         SIX_PASS_CALLS["predict fp32 B=2"][0][0], six_calls(0),
         err_fwd["fp32"], six["attention_packed"]),
        ("attention_packed_bwd", "attention_packed_bwd.cu",
         "aaclip_tpu/ops/flash_attention.py:302",
         SIX_PASS_CALLS["train fp32 B=2 remat"][0][2], six_calls(2),
         err_bwd["fp32"], six["attention_packed_bwd"]),
        ("attention_packed_vv", "attention_packed.cu",
         "aaclip_tpu/ops/flash_attention.py:190",
         SIX_PASS_CALLS["stage-1 spatial features fp32 B=2"][0][1],
         six_calls(1), err_vv["fp32"], six["attention_packed_vv"]),
        ("attention_kernel", "attention_packed.cu",
         "aaclip_tpu/ops/flash_attention.py:94", 0, {}, err_b4["fp32"],
         six["attention_kernel"]),
        ("split3", "attention_packed.cu",
         "aaclip_tpu/ops/flash_attention.py:49",
         SIX_PASS_CALLS["predict fp32 B=2"][1], six_calls(None), 0.0,
         fp32_times["split3"]),
        # the 3-pass route's split: launches on the staged fp32_high
        # predict, calls on every fp32_high path
        ("split2", "attention_packed.cu",
         "aaclip_tpu/ops/flash_attention.py:56",
         hc["split2"]["fp32_high predict, bf16_until 6"], hc["split2"], 0.0,
         fp32_times["split2"]),
    ]
    hd_rows = head_dim_rows(head_dims, wide)
    print(json.dumps({"kernels": [{
        "name": "attention_packed",
        "route": "cuda",
        "source": "aaclip_tpu_torch/kernels/csrc/attention_packed.cu",
        "replaces": "aaclip_tpu/ops/flash_attention.py:190",
        "launches": fwd_launches,
        "calls": {"predict": fwd_launches,
                  **{f"stage-2 step, remat {k}": v[0] for k, v in
                     train_steps.items()},
                  **{f"training CLI {k}": v[0] for k, v in
                     train_cli.items()},
                  **serving_calls, **par_calls["attention_packed"]},
        "kernels_per_call": fwd_per_call,
        "max_abs_err": err_fwd["bf16"],
        "ms": ms_fwd,
        "plain_ms": ms_fwd_plain,
        "bound_ms": fwd_bound,
        "bound_by": fwd_bound_by,
        "library_ms": ms_sdpa,
    }, {
        "name": "attention_packed_bwd",
        "route": "cuda",
        "source": "aaclip_tpu_torch/kernels/csrc/attention_packed_bwd.cu",
        "replaces": "aaclip_tpu/ops/flash_attention.py:302",
        "launches": train_bwd,
        "calls": {**{f"stage-2 step, remat {k}": v[1] for k, v in
                     train_steps.items()},
                  **{f"training CLI {k}": v[2] for k, v in
                     train_cli.items()},
                  **par_calls["attention_packed_bwd"]},
        "kernels_per_call": bwd_per_call,
        "max_abs_err": err_bwd["bf16"],
        "ms": ms_bwd,
        "plain_ms": ms_bwd_plain,
        "bound_ms": bwd_bound,
        "bound_by": bwd_bound_by,
        "library_ms": ms_sdpa_bwd,
    }, {
        "name": "attention_packed_vv",
        "route": "cuda",
        "source": "aaclip_tpu_torch/kernels/csrc/attention_packed.cu",
        "replaces": "aaclip_tpu/ops/flash_attention.py:190",
        "launches": vv_launches,
        "calls": {"stage-1 spatial features": vv_launches,
                  **{f"training CLI {k}": v[1] for k, v in
                     train_cli.items()},
                  **par_calls["attention_packed_vv"]},
        "kernels_per_call": vv_per_call,
        "max_abs_err": err_vv["bf16"],
        "ms": ms_vv,
        "plain_ms": ms_vv_plain,
        "bound_ms": vv_bound,
        "bound_by": vv_bound_by,
        "library_ms": ms_vv_sdpa,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"aaclip_tpu_torch/kernels/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "kernels_per_call": fused_times[name][5],
        "max_abs_err": err,
        "ms": fused_times[name][0],
        "plain_ms": fused_times[name][1],
        "bound_ms": fused_times[name][3],
        "bound_by": fused_times[name][4],
        "library_ms": fused_times[name][2],
    } for name, source, replaces, launches, err in fused_rows] + [{
        "name": f"{name} (3-pass)",
        "route": "cuda",
        "source": "aaclip_tpu_torch/kernels/csrc/fused_block.cu",
        "replaces": replaces,
        "launches": calls["fused fp32_high predict, bf16_until 6"],
        "calls": calls,
        "kernels_per_call": fused_high_times[name][5],
        "max_abs_err": high_fused["err"][name],
        "fp64_of_max": high_fused["fp64"][name],
        "ms": fused_high_times[name][0],
        "plain_ms": fused_high_times[name][1],
        "bound_ms": fused_high_times[name][3],
        "bound_by": fused_high_times[name][4],
        "library_ms": fused_high_times[name][2],
    } for name, replaces, calls in high_fused_rows] + [{
        "name": f"{name} (6-pass)",
        "route": "cuda",
        "source": "aaclip_tpu_torch/kernels/csrc/fused_block.cu",
        "replaces": replaces,
        "launches": fp32_calls[name],
        "calls": {f"fused fp32 predict B={TRAIN_BATCH}": fp32_calls[name]},
        "kernels_per_call": fused_fp32[name][5],
        "max_abs_err": err_fused["fp32"][name],
        "fp64_of_max": err_fused["fp32"]["fp64"][name],
        "ms": fused_fp32[name][0],
        "plain_ms": fused_fp32[name][1],
        "bound_ms": fused_fp32[name][3],
        "bound_by": fused_fp32[name][4],
        "fma_bound_ms": fused_fp32[name][6],
        "library_ms": fused_fp32[name][2],
    } for name, replaces, _ in high_fused_rows] + [{
        "name": f"{name} (3-pass)",
        "route": "cuda",
        "source": f"aaclip_tpu_torch/kernels/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "calls": calls,
        "kernels_per_call": fp32_times["3pass"][name][5],
        "max_abs_err": err,
        "ms": fp32_times["3pass"][name][0],
        "plain_ms": fp32_times["3pass"][name][1],
        "bound_ms": fp32_times["3pass"][name][3],
        "bound_by": fp32_times["3pass"][name][4],
        "library_ms": fp32_times["3pass"][name][2],
    } for name, source, replaces, launches, calls, err in high_rows] + [{
        "name": f"{name} (6-pass)" if not name.startswith("split") else name,
        "route": "cuda",
        "source": f"aaclip_tpu_torch/kernels/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "calls": calls,
        "kernels_per_call": times[5],
        "max_abs_err": err,
        "ms": times[0],
        "plain_ms": times[1],
        "bound_ms": times[3],
        "bound_by": times[4],
        "library_ms": times[2],
    } for name, source, replaces, launches, calls, err, times in six_rows]
        + hd_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-clis"]:
        sys.exit(cli_ranks_main(sys.argv[2]))
    if sys.argv[1:2] == ["--export-artifact"]:
        sys.exit(export_artifact_main(sys.argv[2]))
    sys.exit(main())
