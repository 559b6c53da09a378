#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (numbered as they were
added; phases 3, 3b and 7 time nothing and run in this process while the
processes of phases 20 and 21 run, ``phase_processes``):

1. device  — the card's name and power limit; no CUDA device is a failure.
2. build   — compiles every CUDA kernel of the serving and training paths
   from ``csrc/``, one nvcc per source, all started together.
3. kernels — the forward kernel against its plain PyTorch version on the
   card, at the serving shapes and edge cases, in float32 (the split-TF32
   tensor-core kernel up to head dim 128) and bfloat16.
3b. kernels-bwd — the backward kernel against its plain version and a
   float64 version with the same rounding points, at the same cases plus
   the training shapes, Lq != Lk and head dims 80 and 128, in float32 and
   bfloat16 (both dtypes run tensor-core kernels up to head dim 128, fp32
   through split-TF32 products); the forward op's registered autograd
   against autograd through the plain forward.
4. serve   — ViT-B-16 at full width on a seeded random init, through
   ``create_engine`` and the HTTP server: image, text and similarity
   requests, ``/health`` and concurrent HTTP requests that the batcher
   coalesces. Checks unit-norm features, the kernel's launch count (12 per
   tower call: one per attention layer), agreement with the same weights
   run through the plain attention path (cosine >= 0.9999 in fp32), and by
   the profiler that one served fp32 image call ran the split-TF32 kernel
   and no scalar fp32 kernel.
4b. export — the deployable artifact: the serve phase's engine exported at
   buckets 1 and 8 (``ClipInferenceEngine.export``: one ``torch.export``
   program per encoder and bucket, the weights baked in, the kernels as
   ``torch.library`` custom ops in the graph) and each program reloaded with
   ``load_exported``: features within 1e-5 and at cosine >= 0.99999 of the
   engine's, 12 fused-forward launches a tower call, the profiler's check
   that the fp32 image program runs the split-TF32 kernel alone; seconds to
   export and to load each program, its bytes, and its call time beside the
   engine's (host clock and CUDA events). Phases 13 and 13b export two more
   engines at bucket 1 the same way: the 384-px tower under ``"flash"`` (12
   flash launches through the artifact) and the int8 engine (its program
   holds the int8 values; cosine >= 0.999 to fp32); phase 21 (h) a split
   engine.
5. times   — each kernel, its plain version and the library yardstick
   (``scaled_dot_product_attention``, which the port never calls) timed with
   CUDA events at the serving shapes, beside the kernel's bound (fp32: on
   TF32 tensor cores, three products a FLOP, with the CUDA-core bound beside
   it) and the time of the scalar kernel each tensor-core route replaced
   (where recorded), with the speedup; each tower's
   time per call with the kernel and with the plain attention (CUDA events
   behind a queued sleep: device time as long as the host launches faster
   than the device runs; ``scripts/profile_torch_serving.py`` gives device
   busy time and idle share); request latency per bucket.
6. train-step / train-cli — three ViT-B-16 DINO-soft steps through both
   fused kernels (24 + 24 launches per step), one step's loss and gradients
   against plain attention (bf16: all tensors together, beside the same
   comparison between the kernels' plain versions and plain attention), and
   the training CLI, whose checkpoint serves; the fp32 step (what
   ``--precision amp`` runs): its launches, the profiler's check that it ran
   the split-TF32 kernels and no scalar fp32 kernel, and its time and peak
   memory through the kernels and through plain attention; the backward
   kernel's times (each beside the scalar kernels' it replaced, with the
   speedup).
7. kernels-flash — the flash forward kernel against its plain version and a
   float64 version with the same rounding points, from 512 to 4097 tokens,
   causal, Lq != Lk both ways, head_dim 40 to 256, in float32 (the
   split-TF32 tensor-core kernel up to head dim 128) and bfloat16; its
   op's registered autograd against autograd through the plain version.
8. train-long — ViT-L-14-336 (577 vision tokens) at full width, its vision
   depth cut to ``LONG_LAYERS`` of 24 blocks, DINO-soft, bf16,
   ``attn_impl="flash"``: three steps without and three with grad
   checkpointing (one and two flash launches a block a step, no fused
   launch), one step's loss and gradients against plain attention, step
   times and peak memory; then in fp32 compute with grad checkpointing
   (what ``--precision amp --attn-impl flash --grad-checkpointing`` runs):
   one step's loss and gradients against plain attention, three steps'
   launches (two flash a block a step, no fused), the profiler's check that a step
   ran the split-TF32 flash kernel and no scalar fp32 kernel, and the
   step's time and peak memory through flash, through ``"auto"`` (the fused
   fp32 kernels at 577 tokens) and through plain attention.
9. train-cli-long — the training CLI on ViT-L-14-336 with
   ``--grad-checkpointing`` (its checkpoint loads strictly) and on ViT-B-16
   with ``--force-image-size 384`` (12 flash launches per forward); then the
   flash kernel's times beside its plain version, SDPA, its bound and the
   scalar kernel's time.

9b. preprocess — ``--device-preprocess``, right after train-eval-cli on
    its mini-Flickr set: (a) ``ops/preprocess.py:preprocess_train_batch`` on
    the card at ``[96, 256, 256, 3]`` uint8 -> 224 against the CPU float64
    evaluation of the same crop boxes (max abs <= 1e-4), its CUDA-event
    time; (b) train-eval-cli's thesis flags with ``--device-preprocess``
    through ``train.main`` for one epoch: finite losses, the launches
    ``_thesis_launches`` expects, train samples/s with loading beside
    train-eval-cli's host-path run, and the uint8 loader's rate alone
    beside the PIL loader's; (c) which JPEG decoder ran and, where the
    native one built (libjpeg's headers are there), the raw loader over
    mini-Flickr regenerated as 500 x 333 JPEGs (Flickr30k's size), the
    native DCT-scaled decode against PIL, in images/s; the native BPE core
    against the Python BPE on the val captions (tokens/s, ids equal).
    Phase 2 also builds the host cores (``native/``, g++): the BPE core
    must build.
The DINOv2 teacher's phases run after train-eval-cli, on its mini-Flickr
set (the forward kernel is checked at the teacher's shapes ``[64,6,257,64]``
and ``[32,16,257,64]`` in phase 3, and timed in phase 5):

10. teacher — a seeded dinov2-small directory in the HF layout at the
    published config (hidden 384, 12 layers, 6 heads, patch 14, image_size
    518, LayerScale 1.0, LN eps 1e-6), loaded with ``load_dinov2_model``; a
    batch of 64 at 224 px in fp32 and bf16 through ``"auto"`` (12 fused
    forward launches a call, no backward) against ``"xla"`` (CLS cosine >=
    0.9999 fp32, >= 0.999 bf16), the time per batch; one fp32 forward each
    of dinov2-large and dinov2-giant (SwiGLU) at batch 32 against ``"xla"``.
11. extract — the port's feature extractor on both mini-Flickr CSVs with
    the seeded teacher: rows, the map, ``DinoFeatureStore`` and
    ``CsvDataset`` accept them, 12 launches a batch.
12. train-live-cli — the CLI at ViT-B-16, ``--precision amp``, batch 32, one
    epoch with evaluation and ``--run_clip_blind``, the teacher from
    ``--dino_model_name`` and no ``--dino_fts_path``: a non-zero
    ``soft_loss``, both CLIP-blind files, launches (36 forward + 24 backward
    a train step, 24 an eval batch, 24 a CLIP-blind batch), the extracted
    rows against the live check's teacher rows of the same val images
    (cosine >= 0.9999), wall time, samples/s and the seconds in the teacher
    (CUDA events around ``extract``); then the live fp32 step alone beside
    the step on cached features and the teacher alone at batch 32.

The pretrained-checkpoint and thesis-evaluation phases run after them on the
same set, at ViT-B-16's full width (the fused forward is checked and timed
at their new shapes, the zero-shot text batch ``[800,8,77,64]`` causal and
the offline extractor's bf16 ``[256,12,197,64]``, in phases 3 and 5):

13. pretrained — the port's seeded ViT-B-16 weights written twice: as the
    open_clip-layout file of the ``openai`` tag's hub repo in the hub-cache
    layout, and as an fp16 OpenAI TorchScript archive. ``create_model(...,
    pretrained="openai")``, ``load_openai_model(archive)`` and
    ``create_model(..., pretrained=archive)`` (what ``--pretrained
    <archive>`` runs) hold exactly the written values (fp16-rounded from the
    archive); the archive's features through the kernel against plain
    attention (cosine >= 0.9999, fp32, 12 launches a tower call); the 224-px
    checkpoint at ``force_image_size=384`` resizes its table and runs
    ``[B,12,577,64]`` through the fused kernel and through flash.
13b. int8 — weight-only int8 serving from that tag: ``create_engine(...,
    pretrained="openai", quantize="int8")`` behind the HTTP server beside
    the fp32 engine on the tag: resident bytes of the int8 tensors and of
    each whole model, 12 launches a tower call, the int8 features through
    the kernel against plain attention on the same int8 weights (cosine >=
    0.9999) and against fp32 (>= 0.999, the JAX test's), each tower's time
    and the request latency at buckets 1 and 8 beside fp32.
13c. zoo — the rest of the loss zoo and the ViT variants at full width:
    (a) a seeded ViT-L-14 (full width and depth) written into the hub repo
    of its ``openai`` tag; ``train.main`` with ``--distill-model ViT-L-14
    --distill-pretrained openai`` for one epoch of the first 96 mini-Flickr
    train rows (launches, losses, a final checkpoint of the student's keys
    alone), whose teacher, loaded by tag, holds exactly the written values
    and serves the checks that follow: its features through the kernels
    against plain attention (cosine >= 0.9999 fp32; 24 + 12 launches); the
    ViT-B-16 student's distillation step at batch 32 under it against
    plain attention in bf16 and fp32 (``STEP_TOL``; 36 teacher + 24 student
    forward and 24 backward launches a step), its host clock, CUDA events,
    the teacher's share and peak memory; (b) the CyCLIP step at batch
    64 in bf16 and fp32 against plain attention (24 + 24); (c) a seeded
    ViT-L-14-CLIPA written with the committed BERT test vocabulary into
    the hub repos of its ``datacomp1b`` tag and of bert-base-uncased, loaded
    by tag exactly, its captions tokenized by the WordPiece reader to the
    ids the CPU test pins, served fp32 at buckets 1 and 8 (24 launches an
    image call, 12 a text call; cosine >= 0.9999 to plain attention; one
    HTTP text request) and its tower time per call; (d) one full-width
    forward each of ``vit_medium_patch16_gap_256`` (12 launches) and
    ``vit_relpos_medium_patch16_cls_224`` (none: its bias is an external
    mask, as in JAX) against plain attention. The new forward shapes
    (``ZOO_CASES``, head dim 104 among them) are checked and timed in
    phases 3 and 5, head dim 104's backward in 3b and 6. (e) EVA02-L-14 at
    full width and depth, seeded: fp32 features through the kernels against
    plain attention (cosine >= 0.9999; 24 launches an image call, 12 a text
    call), the tower time at buckets 1 and 8, the bf16 CLIP step at 32
    (``STEP_TOL``, all tensors together) and the fp32 step at 8 (every
    tensor) against plain attention, 36 + 36 launches a step; EVA02-E-14 at
    full width, 2 of its 64 blocks: one forward at head dim 112 in fp32 and
    bf16 against plain attention. Their shapes (``EVA02_CASES``) are checked
    and timed in phases 3, 3b, 5 and 6.
13d. convnets — the convolution towers, in the main process: (a) RN50
    (102M parameters) from a seeded fp16 OpenAI TorchScript archive (random
    running statistics, ``num_batches_tracked`` included) in the hub cache
    of its ``openai`` tag, loaded by tag exactly; fp32 features through the
    kernels against plain attention (cosine >= 0.9999; 1 fused launch an
    image call: the pool's mean-token query over 50 keys, 12 a text call),
    serving leaves the running statistics bit for bit; the tower time at
    buckets 1 and 8 (CUDA events and host clock); (b) its DINO-soft step in
    bf16 at 64 and fp32 at 8 against plain attention (``STEP_TOL``; 13 + 13
    launches), the BatchNorm statistics after either route equal within
    1e-6, and bit for bit unchanged with ``freeze_bn_stats``; the bf16
    forward and backward's time and peak memory; (c) RN50x64 at 448 px, full
    width, ``RN_BIG_BLOCKS`` blocks a stage (2 of its 3, 15, 36 and 10: the
    time limit), one fp32 forward at 8 against plain attention (1 launch,
    ``[8,64,1,64]`` over 197 keys); (d) convnext_base_w from the seeded hub
    cache of its ``laion2b_s13b_b82k`` tag, exactly; fp32 features (0
    launches an image call: the tower has no attention; 12 a text call), the
    tower time, the bf16 DINO-soft step at 64 under ``--grad-checkpointing``
    against plain attention (24 + 12); (e) convnext_large_d's mlp head
    loaded exactly from open_clip's ``visual.head.mlp.*`` keys, one fp32
    forward (16 text launches). The new shapes (``CONVNET_CASES``) are
    checked and timed in phases 3, 3b, 5 and 6.
13e. hybrids — the hybrid and windowed towers, in the main process: (a)
    ViTamin-L (456,994,113 parameters) seeded and written in open_clip's
    timm layout (the text under ``text.``) as ``pytorch_model.bin`` in the
    hub cache of its ``datacomp1b`` tag, loaded by tag exactly; fp32
    features through the kernels against plain attention (cosine >= 0.9999;
    31 fused launches an image call, 12 a text call), the tower time at
    buckets 1 and 8; (b) its bf16 DINO-soft step at 32 under
    ``--grad-checkpointing`` against plain attention (``STEP_TOL``; 86 + 43
    launches: the ViT stage and the text recomputed), its time and peak
    memory; (c) ViTamin-L-384 at full width (576 vision tokens, ViTamin-L's
    weights and a seeded position table), one fp32 forward at 8 under
    ``--attn-impl flash`` (31 flash launches, no fused forward) and under
    ``"auto"`` (31 fused forwards at 576 tokens), each against plain
    attention; (d) swin_base_patch4_window7_224 seeded: fp32 features (0
    launches an image call: every window attention carries a mask and runs
    plain, as in JAX; 12 a text call), its bf16 DINO-soft step at 32 against
    the fp32 step through plain attention (the bf16 step row's tolerances;
    every ``relative_position_bias_table`` gradient among the tensors; 12 +
    12). The new shapes (``HYBRID_CASES``, ``HYBRID_BWD_CASES``,
    ``HYBRID_FLASH_CASES``) are checked in phases 3, 3b and 7 and timed in
    5, 6 and 9.
13f. mobileclip — MobileCLIP's towers, in the main process: (a)
    MobileCLIP-S2 (99,243,329 parameters, 124,480 running statistics)
    seeded, its running statistics drawn away from 0/1, and written in
    open_clip's layout as ``open_clip_pytorch_model.bin`` in the hub cache
    of its ``datacompdr`` tag, loaded by tag exactly with the tag's
    preprocessing (mean 0, std 1, ``shortest``, ``bilinear``); fp32
    features through the kernels against plain attention (0 launches an
    image call: FastViT's attention stage is plain, as in JAX; 12 a text
    call, non-causal), the tower time at buckets 1 and 8; (d) its deploy
    form (``models/fastvit.py:fuse_fastvit``: every branch and BatchNorm
    folded) against the training form (fp32 image features, cosine >=
    0.9999) and both forms' image time at buckets 1 and 8; (b) its bf16
    DINO-soft step at 64, its BatchNorms training, against plain attention
    (``STEP_TOL``; 12 + 12 launches; the running statistics of the two
    routes equal), its time and peak memory; (c) MobileCLIP-B (149,777,921
    parameters) seeded and written in Apple's layout
    (``scripts/mobileclip_apple_layout.py``), loaded exactly through
    ``load_checkpoint``; fp32 features (12 + 12 launches), the tower time,
    its bf16 step at 64 (24 + 24). The new shapes (``MOBILECLIP_CASES``,
    ``MOBILECLIP_BWD_CASES``) are checked in phases 3 and 3b and timed in 5
    and 6.
14. zero-shot — Config 1 through ``train.main.main``: ``--pretrained
    openai``, mini-Flickr's val CSV and ``--imagenet-val`` on a procedural
    ImageNet-V2-style folder (1000 digit-named classes, one image each), no
    train data: retrieval, top-1/top-5, the classifier's seconds (80,000
    captions, 100 text calls of ``[800,77]``) and the launches; the
    classifier of the first 10 classes through plain attention (weight
    cosine >= 0.9999, fp32).
15. finetune — Config 2: train-eval-cli's thesis flags with ``--pretrained
    openai`` for one epoch; its pre-train evaluation equals Config 1's
    retrieval (same weights); samples/s, the evaluations, the launches, and
    the fp32 step alone from the pretrained weights.
16. offline — ``eval.run_all_evals`` on both mini-Flickr CSVs (the ``label``
    column) from that run's checkpoint (bf16 extraction, 12 launches a batch
    of 256 rows), then ``eval.clip_blinds_cli`` on the val CSV with
    mini-Flickr's DINO features and map: kNN, probe, geometry and CLIP-blind
    results and each stage's seconds; the extracted val features against
    plain attention's (cosine >= 0.999, bf16).

The published Config 2 and the accumulated step run last, on the same set:

17. config2 — ``train.main.main`` with Config 2's flags exactly as
    ``docs/REPRODUCE.md`` writes them (ViT-B-16 from the ``openai`` tag,
    ``--precision bf16``, batch 96, ``--teacher_temp 0.15 --use_projection
    --projection_type mlp --report-to tensorboard --run_clip_blind``), cut
    to mini-Flickr, 2 epochs and whole-image train crops: launches (48 a
    train step, 24 an eval batch, 12 a CLIP-blind batch), the TensorBoard
    events or their one warning, every artifact, ``final_torch_state.pt``
    served by the engine; the same flags with ``--save-on-preemption
    --async-checkpoint`` in a subprocess, sent SIGTERM once its
    ``out.log`` shows step 3 of epoch 1 (beside phases 20 and 21), then
    ``--resume latest`` (after them): the
    preemption save's position, both runs' launches, their losses against
    the uninterrupted run's (bf16, ``STEP_TOL``); the blocking seconds of a
    synchronous and an asynchronous save of the ViT-B-16 state.
18. accum — ``--accum-freq 2`` of microbatches of 48 against one batch of
    96 through the kernels, in bf16 and fp32: loss and gradients within
    ``STEP_TOL`` (the logit scale's gradient halved), launches 48a forward
    and 24a backward (12a more forward with the live dinov2-small teacher),
    host clock and peak memory against the single step.

Config 5's single-chip recipe runs last in the work directory (the
kernels are checked at its shapes, head dim 88 among them, in phases 3 and
3b, and timed in phases 5 and 6):

19. giant — ViT-g-14 at full width, its vision depth cut to
    ``GIANT_LAYERS`` of 40 blocks and its text to ``GIANT_TEXT_LAYERS`` of
    24 (vision ``[16,16,257,88]``, text
    ``[16,16,77,64]`` causal), seeded, bf16 over fp32 parameters, batch 16,
    DINO-soft: one fused-forward launch a block a forward, two forward and
    one backward a block a checkpointed step; one step
    through the kernels against plain attention (``STEP_TOL`` bf16); under
    adafactor with a bf16 first moment each remat policy (``full``,
    ``dots_saveable``, ``dots_with_no_batch_dims_saveable``,
    ``offload_dots_with_no_batch_dims``) against ``full``, with its host
    clock, CUDA-event time, peak memory and launches, and the same without
    checkpointing; the peak memory of AdamW (fp32 and bf16 first moment)
    and adafactor (bf16) under ``dots_with_no_batch_dims_saveable``; then
    ``train.main`` with Config 5's flags, Config 2's DINO flags and
    ``--force-patch-dropout 0.5`` on mini-Flickr cut to 16 + 8 images, one
    epoch and no per-epoch checkpoint: launches against the loader's
    batches, and the vision attention at 129 tokens in training and 257 in
    evaluation.

Multi-GPU training runs after it, in subprocesses of this script
(``--dist-child train|probe|step``), on its own mini-Flickr cut (20 + 8
images, whole-image crops). Every process of phases 20 and 21 and phase
17's preempted run starts at once (``phase_processes``; each phase's
checks and lines then come in order, and their host clocks, walls and
latencies are taken beside the other processes); phase 17's ``--resume
latest`` runs in this process after them:

20. dist — ViT-B-16 at full width, its vision tower cut to
    ``DIST_VISION_LAYERS`` of 12 blocks: (a) the thesis flags through
    ``train.main`` (``--precision amp``, batch 32, three steps) as one
    process and as rank 0 of a NCCL group of one under DDP,
    ``--shard-opt-state`` and ``--fsdp``: per-step losses equal the one
    process's (1e-5), ``DIST_VISION_LAYERS`` + 12 fused launches forward
    and backward a step, host clock and peak memory beside the one
    process's; (b) two ranks on the card over gloo: each collective the
    port uses on CUDA tensors (and DDP, ZeRO-1's gather, FSDP) probed in
    its own pair of processes (beside phase 2's build, waited for before
    phase 4: no timed phase runs beside them), the result written to
    ``gloo_cuda_probe.json`` in the work directory and printed, then from
    that file the ViT-B-16
    fp32 step at 2 x 32 for each case it carries (clip and the SigLIP
    rings under DDP, clip under ZeRO-1 and FSDP) against the one-process
    step at 64 on the same rows: the rank-mean loss at 1e-5, every
    gradient after the rank mean at cosine >= 0.9999 (TF32 off),
    ``DIST_VISION_LAYERS`` + 12 forward and backward launches a step on
    each rank, the host clock of a second step.

Config 5's multi-chip recipe runs after it, in ``--dist-child tp`` and
``train`` subprocesses (the kernels are checked at each rank's local heads,
``TP_CASES``, in phases 3 and 3b, and timed in phases 5 and 6):

21. tp — two ranks on the card over gloo at ``--mesh-model-axis 2``: (a)
    the ViT-B-16 fp32 DINO-soft step split over the model group,
    replicated and under ZeRO-1, against the one-process step on the same
    rows and weights (loss 1e-5 relative, every whole gradient at cosine
    >= 0.9999), 24 + 24 launches a rank a step at ``[32,6,197,64]`` and
    ``[32,4,77,64]``, and one gloo all-reduce of an EVA01-g-14 activation;
    (c) dinov2-giant (``TP_TEACHER_LAYERS`` of its 40 blocks) split over the
    two ranks against the whole teacher (CLS cosine >= 0.9999 fp32; bf16
    >= 0.999 or, where two bf16 paths of the whole teacher differ by more,
    no further than its kernel is from plain attention), one fused-forward
    launch a block a rank a call; (b)
    EVA01-g-14 at full width, its vision tower's depth cut to
    ``TP_EVA_LAYERS`` of 40 blocks, with Config 5's flags through
    ``train.main``, bf16, batch 16, one process and two ranks: per-step
    losses at 1e-2 relative, each rank's peak memory beside the one
    process's, 2 x (``TP_EVA_LAYERS`` + 12) + (``TP_EVA_LAYERS`` + 12)
    launches a rank a step. After (a) and (c), in the same pair, the towers
    parts, each split over the two ranks against the whole model in the
    process on the same rows and weights (fp32, the CLIP loss, batch
    ``TP_TOWER_BATCH``: loss 1e-5 relative, every whole gradient at cosine
    >= 0.9999): towers (e) EVA02-L-14 at full width, ``TP_TOWER_LAYERS`` of
    its 24 vision blocks (sub-LN and SwiGLU norms over the local width, their
    whole gradients compared), 2 + 12 forward and backward launches a rank
    at ``[8,8,257,64]`` / ``[8,6,77,64]``; towers (f) EVA02-E-14's vision
    tower at full width, ``TP_TOWER_LAYERS`` of 64 blocks, one forward at
    ``[8,8,257,112]``, features against the whole tower's (cosine >=
    0.9999); towers (g) vit_relpos_medium_patch16_cls_224 and
    swin_base_patch4_window7_224 at full depth (each bias table whole,
    sliced to the rank's heads, its whole gradient compared; 0 + 12
    launches) and ViTamin-L with ``TP_TOWER_LAYERS`` ViT blocks (2 + 12);
    towers (i) MobileCLIP-B with ``TP_MC_B_LAYERS`` of its 12 ViT blocks
    (2 + 12 launches, ``[8,6,197,64]`` and causal ``[8,4,77,64]``) and
    MobileCLIP-S1 whole (its FastViT tower whole on each rank, 0 + 12 at
    ``[8,4,77,64]`` non-causal), every whole gradient at cosine >= 0.99999.
    In a second pair of processes:
    (d) ViT-B-16 fp32 served at ``(1, 2)`` through the engine's follower
    protocol (rank 0 drives) against the one-process engine (cosine >=
    0.9999), 12 launches a tower call on each rank at ``[8,6,197,64]`` /
    ``[8,4,77,64]``, request latency at buckets 1 and 8 beside one process;
    (e) the serve CLI at ``--mesh-model-axis 2`` from phase 13's ``openai``
    tag, rank 0 answering ``/v1/encode_image`` and ``/v1/similarity``; (f)
    ViT-B-16-SigLIP and coca_ViT-L-14 at full width, every tower cut to
    ``TP_SERVE_LAYERS`` blocks, one fp32 and one bf16 loss and backward split
    over the model group against the whole model (``STEP_TOL``), launches
    on each rank; (g) a CoCa caption at ``(1, 2)`` against one process,
    token for token; (h) ViT-B-16 fp32 split at ``(1, 2)`` exported at
    bucket 1 and reloaded with ``load_exported_sharded`` (programs without
    weights, ``params.npz`` and the manifest): each rank's features against
    the split engine's (1e-5), 12 launches a tower call a rank. The kernels
    are checked and timed at these local heads (``TP_SERVE_CASES``) in
    phases 3, 3b, 5 and 6.

CoCa runs right after the mini-Flickr set is made (the fused kernels are
checked at its decoder's shapes, the cross-attention ``[32,12,75,255,64]``
(75 text queries over 255 image tokens) and the causal ``[32,12,75,64]``,
forward in phase 3 and backward in 3b, and timed in phases 5 and 6):

22. coca — coca_ViT-L-14 at full width (638,450,177 parameters at full
    depth), its vision tower cut to ``COCA_VISION_LAYERS`` of 24 blocks,
    seeded: written in open_clip's layout into the hub cache of the
    ``mscoco_finetuned_laion2b_s13b_b90k`` tag and loaded by tag, exactly;
    an fp32 engine behind the HTTP server captions 1 and 8 mini-Flickr
    images at the defaults (6 beams in 3 groups, 30 tokens) and once with
    custom parameters (a fused-forward launch a vision block a caption
    call: the vision tower; the text tower, the poolers and the cached decode take
    plain attention, as in JAX), encodes images and texts;
    ``decode_logits`` through the kernels against plain attention (cosine
    >= 0.9999), the captions against the plain-attention engine's token for
    token (where they differ: the step and the top-2 logit gap there), the
    caption latency cached and uncached; the CoCa step in bf16 at batch 32
    (a forward and a backward launch a vision and decoder block a step:
    ``COCA_VISION_LAYERS`` + 24; one step against plain
    attention at ``STEP_TOL`` bf16) and in fp32 with TF32 off at batch 8
    (``STEP_TOL`` fp32), host clock and peak memory; ``train.main`` from the
    tag, bf16, batch 32, one epoch on 64 + 32 mini-Flickr rows: the caption
    loss in the loss records, ``val_generative_loss`` in both evaluations,
    the final checkpoint loaded strictly into an engine that captions.

SigLIP runs right after CoCa (the fused kernels are checked at its shapes,
the MAP head's probe ``[b,12,1,196,64]`` (one query over 196 keys), the
non-causal text ``[b,12,64,64]`` and the vision ``[128,12,196,64]``, at b 8
and 128, forward in phase 3 and backward in 3b, and timed at b 128 in
phases 5 and 6):

23. siglip — ViT-B-16-SigLIP at full width and depth (203,155,970
    parameters), seeded: written with the committed c4-en vocabulary into
    the hub repo of the ``webli`` tag, loaded by tag with its HF tokenizer,
    exactly; fp32 serving (13 fused-forward launches a vision call, 12 a
    text call; features against plain attention, cosine >= 0.9999) and the
    HTTP encoders; the step in bf16 at batch 128 with
    ``--grad-checkpointing`` (25 + 24 forward and 25 backward launches a
    step: the MAP head is not recomputed; one step against plain attention
    at ``STEP_TOL`` bf16), its host clock, CUDA-event time and peak memory,
    and in fp32 with TF32 off at batch 8 (``STEP_TOL`` fp32); Config 4's
    flags through ``train.main`` (``--siglip --precision bf16
    --dataset-type webdataset --loss-dist-impl bidir --grad-checkpointing``,
    batch 128, ``--pretrained webli``) on four tar shards written from
    mini-Flickr: three steps' losses, samples/s, wall and launches.

Each phase prints the seconds elapsed since the start. The line before the
last is the JSON list of kernels (each fused kernel with ``"coca"`` and
``"siglip"`` lists of those shapes, ``"tp_serve"`` of the model axis's
serving and family shapes, ``"zoo"`` of phase 13c's, ``"eva02"`` of its
part (e) and ``"convnets"`` of phase 13d's); the last line is ``{"ok": true,
"device": {...}}``.
Imports no JAX.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

# published H100 SXM peaks (NVIDIA data sheet, dense): the tensor-core rates
# (TF32 for fp32, which the kernels form from three split TF32 products to
# keep fp32 accuracy, so one fp32 FLOP takes three), the plain fp32 FMA rate
# outside the tensor cores (printed beside fp32 bounds), HBM3 bandwidth
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PRODUCTS_PER_FLOP = {"float32": 3, "bfloat16": 1}
CUDA_CORE_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# max |kernel - plain| compared in fp32, and |kernel - float64 version|:
# fp32 differs by summation order only; bf16 by one output ulp (7.8e-3
# near 1) where rounding flips
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MIN_COSINE = 0.9999  # engine features vs the plain-attention run, fp32
# Kernel cases: (B, H, L, D, causal). The ViT-B-16 serving shapes (image
# [b,12,197,64], causal text [b,8,77,64]) at buckets 8 and 32, ViT-B-32's
# [8,12,50,64], and edge cases: L = 1, odd L, L = 1024, odd B*H, head_dim
# not a multiple of 32, and the largest head_dim the gate admits.
KERNEL_CASES = [
    (8, 12, 197, 64, False), (8, 8, 77, 64, True), (8, 12, 50, 64, False),
    (32, 12, 197, 64, False), (32, 8, 77, 64, True),
    (1, 1, 1, 64, False), (1, 1, 1, 64, True), (3, 5, 23, 64, True),
    (3, 5, 23, 64, False), (1, 2, 1024, 64, False), (1, 2, 1024, 64, True),
    (2, 3, 65, 40, True), (1, 3, 130, 128, False), (1, 2, 300, 256, True),
    (2, 1, 1024, 256, False),
]
TIMED_CASES = [(1, 12, 197, 64, False), (8, 12, 197, 64, False), (32, 12, 197, 64, False),
               (64, 12, 197, 64, False), (1, 8, 77, 64, True), (8, 8, 77, 64, True),
               (32, 8, 77, 64, True), (64, 8, 77, 64, True)]
MAIN_PATH_CASE = (8, 12, 197, 64, False)  # the image call the served requests make
MODEL, BUCKETS, SEED = "ViT-B-16", (1, 8, 32), 0
DEVICE = "cuda"
CARD = "not read"  # the card's name and power limit, as nvidia-smi gives them
FUSED_TPU = "refining_clip_via_dinov2_representations_tpu/ops/fused_attention.py:60"
FUSED_SRC = "refining_clip_via_dinov2_representations_torch/csrc/fused_attention_fwd.cu"
BWD_TPU = "refining_clip_via_dinov2_representations_tpu/ops/fused_attention.py:69"
BWD_SRC = "refining_clip_via_dinov2_representations_torch/csrc/fused_attention_bwd.cu"
# backward: max |kernel - plain| and |kernel - float64 version| over the
# largest |grad| of the three outputs. fp32: summation order only. bf16: a
# few output ulps (one is 2^-8 of a value; dS, rounded to bf16 before its
# products, flips by one ulp where P or dP differ in their last bits).
BWD_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the training shapes: image [64,12,197,64], causal text [64,8,77,64]
TRAIN_CASES = [(64, 12, 197, 64, False), (64, 8, 77, 64, True)]
# backward times: the training shapes, and head dim 256, where both dtypes
# keep the scalar kernels (off every registry model)
BWD_TIMED = TRAIN_CASES + [(8, 4, 197, 256, False)]
# (extended by ViT-g-14's GIANT_CASES below)
# backward only, (B, H, Lq, Lk, D, causal): Lq != Lk with and without the
# causal mask, and head dims 80 and 128 (the widest the bf16 tensor-core
# route takes; 256 in KERNEL_CASES takes the scalar kernels)
BWD_CASES = [
    (4, 12, 197, 150, 64, False), (4, 8, 77, 120, 64, True), (4, 12, 150, 77, 64, True),
    (8, 12, 197, 197, 80, False), (8, 8, 77, 77, 80, True), (8, 12, 197, 197, 128, False),
    (4, 8, 77, 77, 128, True), (2, 4, 300, 1024, 128, False),
]
# The fused kernels' times on the scalar (CUDA-core) kernels each tensor-core
# route replaced (this script's time phases, CUDA events, as PERF.md records
# them); printed beside each new time with the speedup.
SCALAR_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
SCALAR_FUSED_MS = {
    ("float32", (8, 12, 197, 64, False)): 0.0998, ("float32", (32, 12, 197, 64, False)): 0.4184,
    ("float32", (8, 8, 77, 64, True)): 0.0245, ("float32", (32, 8, 77, 64, True)): 0.0472,
    ("bfloat16", (64, 12, 197, 64, False)): 0.8209, ("bfloat16", (64, 8, 77, 64, True)): 0.0725,
}
SCALAR_BWD_MS = {("bfloat16", (64, 12, 197, 64, False)): 2.7512,
                 ("bfloat16", (64, 8, 77, 64, True)): 0.2600,
                 ("float32", (64, 12, 197, 64, False)): 2.7458,
                 ("float32", (64, 8, 77, 64, True)): 0.2661}
# The CUDA kernels of the fp32 route (tensor cores, split TF32) and the
# scalar fp32 kernels they replace at head dim <= 128, as torch.profiler
# names them.
TF32_KERNELS = {"fwd": "fused_attention_fwd_tf32_kernel",
                "dq": "fused_attention_bwd_dq_tf32_kernel",
                "dkdv": "fused_attention_bwd_dkdv_tf32_kernel",
                "flash": "flash_attention_fwd_tf32_kernel"}
SCALAR_F32_KERNELS = {"fwd": "fused_attention_fwd_kernel<float",
                      "dq": "fused_attention_bwd_dq_kernel<float",
                      "dkdv": "fused_attention_bwd_dkdv_kernel<float",
                      "flash": "flash_attention_fwd_kernel<float"}
# the flash kernel's scalar times, each taken before its tensor-core route
# existed (fp32: one turn of scripts/ab_fp32_attention.py on that tree)
SCALAR_FLASH_MS = {(32, 16, 577, 577, 64, False, "bfloat16"): 2.8691,
                   (32, 16, 577, 577, 64, False, "float32"): 2.9048,
                   (32, 12, 577, 577, 64, False, "bfloat16"): 2.0935,
                   (32, 12, 577, 577, 64, False, "float32"): 2.1526}
TRAIN_BATCH, CLI_BATCH, CLI_SAMPLES, DINO_DIM = 64, 32, 96, 384
# train-eval-cli: mini-Flickr at full resolution, 800 train and 200 val
# caption rows; the thesis model at the CLI's batch
EVAL_MODEL, EVAL_BATCH, EVAL_SIZE_PX = "ViT-B-16", 32, 224
EVAL_TRAIN_IMAGES, EVAL_VAL_IMAGES = 160, 40
FLASH_TPU = "refining_clip_via_dinov2_representations_tpu/ops/flash_attention.py:44"
FLASH_SRC = "refining_clip_via_dinov2_representations_torch/csrc/flash_attention_fwd.cu"
# Flash kernel cases: (B, H, Lq, Lk, D, causal). The ViT-L-14-336 and
# ViT-B-16@384 vision shapes, the gate's edge (512) and one past it, 1370
# tokens (a 518-px DINOv2, where "fused" falls to flash), 4097 tokens at
# B*H = 1, Lq < Lk and Lq > Lk, head_dim 80 and 40 (the scale is not exact
# in bf16) and the largest head_dim the gate admits (fp32: the scalar kernel).
FLASH_CASES = [
    (8, 16, 577, 577, 64, False), (8, 16, 577, 577, 64, True),
    (8, 12, 577, 577, 64, False), (8, 12, 577, 577, 64, True),
    (1, 4, 512, 512, 64, False), (1, 4, 513, 513, 64, True), (2, 6, 1370, 1370, 64, False),
    (1, 1, 4097, 4097, 64, False), (1, 1, 4097, 4097, 64, True),
    (2, 4, 600, 1030, 64, False), (2, 4, 600, 1030, 64, True),
    (2, 4, 1030, 600, 64, False), (2, 4, 1030, 600, 64, True),
    (2, 4, 577, 577, 80, False), (2, 4, 577, 577, 40, True), (1, 2, 577, 577, 256, False),
]
FLASH_TIMED = [(32, 16, 577, 577, 64, False, "bfloat16"), (32, 16, 577, 577, 64, False, "float32"),
               (32, 12, 577, 577, 64, False, "bfloat16"), (32, 12, 577, 577, 64, False, "float32")]
# ViTamin-L-384's vision call under "flash" (phase 13e (c))
FLASH_TIMED += [(8, 16, 576, 576, 64, False, "bfloat16"), (8, 16, 576, 576, 64, False, "float32")]
LONG_MODEL, LONG_BATCH, CLI_LONG_SAMPLES = "ViT-L-14-336", 32, 96
# the long-sequence phases' vision depth: ViT-L-14-336's 24 blocks cut to 2
# to keep the script inside its time limit (width, 577 tokens and every
# check stay; PERF.md keeps the numbers measured at 24, 12, 8 and 4 blocks)
LONG_LAYERS = 2
# the DINOv2 teacher: every variant has head dim 64 and 257 tokens at 224 px
# (fused kernel's gate); the thesis teacher is dinov2-small, 6 heads. HF's
# published dinov2-small config (facebook/dinov2-small/config.json)
TEACHER_CASES = [(64, 6, 257, 64, False), (32, 16, 257, 64, False)]
DINOV2_SMALL = dict(hidden_size=384, layers=12, heads=6, patch_size=14, mlp_ratio=4.0,
                    layerscale_value=1.0, norm_eps=1e-6, use_swiglu_ffn=False,
                    native_image_size=518)
TEACHER_BATCH, TEACHER_BIG_BATCH, LIVE_BATCH = 64, 32, 32
TEACHER_MIN_COS = {"float32": 0.9999, "bfloat16": 0.999}
# one train step through the kernels vs the plain attention, same init/batch
STEP_TOL = {"bfloat16": (1e-2, 0.99), "float32": (1e-5, 0.9999)}  # (loss rel, min cosine)
# the pretrained and thesis-evaluation phases: the zero-shot text call (10
# ImageNet classes x 80 templates, causal) and the offline extractor's bf16
# image batch of 256 rows; the procedural ImageNet-V2 folder's classes (one
# image each); the revision of the seeded hub-cache snapshot
SLICE10_CASES = [(800, 8, 77, 64, True), (256, 12, 197, 64, False)]
ZS_IMAGES, ZS_CLASSES_PER_CALL, EXTRACT_BATCH, HUB_REV = 1000, 10, 256, "seeded"
# Config 2 as published (batch 96), its epochs cut to 2; the preempted run
# gets SIGTERM at this step of its second epoch; the accumulated step
CONFIG2_BATCH, CONFIG2_EPOCHS, PREEMPT_AT, ACCUM = 96, 2, 3, 2
# Config 5's single-chip recipe (docs/REPRODUCE.md:78-90): ViT-g-14 at batch
# 16. Its attention calls: vision [16,16,257,88] (head dim 88: the kernels'
# head-dim-128 instantiations with the tail zero-padded), text [16,16,77,64]
# causal; checked forward and backward in both dtypes, timed beside SDPA
GIANT_MODEL, GIANT_BATCH = "ViT-g-14", 16
# Config 5's depth here: ViT-g-14's 40 vision blocks cut to 4 and its 24
# text blocks to 6 for the time limit (width, head dim 88 and every check
# stay; PERF.md keeps the numbers measured at 40, 16 and 8 vision blocks and
# 24 text blocks, 13.7 GiB at its peak at 40)
GIANT_LAYERS, GIANT_TEXT_LAYERS = 4, 6
GIANT_CASES = [(16, 16, 257, 88, False), (16, 16, 77, 64, True)]
# peak memory of these optimizers under dots_with_no_batch_dims_saveable
GIANT_OPTIMIZERS = (("adamw", None), ("adamw", "bfloat16"), ("adafactor", "bfloat16"))
# the recipe through train.main: mini-Flickr cut to 16 train and 8 val
# images (80 and 40 caption rows: 5 steps of 16, 3 eval batches), one
# epoch, no per-epoch checkpoint (the final export stays)
GIANT_TRAIN_IMAGES, GIANT_VAL_IMAGES, GIANT_PATCH_DROPOUT = 16, 8, 0.5
# Config 5's multi-chip recipe (docs/REPRODUCE.md:69-77) at a model axis of 2,
# both ranks on the card over gloo. The attention calls at each rank's local
# heads: ViT-B-16 at batch 32 (image [32,6,197,64], causal text [32,4,77,64]),
# EVA01-g-14 at batch 16 (vision 16 heads of 88: [16,8,257,88]; causal text
# 12 heads of 64: [16,6,77,64]) and dinov2-giant's 24 heads of 64 forward
# only ([16,12,257,64]); checked forward (all) and backward (the first four)
# in both dtypes in phases 3 and 3b, timed in phases 5 and 6
TP_AXIS, TP_BATCH, TP_EVA_MODEL, TP_EVA_BATCH = 2, 32, "EVA01-g-14", 16
# the EVA01 vision tower's depth in the recipe's train.main runs: cut from 40
# blocks to 2 to keep the script inside its time limit (the width and every
# check stay; the step-level checks at full depth are (a), (c) and phase 19's)
TP_EVA_LAYERS = 2
# the split dinov2-giant teacher of tp (c): its 40 blocks cut to 10 (the
# width, 24 heads of 64 split over the axis, and every check stay)
TP_TEACHER_LAYERS = 10
TP_CASES = [(32, 6, 197, 64, False), (32, 4, 77, 64, True), (16, 8, 257, 88, False),
            (16, 6, 77, 64, True), (16, 12, 257, 64, False)]
TP_BWD_CASES = TP_CASES[:4]
# the EVA01 recipe through train.main: mini-Flickr cut to 7 train images (35
# caption rows: 2 steps of 16), no evaluation, no per-epoch checkpoint
TP_EVA_IMAGES = 7
# CoCa at coca_ViT-L-14's full width and depth (phase 22): the tag whose hub
# cache the seeded weights are written into; the engine's buckets; the
# training batch (bf16), the fp32 step's batch and the steps. Its attention
# calls through the kernels, (B, H, Lq, Lk, D, causal): the decoder's
# cross-attention of 75 text queries over 255 image tokens and its causal
# self-attention at 75 (the vision tower's [b,16,257,64] is a teacher case)
COCA_MODEL, COCA_TAG = "coca_ViT-L-14", "mscoco_finetuned_laion2b_s13b_b90k"
# the CoCa phase's vision depth: coca_ViT-L-14's 24 blocks cut to 4 to keep
# the script inside its time limit (every width, the text tower, the pooler,
# the decoder and every check stay); a vision block holds 12,596,224
# parameters, 638,450,177 at full depth
COCA_VISION_LAYERS, COCA_VISION_BLOCK, COCA_FULL_PARAMS = 4, 12_596_224, 638_450_177
COCA_BUCKETS, COCA_BATCH, COCA_FP32_BATCH, COCA_STEPS = (1, 8), 32, 8, 3
COCA_CASES = [(32, 12, 75, 255, 64, False), (32, 12, 75, 75, 64, True)]
# SigLIP at ViT-B-16-SigLIP's full width and depth (phase 23; Config 4,
# docs/REPRODUCE.md:54-67): the tag whose hub repo the seeded weights and
# the committed c4-en vocabulary are written into; the serving buckets; the
# training batch (Config 4's per-chip batch, docs/REPRODUCE.md:64-66, bf16,
# checkpointed), the fp32 step's batch, the steps; the CLI's tar shards (4 x
# 96 samples: three steps of 128). Its attention calls through the kernels,
# (B, H, Lq, Lk, D, causal): the MAP head's one probe query over the 196
# patch tokens, the non-causal 64-token text tower and the vision blocks, at
# the serving bucket and the training batch; all but the b8 ones are timed
SIGLIP_MODEL, SIGLIP_TAG, SIGLIP_BUCKETS = "ViT-B-16-SigLIP", "webli", (1, 8)
SIGLIP_BATCH, SIGLIP_FP32_BATCH, SIGLIP_STEPS, SIGLIP_SHARD_SAMPLES = 128, 8, 3, 96
SIGLIP_CASES = [(8, 12, 1, 196, 64, False), (128, 12, 1, 196, 64, False),
                (8, 12, 64, 64, 64, False), (128, 12, 64, 64, 64, False),
                (128, 12, 196, 196, 64, False)]
SIGLIP_TIMED = [c for c in SIGLIP_CASES if c[0] == SIGLIP_BATCH]
# Serving as the JAX engine serves (phases 13b and 21 (d)-(g)). Weight-only
# int8: the ViT-B-16 engine from the ``openai`` tag at these buckets, held at
# the JAX test's cosine against fp32 (tests/test_inference.py:121). The
# model axis of 2, each rank's local heads, (B, H, Lq, Lk, D, causal):
# ViT-B-16 served at bucket 8 (image [8,6,197,64], causal text [8,4,77,64]);
# ViT-B-16-SigLIP's step at 8 (the MAP head's probe over 196 keys, the
# non-causal 64-token text, the 196-token vision blocks); coca_ViT-L-14's
# step at 8 (the decoder's cross-attention of 75 queries over 255 keys, its
# causal self-attention, the vision tower's 16 heads of 64 at 257 tokens).
# Checked forward and backward in both dtypes (phases 3 and 3b), timed in
# phases 5 and 6. The SigLIP and CoCa towers there run at full width with
# every tower cut to TP_SERVE_LAYERS blocks (the time limit; their full depths
# run in phases 22 and 23)
INT8_BUCKETS, INT8_MIN_COS = (1, 8), 0.999
# the deployable artifact (phase 4b): ViT-B-16 fp32 exported at these
# buckets; a reloaded program runs the engine's kernels and GEMMs in the same
# order, so its features match the engine's up to fp32 rounding
EXPORT_BUCKETS, EXPORT_TOL, EXPORT_MIN_COS = (1, 8), 1e-5, 0.99999
TP_SERVE_CASES = [(8, 6, 197, 197, 64, False), (8, 4, 77, 77, 64, True),
              (8, 6, 1, 196, 64, False), (8, 6, 64, 64, 64, False),
              (8, 6, 196, 196, 64, False), (8, 6, 75, 255, 64, False),
              (8, 6, 75, 75, 64, True), (8, 8, 257, 257, 64, False)]
TP_SERVE_BATCH, TP_SERVE_LAYERS, TP_SERVE_BUCKETS = 8, 2, (1, 8)
SIGLIP_VOCAB = os.path.join("tests", "assets", "siglip_vocab", "c4_en_32000.json")
# The rest of the loss zoo and the ViT variants (phase 13c, after pretrained).
# Distillation: the ViT-B-16 student under a ViT-L-14 teacher at full width
# and depth, loaded by its ``openai`` tag from the seeded hub cache, at
# ZOO_BATCH (the step checks, and train.main on the first ZOO_CLI_ROWS
# mini-Flickr train rows); CyCLIP: the ViT-B-16 step at ZOO_CYCLIP_BATCH.
# ViT-L-14-CLIPA at full width from the hub repo of its ``datacomp1b`` tag,
# its text read by the committed BERT test vocabulary (the hub cache of
# bert-base-uncased) and served at ZOO_BUCKETS; CLIPA_IDS are the ids the
# CPU test pins for CLIPA_CAPTIONS (tests/test_torch_clipa.py, equal to the
# JAX HFTokenizer's). timm's GAP and relative-position ViTs at full width,
# one forward each at ZOO_VIT_BATCH. The new forward shapes, (B, H, Lq, Lk,
# D, causal), checked in both dtypes (phase 3) and timed (5): the teacher's
# causal text [32,12,77,64], CLIPA's vision [8,16,257,64] and non-causal
# text [8,12,32,64], the GAP ViT's [8,8,256,64] and ViT-bigG-14-CLIPA's head
# dim 104 [16,16,257,104] (it pads to DP = 128, as head dim 88 does; its
# 2.5B-parameter model is not built); the backward runs at none of them but
# head dim 104 (the students train at the training shapes), which phases 3b
# and 6 check and time (ZOO_BWD_CASES)
ZOO_TEACHER, ZOO_STUDENT, ZOO_TEACHER_TAG = "ViT-L-14", "ViT-B-16", "openai"
ZOO_BATCH, ZOO_CYCLIP_BATCH, ZOO_CLI_ROWS, ZOO_STEPS = 32, 64, 96, 3
CLIPA_MODEL, CLIPA_TAG, ZOO_BUCKETS = "ViT-L-14-CLIPA", "datacomp1b", (1, 8)
ZOO_GAP, ZOO_RELPOS, ZOO_VIT_BATCH = ("vit_medium_patch16_gap_256",
                                      "vit_relpos_medium_patch16_cls_224", 8)
ZOO_CASES = [(32, 12, 77, 77, 64, True), (8, 16, 257, 257, 64, False),
             (8, 12, 32, 32, 64, False), (8, 8, 256, 256, 64, False),
             (16, 16, 257, 257, 104, False)]
ZOO_BWD_CASES = ZOO_CASES[-1:]
# EVA02 (phase 13c (e)): EVA02-L-14 at full width and depth served fp32 at
# EVA02_BUCKETS, its bf16 step at EVA02_BATCH and fp32 step at
# EVA02_FP32_BATCH; EVA02-E-14 at full width with its vision depth cut to
# EVA02_E_LAYERS of 64 blocks (the time limit), one forward at
# EVA02_E_BATCH. Their attention calls, (B, H, Lq, Lk, D, causal): the L
# tower at bucket 8 and at the step's 32 (forward and backward), E's head
# dim 112 (forward; it pads to DP = 128)
EVA02_MODEL, EVA02_E_MODEL, EVA02_BUCKETS = "EVA02-L-14", "EVA02-E-14", (1, 8)
EVA02_BATCH, EVA02_FP32_BATCH, EVA02_E_LAYERS, EVA02_E_BATCH = 32, 8, 2, 8
EVA02_CASES = [(8, 16, 257, 257, 64, False), (32, 16, 257, 257, 64, False),
               (8, 16, 257, 257, 112, False)]
EVA02_BWD_CASES = EVA02_CASES[:2]
# The convolution towers (phase 13d, after zoo). RN50 from a seeded OpenAI
# TorchScript archive (fp16, ``num_batches_tracked`` included, as OpenAI's
# carry it) in the hub cache of its ``openai`` tag, served fp32 at
# CONVNET_BUCKETS; its DINO-soft step bf16 at CONVNET_BATCH and fp32 at
# CONVNET_FP32_BATCH, and once with the freeze flag; RN50x64 at 448 px, full
# width, RN_BIG_BLOCKS of its (3, 15, 36, 10) blocks a stage (None: all; 2:
# the time limit), one fp32 forward at RN_BIG_BATCH; convnext_base_w from the
# seeded hub cache of its laion2b_s13b_b82k tag, served fp32, its bf16 step
# at CONVNET_BATCH under --grad-checkpointing; convnext_large_d's mlp head
# loaded from open_clip's visual.head.mlp.* keys, one fp32 forward at 8.
# Their attention calls, (B, H, Lq, Lk, D, causal): the ResNet pool's one
# mean-token query over HW + 1 keys (RN50's 50 at the serving bucket, the
# bf16 and fp32 steps; RN50x64's 197), convnext_base_w's causal text (10
# heads of 64) at the serving bucket and the step; RN50's text is
# ViT-B-16's, convnext_large_d's the ViT-L-14 teacher's. Checked in both
# dtypes (phases 3 and 3b), timed in phases 5 and 6
RN_MODEL, RN_TAG, RN_BIG, RN_BIG_BLOCKS, RN_BIG_BATCH = "RN50", "openai", "RN50x64", 2, 8
CN_MODEL, CN_TAG, CN_MLP = "convnext_base_w", "laion2b_s13b_b82k", "convnext_large_d"
CONVNET_BUCKETS, CONVNET_BATCH, CONVNET_FP32_BATCH = (1, 8), 64, 8
CONVNET_CASES = [(8, 32, 1, 50, 64, False), (64, 32, 1, 50, 64, False),
                 (8, 64, 1, 197, 64, False), (8, 10, 77, 77, 64, True),
                 (64, 10, 77, 77, 64, True)]
CONVNET_BWD_CASES = [(8, 32, 1, 50, 64, False), (64, 32, 1, 50, 64, False),
                     (64, 10, 77, 77, 64, True)]
# The hybrid and windowed towers (phase 13e, after convnets). ViTamin-L from
# the seeded hub cache of its ``datacomp1b`` tag (``pytorch_model.bin`` in
# open_clip's timm layout, the text under ``text.``), served fp32 at
# HYBRID_BUCKETS, its bf16 DINO-soft step at HYBRID_BATCH under
# --grad-checkpointing; ViTamin-L-384 at full width (ViTamin-L's weights, a
# seeded 576-row position table), one fp32 forward at 8 under "flash" and
# under "auto"; swin_base_patch4_window7_224 seeded, fp32 features and its
# bf16 step at HYBRID_BATCH against the fp32 plain step. Their attention
# calls, (B, H, Lq, Lk, D, causal): ViTamin-L's vision [b,16,196,64] at the
# serving bucket and the step (forward and backward), its text [8,12,77,64]
# causal (the step's [32,12,77,64] is ZOO_CASES' teacher text, its backward
# here), ViTamin-L-384's 576 queries through the fused forward ("auto") and
# the flash forward (HYBRID_FLASH_CASES), Swin's text at the step's 32
# (the b8 one is CONVNET_CASES'); Swin's windows carry a mask and run plain.
# The tp pair's parts (e)-(g) at each rank's local heads (model axis 2,
# batch TP_TOWER_BATCH): EVA02-L-14 [8,8,257,64] and its text [8,6,77,64]
# causal (ViTamin-L's text too), EVA02-E-14's [8,8,257,112], Swin's text
# [8,5,77,64] causal and ViTamin-L's [8,8,196,64] (relpos's text is
# TP_SERVE_CASES' [8,4,77,64]). Checked in both dtypes (phases 3, 3b, 7);
# HYBRID_TIMED and HYBRID_BWD_CASES timed in phases 5 and 6
HYBRID_MODEL, HYBRID_TAG, HYBRID_384, SWIN_MODEL = ("ViTamin-L", "datacomp1b", "ViTamin-L-384",
                                                    "swin_base_patch4_window7_224")
HYBRID_BUCKETS, HYBRID_BATCH = (1, 8), 32
HYBRID_CASES = [(8, 16, 196, 196, 64, False), (32, 16, 196, 196, 64, False),
                (8, 12, 77, 77, 64, True), (8, 16, 576, 576, 64, False),
                (32, 10, 77, 77, 64, True), (8, 8, 257, 257, 64, False),
                (8, 6, 77, 77, 64, True), (8, 8, 257, 257, 112, False),
                (8, 5, 77, 77, 64, True), (8, 8, 196, 196, 64, False)]
HYBRID_TIMED = [c for c in HYBRID_CASES if c != (8, 12, 77, 77, 64, True)]
HYBRID_BWD_CASES = [(32, 16, 196, 196, 64, False), (32, 12, 77, 77, 64, True),
                    (32, 10, 77, 77, 64, True), (8, 8, 257, 257, 64, False),
                    (8, 6, 77, 77, 64, True), (8, 5, 77, 77, 64, True),
                    (8, 8, 196, 196, 64, False)]
HYBRID_FLASH_CASES = [(8, 16, 576, 576, 64, False)]
# (e)-(g): EVA02-L-14's and EVA02-E-14's vision depth cut to TP_TOWER_LAYERS
# blocks and ViTamin-L's ViT stage to TP_TOWER_LAYERS (the time limit; the
# widths and every check stay); relpos and Swin at full depth
TP_TOWER_BATCH, TP_TOWER_LAYERS = 8, 2
# MobileCLIP (phase 13f, after hybrids). MobileCLIP-S2 at full width by its
# datacompdr tag from a seeded hub cache, MobileCLIP-B at full width from a
# seeded file in Apple's layout (scripts/mobileclip_apple_layout.py). New
# kernel shapes: the S towers' non-causal text [8,8,77,64] and [64,8,77,64]
# (MobileCLIP-B's causal text and its [B,12,197,64] vision are ViT-B-16's),
# and S1's text at a model axis of 2, [8,4,77,64] non-causal (the tp pair's
# part (i)); checked in both dtypes (phases 3, 3b), timed in phases 5 and 6
MC_S2, MC_B, MC_S1, MC_TAG = "MobileCLIP-S2", "MobileCLIP-B", "MobileCLIP-S1", "datacompdr"
MC_BUCKETS, MC_BATCH = (1, 8), 64
MOBILECLIP_CASES = [(8, 8, 77, 77, 64, False), (64, 8, 77, 77, 64, False),
                    (8, 4, 77, 77, 64, False)]
MOBILECLIP_BWD_CASES = list(MOBILECLIP_CASES)
# (i): MobileCLIP-B's ViT cut to TP_MC_B_LAYERS blocks (the time limit; the
# widths and every check stay), MobileCLIP-S1 whole; every whole gradient at
# cosine >= TP_MC_MIN_COS
TP_MC_B_LAYERS, TP_MC_MIN_COS = 2, 0.99999
# device preprocessing (phase 9b): the batch and raw size of the resampler's
# check, its tolerance against float64; the JPEGs of the decoder comparison
# (made only where the native decoder built),
# mini-Flickr redrawn at 500 px and cut to Flickr30k's 500 x 333
PP_BATCH, PP_RAW, PP_TOL = 96, 256, 1e-4
PP_JPEG_SIZE = (500, 333)
BERT_VOCAB = os.path.join("tests", "assets", "bert_vocab", "tokenizer.json")
BERT_TOKENIZER_CONFIG = {"tokenizer_class": "BertTokenizer", "do_lower_case": True,
                         "model_max_length": 512}
CLIPA_CAPTIONS = ["a photo of a red circle on a black background",
                  "Ünïcödé café: a naïve 猫 and a dog!", "unplayable xyzzy, (yes) $5 <b>"]
CLIPA_IDS = [[101, 104, 238, 220, 104, 258, 254, 225, 104, 266, 244],
             [101, 321, 190, 184, 196, 185, 186, 311, 155, 104, 313, 172, 222, 104, 271, 140],
             [101, 321, 197, 193, 182, 206, 323, 127, 206, 207, 207, 206, 151, 147, 128, 318,
              148, 143, 135, 157, 105, 159]]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase_device() -> None:
    import torch

    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and bool(smi.stdout.strip()),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)
    # fp32 stays fp32 in every comparison: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import refining_clip_via_dinov2_representations_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is missing ({e}): run from the root of the repo")


def phase_build() -> None:
    from refining_clip_via_dinov2_representations_torch import native as host
    from refining_clip_via_dinov2_representations_torch.ops import native

    t0 = time.perf_counter()
    # the host cores (g++) build beside the kernels (nvcc)
    built = {}
    threads = [threading.Thread(target=lambda n=n, f=f: built.__setitem__(n, f()))
               for n, f in (("bpe", host.load_native), ("jpeg", host.load_native_jpeg))]
    for t in threads:
        t.start()
    seconds = native.build()
    print(f"build: {len(seconds)} kernel sources in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())})", flush=True)
    for t in threads:
        t.join()
    print(f"build: host cores in {time.perf_counter() - t0:.2f} s: native BPE "
          f"{'built' if built.get('bpe') is not None else 'FAILED'}, JPEG decoder "
          f"{'native (libjpeg)' if built.get('jpeg') is not None else 'PIL (no libjpeg headers)'}",
          flush=True)
    check(built.get("bpe") is not None, "the native BPE core did not build with g++")
    for name, log in native.build_logs.items():
        kernel = "?"
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                kernel = _kernel_name(entry.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  ptxas[{name}] {kernel}: {line.strip()}", flush=True)


def _kernel_name(mangled: str) -> str:
    """``flash_attention_fwd_mma_kernel<64>`` from its mangled name: the
    identifier ending in ``_kernel`` whose length prefix matches (a kernel in
    an anonymous namespace follows a hashed namespace name)."""
    base = mangled
    for m in re.finditer(r"_kernelI", mangled):
        end = m.start() + len("_kernel")
        starts = [end - n for n in range(len("_kernel") + 1, end)
                  if mangled[end - n].isalpha() and mangled[:end - n].endswith(str(n))]
        if starts:
            base = mangled[starts[0]:end]
            break
    args = ["float"] if "IfLi" in mangled else ["bf16"] if "I13__nv_bfloat16Li" in mangled else []
    args += re.findall(r"Li(\d+)E", mangled)
    return f"{base}<{','.join(args)}>"


def _qkv(b, h, l, d, dtype, seed, lk=None):
    """Seeded q [b,h,l,d] and k, v [b,h,lk,d] (lk = l unless given) on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, n, d, generator=g).to("cuda", dtype) for n in (l, lk or l, lk or l)]


def _attention_fp64(q, k, v, scale, causal):
    """The kernel's function in float64, P still rounded to V's dtype: its
    distance from the kernel is the kernel's own rounding error."""
    import torch

    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    if causal:
        above = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype).double(), v.double())


def phase_kernels() -> dict:
    """Kernel vs its plain version on the card, at the serving, edge,
    teacher and evaluation cases; returns {dtype: max_abs_err}."""
    import torch

    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_fwd, fused_attention_reference,
    )

    worst = {}
    cases = [(b, h, l, l, d, c) for b, h, l, d, c in KERNEL_CASES + TEACHER_CASES + SLICE10_CASES
             + GIANT_CASES + TP_CASES] + COCA_CASES + SIGLIP_CASES + TP_SERVE_CASES + ZOO_CASES
    cases += EVA02_CASES + CONVNET_CASES + HYBRID_CASES + MOBILECLIP_CASES
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, (b, h, l, lk, d, causal) in enumerate(cases):
            q, k, v = _qkv(b, h, l, d, dtype, seed=i, lk=lk)
            scale = d ** -0.5
            got = fused_attention_fwd(q, k, v, scale, causal)
            want = fused_attention_reference(q, k, v, scale, causal)
            exact = _attention_fp64(q, k, v, scale, causal)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dtype,
                  f"kernel output {tuple(got.shape)} {got.dtype} at {(b, h, l, d)}")
            err = (got.float() - want.float()).abs().max().item()
            err64 = (got.double() - exact).abs().max().item()
            worst[name] = max(worst.get(name, 0.0), err)
            ok = (max(err, err64) <= TOL[name]
                  and bool(torch.isfinite(got.float()).all()))
            print(f"kernel fused_attention_fwd {name} [{b},{h},{l},{d}] x {lk} keys "
                  f"causal={causal}: max_abs_err {err:.3e} vs plain, {err64:.3e} vs float64 "
                  f"(tol {TOL[name]:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
            check(ok, f"fused_attention_fwd disagrees with its plain version at "
                      f"{name} [{b},{h},{l},{d}] x {lk} keys causal={causal}: {err:.3e}")
    return worst


def _post(base: str, path: str, payload: dict):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _post_status(base: str, path: str, payload: dict):
    """``_post``, with an HTTP error's status and body returned, not raised."""
    try:
        return _post(base, path, payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _cosines(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def phase_serve():
    """Drive the port's serving path at ViT-B-16 width; returns
    (engine, plain-attention model, kernel launches of the served run)."""
    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.models import create_model
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_fwd,
    )
    from refining_clip_via_dinov2_representations_torch.serve import (
        ClipServer, make_http_server,
    )

    t0 = time.perf_counter()
    engine, preprocess, tokenizer = create_engine(MODEL, device=DEVICE, buckets=BUCKETS,
                                                  seed=SEED)
    model = engine.model
    n_vis, n_txt = len(model.visual.transformer.resblocks), len(model.transformer.resblocks)
    print(f"serve: {MODEL} engine on {engine.device} (vision {n_vis}x"
          f"{model.visual.width}, text {n_txt}x{model.ln_final.weight.numel()}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, buckets "
          f"{engine.buckets}) built and warmed in {time.perf_counter() - t0:.1f} s", flush=True)
    check(n_vis == 12 and n_txt == 12, "ViT-B-16 must have 12 layers per tower")

    rng = np.random.default_rng(SEED)
    pixels = rng.normal(size=(5, 224, 224, 3)).astype(np.float32)
    captions = ["a photo of a cat", "a diagram of a transformer", "two dogs in the snow"]
    http_texts = [f"request number {i} about a red bicycle" for i in range(6)]
    ids = tokenizer(captions)

    server = ClipServer(engine, preprocess, tokenizer, batch_window_ms=50.0)
    httpd = make_http_server(server, host="127.0.0.1", port=0)
    serve_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve_thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    batcher_calls = []
    text_fn = server._text_batcher._fn

    def counted(x):
        batcher_calls.append(x.shape[0])
        return text_fn(x)

    server._text_batcher._fn = counted
    http_feats = [None] * len(http_texts)
    barrier = threading.Barrier(len(http_texts))

    def client(i):
        barrier.wait(timeout=60)
        status, body = _post(base, "/v1/encode_text", {"texts": [http_texts[i]]})
        if status == 200:
            http_feats[i] = np.asarray(body["features"][0], np.float32)

    try:
        # ---- the main path: counts at 0 just before, read just after ----
        fused_attention_fwd.launches = 0
        img_f = engine.encode_image(pixels)            # 1 image-tower call (bucket 8)
        txt_f = engine.encode_text(ids)                # 1 text-tower call (bucket 8)
        sims = engine.similarity(pixels, ids)          # 1 image + 1 text call
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(http_texts))]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        torch.cuda.synchronize()
        launches = fused_attention_fwd.launches
    finally:
        server._text_batcher._fn = text_fn
        httpd.shutdown()
        httpd.server_close()
        server.close()
        serve_thread.join(timeout=30)
    check(not any(t.is_alive() for t in clients), "an HTTP client did not finish")
    check(not serve_thread.is_alive(), "the HTTP server thread did not stop")

    tower_calls = 4 + len(batcher_calls)
    print(f"serve: encode_image {img_f.shape}, encode_text {txt_f.shape}, similarity "
          f"{sims.shape}, /health {health['status']} on {health['device']}, "
          f"{len(http_texts)} concurrent /v1/encode_text coalesced into "
          f"{len(batcher_calls)} batcher calls {batcher_calls}", flush=True)
    print(f"serve: fused_attention_fwd launches {launches} over {tower_calls} tower calls "
          f"(expected {12 * tower_calls})", flush=True)
    check(health["status"] == "ok" and health["buckets"] == list(BUCKETS), "bad /health")
    check(img_f.shape == (5, 512) and txt_f.shape == (3, 512) and sims.shape == (5, 3),
          "feature shapes")
    for name, f in (("image", img_f), ("text", txt_f)):
        norms = np.linalg.norm(f, axis=-1)
        check(bool(np.isfinite(f).all()) and bool(np.abs(norms - 1).max() < 1e-4),
              f"{name} features not finite unit vectors: norms {norms}")
    scale, bias = engine.logit_terms()
    check(bool(np.abs(sims - (scale * img_f @ txt_f.T + bias)).max() < 1e-3),
          "similarity != scale * cos + bias")
    check(all(f is not None for f in http_feats), "an HTTP request failed")
    check(sum(batcher_calls) == len(http_texts) and len(batcher_calls) < len(http_texts),
          f"concurrent requests did not coalesce: {batcher_calls}")
    direct = engine.encode_text(tokenizer(http_texts))
    check(bool(np.abs(np.stack(http_feats) - direct).max() < 1e-4),
          "HTTP features differ from direct engine calls")
    check(launches == 12 * tower_calls,
          f"fused_attention_fwd launched {launches} times, expected {12 * tower_calls}")

    # the same weights through the plain attention path on the card
    plain, _ = create_model(MODEL, device=DEVICE, attn_impl="xla", seed=SEED + 1)
    plain.load_state_dict(model.state_dict(), strict=True)
    with torch.inference_mode():
        x = torch.from_numpy(pixels).to(DEVICE).to(engine.dtype)
        ref_img = plain.encode_image(x).float().cpu().numpy()
        ref_txt = plain.encode_text(torch.from_numpy(ids).to(DEVICE).long()).float().cpu().numpy()
    cos_img, cos_txt = _cosines(img_f, ref_img), _cosines(txt_f, ref_txt)
    print(f"serve: cosine vs plain attention: image min {cos_img.min():.8f}, "
          f"text min {cos_txt.min():.8f} (need >= {MIN_COSINE})", flush=True)
    check(cos_img.min() >= MIN_COSINE and cos_txt.min() >= MIN_COSINE,
          "engine features disagree with the plain-attention run")
    check_fp32_route(lambda: engine.encode_image(pixels), ("fwd",), "one served fp32 image call")
    return engine, plain, launches


def _kernels_launched(fn) -> set:
    """Names of the CUDA kernels that ``fn`` launches, from torch.profiler.
    ``fn`` runs once before the profiled call: a kernel's first launch loads
    its module, and the profiler can miss the kernels of that launch. The
    profiler at times records a window's runtime calls but none of its
    kernels (seen on an H100); such a window is profiled again, up to three
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        if any("_kernel" in n for n in names):
            break
    return names


def check_fp32_route(fn, parts, what: str) -> None:
    """``fn`` ran the split-TF32 kernels named by ``parts`` (keys of
    ``TF32_KERNELS``) and none of the scalar fp32 kernels, by the profiler."""
    names = _kernels_launched(fn)
    ran = {TF32_KERNELS[p]: any(TF32_KERNELS[p] in n for n in names) for p in parts}
    scalar = sorted(n for n in names if any(k in n for k in SCALAR_F32_KERNELS.values()))
    print(f"route {what}: tensor-core fp32 kernels ran {ran}; scalar fp32 kernels "
          f"{scalar or 'none'}", flush=True)
    check(all(ran.values()) and not scalar,
          f"{what} did not run the split-TF32 kernels alone: {sorted(names)}")


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of one call, by CUDA events over `iters` calls. A
    sleep kernel queued first keeps the device behind the host, so host-side
    launch cost does not leak into the device time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 1.5 * iters * host_s + 1e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float, dtype_name: str):
    """(ms, what bounds it): the larger of the bytes over the memory rate and
    the FLOPs over the tensor-core rate for the type, an fp32 FLOP taking
    three TF32 products (split TF32 keeps fp32 accuracy)."""
    t_ops = flops * PRODUCTS_PER_FLOP[dtype_name] / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _case_key(case):
    """A (B, H, Lq, Lk, D, causal) case's key in the time phases' rows:
    (B, H, L, D, causal) where Lq = Lk."""
    b, h, l, lk, d, causal = case
    return (b, h, l, d, causal) if lk == l else case


def attention_work(b, h, l, d, causal, dtype_name, lk=None):
    """(FLOPs, bytes) of the attention forward: QK^T and PV over the live
    score entries (about half when causal); q, k, v read once, o written
    once. lk = l unless given."""
    elem = 4 if dtype_name == "float32" else 2
    lk = lk or l
    pairs = sum(min(i + 1, lk) for i in range(l)) if causal else l * lk
    return 4.0 * b * h * pairs * d, 2.0 * b * h * (l + lk) * d * elem


def _fp32_cuda_core(work, dtype_name: str) -> str:
    """For fp32, the least time with its FLOPs on CUDA cores (67 TFLOP/s),
    printed beside the bound."""
    if dtype_name != "float32":
        return ""
    flops, nbytes = work
    ms = max(flops / CUDA_CORE_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    return f", cuda-core bound {ms:.4f} ms"


def _beside_scalar(before, ms: float) -> str:
    if before is None:
        return "scalar kernel: not recorded"
    return f"scalar kernel {before:.4f} ms (on {SCALAR_CARD}), {before / ms:.2f}x faster"


def phase_kernel_times(dtype_name: str) -> dict:
    """Kernel, plain version and SDPA (yardstick only) at the serving, the
    teacher and the evaluation shapes."""
    import torch
    import torch.nn.functional as F

    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_fwd, fused_attention_reference,
    )

    dtype = getattr(torch, dtype_name)
    rows = {}
    cases = [(b, h, l, l, d, c) for b, h, l, d, c in TIMED_CASES + TEACHER_CASES
             + SLICE10_CASES + GIANT_CASES + TP_CASES] + COCA_CASES + SIGLIP_TIMED + TP_SERVE_CASES
    cases += ZOO_CASES + EVA02_CASES + CONVNET_CASES + HYBRID_TIMED + MOBILECLIP_CASES
    for b, h, l, lk, d, causal in cases:
        q, k, v = _qkv(b, h, l, d, dtype, seed=100, lk=lk)
        scale = d ** -0.5
        ms = time_ms(lambda: fused_attention_fwd(q, k, v, scale, causal), iters=20)
        plain = time_ms(lambda: fused_attention_reference(q, k, v, scale, causal), iters=20)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale), iters=20)
        work = attention_work(b, h, l, d, causal, dtype_name, lk=lk)
        bound, by = _bound(*work, dtype_name)
        row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
        rows[_case_key((b, h, l, lk, d, causal))] = row
        print(f"time fused_attention_fwd {dtype_name} [{b},{h},{l},{d}] x {lk} keys "
              f"causal={causal}: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by}){_fp32_cuda_core(work, dtype_name)}, kernel at "
              f"{bound / ms:.1%} of bound; "
              f"{_beside_scalar(SCALAR_FUSED_MS.get((dtype_name, (b, h, l, d, causal))), ms)}"
              f" [{CARD}]", flush=True)
    return rows


def phase_serving_times(engine, plain) -> None:
    """Tower time per call with the kernel and with plain attention (CUDA
    events, see ``time_ms``), and the request latency per bucket (host
    clock, H2D and D2H included)."""
    import numpy as np
    import torch

    h, w = engine.image_size
    rng = np.random.default_rng(SEED + 2)
    for b in engine.buckets:
        x = torch.from_numpy(rng.normal(size=(b, h, w, 3)).astype(np.float32)).to("cuda")
        ids = torch.zeros(b, engine.context_length, dtype=torch.long, device="cuda")
        ids[:, 0], ids[:, 1:6], ids[:, 6] = 49406, 320, 49407
        with torch.inference_mode():
            img_ms = time_ms(lambda: engine.model.encode_image(x.to(engine.dtype)), iters=10)
            img_plain = time_ms(lambda: plain.encode_image(x.to(engine.dtype)), iters=10)
            txt_ms = time_ms(lambda: engine.model.encode_text(ids), iters=10)
            txt_plain = time_ms(lambda: plain.encode_text(ids), iters=10)
        host_x, host_ids = x.cpu().numpy(), ids.cpu().numpy().astype(np.int32)
        lat = {}
        for name, fn, arg in (("encode_image", engine.encode_image, host_x),
                              ("encode_text", engine.encode_text, host_ids)):
            samples = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn(arg)
                samples.append((time.perf_counter() - t0) * 1e3)
            lat[name] = statistics.median(samples)
        print(f"time tower bucket {b}: image {img_ms:.3f} ms per call (plain attention "
              f"{img_plain:.3f}), text {txt_ms:.3f} ms (plain {txt_plain:.3f}); request "
              f"latency p50 encode_image {lat['encode_image']:.3f} ms, encode_text "
              f"{lat['encode_text']:.3f} ms"
              f" [{CARD}]", flush=True)


@contextlib.contextmanager
def _each_call(module, name: str, seconds: list):
    """Wraps ``module.name`` so that each call appends its wall time to
    ``seconds``; restores it on exit."""
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, fn)


def _export_timed(engine, out: str) -> tuple:
    """``engine.export(out)`` of a one-process engine: (the written paths,
    {program: seconds to trace it and write its file})."""
    import torch

    from refining_clip_via_dinov2_representations_torch import inference

    traced, saved = [], []
    with _each_call(inference, "_trace", traced), _each_call(torch.export, "save", saved):
        written = engine.export(out)
    return written, {k: traced[i] + saved[i] for i, k in enumerate(written)}


def _through_artifact(path: str, x, want, what: str, kernel: str, layers: int) -> tuple:
    """One reloaded program (``load_exported``) on ``x``, the main path:
    ``layers`` launches of ``kernel`` and none of another (counts at 0 just
    before, read just after), features within ``EXPORT_TOL`` and at cosine
    ``EXPORT_MIN_COS`` of ``want`` (the engine's), checked. Returns (the
    callable, its load seconds, the launches, the features)."""
    import numpy as np

    from refining_clip_via_dinov2_representations_torch.inference import load_exported

    t0 = time.perf_counter()
    run = load_exported(path)
    load_s = time.perf_counter() - t0
    # ---- the main path: counts at 0 just before, read just after ----
    _zero_counts()
    got = run(x)
    _sync()
    counts = _read_counts()
    got = got.cpu().numpy()
    err, cos = float(np.abs(got - want).max()), float(_cosines(got, want).min())
    want_counts = {k: layers if k == kernel and DEVICE == "cuda" else 0 for k in counts}
    print(f"export {what}: {os.path.getsize(path):,} bytes, loaded in {load_s:.2f} s; features "
          f"{got.shape} vs the engine max abs error {err:.3e} (tol {EXPORT_TOL:g}), min cosine "
          f"{cos:.8f} (need >= {EXPORT_MIN_COS}); launches {counts}", flush=True)
    check(got.shape == want.shape and bool(np.isfinite(got).all()) and err <= EXPORT_TOL
          and cos >= EXPORT_MIN_COS, f"export {what}: the artifact disagrees with the engine")
    check(counts == want_counts, f"export {what}: launches {counts}, expected {want_counts}")
    return run, load_s, counts, got


def _host_ms(fn, n: int = 10) -> float:
    """Median host clock of ``n`` calls, each ending in a device sync."""
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        _sync()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def phase_export(engine) -> dict:
    """The deployable artifact (phase 4b): the serve phase's seeded ViT-B-16
    fp32 engine exported at ``EXPORT_BUCKETS`` (``ClipInferenceEngine.
    export``, one program per encoder and bucket) and each program reloaded
    with ``load_exported``: its features against the engine's, its launches
    (12 fused-forward a tower call: the reloaded program runs the
    hand-written kernel), the profiler's check that the fp32 image program
    runs the split-TF32 kernel alone; seconds to export and to load each
    program, each file's bytes, and each program's call time beside the
    engine's (host clock, median of 10 calls that end in a sync; CUDA
    events, ``time_ms``). Returns the launches."""
    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine

    t_phase = time.perf_counter()
    model = engine.model
    eng = ClipInferenceEngine(model, engine.image_size, engine.context_length, EXPORT_BUCKETS,
                              dtype=engine.dtype)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    out = tempfile.mkdtemp(prefix="chip_smoke_export_", dir=build)
    written, export_s = _export_timed(eng, out)
    print(f"export {MODEL} fp32 buckets {EXPORT_BUCKETS}: seconds to export each program "
          f"{ {k: round(v, 2) for k, v in export_s.items()} }; bytes "
          f"{ {k: os.path.getsize(p) for k, p in written.items()} }", flush=True)
    layers = len(model.visual.transformer.resblocks)
    rng = np.random.default_rng(SEED + 80)
    h, w = eng.image_size
    total = {}
    for name, path in written.items():
        op, b = name.rsplit("_b", 1)
        b = int(b)
        if op == "encode_image":
            x = rng.normal(size=(b, h, w, 3)).astype(np.float32)
            want = eng.encode_image(x)
        else:
            x = np.zeros((b, eng.context_length), np.int32)
            x[:, 0], x[:, 1:6], x[:, 6] = 49406, rng.integers(1, 49405, (b, 5)), 49407
            want = eng.encode_text(x)
        run, _, counts, _ = _through_artifact(path, x, want, f"{name} fp32",
                                              "fused_attention_fwd", layers)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        xd = torch.from_numpy(x).to(DEVICE)
        if op == "encode_image" and b == EXPORT_BUCKETS[-1] and DEVICE == "cuda":
            check_fp32_route(lambda: run(xd), ("fwd",), f"the exported fp32 {name}")
        eager = eng._encoders[op]  # what the engine runs for the same rows
        with torch.no_grad():
            times = {"artifact": (_host_ms(lambda: run(xd)), time_ms(lambda: run(xd), iters=10)),
                     "engine": (_host_ms(lambda: eager(xd)), time_ms(lambda: eager(xd), iters=10))}
        print(f"time export {name}: the reloaded program {times['artifact'][0]:.3f} ms host "
              f"clock, {times['artifact'][1]:.3f} ms CUDA events; the engine's encoder "
              f"{times['engine'][0]:.3f} ms host clock, {times['engine'][1]:.3f} ms CUDA events "
              f"[{CARD}]", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    print(f"export: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def _export_one_bucket(model, image_size, context_length, out: str, what: str, kernel: str,
                       x) -> tuple:
    """``model`` exported by an engine at bucket 1 (images rounded to bf16,
    the engine's default), its image program reloaded and run on the one
    image ``x`` against that engine (``_through_artifact``). Returns (the
    launches, the image program's tensor elements by dtype, the features)."""
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine

    eng = ClipInferenceEngine(model, image_size, context_length, (1,))
    written, export_s = _export_timed(eng, out)
    program = torch.export.load(written["encode_image_b1"])
    tensors = {}
    for t in program.constants.values():
        key = str(t.dtype).split(".")[-1]
        tensors[key] = tensors.get(key, 0) + t.numel()
    del program
    layers = len(model.visual.transformer.resblocks)
    _, _, counts, got = _through_artifact(written["encode_image_b1"], x, eng.encode_image(x),
                                          f"{what} encode_image_b1", kernel, layers)
    print(f"export {what}: seconds to export each program "
          f"{ {k: round(v, 2) for k, v in export_s.items()} }, bytes "
          f"{ {k: os.path.getsize(p) for k, p in written.items()} }; the image program's "
          f"tensor elements by dtype {tensors}", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return counts, tensors, got


def _attention_bwd_fp64(q, k, v, o, do, scale, causal):
    """The backward kernel's function in float64, rounded to the input dtype
    where ``_bwd_kernel`` rounds (P and dO for dV, dS): its distance from
    the kernel is the kernel's own rounding error."""
    import torch

    t = q.dtype
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    if causal:
        above = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.to(t).double().transpose(-1, -2), do.double())
    dp = torch.matmul(do.double(), v.double().transpose(-1, -2))
    delta = (do.double() * o.double()).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(t).double()
    return (torch.matmul(ds, k.double()) * scale, torch.matmul(ds.transpose(-1, -2), q.double())
            * scale, dv)


def bwd_cases():
    """Every backward case as (B, H, Lq, Lk, D, causal)."""
    return ([(b, h, l, l, d, c) for b, h, l, d, c in KERNEL_CASES + TRAIN_CASES + GIANT_CASES
             + TP_BWD_CASES] + BWD_CASES + COCA_CASES + SIGLIP_CASES + TP_SERVE_CASES
            + ZOO_BWD_CASES + EVA02_BWD_CASES + CONVNET_BWD_CASES + HYBRID_BWD_CASES
            + MOBILECLIP_BWD_CASES)


def check_bwd_case(b, h, lq, lk, d, causal, dtype, seed, qkv=None):
    """The backward kernel against its plain version and the float64 version
    at one case, with seeded inputs (or the given q, k, v). Prints one line;
    returns (max_abs_err vs plain, ok)."""
    import torch

    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_bwd_reference, fused_attention_fwd,
    )

    name = str(dtype).split(".")[-1]
    q, k, v = qkv or _qkv(b, h, lq, d, dtype, seed=seed, lk=lk)
    do = _qkv(b, h, lq, d, dtype, seed=1000 + seed)[0]
    scale = d ** -0.5
    o = fused_attention_fwd(q, k, v, scale, causal)
    got = fused_attention_bwd(q, k, v, o, do, scale, causal)
    want = fused_attention_bwd_reference(q, k, v, o, do, scale, causal)
    exact = _attention_bwd_fp64(q, k, v, o, do, scale, causal)
    torch.cuda.synchronize()
    largest = max(w.float().abs().max().item() for w in want)
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    err64 = max((g.double() - e).abs().max().item() for g, e in zip(got, exact))
    ok = (all(g.dtype == dtype and g.shape == w.shape for g, w in zip(got, want))
          and max(err, err64) <= BWD_REL_TOL[name] * largest
          and all(bool(torch.isfinite(g.float()).all()) for g in got))
    print(f"kernel fused_attention_bwd {name} [{b},{h},{lq},{d}] x {lk} keys causal={causal}: "
          f"max_abs_err {err:.3e} vs plain, {err64:.3e} vs float64, largest |grad| "
          f"{largest:.3e} (tol {BWD_REL_TOL[name]:g} x largest) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    return err, ok


def phase_kernels_bwd() -> dict:
    """Backward kernel vs its plain version (and float64) on the card;
    returns {dtype: max_abs_err vs plain}."""
    import torch

    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention, fused_attention_reference,
    )

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, (b, h, lq, lk, d, causal) in enumerate(bwd_cases()):
            err, ok = check_bwd_case(b, h, lq, lk, d, causal, dtype, seed=i)
            worst[name] = max(worst.get(name, 0.0), err)
            check(ok, f"fused_attention_bwd disagrees with its plain version at "
                      f"{name} [{b},{h},{lq},{d}] x {lk} keys causal={causal}: {err:.3e}")
    # the forward op's registered autograd against autograd through the plain
    # forward, fp32
    for i, (b, h, l, d, causal) in enumerate(TRAIN_CASES):
        q, k, v = (x.requires_grad_() for x in _qkv(b, h, l, d, torch.float32, seed=50 + i))
        do = _qkv(b, h, l, d, torch.float32, seed=60 + i)[0]
        got = torch.autograd.grad(fused_attention(q, k, v, d ** -0.5, causal), (q, k, v), do)
        want = torch.autograd.grad(fused_attention_reference(q, k, v, d ** -0.5, causal),
                                   (q, k, v), do)
        largest = max(w.abs().max().item() for w in want)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        print(f"autograd fused_attention float32 [{b},{h},{l},{d}] causal={causal}: max_abs_err "
              f"{err:.3e} vs autograd of the plain forward (tol 1e-4 x {largest:.3e})", flush=True)
        check(err <= 1e-4 * largest, "the fused op's autograd disagrees with autograd")
    return worst


def _train_batch(tokenizer, n: int, device: str, model_name: str = MODEL, size=None,
                 seed: int = SEED + 10) -> dict:
    """Seeded random pixels (at the model's image size unless ``size``), n
    distinct captions through the port's tokenizer, seeded DINO features."""
    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_model_config

    size = size or get_model_config(model_name)["vision_cfg"]["image_size"]
    rng = np.random.default_rng(seed)
    captions = [f"a photo of item {i}, a {['red', 'green', 'blue', 'grey'][i % 4]} thing "
                f"number {i * 7 + 3} in scene {i % 5}" for i in range(n)]
    return {
        "images": torch.from_numpy(rng.normal(size=(n, size, size, 3)).astype(np.float32)).to(device),
        "texts": torch.from_numpy(tokenizer(captions)).long().to(device),
        "dino_features": torch.from_numpy(
            rng.normal(size=(n, DINO_DIM)).astype(np.float32)).to(device),
    }


def _dino_setup(precision: str, attn_impl: str, steps: int = 3, model_name: str = MODEL,
                grad_checkpointing=False, force_image_size=None, dino_teacher=None,
                optim_kw=None, **model_kw):
    """The model (ViT-B-16 by default) + the MLP DINO head (embed dim ->
    448 -> 384 for ViT-B-16) + default param groups + a cosine schedule, from
    the same seeds every time; returns (model, head, state, train_step,
    step_cfg). ``dino_teacher`` gives the step a live teacher; ``optim_kw``
    go to ``OptimCfg`` (``opt``, ``mu_dtype``; AdamW by default),
    ``model_kw`` to ``create_model`` (``pretrained``, ``cache_dir``).
    ``grad_checkpointing`` is a bool or a remat policy's name."""
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.models import create_model
    from refining_clip_via_dinov2_representations_torch.train.optim import (
        OptimCfg, build_optimizer,
    )
    from refining_clip_via_dinov2_representations_torch.train.scheduler import cosine_lr
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, TrainState, make_train_step, train_parameters,
    )

    model, _ = create_model(model_name, precision=precision, device=DEVICE, attn_impl=attn_impl,
                            seed=SEED, grad_checkpointing=grad_checkpointing,
                            force_image_size=force_image_size, **model_kw)
    model.train()
    torch.manual_seed(SEED + 1)
    head = DinoProjectionHead(model.text_projection.shape[1], DINO_DIM, "mlp").to(DEVICE)
    optimizer, _ = build_optimizer(train_parameters(model, head), OptimCfg(**(optim_kw or {})),
                                   cosine_lr(5e-4, 0, steps))
    cfg = StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5, soft_mode="kl_teacher"))
    state = TrainState(model, head, optimizer, 0, torch.Generator().manual_seed(SEED))
    return model, head, state, make_train_step(model, cfg, head, dino_teacher), cfg


def _loss_and_grads(model, head, cfg, batch):
    from refining_clip_via_dinov2_representations_torch.train.step import (
        make_loss_fn, train_parameters,
    )

    params = train_parameters(model, head)
    for p in params.values():
        p.grad = None
    loss, _ = make_loss_fn(model, cfg, head)(batch, 0)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in params.items() if p.grad is not None}
    for p in params.values():
        p.grad = None
    return float(loss.detach()), grads


def _grad_cosines(grads_a: dict, grads_b: dict):
    """Per-tensor gradient cosines, and the cosine of all tensors together."""
    import torch

    cos, dot, na, nb = {}, 0.0, 0.0, 0.0
    for n in grads_a:
        a, b = grads_a[n].double().flatten(), grads_b[n].double().flatten()
        ab, aa, bb = float(a @ b), float(a @ a), float(b @ b)
        cos[n] = ab / max((aa * bb) ** 0.5, 1e-300)
        dot, na, nb = dot + ab, na + aa, nb + bb
    # all tensors together, summed tensor by tensor (no concatenated copy:
    # ViT-g-14's gradients are 1.4 billion numbers)
    return cos, dot / (na * nb) ** 0.5


@contextlib.contextmanager
def _plain_versions():
    """Run the flash and fused ops (forward, and backward through their
    registered autograd) on their plain versions on CUDA tensors
    (measurement only): each op takes its plain version where its inputs
    count as on the CPU, so a step through them against one through plain
    attention compares two plain PyTorch versions, no kernel."""
    from refining_clip_via_dinov2_representations_torch.ops import flash_attention as fm
    from refining_clip_via_dinov2_representations_torch.ops import fused_attention as fu

    on_cpu = fu._on_cpu, fm._on_cpu
    fu._on_cpu = fm._on_cpu = lambda *tensors: True
    try:
        yield
    finally:
        fu._on_cpu, fm._on_cpu = on_cpu


def _compare_step(precision: str, batch, model_name: str = MODEL, impl: str = "auto",
                  grad_checkpointing: bool = False) -> None:
    """One loss and gradient through the kernels vs the plain attention.
    fp32: every tensor's gradient cosine is held to the minimum. bf16: the
    cosine of all tensors together is, as the bf16 train-step test does
    (``tests/test_torch_train_step.py``), and the per-tensor minimum is
    printed beside the same comparison between two plain versions (the
    kernels' and plain attention), no kernel involved: the bf16 noise floor
    of the step. In bf16 single tensors (``dino_head.fc1.bias``) fall below
    0.99 also between two plain versions, at 197 and at 577 tokens
    (``scripts/step_noise_floor.py``, PERF.md)."""
    import torch

    name = "bfloat16" if precision == "bf16" else "float32"
    loss_tol, min_cos = STEP_TOL[name]
    per_tensor = precision != "bf16"

    def run(attn):
        model, head, _, _, cfg = _dino_setup(precision, attn, model_name=model_name,
                                             grad_checkpointing=grad_checkpointing)
        result = _loss_and_grads(model, head, cfg, batch)
        del model, head
        torch.cuda.empty_cache()
        return result

    (loss_k, grads_k), (loss_p, grads_p) = run(impl), run("xla")
    check(grads_k.keys() == grads_p.keys(), "the two runs have different parameters")
    cos, together = _grad_cosines(grads_k, grads_p)
    worst = min(cos, key=cos.get)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    fp32_grads = all(g.dtype == torch.float32 for g in grads_k.values())
    held = cos[worst] if per_tensor else together
    print(f"train-step {model_name} {precision} impl={impl} grad_checkpointing="
          f"{grad_checkpointing}: loss {loss_k:.6f} through the kernels vs {loss_p:.6f} plain "
          f"(rel {rel:.2e}, tol {loss_tol:g}); gradient cosine, per tensor min {cos[worst]:.6f} "
          f"at {worst} ({sum(c < min_cos for c in cos.values())} of {len(cos)} tensors below "
          f"{min_cos}), all tensors together {together:.6f} (need "
          f"{'per tensor' if per_tensor else 'together'} >= {min_cos}); fp32 grads "
          f"{fp32_grads}", flush=True)
    if not per_tensor:
        with _plain_versions():
            loss_f, grads_f = run(impl)
        cos_f, together_f = _grad_cosines(grads_f, grads_p)
        worst_f = min(cos_f, key=cos_f.get)
        print(f"train-step {model_name} {precision} noise floor, impl={impl} through the "
              f"kernels' plain versions vs plain attention (no kernel): loss rel "
              f"{abs(loss_f - loss_p) / abs(loss_p):.2e}; gradient cosine, per tensor min "
              f"{cos_f[worst_f]:.6f} at {worst_f} ({sum(c < min_cos for c in cos_f.values())} "
              f"below {min_cos}), all tensors together {together_f:.6f}", flush=True)
    check(rel <= loss_tol and held >= min_cos and fp32_grads,
          f"{precision} step through the kernels disagrees with plain attention")


def host_step_ms(fn, steps: int = 5) -> float:
    """Mean host-clock time of one call over ``steps`` back-to-back calls
    that end in one device sync: what a training loop sees, host launch cost
    and device time overlapping."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def phase_train_step():
    """The training main path at ViT-B-16 width, bf16 compute; returns
    (forward launches, backward launches, timing dict)."""
    import math

    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_fwd,
    )

    batch = _train_batch(get_tokenizer(MODEL), TRAIN_BATCH, DEVICE)
    _compare_step("bf16", batch)

    model, head, state, train_step, _ = _dino_setup("bf16", "auto")
    head_before = [p.detach().clone() for p in head.parameters()]
    steps = 3
    # ---- the main path: counts at 0 just before, read just after ----
    fused_attention_fwd.launches = fused_attention_bwd.launches = 0
    losses = []
    for _ in range(steps):
        state, metrics = train_step(state, batch)
        losses.append(metrics["total_loss"])
    torch.cuda.synchronize()
    fwd, bwd = fused_attention_fwd.launches, fused_attention_bwd.launches
    losses = [float(x) for x in losses]
    ln_scale = float(model.logit_scale.detach())
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(head.parameters(), head_before))
    print(f"train-step: {MODEL} bf16 DINO-soft (kl_teacher, lambda_soft 0.5, mlp head "
          f"{head.fc1.in_features}->{head.fc1.out_features}->{DINO_DIM}) batch {TRAIN_BATCH}: losses {losses}, ln logit scale {ln_scale:.6f}, head "
          f"moved by {moved:.3e}; launches fwd {fwd} bwd {bwd} over {steps} steps "
          f"(expected {24 * steps} each)", flush=True)
    check(all(math.isfinite(x) for x in losses), "a train-step loss is not finite")
    check(0.0 <= ln_scale <= math.log(100.0), "the logit scale left [0, ln 100]")
    check(moved > 0, "the DINO head did not move")
    check(fwd == 24 * steps and bwd == 24 * steps,
          f"expected {24 * steps} forward and backward launches, got {fwd} and {bwd}")

    # ---- step time and peak memory, kernels vs plain attention ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: train_step(state, batch), iters=5)
    host_ms = host_step_ms(lambda: train_step(state, batch))
    peak = torch.cuda.max_memory_allocated()
    del model, head, state, train_step
    torch.cuda.empty_cache()
    _, _, p_state, p_step, _ = _dino_setup("bf16", "xla")
    torch.cuda.reset_peak_memory_stats()
    plain_ms = time_ms(lambda: p_step(p_state, batch), iters=5)
    plain_host_ms = host_step_ms(lambda: p_step(p_state, batch))
    plain_peak = torch.cuda.max_memory_allocated()
    del p_state, p_step
    torch.cuda.empty_cache()
    print(f"time train step {MODEL} bf16 batch {TRAIN_BATCH}: device {step_ms:.3f} ms with the "
          f"kernels, {plain_ms:.3f} ms with plain attention (CUDA events); host clock "
          f"{host_ms:.3f} ms ({TRAIN_BATCH / host_ms * 1e3:.1f} samples/s) with the kernels, "
          f"{plain_host_ms:.3f} ms ({TRAIN_BATCH / plain_host_ms * 1e3:.1f} samples/s) plain; "
          f"peak memory {peak / 2**30:.3f} GiB (plain {plain_peak / 2**30:.3f} GiB)"
              f" [{CARD}]", flush=True)

    _compare_step("fp32", batch)
    phase_fp32_step(batch)
    return fwd, bwd


def phase_fp32_step(batch) -> None:
    """The ViT-B-16 DINO-soft step in fp32 compute (what ``--precision amp``,
    the CLI's default, runs): launches over three steps, the kernels one step
    runs by the profiler (the split-TF32 ones, no scalar fp32 kernel), then
    the step's time and peak memory through the kernels and through plain
    attention."""
    import torch

    model, head, state, train_step, _ = _dino_setup("fp32", "auto")
    steps = 3
    _zero_counts()
    for _ in range(steps):
        state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    counts = _read_counts()
    print(f"train-step {MODEL} fp32: launches {counts} over {steps} steps (expected fused fwd "
          f"and bwd {24 * steps} each)", flush=True)
    check(counts["fused_attention_fwd"] == 24 * steps
          and counts["fused_attention_bwd"] == 24 * steps, f"fp32 step launches {counts}")
    check_fp32_route(lambda: train_step(state, batch), ("fwd", "dq", "dkdv"),
                     "one fp32 train step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: train_step(state, batch), iters=5)
    host_ms = host_step_ms(lambda: train_step(state, batch))
    peak = torch.cuda.max_memory_allocated()
    del model, head, state, train_step
    torch.cuda.empty_cache()
    _, _, p_state, p_step, _ = _dino_setup("fp32", "xla")
    torch.cuda.reset_peak_memory_stats()
    plain_ms = time_ms(lambda: p_step(p_state, batch), iters=5)
    plain_host_ms = host_step_ms(lambda: p_step(p_state, batch))
    plain_peak = torch.cuda.max_memory_allocated()
    del p_state, p_step
    torch.cuda.empty_cache()
    print(f"time train step {MODEL} fp32 batch {TRAIN_BATCH}: device {step_ms:.3f} ms with the "
          f"kernels, {plain_ms:.3f} ms with plain attention (CUDA events); host clock "
          f"{host_ms:.3f} ms ({TRAIN_BATCH / host_ms * 1e3:.1f} samples/s) with the kernels, "
          f"{plain_host_ms:.3f} ms ({TRAIN_BATCH / plain_host_ms * 1e3:.1f} samples/s) plain; "
          f"peak memory {peak / 2**30:.3f} GiB (plain {plain_peak / 2**30:.3f} GiB) [{CARD}]",
          flush=True)


def phase_train_cli() -> None:
    """``train.main.main`` for one synthetic epoch; its checkpoint serves."""
    import json as _json
    import math
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_fwd,
    )
    from refining_clip_via_dinov2_representations_torch.train.main import main as train_main

    # a temporary directory inside the checkout's (ignored) build tree
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    logs = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=build)
    try:
        fused_attention_fwd.launches = fused_attention_bwd.launches = 0
        train_main(["--model", MODEL, "--dataset-type", "synthetic", "--use_dino_general",
                    "--soft_mode", "kl_teacher", "--lambda_soft", "0.5",
                    "--synthetic-dino-dim", str(DINO_DIM), "--precision", "bf16",
                    "--batch-size", str(CLI_BATCH), "--train-num-samples", str(CLI_SAMPLES),
                    "--epochs", "1", "--workers", "4", "--log-every-n-steps", "1",
                    "--logs", logs, "--name", "cli", "--seed", str(SEED), "--device", DEVICE])
        torch.cuda.synchronize()
        launches = fused_attention_fwd.launches + fused_attention_bwd.launches
        steps = CLI_SAMPLES // CLI_BATCH
        with open(os.path.join(logs, "cli", "loss_steps.json")) as f:
            records = _json.load(f)
        ckpt = os.path.join(logs, "cli", "checkpoints", "epoch_1.pt")
        print(f"train-cli: {len(records)} logged steps, total_loss "
              f"{[r['total_loss'] for r in records]}; kernel launches {launches} "
              f"(expected {48 * steps}); checkpoint {os.path.getsize(ckpt) / 2**20:.1f} MiB",
              flush=True)
        check(len(records) == steps and all(math.isfinite(r["total_loss"]) for r in records),
              "loss_steps.json is not one finite record per step")
        check(launches == 48 * steps, f"the CLI run launched {launches} kernels")
        engine, _, tokenizer = create_engine(MODEL, checkpoint=ckpt, buckets=(1,), device=DEVICE)
        feats = engine.encode_text(tokenizer(["a photo of a cat"]))
        norm = float(np.linalg.norm(feats))
        print(f"train-cli: the checkpoint serves encode_text {feats.shape}, norm {norm:.6f}",
              flush=True)
        check(feats.shape[0] == 1 and abs(norm - 1) < 1e-4, "the checkpoint does not serve")
        del engine
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(logs, ignore_errors=True)


@contextlib.contextmanager
def _timed(module, name: str, seconds: dict):
    """Wraps ``module.name`` so that each call adds its wall time (after a
    device sync) to ``seconds[name]``; restores it on exit."""
    import torch

    fn = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            if DEVICE != "cpu":
                torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, fn)


def _eval_cli_run(argv: list, timed=()) -> tuple:
    """One ``train.main.main`` run: (records, launch counts, wall seconds,
    seconds in train_one_epoch / evaluate / run_clip_blind_on_split and in
    each further (module, function name) of ``timed``)."""
    import torch

    from refining_clip_via_dinov2_representations_torch.eval import clip_blind
    from refining_clip_via_dinov2_representations_torch.train import evaluate as evaluate_mod
    from refining_clip_via_dinov2_representations_torch.train import main as main_mod

    seconds: dict = {}
    with contextlib.ExitStack() as stack:
        for module, name in ((main_mod, "train_one_epoch"), (evaluate_mod, "evaluate"),
                             (clip_blind, "run_clip_blind_on_split"), *timed):
            stack.enter_context(_timed(module, name, seconds))
        # ---- the main path: counts at 0 just before, read just after ----
        _zero_counts()
        t0 = time.perf_counter()
        records = main_mod.main(argv)
        if DEVICE != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
    return records, counts, wall, seconds


def phase_data(work: str) -> dict:
    """mini-Flickr at 224 px under ``work``: 160 train and 40 val images,
    five captions each, DINO-like features of 384 dims; returns its paths."""
    from scripts.mini_flickr import generate

    t0 = time.perf_counter()
    d = generate(os.path.join(work, "data"), n_train=EVAL_TRAIN_IMAGES, n_val=EVAL_VAL_IMAGES,
                 size_px=EVAL_SIZE_PX, dino_dim=DINO_DIM, seed=SEED)
    print(f"data: mini-Flickr {EVAL_TRAIN_IMAGES} + {EVAL_VAL_IMAGES} images at "
          f"{EVAL_SIZE_PX} px in {time.perf_counter() - t0:.2f} s", flush=True)
    return d


def _thesis_argv(d: dict, work: str, name: str) -> list:
    """The thesis protocol's CLI flags on mini-Flickr: the DINO-soft flags of
    ``scripts/dress_rehearsal.py:_common_flags``, ViT-B-16, ``--precision
    amp`` at batch 32, the precomputed features for training and the
    CLIP-blind check on both splits; the run under ``work/name``."""
    return ["--model", EVAL_MODEL, "--train-data", d["train_csv"], "--val-data",
            d["val_csv"], "--dataset-type", "csv", "--batch-size", str(EVAL_BATCH),
            "--precision", "amp", "--lr", "5e-4", "--warmup", "2", "--wd", "0.1",
            "--workers", "8", "--seed", str(SEED), "--use_dino_general", "--lambda_soft",
            "0.5", "--soft_mode", "kl_teacher", "--lambda_weighted", "0.2",
            "--dino_fts_path", d["dino_feats"], "--dino_index_map_path", d["dino_index_map"],
            "--dino_fts_path_val", d["dino_feats"], "--dino_index_map_path_val",
            d["dino_index_map"], "--run_clip_blind", "--clip_blind_val_key", "val",
            "--log-every-n-steps", "1", "--logs", work, "--name", name, "--device", DEVICE]


def _thesis_launches(args):
    """(train batches, val batches, CLIP-blind batches of both splits, and
    the expected launches of a run with ``evals`` evaluations: 48 a train
    step, 24 an eval batch, 12 a CLIP-blind batch) of the thesis flags."""
    from refining_clip_via_dinov2_representations_torch.train.data import (
        _clone_args, get_csv_dataset,
    )

    train_batches = get_csv_dataset(args, None, True).dataloader.num_batches
    val_batches = get_csv_dataset(args, None, False).dataloader.num_batches
    blind_info = get_csv_dataset(_clone_args(args, val_data=args.train_data), None, False)
    check(2 * args.clip_blind_max_images >= blind_info.dataloader.num_samples,
          "the CLIP-blind cap would cut the train split")
    blind_batches = val_batches + blind_info.dataloader.num_batches

    def expected(evals: int) -> dict:
        return {"flash_attention_fwd": 0,
                "fused_attention_fwd": 24 * train_batches + 24 * val_batches * evals
                + 12 * blind_batches,
                "fused_attention_bwd": 24 * train_batches}

    return train_batches, val_batches, blind_batches, expected


def phase_train_eval_cli(d: dict, work: str) -> dict:
    """The thesis protocol through ``train.main.main`` on the card: ViT-B-16
    at full width and depth, fp32 compute (``--precision amp``) through the
    split-TF32 fused kernels, on mini-Flickr (``phase_data``), with CSV data and
    the DINO join, pre-train and per-epoch evaluation, checkpoints and the
    CLIP-blind check on both splits; one epoch, then ``--resume latest
    --epochs 2``. Checks every artifact, the resumed step, and the fused
    launches against the loaders' batch counts (48 a train step, 24 an eval
    batch, 12 a CLIP-blind batch); by the profiler, that an eval call runs
    the split-TF32 forward; then the train loader's rate alone and the step's
    alone. Returns the launches of both runs."""
    import math

    import torch

    from refining_clip_via_dinov2_representations_torch.models import create_model, get_tokenizer
    from refining_clip_via_dinov2_representations_torch.train.data import (
        get_csv_dataset, load_dino_index_map,
    )
    from refining_clip_via_dinov2_representations_torch.train.evaluate import evaluate
    from refining_clip_via_dinov2_representations_torch.train.main import build_transforms
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args
    from refining_clip_via_dinov2_representations_torch.transform import image_transform_v2

    argv = _thesis_argv(d, work, "run")
    args = parse_args(argv)
    train_batches, val_batches, blind_batches, expected = _thesis_launches(args)

    run = os.path.join(work, "run")
    launches = {"fused_attention_fwd": 0, "fused_attention_bwd": 0}
    rates = {}  # run 1's train samples/s and the loader's alone, for phase 9b
    first, counts1, wall1, sec1 = _eval_cli_run(argv + ["--epochs", "1"])
    saved_step = torch.load(os.path.join(run, "checkpoints", "epoch_1.pt"),
                            map_location="cpu", weights_only=True, mmap=True)["step"]
    second, counts2, wall2, sec2 = _eval_cli_run(argv + ["--epochs", "2", "--resume",
                                                         "latest"])
    resumed = second[len(first):]
    for label, counts, want, wall, sec, steps in (
            ("run 1 (--epochs 1)", counts1, expected(2), wall1, sec1, len(first)),
            ("run 2 (--resume latest --epochs 2)", counts2, expected(1), wall2, sec2,
             len(resumed))):
        train_s = sec.get("train_one_epoch", float("nan"))
        print(f"train-eval-cli {label}: {EVAL_MODEL} fp32 batch {EVAL_BATCH}: wall "
              f"{wall:.2f} s; train {train_s:.2f} s for {steps} steps "
              f"({steps * EVAL_BATCH / train_s:.1f} samples/s, data loading included); "
              f"evaluate {sec.get('evaluate', 0.0):.2f} s; CLIP-blind "
              f"{sec.get('run_clip_blind_on_split', 0.0):.2f} s [{CARD}]", flush=True)
        print(f"train-eval-cli {label}: launches {counts}, expected {want} ({train_batches} "
              f"train steps x 48, {val_batches} eval batches x 24 per evaluation, "
              f"{blind_batches} CLIP-blind batches x 12)", flush=True)
        check(counts == want, f"train-eval-cli {label} launched {counts}, expected {want}")
        for k in launches:
            launches[k] += counts[k]
        rates.setdefault("train_samples_s", steps * EVAL_BATCH / train_s)

    with open(os.path.join(run, "loss_steps.json")) as f:
        records = json.load(f)
    print(f"train-eval-cli: loss_steps.json {len(records)} records, steps "
          f"{records[0]['step']}..{records[-1]['step']}; the resumed run's first step "
          f"{resumed[0]['step'] if resumed else None} after the saved step {saved_step}",
          flush=True)
    check([r["step"] for r in records] == list(range(1, 2 * train_batches + 1))
          and all(math.isfinite(r["total_loss"]) for r in records),
          "loss_steps.json is not one finite record per step of both runs")
    check(records == second, "loss_steps.json differs from the records main returned")
    check(saved_step == train_batches and resumed and resumed[0]["step"] == saved_step + 1,
          "the resumed run did not continue at the saved step")
    with open(os.path.join(run, "final_itm_results.json")) as f:
        results = json.load(f)
    check([e["epoch"] for e in results] == [0, 1, 2],
          f"final_itm_results.json epochs {[e['epoch'] for e in results]}")
    keys = [f"{d}_R@{k}" for d in ("text_to_image", "image_to_text") for k in (1, 5, 10)]
    for e in results:
        m = {r["val_name"]: r["metrics"] for r in e["results"]}.get("val", {})
        print(f"train-eval-cli: epoch {e['epoch']} val "
              f"{ {k: m.get(k) for k in keys + ['clip_val_loss', 'modality_gap']} }",
              flush=True)
        check(all(isinstance(m.get(k), float) and math.isfinite(m[k])
                  for k in keys + ["clip_val_loss"]), f"epoch {e['epoch']}: {m}")
    with open(os.path.join(run, "best_metrics.json")) as f:
        best = json.load(f)
    print(f"train-eval-cli: best epoch {best['epoch']}, retrieval score "
          f"{best['score']:.4f}", flush=True)
    check(best["epoch"] in (1, 2), f"best_metrics.json names epoch {best['epoch']}")
    check(os.path.isfile(os.path.join(run, "itm_scores.csv")), "no itm_scores.csv")
    for split in ("val", "train"):
        path = os.path.join(run, "clip_blind", f"clip_blind_{split}.json")
        check(os.path.isfile(path), f"no {path}")
        with open(path) as f:
            stats = json.load(f)
        rel = {k: round(v["relative_percent"], 4) for k, v in stats["results"].items()}
        print(f"train-eval-cli: clip_blind_{split}.json: {stats['total_pairs']} pairs, "
              f"relative % {rel}", flush=True)
        check(len(stats["results"]) == 3, f"clip_blind_{split}.json thresholds")

    # ---- the fp32 route of one eval call, by the profiler ----
    model, pp = create_model(EVAL_MODEL, os.path.join(run, "checkpoints", "epoch_2.pt"),
                             precision="amp", device=DEVICE)
    info = get_csv_dataset(args, image_transform_v2(pp), False,
                           tokenizer=get_tokenizer(EVAL_MODEL))
    check_fp32_route(lambda: evaluate(model, {"val": info}, 2, args), ("fwd",),
                     "one eval call")
    del model
    # ---- the train loader alone, on the host: the rate the CLI's
    # samples/s would reach if the steps cost nothing ----
    loader = get_csv_dataset(args, build_transforms(args, pp)[0], True,
                             tokenizer=get_tokenizer(EVAL_MODEL),
                             dino_index_map=load_dino_index_map(d["dino_index_map"])
                             ).dataloader
    t0 = time.perf_counter()
    n = sum(len(b["images"]) for b in loader)
    host_s = time.perf_counter() - t0
    print(f"train-eval-cli: the train loader alone ({args.workers} threads: PNG decode, "
          f"random resized crop, tokenizer, DINO rows): {n} samples in {host_s:.2f} s, "
          f"{n / host_s:.1f} samples/s (host clock) [{CARD}]", flush=True)
    rates["loader_samples_s"] = n / host_s
    # ---- and the fp32 step alone at the CLI's batch, on one cached batch ----
    _, _, state, train_step, _ = _dino_setup("fp32", "auto", model_name=EVAL_MODEL)
    batch = _train_batch(get_tokenizer(EVAL_MODEL), EVAL_BATCH, DEVICE, model_name=EVAL_MODEL)
    step_ms = host_step_ms(lambda: train_step(state, batch))
    print(f"train-eval-cli: the fp32 DINO-soft step alone at batch {EVAL_BATCH} on one "
          f"cached batch: {step_ms:.3f} ms host clock ({EVAL_BATCH / step_ms * 1e3:.1f} "
          f"samples/s) [{CARD}]", flush=True)
    del state, train_step
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return {**launches, "rates": rates}


def _jpeg_mini_flickr(work: str) -> str:
    """mini-Flickr redrawn at 500 px, each image cut to ``PP_JPEG_SIZE``
    (Flickr30k's 500 x 333) and saved as a JPEG; returns its train CSV
    (five captions an image, as mini-Flickr's)."""
    import csv

    from PIL import Image

    from scripts.mini_flickr import generate

    d = generate(os.path.join(work, "data500"), n_train=EVAL_TRAIN_IMAGES, n_val=1,
                 size_px=max(PP_JPEG_SIZE), dino_dim=8, seed=SEED + 3)
    jpg_dir = os.path.join(work, "jpeg500")
    os.makedirs(jpg_dir, exist_ok=True)
    with open(d["train_csv"], newline="") as f:
        rows = list(csv.reader(f))
    out, done = [rows[0]], {}
    for path, *rest in rows[1:]:
        if path not in done:
            done[path] = os.path.join(jpg_dir, os.path.basename(path)[:-4] + ".jpg")
            with Image.open(path) as img:
                img.convert("RGB").resize(PP_JPEG_SIZE, Image.BICUBIC).save(done[path],
                                                                            quality=90)
        out.append([done[path], *rest])
    csv_path = os.path.join(work, "jpeg500_train.csv")
    with open(csv_path, "w", newline="") as f:
        csv.writer(f).writerows(out)
    return csv_path


def _loader_rate(args, transform, tokenizer, dino_map=None) -> tuple:
    """(samples, seconds, dtype and shape of a batch's images) of one pass
    of the CSV train loader of ``args`` over ``transform``, on the host."""
    from refining_clip_via_dinov2_representations_torch.train.data import get_csv_dataset

    loader = get_csv_dataset(args, transform, True, tokenizer=tokenizer,
                             dino_index_map=dino_map).dataloader
    t0 = time.perf_counter()
    n, kind = 0, None
    for batch in loader:
        n += len(batch["images"])
        kind = kind or (str(batch["images"].dtype), tuple(batch["images"].shape))
    return n, time.perf_counter() - t0, kind


def phase_preprocess(d: dict, work: str, eval_cli: dict) -> dict:
    """Phase 9b, ``--device-preprocess`` on the card (the module docstring):
    (a) the resampler against float64, (b) the thesis CLI with the flag,
    (c) the decoders and the BPE cores. Returns the CLI run's launches and
    the numbers."""
    from unittest import mock

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch import native as host
    from refining_clip_via_dinov2_representations_torch.constants import (
        OPENAI_DATASET_MEAN, OPENAI_DATASET_STD,
    )
    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
    from refining_clip_via_dinov2_representations_torch.ops import preprocess
    from refining_clip_via_dinov2_representations_torch.tokenizer import SimpleTokenizer
    from refining_clip_via_dinov2_representations_torch.train.data import load_dino_index_map
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args
    from refining_clip_via_dinov2_representations_torch.transform import raw_uint8_transform

    t_phase = time.perf_counter()
    out = {}
    # ---- (a) the resampler on the card against the CPU's float64 ----
    mean, std = OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
    u8 = torch.from_numpy(np.random.default_rng(SEED + 90).integers(
        0, 256, (PP_BATCH, PP_RAW, PP_RAW, 3), dtype=np.uint8)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 91)
    boxes = preprocess.sample_crop_boxes(gen, PP_BATCH, PP_RAW, PP_RAW)
    got = preprocess.preprocess_train_batch(None, u8, (224, 224), mean, std, boxes=boxes)
    x64 = u8.cpu().double() / 255.0
    want = preprocess.normalize_images(preprocess.resized_crop(x64, boxes.cpu().double(),
                                                               (224, 224)),
                                       mean, std, dtype=torch.float64)
    err = float((got.cpu().double() - want).abs().max())
    ms = time_ms(lambda: preprocess.preprocess_train_batch(gen, u8, (224, 224), mean, std),
                 iters=20)
    nbytes = u8.numel() + got.numel() * 4
    print(f"preprocess (a) preprocess_train_batch [{PP_BATCH},{PP_RAW},{PP_RAW},3] uint8 -> "
          f"{tuple(got.shape)} {got.dtype} on the card: max abs {err:.3e} against the CPU "
          f"float64 of the same boxes (tol {PP_TOL:g}); {ms:.4f} ms a batch (CUDA events, the "
          f"box draw included; its bytes alone {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms at "
          f"HBM rate) [{CARD}]", flush=True)
    check(err <= PP_TOL and bool(torch.isfinite(got).all()),
          f"preprocess_train_batch on the card disagrees with float64: {err:.3e}")
    out.update(preprocess_ms=ms, preprocess_err=err)
    del u8, got, x64, want

    # ---- (b) the thesis CLI with --device-preprocess, one epoch ----
    argv = _thesis_argv(d, work, "dp_run") + ["--device-preprocess", "--epochs", "1"]
    args = parse_args(argv)
    train_batches, val_batches, blind_batches, expected = _thesis_launches(args)
    records, counts, wall, sec = _eval_cli_run(argv)
    steps = len(records)
    losses = [r["total_loss"] for r in records]
    train_s = sec.get("train_one_epoch", float("nan"))
    rate = steps * EVAL_BATCH / train_s
    host_rate = eval_cli["rates"]["train_samples_s"]
    print(f"preprocess (b) the thesis CLI with --device-preprocess ({EVAL_MODEL} fp32 batch "
          f"{EVAL_BATCH}, uint8 at {args.device_preprocess_raw_size} px): wall {wall:.2f} s; "
          f"train {train_s:.2f} s for {steps} steps, {rate:.1f} samples/s with loading, "
          f"against {host_rate:.1f} on the host path (train-eval-cli run 1, this run); "
          f"evaluate {sec.get('evaluate', 0.0):.2f} s; launches {counts}, expected "
          f"{expected(2)} [{CARD}]", flush=True)
    check(steps == train_batches and all(math.isfinite(x) for x in losses),
          f"the --device-preprocess run's losses: {losses}")
    check(counts == expected(2), f"the --device-preprocess run launched {counts}")
    tokenizer = get_tokenizer(EVAL_MODEL)
    dino_map = load_dino_index_map(d["dino_index_map"])
    n, secs, kind = _loader_rate(args, raw_uint8_transform(args.device_preprocess_raw_size),
                                 tokenizer, dino_map)
    loader_host = eval_cli["rates"]["loader_samples_s"]
    print(f"preprocess (b) the uint8 train loader alone ({args.workers} threads, batches "
          f"{kind}): {n} samples in {secs:.2f} s, {n / secs:.1f} samples/s, against the PIL "
          f"loader's {loader_host:.1f} (train-eval-cli, this run; host clock) [{CARD}]",
          flush=True)
    check(kind is not None and kind[0] == "uint8", f"the raw loader's batches: {kind}")
    out.update(cli_samples_s=rate, host_cli_samples_s=host_rate, loader_samples_s=n / secs,
               host_loader_samples_s=loader_host)

    # ---- (c) the decoders on 500 x 333 JPEGs, and the BPE cores ----
    decoder = host.jpeg_decoder()
    rates = {}
    if decoder == "PIL":  # no libjpeg headers: both passes would time PIL
        print(f"preprocess (c) JPEG decoder that ran: PIL (the native decoder did not build: "
              f"no libjpeg headers here); the native-against-PIL loader comparison skipped "
              f"[{CARD}]", flush=True)
    else:
        jpeg_args = parse_args(argv[:2] + ["--train-data", _jpeg_mini_flickr(work)] + argv[4:]
                               + ["--device-preprocess"])
        native_t = raw_uint8_transform(PP_RAW)
        pil_t = raw_uint8_transform(PP_RAW)
        pil_t.decode_min_dim = None  # PIL at full size, then the same resize and crop
        for what, t in (("native", native_t), ("PIL", pil_t), ("native again", native_t)):
            n, secs, kind = _loader_rate(jpeg_args, t, tokenizer)
            rates[what] = n / secs
        print(f"preprocess (c) JPEG decoder that ran: native; the raw loader over {n} rows of "
              f"{PP_JPEG_SIZE[0]}x{PP_JPEG_SIZE[1]} JPEGs ({jpeg_args.workers} threads, decode, "
              f"resize to {PP_RAW}, crop, tokenizer): the native DCT-scaled decode "
              f"{rates['native']:.1f} then {rates['native again']:.1f} images/s, PIL at full "
              f"size {rates['PIL']:.1f} images/s (host clock) [{CARD}]", flush=True)
    import csv

    with open(d["val_csv"], newline="") as f:
        captions = [r[1] for r in list(csv.reader(f))[1:]]
    bpe = {}
    with mock.patch.object(host, "load_native", lambda: None):  # the Python merge loop
        python_tok = SimpleTokenizer()
    native_tok = SimpleTokenizer()
    check(native_tok._native is not None and python_tok._native is None,
          "the tokenizers did not take the native and the Python BPE")
    for what, tok in (("native", native_tok), ("Python", python_tok)):
        t0 = time.perf_counter()
        ids = tok(captions)
        secs = time.perf_counter() - t0
        bpe[what] = (ids, int((ids != 0).sum()) / secs)
    same = bool(np.array_equal(bpe["native"][0], bpe["Python"][0]))
    print(f"preprocess (c) BPE on {len(captions)} val captions (cold memo): native core "
          f"{bpe['native'][1]:.0f} tokens/s, Python {bpe['Python'][1]:.0f} tokens/s; ids equal: "
          f"{same} [{CARD}]", flush=True)
    check(same, "the native BPE core's ids differ from the Python BPE's")
    out.update(decoder=decoder, jpeg_images_s=rates, bpe_tokens_s={k: v[1] for k, v in bpe.items()})
    out["seconds"] = time.perf_counter() - t_phase
    print(f"preprocess: phase {out['seconds']:.1f} s", flush=True)
    return {**counts, **out}


def _set_attn_impl(model, impl: str) -> None:
    """Every attention layer of ``model`` (CLIP or DINOv2) to ``impl``."""
    for m in model.modules():
        if hasattr(m, "attn_impl"):
            m.attn_impl = impl


def _teacher_pixels(n: int, size: int = 224, seed: int = SEED + 20):
    """Seeded ImageNet-normalised-like NCHW pixels on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, size, size, generator=g).to(DEVICE)


def _teacher_vs_plain(model, x, launches_expected: int, what: str, min_cos: float) -> int:
    """One ``model(x)`` through ``"auto"`` against ``"xla"`` on the same
    weights: the ``"auto"`` call's launches (``launches_expected`` fused
    forward, no backward, no flash), finite CLS features [B, hidden] and the
    worst CLS cosine. Returns the fused forward launches."""
    import torch

    _set_attn_impl(model, "auto")
    # ---- the main path: counts at 0 just before, read just after ----
    _zero_counts()
    with torch.no_grad():
        got = model(x).float()
    if DEVICE != "cpu":
        torch.cuda.synchronize()
    counts = _read_counts()
    _set_attn_impl(model, "xla")
    with torch.no_grad():
        want = model(x).float()
    _set_attn_impl(model, "auto")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    print(f"teacher {what}: features {tuple(got.shape)}, launches {counts} (expected fused "
          f"forward {launches_expected}, no backward); CLS cosine vs \"xla\" min {cos:.8f} "
          f"(need >= {min_cos})", flush=True)
    check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": launches_expected,
                     "fused_attention_bwd": 0}, f"teacher {what} launched {counts}")
    check(tuple(got.shape) == (x.shape[0], model.cfg.hidden_size)
          and bool(torch.isfinite(got).all()) and cos >= min_cos,
          f"teacher {what} disagrees with plain attention")
    return counts["fused_attention_fwd"]


def phase_teacher(work: str):
    """The DINOv2 teacher on the card: a seeded dinov2-small directory at the
    published config, loaded by ``load_dinov2_model``, fp32 and bf16 through
    the fused kernel against plain attention, with its time per batch; one
    fp32 forward of dinov2-large and dinov2-giant. Returns (teacher
    directory, fused forward launches of the ``"auto"`` calls)."""
    import dataclasses

    import torch

    from refining_clip_via_dinov2_representations_torch.models.dinov2 import (
        Dinov2, Dinov2Cfg, dinov2_cfg_from_name, load_dinov2_model, save_hf_checkpoint,
    )

    t0 = time.perf_counter()
    path = save_hf_checkpoint(Dinov2(Dinov2Cfg(**DINOV2_SMALL)).init_weights(SEED),
                              os.path.join(work, "dinov2-small-seeded"))
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    print(f"teacher: seeded dinov2-small written to {path} in {time.perf_counter() - t0:.2f} s "
          f"(hidden {cfg['hidden_size']}, {cfg['num_hidden_layers']} layers, "
          f"{cfg['num_attention_heads']} heads, patch {cfg['patch_size']}, image_size "
          f"{cfg['image_size']}, layerscale {cfg['layerscale_value']}, LN eps "
          f"{cfg['layer_norm_eps']})", flush=True)
    x = _teacher_pixels(TEACHER_BATCH)
    launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        model = load_dinov2_model(path, dtype=dtype, device=DEVICE, attn_impl="auto")
        check(model.embeddings.position_embeddings.shape[1] == 37 * 37 + 1,
              "dinov2-small's position table must hold 37 x 37 + 1 rows")
        launches += _teacher_vs_plain(model, x, 12, f"dinov2-small {name} batch "
                                      f"{TEACHER_BATCH} at 224 px", TEACHER_MIN_COS[name])
        ms = {}
        for impl in ("auto", "xla"):
            _set_attn_impl(model, impl)
            with torch.no_grad():
                ms[impl] = time_ms(lambda: model(x), iters=10)
        print(f"time teacher dinov2-small {name} batch {TEACHER_BATCH} at 224 px: "
              f"{ms['auto']:.3f} ms a batch through the fused kernel, {ms['xla']:.3f} ms "
              f"through plain attention (CUDA events) [{CARD}]", flush=True)
        del model
    for name in ("facebook/dinov2-large", "facebook/dinov2-giant"):
        cfg = dataclasses.replace(dinov2_cfg_from_name(name), native_image_size=518)
        model = Dinov2(cfg, attn_impl="auto").to(DEVICE).init_weights(SEED).eval()
        launches += _teacher_vs_plain(
            model, x[:TEACHER_BIG_BATCH], cfg.layers,
            f"{name.split('/')[-1]} float32 batch {TEACHER_BIG_BATCH} ({cfg.layers} x "
            f"{cfg.hidden_size}, {cfg.heads} heads, "
            f"{'SwiGLU' if cfg.use_swiglu_ffn else 'GELU'})", TEACHER_MIN_COS["float32"])
        del model
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    return path, launches


def phase_extract(d: dict, teacher: str, work: str):
    """The port's extractor (``eval/extract_dino_features.py``) on both
    mini-Flickr CSVs with the seeded teacher, fp32 on the card. Checks rows,
    the map, that ``DinoFeatureStore`` and ``CsvDataset`` accept them, and
    12 launches a batch of 64; returns ({split: (features, map)}, launches)."""
    import math

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.eval.extract_dino_features import (
        main as extract_main,
    )
    from refining_clip_via_dinov2_representations_torch.train.data import (
        CsvDataset, DinoFeatureStore, load_dino_index_map,
    )

    from refining_clip_via_dinov2_representations_torch.models import get_model_config

    # the live run's image size (224 for ViT-B-16), so the two see one crop
    size = get_model_config(EVAL_MODEL)["vision_cfg"]["image_size"]
    out, launches = {}, 0
    for split, csv, n in (("train", d["train_csv"], EVAL_TRAIN_IMAGES),
                          ("val", d["val_csv"], EVAL_VAL_IMAGES)):
        feats = os.path.join(work, f"extract_{split}.npy")
        index = os.path.join(work, f"extract_{split}.json")
        # ---- the main path: counts at 0 just before, read just after ----
        _zero_counts()
        t0 = time.perf_counter()
        extract_main(["--csv", csv, "--dino-model", teacher, "--image-size", str(size),
                      "--batch-size", "64", "--out-feats", feats, "--out-map", index]
                     + (["--force-cpu"] if DEVICE == "cpu" else []))
        if DEVICE != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        store, mapping = DinoFeatureStore(feats), load_dino_index_map(index)
        batches = math.ceil(n / 64)
        print(f"extract {split}: {store.shape} rows from {os.path.basename(csv)} in {wall:.2f} s "
              f"({n / wall:.1f} images/s, teacher load and PNG decode included), "
              f"{len(mapping)} map entries; launches {counts} (expected fused forward "
              f"{12 * batches}) [{CARD}]", flush=True)
        check(store.shape == (n, 384) and store.features.dtype == np.float32
              and bool(np.isfinite(store.features).all()), f"extract {split} rows {store.shape}")
        check(sorted(mapping.values()) == list(range(n)), f"extract {split}: the map")
        check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": 12 * batches,
                         "fused_attention_bwd": 0}, f"extract {split} launched {counts}")
        ds = CsvDataset(csv, lambda img: img, "filepath", "title", dino_index_map=mapping)
        check(len(ds) == 5 * n, f"CsvDataset read {len(ds)} rows of {csv}")
        out[split] = (np.asarray(store.features), mapping)
        launches += counts["fused_attention_fwd"]
    return out, launches


@contextlib.contextmanager
def _teacher_watch(record: list, captured: list):
    """Wraps ``LiveDinoTeacher.extract`` to record CUDA events around each
    call (``record``: (where, start, end), where "train" or "clip-blind")
    and ``clip_blind.encode_clip_and_dino_images`` to keep each pass's
    L2-normalised teacher rows and paths (``captured``, in call order)."""
    import torch

    from refining_clip_via_dinov2_representations_torch.eval import clip_blind
    from refining_clip_via_dinov2_representations_torch.train.dino_teacher import (
        LiveDinoTeacher,
    )

    extract, encode = LiveDinoTeacher.extract, clip_blind.encode_clip_and_dino_images
    where = ["train"]

    def timed(self, images):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = extract(self, images)
        end.record()
        record.append((where[0], start, end))
        return out

    def kept(model, teacher, loader, max_images=None):
        where[0] = "clip-blind"
        try:
            clip_z, dino_z, paths = encode(model, teacher, loader, max_images)
        finally:
            where[0] = "train"
        captured.append((dino_z, paths))
        return clip_z, dino_z, paths

    LiveDinoTeacher.extract, clip_blind.encode_clip_and_dino_images = timed, kept
    try:
        yield
    finally:
        LiveDinoTeacher.extract, clip_blind.encode_clip_and_dino_images = extract, encode


def phase_train_live_cli(d: dict, teacher: str, work: str, extracted: dict) -> dict:
    """The live-teacher protocol through ``train.main.main``: ViT-B-16 fp32
    (``--precision amp``), batch 32, one epoch on mini-Flickr with pre-train
    and epoch evaluation and ``--run_clip_blind``; the seeded dinov2-small
    from ``--dino_model_name``, no ``--dino_fts_path``. Checks the soft loss,
    both CLIP-blind files, the launches, a checkpoint without the teacher,
    and the live check's val teacher rows against the extracted ones; times
    the teacher; then the live step alone. Returns the launch counts."""
    import math

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
    from refining_clip_via_dinov2_representations_torch.train.data import (
        _clone_args, get_csv_dataset,
    )
    from refining_clip_via_dinov2_representations_torch.train.dino_teacher import (
        LiveDinoTeacher,
    )
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args

    argv = ["--model", EVAL_MODEL, "--train-data", d["train_csv"], "--val-data", d["val_csv"],
            "--dataset-type", "csv", "--batch-size", str(LIVE_BATCH), "--precision", "amp",
            "--lr", "5e-4", "--warmup", "2", "--wd", "0.1", "--workers", "8", "--seed",
            str(SEED), "--use_dino_general", "--lambda_soft", "0.5", "--soft_mode",
            "kl_teacher", "--lambda_weighted", "0.2", "--dino_model_name", teacher,
            "--run_clip_blind", "--clip_blind_val_key", "val", "--log-every-n-steps", "1",
            "--logs", work, "--name", "live", "--device", DEVICE, "--epochs", "1"]
    args = parse_args(argv)
    train_batches = get_csv_dataset(args, None, True).dataloader.num_batches
    val_batches = get_csv_dataset(args, None, False).dataloader.num_batches
    blind = get_csv_dataset(_clone_args(args, val_data=args.train_data), None, False).dataloader
    check(2 * args.clip_blind_max_images >= blind.num_samples,
          "the CLIP-blind cap would cut the train split")
    blind_batches = val_batches + blind.num_batches
    want = {"flash_attention_fwd": 0,
            "fused_attention_fwd": 36 * train_batches + 24 * val_batches * 2 + 24 * blind_batches,
            "fused_attention_bwd": 24 * train_batches}

    record, captured = [], []
    with _teacher_watch(record, captured):
        records, counts, wall, sec = _eval_cli_run(argv)
    if DEVICE != "cpu":
        torch.cuda.synchronize()
    teacher_s = {w: sum(s.elapsed_time(e) for x, s, e in record if x == w) / 1e3
                 for w in ("train", "clip-blind")}
    calls = {w: sum(x == w for x, _, _ in record) for w in ("train", "clip-blind")}
    run = os.path.join(work, "live")
    train_s = sec.get("train_one_epoch", float("nan"))
    soft = [r.get("soft_loss", 0.0) for r in records]
    print(f"train-live-cli: {EVAL_MODEL} fp32 batch {LIVE_BATCH}, live dinov2-small: wall "
          f"{wall:.2f} s; train {train_s:.2f} s for {len(records)} steps "
          f"({len(records) * LIVE_BATCH / train_s:.1f} samples/s, data loading included); "
          f"evaluate {sec.get('evaluate', 0.0):.2f} s; CLIP-blind "
          f"{sec.get('run_clip_blind_on_split', 0.0):.2f} s; teacher (CUDA events around "
          f"extract) {teacher_s['train']:.3f} s in {calls['train']} train calls, "
          f"{teacher_s['clip-blind']:.3f} s in {calls['clip-blind']} CLIP-blind calls "
          f"[{CARD}]", flush=True)
    print(f"train-live-cli: launches {counts}, expected {want} ({train_batches} train steps x "
          f"(36 forward + 24 backward), {val_batches} eval batches x 24 in 2 evaluations, "
          f"{blind_batches} CLIP-blind batches x 24); soft_loss {soft[0]:.6f} .. "
          f"{soft[-1]:.6f}", flush=True)
    check(len(records) == train_batches and all(math.isfinite(r["total_loss"]) for r in records),
          "train-live-cli: not one finite record per step")
    check(all(x > 0 for x in soft), f"train-live-cli: soft_loss {soft}")
    check(counts == want, f"train-live-cli launched {counts}, expected {want}")
    check(calls == {"train": train_batches, "clip-blind": blind_batches},
          f"teacher calls {calls}")
    for split in ("val", "train"):
        path = os.path.join(run, "clip_blind", f"clip_blind_{split}.json")
        check(os.path.isfile(path), f"no {path}")
        with open(path) as f:
            stats = json.load(f)
        rel = {k: round(v["relative_percent"], 4) for k, v in stats["results"].items()}
        print(f"train-live-cli: clip_blind_{split}.json: {stats['total_pairs']} pairs, "
              f"relative % {rel}", flush=True)
        check(len(stats["results"]) == 3, f"clip_blind_{split}.json thresholds")
    saved = torch.load(os.path.join(run, "checkpoints", "epoch_1.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    check(not any(k.startswith(("embeddings.", "encoder.")) for k in saved["state_dict"])
          and saved["dino_head"]["fc2.weight"].shape[0] == 384,
          "the checkpoint holds teacher weights or a head of the wrong width")
    del saved

    # the live check's val teacher rows against the extractor's, same images
    check(len(captured) == 2, f"captured {len(captured)} CLIP-blind passes")
    live_z, live_paths = captured[0]
    feats, mapping = extracted["val"]
    ext = feats[[mapping[p] for p in live_paths]].astype(np.float64)
    ext /= np.linalg.norm(ext, axis=-1, keepdims=True)
    cos = (ext * live_z.astype(np.float64)).sum(-1)
    print(f"train-live-cli: extracted vs live teacher rows of {len(live_paths)} val images "
          f"(same paths): cosine min {cos.min():.8f} (need >= 0.9999)", flush=True)
    check(len(live_paths) == 5 * EVAL_VAL_IMAGES and cos.min() >= 0.9999,
          "extracted and live teacher rows disagree")

    # ---- the live fp32 step alone at batch 32 on one cached batch, beside
    # the step on cached teacher features and the teacher alone ----
    live_teacher = LiveDinoTeacher.from_pretrained(teacher, device=DEVICE)
    batch = _train_batch(get_tokenizer(EVAL_MODEL), LIVE_BATCH, DEVICE, model_name=EVAL_MODEL)
    times = {}
    for label, tch in (("live teacher", live_teacher), ("cached features", None)):
        _, _, state, train_step, _ = _dino_setup("fp32", "auto", model_name=EVAL_MODEL,
                                                 dino_teacher=tch)
        b = {k: v for k, v in batch.items() if tch is None or k != "dino_features"}
        times[label] = host_step_ms(lambda: train_step(state, b))
        del state, train_step
    alone = time_ms(lambda: live_teacher.extract(batch["images"]), iters=10)
    print(f"train-live-cli: the fp32 DINO-soft step alone at batch {LIVE_BATCH} on one cached "
          f"batch: {times['live teacher']:.3f} ms host clock with the live teacher "
          f"({LIVE_BATCH / times['live teacher'] * 1e3:.1f} samples/s), "
          f"{times['cached features']:.3f} ms on cached features; the teacher alone "
          f"{alone:.3f} ms (CUDA events), {alone / times['live teacher']:.1%} of the live step "
          f"[{CARD}]", flush=True)
    del live_teacher
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return counts


def _exactly(model, want: dict) -> bool:
    """Every tensor of ``model``'s state dict equals ``want``'s (on the CPU,
    reshaped to the model's shape, cast to its dtype)."""
    import torch

    return all(torch.equal(v.cpu(), want[k].reshape(v.shape).to(v.dtype))
               for k, v in model.state_dict().items())


def _kernel_vs_plain(model, inputs: dict, what: str, min_cos: float = MIN_COSINE) -> dict:
    """``model``'s features of ``inputs`` ({"image": NHWC pixels, "text":
    ids} on the card) through its attention impl against ``"xla"``: the
    launches of the first pass and the worst cosine, checked."""
    import torch

    impl = next(m.attn_impl for m in model.modules() if hasattr(m, "attn_impl"))
    fns = {"image": model.encode_image, "text": model.encode_text}
    # ---- the main path: counts at 0 just before, read just after ----
    _zero_counts()
    with torch.no_grad():
        got = {k: fns[k](x, normalize=True).float() for k, x in inputs.items()}
    if DEVICE != "cpu":
        torch.cuda.synchronize()
    counts = _read_counts()
    _set_attn_impl(model, "xla")
    with torch.no_grad():
        want = {k: fns[k](x, normalize=True).float() for k, x in inputs.items()}
    _set_attn_impl(model, impl)
    cos = {k: torch.nn.functional.cosine_similarity(got[k].double(), want[k].double(),
                                                    dim=-1).min().item() for k in inputs}
    shapes = {k: tuple(v.shape) for k, v in got.items()}
    print(f"pretrained {what}: features {shapes} through {impl!r}, launches {counts}; cosine "
          f"vs plain attention min {cos} (need >= {min_cos})", flush=True)
    check(all(bool(torch.isfinite(v).all()) for v in got.values())
          and min(cos.values()) >= min_cos, f"pretrained {what} disagrees with plain attention")
    return counts


def phase_pretrained(work: str) -> dict:
    """Pretrained checkpoints at ViT-B-16's full width (phase 13): the
    seeded weights written in the hub-cache layout of the ``openai`` tag
    and as an fp16 OpenAI TorchScript archive, loaded three ways and checked
    exactly; the archive's features through the kernel against plain
    attention; the 224-px checkpoint at 384 px through the fused kernel and
    through flash. Returns the cache, the archive and the launches."""
    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.models.openai import (
        load_openai_model, save_openai_archive,
    )
    from refining_clip_via_dinov2_representations_torch.models.pretrained import (
        get_pretrained_cfg,
    )

    t0 = time.perf_counter()
    src, _ = create_model(EVAL_MODEL, device=DEVICE, seed=SEED + 30)
    sd = {k: v.detach().cpu() for k, v in src.state_dict().items()}
    del src
    hub_id = get_pretrained_cfg(EVAL_MODEL, "openai")["hf_hub"].rstrip("/")
    cache = os.path.join(work, "hub")
    repo = os.path.join(cache, "models--" + hub_id.replace("/", "--"))
    snap = os.path.join(repo, "snapshots", HUB_REV)
    os.makedirs(os.path.join(repo, "refs"))
    os.makedirs(snap)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(HUB_REV)
    torch.save(sd, os.path.join(snap, "open_clip_pytorch_model.bin"))
    archive = save_openai_archive(sd, os.path.join(work, f"{EVAL_MODEL}-openai-seeded.pt"))
    print(f"pretrained: seeded {EVAL_MODEL} written in {time.perf_counter() - t0:.2f} s: "
          f"{os.path.getsize(os.path.join(snap, 'open_clip_pytorch_model.bin')) / 2**20:.1f} MiB "
          f"open_clip layout in the hub cache of {hub_id}, {os.path.getsize(archive) / 2**20:.1f}"
          f" MiB fp16 TorchScript archive", flush=True)
    half = {k: v.half() if v.is_floating_point() else v for k, v in sd.items()}

    t0 = time.perf_counter()
    tagged, pp = create_model(EVAL_MODEL, pretrained="openai", cache_dir=cache, device=DEVICE)
    tag_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    openai = load_openai_model(archive, device=DEVICE)
    archive_s = time.perf_counter() - t0
    by_path, _ = create_model(EVAL_MODEL, pretrained=archive, device=DEVICE)
    exact = {"pretrained='openai' (hub cache)": _exactly(tagged, sd),
             "load_openai_model(archive)": _exactly(openai, half),
             "pretrained=<archive> (--pretrained)": _exactly(by_path, half)}
    act = openai.visual.transformer.resblocks[0].mlp.act.__name__
    print(f"pretrained: loads {tag_s:.2f} s from the hub cache, {archive_s:.2f} s from the "
          f"archive; the written values exactly: {exact}; load_openai_model's activation "
          f"{act}; the tag's preprocess: mean {pp.mean}, interpolation {pp.interpolation}, "
          f"resize {pp.resize_mode}", flush=True)
    check(all(exact.values()), f"pretrained weights differ from the written ones: {exact}")
    check(act == "quick_gelu", "load_openai_model must build QuickGELU")
    del tagged, by_path

    rng = np.random.default_rng(SEED + 31)
    size = openai.visual.image_size[0]
    x = torch.from_numpy(rng.normal(size=(8, size, size, 3)).astype(np.float32)).to(DEVICE)
    ids = torch.from_numpy(get_tokenizer(EVAL_MODEL)(
        [f"a photo of pretrained item {i}" for i in range(8)])).long().to(DEVICE)
    launches = {"fused_attention_fwd": 0, "flash_attention_fwd": 0}
    counts = _kernel_vs_plain(openai, {"image": x, "text": ids}, "archive fp32 batch 8")
    check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": 24,
                     "fused_attention_bwd": 0}, f"the archive's towers launched {counts}")
    launches["fused_attention_fwd"] += counts["fused_attention_fwd"]
    del openai

    big, _ = create_model(EVAL_MODEL, pretrained="openai", cache_dir=cache, device=DEVICE,
                          force_image_size=384)
    pos = big.visual.positional_embedding
    tokens = (384 // big.visual.patch_size[0]) ** 2 + 1  # 577 at patch 16
    check(tuple(pos.shape) == (tokens, sd["visual.positional_embedding"].shape[1])
          and torch.equal(pos[0].cpu(), sd["visual.positional_embedding"][0]),
          f"the 384-px table {tuple(pos.shape)} is not the resized {size}-px one")
    x384 = torch.from_numpy(rng.normal(size=(4, 384, 384, 3)).astype(np.float32)).to(DEVICE)
    heads = big.visual.transformer.resblocks[0].attn.num_heads
    for impl, kernel in (("auto", "fused_attention_fwd"), ("flash", "flash_attention_fwd")):
        _set_attn_impl(big, impl)
        counts = _kernel_vs_plain(big, {"image": x384},
                                  f"384 px [4,{heads},{tokens},64] {impl}")
        check(counts[kernel] == 12 and sum(counts.values()) == 12,
              f"the 384-px tower through {impl!r} launched {counts}")
        launches[kernel] += counts[kernel]
    # the tower under "flash" through its deployable artifact (phase 4b)
    counts, _, _ = _export_one_bucket(big, big.visual.image_size, big.context_length,
                                      os.path.join(work, "export_flash"), "384 px flash",
                                      "flash_attention_fwd", x384[:1].cpu().numpy())
    launches["flash_attention_fwd"] += counts["flash_attention_fwd"]
    del big
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return {"cache": cache, "archive": archive, "launches": launches}


def phase_int8(d: dict, pre: dict) -> dict:
    """Weight-only int8 serving at ViT-B-16's full width (phase 13b): the
    ``openai`` tag that phase 13 wrote into the hub cache, through
    ``create_engine(pretrained="openai", quantize="int8")`` and the HTTP
    server, beside the fp32 engine on the same tag: the resident bytes of
    the int8 tensors and of each whole model; the main path's launches (12
    a tower call: warm-up, image, text and a served similarity); the int8
    features through the kernel against plain attention on the same int8
    weights (cosine >= 0.9999) and against the fp32 engine's (>= 0.999, the
    JAX test's); each tower's time per call (CUDA events) and the request
    latency (host clock, p50 of 10) at buckets 1 and 8, int8 beside fp32.
    Returns the launches."""
    import base64

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import (
        create_engine, resident_bytes,
    )
    from refining_clip_via_dinov2_representations_torch.serve import (
        ClipServer, make_http_server,
    )

    t_phase = time.perf_counter()
    kw = dict(pretrained="openai", cache_dir=pre["cache"], buckets=INT8_BUCKETS, device=DEVICE)
    fp32, _, _ = create_engine(EVAL_MODEL, warm=False, **kw)
    # ---- the main path: counts at 0 just before, read just after ----
    _zero_counts()
    engine, preprocess, tokenizer = create_engine(EVAL_MODEL, quantize="int8", **kw)
    server = ClipServer(engine, preprocess, tokenizer)
    httpd = make_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    paths = sorted(os.listdir(d["img_dir"]))[:8]
    images_b64 = []
    for p in paths:
        with open(os.path.join(d["img_dir"], p), "rb") as f:
            images_b64.append(base64.b64encode(f.read()).decode())
    captions = [f"a photo of served item {i}" for i in range(8)]
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        pixels = server._decode_images(images_b64)
        ids = tokenizer(captions)
        img = engine.encode_image(pixels)
        txt = engine.encode_text(ids)
        status, body = _post(base, "/v1/similarity", {"images_b64": images_b64[:2],
                                                      "texts": captions[:2]})
        _sync()
        counts = _read_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    tower_calls = 2 * len(INT8_BUCKETS) + 2 + 2  # warm-up, image, text, the similarity
    want = {"flash_attention_fwd": 0, "fused_attention_fwd": 12 * tower_calls,
            "fused_attention_bwd": 0} if DEVICE == "cuda" else None
    scale, bias = engine.logit_terms()
    served = np.asarray(body.get("logits", []), np.float32)
    check(status == 200 and served.shape == (2, 2)
          and float(np.abs(served - (scale * img[:2] @ txt[:2].T + bias)).max()) < 1e-3,
          f"int8 /v1/similarity: {status} {str(body)[:200]}")
    check(health["quantize"] == "int8" and health["mesh"] is None, f"int8 /health {health}")
    check(want is None or counts == want, f"int8 serving launched {counts}, expected {want}")

    def plain_features(eng):
        _set_attn_impl(eng.model, "xla")
        try:
            return eng.encode_image(pixels), eng.encode_text(ids)
        finally:
            _set_attn_impl(eng.model, "auto")

    p_img, p_txt = plain_features(engine)
    f_img, f_txt = fp32.encode_image(pixels), fp32.encode_text(ids)
    vs_plain = min(_cosines(img, p_img).min(), _cosines(txt, p_txt).min())
    vs_fp32 = {"image": float(_cosines(img, f_img).min()),
               "text": float(_cosines(txt, f_txt).min())}
    sizes = {"int8": resident_bytes(engine.model), "fp32": resident_bytes(fp32.model)}
    n_q = sum(p.numel() for p in engine.model.parameters() if p.dtype == torch.int8)
    print(f"int8 {EVAL_MODEL} from the openai tag: {n_q:,} parameters stored as int8 "
          f"({sizes['int8']['int8'] / 2**20:.1f} MiB), the whole model resident "
          f"{sizes['int8']['total'] / 2**20:.1f} MiB against fp32 "
          f"{sizes['fp32']['total'] / 2**20:.1f} MiB; /health quantize {health['quantize']}; "
          f"launches {counts} over {tower_calls} tower calls; int8 features through the kernel vs "
          f"plain attention on the same int8 weights min cosine {vs_plain:.8f} (need >= "
          f"{MIN_COSINE}); int8 vs fp32 min cosine {vs_fp32} (need >= {INT8_MIN_COS}) [{CARD}]",
          flush=True)
    check(vs_plain >= MIN_COSINE, "the int8 engine's kernel disagrees with plain attention")
    check(min(vs_fp32.values()) >= INT8_MIN_COS, f"int8 vs fp32 cosine {vs_fp32}")
    check(sizes["int8"]["total"] < 0.5 * sizes["fp32"]["total"],
          f"int8 resident bytes {sizes}")

    rng = np.random.default_rng(SEED + 40)
    h, w = engine.image_size
    for b in INT8_BUCKETS:
        x = torch.from_numpy(rng.normal(size=(b, h, w, 3)).astype(np.float32)).to(DEVICE)
        t_ids = torch.from_numpy(tokenizer(captions[:1] * b)).long().to(DEVICE)
        row = {}
        for name, eng in (("int8", engine), ("fp32", fp32)):
            with torch.inference_mode():
                tower = (time_ms(lambda: eng.model.encode_image(x.to(eng.dtype)), iters=10),
                         time_ms(lambda: eng.model.encode_text(t_ids), iters=10))
            lat = []
            for fn, arg in ((eng.encode_image, x.cpu().numpy()),
                            (eng.encode_text, t_ids.cpu().numpy().astype(np.int32))):
                samples = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    fn(arg)
                    samples.append((time.perf_counter() - t0) * 1e3)
                lat.append(statistics.median(samples))
            row[name] = (tower, lat)
        print(f"int8 time bucket {b}: image tower {row['int8'][0][0]:.3f} ms per call (fp32 "
              f"{row['fp32'][0][0]:.3f}), text {row['int8'][0][1]:.3f} (fp32 "
              f"{row['fp32'][0][1]:.3f}); request latency p50 encode_image "
              f"{row['int8'][1][0]:.3f} ms (fp32 {row['fp32'][1][0]:.3f}), encode_text "
              f"{row['int8'][1][1]:.3f} (fp32 {row['fp32'][1][1]:.3f}) [{CARD}]", flush=True)
    # the int8 engine's deployable artifact at bucket 1 (phase 4b): the int8
    # values in the program, the int8 phase's tolerance against fp32
    n_vis = sum(p.numel() for n, p in engine.model.named_parameters()
                if n.startswith("visual.") and p.dtype == torch.int8)
    a_counts, tensors, got = _export_one_bucket(
        engine.model, engine.image_size, engine.context_length,
        os.path.join(os.path.dirname(pre["cache"]), "export_int8"), "int8",
        "fused_attention_fwd", pixels[:1])
    a_cos = float(_cosines(got, f_img[:1]).min())
    print(f"export int8: the image program holds {tensors.get('int8', 0):,} int8 values (the "
          f"vision tower's {n_vis:,}); against the fp32 engine min cosine {a_cos:.8f} (need >= "
          f"{INT8_MIN_COS})", flush=True)
    check(tensors.get("int8", 0) == n_vis > 0, "the int8 artifact does not hold the int8 values")
    check(a_cos >= INT8_MIN_COS, f"the int8 artifact against fp32: cosine {a_cos}")
    counts = {k: v + a_counts[k] for k, v in counts.items()}
    del engine, fp32
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    print(f"int8: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def phase_zero_shot(d: dict, pre: dict, work: str) -> dict:
    """Config 1 through ``train.main.main`` (phase 14): zero-shot Flickr
    retrieval and zero-shot ImageNet from ``--pretrained openai``, no train
    data, on a procedural ImageNet-V2-style folder. Checks the metrics and
    the launches (12 a text call of 10 classes x 80 templates, 12 an image
    batch, 24 a val batch); times the classifier; holds the first 10
    classes' classifier to plain attention's. Returns the launches and the
    val metrics."""
    import math

    import numpy as np
    import torch
    from PIL import Image

    from refining_clip_via_dinov2_representations_torch.eval._imagenet_metadata import (
        IMAGENET_CLASSNAMES, OPENAI_IMAGENET_TEMPLATES,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.train import zero_shot
    from refining_clip_via_dinov2_representations_torch.train.data import get_csv_dataset
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args

    folder = os.path.join(work, "imagenet-v2")
    rng = np.random.default_rng(SEED + 40)
    t0 = time.perf_counter()
    for c in range(ZS_IMAGES):
        os.makedirs(os.path.join(folder, str(c)))
        Image.fromarray(rng.integers(0, 255, (96, 96, 3), dtype=np.uint8)).save(
            os.path.join(folder, str(c), "0.png"))
    print(f"zero-shot: {ZS_IMAGES} class folders of one 96-px image each in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    argv = ["--model", EVAL_MODEL, "--pretrained", "openai", "--cache-dir", pre["cache"],
            "--val-data", d["val_csv"], "--dataset-type", "csv", "--imagenet-val", folder,
            "--batch-size", str(EVAL_BATCH), "--precision", "amp", "--workers", "8",
            "--seed", str(SEED), "--logs", work, "--name", "zero-shot", "--device", DEVICE]
    val_batches = get_csv_dataset(parse_args(argv), None, False).dataloader.num_batches
    text_calls = math.ceil(len(IMAGENET_CLASSNAMES) / ZS_CLASSES_PER_CALL)
    image_batches = math.ceil(ZS_IMAGES / EVAL_BATCH)
    want = {"flash_attention_fwd": 0, "fused_attention_bwd": 0,
            "fused_attention_fwd": 12 * (text_calls + image_batches) + 24 * val_batches}
    results, counts, wall, sec = _eval_cli_run(argv, timed=(
        (zero_shot, "build_zero_shot_classifier"), (zero_shot, "run")))
    (entry,) = results
    m = entry["metrics"]
    keys = [f"{k}_R@{r}" for k in ("text_to_image", "image_to_text") for r in (1, 5, 10)]
    zs = {k: m.get(k) for k in ("imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5")}
    print(f"zero-shot Config 1: {EVAL_MODEL} fp32 (--precision amp), eval only: wall "
          f"{wall:.2f} s; classifier {sec.get('build_zero_shot_classifier', 0.0):.2f} s "
          f"({len(IMAGENET_CLASSNAMES)} classes x {len(OPENAI_IMAGENET_TEMPLATES)} templates in "
          f"{text_calls} text calls, tokenizer included); ImageNet images "
          f"{sec.get('run', 0.0):.2f} s ({ZS_IMAGES} images, {image_batches} batches, decode "
          f"included); evaluate {sec.get('evaluate', 0.0):.2f} s [{CARD}]", flush=True)
    print(f"zero-shot Config 1: val retrieval { {k: m.get(k) for k in keys} }, clip_val_loss "
          f"{m.get('clip_val_loss')}; ImageNet {zs}; launches {counts}, expected {want}",
          flush=True)
    check(counts == want, f"zero-shot launched {counts}, expected {want}")
    check(all(isinstance(v, float) and 0.0 <= v <= 1.0 for v in zs.values())
          and all(math.isfinite(m.get(k, float("nan"))) for k in keys + ["clip_val_loss"]),
          f"zero-shot metrics {m}")

    model, _ = create_model(EVAL_MODEL, "openai", precision="amp", cache_dir=pre["cache"],
                            device=DEVICE)
    tok = get_tokenizer(EVAL_MODEL)
    first = IMAGENET_CLASSNAMES[:ZS_CLASSES_PER_CALL]
    got = zero_shot.build_zero_shot_classifier(model, tok, first, OPENAI_IMAGENET_TEMPLATES)
    _set_attn_impl(model, "xla")
    plain = zero_shot.build_zero_shot_classifier(model, tok, first, OPENAI_IMAGENET_TEMPLATES)
    cos = torch.nn.functional.cosine_similarity(got.double(), plain.double(), dim=0).min().item()
    print(f"zero-shot: the classifier of the first {len(first)} classes {tuple(got.shape)} "
          f"through the kernel vs plain attention: weight cosine min {cos:.8f} (need >= "
          f"{MIN_COSINE})", flush=True)
    check(cos >= MIN_COSINE, "the zero-shot classifier disagrees with plain attention")
    del model
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return {"counts": counts, "metrics": m}


def phase_finetune(d: dict, pre: dict, zs: dict, work: str) -> dict:
    """Config 2 (phase 15): the thesis flags with ``--pretrained openai`` for
    one epoch. Checks the launches, that the pre-train evaluation equals
    Config 1's retrieval on the same weights, every epoch's metrics; times
    the run and the fp32 step alone from the pretrained weights. Returns
    the launches and the checkpoint."""
    import math

    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args

    argv = _thesis_argv(d, work, "finetune") + ["--pretrained", "openai", "--cache-dir",
                                                pre["cache"], "--epochs", "1"]
    train_batches, _, _, expected = _thesis_launches(parse_args(argv))
    want = expected(2)
    records, counts, wall, sec = _eval_cli_run(argv)
    run = os.path.join(work, "finetune")
    train_s = sec.get("train_one_epoch", float("nan"))
    print(f"finetune Config 2: {EVAL_MODEL} from the pretrained weights, fp32 batch "
          f"{EVAL_BATCH}: wall {wall:.2f} s; train {train_s:.2f} s for {len(records)} steps "
          f"({len(records) * EVAL_BATCH / train_s:.1f} samples/s, data loading included); "
          f"evaluate {sec.get('evaluate', 0.0):.2f} s; CLIP-blind "
          f"{sec.get('run_clip_blind_on_split', 0.0):.2f} s; launches {counts}, expected "
          f"{want} [{CARD}]", flush=True)
    check(counts == want, f"finetune launched {counts}, expected {want}")
    check(len(records) == train_batches and all(math.isfinite(r["total_loss"]) for r in records),
          "finetune: not one finite record per step")
    with open(os.path.join(run, "final_itm_results.json")) as f:
        results = json.load(f)
    check([e["epoch"] for e in results] == [0, 1], f"finetune epochs {results}")
    keys = [f"{k}_R@{r}" for k in ("text_to_image", "image_to_text") for r in (1, 5, 10)]
    for e in results:
        m = {r["val_name"]: r["metrics"] for r in e["results"]}["val"]
        print(f"finetune: epoch {e['epoch']} val { {k: m.get(k) for k in keys} }, "
              f"clip_val_loss {m.get('clip_val_loss')}", flush=True)
        check(all(math.isfinite(m[k]) for k in keys + ["clip_val_loss"]), f"epoch {e}: {m}")
    m0 = {r["val_name"]: r["metrics"] for r in results[0]["results"]}["val"]
    same = all(m0[k] == zs["metrics"][k] for k in keys) and abs(
        m0["clip_val_loss"] - zs["metrics"]["clip_val_loss"]) <= 1e-5
    print(f"finetune: the pre-train evaluation equals Config 1's on the same weights: {same}",
          flush=True)
    check(same, "the fine-tune did not start from the pretrained weights")

    _, _, state, train_step, _ = _dino_setup("fp32", "auto", model_name=EVAL_MODEL,
                                             pretrained="openai", cache_dir=pre["cache"])
    batch = _train_batch(get_tokenizer(EVAL_MODEL), EVAL_BATCH, DEVICE, model_name=EVAL_MODEL)
    step_ms = host_step_ms(lambda: train_step(state, batch))
    print(f"finetune: the fp32 DINO-soft step alone from the pretrained weights at batch "
          f"{EVAL_BATCH} on one cached batch: {step_ms:.3f} ms host clock "
          f"({EVAL_BATCH / step_ms * 1e3:.1f} samples/s) [{CARD}]", flush=True)
    del state, train_step
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return {"counts": counts, "checkpoint": os.path.join(run, "checkpoints", "epoch_1.pt")}


def phase_offline(d: dict, pre: dict, ft: dict, work: str) -> dict:
    """The offline acceptance suite (phase 16): ``run_all_evals`` on both
    mini-Flickr CSVs from the fine-tune's checkpoint (bf16 extraction, 12
    launches a batch of 256 rows), ``clip_blinds_cli`` on the val CSV with
    mini-Flickr's DINO features and map (12 launches a batch of 128
    images); results and each stage's seconds; the extracted val features
    against plain attention's (cosine >= 0.999). Returns the launches."""
    import math

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.eval import (
        clip_blinds_cli, offline, run_all_evals,
    )
    from refining_clip_via_dinov2_representations_torch.eval._batching import (
        encode_images_padded,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, load_checkpoint,
    )
    from refining_clip_via_dinov2_representations_torch.train.data import _read_csv
    from refining_clip_via_dinov2_representations_torch.transform import image_transform_v2

    cpu = ["--force-cpu"] if DEVICE == "cpu" else []
    rows = {s: len(_read_csv(d[f"{s}_csv"], ",", ("filepath",))["filepath"])
            for s in ("train", "val")}
    out = os.path.join(work, "evals")
    sec: dict = {}
    with contextlib.ExitStack() as stack:
        for name in ("extract_features", "knn_top1", "eval_geometry", "linear_probe"):
            stack.enter_context(_timed(offline, name, sec))
        # ---- the main path: counts at 0 just before, read just after ----
        _zero_counts()
        t0 = time.perf_counter()
        results = run_all_evals.main(
            ["--train-csv", d["train_csv"], "--val-csv", d["val_csv"], "--model", EVAL_MODEL,
             "--pretrained", "openai", "--cache-dir", pre["cache"], "--checkpoint",
             ft["checkpoint"], "--out-dir", out, "--batch-size", str(EXTRACT_BATCH)] + cpu)
        if DEVICE != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
    want = {"flash_attention_fwd": 0, "fused_attention_bwd": 0,
            "fused_attention_fwd": 12 * sum(math.ceil(n / EXTRACT_BATCH) for n in rows.values())}
    print(f"offline run_all_evals: {EVAL_MODEL} bf16 from {os.path.basename(ft['checkpoint'])}: "
          f"{results}; wall {wall:.2f} s: extract {sec.get('extract_features', 0.0):.2f} s "
          f"({rows['train']} + {rows['val']} rows, model builds and decode included), kNN "
          f"{sec.get('knn_top1', 0.0):.3f} s, geometry {sec.get('eval_geometry', 0.0):.3f} s, "
          f"probe {sec.get('linear_probe', 0.0):.3f} s; launches {counts}, expected {want} "
          f"[{CARD}]", flush=True)
    check(counts == want, f"run_all_evals launched {counts}, expected {want}")
    check(set(results) == {"knn_top1", "linear_probe_top1", "uniformity", "pc1", "pc10",
                           "pc100"} and all(math.isfinite(v) for v in results.values()),
          f"all_evals.json {results}")
    with open(os.path.join(out, "all_evals.json")) as f:
        check(json.load(f) == results, "all_evals.json differs from the returned results")

    blind_out = os.path.join(work, "clip-blinds")
    images = len(dict.fromkeys(_read_csv(d["val_csv"], ",", ("filepath",))["filepath"]))
    _zero_counts()
    t0 = time.perf_counter()
    stats = clip_blinds_cli.main(
        ["--csv", d["val_csv"], "--model", EVAL_MODEL, "--pretrained", "openai", "--cache-dir",
         pre["cache"], "--checkpoint", ft["checkpoint"], "--dino-feats", d["dino_feats"],
         "--dino-index-map", d["dino_index_map"], "--out-dir", blind_out, "--save-pairs"] + cpu)
    if DEVICE != "cpu":
        torch.cuda.synchronize()
    blind_s = time.perf_counter() - t0
    blind_counts = _read_counts()
    blind_want = {"flash_attention_fwd": 0, "fused_attention_bwd": 0,
                  "fused_attention_fwd": 12 * math.ceil(images / 128)}
    print(f"offline clip_blinds_cli: {images} val images, {stats['total_pairs']} pairs, "
          f"{stats['results']} in {blind_s:.2f} s; launches {blind_counts}, expected "
          f"{blind_want} [{CARD}]", flush=True)
    check(blind_counts == blind_want, f"clip_blinds_cli launched {blind_counts}")
    check(stats["total_pairs"] == images * (images - 1) // 2
          and all(os.path.isfile(os.path.join(blind_out, f))
                  for f in ("summary.txt", "summary.json", "pairs.csv")),
          "clip_blinds_cli did not write its summaries")

    # the extracted val rows against plain attention's on the same weights
    model, pp = create_model(EVAL_MODEL, "openai", precision="bf16", force_quick_gelu=True,
                             cache_dir=pre["cache"], device=DEVICE, attn_impl="xla")
    load_checkpoint(model, ft["checkpoint"], strict=False)

    def encode(batch: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return model.encode_image(torch.from_numpy(batch).to(DEVICE),
                                      normalize=True).float().cpu().numpy()

    plain = encode_images_padded(encode, _read_csv(d["val_csv"], ",", ("filepath",))["filepath"],
                                 image_transform_v2(pp), EXTRACT_BATCH)
    got = offline.load_feats(os.path.join(out, "val_feats.npz"))[0].astype(np.float64)
    cos = (got * plain).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(plain, axis=-1))
    print(f"offline: extracted val features {got.shape} (bf16, kernel) vs plain attention: "
          f"cosine min {cos.min():.8f} (need >= {TEACHER_MIN_COS['bfloat16']})", flush=True)
    check(cos.min() >= TEACHER_MIN_COS["bfloat16"], "the extracted features disagree")
    del model
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return {"fused_attention_fwd": counts["fused_attention_fwd"]
            + blind_counts["fused_attention_fwd"]}


def _config2_argv(d: dict, cache: str, work: str, name: str) -> list:
    """Config 2's training flags exactly as ``docs/REPRODUCE.md:30-36``
    writes them, on mini-Flickr (its CSVs and precomputed DINO features in
    place of CC3M's and Flickr's), cut to ``CONFIG2_EPOCHS`` epochs, with
    the train crops fixed to the whole image (``--aug-cfg scale=(1.0,
    1.0)``) so that an interrupted and resumed run sees the uninterrupted
    run's pixels; the ``openai`` tag from the seeded hub cache."""
    return ["--model", EVAL_MODEL, "--pretrained", "openai", "--precision", "bf16",
            "--train-data", d["train_csv"], "--val-data", d["val_csv"], "--dataset-type", "csv",
            "--use_dino_general", "--soft_mode", "kl_teacher", "--lambda_soft", "0.5",
            "--teacher_temp", "0.15", "--use_projection", "--projection_type", "mlp",
            "--dino_fts_path", d["dino_feats"], "--dino_index_map_path", d["dino_index_map"],
            "--batch-size", str(CONFIG2_BATCH), "--epochs", str(CONFIG2_EPOCHS), "--warmup",
            "500", "--lr", "5e-4", "--report-to", "tensorboard", "--run_clip_blind",
            # the cuts and the run's place
            "--aug-cfg", "scale=(1.0, 1.0)", "--cache-dir", cache, "--seed", str(SEED),
            "--log-every-n-steps", "1", "--logs", work, "--name", name, "--device", DEVICE]


def _config2_expected(args, epochs: int, evals: int, steps: int = None) -> dict:
    """The fused launches of a Config 2 run: 48 a train step, 24 an eval
    batch, 12 a CLIP-blind batch of the train split (the published flags
    give the val split no features, so its check is skipped)."""
    train_batches, val_batches, blind_batches, _ = _thesis_launches(args)
    steps = train_batches * epochs if steps is None else steps
    return {"flash_attention_fwd": 0,
            "fused_attention_fwd": 24 * steps + 24 * val_batches * evals
            + 12 * (blind_batches - val_batches),
            "fused_attention_bwd": 24 * steps}


def _wait_for_line(path: str, needle: str, proc, timeout: float) -> bool:
    """Polls ``path`` until it holds ``needle``; False when ``proc`` ends or
    the time runs out first."""
    deadline = time.time() + timeout
    while time.time() < deadline and proc.poll() is None:
        if os.path.isfile(path):
            with open(path) as f:
                if needle in f.read():
                    return True
        time.sleep(0.05)
    return False


def phase_config2(d: dict, pre: dict, work: str) -> dict:
    """Config 2 as published (phase 17): ViT-B-16 from the ``openai`` tag at
    bf16, batch 96, the DINO-soft flags, ``--report-to tensorboard
    --run_clip_blind``, on mini-Flickr for ``CONFIG2_EPOCHS`` epochs through
    ``train.main.main``: launches, TensorBoard (or its one warning), every
    artifact, ``final_torch_state.pt`` served by the engine. Then the same
    flags with ``--save-on-preemption --async-checkpoint`` in a subprocess,
    sent SIGTERM once its ``out.log`` shows step ``PREEMPT_AT`` of epoch 1,
    and ``--resume latest`` in this process: the two runs' losses against
    the uninterrupted run's (``config2_preempted``, started beside the
    multi-GPU phases' processes, and ``phase_config2_resume`` after them).
    Then the blocking seconds of a synchronous and an asynchronous save of
    the run's state. Returns the launches, the run's records and its
    arguments."""
    import math

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
    from refining_clip_via_dinov2_representations_torch.train.checkpoint import (
        save_checkpoint, wait_for_checkpoints,
    )
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args

    print(f"config2: the cuts: mini-Flickr's {EVAL_TRAIN_IMAGES} train and {EVAL_VAL_IMAGES} "
          f"val images (5 captions each, {EVAL_SIZE_PX} px) in place of CC3M and Flickr30k, "
          f"{CONFIG2_EPOCHS} epochs in place of 10, train crops of the whole image "
          f"(--aug-cfg scale=(1.0, 1.0)), seeded weights under the openai tag", flush=True)
    argv = _config2_argv(d, pre["cache"], work, "config2")
    args = parse_args(argv)
    train_batches = _thesis_launches(args)[0]
    launches = {"fused_attention_fwd": 0, "fused_attention_bwd": 0}
    records, counts, wall, sec = _eval_cli_run(argv)
    want = _config2_expected(args, CONFIG2_EPOCHS, CONFIG2_EPOCHS + 1)
    run = os.path.join(work, "config2")
    train_s = sec.get("train_one_epoch", float("nan"))
    print(f"config2: {EVAL_MODEL} bf16 batch {CONFIG2_BATCH}, {len(records)} steps: wall "
          f"{wall:.2f} s; train {train_s:.2f} s ({len(records) * CONFIG2_BATCH / train_s:.1f} "
          f"samples/s, data loading included); evaluate {sec.get('evaluate', 0.0):.2f} s; "
          f"CLIP-blind {sec.get('run_clip_blind_on_split', 0.0):.2f} s; launches {counts}, "
          f"expected {want} [{CARD}]", flush=True)
    check(counts == want, f"config2 launched {counts}, expected {want}")
    check(len(records) == CONFIG2_EPOCHS * train_batches
          and all(math.isfinite(r["total_loss"]) for r in records),
          "config2: not one finite record per step")
    for k in launches:
        launches[k] += counts[k]
    tb = os.path.join(run, "tensorboard")
    events = sorted(f for f in os.listdir(tb) if f.startswith("events.")) if os.path.isdir(
        tb) else []
    with open(os.path.join(run, "out.log")) as f:
        log = f.read()
    warned = log.count("tensorboard logging unavailable")
    # the plots are drawn where matplotlib imports, else a warning
    plots = importlib.util.find_spec("matplotlib") is not None
    print(f"config2: --report-to tensorboard: {len(events)} event files written, "
          f"{warned} warnings that tensorboard is missing; matplotlib "
          f"{'imports' if plots else 'missing'}, loss_curves.png "
          f"{os.path.isfile(os.path.join(run, 'loss_curves.png'))}", flush=True)
    check(bool(events) ^ (warned == 1), "config2: not either TensorBoard events or its one "
                                        "warning")
    check(plots or "loss plotting failed" in log, "config2: no loss plot and no warning")
    arts = ["loss_steps.json", "final_itm_results.json", "best_metrics.json",
            "itm_scores.csv", "params.txt", os.path.join("clip_blind", "clip_blind_train.json"),
            os.path.join("checkpoints", f"epoch_{CONFIG2_EPOCHS}.pt"),
            os.path.join("checkpoints", "final_torch_state.pt")]
    for art in arts + (["loss_curves.png"] if plots else []):
        check(os.path.isfile(os.path.join(run, art)), f"config2 wrote no {art}")
    final = os.path.join(run, "checkpoints", "final_torch_state.pt")
    engine, _, tokenizer = create_engine(EVAL_MODEL, checkpoint=final, buckets=(1,),
                                         device=DEVICE)
    feats = engine.encode_text(tokenizer(["a photo of a cat"]))
    norm = float(np.linalg.norm(feats))
    print(f"config2: final_torch_state.pt ({os.path.getsize(final) / 2**20:.1f} MiB) serves "
          f"encode_text {feats.shape}, norm {norm:.6f}", flush=True)
    check(feats.shape[0] == 1 and abs(norm - 1) < 1e-4, "final_torch_state.pt does not serve")
    del engine

    # ---- the blocking time of one save, synchronous and asynchronous ----
    _, _, state, train_step, _ = _dino_setup("bf16", "auto", model_name=EVAL_MODEL)
    batch = _train_batch(get_tokenizer(EVAL_MODEL), CONFIG2_BATCH, DEVICE,
                         model_name=EVAL_MODEL)
    state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    blocking = {}
    for mode in ("sync", "async"):
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(work, f"save_{mode}"), state, 1,
                               async_save=mode == "async")
        blocking[mode] = time.perf_counter() - t0
        wait_for_checkpoints()
        blocking[mode + " total"] = time.perf_counter() - t0
    print(f"config2: one save of the {EVAL_MODEL} state with AdamW ("
          f"{os.path.getsize(path) / 2**30:.3f} GiB): blocks the loop {blocking['sync']:.3f} s "
          f"synchronous, {blocking['async']:.3f} s asynchronous (the copy to host memory; the "
          f"write done {blocking['async total']:.3f} s after the call) [{CARD}]", flush=True)
    del state, train_step
    torch.cuda.empty_cache()
    return {"launches": launches, "records": records, "args": args,
            "train_batches": train_batches}


def config2_preempted(d: dict, pre: dict, work: str, train_batches: int,
                      threads: int) -> dict:
    """Config 2's flags with ``--save-on-preemption --async-checkpoint`` in a
    subprocess (``threads`` OpenMP threads), sent SIGTERM once its
    ``out.log`` shows step ``PREEMPT_AT`` of epoch 1 (an epoch is
    ``train_batches`` steps): whether the line came, the exit code and the
    seconds."""
    import signal

    pre_argv = _config2_argv(d, pre["cache"], work, "preempted") + [
        "--save-on-preemption", "--async-checkpoint"]
    log = os.path.join(work, "preempted", "out.log")
    needle = f"Train Epoch: 1 [{train_batches + PREEMPT_AT}]"
    env = {**os.environ, "OMP_NUM_THREADS": str(threads)}
    with open(os.path.join(work, "preempted.stdout"), "w") as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m",
                                 "refining_clip_via_dinov2_representations_torch.train.main",
                                 *pre_argv], stdout=out, stderr=subprocess.STDOUT, env=env,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            seen = _wait_for_line(log, needle, proc, timeout=600)
            if seen:
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"argv": pre_argv, "needle": needle, "seen": seen, "rc": rc,
            "seconds": time.perf_counter() - t0}


def phase_config2_resume(work: str, c2: dict, run: dict) -> None:
    """Config 2's preempted run (``config2_preempted``'s ``run``) checked,
    then ``--resume latest`` in this process: the preemption save's
    position, the launches, and both runs' losses against the
    uninterrupted run's (``c2``, ``phase_config2``'s; the resumed launches
    are added to its)."""
    import torch

    records, args, train_batches = c2["records"], c2["args"], c2["train_batches"]
    launches = c2["launches"]
    log = os.path.join(work, "preempted", "out.log")
    with open(log) as f:
        tail = f.read()
    seen, rc, needle = run["seen"], run["rc"], run["needle"]
    check(seen and rc == 0, f"the preempted run: line seen {seen}, rc {rc}; "
                            f"its log ends {tail[-2000:]}")
    saved = torch.load(os.path.join(work, "preempted", "checkpoints", "epoch_1_preempt.pt"),
                       map_location="cpu", weights_only=True, mmap=True)
    at, step = saved["step_in_epoch"], saved["step"]
    del saved
    with open(os.path.join(work, "preempted", "final_itm_results.json")) as f:
        first_epochs = [e["epoch"] for e in json.load(f)]
    print(f"config2: the subprocess with --save-on-preemption --async-checkpoint: SIGTERM "
          f"after '{needle}', exit code {rc} after {run['seconds']:.2f} s (beside the "
          f"multi-GPU phases' processes); epoch_1_preempt.pt at optimizer step {step}, {at} "
          f"steps into epoch 1; evaluations {first_epochs} [{CARD}]", flush=True)
    check(at >= PREEMPT_AT and step == train_batches + at and first_epochs == [0, 1],
          "the preemption save is not at its step, or evaluated the stopped epoch")
    resumed, rcounts, rwall, _ = _eval_cli_run(run["argv"] + ["--resume", "latest"])
    rwant = _config2_expected(args, 1, 1, steps=train_batches - at)
    print(f"config2: --resume latest: wall {rwall:.2f} s, launches {rcounts}, expected "
          f"{rwant} [{CARD}]", flush=True)
    check(rcounts == rwant, f"the resumed run launched {rcounts}, expected {rwant}")
    for k in launches:
        launches[k] += rcounts[k]
    check([r["step"] for r in resumed] == [r["step"] for r in records],
          "the two runs' records do not cover the uninterrupted run's steps")
    rel = max(abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
              for a, b in zip(resumed, records))
    same = sum(a["total_loss"] == b["total_loss"] for a, b in zip(resumed, records))
    tol = STEP_TOL["bfloat16"][0]
    print(f"config2: preempted + resumed vs uninterrupted, {len(records)} steps: total_loss "
          f"largest relative difference {rel:.3e} (tol {tol:g}), {same} of {len(records)} "
          f"equal", flush=True)
    check(rel <= tol, "the preempted and resumed run does not reproduce the losses")


def phase_accum(teacher: str) -> dict:
    """Cached-feature accumulation at ViT-B-16's full width (phase 18):
    ``--accum-freq 2`` of microbatches of 48 against one batch of 96 on the
    same weights and rows, in bf16 and fp32 through the kernels: the loss,
    the gradients (the logit scale's halved; bf16 all tensors together,
    fp32 per tensor, ``STEP_TOL``), the launches (48a forward and 24a
    backward; with the live dinov2-small teacher 12a more forward), and the
    host clock and peak memory of the whole step, accumulated against one
    step at 96. Returns the launches of the accumulated passes."""
    import dataclasses

    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
    from refining_clip_via_dinov2_representations_torch.train.dino_teacher import (
        LiveDinoTeacher,
    )
    from refining_clip_via_dinov2_representations_torch.train.step import (
        accumulate_grads, make_loss_fn, make_train_step, train_parameters,
    )

    a, micro = ACCUM, CONFIG2_BATCH // ACCUM
    batch = _train_batch(get_tokenizer(MODEL), CONFIG2_BATCH, DEVICE)
    stacked = {k: v.reshape(a, micro, *v.shape[1:]) for k, v in batch.items()}
    launches = {"fused_attention_fwd": 0, "fused_attention_bwd": 0}
    for precision in ("bf16", "fp32"):
        name = "bfloat16" if precision == "bf16" else "float32"
        loss_tol, min_cos = STEP_TOL[name]
        model, head, state, train_step, cfg = _dino_setup(precision, "auto")
        loss_big, grads_big = _loss_and_grads(model, head, cfg, batch)
        params = train_parameters(model, head)
        # ---- the main path: counts at 0 just before, read just after ----
        _zero_counts()
        metrics = accumulate_grads(make_loss_fn(model, cfg, head), stacked, 0, a)
        torch.cuda.synchronize()
        counts = _read_counts()
        grads = {n: p.grad.detach().clone() for n, p in params.items() if p.grad is not None}
        for p in params.values():
            p.grad = None
        grads["logit_scale"] = grads["logit_scale"] / a
        cos, together = _grad_cosines(grads, grads_big)
        worst = min(cos, key=cos.get)
        loss = float(metrics["total_loss"])
        rel = abs(loss - loss_big) / abs(loss_big)
        want = {"flash_attention_fwd": 0, "fused_attention_fwd": 48 * a,
                "fused_attention_bwd": 24 * a}
        print(f"accum {MODEL} {precision}: a={a} x {micro} vs one batch of {CONFIG2_BATCH}: "
              f"loss {loss:.6f} vs {loss_big:.6f} (rel {rel:.2e}, tol {loss_tol:g}); gradient "
              f"cosine (logit scale / {a}) per tensor min {cos[worst]:.6f} at {worst}, all "
              f"tensors together {together:.6f} (need "
              f"{'together' if precision == 'bf16' else 'per tensor'} >= {min_cos}); launches "
              f"{counts}, expected {want}", flush=True)
        check(counts == want, f"accumulation launched {counts}, expected {want}")
        check(rel <= loss_tol and (together if precision == "bf16" else cos[worst]) >= min_cos,
              f"{precision}: accumulated gradients differ from the big batch's")
        for k in launches:
            launches[k] += counts[k]
        acc_step = make_train_step(model, dataclasses.replace(cfg, accum_freq=a), head)
        times, peaks = {}, {}
        for label, fn in ((f"one step of {CONFIG2_BATCH}", lambda: train_step(state, batch)),
                          (f"accumulated {a} x {micro}", lambda: acc_step(state, stacked))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times[label] = host_step_ms(fn, steps=3)
            peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        print(f"accum {MODEL} {precision}: host clock " + ", ".join(
            f"{k} {v:.3f} ms (peak {peaks[k]:.3f} GiB)" for k, v in times.items())
            + f" [{CARD}]", flush=True)
        del model, head, state, train_step, acc_step
        torch.cuda.empty_cache()

    # ---- the live teacher: 12 more forward launches a microbatch ----
    live = LiveDinoTeacher.from_pretrained(teacher, dtype=torch.bfloat16, device=DEVICE)
    _, _, state, _, cfg = _dino_setup("bf16", "auto")
    acc_step = make_train_step(state.model, dataclasses.replace(cfg, accum_freq=a),
                               state.head, dino_teacher=live)
    no_rows = {k: v for k, v in stacked.items() if k != "dino_features"}
    _zero_counts()
    state, metrics = acc_step(state, no_rows)
    torch.cuda.synchronize()
    counts = _read_counts()
    want = {"flash_attention_fwd": 0, "fused_attention_fwd": 48 * a + 12 * a,
            "fused_attention_bwd": 24 * a}
    print(f"accum {MODEL} bf16 with the live dinov2-small teacher: soft_loss "
          f"{float(metrics['soft_loss']):.6f}; launches {counts}, expected {want}", flush=True)
    check(counts == want, f"live accumulation launched {counts}, expected {want}")
    for k in launches:
        launches[k] += counts[k]
    del live, state, acc_step
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _attention_lengths():
    """Records the sequence length of every ``MultiheadAttention`` call
    (recomputes included: a checkpointed block calls its modules again), by
    a global forward pre-hook; yields the list of lengths."""
    import torch

    from refining_clip_via_dinov2_representations_torch.models.layers import MultiheadAttention

    lengths = []

    def hook(module, args):
        if isinstance(module, MultiheadAttention):
            lengths.append(int(args[0].shape[1]))

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield lengths
    finally:
        handle.remove()


def _set_remat(model, policy) -> None:
    """Both towers' activation checkpointing: a remat policy's name, or None
    for none."""
    for tower in (model.visual.transformer, model.transformer):
        tower.grad_checkpointing = policy is not None
        tower.remat_policy = policy or "full"


def _giant_step_numbers(state, train_step, batch, what: str) -> dict:
    """One step's launches, then the host clock over back-to-back steps,
    the CUDA-event time and the peak memory of those steps (gradients freed
    first, so the peak is the step's own)."""
    import torch

    for p in state.optimizer.params:
        p.grad = None
    torch.cuda.empty_cache()
    # ---- the main path: counts at 0 just before, read just after ----
    _zero_counts()
    state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    counts = _read_counts()
    loss = float(metrics["total_loss"])
    for p in state.optimizer.params:
        p.grad = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    host = host_step_ms(lambda: train_step(state, batch), steps=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    events = time_ms(lambda: train_step(state, batch), iters=3)
    print(f"giant {what}: loss {loss:.6f}; launches {counts}; host clock {host:.3f} ms "
          f"({GIANT_BATCH / host * 1e3:.2f} samples/s), CUDA events {events:.3f} ms, peak "
          f"memory {peak:.3f} GiB [{CARD}]", flush=True)
    return dict(loss=loss, counts=counts, host_ms=host, events_ms=events, peak_gib=peak)


def phase_giant(work: str) -> dict:
    """Config 5's single-chip recipe at ViT-g-14's full width, its depth cut
    to ``GIANT_LAYERS`` and ``GIANT_TEXT_LAYERS`` (vision 40 x 1408 in the registry, 16
    heads of 88, 257 tokens; text 24 x 1024, 77 causal tokens; 1.37B
    parameters at full depth), seeded, bf16 compute over fp32 parameters,
    batch 16, the DINO-soft loss as Config 2 sets it (kl_teacher, lambda_soft
    0.5, mlp head 1024 -> 384 on precomputed rows):

    (a) one step's loss and gradients through the kernels against plain
        attention (bf16 ``STEP_TOL``: loss 1e-2, all tensors' cosine 0.99),
        a fused-forward launch a block a forward pass, two forward and one
        backward a block a checkpointed step;
    (b) under adafactor with a bf16 first moment, each remat policy's loss
        and gradients against ``full``'s (the same tolerances), its launches,
        host clock, CUDA-event time and peak memory, and the same without
        checkpointing;
    (c) the peak memory of AdamW (fp32 and bf16 first moment) and adafactor
        (bf16) under ``dots_with_no_batch_dims_saveable``;
    (d) the recipe through ``train.main`` on a cut mini-Flickr with
        ``--force-patch-dropout 0.5``: the vision kernels at 129 tokens in
        training and 257 in evaluation, launches against the loader's batches.

    Returns the launches of (a), (b) and (d)."""
    import math

    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
    from refining_clip_via_dinov2_representations_torch.models.transformer import REMAT_POLICIES
    from refining_clip_via_dinov2_representations_torch.train.optim import (
        OptimCfg, build_optimizer,
    )
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args
    from refining_clip_via_dinov2_representations_torch.train.scheduler import cosine_lr
    from refining_clip_via_dinov2_representations_torch.train.step import train_parameters

    from refining_clip_via_dinov2_representations_torch.models import get_model_config

    launches = {"flash_attention_fwd": 0, "fused_attention_fwd": 0, "fused_attention_bwd": 0}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    # launches: one a block (40 vision + 24 text) a forward; a checkpointed
    # step runs the forward twice (the recompute relaunches the kernel) and
    # the backward once
    _cut_vision_depth(GIANT_MODEL, GIANT_LAYERS, GIANT_TEXT_LAYERS)
    mcfg = get_model_config(GIANT_MODEL)
    v_layers, t_layers = mcfg["vision_cfg"]["layers"], mcfg["text_cfg"]["layers"]
    blocks = v_layers + t_layers
    n_tok = (mcfg["vision_cfg"]["image_size"] // mcfg["vision_cfg"]["patch_size"]) ** 2 + 1
    ctx = mcfg["text_cfg"]["context_length"]
    step_want = {"flash_attention_fwd": 0, "fused_attention_fwd": 2 * blocks,
                 "fused_attention_bwd": blocks}
    loss_tol, min_cos = STEP_TOL["bfloat16"]
    t0 = time.perf_counter()
    model, head, state, train_step, cfg = _dino_setup(
        "bf16", "auto", steps=20, model_name=GIANT_MODEL, grad_checkpointing="full",
        optim_kw=dict(opt="adafactor", mu_dtype="bfloat16"))
    batch = _train_batch(get_tokenizer(GIANT_MODEL), GIANT_BATCH, DEVICE, GIANT_MODEL)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in train_parameters(model, head).values())
    print(f"giant: {GIANT_MODEL} seeded, {n_params / 1e9:.4f}B parameters with the head, on the "
          f"card in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- (a) the kernels against plain attention, and the launches ----
    _zero_counts()
    with torch.no_grad():
        out = model(batch["images"], batch["texts"])
    torch.cuda.synchronize()
    counts = _read_counts()
    check(counts["fused_attention_fwd"] == blocks and counts["fused_attention_bwd"] == 0
          and torch.isfinite(out["image_features"].float()).all().item(),
          f"a ViT-g-14 forward launched {counts}, expected {blocks} forward")
    add(counts)
    del out
    _zero_counts()
    loss_k, grads_k = _loss_and_grads(model, head, cfg, batch)
    torch.cuda.synchronize()
    counts = _read_counts()
    add(counts)
    _set_attn_impl(model, "xla")
    loss_p, grads_p = _loss_and_grads(model, head, cfg, batch)
    _set_attn_impl(model, "auto")
    cos, together = _grad_cosines(grads_k, grads_p)
    worst = min(cos, key=cos.get)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"giant {GIANT_MODEL} bf16 batch {GIANT_BATCH}, full remat: loss {loss_k:.6f} through "
          f"the kernels vs {loss_p:.6f} plain (rel {rel:.2e}, tol {loss_tol:g}); gradient "
          f"cosine all tensors together {together:.6f} (need >= {min_cos}), per tensor min "
          f"{cos[worst]:.6f} at {worst}; launches {counts}, expected {step_want}", flush=True)
    check(counts == step_want, f"the checkpointed ViT-g-14 step launched {counts}")
    check(math.isfinite(loss_k) and rel <= loss_tol and together >= min_cos,
          "the ViT-g-14 step through the kernels disagrees with plain attention")
    del grads_p
    torch.cuda.empty_cache()

    # ---- (b) each remat policy against full on the same parameters ----
    for policy in REMAT_POLICIES[1:]:
        _set_remat(model, policy)
        loss, grads = _loss_and_grads(model, head, cfg, batch)
        cos, together = _grad_cosines(grads, grads_k)
        rel = abs(loss - loss_k) / abs(loss_k)
        del grads
        print(f"giant remat {policy}: loss {loss:.6f} vs full's {loss_k:.6f} (rel {rel:.2e}); "
              f"gradient cosine all tensors together {together:.6f}, per tensor min "
              f"{min(cos.values()):.6f}", flush=True)
        check(rel <= loss_tol and together >= min_cos,
              f"remat policy {policy} changes the ViT-g-14 step")
    del grads_k
    torch.cuda.empty_cache()
    # ---- each policy's numbers (the steps from here on move the parameters) ----
    policies = {}
    for policy in REMAT_POLICIES + (None,):
        _set_remat(model, policy)
        nums = _giant_step_numbers(state, train_step, batch,
                                   f"step adafactor bf16-mu {policy or 'no remat'}")
        want = step_want if policy else {**step_want, "fused_attention_fwd": blocks}
        check(nums["counts"] == want and math.isfinite(nums["loss"]),
              f"{policy}: launches {nums['counts']}, expected {want}")
        add(nums["counts"])
        policies[policy or "none"] = nums

    # ---- (c) the optimizers' peak memory ----
    _set_remat(model, "dots_with_no_batch_dims_saveable")
    optimizers = {}
    for opt, mu in GIANT_OPTIMIZERS:
        state.optimizer = None
        for p in train_parameters(model, head).values():
            p.grad = None
        torch.cuda.empty_cache()
        state.optimizer, _ = build_optimizer(train_parameters(model, head),
                                             OptimCfg(opt=opt, mu_dtype=mu), cosine_lr(5e-4, 0, 20))
        state_gib = sum(t.numel() * t.element_size() for st in state.optimizer.state.values()
                        for t in st.values()) / 2**30
        what = f"{opt} {mu or 'float32'} mu"
        nums = _giant_step_numbers(state, train_step, batch, f"optimizer {what}")
        nums["state_gib"] = state_gib
        print(f"giant optimizer {what}: state {state_gib:.3f} GiB, peak {nums['peak_gib']:.3f} "
              f"GiB under dots_with_no_batch_dims_saveable [{CARD}]", flush=True)
        check(math.isfinite(nums["loss"]) and nums["counts"] == step_want,
              f"{what}: the step failed ({nums})")
        add(nums["counts"])
        optimizers[what] = nums
    finite = all(torch.isfinite(p).all().item() for p in model.parameters())
    check(finite, "a ViT-g-14 parameter is not finite after the steps")
    del model, head, state, train_step, batch
    torch.cuda.empty_cache()

    # ---- (d) the recipe through train.main ----
    from scripts.mini_flickr import generate

    d = generate(os.path.join(work, "giant_data"), n_train=GIANT_TRAIN_IMAGES,
                 n_val=GIANT_VAL_IMAGES, size_px=224, dino_dim=DINO_DIM, seed=SEED + 3)
    argv = ["--model", GIANT_MODEL, "--train-data", d["train_csv"], "--val-data", d["val_csv"],
            "--dataset-type", "csv", "--batch-size", str(GIANT_BATCH), "--precision", "bf16",
            "--opt", "adafactor", "--adam-mu-dtype", "bfloat16", "--grad-checkpointing",
            "--remat-policy", "dots_with_no_batch_dims_saveable", "--use_dino_general",
            "--soft_mode", "kl_teacher", "--lambda_soft", "0.5", "--teacher_temp", "0.15",
            "--use_projection", "--projection_type", "mlp", "--dino_fts_path", d["dino_feats"],
            "--dino_index_map_path", d["dino_index_map"], "--force-patch-dropout",
            str(GIANT_PATCH_DROPOUT), "--epochs", "1", "--save-frequency", "0", "--lr", "5e-4",
            "--warmup", "2", "--workers", "4", "--seed", str(SEED), "--log-every-n-steps", "1",
            "--logs", work, "--name", "giant_cli", "--device", DEVICE]
    from refining_clip_via_dinov2_representations_torch.train.data import get_csv_dataset

    args = parse_args(argv)
    train_batches = get_csv_dataset(args, None, True).dataloader.num_batches
    val_batches = get_csv_dataset(args, None, False).dataloader.num_batches
    with _attention_lengths() as lengths:
        records, counts, wall, seconds = _eval_cli_run(argv)
    # two evaluations (before training and after the epoch)
    want = {"flash_attention_fwd": 0,
            "fused_attention_fwd": 2 * blocks * train_batches + blocks * val_batches * 2,
            "fused_attention_bwd": blocks * train_batches}
    kept = 1 + max(1, int((n_tok - 1) * (1 - GIANT_PATCH_DROPOUT)))
    hist = {n: lengths.count(n) for n in sorted(set(lengths))}
    want_hist = {ctx: 2 * t_layers * train_batches + t_layers * val_batches * 2,
                 kept: 2 * v_layers * train_batches, n_tok: v_layers * val_batches * 2}
    run = os.path.join(work, "giant_cli")
    with open(os.path.join(run, "final_itm_results.json")) as f:
        evals = [e["epoch"] for e in json.load(f)]
    losses = [r["total_loss"] for r in records]
    print(f"giant-cli: {GIANT_MODEL} Config 5 flags + Config 2's DINO flags + "
          f"--force-patch-dropout {GIANT_PATCH_DROPOUT} on mini-Flickr ({GIANT_TRAIN_IMAGES} + "
          f"{GIANT_VAL_IMAGES} images; cut in images, steps and checkpoint saves): "
          f"{len(records)} steps, losses {losses}, evaluations at epochs {evals}; wall "
          f"{wall:.2f} s (train {seconds.get('train_one_epoch', 0):.2f} s, evaluation "
          f"{seconds.get('evaluate', 0):.2f} s); launches {counts}, expected {want}; attention "
          f"lengths {hist}, expected {want_hist} [{CARD}]", flush=True)
    check(counts == want, f"the Config 5 run launched {counts}, expected {want}")
    check(hist == want_hist, f"attention lengths {hist}, expected {want_hist}")
    check(len(records) == train_batches and all(math.isfinite(x) for x in losses),
          "the Config 5 run's losses")
    check(evals == [0, 1] and os.path.isfile(os.path.join(run, "checkpoints",
                                                         "final_torch_state.pt")),
          "the Config 5 run's evaluations or final export are missing")
    add(counts)
    return {"launches": launches, "policies": policies, "optimizers": optimizers,
            "cli": dict(wall=wall, seconds=seconds, steps=len(records))}


def attention_bwd_work(b, h, l, d, causal, dtype_name, lk=None):
    """(FLOPs, bytes) of the attention backward: 10 pairs D FLOPs per head
    (S recomputed, dV, dP, dQ, dK); 4 Lq D + 4 Lk D elements per head moved
    (q, o, dO in and dq out; k, v in and dk, dv out). lk = l unless given."""
    elem = 4 if dtype_name == "float32" else 2
    lk = lk or l
    pairs = sum(min(i + 1, lk) for i in range(l)) if causal else l * lk
    return 10.0 * b * h * pairs * d, 4.0 * b * h * (l + lk) * d * elem


def phase_bwd_times(dtype_name: str) -> dict:
    """Backward kernel, its plain version and SDPA forward+backward minus
    its forward (yardstick only) at ``BWD_TIMED``."""
    import torch
    import torch.nn.functional as F

    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_bwd_reference, fused_attention_fwd,
    )

    dtype = getattr(torch, dtype_name)
    rows = {}
    cases = [(b, h, l, l, d, c) for b, h, l, d, c in BWD_TIMED + GIANT_CASES + TP_BWD_CASES]
    cases += (COCA_CASES + SIGLIP_TIMED + TP_SERVE_CASES + ZOO_BWD_CASES + EVA02_BWD_CASES
              + CONVNET_BWD_CASES + HYBRID_BWD_CASES + MOBILECLIP_BWD_CASES)
    for b, h, l, lk, d, causal in cases:
        q, k, v = _qkv(b, h, l, d, dtype, seed=200, lk=lk)
        do = _qkv(b, h, l, d, dtype, seed=201)[0]
        scale = d ** -0.5
        o = fused_attention_fwd(q, k, v, scale, causal)
        ms = time_ms(lambda: fused_attention_bwd(q, k, v, o, do, scale, causal), iters=20)
        plain = time_ms(lambda: fused_attention_bwd_reference(q, k, v, o, do, scale, causal),
                        iters=20)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, scale=scale)
            torch.autograd.grad(out, (qg, kg, vg), do)

        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale), iters=20)
        lib = time_ms(sdpa_fwd_bwd, iters=20) - sdpa_fwd
        work = attention_bwd_work(b, h, l, d, causal, dtype_name, lk=lk)
        bound, by = _bound(*work, dtype_name)
        row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
        rows[_case_key((b, h, l, lk, d, causal))] = row
        scalar = SCALAR_BWD_MS.get((dtype_name, (b, h, l, d, causal)))
        print(f"time fused_attention_bwd {dtype_name} [{b},{h},{l},{d}] x {lk} keys "
              f"causal={causal}: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa fwd+bwd minus fwd {lib:.4f} ms, "
              f"bound {bound:.4f} ms ({by}){_fp32_cuda_core(work, dtype_name)}, kernel at "
              f"{bound / ms:.1%} of bound"
              f"{'' if scalar is None else '; ' + _beside_scalar(scalar, ms)} [{CARD}]",
              flush=True)
    return rows


def _flash_fp64(q, k, v, scale, causal):
    """The flash kernel's function in float64 with its rounding points: Q
    pre-scaled in the input dtype, P rounded to V's dtype for the PV product,
    normalised after it. Its distance from the kernel is the kernel's own
    rounding error."""
    import torch

    qs = (q * torch.tensor(scale, dtype=q.dtype, device=q.device)).double()
    s = torch.matmul(qs, k.double().transpose(-1, -2))
    if causal:
        above = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return torch.matmul(p.to(v.dtype).double(), v.double()) / p.sum(dim=-1, keepdim=True)


def phase_kernels_flash() -> dict:
    """The flash kernel vs its plain version and float64 on the card;
    returns {dtype: max_abs_err vs plain}."""
    import torch

    from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
        flash_attention, flash_attention_fwd, flash_attention_reference,
    )

    worst, worst_case = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, (b, h, lq, lk, d, causal) in enumerate(FLASH_CASES + HYBRID_FLASH_CASES):
            q, k, v = _qkv(b, h, lq, d, dtype, seed=300 + i, lk=lk)
            scale = d ** -0.5
            got = flash_attention_fwd(q, k, v, scale, causal)
            want = flash_attention_reference(q, k, v, scale, causal)
            exact = _flash_fp64(q, k, v, scale, causal)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dtype,
                  f"flash output {tuple(got.shape)} {got.dtype} at {(b, h, lq, lk, d)}")
            err = (got.float() - want.float()).abs().max().item()
            err64 = (got.double() - exact).abs().max().item()
            if max(err, err64) >= worst_case.get(name, (-1.0,))[0]:
                worst_case[name] = (max(err, err64), (b, h, lq, lk, d, causal))
            worst[name] = max(worst.get(name, 0.0), err)
            ok = max(err, err64) <= TOL[name] and bool(torch.isfinite(got.float()).all())
            print(f"kernel flash_attention_fwd {name} [{b},{h},{lq},{d}] x {lk} keys "
                  f"causal={causal}: max_abs_err {err:.3e} vs plain, {err64:.3e} vs float64 "
                  f"(tol {TOL[name]:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
            check(ok, f"flash_attention_fwd disagrees with its plain version at {name} "
                      f"[{b},{h},{lq},{lk},{d}] causal={causal}: {err:.3e} / {err64:.3e}")
        err, (b, h, lq, lk, d, causal) = worst_case[name]
        print(f"kernel flash_attention_fwd {name}: worst case [{b},{h},{lq},{d}] x {lk} keys "
              f"causal={causal}, {err:.3e} vs plain or float64 (tol {TOL[name]:g})", flush=True)
    # the flash op's registered autograd against autograd through the plain
    # version, fp32
    for causal in (False, True):
        q, k, v = (x.requires_grad_() for x in _qkv(2, 4, 577, 64, torch.float32,
                                                     seed=400 + causal))
        do = _qkv(2, 4, 577, 64, torch.float32, seed=410 + causal)[0]
        got = torch.autograd.grad(flash_attention(q, k, v, 0.125, causal), (q, k, v), do)
        want = torch.autograd.grad(flash_attention_reference(q, k, v, 0.125, causal),
                                   (q, k, v), do)
        largest = max(w.abs().max().item() for w in want)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        print(f"autograd flash_attention float32 [2,4,577,64] causal={causal}: max_abs_err "
              f"{err:.3e} vs autograd of the plain version (tol 1e-4 x {largest:.3e})",
              flush=True)
        check(err <= 1e-4 * largest, "the flash op's autograd disagrees with autograd")
    return worst


def _launch_counters():
    from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
        flash_attention_fwd,
    )
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_fwd,
    )

    return {"flash_attention_fwd": flash_attention_fwd,
            "fused_attention_fwd": fused_attention_fwd,
            "fused_attention_bwd": fused_attention_bwd}


def _zero_counts() -> None:
    for fn in _launch_counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _launch_counters().items()}


def phase_train_long() -> int:
    """The long-sequence training path: ViT-L-14-336 at full width, its
    vision depth cut to ``LONG_LAYERS``, bf16 compute, ``attn_impl="flash"``,
    three steps without and three with grad checkpointing; returns the flash
    launches of the six steps."""
    import math

    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer

    _cut_vision_depth(LONG_MODEL, LONG_LAYERS)
    batch = _train_batch(get_tokenizer(LONG_MODEL), LONG_BATCH, DEVICE, model_name=LONG_MODEL)
    _compare_step("bf16", batch, model_name=LONG_MODEL, impl="flash")

    # a schedule long enough that the learning rate is not 0 in any step here
    model, head, state, train_step, _ = _dino_setup("bf16", "flash", steps=40,
                                                    model_name=LONG_MODEL)
    n_vis = len(model.visual.transformer.resblocks)
    print(f"train-long: {LONG_MODEL} (vision {n_vis}x{model.visual.width}, "
          f"{model.visual.positional_embedding.shape[0]} tokens; text "
          f"{len(model.transformer.resblocks)}x{model.ln_final.weight.numel()}; "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params) bf16 DINO-soft "
          f"(kl_teacher, lambda_soft 0.5, mlp head {head.fc1.in_features}->"
          f"{head.fc1.out_features}->{DINO_DIM}) batch {LONG_BATCH}", flush=True)
    check(n_vis == LONG_LAYERS and model.visual.positional_embedding.shape[0] == 577,
          f"ViT-L-14-336 must have {LONG_LAYERS} vision layers over 577 tokens here")
    head_before = [p.detach().clone() for p in head.parameters()]
    steps, flash_total, losses = 3, 0, []
    for remat in (False, True):
        model.set_grad_checkpointing(remat)
        # ---- the main path: counts at 0 just before, read just after ----
        _zero_counts()
        for _ in range(steps):
            state, metrics = train_step(state, batch)
            losses.append(metrics["total_loss"])
        torch.cuda.synchronize()
        counts = _read_counts()
        per_step = 2 * n_vis if remat else n_vis
        print(f"train-long grad_checkpointing={remat}: launches {counts} over {steps} steps "
              f"(expected flash {per_step * steps}, fused 0)", flush=True)
        check(counts["flash_attention_fwd"] == per_step * steps,
              f"expected {per_step * steps} flash launches, got {counts}")
        check(counts["fused_attention_fwd"] == 0 and counts["fused_attention_bwd"] == 0,
              f"the flash path launched a fused kernel: {counts}")
        flash_total += counts["flash_attention_fwd"]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: train_step(state, batch), iters=3)
        host_ms = host_step_ms(lambda: train_step(state, batch), steps=3)
        peak = torch.cuda.max_memory_allocated()
        print(f"time train step {LONG_MODEL} bf16 batch {LONG_BATCH} flash grad_checkpointing="
              f"{remat}: device {step_ms:.3f} ms (CUDA events), host clock {host_ms:.3f} ms "
              f"({LONG_BATCH / host_ms * 1e3:.1f} samples/s), peak memory "
              f"{peak / 2**30:.3f} GiB [{CARD}]", flush=True)
    losses = [float(x) for x in losses]
    ln_scale = float(model.logit_scale.detach())
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(head.parameters(), head_before))
    print(f"train-long: losses {losses}, ln logit scale {ln_scale:.6f}, head moved by "
          f"{moved:.3e}", flush=True)
    check(all(math.isfinite(x) for x in losses), "a train-long loss is not finite")
    check(0.0 <= ln_scale <= math.log(100.0), "the logit scale left [0, ln 100]")
    check(moved > 0, "the DINO head did not move")
    del model, head, state, train_step
    torch.cuda.empty_cache()

    # plain attention's step, for scale (no checkpointing)
    _, _, p_state, p_step, _ = _dino_setup("bf16", "xla", model_name=LONG_MODEL)
    torch.cuda.reset_peak_memory_stats()
    plain_ms = time_ms(lambda: p_step(p_state, batch), iters=3)
    plain_host_ms = host_step_ms(lambda: p_step(p_state, batch), steps=3)
    plain_peak = torch.cuda.max_memory_allocated()
    del p_state, p_step
    torch.cuda.empty_cache()
    print(f"time train step {LONG_MODEL} bf16 batch {LONG_BATCH} plain attention "
          f"grad_checkpointing=False: device {plain_ms:.3f} ms (CUDA events), host clock "
          f"{plain_host_ms:.3f} ms ({LONG_BATCH / plain_host_ms * 1e3:.1f} samples/s), peak "
          f"memory {plain_peak / 2**30:.3f} GiB [{CARD}]", flush=True)

    # fp32 (TF32 off) with checkpointing: its activations would not fit without
    _compare_step("fp32", batch, model_name=LONG_MODEL, impl="flash", grad_checkpointing=True)
    return flash_total + phase_long_fp32_step(batch)


def phase_long_fp32_step(batch) -> int:
    """The ViT-L-14-336 DINO-soft step in fp32 compute with grad
    checkpointing (what ``--precision amp --attn-impl flash
    --grad-checkpointing`` runs): three steps' launches through flash (48 a
    step, no fused), the kernels a step runs by the profiler, then the step's
    time and peak memory through flash, through ``"auto"`` (at 577 tokens the
    fused fp32 kernels, forward and backward: the CLI's default) and through
    plain attention, all checkpointed; returns the flash launches."""
    import torch

    routes = {"flash": ("flash",), "auto": ("fwd", "dq", "dkdv"), "xla": ()}
    times, flash = {}, 0
    for impl, parts in routes.items():
        model, head, state, train_step, _ = _dino_setup("fp32", impl, steps=40,
                                                        model_name=LONG_MODEL,
                                                        grad_checkpointing=True)
        steps = 3 if impl == "flash" else 1
        # ---- the main path (flash): counts at 0 just before, read just after ----
        _zero_counts()
        for _ in range(steps):
            state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        counts = _read_counts()
        print(f"train-long {LONG_MODEL} fp32 impl={impl} grad_checkpointing=True: launches "
              f"{counts} over {steps} step(s)", flush=True)
        if impl == "flash":
            want = 2 * LONG_LAYERS * steps
            check(counts == {"flash_attention_fwd": want, "fused_attention_fwd": 0,
                             "fused_attention_bwd": 0},
                  f"expected {want} flash launches and no fused one, got {counts}")
            flash = counts["flash_attention_fwd"]
        if parts:
            check_fp32_route(lambda: train_step(state, batch), parts,
                             f"one fp32 {LONG_MODEL} step, impl={impl}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: train_step(state, batch), iters=3)
        host_ms = host_step_ms(lambda: train_step(state, batch), steps=3)
        times[impl] = (step_ms, host_ms, torch.cuda.max_memory_allocated())
        del model, head, state, train_step
        torch.cuda.empty_cache()
    print(f"time train step {LONG_MODEL} fp32 batch {LONG_BATCH} grad_checkpointing=True: "
          + "; ".join(f"{impl} device {ms:.3f} ms (CUDA events), host clock {host:.3f} ms "
                      f"({LONG_BATCH / host * 1e3:.2f} samples/s), peak memory "
                      f"{peak / 2**30:.3f} GiB" for impl, (ms, host, peak) in times.items())
          + f" [{CARD}]", flush=True)
    return flash


def phase_train_cli_long() -> int:
    """The CLI on ViT-L-14-336 with ``--grad-checkpointing --attn-impl
    flash`` (its checkpoint loads strictly), then one step of ViT-B-16 at
    ``--force-image-size 384``; returns the flash launches of both runs."""
    import json as _json
    import math
    import os
    import shutil
    import tempfile

    import torch

    from refining_clip_via_dinov2_representations_torch.models import create_model
    from refining_clip_via_dinov2_representations_torch.train.main import main as train_main

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    logs = tempfile.mkdtemp(prefix="chip_smoke_train_long_", dir=build)
    common = ["--dataset-type", "synthetic", "--use_dino_general", "--soft_mode", "kl_teacher",
              "--lambda_soft", "0.5", "--synthetic-dino-dim", str(DINO_DIM), "--precision",
              "bf16", "--batch-size", str(LONG_BATCH), "--epochs", "1", "--workers", "4",
              "--log-every-n-steps", "1", "--logs", logs, "--seed", str(SEED), "--device", DEVICE,
              "--attn-impl", "flash"]
    try:
        _zero_counts()
        train_main(["--model", LONG_MODEL, "--grad-checkpointing", "--name", "long",
                    "--train-num-samples", str(CLI_LONG_SAMPLES), *common])
        torch.cuda.synchronize()
        counts = _read_counts()
        steps = CLI_LONG_SAMPLES // LONG_BATCH
        with open(os.path.join(logs, "long", "loss_steps.json")) as f:
            records = _json.load(f)
        ckpt = os.path.join(logs, "long", "checkpoints", "epoch_1.pt")
        print(f"train-cli-long: {LONG_MODEL} --grad-checkpointing --attn-impl flash: "
              f"{len(records)} logged steps, total_loss {[r['total_loss'] for r in records]}; "
              f"launches {counts} (expected flash {2 * LONG_LAYERS * steps}, fused 0); "
              f"checkpoint {os.path.getsize(ckpt) / 2**20:.1f} MiB", flush=True)
        check(len(records) == steps and all(math.isfinite(r["total_loss"]) for r in records),
              "loss_steps.json is not one finite record per step")
        check(counts == {"flash_attention_fwd": 2 * LONG_LAYERS * steps,
                         "fused_attention_fwd": 0, "fused_attention_bwd": 0},
              f"the CLI run launched {counts}")
        flash = counts["flash_attention_fwd"]
        model, _ = create_model(LONG_MODEL, pretrained=ckpt, device=DEVICE)  # strict
        saved = torch.load(ckpt, map_location="cpu", weights_only=True, mmap=True)["state_dict"]
        same = all(torch.equal(v.cpu(), saved[k]) for k, v in model.state_dict().items())
        print(f"train-cli-long: the checkpoint loads strictly with create_model(pretrained=...), "
              f"every tensor equal to the saved one: {same}", flush=True)
        check(same and len(saved) == len(model.state_dict()), "the checkpoint does not load")
        del model, saved
        torch.cuda.empty_cache()

        _zero_counts()
        train_main(["--model", MODEL, "--force-image-size", "384", "--name", "b16_384",
                    "--train-num-samples", str(LONG_BATCH), "--save-frequency", "0", *common])
        torch.cuda.synchronize()
        counts = _read_counts()
        with open(os.path.join(logs, "b16_384", "loss_steps.json")) as f:
            records = _json.load(f)
        print(f"train-cli-long: {MODEL} --force-image-size 384 --attn-impl flash: one step, "
              f"total_loss {[r['total_loss'] for r in records]}; launches {counts} (expected "
              f"flash 12, fused 0)", flush=True)
        check(len(records) == 1 and math.isfinite(records[0]["total_loss"]),
              "the forced-size run did not log one finite step")
        check(counts == {"flash_attention_fwd": 12, "fused_attention_fwd": 0,
                         "fused_attention_bwd": 0}, f"the forced-size run launched {counts}")
        return flash + counts["flash_attention_fwd"]
    finally:
        shutil.rmtree(logs, ignore_errors=True)


def phase_flash_times() -> dict:
    """Flash kernel, its plain version and SDPA (yardstick only) at the
    training shapes, beside the bound."""
    import torch
    import torch.nn.functional as F

    from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference,
    )

    rows = {}
    for b, h, lq, lk, d, causal, dtype_name in FLASH_TIMED:
        q, k, v = _qkv(b, h, lq, d, getattr(torch, dtype_name), seed=500, lk=lk)
        scale = d ** -0.5
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, scale, causal), iters=20)
        plain = time_ms(lambda: flash_attention_reference(q, k, v, scale, causal), iters=20)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale), iters=20)
        work = attention_work(b, h, lq, d, causal, dtype_name, lk=lk)
        bound, by = _bound(*work, dtype_name)
        rows[(b, h, lq, lk, d, causal, dtype_name)] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
        print(f"time flash_attention_fwd {dtype_name} [{b},{h},{lq},{d}] causal={causal}: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by}){_fp32_cuda_core(work, dtype_name)}, kernel at "
              f"{bound / ms:.1%} of bound; "
              f"{_beside_scalar(SCALAR_FLASH_MS.get((b, h, lq, lk, d, causal, dtype_name)), ms)} "
              f"[{CARD}]", flush=True)
    return rows


# ---- phase dist: multi-GPU training on the one card ----

# the dist phase's own mini-Flickr cut: 100 train caption rows (three steps
# of 32), whole-image crops so that every run sees the same pixels
DIST_TRAIN_IMAGES, DIST_VAL_IMAGES, DIST_BATCH = 20, 8, 32
# ViT-B-16's vision depth in the dist phase's runs: 12 blocks cut to 2 to
# keep the script inside its time limit (the width, the text tower and every
# check stay: the routes must move bytes only; the thesis step runs at full
# depth in phases 6 and 12)
DIST_VISION_LAYERS = 2
# the processes of phases 20 and 21 and config2's preempted run start at
# once (``phase_processes``): the threads that wait on them, at least one a
# process (a rank whose peer waits for a thread never ends)
LANE_WORKERS = 16
DIST_ROUTES = (("replicated", []), ("zero1", ["--shard-opt-state"]), ("fsdp", ["--fsdp"]))
# the flags of the evaluation and the CLIP-blind check (and their values),
# left out of the world-size-1 runs: their train steps are what is compared
_EVAL_FLAGS = {"--val-data": 1, "--dino_fts_path_val": 1, "--dino_index_map_path_val": 1,
               "--run_clip_blind": 0, "--clip_blind_val_key": 1}
# the bare torch.distributed calls gloo carried for CUDA tensors with torch
# 2.11 on the H100 (PERF.md §5), probed together in one pair of ranks: a
# refusal of any of them now fails the phase
GLOO_CUDA_CARRIES = ("all_gather", "all_gather_grad", "all_reduce", "broadcast",
                     "reduce_scatter", "all_gather_into_tensor", "ddp")
# what it refused there (P2P: "writev ... Bad address"; fully_shard: signal
# 11), each in a pair of its own, since it may end the process
GLOO_CUDA_REFUSED = ("p2p", "fsdp")
# (loss, SigLIP impl, route) of phase (b), and the collectives each needs
# (DDP: broadcast at the start, all_reduce in the backward; the gathered
# losses: all_gather, then all_reduce in the backward; ZeRO-1: each rank's
# slices gathered into the parameters)
_DDP = ("all_reduce", "broadcast", "ddp")
DIST_STEP_CASES = ((("clip", "bidir", "replicated"), ("all_gather_grad",) + _DDP),
                   (("siglip", "bidir", "replicated"), ("p2p",) + _DDP),
                   (("siglip", "gather", "replicated"), ("all_gather_grad",) + _DDP),
                   (("siglip", "shift", "replicated"), ("p2p",) + _DDP),
                   (("siglip", "reduce", "replicated"), _DDP),
                   (("clip", "bidir", "zero1"), ("all_gather_grad", "all_gather_into_tensor")
                    + _DDP),
                   (("clip", "bidir", "fsdp"), ("all_gather_grad", "fsdp")))


def phase_processes(work: str, carried: dict, d: dict, pre: dict, c2: dict,
                    beside=lambda: None) -> tuple:
    """Phases 20 (dist) and 21 (tp) and Config 2's preempted run
    (``config2_preempted``): every process of them started at once, then
    ``beside()`` in this process (checks that time nothing), then each
    phase's checks and lines in order. None of them is timed against a
    quiet card: the host clocks, walls and latencies they print are taken
    beside the other processes. Returns dist's launches, tp's results, the
    preempted run and what ``beside`` returned."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()  # what this process cached, for the children
    # OpenMP threads a process: the processes share the host's cores, and
    # each spends most of its time starting up or in gloo's host copies
    threads = max(1, (os.cpu_count() or 1) // 4)
    n = 1 + len(DIST_ROUTES) + 2 + 2 * TP_AXIS + 1 + TP_AXIS + 1
    check(n <= LANE_WORKERS, f"processes: {n} processes, {LANE_WORKERS} threads to wait on them")
    print(f"processes: phases 20 and 21 and config2's preempted run, {n} processes, start at "
          f"once, {threads} OpenMP threads each, on {os.cpu_count()} host cores", flush=True)
    with ThreadPoolExecutor(LANE_WORKERS) as pool:
        preempted = pool.submit(config2_preempted, d, pre, work, c2["train_batches"], threads)
        finish_dist = start_dist(work, carried, pool, threads)
        finish_tp = start_tp(work, d, pre, pool, threads)
        besides = beside()
        print(f"processes: this process's checks beside them ended after "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        dist_launches = finish_dist()
        tp = finish_tp()
        run = preempted.result()
    print(f"processes: {time.perf_counter() - t0:.1f} s", flush=True)
    return dist_launches, tp, run, besides


def _rank_device():
    """Every rank's device: the one card (``DEVICE`` "cpu" rehearses on the
    host)."""
    import torch

    return torch.device("cuda", 0) if DEVICE == "cuda" else torch.device("cpu")


def _sync(device=None) -> None:
    import torch

    if (device.type if device is not None else DEVICE) == "cuda":
        torch.cuda.synchronize(device)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_child(role: str, payload: dict, env: dict, timeout: float):
    """``python3 chip_smoke.py --dist-child role payload`` under ``env`` (a
    rank's variables): (exit code, the JSON of its ``DIST_CHILD`` line or
    None, the ends of its output and errors)."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--dist-child", role,
                               json.dumps(payload)], cwd=here, env={**os.environ, **env},
                              capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        return None, None, f"timed out after {timeout} s", str(e.stderr)[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("DIST_CHILD ")]
    result = json.loads(lines[-1][len("DIST_CHILD "):]) if lines else None
    return proc.returncode, result, proc.stdout[-3000:], proc.stderr[-6000:]


def _child(role: str, payload: dict, env: dict, timeout: float = 300) -> dict:
    """A child that must succeed: its result."""
    code, result, out, err = _run_child(role, payload, env, timeout)
    if code != 0 or result is None:
        fail(f"dist child {role} ({env.get('RANK', 'one process')}) exited {code}:\n{out}\n{err}")
    return result


def _rank_envs(world: int, per_card: bool = False, threads: int = None) -> list:
    """torchrun's variables for ``world`` ranks: every rank on card 0, or
    rank ``r`` on card ``r`` (``per_card``); ``threads`` OpenMP threads a
    rank (default: the host's cores over the ranks, or ``OMP_NUM_THREADS``)."""
    port = str(_free_port())
    omp = (str(threads) if threads else
           os.environ.get("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world))))
    return [{"RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r if per_card else 0),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port, "OMP_NUM_THREADS": omp}
            for r in range(world)]


def _submit_ranks(pool, role: str, payload: dict, world: int, timeout: float,
                  threads: int) -> list:
    """``world`` ranks of ``role`` submitted to ``pool`` together (it must
    have a free worker for each, or a rank waits for a peer that never
    starts); their futures in rank order."""
    return [pool.submit(_child, role, payload, env, timeout)
            for env in _rank_envs(world, threads=threads)]


def _children(role: str, payload: dict, world: int, timeout: float = 300,
              per_card: bool = False) -> list:
    """``world`` ranks of ``role``, started together; their results in rank
    order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(world) as pool:
        return list(pool.map(lambda e: _child(role, payload, e, timeout),
                             _rank_envs(world, per_card)))


def _probe_gloo_cuda() -> dict:
    """The collectives gloo carries for CUDA tensors on two ranks of the
    card: those it carried before in one pair, each it refused in a pair of
    its own, all pairs at once. Each name gives True, "wrong numbers", what
    the ranks raised or how they ended, or that an earlier probe of its
    pair stopped it."""
    from concurrent.futures import ThreadPoolExecutor

    pairs = [GLOO_CUDA_CARRIES] + [(name,) for name in GLOO_CUDA_REFUSED]
    jobs = [(ops, env) for ops in pairs for env in _rank_envs(2)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        ends = list(pool.map(lambda j: _run_child("probe", {"ops": list(j[0])}, j[1], 150),
                             jobs))
    carried = {}
    for ops in pairs:
        mine = [end for (o, _), end in zip(jobs, ends) if o == ops]
        for name in ops:
            said = [res["carried"].get(name) for _, res, _, _ in mine if res is not None]
            if len(said) == 2 and all(v is True for v in said):
                carried[name] = True
                continue
            why = [str(v) for v in said if v not in (True, None)]
            for code, res, _, err in mine:
                if res is None:  # the fatal error and the innermost frame faulthandler printed
                    lines = [ln.strip() for ln in err.splitlines() if ln.strip()]
                    fatal = [ln for ln in lines if ln.startswith(("Fatal Python error",
                                                                  "terminate called", "what():"))]
                    frames = [ln for ln in lines if ln.startswith("File ")]
                    why.append(f"exit {code}: {' / '.join(fatal[:2] + frames[:1])[:300]}")
            carried[name] = "; ".join(why) or "not probed: an earlier probe of its pair failed"
    return carried


def _child_train(payload: dict) -> dict:
    """One run of ``train.main`` (a rank when the environment names one):
    its per-step losses, host clock and launches, and its peak memory.
    ``payload["eva_layers"]`` cuts the EVA01 towers' depth to that many
    blocks, ``payload["cut"]`` (a model name, a depth) a registry model's
    vision depth (``_cut_vision_depth``)."""
    import torch
    import torch.distributed as dist

    from refining_clip_via_dinov2_representations_torch.models import eva
    from refining_clip_via_dinov2_representations_torch.train import main as train_main
    from refining_clip_via_dinov2_representations_torch.train import step as train_step_mod

    if payload.get("eva_layers"):
        for name, (width, _, heads, mlp_ratio, patch) in list(eva.EVA01_DIMS.items()):
            eva.EVA01_DIMS[name] = (width, payload["eva_layers"], heads, mlp_ratio, patch)
    if payload.get("cut"):
        _cut_vision_depth(*payload["cut"])

    counters = _launch_counters()
    steps = []
    make = train_step_mod.make_train_step

    def timed(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(state, batch):
            _sync()
            before = _read_counts()
            t0 = time.perf_counter()
            out = step(state, batch)
            _sync()
            after = _read_counts()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                          **{k: after[k] - before[k] for k in after}})
            return out

        return run

    train_step_mod.make_train_step = timed
    _zero_counts()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    records = train_main.main(payload["argv"])
    wall = time.perf_counter() - t0
    return {"losses": [r["total_loss"] for r in records], "steps": steps,
            "launches": {k: fn.launches for k, fn in counters.items()}, "wall_s": wall,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if DEVICE == "cuda" else 0.0),
            "world": dist.get_world_size() if dist.is_initialized() else 0,
            "backend": dist.get_backend() if dist.is_initialized() else None}


def _child_probe(payload: dict) -> dict:
    """The bare torch.distributed calls of ``payload["ops"]`` on CUDA
    tensors over gloo, in order, up to the first that raises: for each,
    True when it gives the right numbers, "wrong numbers" when not, or what
    it raised."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    # a collective that hangs raises after a minute instead of holding the run
    dist.init_process_group("gloo", timeout=timedelta(seconds=60))
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4, 8), float(rank + 1), device=_rank_device())

    def all_gather():
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return all(float(o[0, 0]) == i + 1 for i, o in enumerate(out))

    class Gather(torch.autograd.Function):  # all_gather, all_reduce in the backward
        @staticmethod
        def forward(ctx, t):
            out = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(out, t.contiguous())
            return torch.cat(out)

        @staticmethod
        def backward(ctx, g):
            g = g.contiguous().clone()
            dist.all_reduce(g)
            return g[rank * 4:(rank + 1) * 4]

    def all_gather_grad():
        a = x.clone().requires_grad_()
        g = Gather.apply(a)
        g.sum().backward()
        return (g.shape[0] == 4 * world and float(g[4 * (world - 1), 0]) == world
                and bool((a.grad == world).all()))

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return float(y[0, 0]) == world * (world + 1) / 2

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return float(y[0, 0]) == 1.0

    def p2p():
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, y, (rank - 1) % world)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        return float(y[0, 0]) == (rank - 1) % world + 1

    def reduce_scatter():
        y = torch.empty_like(x)
        dist.reduce_scatter_tensor(y, torch.cat([x] * world))
        return float(y[0, 0]) == world * (world + 1) / 2

    def all_gather_into_tensor():
        y = x.new_empty((4 * world, 8))
        dist.all_gather_into_tensor(y, x)
        return float(y[4 * (world - 1), 0]) == world

    def ddp():  # the wrapper's start (shapes checked, states broadcast) and a backward
        from torch.nn.parallel import DistributedDataParallel

        lin = torch.nn.Linear(8, 2).to(x.device)
        ids = [x.device.index] if x.device.type == "cuda" else None
        wrapped = DistributedDataParallel(lin, device_ids=ids)  # alive through the backward
        wrapped(x).sum().backward()
        # each rank's rows sum to 4 (rank + 1); DDP averages over the ranks
        return torch.allclose(lin.weight.grad, torch.full_like(lin.weight.grad,
                                                               4 * (world + 1) / 2))

    def fsdp():  # fully_shard on two layers and the root, forward and backward
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(8, 64), torch.nn.Linear(64, 8)).to(x.device)
        want = [p.detach().clone() for p in net.parameters()]
        mesh = init_device_mesh(x.device.type, (world,))
        for layer in net:
            fully_shard(layer, mesh=mesh)
        fully_shard(net, mesh=mesh)
        net(x).sum().backward()
        grads = [p.grad.full_tensor() for p in net.parameters()]
        # the rank mean of each rank's gradient, from the same weights
        ref = torch.nn.Sequential(torch.nn.Linear(8, 64), torch.nn.Linear(64, 8)).to(x.device)
        with torch.no_grad():
            for p, w in zip(ref.parameters(), want):
                p.copy_(w)
        for r in range(world):
            ref(torch.full_like(x, float(r + 1))).sum().backward()
        return all(torch.allclose(g, p.grad / world, rtol=1e-5, atol=1e-5)
                   for g, p in zip(grads, ref.parameters()))

    ops = {"all_gather": all_gather, "all_gather_grad": all_gather_grad, "ddp": ddp,
           "fsdp": fsdp, "all_reduce": all_reduce, "broadcast": broadcast, "p2p": p2p,
           "reduce_scatter": reduce_scatter, "all_gather_into_tensor": all_gather_into_tensor}
    carried = {}
    for name in payload["ops"]:
        try:
            carried[name] = True if ops[name]() else "wrong numbers"
            _sync()
        except Exception as e:  # the probe's finding: gloo refuses this one
            carried[name] = f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:200]}"
            break  # the pair's connection may be gone: the rest stay unprobed
    return {"rank": rank, "carried": carried, "torch": torch.__version__}


def _child_step(payload: dict) -> dict:
    """A rank of the multi-rank train step: phase (b) (gloo, both ranks on
    card 0) and ``scripts/dist_nccl_check.py`` (NCCL, rank ``r`` on card
    ``r``; or gloo on the CPU). The group joins through
    ``train/distributed.py`` (``payload["backend"]``, ``payload["device"]``
    "cuda" or "cpu"). Each case ``(loss, SigLIP impl, route)`` takes a fresh
    copy of one seeded ``payload["model"]`` (and DINO head for ``dino``:
    soft KL and weighted CE) under DDP (``replicated``), ZeRO-1 under DDP
    or FSDP, and a step on this rank's ``payload["batch"]`` rows (fp32,
    TF32 off). Its reference: for clip and SigLIP, rank 0's one-process
    step at the global batch (their rank mean is the global batch's loss);
    for DINO-soft under ZeRO-1 and FSDP, the DINO case under DDP. Returns,
    a case: the loss, the cosines of the whole gradients after the rank
    mean against the reference's (rank 0), the launches of the step and of
    two, the host clock of the second, and the card's peak over the two
    steps and over a checkpoint's gather (model, head and optimizer state
    into rank 0's host memory; its seconds and the tensors kept). With
    ``payload["time_one_process"]`` rank 0 also times the one-process step
    at ``batch`` rows. With ``payload["model_axis"]`` above 1 the ranks form
    a ``(world / model_axis, model_axis)`` mesh: every copy but the
    one-process reference is split over its model group
    (``parallel/tensor.py``), the losses, DDP, ZeRO-1 and FSDP run over the
    data group, data rank ``r`` takes rows ``r * batch`` onward of the global
    batch of ``world / model_axis * batch`` rows, and the gradients are
    gathered whole over both axes. ``payload["remat"]`` builds the model
    with that remat policy, ``payload["optim"]`` the optimizer's settings
    (``OptimCfg``'s fields)."""
    import copy
    import gc
    from types import SimpleNamespace

    import torch
    import torch.distributed as dist

    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import (
        DATA_AXIS, apply_fsdp, create_mesh, full_state_dict, tp_sharding, wrap_ddp,
        zero1_sharding,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import (
        gather_tensor, model_parallel, shard_module,
    )
    from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
    from refining_clip_via_dinov2_representations_torch.train.distributed import (
        data_group, init_distributed_device, model_group,
    )
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, Towers, TrainState, make_train_step, train_parameters, train_splits,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if payload.get("cut"):
        _cut_vision_depth(*payload["cut"])
    ns = SimpleNamespace(device=None, force_cpu=payload["device"] == "cpu", dist_url=None,
                         dist_backend=payload["backend"], no_set_device_rank=False)
    dev = init_distributed_device(ns)
    rank, world, group = ns.rank, ns.world_size, dist.group.WORLD
    cuda = dev.type == "cuda"
    model_name, batch = payload["model"], payload["batch"]
    model_axis = payload.get("model_axis", 1)
    mesh = mp = dgroup = None
    data_rank, data_world = rank, world
    if model_axis > 1:
        mesh = create_mesh(model=model_axis, device_type=dev.type)
        mp, group, dgroup = model_parallel(model_group()), data_group(), mesh[DATA_AXIS].get_group()
        data_rank, data_world = mesh[DATA_AXIS].get_local_rank(), mesh[DATA_AXIS].size()
    base, _ = create_model(model_name, precision="amp", device=dev, seed=SEED,
                           grad_checkpointing=payload.get("remat") or False)
    base.train()
    torch.manual_seed(SEED + 1)
    base_head = DinoProjectionHead(base.text_projection.shape[1], DINO_DIM).to(dev)
    full = _train_batch(get_tokenizer(model_name), data_world * batch, dev.type,
                        model_name=model_name)
    mine = {k: v[data_rank * batch:(data_rank + 1) * batch] for k, v in full.items()}
    schedule = scheduler.const_lr(1e-5, 0, 2)
    dino = DinoLossCfg(lambda_soft=0.5, soft_mode="kl_teacher", lambda_weighted=0.2)

    def build(route, loss):
        nonlocal mesh
        model = copy.deepcopy(base)
        head = copy.deepcopy(base_head) if loss == "dino" else None
        splits = {}
        if route != "single" and mp is not None:
            shard_module(model, mp)
            if head is not None:
                shard_module(head, mp, head=True)
            splits = train_splits(model, head)
        named = train_parameters(model, head)
        sharding = towers = None
        if route == "fsdp":
            mesh = mesh or create_mesh(device_type=dev.type)
            sharding = apply_fsdp(model, head, mesh, named)
            towers = Towers(model, head)
        elif route != "single":
            if route == "zero1":
                sharding = zero1_sharding(named, dgroup or group, tp=mp, tp_splits=splits)
            elif mp is not None:
                sharding = tp_sharding(named, dgroup, mp, splits)
            towers = wrap_ddp(Towers(model, head), dev, dgroup)
        # FSDP replaces the parameters with its DTensors: the optimizer takes those
        opt, _ = optim.build_optimizer(train_parameters(model, head),
                                       optim.OptimCfg(**payload.get("optim", {})), schedule,
                                       sharding=sharding)
        return model, head, opt, towers

    def whole_grads(model, head):  # a collective under FSDP or a model axis
        splits = train_splits(model, head) if mp is not None else {}
        out = {}
        for n, p in train_parameters(model, head).items():
            g = (p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad).detach()
            out[n] = (gather_tensor(g, splits[n], mp) if n in splits else g
                      ).double().flatten().cpu()
        return out

    out, dino_ref = {}, None
    for loss, impl, route in payload["cases"]:
        key = f"{loss}-{impl}-{route}"
        print(f"rank {rank}: {key}", file=sys.stderr, flush=True)
        cfg = StepCfg(loss_type=loss, dino=dino, siglip_dist_impl=impl)
        ref = dino_ref if loss == "dino" and route != "replicated" else None
        if rank == 0 and loss != "dino":  # the one-process step at the global batch
            model, head, opt, _ = build("single", loss)
            single, m = make_train_step(model, cfg, head)(TrainState(model, head, opt), full)
            ref = (float(m["total_loss"]), whole_grads(model, head))
            del model, head, opt, single, m
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        model, head, opt, towers = build(route, loss)
        step = make_train_step(model, cfg, head, group=group, towers=towers)
        state = TrainState(model, head, opt)
        _zero_counts()
        state, m = step(state, mine)
        _sync(dev)
        res = {"loss": float(m["total_loss"]), "launches": _read_counts()}
        grads = whole_grads(model, head)
        if loss == "dino" and route == "replicated":
            dino_ref = (res["loss"], grads)
        if ref is not None and rank == 0:
            cos = {n: float(torch.nn.functional.cosine_similarity(g, ref[1][n], dim=0))
                   for n, g in grads.items()}
            res.update(ref_loss=ref[0], min_cosine=min(cos.values()),
                       min_cosine_at=min(cos, key=cos.get))
        del grads
        _sync(dev)
        dist.barrier()  # every rank starts the timed step together
        t0 = time.perf_counter()
        state, m = step(state, mine)
        float(m["total_loss"])
        _sync(dev)
        res["ms"] = (time.perf_counter() - t0) * 1e3
        res["launches_both"] = _read_counts()
        gib = lambda n: n / 2 ** 30 if cuda else 0.0  # noqa: E731
        res["peak_gib"] = gib(cuda and torch.cuda.max_memory_allocated(dev))
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        res["resident_gib"] = gib(cuda and torch.cuda.memory_allocated(dev))
        t0 = time.perf_counter()  # a checkpoint's gather
        saved = (full_state_dict(model, cpu_offload=True),
                 None if head is None else full_state_dict(head, cpu_offload=True),
                 opt.state_dict(cpu_offload=True))
        _sync(dev)
        res["save_s"] = time.perf_counter() - t0
        res["save_peak_gib"] = gib(cuda and torch.cuda.max_memory_allocated(dev))
        res["saved_tensors"] = len(saved[0]) + len(saved[2]["state"])
        del saved
        out[key] = res
        del model, head, opt, towers, step, state, ref
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    one_ms = None
    if rank == 0 and payload.get("time_one_process"):  # the per-card reference
        model, head, opt, _ = build("single", "clip")
        step = make_train_step(model, StepCfg(loss_type="clip"))
        state = TrainState(model, head, opt)
        state, _ = step(state, mine)
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, mine)
        float(m["total_loss"])
        _sync(dev)
        one_ms = (time.perf_counter() - t0) * 1e3
    dist.barrier()
    dist.destroy_process_group()
    return {"rank": rank, "cases": out, "one_process_step_ms": one_ms}


def step_case_report(ranks: list, cases, expect=(24, 24)):
    """The checks of ``_child_step``'s results (``ranks``, in rank order):
    (a line a case, the failures). A case's loss is the reference's at 1e-5
    relative and the same on every rank, every gradient at cosine >= 0.9999,
    and each rank launches ``expect`` (fused forward, backward; or a dict of
    them by case) a step."""
    lines, failed = [], []
    for loss, impl, route in cases:
        fwd, bwd = expect[(loss, impl, route)] if isinstance(expect, dict) else expect
        key = f"{loss}-{impl}-{route}"
        rs = [r["cases"][key] for r in ranks]
        r0 = rs[0]
        rel = None
        if "ref_loss" in r0:
            rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
            if rel > 1e-5 or r0["min_cosine"] < 0.9999:
                failed.append(f"{key}: loss rel {rel:.2e}, min gradient cosine "
                              f"{r0['min_cosine']} at {r0['min_cosine_at']}")
        elif (loss, route) != ("dino", "replicated"):
            failed.append(f"{key}: no reference ran")
        for r in rs:
            first, both = r["launches"], r["launches_both"]
            if ((first["fused_attention_fwd"], first["fused_attention_bwd"]) != (fwd, bwd)
                    or (both["fused_attention_fwd"], both["fused_attention_bwd"])
                    != (2 * fwd, 2 * bwd) or r["loss"] != r0["loss"]):
                failed.append(f"{key}: launches {first} (first step), {both} (two), expected "
                              f"{fwd} + {bwd} a step; loss {r['loss']} vs rank 0's {r0['loss']}")
        ref = (f"vs {r0['ref_loss']:.6f} (rel {rel:.2e}), min gradient cosine "
               f"{r0['min_cosine']:.7f} ({r0['min_cosine_at']})" if rel is not None
               else "(the reference)")
        mem = (f", peak GiB a rank {[round(r['peak_gib'], 3) for r in rs]}, resident "
               f"{[round(r['resident_gib'], 3) for r in rs]}, checkpoint gather peak "
               f"{[round(r['save_peak_gib'], 3) for r in rs]} in "
               f"{[round(r['save_s'], 2) for r in rs]} s")
        launched = [(r["launches"]["fused_attention_fwd"], r["launches"]["fused_attention_bwd"])
                    for r in rs]
        lines.append(f"{key}: loss {r0['loss']:.6f} {ref}, launches a rank a step {launched}, "
                     f"second step host clock {[round(r['ms'], 1) for r in rs]} ms{mem}")
    return lines, failed


def start_dist(work: str, carried: dict, pool, threads: int):
    """Multi-GPU training on the one card, ViT-B-16 at full width with its
    vision depth cut to ``DIST_VISION_LAYERS``. (a) World size 1 over NCCL
    through ``train.main``: the thesis protocol's training (``--precision
    amp``, batch 32, three steps; no evaluation) as one process, then as
    rank 0 of a group of one under DDP, ``--shard-opt-state`` and
    ``--fsdp``: the ranks' per-step losses equal the one process's (fp32,
    1e-5 relative), ``DIST_VISION_LAYERS`` + 12 fused launches forward and
    backward a step, host clock and peak memory beside the one process's. (b) Two ranks on the card over gloo
    (NCCL refuses two ranks on one device): first the bare collectives gloo
    carries for CUDA tensors, written to ``gloo_cuda_probe.json`` in
    ``work`` and printed (a refusal of one it carried with torch 2.11, or
    wrong numbers from any, fails the phase); then, from that file, the
    ViT-B-16 fp32 step at 2 x 32 for each case whose collectives it carries
    (``DIST_STEP_CASES``; at least one must) against the one-process step
    at 64 on the same rows (``step_case_report``), with each rank's peak
    memory over the steps and over the checkpoint's gather. Every run is a
    process of its own (in one process a run's peak memory carries part of
    what the run before it left), all submitted to ``pool`` at once with
    ``threads`` OpenMP threads each. Returns a function that waits for them,
    checks and prints, and returns the launches of every run."""
    import torch

    from scripts.mini_flickr import generate

    t_phase = time.perf_counter()
    d = generate(os.path.join(work, "dist_data"), n_train=DIST_TRAIN_IMAGES,
                 n_val=DIST_VAL_IMAGES, size_px=EVAL_SIZE_PX, dino_dim=DINO_DIM, seed=SEED)
    argv = []
    thesis = iter(_thesis_argv(d, work, "dist"))
    for a in thesis:
        if a in _EVAL_FLAGS:
            for _ in range(_EVAL_FLAGS[a]):
                next(thesis)
        else:
            argv.append(a)

    def run_argv(route, flags):
        return argv + ["--name", f"dist-{route}", "--batch-size", str(DIST_BATCH), "--epochs",
                       "1", "--aug-cfg", "scale=(1.0, 1.0)", "--save-frequency", "0", *flags]

    cut = (MODEL, DIST_VISION_LAYERS)
    blocks = DIST_VISION_LAYERS + 12  # vision + text, a forward and a backward each
    one_env = {"OMP_NUM_THREADS": str(threads)}
    runs = {"one-process": pool.submit(_child, "train", {"argv": run_argv("one-process", []),
                                                         "cut": cut}, one_env)}
    for route, flags in DIST_ROUTES:
        (runs[route],) = _submit_ranks(pool, "train", {"argv": run_argv(route, flags),
                                                       "cut": cut}, 1, 300, threads)

    carried = carried if carried is not None else _probe_gloo_cuda()
    probe_path = os.path.join(work, "gloo_cuda_probe.json")
    with open(probe_path, "w") as f:
        json.dump({"card": CARD, "torch": torch.__version__, "carried": carried}, f, indent=1)
    with open(probe_path) as f:  # the phase runs what the written probe allows
        carried = json.load(f)["carried"]
    cases = [c for c, needs in DIST_STEP_CASES if all(carried[n] is True for n in needs)]
    pair = (_submit_ranks(pool, "step", {"cases": cases, "model": MODEL, "batch": DIST_BATCH,
                                         "device": DEVICE, "backend": "gloo", "cut": cut}, 2,
                          300, threads) if cases else [])

    def finish() -> dict:
        total = {"fused_attention_fwd": 0, "fused_attention_bwd": 0, "flash_attention_fwd": 0}

        def add(launches):
            for k in total:
                total[k] += launches.get(k, 0)

        done = {route: fut.result() for route, fut in runs.items()}
        backend = "nccl" if DEVICE == "cuda" else "gloo"
        for route, _ in DIST_ROUTES:
            check(done[route]["world"] == 1 and done[route]["backend"] == backend,
                  f"dist {route}: not a NCCL group of one ({done[route]['backend']})")
        for res in done.values():
            add(res["launches"])
        base = done["one-process"]
        check(len(base["losses"]) == 3, f"dist: {len(base['losses'])} steps, expected 3")
        for route, res in done.items():
            rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], base["losses"]))
            check(len(res["losses"]) == len(base["losses"]) and rel <= 1e-5,
                  f"dist {route}: losses {res['losses']} vs one process {base['losses']}")
            for s in res["steps"]:
                check(s["fused_attention_fwd"] == blocks and s["fused_attention_bwd"] == blocks,
                      f"dist {route}: step launches {s}, expected {blocks} + {blocks}")
            step_ms = statistics.median(s["ms"] for s in res["steps"][1:])
            base_ms = statistics.median(s["ms"] for s in base["steps"][1:])
            print(f"dist {route} (world {res['world'] or 1}, {res['backend'] or 'no group'}): "
                  f"losses {[f'{x:.6f}' for x in res['losses']]} (max rel {rel:.2e} vs one "
                  f"process), step host clock {step_ms:.3f} ms (one process {base_ms:.3f}, "
                  f"overhead {step_ms - base_ms:+.3f} ms; beside the other children), peak "
                  f"{res['peak_gib']:.3f} GiB (one process {base['peak_gib']:.3f}), wall "
                  f"{res['wall_s']:.2f} s, launches {res['launches']} ({CARD})", flush=True)

        print(f"dist gloo on CUDA tensors, 2 ranks on one card (torch {torch.__version__}, "
              f"{CARD}): {json.dumps(carried)}", flush=True)
        wrong = [n for n, v in carried.items() if "wrong numbers" in str(v)]
        check(not wrong, f"dist: gloo gave wrong numbers for CUDA tensors in {wrong}")
        lost = [n for n in GLOO_CUDA_CARRIES if carried[n] is not True]
        check(not lost, f"dist: gloo no longer carries {lost} for CUDA tensors: "
              f"{ {n: carried[n] for n in lost} }")
        for c, needs in DIST_STEP_CASES:
            if c not in cases:
                print(f"dist 2-rank {'-'.join(c)}: not run, gloo does not carry "
                      f"{[n for n in needs if carried[n] is not True]} for CUDA tensors",
                      flush=True)
        check(bool(cases), "dist: no 2-rank case ran")
        ranks = [fut.result() for fut in pair]
        lines, failed = step_case_report(ranks, cases,
                                         (blocks, blocks) if DEVICE == "cuda" else (0, 0))
        for line in lines:
            print(f"dist 2-rank gloo {line} ({CARD})", flush=True)
        check(not failed, f"dist 2-rank: {failed}")
        for r in ranks:
            for res in r["cases"].values():
                add(res["launches_both"])
        print(f"dist: {time.perf_counter() - t_phase:.1f} s", flush=True)
        return total

    return finish

def _child_tp(payload: dict) -> dict:
    """A rank of the tp phase's parts (a) and (c): both ranks on the card over
    gloo, a ``(1, TP_AXIS)`` mesh. (a) ViT-B-16 in fp32 (TF32 off), DINO-soft
    with the mlp head, batch ``TP_BATCH``: on each rank the whole model's two
    steps (the one-process reference on the same rows and weights), then the
    model, head and optimizer split over the model group, with replicated
    optimizer state and under ZeRO-1 (``zero1_sharding``): each step's loss,
    every whole gradient's cosine against the reference's after the first
    step (split ones gathered), the launches of each split step (counts at 0
    just before it, read just after), its host clock and the rank's peak
    memory; one gloo all-reduce of a ``[16,257,1408]`` bf16 activation
    (EVA01-g-14's, summed in fp32 as the port does on gloo), host clock.
    (c) dinov2-giant at its width, ``TP_TEACHER_LAYERS`` of its 40 blocks,
    seeded on the card: the whole
    teacher's CLS features against its split copy's, fp32 and bf16, the
    split call's launches, and the floor: the whole teacher through the
    kernel against itself through plain attention (``"xla"``). Then parts
    (d)-(h) (``_child_tp_serve``), and the towers parts (e)-(g)
    (``_child_tp_towers``). ``payload["parts"]`` names the parts to run:
    ``"train"`` ((a) and (c)), ``"towers"`` (towers (e)-(g) and (i)) and ``"serve"``
    ((d)-(h)); all three by default."""
    import copy
    import dataclasses
    import gc
    from types import SimpleNamespace

    import torch

    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.models.dinov2 import (
        Dinov2, dinov2_cfg_from_name,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import (
        DATA_AXIS, create_mesh, tp_sharding, wrap_ddp, zero1_sharding,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import (
        _all_reduce, gather_tensor, model_parallel, shard_module,
    )
    from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
    from refining_clip_via_dinov2_representations_torch.train.distributed import (
        data_group, init_distributed_device, model_group,
    )
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, Towers, TrainState, make_train_step, train_parameters, train_splits,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ns = SimpleNamespace(device=None, force_cpu=DEVICE == "cpu", dist_url=None,
                         dist_backend="gloo", no_set_device_rank=False)
    dev = init_distributed_device(ns)
    mesh = create_mesh(model=ns.world_size, device_type=dev.type)
    mp = model_parallel(model_group())
    out = {"rank": ns.rank}
    parts = payload.get("parts", ("train", "towers", "serve"))
    if "train" not in parts:
        if "towers" in parts:
            out["towers"] = _child_tp_towers(dev, mp, payload.get("towers"))
        if "serve" in parts:
            out.update(_child_tp_serve(payload, dev, mesh, mp))
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
        return out
    cuda = dev.type == "cuda"
    gib = lambda: torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else 0.0  # noqa: E731
    base, _ = create_model(MODEL, precision="amp", device=dev, seed=SEED)
    base.train()
    torch.manual_seed(SEED + 1)
    base_head = DinoProjectionHead(base.text_projection.shape[1], DINO_DIM).to(dev)
    batch = _train_batch(get_tokenizer(MODEL), TP_BATCH, dev.type)
    cfg = StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5, soft_mode="kl_teacher",
                                                    lambda_weighted=0.2))
    schedule = scheduler.const_lr(1e-5, 0, 2)

    def run(route):
        model, head = copy.deepcopy(base), copy.deepcopy(base_head)
        sharding = towers = group = None
        splits = {}
        if route != "single":
            shard_module(model, mp)
            shard_module(head, mp, head=True)
            named, dgroup = train_parameters(model, head), mesh[DATA_AXIS].get_group()
            splits = train_splits(model, head)
            sharding = (zero1_sharding(named, dgroup, tp=mp, tp_splits=splits)
                        if route == "zero1" else tp_sharding(named, dgroup, mp, splits))
            towers, group = wrap_ddp(Towers(model, head), dev, dgroup), data_group()
        opt, _ = optim.build_optimizer(train_parameters(model, head), optim.OptimCfg(),
                                       schedule, sharding=sharding)
        step = make_train_step(model, cfg, head, group=group, towers=towers)
        state = TrainState(model, head, opt)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        res = {"losses": [], "launches": [], "ms": []}
        for i in range(2):
            _sync(dev)
            _zero_counts()  # the main path: counts at 0 just before the step
            t0 = time.perf_counter()
            state, m = step(state, batch)
            res["losses"].append(float(m["total_loss"]))
            _sync(dev)
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["launches"].append(_read_counts())  # read just after
            if i == 0:
                res["grads"] = {n: (gather_tensor(p.grad, splits[n], mp) if n in splits
                                    else p.grad).detach().double().flatten().cpu()
                                for n, p in train_parameters(model, head).items()}
        res["peak_gib"] = gib()
        del model, head, opt, towers, step, state
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return res

    ref = run("single")
    for route in ("replicated", "zero1"):
        res = run(route)
        cos = {n: float(torch.nn.functional.cosine_similarity(g, ref["grads"][n], dim=0))
               for n, g in res.pop("grads").items()}
        res.update(ref_losses=ref["losses"], ref_ms=ref["ms"], ref_peak_gib=ref["peak_gib"],
                   min_cosine=min(cos.values()), min_cosine_at=min(cos, key=cos.get))
        out[route] = res
    del base, base_head
    gc.collect()
    # one all-reduce of an EVA01-g-14 activation over gloo
    act = torch.randn(TP_EVA_BATCH, 257, 1408, device=dev).to(torch.bfloat16)
    times = []
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        _all_reduce(act, mp.group)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = statistics.median(times[1:])
    del act
    # (c) the split teacher at dinov2-giant's width, its depth cut
    tcfg = dataclasses.replace(dinov2_cfg_from_name("facebook/dinov2-giant"),
                               layers=TP_TEACHER_LAYERS)
    whole = Dinov2(tcfg, attn_impl="auto").to(dev).init_weights(SEED).eval()
    split = copy.deepcopy(whole)
    shard_module(split, mp)
    x = _teacher_pixels(TP_EVA_BATCH)
    out["teacher"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        whole.dtype = split.dtype = dtype
        with torch.no_grad():
            want = whole(x).float()
            _set_attn_impl(whole, "xla")
            plain = whole(x).float()
            _set_attn_impl(whole, "auto")
        _sync(dev)
        _zero_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            got = split(x).float()
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()
        out["teacher"][str(dtype).split(".")[-1]] = {
            "launches": counts, "ms": ms, "shape": list(got.shape), "hidden": tcfg.hidden_size,
            "finite": bool(torch.isfinite(got).all()),
            "min_cosine": float(torch.nn.functional.cosine_similarity(got, want, dim=-1).min()),
            "floor": float(torch.nn.functional.cosine_similarity(plain, want, dim=-1).min())}
    del whole, split, x, want, plain, got
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if "towers" in parts:
        out["towers"] = _child_tp_towers(dev, mp)
    if "serve" in parts:
        out.update(_child_tp_serve(payload, dev, mesh, mp))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return out


def _child_tp_towers(dev, mp, names=None) -> dict:
    """The tp pair's towers parts (e)-(g), each rank, fp32 (TF32 off), the split
    model against the whole one in this process on the same rows and weights
    (``_split_vs_whole``; the CLIP loss): (e) EVA02-L-14 at full width, its
    vision depth cut to ``TP_TOWER_LAYERS``, the sub-LN and SwiGLU norms'
    whole gradients watched; (f) EVA02-E-14's vision tower at full width,
    ``TP_TOWER_LAYERS`` of its 64 blocks, one forward (head dim 112 on 8
    local heads): features against the whole tower's and the split call's
    launches; (g) vit_relpos_medium_patch16_cls_224 and
    swin_base_patch4_window7_224 at full depth (the bias tables' whole
    gradients watched) and ViTamin-L with its ViT stage cut to
    ``TP_TOWER_LAYERS`` blocks, one step each; (i) MobileCLIP-B with its ViT
    cut to ``TP_MC_B_LAYERS`` blocks and MobileCLIP-S1 whole (its FastViT
    tower whole on each rank, its BatchNorms training), one step each.
    ``names``: the towers to run (all by default; EVA02-E-14 is (f)'s)."""
    import copy
    import dataclasses
    import gc

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, eva02, fastvit, get_tokenizer, vitamin,
    )
    from refining_clip_via_dinov2_representations_torch.models.clip import init_weights
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import shard_module
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg

    cfg = StepCfg(loss_type="clip")
    out = {}
    # (name, the trunk table and key to cut, the cut, the watched name endings)
    steps = ((EVA02_MODEL, eva02.EVA02_DIMS, "eva02_large_patch14_clip_224",
              {"layers": TP_TOWER_LAYERS}, ("attn.norm.weight", "mlp.norm.weight")),
             (ZOO_RELPOS, None, None, None, ("relative_position_bias_table",)),
             (SWIN_MODEL, None, None, None, ("relative_position_bias_table",)),
             (HYBRID_MODEL, vitamin.VITAMIN_DIMS, "vitamin_large_224",
              {"depth": TP_TOWER_LAYERS}, ()),
             (MC_B, fastvit.MCI_DIMS, "vit_base_mci_224", {"layers": TP_MC_B_LAYERS}, ()),
             (MC_S1, None, None, None, ()))
    for name, table, key, kw, watch in steps:
        if names is not None and name not in names:
            continue
        t0 = time.perf_counter()
        whole = None
        if table is not None:
            whole = table[key]
            table[key] = dataclasses.replace(whole, **kw)
        try:
            model, _ = create_model(name, device=dev, seed=SEED + 120)
        finally:
            if table is not None:
                table[key] = whole
        model.train()
        batch = _train_batch(get_tokenizer(name), TP_TOWER_BATCH, dev.type, model_name=name,
                             seed=SEED + 121)
        res = _split_vs_whole(model, mp, batch, cfg, name, watch)
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
        del model, batch
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # (f) EVA02-E-14's vision tower, one forward
    if names is not None and EVA02_E_MODEL not in names:
        return out
    t0 = time.perf_counter()
    e_cfg = dataclasses.replace(eva02.EVA02_DIMS["eva02_enormous_patch14_clip_224"],
                                layers=TP_TOWER_LAYERS)
    tower = eva02.Eva02VisionTower(e_cfg, 1024)
    init_weights(tower, SEED + 122)
    tower = tower.to(dev).eval()
    split = copy.deepcopy(tower)
    shard_module(split, mp)
    x = torch.from_numpy(np.random.default_rng(SEED + 123).normal(
        size=(TP_TOWER_BATCH, 224, 224, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        want = tower(x)
        _sync(dev)
        _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
        got = split(x)
        _sync(dev)
        counts = _read_counts()
    out[EVA02_E_MODEL] = {
        "launches": counts, "n_split": len(split.tp_splits), "shape": list(got.shape),
        "finite": bool(torch.isfinite(got).all()),
        "min_cosine": float(torch.nn.functional.cosine_similarity(got.double(), want.double(),
                                                                  dim=-1).min()),
        "seconds": time.perf_counter() - t0}
    del tower, split, x, want, got
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def tp_towers_report(ranks: list, add, names=None) -> None:
    """Checks and prints the tp pair's towers parts (e)-(g) and (i)
    (``_child_tp_towers``; ``names``: the towers that ran, all by
    default)."""
    cuda = DEVICE == "cuda"
    blocks = {EVA02_MODEL: (TP_TOWER_LAYERS, 12), ZOO_RELPOS: (0, 12), SWIN_MODEL: (0, 12),
              HYBRID_MODEL: (TP_TOWER_LAYERS, 12), MC_B: (TP_MC_B_LAYERS, 12), MC_S1: (0, 12)}
    for name, (vision, text) in blocks.items():
        if names is not None and name not in names:
            continue
        rs = [r["towers"][name] for r in ranks]
        n = vision + text if cuda else 0
        want = {"flash_attention_fwd": 0, "fused_attention_fwd": n, "fused_attention_bwd": n}
        rel = max(abs(r["loss"] - r["ref_loss"]) / abs(r["ref_loss"]) for r in rs)
        part = {EVA02_MODEL: "towers (e)", MC_B: "towers (i)", MC_S1: "towers (i)"}.get(
            name, "towers (g)")
        min_cos = TP_MC_MIN_COS if name in (MC_B, MC_S1) else 0.9999
        print(f"tp {part} {name} fp32 (1, {TP_AXIS}) split vs one process, batch "
              f"{TP_TOWER_BATCH}: loss {rs[0]['loss']:.7f} vs {rs[0]['ref_loss']:.7f} (max rel "
              f"{rel:.2e}), min gradient cosine {min(r['min_cosine'] for r in rs):.7f} "
              f"({rs[0]['min_at']}), the {rs[0]['watched']} watched whole parameters' lowest "
              f"{min(r['watched_min'] for r in rs):.7f}, {rs[0]['under']} tensors under "
              f"{COCA_FP32_NOISE:g} of the norm held by their error ({rs[0]['under_ok']}), "
              f"{rs[0]['n_split']} split tensors, launches a rank "
              f"{[r['launches'] for r in rs]} (expected {want}), "
              f"{[round(r['seconds'], 1) for r in rs]} s a rank [{CARD}]", flush=True)
        check(rel <= 1e-5 and all(r["min_cosine"] >= min_cos and r["n_grads"] and r["under_ok"]
                                  and r["n_split"] > 0 and r["watched_held"] for r in rs),
              f"tp {part} {name}: the split step disagrees with the one-process step")
        check(all(r["watched"] > 0 for r in rs) or name in (HYBRID_MODEL, MC_B, MC_S1),
              f"tp {part} {name}: no whole parameter used on a rank's part was compared")
        if name == MC_S1:  # its FastViT tower whole on each rank: only the text splits
            check(all(r["vision_split"] == 0 for r in rs),
                  f"tp {part} {name}: a FastViT tensor was split")
        check(all(r["launches"] == want for r in rs), f"tp {part} {name}: launches")
        for r in rs:
            add(r["launches"])
    if names is not None and EVA02_E_MODEL not in names:
        return
    rs = [r["towers"][EVA02_E_MODEL] for r in ranks]
    want = {"flash_attention_fwd": 0, "fused_attention_fwd": TP_TOWER_LAYERS if cuda else 0,
            "fused_attention_bwd": 0}
    print(f"tp towers (f) {EVA02_E_MODEL} vision tower at full width, {TP_TOWER_LAYERS} of 64 blocks, "
          f"fp32 split over {TP_AXIS} ranks, batch {TP_TOWER_BATCH} (8 local heads of 112): "
          f"feature cosine vs the whole tower min {min(r['min_cosine'] for r in rs):.8f} (need "
          f">= {MIN_COSINE}), {rs[0]['n_split']} split tensors, launches a rank "
          f"{[r['launches'] for r in rs]} (expected {want}), "
          f"{[round(r['seconds'], 1) for r in rs]} s a rank [{CARD}]", flush=True)
    check(all(r["finite"] and r["min_cosine"] >= MIN_COSINE and r["launches"] == want
              and r["shape"] == [TP_TOWER_BATCH, 1024] for r in rs),
          f"tp towers (f) {EVA02_E_MODEL}: the split tower disagrees with the whole one")
    for r in rs:
        add(r["launches"])


def _leader_and_followers(engine, lead) -> tuple:
    """``lead()`` on rank 0 (then ``stop``), the follower loop elsewhere;
    the launches of this rank's part, counted from 0. Returns what
    ``lead`` returned on rank 0, None elsewhere."""
    _sync()
    _zero_counts()
    got = None
    if engine.leader:
        got = lead()
        engine.stop()
    else:
        engine.follow()
    _sync()
    return got, _read_counts()


def _split_vs_whole(model, mp, batch, cfg, name: str, watch=()) -> dict:
    """One loss and every gradient of ``model`` split over the model group
    against the whole model in this process, same rows and weights:
    (losses, the lowest cosine of a gradient gathered whole and where, the
    cosine of all tensors together, the split run's launches). As the CoCa
    phase holds its fp32 step, a tensor whose gradient is under
    ``COCA_FP32_NOISE`` of the whole gradient's norm is held by its absolute
    error against that share (with seeded weights the CoCa pooler's tokens
    are nearly equal and the cross blocks' query-side gradients cancel).
    ``watch``: name endings whose gradients' count and lowest cosine are
    returned (the whole parameters a split tower uses on a rank's part)."""
    import copy

    from refining_clip_via_dinov2_representations_torch.parallel.tensor import (
        gather_tensor, shard_module,
    )

    whole = copy.deepcopy(model)
    loss_w, grads_w, _ = _model_loss_and_grads(whole, batch, cfg)
    del whole
    split = copy.deepcopy(model)
    shard_module(split, mp)
    loss_s, grads_s, counts = _model_loss_and_grads(split, batch, cfg)
    grads_s = {n: gather_tensor(g, split.tp_splits[n], mp) if n in split.tp_splits else g
               for n, g in grads_s.items()}
    n_split = len(split.tp_splits)
    vision_split = sum(n.startswith("visual.") for n in split.tp_splits)
    del split
    cos, together = _grad_cosines(grads_s, grads_w)
    whole_norm = sum(float(g.double().norm()) ** 2 for g in grads_w.values()) ** 0.5
    under = {n: float((grads_s[n].double() - g.double()).norm()) for n, g in grads_w.items()
             if float(g.double().norm()) < COCA_FP32_NOISE * whole_norm}
    held = {n: c for n, c in cos.items() if n not in under}
    worst = min(held, key=held.get)
    watched = {n: c for n, c in cos.items() if n.endswith(tuple(watch))}
    return {"loss": loss_s, "ref_loss": loss_w, "min_cosine": held[worst], "min_at": worst,
            "watched": len(watched), "watched_min": min(watched.values(), default=1.0),
            "watched_held": all(n in held for n in watched),
            "together": together, "launches": counts, "n_split": n_split,
            "vision_split": vision_split,
            "n_grads": len(grads_s) == len(grads_w), "under": len(under),
            "under_ok": all(e <= COCA_FP32_NOISE * whole_norm for e in under.values()),
            "what": name}


def _child_tp_export(out_dir: str, dev, mesh, pixels, ids) -> dict:
    """The tp pair's part (h), each rank: ``MODEL`` fp32 split over the
    mesh's model axis and exported at bucket 1 to ``out_dir``, both encoders
    reloaded with ``load_exported_sharded`` and run on one image and one
    caption (the main path: counts at 0 just before, read just after); the
    split engine's features of the same rows (rank 0); the programs' bytes
    and the tensors they hold; export and load seconds."""
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import (
        ClipInferenceEngine, load_exported_sharded,
    )
    from refining_clip_via_dinov2_representations_torch.models import create_model

    t0 = time.perf_counter()
    model = create_model(MODEL, device=dev, seed=SEED)[0]
    ex = ClipInferenceEngine(model, model.visual.image_size, model.context_length, (1,),
                             mesh=mesh)
    t1 = time.perf_counter()
    written = ex.export(out_dir)
    res = {"export_s": time.perf_counter() - t1,
           "bytes": {k: os.path.getsize(p) for k, p in written.items()},
           # tensor elements the programs hold (plain attention's scale: a scalar)
           "program_elements": sum(t.numel() for k in written if k.startswith("encode")
                                   for p in [torch.export.load(written[k])]
                                   for t in [*p.state_dict.values(), *p.constants.values()])}
    t1 = time.perf_counter()
    runs = [load_exported_sharded(out_dir, f"{op}_b1", mesh)
            for op in ("encode_image", "encode_text")]
    res["load_s"] = time.perf_counter() - t1
    _sync()
    # ---- the main path: counts at 0 just before, read just after ----
    _zero_counts()
    got = [runs[0](pixels), runs[1](ids)]
    _sync()
    res["launches"] = _read_counts()
    res["features"] = [g.cpu().numpy().tolist() for g in got]
    want, _ = _leader_and_followers(ex, lambda: (ex.encode_image(pixels), ex.encode_text(ids)))
    if ex.leader:
        res["want"] = [w.tolist() for w in want]
    res["s"] = time.perf_counter() - t0
    return res


def _child_tp_serve(payload: dict, dev, mesh, mp) -> dict:
    """The tp pair's serving and family parts (phase 21 (d)-(h)), each rank:
    (d) ViT-B-16 fp32 served at ``(1, TP_AXIS)`` through the engine's
    follower protocol (rank 0 drives) against the one-process engine on
    rank 0, same seeded weights: features, each rank's launches (12 a tower
    call at ``[8,6,197,64]`` / ``[8,4,77,64]``), request latency p50 at
    buckets 1 and 8 beside one process; (e) the serve CLI at
    ``--mesh-model-axis 2`` from the ``openai`` tag that phase 13 wrote,
    rank 0 answering ``/v1/encode_image`` and ``/v1/similarity``, against
    the one-process engine on the tag; (f) ViT-B-16-SigLIP and
    coca_ViT-L-14 at full width, every tower cut to ``TP_SERVE_LAYERS`` blocks,
    one fp32 and one bf16 loss and backward split over the model group
    against the whole model (``_split_vs_whole``); (g) a CoCa caption (the
    engine's defaults: 6 beams in 3 groups, 30 tokens) at ``(1, TP_AXIS)``
    against one process, token for token; (h) ViT-B-16 fp32 split at
    ``(1, TP_AXIS)`` exported at bucket 1 (``ClipInferenceEngine.export``:
    the rank-local programs, ``params.npz`` and the manifest) and reloaded
    onto the mesh with ``load_exported_sharded``: each rank's features of an
    image and a caption against the split engine's, its launches (12 a tower
    call), the programs' bytes and tensors (none), export and load
    seconds."""
    import copy
    import gc

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import (
        ClipInferenceEngine, create_engine, load_exported_sharded,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_model_config, get_tokenizer, register_model_config,
    )
    from refining_clip_via_dinov2_representations_torch.models import siglip
    from refining_clip_via_dinov2_representations_torch.serve import ClipServer
    from refining_clip_via_dinov2_representations_torch.serve import main as serve_main
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg

    leader = torch.distributed.get_rank() == 0
    out = {}

    def median_ms(fn, arg, n=5):
        samples = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn(arg)
            samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples)

    # (d) ViT-B-16 served on the model axis
    t0 = time.perf_counter()
    base, _ = create_model(MODEL, device=dev, seed=SEED)
    size, ctx = base.visual.image_size, base.context_length
    one = ClipInferenceEngine(copy.deepcopy(base), size, ctx, TP_SERVE_BUCKETS) if leader else None
    eng = ClipInferenceEngine(base, size, ctx, TP_SERVE_BUCKETS, mesh=mesh)
    rng = np.random.default_rng(SEED + 70)
    pixels = rng.normal(size=(5, 224, 224, 3)).astype(np.float32)
    ids = get_tokenizer(MODEL)(["a photo of a cat", "a red bicycle", "two dogs in the snow"])
    local = (eng.model.visual.transformer.resblocks[0].attn.in_proj_weight.shape[0] // 192,
             eng.model.transformer.resblocks[0].attn.in_proj_weight.shape[0] // 192)
    got, counts = _leader_and_followers(
        eng, lambda: (eng.encode_image(pixels), eng.encode_text(ids)))
    res = {"launches": counts, "local_heads": local, "tower_calls": 2}
    if leader:
        res["min_cosine"] = float(min(_cosines(got[0], one.encode_image(pixels)).min(),
                                      _cosines(got[1], one.encode_text(ids)).min()))
        res["shapes"] = [list(got[0].shape), list(got[1].shape)]

    def latency():
        lat = {}
        for b in TP_SERVE_BUCKETS:
            x, t = pixels[:1].repeat(b, 0), ids[:1].repeat(b, 0)
            lat[b] = {"tp": [median_ms(eng.encode_image, x), median_ms(eng.encode_text, t)],
                      "one": [median_ms(one.encode_image, x), median_ms(one.encode_text, t)]}
        return lat

    res["latency"], _ = _leader_and_followers(eng, latency)
    res["s"] = time.perf_counter() - t0
    out["serve_engine"] = res
    del eng, one, base
    gc.collect()
    _sync()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (h) the split engine's deployable artifact at bucket 1, reloaded onto the mesh
    out["export"] = _child_tp_export(os.path.join(os.path.dirname(payload["cache"]), "tp_export"),
                                     dev, mesh, pixels[:1], ids[:1])
    gc.collect()
    _sync()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (e) the serve CLI under the two ranks
    t0 = time.perf_counter()
    answers = {}

    def drive(httpd):
        base_url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            with urllib.request.urlopen(base_url + "/health", timeout=60) as r:
                answers["health"] = json.loads(r.read())
            answers["image"] = _post(base_url, "/v1/encode_image",
                                     {"images_b64": payload["images_b64"]})
            answers["similarity"] = _post(base_url, "/v1/similarity",
                                          {"images_b64": payload["images_b64"],
                                           "texts": payload["texts"]})
        finally:
            httpd.shutdown()

    argv = ["--model", MODEL, "--pretrained", "openai", "--cache-dir", payload["cache"],
            "--mesh-model-axis", str(TP_AXIS), "--device", DEVICE,
            "--host", "127.0.0.1", "--port", "0", "--buckets"] + [str(b) for b in TP_SERVE_BUCKETS]
    _sync()
    _zero_counts()
    serve_main(argv, on_ready=drive if leader else None)
    _sync()
    res = {"launches": _read_counts(), "tower_calls": 2 * len(TP_SERVE_BUCKETS) + 3,
           "s": time.perf_counter() - t0}
    if leader:
        ref, preprocess, tokenizer = create_engine(MODEL, pretrained="openai",
                                                   cache_dir=payload["cache"],
                                                   buckets=TP_SERVE_BUCKETS, device=dev, warm=False)
        server = ClipServer(ref, preprocess, tokenizer)
        try:
            want_f = server.encode_image_b64(payload["images_b64"])
            want_l = server.similarity(payload["texts"], payload["images_b64"])
        finally:
            server.close()
        status_i, body_i = answers["image"]
        status_s, body_s = answers["similarity"]
        res.update(health=answers["health"], status=[status_i, status_s],
                   min_cosine=float(_cosines(np.asarray(body_i["features"], np.float32),
                                             want_f).min()),
                   logits_err=float(np.abs(np.asarray(body_s["logits"]) - want_l).max()))
        del ref, server
    out["serve_cli"] = res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (f) SigLIP and CoCa split over the model group, depth cut
    width, _, heads, mlp = siglip._SIGLIP_FAMILY_DIMS["base"]
    siglip._SIGLIP_FAMILY_DIMS["base"] = (width, TP_SERVE_LAYERS, heads, mlp)
    cfg = get_model_config(SIGLIP_MODEL)
    cfg["text_cfg"]["layers"] = TP_SERVE_LAYERS
    register_model_config(SIGLIP_MODEL, cfg)
    cfg = get_model_config(COCA_MODEL)
    for tower in ("vision_cfg", "text_cfg", "multimodal_cfg"):
        cfg[tower]["layers"] = TP_SERVE_LAYERS
    register_model_config(COCA_MODEL, cfg)
    out["families"] = {}
    g = torch.Generator().manual_seed(SEED + 71)
    batches = {
        "siglip": {"images": torch.randn(TP_SERVE_BATCH, 224, 224, 3, generator=g).to(dev),
                   "texts": torch.randint(3, 32000, (TP_SERVE_BATCH, 64), generator=g).to(dev)},
        "coca": _coca_batch(get_tokenizer(COCA_MODEL), TP_SERVE_BATCH)}
    for family, name in (("siglip", SIGLIP_MODEL), ("coca", COCA_MODEL)):
        t0 = time.perf_counter()
        model, _ = create_model(name, device=dev, seed=SEED)
        model.train()
        step_cfg = StepCfg(loss_type=family)
        for dtype_name in ("float32", "bfloat16"):
            _set_compute_dtype(model, getattr(torch, dtype_name))
            out["families"][f"{family} {dtype_name}"] = _split_vs_whole(
                model, mp, batches[family], step_cfg, f"{name} {dtype_name}")
        out["families"][f"{family} s"] = time.perf_counter() - t0
        if family == "coca":
            coca = model
        else:
            del model
        gc.collect()

    # (g) a CoCa caption on the model axis
    t0 = time.perf_counter()
    coca.eval()
    _set_compute_dtype(coca, torch.float32)
    size, ctx = coca.visual.image_size, coca.context_length
    one = ClipInferenceEngine(copy.deepcopy(coca), size, ctx, (2,)) if leader else None
    eng = ClipInferenceEngine(coca, size, ctx, (2,), mesh=mesh)
    got, counts = _leader_and_followers(eng, lambda: eng.caption_tokens(pixels[:2]))
    res = {"launches": counts, "s": time.perf_counter() - t0}
    if leader:
        want = one.caption_tokens(pixels[:2])
        res.update(tokens=got.tolist(), ref_tokens=want.tolist())
        if not np.array_equal(got, want):
            x = torch.from_numpy(pixels[:2]).to(dev).to(one.dtype)
            res["divergence"] = [_caption_divergence(one.model, x[i], torch.from_numpy(got[i]).to(
                dev).long(), torch.from_numpy(want[i]).to(dev).long()) for i in range(2)]
    out["caption"] = res
    del eng, one, coca
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def tp_export_report(ranks: list) -> None:
    """Prints and checks the tp pair's part (h) (``_child_tp_export``)."""
    import numpy as np

    want_launches = {"flash_attention_fwd": 0, "fused_attention_bwd": 0,
                     "fused_attention_fwd": 24 if DEVICE == "cuda" else 0}  # 12 a tower call
    x0 = ranks[0]["export"]
    want = [np.asarray(w, np.float32) for w in x0["want"]]
    errs = [max(float(np.abs(np.asarray(g, np.float32) - w).max())
                for g, w in zip(r["export"]["features"], want)) for r in ranks]
    programs = max(v for k, v in x0["bytes"].items() if k.startswith("encode"))
    print(f"tp (h) {MODEL} fp32 split at (1, {TP_AXIS}) exported at bucket 1 and reloaded with "
          f"load_exported_sharded: max abs error vs the split engine a rank {errs} (tol "
          f"{EXPORT_TOL:g}); launches a rank over 2 tower calls "
          f"{[r['export']['launches'] for r in ranks]}; bytes {x0['bytes']}, tensor elements "
          f"in the programs {[r['export']['program_elements'] for r in ranks]}; export "
          f"{[round(r['export']['export_s'], 2) for r in ranks]} s, load "
          f"{[round(r['export']['load_s'], 2) for r in ranks]} s a rank; {x0['s']:.1f} s "
          f"[{CARD}]", flush=True)
    check(max(errs) <= EXPORT_TOL, "tp (h): the reloaded split artifact disagrees with the engine")
    check(all(r["export"]["launches"] == want_launches for r in ranks), "tp (h): launches")
    check(all(r["export"]["program_elements"] < 100 for r in ranks)
          and programs < x0["bytes"]["params"] / 100, "tp (h): the programs carry weights")


def tp_serve_report(ranks: list, add) -> None:
    """Prints and checks the tp pair's serving and family parts
    (``_child_tp_serve``) and adds their launches (``add``)."""
    import numpy as np

    on_card = DEVICE == "cuda"

    def fused(n_fwd, n_bwd=0):
        return {"flash_attention_fwd": 0, "fused_attention_fwd": n_fwd if on_card else 0,
                "fused_attention_bwd": n_bwd if on_card else 0}

    r0 = ranks[0]["serve_engine"]
    lat = {b: {k: [round(v, 3) for v in r0["latency"][str(b)][k]] for k in ("tp", "one")}
           for b in TP_SERVE_BUCKETS}
    print(f"tp (d) {MODEL} fp32 served at (1, {TP_AXIS}), rank 0 driving: features "
          f"{r0['shapes']}, min cosine vs one process {r0['min_cosine']:.8f} (need >= "
          f"{MIN_COSINE}); local heads (vision, text) a rank "
          f"{[r['serve_engine']['local_heads'] for r in ranks]}; launches a rank over "
          f"{r0['tower_calls']} tower calls {[r['serve_engine']['launches'] for r in ranks]}; "
          f"request latency p50 ms [image, text] by bucket {lat} (tp vs one process); "
          f"{r0['s']:.1f} s [{CARD}]", flush=True)
    check(r0["min_cosine"] >= MIN_COSINE and r0["shapes"] == [[5, 512], [3, 512]],
          "tp (d): the served split model disagrees with one process")
    check(all(r["serve_engine"]["local_heads"] == [12 // TP_AXIS, 8 // TP_AXIS]
              and r["serve_engine"]["launches"] == fused(12 * r0["tower_calls"])
              for r in ranks), "tp (d): local heads or launches")
    tp_export_report(ranks)
    c0 = ranks[0]["serve_cli"]
    print(f"tp (e) the serve CLI --pretrained openai --mesh-model-axis {TP_AXIS}: /health mesh "
          f"{c0['health']['mesh']}, statuses {c0['status']}, /v1/encode_image min cosine vs one "
          f"process {c0['min_cosine']:.8f}, /v1/similarity max abs error {c0['logits_err']:.3e}, "
          f"launches a rank over {c0['tower_calls']} tower calls "
          f"{[r['serve_cli']['launches'] for r in ranks]}, {c0['s']:.1f} s [{CARD}]", flush=True)
    check(c0["status"] == [200, 200] and c0["health"]["mesh"] == {"data": 1, "model": TP_AXIS}
          and c0["min_cosine"] >= MIN_COSINE and c0["logits_err"] < 1e-2,
          "tp (e): the serve CLI on two ranks disagrees with one process")
    check(all(r["serve_cli"]["launches"] == fused(12 * c0["tower_calls"]) for r in ranks),
          "tp (e): launches")
    blocks = {"siglip": (2 * TP_SERVE_LAYERS + 1,) * 2, "coca": (3 * TP_SERVE_LAYERS,) * 2}
    for key in sorted(k for k in ranks[0]["families"] if not k.endswith(" s")):
        family, dtype_name = key.split()
        rs = [r["families"][key] for r in ranks]
        f0 = rs[0]
        rel = abs(f0["loss"] - f0["ref_loss"]) / abs(f0["ref_loss"])
        loss_tol, min_cos = STEP_TOL[dtype_name]
        held = f0["together"] if dtype_name == "bfloat16" else min(r["min_cosine"] for r in rs)
        print(f"tp (f) {f0['what']} (full width, {TP_SERVE_LAYERS} blocks a tower, batch "
              f"{TP_SERVE_BATCH}) split over {TP_AXIS} ranks ({f0['n_split']} split tensors): loss "
              f"{f0['loss']:.6f} vs one process {f0['ref_loss']:.6f} (rel {rel:.2e}, tol "
              f"{loss_tol:g}); gradient cosine all together {f0['together']:.7f}, per tensor min "
              f"{f0['min_cosine']:.7f} at {f0['min_at']} ({f0['under']} tensors under "
              f"{COCA_FP32_NOISE:g} of the whole norm held by absolute error); need "
              f"{'together' if dtype_name == 'bfloat16' else 'per tensor'} >= {min_cos}; "
              f"launches a rank {[r['launches'] for r in rs]} [{CARD}]", flush=True)
        check(rel <= loss_tol and held >= min_cos and f0["n_grads"] and f0["n_split"] > 0
              and (dtype_name == "bfloat16" or all(r["under_ok"] for r in rs))
              and all(r["loss"] == f0["loss"] for r in rs),
              f"tp (f): {key} split over the model group disagrees with one process")
        check(all(r["launches"] == fused(*blocks[family]) for r in rs),
              f"tp (f) {key}: launches, expected {fused(*blocks[family])}")
        for r in rs:
            add(r["launches"])
    g0 = ranks[0]["caption"]
    same = g0["tokens"] == g0["ref_tokens"]
    print(f"tp (g) {COCA_MODEL} ({TP_SERVE_LAYERS} blocks a tower) captions 2 images at (1, "
          f"{TP_AXIS}) (6 beams in 3 groups, 30 tokens): {'equal to' if same else 'NOT equal to'}"
          f" one process token for token{'' if same else ': ' + str(g0['divergence'])}; "
          f"launches a rank {[r['caption']['launches'] for r in ranks]}; {g0['s']:.1f} s "
          f"[{CARD}]", flush=True)
    check(same, "tp (g): the split CoCa's caption differs from one process")
    check(all(r["caption"]["launches"] == fused(TP_SERVE_LAYERS) for r in ranks),
          "tp (g): launches")
    for r in ranks:
        for part in ("serve_engine", "export", "serve_cli", "caption"):
            add(r[part]["launches"])


def _tp_pair_payload(d: dict, pre: dict) -> dict:
    import base64

    images_b64 = []
    for p in sorted(os.listdir(d["img_dir"]))[:2]:
        with open(os.path.join(d["img_dir"], p), "rb") as f:
            images_b64.append(base64.b64encode(f.read()).decode())
    return {"cache": pre["cache"], "images_b64": images_b64,
            "texts": ["a photo of a dog", "a red car in the street"]}


def tp_pair(d: dict, pre: dict) -> list:
    """One pair of ``--dist-child tp`` ranks (``_child_tp``: parts (a), (c)
    and (d)-(h)) on two mini-Flickr images and the ``openai`` tag's hub
    cache; each rank's results."""
    return _children("tp", _tp_pair_payload(d, pre), TP_AXIS, timeout=600)


def start_tp(work: str, d: dict, pre: dict, pool, threads: int):
    """Config 5's multi-chip recipe at a model axis of ``TP_AXIS``, both ranks
    on the card over gloo (NCCL refuses two ranks on one device; gloo carries
    the all_reduce and all_gather that tensor parallelism needs). (a) and (c)
    in one pair of ``--dist-child tp`` processes (``_child_tp``): the TP
    ViT-B-16 step against the one-process step (loss 1e-5 relative, every
    whole gradient at cosine >= 0.9999, fp32), replicated and ZeRO-1, 24 + 24
    launches a rank a step at ``[32,6,197,64]`` and ``[32,4,77,64]``; the
    split dinov2-giant teacher against the whole one (CLS cosine >= 0.9999
    fp32, >= 0.999 bf16), 40 fused-forward launches a rank a call. (b)
    EVA01-g-14 at full width, its vision depth cut to ``TP_EVA_LAYERS``,
    through ``train.main`` with Config 5's flags (adafactor, a bf16 first
    moment, ``--grad-checkpointing`` under
    ``dots_with_no_batch_dims_saveable``) and Config 2's DINO flags, bf16,
    batch 16, on mini-Flickr cut to ``TP_EVA_IMAGES`` images with
    whole-image crops (the same rows in both runs): one process, then two
    ranks at ``--mesh-model-axis 2 --shard-opt-state``: the per-step losses
    at 1e-2 relative (the bf16 step row), each rank's peak memory beside
    the one process's, two fused-forward and one backward launch a rank a
    block a step (``TP_EVA_LAYERS`` vision + 12 text blocks, the forward
    twice with the recompute). The pair of (a) and (c), the pair of (d)-(h)
    (``tp_serve_report``), the one process and the pair of (b) are
    submitted to ``pool`` at once, ``threads`` OpenMP threads a process.
    Returns a function that waits for them, checks and prints, and returns
    the launches, the pairs' results merged by rank and (b)'s."""
    from scripts.mini_flickr import generate

    t_phase = time.perf_counter()
    payload = _tp_pair_payload(d, pre)
    pairs = [_submit_ranks(pool, "tp", {**payload, "parts": parts}, TP_AXIS, timeout=600,
                           threads=threads) for parts in (["train", "towers"], ["serve"])]
    # (b) EVA01-g-14 through train.main, one process and two ranks
    d = generate(os.path.join(work, "tp_data"), n_train=TP_EVA_IMAGES, n_val=1, size_px=224,
                 dino_dim=DINO_DIM, seed=SEED + 5)
    argv = ["--model", TP_EVA_MODEL, "--train-data", d["train_csv"], "--dataset-type", "csv",
            "--batch-size", str(TP_EVA_BATCH), "--precision", "bf16", "--opt", "adafactor",
            "--adam-mu-dtype", "bfloat16", "--grad-checkpointing", "--remat-policy",
            "dots_with_no_batch_dims_saveable", "--use_dino_general", "--soft_mode",
            "kl_teacher", "--lambda_soft", "0.5", "--teacher_temp", "0.15", "--use_projection",
            "--projection_type", "mlp", "--dino_fts_path", d["dino_feats"],
            "--dino_index_map_path", d["dino_index_map"], "--epochs", "1", "--save-frequency",
            "0", "--lr", "5e-4", "--warmup", "2", "--workers", "4", "--seed", str(SEED),
            "--log-every-n-steps", "1", "--aug-cfg", "scale=(1.0, 1.0)", "--logs", work,
            "--device", DEVICE]
    one_env = {"OMP_NUM_THREADS": str(threads)}
    one_fut = pool.submit(_child, "train", {"argv": argv + ["--name", "tp-one"],
                                            "eva_layers": TP_EVA_LAYERS}, one_env, 400)
    eva_pair = _submit_ranks(pool, "train", {"argv": argv + ["--name", "tp-2",
                                                             "--mesh-model-axis",
                                                             str(TP_AXIS), "--shard-opt-state",
                                                             "--dist-backend", "gloo"],
                                             "eva_layers": TP_EVA_LAYERS}, TP_AXIS,
                             timeout=500, threads=threads)
    return lambda: _finish_tp(t_phase, [{**a.result(), **b.result()} for a, b in zip(*pairs)],
                              one_fut, eva_pair)


def _finish_tp(t_phase: float, ranks: list, one_fut, eva_pair: list) -> dict:
    """``start_tp``'s checks and lines, once its processes end."""
    import math

    total = {"fused_attention_fwd": 0, "fused_attention_bwd": 0, "flash_attention_fwd": 0}

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    want = (24, 24) if DEVICE == "cuda" else (0, 0)
    for route in ("replicated", "zero1"):
        rs = [r[route] for r in ranks]
        r0 = rs[0]
        rels = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["ref_losses"])]
        launched = [[(c["fused_attention_fwd"], c["fused_attention_bwd"]) for c in r["launches"]]
                    for r in rs]
        print(f"tp (a) ViT-B-16 fp32 (1, {TP_AXIS}) {route}: losses {r0['losses']} vs one "
              f"process {r0['ref_losses']} (max rel {max(rels):.2e}), min gradient cosine "
              f"{min(r['min_cosine'] for r in rs):.7f} ({r0['min_cosine_at']}), launches a rank "
              f"a step {launched}, second step host clock {[round(r['ms'][1], 1) for r in rs]} "
              f"ms (one process {r0['ref_ms'][1]:.1f}), peak GiB a rank "
              f"{[round(r['peak_gib'], 3) for r in rs]} (one process "
              f"{r0['ref_peak_gib']:.3f}) [{CARD}]", flush=True)
        check(max(rels) <= 1e-5 and all(r["min_cosine"] >= 0.9999 for r in rs)
              and all(r["losses"] == r0["losses"] for r in rs),
              f"tp (a) {route}: the TP step disagrees with the one-process step")
        check(all(c == want for steps in launched for c in steps),
              f"tp (a) {route}: launches {launched}, expected {want} a rank a step")
        for r in rs:
            for c in r["launches"]:
                add(c)
    print(f"tp gloo all-reduce of a [16,257,1408] bf16 activation (fp32 sum), 2 ranks on the "
          f"card: {[round(r['allreduce_ms'], 2) for r in ranks]} ms host clock [{CARD}]",
          flush=True)
    for dtype, min_cos in TEACHER_MIN_COS.items():
        rs = [r["teacher"][dtype] for r in ranks]
        floor = min(r["floor"] for r in rs)
        if dtype == "bfloat16":
            # two bf16 paths of a seeded 40-block giant differ by more than
            # 0.999 (the kernel against plain attention: PERF.md, PR 14); the
            # split teacher must be no further from the whole than that
            min_cos = min(min_cos, floor)
        want_t = {"flash_attention_fwd": 0,
                  "fused_attention_fwd": TP_TEACHER_LAYERS if DEVICE == "cuda" else 0,
                  "fused_attention_bwd": 0}
        print(f"tp (c) dinov2-giant ({TP_TEACHER_LAYERS} of 40 blocks) split over {TP_AXIS} "
              f"ranks, {dtype}, batch {TP_EVA_BATCH}: "
              f"CLS cosine vs the whole teacher min {min(r['min_cosine'] for r in rs):.8f} "
              f"(need >= {min_cos:.8f}; the whole teacher, kernel vs plain attention, "
              f"{floor:.8f}), launches a rank {[r['launches'] for r in rs]}, host clock "
              f"{[round(r['ms'], 1) for r in rs]} ms [{CARD}]", flush=True)
        check(all(r["finite"] and r["shape"] == [TP_EVA_BATCH, r["hidden"]]
                  and r["min_cosine"] >= min_cos for r in rs),
              f"tp (c) the split teacher disagrees ({dtype})")
        check(all(r["launches"] == want_t for r in rs), f"tp (c) launches, expected {want_t}")
        for r in rs:
            add(r["launches"])

    tp_serve_report(ranks, add)
    tp_towers_report(ranks, add)

    one = one_fut.result()
    tp = [f.result() for f in eva_pair]
    steps = len(one["losses"])
    blocks = TP_EVA_LAYERS + 12  # vision + text, each recomputed once
    want_b = ((2 * blocks, blocks) if DEVICE == "cuda" else (0, 0))
    rels = [abs(a - b) / abs(b) for a, b in zip(tp[0]["losses"], one["losses"])]
    launched = [[(s["fused_attention_fwd"], s["fused_attention_bwd"]) for s in r["steps"]]
                for r in tp]
    print(f"tp (b) {TP_EVA_MODEL} Config 5 flags + --mesh-model-axis {TP_AXIS} "
          f"--shard-opt-state (full width, {TP_EVA_LAYERS} of 40 vision blocks, bf16, batch "
          f"{TP_EVA_BATCH}, {steps} steps): "
          f"losses {tp[0]['losses']} vs one process {one['losses']} (max rel {max(rels):.2e}); "
          f"step host clock a rank {[[round(s['ms'], 1) for s in r['steps']] for r in tp]} ms "
          f"(one process {[round(s['ms'], 1) for s in one['steps']]}); peak GiB a rank "
          f"{[round(r['peak_gib'], 3) for r in tp]} (one process {one['peak_gib']:.3f}); wall "
          f"{[round(r['wall_s'], 1) for r in tp]} s (one process {one['wall_s']:.1f}); launches "
          f"a rank a step {launched} [{CARD}]", flush=True)
    check(steps >= 2 and len(tp[0]["losses"]) == steps and max(rels) <= STEP_TOL["bfloat16"][0]
          and all(math.isfinite(x) for x in tp[0]["losses"])
          and tp[0]["losses"] == tp[1]["losses"] and all(r["world"] == TP_AXIS for r in tp),
          "tp (b): the two-rank EVA01-g-14 run disagrees with the one process")
    check(all(c == want_b for steps_ in launched for c in steps_),
          f"tp (b): launches {launched}, expected {want_b} a rank a step")
    add(one["launches"])
    for r in tp:
        add(r["launches"])
    print(f"tp: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": total, "ranks": ranks, "eva": {"one": one, "tp": tp}}


def _cut_vision_depth(model_name: str, layers: int, text_layers: int = None) -> None:
    """Registers ``model_name`` with its vision tower cut to ``layers``
    blocks (and its text tower to ``text_layers`` where given), for every
    later build in this process."""
    from refining_clip_via_dinov2_representations_torch.models import (
        get_model_config, register_model_config,
    )

    cfg = get_model_config(model_name)
    cfg["vision_cfg"]["layers"] = layers
    if text_layers is not None:
        cfg["text_cfg"]["layers"] = text_layers
    register_model_config(model_name, cfg)


def _set_compute_dtype(model, dtype) -> None:
    """Every tower of ``model`` to compute in ``dtype`` (parameters stay)."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype


def _coca_batch(tokenizer, n: int, seed: int = SEED + 50) -> dict:
    """Seeded pixels at 224 px and n distinct captions (76 tokens)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    captions = [f"a {['red', 'green', 'blue'][i % 3]} {['cube', 'ball', 'cone', 'ring'][i % 4]} "
                f"number {i * 7 + 3} on a table in scene {i % 5}" for i in range(n)]
    return {"images": torch.from_numpy(rng.normal(size=(n, 224, 224, 3)).astype(
                np.float32)).to(DEVICE),
            "texts": torch.from_numpy(tokenizer(captions)).long().to(DEVICE)}


def _model_loss_and_grads(model, batch, cfg) -> tuple:
    """(loss, {name: gradient}, launches) of one loss of ``cfg`` (a
    ``StepCfg``) and its backward over ``model``'s parameters."""
    import torch

    from refining_clip_via_dinov2_representations_torch.train.step import make_loss_fn

    for p in model.parameters():
        p.grad = None
    _zero_counts()
    loss, _ = make_loss_fn(model, cfg)(batch, 0)
    loss.backward()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    counts = _read_counts()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), grads, counts


# fp32 CoCa step: a tensor whose gradient is under this share of the whole
# gradient's norm is cancellation (with seeded weights the pooler's 255
# image tokens are nearly equal, so the cross-attention blocks' query-side
# LayerNorm gradients cancel to ~5e-8 of the whole): its cosine measures
# rounding, so it is held by its absolute error against the same share
COCA_FP32_NOISE = 1e-6


def _coca_step_vs_plain(model, batch, name: str) -> None:
    """One CoCa loss and gradient through the kernels against plain attention
    on the same weights: ``STEP_TOL`` (bf16: all tensors together; fp32:
    every tensor whose gradient is at least ``COCA_FP32_NOISE`` of the whole
    gradient's norm, the others to that share in absolute error)."""
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg

    loss_tol, min_cos = STEP_TOL[name]
    _set_attn_impl(model, "auto")
    loss_k, grads_k, _ = _model_loss_and_grads(model, batch, StepCfg(loss_type="coca"))
    _set_attn_impl(model, "xla")
    loss_p, grads_p, _ = _model_loss_and_grads(model, batch, StepCfg(loss_type="coca"))
    _set_attn_impl(model, "auto")
    check(grads_k.keys() == grads_p.keys() and len(grads_k) == len(list(model.parameters())),
          "the two CoCa runs have different gradients")
    cos, together = _grad_cosines(grads_k, grads_p)
    whole = sum(float(g.double().norm()) ** 2 for g in grads_p.values()) ** 0.5
    norm = {n: float(g.double().norm()) for n, g in grads_p.items()}
    under = {n: float((grads_k[n].double() - g.double()).norm())
             for n, g in grads_p.items() if norm[n] < COCA_FP32_NOISE * whole}
    held_cos = {n: c for n, c in cos.items() if n not in under or name == "bfloat16"}
    worst = min(held_cos, key=held_cos.get)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    if name == "bfloat16":
        held, under_ok, under_note = together, True, ""
    else:
        held = held_cos[worst]
        under_ok = all(e <= COCA_FP32_NOISE * whole for e in under.values())
        big = max(under, key=under.get) if under else None
        under_note = (f"; {len(under)} tensors under {COCA_FP32_NOISE:g} of the whole gradient's "
                      f"norm {whole:.4e} (cosines {min(cos[n] for n in under):.7f}-"
                      f"{max(cos[n] for n in under):.7f}, gradient norms "
                      f"{min(norm[n] for n in under):.3e}-{max(norm[n] for n in under):.3e}), "
                      f"largest absolute error {under[big]:.3e} at {big} (need <= "
                      f"{COCA_FP32_NOISE * whole:.3e})" if under else "")
    print(f"coca step {COCA_MODEL} {name} batch {batch['images'].shape[0]}: loss {loss_k:.6f} "
          f"through the kernels vs {loss_p:.6f} plain (rel {rel:.2e}, tol {loss_tol:g}); "
          f"gradient cosine per tensor min {cos[worst]:.7f} at {worst} "
          f"({sum(held_cos[n] < min_cos for n in held_cos)} of {len(held_cos)} below "
          f"{min_cos}), all together {together:.7f} (need "
          f"{'together' if name == 'bfloat16' else 'per tensor'} >= {min_cos}){under_note}",
          flush=True)
    check(rel <= loss_tol and held >= min_cos and under_ok,
          f"the {name} CoCa step through the kernels disagrees with plain attention")


def _caption_divergence(model, image, got, want) -> str:
    """Where two captions of one image first differ: the step and the top-2
    gap of the plain route's logits there."""
    import torch

    diff = (got != want).nonzero()
    if not len(diff):
        return "equal"
    t = int(diff[0, 0])
    with torch.no_grad():
        logits = model.decode_logits(image[None], want[None, :t])[0, -1].float()
    top = torch.topk(logits, 2).values
    return f"first differ at step {t}, top-2 logit gap {float(top[0] - top[1]):.3e} there"


def phase_coca(work: str, d: dict) -> dict:
    """CoCa at coca_ViT-L-14's full width, its vision depth cut to
    ``COCA_VISION_LAYERS`` of 24 blocks (phase 22; vision 1024 wide, 257
    tokens, pooler 256 queries x 8 heads into 768; text 12 x 768 with the
    appended CLS; decoder 12 self + 12 cross blocks at 768 over 255 image
    tokens into 49,408 tokens; 638,450,177 parameters at full depth),
    seeded:
    (a) written in open_clip's layout into the hub cache of
    ``COCA_TAG``, loaded by tag, exact; (b) an fp32 engine and the HTTP
    server: ``/v1/caption`` for 1 and 8 mini-Flickr images at the defaults
    (6 beams in 3 groups, 30 tokens) and once with custom parameters,
    ``/v1/encode_image`` and ``/v1/encode_text``; a fused-forward launch a
    vision block a caption call (the vision tower; the text tower, the
    poolers and the cached decode take plain attention), ``decode_logits`` through the
    kernels against plain attention (cosine >= 0.9999), the captions
    against the plain-attention engine's token for token (a divergence is
    printed with the step and the top-2 logit gap there), the caption
    latency cached and uncached; (c) the CoCa step, bf16 at batch 32, three
    steps of a forward and a backward launch a block (the vision blocks,
    the decoder's 12 causal self-attention calls at ``[32,12,75,64]`` and 12 cross-attention
    calls at ``[32,12,75,255,64]``), one step against plain attention
    (``STEP_TOL`` bf16), one fp32 step with TF32 off at batch 8 against
    plain attention (``STEP_TOL`` fp32), the host clock and peak memory;
    (d) ``train.main`` with ``--pretrained`` the tag, bf16, batch 32, one
    epoch on mini-Flickr rows (the caption loss in the run's loss records
    and ``val_generative_loss`` in its evaluations), whose final checkpoint
    loads strictly into an engine that captions. Returns the launches."""
    import base64
    import math

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, create_model_and_transforms, get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.models.coca import generate_beam
    from refining_clip_via_dinov2_representations_torch.models.pretrained import (
        get_pretrained_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.serve import ClipServer, make_http_server
    from refining_clip_via_dinov2_representations_torch.train.optim import (
        OptimCfg, build_optimizer,
    )
    from refining_clip_via_dinov2_representations_torch.train.scheduler import cosine_lr
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, TrainState, make_train_step,
    )

    t_phase = time.perf_counter()
    total = {"fused_attention_fwd": 0, "fused_attention_bwd": 0, "flash_attention_fwd": 0}

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    # ---- (a) seeded weights in the hub cache of the tag, loaded by tag ----
    _cut_vision_depth(COCA_MODEL, COCA_VISION_LAYERS)
    vision = COCA_VISION_LAYERS  # fused launches a vision forward; the decoder's 24 besides
    t0 = time.perf_counter()
    src, _ = create_model(COCA_MODEL, device="cpu", seed=SEED + 40)
    n_params = sum(p.numel() for p in src.parameters())
    sd = src.state_dict()
    del src
    hub_id = get_pretrained_cfg(COCA_MODEL, COCA_TAG)["hf_hub"].rstrip("/")
    cache = os.path.join(work, "coca_hub")
    repo = os.path.join(cache, "models--" + hub_id.replace("/", "--"))
    snap = os.path.join(repo, "snapshots", HUB_REV)
    os.makedirs(os.path.join(repo, "refs"))
    os.makedirs(snap)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(HUB_REV)
    torch.save(sd, os.path.join(snap, "open_clip_pytorch_model.bin"))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, pp_val = create_model_and_transforms(COCA_MODEL, pretrained=COCA_TAG,
                                                cache_dir=cache, device=DEVICE)
    load_s = time.perf_counter() - t0
    exact = _exactly(model, sd)
    pooler = sorted(k for k in sd if k.startswith("visual.attn_pool.attn."))
    print(f"coca (a): seeded {COCA_MODEL}, {n_params:,} parameters, written in {write_s:.2f} s "
          f"({os.path.getsize(os.path.join(snap, 'open_clip_pytorch_model.bin')) / 2**30:.3f} "
          f"GiB, open_clip layout, hub cache of {hub_id}), loaded by tag {COCA_TAG} in "
          f"{load_s:.2f} s; the written values exactly: {exact}; pooler keys {pooler}",
          flush=True)
    check(exact, "the CoCa checkpoint loaded by tag differs from the written one")
    want_params = COCA_FULL_PARAMS - (24 - COCA_VISION_LAYERS) * COCA_VISION_BLOCK
    check(n_params == want_params, f"coca_ViT-L-14 at {COCA_VISION_LAYERS} vision blocks has "
                                   f"{n_params:,} parameters, expected {want_params:,}")
    del sd

    # ---- (b) serving, fp32 ----
    tokenizer = get_tokenizer(COCA_MODEL)
    engine = ClipInferenceEngine(model, image_size=model.visual.image_size,
                                 context_length=model.context_length, buckets=COCA_BUCKETS)
    server = ClipServer(engine, pp_val, tokenizer)
    httpd = make_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    paths = sorted(os.listdir(d["img_dir"]))[:8]
    images_b64 = []
    for p in paths:
        with open(os.path.join(d["img_dir"], p), "rb") as f:
            images_b64.append(base64.b64encode(f.read()).decode())
    custom = dict(seq_len=20, num_beams=4, num_beam_groups=2, min_seq_len=3,
                  repetition_penalty=1.2, length_penalty=0.8)
    served = {}
    try:
        for what, imgs, gen in (("1 image", images_b64[:1], {}), ("8 images", images_b64, {}),
                                ("custom 8 images", images_b64, custom)):
            # ---- the main path: counts at 0 just before, read just after ----
            _zero_counts()
            t0 = time.perf_counter()
            status, body = _post(base, "/v1/caption", {"images_b64": imgs, **gen})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = _read_counts()
            add(counts)
            served[what] = body.get("captions")
            print(f"coca (b) /v1/caption {what} {gen or 'defaults'}: status {status}, "
                  f"{ms:.1f} ms, launches {counts} (expected {vision} fused forward), captions "
                  f"{body.get('captions', body)[:2]}", flush=True)
            check(status == 200 and len(body["captions"]) == len(imgs)
                  and all(isinstance(c, str) for c in body["captions"]),
                  f"/v1/caption {what} answered {status}: {body}")
            check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": vision,
                             "fused_attention_bwd": 0}, f"a caption call launched {counts}")
        texts = ["a red cube on a table", "a blue ball"]
        status_i, feats_i = _post(base, "/v1/encode_image", {"images_b64": images_b64[:2]})
        status_t, feats_t = _post(base, "/v1/encode_text", {"texts": texts})
        fi, ft = np.asarray(feats_i["features"]), np.asarray(feats_t["features"])
        print(f"coca (b) /v1/encode_image {status_i} {fi.shape}, /v1/encode_text {status_t} "
              f"{ft.shape}; norms {np.linalg.norm(fi, axis=-1).round(6).tolist()} "
              f"{np.linalg.norm(ft, axis=-1).round(6).tolist()}", flush=True)
        check(status_i == status_t == 200 and fi.shape == (2, 768) and ft.shape == (2, 768)
              and np.allclose(np.linalg.norm(fi, axis=-1), 1, atol=1e-5)
              and np.allclose(np.linalg.norm(ft, axis=-1), 1, atol=1e-5),
              "the CoCa engine's encoders")
        status, body = _post_status(base, "/v1/caption", {"images_b64": images_b64[:1],
                                                          "num_beams": 20})
        check(status == 400, f"a bad caption parameter answered {status}: {body}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()

    # decode_logits and captions through the kernels against plain attention
    pixels = torch.from_numpy(server._decode_images(images_b64)).to(DEVICE)
    batch = _coca_batch(tokenizer, 8)
    with torch.no_grad():
        _zero_counts()
        got = model.decode_logits(pixels.to(engine.dtype), batch["texts"][:, :-1]).float()
        torch.cuda.synchronize()
        counts = _read_counts()
        _set_attn_impl(model, "xla")
        want = model.decode_logits(pixels.to(engine.dtype), batch["texts"][:, :-1]).float()
        _set_attn_impl(model, "auto")
    add(counts)
    cos = torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=-1).min().item()
    print(f"coca (b) decode_logits {tuple(got.shape)} fp32: launches {counts} (expected "
          f"{vision + 24} fused forward: vision {vision}, decoder 24), cosine vs plain attention min {cos:.8f} "
          f"(need >= {MIN_COSINE})", flush=True)
    check(counts["fused_attention_fwd"] == vision + 24 and cos >= MIN_COSINE,
          "decode_logits through the kernels disagrees with plain attention")
    host = pixels.cpu().numpy()
    kernel_tokens = torch.from_numpy(engine.caption_tokens(host))
    _set_attn_impl(model, "xla")
    plain_tokens = torch.from_numpy(engine.caption_tokens(host))
    _set_attn_impl(model, "auto")
    notes = [_caption_divergence(model, pixels[i].to(engine.dtype), kernel_tokens[i].to(DEVICE),
                                 plain_tokens[i].to(DEVICE)) for i in range(len(host))]
    same = sum(n == "equal" for n in notes)
    print(f"coca (b) captions through the kernels vs the plain-attention engine: {same} of "
          f"{len(notes)} equal token for token; {notes}", flush=True)
    decoded = []
    for row in kernel_tokens.tolist():  # as the server reads a row
        body = row[1:] if row[0] == 49406 else row
        decoded.append(tokenizer.decode(body[:body.index(49407)] if 49407 in body
                                        else body).strip())
    check(decoded == served["8 images"], "the served captions are not the engine's")

    # caption latency: cached decode at the defaults, the re-decode at 10 tokens
    lat = {}
    for n in (1, 8):
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.caption_tokens(host[:n])
            samples.append((time.perf_counter() - t0) * 1e3)
        lat[f"cached b{n} 30 tokens"] = statistics.median(samples)
    x1 = pixels[:1].to(engine.dtype)
    for use_cache in (True, False):
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate_beam(model, x1, seq_len=10, use_cache=use_cache)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        lat[f"{'cached' if use_cache else 'uncached'} b1 10 tokens"] = statistics.median(samples)
    print(f"time coca caption fp32, 6 beams in 3 groups, median of 3 (host clock, ms): "
          f"{ {k: round(v, 2) for k, v in lat.items()} } [{CARD}]", flush=True)

    # ---- (c) the CoCa step: bf16 at batch 32, then fp32 at batch 8 ----
    del engine, server
    model.train()
    _set_compute_dtype(model, torch.bfloat16)
    batch = _coca_batch(tokenizer, COCA_BATCH)
    _coca_step_vs_plain(model, batch, "bfloat16")
    optimizer, _ = build_optimizer(dict(model.named_parameters()),
                                   OptimCfg(text_tower_style="custom_text"),
                                   cosine_lr(5e-4, 0, 10))
    state = TrainState(model, None, optimizer, 0, torch.Generator().manual_seed(SEED))
    train_step = make_train_step(model, StepCfg(loss_type="coca"))
    losses = []
    # ---- the main path: counts at 0 just before, read just after ----
    _zero_counts()
    for _ in range(COCA_STEPS):
        state, metrics = train_step(state, batch)
        losses.append((float(metrics["total_loss"]), float(metrics["caption_loss"])))
    torch.cuda.synchronize()
    counts = _read_counts()
    add(counts)
    step = vision + 24  # a forward and a backward launch a block a step
    want_counts = {"flash_attention_fwd": 0, "fused_attention_fwd": step * COCA_STEPS,
                   "fused_attention_bwd": step * COCA_STEPS}
    torch.cuda.reset_peak_memory_stats()
    host_ms = host_step_ms(lambda: train_step(state, batch), steps=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"coca (c) train step {COCA_MODEL} bf16 batch {COCA_BATCH}: (total, caption) losses "
          f"{losses}; launches {counts} over {COCA_STEPS} steps, expected {want_counts}; host "
          f"clock {host_ms:.3f} ms a step ({COCA_BATCH / host_ms * 1e3:.1f} samples/s); peak "
          f"{peak:.3f} GiB [{CARD}]", flush=True)
    check(counts == want_counts and all(math.isfinite(a) and math.isfinite(b)
                                        for a, b in losses), f"the CoCa steps: {counts}")
    state.optimizer = optimizer = train_step = None
    torch.cuda.empty_cache()
    _set_compute_dtype(model, torch.float32)
    _coca_step_vs_plain(model, _coca_batch(tokenizer, COCA_FP32_BATCH, seed=SEED + 51),
                        "float32")
    del model, state
    torch.cuda.empty_cache()

    # ---- (d) train.main with the tag, bf16, batch 32, one epoch ----
    rows = {}
    for split, n in (("train", 2 * COCA_BATCH), ("val", COCA_BATCH)):
        with open(d[f"{split}_csv"]) as f:
            lines = f.readlines()
        rows[split] = os.path.join(work, f"coca_{split}.csv")
        with open(rows[split], "w") as f:
            f.writelines(lines[:n + 1])
    argv = ["--model", COCA_MODEL, "--pretrained", COCA_TAG, "--cache-dir", cache,
            "--train-data", rows["train"], "--val-data", rows["val"], "--dataset-type", "csv",
            "--precision", "bf16", "--batch-size", str(COCA_BATCH), "--epochs", "1",
            "--save-frequency", "0", "--workers", "4", "--seed", str(SEED),
            "--log-every-n-steps", "1", "--logs", work, "--name", "coca_cli",
            "--device", DEVICE]
    records, counts, wall, seconds = _eval_cli_run(argv)
    add(counts)
    want_counts = {"flash_attention_fwd": 0, "fused_attention_fwd": step * 2 + step * 2,
                   "fused_attention_bwd": step * 2}  # 2 steps; an eval batch before and after
    run = os.path.join(work, "coca_cli")
    with open(os.path.join(run, "final_itm_results.json")) as f:
        evals = [(e["epoch"], e["results"][0]["metrics"]) for e in json.load(f)]
    gen_losses = [m.get("val_generative_loss") for _, m in evals]
    caption_losses = [r.get("caption_loss") for r in records]
    final = os.path.join(run, "checkpoints", "final_torch_state.pt")
    served_model, _ = create_model(COCA_MODEL, pretrained=final, device=DEVICE)
    engine = ClipInferenceEngine(served_model, image_size=served_model.visual.image_size,
                                 context_length=served_model.context_length, buckets=(1,))
    tokens = engine.caption_tokens(host[:1])
    print(f"coca (d) train.main {COCA_MODEL} --pretrained {COCA_TAG} bf16 batch {COCA_BATCH} "
          f"on {2 * COCA_BATCH} + {COCA_BATCH} mini-Flickr rows: {len(records)} steps, caption "
          f"losses {caption_losses}, total {[r['total_loss'] for r in records]}; evaluations "
          f"{[e for e, _ in evals]} with val_generative_loss {gen_losses}; wall {wall:.2f} s "
          f"(train {seconds.get('train_one_epoch', 0):.2f} s, evaluation "
          f"{seconds.get('evaluate', 0):.2f} s); launches {counts}, expected {want_counts}; "
          f"final_torch_state.pt loads strictly and captions {tokens[0].tolist()[:12]}... "
          f"[{CARD}]", flush=True)
    check(counts == want_counts, f"the CoCa CLI run launched {counts}, expected {want_counts}")
    check(len(records) == 2 and all(c is not None and math.isfinite(c) for c in caption_losses),
          "the CoCa CLI run's caption losses")
    check([e for e, _ in evals] == [0, 1] and all(g is not None and math.isfinite(g)
                                                  for g in gen_losses),
          f"the CoCa CLI run's evaluations lack val_generative_loss: {evals}")
    check(tokens.shape == (1, 30) and tokens[0, 0] == 49406, "the trained CoCa does not caption")
    del served_model, engine
    torch.cuda.empty_cache()
    print(f"coca: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": total, "latency_ms": lat, "step_ms": host_ms, "peak_gib": peak}


def _siglip_batch(tokenizer, n: int, seed: int = SEED + 60) -> dict:
    """Seeded pixels at 224 px and n distinct captions (64 tokens)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    captions = [f"a photo of a {['red', 'green', 'blue', 'black'][i % 4]} "
                f"{['cat', 'dog', 'car', 'boat', 'bird'][i % 5]} number {i} in the park"
                for i in range(n)]
    return {"images": torch.from_numpy(rng.normal(size=(n, 224, 224, 3)).astype(
                np.float32)).to(DEVICE),
            "texts": torch.from_numpy(tokenizer(captions)).long().to(DEVICE)}


def _siglip_step_vs_plain(model, batch, name: str, want_counts: dict) -> dict:
    """One SigLIP loss and every gradient through the kernels against plain
    attention on the same weights, ``STEP_TOL``: bf16 all tensors together,
    fp32 every tensor. The kernel run's launches must be ``want_counts``;
    the tensors with the lowest cosines are printed with their share of the
    whole gradient's norm."""
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg

    cfg = StepCfg(loss_type="siglip", siglip_dist_impl="bidir")
    loss_tol, min_cos = STEP_TOL[name]
    _set_attn_impl(model, "auto")
    loss_k, grads_k, counts = _model_loss_and_grads(model, batch, cfg)
    _set_attn_impl(model, "xla")
    loss_p, grads_p, _ = _model_loss_and_grads(model, batch, cfg)
    _set_attn_impl(model, "auto")
    check(grads_k.keys() == grads_p.keys() and len(grads_k) == len(list(model.parameters())),
          "the two SigLIP runs have different gradients")
    cos, together = _grad_cosines(grads_k, grads_p)
    whole = sum(float(g.double().norm()) ** 2 for g in grads_p.values()) ** 0.5
    lowest = sorted(cos, key=cos.get)[:3]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    held = together if name == "bfloat16" else cos[lowest[0]]
    shares = [(n, round(cos[n], 7), f"{float(grads_p[n].double().norm()) / whole:.1e}")
              for n in lowest]
    need = "together" if name == "bfloat16" else "per tensor"
    print(f"siglip step {SIGLIP_MODEL} {name} batch {batch['images'].shape[0]}: loss "
          f"{loss_k:.6f} through the kernels vs {loss_p:.6f} plain (rel {rel:.2e}, tol "
          f"{loss_tol:g}); gradient cosine all tensors together {together:.7f}, per tensor "
          f"lowest {shares} (cosine, share of the whole norm {whole:.4e}); "
          f"{sum(c < min_cos for c in cos.values())} of {len(cos)} below {min_cos} (need "
          f"{need} >= {min_cos}); kernel run launches {counts}, expected {want_counts}",
          flush=True)
    check(counts == want_counts, f"the {name} SigLIP step launched {counts}")
    check(rel <= loss_tol and held >= min_cos,
          f"the {name} SigLIP step through the kernels disagrees with plain attention")
    return {"loss": loss_k, "together": together, "min_cosine": cos[lowest[0]]}


def _write_siglip_shards(d: dict, out: str) -> str:
    """Four tar shards in the webdataset layout from mini-Flickr's train rows:
    ``SIGLIP_SHARD_SAMPLES`` samples each of a JPEG and its caption as
    ``.txt``, one sample's caption in a ``.json`` member instead. Returns
    the brace pattern."""
    import csv
    import io
    import tarfile

    from PIL import Image

    with open(d["train_csv"]) as f:
        rows = [(r["filepath"], r["title"]) for r in csv.DictReader(f)]
    os.makedirs(out, exist_ok=True)
    jpeg = {}
    for s in range(4):
        with tarfile.open(os.path.join(out, f"shards-{s:05d}.tar"), "w") as tf:
            for i in range(SIGLIP_SHARD_SAMPLES):
                path, caption = rows[(s * SIGLIP_SHARD_SAMPLES + i) % len(rows)]
                if path not in jpeg:
                    buf = io.BytesIO()
                    with Image.open(path) as img:
                        img.convert("RGB").save(buf, format="JPEG", quality=90)
                    jpeg[path] = buf.getvalue()
                text = (("json", json.dumps({"caption": caption}).encode()) if (s, i) == (2, 5)
                        else ("txt", caption.encode()))
                for ext, data in (("jpg", jpeg[path]), text):
                    info = tarfile.TarInfo(f"{s:02d}{i:05d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return os.path.join(out, "shards-{00000..00003}.tar")


def phase_siglip(work: str, d: dict) -> dict:
    """SigLIP at ViT-B-16-SigLIP's full width and depth (phase 23; vision 12
    x 768 over 196 patch tokens, no CLS, the MAP head's probe; text 12 x 768
    over 64 tokens, no causal mask, last-token pooling, a biased
    projection; 203,155,970 parameters), seeded: (a) written with the
    committed c4-en vocabulary (``tokenizer.json``) and a T5
    ``tokenizer_config.json`` into the hub repo of the ``webli`` tag, loaded
    by ``create_model`` and ``get_tokenizer`` from that cache, exact; (b)
    serving fp32 through ``ClipInferenceEngine`` and the HTTP server: 13
    fused-forward launches a vision call (12 blocks and the head), 12 a
    text call, features through the kernels against plain attention
    (cosine >= 0.9999); (c) the step: bf16 at ``SIGLIP_BATCH`` with
    ``--grad-checkpointing``, one loss and gradient against plain attention
    (``STEP_TOL`` bf16; 25 + 24 forward and 25 backward launches: the blocks
    recompute, the head does not), three steps' launches, host clock,
    CUDA-event time and peak memory; fp32 (TF32 off) at
    ``SIGLIP_FP32_BATCH`` against plain attention (``STEP_TOL`` fp32, every
    tensor); (d) Config 4's flags through ``train.main`` (``--siglip
    --precision bf16 --dataset-type webdataset --loss-dist-impl bidir
    --grad-checkpointing``, batch 128, ``--pretrained webli --cache-dir``)
    on four tar shards written from mini-Flickr: per-step losses,
    samples/s, wall, launches. Returns the launches."""
    import base64
    import math
    import shutil

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, create_model_and_transforms, get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.models.pretrained import (
        get_pretrained_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.serve import ClipServer, make_http_server
    from refining_clip_via_dinov2_representations_torch.train.optim import (
        OptimCfg, build_optimizer,
    )
    from refining_clip_via_dinov2_representations_torch.train.scheduler import cosine_lr
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, TrainState, make_train_step,
    )

    t_phase = time.perf_counter()
    total = {"fused_attention_fwd": 0, "fused_attention_bwd": 0, "flash_attention_fwd": 0}

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    # ---- (a) the seeded hub repo of the tag, loaded by tag ----
    t0 = time.perf_counter()
    src, _ = create_model(SIGLIP_MODEL, device="cpu", seed=SEED + 60)
    n_params = sum(p.numel() for p in src.parameters())
    sd = src.state_dict()
    del src
    hub_id = get_pretrained_cfg(SIGLIP_MODEL, SIGLIP_TAG)["hf_hub"].rstrip("/")
    cache = os.path.join(work, "siglip_hub")
    repo = os.path.join(cache, "models--" + hub_id.replace("/", "--"))
    snap = os.path.join(repo, "snapshots", HUB_REV)
    os.makedirs(os.path.join(repo, "refs"))
    os.makedirs(snap)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(HUB_REV)
    torch.save(sd, os.path.join(snap, "open_clip_pytorch_model.bin"))
    shutil.copy(os.path.join(os.path.dirname(os.path.abspath(__file__)), SIGLIP_VOCAB),
                os.path.join(snap, "tokenizer.json"))
    with open(os.path.join(snap, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "T5Tokenizer", "eos_token": "</s>", "unk_token": "<unk>",
                   "pad_token": "</s>", "extra_ids": 0, "model_max_length": 64}, f)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, pp_val = create_model_and_transforms(SIGLIP_MODEL, pretrained=SIGLIP_TAG,
                                                cache_dir=cache, device=DEVICE)
    load_s = time.perf_counter() - t0
    tokenizer = get_tokenizer(SIGLIP_MODEL, cache_dir=cache)
    exact = _exactly(model, sd)
    gib = os.path.getsize(os.path.join(snap, "open_clip_pytorch_model.bin")) / 2**30
    print(f"siglip (a): seeded {SIGLIP_MODEL}, {n_params:,} parameters, written in "
          f"{write_s:.2f} s ({gib:.3f} GiB, open_clip CustomTextCLIP layout: visual.trunk.* + text.*, hub repo {hub_id} "
          f"with tokenizer.json and tokenizer_config.json), loaded by tag {SIGLIP_TAG} in "
          f"{load_s:.2f} s; the written values exactly: {exact}; tokenizer "
          f"{type(tokenizer).__name__}, pad {tokenizer.pad_token_id}, eos "
          f"{tokenizer.eos_token_id}", flush=True)
    check(exact, "the SigLIP checkpoint loaded by tag differs from the written one")
    check(n_params == 203_155_970, f"ViT-B-16-SigLIP has {n_params:,} parameters")
    check(type(tokenizer).__name__ == "HFTokenizer", "the SigLIP tokenizer")
    del sd

    # ---- (b) serving, fp32 ----
    engine = ClipInferenceEngine(model, image_size=model.visual.image_size,
                                 context_length=model.context_length, buckets=SIGLIP_BUCKETS)
    engine.warmup()
    paths = sorted(os.listdir(d["img_dir"]))[:8]
    images_b64, pixels = [], []
    for p in paths:
        with open(os.path.join(d["img_dir"], p), "rb") as f:
            raw = f.read()
        images_b64.append(base64.b64encode(raw).decode())
    captions = ["a photo of a cat", "a dog on the beach", "two red cars in the street",
                "an image of a bird", "a man holding a ball", "a blue boat on the water",
                "a child sitting on a chair", "a horse near a tree"]
    server = ClipServer(engine, pp_val, tokenizer)
    pixels = server._decode_images(images_b64)
    ids = tokenizer(captions)
    counts = {}
    with torch.inference_mode():
        for what, fn, arg in (("image", engine.encode_image, pixels),
                              ("text", engine.encode_text, ids)):
            _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
            got = fn(arg)
            torch.cuda.synchronize()
            counts[what] = _read_counts()
            add(counts[what])
            _set_attn_impl(model, "xla")
            want = fn(arg)
            _set_attn_impl(model, "auto")
            cos = float((torch.nn.functional.cosine_similarity(
                torch.from_numpy(got).double(), torch.from_numpy(want).double(), dim=-1)).min())
            norms = np.linalg.norm(got, axis=-1)
            n_want = 13 if what == "image" else 12
            print(f"siglip (b) encode_{what} fp32 bucket 8: launches {counts[what]} (expected "
                  f"{n_want} fused forward), cosine vs plain attention min {cos:.8f} (need >= "
                  f"{MIN_COSINE}), norms {norms.min():.6f}-{norms.max():.6f}", flush=True)
            check(counts[what] == {"flash_attention_fwd": 0, "fused_attention_fwd": n_want,
                                   "fused_attention_bwd": 0} and cos >= MIN_COSINE
                  and np.allclose(norms, 1, atol=1e-5),
                  f"the SigLIP engine's encode_{what} through the kernels")
    httpd = make_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        status_i, feats_i = _post(base, "/v1/encode_image", {"images_b64": images_b64[:2]})
        status_t, feats_t = _post(base, "/v1/encode_text", {"texts": captions[:2]})
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    fi, ft = np.asarray(feats_i["features"]), np.asarray(feats_t["features"])
    print(f"siglip (b) HTTP /v1/encode_image {status_i} {fi.shape}, /v1/encode_text "
          f"{status_t} {ft.shape}", flush=True)
    dim = model.embed_dim
    check(status_i == status_t == 200 and fi.shape == (2, dim) and ft.shape == (2, dim),
          "the SigLIP server's encoders")
    lat = {}
    for b in SIGLIP_BUCKETS:
        x = torch.from_numpy(np.repeat(pixels, 8, axis=0)[:b]).to(DEVICE)
        t = torch.from_numpy(np.repeat(ids, 8, axis=0)[:b]).long().to(DEVICE)
        with torch.inference_mode():
            lat[f"image b{b}"] = time_ms(lambda: model.encode_image(x), iters=10)
            lat[f"text b{b}"] = time_ms(lambda: model.encode_text(t), iters=10)
    print(f"time siglip tower fp32 per call (CUDA events, ms): "
          f"{ {k: round(v, 3) for k, v in lat.items()} } [{CARD}]", flush=True)
    del engine, server

    # ---- (c) the step: bf16 at SIGLIP_BATCH checkpointed, then fp32 ----
    model.train()
    _set_compute_dtype(model, torch.bfloat16)
    model.set_grad_checkpointing(True)
    batch = _siglip_batch(tokenizer, SIGLIP_BATCH)
    step_want = {"flash_attention_fwd": 0, "fused_attention_fwd": 25 + 24,
                 "fused_attention_bwd": 25}
    bf16 = _siglip_step_vs_plain(model, batch, "bfloat16", step_want)
    # a warm-up, as the CLI's: at the full rate from step 0 the third step's
    # loss jumps to ~220 (first card run)
    optimizer, _ = build_optimizer(dict(model.named_parameters()),
                                   OptimCfg(text_tower_style="custom_text"),
                                   cosine_lr(5e-4, 100, 1000))
    state = TrainState(model, None, optimizer, 0, torch.Generator().manual_seed(SEED))
    train_step = make_train_step(model, StepCfg(loss_type="siglip", siglip_dist_impl="bidir"))
    losses = []
    _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
    for _ in range(SIGLIP_STEPS):
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["total_loss"]))
    torch.cuda.synchronize()
    counts = _read_counts()
    add(counts)
    want_counts = {k: v * SIGLIP_STEPS for k, v in step_want.items()}
    torch.cuda.reset_peak_memory_stats()
    host_ms = host_step_ms(lambda: train_step(state, batch), steps=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        train_step(state, batch)
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / 3
    print(f"siglip (c) train step {SIGLIP_MODEL} bf16 batch {SIGLIP_BATCH} "
          f"--grad-checkpointing: losses {losses}; launches {counts} over {SIGLIP_STEPS} steps, "
          f"expected {want_counts}; host clock {host_ms:.3f} ms a step "
          f"({SIGLIP_BATCH / host_ms * 1e3:.1f} samples/s), CUDA events {event_ms:.3f} ms; peak "
          f"{peak:.3f} GiB [{CARD}]", flush=True)
    check(counts == want_counts and all(math.isfinite(x) for x in losses),
          f"the SigLIP steps: {counts}")
    state.optimizer = optimizer = train_step = None
    torch.cuda.empty_cache()
    _set_compute_dtype(model, torch.float32)
    model.set_grad_checkpointing(False)
    fp32 = _siglip_step_vs_plain(
        model, _siglip_batch(tokenizer, SIGLIP_FP32_BATCH, seed=SEED + 61), "float32",
        {"flash_attention_fwd": 0, "fused_attention_fwd": 25, "fused_attention_bwd": 25})
    del model, state
    torch.cuda.empty_cache()

    # ---- (d) Config 4's flags through train.main ----
    t0 = time.perf_counter()
    shards = _write_siglip_shards(d, os.path.join(work, "siglip_shards"))
    shard_s = time.perf_counter() - t0
    n_samples = SIGLIP_STEPS * SIGLIP_BATCH
    argv = ["--model", SIGLIP_MODEL, "--siglip", "--precision", "bf16", "--dataset-type",
            "webdataset", "--train-data", shards, "--loss-dist-impl", "bidir",
            "--grad-checkpointing", "--batch-size", str(SIGLIP_BATCH), "--train-num-samples",
            str(n_samples), "--pretrained", SIGLIP_TAG, "--cache-dir", cache, "--epochs", "1",
            "--save-frequency", "0", "--workers", "8", "--seed", str(SEED),
            "--log-every-n-steps", "1", "--logs", work, "--name", "siglip_cli",
            "--device", DEVICE]
    records, counts, wall, seconds = _eval_cli_run(argv)
    add(counts)
    want_counts = {k: v * SIGLIP_STEPS for k, v in step_want.items()}
    train_s = seconds.get("train_one_epoch", 0.0)
    cli_losses = [r["total_loss"] for r in records]
    print(f"siglip (d) train.main Config 4 flags ({' '.join(argv[:14])} ...) batch "
          f"{SIGLIP_BATCH} on 4 tar shards of {SIGLIP_SHARD_SAMPLES} samples (written in "
          f"{shard_s:.2f} s): {len(records)} steps, losses {cli_losses}; wall {wall:.2f} s "
          f"(train {train_s:.2f} s, {n_samples / max(train_s, 1e-9):.1f} samples/s with loading); "
          f"launches {counts}, expected {want_counts} [{CARD}]", flush=True)
    check(len(records) == SIGLIP_STEPS and all(math.isfinite(x) for x in cli_losses),
          "the Config 4 CLI run's losses")
    check(counts == want_counts, f"the Config 4 CLI run launched {counts}, expected {want_counts}")
    torch.cuda.empty_cache()
    print(f"siglip: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": total, "step_ms": host_ms, "event_ms": event_ms, "peak_gib": peak,
            "cli_wall_s": wall, "bf16": bf16, "fp32": fp32, "tower_ms": lat}


def _write_hub_repo(cache: str, hub_id: str, files: dict) -> str:
    """A hub-cache repo ``hub_id`` under ``cache`` whose ``refs/main`` names
    the ``HUB_REV`` snapshot; ``files`` maps a file name to a state dict
    (``torch.save``), a path to copy, or a dict (JSON). Returns the snapshot."""
    import torch

    repo = os.path.join(cache, "models--" + hub_id.replace("/", "--"))
    snap = os.path.join(repo, "snapshots", HUB_REV)
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    os.makedirs(snap, exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(HUB_REV)
    for name, what in files.items():
        if isinstance(what, str):
            shutil.copy(what, os.path.join(snap, name))
        elif name.endswith(".json"):
            with open(os.path.join(snap, name), "w") as f:
                json.dump(what, f)
        else:
            torch.save(what, os.path.join(snap, name))
    return snap


def _zoo_step_vs_plain(models, batch, cfg, name: str, want_counts: dict,
                       dist_model=None) -> dict:
    """One loss of ``cfg`` and every gradient of the student (``models[0]``)
    through the kernels against plain attention in every model of
    ``models`` (the student, and the distillation teacher ``dist_model``
    where given), ``STEP_TOL``: bf16 all tensors together, fp32 every
    tensor. The kernel run's launches must be ``want_counts``."""
    import torch

    from refining_clip_via_dinov2_representations_torch.train.step import make_loss_fn

    loss_tol, min_cos = STEP_TOL[name]
    model = models[0]

    def run():
        for p in model.parameters():
            p.grad = None
        _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
        loss, metrics = make_loss_fn(model, cfg, dist_model=dist_model)(batch, 0)
        loss.backward()
        torch.cuda.synchronize()
        counts = _read_counts()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        for p in model.parameters():
            p.grad = None
        return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads,
                counts)

    loss_k, metrics_k, grads_k, counts = run()
    for m in models:
        _set_attn_impl(m, "xla")
    loss_p, metrics_p, grads_p, _ = run()
    for m in models:
        _set_attn_impl(m, "auto")
    check(grads_k.keys() == grads_p.keys() and len(grads_k) == len(list(model.parameters())),
          f"the two {cfg.loss_type} runs have different gradients")
    cos, together = _grad_cosines(grads_k, grads_p)
    lowest = min(cos, key=cos.get)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    held = together if name == "bfloat16" else cos[lowest]
    need = "together" if name == "bfloat16" else "per tensor"
    terms = {k: round(v, 6) for k, v in metrics_k.items() if k != "logit_scale"}
    print(f"zoo {cfg.loss_type} step {name} batch {batch['images'].shape[0]}: loss {loss_k:.6f} "
          f"through the kernels vs {loss_p:.6f} plain (rel {rel:.2e}, tol {loss_tol:g}), terms "
          f"{terms}; student gradient cosine all tensors together {together:.7f}, per tensor "
          f"lowest {cos[lowest]:.7f} at {lowest}, {sum(c < min_cos for c in cos.values())} of "
          f"{len(cos)} below {min_cos} (need {need} >= {min_cos}); kernel run launches "
          f"{counts}, expected {want_counts}", flush=True)
    check(counts == want_counts, f"the {name} {cfg.loss_type} step launched {counts}")
    check(rel <= loss_tol and held >= min_cos and math.isfinite(loss_k),
          f"the {name} {cfg.loss_type} step through the kernels disagrees with plain attention")
    return {"loss": loss_k, "together": together, "min_cosine": cos[lowest]}


def phase_zoo(work: str, d: dict, pre: dict) -> dict:
    """The rest of the loss zoo and the ViT variants (phase 13c, after
    pretrained), at full width: (a) distillation: a seeded ViT-L-14
    (``ZOO_TEACHER``, full width and depth) written in the hub-cache layout
    of its ``openai`` tag; ``train.main`` with ``--model ViT-B-16
    --distill-model ViT-L-14 --distill-pretrained openai`` on the first
    ``ZOO_CLI_ROWS`` mini-Flickr train rows, one epoch: losses, launches,
    wall, and a checkpoint without the teacher; the teacher that run loaded
    by tag (kept by wrapping ``factory.create_model``) holds exactly the
    written values, and its features through the kernels go against plain
    attention (cosine >= 0.9999, fp32; 24 + 12 launches); the ViT-B-16
    student's distillation step at ``ZOO_BATCH`` under it against plain
    attention in bf16 and fp32 (``STEP_TOL``; 36 teacher + 24 student
    forward and 24 backward launches); its host clock, CUDA events, the
    teacher's share and peak memory;
    (b) the CyCLIP step at ``ZOO_CYCLIP_BATCH`` in bf16 and fp32 against
    plain attention (24 + 24); (c) ViT-L-14-CLIPA (``CLIPA_MODEL``) seeded,
    written with the committed BERT test vocabulary into the hub repos of
    its ``datacomp1b`` tag and of bert-base-uncased, loaded by tag exactly,
    its captions tokenized to ``CLIPA_IDS``, served fp32 at ``ZOO_BUCKETS``
    (24 launches an image call, 12 a text call; cosine >= 0.9999 to plain
    attention; one HTTP text request), the tower time per call; (d) one
    full-width fp32 forward each of ``ZOO_GAP`` (12 launches) and
    ``ZOO_RELPOS`` (none: its bias is an external mask, the plain path, as
    in JAX) against plain attention. Returns the launches and numbers."""
    import base64
    import csv

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, create_model, create_model_and_transforms, factory, get_model_config,
        get_tokenizer, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.models.pretrained import (
        get_pretrained_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.serve import ClipServer, make_http_server
    from refining_clip_via_dinov2_representations_torch.train.optim import (
        OptimCfg, build_optimizer,
    )
    from refining_clip_via_dinov2_representations_torch.train.scheduler import cosine_lr
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, TrainState, make_train_step,
    )

    t_phase = time.perf_counter()
    total = {"fused_attention_fwd": 0, "fused_attention_bwd": 0, "flash_attention_fwd": 0}

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    def cosine(a, b):
        return float(torch.nn.functional.cosine_similarity(
            torch.as_tensor(a).double().flatten(1), torch.as_tensor(b).double().flatten(1),
            dim=-1).min())

    cache = pre["cache"]
    out = {}
    # ---- (a) distillation: the teacher written in the hub repo of its tag ----
    t0 = time.perf_counter()
    src, _ = create_model(ZOO_TEACHER, device="cpu", seed=SEED + 70)
    sd = src.state_dict()
    n_teacher = sum(p.numel() for p in src.parameters())
    del src
    hub_id = get_pretrained_cfg(ZOO_TEACHER, ZOO_TEACHER_TAG)["hf_hub"].rstrip("/")
    _write_hub_repo(cache, hub_id, {"open_clip_pytorch_model.bin": sd})
    print(f"zoo (a): seeded {ZOO_TEACHER}, {n_teacher:,} parameters, written in "
          f"{time.perf_counter() - t0:.2f} s (hub cache of {hub_id})", flush=True)

    # ---- (a) the CLI with the distillation flags; the teacher it loads by tag
    # is kept for the checks below (one load of 1.7 GB instead of two) ----
    with open(d["train_csv"], newline="") as f:
        rows = list(csv.reader(f))
    cut, n_rows = os.path.join(work, "zoo_train.csv"), min(ZOO_CLI_ROWS, len(rows) - 1)
    with open(cut, "w", newline="") as f:
        csv.writer(f).writerows(rows[:1 + n_rows])
    argv = ["--model", ZOO_STUDENT, "--distill-model", ZOO_TEACHER, "--distill-pretrained",
            ZOO_TEACHER_TAG, "--cache-dir", cache, "--train-data", cut, "--dataset-type", "csv",
            "--precision", "bf16", "--batch-size", str(ZOO_BATCH), "--epochs", "1",
            "--save-frequency", "0", "--workers", "8", "--seed", str(SEED),
            "--log-every-n-steps", "1", "--logs", work, "--name", "zoo_distill_cli",
            "--device", DEVICE]
    captured = {}
    build = factory.create_model

    def capture(name, *args, **kwargs):
        t = time.perf_counter()
        built = build(name, *args, **kwargs)
        if name == ZOO_TEACHER:
            captured["teacher"], captured["load_s"] = built[0], time.perf_counter() - t
        return built

    factory.create_model = capture
    try:
        records, counts, wall, seconds = _eval_cli_run(argv)
    finally:
        factory.create_model = build
    add(counts)
    distill_want = {"flash_attention_fwd": 0, "fused_attention_fwd": 36 + 24,
                    "fused_attention_bwd": 24}
    steps = n_rows // ZOO_BATCH  # the train loader drops the last partial batch
    want_counts = {k: v * steps for k, v in distill_want.items()}
    final = torch.load(os.path.join(work, "zoo_distill_cli", "checkpoints",
                                    "final_torch_state.pt"), map_location="cpu",
                       weights_only=False)["state_dict"]
    with torch.device("meta"):
        student_keys = set(build_model(parse_model_cfg(get_model_config(ZOO_STUDENT)))
                           .state_dict())
    student_only = set(final) == student_keys
    del final
    teacher = captured["teacher"]
    exact = _exactly(teacher, sd)
    del sd
    cli_losses = [(round(r["contrastive_loss"], 5), round(r["distill_loss"], 5))
                  for r in records]
    train_s = seconds.get("train_one_epoch", 0.0)
    print(f"zoo (a) train.main {' '.join(argv[:6])} ... bf16 batch {ZOO_BATCH} on "
          f"{n_rows} mini-Flickr rows: {len(records)} steps, (contrastive, distill) "
          f"losses {cli_losses}; wall {wall:.2f} s (train {train_s:.2f} s, the teacher loaded by "
          f"tag {ZOO_TEACHER_TAG} in {captured['load_s']:.2f} s, its values exactly the written "
          f"ones: {exact}); launches {counts}, expected {want_counts}; the final checkpoint "
          f"holds the student's keys alone: {student_only} [{CARD}]", flush=True)
    check(exact, "the distillation teacher loaded by tag differs from the written one")
    check(len(records) == steps and all(math.isfinite(r["total_loss"]) for r in records),
          "the distillation CLI run's losses")
    check(counts == want_counts, f"the distillation CLI run launched {counts}")
    check(student_only, "the final checkpoint holds other tensors than the student's")
    out["cli_wall_s"] = wall
    torch.cuda.empty_cache()

    # ---- (a) the teacher's features and the distillation step ----
    _set_compute_dtype(teacher, torch.float32)
    tokenizer = get_tokenizer(ZOO_STUDENT)
    batch = _train_batch(tokenizer, ZOO_BATCH, DEVICE, model_name=ZOO_STUDENT, seed=SEED + 71)
    feats = {}
    with torch.no_grad():
        for what, fn, x in (("image", teacher.encode_image, batch["images"]),
                            ("text", teacher.encode_text, batch["texts"])):
            _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
            got = fn(x, normalize=True).float()
            torch.cuda.synchronize()
            counts = _read_counts()
            add(counts)
            _set_attn_impl(teacher, "xla")
            want = fn(x, normalize=True).float()
            _set_attn_impl(teacher, "auto")
            feats[what] = (cosine(got, want), counts["fused_attention_fwd"])
    print(f"zoo (a) teacher {ZOO_TEACHER} fp32 batch {ZOO_BATCH}: features through the kernels "
          f"vs plain attention, cosine min and fused launches {feats} (need >= {MIN_COSINE}; "
          f"24 image, 12 text)", flush=True)
    check(feats["image"][0] >= MIN_COSINE and feats["text"][0] >= MIN_COSINE
          and (feats["image"][1], feats["text"][1]) == (24, 12),
          "the distillation teacher's features through the kernels")
    student, _ = create_model(ZOO_STUDENT, device=DEVICE, seed=SEED + 72)
    student.train()
    cfg = StepCfg(loss_type="distill")
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for m in (student, teacher):
            _set_compute_dtype(m, dtype)
        out[f"distill_{name}"] = _zoo_step_vs_plain((student, teacher), batch, cfg, name,
                                                    distill_want, dist_model=teacher)
        add(distill_want)
    for m in (student, teacher):
        _set_compute_dtype(m, torch.bfloat16)
    optimizer, _ = build_optimizer(dict(student.named_parameters()), OptimCfg(),
                                   cosine_lr(5e-4, 100, 1000))
    state = TrainState(student, None, optimizer, 0, torch.Generator().manual_seed(SEED))
    train_step = make_train_step(student, cfg, dist_model=teacher)
    _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
    losses = []
    for _ in range(ZOO_STEPS):
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["total_loss"]))
    torch.cuda.synchronize()
    counts = _read_counts()
    add(counts)
    torch.cuda.reset_peak_memory_stats()
    host_ms = host_step_ms(lambda: train_step(state, batch), steps=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    event_ms = time_ms(lambda: train_step(state, batch), iters=3)
    with torch.no_grad():
        teacher_ms = time_ms(lambda: teacher(batch["images"], batch["texts"]), iters=3)
    want_counts = {k: v * ZOO_STEPS for k, v in distill_want.items()}
    print(f"zoo (a) distill train step {ZOO_STUDENT} under {ZOO_TEACHER} bf16 batch {ZOO_BATCH}: "
          f"losses {losses}; launches {counts} over {ZOO_STEPS} steps, expected {want_counts}; "
          f"host clock {host_ms:.3f} ms a step ({ZOO_BATCH / host_ms * 1e3:.1f} samples/s), "
          f"CUDA events {event_ms:.3f} ms, the teacher's forward alone {teacher_ms:.3f} ms "
          f"({teacher_ms / event_ms:.1%} of the step); peak {peak:.3f} GiB [{CARD}]", flush=True)
    check(counts == want_counts and all(math.isfinite(x) for x in losses),
          f"the distillation steps: {counts}")
    out.update(distill_step_ms=host_ms, distill_event_ms=event_ms, teacher_ms=teacher_ms,
               distill_peak_gib=peak)
    state = optimizer = train_step = None
    del teacher, captured
    torch.cuda.empty_cache()

    # ---- (b) CyCLIP ----
    cyc_batch = _train_batch(tokenizer, ZOO_CYCLIP_BATCH, DEVICE, model_name=ZOO_STUDENT,
                             seed=SEED + 73)
    cyc_want = {"flash_attention_fwd": 0, "fused_attention_fwd": 24, "fused_attention_bwd": 24}
    cfg = StepCfg(loss_type="cyclip")
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        _set_compute_dtype(student, dtype)
        out[f"cyclip_{name}"] = _zoo_step_vs_plain((student,), cyc_batch, cfg, name, cyc_want)
        add(cyc_want)
    del student
    torch.cuda.empty_cache()

    # ---- (c) ViT-L-14-CLIPA by its tag, its text by the WordPiece reader ----
    t0 = time.perf_counter()
    src, _ = create_model(CLIPA_MODEL, device="cpu", seed=SEED + 74)
    sd = src.state_dict()
    n_clipa = sum(p.numel() for p in src.parameters())
    del src
    root = os.path.dirname(os.path.abspath(__file__))
    clipa_hub = get_pretrained_cfg(CLIPA_MODEL, CLIPA_TAG)["hf_hub"].rstrip("/")
    _write_hub_repo(cache, clipa_hub, {"open_clip_pytorch_model.bin": sd})
    _write_hub_repo(cache, "bert-base-uncased", {
        "tokenizer.json": os.path.join(root, BERT_VOCAB),
        "tokenizer_config.json": BERT_TOKENIZER_CONFIG})
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, pp_val = create_model_and_transforms(CLIPA_MODEL, pretrained=CLIPA_TAG,
                                                cache_dir=cache, device=DEVICE)
    load_s = time.perf_counter() - t0
    exact = _exactly(model, sd)
    del sd
    tokenizer = get_tokenizer(CLIPA_MODEL, cache_dir=cache)
    ids = tokenizer(CLIPA_CAPTIONS)
    ids_ok = [list(map(int, row[row != 0])) for row in ids] == CLIPA_IDS
    print(f"zoo (c): seeded {CLIPA_MODEL}, {n_clipa:,} parameters, written in {write_s:.2f} s "
          f"(hub repos {clipa_hub} and bert-base-uncased with the committed test vocabulary), "
          f"loaded by tag {CLIPA_TAG} in {load_s:.2f} s; the written values exactly: {exact}; "
          f"tokenizer {type(tokenizer).__name__} ({tokenizer.tokenizer.model_type}, context "
          f"{tokenizer.context_length}, strip_sep_token {tokenizer.strip_sep_token}); the "
          f"captions' ids equal the CPU test's: {ids_ok}", flush=True)
    check(exact, "the CLIPA checkpoint loaded by tag differs from the written one")
    check(ids_ok, f"CLIPA's token ids {ids.tolist()} differ from the pinned ones")
    engine = ClipInferenceEngine(model, image_size=model.visual.image_size,
                                 context_length=model.context_length, buckets=ZOO_BUCKETS)
    engine.warmup()
    images_b64 = []
    for p in sorted(os.listdir(d["img_dir"]))[:8]:
        with open(os.path.join(d["img_dir"], p), "rb") as f:
            images_b64.append(base64.b64encode(f.read()).decode())
    captions = CLIPA_CAPTIONS + ["a photo of a cat", "a dog on the beach", "two red cars",
                                 "an image of a bird", "a blue boat on the water"]
    server = ClipServer(engine, pp_val, tokenizer)
    pixels = server._decode_images(images_b64)
    text_ids = tokenizer(captions)
    served = {}
    with torch.inference_mode():
        for what, fn, arg, n_want in (("image", engine.encode_image, pixels, 24),
                                      ("text", engine.encode_text, text_ids, 12)):
            _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
            got = fn(arg)
            torch.cuda.synchronize()
            counts = _read_counts()
            add(counts)
            _set_attn_impl(model, "xla")
            want = fn(arg)
            _set_attn_impl(model, "auto")
            served[what] = got
            cos = cosine(got, want)
            print(f"zoo (c) {CLIPA_MODEL} encode_{what} fp32 bucket 8: launches {counts} "
                  f"(expected {n_want} fused forward), cosine vs plain attention min {cos:.8f} "
                  f"(need >= {MIN_COSINE}), finite {bool(np.isfinite(got).all())}", flush=True)
            check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": n_want,
                             "fused_attention_bwd": 0} and cos >= MIN_COSINE
                  and np.isfinite(got).all(), f"CLIPA's encode_{what} through the kernels")
    httpd = make_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        status, body = _post(f"http://127.0.0.1:{httpd.server_address[1]}", "/v1/encode_text",
                             {"texts": captions[:2]})
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    http_err = float(np.abs(np.asarray(body["features"]) - served["text"][:2]).max())
    print(f"zoo (c) HTTP /v1/encode_text {status}: max |served - engine| {http_err:.2e}",
          flush=True)
    check(status == 200 and http_err < 1e-5, "CLIPA's served text features")
    lat = {}
    for b in ZOO_BUCKETS:
        x = torch.from_numpy(np.repeat(pixels, 8, axis=0)[:b]).to(DEVICE)
        t = torch.from_numpy(np.repeat(text_ids, 8, axis=0)[:b]).long().to(DEVICE)
        with torch.inference_mode():
            lat[f"image b{b}"] = time_ms(lambda: model.encode_image(x), iters=10)
            lat[f"text b{b}"] = time_ms(lambda: model.encode_text(t), iters=10)
    print(f"time zoo {CLIPA_MODEL} tower fp32 per call (CUDA events, ms): "
          f"{ {k: round(v, 3) for k, v in lat.items()} } [{CARD}]", flush=True)
    out["clipa_tower_ms"] = lat
    del engine, model
    torch.cuda.empty_cache()

    # ---- (d) the GAP and the relative-position ViTs, one forward each ----
    for name, n_want in ((ZOO_GAP, 12), (ZOO_RELPOS, 0)):
        model, _ = create_model(name, device=DEVICE, seed=SEED + 75)
        size = model.visual.image_size[0]
        x = torch.from_numpy(np.random.default_rng(SEED + 76).normal(
            size=(ZOO_VIT_BATCH, size, size, 3)).astype(np.float32)).to(DEVICE)
        with torch.no_grad():
            _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
            got = model.encode_image(x, normalize=True)
            torch.cuda.synchronize()
            counts = _read_counts()
            add(counts)
            _set_attn_impl(model, "xla")
            want = model.encode_image(x, normalize=True)
        cos = cosine(got, want)
        print(f"zoo (d) {name} fp32 batch {ZOO_VIT_BATCH} at {size} px "
              f"({sum(p.numel() for p in model.parameters()):,} parameters): features "
              f"{tuple(got.shape)}, launches {counts} (expected {n_want} fused forward), cosine "
              f"vs plain attention min {cos:.8f} (need >= {MIN_COSINE})", flush=True)
        check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": n_want,
                         "fused_attention_bwd": 0} and cos >= MIN_COSINE
              and bool(torch.isfinite(got).all()), f"{name}'s forward")
        del model
    torch.cuda.empty_cache()
    out.update(phase_zoo_eva02(add, cosine))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"zoo: phase {out['seconds']:.1f} s", flush=True)
    return {"launches": total, **out}


def phase_zoo_eva02(add, cosine) -> dict:
    """Phase 13c (e): EVA02-L-14 at full width and depth and EVA02-E-14 at
    full width, ``EVA02_E_LAYERS`` of its 64 blocks (the module docstring).
    ``add`` takes each main-path run's launches."""
    import dataclasses

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, eva02, get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg, make_loss_fn

    t0 = time.perf_counter()
    out = {}
    model, _ = create_model(EVA02_MODEL, device=DEVICE, seed=SEED + 80)
    n_params = sum(p.numel() for p in model.parameters())
    tokenizer = get_tokenizer(EVA02_MODEL)
    batch = _train_batch(tokenizer, max(EVA02_BUCKETS), DEVICE, model_name=EVA02_MODEL,
                         seed=SEED + 81)
    for what, fn, arg, n_want in (("image", model.encode_image, batch["images"], 24),
                                  ("text", model.encode_text, batch["texts"], 12)):
        with torch.no_grad():
            _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
            got = fn(arg, normalize=True)
            torch.cuda.synchronize()
            counts = _read_counts()
            add(counts)
            _set_attn_impl(model, "xla")
            want = fn(arg, normalize=True)
            _set_attn_impl(model, "auto")
        cos = cosine(got, want)
        print(f"zoo (e) {EVA02_MODEL} ({n_params:,} parameters) encode_{what} fp32 batch "
              f"{max(EVA02_BUCKETS)}: launches {counts} (expected {n_want} fused forward), "
              f"cosine vs plain attention min {cos:.8f} (need >= {MIN_COSINE})", flush=True)
        check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": n_want,
                         "fused_attention_bwd": 0} and cos >= MIN_COSINE
              and bool(torch.isfinite(got).all()), f"{EVA02_MODEL}'s encode_{what}")
    lat = {}
    for b in EVA02_BUCKETS:
        x, t = batch["images"][:b], batch["texts"][:b]
        with torch.inference_mode():
            lat[f"image b{b}"] = time_ms(lambda: model.encode_image(x), iters=10)
            lat[f"text b{b}"] = time_ms(lambda: model.encode_text(t), iters=10)
    print(f"time zoo (e) {EVA02_MODEL} tower fp32 per call (CUDA events, ms): "
          f"{ {k: round(v, 3) for k, v in lat.items()} } [{CARD}]", flush=True)
    out["eva02_tower_ms"] = lat
    step_want = {"flash_attention_fwd": 0, "fused_attention_fwd": 36, "fused_attention_bwd": 36}
    cfg = StepCfg(loss_type="clip")
    for name, dtype, n in (("bfloat16", torch.bfloat16, EVA02_BATCH),
                           ("float32", torch.float32, EVA02_FP32_BATCH)):
        _set_compute_dtype(model, dtype)
        step_batch = _train_batch(tokenizer, n, DEVICE, model_name=EVA02_MODEL, seed=SEED + 82)
        out[f"eva02_step_{name}"] = _zoo_step_vs_plain((model,), step_batch, cfg, name,
                                                       step_want)
        add(step_want)
        if name == "bfloat16":  # the forward and backward's time and peak memory
            loss_fn = make_loss_fn(model, cfg)

            def fwd_bwd():
                model.zero_grad(set_to_none=True)
                loss_fn(step_batch, 0)[0].backward()

            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(fwd_bwd, iters=3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            model.zero_grad(set_to_none=True)
            print(f"time zoo (e) {EVA02_MODEL} bf16 CLIP forward and backward at batch {n}: "
                  f"{ms:.3f} ms (CUDA events), peak {peak:.3f} GiB [{CARD}]", flush=True)
            out["eva02_step_bf16_ms"], out["eva02_step_bf16_peak_gib"] = ms, peak
    _set_compute_dtype(model, torch.float32)
    del model, batch
    torch.cuda.empty_cache()

    # ---- EVA02-E-14: head dim 112, its vision depth cut ----
    key = "eva02_enormous_patch14_clip_224"
    whole = eva02.EVA02_DIMS[key]
    eva02.EVA02_DIMS[key] = dataclasses.replace(whole, layers=EVA02_E_LAYERS)
    try:
        model, _ = create_model(EVA02_E_MODEL, device=DEVICE, seed=SEED + 83)
    finally:
        eva02.EVA02_DIMS[key] = whole
    x = torch.from_numpy(np.random.default_rng(SEED + 84).normal(
        size=(EVA02_E_BATCH, 224, 224, 3)).astype(np.float32)).to(DEVICE)
    for name, dtype, min_cos in (("float32", torch.float32, MIN_COSINE),
                                 ("bfloat16", torch.bfloat16, TEACHER_MIN_COS["bfloat16"])):
        _set_compute_dtype(model, dtype)
        with torch.no_grad():
            _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
            got = model.encode_image(x, normalize=True)
            torch.cuda.synchronize()
            counts = _read_counts()
            add(counts)
            _set_attn_impl(model, "xla")
            want = model.encode_image(x, normalize=True)
            _set_attn_impl(model, "auto")
        cos = cosine(got.float(), want.float())
        print(f"zoo (e) {EVA02_E_MODEL} at full width, {EVA02_E_LAYERS} of 64 vision blocks "
              f"(head dim {whole.width // whole.heads}), {name} batch {EVA02_E_BATCH}: launches "
              f"{counts} (expected {EVA02_E_LAYERS} fused forward), cosine vs plain attention "
              f"min {cos:.8f} (need >= {min_cos})", flush=True)
        check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": EVA02_E_LAYERS,
                         "fused_attention_bwd": 0} and cos >= min_cos
              and bool(torch.isfinite(got.float()).all()), f"{EVA02_E_MODEL}'s {name} forward")
    del model, x
    torch.cuda.empty_cache()
    out["eva02_seconds"] = time.perf_counter() - t0
    print(f"zoo (e): {out['eva02_seconds']:.1f} s", flush=True)
    return out


def _bn_buffers(model) -> dict:
    """Copies of ``model``'s BatchNorm running statistics."""
    return {k: v.detach().clone() for k, v in model.named_buffers() if ".running_" in k}


def _set_bn_buffers(model, stats: dict) -> None:
    import torch

    with torch.no_grad():
        for k, v in model.named_buffers():
            if k in stats:
                v.copy_(stats[k])


def _convnet_step_vs_plain(model, head, cfg, batch, name: str, want: dict, what: str,
                           phase: str = "convnets") -> dict:
    """One loss and every gradient of ``cfg`` through the kernels against
    plain attention (``STEP_TOL``: bf16 all tensors together; fp32 every
    tensor whose gradient is at least 1e-6 of the whole norm, the others
    within 1e-6 of it, as §2's CoCa row: the pool's key bias gradient is
    zero but for rounding), each from the same BatchNorm statistics; the
    statistics after the two runs against each other (1e-6 of a tensor's
    largest element: BatchNorm comes before the pool, so the attention route
    cannot move them). The kernel run's launches must be ``want``."""
    import torch

    loss_tol, min_cos = STEP_TOL[name]
    start = _bn_buffers(model)

    def run():
        _set_bn_buffers(model, start)
        _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
        loss, grads = _loss_and_grads(model, head, cfg, batch)
        torch.cuda.synchronize()
        return loss, grads, _read_counts(), _bn_buffers(model)

    loss_k, grads_k, counts, stats_k = run()
    _set_attn_impl(model, "xla")
    loss_p, grads_p, _, stats_p = run()
    _set_attn_impl(model, "auto")
    _set_bn_buffers(model, start)
    cos, together = _grad_cosines(grads_k, grads_p)
    whole = sum(float(g.double().norm()) ** 2 for g in grads_p.values()) ** 0.5
    small = {n for n, g in grads_p.items() if float(g.double().norm()) < 1e-6 * whole}
    small_err = max([float((grads_k[n].double() - grads_p[n].double()).norm()) / whole
                     for n in small] or [0.0])
    held_cos = {n: c for n, c in cos.items() if n not in small}
    lowest = min(held_cos, key=held_cos.get)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    stats_rel = max([float((stats_k[k] - stats_p[k]).abs().max())
                     / max(float(stats_p[k].abs().max()), 1e-30) for k in stats_k] or [0.0])
    moved = sum(not torch.equal(stats_k[k], start[k]) for k in start)
    held = together if name == "bfloat16" else held_cos[lowest]
    print(f"{phase} {what} {cfg.loss_type} step {name} batch {batch['images'].shape[0]}: loss "
          f"{loss_k:.6f} through the kernels vs {loss_p:.6f} plain (rel {rel:.2e}, tol "
          f"{loss_tol:g}); gradient cosine all tensors together {together:.7f}, per tensor "
          f"lowest {held_cos[lowest]:.7f} at {lowest} (need "
          f"{'together' if name == 'bfloat16' else 'per tensor'} >= {min_cos}), {len(small)} "
          f"tensors under 1e-6 of the whole norm within {small_err:.2e} of it; BatchNorm "
          f"statistics: {moved} of {len(start)} moved, kernel vs plain route {stats_rel:.2e} "
          f"(need <= 1e-6); launches {counts}, expected {want}", flush=True)
    check(counts == want, f"the {what} {name} step launched {counts}")
    check(rel <= loss_tol and held >= min_cos and small_err <= 1e-6 and math.isfinite(loss_k)
          and stats_rel <= 1e-6 and moved == len(start),
          f"the {what} {name} step through the kernels disagrees with plain attention")
    return {"loss": loss_k, "together": together, "min_cosine": held_cos[lowest],
            "stats_rel": stats_rel}


def _features_vs_plain(model, batch, what, want_counts, add, phase: str = "convnets") -> dict:
    """fp32 image and text features of ``model`` through the kernels against
    plain attention (cosine >= ``MIN_COSINE``); each main-path call's
    launches must be ``want_counts[kind]`` fused forwards and go to ``add``."""
    import torch

    got, counts = {}, {}
    for kind, fn, x in (("image", model.encode_image, batch["images"]),
                        ("text", model.encode_text, batch["texts"])):
        with torch.no_grad():
            _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
            got[kind] = fn(x, normalize=True).float()
            torch.cuda.synchronize()
            counts[kind] = _read_counts()
            add(counts[kind])
            _set_attn_impl(model, "xla")
            want = fn(x, normalize=True).float()
            _set_attn_impl(model, "auto")
        cos = float(torch.nn.functional.cosine_similarity(got[kind].double(), want.double(),
                                                          dim=-1).min())
        n_want = want_counts[kind]
        print(f"{phase} {what} encode_{kind} fp32 batch {x.shape[0]}: launches "
              f"{counts[kind]} (expected {n_want} fused forward), cosine vs plain attention "
              f"min {cos:.8f} (need >= {MIN_COSINE})", flush=True)
        check(counts[kind] == {"flash_attention_fwd": 0, "fused_attention_fwd": n_want,
                               "fused_attention_bwd": 0} and cos >= MIN_COSINE
              and bool(torch.isfinite(got[kind]).all()),
              f"{what}'s encode_{kind} through the kernels")
    return got


def _tower_times(model, batch, buckets, what, phase: str = "convnets") -> dict:
    """Each tower's fp32 time per call at ``buckets``: CUDA events and the
    host clock with a sync."""
    import torch

    lat = {}
    for b in buckets:
        x, t = batch["images"][:b], batch["texts"][:b]
        with torch.inference_mode():
            for kind, fn, arg in (("image", model.encode_image, x),
                                  ("text", model.encode_text, t)):
                lat[f"{kind} b{b}"] = time_ms(lambda: fn(arg), iters=10)
                lat[f"{kind} b{b} host"] = _host_ms(lambda: fn(arg))
    print(f"time {phase} {what} tower fp32 per call (CUDA events; host clock with a sync, "
          f"median of 10), ms: { {k: round(v, 4) for k, v in lat.items()} } [{CARD}]",
          flush=True)
    return lat


def phase_convnets(work: str) -> dict:
    """The convolution towers (phase 13d, the module docstring): (a) RN50
    by its ``openai`` tag from a seeded fp16 TorchScript archive, loaded
    exactly, fp32 features through the kernels against plain attention (1
    launch an image call, 12 a text call), its tower time at
    ``CONVNET_BUCKETS``; (b) its DINO-soft step in bf16 and fp32 against
    plain attention (13 + 13 launches), the running statistics equal
    between the routes, and bit for bit unchanged under
    ``freeze_bn_stats``; (c) RN50x64 at 448 px, one fp32 forward against
    plain attention; (d) convnext_base_w by its tag, exactly, features (0 +
    12 launches), tower time, the bf16 checkpointed step (24 + 12); (e)
    convnext_large_d's mlp head loaded exactly from ``visual.head.mlp.*``,
    one fp32 forward. Returns the launches and numbers."""
    import dataclasses

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_model_config, get_tokenizer, openai,
    )
    from refining_clip_via_dinov2_representations_torch.models.factory import load_weights
    from refining_clip_via_dinov2_representations_torch.models.pretrained import (
        get_pretrained_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg

    t_phase = time.perf_counter()
    total = {"fused_attention_fwd": 0, "fused_attention_bwd": 0, "flash_attention_fwd": 0}
    out = {"launches": total}

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    cache = os.path.join(work, "convnets_hub")
    dino = StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5, soft_mode="kl_teacher"))

    # ---- (a) RN50 by its openai tag: a seeded OpenAI TorchScript archive ----
    t0 = time.perf_counter()
    src, _ = create_model(RN_MODEL, device="cpu", seed=SEED + 90)
    _bn_away_from_init(src, SEED + 91)
    sd = src.state_dict()
    want_sd = {k: v.half().float() for k, v in sd.items()}
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(1000)
               for k in list(sd) if k.endswith(".running_mean")})
    del src
    archive = openai.save_openai_archive(sd, os.path.join(work, "RN50.pt"))
    hub_id = get_pretrained_cfg(RN_MODEL, RN_TAG)["hf_hub"].rstrip("/")
    _write_hub_repo(cache, hub_id, {"open_clip_pytorch_model.bin": archive})
    model, _ = create_model(RN_MODEL, pretrained=RN_TAG, cache_dir=cache, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    exact = _exactly(model, want_sd)
    print(f"convnets (a) {RN_MODEL} ({n_params:,} parameters) from its {RN_TAG!r} tag (a seeded "
          f"fp16 TorchScript archive with num_batches_tracked, hub repo {hub_id}): loaded "
          f"exactly {exact} in {time.perf_counter() - t0:.2f} s", flush=True)
    check(exact, f"{RN_MODEL} by its tag does not hold the archive's values")
    tokenizer = get_tokenizer(RN_MODEL)
    batch = _train_batch(tokenizer, CONVNET_BATCH, DEVICE, model_name=RN_MODEL, seed=SEED + 92)
    b8 = {k: v[:max(CONVNET_BUCKETS)] for k, v in batch.items()}
    stats0 = _bn_buffers(model)
    _features_vs_plain(model, b8, f"(a) {RN_MODEL}", {"image": 1, "text": 12}, add)
    out["rn50_tower_ms"] = _tower_times(model, b8, CONVNET_BUCKETS, f"(a) {RN_MODEL}")
    check(all(torch.equal(v, stats0[k]) for k, v in _bn_buffers(model).items()),
          "serving moved the running statistics")

    # ---- (b) its DINO-soft step, bf16 and fp32, and with the freeze flag ----
    model.train()
    torch.manual_seed(SEED + 93)
    head = DinoProjectionHead(model.text_projection.shape[1], DINO_DIM, "mlp").to(DEVICE)
    want = {"flash_attention_fwd": 0, "fused_attention_fwd": 13, "fused_attention_bwd": 13}
    for name, dtype, n in (("bfloat16", torch.bfloat16, CONVNET_BATCH),
                           ("float32", torch.float32, CONVNET_FP32_BATCH)):
        _set_compute_dtype(model, dtype)
        out[f"rn50_step_{name}"] = _convnet_step_vs_plain(
            model, head, dino, {k: v[:n] for k, v in batch.items()}, name, want, f"(b) {RN_MODEL}")
        add(want)
    _set_compute_dtype(model, torch.bfloat16)
    frozen = dataclasses.replace(dino, freeze_bn_stats=True)
    _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
    loss, _ = _loss_and_grads(model, head, frozen, batch)
    torch.cuda.synchronize()
    counts = _read_counts()
    add(counts)
    kept = all(torch.equal(v, stats0[k]) for k, v in _bn_buffers(model).items())
    print(f"convnets (b) {RN_MODEL} bf16 step at {CONVNET_BATCH} with freeze_bn_stats: loss "
          f"{loss:.6f}, running statistics bit for bit unchanged {kept}, launches {counts}",
          flush=True)
    check(kept and counts == want and math.isfinite(loss), "the frozen step moved the statistics")

    def fwd_bwd():
        _loss_and_grads(model, head, dino, batch)

    torch.cuda.reset_peak_memory_stats()
    out["rn50_step_bf16_ms"] = time_ms(fwd_bwd, iters=3)
    out["rn50_step_bf16_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"time convnets (b) {RN_MODEL} bf16 DINO-soft forward and backward at "
          f"{CONVNET_BATCH}: {out['rn50_step_bf16_ms']:.3f} ms (CUDA events), peak "
          f"{out['rn50_step_bf16_peak_gib']:.3f} GiB [{CARD}]", flush=True)
    del model, head, batch, b8
    torch.cuda.empty_cache()
    out["rn50_seconds"] = time.perf_counter() - t_phase
    print(f"convnets (a)-(b): {out['rn50_seconds']:.1f} s", flush=True)

    # ---- (c) RN50x64 at 448 px, full width ----
    t0 = time.perf_counter()
    if RN_BIG_BLOCKS is not None:  # the time limit: fewer blocks a stage
        layers = get_model_config(RN_BIG)["vision_cfg"]["layers"]
        _cut_vision_depth(RN_BIG, [min(n, RN_BIG_BLOCKS) for n in layers])
    model, _ = create_model(RN_BIG, device=DEVICE, seed=SEED + 94)
    n_params = sum(p.numel() for p in model.parameters())
    blocks = [len(getattr(model.visual, f"layer{i}")) for i in range(1, 5)]
    x = torch.from_numpy(np.random.default_rng(SEED + 95).normal(
        size=(RN_BIG_BATCH, 448, 448, 3)).astype(np.float32)).to(DEVICE)
    with torch.no_grad():
        _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
        got = model.encode_image(x, normalize=True)
        torch.cuda.synchronize()
        counts = _read_counts()
        add(counts)
        _set_attn_impl(model, "xla")
        ref = model.encode_image(x, normalize=True)
        _set_attn_impl(model, "auto")
    cos = float(torch.nn.functional.cosine_similarity(got.double(), ref.double(), dim=-1).min())
    print(f"convnets (c) {RN_BIG} ({n_params:,} parameters, blocks {blocks}) fp32 at 448 px "
          f"batch {RN_BIG_BATCH}: launches {counts} (expected 1 fused forward, "
          f"[{RN_BIG_BATCH},64,1,64] over 197 keys), cosine vs plain attention min {cos:.8f} "
          f"(need >= {MIN_COSINE}); {time.perf_counter() - t0:.1f} s with the build", flush=True)
    check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": 1, "fused_attention_bwd": 0}
          and cos >= MIN_COSINE and bool(torch.isfinite(got).all()), f"{RN_BIG}'s forward")
    del model, x, got, ref
    torch.cuda.empty_cache()

    # ---- (d) convnext_base_w by its tag: a seeded open_clip file in the hub cache ----
    t0 = time.perf_counter()
    src, _ = create_model(CN_MODEL, device="cpu", seed=SEED + 96)
    sd = src.state_dict()
    del src
    hub_id = get_pretrained_cfg(CN_MODEL, CN_TAG)["hf_hub"].rstrip("/")
    _write_hub_repo(cache, hub_id, {"open_clip_pytorch_model.bin": sd})
    model, _ = create_model(CN_MODEL, pretrained=CN_TAG, cache_dir=cache, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    exact = _exactly(model, sd)
    print(f"convnets (d) {CN_MODEL} ({n_params:,} parameters) from its {CN_TAG!r} tag (hub repo "
          f"{hub_id}): loaded exactly {exact} in {time.perf_counter() - t0:.2f} s", flush=True)
    check(exact, f"{CN_MODEL} by its tag does not hold the written values")
    tokenizer = get_tokenizer(CN_MODEL)
    batch = _train_batch(tokenizer, CONVNET_BATCH, DEVICE, model_name=CN_MODEL, seed=SEED + 97)
    b8 = {k: v[:max(CONVNET_BUCKETS)] for k, v in batch.items()}
    t1 = time.perf_counter()
    _features_vs_plain(model, b8, f"(d) {CN_MODEL}", {"image": 0, "text": 12}, add)
    t2 = time.perf_counter()
    out["convnext_tower_ms"] = _tower_times(model, b8, CONVNET_BUCKETS, f"(d) {CN_MODEL}")
    print(f"convnets (d) seconds: features {t2 - t1:.1f}, tower times "
          f"{time.perf_counter() - t2:.1f}", flush=True)
    t1 = time.perf_counter()
    model.train().set_grad_checkpointing(True)
    torch.manual_seed(SEED + 98)
    head = DinoProjectionHead(model.text_projection.shape[1], DINO_DIM, "mlp").to(DEVICE)
    _set_compute_dtype(model, torch.bfloat16)
    want = {"flash_attention_fwd": 0, "fused_attention_fwd": 24, "fused_attention_bwd": 12}
    out["convnext_step_bfloat16"] = _convnet_step_vs_plain(
        model, head, dino, batch, "bfloat16", want, f"(d) {CN_MODEL} checkpointed")
    add(want)
    print(f"convnets (d) seconds: the step against plain attention "
          f"{time.perf_counter() - t1:.1f}", flush=True)

    def cn_fwd_bwd():
        _loss_and_grads(model, head, dino, batch)

    torch.cuda.reset_peak_memory_stats()
    out["convnext_step_bf16_ms"] = time_ms(cn_fwd_bwd, iters=3)
    out["convnext_step_bf16_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"time convnets (d) {CN_MODEL} bf16 DINO-soft forward and backward at {CONVNET_BATCH} "
          f"under --grad-checkpointing: {out['convnext_step_bf16_ms']:.3f} ms (CUDA events), "
          f"peak {out['convnext_step_bf16_peak_gib']:.3f} GiB [{CARD}]", flush=True)
    del model, head, batch, b8, sd
    torch.cuda.empty_cache()
    print(f"convnets (d): {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (e) convnext_large_d: the mlp head from open_clip's keys ----
    t0 = time.perf_counter()
    model, _ = create_model(CN_MLP, device=DEVICE, seed=SEED + 99)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}  # on the card
    head_keys = sorted(k for k in sd if k.startswith("visual.head."))
    with torch.no_grad():  # the head away from what the state dict holds
        for k, v in model.state_dict().items():
            if k in head_keys:
                v.zero_()
    load_weights(model, sd, strict=True)
    exact = all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    tokenizer = get_tokenizer(CN_MLP)
    batch = _train_batch(tokenizer, 8, DEVICE, model_name=CN_MLP, seed=SEED + 100)
    print(f"convnets (e) {CN_MLP}: head keys {head_keys}, loaded exactly {exact}", flush=True)
    check(exact and "visual.head.mlp.fc1.weight" in head_keys
          and "visual.head.mlp.fc2.weight" in head_keys, f"{CN_MLP}'s mlp head")
    _features_vs_plain(model, batch, f"(e) {CN_MLP}", {"image": 0, "text": 16}, add)
    print(f"convnets (e): {time.perf_counter() - t0:.1f} s", flush=True)
    del model, batch, sd
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"convnets: {out['seconds']:.1f} s, launches {total}", flush=True)
    return out


def _hub_file_sd(sd: dict) -> dict:
    """A port CLIP state dict in open_clip's CustomTextCLIP layout, as a timm
    trunk's hub file holds it: the text tower's parts under ``text.``."""
    return {k if k.startswith("visual.") or k in ("logit_scale", "logit_bias") else "text." + k: v
            for k, v in sd.items()}


def _swin_bf16_vs_fp32_plain(model, head, cfg, batch, want: dict) -> dict:
    """Swin's bf16 step through the kernels (the text tower; the windows'
    masked attention on the JAX package's bf16 backward) against the fp32
    step through plain attention: loss 1e-2 relative, every gradient
    together at cosine >= 0.99 (the bf16 step row), each
    ``relative_position_bias_table``'s gradient among them and printed."""
    import torch

    loss_tol, min_cos = STEP_TOL["bfloat16"]
    _set_compute_dtype(model, torch.bfloat16)
    _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
    loss_k, grads_k = _loss_and_grads(model, head, cfg, batch)
    torch.cuda.synchronize()
    counts = _read_counts()
    _set_compute_dtype(model, torch.float32)
    _set_attn_impl(model, "xla")
    loss_p, grads_p = _loss_and_grads(model, head, cfg, batch)
    _set_attn_impl(model, "auto")
    cos, together = _grad_cosines(grads_k, grads_p)
    tables = [n for n in cos if n.endswith("relative_position_bias_table")]
    n_blocks = sum(model.visual.cfg.depths)
    lowest = min(cos, key=cos.get)
    low_t = min(tables, key=cos.get)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"hybrids (d) {SWIN_MODEL} DINO-soft step bf16 through the kernels vs fp32 plain, "
          f"batch {batch['images'].shape[0]}: loss {loss_k:.6f} vs {loss_p:.6f} (rel {rel:.2e}, "
          f"tol {loss_tol:g}); gradient cosine all tensors together {together:.7f} (need >= "
          f"{min_cos}), per tensor lowest {cos[lowest]:.7f} at {lowest}; the {len(tables)} "
          f"bias tables lowest {cos[low_t]:.7f} at {low_t}; launches {counts}, expected {want}",
          flush=True)
    check(counts == want, f"the {SWIN_MODEL} bf16 step launched {counts}")
    check(len(tables) == n_blocks and grads_k.keys() == grads_p.keys()
          and rel <= loss_tol and together >= min_cos and math.isfinite(loss_k),
          f"the {SWIN_MODEL} bf16 step disagrees with the fp32 plain step")
    return {"loss": loss_k, "together": together, "min_cosine": cos[lowest],
            "tables_min_cosine": cos[low_t]}


def phase_hybrids(work: str) -> dict:
    """The hybrid and windowed towers (phase 13e, the module docstring): (a)
    ViTamin-L by its ``datacomp1b`` tag from a seeded hub cache, loaded
    exactly, fp32 features through the kernels against plain attention (31
    launches an image call, 12 a text call), its tower time at
    ``HYBRID_BUCKETS``; (b) its bf16 DINO-soft step at ``HYBRID_BATCH`` under
    --grad-checkpointing against plain attention (62 + 24 forward, 31 + 12
    backward launches), its time and peak memory; (c) ViTamin-L-384 at full
    width, one fp32 forward at 8 under ``"flash"`` (31 flash launches, no
    fused forward) and under ``"auto"`` (31 fused at 576 tokens), each
    against plain attention; (d) swin_base_patch4_window7_224 seeded, fp32
    features (0 + 12 launches) and its bf16 step against the fp32 plain
    step (12 + 12). Returns the launches and numbers."""
    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, create_model, get_model_config, get_tokenizer, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.models.pretrained import (
        get_pretrained_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg

    t_phase = time.perf_counter()
    total = {"fused_attention_fwd": 0, "fused_attention_bwd": 0, "flash_attention_fwd": 0}
    out = {"launches": total}

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    cache = os.path.join(work, "hybrids_hub")
    dino = StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5, soft_mode="kl_teacher"))

    # ---- (a) ViTamin-L by its datacomp1b tag: a seeded file in the hub cache ----
    t0 = time.perf_counter()
    src, _ = create_model(HYBRID_MODEL, device="cpu", seed=SEED + 110)
    sd = src.state_dict()
    del src
    repo, fname = get_pretrained_cfg(HYBRID_MODEL, HYBRID_TAG)["hf_hub"].rstrip("/").rsplit("/", 1)
    _write_hub_repo(cache, repo, {fname: _hub_file_sd(sd)})
    t1 = time.perf_counter()
    model, _ = create_model(HYBRID_MODEL, pretrained=HYBRID_TAG, cache_dir=cache, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    exact = _exactly(model, sd)
    print(f"hybrids (a) {HYBRID_MODEL} ({n_params:,} parameters) from its {HYBRID_TAG!r} tag "
          f"(hub repo {repo}, {fname}, the text under text.): loaded exactly {exact}; seeded and "
          f"written in {t1 - t0:.2f} s, loaded in {time.perf_counter() - t1:.2f} s", flush=True)
    check(exact, f"{HYBRID_MODEL} by its tag does not hold the written values")
    tokenizer = get_tokenizer(HYBRID_MODEL)
    batch = _train_batch(tokenizer, HYBRID_BATCH, DEVICE, model_name=HYBRID_MODEL,
                         seed=SEED + 111)
    b8 = {k: v[:max(HYBRID_BUCKETS)] for k, v in batch.items()}
    _features_vs_plain(model, b8, f"(a) {HYBRID_MODEL}", {"image": 31, "text": 12}, add,
                       "hybrids")
    out["vitamin_tower_ms"] = _tower_times(model, b8, HYBRID_BUCKETS, f"(a) {HYBRID_MODEL}",
                                           "hybrids")
    print(f"hybrids (a): {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (c) ViTamin-L-384: ViTamin-L's weights, a seeded 576-row table ----
    t0 = time.perf_counter()
    with torch.device(DEVICE):
        big = build_model(parse_model_cfg(get_model_config(HYBRID_384)), init=False).eval()
    own = model.state_dict()
    g = torch.Generator().manual_seed(SEED + 112)
    with torch.no_grad():
        for k, v in big.state_dict().items():
            v.copy_(own[k] if own[k].shape == v.shape
                    else (torch.randn(v.shape, generator=g) * 0.02).to(DEVICE))
    size = get_model_config(HYBRID_384)["vision_cfg"]["image_size"]
    x = torch.from_numpy(np.random.default_rng(SEED + 113).normal(
        size=(8, size, size, 3)).astype(np.float32)).to(DEVICE)
    with torch.no_grad():
        _set_attn_impl(big, "xla")
        ref = big.encode_image(x, normalize=True)
        for impl, want in (("flash", {"flash_attention_fwd": 31, "fused_attention_fwd": 0,
                                      "fused_attention_bwd": 0}),
                           ("auto", {"flash_attention_fwd": 0, "fused_attention_fwd": 31,
                                     "fused_attention_bwd": 0})):
            _set_attn_impl(big, impl)
            _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
            got = big.encode_image(x, normalize=True)
            torch.cuda.synchronize()
            counts = _read_counts()
            add(counts)
            cos = float(torch.nn.functional.cosine_similarity(got.double(), ref.double(),
                                                              dim=-1).min())
            print(f"hybrids (c) {HYBRID_384} fp32 batch 8 ({(size // 16) ** 2} vision tokens) "
                  f"--attn-impl "
                  f"{impl}: launches {counts} (expected {want}), cosine vs plain attention min "
                  f"{cos:.8f} (need >= {MIN_COSINE})", flush=True)
            check(counts == want and cos >= MIN_COSINE and bool(torch.isfinite(got).all()),
                  f"{HYBRID_384} under {impl}")
    del big, x, ref, got
    torch.cuda.empty_cache()
    print(f"hybrids (c): {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (b) its bf16 DINO-soft step under --grad-checkpointing ----
    t0 = time.perf_counter()
    model.train().set_grad_checkpointing(True)
    torch.manual_seed(SEED + 114)
    head = DinoProjectionHead(model.text_projection.shape[1], DINO_DIM, "mlp").to(DEVICE)
    _set_compute_dtype(model, torch.bfloat16)
    want = {"flash_attention_fwd": 0, "fused_attention_fwd": 2 * (31 + 12),
            "fused_attention_bwd": 31 + 12}
    out["vitamin_step_bfloat16"] = _convnet_step_vs_plain(
        model, head, dino, batch, "bfloat16", want, f"(b) {HYBRID_MODEL} checkpointed",
        "hybrids")
    add(want)

    def fwd_bwd():
        _loss_and_grads(model, head, dino, batch)

    torch.cuda.reset_peak_memory_stats()
    out["vitamin_step_bf16_ms"] = time_ms(fwd_bwd, iters=3)
    out["vitamin_step_bf16_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"time hybrids (b) {HYBRID_MODEL} bf16 DINO-soft forward and backward at "
          f"{HYBRID_BATCH} under --grad-checkpointing: {out['vitamin_step_bf16_ms']:.3f} ms "
          f"(CUDA events), peak {out['vitamin_step_bf16_peak_gib']:.3f} GiB [{CARD}]", flush=True)
    del model, head, batch, b8, sd, own
    torch.cuda.empty_cache()
    print(f"hybrids (b): {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (d) swin_base_patch4_window7_224, seeded ----
    t0 = time.perf_counter()
    model, _ = create_model(SWIN_MODEL, device=DEVICE, seed=SEED + 115)
    n_params = sum(p.numel() for p in model.parameters())
    tokenizer = get_tokenizer(SWIN_MODEL)
    batch = _train_batch(tokenizer, HYBRID_BATCH, DEVICE, model_name=SWIN_MODEL, seed=SEED + 116)
    print(f"hybrids (d) {SWIN_MODEL}: {n_params:,} parameters", flush=True)
    _features_vs_plain(model, {k: v[:8] for k, v in batch.items()}, f"(d) {SWIN_MODEL}",
                       {"image": 0, "text": 12}, add, "hybrids")
    model.train()
    torch.manual_seed(SEED + 117)
    head = DinoProjectionHead(model.text_projection.shape[1], DINO_DIM, "mlp").to(DEVICE)
    want = {"flash_attention_fwd": 0, "fused_attention_fwd": 12, "fused_attention_bwd": 12}
    out["swin_step"] = _swin_bf16_vs_fp32_plain(model, head, dino, batch, want)
    add(want)
    del model, head, batch
    torch.cuda.empty_cache()
    print(f"hybrids (d): {time.perf_counter() - t0:.1f} s", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"hybrids: {out['seconds']:.1f} s, launches {total}", flush=True)
    return out


def _bn_away_from_init(model, seed: int) -> None:
    """Every BatchNorm's running statistics of ``model`` drawn away from
    0/1 (means N(0, 0.1), variances U(0.5, 1.5))."""
    import torch

    from refining_clip_via_dinov2_representations_torch.models.resnet import BatchNorm2d

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)


def _mobileclip_step(model, dino, batch, what: str, want: dict, add) -> dict:
    """The bf16 DINO-soft step of a MobileCLIP model through the kernels
    against plain attention, its BatchNorms training (``_convnet_step_vs_plain``:
    the running statistics of the two routes compared too), then its time
    (CUDA events) and peak memory."""
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import DinoProjectionHead

    model.train()
    torch.manual_seed(SEED + 135)
    head = DinoProjectionHead(model.embed_dim, DINO_DIM, "mlp").to(DEVICE)
    _set_compute_dtype(model, torch.bfloat16)
    out = _convnet_step_vs_plain(model, head, dino, batch, "bfloat16", want, what, "mobileclip")
    add(want)
    start = _bn_buffers(model)

    def fwd_bwd():
        _loss_and_grads(model, head, dino, batch)

    torch.cuda.reset_peak_memory_stats()
    out["ms"] = time_ms(fwd_bwd, iters=3)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    _set_bn_buffers(model, start)
    print(f"time mobileclip {what} bf16 DINO-soft forward and backward at "
          f"{batch['images'].shape[0]}: {out['ms']:.3f} ms (CUDA events), peak "
          f"{out['peak_gib']:.3f} GiB [{CARD}]", flush=True)
    _set_compute_dtype(model, torch.float32)
    model.eval()
    return out


def phase_mobileclip(work: str) -> dict:
    """MobileCLIP (phase 13f, the module docstring): (a) MobileCLIP-S2 by its
    ``datacompdr`` tag from a seeded hub cache, loaded exactly with the tag's
    preprocessing, fp32 features through the kernels against plain attention
    (0 launches an image call, 12 a text call), its tower time at
    ``MC_BUCKETS``; (d) its deploy form (``fuse_fastvit``) against the
    training form, fp32, and both forms' image time; (b) its bf16 DINO-soft
    step at ``MC_BATCH`` with its BatchNorms training, against plain
    attention (12 + 12 launches); (c) MobileCLIP-B from a seeded file in
    Apple's layout through ``load_checkpoint``, exactly, fp32 features (12 +
    12 launches), tower time, its bf16 step (24 + 24). Returns the launches
    and numbers."""
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import DinoLossCfg
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, create_model, get_model_config, get_tokenizer, load_checkpoint,
        parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.models.fastvit import fuse_fastvit
    from refining_clip_via_dinov2_representations_torch.models.pretrained import (
        get_pretrained_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg
    from scripts.mobileclip_apple_layout import to_apple_layout

    t_phase = time.perf_counter()
    total = {"fused_attention_fwd": 0, "fused_attention_bwd": 0, "flash_attention_fwd": 0}
    out = {"launches": total}

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    cache = os.path.join(work, "mobileclip_hub")
    dino = StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5, soft_mode="kl_teacher"))

    # ---- (a) MobileCLIP-S2 by its datacompdr tag: a seeded file in the hub cache ----
    t0 = time.perf_counter()
    src, _ = create_model(MC_S2, device="cpu", seed=SEED + 130)
    _bn_away_from_init(src, SEED + 131)
    sd = src.state_dict()
    del src
    hub_id = get_pretrained_cfg(MC_S2, MC_TAG)["hf_hub"].rstrip("/")
    _write_hub_repo(cache, hub_id, {"open_clip_pytorch_model.bin": sd})
    t1 = time.perf_counter()
    model, pp = create_model(MC_S2, pretrained=MC_TAG, cache_dir=cache, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    n_stats = sum(b.numel() for k, b in model.named_buffers() if ".running_" in k)
    exact = _exactly(model, sd)
    tag_pp = (tuple(pp.mean), tuple(pp.std), pp.resize_mode, pp.interpolation)
    print(f"mobileclip (a) {MC_S2} ({n_params:,} parameters, {n_stats:,} running statistics) "
          f"from its {MC_TAG!r} tag (hub repo {hub_id}): loaded exactly {exact}, preprocessing "
          f"{tag_pp}; seeded and written in {t1 - t0:.2f} s, loaded in "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    check(exact and n_params == 99_243_329 and n_stats == 124_480,
          f"{MC_S2} by its tag does not hold the written values")
    check(tag_pp == ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), "shortest", "bilinear"),
          f"{MC_S2}'s tag preprocessing {tag_pp}")
    tokenizer = get_tokenizer(MC_S2)
    batch = _train_batch(tokenizer, MC_BATCH, DEVICE, model_name=MC_S2, seed=SEED + 132)
    b8 = {k: v[:max(MC_BUCKETS)] for k, v in batch.items()}
    _features_vs_plain(model, b8, f"(a) {MC_S2}", {"image": 0, "text": 12}, add, "mobileclip")
    out["s2_tower_ms"] = _tower_times(model, b8, MC_BUCKETS, f"(a) {MC_S2}", "mobileclip")
    print(f"mobileclip (a): {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (d) the deploy form against the training form ----
    t0 = time.perf_counter()
    fused = fuse_fastvit(model)
    n_fused = sum(p.numel() for p in fused.visual.parameters())
    with torch.no_grad():
        want = model.encode_image(b8["images"], normalize=True).float()
        _zero_counts()  # ---- the main path: counts at 0 just before, read just after ----
        got = fused.encode_image(b8["images"], normalize=True).float()
        torch.cuda.synchronize()
        counts = _read_counts()
    cos = float(torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=-1).min())
    lat = {}
    with torch.inference_mode():
        for form, m in (("training", model), ("deploy", fused)):
            for b in MC_BUCKETS:
                x = b8["images"][:b]
                lat[f"{form} b{b}"] = time_ms(lambda: m.encode_image(x), iters=10)
                lat[f"{form} b{b} host"] = _host_ms(lambda: m.encode_image(x))
    out["s2_deploy_ms"] = lat
    print(f"mobileclip (d) {MC_S2} deploy form (fuse_fastvit: {n_fused:,} image parameters, no "
          f"BatchNorm) vs the training form, fp32 batch {b8['images'].shape[0]}: cosine min "
          f"{cos:.8f} (need >= {MIN_COSINE}), launches {counts} (expected none); image tower "
          f"per call (CUDA events; host clock with a sync, median of 10), ms: "
          f"{ {k: round(v, 4) for k, v in lat.items()} } [{CARD}]", flush=True)
    check(cos >= MIN_COSINE and bool(torch.isfinite(got).all()) and not any(counts.values())
          and not any(".running_" in k for k in fused.state_dict()),
          f"{MC_S2}'s deploy form disagrees with its training form")
    del fused
    print(f"mobileclip (d): {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (b) its bf16 DINO-soft step, its BatchNorms training ----
    t0 = time.perf_counter()
    want = {"flash_attention_fwd": 0, "fused_attention_fwd": 12, "fused_attention_bwd": 12}
    out["s2_step_bfloat16"] = _mobileclip_step(model, dino, batch, f"(b) {MC_S2}", want, add)
    del model, batch, b8, sd
    torch.cuda.empty_cache()
    print(f"mobileclip (b): {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (c) MobileCLIP-B from a seeded file in Apple's layout ----
    t0 = time.perf_counter()
    src, _ = create_model(MC_B, device="cpu", seed=SEED + 136)
    _bn_away_from_init(src, SEED + 137)
    with torch.no_grad():
        src.visual.trunk.head.bias.zero_()  # Apple's projection is a bare matrix
    sd = src.state_dict()
    del src
    path = os.path.join(work, "mobileclip_b_apple.pt")
    torch.save(to_apple_layout(sd), path)
    t1 = time.perf_counter()
    with torch.device(DEVICE):
        model = build_model(parse_model_cfg(get_model_config(MC_B)), init=False)
    missing, unexpected = load_checkpoint(model, path, strict=True)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    exact = _exactly(model, sd)
    print(f"mobileclip (c) {MC_B} ({n_params:,} parameters) from a seeded file in Apple's "
          f"layout (image_encoder.model.*, text_encoder.*) through load_checkpoint: loaded "
          f"exactly {exact} (missing {len(missing)}, unexpected {len(unexpected)}); seeded and "
          f"written in {t1 - t0:.2f} s, loaded in {time.perf_counter() - t1:.2f} s", flush=True)
    check(exact and n_params == 149_777_921 and not missing and not unexpected,
          f"{MC_B} from Apple's layout does not hold the written values")
    tokenizer = get_tokenizer(MC_B)
    batch = _train_batch(tokenizer, MC_BATCH, DEVICE, model_name=MC_B, seed=SEED + 138)
    b8 = {k: v[:max(MC_BUCKETS)] for k, v in batch.items()}
    _features_vs_plain(model, b8, f"(c) {MC_B}", {"image": 12, "text": 12}, add, "mobileclip")
    out["b_tower_ms"] = _tower_times(model, b8, MC_BUCKETS, f"(c) {MC_B}", "mobileclip")
    want = {"flash_attention_fwd": 0, "fused_attention_fwd": 24, "fused_attention_bwd": 24}
    out["b_step_bfloat16"] = _mobileclip_step(model, dino, batch, f"(c) {MC_B}", want, add)
    del model, batch, b8, sd
    torch.cuda.empty_cache()
    print(f"mobileclip (c): {time.perf_counter() - t0:.1f} s", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"mobileclip: {out['seconds']:.1f} s, launches {total}", flush=True)
    return out


# every kernel case list of phases 3, 3b, 5 and 6, by name (``run_subset``)
CASE_LISTS = ("KERNEL_CASES", "TIMED_CASES", "TRAIN_CASES", "BWD_TIMED", "BWD_CASES",
              "TEACHER_CASES", "SLICE10_CASES", "GIANT_CASES", "TP_CASES", "TP_BWD_CASES",
              "COCA_CASES", "SIGLIP_CASES", "SIGLIP_TIMED", "TP_SERVE_CASES", "ZOO_CASES",
              "ZOO_BWD_CASES", "EVA02_CASES", "EVA02_BWD_CASES", "CONVNET_CASES",
              "CONVNET_BWD_CASES", "HYBRID_CASES", "HYBRID_TIMED", "HYBRID_BWD_CASES",
              "HYBRID_FLASH_CASES", "MOBILECLIP_CASES", "MOBILECLIP_BWD_CASES")


def run_subset(keep, phases) -> None:
    """A short card run of a few pieces (``scripts/chip_*_phase.py``): the
    device and the build; phases 3, 3b, 5 and 6 on the case lists named in
    ``keep`` alone (every other list of ``CASE_LISTS`` emptied); then
    ``phases(work, d)`` on mini-Flickr cut to 14 + 7 images, in a directory
    under ``build/`` removed at the end. Prints the seconds after each step
    and ``RESULT`` with what ``phases`` returns."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    phase_device()
    phase_build()
    print(f"elapsed {time.perf_counter() - t0:.1f}", flush=True)
    unknown = set(keep) - set(CASE_LISTS)
    check(not unknown, f"run_subset: no case list {sorted(unknown)}")
    for name in CASE_LISTS:
        if name not in keep:
            globals()[name] = []
    phase_kernels()
    phase_kernels_bwd()
    for dtype_name in ("float32", "bfloat16"):
        phase_kernel_times(dtype_name)
        phase_bwd_times(dtype_name)
    print(f"elapsed {time.perf_counter() - t0:.1f}", flush=True)
    global EVAL_TRAIN_IMAGES, EVAL_VAL_IMAGES
    EVAL_TRAIN_IMAGES, EVAL_VAL_IMAGES = 14, 7
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(dir=build)
    try:
        out = phases(work, phase_data(work))
        print("RESULT", json.dumps(out, default=str), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"elapsed {time.perf_counter() - t0:.1f}", flush=True)


def _dist_child_main() -> None:
    import faulthandler

    faulthandler.enable()  # a crash in native code prints where it happened
    role, payload = sys.argv[2], json.loads(sys.argv[3])
    result = {"train": _child_train, "probe": _child_probe, "step": _child_step,
              "tp": _child_tp}[role](payload)
    print("DIST_CHILD " + json.dumps(result), flush=True)


def main() -> None:
    import shutil
    import tempfile

    import torch

    t_start = time.perf_counter()

    def _elapsed(phase: str) -> None:
        print(f"elapsed after {phase}: {time.perf_counter() - t_start:.1f} s", flush=True)

    phase_device()
    _elapsed("device")
    # the dist phase's gloo probes launch no kernel: their processes run
    # beside the build and are waited for before the first timed phase
    # (their results are read in phase 20)
    from concurrent.futures import ThreadPoolExecutor

    def probe():
        carried = _probe_gloo_cuda()
        return carried, time.perf_counter() - t_start

    with ThreadPoolExecutor(1) as probe_pool:
        probes = probe_pool.submit(probe)
        phase_build()
        _elapsed("build")
        carried, probes_end = probes.result()
    print(f"gloo probes ended {probes_end:.1f} s after the start", flush=True)
    _elapsed("gloo probes")
    engine, plain, serve_launches = phase_serve()
    _elapsed("serve")
    export_launches = phase_export(engine)
    _elapsed("export")
    rows = phase_kernel_times("float32")
    _elapsed("kernel_times")
    rows_bf16 = phase_kernel_times("bfloat16")
    _elapsed("kernel_times")
    phase_serving_times(engine, plain)
    _elapsed("serving_times")
    check(serve_launches > 0, "the served run launched no fused_attention_fwd")
    del engine, plain
    torch.cuda.empty_cache()
    train_fwd, train_bwd = phase_train_step()
    _elapsed("train_step")
    check(train_fwd > 0 and train_bwd > 0, "the train steps launched no kernel")
    phase_train_cli()
    _elapsed("train_cli")
    # a work directory inside the checkout's (ignored) build tree, for the
    # mini-Flickr set, the runs and the seeded teacher
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_work_", dir=build)
    try:
        data = phase_data(work)
        _elapsed("data")
        coca = phase_coca(work, data)
        _elapsed("coca")
        siglip = phase_siglip(work, data)
        _elapsed("siglip")
        eval_cli = phase_train_eval_cli(data, work)
        _elapsed("train_eval_cli")
        pp = phase_preprocess(data, work, eval_cli)
        _elapsed("preprocess")
        teacher_dir, teacher_launches = phase_teacher(work)
        _elapsed("teacher")
        extracted, extract_launches = phase_extract(data, teacher_dir, work)
        _elapsed("extract")
        live = phase_train_live_cli(data, teacher_dir, work, extracted)
        _elapsed("train_live_cli")
        pre = phase_pretrained(work)
        _elapsed("pretrained")
        int8_launches = phase_int8(data, pre)
        _elapsed("int8")
        zoo = phase_zoo(work, data, pre)
        _elapsed("zoo")
        convnets = phase_convnets(work)
        _elapsed("convnets")
        hybrids = phase_hybrids(work)
        _elapsed("hybrids")
        mobileclip = phase_mobileclip(work)
        _elapsed("mobileclip")
        zs = phase_zero_shot(data, pre, work)
        _elapsed("zero_shot")
        ft = phase_finetune(data, pre, zs, work)
        _elapsed("finetune")
        off = phase_offline(data, pre, ft, work)
        _elapsed("offline")
        config2 = phase_config2(data, pre, work)
        _elapsed("config2")
        accum = phase_accum(teacher_dir)
        _elapsed("accum")
        giant = phase_giant(work)
        _elapsed("giant")
        # the kernels against their plain and float64 versions (phases 3, 3b
        # and 7: checks that time nothing) run beside the processes
        dist_launches, tp, preempted, (worst, worst_bwd, worst_flash) = phase_processes(
            work, carried, data, pre, config2,
            beside=lambda: (phase_kernels(), phase_kernels_bwd(), phase_kernels_flash()))
        _elapsed("dist, tp and the preempted run, and phases 3, 3b and 7")
        phase_config2_resume(work, config2, preempted)
        _elapsed("config2 resume")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bwd_rows = phase_bwd_times("bfloat16")
    _elapsed("bwd_times")
    bwd_rows32 = phase_bwd_times("float32")
    _elapsed("bwd_times")
    long_launches = phase_train_long()
    _elapsed("train_long")
    phase_train_cli_long()
    _elapsed("train_cli_long")
    flash_rows = phase_flash_times()
    _elapsed("flash_times")

    t = rows[MAIN_PATH_CASE]
    t16 = rows_bf16[TRAIN_CASES[0]]  # the training image call, bf16
    tb = bwd_rows[TRAIN_CASES[0]]
    tb32 = bwd_rows32[TRAIN_CASES[0]]
    tf = flash_rows[FLASH_TIMED[0]]
    tf32 = flash_rows[FLASH_TIMED[1]]  # the ViT-L-14-336 vision call, fp32
    print(json.dumps({"kernels": [{
        "name": "fused_attention_fwd", "route": "cuda", "source": FUSED_SRC,
        "replaces": FUSED_TPU,
        "launches": serve_launches + train_fwd + eval_cli["fused_attention_fwd"]
        + teacher_launches + extract_launches + live["fused_attention_fwd"]
        + pre["launches"]["fused_attention_fwd"] + zs["counts"]["fused_attention_fwd"]
        + ft["counts"]["fused_attention_fwd"] + off["fused_attention_fwd"]
        + config2["launches"]["fused_attention_fwd"] + accum["fused_attention_fwd"]
        + giant["launches"]["fused_attention_fwd"] + dist_launches["fused_attention_fwd"]
        + tp["launches"]["fused_attention_fwd"] + coca["launches"]["fused_attention_fwd"]
        + siglip["launches"]["fused_attention_fwd"] + int8_launches["fused_attention_fwd"]
        + export_launches["fused_attention_fwd"] + zoo["launches"]["fused_attention_fwd"]
        + pp["fused_attention_fwd"] + convnets["launches"]["fused_attention_fwd"]
        + hybrids["launches"]["fused_attention_fwd"]
        + mobileclip["launches"]["fused_attention_fwd"],
        "max_abs_err": worst["float32"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "bf16_shape": list(TRAIN_CASES[0][:4]), "bf16_ms": t16["ms"],
        "bf16_plain_ms": t16["plain_ms"], "bf16_bound_ms": t16["bound_ms"],
        "bf16_library_ms": t16["library_ms"],
        "teacher": [{"shape": list(case[:4]), "dtype": dtype_name, **by_case[case]}
                    for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                    for case in TEACHER_CASES],
        "evaluation": [{"shape": list(case[:4]), "dtype": dtype_name, **by_case[case]}
                       for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                       for case in SLICE10_CASES],
        "giant": [{"shape": list(case[:4]), "causal": case[4], "dtype": dtype_name,
                   **by_case[case]}
                  for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                  for case in GIANT_CASES],
        "tp": [{"shape": list(case[:4]), "causal": case[4], "dtype": dtype_name,
                **by_case[case]}
               for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
               for case in TP_CASES],
        "coca": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                  **by_case[_case_key(case)]}
                 for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                 for case in COCA_CASES],
        "siglip": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                    **by_case[_case_key(case)]}
                   for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                   for case in SIGLIP_TIMED],
        "tp_serve": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                  **by_case[_case_key(case)]}
                 for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                 for case in TP_SERVE_CASES],
        "zoo": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                 **by_case[_case_key(case)]}
                for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                for case in ZOO_CASES],
        "eva02": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                   **by_case[_case_key(case)]}
                  for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                  for case in EVA02_CASES],
        "convnets": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                      **by_case[_case_key(case)]}
                     for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                     for case in CONVNET_CASES],
        "hybrids": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                     **by_case[_case_key(case)]}
                    for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                    for case in HYBRID_TIMED],
        "mobileclip": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                        **by_case[_case_key(case)]}
                       for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                       for case in MOBILECLIP_CASES],
    }, {
        "name": "fused_attention_bwd", "route": "cuda", "source": BWD_SRC,
        "replaces": BWD_TPU,
        "launches": train_bwd + eval_cli["fused_attention_bwd"] + live["fused_attention_bwd"]
        + ft["counts"]["fused_attention_bwd"] + config2["launches"]["fused_attention_bwd"]
        + accum["fused_attention_bwd"] + giant["launches"]["fused_attention_bwd"]
        + dist_launches["fused_attention_bwd"] + tp["launches"]["fused_attention_bwd"]
        + coca["launches"]["fused_attention_bwd"] + siglip["launches"]["fused_attention_bwd"]
        + zoo["launches"]["fused_attention_bwd"] + pp["fused_attention_bwd"]
        + convnets["launches"]["fused_attention_bwd"]
        + hybrids["launches"]["fused_attention_bwd"]
        + mobileclip["launches"]["fused_attention_bwd"],
        "max_abs_err": worst_bwd["bfloat16"],
        "ms": tb["ms"], "plain_ms": tb["plain_ms"], "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"], "library_ms": tb["library_ms"],
        "fp32_shape": list(TRAIN_CASES[0][:4]), "fp32_max_abs_err": worst_bwd["float32"],
        "fp32_ms": tb32["ms"], "fp32_plain_ms": tb32["plain_ms"],
        "fp32_bound_ms": tb32["bound_ms"], "fp32_bound_by": tb32["bound_by"],
        "fp32_library_ms": tb32["library_ms"],
        "giant": [{"shape": list(case[:4]), "causal": case[4], "dtype": dtype_name,
                   **by_case[case]}
                  for dtype_name, by_case in (("float32", bwd_rows32), ("bfloat16", bwd_rows))
                  for case in GIANT_CASES],
        "tp": [{"shape": list(case[:4]), "causal": case[4], "dtype": dtype_name,
                **by_case[case]}
               for dtype_name, by_case in (("float32", bwd_rows32), ("bfloat16", bwd_rows))
               for case in TP_BWD_CASES],
        "coca": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                  **by_case[_case_key(case)]}
                 for dtype_name, by_case in (("float32", bwd_rows32), ("bfloat16", bwd_rows))
                 for case in COCA_CASES],
        "siglip": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                    **by_case[_case_key(case)]}
                   for dtype_name, by_case in (("float32", bwd_rows32), ("bfloat16", bwd_rows))
                   for case in SIGLIP_TIMED],
        "tp_serve": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                  **by_case[_case_key(case)]}
                 for dtype_name, by_case in (("float32", bwd_rows32), ("bfloat16", bwd_rows))
                 for case in TP_SERVE_CASES],
        "zoo": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                 **by_case[_case_key(case)]}
                for dtype_name, by_case in (("float32", bwd_rows32), ("bfloat16", bwd_rows))
                for case in ZOO_BWD_CASES],
        "eva02": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                   **by_case[_case_key(case)]}
                  for dtype_name, by_case in (("float32", bwd_rows32), ("bfloat16", bwd_rows))
                  for case in EVA02_BWD_CASES],
        "convnets": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                      **by_case[_case_key(case)]}
                     for dtype_name, by_case in (("float32", bwd_rows32), ("bfloat16", bwd_rows))
                     for case in CONVNET_BWD_CASES],
        "hybrids": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                     **by_case[_case_key(case)]}
                    for dtype_name, by_case in (("float32", bwd_rows32), ("bfloat16", bwd_rows))
                    for case in HYBRID_BWD_CASES],
        "mobileclip": [{"shape": list(case[:5]), "causal": case[5], "dtype": dtype_name,
                        **by_case[_case_key(case)]}
                       for dtype_name, by_case in (("float32", bwd_rows32), ("bfloat16", bwd_rows))
                       for case in MOBILECLIP_BWD_CASES],
    }, {
        "name": "flash_attention_fwd", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_TPU,
        "launches": long_launches + pre["launches"]["flash_attention_fwd"]
        + hybrids["launches"]["flash_attention_fwd"],
        "max_abs_err": worst_flash["bfloat16"], "ms": tf["ms"], "plain_ms": tf["plain_ms"],
        "bound_ms": tf["bound_ms"], "bound_by": tf["bound_by"], "library_ms": tf["library_ms"],
        "fp32_shape": list(FLASH_TIMED[1][:3]) + [FLASH_TIMED[1][4]],
        "fp32_max_abs_err": worst_flash["float32"], "fp32_ms": tf32["ms"],
        "fp32_plain_ms": tf32["plain_ms"], "fp32_bound_ms": tf32["bound_ms"],
        "fp32_bound_by": tf32["bound_by"], "fp32_library_ms": tf32["library_ms"],
        "hybrids": [{"shape": list(case[:5]), "causal": case[5], "dtype": case[6], **row}
                    for case, row in flash_rows.items() if case[2] == 576],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:
        _dist_child_main()
    else:
        main()
