#!/usr/bin/env python3
"""Run vfs_tpu_torch's paths on one CUDA card and hold every kernel against
its plain PyTorch version.

    python3 chip_smoke.py            # every phase, on one card

Phases, one JSON line each on stdout:

1. build: compile the package's CUDA sources (``nvcc``, sm_90a), one
   ``nvcc`` per source, and the two native host decoders of slice 11
   (``g++`` against libjpeg and FFmpeg, ``datasets.native_loader``), all
   started together; each kernel's ``ptxas`` registers and spills, and
   whether each decoder built (with the compiler's line where it did not:
   not a failure, the decode steps then take cv2). Then the card's name
   and power limit as ``nvidia-smi`` gives them. Then the ``native`` line:
   cv2's decode of one ``write_davis`` video's 48 480x854 JPEGs in ms a
   frame and, where the JPEG library built, the native decode (bit-equal
   to cv2's) and its yuv420 planes; ``NATIVE_CLIPS`` of the train phase's
   Kinetics clips, sampled as the r18 config samples them, through
   ``OpenCVInit``/``OpenCVDecode`` in ms a sample and, where the FFmpeg
   library built, ``DecordInit``/``DecordDecode`` native (bit-equal); the
   card's ``'jpeg'`` yuv420 unpack against the CPU's within
   ``YUV_CARD_CPU_ATOL`` on those frames (the native planes, else
   full-range planes from cv2's YCrCb).
2. small: each kernel vs its plain version over a small-shape matrix:
   ``video_topk_affinity`` over the CPU tests' cases plus a
   duplicated-frame tie case; ``local_topk_attend`` over odd maps,
   invalid slots, top-k up to its maximum, K = 4 and 16, filler entries
   and a duplicated-frame tie case. All four kernels also at the edges of
   their 8 x 32 query tiles and 32-channel chunks (a map smaller than a
   tile, h and w not multiples of it, C = 4 and 260, top-k 32, radius 32),
   the video kernels on a t <= P case where frame 0's two bank entries
   both enter the lists. ``video_topk_affinity_v1`` over row 1's cases,
   two wider radii and temporally smooth features, under every
   ``video_extract`` and ``early_exit``: the lists equal row 1's and each
   other's bit for bit, and on smooth features the tau exit merges fewer
   (query, key row) pairs. ``local_topk_attend_v2`` over
   ``local_topk_attend``'s cases and a wider radius; both on banks of
   mostly invalid slots (one valid slot of 21, 17 of 21, none at all).
   Row 3's mode entries (slice 10: bf16 scores and packed, each with fp32
   and bf16 features) over row 3's small, edge and sparse cases and a
   duplicated-frame tie case, against their plain versions
   (``compare_mode``) and, with bf16 features, against the mode's fp32
   entry on the widened features bit for bit; packed with bf16 scores
   must raise.
3. full: every kernel at the r18 (C=256, radius 12) and r50 (C=1024,
   radius 18) DAVIS-480p shapes (60x107 cells, P=20, top-10) with
   CUDA-event timings (median of 5 after a warm-up), the work, the bound
   and its share. ``video_topk_affinity`` and ``video_topk_affinity_v1``
   at T=24 and T=48, v1 with the tau exit on and off, on random and on
   smooth features, with the merges it ran; ``local_topk_attend`` and
   ``local_topk_attend_v2`` for one step against a full bank (F=21
   slots, K=4). ``local_topk_attend_v2``'s path is its op entry point,
   called once per model with its count set to 0 before; it is also held
   against ``local_topk_attend``'s kernel, which computes the same
   function. Rows 2 and 4 must equal rows 1 and 3 bit for bit. Row 3's
   mode entries on the same step: the mode gates, their ms beside the
   exact fp32 entry's in turn, the plain version's, the bound and its
   share, and the packed re-score's time apart (the merge kernel's
   profiler time, packed against exact).
4. main: slice 1's path, DAVIS label-propagation eval of the r18 model of
   configs/r18_nc_sgd_cos_100e_r2_1xNx8_k400.py at full width with seeded
   random weights, on a synthetic 48x480x854 two-object video, through
   ``build_model(...).forward_test``; ``video_topk_affinity``'s launch
   count must rise and the masks must agree with a run whose phase 1 is
   the plain version. Then slice 11's demo on the video's first
   ``DEMO_FRAMES`` frames: ``tools.demo.propagate`` on the card with the
   config's weights saved as a ``.pth`` (row 1's count must rise, the
   masks must equal ``forward_test``'s with the same weights), then
   ``tools.demo.main`` end to end where this cv2 writes mp4v
   (``demo_mp4``: written or unavailable).
4b. wide: slice 14's wide kernel (``csrc/window_topk_wide.cu``), which
   the four rows' wrappers launch where the core's limits (r <= 31, topk
   <= 32) do not hold, at any radius and top-k, as the JAX package takes
   them. Small shapes through the wrappers (``WIDE_VIDEO_CASES``,
   ``WIDE_LOCAL_CASES``: top-k past 32, r past 31, C = 260, fillers, a
   duplicated-frame tie case at top-40; every row 3 mode, bf16 features)
   against the plain versions under the small phase's gates, rows 2 and 4
   bit-equal to rows 1 and 3; then the r18 full width (C = 256, 60 x 107,
   T = 24, P = 20, so the ring wraps; a step against 21 slots, K = 4) at
   radius 40 / top-10 and radius 12 / top-48: the gates, CUDA-event ms,
   the plain version's ms and the bound (row 4 through its op entry), and
   row 3w's time split by channel count, feature type and top-k
   (``WIDE_SPLIT_*``); the wide ops
   (``*_wide_cuda``) forced at radius 12 / top-10 and at the core's edge,
   radius 32 / top-32 (``WIDE_FORCED``), must equal rows 1 and 3 bit for
   bit in every mode and feature type; rows 1w and 3w at the r50 width (C
   = 1024) at radius 40 / top-10 against the plain version, with ms,
   plain ms and the bound (``wide_r50``). Then r18 ``forward_test``
   on the main path's video at ``neighbor_range=80`` for ``backend``
   ``'tiled'``, ``'pallas_video'`` with ``video_engine='v1'`` and
   ``'pallas'``: the wide kernel launches on each path (rows 1 and 2 once,
   row 3 once a step) and no core, and the masks agree with the tiled
   run's on >= 99.9% of pixels. The comm helpers of slice 14 run once, in
   the bench_cfg phase's first one-rank NCCL group (``comm_checks``).
4c. wgrad3d: the narrow weight-gradient kernel (``csrc/conv3d_wgrad.cu``,
   ``ops/conv3d_wgrad.py``) that ``ConvBN3d`` routes SlowFast's narrow
   convolutions to in fp32 training. ``WGRAD3D_SMALL`` (the five families,
   ragged tiles, padding, strides, in NCDHW and NDHWC) against float64
   within ``WGRAD3D_SMALL_TOL``, dW in the weight's strides; then each
   routed convolution of ``train_slowfast_r50`` (``conv3d_shapes``)
   at the cell's shapes: kernel, plain and cuDNN (``library_ms``,
   ``torch.nn.grad.conv3d_weight`` with TF32 off) ms, the bound (the
   positions of X that the taps read, dY, dW) and its share, each one's
   largest gap to float64 (the kernel's no worse than cuDNN's), two runs
   bit for bit, one launch counted on the wrapper and on the program
   counter ``conv3d.narrow_wgrad``; then a ``ConvBN3d`` step on the card
   through the routing, its gradient as cuDNN's; then the main path: one
   full-width step of the cell's model, optimizer and 32 clips through
   ``make_train_step`` with the launch count set to 0 just before it,
   which must launch the kernel once for each module the rule routes,
   on the wrapper and on the program counter.
5. eval: slice 2's path, the config-driven DAVIS eval of the r50 model
   (configs/r50_nc_sgd_cos_100e_r5_1xNx2_k400.py, full width, seeded
   random weights saved as a torchvision-layout ``.pth``) through
   ``python -m vfs_tpu_torch.tools.test``, run in-process with
   ``test_cfg.backend=pallas`` on a synthetic DAVIS-layout dataset of
   ``EVAL_VIDEOS`` (one) 48x480x854 videos written to a
   temporary directory under ``build/``.
   ``local_topk_attend`` must launch once per step (47 a video), the masks
   must agree with the same command under ``backend=pallas_video`` and, on
   one video, with a run whose per-step attention is the plain version.
   The counted run's stage times come from CUDA events around
   ``VanillaTracker._extract_feats`` and ``propagate_video``. Then the
   same command with ``test_cfg.pallas_extract=packed`` and with
   ``test_cfg.pallas_scores=bfloat16``: each mode's entry launches once
   per step, and the masks agree with the exact run's on
   ``MODE_AGREEMENT``'s share of pixels (0.999 packed, 0.99 bf16
   scores).
5b. all_blocks: the r50 config's second shipped eval (BASELINE.json:
   DAVIS-2017 label propagation with all res4 blocks),
   ``python -m vfs_tpu_torch.tools.test --options
   test_cfg.all_blocks=True`` in-process on one synthetic 48x480x854
   video with the eval phase's seeded r50 weights, their BatchNorm
   scales and shifts drawn (``write_backbone(randomize_bn=True)``: the
   init's zero ``bn3`` scales would make layer3's blocks 1-5 identities),
   in exact fp32 on the default engine (row 1). ``ResNetBlockwise`` gives
   one bank a layer3 Bottleneck (6) and the tracker propagates each: row
   1 must launch 6 times; the six banks must equal the plain ``ResNet``'s
   ``layer3[j]`` outputs taken with forward hooks on the same frames (bit
   for bit, or within rtol / atol 1e-5: ``layer3_bit_equal`` says which);
   the last block's masks must equal the standard eval's; each block's
   masks must agree with a run whose phase 1 is the plain version on >=
   99.9% of pixels; the result must hold ``feat_0`` ... ``feat_5``
   ``J&F-Mean``. Extraction and propagation (with decode, per block) ms a
   frame from CUDA events, one block's synchronous mask readback in ms
   (CUDA events around the copy of its (48, 480, 854) masks), and the
   run's peak device memory.
6. pose: slice 3's JHMDB path, pose-keypoint propagation with PCK of the
   r18 model (full width, seeded random weights as a ``.pth``) through
   ``python -m vfs_tpu_torch.tools.test --eval pck`` in-process, with
   ``test_cfg.video_engine=v1 video_extract=perframe``, on a synthetic
   JHMDB-layout dataset of two 40-frame 240x320 videos with 15 moving
   joints. ``video_topk_affinity_v1`` must launch once per video; the
   heatmaps must agree with the same command under ``video_engine=v2``
   within 1e-5 (PCK equal) and, on one video, with a run whose phase 1
   is the plain version. The counted eval's wall is followed by
   ``POSE_REPEATS`` more of the same path, and their median.
7. vip: slice 3's VIP path, part segmentation with mIoU of the r50 model
   (``--eval mIoU``, ``video_engine=v1``, the default
   ``video_extract='sweep'``) on two synthetic 48-frame 480x854 videos
   with 19 moving parts; one launch per video, masks on >= 99.9% of
   pixels equal to the ``video_engine=v2`` run (mIoU equal) and, on one
   video, to a plain-phase-1 run.
8. train: slice 6's path, SimSiam pretraining of the r18 config at full
   width (ResNet-18, the 512-512-512 / 128-512 head, 32 samples of two
   4-frame 224x224 clips: 256 frames a step) with seeded random weights,
   through ``python -m vfs_tpu_torch.tools.train --validate
   --auto-resume`` in-process, on a synthetic Kinetics-layout set of 32
   MJPG clips of 16 256x340 frames under ``build/`` (``write_k400``; the
   same clips in mp4v beside them for the second card-vs-CPU batch;
   decoded natively where the FFmpeg library built, else by cv2:
   ``loader_video_decoder``; ``RepeatDataset``
   times 2: 2 steps an epoch) with the config's 16 loader processes, and
   ``write_davis``'s layout with two 10-frame 480x854 videos for the eval
   hook. Two epochs: every loss finite, ``video_topk_affinity`` launched
   once per val video per eval epoch, ``epoch_1``, ``epoch_2`` and
   ``best.json`` written; a second call with ``total_epochs=3`` resumes
   from ``epoch_2``, runs epoch 3 alone and ends at step 6. Then one
   step at B=2 from the same weights and batch on the card and on the CPU,
   each in exact fp32 and in fp64 (see the tolerances below), on the
   first two samples of the first batch of a ``GATE_LOADER_BATCHES``-batch
   loader epoch over the MJPG clips and over the mp4v clips, built as the
   loader's first worker builds them (``loader_first_batch``):
   ``card_vs_cpu``, and on the mp4v batch ``card_vs_cpu_kinks``, with
   each ReLU's decision taken from the fp64 step; the
   device-only step time (median of
   ``TIMED_STEPS`` CUDA-event-timed steps after ``WARMUP_STEPS`` on a
   batch already on the card), ``train_mfu`` and peak memory in exact
   fp32 and in bf16 (the bf16 step's first backbone features and
   gradients within ``BF16_REL_L2`` of the fp32 step's and its loss
   within ``BF16_LOSS_ATOL``, BatchNorm statistics fp32), and ``torch.profiler``'s kernel times of three more
   steps by kind. End to end and the loader, in a window that keeps all
   16 loader processes busy (a process builds a whole batch): a
   ``tools.train`` run of one epoch of ``HOST_E2E_BATCHES`` steps on the
   same clips (``RepeatDataset`` times raised), whose steps/s leaves out
   the first step; the loader alone over a warm epoch of
   ``LOADER_BATCHES``; and the pipeline's samples/s in this process. The
   eval hook's J&F and wall. Then slice 7's on-device augmentation, the
   ``_deviceaug`` config (the same model; the loader decodes and stages
   256x320 uint8 frames, the chain crops them to 224x224 in the step) on
   the same clips, a line of its own (``train_deviceaug``): the host
   loader's samples/s over a warm epoch of ``LOADER_BATCHES`` and its
   bytes a batch; ``tools.train``'s steps/s over an epoch of
   ``E2E_BATCHES`` steps, beside the host-aug config's; ``--profile 2``
   over ``DA_RUN_EPOCHS`` 1-step epochs, whose trace must name the steps'
   convolution kernels, and an auto-resume of the last epoch, whose draws
   must equal the whole run's; the chain on a B=2 batch with the same
   drawn parameters on the card and the CPU (within ``DA_CARD_CPU_ATOL``
   on the [0, 255] scale); the chain's ms and kernel launches on the full
   batch, and the device-only step with the chain in exact fp32 and bf16.
8b. train_r50: the r50 pretraining config
   (configs/r50_nc_sgd_cos_100e_r5_1xNx2_k400.py: ResNet-50 with
   ``zero_init_residual``, the 2048-wide head, ``intra_video=False``, 32
   samples of two 1-frame 224x224 clips: 64 frames a step) at full width
   with seeded random weights through ``python -m
   vfs_tpu_torch.tools.train --validate --auto-resume`` in-process on its
   own copy of the train phase's clips (MJPG; the config's 16 loader
   processes), one epoch of ``R50_EPOCH_STEPS`` steps with the DAVIS hook
   on two 10-frame 480x854 videos, then a resume that runs epoch 2 and its
   eval: losses finite, ``epoch_1`` and ``epoch_2`` written, row 1
   launched once per val video per epoch. Then the device-only exact-fp32
   step on the loader's first MJPG batch on the card (median of
   ``TIMED_STEPS`` after ``WARMUP_STEPS``), ``train_mfu`` on
   ``train_flops``, peak memory and ``device_breakdown``; and
   ``card_vs_cpu_kinks`` on the first ``R50_GATE_SAMPLES`` samples of the
   first MJPG and mp4v batches.
9. dense: slice 7's dense tier, r18 ``forward_test`` at full width on a
   ``DENSE_FRAMES``-frame 480x854 video under each of ``DENSE_RUNS`` (the
   masked path with the first frame exempt, ``non_mask_len=1``; no mask,
   ``backend='dense'``): warm ms/frame on the card, no kernel launched,
   masks equal to the CPU run's on >= 99.9% of pixels.
10. learning: slice 7's learning loop, ``python -m
   vfs_tpu_torch.tools.learning_loop`` at its defaults (seed 0, 24 epochs
   of 12 steps, batch 8, 64x64 crops) on the card: both J&F values, both
   retrieval values, the margins and the wall; ``retrieval_margin`` must
   be positive; ``video_topk_affinity`` launches once per val video and
   tracker (24).
11. bench_cfg: slice 8's path, the JAX bench's eval configuration
   (bench.py:41,63-72,114-124: bf16 features in rows 1-3, a bf16 backbone,
   yuv420 transport; P=20, top-10, batch_step 20, neighbor 24 for r18 and
   36 for r50) on bench.py's three seeded noise videos (80x480x854,
   60x480x910, 100x480x768) with seeded weights. First rows 1-3's bf16
   entries at small shapes (C = 8, 16, 72, tie cases), then per depth:
   rows 1-3 in bf16 at the DAVIS shapes against their plain versions (the
   fp32 gates), against their fp32 entries on the widened features and
   row 2 against row 1 (bit for bit), with bf16 and fp32 times in turn and
   the bound two ways: ``bound_ms`` and ``bound_share`` on the bf16 dense
   tensor cores (the card's peak for these operands), ``ffma_bound_ms``
   and ``ffma_share`` on the fp32 CUDA cores (the design's FFMAs); the
   production eval loop (``single_process_test``) over the three videos,
   counted (row 1's bf16 entry once per video) and timed warm
   (``e2e_fps``, peak memory); extraction ms/frame of the bf16 and fp32
   backbones on the packed frames; bytes a frame, the host pack and the
   pageable host-to-device copy, yuv420 against RGB; the card's
   ``yuv420_to_rgb`` against the CPU's; bench.py's two agreement checks
   on the first 20 frames of video 0 (the fp32 kernel against
   ``tiled``, which in the port is the same engine, and against a plain
   phase 1, >= 99.9%; bf16 against fp32 over the floor, 0.97 r18 / 0.98
   r50); the v1 engine (row 2) and the scan (row 3) in bf16 on those
   frames, counted, their masks against the v2 run's; and one
   ``multi_process_test`` in a one-rank NCCL group against
   ``single_process_test`` on the three videos' first 20 frames.
12. siamfc: slice 9's path, SiamFC tracking (``projects/siamfc/
   siamfc_tpu_torch``) at r18's full width (``default_cfg``: exemplar
   120, instance 255, 3 scales, the 512-512 1x1 head; seeded weights, the
   backbone saved as a torchvision ``.pth``) on bench.py's tracking
   fixture (tools/analysis/bench_track.py make_fixture: 4 sequences x 50
   frames at 360x640, seed 7, under ``build/``), through
   ``ExperimentOTB.run`` in bench.py's two modes: ``host_seq`` (host cv2
   crops, sequential) and ``dev_batch2`` (device crops and response post,
   ``track_batch(2)`` over two interleaved streams), and
   ``track_batch(8)`` over the four sequences at once; gated as bench.py
   gates (bench.py:84-88): device against host boxes within 2.0 px and
   the device path's precision@20 over a floor (``TRACK_GATES``:
   bench.py's 0.95 is above what the JAX package's own seeded weights
   reach, so the floor is the port's seed-0 known-good less a margin; its
   20-fps floor is a TPU figure and is not carried). A per-frame split of
   one ``track_batch(2)`` stream (host clocks: reads, region cuts with
   taps; CUDA events: upload, crops, backbone, xcorr, post, readback) and
   the peak memory. The card
   against the CPU on the first ``CPU_FRAMES`` frames of one sequence:
   device crops bit-equal, raw responses within ``RESP_REL_TOL`` of their
   magnitude, equal peaks and boxes; the card's crops against cv2's host
   crops (bit-equal downscale; upscale within one LSB on < 0.3% of
   values). One r50 sequence through the CLI's depth >= 50 branch (2048
   channels), boxes finite. The linear probe: ``train_siamfc_torch.py``
   in-process on ``PROBE_SEQS`` synthetic GOT-10k-layout sequences with
   the config's batch_size 8 and 8 loader processes for one epoch: every
   loss finite, ``epoch_1`` written, only head parameters changed; one
   head step on the card against the CPU (B=2, the train phase's
   tolerances) and the step's ms. The phase adds no kernel.
13. analysis: slice 10's CLIs, ``vfs_tpu_torch.tools.analysis``, each
   once in-process at full width and cut depth (``phase_analysis``):
   ``bench_kernel`` at the r18 and r50 shapes (``BENCH_KERNEL_FRAMES``
   frames; no variant may fail; packed and bf16-score argmax agreement
   against ``pallas_fp32`` over ``MODE_AGREEMENT``), ``profile_kernel``,
   ``bench_track``'s five modes on the siamfc fixture (boxes within
   2.0 px of ``host_seq``), ``bench_extract``, ``get_flops``,
   ``benchmark``, ``bench_pretrain`` (3 steps on 16-frame clips), again
   with ``--device-aug`` on the ``_deviceaug`` config (slice 11), and
   ``analyze_logs``.
14. recognition: slice 12's path, action recognition (ROADMAP item 7a),
   four lines (``part``). ``train_tsm_r50``: MMAction2 v0.6.0's TSM-R50
   1x1x8 Kinetics-400 recipe at full width (``tsm_r50_cfg``: ResNet-50
   with the temporal shift, 8 segments, 400 classes, 8 videos of 8
   224x224 segments a step, the TSM optimizer's groups) with seeded
   weights, through ``apis.train.train_model`` in exact fp32 for one
   epoch on the train phase's ``K400_CLIPS`` clips and the recognition
   pipeline (``RECOG_WORKERS`` loader processes): losses finite, the
   first near ln 400, the fc_lr5 group present, ``epoch_1`` written;
   steps/s end to end (the first step left out); the device-only step
   (median of ``RECOG_TIMED_STEPS`` CUDA-event-timed steps on a batch on
   the card), its peak memory, ``train_mfu`` (``get_flops``' forward
   FLOPs, 2 a multiply-add, x3 for the step, x2 for the stem) and
   ``device_breakdown``. ``forward_3d``: one 32x224x224 clip through
   I3D-R50 and SlowFast-R50 4x16 (``I3D_R50``, ``SLOWFAST_R50``; seeded
   weights): probabilities summing to 1, ms and clips/s. ``card_vs_cpu``:
   every recognition backbone of the slice (``RECOG_GATES``: TSM r50 and
   with non-local blocks, TIN, I3D with non-local blocks, SlowOnly,
   SlowFast, R(2+1)D, ip-CSN, AlexNet V1-V3) in a recognizer at a small
   size, its eval scores and one train step on the card and on the CPU
   (the train phase's rule below). ``tools``: ``tools.demo_recognition``
   on one clip with the trained checkpoint, and
   ``tools.analysis.report_accuracy`` over two score files (centre crops
   and their flips of every clip, each scored by
   ``VideoDataset.evaluate``). None of the four rows' kernels may launch
   in the phase (the narrow weight-gradient kernel of phase 4c runs in
   the fp32 train steps of the 3-D backbones' gates).
15. localization: slice 13's path, temporal action localization (ROADMAP
   item 7b), five lines (``part``). ``train_bmn``: MMAction2 v0.6.0's
   BMN recipe at its published width (``bmn_cfg``: T=100, 400 features,
   32 samples of 3 a bin, hidden 256/128/512, 8 videos a step, Adam at
   the lr scaled to one card) with seeded weights, through ``python -m
   vfs_tpu_torch.tools.train`` in-process on ``write_activitynet``'s 16
   synthetic videos for ``BMN_EPOCHS`` epochs (2 loader processes):
   losses finite, a checkpoint an epoch; steps/s end to end; the
   device-only step (median of ``BMN_TIMED_STEPS`` CUDA-event-timed
   steps on a batch on the card), its peak memory, ``train_mfu`` against
   ``bmn_flops``' count from the code, ``device_breakdown`` by
   ``LOC_KERNEL_KINDS`` and the boundary-matching product alone
   (``bm_product_ms``). ``infer_bmn``: the trained model on two videos,
   the forward, the host decode (``decode_proposals``, soft NMS) in ms a
   video and ``ActivityNetDataset.evaluate``'s AR@1/5/10/100 and AUC
   (synthetic: printed). ``bsn``: TEM one step at its width (hidden 512,
   16 videos), its scores dumped as TEM result CSVs, PGM proposals and
   BSP features by ``tools.bsn_proposal_generation`` (``BSN_WORKERS``
   processes), then ``PEM_EPOCHS`` PEM steps. ``ssn``: SSN with a
   ResNet-50 (2048 channels, 20 classes, STPP (1, 1, 1) over (2, 5, 2)
   segments, the 8-proposal sampler; 72 crops of 224x224 a step) for an
   epoch of two THUMOS-layout videos, then ``SSN.forward_test`` (the
   test-time STPP) on each and ``SSNDataset.evaluate``'s mAP (printed).
   ``card_vs_cpu``: BMN, TEM, PEM and SSN (ResNet-18) at a small size,
   the forward, the loss and all the gradients as one vector on the card
   and on the CPU (the train phase's rule; fp64 within 1e-10; the
   losses' uniform draws given). None of the four hand-written kernels
   may launch in the phase.
16. kernels: every kernel with its launches on its path, times, bound
   and share of the bound. ``video_topk_affinity``'s launches are the main
   path's, the demo's, the all-blocks eval's, the train phases' eval
   hooks' (r18 and r50), the learning loop's and the bench_cfg path's; rows 1-3 add their bf16 launches on the bench_cfg
   path and carry a ``bf16`` entry (r18 and r50 numbers of phase 11);
   row 3 also carries ``scores_bf16`` and ``packed`` entries (launches on
   the eval path, numbers of phase 3), whose launches add to its own. (The
   full lines also give the share of the computed pairs the function
   needs, from the core's pass rule. Times of an earlier checkout come
   from ``ab_kernels.py``, which runs both checkouts in one call.) Its
   ``paths_without_kernels`` names the localization path, which launches
   none; the narrow wgrad3d entry's ``launches`` are those of one
   ``train_slowfast_r50`` step (phase 4c) and its
   ``recognition_launches`` those of the recognition phase, whose 3-D
   gates route their narrow fp32 convolutions to it. Rows 1-4's wide entries (slice 14) carry
   their launches on the wide phase's paths and its full-width numbers
   (radius 40 / top-10; radius 12 / top-48 beside). A ``total`` line before it gives the
   script's seconds and each phase's (``phase_seconds``).

The last line is ``{"ok": true, "device": {...}}``; any failure raises and
exits non-zero before it. Without a CUDA device the script exits 2.

Tolerances. The kernels sum each 256/1024-term dot product with fmaf in
channel order; the plain versions use a cuBLAS fp32 matrix product (TF32
off), which sums in another order. Scores therefore differ by ~1e-6
absolute (scores are cosines / 0.07, |s| <= 14.3): checked at rtol 1e-5,
atol 1e-5. Two candidates whose scores lie that close may swap places,
so sources must agree on >= 99.99% of entries (exactly on the tie cases,
where the equal scores are bit-identical in both versions). The per-step
logits are checked at rtol 1e-5 / atol 1e-5 on the cells whose sources
agree; masks of the paths on >= 99.9% of pixels. ``video_topk_affinity_v1``
and ``local_topk_attend_v2`` sum in the order of the other two kernels, so
at the full shapes their scores and sources must equal those kernels'
exactly, and the pose heatmaps of the v1 and v2 engines agree within 1e-5;
against the plain version (cuBLAS order) a near tie may swap one selected
key, so the plain-phase-1 heatmaps must agree within 1e-5 on >= 99.9% of
their values. Train: cuDNN sums the convolutions in another order than
the CPU (TF32 off on both), and BatchNorm's ``E[x^2] - E[x]^2`` over the
8-row batches of a B=2 step amplifies fp32 rounding by the batch's
mean^2 / var, which the random crops move by orders of magnitude from
batch to batch (1e-5 to 2e-3 relative L2 between card and CPU). So the
check takes the exact answer, the CPU's step in fp64: the card's fp64
step must equal it within 1e-9 (relative L2 of every gradient, and the
loss), which shows the same code computes the same function on both
devices; and the card's fp32 step must lie within ``CARD_CPU_FACTOR`` x
the CPU's fp32 distance from it plus ``CARD_CPU_FLOOR`` (relative L2 of
every gradient; the loss likewise plus 1e-6), which shows the card's
fp32 (cuDNN's algorithms, TF32 off) is as accurate as the CPU's. The
gradients that are zero in exact arithmetic (a Linear bias before a
BatchNorm) are rounding noise and are left out. A ReLU's gradient jumps
at 0: a pre-activation within the fp32 rounding of 0 takes its sign from
the rounding, and the gradient of its position passes or not by chance on
either device. On the first mp4v batch the card cuts one such position
of layer2 that fp64 and the CPU pass (+1.8e-7 in fp64, 0 on the card),
and the per-parameter rule reads layer2's shift gradients 7.0e-3 off
(the CPU's 1.8e-5); on other batches the CPU cuts one the card passes.
So that batch takes ``card_vs_cpu_kinks``: the same rule on steps whose
ReLU decisions are the fp64 step's, and every fp32 decision of card or
CPU that differs from fp64's must lie within ``KINK_ULPS`` (64) fp32
ulps of its call's RMS input from 0 (2 to 15 differ on every batch, at
up to 14 ulps); the free steps' errors and the decisions that differed
are printed beside. The r50 config's batches take the same check, on 4
samples (``R50_GATE_SAMPLES``): with 1-frame clips a view of 2 samples
is a 2-row BatchNorm batch, whose output is +-1 whatever its input, so
the backbone's exact gradient is made of the eps terms alone, too ill
conditioned for the fp64 rule's 1e-9. The bf16 step: its
first step from the same seed-0 weights on the same batch as the fp32
step; the backbone's features (both views) and all the gradients are
set against the fp32 step's in relative L2. The loss, ``2 - 2 cos``
averaged, is about 2.00 at this initialisation whatever the backbone
computes, so its check (``BF16_LOSS_ATOL``, 1e-3 against readings of
2.1e-5 and 3.6e-6) tells little beside those two. Measured on an H100 80GB HBM3
at 700 W, two runs: features 1.03e-2 in both, gradients 1.63e-1 and
1.55e-1 (the CPU tests hold each bf16 stage against the JAX package's
bf16 ConvBN, where fp32 differs from bf16 by 3e-3 a stage forward).
``BF16_REL_L2`` holds them at about
2.5x those readings above, and at 1e-3 and 1e-2 below, so that a bf16
step that ran in fp32 fails: two fp32 steps differ by rounding alone
(the card's and the CPU's gradients by 2e-5). bench_cfg: a bf16 entry
widens each value and runs its fp32 entry's fmaf chain (a bf16 product is
exact in fp32), so it must equal the fp32 entry on the widened features
bit for bit; against the plain version the fp32 gates hold. The card's
yuv420 unpack must lie within 1e-3 of the CPU's on the [0, 255] scale
(the same fp32 operations; no division), in both conventions. The
scan's masks in bf16 against the v2 engine's on >= 99.9% of pixels (the
epilogue sums in the kernel, phase 2 in PyTorch); the v1 engine's equal
them. The native decoders are host code and bit-equal to cv2's or fail.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs', 'r18_nc_sgd_cos_100e_r2_1xNx8_k400.py')
CONFIG_R50 = os.path.join(ROOT, 'configs',
                          'r50_nc_sgd_cos_100e_r5_1xNx2_k400.py')

# (fp32 CUDA-core TFLOP/s, device-memory TB/s, bf16 tensor-core TFLOP/s),
# NVIDIA data sheets, dense, at the full power limit; first matching name
# wins
PEAKS = [('H100 PCIe', 51.0, 2.0, 756.0), ('H100 NVL', 60.0, 3.9, 835.0),
         ('H100', 67.0, 3.35, 989.0)]

# the CPU tests' small-shape matrix: (T, h, w, neighbor_range, P, topk)
SMALL_CASES = [(9, 6, 7, 6, 4, 5), (12, 8, 8, 6, 4, 3), (6, 5, 9, 8, 3, 4),
               (12, 8, 9, 6, 1, 5), (2, 5, 6, 6, 4, 3), (10, 8, 9, 6, 4, 5),
               (4, 2, 3, 4, 2, 12)]  # the last has filler entries
NO_LIBRARY_CALL = ('no single PyTorch call computes a masked windowed '
                   'top-k over a frame bank')
KERNEL_INFO = dict(
    name='video_topk_affinity', route='cuda',
    source='vfs_tpu_torch/csrc/video_topk_affinity.cu',
    replaces='vfs_tpu/ops/pallas_affinity_video.py:1037')
LOCAL_INFO = dict(
    name='local_topk_attend', route='cuda',
    source='vfs_tpu_torch/csrc/local_topk_attend.cu',
    replaces='vfs_tpu/ops/pallas_attention.py:357')
V1_INFO = dict(
    name='video_topk_affinity_v1', route='cuda',
    source='vfs_tpu_torch/csrc/video_topk_affinity_v1.cu',
    replaces='vfs_tpu/ops/pallas_affinity_video.py:531')
V2_INFO = dict(
    name='local_topk_attend_v2', route='cuda',
    source='vfs_tpu_torch/csrc/local_topk_attend_v2.cu',
    replaces='vfs_tpu/ops/pallas_attention_v2.py:130')
# the v1 kernel's (video_extract, early_exit) settings
V1_MODES = [('sweep', False), ('sweep', True), ('perframe', False),
            ('perframe', True)]
# wider windows for rows 2 and 4: radius 18 and 30
WIDE_CASES = [(6, 9, 10, 36, 3, 5), (5, 12, 13, 60, 2, 6)]
MODELS = (('r18', 256, 12.0), ('r50', 1024, 18.0))
# local_topk_attend's small matrix: (h, w, C, radius, slot validity, topk,
# K); the kernel keeps at most 32 entries per query
LOCAL_CASES = [(7, 9, 8, 3.0, (1, 1, 1, 0, 0), 5, 4),
               (11, 13, 16, 4.0, (1, 0, 1, 1, 0, 1), 32, 16),
               (9, 40, 12, 5.0, (0, 1, 1, 1), 10, 4),
               (5, 6, 8, 18.0, (1, 1, 0), 10, 16),
               (2, 3, 8, 2.0, (1, 0, 1), 12, 4)]  # the last has fillers
WIDE_LOCAL_CASE = (6, 7, 8, 30.0, (1, 0, 1), 10, 4)
# the kernels at the edges of their 8 x 32 tiles and 32-channel chunks:
# a map smaller than a tile, h and w not multiples of it, C = 4 and 260,
# topk = 32, radius 32 (r = 31). Rows 1 and 2: (T, h, w, C, radius, P,
# topk); rows 3 and 4: (h, w, C, radius, slot validity, topk, K)
EDGE_CASES = [(5, 3, 5, 8, 3.0, 4, 5), (6, 13, 45, 4, 5.0, 3, 10),
              (4, 10, 37, 260, 12.0, 2, 32), (3, 9, 40, 8, 32.0, 2, 32)]
EDGE_LOCAL_CASES = [(3, 5, 8, 3.0, (1, 1), 5, 4),
                    (13, 45, 4, 5.0, (1, 0, 1), 10, 4),
                    (10, 37, 260, 12.0, (1, 1), 32, 4),
                    (9, 40, 8, 32.0, (0, 1, 1), 32, 16)]
# warm JHMDB evals timed after the counted one (pose phase; 4 until the
# localization phase took the script past 1000 s, 2 until the r50 phases
# took it past 1200 s)
POSE_REPEATS = 1
# rows 3 and 4 on banks of mostly invalid slots: one valid slot of 21, 17
# of 21, and no valid slot (fillers only)
ONE_OF_21 = tuple(int(f == 13) for f in range(21))
SOME_OF_21 = tuple(int(f not in (2, 6, 11, 17)) for f in range(21))
SPARSE_LOCAL_CASES = [(9, 40, 8, 5.0, ONE_OF_21, 10, 4),
                      (9, 40, 8, 5.0, SOME_OF_21, 10, 4),
                      (5, 6, 8, 3.0, (0, 0), 5, 4)]


# row 3's inexact modes (slice 10): an entry's name in the kernels line
# and local_topk_attend's keywords. Sources of kernel and plain version
# must agree on MODE_SRC_SHARE of the entries: a score within ~1e-6 of a
# bf16 midpoint or a packed quantisation boundary may round apart in the
# two summation orders and change a selection. A bf16 score that rounds
# apart, its source the same, must lie within BF16_FLIP_EPS of the
# midpoint of the two roundings.
LOCAL_MODES = (('scores_bf16', dict(scores='bfloat16')),
               ('packed', dict(extract='packed')))
MODE_SRC_SHARE = 1e-3
BF16_FLIP_EPS = 1e-5
# bench_kernel's argmax agreement against pallas_fp32 in the analysis
# phase: packed and bf16 scores (the JAX package's own tests gate 1.0 and
# 0.99 at their small shapes, test_pallas_kernel.py:89,150); packed on
# bf16 features at the bf16 features' own floor (bench.py:80-82, r50's),
# since its differences from the fp32 scan are those of bf16mm
MODE_AGREEMENT = dict(pallas_packed=0.999, pallas_bf16=0.99,
                      pallas_bf16mm_packed=0.98)
# the analysis phase's depth: bench_kernel's frames, then, cut to keep the
# script's time, profile_kernel's (24 in the first full run), bench_track's
# frames a sequence (the siamfc fixture has 50) and bench_extract's frames
BENCH_KERNEL_FRAMES = 24
ANALYSIS_FRAMES, ANALYSIS_TRACK_FRAMES, ANALYSIS_EXTRACT_FRAMES = 12, 20, 20
# bench_pretrain's batch (the configs' 32 until the r50 phases took the
# script past 1200 s)
ANALYSIS_PRETRAIN_BATCH = 8
# slice 11: the K400 clips the native phase decodes, and the card's
# 'jpeg' yuv420 unpack against the CPU's on the [0, 255] scale (the same
# fp32 operations: rounding only)
NATIVE_CLIPS = 8
YUV_CARD_CPU_ATOL = 1e-3
# slice 11's demo: the first frames of the main path's video
DEMO_FRAMES = 16
# slice 14's wide kernel (csrc/window_topk_wide.cu): rows 1-4 where the
# core's limits (r <= 31, topk <= 32) do not hold. Small shapes, rows 1/2:
# (T, h, w, C, radius, P, topk); rows 3/4: (h, w, C, radius, slot
# validity, topk, K): top-k past 32, r past 31 (radius 33 and 40), C = 260,
# fillers (a 2 x 3 map at top-64; no valid slot)
WIDE_INFO = dict(route='cuda', source='vfs_tpu_torch/csrc/window_topk_wide.cu')
WIDE_VIDEO_CASES = [(5, 3, 5, 8, 3.0, 4, 40), (6, 9, 40, 8, 40.0, 3, 10),
                    (4, 10, 37, 260, 33.0, 2, 33), (3, 2, 3, 8, 36.0, 2, 64)]
WIDE_LOCAL_CASES = [(3, 5, 8, 3.0, (1, 1), 40, 4),
                    (9, 40, 8, 40.0, (0, 1, 1), 10, 16),
                    (10, 37, 260, 33.0, (1, 1), 33, 4),
                    (5, 6, 8, 36.0, (0, 0), 40, 4)]
# the r18 full-width wide shapes (C = 256, 60 x 107, P = 20, a step
# against 21 slots with K = 4): (radius, topk); T frames for rows 1/2,
# past P + 1 so that the ring of slots wraps (from t = 21) and frames
# t >= 20 score 21 distinct bank frames, as the main path's do
WIDE_FULL = ((40.0, 10), (12.0, 48))
WIDE_FULL_FRAMES = 24
# the wide ops forced at core sizes, bit-equal to rows 1 and 3: radius 12
# / top-10 and the core's edge (r = 31, top-32)
WIDE_FORCED = ((12.0, 10), (32.0, 32))
# rows 1w and 3w at the r50 width (C = 1024) at WIDE_FULL's first shape
WIDE_R50_KEY = f'radius{WIDE_FULL[0][0]:g}_top{WIDE_FULL[0][1]}'
# where row 3w's time goes at radius 40 / top-10 (one step, 21 slots):
# its CUDA-event ms at these channel counts (fp32, the first C channels of
# the full-width features, renormalised), bf16 features at C = 256, and
# top-48; the fit ms = a + b * C splits the time that scales with C
# (scoring) from the rest (the walk, sorts and merges)
WIDE_SPLIT_CHANNELS = (64, 128, 256)
WIDE_SPLIT_TOPK = 48
# r18 forward_test on the main path's video at this neighbor_range
# (radius 40, r = 39), under each backend
WIDE_NEIGHBOR_RANGE = 80
WIDE_BACKENDS = (('tiled', dict(backend='tiled')),
                 ('pallas_video_v1', dict(backend='pallas_video',
                                          video_engine='v1')),
                 ('pallas', dict(backend='pallas')))


def emit(obj):
    print(json.dumps(obj), flush=True)


def peaks(name):
    """(fp32 TFLOP/s, TB/s, bf16 TFLOP/s) of the card called ``name``."""
    for key, *rates in PEAKS:
        if key in name:
            return tuple(rates)
    return PEAKS[2][1:]


def cuda_ms(fn, runs=5, warmup=1):
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    return statistics.median(cuda_call(fn)[1] for _ in range(runs))


def cuda_call(fn):
    """``fn()`` and its CUDA-event milliseconds."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def affinity_work(t_total, h, w, c, radius, topk, p):
    """FLOPs and bytes the affinity needs for these inputs: 2*C per (query,
    distinct live bank frame, in-map window key); features read once,
    outputs written once. Frame t's bank holds min(t, P+1) distinct frames:
    while t <= P frame 0 sits at both j=0 and ring slot 0, and its two
    scores are the same numbers, so the function needs them once."""
    live = sum(min(t, p + 1) for t in range(1, t_total))
    flops = 2.0 * c * window_pairs(h, w, radius) * live
    nbytes = 4.0 * t_total * h * w * c + 12.0 * (t_total - 1) * h * w * topk
    return flops, nbytes


def window_pairs(h, w, radius):
    """(query, key) pairs of one frame pair: keys in the circle and the
    map."""
    from vfs_tpu_torch.ops.video_affinity import circle_offsets
    _, dy, dx = circle_offsets(radius)
    ys, xs = np.arange(h)[:, None, None], np.arange(w)[None, :, None]
    ky, kx = ys + dy.numpy(), xs + dx.numpy()
    return int(((ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)).sum())


def pairs_needed_share(h, w, radius):
    """Of the (query, key) pairs rows 1 and 3 compute for a frame pair, the
    share the function needs (window_geometry.pair_counts)."""
    from vfs_tpu_torch.ops.window_geometry import pair_counts
    needed, computed = pair_counts(h, w, radius)
    return needed / computed


def step_work(h, w, c, radius, topk, k_classes, n_slots, distinct):
    """FLOPs and bytes one per-step attention needs: 2*C per (query,
    distinct valid bank frame, in-map window key) plus the 2*k*K-term
    weighted sum per query; the query, the bank's slots and values read
    once, the logits, scores and sources written once."""
    hw = h * w
    flops = (2.0 * c * window_pairs(h, w, radius) * distinct
             + 2.0 * hw * topk * k_classes)
    nbytes = (4.0 * hw * c * (1 + n_slots) + 4.0 * n_slots * hw * k_classes
              + 4.0 * hw * k_classes + 12.0 * hw * topk)
    return flops, nbytes


def bound_ms(flops, nbytes, name):
    tflops, tbps, _ = peaks(name)
    by_ops = flops / (tflops * 1e12) * 1e3
    by_bytes = nbytes / (tbps * 1e12) * 1e3
    return max(by_ops, by_bytes), ('operations' if by_ops >= by_bytes
                                   else 'bytes')


def compare(kernel, plain, exact_src, what):
    """Kernel vs plain (scores, sources). Returns (max_abs_err, number of
    differing sources, their share) and raises past the tolerances."""
    import torch
    ks, ki = kernel
    ps, pi = plain
    if not torch.isfinite(ks).all():
        raise AssertionError(f'{what}: non-finite kernel scores')
    err = float((ks - ps).abs().max()) if ks.numel() else 0.0
    mismatch = int((ki != pi).sum())
    share = mismatch / max(1, ki.numel())
    if not torch.allclose(ks, ps, rtol=1e-5, atol=1e-5):
        raise AssertionError(f'{what}: scores differ, max abs err {err}')
    if exact_src and mismatch:
        raise AssertionError(f'{what}: {mismatch} tie-case sources differ')
    if share > 1e-4:
        raise AssertionError(f'{what}: {mismatch} sources differ '
                             f'({share} > 1e-4)')
    return err, mismatch, share


def compare_local(kernel, plain, exact_src, what):
    """Per-step kernel vs plain (logits, scores, sources). Returns
    (max |score diff|, max |logit diff|, differing sources, their share);
    logits are held to the tolerance on the cells whose sources agree."""
    import torch
    (ko, ks, ki), (po, ps, pi) = kernel, plain
    err, mismatch, share = compare((ks, ki), (ps, pi), exact_src, what)
    if not torch.isfinite(ko).all():
        raise AssertionError(f'{what}: non-finite kernel logits')
    logit_err = float((ko - po).abs().max())
    same = (ki == pi).all(-1)
    if not torch.allclose(ko[same], po[same], rtol=1e-5, atol=1e-5):
        raise AssertionError(f'{what}: logits differ, max abs err '
                             f'{float((ko[same] - po[same]).abs().max())}')
    return err, logit_err, mismatch, share


def phase_build():
    """Build every kernel, one nvcc per source, and the two native host
    decoders (g++), all started together. A decoder that does not build
    is reported with the compiler's line and is not a failure: its
    callers decode with cv2."""
    from vfs_tpu_torch.datasets import native_loader
    from vfs_tpu_torch.ops import _build
    names = [info['name']
             for info in (KERNEL_INFO, V1_INFO, LOCAL_INFO, V2_INFO)] + [
                 'window_topk_wide', 'video_topk_tc', 'conv3d_wgrad']
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(names) + 2) as pool:
        decoders = {name: pool.submit(get) for name, get in (
            ('frame_loader', native_loader.get_lib),
            ('video_decoder', native_loader.get_video_lib))}
        libs = dict(zip(names, pool.map(_build.build, names)))
        native = {name: dict(built=f.result() is not None,
                             error=native_loader.build_error(name))
                  for name, f in decoders.items()}
    secs = time.time() - t0
    keep = ('Compiling entry function', 'registers', 'spill')
    ptxas = {name: [ln.strip()
                    for ln in lib.with_suffix('.log').read_text().splitlines()
                    if any(k in ln for k in keep)]
             for name, lib in libs.items()}
    emit({'phase': 'build', 'seconds': secs, 'ptxas': ptxas,
          'native_decoders': native})
    smi_line = card_line()
    print(smi_line, flush=True)
    return smi_line


def card_line():
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def full_range_yuv420(rgb):
    """(T, H, W, 3) uint8 RGB (even H, W) -> flat planar I420 in the
    full-range JFIF ('jpeg') convention, chroma from each 2x2 block's
    top-left pixel: planes of the kind libjpeg's decoder returns, for the
    unpack check where that decoder did not build."""
    import cv2
    t, h, w = rgb.shape[:3]
    out = np.empty((t, h * w * 3 // 2), np.uint8)
    for i in range(t):
        ycc = cv2.cvtColor(rgb[i], cv2.COLOR_RGB2YCrCb)
        out[i, :h * w] = ycc[..., 0].ravel()
        out[i, h * w:h * w * 5 // 4] = ycc[::2, ::2, 2].ravel()
        out[i, h * w * 5 // 4:] = ycc[::2, ::2, 1].ravel()
    return out


def host_ms(fn, runs=3):
    """Median host milliseconds of ``fn`` over ``runs`` calls, after one."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def native_decode(root):
    """Slice 11's decoders on the host (module docstring, phase 1): the
    DAVIS JPEGs of ``write_davis`` (one video) and ``NATIVE_CLIPS`` of the
    train phase's Kinetics clips, each decoded by cv2 and, where its
    library built, natively; the native frames must equal cv2's bit for
    bit. Returns the line's fields and the (T, H, W, 3) frames and their
    flat 'jpeg' planes for the unpack check."""
    import cv2
    from vfs_tpu_torch.datasets import native_loader
    from vfs_tpu_torch.datasets.registry import PIPELINES
    from vfs_tpu_torch.tools.analysis.fixtures import write_k400 as write
    img_root, _, _, _ = write_davis(os.path.join(root, 'davis'), n_videos=1)
    frame_dir = os.path.join(img_root, 'video0')
    paths = sorted(os.path.join(frame_dir, f) for f in os.listdir(frame_dir))

    def cv2_frames():
        return np.stack([cv2.cvtColor(cv2.imread(p, cv2.IMREAD_COLOR),
                                      cv2.COLOR_BGR2RGB) for p in paths])

    rgb = cv2_frames()
    out = dict(jpeg_frames=len(paths), jpeg_hw=list(rgb.shape[1:3]),
               jpeg_cv2_ms_per_frame=host_ms(cv2_frames) / len(paths))
    planes = None
    if native_loader.get_lib() is not None:
        native = native_loader.decode_jpeg_batch(paths, num_threads=8)
        if not np.array_equal(native, rgb):
            raise AssertionError('native JPEG decode differs from cv2: max '
                                 f'{np.abs(native.astype(int) - rgb).max()}')
        out['jpeg_native_ms_per_frame'] = host_ms(
            lambda: native_loader.decode_jpeg_batch(paths, num_threads=8)) \
            / len(paths)
        out['jpeg_yuv420_native_ms_per_frame'] = host_ms(
            lambda: native_loader.decode_jpeg_batch_yuv420(
                paths, num_threads=8)) / len(paths)
        planes = np.asarray(native_loader.decode_jpeg_batch_yuv420(paths))
    out['yuv420_planes'] = 'native' if planes is not None else 'cv2_ycrcb'
    if planes is None:
        planes = full_range_yuv420(rgb)

    clips = os.path.join(root, 'k400')
    os.makedirs(clips)
    with open(write(clips, NATIVE_CLIPS, K400_FRAMES, K400_HW)) as f:
        names = [os.path.join(clips, ln.split()[0]) for ln in f]
    sample = PIPELINES.get('SampleFrames')(clip_len=1, frame_interval=0,
                                           num_clips=8)
    np.random.seed(0)
    inds = [sample(dict(total_frames=K400_FRAMES, start_index=0))[
        'frame_inds'] for _ in names]

    def decode(init, dec):
        return [PIPELINES.get(dec)()(dict(PIPELINES.get(init)()(
            dict(filename=n)), frame_inds=i))['imgs']
            for n, i in zip(names, inds)]

    out.update(k400_clips=len(names), k400_container=os.path.splitext(
        names[0])[1].lstrip('.'),
        k400_cv2_ms_per_sample=host_ms(
            lambda: decode('OpenCVInit', 'OpenCVDecode')) / len(names))
    if native_loader.get_video_lib() is not None:
        ref = decode('OpenCVInit', 'OpenCVDecode')
        got = decode('DecordInit', 'DecordDecode')
        if not all(np.array_equal(np.stack(a), np.stack(b))
                   for a, b in zip(got, ref)):
            raise AssertionError('native video decode differs from cv2')
        out['k400_native_ms_per_sample'] = host_ms(
            lambda: decode('DecordInit', 'DecordDecode')) / len(names)
    return out, rgb, planes


def phase_native(dev, smi_line):
    """Slice 11's native decoders (module docstring, phase 1)."""
    import torch
    from vfs_tpu_torch.datasets import native_loader
    from vfs_tpu_torch.ops.yuv import yuv420_to_rgb
    t0 = time.time()
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        out, rgb, planes = native_decode(root)
    h, w = rgb.shape[1:3]
    card = yuv420_to_rgb(torch.as_tensor(planes, device=dev), h, w,
                         'jpeg').cpu()
    cpu = yuv420_to_rgb(torch.as_tensor(planes), h, w, 'jpeg')
    err = float((card - cpu).abs().max())
    if err > YUV_CARD_CPU_ATOL:
        raise AssertionError(f"'jpeg' yuv420 unpack: card vs CPU {err} > "
                             f'{YUV_CARD_CPU_ATOL}')
    rec = float((cpu - torch.as_tensor(rgb, dtype=torch.float32))
                .abs().mean())
    emit({'phase': 'native', 'card': smi_line, **{
        f'{name}_built': native_loader.build_error(name) is None
        for name in ('frame_loader', 'video_decoder')}, **{
        f'{name}_error': native_loader.build_error(name)
        for name in ('frame_loader', 'video_decoder')}, **out,
        'yuv420_jpeg_card_vs_cpu': err,
        'yuv420_jpeg_vs_rgb_mean_abs': rec, 'seconds': time.time() - t0})


def run_case(feats, radius, topk, p, exact_src, what):
    from vfs_tpu_torch.ops import (video_topk_affinity_cuda,
                                   video_topk_affinity_reference)
    out_k = video_topk_affinity_cuda(feats, radius, 0.07, topk, p)
    out_p = video_topk_affinity_reference(feats, radius, 0.07, topk, p)
    import torch
    torch.cuda.synchronize()
    return compare((out_k[0][1:], out_k[1][1:]), (out_p[0][1:], out_p[1][1:]),
                   exact_src, what)


def run_v1_case(feats, radius, topk, p, exact_src, what):
    """video_topk_affinity_v1's kernel under every (video_extract,
    early_exit) vs the plain version and, bit for bit, vs row 1's kernel;
    returns the worst max_abs_err and source mismatch count, and the
    (query, key row) merges each setting ran."""
    import torch
    from vfs_tpu_torch.ops import (video_topk_affinity_cuda,
                                   video_topk_affinity_reference,
                                   video_topk_affinity_v1_cuda)
    plain = video_topk_affinity_reference(feats, radius, 0.07, topk, p)
    row1 = video_topk_affinity_cuda(feats, radius, 0.07, topk, p)
    errs, mismatches, merges = [], [], {}
    for extract, early_exit in V1_MODES:
        count = torch.zeros(1, dtype=torch.int64, device=feats.device)
        out = video_topk_affinity_v1_cuda(feats, radius, 0.07, topk, p,
                                          early_exit=early_exit,
                                          extract=extract, merge_count=count)
        torch.cuda.synchronize()
        mode = f'{extract}/early_exit={early_exit}'
        err, mismatch, _ = compare(
            (out[0][1:], out[1][1:]), (plain[0][1:], plain[1][1:]),
            exact_src, f'{what} {mode}')
        if not (torch.equal(out[0][1:], row1[0][1:])
                and torch.equal(out[1][1:], row1[1][1:])):
            raise AssertionError(f'{what} {mode}: differs from row 1')
        errs.append(err)
        mismatches.append(mismatch)
        merges[mode] = int(count)
    return max(errs), max(mismatches), merges


def smooth_features(shape, dev, generator):
    """L2-normalised (T, h, w, C) features that drift slowly over time (a
    base map plus a cumulative 0.1-scale random walk): the regime of real
    video, where the tau exit skips most passes."""
    import torch
    from vfs_tpu_torch.ops import l2_normalize
    base = torch.randn(shape[1:], device=dev, generator=generator)
    drift = torch.randn(shape, device=dev, generator=generator) * 0.1
    return l2_normalize(base + torch.cumsum(drift, 0)).contiguous()


def run_local(query, bank, vals, valid, radius, topk, exact_src, what,
              kernel=None):
    """A per-step kernel (``local_topk_attend``'s unless ``kernel`` names
    another wrapper) vs its plain version (TF32 off); returns
    compare_local's numbers and the kernel's outputs."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (local_topk_attend_cuda,
                                   local_topk_attend_reference)
    kernel = kernel or local_topk_attend_cuda
    with exact_fp32():
        out_k = kernel(query, bank, vals, valid, radius, 0.07, topk)
        out_p = local_topk_attend_reference(query, bank, vals, valid, radius,
                                            0.07, topk)
    torch.cuda.synchronize()
    return compare_local(out_k, out_p, exact_src, what), out_k


def run_local_v2(query, bank, vals, valid, radius, topk, exact_src, what):
    """``run_local`` for ``local_topk_attend_v2``'s kernel, whose scores
    and sources must also equal ``local_topk_attend``'s bit for bit."""
    import torch
    from vfs_tpu_torch.ops import (local_topk_attend_cuda,
                                   local_topk_attend_v2_cuda)
    nums, out = run_local(query, bank, vals, valid, radius, topk, exact_src,
                          what, local_topk_attend_v2_cuda)
    row3 = local_topk_attend_cuda(query, bank, vals, valid, radius, 0.07,
                                  topk)
    if not (torch.equal(out[1], row3[1]) and torch.equal(out[2], row3[2])):
        raise AssertionError(f'{what}: differs from row 3')
    return nums, out


def compare_mode(kernel, plain, exact_src, what, query, bank, mode):
    """A row 3 mode's kernel vs its plain version (logits, scores,
    sources): sources on MODE_SRC_SHARE of the entries (all of them on the
    tie cases); where a cell's sources agree, scores and logits at rtol
    1e-5 / atol 1e-5, but for bf16 scores that round apart at a midpoint
    (BF16_FLIP_EPS of the exact fp64 score), whose cells are counted and
    left out of the logits check. Returns (max |score diff|, max |logit
    diff|, differing sources, their share, rounding flips)."""
    import torch
    (ko, ks, ki), (po, ps, pi) = kernel, plain
    if not (torch.isfinite(ko).all() and torch.isfinite(ks).all()):
        raise AssertionError(f'{what}: non-finite kernel outputs')
    mismatch = int((ki != pi).sum())
    share = mismatch / max(1, ki.numel())
    if (exact_src and mismatch) or share > MODE_SRC_SHARE:
        raise AssertionError(f'{what}: {mismatch} sources differ ({share})')
    same = (ki == pi).all(-1)
    flips = same[..., None] & ~torch.isclose(ks, ps, rtol=1e-5, atol=1e-5)
    n_flips = int(flips.sum())
    if n_flips:
        if mode.get('scores') != 'bfloat16':
            raise AssertionError(f'{what}: scores differ')
        h, w, c = query.shape
        cells = torch.nonzero(flips)
        q = query.reshape(h * w, c).double()[cells[:, 0] * w + cells[:, 1]]
        k = bank.reshape(-1, c).double()[ki[flips]]
        exact = (q * k).sum(-1) * float(np.float32(1 / 0.07))
        mid = (ks[flips].double() + ps[flips].double()) / 2
        if not bool(((exact - mid).abs() < BF16_FLIP_EPS).all()):
            raise AssertionError(f'{what}: bf16 scores differ away from a '
                                 'rounding midpoint')
        same &= ~flips.any(-1)
    err = float((ks - ps)[same].abs().max()) if same.any() else 0.0
    logit_err = float((ko - po)[same].abs().max()) if same.any() else 0.0
    if not torch.allclose(ko[same], po[same], rtol=1e-5, atol=1e-5):
        raise AssertionError(f'{what}: logits differ, max abs err '
                             f'{logit_err}')
    return err, logit_err, mismatch, share, n_flips


def run_local_mode(query, bank, vals, valid, radius, topk, exact_src, what,
                   mode):
    """A row 3 mode's kernel vs its plain version (TF32 off); with bf16
    features also vs the mode's fp32 entry on the widened features, bit
    for bit. Returns compare_mode's numbers and the kernel's outputs."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (local_topk_attend_cuda,
                                   local_topk_attend_reference)
    args = (query, bank, vals, valid, radius, 0.07, topk)
    with exact_fp32():
        out_k = local_topk_attend_cuda(*args, **mode)
        out_p = local_topk_attend_reference(*args, **mode)
        widened = None
        if query.dtype == torch.bfloat16:
            widened = local_topk_attend_cuda(query.float(), bank.float(),
                                             *args[2:], **mode)
    torch.cuda.synchronize()
    if widened is not None and not all(
            torch.equal(a, b) for a, b in zip(out_k, widened)):
        raise AssertionError(f'{what}: bf16 features differ from the fp32 '
                             'entry on the widened features')
    return compare_mode(out_k, out_p, exact_src, what, query, bank,
                        mode), out_k


def phase_small_modes(dev, tensor):
    """Row 3's four mode entries (LOCAL_MODES x fp32 / bf16 features)
    against their plain versions over row 3's small matrix, its edge and
    sparse-bank cases (bf16 features where C is a multiple of 8) and a
    duplicated-frame tie case (exact sources); packed with bf16 scores
    raises."""
    import torch
    from vfs_tpu_torch.ops import l2_normalize, local_topk_attend_cuda
    cases = []
    for h, w, c, radius, valid, topk, k in (LOCAL_CASES + EDGE_LOCAL_CASES
                                            + SPARSE_LOCAL_CASES):
        rng = np.random.RandomState(h * 100 + w + c)
        f = len(valid)
        cases.append((rng.randn(h, w, c), rng.randn(f, h, w, c),
                      rng.rand(f, h, w, k), valid, radius, topk, False,
                      [h, w, c, radius, f, sum(valid), topk, k]))
    rng = np.random.RandomState(41)
    tie = rng.randn(5, 8, 9, 16)
    tie[2], tie[4] = tie[0], tie[1]
    cases.append((rng.randn(8, 9, 16), tie, rng.rand(5, 8, 9, 4),
                  (1, 1, 1, 1, 1), 3.0, 8, True, 'tie'))
    for name, mode in LOCAL_MODES:
        for feat in (torch.float32, torch.bfloat16):
            results = []
            for q, b, v, valid, radius, topk, exact_src, row in cases:
                if feat == torch.bfloat16 and q.shape[-1] % 8:
                    continue
                query = l2_normalize(tensor(q)).to(feat).contiguous()
                bank = l2_normalize(tensor(b)).to(feat).contiguous()
                nums, _ = run_local_mode(
                    query, bank, tensor(v), tensor(valid, torch.int32),
                    radius, topk, exact_src, f'small {name} {feat} {row}',
                    mode)
                results.append([row, *nums])
            emit({'phase': 'small', 'kernel': LOCAL_INFO['name'],
                  'mode': name, 'features': str(feat).split('.')[-1],
                  'columns': ['case', 'max_abs_err', 'max_logit_err',
                              'src_mismatch', 'src_mismatch_share',
                              'bf16_rounding_flips'],
                  'cases': results})
    q = tensor(np.zeros((4, 5, 8)))
    try:
        local_topk_attend_cuda(q, q[None], tensor(np.zeros((1, 4, 5, 2))),
                               tensor([1], torch.int32), 3.0, 0.07, 4,
                               scores='bfloat16', extract='packed')
    except ValueError:
        pass
    else:
        raise AssertionError('packed with bf16 scores did not raise')


def phase_small(dev):
    import torch
    from vfs_tpu_torch.ops import l2_normalize
    results = []
    for t_total, h, w, nr, p, topk in SMALL_CASES:
        rng = np.random.RandomState(t_total * 100 + h)
        feats = l2_normalize(torch.tensor(rng.randn(t_total, h, w, 8),
                                          dtype=torch.float32, device=dev))
        err, mismatch, _ = run_case(feats.contiguous(), float(nr // 2),
                                    topk, p, False,
                                    f'small {t_total}x{h}x{w} P={p}')
        results.append([t_total, h, w, nr, p, topk, err, mismatch])
    rng = np.random.RandomState(17)
    feats = rng.randn(10, 8, 9, 8)
    feats[3] = feats[1]
    feats[7] = feats[5]
    feats = l2_normalize(torch.tensor(feats, dtype=torch.float32,
                                      device=dev)).contiguous()
    err, mismatch, _ = run_case(feats, 3.0, 5, 4, True, 'tie case')
    emit({'phase': 'small', 'kernel': KERNEL_INFO['name'],
          'columns': ['T', 'h', 'w', 'neighbor_range', 'P', 'topk',
                      'max_abs_err', 'src_mismatch'],
          'cases': results,
          'tie_case': {'max_abs_err': err, 'src_mismatch': mismatch}})

    def tensor(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=dev)

    results = []
    fillers = 0
    for h, w, c, radius, valid, topk, k in LOCAL_CASES:
        rng = np.random.RandomState(h * 100 + w)
        f = len(valid)
        query = l2_normalize(tensor(rng.randn(h, w, c))).contiguous()
        bank = l2_normalize(tensor(rng.randn(f, h, w, c))).contiguous()
        vals = tensor(rng.rand(f, h, w, k))
        (err, logit_err, mismatch, _), out = run_local(
            query, bank, vals, tensor(valid, torch.int32), radius, topk,
            False, f'small local {h}x{w} F={f} k={topk} K={k}')
        fillers += int((out[1] <= -1e29).sum())
        results.append([h, w, c, radius, f, sum(valid), topk, k, err,
                        logit_err, mismatch])
    if not fillers:
        raise AssertionError('the filler case produced no filler entries')
    rng = np.random.RandomState(23)
    bank = rng.randn(4, 8, 9, 8)
    bank[2], bank[3] = bank[0], bank[1]
    bank = l2_normalize(tensor(bank)).contiguous()
    query = l2_normalize(tensor(rng.randn(8, 9, 8))).contiguous()
    (err, logit_err, mismatch, _), out = run_local(
        query, bank, tensor(rng.rand(4, 8, 9, 4)),
        tensor([1, 1, 1, 1], torch.int32), 3.0, 5, True, 'local tie case')
    slot, cell = out[2] // 72, out[2] % 72
    if not ((slot[..., :-1] == 0) & (slot[..., 1:] == 2)
            & (cell[..., :-1] == cell[..., 1:])).any():
        raise AssertionError('the local tie case holds no tie')
    emit({'phase': 'small', 'kernel': LOCAL_INFO['name'],
          'columns': ['h', 'w', 'C', 'radius', 'F', 'valid', 'topk', 'K',
                      'max_abs_err', 'max_logit_err', 'src_mismatch'],
          'cases': results, 'filler_entries': fillers,
          'tie_case': {'max_abs_err': err, 'max_logit_err': logit_err,
                       'src_mismatch': mismatch}})
    phase_small_edges(dev, tensor)
    phase_small_perframe(dev, tensor)
    phase_small_modes(dev, tensor)


def phase_small_edges(dev, tensor):
    """The four kernels at the edges of their 8 x 32 query tiles and
    32-channel chunks (EDGE_CASES, EDGE_LOCAL_CASES); the video kernels'
    t <= P case in which frame 0's two bank entries (j = 0 and ring slot 0)
    both enter the lists; rows 3 and 4 on banks of mostly invalid slots
    (SPARSE_LOCAL_CASES)."""
    import torch
    from vfs_tpu_torch.ops import (l2_normalize, video_topk_affinity_cuda,
                                   video_topk_affinity_v1_cuda)
    video_cases = []
    for t_total, h, w, c, radius, p, topk in EDGE_CASES:
        rng = np.random.RandomState(t_total * 1000 + h * 10 + c)
        feats = l2_normalize(tensor(rng.randn(t_total, h, w, c))).contiguous()
        video_cases.append((feats, radius, topk, p,
                            f'edge {t_total}x{h}x{w}x{c} r={radius}',
                            [t_total, h, w, c, radius, p, topk]))
    # frame 1 repeats frame 0: its queries meet themselves at j = 0 and at
    # ring slot 0 (j = 1), two equal top scores
    rng = np.random.RandomState(29)
    tie = rng.randn(4, 9, 11, 8)
    tie[1] = tie[0]
    tie = l2_normalize(tensor(tie)).contiguous()
    own = torch.arange(9 * 11, device=dev).view(9, 11)
    for info, run, kernel in (
            (KERNEL_INFO, run_case, video_topk_affinity_cuda),
            (V1_INFO, run_v1_case,
             lambda *a: video_topk_affinity_v1_cuda(*a, extract='perframe'))):
        results = [case[-1] + list(run(*case[:4], False, case[4])[:2])
                   for case in video_cases]
        err, mismatch = run(tie, 3.0, 6, 4, True, 'edge frame-0 tie')[:2]
        scores, src = kernel(tie, 3.0, 0.07, 6, 4)
        both = ((src[1, ..., 0] == own) & (src[1, ..., 1] == own)
                & (scores[1, ..., 0] == scores[1, ..., 1]))
        if not bool(both.all()):
            raise AssertionError(f"{info['name']}: frame 0 did not enter "
                                 'the lists twice')
        emit({'phase': 'small', 'kernel': info['name'], 'edges': True,
              'columns': ['T', 'h', 'w', 'C', 'radius', 'P', 'topk',
                          'max_abs_err', 'src_mismatch'],
              'cases': results,
              'frame0_tie_case': {'max_abs_err': err,
                                  'src_mismatch': mismatch}})

    for info, run in ((LOCAL_INFO, run_local), (V2_INFO, run_local_v2)):
        results = []
        for h, w, c, radius, valid, topk, k in (EDGE_LOCAL_CASES
                                                + SPARSE_LOCAL_CASES):
            rng = np.random.RandomState(h * 1000 + w * 10 + c)
            f = len(valid)
            query = l2_normalize(tensor(rng.randn(h, w, c))).contiguous()
            bank = l2_normalize(tensor(rng.randn(f, h, w, c))).contiguous()
            vals = tensor(rng.rand(f, h, w, k))
            (err, logit_err, mismatch, _), _ = run(
                query, bank, vals, tensor(valid, torch.int32), radius, topk,
                False, f"edge {info['name']} {h}x{w}x{c} r={radius} "
                f'valid={sum(valid)}/{f}')
            results.append([h, w, c, radius, f, sum(valid), topk, k, err,
                            logit_err, mismatch])
        emit({'phase': 'small', 'kernel': info['name'], 'edges': True,
              'columns': ['h', 'w', 'C', 'radius', 'F', 'valid', 'topk', 'K',
                          'max_abs_err', 'max_logit_err', 'src_mismatch'],
              'cases': results})


def phase_small_perframe(dev, tensor):
    """The small matrix of rows 2 and 4: video_topk_affinity_v1 over row
    1's cases, the wide radii, the tie case and smooth features (where the
    tau exit must merge fewer (query, key row) pairs than no exit, for the
    same lists), local_topk_attend_v2 over local_topk_attend's cases, a
    wide radius and its tie case."""
    import torch
    from vfs_tpu_torch.ops import l2_normalize
    results = []
    for t_total, h, w, nr, p, topk in SMALL_CASES + WIDE_CASES:
        rng = np.random.RandomState(t_total * 100 + h)
        feats = l2_normalize(tensor(rng.randn(t_total, h, w, 8))).contiguous()
        err, mismatch, _ = run_v1_case(feats, float(nr // 2), topk, p, False,
                                       f'small v1 {t_total}x{h}x{w} P={p}')
        results.append([t_total, h, w, nr, p, topk, err, mismatch])
    rng = np.random.RandomState(17)
    feats = rng.randn(10, 8, 9, 8)
    feats[3] = feats[1]
    feats[7] = feats[5]
    feats = l2_normalize(tensor(feats)).contiguous()
    tie_err, tie_mismatch, _ = run_v1_case(feats, 3.0, 5, 4, True,
                                           'v1 tie case')
    rng = np.random.RandomState(3)
    smooth = rng.randn(8, 9, 8)[None] + np.cumsum(
        rng.randn(10, 8, 9, 8) * 0.1, 0)
    smooth = l2_normalize(tensor(smooth)).contiguous()
    smooth_err, smooth_mismatch, merges = run_v1_case(smooth, 3.0, 5, 4,
                                                      False, 'v1 smooth')
    # run_v1_case held every setting's lists to row 1's, bit for bit
    full = merges['perframe/early_exit=False']
    if not (merges['perframe/early_exit=True'] < full
            and merges['sweep/early_exit=True'] == full):
        raise AssertionError(f'the tau exit did not save merges: {merges}')
    emit({'phase': 'small', 'kernel': V1_INFO['name'],
          'modes': [f'{e}/early_exit={x}' for e, x in V1_MODES],
          'columns': ['T', 'h', 'w', 'neighbor_range', 'P', 'topk',
                      'max_abs_err', 'src_mismatch'],
          'cases': results,
          'tie_case': {'max_abs_err': tie_err, 'src_mismatch': tie_mismatch},
          'smooth_case': {'max_abs_err': smooth_err,
                          'src_mismatch': smooth_mismatch,
                          'merges': merges}})

    results = []
    fillers = 0
    for h, w, c, radius, valid, topk, k in LOCAL_CASES + [WIDE_LOCAL_CASE]:
        rng = np.random.RandomState(h * 100 + w)
        f = len(valid)
        query = l2_normalize(tensor(rng.randn(h, w, c))).contiguous()
        bank = l2_normalize(tensor(rng.randn(f, h, w, c))).contiguous()
        vals = tensor(rng.rand(f, h, w, k))
        (err, logit_err, mismatch, _), out = run_local_v2(
            query, bank, vals, tensor(valid, torch.int32), radius, topk,
            False, f'small v2 {h}x{w} F={f} k={topk} K={k}')
        fillers += int((out[1] <= -1e29).sum())
        results.append([h, w, c, radius, f, sum(valid), topk, k, err,
                        logit_err, mismatch])
    if not fillers:
        raise AssertionError('the filler case produced no filler entries')
    rng = np.random.RandomState(23)
    bank = rng.randn(4, 8, 9, 8)
    bank[2], bank[3] = bank[0], bank[1]
    bank = l2_normalize(tensor(bank)).contiguous()
    query = l2_normalize(tensor(rng.randn(8, 9, 8))).contiguous()
    (err, logit_err, mismatch, _), _ = run_local_v2(
        query, bank, tensor(rng.rand(4, 8, 9, 4)),
        tensor([1, 1, 1, 1], torch.int32), 3.0, 5, True, 'v2 tie case')
    emit({'phase': 'small', 'kernel': V2_INFO['name'],
          'columns': ['h', 'w', 'C', 'radius', 'F', 'valid', 'topk', 'K',
                      'max_abs_err', 'max_logit_err', 'src_mismatch'],
          'cases': results, 'filler_entries': fillers,
          'tie_case': {'max_abs_err': err, 'max_logit_err': logit_err,
                       'src_mismatch': mismatch}})


def phase_full(dev, smi_name):
    """video_topk_affinity: correctness at T=24; times at T=24 and T=48.
    Frames 24..47 all see the full bank (P+1 frames), so (time(48) -
    time(24)) / 24 is the steady-state time per frame. local_topk_attend:
    one step against a full bank of 21 distinct random frames, the
    steady state of the scan. Returns the r50 local_topk_attend numbers,
    the kernels line's, and the plain version's times of
    video_topk_affinity per model and T."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (l2_normalize, local_topk_attend_cuda,
                                   local_topk_attend_reference,
                                   video_topk_affinity_cuda,
                                   video_topk_affinity_reference)
    out, row1_plain = {}, {}
    h, w, p, topk = 60, 107, 20, 10
    for model, c, radius in MODELS:
        g = torch.Generator(device=dev).manual_seed(c)
        feats48 = l2_normalize(torch.randn((48, h, w, c), device=dev,
                                           generator=g)).contiguous()
        feats24 = feats48[:24].contiguous()
        res = {}
        with exact_fp32():
            err, mismatch, share = run_case(feats24, radius, topk, p, False,
                                            f'full {model}')
            for t_total, feats in ((24, feats24), (48, feats48)):
                res[t_total] = (
                    cuda_ms(lambda: video_topk_affinity_cuda(
                        feats, radius, 0.07, topk, p)),
                    cuda_ms(lambda: video_topk_affinity_reference(
                        feats, radius, 0.07, topk, p)),
                    *affinity_work(t_total, h, w, c, radius, topk, p))
        (k24, p24, f24, b24), (k48, p48, f48, b48) = res[24], res[48]
        row1_plain[model] = {24: p24, 48: p48}
        b_ms, b_by = bound_ms(f24, b24, smi_name)
        sb_ms, _ = bound_ms((f48 - f24) / 24, (b48 - b24) / 24, smi_name)
        out[model] = dict(
            shape=[24, h, w, c], radius=radius, precede_frames=p, topk=topk,
            max_abs_err=err, src_mismatch=mismatch,
            src_mismatch_share=share,
            kernel_ms_per_frame=k24 / 23, plain_ms_per_frame=p24 / 23,
            gflop_per_frame=f24 / 23 / 1e9, bound_ms_per_frame=b_ms / 23,
            bound_by=b_by,
            steady_kernel_ms_per_frame=(k48 - k24) / 24,
            steady_plain_ms_per_frame=(p48 - p24) / 24,
            steady_gflop_per_frame=(f48 - f24) / 24 / 1e9,
            steady_bound_ms_per_frame=sb_ms,
            bound_share=b_ms / k24,
            steady_bound_share=sb_ms / ((k48 - k24) / 24),
            pairs_needed_share=pairs_needed_share(h, w, radius),
            library_ms=None, library_note=NO_LIBRARY_CALL)
        del feats48, feats24
        torch.cuda.empty_cache()
    emit({'phase': 'full', 'kernel': KERNEL_INFO['name'], **out})

    out = {}
    f, k_classes = p + 1, 4
    for model, c, radius in MODELS:
        g = torch.Generator(device=dev).manual_seed(c + 1)
        bank = l2_normalize(torch.randn((f, h, w, c), device=dev,
                                        generator=g)).contiguous()
        query = l2_normalize(torch.randn((h, w, c), device=dev,
                                         generator=g)).contiguous()
        vals = torch.rand((f, h, w, k_classes), device=dev, generator=g)
        valid = torch.ones(f, dtype=torch.int32, device=dev)
        (err, logit_err, mismatch, share), _ = run_local(
            query, bank, vals, valid, radius, topk, False, f'full local {model}')

        def call(fn):
            return fn(query, bank, vals, valid, radius, 0.07, topk)

        with exact_fp32():
            kernel_ms = cuda_ms(lambda: call(local_topk_attend_cuda))
            plain_ms = cuda_ms(lambda: call(local_topk_attend_reference))
        flops, nbytes = step_work(h, w, c, radius, topk, k_classes, f, f)
        b_ms, b_by = bound_ms(flops, nbytes, smi_name)
        out[model] = dict(
            h=h, w=w, C=c, radius=radius, F=f, topk=topk, K=k_classes,
            max_abs_err=err, max_logit_err=logit_err, src_mismatch=mismatch,
            src_mismatch_share=share, kernel_ms_per_step=kernel_ms,
            plain_ms_per_step=plain_ms, gflop_per_step=flops / 1e9,
            bound_ms_per_step=b_ms, bound_by=b_by,
            bound_share=b_ms / kernel_ms,
            pairs_needed_share=pairs_needed_share(h, w, radius),
            library_ms=None, library_note=NO_LIBRARY_CALL)
        del bank, query, vals
        torch.cuda.empty_cache()
    emit({'phase': 'full', 'kernel': LOCAL_INFO['name'], **out})
    return out['r50'], row1_plain


def merge_ms(fn, steps=3):
    """Mean CUDA ms of row 3's merge kernel (stage 2) per launch over
    ``steps`` calls of ``fn``, from torch.profiler's kernel times (one
    warm-up step inside the profiler first: its device tracer may miss
    the kernels launched as it starts)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1)) as prof:
        for _ in range(steps + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    total, calls = 0.0, 0
    for e in prof.key_averages():
        if 'local_topk_merge_kernel' in e.key and \
                e.device_type == DeviceType.CUDA:
            total += e.self_device_time_total
            calls += e.count
    if total <= 0 or not calls:
        raise AssertionError('the profiler saw no merge kernel')
    return total / 1e3 / calls


def phase_full_modes(dev, smi_name):
    """Row 3's mode entries at the r18 and r50 DAVIS shapes (one step
    against a full bank of 21 random slots, K = 4; the full phase's
    inputs): each against its plain version (the mode gates), CUDA-event
    ms of the mode, of row 3's exact fp32 entry in turn and of the plain
    version, the bound (row 3's work; bf16 features two ways, as
    bf16_bounds) and its share; and the packed re-score apart: the merge
    kernel's profiler time, packed against exact. Returns {mode: {model:
    numbers}}."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (l2_normalize, local_topk_attend_cuda,
                                   local_topk_attend_reference)
    h, w, p, topk, k_classes = 60, 107, 20, 10, 4
    f = p + 1
    out = {name: {} for name, _ in LOCAL_MODES}
    for model, c, radius in MODELS:
        g = torch.Generator(device=dev).manual_seed(c + 1)
        bank = l2_normalize(torch.randn((f, h, w, c), device=dev,
                                        generator=g)).contiguous()
        query = l2_normalize(torch.randn((h, w, c), device=dev,
                                         generator=g)).contiguous()
        vals = torch.rand((f, h, w, k_classes), device=dev, generator=g)
        valid = torch.ones(f, dtype=torch.int32, device=dev)
        flops, nbytes = step_work(h, w, c, radius, topk, k_classes, f, f)
        b_ms, b_by = bound_ms(flops, nbytes, smi_name)
        bd = bf16_bounds(flops, nbytes - 2.0 * h * w * c * (1 + f), smi_name)
        for name, mode in LOCAL_MODES:
            res = {}
            for feat in (torch.float32, torch.bfloat16):
                q, b = query.to(feat), bank.to(feat)
                nums, _ = run_local_mode(q, b, vals, valid, radius, topk,
                                         False, f'full {name} {model} '
                                         f'{feat}', mode)

                def call(fn, **kw):
                    return fn(q, b, vals, valid, radius, 0.07, topk, **kw)

                with exact_fp32():
                    ms = cuda_ms(lambda: call(local_topk_attend_cuda,
                                              **mode))
                    exact_ms = cuda_ms(lambda: call(local_topk_attend_cuda))
                    ms2 = cuda_ms(lambda: call(local_topk_attend_cuda,
                                               **mode))
                    plain_ms = cuda_ms(lambda: call(
                        local_topk_attend_reference, **mode), runs=3)
                kernel_ms = statistics.median([ms, ms2])
                err, logit_err, mismatch, share, flips = nums
                row = dict(max_abs_err=err, max_logit_err=logit_err,
                           src_mismatch=mismatch, src_mismatch_share=share,
                           bf16_rounding_flips=flips, ms=kernel_ms,
                           ms_runs=[ms, ms2], exact_entry_ms=exact_ms,
                           vs_exact=kernel_ms / exact_ms - 1.0,
                           plain_ms=plain_ms, gflop=flops / 1e9)
                if feat == torch.float32:
                    row.update(bound_ms=b_ms, bound_by=b_by,
                               bound_share=b_ms / kernel_ms)
                else:
                    row.update(bound_share=bd['bound_ms'] / kernel_ms,
                               ffma_share=bd['ffma_bound_ms'] / kernel_ms,
                               **bd)
                if name == 'packed':
                    with exact_fp32():
                        pm = merge_ms(lambda: call(local_topk_attend_cuda,
                                                   **mode))
                        em = merge_ms(lambda: call(local_topk_attend_cuda))
                    row.update(merge_ms=pm, exact_merge_ms=em,
                               rescore_ms=pm - em)
                res['fp32' if feat == torch.float32 else 'bf16'] = row
            out[name][model] = dict(h=h, w=w, C=c, radius=radius, F=f,
                                    topk=topk, K=k_classes, **res)
        del bank, query, vals
        torch.cuda.empty_cache()
    emit({'phase': 'full', 'kernel': LOCAL_INFO['name'], 'modes': out})
    return out


def phase_full_v1(dev, smi_name, plain_ms):
    """video_topk_affinity_v1 at the r18 and r50 shapes, on the random
    features of row 1's full phase (same seeds: the plain version's times
    ``plain_ms`` are row 1's on these inputs) and on smooth features, with
    the tau exit on and off ('perframe'; the 'sweep' setting merges as the
    exit off does). Checks at T=24 against the plain version and that
    scores and sources equal row 1's kernel bit for bit. Times at T=24 and
    T=48, the shares of the bound and the (query, key row) merges run at
    T=48. Returns the kernels line's numbers: r50, T=48, random features,
    exit off (the vip path's setting and shape)."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (l2_normalize, video_topk_affinity_cuda,
                                   video_topk_affinity_reference,
                                   video_topk_affinity_v1_cuda)
    out = {}
    h, w, p, topk = 60, 107, 20, 10
    for model, c, radius in MODELS:
        g = torch.Generator(device=dev).manual_seed(c)
        inputs = dict(random=l2_normalize(torch.randn(
            (48, h, w, c), device=dev, generator=g)).contiguous())
        inputs['smooth'] = smooth_features(
            (48, h, w, c), dev, torch.Generator(device=dev).manual_seed(c + 2))
        (f24, b24), (f48, b48) = [affinity_work(t, h, w, c, radius, topk, p)
                                  for t in (24, 48)]
        res = dict(shape=[48, h, w, c], radius=radius, precede_frames=p,
                   topk=topk, plain_ms_per_frame=plain_ms[model][24] / 23,
                   steady_plain_ms_per_frame=(plain_ms[model][48]
                                              - plain_ms[model][24]) / 24,
                   bound_ms_per_frame=bound_ms(f24, b24, smi_name)[0] / 23,
                   steady_bound_ms_per_frame=bound_ms(
                       (f48 - f24) / 24, (b48 - b24) / 24, smi_name)[0],
                   pairs_needed_share=pairs_needed_share(h, w, radius),
                   library_ms=None, library_note=NO_LIBRARY_CALL)
        with exact_fp32():
            for kind, feats48 in inputs.items():
                feats24 = feats48[:24].contiguous()
                plain = video_topk_affinity_reference(feats24, radius, 0.07,
                                                      topk, p)
                row1 = video_topk_affinity_cuda(feats24, radius, 0.07, topk,
                                                p)
                for early_exit in (True, False):
                    def call(feats, count=None):
                        return video_topk_affinity_v1_cuda(
                            feats, radius, 0.07, topk, p,
                            early_exit=early_exit, extract='perframe',
                            merge_count=count)
                    got = call(feats24)
                    torch.cuda.synchronize()
                    what = f'full v1 {model} {kind} early_exit={early_exit}'
                    err, mismatch, share = compare(
                        (got[0][1:], got[1][1:]),
                        (plain[0][1:], plain[1][1:]), False, what)
                    if not (torch.equal(got[0][1:], row1[0][1:])
                            and torch.equal(got[1][1:], row1[1][1:])):
                        raise AssertionError(f'{what}: differs from row 1')
                    count = torch.zeros(1, dtype=torch.int64, device=dev)
                    call(feats48, count)
                    k24 = cuda_ms(lambda: call(feats24))
                    k48 = cuda_ms(lambda: call(feats48))
                    res[f'{kind}/early_exit={early_exit}'] = dict(
                        max_abs_err=err, src_mismatch=mismatch,
                        src_mismatch_share=share, equal_to_row1=True,
                        kernel_ms=k48, kernel_ms_per_frame=k24 / 23,
                        steady_kernel_ms_per_frame=(k48 - k24) / 24,
                        bound_share=res['bound_ms_per_frame'] * 23 / k24,
                        steady_bound_share=(res['steady_bound_ms_per_frame']
                                            * 24 / (k48 - k24)),
                        merges_T48=int(count))
        out[model] = res
        del inputs
        torch.cuda.empty_cache()
    emit({'phase': 'full', 'kernel': V1_INFO['name'], **out})
    r50 = out['r50']['random/early_exit=False']
    b_ms, b_by = bound_ms(*affinity_work(48, h, w, 1024, 18.0, topk, p),
                          smi_name)
    return dict(max_abs_err=r50['max_abs_err'],
                src_mismatch=r50['src_mismatch'], ms=r50['kernel_ms'],
                plain_ms=plain_ms['r50'][48], bound_ms=b_ms, bound_by=b_by,
                bound_share=b_ms / r50['kernel_ms'])


def phase_full_v2(dev, smi_name):
    """local_topk_attend_v2 for one step against a full bank at the r18
    and r50 shapes, on the inputs of row 3's full phase. Its path is the
    op entry point ``local_topk_attend_v2``, called once per model with
    the launch count set to 0 before the first call and read after the
    last. Held against the plain version and against row 3's kernel (the
    same function, the same arithmetic: scores and sources equal), with
    the (query, key row) merges it ran. Returns the kernels line's entry
    (r50)."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (l2_normalize, local_topk_attend_cuda,
                                   local_topk_attend_reference,
                                   local_topk_attend_v2,
                                   local_topk_attend_v2_cuda)
    h, w, p, topk, k_classes = 60, 107, 20, 10, 4
    f = p + 1
    inputs = {}
    for model, c, radius in MODELS:
        g = torch.Generator(device=dev).manual_seed(c + 1)
        bank = l2_normalize(torch.randn((f, h, w, c), device=dev,
                                        generator=g)).contiguous()
        query = l2_normalize(torch.randn((h, w, c), device=dev,
                                         generator=g)).contiguous()
        vals = torch.rand((f, h, w, k_classes), device=dev, generator=g)
        valid = torch.ones(f, dtype=torch.int32, device=dev)
        inputs[model] = (query, bank, vals, valid, radius)

    # the path: the op entry point, counted
    local_topk_attend_v2_cuda.launches = 0
    with exact_fp32():
        got = {model: local_topk_attend_v2(q, b, v, ok, radius, 0.07, topk)
               for model, (q, b, v, ok, radius) in inputs.items()}
    torch.cuda.synchronize()
    launches = local_topk_attend_v2_cuda.launches
    if launches != len(MODELS):
        raise AssertionError(f'{launches} launches of local_topk_attend_v2 '
                             f'for {len(MODELS)} calls')

    out = {}
    for model, c, radius in MODELS:
        query, bank, vals, valid, _ = inputs.pop(model)

        def call(fn, count=None):
            if count is None:
                return fn(query, bank, vals, valid, radius, 0.07, topk)
            return fn(query, bank, vals, valid, radius, 0.07, topk,
                      merge_count=count)

        with exact_fp32():
            plain = call(local_topk_attend_reference)
            row3 = call(local_topk_attend_cuda)
            torch.cuda.synchronize()
            err, logit_err, mismatch, share = compare_local(
                got[model], plain, False, f'full v2 {model}')
            _, row3_logit_err, row3_mismatch, _ = compare_local(
                got[model], row3, True, f'full v2 {model} vs row 3')
            if not (torch.equal(got[model][1], row3[1])
                    and torch.equal(got[model][2], row3[2])):
                raise AssertionError(f'full v2 {model}: scores or sources '
                                     'differ from row 3')
            count = torch.zeros(1, dtype=torch.int64, device=dev)
            call(local_topk_attend_v2_cuda, count)
            kernel_ms = cuda_ms(lambda: call(local_topk_attend_v2_cuda))
            plain_ms = cuda_ms(lambda: call(local_topk_attend_reference))
            row3_ms = cuda_ms(lambda: call(local_topk_attend_cuda))
        flops, nbytes = step_work(h, w, c, radius, topk, k_classes, f, f)
        b_ms, b_by = bound_ms(flops, nbytes, smi_name)
        out[model] = dict(
            h=h, w=w, C=c, radius=radius, F=f, topk=topk, K=k_classes,
            max_abs_err=err, max_logit_err=logit_err, src_mismatch=mismatch,
            src_mismatch_share=share, src_mismatch_vs_row3=row3_mismatch,
            max_logit_err_vs_row3=row3_logit_err,
            kernel_ms_per_step=kernel_ms, plain_ms_per_step=plain_ms,
            row3_kernel_ms_per_step=row3_ms, merges=int(count),
            gflop_per_step=flops / 1e9, bound_ms_per_step=b_ms,
            bound_by=b_by, bound_share=b_ms / kernel_ms,
            pairs_needed_share=pairs_needed_share(h, w, radius),
            library_ms=None, library_note=NO_LIBRARY_CALL)
        del query, bank, vals
        torch.cuda.empty_cache()
    emit({'phase': 'full', 'kernel': V2_INFO['name'], 'launches': launches,
          **out})
    r50 = out['r50']
    return dict(**V2_INFO, launches=launches, max_abs_err=r50['max_abs_err'],
                src_mismatch=r50['src_mismatch'],
                ms=r50['kernel_ms_per_step'],
                plain_ms=r50['plain_ms_per_step'],
                bound_ms=r50['bound_ms_per_step'], bound_by=r50['bound_by'],
                bound_share=r50['bound_share'],
                library_ms=None, library_note=NO_LIBRARY_CALL)


def wide_small(dev, tensor):
    """Rows 1-4's wide path over ``WIDE_VIDEO_CASES`` and
    ``WIDE_LOCAL_CASES`` and a duplicated-frame tie case at top-40, through
    the four wrappers, against the plain versions (the small phase's
    gates); rows 2 and 4 bit-equal to rows 1 and 3; bf16 features bit-equal
    to the fp32 entry on the widened features; row 3's modes
    (``compare_mode``)."""
    import torch
    from vfs_tpu_torch.ops import (l2_normalize, video_topk_affinity_cuda,
                                   video_topk_affinity_reference)
    results = []
    cases = [(c, np.random.RandomState(sum(c[:4]) + 14), False)
             for c in WIDE_VIDEO_CASES]
    rng = np.random.RandomState(19)
    for (t_total, h, w, c, radius, p, topk), rng_c, tie in cases + [
            ((10, 8, 9, 8, 3.0, 4, 40), rng, True)]:
        raw = rng_c.randn(t_total, h, w, c)
        if tie:
            raw[3], raw[7] = raw[1], raw[5]
        feats = l2_normalize(tensor(raw)).contiguous()
        what = f'wide video {t_total}x{h}x{w}x{c} r={radius} k={topk}'
        err, mismatch, merges = run_v1_case(feats, radius, topk, p, tie,
                                            what)
        if c % 8 == 0:
            fb = feats.to(torch.bfloat16)
            widened = video_topk_affinity_cuda(fb.float().contiguous(),
                                               radius, 0.07, topk, p)
            bf16 = video_topk_affinity_cuda(fb, radius, 0.07, topk, p)
            if not (torch.equal(bf16[0][1:], widened[0][1:]) and torch.equal(
                    bf16[1][1:], widened[1][1:])):
                raise AssertionError(f'{what}: bf16 features differ from '
                                     'the fp32 entry on the widened ones')
        plain = video_topk_affinity_reference(feats, radius, 0.07, topk, p)
        fillers = int((plain[0][1:] <= -1e29).sum())
        results.append([t_total, h, w, c, radius, p, topk, tie, err,
                        mismatch, fillers])
    emit({'phase': 'wide', 'part': 'small_video',
          'columns': ['T', 'h', 'w', 'C', 'radius', 'P', 'topk', 'tie',
                      'max_abs_err', 'src_mismatch', 'filler_entries'],
          'cases': results})

    results = []
    rng = np.random.RandomState(23)
    tie_bank = rng.randn(5, 8, 9, 16)
    tie_bank[2], tie_bank[4] = tie_bank[0], tie_bank[1]
    cases = [(c, np.random.RandomState(c[0] * 100 + c[1] + 14), False)
             for c in WIDE_LOCAL_CASES]
    for (h, w, c, radius, valid, topk, k), rng_c, tie in cases + [
            ((8, 9, 16, 3.0, (1,) * 5, 40, 4), rng, True)]:
        f = len(valid)
        query = tensor(rng_c.randn(h, w, c))
        bank = tensor(tie_bank) if tie else tensor(rng_c.randn(f, h, w, c))
        vals = tensor(rng_c.rand(f, h, w, k))
        what = f'wide local {h}x{w}x{c} r={radius} F={f} k={topk}'
        row = [h, w, c, radius, f, sum(valid), topk, k, tie]
        for feat in (torch.float32, torch.bfloat16):
            if feat == torch.bfloat16 and c % 8:
                continue
            q = l2_normalize(query).to(feat).contiguous()
            b = l2_normalize(bank).to(feat).contiguous()
            valid_t = tensor(valid, torch.int32)
            for name, mode in (('exact', {}),) + LOCAL_MODES:
                label = f'{what} {name} {feat}'
                if feat == torch.float32 and not mode:  # the exact gate
                    nums = (*run_local(q, b, vals, valid_t, radius, topk,
                                       tie, label)[0], 0)
                    run_local_v2(q, b, vals, valid_t, radius, topk, tie,
                                 f'{what} v2')
                else:
                    nums, _ = run_local_mode(q, b, vals, valid_t, radius,
                                             topk, tie, label, mode)
                results.append(row + [name, str(feat).split('.')[-1],
                                      *nums])
    emit({'phase': 'wide', 'part': 'small_local',
          'columns': ['h', 'w', 'C', 'radius', 'F', 'valid', 'topk', 'K',
                      'tie', 'mode', 'features', 'max_abs_err',
                      'max_logit_err', 'src_mismatch', 'src_mismatch_share',
                      'bf16_rounding_flips'],
          'cases': results})


def wide_full(dev, smi_name):
    """Rows 1-4's wide path at the r18 full width (C = 256, 60 x 107, P =
    20, ``WIDE_FULL_FRAMES`` frames; a step against 21 valid slots with
    K = 4) for each of ``WIDE_FULL``: each row against the plain version
    (TF32 off; the full phase's gates), rows 2 and 4 bit-equal to rows 1
    and 3, CUDA-event ms, the plain version's ms and the bound. Row 4
    through its op entry (``local_topk_attend_v2``), its wide count set to
    0 first. Then the wide ops forced at the core sizes of ``WIDE_FORCED``
    (``wide_forced``). Returns the kernels line's entries' numbers
    per row and row 4's op launches."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (l2_normalize, local_topk_attend_cuda,
                                   local_topk_attend_reference,
                                   local_topk_attend_v2,
                                   local_topk_attend_v2_cuda,
                                   video_topk_affinity_cuda,
                                   video_topk_affinity_reference,
                                   video_topk_affinity_v1_cuda)
    h, w, c, p, t_total, k_classes = 60, 107, 256, 20, WIDE_FULL_FRAMES, 4
    f = p + 1
    g = torch.Generator(device=dev).manual_seed(14)
    feats = l2_normalize(torch.randn((t_total, h, w, c), device=dev,
                                     generator=g)).contiguous()
    bank = l2_normalize(torch.randn((f, h, w, c), device=dev,
                                    generator=g)).contiguous()
    query = l2_normalize(torch.randn((h, w, c), device=dev,
                                     generator=g)).contiguous()
    vals = torch.rand((f, h, w, k_classes), device=dev, generator=g)
    valid = torch.ones(f, dtype=torch.int32, device=dev)
    rows = {1: {}, 2: {}, 3: {}, 4: {}}
    row4_launches = 0
    for radius, topk in WIDE_FULL:
        key = f'radius{radius:g}_top{topk}'

        def video(fn, **kw):
            return fn(feats, radius, 0.07, topk, p, **kw)

        def local(fn):
            return fn(query, bank, vals, valid, radius, 0.07, topk)

        with exact_fp32():
            # T = 24 calls last seconds: each timed on its checked run (the
            # wide kernel is warm from wide_small)
            plain, plain_v = cuda_call(
                lambda: video(video_topk_affinity_reference))
            row1, ms1 = cuda_call(lambda: video(video_topk_affinity_cuda))
            row2, ms2 = cuda_call(lambda: video(video_topk_affinity_v1_cuda,
                                                extract='perframe'))
            err, mismatch, share = compare(
                (row1[0][1:], row1[1][1:]), (plain[0][1:], plain[1][1:]),
                False, f'wide full row 1 {key}')
            if not (torch.equal(row2[0], row1[0])
                    and torch.equal(row2[1], row1[1])):
                raise AssertionError(f'wide full row 2 {key}: differs '
                                     'from row 1')
            del plain
            (l_err, logit_err, l_mismatch, l_share), row3 = run_local(
                query, bank, vals, valid, radius, topk, False,
                f'wide full row 3 {key}')
            local_topk_attend_v2_cuda.wide_launches = 0  # its op entry
            row4 = local(local_topk_attend_v2)
            row4_launches += local_topk_attend_v2_cuda.wide_launches
            if not (torch.equal(row4[1], row3[1])
                    and torch.equal(row4[2], row3[2])):
                raise AssertionError(f'wide full row 4 {key}: differs '
                                     'from row 3')
            ms3 = cuda_ms(lambda: local(local_topk_attend_cuda), runs=3)
            ms4 = cuda_ms(lambda: local(local_topk_attend_v2_cuda), runs=3)
            plain_l = cuda_ms(lambda: local(local_topk_attend_reference),
                              runs=1, warmup=0)
        v_flops, v_bytes = affinity_work(t_total, h, w, c, radius, topk, p)
        l_flops, l_bytes = step_work(h, w, c, radius, topk, k_classes, f, f)
        vb, vby = bound_ms(v_flops, v_bytes, smi_name)
        lb, lby = bound_ms(l_flops, l_bytes, smi_name)
        common = dict(radius=radius, topk=topk, library_ms=None,
                      library_note=NO_LIBRARY_CALL)
        video_nums = dict(common, shape=[t_total, h, w, c],
                          precede_frames=p, max_abs_err=err,
                          src_mismatch=mismatch, src_mismatch_share=share,
                          plain_ms=plain_v, gflop=v_flops / 1e9,
                          bound_ms=vb, bound_by=vby)
        local_nums = dict(common, h=h, w=w, C=c, F=f, K=k_classes,
                          max_abs_err=l_err, max_logit_err=logit_err,
                          src_mismatch=l_mismatch,
                          src_mismatch_share=l_share, plain_ms=plain_l,
                          gflop=l_flops / 1e9, bound_ms=lb, bound_by=lby)
        for row, ms, nums in ((1, ms1, video_nums), (2, ms2, video_nums),
                              (3, ms3, local_nums), (4, ms4, local_nums)):
            rows[row][key] = dict(nums, ms=ms, bound_share=nums['bound_ms']
                                  / ms)
        del row1, row2, row3, row4
        torch.cuda.empty_cache()
    if row4_launches != len(WIDE_FULL):
        raise AssertionError(f'row 4 op entry: {row4_launches} wide '
                             'launches')
    split = wide_split(query, bank, vals, valid)
    forced = {f'radius{radius:g}_top{topk}': wide_forced(
        feats, query, bank, vals, valid, p, radius, topk)
        for radius, topk in WIDE_FORCED}
    del feats, bank, query, vals
    torch.cuda.empty_cache()
    r50 = wide_r50(dev, smi_name)
    for row, nums in r50.items():
        rows[row][f'r50_{WIDE_R50_KEY}'] = nums
    emit({'phase': 'wide', 'part': 'full', 'card': smi_name,
          'rows': {f'row{r}': v for r, v in rows.items()},
          'row3w_split': split, 'forced': forced})
    return rows, row4_launches


def wide_r50(dev, smi_name):
    """Rows 1w and 3w at the r50 width (C = 1024, 60 x 107, P = 20, T =
    ``WIDE_FULL_FRAMES``; a step against 21 slots, K = 4) at radius 40 /
    top-10: each against its plain version under the full phase's gates
    (TF32 off), its CUDA-event ms, the plain version's and the bound."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (l2_normalize, local_topk_attend_cuda,
                                   local_topk_attend_reference,
                                   video_topk_affinity_cuda,
                                   video_topk_affinity_reference)
    h, w, c, p, t_total, k_classes = 60, 107, 1024, 20, WIDE_FULL_FRAMES, 4
    radius, topk = WIDE_FULL[0]
    f = p + 1
    g = torch.Generator(device=dev).manual_seed(50)
    feats = l2_normalize(torch.randn((t_total, h, w, c), device=dev,
                                     generator=g)).contiguous()
    bank = l2_normalize(torch.randn((f, h, w, c), device=dev,
                                    generator=g)).contiguous()
    query = l2_normalize(torch.randn((h, w, c), device=dev,
                                     generator=g)).contiguous()
    vals = torch.rand((f, h, w, k_classes), device=dev, generator=g)
    valid = torch.ones(f, dtype=torch.int32, device=dev)
    with exact_fp32():
        plain, plain_v = cuda_call(lambda: video_topk_affinity_reference(
            feats, radius, 0.07, topk, p))
        row1, ms1 = cuda_call(lambda: video_topk_affinity_cuda(
            feats, radius, 0.07, topk, p))
        err, mismatch, share = compare(
            (row1[0][1:], row1[1][1:]), (plain[0][1:], plain[1][1:]), False,
            f'wide r50 row 1 {WIDE_R50_KEY}')
        del plain, row1
        (l_err, logit_err, l_mismatch, l_share), _ = run_local(
            query, bank, vals, valid, radius, topk, False,
            f'wide r50 row 3 {WIDE_R50_KEY}')
        ms3 = cuda_ms(lambda: local_topk_attend_cuda(
            query, bank, vals, valid, radius, 0.07, topk), runs=3)
        plain_l = cuda_ms(lambda: local_topk_attend_reference(
            query, bank, vals, valid, radius, 0.07, topk), runs=1, warmup=0)
    v_flops, v_bytes = affinity_work(t_total, h, w, c, radius, topk, p)
    l_flops, l_bytes = step_work(h, w, c, radius, topk, k_classes, f, f)
    vb, vby = bound_ms(v_flops, v_bytes, smi_name)
    lb, lby = bound_ms(l_flops, l_bytes, smi_name)
    torch.cuda.empty_cache()
    return {1: dict(shape=[t_total, h, w, c], ms=ms1, plain_ms=plain_v,
                    bound_ms=vb, bound_by=vby, bound_share=vb / ms1,
                    max_abs_err=err, src_mismatch=mismatch,
                    src_mismatch_share=share),
            3: dict(h=h, w=w, C=c, F=f, K=k_classes, ms=ms3,
                    plain_ms=plain_l, bound_ms=lb, bound_by=lby,
                    bound_share=lb / ms3, max_abs_err=l_err,
                    max_logit_err=logit_err, src_mismatch=l_mismatch,
                    src_mismatch_share=l_share)}


def wide_forced(feats, query, bank, vals, valid, p, radius, topk):
    """The wide ops forced at a core size (``WIDE_FORCED``): bit-equal to
    rows 1 and 3 in every mode and feature type, and their ms (fp32,
    exact) beside the core's."""
    import torch
    from vfs_tpu_torch.ops import (local_topk_attend_cuda,
                                   local_topk_attend_wide_cuda,
                                   video_topk_affinity_cuda,
                                   video_topk_affinity_wide_cuda)
    forced = {}
    what = f'radius {radius:g} / top-{topk}'
    for feat in (torch.float32, torch.bfloat16):
        name = str(feat).split('.')[-1]
        fv = feats.to(feat)
        a = video_topk_affinity_wide_cuda(fv, radius, 0.07, topk, p)
        b = video_topk_affinity_cuda(fv, radius, 0.07, topk, p)
        if not (torch.equal(a[0][1:], b[0][1:])
                and torch.equal(a[1][1:], b[1][1:])):
            raise AssertionError(f'wide video {name} at {what} differs '
                                 'from row 1')
        q, bk = query.to(feat), bank.to(feat)
        for mname, mode in (('exact', {}),) + LOCAL_MODES:
            a = local_topk_attend_wide_cuda(q, bk, vals, valid, radius, 0.07,
                                            topk, **mode)
            b = local_topk_attend_cuda(q, bk, vals, valid, radius, 0.07,
                                       topk, **mode)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f'wide local {mname} {name} at {what} '
                                     'differs from row 3')
            forced[f'row3_{mname}_{name}'] = 'bit-equal'
        forced[f'row1_{name}'] = 'bit-equal'
    forced['ms'] = dict(
        row1_wide=cuda_ms(lambda: video_topk_affinity_wide_cuda(
            feats, radius, 0.07, topk, p), runs=3),
        row1_core=cuda_ms(lambda: video_topk_affinity_cuda(
            feats, radius, 0.07, topk, p), runs=3),
        row3_wide=cuda_ms(lambda: local_topk_attend_wide_cuda(
            query, bank, vals, valid, radius, 0.07, topk), runs=3),
        row3_core=cuda_ms(lambda: local_topk_attend_cuda(
            query, bank, vals, valid, radius, 0.07, topk), runs=3))
    return forced


def wide_split(query, bank, vals, valid):
    """Where row 3w's time goes at radius 40 / top-10 (``WIDE_SPLIT_*``):
    CUDA-event ms at each channel count, the least-squares fit ms = a + b *
    C over them (a: the time that does not scale with C, the walk over the
    window, the sorts and the merges; b * C: the scoring), bf16 features
    (half the key bytes, the same load instructions) and top-48."""
    import torch
    from vfs_tpu_torch.ops import l2_normalize, local_topk_attend_wide_cuda
    radius, topk = WIDE_FULL[0]

    def ms(q, bk, k=topk):
        return cuda_ms(lambda: local_topk_attend_wide_cuda(
            q, bk, vals, valid, radius, 0.07, k), runs=2)

    by_c = {}
    for c in WIDE_SPLIT_CHANNELS:
        q = l2_normalize(query[..., :c]).contiguous()
        bk = l2_normalize(bank[..., :c]).contiguous()
        by_c[c] = ms(q, bk)
    cs = np.array(WIDE_SPLIT_CHANNELS, np.float64)
    b, a = np.polyfit(cs, np.array([by_c[c] for c in WIDE_SPLIT_CHANNELS]),
                      1)
    full = by_c[WIDE_SPLIT_CHANNELS[-1]]
    return dict(radius=radius, topk=topk, ms_by_channels=by_c,
                fit_a_ms=float(a), fit_b_ms_per_channel=float(b),
                fixed_share=float(a) / full,
                bf16_ms=ms(query.to(torch.bfloat16), bank.to(torch.bfloat16)),
                topk48_ms=ms(query, bank, WIDE_SPLIT_TOPK))


def wide_forward(dev):
    """r18 ``forward_test`` on the main path's 48x480x854 video at
    ``WIDE_NEIGHBOR_RANGE`` under each of ``WIDE_BACKENDS``, each wide
    count set to 0 before: the wide kernel must launch (row 1 once, row 2
    once, row 3 once a step) and no core; the masks must agree with the
    tiled run's on >= 99.9% of pixels. Returns each backend's numbers and
    the wide launches by row."""
    import runpy
    import torch
    from vfs_tpu_torch import ops
    from vfs_tpu_torch.models import build_model
    cfg = runpy.run_path(CONFIG)
    model = build_model(dict(type='VanillaTracker',
                             backbone=dict(cfg['model']['backbone'])),
                        test_cfg=dict(cfg['test_cfg']))
    model.init_weights(torch.Generator().manual_seed(0))
    imgs, gt = synthetic_video()
    t_total = imgs.shape[0]
    meta = [dict(original_shape=imgs.shape[1:3],
                 img_norm_cfg=dict(cfg['img_norm_cfg']))]
    wrappers = {1: ops.video_topk_affinity_cuda,
                2: ops.video_topk_affinity_v1_cuda,
                3: ops.local_topk_attend_cuda}
    want = {'tiled': {1: 1}, 'pallas_video_v1': {2: 1},
            'pallas': {3: t_total - 1}}
    runs, masks, launches = {}, {}, {}
    for name, extra in WIDE_BACKENDS:
        model.test_cfg = dict(cfg['test_cfg'],
                              neighbor_range=WIDE_NEIGHBOR_RANGE, **extra)
        for k in wrappers.values():
            k.wide_launches = 0
        before = kernel_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        preds = model.forward_test(imgs, gt[0], meta)[0]
        torch.cuda.synchronize()
        wall = time.time() - t0
        wide = {row: k.wide_launches for row, k in wrappers.items()}
        got = {row: n for row, n in wide.items() if n}
        if got != want[name] or kernel_launches() - before != sum(
                got.values()):
            raise AssertionError(f'wide forward_test {name}: wide launches '
                                 f'{wide}, all {kernel_launches() - before}')
        if preds.shape != gt.shape or preds.max() > 2:
            raise AssertionError(f'wide forward_test {name}: bad masks')
        masks[name] = preds
        launches.update(got)
        runs[name] = dict(wall_s=wall, ms_per_frame=wall * 1e3 / t_total,
                          wide_launches=sum(got.values()))
    model.test_cfg = dict(cfg['test_cfg'])
    for name in masks:
        runs[name]['mask_agree_tiled'] = float(
            (masks[name] == masks['tiled']).mean())
        if runs[name]['mask_agree_tiled'] < 0.999:
            raise AssertionError(f'wide forward_test {name}: masks agree on '
                                 f"{runs[name]['mask_agree_tiled']} < 0.999")
    emit({'phase': 'wide', 'part': 'forward_test', 'video': list(imgs.shape),
          'neighbor_range': WIDE_NEIGHBOR_RANGE, 'runs': runs})
    return launches


# Row 1's tensor-core path (csrc/video_topk_tc.cu): the small cases (T,
# h, w, C, radius, P, topk) at tile, chunk and radius edges (r 0, 3, 11,
# 17 and 31: every instance of the kernels), and the feature kinds whose
# near ties overflow its lists
TC_SMALL_CASES = [(5, 9, 40, 16, 4.0, 2, 4), (6, 10, 40, 32, 4.0, 3, 10),
                  (6, 12, 45, 64, 12.0, 20, 10), (5, 20, 70, 48, 18.0, 3, 10),
                  (4, 10, 70, 36, 31.5, 2, 8), (5, 17, 37, 1024, 18.0, 20, 10),
                  (4, 9, 33, 20, 1.0, 1, 1), (4, 9, 33, 20, 1.5, 2, 32)]
TC_KINDS = ('random', 'static', 'flat', 'ulp')


def tc_feats(dev, kind, t_total, h, w, c, seed):
    """L2-normalised (T, h, w, C) fp32 features on ``dev``: random, or
    with near ties: every frame the first ('static', a still background),
    a constant region in every frame ('flat'), frames 2.. an ulp from
    frame 1 in one channel ('ulp')."""
    import torch
    from vfs_tpu_torch.ops import l2_normalize
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((t_total, h, w, c), device=dev, generator=g)
    if kind == 'static':
        x[1:] = x[0]
    elif kind == 'flat':
        x[:, h // 4:h // 2 + 1, w // 4:w // 2 + 1] = x[0, 0, 0]
    f = l2_normalize(x).contiguous()
    if kind == 'ulp':
        f[2:] = f[1]
        for t in range(2, t_total):
            ch = f[1, ..., t % c]
            f[t, ..., t % c] = torch.nextafter(
                ch, torch.full_like(ch, float('inf') if t % 2
                                    else float('-inf')))
    return f


def tc_counted(feats, radius, topk, p):
    """The tensor-core path's outputs and its counters (a recording)."""
    import torch
    from vfs_tpu_torch.ops.video_affinity import flush_counts, launch_tc
    from vfs_tpu_torch.utils import trace
    with trace.recording() as rec:
        out = launch_tc(feats, radius, 0.07, topk, p)
        torch.cuda.synchronize()
        flush_counts()
    return out, dict(rec.counts)


def tc_same(a, b):
    """Whether two (scores, src) are equal bit for bit."""
    import torch
    return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))


def tf32_np(x):
    """fp32 values with their low 13 mantissa bits cleared (TF32)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xffffe000)).view(np.float32)


def mma_model_check(dev, n=2048, seed=0):
    """window_geometry.MMA_RHO's model on the card: n single k8 steps of
    wgmma m64n56 TF32, the main kernel's shape
    (``vfs_video_topk_mma_check``), on TF32-exact operands of four kinds (c near 1 with products just under its last
    bits, spread exponents, sums that cancel c, feature-like values), each
    result against the float64 sum; and n more on raw fp32 operands
    (c = 0), against the products of their truncated and their rounded
    TF32 parts. Returns the largest |d - exact| / (|c| + sum |a_i b_i|)
    in units of rho by kind (the raw kinds: against truncation), the
    shares of results equal to the exact sum rounded to nearest and toward
    zero, and the raw runs' largest gap to rounded operands."""
    import torch
    from vfs_tpu_torch.ops import window_geometry
    from vfs_tpu_torch.ops.video_affinity import _tc_library
    rng = np.random.RandomState(seed)
    q = n // 4

    def signed(*shape):
        return rng.uniform(1, 2, shape) * rng.choice([-1, 1], shape)

    a, b, c = signed(n, 64, 8), signed(n, 56, 8), signed(n, 64, 56)
    a[:q] *= 2.0 ** rng.randint(-14, -11, (q, 64, 8))      # under c's ulp
    b[:q] *= 2.0 ** rng.randint(-14, -11, (q, 56, 8))
    a[q:2 * q] *= 2.0 ** rng.randint(-20, 1, (q, 64, 8))   # spread
    b[q:2 * q] *= 2.0 ** rng.randint(-20, 1, (q, 56, 8))
    c[q:2 * q] *= 2.0 ** rng.randint(-24, 4, (q, 64, 56))
    a[3 * q:] = rng.randn(n - 3 * q, 64, 8) / np.sqrt(1024)  # features
    b[3 * q:] = rng.randn(n - 3 * q, 56, 8) / np.sqrt(1024)
    c[3 * q:] = rng.randn(n - 3 * q, 64, 56) / 4

    def run(a, b, c):
        d = torch.empty((n, 64, 56), dtype=torch.float32, device=dev)
        ta, tb, tcc = (torch.from_numpy(np.ascontiguousarray(
            x, np.float32)).to(dev) for x in (a, b, c))
        err = _tc_library().vfs_video_topk_mma_check(
            ta.data_ptr(), tb.data_ptr(), tcc.data_ptr(), d.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f'mma check launch failed: CUDA error {err}')
        return d.cpu().numpy().astype(np.float64)

    def exact_of(a, b, c):
        a, b = a.astype(np.float64), b.astype(np.float64)
        c = c.astype(np.float64)
        return (c + a @ b.transpose(0, 2, 1),
                np.abs(c) + np.abs(a) @ np.abs(b).transpose(0, 2, 1))

    a, b = tf32_np(a), tf32_np(b)
    prod = a.astype(np.float64) @ b.astype(np.float64).transpose(0, 2, 1)
    c[2 * q:3 * q] = -prod[2 * q:3 * q] * (1 + rng.uniform(  # cancelling
        -1e-6, 1e-6, (q, 64, 56)))
    c = c.astype(np.float32)
    got = run(a, b, c)
    exact, mag = exact_of(a, b, c)
    ratio = np.abs(got - exact) / mag / window_geometry.MMA_RHO
    rn = exact.astype(np.float32)
    rz = np.where(np.abs(rn.astype(np.float64)) > np.abs(exact),
                  np.nextafter(rn, np.float32(0)), rn)
    kinds = ('under_ulp', 'spread', 'cancel', 'features')
    out = dict(max_err_over_rho={k: float(ratio[i * q:(i + 1) * q].max())
                                 for i, k in enumerate(kinds)},
               rounded_nearest_share=float((got == rn).mean()),
               rounded_toward_zero_share=float((got == rz).mean()),
               steps=n)
    raw_a = rng.randn(n, 64, 8).astype(np.float32)
    raw_b = rng.randn(n, 56, 8).astype(np.float32)
    got = run(raw_a, raw_b, np.zeros((n, 64, 56), np.float32))
    exact, mag = exact_of(tf32_np(raw_a), tf32_np(raw_b),
                          np.zeros((n, 64, 56)))
    out['max_err_over_rho']['raw_truncated'] = float(
        (np.abs(got - exact) / mag).max() / window_geometry.MMA_RHO)
    rna = [((np.ascontiguousarray(x).view(np.uint32) + np.uint32(0x1000))
            & np.uint32(0xffffe000)).view(np.float32) for x in (raw_a, raw_b)]
    exact, mag = exact_of(*rna, np.zeros((n, 64, 56)))
    out['raw_vs_rounded_operands_over_rho'] = float(
        (np.abs(got - exact) / mag).max() / window_geometry.MMA_RHO)
    return out


def phase_tc(dev, smi_line):
    """Row 1's tensor-core path against the FFMA core, bit for bit: the
    small cases on random and near-tie features, then the r18 and r50
    widths (T = 24, 60 x 107, P = 20, top-10) on each feature kind, with
    the keys it re-scored and the queries its lists did not settle; and
    the accumulation model's check."""
    import torch
    from vfs_tpu_torch.ops.video_affinity import launch_core
    small = []
    for t_total, h, w, c, radius, p, topk in TC_SMALL_CASES:
        for kind in TC_KINDS:
            feats = tc_feats(dev, kind, t_total, h, w, c, t_total * 1000 + c)
            out, counts = tc_counted(feats, radius, topk, p)
            same = tc_same(out, launch_core(feats, radius, 0.07, topk, p))
            small.append([t_total, h, w, c, radius, p, topk, kind, same,
                          counts.get('row1.overflow_queries', 0)])
            if not same:
                raise AssertionError(f'tensor-core row 1 differs from the '
                                     f'core: {small[-1]}')
    full = {}
    h, w, p, topk = 60, 107, 20, 10
    for model, c, radius in MODELS:
        for kind in TC_KINDS:
            feats = tc_feats(dev, kind, 24, h, w, c, c)
            out, counts = tc_counted(feats, radius, topk, p)
            same = tc_same(out, launch_core(feats, radius, 0.07, topk, p))
            if not same:
                raise AssertionError(f'tensor-core row 1 differs from the '
                                     f'core: {model} {kind}')
            queries = 23 * h * w
            full[f'{model}/{kind}'] = dict(
                bit_identical=same, **counts,
                overflow_share=counts.get('row1.overflow_queries', 0)
                / queries)
            del feats, out
            torch.cuda.empty_cache()
    model_check = mma_model_check(dev)
    if max(model_check['max_err_over_rho'].values()) > 1:
        raise AssertionError(f'the mma accumulation model fails: '
                             f'{model_check}')
    emit({'phase': 'tc', 'card': smi_line,
          'columns': ['T', 'h', 'w', 'C', 'radius', 'P', 'topk', 'kind',
                      'bit_identical', 'overflow_queries'],
          'small': small, 'full': full, 'mma_model': model_check})


# the wgrad3d phase: the narrow weight-gradient kernel
# (csrc/conv3d_wgrad.cu) against float64 on small shapes, each case (X
# shape (N, Cin, T, H, W), weight shape, stride, padding) in NCDHW and
# NDHWC: the five families of SlowFast's narrow convolutions, ragged row
# tiles and segments, padding, stride (1, 2, 2), the laterals' temporal
# stride 8, a 16-byte-misaligned stem row (W * Cin not a multiple of 4)
WGRAD3D_SMALL = (((2, 3, 6, 20, 22), (8, 3, 5, 7, 7), (1, 2, 2), (2, 3, 3)),
                 ((1, 3, 3, 9, 16), (8, 3, 5, 7, 7), (1, 2, 2), (2, 3, 3)),
                 ((2, 3, 3, 17, 15), (64, 3, 1, 7, 7), (1, 2, 2), (0, 3, 3)),
                 ((2, 8, 4, 9, 7), (32, 8, 1, 1, 1), (1, 1, 1), (0, 0, 0)),
                 ((2, 8, 4, 9, 7), (8, 8, 1, 3, 3), (1, 1, 1), (0, 1, 1)),
                 ((2, 8, 5, 6, 7), (8, 8, 3, 1, 1), (1, 1, 1), (1, 0, 0)),
                 ((1, 8, 16, 3, 4), (16, 8, 5, 1, 1), (8, 1, 1), (2, 0, 0)),
                 ((1, 16, 2, 7, 9), (16, 16, 1, 3, 3), (1, 2, 2), (0, 1, 1)),
                 ((1, 4, 2, 7, 7), (8, 4, 1, 1, 1), (1, 2, 2), (0, 0, 0)),
                 ((2, 40, 3, 5, 6), (64, 40, 3, 1, 1), (1, 1, 1), (1, 0, 0)))
# the kernel's largest gap to float64 on them, over the largest |dW|: fp32
# sums of at most a few thousand terms
WGRAD3D_SMALL_TOL = 1e-5
# the cell whose convolutions the phase and ab_kernels.py --wgrad3d take:
# train_slowfast_r50's 32 clips of 32 x 224 x 224
WGRAD3D_CLIP = (32, 3, 32, 224, 224)


def conv3d_shapes(cfg=None, clip=WGRAD3D_CLIP):
    """Every distinct convolution of the backbone (``ConvBN3d``) of the
    recognizer ``cfg`` (``SLOWFAST_R50`` by default) at ``clip``'s input,
    in the order the forward meets them: name of its first module, X
    shape, weight shape, stride, padding, how many modules share it,
    whether ``conv3d_wgrad.narrow`` takes it and whether its weight
    gradient is routed to the kernel (``narrow`` and a ``plan`` for the
    shape, as ``takes`` asks on the card). Traced on the meta device:
    nothing is computed."""
    import torch
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.models.backbones.resnet3d import ConvBN3d
    from vfs_tpu_torch.ops import conv3d_wgrad
    with torch.device('meta'):
        model = build_model(dict(cfg or SLOWFAST_R50))
    shapes = {}

    def hook(name):
        def record(module, args, _):
            conv = module.conv
            key = (tuple(args[0].shape), tuple(conv.weight.shape),
                   tuple(conv.stride), tuple(conv.padding))
            if key not in shapes:
                narrow = conv3d_wgrad.narrow(conv, torch.float32)
                shapes[key] = dict(
                    name=name, x=key[0], weight=key[1], stride=key[2],
                    padding=key[3], modules=0, narrow=narrow,
                    routed=narrow and conv3d_wgrad.plan(*key) is not None)
            shapes[key]['modules'] += 1
        return record

    for name, module in model.backbone.named_modules():
        if isinstance(module, ConvBN3d):
            module.register_forward_hook(hook(name))
    with torch.device('meta'):
        model.backbone(torch.empty(clip))
    return list(shapes.values())


def wgrad3d_reached(size, out, k, s, p):
    """Input positions along one dimension that some output position's
    taps read (padding excluded)."""
    return len({o * s + d - p for o in range(out) for d in range(k)}
               & set(range(size)))


def wgrad3d_work(x_shape, w_shape, stride, padding):
    """FLOPs (2 a multiply-add) and bytes (fp32: the positions of X that
    some tap reads and dY, read once; dW written once) of one weight
    gradient."""
    from vfs_tpu_torch.ops.conv3d_wgrad import out_size
    n, cin, *sizes = x_shape
    cout, _, *kernel = w_shape
    out = [out_size(*a) for a in zip(sizes, kernel, stride, padding)]
    positions = n * int(np.prod(out))
    reached = n * cin * int(np.prod([
        wgrad3d_reached(z, o, k, st, p)
        for z, o, k, st, p in zip(sizes, out, kernel, stride, padding)]))
    dw = int(np.prod(w_shape))
    return 2.0 * positions * dw, 4.0 * (reached + positions * cout + dw)


def wgrad3d_inputs(x_shape, w_shape, stride, padding, dev, seed,
                   channels_last=True):
    """Seeded X and dY on ``dev`` (channels-last, as the training step
    keeps them, or NCDHW) and an empty weight in the same format."""
    import torch
    from vfs_tpu_torch.ops.conv3d_wgrad import out_size
    fmt = (torch.channels_last_3d if channels_last
           else torch.contiguous_format)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(x_shape, device=dev, generator=g)
    out = [out_size(*a) for a in zip(x_shape[2:], w_shape[2:], stride,
                                     padding)]
    dy = torch.randn((x_shape[0], w_shape[0], *out), device=dev, generator=g)
    w = torch.empty(w_shape, device=dev)
    return (x.contiguous(memory_format=fmt), dy.contiguous(memory_format=fmt),
            w.contiguous(memory_format=fmt))


def wgrad3d_gap(got, exact):
    """The largest |got - exact| over the largest |exact|."""
    return float((got.double() - exact).abs().max() / exact.abs().max())


def phase_wgrad3d(dev, smi_line):
    """The narrow weight-gradient kernel (module docstring, phase 4c): the
    small cases against float64, then each convolution of
    train_slowfast_r50 whose weight gradient ``conv3d_wgrad.narrow``
    routes to it, at the cell's shapes: the kernel's time, the plain
    version's, cuDNN's ``conv3d_weight`` (``library_ms``, TF32 off) and the
    bound; the kernel's, cuDNN's and the plain version's largest gap to
    float64; two runs bit for bit; the launch count and the program
    counter moved by one launch. Then a ``ConvBN3d`` step on the card
    through the routing, and the cell's own step (``slowfast_step``):
    one launch a routed module. Returns the kernels line's entry, its
    ``launches`` those of that step."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.models.backbones.resnet3d import ConvBN3d
    from vfs_tpu_torch.ops import conv3d_wgrad as cw
    from vfs_tpu_torch.utils import trace
    t0 = time.time()
    small = []
    with exact_fp32():
        for i, (xs, ws, st, pad) in enumerate(WGRAD3D_SMALL):
            for channels_last in (False, True):
                x, dy, w = wgrad3d_inputs(xs, ws, st, pad, dev, i,
                                          channels_last)
                exact = torch.nn.grad.conv3d_weight(x.double(), ws,
                                                    dy.double(), st, pad)
                got = cw.conv3d_weight_cuda(x, dy, w, st, pad)
                gap = wgrad3d_gap(got, exact)
                small.append([xs, ws, st, pad, channels_last, gap,
                              got.stride() == w.stride()])
                if gap > WGRAD3D_SMALL_TOL or got.stride() != w.stride():
                    raise AssertionError(f'narrow wgrad3d: {small[-1]}')
        shapes, failed = {}, []
        for k, c in enumerate(s for s in conv3d_shapes()
                              if s['routed']):
            xs, ws, st, pad = c['x'], c['weight'], c['stride'], c['padding']
            x, dy, w = wgrad3d_inputs(xs, ws, st, pad, dev, 100 + k)
            first = cw.conv3d_weight_cuda(x, dy, w, st, pad)
            second = cw.conv3d_weight_cuda(x, dy, w, st, pad)
            same = bool(torch.equal(first.view(torch.int32),
                                    second.view(torch.int32)))
            before = cw.conv3d_weight_cuda.launches
            with trace.recording() as rec:
                counted = cw.conv3d_weight(x, dy, w, st, pad)
            moved = dict(launches=cw.conv3d_weight_cuda.launches - before,
                         counter=rec.counts.get(cw.TRACE_COUNT, 0))
            library = torch.nn.grad.conv3d_weight(x, ws, dy, st, pad)
            plain = cw.conv3d_weight_reference(x, dy, w, st, pad)
            exact = torch.nn.grad.conv3d_weight(x.double(), ws, dy.double(),
                                                st, pad)
            flops, nbytes = wgrad3d_work(xs, ws, st, pad)
            bound, bound_by = bound_ms(flops, nbytes, smi_line)
            kernel_ms = cuda_ms(lambda: cw.conv3d_weight_cuda(x, dy, w, st,
                                                              pad))
            entry = dict(
                x=xs, weight=ws, stride=st, padding=pad,
                modules=c['modules'], kernel_ms=kernel_ms,
                plain_ms=cuda_ms(lambda: cw.conv3d_weight_reference(
                    x, dy, w, st, pad), runs=3),
                library_ms=cuda_ms(lambda: torch.nn.grad.conv3d_weight(
                    x, ws, dy, st, pad), runs=3),
                bound_ms=bound, bound_by=bound_by,
                share_of_bound=bound / kernel_ms,
                gap_to_fp64=wgrad3d_gap(first, exact),
                library_gap_to_fp64=wgrad3d_gap(library, exact),
                plain_gap_to_fp64=wgrad3d_gap(plain, exact),
                bit_identical=same and bool(torch.equal(first, counted)),
                strides_kept=first.stride() == w.stride(), **moved)
            shapes[c['name']] = entry
            if not (entry['bit_identical'] and entry['strides_kept']
                    and moved == dict(launches=1, counter=1)
                    and entry['gap_to_fp64']
                    <= entry['library_gap_to_fp64']):
                failed.append(c['name'])
            del x, dy, w, first, second, counted, library, plain, exact
            torch.cuda.empty_cache()
        # the routing: a ConvBN3d's step on the card takes the kernel, its
        # gradient as cuDNN's within the fp32 rounding
        block = ConvBN3d(8, 8, (1, 3, 3)).to(dev).to(
            memory_format=torch.channels_last_3d)
        x = torch.randn((2, 8, 4, 28, 28), device=dev).contiguous(
            memory_format=torch.channels_last_3d)
        before = cw.conv3d_weight_cuda.launches
        block(x).square().sum().backward()
        routed = cw.conv3d_weight_cuda.launches - before
        grad = block.conv.weight.grad.clone()
        block.conv.weight.grad = None
        block.bn(block.conv(x)).relu().square().sum().backward()
        convbn = dict(launches=routed,
                      gap_to_cudnn=float((grad - block.conv.weight.grad)
                                         .abs().max()
                                         / block.conv.weight.grad.abs().max()))
        del block, x, grad
        step = slowfast_step(dev)
    emit({'phase': 'wgrad3d', 'card': smi_line,
          'columns': ['x', 'weight', 'stride', 'padding', 'channels_last',
                      'gap_to_fp64', 'strides_kept'],
          'small': small, 'shapes': shapes, 'convbn3d': convbn,
          'train_slowfast_r50_step': step, 'seconds': time.time() - t0})
    if failed:
        raise AssertionError(f'narrow wgrad3d: {failed} fail (shapes above)')
    if routed != 1 or convbn['gap_to_cudnn'] > WGRAD3D_SMALL_TOL:
        raise AssertionError(f'ConvBN3d routing: {convbn}')
    if not step['launches'] == step['counter'] == step['routed_modules']:
        raise AssertionError(f'train_slowfast_r50 step: {step}')
    return dict(name='narrow_wgrad3d', route='cuda',
                source='vfs_tpu_torch/csrc/conv3d_wgrad.cu',
                replaces=None, launches=step['launches'],
                launches_of='one train_slowfast_r50 step (phase 4c)',
                shapes=shapes)


def slowfast_step(dev):
    """One full-width step of train_slowfast_r50's model (``SLOWFAST_R50``,
    seeded), optimizer (SGD lr 0.1, momentum 0.9, weight decay 1e-4) and
    batch (32 clips of 32 x 224 x 224, ``WGRAD3D_CLIP``) through
    ``make_train_step``, after one step to warm up, with the kernel's
    launch count set to 0 just before it and a trace recording over it:
    the launches, the program counter ``conv3d.narrow_wgrad``, the
    modules the rule routes (``conv3d_shapes``) and the step's ms on the
    host clock."""
    import torch
    from vfs_tpu_torch.apis.train import make_train_step
    from vfs_tpu_torch.core.optimizer import build_optimizer
    from vfs_tpu_torch.ops import conv3d_wgrad as cw
    from vfs_tpu_torch.utils import trace
    routed = sum(c['modules'] for c in conv3d_shapes() if c['routed'])
    model = seeded_recognizer(dict(SLOWFAST_R50), dev).train()
    optimizer, _ = build_optimizer(model.parameters(), dict(
        type='SGD', lr=0.1, momentum=0.9, weight_decay=1e-4))
    step = make_train_step(model, optimizer)
    n, c, t, h, w = WGRAD3D_CLIP
    g = torch.Generator(device=dev).manual_seed(0)
    imgs = torch.randn((n, 1, t, h, w, c), device=dev, generator=g)
    labels = torch.arange(n, device=dev) % 400
    step(imgs, None, labels)
    torch.cuda.synchronize()
    cw.conv3d_weight_cuda.launches = 0
    t0 = time.perf_counter()
    with trace.recording() as rec:
        step(imgs, None, labels)
        torch.cuda.synchronize()
    out = dict(launches=cw.conv3d_weight_cuda.launches,
               counter=rec.counts.get(cw.TRACE_COUNT, 0),
               routed_modules=routed,
               step_ms=(time.perf_counter() - t0) * 1e3)
    del model, optimizer, step, imgs, labels
    torch.cuda.empty_cache()
    return out


def phase_wide(dev, smi_name):
    """Slice 14's wide kernel (module docstring, phase 4b): small shapes,
    the r18 full-width wide shapes and the forced core-size check, then
    ``forward_test`` at neighbor_range 80. Returns the kernels line's
    entries: rows 1-4's wide paths with their launches on their paths
    (row 1 the tiled run's, row 2 the v1 engine's, row 3 the scan's, row 4
    its op entry's) and the full-width numbers (radius 40 / top-10 as the
    entry's, radius 12 / top-48 beside)."""
    import torch

    def tensor(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=dev)

    wide_small(dev, tensor)
    rows, row4_launches = wide_full(dev, smi_name)
    launches = wide_forward(dev)
    launches[4] = row4_launches
    names = {1: ('video_topk_affinity_wide', KERNEL_INFO),
             2: ('video_topk_affinity_v1_wide', V1_INFO),
             3: ('local_topk_attend_wide', LOCAL_INFO),
             4: ('local_topk_attend_v2_wide', V2_INFO)}
    entries = []
    main_key = f'radius{WIDE_FULL[0][0]:g}_top{WIDE_FULL[0][1]}'
    for row, (name, info) in names.items():
        if not launches.get(row):
            raise AssertionError(f'{name}: no launch on its path')
        nums = dict(rows[row])
        first = nums.pop(main_key)
        entries.append(dict(name=name, **WIDE_INFO,
                            replaces=info['replaces'],
                            launches=launches[row], **first, **nums))
    return entries


def synthetic_video(t_total=48, h=480, w=854, seed=0):
    """uint8 (T, H, W, 3) textured background with two coloured objects
    moving across it, and their (T, H, W) label maps."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 90, (h // 8, w // 8, 3)).astype(np.uint8)
    base = np.repeat(np.repeat(base, 8, 0), 8, 1)
    base = np.pad(base, ((0, h - base.shape[0]), (0, w - base.shape[1]),
                         (0, 0)), mode='edge')
    imgs = np.empty((t_total, h, w, 3), np.uint8)
    labels = np.zeros((t_total, h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for t in range(t_total):
        img = base.copy()
        cy, cx = 160 + 2 * t, 200 + 5 * t  # a disc moving right and down
        disc = (yy - cy)**2 + (xx - cx)**2 < 70**2
        img[disc] = [220, 50, 40]
        labels[t][disc] = 1
        y2, x2 = 300, 620 - 4 * t          # a box moving left
        box = (slice(y2, y2 + 110), slice(x2, x2 + 130))
        img[box] = [40, 200, 70]
        labels[t][box] = 2
        imgs[t] = img
    return imgs, labels


def phase_main(dev, smi_name):
    import runpy
    import torch
    from vfs_tpu_torch.core.evaluation import (aggregate_metrics,
                                               evaluate_semisupervised)
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.models.trackers.vanilla_tracker import (
        decode_predictions, make_propagation_config)
    from vfs_tpu_torch.ops import (l2_normalize, propagate_labels,
                                   video_topk_affinity,
                                   video_topk_affinity_cuda,
                                   video_topk_affinity_reference)

    cfg = runpy.run_path(CONFIG)
    test_cfg = dict(cfg['test_cfg'])
    model = build_model(dict(type='VanillaTracker',
                             backbone=dict(cfg['model']['backbone'])),
                        test_cfg=test_cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    imgs, gt = synthetic_video()
    t_total = imgs.shape[0]
    meta = [dict(original_shape=imgs.shape[1:3],
                 img_norm_cfg=dict(cfg['img_norm_cfg']))]

    # the main path, counted
    video_topk_affinity_cuda.launches = 0
    t0 = time.time()
    preds = model.forward_test(imgs, gt[0], meta)[0]
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = video_topk_affinity_cuda.launches
    if launches < 1:
        raise AssertionError('the main path did not launch the kernel')
    if preds.shape != gt.shape or preds.dtype != np.uint8 \
            or preds.max() > 2:
        raise AssertionError(f'bad predictions {preds.shape} {preds.dtype}')

    # end to end, warm
    t0 = time.time()
    model.forward_test(imgs, gt[0], meta)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0

    # per stage, warm, on the card
    imgs_dev = torch.as_tensor(imgs, device=dev)
    norm = meta[0]['img_norm_cfg']
    mean = torch.tensor(norm['mean'], dtype=torch.float32, device=dev)
    std = torch.tensor(norm['std'], dtype=torch.float32, device=dev)
    batch_step = int(test_cfg.get('batch_step', 20))
    extract_ms = cuda_ms(lambda: model._extract_feats(
        imgs_dev, batch_step, mean, std))
    feats = model._extract_feats(imgs_dev, batch_step, mean, std)[0]
    h, w = feats.shape[1:3]
    pcfg, _ = make_propagation_config(test_cfg, h, w)
    radius = float(pcfg.neighbor_range // 2)
    feats_n = l2_normalize(feats).contiguous()

    def affinity(fn):
        return fn(feats_n, radius, pcfg.temperature, pcfg.topk,
                  pcfg.precede_frames)

    from vfs_tpu_torch.ops.resize import pil_nearest_resize
    resized = pil_nearest_resize(gt[0].astype(np.float32),
                                 (h, w)).astype(np.int64)
    seg_first = torch.as_tensor(np.eye(4, dtype=np.float32)[resized],
                                device=dev)
    class_valid = torch.as_tensor(np.arange(4) < 3, device=dev)

    with exact_fp32():
        out_k = affinity(video_topk_affinity)
        out_p = affinity(video_topk_affinity_reference)
        err, mismatch, _ = compare((out_k[0][1:], out_k[1][1:]),
                                   (out_p[0][1:], out_p[1][1:]), False,
                                   'main path affinity')
        affinity_ms = cuda_ms(lambda: affinity(video_topk_affinity_cuda))
        plain_ms = cuda_ms(lambda: affinity(video_topk_affinity_reference))

        def gather_decode(out):
            logits = propagate_labels(out[0], out[1], seg_first)
            return decode_predictions(logits, gt.shape[1:], class_valid)

        decode_ms = cuda_ms(lambda: gather_decode(out_k))
        preds_plain = gather_decode(out_p).cpu().numpy()
    preds_plain[0] = gt[0]
    mask_agree = float((preds_plain == preds).mean())
    if mask_agree < 0.999:
        raise AssertionError(f'masks agree on {mask_agree} < 0.999 with the '
                             'plain phase 1')
    metrics = aggregate_metrics({'synthetic': evaluate_semisupervised(
        gt.astype(np.int64), preds.astype(np.int64))})
    jf = (np.mean(metrics['J']['M']) + np.mean(metrics['F']['M'])) / 2
    if not 0.0 <= jf <= 1.0:
        raise AssertionError(f'J&F {jf} out of range')

    c = feats.shape[-1]
    flops, nbytes = affinity_work(t_total, h, w, c, radius, pcfg.topk,
                                  pcfg.precede_frames)
    b_ms, b_by = bound_ms(flops, nbytes, smi_name)
    demo = run_demo(dev, imgs[:DEMO_FRAMES], gt[0], meta)
    launches += demo['demo_launches']
    emit({'phase': 'main', 'video': list(imgs.shape), 'features':
          list(feats.shape), 'first_call_s': first_s,
          'e2e_fps': t_total / e2e_s, 'e2e_ms_per_frame': e2e_s * 1e3
          / t_total, 'extract_ms_per_frame': extract_ms / t_total,
          'affinity_ms_per_frame': affinity_ms / (t_total - 1),
          'gather_decode_ms_per_frame': decode_ms / t_total,
          'mask_agree_plain': mask_agree, 'jf_synthetic': float(jf),
          'kernel_launches': launches, **demo})
    return [dict(
        **KERNEL_INFO, launches=launches, max_abs_err=err,
        src_mismatch=mismatch, ms=affinity_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / affinity_ms,
        library_ms=None, library_note=NO_LIBRARY_CALL)]


def run_demo(dev, imgs, first_mask, meta):
    """Slice 11's demo (module docstring, phase 4) on ``imgs``, the main
    path's first frames: ``tools.demo.propagate`` on the card with the r18
    config and its seeded weights as a ``.pth``, counted, against
    ``forward_test`` of a tracker carrying the same weights (equal masks);
    then ``tools.demo.main`` end to end where this cv2 writes mp4v.
    Returns the line's fields; ``demo_launches`` are row 1's."""
    import cv2
    import torch
    from PIL import Image
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.ops import video_topk_affinity_cuda
    from vfs_tpu_torch.tools import demo
    from vfs_tpu_torch.utils import Config

    cfg = Config.fromfile(CONFIG)
    t_total, h, w = imgs.shape[:3]
    out = {}
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        ckpt = write_backbone(CONFIG, os.path.join(root, 'r18.pth'))
        video_topk_affinity_cuda.launches = 0
        t0 = time.time()
        frames_rs, preds = demo.propagate(list(imgs), first_mask, cfg, ckpt,
                                          h, device=dev)
        torch.cuda.synchronize()
        out['demo_propagate_s'] = time.time() - t0
        launches = video_topk_affinity_cuda.launches
        if launches < 1:
            raise AssertionError('the demo did not launch row 1')
        model_cfg = dict(type='VanillaTracker',
                         backbone=dict(cfg.model.backbone, pretrained=ckpt))
        model = build_model(model_cfg, test_cfg=cfg.test_cfg)
        model.init_weights()
        ref = model.forward_test(imgs, first_mask, meta, device=dev)[0]
        if not np.array_equal(preds, ref):
            raise AssertionError('demo masks differ from forward_test on '
                                 f'{float((preds != ref).mean())} of pixels')
        out.update(demo_frames=t_total, demo_hw=[h, w],
                   demo_fps=t_total / out['demo_propagate_s'])

        src = os.path.join(root, 'in.mp4')
        writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*'mp4v'), 24,
                                 (w, h))
        if not writer.isOpened():
            out['demo_mp4'] = 'unavailable'
            return dict(out, demo_launches=launches)
        for img in imgs:
            writer.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        writer.release()
        mask_png = os.path.join(root, 'mask.png')
        Image.fromarray(first_mask).save(mask_png)
        dst = os.path.join(root, 'out.mp4')
        video_topk_affinity_cuda.launches = 0
        t0 = time.time()
        demo.main([CONFIG, ckpt, src, mask_png, dst, '--device', str(dev)])
        out['demo_main_s'] = time.time() - t0
        launches += video_topk_affinity_cuda.launches
        cap = cv2.VideoCapture(dst)
        written = 0
        while cap.read()[0]:
            written += 1
        cap.release()
        if written != t_total:
            raise AssertionError(f'demo wrote {written} of {t_total} frames')
        out['demo_mp4'] = 'written'
    return dict(out, demo_launches=launches)


def write_davis(root, n_videos=2, t_total=48):
    """A DAVIS-layout dataset of synthetic videos under ``root``: JPEG
    frames, palette-PNG annotations and two list files (every video; the
    first alone). Video v uses ``synthetic_video(seed=v)``, mirrored for
    odd v so the objects move the other way."""
    from PIL import Image
    from vfs_tpu_torch.datasets.davis_dataset import PALETTE
    img_root = os.path.join(root, 'JPEGImages', '480p')
    ann_root = os.path.join(root, 'Annotations', '480p')
    palette = np.asarray(PALETTE, np.uint8).ravel()
    lines = []
    for v in range(n_videos):
        imgs, labels = synthetic_video(t_total, seed=v)
        if v % 2:
            imgs, labels = imgs[:, :, ::-1], labels[:, :, ::-1]
        name = f'video{v}'
        os.makedirs(os.path.join(img_root, name))
        os.makedirs(os.path.join(ann_root, name))
        for t in range(t_total):
            Image.fromarray(np.ascontiguousarray(imgs[t])).save(
                os.path.join(img_root, name, f'{t:05}.jpg'), quality=95)
            ann = Image.fromarray(np.ascontiguousarray(labels[t]))
            ann.putpalette(palette)
            ann.save(os.path.join(ann_root, name, f'{t:05}.png'))
        lines.append(f'{name} {t_total} 0\n')
    lists = []
    for fname, chosen in (('val_list.txt', lines), ('val_one.txt', lines[:1])):
        lists.append(os.path.join(root, fname))
        with open(lists[-1], 'w') as f:
            f.writelines(chosen)
    return img_root, ann_root, lists, labels.shape


@contextlib.contextmanager
def patched(owner, attr, make):
    """Replace ``owner.attr`` by ``make(original)`` inside the block."""
    original = getattr(owner, attr)
    setattr(owner, attr, make(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def wall_timer(walls):
    """``patched`` maker: append each call's wall seconds, the card's queue
    drained before and after, to ``walls``."""
    import torch

    def make(fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            return out
        return timed
    return make


def span_timer(spans):
    """``patched`` maker: record a pair of CUDA events around each call on
    the current stream into ``spans``; ``spans_ms`` sums them."""
    import torch

    def make(fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((start, end))
            return out
        return timed
    return make


def spans_ms(spans):
    import torch
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in spans)


def write_eval_inputs(root, n_videos=2):
    """The eval path's inputs under ``root``: ``write_davis``'s dataset of
    ``n_videos`` and the r50 backbone of CONFIG_R50 with seeded random
    weights, saved as a torchvision-layout ``.pth``. Returns
    ``write_davis``'s values and the checkpoint's path."""
    data = write_davis(root, n_videos=n_videos)
    return (*data, write_backbone(CONFIG_R50, os.path.join(root, 'r50.pth')))


def write_backbone(config, path, randomize_bn=False):
    """The backbone of ``config`` with seeded random weights (seed 0),
    saved at ``path`` as a torchvision-layout ``.pth``; returns ``path``.
    ``randomize_bn``: every BatchNorm's scale 1 + 0.1 N(0, 1) and shift
    0.1 N(0, 1) (seed 1), so that a residual block whose last scale the
    init zeroes is not the identity."""
    import runpy
    import torch
    from vfs_tpu_torch.models.backbones import ResNet
    backbone_cfg = dict(runpy.run_path(config)['model']['backbone'])
    backbone_cfg.pop('type')
    backbone = ResNet(**backbone_cfg)
    backbone.init_weights(torch.Generator().manual_seed(0))
    if randomize_bn:
        generator = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for m in backbone.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.weight.copy_(1 + 0.1 * torch.randn(
                        m.weight.shape, generator=generator))
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape,
                                                   generator=generator))
    torch.save(backbone.state_dict(), path)
    return path


def eval_argv(root, img_root, ann_root, ann_file, ckpt, backend, out):
    """``python -m vfs_tpu_torch.tools.test``'s arguments for the eval path
    on ``write_eval_inputs``'s dataset."""
    return [CONFIG_R50, ckpt, '--eval', 'davis', '--out', out,
            '--options', f'test_cfg.backend={backend}',
            f'data.test.ann_file={ann_file}',
            f'data.test.data_prefix={img_root}',
            f'data.test.anno_prefix={ann_root}',
            f'data.test.data_root={root}']


# the eval phase's videos (two until the all-blocks phase took the other)
EVAL_VIDEOS = 1


def phase_eval(local_full):
    """Slice 2's path: ``python -m vfs_tpu_torch.tools.test`` on the r50
    config with ``backend=pallas``, run in-process. The counted run also
    times its stages with CUDA events around ``_extract_feats`` and
    ``propagate_video``. Returns the kernels line's entry of
    ``local_topk_attend``."""
    import vfs_tpu_torch.apis as apis
    from vfs_tpu_torch.models.trackers import vanilla_tracker
    from vfs_tpu_torch.ops import (local_topk_attend_cuda,
                                   local_topk_attend_reference, propagation)
    from vfs_tpu_torch.tools import test as tools_test

    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        (img_root, ann_root, (list_all, list_one), shape,
         ckpt) = write_eval_inputs(root, EVAL_VIDEOS)

        def run(backend, ann_file, name, options=()):
            out = os.path.join(root, f'{name}.npz')
            jf = tools_test.main(eval_argv(root, img_root, ann_root,
                                           ann_file, ckpt, backend, out)
                                 + list(options))
            with np.load(out) as saved:
                masks = [saved[f'arr_{i}'] for i in range(len(saved.files))]
            return jf, masks

        walls, extract_spans, scan_spans = [], [], []
        with patched(apis, 'single_process_test', wall_timer(walls)):
            run('pallas', list_all, 'cold')
            first_s = walls[-1]
            # the path, counted and timed per stage
            local_topk_attend_cuda.launches = 0
            with patched(vanilla_tracker.VanillaTracker, '_extract_feats',
                         span_timer(extract_spans)), \
                    patched(vanilla_tracker, 'propagate_video',
                            span_timer(scan_spans)):
                jf, masks = run('pallas', list_all, 'scan')
            launches = local_topk_attend_cuda.launches
            eval_s = walls[-1]
            extract_ms, scan_ms = spans_ms(extract_spans), spans_ms(scan_spans)
            _, masks_video = run('pallas_video', list_all, 'video')
            with patched(propagation, 'local_topk_attend',
                         lambda _: local_topk_attend_reference):
                _, masks_plain = run('pallas', list_one, 'plain')
            # row 3's inexact modes through the same CLI, counted
            modes = {}
            for name, option, counter in (
                    ('packed', 'test_cfg.pallas_extract=packed',
                     'packed_launches'),
                    ('scores_bf16', 'test_cfg.pallas_scores=bfloat16',
                     'scores_bf16_launches')):
                setattr(local_topk_attend_cuda, counter, 0)
                jf_mode, masks_mode = run('pallas', list_all, name, [option])
                modes[name] = dict(
                    option=option,
                    launches=getattr(local_topk_attend_cuda, counter),
                    eval_s=walls[-1],
                    mask_agree_exact=float(np.mean([
                        (a == b).mean() for a, b in zip(masks, masks_mode)])),
                    **{k: float(v) for k, v in jf_mode.items()})

        frames = sum(m.shape[0] for m in masks)
        steps = sum(m.shape[0] - 1 for m in masks)
        if launches < steps or steps < EVAL_VIDEOS * (shape[0] - 1):
            raise AssertionError(f'{launches} scan-kernel launches for '
                                 f'{steps} steps')
        for m in masks:
            if m.shape != shape or m.dtype != np.uint8 or m.max() > 2:
                raise AssertionError(f'bad masks {m.shape} {m.dtype}')
        agree_video = float(np.mean([(a == b).mean()
                                     for a, b in zip(masks, masks_video)]))
        agree_plain = float((masks[0] == masks_plain[0]).mean())
        if agree_video < 0.999 or agree_plain < 0.999:
            raise AssertionError(
                f'masks agree on {agree_video} (pallas_video) and '
                f'{agree_plain} (plain per-step) < 0.999')
        if not 0.0 <= jf['J&F-Mean'] <= 1.0:
            raise AssertionError(f"J&F {jf['J&F-Mean']} out of range")
        for name, mode in modes.items():
            floor = MODE_AGREEMENT['pallas_' + ('packed' if name == 'packed'
                                                else 'bf16')]
            if mode['launches'] != steps or mode['mask_agree_exact'] < floor:
                raise AssertionError(f'{name} eval: {mode["launches"]} '
                                     f'launches for {steps} steps, masks '
                                     f'agree with the exact run on '
                                     f"{mode['mask_agree_exact']} < {floor}")
    emit({'phase': 'eval', 'config': os.path.relpath(CONFIG_R50, ROOT),
          'backend': 'pallas', 'videos': len(masks), 'frames': frames,
          'first_call_s': first_s, 'eval_s': eval_s,
          'eval_fps': frames / eval_s,
          'extract_ms_per_frame': extract_ms / frames,
          'scan_ms_per_frame': scan_ms / steps,
          'mask_agree_pallas_video': agree_video,
          'mask_agree_plain_per_step': agree_plain,
          'kernel_launches': launches, 'steps': steps,
          **{k: float(v) for k, v in jf.items()}, 'modes': modes})
    return modes, dict(**LOCAL_INFO, launches=launches,
                max_abs_err=local_full['max_abs_err'],
                src_mismatch=local_full['src_mismatch'],
                ms=local_full['kernel_ms_per_step'],
                plain_ms=local_full['plain_ms_per_step'],
                bound_ms=local_full['bound_ms_per_step'],
                bound_by=local_full['bound_by'],
                bound_share=local_full['bound_share'], library_ms=None,
                library_note=NO_LIBRARY_CALL)


# the all-blocks eval (module docstring, phase 5b): r50's layer3 blocks
ALL_BLOCKS_R50 = 6


def layer3_blocks(ckpt, imgs, batch_step, mean, std):
    """The outputs of the plain r50 ``ResNet``'s ``layer3[j]``, taken with
    forward hooks over ``imgs`` in ``batch_step`` chunks as
    ``VanillaTracker._extract_feats`` runs it: one (T, h, w, 1024) fp32
    bank a block."""
    import runpy
    import torch
    from vfs_tpu_torch.models import build_model
    cfg = runpy.run_path(CONFIG_R50)
    tracker = build_model(dict(type='VanillaTracker',
                               backbone=dict(cfg['model']['backbone'])),
                          test_cfg=dict(cfg['test_cfg']))
    tracker.load_weights(ckpt)
    blocks = list(tracker.backbone.layer3)
    parts = [[] for _ in blocks]
    hooks = [b.register_forward_hook(
        lambda m, args, out, j=j: parts[j].append(
            out.permute(0, 2, 3, 1).to(torch.float32)))
        for j, b in enumerate(blocks)]
    try:
        tracker._extract_feats(imgs, batch_step, mean, std)
    finally:
        for h in hooks:
            h.remove()
    return [torch.cat(p) for p in parts]


def phase_all_blocks(dev, smi_line):
    """The all-blocks eval (module docstring, phase 5b): ``tools.test`` on
    the r50 config with ``test_cfg.all_blocks=True`` on one synthetic
    video. Returns the launches of video_topk_affinity on it."""
    import torch
    import vfs_tpu_torch.apis as apis
    from vfs_tpu_torch.models.trackers import vanilla_tracker
    from vfs_tpu_torch.ops import propagation, video_topk_affinity_cuda
    from vfs_tpu_torch.tools import test as tools_test

    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        img_root, ann_root, (list_one, _), shape = write_davis(
            root, n_videos=1)
        # the eval phase's seeded weights, BatchNorm scales drawn: with
        # each Bottleneck's zero-initialised bn3 scale, layer3's blocks 1-5
        # would be identities and their masks those of block 0
        ckpt = write_backbone(CONFIG_R50, os.path.join(root, 'r50.pth'),
                              randomize_bn=True)

        def run(name, options=()):
            out = os.path.join(root, f'{name}.npz')
            jf = tools_test.main([
                CONFIG_R50, ckpt, '--eval', 'davis', '--out', out,
                '--options', f'data.test.ann_file={list_one}',
                f'data.test.data_prefix={img_root}',
                f'data.test.anno_prefix={ann_root}',
                f'data.test.data_root={root}', *options])
            with np.load(out) as saved:
                return jf, saved['arr_0']

        blockwise = ['test_cfg.all_blocks=True']
        walls, extract_spans, propagate_spans, seen = [], [], [], []

        def keep_feats(fn):
            timed = span_timer(extract_spans)(fn)

            def kept(self, imgs, batch_step, mean=None, std=None, *args,
                     **kwargs):
                banks = timed(self, imgs, batch_step, mean, std, *args,
                              **kwargs)
                seen.append((imgs, batch_step, mean, std, banks))
                return banks
            return kept

        # the path, counted, timed per stage; the peak memory of the run
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        video_topk_affinity_cuda.launches = 0
        with patched(apis, 'single_process_test', wall_timer(walls)), \
                patched(vanilla_tracker.VanillaTracker, '_extract_feats',
                        keep_feats), \
                patched(vanilla_tracker.VanillaTracker, '_propagate_decode',
                        span_timer(propagate_spans)):
            jf, masks = run('all_blocks', blockwise)
        launches = video_topk_affinity_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        eval_s = walls[-1]
        extract_ms = spans_ms(extract_spans)
        propagate_ms = spans_ms(propagate_spans)

        # the six banks against the plain ResNet's layer3 blocks
        imgs, batch_step, mean, std, banks = seen[-1]
        plain_banks = layer3_blocks(ckpt, imgs, batch_step, mean, std)
        bit_equal = [bool(torch.equal(a, b))
                     for a, b in zip(banks, plain_banks)]
        feat_err = [float((a - b).abs().max()) for a, b in
                    zip(banks, plain_banks)]
        close = [bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5))
                 for a, b in zip(banks, plain_banks)]
        del seen, banks, plain_banks, imgs
        torch.cuda.empty_cache()

        # what the tracker's synchronous per-block readback costs: one
        # block's masks from the card, CUDA events around the copy
        on_card = torch.as_tensor(masks[-1], device=dev)
        readback_ms = cuda_ms(lambda: on_card.cpu())
        del on_card

        _, masks_std = run('standard')
        with patched(propagation, 'video_topk_affinity', plain_phase1):
            _, masks_plain = run('plain', blockwise)

    blocks = ALL_BLOCKS_R50
    keys = [f'feat_{i}.J&F-Mean' for i in range(blocks)]
    agree_plain = [float((a == b).mean()) for a, b in zip(masks, masks_plain)]
    if launches != blocks:
        raise AssertionError(f'all_blocks: {launches} row-1 launches for '
                             f'one video (want {blocks})')
    if masks.shape != (blocks, *shape) or masks.dtype != np.uint8:
        raise AssertionError(f'all_blocks masks {masks.shape} {masks.dtype}')
    if not all(close):
        raise AssertionError(f'all_blocks banks against the ResNet layer3 '
                             f'blocks: largest differences {feat_err}')
    if not np.array_equal(masks[-1], masks_std):
        raise AssertionError('all_blocks: the last block masks differ from '
                             'the standard eval masks')
    if min(agree_plain) < 0.999:
        raise AssertionError(f'all_blocks masks agree with a plain-phase-1 '
                             f'run on {agree_plain} < 0.999')
    if not set(keys) <= set(jf) or not all(0.0 <= jf[k] <= 1.0
                                           for k in keys):
        raise AssertionError(f'all_blocks results {sorted(jf)}')
    frames = shape[0]
    emit({'phase': 'all_blocks', 'card': smi_line,
          'config': os.path.relpath(CONFIG_R50, ROOT),
          'option': 'test_cfg.all_blocks=True', 'videos': 1,
          'frames': frames, 'blocks': blocks, 'eval_s': eval_s,
          'eval_fps': frames / eval_s,
          'extract_ms_per_frame': extract_ms / frames,
          'propagate_ms_per_frame': propagate_ms / frames,
          'readback_ms_per_block': readback_ms,
          'readback_ms_per_frame': readback_ms * blocks / frames,
          'max_memory_allocated_gb': peak / 2**30,
          'layer3_bit_equal': bit_equal, 'layer3_max_abs_err': feat_err,
          'mask_agree_plain_phase1': agree_plain,
          'last_block_equals_standard': True, 'kernel_launches': launches,
          **{k: float(jf[k]) for k in keys}})
    return launches


def blocky_background(h, w, rng):
    """uint8 (h, w, 3) background of random 8x8 blocks in 0..89."""
    base = rng.randint(0, 90, (-(-h // 8), -(-w // 8), 3)).astype(np.uint8)
    return np.repeat(np.repeat(base, 8, 0), 8, 1)[:h, :w]


def class_colors(n):
    """n distinct bright RGB colours."""
    c = np.arange(n)
    return np.stack([(67 * c) % 200 + 40, (131 * c + 60) % 200 + 40,
                     (29 * c + 100) % 200 + 40], 1).astype(np.uint8)


# a standing figure's 15 joints (x, y) around its centre: head, neck,
# shoulders, elbows, wrists, belly, hips, knees, ankles
JOINTS = np.array([[0, -60], [0, -45], [-18, -42], [18, -42], [-26, -20],
                   [26, -20], [-30, 0], [30, 0], [0, -10], [-12, 10],
                   [12, 10], [-14, 35], [14, 35], [-15, 60], [15, 60]],
                  np.float64)
SWINGING = np.array([4, 5, 6, 7, 11, 12, 13, 14])  # limbs: elbows .. ankles


def synthetic_pose_video(t_total=40, h=240, w=320, seed=0):
    """uint8 (T, h, w, 3) frames of a figure of 15 coloured joint discs
    walking across a blocky background (limbs swinging), and the joints
    (2, 15, T) as 0-indexed (x, y)."""
    rng = np.random.RandomState(100 + seed)
    base = blocky_background(h, w, rng)
    colors = class_colors(len(JOINTS) + 1)[1:]
    yy, xx = np.mgrid[:h, :w]
    imgs = np.empty((t_total, h, w, 3), np.uint8)
    pos = np.empty((2, len(JOINTS), t_total))
    for t in range(t_total):
        cx = 80 + 4 * t if seed % 2 == 0 else w - 80 - 4 * t
        cy = 120 + 6 * np.sin(t / 5)
        joints = JOINTS + [cx, cy]
        joints[SWINGING, 0] += 6 * np.sin(t / 4) * np.where(
            SWINGING % 2, 1, -1)
        img = base.copy()
        for j, (x, y) in enumerate(joints):
            img[(yy - y)**2 + (xx - x)**2 < 36] = colors[j]
        imgs[t] = img
        pos[:, :, t] = joints.T
    return imgs, pos


def write_lists(root, lines):
    """Two list files under ``root``: every video, and the first alone."""
    lists = []
    for fname, chosen in (('val_list.txt', lines), ('val_one.txt', lines[:1])):
        lists.append(os.path.join(root, fname))
        with open(lists[-1], 'w') as f:
            f.writelines(chosen)
    return lists


def write_jhmdb(root, n_videos=2, t_total=40):
    """A JHMDB-layout dataset under ``root``: PNG frames
    Frames/<class>/<video>/{t+1:05}.png, the joints in
    anno/joint_positions/<class>/<video>/joint_positions.mat ('pos_img'
    (2, 15, T), 1-indexed) and two list files. Returns the frame and
    annotation prefixes, the lists and a video's heatmap shape (T, 15,
    H, W)."""
    import scipy.io as sio
    from PIL import Image
    img_root = os.path.join(root, 'Frames')
    lines = []
    for v in range(n_videos):
        imgs, pos = synthetic_pose_video(t_total, seed=v)
        name = f'walk/video{v}'
        os.makedirs(os.path.join(img_root, name))
        pose_dir = os.path.join(root, 'anno', 'joint_positions', name)
        os.makedirs(pose_dir)
        for t in range(t_total):
            Image.fromarray(imgs[t]).save(
                os.path.join(img_root, name, f'{t + 1:05}.png'))
        sio.savemat(os.path.join(pose_dir, 'joint_positions.mat'),
                    {'pos_img': pos + 1})
        lines.append(f'{name} {t_total} 0\n')
    return (img_root, os.path.join(root, 'anno', 'Frames'),
            write_lists(root, lines), (t_total, len(JOINTS)) + imgs.shape[1:3])


def synthetic_parts_video(t_total=48, h=480, w=854, seed=0):
    """uint8 (T, h, w, 3) frames of a figure of 19 coloured part boxes (a
    4x5 grid less one cell, classes 1..19) moving across a blocky
    background, and their (T, h, w) label maps."""
    rng = np.random.RandomState(200 + seed)
    base = blocky_background(h, w, rng)
    colors = class_colors(20)
    cells = [(r, c) for r in range(5) for c in range(4)][1:]
    imgs = np.empty((t_total, h, w, 3), np.uint8)
    labels = np.zeros((t_total, h, w), np.uint8)
    for t in range(t_total):
        x0, y0 = 150 + 6 * t, 120 + 2 * t
        img, label = base.copy(), np.zeros((h, w), np.uint8)
        for cls, (r, c) in enumerate(cells, start=1):
            box = (slice(y0 + 36 * r, y0 + 36 * r + 34),
                   slice(x0 + 40 * c, x0 + 40 * c + 38))
            img[box] = colors[cls]
            label[box] = cls
        if seed % 2:  # the mirror image: the figure moves the other way
            img, label = img[:, ::-1], label[:, ::-1]
        imgs[t], labels[t] = img, label
    return imgs, labels


def write_vip(root, n_videos=2, t_total=48):
    """A VIP-layout dataset under ``root``: JPEG frames
    Images/<video>/{t:012}.jpg, palette-PNG part annotations
    Annotations/<video>/{t:012}.png and two list files. Returns the frame
    and annotation prefixes, the lists and a label map's shape."""
    from PIL import Image
    from vfs_tpu_torch.datasets.davis_dataset import PALETTE
    img_root = os.path.join(root, 'Images')
    ann_root = os.path.join(root, 'Annotations')
    palette = np.asarray(PALETTE, np.uint8).ravel()
    lines = []
    for v in range(n_videos):
        imgs, labels = synthetic_parts_video(t_total, seed=v)
        name = f'videos{v}'
        os.makedirs(os.path.join(img_root, name))
        os.makedirs(os.path.join(ann_root, name))
        for t in range(t_total):
            Image.fromarray(np.ascontiguousarray(imgs[t])).save(
                os.path.join(img_root, name, f'{t:012}.jpg'), quality=95)
            ann = Image.fromarray(np.ascontiguousarray(labels[t]))
            ann.putpalette(palette)
            ann.save(os.path.join(ann_root, name, f'{t:012}.png'))
        lines.append(f'{name} {t_total} 0\n')
    return img_root, ann_root, write_lists(root, lines), labels.shape


def slice3_argv(config, ckpt, metric, dataset, out, options):
    """``python -m vfs_tpu_torch.tools.test``'s arguments for a slice-3
    dataset (``dataset``: type and the ``data.test`` paths)."""
    return [config, ckpt, '--eval', metric, '--out', out, '--options',
            *[f'data.test.{k}={v}' for k, v in dataset.items()], *options]


def run_slice3_eval(config, ckpt, metric, dataset, out, options):
    """``python -m vfs_tpu_torch.tools.test`` in-process on a slice-3
    dataset; returns the metrics and the per-video results saved with
    ``--out``."""
    from vfs_tpu_torch.tools import test as tools_test
    metrics = tools_test.main(slice3_argv(config, ckpt, metric, dataset, out,
                                          options))
    with np.load(out) as saved:
        results = [saved[f'arr_{i}'] for i in range(len(saved.files))]
    return metrics, results


def counted_eval(run, options, ann_file, extract_spans, propagate_spans):
    """One counted, timed run of slice 3's path: ``video_topk_affinity_v1``'s
    count set to 0 just before and read just after, CUDA events around
    ``_extract_feats`` and ``propagate_video``. Returns ``run``'s value and
    the launches."""
    from vfs_tpu_torch.models.trackers import vanilla_tracker
    from vfs_tpu_torch.ops import video_topk_affinity_v1_cuda
    video_topk_affinity_v1_cuda.launches = 0
    with patched(vanilla_tracker.VanillaTracker, '_extract_feats',
                 span_timer(extract_spans)), \
            patched(vanilla_tracker, 'propagate_video',
                    span_timer(propagate_spans)):
        got = run(options, ann_file, 'counted')
    return got, video_topk_affinity_v1_cuda.launches


def plain_phase1(_):
    """``patched`` maker: the v1 engine's phase 1 replaced by the plain
    version."""
    from vfs_tpu_torch.ops import video_topk_affinity_reference

    def plain(feats, radius, temperature, topk, precede_frames, **_):
        return video_topk_affinity_reference(feats, radius, temperature,
                                             topk, precede_frames)
    return plain


def phase_pose():
    """Slice 3's JHMDB path (module docstring, phase 6). Returns the
    launches of video_topk_affinity_v1 on it."""
    import vfs_tpu_torch.apis as apis
    from vfs_tpu_torch.ops import propagation

    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        img_root, ann_root, (list_all, list_one), shape = write_jhmdb(root)
        ckpt = write_backbone(CONFIG, os.path.join(root, 'r18.pth'))

        def run(options, ann_file, name):
            dataset = dict(type='JHMDBDataset', ann_file=ann_file,
                           data_prefix=img_root, anno_prefix=ann_root,
                           data_root=root)
            return run_slice3_eval(CONFIG, ckpt, 'pck', dataset,
                                   os.path.join(root, f'{name}.npz'),
                                   options)

        v1 = ['test_cfg.video_engine=v1', 'test_cfg.video_extract=perframe']
        walls, extract_spans, propagate_spans = [], [], []
        with patched(apis, 'single_process_test', wall_timer(walls)):
            run(v1, list_all, 'cold')
            first_s = walls[-1]
            (pck, heat), launches = counted_eval(
                run, v1, list_all, extract_spans, propagate_spans)
            eval_s = walls[-1]
            extract_ms = spans_ms(extract_spans)
            propagate_ms = spans_ms(propagate_spans)
            # one eval takes about a second and single walls spread by tens
            # of percent: time a few more of the same path
            for _ in range(POSE_REPEATS):
                run(v1, list_all, 'repeat')
            repeat_fps = [sum(x.shape[0] for x in heat) / s
                          for s in [eval_s, *walls[-POSE_REPEATS:]]]
            pck_v2, heat_v2 = run(['test_cfg.video_engine=v2'], list_all,
                                  'v2')
            with patched(propagation, 'video_topk_affinity_v1',
                         plain_phase1):
                _, heat_plain = run(v1, list_one, 'plain')

    frames = sum(x.shape[0] for x in heat)
    if launches != len(heat):
        raise AssertionError(f'{launches} v1 launches for {len(heat)} '
                             'videos')
    for x in heat:
        if x.shape != shape or not np.isfinite(x).all():
            raise AssertionError(f'bad heatmaps {x.shape}')
    diff_v2 = max(float(np.abs(a - b).max()) for a, b in zip(heat, heat_v2))
    plain_diff = np.abs(heat[0] - heat_plain[0])
    within = float((plain_diff <= 1e-5).mean())
    if diff_v2 > 1e-5 or pck != pck_v2:
        raise AssertionError(f'v1 vs v2: heatmaps differ by {diff_v2}, PCK '
                             f'{pck} vs {pck_v2}')
    if within < 0.999:
        raise AssertionError(f'v1 vs plain phase 1: {within} of the heatmap '
                             'values within 1e-5 (< 0.999)')
    if not all(0.0 <= v <= 100.0 for v in pck.values()):
        raise AssertionError(f'PCK out of range: {pck}')
    emit({'phase': 'pose', 'config': os.path.relpath(CONFIG, ROOT),
          'dataset': 'JHMDBDataset', 'engine': 'v1', 'extract': 'perframe',
          'videos': len(heat), 'frames': frames, 'first_call_s': first_s,
          'eval_s': eval_s, 'eval_fps': frames / eval_s,
          'eval_fps_repeats': repeat_fps,
          'eval_fps_median': statistics.median(repeat_fps),
          'extract_ms_per_frame': extract_ms / frames,
          'propagate_ms_per_frame': propagate_ms / frames,
          'heatmap_max_abs_diff_v2': diff_v2,
          'heatmap_max_abs_diff_plain': float(plain_diff.max()),
          'heatmap_share_within_1e-5_plain': within,
          'kernel_launches': launches, **pck})
    return launches


def phase_vip():
    """Slice 3's VIP path (module docstring, phase 7). Returns the
    launches of video_topk_affinity_v1 on it."""
    import vfs_tpu_torch.apis as apis
    from vfs_tpu_torch.ops import propagation

    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        img_root, ann_root, (list_all, list_one), shape = write_vip(root)
        ckpt = write_backbone(CONFIG_R50, os.path.join(root, 'r50.pth'))

        def run(options, ann_file, name):
            dataset = dict(type='VIPDataset', ann_file=ann_file,
                           data_prefix=img_root, anno_prefix=ann_root,
                           data_root=root)
            return run_slice3_eval(CONFIG_R50, ckpt, 'mIoU', dataset,
                                   os.path.join(root, f'{name}.npz'),
                                   options)

        v1 = ['test_cfg.video_engine=v1']
        walls, extract_spans, propagate_spans = [], [], []
        with patched(apis, 'single_process_test', wall_timer(walls)):
            run(v1, list_all, 'cold')
            first_s = walls[-1]
            (miou, masks), launches = counted_eval(
                run, v1, list_all, extract_spans, propagate_spans)
            eval_s = walls[-1]
            extract_ms = spans_ms(extract_spans)
            propagate_ms = spans_ms(propagate_spans)
            miou_v2, masks_v2 = run(['test_cfg.video_engine=v2'], list_all,
                                    'v2')
            with patched(propagation, 'video_topk_affinity_v1',
                         plain_phase1):
                _, masks_plain = run(v1, list_one, 'plain')

    frames = sum(m.shape[0] for m in masks)
    if launches != len(masks):
        raise AssertionError(f'{launches} v1 launches for {len(masks)} '
                             'videos')
    for m in masks:
        if m.shape != shape or m.dtype != np.uint8 or m.max() > 19:
            raise AssertionError(f'bad masks {m.shape} {m.dtype}')
    agree_v2 = float(np.mean([(a == b).mean()
                              for a, b in zip(masks, masks_v2)]))
    agree_plain = float((masks[0] == masks_plain[0]).mean())
    if agree_v2 < 0.999 or agree_plain < 0.999 or miou != miou_v2:
        raise AssertionError(
            f'masks agree on {agree_v2} (v2) and {agree_plain} (plain phase '
            f'1), mIoU {miou} vs {miou_v2}')
    if not 0.0 <= miou['mIoU'] <= 1.0:
        raise AssertionError(f'mIoU {miou} out of range')
    emit({'phase': 'vip', 'config': os.path.relpath(CONFIG_R50, ROOT),
          'dataset': 'VIPDataset', 'engine': 'v1', 'extract': 'sweep',
          'videos': len(masks), 'frames': frames, 'first_call_s': first_s,
          'eval_s': eval_s, 'eval_fps': frames / eval_s,
          'extract_ms_per_frame': extract_ms / frames,
          'propagate_ms_per_frame': propagate_ms / frames,
          'mask_agree_v2': agree_v2, 'mask_agree_plain_phase1': agree_plain,
          'kernel_launches': launches, **miou})
    return launches


# the train phase (module docstring, phase 8)
K400_CLIPS, K400_FRAMES, K400_HW = 32, 16, (256, 340)
TRAIN_VAL_FRAMES = 10
TIMED_STEPS, WARMUP_STEPS = 10, 3
# batches in the epoch that times the end-to-end rate of the _deviceaug
# config (one for each of the config's 16 loader processes; two until the
# r50 phases took the script past 1200 s) and of the host-aug config (the
# 154 MB batches queue on the pool's result pipe from the first round on;
# 32, then 16, cut to keep the script's time), and in the warm epoch that
# times the loader alone (the pipe, not the 16 processes, sets its rate;
# 16 until the same cut)
E2E_BATCHES, HOST_E2E_BATCHES, LOADER_BATCHES = 16, 8, 8
LOADER_SAMPLES_IN_PROCESS = 4
# the loader epoch whose first batch the card-vs-CPU checks take: 16
# batches of the config's RepeatDataset (the first batch of each clip
# format that every earlier run of this script took)
GATE_LOADER_BATCHES = 16
CARD_CPU_FACTOR, CARD_CPU_FLOOR = 4.0, 1e-5
# a ReLU decision of an fp32 step may differ from the fp64 step's only
# within this many fp32 ulps of the call's RMS input from 0 (measured on
# the card and the CPU: up to 13.3)
KINK_ULPS = 64
# (low, high) relative L2 of the bf16 step's step-0 backbone features and
# gradients from the fp32 step's (module docstring, tolerances)
BF16_REL_L2 = dict(feats=(1e-3, 2.5e-2), grads=(1e-2, 0.4))
BF16_LOSS_ATOL = 1e-3


def write_k400(root, fmt):
    """``K400_CLIPS`` Kinetics-layout clips of ``K400_FRAMES`` frames of
    ``K400_HW`` under ``root`` (``tools.analysis.fixtures.write_k400``) in
    ``fmt``: ``'mjpg'`` (the train runs' clips) or ``'mp4v'`` (the
    fixture's default, which ``bench_pretrain`` writes); both feed the
    card-vs-CPU checks (module docstring, tolerances). Returns the list
    file's path."""
    from vfs_tpu_torch.tools.analysis.fixtures import MJPG
    from vfs_tpu_torch.tools.analysis.fixtures import write_k400 as write
    return write(root, K400_CLIPS, K400_FRAMES, K400_HW,
                 MJPG if fmt == 'mjpg' else ('mp4', 'mp4v'))


def loader_first_batch(cfg_dict, ann, clips, samples):
    """The first ``samples`` samples of the first batch of ``cfg_dict``'s
    train loader over ``clips`` for an epoch of ``GATE_LOADER_BATCHES``
    batches (``RepeatDataset`` times raised to give them; shuffled with
    seed 0): built in this process as the loader's first worker
    builds them, its generators seeded with the loader's seed + 0, so that
    the batch does not depend on which worker the pool hands it to.
    Returns the frames as numpy."""
    import random
    from vfs_tpu_torch.datasets import build_dataloader, build_dataset
    from vfs_tpu_torch.datasets.builder import collate
    global_batch = cfg_dict['data']['videos_per_gpu']
    dataset = build_dataset(dict(
        cfg_dict['data']['train'],
        times=GATE_LOADER_BATCHES * global_batch // K400_CLIPS, dataset=dict(
            cfg_dict['data']['train']['dataset'], ann_file=ann,
            data_prefix=clips)))
    loader = build_dataloader(dataset, global_batch, 1, shuffle=True,
                              drop_last=True, seed=0)
    indices = loader.sampler.indices(0)[:samples]
    saved = np.random.get_state(), random.getstate()
    np.random.seed(loader.sampler.seed)
    random.seed(loader.sampler.seed)
    try:
        return collate([dataset[int(i)] for i in indices])['imgs']
    finally:
        np.random.set_state(saved[0])
        random.setstate(saved[1])


def video_decoder():
    """The decoder behind the configs' ``DecordInit`` / ``DecordDecode`` in
    this process: ``'native'`` (FFmpeg, ``datasets.native_loader``) or
    ``'cv2'`` (its library did not build)."""
    from vfs_tpu_torch.datasets import native_loader
    return 'native' if native_loader.get_video_lib() is not None else 'cv2'


def train_flops(model, frames_hw, n_frames):
    """FLOPs of one train step of ``model``: 2 per multiply-accumulate of
    every convolution and linear layer at the shapes a forward over two
    views of ``n_frames`` frames gives them, x3 for the forward and the
    backward (data and weight gradients), but x2 for the stem's
    convolution, whose input (the frames) takes no gradient; and the
    forward's multiply-accumulates a frame. Counted with hooks on a copy
    over two 1-frame views, scaled."""
    import copy
    import torch
    probe = copy.deepcopy(model).cpu().float().eval()
    macs = [0, 0]  # forward, forward + backward passes

    def hook(m, inp, out):
        if isinstance(m, torch.nn.Conv2d):
            k = m.in_channels // m.groups * m.kernel_size[0] \
                * m.kernel_size[1]
        else:
            k = m.in_features
        passes = 2 if m is probe.backbone.conv1 else 3
        macs[0] += out.numel() * k
        macs[1] += passes * out.numel() * k

    for m in probe.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        # one sample of two 1-frame views: the backbone and head see 2
        # frames; the BatchNorms of an eval-mode copy run on 1-row batches
        probe(torch.zeros(1, 2, 1, *frames_hw, 3))
    return 2 * macs[1] * n_frames / 2, macs[0] / 2


def step_timer(records):
    """``patched`` maker for ``apis.train.make_train_step``: each step's
    loss (a tensor on the card) and its end time, the card's queue
    drained, go to ``records``."""
    import torch

    def make(make_step):
        def wrapped(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def timed(imgs, *args):
                log_vars = step(imgs, *args)
                torch.cuda.synchronize()
                records.append((log_vars['loss'], time.time()))
                return log_vars
            return timed
        return wrapped
    return make


def eval_counter(evals):
    """``patched`` maker for ``apis.test.single_process_test``: each
    eval's wall seconds and ``video_topk_affinity``'s launches in it."""
    import torch
    from vfs_tpu_torch.ops import video_topk_affinity_cuda

    def make(fn):
        def counted(model, dataset, *args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = video_topk_affinity_cuda.launches, time.time()
            out = fn(model, dataset, *args, **kwargs)
            torch.cuda.synchronize()
            evals.append(dict(videos=len(dataset), wall_s=time.time() - t0,
                              launches=video_topk_affinity_cuda.launches
                              - before))
            return out
        return counted
    return make


_SEEDED_MODELS = {}


def build_train_model(cfg_dict, mixed, dev):
    """The config's tracker at full width with seeded random weights
    (seed 0), on ``dev``; ``mixed`` takes the bf16 backbone. The seeded
    init runs once a configuration; later calls copy its model."""
    import copy
    import torch
    from vfs_tpu_torch.apis.train import apply_mixed_precision
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.utils import Config
    cfg = Config.fromdict(copy.deepcopy(cfg_dict))
    if mixed:
        cfg.bf16 = True
        apply_mixed_precision(cfg)
    key = json.dumps([cfg_dict['model'], cfg_dict.get('train_cfg'), mixed],
                     sort_keys=True, default=str)
    if key not in _SEEDED_MODELS:
        seeded = build_model(cfg.model, train_cfg=cfg.get('train_cfg'))
        seeded.init_weights(torch.Generator().manual_seed(0))
        _SEEDED_MODELS[key] = seeded
    model = copy.deepcopy(_SEEDED_MODELS[key])
    model.to(dev).train()
    if dev.type == 'cuda':
        model.backbone.to(memory_format=torch.channels_last)
    return model, cfg


def train_grads(cfg_dict, batch, device, dtype):
    """One step of the config's model (seed-0 weights) on ``batch``:
    (loss, {name: gradient as fp64 on the CPU})."""
    import torch
    from vfs_tpu_torch.apis.train import make_train_step
    from vfs_tpu_torch.core.optimizer import build_optimizer
    model, cfg = build_train_model(cfg_dict, False, torch.device('cpu'))
    model.to(device=device, dtype=dtype)
    if device.type == 'cuda':
        model.backbone.to(memory_format=torch.channels_last)
    optimizer, _ = build_optimizer(model.parameters(), cfg.optimizer,
                                   cfg.get('lr_config'), 10, 5)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    loss = float(make_train_step(model, optimizer)(
        batch.astype(np_dtype))['loss'])
    return loss, {n: p.grad.detach().double().cpu()
                  for n, p in model.named_parameters()}


def grad_error(grads, ref):
    """The largest relative L2 difference of a gradient from ``ref``'s,
    and its name; gradients that are zero in exact arithmetic (a Linear
    bias before a BatchNorm: below 1e-6 of the whole) are left out."""
    import torch
    total = float(torch.sqrt(sum((g * g).sum() for g in ref.values())))
    return max((float((grads[n] - g).norm()) / float(g.norm()), n)
               for n, g in ref.items() if float(g.norm()) > 1e-6 * total)


def card_vs_cpu(cfg_dict, batch, dev):
    """One step at the batch's B from the same weights and batch on the
    card and on the CPU through the same code, each in exact fp32 and in
    fp64 (module docstring, tolerances). Returns the losses and the
    errors."""
    import torch
    cpu = torch.device('cpu')
    return card_cpu_rule(train_grads(cfg_dict, batch, cpu, torch.float64),
                         train_grads(cfg_dict, batch, dev, torch.float64),
                         train_grads(cfg_dict, batch, cpu, torch.float32),
                         train_grads(cfg_dict, batch, dev, torch.float32))


def card_cpu_rule(exact, card64, cpu32, card32):
    """The card-vs-CPU rule on four steps' (loss, gradients): the card's
    fp64 step within 1e-9 of the CPU's, and the card's fp32 step within
    ``CARD_CPU_FACTOR`` x the CPU's fp32 distance from it plus
    ``CARD_CPU_FLOOR`` (the loss likewise, plus 1e-6 of it)."""
    l64, g64 = exact
    err64, name64 = grad_error(card64[1], g64)
    err_cpu, _ = grad_error(cpu32[1], g64)
    err_card, name = grad_error(card32[1], g64)
    err_pair, _ = grad_error(card32[1], cpu32[1])
    if err64 > 1e-9 or abs(card64[0] - l64) > 1e-9 * abs(l64):
        raise AssertionError(f'card vs CPU in fp64: gradient {name64} '
                             f'differs by {err64}, loss {card64[0]} vs '
                             f'{l64}')
    if err_card > CARD_CPU_FACTOR * err_cpu + CARD_CPU_FLOOR or \
            abs(card32[0] - l64) > CARD_CPU_FACTOR * abs(cpu32[0] - l64) \
            + 1e-6 * abs(l64):
        raise AssertionError(
            f'card vs CPU in fp32: gradient {name} off the fp64 step by '
            f'{err_card} (the CPU by {err_cpu}), loss {card32[0]} '
            f'({cpu32[0]} on the CPU, {l64} in fp64)')
    return dict(loss_fp32=[card32[0], cpu32[0]], loss_fp64=[card64[0], l64],
                grad_rel_l2_fp32_card_cpu=err_pair,
                grad_rel_l2_fp32_card_exact=err_card,
                grad_rel_l2_fp32_cpu_exact=err_cpu,
                grad_rel_l2_fp64_card_cpu=err64)


@contextlib.contextmanager
def relu_decisions(record=None, pinned=None):
    """Inside the block every ``F.relu`` call (the backbones' and heads')
    appends its input, on the CPU, to ``record``; or, given ``pinned``
    (the boolean masks of another run's calls, in call order), passes its
    input where the call's mask holds and 0 elsewhere, whatever the
    input's sign, so that the gradient takes the mask's decision."""
    import torch
    import torch.nn.functional as F
    relu, calls = F.relu, [0]

    def decided(x, inplace=False):
        i, calls[0] = calls[0], calls[0] + 1
        if record is not None:
            record.append(x.detach().cpu())
        if pinned is None:
            return relu(x)
        return torch.where(pinned[i].to(x.device), x, torch.zeros_like(x))

    F.relu = decided
    try:
        yield
    finally:
        F.relu = relu


def card_vs_cpu_kinks(cfg_dict, batch, dev):
    """``card_cpu_rule`` on steps whose ReLU decisions are the fp64 step's
    (``relu_decisions``), and the fp32 decisions of the card and the CPU
    that differ from the fp64 step's: each must sit within
    ``KINK_ULPS`` fp32 ulps of the call's RMS input from 0 in fp64, where
    the sign is the rounding's (module docstring, tolerances). A ReLU's
    gradient jumps at 0, so such a decision moves every gradient that
    sums over its position by what the position carries, on whichever
    device rounds to the other side. Returns the rule's numbers with the
    pinned decisions, the free steps' errors and the decisions that
    differed."""
    import torch
    cpu = torch.device('cpu')
    inputs = []
    with relu_decisions(record=inputs):
        exact = train_grads(cfg_dict, batch, cpu, torch.float64)
    masks = [x > 0 for x in inputs]
    card64 = train_grads(cfg_dict, batch, dev, torch.float64)
    steps, flips = {}, {}
    for name, device in (('cpu', cpu), ('card', dev)):
        seen = []
        with relu_decisions(record=seen):
            free = train_grads(cfg_dict, batch, device, torch.float32)
        with relu_decisions(pinned=masks):
            steps[name] = train_grads(cfg_dict, batch, device,
                                      torch.float32)
        flips[name] = dict(free_grad_rel_l2=grad_error(free[1],
                                                       exact[1])[0],
                           decisions=0, max_ulps=0.0)
        for x, m, x64 in zip(seen, masks, inputs):
            differ = (x > 0) != m
            if differ.any():
                ulp = float(x64.square().mean().sqrt()) * 2.0**-23
                ulps = float(x64[differ].abs().max()) / ulp
                flips[name]['decisions'] += int(differ.sum())
                flips[name]['max_ulps'] = max(flips[name]['max_ulps'], ulps)
        if flips[name]['max_ulps'] > KINK_ULPS:
            raise AssertionError(
                f'{name} fp32 step: a ReLU decision differs from the fp64 '
                f"step's {flips[name]['max_ulps']} ulps from 0 (> "
                f'{KINK_ULPS})')
    out = card_cpu_rule(exact, card64, steps['cpu'], steps['card'])
    out.update({f'{k}_{name}': v for name, d in flips.items()
                for k, v in d.items()})
    return out


KERNEL_KINDS = (('conv', ('conv', 'cudnn', 'xmma', 'wgrad', 'dgrad',
                           'fprop', 'implicit')),
                ('gemm', ('gemm', 'cublas', 'cutlass')),
                ('reduce', ('reduce',)),
                ('elementwise', ('elementwise', 'vectorized', 'unrolled')))


def device_breakdown(step, batch, steps=3, kind_keys=KERNEL_KINDS):
    """``torch.profiler``'s kernel times over ``steps`` train steps: the
    card's busy ms a step, its idle share of the steps' wall (the
    profiler's own cost included), the ms a step by kind of kernel (by
    name, the first of ``kind_keys`` whose keys it holds) and the top
    kernels. None where it shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / steps
    kernels = []
    for e in prof.key_averages():
        if str(e.device_type).endswith('CUDA'):
            us = getattr(e, 'self_device_time_total', None)
            if us is None:
                us = getattr(e, 'self_cuda_time_total', 0)
            kernels.append((us / 1e3 / steps, e.key, e.count / steps))
    busy = sum(k[0] for k in kernels)
    if not busy:
        return dict(device_busy_ms=None, device_idle_share=None,
                    kernel_ms_by_kind=None, top_kernels=None)
    kinds = {}
    for ms, name, _ in kernels:
        low = name.lower()
        kind = next((k for k, keys in kind_keys
                     if any(key in low for key in keys)), 'other')
        kinds[kind] = kinds.get(kind, 0.0) + ms
    kernels.sort(reverse=True)
    return dict(device_busy_ms=busy, device_idle_share=1 - busy / wall_ms,
                kernel_ms_by_kind=kinds,
                kernels_per_step=sum(k[2] for k in kernels),
                top_kernels=[[name[:90], ms, n]
                             for ms, name, n in kernels[:8]])


def device_steps(cfg_dict, batch, mixed, dev):
    """Median ms of TIMED_STEPS CUDA-event-timed train steps on a batch
    already on the card, after WARMUP_STEPS, and the peak memory; the
    first step's loss, backbone features (both views) and gradients,
    whether the BatchNorm statistics stayed fp32, and
    ``device_breakdown`` of three more steps."""
    import torch
    from vfs_tpu_torch.apis.train import make_train_step
    from vfs_tpu_torch.core.optimizer import build_optimizer
    model, cfg = build_train_model(cfg_dict, mixed, dev)
    optimizer, _ = build_optimizer(model.parameters(), cfg.optimizer,
                                   cfg.get('lr_config'), 1000, 100)
    step = make_train_step(model, optimizer)
    feats = []
    hook = model.backbone.register_forward_hook(
        lambda m, args, out: feats.append(out.detach().clone()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first_loss = float(step(batch)['loss'])
    hook.remove()
    first = dict(loss=first_loss, feats=torch.cat(feats),
                 grads=torch.cat([p.grad.detach().flatten()
                                  for p in model.parameters()]))
    ms = cuda_ms(lambda: step(batch), runs=TIMED_STEPS,
                 warmup=WARMUP_STEPS - 1)
    stats_fp32 = all(b.dtype == torch.float32 for n, b in
                     model.named_buffers() if 'running' in n)
    peak = torch.cuda.max_memory_allocated()
    breakdown = device_breakdown(step, batch)
    del model, optimizer, step
    torch.cuda.empty_cache()
    return ms, peak, first, stats_fp32, breakdown


def part_seconds(t_start, marks):
    """Each part's seconds from ``marks`` (name: end time, in order) after
    ``t_start``."""
    out, t = {}, t_start
    for name, end in marks.items():
        out[name] = end - t
        t = end
    return out


def phase_train(dev, smi_line):
    """Slice 6's path (module docstring, phase 8). Returns the launches of
    video_topk_affinity in the eval hook."""
    import torch
    import vfs_tpu_torch.apis.test as apis_test
    import vfs_tpu_torch.apis.train as apis_train
    from vfs_tpu_torch.datasets import build_dataloader, build_dataset
    from vfs_tpu_torch.ops import video_topk_affinity_cuda
    from vfs_tpu_torch.tools import train as tools_train
    from vfs_tpu_torch.utils import Config

    t_start = time.time()
    cfg_dict = Config.fromfile(CONFIG).to_dict()
    global_batch = cfg_dict['data']['videos_per_gpu']
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        clips, clips_mp4v = (os.path.join(root, d)
                             for d in ('k400', 'k400_mp4v'))
        os.makedirs(clips)
        os.makedirs(clips_mp4v)
        ann = write_k400(clips, 'mjpg')
        ann_mp4v = write_k400(clips_mp4v, 'mp4v')
        davis = os.path.join(root, 'davis')
        img_root, ann_root, (list_all, _), _ = write_davis(
            davis, t_total=TRAIN_VAL_FRAMES)
        work = os.path.join(root, 'work')
        # the config's key names a second feature (feat_1) that an eval
        # with one out_index does not give, so best.json would never be
        # written (in the JAX package too): key on the one J&F
        options = [f'data.train.dataset.ann_file={ann}',
                   f'data.train.dataset.data_prefix={clips}',
                   f'data.val.ann_file={list_all}',
                   f'data.val.data_prefix={img_root}',
                   f'data.val.anno_prefix={ann_root}',
                   f'data.val.data_root={davis}',
                   'evaluation.key_indicator=J&F-Mean']

        def train(total_epochs, validate, records, evals, work=work,
                  extra=()):
            argv = [CONFIG, '--work-dir', work, '--auto-resume',
                    *(['--validate'] if validate else []), '--options',
                    *options, *extra, f'total_epochs={total_epochs}']
            with patched(apis_train, 'make_train_step',
                         step_timer(records)), \
                    patched(apis_test, 'single_process_test',
                            eval_counter(evals)):
                t0 = time.time()
                state = tools_train.main(argv)
                return state, time.time() - t0

        parts = {'setup': time.time()}
        # the path, counted: two epochs with the eval hook
        records, evals = [], []
        video_topk_affinity_cuda.launches = 0
        state, wall_s = train(2, True, records, evals)
        launches = video_topk_affinity_cuda.launches
        steps_per_epoch = len(records) // 2
        losses = [float(loss) for loss, _ in records]
        ckpt = os.path.join(work, 'checkpoints')
        with open(os.path.join(work, 'best.json')) as f:
            best = json.load(f)
        with open(os.path.join(work, 'train_log.jsonl')) as f:
            val = [r for r in map(json.loads, f) if r['mode'] == 'val']
        # auto-resume: epoch 3 alone
        resume_records, resume_evals = [], []
        state3, _ = train(3, False, resume_records, resume_evals)
        parts['path'] = time.time()
        ckpts = sorted(os.listdir(ckpt))

        # end to end in a window that keeps every loader process busy:
        # one epoch of HOST_E2E_BATCHES steps, the first step (the pool's
        # start) left out
        window_records = []
        times = HOST_E2E_BATCHES * global_batch // K400_CLIPS
        train(1, False, window_records, [], work=os.path.join(root, 'e2e'),
              extra=[f'data.train.times={times}'])
        window_ends = [t for _, t in window_records]
        parts['e2e_window'] = time.time()
        e2e_sps = (len(window_ends) - 1) / (window_ends[-1]
                                            - window_ends[0])

        # the host loader alone: epoch 0 starts the pool and gives the
        # batch used below, epoch 1 is timed
        dataset = build_dataset(dict(
            cfg_dict['data']['train'],
            times=LOADER_BATCHES * global_batch // K400_CLIPS, dataset=dict(
                cfg_dict['data']['train']['dataset'], ann_file=ann,
                data_prefix=clips)))
        loader = build_dataloader(
            dataset, global_batch, cfg_dict['data']['workers_per_gpu'],
            shuffle=True, drop_last=True, seed=0)
        try:
            first_batch = None
            for batch in loader:
                first_batch = first_batch or batch
            loader.set_epoch(1)
            t0 = time.time()
            n_samples = sum(len(b['imgs']) for b in loader)
            loader_sps = n_samples / (time.time() - t0)
        finally:
            loader.close()
        # the pipeline in this process, a sample at a time (cv2 free to
        # use its threads)
        t0 = time.time()
        for i in range(LOADER_SAMPLES_IN_PROCESS):
            dataset[i]
        in_process_sps = LOADER_SAMPLES_IN_PROCESS / (time.time() - t0)
        parts['loader'] = time.time()
        frames_hw = first_batch['imgs'].shape[3:5]
        clip_len = first_batch['imgs'].shape[2]
        card_batch = torch.as_tensor(first_batch['imgs'], device=dev)
        small = loader_first_batch(cfg_dict, ann, clips, 2)
        small_mp4v = loader_first_batch(cfg_dict, ann_mp4v, clips_mp4v, 2)
        deviceaug = deviceaug_runs(root, ann, clips)
        parts['deviceaug_runs'] = time.time()

    want = K400_CLIPS * cfg_dict['data']['train']['times'] // global_batch
    if state.step != 2 * steps_per_epoch or steps_per_epoch != want:
        raise AssertionError(f'{state.step} steps, {steps_per_epoch} an '
                             f'epoch (want 2 x {want})')
    if not all(np.isfinite(losses)) or len(losses) != 2 * want:
        raise AssertionError(f'train losses {losses}')
    if [e['launches'] for e in evals] != [e['videos'] for e in evals] \
            or len(evals) != 2 or launches != sum(e['videos'] for e in evals):
        raise AssertionError(f'eval hook launches {evals} ({launches} in '
                             'all; want one per val video per epoch)')
    if 'epoch_1' not in ckpts or 'epoch_2' not in ckpts:
        raise AssertionError(f'checkpoints {ckpts}')
    if state3.step != 3 * want or len(resume_records) != want \
            or 'epoch_3' not in ckpts or resume_evals:
        raise AssertionError(f'resume: step {state3.step}, '
                             f'{len(resume_records)} steps run')
    if not all(np.isfinite(float(loss)) for loss, _ in resume_records):
        raise AssertionError('non-finite loss after resume')
    if not 0.0 <= best['best_score'] <= 1.0 or len(val) != 2:
        raise AssertionError(f'eval hook results {best} {val}')
    if len(window_records) != HOST_E2E_BATCHES or not all(
            np.isfinite(float(loss)) for loss, _ in window_records):
        raise AssertionError(f'end-to-end window: {len(window_records)} '
                             f'steps (want {HOST_E2E_BATCHES})')

    card_cpu = card_vs_cpu(cfg_dict, small, dev)
    card_cpu_mp4v = card_vs_cpu_kinks(cfg_dict, small_mp4v, dev)
    parts['card_vs_cpu'] = time.time()
    n_frames = global_batch * 2 * clip_len
    flops, macs_per_frame = train_flops(
        build_train_model(cfg_dict, False, torch.device('cpu'))[0],
        frames_hw, n_frames)
    fp32_tflops, _, bf16_tflops = peaks(smi_line)
    modes, first = {}, {}
    for name, mixed, peak_tflops in (
            ('fp32', False, fp32_tflops),
            ('bf16', True, bf16_tflops)):
        ms, mem, first[name], stats_fp32, breakdown = device_steps(
            cfg_dict, card_batch, mixed, dev)
        modes[name] = dict(
            ms_per_step=ms, steps_per_s=1e3 / ms,
            frames_per_s=n_frames * 1e3 / ms,
            train_mfu=flops / (ms * 1e-3) / (peak_tflops * 1e12),
            peak_tflops=peak_tflops,
            bound_ms=flops / (peak_tflops * 1e12) * 1e3,
            max_memory_allocated_gb=mem / 2**30,
            step0_loss=first[name]['loss'], bn_stats_fp32=stats_fp32,
            **breakdown)
    bf16_gap = {k: float((first['bf16'][k] - first['fp32'][k]).norm()
                         / first['fp32'][k].norm())
                for k in ('feats', 'grads')}
    for k, (low, high) in BF16_REL_L2.items():
        if not low < bf16_gap[k] < high:
            raise AssertionError(f'bf16 step-0 {k} off the fp32 ones by '
                                 f'{bf16_gap[k]} in relative L2 (want '
                                 f'{low} to {high})')
    loss_gap = abs(first['bf16']['loss'] - first['fp32']['loss'])
    if loss_gap > BF16_LOSS_ATOL:
        raise AssertionError(f'bf16 step-0 loss off the fp32 one by '
                             f'{loss_gap} (> {BF16_LOSS_ATOL})')
    if not modes['bf16']['bn_stats_fp32']:
        raise AssertionError('bf16 step: BatchNorm statistics not fp32')
    parts['device_steps'] = time.time()
    deviceaug.update(deviceaug_device(deviceaug.pop('first_batch'), dev))
    parts['deviceaug_device'] = time.time()
    deviceaug.update(host_aug_e2e_steps_per_s=e2e_sps,
                     host_aug_loader_samples_per_s=loader_sps,
                     host_aug_batch_bytes=card_batch.numel()
                     * card_batch.element_size())
    emit({'phase': 'train_deviceaug', 'card': smi_line,
          'config': os.path.relpath(DA_CONFIG, ROOT), **deviceaug})
    emit({'phase': 'train', 'card': smi_line,
          'config': os.path.relpath(CONFIG, ROOT),
          'global_batch': global_batch, 'frames_per_step': n_frames,
          'frame_hw': list(frames_hw),
          'gmac_per_frame': macs_per_frame / 1e9,
          'tflop_per_step': flops / 1e12, **{
              f'{m}_{k}': v for m, d in modes.items() for k, v in d.items()},
          'bf16_fp32_loss_gap': loss_gap,
          'bf16_fp32_feature_rel_l2': bf16_gap['feats'],
          'bf16_fp32_grad_rel_l2': bf16_gap['grads'],
          **{f'card_vs_cpu_{k}': v for k, v in card_cpu.items()},
          **{f'card_vs_cpu_mp4v_{k}': v for k, v in card_cpu_mp4v.items()},
          'loader_samples_per_s': loader_sps,
          'loader_samples_per_s_in_process': in_process_sps,
          'loader_video_decoder': video_decoder(),
          'loader_workers': cfg_dict['data']['workers_per_gpu'],
          'loader_epoch_batches': LOADER_BATCHES,
          'e2e_epoch_steps': HOST_E2E_BATCHES,
          'e2e_steps_per_s': e2e_sps,
          'train_wall_s': wall_s, 'losses': losses,
          'eval_jf': [r['J&F-Mean'] for r in val],
          'eval_wall_s': [e['wall_s'] for e in evals],
          'eval_videos': evals[0]['videos'], 'kernel_launches': launches,
          'resume_final_step': state3.step, 'checkpoints': ckpts,
          'part_seconds': part_seconds(t_start, parts)})
    return launches


# the r50 pretraining phase (module docstring, phase 8b): steps an epoch,
# and the samples of the card-vs-CPU batches (module docstring,
# tolerances: at 2 the head's BatchNorm1d is degenerate)
R50_EPOCH_STEPS = 2
R50_GATE_SAMPLES = 4


def phase_train_r50(dev, smi_line):
    """The r50 pretraining config's path (module docstring, phase 8b).
    Returns the launches of video_topk_affinity in the eval hook."""
    import torch
    import vfs_tpu_torch.apis.test as apis_test
    import vfs_tpu_torch.apis.train as apis_train
    from vfs_tpu_torch.ops import video_topk_affinity_cuda
    from vfs_tpu_torch.tools import train as tools_train
    from vfs_tpu_torch.utils import Config

    t_start = time.time()
    cfg_dict = Config.fromfile(CONFIG_R50).to_dict()
    global_batch = cfg_dict['data']['videos_per_gpu']
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        sets = {}
        for fmt in ('mjpg', 'mp4v'):
            clips = os.path.join(root, fmt)
            os.makedirs(clips)
            sets[fmt] = (write_k400(clips, fmt), clips)
        ann, clips = sets['mjpg']
        davis = os.path.join(root, 'davis')
        img_root, ann_root, (list_all, _), _ = write_davis(
            davis, t_total=TRAIN_VAL_FRAMES)
        work = os.path.join(root, 'work')
        # the config's key names feat_1, which an eval with one out_index
        # does not give (train phase): key on the one J&F
        options = [f'data.train.dataset.ann_file={ann}',
                   f'data.train.dataset.data_prefix={clips}',
                   'data.train.times='
                   f'{R50_EPOCH_STEPS * global_batch // K400_CLIPS}',
                   f'data.val.ann_file={list_all}',
                   f'data.val.data_prefix={img_root}',
                   f'data.val.anno_prefix={ann_root}',
                   f'data.val.data_root={davis}',
                   'evaluation.key_indicator=J&F-Mean']

        def train(total_epochs, records, evals):
            argv = [CONFIG_R50, '--work-dir', work, '--validate',
                    '--auto-resume', '--options', *options,
                    f'total_epochs={total_epochs}']
            with patched(apis_train, 'make_train_step',
                         step_timer(records)), \
                    patched(apis_test, 'single_process_test',
                            eval_counter(evals)):
                t0 = time.time()
                state = tools_train.main(argv)
                return state, time.time() - t0

        # the path, counted: an epoch with the eval hook, then a resume
        # that runs the next epoch and its eval
        parts = {'setup': time.time()}
        records, evals, resume_records, resume_evals = [], [], [], []
        video_topk_affinity_cuda.launches = 0
        state, wall_s = train(1, records, evals)
        state2, resume_wall_s = train(2, resume_records, resume_evals)
        launches = video_topk_affinity_cuda.launches
        parts['path'] = time.time()
        ckpts = sorted(os.listdir(os.path.join(work, 'checkpoints')))
        with open(os.path.join(work, 'train_log.jsonl')) as f:
            val = [r for r in map(json.loads, f) if r['mode'] == 'val']
        batches = {fmt: loader_first_batch(
            cfg_dict, a, c, global_batch if fmt == 'mjpg'
            else R50_GATE_SAMPLES) for fmt, (a, c) in sets.items()}
        parts['batches'] = time.time()

    losses = [float(loss) for loss, _ in records + resume_records]
    all_evals = evals + resume_evals
    if state.step != R50_EPOCH_STEPS or state2.step != 2 * R50_EPOCH_STEPS \
            or len(records) != R50_EPOCH_STEPS \
            or len(resume_records) != R50_EPOCH_STEPS:
        raise AssertionError(f'r50: steps {state.step}, {state2.step} '
                             f'({len(records)} + {len(resume_records)} run)')
    if not all(np.isfinite(losses)):
        raise AssertionError(f'r50 train losses {losses}')
    if 'epoch_1' not in ckpts or 'epoch_2' not in ckpts:
        raise AssertionError(f'r50 checkpoints {ckpts}')
    if len(all_evals) != 2 or len(val) != 2 or launches != sum(
            e['videos'] for e in all_evals) or any(
                e['launches'] != e['videos'] for e in all_evals):
        raise AssertionError(f'r50 eval hook {all_evals} ({launches} '
                             'launches; want one per val video per epoch)')
    gates = {fmt: card_vs_cpu_kinks(cfg_dict, b[:R50_GATE_SAMPLES], dev)
             for fmt, b in batches.items()}
    parts['card_vs_cpu'] = time.time()
    card_batch = torch.as_tensor(batches['mjpg'], device=dev)
    frames_hw = card_batch.shape[3:5]
    n_frames = global_batch * 2 * card_batch.shape[2]
    flops, macs_per_frame = train_flops(
        build_train_model(cfg_dict, False, torch.device('cpu'))[0],
        frames_hw, n_frames)
    fp32_tflops = peaks(smi_line)[0]
    ms, mem, first, stats_fp32, breakdown = device_steps(
        cfg_dict, card_batch, False, dev)
    del card_batch
    parts['device_steps'] = time.time()
    emit({'phase': 'train_r50', 'card': smi_line,
          'config': os.path.relpath(CONFIG_R50, ROOT),
          'global_batch': global_batch, 'frames_per_step': n_frames,
          'frame_hw': list(frames_hw),
          'gmac_per_frame': macs_per_frame / 1e9,
          'tflop_per_step': flops / 1e12,
          'fp32_ms_per_step': ms, 'fp32_steps_per_s': 1e3 / ms,
          'fp32_frames_per_s': n_frames * 1e3 / ms,
          'fp32_train_mfu': flops / (ms * 1e-3) / (fp32_tflops * 1e12),
          'fp32_bound_ms': flops / (fp32_tflops * 1e12) * 1e3,
          'fp32_max_memory_allocated_gb': mem / 2**30,
          'fp32_step0_loss': first['loss'], 'bn_stats_fp32': stats_fp32,
          **{f'fp32_{k}': v for k, v in breakdown.items()},
          **{f'card_vs_cpu_{fmt}_{k}': v for fmt, d in gates.items()
             for k, v in d.items()},
          'card_vs_cpu_samples': R50_GATE_SAMPLES,
          'loader_workers': cfg_dict['data']['workers_per_gpu'],
          'train_wall_s': wall_s, 'resume_wall_s': resume_wall_s,
          'losses': losses, 'eval_jf': [r['J&F-Mean'] for r in val],
          'eval_wall_s': [e['wall_s'] for e in all_evals],
          'kernel_launches': launches, 'resume_final_step': state2.step,
          'checkpoints': ckpts,
          'part_seconds': part_seconds(t_start, parts)})
    return launches


# the _deviceaug config's runs in the train phase (module docstring,
# phase 8): 1-step epochs of the profile and resume runs; the card's chain
# against the CPU's on the [0, 255] scale, before normalisation
DA_CONFIG = os.path.join(ROOT, 'configs',
                         'r18_sgd_cos_100e_r2_1xNx8_k400_deviceaug.py')
DA_RUN_EPOCHS = 4
# loader processes of the profile and resume runs, which take a batch an
# epoch (the config's 16 until the r50 phases took the script past 1200 s)
DA_RUN_WORKERS = 4
DA_CARD_CPU_ATOL = 1e-3
# the dense phase (module docstring, phase 9; 12 frames until the r50
# phases took the script past 1200 s)
DENSE_FRAMES = 8
DENSE_RUNS = (('first_neighbor_exempt', dict(with_first_neighbor=False)),
              ('no_mask_dense', dict(neighbor_range=None, backend='dense')))


def draw_recorder(draws):
    """``patched`` maker for ``DeviceAugChain.draw``: each call's drawn
    parameters, as CPU tensors, go to ``draws``."""
    import torch

    def make(draw):
        def recorded(self, *args, **kwargs):
            params = draw(self, *args, **kwargs)
            draws.append([v.cpu() for _, p in params for v in p.values()
                          if torch.is_tensor(v)] +
                         [v.cpu() for _, p in params
                          for v in p.get('rects', ())])
            return params
        return recorded
    return make


def trace_kernels(path):
    """The kernel names of a Chrome trace ``torch.profiler`` wrote."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    return [e['name'] for e in events if e.get('cat') == 'kernel']


def deviceaug_runs(root, ann, clips):
    """The ``_deviceaug`` config through ``tools.train`` on the clips under
    ``root``: the host loader's samples/s over a warm epoch and its bytes a
    batch, the end-to-end steps/s over an epoch of ``E2E_BATCHES`` steps,
    a ``--profile 2`` run of ``DA_RUN_EPOCHS`` 1-step epochs (the trace
    must name the steps' kernels) and its auto-resume from epoch
    ``DA_RUN_EPOCHS - 1`` (the last step's draws must be equal). Returns
    the numbers and the loader's first batch."""
    import torch
    import vfs_tpu_torch.apis.train as apis_train
    from vfs_tpu_torch.datasets import build_dataloader, build_dataset
    from vfs_tpu_torch.ops import device_aug
    from vfs_tpu_torch.tools import train as tools_train
    from vfs_tpu_torch.utils import Config

    cfg_dict = Config.fromfile(DA_CONFIG).to_dict()
    batch = cfg_dict['data']['videos_per_gpu']
    options = [f'data.train.dataset.ann_file={ann}',
               f'data.train.dataset.data_prefix={clips}']

    def train(work, epochs, times, records, draws, extra=(), workers=None):
        argv = [DA_CONFIG, '--work-dir', work, '--auto-resume', *extra,
                '--options', *options, f'data.train.times={times}',
                f'total_epochs={epochs}']
        if workers is not None:
            argv.append(f'data.workers_per_gpu={workers}')
        with patched(apis_train, 'make_train_step', step_timer(records)), \
                patched(device_aug.DeviceAugChain, 'draw',
                        draw_recorder(draws)):
            return tools_train.main(argv)

    # the host loader alone: epoch 0 starts the pool, epoch 1 is timed
    dataset = build_dataset(dict(
        cfg_dict['data']['train'], times=LOADER_BATCHES * batch // K400_CLIPS,
        dataset=dict(cfg_dict['data']['train']['dataset'], ann_file=ann,
                     data_prefix=clips)))
    loader = build_dataloader(dataset, batch,
                              cfg_dict['data']['workers_per_gpu'],
                              shuffle=True, drop_last=True, seed=0)
    try:
        first_batch = None
        for b in loader:
            first_batch = first_batch or b
        loader.set_epoch(1)
        t0 = time.time()
        n_samples = sum(len(b['imgs']) for b in loader)
        loader_sps = n_samples / (time.time() - t0)
    finally:
        loader.close()
    imgs = first_batch['imgs']
    staging_w, staging_h = next(
        t['scale'] for t in cfg_dict['data']['train']['dataset']['pipeline']
        if t['type'] == 'DeviceAug')
    if imgs.dtype != np.uint8 or imgs.shape[3:] != (staging_h, staging_w, 3) \
            or first_batch['orig_hw'].tolist() != [list(K400_HW)] * batch:
        raise AssertionError(f'deviceaug batch {imgs.dtype} {imgs.shape} '
                             f'{first_batch["orig_hw"][:2]}')

    # end to end: one epoch of E2E_BATCHES steps, the first left out
    records = []
    train(os.path.join(root, 'da_e2e'), 1, E2E_BATCHES * batch // K400_CLIPS,
          records, [])
    ends = [t for _, t in records]
    if len(records) != E2E_BATCHES or not all(
            np.isfinite(float(loss)) for loss, _ in records):
        raise AssertionError(f'deviceaug end to end: {len(records)} steps')
    e2e_sps = (len(ends) - 1) / (ends[-1] - ends[0])

    # --profile 2 over 1-step epochs, then a resume of the last epoch
    work = os.path.join(root, 'da_profile')
    steps_per_epoch = K400_CLIPS // batch
    records, draws = [], []
    state = train(work, DA_RUN_EPOCHS, 1, records, draws,
                  extra=['--profile', '2'], workers=DA_RUN_WORKERS)
    kernels = trace_kernels(os.path.join(work, 'profile',
                                         'trace_rank0.json'))
    conv = [k for k in kernels if any(
        key in k.lower() for key in KERNEL_KINDS[0][1])]
    if state.step != DA_RUN_EPOCHS * steps_per_epoch or not conv:
        raise AssertionError(f'profile run: step {state.step}, '
                             f'{len(kernels)} kernels traced, '
                             f'{len(conv)} convolutions')
    with open(os.path.join(work, 'checkpoints', 'latest'), 'w') as f:
        f.write(f'epoch_{DA_RUN_EPOCHS - 1}')
    resumed = []
    state = train(work, DA_RUN_EPOCHS, 1, [], resumed,
                  workers=DA_RUN_WORKERS)
    if state.step != DA_RUN_EPOCHS * steps_per_epoch \
            or len(resumed) != steps_per_epoch \
            or len(draws) != DA_RUN_EPOCHS * steps_per_epoch:
        raise AssertionError(f'resume: step {state.step}, {len(resumed)} '
                             f'draws (whole run {len(draws)})')
    same = all(len(r) == len(d) and all(map(torch.equal, r, d))
               for r, d in zip(resumed, draws[-steps_per_epoch:]))
    if not same:
        raise AssertionError('the resumed steps drew other augmentations')
    return dict(first_batch=first_batch,
                loader_samples_per_s=loader_sps,
                loader_batch_bytes=int(imgs.nbytes
                                       + first_batch['orig_hw'].nbytes),
                loader_workers=cfg_dict['data']['workers_per_gpu'],
                e2e_epoch_steps=E2E_BATCHES, e2e_steps_per_s=e2e_sps,
                profile_kernels_traced=len(kernels),
                profile_conv_kernels=len(conv),
                resume_draws_equal=same)


def count_kernels(fn):
    """The kernels ``fn`` launches on the card (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages()
                   if str(e.device_type).endswith('CUDA')))


def deviceaug_device(first_batch, dev):
    """The chain of the ``_deviceaug`` config on the card: on a B=2 batch
    with the same drawn parameters on the card and on the CPU (within
    ``DA_CARD_CPU_ATOL`` on the [0, 255] scale); its ms and launches on
    the full batch; the device-only step with the chain in exact fp32 and
    in bf16 (median of ``TIMED_STEPS`` after ``WARMUP_STEPS``)."""
    import torch
    from vfs_tpu_torch.apis.train import make_train_step
    from vfs_tpu_torch.core.optimizer import build_optimizer
    from vfs_tpu_torch.ops.device_aug import build_device_aug, step_seed
    from vfs_tpu_torch.utils import Config
    cfg_dict = Config.fromfile(DA_CONFIG).to_dict()
    da = cfg_dict['device_aug']
    chain = build_device_aug(da['transforms'], cfg_dict['img_norm_cfg'],
                             out_hw=tuple(da['out_hw']))
    imgs = torch.as_tensor(first_batch['imgs'], device=dev)
    orig_hw = torch.as_tensor(first_batch['orig_hw'], device=dev)

    # (a) the card against the CPU on the same parameters
    generator = torch.Generator(device=dev)
    generator.manual_seed(step_seed(0, 0, 0))
    params = chain.draw(imgs[:2].shape, orig_hw[:2], generator)
    params_cpu = [(typ, {k: (tuple(t.cpu() for t in v)
                             if isinstance(v, tuple) else
                             v.cpu() if torch.is_tensor(v) else v)
                         for k, v in p.items()}) for typ, p in params]
    card = chain.apply(imgs[:2], params).cpu()
    cpu = chain.apply(imgs[:2].cpu(), params_cpu)
    std = torch.tensor(chain.std)
    card_cpu = float(((card - cpu) * std).abs().max())
    if not card_cpu <= DA_CARD_CPU_ATOL:
        raise AssertionError(f'deviceaug chain: card vs CPU {card_cpu} > '
                             f'{DA_CARD_CPU_ATOL} on the [0, 255] scale')

    # (b) the chain alone and the device-only step with it
    chain_ms = cuda_ms(lambda: chain(imgs, orig_hw, generator),
                       runs=TIMED_STEPS, warmup=2)
    chain_launches = count_kernels(lambda: chain(imgs, orig_hw, generator))
    out = {}
    for name, mixed in (('fp32', False), ('bf16', True)):
        model, cfg = build_train_model(cfg_dict, mixed, dev)
        optimizer, _ = build_optimizer(model.parameters(), cfg.optimizer,
                                       cfg.get('lr_config'), 1000, 100)
        step = make_train_step(model, optimizer, device_aug=chain)
        loss = float(step(imgs, orig_hw)['loss'])
        if not np.isfinite(loss):
            raise AssertionError(f'deviceaug {name} step: loss {loss}')
        out[f'{name}_ms_per_step'] = cuda_ms(
            lambda: step(imgs, orig_hw), runs=TIMED_STEPS,
            warmup=WARMUP_STEPS - 1)
        out[f'{name}_kernels_per_step'] = count_kernels(
            lambda: step(imgs, orig_hw))
        del model, optimizer, step
        torch.cuda.empty_cache()
    return dict(batch=list(first_batch['imgs'].shape),
                chain_card_vs_cpu_max_abs=card_cpu,
                chain_ms_per_step=chain_ms,
                chain_kernels_per_step=chain_launches,
                chain_share_fp32=chain_ms / out['fp32_ms_per_step'],
                chain_share_bf16=chain_ms / out['bf16_ms_per_step'], **out)


def phase_dense(dev, smi_line):
    """The dense tier (module docstring, phase 9): r18 ``forward_test`` at
    full width on a ``DENSE_FRAMES``-frame video under each of
    ``DENSE_RUNS``, on the card (warm ms/frame) and on the CPU; the masks
    must agree on >= 99.9% of pixels and no kernel may launch."""
    import runpy
    import torch
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.ops import (local_topk_attend_cuda,
                                   video_topk_affinity_cuda)
    cfg = runpy.run_path(CONFIG)
    model = build_model(dict(type='VanillaTracker',
                             backbone=dict(cfg['model']['backbone'])),
                        test_cfg=dict(cfg['test_cfg']))
    model.init_weights(torch.Generator().manual_seed(0))
    imgs, gt = synthetic_video(t_total=DENSE_FRAMES)
    meta = [dict(original_shape=imgs.shape[1:3],
                 img_norm_cfg=dict(cfg['img_norm_cfg']))]
    runs = {}
    for name, extra in DENSE_RUNS:
        model.test_cfg = dict(cfg['test_cfg'], **extra)
        video_topk_affinity_cuda.launches = 0
        local_topk_attend_cuda.launches = 0
        walls = []
        for _ in range(2):  # cold, warm
            torch.cuda.synchronize()
            t0 = time.time()
            preds = model.forward_test(imgs, gt[0], meta)[0]
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
        launched = (video_topk_affinity_cuda.launches
                    + local_topk_attend_cuda.launches)
        t0 = time.time()
        cpu = model.forward_test(imgs, gt[0], meta, device='cpu')[0]
        cpu_s = time.time() - t0
        agree = float((preds == cpu).mean())
        if preds.shape != gt.shape or agree < 0.999 or launched:
            raise AssertionError(f'dense {name}: masks agree on {agree}, '
                                 f'{launched} kernel launches')
        runs[name] = dict(card_ms_per_frame=walls[1] * 1e3 / DENSE_FRAMES,
                          card_cold_ms_per_frame=walls[0] * 1e3
                          / DENSE_FRAMES,
                          cpu_ms_per_frame=cpu_s * 1e3 / DENSE_FRAMES,
                          mask_agree_cpu=agree)
    model.test_cfg = dict(cfg['test_cfg'])
    emit({'phase': 'dense', 'card': smi_line, 'video': list(imgs.shape),
          **{f'{n}_{k}': v for n, r in runs.items() for k, v in r.items()}})


def phase_learning(smi_line):
    """The learning loop (module docstring, phase 10) at its defaults on
    the card: ``retrieval_margin`` must be positive; ``jf_margin`` is
    printed, not gated. Returns video_topk_affinity's launches (one per
    val video and tracker)."""
    import torch
    from vfs_tpu_torch.ops import video_topk_affinity_cuda
    from vfs_tpu_torch.tools import learning_loop
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        video_topk_affinity_cuda.launches = 0
        t0 = time.time()
        res = learning_loop.main(['--work-dir', os.path.join(root, 'll'),
                                  '--seed', '0'])
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        launches = video_topk_affinity_cuda.launches
    if not res['retrieval_margin'] > 0 or launches != 2 * 12:
        raise AssertionError(f'learning loop: {res}, {launches} launches')
    emit({'phase': 'learning', 'card': smi_line, 'wall_s': wall_s,
          'kernel_launches': launches, **res})
    return launches


# The JAX bench's eval configuration (bench.py:41,63-72,80-82,114-124),
# copied: the script imports nothing of the JAX package. Three videos of
# seeded noise with seven boxes of labels; per depth the test_cfg (bf16
# features, yuv420 transport) and neighbor range, a bf16 backbone, and the
# floors of bf16 against fp32 agreement.
BENCH_VIDEO_SHAPES = [(80, 480, 854), (60, 480, 910), (100, 480, 768)]
BENCH_NUM_CLASSES = 8
BENCH_BOXES = [(60, 150, 120, 120), (250, 90, 100, 160), (340, 420, 90, 200),
               (120, 520, 140, 110), (300, 640, 80, 90), (40, 700, 60, 60),
               (400, 100, 60, 260)]
BENCH_MODELS = (('r18', 18, 24, 0.97), ('r50', 50, 36, 0.98))
BENCH_AGREE_FRAMES = 20
BENCH_NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
# rows 1-3 in bf16 at small shapes: C = 8 (one 16-byte quad), 16 (a part
# of a 64-channel cell), 72 (a cell and a part), topk up to 32. Rows 1-2:
# (T, h, w, C, radius, P, topk); row 3: (h, w, C, radius, validity, topk,
# K)
BF16_SMALL_CASES = [(5, 3, 5, 8, 3.0, 4, 5), (6, 13, 45, 16, 5.0, 3, 10),
                    (4, 10, 37, 72, 12.0, 2, 32)]
BF16_SMALL_LOCAL_CASES = [(3, 5, 8, 3.0, (1, 1), 5, 4),
                          (13, 45, 16, 5.0, (1, 0, 1), 10, 4),
                          (10, 37, 72, 12.0, (1, 1), 32, 4)]


def bench_test_cfg(neighbor_range):
    """bench.py's TEST_CFGS entry for a depth."""
    return dict(precede_frames=20, topk=10, temperature=0.07,
                strides=(1, 2, 1, 1), out_indices=(2,),
                neighbor_range=neighbor_range, with_first=True,
                with_first_neighbor=True, batch_step=20,
                pallas_precision='bfloat16', input_format='yuv420')


def bench_videos():
    """bench.py's make_videos: (imgs, first-frame labels, meta) each."""
    rng = np.random.RandomState(0)
    videos = []
    for t_total, h, w in BENCH_VIDEO_SHAPES:
        imgs = rng.randint(0, 255, (t_total, h, w, 3), np.uint8)
        seg = np.zeros((h, w), np.uint8)
        for k, (y, x, bh, bw) in enumerate(
                BENCH_BOXES[:BENCH_NUM_CLASSES - 1]):
            seg[y:y + bh, x:min(x + bw, w)] = k + 1
        meta = dict(original_shape=(h, w), img_norm_cfg=dict(
            mean=np.array(BENCH_NORM['mean'], np.float32),
            std=np.array(BENCH_NORM['std'], np.float32)))
        videos.append((imgs, seg, meta))
    return videos


def bf16_bounds(flops, nbytes_bf16, name):
    """The bound of a bf16 launch two ways, each the larger of operations
    over the peak and bytes over the memory rate: ``bound_ms`` on the dense
    bf16 tensor cores (the card's peak for bf16 products summed in fp32:
    the roofline of the kernels line) and ``ffma_bound_ms`` on the fp32
    CUDA cores (the design's own ceiling: its FFMAs)."""
    ffma_ms, ffma_by = bound_ms(flops, nbytes_bf16, name)
    _, tbps, bf16_tflops = peaks(name)
    by_ops = flops / (bf16_tflops * 1e12) * 1e3
    by_bytes = nbytes_bf16 / (tbps * 1e12) * 1e3
    return dict(bound_ms=max(by_ops, by_bytes),
                bound_by='operations' if by_ops >= by_bytes else 'bytes',
                ffma_bound_ms=ffma_ms, ffma_bound_by=ffma_by)


def same_lists(a, b):
    """Scores and sources of rows t >= 1 equal bit for bit."""
    import torch
    return (torch.equal(a[0][1:], b[0][1:])
            and torch.equal(a[1][1:], b[1][1:]))


def bf16_small_checks(dev):
    """Rows 1-3's bf16 entries at small shapes (BF16_SMALL_CASES,
    BF16_SMALL_LOCAL_CASES) and on duplicated-frame tie cases: each against
    its plain version (exact sources on the ties), against its fp32 entry
    on the widened features (bit for bit) and row 2 against row 1 (bit for
    bit). Returns the worst max_abs_err and source mismatch."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (l2_normalize, local_topk_attend_cuda,
                                   video_topk_affinity_cuda,
                                   video_topk_affinity_reference,
                                   video_topk_affinity_v1_cuda)

    def bf16(x):
        return l2_normalize(torch.tensor(x, dtype=torch.float32, device=dev)
                            ).to(torch.bfloat16).contiguous()

    worst = [0.0, 0]
    video = []
    for t_total, h, w, c, radius, p, topk in BF16_SMALL_CASES:
        rng = np.random.RandomState(t_total * 1000 + h * 10 + c)
        video.append((bf16(rng.randn(t_total, h, w, c)), radius, topk, p,
                      False, f'bf16 small {t_total}x{h}x{w}x{c}'))
    tie = np.random.RandomState(31).randn(10, 8, 9, 16)
    tie[3], tie[7] = tie[1], tie[5]
    video.append((bf16(tie), 3.0, 5, 4, True, 'bf16 tie'))
    with exact_fp32():
        for feats, radius, topk, p, exact_src, what in video:
            plain = video_topk_affinity_reference(feats, radius, 0.07, topk,
                                                  p)
            row1 = video_topk_affinity_cuda(feats, radius, 0.07, topk, p)
            fp32 = video_topk_affinity_cuda(feats.float(), radius, 0.07,
                                            topk, p)
            torch.cuda.synchronize()
            err, mismatch, _ = compare((row1[0][1:], row1[1][1:]),
                                       (plain[0][1:], plain[1][1:]),
                                       exact_src, what)
            if not same_lists(row1, fp32):
                raise AssertionError(f'{what}: bf16 differs from fp32 on '
                                     'the widened features')
            for extract, early_exit in V1_MODES:
                v1 = video_topk_affinity_v1_cuda(
                    feats, radius, 0.07, topk, p, early_exit=early_exit,
                    extract=extract)
                torch.cuda.synchronize()
                if not same_lists(v1, row1):
                    raise AssertionError(f'{what} v1 {extract}/'
                                         f'{early_exit}: differs from row 1')
            worst = [max(worst[0], err), max(worst[1], mismatch)]
        local = []
        for h, w, c, radius, valid, topk, k in BF16_SMALL_LOCAL_CASES:
            rng = np.random.RandomState(h * 1000 + w * 10 + c)
            local.append((bf16(rng.randn(h, w, c)),
                          bf16(rng.randn(len(valid), h, w, c)),
                          rng.rand(len(valid), h, w, k), valid, radius, topk,
                          False, f'bf16 small local {h}x{w}x{c}'))
        rng = np.random.RandomState(37)
        bank = rng.randn(4, 7, 9, 16)
        bank[2] = bank[0]
        local.append((bf16(rng.randn(7, 9, 16)), bf16(bank),
                      rng.rand(4, 7, 9, 4), (1, 1, 1, 1), 3.0, 6, True,
                      'bf16 local tie'))
        for (query, bank, vals, valid, radius, topk, exact_src,
             what) in local:
            vals = torch.tensor(vals, dtype=torch.float32, device=dev)
            valid = torch.tensor(valid, dtype=torch.int32, device=dev)
            (err, _, mismatch, _), out = run_local(
                query, bank, vals, valid, radius, topk, exact_src, what)
            fp32 = local_topk_attend_cuda(query.float(), bank.float(), vals,
                                          valid, radius, 0.07, topk)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, fp32)):
                raise AssertionError(f'{what}: bf16 differs from fp32 on '
                                     'the widened features')
            worst = [max(worst[0], err), max(worst[1], mismatch)]
    return worst


def bf16_full_checks(dev, smi_name, c, radius):
    """Rows 1-3's bf16 entries at the DAVIS-480p shapes (60x107 cells, P =
    20, top-10) on random L2-normalised features cast to bf16: rows 1-2 at
    T = 24 (times also at T = 48), row 3 one step against F = 21 slots (K
    = 4). Each against its plain version (widened features, cuBLAS fp32,
    TF32 off) with the fp32 gates, against its fp32 entry on the widened
    features bit for bit, row 2 against row 1 bit for bit; the bf16 and
    fp32 entries' times in turn, that of a widening copy and the fp32
    entry (what a bf16 entry spares), the plain version's, and the bounds
    (``bf16_bounds``). Returns {row: numbers}."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (l2_normalize, local_topk_attend_cuda,
                                   local_topk_attend_reference,
                                   video_topk_affinity_cuda,
                                   video_topk_affinity_reference,
                                   video_topk_affinity_v1_cuda)
    h, w, p, topk, k_classes = 60, 107, 20, 10, 4
    g = torch.Generator(device=dev).manual_seed(c + 3)
    b48 = l2_normalize(torch.randn((48, h, w, c), device=dev, generator=g)
                       ).to(torch.bfloat16).contiguous()
    b24 = b48[:24].contiguous()
    w48, w24 = b48.float(), b24.float()
    out = {}
    with exact_fp32():
        plain = video_topk_affinity_reference(b24, radius, 0.07, topk, p)
        row1 = video_topk_affinity_cuda(b24, radius, 0.07, topk, p)
        fp32 = video_topk_affinity_cuda(w24, radius, 0.07, topk, p)
        v1 = video_topk_affinity_v1_cuda(b24, radius, 0.07, topk, p,
                                         early_exit=True, extract='perframe')
        torch.cuda.synchronize()
        err, mismatch, share = compare((row1[0][1:], row1[1][1:]),
                                       (plain[0][1:], plain[1][1:]), False,
                                       f'bf16 full row 1 C={c}')
        if not same_lists(row1, fp32) or not same_lists(v1, row1):
            raise AssertionError(f'bf16 full C={c}: row 1 differs from its '
                                 'fp32 entry or row 2 from row 1')
        del plain, row1, fp32, v1

        def row1_call(feats):
            return video_topk_affinity_cuda(feats, radius, 0.07, topk, p)

        def v1_call(feats):
            return video_topk_affinity_v1_cuda(
                feats, radius, 0.07, topk, p, early_exit=True,
                extract='perframe')

        def widen_call(feats):  # the alternative to a bf16 entry
            return row1_call(feats.float())

        ms = {}
        for key, fn, feats in (('b24', row1_call, b24),
                               ('f24', row1_call, w24),
                               ('wf24', widen_call, b24),
                               ('b48', row1_call, b48),
                               ('f48', row1_call, w48),
                               ('v24', v1_call, b24),
                               ('v48', v1_call, b48)):
            ms[key] = cuda_ms(lambda: fn(feats))
        plain24 = cuda_ms(lambda: video_topk_affinity_reference(
            b24, radius, 0.07, topk, p), runs=3)
    (f24, n24), (f48, n48) = [affinity_work(t, h, w, c, radius, topk, p)
                              for t in (24, 48)]
    half = 2.0 * h * w * c  # a bf16 frame is half an fp32 one's bytes
    bd24 = bf16_bounds(f24, n24 - half * 24, smi_name)
    bd_steady = bf16_bounds((f48 - f24) / 24, (n48 - n24 - half * 24) / 24,
                            smi_name)
    for row, k24, k48 in (('row1', ms['b24'], ms['b48']),
                          ('row2', ms['v24'], ms['v48'])):
        out[row] = dict(
            shape=[24, h, w, c], max_abs_err=err, src_mismatch=mismatch,
            src_mismatch_share=share, ms=k24, ms_per_frame=k24 / 23,
            steady_ms_per_frame=(k48 - k24) / 24,
            plain_ms=plain24, plain_ms_per_frame=plain24 / 23,
            bound_ms_per_frame=bd24['bound_ms'] / 23,
            ffma_bound_ms_per_frame=bd24['ffma_bound_ms'] / 23,
            steady_bound_ms_per_frame=bd_steady['bound_ms'],
            steady_ffma_bound_ms_per_frame=bd_steady['ffma_bound_ms'],
            bound_share=bd24['bound_ms'] / k24,
            ffma_share=bd24['ffma_bound_ms'] / k24,
            steady_bound_share=bd_steady['bound_ms'] * 24 / (k48 - k24),
            steady_ffma_share=bd_steady['ffma_bound_ms'] * 24 / (k48 - k24),
            **bd24)
    out['row1'].update(fp32_ms=ms['f24'], widen_fp32_ms=ms['wf24'],
                       fp32_ms_per_frame=ms['f24'] / 23,
                       fp32_steady_ms_per_frame=(ms['f48'] - ms['f24']) / 24)
    del b48, b24, w48, w24
    torch.cuda.empty_cache()

    f = p + 1
    g = torch.Generator(device=dev).manual_seed(c + 4)
    bank = l2_normalize(torch.randn((f, h, w, c), device=dev, generator=g)
                        ).to(torch.bfloat16).contiguous()
    query = l2_normalize(torch.randn((h, w, c), device=dev, generator=g)
                         ).to(torch.bfloat16).contiguous()
    vals = torch.rand((f, h, w, k_classes), device=dev, generator=g)
    valid = torch.ones(f, dtype=torch.int32, device=dev)
    (err, logit_err, mismatch, share), got = run_local(
        query, bank, vals, valid, radius, topk, False,
        f'bf16 full row 3 C={c}')
    qf, bf = query.float(), bank.float()
    with exact_fp32():
        fp32 = local_topk_attend_cuda(qf, bf, vals, valid, radius, 0.07, topk)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, fp32)):
            raise AssertionError(f'bf16 full row 3 C={c}: differs from its '
                                 'fp32 entry on the widened features')
        k_ms = cuda_ms(lambda: local_topk_attend_cuda(
            query, bank, vals, valid, radius, 0.07, topk))
        f_ms = cuda_ms(lambda: local_topk_attend_cuda(
            qf, bf, vals, valid, radius, 0.07, topk))
        wf_ms = cuda_ms(lambda: local_topk_attend_cuda(
            query.float(), bank.float(), vals, valid, radius, 0.07, topk))
        p_ms = cuda_ms(lambda: local_topk_attend_reference(
            query, bank, vals, valid, radius, 0.07, topk), runs=3)
    flops, nbytes = step_work(h, w, c, radius, topk, k_classes, f, f)
    bd = bf16_bounds(flops, nbytes - 2.0 * h * w * c * (1 + f), smi_name)
    out['row3'] = dict(h=h, w=w, C=c, F=f, K=k_classes, max_abs_err=err,
                       max_logit_err=logit_err, src_mismatch=mismatch,
                       src_mismatch_share=share, ms=k_ms, fp32_ms=f_ms,
                       widen_fp32_ms=wf_ms,
                       plain_ms=p_ms, bound_share=bd['bound_ms'] / k_ms,
                       ffma_share=bd['ffma_bound_ms'] / k_ms, **bd)
    return out


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def bench_depth(dev, smi_name, name, depth, neighbor_range, floor, videos,
                check_comm):
    """One depth of the bench_cfg phase (module docstring): the kernels in
    bf16, then the path; ``comm_checks`` in its NCCL group where
    ``check_comm``. Returns the kernel checks' numbers and each row's bf16
    launches on the path."""
    import torch
    import torch.distributed as dist
    import vfs_tpu_torch.apis as apis
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.ops import (local_topk_attend_cuda, propagation,
                                   video_topk_affinity_cuda,
                                   video_topk_affinity_reference,
                                   video_topk_affinity_v1_cuda)
    from vfs_tpu_torch.ops.yuv import rgb_to_yuv420, yuv420_to_rgb

    c = 256 if depth == 18 else 1024
    radius = float(neighbor_range // 2)
    kernels = bf16_full_checks(dev, smi_name, c, radius)
    test_cfg = bench_test_cfg(neighbor_range)

    def tracker(dtype):
        model = build_model(dict(type='VanillaTracker', backbone=dict(
            type='ResNet', depth=depth, out_indices=(3,), dtype=dtype)),
            test_cfg=dict(test_cfg))
        model.init_weights(torch.Generator().manual_seed(0))
        return model

    model = tracker('bfloat16')
    dataset = [dict(imgs=imgs, ref_seg_map=seg, img_meta=meta)
               for imgs, seg, meta in videos]
    frames = sum(v[0].shape[0] for v in videos)
    apis.single_process_test(model, dataset)  # cold: cuDNN's first calls

    # the path, counted: the production eval loop over the three videos
    counted = (video_topk_affinity_cuda, video_topk_affinity_v1_cuda,
               local_topk_attend_cuda)
    for fn in counted:
        fn.launches = fn.bf16_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    preds = apis.single_process_test(model, dataset)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    row1_bf16 = video_topk_affinity_cuda.bf16_launches
    if row1_bf16 != len(videos) or video_topk_affinity_cuda.launches \
            != row1_bf16:
        raise AssertionError(f'{name}: {row1_bf16} bf16 launches of row 1 '
                             f'for {len(videos)} videos')
    for (imgs, _, _), pred in zip(videos, preds):
        if pred.shape != imgs.shape[:3] or pred.dtype != np.uint8 \
                or pred.max() >= BENCH_NUM_CLASSES:
            raise AssertionError(f'{name}: bad predictions {pred.shape}')

    # transport and extraction on video 0
    imgs0, seg0, meta0 = videos[0]
    t0 = time.time()
    packed_host = rgb_to_yuv420(imgs0)
    pack_ms = (time.time() - t0) * 1e3
    copy_ms = {}
    for key, host in (('yuv420', packed_host), ('rgb', imgs0)):
        walls = []
        for _ in range(3):
            src = torch.from_numpy(host)
            torch.cuda.synchronize()
            t0 = time.time()
            src.to(dev)
            torch.cuda.synchronize()
            walls.append((time.time() - t0) * 1e3)
        copy_ms[key] = statistics.median(walls)
    packed = model.preload(imgs0, device=dev)
    yuv = tuple(packed.hw) + (packed.convention,)
    mean = torch.tensor(BENCH_NORM['mean'], device=dev)
    std = torch.tensor(BENCH_NORM['std'], device=dev)
    rgb_dev = torch.as_tensor(imgs0, device=dev)
    fp32_model = tracker('float32')
    fp32_model.backbone.load_state_dict(model.backbone.state_dict())
    t_total = imgs0.shape[0]
    ext = {key: cuda_ms(lambda: m._extract_feats(x, 20, mean, std, y),
                        runs=3) / t_total
           for key, m, x, y in (('bf16', model, packed.frames, yuv),
                                ('fp32', fp32_model, packed.frames, yuv),
                                ('bf16_rgb_input', model, rgb_dev, None))}
    del fp32_model, rgb_dev
    torch.cuda.empty_cache()
    # the card's unpack against the CPU's
    n = BENCH_AGREE_FRAMES
    card = yuv420_to_rgb(packed.frames[:n], *yuv).cpu()
    cpu = yuv420_to_rgb(torch.from_numpy(packed_host[:n]), *yuv)
    yuv_err = float((card - cpu).abs().max())
    if yuv_err > 1e-3:
        raise AssertionError(f'{name}: yuv420_to_rgb card vs CPU {yuv_err}')

    # bench.py's agreement checks on video 0's first 20 frames, and the
    # v1 engine and the scan in bf16, counted
    short = imgs0[:n]
    runs = {}
    saved = dict(model.test_cfg)
    for key, over, patch in (
            ('tiled', dict(backend='tiled'), None),
            ('fp32', dict(backend='pallas_video',
                          pallas_precision='float32'), None),
            ('plain', dict(backend='pallas_video',
                           pallas_precision='float32'),
             video_topk_affinity_reference),
            ('bf16', dict(backend='pallas_video'), None),
            ('bf16_v1', dict(backend='pallas_video', video_engine='v1',
                             video_extract='perframe'), None),
            ('bf16_scan', dict(backend='pallas'), None)):
        model.test_cfg.update(over)
        for fn in counted:
            fn.launches = fn.bf16_launches = 0
        with contextlib.ExitStack() as stack:
            if patch is not None:
                stack.enter_context(patched(propagation,
                                            'video_topk_affinity',
                                            lambda _: patch))
            runs[key] = (model.forward_test(short, seg0, [meta0])[0],
                         [fn.bf16_launches for fn in counted])
        model.test_cfg.clear()
        model.test_cfg.update(saved)
    agree = {key: float((runs[key][0] == runs[ref][0]).mean())
             for key, ref in (('tiled', 'fp32'), ('plain', 'fp32'),
                              ('bf16', 'fp32'), ('bf16_v1', 'bf16'),
                              ('bf16_scan', 'bf16'))}
    row2_bf16 = runs['bf16_v1'][1][1]
    row3_bf16 = runs['bf16_scan'][1][2]
    if (agree['tiled'] < 0.999 or agree['plain'] < 0.999
            or agree['bf16'] < floor or agree['bf16_v1'] != 1.0
            or agree['bf16_scan'] < 0.999 or runs['bf16'][1][0] != 1
            or row2_bf16 != 1 or row3_bf16 != n - 1):
        raise AssertionError(f'{name}: agreement {agree}, bf16 launches '
                             f'{ {k: v[1] for k, v in runs.items()} }')

    # eval over processes: a one-rank NCCL group against the single
    # process on the three videos' first 20 frames
    clips = [dict(d, imgs=d['imgs'][:n]) for d in dataset]
    single = apis.single_process_test(model, clips)
    dist.init_process_group('nccl', init_method=f'tcp://localhost:'
                            f'{free_port()}', rank=0, world_size=1)
    try:
        multi = apis.multi_process_test(model, clips)
        comm = {'comm': comm_checks(dev)} if check_comm else {}
    finally:
        dist.destroy_process_group()
    if len(multi) != len(single) or not all(
            np.array_equal(a, b) for a, b in zip(multi, single)):
        raise AssertionError(f'{name}: multi_process_test differs from '
                             'single_process_test')

    emit({'phase': 'bench_cfg', 'model': name, 'card': smi_name,
          'test_cfg': test_cfg, 'backbone_dtype': 'bfloat16',
          'videos': [list(v[0].shape) for v in videos], 'frames': frames,
          'e2e_s': e2e_s, 'e2e_fps': frames / e2e_s,
          'peak_memory_gb': peak_gb,
          'extract_ms_per_frame': ext,
          'row1_ms_per_frame': dict(
              bf16=kernels['row1']['ms_per_frame'],
              fp32=kernels['row1']['fp32_ms_per_frame'],
              bf16_steady=kernels['row1']['steady_ms_per_frame'],
              fp32_steady=kernels['row1']['fp32_steady_ms_per_frame']),
          'bytes_per_frame': dict(yuv420=int(packed_host[0].nbytes),
                                  rgb=int(imgs0[0].nbytes)),
          'host_pack_ms_per_frame': pack_ms / t_total,
          'copy_ms_per_frame': {k: v / t_total for k, v in copy_ms.items()},
          'copy': 'pageable, synchronous, in the prefetch thread',
          'yuv420_card_vs_cpu_max_abs': yuv_err,
          'agreement': agree, 'bf16_floor': floor,
          'bf16_path_launches': dict(row1=row1_bf16 + 1, row2=row2_bf16,
                                     row3=row3_bf16),
          'multi_process_equal': True, **comm, 'kernels': kernels})
    return kernels, (row1_bf16 + runs['bf16'][1][0], row2_bf16, row3_bf16)


def comm_checks(dev):
    """Slice 14's ``parallel.comm`` helpers in the one-rank NCCL group
    (their collectives run; on one rank each is the identity, as the JAX
    functions are on one device): the gather carries no gradient, the
    shuffle is a permutation that the unshuffle undoes, the gradient mean
    is the gradient, the sharded gather keeps the identity's gradient."""
    import torch
    from vfs_tpu_torch.parallel import (allreduce_grads, batch_shuffle,
                                        batch_unshuffle, concat_all_gather,
                                        concat_all_gather_sharded)
    x = torch.arange(48.0, device=dev).reshape(12, 4).requires_grad_()
    gathered = concat_all_gather(x)
    gen = torch.Generator(device=dev).manual_seed(0)
    shuffled, inverse = batch_shuffle(x.detach(), gen)
    grads = {'w': torch.arange(6.0, device=dev),
             'b': torch.ones(2, dtype=torch.float64, device=dev)}
    want = {k: v.clone() for k, v in grads.items()}
    allreduce_grads(grads)
    concat_all_gather_sharded(x).pow(2).sum().backward()
    checks = dict(
        gather=bool(torch.equal(gathered, x) and not gathered.requires_grad),
        shuffle=bool(torch.equal(batch_unshuffle(shuffled, inverse), x)
                     and not torch.equal(shuffled, x) and torch.equal(
                         shuffled[:, 0].sort().values, x[:, 0].detach())),
        allreduce=all(torch.equal(grads[k], want[k]) for k in grads),
        sharded_grad=bool(torch.equal(x.grad, 2 * x.detach())))
    if not all(checks.values()):
        raise AssertionError(f'comm helpers in the NCCL group: {checks}')
    return checks


def phase_bench_cfg(dev, smi_name):
    """The JAX bench's eval configuration (module docstring, phase 11) for
    r18 and r50. Returns {row: its bf16 entry for the kernels line}."""
    import torch
    small_err, small_mismatch = bf16_small_checks(dev)
    emit({'phase': 'bench_cfg', 'small': True, 'max_abs_err': small_err,
          'src_mismatch': small_mismatch,
          'cases': [list(c) for c in (BF16_SMALL_CASES
                                      + BF16_SMALL_LOCAL_CASES)]})
    videos = bench_videos()
    out = {row: dict(launches=0) for row in ('row1', 'row2', 'row3')}
    for i, (name, depth, nr, floor) in enumerate(BENCH_MODELS):
        kernels, launches = bench_depth(dev, smi_name, name, depth, nr, floor,
                                        videos, check_comm=i == 0)
        for row, n in zip(('row1', 'row2', 'row3'), launches):
            out[row]['launches'] += n
            out[row][name] = kernels[row]
        torch.cuda.empty_cache()
    return out


# The siamfc phase (module docstring, phase 12): bench.py's tracking block
# (bench.py:84-88,410-451) and its fixture (tools/analysis/bench_track.py
# make_fixture, copied into siamfc_tpu_torch.fixtures): the script imports
# nothing of the JAX package.
# bench.py's 20-fps floor is a TPU figure and is not carried. Its
# precision floor, 0.95, is not met by the JAX package's own seeded
# weights on this fixture (0.755 in its last recorded bench run,
# BENCH_r05.json; 0.78 for the same draw through the port on an H100,
# precision_survey_torch.py), and seeded draws spread from 0.02 to 1.0
# (the same script). The floor here is bench.py's rule, known-good minus
# a margin, on the port's seed-0 weights: 0.625 on the card and the CPU
# alike (the card's boxes are the CPU's), less 0.025.
SIAMFC_DIR = os.path.join(ROOT, 'projects', 'siamfc')
TRACK_SEQS, TRACK_FRAMES, TRACK_HW, TRACK_BATCH = 4, 50, (360, 640), 2
TRACK_GATES = dict(box_agreement_px=2.0, precision_20=0.60)
# card against CPU: the first frames of one sequence
CPU_FRAMES = 8
# the card's raw responses against the CPU's, relative to their largest
# magnitude (fp32 convolutions summed in other orders; TF32 off on both)
RESP_REL_TOL = 1e-4
# the linear probe: GOT-10k-layout sequences, three steps of the config's
# batch_size (8) with its num_workers (8) loader processes
PROBE_SEQS, PROBE_FRAMES, PROBE_HW = 24, 6, (360, 640)
PROBE_TIMED_STEPS = 10
# the probe's fp32 loss on the card against the fp64 step: the train
# phase's form (CARD_CPU_FACTOR x the CPU's distance) plus this share of
# the loss. Its response is a 115,200-term sum (15x15x512) a cell, which
# cuDNN sums in another order than the CPU: the card's fp32 loss lay
# 1.8e-6 from the fp64 one (the CPU's 1.3e-7) on an H100, past the
# train phase's 1e-6; the gradients keep the train phase's bound.
PROBE_LOSS_RTOL = 1e-5


def make_got10k(root, n_seqs, n_frames, hw):
    """GOT-10k layout, ``root/<seq>/%08d.jpg`` + ``groundtruth.txt`` (one
    1-indexed ltwh row a frame): a moving box of its own size and colour
    on noise, a sequence each."""
    import cv2
    h, w = hw
    rng = np.random.RandomState(11)
    for s in range(n_seqs):
        d = os.path.join(root, f'GOT-10k_Train_{s:06d}')
        os.makedirs(d)
        base = rng.randint(0, 80, (h, w, 3), np.uint8)
        color = rng.randint(140, 255, 3).tolist()
        bw, bh = rng.randint(40, 120), rng.randint(40, 120)
        x0, y0 = rng.randint(0, w // 2), rng.randint(0, h // 2)
        rows = []
        for t in range(n_frames):
            img = base.copy()
            x, y = min(x0 + 4 * t, w - bw - 1), min(y0 + 2 * t, h - bh - 1)
            img[y:y + bh, x:x + bw] = color
            cv2.imwrite(os.path.join(d, f'{t + 1:08d}.jpg'), img)
            rows.append([x + 1, y + 1, bw, bh])
        np.savetxt(os.path.join(d, 'groundtruth.txt'), np.array(rows),
                   fmt='%d', delimiter=',')


def siamfc_tracker(cfg, dev, pth, device_crops=True):
    """A tracker of ``cfg`` on ``dev`` with seed-0 weights
    (``init_weights``: the JAX package's initialisers), the backbone then
    loaded from the ``.pth`` when one is given."""
    import torch
    from siamfc_tpu_torch import TrackerSiamFC
    cfg = dict(cfg, device_crops=device_crops)
    tracker = TrackerSiamFC(cfg, device=dev)
    tracker.init_weights(pretrained=pth,
                         generator=torch.Generator().manual_seed(0))
    return tracker


def track_mode(mode, tracker, exp, pairs):
    """One tracking mode over the fixture, warmed on three frames of the
    first sequence outside the clock (bench_track.run_mode). Returns
    (fps over the tracked frames, frame 0 left out; boxes by sequence)."""
    import torch
    warm = [(pairs[0][0][:3], pairs[0][1])]
    if mode == 'host_seq':
        tracker.track(*warm[0])
    else:
        tracker.track_batch(warm, batch_size=TRACK_BATCH)
    torch.cuda.synchronize()
    t0 = time.time()
    if mode == 'host_seq':
        res = exp.run(tracker)
    elif mode == 'dev_batch2':
        res = exp.run(tracker, batch_size=TRACK_BATCH)
    else:
        res = dict(zip(exp.seq_names, tracker.track_batch(
            pairs, batch_size=int(mode.rsplit('_', 1)[1]))))
    torch.cuda.synchronize()
    wall = time.time() - t0
    frames = sum(len(f) - 1 for f, _ in pairs)
    return frames / wall, {name: boxes for name, (boxes, _) in res.items()}


def measure_tracking(cfg, dev, pth, root):
    """bench.py's measure_tracking on the port: host_seq (host cv2 crops,
    sequential) and dev_batch2 (device crops, track_batch(2) over two
    interleaved streams) through ExperimentOTB.run, gated on the device
    path's box agreement with the host path and its precision@20; plus
    track_batch over every sequence at once (K = 8, capped by the
    fixture's sequences) and the peak memory of dev_batch2."""
    import torch
    from siamfc_tpu_torch import ExperimentOTB, eval_metrics
    from siamfc_tpu_torch.otb import _load_otb_seq
    exp = ExperimentOTB(root, result_dir=os.path.join(root, 'res'),
                        report_dir=os.path.join(root, 'rep'))
    seqs = [_load_otb_seq(d) for d in exp.seq_dirs]
    pairs = [(f, a[0]) for f, a in seqs]
    host = siamfc_tracker(cfg, dev, pth, device_crops=False)
    host_fps, host_boxes = track_mode('host_seq', host, exp, pairs)
    tracker = siamfc_tracker(cfg, dev, pth)
    torch.cuda.reset_peak_memory_stats()
    dev_fps, dev_boxes = track_mode('dev_batch2', tracker, exp, pairs)
    peak = torch.cuda.max_memory_allocated()
    batch8_fps, batch8_boxes = track_mode('batch_8', tracker, exp, pairs)
    box_dev = max(float(np.abs(dev_boxes[n] - host_boxes[n]).max())
                  for n in dev_boxes)
    box_b8 = max(float(np.abs(batch8_boxes[n] - dev_boxes[n]).max())
                 for n in dev_boxes)
    prec = [eval_metrics(dev_boxes[n], anno)[1][20]
            for n, (_, anno) in zip(exp.seq_names, seqs)]
    report = exp.report({n: (b, None) for n, b in dev_boxes.items()})
    out = dict(dev_batch2_fps=dev_fps, host_seq_fps=host_fps,
               track_batch8_fps=batch8_fps, box_agreement_px=box_dev,
               track_batch8_vs_dev_batch2_px=box_b8,
               precision_20=float(np.mean(prec)),
               success_score=report['success_score'],
               peak_memory_bytes=peak)
    if box_dev > TRACK_GATES['box_agreement_px'] or \
            out['precision_20'] < TRACK_GATES['precision_20'] or \
            box_b8 > TRACK_GATES['box_agreement_px']:
        raise AssertionError(f'siamfc tracking gates ({TRACK_GATES}): '
                             f'{out}')
    return out, tracker, pairs


def frame_split(tracker, pairs):
    """Per-frame split of the device path, one track_batch(2) stream over
    the fixture: host clocks around the frame reads and the region cuts
    with their taps; CUDA events around the upload, the crops, the
    backbone (the exemplar passes included), the xcorr, the post and the
    readback. ms per tracked frame."""
    import torch
    import siamfc_tpu_torch.tracker as trk
    walls = dict(read=[], region=[])
    spans = {k: [] for k in ('upload', 'crops', 'backbone', 'xcorr',
                             'post', 'readback')}
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(trk.ops, 'read_image',
                                    host_timer(walls['read'])))
        stack.enter_context(patched(trk.TrackerSiamFC, '_make_region',
                                    host_timer(walls['region'])))
        for owner, attr, key in (
                (trk.TrackerSiamFC, '_upload', 'upload'),
                (trk, 'device_scale_crops', 'crops'),
                (trk.Net, 'features', 'backbone'),
                (type(tracker.net.head), 'forward', 'xcorr'),
                (trk, 'device_response_post', 'post'),
                (trk.TrackerSiamFC, '_readback', 'readback')):
            stack.enter_context(patched(owner, attr, span_timer(spans[key])))
        torch.cuda.synchronize()
        t0 = time.time()
        tracker.track_batch(pairs, batch_size=TRACK_BATCH)
        torch.cuda.synchronize()
        wall = time.time() - t0
    frames = sum(len(f) for f, _ in pairs)
    split = {f'{k}_ms': 1e3 * sum(v) / frames for k, v in walls.items()}
    split.update({f'{k}_ms': spans_ms(v) / frames for k, v in spans.items()})
    split['wall_ms'] = 1e3 * wall / frames
    return split


def host_timer(walls):
    """``patched`` maker: append each call's host seconds to ``walls``."""
    def make(fn):
        def timed(*args, **kwargs):
            t0 = time.time()
            out = fn(*args, **kwargs)
            walls.append(time.time() - t0)
            return out
        return timed
    return make


def card_cpu_tracking(cfg, dev, pth, pairs):
    """The same tracker on the card and on the CPU over the first
    CPU_FRAMES frames of one sequence: the card's device crops equal the
    CPU's bit for bit on every frame's region, the raw responses agree
    within RESP_REL_TOL of their magnitude, the (scale_id, y, x) peaks and
    the boxes are equal. Then device_scale_crops on the card against cv2's
    host crops on test_siamfc.py's downscale and upscale cases."""
    import torch
    from siamfc_tpu_torch import ops
    from siamfc_tpu_torch.device_crops import (device_response_post,
                                               device_scale_crops,
                                               make_region, make_taps)
    files, box = pairs[0][0][:CPU_FRAMES], pairs[0][1]
    card = siamfc_tracker(cfg, dev, pth)
    cpu = siamfc_tracker(cfg, 'cpu', pth)
    inputs = []

    def record(fn):
        def kept(self, kernel, region, taps):
            inputs.append((region, taps))
            return fn(self, kernel, region, taps)
        return kept
    with patched(type(cpu), '_region_responses', record):
        cpu_boxes, _ = cpu.track(files, box)
    card_boxes, _ = card.track(files, box)
    crops_equal = resp_err = 0.0
    peaks_equal = True
    card.init(ops.read_image(files[0]), box)
    cpu.init(ops.read_image(files[0]), box)
    for region, taps in inputs:
        a = device_scale_crops(torch.from_numpy(region).to(dev),
                               torch.from_numpy(taps).to(dev)).cpu()
        b = device_scale_crops(torch.from_numpy(region),
                               torch.from_numpy(taps))
        crops_equal = max(crops_equal, float((a - b).abs().max()))
        ra = card._region_responses(card.kernel, region, taps)
        rb = cpu._region_responses(cpu.kernel, region, taps)
        resp_err = max(resp_err, float((ra.cpu() - rb).abs().max()
                                       / rb.abs().max()))
        up, hann = card._post_consts(ra.shape[-1])
        pa = device_response_post(ra, up, hann, cfg['scale_penalty'],
                                  cfg['window_influence'])
        up, hann = cpu._post_consts(rb.shape[-1])
        pb = device_response_post(rb, up, hann, cfg['scale_penalty'],
                                  cfg['window_influence'])
        peaks_equal &= all(torch.equal(x.cpu(), y) for x, y in zip(pa, pb))
    box_err = float(np.abs(card_boxes - cpu_boxes).max())
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (360, 640, 3), np.uint8)
    center = np.array([181.3, 322.8], np.float32)
    avg = img.mean(axis=(0, 1))
    cv2_cases = {}
    for name, sizes in (('downscale', [258.9, 280.0, 310.2]),
                        ('upscale', [96.0, 140.5, 200.9])):
        host = np.stack([ops.crop_and_resize(img, center, s, 255,
                                             border_value=avg)
                         for s in sizes]).astype(np.float32)
        region, offs, sz = make_region(img, center, sizes, avg)
        got = device_scale_crops(
            torch.from_numpy(region).to(dev),
            torch.from_numpy(make_taps(offs, sz, 255)).to(dev)).cpu().numpy()
        d = np.abs(got - host)
        cv2_cases[name] = dict(max_abs=float(d.max()),
                               share_off=float((d > 0).mean()))
    out = dict(frames=len(files), crops_max_abs_card_cpu=crops_equal,
               resp_rel_err_card_cpu=resp_err, peaks_equal=peaks_equal,
               boxes_max_abs_card_cpu=box_err, crops_vs_cv2=cv2_cases)
    if crops_equal or not peaks_equal or box_err or \
            resp_err > RESP_REL_TOL or cv2_cases['downscale']['max_abs'] \
            or cv2_cases['upscale']['max_abs'] > 1 or \
            cv2_cases['upscale']['share_off'] >= 3e-3:
        raise AssertionError(f'siamfc card vs CPU: {out}')
    return out


def r50_sequence(dev, pairs):
    """One sequence through the depth >= 50 branch of the CLI's config
    merge (2048 channels, out_scale 1e-5), seeded weights, device crops."""
    import torch
    import train_siamfc_torch
    from siamfc_tpu_torch import TrackerSiamFC
    cfg = train_siamfc_torch.build_cfg(train_siamfc_torch.parse_args(
        [CONFIG_R50]))
    tracker = TrackerSiamFC(cfg, device=dev)
    tracker.init_weights(generator=torch.Generator().manual_seed(0))
    files, box = pairs[0]
    tracker.track(files[:3], box)
    torch.cuda.synchronize()
    t0 = time.time()
    boxes, _ = tracker.track(files, box)
    torch.cuda.synchronize()
    fps = (len(files) - 1) / (time.time() - t0)
    if not np.isfinite(boxes).all() or cfg['out_channels'] != 2048:
        raise AssertionError(f'siamfc r50: {cfg["out_channels"]}, {boxes}')
    return dict(out_channels=cfg['out_channels'],
                out_scale=cfg['out_scale'], frames=len(files), fps=fps)


def probe_grads(cfg, state, batch, device, dtype):
    """One probe step's loss and head gradients (fp64 on the CPU) from
    ``state`` on ``batch`` = (z, x) float crops."""
    import torch
    from siamfc_tpu_torch import TrackerSiamFC
    from siamfc_tpu_torch.tracker import IMG_MEAN, IMG_STD
    tracker = TrackerSiamFC(cfg, device=device)
    tracker.net.load_state_dict(state)
    tracker.net.to(dtype)
    z, x = (tracker._upload((a - IMG_MEAN) / IMG_STD).to(dtype)
            for a in batch)
    from vfs_tpu_torch import exact_fp32
    with exact_fp32():
        loss = tracker._loss(z, x, tracker._labels(z.shape[0], z, x))
        loss.backward()
    return float(loss.detach()), {n: p.grad.detach().double().cpu()
                         for n, p in tracker.net.head.named_parameters()}


def probe_card_vs_cpu(cfg, state, batch, dev):
    """One probe step on the card and the CPU (module docstring,
    tolerances of the train phase): fp64 equal within 1e-9, the card's
    fp32 as close to the fp64 step as the CPU's (the loss with
    PROBE_LOSS_RTOL's slack)."""
    import torch
    cpu = torch.device('cpu')
    l64, g64 = probe_grads(cfg, state, batch, cpu, torch.float64)
    card64 = probe_grads(cfg, state, batch, dev, torch.float64)
    cpu32 = probe_grads(cfg, state, batch, cpu, torch.float32)
    card32 = probe_grads(cfg, state, batch, dev, torch.float32)
    err64, name64 = grad_error(card64[1], g64)
    err_cpu, _ = grad_error(cpu32[1], g64)
    err_card, name = grad_error(card32[1], g64)
    if err64 > 1e-9 or abs(card64[0] - l64) > 1e-9 * abs(l64):
        raise AssertionError(f'probe card vs CPU in fp64: {name64} '
                             f'{err64}, loss {card64[0]} vs {l64}')
    if err_card > CARD_CPU_FACTOR * err_cpu + CARD_CPU_FLOOR or \
            abs(card32[0] - l64) > CARD_CPU_FACTOR * abs(cpu32[0] - l64) \
            + PROBE_LOSS_RTOL * abs(l64):
        raise AssertionError(
            f'probe card vs CPU in fp32: {name} off the fp64 step by '
            f'{err_card} (the CPU by {err_cpu}), loss {card32[0]} '
            f'({cpu32[0]} on the CPU, {l64} in fp64)')
    return dict(loss_fp32=[card32[0], cpu32[0]], loss_fp64=[card64[0], l64],
                grad_rel_l2_fp64_card_cpu=err64,
                grad_rel_l2_fp32_card_exact=err_card,
                grad_rel_l2_fp32_cpu_exact=err_cpu)


def linear_probe(root, dev, pth):
    """train_siamfc_torch.py in-process on a GOT-10k-layout set with the
    config's batch_size and num_workers for one epoch: every loss finite,
    epoch_1 written, only head parameters changed; a probe step on the
    card against the CPU; the step's ms (CUDA events, median of
    PROBE_TIMED_STEPS on one loader batch)."""
    import torch
    import train_siamfc_torch
    from siamfc_tpu_torch import (Pair, SequenceDataset, SiamFCTransforms,
                                  TrackerSiamFC)
    from vfs_tpu_torch.checkpoint import restore_checkpoint
    got = os.path.join(root, 'got10k')
    make_got10k(got, PROBE_SEQS, PROBE_FRAMES, PROBE_HW)
    work = os.path.join(root, 'probe')
    argv = [CONFIG, '--pretrained', pth, '--got10k-root', got,
            '--otb-root', os.path.join(root, 'no_otb'), '--work-dir', work,
            '--device', str(dev), '--options', 'epoch_num=1',
            'log_interval=1']
    args = train_siamfc_torch.parse_args(argv)
    cfg = train_siamfc_torch.build_cfg(args)
    losses = []
    step = TrackerSiamFC.probe_step

    def record(self, *a):
        losses.append(step(self, *a))
        return losses[-1]
    t0 = time.time()
    with patched(TrackerSiamFC, 'probe_step', lambda fn: record):
        train_siamfc_torch.main(argv)
    wall = time.time() - t0
    losses = [float(v) for v in losses]
    ckpt_path = os.path.join(work, 'checkpoints', 'epoch_1')
    ckpt = restore_checkpoint(ckpt_path)
    init = TrackerSiamFC(cfg, device='cpu')
    init.init_weights(pretrained=pth)
    moved = [n for n, v in init.net.state_dict().items()
             if not torch.equal(ckpt['model'][n], v)]
    if not losses or not np.isfinite(losses).all() or \
            not moved or any(not n.startswith('head.') for n in moved):
        raise AssertionError(f'siamfc probe: losses {losses}, changed '
                             f'{moved}')
    # one loader batch for the timing and the card-vs-CPU step
    dataset = Pair(SequenceDataset(got), SiamFCTransforms(
        cfg['exemplar_sz'], cfg['instance_sz'], cfg['context']))
    items = [dataset[i] for i in range(cfg['batch_size'])]
    batch = tuple(np.stack([it[k] for it in items]) for k in ('z', 'x'))
    tracker = TrackerSiamFC(cfg, device=dev)
    tracker.net.load_state_dict(ckpt['model'])
    optimizer, _ = tracker._build_optimizer(1)
    step_ms = cuda_ms(lambda: tracker.probe_step(optimizer, *batch),
                      runs=PROBE_TIMED_STEPS, warmup=2)
    small = tuple(a[:2] for a in batch)
    checks = probe_card_vs_cpu(cfg, ckpt['model'], small, dev)
    return dict(steps=len(losses), losses=losses, wall_s=wall,
                batch_size=cfg['batch_size'],
                num_workers=cfg['num_workers'],
                params_changed=len(moved), step_ms=step_ms,
                card_vs_cpu_b2=checks)


def phase_siamfc(dev, smi_line):
    """Slice 9's path (module docstring, phase 12): SiamFC tracking at
    r18's full width (default_cfg, seeded weights saved as a torchvision
    .pth) on bench.py's fixture, the card against the CPU, the per-frame
    split, one r50 sequence and the linear probe."""
    import torch
    if SIAMFC_DIR not in sys.path:
        sys.path.insert(0, SIAMFC_DIR)
    from siamfc_tpu_torch import default_cfg
    from siamfc_tpu_torch.fixtures import make_otb_fixture
    t0 = time.time()
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        cfg = dict(default_cfg)
        pth = os.path.join(root, 'r18.pth')
        torch.save(siamfc_tracker(cfg, 'cpu', None).net.backbone.state_dict(),
                   pth)
        otb = os.path.join(root, 'otb')
        make_otb_fixture(otb, TRACK_SEQS, TRACK_FRAMES, TRACK_HW)
        tracking, tracker, pairs = measure_tracking(cfg, dev, pth, otb)
        split = frame_split(tracker, pairs)
        card_cpu = card_cpu_tracking(cfg, dev, pth, pairs)
        r50 = r50_sequence(dev, pairs)
        probe = linear_probe(root, dev, pth)
    emit({'phase': 'siamfc', 'card': smi_line,
          'fixture': dict(seqs=TRACK_SEQS, frames=TRACK_FRAMES,
                          hw=list(TRACK_HW), exemplar_sz=cfg['exemplar_sz'],
                          instance_sz=cfg['instance_sz'],
                          scales=cfg['scale_num']),
          'gates': TRACK_GATES, **tracking, 'split_ms_per_frame': split,
          'card_vs_cpu': card_cpu, 'r50': r50, 'probe': probe,
          'seconds': time.time() - t0})


def phase_analysis(dev, smi_line):
    """Slice 10's analysis CLIs (``vfs_tpu_torch.tools.analysis``), each
    once in-process on the card at full width and cut depth (the
    ANALYSIS_* constants): bench_kernel at the r18 and r50 shapes (no
    variant may fail;
    MODE_AGREEMENT's argmax agreement against pallas_fp32), profile_kernel
    (r18, two repeats), bench_track in its five modes on bench.py's
    tracking fixture's shape (every device and batch mode within
    TRACK_GATES['box_agreement_px'] of host_seq), bench_extract,
    get_flops (r18, r50), benchmark (the eval phase's r50 DAVIS set, one
    video after a warm-up), bench_pretrain (the r18 config, 3 steps, on
    K400_CLIPS clips) and analyze_logs (cal_train_time; plot_curve where
    matplotlib is installed, whose version the line gives)."""
    from vfs_tpu_torch.ops import local_topk_attend_cuda
    from vfs_tpu_torch.tools.analysis import (analyze_logs, bench_extract,
                                              bench_kernel, bench_pretrain,
                                              bench_track, benchmark,
                                              get_flops, profile_kernel)
    from vfs_tpu_torch.utils import JsonlLogger
    t0 = time.time()
    marks = [t0]

    def lap():
        marks.append(time.time())
        return marks[-1] - marks[-2]

    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        for model, c, radius in MODELS:
            before = local_topk_attend_cuda.packed_launches
            res = bench_kernel.main(['--frames', str(BENCH_KERNEL_FRAMES),
                                     '--channels', str(c), '--radius',
                                     str(int(radius))])
            if res['failed'] or local_topk_attend_cuda.packed_launches \
                    == before:
                raise AssertionError(f'bench_kernel {model}: {res}')
            for name, floor in MODE_AGREEMENT.items():
                if res['agreement'][name] < floor:
                    raise AssertionError(f'bench_kernel {model}: {name} '
                                         f'agrees on {res["agreement"][name]}'
                                         f' < {floor}')
            emit({'phase': 'analysis', 'seconds': lap(), 'cli': 'bench_kernel', 'model': model,
                  'card': smi_line, **res})
        res = profile_kernel.main(['--repeats', '2', '--frames',
                                   str(ANALYSIS_FRAMES), '--out',
                                   os.path.join(root, 'prof')])
        emit({'phase': 'analysis', 'seconds': lap(), 'cli': 'profile_kernel', **res})
        res = bench_track.main(['--seqs', str(TRACK_SEQS), '--frames',
                                str(ANALYSIS_TRACK_FRAMES), '--hw',
                                *map(str, TRACK_HW),
                                '--batch', str(TRACK_BATCH), '--root',
                                os.path.join(root, 'otb')])
        worst = max(m['box_vs_host_seq_px'] for n, m in res['modes'].items()
                    if n != 'host_seq')
        if worst > TRACK_GATES['box_agreement_px']:
            raise AssertionError(f'bench_track: boxes {worst} px from '
                                 f'host_seq: {res}')
        emit({'phase': 'analysis', 'seconds': lap(), 'cli': 'bench_track', **res})
        res = bench_extract.main(['--frames', str(ANALYSIS_EXTRACT_FRAMES),
                                  '--steps', '10', '20'])
        emit({'phase': 'analysis', 'seconds': lap(), 'cli': 'bench_extract', **res})
        for config in (CONFIG, CONFIG_R50):
            res = get_flops.main([config])
            emit({'phase': 'analysis', 'seconds': lap(), 'cli': 'get_flops',
                  'config': os.path.relpath(config, ROOT), **res})
        img_root, ann_root, (list_all, _), _, ckpt = write_eval_inputs(root)
        data = eval_argv(root, img_root, ann_root, list_all, ckpt, 'pallas',
                         os.path.join(root, 'unused.npz'))
        data = data[data.index('--options') + 1:]
        res = benchmark.main([CONFIG_R50, ckpt, '--num-videos', '1',
                              '--options', *data])
        emit({'phase': 'analysis', 'seconds': lap(), 'cli': 'benchmark', **res})
        k400 = ['--steps', '3', '--batch-size', str(ANALYSIS_PRETRAIN_BATCH),
                '--num-videos', str(K400_CLIPS),
                '--video-frames', str(K400_FRAMES), '--data-dir',
                os.path.join(root, 'k400')]
        res = bench_pretrain.main(k400)
        emit({'phase': 'analysis', 'seconds': lap(), 'cli': 'bench_pretrain', **res})
        res = bench_pretrain.main([DA_CONFIG, '--device-aug', *k400])
        if not res['device_aug']:
            raise AssertionError(f'bench_pretrain --device-aug: {res}')
        emit({'phase': 'analysis', 'seconds': lap(), 'cli': 'bench_pretrain', **res})
        log = os.path.join(root, 'train_log.jsonl')
        for i, dt in enumerate((0.5, 0.25, 0.75)):
            JsonlLogger(log).log(dict(mode='train', iter=i + 1, time=dt,
                                      loss=2.0 - 0.1 * i))
        times = analyze_logs.main(['cal_train_time', log])[log]
        try:
            import matplotlib
            version = matplotlib.__version__
        except ImportError:
            version = None
        if version is not None:
            analyze_logs.main(['plot_curve', log, '--out',
                               os.path.join(root, 'curve.png')])
        emit({'phase': 'analysis', 'seconds': lap(), 'cli': 'analyze_logs',
              'cal_train_time': times, 'matplotlib': version})
    out['seconds'] = time.time() - t0
    emit({'phase': 'analysis', 'seconds': out['seconds']})


# slice 12's recognition path (module docstring, phase 14): MMAction2
# v0.6.0's TSM-R50 1x1x8 Kinetics-400 recipe at full width (8 videos of 8
# 224x224 segments a step), trained for one epoch on the train phase's
# K400_CLIPS clips; the device-only step over RECOG_TIMED_STEPS after
# RECOG_WARMUP_STEPS; one 32x224x224 clip through I3D-R50 and
# SlowFast-R50 4x16; every recognition backbone's card-vs-CPU gate at a
# small size (the train phase's tolerances); the demo and the report
RECOG_BATCH, RECOG_SEGMENTS, RECOG_CROP, RECOG_CLIP_FRAMES = 8, 8, 224, 32
RECOG_WORKERS = 4
# the train epoch: RECOG_REPEAT passes over the clips (8 steps; 16 until
# the localization phase took the script past 1000 s); its end-to-end
# rate over the last RECOG_E2E_STEPS steps, once the batches that the
# loader built during the first step's start-up are used up
RECOG_REPEAT, RECOG_E2E_STEPS = 2, 4
RECOG_TIMED_STEPS, RECOG_WARMUP_STEPS = 5, 2
RECOG_NORM = dict(mean=[123.675, 116.28, 103.53],
                  std=[58.395, 57.12, 57.375], to_bgr=False)
RECOG_LABELS = 10  # names in the demo's label file: the rest are padded


# the fp32 gradients of a net with depthwise 3-D convolutions (ip-CSN's
# ``conv2_dw``), which take ATen's own kernels on the card (no cuDNN path)
# forward and backward: against the CPU's fp64 step they read 1.36e-3 in
# relative L2 on the card (the worst), 6.3e-5 on the CPU, the depthwise
# weights' own 4.4e-4 and 5.1e-5 (H100 80GB HBM3, 700 W); held at about
# 7x the card's reading against fp64 instead of the CPU's rule, while the
# scores, the loss and the fp64 step keep theirs
RECOG_DEPTHWISE_GRAD = 1e-2


def tsm_r50_cfg(ann, prefix, work):
    """MMAction2 v0.6.0 configs/recognition/tsm/
    tsm_r50_1x1x8_50e_kinetics400_rgb.py as a dict: its model, pipelines,
    batch, optimizer (TSMOptimizerConstructor with fc_lr5, SGD lr 0.01,
    momentum 0.9, decay 1e-4, gradient clip 20) and schedule, cut to one
    epoch of RECOG_REPEAT passes over the given clips, no pretrained
    backbone (seeded weights). Its lr 0.01 is for 8 cards of 8 videos;
    one card of RECOG_BATCH takes MMAction2's linear scaling rule,
    0.01 x RECOG_BATCH / 64 (at 0.01 the loss rose from 5.99 to 26 in
    one step from these weights on an H100 80GB HBM3 at 700 W)."""
    train_pipeline = [
        dict(type='DecordInit'),
        dict(type='SampleFrames', clip_len=1, frame_interval=1,
             num_clips=RECOG_SEGMENTS),
        dict(type='DecordDecode'),
        dict(type='Resize', scale=(-1, 256)),
        dict(type='MultiScaleCrop', input_size=RECOG_CROP,
             scales=(1, 0.875, 0.75, 0.66), random_crop=False,
             max_wh_scale_gap=1, num_fixed_crops=13),
        dict(type='Resize', scale=(RECOG_CROP, RECOG_CROP),
             keep_ratio=False),
        dict(type='Flip', flip_ratio=0.5),
        dict(type='Normalize', **RECOG_NORM),
        dict(type='FormatShape', input_format='NCHW'),
        dict(type='Collect', keys=['imgs', 'label'], meta_keys=[]),
        dict(type='ToTensor', keys=['imgs', 'label'])]
    test_pipeline = [
        dict(type='DecordInit'),
        dict(type='SampleFrames', clip_len=1, frame_interval=1,
             num_clips=RECOG_SEGMENTS, test_mode=True),
        dict(type='DecordDecode'),
        dict(type='Resize', scale=(-1, 256)),
        dict(type='CenterCrop', crop_size=RECOG_CROP),
        dict(type='Flip', flip_ratio=0),
        dict(type='Normalize', **RECOG_NORM),
        dict(type='FormatShape', input_format='NCHW'),
        dict(type='Collect', keys=['imgs', 'label'], meta_keys=[]),
        dict(type='ToTensor', keys=['imgs'])]
    return dict(
        model=dict(
            type='Recognizer2D',
            backbone=dict(type='ResNetTSM', pretrained=None, depth=50,
                          norm_eval=False, num_segments=RECOG_SEGMENTS,
                          shift_div=8),
            cls_head=dict(type='TSMHead', num_classes=400, in_channels=2048,
                          num_segments=RECOG_SEGMENTS, spatial_type='avg',
                          consensus=dict(type='AvgConsensus', dim=1),
                          dropout_ratio=0.5, init_std=0.001,
                          is_shift=True)),
        train_cfg=None, test_cfg=dict(average_clips='prob'),
        data=dict(videos_per_gpu=RECOG_BATCH, workers_per_gpu=RECOG_WORKERS,
                  train=dict(type='RepeatDataset', times=RECOG_REPEAT,
                             dataset=dict(type='VideoDataset', ann_file=ann,
                                          data_prefix=prefix,
                                          pipeline=train_pipeline)),
                  test=dict(type='VideoDataset', ann_file=ann,
                            data_prefix=prefix, pipeline=test_pipeline,
                            test_mode=True)),
        optimizer=dict(type='SGD', constructor='TSMOptimizerConstructor',
                       paramwise_cfg=dict(fc_lr5=True),
                       lr=0.01 * RECOG_BATCH / 64, momentum=0.9,
                       weight_decay=0.0001),
        optimizer_config=dict(grad_clip=dict(max_norm=20, norm_type=2)),
        lr_config=dict(policy='step', step=[20, 40]), total_epochs=1,
        checkpoint_config=dict(interval=1), log_config=dict(interval=1),
        work_dir=work, seed=0)


# MMAction2 v0.6.0 configs/recognition/i3d/i3d_r50_32x2x1_100e_kinetics400
# _rgb.py and configs/recognition/slowfast/slowfast_r50_4x16x1_256e_
# kinetics400_rgb.py: the models, seeded weights
I3D_R50 = dict(
    type='Recognizer3D',
    backbone=dict(type='ResNet3d', depth=50, pretrained=None,
                  pretrained2d=True, norm_eval=False,
                  conv1_kernel=(5, 7, 7), conv1_stride_t=2, pool1_stride_t=2,
                  inflate=((1, 1, 1), (1, 0, 1, 0), (1, 0, 1, 0, 1, 0),
                           (0, 1, 0)), zero_init_residual=False),
    cls_head=dict(type='I3DHead', num_classes=400, in_channels=2048,
                  spatial_type='avg', dropout_ratio=0.5, init_std=0.01))
SLOWFAST_R50 = dict(
    type='Recognizer3D',
    backbone=dict(
        type='ResNet3dSlowFast', pretrained=None, resample_rate=8,
        speed_ratio=8, channel_ratio=8,
        slow_pathway=dict(type='resnet3d', depth=50, pretrained=None,
                          lateral=True, conv1_kernel=(1, 7, 7),
                          dilations=(1, 1, 1, 1), conv1_stride_t=1,
                          pool1_stride_t=1, inflate=(0, 0, 1, 1),
                          norm_eval=False),
        fast_pathway=dict(type='resnet3d', depth=50, pretrained=None,
                          lateral=False, base_channels=8,
                          conv1_kernel=(5, 7, 7), conv1_stride_t=1,
                          pool1_stride_t=1, norm_eval=False)),
    cls_head=dict(type='SlowFastHead', in_channels=2304, num_classes=400,
                  spatial_type='avg', dropout_ratio=0.5))
# MMAction2 v0.6.0 configs/recognition/slowonly/slowonly_r50_4x16x1_256e_
# kinetics400_rgb.py and csn/ircsn_ig65m_pretrained_r152_32x2x1_58e_
# kinetics400_rgb.py: the other recognizers whose ConvBN3d convolutions
# the narrow weight-gradient rule routes (ab_kernels.py --wgrad3d)
SLOWONLY_R50 = dict(
    type='Recognizer3D',
    backbone=dict(type='ResNet3dSlowOnly', depth=50, pretrained=None,
                  lateral=False, conv1_kernel=(1, 7, 7), conv1_stride_t=1,
                  pool1_stride_t=1, inflate=(0, 0, 1, 1), norm_eval=False),
    cls_head=dict(type='I3DHead', in_channels=2048, num_classes=400,
                  spatial_type='avg', dropout_ratio=0.5))
IRCSN_R152 = dict(
    type='Recognizer3D',
    backbone=dict(type='ResNet3dCSN', pretrained=None, depth=152,
                  with_pool2=False, bottleneck_mode='ir', norm_eval=False),
    cls_head=dict(type='I3DHead', in_channels=2048, num_classes=400,
                  spatial_type='avg', dropout_ratio=0.5))
# name: (recognizer, one card's clips (N, C, T, H, W)): the recipes'
# videos_per_gpu (8, 8, 3) of 32 x 2, 4 x 16 and 32 x 2 frames at 224
WGRAD3D_OTHERS = {
    'i3d_r50_32x2x1': (I3D_R50, (8, 3, 32, 224, 224)),
    'slowonly_r50_4x16x1': (SLOWONLY_R50, (8, 3, 4, 224, 224)),
    'ircsn_r152_32x2x1': (IRCSN_R152, (3, 3, 32, 224, 224)),
}


def _recognizer(backbone, head, in_channels, **head_kw):
    kind = 'Recognizer3D' if head in ('I3DHead', 'SlowFastHead') \
        else 'Recognizer2D'
    return dict(type=kind, backbone=backbone,
                cls_head=dict(type=head, num_classes=5,
                              in_channels=in_channels, dropout_ratio=0.0,
                              **head_kw))


_SLOW = dict(type='resnet3d', depth=18, lateral=True,
             conv1_kernel=(1, 7, 7), inflate=(0, 0, 1, 1))
_FAST = dict(type='resnet3d', depth=18, lateral=False, base_channels=8,
             conv1_kernel=(5, 7, 7))
_NL = dict(norm_cfg=dict(type='BN3d'), zeros_init=False)
# name: (recognizer, channels-last batch) of every backbone of slice 12,
# at a small size: the card against the CPU
RECOG_GATES = {
    'tsm_r50': (_recognizer(dict(type='ResNetTSM', depth=50,
                                 num_segments=4), 'TSMHead', 2048,
                            num_segments=4), (2, 4, 64, 64, 3)),
    'tsm_r18_non_local': (_recognizer(
        dict(type='ResNetTSM', depth=18, num_segments=4,
             non_local=((0, 0), (1, 0), 0, 0), non_local_cfg=_NL),
        'TSMHead', 512, num_segments=4), (2, 4, 64, 64, 3)),
    'tin_r18': (_recognizer(dict(type='ResNetTIN', depth=18,
                                 num_segments=4), 'TSMHead', 512,
                            num_segments=4), (2, 4, 64, 64, 3)),
    'i3d_r18_non_local': (_recognizer(
        dict(type='ResNet3d', depth=18, non_local=(0, (1, 0), 0, 0),
             non_local_cfg=dict(_NL, sub_sample=True)), 'I3DHead', 512),
        (2, 1, 8, 64, 64, 3)),
    'slowonly_r18': (_recognizer(dict(type='ResNet3dSlowOnly', depth=18),
                                 'I3DHead', 512), (2, 1, 8, 64, 64, 3)),
    'slowfast_r18': (_recognizer(dict(
        type='ResNet3dSlowFast', resample_rate=4, speed_ratio=4,
        slow_pathway=_SLOW, fast_pathway=_FAST), 'SlowFastHead', 576),
        (2, 1, 8, 64, 64, 3)),
    'r2plus1d_r18': (_recognizer(dict(type='ResNet2Plus1d', depth=18),
                                 'I3DHead', 512), (2, 1, 8, 64, 64, 3)),
    'csn_r18_ip': (_recognizer(dict(type='ResNet3dCSN', depth=18,
                                    bottleneck_mode='ip'), 'I3DHead', 2048),
                   (2, 1, 8, 64, 64, 3)),
    'alexnet_v1': (_recognizer(dict(type='AlexNetV1'), 'TSNHead', 256),
                   (2, 2, 127, 127, 3)),
    'alexnet_v2': (_recognizer(dict(type='AlexNetV2'), 'TSNHead', 32),
                   (2, 2, 127, 127, 3)),
    'alexnet_v3': (_recognizer(dict(type='AlexNetV3'), 'TSNHead', 512),
                   (2, 2, 127, 127, 3)),
}


def write_config(path, cfg_dict):
    """A config file of ``cfg_dict``'s top-level keys."""
    with open(path, 'w') as f:
        f.writelines(f'{k} = {v!r}\n' for k, v in cfg_dict.items())
    return path


def kernel_launches():
    """Every launch count of the hand-written kernels: the four rows'
    wrappers (the wide kernel's launches through them included), the
    wide ops and the narrow 3-D weight gradient."""
    from vfs_tpu_torch import ops
    from vfs_tpu_torch.ops import conv3d_wgrad
    return sum(getattr(k, name) for k in (
        ops.video_topk_affinity_cuda, ops.video_topk_affinity_v1_cuda,
        ops.local_topk_attend_cuda, ops.local_topk_attend_v2_cuda,
        ops.video_topk_affinity_wide_cuda, ops.local_topk_attend_wide_cuda,
        conv3d_wgrad.conv3d_weight_cuda)
        for name in dir(k) if name.endswith('launches'))


def seeded_recognizer(cfg, device, dtype=None, test_cfg=None):
    """The config's recognizer with the JAX modules' initialisers (seed 0)
    and, for a gate, every BatchNorm's scale and shift drawn too (seed 1),
    so that no residual branch starts at zero; on ``device``."""
    import torch
    from vfs_tpu_torch.device import to_channels_last
    from vfs_tpu_torch.models import build_model
    model = build_model(cfg, test_cfg=test_cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    if dtype is not None:
        generator = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.weight.uniform_(0.5, 1.5, generator=generator)
                    m.bias.normal_(0.0, 0.1, generator=generator)
        model.to(dtype=dtype)
    model.to(device)
    if device.type == 'cuda':
        to_channels_last(model.backbone)
    return model


def depthwise_3d_weights(model):
    """Names of the weights of ``model``'s depthwise 3-D convolutions."""
    import torch
    return {f'{n}.weight' for n, m in model.named_modules()
            if isinstance(m, torch.nn.Conv3d) and m.groups > 1
            and m.groups == m.in_channels}


def gate_run(cfg, x, labels, device, dtype):
    """Eval-mode scores, then one SGD train step's loss and gradients (as
    fp64 on the CPU) of the gate's recognizer on ``device``."""
    import torch
    from vfs_tpu_torch.apis.train import make_train_step
    from vfs_tpu_torch.core.optimizer import build_optimizer
    from vfs_tpu_torch.device import exact_fp32
    model = seeded_recognizer(cfg, device, dtype).eval()
    xt = torch.as_tensor(x).to(device=device, dtype=dtype)
    with torch.no_grad(), exact_fp32():
        scores = model(xt, return_loss=False).double().cpu()
    optimizer, _ = build_optimizer(model.train().parameters(), dict(
        type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4))
    loss = float(make_train_step(model, optimizer)(xt, None, labels)['loss'])
    return scores, loss, {n: p.grad.detach().double().cpu()
                          for n, p in model.named_parameters()}


def recognition_gates(dev):
    """Each RECOG_GATES backbone on the card against the CPU: fp64 within
    1e-9 (the scores, the loss, each gradient, relative), which shows the
    same function on both; fp32 as close to the CPU's fp64 answer as the
    CPU's fp32 is, times CARD_CPU_FACTOR plus CARD_CPU_FLOOR (the train
    phase's rule, module docstring), for the scores, the loss and all the
    gradients as one vector (each relative). At these sizes single
    gradients cancel badly in fp32 on both devices (R(2+1)D's 8-value
    BatchNorms: 1.2e-2 from fp64 on each; AlexNet V1's ``bn2.bias``
    7.6e-3 on the card, 2.7e-4 on the CPU; H100 80GB HBM3, 700 W), so the
    worst single gradient is printed, not gated."""
    import torch
    from vfs_tpu_torch.models import build_model
    cpu = torch.device('cpu')
    out = {}
    for name, (cfg, shape) in RECOG_GATES.items():
        t0 = time.time()
        x = np.random.RandomState(2).randn(*shape)
        rows = shape[0] * (shape[1] if cfg['type'] == 'Recognizer3D' else 1)
        labels = np.arange(rows) % 5
        runs = {(role, bits): gate_run(cfg, x, labels, d, dtype)
                for role, d in (('cpu', cpu), ('card', dev))
                for bits, dtype in ((64, torch.float64),
                                    (32, torch.float32))}
        exact = runs[('cpu', 64)]

        def rel(a, b):
            return float((a - b).norm() / b.norm())

        def rel_all(grads):  # every gradient as one vector
            return float(torch.sqrt(sum(
                ((grads[n] - g)**2).sum() for n, g in exact[2].items()))
                / torch.sqrt(sum((g * g).sum() for g in exact[2].values())))

        # a net with depthwise 3-D convolutions: RECOG_DEPTHWISE_GRAD
        depthwise = bool(depthwise_3d_weights(build_model(cfg)))
        errs = dict(
            fp64_scores=rel(runs[('card', 64)][0], exact[0]),
            fp64_loss=abs(runs[('card', 64)][1] - exact[1]) / abs(exact[1]),
            fp64_grads=grad_error(runs[('card', 64)][2], exact[2])[0],
            fp32_scores=rel(runs[('card', 32)][0], exact[0]),
            cpu_fp32_scores=rel(runs[('cpu', 32)][0], exact[0]),
            fp32_grads=rel_all(runs[('card', 32)][2]),
            cpu_fp32_grads=rel_all(runs[('cpu', 32)][2]),
            fp32_worst_grad=grad_error(runs[('card', 32)][2], exact[2]),
            cpu_fp32_worst_grad=grad_error(runs[('cpu', 32)][2], exact[2]),
            fp32_loss=abs(runs[('card', 32)][1] - exact[1]) / abs(exact[1]),
            cpu_fp32_loss=abs(runs[('cpu', 32)][1] - exact[1])
            / abs(exact[1]), seconds=time.time() - t0)
        if max(errs['fp64_scores'], errs['fp64_loss'],
               errs['fp64_grads']) > 1e-9 or depthwise \
                and errs['fp32_grads'] > RECOG_DEPTHWISE_GRAD:
            raise AssertionError(f'{name}: card vs CPU {errs}')
        for key in ('scores', 'loss') if depthwise \
                else ('scores', 'grads', 'loss'):
            if errs[f'fp32_{key}'] > CARD_CPU_FACTOR \
                    * errs[f'cpu_fp32_{key}'] + CARD_CPU_FLOOR:
                raise AssertionError(f'{name}: card vs CPU in fp32 {key} '
                                     f'{errs}')
        out[name] = errs
    return out


def recognition_train(root, dev, smi_line):
    """TSM-R50 through ``apis.train.train_model`` for one epoch on the
    clips (steps/s end to end leave out the first step), then the
    device-only step (RECOG_TIMED_STEPS CUDA-event-timed steps on a batch
    already on the card), its peak memory, ``train_mfu`` and
    ``device_breakdown``. Returns the line and the config."""
    import copy
    import math
    import random
    import torch
    import vfs_tpu_torch.apis.train as apis_train
    from vfs_tpu_torch.core.optimizer import build_tsm_optimizer
    from vfs_tpu_torch.datasets import build_dataset, collate
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.tools.analysis import get_flops
    from vfs_tpu_torch.utils import Config
    clips = os.path.join(root, 'k400')
    os.makedirs(clips)
    ann = write_k400(clips, 'mjpg')
    cfg_dict = tsm_r50_cfg(ann, clips, os.path.join(root, 'w'))
    cfg = Config.fromdict(copy.deepcopy(cfg_dict))
    dataset = build_dataset(cfg.data.train)
    model = build_model(cfg.model, test_cfg=cfg.test_cfg)
    records = []
    with patched(apis_train, 'make_train_step', step_timer(records)):
        t0 = time.time()
        state = apis_train.train_model(model, dataset, cfg, device=dev)
        wall_s = time.time() - t0
    losses = [float(loss) for loss, _ in records]
    ends = [t for _, t in records][-RECOG_E2E_STEPS - 1:]
    want = K400_CLIPS * RECOG_REPEAT // RECOG_BATCH
    if state.step != want or len(losses) != want \
            or not all(np.isfinite(losses)):
        raise AssertionError(f'TSM-R50: {state.step} steps, losses {losses}')
    # a 400-way classifier at init_std 0.001 starts near uniform
    if abs(losses[0] - math.log(400)) > 0.5:
        raise AssertionError(f'TSM-R50 step-0 loss {losses[0]} (ln 400 = '
                             f'{math.log(400)})')
    if (5.0, 10.0) not in state.optimizer.mults:
        raise AssertionError('TSM-R50: no fc_lr5 group in the optimizer')
    ckpt = os.path.join(cfg.work_dir, 'checkpoints', 'epoch_1')
    if not os.path.isfile(ckpt):
        raise AssertionError(f'TSM-R50: no checkpoint {ckpt}')

    np.random.seed(0)
    random.seed(0)
    batch = collate([dataset.dataset[i] for i in range(RECOG_BATCH)])
    imgs = torch.as_tensor(batch['imgs'], device=dev)
    labels = torch.as_tensor(batch['label'], device=dev)
    model = seeded_recognizer(cfg.model, dev).train()
    opt = cfg.optimizer
    step = apis_train.make_train_step(model, build_tsm_optimizer(
        model, opt.lr, opt.momentum, opt.weight_decay))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(imgs, None, labels), runs=RECOG_TIMED_STEPS,
                 warmup=RECOG_WARMUP_STEPS)
    peak = torch.cuda.max_memory_allocated()
    breakdown = device_breakdown(lambda _: step(imgs, None, labels), None)
    del model, step
    torch.cuda.empty_cache()

    path = write_config(os.path.join(root, 'tsm_r50.py'), cfg_dict)
    with contextlib.redirect_stdout(io.StringIO()):
        fwd = get_flops.main([path, '--frames', str(RECOG_SEGMENTS),
                              '--shape', str(RECOG_CROP)])['flops']
    # x3 for the forward and the backward (data and weight gradients), but
    # x2 for the stem, whose input (the frames) takes no gradient
    stem = 2 * (RECOG_CROP // 2)**2 * 64 * 7 * 7 * 3 * RECOG_SEGMENTS
    flops = RECOG_BATCH * (3 * fwd - stem)
    fp32_tflops = peaks(smi_line)[0]
    line = dict(
        config='MMAction2 v0.6.0 tsm_r50_1x1x8_50e_kinetics400_rgb',
        videos_per_step=RECOG_BATCH, segments=RECOG_SEGMENTS,
        crop=RECOG_CROP, loader_workers=RECOG_WORKERS,
        loader_video_decoder=video_decoder(), steps=state.step,
        losses=losses, train_wall_s=wall_s, e2e_steps=len(ends) - 1,
        e2e_steps_per_s=(len(ends) - 1) / (ends[-1] - ends[0]),
        gflop_forward_per_video=fwd / 1e9, tflop_per_step=flops / 1e12,
        ms_per_step=ms, steps_per_s=1e3 / ms,
        videos_per_s=RECOG_BATCH * 1e3 / ms,
        train_mfu=flops / (ms * 1e-3) / (fp32_tflops * 1e12),
        peak_tflops=fp32_tflops,
        bound_ms=flops / (fp32_tflops * 1e12) * 1e3,
        max_memory_allocated_gb=peak / 2**30, **breakdown)
    return line, cfg_dict, ann, ckpt


def recognition_forwards(root, dev, smi_line):
    """One RECOG_CLIP_FRAMES x 224 x 224 clip through I3D-R50 and
    SlowFast-R50 4x16 (seeded weights, exact fp32): probabilities that sum
    to 1, the median of five CUDA-event-timed forwards, clips/s and the
    forward's share of the fp32 peak."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.tools.analysis import get_flops
    out = {}
    fp32_tflops = peaks(smi_line)[0]
    for name, cfg in (('i3d_r50_32x2x1', I3D_R50),
                      ('slowfast_r50_4x16x1', SLOWFAST_R50)):
        model = seeded_recognizer(cfg, dev,
                                  test_cfg=dict(average_clips='prob')).eval()
        clip = torch.randn((1, 1, RECOG_CLIP_FRAMES, RECOG_CROP, RECOG_CROP,
                            3), generator=torch.Generator().manual_seed(0))
        clip = clip.to(dev)
        with torch.no_grad(), exact_fp32():
            probs = model(clip, return_loss=False)
            ms = cuda_ms(lambda: model(clip, return_loss=False))
        if probs.shape != (1, 400) or not torch.isfinite(probs).all() \
                or abs(float(probs.sum()) - 1) > 1e-4:
            raise AssertionError(f'{name}: probabilities {probs}')
        path = write_config(os.path.join(root, f'{name}.py'),
                            dict(model=cfg))
        with contextlib.redirect_stdout(io.StringIO()):
            flops = get_flops.main([path, '--frames',
                                    str(RECOG_CLIP_FRAMES), '--shape',
                                    str(RECOG_CROP)])['flops']
        out[name] = dict(ms_per_clip=ms, clips_per_s=1e3 / ms,
                         gflop_per_clip=flops / 1e9,
                         forward_mfu=flops / (ms * 1e-3)
                         / (fp32_tflops * 1e12))
        del model
        torch.cuda.empty_cache()
    return out


def recognition_tools(root, cfg_dict, ann, ckpt):
    """``tools.demo_recognition`` on one clip with the trained TSM-R50 (a
    label file of RECOG_LABELS names, padded to 400), and
    ``tools.analysis.report_accuracy`` over two score files: the trained
    model's scores of every clip, centre crops and their flips, each scored
    by ``VideoDataset.evaluate`` first."""
    import copy
    import torch
    from vfs_tpu_torch.apis import init_recognizer
    from vfs_tpu_torch.datasets import build_dataloader, build_dataset
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.tools import demo_recognition
    from vfs_tpu_torch.tools.analysis import report_accuracy
    path = write_config(os.path.join(root, 'tsm_r50_test.py'), cfg_dict)
    labels = os.path.join(root, 'labels.txt')
    with open(labels, 'w') as f:
        f.writelines(f'class {i}\n' for i in range(RECOG_LABELS))
    video = os.path.join(os.path.dirname(ann), sorted(
        n for n in os.listdir(os.path.dirname(ann))
        if n.startswith('clip'))[0])
    out_mp4 = os.path.join(root, 'demo.mp4')
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        top5 = demo_recognition.main([path, ckpt, video, labels,
                                      '--out-filename', out_mp4])
    if len(top5) != 5 or not os.path.isfile(out_mp4):
        raise AssertionError(f'demo_recognition: {buf.getvalue()}')
    model = init_recognizer(path, ckpt)
    model.test_cfg = dict(average_clips=None)  # a score row a video
    device = next(model.parameters()).device
    files, evals = [], []
    for flip in (0, 1):
        test = copy.deepcopy(cfg_dict['data']['test'])
        test['pipeline'] = [dict(t, flip_ratio=flip)
                            if t['type'] == 'Flip' else t
                            for t in test['pipeline']]
        dataset = build_dataset(test)
        loader = build_dataloader(dataset, RECOG_BATCH, RECOG_WORKERS,
                                  shuffle=False)
        scores = []
        try:
            for batch in loader:
                imgs = torch.as_tensor(batch['imgs'], device=device)
                with torch.no_grad(), exact_fp32():
                    scores += list(model(imgs, return_loss=False).cpu()
                                   .numpy())
        finally:
            loader.close()
        evals.append(dataset.evaluate(
            scores, ['top_k_accuracy', 'mean_class_accuracy']))
        files.append(os.path.join(root, f'scores_{flip}.npy'))
        np.save(files[-1], np.stack(scores))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fused = report_accuracy.main(['--scores', *files, '--coefficients',
                                      '1', '1', '--annotation', ann])
    return dict(demo_top5=[[str(k), float(v)] for k, v in top5],
                demo_mp4=os.path.isfile(out_mp4), evaluate=evals,
                report_accuracy=buf.getvalue().strip(), fused=fused)


def phase_recognition(dev, smi_line):
    """Slice 12's path (module docstring, phase 14). None of the four
    rows' kernels lies on it: their launch counts must not move. Its 3-D
    gates train narrow fp32 convolutions on the card, whose weight
    gradient is the narrow wgrad3d kernel's: that count, set to 0 before
    the phase, is returned with the phase's seconds."""
    from vfs_tpu_torch.ops.conv3d_wgrad import conv3d_weight_cuda
    t0 = time.time()
    conv3d_weight_cuda.launches = 0
    before = kernel_launches()
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        train, cfg_dict, ann, ckpt = recognition_train(root, dev, smi_line)
        emit({'phase': 'recognition', 'part': 'train_tsm_r50',
              'card': smi_line, **train, 'seconds': time.time() - t0})
        t1 = time.time()
        forwards = recognition_forwards(root, dev, smi_line)
        emit({'phase': 'recognition', 'part': 'forward_3d',
              'card': smi_line, 'clip': [RECOG_CLIP_FRAMES, RECOG_CROP,
                                         RECOG_CROP], **forwards,
              'seconds': time.time() - t1})
        t1 = time.time()
        tools = recognition_tools(root, cfg_dict, ann, ckpt)
        tools['seconds'] = time.time() - t1
    gates = recognition_gates(dev)
    wgrad3d = conv3d_weight_cuda.launches
    launches = kernel_launches() - before - wgrad3d
    if launches:
        raise AssertionError(f'recognition launched {launches} of the four '
                             'rows\' kernels (want none)')
    emit({'phase': 'recognition', 'part': 'card_vs_cpu',
          'gates': gates, 'tolerances': dict(
              fp64=1e-9, fp32_factor=CARD_CPU_FACTOR,
              fp32_floor=CARD_CPU_FLOOR,
              fp32_depthwise_grads=RECOG_DEPTHWISE_GRAD)})
    seconds = time.time() - t0
    emit({'phase': 'recognition', 'part': 'tools', **tools,
          'row_kernel_launches': launches,
          'narrow_wgrad3d_launches': wgrad3d, 'phase_seconds': seconds})
    return seconds, wgrad3d


# slice 13's localization path (module docstring, phase 15): MMAction2
# v0.6.0's BMN, BSN (TEM, PEM) and SSN recipes at full width with seeded
# weights on synthetic ActivityNet-layout features and THUMOS-layout
# frames written under build/
LOC_VIDEOS, LOC_TSCALE, LOC_FEAT = 16, 100, 400
# BMN: videos a step (bmn_400x100_2x8: 8 a card), epochs of
# LOC_VIDEOS / 8 steps, device-only steps timed after warm-up ones, and the
# videos decoded and evaluated after training
BMN_BATCH, BMN_EPOCHS = 8, 4
BMN_TIMED_STEPS, BMN_WARMUP_STEPS = 5, 2
BMN_INFER_VIDEOS = 2
# TEM and PEM: videos a step (bsn_*_1x16: 16 on one card), PEM's epochs
# and the BSN proposal tool's worker processes; SSN: one epoch over the
# two THUMOS videos of the proposal file, a video a step
BSN_BATCH, PEM_EPOCHS, BSN_WORKERS = 16, 3, 4
# BMN's kernels by kind: cuDNN's convolutions (implicit GEMMs, FFT
# products of complex fp32, layout transforms) apart from the
# boundary-matching product's cuBLAS GEMMs
LOC_KERNEL_KINDS = (('conv', ('implicit_gemm', 'conv', 'cudnn', 'wgrad',
                              'dgrad', 'fprop', 'fft', 'cf32')),
                    ('product', ('gemm', 'cublas', 'cutlass')),
                    ('reduce', ('reduce',)),
                    ('elementwise', ('elementwise', 'vectorized',
                                     'unrolled')))
SSN_HW = 224
SSN_NORM = dict(mean=[104.0, 117.0, 128.0], std=[1.0, 1.0, 1.0],
                to_bgr=True)
SSN_TRAIN_CFG = dict(ssn=dict(
    assigner=dict(positive_iou_threshold=0.7, background_iou_threshold=0.01,
                  incomplete_iou_threshold=0.3,
                  background_coverage_threshold=0.02,
                  incomplete_overlap_threshold=0.01),
    sampler=dict(num_per_video=8, positive_ratio=1, background_ratio=1,
                 incomplete_ratio=6, add_gt_as_proposals=True),
    loss_weight=dict(comp_loss_weight=0.1, reg_loss_weight=0.1)))
SSN_TEST_CFG = dict(ssn=dict(
    sampler=dict(test_interval=6, batch_size=16),
    evaluater=dict(top_k=2000, nms=0.2, softmax_before_filter=True,
                   cls_top_k=2)))
# the THUMOS-layout proposal file (tests/test_data/test_ssn.py's): two
# videos of 300 and 200 frames, their ground truth and proposals
SSN_PROPOSALS = """# 0
video_a
1
300
2
1 30 90
2 150 240
4
1 0.85 0.9 35 95
1 0.2 0.8 10 40
2 0.9 0.95 145 235
0 0.0 0.0 250 290
# 1
video_b
1
200
1
3 50 120
3
3 0.75 0.8 55 130
3 0.1 0.9 60 80
0 0.0 0.0 150 190
"""
SSN_FRAMES = (('video_a', 300), ('video_b', 200))


def write_activitynet(root, seed=0):
    """An ActivityNet-layout fixture (``tests/test_core/
    test_localization_train.py::make_activitynet`` at full width,
    LOC_VIDEOS videos of LOC_TSCALE x LOC_FEAT): the JSON database and a
    feature CSV a video whose features rise inside the annotated segment.
    Returns the annotation file."""
    n_videos, tscale, feat_dim = LOC_VIDEOS, LOC_TSCALE, LOC_FEAT
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    database = {}
    for i in range(n_videos):
        name = f'v_test{i:02d}'
        dur = 100.0
        start = float(rng.uniform(0.1, 0.5)) * dur
        end = start + float(rng.uniform(0.2, 0.4)) * dur
        feats = rng.randn(tscale, feat_dim).astype(np.float32) * 0.1
        lo = int(start / dur * tscale)
        feats[lo:max(lo + 1, int(end / dur * tscale)), :] += 1.0
        np.savetxt(os.path.join(root, name + '.csv'), feats, fmt='%.4f',
                   delimiter=',', comments='',
                   header=','.join(f'f{j}' for j in range(feat_dim)))
        database[name] = dict(
            duration_second=dur, duration_frame=3000, feature_frame=2996,
            annotations=[dict(segment=[start, end], label='Test')],
            fps=30.0, rfps=29.97)
    ann = os.path.join(root, 'anno.json')
    with open(ann, 'w') as f:
        json.dump(database, f)
    return ann


def _anet_data(ann, prefix, batch, workers, keys=('raw_feature', 'gt_bbox')):
    pipeline = [dict(type='LoadLocalizationFeature'),
                dict(type='GenerateLocalizationLabels'),
                dict(type='Collect', keys=list(keys),
                     meta_keys=('video_name',))]
    return dict(videos_per_gpu=batch, workers_per_gpu=workers,
                train=dict(type='ActivityNetDataset', ann_file=ann,
                           data_prefix=prefix, pipeline=pipeline))


def bmn_cfg(ann, prefix, work):
    """MMAction2 v0.6.0 configs/localization/bmn/
    bmn_400x100_2x8_9e_activitynet_feature.py as a dict: its model, train
    pipeline, batch and optimizer (Adam, decay 1e-4, step at epoch 7), cut
    to BMN_EPOCHS epochs over the fixture. Its lr 0.001 is for 2 cards of
    8 videos; one card takes the linear scaling rule, 0.001 x 8 / 16."""
    return dict(
        model=dict(type='BMN', temporal_dim=LOC_TSCALE, boundary_ratio=0.5,
                   num_samples=32, num_samples_per_bin=3, feat_dim=LOC_FEAT,
                   soft_nms_alpha=0.4, soft_nms_low_threshold=0.5,
                   soft_nms_high_threshold=0.9, post_process_top_k=100),
        data=_anet_data(ann, prefix, BMN_BATCH, 2),
        optimizer=dict(type='Adam', lr=0.001 * BMN_BATCH / 16,
                       weight_decay=0.0001),
        optimizer_config=dict(grad_clip=None),
        lr_config=dict(policy='step', step=7), total_epochs=BMN_EPOCHS,
        checkpoint_config=dict(interval=1), log_config=dict(interval=1),
        work_dir=work, seed=0)


def tem_cfg(ann, prefix, work):
    """MMAction2 v0.6.0 configs/localization/bsn/
    bsn_tem_400x100_1x16_20e_activitynet_feature.py: TEM (hidden 512), 16
    videos a step on one card, Adam lr 0.001, decay 1e-4; one epoch."""
    return dict(
        model=dict(type='TEM', temporal_dim=LOC_TSCALE, boundary_ratio=0.1,
                   tem_feat_dim=LOC_FEAT, tem_hidden_dim=512,
                   tem_match_threshold=0.5),
        data=_anet_data(ann, prefix, BSN_BATCH, 2),
        optimizer=dict(type='Adam', lr=0.001, weight_decay=0.0001),
        lr_config=dict(policy='step', step=7), total_epochs=1,
        log_config=dict(interval=1), work_dir=work, seed=0)


def pem_cfg(ann, prefix, pgm_dir, feat_dir, work):
    """MMAction2 v0.6.0 configs/localization/bsn/
    bsn_pem_400x100_1x16_20e_activitynet_feature.py: PEM (32 BSP features,
    hidden 256) on the first 500 PGM proposals a video, 16 videos a step,
    Adam lr 0.01, decay 1e-5; PEM_EPOCHS epochs."""
    return dict(
        model=dict(type='PEM', pem_feat_dim=32, pem_hidden_dim=256,
                   pem_u_ratio_m=1, pem_u_ratio_l=2,
                   pem_high_temporal_iou_threshold=0.6,
                   pem_low_temporal_iou_threshold=0.2, soft_nms_alpha=0.75,
                   soft_nms_low_threshold=0.65, soft_nms_high_threshold=0.9,
                   post_process_top_k=100),
        data=dict(videos_per_gpu=BSN_BATCH, workers_per_gpu=2, train=dict(
            type='ActivityNetDataset', ann_file=ann, data_prefix=prefix,
            pipeline=[dict(type='LoadProposals', top_k=500,
                           pgm_proposals_dir=pgm_dir,
                           pgm_features_dir=feat_dir),
                      dict(type='Collect',
                           keys=['bsp_feature', 'reference_temporal_iou'],
                           meta_keys=('video_name',))])),
        optimizer=dict(type='Adam', lr=0.01, weight_decay=0.00001),
        lr_config=dict(policy='step', step=10), total_epochs=PEM_EPOCHS,
        log_config=dict(interval=1), work_dir=work, seed=0)


def _ssn_pipeline(mode):
    keys = (['imgs', 'proposal_scale_factor', 'proposal_type',
             'proposal_labels', 'reg_targets'] if mode == 'train' else
            ['imgs', 'relative_proposal_list', 'scale_factor_list',
             'proposal_tick_list', 'reg_norm_consts'])
    return [dict(type='SampleProposalFrames', clip_len=1, body_segments=5,
                 aug_segments=(2, 2), aug_ratio=0.5, mode=mode),
            dict(type='RawFrameDecode'),
            dict(type='Resize', scale=(SSN_HW, SSN_HW), keep_ratio=False),
            dict(type='Normalize', **SSN_NORM),
            dict(type='FormatShape', input_format='NHWC'),
            dict(type='Collect', keys=keys, meta_keys=())]


def ssn_cfg(ann, prefix, work):
    """MMAction2 v0.6.0 configs/localization/ssn/
    ssn_r50_450e_thumos14_rgb_{train,test}.py: SSN on ResNet-50 (2048
    channels), STPP (1, 1, 1) over (2, 5, 2) segments, 20 classes, the
    8-proposal sampler, SGD lr 0.001, momentum 0.9, decay 1e-6; its
    pipelines with the frames resized to SSN_HW square (no random crop);
    one epoch of a video a step."""
    dataset = dict(type='SSNDataset', ann_file=ann, data_prefix=prefix,
                   train_cfg=SSN_TRAIN_CFG, test_cfg=SSN_TEST_CFG,
                   body_segments=5, aug_segments=(2, 2), aug_ratio=0.5,
                   filename_tmpl='img_{:05d}.jpg')
    return dict(
        model=dict(type='SSN', spatial_type='avg', dropout_ratio=0.8,
                   backbone=dict(type='ResNet', pretrained=None, depth=50,
                                 norm_eval=False, partial_bn=True),
                   cls_head=dict(type='SSNHead', dropout_ratio=0.8,
                                 in_channels=2048, num_classes=20,
                                 consensus=dict(type='STPPTrain',
                                                stpp_stage=(1, 1, 1),
                                                num_segments_list=(2, 5, 2)),
                                 use_regression=True)),
        train_cfg=SSN_TRAIN_CFG, test_cfg=SSN_TEST_CFG,
        data=dict(videos_per_gpu=1, workers_per_gpu=2,
                  train=dict(dataset, pipeline=_ssn_pipeline('train')),
                  test=dict(dataset, pipeline=_ssn_pipeline('test'),
                            test_mode=True)),
        optimizer=dict(type='SGD', lr=0.001, momentum=0.9,
                       weight_decay=1e-6),
        optimizer_config=dict(grad_clip=dict(max_norm=20, norm_type=2)),
        lr_config=dict(policy='step', step=[200, 400]), total_epochs=1,
        log_config=dict(interval=1), work_dir=work, seed=0)


def bmn_flops(model, dev):
    """FLOPs of one BMN train step a video, from the code: 2 per
    multiply-add of every convolution at the shapes a forward gives them
    (forward hooks on one video on the card) and of the boundary-matching
    product, x3 for the forward and the backward (data and weight
    gradients) but x2 for the first convolution (the features take no
    gradient) and for the product (the sampling mask is a constant: one
    product, the features' gradient)."""
    import torch
    macs = []

    def hook(m, inp, out):
        per_out = m.weight.numel() // m.out_channels
        macs.append((out.numel() * per_out, m is model.x1db_0))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.modules.conv._ConvNd)]
    with torch.no_grad():
        model(torch.zeros(1, model.temporal_dim, model.feat_dim,
                          device=dev))
    for h in hooks:
        h.remove()
    t = model.temporal_dim
    product = model.hidden_dim_1d * t * model.sample_mask.shape[1]
    return 2 * (sum((2 if first else 3) * n for n, first in macs)
                + 2 * product)


def bm_product_ms(model, dev, smi_line):
    """The boundary-matching product of a BMN_BATCH step alone: its
    forward (features x mask) and its backward's one product (gradient x
    mask^T), CUDA-event medians in exact fp32, each beside its bound
    (2 FLOP a multiply-add at the fp32 peak; each operand read and the
    result written once at the memory rate)."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    mask = model.sample_mask
    t, cols = mask.shape
    generator = torch.Generator(device=dev).manual_seed(0)
    p = torch.randn(BMN_BATCH, model.hidden_dim_1d, t, device=dev,
                    generator=generator)
    g = torch.randn(BMN_BATCH, model.hidden_dim_1d, cols, device=dev,
                    generator=generator)
    fp32_tflops, tbps = peaks(smi_line)[:2]
    flops = 2.0 * p.shape[0] * p.shape[1] * t * cols
    nbytes = 4.0 * (p.numel() + mask.numel() + g.numel())
    bound = max(flops / (fp32_tflops * 1e12), nbytes / (tbps * 1e12)) * 1e3
    with exact_fp32():
        fwd = cuda_ms(lambda: torch.matmul(p, mask))
        bwd = cuda_ms(lambda: torch.matmul(g, mask.t()))
    del g
    torch.cuda.empty_cache()
    return dict(forward_ms=fwd, backward_ms=bwd, bound_ms=bound,
                gflop=flops / 1e9, gbytes=nbytes / 1e9)


def bmn_train(root, dev, smi_line):
    """BMN through ``python -m vfs_tpu_torch.tools.train`` in-process on
    the card: BMN_EPOCHS epochs, losses finite, a checkpoint an epoch; the
    end-to-end steps/s (the first step left out); then the device-only
    step on one batch on the card, its peak memory, ``train_mfu`` and
    ``device_breakdown``. Returns the line, the trained model and the
    dataset config."""
    import copy
    import torch
    import vfs_tpu_torch.apis.train_localizer as apis_loc
    from vfs_tpu_torch.core.optimizer import build_optimizer
    from vfs_tpu_torch.datasets import build_dataset, collate
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.tools import train as tools_train
    feats = os.path.join(root, 'anet')
    ann = write_activitynet(feats)
    cfg_dict = bmn_cfg(ann, feats, os.path.join(root, 'bmn'))
    path = write_config(os.path.join(root, 'bmn.py'), cfg_dict)
    records = []
    with patched(apis_loc, 'make_localizer_train_step',
                 step_timer(records)), \
            contextlib.redirect_stdout(io.StringIO()):
        t0 = time.time()
        state = tools_train.main([path, '--work-dir', cfg_dict['work_dir']])
        wall_s = time.time() - t0
    losses = [float(loss) for loss, _ in records]
    ends = [t for _, t in records]
    want = LOC_VIDEOS // BMN_BATCH * BMN_EPOCHS
    if state.step != want or len(losses) != want \
            or not all(np.isfinite(losses)):
        raise AssertionError(f'BMN: {state.step} steps, losses {losses}')
    for epoch in range(1, BMN_EPOCHS + 1):
        if not os.path.isfile(os.path.join(cfg_dict['work_dir'],
                                           'checkpoints', f'epoch_{epoch}')):
            raise AssertionError(f'BMN: no checkpoint epoch_{epoch}')
    trained = state.model

    dataset = build_dataset(cfg_dict['data']['train'])
    batch = collate([dataset[i] for i in range(BMN_BATCH)])
    model = build_model(cfg_dict['model'])
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev).train()
    optimizer, _ = build_optimizer(model.parameters(),
                                   copy.deepcopy(cfg_dict['optimizer']))
    step = apis_loc.make_localizer_train_step(model, optimizer)
    tensors = apis_loc.prepare_batch(model, batch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(tensors), runs=BMN_TIMED_STEPS,
                 warmup=BMN_WARMUP_STEPS)
    peak = torch.cuda.max_memory_allocated()
    breakdown = device_breakdown(step, tensors, kind_keys=LOC_KERNEL_KINDS)
    flops = BMN_BATCH * bmn_flops(model, dev)
    product = bm_product_ms(model, dev, smi_line)
    del model, optimizer, step, tensors
    torch.cuda.empty_cache()
    fp32_tflops = peaks(smi_line)[0]
    line = dict(
        config='MMAction2 v0.6.0 bmn_400x100_2x8_9e_activitynet_feature',
        videos_per_step=BMN_BATCH, temporal_dim=LOC_TSCALE,
        feat_dim=LOC_FEAT, num_samples=32, steps=state.step, losses=losses,
        train_wall_s=wall_s, e2e_steps=len(ends) - 2,
        e2e_steps_per_s=(len(ends) - 2) / (ends[-1] - ends[1]),
        tflop_per_step=flops / 1e12, ms_per_step=ms,
        videos_per_s=BMN_BATCH * 1e3 / ms,
        train_mfu=flops / (ms * 1e-3) / (fp32_tflops * 1e12),
        peak_tflops=fp32_tflops,
        bound_ms=flops / (fp32_tflops * 1e12) * 1e3,
        max_memory_allocated_gb=peak / 2**30, product=product, **breakdown)
    return line, trained, cfg_dict


def bmn_infer(trained, cfg_dict, dev):
    """The trained BMN on BMN_INFER_VIDEOS videos, one at a time: the
    forward on the card, ``decode_proposals`` (soft NMS and
    ``post_processing`` inside) on the host, then
    ``ActivityNetDataset.evaluate``'s AR@AN (synthetic data: printed, not
    gated)."""
    import torch
    from vfs_tpu_torch.datasets import build_dataset
    from vfs_tpu_torch.device import exact_fp32
    data = dict(cfg_dict['data']['train'], test_mode=True, pipeline=[
        dict(type='LoadLocalizationFeature'),
        dict(type='Collect', keys=['raw_feature'],
             meta_keys=('video_name', 'duration_frame', 'duration_second'))])
    dataset = build_dataset(data)
    dataset.video_infos = dataset.video_infos[:BMN_INFER_VIDEOS]
    trained.eval()
    results, forward_ms, decode_ms = [], [], []
    for i in range(len(dataset)):
        sample = dataset[i]
        x = torch.as_tensor(sample['raw_feature'].T[None], device=dev)
        with torch.no_grad(), exact_fp32():
            forward_ms.append(cuda_ms(lambda: trained(x), runs=1,
                                      warmup=0))
            maps = trained(x)
        t0 = time.time()
        results += trained.decode_proposals(*maps, [sample['img_meta']])
        decode_ms.append((time.time() - t0) * 1e3)
    metrics = dataset.evaluate(results)
    if not all(len(r['proposal_list']) > 0 for r in results) \
            or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f'BMN inference: {metrics}, {results[:1]}')
    return dict(videos=len(results), forward_ms=forward_ms,
                decode_host_ms_per_video=decode_ms,
                proposals_per_video=[len(r['proposal_list'])
                                     for r in results], **metrics)


def bsn_chain(root, dev):
    """TEM one step at its published width through ``train_localizer_model``,
    its scores of every fixture video dumped as the TEM result CSVs
    (``ActivityNetDataset.dump_results(..., 'csv')``), PGM proposals and
    BSP features by ``python -m vfs_tpu_torch.tools.bsn_proposal_generation``
    (BSN_WORKERS processes), then PEM_EPOCHS PEM steps on them."""
    import torch
    import vfs_tpu_torch.apis.train_localizer as apis_loc
    from vfs_tpu_torch.datasets import build_dataset
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.tools import bsn_proposal_generation
    from vfs_tpu_torch.utils import Config
    feats = os.path.join(root, 'anet')
    ann = os.path.join(feats, 'anno.json')
    out = {}
    t0 = time.time()
    cfg = Config.fromdict(tem_cfg(ann, feats, os.path.join(root, 'tem')))
    dataset = build_dataset(cfg.data.train)
    with contextlib.redirect_stdout(io.StringIO()):
        state = apis_loc.train_localizer_model(build_model(cfg.model),
                                               dataset, cfg, device=dev)
    tem = state.model.eval()
    tem_results = []
    for i in range(len(dataset)):
        x = torch.as_tensor(dataset[i]['raw_feature'].T[None], device=dev)
        with torch.no_grad(), exact_fp32():
            scores = tem(x)[0].cpu().numpy()
        tmin = np.arange(LOC_TSCALE) / LOC_TSCALE
        tem_results.append((dataset.video_infos[i]['video_name'],
                            np.concatenate([scores, tmin[:, None],
                                            tmin[:, None] + 1 / LOC_TSCALE],
                                           axis=1)))
    tem_dir = os.path.join(root, 'tem_results')
    dataset.dump_results(tem_results, tem_dir, 'csv')
    out.update(tem_steps=state.step, tem_seconds=time.time() - t0)

    t0 = time.time()
    pgm_dir, feat_dir = (os.path.join(root, n) for n in ('pgm', 'pgm_feat'))
    bsn = write_config(os.path.join(root, 'bsn.py'), dict(
        tem_results_dir=tem_dir, pgm_proposals_dir=pgm_dir,
        pgm_features_dir=feat_dir,
        temporal_proposal_generation=dict(temporal_scale=LOC_TSCALE,
                                          peak_threshold=0.5),
        pgm_features_cfg=dict(top_k=1000, num_sample_start=8,
                              num_sample_end=8, num_sample_action=16,
                              num_sample_interp=3, bsp_boundary_ratio=0.2),
        data=dict(train=dict(ann_file=ann))))
    with contextlib.redirect_stdout(io.StringIO()):
        n = bsn_proposal_generation.main([bsn, '--mode', 'train',
                                          '--num-workers',
                                          str(BSN_WORKERS)])
    feat0 = np.load(os.path.join(feat_dir, 'v_test00.npy'))
    rows = len(np.loadtxt(os.path.join(pgm_dir, 'v_test00.csv'),
                          delimiter=',', skiprows=1))
    if n != LOC_VIDEOS or feat0.shape != (min(rows, 1000), 32) \
            or not np.isfinite(feat0).all():
        raise AssertionError(f'BSN proposals: {n} videos, {rows} '
                             f'proposals, features {feat0.shape}')
    out.update(pgm_videos=n, pgm_proposals_video0=rows,
               bsp_feature_shape=list(feat0.shape),
               pgm_seconds=time.time() - t0)

    t0 = time.time()
    cfg = Config.fromdict(pem_cfg(ann, feats, pgm_dir, feat_dir,
                                  os.path.join(root, 'pem')))
    records = []
    with patched(apis_loc, 'make_localizer_train_step',
                 step_timer(records)), \
            contextlib.redirect_stdout(io.StringIO()):
        state = apis_loc.train_localizer_model(
            build_model(cfg.model), build_dataset(cfg.data.train), cfg,
            device=dev)
    losses = [float(loss) for loss, _ in records]
    if state.step != PEM_EPOCHS * (LOC_VIDEOS // BSN_BATCH) \
            or not all(np.isfinite(losses)):
        raise AssertionError(f'PEM: {state.step} steps, {losses}')
    out.update(pem_steps=state.step, pem_losses=losses,
               pem_seconds=time.time() - t0)
    return out


def write_thumos(root):
    """The THUMOS-layout proposal file and ``SSN_FRAMES``' rawframes
    (``make_ssn_rawframes``: 32x40 noise JPEGs). Returns the file."""
    import cv2
    rng = np.random.RandomState(2)
    for name, n in SSN_FRAMES:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for i in range(1, n + 1):
            cv2.imwrite(os.path.join(d, f'img_{i:05d}.jpg'),
                        rng.randint(0, 255, (32, 40, 3), np.uint8))
    ann = os.path.join(root, 'proposals.txt')
    with open(ann, 'w') as f:
        f.write(SSN_PROPOSALS)
    return ann


def ssn_run(root, dev):
    """SSN (ResNet-50) through ``train_localizer_model``: one epoch of a
    video a step, losses finite; then ``SSN.forward_test`` (the test
    frames through the backbone, ``test_fc``, the host ``STPPTest``) on
    every video and ``SSNDataset.evaluate``'s mAP (synthetic: printed)."""
    import torch
    import vfs_tpu_torch.apis.train_localizer as apis_loc
    from vfs_tpu_torch.datasets import build_dataset
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.utils import Config
    frames = os.path.join(root, 'thumos')
    cfg = Config.fromdict(ssn_cfg(write_thumos(frames), frames,
                                  os.path.join(root, 'ssn')))
    records = []
    t0 = time.time()
    with patched(apis_loc, 'make_localizer_train_step',
                 step_timer(records)), \
            contextlib.redirect_stdout(io.StringIO()):
        state = apis_loc.train_localizer_model(
            build_model(cfg.model, train_cfg=cfg.train_cfg,
                        test_cfg=cfg.test_cfg),
            build_dataset(cfg.data.train), cfg, device=dev)
    losses = [float(loss) for loss, _ in records]
    if state.step != len(SSN_FRAMES) or not all(np.isfinite(losses)):
        raise AssertionError(f'SSN: {state.step} steps, {losses}')
    train_s = time.time() - t0
    model = state.model.eval()
    test = build_dataset(cfg.data.test)
    results, test_ms, test_frames = [], [], []
    for i in range(len(test)):
        sample = test[i]
        test_frames.append(len(sample['imgs']))
        t1 = time.time()
        imgs = torch.as_tensor(sample['imgs'], device=dev)
        with exact_fp32():
            results.append(model.forward_test(
                imgs, sample['relative_proposal_list'],
                sample['scale_factor_list'], sample['proposal_tick_list'],
                sample['reg_norm_consts']))
        test_ms.append((time.time() - t1) * 1e3)
    metrics = test.evaluate(results)
    if not all(np.isfinite(r[1]).all() and np.isfinite(r[3]).all()
               for r in results):
        raise AssertionError('SSN test scores not finite')
    return dict(config='MMAction2 v0.6.0 ssn_r50_450e_thumos14_rgb',
                crops_per_step=8 * 9, crop=SSN_HW, steps=state.step,
                losses=losses, train_wall_s=train_s,
                test_frames=test_frames,
                test_ms_per_video=test_ms,
                **{k: metrics[k] for k in ('mAP@0.10', 'mAP@0.50')})


# the card-vs-CPU gates at a small size: (config, batch maker)
LOC_GATE_T = 20


def _gate_batches():
    """Each gate's loader batch: numpy, seeded."""
    rng = np.random.RandomState(3)
    t = LOC_GATE_T
    # no cell's IoU with these boxes lies within 1e-3 of BMN's 0.3 / 0.7
    # label thresholds, so fp32 and fp64 label the same cells
    boxes = [np.array([[0.12, 0.43], [0.52, 0.81]]),
             np.array([[0.31, 0.88]])]
    feats = rng.randn(2, 16, t).astype(np.float32)
    ssn = dict(imgs=rng.randn(1, 72, 32, 32, 3).astype(np.float32),
               proposal_scale_factor=(rng.rand(1, 8, 2) + 0.5).astype(
                   np.float32),
               proposal_type=np.array([[0, 1, 1, 1, 1, 1, 1, 2]]),
               proposal_labels=np.array([[2, 1, 3, 2, 2, 1, 3, 0]]),
               reg_targets=(rng.randn(1, 8, 2) * 0.3).astype(np.float32))
    return {
        'bmn': (dict(type='BMN', temporal_dim=t, boundary_ratio=0.5,
                     num_samples=8, num_samples_per_bin=3, feat_dim=16,
                     soft_nms_alpha=0.4, soft_nms_low_threshold=0.5,
                     soft_nms_high_threshold=0.9, post_process_top_k=100,
                     hidden_dim_1d=16, hidden_dim_2d=8, hidden_dim_3d=32),
                dict(raw_feature=feats, gt_bbox=boxes),
                [rng.rand(2, t, t).astype(np.float32) for _ in range(2)]),
        'tem': (dict(type='TEM', temporal_dim=t, boundary_ratio=0.1,
                     tem_feat_dim=16, tem_hidden_dim=32,
                     tem_match_threshold=0.5),
                dict(raw_feature=feats, gt_bbox=boxes), None),
        'pem': (dict(type='PEM', pem_feat_dim=32, pem_hidden_dim=64,
                     pem_u_ratio_m=1, pem_u_ratio_l=2,
                     pem_high_temporal_iou_threshold=0.6,
                     pem_low_temporal_iou_threshold=0.2,
                     soft_nms_alpha=0.75, soft_nms_low_threshold=0.65,
                     soft_nms_high_threshold=0.9, post_process_top_k=100),
                dict(bsp_feature=rng.randn(2, 40, 32).astype(np.float32),
                     reference_temporal_iou=rng.rand(2, 40).astype(
                         np.float32)),
                [rng.rand(80).astype(np.float32) for _ in range(2)]),
        'ssn': (dict(type='SSN', backbone=dict(type='ResNet', depth=18),
                     cls_head=dict(type='SSNHead', dropout_ratio=0.0,
                                   in_channels=512, num_classes=3)),
                ssn, None)}


def loc_gate_run(cfg, batch, draws, device, dtype):
    """The gate's localizer (seed-0 weights) on ``device`` in ``dtype``,
    train mode: its forward's outputs, loss and gradients (fp64 on the
    CPU)."""
    import torch
    from vfs_tpu_torch.apis.train_localizer import (_KINDS, prepare_batch,
                                                    sum_losses)
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.models import build_model
    model = build_model(cfg, train_cfg=SSN_TRAIN_CFG)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device=device, dtype=dtype).train()
    tensors = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in prepare_batch(model, batch, device).items()}
    outs = []
    hook = (model.backbone if cfg['type'] == 'SSN' else model
            ).register_forward_hook(lambda m, a, out: outs.extend(
                o.detach() for o in (out if isinstance(out, tuple)
                                     else (out,))))
    with exact_fp32():
        total, _ = sum_losses(_KINDS[cfg['type']][1](
            model, model, tensors, None,
            None if draws is None else [torch.as_tensor(d) for d in draws]))
        total.backward()
    hook.remove()
    flat = torch.cat([o.double().flatten().cpu() for o in outs])
    return flat, float(total.detach()), torch.cat(
        [p.grad.detach().double().flatten().cpu()
         for p in model.parameters() if p.grad is not None])


def localization_gates(dev):
    """Each localizer at a small size on the card against the CPU (the
    train phase's rule): in fp64 the forward's outputs, the loss and all
    the gradients as one vector within 1e-10 (relative), which shows the
    same function on both; in fp32 the card as close to the CPU's fp64
    answer as the CPU's fp32 is, x CARD_CPU_FACTOR + CARD_CPU_FLOOR. The
    losses' uniform draws are given (the same numbers on both)."""
    import torch
    cpu = torch.device('cpu')
    out = {}
    for name, (cfg, batch, draws) in _gate_batches().items():
        runs = {(role, bits): loc_gate_run(cfg, batch, draws, d, dtype)
                for role, d in (('cpu', cpu), ('card', dev))
                for bits, dtype in ((64, torch.float64),
                                    (32, torch.float32))}
        exact = runs[('cpu', 64)]

        def rel(a, b):
            return float((a - b).norm() / b.norm())

        errs = {}
        for i, part in enumerate(('outputs', 'loss', 'grads')):
            def err(run):
                a, b = run[i], exact[i]
                return abs(a - b) / abs(b) if part == 'loss' else rel(a, b)
            errs[f'fp64_{part}'] = err(runs[('card', 64)])
            errs[f'fp32_{part}'] = err(runs[('card', 32)])
            errs[f'cpu_fp32_{part}'] = err(runs[('cpu', 32)])
            if errs[f'fp64_{part}'] > 1e-10 or errs[f'fp32_{part}'] > \
                    CARD_CPU_FACTOR * errs[f'cpu_fp32_{part}'] \
                    + CARD_CPU_FLOOR:
                raise AssertionError(f'{name}: card vs CPU {part} {errs}')
        out[name] = errs
    return out


def phase_localization(dev, smi_line):
    """Slice 13's path (module docstring, phase 15). No hand-written
    kernel lies on it: their launch counts must not move."""
    t0 = time.time()
    before = kernel_launches()
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        train, trained, cfg_dict = bmn_train(root, dev, smi_line)
        emit({'phase': 'localization', 'part': 'train_bmn',
              'card': smi_line, **train, 'seconds': time.time() - t0})
        t1 = time.time()
        infer = bmn_infer(trained, cfg_dict, dev)
        emit({'phase': 'localization', 'part': 'infer_bmn', **infer,
              'seconds': time.time() - t1})
        del trained
        t1 = time.time()
        bsn = bsn_chain(root, dev)
        emit({'phase': 'localization', 'part': 'bsn', **bsn,
              'seconds': time.time() - t1})
        t1 = time.time()
        ssn = ssn_run(root, dev)
        emit({'phase': 'localization', 'part': 'ssn', 'card': smi_line,
              **ssn, 'seconds': time.time() - t1})
    t1 = time.time()
    gates = localization_gates(dev)
    launches = kernel_launches() - before
    if launches:
        raise AssertionError(f'localization launched {launches} '
                             'hand-written kernels (want none)')
    seconds = time.time() - t0
    emit({'phase': 'localization', 'part': 'card_vs_cpu', 'gates': gates,
          'tolerances': dict(fp64=1e-10, fp32_factor=CARD_CPU_FACTOR,
                             fp32_floor=CARD_CPU_FLOOR),
          'gate_seconds': time.time() - t1,
          'hand_written_kernel_launches': launches,
          'phase_seconds': seconds})
    return seconds


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    import vfs_tpu_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.time()
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.time()
        try:
            return fn(*args)
        finally:
            phase_s[name] = phase_s.get(name, 0.0) + time.time() - t0

    smi_line = timed('build', phase_build)
    timed('native', phase_native, dev, smi_line)
    timed('small', phase_small, dev)
    local_full, plain_ms = timed('full', phase_full, dev, smi_line)
    modes_full = timed('full_modes', phase_full_modes, dev, smi_line)
    v1_full = timed('full_v1', phase_full_v1, dev, smi_line, plain_ms)
    v2_entry = timed('full_v2', phase_full_v2, dev, smi_line)
    timed('tc', phase_tc, dev, smi_line)
    wgrad3d = timed('wgrad3d', phase_wgrad3d, dev, smi_line)
    row1 = timed('main', phase_main, dev, smi_line)
    wide = timed('wide', phase_wide, dev, smi_line)
    eval_modes, row3 = timed('eval', phase_eval, local_full)
    row1[0]['launches'] += timed('all_blocks', phase_all_blocks, dev,
                                 smi_line)
    v1_launches = timed('pose', phase_pose) + timed('vip', phase_vip)
    row1[0]['launches'] += timed('train', phase_train, dev, smi_line)
    row1[0]['launches'] += timed('train_r50', phase_train_r50, dev, smi_line)
    timed('dense', phase_dense, dev, smi_line)
    row1[0]['launches'] += timed('learning', phase_learning, smi_line)
    bench = timed('bench_cfg', phase_bench_cfg, dev, smi_line)
    timed('siamfc', phase_siamfc, dev, smi_line)
    row2 = dict(**V1_INFO, launches=v1_launches, **v1_full, library_ms=None,
                library_note=NO_LIBRARY_CALL)
    timed('analysis', phase_analysis, dev, smi_line)
    _, wgrad3d['recognition_launches'] = timed(
        'recognition', phase_recognition, dev, smi_line)
    timed('localization', phase_localization, dev, smi_line)
    for entry, row in ((row1[0], 'row1'), (row2, 'row2'), (row3, 'row3')):
        entry['launches'] += bench[row]['launches']
        entry['bf16'] = bench[row]
    for name, _ in LOCAL_MODES:  # launched on the eval path
        row3['launches'] += eval_modes[name]['launches']
        row3[name] = dict(launches=eval_modes[name]['launches'],
                          **modes_full[name])
    emit({'phase': 'total', 'seconds': time.time() - t_start,
          'phase_seconds': phase_s})
    emit({'kernels': [*row1, row2, row3, v2_entry, *wide, wgrad3d],
          'paths_without_kernels': {
              'localization': 'launches no hand-written kernel: cuDNN '
                              'convolutions, torch.matmul and PyTorch ops '
                              '(phase 15)'}})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
