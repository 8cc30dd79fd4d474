"""Drive the PyTorch/CUDA port (ofa_sr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit and no result line):
1. The card (nvidia-smi name and power limit), torch / CUDA versions, and
   the build of the hand-written kernels from csrc/ (nvcc, one per source,
   in parallel).
2. Kernel parity on the card: each kernel against its plain PyTorch version
   on the same inputs, at the serving and training paths' shapes and a few
   ragged ones (the fused BN forward `bn_forward`: the moments, and inv, y
   and the running statistics, prefix views included, bit for bit against
   the plain ops on the kernel's moments, two calls giving the same bits;
   the fused BN backward `bn_backward`: dx, dscale, dbias; the
   shuffle tail and the MBConv also against float64, each no less accurate
   than its cuDNN float32 composition);
   train-mode BN through the BN kernels (`bn_train_fused`) against the
   plain autograd branch: y, dx, dscale, dbias. Then the bf16 forms of the
   BN kernels (`ofa_bn_forward_bf16`, `ofa_col_sums2_bf16`,
   `ofa_bn_backward_bf16`) the same way on
   bf16 tensors, at every BN shape of the training path plus C = 3, ragged
   C and misaligned rows (sums and moments at the float32 rows' tolerance,
   dx within one bf16 ulp), and float16 or a bf16 dy with a float32 x
   refused on the card. And, f32 and bf16, `bn_forward` and `bn_backward`
   with the masked step's active-width operand (a device int32 width) at
   its shapes (C 384 at 36,864 and 9,216 rows, each middle width 192, 256,
   384) and two ragged ones: inv, y and the running statistics bit for bit
   against the plain ops on the kernel's moments with the operand, y 0 and
   the running statistics unchanged from the width on, an active width of
   C the bits of the call without it; dx, dscale, dbias against the plain
   backward with it, 0 from the width on; train-mode BN through the kernels
   with it against the plain autograd branch. Then the masked depthwise
   (csrc/dw_masked.cu: forward, dgrad, wgrad), TF32 off, f32 and bf16, at
   the S4 masked step's shapes (C 384 at 36,864 and 9,216 rows with widths
   0, 192, 200, 256, 384 and those rounded up to 128 as bounds; C 192 and
   256 at their full width) and MBV3's (C 96 at 64x112x112, stride 1 and 2; C 960 at
   64x7x7), and the tiled kernel's edges (C 100, whose bf16 pixel rows are
   not a multiple of 16 bytes; an odd C 37; odd sides at stride 2; widths
   ragged against the 16-column tile), every kernel size: y and dx against
   the plain version within
   TOL (bf16 BF16_DX_TOL), dW no farther from a float64 plain run than the
   plain version plus DW_F64_MARGIN, exact zeros from the bound on and
   outside the k x k window, two calls the same bits. Then the masked 1x1
   expand and project convs (csrc/pw_masked.cu: the six products, forward,
   dgrad and wgrad of each conv), TF32 off, f32 and bf16, at the S4 masked
   step's shapes (36,864 and 9,216 rows, Cin = Cout = 64, the bank width
   384, bounds 0, 192, 200, 256, 384) and the GEMM's edges (1,000 rows,
   Cin 24, M 72, Cout 40, bounds 0, 36, 37, 72; 40 rows, fewer than one
   64-row tile, at the S4's widths, bounds 0, 37, 200, 384): f32 forwards and dgrads
   within TOL of the plain version (3xTF32 keeps float32's accuracy), the
   wgrads no farther from float64 than the plain version plus
   PW_F64_MARGIN; bf16 every product within one bf16 ulp of the float64
   product rounded once (plus PW_BF16_SUM_SHARE of its terms' magnitudes),
   the wgrads also against float64; exact zeros from the bound on, two
   calls the same bits.
3. Serving: a full-width OFAMobileNetS4 (seeded he_fout weights, random BN
   statistics) materialized as the ks7/e6/d2/pixel_d 2 subnet serves 8 LR
   180x320 frames (720p out) through `entry.serve`, with every kernel's
   launch count read around that run; the frames are held against the same
   subnet run on the plain (cuDNN) path on the card, and a small frame
   against the same subnet on the CPU. Frame times from CUDA events; device
   time by kernel and the idle share from torch.profiler.
4. The supernet eval forward of `entry.entry` (bs16, 48x48, pixel_d 1),
   held against the same forward on the CPU; then training through
   `entry.train` on the full-width supernet (bs16, 96x96 HR, Adam, weight
   decay 3e-5): 8 one-subnet steps (both pixel_d among their subnets) and 2
   steps of 4 subnets with KD, each BN wrapper's launches read around each
   run: bn_forward and bn_backward held to 3*sum(d) + pixel_d + 4 a subnet
   (the teacher's eval forward launches none), col_sums2 and bn_moments
   (off the path) to 0; then the same two runs in bf16
   mixed precision (`compute_dtype=torch.bfloat16`, the JAX bench's own
   training envelope), where every BN launch must be a bf16 one, and the
   one-subnet bf16 run once more on the plain path (losses held to the
   kernel path's). Then, outside the counted runs:
   kernel path against plain path (`use_kernels=False`) on the card from the
   same weights (SGD: per-step losses, params after one step), a small step
   card against CPU, ms per step of the float32 and bf16 kernel and plain
   paths (CUDA events, in the order f32 plain, f32 kernels, bf16 kernels,
   bf16 plain, then back), and (profiled in phase 5) the device's idle
   share and top kernels.
5. The run-management path through the port's two command-line entry
   points, in a temporary directory, at full width: the teacher trainer
   (`cli.train_teacher_net_sr_simple`, synthetic data, BN in train mode)
   for 2 epochs of 4 steps with validation, its BN-kernel launches counted
   (bn_forward, bn_backward) and held to 3*sum(d) + pixel_d + 4 a step,
   col_sums2 and bn_moments to 0, its checkpoint and log files
   checked; again with 3 epochs, which must resume at epoch 2 and run one;
   once in bf16, where every BN launch must be a bf16 one. Then the SR
   evaluator (`cli.eval_ofa_net_sr --materialize`, ks7/e6/d2/pixel_d 2,
   synthetic 720x720 HR frames: LR 180x180) from the teacher's checkpoint,
   its MBConv and shuffle-tail launches held to sum(d) and pixel_d a frame,
   and its mean PSNR-Y held within 1e-3 dB of the same subnet on the plain
   path. Times: the run manager's ms per step (CUDA events around
   `train_one_epoch`) against `entry.train`'s on the same net and against
   the epoch's data path alone (the loader, and the loader with the copies
   to the card), in alternating rounds; epoch wall seconds; eval ms per
   frame.
6. Per-kernel numbers at the paths' shapes (kernel, plain version, the
   card's least time, and for the BN kernels one PyTorch call computing the
   same function as a yardstick the port never calls: F.batch_norm in train
   mode for the fused forward), the BN kernels in float32 and in bf16, and
   the masked depthwise's three directions at the graphed one-subnet S4
   window's shapes (with the masked work's bound and cuDNN's unmasked 7x7
   calls beside them; their device time from phase 13's dw_switch
   profile), and the masked 1x1's three directions (each over the expand's
   and the project's products) at the same window's shapes (with the
   sampled work's bound, the whole width's, and cuDNN's full-width 1x1
   calls beside them; their device time from phase 13's expand_switch +
   dw_switch profile). Then
   the torch.profiler
   sessions of phases 3 and 4, last, because a profiler session leaves the
   launch path slower for the rest of the process: device time and kernels
   per frame and per step, and the BN kernels' own device time (and the X4 frames' profiles of phase
   7). One JSON line of all of it, the
   nvidia-smi line, and the result line {"ok": true, "device": {...}}.
7. (run after phase 5, before phase 6's timings and profiles) The X4
   supernet (learned downscale + SR), full width, seeded weights: the
   ks7/e6/d2/pixel_d 2 subnet (both trunks) serves 8 frames through
   `entry.serve` in sr mode (LR 180x320 -> 720p) and in autoencoder mode
   (720p in, 720p out), MBConv launches held to sum(d) of the trunks run
   (8 and 16 a frame) and shuffle-tail launches to 0 (the X4's shuffle
   convs are 3x3; the tail kernel is 5x5 only), frames against the plain
   path (the autoencoder's against float64: no less accurate than the
   plain path, see F64_FRAME_RATIO) and a small frame against the CPU,
   frame ms with fold_tail on and off, each mode's kernel frame profiled with phase 6's; `entry.train` on
   the X4 (bs16, 96 px, Adam) 4 one-subnet steps in each mode in float32
   and bf16, BN launches held to 3*sum(d_dec) + pixel_d + 4 a subnet (sr)
   and 3*(sum(d_enc) + sum(d_dec)) + 2*pixel_d + 7 (autoencoder), bf16
   ones apart, losses against the plain path, ms a step and host enqueue
   ms; then the shrinking CLI (`cli.train_ofa_net_sr_simple`, synthetic
   data) in a temporary directory: one expand stage in autoencoder mode
   (it reorganizes both trunks; BN launches counted, stage file, stage
   checkpoint, logs), its rerun (the stage is finished: nothing trains),
   a pixelshuffle_depth stage in sr mode warm-started from it, and the
   evaluator with `--x4_autoencoder --materialize` from that checkpoint
   (16 MBConv launches a frame, PSNR-Y within 1e-3 dB of the plain path).
8. (run after phase 7, before phase 6's timings and profiles) Large frames
   and data parallelism: (a) the MBConv kernel with row bounds at (1, 180,
   320, 64), k 7, e 6, against its plain version for bounds inside, one
   row, empty and past the frame, (0, H) the unbounded call's bits, ms a
   launch with and without bounds; (b) the S4's ks7/e6/d2/pixel_d 2 subnet
   on an LR 270x480 frame and the X4 autoencoder's on a true 1080x1920
   frame, full width, through the kernels, each row-padded (280 and 1088
   rows) with row_valid against the unpadded frame (max |diff| at most
   1e-5 of the frame's max |value|), MBConv and tail launches counted; (c)
   tiled_sr_infer on both frames with the receptive-field halo, against
   the full frame at that bound; frame ms full, row-padded, tiled; (d) two
   ranks (this script again, `--mesh-rank`) sharing the card over gloo
   (gloo takes CUDA tensors for all_reduce and broadcast, the only
   collectives the port uses, and NCCL refuses two ranks on one GPU):
   make_spatial_infer and tiled_sr_infer_mesh on (b)'s frames against
   (b)'s full and (c)'s tiled frames, then entry.train with the mesh, 4
   one-subnet steps at the global bs16 96 px (8 rows a rank) in float32 and
   in bf16, against phase 4's one-process runs (losses rtol 1e-4 / 1e-2),
   the ranks' parameters equal bit for bit, and each rank's BN wrappers of
   the mesh route (col_sums2's pass 1, bn_bwd_sums, and the apply entry
   points bn_forward_from_sums / bn_backward_from_sums) launched
   3*sum(d) + pixel_d + 4 times a subnet, the fused bn_forward and
   bn_backward never; MBConv and tail launches held on each rank to one
   subnet run a slab (spatial) and one a window of its share
   (tiled_sr_infer_mesh), and in (c) to one a window; (e) one process over
   NCCL at world 1: the mesh BN route's bits equal to the fused call's (y, mean,
   var, inv, running statistics; dx, dscale, dbias) at every path BN shape
   in float32 and bf16, the apply entry points against their plain
   versions, the all-reduce's ms a BN, and ms a step of the trainer with
   and without the mesh; then the window step under that mesh: the apply
   entry points with the active width at the masked steps' BN shapes (the
   SR step's C 384 at widths 0 and each middle width, the classification
   step's with widths 0 and C) giving the fused calls' bits with the same
   width, f32 and bf16, and against their plain versions; entry.train with
   steps_per_dispatch 4 on the full-width S4 (bs16, 96 px, 2 windows of 4)
   under the mesh, f32 and bf16, each distinct pass launching the mesh
   route's four wrappers once per train-mode BN at its eager first run and
   at its capture (the all-reduces captured with it) and the fused ones
   never, its captures and replays counted, held to the same windows in
   one process (and, in f32, that run to itself again: cuDNN's float32
   convolutions vary between runs); one MBV3 bf16 window (ClsRunManager,
   batch 64 at 224 px) the same way; a gloo group on the card refused with
   ValueError before any launch; and the deterministic pair again with dw_switch on (the masked depthwise's
   deterministic wgrad keeps the one-process window's bits; each direction
   launched once a block of each distinct pass at its eager first run and
   capture). The two-rank
   timings on one card, and the world-1 mesh's, are no measure of
   multi-GPU speed.
9. (run after phase 8, before phase 6's timings and profiles) Subnet
   search: (c) `entry.search` on the full-width S4 (seeded weights, random
   BN statistics as in phase 3) at 720 px HR with a synthetic provider
   (96 px, 2 recalibration batches of 16): its block table (a) is
   `build_block_latency_table` at LR 360 and 180, 2 x 9 MBConv entries and
   2 head/tail entries, each positive, every timed call of a block one
   MBConv launch and of the minimal subnet sum(d) MBConv and pixel_d tail
   launches (counted where the calls are captured into CUDA graphs; the
   replays re-run those launches without the wrappers), each block entry
   beside its eager time and the plain path's graph time; the finder's
   winner within the constraint; the deployments (smallest and largest
   uniform subnets, the winner) measured and scored after BN
   recalibration, which launches `bn_forward` 3*sum(d)+pixel_d+4 times a
   batch and no other BN kernel; the winner serves 8 LR 180x320 frames
   through `entry.serve` (sum(d) MBConv and pixel_d tail launches a frame)
   against the plain path at 1e-3. (b) The table's sum against the
   measured subnet for `sample_subnet` seeds 0-7, reported. (d) The
   accuracy predictor's fit on the card against the same fit on the CPU
   (predictions rtol 1e-3) and `build_latency_table` over the 16 corners
   of ks 3/7, e 3/6, d 2/4, pixel_d 1/2. (e) `resize_bicubic` of a bs16
   720x720 batch to 360 against the CPU (atol 1e-5), ms a batch; the
   oracle-video CLIs (teacher validate-only and `--finetune`, the X4
   per-video overfit; BN frozen: no kernel launched) and `eval_ofa_net_sr
   --dataset oracle_video --materialize` (8 MBConv and 2 tail launches a
   frame). Whole subnets are timed with windows of 4 and 12 calls
   (WHOLE_WINDOWS), blocks with measure_latency_device's defaults.
10. (run after phase 9, before phase 6's timings and profiles) The rest of
   the SR side and the classification nets: (a) `export_subnet` of phase
   3's S4 subnet for a true 720p LR 180x320 frame and of phase 7's X4
   autoencoder subnet for its 720x1280 HR frame, written, loaded on the
   card with `load_subnet` and run: the artifact against the eager plain
   path within 1e-6 and against the kernel path (the S4 at FRAME_TOL; the
   X4 autoencoder, where no float32 path meets FRAME_TOL, no less accurate
   against float64 than the artifact, F64_FRAME_RATIO), the kernel frames
   counted (sum(d) MBConv and pixel_d tail launches a frame), and the
   artifact's, the plain and the kernel frames' ms; (b) `get_net_info` of
   the full-width S4 and X4 supernets (the `trace` check runs after phase
   6's profiles: a profiler session slows every later launch); (c)
   OFAMobileNetV3 and OFAProxylessNASNets at their published widths (1000
   classes; MBV3 also with width_mult_list [0.65, 1.0] at wid 0 and 1),
   seeded weights and random BN, batch 16 at 224x224: for max_arch and two
   sampled archs the eval forward against `StaticClsSubnet` and against
   `specialize`'s static net (CLS_TOL), the train-mode forward with the BN
   kernel against the plain one (logits CLS_TOL, running statistics
   CLS_STATE_TOL) with `bn_forward` launched once a BN of the active arch
   and no other kernel, ms a batch of each, and `export_cls_subnet` saved,
   loaded and run against the materialized subnet (1e-6); (d) the tutorial
   (`ofa_sr_tpu_torch.tutorial`) at its defaults on the card, its launches
   counted. Whether PIL imports on this machine is printed.
11. (run after phase 10, before phase 6's timings and profiles)
   Classification training: (a) `ClsTrainer` on OFAMobileNetV3 and
   OFAProxylessNASNets at the published widths, 1000 classes, seeded
   weights and random BN, batch 64 at 224 px, SGD with Nesterov momentum,
   weight decay 3e-5, label smoothing 0.1: one step of one subnet (the
   kernel phase's draw) and one of TASK_PHASES[("expand", 2)]'s 4 subnets
   with KD against a ks7/e6/d4 teacher, each in float32 and bf16, the
   kernel path against the plain path from the same weights (losses
   STEP_TOL, bf16 BF16_STEP_TOL; float32 parameters STEP_TOL and running
   statistics CLS_STATE_TOL) with `bn_forward` and `bn_backward` launched
   once per executed BN and nothing else; ms per step (CUDA events) and
   host enqueue ms in alternating rounds, each path's peak
   max_memory_allocated; the BN kernels at the step's extreme shapes (the
   most rows, 802,816, at the fewest and most channels; the most channels
   at 3,136 rows) against their plain versions, float32 against float64
   sums, ms a launch beside F.batch_norm (train) /
   native_batch_norm_backward and the bound; the one-subnet kernel step of
   each family profiled with phase 6's. (b) The five classification CLIs,
   --synthetic, counted: the CIFAR teacher for 1 epoch and a resumed
   second, the CIFAR supernet with KD from it; `train_ofa_net --task
   kernel` then `--task depth --phase 1 --warmstart`; `eval_ofa_net`
   plain, --materialize and --export from that checkpoint (the artifact
   against the recalibrated materialized subnet, EXPORT_TOL);
   `eval_specialized_net --supernet_checkpoint --arch_config`; BN launches
   against each run's executed BNs, checkpoint and log files, finite
   losses. (c) Cifar10Provider on a seeded pickle directory and
   ImagenetProvider with ElasticResolution(128-224) on a seeded PNG tree,
   one epoch each through ClsRunManager (the folder epoch at all four
   sizes), BN launches counted.
12. (run after phase 11, before phase 6's timings and profiles) The SR
   curriculum and the search-and-deploy demo (`ofa_sr_tpu_torch.exp`), in
   a temporary directory. First one SGD step of the expand space's X4 on a
   curriculum batch (batch 4 of 32 and of 48 px crops from a generated
   tree, an expand-phase subnet) with the kernels and on the plain path:
   loss, parameters and running statistics at STEP_TOL, BN launches
   counted (phase 2 also holds both BN kernels at these steps' shapes).
   Then `exp.curriculum` at its small defaults (32
   generated 'sharp' PNGs of 64 px, 32 px crops, batch 4, the teacher 12
   epochs, max-net pretraining and each shrink phase 4 epochs) through the
   port's two training CLIs, each CLI run's launches and trained subnets
   recorded: the frozen-BN teacher launches no BN kernel, each X4 phase
   `bn_forward` and `bn_backward` once per executed train-mode BN
   (3*sum(d_dec) + pixel_d + 4 a subnet, as phase 7 holds it) and nothing
   else, the grid evaluations nothing; every phase scored finite with its
   PHASE_DONE.json; the rerun with `--resume_report` trains nothing,
   launches nothing and reports the same numbers. Then
   `exp.search_deploy_demo --quality macs` on the expand checkpoint: each
   timed call's MBConv launches (one a block entry's call, sum(d_dec) a
   whole subnet's), `bn_forward` once per BN of the three deployments'
   recalibration, nothing else; the winner within its budget, its kernel
   frame against its plain frame (FRAME_TOL). Wall seconds, the headline
   (margins over bicubic), the winner's PSNR-Y, table ms and measured ms
   printed.
13. (run after phase 12, before phase 6's timings and profiles) Multi-step
   dispatch: the masked training step as CUDA-graph replays
   (`SRTrainer.make_scan_train_step`, `train/graphs.py`). (a) The main
   path: `entry.train` with `steps_per_dispatch` at bench.py's envelopes
   (16 one-subnet steps in one window; 8 steps of 4 subnets + KD in one),
   float32 and bf16, the BN wrappers counted: each distinct pass (depths,
   pixel_d) launches bn_forward and bn_backward once per train-mode BN at
   its eager first run and once at its capture, the replays without the
   wrappers; nothing else; then the one-subnet envelope with dw_switch on,
   the masked depthwise's main path: each of its three directions launched
   once a block of each distinct pass at its eager first run and capture
   (2 * sum(d) a pass key), none without the lever; then with
   expand_switch too, the masked 1x1's main path: each of its directions
   twice a block (4 * sum(d) a pass key), none without that lever. (b)
   Parity, TF32 off:
   the graphed windows
   against the same steps run eagerly in the masked form (the cache's
   graphs off) and against the eager sliced steps (`train_step`), per-step
   losses at STEP_TOL (bf16: BF16_STEP_TOL), in float32 the parameters at
   STEP_TOL (a tensor past it within CLS_UPDATE_RTOL of a float64 sliced
   step's update) and the running statistics at CLS_STATE_TOL: the S4 at
   the bench's 8 subnets (16 one-subnet steps; 4 steps of 4 + KD), f32 and
   bf16; the X4 in sr mode (4 windows of 4) and autoencoder mode (one of
   4); captures held to the distinct passes + the update (+ the teacher);
   the S4's one-subnet window with dw_switch against the eager sliced
   steps, f32 and bf16, its captures as many as without the lever and its
   masked depthwise launches counted at first runs and captures alone; the
   same window with expand_switch and dw_switch the same way, its masked
   1x1 launches counted too.
   Graphs of one pool replayed out of capture order (A, B, A, B | B, A)
   against eager. (c) SRRunManager at steps_per_dispatch 4 (one window of
   4 steps, bs16 96 px synthetic) against the same epoch at 1, its log
   lines, and its checkpoint resumed at 1. (d) ms a step and host enqueue
   ms, eager sliced against graphed, f32 and bf16, 1 subnet, alternating
   rounds (the graphed windows with dw_switch and with expand_switch +
   dw_switch among them); replays a step, captures and capture seconds,
   peak max_memory_allocated; the graphed paths profiled with phase 6's
   (4 + KD and the mesh window are timed by neither: the port bench's). (e)
   bn_forward / bn_backward ms a launch at C 384 with the active width and
   without. A failed capture or replay ends the run non-zero.
14. (run after phase 13, before phase 6's timings and profiles) The
   classification scan step: `ClsTrainer.make_scan_train_step` and
   `ClsRunManager` at `steps_per_dispatch` 4, the masked MBV3 / Proxyless
   step (every block at max width, depth a device gate, dropout from a
   generator registered with the graphs) as CUDA-graph replays, at the
   published widths, 1000 classes, seeded weights and random BN, batch 64
   at 224 px, SGD Nesterov, weight decay 3e-5, label smoothing 0.1. (a)
   The main path: ClsRunManager on MBV3 with a synthetic provider, 8 steps
   in windows of 4: one subnet a step (the kernel phase), then the expand
   phase 2's 4 subnets with KD against a ks7/e6/d4 teacher, f32 and bf16;
   the one pass key launches bn_forward and bn_backward once per
   train-mode BN of the masked forward (every block) at its eager first
   run and once at its capture, the replays none, nothing else; captures
   held to the pass, the update (and the teacher), replays to the rest.
   (b) Parity, TF32 off, dropout 0, MBV3 and Proxyless, f32 and bf16,
   deterministic cuDNN (the same comparison on every run): a window of 4
   one-subnet steps (depths 2-3: each stage's last block gated
   off, its running statistics and parameters unchanged) and one of 2
   steps of 4 + KD, SGD at CLS_PARITY_LR, graphed against eager masked and
   eager sliced: per-step losses at STEP_TOL (bf16: BF16_STEP_TOL), top-1
   and top-5 exact (bf16 against sliced: one row a step), f32 parameters
   at STEP_TOL (past it within CLS_UPDATE_RTOL of a float64 sliced window's
   change, or no farther from it than the reference path plus
   CLS_UPDATE_RTOL where that path misses the bound too: Proxyless's float32
   windows do on every path), running statistics at CLS_STATE_TOL; two pass
   keys (224 and 192 px) replayed out of capture order against eager; the
   masked forward of a stride-2 SE block against its sliced forward at
   every (ks, e) through the kernels; MBV3's one-subnet window with
   dw_switch against the eager sliced steps, f32 and bf16 (captures as
   without the lever; the masked depthwise launched once an elastic block
   at the pass's first run and capture). (c) Dropout 0.1: replays of one key
   draw pairwise distinct masks, the keep fraction within 4 sigma of 0.9,
   and the graphed window's draws against an eager window's from the same
   seed, step by step (reported). (d) ClsRunManager at steps_per_dispatch 4
   against 1 for a 6-step epoch (a window and a tail), its log lines, its
   checkpoint resumed at 1; an ImagenetProvider epoch with
   ElasticResolution(128-224) at 4: a pass key a size, its captures, BN
   launches and peak memory. (e) ms a step and host enqueue ms, eager
   sliced against graphed, both families, f32 and bf16, 1 subnet,
   alternating rounds (MBV3's graphed window with dw_switch among them);
   replays a step, captures and their seconds, peak max_memory_allocated;
   the paths profiled with phase 6's.
   Phase 2 holds bn_forward and bn_backward with the active width at the
   classification step's shapes (C 96 at 802,816 rows, widths 0, 48, 72,
   96; C 960 and 1,152 at 3,136 rows, widths 0, half, C; a ragged shape),
   f32 and bf16. A failed capture or replay ends the run non-zero.

Float32 with TF32 off for cuDNN and matmuls, so the card's numbers compare
with the CPU's, apart from the bf16 training runs; the shuffle-tail and
MBConv kernels' own TF32 products are compensated (3xTF32, float32
accuracy). Exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import functools
import gc
import hashlib
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bn_path_times import bn_train_shapes, time_ms  # noqa: E402
from ofa_sr_tpu_torch.entry import (  # noqa: E402
    entry,
    kd_teacher,
    serve,
    step_subnets,
    synthetic_batch,
    train,
)
from ofa_sr_tpu_torch import entry as entry_mod  # noqa: E402
from ofa_sr_tpu_torch import search  # noqa: E402
from ofa_sr_tpu_torch.cli import (  # noqa: E402
    eval_ofa_net,
    eval_ofa_net_sr,
    eval_specialized_net,
    train_ofa_net,
    train_ofa_net_cifar10_simple,
    train_ofa_net_sr_oracle_video,
    train_ofa_net_sr_simple,
    train_teacher_net_cifar10_simple,
    train_teacher_net_sr_oracle_video,
    train_teacher_net_sr_simple,
)
from ofa_sr_tpu_torch.cli.common import make_net, make_sr_provider  # noqa: E402
from ofa_sr_tpu_torch.data import (  # noqa: E402
    Cifar10Provider,
    Div2KSetXXProvider,
    ElasticResolution,
    ImagenetProvider,
    SyntheticClsProvider,
    SyntheticSRProvider,
)
from ofa_sr_tpu_torch.exp import curriculum, search_deploy_demo  # noqa: E402
from ofa_sr_tpu_torch.model_zoo import ofa_net  # noqa: E402
from ofa_sr_tpu_torch.data.bicubic import resize_bicubic  # noqa: E402
from ofa_sr_tpu_torch.models import (  # noqa: E402
    OFAMobileNetS4,
    OFAMobileNetX4,
    SearchSpace,
    SubnetConfig,
    get_active_subnet,
)
from ofa_sr_tpu_torch import tutorial  # noqa: E402
from ofa_sr_tpu_torch.models import (  # noqa: E402
    OFAMobileNetV3,
    OFAProxylessNASNets,
    get_active_cls_subnet,
)
from ofa_sr_tpu_torch.models.arch import (  # noqa: E402
    reference_quirk_arch_x4,
    sample_subnet,
    subnet_seed,
    uniform_subnet,
)
from ofa_sr_tpu_torch.models.export import (  # noqa: E402
    export_cls_subnet,
    export_subnet,
    load_subnet,
)
from ofa_sr_tpu_torch.models.net_config import specialize  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels import _build  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels.bn import bn_train_fused  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels.bn_stats import (  # noqa: E402
    bn_backward,
    bn_backward_from_sums,
    bn_backward_from_sums_reference,
    bn_backward_reference,
    bn_bwd_sums,
    bn_bwd_sums_reference,
    bn_forward,
    bn_forward_from_moments,
    bn_forward_from_sums,
    bn_forward_from_sums_reference,
    bn_forward_reference,
    bn_moments,
    bn_moments_reference,
    col_sums2,
    col_sums2_reference,
)
from ofa_sr_tpu_torch.ops.kernels.dw_masked import (  # noqa: E402
    dw_masked_dgrad,
    dw_masked_forward,
    dw_masked_wgrad,
    masked_depthwise_grads_reference,
    masked_depthwise_reference,
    out_size,
    tap_mask,
)
from ofa_sr_tpu_torch.ops.kernels.dw_masked import smem_bytes as dw_smem_mirror  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels.mbconv import fused_mbconv_infer, mbconv_reference  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels.pw_masked import (  # noqa: E402
    masked_pointwise_dgrad_reference,
    masked_pointwise_grads_reference,
    masked_pointwise_reference,
    masked_pointwise_wgrad_reference,
    pw_masked_dgrad,
    pw_masked_forward,
    pw_masked_wgrad,
)
from ofa_sr_tpu_torch.ops.kernels.pw_masked import smem_bytes as pw_smem_mirror  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels.shuffle_tail import (  # noqa: E402
    fused_shuffle_tail,
    shuffle_tail_reference,
)
from ofa_sr_tpu_torch.ops.norm import batch_norm_train  # noqa: E402
from ofa_sr_tpu_torch.parallel import Mesh  # noqa: E402
from ofa_sr_tpu_torch.search import latency as search_latency  # noqa: E402
from rank_launch import free_port, launch  # noqa: E402
from ofa_sr_tpu_torch.train import (  # noqa: E402
    ClsRunManager,
    ClsTrainer,
    RunConfig,
    SRRunManager,
    SRTrainer,
)
from ofa_sr_tpu_torch.train import graphs as graphs_mod  # noqa: E402
from ofa_sr_tpu_torch.train.checkpoint import load_weights_lenient  # noqa: E402
from ofa_sr_tpu_torch.train.optim import GatedOpt  # noqa: E402
from ofa_sr_tpu_torch.train.tiled_infer import (  # noqa: E402
    receptive_field_radius,
    receptive_field_radius_autoencoder,
    tiled_sr_infer,
    tiled_sr_infer_mesh,
)
from ofa_sr_tpu_torch.utils.common import make_divisible  # noqa: E402
from ofa_sr_tpu_torch.utils.metrics import psnr_y_device  # noqa: E402
from ofa_sr_tpu_torch.utils.profile import get_net_info, trace  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, TF32 on the tensor cores (dense), and HBM3 bandwidth. The shuffle
# tail and the MBConv's 1x1 convs multiply on the tensor cores, 3 TF32
# products a multiply-add (3xTF32); the MBConv's depthwise and the BN
# kernels use the FP32 pipe.
PEAK_F32_FLOPS = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
TOL = dict(rtol=1e-4, atol=1e-4)      # kernel vs plain, float32, other sum order
FRAME_TOL = dict(rtol=1e-3, atol=1e-3)  # whole frames: errors compound over ~14 layers
# column sums of float32 rows (kernel vs plain, each summing ~100 terms in
# sequence at most): |err| <= SUM_RTOL * sum|terms| per column, twice a
# worst-case float32 bound
SUM_RTOL = 2e-5
MOMENT_TOL = dict(rtol=1e-4, atol=5e-5)   # mean / biased var of O(1) data
# the 3xTF32 kernels (shuffle tail, MBConv) against a float64 run of their
# plain version at the path shape: their max abs error at most this many
# times the cuDNN float32 composition's (PERF.md: the tail reads ~0.35x;
# MMAs chained into one truncating accumulator read several times 1x)
F64_RATIO = 1.0
STEP_TOL = dict(rtol=1e-4, atol=1e-5)     # params after one SGD step, kernels vs plain
BF16 = torch.bfloat16
# a bf16 dx, kernel vs plain: each rounds its float32 value once, so where
# the two (summed in other orders) straddle a rounding boundary they differ
# by one bf16 ulp, at most 2^-7 of the value; plus the float32 tolerance
# where dx cancels to near 0
BF16_DX_TOL = dict(rtol=2.0 ** -7, atol=1e-4)
# bf16 training losses, kernel path vs plain path (bf16 roundings flip apart
# over the steps): half the JAX package's own bf16-against-float32 bound of
# 2% of the loss (tests/test_train.py)
BF16_STEP_TOL = dict(rtol=1e-2, atol=0)
# params after one SGD step (lr 0.01), card vs CPU: the convs' weight
# gradients are sums over the batch in cuDNN's order and the CPU's
DEVICE_STEP_TOL = dict(rtol=1e-4, atol=1e-4)
LR_HW = (180, 320)                    # 720p output at 4x
N_FRAMES = 8
BS, HR = 16, 96                       # the training envelope of the JAX bench
TRAIN_STEPS = 8                       # one-subnet steps; steps 0-7 sample both pixel_d
KD_STEPS = 2                          # steps of 4 subnets with KD
STEP_ROUNDS = 1                       # rounds of (plain, kernels, kernels, plain) timing
# the BN wrappers the training path calls, one launch each per train-mode BN
# (the fused forward and the fused backward), and the BN wrappers that are
# off the path (entry points of the Pallas functions, held in phase 2)
BN_KERNELS = (bn_forward, bn_backward)
BN_OFF_PATH = (col_sums2, bn_moments)
# the __global__ functions of csrc/*.cu, as the profiler names them
PORT_KERNELS = ("col_partials_kernel", "finish_kernel", "bn_dx_kernel", "bn_fwd_finish_kernel",
                "bn_norm_kernel", "mbconv_kernel", "shuffle_tail_kernel",
                "bn_fwd_from_sums_kernel", "bn_bwd_coef_kernel", "dw_fwd_kernel",
                "dw_dgrad_kernel", "dw_wgrad_partial_kernel", "dw_wgrad_finish_kernel",
                "pw_fwd_kernel", "pw_dgrad_kernel", "pw_wgrad_kernel",
                "pw_wgrad_finish_kernel")
# the kernels of each BN row, as the profiler names them (the mode is the
# template argument: 1 moments, 2 backward, 3 the forward's moments)
# the backward row times `bn_backward`: bn_bwd_sums' sums and dx in one call
BWD_ROW = "bn_bwd_sums+dx (bn_backward)"
BN_ROW_KERNELS = {"bn_forward": ("col_partials_kernel<3,", "bn_fwd_finish_kernel",
                                 "bn_norm_kernel"),
                  "col_sums2": ("col_partials_kernel<1,", "finish_kernel<1>"),
                  BWD_ROW: ("col_partials_kernel<2,", "finish_kernel<2>", "bn_dx_kernel")}
# the bf16 forms' rows: the same kernels, instantiated for __nv_bfloat16
# (finish_kernel reads float32 partials and is shared; each step profile
# runs one type only)
BF16_ROWS = {"bn_forward": "bn_forward (bf16)", "col_sums2": "col_sums2 (bf16)",
             BWD_ROW: "bn_bwd_sums+dx (bn_backward, bf16)"}
BN_EPS = 1e-5
# the running statistics' update of each phase-2 forward case, in turn
BN_UPDATES = ((0.1, "unbiased"), (1.0, "biased"), (0.1, "biased"), (1.0, "unbiased"))
DEVICE = "cuda"                       # the card; a CPU rehearsal sets "cpu"
# phase 5: the CLIs' synthetic data (cli.common.make_sr_provider: 64
# training images at the batch size, 4 validation frames)
TEACHER_EPOCH_STEPS = 64 // BS
EVAL_HR = 720                         # the evaluator's HR frames: LR 180x180 at pixel_d 2
EVAL_FRAMES = 4
PSNR_TOL_DB = 1e-3                    # evaluator's mean PSNR-Y, kernels vs plain path
RM_ROUNDS = 2                         # rounds of (entry.train, train_one_epoch) timing
# phase 7: the X4 supernet
X4_STEPS = 4                          # one-subnet steps a (mode, type) run
X4_ROUNDS = 1                         # rounds of (plain, kernels, kernels, plain) step timing
X4_MODES = ("sr", "autoencoder")
# phase 12: the curriculum's batch and crops (its default, and the long
# run's CURRICULUM_r04 config)
CURRICULUM_BS, CURRICULUM_CROPS = 4, (32, 48)
# the X4 autoencoder's frames (random BN statistics over two trunks: |y| up
# to ~1.3e3) are held against float64: every float32 path, the plain cuDNN
# one included, misses the elementwise FRAME_TOL there on a few of its
# 2.8M values (where large terms cancel), at ~2e-6 of the frame's scale.
# The kernel path's max abs error against float64 at most this many times
# the larger of the two plain float32 paths' (PERF.md records the ratios
# measured: about 1, both ways)
F64_FRAME_RATIO = 1.25


def fail(msg):
    print("FAIL: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check_close(name, got, ref, tol):
    err = float((got - ref).abs().max())
    bound = float((tol["atol"] + tol["rtol"] * ref.abs()).min())
    ok = bool(torch.isfinite(got).all()) and bool(
        ((got - ref).abs() <= tol["atol"] + tol["rtol"] * ref.abs()).all())
    print("  %-58s max_abs_err %.3e  (atol %.0e + rtol %.0e*|ref|)  %s"
          % (name, err, tol["atol"], tol["rtol"], "ok" if ok else "FAIL"), flush=True)
    if not ok:
        fail("%s disagrees with its reference (max abs err %.3e, tightest bound %.3e)"
             % (name, err, bound))
    return err


def bound_ms(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(ms of the operations at `peak`, ms of the bytes at the memory rate):
    the least time is the larger of the two."""
    return flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_of(weighted):
    """Least time of launches given as [((ops ms, bytes ms), count)], and what
    bounds the larger share of it."""
    total = sum(max(t) * k for t, k in weighted)
    ops = sum(t[0] * k for t, k in weighted if t[0] >= t[1])
    return total, "operations" if 2 * ops >= total else "bytes"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def randn(g, *shape, scale=1.0, device=None):
    return (scale * torch.randn(*shape, generator=g)).to(device or DEVICE)


# -- phase 2: kernels against their plain versions ---------------------------

def mbconv_case(g, shape, m, ks, device="cuda"):
    c = shape[-1]
    x = randn(g, *shape, device=device)
    w = dict(ib_w=randn(g, c, m, scale=0.15, device=device),
             ib_b=randn(g, m, scale=0.5, device=device),
             dw_w=randn(g, ks, ks, m, scale=0.15, device=device),
             dw_b=randn(g, m, scale=0.5, device=device),
             pl_w=randn(g, m, c, scale=0.05, device=device),
             pl_b=randn(g, c, scale=0.5, device=device))
    return x, w


def shuffle_case(g, shape, device="cuda"):
    c = shape[-1]
    x = torch.rand(*shape, generator=g).to(device)
    return x, randn(g, 5, 5, c, 4 * c, scale=0.03, device=device), randn(g, 4 * c, scale=0.1, device=device)


def launched(wrapper, fn, bf16=False):
    """fn()'s result; fails unless it launched `wrapper`'s kernel once (its
    bf16 form when `bf16`, else the float32 one)."""
    before = wrapper.launches, getattr(wrapper, "launches_bf16", 0)
    out = fn()
    if (wrapper.launches, getattr(wrapper, "launches_bf16", 0)) != (before[0] + 1,
                                                                    before[1] + bf16):
        fail("%s did not launch its %s kernel" % (wrapper.__name__, "bf16" if bf16 else "float32"))
    return out


def kernel_parity(g):
    """Returns {kernel: max abs err over the path's shapes}, and the shuffle
    tail's and its plain version's max abs err against a float64 conv at
    the LR path shape."""
    errs = {"mbconv": 0.0, "shuffle_tail": 0.0}
    path = (1,) + LR_HW + (64,)
    # after the path's shapes, what the 15x16 tile and the 16-channel mid
    # chunk leave ragged: M 72 (4.5 chunks) and M 45 (not a multiple of 4:
    # the weights are copied 4 bytes at a time), C 4 (zero-padded to one k8
    # step), a frame smaller than one tile, and B 2 at the path's H and W
    for shape, m, ks, res in [(path, 384, 7, True), (path, 384, 5, True),
                              (path, 384, 3, True), ((1, 7, 13, 64), 192, 5, False),
                              ((2, 18, 20, 64), 256, 3, True), ((1, 181, 37, 16), 48, 7, True),
                              ((1, 37, 50, 64), 72, 7, True), ((1, 37, 50, 32), 45, 5, False),
                              ((1, 23, 41, 4), 24, 7, True), ((2, 5, 6, 8), 48, 7, True),
                              ((2,) + LR_HW + (64,), 384, 7, True)]:
        x, w = mbconv_case(g, shape, m, ks)
        got = launched(fused_mbconv_infer,
                       lambda: fused_mbconv_infer(x, **w, residual=res))
        torch.cuda.synchronize()
        plain = mbconv_reference(x, **w, residual=res)
        err = check_close("mbconv %s M=%d k=%d residual=%s" % (shape, m, ks, res),
                          got, plain, TOL)
        if shape == path:
            errs["mbconv"] = max(errs["mbconv"], err)
        if shape == path and ks == 7:
            ref64 = mbconv_reference(x.double(), **{k: v.double() for k, v in w.items()})
            errs["mbconv_vs_f64"] = f64_check("mbconv %s M=%d k=7" % (shape, m), got, plain,
                                              ref64)
    # x 4 bytes past a 16-byte boundary: the kernel copies its halo 4 bytes
    # at a time
    x, w = mbconv_case(g, (1, 23, 41, 64), 48, 7)
    xm = torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape).copy_(x)
    got = launched(fused_mbconv_infer, lambda: fused_mbconv_infer(xm, **w))
    torch.cuda.synchronize()
    check_close("mbconv %s M=48 k=7, x not 16-byte aligned" % (tuple(x.shape),), got,
                mbconv_reference(x, **w), TOL)
    # (1, 9, 17, 6): Cin and Cout not multiples of 4, so the kernel loads the
    # halo and stores the output one float at a time
    for shape in [path, (1, 2 * LR_HW[0], 2 * LR_HW[1], 64), (2, 7, 13, 64), (1, 9, 17, 8),
                  (1, 9, 17, 6)]:
        x, w, b = shuffle_case(g, shape)
        got = launched(fused_shuffle_tail, lambda: fused_shuffle_tail(x, w, b))
        torch.cuda.synchronize()
        err = check_close("shuffle_tail %s" % (shape,), got, shuffle_tail_reference(x, w, b), TOL)
        if shape[0] == 1 and shape[-1] == 64 and shape[1] >= LR_HW[0]:
            errs["shuffle_tail"] = max(errs["shuffle_tail"], err)
        if shape == path:
            ref64 = shuffle_tail_reference(x.double(), w.double(), b.double())
            errs["shuffle_tail_vs_f64"] = f64_check(
                "shuffle_tail %s" % (shape,), got, shuffle_tail_reference(x, w, b), ref64)
    serving_bf16_operands(g)
    return errs


def serving_bf16_operands(g):
    """As the Pallas kernels: bf16 weights with a float32 x go through the
    float32 kernel on the weights upcast (exact), and a bf16 x is refused
    without a launch."""
    bf = lambda d: {k: v.to(BF16) for k, v in d.items()}  # noqa: E731
    x, w = mbconv_case(g, (1, 37, 50, 64), 384, 7)
    got = launched(fused_mbconv_infer, lambda: fused_mbconv_infer(x, **bf(w)))
    torch.cuda.synchronize()
    check_close("mbconv (1, 37, 50, 64) M=384 k=7, bf16 weights", got,
                mbconv_reference(x, **{k: v.float() for k, v in bf(w).items()}), TOL)
    xt, wt, bt = shuffle_case(g, (1, 37, 50, 64))
    got = launched(fused_shuffle_tail, lambda: fused_shuffle_tail(xt, wt.to(BF16), bt.to(BF16)))
    torch.cuda.synchronize()
    check_close("shuffle_tail (1, 37, 50, 64), bf16 weights", got,
                shuffle_tail_reference(xt, wt.to(BF16).float(), bt.to(BF16).float()), TOL)
    before = fused_mbconv_infer.launches, fused_shuffle_tail.launches
    for name, fn in (("mbconv", lambda: fused_mbconv_infer(x.to(BF16), **w)),
                     ("shuffle_tail", lambda: fused_shuffle_tail(xt.to(BF16), wt, bt))):
        try:
            fn()
        except ValueError as e:
            print("  refused on the card: %s with a bf16 x (%s)" % (name, str(e)[:60]), flush=True)
            continue
        fail("%s took a bf16 x on the card" % name)
    if (fused_mbconv_infer.launches, fused_shuffle_tail.launches) != before:
        fail("a refused serving-kernel call launched a kernel")


def f64_check(name, got, plain, ref64):
    """The kernel's and the plain (cuDNN f32) version's max abs error against
    a float64 run of the plain version; fails when the kernel's exceeds
    F64_RATIO times the plain version's."""
    kern, pl = (float((t.double() - ref64).abs().max()) for t in (got, plain))
    ok = kern <= F64_RATIO * pl
    print("  %s against float64: max_abs_err kernel %.3e, plain (cuDNN f32) %.3e "
          "(kernel at most %.1fx plain)  %s" % (name, kern, pl, F64_RATIO,
                                                "ok" if ok else "FAIL"), flush=True)
    if not ok:
        fail("%s is less accurate than the cuDNN float32 composition against float64 "
             "(%.3e > %.1f x %.3e)" % (name, kern, F64_RATIO, pl))
    return {"kernel": kern, "plain": pl}


def check_sums(name, got, ref, terms):
    """Column sums: |got - ref| <= SUM_RTOL * sum|terms|, per column."""
    err = float((got - ref).abs().max())
    bound = SUM_RTOL * terms.abs().sum(0)
    ok = bool(torch.isfinite(got).all()) and bool(((got - ref).abs() <= bound).all())
    print("  %-58s max_abs_err %.3e  (%.0e * sum|terms|)  %s"
          % (name, err, SUM_RTOL, "ok" if ok else "FAIL"), flush=True)
    if not ok:
        fail("%s disagrees with its reference (max abs err %.3e)" % (name, err))
    return err


def path_bn_shapes():
    """The training paths' distinct BN shapes: the S4's 1-subnet steps' and
    the X4's steps of phase 7 in both modes (the unshuffle convs' C 16 at
    147,456 and 36,864 rows, the encoder output's C 3 at 9,216 and
    36,864), and the curriculum's X4 sr steps (phase 12 and the long run:
    batch 4 of 32 and 48 px crops, every expand ratio, pixel_d 1 and 2:
    the decoder's C 64-384 at 256 to 2,304 rows)."""
    space = SearchSpace()
    cfgs = [step_subnets(space, i, 1)[0] for i in range(TRAIN_STEPS)]
    shapes = {s for c in cfgs for s in bn_train_shapes(space, c, BS, HR)}
    shapes |= {s for c in x4_step_cfgs() for mode in X4_MODES
               for s in x4_bn_train_shapes(space, c, mode)}
    shapes |= {s for hr in CURRICULUM_CROPS for e in space.expand_list
               for pd in space.pixel_d_list
               for s in x4_bn_train_shapes(space, uniform_subnet(space, 7, e, 2, pd, n_trunks=2),
                                           "sr", bs=CURRICULUM_BS, hr=hr)}
    return sorted(shapes)


def offset(t, k):
    """A copy of `t` whose data starts k elements past an allocation (k > 0:
    rows off a 16-byte boundary, so the kernels take narrower loads)."""
    if k == 0:
        return t
    return torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:].view(t.shape).copy_(t)


def bn_parity(g, dtype=torch.float32):
    """The four BN wrappers against their plain versions at the training
    path's shapes and ragged ones, on `dtype` activations (float32, or bf16
    for the bf16 forms, the plain versions reading the same bf16 tensors);
    returns {kernel: max abs err at the path's shapes} (of the moments for
    col_sums2, and of dx for the backward, as the path uses them)."""
    bf16 = dtype is BF16
    tag = " bf16" if bf16 else ""
    key = "_bf16" if bf16 else ""
    errs = {"col_sums2" + key: 0.0, "bn_bwd_sums" + key: 0.0}
    cases = [(s, True, 0) for s in path_bn_shapes()]
    cases += [((n, 1, 1, c), False, 0) for n in (1000, 37) for c in (3, 17, 48)]
    if bf16:
        # C 6: 4-byte loads of 2 columns; C 24: 16-byte loads of 8 at a small
        # C; rows 2 and 4 bytes past a 16-byte boundary at C 64: loads of 1
        # and of 2 columns
        cases += [((1000, 1, 1, 6), False, 0), ((37, 1, 1, 24), False, 0),
                  ((300, 1, 1, 64), False, 1), ((300, 1, 1, 64), False, 2)]
    dx_tol = BF16_DX_TOL if bf16 else TOL
    for shape, on_path, k in cases:
        n, c = int(np.prod(shape[:3])), shape[3]
        a = offset(randn(g, n, c).to(dtype), k)
        b = offset((randn(g, n, c, scale=0.5) + 0.25).to(dtype), k)
        got = launched(col_sums2, lambda: col_sums2(a, b), bf16)
        torch.cuda.synchronize()
        af, bf = a.float(), b.float()
        for i, (u, v, terms) in enumerate(zip(got, col_sums2_reference(a, b), (af, af * bf))):
            check_sums("col_sums2%s s%d %s" % (tag, i + 1, (n, c)), u, v, terms)
        x = offset((1.5 * randn(g, *shape) + 0.3).to(dtype).contiguous(), k)
        got = launched(bn_moments, lambda: bn_moments(x), bf16)
        torch.cuda.synchronize()
        for i, (u, v) in enumerate(zip(got, bn_moments_reference(x))):
            err = check_close("bn_moments%s %s %s" % (tag, ("mean", "var")[i], shape), u, v,
                              MOMENT_TOL)
            if on_path:
                errs["col_sums2" + key] = max(errs["col_sums2" + key], err)
        dy, xf = offset(randn(g, n, c).to(dtype), k), x.view(n, c)
        mean, var = bn_moments_reference(x)
        inv = torch.rsqrt(var + 1e-5)
        got = launched(bn_bwd_sums, lambda: bn_bwd_sums(dy, xf, mean, inv), bf16)
        torch.cuda.synchronize()
        dyf, xhat = dy.float(), (xf.float() - mean) * inv
        for i, (u, v, terms) in enumerate(zip(got, bn_bwd_sums_reference(dy, xf, mean, inv),
                                              (dyf, dyf * xhat))):
            check_sums("bn_bwd_sums%s s%d %s" % (tag, i + 1, (n, c)), u, v, terms)
        # the fused backward, as bn_train_fused calls it (NHWC dy and x)
        scale = (0.5 + torch.rand(c, generator=g)).to(DEVICE)
        dy4 = dy.view(shape)
        dx, ds, db = launched(bn_backward, lambda: bn_backward(dy4, x, scale, mean, inv), bf16)
        torch.cuda.synchronize()
        if dx.dtype is not dtype or ds.dtype is not torch.float32:
            fail("bn_backward%s returned dx %s, dscale %s" % (tag, dx.dtype, ds.dtype))
        dx_p, ds_p, db_p = bn_backward_reference(dy4, x, scale, mean, inv)
        err = check_close("bn_backward%s dx %s" % (tag, shape), dx.float(), dx_p.float(), dx_tol)
        check_sums("bn_backward%s dscale %s" % (tag, (n, c)), ds, ds_p, dyf * xhat)
        check_sums("bn_backward%s dbias %s" % (tag, (n, c)), db, db_p, dyf)
        if on_path:
            errs["bn_bwd_sums" + key] = max(errs["bn_bwd_sums" + key], err)
    return errs


def check_bits(name, got, ref):
    """got and ref bit for bit (same shape and type); on a mismatch, fails
    with the largest distance in steps of their type."""
    same = got.dtype == ref.dtype and got.shape == ref.shape and torch.equal(got, ref)
    if not same:
        ints = {torch.float32: torch.int32, BF16: torch.int16}[ref.dtype]

        def order(t):  # the bit patterns in a monotonic integer order
            i = t.contiguous().view(ints).long()
            return torch.where(i < 0, torch.iinfo(ints).min - i, i)
        steps = int((order(got.to(ref.dtype)) - order(ref)).abs().max())
        fail("%s differs from its plain version by up to %d steps of %s (expected the same "
             "bits: same association)" % (name, steps, ref.dtype))
    return same


def bn_forward_parity(g, dtype=torch.float32):
    """`bn_forward` against its plain version on the card, at every BN
    shape of the training path and at C 3, 17, 100 (a ragged second tile of
    64 columns), N 1 and rows off a 16-byte boundary (4 bytes in float32;
    2 and 4 in bf16, and C 6 and 24 there), the running statistics as
    prefix views of longer buffers and the four (momentum, update_var)
    pairs in turn. The moments are held to `bn_moments_reference` (other sum
    order: MOMENT_TOL); inv, y and both running statistics, bit for bit, to
    the plain ops on the kernel's own moments (`bn_forward_from_moments`,
    the same association); y also to the whole plain version (TOL, a bf16 y
    within one ulp: BF16_DX_TOL); a second call on the same input gives the
    same bits. Returns {"bn_forward"[_bf16]: max abs err of y against the
    plain version at the path's shapes}."""
    bf16 = dtype is BF16
    tag, key = (" bf16", "_bf16") if bf16 else ("", "")
    err_key = "bn_forward" + key
    errs = {err_key: 0.0}
    cases = [(s, True, 0) for s in path_bn_shapes()]
    cases += [((n, 1, 1, c), False, 0) for n in (1000, 37) for c in (3, 17, 100)]
    cases += [((1, 1, 1, 8), False, 0), ((300, 1, 1, 64), False, 1)]
    if bf16:
        cases += [((1000, 1, 1, 6), False, 0), ((37, 1, 1, 24), False, 0),
                  ((300, 1, 1, 64), False, 2)]
    y_tol = BF16_DX_TOL if bf16 else TOL
    for i, (shape, on_path, k) in enumerate(cases):
        momentum, update_var = BN_UPDATES[i % len(BN_UPDATES)]
        c = shape[3]
        x = offset((1.5 * randn(g, *shape) + 0.3).to(dtype).contiguous(), k)
        scale, bias = (0.5 + torch.rand(c, generator=g)).to(DEVICE), randn(g, c, scale=0.2)
        rm0, rv0 = randn(g, c + 5, scale=0.2), (0.5 + torch.rand(c + 5, generator=g)).to(DEVICE)
        kw = dict(momentum=momentum, eps=BN_EPS, update_var=update_var)
        runs = []
        for _ in range(2):  # the second: the determinism check
            rm, rv = rm0.clone(), rv0.clone()
            out = launched(bn_forward, lambda: bn_forward(x, scale, bias, rm[:c], rv[:c], **kw),
                           bf16)
            runs.append(out + (rm, rv))
        torch.cuda.synchronize()
        y, mean, var, inv, rm, rv = runs[0]
        name = "bn_forward%s %s m=%s %s" % (tag, shape, momentum, update_var)
        if y.dtype is not dtype or y.shape != x.shape or inv.dtype is not torch.float32:
            fail("%s returned y %s %s, inv %s" % (name, y.dtype, tuple(y.shape), inv.dtype))
        for a, b in zip(runs[0], runs[1]):
            if not torch.equal(a, b):
                fail("%s: two calls on one input gave different bits" % name)
        for j, (u, v) in enumerate(zip((mean, var), bn_moments_reference(x))):
            check_close("%s %s" % (name, ("mean", "var")[j]), u, v, MOMENT_TOL)
        rm_p, rv_p = rm0.clone(), rv0.clone()
        y_m, _, _, inv_m = bn_forward_from_moments(x, scale, bias, rm_p[:c], rv_p[:c], mean,
                                                   var, **kw)
        for part, u, v in (("inv", inv, inv_m), ("y", y, y_m), ("running_mean", rm, rm_p),
                           ("running_var", rv, rv_p)):
            check_bits("%s %s" % (name, part), u, v)
        if not (torch.equal(rm[c:], rm0[c:]) and torch.equal(rv[c:], rv0[c:])):
            fail("%s wrote past the running statistics' prefix" % name)
        y_p = bn_forward_reference(x, scale, bias, rm0.clone()[:c], rv0.clone()[:c], **kw)[0]
        err = check_close(name + " y vs plain", y.float(), y_p.float(), y_tol)
        print("  %-58s inv, y, running stats bit for bit; deterministic" % name, flush=True)
        if on_path:
            errs[err_key] = max(errs[err_key], err)
    return errs


def bn_dtype_rule():
    """The BN wrappers refuse, on the card, activations the kernels do not
    take (float16; a bf16 dy with a float32 x), launching nothing."""
    x16 = torch.zeros(64, 8, device=DEVICE, dtype=torch.float16)
    xb, xf = torch.zeros(64, 8, device=DEVICE, dtype=BF16), torch.zeros(64, 8, device=DEVICE)
    v = torch.ones(8, device=DEVICE)
    kernels = BN_KERNELS + BN_OFF_PATH + (bn_bwd_sums,)
    before = [(k.launches, k.launches_bf16) for k in kernels]
    for name, fn in (("float16 moments", lambda: bn_moments(x16.view(1, 8, 8, 8))),
                     ("float16 forward", lambda: bn_forward(x16.view(1, 8, 8, 8), v, v, v, v,
                                                            momentum=0.1)),
                     ("bf16 running stats", lambda: bn_forward(xf, v, v, v.to(BF16), v,
                                                               momentum=0.1)),
                     ("float16 backward", lambda: bn_backward(x16, x16, v, v, v)),
                     ("bf16 dy, float32 x", lambda: bn_backward(xb, xf, v, v, v)),
                     ("float32 a, bf16 b", lambda: col_sums2(xf, xb))):
        try:
            fn()
        except ValueError as e:
            print("  refused on the card: %-24s (%s)" % (name, str(e)[:70]), flush=True)
            continue
        fail("the BN wrappers took %s on the card" % name)
    if [(k.launches, k.launches_bf16) for k in kernels] != before:
        fail("a refused BN call launched a kernel")


def bn_grad_check(g, dtype=torch.float32):
    """Train-mode BN through the kernels (bn_train_fused: one bn_forward and
    one bn_backward launch) against the plain autograd branch on the card:
    y, dx, dscale, dbias, running stats; on
    bf16 x with float32 scale and bias for the bf16 forms (y and dx within
    one bf16 ulp)."""
    bf16 = dtype is BF16
    shapes = [(BS, 48, 48, 64), (BS, 48, 48, 384), (BS, HR, HR, 3), (BS, 24, 24, 256),
              (2, 5, 7, 17)]
    if bf16:
        shapes = [(BS, 48, 48, 64), (BS, HR, HR, 3), (2, 5, 7, 17)]
    tol = BF16_DX_TOL if bf16 else TOL
    for shape in shapes:
        c = shape[-1]
        x0 = (1.5 * randn(g, *shape) + 0.3).to(dtype)
        w = randn(g, *shape).to(dtype)
        scale0, bias0 = 0.5 + torch.rand(c, generator=g), 0.2 * torch.randn(c, generator=g)
        rm0, rv0 = 0.2 * torch.randn(c, generator=g), 0.5 + torch.rand(c, generator=g)
        out = {}
        for uk in (True, False):
            x = x0.clone().requires_grad_()
            scale, bias = (t.to(x0.device).requires_grad_() for t in (scale0, bias0))
            rm, rv = rm0.to(x0.device), rv0.to(x0.device)
            before = [(k.launches, k.launches_bf16) for k in BN_KERNELS]
            y = batch_norm_train(x, scale, bias, rm, rv, use_kernels=uk)
            y.backward(w)
            if uk and x.is_cuda and [(k.launches, k.launches_bf16) for k in BN_KERNELS] != [
                    (n + 1, nb + bf16) for n, nb in before]:
                fail("bn_train_fused did not launch bn_forward and bn_backward once each")
            out[uk] = (y.detach(), x.grad, scale.grad, bias.grad, rm, rv)
        torch.cuda.synchronize()
        (y, dx, ds, db, rm, rv), (y_p, dx_p, ds_p, db_p, rm_p, rv_p) = out[True], out[False]
        if y.dtype is not dtype or dx.dtype is not dtype or ds.dtype is not torch.float32:
            fail("bn_train_fused returned y %s, dx %s, dscale %s" % (y.dtype, dx.dtype, ds.dtype))
        name = "bn_train_fused%s %s" % (" bf16" if bf16 else "", shape)
        check_close(name + " y", y.float(), y_p.float(), tol)
        check_close(name + " dx", dx.float(), dx_p.float(), tol)
        xf, wf = x0.float(), w.float()
        xhat = ((xf - xf.mean((0, 1, 2))) * torch.rsqrt(xf.var((0, 1, 2), correction=0) + 1e-5))
        check_sums(name + " dscale", ds, ds_p, (wf * xhat).reshape(-1, c))
        check_sums(name + " dbias", db, db_p, wf.reshape(-1, c))
        check_close(name + " running_mean", rm, rm_p, MOMENT_TOL)
        check_close(name + " running_var", rv, rv_p, MOMENT_TOL)


def masked_bn_shapes():
    """The masked training step's BN shapes with an active width: the S4's
    (and the X4 sr decoder's) expand and depthwise BNs at the max middle
    width, C 384 whatever the subnet, for bs16 at 96 px, pixel_d 1 and 2
    (36,864 and 9,216 rows), with each middle-width candidate as the
    width."""
    space = SearchSpace()
    c = max(space.mid_candidates())
    return [((BS, HR // 2 ** pd, HR // 2 ** pd, c), m) for pd in space.pixel_d_list
            for m in space.mid_candidates()]


def cls_masked_bn_cases():
    """The classification masked step's BN shapes with an active width
    (batch 64 at 224 px, every block at its max middle width): MBV3's first
    expand, C 96 at 112x112 (802,816 rows), at widths 0 (a gated-off
    block), 48, 72 and 96; the widest middles at 7x7 (3,136 rows), MBV3's
    C 960 and Proxyless's 1,152, at widths 0, half and C; and a ragged
    shape at 0 and 77. Each (shape, width, on the path)."""
    cases = [((CLS_TRAIN_BATCH, 112, 112, 96), m, True) for m in (0, 48, 72, 96)]
    cases += [((CLS_TRAIN_BATCH, 7, 7, c), m, True) for c in (960, 1152)
              for m in (0, c // 2, c)]
    return cases + [((5, 9, 11, 200), m, False) for m in (0, 77)]


def bn_active_parity(g, dtype=torch.float32, cases=None, key="_active"):
    """`bn_forward` and `bn_backward` with the active-width operand (the
    masked step's) against their plain versions with it, at the masked
    path's shapes and two ragged ones: the forward's inv, y and running
    statistics bit for bit against the plain ops on the kernel's own
    moments with the same operand, y 0 and the running statistics unchanged
    from the width on, y against the whole plain version (TOL; a bf16 y
    within one ulp); an active width of C gives the bits of the call
    without the operand; the backward's dx (TOL / one bf16 ulp), dscale and
    dbias (column sums), each exactly 0 from the width on; and train-mode
    BN through the kernels with the operand against the plain autograd
    branch with it (y, dx, dscale, dbias, running statistics). `cases`:
    (shape, width, on the path) triples in place of the SR step's (the
    classification step's, `cls_masked_bn_cases`, with `key` "_active_cls").
    Returns {"bn_forward" + key [+ "_bf16"], "bn_backward" + key [+ "_bf16"]:
    max abs err at the path's shapes}."""
    bf16 = dtype is BF16
    tag, key = (" bf16", key + "_bf16") if bf16 else ("", key)
    errs = {"bn_forward" + key: 0.0, "bn_backward" + key: 0.0}
    tol = BF16_DX_TOL if bf16 else TOL
    kw = dict(momentum=0.1, eps=BN_EPS, update_var="unbiased")
    if cases is None:
        cases = [(shape, m, True) for shape, m in masked_bn_shapes()]
        cases += [((37, 1, 1, 17), 5, False), ((1000, 1, 1, 100), 64, False)]
    for shape, m, on_path in cases:
        n, c = int(np.prod(shape[:3])), shape[3]
        name = "bn_forward%s %s active %d" % (tag, shape, m)
        x = (1.5 * randn(g, *shape) + 0.3).to(dtype).contiguous()
        scale, bias = (0.5 + torch.rand(c, generator=g)).to(DEVICE), randn(g, c, scale=0.2)
        rm0, rv0 = randn(g, c, scale=0.2), (0.5 + torch.rand(c, generator=g)).to(DEVICE)
        active = torch.tensor(m, dtype=torch.int32, device=DEVICE)
        rm, rv = rm0.clone(), rv0.clone()
        y, mean, var, inv = launched(
            bn_forward, lambda: bn_forward(x, scale, bias, rm, rv, active=active, **kw), bf16)
        full = [rm0.clone(), rv0.clone()]
        y_full = launched(bn_forward, lambda: bn_forward(
            x, scale, bias, *full, active=torch.tensor(c, dtype=torch.int32, device=DEVICE),
            **kw), bf16)[0]
        bare = [rm0.clone(), rv0.clone()]
        y_bare = launched(bn_forward, lambda: bn_forward(x, scale, bias, *bare, **kw), bf16)[0]
        torch.cuda.synchronize()
        rm_p, rv_p = rm0.clone(), rv0.clone()
        y_m, _, _, inv_m = bn_forward_from_moments(x, scale, bias, rm_p, rv_p, mean, var,
                                                   active=active, **kw)
        for part, u, v in (("inv", inv, inv_m), ("y", y, y_m), ("running_mean", rm, rm_p),
                           ("running_var", rv, rv_p), ("y at active C", y_full, y_bare),
                           ("running_mean at active C", full[0], bare[0]),
                           ("running_var at active C", full[1], bare[1])):
            check_bits("%s %s" % (name, part), u, v)
        if (y[..., m:].any() or not torch.equal(rm[m:], rm0[m:])
                or not torch.equal(rv[m:], rv0[m:])):
            fail("%s: y is not 0, or a running statistic changed, past the width" % name)
        y_p = bn_forward_reference(x, scale, bias, rm0.clone(), rv0.clone(), active=active,
                                   **kw)[0]
        err = check_close(name + " y vs plain", y.float(), y_p.float(), tol)
        dy = randn(g, *shape).to(dtype)
        dx, ds, db = launched(bn_backward, lambda: bn_backward(dy, x, scale, mean, inv,
                                                               active=active), bf16)
        torch.cuda.synchronize()
        dx_p, ds_p, db_p = bn_backward_reference(dy, x, scale, mean, inv, active=active)
        bname = "bn_backward%s %s active %d" % (tag, shape, m)
        err_b = check_close(bname + " dx", dx.float(), dx_p.float(), tol)
        live = (torch.arange(c, device=DEVICE) < m).float()
        dyf = dy.view(n, c).float() * live
        xhat = (x.view(n, c).float() - mean) * inv
        check_sums(bname + " dscale", ds, ds_p, dyf * xhat)
        check_sums(bname + " dbias", db, db_p, dyf)
        if dx[..., m:].any() or ds[m:].any() or db[m:].any():
            fail("%s: dx, dscale or dbias is not 0 past the width" % bname)
        if on_path:
            errs["bn_forward" + key] = max(errs["bn_forward" + key], err)
            errs["bn_backward" + key] = max(errs["bn_backward" + key], err_b)
    shape, m = masked_bn_shapes()[0]
    c = shape[3]
    x0, w = (1.5 * randn(g, *shape) + 0.3).to(dtype), randn(g, *shape).to(dtype)
    scale0, bias0 = 0.5 + torch.rand(c, generator=g), 0.2 * torch.randn(c, generator=g)
    rm0, rv0 = 0.2 * torch.randn(c, generator=g), 0.5 + torch.rand(c, generator=g)
    active = torch.tensor(m, dtype=torch.int32, device=DEVICE)
    out = {}
    for uk in (True, False):
        x = x0.clone().requires_grad_()
        scale, bias = (t.to(DEVICE).requires_grad_() for t in (scale0, bias0))
        rm, rv = rm0.to(DEVICE), rv0.to(DEVICE)
        y = batch_norm_train(x, scale, bias, rm, rv, use_kernels=uk, active=active)
        y.backward(w)
        out[uk] = (y.detach(), x.grad, scale.grad, bias.grad, rm, rv)
    torch.cuda.synchronize()
    (y, dx, ds, db, rm, rv), (y_p, dx_p, ds_p, db_p, rm_p, rv_p) = out[True], out[False]
    name = "bn_train_fused%s %s active %d" % (tag, shape, m)
    check_close(name + " y", y.float(), y_p.float(), tol)
    check_close(name + " dx", dx.float(), dx_p.float(), tol)
    xf, wf = x0.float(), w.float() * (torch.arange(c, device=DEVICE) < m)
    xhat = ((xf - xf.mean((0, 1, 2))) * torch.rsqrt(xf.var((0, 1, 2), correction=0) + 1e-5))
    check_sums(name + " dscale", ds, ds_p, (wf * xhat).reshape(-1, c))
    check_sums(name + " dbias", db, db_p, wf.reshape(-1, c))
    check_close(name + " running_mean", rm, rm_p, MOMENT_TOL)
    check_close(name + " running_var", rv, rv_p, MOMENT_TOL)
    return errs


# -- phase 3: serving --------------------------------------------------------

# -- phase 2: the masked depthwise (csrc/dw_masked.cu) -------------------------

# the three directions' wrappers, each counting its calls (one a call: the
# wgrad's two launches included), and their kernels as the profiler names them
DW_WRAPPERS = (dw_masked_forward, dw_masked_dgrad, dw_masked_wgrad)
DW_ROW_KERNELS = {"dw_masked_forward": ("dw_fwd_kernel",),
                  "dw_masked_dgrad": ("dw_dgrad_kernel",),
                  "dw_masked_wgrad": ("dw_wgrad_partial_kernel", "dw_wgrad_finish_kernel")}
DW_KS = (3, 5, 7)                      # the nets' kernel sizes: a 7x7 bank
DW_ALIGNS = (0, 128)
# dW against a float64 run of the plain version: its max abs error no more
# than the plain version's (cuDNN in the same type) plus this share of dW's
# largest magnitude. float32: both sum 9,216 to 802,816 rows in float32, in
# other orders (1e-5 is ~80 float32 ulps of the largest dW); bf16: each
# rounds its float32 sum once, so the two may straddle a rounding boundary:
# half a bf16 ulp (2^-8 of the value)
DW_F64_MARGIN = {"f32": 1e-5, "bf16": 2.0 ** -8}
# the lever the graphed windows of phases 8 (e), 13 and 14 run with
DW_LEVER = dict(dw_switch=True)


def zero_counts(wrappers):
    for k in wrappers:
        k.launches = k.launches_bf16 = 0


def counts_of(wrappers):
    counts = {k.__name__: k.launches for k in wrappers}
    counts.update({k.__name__ + "_bf16": k.launches_bf16 for k in wrappers})
    return counts


def counts_wrong(wrappers, what, counts, expect, bf16):
    """Why `counts` is not each of `wrappers` (the directions of `what`)
    launched `expect` times, all of the run's type; None if it is."""
    got = {k.__name__: counts[k.__name__] for k in wrappers}
    if any(v != expect for v in got.values()):
        return "%s launches %s, expected %d each" % (what, got, expect)
    if any(counts[k.__name__ + "_bf16"] != (expect if bf16 else 0) for k in wrappers):
        return "launched %s kernels of the other type" % what
    return None


def dw_masked_cases():
    """Phase 2's masked depthwise shapes: (label, x shape, stride, the
    active widths). The S4 masked step's (bs16, LR 48 and 24 at pixel_d 1
    and 2: 36,864 and 9,216 rows; its bank width 384 with the middle widths
    192 and 256 on the candidate grid, 200 off it, 0 and C; the banks of
    widths 192 and 256 at their full width) and MBV3's at batch 64, 224 px
    (C 96 at 112x112, stride 1 and 2: 802,816 input rows; C 960 at 7x7). Each
    width is run as the bound (the nets' lever passes the width) and
    rounded up to a multiple of 128 (the bounds of the JAX package's
    dw_align 128)."""
    cases = []
    for lr in (HR // 2, HR // 4):
        cases.append(("S4", (BS, lr, lr, 384), 1, (0, 192, 200, 256, 384)))
        cases += [("S4", (BS, lr, lr, c), 1, (c,)) for c in (192, 256)]
    cases += [("MBV3", (CLS_TRAIN_BATCH, 112, 112, 96), s, (0, 64, 72, 96)) for s in (1, 2)]
    cases.append(("MBV3", (CLS_TRAIN_BATCH, 7, 7, 960), 1, (0, 480, 500, 960)))
    # the tiled kernel's edges: a C whose bf16 pixel rows are not a multiple
    # of 16 bytes (C 100: 4-byte copies), an odd C (37: 2-byte bf16 copies,
    # one-value stores), odd sides at stride 2, and widths ragged against
    # the 16-column output tile and the stride-2 dgrad's 32-column dx tile
    cases += [("edge", (8, 20, 36, 100), 1, (0, 50, 100)),
              ("edge", (8, 15, 15, 100), 2, (0, 50, 100)),
              ("edge", (4, 13, 21, 37), 1, (0, 19, 37)),
              ("edge", (4, 15, 45, 37), 2, (0, 19, 37))]
    return cases


def dw_smem_bytes():
    """The masked depthwise's dynamic shared memory a block, by direction,
    bank size, stride and type, as csrc/dw_masked.cu sizes it; fails unless
    the wrapper's mirror of its tiling (`dw_masked.smem_bytes`) agrees."""
    query = _build.load("dw_masked").ofa_dw_masked_smem_bytes
    query.argtypes, query.restype = [ctypes.c_int] * 4, ctypes.c_int
    out = {}
    for di, d in enumerate(("fwd", "dgrad", "wgrad")):
        for k in (3, 5, 7):
            for bf16 in (False, True):
                got = [query(di, k, s, int(bf16)) for s in (1, 2)]
                mirror = [dw_smem_mirror(d, k, s, BF16 if bf16 else torch.float32)
                          for s in (1, 2)]
                if got != mirror:
                    fail("dw_masked %s K %d: shared memory %s bytes, the wrapper's tiling says %s"
                         % (d, k, got, mirror))
                out["%s K%d %s" % (d, k, "bf16" if bf16 else "f32")] = got
    return out


def pw_smem_bytes():
    """The masked 1x1's dynamic shared memory a block, by form (a forward or
    dgrad bounded on N or on K, at the S4 step's (K, N) and phase 2's edge,
    and the wgrad) and type, as csrc/pw_masked.cu sizes it; fails unless
    the wrapper's mirror (`pw_masked.smem_bytes`) agrees."""
    query = _build.load("pw_masked").ofa_pw_masked_smem_bytes
    query.argtypes, query.restype = [ctypes.c_int] * 4, ctypes.c_int
    shapes = {"bound_n": ((64, 384), (24, 72), (40, 72)),
              "bound_k": ((384, 64), (72, 40), (72, 24)), "wgrad": ((0, 0),)}
    out = {}
    for form, d in enumerate(("bound_n", "bound_k", "wgrad")):
        for bf16 in (False, True):
            dtype = BF16 if bf16 else torch.float32
            for k, n in shapes[d]:
                got = query(form, int(bf16), k, n)
                mirror = pw_smem_mirror(d, dtype, k, n)
                if got != mirror:
                    fail("pw_masked %s K %d N %d %s: shared memory %d bytes, the wrapper's plan "
                         "says %d" % (d, k, n, dtype, got, mirror))
                out["%s K%d N%d %s" % (d, k, n, "bf16" if bf16 else "f32")] = got
    return out


def dw_close(name, got, ref, tol):
    """check_close without its line: max abs err, or fail."""
    err = float((got.float() - ref.float()).abs().max())
    ok = bool(torch.isfinite(got).all()) and bool(
        ((got.float() - ref.float()).abs() <= tol["atol"] + tol["rtol"] * ref.float().abs())
        .all())
    if not ok:
        fail("%s disagrees with its plain version (max abs err %.3e)" % (name, err))
    return err


def dw_masked_parity(g, dtype=torch.float32):
    """The masked depthwise's three directions against the plain version
    (cuDNN's grouped conv of x * cmask and w * tapmask, and its autograd),
    TF32 off, at `dw_masked_cases` for every kernel size and bound, on
    `dtype` (float32, or bf16 for the bf16 entry points): y and dx within TOL
    (bf16: BF16_DX_TOL); dW no farther from a float64 run of the plain
    version than the plain version is, plus DW_F64_MARGIN of its largest
    magnitude; exact zeros from the bound on (y, dx, dW) and outside the
    k x k window (dW); two calls the same bits, each direction. Returns
    {wrapper: max abs err} and the dW errors against float64."""
    bf16 = dtype is BF16
    key = "_bf16" if bf16 else ""
    tol = BF16_DX_TOL if bf16 else TOL
    errs = {k.__name__ + key: 0.0 for k in DW_WRAPPERS}
    f64 = {"kernel": 0.0, "plain": 0.0}
    t0, n_cases = time.perf_counter(), 0
    for label, shape, stride, widths in dw_masked_cases():
        c = shape[-1]
        ho, wo = out_size(shape[1], 7, stride), out_size(shape[2], 7, stride)
        x = randn(g, *shape).to(dtype)
        dy = randn(g, shape[0], ho, wo, c).to(dtype)
        w = randn(g, c, 1, 7, 7, scale=0.1).to(dtype)
        kw = dict(ks_list=DW_KS, stride=stride)
        # the float64 dW at every tap and channel: a bound and a window
        # only mask it (the wgrad does not read w)
        full = torch.tensor(len(DW_KS) - 1, dtype=torch.int32, device=DEVICE)
        every = torch.tensor(c, dtype=torch.int32, device=DEVICE)
        dw64 = masked_depthwise_grads_reference(x.double(), w.double(), full, every,
                                                dy.double(), **kw)[1]
        bounds = sorted({min(-(-m // a) * a, c) if a else m for m in widths for a in DW_ALIGNS})
        for bnd in bounds:
            bt = torch.tensor(bnd, dtype=torch.int32, device=DEVICE)
            live = bnd
            for ki in range(len(DW_KS)):
                kt = torch.tensor(ki, dtype=torch.int32, device=DEVICE)
                name = "%s %s stride %d ks %d bound %s%s" % (label, tuple(shape), stride,
                                                             DW_KS[ki], bnd, key)
                outs = [launched(dw_masked_forward, lambda: dw_masked_forward(
                            x, w, kt, bt, **kw), bf16),
                        launched(dw_masked_dgrad, lambda: dw_masked_dgrad(
                            dy, w, kt, bt, in_hw=shape[1:3], **kw), bf16),
                        launched(dw_masked_wgrad, lambda: dw_masked_wgrad(
                            x, dy, kt, bt, bank_ks=7, **kw), bf16)]
                again = [dw_masked_forward(x, w, kt, bt, **kw),
                         dw_masked_dgrad(dy, w, kt, bt, in_hw=shape[1:3], **kw),
                         dw_masked_wgrad(x, dy, kt, bt, bank_ks=7, **kw)]
                torch.cuda.synchronize()
                for d, a, b in zip(DW_WRAPPERS, outs, again):
                    if not torch.equal(a, b):
                        fail("%s: two calls of %s differ" % (name, d.__name__))
                y, dx, dw = outs
                yr = masked_depthwise_reference(x, w, kt, bt, **kw)
                dxr, dwr = masked_depthwise_grads_reference(x, w, kt, bt, dy, **kw)
                errs["dw_masked_forward" + key] = max(errs["dw_masked_forward" + key],
                                                      dw_close(name + " y", y, yr, tol))
                errs["dw_masked_dgrad" + key] = max(errs["dw_masked_dgrad" + key],
                                                    dw_close(name + " dx", dx, dxr, tol))
                tm = tap_mask(kt, DW_KS, 7, DEVICE).bool()
                ref64 = dw64 * tm.double()
                ref64[live:] = 0
                kern, pl = (float((t.double() - ref64).abs().max()) for t in (dw, dwr))
                margin = DW_F64_MARGIN["bf16" if bf16 else "f32"] * float(ref64.abs().max())
                if not kern <= pl + margin:
                    fail("%s dW: %.3e from float64, the plain version %.3e (+ margin %.3e)"
                         % (name, kern, pl, margin))
                f64["kernel"], f64["plain"] = max(f64["kernel"], kern), max(f64["plain"], pl)
                errs["dw_masked_wgrad" + key] = max(errs["dw_masked_wgrad" + key],
                                                    float((dw.float() - dwr.float()).abs().max()))
                if (y[..., live:].any() or dx[..., live:].any() or dw[live:].any()
                        or dw[:, :, ~tm].any()):
                    fail("%s: a value past the bound or outside the %dx%d window is not 0"
                         % (name, DW_KS[ki], DW_KS[ki]))
                n_cases += 1
        print("  masked depthwise %s %s stride %d%s: %d bounds x %d kernel sizes ok (y/dx/dW "
              "max abs err vs plain so far %.3e / %.3e / %.3e; dW vs float64 %.3e, plain %.3e)"
              % (label, tuple(shape), stride, " bf16" if bf16 else "", len(bounds), len(DW_KS),
                 errs["dw_masked_forward" + key], errs["dw_masked_dgrad" + key],
                 errs["dw_masked_wgrad" + key], f64["kernel"], f64["plain"]), flush=True)
        del x, dy, w, dw64
        torch.cuda.empty_cache()
    errs["dw_masked_wgrad_vs_f64" + key] = f64
    print("  masked depthwise%s: %d cases, two calls the same bits each, %.1f s"
          % (" bf16" if bf16 else "", n_cases, time.perf_counter() - t0), flush=True)
    return errs


PW_WRAPPERS = (pw_masked_forward, pw_masked_dgrad, pw_masked_wgrad)
PW_ROW_KERNELS = {"pw_masked_forward": ("pw_fwd_kernel",),
                  "pw_masked_dgrad": ("pw_dgrad_kernel",),
                  "pw_masked_wgrad": ("pw_wgrad_kernel", "pw_wgrad_finish_kernel")}
# the expand lever with the depthwise lever: the lever case of phases 6 and 13
PW_LEVER = dict(dw_switch=True, expand_switch=True)
PW_LABEL = "expand_switch + dw_switch"
# float32 (3xTF32) products against float64: the kernel's max abs error no
# more than the plain version's (cuBLAS in float32, TF32 off) plus this
# share of the product's largest magnitude. 3xTF32 keeps float32's accuracy
# (each product to ~2^-22 of its value; the kernel adds each k8 step's
# three products into its float32 sum with a rounded add), the two sum in
# other orders: 1e-5 is ~80 float32 ulps of the largest value
PW_F64_MARGIN = 1e-5
# a bf16 product: within one bf16 ulp of the float64 product rounded to bf16
# once (the two may straddle a rounding boundary), plus 2^-16 of the sum of
# the terms' magnitudes, the float32 sum's own error in another order where
# the product cancels (K/8 rounded adds of 2^-24 each at K 384; the wgrads'
# runs of 448 rows and their partials)
PW_BF16_SUM_SHARE = 2.0 ** -16


def pw_masked_cases():
    """Phase 2's masked 1x1 shapes: (label, NHWC shape of the rows, Cin, M,
    Cout, the bounds). The S4 masked step's (bs16, LR 48 and 24: 36,864 and
    9,216 rows; Cin = Cout = 64, the bank width M 384; widths 192 and 256
    on the candidate grid, 200 off it, 0 and 384) and the GEMM's edges:
    1,000 rows (ragged against the 64-row tile), Cin 24 (a K shorter than
    one 128-byte chunk), M 72 and Cout 40 (ragged against the 64-wide
    tile), bounds 0, 36, 37 (odd: inside a 16-byte piece) and 72; and 40
    rows, fewer than one 64-row tile (a persistent grid of one block, TMA
    boxes past the rows), at the S4's widths, bounds 0, 37, 200 and 384."""
    cases = [("S4", (BS, lr, lr), 64, 384, 64, (0, 192, 200, 256, 384))
             for lr in (HR // 2, HR // 4)]
    cases.append(("edge", (2, 20, 25), 24, 72, 40, (0, 36, 37, 72)))
    cases.append(("edge", (1, 5, 8), 64, 384, 64, (0, 37, 200, 384)))
    return cases


def bf16_ulp(v):
    """One bf16 ulp of each value of the bf16 tensor `v` (0 where v is 0)."""
    _, e = torch.frexp(v.float())
    return torch.where(v == 0, torch.zeros_like(v, dtype=torch.float32),
                       torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8))


def pw_products(x, we, dy_e, h, wp, dz, bound):
    """The six products of the masked 1x1 through its wrappers: expand and
    project forward, dgrad, wgrad, in that order."""
    return [pw_masked_forward(x, we, bound, side="expand"),
            pw_masked_forward(h, wp, bound, side="project"),
            pw_masked_dgrad(dy_e, we, bound, side="expand"),
            pw_masked_dgrad(dz, wp, bound, side="project"),
            pw_masked_wgrad(x, dy_e, bound, side="expand"),
            pw_masked_wgrad(h, dz, bound, side="project")]


def pw_plain(x, we, dy_e, h, wp, dz, bound):
    """The six products of the plain version, in `pw_products`' order."""
    gre = masked_pointwise_grads_reference(x, we, bound, dy_e, side="expand")
    grp = masked_pointwise_grads_reference(h, wp, bound, dz, side="project")
    return [masked_pointwise_reference(x, we, bound, side="expand"),
            masked_pointwise_reference(h, wp, bound, side="project"),
            gre[0], grp[0], gre[1], grp[1]]


PW_PRODUCTS = ("expand forward", "project forward", "expand dgrad", "project dgrad",
               "expand wgrad", "project wgrad")
PW_PRODUCT_WRAPPER = (pw_masked_forward, pw_masked_forward, pw_masked_dgrad, pw_masked_dgrad,
                      pw_masked_wgrad, pw_masked_wgrad)


def pw_masked_parity(g, dtype=torch.float32):
    """The masked 1x1's six products (csrc/pw_masked.cu) against the plain
    version (cuBLAS's product of the masked operands, and its autograd),
    TF32 off, at `pw_masked_cases` for every bound, on `dtype`: float32
    forwards and dgrads within TOL of the plain version (3xTF32 keeps
    float32's accuracy: the kernel and cuBLAS differ by their sum orders)
    and the wgrads no farther from float64 than the plain version is, plus
    PW_F64_MARGIN of their largest magnitude; bf16 every product within one
    bf16 ulp of the float64 product rounded once, plus PW_BF16_SUM_SHARE of
    the sum of its terms' magnitudes, and the wgrads also against float64
    as the float32 ones; exact zeros from the bound on (y, dH, dWe's rows,
    dWp's columns); two calls the same bits. Returns {wrapper: max abs err
    against the plain version}, and the wgrads' errors against float64."""
    bf16 = dtype is BF16
    key = "_bf16" if bf16 else ""
    errs = {k.__name__ + key: 0.0 for k in PW_WRAPPERS}
    f64 = {"kernel": 0.0, "plain": 0.0}
    t0, n_cases = time.perf_counter(), 0
    for label, lead, cin, mid, cout, bounds in pw_masked_cases():
        x = randn(g, *lead, cin).to(dtype)
        h = randn(g, *lead, mid).to(dtype)
        dy_e = randn(g, *lead, mid).to(dtype)
        dz = randn(g, *lead, cout).to(dtype)
        we = randn(g, mid, cin, 1, 1, scale=cin ** -0.5).to(dtype)
        wp = randn(g, cout, mid, 1, 1, scale=mid ** -0.5).to(dtype)
        ops = (x, we, dy_e, h, wp, dz)
        ops64 = [t.double() for t in ops]
        for bnd in bounds:
            bt = torch.tensor(bnd, dtype=torch.int32, device=DEVICE)
            name = "%s rows %s Cin %d M %d Cout %d bound %d%s" % (label, lead, cin, mid, cout,
                                                                  bnd, key)
            before = [(w.launches, w.launches_bf16) for w in PW_WRAPPERS]
            outs = pw_products(*ops, bt)
            again = pw_products(*ops, bt)
            torch.cuda.synchronize()
            after = [(w.launches, w.launches_bf16) for w in PW_WRAPPERS]
            if any(a != (b[0] + 4, b[1] + 4 * bf16) for a, b in zip(after, before)):
                fail("%s: launches %s -> %s, expected 4 of each direction (%s)"
                     % (name, before, after, "bf16" if bf16 else "float32"))
            for prod, a, b in zip(PW_PRODUCTS, outs, again):
                if not torch.equal(a, b):
                    fail("%s: two calls of the %s differ" % (name, prod))
            plain = pw_plain(*ops, bt)
            ref64 = pw_plain(*ops64, bt)
            # the sums of the terms' magnitudes: the product of |operands|
            mag64 = pw_plain(*[t.abs() for t in ops64], bt)
            for i, (prod, got, pl, r64, mag) in enumerate(zip(PW_PRODUCTS, outs, plain, ref64,
                                                              mag64)):
                wname = PW_PRODUCT_WRAPPER[i].__name__ + key
                err = float((got.float() - pl.float()).abs().max()) if got.numel() else 0.0
                if not bool(torch.isfinite(got).all()):
                    fail("%s %s: non-finite values" % (name, prod))
                if bf16:
                    rb = r64.to(BF16)
                    lim = bf16_ulp(rb).double() + PW_BF16_SUM_SHARE * mag
                    over = (got.double() - rb.double()).abs() - lim
                    if got.numel() and float(over.max()) > 0:
                        fail("%s %s: %.3e past one bf16 ulp of the float64 product (+ %.0e of "
                             "its terms' magnitudes)" % (name, prod, float(over.max()),
                                                         PW_BF16_SUM_SHARE))
                elif i < 4:
                    err = dw_close("%s %s" % (name, prod), got, pl, TOL)
                if i >= 4:
                    kern, pe = (float((t.double() - r64).abs().max()) for t in (got, pl))
                    margin = (DW_F64_MARGIN["bf16"] if bf16 else PW_F64_MARGIN) * float(
                        r64.abs().max())
                    if not kern <= pe + margin:
                        fail("%s %s: %.3e from float64, the plain version %.3e (+ margin %.3e)"
                             % (name, prod, kern, pe, margin))
                    f64["kernel"], f64["plain"] = max(f64["kernel"], kern), max(f64["plain"], pe)
                errs[wname] = max(errs[wname], err)
            y, _, _, dh, dwe, dwp = outs
            if y[..., bnd:].any() or dh[..., bnd:].any() or dwe[bnd:].any() or \
                    dwp[:, bnd:].any():
                fail("%s: a value past the bound is not 0" % name)
            n_cases += 1
        print("  masked 1x1 %s rows %s Cin %d M %d Cout %d%s: %d bounds ok (forward / dgrad / "
              "wgrad max abs err vs plain so far %.3e / %.3e / %.3e; wgrads vs float64 %.3e, "
              "plain %.3e)" % (label, lead, cin, mid, cout, " bf16" if bf16 else "",
                               len(bounds), errs["pw_masked_forward" + key],
                               errs["pw_masked_dgrad" + key], errs["pw_masked_wgrad" + key],
                               f64["kernel"], f64["plain"]), flush=True)
        del x, h, dy_e, dz, we, wp, ops, ops64
        torch.cuda.empty_cache()
    errs["pw_masked_wgrad_vs_f64" + key] = f64
    print("  masked 1x1%s: %d cases x 6 products, two calls the same bits each, %.1f s"
          % (" bf16" if bf16 else "", n_cases, time.perf_counter() - t0), flush=True)
    return errs


def randomize_bn(net, g):
    """Random BN affine parameters and running statistics, so the BN fold
    is exercised (fresh BN would fold to the identity)."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                dev = mod.weight.device
                mod.weight.copy_((0.5 + torch.rand(n, generator=g)).to(dev))
                mod.bias.copy_((0.2 * torch.randn(n, generator=g)).to(dev))
                mod.running_mean.copy_((0.2 * torch.randn(n, generator=g)).to(dev))
                mod.running_var.copy_((0.5 + torch.rand(n, generator=g)).to(dev))


def build_net(device, seed=0):
    net = OFAMobileNetS4(SearchSpace(), device=device,
                         generator=torch.Generator().manual_seed(seed))
    randomize_bn(net, torch.Generator().manual_seed(seed + 1))
    return net


def serving(net, net_cpu, cfg):
    rng = np.random.RandomState(0)
    frames = [rng.rand(1, *LR_HW, 3).astype(np.float32) for _ in range(N_FRAMES)]
    sub_k = get_active_subnet(net, cfg, use_kernels=True)
    sub_p = get_active_subnet(net, cfg, use_kernels=False, fold_tail=False)
    sub_f = get_active_subnet(net, cfg, use_kernels=False)
    assert sub_k.use_kernels and not sub_k.fold_tail and sub_f.fold_tail
    torch.cuda.synchronize()

    # the main path, counted: every kernel launch in this window is serving's
    fused_mbconv_infer.launches = 0
    fused_shuffle_tail.launches = 0
    out = serve(frames, net=net, cfg=cfg, device=net.device)
    torch.cuda.synchronize()
    counts = {"mbconv": fused_mbconv_infer.launches,
              "shuffle_tail": fused_shuffle_tail.launches}

    n_mb = sum(cfg.d)
    expect = {"mbconv": n_mb * N_FRAMES, "shuffle_tail": cfg.pixel_d * N_FRAMES}
    print("  launches during serve(%d frames): %s (expected %s)"
          % (N_FRAMES, counts, expect), flush=True)
    if counts != expect:
        fail("the serving path did not go through the kernels as expected")

    hr = (1, LR_HW[0] * 2 ** cfg.pixel_d, LR_HW[1] * 2 ** cfg.pixel_d, 3)
    with torch.inference_mode():
        for i, (f, y) in enumerate(zip(frames, out)):
            if tuple(y.shape) != hr:
                fail("frame %d has shape %s, expected %s" % (i, tuple(y.shape), hr))
            x = torch.from_numpy(f).to(net.device)
            if i in (0, N_FRAMES - 1):
                check_close("frame %d: kernels vs plain path on the card" % i, y, sub_p(x), FRAME_TOL)
                check_close("frame %d: kernels vs fold_tail plain path" % i, y, sub_f(x), FRAME_TOL)

        # a small frame through the same subnet on the CPU (the port's CPU
        # path is held to the JAX package by the tests)
        small = torch.from_numpy(rng.rand(1, 24, 40, 3).astype(np.float32))
        sub_cpu = get_active_subnet(net_cpu, cfg, use_kernels=False, fold_tail=False)
        check_close("24x40 frame: card kernels vs CPU", sub_k(small.to(net.device)).cpu(),
                    sub_cpu(small), FRAME_TOL)

        xs = [torch.from_numpy(f).to(net.device) for f in frames]
        times = {}
        for name, sub in (("kernels", sub_k), ("plain", sub_p), ("plain_fold_tail", sub_f)):
            times[name] = time_ms(lambda: [sub(x) for x in xs], iters=3, warmup=1) / N_FRAMES
    print("  frame ms (CUDA events, mean of %d frames x 3): %s"
          % (N_FRAMES, {k: round(v, 4) for k, v in times.items()}), flush=True)
    # profiled at the end of the run (see main)
    profiles = [("kernels", lambda: [sub_k(x) for x in xs], N_FRAMES, times["kernels"]),
                ("plain_fold_tail", lambda: [sub_f(x) for x in xs], N_FRAMES,
                 times["plain_fold_tail"])]
    return counts, times, profiles


def device_profile(name, run, n, unit_ms, unit, keep_rows=False):
    """Device time per `unit` (frame, step) by kernel from torch.profiler over
    run() (n units), and the device's idle share of the time per unit
    measured with CUDA events (`unit_ms`; None: not measured); with
    `keep_rows`, every kernel's row under "rows"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.inference_mode(unit == "frame"), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # ranges such as "Optimizer.step#Adam.step" show on the device timeline
    # around the kernels they hold; count only the kernels
    ranges = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key in ranges:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append({"kernel": e.key[:90], "calls_per_%s" % unit: e.count / n,
                         "ms_per_%s" % unit: us / 1e3 / n})
    key = "ms_per_%s" % unit
    rows.sort(key=lambda r: -r[key])
    busy = sum(r[key] for r in rows)
    if not rows:
        print("  %s: device time not measured (the profiler recorded no CUDA kernel)"
              % name, flush=True)
        return {"path": name, "busy_ms_per_%s" % unit: None, "idle_share": None, "top": [],
                "kernels_per_%s" % unit: None, "port_kernels": []}
    n_kernels = sum(r["calls_per_%s" % unit] for r in rows)
    idle = None if unit_ms is None else 1 - busy / unit_ms
    print("  %s: device busy %.4f of %s ms per %s (idle share %s), %.1f device kernels per %s"
          % (name, busy, "%.4f" % unit_ms if unit_ms else "(not measured)", unit,
             "%.3f" % idle if unit_ms else "not measured", n_kernels, unit), flush=True)
    ours = [r for r in rows if any(k in r["kernel"] for k in PORT_KERNELS)]
    for r in rows[:10] + [r for r in ours if r not in rows[:10]]:
        print("    %8.4f ms  x%-5.1f %s" % (r[key], r["calls_per_%s" % unit], r["kernel"]),
              flush=True)
    out = {"path": name, "busy_ms_per_%s" % unit: busy, "idle_share": idle,
           "kernels_per_%s" % unit: n_kernels, "top": rows[:10], "port_kernels": ours}
    if keep_rows:
        out["rows"] = rows
    return out


# cuDNN's kernels of each direction of a 1x1 conv on NHWC views, by name:
# float32 its implicit GEMMs (fprop, dgrad, wgrad engines; their layout
# transposes name no direction), bf16 the cuBLASLt kernels it calls on the
# H100 (nvJet "TN?" forward and "NN?" dgrad; a CUTLASS "nt" GEMM and its
# split-K reduction for the wgrad)
CUDNN_DIRECTIONS = (("pw_masked_wgrad", re.compile(r"wgrad|splitKreduce|gemm\w*_nt_align")),
                    ("pw_masked_dgrad", re.compile(r"dgrad|nvjet\w*_NN[NT]\b")),
                    ("pw_masked_forward", re.compile(r"fprop|implicit_convolve|nvjet\w*_TN[NT]\b")))


def cudnn_1x1_device_ms(without, with_lever):
    """cuDNN's full-width 1x1 convs' device ms a step by direction, from two
    profiles of the graphed one-subnet S4 step that phase 13 takes: with
    the depthwise lever alone (`without`: the 1x1 convs are cuDNN's) and
    with the expand lever too (`with_lever`: they are csrc/pw_masked.cu's).
    A direction's number is the device ms a step its cuDNN kernels
    (CUDNN_DIRECTIONS) take in the first less what they take in the second
    (the step's other convs run in both); kernels of no direction (float32's
    layout transposes) add to "other", the port's own are left out; the
    busy times' difference beside it."""
    ms = {}
    for sign, prof in ((1.0, without), (-1.0, with_lever)):
        for r in prof["rows"]:
            ms[r["kernel"]] = ms.get(r["kernel"], 0.0) + sign * r["ms_per_step"]
    out = {name: 0.0 for name, _ in CUDNN_DIRECTIONS}
    out["other"] = 0.0
    for kernel, d in ms.items():
        if any(k in kernel for k in PORT_KERNELS):
            continue
        name = next((n for n, pat in CUDNN_DIRECTIONS if pat.search(kernel)), "other")
        out[name] += d
    out["busy_difference"] = without["busy_ms_per_step"] - with_lever["busy_ms_per_step"]
    return out


# -- phase 4: training -------------------------------------------------------

def bn_launches_expected(cfgs):
    """Launches of each BN wrapper of the path (bn_forward, bn_backward) for
    a step over `cfgs`: one per train-mode BN, 3*sum(d) + pixel_d + 4 a
    subnet."""
    return sum(3 * sum(c.d) + c.pixel_d + 4 for c in cfgs)


def zero_bn_counts():
    for k in BN_KERNELS + BN_OFF_PATH:
        k.launches = k.launches_bf16 = 0


def bn_counts():
    """{wrapper: launches, wrapper_bf16: its bf16 launches} of the path's BN
    wrappers and of those off the path."""
    counts = {k.__name__: k.launches for k in BN_KERNELS + BN_OFF_PATH}
    counts.update({k.__name__ + "_bf16": k.launches_bf16 for k in BN_KERNELS + BN_OFF_PATH})
    return counts


def bn_launches_wrong(counts, expect, bf16):
    """Why `counts` is not one launch of each path wrapper per train-mode BN
    (`expect`), all of the run's type, and none off the path; None if it
    is."""
    if any(counts[k.__name__] != expect for k in BN_KERNELS):
        return "did not launch bn_forward and bn_backward once per train-mode BN"
    if any(counts[k.__name__ + "_bf16"] != (expect if bf16 else 0) for k in BN_KERNELS):
        return "launched BN kernels of the other type"
    if any(counts[k.__name__] for k in BN_OFF_PATH):
        return "launched col_sums2 / bn_moments, which are off the path"
    return None


def counted_train(steps, **kw):
    """entry.train with the BN wrappers' counters read around it: the main
    path's run. Returns (metrics, {kernel: launches, kernel_bf16: its bf16
    launches})."""
    zero_bn_counts()
    bn_train_fused.layout_copies = 0
    metrics = train(steps, device=DEVICE, **kw)
    torch.cuda.synchronize()
    counts = bn_counts()
    counts["layout_copies"] = bn_train_fused.layout_copies
    return metrics, counts


def training_main_path(compute_dtype=None):
    """The two training envelopes through entry.train, counted: float32, or
    bf16 mixed precision, where every BN launch is a bf16 one."""
    space = SearchSpace()
    runs = {}
    bf16 = compute_dtype is BF16
    for label, steps, kw in (("1 subnet", TRAIN_STEPS, {}),
                             ("4 subnets + KD", KD_STEPS, dict(n_subnets=4, kd_ratio=1.0))):
        cfgs = [c for i in range(steps) for c in step_subnets(space, i, kw.get("n_subnets", 1))]
        metrics, counts = counted_train(steps, compute_dtype=compute_dtype, **kw)
        expect = bn_launches_expected(cfgs)
        print("  entry.train(%d steps, %s%s): BN-kernel launches %s (expected %d each), "
              "pixel_d %s, losses %s" % (steps, label, ", bf16" if bf16 else "", counts, expect,
                                         sorted({c.pixel_d for c in cfgs}),
                                         [round(m["loss"], 5) for m in metrics]), flush=True)
        wrong = bn_launches_wrong(counts, expect, bf16)
        if wrong:
            fail("the %s training path %s" % ("bf16" if bf16 else "float32", wrong))
        if not all(np.isfinite(m["loss"]) and np.isfinite(m["psnr"]) for m in metrics):
            fail("non-finite training metrics: %s" % metrics)
        runs[label] = {"steps": steps, "launches": counts, "expected": expect,
                       "metrics": metrics}
    if {c.pixel_d for i in range(TRAIN_STEPS) for c in step_subnets(space, i, 1)} != {1, 2}:
        fail("the one-subnet steps did not sample both pixel_d")
    if bf16:
        # the bf16 step on the plain path, from the same seed-0 weights and batch
        plain = train(TRAIN_STEPS, device=DEVICE, compute_dtype=BF16, use_kernels=False)
        kern = runs["1 subnet"]["metrics"]
        check_close("bf16: %d one-subnet steps, losses: kernel path vs plain path" % TRAIN_STEPS,
                    torch.tensor([m["loss"] for m in kern]),
                    torch.tensor([m["loss"] for m in plain]), BF16_STEP_TOL)
        runs["1 subnet"]["plain_metrics"] = plain
        if runs["1 subnet"]["launches"]["layout_copies"]:
            print("  finding: the bf16 path copied %d BN inputs to row-contiguous layout"
                  % runs["1 subnet"]["launches"]["layout_copies"], flush=True)
    return runs


def train_net(device, seed=0):
    return OFAMobileNetS4(SearchSpace(), device=device,
                          generator=torch.Generator().manual_seed(seed))


def sgd_steps(device, use_kernels, batch, cfg_lists, lr=0.01):
    """SGD steps from seed-0 weights; (losses, params after the first)."""
    net = train_net(device)
    tr = SRTrainer(net, opt_type="sgd", weight_decay=3e-5, use_kernels=use_kernels)
    losses, first = [], None
    for cfgs in cfg_lists:
        losses.append(tr.train_step(batch, cfgs, lr)["loss"])
        if first is None:
            first = {n: p.detach().clone() for n, p in net.named_parameters()}
    return torch.stack(losses), first


def training_checks():
    """Kernel path vs plain path on the card; a small step card vs CPU."""
    space = SearchSpace()
    cfgs = [step_subnets(space, i, 1)[0] for i in (0, 6)]  # pixel_d 1 and 2
    batch = synthetic_batch(BS, HR, DEVICE)
    lk, pk = sgd_steps(DEVICE, True, batch, [[cfgs[0]], [cfgs[1]], [cfgs[0]]])
    lp, pp = sgd_steps(DEVICE, False, batch, [[cfgs[0]], [cfgs[1]], [cfgs[0]]])
    check_close("3 SGD steps, losses: kernel path vs plain path", lk, lp, STEP_TOL)
    err = max(float((pk[n] - pp[n]).abs().max()) for n in pk)
    for n in pk:
        if not bool(torch.isclose(pk[n], pp[n], **STEP_TOL).all()):
            check_close("params after one SGD step: " + n, pk[n], pp[n], STEP_TOL)
    print("  params after one SGD step, kernel path vs plain path: max_abs_err %.3e  ok"
          % err, flush=True)
    small = synthetic_batch(2, 32, "cpu", seed=1)
    lc, pc = sgd_steps(DEVICE, None, {k: v.to(DEVICE) for k, v in small.items()}, [cfgs])
    lh, ph = sgd_steps("cpu", None, small, [cfgs])
    check_close("2-subnet step at bs2 32x32: loss, card kernels vs CPU", lc.cpu(), lh,
                DEVICE_STEP_TOL)
    err = max(float((pc[n].cpu() - ph[n]).abs().max()) for n in pc)
    for n in pc:
        if not bool(torch.isclose(pc[n].cpu(), ph[n], **DEVICE_STEP_TOL).all()):
            check_close("params, card vs CPU: " + n, pc[n].cpu(), ph[n], DEVICE_STEP_TOL)
    print("  params after that step, card vs CPU: max_abs_err %.3e  ok" % err, flush=True)


def timed_steps(run, n_steps):
    """(ms per step on the device timeline from CUDA events, ms per step the
    host spent enqueueing) of one run(); equal when the host is the limit."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end) / n_steps, host_ms / n_steps


# the timed training paths: (use_kernels, compute_dtype), timed in the order
# of STEP_ORDER and back, STEP_ROUNDS times
STEP_PATHS = {"kernels": (True, None), "plain": (False, None),
              "bf16 kernels": (True, BF16), "bf16 plain": (False, BF16)}
STEP_ORDER = ("plain", "kernels", "bf16 kernels", "bf16 plain")


def step_times():
    """ms per step of the float32 and bf16 kernel and plain paths for both
    envelopes, in STEP_ROUNDS rounds of STEP_ORDER and back; and the runs of
    the one-subnet steps on the float32 paths and the bf16 kernel path, to
    profile at the end."""
    space = SearchSpace()
    batch = synthetic_batch(BS, HR, DEVICE)
    envelopes = {"1 subnet": ([step_subnets(space, i, 1) for i in range(TRAIN_STEPS)], {}),
                 "4 subnets + KD": ([step_subnets(space, i, 4) for i in range(KD_STEPS)],
                                    dict(kd_ratio=1.0))}
    teacher = kd_teacher(space, DEVICE)
    out, profiles = {}, []
    for env, (steps, kw) in envelopes.items():
        trainers = {name: SRTrainer(train_net(DEVICE), use_kernels=uk, compute_dtype=cd,
                                    teacher=teacher if kw else None, **kw)
                    for name, (uk, cd) in STEP_PATHS.items()}

        def run(name, trainers=trainers, steps=steps):  # bound now: profiled later
            for cfgs in steps:
                trainers[name].train_step(batch, cfgs, 1e-4)

        for name in STEP_PATHS:
            run(name)  # warm: cuDNN's algorithm choice, the allocator
        times = {name: [] for name in STEP_PATHS}
        for name in (STEP_ORDER + STEP_ORDER[::-1]) * STEP_ROUNDS:
            times[name].append(timed_steps(lambda: run(name), len(steps)))
        out[env] = {}
        for name in STEP_PATHS:
            ev, host = zip(*times[name])
            out[env][name] = {"ms": list(ev), "host_enqueue_ms": list(host),
                              "median_ms": float(np.median(ev)),
                              "median_host_enqueue_ms": float(np.median(host))}
            print("  %s, %s: ms per step (CUDA events) %s, median %.4f; host enqueue %s"
                  % (env, name, [round(t, 3) for t in ev], np.median(ev),
                     [round(t, 3) for t in host]), flush=True)
        if env == "1 subnet":
            profiles += [("train %s" % name, functools.partial(run, name), len(steps),
                          out[env][name]["median_ms"])
                         for name in ("kernels", "plain", "bf16 kernels")]
    return out, profiles


# -- phase 5: the run-management path through the CLIs ----------------------

def teacher_space():
    """The teacher CLI's search space at its defaults (ks5/e3/d2/pixel_d 1)."""
    return SearchSpace(ks_list=[5], expand_list=[3], depth_list=[2], pixel_d_list=[1])


class EpochTimes:
    """Wraps SRRunManager.train_one_epoch while active, recording each
    epoch's index, (ms per step from CUDA events, host ms per step) and its
    wall seconds."""

    def __init__(self):
        self.epochs = []

    def __enter__(self):
        real = self.real = SRRunManager.train_one_epoch

        def timed_epoch(rm, epoch, *a, **k):
            n = len(rm.provider.train)
            box = []
            t0 = time.perf_counter()
            ms, host_ms = timed_steps(lambda: box.append(real(rm, epoch, *a, **k)), n)
            self.epochs.append({"epoch": epoch, "steps": n, "ms_per_step": ms,
                                "host_ms_per_step": host_ms,
                                "wall_s": time.perf_counter() - t0})
            return box[0]

        SRRunManager.train_one_epoch = timed_epoch
        return self

    def __exit__(self, *exc):
        SRRunManager.train_one_epoch = self.real


def counted_cli(main_fn, argv):
    """main_fn(argv + --device) with every kernel's counters set to 0 just
    before and read just after: a main path's run. Returns (its result,
    {counter: launches}, wall seconds)."""
    zero_bn_counts()
    fused_mbconv_infer.launches = fused_shuffle_tail.launches = 0
    t0 = time.perf_counter()
    out = main_fn(argv + ["--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = bn_counts()
    counts.update(mbconv=fused_mbconv_infer.launches, shuffle_tail=fused_shuffle_tail.launches)
    return out, counts, wall


def check_bn_launches(label, counts, n_steps, bf16):
    cfg = uniform_subnet(teacher_space(), 5, 3, 2, 1)
    expect = n_steps * bn_launches_expected([cfg])
    print("  %s: BN-kernel launches %s (expected %d each%s)"
          % (label, counts, expect, ", all bf16" if bf16 else ""), flush=True)
    wrong = bn_launches_wrong(counts, expect, bf16)
    if wrong:
        fail("%s %s" % (label, wrong))
    if counts["mbconv"] or counts["shuffle_tail"]:
        fail("%s launched a serving kernel" % label)
    return expect


def teacher_runs(tmp):
    """The teacher CLI: 2 epochs; 3 epochs resumed from the first run's
    checkpoint; 1 epoch in bf16. Returns the record and the checkpoint dir."""
    run_dir = os.path.join(tmp, "teacher")
    base = ["--synthetic", "--bn_mode", "train", "--warmup_epochs", "0"]
    out = {}
    with EpochTimes() as et:
        best, counts, wall = counted_cli(train_teacher_net_sr_simple.main,
                                         base + ["--path", run_dir, "--n_epochs", "2"])
        check_bn_launches("teacher, 2 epochs", counts, 2 * TEACHER_EPOCH_STEPS, False)
        for f in ("checkpoint/latest.txt", "checkpoint/checkpoint.pth.tar",
                  "checkpoint/model_best.pth.tar", "logs/train_console.txt",
                  "logs/valid_console.txt", "net_info.txt", "run.config"):
            if not os.path.isfile(os.path.join(run_dir, f)):
                fail("the teacher run wrote no %s" % f)
        if not np.isfinite(best):
            fail("the teacher run's best PSNR is %s" % best)
        out["f32"] = {"best_psnr": best, "launches": counts, "wall_s": wall,
                      "epochs": list(et.epochs)}
        n0 = len(et.epochs)
        _, counts, wall = counted_cli(train_teacher_net_sr_simple.main,
                                      base + ["--path", run_dir, "--n_epochs", "3"])
        resumed = [e["epoch"] for e in et.epochs[n0:]]
        with open(os.path.join(run_dir, "logs", "valid_console.txt")) as f:
            log = f.read()
        print("  teacher, 3 epochs: resumed epochs %s" % resumed, flush=True)
        if resumed != [2] or "=> loaded checkpoint (epoch 2)" not in log:
            fail("the teacher run did not resume at epoch 2 (ran epochs %s)" % resumed)
        check_bn_launches("teacher, resumed", counts, TEACHER_EPOCH_STEPS, False)
        out["f32_resumed"] = {"launches": counts, "wall_s": wall, "epochs": et.epochs[n0:]}
        n0 = len(et.epochs)
        best, counts, wall = counted_cli(
            train_teacher_net_sr_simple.main,
            base + ["--path", os.path.join(tmp, "teacher_bf16"), "--n_epochs", "1",
                    "--compute_dtype", "bf16"])
        check_bn_launches("teacher, bf16, 1 epoch", counts, TEACHER_EPOCH_STEPS, True)
        if not np.isfinite(best):
            fail("the bf16 teacher run's best PSNR is %s" % best)
        out["bf16"] = {"best_psnr": best, "launches": counts, "wall_s": wall,
                       "epochs": et.epochs[n0:]}
    return out, os.path.join(run_dir, "checkpoint")


def eval_run(tmp, ckpt_dir):
    """The SR evaluator with --materialize from the teacher's checkpoint,
    counted; then the same subnet from the same checkpoint on the plain
    path, scored on the same frames."""
    frame_log = os.path.join(tmp, "frames.jsonl")
    argv = ["--path", os.path.join(tmp, "eval"), "--synthetic", "--dataset", "div2k",
            "--materialize", "--checkpoint", ckpt_dir, "--image_size", str(EVAL_HR),
            "--frame_log", frame_log]
    psnr, counts, wall = counted_cli(eval_ofa_net_sr.main, argv)
    cfg = uniform_subnet(SearchSpace(), 7, 6, 2, 2)
    expect = {"mbconv": sum(cfg.d) * EVAL_FRAMES, "shuffle_tail": cfg.pixel_d * EVAL_FRAMES}
    got = {k: counts[k] for k in expect}
    print("  eval_ofa_net_sr --materialize, %d frames of %dx%d HR: launches %s (expected %s), "
          "mean PSNR-Y %.6f" % (EVAL_FRAMES, EVAL_HR, EVAL_HR, got, expect, psnr), flush=True)
    if got != expect or any(counts[k.__name__] for k in BN_KERNELS + BN_OFF_PATH):
        fail("the evaluator did not go through the serving kernels as expected")
    with open(frame_log) as f:
        frames = [json.loads(line) for line in f]
    if len(frames) != EVAL_FRAMES or not all(np.isfinite(r["psnr"]) for r in frames):
        fail("the evaluator's frame log: %s" % frames)

    args = eval_ofa_net_sr.build_args(argv + ["--device", DEVICE])
    net = make_net(OFAMobileNetS4, SearchSpace(), args)
    load_weights_lenient(ckpt_dir, net)
    sub = get_active_subnet(net, cfg, use_kernels=False)
    psnrs = []
    with torch.inference_mode():
        for batch in make_sr_provider(args, None).test:
            x = torch.from_numpy(batch["x4"]).to(net.device)
            out = sub(x)
            if tuple(out.shape) != (1, EVAL_HR, EVAL_HR, 3) or not bool(torch.isfinite(out).all()):
                fail("plain-path frame: shape %s" % (tuple(out.shape),))
            psnrs.append(float(psnr_y_device(out, torch.from_numpy(batch["image"]).to(net.device))))
    plain = float(np.mean(psnrs))
    diff = abs(plain - psnr)
    print("  the same subnet on the plain path: mean PSNR-Y %.6f (|diff| %.2e dB, at most %.0e)"
          % (plain, diff, PSNR_TOL_DB), flush=True)
    if not diff <= PSNR_TOL_DB:
        fail("the evaluator's kernel path and plain path differ by %.3e dB" % diff)
    ms = [1e3 * r["sec"] for r in frames]
    return {"launches": counts, "expected": expect, "mean_psnr": psnr, "plain_mean_psnr": plain,
            "frame_ms": ms, "frame_ms_after_first_median": float(np.median(ms[1:])),
            "wall_s": wall}


def run_manager_times(tmp):
    """ms per step of the run manager (CUDA events around train_one_epoch,
    4 steps of the synthetic provider) against entry.train's on the same
    teacher net and batch shape, and of the epoch's data path alone, in
    RM_ROUNDS rounds of alternating order."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    net = OFAMobileNetS4(teacher_space(), device=DEVICE, generator=gen())
    rm = SRRunManager(os.path.join(tmp, "timing"), net,
                      RunConfig(n_epochs=2 * RM_ROUNDS + 1, base_lr=1e-3),
                      SyntheticSRProvider(n_train=64, n_valid=4, hr_size=HR,
                                          train_batch_size=BS))
    net_e = OFAMobileNetS4(teacher_space(), device=DEVICE, generator=gen())
    rm.train_one_epoch(0)  # warm both
    train(TEACHER_EPOCH_STEPS, device=DEVICE, net=net_e)
    loader = rm.provider.train
    # the epoch's data path alone: the loader's batches (made on the host),
    # and those batches copied to the card as train_one_epoch copies them
    runs = {"run manager": None,
            "entry.train": functools.partial(train, TEACHER_EPOCH_STEPS, device=DEVICE,
                                             net=net_e),
            "loader": lambda: list(loader),
            "loader + copies": lambda: [rm._to_device(b) for b in loader]}
    times = {name: [] for name in runs}
    for r in range(RM_ROUNDS):
        for name in (runs if r % 2 == 0 else list(runs)[::-1]):
            run = runs[name] or functools.partial(rm.train_one_epoch, r + 1)
            times[name].append(timed_steps(run, TEACHER_EPOCH_STEPS))
    out = {}
    for name, ts in times.items():
        ev, host = zip(*ts)
        out[name] = {"ms": list(ev), "host_ms": list(host), "median_ms": float(np.median(ev)),
                     "median_host_ms": float(np.median(host))}
        print("  %s: ms per step (CUDA events) %s, median %.4f; host %s"
              % (name, [round(t, 3) for t in ev], np.median(ev), [round(t, 3) for t in host]),
              flush=True)
    return out


def cli_phase():
    with tempfile.TemporaryDirectory(prefix="ofa_sr_cli_") as tmp:
        teacher, ckpt_dir = teacher_runs(tmp)
        ev = eval_run(tmp, ckpt_dir)
        times = run_manager_times(tmp)
    return {"teacher": teacher, "eval": ev, "step_times": times}


# -- phase 7: the X4 supernet (learned downscale + SR) -----------------------

def x4_step_cfgs():
    """The subnets of phase 7's one-subnet X4 steps (both trunks' choices)."""
    return [step_subnets(SearchSpace(), i, 1, n_trunks=2)[0] for i in range(X4_STEPS)]


def decoder_cfg(space, cfg):
    """The decoder trunk's half of an X4 subnet, as a one-trunk subnet."""
    nb, ns = space.blocks_per_trunk, space.n_stages
    return SubnetConfig(ks=cfg.ks[nb:], e=cfg.e[nb:], d=cfg.d[ns:], pixel_d=cfg.pixel_d)


def x4_bn_train_shapes(space, cfg, mode, bs=BS, hr=HR):
    """NHWC shapes of every train-mode BN of an X4 subnet's forward at
    batch `bs` of hr x hr frames, in order: in autoencoder mode the
    unshuffle convs (before their unshuffle), the encoder trunk and its
    three final convs, then the decoder (the S4 topology on trunk 1)."""
    pd = cfg.pixel_d
    lr = hr // 2 ** pd
    shapes = []
    if mode == "autoencoder":
        shapes += [(bs, hr // 2 ** i, hr // 2 ** i, space.width // 4) for i in range(pd)]
        enc = SubnetConfig(ks=cfg.ks, e=cfg.e, d=cfg.d[:space.n_stages], pixel_d=pd)
        trunk = (bs, lr, lr, space.width)
        for stage in range(space.n_stages):
            for i in range(enc.d[stage]):
                mid = space.mid_channels(enc.e[stage * space.max_depth + i])
                shapes += [(bs, lr, lr, mid)] * 2 + [trunk]
        shapes += [trunk] * 2 + [(bs, lr, lr, 3)]
    return shapes + bn_train_shapes(space, decoder_cfg(space, cfg), bs, hr)


def x4_bn_launches_expected(cfgs, mode):
    """Launches of each BN wrapper of the X4 path a step over `cfgs`: one
    per train-mode BN, 3*sum(d_dec) + pixel_d + 4 a subnet in sr mode,
    3*(sum(d_enc) + sum(d_dec)) + 2*pixel_d + 7 in autoencoder mode."""
    ns = SearchSpace().n_stages
    if mode == "sr":
        return sum(3 * sum(c.d[ns:]) + c.pixel_d + 4 for c in cfgs)
    return sum(3 * sum(c.d) + 2 * c.pixel_d + 7 for c in cfgs)


def build_x4(device, seed=0):
    net = OFAMobileNetX4(SearchSpace(), device=device,
                         generator=torch.Generator().manual_seed(seed))
    randomize_bn(net, torch.Generator().manual_seed(seed + 1))
    return net


def f64_frame_check(name, got, plains, y64):
    """`got`'s max abs error against the float64 frame `y64` at most
    F64_FRAME_RATIO times the largest of the plain float32 frames'
    (`plains`); also fails on a non-finite value."""
    err = lambda t: float((t.double() - y64).abs().max())  # noqa: E731
    # values of each outside FRAME_TOL of float64: why this check replaces it
    over = lambda t: int(((t.double() - y64).abs()  # noqa: E731
                          > FRAME_TOL["atol"] + FRAME_TOL["rtol"] * y64.abs()).sum())
    kern, plain = err(got), max(err(t) for t in plains)
    ok = bool(torch.isfinite(got).all()) and kern <= F64_FRAME_RATIO * plain
    print("  %-58s against float64: max_abs_err %.3e, plain float32 %.3e (at most %.2fx, "
          "|y| max %.1f; outside FRAME_TOL of float64: %d, plain %s)  %s"
          % (name, kern, plain, F64_FRAME_RATIO, float(y64.abs().max()), over(got),
             [over(t) for t in plains], "ok" if ok else "FAIL"), flush=True)
    if not ok:
        fail("%s is less accurate than the plain float32 path against float64 (%.3e > %.2f x "
             "%.3e)" % (name, kern, F64_FRAME_RATIO, plain))
    return {"kernel": kern, "plain": plain, "outside_frame_tol": over(got),
            "plain_outside_frame_tol": [over(t) for t in plains]}


def x4_serving(net, net_cpu, net64):
    """8 frames in each mode through entry.serve, counted: MBConv launches
    sum(d_dec) a frame in sr mode and sum(d_enc) + sum(d_dec) in autoencoder
    mode, no shuffle-tail launch (the X4's shuffle convs are 3x3, the tail
    kernel 5x5 only); frames against the plain path (sr: at FRAME_TOL;
    autoencoder: no less accurate against float64 than the plain paths,
    F64_FRAME_RATIO), a small frame against the CPU; frame ms with fold_tail
    on and off."""
    cfg = uniform_subnet(net.space, 7, 6, 2, 2, n_trunks=2)
    rng = np.random.RandomState(3)
    out, profiles = {"cfg": cfg.describe()}, []
    for mode in X4_MODES:
        f = 1 if mode == "sr" else 2 ** cfg.pixel_d
        in_hw = (LR_HW[0] * f, LR_HW[1] * f)
        frames = [rng.rand(1, *in_hw, 3).astype(np.float32) for _ in range(N_FRAMES)]
        torch.cuda.synchronize()
        # the main path, counted
        zero_bn_counts()
        fused_mbconv_infer.launches = fused_shuffle_tail.launches = 0
        ys = serve(frames, net=net, cfg=cfg, device=net.device, mode=mode)
        torch.cuda.synchronize()
        counts = {"mbconv": fused_mbconv_infer.launches,
                  "shuffle_tail": fused_shuffle_tail.launches}
        n_mb = sum(cfg.d[net.space.n_stages:]) if mode == "sr" else sum(cfg.d)
        expect = {"mbconv": n_mb * N_FRAMES, "shuffle_tail": 0}
        print("  X4 %s: launches during serve(%d frames of %dx%d): %s (expected %s)"
              % ((mode, N_FRAMES) + in_hw + (counts, expect)), flush=True)
        if counts != expect or any(bn_counts().values()):
            fail("the X4 %s serving path did not go through the kernels as expected" % mode)
        subs = {"kernels": get_active_subnet(net, cfg, mode=mode, use_kernels=True),
                "kernels_no_fold": get_active_subnet(net, cfg, mode=mode, use_kernels=True,
                                                     fold_tail=False),
                "plain": get_active_subnet(net, cfg, mode=mode, use_kernels=False,
                                           fold_tail=False),
                "plain_fold_tail": get_active_subnet(net, cfg, mode=mode, use_kernels=False)}
        if not (subs["kernels"].fold_tail and not subs["kernels"].tail_kernel):
            fail("the X4 subnet with kernels should keep fold_tail and use no tail kernel")
        hr = (1, LR_HW[0] * 2 ** cfg.pixel_d, LR_HW[1] * 2 ** cfg.pixel_d, 3)
        sub64 = get_active_subnet(net64, cfg, mode=mode, use_kernels=False, fold_tail=False)
        errs = {}
        with torch.inference_mode():
            for i, (x_np, y) in enumerate(zip(frames, ys)):
                if tuple(y.shape) != hr or not bool(torch.isfinite(y).all()):
                    fail("X4 %s frame %d: shape %s (expected %s) or not finite"
                         % (mode, i, tuple(y.shape), hr))
                if i not in (0, N_FRAMES - 1):
                    continue
                x = torch.from_numpy(x_np).to(net.device)
                plain = [subs["plain"](x), subs["plain_fold_tail"](x)]
                if mode == "sr":
                    for name, ref in zip(("plain", "plain_fold_tail"), plain):
                        check_close("X4 sr frame %d: kernels vs %s" % (i, name), y, ref,
                                    FRAME_TOL)
                    check_close("X4 sr frame %d: kernels vs kernels_no_fold" % i, y,
                                subs["kernels_no_fold"](x), FRAME_TOL)
                    continue
                y64 = sub64(x.double())
                for name in ("kernels", "kernels_no_fold"):
                    got = y if name == "kernels" else subs[name](x)
                    errs["frame %d %s" % (i, name)] = f64_frame_check(
                        "X4 autoencoder frame %d: %s" % (i, name), got, plain, y64)
            small = torch.from_numpy(rng.rand(1, 24 * f, 40 * f, 3).astype(np.float32))
            sub_cpu = get_active_subnet(net_cpu, cfg, mode=mode, use_kernels=False,
                                        fold_tail=False)
            got, ref = subs["kernels"](small.to(net.device)).cpu(), sub_cpu(small)
            if mode == "sr":
                check_close("X4 sr small frame: card kernels vs CPU", got, ref, FRAME_TOL)
            else:
                errs["small frame, card vs CPU"] = f64_frame_check(
                    "X4 autoencoder small frame: card kernels vs CPU", got, [ref],
                    sub64(small.to(net.device).double()).cpu())
            xs = [torch.from_numpy(x_np).to(net.device) for x_np in frames]
            times = {name: time_ms(lambda sub=sub: [sub(x) for x in xs], iters=3,
                                   warmup=1) / N_FRAMES for name, sub in subs.items()}
        print("  X4 %s frame ms (CUDA events, mean of %d frames x 3): %s"
              % (mode, N_FRAMES, {k: round(v, 4) for k, v in times.items()}), flush=True)
        out[mode] = {"launches": counts, "expected": expect, "frame_ms": times,
                     "input_hw": list(in_hw), "errors_vs_f64": errs}
        profiles.append(("X4 %s kernels" % mode,
                         lambda sub=subs["kernels"], xs=xs: [sub(x) for x in xs], N_FRAMES,
                         times["kernels"]))
    return out, profiles


def x4_train_net():
    return OFAMobileNetX4(SearchSpace(), device=DEVICE, generator=torch.Generator().manual_seed(0))


def x4_training():
    """entry.train on the full-width X4, 4 one-subnet steps in each mode, in
    float32 and bf16, counted (BN launches per the formulas, bf16 apart);
    the kernel path's losses against the plain path's (float32 at
    STEP_TOL's rtol, bf16 at BF16_STEP_TOL); ms a step of both paths with
    the host's enqueue time."""
    cfgs = x4_step_cfgs()
    batch = synthetic_batch(BS, HR, DEVICE)
    out = {}
    for mode in X4_MODES:
        for cd in (None, BF16):
            bf16 = cd is BF16
            label = "%s%s" % (mode, " bf16" if bf16 else "")
            zero_bn_counts()
            metrics = train(X4_STEPS, device=DEVICE, net=x4_train_net(), compute_dtype=cd,
                            mode=mode)
            torch.cuda.synchronize()
            counts = bn_counts()
            expect = x4_bn_launches_expected(cfgs, mode)
            print("  X4 entry.train(%d steps, %s): BN-kernel launches %s (expected %d each), "
                  "losses %s" % (X4_STEPS, label, counts, expect,
                                 [round(m["loss"], 5) for m in metrics]), flush=True)
            wrong = bn_launches_wrong(counts, expect, bf16)
            if wrong:
                fail("the X4 %s training path %s" % (label, wrong))
            if not all(np.isfinite(m["loss"]) and np.isfinite(m["psnr"]) for m in metrics):
                fail("non-finite X4 training metrics: %s" % metrics)
            plain = train(X4_STEPS, device=DEVICE, net=x4_train_net(), compute_dtype=cd,
                          mode=mode, use_kernels=False)
            tol = BF16_STEP_TOL if bf16 else dict(STEP_TOL, atol=0)
            check_close("X4 %s: %d steps, losses: kernel path vs plain path" % (label, X4_STEPS),
                        torch.tensor([m["loss"] for m in metrics]),
                        torch.tensor([m["loss"] for m in plain]), tol)
            trainers = {uk: SRTrainer(x4_train_net(), use_kernels=uk, compute_dtype=cd,
                                      mode=mode) for uk in (False, True)}

            def run(uk, trainers=trainers):
                for c in cfgs:
                    trainers[uk].train_step(batch, [c], 1e-4)

            for uk in trainers:
                run(uk)  # warm
            times = {False: [], True: []}
            for uk in (False, True, True, False) * X4_ROUNDS:
                times[uk].append(timed_steps(lambda: run(uk), X4_STEPS))
            rec = {"launches": counts, "expected": expect, "metrics": metrics,
                   "plain_metrics": plain}
            for uk, name in ((True, "kernels"), (False, "plain")):
                ev, host = zip(*times[uk])
                rec[name] = {"ms": list(ev), "host_enqueue_ms": list(host),
                             "median_ms": float(np.median(ev)),
                             "median_host_enqueue_ms": float(np.median(host))}
                print("  X4 %s, %s: ms per step (CUDA events) %s, median %.4f; host enqueue "
                      "%s" % (label, name, [round(t, 3) for t in ev], np.median(ev),
                              [round(t, 3) for t in host]), flush=True)
            out[label] = rec
    return out


def read_json(path):
    with open(path) as f:
        return json.load(f)


def x4_cli(tmp):
    """The shrinking CLI in a temporary directory: one expand stage in
    autoencoder mode (it reorganizes both trunks), its rerun (the stage is
    finished: nothing trains), the pixelshuffle_depth stage in sr mode
    warm-started from it; then the evaluator with --x4_autoencoder
    --materialize from that checkpoint, its PSNR-Y against the plain path's."""
    out = {}
    expand = os.path.join(tmp, "expand")
    argv = ["--synthetic", "--task", "expand", "--phase", "1", "--mode", "autoencoder",
            "--n_epochs", "1", "--path", expand]
    preset = train_ofa_net_sr_simple.TASK_PHASES[("expand", 1)]
    space = SearchSpace(**{k: preset[k] for k in ("ks_list", "expand_list", "depth_list",
                                                 "pixel_d_list")})
    supported = sorted(space.expand_list, reverse=True)[:2]
    cfgs = [sample_subnet(space, seed=subnet_seed(0, TEACHER_EPOCH_STEPS, i, k), n_trunks=2,
                          expand_candidates=supported)
            for i in range(TEACHER_EPOCH_STEPS) for k in range(preset["dynamic_batch_size"])]
    with EpochTimes() as et:
        best, counts, wall = counted_cli(train_ofa_net_sr_simple.main, argv)
        expect = x4_bn_launches_expected(cfgs, "autoencoder")
        print("  shrink expand/1 autoencoder: BN-kernel launches %s (expected %d each), best "
              "PSNR %.4f, %.1f s" % (counts, expect, best, wall), flush=True)
        wrong = bn_launches_wrong(counts, expect, False)
        if wrong or counts["mbconv"] or counts["shuffle_tail"]:
            fail("the shrinking CLI %s" % (wrong or "launched a serving kernel"))
        if read_json(os.path.join(expand, "expand.stage")) != {"stage": 1}:
            fail("expand.stage: %s" % read_json(os.path.join(expand, "expand.stage")))
        for f in ("checkpoint/expand_stage1.ckpt", "checkpoint/latest.txt",
                  "logs/valid_console.txt", "logs/train_console.txt", "run.config"):
            if not os.path.isfile(os.path.join(expand, f)):
                fail("the expand stage wrote no %s" % f)
        with open(os.path.join(expand, "logs", "valid_console.txt")) as f:
            log = f.read()
        if "Elastic expand: [6] -> [6, 4]" not in log or "stage 1:" not in log:
            fail("the expand stage's log lacks its stage lines")
        out["expand"] = {"best_psnr": best, "launches": counts, "expected": expect,
                         "wall_s": wall, "epochs": list(et.epochs)}
        n0 = len(et.epochs)
        best2, counts, wall = counted_cli(train_ofa_net_sr_simple.main, argv)
        print("  shrink expand/1 rerun: epochs %s, BN launches %s, best %s"
              % (et.epochs[n0:], counts["bn_forward"], best2), flush=True)
        if et.epochs[n0:] or counts["bn_forward"] or counts["bn_backward"] or best2 != -1e9:
            fail("the rerun of a finished stage trained")
        out["expand_rerun"] = {"epochs": len(et.epochs) - n0, "wall_s": wall}
        n0 = len(et.epochs)
        psd = os.path.join(tmp, "psd")
        best, counts, wall = counted_cli(train_ofa_net_sr_simple.main, [
            "--synthetic", "--task", "pixelshuffle_depth", "--phase", "1", "--mode", "sr",
            "--n_epochs", "1", "--warmup_epochs", "0", "--path", psd, "--warmstart",
            os.path.join(expand, "checkpoint")])
        p_preset = train_ofa_net_sr_simple.TASK_PHASES[("pixelshuffle_depth", 1)]
        p_space = SearchSpace(**{k: p_preset[k] for k in ("ks_list", "expand_list",
                                                         "depth_list", "pixel_d_list")})
        p_cfgs = [sample_subnet(p_space, seed=subnet_seed(0, TEACHER_EPOCH_STEPS, i, 0),
                                n_trunks=2, pixel_d_candidates=[2, 1])
                  for i in range(TEACHER_EPOCH_STEPS)]
        expect = x4_bn_launches_expected(p_cfgs, "sr")
        print("  shrink pixelshuffle_depth/1 sr (warm start): BN-kernel launches %s (expected "
              "%d each), best PSNR %.4f, %.1f s" % (counts, expect, best, wall), flush=True)
        if bn_launches_wrong(counts, expect, False) or \
                read_json(os.path.join(psd, "pixelshuffle_depth.stage")) != {"stage": 1}:
            fail("the pixelshuffle_depth stage did not run as expected")
        with open(os.path.join(psd, "logs", "valid_console.txt")) as f:
            if "warmstart:" not in f.read():
                fail("the pixelshuffle_depth stage did not warm-start")
        out["pixelshuffle_depth"] = {"best_psnr": best, "launches": counts, "expected": expect,
                                     "wall_s": wall, "epochs": et.epochs[n0:]}
    out["eval"] = x4_eval(tmp, os.path.join(psd, "checkpoint"))
    return out


def x4_eval(tmp, ckpt_dir):
    frame_log = os.path.join(tmp, "x4_frames.jsonl")
    argv = ["--path", os.path.join(tmp, "x4_eval"), "--synthetic", "--dataset", "div2k",
            "--x4_autoencoder", "--materialize", "--checkpoint", ckpt_dir, "--image_size",
            str(EVAL_HR), "--frame_log", frame_log]
    psnr, counts, wall = counted_cli(eval_ofa_net_sr.main, argv)
    cfg = uniform_subnet(SearchSpace(), 7, 6, 2, 2, n_trunks=2)
    expect = {"mbconv": sum(cfg.d) * EVAL_FRAMES, "shuffle_tail": 0}
    got = {k: counts[k] for k in expect}
    print("  eval_ofa_net_sr --x4_autoencoder --materialize, %d frames of %dx%d HR: launches %s "
          "(expected %s), mean PSNR-Y %.6f" % (EVAL_FRAMES, EVAL_HR, EVAL_HR, got, expect, psnr),
          flush=True)
    if got != expect or any(counts[k.__name__] for k in BN_KERNELS + BN_OFF_PATH):
        fail("the X4 evaluator did not go through the serving kernels as expected")
    frames = [json.loads(line) for line in open(frame_log)]
    if len(frames) != EVAL_FRAMES or not all(np.isfinite(r["psnr"]) for r in frames):
        fail("the X4 evaluator's frame log: %s" % frames)
    args = eval_ofa_net_sr.build_args(argv + ["--device", DEVICE])
    net = make_net(OFAMobileNetX4, SearchSpace(), args)
    load_weights_lenient(ckpt_dir, net)
    sub = get_active_subnet(net, cfg, mode="autoencoder", use_kernels=False)
    psnrs = []
    with torch.inference_mode():
        for batch in make_sr_provider(args, None).test:
            hr = torch.from_numpy(batch["image"]).to(net.device)
            y = sub(hr)
            if tuple(y.shape) != tuple(hr.shape) or not bool(torch.isfinite(y).all()):
                fail("X4 plain-path frame: shape %s" % (tuple(y.shape),))
            psnrs.append(float(psnr_y_device(y, hr)))
    plain = float(np.mean(psnrs))
    diff = abs(plain - psnr)
    print("  the same X4 subnet on the plain path: mean PSNR-Y %.6f (|diff| %.2e dB, at most "
          "%.0e)" % (plain, diff, PSNR_TOL_DB), flush=True)
    if not diff <= PSNR_TOL_DB:
        fail("the X4 evaluator's kernel path and plain path differ by %.3e dB" % diff)
    ms = [1e3 * r["sec"] for r in frames]
    return {"launches": counts, "expected": expect, "mean_psnr": psnr, "plain_mean_psnr": plain,
            "frame_ms": ms, "frame_ms_after_first_median": float(np.median(ms[1:])),
            "wall_s": wall}


def x4_phase(dev):
    t0 = time.perf_counter()
    net, net_cpu, net64 = build_x4(dev), build_x4("cpu"), build_x4(dev).double()
    serving_out, profiles = x4_serving(net, net_cpu, net64)
    del net, net_cpu, net64
    training_out = x4_training()
    with tempfile.TemporaryDirectory(prefix="ofa_sr_x4_") as tmp:
        cli_out = x4_cli(tmp)
    wall = time.perf_counter() - t0
    print("  phase 7 took %.1f s" % wall, flush=True)
    return {"serving": serving_out, "training": training_out, "cli": cli_out,
            "wall_s": wall}, profiles


# -- phase 8: large frames and data parallelism ------------------------------

ROW_BOUNDS = ((17, 150), (90, 91), (0, 0), (-5, 400))  # the MBConv's, at LR 180 rows
S4_1080P_LR = (270, 480)                # the S4 at pixel_d 2: 1080x1920 out
X4_1080P = (1080, 1920)                 # the X4 autoencoder's true 1080p frame
PAD_TO = {"s4": 280, "x4": 1088}        # rows of the row-padded frames
TILE = {"s4": 128, "x4": 512}           # tiles: LR pixels (S4), HR pixels (X4)
# row-padded, tiled and split frames against the full frame, through the
# kernels: max |diff| <= this times max |full frame| (cuDNN picks its conv
# algorithms by shape; the MBConv and tail kernels' per-pixel sums do not
# depend on the frame's size)
LARGE_FRAME_RTOL = 1e-5
MESH_STEPS = 4                          # one-subnet steps of the two-rank trainer
MESH_LOSS_RTOL = {"f32": 1e-4, "bf16": 1e-2}
MESH_TIMEOUT_S = 420                    # the two ranks' run, bounded
APPLY_WRAPPERS = (bn_forward_from_sums, bn_backward_from_sums)
MESH_PATH_WRAPPERS = BN_KERNELS + APPLY_WRAPPERS + (col_sums2, bn_bwd_sums, bn_moments)
# launched no time under a mesh: the fused calls' pass 1 counts there under
# col_sums2 and bn_bwd_sums
OFF_MESH_ROUTE = ("bn_forward", "bn_backward", "bn_moments")


def frame_check(name, got, full):
    """max |got - full| <= LARGE_FRAME_RTOL * max |full|; returns the
    measured ratio."""
    err = float((got - full).abs().max())
    scale = float(full.abs().max())
    ratio = err / scale
    ok = bool(torch.isfinite(got).all()) and got.shape == full.shape and \
        ratio <= LARGE_FRAME_RTOL
    print("  %-58s max|diff| %.3e = %.2e x max|full| %.3e (bound %.0e)  %s"
          % (name, err, ratio, scale, LARGE_FRAME_RTOL, "ok" if ok else "FAIL"), flush=True)
    if not ok:
        fail("%s differs from the full frame (%.3e of its scale)" % (name, ratio))
    return ratio


def windows(shape, tile, halo):
    """Windows tiled_sr_infer runs over a frame of `shape` (rows, columns):
    one a tile, the last of each row and column flush against the edge; a
    frame smaller than a window runs whole."""
    if min(shape) < tile + 2 * halo:
        return 1
    return int(np.prod([-(-e // tile) for e in shape]))


def serving_launches(run):
    """run() with the MBConv and tail counters read around it: (its result,
    {"mbconv": launches, "shuffle_tail": launches})."""
    fused_mbconv_infer.launches = fused_shuffle_tail.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {"mbconv": fused_mbconv_infer.launches,
                 "shuffle_tail": fused_shuffle_tail.launches}


def subnet_run_launches(kind, cfg):
    """MBConv and tail launches of one run of the subnet: every trunk run
    (the S4's one, the autoencoder's two); the X4's shuffle convs are 3x3,
    the tail kernel's 5x5 only."""
    return {"mbconv": sum(cfg.d), "shuffle_tail": cfg.pixel_d if kind == "s4" else 0}


def hold_launches(label, counts, expect):
    print("  %-58s launches %s (expected %s)  %s"
          % (label, counts, expect, "ok" if counts == expect else "FAIL"), flush=True)
    if counts != expect:
        fail("%s did not go through the kernels as often as expected" % label)


def mbconv_row_bounds(g):
    """(a) The MBConv kernel with row bounds at the serving shape, k 7, e 6,
    against its plain version; (0, H) gives the unbounded call's bits.
    Returns the errors and ms a launch with and without bounds."""
    x, w = mbconv_case(g, (1,) + LR_HW + (64,), SearchSpace().mid_channels(6), 7,
                       device=DEVICE)
    errs = {}
    for b in ROW_BOUNDS:
        got = launched(fused_mbconv_infer, lambda: fused_mbconv_infer(x, **w, row_valid=b))
        torch.cuda.synchronize()
        errs[str(b)] = check_close("mbconv (1, 180, 320, 64) k 7, row_valid %s" % (b,), got,
                                   mbconv_reference(x, **w, row_valid=b), TOL)
    whole = launched(fused_mbconv_infer,
                     lambda: fused_mbconv_infer(x, **w, row_valid=(0, LR_HW[0])))
    if not torch.equal(whole, fused_mbconv_infer(x, **w)):
        fail("mbconv with row_valid (0, H) is not the unbounded call's bits")
    print("  mbconv row_valid (0, 180): the unbounded call's bits  ok", flush=True)
    ms = {"unbounded": time_ms(lambda: fused_mbconv_infer(x, **w)),
          "row_valid (17, 150)": time_ms(lambda: fused_mbconv_infer(x, **w,
                                                                    row_valid=(17, 150)))}
    print("  mbconv ms a launch: %s" % {k: round(v, 4) for k, v in ms.items()}, flush=True)
    return {"max_abs_err": errs, "ms": ms}


def large_frames(dev):
    """(b) the S4 sr frame at LR 270x480 and the X4 autoencoder's true
    1080x1920 frame (ks7/e6/d2/pixel_d 2, full width, the kernels), each
    row-padded with row_valid against the unpadded frame, launches counted;
    (c) tiled_sr_infer with the receptive-field halo against the full frame.
    Returns the numbers, and each case's (subnet, x, full frame, tiled
    frame) for (d)."""
    out, frames = {}, {}
    rng = np.random.RandomState(8)
    for kind, net, mode, shape in (("s4", build_net(dev), "sr", S4_1080P_LR),
                                   ("x4", build_x4(dev), "autoencoder", X4_1080P)):
        space = net.space
        cfg = uniform_subnet(space, 7, 6, 2, 2, n_trunks=net.n_trunks)
        sub = get_active_subnet(net, cfg, mode=mode)
        x = torch.from_numpy(rng.rand(1, *shape, 3).astype(np.float32)).to(dev)
        xp = torch.zeros(1, PAD_TO[kind], shape[1], 3, device=dev)
        xp[:, :shape[0]] = x
        if mode == "autoencoder":
            halo, scale = receptive_field_radius_autoencoder(cfg, space), 1
        else:
            halo, scale = receptive_field_radius(cfg, space), 2 ** cfg.pixel_d
        with torch.inference_mode():
            full = sub(x)
            expect = subnet_run_launches(kind, cfg)
            padded, counts = serving_launches(lambda: sub(xp, row_valid=(0, shape[0])))
            hold_launches("%s %s frame row-padded to %d rows" % (kind, mode, PAD_TO[kind]),
                          counts, expect)
            rows = shape[0] * scale
            ratio_pad = frame_check("%s row-padded frame, valid rows vs the full frame" % kind,
                                    padded[:, :rows], full)
            tiled, tiled_counts = serving_launches(
                lambda: tiled_sr_infer(sub, x, tile=TILE[kind], halo=halo, scale=scale))
            n_win = windows(shape, TILE[kind], halo)
            hold_launches("%s tiled, %d windows" % (kind, n_win), tiled_counts,
                          {k: n_win * v for k, v in expect.items()})
            ratio_tiled = frame_check("%s tiled (tile %d, halo %d) vs the full frame"
                                      % (kind, TILE[kind], halo), tiled, full)
            ms = {"full": time_ms(lambda: sub(x), iters=3, warmup=1),
                  "row_padded": time_ms(lambda: sub(xp, row_valid=(0, shape[0])), iters=3,
                                        warmup=1),
                  "tiled": time_ms(lambda: tiled_sr_infer(sub, x, tile=TILE[kind], halo=halo,
                                                          scale=scale), iters=3, warmup=1)}
        print("  %s frame ms: %s" % (kind, {k: round(v, 4) for k, v in ms.items()}), flush=True)
        out[kind] = {"cfg": cfg.describe(), "frame": list(shape), "padded_rows": PAD_TO[kind],
                     "launches": counts, "halo": halo, "tile": TILE[kind], "windows": n_win,
                     "tiled_launches": tiled_counts,
                     "row_padded_over_scale": ratio_pad, "tiled_over_scale": ratio_tiled,
                     "frame_ms": ms}
        frames[kind] = (full.cpu(), tiled.cpu())
        del net, sub, full, padded, tiled
    return out, frames


def mesh_rank_main(d):
    """(d) one of two ranks sharing the card over gloo (gloo on CUDA takes
    all_reduce and broadcast, the only collectives the port uses; NCCL
    refuses two ranks on one GPU): spatial inference and the tiled window
    batch split over the ranks on (b)'s frames, then SRTrainer with the
    mesh, 4 one-subnet steps at the global bs16 96 px (8 rows a rank) in
    float32 and in bf16, BN wrapper launches counted."""
    from ofa_sr_tpu_torch.parallel import init_distributed, make_mesh, make_spatial_infer
    dev = torch.device("cuda", 0) if DEVICE == "cuda" else torch.device(DEVICE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = init_distributed(device=dev, backend="gloo", timeout_s=MESH_TIMEOUT_S)
    mesh = make_mesh(dev)
    res = {"rank": rank, "world": world, "backend": torch.distributed.get_backend()}
    rng = np.random.RandomState(8)
    for kind, net, mode, shape in (("s4", build_net(dev), "sr", S4_1080P_LR),
                                   ("x4", build_x4(dev), "autoencoder", X4_1080P)):
        space = net.space
        cfg = uniform_subnet(space, 7, 6, 2, 2, n_trunks=net.n_trunks)
        sub = get_active_subnet(net, cfg, mode=mode)
        x = torch.from_numpy(rng.rand(1, *shape, 3).astype(np.float32)).to(dev)
        if mode == "autoencoder":
            halo, scale, align = receptive_field_radius_autoencoder(cfg, space), 1, 4
        else:
            halo, scale, align = receptive_field_radius(cfg, space), 2 ** cfg.pixel_d, 1
        one = subnet_run_launches(kind, cfg)
        # the window batch in chunks of one window a rank, the last padded
        calls = -(-windows(shape, TILE[kind], halo) // world)
        with torch.inference_mode():
            spatial, counts = serving_launches(
                lambda: make_spatial_infer(sub, mesh, halo=halo, scale=scale, align=align)(x))
            tiled, tiled_counts = serving_launches(
                lambda: tiled_sr_infer_mesh(sub, x, tile=TILE[kind], halo=halo, scale=scale,
                                            mesh=mesh))
            res[kind + " launches"] = {
                "spatial": counts, "spatial_expected": one, "tiled_mesh": tiled_counts,
                "tiled_mesh_expected": {k: calls * v for k, v in one.items()}}
            t0 = time.perf_counter()
            make_spatial_infer(sub, mesh, halo=halo, scale=scale, align=align)(x)
            torch.cuda.synchronize()
            res[kind + " spatial frame ms"] = (time.perf_counter() - t0) * 1e3
        if rank == 0:
            torch.save({"spatial": spatial.cpu(), "tiled": tiled.cpu()},
                       os.path.join(d, "frames_%s.pt" % kind))
        del net, sub, spatial, tiled
    space = SearchSpace()
    for label, dtype in (("f32", None), ("bf16", BF16)):
        for k in MESH_PATH_WRAPPERS:
            k.launches = k.launches_bf16 = 0
        net = train_net(dev)
        metrics = train(MESH_STEPS, device=dev, net=net, batch_size=BS, hr_size=HR,
                        compute_dtype=dtype, mesh=mesh)
        torch.cuda.synchronize()
        flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()]).cpu()
        res[label] = {"losses": [m["loss"] for m in metrics],
                      "psnrs": [m["psnr"] for m in metrics],
                      "params_sha256": hashlib.sha256(flat.numpy().tobytes()).hexdigest(),
                      "launches": {k.__name__: k.launches for k in MESH_PATH_WRAPPERS},
                      "launches_bf16": {k.__name__: k.launches_bf16
                                        for k in MESH_PATH_WRAPPERS},
                      "expected": bn_launches_expected(
                          [c for i in range(MESH_STEPS) for c in step_subnets(space, i, 1)])}
    with open(os.path.join(d, "rank_%d.json" % rank), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def two_ranks(frames, runs_f32, runs_bf16):
    """(d) from the parent: the two ranks' run, then their results against
    (b)'s full frames, (c)'s tiled frames and phase 4's one-process runs
    (the first MESH_STEPS steps of the same seed, subnets and batch)."""
    with tempfile.TemporaryDirectory(prefix="ofa_sr_mesh_") as d:
        t0 = time.perf_counter()
        try:
            outputs = launch([sys.executable, os.path.abspath(__file__), "--mesh-rank", d], 2,
                             timeout=MESH_TIMEOUT_S + 60, cwd=os.path.dirname(
                                 os.path.abspath(__file__)))
        except RuntimeError as e:
            fail("the two-rank run failed: %s" % str(e)[-4000:])
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(d, "rank_%d.json" % r)) as f:
                ranks.append(json.load(f))
        out = {"wall_s": wall, "backend": ranks[0]["backend"],
               "note": "two processes sharing one card over gloo: no measure of multi-GPU "
                       "speed"}
        for kind in ("s4", "x4"):
            got = torch.load(os.path.join(d, "frames_%s.pt" % kind))
            full, tiled = frames[kind]
            out[kind] = {
                "spatial_over_scale": frame_check("%s spatial over 2 ranks vs the full frame"
                                                  % kind, got["spatial"], full),
                "tiled_mesh_vs_tiled_over_scale": frame_check(
                    "%s tiled over 2 ranks vs tiled in one process" % kind, got["tiled"], tiled),
                "launches_per_rank": [r[kind + " launches"] for r in ranks],
                "spatial_frame_ms_per_rank": [r[kind + " spatial frame ms"] for r in ranks]}
            for r in ranks:
                n = r[kind + " launches"]
                for route in ("spatial", "tiled_mesh"):
                    hold_launches("rank %d %s %s" % (r["rank"], kind, route), n[route],
                                  n[route + "_expected"])
    for label, one in (("f32", runs_f32), ("bf16", runs_bf16)):
        a, b = ranks[0][label], ranks[1][label]
        bf16 = label == "bf16"
        if a["params_sha256"] != b["params_sha256"] or a["losses"] != b["losses"]:
            fail("%s: the two ranks' parameters or losses differ" % label)
        ref = [m["loss"] for m in one["1 subnet"]["metrics"][:MESH_STEPS]]
        check_close("%s: %d steps over 2 ranks x bs8 vs one process at bs16, losses"
                    % (label, MESH_STEPS), torch.tensor(a["losses"]), torch.tensor(ref),
                    dict(rtol=MESH_LOSS_RTOL[label], atol=0))
        for r in ranks:
            counts = r[label]["launches_bf16" if bf16 else "launches"]
            others = r[label]["launches" if bf16 else "launches_bf16"]
            want = {k: 0 if k in OFF_MESH_ROUTE else r[label]["expected"] for k in counts}
            print("  rank %d %s: BN wrapper launches %s (expected %s)"
                  % (r["rank"], label, counts, want), flush=True)
            if counts != want or (bf16 and counts != others) or (
                    not bf16 and any(others.values())):
                fail("rank %d's %s mesh training did not launch each BN wrapper of the mesh "
                     "route once per train-mode BN and the fused ones never"
                     % (r["rank"], label))
        out[label] = {"losses": a["losses"], "one_process_losses": ref,
                      "params_equal_across_ranks": True,
                      "launches_per_rank": [r[label]["launches"] for r in ranks],
                      "launches_bf16_per_rank": [r[label]["launches_bf16"] for r in ranks],
                      "expected": a["expected"]}
    print("  two ranks took %.1f s" % out["wall_s"], flush=True)
    return out


def nccl_world_one(g, dev):
    """(e) one process, NCCL, world 1: the mesh BN route gives the fused
    call's bits at the path's BN shapes, in float32 and bf16; the apply
    entry points against their plain versions (errors, ms); the
    all-reduce's ms a BN; ms a step of the trainer with and without the
    mesh."""
    from ofa_sr_tpu_torch.parallel import all_reduce_sum, init_distributed, make_mesh
    init_distributed("127.0.0.1:%d" % free_port(), 1, 0, device=dev, timeout_s=300)
    mesh = make_mesh(dev)
    group = mesh.group
    out = {"backend": torch.distributed.get_backend(), "errs": {}}
    kw = dict(momentum=0.1, eps=BN_EPS, update_var="unbiased")
    for dtype in (torch.float32, BF16):
        key = "_bf16" if dtype is BF16 else ""
        for shp in path_bn_shapes():
            c = shp[-1]
            x = (1.5 * randn(g, *shp) + 0.3).to(dtype).contiguous()
            dy = randn(g, *shp).to(dtype)
            scale, bias = (0.5 + torch.rand(c, generator=g)).to(dev), randn(g, c, scale=0.2)
            stats = [t.clone() for t in (randn(g, c, scale=0.2),
                                         (0.5 + torch.rand(c, generator=g)).to(dev)) * 2]
            fused = bn_forward(x, scale, bias, stats[0], stats[1], **kw)
            meshed = bn_forward(x, scale, bias, stats[2], stats[3], group=group, **kw)
            bwd = bn_backward(dy, x, scale, fused[1], fused[3])
            bwd_mesh = bn_backward(dy, x, scale, fused[1], fused[3], group=group)
            torch.cuda.synchronize()
            pairs = list(zip(("y", "mean", "var", "inv"), fused, meshed)) + [
                ("running_mean", stats[0], stats[2]), ("running_var", stats[1], stats[3])] + \
                list(zip(("dx", "dscale", "dbias"), bwd, bwd_mesh))
            bad = [n for n, a, b in pairs if not torch.equal(a, b)]
            if bad:
                fail("the mesh BN route at world 1 is not the fused call's bits at %s %s: %s"
                     % (shp, dtype, bad))
            # the apply entry points against their plain versions
            sums = torch.cat([x.float().reshape(-1, c).sum(0),
                              (x.float().reshape(-1, c) ** 2).sum(0)])
            n = x.numel() // c
            got = launched(bn_forward_from_sums, lambda: bn_forward_from_sums(
                x, sums, scale, bias, None, None, n_total=n, **kw), bf16=dtype is BF16)
            ref = bn_forward_from_sums_reference(x, sums, scale, bias, None, None, n_total=n,
                                                 **kw)
            e_f = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
            bsums = torch.cat([dy.float().reshape(-1, c).sum(0),
                               (dy.float() * ((x.float() - fused[1]) * fused[3]))
                               .reshape(-1, c).sum(0)])
            got_b = launched(bn_backward_from_sums, lambda: bn_backward_from_sums(
                dy, x, bsums, scale, fused[1], fused[3], n_total=n), bf16=dtype is BF16)
            ref_b = bn_backward_from_sums_reference(dy, x, bsums, scale, fused[1], fused[3],
                                                    n_total=n)
            tol = BF16_DX_TOL if dtype is BF16 else TOL
            check_close("bn_forward_from_sums%s %s y" % (key, shp), got[0].float(),
                        ref[0].float(), tol)
            check_close("bn_backward_from_sums%s %s dx" % (key, shp), got_b.float(),
                        ref_b.float(), tol)
            out["errs"]["bn_forward_from_sums" + key] = max(
                out["errs"].get("bn_forward_from_sums" + key, 0.0), e_f)
            out["errs"]["bn_backward_from_sums" + key] = max(
                out["errs"].get("bn_backward_from_sums" + key, 0.0),
                float((got_b.float() - ref_b.float()).abs().max()))
        print("  NCCL world 1, %s: the mesh BN route gave the fused call's bits at %d shapes"
              % (dtype, len(path_bn_shapes())), flush=True)
    ar = {}
    for c in sorted({s[-1] for s in path_bn_shapes()}):
        buf = torch.zeros(2 * c, device=dev)
        ar[c] = time_ms(lambda: all_reduce_sum(buf, group))
    out["all_reduce_ms_by_C"] = ar
    space = SearchSpace()
    per_step = {}
    for i in range(TRAIN_STEPS):
        for shp in bn_train_shapes(space, step_subnets(space, i, 1)[0], BS, HR):
            per_step[shp[-1]] = per_step.get(shp[-1], 0) + 1.0 / TRAIN_STEPS
    out["all_reduce_ms_per_bn"] = sum(ar[c] * k for c, k in per_step.items()) / sum(
        per_step.values())
    out["bn_per_step"] = sum(per_step.values())
    print("  NCCL world 1: all_reduce of a BN's (2, C) totals %.4f ms (mean over a step's "
          "BNs), two a BN" % out["all_reduce_ms_per_bn"], flush=True)
    # ms a step of the trainer with and without the mesh (alternating)
    batch = synthetic_batch(BS, HR, dev)
    cfgs = [step_subnets(space, i, 1) for i in range(TRAIN_STEPS)]
    trainers = {}
    for label, m in (("no mesh", None), ("mesh", mesh)):
        net = train_net(dev)
        trainers[label] = SRTrainer(net, opt_type="adam", weight_decay=3e-5, mesh=m)
        trainers[label].train_step(batch, cfgs[0], 1e-4)  # warm-up
    step_ms = {k: [] for k in trainers}
    for label in ("no mesh", "mesh", "mesh", "no mesh"):
        tr = trainers[label]
        step_ms[label].append(timed_steps(
            lambda: [tr.train_step(batch, c, 1e-4) for c in cfgs], TRAIN_STEPS)[0])
    out["step_ms"] = {k: float(np.mean(v)) for k, v in step_ms.items()}
    out["step_ms_rounds"] = step_ms
    print("  entry.train's step with and without the mesh (NCCL world 1), ms: %s"
          % {k: round(v, 4) for k, v in out["step_ms"].items()}, flush=True)
    # the window step under the mesh: the apply kernels with the width, the
    # graphed S4 window (its all-reduces captured) and an MBV3 bf16 window
    # against one process, the gloo refusal
    walls = {}
    gd = torch.Generator(device=DEVICE).manual_seed(17)
    for part, fn in (
            ("apply_active", lambda: [apply_active_parity(gd, group, dt)
                                      for dt in (torch.float32, BF16)]),
            ("mesh_window_f32", lambda: mesh_window_main_path(mesh)),
            ("mesh_window_bf16", lambda: mesh_window_main_path(mesh, BF16)),
            ("mesh_cls_window_bf16", lambda: mesh_cls_window(mesh, tmp)),
            ("gloo_refusal", lambda: gloo_refusal(dev))):
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="ofa_sr_p8_") as tmp:
            res = fn()
        walls[part] = time.perf_counter() - t1
        if part == "apply_active":
            for r in res:
                out["errs"].update(r["errs"])
            out["apply_active_ms"] = [t for r in res for t in r["ms"]]
        else:
            out[part] = res
    out["window_part_wall_s"] = walls
    print("  the window under the mesh took %s s" % {k: round(v, 1) for k, v in walls.items()},
          flush=True)
    torch.distributed.destroy_process_group()
    return out


MESH_SPD, MESH_WINDOWS = 4, 2           # the graphed mesh window: bench.py's one-subnet
                                        # envelope, 2 windows of 4 steps
# the wrappers of the mesh route, and the fused ones it never launches
MESH_ROUTE_KEYS = ("col_sums2", "bn_bwd_sums", "bn_forward_from_sums", "bn_backward_from_sums")
FUSED_KEYS = ("bn_forward", "bn_backward")


def apply_active_parity(g, group, dtype=torch.float32):
    """(e) The apply entry points with the active width at the masked steps'
    BN shapes (the SR step's C 384 at each middle width and at 0; the
    classification step's, widths 0 and C among them; a ragged one): at
    NCCL world 1 the mesh route gives the fused calls' bits with the same
    width (y, mean, var, inv, running statistics; dx, dscale, dbias), y,
    dx, dscale and dbias 0 and the running statistics unchanged from the
    width on; each apply entry point against its plain version with the
    width, from the same totals (y, running statistics, dx); ms a launch
    of each with the width (the middle candidates' mean, 256) and without
    it at the SR step's C 384 shapes. `g`: a generator on the card (the
    classification shapes hold 77M elements). Returns {"errs":
    {"bn_forward_from_sums_active" [+ "_bf16"], "bn_backward_from_sums_active"
    [+ "_bf16"]: max abs err at the paths' shapes}, "ms": [a row a shape]}."""
    bf16 = dtype is BF16
    key, tag = ("_bf16", " bf16") if bf16 else ("", "")
    tol = BF16_DX_TOL if bf16 else TOL
    kw = dict(momentum=0.1, eps=BN_EPS, update_var="unbiased")
    cases = [(s, m, True) for s, m in masked_bn_shapes()]
    cases += [(s, 0, True) for s in sorted({s for s, _ in masked_bn_shapes()})]
    cases += cls_masked_bn_cases()
    errs = {"bn_forward_from_sums_active" + key: 0.0, "bn_backward_from_sums_active" + key: 0.0}
    times = []
    for shape, m, on_path in cases:
        n, c = int(np.prod(shape[:3])), shape[3]
        name = "mesh route%s %s active %d" % (tag, shape, m)
        x = (1.5 * torch.randn(shape, generator=g, device=DEVICE) + 0.3).to(dtype)
        dy = torch.randn(shape, generator=g, device=DEVICE).to(dtype)
        scale = 0.5 + torch.rand(c, generator=g, device=DEVICE)
        bias, rm0 = (0.2 * torch.randn(c, generator=g, device=DEVICE) for _ in range(2))
        rv0 = 0.5 + torch.rand(c, generator=g, device=DEVICE)
        st = [t.clone() for t in (rm0, rv0) * 3]
        active = torch.tensor(m, dtype=torch.int32, device=DEVICE)
        fused = bn_forward(x, scale, bias, st[0], st[1], active=active, **kw)
        meshed = launched(bn_forward_from_sums, lambda: bn_forward(
            x, scale, bias, st[2], st[3], group=group, active=active, **kw), bf16)
        bwd = bn_backward(dy, x, scale, fused[1], fused[3], active=active)
        bwd_mesh = launched(bn_backward_from_sums, lambda: bn_backward(
            dy, x, scale, fused[1], fused[3], group=group, active=active), bf16)
        torch.cuda.synchronize()
        pairs = list(zip(("y", "mean", "var", "inv"), fused, meshed)) + [
            ("running_mean", st[0], st[2]), ("running_var", st[1], st[3])] + \
            list(zip(("dx", "dscale", "dbias"), bwd, bwd_mesh))
        bad = [p for p, a, b in pairs if not torch.equal(a, b)]
        if bad:
            fail("%s: not the fused call's bits with the width: %s" % (name, bad))
        if (meshed[0][..., m:].any() or any(t[..., m:].any() for t in bwd_mesh)
                or not torch.equal(st[2][m:], rm0[m:]) or not torch.equal(st[3][m:], rv0[m:])):
            fail("%s: y, dx, dscale or dbias is not 0, or a running statistic changed, past "
                 "the width" % name)
        flat = x.view(n, c)
        sums = torch.cat(col_sums2_reference(flat, flat))
        got = launched(bn_forward_from_sums, lambda: bn_forward_from_sums(
            x, sums, scale, bias, st[4], st[5], n_total=n, active=active, **kw), bf16)
        rm_p, rv_p = rm0.clone(), rv0.clone()
        ref = bn_forward_from_sums_reference(x, sums, scale, bias, rm_p, rv_p, n_total=n,
                                             active=active, **kw)
        bsums = torch.cat(bn_bwd_sums_reference(dy.view(n, c), flat, fused[1], fused[3]))
        got_b = launched(bn_backward_from_sums, lambda: bn_backward_from_sums(
            dy, x, bsums, scale, fused[1], fused[3], n_total=n, active=active), bf16)
        ref_b = bn_backward_from_sums_reference(dy, x, bsums, scale, fused[1], fused[3],
                                                n_total=n,
                                                live=torch.arange(c, device=DEVICE) < m)
        torch.cuda.synchronize()
        e_f = check_close(name + " bn_forward_from_sums y", got[0].float(), ref[0].float(), tol)
        check_close(name + " bn_forward_from_sums running statistics",
                    torch.cat(st[4:6]), torch.cat([rm_p, rv_p]), MOMENT_TOL)
        e_b = check_close(name + " bn_backward_from_sums dx", got_b.float(), ref_b.float(), tol)
        if got[0][..., m:].any() or got_b[..., m:].any():
            fail("%s: an apply entry point's y or dx is not 0 past the width" % name)
        if on_path:
            errs["bn_forward_from_sums_active" + key] = max(
                errs["bn_forward_from_sums_active" + key], e_f)
            errs["bn_backward_from_sums_active" + key] = max(
                errs["bn_backward_from_sums_active" + key], e_b)
        if m == 256 and c == 384:
            times.append({
                "shape": list(shape), "active": m, "dtype": str(dtype).replace("torch.", ""),
                "bn_forward_from_sums_ms": steady_ms(lambda: bn_forward_from_sums(
                    x, sums, scale, bias, st[4], st[5], n_total=n, active=active, **kw)),
                "bn_forward_from_sums_no_operand_ms": steady_ms(lambda: bn_forward_from_sums(
                    x, sums, scale, bias, st[4], st[5], n_total=n, **kw)),
                "bn_backward_from_sums_ms": steady_ms(lambda: bn_backward_from_sums(
                    dy, x, bsums, scale, fused[1], fused[3], n_total=n, active=active)),
                "bn_backward_from_sums_no_operand_ms": steady_ms(lambda: bn_backward_from_sums(
                    dy, x, bsums, scale, fused[1], fused[3], n_total=n))})
            print("  apply entry points %s ms a launch, with the width and without: %s"
                  % (times[-1]["dtype"], {k: round(v, 4) for k, v in times[-1].items()
                                          if k.endswith("_ms")}), flush=True)
    print("  NCCL world 1, %s: the mesh route with the width gave the fused calls' bits at %d "
          "masked shapes" % (dtype, len(cases)), flush=True)
    return {"errs": errs, "ms": times}


@contextlib.contextmanager
def recorded_caches():
    """The GraphCaches the window steps made meanwhile (entry.train and the
    run managers make theirs inside)."""
    made, base = [], graphs_mod.GraphCache

    class Recorded(base):
        def __init__(self, device):
            super().__init__(device)
            made.append(self)

    graphs_mod.GraphCache = Recorded
    try:
        yield made
    finally:
        graphs_mod.GraphCache = base


def mesh_counts_wrong(counts, expect, bf16, mesh):
    """Why `counts` is not each BN wrapper of the route (the mesh route's
    four, or the fused two without a mesh) launched `expect` times, all of
    the run's type, and nothing else; None if it is."""
    on = MESH_ROUTE_KEYS if mesh else FUSED_KEYS
    want = {k: expect if k in on else 0 for k in MESH_ROUTE_KEYS + FUSED_KEYS}
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        return "launched %s, expected %s" % (got, want)
    if any(counts.get(k + "_bf16", 0) != (want[k] if bf16 else 0) for k in want):
        return "launched BN kernels of the other type"
    others = {k: v for k, v in counts.items() if v and k.replace("_bf16", "") not in want}
    return "launched %s" % others if others else None


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block: its backward
    convolutions then sum in a fixed order, so a run gives the same bits
    every time; the default (any order) after it. Usable as a decorator."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def release_graphs():
    """Free the memory of the graphs no window holds any more: their pools
    go back to the allocator once the graphs are collected (a window's
    objects refer to each other), and the cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def run_state(net):
    return ({k: p.detach().clone() for k, p in net.named_parameters()},
            {k: v.clone() for k, v in net.state_dict().items() if "running" in k})


def state_diff(a, b):
    """(max |a - b| over the parameters and the running statistics, bit for
    bit equal)."""
    diffs = [float((u[k].float() - v[k].float()).abs().max()) for u, v in zip(a, b) for k in u]
    return max(diffs), all(torch.equal(u[k], v[k]) for u, v in zip(a, b) for k in u)


def mesh_window_main_path(mesh, dtype=None):
    """(e) The main path of the graphed window under a mesh: entry.train on
    the full-width S4 at bench.py's one-subnet envelope (bs16, 96 px,
    MESH_WINDOWS windows of MESH_SPD steps, Adam 1e-4) under the NCCL
    world-1 mesh, counted: each distinct pass key launches every wrapper of
    the mesh route once per train-mode BN at its eager first run and once
    at its capture (its all-reduces captured with it), the fused
    bn_forward / bn_backward never; captures (the passes and the update)
    and replays. The same steps in one process launch the fused wrappers
    as often. Parity: with cuDNN's deterministic algorithms the mesh
    window's per-step losses, parameters and running statistics are the
    one-process window's bits (PSNR-Y within 1e-6: the mesh forms it from
    the summed squared errors); with the default algorithms (float32
    convolutions vary between runs, and Adam at 1e-4 turns a near-zero
    gradient's noise into a whole lr step) the per-step losses at STEP_TOL
    (bf16: BF16_STEP_TOL), and the state's distance beside the one-process
    window's distance from itself, run again (f32), reported. Then the same
    deterministic pair with dw_switch on: the masked depthwise (its wgrad a
    fixed two-pass sum, no atomics) keeps the bits, and launches each
    direction once a block of each distinct pass at its eager first run and
    capture (none without the lever)."""
    bf16 = dtype is BF16
    space = SearchSpace()
    steps = MESH_SPD * MESH_WINDOWS
    keys = pass_keys([step_subnets(space, i, 1) for i in range(steps)])
    expect = 2 * sum(3 * sum(d) + pd + 4 for d, pd in keys)
    dw_expect = 2 * sum(sum(d) for d, _ in keys)
    runs = {}
    for label, m, det, lever in (
            ("mesh", mesh, False, None), ("one process", None, False, None),
            ("one process again", None, False, None),
            ("mesh, deterministic cuDNN", mesh, True, None),
            ("one process, deterministic cuDNN", None, True, None),
            ("mesh, deterministic cuDNN, dw_switch", mesh, True, DW_LEVER),
            ("one process, deterministic cuDNN, dw_switch", None, True, DW_LEVER)):
        if label == "one process again" and bf16:
            continue
        net = graph_net()
        torch.cuda.synchronize()
        zero_kernel_counts()
        zero_counts(DW_WRAPPERS)
        t0 = time.perf_counter()
        with deterministic_cudnn() if det else contextlib.nullcontext(), \
                recorded_caches() as caches:
            metrics = train(steps, device=DEVICE, net=net, compute_dtype=dtype, mesh=m,
                            steps_per_dispatch=MESH_SPD, **(lever or {}))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dw = counts_of(DW_WRAPPERS)
        wrong = counts_wrong(DW_WRAPPERS, "masked depthwise", dw, dw_expect if lever else 0,
                             bf16)
        if wrong:
            fail("the S4 window%s (%s): %s" % (" bf16" if bf16 else "", label, wrong))
        counts = {k: v for k, v in kernel_counts().items() if v}
        cache = caches[0]
        name = "entry.train %d steps%s, steps_per_dispatch %d, %s" % (
            steps, " bf16" if bf16 else "", MESH_SPD,
            label.replace("mesh", "NCCL world-1 mesh", 1) if m is not None else label)
        print("  %s: BN launches %s (expected %d each: %d distinct passes at their eager first "
              "run and capture), %d captures (%.2f s), %d replays, %.1f s"
              % (name, counts, expect, len(keys), cache.captures, cache.capture_s,
                 cache.replays, wall), flush=True)
        wrong = mesh_counts_wrong(counts, expect, bf16, m is not None)
        if wrong:
            fail("%s %s" % (name, wrong))
        if cache.captures != len(keys) + 1 or cache.replays != 2 * steps - cache.captures:
            fail("%s: %d captures and %d replays, expected %d and %d"
                 % (name, cache.captures, cache.replays, len(keys) + 1,
                    2 * steps - len(keys) - 1))
        if not all(np.isfinite(x["loss"]) and np.isfinite(x["psnr"]) for x in metrics):
            fail("%s: non-finite metrics %s" % (name, metrics))
        runs[label] = {"metrics": metrics, "launches": dict(counts, **{
                           k: v for k, v in dw.items() if v}), "expected": expect,
                       "expected_dw": dw_expect if lever else 0,
                       "captures": cache.captures, "replays": cache.replays,
                       "capture_s": cache.capture_s, "wall_s": wall, "state": run_state(net)}
        del net, cache, caches
        release_graphs()
    out = {}
    for label, ref_label in (("mesh", "one process"), ("one process again", "one process"),
                             ("mesh, deterministic cuDNN", "one process, deterministic cuDNN"),
                             ("mesh, deterministic cuDNN, dw_switch",
                              "one process, deterministic cuDNN, dw_switch")):
        if label not in runs:
            continue
        got, ref = runs[label], runs[ref_label]
        losses = [torch.tensor([x[k] for x in r["metrics"]], dtype=torch.float64)
                  for r in (got, ref) for k in ("loss", "psnr")]
        diff, bits = state_diff(got["state"], ref["state"])
        rec = {"state_max_abs_diff": diff, "state_bits_equal": bits,
               "loss_bits_equal": bool(torch.equal(losses[0], losses[2])),
               "psnr_max_abs_diff": float((losses[1] - losses[3]).abs().max())}
        print("  %s vs %s%s: state max |diff| %.3e (bits equal %s), losses bits equal %s, "
              "PSNR-Y max |diff| %.3e" % (label, ref_label, " bf16" if bf16 else "", diff, bits,
                                          rec["loss_bits_equal"], rec["psnr_max_abs_diff"]),
              flush=True)
        if "deterministic" in label:
            if not (bits and rec["loss_bits_equal"]):
                fail("%s: the mesh window at NCCL world 1 is not the one-process window's "
                     "bits with deterministic cuDNN (state max |diff| %.3e)"
                     % ("bf16" if bf16 else "f32", diff))
            check_close("%s vs one process, per-step PSNR-Y" % label, losses[1], losses[3],
                        dict(rtol=1e-6, atol=0))
        elif label == "mesh":
            check_close("mesh window vs one process, per-step losses", losses[0], losses[2],
                        BF16_STEP_TOL if bf16 else STEP_TOL)
        out["%s vs %s" % (label, ref_label)] = rec
    for r in runs.values():
        del r["state"]
    return dict(runs=runs, comparisons=out)


def mesh_cls_window(mesh, tmp):
    """(e) One MBV3 bf16 window under the NCCL world-1 mesh: ClsRunManager
    at steps_per_dispatch CLS_SPD, an epoch of one window (batch 64 at
    224 px, one subnet a step, the kernel phase's draw, dropout 0.1 from the
    run's seed), against the same epoch in one process: the mesh route's
    wrappers launched 2 x the masked forward's train-mode BNs each (the one
    pass key at its eager first run and capture), the fused ones never;
    captures (the pass, the update) and replays; the epoch's loss at
    BF16_STEP_TOL."""
    out = {}
    for label, m in (("mesh", mesh), ("one process", None)):
        net = cls_train_net(OFAMobileNetV3, DEVICE, 41)
        provider = SyntheticClsProvider(n_train=CLS_SPD * CLS_TRAIN_BATCH, n_test=8,
                                        image_size=CLS_TRAIN_HW, n_classes=1000,
                                        train_batch_size=CLS_TRAIN_BATCH, test_batch_size=8)
        rc = RunConfig(n_epochs=1, base_lr=CLS_LR, warmup_epochs=0, opt_type="sgd",
                       weight_decay=3e-5, momentum=0.9, nesterov=True,
                       train_batch_size=CLS_TRAIN_BATCH, dynamic_batch_size=1,
                       print_frequency=2, compute_dtype="bf16", steps_per_dispatch=CLS_SPD,
                       manual_seed=0)
        rm = ClsRunManager(os.path.join(tmp, "mesh_cls_" + label.replace(" ", "_")), net, rc,
                           provider, label_smoothing=0.1, mesh=m)
        torch.cuda.synchronize()
        zero_kernel_counts()
        t0 = time.perf_counter()
        loss, top1 = rm.train_one_epoch(0, dict(expand_candidates=[6], depth_candidates=[4]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in kernel_counts().items() if v}
        cache = rm._scan_step.cache
        expect = 2 * cls_masked_bn_count(net)
        name = "ClsRunManager MBV3 bf16, steps_per_dispatch %d, %s" % (
            CLS_SPD, "NCCL world-1 mesh" if m is not None else label)
        print("  %s: BN launches %s (expected %d each), %d captures (%.2f s), %d replays, loss "
              "%.5f top1 %.3f, %.1f s" % (name, counts, expect, cache.captures,
                                          cache.capture_s, cache.replays, loss, top1, wall),
              flush=True)
        wrong = mesh_counts_wrong(counts, expect, True, m is not None)
        if wrong:
            fail("%s %s" % (name, wrong))
        if cache.captures != 2 or cache.replays != 2 * CLS_SPD - 2:
            fail("%s: %d captures and %d replays, expected 2 and %d"
                 % (name, cache.captures, cache.replays, 2 * CLS_SPD - 2))
        if not np.isfinite([loss, top1]).all():
            fail("%s: non-finite epoch metrics %s" % (name, (loss, top1)))
        out[label] = {"launches": counts, "expected": expect, "captures": cache.captures,
                      "replays": cache.replays, "capture_s": cache.capture_s, "loss": loss,
                      "top1": top1, "wall_s": wall}
        del rm, net
        torch.cuda.empty_cache()
    check_close("MBV3 bf16 window, mesh vs one process, epoch loss",
                torch.tensor([out["mesh"]["loss"]]), torch.tensor([out["one process"]["loss"]]),
                BF16_STEP_TOL)
    return out


def gloo_refusal(dev):
    """(e) A CUDA net under a gloo group (whose collectives a CUDA graph
    cannot capture): make_scan_train_step raises ValueError naming the
    backend, before any kernel launch and before its optimizer is taken
    over."""
    mesh = Mesh(torch.distributed.new_group(backend="gloo"), 0, 1, dev)
    tr = SRTrainer(graph_net(), opt_type="adam", weight_decay=3e-5, mesh=mesh)
    torch.cuda.synchronize()
    zero_kernel_counts()
    try:
        tr.make_scan_train_step(1)
        fail("make_scan_train_step took a gloo mesh on a CUDA net")
    except ValueError as e:
        msg = str(e)
    counts = {k: v for k, v in kernel_counts().items() if v}
    if "gloo" not in msg or counts or isinstance(tr.opt, GatedOpt):
        fail("the gloo refusal did not name the backend, or came after a launch (%s) or after "
             "taking over the optimizer: %s" % (counts, msg))
    print("  gloo on CUDA refused before any launch: %s" % msg, flush=True)
    torch.distributed.destroy_process_group(mesh.group)
    return msg


def apply_kernel_numbers(g, launches, errs, dtype=torch.float32):
    """The two apply entry points' rows: time a one-subnet step of their
    launches at the path's shapes (phase 4's subnets), against their plain
    versions and their bounds (bytes: the fused forward's and backward's, x
    read and y written; dy and x read and dx written). The backward's
    library call is SyncBatchNorm's apply step,
    torch.batch_norm_backward_elemt, on the channels-last NCHW views from
    the same totals (its sum_dy_xmu is the kernel's sum dy*xhat over inv),
    held against the kernel's dx first; no single PyTorch call computes the
    forward's finish, running statistics and normalize together
    (batch_norm_gather_stats_with_counts and batch_norm_elemt are two), so
    its library_ms is null."""
    bf16 = dtype is BF16
    key = "_bf16" if bf16 else ""
    space = SearchSpace()
    per_step = {}
    for i in range(TRAIN_STEPS):
        for shp in bn_train_shapes(space, step_subnets(space, i, 1)[0], BS, HR):
            per_step[shp] = per_step.get(shp, 0) + 1.0 / TRAIN_STEPS
    fwd, bwd = [], []
    kw = dict(momentum=0.1, eps=BN_EPS, update_var="unbiased")
    for shp in sorted(per_step):
        n, c = int(np.prod(shp[:3])), shp[3]
        k = per_step[shp]
        x = (1.5 * randn(g, *shp) + 0.3).to(dtype).contiguous()
        dy = randn(g, *shp).to(dtype)
        scale, bias = (0.5 + torch.rand(c, generator=g)).to(DEVICE), randn(g, c, scale=0.2)
        rm, rv = randn(g, c, scale=0.2), (0.5 + torch.rand(c, generator=g)).to(DEVICE)
        sums = torch.cat([x.float().reshape(n, c).sum(0), (x.float().reshape(n, c) ** 2).sum(0)])
        mean = sums[:c] / n
        inv = torch.rsqrt(sums[c:] / n - mean * mean + BN_EPS)
        bsums = randn(g, 2 * c)
        # SyncBatchNorm's dx from the all-reduced sums and the global count
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        count = torch.tensor([n], dtype=torch.int32, device=DEVICE)
        sum_dy_xmu = bsums[c:] / inv
        library = lambda: torch.batch_norm_backward_elemt(  # noqa: E731
            nchw(dy), nchw(x), mean, inv, scale, bsums[:c], sum_dy_xmu, count)
        check_close("torch.batch_norm_backward_elemt %s %s vs bn_backward_from_sums dx"
                    % (list(shp), key), nchw(bn_backward_from_sums(
                        dy, x, bsums, scale, mean, inv, n_total=n)).float(),
                    library().float(), BF16_DX_TOL if bf16 else TOL)
        fwd.append(measure_shape(
            lambda: bn_forward_from_sums(x, sums, scale, bias, rm, rv, n_total=n, **kw),
            lambda: bn_forward_from_sums_reference(x, sums, scale, bias, rm, rv, n_total=n,
                                                   **kw),
            flops=4 * n * c, nbytes_=2 * nbytes(x) + 9 * c * 4, launches=k, unit="step",
            shape=list(shp)))
        bwd.append(measure_shape(
            lambda: bn_backward_from_sums(dy, x, bsums, scale, mean, inv, n_total=n),
            lambda: bn_backward_from_sums_reference(dy, x, bsums, scale, mean, inv, n_total=n),
            flops=7 * n * c, nbytes_=3 * nbytes(dy) + 5 * c * 4, launches=k, unit="step",
            library=library, shape=list(shp)))
    info = dict(unit="step", dtype=str(dtype).replace("torch.", ""))
    src = "ofa_sr_tpu_torch/csrc/bn_stats.cu"
    return [kernel_row("bn_forward_from_sums" + (" (bf16)" if bf16 else ""), src,
                       "ofa_sr_tpu/ops/pallas/bn_stats.py:94",
                       launches["bn_forward_from_sums" + key],
                       errs["bn_forward_from_sums" + key], fwd,
                       wrapper="bn_forward_from_sums (under a mesh)",
                       replaces_also="the XLA normalize after the Pallas moments "
                       "(ofa_sr_tpu/ops/pallas/bn.py:47-51) and the EMA "
                       "(ofa_sr_tpu/ops/norm.py:86-90), from the all-reduced totals", **info),
            kernel_row("bn_backward_from_sums" + (" (bf16)" if bf16 else ""), src,
                       "ofa_sr_tpu/ops/pallas/bn_stats.py:196",
                       launches["bn_backward_from_sums" + key],
                       errs["bn_backward_from_sums" + key], bwd,
                       wrapper="bn_backward_from_sums (under a mesh)",
                       library_note="torch.batch_norm_backward_elemt (SyncBatchNorm's apply)",
                       replaces_also="the dx XLA fuses after the Pallas bn_bwd_sums "
                       "(ofa_sr_tpu/ops/pallas/bn.py:59-73), from the all-reduced totals",
                       **info)]


def phase8(g, dev, runs_f32, runs_bf16):
    t0 = time.perf_counter()
    out = {"mbconv_row_bounds": mbconv_row_bounds(g)}
    out["frames"], frames = large_frames(dev)
    out["two_ranks"] = two_ranks(frames, runs_f32, runs_bf16)
    out["nccl_world_1"] = nccl_world_one(g, dev)
    out["wall_s"] = time.perf_counter() - t0
    print("  phase 8 took %.1f s" % out["wall_s"], flush=True)
    return out


# -- phase 9: subnet search -------------------------------------------------

SEARCH_HR = 720                         # HR size of the latency tables (LR 360 and 180)
ADDITIVITY_SEEDS = range(8)             # sample_subnet seeds held against the table's sum
SEARCH_PROVIDER = dict(n_train=32, n_valid=2, hr_size=96, train_batch_size=16)
SEARCH_FRAMES = 8                       # the winner's LR 180x320 frames through entry.serve
# whole subnets take 5 ms or more a call at SEARCH_HR: windows of 4 and 12
# calls give a slope signal of 40 ms or more, twice measure_latency_device's
# min_signal_s, at a quarter of the default windows' work
WHOLE_WINDOWS = dict(n_small=4, n_big=12)
# the predictor: the CPU test's fit (tests/test_torch_search.py), on 256
# sampled subnets; card and CPU from the same start within PRED_RTOL (40
# Adam steps: the CPU test holds the same fit to the JAX package at 1e-3)
PRED_SUBNETS, PRED_FIT = 256, dict(epochs=10, lr=3e-3, batch_size=64, seed=2)
PRED_RTOL = 1e-3
CORNERS = dict(ks_list=[3, 7], expand_list=[3, 6], depth_list=[2, 4], pixel_d_list=[1, 2])
RESIZE = (16, 720, 360)                 # resize_bicubic: batch, in and out side
RESIZE_TOL = dict(rtol=0, atol=1e-5)    # card vs CPU: float32 matmuls, other sum order
# the oracle CLIs at their defaults, synthetic data (64 images at batch 4)
ORACLE_ARGS = {"teacher": [], "ofa": []}
ORACLE_EVAL_HR = 720


def kernel_counts():
    """Every kernel wrapper's launches (the BN ones by type), the mesh
    route's too."""
    counts = bn_counts()
    for k in APPLY_WRAPPERS + (bn_bwd_sums,):
        counts[k.__name__], counts[k.__name__ + "_bf16"] = k.launches, k.launches_bf16
    counts.update(mbconv=fused_mbconv_infer.launches, shuffle_tail=fused_shuffle_tail.launches)
    return counts


def zero_kernel_counts():
    zero_bn_counts()
    for k in APPLY_WRAPPERS + (bn_bwd_sums,):
        k.launches = k.launches_bf16 = 0
    fused_mbconv_infer.launches = fused_shuffle_tail.launches = 0


class TimedCalls:
    """While active, every measure_latency_device call of the search path
    (build_*_latency_table's and entry.search's) is recorded: its input shape,
    its ms, how many times it called the timed function (the warm-ups and
    the calls captured into the CUDA graphs: the wrappers count launches
    there; the graphs' replays re-run those launches without them) and the
    MBConv and tail launches counted meanwhile. Whole subnets (3-channel
    inputs) get the windows `whole` (WHOLE_WINDOWS by default)."""

    def __init__(self, whole=WHOLE_WINDOWS):
        self.records = []
        self.whole = whole

    def __enter__(self):
        self.real = real = search_latency.measure_latency_device
        whole = self.whole

        def timed(fn, x, **kw):
            n = [0]

            def counted(t):
                n[0] += 1
                return fn(t)

            before = fused_mbconv_infer.launches, fused_shuffle_tail.launches
            if x.shape[-1] == 3:
                kw = dict(whole, **kw)
            ms = real(counted, x, **kw)
            self.records.append({"shape": list(x.shape), "ms": ms, "calls": n[0],
                                 "mbconv": fused_mbconv_infer.launches - before[0],
                                 "shuffle_tail": fused_shuffle_tail.launches - before[1]})
            return ms

        search_latency.measure_latency_device = entry_mod.measure_latency_device = timed
        return self

    def __exit__(self, *exc):
        search_latency.measure_latency_device = entry_mod.measure_latency_device = self.real


def hold_timed_launches(label, rec, per_call):
    """Each timed call of `rec` launched `per_call` of each serving kernel."""
    expect = {k: v * rec["calls"] for k, v in per_call.items()}
    got = {k: rec[k] for k in expect}
    if got != expect:
        fail("%s: %d timed calls launched %s, expected %s" % (label, rec["calls"], got, expect))


def block_entries(net, table, records):
    """(a) The block table's entries: each positive, each block call one
    MBConv launch and no tail launch, each head/tail entry's minimal subnet
    sum(d) MBConv and pixel_d tail launches a call; beside each block entry
    its eager time (measure_latency) and the plain path's CUDA-graph time."""
    space, w = net.space, net.space.width
    if len(table.table) != 2 * 9 + 2 or not all(v > 0 for v in table.table.values()):
        fail("the block table has %d entries, not all positive: %s"
             % (len(table.table), table.table))
    rng = np.random.RandomState(1)
    rows, blocks = [], iter([r for r in records if r["shape"][-1] == w])
    wholes = iter([r for r in records if r["shape"][-1] == 3])
    for pd in space.pixel_d_list:
        lr = SEARCH_HR // 2 ** pd
        xb = torch.from_numpy(rng.rand(1, lr, lr, w).astype(np.float32)).to(DEVICE)
        for k in space.ks_list:
            for e in space.expand_list:
                rec = next(blocks)
                hold_timed_launches("block entry k%d e%s at %d" % (k, e, lr), rec,
                                    {"mbconv": 1, "shuffle_tail": 0})
                cfg = uniform_subnet(space, k, e, max(space.depth_list), pd)
                sub_k = get_active_subnet(net, cfg)
                sub_p = get_active_subnet(net, cfg, use_kernels=False)
                bk, bp = sub_k.params["dec_stages"][0][0], sub_p.params["dec_stages"][0][0]
                row = {"lr": lr, "ks": k, "e": e, "graph_ms": rec["ms"],
                       "eager_ms": search_latency.measure_latency(
                           lambda t: sub_k._mbconv(bk, t), xb),
                       "plain_graph_ms": search_latency.measure_latency_device(
                           lambda t: sub_p._mbconv(bp, t), xb),
                       "timed_calls": rec["calls"], "mbconv_launches": rec["mbconv"]}
                print("  block k%d e%s LR %d: kernel %.4f ms (CUDA graph), %.4f eager; plain "
                      "%.4f (CUDA graph); %d calls, %d MBConv launches counted"
                      % (k, e, lr, row["graph_ms"], row["eager_ms"], row["plain_graph_ms"],
                         rec["calls"], rec["mbconv"]), flush=True)
                rows.append(row)
        rec = next(wholes)
        k0, e0, d0 = min(space.ks_list), min(space.expand_list), min(space.depth_list)
        cfg = uniform_subnet(space, k0, e0, d0, pd)
        hold_timed_launches("head/tail entry at pixel_d %d" % pd, rec,
                            {"mbconv": sum(cfg.d), "shuffle_tail": pd})
        ht = table.query("sr_head_tail", [lr, lr, 3], [SEARCH_HR, SEARCH_HR, 3], pixel_d=pd)
        rows.append({"lr": lr, "head_tail_ms": ht, "whole_min_subnet_ms": rec["ms"],
                     "timed_calls": rec["calls"], "mbconv_launches": rec["mbconv"],
                     "tail_launches": rec["shuffle_tail"]})
        print("  head/tail pixel_d %d: %.4f ms (the minimal subnet %.4f less its blocks); %d "
              "calls, %d MBConv and %d tail launches counted"
              % (pd, ht, rec["ms"], rec["calls"], rec["mbconv"], rec["shuffle_tail"]),
              flush=True)
    return rows


def additivity(net, table, timed):
    """(b) The table's sum against the measured subnet, for sampled subnets:
    reported, not bounded (the sum is approximate)."""
    space = net.space
    eff = search_latency.lut_efficiency_fn(table, space, hr_size=SEARCH_HR)
    rng = np.random.RandomState(2)
    out = []
    for seed in ADDITIVITY_SEEDS:
        cfg = sample_subnet(space, seed=seed)
        lr = SEARCH_HR // 2 ** cfg.pixel_d
        x = torch.from_numpy(rng.rand(1, lr, lr, 3).astype(np.float32)).to(DEVICE)
        ms = search_latency.measure_latency_device(get_active_subnet(net, cfg), x)
        rec = timed.records[-1]
        hold_timed_launches("subnet seed %d" % seed, rec,
                            {"mbconv": sum(cfg.d), "shuffle_tail": cfg.pixel_d})
        pred = eff(cfg)
        out.append({"seed": seed, "cfg": cfg.describe(), "lut_ms": pred, "measured_ms": ms,
                    "rel_err": (pred - ms) / ms, "mbconv_launches": rec["mbconv"],
                    "tail_launches": rec["shuffle_tail"]})
        print("  seed %d (pixel_d %d, sum(d) %d): table %.4f ms, measured %.4f, rel err %+.4f"
              % (seed, cfg.pixel_d, sum(cfg.d), pred, ms, (pred - ms) / ms), flush=True)
    return out


def search_and_deploy(net):
    """(c) entry.search on the full-width S4, the deployments' recalibration
    counted; then the winner serves SEARCH_FRAMES frames through
    entry.serve, counted, against the plain path."""
    provider = SyntheticSRProvider(**SEARCH_PROVIDER)
    zero_kernel_counts()
    t0 = time.perf_counter()
    with TimedCalls() as timed:
        rep = entry_mod.search(net, provider, hr_size=SEARCH_HR, quality="macs", device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    winner, cands = rep["winner"], rep["candidates"]
    n_batches = len(provider.train)
    # the deployments: entry.search's smallest and largest uniform subnets
    # (at the largest pixel_d) and the winner
    cfgs = [uniform_subnet(net.space, 3, 3, 2, 2), uniform_subnet(net.space, 7, 6, 4, 2), winner]
    expect = n_batches * bn_launches_expected(cfgs)
    print("  entry.search: %.1f s; winner %s; table %.4f ms (constraint %.4f), measured %.4f"
          % (wall, winner.describe(), cands["searched"]["lut_ms"], rep["constraint_ms"],
             cands["searched"]["true_ms"]), flush=True)
    for name, c in cands.items():
        print("    %-12s table %.4f ms, measured %.4f, trunk %.3f GMAC, PSNR-Y %.4f dB after "
              "recalibration" % (name, c["lut_ms"], c["true_ms"], c["trunk_gmacs"],
                                 c["psnr_db"]), flush=True)
    print("  recalibration: BN launches %s (bn_forward expected %d: %d batches x "
          "3*sum(d)+pixel_d+4 over the 3 subnets)"
          % ({k: v for k, v in counts.items() if k.startswith(("bn", "col"))}, expect,
             n_batches), flush=True)
    if not cands["searched"]["lut_ms"] <= rep["constraint_ms"]:
        fail("the winner's table time exceeds the constraint")
    if counts["bn_forward"] != expect or any(
            v for k, v in counts.items() if k not in ("bn_forward", "mbconv", "shuffle_tail")):
        fail("the deployments' recalibration did not launch bn_forward once per train-mode BN "
             "(and nothing else of the BN kernels)")
    if not all(np.isfinite(c["psnr_db"]) and c["true_ms"] > 0 for c in cands.values()):
        fail("a deployment has no finite PSNR-Y or no positive time: %s" % cands)
    rng = np.random.RandomState(3)
    frames = [rng.rand(1, *LR_HW, 3).astype(np.float32) for _ in range(SEARCH_FRAMES)]
    out, served = serving_launches(lambda: serve(frames, net=net, cfg=winner, device=net.device))
    hold_launches("the winner, %d frames through entry.serve" % SEARCH_FRAMES, served,
                  {"mbconv": sum(winner.d) * SEARCH_FRAMES,
                   "shuffle_tail": winner.pixel_d * SEARCH_FRAMES})
    sub_p = get_active_subnet(net, winner, use_kernels=False, fold_tail=False)
    with torch.inference_mode():
        for i in (0, SEARCH_FRAMES - 1):
            check_close("winner frame %d: kernels vs plain path" % i, out[i],
                        sub_p(torch.from_numpy(frames[i]).to(net.device)), FRAME_TOL)
    return {"wall_s": wall, "winner": winner.describe(), "constraint_ms": rep["constraint_ms"],
            "candidates": cands, "history": rep["history"], "lut": rep["lut"],
            "launches": counts, "bn_forward_expected": expect, "recalib_batches": n_batches,
            "serve_launches": served, "timed_calls": timed.records}


def predictor_and_corners(net):
    """(d) The predictor's fit on the card against the same fit on the CPU,
    and the whole-subnet table over the corners."""
    space = net.space
    cfgs = [sample_subnet(space, seed=s) for s in range(PRED_SUBNETS)]
    feats = np.stack([search.encode_sr_subnet(c, space) for c in cfgs])
    targets = np.asarray([search.s4_subnet_flops(c, space) / 1e9 for c in cfgs])
    start = search.AccuracyPredictor(feats.shape[1], hidden=64, n_layers=2, device="cpu")
    card = search.AccuracyPredictor(feats.shape[1], hidden=64, n_layers=2, device=DEVICE)
    card.load_state_dict(start.state_dict())
    t0 = time.perf_counter()
    loss = card.fit(feats, targets, **PRED_FIT)
    fit_s = time.perf_counter() - t0
    loss_cpu = start.fit(feats, targets, **PRED_FIT)
    test = np.stack([search.encode_sr_subnet(sample_subnet(space, seed=10_000 + i), space)
                     for i in range(64)])
    got, ref = card.predict(test), start.predict(test)
    err = float(np.max(np.abs(got - ref) / np.abs(ref)))
    print("  predictor fit on the card: %.2f s, loss %.6g (CPU %.6g); predictions max rel "
          "diff %.2e (at most %.0e)" % (fit_s, loss, loss_cpu, err, PRED_RTOL), flush=True)
    if not (err <= PRED_RTOL and abs(loss - loss_cpu) <= PRED_RTOL * abs(loss_cpu)):
        fail("the predictor's fit on the card disagrees with the CPU's")
    with TimedCalls() as timed:
        table = search_latency.build_latency_table(net, SearchSpace(**CORNERS),
                                                   hr_size=SEARCH_HR)
    if len(table.table) != 16 or not all(v > 0 for v in table.table.values()):
        fail("the corner table: %s" % table.table)
    for key, rec in zip(table.table, timed.records):
        d = int(key.split("depth:")[1].split("-")[0])
        pd = int(key.split("pixel_d:")[1])
        hold_timed_launches(key, rec, {"mbconv": 4 * d, "shuffle_tail": pd})
    print("  corner table: %s" % {k.split("-", 3)[3]: round(v, 4) for k, v in table.table.items()},
          flush=True)
    return {"fit_s": fit_s, "loss": loss, "loss_cpu": loss_cpu, "pred_max_rel_diff": err,
            "corners": table.table, "corner_calls": timed.records}


def data_and_video_clis():
    """(e) resize_bicubic on the card against the CPU; the oracle-video CLIs
    (BN frozen: no BN kernel) and the evaluator on oracle-video frames."""
    b, n_in, n_out = RESIZE
    x = torch.from_numpy(np.random.RandomState(4).rand(b, n_in, n_in, 3).astype(np.float32))
    xd = x.to(DEVICE)
    got = resize_bicubic(xd, n_out, n_out)
    torch.cuda.synchronize()
    err = check_close("resize_bicubic %s -> %d: card vs CPU" % (tuple(x.shape), n_out),
                      got.cpu(), resize_bicubic(x, n_out, n_out), RESIZE_TOL)
    ms = time_ms(lambda: resize_bicubic(xd, n_out, n_out), iters=10)
    print("  resize_bicubic: %.4f ms a batch" % ms, flush=True)
    out = {"resize": {"max_abs_err": err, "ms": ms, "shape": list(x.shape), "out": n_out}}
    with tempfile.TemporaryDirectory(prefix="ofa_oracle_") as tmp:
        runs = {
            "teacher validate": (train_teacher_net_sr_oracle_video.main,
                                 ["--synthetic", "--path", os.path.join(tmp, "tv")]
                                 + ORACLE_ARGS["teacher"]),
            "teacher finetune": (train_teacher_net_sr_oracle_video.main,
                                 ["--synthetic", "--finetune", "--n_epochs", "1", "--path",
                                  os.path.join(tmp, "tf")] + ORACLE_ARGS["teacher"]),
            "ofa oracle": (train_ofa_net_sr_oracle_video.main,
                           ["--synthetic", "--n_epochs", "1", "--path",
                            os.path.join(tmp, "ofa")] + ORACLE_ARGS["ofa"]),
        }
        for label, (main_fn, argv) in runs.items():
            zero_kernel_counts()
            psnr, counts, wall = counted_cli(main_fn, argv)
            counts = kernel_counts()
            print("  %s: PSNR-Y %.4f, %.1f s, launches %s" % (label, psnr, wall, counts),
                  flush=True)
            if not np.isfinite(psnr) or any(counts.values()):
                fail("%s: PSNR-Y %s; with BN frozen it launches no kernel, got %s"
                     % (label, psnr, counts))
            out[label] = {"psnr": psnr, "wall_s": wall, "launches": counts}
        argv = ["--synthetic", "--dataset", "oracle_video", "--materialize", "--image_size",
                str(ORACLE_EVAL_HR), "--path", os.path.join(tmp, "eval")]
        psnr, counts, wall = counted_cli(eval_ofa_net_sr.main, argv)
        cfg = uniform_subnet(SearchSpace(), 7, 6, 2, 2)
        hold_launches("eval_ofa_net_sr --dataset oracle_video --materialize",
                      {k: counts[k] for k in ("mbconv", "shuffle_tail")},
                      {"mbconv": sum(cfg.d) * EVAL_FRAMES,
                       "shuffle_tail": cfg.pixel_d * EVAL_FRAMES})
        if not np.isfinite(psnr):
            fail("the oracle-video evaluator's PSNR-Y is %s" % psnr)
        out["eval oracle_video"] = {"psnr": psnr, "wall_s": wall, "launches": counts}
    return out


def phase9(dev):
    t0 = time.perf_counter()
    net = build_net(dev)
    out = {}
    out["search"] = search_and_deploy(net)
    table = search_latency.LatencyTable(dict(out["search"]["lut"]))
    # the search's first 20 timed calls built its block table
    out["block_table"] = block_entries(net, table, out["search"]["timed_calls"][:20])
    with TimedCalls() as timed:
        out["additivity"] = additivity(net, table, timed)
    out["predictor"] = predictor_and_corners(net)
    out["data"] = data_and_video_clis()
    out["wall_s"] = time.perf_counter() - t0
    print("  phase 9 took %.1f s" % out["wall_s"], flush=True)
    return out


# -- phase 10: export, profile, the classification nets, the tutorial ---------

EXPORT_TOL = dict(rtol=1e-6, atol=1e-6)   # the loaded artifact vs the eager plain path
CLS_BATCH, CLS_HW = 16, 224
CLS_TOL = dict(rtol=1e-3, atol=1e-3)      # logits: static nets vs supernet, kernels vs plain
CLS_STATE_TOL = dict(rtol=1e-4, atol=1e-4)  # running statistics, kernels vs plain
CLS_ARCH_SEEDS = (1, 2)
CLS_TIME_ITERS = 5
# the kernel-table rows whose wrapper's name is not their name's first word
ROW_WRAPPER = {"fused_mbconv_infer": "mbconv", "fused_shuffle_tail": "shuffle_tail",
               BWD_ROW: "bn_backward", BF16_ROWS[BWD_ROW]: "bn_backward"}


def export_frames(dev, tmp):
    """(a): each artifact saved, loaded on the card and held to the eager
    plain path and the kernel path; the kernel frames counted; the
    artifact's, plain and kernel frames' ms (CUDA events, back to back)."""
    s4, x4 = build_net(dev), build_x4(dev)
    cases = (("s4", s4, uniform_subnet(s4.space, 7, 6, 2, 2), "sr", LR_HW),
             ("x4 autoencoder", x4, uniform_subnet(x4.space, 7, 6, 2, 2, n_trunks=2),
              "autoencoder", (LR_HW[0] * 4, LR_HW[1] * 4)))
    rng = np.random.RandomState(10)
    out, total = {}, {}
    for name, net, cfg, mode, hw in cases:
        path = os.path.join(tmp, name.replace(" ", "_") + ".pt2")
        t0 = time.perf_counter()
        blob = export_subnet(net, cfg, hw, mode=mode, path=path)
        export_s = time.perf_counter() - t0
        served = load_subnet(path, device=dev)
        subs = {"artifact": served,
                "plain": get_active_subnet(net, cfg, mode=mode, use_kernels=False),
                "kernels": get_active_subnet(net, cfg, mode=mode, use_kernels=True)}
        xs = [torch.from_numpy(rng.rand(1, *hw, 3).astype(np.float32)).to(dev)
              for _ in range(N_FRAMES)]
        torch.cuda.synchronize()
        with torch.inference_mode():
            zero_kernel_counts()
            ys = [subs["kernels"](x) for x in xs]
            torch.cuda.synchronize()
            counts = kernel_counts()
            expect = {"mbconv": sum(cfg.d) * N_FRAMES,
                      "shuffle_tail": (cfg.pixel_d if mode == "sr" else 0) * N_FRAMES}
            got = {k: counts[k] for k in expect}
            print("  export %s: %d bytes, exported in %.2f s; kernel frames' launches %s "
                  "(expected %s)" % (name, len(blob), export_s, got, expect), flush=True)
            if got != expect or any(v for k, v in counts.items() if k not in expect):
                fail("the %s kernel frames did not go through the serving kernels as expected"
                     % name)
            errs = {}
            sub64 = (get_active_subnet(build_x4(dev).double(), cfg, mode=mode, use_kernels=False,
                                       fold_tail=False) if mode == "autoencoder" else None)
            for i in (0, N_FRAMES - 1):
                a = served(xs[i])
                errs["frame %d artifact vs plain" % i] = check_close(
                    "%s frame %d: artifact vs eager plain path" % (name, i), a,
                    subs["plain"](xs[i]), EXPORT_TOL)
                if mode == "sr":
                    errs["frame %d artifact vs kernels" % i] = check_close(
                        "%s frame %d: artifact vs kernel path" % (name, i), a, ys[i], FRAME_TOL)
                else:
                    errs["frame %d kernels vs f64" % i] = f64_frame_check(
                        "%s frame %d: kernel path" % (name, i), ys[i], [a],
                        sub64(xs[i].double()))
            del sub64
            times = {k: time_ms(lambda sub=sub: [sub(x) for x in xs], iters=3, warmup=1)
                     / N_FRAMES for k, sub in subs.items()}
        print("  export %s frame ms (CUDA events, mean of %d frames x 3): %s"
              % (name, N_FRAMES, {k: round(v, 4) for k, v in times.items()}), flush=True)
        out[name] = {"bytes": len(blob), "export_s": export_s, "input_hw": list(hw),
                     "cfg": cfg.describe(), "launches": got, "expected": expect,
                     "errors": errs, "frame_ms": times}
        # the counted frames, the checks and the timings
        for k, v in kernel_counts().items():
            total[k] = total.get(k, 0) + v
    out["launches_all"] = total
    info = {"s4": get_net_info(s4), "x4": get_net_info(x4)}
    print("  get_net_info: %s" % info, flush=True)
    out["net_info"] = info
    return out


def cls_bn_count(net, arch):
    """The train-mode BNs of `arch`: the first conv's, the first block's
    two, three in each active block, the head's one."""
    n_blocks = sum(min(d, sp.n_block) for d, sp in zip(arch.d, net.stage_specs))
    return 3 + 3 * n_blocks + 1


def running_stats(net):
    return {k: v.clone() for k, v in net.state_dict().items()
            if "running" in k or "num_batches" in k}


def cls_case(label, net, arch, x, tmp, export):
    """(c) for one arch: the eval forward against the static nets, the
    train-mode forward with and without the BN kernel, launches, ms, and
    (where `export`) the exported subnet."""
    saved = running_stats(net)
    with torch.inference_mode():
        y = net(x, arch)
        sub = get_active_cls_subnet(net, arch)
        static = specialize(net, arch)
        errs = {"materialized": check_close("%s %s: eval vs StaticClsSubnet"
                                            % (label, arch.describe()[:40]), sub(x), y, CLS_TOL),
                "specialized": check_close("%s: eval vs specialize's static net" % label,
                                           static(x), y, CLS_TOL)}
        yp = net(x, arch, training=True, use_kernels=False)
        plain_stats = running_stats(net)
        net.load_state_dict(saved, strict=False)
        torch.cuda.synchronize()
        zero_kernel_counts()
        yk = net(x, arch, training=True, use_kernels=True)
        torch.cuda.synchronize()
        counts = kernel_counts()
        kern_stats = running_stats(net)
        net.load_state_dict(saved, strict=False)
        errs["train logits"] = check_close("%s: train-mode logits, kernels vs plain" % label,
                                           yk, yp, CLS_TOL)
        keys = [k for k in kern_stats if "running" in k]
        errs["train running stats"] = check_close(
            "%s: running statistics, kernels vs plain" % label,
            torch.cat([kern_stats[k] for k in keys]), torch.cat([plain_stats[k] for k in keys]),
            CLS_STATE_TOL)
        n_bn = cls_bn_count(net, arch)
        if counts["bn_forward"] != n_bn or any(v for k, v in counts.items()
                                               if k != "bn_forward"):
            fail("%s: the train-mode forward launched %s, expected bn_forward %d times and "
                 "nothing else" % (label, {k: v for k, v in counts.items() if v}, n_bn))
        ms = {"eval": time_ms(lambda: net(x, arch), iters=CLS_TIME_ITERS, warmup=1),
              "materialized": time_ms(lambda: sub(x), iters=CLS_TIME_ITERS, warmup=1),
              "specialized": time_ms(lambda: static(x), iters=CLS_TIME_ITERS, warmup=1),
              "train kernels": time_ms(lambda: net(x, arch, training=True, use_kernels=True),
                                       iters=CLS_TIME_ITERS, warmup=1),
              "train plain": time_ms(lambda: net(x, arch, training=True, use_kernels=False),
                                     iters=CLS_TIME_ITERS, warmup=1)}
        net.load_state_dict(saved, strict=False)
        out = {"arch": arch.describe(), "bn_forward": n_bn, "errors": errs, "ms": ms,
               "launches": {k: v for k, v in counts.items() if v}}
        if export:
            path = os.path.join(tmp, label.replace(" ", "_") + ".pt2")
            blob = export_cls_subnet(net, arch, CLS_HW, batch=CLS_BATCH, path=path)
            out["export_bytes"] = len(blob)
            errs["artifact"] = check_close("%s: artifact vs materialized" % label,
                                           load_subnet(path, device=x.device)(x), sub(x),
                                           EXPORT_TOL)
    print("  %s: bn_forward %d launches; ms a batch of %d: %s" % (
        label, n_bn, CLS_BATCH, {k: round(v, 4) for k, v in ms.items()}), flush=True)
    return out


def cls_nets(dev, tmp):
    """(c): both families at published width, MBV3 also at runtime elastic
    width."""
    g = torch.Generator().manual_seed(20)
    x = torch.rand(CLS_BATCH, CLS_HW, CLS_HW, 3, generator=g).to(dev)
    out, total = {}, {}
    for label, make, kw in (("MBV3", OFAMobileNetV3, {}),
                            ("Proxyless", OFAProxylessNASNets, {}),
                            ("MBV3 w[0.65,1.0]", OFAMobileNetV3,
                             {"width_mult_list": [0.65, 1.0]})):
        net = make(n_classes=1000, device=dev, generator=torch.Generator().manual_seed(21),
                   **kw)
        randomize_bn(net, torch.Generator().manual_seed(22))
        archs = [net.max_arch()] + [net.sample_arch(s) for s in CLS_ARCH_SEEDS]
        if kw:  # wid 0 and 1
            archs = [dataclasses.replace(archs[0], wid=0), dataclasses.replace(archs[1], wid=1)]
        out[label] = [cls_case("%s %d" % (label, i), net, a, x, tmp, export=(i == 0 and not kw))
                      for i, a in enumerate(archs)]
        for case in out[label]:
            for k, v in case["launches"].items():
                total[k] = total.get(k, 0) + v
        del net
    return out, total


def tutorial_run(tmp):
    """(d): the tutorial at its defaults on the card, every launch counted."""
    zero_kernel_counts()
    t0 = time.perf_counter()
    res = tutorial.main(["--path", os.path.join(tmp, "tutorial")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in kernel_counts().items() if v}
    winner = SubnetConfig.from_dict(res["winner_cfg"])
    expect = {"mbconv": sum(winner.d), "shuffle_tail": winner.pixel_d}
    print("  tutorial: %.1f s; winner %s; deployed %.4f ms a frame; the deployed frame's "
          "launches %s (expected %s); every launch of the run %s"
          % (wall, winner.describe(), res["deployed_ms"], res["deployed_launches"], expect,
             counts), flush=True)
    if res["deployed_launches"] != expect:
        fail("the tutorial's deployed frame did not go through the serving kernels")
    if not counts.get("bn_forward") or counts.get("bn_forward") != counts.get("bn_backward"):
        fail("the tutorial's training did not run every BN through bn_forward and bn_backward")
    if res["artifact_max_abs_err_plain"] > EXPORT_TOL["atol"]:
        fail("the tutorial's artifact differs from its plain path by %.3e"
             % res["artifact_max_abs_err_plain"])
    return dict(res, wall_s=wall, launches=counts)


def phase10(dev):
    t0 = time.perf_counter()
    pil = subprocess.run([sys.executable, "-c", "import PIL; print(PIL.__version__)"],
                         capture_output=True, text=True, timeout=60)
    pil_line = (pil.stdout.strip() if pil.returncode == 0
                else (pil.stderr.strip().splitlines() or ["no output"])[-1])
    print("  PIL on this machine (python3 -c 'import PIL'): %s" % pil_line, flush=True)
    out = {"pil": pil_line}
    with tempfile.TemporaryDirectory(prefix="ofa_sr_p10_") as tmp:
        out["export"] = export_frames(dev, tmp)
        out["cls"], out["cls_launches"] = cls_nets(dev, tmp)
        out["tutorial"] = tutorial_run(tmp)
    out["wall_s"] = time.perf_counter() - t0
    print("  phase 10 took %.1f s" % out["wall_s"], flush=True)
    return out


def trace_check(dev, tmp):
    """(b), run last: `trace` around two kernel frames of phase 3's subnet
    writes a trace that names both serving kernels."""
    net = build_net(dev)
    sub = get_active_subnet(net, uniform_subnet(net.space, 7, 6, 2, 2), use_kernels=True)
    x = torch.rand(1, *LR_HW, 3, generator=torch.Generator().manual_seed(30)).to(dev)
    logdir = os.path.join(tmp, "trace")
    with torch.inference_mode(), trace(logdir) as d:
        for _ in range(2):
            sub(x)
        torch.cuda.synchronize()
    files = [os.path.join(d, f) for f in os.listdir(d)]
    text = "".join(open(f).read() for f in files)
    found = {k: text.count(k) for k in ("mbconv_kernel", "shuffle_tail_kernel")}
    print("  trace: %s (%d bytes), kernel names found %s" % (
        [os.path.basename(f) for f in files], len(text), found), flush=True)
    if len(files) != 1 or not all(found.values()):
        fail("trace() wrote no trace naming both serving kernels")
    return {"files": len(files), "bytes": len(text), "names": found}


# -- phase 11: classification training ---------------------------------------

CLS_TRAIN_BATCH, CLS_TRAIN_HW = 64, 224   # train_ofa_net's per-device batch at 224 px
CLS_LR = 2.5e-3                          # the depth and expand phase-1 presets' LR
# a parameter past STEP_TOL after a step, kernels against plain (the
# classification step's gradients are 10-60x the early convs' weights, and
# train-mode BN's E[x^2] - mean^2 cancels on channels whose mean dwarfs their
# spread, so float32 noise alone passes STEP_TOL's atol there): its update
# within this share of the float64 step's update (relative L2), the plain
# float32 path's share reported beside it
CLS_UPDATE_RTOL = 5e-2
CLS_EVAL_HW = 224                         # eval_ofa_net's default --image_size
CLS_STEP_ROUNDS = 1                       # rounds of (plain, kernels, kernels, plain) timing
CLS_FAMILIES = (("MBV3", OFAMobileNetV3), ("Proxyless", OFAProxylessNASNets))
CLS_DTYPES = ((None, "f32"), (BF16, "bf16"))
CLS_STEP_PATHS = ("plain", "kernels")
# (c): the real data paths' sizes, all drawn in one epoch of the folder provider
ELASTIC_SIZES = (128, 160, 192, 224)
FOLDER_BATCH, FOLDER_TRAIN_PER_CLASS, FOLDER_CLASSES = 8, 24, 4  # 12 batches: all 4 sizes
CIFAR_PER_BATCH_FILE, CIFAR_BATCH = 64, 64


def cls_envelopes(net):
    """The phase's two steps: one subnet of the kernel phase (ks drawn, e6,
    d4), and TASK_PHASES[("expand", 2)]'s 4 subnets (ks, e and d drawn)."""
    expand = train_ofa_net.TASK_PHASES[("expand", 2)]
    return {"1 subnet": [net.sample_arch(seed=subnet_seed(0, 1, 0, 0), expand_candidates=[6],
                                         depth_candidates=[4])],
            "4 subnets + KD": [net.sample_arch(seed=subnet_seed(0, 1, 0, k),
                                               ks_candidates=expand["ks_list"],
                                               expand_candidates=expand["expand_list"],
                                               depth_candidates=expand["depth_list"])
                               for k in range(expand["dynamic_batch_size"])]}


def cls_train_net(make, dev, seed, **kw):
    net = make(n_classes=1000, device=dev, generator=torch.Generator().manual_seed(seed), **kw)
    randomize_bn(net, torch.Generator().manual_seed(seed + 1))
    return net


def cls_trainer(net, env, teacher, use_kernels, dtype, lever=None):
    kd = env != "1 subnet"
    return ClsTrainer(net, opt_type="sgd", weight_decay=3e-5, momentum=0.9, nesterov=True,
                      label_smoothing=0.1, kd_ratio=1.0 if kd else 0.0,
                      teacher=teacher if kd else None, use_kernels=use_kernels,
                      compute_dtype=dtype, **(lever or {}))


BN_PATH_KEYS = ("bn_forward", "bn_backward", "bn_forward_bf16", "bn_backward_bf16")


def cls_bn_launches_wrong(counts, expect, bf16):
    """bn_launches_wrong for a classification step: also no kernel of the
    mesh route and no serving kernel."""
    others = {k: v for k, v in counts.items() if v and k not in BN_PATH_KEYS}
    return bn_launches_wrong(counts, expect, bf16) or (
        "launched %s" % others if others else None)


def cls_step_checks(label, net, w0, batch, archs, env, teacher, dtype):
    """One step from w0 on the kernel path (counted) and on the plain path:
    losses, and in float32 the parameters and running statistics after it."""
    bf16 = dtype is BF16
    runs = [("kernels", net, True, batch, teacher), ("plain", net, False, batch, teacher)]
    if not bf16:  # the plain path in float64: the reference of the float32 updates
        net64, t64 = (copy.deepcopy(m).double() for m in (net, teacher[0]))
        net64.load_state_dict(w0)
        runs.append(("float64", net64, False, dict(batch, image=batch["image"].double()),
                     (t64, teacher[1])))
    out = {}
    for name, n_, use_kernels, b, t in runs:
        n_.load_state_dict(w0)
        tr = cls_trainer(n_, env, t, use_kernels, dtype)
        torch.cuda.synchronize()
        zero_kernel_counts()
        m = tr.train_step(b, archs, CLS_LR)
        torch.cuda.synchronize()
        counts = kernel_counts()
        out[name] = {"loss": m["loss"].float().cpu(), "counts": counts,
                     "params": {k: p.detach().clone() for k, p in n_.named_parameters()},
                     "stats": running_stats(n_), "metrics": {k: float(v) for k, v in m.items()}}
    kern, plain = out["kernels"], out["plain"]
    expect = sum(cls_bn_count(net, a) for a in archs)
    wrong = cls_bn_launches_wrong(kern["counts"], expect, bf16)
    print("  %s: BN launches %s (expected %d each), loss %.5f (plain %.5f)"
          % (label, {k: v for k, v in kern["counts"].items() if v}, expect,
             kern["metrics"]["loss"], plain["metrics"]["loss"]), flush=True)
    if wrong:
        fail("%s: the kernel path %s" % (label, wrong))
    if any(plain["counts"].values()):
        fail("%s: the plain path launched %s" % (label, {k: v for k, v in plain["counts"].items()
                                                         if v}))
    if not all(np.isfinite(v) for v in kern["metrics"].values()):
        fail("%s: non-finite metrics %s" % (label, kern["metrics"]))
    errs = {"loss": check_close("%s: loss, kernels vs plain" % label, kern["loss"][None],
                                plain["loss"][None], BF16_STEP_TOL if bf16 else STEP_TOL)}
    if not bf16:
        errs["params"] = max(float((kern["params"][n] - plain["params"][n]).abs().max())
                             for n in kern["params"])
        # each tensor at STEP_TOL; a tensor past it (float32 noise in a
        # gradient 10-60x its weights) with its update within CLS_UPDATE_RTOL
        # of the float64 step's (relative L2), the plain path's measured
        # beside it
        ref = out["float64"]["params"]
        errs["past_step_tol"] = {}
        for n, k_n in kern["params"].items():
            if bool(torch.isclose(k_n, plain["params"][n], **STEP_TOL).all()):
                continue
            size = float((ref[n] - w0[n].double()).norm())
            rel = {p: float((o["params"][n].double() - ref[n]).norm()) / size
                   for p, o in (("kernels", kern), ("plain", plain))}
            errs["past_step_tol"][n] = rel
            if not rel["kernels"] <= CLS_UPDATE_RTOL:
                fail("%s: %s's update on the kernel path is %.3e of its size from the float64 "
                     "step's (the plain path's %.3e; bound %.0e)"
                     % (label, n, rel["kernels"], rel["plain"], CLS_UPDATE_RTOL))
        keys = [k for k in kern["stats"] if "running" in k]
        errs["running stats"] = check_close(
            "%s: running statistics, kernels vs plain" % label,
            torch.cat([kern["stats"][k] for k in keys]),
            torch.cat([plain["stats"][k] for k in keys]), CLS_STATE_TOL)
        worst = {p: max([r[p] for r in errs["past_step_tol"].values()] or [0.0])
                 for p in ("kernels", "plain")}
        print("  %s: params after the step, kernels vs plain: max_abs_err %.3e; %d tensors past "
              "STEP_TOL, their updates at most %.3e (kernels) and %.3e (plain) of their size "
              "from the float64 step's  ok" % (label, errs["params"], len(errs["past_step_tol"]),
                                                worst["kernels"], worst["plain"]), flush=True)
    return {"archs": [a.describe() for a in archs], "bn_per_step": expect,
            "launches": {k: v for k, v in kern["counts"].items() if v},
            "metrics": kern["metrics"], "plain_metrics": plain["metrics"], "errors": errs}


def cls_step_times(label, net, batch, archs, env, teacher, dtype):
    """ms per step (CUDA events) and host enqueue ms of the plain and kernel
    paths in CLS_STEP_ROUNDS rounds of (plain, kernels, kernels, plain), and
    each path's peak of torch.cuda.max_memory_allocated over a step. The
    steps move the weights; the timings do not depend on their values."""
    trainers = {p: cls_trainer(net, env, teacher, p == "kernels", dtype) for p in CLS_STEP_PATHS}

    def run(p):
        trainers[p].train_step(batch, archs, CLS_LR)

    peak = {}
    for p in CLS_STEP_PATHS:
        run(p)  # warm: cuDNN's algorithm choice, the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run(p)
        torch.cuda.synchronize()
        peak[p] = torch.cuda.max_memory_allocated() / 2 ** 20
    times = {p: [] for p in CLS_STEP_PATHS}
    for p in (CLS_STEP_PATHS + CLS_STEP_PATHS[::-1]) * CLS_STEP_ROUNDS:
        times[p].append(timed_steps(lambda: run(p), 1))
    out = {}
    for p in CLS_STEP_PATHS:
        ev, host = zip(*times[p])
        out[p] = {"ms": list(ev), "host_enqueue_ms": list(host), "median_ms": float(np.median(ev)),
                  "median_host_enqueue_ms": float(np.median(host)), "peak_mib": peak[p]}
        print("  %s, %s: ms per step %s, median %.3f; host enqueue median %.3f; peak %.0f MiB"
              % (label, p, [round(t, 2) for t in ev], np.median(ev), np.median(host), peak[p]),
              flush=True)
    return out, functools.partial(run, "kernels")


def cls_bn_train_shapes(net, arch, b=None, hw=None):
    """Every train-mode BN's NHWC shape in a step of `arch` at batch b and
    hw px, in network order: cls_bn_count(net, arch) of them."""
    b, hw = b or CLS_TRAIN_BATCH, hw or CLS_TRAIN_HW
    a = net.arch_to_device(arch)
    s = hw // 2
    shapes = [(b, s, s, a["first_w"])] * 2 + [(b, s, s, a["fb_out"])]
    bi = 0
    for si, sp in enumerate(net.stage_specs):
        for i in range(sp.n_block):
            if i == 0 or i < a["depth"][si]:
                mid = a["mid"][bi]
                shapes.append((b, s, s, mid))
                s = -(-s // (sp.stride if i == 0 else 1))
                shapes += [(b, s, s, mid), (b, s, s, a["out_ch"][bi])]
            bi += 1
    return shapes + [(b, s, s, net.final_expand_width or a["fm_w"])]


def cls_bn_shapes(net):
    """The step's BN shapes at its extremes (max_arch): the most rows at the
    fewest and at the most channels (the first conv's, the first stage's
    expand at 112x112), and the most channels (at 7x7)."""
    shapes = cls_bn_train_shapes(net, net.max_arch())
    rows = lambda s: s[0] * s[1] * s[2]  # noqa: E731
    most = max(rows(s) for s in shapes)
    wide = max(shapes, key=lambda s: (s[3], -rows(s)))
    at_most = [s for s in shapes if rows(s) == most]
    return sorted({min(at_most, key=lambda s: s[3]), max(at_most, key=lambda s: s[3]), wide},
                  key=lambda s: (-rows(s), s[3]))


def cls_bn_numbers(g, net, dtype):
    """The BN kernels at the step's extreme shapes: bn_forward and
    bn_backward against their plain versions (MOMENT_TOL, TOL; bf16 dx
    BF16_DX_TOL) and, for float32, the moments, running statistics and dx
    of each against a float64 computation (reported); ms per launch back to
    back beside the plain version, F.batch_norm in train mode /
    native_batch_norm_backward on the channels-last NCHW view, and the
    bound (bytes, as in phase 6)."""
    bf16 = dtype is BF16
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    rows = []
    for shp in cls_bn_shapes(net):
        n, c = int(np.prod(shp[:3])), shp[3]
        x = (1.5 * randn(g, *shp) + 0.3).to(dtype).contiguous()
        scale, bias = (0.5 + torch.rand(c, generator=g)).to(DEVICE), randn(g, c, scale=0.2)
        rm0, rv0 = randn(g, c, scale=0.2), (0.5 + torch.rand(c, generator=g)).to(DEVICE)
        kw = dict(momentum=0.1, eps=BN_EPS, update_var="unbiased")
        tag = "cls %s %s" % ("bf16" if bf16 else "f32", shp)
        rmk, rvk, rmp, rvp = rm0.clone(), rv0.clone(), rm0.clone(), rv0.clone()
        yk, mk, vk, ik = launched(bn_forward, lambda: bn_forward(x, scale, bias, rmk, rvk, **kw),
                                  bf16)
        yp, mp, vp, ip = bn_forward_reference(x, scale, bias, rmp, rvp, **kw)
        torch.cuda.synchronize()
        errs = {"mean": check_close("bn_forward %s mean" % tag, mk, mp, MOMENT_TOL),
                "var": check_close("bn_forward %s var" % tag, vk, vp, MOMENT_TOL),
                "y": check_close("bn_forward %s y" % tag, yk.float(), yp.float(),
                                 BF16_DX_TOL if bf16 else TOL),
                "running_var": check_close("bn_forward %s running_var" % tag, rvk, rvp,
                                           MOMENT_TOL)}
        dy = randn(g, *shp).to(dtype)
        dxk, dsk, dbk = launched(bn_backward, lambda: bn_backward(dy, x, scale, mk, ik), bf16)
        dxp, dsp, dbp = bn_backward_reference(dy, x, scale, mk, ik)
        torch.cuda.synchronize()
        errs["dx"] = check_close("bn_backward %s dx" % tag, dxk.float(), dxp.float(),
                                 BF16_DX_TOL if bf16 else TOL)
        dyf, xf = dy.view(n, c).float(), x.view(n, c).float()
        check_sums("bn_backward %s dscale" % tag, dsk, dsp, dyf * ((xf - mk) * ik))
        check_sums("bn_backward %s dbias" % tag, dbk, dbp, dyf)
        f64 = None
        if not bf16:  # float64 sums of the same inputs
            x64, dy64 = xf.double(), dyf.double()
            m64 = x64.mean(0)
            v64 = (x64 * x64).mean(0) - m64 * m64
            i64 = torch.rsqrt(v64 + BN_EPS)
            rv64 = 0.9 * rv0.double() + 0.1 * v64 * n / (n - 1)
            xh = (x64 - m64) * i64
            dx64 = (scale.double() * i64 * (dy64 - dy64.mean(0) - xh * (dy64 * xh).mean(0)))
            # the backward at the kernel's own (mean, inv) against float64 at those
            xh_k = (x64 - mk.double()) * ik.double()
            dx64_k = (scale.double() * ik.double() * (dy64 - dy64.mean(0)
                                                        - xh_k * (dy64 * xh_k).mean(0)))
            f64 = {}
            for part, kt, pt, rt in (("mean", mk, mp, m64), ("var", vk, vp, v64),
                                     ("running_var", rvk, rvp, rv64),
                                     ("dx", dxk.view(n, c), dxp.view(n, c), dx64_k)):
                f64[part] = {"kernel": float((kt.double() - rt).abs().max()),
                             "plain": float((pt.double() - rt).abs().max())}
            f64["dx_vs_exact_moments"] = float((dxk.view(n, c).double() - dx64).abs().max())
            print("  %s against float64: %s" % (tag, {k: v for k, v in f64.items()}), flush=True)
        lib_rm, lib_rv = rm0.clone(), rv0.clone()

        def fwd_library():
            return torch.nn.functional.batch_norm(nchw(x), lib_rm, lib_rv, scale, bias,
                                                  training=True, momentum=0.1, eps=BN_EPS)

        def bwd_library():
            return torch.ops.aten.native_batch_norm_backward(
                nchw(dy), nchw(x), scale, None, None, mk, ik, True, BN_EPS, [True, True, True])

        try:
            fwd_library()
        except RuntimeError:  # a yardstick only: the port never calls it
            fwd_library = None
        try:
            bwd_library()
        except RuntimeError:
            bwd_library = None
        rows.append({"shape": list(shp), "dtype": "bf16" if bf16 else "f32", "errors": errs,
                     "vs_float64": f64,
                     "bn_forward": measure_shape(
                         lambda: bn_forward(x, scale, bias, rmk, rvk, **kw),
                         lambda: bn_forward_reference(x, scale, bias, rmp, rvp, **kw),
                         flops=6 * n * c, nbytes_=2 * nbytes(x) + 9 * c * 4, launches=1,
                         unit="call", library=fwd_library),
                     "bn_backward": measure_shape(
                         lambda: bn_backward(dy, x, scale, mk, ik),
                         lambda: bn_backward_reference(dy, x, scale, mk, ik),
                         flops=11 * n * c, nbytes_=3 * nbytes(dy) + 5 * c * 4, launches=1,
                         unit="call", library=bwd_library)})
        for k in ("bn_forward", "bn_backward"):
            r = rows[-1][k]
            r.pop("_t")
            print("  %s %s: %.4f ms a launch, plain %.4f, library %s, bound %.4f"
                  % (k, tag, r["ms_per_launch"], r["plain_ms_per_launch"],
                     "%.4f" % r["library_ms_per_launch"] if r["library_ms_per_launch"]
                     else "refused", r["bound_ms_per_launch"]), flush=True)
    return rows


def cls_trainer_phase(g, dev):
    """(a) Both families at the published widths, 1000 classes, seeded
    weights and random BN, batch 64 at 224 px."""
    gb = torch.Generator().manual_seed(40)
    batch = {"image": torch.rand(CLS_TRAIN_BATCH, CLS_TRAIN_HW, CLS_TRAIN_HW, 3,
                                 generator=gb).to(dev),
             "label": torch.randint(0, 1000, (CLS_TRAIN_BATCH,), generator=gb).to(dev)}
    out, profiles, launches = {}, [], {}
    for fam, make in CLS_FAMILIES:
        net = cls_train_net(make, dev, 41)
        teacher_net = cls_train_net(make, dev, 43, ks_list=[7], expand_list=[6], depth_list=[4])
        teacher = (teacher_net, teacher_net.max_arch())
        w0 = {k: v.clone() for k, v in net.state_dict().items()}
        rec = {"bn_shapes": {}}
        for a in (net.max_arch(), net.sample_arch(seed=1)):
            if len(cls_bn_train_shapes(net, a)) != cls_bn_count(net, a):
                fail("%s: the BN shape list disagrees with the BN count" % fam)
        for env, archs in cls_envelopes(net).items():
            for dtype, dname in CLS_DTYPES:
                label = "%s %s %s" % (fam, env, dname)
                r = cls_step_checks(label, net, w0, batch, archs, env, teacher, dtype)
                for k, v in r["launches"].items():
                    launches[k] = launches.get(k, 0) + v
                net.load_state_dict(w0)
                r["times"], run = cls_step_times(label, net, batch, archs, env, teacher, dtype)
                if env == "1 subnet" and dtype is None:
                    profiles.append(("cls %s 1 subnet kernels" % fam, run, 1,
                                     r["times"]["kernels"]["median_ms"]))
                rec[env + " " + dname] = r
        net.load_state_dict(w0)
        for dtype, dname in CLS_DTYPES:
            rec["bn_shapes"][dname] = cls_bn_numbers(g, net, dtype or torch.float32)
        out[fam] = rec
        del net, teacher_net, teacher, w0
        torch.cuda.empty_cache()
    return out, profiles, launches


def cls_run_expect(net, epochs, n_batch, n_subnets, constraints=None):
    """bn_forward (= bn_backward) launches of training epochs `epochs` of
    n_batch steps: one per executed BN of each sampled subnet."""
    return sum(cls_bn_count(net, net.sample_arch(seed=subnet_seed(e, n_batch, i, k),
                                                 **(constraints or {})))
               for e in epochs for i in range(n_batch) for k in range(n_subnets))


def check_cls_cli(label, counts, fwd, bwd):
    """A float32 run's launches: bn_forward `fwd` and bn_backward `bwd`
    times, no other kernel."""
    got = {k: v for k, v in counts.items() if v}
    print("  %s: launches %s (expected bn_forward %d, bn_backward %d)" % (label, got, fwd, bwd),
          flush=True)
    if counts["bn_forward"] != fwd or counts["bn_backward"] != bwd or \
            sum(counts.values()) != fwd + bwd:
        fail("%s: expected bn_forward %d and bn_backward %d launches and no other, got %s"
             % (label, fwd, bwd, got))


def check_run_files(label, path, best):
    for f in ("checkpoint/checkpoint.pth.tar", "checkpoint/latest.txt",
              "checkpoint/model_best.pth.tar", "logs/train_console.txt",
              "logs/valid_console.txt"):
        if not os.path.isfile(os.path.join(path, f)):
            fail("%s wrote no %s" % (label, f))
    if not np.isfinite(best):
        fail("%s returned %r" % (label, best))
    with open(os.path.join(path, "logs", "valid_console.txt")) as f:
        losses = [float(line.split("train loss ")[1].split()[0]) for line in f
                  if "train loss" in line]
    if not losses or not all(np.isfinite(losses)):
        fail("%s: train losses %s" % (label, losses))
    return losses


def cls_cli_phase(tmp):
    """(b) The CIFAR chain and the ImageNet chain through the CLIs,
    --synthetic, on the card, every run counted."""
    out = {}
    teacher = os.path.join(tmp, "cifar_teacher")
    # CPU nets for their archs and BN counts (the draws do not depend on the device)
    cifar_net = OFAMobileNetV3(n_classes=10, ks_list=[7], expand_list=[6], depth_list=[4],
                               device="cpu")
    per_step = cls_bn_count(cifar_net, cifar_net.max_arch())
    tb = train_teacher_net_cifar10_simple.build_args([]).base_batch_size
    for label, n_epochs, epochs in (("teacher 1 epoch", "1", 1), ("teacher resumed", "2", 1)):
        best, counts, wall = counted_cli(train_teacher_net_cifar10_simple.main, [
            "--synthetic", "--path", teacher, "--n_epochs", n_epochs, "--warmup_epochs", "0"])
        steps = epochs * 2  # the synthetic provider: 2 batches an epoch
        check_cls_cli("cifar " + label, counts, steps * per_step, steps * per_step)
        out[label] = {"best": best, "launches": counts, "wall_s": wall,
                      "losses": check_run_files(label, teacher, best), "batch": tb}
    with open(os.path.join(teacher, "logs", "valid_console.txt")) as f:
        if "Epoch 2:" not in f.read():
            fail("the teacher CLI did not resume at epoch 2")
    ofa = os.path.join(tmp, "cifar_ofa")
    best, counts, wall = counted_cli(train_ofa_net_cifar10_simple.main, [
        "--synthetic", "--path", ofa, "--n_epochs", "1", "--warmup_epochs", "0",
        "--kd_ratio", "1.0", "--teacher_ckpt", os.path.join(teacher, "checkpoint")])
    check_cls_cli("cifar ofa + KD", counts, 2 * per_step, 2 * per_step)
    out["cifar ofa + KD"] = {"best": best, "launches": counts, "wall_s": wall,
                             "losses": check_run_files("cifar ofa", ofa, best)}
    # the ImageNet chain
    kernel, depth = os.path.join(tmp, "kernel"), os.path.join(tmp, "depth")
    for label, argv, path, preset in (
            ("train_ofa_net kernel", ["--task", "kernel", "--n_epochs", "1"], kernel,
             train_ofa_net.TASK_PHASES[("kernel", 1)]),
            ("train_ofa_net depth 1", ["--task", "depth", "--phase", "1", "--n_epochs", "1",
                                       "--warmstart", os.path.join(kernel, "checkpoint")],
             depth, train_ofa_net.TASK_PHASES[("depth", 1)])):
        best, counts, wall = counted_cli(train_ofa_net.main,
                                         ["--synthetic", "--path", path] + argv)
        net = OFAMobileNetV3(ks_list=preset["ks_list"], expand_list=preset["expand_list"],
                             depth_list=preset["depth_list"], device="cpu")
        expect = cls_run_expect(net, range(1 + preset["warmup_epochs"]), 4,
                                preset["dynamic_batch_size"])
        check_cls_cli(label, counts, expect, expect)
        out[label] = {"best": best, "launches": counts, "wall_s": wall,
                      "losses": check_run_files(label, path, best)}
    # the evaluators from the depth run's checkpoint
    ckpt = os.path.join(depth, "checkpoint")
    full = OFAMobileNetV3(device="cpu")
    arch = full.sample_arch(seed=0)
    recal = 2 * cls_bn_count(full, arch)  # 64 calibration images in batches of 32
    art = os.path.join(tmp, "eval.pt2")
    for label, extra in (("eval_ofa_net", []), ("eval_ofa_net --materialize", ["--materialize"]),
                         ("eval_ofa_net --export", ["--export", art])):
        top1, counts, wall = counted_cli(eval_ofa_net.main, [
            "--synthetic", "--path", os.path.join(tmp, "eval"), "--checkpoint", ckpt] + extra)
        check_cls_cli(label, counts, recal, 0)
        if not np.isfinite(top1):
            fail("%s returned %r" % (label, top1))
        out[label] = {"top1": top1, "launches": counts, "wall_s": wall}
    # the artifact against the recalibrated materialized subnet, rebuilt
    net = ofa_net(checkpoint=ckpt, device=DEVICE)
    rm = ClsRunManager(os.path.join(tmp, "recal"), net, RunConfig(), SyntheticClsProvider(
        n_train=64, n_test=32, image_size=CLS_EVAL_HW, n_classes=1000, train_batch_size=32,
        test_batch_size=32))
    rm.reset_running_statistics(arch, n_images=64, batch_size=32)
    x = torch.rand(1, CLS_EVAL_HW, CLS_EVAL_HW, 3, generator=torch.Generator().manual_seed(44))
    with torch.inference_mode():
        x = x.to(DEVICE)
        out["export_max_abs_err"] = check_close(
            "eval_ofa_net --export: artifact vs the materialized subnet",
            load_subnet(art, device=DEVICE)(x), get_active_cls_subnet(net, arch)(x), EXPORT_TOL)
    del net, rm
    cfg = os.path.join(tmp, "arch.json")
    with open(cfg, "w") as f:
        json.dump({"ks": list(arch.ks), "e": [6] * len(arch.e), "d": list(arch.d)}, f)
    top1, counts, wall = counted_cli(eval_specialized_net.main, [
        "--synthetic", "--supernet_checkpoint", ckpt, "--arch_config", cfg])
    check_cls_cli("eval_specialized_net", counts, 0, 0)
    out["eval_specialized_net"] = {"top1": top1, "launches": counts, "wall_s": wall}
    return out


def write_cifar(root, g):
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for name in ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": torch.randint(0, 256, (CIFAR_PER_BATCH_FILE, 3072), generator=g,
                                    dtype=torch.uint8).numpy(),
             b"labels": torch.randint(0, 10, (CIFAR_PER_BATCH_FILE,), generator=g).tolist()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)
    return root


def write_folder(root, g):
    """<root>/{train,val}/<class>/*.png, seeded images of 200-320 px sides."""
    from PIL import Image
    for split, n in (("train", FOLDER_TRAIN_PER_CLASS), ("val", 2)):
        for c in range(FOLDER_CLASSES):
            d = os.path.join(root, split, "n%02d" % c)
            os.makedirs(d)
            for i in range(n):
                h, w = (int(v) for v in torch.randint(200, 321, (2,), generator=g))
                Image.fromarray(torch.randint(0, 256, (h, w, 3), generator=g,
                                              dtype=torch.uint8).numpy()).save(
                    os.path.join(d, "%d.png" % i))
    return root


def real_data_phase(tmp):
    """(c) Cifar10Provider on a seeded pickle directory and ImagenetProvider
    with ElasticResolution on a seeded PNG tree, one epoch each through
    ClsRunManager, every BN launch counted; the folder epoch draws all four
    sizes."""
    g = torch.Generator().manual_seed(45)
    out = {}
    elastic = ElasticResolution(list(ELASTIC_SIZES))
    n_batch = FOLDER_TRAIN_PER_CLASS * FOLDER_CLASSES // FOLDER_BATCH
    drawn = [elastic.sample(b, 0) for b in range(n_batch)]
    if set(drawn) != set(ELASTIC_SIZES):
        fail("the folder epoch's draws %s miss a size of %s" % (drawn, ELASTIC_SIZES))
    for label, provider, n_classes in (
            ("cifar10", lambda: Cifar10Provider(root=write_cifar(os.path.join(tmp, "cifar"), g),
                                                train_batch_size=CIFAR_BATCH,
                                                test_batch_size=CIFAR_BATCH), 10),
            ("imagenet folder", lambda: ImagenetProvider(
                root=write_folder(os.path.join(tmp, "folder"), g), image_size=max(ELASTIC_SIZES),
                train_batch_size=FOLDER_BATCH, test_batch_size=FOLDER_BATCH,
                elastic=elastic), 1000)):
        prov = provider()
        net = OFAMobileNetV3(n_classes=n_classes, ks_list=[3, 5, 7], expand_list=[6],
                             depth_list=[4], device=DEVICE,
                             generator=torch.Generator().manual_seed(46))
        rm = ClsRunManager(os.path.join(tmp, label.replace(" ", "_")), net,
                           RunConfig(n_epochs=1, base_lr=0.01, opt_type="sgd",
                                     train_batch_size=prov.train.batch_size), prov)
        steps = len(prov.train)
        seen = []
        real = rm.trainer.train_step

        def step(batch, archs, lr, real=real, seen=seen):
            seen.append(int(batch["image"].shape[1]))
            return real(batch, archs, lr)

        rm.trainer.train_step = step
        zero_kernel_counts()
        t0 = time.perf_counter()
        loss, top1 = rm.train_one_epoch(0)
        val = rm.validate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        expect = steps * cls_bn_count(net, net.max_arch())
        check_cls_cli(label, counts, expect, expect)
        if not all(np.isfinite([loss, top1] + list(val))):
            fail("%s: non-finite epoch metrics %s %s" % (label, (loss, top1), val))
        if label != "cifar10" and sorted(set(seen)) != list(ELASTIC_SIZES):
            fail("the folder epoch ran sizes %s, not %s" % (seen, ELASTIC_SIZES))
        print("  %s: %d steps at sizes %s, loss %.4f, valid %s, %.1f s"
              % (label, steps, seen, loss, [round(v, 3) for v in val], wall), flush=True)
        out[label] = {"steps": steps, "sizes": seen, "loss": loss, "valid": val,
                      "launches": counts, "wall_s": wall}
        del net, rm
    return out


def phase11(g, dev):
    t0 = time.perf_counter()
    out = {}
    out["trainer"], profiles, launches = cls_trainer_phase(g, dev)
    with tempfile.TemporaryDirectory(prefix="ofa_sr_p11_") as tmp:
        out["clis"] = cls_cli_phase(tmp)
        out["real_data"] = real_data_phase(tmp)
    out["trainer_launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    print("  phase 11 took %.1f s" % out["wall_s"], flush=True)
    return out, profiles


# -- phase 12: the SR curriculum and the search-and-deploy demo ---------------

# the curriculum at the script's small defaults (32 training images of 64 px,
# 32 px crops, batch 4, the teacher 12 epochs, 4 epochs a phase), 'sharp'
# images and 4 epochs of max-net pretraining; then the demo on its expand
# checkpoint, searching by decoder MACs
CURRICULUM_ARGS = ["--style", "sharp", "--pretrain_epochs", "4"]
DEMO_ARGS = ["--quality", "macs"]


class CurriculumRuns:
    """While active, each CLI run of the curriculum is recorded: its task,
    its wall seconds, every kernel's launches in it (read before and after
    the run) and the
    subnets of each training step it took (`SRTrainer.train_step`'s), with
    whether BN was frozen."""

    def __init__(self):
        self.runs = []

    def __enter__(self):
        self.real = {m: m.main for m in (train_teacher_net_sr_simple, train_ofa_net_sr_simple)}
        self.real_step = real_step = SRTrainer.train_step
        steps = self.steps = []

        def step(trainer, batch, cfgs, lr):
            steps.append((list(cfgs), trainer.bn_frozen))
            return real_step(trainer, batch, cfgs, lr)

        def wrap(module, real):
            def main(argv):
                before, n0 = kernel_counts(), len(steps)
                t0 = time.perf_counter()
                out = real(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                after = kernel_counts()
                task = argv[argv.index("--task") + 1] if "--task" in argv else "teacher"
                self.runs.append({"task": task, "best": out, "wall_s": wall,
                                  "launches": {k: after[k] - before[k] for k in after},
                                  "steps": steps[n0:]})
                return out
            return main

        for m, real in self.real.items():
            m.main = wrap(m, real)
        SRTrainer.train_step = step
        return self

    def __exit__(self, *exc):
        for m, real in self.real.items():
            m.main = real
        SRTrainer.train_step = self.real_step


def curriculum_steps(tmp):
    """One SGD step of the expand space's X4 on a curriculum batch (batch
    CURRICULUM_BS of each of CURRICULUM_CROPS from a generated 'sharp'
    tree), over an expand-phase subnet as the curriculum trains it
    (`reference_quirk_arch_x4`), kernels against the plain path from the
    same weights: the loss, every parameter and every running statistic
    after the step at STEP_TOL (SGD at the curriculum's max-net learning
    rate, its --pretrain_lr, so an update is that multiple of the
    gradient); the kernel step's BN launches counted, the plain step's
    none."""
    root = os.path.join(tmp, "step_data")
    curriculum.gen_tree(root, n_train=2 * CURRICULUM_BS, n_val=1, size=64,
                        seed=curriculum.SEED, style="sharp")
    space = search_deploy_demo.expand_space()
    lr = curriculum.build_parser().get_default("pretrain_lr")
    out = {}
    for crop in CURRICULUM_CROPS:
        provider = Div2KSetXXProvider(root=root, image_size=crop,
                                      train_batch_size=CURRICULUM_BS)
        batch = {k: torch.as_tensor(np.asarray(v)).to(DEVICE)
                 for k, v in next(iter(provider.train)).items() if k in ("image", "x2", "x4")}
        cfg = reference_quirk_arch_x4(sample_subnet(space, seed=crop, n_trunks=2))
        runs = {}
        for uk in (True, False):
            net = OFAMobileNetX4(space, device=DEVICE,
                                 generator=torch.Generator().manual_seed(crop))
            tr = SRTrainer(net, opt_type="sgd", weight_decay=3e-5, use_kernels=uk)
            zero_bn_counts()
            loss = float(tr.train_step(batch, [cfg], lr)["loss"])
            torch.cuda.synchronize()
            runs[uk] = (loss, {k: v.detach().clone() for k, v in net.state_dict().items()
                               if v.is_floating_point()}, bn_counts())
        expect = x4_bn_launches_expected([cfg], "sr")
        label = "curriculum step, bs %d at %d px, lr %g, %s" % (CURRICULUM_BS, crop, lr,
                                                                 cfg.describe())
        wrong = bn_launches_wrong(runs[True][2], expect, False)
        if wrong or any(runs[False][2].values()):
            fail("%s: kernel path %s; plain path launched %s" % (label, wrong, runs[False][2]))
        check_close("%s: loss, kernels vs plain" % label, torch.tensor([runs[True][0]]),
                    torch.tensor([runs[False][0]]), STEP_TOL)
        pk, pp = runs[True][1], runs[False][1]
        for n in pk:
            if not bool(torch.isclose(pk[n], pp[n], **STEP_TOL).all()):
                check_close("%s: %s after the step" % (label, n), pk[n], pp[n], STEP_TOL)
        err = {kind: max(float((pk[n] - pp[n]).abs().max()) for n in pk
                         if ("running" in n) == (kind == "running stats"))
               for kind in ("params", "running stats")}
        print("  %s: loss %.6f; BN launches %d each (expected %d); after the step, kernels vs "
              "plain: params max_abs_err %.3e, running stats %.3e  ok"
              % (label, runs[True][0], runs[True][2]["bn_forward"], expect, err["params"],
                 err["running stats"]), flush=True)
        out[crop] = {"cfg": cfg.describe(), "loss": runs[True][0], "plain_loss": runs[False][0],
                     "bn_launches": expect, "max_abs_err": err}
    return out


def curriculum_run(tmp):
    """The curriculum through the port's CLIs, every phase's BN-kernel
    launches held to its executed train-mode BNs (the frozen-BN teacher's
    to 0), nothing else launched; then its rerun from the report, which
    trains and launches nothing and reports the same numbers."""
    out_dir = os.path.join(tmp, "curriculum")
    argv = ["--out", out_dir, "--device", DEVICE] + CURRICULUM_ARGS
    zero_kernel_counts()
    t0 = time.perf_counter()
    with CurriculumRuns() as runs:
        rep = curriculum.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = kernel_counts()
    phases = {}
    for run in runs.runs:
        frozen = {f for _, f in run["steps"]}
        cfgs = [c for cs, _ in run["steps"] for c in cs]
        expect = 0 if frozen == {True} else x4_bn_launches_expected(cfgs, "sr")
        got = run["launches"]
        print("  %-20s %4d steps, %4d subnets, %.1f s, BN %s: bn_forward %d, bn_backward %d "
              "launches (expected %d each)" % (
                  run["task"], len(run["steps"]), len(cfgs), run["wall_s"],
                  "frozen" if frozen == {True} else "train", got["bn_forward"],
                  got["bn_backward"], expect), flush=True)
        if run["task"] == "teacher" and frozen != {True}:
            fail("the curriculum's teacher trained with BN in train mode")
        if run["task"] != "teacher" and frozen != {False}:
            fail("the curriculum's %s phase trained with BN frozen" % run["task"])
        if bn_launches_wrong(got, expect, False) or any(
                v for k, v in got.items() if k not in ("bn_forward", "bn_backward")):
            fail("the curriculum's %s phase launched %s, expected bn_forward and bn_backward "
                 "%d times each and nothing else" % (run["task"], got, expect))
        phases[run["task"]] = {"steps": len(run["steps"]), "subnets": len(cfgs),
                               "wall_s": run["wall_s"], "launches": got, "expected": expect}
    tasks = ["teacher", "pretrain"] + [t for t, _ in curriculum.phase_table(
        curriculum.build_parser().parse_args(argv))]
    if list(phases) != tasks:
        fail("the curriculum ran %s, not %s" % (list(phases), tasks))
    # the grid evaluations and the bicubic floor (outside the CLI runs)
    # launched nothing
    if any(total[k] != sum(p["launches"][k] for p in phases.values()) for k in total):
        fail("the curriculum launched kernels outside its CLI runs: %s" % total)
    for task, corners in rep["port"].items():
        if not corners or not all(np.isfinite(v) for v in corners.values()):
            fail("the curriculum's %s phase scored %s" % (task, corners))
        if not os.path.isfile(os.path.join(out_dir, "port", task, "PHASE_DONE.json")):
            fail("the curriculum's %s phase wrote no PHASE_DONE.json" % task)
    h = rep["headline"]
    print("  curriculum: %.1f s; bicubic x2 %.3f, x4 %.3f; teacher %.3f (margin %+.3f dB); "
          "best x4 corner %s of %s %.3f (margin %+.3f dB)"
          % (wall, h["bicubic_x2"], h["bicubic_x4"], h["teacher_psnr_x2"],
             h["teacher_margin_db"], h["best_corner"], h["best_corner_phase"],
             h["best_corner_psnr_x4"], h["corner_margin_db"]), flush=True)
    zero_kernel_counts()
    t0 = time.perf_counter()
    with CurriculumRuns() as reruns:
        again = curriculum.main(argv + ["--resume_report",
                                        os.path.join(out_dir, "report.json")])
    torch.cuda.synchronize()
    rerun_wall = time.perf_counter() - t0
    rerun = kernel_counts()
    print("  rerun from the report: %.1f s, %d CLI runs, launches %s" % (
        rerun_wall, len(reruns.runs), {k: v for k, v in rerun.items() if v}), flush=True)
    if reruns.runs or any(rerun.values()) or again["port"] != rep["port"]:
        fail("the curriculum's rerun from its report trained, launched or scored otherwise")
    return out_dir, {"wall_s": wall, "report": rep, "phases": phases, "launches": total,
                     "rerun": {"wall_s": rerun_wall, "launches": rerun}}


def demo_run(out_dir):
    """The search-and-deploy demo on the curriculum's expand checkpoint,
    counted: every timed call's MBConv launches (one a block entry's call,
    sum(d) of the decoder a whole subnet's), bn_forward once per train-mode
    BN of the three deployments' recalibration, nothing else; then the
    winner's kernel frame against its plain frame."""
    zero_kernel_counts()
    t0 = time.perf_counter()
    with TimedCalls(whole={}) as timed:
        rep = search_deploy_demo.main(["--curriculum", out_dir, "--device", DEVICE] + DEMO_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    space = search_deploy_demo.expand_space()
    ns = space.n_stages
    winner = SubnetConfig.from_dict(rep["winner"])
    deployed = [uniform_subnet(space, 3, 3, 2, 2, n_trunks=2),
                uniform_subnet(space, 7, 6, 4, 2, n_trunks=2), winner]
    n_blocks = len(space.ks_list) * len(space.expand_list)
    per_call = [1] * n_blocks + [sum(c.d[ns:]) for c in deployed[:1] + deployed]
    if len(timed.records) != len(per_call):
        fail("the demo timed %d calls, expected %d" % (len(timed.records), len(per_call)))
    for rec, n in zip(timed.records, per_call):
        hold_timed_launches("demo timed call %s" % rec["shape"], rec,
                            {"mbconv": n, "shuffle_tail": 0})
    n_batches = len(Div2KSetXXProvider(root=os.path.join(out_dir, "data"), image_size=32,
                                       train_batch_size=4).train)
    expect = n_batches * x4_bn_launches_expected(deployed, "sr")
    if counts["mbconv"] != sum(r["mbconv"] for r in timed.records) or \
            counts["bn_forward"] != expect or any(
                v for k, v in counts.items() if k not in ("bn_forward", "mbconv")):
        fail("the demo launched %s; expected MBConv only in its timed calls and bn_forward %d "
             "times (%d batches of recalibration over 3 subnets), nothing else"
             % (counts, expect, n_batches))
    cands = rep["candidates"]
    if not cands["searched"]["lut_ms"] <= rep["constraint_ms"] or not all(
            np.isfinite(c["psnr_db"]) and c["true_ms"] > 0 for c in cands.values()):
        fail("the demo's deployments: %s (constraint %.4f ms)" % (cands, rep["constraint_ms"]))
    for name, c in cands.items():
        print("  %-12s table %.4f ms, measured %.4f, decoder %.4f GMAC, PSNR-Y %.4f dB after "
              "recalibration" % (name, c["lut_ms"], c["true_ms"], c["dec_gmacs"], c["psnr_db"]),
              flush=True)
    print("  demo: %.1f s; winner %s under %.4f ms; launches %s (bn_forward expected %d)"
          % (wall, winner.describe(), rep["constraint_ms"], counts, expect), flush=True)
    net = OFAMobileNetX4(space, device=DEVICE)
    load_weights_lenient(os.path.join(out_dir, "port", "expand", "checkpoint"), net)
    lr = rep["hr"] // 4
    x = torch.from_numpy(np.random.RandomState(5).rand(1, lr, lr, 3).astype(np.float32)).to(
        DEVICE)
    with torch.inference_mode():
        y = get_active_subnet(net, winner)(x)
        err = check_close("demo winner frame: kernels vs plain path", y,
                          get_active_subnet(net, winner, use_kernels=False)(x), FRAME_TOL)
    return {"wall_s": wall, "report": rep, "launches": counts, "bn_forward_expected": expect,
            "recalib_batches": n_batches, "timed_calls": timed.records,
            "winner_frame_max_abs_err": err}


def phase12(dev):
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ofa_sr_p12_") as tmp:
        steps = curriculum_steps(tmp)
        out_dir, cur = curriculum_run(tmp)
        demo = demo_run(out_dir)
    out = {"steps": steps, "curriculum": cur, "demo": demo,
           "wall_s": time.perf_counter() - t0}
    print("  phase 12 took %.1f s" % out["wall_s"], flush=True)
    return out


# -- phase 13: multi-step dispatch, CUDA-graph replays of the masked step ----

SPD, SPD_KD = 16, 8          # steps a window: bench.py:201-215 (1 subnet), :261-272 (4 + KD)
BENCH_LR = 1e-4              # bench.py's Adam lr
# parity runs: SGD (Nesterov momentum 0.9, weight decay 3e-5), whose update
# is linear in the gradient; 16 of bench.py's Adam steps at 1e-4 move a
# weight by ~lr * g / (|g| + eps), so float32 noise in a gradient near 0
# moved the update of a whole tensor (the first conv) by 7% against a
# float64 step on an H100 (PERF.md), on either masked path alike
PARITY_OPT, PARITY_LR = "sgd", 0.01
X4_SPD, X4_SR_WINDOWS = 4, 4  # the X4: 4 windows of 4 sr steps, one of 4 autoencoder steps
GRAPH_ROUNDS = 1             # rounds of (sliced, graphed, graphed, sliced) step timing
RM_TRAIN = 64                # run manager: synthetic images, bs16: 4 steps an epoch


def bench_cfgs(space, n_steps, k, n_trunks=1):
    """bench.py's subnets (:199-200): the 8 of subnet_seed(0, 50, i, 0),
    step i's subnet j the ((i * k + j) % 8)-th (bench.py's cycling)."""
    eight = [sample_subnet(space, seed=subnet_seed(0, 50, i, 0), n_trunks=n_trunks)
             for i in range(8)]
    return [[eight[(i * k + j) % 8] for j in range(k)] for i in range(n_steps)]


def pass_keys(cfg_steps):
    """The distinct graph keys of the subnet passes: (depths, pixel_d)."""
    return {(tuple(c.d), c.pixel_d) for step in cfg_steps for c in step}


def graph_main_path(compute_dtype=None):
    """The graphed path through `entry.train(..., steps_per_dispatch=n)` at
    the bench's envelopes (16 one-subnet steps, one window; 8 steps of 4
    subnets with KD, one window), counted: each distinct pass launches
    bn_forward and bn_backward once per train-mode BN at its eager first run
    and once at its capture, its replays none, so 2 * (3*sum(d) + pixel_d +
    4) for each distinct (depths, pixel_d); nothing else. Then the
    one-subnet envelope with dw_switch on (the masked depthwise's main
    path): the same BN launches, and each direction of the masked depthwise
    once a block of each distinct pass at its eager first run and capture,
    2 * sum(d) for each distinct (depths, pixel_d); none without the
    lever. Then the same with expand_switch too (the masked 1x1's main
    path): each direction of the masked 1x1 twice a block (the expand and
    the project conv) of each distinct pass at its eager first run and
    capture, 4 * sum(d); none without that lever."""
    space = SearchSpace()
    bf16 = compute_dtype is BF16
    runs = {}
    for label, steps, kw in (("1 subnet", SPD, {}),
                             ("4 subnets + KD", SPD_KD, dict(n_subnets=4, kd_ratio=1.0)),
                             ("1 subnet, dw_switch", SPD, DW_LEVER),
                             ("1 subnet, " + PW_LABEL, SPD, PW_LEVER)):
        cfg_steps = [step_subnets(space, i, kw.get("n_subnets", 1)) for i in range(steps)]
        zero_bn_counts()
        zero_counts(DW_WRAPPERS + PW_WRAPPERS)
        metrics = train(steps, device=DEVICE, compute_dtype=compute_dtype,
                        steps_per_dispatch=steps, **kw)
        torch.cuda.synchronize()
        counts = bn_counts()
        dw, pw = counts_of(DW_WRAPPERS), counts_of(PW_WRAPPERS)
        keys = pass_keys(cfg_steps)
        expect = 2 * sum(3 * sum(d) + pd + 4 for d, pd in keys)
        # the masked depthwise: each direction once a block of each distinct
        # pass, at its eager first run and at its capture, with the lever;
        # the masked 1x1 twice a block with the expand lever
        blocks = sum(sum(d) for d, _ in keys)
        dw_expect = 2 * blocks if "dw_switch" in kw else 0
        pw_expect = 4 * blocks if "expand_switch" in kw else 0
        wrong = (counts_wrong(DW_WRAPPERS, "masked depthwise", dw, dw_expect, bf16)
                 or counts_wrong(PW_WRAPPERS, "masked 1x1", pw, pw_expect, bf16))
        if wrong:
            fail("the graphed %s training path (%s) %s" % ("bf16" if bf16 else "float32", label,
                                                           wrong))
        counts.update({k: v for k, v in dw.items() if v})
        counts.update({k: v for k, v in pw.items() if v})
        print("  entry.train(%d steps, %s%s, steps_per_dispatch=%d): BN-kernel launches %s "
              "(expected %d each: %d distinct passes, counted at their eager first run and "
              "capture), losses %s" % (steps, label, ", bf16" if bf16 else "", steps,
                                       counts, expect, len(keys),
                                       [round(m["loss"], 5) for m in metrics]), flush=True)
        wrong = bn_launches_wrong(counts, expect, bf16)
        if wrong:
            fail("the graphed %s training path %s" % ("bf16" if bf16 else "float32", wrong))
        if not all(np.isfinite(m["loss"]) and np.isfinite(m["psnr"]) for m in metrics):
            fail("non-finite graphed training metrics: %s" % metrics)
        runs[label] = {"steps": steps, "launches": counts, "expected": expect,
                       "expected_dw": dw_expect, "expected_pw": pw_expect,
                       "distinct_passes": len(keys), "metrics": metrics}
    return runs


def graph_net(kind="s4", seed=0, dtype=None):
    """A full-width seeded S4 or X4 on the card (the same weights on every
    call); in float64 for `dtype`."""
    net = (OFAMobileNetX4 if kind == "x4" else OFAMobileNetS4)(
        SearchSpace(), device=DEVICE, generator=torch.Generator().manual_seed(seed))
    return net.double() if dtype is torch.float64 else net


def window_run(path, cfg_steps, batch, *, kind="s4", mode="sr", n_subnets=1, kd=False,
               compute_dtype=None, spd=None, lever=None):
    """Run `cfg_steps` (PARITY_OPT at PARITY_LR, weight decay 3e-5) from
    the seeded weights on one path: "graphed" (make_scan_train_step's windows of
    `spd`, CUDA graphs), "eager masked" (the same windows with the cache's
    graphs off: every part run eagerly), "eager sliced" (train_step) or
    "float64" (train_step on the plain path in float64). `lever`: the
    trainer's levers (DW_LEVER, PW_LEVER) or None. Returns per-step losses,
    the parameters and running statistics after, the first weights, the
    graph cache's counts and the masked depthwise's and 1x1's launches."""
    dtype = torch.float64 if path == "float64" else None
    net = graph_net(kind, dtype=dtype)
    w0 = {k: p.detach().clone() for k, p in net.named_parameters()}
    s0 = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    teacher = None
    if kd:
        t_net, t_cfg, t_pd = kd_teacher(net.space, DEVICE)
        teacher = (t_net.double() if dtype else t_net, t_cfg, t_pd)
    tr = SRTrainer(net, opt_type=PARITY_OPT, weight_decay=3e-5, kd_ratio=1.0 if kd else 0.0,
                   teacher=teacher, compute_dtype=compute_dtype, mode=mode,
                   use_kernels=False if dtype else None, **(lever or {}))
    b = {k: v.to(torch.float64) for k, v in batch.items()} if dtype else batch
    zero_counts(DW_WRAPPERS + PW_WRAPPERS)
    losses, cache = [], None
    if path in ("graphed", "eager masked"):
        step = tr.make_scan_train_step(n_subnets)
        cache = step.cache
        if path == "eager masked":
            cache.cuda = False  # the same window code, each part run eagerly
        spd = spd or len(cfg_steps)
        for i in range(0, len(cfg_steps), spd):
            w = cfg_steps[i:i + spd]
            losses += step([b] * len(w), w, [PARITY_LR] * len(w))["losses"].tolist()
    else:
        losses = [float(tr.train_step(b, c, PARITY_LR)["loss"]) for c in cfg_steps]
    torch.cuda.synchronize()
    out = {"losses": torch.tensor(losses, dtype=torch.float64),
           "params": {k: p.detach().clone() for k, p in net.named_parameters()},
           "stats": {k: v.clone() for k, v in net.state_dict().items() if "running" in k},
           "w0": w0, "s0": s0, "dw_launches": counts_of(DW_WRAPPERS),
           "pw_launches": counts_of(PW_WRAPPERS)}
    if cache is not None:
        out["cache"] = {"captures": cache.captures, "replays": cache.replays,
                        "capture_s": cache.capture_s}
    del net, tr
    return out


def hold_to(label, got, ref, f64, bf16=False, beside_ref=False):
    """`got` against `ref` (window_run results): the per-step losses at
    STEP_TOL (bf16: BF16_STEP_TOL); in float32 each parameter tensor at
    STEP_TOL and each running statistic at CLS_STATE_TOL, and a tensor past
    its tolerance (float32 is ill-conditioned at full width, as phase 11
    finds; over a window the drift compounds) with its change over the
    window within CLS_UPDATE_RTOL of the float64 sliced steps' (relative L2;
    `f64()` runs them, once), `ref`'s measured beside it. `beside_ref`:
    where `ref` itself misses that bound, `got` may be as far from float64
    as `ref` is, plus CLS_UPDATE_RTOL (no less accurate than the path it is
    held to)."""
    out = {"loss": check_close("%s: per-step losses" % label, got["losses"], ref["losses"],
                               BF16_STEP_TOL if bf16 else STEP_TOL)}
    if bf16:
        return out
    past = {}
    for part, start, tol in (("params", "w0", STEP_TOL), ("stats", "s0", CLS_STATE_TOL)):
        out[part] = max(float((got[part][n] - ref[part][n]).abs().max()) for n in got[part])
        for n, t in got[part].items():
            if bool(torch.isclose(t, ref[part][n], **tol).all()):
                continue
            r64 = f64()[part][n]
            size = float((r64 - got[start][n].double()).norm())
            rel = {k: float((o[part][n].double() - r64).norm()) / max(size, 1e-30)
                   for k, o in (("got", got), ("ref", ref))}
            past[n] = rel
            bound = CLS_UPDATE_RTOL
            if beside_ref and rel["ref"] > CLS_UPDATE_RTOL:
                bound += rel["ref"]
            if not rel["got"] <= bound:
                fail("%s: %s's change over the window is %.3e of its size from the float64 "
                     "steps' (the reference path's %.3e; bound %.3e)"
                     % (label, n, rel["got"], rel["ref"], bound))
    out["past_tol"] = past
    worst = max([r["got"] for r in past.values()] or [0.0])
    print("  %s: params max_abs_err %.3e, running statistics %.3e; %d tensors past their "
          "tolerance, their change at most %.3e of the float64 steps' (bound %.0e)  ok"
          % (label, out["params"], out["stats"], len(past), worst, CLS_UPDATE_RTOL),
          flush=True)
    return out


def graph_parity():
    """The graphed windows against the same steps run eagerly in the masked
    form, and against the eager sliced steps (train_step), float32 (TF32
    off) and bf16: the S4 at bench.py's envelopes (16 one-subnet steps in
    one window; 8 steps of 4 subnets + KD in one window), the X4 in sr
    mode (4 windows of 4 steps) and in autoencoder mode (one window of 4);
    the S4's one-subnet window with dw_switch, and with expand_switch and
    dw_switch, against the eager sliced steps; float32 tensors past
    STEP_TOL held against a float64 sliced step."""
    space = SearchSpace()
    batch = synthetic_batch(BS, HR, DEVICE)
    cases = [("S4 1 subnet", dict(n_subnets=1), bench_cfgs(space, SPD, 1), SPD),
             ("S4 4 subnets + KD", dict(n_subnets=4, kd=True), bench_cfgs(space, SPD_KD, 4),
              SPD_KD),
             ("X4 sr", dict(kind="x4"), bench_cfgs(space, X4_SPD * X4_SR_WINDOWS, 1, 2), X4_SPD),
             ("X4 autoencoder", dict(kind="x4", mode="autoencoder"),
              bench_cfgs(space, X4_SPD, 1, 2), X4_SPD),
             ("S4 1 subnet dw_switch", dict(n_subnets=1, lever=DW_LEVER),
              bench_cfgs(space, SPD, 1), SPD),
             ("S4 1 subnet " + PW_LABEL, dict(n_subnets=1, lever=PW_LEVER),
              bench_cfgs(space, SPD, 1), SPD)]
    out = {}
    for label, kw, cfg_steps, spd in cases:
        for cd in (None, BF16):
            if cd is BF16 and label.startswith("X4"):
                continue  # the X4's bf16 step is held in phase 7; its graphs here in f32
            name = label + (" bf16" if cd else "")
            lever = kw.get("lever") is not None
            t0 = time.perf_counter()
            # with the lever: against the eager sliced steps (the levers
            # change nothing there), its captures against the lever-off run's
            paths = ("graphed", "eager sliced") if lever else ("graphed", "eager masked",
                                                                "eager sliced")
            runs = {p: window_run(p, cfg_steps, batch, compute_dtype=cd, spd=spd, **kw)
                    for p in paths}
            noise = None
            if cd is None and not lever:
                # the run-to-run noise of the float32 eager masked steps
                # (cuDNN's backward convolutions sum in no fixed order): the
                # floor under graphed against eager masked
                again = window_run("eager masked", cfg_steps, batch, spd=spd, **kw)
                noise = {"loss": float((again["losses"] - runs["eager masked"]["losses"])
                                       .abs().max()),
                         "params": max(float((again["params"][n] - t).abs().max())
                                       for n, t in runs["eager masked"]["params"].items())}
                print("  %s: eager masked run twice: losses %.3e, params %.3e apart"
                      % (name, noise["loss"], noise["params"]), flush=True)
                del again
            f64_box = []

            def f64(cfg_steps=cfg_steps, kw=kw):
                if not f64_box:
                    f64_box.append(window_run("float64", cfg_steps, batch, **kw))
                return f64_box[0]

            rec = {"steps": len(cfg_steps), "window": spd, "cache": runs["graphed"]["cache"],
                   "losses": runs["graphed"]["losses"].tolist()}
            for ref in paths[1:]:
                rec["vs " + ref] = hold_to("%s, graphed vs %s" % (name, ref), runs["graphed"],
                                           runs[ref], f64, bool(cd))
            rec.update(eager_masked_run_to_run=noise, float64_run=bool(f64_box),
                       wall_s=time.perf_counter() - t0)
            keys = len(pass_keys(cfg_steps)) + 1 + bool(kw.get("kd"))
            if rec["cache"]["captures"] != keys:
                fail("%s: %d captures, expected %d (the distinct passes, the update%s)"
                     % (name, rec["cache"]["captures"], keys, ", the teacher" if
                        kw.get("kd") else ""))
            # the masked depthwise: a launch a direction for each block of
            # each distinct pass at its eager first run and at its capture,
            # none at a replay, none without the lever (the masked 1x1: two,
            # with the expand lever); as many captures as the same window
            # without the levers
            blocks = sum(sum(d) for d, _ in pass_keys(cfg_steps))
            dw_expect = 2 * blocks if lever else 0
            pw_expect = 4 * blocks if "expand_switch" in (kw.get("lever") or {}) else 0
            for p in paths:
                on = p == "graphed"
                wrong = (counts_wrong(DW_WRAPPERS, "masked depthwise", runs[p]["dw_launches"],
                                      dw_expect if on else 0, bool(cd))
                         or counts_wrong(PW_WRAPPERS, "masked 1x1", runs[p]["pw_launches"],
                                         pw_expect if on else 0, bool(cd)))
                if wrong:
                    fail("%s, %s: %s" % (name, p, wrong))
            if lever:
                off = out[name.replace(" " + PW_LABEL, "").replace(" dw_switch", "")]
                if rec["cache"]["captures"] != off["cache"]["captures"]:
                    fail("%s: %d captures, %d without the levers" % (
                        name, rec["cache"]["captures"], off["cache"]["captures"]))
                launches = dict(runs["graphed"]["dw_launches"], **runs["graphed"]["pw_launches"])
                rec["lever_launches"] = {k: v for k, v in launches.items() if v}
                print("  %s: masked depthwise and 1x1 launches %s (expected %d and %d each: a "
                      "block of each distinct pass at its eager first run and capture, none at "
                      "replay); %d captures, as without the levers"
                      % (name, rec["lever_launches"], dw_expect, pw_expect,
                         rec["cache"]["captures"]), flush=True)
            print("  %s: %d steps in windows of %d, %d captures (%.2f s), %d replays; %.1f s"
                  % (name, len(cfg_steps), spd, rec["cache"]["captures"],
                     rec["cache"]["capture_s"], rec["cache"]["replays"], rec["wall_s"]),
                  flush=True)
            out[name] = rec
            del runs, f64_box
            release_graphs()
    return out


def replay_order_check():
    """Graphs sharing one pool, replayed out of their capture order: a
    window whose passes run keys A, B, A, B (each captured at its first
    use), and then B, A in a second window, against the same steps run
    eagerly, per-step losses at STEP_TOL."""
    space = SearchSpace()
    eight = bench_cfgs(space, 8, 1)
    a = eight[0]
    b = next(c for c in eight if pass_keys([c]) != pass_keys([a]))
    order = [a, b, a, b, b, a]
    batch = synthetic_batch(BS, HR, DEVICE)
    g = window_run("graphed", order, batch, spd=4)
    e = window_run("eager masked", order, batch, spd=4)
    check_close("A, B, A, B | B, A replays vs eager masked: per-step losses", g["losses"],
                e["losses"], STEP_TOL)
    return {"order": ["A", "B", "A", "B", "B", "A"], "losses": g["losses"].tolist()}


def graph_run_manager(tmp):
    """SRRunManager (bs16 96 px synthetic, PARITY_OPT at PARITY_LR) for
    one epoch of 4 steps at steps_per_dispatch 4 (one window) against the
    same epoch at 1: the epoch's loss (STEP_TOL) and the parameters (STEP_TOL; a tensor
    past it with its update within CLS_UPDATE_RTOL of the eager epoch's);
    the log lines; then its checkpoint resumed at steps_per_dispatch 1 for
    a second epoch, the optimizer state read in torch's layout."""
    out = {}
    for spd in (1, 4):
        net = graph_net()
        w0 = {k: p.detach().clone() for k, p in net.named_parameters()}
        rc = RunConfig(n_epochs=1, base_lr=PARITY_LR, opt_type=PARITY_OPT, image_size=HR,
                       print_frequency=2, steps_per_dispatch=spd, manual_seed=0)
        provider = SyntheticSRProvider(n_train=RM_TRAIN, n_valid=2, hr_size=HR,
                                       train_batch_size=BS)
        path = os.path.join(tmp, "rm%d" % spd)
        rm = SRRunManager(path, net, rc, provider)
        zero_bn_counts()
        t0 = time.perf_counter()
        loss, psnr = rm.train_one_epoch(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rm.save_model(epoch=0)
        with open(os.path.join(rm.logs_path, "train_console.txt")) as f:
            lines = [ln.split("\t")[0] for ln in f if ln.startswith("Train")]
        out[spd] = {"loss": loss, "psnr": psnr, "wall_s": wall, "log": lines,
                    "launches": {k: v for k, v in bn_counts().items() if v},
                    "params": {k: p.detach().clone() for k, p in net.named_parameters()},
                    "w0": w0, "path": path,
                    "opt_entries": len(rm.trainer.opt.state_dict()["state"])}
        del rm, net
    a, b = out[1], out[4]
    check_close("run manager epoch loss: steps_per_dispatch 4 vs 1", torch.tensor([b["loss"]]),
                torch.tensor([a["loss"]]), STEP_TOL)
    past = 0
    for n, p in b["params"].items():
        if bool(torch.isclose(p, a["params"][n], **STEP_TOL).all()):
            continue
        past += 1
        size = float((a["params"][n] - a["w0"][n]).norm())
        rel = float((p - a["params"][n]).norm()) / max(size, 1e-30)
        if not rel <= CLS_UPDATE_RTOL:
            fail("run manager: %s's update at steps_per_dispatch 4 is %.3e of its size from "
                 "the eager epoch's" % (n, rel))
    if a["log"] != ["Train [1][2/4]", "Train [1][4/4]"] or b["log"] != ["Train [1][4/4]"]:
        fail("run manager log lines: %s (1) and %s (4)" % (a["log"], b["log"]))
    net = graph_net()
    rc = RunConfig(n_epochs=2, base_lr=PARITY_LR, opt_type=PARITY_OPT, image_size=HR,
                   steps_per_dispatch=1, manual_seed=0)
    provider = SyntheticSRProvider(n_train=RM_TRAIN, n_valid=2, hr_size=HR, train_batch_size=BS)
    rm = SRRunManager(b["path"], net, rc, provider)
    rm.load_model()
    if rm.start_epoch != 1 or len(rm.trainer.opt.state_dict()["state"]) != b["opt_entries"]:
        fail("resume at steps_per_dispatch 1: start epoch %d, %d optimizer entries (saved %d)"
             % (rm.start_epoch, len(rm.trainer.opt.state_dict()["state"]), b["opt_entries"]))
    loss2, _ = rm.train_one_epoch(1)
    if not np.isfinite(loss2):
        fail("resumed epoch loss %r" % loss2)
    print("  run manager: epoch loss %.6f (1) / %.6f (4), %d tensors past STEP_TOL, logs %s / "
          "%s; resumed at 1: epoch 2 loss %.6f, %d optimizer entries  ok"
          % (a["loss"], b["loss"], past, a["log"], b["log"], loss2, b["opt_entries"]),
          flush=True)
    return {str(k): {kk: v[kk] for kk in ("loss", "psnr", "wall_s", "log", "launches")}
            for k, v in out.items()} | {"past_step_tol": past, "resumed_loss": loss2}


def graph_step_times():
    """ms a step (CUDA events) and host enqueue ms a step, eager sliced
    (train_step) against graphed (windows of make_scan_train_step), float32
    and bf16, one subnet (windows of 16), in GRAPH_ROUNDS rounds of (sliced,
    graphed, graphed dw_switch, graphed expand_switch + dw_switch, the same,
    graphed dw_switch, graphed, sliced); graph replays a step, captures and
    capture seconds; each path's peak max_memory_allocated (the graphed one
    with its cache full); and the graphed runs to profile with phase 6's
    (the sliced step's profile is phase 4's "train kernels"). The 4 + KD
    envelope's parity is (b)'s; its time is left to the port bench."""
    space = SearchSpace()
    batch = synthetic_batch(BS, HR, DEVICE)
    out, profiles = {}, []
    env, n = "1 subnet", SPD
    cfg_steps = bench_cfgs(space, n, 1)
    lever_path = "graphed " + PW_LABEL
    order = ("sliced", "graphed", "graphed dw_switch", lever_path, lever_path,
             "graphed dw_switch", "graphed", "sliced")
    levers = {"graphed dw_switch": DW_LEVER, lever_path: PW_LEVER}
    rounds = GRAPH_ROUNDS
    for cd in (None, BF16):
        name = env + (" bf16" if cd else "")
        rec, runs, steps, replays0 = {}, {}, {}, {}
        for path in dict.fromkeys(order):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr = SRTrainer(graph_net(), opt_type="adam", weight_decay=3e-5, compute_dtype=cd,
                           **levers.get(path, {}))
            # bound now: the one-subnet runs are profiled after the loop
            if path != "sliced":
                step = steps[path] = tr.make_scan_train_step(1)

                def run(step=step, n=n, cfg_steps=cfg_steps):
                    step([batch] * n, cfg_steps, [BENCH_LR] * n)
            else:
                def run(tr=tr, cfg_steps=cfg_steps):
                    for c in cfg_steps:
                        tr.train_step(batch, c, BENCH_LR)
            t0 = time.perf_counter()
            run()  # warm: the graphs' captures, cuDNN, the allocator
            torch.cuda.synchronize()
            rec[path] = {"warm_s": time.perf_counter() - t0,
                         "max_memory_allocated_MiB":
                             torch.cuda.max_memory_allocated() / 2 ** 20}
            if path != "sliced":
                rec[path].update(captures=step.cache.captures,
                                 capture_s=step.cache.capture_s)
                replays0[path] = step.cache.replays
            runs[path] = run
        times = {p: [] for p in runs}
        for p in order * rounds:
            times[p].append(timed_steps(runs[p], n))
        for p, step in steps.items():
            rec[p]["replays_per_step"] = (step.cache.replays - replays0[p]) / (
                n * 2 * rounds)
        for p in runs:
            ev, host = zip(*times[p])
            rec[p].update(ms=list(ev), host_enqueue_ms=list(host),
                          median_ms=float(np.median(ev)),
                          median_host_enqueue_ms=float(np.median(host)),
                          spread_ms=float(max(ev) - min(ev)))
            print("  %s, %s: ms per step %s, median %.4f; host enqueue median %.4f; peak "
                  "%.0f MiB%s" % (name, p, [round(t, 3) for t in ev], np.median(ev),
                                  np.median(host), rec[p]["max_memory_allocated_MiB"],
                                  "; %d captures in %.2f s, %.1f replays a step" % (
                                      rec[p]["captures"], rec[p]["capture_s"],
                                      rec[p]["replays_per_step"]) if p in steps else ""),
                  flush=True)
        out[name] = rec
        profiles += [("%s %s" % (p, name), runs[p], n, rec[p]["median_ms"])
                     for p in ("graphed", "graphed dw_switch", lever_path)]
    return out, profiles


def masked_bn_numbers(g):
    """ms a launch of bn_forward and bn_backward at the masked step's C 384
    shapes with the active width (the middle candidates' mean 256) against
    the same call without it, f32 and bf16 (CUDA events, 20 calls, median of
    3)."""
    out = []
    for dtype in (torch.float32, BF16):
        for shape, m in masked_bn_shapes():
            if m != 256:
                continue
            c = shape[3]
            x = (1.5 * randn(g, *shape) + 0.3).to(dtype).contiguous()
            dy = randn(g, *shape).to(dtype)
            scale, bias = (0.5 + torch.rand(c, generator=g)).to(DEVICE), randn(g, c, scale=0.2)
            rm, rv = randn(g, c, scale=0.2), (0.5 + torch.rand(c, generator=g)).to(DEVICE)
            active = torch.tensor(m, dtype=torch.int32, device=DEVICE)
            kw = dict(momentum=0.1, eps=BN_EPS)
            _, mean, _, inv = bn_forward(x, scale, bias, None, None, **kw)
            row = {"shape": list(shape), "active": m, "dtype": str(dtype).replace("torch.", ""),
                   "bn_forward_ms": steady_ms(lambda: bn_forward(x, scale, bias, rm, rv,
                                                                 active=active, **kw)),
                   "bn_forward_no_operand_ms": steady_ms(lambda: bn_forward(x, scale, bias, rm,
                                                                            rv, **kw)),
                   "bn_backward_ms": steady_ms(lambda: bn_backward(dy, x, scale, mean, inv,
                                                                   active=active)),
                   "bn_backward_no_operand_ms": steady_ms(lambda: bn_backward(dy, x, scale,
                                                                              mean, inv))}
            print("  masked BN %s: %s" % (row["dtype"], {k: (round(v, 4) if isinstance(
                v, float) else v) for k, v in row.items()}), flush=True)
            out.append(row)
    return out


def phase13(g, tmp):
    t0 = time.perf_counter()
    out, walls = {}, {}
    for key, fn in (("main_path", graph_main_path),
                    ("main_path_bf16", lambda: graph_main_path(BF16)),
                    ("parity", graph_parity), ("replay_order", replay_order_check),
                    ("run_manager", lambda: graph_run_manager(tmp)),
                    ("step_times", graph_step_times), ("masked_bn", lambda: masked_bn_numbers(g))):
        release_graphs()
        t1 = time.perf_counter()
        out[key] = fn()
        walls[key] = time.perf_counter() - t1
    out["step_times"], profiles = out["step_times"]
    out.update(wall_s=time.perf_counter() - t0, part_wall_s=walls)
    print("  phase 13 took %.1f s (%s)" % (out["wall_s"], ", ".join(
        "%s %.1f" % kv for kv in walls.items())), flush=True)
    return out, profiles


# -- phase 14: the classification scan step -----------------------------------

CLS_SPD = 4                  # steps a window: the run manager's steps_per_dispatch
CLS_MAIN_STEPS = 8           # (a): two windows an envelope
CLS_KD_WINDOW = 2            # (b), (e): a window of 2 steps of 4 subnets + KD
CLS_GRAPH_ROUNDS = 1         # (e): rounds of (sliced, graphed, graphed, sliced)
CLS_RM_STEPS = 6             # (d): a window of 4 and a tail of 2
CLS_ORDER_SIZES = (224, 192)  # (b): the out-of-order replays' two batch shapes (keys A, B)
DROPOUT_STEPS = 4            # (c): one eager first run, then 3 replays
DROPOUT_SIGMAS = 4.0
# (b), (d): the parity runs' SGD lr. At the presets' CLS_LR float32 is
# chaotic over a window at full width: Proxyless's float32 paths (graphed,
# eager masked and eager sliced alike) ended 28-60% of each tensor's change
# away from the float64 steps', the eager masked path 2.5e-3 apart in loss
# from itself graphed; at this lr 9-19%, still on every float32 path alike,
# and MBV3's within CLS_UPDATE_RTOL (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md). So (b) holds a graphed tensor past STEP_TOL to float64 as its
# reference path is held, plus CLS_UPDATE_RTOL (hold_to's beside_ref). The
# window is that chaotic even in float64: rounding its lr to float32 moves
# the float64 sliced window's tensors a median 1.3e-2 of their change over
# 4 steps. The distances move from run to run with cuDNN's backward sums,
# whose order is not fixed by default: over six runs of each path
# Proxyless's first depthwise weight ended 0.214-0.228 of its change from
# float64 graphed and 0.177-0.187 eager sliced, the bound 0.05 above the
# latter (cls_parity_spread.py; NVIDIA H100 80GB HBM3, 700.00 W). So (b)
# runs with deterministic cuDNN, and every run on one card and software
# makes the same comparison
CLS_PARITY_LR = 2.5e-4


def cls_masked_bn_count(net):
    """The train-mode BNs of the masked forward: every block runs."""
    return 3 + 3 * net.n_blocks + 1


def cls_batch(seed, hw=None, b=None):
    gb = torch.Generator().manual_seed(seed)
    b, hw = b or CLS_TRAIN_BATCH, hw or CLS_TRAIN_HW
    return {"image": torch.rand(b, hw, hw, 3, generator=gb).to(DEVICE),
            "label": torch.randint(0, 1000, (b,), generator=gb).to(DEVICE)}


def cls_scan_envelopes(net, n_steps, kd_steps=CLS_KD_WINDOW):
    """The windows' subnets: one a step of the kernel phase's draw (ks
    drawn, e6, d4) and the expand phase 2's 4 a step, each step's own
    subnet_seed draws."""
    expand = train_ofa_net.TASK_PHASES[("expand", 2)]
    one = [[net.sample_arch(seed=subnet_seed(0, n_steps, i, 0), expand_candidates=[6],
                            depth_candidates=[4])] for i in range(n_steps)]
    four = [[net.sample_arch(seed=subnet_seed(0, kd_steps, i, k),
                             ks_candidates=expand["ks_list"],
                             expand_candidates=expand["expand_list"],
                             depth_candidates=expand["depth_list"])
             for k in range(expand["dynamic_batch_size"])] for i in range(kd_steps)]
    return {"1 subnet": one, "4 subnets + KD": four}


def cls_rm(path, net, n_subnets, kd, dtype, spd, provider, teacher=None, n_epochs=1,
           lr=CLS_LR):
    rc = RunConfig(n_epochs=n_epochs, base_lr=lr, warmup_epochs=0, opt_type="sgd",
                   weight_decay=3e-5, momentum=0.9, nesterov=True,
                   train_batch_size=provider.train.batch_size, dynamic_batch_size=n_subnets,
                   kd_ratio=1.0 if kd else 0.0, kd_type="ce", print_frequency=2,
                   compute_dtype="bf16" if dtype is BF16 else None, steps_per_dispatch=spd,
                   manual_seed=0)
    return ClsRunManager(path, net, rc, provider, teacher=teacher if kd else None,
                         label_smoothing=0.1)


def cls_graph_main_path(tmp, dtype=None):
    """(a) ClsRunManager at steps_per_dispatch 4 on the full-width MBV3,
    synthetic provider, batch 64 at 224 px, 8 steps (two windows): one
    subnet a step (the kernel phase), then the expand phase 2's 4 subnets
    with KD against a ks7/e6/d4 teacher; counted: the one pass key launches
    bn_forward and bn_backward once per train-mode BN of the masked forward
    (every block) at its eager first run and once at its capture, the
    replays none, nothing else; captures: the pass, the update (and the
    teacher)."""
    bf16 = dtype is BF16
    expand = train_ofa_net.TASK_PHASES[("expand", 2)]
    out = {}
    for label, n_sub, cons, kd in (
            ("1 subnet", 1, dict(expand_candidates=[6], depth_candidates=[4]), False),
            ("4 subnets + KD", expand["dynamic_batch_size"],
             dict(ks_candidates=expand["ks_list"], expand_candidates=expand["expand_list"],
                  depth_candidates=expand["depth_list"]), True)):
        net = cls_train_net(OFAMobileNetV3, DEVICE, 41)
        teacher = None
        if kd:
            t_net = cls_train_net(OFAMobileNetV3, DEVICE, 43, ks_list=[7], expand_list=[6],
                                  depth_list=[4])
            teacher = (t_net, t_net.max_arch())
        provider = SyntheticClsProvider(n_train=CLS_MAIN_STEPS * CLS_TRAIN_BATCH, n_test=8,
                                        image_size=CLS_TRAIN_HW, n_classes=1000,
                                        train_batch_size=CLS_TRAIN_BATCH, test_batch_size=8)
        rm = cls_rm(os.path.join(tmp, "main_%s_%d" % ("bf16" if bf16 else "f32", n_sub)), net,
                    n_sub, kd, dtype, CLS_SPD, provider, teacher)
        torch.cuda.synchronize()
        zero_kernel_counts()
        t0 = time.perf_counter()
        loss, top1 = rm.train_one_epoch(0, cons)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        cache = rm._scan_step.cache
        expect = 2 * cls_masked_bn_count(net)
        name = "ClsRunManager MBV3 %s%s, steps_per_dispatch %d" % (label, " bf16" if bf16
                                                                   else "", CLS_SPD)
        print("  %s: %d steps, BN launches %s (expected %d each: one pass key, counted at its "
              "eager first run and capture), %d captures (%.2f s), %d replays, loss %.5f top1 "
              "%.3f, %.1f s" % (name, CLS_MAIN_STEPS, {k: v for k, v in counts.items() if v},
                                expect, cache.captures, cache.capture_s, cache.replays, loss,
                                top1, wall), flush=True)
        wrong = cls_bn_launches_wrong(counts, expect, bf16)
        if wrong:
            fail("%s: the graphed classification path %s" % (name, wrong))
        if cache.captures != 2 + kd:
            fail("%s: %d captures, expected %d (the pass, the update%s)"
                 % (name, cache.captures, 2 + kd, ", the teacher" if kd else ""))
        want_replays = CLS_MAIN_STEPS * (n_sub + 1 + kd) - (2 + kd)
        if cache.replays != want_replays:
            fail("%s: %d replays, expected %d" % (name, cache.replays, want_replays))
        if not np.isfinite([loss, top1]).all():
            fail("%s: non-finite epoch metrics %s" % (name, (loss, top1)))
        out[label] = {"steps": CLS_MAIN_STEPS, "launches": {k: v for k, v in counts.items()
                                                            if v},
                      "expected": expect, "captures": cache.captures,
                      "capture_s": cache.capture_s, "replays": cache.replays, "loss": loss,
                      "top1": top1, "wall_s": wall}
        del rm, net, teacher
        torch.cuda.empty_cache()
    return out


def cls_window_run(path, make, arch_steps, batches, *, kd=False, dtype=None, spd=None,
                   dropout=0.0, lever=None):
    """Run `arch_steps` (SGD Nesterov at CLS_PARITY_LR, weight decay 3e-5, label
    smoothing 0.1) on `batches` (one a step) from the seeded weights on one
    path: "graphed" (make_scan_train_step's windows of `spd`), "eager
    masked" (the same windows, the cache's graphs off), "eager sliced"
    (train_step) or "float64" (train_step on the plain path in float64).
    Returns window_run's record (per-step losses, parameters and running
    statistics after, the first ones, the masked depthwise's launches) with
    the per-step top-1 and top-5 and the graph cache's counts. `lever`: the
    trainer's depthwise lever (DW_LEVER) or None."""
    f64 = path == "float64"
    net = cls_train_net(make, DEVICE, 41, dropout_rate=dropout)
    w0 = {k: p.detach().clone() for k, p in net.named_parameters()}
    s0 = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    teacher = None
    if kd:
        t_net = cls_train_net(make, DEVICE, 43, ks_list=[7], expand_list=[6], depth_list=[4],
                              dropout_rate=dropout)
        teacher = (t_net.double() if f64 else t_net, t_net.max_arch())
    if f64:
        net.double()
        batches = [dict(b, image=b["image"].double()) for b in batches]
    tr = ClsTrainer(net, opt_type="sgd", weight_decay=3e-5, momentum=0.9, nesterov=True,
                    label_smoothing=0.1, kd_ratio=1.0 if kd else 0.0, teacher=teacher,
                    compute_dtype=dtype, use_kernels=False if f64 else None, **(lever or {}))
    n, ms, cache = len(arch_steps), [], None
    zero_counts(DW_WRAPPERS)
    if path in ("graphed", "eager masked"):
        step = tr.make_scan_train_step(len(arch_steps[0]))
        cache = step.cache
        if path == "eager masked":
            cache.cuda = False  # the same window code, each part run eagerly
        spd = spd or n
        for i in range(0, n, spd):
            m = step(batches[i:i + spd], arch_steps[i:i + spd], [CLS_PARITY_LR] * len(
                arch_steps[i:i + spd]))
            ms += list(zip(*(m[k].tolist() for k in ("losses", "top1s", "top5s"))))
    else:
        for b, archs in zip(batches, arch_steps):
            m = tr.train_step(b, archs, CLS_PARITY_LR)
            ms.append(tuple(float(m[k]) for k in ("loss", "top1", "top5")))
    torch.cuda.synchronize()
    losses, top1, top5 = zip(*ms)
    out = {"losses": torch.tensor(losses, dtype=torch.float64), "top1": list(top1),
           "top5": list(top5),
           "params": {k: p.detach().clone() for k, p in net.named_parameters()},
           "stats": {k: v.clone() for k, v in net.state_dict().items() if "running" in k},
           "w0": w0, "s0": s0, "dw_launches": counts_of(DW_WRAPPERS)}
    if cache is not None:
        out["cache"] = {"captures": cache.captures, "replays": cache.replays,
                        "capture_s": cache.capture_s}
    del net, tr, teacher
    return out


def gated_off_blocks(net, arch_steps):
    """The elastic blocks no subnet of the window runs: 'blocks.<i>.'."""
    out, bi = [], 0
    for si, sp in enumerate(net.stage_specs):
        for i in range(sp.n_block):
            if all(not (i == 0 or i < a.d[si]) for step in arch_steps for a in step):
                out.append("blocks.%d." % (1 + bi))
            bi += 1
    return out


@deterministic_cudnn()
def cls_graph_parity():
    """(b) The graphed windows against the same steps run eagerly in the
    masked form and against the eager sliced steps, TF32 off, deterministic
    cuDNN (every path, the float64 one too), dropout 0:
    MBV3 and Proxyless, f32 and bf16, one window of 4 one-subnet steps
    (depths drawn from 2-3, so each stage's last block is gated off in every
    step: its running statistics and parameters must stay as they were) and
    one of 2 steps of 4 subnets + KD, SGD at CLS_PARITY_LR. Per-step losses
    at STEP_TOL (bf16: BF16_STEP_TOL), top-1 and top-5 exact (bf16 against
    the sliced path: within one row of the batch a step), float32
    parameters at STEP_TOL (a tensor past it within CLS_UPDATE_RTOL of a
    float64 sliced window's change, or, where the reference path misses
    that too, no farther from it than the reference path plus
    CLS_UPDATE_RTOL) and running statistics at
    CLS_STATE_TOL; the float32 eager masked window run twice, its
    run-to-run distance reported; captures held to the pass, the update (and
    the teacher)."""
    out = {}
    for fam, make in CLS_FAMILIES:
        probe = cls_train_net(make, "cpu", 41)
        expand = train_ofa_net.TASK_PHASES[("expand", 2)]
        one = [[probe.sample_arch(seed=subnet_seed(0, CLS_SPD, i, 0), depth_candidates=[2, 3])]
               for i in range(CLS_SPD)]
        four = [[probe.sample_arch(seed=subnet_seed(0, CLS_KD_WINDOW, i, k),
                                   ks_candidates=expand["ks_list"],
                                   expand_candidates=expand["expand_list"],
                                   depth_candidates=expand["depth_list"])
                 for k in range(expand["dynamic_batch_size"])] for i in range(CLS_KD_WINDOW)]
        gated = gated_off_blocks(probe, one)
        if not gated:
            fail("%s: the one-subnet parity window gates off no block" % fam)
        n_elastic = probe.n_blocks
        del probe
        envs = [("1 subnet", one, False), ("4 subnets + KD", four, True)]
        if fam == "MBV3":  # the masked depthwise under dw_switch: MBV3's one-subnet window
            envs.append(("1 subnet dw_switch", one, False))
        for env, arch_steps, kd in envs:
            batches = [cls_batch(50 + i) for i in range(len(arch_steps))]
            lever = DW_LEVER if env.endswith("dw_switch") else None
            # with the lever: against the eager sliced steps (which it does
            # not change), its captures against the lever-off window's
            paths = ("graphed", "eager sliced") if lever else ("graphed", "eager masked",
                                                                "eager sliced")
            for dtype, dname in CLS_DTYPES:
                name = "%s %s %s" % (fam, env, dname)
                bf16 = dtype is BF16
                t0 = time.perf_counter()
                runs = {p: cls_window_run(p, make, arch_steps, batches, kd=kd, dtype=dtype,
                                          lever=lever)
                        for p in paths}
                f64_box = []

                def f64(make=make, arch_steps=arch_steps, batches=batches, kd=kd):
                    if not f64_box:
                        f64_box.append(cls_window_run("float64", make, arch_steps, batches,
                                                      kd=kd))
                    return f64_box[0]

                g = runs["graphed"]
                noise = None
                if not bf16 and not lever:
                    again = cls_window_run("eager masked", make, arch_steps, batches, kd=kd)
                    noise = {"loss": float((again["losses"] - runs["eager masked"]["losses"])
                                           .abs().max()),
                             "params": max(float((again["params"][n] - t).abs().max())
                                           for n, t in runs["eager masked"]["params"].items())}
                    print("  %s: eager masked run twice: losses %.3e, params %.3e apart"
                          % (name, noise["loss"], noise["params"]), flush=True)
                    del again
                rec = {"steps": len(arch_steps), "cache": g["cache"],
                       "eager_masked_run_to_run": noise,
                       "losses": g["losses"].tolist(), "top1": g["top1"], "top5": g["top5"]}
                for ref in paths[1:]:
                    rec["vs " + ref] = hold_to("%s, graphed vs %s" % (name, ref), g, runs[ref],
                                               f64, bf16, beside_ref=True)
                    # the same arithmetic: the same hits; bf16 against the
                    # sliced path's other roundings: a near-tie may flip
                    # one row of the batch a step
                    rows = 1 if bf16 and ref == "eager sliced" else 0
                    for k in ("top1", "top5"):
                        off = max(abs(a - b) for a, b in zip(g[k], runs[ref][k]))
                        if off > rows * 100.0 / CLS_TRAIN_BATCH + 1e-9:
                            fail("%s: %s %s (graphed) against %s (%s)"
                                 % (name, k, g[k], runs[ref][k], ref))
                if env.startswith("1 subnet"):
                    for k, v in g["stats"].items():
                        if k.startswith(tuple(gated)) and not torch.equal(v, g["s0"][k]):
                            fail("%s: %s of a gated-off block changed" % (name, k))
                    for k, v in g["params"].items():
                        if k.startswith(tuple(gated)) and not torch.equal(v, g["w0"][k]):
                            fail("%s: %s of a gated-off block changed" % (name, k))
                    rec["gated_off_blocks"] = gated
                keys = 2 + kd
                if rec["cache"]["captures"] != keys:
                    fail("%s: %d captures, expected %d" % (name, rec["cache"]["captures"],
                                                            keys))
                # the masked depthwise: each elastic block's (gated-off ones
                # too, bound 0) at the pass's eager first run and capture
                dw_expect = 2 * n_elastic if lever else 0
                for p in paths:
                    wrong = counts_wrong(DW_WRAPPERS, "masked depthwise", runs[p]["dw_launches"],
                                         dw_expect if p == "graphed" else 0, bf16)
                    if wrong:
                        fail("%s, %s: %s" % (name, p, wrong))
                if lever:
                    off = out[name.replace(" dw_switch", "")]["cache"]["captures"]
                    if rec["cache"]["captures"] != off:
                        fail("%s: %d captures, %d without the lever"
                             % (name, rec["cache"]["captures"], off))
                    rec["dw_launches"] = {k: v for k, v in g["dw_launches"].items() if v}
                rec.update(float64_run=bool(f64_box), wall_s=time.perf_counter() - t0)
                print("  %s: %d steps, %d captures (%.2f s), %d replays, top-1 %s top-5 %s "
                      "held on all paths%s; %.1f s"
                      % (name, len(arch_steps), rec["cache"]["captures"],
                         rec["cache"]["capture_s"], rec["cache"]["replays"], g["top1"],
                         g["top5"], "; gated-off blocks %s unchanged" % gated
                         if env.startswith("1 subnet") else "", rec["wall_s"]), flush=True)
                if lever:
                    print("  %s: masked depthwise launches %s (expected %d each: every elastic "
                          "block at the pass's eager first run and capture)"
                          % (name, rec["dw_launches"], dw_expect), flush=True)
                out[name] = rec
                del runs, f64_box
                release_graphs()
    return out


def cls_replay_order_and_block():
    """(b) Two pass keys (batches at 224 and 192 px) of one pool replayed
    out of capture order (A, B, A, B | B, A) against the same steps run
    eagerly in the masked form, per-step losses at STEP_TOL; and the
    masked forward of a stride-2 SE block (MBV3's second stage's first,
    24 -> 40 at 56x56) against its sliced forward at every (ks, e),
    train-mode BN through the kernels: y and dx at TOL, the running
    statistics at CLS_STATE_TOL."""
    probe = cls_train_net(OFAMobileNetV3, "cpu", 41)
    a = [probe.sample_arch(seed=subnet_seed(0, 6, i, 0)) for i in range(6)]
    del probe
    sizes = [CLS_ORDER_SIZES[i] for i in (0, 1, 0, 1, 1, 0)]
    batches = [cls_batch(60 + i, hw) for i, hw in enumerate(sizes)]
    steps = [[x] for x in a]
    g = cls_window_run("graphed", OFAMobileNetV3, steps, batches, spd=4)
    e = cls_window_run("eager masked", OFAMobileNetV3, steps, batches, spd=4)
    order = check_close("A, B, A, B | B, A replays vs eager masked: per-step losses",
                        g["losses"], e["losses"], STEP_TOL)
    if g["cache"]["captures"] != 3:
        fail("out-of-order replays: %d captures, expected 3" % g["cache"]["captures"])
    net = cls_train_net(OFAMobileNetV3, DEVICE, 41)
    bi = net.space.max_depth  # stage 1, block 0
    in_ch, out_ch, stride, act, se, _, _ = net.block_layout()[bi]
    if not (stride == 2 and se):
        fail("block %d is not a stride-2 SE block" % bi)
    gb = torch.Generator().manual_seed(62)
    x0 = torch.randn(CLS_TRAIN_BATCH, 56, 56, in_ch, generator=gb).to(DEVICE)
    w = torch.randn(CLS_TRAIN_BATCH, 28, 28, out_ch, generator=gb).to(DEVICE)
    layer = net.blocks[1 + bi].mobile_inverted_conv
    sd = {k: v.clone() for k, v in layer.state_dict().items()}
    errs = {}
    for ks in net.space.ks_list:
        for e_ in net.space.expand_list:
            mid = make_divisible(round(in_ch * e_), 8)
            dev = [torch.tensor(v, dtype=torch.int32, device=DEVICE) for v in
                   (net.space.ks_list.index(ks), mid, make_divisible(mid // 4, 8))]
            res = []
            for masked in (True, False):
                layer.load_state_dict(sd)
                x = x0.clone().requires_grad_()
                kw = dict(act=act, stride=stride, bn_training=True, use_kernels=True)
                y = (layer.forward_masked(x, dev[0], dev[1], se_mid=dev[2], **kw) if masked
                     else layer(x, ks, mid, **kw))
                y.backward(w)
                res.append((y.detach(), x.grad, {k: v.clone() for k, v in
                                                 layer.state_dict().items() if "running" in k}))
            tag = "stride-2 SE block ks%d e%d masked vs sliced" % (ks, e_)
            errs["ks%d_e%d" % (ks, e_)] = {
                "y": check_close(tag + " y", res[0][0], res[1][0], TOL),
                "dx": check_close(tag + " dx", res[0][1], res[1][1], TOL),
                "stats": check_close(tag + " running statistics",
                                     torch.cat(list(res[0][2].values())),
                                     torch.cat(list(res[1][2].values())), CLS_STATE_TOL)}
    print("  stride-2 SE block, masked vs sliced at every (ks, e): y, dx at most %.3e, %.3e  ok"
          % (max(v["y"] for v in errs.values()), max(v["dx"] for v in errs.values())),
          flush=True)
    del net
    return {"replay_order": {"order": ["A", "B", "A", "B", "B", "A"], "sizes": sizes,
                             "losses": g["losses"].tolist(), "max_abs_err": order},
            "se_block": errs}


def cls_dropout_check():
    """(c) Dropout 0.1 inside the graphs: a window of 4 steps of one subnet
    on one batch (MBV3 f32), the pass key's eager first run and 3 replays,
    each step's uniform draws read by a spy on torch.rand copying them into
    a static buffer (captured with the pass): the replays' masks differ
    pairwise; the window's keep fraction within 4 sigma of 0.9; and the
    graphed window's draws against the same window run eagerly from the same
    dropout seed (the cache's graphs off), step for step."""
    probe = cls_train_net(OFAMobileNetV3, "cpu", 41)
    arch = [probe.sample_arch(seed=7)]
    del probe
    batch = cls_batch(70)
    draws = {}
    real = torch.rand
    for path in ("graphed", "eager masked"):
        net = cls_train_net(OFAMobileNetV3, DEVICE, 41, dropout_rate=0.1)
        tr = ClsTrainer(net, opt_type="sgd", weight_decay=3e-5, label_smoothing=0.1)
        step = tr.make_scan_train_step(1)
        if path == "eager masked":
            step.cache.cuda = False
        spy = torch.zeros(CLS_TRAIN_BATCH, net.feature_mix_width, device=DEVICE)
        seen = []

        def rand_spy(*a, spy=spy, **k):
            r = real(*a, **k)
            if k.get("generator") is tr.dropout_generator:
                spy.copy_(r)
            return r

        torch.rand = rand_spy
        try:
            for _ in range(DROPOUT_STEPS):
                step([batch], [arch], [CLS_LR])
                torch.cuda.synchronize()
                seen.append(spy.clone())
        finally:
            torch.rand = real
        draws[path] = torch.stack(seen)
        del net, tr, step
    g, e = draws["graphed"], draws["eager masked"]
    masks = g < 0.9
    keep = float(masks.float().mean())
    n = masks.numel()
    sigma = (0.9 * 0.1 / n) ** 0.5
    distinct = all(not torch.equal(masks[i], masks[j]) for i in range(1, DROPOUT_STEPS)
                   for j in range(i + 1, DROPOUT_STEPS))
    same_stream = [bool(torch.equal(g[i], e[i])) for i in range(DROPOUT_STEPS)]
    print("  dropout 0.1 in the graphs: replays' masks pairwise distinct %s; keep fraction "
          "%.5f over %d draws (0.9 +- %.5f at 4 sigma); the graphed window's draws equal the "
          "eager window's, step by step: %s" % (distinct, keep, n, DROPOUT_SIGMAS * sigma,
                                                 same_stream), flush=True)
    if not distinct:
        fail("two replays of one pass key drew the same dropout mask")
    if abs(keep - 0.9) > DROPOUT_SIGMAS * sigma:
        fail("dropout keep fraction %.5f is more than 4 sigma from 0.9" % keep)
    return {"replays_distinct": distinct, "keep_fraction": keep, "draws": n,
            "sigma": sigma, "graphed_equals_eager_stream": same_stream}


def cls_graph_run_manager(tmp):
    """(d) ClsRunManager (MBV3, synthetic, batch 64 at 224 px, SGD at
    CLS_PARITY_LR, 2 subnets a step) for one epoch of 6 steps at
    steps_per_dispatch 4 (a window and a tail of 2) against the same epoch
    at 1: the epoch's loss (STEP_TOL), the parameters (STEP_TOL; a tensor
    past it with its update within CLS_UPDATE_RTOL of the eager epoch's),
    the log lines (print_frequency 2); its checkpoint resumed at 1 for a
    second epoch. Then one ImagenetProvider epoch on a seeded PNG tree with
    ElasticResolution(128-224) at steps_per_dispatch 4: one pass key a
    size, its captures, BN launches and peak memory."""
    out = {}
    for spd in (1, CLS_SPD):
        net = cls_train_net(OFAMobileNetV3, DEVICE, 41, dropout_rate=0.0)
        w0 = {k: p.detach().clone() for k, p in net.named_parameters()}
        provider = SyntheticClsProvider(n_train=CLS_RM_STEPS * CLS_TRAIN_BATCH, n_test=8,
                                        image_size=CLS_TRAIN_HW, n_classes=1000,
                                        train_batch_size=CLS_TRAIN_BATCH, test_batch_size=8)
        path = os.path.join(tmp, "rm%d" % spd)
        rm = cls_rm(path, net, 2, False, None, spd, provider, lr=CLS_PARITY_LR)
        t0 = time.perf_counter()
        loss, top1 = rm.train_one_epoch(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rm.save_model(epoch=0)
        with open(os.path.join(path, "logs", "train_console.txt")) as f:
            lines = [ln.split(" loss")[0] for ln in f if ln.startswith("Train")]
        out[spd] = {"loss": loss, "top1": top1, "wall_s": wall, "log": lines, "path": path,
                    "params": {k: p.detach().clone() for k, p in net.named_parameters()},
                    "w0": w0, "opt_entries": len(rm.trainer.opt.state_dict()["state"])}
        del rm, net
    a, b = out[1], out[CLS_SPD]
    check_close("cls run manager epoch loss: steps_per_dispatch 4 vs 1", torch.tensor([b["loss"]]),
                torch.tensor([a["loss"]]), STEP_TOL)
    past = 0
    for n, p in b["params"].items():
        if bool(torch.isclose(p, a["params"][n], **STEP_TOL).all()):
            continue
        past += 1
        size = float((a["params"][n] - a["w0"][n]).norm())
        rel = float((p - a["params"][n]).norm()) / max(size, 1e-30)
        if not rel <= CLS_UPDATE_RTOL:
            fail("cls run manager: %s's update at steps_per_dispatch 4 is %.3e of its size "
                 "from the eager epoch's" % (n, rel))
    if (a["log"] != ["Train [1][2/6]", "Train [1][4/6]", "Train [1][6/6]"]
            or b["log"] != ["Train [1][4/6]", "Train [1][6/6]"]):
        fail("cls run manager log lines: %s (1) and %s (4)" % (a["log"], b["log"]))
    net = cls_train_net(OFAMobileNetV3, DEVICE, 41, dropout_rate=0.0)
    provider = SyntheticClsProvider(n_train=CLS_RM_STEPS * CLS_TRAIN_BATCH, n_test=8,
                                    image_size=CLS_TRAIN_HW, n_classes=1000,
                                    train_batch_size=CLS_TRAIN_BATCH, test_batch_size=8)
    rm = cls_rm(b["path"], net, 2, False, None, 1, provider, n_epochs=2, lr=CLS_PARITY_LR)
    rm.load_model()
    if rm.start_epoch != 1 or len(rm.trainer.opt.state_dict()["state"]) != b["opt_entries"]:
        fail("cls resume at steps_per_dispatch 1: start epoch %d, %d optimizer entries (saved "
             "%d)" % (rm.start_epoch, len(rm.trainer.opt.state_dict()["state"]),
                      b["opt_entries"]))
    loss2, _ = rm.train_one_epoch(1)
    if not np.isfinite(loss2):
        fail("cls resumed epoch loss %r" % loss2)
    print("  cls run manager: epoch loss %.6f (1) / %.6f (4), %d tensors past STEP_TOL, logs "
          "%s / %s; resumed at 1: epoch 2 loss %.6f  ok"
          % (a["loss"], b["loss"], past, a["log"], b["log"], loss2), flush=True)
    del rm, net
    res = {str(k): {kk: v[kk] for kk in ("loss", "top1", "wall_s", "log")}
           for k, v in out.items()}
    res.update(past_step_tol=past, resumed_loss=loss2)
    # the folder epoch with elastic resolution
    g = torch.Generator().manual_seed(45)
    elastic = ElasticResolution(list(ELASTIC_SIZES))
    prov = ImagenetProvider(root=write_folder(os.path.join(tmp, "folder"), g),
                            image_size=max(ELASTIC_SIZES), train_batch_size=FOLDER_BATCH,
                            test_batch_size=FOLDER_BATCH, elastic=elastic)
    net = OFAMobileNetV3(n_classes=1000, ks_list=[3, 5, 7], expand_list=[6], depth_list=[4],
                         device=DEVICE, generator=torch.Generator().manual_seed(46))
    rm = cls_rm(os.path.join(tmp, "folder_run"), net, 1, False, None, CLS_SPD, prov)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t0 = time.perf_counter()
    loss, top1 = rm.train_one_epoch(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    cache = rm._scan_step.cache
    sizes = sorted({k[2][0][1][1] for k in cache.graphs if k[0] == "pass"})
    expect = 2 * len(sizes) * cls_masked_bn_count(net)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print("  ImagenetProvider + ElasticResolution epoch at steps_per_dispatch %d: %d steps, "
          "pass keys at sizes %s, %d captures (%.2f s), %d replays, BN launches %s (expected "
          "%d each), loss %.4f, peak %.0f MiB, %.1f s"
          % (CLS_SPD, len(prov.train), sizes, cache.captures, cache.capture_s, cache.replays,
             {k: v for k, v in counts.items() if v}, expect, loss, peak, wall), flush=True)
    if sizes != sorted(ELASTIC_SIZES) or cache.captures != len(sizes) + 1:
        fail("the elastic-resolution epoch captured %d graphs over sizes %s, expected a pass "
             "at each of %s and the update" % (cache.captures, sizes, ELASTIC_SIZES))
    wrong = cls_bn_launches_wrong(counts, expect, False)
    if wrong:
        fail("the elastic-resolution epoch %s" % wrong)
    if not np.isfinite([loss, top1]).all():
        fail("the elastic-resolution epoch's metrics %s" % ((loss, top1),))
    res["elastic_resolution"] = {"steps": len(prov.train), "sizes": sizes,
                                 "captures": cache.captures, "capture_s": cache.capture_s,
                                 "replays": cache.replays, "launches": {
                                     k: v for k, v in counts.items() if v},
                                 "expected": expect, "loss": loss, "peak_MiB": peak,
                                 "wall_s": wall}
    del rm, net
    torch.cuda.empty_cache()
    return res


def cls_graph_step_times():
    """(e) ms a step (CUDA events) and host enqueue ms a step, eager sliced
    (train_step) against graphed (make_scan_train_step's windows), MBV3 and
    Proxyless, f32 and bf16, one subnet (windows of 4), in CLS_GRAPH_ROUNDS
    rounds of (sliced, graphed, graphed, sliced), MBV3's with the graphed
    window under dw_switch between them (sliced, graphed, graphed
    dw_switch, graphed dw_switch, graphed, sliced); replays a step,
    captures and their seconds, each path's peak max_memory_allocated (the
    graphed one with its cache full); the runs returned for phase 6's
    profiles. The 4 + KD envelope's parity is (b)'s; its time is left to
    the port bench."""
    out, profiles = {}, []
    env = "1 subnet"
    for fam, make in CLS_FAMILIES:
        # MBV3: the graphed window with dw_switch too
        order = (("sliced", "graphed", "graphed dw_switch", "graphed dw_switch", "graphed",
                  "sliced") if fam == "MBV3" else ("sliced", "graphed", "graphed", "sliced"))
        for dtype, dname in CLS_DTYPES:
            name = "%s %s %s" % (fam, env, dname)
            net = cls_train_net(make, DEVICE, 41)
            n = CLS_SPD
            arch_steps = cls_scan_envelopes(net, CLS_SPD)[env]
            batch = cls_batch(80)
            rec, runs, steps, replays0 = {}, {}, {}, {}
            for path in dict.fromkeys(order):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                # the lever is the net's (set by its trainer, as in JAX):
                # the dw_switch window gets a net of its own, the same weights
                lever = path == "graphed dw_switch"
                tr = cls_trainer(cls_train_net(make, DEVICE, 41) if lever else net, env,
                                 None, True, dtype, DW_LEVER if lever else None)
                if path != "sliced":
                    step = steps[path] = tr.make_scan_train_step(len(arch_steps[0]))

                    def run(step=step, n=n, arch_steps=arch_steps, batch=batch):
                        step([batch] * n, arch_steps, [CLS_LR] * n)
                else:
                    def run(tr=tr, arch_steps=arch_steps, batch=batch):
                        for archs in arch_steps:
                            tr.train_step(batch, archs, CLS_LR)
                t0 = time.perf_counter()
                run()  # warm: the captures, cuDNN, the allocator
                torch.cuda.synchronize()
                rec[path] = {"warm_s": time.perf_counter() - t0,
                             "max_memory_allocated_MiB":
                                 torch.cuda.max_memory_allocated() / 2 ** 20}
                if path != "sliced":
                    rec[path].update(captures=step.cache.captures,
                                     capture_s=step.cache.capture_s)
                    replays0[path] = step.cache.replays
                runs[path] = run
            times = {p: [] for p in runs}
            rounds = CLS_GRAPH_ROUNDS
            for p in order * rounds:
                times[p].append(timed_steps(runs[p], n))
            for p, step in steps.items():
                rec[p]["replays_per_step"] = (step.cache.replays - replays0[p]) / (
                    n * 2 * rounds)
            for p in runs:
                ev, host = zip(*times[p])
                rec[p].update(ms=list(ev), host_enqueue_ms=list(host),
                              median_ms=float(np.median(ev)),
                              median_host_enqueue_ms=float(np.median(host)),
                              spread_ms=float(max(ev) - min(ev)))
                print("  %s, %s: ms per step %s, median %.3f; host enqueue median %.3f; "
                      "peak %.0f MiB%s" % (
                          name, p, [round(t, 3) for t in ev], np.median(ev),
                          np.median(host), rec[p]["max_memory_allocated_MiB"],
                          "; %d captures in %.2f s, %.1f replays a step" % (
                              rec[p]["captures"], rec[p]["capture_s"],
                              rec[p]["replays_per_step"]) if p in steps else ""),
                      flush=True)
            out[name] = rec
            # (the dw_switch window is not kept: its graphs' memory)
            profiles += [("cls %s %s" % (p, name), runs[p], n, rec[p]["median_ms"])
                         for p in ("graphed", "sliced")]
            del net
            torch.cuda.empty_cache()
    return out, profiles


def phase14(tmp):
    t0 = time.perf_counter()
    out, walls = {}, {}
    for key, fn in (("main_path", lambda: cls_graph_main_path(tmp)),
                    ("main_path_bf16", lambda: cls_graph_main_path(tmp, BF16)),
                    ("parity", cls_graph_parity),
                    ("replay_order_and_block", cls_replay_order_and_block),
                    ("dropout", cls_dropout_check),
                    ("run_manager", lambda: cls_graph_run_manager(tmp)),
                    ("step_times", cls_graph_step_times)):
        release_graphs()
        t1 = time.perf_counter()
        out[key] = fn()
        walls[key] = time.perf_counter() - t1
    out["step_times"], profiles = out["step_times"]
    out.update(wall_s=time.perf_counter() - t0, part_wall_s=walls)
    print("  phase 14 took %.1f s (%s)" % (out["wall_s"], ", ".join(
        "%s %.1f" % kv for kv in walls.items())), flush=True)
    return out, profiles


# -- phase 6: per-kernel numbers at the path's shapes ------------------------

def steady_ms(fn, repeats=3):
    """Median of `repeats` time_ms runs (20 calls each): a call of the BN
    wrappers is mostly host time, and one slow stretch of the host would
    otherwise stand for the shape."""
    return float(np.median([time_ms(fn) for _ in range(repeats)]))


def measure_shape(kernel, plain, flops, nbytes_, launches, unit="frame", library=None,
                  peak=PEAK_F32_FLOPS, ops_ms=None, **info):
    """Kernel, plain and (where given) library ms per launch at one shape
    (median of 3 runs of 20 back-to-back calls),
    beside its bound (`flops` at `peak`, or `ops_ms` where the operations
    run on more than one pipe, or the bytes); `launches` per `unit` (frame
    or step)."""
    t = bound_ms(flops, nbytes_, peak)
    if ops_ms is not None:
        t = (ops_ms, t[1])
    return dict(info, **{"launches_per_" + unit: launches},
                ms_per_launch=steady_ms(kernel), plain_ms_per_launch=steady_ms(plain),
                library_ms_per_launch=steady_ms(library) if library else None,
                bound_ms_per_launch=max(t), flop=flops, bytes=nbytes_, _t=t)


def kernel_row(name, source, replaces, launches, err, shapes, unit="frame", **info):
    """One kernel's line: sums per `unit` over its launches at the path's
    shapes."""
    per = "launches_per_" + unit
    bound, by = bound_of([(s.pop("_t"), s[per]) for s in shapes])
    total = lambda key: sum(s[key] * s[per] for s in shapes)  # noqa: E731
    lib = all(s["library_ms_per_launch"] is not None for s in shapes)
    return dict({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, per: sum(s[per] for s in shapes),
                 "max_abs_err": err, "ms": total("ms_per_launch"),
                 "plain_ms": total("plain_ms_per_launch"), "bound_ms": bound, "bound_by": by,
                 "library_ms": total("library_ms_per_launch") if lib else None,
                 "per": unit}, **info, per_shape=shapes)


def kernel_numbers(g, cfg, counts, errs):
    """Per serving kernel: time per frame of all its launches at the path's
    shapes (kernel, plain version), with the card's least time for the same
    work. No single PyTorch call computes either function: library_ms is
    null. Both kernels multiply on the tensor cores, 3 TF32 products a
    multiply-add; the bound takes those at the TF32 rate (and the MBConv's
    depthwise at the FP32 rate, the larger of the two), with the bound on
    the FP32 pipe alone beside it."""
    c, m, ks = 64, SearchSpace().mid_channels(6), 7
    x, w = mbconv_case(g, (1,) + LR_HW + (c,), m, ks)
    px = x.numel() // c
    f1x1, fdw = 2 * px * 2 * c * m, 2 * px * ks * ks * m
    mb = measure_shape(
        lambda: fused_mbconv_infer(x, **w), lambda: mbconv_reference(x, **w),
        flops=f1x1 + fdw, nbytes_=nbytes(x, *w.values()) + nbytes(x), launches=sum(cfg.d),
        ops_ms=max(3 * f1x1 / PEAK_TF32, fdw / PEAK_F32_FLOPS) * 1e3,
        shape=list(x.shape), mid=m, ks=ks, conv1x1_flop=f1x1, depthwise_flop=fdw,
        bound_f32_fma_ms=(f1x1 + fdw) / PEAK_F32_FLOPS * 1e3)
    tail = []
    for i in range(cfg.pixel_d):
        x, wt, b = shuffle_case(g, (1, LR_HW[0] * 2 ** i, LR_HW[1] * 2 ** i, c))
        flops = 2 * x.numel() * 25 * 4 * c
        tail.append(measure_shape(
            lambda: fused_shuffle_tail(x, wt, b), lambda: shuffle_tail_reference(x, wt, b),
            flops=3 * flops, nbytes_=nbytes(x, wt, b) + 4 * nbytes(x), launches=1,
            peak=PEAK_TF32, shape=list(x.shape), conv_flop=flops,
            bound_f32_fma_ms=flops / PEAK_F32_FLOPS * 1e3))
    n = mb["launches_per_frame"]
    return [kernel_row("fused_mbconv_infer", "ofa_sr_tpu_torch/csrc/mbconv.cu",
                       "ofa_sr_tpu/ops/pallas/mbconv.py:155", counts["mbconv"],
                       errs["mbconv"], [mb],
                       bound_rate="the larger of the 1x1 convs' 3 TF32 products a "
                       "multiply-add at %.0f TFLOP/s and the depthwise at %.0f TFLOP/s "
                       "(FP32)" % (PEAK_TF32 / 1e12, PEAK_F32_FLOPS / 1e12),
                       bound_f32_fma_ms=n * mb["bound_f32_fma_ms"],
                       max_abs_err_vs_f64=errs["mbconv_vs_f64"]),
            kernel_row("fused_shuffle_tail", "ofa_sr_tpu_torch/csrc/shuffle_tail.cu",
                       "ofa_sr_tpu/ops/pallas/shuffle_tail.py:121", counts["shuffle_tail"],
                       errs["shuffle_tail"], tail,
                       bound_rate="3xTF32: 3 TF32 products per multiply-add at %.0f TFLOP/s"
                       % (PEAK_TF32 / 1e12),
                       bound_f32_fma_ms=sum(s["bound_f32_fma_ms"] for s in tail),
                       max_abs_err_vs_f64=errs["shuffle_tail_vs_f64"])]


def bn_kernel_numbers(g, launches, errs, dtype=torch.float32):
    """Per BN kernel row: time per one-subnet training step of its launches
    at the path's shapes (the subnets of the counted one-subnet steps,
    launches averaged per step), against its plain version, the card's least
    time (bytes), and one PyTorch call computing the same function:
    torch.nn.functional.batch_norm(training=True) on the channels-last NCHW
    view with copies of the running statistics for the fused forward,
    torch.var_mean for the moments, and aten.native_batch_norm_backward with
    the full output mask (dx, dscale = sum dy*xhat, dbias = sum dy) on the
    channels-last NCHW view for the fused backward, checked here to return
    the plain version's results. The backward row times `bn_backward` as
    bn_train_fused calls it: the sums of the TPU kernel `bn_bwd_sums` and the
    dx that XLA fuses after it, hence its name. `dtype` bf16 gives the bf16
    forms' rows, on bf16 activations (float32 scale, mean and inv), with
    their bf16 launches."""
    bf16 = dtype is BF16
    space = SearchSpace()
    per_step = {}
    for i in range(TRAIN_STEPS):
        for shp in bn_train_shapes(space, step_subnets(space, i, 1)[0], BS, HR):
            per_step[shp] = per_step.get(shp, 0) + 1.0 / TRAIN_STEPS
    fwd, mom, bwd = [], [], []
    library_note = fwd_note = None
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731  channels-last NCHW view
    for shp in sorted(per_step):
        n, c = int(np.prod(shp[:3])), shp[3]
        k = per_step[shp]
        x = (1.5 * randn(g, *shp) + 0.3).to(dtype).contiguous()
        scale, bias = (0.5 + torch.rand(c, generator=g)).to(DEVICE), randn(g, c, scale=0.2)
        rm0, rv0 = randn(g, c, scale=0.2), (0.5 + torch.rand(c, generator=g)).to(DEVICE)
        stats = [t.clone() for t in (rm0, rv0) * 3]  # kernel, plain, library
        kw = dict(momentum=0.1, eps=BN_EPS, update_var="unbiased")

        def fwd_library(rm=stats[4], rv=stats[5]):
            return torch.nn.functional.batch_norm(nchw(x), rm, rv, scale, bias, training=True,
                                                  momentum=0.1, eps=BN_EPS)

        lib_fwd = fwd_library
        try:
            lib_y = fwd_library(*[t.clone() for t in (rm0, rv0)])
            if lib_y.dtype is not dtype:
                raise RuntimeError("it returned %s" % lib_y.dtype)
        except RuntimeError as e:  # a yardstick only: the port never calls it
            fwd_note = "batch_norm(training=True) refused %s input: %s" % (
                dtype, str(e).splitlines()[0][:160])
            print("  " + fwd_note, flush=True)
            lib_fwd = None
        if lib_fwd is not None:
            check_close("batch_norm(training=True)%s y %s" % (" bf16" if bf16 else "", shp),
                        lib_y.permute(0, 2, 3, 1).float(),
                        bn_forward_reference(x, scale, bias, rm0.clone(), rv0.clone(),
                                             **kw)[0].float(),
                        BF16_DX_TOL if bf16 else TOL)
        fwd.append(measure_shape(
            lambda: bn_forward(x, scale, bias, stats[0], stats[1], **kw),
            lambda: bn_forward_reference(x, scale, bias, stats[2], stats[3], **kw),
            flops=6 * n * c, nbytes_=2 * nbytes(x) + 9 * c * 4, launches=k, unit="step",
            library=lib_fwd, shape=list(shp)))
        mom.append(measure_shape(
            lambda: bn_moments(x), lambda: bn_moments_reference(x),
            flops=3 * n * c, nbytes_=nbytes(x) + 2 * c * 4, launches=k,
            unit="step", library=lambda: torch.var_mean(x, dim=(0, 1, 2), correction=0),
            shape=list(shp)))
        dy = randn(g, *shp).to(dtype)
        mean, var = bn_moments_reference(x)
        inv = torch.rsqrt(var + 1e-5)
        dyf = dy.view(n, c).float()

        def library():
            return torch.ops.aten.native_batch_norm_backward(
                nchw(dy), nchw(x), scale, None, None, mean, inv, True, 1e-5,
                [True, True, True])

        try:
            lib_dx, lib_ds, lib_db = library()
        except RuntimeError as e:  # a yardstick only: the port never calls it
            library_note = "native_batch_norm_backward refused %s input: %s" % (
                dtype, str(e).splitlines()[0][:160])
            print("  " + library_note, flush=True)
            library = None
        ref = bn_backward_reference(dy, x, scale, mean, inv)
        if library is not None:
            xhat = (x.view(n, c).float() - mean) * inv
            check_close("native_batch_norm_backward%s dx %s" % (" bf16" if bf16 else "", shp),
                        lib_dx.permute(0, 2, 3, 1).float(), ref[0].float(),
                        BF16_DX_TOL if bf16 else TOL)
            check_sums("native_batch_norm_backward dscale %s" % (shp,), lib_ds.float(), ref[1],
                       dyf * xhat)
            check_sums("native_batch_norm_backward dbias %s" % (shp,), lib_db.float(), ref[2],
                       dyf)
        bwd.append(measure_shape(
            lambda: bn_backward(dy, x, scale, mean, inv),
            lambda: bn_backward_reference(dy, x, scale, mean, inv),
            flops=11 * n * c, nbytes_=3 * nbytes(dy) + 5 * c * 4, launches=k,
            unit="step", library=library, shape=list(shp)))
    key = "_bf16" if bf16 else ""
    info = dict(unit="step", dtype=str(dtype).replace("torch.", ""))
    names = [BF16_ROWS[r] if bf16 else r for r in BN_ROW_KERNELS]
    src = "ofa_sr_tpu_torch/csrc/bn_stats.cu"
    return [kernel_row(names[0], src, "ofa_sr_tpu/ops/pallas/bn_stats.py:94",
                       launches["bn_forward" + key], errs["bn_forward" + key], fwd,
                       wrapper="bn_forward", replaces_also="the XLA normalize after the "
                       "Pallas moments (ofa_sr_tpu/ops/pallas/bn.py:47-51) and the running "
                       "statistics' EMA (ofa_sr_tpu/ops/norm.py:86-90)",
                       **dict(info, **({"library_note": fwd_note} if fwd_note else {}))),
            kernel_row(names[1], src, "ofa_sr_tpu/ops/pallas/bn_stats.py:94",
                       launches["col_sums2" + key], errs["col_sums2" + key], mom,
                       wrapper="bn_moments (off the training path)", **info),
            kernel_row(names[2], src, "ofa_sr_tpu/ops/pallas/bn_stats.py:196",
                       launches["bn_backward" + key], errs["bn_bwd_sums" + key], bwd,
                       wrapper="bn_backward",
                       **dict(info, **({"library_note": library_note} if library_note else {})))]


def dw_path_shapes(space):
    """{(LR side, ks, mid): launches a step} of the masked depthwise on the
    graphed one-subnet S4 window's path (bench.py's 16 steps): one a block
    run, at the bank width 384."""
    per = {}
    cfg_steps = bench_cfgs(space, SPD, 1)
    for (cfg,) in cfg_steps:
        lr = HR // 2 ** cfg.pixel_d
        for stage in range(space.n_stages):
            for i in range(cfg.d[stage]):
                bi = stage * space.max_depth + i
                key = (lr, cfg.ks[bi], space.mid_channels(cfg.e[bi]))
                per[key] = per.get(key, 0) + 1.0 / len(cfg_steps)
    return per


def dw_kernel_numbers(g, p13, errs, dtype=torch.float32):
    """The masked depthwise's three rows (forward, dgrad, wgrad): time a
    step of their launches at the graphed one-subnet S4 window's shapes
    (bs16, LR 48 and 24, bank width 384, each block's sampled ks and mid,
    the activations 0 from mid on), against the plain version (cuDNN's
    grouped conv of the masked operands, and for dx and dW the
    convolution_backward calls its autograd makes, with the masks) and one
    library call of the masked step's own work (cuDNN's grouped conv
    forward, and convolution_backward for dx or dW alone, at 7x7 over all
    384 channels, unmasked: what the masked step runs without the lever),
    with the card's least time for the sampled work (k x k taps below the
    bound: FMAs at the FP32 rate against the bytes the kernel must move: the
    live channels read, the whole output written), the masked work's
    beside it. `launches` is the main path's: phase 13's graphed run with
    dw_switch."""
    bf16 = dtype is BF16
    key = "_bf16" if bf16 else ""
    space, c, big = SearchSpace(), SearchSpace().mid_channels(max(SearchSpace().expand_list)), 7
    esz = torch.finfo(dtype).bits // 8
    ks_list = tuple(sorted(set(space.ks_list)))
    rows = {k.__name__: [] for k in DW_WRAPPERS}
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    cb = torch.ops.aten.convolution_backward
    for (lr, ks, mid), k in sorted(dw_path_shapes(space).items()):
        live = (torch.arange(c, device=DEVICE) < mid).to(dtype)
        x = (randn(g, BS, lr, lr, c) * live).to(dtype).contiguous()
        dy = (randn(g, BS, lr, lr, c) * live).to(dtype).contiguous()
        w = randn(g, c, 1, big, big, scale=0.1).to(dtype)
        kt = torch.tensor(ks_list.index(ks), dtype=torch.int32, device=DEVICE)
        bt = torch.tensor(mid, dtype=torch.int32, device=DEVICE)
        tm = tap_mask(kt, ks_list, big, DEVICE).to(dtype)
        wm = w * tm
        cv = dict(stride=[1, 1], padding=[big // 2] * 2, dilation=[1, 1], transposed=False,
                  output_padding=[0, 0], groups=c)
        kw = dict(ks_list=ks_list, stride=1)
        r = x.numel() // c
        sampled = 2 * r * mid * ks * ks
        masked = 2 * r * c * big * big
        info = dict(shape=[BS, lr, lr, c], ks=ks, mid=mid)
        for name, kern, plain, library, nbytes_s, nbytes_m in (
                ("dw_masked_forward", lambda: dw_masked_forward(x, w, kt, bt, **kw),
                 lambda: masked_depthwise_reference(x, w, kt, bt, **kw),
                 lambda: torch.nn.functional.conv2d(nchw(x), w, padding=big // 2, groups=c),
                 (r * mid + r * c) * esz + mid * ks * ks * esz, 2 * r * c * esz),
                ("dw_masked_dgrad", lambda: dw_masked_dgrad(dy, w, kt, bt, in_hw=(lr, lr), **kw),
                 lambda: cb(nchw(dy * live), nchw(x), wm, None, output_mask=[True, False, False],
                            **cv)[0] * live.view(1, c, 1, 1),
                 lambda: cb(nchw(dy), nchw(x), w, None, output_mask=[True, False, False], **cv),
                 (r * mid + r * c) * esz + mid * ks * ks * esz, 2 * r * c * esz),
                ("dw_masked_wgrad", lambda: dw_masked_wgrad(x, dy, kt, bt, bank_ks=big, **kw),
                 lambda: cb(nchw(dy * live), nchw(x * live), wm, None,
                            output_mask=[False, True, False], **cv)[1] * tm,
                 lambda: cb(nchw(dy), nchw(x), w, None, output_mask=[False, True, False], **cv),
                 2 * r * mid * esz + c * big * big * esz, 2 * r * c * esz)):
            rec = measure_shape(kern, plain, sampled, nbytes_s, k, unit="step", library=library,
                                **info)
            rec["bound_masked_work_ms_per_launch"] = max(bound_ms(masked, nbytes_m))
            rows[name].append(rec)
        del x, dy, w, wm, tm
    src = "ofa_sr_tpu_torch/csrc/dw_masked.cu"
    replaces = ("none: no Pallas kernel; the XLA depthwise branches of the masked MBConv, "
                "ofa_sr_tpu/models/layers.py:248 (_dw_switched, dw_switch) and :425 (ks_switch)")
    run = p13["main_path_bf16" if bf16 else "main_path"]["1 subnet, dw_switch"]
    out = []
    for name in rows:
        row = kernel_row(name + (" (bf16)" if bf16 else ""), src, replaces,
                         run["launches"].get(name + key, 0), errs[name + key], rows[name],
                         unit="step", wrapper=name, dtype=str(dtype).replace("torch.", ""),
                         bound_rate="FMAs at %.0f TFLOP/s (FP32) against %.2f TB/s, the "
                         "sampled k x k taps below the bound" % (PEAK_F32_FLOPS / 1e12,
                                                                PEAK_BYTES / 1e12),
                         library_call={"dw_masked_forward": "F.conv2d(groups=C), 7x7, all C",
                                       "dw_masked_dgrad": "aten.convolution_backward, dx, "
                                                          "7x7, all C",
                                       "dw_masked_wgrad": "aten.convolution_backward, dW, "
                                                          "7x7, all C"}[name])
        row["bound_masked_work_ms"] = sum(sh["bound_masked_work_ms_per_launch"]
                                          * sh["launches_per_step"] for sh in rows[name])
        if name == "dw_masked_wgrad":
            row["max_abs_err_vs_f64"] = errs["dw_masked_wgrad_vs_f64" + key]
        out.append(row)
        print("  %-24s %d launches (graphed main path)  %.4f ms/step  plain %.4f  bound %.4f "
              "(%s; masked work %.4f)  library %.4f" % (
                  row["name"], row["launches"], row["ms"], row["plain_ms"], row["bound_ms"],
                  row["bound_by"], row["bound_masked_work_ms"], row["library_ms"]), flush=True)
    return out


def pw_path_shapes(space):
    """{(LR side, mid): blocks a step} of the graphed one-subnet S4 window's
    path (bench.py's 16 steps): each block run launches each direction of
    the masked 1x1 twice, the expand's and the project's."""
    per = {}
    cfg_steps = bench_cfgs(space, SPD, 1)
    for (cfg,) in cfg_steps:
        lr = HR // 2 ** cfg.pixel_d
        for stage in range(space.n_stages):
            for i in range(cfg.d[stage]):
                key = (lr, space.mid_channels(cfg.e[stage * space.max_depth + i]))
                per[key] = per.get(key, 0) + 1.0 / len(cfg_steps)
    return per


def pw_kernel_numbers(g, p13, errs, dtype=torch.float32):
    """The masked 1x1's three rows (forward, dgrad, wgrad, each over the
    expand's and the project's products): time a step of their launches at
    the graphed one-subnet S4 window's shapes (bs16, LR 48 and 24, Cin =
    Cout = 64, the bank width 384, each block's sampled mid), against the
    plain version (cuBLAS on the masked operands, one product a direction:
    masked_pointwise_reference, masked_pointwise_dgrad_reference and
    masked_pointwise_wgrad_reference) and one library call of the masked
    step's own work without the lever (cuDNN's 1x1 conv over all 384
    channels, and convolution_backward for dx or dW alone), with the card's
    least time for
    the sampled work: the multiply-adds below the bound on the tensor cores
    (3xTF32: three TF32 products a multiply-add at the TF32 rate; bf16 at
    its rate) against the bytes the kernel must move (the live operands
    read once, the whole output written, its zeros included); the whole
    width's bound beside it. `launches` is the main path's: phase 13's
    graphed run with expand_switch and dw_switch."""
    bf16 = dtype is BF16
    key = "_bf16" if bf16 else ""
    space = SearchSpace()
    c, big = space.width, space.mid_channels(max(space.expand_list))
    esz = torch.finfo(dtype).bits // 8
    rows = {k.__name__: [] for k in PW_WRAPPERS}
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    cb = torch.ops.aten.convolution_backward
    cv = dict(stride=[1, 1], padding=[0, 0], dilation=[1, 1], transposed=False,
              output_padding=[0, 0], groups=1)

    def ops_ms(macs):
        return (3 * 2 * macs / PEAK_TF32 if not bf16 else 2 * macs / PEAK_BF16) * 1e3

    for (lr, mid), k in sorted(pw_path_shapes(space).items()):
        live = (torch.arange(big, device=DEVICE) < mid).to(dtype)
        x = randn(g, BS, lr, lr, c).to(dtype)
        h = (randn(g, BS, lr, lr, big) * live).to(dtype).contiguous()
        dy = (randn(g, BS, lr, lr, big) * live).to(dtype).contiguous()
        dz = randn(g, BS, lr, lr, c).to(dtype)
        we = randn(g, big, c, 1, 1, scale=c ** -0.5).to(dtype)
        wp = randn(g, c, big, 1, 1, scale=big ** -0.5).to(dtype)
        bt = torch.tensor(mid, dtype=torch.int32, device=DEVICE)
        r = BS * lr * lr
        macs = r * c * mid
        info = dict(rows=r, cin=c, m=big, cout=c, mid=mid)
        for name, side, kern, plain, library, nbytes_s, nbytes_m in (
                ("pw_masked_forward", "expand",
                 lambda: pw_masked_forward(x, we, bt, side="expand"),
                 lambda: masked_pointwise_reference(x, we, bt, side="expand"),
                 lambda: torch.nn.functional.conv2d(nchw(x), we),
                 (r * c + mid * c + r * big) * esz, (r * c + big * c + r * big) * esz),
                ("pw_masked_forward", "project",
                 lambda: pw_masked_forward(h, wp, bt, side="project"),
                 lambda: masked_pointwise_reference(h, wp, bt, side="project"),
                 lambda: torch.nn.functional.conv2d(nchw(h), wp),
                 (r * mid + c * mid + r * c) * esz, (r * big + c * big + r * c) * esz),
                ("pw_masked_dgrad", "expand",
                 lambda: pw_masked_dgrad(dy, we, bt, side="expand"),
                 lambda: masked_pointwise_dgrad_reference(dy, we, bt, side="expand"),
                 lambda: cb(nchw(dy), nchw(x), we, None, output_mask=[True, False, False], **cv),
                 (r * mid + mid * c + r * c) * esz, (r * big + big * c + r * c) * esz),
                ("pw_masked_dgrad", "project",
                 lambda: pw_masked_dgrad(dz, wp, bt, side="project"),
                 lambda: masked_pointwise_dgrad_reference(dz, wp, bt, side="project"),
                 lambda: cb(nchw(dz), nchw(h), wp, None, output_mask=[True, False, False], **cv),
                 (r * c + c * mid + r * big) * esz, (r * c + c * big + r * big) * esz),
                ("pw_masked_wgrad", "expand",
                 lambda: pw_masked_wgrad(x, dy, bt, side="expand"),
                 lambda: masked_pointwise_wgrad_reference(x, dy, bt, side="expand"),
                 lambda: cb(nchw(dy), nchw(x), we, None, output_mask=[False, True, False], **cv),
                 (r * mid + r * c + big * c) * esz, (r * big + r * c + big * c) * esz),
                ("pw_masked_wgrad", "project",
                 lambda: pw_masked_wgrad(h, dz, bt, side="project"),
                 lambda: masked_pointwise_wgrad_reference(h, dz, bt, side="project"),
                 lambda: cb(nchw(dz), nchw(h), wp, None, output_mask=[False, True, False], **cv),
                 (r * mid + r * c + c * big) * esz, (r * big + r * c + c * big) * esz)):
            rec = measure_shape(kern, plain, 2 * macs, nbytes_s, k, unit="step",
                                library=library, ops_ms=ops_ms(macs), side=side, **info)
            rec["bound_whole_width_ms_per_launch"] = max(ops_ms(r * c * big),
                                                         nbytes_m / PEAK_BYTES * 1e3)
            rows[name].append(rec)
        del x, h, dy, dz, we, wp
    src = "ofa_sr_tpu_torch/csrc/pw_masked.cu"
    replaces = ("none: no Pallas kernel; the XLA 1x1 convs of the JAX package's expand_switch "
                "branches, ofa_sr_tpu/models/layers.py:126 and :156 (_sliced_mbconv_branch)")
    run = p13["main_path_bf16" if bf16 else "main_path"]["1 subnet, " + PW_LABEL]
    rate = ("3 TF32 products a multiply-add at %.0f TFLOP/s" % (PEAK_TF32 / 1e12) if not bf16
            else "bf16 at %.0f TFLOP/s" % (PEAK_BF16 / 1e12))
    out = []
    for name in rows:
        row = kernel_row(name + (" (bf16)" if bf16 else ""), src, replaces,
                         run["launches"].get(name + key, 0), errs[name + key], rows[name],
                         unit="step", wrapper=name, dtype=str(dtype).replace("torch.", ""),
                         bound_rate="%s against %.2f TB/s, the multiply-adds below the bound"
                         % (rate, PEAK_BYTES / 1e12),
                         library_call={"pw_masked_forward": "F.conv2d 1x1, all 384 channels",
                                       "pw_masked_dgrad": "aten.convolution_backward, dx, "
                                                          "1x1, all 384 channels",
                                       "pw_masked_wgrad": "aten.convolution_backward, dW, "
                                                          "1x1, all 384 channels"}[name])
        row["bound_whole_width_ms"] = sum(sh["bound_whole_width_ms_per_launch"]
                                          * sh["launches_per_step"] for sh in rows[name])
        if name == "pw_masked_wgrad":
            row["max_abs_err_vs_f64"] = errs["pw_masked_wgrad_vs_f64" + key]
        out.append(row)
        print("  %-24s %d launches (graphed main path)  %.4f ms/step  plain %.4f  bound %.4f "
              "(%s; whole width %.4f)  library %.4f" % (
                  row["name"], row["launches"], row["ms"], row["plain_ms"], row["bound_ms"],
                  row["bound_by"], row["bound_whole_width_ms"], row["library_ms"]), flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures the port on a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print("phase 1: card:", smi_line, flush=True)
    print("  torch %s, CUDA %s, python %s" % (torch.__version__, torch.version.cuda,
                                             sys.version.split()[0]), flush=True)
    build_s = _build.build_all()
    print("  kernels built in %.1f s (%s)" % (build_s, _build.BUILD_DIR), flush=True)
    for name, log in sorted(_build.ptxas_log.items()):
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line or \
                    "smem" in line:
                print("  [%s] %s" % (name, line.strip()), flush=True)
    smem_query = _build.load("mbconv").ofa_mbconv_smem_bytes
    smem_query.argtypes, smem_query.restype = [ctypes.c_int] * 2, ctypes.c_int
    mb_smem = {ks: smem_query(64, ks) for ks in (3, 5, 7)}
    print("  [mbconv] dynamic shared memory a block at C 64, by k: %s bytes" % mb_smem,
          flush=True)
    dw_smem = dw_smem_bytes()
    print("  [dw_masked] dynamic shared memory a block, K 7, (stride 1, stride 2), float32 "
          "and bf16: %s bytes" % {k: v for k, v in dw_smem.items() if "K7" in k}, flush=True)
    pw_smem = pw_smem_bytes()
    print("  [pw_masked] dynamic shared memory a block at the S4 shapes: %s bytes" % {
        k: v for k, v in pw_smem.items() if "K24" not in k and "K40" not in k and "K72" not in k},
          flush=True)

    g = torch.Generator().manual_seed(1234)
    t_phase = time.perf_counter()
    print("phase 2: kernel parity on the card", flush=True)
    errs = kernel_parity(g)
    errs.update(bn_forward_parity(g))
    errs.update(bn_parity(g))
    bn_grad_check(g)
    print("phase 2: the BN kernels with the masked step's active width", flush=True)
    errs.update(bn_active_parity(g))
    print("phase 2: the BN kernels' bf16 forms", flush=True)
    errs.update(bn_forward_parity(g, BF16))
    errs.update(bn_parity(g, BF16))
    bn_grad_check(g, BF16)
    errs.update(bn_active_parity(g, BF16))
    print("phase 2: the BN kernels with the classification masked step's active width "
          "(width 0 included)", flush=True)
    for dtype in (torch.float32, BF16):
        errs.update(bn_active_parity(g, dtype, cls_masked_bn_cases(), "_active_cls"))
    bn_dtype_rule()
    print("phase 2: the masked depthwise (csrc/dw_masked.cu), forward, dgrad and wgrad, "
          "float32 and bf16", flush=True)
    for dtype in (torch.float32, BF16):
        errs.update(dw_masked_parity(g, dtype))
    print("phase 2: the masked 1x1 expand and project convs (csrc/pw_masked.cu), forward, "
          "dgrad and wgrad, float32 and bf16", flush=True)
    for dtype in (torch.float32, BF16):
        errs.update(pw_masked_parity(g, dtype))

    print("  phase 2 took %.1f s" % (time.perf_counter() - t_phase), flush=True)
    t_phase = time.perf_counter()
    print("phase 3: serving %d frames of %dx%d LR" % ((N_FRAMES,) + LR_HW), flush=True)
    net = build_net(dev)
    net_cpu = build_net("cpu")
    cfg = uniform_subnet(net.space, 7, 6, 2, 2)
    counts, frame_ms, profiles = serving(net, net_cpu, cfg)

    print("phase 4: entry() supernet forward, bs16 48x48, pixel_d 1", flush=True)
    fn, args = entry(device=dev)
    y = fn(*args)
    torch.cuda.synchronize()
    if tuple(y.shape) != (16, 96, 96, 3):
        fail("entry output shape %s" % (tuple(y.shape),))
    fn_cpu, args_cpu = entry(device="cpu")
    check_close("entry forward: card vs CPU", y.cpu(), fn_cpu(*args_cpu), FRAME_TOL)
    entry_ms = time_ms(lambda: fn(*args), iters=5, warmup=1)
    print("  entry forward ms: %.4f" % entry_ms, flush=True)
    del fn, args, y
    print("phase 4: entry.train, bs%d %dx%d HR, full-width supernet" % (BS, HR, HR), flush=True)
    train_runs = training_main_path()
    print("phase 4: entry.train in bf16 mixed precision (compute_dtype=torch.bfloat16)",
          flush=True)
    train_runs_bf16 = training_main_path(BF16)
    path_counts = {}
    for runs, key in ((train_runs, ""), (train_runs_bf16, "_bf16")):
        for k in BN_KERNELS + BN_OFF_PATH:
            name = k.__name__ + key
            path_counts[name] = sum(r["launches"][name] for r in runs.values())
    training_checks()
    step_ms, train_runs_to_profile = step_times()

    print("  phases 3-4 took %.1f s" % (time.perf_counter() - t_phase), flush=True)
    t_phase = time.perf_counter()
    print("phase 5: the run-management path through the CLIs (teacher trainer, SR evaluator)",
          flush=True)
    cli = cli_phase()
    print("  phase 5 took %.1f s" % (time.perf_counter() - t_phase), flush=True)

    print("phase 7: the X4 supernet: serving, training and the shrinking CLI", flush=True)
    x4, x4_profiles = x4_phase(dev)

    print("phase 8: large frames (row bounds, row-padded, tiled, spatial) and data "
          "parallelism (two ranks on the card over gloo; NCCL at world 1)", flush=True)
    p8 = phase8(g, dev, train_runs, train_runs_bf16)

    print("phase 9: subnet search (latency tables through the kernels, the finder, the "
          "deployments), the predictor, bicubic and the oracle-video CLIs", flush=True)
    p9 = phase9(dev)

    print("phase 10: export, get_net_info, the classification nets at published width, the "
          "tutorial", flush=True)
    p10 = phase10(dev)

    print("phase 11: classification training: the trainer at full width, the five CLIs, the "
          "real data paths", flush=True)
    p11, cls_profiles = phase11(g, dev)

    print("phase 12: the SR curriculum through the CLIs, its resume, and the search-and-deploy "
          "demo on its expand checkpoint", flush=True)
    p12 = phase12(dev)

    print("phase 13: multi-step dispatch: the masked step as CUDA-graph replays (entry.train "
          "with steps_per_dispatch, parity, the run manager, step times)", flush=True)
    with tempfile.TemporaryDirectory(prefix="ofa_sr_p13_") as tmp:
        p13, graph_profiles = phase13(g, tmp)

    print("phase 14: the classification scan step: ClsRunManager with steps_per_dispatch, "
          "parity, dropout, the run manager, step times", flush=True)
    with tempfile.TemporaryDirectory(prefix="ofa_sr_p14_") as tmp:
        p14, cls_graph_profiles = phase14(tmp)

    t_phase = time.perf_counter()
    print("phase 6: per-kernel numbers", flush=True)
    bn_rows = bn_kernel_numbers(g, path_counts, errs)
    bn_rows_bf16 = bn_kernel_numbers(g, path_counts, errs, BF16)
    rows = kernel_numbers(g, cfg, counts, errs) + bn_rows + bn_rows_bf16
    # each row's launches in phase 5's counted CLI runs: the BN rows in the
    # teacher runs of their type, the serving rows in the evaluator's
    t = cli["teacher"]
    f32_cli = [t["f32"]["launches"][k] + t["f32_resumed"]["launches"][k]
               for k in ("bn_forward", "col_sums2", "bn_backward")]
    bf16_cli = [t["bf16"]["launches"][k + "_bf16"] for k in ("bn_forward", "col_sums2",
                                                             "bn_backward")]
    for r, n in zip(rows, [cli["eval"]["launches"]["mbconv"],
                           cli["eval"]["launches"]["shuffle_tail"]] + f32_cli + bf16_cli):
        r["launches_cli"] = n
    # each row's launches in phase 7's counted X4 runs: serving (per mode),
    # the evaluator, training (per mode, of the row's type) and the
    # shrinking CLI's two training stages
    xs, xt, xc = x4["serving"], x4["training"], x4["cli"]
    for r, key in zip(rows[:2], ("mbconv", "shuffle_tail")):
        r["launches_x4"] = {"serve " + m: xs[m]["launches"][key] for m in X4_MODES}
        r["launches_x4"]["eval cli"] = xc["eval"]["launches"][key]
    rows[1]["launches_x4_note"] = ("0: the X4's shuffle convs are 3x3 and the tail kernel is "
                                   "5x5 only, in both packages")
    for r, name in zip(rows[2:], ("bn_forward", "col_sums2", "bn_backward") * 2):
        bf16 = r["dtype"] == "bfloat16"
        key = name + ("_bf16" if bf16 else "")
        r["launches_x4"] = {"train " + m: xt[m + (" bf16" if bf16 else "")]["launches"][key]
                            for m in X4_MODES}
        r["launches_x4"]["shrink cli"] = (0 if bf16 else xc["expand"]["launches"][key]
                                          + xc["pixelshuffle_depth"]["launches"][key])
    for r in rows:
        print("  %-20s %d launches (CLIs %d)  %.4f ms/%s  plain %.4f  bound %.4f (%s)  "
              "library %s" % (r["name"], r["launches"], r["launches_cli"], r["ms"], r["per"],
                              r["plain_ms"], r["bound_ms"], r["bound_by"], r["library_ms"]),
              flush=True)
    # phase 8's counted runs: the MBConv's row-padded 1080p frames, and the
    # apply entry points' rows from rank 0 of the two-rank training (each
    # rank launches as many)
    rows[0]["launches_phase8"] = {k: v["launches"]["mbconv"] for k, v in p8["frames"].items()}
    rows[0]["ms_row_bounds"] = p8["mbconv_row_bounds"]["ms"]
    rows[0]["max_abs_err_row_bounds"] = p8["mbconv_row_bounds"]["max_abs_err"]
    rows[1]["launches_phase8"] = {k: v["launches"]["shuffle_tail"]
                                  for k, v in p8["frames"].items()}
    # phase 9's counted runs: the search (its tables and deployments' timed
    # calls, counted at capture; the recalibration's BN forwards), the
    # winner's frames, the additivity subnets, the corner table and the
    # oracle-video evaluator; the oracle CLIs launch nothing (BN frozen)
    s9, d9 = p9["search"], p9["data"]
    for r, key in zip(rows[:2], ("mbconv", "shuffle_tail")):
        r["launches_phase9"] = {
            "search (table, deployments, counted at capture)": s9["launches"][key],
            "serve winner": s9["serve_launches"][key],
            "additivity": sum(a[{"mbconv": "mbconv_launches",
                                 "shuffle_tail": "tail_launches"}[key]]
                              for a in p9["additivity"]),
            "corner table": sum(c[key] for c in p9["predictor"]["corner_calls"]),
            "eval oracle_video": d9["eval oracle_video"]["launches"][key],
            "oracle CLIs": sum(d9[k]["launches"][key] for k in ("teacher validate",
                                                               "teacher finetune",
                                                               "ofa oracle"))}
    for r, name in zip(rows[2:], ("bn_forward", "col_sums2", "bn_backward") * 2):
        key = name + ("_bf16" if r["dtype"] == "bfloat16" else "")
        r["launches_phase9"] = {"recalibration": s9["launches"][key],
                                "oracle CLIs": sum(d9[k]["launches"][key] for k in (
                                    "teacher validate", "teacher finetune", "ofa oracle"))}
    mesh_runs = p8["two_ranks"]
    apply_launches = {}
    for name in ("bn_forward_from_sums", "bn_backward_from_sums"):
        apply_launches[name] = mesh_runs["f32"]["launches_per_rank"][0][name]
        apply_launches[name + "_bf16"] = mesh_runs["bf16"]["launches_bf16_per_rank"][0][name]
    apply_rows = [r for dtype in (torch.float32, BF16)
                  for r in apply_kernel_numbers(g, apply_launches, p8["nccl_world_1"]["errs"],
                                                dtype)]
    for r in apply_rows:
        r["all_reduce_ms_per_bn_nccl_world_1"] = p8["nccl_world_1"]["all_reduce_ms_per_bn"]
        print("  %-20s %d launches (rank 0 of 2)  %.4f ms/step  plain %.4f  bound %.4f (%s)"
              % (r["name"], r["launches"], r["ms"], r["plain_ms"], r["bound_ms"],
                 r["bound_by"]), flush=True)
    for r in apply_rows:
        key = r["name"].split()[0] + ("_bf16" if r["dtype"] == "bfloat16" else "")
        r["launches_phase9"] = {"recalibration": s9["launches"][key],
                                "oracle CLIs": sum(d9[k]["launches"][key] for k in (
                                    "teacher validate", "teacher finetune", "ofa oracle"))}
    rows += apply_rows
    # phase 8 (e)'s counted windows under the NCCL world-1 mesh and in one
    # process beside them (each distinct pass counted at its eager first run
    # and capture), and the apply entry points' errors with the active width
    w1 = p8["nccl_world_1"]
    windows8 = {"S4 window %s, %s" % (dt, label): run["launches"]
                for dt in ("f32", "bf16") for label, run in w1["mesh_window_" + dt]["runs"].items()}
    windows8.update({"MBV3 window bf16, %s" % label: run["launches"]
                     for label, run in w1["mesh_cls_window_bf16"].items()})
    row_wrapper = {id(r): w for r, w in zip(rows[2:8], ("bn_forward", "col_sums2",
                                                        "bn_backward") * 2)}
    for r in rows:
        base = row_wrapper.get(id(r), ROW_WRAPPER.get(r["name"], r["name"].split()[0]))
        bf16 = r.get("dtype") == "bfloat16" and base not in ("mbconv", "shuffle_tail")

        def of_type(counts, wrapper, bf16=bf16):
            return counts.get(wrapper + "_bf16", 0) if bf16 else (
                counts.get(wrapper, 0) - counts.get(wrapper + "_bf16", 0))

        r["launches_phase8_mesh_window"] = {w: of_type(c, base) for w, c in windows8.items()}
        if base == "bn_backward":  # its pass 1 under the mesh counts under bn_bwd_sums
            r["launches_phase8_mesh_window_bn_bwd_sums"] = {
                w: of_type(c, "bn_bwd_sums") for w, c in windows8.items()}
        if base in ("bn_forward_from_sums", "bn_backward_from_sums"):
            r["max_abs_err_active_mesh"] = w1["errs"][base + "_active" + ("_bf16" if bf16
                                                                          else "")]
    # phase 10's counted runs: the export phase's kernel frames (and their
    # checks and timings), the classification nets' train-mode forwards
    # (float32 only), the tutorial (training, evaluation, deployment)
    e10, t10 = p10["export"]["launches_all"], p10["tutorial"]["launches"]
    for r in rows:
        key = ROW_WRAPPER.get(r["name"], r["name"].split()[0])
        key += "_bf16" if r.get("dtype") == "bfloat16" and key not in ("mbconv",
                                                                      "shuffle_tail") else ""
        r["launches_phase10"] = {"export frames": e10.get(key, 0),
                                 "classification": p10["cls_launches"].get(key, 0),
                                 "tutorial": t10.get(key, 0)}
    # phase 11's counted runs: the classification trainer's kernel-path steps
    # (both families, both envelopes, float32 and bf16), the CLI runs, the
    # real-data epochs
    c11, d11, t11 = {}, {}, dict(p11["trainer_launches"])
    for src, dst in ((p11["clis"], c11), (p11["real_data"], d11)):
        for run in src.values():
            for k, v in (run.get("launches") or {}).items() if isinstance(run, dict) else ():
                dst[k] = dst.get(k, 0) + v
    for d in (t11, c11, d11):  # a wrapper's count holds its bf16 launches too
        for k in [k for k in d if k + "_bf16" in d]:
            d[k] -= d[k + "_bf16"]
    for r in rows:
        key = ROW_WRAPPER.get(r["name"], r["name"].split()[0])
        key += "_bf16" if r.get("dtype") == "bfloat16" and key not in ("mbconv",
                                                                      "shuffle_tail") else ""
        r["launches_phase11"] = {"trainer": t11.get(key, 0),
                                 "clis": c11.get(key, 0), "real data": d11.get(key, 0)}
    # phase 12's counted runs: the curriculum's CLI runs (training only: its
    # evaluations launch nothing), the demo's (its table and deployments'
    # timed calls, counted at capture, and its recalibration)
    c12, d12 = p12["curriculum"]["launches"], p12["demo"]["launches"]
    for r in rows:
        key = ROW_WRAPPER.get(r["name"], r["name"].split()[0])
        key += "_bf16" if r.get("dtype") == "bfloat16" and key not in ("mbconv",
                                                                      "shuffle_tail") else ""
        r["launches_phase12"] = {"curriculum": c12.get(key, 0), "demo": d12.get(key, 0)}
    # the BN kernels at the classification step's extreme shapes (phase 11)
    for rows_, dname in ((bn_rows, "f32"), (bn_rows_bf16, "bf16")):
        for r, kname in ((rows_[0], "bn_forward"), (rows_[2], "bn_backward")):
            r["cls_shapes_phase11"] = {
                fam: [dict({"shape": s["shape"]}, **{k: s[kname][k] for k in (
                    "ms_per_launch", "plain_ms_per_launch", "library_ms_per_launch",
                    "bound_ms_per_launch")}) for s in rec["bn_shapes"][dname]]
                for fam, rec in p11["trainer"].items()}
    # phase 13's counted runs: the graphed path through entry.train (each
    # distinct pass counted at its eager first run and at its capture; the
    # replays launch without the wrappers), and the masked-operand errors
    # of phase 2
    for r, name in zip(rows[2:8], ("bn_forward", "col_sums2", "bn_backward") * 2):
        bf16 = r["dtype"] == "bfloat16"
        key = name + ("_bf16" if bf16 else "")
        main13 = p13["main_path_bf16" if bf16 else "main_path"]
        r["launches_phase13"] = {"graphed, counted at first run and capture": sum(
            run["launches"][key] for run in main13.values())}
        if name != "col_sums2":
            r["max_abs_err_active"] = errs[name + "_active" + ("_bf16" if bf16 else "")]
    for r in rows[8:]:
        r["launches_phase13"] = {"graphed, counted at first run and capture": 0}
    for r in rows[:2]:
        r["launches_phase13"] = {"graphed (training: the serving kernels are off it)": 0}
    # phase 14's counted runs: the classification run manager's graphed
    # epochs (the one pass key counted at its eager first run and capture),
    # and the elastic-resolution epoch (a pass key a size); the errors at
    # the classification step's masked BN shapes (phase 2, width 0 included)
    for r in rows:
        base = ROW_WRAPPER.get(r["name"], r["name"].split()[0])
        bf16 = r.get("dtype") == "bfloat16"
        main14 = p14["main_path_bf16" if bf16 else "main_path"]
        key = base + ("_bf16" if bf16 and base not in ("mbconv", "shuffle_tail") else "")
        r["launches_phase14"] = {
            "graphed, counted at first run and capture": sum(
                run["launches"].get(key, 0) for run in main14.values()),
            "elastic resolution": 0 if bf16 else p14["run_manager"]["elastic_resolution"][
                "launches"].get(key, 0)}
        if base in ("bn_forward", "bn_backward"):
            r["max_abs_err_active_cls"] = errs[base + "_active_cls" + ("_bf16" if bf16 else "")]
    dw_rows = dw_kernel_numbers(g, p13, errs) + dw_kernel_numbers(g, p13, errs, BF16)
    pw_rows = pw_kernel_numbers(g, p13, errs) + pw_kernel_numbers(g, p13, errs, BF16)
    rows[2]["route_note"] = ("takes every channel count; JAX switches its Pallas BN in only "
                             "for C % 64 == 0 (ofa_sr_tpu/ops/norm.py:76); the classification "
                             "nets' C 16-1280 run through it here")
    # last: a torch.profiler session leaves the launch path slower for the
    # rest of the process, so every timing above comes first, and the steps
    # are timed once more after the profiles to show by how much
    print("phase 6: device profiles", flush=True)
    profiles = [device_profile(*p, "frame") for p in profiles + x4_profiles]
    train_profiles = [device_profile(*p, "step") for p in train_runs_to_profile]
    p13["step_profiles"] = [device_profile(*p, "step", keep_rows=True) for p in graph_profiles]
    p14["step_profiles"] = [device_profile(*p, "step") for p in cls_graph_profiles]
    p11["step_profiles"] = [device_profile(*p, "step") for p in cls_profiles]
    by_path = {p["path"]: p for p in train_profiles}
    # the kernels' own device time in the kernel path's step of their type
    for rows_, path in ((bn_rows, "train kernels"), (bn_rows_bf16, "train bf16 kernels")):
        for r, names in zip(rows_, BN_ROW_KERNELS.values()):
            if not r["launches"]:  # off the path: not in the step's profile
                r["device_ms"] = None
                continue
            r["device_ms"] = sum(k["ms_per_step"] for k in by_path[path]["port_kernels"]
                                 if any(n in k["kernel"] for n in names))
            print("  %s: %.4f ms per step on the device (bound %.4f)"
                  % (r["name"], r["device_ms"], r["bound_ms"]), flush=True)
    for prof, (name, run, n, _) in zip(train_profiles, train_runs_to_profile):
        after = timed_steps(run, n)
        prof["ms_after_profiling"], prof["host_enqueue_ms_after_profiling"] = after
        print("  %s after the profiles: %.4f ms per step (CUDA events), host enqueue %.4f"
              % ((name,) + after), flush=True)
    # the masked depthwise's rows: their times at the graphed window's
    # shapes were taken with phase 6's others (below, before the profiles);
    # their device time a step from the graphed dw_switch step's profile
    by13 = {p["path"]: p for p in p13["step_profiles"]}
    for r in dw_rows:
        prof = by13["graphed dw_switch 1 subnet" + (" bf16" if r["dtype"] == "bfloat16"
                                                   else "")]
        r["device_ms"] = sum(k["ms_per_step"] for k in prof["port_kernels"]
                             if any(n in k["kernel"] for n in DW_ROW_KERNELS[r["wrapper"]]))
        print("  %s: %.4f ms per step on the device (bound %.4f)"
              % (r["name"], r["device_ms"], r["bound_ms"]), flush=True)
    rows += dw_rows
    # the masked 1x1's rows the same way, their device time a step from the
    # graphed expand_switch + dw_switch step's profile; the library's device
    # time a step (cuDNN's full-width 1x1 convs) from the graphed dw_switch
    # step's profile against it, device time against device time
    for r in pw_rows:
        sfx = " bf16" if r["dtype"] == "bfloat16" else ""
        prof = by13["graphed %s 1 subnet%s" % (PW_LABEL, sfx)]
        r["device_ms"] = sum(k["ms_per_step"] for k in prof["port_kernels"]
                             if any(n in k["kernel"] for n in PW_ROW_KERNELS[r["wrapper"]]))
        lib = cudnn_1x1_device_ms(by13["graphed dw_switch 1 subnet" + sfx], prof)
        r["library_device_ms"] = lib[r["wrapper"]]
        r["library_device_split_ms"] = lib
        r["library_ms_is"] = "one cuDNN call back to back, CUDA events (measure_shape)"
        r["library_device_ms_is"] = ("cuDNN's 1x1 kernels of this direction, device ms a step: "
                                     "phase 13's graphed dw_switch step profile less the "
                                     "expand_switch + dw_switch one")
        print("  %s: %.4f ms per step on the device (bound %.4f); cuDNN's full-width 1x1 %.4f "
              "on the device (other %.4f, busy difference %.4f)"
              % (r["name"], r["device_ms"], r["bound_ms"], r["library_device_ms"], lib["other"],
                 lib["busy_difference"]), flush=True)
    rows += pw_rows
    for prof in p13["step_profiles"]:
        prof.pop("rows", None)
    print("  phase 6 took %.1f s" % (time.perf_counter() - t_phase), flush=True)
    print("phase 10 (b): trace() around two kernel frames", flush=True)
    with tempfile.TemporaryDirectory(prefix="ofa_sr_trace_") as tmp:
        p10["trace"] = trace_check(dev, tmp)
    print(json.dumps({"kernels": rows, "frame_ms": frame_ms, "frame_profile": profiles,
                      "entry_ms": entry_ms, "train_runs": train_runs,
                      "train_runs_bf16": train_runs_bf16, "step_ms": step_ms,
                      "step_profile": train_profiles, "cli": cli, "x4": x4, "phase8": p8,
                      "search": p9, "phase10": p10, "phase11": p11, "phase12": p12,
                      "phase13": p13, "phase14": p14,
                      "build_s": build_s,
                      "mbconv_smem_bytes": mb_smem, "dw_masked_smem_bytes": dw_smem,
                      "pw_masked_smem_bytes": pw_smem,
                      "gpu": smi_line}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_main(sys.argv[2])  # one of phase 8's two ranks
    else:
        main()
