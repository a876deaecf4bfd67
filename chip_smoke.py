#!/usr/bin/env python3
"""Smoke test of makani_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--record PATH]

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the Hopper kernels from makani_tpu_torch/csrc/ into
     build/kernels/, one nvcc per source, all started together;
  3. each matmul kernel at the flagship SFNO's shapes, passes 3 and 1:
     against a float64 product on the card (5e-5 / 5e-2 relative, the bounds
     of tests/test_pallas_mm.py) and against its plain PyTorch twin
     (TWIN_TOL), timed with CUDA events beside the twin and one PyTorch
     library call (float32 bmm for legmm, complex64 matmul for dhconv_mm and
     dhconv_dw, TF32 off); and the fused Adam kernel over the flagship's 87
     parameter leaves (572.5 M elements, bf16 moments under stochastic
     rounding): one launch an update, bit-identical to its twin after 2
     steps, timed per full update (CUDA events; the same behind a spin
     kernel, the card's time alone; and the host's time to enqueue it)
     beside the twin and torch.optim.Adam(fused=True) on float32 state
     (context only: no PyTorch call rounds moments stochastically);
     and the bf16 GELU kernels, forward and gradient, at the blocks' MLP
     activation (1, 768, 240, 480) and the encoder's (1, 384, 721, 1440):
     bit-identical to their twins, timed at the second beside the twin and
     PyTorch's fused tanh-form GELU and its gradient on bf16; and the
     instance norm kernels, forward and backward, at the flagship's inner
     (1, 384, 240, 480) and full (1, 384, 721, 1440) grids and AFNO v2's
     (1, 768, 90, 180) in bf16: within one bf16 ulp of their twins (the
     eager chain, the closed-form backward), timed beside them and
     F.instance_norm with its autograd backward;
  4. the flagship_synth_drive_bare SFNO at full width (73 channels on
     721x1440, embed 384, 8 blocks, random weights from a seed): one forward
     through the kernels with its launch counts, against one through the plain
     twins (FORWARD_TOL); and a 3-block SFNO at 36x72 on the card against the
     same weights on the CPU (SMALL_TOL);
  5. the serving path: an Inferencer lite rollout of 4 steps at batch 1,
     one untimed (it pays the page-locked host buffer and cuBLAS's set-up),
     then 3 timed: the median ms per step and all three, kernel launch
     counts read around the first timed one, finite outputs, and the peak
     device memory of the phase;
  6. the training path: a Trainer of flagship_synth_drive_bare on synthetic
     data (fused Adam, checkpointing 0, no validation or checkpoints) runs
     one epoch of 3 steps at batch 1 with finite losses and its launch
     counts per step asserted (36 legmm, 36 gridmm, 16 dhconv_mm, 8 dhconv_dw, 1
     fused_adam); the train step timed on a resident batch (median of 3
     after a warm-up) with its peak device memory; the full-width gradients
     through the kernels against those through the twins (FORWARD_TOL per
     leaf), and a 3-block SFNO's gradients on the card against the same
     weights and batch on the CPU (SMALL_TOL per leaf);
  7. the complex coefficient engine ("xla", makani_tpu's default) with the
     complex dhconv kernel on (complex_ops.enable_pallas_kernels), at full
     width: the kernel at x (1, 384, 240, 241) and w (384, 384, 240)
     complex64, forward and dx (conj(w) transposed), passes 3 and 1, against
     its twin (TWIN_TOL) and float64 (F64_TOL), timed beside the twin and a
     complex64 torch.matmul batched over l; one flagship forward (8
     dhconv_complex launches, no other matmul kernel) against the same
     weights on the "kernel" engine and on "xla" without the kernel
     (FORWARD_TOL); 4-step Inferencer rollouts timed as in phase 5; a
     Trainer epoch of 3 steps with coefficient_engine "xla" (16
     dhconv_complex and 1 fused_adam launch per step), its step time and
     peak memory, and its full-width
     gradients against the kernel engine's (FORWARD_TOL per leaf). The
     engine, precisions and kernel toggle are restored afterwards;
  8. the kernel-benchmark and probe path: gridmm at the flagship longitude
     DFT's shapes (analysis 276,864 x 1440 @ 1440 x 482 with a bf16 x at 2
     passes and a float32 x at 3 and 1; synthesis 276,864 x 482 @ 482 x 1440
     at 3 passes to float32 and to bf16; the inner-grid pair with K or N 480)
     and grid_dot at tools/bench_gridmm.py's shapes, against float64 and
     their twins, timed beside the twin, a float32 torch.mm (TF32 off) and a
     bf16 torch.mm with float32 sums; the seven probe kernels at
     scripts/pallas_isolate.py's shapes against their twins (probe_copy bit
     for bit, and the two dot probes bit for bit with the fused
     multiply-adds in order of c, read from the reference chain,
     kernel_isolate.dot_chain), timed beside one PyTorch call each, with
     CUDA events around a call (the host's launch path, at these few-KB
     inputs) and the host's enqueue of a call (tools/launch_path.py), three
     rounds, the probe and its call interleaved, all before any profiler
     session; then on the device (torch.profiler's kernel records over
     kernel_isolate.DEVICE_REPS calls, three times for each probe and each
     call, the median kept and the spread printed beside probe_copy's device
     time, the launch floor), and the enqueue once more after those
     sessions; then the three tools end
     to end
     (tools/bench_spectral_mm.py all, tools/bench_gridmm.py,
     tools/kernel_isolate.py: nine PASS), each returning 0, with the launches
     of every kernel counted over them and asserted;
  9. bf16 AMP at full width (amp_mode "bf16", precision "default": every
     kernel launch at 1 bf16 pass, checked by kernels.launches_by_passes;
     cuBLAS's bf16 reduced-precision reductions off): one forward through the
     kernels (18 legmm, 18 gridmm, 8 dhconv_mm, 18 gelu_bf16, 16
     instance_norm_fwd, no norm on the eager path), its deviation from one
     through the twins and from phase 4's float32 forward of the same
     weights and input, both below AMP_DEV_MAX; every legmm, dhconv_mm and gridmm
     call of an AMP forward against its twin on the same inputs (TWIN_TOL);
     each block and the decoder on the kernels' own input to it, kernels
     against twins below BLOCK_SHARE of the twins' own AMP deviation from
     float32 there; a 4-step
     Inferencer lite rollout timed as in phase 5 with its peak memory; a
     Trainer epoch of 3 steps with finite losses and phase 6's launch counts
     per step, plus 18 gelu_bf16 and 18 gelu_bf16_grad and 16 instance_norm_fwd
     and 16 instance_norm_bwd (no eager norm); the train step timed
     on a resident batch with its peak memory; on the "xla" engine with its
     kernel, one forward (8 dhconv_complex) and one train step (16
     dhconv_complex, 1 fused_adam), then that step timed (median of 3). The
     engine, precisions, kernel toggle and cuBLAS setting are restored
     afterwards;
 10. inputs from files at full width: flagship_synth_drive, all its
     auxiliary channels (zenith, the 16-frequency sinusoidal grid on the
     data's lat/lon, orography, the land-sea mask: 109 input channels).
     tools/make_synthetic_dataset.py writes 73 AR channels at 721x1440 as npy
     shards into build/chip_smoke_files/ (4 train and 7 test samples, about
     3.6 GB with the stats; removed at the end of the phase), and the
     invariant fields as .npy (no h5py on the path); every train sample read
     through get_dataloader and the native reader equals the shard read
     directly, normalized the same way, with zenith from cos_zenith_angle,
     bit for bit, and one loader epoch is timed (samples/s, GB/s); a Trainer
     under bf16 AMP (AdamW, beta2 0.95, bf16 moments) runs one epoch of 3
     steps from the files under the profiler (CUDA activity only): finite
     losses, phase 9's launch counts per step, the epoch's wall time, the
     mean step with the loader in the loop beside phase 9's resident-batch
     step, the share of the epoch the card was idle, peak memory; an
     Inferencer on the evaluation files: a float32 forward of the
     109-channel model on the first evaluation sample through the kernels
     against the twins (FORWARD_TOL), and a capture rollout of 5 steps
     (valid_autoreg_steps 4) with zenith from the targets' times, timed as in
     phase 5, finite, with its launches and peak memory. Its cuts against
     flagship_synth_drive (FILES_CUTS) are printed, one a line;
 11. checkpoints, scoring and packages on phase 10's dataset and model
     (float32 at "high"): (a) the trained model and its AdamW state (bf16
     moments) saved with utils/checkpoint.save_checkpoint into
     build/chip_smoke_files/ckpt and restored into a fresh model and state,
     every tensor and the counters bit for bit, with the bytes, seconds and
     GB/s each way; (b) an Inferencer restored from that checkpoint scores
     the evaluation files (score_model, n_eval_samples 2 at
     valid_autoreg_steps 4): finite logs, ACC and RMSE curves of (73, 5), the
     four npy exports, the same scoring through the twins within
     FORWARD_TOL, 18 legmm, 18 gridmm and 8 dhconv_mm launches a scored step, all at 3
     passes, the ms a scored step (score_model's wall, and a metrics
     rollout on a resident batch) and the peak memory; (c)
     inference_single with metrics and data, inference_lite with two
     channels perturbed (the IC plus RandomState(42)'s draws, bit for bit)
     and a third persisted (equal to its IC at every step, bit for bit), and
     predict, all finite; (d) `python3 -m makani_tpu_torch.inference --mode
     epoch` in a subprocess from a YAML the phase writes: exit 0, exports
     within TWIN_TOL of (b)'s; (e) a model package (save_model_package, the
     model alone as best_ckpt, .npy invariants) through load_time_loop for 3
     steps, each within FORWARD_TOL of the twins, with its launches and ms a
     step. The checkpoint is taken between phase 10's training and serving
     halves; the dataset (3.6 GB), the checkpoint (4.6 GB) and the package
     (2.3 GB) are removed at the end of the phase.
 12. the full Trainer through the train CLI, on phase 10's dataset, after
     phase 11's checkpoint and package are removed (the free disk is checked
     first, and the phase fails with the shortfall): the canonical recipe
     sfno_linear_73chq_sc3_layers8_edim384_wstgl2 at full width (109 input
     channels, the temp-std loss with auto channel weights, AdamW beta2 0.95
     with bf16 moments, StepLR) under bf16 AMP, cut as TRAIN_CUTS lists, from
     a YAML the phase writes. (a) makani_tpu_torch.train.main(...,
     "--amp_mode", "bf16", "--profile", "2") in-process, 2 epochs with
     validation and save_checkpoint "flexible": finite training and
     validation losses each epoch, the lr of epoch 2 half that of epoch 1,
     per-epoch checkpoints {1, 2} (keep 2) and the best one, counters iters 6
     and epoch 2, a torch.profiler trace of the first 2 steps that names
     legmm and dhconv_mm, and the launches of the run: 6 AMP train steps at
     phase 9's counts and 20 validation AR steps at 18 legmm, 18 gridmm, 8 dhconv_mm
     and 18 gelu_bf16 each, all at 1 pass; a validation AR step timed on a
     resident batch (median of 3 rollouts) with its launches; (b) the same
     main with max_epochs 3 resumes from epoch 2: before its epoch runs, the
     restored weights, bf16 moments, counters, scheduler and generator state
     equal (a)'s bit for bit; it runs epoch 3 alone (iters 9, steps {2, 3} on
     disk, the lr a quarter of epoch 1's); (c) `python3 -m
     makani_tpu_torch.train --mode test` in a subprocess on the same YAML:
     exit 0 and "0 errors". Each epoch's wall, train and validation seconds,
     each save's bytes, its synchronous copy and its background write beside
     the waits that exposed it, the loader-wait fraction and the peak memory
     are printed on [trainer ...] lines.
 13. the SFNO recipes of config/icml_models.yaml at full width (73 channels
     on 721x1440, embed 384, 8 blocks, scale factor 2 to a 360x720
     Legendre-Gauss grid, 180 degrees and orders) on phase 10's dataset,
     under bf16 AMP through makani_tpu_torch.train.main, cut as ICML_CUTS
     lists, after phase 12's checkpoints are removed: (a) the pretrain
     sfno_dhealy_73ch, one epoch of 2 steps, writing its per-epoch
     checkpoint; (b) sfno_dhealy_73ch_2step with --multistep_count 2,
     finetuning from (a)'s checkpoint (its weights checked before the epoch
     runs, its optimizer fresh), at the lowest checkpointing level that fits
     (ICML_LEVELS); (c) sfno_nonlinear_73ch (the non-linear filter), 3 steps;
     (d) (a)'s model with dropout at 0.1 at every site and checkpointing 3:
     each site's kept fraction within 5 sigma of 0.9, and a small non-linear
     SFNO with dropout whose gradients at checkpointing 0 and 3 are
     bit-equal; each run's finite losses, its launches (a step's of
     icml_launches, the 2-step unroll twice a one-step step's forward and
     backward), all at 1 pass, its peak memory, and for (a)-(c) a train
     step on a resident batch; (e) one LAMB update (bf16 moments) and one
     AdamW update (float32 moments), both clipped by the global norm, over
     (a)'s 87 leaves: the kernel's new modes against their twin, bit for
     bit, one launch an update, each timed (CUDA events, the card's time
     alone, and the host's time to enqueue it) beside the plain mode,
     torch.optim.Adam(fused=True), and the clipped AdamW update as PyTorch
     computes it (clip_grad_norm_(foreach=True), then
     torch.optim.AdamW(fused=True)); the bounds count the clip's read of g
     and LAMB's trust-ratio passes;
     (f) legmm, dhconv_mm (forward, dx) and
     dhconv_dw at the ICML shapes against float64 and their twins, with
     phase 3's bounds, timed as phase 3 times them.
 14. the planar FNO recipes and the SFNO model options at full width, on
     phase 10's dataset under bf16 AMP, cut as ICML_CUTS and FNO_CUTS list:
     (a) fno_linear_73ch (embed 64, the diagonal filter on 180 x 180 FFT
     modes, 2.12 B parameters) and (b) fno_nonlinear_73ch (SpectralAttention
     on the FFT coefficients) through train.main at the lowest checkpointing
     level that fits (FNO_LEVELS), 2 steps each: finite losses, the launches
     (fno_launches: the GELU kernels and one fused_adam a step), a train step
     on a resident batch with its peak memory, then a 4-step Inferencer
     rollout of the trained model timed as in phase 5; (c) at
     sfno_dhealy_73ch's width: scan_layers through train.main (37 leaves, the
     6 middle blocks' weights stacked and recomputed in backward: the
     launches of a level-0 step plus 12 legmm, 6 dhconv_mm and 12 gelu_bf16),
     a train step timed; the "direct" and "frequency" position embeddings and
     the layer norm, one float32 forward each at 3 passes against the twins
     (FORWARD_TOL); a CP-factorized dhconv filter on the "xla" engine with
     the complex dhconv kernel under AMP, a forward and backward with 16
     dhconv_complex launches at 1 pass and the forward against the complex
     einsum (AMP_DEV_MAX); the csphase=False SHT pair at the ICML grids
     through legmm at 3 passes against float64 (5e-5); (d) fused_adam over
     (a)'s leaves with float16 moments, bit-identical to its twin after 2
     updates, then one update each with float16, bf16 (stochastic rounding)
     and float32 moments timed beside its bound and
     torch.optim.Adam(fused=True); a Trainer of sfno_dhealy_73ch with float16
     moments (2 steps); Adafactor and SGD with momentum, 2 updates on the
     card against the same chain on the CPU (SGD bit for bit, Adafactor
     within OPT_TOL).
 15. the other model families at full width on phase 10's dataset (73
     channels cropped to 720x1440 as the configs ask, patch 8x8: 90x180 =
     16,200 tokens, embed 768, 12 layers, MLP ratio 4), cut as AFNO_CUTS
     lists: config/afnonet.yaml's afno_v2 (8 AFNO blocks) and afno_backbone
     (AFNO v1) and config/vit.yaml's vit_backbone (12 heads of 64, the
     blockwise attention) through train.main, each (a)-(c) float32 as its
     YAML says, 2 steps, and (d) under bf16 AMP, 1 step: finite losses, the
     launches (one fused_adam a step over 136, 148 and 150 leaves; under AMP
     AFNO v2's 12 gelu_bf16 and 12 gelu_bf16_grad a step, none for the
     others, whose flax-style norms and dense layers compute in float32;
     AFNO v2's 24 instance_norm_fwd and 24 instance_norm_bwd a step, float32
     and AMP, and 24 instance_norm_fwd a rollout step, no norm eager), a
     train step on a resident batch with its peak memory, and a 4-step
     Inferencer rollout of the trained model timed as in phase 5; a
     PrecipNet over an AFNO v1 of afno_backbone's widths, forward and
     backward on the card against the same weights on the CPU (SMALL_TOL);
     one ViT layer's attention at (1, 12, 16200, 64) against float64 on
     ATTN_ROWS rows, timed beside F.scaled_dot_product_attention (a
     comparison, never on the path).
 16. the rollout videos on phase 10's dataset: sfno_dhealy_73ch at full width
     through makani_tpu_torch.train.main under bf16 AMP, cut as VIDEO_CUTS
     lists, 2 train steps, then validation (FILES_EVAL samples of
     FILES_AUTOREG + 1 AR steps) with log_video 10 as the YAML sets it, so
     epoch 0 renders the first batch's one-step comparison of channels :2
     and its channel-0 rollout video (utils/visualize, spawned workers, on
     the host): the launches (the train steps' of icml_launches, then 18
     legmm, 8 dhconv_mm and 18 gelu_bf16 for each of the validation's
     forwards: every AR step and the comparison's), all at 1 pass; the
     epoch's train, validation and visualization seconds and the peak
     memory; every captured frame (721x1440) equal to the prediction and
     target its AR step scored, bit for bit; the validation logs equal those
     of a validation that does not render, bit for bit; the AVI's header
     (FILES_AUTOREG + 1 frames of 2 x 1440 + 4 by 721) and the PNG's size.
     The host packages are checked first: without matplotlib or PIL a
     `[videos cut]` line names the missing one, the renderer is replaced by
     one that records what it is given, and the card runs the same work.
 17. data and spatial parallelism (makani_tpu_torch/parallel): ranks
     spawned from this process, each rank a process with the kernels this
     process built (kernels.load_built) on the card. One card: the ranks
     share it, and their collectives run on gloo, staged through host
     memory (NCCL refuses two ranks on one device); a card a rank would take
     NCCL. The backend chosen is printed. (a) flagship_synth_drive_bare at
     full width and depth, float32, on h 2 x w 2 (4 ranks): a 1-step rollout
     of each rank's (361 or 360, 720) patch against the serial rollout of
     the same weights on the card (PARALLEL_SERVE_TOL of each step's largest
     magnitude), with each rank's legmm and dhconv_mm launches, step ms and
     bytes sent; (b) the same model cut to PARALLEL_TRAIN_LAYERS blocks under
     bf16 AMP on data 2 x h 2 (4 ranks, global batch 2), PARALLEL_TRAIN_STEPS
     optimizer steps through fused_adam on each rank's shards, against the
     serial Trainer at batch 2 on the card at the same checkpointing level
     (PARALLEL_LEVEL): the losses (PARALLEL_LOSS_TOL) and every leaf's
     update over the steps (norm-wise, PARALLEL_UPDATE_TOL at
     the worst leaf and PARALLEL_UPDATE_MEDIAN_TOL at the median),
     with each rank's launches of legmm, dhconv_mm, dhconv_dw and
     fused_adam, peak memory, bytes sent and its epoch's ms a step; (c)
     legmm at M2 = 242 and 240 (a rank's m-slice of 241 orders over w 2)
     over K = 721 and 240 with 192 channels, and dhconv_mm / dhconv_dw on
     120 degrees and 121 or 120 orders, against float64 and their twins with
     phase 3's bounds, and fused_adam on the second h rank's shard of a
     dhconv weight (bf16 moments, stochastic rounding, the whole leaf's
     indices from the shard's first one) bit for bit against its twin and
     the whole leaf's update; the control of (b), run by the same ranks
     after it, drops the spatial sum of the replicated leaves' gradients and
     must read above its bounds; (e) and (f), run by (a)'s ranks after it,
     each model freed first: the flagship held in a class registered from a
     file (FILE_CLASS, written under PARALLEL_DIR) that sets no
     spatially_parallel, built by get_model from its "path.py:FileSFNO"
     nettype, so each rank gathers the whole field, runs the class on it
     with the model axes serial and keeps its patch: (e) at full depth, a
     1-step float32 rollout against (a)'s serial steps (PARALLEL_SERVE_TOL)
     with each rank's launches (the serial forward's 18 legmm, 18 gridmm and
     8 dhconv_mm), bytes sent, step ms and peak; (f) at
     PARALLEL_TRAIN_LAYERS blocks, float32, checkpointing FILE_CLASS_LEVEL,
     the gradients of mean(y**2) over the whole output reduced as the
     Trainer reduces them, every leaf whole, against the serial gradients
     of the same weights, both held against the serial ones at "highest"
     (float32): each leaf of the ranks within FILE_CLASS_GRAD_FACTOR times
     the serial run's deviation plus TWIN_TOL, the ranks' partial gradients
     before the spatial sum (the control) above it, with 18 legmm, 18 gridmm, 6
     dhconv_mm (the blocks recomputed in backward) and 2 dhconv_dw a rank;
     the ranks take their backward in turn, since four at once do not fit
     the card. These times are not the
     port's speed on several cards: gloo moves the transposes through the
     host.
 18. channel (tensor) parallelism over fin and fout, the ranks sharing the
     card over gloo as in phase 17, cut as TP_CUTS lists: (a)
     flagship_synth_drive_bare at full width, TP_SERVE_LAYERS blocks,
     float32, the "kernel" engine, on fin 2 x fout 2 (4 ranks, each holding
     makani_tpu's
     shards of the split leaves): a 1-step rollout against the serial one
     (PARALLEL_SERVE_TOL), each rank's legmm and dhconv_mm launches, bytes
     sent a step, step ms and peak; (b) bf16 AMP training on h 2 x fin 2 at
     depth TP_TRAIN_LAYERS, TP_TRAIN_STEPS optimizer steps against the serial
     Trainer: losses and every leaf's update (phase 17's bounds), each
     rank's launches of legmm, dhconv_mm, dhconv_dw, fused_adam and the GELU
     kernels, and a control run by the same ranks after it, with the fin sum
     of the filter's contraction dropped, which must read above the bounds; (c) the kernels at a fin rank's shapes: legmm on 192
     channels (full and inner grid), dhconv_mm x (2, 1, 240, 192, 241) with
     w (2, 240, 192, 384) forward and dx, dhconv_dw into (2, 240, 192, 384),
     the complex kernel 192 -> 384, against float64 and their twins with
     phase 3's bounds, and fused_adam on a (fout, fin) block of a flagship
     MLP weight and a fin shard of a dhconv weight, bit for bit against its
     twin and the whole leaf's update, the control with base 0 differing;
     (d) vit_backbone and afno_v2 at full width, depth TP_FAMILY_LAYERS, on
     fin 2 x fout 2: one float32 forward each against the serial forward
     (PARALLEL_SERVE_TOL).
 19. the last modules on spatial ranks, the ranks sharing the card over gloo
     as in phase 17, one spawn for all of (a)-(d), cut as SP_CUTS lists: (a)
     fno_linear_73ch at full width and depth (2.12 B parameters, a quarter
     of each diagonal filter a rank, the ranks building the model in turn)
     on h 2 x w 2, float32, a 2-step rollout against the serial one
     (PARALLEL_SERVE_TOL), each rank's bytes sent, step ms and peak; (b) its
     bf16 AMP Trainer at depth SP_TRAIN_LAYERS on h 2 x w 2, 2 steps against
     the serial Trainer (phase 17's bounds), fused_adam once a step on each
     rank's leaves, its (h, w) blocks of the filters among them, the GELU kernels launched, and
     a control with the spatial sum of the replicated leaves' gradients
     dropped, which must read above the bounds; (c) afno_v2, afno_backbone
     inside PrecipNet (its periodic pad a halo exchange) and vit_backbone at
     full width, depth SP_FAMILY_LAYERS: one float32 forward each against the
     serial forward (PARALLEL_SERVE_TOL); (d) the distributed FFT2 pair at
     the FNO's full and inner grids against serial cuFFT (SP_FFT_TOL); and
     in this process fused_adam on an (h, w) block of the FNO's filter, bit
     for bit against its twin and the whole leaf's update, the control with
     base 0 differing; (e) InstanceNorm2d's "bf16" statistics: the
     flagship's AMP forward at "bf16" against "f32" statistics, below AMP's
     own deviation from float32 in the run, with its launches of legmm,
     dhconv_mm and gelu_bf16, and one norm at NORM_SHAPE in bf16 timed at
     both modes.
 20. the SHT's grid stage (the longitude DFT and its inverse, gridmm through
     spectral_mm.griddot) at every precision mode, at the flagship's shapes
     (GRID_STAGE_SHAPES: the full-grid analysis of 276,864 rows of 1440, the
     full-grid synthesis into them, the inner pair of 92,160 rows at
     480/482): (a) each mode's stage forward and backward on the "kernel"
     engine against the "stacked" engine's twin on the same inputs
     (TWIN_TOL; a cotangent rounded to bf16 one bf16 ulp more) and against
     float64 (grid_f64_bound: 5e-5 at 3 passes or 2 on an
     operand exact in bf16, else 5e-2; half a bf16 ulp more where rounded;
     "highest" 1e-5), one gridmm launch each way at the mode's passes (none
     under "highest"), timed with CUDA events beside gridmm alone on
     row-major operands, the float32 torch.matmul the stage replaced and the
     transpose copy of the m-leading side that the kernel's layouts (a
     K-major x, a transposed output) spare; (b) one flagship forward on the "kernel" engine under
     each of the seven mode names: 18 gridmm and 18 legmm at the mode's
     passes (none under "highest"), its ms and its deviation from
     "highest"; (c) phase 9's AMP forward deviation from float32, below
     AMP_DEV_MAX.
The last two lines are the kernels' JSON record (the AMP path's launches in
each row's *_amp fields, phase 10's in *_files, phase 11's a scored step in
launches_score, phase 12's run (a) in launches_trainer and a validation AR
step in launches_valid_step, phase 13's (b) in launches_multistep, (c) in
launches_nonlinear and (e)'s LAMB update in launches_lamb, phase 14's in
launches_fno_linear, launches_fno_nonlinear, launches_scan,
launches_factorized, launches_csphase, launches_fp16_trainer and
launches_fp16_update, phase 15's in launches_afno_v2, launches_afno_v1,
launches_vit and their *_amp, phase 16's in launches_videos, phase 17's
per rank in launches_parallel_serve and launches_parallel_train, (e)'s and
(f)'s in launches_file_class_serve and launches_file_class_grad, and its
(c) row at a rank's local shape in parallel_local, phase 18's per rank in
launches_tp_serve and launches_tp_train, and its (c) row at a fin rank's
shape in tp_local, phase 19's per rank in launches_spatial_serve and
launches_spatial_train and (e)'s in launches_norm_bf16, fused_adam's (h, w)
block in spatial_local; gridmm's row also holds phase 8's tools' launches in
launches_tools and phase 20's grid stage in grid_stage; fused_adam's
row also holds its times at the linear FNO's 2.12 B elements for each moment
type) and the result line.
--record PATH also writes every measurement of the run to PATH as JSON.

TF32 is off for matmuls and cuDNN (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 = False): the float32 references, the
longitude DFT at "highest" and the 1x1 channel mixes run in full float32.
Serving precision is "high", i.e. 3 bf16 passes in the kernels, the
longitude DFT's gridmm included.
"""

import argparse
import datetime
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# kernel vs plain twin: the same bf16 operand parts and exact float32 products,
# summed in another order; the gap is a few ulps of the largest partial sum
TWIN_TOL = 1e-5
# vs a float64 product (tests/test_pallas_mm.py:27,56); 2 passes on a bf16 x
# split the table alone, as exact as 3
F64_TOL = {3: 5e-5, 2: 5e-5, 1: 5e-2}
# full-width forward, kernels vs twins: the per-contraction ordering gap
# (~1e-6) passes through 26 contractions and 16 instance norms
FORWARD_TOL = 1e-3
# small SFNO, card (kernels) vs CPU (twins): the same arithmetic, other
# summation orders in every matmul
SMALL_TOL = 1e-4

# published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor FLOP/s, and
# float32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# a bf16 output rounds the float32 sum once: up to half a bf16 ulp, 2**-8 of
# the element, on top of the product's own error
BF16_OUT = 2.0 ** -8

ROLLOUT_STEPS = 4
# timed rollouts of phases 5 and 7, after one untimed
ROLLOUT_REPS = 3
TRAIN_STEPS = 3
# timed runs of each line of the bench tools in phase 8
TOOL_REPS = 3
# phase 8: device times taken of each probe and its PyTorch call, the median kept
DEVICE_RUNS = 3
# launches per train step at checkpointing 0, read from the code: 18 forward
# Legendre contractions and their 18 transposes, and as many longitude DFTs
# (gridmm: the grid stage of each of the 18 transforms, forward and backward,
# at every precision mode but "highest"); 8 dhconv forwards, 8 dx and 8 dw;
# one fused Adam launch for all 87 parameter leaves (10 per block, 3 in the
# encoder and the decoder each, the residual transform)
TRAIN_LAUNCHES = {"legmm": 36, "gridmm": 36, "dhconv_mm": 16, "dhconv_dw": 8, "fused_adam": 1}
# on the complex engine with the kernel on: 8 forward contractions and their 8
# dx; dw is an einsum, and the Legendre contractions are float32 einsums; the
# longitude DFTs on gridmm as on the kernel engine
COMPLEX_FORWARD_LAUNCHES = {"dhconv_complex": 8, "gridmm": 18}
COMPLEX_TRAIN_LAUNCHES = {"dhconv_complex": 16, "gridmm": 36, "fused_adam": 1}
# bf16 AMP's forward against float32, norm-wise: makani_tpu/utils/trainer.py
# puts AMP's model-level deviation at ~1.5e-2; a deviation past this is a
# fault, not rounding
AMP_DEV_MAX = 5e-2
# under AMP, each block and the decoder on the kernels' own input to it:
# kernels against twins below this share of the twins' own AMP deviation
# from float32 on that input (the block's AMP rounding). Kernels and twins
# differ by float32 ulps (each call is held to TWIN_TOL on the path's own
# inputs), but the 1-pass operand roundings and the bf16 activations turn
# them into flipped bf16 roundings, and the MLP's dense mixes spread those:
# the blocks read 0.57-0.58 (PERF.md)
BLOCK_SHARE = 1.0
# the bf16 GELU kernels under AMP: 2 a block (after norm0, in the MLP), 1 in
# the encoder and the decoder each; the gradient as many in a train step
AMP_FORWARD_GELU = {"gelu_bf16": 18}
AMP_TRAIN_GELU = {"gelu_bf16": 18, "gelu_bf16_grad": 18}
# the instance norm kernels: 16 norms a flagship forward (norm0 and norm1 of
# 8 blocks), each one forward launch and one backward launch; no call takes
# the eager path ("f32" statistics, one card)
FORWARD_NORMS = {"instance_norm_fwd": 16}
TRAIN_NORMS = {"instance_norm_fwd": 16, "instance_norm_bwd": 16}
# phase 20: the SHT's grid stage at each precision mode, at the flagship's
# shapes (label, rows, nlon, mmax, analysis): the full grid 721 x 1440 of 384
# channels and the inner grid 240 x 480
GRID_STAGE_SHAPES = (("full analysis", 384 * 721, 1440, 241, True),
                     ("full synthesis", 384 * 721, 1440, 241, False),
                     ("inner analysis", 384 * 240, 480, 241, True),
                     ("inner synthesis", 384 * 240, 480, 241, False))
GRID_MODES = ("default", "split2", "tf32", "mixed", "mixed2", "high", "highest")
GRID_REPS = 5
# "highest", the float32 torch.matmul (TF32 off), against float64
GRID_HIGHEST_TOL = 1e-5
# the MLP's output bias feeds an instance norm, which removes it: its exact
# gradient is zero, and its rounding noise is measured against the largest
# gradient of the model instead of its own
ZERO_GRAD = "mlp.fc2.bias"
# phase 10: flagship_synth_drive from files, written into FILES_DIR (removed
# at the end of the phase): 4 train samples give 3 one-step windows, 7 test
# samples the 2 windows of n_eval_samples at valid_autoreg_steps 4
FILES_DIR = ROOT / "build" / "chip_smoke_files"
FILES_TRAIN_SAMPLES = 4
FILES_VALID_SAMPLES = 7
FILES_AUTOREG = 4
FILES_EVAL = 2
FILES_SHAPE, FILES_CHANNELS = (721, 1440), 73
FILES_CUTS = (
    "3 train samples (flagship_synth_drive: 63)",
    f"valid_autoreg_steps {FILES_AUTOREG} (19)",
    f"n_eval_samples {FILES_EVAL} (2)",
    "1 epoch (8)",
    "skip_validation: true and save_checkpoint: none (phase 11 checkpoints the trained "
    "model itself; phase 12 runs validation and the Trainer's checkpoints)",
    "checkpointing 0 (the drive's command line asks for level 2)",
    "orography and land-sea mask as .npy (.nc needs h5py, which this machine may lack)",
)
# the 109-channel encoder: 73 channels + zenith + 2x16 sinusoidal grid +
# orography + 2 land-sea mask classes
FILES_IN_CHANNELS = FILES_CHANNELS + 1 + 32 + 1 + 2
# phase 11: phase 10's model checkpointed into FILES_DIR and served from it
SERVE_CKPT = FILES_DIR / "ckpt"
SERVE_EXPORTS = ("acc_curves.npy", "rmse_curves.npy", "RMSE_over_time.npy",
                 "RMSE_over_space.npy")
# inference_lite: two perturbed channels (std), a third persisted
SERVE_PERTURBATION = {3: 0.5, 7: 0.25}
SERVE_PERSISTENCE = 11
SERVE_LOOP_STEPS = 3
# seconds for the inference CLI's subprocess, its kernel build included
CLI_TIMEOUT = 300
# phase 12: the canonical training recipe through the train CLI on phase 10's
# dataset, cut as TRAIN_CUTS lists
CANONICAL = "sfno_linear_73chq_sc3_layers8_edim384_wstgl2"
TRAIN_CONFIG = "chip_smoke_train"
TRAIN_DIR = FILES_DIR / "train_cli"
TRAIN_EPOCHS, TRAIN_KEEP = 2, 2
TRAIN_CUTS = (
    "data, stats and invariants of phase 10's dataset (invariants as .npy)",
    f"{FILES_TRAIN_SAMPLES - 1} train samples an epoch (n_train_samples_per_epoch 54000)",
    f"n_eval_samples {FILES_EVAL} (8760), valid_autoreg_steps {FILES_AUTOREG} (19)",
    "scheduler_step_size 1 (100), so the lr halves each epoch",
    f"checkpoint_max_to_keep {TRAIN_KEEP}",
    "checkpointing 0",
    f"{TRAIN_EPOCHS} epochs, then 1 more on resume (max_epochs 500)",
    f"experiment dir under {FILES_DIR.name}",
)
# a validation AR step: the forward's launches and its GELU under AMP
VALID_STEP_LAUNCHES = {"legmm": 18, "gridmm": 18, "dhconv_mm": 8, "gelu_bf16": 18}
# phase 13: config/icml_models.yaml's SFNO recipes on phase 10's dataset, cut
# as ICML_CUTS lists; runs under ICML_DIR
ICML_PRETRAIN = "sfno_dhealy_73ch"
ICML_FINETUNE = "sfno_dhealy_73ch_2step"
ICML_NONLINEAR = "sfno_nonlinear_73ch"
ICML_DIR = FILES_DIR / "icml"
# the lowest checkpointing level at which each run fits in 80 GB (H100, bf16
# AMP, batch 1): the 2-step unroll runs out of memory at level 0 and peaks
# near 60 GiB at level 2; the others fit at 0. The dropout run (d) is held at
# level 3, where every block is recomputed in backward
ICML_LEVELS = {ICML_PRETRAIN: 0, ICML_FINETUNE: 2, ICML_NONLINEAR: 0}
ICML_DROPOUT_LEVEL = 3
ICML_DROP_RATE = 0.1
# train steps an epoch: the linear runs 2 (the 2-step unroll's windows on
# 4 train samples), the non-linear one 3
ICML_STEPS = {ICML_PRETRAIN: 2, ICML_FINETUNE: 2, ICML_NONLINEAR: 3}
ICML_CUTS = (
    "batch_size 64 -> 1",
    "2 train steps an epoch (3 for the non-linear model), 1 epoch (max_epochs 60, 5 for the "
    "2-step finetune)",
    "data, stats and paths of phase 10's dataset",
    f"channel_names: the dataset's c0-c{FILES_CHANNELS - 1} (the ICML names are absent)",
    f"--skip_validation; n_eval_samples 320 -> {FILES_EVAL}, valid_autoreg_steps 20 -> "
    f"{FILES_AUTOREG}",
    "pretrained_checkpoint_path: (a)'s per-epoch checkpoint (the ICML path /runs/... is not "
    "in the repository)",
    "checkpointing_level: the lowest that fits in 80 GB (ICML_LEVELS), 3 for the dropout run",
)


# phase 14: config/icml_models.yaml's planar FNO recipes and the SFNO model
# options, on phase 10's dataset, cut as ICML_CUTS and FNO_CUTS list
FNO_LINEAR = "fno_linear_73ch"
FNO_NONLINEAR = "fno_nonlinear_73ch"
ICML_STEPS.update({FNO_LINEAR: 2, FNO_NONLINEAR: 2})
# the lowest checkpointing level at which each fits in 80 GB (H100, bf16
# AMP, batch 1; tools/checkpoint_levels.py): both fit at 0, the linear
# FNO's 2.12 B parameters with their gradients and float32 moments (34 GB)
# at 44.9 GiB, the non-linear one at 56.0 GiB
FNO_LEVELS = {FNO_LINEAR: 0, FNO_NONLINEAR: 0}
# the CP filter's rank, a fraction of the dense weight's parameters: the
# network's default 1.0 gives rank 27,993 on a (384, 384, 180) dhconv
# weight, whose rebuilt (384, 384, rank) complex intermediate would hold
# ~33 GB a block
OPTION_RANK = 0.01
# Adafactor on the card against the CPU: reductions summed in another order
OPT_TOL = 2e-5
FNO_CUTS = (
    "the ICML cuts above (batch 1, 2 train steps, 1 epoch, phase 10's data, no validation or "
    "videos)",
    f"checkpointing_level: the lowest that fits in 80 GB (FNO_LEVELS: {FNO_LINEAR} "
    f"{FNO_LEVELS[FNO_LINEAR]}, {FNO_NONLINEAR} {FNO_LEVELS[FNO_NONLINEAR]})",
    "--save_checkpoint none (fno_linear_73ch's checkpoint would hold ~25.5 GB)",
    f"the model options on {ICML_PRETRAIN}: scan_layers through train.main; the position "
    "embeddings and the layer norm as one float32 forward each; the CP dhconv filter at rank "
    f"{OPTION_RANK} as one AMP forward and backward",
    "Adafactor and SGD against the CPU over block 0's, the encoder's, the decoder's and the "
    "residual's leaves",
)

# phase 15: the other model families of config/afnonet.yaml and
# config/vit.yaml at full width on phase 10's dataset (73 channels, cropped to
# 720x1440 as both ask), cut as AFNO_CUTS lists; runs under FAMILY_DIR
AFNO_V2, AFNO_V1, VIT = "afno_v2", "afno_backbone", "vit_backbone"
FAMILIES = {AFNO_V2: ("afnonet.yaml", "AdaptiveFourierNeuralOperatorNet", 136),
            AFNO_V1: ("afnonet.yaml", "AdaptiveFourierNeuralOperatorNetV1", 148),
            VIT: ("vit.yaml", "VisionTransformer", 150)}
FAMILY_DIR = FILES_DIR / "families"
FAMILY_SHAPE = (720, 1440)
# train steps of the float32 run and of the AMP run
FAMILY_STEPS, FAMILY_AMP_STEPS = 2, 1
# AFNO v2 stays bf16 under AMP: one GELU a block each way (12 blocks)
FAMILY_AMP_GELU = {AFNO_V2: 12, AFNO_V1: 0, VIT: 0}
# instance norm kernel launches a forward (AFNO v2: norm1 and norm2 of 12
# blocks, float32 and AMP alike); AFNO v1 and the ViT use flax-style layer norms
FAMILY_NORMS = {AFNO_V2: 24, AFNO_V1: 0, VIT: 0}
# the PrecipNet check on the card against the CPU: afno_backbone's widths
# (73 channels, patch 8, embed 768, 8 blocks) on a 64x128 grid, 2 layers
PRECIP_SHAPE, PRECIP_LAYERS = (64, 128), 2
# the rows of the full-width attention held against float64
ATTN_ROWS = 256
AFNO_CUTS = (
    "batch_size 32 -> 1",
    f"{FAMILY_STEPS} train steps, 1 epoch (max_epochs 150); the AMP run "
    f"{FAMILY_AMP_STEPS} step",
    "--skip_validation (the YAMLs' log_video is 0)",
    "--save_checkpoint none",
    "data, stats and paths of phase 10's dataset; its channels c0-c72",
    f"PrecipNet: afno_backbone's widths on a {PRECIP_SHAPE[0]}x{PRECIP_SHAPE[1]} grid, "
    f"{PRECIP_LAYERS} layers (held against the CPU)",
)

# phase 16: phase 13's pretrain with its validation and the rollout videos
# its YAML asks for (log_video 10: epoch 0 renders), cut as VIDEO_CUTS lists;
# runs under VIDEO_DIR
VIDEO_DIR = FILES_DIR / "videos"
VIDEO_CUTS = (
    "phase 13's cuts: batch_size 64 -> 1, 2 train steps, 1 epoch (max_epochs 60), the data, "
    "stats, paths and channel names of phase 10's dataset",
    f"validation on: n_eval_samples 320 -> {FILES_EVAL}, valid_autoreg_steps 20 -> "
    f"{FILES_AUTOREG}",
    "--save_checkpoint none",
)
# the rollout video's frame: prediction | 4 black columns | target
VIDEO_SEPARATOR = 4


# phase 17: data and spatial parallelism of the SFNO on one card. The ranks
# share the card (NCCL refuses two ranks on one device), so they exchange
# over gloo, staged through host memory, while all their compute and kernels
# stay on the card; with a card a rank they would take NCCL.
PARALLEL_DIR = ROOT / "build" / "chip_smoke_parallel"
# (model_parallel_sizes [h, w, fin, fout], ranks): (a) h 2 x w 2, (b) data 2 x h 2
PARALLEL_SERVE = ([2, 2, 1, 1], 4)
PARALLEL_TRAIN = ([2, 1, 1, 1], 4)
# 1 rollout step: a second and a third (~9 s each on the ranks) were cut to
# leave the script's time to phase 19
PARALLEL_SERVE_STEPS = 1
# global batch 2 over 2 data ranks: 1 optimizer step from 2 samples (a second,
# ~12 s on the ranks in (b) and again in its control, was cut to leave the
# script's time to phase 19)
PARALLEL_TRAIN_STEPS = 1
PARALLEL_BATCH = 2
# (b)'s depth: 8 blocks cut to PARALLEL_TRAIN_LAYERS (width kept) to leave the
# script's time to phase 19; each of (b)'s two runs took ~80 s at 8 blocks
# and 2 steps
PARALLEL_TRAIN_LAYERS = 2
# checkpointing level 2, the lowest at which four ranks of (b) fit the card
# at full depth with the serial batch-2 reference's process (at level 0 a
# rank ran out of memory at 15.28 GiB of its own with the card full, H100
# 80GB HBM3); kept at the cut depth, so the ranks recompute in backward
PARALLEL_LEVEL = 2
PARALLEL_SEED = 17
# (a) each rank's patch of each step within PARALLEL_SERVE_TOL of the serial
# step's largest magnitude. The Legendre contraction on a rank is the serial
# one on a slice, but the longitude DFT and the 1x1 mixes run as cuBLAS
# float32 products of other shapes (a rank's rows), whose algorithms sum in
# other orders, and the instance norms' sums change order. On an H100 the
# first step reads 2.0e-5-2.3e-5, the ordering gap of one serial forward
# (phase 4's kernels against their twins: 2.84e-5, printed beside), and the
# gap grows through the rollout to 5.4e-5-5.7e-5 at the second step (and
# 1.53e-4-1.58e-4 at a third, when (a) ran 3); a wrong slice or transpose
# gives O(1)
PARALLEL_SERVE_TOL = 5e-4
# (b) the losses within 2e-3 relative (bf16 AMP, the sums of the norms and
# the loss in another order); the weights after 2 steps: each leaf's update
# (its change over the 2 steps) against the serial update, norm-wise, the
# worst leaf within PARALLEL_UPDATE_TOL and the median leaf within
# PARALLEL_UPDATE_MEDIAN_TOL. Adam's first steps are sign-like, so an
# element whose gradient is bf16 rounding noise takes a full step of either
# sign on either side: the updates differ by 0.099 at the median leaf and
# 0.227 at the worst, a norm's bias that starts at zero (on an H100). The
# control reruns (b) with one fault planted in the gradients' reduction,
# the spatial sum of the replicated leaves dropped (each h rank steps on its
# own half of the globe's gradient), and must read above both bounds: it
# read 0.707 at the median and 1.03 at the worst; each bound lies near the
# geometric mean of the two readings. The MLP's output bias, whose exact
# gradient is zero (an instance norm follows it), is checked finite only
# (ZERO_GRAD). The weights themselves are printed beside: 0.0033 norm-wise
# at the median.
PARALLEL_LOSS_TOL = 2e-3
PARALLEL_UPDATE_TOL = 0.5
PARALLEL_UPDATE_MEDIAN_TOL = 0.25
PARALLEL_TIMEOUT = 600
# (e) and (f): the flagship held in a class registered from a file
# (FILE_CLASS, written under PARALLEL_DIR), which sets no spatially_parallel:
# each rank gathers the whole field, runs the class on it with the model axes
# serial and keeps its patch (spmd.whole_field), in the spawn of (a), after
# it. (e) a 1-step float32 rollout at full depth against (a)'s serial steps
# (PARALLEL_SERVE_TOL); each rank runs the serial forward on the serial
# shapes, so its launches are the serial ones. (f) the gradients of
# mean(y**2) over the whole output at PARALLEL_TRAIN_LAYERS blocks, float32,
# checkpointing FILE_CLASS_LEVEL (every block recomputed in backward, with
# the model axes serial again), reduced as the Trainer reduces them,
# against the serial gradients of the same weights. Each rank backpropagates
# its own patch's share of the cotangent, so its kernels round other partial
# contractions than the serial run's, and the sum of the four partials
# differs from the serial gradient by two roundings at 3 bf16 passes, not
# by a reordered float32 sum. Both are held against the serial gradients at
# "highest" (float32 throughout, no kernel): every leaf of the ranks within
# FILE_CLASS_GRAD_FACTOR times the serial run's own deviation from them,
# plus TWIN_TOL (a leaf that no kernel reaches), each relative to the leaf's
# largest magnitude (the MLP's output bias, whose exact gradient is zero,
# against the largest of all: ZERO_GRAD). So the ranks are no less exact
# than one card. The control, each rank's partial gradients before the
# spatial sum, must fail the same bound
FILE_CLASS_GRAD_FACTOR = 2.0
FILE_CLASS = "FileSFNO"
FILE_CLASS_SOURCE = """
import inspect

import torch

from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet


class FileSFNO(torch.nn.Module):
    # the port's SFNO by composition: this class sets no spatially_parallel
    def __init__(self, device="cpu", generator=None, **kwargs):
        super().__init__()
        self.net = SphericalFourierNeuralOperatorNet(device=device, generator=generator, **kwargs)

    def forward(self, x, deterministic=True):
        return self.net(x, deterministic=deterministic)


# get_model passes the config's keys that the SFNO takes
FileSFNO.__init__.__signature__ = inspect.signature(SphericalFourierNeuralOperatorNet.__init__)
"""
# (f)'s level: at PARALLEL_LEVEL a rank's whole-field forward alone held
# 17.64 GiB, and the fourth ran out of memory (H100 80GB HBM3); at 3 a
# rank keeps only each block's input through the forward. The recomputed
# blocks launch their forward kernels again in backward: 18 legmm, 18
# gridmm and 6 dhconv_mm where level 2 launches 12, 12 and 4
FILE_CLASS_LEVEL = 3
FILE_CLASS_SERVE_LAUNCHES = {"legmm": 18, "gridmm": 18, "dhconv_mm": 8}
FILE_CLASS_GRAD_LAUNCHES = {"legmm": 18, "gridmm": 18, "dhconv_mm": 6, "dhconv_dw": 2}

# phase 18: channel (tensor) parallelism on one card, the ranks sharing it
# over gloo as in phase 17
TP_DIR = ROOT / "build" / "chip_smoke_tp"
# (model_parallel_sizes [h, w, fin, fout], ranks): (a) and (d) fin 2 x fout 2,
# (b) h 2 x fin 2 (tests/test_distributed.py:230's mesh without its data axis)
TP_SERVE = ([1, 1, 2, 2], 4)
TP_TRAIN = ([2, 1, 2, 1], 4)
# (a): 1 rollout step (a second, ~19 s on the ranks, was cut to leave the
# script's time to phase 19), at TP_SERVE_LAYERS blocks (8 cut to 2, width
# kept, likewise: the step moved ~9 GB a rank through the host at 8)
TP_SERVE_STEPS = 1
TP_SERVE_LAYERS = 2
# (b): 1 optimizer step at batch 1 (data 1; a second, ~12 s on the ranks in
# (b) and again in its control, was cut to leave the script's time to phase
# 19), depth cut to TP_TRAIN_LAYERS blocks (8 at full depth; width kept) to
# fit the script's time: gloo moves each block's all-reduces through the
# host; the lowest checkpointing level
TP_TRAIN_STEPS = 1
TP_TRAIN_LAYERS = 2
TP_LEVEL = 0
# (d): the ViT and AFNO v2 at full width (16,200 tokens of embed 768), depth
# cut to TP_FAMILY_LAYERS, one float32 forward each
TP_FAMILY_LAYERS = 2
TP_CUTS = (
    f"(a) flagship_synth_drive_bare at full width, num_layers 8 -> {TP_SERVE_LAYERS}, "
    f"{TP_SERVE_STEPS} rollout step",
    f"(b) num_layers 8 -> {TP_TRAIN_LAYERS}, optimizer steps 2 -> {TP_TRAIN_STEPS} at batch 1, "
    f"checkpointing {TP_LEVEL}",
    f"(d) vit_backbone depth 12 -> {TP_FAMILY_LAYERS}, afno_v2 num_layers 12 -> "
    f"{TP_FAMILY_LAYERS}, 73 channels in and out, random weights, one forward",
)
# (a) and (d): each rank's output (whole: the decoder's and the heads' sums
# are all-reduced) within PARALLEL_SERVE_TOL of the serial output's largest
# magnitude: the channel contractions sum their halves in another order, as
# phase 17's float32 products on a rank's rows do (its ordering gap: 2.8e-5
# at a rollout's first step, 1.6e-4 at its third); (b) phase 17's bounds
# (PARALLEL_LOSS_TOL, PARALLEL_UPDATE_TOL, PARALLEL_UPDATE_MEDIAN_TOL); its
# control drops the fin sum of the spectral filter's contraction (each fin
# rank keeps its own partial product) and must read above them


# phase 19: the last modules on spatial ranks (the FFT pairs, the planar FNO,
# AFNO v2, AFNO v1 with PrecipNet, the ViT) and InstanceNorm2d's "bf16"
# statistics; the ranks share the card over gloo as in phases 17-18, one
# spawn for (a)-(d)
SP_DIR = ROOT / "build" / "chip_smoke_spatial"
SP_SIZES = ([2, 2, 1, 1], 4)
SP_SERVE_STEPS = 2
# (b): fno_linear_73ch under bf16 AMP, depth cut to SP_TRAIN_LAYERS (8 at full
# depth; width kept), batch 1, SP_TRAIN_STEPS steps, checkpointing SP_LEVEL
SP_TRAIN_STEPS = 2
SP_TRAIN_LAYERS = 2
SP_LEVEL = 0
# (c): the families at full width (the 720x1440 crop, 16,200 tokens of embed
# 768), depth cut to SP_FAMILY_LAYERS, 73 channels in and out, PrecipNet's 1
SP_FAMILY_LAYERS = 2
SP_FAMILIES = (AFNO_V2, AFNO_V1, VIT)
SP_CUTS = (
    f"(a) {FNO_LINEAR} at full width and depth (73 channels, 721x1440, embed 64, 8 blocks, "
    f"180x180 modes), {SP_SERVE_STEPS} rollout steps, float32",
    f"(b) {FNO_LINEAR}, bf16 AMP, num_layers 8 -> {SP_TRAIN_LAYERS}, {SP_TRAIN_STEPS} steps at "
    f"batch 1 (64), checkpointing {SP_LEVEL}, synthetic data",
    f"(c) afno_v2, afno_backbone in PrecipNet and vit_backbone at full width, depth 12 -> "
    f"{SP_FAMILY_LAYERS}, 73 channels, random weights, one float32 forward each",
)
# (d): the FFT2 pair at the FNO's full and inner grids, 64 channels, 180x180
# modes, distributed against serial cuFFT: the coefficients and the round
# trip within SP_FFT_TOL of their largest magnitude. The distributed DFTs
# are float32 matmuls (TF32 off) of length 1440 and 721, cuFFT's sums are
# shorter: the gap is float32 rounding, ~1e-6; a wrong slice or move O(1)
SP_FFT_TOL = 1e-5
SP_FFT_GRIDS = ((721, 1440), (360, 720))
SP_FFT_CHANNELS, SP_FFT_MODES = 64, (180, 180)
# the FNO's diagonal filter (i, o, l, m, 2); a rank holds its (l/h, m/w)
# block, and fused_adam is checked on the block of the rank at h 1, w 1
SP_FILTER = (64, 64, 180, 180, 2)
SP_BLOCK = SP_FILTER[:2] + (SP_FILTER[2] // 2, SP_FILTER[3] // 2, 2)
# (e): InstanceNorm2d at a flagship block's shape, bf16
NORM_SHAPE = (1, 384, 240, 480)
# (a), (c): phase 17's PARALLEL_SERVE_TOL of the serial output's largest
# magnitude; (b): phase 17's bounds; (e): the "bf16" statistics' deviation
# from "f32" under AMP must read below AMP's own deviation from float32,
# both measured in the run


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps):
    """Median milliseconds of `fn` over `reps` runs, CUDA events around each."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops, rate=BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def dev_norm(got, ref):
    """Norm-wise deviation ||got - ref|| / ||ref|| over the whole tensor."""
    return float((got - ref).norm() / ref.norm())


def rel_err_c(got, ref):
    """rel_err for complex tensors, in complex128."""
    import torch
    return float((got.to(torch.complex128) - ref).abs().max() / ref.abs().max())


class _AnyCount:
    """Equal to any launch count: the instance norm kernels' count where a
    check does not name it."""

    def __eq__(self, other):
        return True

    def __repr__(self):
        return "any"


NORM_KERNELS = ("instance_norm_fwd", "instance_norm_bwd")


def launch_counts(kernels, expected):
    """`expected` with every other kernel at zero launches; the instance norm
    kernels, which every model with InstanceNorm2d launches, are held to a
    count only where `expected` names them (phases 3, 9 and 15)."""
    return {k: expected.get(k, _AnyCount() if k in NORM_KERNELS else 0) for k in kernels.launches}


def timed_rollouts(torch, np, kernels, inferencer, x, label):
    """One untimed rollout, which pays the page-locked host buffer and
    cuBLAS's set-up, then ROLLOUT_REPS timed ones (host clock; the rollout
    ends with its predictions on the host). Returns the launch counts of the
    first timed rollout, whose predictions are checked (the shape of x), and
    the ms per step of each."""
    inferencer._rollout_lite(x)
    launches, times = None, []
    for _ in range(ROLLOUT_REPS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        preds = inferencer._rollout_lite(x)
        times.append((time.perf_counter() - t0) * 1e3 / ROLLOUT_STEPS)
        if launches is None:
            launches = dict(kernels.launches)
            check(preds.shape == (ROLLOUT_STEPS, *x.shape), f"{label} shape {preds.shape}")
            check(bool(np.isfinite(preds).all()), f"{label} not finite")
        # the predictions alias the rollout's page-locked buffer: freed here,
        # the next rollout takes it from PyTorch's host cache
        del preds
    return launches, times


def phase_kernels(torch, spectral_mm, dev, gen, mmax=241, Lin=240, Kin=240, Kfull=721,
                  reps=20, plain_reps=5, C=384, Ldh=None):
    """Each kernel at the flagship shapes (or the given modes mmax and Lin,
    inner grid rows Kin and input grid rows Kfull, at C = 384 channels and
    batch 1; the dhconv kernels at Ldh degrees, default Lin); returns rows of
    measurements."""
    rows = []
    cases = [("full analysis", Kfull, "k"), ("full synthesis", Kfull, "l"),
             ("inner analysis", Kin, "k"), ("inner synthesis", Kin, "l")]
    for label, K, contract in cases:
        D = K if contract == "k" else Lin
        z = torch.randn((2 * mmax, C, D), device=dev, generator=gen)
        p = torch.randn((mmax, Lin, K), device=dev, generator=gen)
        zs = z.view(2, mmax, C, D)
        table = p.transpose(-1, -2) if contract == "k" else p
        ref = torch.matmul(zs.double(), table.double()).reshape(2 * mmax, C, -1)
        # the library yardstick: one float32 bmm against the table repeated
        # for the re and im rows (prepared outside the timing)
        tables = torch.cat([table, table])
        for passes in (3, 1):
            got = spectral_mm.legmm(z, p, passes, contract)
            torch.cuda.synchronize()
            plain = spectral_mm.legmm_plain(z, p, passes, contract)
            e64, etwin = rel_err(got, ref), rel_err(got, plain.double())
            check(e64 < F64_TOL[passes], f"legmm {label} p{passes} vs f64: {e64}")
            check(etwin < TWIN_TOL, f"legmm {label} p{passes} vs twin: {etwin}")
            nbytes = (z.numel() + p.numel() + got.numel()) * 4
            flops = 2 * 2 * mmax * C * Lin * K * passes
            b_ms, b_by = bound(nbytes, flops)
            rows.append(dict(
                name="legmm", shape=f"{label} z{tuple(z.shape)} p{tuple(p.shape)}",
                passes=passes, max_abs_err=float((got - plain).abs().max()),
                rel_err_twin=etwin, rel_err_f64=e64,
                ms=cuda_ms(lambda: spectral_mm.legmm(z, p, passes, contract), reps),
                plain_ms=cuda_ms(lambda: spectral_mm.legmm_plain(z, p, passes, contract),
                                 plain_reps),
                library_ms=cuda_ms(lambda: torch.bmm(z, tables), reps),
                bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9, gflop=flops / 1e9))
            del got, plain
        del z, p, zs, table, tables, ref

    B, L, M, C = 1, Ldh or Lin, mmax, 384
    x = torch.randn((2, B, L, C, M), device=dev, generator=gen)
    w = torch.randn((2, L, C, C), device=dev, generator=gen)
    # the library yardstick: one complex64 matmul (a float32 bmm cannot form
    # the complex product in one call). The forward contracts w's C, the
    # backward's dx (wdim 1, conj_w) contracts w's O with conj(w); C = O, so
    # one x serves both.
    xc = torch.complex(x[0], x[1])
    wc = torch.complex(w[0], w[1])
    for label, wdim, conj_w, wop in (("forward", 0, False, wc.transpose(-1, -2)),
                                     ("dx", 1, True, torch.conj(wc).resolve_conj())):
        ref = torch.matmul(wop.to(torch.complex128), xc.to(torch.complex128))
        for passes in (3, 1):
            got = spectral_mm.dhconv_mm(x, w, passes, wdim=wdim, conj_w=conj_w)
            torch.cuda.synchronize()
            plain = spectral_mm.dhconv_mm_plain(x, w, passes, wdim=wdim, conj_w=conj_w)
            e64 = max(float((got[0].double() - ref.real).abs().max()),
                      float((got[1].double() - ref.imag).abs().max())) / float(ref.abs().max())
            etwin = rel_err(got, plain.double())
            check(e64 < F64_TOL[passes], f"dhconv_mm {label} p{passes} vs f64: {e64}")
            check(etwin < TWIN_TOL, f"dhconv_mm {label} p{passes} vs twin: {etwin}")
            nbytes = (x.numel() + w.numel() + got.numel()) * 4
            flops = 2 * B * L * C * C * M * 3 * passes  # 3M: three real products
            b_ms, b_by = bound(nbytes, flops)
            rows.append(dict(
                name="dhconv_mm", shape=f"{label} x{tuple(x.shape)} w{tuple(w.shape)}",
                passes=passes, max_abs_err=float((got - plain).abs().max()),
                rel_err_twin=etwin, rel_err_f64=e64,
                ms=cuda_ms(lambda: spectral_mm.dhconv_mm(x, w, passes, wdim=wdim,
                                                         conj_w=conj_w), reps),
                plain_ms=cuda_ms(lambda: spectral_mm.dhconv_mm_plain(x, w, passes, wdim=wdim,
                                                                     conj_w=conj_w), plain_reps),
                library_ms=cuda_ms(lambda: torch.matmul(wop, xc), reps),
                bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9, gflop=flops / 1e9))
            del got, plain
        del ref
    del w, wc

    # dhconv_dw: x and the cotangent g at the forward's shapes
    g = torch.randn((2, B, L, C, M), device=dev, generator=gen)
    xcj = torch.conj(xc)                                 # (L, C, M)
    gct = torch.complex(g[0], g[1]).transpose(-1, -2)    # (L, M, O)
    ref = torch.matmul(xcj.to(torch.complex128), gct.to(torch.complex128))
    for passes in (3, 1):
        got = spectral_mm.dhconv_dw(x, g, passes)
        torch.cuda.synchronize()
        plain = spectral_mm.dhconv_dw_plain(x, g, passes)
        e64 = max(float((got[0].double() - ref.real).abs().max()),
                  float((got[1].double() - ref.imag).abs().max())) / float(ref.abs().max())
        etwin = rel_err(got, plain.double())
        check(e64 < F64_TOL[passes], f"dhconv_dw p{passes} vs f64: {e64}")
        check(etwin < TWIN_TOL, f"dhconv_dw p{passes} vs twin: {etwin}")
        nbytes = (x.numel() + g.numel() + got.numel()) * 4
        flops = 2 * B * L * C * C * M * 3 * passes
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(
            name="dhconv_dw", shape=f"x{tuple(x.shape)} g{tuple(g.shape)}", passes=passes,
            max_abs_err=float((got - plain).abs().max()), rel_err_twin=etwin, rel_err_f64=e64,
            ms=cuda_ms(lambda: spectral_mm.dhconv_dw(x, g, passes), reps),
            plain_ms=cuda_ms(lambda: spectral_mm.dhconv_dw_plain(x, g, passes), plain_reps),
            library_ms=cuda_ms(lambda: torch.matmul(xcj, gct), reps),
            bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9, gflop=flops / 1e9))
        del got, plain
    return rows


def phase_adam(torch, kernels, dev, gen, shapes):
    """The fused Adam kernel over the flagship's parameter leaves: 2 steps,
    one launch each, bit-identical to the twin, then timed per full update
    (CUDA events, the card alone, the host's enqueue)."""
    from makani_tpu_torch.ops import fused_adam
    from makani_tpu_torch.tools.bench_fused_adam import device_ms
    from makani_tpu_torch.utils.optimizers import AdamState
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, stochastic_rounding=True, seed=340)
    params = {k: torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
    twin = {k: v.clone() for k, v in params.items()}
    grads = {k: 1e-2 * torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}

    def state():
        return AdamState(0, {k: torch.zeros(s, device=dev, dtype=torch.bfloat16)
                             for k, s in shapes.items()},
                         {k: torch.zeros(s, device=dev, dtype=torch.bfloat16)
                          for k, s in shapes.items()})

    s_kernel, s_twin = state(), state()
    kernels.reset_launches()
    for _ in range(2):
        fused_adam.fused_adam_apply(params, grads, s_kernel, 1e-3, **kw)
        fused_adam.fused_adam_apply_plain(twin, grads, s_twin, 1e-3, **kw)
    torch.cuda.synchronize()
    launches = kernels.launches["fused_adam"]
    check(launches == 2, f"fused_adam: {launches} launches over 2 updates")
    diff = 0.0
    for k in shapes:
        for a, b in ((params[k], twin[k]), (s_kernel.mu[k], s_twin.mu[k]),
                     (s_kernel.nu[k], s_twin.nu[k])):
            diff = max(diff, float((a.float() - b.float()).abs().max()))
            check(torch.equal(a, b), f"fused_adam kernel vs twin differ in {k}")
    n = sum(math.prod(s) for s in shapes.values())
    nbytes = n * (4 + 4 + 4 + 2 + 2 + 2 + 2)  # p read and written, g, mu and nu read and written
    b_ms, b_by = bound(nbytes, 0)
    def update():
        fused_adam.fused_adam_apply(params, grads, s_kernel, 1e-3, **kw)
    ms, dev_ms = cuda_ms(update, 10), device_ms(update, 10)
    enqueue_ms = host_enqueue_ms(torch, update, 10)
    plain_ms = cuda_ms(lambda: fused_adam.fused_adam_apply_plain(twin, grads, s_twin, 1e-3,
                                                                 **kw), 2)
    del twin, s_twin
    torch.cuda.empty_cache()
    # context only: PyTorch's fused Adam on float32 moments, the same leaves
    leaves = list(params.values())
    for p, g in zip(leaves, grads.values()):
        p.grad = g
    opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, fused=True)
    library_ms, library_device_ms = cuda_ms(opt.step, 10), device_ms(opt.step, 10)
    library_enqueue_ms = host_enqueue_ms(torch, opt.step, 10)
    del opt, leaves, params, grads, s_kernel
    torch.cuda.empty_cache()
    return dict(name="fused_adam", shape=f"{len(shapes)} leaves, {n} elements", passes=None,
                max_abs_err=diff, rel_err_twin=diff, launches_per_update=launches // 2,
                ms=ms, device_ms=dev_ms, enqueue_ms=enqueue_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=library_device_ms,
                library_enqueue_ms=library_enqueue_ms, bound_ms=b_ms, bound_by=b_by,
                gbytes=nbytes / 1e9, elements=n, leaves=len(shapes))


def phase_gelu(torch, dev, gen):
    """The bf16 GELU kernels at the blocks' MLP activation and the AMP path's
    largest (the encoder's hidden layer): bit-identical to their twins, then
    timed at the largest beside the twin and PyTorch's fused tanh-form GELU
    and its gradient on bf16 (the same function, rounded once)."""
    import torch.nn.functional as F

    from makani_tpu_torch.ops import gelu
    for shape in ((1, 768, 240, 480), (1, 384, 721, 1440)):
        x = (3 * torch.randn(shape, device=dev, generator=gen)).bfloat16()
        g = torch.randn(shape, device=dev, generator=gen).bfloat16()
        for name, got, plain in (
                ("gelu_bf16", gelu.gelu_bf16_forward(x), gelu.gelu_bf16_plain(x)),
                ("gelu_bf16_grad", gelu.gelu_bf16_backward(x, g), gelu.gelu_bf16_grad_plain(x, g))):
            check(torch.equal(got, plain),
                  f"{name} {shape} vs twin: {int((got != plain).sum())} elements differ")
    n = x.numel()
    rows = []
    for name, fn, plain, library, nbytes, flops in (
            ("gelu_bf16", lambda: gelu.gelu_bf16_forward(x), lambda: gelu.gelu_bf16_plain(x),
             lambda: F.gelu(x, approximate="tanh"), 4 * n, 9 * n),
            ("gelu_bf16_grad", lambda: gelu.gelu_bf16_backward(x, g),
             lambda: gelu.gelu_bf16_grad_plain(x, g),
             lambda: torch.ops.aten.gelu_backward(g, x, approximate="tanh"), 6 * n, 21 * n)):
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        rows.append(dict(
            name=name, shape=f"x{tuple(x.shape)} bf16", passes=None, max_abs_err=0.0,
            ms=cuda_ms(fn, 20), plain_ms=cuda_ms(plain, 5), library_ms=cuda_ms(library, 20),
            bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9, gflop=flops / 1e9))
    return rows


def phase_instance_norm(torch, dev, gen):
    """The instance norm kernels at the paths' shapes in bf16 (the flagship's
    inner and full grids at embed 384, AFNO v2's 90 x 180 tokens at 768):
    y and dx within one bf16 ulp of each element of the twins' plus 1e-6 of
    the largest magnitude (their float32 statistics summed in other orders),
    then each kernel timed beside its twin (the eager chain forward, the
    closed form backward) and PyTorch's F.instance_norm forward and its
    autograd backward. Bounds: 4 bytes an element forward (x read, y
    written), 6 backward (x and g read, dx written)."""
    import torch.nn.functional as F

    from makani_tpu_torch.ops import instance_norm as inorm
    rows = []
    for shape in ((1, 384, 240, 480), (1, 384, 721, 1440), (1, 768, 90, 180)):
        x = (1.7 * torch.randn(shape, device=dev, generator=gen) + 0.6).bfloat16()
        g = torch.randn(shape, device=dev, generator=gen).bfloat16()
        w = 1 + 0.3 * torch.randn(shape[1], device=dev, generator=gen)
        b = 0.2 * torch.randn(shape[1], device=dev, generator=gen)
        y, stats = inorm.instance_norm_forward(x, w, b, 1e-6)
        dx, _, _ = inorm.instance_norm_backward(x, g, w, stats)
        y_t, stats_t = inorm.instance_norm_plain(x, w, b, 1e-6)
        dx_t, _, _ = inorm.instance_norm_grad_plain(x, g, w, stats_t)
        for name, got, want in (("instance_norm_fwd", y, y_t), ("instance_norm_bwd", dx, dx_t)):
            err = (got.float() - want.float()).abs()
            ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-38))) - 7)
            check(bool((err <= ulp + 1e-6 * want.float().abs().max()).all()),
                  f"{name} {shape} vs twin: {int((err > ulp).sum())} elements past one ulp")
        del y, dx, y_t, dx_t, stats_t
        xl = x.detach().requires_grad_(True)
        y_lib = F.instance_norm(xl, weight=w, bias=b, eps=1e-6)
        n = x.numel()
        for name, fn, plain, library, nbytes in (
                ("instance_norm_fwd", lambda: inorm.instance_norm_forward(x, w, b, 1e-6),
                 lambda: inorm.instance_norm_plain(x, w, b, 1e-6),
                 lambda: F.instance_norm(x, weight=w, bias=b, eps=1e-6), 4 * n),
                ("instance_norm_bwd", lambda: inorm.instance_norm_backward(x, g, w, stats),
                 lambda: inorm.instance_norm_grad_plain(x, g, w, stats),
                 lambda: torch.autograd.grad(y_lib, xl, g, retain_graph=True), 6 * n)):
            b_ms, b_by = bound(nbytes, 0, F32_FLOPS)
            rows.append(dict(
                name=name, shape=f"x{shape} bf16", passes=None, ms=cuda_ms(fn, 20),
                plain_ms=cuda_ms(plain, 5), library_ms=cuda_ms(library, 5), bound_ms=b_ms,
                bound_by=b_by, gbytes=nbytes / 1e9))
        del x, g, xl, y_lib, stats
        torch.cuda.empty_cache()
    return rows


def flagship_params(steps):
    from makani_tpu_torch.models.model_registry import update_channel_params
    from makani_tpu_torch.utils.yparams import YParams
    params = YParams(str(ROOT / "config" / "sfnonet.yaml"), "flagship_synth_drive_bare")
    params["valid_autoreg_steps"] = steps - 1
    # phases 4-9 run on synthetic data: the Inferencer's evaluation loader too
    params["enable_synthetic_data"] = True
    return update_channel_params(params, n_channels=73)


def phase_small(torch, dev):
    """A 3-block SFNO on the card (kernels) against the same weights on the
    CPU (plain twins)."""
    from makani_tpu_torch.models.model_registry import get_model
    params = flagship_params(1)
    params.update_params(dict(img_shape_x=36, img_shape_y=72, img_crop_shape_x=36,
                              img_crop_shape_y=72, embed_dim=32, num_layers=3,
                              scale_factor=2))
    cpu = get_model(params, device="cpu", generator=torch.Generator().manual_seed(5))
    gpu = get_model(params, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 73, 36, 72), generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(dev)).cpu()
    err = rel_err(got, want.double())
    check(err < SMALL_TOL, f"small SFNO card vs CPU: {err}")
    return err


def leaf_errors(grads, want):
    """Per-leaf relative error (largest magnitude); the MLP's output bias
    against the largest gradient of the model (ZERO_GRAD)."""
    largest = max(float(w.abs().max()) for w in want.values())
    errs = {}
    for k, g in grads.items():
        scale = largest if k.endswith(ZERO_GRAD) else float(want[k].abs().max())
        errs[k] = float((g.double() - want[k].double()).abs().max()) / scale
    return errs


def train_params(**overrides):
    params = flagship_params(1)
    params.update_params(dict(enable_synthetic_data=True, n_train_samples_per_epoch=TRAIN_STEPS,
                              optimizer_fused=True, skip_validation=True, save_checkpoint="none",
                              max_epochs=1, checkpointing=0, log_to_screen=False, **overrides))
    return params


def phase_train(torch, sht, kernels, dev):
    """The training path at full width, its gradients against the twins, and
    a small SFNO's gradients on the card against the CPU."""
    from makani_tpu_torch.utils.trainer import Trainer
    rec = {}
    trainer = Trainer(train_params(), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    rec["epoch_s"] = time.perf_counter() - t0
    total = dict(kernels.launches)
    rec["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    losses = trainer.last_logs["train"]["step losses"]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"train losses {losses}")
    check(total == launch_counts(kernels,
                                 {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}),
          f"launches over {TRAIN_STEPS} train steps {total}, expected {TRAIN_LAUNCHES} per step")
    rec.update(train_losses=losses, train_launches=total,
               train_launches_per_step={k: v // TRAIN_STEPS for k, v in total.items()},
               n_params=trainer.n_model_params, n_leaves=len(trainer.model_params))

    # the train step on a resident batch: one warm-up, the median of three
    inp, tar = (torch.from_numpy(a[None]).to(dev) for a in trainer.train_dataset[0])
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(inp, tar, None, None, 1e-3)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    rec["train_step_ms"] = statistics.median(times)
    rec["train_step_ms_all"] = times

    # full-width gradients, kernels against twins
    _, g_kernel = trainer.loss_and_grads(inp, tar)
    g_kernel = {k: v.cpu() for k, v in g_kernel.items()}
    sht.set_coeff_engine("stacked")
    _, g_plain = trainer.loss_and_grads(inp, tar)
    sht.set_coeff_engine("kernel")
    errs = leaf_errors(g_kernel, {k: v.cpu() for k, v in g_plain.items()})
    worst = max(errs, key=errs.get)
    check(errs[worst] < FORWARD_TOL, f"full-width gradient {worst}: {errs[worst]}")
    rec.update(grad_rel_err_max=errs[worst], grad_rel_err_leaf=worst)
    del trainer, inp, tar, g_kernel, g_plain
    torch.cuda.empty_cache()

    # a 3-block SFNO at 36x72: gradients on the card against the CPU
    small = dict(img_shape_x=36, img_shape_y=72, img_crop_shape_x=36, img_crop_shape_y=72,
                 embed_dim=32, num_layers=3, scale_factor=2)
    cpu = Trainer(train_params(**small), device="cpu",
                  generator=torch.Generator().manual_seed(5))
    gpu = Trainer(train_params(**small), device=dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    x, y = (torch.from_numpy(a[None]) for a in cpu.train_dataset[0])
    _, want = cpu.loss_and_grads(x, y)
    _, got = gpu.loss_and_grads(x.to(dev), y.to(dev))
    errs = leaf_errors({k: v.cpu() for k, v in got.items()}, want)
    worst = max(errs, key=errs.get)
    check(errs[worst] < SMALL_TOL, f"small SFNO gradient card vs CPU {worst}: {errs[worst]}")
    rec.update(small_grad_rel_err_max=errs[worst], small_grad_rel_err_leaf=worst)
    return rec


def phase_complex_kernel(torch, dev, gen):
    """The complex dhconv kernel at the flagship shapes: the forward and the
    backward's dx (the same kernel on conj(w) transposed), passes 3 and 1."""
    from makani_tpu_torch.ops import complex_kernels
    rows = []
    B, C, L, M = 1, 384, 240, 241

    def cplx(shape):
        return torch.complex(torch.randn(shape, device=dev, generator=gen),
                             torch.randn(shape, device=dev, generator=gen))

    x = cplx((B, C, L, M))          # the activation, or the cotangent g for dx
    w = cplx((C, C, L))
    for label, wop in (("forward", w), ("dx", w.conj().transpose(0, 1))):
        # the library yardstick and the float64 reference: one complex matmul
        # batched over l, (L, O, C) x (L, C, B*M), operands prepared outside
        # the timing
        wl = wop.resolve_conj().permute(2, 1, 0).contiguous()
        xl = x.permute(2, 1, 0, 3).reshape(L, C, B * M).contiguous()
        ref = torch.matmul(wl.to(torch.complex128), xl.to(torch.complex128))
        ref = ref.view(L, C, B, M).permute(2, 1, 0, 3)
        for passes in (3, 1):
            got = complex_kernels.contract_dhconv_raw(x, wop, passes)
            torch.cuda.synchronize()
            plain = complex_kernels.contract_dhconv_plain(x, wop, passes)
            e64, etwin = rel_err_c(got, ref), rel_err_c(got, plain.to(torch.complex128))
            check(e64 < F64_TOL[passes], f"dhconv_complex {label} p{passes} vs f64: {e64}")
            check(etwin < TWIN_TOL, f"dhconv_complex {label} p{passes} vs twin: {etwin}")
            nbytes = (x.numel() + w.numel() + got.numel()) * 8
            flops = 2 * B * L * C * C * M * 3 * passes  # 3M: three real products
            b_ms, b_by = bound(nbytes, flops)
            rows.append(dict(
                name="dhconv_complex", shape=f"{label} x{tuple(x.shape)} w{tuple(wop.shape)}",
                passes=passes, max_abs_err=float((got - plain).abs().max()),
                rel_err_twin=etwin, rel_err_f64=e64,
                ms=cuda_ms(lambda: complex_kernels.contract_dhconv_raw(x, wop, passes), 20),
                plain_ms=cuda_ms(lambda: complex_kernels.contract_dhconv_plain(x, wop, passes), 5),
                library_ms=cuda_ms(lambda: torch.matmul(wl, xl), 20),
                bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9, gflop=flops / 1e9))
            del got, plain
        del wl, xl, ref
    del x, w
    torch.cuda.empty_cache()
    return rows


def phase_complex(torch, np, sht, complex_ops, kernels, dev, gen):
    """The complex coefficient engine with the kernel on, at full width:
    kernel checks, a forward, a rollout and a training epoch."""
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.utils.inferencer import Inferencer
    from makani_tpu_torch.utils.trainer import Trainer
    rec = {"kernels": phase_complex_kernel(torch, dev, gen)}
    params = flagship_params(ROLLOUT_STEPS)
    model = get_model(params, device=dev)
    model.eval()
    x = torch.randn((1, params.N_in_channels, 721, 1440), device=dev, generator=gen)
    with torch.inference_mode():
        model(x)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        y = model(x)
        torch.cuda.synchronize()
        rec["forward_ms"] = (time.perf_counter() - t0) * 1e3
        rec["launches_per_forward"] = dict(kernels.launches)
        complex_ops.enable_pallas_kernels(False)
        y_einsum = model(x)
        complex_ops.enable_pallas_kernels(True)
        sht.set_coeff_engine("kernel")
        y_kernel_engine = model(x)
        sht.set_coeff_engine("xla")
    check(rec["launches_per_forward"] == launch_counts(kernels, COMPLEX_FORWARD_LAUNCHES),
          f"complex engine launches per forward {rec['launches_per_forward']}")
    check(bool(torch.isfinite(y).all()), "complex engine forward not finite")
    rec["forward_rel_err_einsum"] = rel_err(y, y_einsum.double())
    rec["forward_rel_err_kernel_engine"] = rel_err(y, y_kernel_engine.double())
    check(rec["forward_rel_err_einsum"] < FORWARD_TOL,
          f"complex engine forward, kernel vs einsum: {rec['forward_rel_err_einsum']}")
    check(rec["forward_rel_err_kernel_engine"] < FORWARD_TOL,
          f"complex engine vs kernel engine forward: {rec['forward_rel_err_kernel_engine']}")
    del y, y_einsum, y_kernel_engine

    # serving: the Inferencer's lite rollout
    inferencer = Inferencer(params, weights=model.state_dict(), device=dev)
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec["rollout_launches"], rec["step_ms_all"] = timed_rollouts(
        torch, np, kernels, inferencer, x, "complex engine rollout")
    rec["step_ms"] = statistics.median(rec["step_ms_all"])
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    check(rec["rollout_launches"] == launch_counts(
        kernels, {k: v * ROLLOUT_STEPS for k, v in COMPLEX_FORWARD_LAUNCHES.items()}),
        f"complex engine rollout launches {rec['rollout_launches']}")
    del inferencer, x
    torch.cuda.empty_cache()

    # training: a Trainer with coefficient_engine "xla", the kernel toggle on
    trainer = Trainer(train_params(coefficient_engine="xla"), device=dev)
    check(sht.get_coeff_engine() == "xla", "the Trainer did not select the complex engine")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    trainer.train()
    torch.cuda.synchronize()
    total = dict(kernels.launches)
    rec["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    losses = trainer.last_logs["train"]["step losses"]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"complex engine train losses {losses}")
    check(total == launch_counts(
        kernels, {k: v * TRAIN_STEPS for k, v in COMPLEX_TRAIN_LAUNCHES.items()}),
        f"complex engine launches over {TRAIN_STEPS} train steps {total}")
    rec.update(train_losses=losses, train_launches=total,
               train_launches_per_step={k: v // TRAIN_STEPS for k, v in total.items()})
    inp, tar = (torch.from_numpy(a[None]).to(dev) for a in trainer.train_dataset[0])
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(inp, tar, None, None, 1e-3)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    rec["train_step_ms"] = statistics.median(times)
    rec["train_step_ms_all"] = times
    _, g_complex = trainer.loss_and_grads(inp, tar)
    g_complex = {k: v.cpu() for k, v in g_complex.items()}
    sht.set_coeff_engine("kernel")
    _, g_kernel = trainer.loss_and_grads(inp, tar)
    sht.set_coeff_engine("xla")
    errs = leaf_errors(g_complex, {k: v.cpu() for k, v in g_kernel.items()})
    worst = max(errs, key=errs.get)
    check(errs[worst] < FORWARD_TOL, f"complex vs kernel engine gradient {worst}: {errs[worst]}")
    rec.update(grad_rel_err_max=errs[worst], grad_rel_err_leaf=worst)
    del trainer, inp, tar, g_complex, g_kernel
    torch.cuda.empty_cache()
    return rec


def bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits): 2**(e - 8)
    for |v| in [2**(e-1), 2**e). frexp gives e exactly, where a float log2
    can fall just below an exact power of two."""
    import torch
    return torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 8)


def phase_grid(torch, spectral_mm, kernels, dev, gen):
    """gridmm at the flagship longitude DFT's shapes and grid_dot at
    tools/bench_gridmm.py's, against float64 and their twins, timed; the
    seven probe kernels against their twins, timed. Returns rows."""
    from makani_tpu_torch.tools.bench_gridmm import grid_dot, grid_dot_plain, split_table
    from makani_tpu_torch.tools.bench_spectral_mm import bf16_mm_f32
    from makani_tpu_torch.tools import kernel_isolate, launch_path
    f32, bf16 = torch.float32, torch.bfloat16
    R, Rin, K, Kin, N = 384 * 721, 384 * 240, 1440, 480, 2 * 241
    rows = []

    def grid_row(name, label, x, tables, passes, out, fn, plain_fn, ref):
        got = fn()
        torch.cuda.synchronize()
        plain = plain_fn()
        e64 = rel_err(got, ref)
        tol = F64_TOL[passes] + (BF16_OUT if out == bf16 else 0.0)
        g, w = got.double(), plain.double()
        slack = TWIN_TOL * w.abs().max() + (bf16_ulp(w) if out == bf16 else 0.0)
        twin_ratio = float(((g - w).abs() / slack).max())
        etwin = rel_err(got, w)
        check(e64 < tol, f"{name} {label} p{passes} vs f64: {e64}")
        check(twin_ratio <= 1.0, f"{name} {label} p{passes} vs twin: {etwin} (ratio {twin_ratio})")
        Rr, Kk = x.shape
        Nn = tables[0].shape[1]
        nbytes = (x.numel() * x.element_size() + sum(t.numel() * t.element_size() for t in tables)
                  + Rr * Nn * got.element_size())
        flops = 2 * Rr * Kk * Nn * passes
        b_ms, b_by = bound(nbytes, flops)
        x32 = x.float()
        xb, tb = x.to(bf16), tables[0].float().to(bf16)
        t32 = tables[0].float() if len(tables) == 1 else (tables[0].float() + tables[1].float())
        row = dict(name=name, shape=f"{label} x{tuple(x.shape)} {str(x.dtype)[6:]} "
                                    f"t({Kk}, {Nn}) -> {str(out)[6:]}",
                   passes=passes, max_abs_err=float((g - w).abs().max()), rel_err_twin=etwin,
                   twin_ratio=twin_ratio, rel_err_f64=e64,
                   ms=cuda_ms(fn, 10), plain_ms=cuda_ms(plain_fn, 3),
                   library_ms=cuda_ms(lambda: torch.mm(x32, t32), 10),
                   bf16_ms=cuda_ms(lambda: bf16_mm_f32(xb, tb), 10),
                   bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9, gflop=flops / 1e9)
        del got, plain, g, w, x32, xb, tb, t32
        return row

    # gridmm: (label, rows, K, N, x dtype, passes, out dtype)
    cases = [("full analysis", R, K, N, f32, 3, f32), ("full analysis", R, K, N, bf16, 2, f32),
             ("full analysis", R, K, N, f32, 1, f32), ("full synthesis", R, N, K, f32, 3, f32),
             ("full synthesis", R, N, K, f32, 3, bf16), ("inner analysis", Rin, Kin, N, f32, 3, f32),
             ("inner synthesis", Rin, N, Kin, f32, 3, f32)]
    shape = None
    for label, Rr, Kk, Nn, xdt, passes, out in cases:
        if (label, Rr, Kk, Nn) != shape:  # new operands; float64 references per x dtype
            x32 = t = x = ref = None
            refs = {}
            torch.cuda.empty_cache()
            shape = (label, Rr, Kk, Nn)
            x32 = torch.randn((Rr, Kk), device=dev, generator=gen)
            t = torch.randn((Kk, Nn), device=dev, generator=gen)
        if xdt not in refs:
            x = x32.to(xdt)
            refs[xdt] = (x, torch.mm(x.double(), t.double()))
        x, ref = refs[xdt]
        rows.append(grid_row("gridmm", label, x, (t,), passes, out,
                             lambda: spectral_mm.gridmm(x, t, passes, out),
                             lambda: spectral_mm.gridmm_plain(x, t, passes, out), ref))
    del x32, t, refs, x, ref
    torch.cuda.empty_cache()

    # grid_dot at the script's shapes: analysis with a bf16 x, synthesis with
    # a float32 x to a bf16 output
    Rs = 320 * 721
    for label, Kk, Nn, xdt, out in (("analysis", K, N, bf16, f32), ("synthesis", N, K, f32, bf16)):
        x = torch.randn((Rs, Kk), device=dev, generator=gen).to(xdt)
        th, tl = split_table(torch.randn((Kk, Nn), device=dev, generator=gen))
        ref = torch.mm(x.double(), th.double() + tl.double())
        passes = 2 if xdt == bf16 else 3
        rows.append(grid_row("grid_dot", label, x, (th, tl), passes, out,
                             lambda: grid_dot(x, th, tl, out),
                             lambda: grid_dot_plain(x, th, tl, out), ref))
        del x, th, tl, ref
    torch.cuda.empty_cache()

    # the probes at scripts/pallas_isolate.py's shapes, each beside one
    # PyTorch call of the same function: first every host reading (CUDA
    # events, the enqueue), then the profiler's device time, then the
    # enqueue once more: a profiler session slows the process's later
    # launches, so the readings kept come before any session
    probes = []
    for name, shapes, kernel, twin in kernel_isolate.CASES[:7]:
        inputs = kernel_isolate.case_inputs(shapes, 0, dev)
        got, want = kernel(*inputs), twin(*inputs)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        etwin = max(rel_err(g, w.double()) for g, w in zip(got, want))
        check(etwin < TWIN_TOL, f"probe {name} vs twin: {etwin}")
        # bit for bit: probe_copy with its twin; the dot probes with the
        # fused multiply-adds in order of c that their body keeps, read from
        # the reference chain
        if name == "copy":
            check(torch.equal(got[0], want[0]), "probe copy is not its twin bit for bit")
        if name in ("dot_plain", "dot_transposed"):
            chain = kernel_isolate.dot_chain(*inputs, transposed=name == "dot_transposed")
            check(torch.equal(got[0].view(torch.int32), chain.view(torch.int32)),
                  f"probe {name} is not the fused multiply-add chain bit for bit")
        nbytes = 4 * (sum(t.numel() for t in inputs) + sum(g.numel() for g in got))
        if name == "copy":
            flops, rate = inputs[0].numel(), F32_FLOPS
        elif name in ("dot_plain", "dot_transposed", "bf16_split"):
            o, m = got[0].shape
            flops = 2 * o * inputs[1].shape[0] * m * (3 if name == "bf16_split" else 1)
            rate = BF16_FLOPS if name == "bf16_split" else F32_FLOPS
        else:
            b, l, o, m = want[0].shape[-4:]
            flops, rate = 2 * b * l * o * inputs[1].shape[1] * m, F32_FLOPS
        b_ms, b_by = bound(nbytes, flops, rate)
        probe = functools.partial(kernel, *inputs)
        library = launch_path.library_call(name, *inputs)
        # CUDA events around a call, and the host's enqueue: the probe and
        # its PyTorch call in DEVICE_RUNS interleaved rounds, so that a drift
        # of the host's speed falls on both
        host = {"ms": [], "library_ms": [], "enqueue_us": [], "library_enqueue_us": []}
        for _ in range(DEVICE_RUNS):
            host["ms"].append(cuda_ms(probe, 50))
            host["library_ms"].append(cuda_ms(library, 50))
            host["enqueue_us"].append(launch_path.enqueue_us(probe))
            host["library_enqueue_us"].append(launch_path.enqueue_us(library))
        rows.append(dict(
            name=kernel.__name__, shape=" ".join(str(tuple(t.shape)) for t in inputs),
            passes=3 if name == "bf16_split" else None,
            max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
            rel_err_twin=etwin, rel_err_f64=None,
            **{k: statistics.median(v) for k, v in host.items()},
            **{f"{k}_runs": v for k, v in host.items()},
            plain_ms=cuda_ms(lambda: twin(*inputs), 50),
            bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9, gflop=flops / 1e9))
        probes.append((rows[-1], probe, library))
    for row, probe, library in probes:
        for key, fn in (("device_ms", probe), ("library_device_ms", library)):
            runs = [kernel_isolate.device_ms(fn, kernel_isolate.DEVICE_REPS)
                    for _ in range(DEVICE_RUNS)]
            row.update({key: statistics.median(runs), f"{key}_runs": runs})
    for row, probe, library in probes:
        row.update(enqueue_after_profiler_us=launch_path.enqueue_us(probe),
                   library_enqueue_after_profiler_us=launch_path.enqueue_us(library))
    return rows


def tool_launches(reps, probes):
    """Launches of each kernel over the three tools, read from their code:
    `timeit` runs its function reps + 1 times (one warm-up) on the card."""
    n = reps + 1
    return {
        # bench_spectral_mm: legendre times 4 legmm calls and checks 1;
        # legendre2 times 3 and checks 1
        "legmm": 4 * n + 1 + 3 * n + 1,
        # dhconv: p1 and p3 forward and dx timed, p1 and p3 forward checked,
        # for dhconv_mm and dhconv_complex; dw timed
        "dhconv_mm": 4 * n + 2, "dhconv_dw": n,
        # grid, per shape (two): p2 and p3 analysis and the p3 synthesis
        # timed, two checks
        "gridmm": 2 * (3 * n + 2),
        # bench_gridmm: analysis and synthesis each timed and checked once
        "grid_dot": 2 * n + 2,
        # kernel_isolate: one launch per probe; dhconv_tiny's forward,
        # dhconv_grad's forward and dx
        **{name: 1 for name in probes}, "dhconv_complex": 4 * n + 2 + 3,
    }


def phase_tools(torch, kernels):
    """The three tools end to end on the card, their launches counted."""
    import contextlib
    import io
    from makani_tpu_torch.tools import bench_gridmm, bench_spectral_mm, kernel_isolate
    rec, logs = {}, {}
    kernels.reset_launches()
    for name, fn in (("bench_spectral_mm", lambda: bench_spectral_mm.run("all", "cuda", TOOL_REPS)),
                     ("bench_gridmm", lambda: bench_gridmm.run("cuda", TOOL_REPS)),
                     ("kernel_isolate", lambda: kernel_isolate.main([]))):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn()
        torch.cuda.synchronize()
        rec[f"{name}_s"] = time.perf_counter() - t0
        logs[name] = buf.getvalue()
        print(f"[tool {name}] rc {rc}, {rec[f'{name}_s']:.1f} s")
        for line in logs[name].splitlines():
            print(f"  {line}")
        check(rc == 0, f"{name} returned {rc}")
    launched = dict(kernels.launches)
    check(logs["kernel_isolate"].count("PASS") == 9, "the probe battery did not give nine PASS")
    expected = launch_counts(kernels, tool_launches(TOOL_REPS, kernels.PROBES))
    check(launched == expected, f"tool launches {launched}, expected {expected}")
    rec.update(launches=launched, logs=logs)
    return rec


def amp_forward(torch, kernels, model, xb, label):
    """One synchronized AMP forward after a warm-up: (output, ms, launches)."""
    with torch.inference_mode():
        model(xb)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        y = model(xb)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check(y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 73, 721, 1440),
          f"{label} forward {y.dtype} {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), f"{label} forward not finite")
    return y, ms, dict(kernels.launches)


def amp_kernel_calls(torch, model, xb):
    """Every legmm, dhconv_mm and gridmm call of an AMP forward of `xb` against
    its twin on the same inputs: the largest relative error of each kernel
    over its calls, and the count of calls checked."""
    from makani_tpu_torch.ops import spectral_mm
    kernels = {"legmm": spectral_mm.legmm_plain, "dhconv_mm": spectral_mm.dhconv_mm_plain,
               "gridmm": spectral_mm.gridmm_plain}
    worst, calls = dict.fromkeys(kernels, 0.0), dict.fromkeys(kernels, 0)
    launch = {name: getattr(spectral_mm, name) for name in kernels}

    def checked(name):
        def call(*args, **kwargs):
            out = launch[name](*args, **kwargs)
            worst[name] = max(worst[name], rel_err(out, kernels[name](*args, **kwargs).double()))
            calls[name] += 1
            return out
        return call
    for name in kernels:
        setattr(spectral_mm, name, checked(name))
    try:
        with torch.inference_mode():
            model(xb)
    finally:
        for name, fn in launch.items():
            setattr(spectral_mm, name, fn)
    return worst, calls


def amp_blocks(torch, sht, model, xb):
    """Kernels against twins under AMP block by block: each block, and the
    decoder, given the kernels' own input to it in a forward of `xb`. Returns
    per stage the norm-wise deviation of the kernels' output from the twins'
    and that of the twins' output from their float32 output on the same
    input (the stage's AMP rounding)."""
    net = model.model
    stages = [*net.blocks, net.decoder]
    inputs = []
    hooks = [m.register_forward_pre_hook(lambda m, args: inputs.append(args[0]))
             for m in stages]
    with torch.inference_mode():
        model(xb)
    for h in hooks:
        h.remove()
    dev_twin, dev_f32 = [], []
    with torch.inference_mode():
        for m, inp in zip(stages, inputs, strict=True):
            y = m(inp).float()
            sht.set_coeff_engine("stacked")
            y_twin, y_f32 = m(inp).float(), m(inp.float())
            sht.set_coeff_engine("kernel")
            dev_twin.append(dev_norm(y, y_twin))
            dev_f32.append(dev_norm(y_twin, y_f32))
    return dev_twin, dev_f32


def at_one_pass(kernels):
    """True when every launch of a kernel that takes a pass count ran at 1."""
    return all(p == 1 for (_, p), n in kernels.launches_by_passes.items() if n)


def phase_amp(torch, np, sht, complex_ops, kernels, dev, x, y_f32):
    """bf16 AMP at full width (amp_mode "bf16", precision "default": 1 bf16
    pass in the kernels): forward through the kernels against the twins and
    against phase 4's float32 forward (`y_f32`, on the host, of the same
    weights and input `x`), a lite rollout, a Trainer epoch and the timed
    train step on the kernel engine; one forward and one train step on the
    complex "xla" engine with its kernel."""
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.utils.inferencer import Inferencer
    from makani_tpu_torch.utils.trainer import Trainer
    rec = {}
    params = flagship_params(ROLLOUT_STEPS)
    params["amp_mode"] = "bf16"
    model = get_model(params, device=dev)  # phase 4's weights: the same seed
    model.eval()
    xd = x.to(dev)
    with torch.inference_mode():
        same = rel_err(model(xd).cpu(), y_f32.double())
    check(same < TWIN_TOL, f"phase 9's model is not phase 4's: forward rel err {same}")
    sht.set_transform_precision("default")
    complex_ops.set_contraction_precision("default")
    xb = xd.to(torch.bfloat16)

    y, rec["forward_ms"], rec["launches_per_forward"] = amp_forward(
        torch, kernels, model, xb, "AMP")
    check(rec["launches_per_forward"] == launch_counts(
        kernels, {"legmm": 18, "gridmm": 18, "dhconv_mm": 8, **AMP_FORWARD_GELU,
                  **FORWARD_NORMS}) and at_one_pass(kernels) and not kernels.eager_calls,
          f"AMP launches per forward {rec['launches_per_forward']}, "
          f"by passes {dict(kernels.launches_by_passes)}")
    sht.set_coeff_engine("stacked")
    with torch.inference_mode():
        y_twin = model(xb)
    sht.set_coeff_engine("kernel")
    yf = y.float().cpu().double()
    y_ref = y_f32.double()
    twin = y_twin.float().cpu().double()
    rec["forward_dev_twin"] = dev_norm(yf, twin)
    rec["forward_dev_f32"] = dev_norm(yf, y_ref)
    rec["twin_dev_f32"] = dev_norm(twin, y_ref)
    rec["forward_rel_err_twin"] = rel_err(yf, twin)
    rec["forward_rel_err_f32"] = rel_err(yf, y_ref)
    check(rec["forward_dev_f32"] < AMP_DEV_MAX and rec["forward_dev_twin"] < AMP_DEV_MAX,
          f"AMP forward deviates from float32 by {rec['forward_dev_f32']}, from the twins by "
          f"{rec['forward_dev_twin']}")
    del y, y_twin, yf, twin
    rec["call_rel_err_twin"], rec["calls_checked"] = amp_kernel_calls(torch, model, xb)
    check(rec["calls_checked"] == {"legmm": 18, "dhconv_mm": 8, "gridmm": 18}
          and max(rec["call_rel_err_twin"].values()) < TWIN_TOL,
          f"AMP forward's kernel calls against their twins {rec['call_rel_err_twin']} over "
          f"{rec['calls_checked']} calls")
    rec["block_dev_twin"], rec["block_dev_f32"] = amp_blocks(torch, sht, model, xb)
    check(all(d < BLOCK_SHARE * f for d, f in zip(rec["block_dev_twin"], rec["block_dev_f32"])),
          f"AMP blocks, kernels vs twins {rec['block_dev_twin']}, not below {BLOCK_SHARE} of "
          f"the twins' deviation from float32 {rec['block_dev_f32']}")

    # the complex engine with its kernel: one AMP forward
    sht.set_coeff_engine("xla")
    complex_ops.enable_pallas_kernels(True)
    y_xla, rec["xla_forward_ms"], rec["xla_launches_per_forward"] = amp_forward(
        torch, kernels, model, xb, "AMP 'xla' engine")
    check(rec["xla_launches_per_forward"] == launch_counts(
        kernels, {**COMPLEX_FORWARD_LAUNCHES, **AMP_FORWARD_GELU}) and at_one_pass(kernels),
          f"AMP 'xla' launches {rec['xla_launches_per_forward']}")
    rec["xla_forward_dev_f32"] = dev_norm(y_xla.float().cpu().double(), y_ref)
    check(rec["xla_forward_dev_f32"] < AMP_DEV_MAX,
          f"AMP 'xla' forward deviates from float32 by {rec['xla_forward_dev_f32']}")
    sht.set_coeff_engine("kernel")
    complex_ops.enable_pallas_kernels(False)
    del y_xla, xb

    # serving: the Inferencer's lite rollout under AMP (its host buffer
    # float32), with phase 5's memory in use: the Inferencer's weights and
    # the float32 input
    inferencer = Inferencer(params, weights=model.state_dict(), device=dev)
    check(inferencer.amp_dtype == torch.bfloat16, "the Inferencer did not take amp_mode bf16")
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec["rollout_launches"], rec["step_ms_all"] = timed_rollouts(
        torch, np, kernels, inferencer, xd, "AMP rollout")
    rec["step_ms"] = statistics.median(rec["step_ms_all"])
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    per_step = {"legmm": 18, "gridmm": 18, "dhconv_mm": 8, **AMP_FORWARD_GELU, **FORWARD_NORMS}
    check(rec["rollout_launches"] == launch_counts(
        kernels, {k: v * ROLLOUT_STEPS for k, v in per_step.items()})
          and not kernels.eager_calls, f"AMP rollout launches {rec['rollout_launches']}, "
          f"eager norms {dict(kernels.eager_calls)}")
    del inferencer, xd
    torch.cuda.empty_cache()

    # training: a Trainer under AMP resolves the precision to "default"
    trainer = Trainer(train_params(amp_mode="bf16"), device=dev)
    check(sht.get_transform_precision() == "default" and sht._coeff_passes() == 1
          and complex_ops.contraction_passes() == 1, "the AMP Trainer did not resolve 1 pass")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    trainer.train()
    torch.cuda.synchronize()
    total = dict(kernels.launches)
    rec["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    losses = trainer.last_logs["train"]["step losses"]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"AMP train losses {losses}")
    check(total == launch_counts(kernels, {
        k: v * TRAIN_STEPS for k, v in {**TRAIN_LAUNCHES, **AMP_TRAIN_GELU, **TRAIN_NORMS}.items()})
          and at_one_pass(kernels) and not kernels.eager_calls,
          f"AMP launches over {TRAIN_STEPS} train steps {total}, by passes "
          f"{dict(kernels.launches_by_passes)}, eager norms {dict(kernels.eager_calls)}")
    rec.update(train_losses=losses, train_launches=total,
               train_launches_per_step={k: v // TRAIN_STEPS for k, v in total.items()})
    inp, tar = (torch.from_numpy(a[None]).to(dev) for a in trainer.train_dataset[0])
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(inp, tar, None, None, 1e-3)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    rec["train_step_ms"] = statistics.median(times)
    rec["train_step_ms_all"] = times
    check(all(p.dtype == torch.float32 for p in trainer.model_params.values()),
          "AMP parameters are not float32")
    del trainer
    torch.cuda.empty_cache()

    # training on the complex engine with its kernel: one AMP step with its
    # launches counted, then the step timed as above
    trainer = Trainer(train_params(amp_mode="bf16", coefficient_engine="xla"), device=dev)
    complex_ops.enable_pallas_kernels(True)
    inp, tar = (torch.from_numpy(a[None]).to(dev) for a in trainer.train_dataset[0])
    torch.cuda.synchronize()
    kernels.reset_launches()
    loss = float(trainer.train_step(inp, tar, None, None, 1e-3))
    rec["xla_train_launches"] = dict(kernels.launches)
    check(math.isfinite(loss), f"AMP 'xla' train loss {loss}")
    check(rec["xla_train_launches"] == launch_counts(
        kernels, {**COMPLEX_TRAIN_LAUNCHES, **AMP_TRAIN_GELU}) and at_one_pass(kernels),
          f"AMP 'xla' train step launches {rec['xla_train_launches']}")
    rec["xla_train_loss"] = loss
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(inp, tar, None, None, 1e-3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rec["xla_train_step_ms"] = statistics.median(times)
    rec["xla_train_step_ms_all"] = times
    del trainer, inp, tar
    torch.cuda.empty_cache()
    return rec


def files_params(**overrides):
    """flagship_synth_drive on the dataset in FILES_DIR, cut as FILES_CUTS
    lists."""
    from makani_tpu_torch.utils.yparams import YParams
    params = YParams(str(ROOT / "config" / "sfnonet.yaml"), "flagship_synth_drive")
    stats, inv = FILES_DIR / "stats", FILES_DIR / "invariant"
    params.update_params(dict(
        metadata_json_path=str(FILES_DIR / "data.json"),
        train_data_path=str(FILES_DIR / "train"), valid_data_path=str(FILES_DIR / "test"),
        inf_data_path=str(FILES_DIR / "test"),
        **{f"{name}_path": str(stats / f"{name}.npy") for name in (
            "global_means", "global_stds", "time_means", "time_diff_means", "time_diff_stds")},
        min_path=str(stats / "mins.npy"), max_path=str(stats / "maxs.npy"),
        orography_path=str(inv / "orography.npy"), landmask_path=str(inv / "land_sea_mask.npy"),
        n_train_samples_per_epoch=FILES_TRAIN_SAMPLES - 1, n_eval_samples=FILES_EVAL,
        valid_autoreg_steps=FILES_AUTOREG, max_epochs=1, skip_validation=True,
        save_checkpoint="none", checkpointing=0, optimizer_fused=True, log_to_screen=False,
        **overrides))
    return params


def write_files_dataset(np):
    """The synthetic AR dataset at full width as npy shards, and the
    invariant fields as .npy; returns the seconds it took."""
    from makani_tpu_torch.tools.make_synthetic_dataset import invariant_fields, make_dataset
    t0 = time.perf_counter()
    make_dataset(str(FILES_DIR), img_shape=FILES_SHAPE,
                 channels=[f"c{i}" for i in range(FILES_CHANNELS)],
                 n_samples_per_year=FILES_TRAIN_SAMPLES, n_valid_samples=FILES_VALID_SAMPLES,
                 mode="ar", fmt="bin", seed=333)
    oro, lsm = invariant_fields(FILES_SHAPE, seed=334)  # make_dataset's invariants seed
    (FILES_DIR / "invariant").mkdir()
    np.save(FILES_DIR / "invariant" / "orography.npy", oro)
    np.save(FILES_DIR / "invariant" / "land_sea_mask.npy", lsm)
    return time.perf_counter() - t0


def check_loader(np):
    """Every train sample through get_dataloader and the native reader
    against a direct read of the shard, normalized as the reader normalizes
    ((x - mean) * (1 / std) in float32), with zenith from the port's
    cos_zenith_angle; then one epoch of the loader timed."""
    import datetime
    from makani_tpu_torch.data.dataloader import get_dataloader, init_data_params
    from makani_tpu_torch.utils.zenith_angle import cos_zenith_angle
    params = init_data_params(files_params())
    loader, ds = get_dataloader(params, params.train_data_path, train=True)
    check(type(ds).__name__ == "BinaryDataset", f"the train files went to {type(ds).__name__}")
    shard = np.load(FILES_DIR / "train" / "2018.npy", mmap_mode="r")
    bias = np.load(params.global_means_path).astype(np.float32)
    iscale = (1.0 / np.load(params.global_stds_path)).astype(np.float32)
    lon, lat = np.meshgrid(np.asarray(params.lon), np.asarray(params.lat))
    jan01 = datetime.datetime(2018, 1, 1, tzinfo=datetime.timezone.utc)
    for i in range(len(ds)):
        want = [(shard[i + t: i + t + 1] - bias) * iscale for t in (0, 1)]
        want += [cos_zenith_angle([jan01 + datetime.timedelta(hours=(i + t) * params.dhours)],
                                  lon, lat)[:, None] for t in (0, 1)]
        got = ds[i]
        check(len(got) == 4 and all(g.dtype == np.float32 and g.shape == w.shape
                                    and np.array_equal(g, w) for g, w in zip(got, want)),
              f"train sample {i} differs from the shard read directly")
    t0 = time.perf_counter()
    n, nbytes = 0, 0
    for batch in loader:
        n += batch[0].shape[0]
        nbytes += sum(b.nbytes for b in batch)
    dt = time.perf_counter() - t0
    return dict(loader_samples=n, loader_s=dt, loader_samples_per_s=n / dt,
                loader_gb_per_s=nbytes / dt / 1e9, sample_bytes=nbytes // n)


def phase_files_train(torch, np, kernels, dev):
    """flagship_synth_drive from files at full width: the dataset written,
    the loader checked and timed, and an AMP epoch from the files under the
    profiler. Returns the measurements and the trained Trainer (phase 11
    checkpoints it)."""
    from torch.profiler import ProfilerActivity, profile
    from makani_tpu_torch.tools.profile_forward import busy_ms, device_events
    from makani_tpu_torch.utils.trainer import Trainer
    rec = {"write_s": write_files_dataset(np)}
    rec.update(check_loader(np))

    # training: the canonical mode, bf16 AMP, AdamW, all auxiliary channels
    trainer = Trainer(files_params(amp_mode="bf16"), device=dev)
    params = trainer.params
    check(params.N_in_channels == FILES_IN_CHANNELS and params.optimizer_type == "AdamW"
          and params.optimizer_beta2 == 0.95 and trainer.amp_dtype == torch.bfloat16
          and type(trainer.train_dataset).__name__ == "BinaryDataset",
          f"phase 10's Trainer: {params.N_in_channels} input channels, "
          f"{params.optimizer_type} beta2 {params.optimizer_beta2}, amp {trainer.amp_dtype}, "
          f"{type(trainer.train_dataset).__name__}")
    rec["aux_channel_names"] = params.aux_channel_names
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        rec["epoch_s"] = time.perf_counter() - t0
    total = dict(kernels.launches)
    rec["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    trace = ROOT / "build" / "chip_smoke_files_trace.json"
    prof.export_chrome_trace(str(trace))
    device = device_events(trace)[1]
    trace.unlink()
    check(bool(device), "the profiler recorded no device event over phase 10's epoch")
    # busy: kernels and copies; the copies alone: the batches' pageable
    # copies to the card; window: first device event to the last, so the
    # epoch less the window is the wait for the first batch and set-up
    rec["epoch_busy_s"] = busy_ms(device) / 1e3
    rec["epoch_copy_s"] = busy_ms([e for e in device if e["cat"] == "gpu_memcpy"]) / 1e3
    rec["epoch_window_s"] = (max((e["ts"] + e["dur"] for e in device), default=0)
                             - min((e["ts"] for e in device), default=0)) / 1e6
    rec["idle_share"] = 1.0 - rec["epoch_busy_s"] / rec["epoch_s"]
    logs = trainer.last_logs
    losses = logs["train"]["step losses"]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"phase 10 train losses {losses}")
    check(total == launch_counts(kernels, {
        k: v * TRAIN_STEPS for k, v in {**TRAIN_LAUNCHES, **AMP_TRAIN_GELU}.items()})
          and at_one_pass(kernels), f"phase 10 launches over {TRAIN_STEPS} train steps {total}, "
          f"by passes {dict(kernels.launches_by_passes)}")
    rec.update(train_losses=losses, train_launches=total,
               train_launches_per_step={k: v // TRAIN_STEPS for k, v in total.items()},
               step_ms_loader=logs["timing"]["training step time [ms]"],
               train_s=logs["timing"]["training time [s]"])
    return rec, trainer


def phase_files_serve(torch, np, sht, complex_ops, kernels, dev):
    """Float32 serving from the evaluation dataset: a forward through the
    kernels against the twins, and the capture rollout."""
    from makani_tpu_torch.utils.inferencer import Inferencer
    rec = {}
    sht.set_transform_precision("high")
    complex_ops.set_contraction_precision("high")
    inferencer = Inferencer(files_params(), device=dev)
    check(len(inferencer.valid_dataset) == FILES_EVAL,
          f"{len(inferencer.valid_dataset)} evaluation windows, expected {FILES_EVAL}")
    inp, tar, zen_inp, zen_tar = (f[None] for f in inferencer.valid_dataset[0])
    check(tar.shape == (1, FILES_AUTOREG + 1, FILES_CHANNELS, *FILES_SHAPE)
          and zen_tar.shape == (1, FILES_AUTOREG + 1, 1, *FILES_SHAPE),
          f"evaluation sample {tar.shape}, {zen_tar.shape}")
    model = inferencer.model
    x = model.preprocessor.flatten_history(torch.from_numpy(inp).to(dev))
    u = torch.from_numpy(zen_inp).to(dev)
    with torch.inference_mode():
        model(x, unpredicted_inp=u)  # warm-up: the 109-channel encoder's cuBLAS set-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        y_kernel = model(x, unpredicted_inp=u)
        torch.cuda.synchronize()
        rec["forward_ms"] = (time.perf_counter() - t0) * 1e3
        rec["launches_per_forward"] = dict(kernels.launches)
        sht.set_coeff_engine("stacked")
        y_plain = model(x, unpredicted_inp=u)
        sht.set_coeff_engine("kernel")
    check(rec["launches_per_forward"] == launch_counts(kernels, {"legmm": 18, "gridmm": 18,
                                                                 "dhconv_mm": 8}),
          f"phase 10 launches per forward {rec['launches_per_forward']}")
    check(tuple(y_kernel.shape) == (1, FILES_CHANNELS, *FILES_SHAPE)
          and bool(torch.isfinite(y_kernel).all()),
          f"phase 10 forward {tuple(y_kernel.shape)}")
    rec["forward_rel_err"] = rel_err(y_kernel, y_plain.double())
    check(rec["forward_rel_err"] < FORWARD_TOL,
          f"109-channel forward kernels vs twins: {rec['forward_rel_err']}")
    del y_kernel, y_plain, x, u

    # the capture rollout, zenith advancing from the targets' times: one
    # untimed, then ROLLOUT_REPS timed
    steps = FILES_AUTOREG + 1
    inferencer._rollout_capture(inp, tar, zen_inp, zen_tar)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for rep in range(ROLLOUT_REPS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        preds, targs = inferencer._rollout_capture(inp, tar, zen_inp, zen_tar)
        times.append((time.perf_counter() - t0) * 1e3 / steps)
        if rep == 0:
            rec["rollout_launches"] = dict(kernels.launches)
            check(preds.shape == targs.shape == (steps, 1, FILES_CHANNELS, *FILES_SHAPE)
                  and bool(np.isfinite(preds).all()), f"phase 10 rollout {preds.shape}")
            check(np.array_equal(targs[:, 0], tar[0]), "phase 10 rollout targets")
        del preds, targs
    rec["rollout_peak_bytes"] = torch.cuda.max_memory_allocated()
    rec.update(rollout_steps=steps, step_ms_all=times, step_ms=statistics.median(times))
    check(rec["rollout_launches"] == launch_counts(kernels, {"legmm": 18 * steps,
                                                             "gridmm": 18 * steps,
                                                             "dhconv_mm": 8 * steps}),
          f"phase 10 rollout launches {rec['rollout_launches']}")
    del inferencer, model
    torch.cuda.empty_cache()
    return rec



def dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_checkpoint(torch, trainer):
    """Phase 11 (a): phase 10's trained model and AdamW state (bf16 moments)
    saved with save_checkpoint, restored into a fresh model and state, every
    tensor bit for bit."""
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
        wait_for_saves,
    )
    from makani_tpu_torch.utils.optimizers import build_optimizer
    rec = {"disk_free_bytes": shutil.disk_usage(FILES_DIR).free}
    counters = {"iters": trainer.iters, "epoch": trainer.epoch}
    torch.cuda.synchronize()
    # the save returns once the tensors are on the host; the files are
    # written in the background, so save_s takes the wait for them too
    t0 = time.perf_counter()
    save_checkpoint(str(SERVE_CKPT), trainer.model.state_dict(), trainer.opt_state, counters)
    rec["copy_s"] = time.perf_counter() - t0
    wait_for_saves()
    rec["save_s"] = time.perf_counter() - t0
    rec["bytes"] = dir_bytes(SERVE_CKPT)
    rec["model_bytes"] = (SERVE_CKPT / "model.pt").stat().st_size

    params = trainer.params
    model = get_model(params, device=trainer.device,
                      generator=torch.Generator(device=trainer.device).manual_seed(99))
    fresh = build_optimizer(params).init({k: p.detach() for k, p in model.named_parameters()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    weights, opt_state, got_counters = restore_checkpoint(str(SERVE_CKPT), model.state_dict(),
                                                          fresh)
    model.load_state_dict(weights)
    torch.cuda.synchronize()
    rec["restore_s"] = time.perf_counter() - t0
    want = trainer.model.state_dict()
    got = model.state_dict()
    check(set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
          "restored parameters differ from the trained ones")
    adam, want_adam = opt_state[0], trainer.opt_state[0]
    check(adam.count == want_adam.count == TRAIN_STEPS and got_counters == counters,
          f"restored count {adam.count} / {want_adam.count}, counters {got_counters}")
    for name in ("mu", "nu"):
        got_m, want_m = getattr(adam, name), getattr(want_adam, name)
        check(set(got_m) == set(want_m) and all(
            got_m[k].dtype == want_m[k].dtype == torch.bfloat16 and torch.equal(got_m[k], want_m[k])
            for k in want_m), f"restored {name} differs from the trained one")
    rec.update(n_tensors=len(want), save_gb_per_s=rec["bytes"] / rec["save_s"] / 1e9,
               restore_gb_per_s=rec["bytes"] / rec["restore_s"] / 1e9)
    return rec


def exports(np, exp_dir):
    return {name: np.load(Path(exp_dir) / name) for name in SERVE_EXPORTS}


def export_err(np, got, want):
    return max(float(np.abs(got[k].astype(np.float64) - want[k]).max() / np.abs(want[k]).max())
               for k in want)


def serve_params(**overrides):
    return files_params(checkpoint_path=str(SERVE_CKPT), **overrides)


def phase_serve(torch, np, sht, complex_ops, kernels, dev):
    """Phase 11 (b)-(e): scoring from the restored checkpoint on the
    evaluation files, inference_single / inference_lite / predict, the
    inference CLI in a subprocess, and a model package's TimeLoop; float32
    at "high", the port's default, which the CLI runs at too."""
    import yaml
    from makani_tpu_torch.models.model_package import load_time_loop, save_model_package
    from makani_tpu_torch.utils.checkpoint import save_checkpoint
    from makani_tpu_torch.utils.inferencer import Inferencer
    sht.set_transform_precision("high")
    complex_ops.set_contraction_precision("high")
    rec = {}
    steps = FILES_AUTOREG + 1
    scored_steps = FILES_EVAL * steps
    exp = {name: FILES_DIR / "score" / name for name in ("kernel", "twin")}
    for d in exp.values():
        d.mkdir(parents=True)

    # (b) score_model through the kernels, then through the twins
    inferencer = Inferencer(serve_params(experiment_dir=str(exp["kernel"])), device=dev)
    params = inferencer.params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    logs = inferencer.score_model(output_channels=params.out_channels)
    torch.cuda.synchronize()
    rec["score_s"] = time.perf_counter() - t0
    rec["score_peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["score_launches"] = dict(kernels.launches)
    rec["score_launches_by_passes"] = {f"{k}/p{p}": v
                                       for (k, p), v in kernels.launches_by_passes.items()}
    rec["launches_per_scored_step"] = {k: v // scored_steps for k, v in
                                       rec["score_launches"].items()}
    check(rec["score_launches"] == launch_counts(kernels, {"legmm": 18 * scored_steps,
                                                           "gridmm": 18 * scored_steps,
                                                           "dhconv_mm": 8 * scored_steps})
          and dict(kernels.launches_by_passes) == {("legmm", 3): 18 * scored_steps,
                                                   ("gridmm", 3): 18 * scored_steps,
                                                   ("dhconv_mm", 3): 8 * scored_steps},
          f"score launches {rec['score_launches']}, by passes {rec['score_launches_by_passes']}")
    base = logs["base"]
    check(base["validation steps"] == FILES_EVAL
          and all(math.isfinite(base[k]) for k in ("validation loss", "validation L1")),
          f"score logs {base}")
    got = exports(np, exp["kernel"])
    shapes = {"acc_curves.npy": (FILES_CHANNELS, steps), "rmse_curves.npy": (FILES_CHANNELS, steps),
              "RMSE_over_time.npy": (steps, FILES_CHANNELS),
              "RMSE_over_space.npy": (FILES_CHANNELS, *FILES_SHAPE)}
    check(all(got[k].shape == shapes[k] and np.isfinite(got[k]).all() for k in shapes),
          f"exports {({k: v.shape for k, v in got.items()})}")
    rec.update(logs_base=base, score_ms_per_step=rec["score_s"] * 1e3 / scored_steps)

    # a scored step on a resident batch: the metrics rollout alone
    inp, tar, zen_inp, zen_tar = inferencer._get_batch(0)
    times = []
    for _ in range(ROLLOUT_REPS):
        buffers, (rt, rs) = inferencer.metrics.initialize_buffers(), \
            inferencer._zero_accumulators()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inferencer._rollout_metrics(buffers, rt, rs, inp, tar, zen_inp, zen_tar)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    rec.update(metrics_step_ms_all=times, metrics_step_ms=statistics.median(times))

    sht.set_coeff_engine("stacked")
    try:
        inferencer.params["experiment_dir"] = str(exp["twin"])
        twin_logs = inferencer.score_model(output_channels=params.out_channels)
    finally:
        sht.set_coeff_engine("kernel")
        inferencer.params["experiment_dir"] = str(exp["kernel"])
    rec["score_rel_err_twin"] = export_err(np, got, exports(np, exp["twin"]))
    rec["loss_rel_err_twin"] = abs(base["validation loss"] - twin_logs["base"]["validation loss"]) \
        / abs(twin_logs["base"]["validation loss"])
    check(rec["score_rel_err_twin"] < FORWARD_TOL and rec["loss_rel_err_twin"] < FORWARD_TOL,
          f"scoring kernels vs twins: exports {rec['score_rel_err_twin']}, loss "
          f"{rec['loss_rel_err_twin']}")

    # (c) inference_single, inference_lite with perturbation and persistence,
    # predict
    targ, pred = inferencer.inference_single(ic=0, compute_metrics=True, output_data=True,
                                             output_channels=[0, 1, 2])
    single_logs = inferencer.metrics.logs["base"]
    check(pred.shape == targ.shape == (steps, 1, 3, *FILES_SHAPE)
          and bool(np.isfinite(pred).all())
          and all(math.isfinite(single_logs[k]) for k in ("validation loss", "validation L1"))
          and np.array_equal(targ[:, 0], tar[0, :, :3].cpu().numpy()),
          f"inference_single {pred.shape}, logs {single_logs}")
    del targ, pred
    ic = inp.cpu().numpy()
    seen = {}
    rollout_lite = inferencer._rollout_lite

    def recording_rollout(x, *args):
        seen["inp"] = x.cpu().numpy()
        return rollout_lite(x, *args)
    inferencer._rollout_lite = recording_rollout
    inferencer.ic_perturbation_std = SERVE_PERTURBATION
    inferencer.sst_persistence_channels = (SERVE_PERSISTENCE,)
    try:
        (lite,) = inferencer.inference_lite(ic=0, output_data=True,
                                            output_channels=list(range(FILES_CHANNELS)))
    finally:
        del inferencer._rollout_lite
        inferencer.ic_perturbation_std = None
        inferencer.sst_persistence_channels = ()
    rng = np.random.RandomState(42)
    want_inp = ic.copy()
    for ch, std in SERVE_PERTURBATION.items():
        want_inp[:, :, ch] += rng.normal(0.0, std, FILES_SHAPE).astype(np.float32)
    check(np.array_equal(seen["inp"], want_inp)
          and not np.array_equal(seen["inp"], ic), "the perturbed input is not the IC plus "
          "RandomState(42)'s draws")
    check(lite.shape == (steps, 1, FILES_CHANNELS, *FILES_SHAPE) and bool(np.isfinite(lite).all())
          and all(np.array_equal(lite[s, 0, SERVE_PERSISTENCE], ic[0, -1, SERVE_PERSISTENCE])
                  for s in range(steps)), "inference_lite: the persisted channel moved")
    del lite, seen
    predicted = inferencer.predict(ic=0)
    check(predicted.shape == (steps, FILES_CHANNELS, *FILES_SHAPE)
          and bool(np.isfinite(predicted).all()), f"predict {predicted.shape}")
    del predicted

    # (d) the inference CLI, --mode epoch, in a subprocess
    cfg = {k: v for k, v in serve_params().to_dict().items() if not k.startswith("_")}
    cfg.update(exp_dir=str(FILES_DIR / "cli"))
    yaml_path = FILES_DIR / "serve.yaml"
    yaml_path.write_text(yaml.safe_dump({"chip_smoke_serve": cfg}))
    log = ROOT / "build" / "chip_smoke_cli.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run(
            ["timeout", "-k", "10", str(CLI_TIMEOUT), sys.executable, "-m",
             "makani_tpu_torch.inference", "--yaml_config", str(yaml_path), "--config",
             "chip_smoke_serve", "--mode", "epoch", "--run_num", "0", "--checkpoint_path",
             str(SERVE_CKPT)], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    rec["cli_s"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"the inference CLI returned {proc.returncode}: "
          + log.read_text()[-3000:])
    rec["cli_rel_err"] = export_err(np, exports(np, FILES_DIR / "cli" / "chip_smoke_serve" / "0"),
                                    got)
    check(rec["cli_rel_err"] < TWIN_TOL, f"CLI exports vs in-process: {rec['cli_rel_err']}")

    # (e) a model package, the model alone as best_ckpt, .npy invariants
    pkg = FILES_DIR / "package"
    params["experiment_dir"] = str(pkg)  # the resolved params of the Inferencer
    save_model_package(params)
    save_checkpoint(str(pkg / "training_checkpoints" / "best_ckpt"),
                    inferencer.model.state_dict())
    rec["package_bytes"] = dir_bytes(pkg)
    check({"orography.npy", "land_mask.npy"} <= {p.name for p in pkg.iterdir()},
          f"package files {sorted(p.name for p in pkg.iterdir())}")
    del inferencer
    torch.cuda.empty_cache()
    loop = load_time_loop(str(pkg), device=dev)
    means = np.load(params.global_means_path)[0, :, 0, 0]
    stds = np.load(params.global_stds_path)[0, :, 0, 0]
    x = ic[:, -1:] * stds[:, None, None] + means[:, None, None]
    t_start = datetime.datetime(2021, 1, 1, tzinfo=datetime.timezone.utc)

    def run_loop():
        out, times = [], []
        it = loop(x, t_start)
        next(it)
        for _ in range(SERVE_LOOP_STEPS):
            t0 = time.perf_counter()
            out.append(next(it)[1])
            times.append((time.perf_counter() - t0) * 1e3)
        return out, times
    kernels.reset_launches()
    fields, times = run_loop()
    rec["loop_launches"] = dict(kernels.launches)
    sht.set_coeff_engine("stacked")
    try:
        twin_fields, _ = run_loop()
    finally:
        sht.set_coeff_engine("kernel")
    rec["loop_rel_err_twin"] = max(
        float(np.abs(f.astype(np.float64) - t).max() / np.abs(t).max())
        for f, t in zip(fields, twin_fields))
    check(all(f.shape == (1, FILES_CHANNELS, *FILES_SHAPE) and np.isfinite(f).all()
              for f in fields) and rec["loop_rel_err_twin"] < FORWARD_TOL,
          f"TimeLoop kernels vs twins: {rec['loop_rel_err_twin']}")
    check(rec["loop_launches"] == launch_counts(kernels, {"legmm": 18 * SERVE_LOOP_STEPS,
                                                          "gridmm": 18 * SERVE_LOOP_STEPS,
                                                          "dhconv_mm": 8 * SERVE_LOOP_STEPS}),
          f"TimeLoop launches {rec['loop_launches']}")
    rec.update(loop_step_ms_all=times, loop_step_ms=statistics.median(times))
    del loop
    torch.cuda.empty_cache()
    return rec

def train_yaml(epochs):
    """The YAML of phase 12: the canonical recipe on phase 10's dataset, cut
    as TRAIN_CUTS lists, with `epochs` epochs."""
    import yaml
    from makani_tpu_torch.utils.yparams import YParams
    cfg = YParams(str(ROOT / "config" / "sfnonet.yaml"), CANONICAL).to_dict()
    cfg = {k: v for k, v in cfg.items() if not k.startswith("_")}
    paths = files_params()
    cfg.update({k: paths[k] for k in (
        "metadata_json_path", "train_data_path", "valid_data_path", "inf_data_path",
        "global_means_path", "global_stds_path", "time_means_path", "time_diff_means_path",
        "time_diff_stds_path", "min_path", "max_path", "orography_path", "landmask_path")})
    cfg.update(n_train_samples_per_epoch=FILES_TRAIN_SAMPLES - 1, n_eval_samples=FILES_EVAL,
               valid_autoreg_steps=FILES_AUTOREG, scheduler_step_size=1,
               checkpoint_max_to_keep=TRAIN_KEEP, max_epochs=epochs, exp_dir=str(TRAIN_DIR))
    path = FILES_DIR / "train.yaml"
    path.write_text(yaml.safe_dump({TRAIN_CONFIG: cfg}))
    return path


def host_state(torch, trainer):
    """The weights, the Adam state and the counters of a Trainer, on the
    host (bf16 moments as they are)."""
    def host(tensors):
        return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}
    adam = trainer.opt_state[0]
    return dict(model=host(trainer.model.state_dict()), count=adam.count, mu=host(adam.mu),
                nu=host(adam.nu), counters=trainer.counters())


def state_equal(torch, got, want):
    return (got["count"] == want["count"] and got["counters"] == want["counters"]
            and all(set(got[n]) == set(want[n]) and all(
                got[n][k].dtype == want[n][k].dtype and torch.equal(got[n][k], want[n][k])
                for k in want[n]) for n in ("model", "mu", "nu")))


def trace_names(trace_path):
    """The port's kernels a Chrome trace names, by tools/profile_forward's
    map."""
    from makani_tpu_torch.tools.profile_forward import _OWN, device_events
    names = {e["name"] for e in device_events(trace_path)[1] if e["cat"] == "kernel"}
    return sorted({label for key, label in _OWN.items()
                   if any(key + end in n for n in names for end in "<(,")})


def phase_trainer(torch, np, kernels, dev):
    """Phase 12: the canonical recipe through makani_tpu_torch.train.main,
    2 epochs with validation and checkpoints, a resume for a third, and the
    DebugNet self-test in a subprocess."""
    from unittest import mock
    from makani_tpu_torch import train
    from makani_tpu_torch.utils import checkpoint as ckpt_lib
    from makani_tpu_torch.utils.trainer import Trainer
    # phase 11's checkpoint, package and exports go first
    for name in ("ckpt", "package", "score", "cli"):
        shutil.rmtree(FILES_DIR / name, ignore_errors=True)
    rec = {"disk_free_bytes": shutil.disk_usage(FILES_DIR).free}
    # three checkpoints of 4.58 GB on disk, a fourth being written, and the
    # package and the trace
    need = 4 * 4.6e9 + 1e9
    check(rec["disk_free_bytes"] >= need,
          f"phase 12 needs {need / 1e9:.1f} GB of disk, {rec['disk_free_bytes'] / 1e9:.1f} GB "
          f"free: {(need - rec['disk_free_bytes']) / 1e9:.1f} GB short")
    argv = ["--yaml_config", str(train_yaml(TRAIN_EPOCHS)), "--config", TRAIN_CONFIG,
            "--amp_mode", "bf16"]
    exp = TRAIN_DIR / TRAIN_CONFIG / "00"
    ckpt_dir = exp / "training_checkpoints" / "ckpt"
    best_dir = exp / "training_checkpoints" / "best_ckpt"

    # (a) 2 epochs with validation and checkpoints, the first 2 steps traced
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    writes_before = len(ckpt_lib.write_times())
    t0 = time.perf_counter()
    trainer = train.main(argv + ["--profile", "2"])
    torch.cuda.synchronize()
    rec["run_a_s"] = time.perf_counter() - t0
    rec["launches"] = dict(kernels.launches)
    by_passes = dict(kernels.launches_by_passes)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    params = trainer.params
    check(params.N_in_channels == FILES_IN_CHANNELS and params.optimizer_type == "AdamW"
          and params.optimizer_beta2 == 0.95 and params.optimizer_moment_dtype == "bfloat16"
          and params.loss == "weighted squared temp-std geometric l2"
          and params.scheduler == "StepLR" and trainer.amp_dtype == torch.bfloat16,
          f"phase 12's recipe: {params.N_in_channels} channels, {params.optimizer_type} beta2 "
          f"{params.optimizer_beta2}, moments {params.optimizer_moment_dtype}, loss "
          f"{params.loss!r}, {params.scheduler}, amp {trainer.amp_dtype}")
    epochs = trainer.epoch_logs
    rec["epochs"] = [dict(train_losses=e["train"]["step losses"], lrs=e["train"]["step lrs"],
                          valid_base=e["valid"]["base"], timing=e["timing"],
                          data_wait_frac=e["data_wait_frac"]) for e in epochs]
    check(len(epochs) == TRAIN_EPOCHS and all(
        len(e["train"]["step losses"]) == TRAIN_STEPS
        and all(math.isfinite(v) for v in e["train"]["step losses"])
        and e["valid"]["base"]["validation steps"] == FILES_EVAL
        and math.isfinite(e["valid"]["base"]["validation loss"]) for e in epochs),
          f"phase 12 epochs {rec['epochs']}")
    lrs = [e["train"]["step lrs"] for e in epochs]
    check(all(lr == lrs[0][0] for lr in lrs[0]) and all(lr == lrs[0][0] / 2 for lr in lrs[1]),
          f"StepLR per step {lrs}")
    steps = sorted(int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit())
    counters = json.loads((ckpt_dir / "counters-2.json").read_text())
    check(steps == [1, 2] and ckpt_lib.checkpoint_exists(str(best_dir))
          and (counters["iters"], counters["epoch"]) == (TRAIN_EPOCHS * TRAIN_STEPS, TRAIN_EPOCHS),
          f"checkpoint steps {steps}, best {best_dir.exists()}, counters iters "
          f"{counters['iters']} epoch {counters['epoch']}")
    rec["trace_kernels"] = trace_names(trainer.profile_path)
    rec["trace_bytes"] = Path(trainer.profile_path).stat().st_size
    check({"legmm", "gridmm", "dhconv_mm"} <= set(rec["trace_kernels"]),
          f"the profiler trace names {rec['trace_kernels']}")
    n_valid = TRAIN_EPOCHS * FILES_EVAL * (FILES_AUTOREG + 1)
    n_train = TRAIN_EPOCHS * TRAIN_STEPS
    train_step = {**TRAIN_LAUNCHES, **AMP_TRAIN_GELU}
    want = {k: n_train * train_step.get(k, 0) + n_valid * VALID_STEP_LAUNCHES.get(k, 0)
            for k in set(train_step) | set(VALID_STEP_LAUNCHES)}
    check(rec["launches"] == launch_counts(kernels, want) and at_one_pass(kernels),
          f"phase 12 (a) launches {rec['launches']} over {n_train} train and {n_valid} "
          f"validation steps, by passes {by_passes}")
    rec.update(train_steps=n_train, valid_steps=n_valid)

    # each save: bytes, the synchronous copy, the background write, and the
    # waits that exposed a write (at the next epoch's checkpoint decision and
    # at the end of train)
    # (one background write a save, in the order of the saves)
    writes = ckpt_lib.write_times()[writes_before:]
    check(len(writes) == len(trainer.checkpoint_log),
          f"{len(writes)} writes for {len(trainer.checkpoint_log)} saves")
    rec["saves"] = []
    for (epoch, _, copy_s), (path, write_s) in zip(trainer.checkpoint_log, writes):
        rec["saves"].append(dict(epoch=epoch, path=str(Path(path).relative_to(FILES_DIR)),
                                 copy_s=copy_s, write_s=write_s, bytes=dir_bytes(path)))
    rec["waits_s"] = list(trainer.checkpoint_waits)
    rec["write_s"] = sum(s["write_s"] for s in rec["saves"])
    rec["hidden_s"] = rec["write_s"] - sum(rec["waits_s"])

    # a validation AR step on a resident batch: one rollout untimed, then 3
    batch = trainer._device_batch(tuple(f[None] for f in trainer.valid_dataset[0]))
    buffers = trainer.metrics.initialize_buffers()
    trainer.eval_step(buffers, *batch)
    times = []
    for rep in range(ROLLOUT_REPS):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.eval_step(buffers, *batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / (FILES_AUTOREG + 1))
        if rep == 0:
            rec["valid_step_launches"] = {k: v // (FILES_AUTOREG + 1)
                                          for k, v in kernels.launches.items()}
            check(dict(kernels.launches) == launch_counts(kernels, {
                k: v * (FILES_AUTOREG + 1) for k, v in VALID_STEP_LAUNCHES.items()})
                  and at_one_pass(kernels), f"validation AR step launches {kernels.launches}")
    rec.update(valid_step_ms_all=times, valid_step_ms=statistics.median(times))
    saved = host_state(torch, trainer)
    del trainer, batch, buffers
    torch.cuda.empty_cache()

    # (b) one more epoch: resume from epoch 2, the restored state checked
    # before the epoch runs
    restored = {}
    train_epochs = Trainer.train

    def checked_train(self):
        restored.update(host_state(torch, self), start=self.startEpoch)
        return train_epochs(self)
    argv[1] = str(train_yaml(TRAIN_EPOCHS + 1))
    kernels.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(Trainer, "train", checked_train):
        trainer = train.main(argv)
    torch.cuda.synchronize()
    rec["run_b_s"] = time.perf_counter() - t0
    rec["resume_launches"] = dict(kernels.launches)
    check(trainer.params.resuming and restored["start"] == TRAIN_EPOCHS
          and state_equal(torch, restored, saved),
          "the resumed Trainer's weights, moments, counters, scheduler or generator differ "
          "from run (a)'s")
    steps = sorted(int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit())
    last = trainer.epoch_logs
    check(len(last) == 1 and (trainer.iters, trainer.epoch) == (3 * TRAIN_STEPS, 3)
          and steps == [2, 3] and all(lr == lrs[0][0] / 4 for lr in last[0]["train"]["step lrs"])
          and math.isfinite(last[0]["valid"]["base"]["validation loss"]),
          f"resume: {len(last)} epochs, iters {trainer.iters}, epoch {trainer.epoch}, steps "
          f"{steps}, lrs {[e['train']['step lrs'] for e in last]}")
    rec["resume_epoch"] = dict(train_losses=last[0]["train"]["step losses"],
                               lrs=last[0]["train"]["step lrs"],
                               valid_base=last[0]["valid"]["base"], timing=last[0]["timing"],
                               data_wait_frac=last[0]["data_wait_frac"])
    del trainer, saved, restored
    torch.cuda.empty_cache()

    # (c) the DebugNet self-test in a subprocess, on the same YAML
    log = ROOT / "build" / "chip_smoke_selftest.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run(
            ["timeout", "-k", "10", str(CLI_TIMEOUT), sys.executable, "-m",
             "makani_tpu_torch.train", *argv, "--mode", "test", "--run_num", "selftest"],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    rec["selftest_s"] = time.perf_counter() - t0
    out = log.read_text()
    check(proc.returncode == 0 and " 0 errors found" in out,
          f"the self-test returned {proc.returncode}: " + out[-3000:])
    rec["selftest_line"] = next((line for line in out.splitlines() if "errors found" in line), "")
    return rec


def icml_launches(level, unroll, linear=True):
    """Launches of one ICML train step at checkpointing `level` with `unroll`
    steps unrolled: per unrolled step a forward
    and its backward (18 legmm and 18 gridmm each way, 8 dhconv_mm forward
    and 8 dx, 8 dhconv_dw, 18 GELU each way), plus what checkpointing
    recomputes (from level 1 the encoder's and the decoder's GELU, from
    level 2 the MLPs' 8, at level 3 the blocks' forward: 18 legmm, 18
    gridmm, 8 dhconv_mm, 16 GELU); one fused_adam for all the leaves."""
    gelu = 18 + (2 if level >= 1 else 0) + (8 if level >= 2 else 0) + (16 if level >= 3 else 0)
    sht_calls = 36 + (18 if level >= 3 else 0)
    step = {"legmm": sht_calls, "gridmm": sht_calls, "gelu_bf16": gelu, "gelu_bf16_grad": 18}
    if linear:
        step.update(dhconv_mm=16 + (8 if level >= 3 else 0), dhconv_dw=8)
    out = {k: v * unroll for k, v in step.items()}
    out["fused_adam"] = 1
    return out


def run_yaml(yaml_file, name, directory, steps, **overrides):
    """A YAML holding config/`yaml_file`'s `name` on phase 10's dataset, cut
    to batch 1 and one epoch of `steps` steps, its experiments under
    `directory`."""
    import yaml
    from makani_tpu_torch.utils.yparams import YParams
    cfg = YParams(str(ROOT / "config" / yaml_file), name).to_dict()
    cfg = {k: v for k, v in cfg.items() if not k.startswith("_")}
    paths = files_params()
    cfg.update({k: paths[k] for k in (
        "metadata_json_path", "train_data_path", "valid_data_path", "inf_data_path",
        "global_means_path", "global_stds_path", "time_means_path", "time_diff_means_path",
        "time_diff_stds_path", "min_path", "max_path")})
    cfg.update(channel_names=[f"c{i}" for i in range(FILES_CHANNELS)], batch_size=1,
               max_epochs=1, n_train_samples_per_epoch=steps,
               n_eval_samples=FILES_EVAL, valid_autoreg_steps=FILES_AUTOREG,
               exp_dir=str(directory), **overrides)
    path = directory / f"{name}.yaml"
    path.write_text(yaml.safe_dump({name: cfg}))
    return path


def icml_yaml(name, **overrides):
    """A YAML holding config/icml_models.yaml's `name` on phase 10's dataset,
    cut as ICML_CUTS lists."""
    return run_yaml("icml_models.yaml", name, ICML_DIR, ICML_STEPS[name], **overrides)


def main_run(torch, kernels, name, argv, steps):
    """makani_tpu_torch.train.main(argv) for `steps` steps of config `name`;
    returns the Trainer and the run's record: launches, whether all ran at 1
    pass, peak memory, finite losses, leaves and parameters."""
    from makani_tpu_torch import train
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer = train.main(argv)
    torch.cuda.synchronize()
    run = dict(run_s=time.perf_counter() - t0, launches=dict(kernels.launches),
               peak_bytes=torch.cuda.max_memory_allocated(), one_pass=at_one_pass(kernels),
               losses=trainer.epoch_logs[-1]["train"]["step losses"],
               leaves=len(trainer.model_params),
               params=sum(p.numel() for p in trainer.model_params.values()))
    check(len(run["losses"]) == steps and all(map(math.isfinite, run["losses"])),
          f"{name}: losses {run['losses']}")
    return trainer, run


def icml_run(torch, kernels, name, level, *extra, **overrides):
    """makani_tpu_torch.train.main on `name` under bf16 AMP without
    validation; returns the Trainer and the run's record (main_run's, and
    the checkpointing level)."""
    argv = ["--yaml_config", str(icml_yaml(name, **overrides)), "--config", name,
            "--amp_mode", "bf16", "--skip_validation", "--checkpointing_level", str(level),
            *extra]
    trainer, run = main_run(torch, kernels, name, argv, ICML_STEPS[name])
    run["level"] = level
    check(trainer.amp_dtype == torch.bfloat16 and trainer.model.model.checkpointing == level,
          f"{name}: amp {trainer.amp_dtype}, checkpointing {trainer.model.model.checkpointing}")
    return trainer, run


def host_enqueue_ms(torch, fn, reps):
    """Median host milliseconds to enqueue `fn` on an idle card (synchronized
    before each call, not after): where it reaches the CUDA-event time, the
    card waits on the host."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def resident_step_ms(torch, trainer):
    """A train step on a resident batch: one untimed, then 3 timed (host
    clock, synchronized); their median, all three, and their peak memory."""
    batch = trainer._device_batch(tuple(f[None] for f in trainer.train_dataset[0]))
    lr = trainer.scheduler(trainer.iters)
    trainer.train_step(*batch, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        trainer.train_step(*batch, lr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times, torch.cuda.max_memory_allocated()


def phase_icml(torch, np, spectral_mm, kernels, dev, gen):
    """Phase 13: the ICML recipes at full width on phase 10's dataset."""
    from unittest import mock
    from makani_tpu_torch.models.common import layers
    from makani_tpu_torch.utils.trainer import Trainer
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)  # phase 12's checkpoints
    ICML_DIR.mkdir(parents=True, exist_ok=True)
    rec = {"disk_free_bytes": shutil.disk_usage(FILES_DIR).free}

    # (a) the pretrain, one epoch, its per-epoch checkpoint written
    level = ICML_LEVELS[ICML_PRETRAIN]
    trainer, run = icml_run(torch, kernels, ICML_PRETRAIN, level)
    p = trainer.params
    check(p.N_in_channels == FILES_CHANNELS and p.embed_dim == 384 and p.num_layers == 8
          and p.scale_factor == 2 and p.hard_thresholding_fraction == 0.5
          and p.loss == "geometric l2" and p.optimizer_beta2 == 0.95
          and p.scheduler == "CosineAnnealingLR" and p.filter_type == "linear",
          f"{ICML_PRETRAIN}'s recipe: {p.N_in_channels} channels, embed {p.embed_dim}, "
          f"{p.num_layers} blocks, scale {p.scale_factor}, {p.loss!r}, {p.scheduler}")
    want = icml_launches(level, 1)
    check(run["launches"] == launch_counts(kernels, {k: v * ICML_STEPS[ICML_PRETRAIN]
                                                     for k, v in want.items()})
          and run["one_pass"], f"(a) launches {run['launches']}, a step {want}")
    ckpt = Path(p.checkpoint_path)
    check(ckpt.exists(), f"(a) wrote no checkpoint under {ckpt}")
    keep = ("residual_transform", "blocks.3.filter_layer.filter.weight", "encoder.fwd_0.weight")
    pretrained = {k: v.detach().to("cpu", copy=True)
                  for k, v in trainer.model.state_dict().items() if k.endswith(keep)}
    shapes = {k: tuple(v.shape) for k, v in trainer.model_params.items()}
    run["step_ms"], run["step_ms_all"], run["step_peak_bytes"] = resident_step_ms(torch, trainer)
    run["launches_per_step"] = want
    rec["pretrain"] = run
    del trainer
    torch.cuda.empty_cache()

    # (b) the 2-step finetune from (a)'s checkpoint: the restored weights
    # checked before its epoch runs
    restored = {}
    train_epochs = Trainer.train

    def checked_train(self):
        restored["equal"] = all(torch.equal(self.model.state_dict()[k].cpu(), v)
                                for k, v in pretrained.items())
        restored["count"] = self.adam_state().count
        return train_epochs(self)
    level = ICML_LEVELS[ICML_FINETUNE]
    with mock.patch.object(Trainer, "train", checked_train):
        trainer, run = icml_run(torch, kernels, ICML_FINETUNE, level, "--multistep_count", "2",
                                "--save_checkpoint", "none",
                                pretrained_checkpoint_path=str(ckpt))
    p = trainer.params
    check(p.finetune and p.n_future == 1 and p.N_target_channels == 2 * FILES_CHANNELS
          and type(trainer.model).__name__ == "MultiStepWrapper" and float(p.lr) == 2e-4,
          f"{ICML_FINETUNE}: finetune {p.finetune}, n_future {p.n_future}, lr {p.lr}")
    check(restored.get("equal") and restored.get("count") == 0,
          f"(b) did not start from (a)'s weights with a fresh optimizer: {restored}")
    # a 2-step unroll: twice a one-step train step's forward and backward
    # launches, one update
    one = icml_launches(level, 1)
    want = icml_launches(level, 2)
    check(all(want[k] == 2 * one[k] for k in one if k != "fused_adam")
          and run["launches"] == launch_counts(kernels, {k: v * ICML_STEPS[ICML_FINETUNE]
                                                         for k, v in want.items()})
          and run["one_pass"], f"(b) launches {run['launches']}, a step {want}")
    run["step_ms"], run["step_ms_all"], run["step_peak_bytes"] = resident_step_ms(torch, trainer)
    run["launches_per_step"] = want
    rec["finetune"] = run
    del trainer
    torch.cuda.empty_cache()

    # (c) the non-linear model, 3 steps
    level = ICML_LEVELS[ICML_NONLINEAR]
    trainer, run = icml_run(torch, kernels, ICML_NONLINEAR, level, "--save_checkpoint", "none")
    p = trainer.params
    filt = trainer.model.model.blocks[0].filter_layer.filter
    check(p.filter_type == "non-linear" and p.operator_type == "diagonal"
          and type(filt).__name__ == "SpectralAttention" and filt.spectral_layers == 3
          and tuple(filt.w_0.shape) == (384, 768, 2),
          f"{ICML_NONLINEAR}: {p.filter_type} {p.operator_type}, {type(filt).__name__}")
    want = icml_launches(level, 1, linear=False)
    check(run["launches"] == launch_counts(kernels, {k: v * ICML_STEPS[ICML_NONLINEAR]
                                                     for k, v in want.items()})
          and run["one_pass"], f"(c) launches {run['launches']}, a step {want}")
    run["step_ms"], run["step_ms_all"], run["step_peak_bytes"] = resident_step_ms(torch, trainer)
    run["launches_per_step"] = want
    rec["nonlinear"] = run
    del trainer
    torch.cuda.empty_cache()

    # (d) dropout at every site of the pretrain model at checkpointing 3:
    # the masks drawn, one per (site, step, unrolled step); a recomputed
    # block draws its forward's again
    drawn = {}
    draw = layers.drop_mask

    def recording(shape, keep, site, device):
        mask = draw(shape, keep, site, device)
        key = layers.current_dropout_key()
        drawn[(site, key.step, key.substep)] = (keep, int(mask.sum()), mask.numel())
        return mask
    rates = {k: ICML_DROP_RATE for k in ("pos_drop_rate", "path_drop_rate", "mlp_drop_rate")}
    with mock.patch.object(layers, "drop_mask", recording):
        trainer, run = icml_run(torch, kernels, ICML_PRETRAIN, ICML_DROPOUT_LEVEL,
                                "--save_checkpoint", "none", "--run_num", "dropout", **rates)
    n_sites = trainer.model.model.n_dropout_sites
    sites = {}
    for (site, _, _), (keep, kept, n) in drawn.items():
        _, k0, n0 = sites.get(site, (keep, 0, 0))
        sites[site] = (keep, k0 + kept, n0 + n)
    # the encoder's, 2 in each block's MLP, DropPath in blocks 1-7 (block 0's
    # rate is 0)
    check(len(sites) == 1 + 2 * 8 + 7 and n_sites == 1 + 3 * 8,
          f"(d) drew at {len(sites)} sites of {n_sites}")
    off = {s: (kept / n, n) for s, (keep, kept, n) in sites.items()
           if abs(kept / n - keep) > 5 * (keep * (1 - keep) / n) ** 0.5}
    check(not off, f"(d) kept fractions beyond 5 sigma: {off}")
    run["sites"] = {s: dict(keep=k, kept=kk, drawn=n) for s, (k, kk, n) in sorted(sites.items())}
    rec["dropout"] = run
    del trainer
    torch.cuda.empty_cache()
    rec["dropout_small"] = icml_small_dropout(torch, dev)

    # (e) LAMB (bf16 moments) and AdamW (float32 moments), both clipped, over
    # (a)'s leaves: kernel against twin, bit for bit, then timed
    rec["optimizers"] = icml_optimizers(torch, kernels, dev, gen, shapes)

    # (f) the matmul kernels at the ICML shapes: 180 degrees and orders, the
    # 360-row inner grid, the 721-row input grid
    rec["kernels"] = phase_kernels(torch, spectral_mm, dev, gen, mmax=180, Lin=180, Kin=360,
                                   Kfull=721, reps=10, plain_reps=2)
    shutil.rmtree(ICML_DIR, ignore_errors=True)
    return rec


def icml_small_dropout(torch, dev):
    """A small non-linear SFNO with dropout at every site on the card: the
    gradients of a 2-step unroll at checkpointing 0 and 3 are bit-equal."""
    from makani_tpu_torch.models.model_registry import update_channel_params
    from makani_tpu_torch.utils.trainer import Trainer
    from makani_tpu_torch.utils.yparams import YParams
    results = []
    for level in (0, 3):
        params = YParams(str(ROOT / "config" / "icml_models.yaml"), ICML_NONLINEAR)
        params.update_params(dict(
            img_shape_x=36, img_shape_y=72, embed_dim=32, num_layers=3, scale_factor=2,
            enable_synthetic_data=True, in_channels=list(range(5)), out_channels=list(range(5)),
            channel_names=[f"c{i}" for i in range(5)], batch_size=2,
            n_train_samples_per_epoch=2, n_eval_samples=2, n_future=1, log_video=0,
            skip_validation=True, save_checkpoint="none", finetune=False, checkpointing=level,
            log_to_screen=False, pos_drop_rate=0.2, path_drop_rate=0.3, mlp_drop_rate=0.25))
        update_channel_params(params)
        trainer = Trainer(params, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(3))
        trainer.iters = 5
        batch = trainer._device_batch(next(iter(trainer.train_dataloader)))
        results.append(trainer.loss_and_grads(*batch))
    (loss0, g0), (loss3, g3) = results
    differ = [k for k in g0 if not torch.equal(g0[k], g3[k])]
    check(torch.equal(loss0, loss3) and not differ,
          f"small SFNO with dropout: checkpointing 0 and 3 differ in {differ[:5]}, losses "
          f"{float(loss0)} {float(loss3)}")
    return dict(leaves=len(g0), loss=float(loss0))


def icml_optimizers(torch, kernels, dev, gen, shapes):
    """The fused_adam modes at full width: LAMB and clipped AdamW against
    their twin after one clipped update, one launch each; each timed (CUDA
    events, the card alone, and the host's time to enqueue an update) beside
    the plain mode, torch.optim.Adam(fused=True), and clipped AdamW as
    PyTorch's calls compute it (clip_grad_norm_(foreach=True), then
    torch.optim.AdamW(fused=True)). The bounds count what the update moves
    beyond the kernel: the clip's read of g (its global norm), and LAMB's
    trust-ratio passes (the norms of p and of the direction, and p - lr *
    ratio * dir: p and the direction read, p written)."""
    from makani_tpu_torch.ops import fused_adam
    from makani_tpu_torch.tools.bench_fused_adam import device_ms
    from makani_tpu_torch.utils.optimizers import AdamState, kernel_update_settings
    params = {k: torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
    grads = {k: 1e-2 * torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
    n = sum(math.prod(s) for s in shapes.values())
    norm = float(fused_adam.global_norm(grads.values()))
    rec = dict(leaves=len(shapes), elements=n, grad_norm=norm)
    configs = {
        "lamb": (dict(optimizer_type="LAMB", optimizer_moment_dtype="bfloat16",
                      weight_decay=0.01, optimizer_max_grad_norm=1.0), torch.bfloat16),
        "clipped_adamw": (dict(optimizer_type="AdamW", weight_decay=0.05,
                               gradient_clip_norm=1.0), torch.float32),
        "plain": (dict(optimizer_type="Adam", optimizer_moment_dtype="bfloat16"),
                  torch.bfloat16),
    }
    for name, (cfg, dtype) in configs.items():
        kw = kernel_update_settings(dict(cfg, optimizer_beta1=0.9, optimizer_beta2=0.95,
                                         global_seed=333))

        def state():
            return AdamState(0, {k: torch.zeros(s, device=dev, dtype=dtype)
                                 for k, s in shapes.items()},
                             {k: torch.zeros(s, device=dev, dtype=dtype)
                              for k, s in shapes.items()})
        s_kernel = state()
        kernel_p = {k: v.clone() for k, v in params.items()}
        kernels.reset_launches()
        fused_adam.fused_adam_apply(kernel_p, grads, s_kernel, 1e-3, **kw)
        torch.cuda.synchronize()
        launches = kernels.launches["fused_adam"]
        check(launches == 1, f"{name}: {launches} fused_adam launches in an update")
        twin_ms = None
        if name != "plain":
            check(kw["max_norm"] == 1.0 and norm > 1.0 and kw["lamb"] == (name == "lamb"),
                  f"{name}: settings {kw}, global norm {norm}")
            s_twin, twin_p = state(), {k: v.clone() for k, v in params.items()}
            t0 = time.perf_counter()
            fused_adam.fused_adam_apply_plain(twin_p, grads, s_twin, 1e-3, **kw)
            torch.cuda.synchronize()
            twin_ms = (time.perf_counter() - t0) * 1e3
            differ = [k for k in shapes if not (
                torch.equal(kernel_p[k], twin_p[k]) and torch.equal(s_kernel.mu[k], s_twin.mu[k])
                and torch.equal(s_kernel.nu[k], s_twin.nu[k]))]
            check(not differ, f"{name}: kernel and twin differ in {differ[:5]}")
            del s_twin, twin_p
            torch.cuda.empty_cache()
        def update():
            fused_adam.fused_adam_apply(kernel_p, grads, s_kernel, 1e-3, **kw)
        ms, dev_ms = cuda_ms(update, 5), device_ms(update, 5)
        enqueue_ms = host_enqueue_ms(torch, update, 5)
        # each input read once and each output written once: p, g and the two
        # moments read, p and the moments written; the clip reads g once more
        # for its norm; LAMB writes the direction and not p, then reads p and
        # the direction for their norms, and both again to write p
        nbytes = n * (4 + 4 + 4 + 4 * dtype.itemsize + (4 if kw["max_norm"] else 0)
                      + (20 if kw["lamb"] else 0))
        b_ms, b_by = bound(nbytes, 0)
        rec[name] = dict(launches=launches, ms=ms, device_ms=dev_ms, enqueue_ms=enqueue_ms,
                         plain_ms=twin_ms, bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9,
                         moments=str(dtype).split(".")[-1])
        del s_kernel, kernel_p
        torch.cuda.empty_cache()
    leaves = list(params.values())
    for p, g in zip(leaves, grads.values()):
        p.grad = g
    opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.95), eps=1e-8, fused=True)
    rec["library_ms"], rec["library_device_ms"] = cuda_ms(opt.step, 5), device_ms(opt.step, 5)
    rec["library_enqueue_ms"] = host_enqueue_ms(torch, opt.step, 5)
    del opt
    torch.cuda.empty_cache()
    # clipped AdamW (float32 moments) as PyTorch computes it: the clip scales
    # the gradients in place, then the fused AdamW
    opt = torch.optim.AdamW(leaves, lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.05,
                            fused=True)

    def clipped_adamw():
        torch.nn.utils.clip_grad_norm_(leaves, 1.0, foreach=True)
        opt.step()
    rec["library_adamw_ms"] = cuda_ms(clipped_adamw, 5)
    rec["library_adamw_device_ms"] = device_ms(clipped_adamw, 5)
    rec["library_adamw_enqueue_ms"] = host_enqueue_ms(torch, clipped_adamw, 5)
    del opt, leaves, params, grads
    torch.cuda.empty_cache()
    return rec


def print_icml(icml):
    """Phase 13's lines."""
    for cut in ICML_CUTS:
        print(f"[icml cut] {cut}")
    for tag, label in (("pretrain", f"(a) {ICML_PRETRAIN}"),
                       ("finetune", f"(b) {ICML_FINETUNE} --multistep_count 2 from (a)"),
                       ("nonlinear", f"(c) {ICML_NONLINEAR}"),
                       ("dropout", f"(d) {ICML_PRETRAIN} with dropout {ICML_DROP_RATE} at every "
                                   f"site")):
        r = icml[tag]
        timed = (f"; a train step on a resident batch {r['step_ms']:.1f} ms (median of "
                 f"{', '.join(f'{t:.1f}' for t in r['step_ms_all'])}), peak "
                 f"{r['step_peak_bytes'] / 2**30:.2f} GiB" if "step_ms" in r else "")
        print(f"[icml {tag}] {label}: {r['params']} parameters in {r['leaves']} leaves, bf16 AMP, "
              f"checkpointing {r['level']}; losses {r['losses']}; run {r['run_s']:.1f} s, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; launches {r['launches']}, all at 1 pass"
              + timed, flush=True)
    d = icml["dropout"]["sites"]
    print("[icml dropout] kept fraction by site (drawn elements): " + "; ".join(
        f"{site} {v['kept'] / v['drawn']:.5f} ({v['drawn']})" for site, v in d.items())
          + f"; small SFNO with dropout, checkpointing 0 and 3: gradients of its "
          f"{icml['dropout_small']['leaves']} leaves bit-equal", flush=True)
    o = icml["optimizers"]
    print(f"[icml optimizers] {o['elements']} elements in {o['leaves']} leaves, global gradient "
          f"norm {o['grad_norm']:.4g}: " + "; ".join(
              f"{name} ({o[name]['moments']} moments) {o[name]['ms']:.3f} ms (the card alone "
              f"{o[name]['device_ms']:.3f}, host enqueue {o[name]['enqueue_ms']:.3f})"
              + ("" if o[name]["plain_ms"] is None else
                 f", twin {o[name]['plain_ms']:.1f} ms, bit-identical")
              + f", {o[name]['launches']} launch, bound {o[name]['bound_ms']:.3f} ms "
              f"({o[name]['gbytes']:.2f} GB)"
              for name in ("lamb", "clipped_adamw", "plain"))
          + f"; torch.optim.Adam(fused=True), float32 moments, {o['library_ms']:.3f} ms (alone "
          f"{o['library_device_ms']:.3f}, host enqueue {o['library_enqueue_ms']:.3f}); "
          f"clip_grad_norm_(foreach=True) + AdamW(fused=True) {o['library_adamw_ms']:.3f} ms "
          f"(alone {o['library_adamw_device_ms']:.3f}, host enqueue "
          f"{o['library_adamw_enqueue_ms']:.3f})",
          flush=True)
    print("[icml kernels] name | shape | passes | rel err vs twin | vs f64 | ms | plain ms | "
          "library ms | bound ms (by)")
    for r in icml["kernels"]:
        print(f"  {r['name']} | {r['shape']} | p{r['passes']} | {r['rel_err_twin']:.3g} | "
              f"{r['rel_err_f64']:.3g} | {r['ms']:.4f} | {r['plain_ms']:.4f} | "
              f"{r['library_ms']:.4f} | {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)


def fno_launches(level):
    """Launches of one FNO train step at checkpointing `level`: the GELU
    kernels of icml_launches and one fused_adam a leaf; no legmm, gridmm or
    dhconv (the FFTs are cuFFT's, the diagonal and non-linear filters
    complex einsums, as makani_tpu leaves them to XLA)."""
    step = icml_launches(level, 1, linear=False)
    del step["legmm"], step["gridmm"]
    return step


def fno_run(torch, np, kernels, dev, gen, name):
    """Phase 14 (a) or (b): `name` trained through train.main at
    FNO_LEVELS[name] with its launches checked and a train step timed on a
    resident batch; then a 4-step Inferencer rollout of the trained model.
    Returns the run's record and the parameter shapes."""
    from makani_tpu_torch.utils.inferencer import Inferencer
    level = FNO_LEVELS[name]
    trainer, run = icml_run(torch, kernels, name, level, "--save_checkpoint", "none")
    p, net = trainer.params, trainer.model.model
    linear = name == FNO_LINEAR
    check(p.nettype == "FNO" and type(net).__name__ == "FourierNeuralOperatorNet"
          and type(net.trans_down).__name__ == "RealFFT2"
          and (net.trans_down.lmax, net.trans_down.mmax) == (180, 180)
          and p.embed_dim == (64 if linear else 384) and p.filter_type == (
              "linear" if linear else "non-linear") and p.operator_type == "diagonal",
          f"{name}: {p.nettype} {type(net).__name__}, embed {p.embed_dim}, {p.filter_type}")
    if linear:
        weight = net.blocks[1].filter_layer.filter.weight
        check(tuple(weight.shape) == (64, 64, 180, 180, 2), f"{name}: filter {weight.shape}")
    want = fno_launches(level)
    check(run["launches"] == launch_counts(kernels, {k: v * ICML_STEPS[name]
                                                     for k, v in want.items()})
          and run["one_pass"], f"{name} launches {run['launches']}, a step {want}")
    run["step_ms"], run["step_ms_all"], run["step_peak_bytes"] = resident_step_ms(torch, trainer)
    run["launches_per_step"] = want
    shapes = {k: tuple(v.shape) for k, v in trainer.model_params.items()}
    weights = trainer.model.state_dict()
    del trainer, net
    torch.cuda.empty_cache()
    p["valid_autoreg_steps"] = ROLLOUT_STEPS - 1
    inferencer = Inferencer(p, weights=weights, device=dev)
    del weights
    check(inferencer.amp_dtype == torch.bfloat16, f"{name}: the Inferencer is not under AMP")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x = torch.randn((1, FILES_CHANNELS, 721, 1440), device=dev, generator=gen)
    launches, times = timed_rollouts(torch, np, kernels, inferencer, x, f"{name} rollout")
    check(launches == launch_counts(kernels, {"gelu_bf16": 18 * ROLLOUT_STEPS}),
          f"{name} rollout launches {launches}")
    run.update(rollout_ms=statistics.median(times), rollout_ms_all=times,
               rollout_peak_bytes=torch.cuda.max_memory_allocated(), rollout_launches=launches)
    del inferencer, x
    torch.cuda.empty_cache()
    return run, shapes


def options_params(**overrides):
    """sfno_dhealy_73ch at full width with `overrides` (73 channels,
    synthetic data: the model alone)."""
    from makani_tpu_torch.models.model_registry import update_channel_params
    from makani_tpu_torch.utils.yparams import YParams
    p = YParams(str(ROOT / "config" / "icml_models.yaml"), ICML_PRETRAIN)
    p.update_params(dict(enable_synthetic_data=True, in_channels=list(range(FILES_CHANNELS)),
                         out_channels=list(range(FILES_CHANNELS)), **overrides))
    return update_channel_params(p)


def option_forward(torch, sht, kernels, dev, gen, x, extra_legmm=0, **overrides):
    """One float32 forward (3 passes) of sfno_dhealy_73ch with `overrides`,
    random weights from `gen`, through the kernels and through the twins."""
    from makani_tpu_torch.models.model_registry import get_model
    model = get_model(options_params(**overrides), device=dev, generator=gen)
    model.eval()
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        y = model(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.launches)
        sht.set_coeff_engine("stacked")
        y_plain = model(x)
        sht.set_coeff_engine("kernel")
    err = rel_err(y, y_plain.double())
    check(tuple(y.shape) == (1, FILES_CHANNELS, 721, 1440) and bool(torch.isfinite(y).all())
          and err < FORWARD_TOL, f"{overrides}: forward {tuple(y.shape)}, vs twins {err}")
    check(launches == launch_counts(kernels, {"legmm": 18 + extra_legmm,
                                              "gridmm": 18 + extra_legmm, "dhconv_mm": 8}),
          f"{overrides}: launches {launches}")
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    del model, y, y_plain
    torch.cuda.empty_cache()
    return dict(ms=ms, launches=launches, rel_err_twin=err), shapes


def factorized_step(torch, sht, complex_ops, kernels, dev, gen, x):
    """A CP-factorized dhconv filter on the "xla" engine with the complex
    dhconv kernel, under AMP (bf16 input, 1 pass): a forward and backward
    with its launches, the forward against the same weights with the
    kernel off (the complex einsum)."""
    from makani_tpu_torch.models.model_registry import get_model
    model = get_model(options_params(factorization="cp", rank=OPTION_RANK), device=dev,
                      generator=gen)
    filt = model.model.blocks[1].filter_layer.filter
    check(type(filt).__name__ == "FactorizedSpectralConv" and filt.weight.kind == "cp",
          f"factorized filter: {type(filt).__name__}")
    xb = x.to(torch.bfloat16)
    complex_ops.enable_pallas_kernels(True)
    model(xb).float().square().mean().backward()   # warm-up
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    y = model(xb)
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launches)
    one_pass = at_one_pass(kernels)
    check(launches == launch_counts(kernels, {"dhconv_complex": 16, "gridmm": 36,
                                              "gelu_bf16": 18, "gelu_bf16_grad": 18})
          and one_pass,
          f"factorized launches {launches}")
    grads = [p.grad for n, p in model.named_parameters() if ".weight." in n]
    check(len(grads) == 4 * 8 and all(g is not None and bool(torch.isfinite(g).all())
                                      for g in grads), "factorized gradients")
    with torch.no_grad():
        complex_ops.enable_pallas_kernels(False)
        y_einsum = model(xb)
    deviation = dev_norm(y.float().double(), y_einsum.float().double())
    check(deviation < AMP_DEV_MAX, f"factorized forward, kernel vs einsum: {deviation}")
    rank = filt.weight.get_parameter("factor_0").shape[1]
    del model, y, y_einsum, grads
    torch.cuda.empty_cache()
    return dict(ms=ms, launches=launches, rank=rank, dev_einsum=deviation)


def csphase_pair(torch, np, sht, kernels, dev, gen):
    """The SHT pair without the Condon-Shortley phase at the ICML shapes (the
    721x1440 equiangular grid and the 360x720 Legendre-Gauss grid, 180
    degrees and orders, 64 channels) through legmm at 3 passes, against the
    same transforms in float64 (phase 3's 5e-5)."""
    from makani_tpu_torch.ops.dft import irdft_matrices, rdft_matrices
    from makani_tpu_torch.ops.legendre import precompute_legpoly
    rec = {}
    kernels.reset_launches()
    for nlat, nlon, grid in ((721, 1440, "equiangular"), (360, 720, "legendre-gauss")):
        fwd = sht.RealSHT(nlat, nlon, 180, 180, grid=grid, csphase=False, device=dev)
        inv = sht.InverseRealSHT(nlat, nlon, 180, 180, grid=grid, csphase=False, device=dev)
        tq, wq = sht._theta_weights(grid, nlat)
        pct = torch.from_numpy(precompute_legpoly(180, 180, tq, csphase=False)).to(dev,
                                                                                   torch.float64)
        C, S = (torch.from_numpy(a).to(dev, torch.float64)
                for a in rdft_matrices(nlon, 180, scale="integral"))
        Cs, Ss = (torch.from_numpy(a).to(dev, torch.float64)
                  for a in irdft_matrices(nlon, 180, scale="synthesis"))
        x = torch.randn((1, 64, nlat, nlon), device=dev, generator=gen)
        w = torch.from_numpy(wq.copy()).to(dev, torch.float64)[:, None]
        x64 = x.double()
        ref = torch.complex(torch.einsum("bckm,mlk->bclm", (x64 @ C) * w, pct),
                            torch.einsum("bckm,mlk->bclm", -(x64 @ S) * w, pct))
        got = fwd(x)
        c = torch.complex(torch.randn((1, 64, 180, 180), device=dev, generator=gen),
                          torch.randn((1, 64, 180, 180), device=dev, generator=gen))
        c64 = c.to(torch.complex128)
        ref_x = (torch.einsum("bclm,mlk->bckm", c64.real, pct) @ Cs
                 - torch.einsum("bclm,mlk->bckm", c64.imag, pct) @ Ss)
        got_x = inv(c)
        torch.cuda.synchronize()
        rec[f"{nlat}x{nlon}"] = (rel_err_c(got, ref), rel_err(got_x, ref_x))
        check(max(rec[f"{nlat}x{nlon}"]) < 5e-5 and not fwd.csphase,
              f"csphase=False SHT pair at {nlat}x{nlon} vs float64: {rec[f'{nlat}x{nlon}']}")
    rec["launches"] = dict(kernels.launches)
    check(rec["launches"] == launch_counts(kernels, {"legmm": 4, "gridmm": 4})
          and kernels.launches_by_passes["legmm", 3] == 4
          and kernels.launches_by_passes["gridmm", 3] == 4, f"csphase launches {rec['launches']}")
    return rec


def adam_state(torch, shapes, dev, dtype):
    from makani_tpu_torch.utils.optimizers import AdamState
    return AdamState(0, {k: torch.zeros(s, device=dev, dtype=dtype) for k, s in shapes.items()},
                     {k: torch.zeros(s, device=dev, dtype=dtype) for k, s in shapes.items()})


def fno_adam(torch, kernels, dev, gen, shapes):
    """Phase 14 (d): fused_adam over fno_linear_73ch's leaves (2.12 B
    elements): float16 moments against the twin bit for bit after 2 updates,
    with the share of nu below float16's smallest normal; then one update
    timed with float16, bf16 (stochastic rounding) and float32 moments (CUDA
    events, the card alone, the host's enqueue) beside the bound and
    torch.optim.Adam(fused=True) on float32 state."""
    from makani_tpu_torch.ops import fused_adam
    from makani_tpu_torch.tools.bench_fused_adam import device_ms
    from makani_tpu_torch.utils.optimizers import kernel_update_settings
    base = dict(optimizer_type="Adam", optimizer_beta1=0.9, optimizer_beta2=0.95, global_seed=333)
    params = {k: torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
    grads = {k: 1e-2 * torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
    n = sum(math.prod(s) for s in shapes.values())
    rec = dict(leaves=len(shapes), elements=n)
    kw = kernel_update_settings(dict(base, optimizer_moment_dtype="float16"))
    check(kw is not None and not kw["stochastic_rounding"], f"float16 settings {kw}")
    s_kernel = adam_state(torch, shapes, dev, torch.float16)
    twin_p = {k: v.clone() for k, v in params.items()}
    s_twin = adam_state(torch, shapes, dev, torch.float16)
    kernels.reset_launches()
    t_twin = 0.0
    for _ in range(2):
        fused_adam.fused_adam_apply(params, grads, s_kernel, 1e-3, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_adam.fused_adam_apply_plain(twin_p, grads, s_twin, 1e-3, **kw)
        torch.cuda.synchronize()
        t_twin = (time.perf_counter() - t0) * 1e3
    launches = kernels.launches["fused_adam"]
    check(launches == 2, f"float16: {launches} fused_adam launches over 2 updates")
    differ = [k for k in shapes if not (
        torch.equal(params[k], twin_p[k]) and torch.equal(s_kernel.mu[k], s_twin.mu[k])
        and torch.equal(s_kernel.nu[k], s_twin.nu[k]))]
    check(not differ, f"float16: kernel and twin differ in {differ[:5]}")
    tiny = torch.finfo(torch.float16).tiny
    nu = s_kernel.nu[next(k for k, s in shapes.items() if len(s) == 5)]
    rec["nu_subnormal_share"] = float(((nu > 0) & (nu < tiny)).float().mean())
    rec["float16_launches"] = launches // 2
    del twin_p, s_twin, s_kernel
    torch.cuda.empty_cache()
    for name, dtype, md in (("float16", torch.float16, "float16"),
                            ("bf16_sr", torch.bfloat16, "bfloat16"),
                            ("float32", torch.float32, "float32")):
        kw = kernel_update_settings(dict(base, optimizer_moment_dtype=md))
        state = adam_state(torch, shapes, dev, dtype)

        def update():
            fused_adam.fused_adam_apply(params, grads, state, 1e-3, **kw)
        ms = cuda_ms(update, 5)
        nbytes = n * (4 + 4 + 4 + 4 * dtype.itemsize)
        b_ms, b_by = bound(nbytes, 0)
        rec[name] = dict(ms=ms, device_ms=device_ms(update, 5),
                         enqueue_ms=host_enqueue_ms(torch, update, 3), bound_ms=b_ms,
                         bound_by=b_by, gbytes=nbytes / 1e9)
        if name == "float16":
            rec[name]["plain_ms"] = t_twin
        del state
        torch.cuda.empty_cache()
    leaves = list(params.values())
    for p, g in zip(leaves, grads.values()):
        p.grad = g
    opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.95), eps=1e-8, fused=True)
    rec["library_ms"], rec["library_device_ms"] = cuda_ms(opt.step, 5), device_ms(opt.step, 5)
    del opt, leaves, params, grads
    torch.cuda.empty_cache()
    return rec


def card_vs_cpu_optimizers(torch, dev, gen, shapes):
    """Phase 14 (d): Adafactor and SGD with momentum, 2 updates of
    build_optimizer's chain over sfno_dhealy_73ch's leaves (block 0's, the
    encoder's, the decoder's and the residual's) on the card,
    against the same chain on the CPU on the same gradients: SGD bit for
    bit, Adafactor within OPT_TOL of each leaf's largest update (its
    reductions sum in another order)."""
    from makani_tpu_torch.utils.optimizers import apply_updates, build_optimizer
    shapes = {k: s for k, s in shapes.items() if "blocks." not in k or "blocks.0." in k}
    rec = {}
    for name, cfg in (("adafactor", dict(optimizer_type="Adafactor")),
                      ("sgd", dict(optimizer_type="SGD", momentum=0.9))):
        opt = build_optimizer(cfg)
        params = {k: torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
        host = {k: v.cpu() for k, v in params.items()}
        state, host_state = opt.init(params), opt.init(host)
        worst, t_card = 0.0, 0.0
        for _ in range(2):
            grads = {k: 1e-2 * torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            updates, state = opt.update(grads, state, params)
            apply_updates(params, updates, 1e-3)
            torch.cuda.synchronize()
            t_card = (time.perf_counter() - t0) * 1e3
            host_updates, host_state = opt.update({k: g.cpu() for k, g in grads.items()},
                                                  host_state, host)
            apply_updates(host, host_updates, 1e-3)
            for k, u in updates.items():
                want = host_updates[k]
                if name == "sgd":
                    check(torch.equal(u.cpu(), want) and torch.equal(params[k].cpu(), host[k]),
                          f"sgd: card and CPU differ in {k}")
                else:
                    worst = max(worst, float((u.cpu() - want).abs().max() / want.abs().max()))
        check(worst < OPT_TOL, f"{name}: card vs CPU {worst}")
        rec[name] = dict(rel_err=worst, ms=t_card, leaves=len(shapes))
        del opt, params, host, state, host_state, updates, host_updates, grads
        torch.cuda.empty_cache()
    return rec


def phase_fno(torch, np, sht, complex_ops, kernels, dev, gen):
    """Phase 14: the planar FNO recipes and the SFNO model options at full
    width, on phase 10's dataset."""
    ICML_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    rec = {}
    settings = (sht.get_coeff_engine(), sht.get_transform_precision(),
                complex_ops.get_contraction_precision(), complex_ops._USE_PALLAS_DHCONV)
    try:
        # (a), (b) the FNO recipes through train.main, then their rollouts
        rec["linear"], fno_shapes = fno_run(torch, np, kernels, dev, gen, FNO_LINEAR)
        rec["nonlinear"], _ = fno_run(torch, np, kernels, dev, gen, FNO_NONLINEAR)

        # (c) the options at sfno_dhealy_73ch's width: scan_layers, a train
        # step with the 6 middle blocks recomputed
        level = ICML_LEVELS[ICML_PRETRAIN]
        trainer, run = icml_run(torch, kernels, ICML_PRETRAIN, level, "--save_checkpoint",
                                "none", "--run_num", "scan", scan_layers=True)
        net = trainer.model.model
        stacked = net.scan_blocks.block.filter_layer.filter.weight
        check(net.scan and net.scan_blocks.length == 6
              and tuple(stacked.shape) == (6, 2, 180, 384, 384) and run["leaves"] == 37,
              f"scan_layers: {run['leaves']} leaves, stacked filter {tuple(stacked.shape)}")
        want = icml_launches(level, 1)
        for k, extra in (("legmm", 12), ("gridmm", 12), ("dhconv_mm", 6), ("gelu_bf16", 12)):
            want[k] += extra
        check(run["launches"] == launch_counts(kernels, {
            k: v * ICML_STEPS[ICML_PRETRAIN] for k, v in want.items()}) and run["one_pass"],
              f"scan_layers launches {run['launches']}, a step {want}")
        run["step_ms"], run["step_ms_all"], run["step_peak_bytes"] = resident_step_ms(torch,
                                                                                     trainer)
        run["launches_per_step"] = want
        rec["scan"] = run
        del trainer, net, stacked
        torch.cuda.empty_cache()

        # float32 forwards at 3 passes: position embeddings and the layer norm
        sht.set_transform_precision("high")
        complex_ops.set_contraction_precision("high")
        x = torch.randn((1, FILES_CHANNELS, 721, 1440), device=dev, generator=gen)
        rec["pos_direct"], _ = option_forward(torch, sht, kernels, dev, gen, x,
                                              pos_embed="direct")
        # the frequency embedding is synthesised by the output transform
        rec["pos_frequency"], _ = option_forward(torch, sht, kernels, dev, gen, x,
                                                 extra_legmm=1, pos_embed="frequency")
        rec["layer_norm"], sfno_shapes = option_forward(torch, sht, kernels, dev, gen, x,
                                                        normalization_layer="layer_norm")
        rec["csphase"] = csphase_pair(torch, np, sht, kernels, dev, gen)

        # the CP-factorized dhconv filter on the "xla" engine with its kernel
        sht.set_coeff_engine("xla")
        sht.set_transform_precision("default")
        complex_ops.set_contraction_precision("default")
        rec["factorized"] = factorized_step(torch, sht, complex_ops, kernels, dev, gen, x)
        sht.set_coeff_engine("kernel")
        complex_ops.enable_pallas_kernels(False)
        del x
        torch.cuda.empty_cache()

        # (d) the optimizers: float16 moments at the FNO's 2.12 B elements,
        # a Trainer with float16 moments, Adafactor and SGD card vs CPU
        rec["adam"] = fno_adam(torch, kernels, dev, gen, fno_shapes)
        trainer, run = icml_run(torch, kernels, ICML_PRETRAIN, level, "--save_checkpoint",
                                "none", "--run_num", "f16", optimizer_moment_dtype="float16")
        state = trainer.adam_state()
        check(trainer.fused_kw is not None and not trainer.fused_kw["stochastic_rounding"]
              and all(v.dtype == torch.float16 for v in (*state.mu.values(), *state.nu.values()))
              and state.count == ICML_STEPS[ICML_PRETRAIN],
              f"float16 Trainer: settings {trainer.fused_kw}, count {state.count}")
        want = icml_launches(level, 1)
        check(run["launches"] == launch_counts(kernels, {
            k: v * ICML_STEPS[ICML_PRETRAIN] for k, v in want.items()}) and run["one_pass"],
              f"float16 Trainer launches {run['launches']}")
        rec["f16_trainer"] = run
        del trainer, state
        torch.cuda.empty_cache()
        rec["card_vs_cpu"] = card_vs_cpu_optimizers(torch, dev, gen, sfno_shapes)
        rec["phase_s"] = time.perf_counter() - t0
    finally:
        sht.set_coeff_engine(settings[0])
        sht.set_transform_precision(settings[1])
        complex_ops.set_contraction_precision(settings[2])
        complex_ops.enable_pallas_kernels(settings[3])
        shutil.rmtree(ICML_DIR, ignore_errors=True)
    return rec


def print_fno(fno):
    """Phase 14's lines."""
    for cut in FNO_CUTS:
        print(f"[fno cut] {cut}")
    for tag, name in (("linear", FNO_LINEAR), ("nonlinear", FNO_NONLINEAR)):
        r = fno[tag]
        print(f"[fno {tag}] {name}: {r['params']} parameters in {r['leaves']} leaves, bf16 AMP, "
              f"checkpointing {r['level']}; losses {r['losses']}; run {r['run_s']:.1f} s, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; a train step on a resident batch "
              f"{r['step_ms']:.1f} ms (median of {', '.join(f'{t:.1f}' for t in r['step_ms_all'])})"
              f", peak {r['step_peak_bytes'] / 2**30:.2f} GiB; launches a step "
              f"{r['launches_per_step']}; {ROLLOUT_STEPS}-step Inferencer rollout "
              f"{r['rollout_ms']:.1f} ms a step (median of "
              f"{', '.join(f'{t:.1f}' for t in r['rollout_ms_all'])}), peak "
              f"{r['rollout_peak_bytes'] / 2**30:.2f} GiB, launches {r['rollout_launches']}",
              flush=True)
    s = fno["scan"]
    print(f"[fno scan_layers] {ICML_PRETRAIN} with scan_layers: {s['params']} parameters in "
          f"{s['leaves']} leaves (the 6 middle blocks' weights stacked), checkpointing "
          f"{s['level']}; losses {s['losses']}; a train step {s['step_ms']:.1f} ms (median of "
          f"{', '.join(f'{t:.1f}' for t in s['step_ms_all'])}), peak "
          f"{s['step_peak_bytes'] / 2**30:.2f} GiB; launches a step {s['launches_per_step']} "
          f"(the middle blocks recomputed: +12 legmm, +6 dhconv_mm, +12 gelu_bf16)", flush=True)
    for tag in ("pos_direct", "pos_frequency", "layer_norm"):
        r = fno[tag]
        print(f"[fno {tag}] {ICML_PRETRAIN} float32 forward at 3 passes: {r['ms']:.1f} ms, "
              f"kernels vs twins {r['rel_err_twin']:.3g}, launches {r['launches']}", flush=True)
    f = fno["factorized"]
    print(f"[fno factorized] {ICML_PRETRAIN} with a CP dhconv filter (rank {f['rank']}), 'xla' "
          f"engine with the complex dhconv kernel, AMP: forward and backward {f['ms']:.1f} ms, "
          f"launches {f['launches']}, all at 1 pass; forward vs the complex einsum "
          f"{f['dev_einsum']:.3g} norm-wise", flush=True)
    c = fno["csphase"]
    print("[fno csphase] RealSHT / InverseRealSHT with csphase=False through legmm at 3 passes "
          "vs float64: " + "; ".join(f"{k} {v[0]:.3g} / {v[1]:.3g}" for k, v in c.items()
                                     if k != "launches") + f"; launches {c['launches']}",
          flush=True)
    a = fno["adam"]
    print(f"[fno adam] fused_adam over {FNO_LINEAR}'s {a['leaves']} leaves, {a['elements']} "
          f"elements: float16 moments bit-identical to the twin after 2 updates "
          f"({a['float16_launches']} launches an update; {100 * a['nu_subnormal_share']:.1f}% "
          f"of the filter's nu subnormal in float16); one update " + "; ".join(
              f"{name} {a[name]['ms']:.3f} ms (the card alone {a[name]['device_ms']:.3f}, host "
              f"enqueue {a[name]['enqueue_ms']:.3f}), bound {a[name]['bound_ms']:.3f} ms "
              f"({a[name]['gbytes']:.2f} GB)"
              for name in ("float16", "bf16_sr", "float32"))
          + f"; twin {a['float16']['plain_ms']:.1f} ms; torch.optim.Adam(fused=True), float32 "
          f"moments, {a['library_ms']:.3f} ms (alone {a['library_device_ms']:.3f})", flush=True)
    t = fno["f16_trainer"]
    print(f"[fno float16 trainer] {ICML_PRETRAIN} with optimizer_moment_dtype float16: losses "
          f"{t['losses']}, peak {t['peak_bytes'] / 2**30:.2f} GiB, launches {t['launches']}",
          flush=True)
    o = fno["card_vs_cpu"]
    print(f"[fno optimizers] {o['sgd']['leaves']} leaves of {ICML_PRETRAIN}, 2 updates on the "
          f"card vs the CPU: SGD with momentum bit for bit ({o['sgd']['ms']:.1f} ms); Adafactor "
          f"{o['adafactor']['rel_err']:.3g} of each leaf's largest update "
          f"({o['adafactor']['ms']:.1f} ms)", flush=True)
    print(f"[fno time] phase 14 in {fno['phase_s']:.1f} s", flush=True)


def family_run(torch, np, kernels, dev, gen, name, amp):
    """Phase 15 (a)-(d): `name` through train.main, float32 as its YAML says
    or under bf16 AMP, without validation or checkpoints: its launches (one
    fused_adam a leaf a step; under AMP, AFNO v2's GELU kernels), a train
    step on a resident batch timed with its peak memory, then a 4-step
    Inferencer rollout of the trained model timed as phase 5 times one."""
    from makani_tpu_torch.utils.inferencer import Inferencer
    yaml_file, kind, leaves = FAMILIES[name]
    steps = FAMILY_AMP_STEPS if amp else FAMILY_STEPS
    run_num = "amp" if amp else "f32"
    argv = ["--yaml_config", str(run_yaml(yaml_file, name, FAMILY_DIR, steps)), "--config", name,
            "--skip_validation", "--save_checkpoint", "none", "--run_num", run_num]
    if amp:
        argv += ["--amp_mode", "bf16"]
    trainer, run = main_run(torch, kernels, name, argv, steps)
    p, net = trainer.params, trainer.model.model
    check(type(net).__name__ == kind and run["leaves"] == leaves
          and (p.img_crop_shape_x, p.img_crop_shape_y) == FAMILY_SHAPE
          and net.grid == (90, 180) and p.embed_dim == 768
          and len(net.blocks) == 12 and trainer.fused_kw is not None
          and trainer.amp_dtype == (torch.bfloat16 if amp else None),
          f"{name}: {type(net).__name__}, {run['leaves']} leaves, crop "
          f"{(p.img_crop_shape_x, p.img_crop_shape_y)}, amp {trainer.amp_dtype}")
    gelu, norms = FAMILY_AMP_GELU[name] if amp else 0, FAMILY_NORMS[name]
    per_step = {"fused_adam": 1, "gelu_bf16": gelu, "gelu_bf16_grad": gelu,
                "instance_norm_fwd": norms, "instance_norm_bwd": norms}
    check(run["launches"] == launch_counts(kernels, {k: v * steps for k, v in per_step.items()}),
          f"{name} launches {run['launches']}, a step {per_step}")
    run.update(amp=amp, steps=steps, launches_per_step=per_step)
    run["step_ms"], run["step_ms_all"], run["step_peak_bytes"] = resident_step_ms(torch, trainer)
    weights = trainer.model.state_dict()
    del trainer, net
    torch.cuda.empty_cache()
    p["valid_autoreg_steps"] = ROLLOUT_STEPS - 1
    inferencer = Inferencer(p, weights=weights, device=dev)
    del weights
    check(inferencer.amp_dtype == (torch.bfloat16 if amp else None),
          f"{name}: Inferencer amp {inferencer.amp_dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x = torch.randn((1, FILES_CHANNELS, *FAMILY_SHAPE), device=dev, generator=gen)
    launches, times = timed_rollouts(torch, np, kernels, inferencer, x, f"{name} rollout")
    check(launches == launch_counts(kernels, {"gelu_bf16": gelu * ROLLOUT_STEPS,
                                              "instance_norm_fwd": norms * ROLLOUT_STEPS})
          and not kernels.eager_calls,
          f"{name} rollout launches {launches}, eager norms {dict(kernels.eager_calls)}")
    run.update(rollout_ms=statistics.median(times), rollout_ms_all=times,
               rollout_peak_bytes=torch.cuda.max_memory_allocated(), rollout_launches=launches)
    del inferencer, x
    torch.cuda.empty_cache()
    return run


def precipnet_card_vs_cpu(torch, dev):
    """A PrecipNet over an AFNO v1 of afno_backbone's widths (PRECIP_SHAPE,
    PRECIP_LAYERS): forward and every gradient on the card against the same
    weights and input on the CPU (SMALL_TOL)."""
    import copy
    from makani_tpu_torch.models.networks.afnonet import (
        AdaptiveFourierNeuralOperatorNetV1,
        PrecipNet,
    )
    cpu_gen = torch.Generator().manual_seed(15)
    backbone = AdaptiveFourierNeuralOperatorNetV1(
        inp_shape=PRECIP_SHAPE, patch_size=(8, 8), inp_chans=FILES_CHANNELS,
        out_chans=FILES_CHANNELS, embed_dim=768, num_layers=PRECIP_LAYERS, num_blocks=8,
        generator=cpu_gen)
    host = PrecipNet(backbone, out_chans=1, generator=cpu_gen)
    card = copy.deepcopy(host).to(dev)
    x = torch.randn((1, FILES_CHANNELS, *PRECIP_SHAPE), generator=cpu_gen)
    r = torch.randn((1, 1, *PRECIP_SHAPE), generator=cpu_gen)
    outs = []
    for model, device in ((host, "cpu"), (card, dev)):
        y = model(x.to(device))
        (y * r.to(device)).sum().backward()
        outs.append(y.detach().cpu())
    err = rel_err(outs[1], outs[0].double())
    grads = {k: p.grad for k, p in card.named_parameters()}
    worst = max(rel_err(grads[k].cpu(), p.grad.double()) for k, p in host.named_parameters())
    check(err < SMALL_TOL and worst < SMALL_TOL and bool((outs[0] == 0).any()),
          f"PrecipNet card vs CPU: output {err}, gradients {worst}")
    return dict(rel_err=err, grad_rel_err=worst, leaves=len(grads))


def vit_attention(torch, dev, gen):
    """One ViT layer's attention at full width, q, k, v (1, 12, 16200, 64)
    float32: the port's blockwise recurrence (16 key blocks of 1024, 184 keys
    padded) against the materialised softmax in float64 on ATTN_ROWS query
    rows, both timed with CUDA events beside one F.scaled_dot_product_attention
    call at the same shape (a comparison only, never on the path); the bound
    is the work's 4 N^2 D H float32 operations at the card's float32 rate."""
    from makani_tpu_torch.models.common.attention import scaled_dot_product_attention
    n, heads, d = 90 * 180, 12, 64
    q, k, v = (torch.randn((1, heads, n, d), device=dev, generator=gen) for _ in range(3))
    y = scaled_dot_product_attention(q, k, v)
    rows = torch.randperm(n, device=dev, generator=gen)[:ATTN_ROWS]
    qr, k64, v64 = q[:, :, rows].double(), k.double(), v.double()
    ref = torch.softmax(qr @ k64.transpose(-1, -2) * d ** -0.5, dim=-1) @ v64
    err = rel_err(y[:, :, rows], ref)
    check(err < SMALL_TOL, f"attention at (1, 12, 16200, 64) vs float64: {err}")
    del qr, k64, v64, ref, y
    torch.cuda.empty_cache()

    def fwd_bwd():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        scaled_dot_product_attention(*leaves).sum().backward()
    ms = cuda_ms(lambda: scaled_dot_product_attention(q, k, v), 3)
    train_ms = cuda_ms(fwd_bwd, 3)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 3)
    flops = 4 * n * n * d * heads
    bound_ms, bound_by = bound(4 * q.numel() * 4, flops, F32_FLOPS)
    del q, k, v
    torch.cuda.empty_cache()
    return dict(rel_err_f64=err, ms=ms, fwd_bwd_ms=train_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, tflop=flops / 1e12)


def phase_families(torch, np, kernels, dev, gen):
    """Phase 15: AFNO v2, AFNO v1 and the ViT at full width on phase 10's
    dataset, float32 and bf16 AMP; PrecipNet; the ViT's attention."""
    FAMILY_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    rec = {}
    try:
        for name in FAMILIES:
            rec[name] = family_run(torch, np, kernels, dev, gen, name, amp=False)
            rec[name + "_amp"] = family_run(torch, np, kernels, dev, gen, name, amp=True)
        rec["precipnet"] = precipnet_card_vs_cpu(torch, dev)
        rec["attention"] = vit_attention(torch, dev, gen)
        rec["phase_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(FAMILY_DIR, ignore_errors=True)
    return rec


def print_families(fam, card):
    """Phase 15's lines, each with the card's name and power limit."""
    for cut in AFNO_CUTS:
        print(f"[afno cut] {cut}")
    for name in FAMILIES:
        for key in (name, name + "_amp"):
            r = fam[key]
            tag = "vit" if name == VIT else "afno"
            print(f"[{tag} {key}] {card}: {name}, {r['params']} parameters in {r['leaves']} "
                  f"leaves, {'bf16 AMP' if r['amp'] else 'float32'}, 73 channels at "
                  f"{FAMILY_SHAPE[0]}x{FAMILY_SHAPE[1]}; losses {r['losses']}; run "
                  f"{r['run_s']:.1f} s, peak {r['peak_bytes'] / 2**30:.2f} GiB; a train step on a "
                  f"resident batch {r['step_ms']:.1f} ms (median of "
                  f"{', '.join(f'{t:.1f}' for t in r['step_ms_all'])}), peak "
                  f"{r['step_peak_bytes'] / 2**30:.2f} GiB; launches a step "
                  f"{r['launches_per_step']}; {ROLLOUT_STEPS}-step Inferencer rollout "
                  f"{r['rollout_ms']:.1f} ms a step (median of "
                  f"{', '.join(f'{t:.1f}' for t in r['rollout_ms_all'])}), peak "
                  f"{r['rollout_peak_bytes'] / 2**30:.2f} GiB, launches "
                  f"{ {k: v for k, v in r['rollout_launches'].items() if v} }", flush=True)
    pn = fam["precipnet"]
    print(f"[afno precipnet] {card}: PrecipNet over AFNO v1 ({PRECIP_LAYERS} layers of "
          f"afno_backbone's widths at {PRECIP_SHAPE[0]}x{PRECIP_SHAPE[1]}), card vs CPU: output "
          f"{pn['rel_err']:.3g}, gradients of its {pn['leaves']} leaves {pn['grad_rel_err']:.3g}",
          flush=True)
    a = fam["attention"]
    print(f"[vit attention] {card}: one layer's attention at (1, 12, 16200, 64) float32, "
          f"blockwise (16 blocks of 1024): vs float64 on {ATTN_ROWS} rows {a['rel_err_f64']:.3g}; "
          f"forward {a['ms']:.2f} ms, forward and backward {a['fwd_bwd_ms']:.2f} ms; "
          f"F.scaled_dot_product_attention (a comparison, not on the path) {a['library_ms']:.2f} "
          f"ms; bound {a['bound_ms']:.2f} ms ({a['bound_by']}, {a['tflop']:.3f} TFLOP at the "
          f"float32 rate)", flush=True)
    print(f"[afno time] {card}: phase 15 in {fam['phase_s']:.1f} s", flush=True)


def host_packages_missing():
    """The rendering's host packages (matplotlib, PIL) that do not import."""
    import importlib
    missing = []
    for name in ("matplotlib", "PIL"):
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    return missing


def avi_header(path):
    """(frames, width, height) from an AVI's main header (avih)."""
    import struct
    with open(path, "rb") as f:
        head = f.read(88)
    check(head[:4] == b"RIFF" and head[8:12] == b"AVI " and head[24:28] == b"avih",
          f"{path} is not an AVI: {head[:32]!r}")
    fields = struct.unpack("<14I", head[32:88])
    return fields[4], fields[8], fields[9]


def png_size(path):
    """(width, height) from a PNG's IHDR."""
    import struct
    with open(path, "rb") as f:
        head = f.read(24)
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def phase_videos(torch, np, kernels, dev):
    """Phase 16: sfno_dhealy_73ch through train.main under bf16 AMP with
    validation and log_video 10 as its YAML sets it: epoch 0 renders the
    first evaluation batch's comparison image and channel-0 rollout video.
    Where matplotlib or PIL is missing on the host, the renderer is replaced
    by one that records what it is given (the Trainer's check of the host
    packages passed over): the card runs the same work."""
    import contextlib
    from unittest import mock
    from makani_tpu_torch.utils import metric, visualize
    from makani_tpu_torch.utils import trainer as trainer_module
    VIDEO_DIR.mkdir(parents=True, exist_ok=True)
    steps = FILES_AUTOREG + 1
    rec = {"missing": host_packages_missing()}
    seen = {"add": [], "add_video": []}

    def recording(name, method):
        def record(self, tag, *arrays, **kwargs):
            seen[name].append((tag, *(np.array(a) for a in arrays)))
            return None if method is None else method(self, tag, *arrays, **kwargs)
        return record

    # the prediction and target of channel 0 that the first batch's AR steps
    # score (the steps that capture the frames)
    scored = []
    update = metric.MetricsHandler.update

    def scoring(self, buffers, pred, targ, loss, idt):
        if len(scored) < steps:
            scored.append((pred[0, 0].cpu().numpy(), targ[0, 0].cpu().numpy()))
        return update(self, buffers, pred, targ, loss, idt)

    patches = [mock.patch.object(metric.MetricsHandler, "update", scoring)]
    if rec["missing"]:
        class FrameRecorder:
            """VisualizationWrapper's surface: records, renders nothing."""
            add = recording("add", None)
            add_video = recording("add_video", None)

            def __init__(self, *args, **kwargs):
                pass

            def finalize(self):
                return []

            def close(self):
                pass
        patches += [mock.patch.object(visualize, "VisualizationWrapper", FrameRecorder),
                    mock.patch.object(trainer_module, "import_optional", lambda *a, **k: None)]
    else:
        wrapper = visualize.VisualizationWrapper
        patches += [mock.patch.object(wrapper, n, recording(n, getattr(wrapper, n)))
                    for n in ("add", "add_video")]
    train_steps = ICML_STEPS[ICML_PRETRAIN]
    argv = ["--yaml_config", str(run_yaml("icml_models.yaml", ICML_PRETRAIN, VIDEO_DIR,
                                          train_steps)),
            "--config", ICML_PRETRAIN, "--amp_mode", "bf16", "--checkpointing_level",
            str(ICML_LEVELS[ICML_PRETRAIN]), "--save_checkpoint", "none", "--run_num", "videos"]
    try:
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            trainer, run = main_run(torch, kernels, ICML_PRETRAIN, argv, train_steps)
        p = trainer.params
        check(p.log_video == 10 and not p.skip_validation and trainer.amp_dtype == torch.bfloat16,
              f"phase 16: log_video {p.log_video}, skip_validation {p.skip_validation}")
        # the train steps', then the validation's: the first batch's
        # one-step comparison and every AR step
        want = {k: v * train_steps
                for k, v in icml_launches(ICML_LEVELS[ICML_PRETRAIN], 1).items()}
        forwards = FILES_EVAL * steps + 1
        for k, v in VALID_STEP_LAUNCHES.items():
            want[k] = want.get(k, 0) + v * forwards
        check(run["launches"] == launch_counts(kernels, want) and run["one_pass"],
              f"phase 16 launches {run['launches']}, want {want}")
        timing = trainer.epoch_logs[-1]["timing"]
        rec.update(run, train_s=timing["training time [s]"],
                   valid_s=timing["validation time [s]"],
                   viz_s=timing["visualization time [s]"], epoch_s=timing["epoch time [s]"],
                   forwards=forwards, valid_ar_steps=FILES_EVAL * steps)

        # the frames: each the prediction and target its AR step scored
        (tag, pred, targ), = seen["add_video"]
        check(tag == "epoch0_rollout_ch0" and pred.shape == targ.shape == (steps, *FILES_SHAPE)
              and len(scored) == steps, f"video {tag}: {pred.shape}, {len(scored)} scored")
        equal = [bool(np.array_equal(pred[t], scored[t][0]) and np.array_equal(targ[t],
                                                                               scored[t][1]))
                 for t in range(steps)]
        check(all(equal) and np.isfinite(pred).all(),
              f"frames vs the scored prediction and target: {equal}")
        (tag, pimg, timg), = seen["add"]
        check(tag == "epoch0_step1" and pimg.shape == timg.shape == (2, *FILES_SHAPE)
              and np.isfinite(pimg).all(), f"comparison {tag}: {pimg.shape}")
        rec.update(frames=steps, frame_shape=list(pred.shape[1:]))

        # the validation logs do not depend on log_video: epoch 1 does not render
        _, viz_s, plain = trainer.validate_one_epoch(1)
        check(plain == trainer.epoch_logs[-1]["valid"],
              "validation logs with log_video differ from those without it")
        rec["plain_valid_viz_s"] = viz_s

        # the files
        if not rec["missing"]:
            out = Path(p.experiment_dir) / "visualizations"
            names = sorted(f.name for f in out.iterdir())
            check(names == ["epoch0_rollout_ch0.avi", "epoch0_step1.png"], f"{out}: {names}")
            rec["avi"] = avi_header(out / "epoch0_rollout_ch0.avi")
            check(rec["avi"] == (steps, 2 * FILES_SHAPE[1] + VIDEO_SEPARATOR, FILES_SHAPE[0]),
                  f"AVI frames, width, height {rec['avi']}")
            rec["png"] = png_size(out / "epoch0_step1.png")
            rec["avi_bytes"] = (out / "epoch0_rollout_ch0.avi").stat().st_size
            rec["png_bytes"] = (out / "epoch0_step1.png").stat().st_size
        del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(VIDEO_DIR, ignore_errors=True)
    return rec


def print_videos(vid, card):
    """Phase 16's lines, each with the card's name and power limit."""
    for cut in VIDEO_CUTS:
        print(f"[videos cut] {cut}")
    if vid["missing"]:
        print(f"[videos cut] {card}: {', '.join(vid['missing'])} missing on this host: the "
              "comparison image and the video are not rendered; the Trainer's renderer records "
              "what it is given instead, and the card runs the same work", flush=True)
    print(f"[videos run] {card}: {ICML_PRETRAIN}, bf16 AMP, log_video 10, {vid['params']} "
          f"parameters; losses {vid['losses']}; epoch 0 in {vid['epoch_s']:.2f} s: train "
          f"{vid['train_s']:.2f} s, validation {vid['valid_s']:.2f} s ({vid['valid_ar_steps']} AR "
          f"steps and the comparison's forward), of which visualization {vid['viz_s']:.2f} s "
          f"(a validation without rendering waits {vid['plain_valid_viz_s']:.6f} s); run "
          f"{vid['run_s']:.1f} s, peak {vid['peak_bytes'] / 2**30:.2f} GiB; launches "
          f"{ {k: v for k, v in vid['launches'].items() if v} }, all at 1 pass", flush=True)
    files = ("not rendered" if vid["missing"] else
             f"epoch0_rollout_ch0.avi {vid['avi_bytes'] / 1e6:.2f} MB, {vid['avi'][0]} frames of "
             f"{vid['avi'][1]}x{vid['avi'][2]}; epoch0_step1.png {vid['png_bytes'] / 1e6:.2f} MB, "
             f"{vid['png'][0]}x{vid['png'][1]}")
    print(f"[videos frames] {card}: {vid['frames']} frames of {vid['frame_shape'][0]}x"
          f"{vid['frame_shape'][1]}, each the prediction and target its AR step scored, bit for "
          f"bit; validation logs with log_video equal those without, bit for bit; files: {files}",
          flush=True)


# --------------------------------------------------------------------------
# phase 17: the ranks
# --------------------------------------------------------------------------

def parallel_rank(rank, world, port, sizes, job, args, queue):
    """One rank of phase 17, spawned: joins the process group, runs `job`
    and puts (rank, ok, result or traceback) on `queue`. It loads the
    kernels the parent built and compiles nothing."""
    import traceback
    # four ranks of (b) fill most of the card: segments that grow in place
    # keep a rank's reserved memory near its peak allocation
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port), PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    comm = None
    try:
        import torch
        from makani_tpu_torch.ops import kernels
        from makani_tpu_torch.parallel import comm
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        kernels.load_built()
        comm.init(sizes, device_type="cuda")
        job_fn = {"serve": parallel_serve_all, "train": parallel_train_pair, "tp_serve": tp_serve,
                  "tp_train": tp_train, "spatial": sp_rank}[job]
        queue.put((rank, True, job_fn(torch, *args)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if comm is not None:
            comm.reset()


def run_ranks(job, sizes, world, *args):
    """Spawns `world` ranks of `job` (spawn: this process holds a CUDA
    context) and returns their results in rank order; a rank that fails
    fails the phase."""
    import multiprocessing as mp
    import socket
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=parallel_rank, args=(r, world, port, sizes, job, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, ok, value = queue.get(timeout=PARALLEL_TIMEOUT)
            check(ok, f"phase 17/18 {job} rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def parallel_input(torch, dev, shape):
    return torch.randn(shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(PARALLEL_SEED + 1))


def parallel_serve(torch, serial_dir, scales, steps=PARALLEL_SERVE_STEPS, layers=None,
                   nettype=None):
    """(a) on a rank: the flagship from PARALLEL_SEED (at `layers` blocks
    where given; held in the class `nettype` names where given, (e)), the
    rank's patch of the seeded input, `steps` rollout steps held against the
    serial steps saved at `serial_dir`."""
    import numpy as np
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.ops import kernels
    from makani_tpu_torch.parallel import comm, spmd
    dev = comm.get_device()
    params = flagship_params(1)
    if layers is not None:
        params["num_layers"] = layers
    if nettype is not None:
        params["nettype"] = nettype
    model = get_model(params, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(PARALLEL_SEED))
    model.eval()
    H, W = params.img_crop_shape_x, params.img_crop_shape_y
    (h0, hn), (w0, wn) = spmd.patch(H, "h"), spmd.patch(W, "w")
    x = parallel_input(torch, dev, (1, params.N_in_channels, H, W))
    x = x[..., h0:h0 + hn, w0:w0 + wn].contiguous()
    errs, diffs, times = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    spmd.moved.clear()
    with torch.inference_mode():
        for step in range(steps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            x = model(x)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            want = np.load(serial_dir / f"step{step}.npy", mmap_mode="r")
            got = x.cpu().numpy()
            check(bool(np.isfinite(got).all()), f"(a) step {step} not finite")
            diffs.append(float(np.abs(got - want[..., h0:h0 + hn, w0:w0 + wn]).max()))
            errs.append(diffs[-1] / scales[step])
    return dict(errs=errs, step_ms=times, launches=dict(kernels.launches),
                moved=dict(spmd.moved), peak_bytes=torch.cuda.max_memory_allocated(dev),
                patch=(hn, wn), backend=comm.get_backend(), device=str(dev),
                max_abs_errs=diffs)


def file_class_params(nettype):
    """(f)'s configuration: the flagship at PARALLEL_TRAIN_LAYERS blocks,
    checkpointing FILE_CLASS_LEVEL, held in the class `nettype` names."""
    params = flagship_params(1)
    params.update_params(dict(nettype=nettype, num_layers=PARALLEL_TRAIN_LAYERS,
                              checkpointing=FILE_CLASS_LEVEL))
    return params


def file_class_grad(torch, nettype, ref_path):
    """(f) on a rank: the gradients of mean(y**2) over the whole output of
    the file class from PARALLEL_SEED on the rank's patch of the seeded
    input, reduced as the Trainer reduces them, against the serial ones
    saved at `ref_path` ("serial", at the run's precision, and "float32", at
    "highest"), and the control's (the rank's partial gradients)."""
    import numpy as np
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.ops import kernels
    from makani_tpu_torch.parallel import comm, partitioning, spmd
    dev = comm.get_device()
    params = file_class_params(nettype)
    model = get_model(params, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(PARALLEL_SEED))
    H, W = params.img_crop_shape_x, params.img_crop_shape_y
    (h0, hn), (w0, wn) = spmd.patch(H, "h"), spmd.patch(W, "w")
    x = parallel_input(torch, dev, (1, params.N_in_channels, H, W))
    x = x[..., h0:h0 + hn, w0:w0 + wn].contiguous()
    # the recomputation (torch.utils.checkpoint) imports torch._dynamo at its
    # first use, seconds of host time: paid before the timed step
    import torch._dynamo  # noqa: F401
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    spmd.moved.clear()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    y = model(x)
    whole = float(y.shape[0] * y.shape[1] * H * W)
    loss = spmd.all_reduce_sum(y.square().sum(), "spatial") / whole
    torch.cuda.synchronize(dev)
    forward_ms = (time.perf_counter() - t0) * 1e3
    # the four ranks share one card, where four whole-field backward passes
    # at once do not fit (each peaks near the serial reference's peak,
    # printed beside; over 20 GiB on an H100 80GB HBM3): the ranks take
    # their backward in turn (it holds no collective), so one recomputes at
    # a time, and each hands its cached memory back before and after its
    # turn
    torch.cuda.empty_cache()
    for turn in range(comm.get_world_size()):
        if turn == comm.get_world_rank():
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize(dev)
            backward_ms = (time.perf_counter() - t1) * 1e3
            torch.cuda.empty_cache()
        comm.barrier()
    grads = {k: p.grad for k, p in model.named_parameters()}
    partial = {k: g.detach().clone() for k, g in grads.items()}    # the control
    partitioning.reduce_gradients(grads, model.shards)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    launches, moved = dict(kernels.launches), dict(spmd.moved)
    peak = torch.cuda.max_memory_allocated(dev)
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"(f) {k} not finite")
    ref = torch.load(ref_path, map_location=dev, weights_only=True)
    check(set(ref["serial"]) == set(grads), "(f) the leaves differ from the serial model's")
    vs_serial = leaf_errors(grads, ref["serial"])
    exact = {name: leaf_errors(g, ref["float32"])
             for name, g in (("ranks", grads), ("serial", ref["serial"]), ("control", partial))}
    bound = {k: FILE_CLASS_GRAD_FACTOR * e + TWIN_TOL for k, e in exact["serial"].items()}
    margin = {name: {k: e / bound[k] for k, e in errs.items()} for name, errs in exact.items()}
    worst = max(margin["ranks"], key=margin["ranks"].get)
    control = max(margin["control"], key=margin["control"].get)
    rs = max(vs_serial, key=vs_serial.get)
    return dict(worst_leaf=worst, worst_margin=margin["ranks"][worst],
                worst_exact=exact["ranks"][worst], worst_serial_exact=exact["serial"][worst],
                control_leaf=control, control_margin=margin["control"][control],
                vs_serial_leaf=rs, vs_serial=vs_serial[rs],
                vs_serial_median=float(np.median(list(vs_serial.values()))),
                leaves=len(grads), split=len(model.shards), loss=float(loss), step_ms=ms,
                forward_ms=forward_ms, backward_ms=backward_ms, launches=launches, moved=moved,
                peak_bytes=peak, patch=(hn, wn))


def parallel_serve_all(torch, serial_dir, scales, nettype, grad_ref):
    """(a), then (e) and (f) on the same ranks, each model freed before the
    next is built."""
    out = {"serve": parallel_serve(torch, serial_dir, scales)}
    gc.collect()
    torch.cuda.empty_cache()
    out["file_serve"] = parallel_serve(torch, serial_dir, scales, nettype=nettype)
    gc.collect()
    torch.cuda.empty_cache()
    out["file_grad"] = file_class_grad(torch, nettype, grad_ref)
    return out


def parallel_train_params(**overrides):
    params = train_params(amp_mode="bf16")
    params.update_params(dict(checkpointing=PARALLEL_LEVEL, num_layers=PARALLEL_TRAIN_LAYERS,
                              n_train_samples_per_epoch=PARALLEL_TRAIN_STEPS * PARALLEL_BATCH,
                              **overrides))
    return params


def parallel_train(torch, ref_path, serial_losses, fault=False, tensor=False, spatial=False):
    """(b) on a rank: the AMP Trainer on data 2 x h 2 (its rows and latitude
    window of each global batch), with `tensor` phase 18's (b) on h 2 x fin 2
    at depth TP_TRAIN_LAYERS, with `spatial` phase 19's (b), fno_linear_73ch
    on h 2 x w 2 at depth SP_TRAIN_LAYERS; then rank 0 holds every leaf's
    update against the serial one. `fault` plants the control's fault (and
    the losses go unchecked): phases 17's and 19's drop the spatial sum of
    the replicated leaves' gradients, phase 18's the fin sum of the spectral
    filter's contraction (each fin rank keeps its own partial product)."""
    from makani_tpu_torch.models.common.spectral_convolution import SpectralConv
    from makani_tpu_torch.ops import kernels
    from makani_tpu_torch.parallel import comm, partitioning, spmd
    from makani_tpu_torch.utils.trainer import Trainer
    dev = comm.get_device()
    if spatial:
        sizes, world = SP_SIZES
        params = sp_train_params(model_parallel_sizes=sizes, world_size=world)
    elif tensor:
        sizes, world = TP_TRAIN
        params = tp_train_params(batch_size=1, model_parallel_sizes=sizes, world_size=world)
    else:
        sizes, world = PARALLEL_TRAIN
        params = parallel_train_params(batch_size=PARALLEL_BATCH // comm.get_size("data"),
                                       model_parallel_sizes=sizes, world_size=world)
    if fault and tensor:
        SpectralConv._reduce = lambda self, o, dim: (
            o if self.in_axis is None else o.narrow(dim, *spmd.patch(o.shape[dim], self.in_axis)))
    elif fault:
        partitioning.shared_axes = lambda *args: ()
    trainer = Trainer(params, device=dev)
    rank0 = comm.get_world_rank() == 0

    def whole():
        out = {}
        for k, p in trainer.model_params.items():
            t = partitioning.gather_full(k, p.detach(), trainer.shards)
            if rank0:
                out[k] = t.cpu()
        return out

    start = whole()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    spmd.moved.clear()
    t0 = time.perf_counter()
    _, _, logs = trainer.train_one_epoch()
    epoch_s = time.perf_counter() - t0
    launches, moved = dict(kernels.launches), dict(spmd.moved)
    peak, reserved = torch.cuda.max_memory_allocated(dev), torch.cuda.max_memory_reserved(dev)
    losses = logs["step losses"]
    steps = SP_TRAIN_STEPS if spatial else TP_TRAIN_STEPS if tensor else PARALLEL_TRAIN_STEPS
    check(len(losses) == steps, f"(b) {len(losses)} steps")
    for got, want in zip(losses, serial_losses):
        # the data ranks' mean of batch-sum losses (makani_tpu's / data size)
        err = abs(got * comm.get_size("data") - want) / abs(want)
        check(fault or err < PARALLEL_LOSS_TOL, f"(b) loss {got} vs serial {want}: {err}")
    after = whole()
    param_devs, update_devs = {}, {}
    if rank0:
        ref = torch.load(ref_path, map_location="cpu", weights_only=True)
        for k, p in after.items():
            check(bool(torch.isfinite(p).all()), f"(b) {k} not finite")
            if k.endswith(ZERO_GRAD):
                continue
            du, dref = p - start[k], ref[k] - start[k]
            param_devs[k] = float((p - ref[k]).norm() / ref[k].norm())
            update_devs[k] = float((du - dref).norm() / dref.norm())
    return dict(losses=losses, epoch_s=epoch_s, launches=launches, moved=moved,
                peak_bytes=peak, reserved_bytes=reserved, param_devs=param_devs,
                update_devs=update_devs,
                shards={k: tuple(s.global_shape) for k, s in trainer.shards.items()},
                splits={k: tuple((x.dim, x.axis) for x in s.splits)
                        for k, s in trainer.shards.items()},
                leaves=len(trainer.model_params), backend=comm.get_backend(),
                data=comm.get_size("data"))


def parallel_train_pair(torch, ref_path, serial_losses, tensor=False, spatial=False):
    """(b) and then its control on the same ranks, one spawn: parallel_train
    as asked, then with the control's fault planted (the planted functions
    restored after)."""
    from makani_tpu_torch.models.common.spectral_convolution import SpectralConv
    from makani_tpu_torch.parallel import partitioning
    out = {"train": parallel_train(torch, ref_path, serial_losses, False, tensor, spatial)}
    gc.collect()
    torch.cuda.empty_cache()
    planted = partitioning.shared_axes, SpectralConv._reduce
    t0 = time.perf_counter()
    try:
        out["fault"] = parallel_train(torch, ref_path, serial_losses, True, tensor, spatial)
    finally:
        partitioning.shared_axes, SpectralConv._reduce = planted
    out["fault"]["wall_s"] = time.perf_counter() - t0
    return out


def parallel_adam_shard(torch, dev, key="model.blocks.0.filter_layer.filter.weight",
                        shape=(2, 240, 384, 384), splits=((1, "h", 120, 120),)):
    """(c) fused_adam on a rank's shard of a flagship leaf (by default the
    second h rank's of a dhconv weight, degrees 120-239 of (2, 240, 384,
    384); `splits` (dim, axis, start, length)), bf16 moments under
    stochastic rounding, 2 steps: bit for bit against its twin on the shard
    and against the same slice of the kernel's update of the whole leaf.
    The control, the kernel on the shard without `shards` (the shard's own
    indices in the dither), must differ in the moments."""
    from makani_tpu_torch.ops import fused_adam
    from makani_tpu_torch.parallel.partitioning import Shard, Split
    from makani_tpu_torch.utils.optimizers import AdamState
    shards = {key: Shard(shape, [Split(*s) for s in splits])}
    gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED + 2)
    p0 = torch.randn(shape, device=dev, generator=gen)
    grads = [0.1 * torch.randn(shape, device=dev, generator=gen) for _ in range(2)]
    cut = [slice(None)] * len(shape)
    for dim, _, start, length in splits:
        cut[dim] = slice(start, start + length)
    cut = tuple(cut)

    def run(fn, whole, **kw):
        p = {key: (p0 if whole else p0[cut]).clone(memory_format=torch.contiguous_format)}
        s = AdamState(0, {key: torch.zeros_like(p[key], dtype=torch.bfloat16)},
                      {key: torch.zeros_like(p[key], dtype=torch.bfloat16)})
        for g in grads:
            fn(p, {key: (g if whole else g[cut]).contiguous()}, s, 1e-3, seed=340, **kw)
        torch.cuda.synchronize(dev)
        return [t if not whole else t[cut] for t in (p[key], s.mu[key], s.nu[key])]

    shard = run(fused_adam.fused_adam_apply, False, shards=shards)
    twin = run(fused_adam.fused_adam_apply_plain, False, shards=shards)
    whole = run(fused_adam.fused_adam_apply, True)
    own = run(fused_adam.fused_adam_apply, False)
    out = dict(key=key, shape=shape, splits=splits,
               base=fused_adam.shard_strides(key, None, shards[key])[1],
               vs_twin=[int((a != b).sum()) for a, b in zip(shard, twin)],
               vs_whole=[int((a != b).sum()) for a, b in zip(shard, whole)],
               control=[int((a != b).sum()) for a, b in zip(own, whole)],
               n=shard[0].numel())
    del p0, grads, shard, twin, whole, own
    torch.cuda.empty_cache()
    return out


def phase_parallel(torch, np, spectral_mm, kernels, dev, gen, card, order_gap=None):
    """Phase 17 (module docstring); prints each part when it is measured.
    `order_gap` is phase 4's forward error of the kernels against their
    twins, printed beside (a)'s."""
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.ops import complex_ops, sht
    from makani_tpu_torch.parallel import comm
    from makani_tpu_torch.utils.trainer import Trainer
    rec = {"backend": comm.choose_backend("cuda", PARALLEL_SERVE[1]),
           "cards": torch.cuda.device_count()}
    print(f"[parallel] {card}: backend {rec['backend']} ({rec['cards']} card(s): "
          + ("the ranks share the card, collectives staged through host memory"
             if rec["backend"] == "gloo" else "a card a rank") + ")", flush=True)
    # (c) the kernels at the ranks' local shapes: legmm on an m-slice of 121
    # or 120 orders (M2 242, 240) over the full latitude, 192 channels a
    # rank after the polar transpose; the dhconv kernels on 120 degrees
    rec["kernels"] = []
    for mloc in (121, 120):
        rows = phase_kernels(torch, spectral_mm, dev, gen, mmax=mloc, C=192, Ldh=120,
                             reps=10, plain_reps=3)
        for r in rows:
            r["local_m"] = mloc
            print(f"[parallel kernel] {r['name']} {r['shape']} p{r['passes']}: {r['ms']:.3f} ms "
                  f"(twin {r['plain_ms']:.3f}, library {r['library_ms']:.3f}, bound "
                  f"{r['bound_ms']:.3f} by {r['bound_by']}); vs twin {r['rel_err_twin']:.3g}, "
                  f"vs f64 {r['rel_err_f64']:.3g}", flush=True)
        rec["kernels"] += rows
    a = rec["adam_shard"] = parallel_adam_shard(torch, dev)
    print(f"[parallel kernel] fused_adam on the shard {a['splits']} of "
          f"{a['shape']} (base {a['base']}), bf16 moments, stochastic rounding, 2 steps: p, mu, nu "
          f"differ from the twin in {a['vs_twin']} and from the whole leaf's slice in "
          f"{a['vs_whole']} of {a['n']} elements (bound 0, bit for bit); control, the shard's "
          f"own indices: {a['control']} differ (must not be 0 in mu and nu)", flush=True)
    check(a["vs_twin"] == [0, 0, 0] and a["vs_whole"] == [0, 0, 0],
          f"fused_adam on a shard vs twin {a['vs_twin']}, vs the whole leaf {a['vs_whole']}")
    check(a["control"][1] > 0 and a["control"][2] > 0,
          f"fused_adam's control with base 0 matches the whole leaf: {a['control']}")
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir(parents=True)
    try:
        # (a) the serial rollout of the same weights, saved step by step
        params = flagship_params(1)
        model = get_model(params, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(PARALLEL_SEED))
        model.eval()
        x = parallel_input(torch, dev, (1, params.N_in_channels, params.img_crop_shape_x,
                                        params.img_crop_shape_y))
        scales, serial_ms = [], []
        with torch.inference_mode():
            for step in range(PARALLEL_SERVE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = model(x)
                torch.cuda.synchronize()
                serial_ms.append((time.perf_counter() - t0) * 1e3)
                y = x.cpu().numpy()
                scales.append(float(np.abs(y).max()))
                np.save(PARALLEL_DIR / f"step{step}.npy", y)
        del model, x, y
        gc.collect()
        torch.cuda.empty_cache()
        # (f) the serial gradients of the file class, from the same weights
        # and input
        file_path = PARALLEL_DIR / "file_sfno.py"
        file_path.write_text(FILE_CLASS_SOURCE)
        nettype = f"{file_path}:{FILE_CLASS}"
        params = file_class_params(nettype)
        model = get_model(params, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(PARALLEL_SEED))
        check(type(model.model).__name__ == FILE_CLASS
              and not hasattr(model.model, "spatially_parallel"),
              f"(f) the file class {type(model.model).__name__}")
        import torch._dynamo  # noqa: F401  (file_class_grad says why)
        x = parallel_input(torch, dev, (1, params.N_in_channels, params.img_crop_shape_x,
                                        params.img_crop_shape_y))
        refs, serial = {}, {}
        prec = sht.get_transform_precision(), complex_ops.get_contraction_precision()
        try:
            for name, modes in (("float32", ("highest", "highest")), ("serial", prec)):
                sht.set_transform_precision(modes[0])
                complex_ops.set_contraction_precision(modes[1])
                model.zero_grad(set_to_none=True)
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(x).square().mean().backward()
                torch.cuda.synchronize()
                serial["ms" if name == "serial" else "float32_ms"] = \
                    (time.perf_counter() - t0) * 1e3
                refs[name] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        finally:
            sht.set_transform_precision(prec[0])
            complex_ops.set_contraction_precision(prec[1])
        serial["peak_bytes"] = torch.cuda.max_memory_allocated()
        grad_ref = PARALLEL_DIR / "file_class_grads.pt"
        torch.save(refs, grad_ref)
        del model, x, refs
        gc.collect()
        torch.cuda.empty_cache()
        rec["parent_reserved_bytes"] = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        out = run_ranks("serve", *PARALLEL_SERVE, PARALLEL_DIR, scales, nettype, grad_ref)
        wall_s = time.perf_counter() - t0
        ranks = [r["serve"] for r in out]
        rec["serve"] = dict(ranks=ranks, wall_s=wall_s, serial_ms=serial_ms,
                            order_gap=order_gap)
        rec["file_serve"] = dict(ranks=[r["file_serve"] for r in out])
        rec["file_grad"] = dict(ranks=[r["file_grad"] for r in out], **serial)
        print_parallel_serve(rec["serve"])
        print_file_class(rec)
        for i, r in enumerate(ranks):
            check(max(r["errs"]) < PARALLEL_SERVE_TOL,
                  f"(a) rank {i} patch vs serial, by step: {r['errs']}")
            for name in ("legmm", "dhconv_mm"):
                check(r["launches"][name] > 0, f"(a) {name} not launched on a rank")
            check(r["launches"]["gridmm"] == r["launches"]["legmm"],
                  f"(a) gridmm {r['launches']['gridmm']}, legmm {r['launches']['legmm']}")
        for i, (e, f) in enumerate(zip(rec["file_serve"]["ranks"], rec["file_grad"]["ranks"])):
            check(max(e["errs"]) < PARALLEL_SERVE_TOL,
                  f"(e) rank {i} patch vs serial, by step: {e['errs']}")
            check(launch_counts(kernels, FILE_CLASS_SERVE_LAUNCHES) == e["launches"],
                  f"(e) rank {i} launches {e['launches']}")
            check(f["worst_margin"] < 1 and f["split"] == 0,
                  f"(f) rank {i}: {f['worst_leaf']} at {f['worst_margin']} of its bound, "
                  f"{f['split']} split leaves")
            check(f["control_margin"] > 1,
                  f"(f)'s control reads {f['control_margin']} of the bound")
            check(launch_counts(kernels, FILE_CLASS_GRAD_LAUNCHES) == f["launches"],
                  f"(f) rank {i} launches {f['launches']}")
        # (b) the serial batch-2 reference, then the ranks
        trainer = Trainer(parallel_train_params(batch_size=PARALLEL_BATCH), device=dev)
        torch.cuda.reset_peak_memory_stats()
        _, _, logs = trainer.train_one_epoch()
        serial_peak = torch.cuda.max_memory_allocated()
        serial_losses = logs["step losses"]
        ref_path = PARALLEL_DIR / "serial_weights.pt"
        torch.save({k: p.detach().cpu() for k, p in trainer.model_params.items()}, ref_path)
        del trainer, logs
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[parallel serial] batch {PARALLEL_BATCH}, {PARALLEL_TRAIN_LAYERS} blocks, "
              f"checkpointing {PARALLEL_LEVEL}: "
              f"losses {serial_losses}, peak {serial_peak / 2**30:.2f} GiB; this process "
              f"keeps {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved while the "
              "ranks run", flush=True)
        t0 = time.perf_counter()
        pairs = run_ranks("train", *PARALLEL_TRAIN, ref_path, serial_losses)
        ranks = [p["train"] for p in pairs]
        devs, udevs = ranks[0]["param_devs"], ranks[0]["update_devs"]
        worst = max(udevs, key=udevs.get)
        rec["train"] = dict(ranks=ranks, wall_s=time.perf_counter() - t0,
                            serial_losses=serial_losses, serial_peak_bytes=serial_peak,
                            worst_leaf=worst, worst_update_dev=udevs[worst],
                            median_update_dev=float(np.median(list(udevs.values()))),
                            worst_dev=max(devs.values()),
                            median_dev=float(np.median(list(devs.values()))))
        print_parallel_train(rec["train"])
        check(udevs[worst] < PARALLEL_UPDATE_TOL,
              f"(b) the update of {worst} vs serial: {udevs[worst]}")
        check(rec["train"]["median_update_dev"] < PARALLEL_UPDATE_MEDIAN_TOL,
              f"(b) the median leaf's update vs serial: {rec['train']['median_update_dev']}")
        for r in ranks:
            for name in ("legmm", "dhconv_mm", "dhconv_dw"):
                check(r["launches"][name] > 0, f"(b) {name} not launched on a rank")
            check(r["launches"]["gridmm"] == r["launches"]["legmm"],
                  f"(b) gridmm {r['launches']['gridmm']}, legmm {r['launches']['legmm']}")
            check(r["launches"]["fused_adam"] == PARALLEL_TRAIN_STEPS,
                  f"(b) {r['launches']['fused_adam']} fused_adam launches on a rank over "
                  f"{PARALLEL_TRAIN_STEPS} steps")
        # the control, run by the same ranks after (b): the spatial sum of the
        # replicated leaves dropped
        fdevs = pairs[0]["fault"]["update_devs"]
        fworst = max(fdevs, key=fdevs.get)
        split = rec["train"]["ranks"][0]["shards"]
        rec["train_fault"] = dict(
            wall_s=pairs[0]["fault"]["wall_s"], worst_leaf=fworst, worst_update_dev=fdevs[fworst],
            median_update_dev=float(np.median(list(fdevs.values()))),
            split_worst=max((v for k, v in fdevs.items() if k in split), default=float("nan")))
        f = rec["train_fault"]
        print(f"[parallel train control] {f['wall_s']:.1f} s of them; the spatial sum of the "
              f"replicated leaves dropped: updates vs serial, norm-wise: worst {f['worst_update_dev']:.3g} "
              f"({fworst}), median {f['median_update_dev']:.3g}, the split leaves' worst "
              f"{f['split_worst']:.3g} (must read above the bounds {PARALLEL_UPDATE_TOL} and "
              f"{PARALLEL_UPDATE_MEDIAN_TOL})", flush=True)
        check(f["worst_update_dev"] > PARALLEL_UPDATE_TOL
              and f["median_update_dev"] > PARALLEL_UPDATE_MEDIAN_TOL,
              f"(b)'s control reads {f['worst_update_dev']} and {f['median_update_dev']}, "
              "within the bounds")
    finally:
        shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    return rec


def print_parallel_serve(serve):
    for i, r in enumerate(serve["ranks"]):
        print(f"[parallel serve rank {i}] h 2 x w 2, patch {r['patch']} on {r['device']}: "
              f"step ms {', '.join(f'{t:.1f}' for t in r['step_ms'])} (serial "
              f"{', '.join(f'{t:.1f}' for t in serve['serial_ms'])}); errors vs serial "
              f"{', '.join(f'{e:.3g}' for e in r['errs'])} (bound {PARALLEL_SERVE_TOL}); "
              f"launches legmm {r['launches']['legmm']}, gridmm {r['launches']['gridmm']}, "
              f"dhconv_mm {r['launches']['dhconv_mm']};"
              f" bytes sent {r['moved']}; peak {r['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    gap = serve["order_gap"]
    print(f"[parallel serve] {serve['wall_s']:.1f} s for the 4 ranks, start to end; the ordering "
          "gap of one serial forward (phase 4, kernels vs twins): "
          + ("not measured" if gap is None else f"{gap:.3g}"), flush=True)


def print_file_class(rec):
    for i, r in enumerate(rec["file_serve"]["ranks"]):
        print(f"[parallel file class serve rank {i}] {FILE_CLASS} from a file, no "
              f"spatially_parallel, h 2 x w 2, the whole field on the rank, patch {r['patch']}: "
              f"step ms {', '.join(f'{t:.1f}' for t in r['step_ms'])}; errors vs serial "
              f"{', '.join(f'{e:.3g}' for e in r['errs'])} (bound {PARALLEL_SERVE_TOL}; max abs "
              f"{', '.join(f'{e:.3g}' for e in r['max_abs_errs'])}); launches legmm "
              f"{r['launches']['legmm']}, gridmm {r['launches']['gridmm']}, dhconv_mm "
              f"{r['launches']['dhconv_mm']}; bytes sent {r['moved']}; peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    g = rec["file_grad"]
    for i, r in enumerate(g["ranks"]):
        print(f"[parallel file class grad rank {i}] {PARALLEL_TRAIN_LAYERS} blocks, float32, "
              f"checkpointing {FILE_CLASS_LEVEL}: {r['leaves']} leaves, {r['split']} split; "
              f"gradients vs the serial run's per leaf: worst {r['vs_serial']:.3g} "
              f"({r['vs_serial_leaf']}), median {r['vs_serial_median']:.3g}; against float32 "
              f"(\"highest\"): the worst leaf {r['worst_leaf']} {r['worst_exact']:.3g}, the serial "
              f"run's {r['worst_serial_exact']:.3g}, {r['worst_margin']:.3g} of the bound "
              f"({FILE_CLASS_GRAD_FACTOR} x the serial run's + {TWIN_TOL}; must be below 1); the "
              f"control, the partial gradients before the spatial sum, {r['control_margin']:.3g} "
              f"of it ({r['control_leaf']}; must be above 1); forward "
              f"{r['forward_ms']:.1f} ms, its backward {r['backward_ms']:.1f} ms (the ranks in "
              f"turn), the step {r['step_ms']:.1f} ms; launches "
              f"{ {k: r['launches'][k] for k in FILE_CLASS_GRAD_LAUNCHES} }; bytes sent "
              f"{r['moved']}; peak {r['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    print(f"[parallel file class] serial gradients {g['ms']:.1f} ms, peak "
          f"{g['peak_bytes'] / 2**30:.2f} GiB; at \"highest\" {g['float32_ms']:.1f} ms",
          flush=True)


def print_parallel_train(train):
    for i, r in enumerate(train["ranks"]):
        print(f"[parallel train rank {i}] data {r['data']} x h 2, bf16 AMP, "
              f"{PARALLEL_TRAIN_LAYERS} blocks, checkpointing {PARALLEL_LEVEL}: losses {r['losses']} (x{r['data']} vs serial batch "
              f"{PARALLEL_BATCH} {train['serial_losses']}, bound {PARALLEL_LOSS_TOL}); epoch "
              f"{r['epoch_s']:.2f} s ({r['epoch_s'] * 1e3 / len(r['losses']):.1f} ms a step "
              f"with the loader); launches "
              f"{ {k: r['launches'][k] for k in ('legmm', 'gridmm', 'dhconv_mm', 'dhconv_dw', 'fused_adam', 'gelu_bf16', 'gelu_bf16_grad')} }; "
              f"bytes sent {r['moved']}; peak {r['peak_bytes'] / 2**30:.2f} GiB (reserved "
              f"{r['reserved_bytes'] / 2**30:.2f})", flush=True)
    print(f"[parallel train] {train['wall_s']:.1f} s for the 4 ranks with the control; "
          f"serial batch "
          f"{PARALLEL_BATCH} peak {train['serial_peak_bytes'] / 2**30:.2f} GiB; split leaves "
          f"{len(train['ranks'][0]['shards'])}; updates over {PARALLEL_TRAIN_STEPS} steps vs "
          f"serial, norm-wise: worst {train['worst_update_dev']:.3g} ({train['worst_leaf']}), "
          f"median {train['median_update_dev']:.3g} (bounds {PARALLEL_UPDATE_TOL}, "
          f"{PARALLEL_UPDATE_MEDIAN_TOL}); the weights: "
          f"worst {train['worst_dev']:.3g}, median {train['median_dev']:.3g}", flush=True)


# --------------------------------------------------------------------------
# phase 18: channel (tensor) parallelism
# --------------------------------------------------------------------------

def tp_train_params(**overrides):
    params = train_params(amp_mode="bf16")
    params.update_params(dict(checkpointing=TP_LEVEL, num_layers=TP_TRAIN_LAYERS,
                              n_train_samples_per_epoch=TP_TRAIN_STEPS, **overrides))
    return params


def tp_train(torch, ref_path, serial_losses):
    return parallel_train_pair(torch, ref_path, serial_losses, tensor=True)


def tp_family(torch, name, dev, generator, layers=TP_FAMILY_LAYERS):
    """(d)'s network `name` (vit_backbone's, afno_v2's or afno_backbone's
    widths, depth `layers`, 73 channels in and out; afno_backbone inside
    PrecipNet with 1 output channel), weights from `generator`."""
    from makani_tpu_torch.models.networks.afnonet import (
        AdaptiveFourierNeuralOperatorNetV1,
        PrecipNet,
    )
    from makani_tpu_torch.models.networks.afnonet_v2 import AdaptiveFourierNeuralOperatorNet
    from makani_tpu_torch.models.networks.vit import VisionTransformer
    common = dict(inp_shape=(720, 1440), patch_size=(8, 8), inp_chans=73, out_chans=73,
                  embed_dim=768, mlp_ratio=4.0, device=dev, generator=generator)
    if name == VIT:
        return VisionTransformer(depth=layers, num_heads=12, **common)
    if name == AFNO_V1:
        backbone = AdaptiveFourierNeuralOperatorNetV1(num_layers=layers, num_blocks=8, **common)
        return PrecipNet(backbone, out_chans=1, device=dev, generator=generator)
    return AdaptiveFourierNeuralOperatorNet(
        num_layers=layers, num_blocks=8, normalization_layer="instance_norm",
        skip_fno="identity", nested_skip_fno=True, sparsity_threshold=0.01,
        hard_thresholding_fraction=1.0, **common)


def tp_family_input(torch, dev):
    return parallel_input(torch, dev, (1, 73, 720, 1440))


def tp_serve(torch, serial_dir, scales, family_scales):
    """(a) and (d) on a rank of fin 2 x fout 2: the flagship's rollout
    (parallel_serve), then each family's forward held against the serial
    output saved at `serial_dir`."""
    import numpy as np
    from makani_tpu_torch.parallel import comm, partitioning, spmd
    out = parallel_serve(torch, serial_dir, scales, TP_SERVE_STEPS, TP_SERVE_LAYERS)
    dev = comm.get_device()
    out["families"] = {}
    for name in (VIT, AFNO_V2):
        gc.collect()
        torch.cuda.empty_cache()
        net = tp_family(torch, name, dev,
                        torch.Generator(device=dev).manual_seed(PARALLEL_SEED + 3))
        net.eval()
        shards = partitioning.shard_module(net)
        x = tp_family_input(torch, dev)
        spmd.moved.clear()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            y = net(x)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        got = y.cpu().numpy()
        check(bool(np.isfinite(got).all()), f"(d) {name} not finite")
        want = np.load(serial_dir / f"{name}.npy")
        out["families"][name] = dict(err=float(np.abs(got - want).max()) / family_scales[name],
                                     ms=ms, moved=dict(spmd.moved), split=len(shards))
        del net, x, y
    return out


def tp_kernel_rows(torch, spectral_mm, complex_kernels, dev, gen, reps=10, plain_reps=3):
    """(c): each kernel at a fin rank's shapes (192 of 384 input channels),
    3 passes, against float64 and its twin, timed beside its twin and its
    phase 3 library call; returns rows."""
    rows = []
    L, M, Ci, Co = 240, 241, 192, 384

    def row(name, shape, got, plain, e64, nbytes, flops, fn, plain_fn, library_fn):
        etwin = rel_err(got, plain.double())
        check(e64 < F64_TOL[3], f"{name} {shape} vs f64: {e64}")
        check(etwin < TWIN_TOL, f"{name} {shape} vs twin: {etwin}")
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(name=name, shape=shape, passes=3,
                         max_abs_err=float((got - plain).abs().max()), rel_err_twin=etwin,
                         rel_err_f64=e64, ms=cuda_ms(fn, reps),
                         plain_ms=cuda_ms(plain_fn, plain_reps),
                         library_ms=cuda_ms(library_fn, reps), bound_ms=b_ms, bound_by=b_by,
                         gbytes=nbytes / 1e9, gflop=flops / 1e9))

    for label, K, contract in (("full analysis", 721, "k"), ("full synthesis", 721, "l"),
                               ("inner analysis", 240, "k"), ("inner synthesis", 240, "l")):
        z = torch.randn((2 * M, Ci, K if contract == "k" else L), device=dev, generator=gen)
        p = torch.randn((M, L, K), device=dev, generator=gen)
        table = p.transpose(-1, -2) if contract == "k" else p
        ref = torch.matmul(z.view(2, M, Ci, -1).double(), table.double()).reshape(2 * M, Ci, -1)
        tables = torch.cat([table, table])
        got = spectral_mm.legmm(z, p, 3, contract)
        torch.cuda.synchronize()
        row("legmm", f"{label} z{tuple(z.shape)} p{tuple(p.shape)}", got,
            spectral_mm.legmm_plain(z, p, 3, contract), rel_err(got, ref),
            (z.numel() + p.numel() + got.numel()) * 4, 2 * 2 * M * Ci * L * K * 3,
            lambda: spectral_mm.legmm(z, p, 3, contract),
            lambda: spectral_mm.legmm_plain(z, p, 3, contract), lambda: torch.bmm(z, tables))
        del z, p, table, ref, tables, got
    x = torch.randn((2, 1, L, Ci, M), device=dev, generator=gen)
    w = torch.randn((2, L, Ci, Co), device=dev, generator=gen)
    dy = torch.randn((2, 1, L, Co, M), device=dev, generator=gen)
    wc = torch.complex(w[0], w[1])                       # (L, Ci, Co)

    def planes_err(got, ref):
        return max(float((got[0].double() - ref.real).abs().max()),
                   float((got[1].double() - ref.imag).abs().max())) / float(ref.abs().max())

    for label, inp, wdim, conj_w, wop in (
            ("forward", x, 0, False, wc.transpose(-1, -2)),
            ("dx", dy, 1, True, torch.conj(wc).resolve_conj())):
        ic = torch.complex(inp[0], inp[1])
        ref = torch.matmul(wop.to(torch.complex128), ic.to(torch.complex128))
        got = spectral_mm.dhconv_mm(inp, w, 3, wdim=wdim, conj_w=conj_w)
        torch.cuda.synchronize()
        row("dhconv_mm", f"{label} x{tuple(inp.shape)} w{tuple(w.shape)}", got,
            spectral_mm.dhconv_mm_plain(inp, w, 3, wdim=wdim, conj_w=conj_w),
            planes_err(got, ref), (inp.numel() + w.numel() + got.numel()) * 4,
            2 * L * Ci * Co * M * 3 * 3,
            lambda: spectral_mm.dhconv_mm(inp, w, 3, wdim=wdim, conj_w=conj_w),
            lambda: spectral_mm.dhconv_mm_plain(inp, w, 3, wdim=wdim, conj_w=conj_w),
            lambda: torch.matmul(wop, ic))
        del ic, ref, got
    xcj = torch.conj(torch.complex(x[0], x[1]))                  # (1, L, Ci, M)
    gct = torch.complex(dy[0], dy[1]).transpose(-1, -2)          # (1, L, M, Co)
    ref = torch.matmul(xcj.to(torch.complex128), gct.to(torch.complex128))[0]
    got = spectral_mm.dhconv_dw(x, dy, 3)
    torch.cuda.synchronize()
    row("dhconv_dw", f"x{tuple(x.shape)} g{tuple(dy.shape)}", got,
        spectral_mm.dhconv_dw_plain(x, dy, 3), planes_err(got, ref),
        (x.numel() + dy.numel() + got.numel()) * 4, 2 * L * Ci * Co * M * 3 * 3,
        lambda: spectral_mm.dhconv_dw(x, dy, 3), lambda: spectral_mm.dhconv_dw_plain(x, dy, 3),
        lambda: torch.matmul(xcj, gct))
    del xcj, gct, ref, got
    # the complex kernel: x (1, Ci, L, M), w (Ci, Co, L), batched over l
    xk = torch.complex(x[0, 0], x[1, 0]).permute(1, 0, 2).unsqueeze(0).contiguous()
    wk = wc.permute(1, 2, 0).contiguous()
    xl, wl = xk[0].permute(1, 2, 0), wk.permute(2, 1, 0)         # (L, M, Ci), (L, Co, Ci)
    ref = torch.matmul(wl.to(torch.complex128), xl.transpose(-1, -2).to(torch.complex128))
    got = complex_kernels.contract_dhconv_raw(xk, wk, 3)
    torch.cuda.synchronize()
    plain = complex_kernels.contract_dhconv_plain(xk, wk, 3)
    e64 = rel_err_c(got[0].permute(1, 0, 2), ref)
    etwin = rel_err_c(got, plain.to(torch.complex128))
    check(e64 < F64_TOL[3], f"dhconv_complex vs f64: {e64}")
    check(etwin < TWIN_TOL, f"dhconv_complex vs twin: {etwin}")
    nbytes = (xk.numel() + wk.numel() + got.numel()) * 8
    b_ms, b_by = bound(nbytes, 2 * L * Ci * Co * M * 4 * 3)
    rows.append(dict(name="dhconv_complex", shape=f"x{tuple(xk.shape)} w{tuple(wk.shape)}",
                     passes=3, max_abs_err=float((got - plain).abs().max()),
                     rel_err_twin=etwin, rel_err_f64=e64,
                     ms=cuda_ms(lambda: complex_kernels.contract_dhconv_raw(xk, wk, 3), reps),
                     plain_ms=cuda_ms(lambda: complex_kernels.contract_dhconv_plain(xk, wk, 3),
                                      plain_reps),
                     library_ms=cuda_ms(lambda: torch.matmul(wl, xl.transpose(-1, -2)), reps),
                     bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9,
                     gflop=2 * L * Ci * Co * M * 4 * 3 / 1e9))
    del x, w, dy, wc, xk, wk, xl, wl, ref, got, plain
    torch.cuda.empty_cache()
    return rows


# (c)'s fused_adam shards: a (fout, fin) block of the flagship MLP's fc1
# weight (768, 384), the rank at fout 1 and fin 1; a fin shard of a dhconv
# weight (2, 240, 384, 384) over its C
TP_ADAM_SHARDS = (
    ("model.blocks.0.mlp.fc1.weight", (768, 384), ((0, "fout", 384, 384), (1, "fin", 192, 192))),
    ("model.blocks.0.filter_layer.filter.weight", (2, 240, 384, 384), ((2, "fin", 192, 192),)),
)


def phase_tensor_parallel(torch, np, spectral_mm, kernels, dev, gen, card):
    """Phase 18 (module docstring); prints each part when it is measured."""
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.ops import complex_kernels, complex_ops, sht
    from makani_tpu_torch.utils.trainer import Trainer
    # the serial references at the settings a rank starts from: the "kernel"
    # engine at the serving precision "high" (an AMP Trainer of an earlier
    # phase leaves "default", 1 bf16 pass, in this process)
    sht.set_coeff_engine("kernel")
    sht.set_transform_precision("high")
    complex_ops.set_contraction_precision("high")
    rec = {"cuts": list(TP_CUTS)}
    for cut in TP_CUTS:
        print(f"[tp cut] {cut}", flush=True)
    # (c) the kernels at a fin rank's shapes
    rec["kernels"] = tp_kernel_rows(torch, spectral_mm, complex_kernels, dev, gen)
    for r in rec["kernels"]:
        print(f"[tp kernel] {r['name']} {r['shape']} p3: {r['ms']:.3f} ms (twin "
              f"{r['plain_ms']:.3f}, library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by "
              f"{r['bound_by']}); vs twin {r['rel_err_twin']:.3g}, vs f64 {r['rel_err_f64']:.3g}",
              flush=True)
    rec["adam"] = []
    for key, shape, splits in TP_ADAM_SHARDS:
        a = parallel_adam_shard(torch, dev, key, shape, splits)
        rec["adam"].append(a)
        print(f"[tp kernel] fused_adam on {key}'s block {a['splits']} of {a['shape']} (base "
              f"{a['base']}), bf16 moments, stochastic rounding, 2 steps: p, mu, nu differ from "
              f"the twin in {a['vs_twin']} and from the whole leaf's slice in {a['vs_whole']} of "
              f"{a['n']} elements (bound 0); control, base 0: {a['control']} differ (must not "
              "be 0 in mu and nu)", flush=True)
        check(a["vs_twin"] == [0, 0, 0] and a["vs_whole"] == [0, 0, 0],
              f"fused_adam on {key}'s block vs twin {a['vs_twin']}, whole {a['vs_whole']}")
        check(a["control"][1] > 0 and a["control"][2] > 0,
              f"fused_adam's control with base 0 matches the whole leaf: {a['control']}")
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    try:
        # (a) and (d): the serial outputs of the same weights, saved
        params = flagship_params(1)
        params["num_layers"] = TP_SERVE_LAYERS
        model = get_model(params, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(PARALLEL_SEED))
        model.eval()
        x = parallel_input(torch, dev, (1, params.N_in_channels, params.img_crop_shape_x,
                                        params.img_crop_shape_y))
        scales, serial_ms = [], []
        with torch.inference_mode():
            for step in range(TP_SERVE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = model(x)
                torch.cuda.synchronize()
                serial_ms.append((time.perf_counter() - t0) * 1e3)
                y = x.cpu().numpy()
                scales.append(float(np.abs(y).max()))
                np.save(TP_DIR / f"step{step}.npy", y)
        del model, x, y
        family_scales, family_ms = {}, {}
        for name in (VIT, AFNO_V2):
            gc.collect()
            torch.cuda.empty_cache()
            net = tp_family(torch, name, dev,
                            torch.Generator(device=dev).manual_seed(PARALLEL_SEED + 3))
            net.eval()
            xf = tp_family_input(torch, dev)
            with torch.inference_mode():
                net(xf)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = net(xf).cpu().numpy()
                family_ms[name] = (time.perf_counter() - t0) * 1e3
            family_scales[name] = float(np.abs(y).max())
            np.save(TP_DIR / f"{name}.npy", y)
            del net, xf, y
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_ranks("tp_serve", *TP_SERVE, TP_DIR, scales, family_scales)
        rec["serve"] = dict(ranks=ranks, wall_s=time.perf_counter() - t0, serial_ms=serial_ms,
                            family_serial_ms=family_ms)
        print_tp_serve(rec["serve"])
        for i, r in enumerate(ranks):
            check(max(r["errs"]) < PARALLEL_SERVE_TOL,
                  f"(a) rank {i} vs serial, by step: {r['errs']}")
            for name in ("legmm", "dhconv_mm"):
                check(r["launches"][name] > 0, f"(a) {name} not launched on a rank")
            check(r["launches"]["gridmm"] == r["launches"]["legmm"],
                  f"(a) gridmm {r['launches']['gridmm']}, legmm {r['launches']['legmm']}")
            for name, f in r["families"].items():
                check(f["err"] < PARALLEL_SERVE_TOL, f"(d) {name} rank {i} vs serial: {f['err']}")
        # (b) the serial reference at the same depth and level, then the ranks
        trainer = Trainer(tp_train_params(batch_size=1), device=dev)
        torch.cuda.reset_peak_memory_stats()
        _, _, logs = trainer.train_one_epoch()
        serial_peak = torch.cuda.max_memory_allocated()
        serial_losses = logs["step losses"]
        ref_path = TP_DIR / "serial_weights.pt"
        torch.save({k: p.detach().cpu() for k, p in trainer.model_params.items()}, ref_path)
        del trainer, logs
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[tp serial] batch 1, {TP_TRAIN_LAYERS} blocks, checkpointing {TP_LEVEL}: losses "
              f"{serial_losses}, peak {serial_peak / 2**30:.2f} GiB", flush=True)
        t0 = time.perf_counter()
        pairs = run_ranks("tp_train", *TP_TRAIN, ref_path, serial_losses)
        ranks = [p["train"] for p in pairs]
        devs, udevs = ranks[0]["param_devs"], ranks[0]["update_devs"]
        worst = max(udevs, key=udevs.get)
        rec["train"] = dict(ranks=ranks, wall_s=time.perf_counter() - t0,
                            serial_losses=serial_losses, serial_peak_bytes=serial_peak,
                            worst_leaf=worst, worst_update_dev=udevs[worst],
                            median_update_dev=float(np.median(list(udevs.values()))),
                            worst_dev=max(devs.values()),
                            median_dev=float(np.median(list(devs.values()))))
        print_tp_train(rec["train"])
        check(udevs[worst] < PARALLEL_UPDATE_TOL,
              f"(b) the update of {worst} vs serial: {udevs[worst]}")
        check(rec["train"]["median_update_dev"] < PARALLEL_UPDATE_MEDIAN_TOL,
              f"(b) the median leaf's update vs serial: {rec['train']['median_update_dev']}")
        for r in ranks:
            for name in ("legmm", "dhconv_mm", "dhconv_dw", "gelu_bf16", "gelu_bf16_grad"):
                check(r["launches"][name] > 0, f"(b) {name} not launched on a rank")
            check(r["launches"]["gridmm"] == r["launches"]["legmm"],
                  f"(b) gridmm {r['launches']['gridmm']}, legmm {r['launches']['legmm']}")
            check(r["launches"]["fused_adam"] == TP_TRAIN_STEPS,
                  f"(b) {r['launches']['fused_adam']} fused_adam launches on a rank over "
                  f"{TP_TRAIN_STEPS} steps")
        # the control, run by the same ranks after (b): the fin sum of the
        # filter's contraction dropped
        fdevs = pairs[0]["fault"]["update_devs"]
        fworst = max(fdevs, key=fdevs.get)
        rec["train_fault"] = dict(wall_s=pairs[0]["fault"]["wall_s"], worst_leaf=fworst,
                                  worst_update_dev=fdevs[fworst],
                                  median_update_dev=float(np.median(list(fdevs.values()))))
        f = rec["train_fault"]
        print(f"[tp train control] {f['wall_s']:.1f} s of them; the fin sum of the filter's "
              f"contraction dropped: updates vs serial, norm-wise: worst {f['worst_update_dev']:.3g} "
              f"({fworst}), median {f['median_update_dev']:.3g} (must read above the bounds "
              f"{PARALLEL_UPDATE_TOL} and {PARALLEL_UPDATE_MEDIAN_TOL})", flush=True)
        check(f["worst_update_dev"] > PARALLEL_UPDATE_TOL
              and f["median_update_dev"] > PARALLEL_UPDATE_MEDIAN_TOL,
              f"(b)'s control reads {f['worst_update_dev']} and {f['median_update_dev']}, "
              "within the bounds")
    finally:
        shutil.rmtree(TP_DIR, ignore_errors=True)
    return rec


def print_tp_serve(serve):
    for i, r in enumerate(serve["ranks"]):
        steps = len(r["step_ms"])
        fams = "; ".join(f"{n}: error {f['err']:.3g}, {f['ms']:.1f} ms, {f['split']} split "
                         f"leaves, bytes sent {f['moved']}" for n, f in r["families"].items())
        print(f"[tp serve rank {i}] fin 2 x fout 2 on {r['device']}: step ms "
              f"{', '.join(f'{t:.1f}' for t in r['step_ms'])} (serial "
              f"{', '.join(f'{t:.1f}' for t in serve['serial_ms'])}); errors vs serial "
              f"{', '.join(f'{e:.3g}' for e in r['errs'])} (bound {PARALLEL_SERVE_TOL}); "
              f"launches legmm {r['launches']['legmm']}, gridmm {r['launches']['gridmm']}, "
              f"dhconv_mm {r['launches']['dhconv_mm']};"
              f" bytes sent a step { {k: v / steps for k, v in r['moved'].items()} }; peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; (d) {fams}", flush=True)
    print(f"[tp serve] {serve['wall_s']:.1f} s for the 4 ranks, start to end; (d) serial "
          f"forwards { {k: round(v, 1) for k, v in serve['family_serial_ms'].items()} } ms",
          flush=True)


def print_tp_train(train):
    for i, r in enumerate(train["ranks"]):
        print(f"[tp train rank {i}] h 2 x fin 2, bf16 AMP, {TP_TRAIN_LAYERS} blocks, "
              f"checkpointing {TP_LEVEL}: losses {r['losses']} (serial {train['serial_losses']}, "
              f"bound {PARALLEL_LOSS_TOL}); epoch {r['epoch_s']:.2f} s "
              f"({r['epoch_s'] * 1e3 / len(r['losses']):.1f} ms a step with the loader); "
              f"launches "
              f"{ {k: r['launches'][k] for k in ('legmm', 'gridmm', 'dhconv_mm', 'dhconv_dw', 'fused_adam', 'gelu_bf16', 'gelu_bf16_grad')} }; "
              f"bytes sent {r['moved']}; peak {r['peak_bytes'] / 2**30:.2f} GiB (reserved "
              f"{r['reserved_bytes'] / 2**30:.2f})", flush=True)
    print(f"[tp train] {train['wall_s']:.1f} s for the 4 ranks with the control; serial peak "
          f"{train['serial_peak_bytes'] / 2**30:.2f} GiB; split leaves "
          f"{len(train['ranks'][0]['shards'])}; updates over {TP_TRAIN_STEPS} steps vs serial, "
          f"norm-wise: worst {train['worst_update_dev']:.3g} ({train['worst_leaf']}), median "
          f"{train['median_update_dev']:.3g} (bounds {PARALLEL_UPDATE_TOL}, "
          f"{PARALLEL_UPDATE_MEDIAN_TOL}); the weights: worst {train['worst_dev']:.3g}, median "
          f"{train['median_dev']:.3g}", flush=True)


# --------------------------------------------------------------------------
# phase 19: the last modules on spatial ranks, and the "bf16" norm statistics
# --------------------------------------------------------------------------

def sp_fno_params(**overrides):
    """config/icml_models.yaml's fno_linear_73ch on synthetic data, 73
    channels in and out: the model alone."""
    from makani_tpu_torch.models.model_registry import update_channel_params
    from makani_tpu_torch.utils.yparams import YParams
    p = YParams(str(ROOT / "config" / "icml_models.yaml"), FNO_LINEAR)
    p.update_params(dict(enable_synthetic_data=True, in_channels=list(range(FILES_CHANNELS)),
                         out_channels=list(range(FILES_CHANNELS)), **overrides))
    return update_channel_params(p)


def sp_train_params(**overrides):
    """(b)'s Trainer: fno_linear_73ch under bf16 AMP, cut as SP_CUTS lists."""
    return sp_fno_params(amp_mode="bf16", num_layers=SP_TRAIN_LAYERS, batch_size=1,
                         n_train_samples_per_epoch=SP_TRAIN_STEPS, optimizer_fused=True,
                         skip_validation=True, save_checkpoint="none", max_epochs=1,
                         checkpointing=SP_LEVEL, log_to_screen=False, **overrides)


def sp_fft(torch, serial_dir, scales):
    """(d) on a rank: the FFT2 pair on its window of the seeded field at each
    grid, its coefficient block and round-trip window against the serial
    cuFFT pair's saved at `serial_dir`, relative to their largest
    magnitudes; the pair's ms (one warm call first) and bytes sent."""
    import numpy as np
    from makani_tpu_torch.ops.fft import InverseRealFFT2, RealFFT2
    from makani_tpu_torch.parallel import comm, spmd
    dev = comm.get_device()
    out = []
    for grid in SP_FFT_GRIDS:
        fwd, inv = RealFFT2(*grid, *SP_FFT_MODES), InverseRealFFT2(*grid, *SP_FFT_MODES)
        x = spmd.local_patch(parallel_input(torch, dev, (1, SP_FFT_CHANNELS, *grid)),
                             grid).contiguous()
        with torch.inference_mode():
            inv(fwd(x))
            spmd.moved.clear()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            coeffs = fwd(x)
            back = inv(coeffs)
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        l, m = (spmd.patch_slice(n, ax) for n, ax in zip(SP_FFT_MODES, ("h", "w")))
        lat, lon = (spmd.patch_slice(n, ax) for n, ax in zip(grid, ("h", "w")))
        want_c = np.load(serial_dir / f"fft{grid[0]}_coeffs.npy", mmap_mode="r")[..., l, m]
        want_b = np.load(serial_dir / f"fft{grid[0]}_back.npy", mmap_mode="r")[..., lat, lon]
        sc, sb = scales[f"fft{grid[0]}"]
        out.append(dict(grid=grid, block=tuple(coeffs.shape), ms=ms, moved=dict(spmd.moved),
                        err_coeffs=float(np.abs(coeffs.cpu().numpy() - want_c).max()) / sc,
                        err_back=float(np.abs(back.cpu().numpy() - want_b).max()) / sb))
        del x, coeffs, back
    return out


def sp_serve(torch, serial_dir, scales):
    """(a) on a rank: fno_linear_73ch from PARALLEL_SEED, built by the ranks
    in turn (a whole float32 copy is 8.5 GB; each keeps its shard), its
    window of the seeded input, SP_SERVE_STEPS rollout steps held against
    the serial steps saved at `serial_dir`."""
    import numpy as np
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.ops import kernels
    from makani_tpu_torch.parallel import comm, spmd
    dev = comm.get_device()
    params = sp_fno_params()
    model = None
    torch.cuda.reset_peak_memory_stats(dev)
    for r in range(comm.get_world_size()):
        if comm.get_world_rank() == r:
            model = get_model(params, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(PARALLEL_SEED))
            gc.collect()
            torch.cuda.empty_cache()
        comm.barrier()
    build_peak = torch.cuda.max_memory_allocated(dev)
    model.eval()
    hw = (params.img_crop_shape_x, params.img_crop_shape_y)
    x = spmd.local_patch(parallel_input(torch, dev, (1, params.N_in_channels, *hw)),
                         hw).contiguous()
    lat, lon = (spmd.patch_slice(n, ax) for n, ax in zip(hw, ("h", "w")))
    weight = model.model.blocks[1].filter_layer.filter.weight
    errs, times = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    spmd.moved.clear()
    with torch.inference_mode():
        for step in range(SP_SERVE_STEPS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            x = model(x)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            got = x.cpu().numpy()
            check(bool(np.isfinite(got).all()), f"(a) step {step} not finite")
            want = np.load(serial_dir / f"fno_step{step}.npy", mmap_mode="r")[..., lat, lon]
            errs.append(float(np.abs(got - want).max()) / scales[f"fno{step}"])
    out = dict(errs=errs, step_ms=times, launches=dict(kernels.launches), moved=dict(spmd.moved),
               peak_bytes=torch.cuda.max_memory_allocated(dev), build_peak_bytes=build_peak,
               patch=tuple(x.shape[-2:]), filter_block=tuple(weight.shape),
               local_params=sum(p.numel() for p in model.parameters()),
               backend=comm.get_backend(), device=str(dev))
    del model, x, weight
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_families(torch, serial_dir, scales):
    """(c) on a rank: each family's forward on its window of the seeded
    720x1440 input, held against the serial output saved at `serial_dir`."""
    import numpy as np
    from makani_tpu_torch.parallel import comm, partitioning, spmd
    dev = comm.get_device()
    hw = FAMILY_SHAPE
    lat, lon = (spmd.patch_slice(n, ax) for n, ax in zip(hw, ("h", "w")))
    out = {}
    for name in SP_FAMILIES:
        net = tp_family(torch, name, dev,
                        torch.Generator(device=dev).manual_seed(PARALLEL_SEED + 3),
                        SP_FAMILY_LAYERS)
        net.eval()
        split = len(partitioning.shard_module(net))
        x = spmd.local_patch(tp_family_input(torch, dev), hw).contiguous()
        spmd.moved.clear()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            y = net(x)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        got = y.cpu().numpy()
        check(bool(np.isfinite(got).all()), f"(c) {name} not finite")
        want = np.load(serial_dir / f"{name}.npy", mmap_mode="r")[..., lat, lon]
        out[name] = dict(err=float(np.abs(got - want).max()) / scales[name], ms=ms,
                         moved=dict(spmd.moved), split=split, window=tuple(got.shape))
        del net, x, y
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sp_rank(torch, serial_dir, scales, ref_path, serial_losses):
    """Phase 19 on a rank, one spawn: (d) the FFT pairs, (a) the FNO's
    rollout, (c) the families' forwards, (b) the AMP Trainer, then its
    control (the spatial sum of the replicated leaves' gradients dropped)."""
    out = dict(fft=sp_fft(torch, serial_dir, scales), serve=sp_serve(torch, serial_dir, scales),
               families=sp_families(torch, serial_dir, scales))
    pair = parallel_train_pair(torch, ref_path, serial_losses, spatial=True)
    out.update(train=pair["train"], train_fault=pair["fault"])
    return out


def sp_norm_stats(torch, sht, complex_ops, kernels, dev):
    """(e): the flagship's AMP forward at "bf16" statistics against "f32"
    statistics, beside AMP's deviation from the float32 forward, with the
    launches of the "bf16" forward; one InstanceNorm2d at NORM_SHAPE on bf16
    at both modes, timed with CUDA events beside its bytes bound."""
    from makani_tpu_torch.models.common import layers
    from makani_tpu_torch.models.model_registry import get_model
    params = flagship_params(1)
    params["amp_mode"] = "bf16"
    model = get_model(params, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(PARALLEL_SEED))
    model.eval()
    x = parallel_input(torch, dev, (1, params.N_in_channels, params.img_crop_shape_x,
                                    params.img_crop_shape_y))
    out = {}
    try:
        with torch.inference_mode():
            y32 = model(x).double()
        sht.set_transform_precision("default")
        complex_ops.set_contraction_precision("default")
        xb = x.to(torch.bfloat16)
        y_amp, out["f32_stats_ms"], _ = amp_forward(torch, kernels, model, xb, "(e) f32 stats")
        layers.set_norm_stats_mode("bf16")
        y_bf, out["bf16_stats_ms"], out["launches"] = amp_forward(torch, kernels, model, xb,
                                                                  "(e) bf16 stats")
    finally:
        layers.set_norm_stats_mode("f32")
        sht.set_transform_precision("high")
        complex_ops.set_contraction_precision("high")
    y_amp, y_bf = y_amp.double(), y_bf.double()
    out.update(amp_dev_f32=dev_norm(y_amp, y32), bf16_dev_f32_stats=dev_norm(y_bf, y_amp),
               bf16_dev_float32=dev_norm(y_bf, y32))
    del model, x, xb, y32, y_amp, y_bf
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED + 4)
    xn = (torch.randn(NORM_SHAPE, device=dev, generator=gen) * 1.7 + 0.6).to(torch.bfloat16)
    norm = layers.InstanceNorm2d(NORM_SHAPE[1], device=dev)
    ys, ms = {}, {}
    try:
        with torch.inference_mode():
            for mode in ("f32", "bf16"):
                layers.set_norm_stats_mode(mode)
                ys[mode] = norm(xn).double()
                ms[mode] = cuda_ms(lambda: norm(xn), 20)
    finally:
        layers.set_norm_stats_mode("f32")
    out.update(norm_ms=ms, norm_dev=dev_norm(ys["bf16"], ys["f32"]),
               norm_max_abs=float((ys["bf16"] - ys["f32"]).abs().max()))
    out["norm_bound_ms"], out["norm_bound_by"] = bound(2 * xn.numel() * 2, 0)
    del xn, ys
    torch.cuda.empty_cache()
    return out


def phase_spatial(torch, np, sht, complex_ops, kernels, dev, card):
    """Phase 19 (module docstring); prints each part when it is measured."""
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.ops.fft import InverseRealFFT2, RealFFT2
    from makani_tpu_torch.utils.trainer import Trainer
    sht.set_coeff_engine("kernel")
    sht.set_transform_precision("high")
    complex_ops.set_contraction_precision("high")
    rec = {"cuts": list(SP_CUTS)}
    for cut in SP_CUTS:
        print(f"[spatial cut] {cut}", flush=True)
    # fused_adam on an (h, w) block of the FNO's diagonal filter: the rank at
    # h 1, w 1, l and m 90-179 of the (64, 64, 180, 180, 2) leaf
    key = "model.blocks.1.filter_layer.filter.weight"
    a = rec["adam"] = parallel_adam_shard(torch, dev, key, SP_FILTER, (
        (2, "h", SP_BLOCK[2], SP_BLOCK[2]), (3, "w", SP_BLOCK[3], SP_BLOCK[3])))
    print(f"[spatial kernel] {card}: fused_adam on {key}'s (h, w) block {a['splits']} of "
          f"{a['shape']} (base {a['base']}), bf16 moments, stochastic rounding, 2 steps: p, mu, "
          f"nu differ from the twin in {a['vs_twin']} and from the whole leaf's slice in "
          f"{a['vs_whole']} of {a['n']} elements (bound 0); control, base 0: {a['control']} "
          "differ (must not be 0 in mu and nu)", flush=True)
    check(a["vs_twin"] == [0, 0, 0] and a["vs_whole"] == [0, 0, 0],
          f"fused_adam on the (h, w) block vs twin {a['vs_twin']}, whole {a['vs_whole']}")
    check(a["control"][1] > 0 and a["control"][2] > 0,
          f"fused_adam's control with base 0 matches the whole leaf: {a['control']}")
    # (e) the "bf16" norm statistics
    n = rec["norm"] = sp_norm_stats(torch, sht, complex_ops, kernels, dev)
    print(f"[spatial norm] {card}: flagship_synth_drive_bare AMP forward at 'bf16' statistics "
          f"against 'f32': {n['bf16_dev_f32_stats']:.4g} norm-wise (must read below AMP's own "
          f"deviation from float32 in this run, {n['amp_dev_f32']:.4g}; PERF.md §2: 3.26e-2); "
          f"against float32 {n['bf16_dev_float32']:.4g}; forward {n['bf16_stats_ms']:.1f} ms "
          f"('f32' statistics {n['f32_stats_ms']:.1f}); launches {n['launches']}", flush=True)
    print(f"[spatial norm] {card}: InstanceNorm2d {NORM_SHAPE} bf16: 'f32' statistics "
          f"{n['norm_ms']['f32']:.4f} ms, 'bf16' {n['norm_ms']['bf16']:.4f} ms (bound "
          f"{n['norm_bound_ms']:.4f} by {n['norm_bound_by']}); 'bf16' vs 'f32' "
          f"{n['norm_dev']:.3g} norm-wise, {n['norm_max_abs']:.3g} at most (makani_tpu's gate: "
          "0.05)", flush=True)
    check(n["bf16_dev_f32_stats"] < n["amp_dev_f32"],
          f"(e) bf16 statistics deviate by {n['bf16_dev_f32_stats']}, AMP by {n['amp_dev_f32']}")
    check(n["norm_max_abs"] < 0.05, f"(e) the norm at bf16 statistics: {n['norm_max_abs']}")
    for name in ("legmm", "dhconv_mm", "gelu_bf16"):
        check(n["launches"].get(name, 0) > 0, f"(e) {name} not launched")
    check(n["launches"].get("gridmm", 0) == n["launches"]["legmm"],
          f"(e) gridmm {n['launches'].get('gridmm', 0)}, legmm {n['launches']['legmm']}")
    shutil.rmtree(SP_DIR, ignore_errors=True)
    SP_DIR.mkdir(parents=True)
    try:
        scales, serial = {}, {}
        # (d) the serial cuFFT pairs
        for grid in SP_FFT_GRIDS:
            fwd, inv = RealFFT2(*grid, *SP_FFT_MODES), InverseRealFFT2(*grid, *SP_FFT_MODES)
            x = parallel_input(torch, dev, (1, SP_FFT_CHANNELS, *grid))
            with torch.inference_mode():
                coeffs = fwd(x)
                back = inv(coeffs)
                serial[f"fft{grid[0]}_ms"] = cuda_ms(lambda: inv(fwd(x)), 5)
            c, b = coeffs.cpu().numpy(), back.cpu().numpy()
            scales[f"fft{grid[0]}"] = (float(np.abs(c).max()), float(np.abs(b).max()))
            np.save(SP_DIR / f"fft{grid[0]}_coeffs.npy", c)
            np.save(SP_DIR / f"fft{grid[0]}_back.npy", b)
            del x, coeffs, back, c, b
        # (a) the serial rollout of the same weights
        params = sp_fno_params()
        model = get_model(params, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(PARALLEL_SEED))
        model.eval()
        rec["fno_params"] = sum(p.numel() for p in model.parameters())
        weight = model.model.blocks[1].filter_layer.filter.weight
        check(type(model.model).__name__ == "FourierNeuralOperatorNet"
              and tuple(weight.shape) == SP_FILTER,
              f"(a) {type(model.model).__name__}, filter {tuple(weight.shape)}")
        del weight
        hw = (params.img_crop_shape_x, params.img_crop_shape_y)
        x = parallel_input(torch, dev, (1, params.N_in_channels, *hw))
        serial["fno_ms"] = []
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            for step in range(SP_SERVE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = model(x)
                torch.cuda.synchronize()
                serial["fno_ms"].append((time.perf_counter() - t0) * 1e3)
                y = x.cpu().numpy()
                scales[f"fno{step}"] = float(np.abs(y).max())
                np.save(SP_DIR / f"fno_step{step}.npy", y)
        serial["fno_peak_bytes"] = torch.cuda.max_memory_allocated()
        del model, x, y
        # (c) the serial family forwards
        serial["family_ms"] = {}
        for name in SP_FAMILIES:
            gc.collect()
            torch.cuda.empty_cache()
            net = tp_family(torch, name, dev,
                            torch.Generator(device=dev).manual_seed(PARALLEL_SEED + 3),
                            SP_FAMILY_LAYERS)
            net.eval()
            xf = tp_family_input(torch, dev)
            with torch.inference_mode():
                net(xf)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = net(xf).cpu().numpy()
                serial["family_ms"][name] = (time.perf_counter() - t0) * 1e3
            scales[name] = float(np.abs(y).max())
            np.save(SP_DIR / f"{name}.npy", y)
            del net, xf, y
        # (b) the serial reference at the same depth and level
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer(sp_train_params(), device=dev)
        torch.cuda.reset_peak_memory_stats()
        _, _, logs = trainer.train_one_epoch()
        serial["train_peak_bytes"] = torch.cuda.max_memory_allocated()
        serial_losses = logs["step losses"]
        ref_path = SP_DIR / "serial_weights.pt"
        torch.save({k: p.detach().cpu() for k, p in trainer.model_params.items()}, ref_path)
        del trainer, logs
        gc.collect()
        torch.cuda.empty_cache()
        serial["train_losses"] = serial_losses
        rec["serial"] = serial
        print(f"[spatial serial] {card}: {FNO_LINEAR} {rec['fno_params']} parameters, rollout "
              f"step ms {', '.join(f'{t:.1f}' for t in serial['fno_ms'])}, peak "
              f"{serial['fno_peak_bytes'] / 2**30:.2f} GiB; family forwards "
              f"{ {k: round(v, 1) for k, v in serial['family_ms'].items()} } ms; the FFT2 pair "
              f"(cuFFT) {', '.join(f'{serial[k]:.3f}' for k in serial if k.startswith('fft'))} "
              f"ms at {SP_FFT_GRIDS}; AMP Trainer at {SP_TRAIN_LAYERS} blocks: losses "
              f"{serial_losses}, peak {serial['train_peak_bytes'] / 2**30:.2f} GiB", flush=True)
        # the ranks: one spawn for (a)-(d)
        t0 = time.perf_counter()
        ranks = run_ranks("spatial", *SP_SIZES, SP_DIR, scales, ref_path, serial_losses)
        rec["wall_s"] = time.perf_counter() - t0
        rec["ranks"] = ranks
        udevs = ranks[0]["train"]["update_devs"]
        worst = max(udevs, key=udevs.get)
        rec["train_worst"] = (worst, udevs[worst])
        rec["train_median"] = float(np.median(list(udevs.values())))
        fdevs = ranks[0]["train_fault"]["update_devs"]
        fworst = max(fdevs, key=fdevs.get)
        rec["fault_worst"] = (fworst, fdevs[fworst])
        rec["fault_median"] = float(np.median(list(fdevs.values())))
        print_spatial(rec, card)
        for i, r in enumerate(ranks):
            for f in r["fft"]:
                check(max(f["err_coeffs"], f["err_back"]) < SP_FFT_TOL,
                      f"(d) rank {i} FFT2 pair at {f['grid']}: {f['err_coeffs']}, {f['err_back']}")
            check(max(r["serve"]["errs"]) < PARALLEL_SERVE_TOL,
                  f"(a) rank {i} vs serial, by step: {r['serve']['errs']}")
            check(r["serve"]["filter_block"] == SP_BLOCK,
                  f"(a) rank {i} filter block {r['serve']['filter_block']}")
            for name, f in r["families"].items():
                check(f["err"] < PARALLEL_SERVE_TOL, f"(c) {name} rank {i} vs serial: {f['err']}")
            t = r["train"]
            check(t["launches"]["fused_adam"] == SP_TRAIN_STEPS,
                  f"(b) rank {i} fused_adam launches {t['launches']['fused_adam']} over "
                  f"{SP_TRAIN_STEPS} steps of {t['leaves']} leaves")
            for name in ("gelu_bf16", "gelu_bf16_grad"):
                check(t["launches"][name] > 0, f"(b) {name} not launched on rank {i}")
            check(all(t["splits"][f"model.blocks.{b}.filter_layer.filter.weight"]
                      == ((2, "h"), (3, "w")) for b in range(SP_TRAIN_LAYERS)),
                  f"(b) rank {i} filter splits {t['splits']}")
        check(udevs[worst] < PARALLEL_UPDATE_TOL,
              f"(b) the update of {worst} vs serial: {udevs[worst]}")
        check(rec["train_median"] < PARALLEL_UPDATE_MEDIAN_TOL,
              f"(b) the median leaf's update vs serial: {rec['train_median']}")
        check(fdevs[fworst] > PARALLEL_UPDATE_TOL
              and rec["fault_median"] > PARALLEL_UPDATE_MEDIAN_TOL,
              f"(b)'s control reads {fdevs[fworst]} and {rec['fault_median']}, within the bounds")
    finally:
        shutil.rmtree(SP_DIR, ignore_errors=True)
    return rec


def print_spatial(rec, card):
    """Phase 19's rank lines, each with the card's name and power limit."""
    for i, r in enumerate(rec["ranks"]):
        s = r["serve"]
        print(f"[spatial serve rank {i}] {card}: {FNO_LINEAR} on h 2 x w 2, window {s['patch']}, "
              f"filter block {s['filter_block']}, {s['local_params']} parameters on the rank: "
              f"step ms {', '.join(f'{t:.1f}' for t in s['step_ms'])} (serial "
              f"{', '.join(f'{t:.1f}' for t in rec['serial']['fno_ms'])}); errors vs serial "
              f"{', '.join(f'{e:.3g}' for e in s['errs'])} (bound {PARALLEL_SERVE_TOL}); bytes "
              f"sent a step { {k: v / SP_SERVE_STEPS for k, v in s['moved'].items()} }; peak "
              f"{s['peak_bytes'] / 2**30:.2f} GiB (building {s['build_peak_bytes'] / 2**30:.2f}); "
              f"launches {s['launches']}", flush=True)
        fams = "; ".join(f"{n}: window {f['window']}, error {f['err']:.3g}, {f['ms']:.1f} ms, "
                         f"bytes sent {f['moved']}" for n, f in r["families"].items())
        print(f"[spatial families rank {i}] {card}: {fams} (bound {PARALLEL_SERVE_TOL})",
              flush=True)
        ffts = "; ".join(f"{f['grid']}: block {f['block']}, coefficients {f['err_coeffs']:.3g}, "
                         f"round trip {f['err_back']:.3g}, {f['ms']:.1f} ms, bytes sent "
                         f"{f['moved']}" for f in r["fft"])
        print(f"[spatial fft rank {i}] {card}: the FFT2 pair vs serial cuFFT, of the largest "
              f"magnitude: {ffts} (bound {SP_FFT_TOL})", flush=True)
        t = r["train"]
        print(f"[spatial train rank {i}] {card}: {FNO_LINEAR}, bf16 AMP, {SP_TRAIN_LAYERS} "
              f"blocks, checkpointing {SP_LEVEL}: losses {t['losses']} (serial "
              f"{rec['serial']['train_losses']}, bound {PARALLEL_LOSS_TOL}); epoch "
              f"{t['epoch_s']:.2f} s ({t['epoch_s'] * 1e3 / len(t['losses']):.1f} ms a step with "
              f"the loader); launches {t['launches']} ({t['leaves']} leaves, {len(t['splits'])} "
              f"split); bytes sent {t['moved']}; peak {t['peak_bytes'] / 2**30:.2f} GiB "
              f"(reserved {t['reserved_bytes'] / 2**30:.2f})", flush=True)
    (w, wd), (fw, fwd) = rec["train_worst"], rec["fault_worst"]
    print(f"[spatial train] {card}: updates over {SP_TRAIN_STEPS} steps vs serial, norm-wise: "
          f"worst {wd:.3g} ({w}), median {rec['train_median']:.3g} (bounds "
          f"{PARALLEL_UPDATE_TOL}, {PARALLEL_UPDATE_MEDIAN_TOL}); control, the spatial sum of "
          f"the replicated leaves dropped: worst {fwd:.3g} ({fw}), median "
          f"{rec['fault_median']:.3g} (must read above the bounds); serial peak "
          f"{rec['serial']['train_peak_bytes'] / 2**30:.2f} GiB", flush=True)
    print(f"[spatial] {card}: {rec['wall_s']:.1f} s for the 4 ranks, start to end", flush=True)


def grid_f64_bound(passes, exact):
    """The pass bound against float64 of a grid-stage product: 3 passes, or
    2 on an operand exact in bf16 (the table split alone), keep 5e-5; 1 pass
    or 2 on a float32 operand (its bf16 rounding) 5e-2."""
    return F64_TOL[3] if passes == 3 or (passes == 2 and exact) else F64_TOL[1]


def grid_stage_rows(torch, sht, spectral_mm, kernels, dev, gen):
    """Phase 20 (a): each mode's grid stage, forward and backward, at each of
    GRID_STAGE_SHAPES, against the twin and float64, timed."""
    rows = []
    for label, R, nlon, mmax, analysis in GRID_STAGE_SHAPES:
        table = sht._rdft_tensor if analysis else sht._irdft_tensor
        dft, dft_t = table(nlon, mmax, dev), sht._transposed(table, nlon, mmax, dev)
        t, t_t = (dft_t, dft) if analysis else (dft, dft_t)   # (K, N) and (N, K)
        K, N = t.shape
        z = torch.randn((R, nlon) if analysis else (2 * mmax, R), device=dev, generator=gen)
        g = torch.randn((2 * mmax, R) if analysis else (R, nlon), device=dev, generator=gen)
        z_rows, g_rows = (z, g.T) if analysis else (z.T, g)   # (R, K) and (R, N)
        # float64 references: the rows as given and rounded to bf16, the
        # cotangent through the transposed table
        ref_x = z_rows.double() @ t.double()
        ref_xb = z_rows.bfloat16().double() @ t.double()
        ref_g = g_rows.double() @ t_t.double()
        # the float32 call the stage replaced, gridmm alone on row-major
        # operands, and the transpose copy of the (2 * mmax, R) m-leading side
        # that the kernel's layouts spare (one each way)
        f32_ms = cuda_ms(lambda: torch.matmul(dft, z.T) if analysis else torch.matmul(z.T, dft),
                         GRID_REPS)
        m_side = torch.empty((2 * mmax, R), device=dev)
        copy_ms = cuda_ms(lambda: m_side.T.contiguous(), GRID_REPS)
        copy_bytes = 2 * m_side.numel() * 4
        del m_side
        x_c = z_rows.contiguous()
        for mode in GRID_MODES:
            sht.set_transform_precision(mode)
            res = {}
            for engine in ("kernel", "stacked"):
                sht.set_coeff_engine(engine)
                zz = z.detach().requires_grad_(True)
                kernels.reset_launches()
                out = sht._grid_stage(zz, dft, dft_t, analysis)
                (dz,) = torch.autograd.grad(out, zz, g)
                torch.cuda.synchronize()
                res[engine] = (out.detach(), dz, {k: v for k, v in
                                                  kernels.launches_by_passes.items() if v})
                del out, zz
            (out, dz, launched), (tw, tw_dz, tw_launched) = res["kernel"], res["stacked"]
            del res
            out_rows, dz_rows = (out.T, dz) if analysis else (out, dz.T)
            row = dict(shape=label, mode=mode, rows=R, K=K, N=N)
            if mode == "highest":
                check(not launched and not tw_launched, f"(a) {label} highest launched {launched}")
                row.update(passes=None, grad_passes=None, rel_err_twin=rel_err(out, tw.double()),
                           rel_err_f64=rel_err(out_rows, ref_x),
                           grad_rel_err_f64=rel_err(dz_rows, ref_g))
                check(max(row["rel_err_f64"], row["grad_rel_err_f64"]) < GRID_HIGHEST_TOL,
                      f"(a) {label} highest vs float64: {row}")
            else:
                fwd, bwd, rounded = sht._GRID[mode]
                want = {("gridmm", fwd): 1}
                want[("gridmm", bwd)] = want.get(("gridmm", bwd), 0) + 1
                check(launched == want and not tw_launched,
                      f"(a) {label} {mode}: launches {launched}, the twin's {tw_launched}")
                row.update(passes=fwd, grad_passes=bwd, grad_bf16=rounded,
                           rel_err_twin=rel_err(out, tw.double()))
                slack = TWIN_TOL * tw_dz.abs().max() + (bf16_ulp(tw_dz) if rounded else 0)
                gap = (dz - tw_dz).abs()
                row["grad_twin_within"] = bool((gap <= slack).all())
                row["grad_rel_err_twin"] = float(gap.max() / tw_dz.abs().max())
                check(row["rel_err_twin"] < TWIN_TOL and row["grad_twin_within"],
                      f"(a) {label} {mode} kernel vs twin: {row}")
                ref = ref_xb if rounded else ref_x
                row["rel_err_f64"] = rel_err(out_rows, ref)
                row["f64_bound"] = grid_f64_bound(fwd, True)
                err = (dz_rows.double() - ref_g).abs()
                gbound = grid_f64_bound(bwd, False)
                row["grad_rel_err_f64"] = float(err.max() / ref_g.abs().max())
                row["grad_f64_bound"] = gbound
                gslack = gbound * ref_g.abs().max() + (BF16_OUT * ref_g.abs() if rounded else 0)
                check(row["rel_err_f64"] < row["f64_bound"] and bool((err <= gslack).all()),
                      f"(a) {label} {mode} vs float64: {row}")
            del out, dz, tw, tw_dz, out_rows, dz_rows
            # times: the stage each way on the kernel engine, gridmm alone
            sht.set_coeff_engine("kernel")
            zz = z.detach().requires_grad_(True)
            row["ms"] = cuda_ms(lambda: sht._grid_stage(zz, dft, dft_t, analysis), GRID_REPS)
            out = sht._grid_stage(zz, dft, dft_t, analysis)
            row["grad_ms"] = cuda_ms(lambda: torch.autograd.grad(out, zz, g, retain_graph=True),
                                     GRID_REPS)
            del out, zz
            if mode != "highest":
                row["gridmm_ms"] = cuda_ms(lambda: spectral_mm.gridmm(x_c, t, fwd), GRID_REPS)
                row["bound_ms"], row["bound_by"] = bound(R * K * 4 + K * N * 4 + R * N * 4,
                                                         2.0 * R * K * N * fwd)
            row.update(f32_ms=f32_ms, copy_ms=copy_ms, copy_bytes=copy_bytes)
            rows.append(row)
            print(f"  {label} | {mode} | p{row['passes']}/p{row['grad_passes']} | "
                  f"vs twin {row['rel_err_twin']:.3g} / {row.get('grad_rel_err_twin', 0):.3g} | "
                  f"vs f64 {row['rel_err_f64']:.3g} / {row['grad_rel_err_f64']:.3g} | stage "
                  f"{row['ms']:.4f} / {row['grad_ms']:.4f} ms | gridmm "
                  f"{row.get('gridmm_ms', float('nan')):.4f} | f32 mm {f32_ms:.4f} | copy "
                  f"{copy_ms:.4f} ({copy_bytes / 1e9:.3f} GB) | bound "
                  f"{row.get('bound_ms', float('nan')):.4f}", flush=True)
        del z, g, z_rows, g_rows, x_c, ref_x, ref_xb, ref_g
        torch.cuda.empty_cache()
    return rows


def phase_grid_stage(torch, sht, complex_ops, spectral_mm, kernels, dev, gen, amp):
    """Phase 20: the grid stage at every precision mode (the docstring)."""
    from makani_tpu_torch.models.model_registry import get_model
    rec = {}
    t0 = time.perf_counter()
    print("[grid stage] shape | mode | passes fwd/bwd | vs twin fwd / bwd | vs float64 fwd / "
          "bwd | stage ms fwd / bwd | gridmm ms, row-major | float32 torch.matmul ms | the "
          "transpose copy the layouts spare, ms | bound ms", flush=True)
    try:
        rec["rows"] = grid_stage_rows(torch, sht, spectral_mm, kernels, dev, gen)
        # (b) the flagship forward under each mode name
        sht.set_coeff_engine("kernel")
        model = get_model(flagship_params(ROLLOUT_STEPS), device=dev).eval()
        x = torch.randn((1, 73, 721, 1440), device=dev, generator=gen)
        forwards, y_highest = {}, None
        with torch.inference_mode():
            for mode in ("highest", *(m for m in GRID_MODES if m != "highest")):
                sht.set_transform_precision(mode)
                complex_ops.set_contraction_precision(mode)
                model(x)
                torch.cuda.synchronize()
                kernels.reset_launches()
                t1 = time.perf_counter()
                y = model(x)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3
                by = {f"{k}/p{p}": v for (k, p), v in kernels.launches_by_passes.items()
                      if v and k in ("gridmm", "legmm")}
                if mode == "highest":
                    want = {}
                else:
                    want = {f"gridmm/p{sht._GRID[mode][0]}": 18,
                            f"legmm/p{sht._PASSES[mode]}": 18}
                check(by == want and bool(torch.isfinite(y).all()),
                      f"(b) forward at {mode!r}: launches {by}, expected {want}")
                if y_highest is None:
                    y_highest = y
                forwards[mode] = dict(ms=ms, launches=by,
                                      dev_highest=dev_norm(y.double(), y_highest.double()))
                del y
        rec["forwards"] = forwards
        del model, x, y_highest
        torch.cuda.empty_cache()
        # (c) AMP's forward against float32 (phase 9), the DFT at 1 pass
        rec["amp_dev_f32"] = amp["forward_dev_f32"]
        check(rec["amp_dev_f32"] < AMP_DEV_MAX,
              f"(c) AMP deviates from float32 by {rec['amp_dev_f32']}")
    finally:
        sht.set_coeff_engine("kernel")
        sht.set_transform_precision("high")
        complex_ops.set_contraction_precision("high")
        torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t0
    return rec


def print_grid_stage(rec, card):
    for mode, f in rec["forwards"].items():
        print(f"[grid stage forward] {card}: flagship forward at {mode!r}: {f['ms']:.1f} ms, "
              f"launches {f['launches']}, deviation from 'highest' {f['dev_highest']:.4g}",
              flush=True)
    print(f"[grid stage] {card}: AMP's forward deviates from float32 by "
          f"{rec['amp_dev_f32']:.4g} (bound {AMP_DEV_MAX}); phase 20 in "
          f"{rec['phase_s']:.1f} s", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", type=Path, help="write every measurement to this JSON file")
    args = ap.parse_args(argv)
    t_script = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from makani_tpu_torch.ops import complex_ops, kernels, sht, spectral_mm
    from makani_tpu_torch.tools import kernel_isolate
    from makani_tpu_torch.utils.inferencer import Inferencer

    # phase 1: card, versions, numerics
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN; serving precision "
          f"{sht.get_transform_precision()!r} ({sht._coeff_passes()} bf16 passes)", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    # phase 2: build
    t0 = time.perf_counter()
    reports = kernels.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"[build] {record['build_s']:.1f} s into {kernels.BUILD_DIR}")
    for name, log in reports.items():
        print(f"[build {name}] " + " | ".join(
            line.strip() for line in log.splitlines() if "registers" in line or "spill" in line))

    # phase 3: kernels at the flagship shapes
    rows = phase_kernels(torch, spectral_mm, dev, gen)
    record["kernels"] = rows
    print("[kernels] name | shape | passes | rel err vs twin | vs f64 | ms | plain ms | "
          "library ms | bound ms (by)")
    for r in rows:
        print(f"  {r['name']} | {r['shape']} | p{r['passes']} | {r['rel_err_twin']:.3g} | "
              f"{r['rel_err_f64']:.3g} | {r['ms']:.4f} | {r['plain_ms']:.4f} | "
              f"{r['library_ms']:.4f} | {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)

    from makani_tpu_torch.models.model_registry import get_model
    params = flagship_params(ROLLOUT_STEPS)
    model = get_model(params, device=dev)
    adam = phase_adam(torch, kernels, dev, gen,
                      {k: tuple(p.shape) for k, p in model.named_parameters()})
    rows.append(adam)
    print(f"  fused_adam | {adam['shape']} | bf16 SR | bit-identical (max abs diff "
          f"{adam['max_abs_err']}), {adam['launches_per_update']} launch an update | - | "
          f"{adam['ms']:.4f} (the card alone {adam['device_ms']:.4f}, host enqueue "
          f"{adam['enqueue_ms']:.4f}) | {adam['plain_ms']:.4f} | {adam['library_ms']:.4f} (torch "
          f"fused Adam, f32 moments; alone {adam['library_device_ms']:.4f}, enqueue "
          f"{adam['library_enqueue_ms']:.4f}) | {adam['bound_ms']:.4f} ({adam['bound_by']})",
          flush=True)
    gelu_rows = phase_gelu(torch, dev, gen)
    record["gelu_kernels"] = gelu_rows
    for r in gelu_rows:
        print(f"  {r['name']} | {r['shape']} | - | bit-identical | - | {r['ms']:.4f} | "
              f"{r['plain_ms']:.4f} | {r['library_ms']:.4f} (PyTorch's fused GELU, rounded "
              f"once) | {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    norm_rows = phase_instance_norm(torch, dev, gen)
    record["norm_kernels"] = norm_rows
    for r in norm_rows:
        print(f"  {r['name']} | {r['shape']} | - | within 1 ulp | - | {r['ms']:.4f} | "
              f"{r['plain_ms']:.4f} | {r['library_ms']:.4f} (F.instance_norm, autograd "
              f"backward) | {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)

    # phase 4: full-width forward, kernels vs twins; small SFNO card vs CPU
    model.eval()
    x = torch.randn((1, params.N_in_channels, 721, 1440), device=dev, generator=gen)
    with torch.inference_mode():
        model(x)  # warm-up: cuBLAS handles and workspaces
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        y_kernel = model(x)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        per_forward = dict(kernels.launches)
        sht.set_coeff_engine("stacked")
        t0 = time.perf_counter()
        y_plain = model(x)
        torch.cuda.synchronize()
        fwd_plain_ms = (time.perf_counter() - t0) * 1e3
        sht.set_coeff_engine("kernel")
    check(per_forward == launch_counts(kernels, {"legmm": 18, "gridmm": 18, "dhconv_mm": 8}),
          f"launches per forward {per_forward}, expected 18 legmm, 18 gridmm and 8 dhconv_mm")
    check(tuple(y_kernel.shape) == (1, 73, 721, 1440), f"forward shape {tuple(y_kernel.shape)}")
    fwd_err = rel_err(y_kernel, y_plain.double())
    check(bool(torch.isfinite(y_kernel).all()), "forward output not finite")
    check(fwd_err < FORWARD_TOL, f"forward kernels vs twins: {fwd_err}")
    # phase 9 holds the AMP forward against this one, on the same input
    x_host, y_f32 = x.cpu(), y_kernel.cpu()
    del y_kernel, y_plain
    small_err = phase_small(torch, dev)
    record.update(forward_ms=fwd_ms, forward_plain_ms=fwd_plain_ms, forward_rel_err=fwd_err,
                  launches_per_forward=per_forward, small_rel_err=small_err)
    print(f"[forward] flagship 73ch 721x1440 edim384 x8: {fwd_ms:.1f} ms with kernels, "
          f"{fwd_plain_ms:.1f} ms with twins; rel err {fwd_err:.3g}; launches {per_forward}; "
          f"small SFNO card vs CPU rel err {small_err:.3g}", flush=True)

    # phase 5: the serving path, an Inferencer lite rollout
    inferencer = Inferencer(params, weights=model.state_dict(), device=dev)
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches, step_all = timed_rollouts(torch, np, kernels, inferencer, x, "rollout")
    peak = torch.cuda.max_memory_allocated()
    check(launches == launch_counts(kernels, {"legmm": 18 * ROLLOUT_STEPS,
                                              "gridmm": 18 * ROLLOUT_STEPS,
                                              "dhconv_mm": 8 * ROLLOUT_STEPS}),
          f"rollout launches {launches}")
    step_ms = statistics.median(step_all)
    record.update(rollout_steps=ROLLOUT_STEPS, step_ms=step_ms, step_ms_all=step_all,
                  peak_bytes=peak, rollout_launches=launches)
    print(f"[rollout] {ROLLOUT_STEPS} steps at batch 1: {step_ms:.1f} ms per step, median of "
          f"{ROLLOUT_REPS} warm rollouts ({', '.join(f'{t:.1f}' for t in step_all)}; host "
          f"clock, prediction copied to the host each step); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)

    del inferencer, x
    torch.cuda.empty_cache()

    # phase 6: the training path
    train = phase_train(torch, sht, kernels, dev)
    record.update(train)
    print(f"[train] flagship {train['n_params']} parameters in {train['n_leaves']} leaves, "
          f"{TRAIN_STEPS} steps at batch 1, losses {train['train_losses']}; train step "
          f"{train['train_step_ms']:.1f} ms (median of {train['train_step_ms_all']}); peak "
          f"device memory {train['train_peak_bytes'] / 2**30:.2f} GiB; launches per step "
          f"{train['train_launches_per_step']}; gradients kernels vs twins rel err "
          f"{train['grad_rel_err_max']:.3g} ({train['grad_rel_err_leaf']}); small SFNO "
          f"gradients card vs CPU {train['small_grad_rel_err_max']:.3g} "
          f"({train['small_grad_rel_err_leaf']})", flush=True)

    # phase 7: the complex coefficient engine with the complex dhconv kernel
    settings = (sht.get_coeff_engine(), sht.get_transform_precision(),
                complex_ops.get_contraction_precision(), complex_ops._USE_PALLAS_DHCONV)
    sht.set_coeff_engine("xla")
    sht.set_transform_precision("high")
    complex_ops.set_contraction_precision("high")
    complex_ops.enable_pallas_kernels(True)
    try:
        cplx = phase_complex(torch, np, sht, complex_ops, kernels, dev, gen)
    finally:
        sht.set_coeff_engine(settings[0])
        sht.set_transform_precision(settings[1])
        complex_ops.set_contraction_precision(settings[2])
        complex_ops.enable_pallas_kernels(settings[3])
    record["complex"] = cplx
    print("[complex kernel] name | shape | passes | rel err vs twin | vs f64 | ms | plain ms | "
          "library ms | bound ms (by)")
    for r in cplx["kernels"]:
        print(f"  {r['name']} | {r['shape']} | p{r['passes']} | {r['rel_err_twin']:.3g} | "
              f"{r['rel_err_f64']:.3g} | {r['ms']:.4f} | "
              f"{r['plain_ms']:.4f} | {r['library_ms']:.4f} | {r['bound_ms']:.4f} "
              f"({r['bound_by']})", flush=True)
    print(f"[complex forward] flagship on the 'xla' engine with the kernel: "
          f"{cplx['forward_ms']:.1f} ms (kernel engine, phase 4: {fwd_ms:.1f} ms); rel err "
          f"vs 'xla' without the kernel {cplx['forward_rel_err_einsum']:.3g}, vs the kernel "
          f"engine {cplx['forward_rel_err_kernel_engine']:.3g}; launches "
          f"{cplx['launches_per_forward']}", flush=True)
    print(f"[complex rollout] {ROLLOUT_STEPS} steps at batch 1: {cplx['step_ms']:.1f} ms per "
          f"step, median of {ROLLOUT_REPS} warm rollouts "
          f"({', '.join(f'{t:.1f}' for t in cplx['step_ms_all'])}); peak device memory "
          f"{cplx['peak_bytes'] / 2**30:.2f} GiB; launches {cplx['rollout_launches']}",
          flush=True)
    print(f"[complex train] losses {cplx['train_losses']}; train step "
          f"{cplx['train_step_ms']:.1f} ms (median of {cplx['train_step_ms_all']}; kernel "
          f"engine, phase 6: {train['train_step_ms']:.1f} ms); peak device memory "
          f"{cplx['train_peak_bytes'] / 2**30:.2f} GiB; launches per step "
          f"{cplx['train_launches_per_step']}; gradients vs the kernel engine rel err "
          f"{cplx['grad_rel_err_max']:.3g} ({cplx['grad_rel_err_leaf']})", flush=True)

    # phase 8: the kernel-benchmark and probe path
    grid_rows = phase_grid(torch, spectral_mm, kernels, dev, gen)
    record["grid_kernels"] = grid_rows
    print("[grid kernels] name | shape | passes | rel err vs twin | vs f64 | ms | plain ms | "
          "library ms (float32 torch.mm, or the probe's call) | bf16 torch.mm ms | bound ms (by) "
          "| probes: device ms, library device ms (profiler)")
    for r in grid_rows:
        f64 = "-" if r["rel_err_f64"] is None else f"{r['rel_err_f64']:.3g}"
        bf = f"{r['bf16_ms']:.4f}" if "bf16_ms" in r else "-"
        passes = "-" if r["passes"] is None else f"p{r['passes']}"
        dev_ms = (f" | {r['device_ms']:.6f}, {r['library_device_ms']:.6f}"
                  if "device_ms" in r else "")
        print(f"  {r['name']} | {r['shape']} | {passes} | {r['rel_err_twin']:.3g} | {f64} | "
              f"{r['ms']:.4f} | {r['plain_ms']:.4f} | {r['library_ms']:.4f} | {bf} | "
              f"{r['bound_ms']:.6f} ({r['bound_by']}){dev_ms}", flush=True)
    probe_rows = [r for r in grid_rows if "device_ms" in r]
    copy_ms = next(r["device_ms"] for r in probe_rows if r["name"] == "probe_copy")

    def spread(r, key):
        runs = r[f"{key}_runs"]
        return f"{1e3 * r[key]:.3f} ({1e3 * min(runs):.3f}-{1e3 * max(runs):.3f})"
    print(f"[probe device time] us a call, median (spread) of {DEVICE_RUNS} runs of "
          f"{kernel_isolate.DEVICE_REPS} calls, the kernel / its PyTorch call: " + "; ".join(
              f"{r['name']} {spread(r, 'device_ms')} / {spread(r, 'library_device_ms')}"
              for r in probe_rows)
          + f"; probe_copy {1e3 * copy_ms:.3f} (the launch floor); profiler sessions discarded "
          f"for lost records: {kernel_isolate.discarded_sessions}", flush=True)
    def runs(r, key, fmt):
        return f"{r[key]:{fmt}} ({', '.join(f'{t:{fmt}}' for t in r[f'{key}_runs'])})"
    for r in probe_rows:
        print(f"[probe host] {r['name']}: median ({DEVICE_RUNS} interleaved rounds), the kernel "
              f"/ its PyTorch call: CUDA events ms {runs(r, 'ms', '.4f')} / "
              f"{runs(r, 'library_ms', '.4f')}; host enqueue us {runs(r, 'enqueue_us', '.2f')} / "
              f"{runs(r, 'library_enqueue_us', '.2f')}, after the profiler's sessions "
              f"{r['enqueue_after_profiler_us']:.2f} / "
              f"{r['library_enqueue_after_profiler_us']:.2f}; device us "
              f"{1e3 * r['device_ms']:.3f} / {1e3 * r['library_device_ms']:.3f}", flush=True)
    tools = phase_tools(torch, kernels)
    record["tools"] = tools
    print(f"[tools] bench_spectral_mm all, bench_gridmm, kernel_isolate: all returned 0 in "
          f"{tools['bench_spectral_mm_s']:.1f} + {tools['bench_gridmm_s']:.1f} + "
          f"{tools['kernel_isolate_s']:.1f} s; nine PASS; launches {tools['launches']}",
          flush=True)

    # phase 9: bf16 AMP at full width. cuBLAS may reduce bf16 products in
    # bf16 unless told not to; makani_tpu accumulates them in float32
    settings = (sht.get_coeff_engine(), sht.get_transform_precision(),
                complex_ops.get_contraction_precision(), complex_ops._USE_PALLAS_DHCONV,
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        amp = phase_amp(torch, np, sht, complex_ops, kernels, dev, x_host, y_f32)
    finally:
        sht.set_coeff_engine(settings[0])
        sht.set_transform_precision(settings[1])
        complex_ops.set_contraction_precision(settings[2])
        complex_ops.enable_pallas_kernels(settings[3])
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = settings[4]
    del x_host, y_f32
    record["amp"] = amp
    print(f"[amp forward] bf16 AMP, precision 'default' (1 bf16 pass), bf16 reduced-precision "
          f"reductions off: {amp['forward_ms']:.1f} ms (float32, phase 4: {fwd_ms:.1f} ms); "
          f"norm-wise deviation vs the twins {amp['forward_dev_twin']:.3g} (the twins' from "
          f"float32 {amp['twin_dev_f32']:.3g}), vs phase 4's float32 forward "
          f"{amp['forward_dev_f32']:.3g} (largest element {amp['forward_rel_err_f32']:.3g}); "
          f"launches {amp['launches_per_forward']}", flush=True)
    print(f"[amp kernel calls] each call of the AMP forward against its twin on its inputs, "
          f"largest relative error {amp['call_rel_err_twin']} over {amp['calls_checked']} "
          f"calls", flush=True)
    print("[amp blocks] each block and the decoder on the kernels' own input, kernels vs twins "
          "(the twins' AMP vs float32): " + "; ".join(
              f"{d:.3g} ({f:.3g}, {d / f:.3f})"
              for d, f in zip(amp["block_dev_twin"], amp["block_dev_f32"])), flush=True)
    print(f"[amp rollout] {ROLLOUT_STEPS} steps at batch 1: {amp['step_ms']:.1f} ms per step, "
          f"median of {ROLLOUT_REPS} warm rollouts "
          f"({', '.join(f'{t:.1f}' for t in amp['step_ms_all'])}); peak device memory "
          f"{amp['peak_bytes'] / 2**30:.2f} GiB; launches {amp['rollout_launches']}", flush=True)
    print(f"[amp train] losses {amp['train_losses']}; train step {amp['train_step_ms']:.1f} ms "
          f"(median of {amp['train_step_ms_all']}; float32, phase 6: "
          f"{train['train_step_ms']:.1f} ms); peak device memory "
          f"{amp['train_peak_bytes'] / 2**30:.2f} GiB; launches per step "
          f"{amp['train_launches_per_step']}, all at 1 pass", flush=True)
    print(f"[amp xla] the 'xla' engine with its kernel: forward {amp['xla_forward_ms']:.1f} ms, "
          f"deviation vs float32 {amp['xla_forward_dev_f32']:.3g}, launches "
          f"{amp['xla_launches_per_forward']}; train step {amp['xla_train_step_ms']:.1f} ms "
          f"(median of {amp['xla_train_step_ms_all']} after the counted one, loss "
          f"{amp['xla_train_loss']:.6g}, launches {amp['xla_train_launches']})",
          flush=True)

    # phase 10: flagship_synth_drive from files at full width; phase 11:
    # checkpoints, scoring and packages on its dataset and model (the
    # checkpoint is taken between phase 10's training and serving halves,
    # where the trained Trainer is alive; the dataset is removed at the end)
    settings = (sht.get_coeff_engine(), sht.get_transform_precision(),
                complex_ops.get_contraction_precision(),
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    shutil.rmtree(FILES_DIR, ignore_errors=True)
    try:
        files, trainer = phase_files_train(torch, np, kernels, dev)
        serve = {"checkpoint": phase_checkpoint(torch, trainer)}
        del trainer
        torch.cuda.empty_cache()
        files.update(phase_files_serve(torch, np, sht, complex_ops, kernels, dev))
        serve.update(phase_serve(torch, np, sht, complex_ops, kernels, dev))
        # phase 12: the full Trainer through the train CLI, on the same
        # dataset (phase 11's checkpoint and package removed first)
        trainer_rec = phase_trainer(torch, np, kernels, dev)
        # phase 13: the ICML recipes on the same dataset (phase 12's
        # checkpoints removed first)
        icml = phase_icml(torch, np, spectral_mm, kernels, dev, gen)
        # phase 14: the FNO recipes and the model options on the same dataset
        fno = phase_fno(torch, np, sht, complex_ops, kernels, dev, gen)
        # phase 15: the other model families on the same dataset
        families = phase_families(torch, np, kernels, dev, gen)
        # phase 16: the ICML pretrain with validation and its rollout videos
        videos = phase_videos(torch, np, kernels, dev)
    finally:
        shutil.rmtree(FILES_DIR, ignore_errors=True)
        sht.set_coeff_engine(settings[0])
        sht.set_transform_precision(settings[1])
        complex_ops.set_contraction_precision(settings[2])
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = settings[3]
    record["files"] = files
    for cut in FILES_CUTS:
        print(f"[files cut] {cut}")
    print(f"[files data] wrote {FILES_CHANNELS} channels at {FILES_SHAPE[0]}x{FILES_SHAPE[1]}, "
          f"{FILES_TRAIN_SAMPLES} train and "
          f"{FILES_VALID_SAMPLES} test samples as npy shards, with the invariants as .npy, in "
          f"{files['write_s']:.1f} s", flush=True)
    print(f"[files loader] {files['loader_samples']} train samples through get_dataloader and "
          f"the native reader equal the shard read directly and cos_zenith_angle, bit for bit; "
          f"one loader epoch {files['loader_s'] * 1e3:.1f} ms: "
          f"{files['loader_samples_per_s']:.2f} samples/s, {files['loader_gb_per_s']:.2f} GB/s "
          f"({files['sample_bytes'] / 1e6:.1f} MB a sample with its target and zenith fields; "
          f"the shards were just written, so in the page cache)", flush=True)
    print(f"[files train] flagship_synth_drive, {FILES_IN_CHANNELS} input channels (auxiliary "
          f"names {files['aux_channel_names']}, makani_tpu's list), "
          f"bf16 AMP, AdamW beta2 0.95, bf16 moments, {TRAIN_STEPS} steps from the "
          f"files at batch 1 under the profiler: losses {files['train_losses']}; epoch "
          f"{files['epoch_s'] * 1e3:.1f} ms, {files['step_ms_loader']:.1f} ms a step with the "
          f"loader in the loop (phase 9's resident-batch AMP step: {amp['train_step_ms']:.1f} "
          f"ms); device busy {files['epoch_busy_s'] * 1e3:.1f} ms (copies to the card "
          f"{files['epoch_copy_s'] * 1e3:.1f} ms), idle {100 * files['idle_share']:.1f}% of the "
          f"epoch, {(files['epoch_s'] - files['epoch_window_s']) * 1e3:.1f} ms of it before "
          f"the first device event and after the last; peak device memory "
          f"{files['train_peak_bytes'] / 2**30:.2f} GiB; launches per step "
          f"{files['train_launches_per_step']}, all at 1 pass", flush=True)
    print(f"[files serve] float32 forward of the {FILES_IN_CHANNELS}-channel model on the first "
          f"evaluation sample: {files['forward_ms']:.1f} ms, kernels vs twins rel err "
          f"{files['forward_rel_err']:.3g}, launches {files['launches_per_forward']}; capture "
          f"rollout of {files['rollout_steps']} steps (valid_autoreg_steps {FILES_AUTOREG}), "
          f"zenith from the targets' times: {files['step_ms']:.1f} ms per step, median of "
          f"{ROLLOUT_REPS} warm rollouts ({', '.join(f'{t:.1f}' for t in files['step_ms_all'])}); "
          f"peak device memory {files['rollout_peak_bytes'] / 2**30:.2f} GiB; launches "
          f"{files['rollout_launches']}", flush=True)

    record["serve"] = serve
    ck = serve["checkpoint"]
    print(f"[serve checkpoint] phase 10's model and AdamW state (bf16 moments), "
          f"{ck['n_tensors']} parameter tensors: {ck['bytes'] / 1e9:.3f} GB "
          f"({ck['model_bytes'] / 1e9:.3f} GB of weights) saved in {ck['save_s']:.2f} s "
          f"({ck['save_gb_per_s']:.2f} GB/s; the host copy in the call {ck['copy_s']:.2f} s, "
          f"then the background write), restored into a fresh model and state in "
          f"{ck['restore_s']:.2f} s ({ck['restore_gb_per_s']:.2f} GB/s), every tensor and the "
          f"counters equal, bit for bit; disk free before {ck['disk_free_bytes'] / 1e9:.1f} GB",
          flush=True)
    print(f"[serve score] score_model from the checkpoint, {FILES_EVAL} evaluation samples at "
          f"valid_autoreg_steps {FILES_AUTOREG}, float32 'high': {serve['score_s']:.2f} s, "
          f"{serve['score_ms_per_step']:.1f} ms a scored step with the loader and the exports "
          f"(a scored step on a resident batch {serve['metrics_step_ms']:.1f} ms, median of "
          f"{ROLLOUT_REPS}: {', '.join(f'{t:.1f}' for t in serve['metrics_step_ms_all'])}; "
          f"phase 10's capture step {files['step_ms']:.1f} ms); peak device memory "
          f"{serve['score_peak_bytes'] / 2**30:.2f} GiB; launches a scored step "
          f"{serve['launches_per_scored_step']}, by passes {serve['score_launches_by_passes']}; "
          f"logs {serve['logs_base']}; exports and loss vs the twins "
          f"{serve['score_rel_err_twin']:.3g}, {serve['loss_rel_err_twin']:.3g}", flush=True)
    print(f"[serve single/lite/predict] inference_single with metrics and data, inference_lite "
          f"with channels {sorted(SERVE_PERTURBATION)} perturbed (the IC plus RandomState(42)'s "
          f"draws, bit for bit) and channel {SERVE_PERSISTENCE} persisted (equal to its IC at "
          f"every step, bit for bit), predict: all finite", flush=True)
    print(f"[serve cli] python3 -m makani_tpu_torch.inference --mode epoch in a subprocess: "
          f"returned 0 in {serve['cli_s']:.1f} s (its kernel build included); exports vs "
          f"in-process {serve['cli_rel_err']:.3g}", flush=True)
    print(f"[serve package] save_model_package + best_ckpt (the model alone), .npy invariants, "
          f"{serve['package_bytes'] / 1e9:.3f} GB; load_time_loop, {SERVE_LOOP_STEPS} steps: "
          f"{serve['loop_step_ms']:.1f} ms a step (median; "
          f"{', '.join(f'{t:.1f}' for t in serve['loop_step_ms_all'])}; host fields in and out), "
          f"kernels vs twins {serve['loop_rel_err_twin']:.3g}; launches {serve['loop_launches']}",
          flush=True)

    record["train"] = trainer_rec
    tr = trainer_rec
    for cut in TRAIN_CUTS:
        print(f"[trainer cut] {cut}")
    print(f"[trainer disk] {tr['disk_free_bytes'] / 1e9:.1f} GB free before the phase",
          flush=True)
    for i, e in enumerate(tr["epochs"] + [tr["resume_epoch"]], start=1):
        t = e["timing"]
        print(f"[trainer epoch {i}]{' (resumed)' if i > TRAIN_EPOCHS else ''} train losses "
              f"{e['train_losses']}, lr {e['lrs'][0]:.6g}; validation loss "
              f"{e['valid_base']['validation loss']:.6g}, L1 {e['valid_base']['validation L1']:.6g};"
              f" epoch {t['epoch time [s]']:.2f} s, train {t['training time [s]']:.2f} s "
              f"({t['training step time [ms]']:.1f} ms a step), validation "
              f"{t['validation time [s]']:.2f} s; loader wait "
              f"{100 * e['data_wait_frac']:.1f}% of the train time", flush=True)
    print(f"[trainer run] (a) {tr['run_a_s']:.1f} s for {TRAIN_EPOCHS} epochs from main(), "
          f"{tr['train_steps']} AMP train steps and {tr['valid_steps']} validation AR steps; "
          f"launches {tr['launches']}, all at 1 pass; peak device memory "
          f"{tr['peak_bytes'] / 2**30:.2f} GiB; profiler trace of 2 steps "
          f"({tr['trace_bytes'] / 1e6:.1f} MB) names {tr['trace_kernels']}; (b) resumed at "
          f"epoch {TRAIN_EPOCHS} with the weights, bf16 moments, counters, scheduler and "
          f"generator of (a) bit for bit, epoch 3 alone in {tr['run_b_s']:.1f} s, launches "
          f"{tr['resume_launches']}; (c) the DebugNet self-test returned 0 in "
          f"{tr['selftest_s']:.1f} s: {tr['selftest_line'].split(' - ')[-1]}", flush=True)
    print(f"[trainer valid step] a validation AR step on a resident batch "
          f"{tr['valid_step_ms']:.1f} ms (median of {ROLLOUT_REPS} rollouts of "
          f"{FILES_AUTOREG + 1}: {', '.join(f'{t:.1f}' for t in tr['valid_step_ms_all'])}); "
          f"launches {tr['valid_step_launches']}, all at 1 pass", flush=True)
    print("[trainer saves] " + "; ".join(
        f"epoch {v['epoch']} {v['path']}: {v['bytes'] / 1e9:.3f} GB, copy {v['copy_s']:.2f} s, "
        f"write {v['write_s']:.2f} s" for v in tr["saves"])
          + f"; waits for the writes {', '.join(f'{w:.2f}' for w in tr['waits_s'])} s (at each "
          f"epoch's checkpoint decision, then at the end); {tr['hidden_s']:.2f} s of "
          f"{tr['write_s']:.2f} s of writes hidden", flush=True)

    record["icml"] = icml
    print_icml(icml)
    record["fno"] = fno
    print_fno(fno)
    record["families"] = families
    print_families(families, card)
    record["videos"] = videos
    print_videos(videos, card)

    # phase 17: data and spatial parallelism, the ranks sharing the card
    t0 = time.perf_counter()
    par = phase_parallel(torch, np, spectral_mm, kernels, dev, gen, card,
                         order_gap=record["forward_rel_err"])
    par["phase_s"] = time.perf_counter() - t0
    record["parallel"] = par
    print(f"[parallel time] phase 17 in {par['phase_s']:.1f} s", flush=True)

    # phase 18: channel (tensor) parallelism, the ranks sharing the card
    t0 = time.perf_counter()
    tp = phase_tensor_parallel(torch, np, spectral_mm, kernels, dev, gen, card)
    tp["phase_s"] = time.perf_counter() - t0
    record["tensor_parallel"] = tp
    print(f"[tp time] phase 18 in {tp['phase_s']:.1f} s", flush=True)

    # phase 19: the last modules on spatial ranks, the "bf16" norm statistics
    t0 = time.perf_counter()
    sp = phase_spatial(torch, np, sht, complex_ops, kernels, dev, card)
    sp["phase_s"] = time.perf_counter() - t0
    record["spatial"] = sp
    print(f"[spatial time] phase 19 in {sp['phase_s']:.1f} s", flush=True)
    # phase 20: the grid stage at every precision mode
    grid_stage = phase_grid_stage(torch, sht, complex_ops, spectral_mm, kernels, dev, gen, amp)
    record["grid_stage"] = grid_stage
    print_grid_stage(grid_stage, card)
    record["script_s"] = time.perf_counter() - t_script
    print(f"[time] phases 1-20 in {record['script_s']:.1f} s, the kernels' build included",
          flush=True)

    # results
    if args.record is not None:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(record, indent=1))
    # launches: counted over the training epoch (TRAIN_STEPS steps), the path
    # that runs all four kernels; launches_per_train_step is that count over
    # the steps, launches_rollout the count of the serving rollout
    main_rows = {"legmm": ("full analysis", 3), "dhconv_mm": ("forward", 3),
                 "dhconv_dw": (None, 3), "fused_adam": (None, None)}
    sources = {"legmm": ("makani_tpu_torch/csrc/legmm.cu", "makani_tpu/ops/pallas_mm.py:130"),
               "dhconv_mm": ("makani_tpu_torch/csrc/dhconv_mm.cu",
                             "makani_tpu/ops/pallas_mm.py:195"),
               "dhconv_dw": ("makani_tpu_torch/csrc/dhconv_dw.cu",
                             "makani_tpu/ops/pallas_mm.py:322"),
               "fused_adam": ("makani_tpu_torch/csrc/fused_adam.cu",
                              "makani_tpu/ops/pallas_adam.py:124")}
    def files_launches(name):
        """*_files: the counts of phase 10's path, an AMP epoch and a float32
        rollout from files; launches_score: phase 11's launches a scored step;
        launches_trainer: phase 12's run (a), 2 epochs with validation;
        launches_valid_step: a validation AR step of phase 12;
        launches_multistep: phase 13's 2-step finetune (b), 2 steps;
        launches_nonlinear: phase 13's non-linear run (c), 3 steps;
        launches_lamb: phase 13's LAMB update over (a)'s leaves (e);
        launches_fno_linear / _nonlinear: phase 14's FNO runs (a) and (b),
        2 steps each; launches_scan: its scan_layers run, 2 steps;
        launches_factorized: its CP filter's forward and backward;
        launches_csphase: its csphase=False pairs; launches_fp16_trainer:
        its Trainer with float16 moments, 2 steps; launches_fp16_update: one
        float16 update over the linear FNO's leaves; launches_afno_v2,
        launches_afno_v1, launches_vit: phase 15's float32 runs of afno_v2,
        afno_backbone and vit_backbone (2 steps each), and *_amp their bf16
        AMP runs (1 step each); launches_videos: phase 16's run, 2 train
        steps and a validation that renders."""
        return dict(launches_files=files["train_launches"][name],
                    launches_per_train_step_files=files["train_launches_per_step"][name],
                    launches_rollout_files=files["rollout_launches"][name],
                    launches_score=serve["launches_per_scored_step"][name],
                    launches_trainer=tr["launches"][name],
                    launches_valid_step=tr["valid_step_launches"][name],
                    launches_multistep=icml["finetune"]["launches"][name],
                    launches_nonlinear=icml["nonlinear"]["launches"][name],
                    launches_lamb=icml["optimizers"]["lamb"]["launches"]
                    if name == "fused_adam" else 0,
                    launches_fno_linear=fno["linear"]["launches"][name],
                    launches_fno_nonlinear=fno["nonlinear"]["launches"][name],
                    launches_scan=fno["scan"]["launches"][name],
                    launches_factorized=fno["factorized"]["launches"][name],
                    launches_csphase=fno["csphase"]["launches"][name],
                    launches_fp16_trainer=fno["f16_trainer"]["launches"][name],
                    launches_fp16_update=fno["adam"]["float16_launches"]
                    if name == "fused_adam" else 0,
                    **{f"launches_{tag}{amp}": families[family + amp]["launches"][name]
                       for tag, family in (("afno_v2", AFNO_V2), ("afno_v1", AFNO_V1),
                                           ("vit", VIT)) for amp in ("", "_amp")},
                    launches_videos=videos["launches"][name],
                    # phase 17: each rank's launches, (a) h 2 x w 2 over 2
                    # rollout steps, (b) data 2 x h 2 over 2 AMP train steps
                    # of PARALLEL_TRAIN_LAYERS blocks
                    launches_parallel_serve=[r["launches"][name]
                                             for r in par["serve"]["ranks"]],
                    launches_parallel_train=[r["launches"][name]
                                             for r in par["train"]["ranks"]],
                    # (e) and (f): the flagship in a class from a file, the
                    # whole field on each rank, 1 float32 rollout step at 8
                    # blocks, and 1 forward and backward at
                    # PARALLEL_TRAIN_LAYERS
                    launches_file_class_serve=[r["launches"][name]
                                               for r in par["file_serve"]["ranks"]],
                    launches_file_class_grad=[r["launches"][name]
                                              for r in par["file_grad"]["ranks"]],
                    # phase 18: each rank's launches, (a) fin 2 x fout 2 over
                    # 1 rollout step, (b) h 2 x fin 2 over 2 AMP train steps
                    launches_tp_serve=[r["launches"][name] for r in tp["serve"]["ranks"]],
                    launches_tp_train=[r["launches"][name] for r in tp["train"]["ranks"]],
                    # phase 19: each rank's launches, (a) the FNO's float32
                    # rollout on h 2 x w 2, (b) its 2 AMP train steps; (e)
                    # the flagship's AMP forward at "bf16" norm statistics
                    launches_spatial_serve=[r["serve"]["launches"].get(name, 0)
                                            for r in sp["ranks"]],
                    launches_spatial_train=[r["train"]["launches"].get(name, 0)
                                            for r in sp["ranks"]],
                    launches_norm_bf16=sp["norm"]["launches"].get(name, 0))

    kernels = []
    # *_amp: the same counts on phase 9's AMP path, where every pass-taking
    # launch ran at 1 pass (the "xla" engine's kernel: over its one train step)
    for name, (label, passes) in main_rows.items():
        r = next(r for r in rows if r["name"] == name and r["passes"] == passes
                 and (label is None or r["shape"].startswith(label)))
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
            launches=train["train_launches"][name],
            launches_per_train_step=train["train_launches_per_step"][name],
            launches_rollout=launches[name],
            launches_amp=amp["train_launches"][name],
            launches_per_train_step_amp=amp["train_launches_per_step"][name],
            launches_rollout_amp=amp["rollout_launches"][name],
            **files_launches(name),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"], passes=passes))
        if label is not None or name == "dhconv_dw":
            # phase 17 (c): the same kernel at a rank's local shape (m-slice
            # of 121 orders; the dhconv kernels on 120 degrees), 3 passes
            lr = next(q for q in par["kernels"] if q["name"] == name and q["passes"] == 3
                      and q["local_m"] == 121 and (label is None or q["shape"].startswith(label)))
            kernels[-1]["parallel_local"] = {k: lr[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
        # phase 18 (c): the kernel at a fin rank's shapes (192 input channels)
        if name == "fused_adam":
            kernels[-1]["tp_local"] = [{k: a[k] for k in ("key", "base", "vs_twin", "vs_whole",
                                                           "control")} for a in tp["adam"]]
            # phase 19: the kernel on an (h, w) block of the FNO's filter
            kernels[-1]["spatial_local"] = {k: sp["adam"][k] for k in (
                "key", "base", "vs_twin", "vs_whole", "control")}
        else:
            tq = next(q for q in tp["kernels"] if q["name"] == name
                      and (label is None or q["shape"].startswith(label)))
            kernels[-1]["tp_local"] = {k: tq[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
    # fused_adam at the linear FNO's 2.12 B elements (phase 14 (d)): each
    # moment type's update time beside its bound, and torch's fused Adam
    a = fno["adam"]
    row = next(r for r in kernels if r["name"] == "fused_adam")
    row.update(elements_fno=a["elements"], library_ms_fno=a["library_ms"], **{
        f"{k}_fno": {f: a[k][f] for f in ("ms", "device_ms", "enqueue_ms", "bound_ms", "bound_by")}
        for k in ("float16", "bf16_sr", "float32")})
    # phase 3's update: the card's time alone and the host's enqueue, beside
    # the CUDA-event `ms`
    row.update({k: adam[k] for k in ("device_ms", "enqueue_ms", "launches_per_update",
                                     "library_device_ms", "library_enqueue_ms")})
    row["float16_fno"]["plain_ms"] = a["float16"]["plain_ms"]
    # the complex dhconv kernel: launches over phase 7's training epoch, the
    # path that runs it forward and backward
    r = next(r for r in cplx["kernels"] if r["shape"].startswith("forward") and r["passes"] == 3)
    kernels.append(dict(
        name="dhconv_complex", route="cuda", source="makani_tpu_torch/csrc/dhconv_complex.cu",
        replaces="makani_tpu/ops/pallas_kernels.py:101",
        launches=cplx["train_launches"]["dhconv_complex"],
        launches_per_train_step=cplx["train_launches_per_step"]["dhconv_complex"],
        launches_rollout=cplx["rollout_launches"]["dhconv_complex"],
        launches_amp=amp["xla_train_launches"]["dhconv_complex"],
        launches_per_train_step_amp=amp["xla_train_launches"]["dhconv_complex"],
        launches_rollout_amp=0, **files_launches("dhconv_complex"),
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        shape=r["shape"], passes=3,
        tp_local={k: q[k] for q in tp["kernels"] if q["name"] == "dhconv_complex"
                  for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                            "max_abs_err")}))
    # gridmm, the longitude DFT of every SHT: launches over phase 6's training
    # epoch and phase 5's rollout as the other main rows, phase 8's tools in
    # launches_tools, phase 20's grid stage in grid_stage; its times are
    # phase 8's flagship analysis with a float32 x at 3 passes (its bound's
    # shape)
    r = next(r for r in grid_rows if r["name"] == "gridmm")
    kernels.append(dict(
        name="gridmm", route="cuda", source="makani_tpu_torch/csrc/gridmm.cu",
        replaces="makani_tpu/ops/pallas_mm.py:82",
        launches=train["train_launches"]["gridmm"],
        launches_per_train_step=train["train_launches_per_step"]["gridmm"],
        launches_rollout=launches["gridmm"],
        launches_amp=amp["train_launches"]["gridmm"],
        launches_per_train_step_amp=amp["train_launches_per_step"]["gridmm"],
        launches_rollout_amp=amp["rollout_launches"]["gridmm"],
        launches_tools=tools["launches"]["gridmm"], **files_launches("gridmm"),
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        shape=r["shape"], passes=r["passes"],
        grid_stage=[{k: q.get(k) for k in ("shape", "mode", "passes", "grad_passes", "ms",
                                           "grad_ms", "gridmm_ms", "f32_ms", "copy_ms",
                                           "rel_err_twin", "rel_err_f64", "grad_rel_err_f64")}
                    for q in grid_stage["rows"]]))
    # the kernel-benchmark and probe path: launches counted over phase 8's
    # run of the three tools; no model path runs these kernels
    grid_sources = {"grid_dot": ("makani_tpu_torch/csrc/gridmm.cu",
                                 "scripts/bench_gridmm.py:63")}
    probe_calls = {"probe_copy": 41, "probe_dot_plain": 54, "probe_dot_transposed": 67,
                   "probe_grid_blocks": 82, "probe_stacked_output": 103,
                   "probe_multi_output": 125, "probe_bf16_split": 149}
    grid_sources.update({name: ("makani_tpu_torch/csrc/probes.cu",
                                f"scripts/pallas_isolate.py:{line}")
                         for name, line in probe_calls.items()})
    for name, (source, replaces) in grid_sources.items():
        # grid_dot: the script's bf16 analysis
        r = next(r for r in grid_rows if r["name"] == name)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=tools["launches"][name], launches_per_train_step=0, launches_rollout=0,
            launches_amp=0, launches_per_train_step_amp=0, launches_rollout_amp=0,
            **files_launches(name),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"], passes=r["passes"],
            **{k: r[k] for k in ("device_ms", "library_device_ms", "enqueue_us",
                                 "library_enqueue_us") if k in r}))
    # the bf16 GELU kernels run on phase 9's AMP path alone: launches over
    # its training epoch; times from phase 3
    for r in gelu_rows:
        kernels.append(dict(
            name=r["name"], route="cuda", source="makani_tpu_torch/csrc/gelu.cu",
            replaces="makani_tpu/models/common/activations.py:48",
            launches=amp["train_launches"][r["name"]],
            launches_per_train_step=amp["train_launches_per_step"][r["name"]],
            launches_rollout=0, launches_amp=amp["train_launches"][r["name"]],
            launches_per_train_step_amp=amp["train_launches_per_step"][r["name"]],
            launches_rollout_amp=amp["rollout_launches"][r["name"]],
            **files_launches(r["name"]),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"], passes=None))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
