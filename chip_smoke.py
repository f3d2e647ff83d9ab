"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. device   - requires CUDA, prints the card's name and power limit,
                turns TF32 off;
  2. build    - compiles every kernel of the main paths from csrc/ (one nvcc
                per source, all at once) and, beside them with g++, the host
                data library of the training input pipeline
                (csrc/host/data.cpp; its seconds printed), and prints
                ptxas's registers and spills per kernel; the wgmma kernels of K1-bf16 and K2-bf16
                and the tap kernels of K3-bf16 and K4-bf16 must spill
                nothing and must not have their wgmma chains serialised;
  3. bf16 GEMM reduction - set_precision(bf16) must turn cuBLAS's bf16
                split-K reduction off; a bf16 weight gradient at the training
                shape (K = 14,464) against f32 accumulation rounded once,
                with the flag off (checked) and on (printed); then one short
                untimed profiler session (`warm_profiler`);
  4. kernels  - each kernel (K1, K2 mixed-attention forward/backward, K3, K4
                MSDA forward/backward) against its plain PyTorch version on
                the card at the main paths' shapes (the lockstep eval's
                batch of 12 included; and narrow and ragged
                edge cases), K1's saved logsumexp included and fed to K2,
                timed on the device (torch.profiler) and with CUDA events,
                beside the plain version, a PyTorch library yardstick where
                one call computes the same function (and the ratio of the
                kernel's time to it), and the card's bound: K1 and K2 run
                3xTF32 on the tensor cores, so their bound_ms is at
                495 / 3 = 165 TFLOP/s, with the f32 CUDA-core bound at
                67 TFLOP/s beside it as bound_f32_ms. K3 and K4 also run on
                model-like sampling locations (the fusion's reference grid
                plus its grid-bias offsets) beside uniform ones, on every
                path `msda_plan` can choose (each is required once), and
                K3's gather grid is timed empty as its launch floor; then
                the bf16 kernels K1-bf16 and K3-bf16 (the JAX package's
                eval dtype) at the bf16 tracker's and the lockstep N = 12
                shapes (K3-bf16 at B 1, 4, 12, 16 on uniform and model-like
                locations, msda_plan's tap kernel required, at most
                MAX_DIFFERING of its outputs not bit-equal to the plain
                version; K1-bf16's attention_bf16_plan must split the keys
                at the tracking shapes and not at the training and lockstep
                ones) and on edge cases (K1-bf16 also with every key-share
                count on K1_SPLIT_EDGES), each against its plain version
                (bf16_tol) and, with its plain version, against the f32
                answer on the same inputs: the kernel's error at most 1.25x
                the plain version's; SDPA at bf16 beside K1-bf16; then the
                bf16 backward kernels at the training shapes, K2-bf16 with
                K1-bf16's lse (the f32 K2 as the f32 answer, SDPA's bf16
                backward as the library time; two calls on one input must
                give the same bits) and
                K4-bf16 on uniform and model-like locations (the f32 K4 as
                the f32 answer; its tap kernel's dValue and dAttw at most
                MAX_DIFFERING not bit-equal to the plain version, and the
                same bits on a second call), and on edge cases covering
                both of msda_plan's backward paths at bf16; each MSDA tap
                row also prints the dense tensor-core floor of its
                products beside the bound; then K1-bf16 (training)
                plus K2-bf16 per bf16 training step beside SDPA's fwd+bwd;
                last the fused AdamW update (csrc/adamw.cu) over the
                recipe's trainable parameters in their regime groups: the
                same bits as its plain version on the card and on the CPU,
                timed beside torch._fused_adamw_;
  5. model    - the full-width asymmetric_shared_ce recipe (seeded random
                weights): cached path (set_online + forward_track) against
                the full forward, and the GPU run against the same model on
                the CPU (plain versions) on the same crops;
  6. tracker  - create_tracker(dtype=torch.float32) -> initialize -> track
                over a seeded synthetic 512x640 RGB-T sequence (64 frames,
                update interval 25), with every kernel's launch count read
                over that run;
  7. profile  - where a frame's time goes: each layer on the host clock, and
                a torch.profiler trace of 10 more frames for the device's busy
                time, idle share, operations per frame and top kernels;
                the tracker phase's and this one's frames are CUDA graph
                replays (create_tracker's default on the card);
  7b. graphs  - a capture of a step that reads a value on the host must
                raise naming the operation and leave the thread's stream
                and the caching allocator as before (what torch alone
                leaves after such a capture is printed beside it), and
                one after it must work;
                the tracking step as CUDA graphs against the same step
                eager (graphs=False) on one model, f32 and bf16: the 63
                frames four times (graphed, eager, graphed, eager), every
                trajectory bit-equal and every run's launch counts equal;
                10 more frames profiled each way, where each kernel's
                launch count must equal the kernels of its name the
                profiler saw in the replays. Prints ms per frame, the
                host's own ms and CPU ms per frame (staging and dispatch)
                and the calling thread's, device busy, idle share and
                operations per frame, capture ms per graph, the graph
                pool's bytes and peak memory;
  7c. train data - the training input pipeline on this machine's host at
                the recipe's settings (batch 16, 8 loader threads): the
                native loader (the C++ host data library, the Trainer's)
                against the plain one (numpy) on one seed, every key of 9
                batches bit for bit; ms per batch of each (after a first
                batch), the host's CPU count; and one line saying whether
                the machine has libjpeg (jpeglib.h, libjpeg.so);
  8. train    - Trainer(dtype=torch.float32) on the full-width recipe at
                batch 16 on SyntheticRGBT, its step a CUDA graph replay
                (the Trainer's default on the card; one graph per keep
                bucket), held against eager twins (graphs=False) from the
                same seed over 6 steps on the same batches (keep 1.0 twice,
                the final bucket twice, 1.0, the bucket): the same launch
                counts, and since f32's K4 sums dValue with atomics (two
                eager runs differ, and more with each step), the counters,
                generator state, BN batch counts and the first step's
                forward metrics bit for bit, then one replay from the eager
                run's state (loaded in place) against an eager step: the
                forward bit for bit, the gradients within 1e-4 of their
                norm, the weights after the update within 1e-6 and the
                AdamW moments within 1e-5; then one step at each other keep
                rate of the recipe's 150-epoch schedule (7 graphs in one
                pool; the pool's and the process's reserved bytes after
                each capture); then an epoch of steps at epoch 1
                (keep 1.0) and one at epoch 51 (keep 0.7, bucketised to
                240/324), launch counts per step;
                step time, samples/s, host data time, device busy time and
                idle share, peak memory, loss per step; an epoch of 16 steps
                (32 at bf16) through cycle_dataset at the recipe's print
                interval, with the loader and the one-batch look-ahead
                (pinned buffers, side-stream uploads) running as in
                training: ms per step after the first 4 against the
                isolated step (5 steps before the epoch, 5 after it, all
                before the profiler, which slows host-bound steps after
                it; the isolated and profiled steps also eager, with the
                host's CPU ms per step, the memory beyond the Trainer's
                state and the graph pool's bytes, capture ms per graph; a
                replay's device operations and K1-K4 kernels per step must
                equal the eager step's), the device stream's wait on each upload
                (CUDA events) and the loop's wait for each batch; and one full-width
                step at batch 2 (dropout and drop path off) on the GPU held
                against the same step on the CPU; launches of K1-K4 and
                one AdamW update per step only;
  9. train bf16 - the same at the Trainer's default dtype (bf16 compute on
                float32 parameters and AdamW moments, both checked), where
                the graphed 6 steps must equal the eager ones bit for bit
                (weights, BN buffers, moments, counters, generator state,
                every step's metrics): K1-bf16
                and K2-bf16 12 and K3-bf16 and K4-bf16 2 launches per step and
                no f32 kernel; finite losses that change between steps; the
                same timings, device busy time, idle share, operations per
                step and peak memory; the epoch at the training pace also
                with its batches collated before the epoch (no loader
                thread beside the steps); a GPU bf16 step at batch 2 held against
                the CPU bf16 step and the GPU f32 step;
 10. lifecycle - checkpoints and the rest of the training loop, full width at
                batch 16 at the Trainer's default (bf16), in a temporary
                directory deleted at the end: a synthetic MAE backbone file warm-starts the backbone
                (checked equal); Trainer.train runs 2 epochs of 2 steps
                with a SyntheticRGBT val split every epoch and a failure
                injected into the second training pass, and the fail-safe
                restart (after that pass ran, so the state has moved on)
                must resume from _ep0001, loading it into the tensors the
                step's graphs hold, finish at epoch 2 and equal an
                uninterrupted two-epoch run bit for bit; a
                fresh Trainer's load_checkpoint must equal the first bit for
                bit (weights, buffers, AdamW moments, count, epoch,
                generator); an ACCUM_ITER 2 epoch of 4 batches must move the
                weights after batches 2 and 4 only, through two role graphs
                (accumulate, update), and equal an eager twin's epoch bit
                for bit; create_tracker on the
                _ep0002 checkpoint (strict load, bf16) must track 16 frames
                within 1e-6 px of a tracker on the trainer's in-memory model
                cast to bf16; bf16 kernels only.
                Prints checkpoint bytes, save / load / resume seconds, val
                ms per batch and ms per accumulation micro-step beside the
                isolated bf16 step of phase 9;
 11. eval     - the evaluation stack on synthetic_rgbt_hard (12 sequences at
                240x320, 30 of their 60 frames each, HARD_FRAMES, as in
                every later phase's runs but the eval.run CLIs' since PR
                18), full width, seed-0 weights: run_dataset
                one stream at a time, chunk 16 (A); run_sequences_batched at
                N = 4 and N = 12 (B4, B12: the N sequences as one (2N, ...)
                batch; K3 takes its gather kernel at N = 4 and its staged one
                at N = 12); run_sequence with ROI-window uploads, margin 1.5
                (R). Requires a result file per sequence with finite boxes
                inside the frame, B4 and B12 within 0.05 px of A at every
                frame, R's files byte-identical to A's and its trajectories
                equal, a windowed chunk, and each run's K1 / K3 launches (K2
                and K4 none); A and B12 (graphed, the default) run again
                eager (A_eager, B12_eager), bit-equal and with the same
                launches. Prints frames/s on the host clock per run,
                upload bytes per frame (full frames, ROI windows), a profiled
                B12 block's device busy time and idle share, and the
                success / precision tables of A and B12;
 12. bf16     - the bf16 serving path: create_tracker(dtype=torch.bfloat16)
                tracks the tracker phase's 63 frames (ms per frame, centre
                distance to the f32 trajectory; the same distance eager
                with K1-bf16, K3-bf16 or both replaced by their plain
                versions on the same CUDA tensors), a profile of 10 more
                (device busy, idle share, operations per frame), then
                synthetic_rgbt_hard one stream (A16) and in lockstep N = 12
                (B12_16): frames/s, device busy per lockstep step, distances
                to one bf16 stream and to the f32 run A; both again eager
                (bit-equal, the same launches), and the N = 12 block
                profiled graphed and eager with its launch counts held
                against the profiler's kernels. Every run must
                launch K1-bf16 and K3-bf16 and no f32 kernel; the f32
                phases must launch no bf16 kernel.
 13. online   - asymmetric_shared_online at full width (phase_online): the
                score-gated cached tracker from create_tracker, f32 and
                bf16, on the tracker phase's 63 frames at update interval
                25, its score bias centred so that scores fall on both
                sides of 0.5: graphed, eager, graphed bit for bit (boxes,
                scores, state buffers), a commit of a taken candidate
                required; f32: the full-forward online tracker within 1e-4
                px of the cached one, a CPU tracker within ONLINE_CPU_PX
                over 8 frames; 10 frames profiled (busy, idle, launches
                against the profiler's kernels), the SPM's and PrRoI's
                device ms and share of a frame; synthetic_rgbt_hard one
                stream against lockstep N = 12 (f32: 0.05 px, identical
                score files; bf16: the drift printed);
 14. stage2   - TRAIN_SCORE (phase_stage2): the online recipe's Trainer at
                batch 64 in bf16, graphed against an eager twin bit for bit
                over 3 steps, then an epoch through cycle_dataset; f32 at
                batch 16 graphed; frozen parameters and BN statistics the
                same bits, score parameters moved, the clipped gradients'
                norm min(grad_norm, GRAD_CLIP_NORM) with the frozen ones
                nonzero; ms per step, busy, idle, memory; one f32 step at
                batch 2 on the GPU against the CPU.
 15. families - the RGB-T families beside the flagship (phase_families),
                full width, seeded random weights: two-stream
                (mixformer_vit_rgbt), shared-LN, unibackbone,
                asymmetric_shared with RGBT_Fusion_Cat and two-stream with
                the SPM. Each: the f32 forward on the card against the CPU
                (1e-4); create_tracker's tracker (full forward for the ViT
                family) at f32 and bf16 on the 63 frames, graphed against
                eager bit for bit, ms per frame, busy, idle, pool bytes; 3
                bf16 batch-16 Trainer steps graphed against eager bit for
                bit (BN statistics included), ms per step, busy, idle,
                memory. Then two-stream lockstep N = 12 at bf16 on
                synthetic_rgbt_hard; the 11 fusion classes at full width,
                forward and backward, against their plain versions; K1 /
                K1-bf16 at N 452 (B*H 12 to 384, plans printed), K2 /
                K2-bf16 at the training ones, K3 / K4 and their bf16 forms
                at head dim 96; the deformable conv's device ms.
                `python3 chip_smoke.py families` runs the device and build
                phases and this phase alone.
 16. unimodal - the unimodal MixFormer-ViT family (phase_unimodal), full
                width, seeded random weights: mixformer_vit/baseline (ViT-B,
                CORNER_UP, 128/288, search factor 4.5): the f32 forward and
                cached path on the card against the CPU (BOX_TOL);
                create_tracker's RGBCachedTracker in RGB, TIR and Prompt,
                f32 and bf16, on the 63 frames at update interval 25, graphed
                against eager bit for bit, no hand-written kernel launched
                (the cached path's attention is plain), 10 frames profiled;
                the f32 cached tracker against the full-forward RGBTracker
                (K1) within UNI_CACHED_PX; 3 Trainer steps at batch 32 on
                SyntheticVideo graphed against eager, bf16 bit for bit, f32
                as the flagship's f32 (an f32 step is not repeatable bit for
                bit: counters, generator and first forward bit for bit, one
                replay from one state within the f32 bounds; K1 and K2 on a
                unimodal path).
                mixformer_vit_online/baseline: OnlineTracker (online size
                3, the ring growing at frames 25 and 50), its score bias
                centred, f32 and bf16, graphed against eager bit for bit,
                the commits printed; stage 2 at batch 32 bf16 graphed
                against eager, frozen tensors unchanged. The device ms of
                the cached path's plain attention in the profiled bf16
                frames of both trackers, and its share of their busy time
                (`_attend_in_frames`). Then `eval.run
                mixformer_vit_online baseline --dataset_name
                synthetic_rgbt_hard --type TIR --batch_sequences 12`, and
                lockstep N = 12 against one stream in TIR mode (f32 within
                UNI_LOCKSTEP_PX, the same score files; bf16 printed); the
                RGB-T online tracker's bf16 lockstep drift study runs alone
                (`python3 chip_smoke.py drift`).
                ViT-L: mixformer_vit/baseline_large (GPU vs
                CPU in f32, LARGE_TRACK - 1 bf16 frames graphed,
                ACCUM_ITER's 3 bf16 steps at batch 12 graphed against
                eager, parameters, peak memory) and
                mixformer_vit_rgbt/baseline_large (its own TEST sizes 192 /
                384, without the tracking overlay's 128 / 288: LARGE_TRACK
                - 1 bf16 frames graphed against eager, one update of 3
                micro-batches of 12); K1 / K1-bf16 and K2 / K2-bf16 at the ViT-L shapes
                and ViT-B's batch 32 against their plain versions.
                `python3 chip_smoke.py unimodal` runs the device and build
                phases and this phase alone.
 17. cvt_convmae - the CvT and ConvMAE MixFormer families
                (phase_cvt_convmae), full width, seeded random weights.
                mixformer_cvt_online/baseline (CvT-21: 64 / 192 / 384,
                depths 1 / 4 / 16, 128 / 320, online size 3, the SPM): the
                f32 forward and cached path on the card against the CPU
                (BOX_TOL); the cached tracker against the full-forward one,
                both through the plain attention, within CVT_CACHED_PX over
                the 63 frames; OnlineTracker, its score bias centred, f32 and
                bf16, graphed against eager bit for bit, the ring's commits,
                10 frames profiled with the plain attention's share of the
                bf16 frames' busy time; stage 2 at batch 32 bf16 graphed
                against eager. mixformer_cvt/baseline (CvT-21): 3 bf16
                steps at batch 8 graphed against eager bit for bit, f32 held
                as the unimodal f32 step. No CvT path launches a
                hand-written attention kernel (a count of 0, required).
                mixformer_convmae/baseline (ConvMAE-B, CORNER_UP, 128 /
                288): GPU against CPU; RGBCachedTracker f32 and bf16 graphed
                against eager, against the full-forward RGBTracker (K1)
                within UNI_CACHED_PX; 3 steps at batch 32, bf16 bit for bit
                (K1-bf16, K2-bf16) and f32 (K1, K2).
                mixformer_convmae_online/baseline: the online tracker bf16,
                stage 2 at batch 32. (The large recipes, CvT-24 and
                ConvMAE-L, run alone since PR 19: `python3 chip_smoke.py
                large`.) Then `eval.run
                mixformer_cvt_online baseline --dataset_name
                synthetic_rgbt_hard --type RGB --batch_sequences 12` and
                `eval.run mixformer_convmae baseline ... --batch_sequences
                12` (frames/s with the model's build), and CvT online
                lockstep N = 12 against one stream (f32, within
                UNI_LOCKSTEP_PX with the same score files).
                `python3 chip_smoke.py cvt_convmae` runs the device and
                build phases and this phase alone.
 18. files    - the file-based data path (phase_files), full width, seeded
                random weights: the host library's decoder (built from
                csrc/host/image.cpp with g++ in the build phase) on every
                committed fixture of tests/torch_port_images/, each decode's
                SHA-256 equal to manifest.json's (the JAX package's
                decode); ms to decode a 640x480 RGB-T pair on one thread
                and through decode_jpeg_batch; a LasHeR tree of 2 x 64
                frames cycling the committed pairs (links) and a DepthTrack
                sequence of 16 frames with 16-bit depth maps written here
                with zlib; the flagship's tracker (bf16 graphed, and f32)
                on a LasHeR sequence from files against the same frames
                handed over as arrays, boxes and result files bit for bit,
                frames/s of each; `eval.run` on the LasHeR and DepthTrack
                trees and the GOT-10k zip of its results; 4 graphed bf16
                Trainer steps at batch 16 from the LasHeR tree through
                cycle_dataset's look-ahead, the loader's ms per batch of 16
                from files beside the isolated graphed step; the CE
                template-range modes CTR_REC, ALL and GT_BOX (with its
                boxes a static input) at bf16 and f32, the full forward
                graphed against eager and, for CTR_REC and ALL, the cached
                tracker over 16 frames graphed against eager, bit for bit;
                CvT-21 with BACKBONE.FREEZE_BN false, 2 bf16 steps at batch
                8 graphed against eager bit for bit, the projection BNs'
                running statistics included and moved. `python3
                chip_smoke.py files` runs the device and build phases and
                this phase alone.
 19. parallel - the multi-GPU slice on the one card (phase_parallel), the
                flagship recipe at full width, global batch 16; everything
                that forms a process group runs in child processes of this
                script (`_parallel_rank`), whose failure fails the phase.
                NCCL at world 1: the one-GPU bf16 Trainer graphed for 3
                steps, then TRAIN.REMAT graphed and eager (step ms, peak
                allocated and graph pool bytes beside the step without
                remat; remat graphed = eager bit for bit; remat's weights
                within 1e-6 of the step without it; its launches a step),
                then the group and the data-parallel Trainer graphed, its
                collectives captured, held bit for bit against the one-GPU
                trainer (the NCCL version printed). Two gloo ranks sharing
                the card, f32 eager, random layers off: the data-parallel
                Trainer (8 samples a rank) 2 steps against the one-process
                step at batch 16 (PAR_F32), then FSDP the same way against
                DP, with each rank's parameter and moment bytes. Then
                run_dataset over two worker threads pinned to cuda:0 on 6
                synthetic_rgbt_hard sequences (bf16 graphed) against the
                sequential run: the result files bit for bit and the same
                launches (a graph counts its own thread's launches at
                capture). The kernel line takes each run's launches as a
                path of its own: gloo DP, FSDP, NCCL DP, remat graphed and
                the two eval workers.
                `python3 chip_smoke.py parallel` runs the device and build
                phases and this phase alone.
Then a line of each phase's seconds (the whole script only), the kernel
table line (launches by path: tracker, graphs, train,
eval, online, stage2, families, unimodal, cvt_convmae, files, parallel
(gloo DP), parallel_fsdp for the f32 kernels; train bf16, lifecycle,
stage2 bf16, families bf16, unimodal bf16, cvt_convmae bf16, files bf16,
parallel bf16 (NCCL DP), parallel remat bf16, and for the forward kernels
the bf16 tracker, graphs, eval, online and parallel eval bf16; train,
train bf16, lifecycle, both stage-2 runs, families bf16, both unimodal
runs, both cvt_convmae runs, files bf16 and the four parallel training
runs for AdamW; the unimodal phase's RGB-T ViT-L counts under families
bf16) and, last, {"ok": true, "device": {...}}.

`python3 chip_smoke.py drift` runs the device and build phases and, alone,
the spread study behind the drift check of phase 16 (`phase_drift`): the
kernels, their plain version and the control at three score-bias offsets.
`python3 chip_smoke.py large` runs them and, alone, the large recipes of
phase 17 (`phase_large`; not part of the whole script since PR 19):
mixformer_cvt_online/baseline_large (CvT-24) and
mixformer_convmae/baseline_large (ConvMAE-L, 192 / 384): parameters,
LARGE_TRACK - 1 bf16 frames graphed against eager, one update (CvT-24: a
stage-2 step at 16; ConvMAE-L: 3 micro-batches of 12), peak memory.

Tolerances (f32 everywhere but the bf16 kernels and phase; TF32 off for
cuBLAS and cuDNN):
  * kernels: 2e-5 abs or 1e-4 rel (K1 and its logsumexp, K2, K3). Both sides
    are f32 sums of the same terms in another order; K1 and K2 form their
    products as 3xTF32, which drops only the small*small term (~2^-22 of a
    product), and sum long reductions tile by tile (tf32_mma.cuh); measured
    differences are up to ~6e-6. One TF32 pass would give 3e-4 to 6e-4
    and fail (tests/test_torch_port_attention_lse.py). K4:
    1e-5 of each output's largest magnitude or 1e-4 rel; it sums dValue with
    atomics in an order that changes from run to run, and dLoc (a factor W
    or H times sums of D products) reaches ~1e3. A wrong mask, tap or
    coordinate gives errors of order 1e-2 of the output or more.
  * eval, lockstep against one stream: 0.05 px in frame coordinates. The
    batch of N runs other GEMM shapes (and a batched crop) than batch 1, so
    sums come out in another order; the model bound above (0.03 px) plus
    what the box map-back adds (f32 only: at bf16 the distance is printed
    as drift). With random weights the box shrinks to the
    10 px minimum; a difference that moved the crop's integer window (round
    half to even of its corner, the ceil of its side) would move a
    trajectory by pixels, which is what this bound catches.
  * bf16 kernels against their plain versions (`bf16_tol`): 2^-8 of the
    largest |value| plus one bf16 unit (2^-7) of the output: each side
    rounds every probability or tap weight to bf16, K1-bf16 at another
    point (before the row-sum division; K2-bf16 takes P from the lse where
    the plain version divides by the row sum), then its output. The MSDA
    kernels round where the plain version rounds: at most MAX_DIFFERING
    (1%) of their bf16 outputs may differ from its bits (the order of f32
    sums). K4-bf16's dLoc is f32: K4's tolerance. Against the f32 answer
    each kernel's error is at most 1.25x its plain version's (K4-bf16 for
    dValue and dAttw).
  * bf16 train step, GPU vs CPU and vs the GPU's f32 step: parameters and
    gradients float32; loss within 2^-6 rel of the CPU bf16 step's and of
    the GPU f32 step's (the bf16 forward drifts from f32 by a few tenths of
    a percent). With the drift the CPU bf16 step's distance from the GPU's
    f32 gradients (bf16 gradients of this loss lie far from f32's, in JAX
    too: tests/test_torch_port_train_step_bf16.py), all gradients together
    within 2 x drift of the CPU bf16 step's and within 1.5 x drift of the
    GPU f32 step's, the bounds that test holds the port to against JAX's
    bf16 and f32 steps. The second fails a gradient that is far off f32:
    a zero gradient lies G (the grad norm) from it, the drift ~0.15 G.
  * model boxes (normalised to [0, 1]): 1e-4, i.e. 0.03 px at 288. The paths
    compared use other key orders, GEMM shapes and CPU vs GPU kernels
    through 12 blocks, 2 fusion layers and the head.
  * train step, GPU vs CPU (loss and grad norm 1e-3 rel; gradients, with G
    the global grad norm): all gradients together within 1e-2 G, each
    tensor within 5e-2 of its own norm + 1e-6 G, each element within 1e-1
    of its tensor's largest gradient + 1e-6 G. The bounds of
    tests/test_torch_port_train_step.py (the port against JAX on the CPU),
    where the reasons are written out: ReLU and MSDA's corner choice switch
    where an input crosses 0 or a pixel centre, so rounding flips a few
    switches; gradients that are exactly zero (conv biases before a BN) come
    out as rounding noise.
"""
from __future__ import annotations

import copy
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12         # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12             # f32 outside the tensor cores
H100_TF32X3_FLOPS = 495e12 / 3     # f32-accurate products as 3 TF32 MMAs (K1, K2)
H100_BF16_FLOPS = 989e12           # dense bf16 on the tensor cores (the bf16 kernels)
KERNEL_TOL = dict(atol=2e-5, rtol=1e-4)
BOX_TOL = 1e-4
MAX_DIFFERING = 0.01               # MSDA tap kernels' outputs not bit-equal to the plain version
SCRIPT, RECIPE = "asymmetric_shared_ce", "attention_lasher_newfusion_2layer"
# the recipe's backbone attention shapes: search lengths per block after CE
# at blocks 3/6/9 (keep 0.7): 4 blocks at 324, 3 at 227, 3 at 159, 2 at 112
CE_LENGTHS = ((324, 4), (227, 3), (159, 3), (112, 2))
N_MT = 128                         # 2 templates x 8x8 tokens per modality
B2, HEADS, HEAD_D = 2, 12, 64      # both modalities on the batch axis
TRAIN_B = 16                       # the recipe's batch; 2 x 16 on the batch axis
TRAIN_STEPS = 3                    # steps per epoch in the train phase
LIFE_STEPS = 2                     # steps (and val batches) per epoch in the lifecycle phase
#: steps of the epoch run at the training pace (train phases), the first
#: EPOCH_WARM of them untimed
EPOCH_STEPS = {torch.float32: 16, torch.bfloat16: 32}
EPOCH_WARM = 4
DATA_BATCHES = 9                   # batches of 16 compared native vs plain (train data phase)
LIFE_FRAMES = 16                   # frames tracked on the lifecycle's checkpoint
KEEP_FINAL = 240 / 324             # keep 0.7 bucketised to a multiple of 16
MSDA_SHAPES = ((18, 18), (18, 18))  # the fusion's two modal 18x18 maps
EVAL_SMALL, EVAL_BIG = 4, 12       # sequences per lockstep batch in the eval phase
EVAL_CHUNK = 16                    # frames per dispatch in the eval phase
#: synthetic_rgbt_hard's frames a sequence in the whole script's eval runs
#: (the eval, bf16, online, families, unimodal and cvt_convmae phases; the
#: eval.run CLIs read the registry's 60): 30 of 60, cut to make room for
#: the files phase
HARD_FRAMES = 30
#: frames of the 64 the large recipes (ViT-L, RGB-T ViT-L, and CvT-24 and
#: ConvMAE-L in `chip_smoke.py large`) track graphed against eager: 16 of
#: 63, a depth cut that makes room for the parallel phase
LARGE_TRACK = 17
EVAL_PX_TOL = 0.05                 # batched vs sequential trajectories, px
M_HEADS, M_D, M_L, M_P = 8, 64, 2, 4
# device kernel names of the bf16 attention kernels (csrc/mixed_attention_bf16.cu,
# csrc/mixed_attention_bwd_bf16.cu): the profiler's name filters
K1_BF16_KERNELS = ["mixed_attention_fwd_bf16_wgmma"]
K2_BF16_KERNELS = ["attn_bwd_dq_bf16_wgmma", "attn_bwd_dkdv_bf16_wgmma"]
# the wgmma kernels whose ptxas report must show no spill and no serialised
# wgmma chain (build phase): every kernel of the bf16 attention libraries,
# and the MSDA libraries' tap kernels
WGMMA_LIBS = ("mixed_attention_bf16", "mixed_attention_bwd_bf16", "msda", "msda_bwd")
WGMMA_KERNELS = {"msda": "tap_bf16", "msda_bwd": "tap_bf16"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, names=None, iters: int = 20, warmup: int = 3, sessions: int = 5) -> float:
    """Device time per call of fn from a torch.profiler trace of `iters`
    calls: the summed durations of the kernels whose names contain one of
    `names` (None: every kernel, copy and memset). Every fn timed here
    launches each such kernel the same number of times per call, so a
    session in which a kernel name's count is not a multiple of `iters`
    has lost events (CUPTI recorded nothing once on an SDPA session, one
    K1-bf16 launch of 20 once, and 5 K1 launches of 20 in each of three
    sessions in a row once): it is run again after a pause, up to
    `sessions` times. If none is whole, the time comes from the session
    that kept the most events: each kernel name's mean duration times its
    launches per call (its count over `iters`, rounded, at least 1), and a
    "profiler" line gives the count. It raises if no session traced any
    such event."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = {}
    for attempt in range(sessions):
        if attempt:
            time.sleep(0.2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for s, e, n in _device_intervals(prof):
            if names is None or any(k in n for k in names):
                by_name.setdefault(n, []).append(e - s)
        if by_name and all(len(ds) % iters == 0 for ds in by_name.values()):
            return sum(sum(ds) for ds in by_name.values()) / iters / 1e3
        if sum(map(len, by_name.values())) > sum(map(len, best.values())):
            best = by_name
    require(best, f"the profiler traced no device event for {names} in {sessions} sessions")
    emit({"phase": "profiler", "names": names, "calls": iters,
          "events": {n: len(ds) for n, ds in best.items()}, "sessions": sessions,
          "time": "per kernel name: mean duration x launches per call"})
    return sum(sum(ds) / len(ds) * max(1, round(len(ds) / iters))
               for ds in best.values()) / 1e3


def warm_profiler() -> None:
    """One short profiler session before any timing. The first session of
    a process starts CUPTI's tracing, and a timed first session has once
    recorded no kernel at all; later sessions record every kernel."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            x.mul_(1.0)
        torch.cuda.synchronize()
    emit({"phase": "profiler warm-up", "device_events": len(_device_intervals(prof))})


def bound_ms(n_bytes: float, flops: float, rate: float = H100_F32_FLOPS):
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, tol=KERNEL_TOL):
    """(max abs error, max rel error over |want| >= 1e-3, within tol)."""
    diff = (got - want).abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * want.abs()).all())
    big = want.abs() >= 1e-3
    return float(diff.max()), float((diff[big] / want.abs()[big]).max()), ok


def max_err_scaled(got, want):
    """K4's tolerance: 1e-5 of the output's largest magnitude, or 1e-4 rel."""
    return max_err(got, want, dict(atol=1e-5 * max(1.0, float(want.abs().max())), rtol=1e-4))


def _sum_rows(rows, weight_key):
    """Per-step or per-frame totals of per-launch numbers."""
    out = {}
    for key in ("ms", "event_ms", "plain_ms", "library_ms", "bytes", "flops", "dense_flops"):
        if all(r.get(key) is not None for r in rows):
            out[key] = sum(r[weight_key] * r[key] for r in rows)
    return out


# ------------------------------------------------------------------ phases
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs "
              "an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
               count=torch.cuda.device_count())
    emit({"phase": "device", "nvidia_smi": smi, **dev, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return dev, smi


def phase_bf16_reduction(smi: str) -> dict:
    """set_precision(bf16) turns cuBLAS's bf16 split-K reduction off. A bf16
    Linear weight gradient at the training shape (fc1: 3072 x 768 over
    K = 32 x 452 = 14,464 rows) against the same product accumulated in
    f32 and rounded once, with the flag as set_precision leaves it and
    with it on (PyTorch's default). With the flag off cuBLAS accumulates in
    f32 and rounds once, so it may differ from the reference only by the
    f32 summation order (whose absolute error grows with the sum of |terms|
    over K, not with each output): within one bf16 unit of the largest
    output; with the flag on the errors are printed beside it."""
    from multi_modal_tracking_torch.utils.device import set_precision
    set_precision(torch.bfloat16)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    require(flag is False, f"set_precision(bf16) left allow_bf16_reduced_precision_reduction "
                           f"= {flag}")
    g = torch.Generator().manual_seed(4)
    K = 2 * TRAIN_B * (N_MT + 324)
    x = torch.randn(K, 768, generator=g).cuda().to(torch.bfloat16)
    gr = torch.randn(K, 3072, generator=g).cuda().to(torch.bfloat16)
    want = (gr.float().t() @ x.float()).to(torch.bfloat16).float()
    unit = 2.0 ** -7 * float(want.abs().max())
    out = {}
    for on in (False, True):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on
        diff = ((gr.t() @ x).float() - want).abs()
        torch.cuda.synchronize()
        out["flag_on" if on else "flag_off"] = dict(
            max_abs_err=float(diff.max()), mean_abs_err=float(diff.mean()),
            max_err_over_top_unit=float(diff.max()) / unit,
            differing_share=float((diff > 0).float().mean()))
    set_precision(torch.bfloat16)
    err = out["flag_off"]["max_abs_err"]
    require(err <= unit, f"bf16 weight gradient with split-K reduction off: max abs err {err} "
                         f"> one bf16 unit of the largest output ({unit})")
    emit({"phase": "bf16 GEMM reduction", "card": smi, "shape": [3072, K, 768],
          "reference": "f32 accumulation, one rounding", "max_abs_reference": float(
              want.abs().max()), **out})
    return out


def phase_build():
    """Builds every kernel library (one nvcc per source, all at once) and
    prints each kernel's ptxas report; the wgmma kernels of K1-bf16 and
    K2-bf16 must spill nothing and keep their wgmma chains unserialised."""
    import threading
    from multi_modal_tracking_torch import native
    from multi_modal_tracking_torch.ops import _build
    host = {}

    def build_host():                       # g++ beside the nvcc processes
        t = time.perf_counter()
        try:
            native.library()
            native.image_library()
        except Exception as e:              # raised below, in this thread
            host["error"] = e
        host["seconds"] = time.perf_counter() - t

    g = threading.Thread(target=build_host)
    t0 = time.perf_counter()
    g.start()
    logs = _build.build()
    g.join()
    secs = time.perf_counter() - t0
    if "error" in host:
        raise host["error"]
    require(set(logs) >= {"mixed_attention", "mixed_attention_bf16", "mixed_attention_bwd",
                          "mixed_attention_bwd_bf16", "msda", "msda_bwd"},
            f"built {sorted(logs)}")
    for name in logs:                       # a library built earlier: its kept log
        if not logs[name]:
            with open(_build._lib_path(name)[:-3] + ".log") as f:
                logs[name] = f.read()
    reports = {name: ptxas_report(log) for name, log in logs.items()}
    wgmma = {name: [r for r in reports[name] if WGMMA_KERNELS.get(name, "") in r["function"]]
             for name in WGMMA_LIBS}
    require(all(wgmma.values()), f"no wgmma kernel found in a ptxas report: {wgmma}")
    bad = [r for rows in wgmma.values() for r in rows
           if r.get("spill_stores") or r.get("spill_loads") or r.get("wgmma_serialized")]
    require(not bad, f"wgmma kernels spill or serialise their wgmma chain: {bad}")
    emit({"phase": "build", "seconds": round(secs, 3),
          "host_library": {"sources": [os.path.relpath(src, os.path.dirname(
              os.path.abspath(__file__))) for src in (native.SOURCE, native.IMAGE_SOURCE)],
              "seconds": round(host["seconds"], 3), "flags": _build.HOST_FLAGS},
          "ptxas": reports,
          "wgmma_kernels": {name: [{k: r.get(k) for k in ("function", "registers", "spill_stores",
                                                           "spill_loads", "wgmma_serialized")}
                                   for r in rows] for name, rows in wgmma.items()}})


def ptxas_report(log: str) -> list:
    """Registers, spills and static shared memory of each kernel in an
    `nvcc -Xptxas -v` log, by (demangled) function name, and ptxas's reason
    where it serialised a kernel's wgmma instructions."""
    out, cur, serialized = [], None, {}
    for ln in log.splitlines():
        m = re.search(r"wgmma.mma_async instructions are serialized (.*) (?:for|in) the function "
                      r"'?([\w$]+)", ln)
        if m:
            serialized[m.group(2)] = m.group(1)
            continue
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", ln)
        if m and (cur is None or cur["function"] != m.group(1)):
            cur = dict(function=m.group(1))
            out.append(cur)
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(m.group(1)) if m else 0
    for r in out:
        if r["function"] in serialized:
            r["wgmma_serialized"] = serialized[r["function"]]
    names = [r["function"] for r in out]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        pass
    for r, name in zip(out, names):
        r["function"] = name.replace("(anonymous namespace)::", "").split("(")[0] \
            .replace("void ", "")
    return out


def _qkv(B, H, Nq, Nk, D, g):
    return (torch.randn(B, H, Nq, D, generator=g).cuda(),
            torch.randn(B, H, Nk, D, generator=g).cuda(),
            torch.randn(B, H, Nk, D, generator=g).cuda())


def _allowed(Nq, Nk, n_mt):
    rows = torch.arange(Nq, device="cuda")[:, None]
    cols = torch.arange(Nk, device="cuda")[None, :]
    return (rows >= n_mt) | (cols < n_mt)


def _pairs(Nq, Nk, n_mt):
    """Allowed (query, key) pairs of the mask."""
    return (Nq - n_mt) * Nk + n_mt * min(n_mt, Nk) if n_mt else Nq * Nk


def train_attention_lengths(keep):
    """(Nq, calls per training step) of the full forward at a keep rate:
    Nq = n_mt + the search tokens left at each block, Nk = Nq + n_mt."""
    from multi_modal_tracking_torch.models.asymmetric_shared import ce_keep_schedule
    keeps, _ = ce_keep_schedule(324, 12, (3, 6, 9), (0.7, 0.7, 0.7), keep)
    lengths, cur = [], 324
    for k in keeps:
        lengths.append(N_MT + cur)
        cur = k if k is not None else cur
    return [(n, lengths.count(n)) for n in sorted(set(lengths), reverse=True)]


def _attn_bounds(n_bytes, flops):
    """K1/K2 rows: the bound at the 3xTF32 rate and the f32 CUDA-core one."""
    b_ms, b_by = bound_ms(n_bytes, flops, H100_TF32X3_FLOPS)
    return dict(bound_ms=b_ms, bound_by=b_by, bound_f32_ms=bound_ms(n_bytes, flops)[0])


def kernel_k1(g):
    import torch.nn.functional as F
    from multi_modal_tracking_torch.ops.attention import (mixed_attention_fwd,
                                                          mixed_attention_lse_ref,
                                                          mixed_attention_ref)

    scale = HEAD_D ** -0.5
    # (form, batch, Nq, Nk, n_mt, calls per tracked frame, calls per training step)
    cases = [("template_step", B2, N_MT, N_MT, 0, 0, 0)]
    cases += [("search_step", B2, L, L + 2 * N_MT, 0, n, 0) for L, n in CE_LENGTHS]
    cases += [("full_forward", B2, N_MT + L, 2 * N_MT + L, N_MT, 0, 0) for L, _ in CE_LENGTHS]
    cases += [(f"search_step_b{n_seq}", 2 * n_seq, L, L + 2 * N_MT, 0, 0, 0)
              for n_seq in (EVAL_SMALL, EVAL_BIG) for L, _ in CE_LENGTHS]
    cases += [("train_forward", 2 * TRAIN_B, n, n + N_MT, N_MT, 0, c)
              for n, c in train_attention_lengths(KEEP_FINAL)]
    rows, err_max = [], 0.0
    for form, B, Nq, Nk, n_mt, calls, step_calls in cases:
        q, k, v = _qkv(B, HEADS, Nq, Nk, HEAD_D, g)
        with_lse = form == "train_forward"     # the training forward saves lse for K2
        got = mixed_attention_fwd(q, k, v, n_mt, scale, return_lse=with_lse)
        want = mixed_attention_ref(q, k, v, n_mt, scale)
        err, rel, ok = max_err(got[0] if with_lse else got, want)
        require(ok, f"K1 {form} Nq={Nq} Nk={Nk} n_mt={n_mt} disagrees with its plain "
                    f"version: max abs err {err}")
        lse_err = None
        if with_lse:
            lse_err, _, ok = max_err(got[1], mixed_attention_lse_ref(q, k, n_mt, scale))
            require(ok, f"K1 {form} Nq={Nq} Nk={Nk} n_mt={n_mt}: lse disagrees with "
                        f"mixed_attention_lse_ref: max abs err {lse_err}")
        err_max = max(err_max, err, lse_err or 0.0)
        mask = _allowed(Nq, Nk, n_mt)
        kern = lambda: mixed_attention_fwd(q, k, v, n_mt, scale, return_lse=with_lse)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,  # noqa: E731
                                                     scale=scale)
        n_bytes = 4 * B * HEADS * HEAD_D * (2 * Nq + 2 * Nk)
        flops = 4 * B * HEADS * HEAD_D * _pairs(Nq, Nk, n_mt)
        row = dict(form=form, B=B, Nq=Nq, Nk=Nk, n_mt=n_mt, calls_per_frame=calls,
                   calls_per_step=step_calls, max_abs_err=err, max_rel_err=rel,
                   lse_max_abs_err=lse_err,
                   ms=device_ms(kern, ["mixed_attention_fwd_kernel"]),
                   event_ms=cuda_time_ms(kern),
                   plain_ms=cuda_time_ms(lambda: mixed_attention_ref(q, k, v, n_mt, scale)),
                   library_ms=device_ms(lib), bytes=n_bytes, flops=flops,
                   **_attn_bounds(n_bytes, flops))
        row["library_ratio"] = row["ms"] / row["library_ms"]
        rows.append(row)
    emit({"phase": "kernels", "kernel": "K1 mixed_attention_fwd", "tolerance": KERNEL_TOL,
          "cases": rows})
    return rows, err_max


def kernel_k2(g):
    """K2 at the training shapes (B 2 x 16, H 12, D 64, n_mt 128): the no-CE
    length and the bucketised CE lengths at the final keep."""
    import torch.nn.functional as F
    from multi_modal_tracking_torch.ops.attention import (mixed_attention_bwd,
                                                          mixed_attention_bwd_ref,
                                                          mixed_attention_fwd)
    scale = HEAD_D ** -0.5
    B = 2 * TRAIN_B
    rows, err_max = [], 0.0
    for Nq, calls in train_attention_lengths(KEEP_FINAL):
        Nk, n_mt = Nq + N_MT, N_MT
        q, k, v = _qkv(B, HEADS, Nq, Nk, HEAD_D, g)
        gr = torch.randn(B, HEADS, Nq, HEAD_D, generator=g).cuda()
        o, lse = mixed_attention_fwd(q, k, v, n_mt, scale, return_lse=True)
        got = mixed_attention_bwd(q, k, v, o, gr, n_mt, scale, lse)
        want = mixed_attention_bwd_ref(q, k, v, gr, n_mt, scale)
        errs = [max_err(a, b) for a, b in zip(got, want)]
        require(all(e[2] for e in errs), f"K2 Nq={Nq} Nk={Nk} disagrees with its plain "
                                         f"version: max abs errs {[e[0] for e in errs]}")
        err = max(e[0] for e in errs)
        err_max = max(err_max, err)
        kern = lambda: mixed_attention_bwd(q, k, v, o, gr, n_mt, scale, lse)  # noqa: E731
        mask = _allowed(Nq, Nk, n_mt)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=scale)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), gr)
        n_bytes = 4 * B * HEADS * HEAD_D * (4 * Nq + 4 * Nk)
        flops = 10 * B * HEADS * HEAD_D * _pairs(Nq, Nk, n_mt)
        row = dict(B=B, Nq=Nq, Nk=Nk, n_mt=n_mt, calls_per_step=calls,
                   max_abs_err=err, max_abs_err_dq_dk_dv=[e[0] for e in errs],
                   max_rel_err=max(e[1] for e in errs), ms=device_ms(kern, ["attn_bwd_"]),
                   event_ms=cuda_time_ms(kern, iters=20),
                   plain_ms=cuda_time_ms(
                       lambda: mixed_attention_bwd_ref(q, k, v, gr, n_mt, scale), iters=10),
                   library_ms=device_ms(sdpa_fwd_bwd) - device_ms(sdpa_fwd),
                   bytes=n_bytes, flops=flops, **_attn_bounds(n_bytes, flops))
        row["library_ratio"] = row["ms"] / row["library_ms"]
        rows.append(row)
    emit({"phase": "kernels", "kernel": "K2 mixed_attention_bwd", "tolerance": KERNEL_TOL,
          "library": "scaled_dot_product_attention with the boolean mask: fwd+bwd minus fwd",
          "cases": rows})
    return rows, err_max


def _msda_inputs(B, shapes, Lq, M, D, P, g, lo=-0.2, hi=1.2):
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, M, D, generator=g).cuda()
    loc = (torch.rand(B, Lq, M, len(shapes), P, 2, generator=g) * (hi - lo) + lo).cuda()
    attw = torch.softmax(torch.randn(B, Lq, M, len(shapes) * P, generator=g), -1) \
        .reshape(B, Lq, M, len(shapes), P).cuda()
    return value, loc, attw


def _model_locations(B, shapes, M, P, g, noise=0.25):
    """Sampling locations as the fusion makes them (models/fusion.py): the
    reference point of each of the 2*H*W queries at its pixel centre, plus
    the directional grid-bias offsets of `_msda_grid_bias` (head m's
    direction times p + 1 pixels) and noise of `noise` pixels (normal), over
    equal levels. Corners cluster as in the model, unlike uniform
    locations."""
    from multi_modal_tracking_torch.models.fusion import _msda_grid_bias
    (H, W), L = shapes[0], len(shapes)
    require(all(s == (H, W) for s in shapes), f"model-like locations need equal levels: {shapes}")
    ys, xs = torch.meshgrid((torch.arange(H) + 0.5) / H, (torch.arange(W) + 0.5) / W,
                            indexing="ij")
    ref = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).repeat(2, 1)      # (2HW, 2)
    bias = torch.from_numpy(_msda_grid_bias(M, L, P)).reshape(M, L, P, 2)
    off = bias + noise * torch.randn(B, ref.shape[0], M, L, P, 2, generator=g)
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
    return (ref[None, :, None, None, None, :] + off / norm[:, None, :]).contiguous().cuda()


def _plan(value, shapes):
    from multi_modal_tracking_torch.ops.msda import msda_plan
    B, _, M, D = value.shape
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return msda_plan(B, M, D, shapes, n_sm)


def _live_corners(loc, shapes):
    """Corner taps inside their map: the work the data needs."""
    n = 0
    for lid, (H, W) in enumerate(shapes):
        x = torch.floor(loc[:, :, :, lid, :, 0] * W - 0.5)
        y = torch.floor(loc[:, :, :, lid, :, 1] * H - 0.5)
        n += sum(int(((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).sum())
                 for xi in (x, x + 1) for yi in (y, y + 1))
    return n


def kernel_k3(g):
    """K3 at the tracking (B 1, gather kernel), lockstep eval (B 4, gather;
    B 12, staged) and training (B 16, staged kernel) shapes, on uniform
    locations (the earlier cases, kept comparable) and model-like ones; at
    B 1 also the gather grid's launch floor (an empty kernel)."""
    from multi_modal_tracking_torch.ops import _build
    from multi_modal_tracking_torch.ops.msda import ms_deform_attn_fwd, ms_deform_attn_ref
    rows, err_max = [], 0.0
    S = Lq = 648
    want_plan = {EVAL_SMALL: "gather", EVAL_BIG: "staged"}
    for B in (1, EVAL_SMALL, EVAL_BIG, TRAIN_B):
        for locations in ("uniform", "model"):
            value, loc, attw = _msda_inputs(B, MSDA_SHAPES, Lq, M_HEADS, M_D, M_P, g, -0.1, 1.1)
            if locations == "model":
                loc = _model_locations(B, MSDA_SHAPES, M_HEADS, M_P, g)
            got = ms_deform_attn_fwd(value, MSDA_SHAPES, loc, attw)
            err, rel, ok = max_err(got, ms_deform_attn_ref(value, MSDA_SHAPES, loc, attw))
            require(ok, f"K3 B={B} {locations} disagrees with its plain version: "
                        f"max abs err {err}")
            err_max = max(err_max, err)
            kern = lambda: ms_deform_attn_fwd(value, MSDA_SHAPES, loc, attw)   # noqa: E731
            flops = 2.0 * M_D * _live_corners(loc, MSDA_SHAPES)
            n_bytes = 4 * (value.numel() + loc.numel() + attw.numel() + got.numel())
            b_ms, b_by = bound_ms(n_bytes, flops)
            plan = _plan(value, MSDA_SHAPES)
            require(plan.fwd == want_plan.get(B, plan.fwd),
                    f"K3 B={B}: msda_plan chose {plan.fwd}, the eval phase expects "
                    f"{want_plan.get(B)}")
            row = dict(B=B, S=S, Lq=Lq, M=M_HEADS, D=M_D, L=M_L, P=M_P, locations=locations,
                       path=plan.fwd, smem=plan.fwd_smem, max_abs_err=err, max_rel_err=rel,
                       ms=device_ms(kern, ["msda_fwd_kernel"]), event_ms=cuda_time_ms(kern),
                       plain_ms=cuda_time_ms(
                           lambda: ms_deform_attn_ref(value, MSDA_SHAPES, loc, attw), iters=10),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
                       flops=flops, calls_per_frame=2 if B == 1 else 0,
                       calls_per_step=2 if B == TRAIN_B else 0)
            if B == 1 and locations == "uniform":
                lib = _build.library("msda")
                stream = torch.cuda.current_stream().cuda_stream
                floor = lambda: _build.check(   # noqa: E731
                    lib.msda_launch_floor_f32(B, Lq, M_HEADS, stream), "msda_launch_floor_f32")
                row["launch_floor_ms"] = device_ms(floor, ["msda_launch_floor_kernel"])
                row["launch_floor_event_ms"] = cuda_time_ms(floor)
            rows.append(row)
    emit({"phase": "kernels", "kernel": "K3 ms_deform_attn_fwd", "tolerance": KERNEL_TOL,
          "cases": rows})
    return rows, err_max


def kernel_k4(g):
    """K4 at the training shape (uniform and model-like locations), at B 1
    and on three ragged levels. ms is the device time of the whole wrapper
    call (its kernels and any zero fill of dValue); zero_fill_ms is that of
    the zeros_like(value) the previous wrapper launched before its kernel."""
    from multi_modal_tracking_torch.ops.msda import ms_deform_attn_bwd, ms_deform_attn_bwd_ref
    rows, err_max = [], 0.0
    cases = [(TRAIN_B, MSDA_SHAPES, 648, M_HEADS, M_D, M_P, "uniform"),
             (TRAIN_B, MSDA_SHAPES, 648, M_HEADS, M_D, M_P, "model"),
             (1, MSDA_SHAPES, 648, M_HEADS, M_D, M_P, "uniform"),
             (2, ((6, 7), (5, 4), (3, 3)), 30, 4, 32, 4, "uniform")]
    for B, shapes, Lq, M, D, P, locations in cases:
        value, loc, attw = _msda_inputs(B, shapes, Lq, M, D, P, g)
        if locations == "model":
            loc = _model_locations(B, shapes, M, P, g)
        gr = torch.randn(B, Lq, M * D, generator=g).cuda()
        got = ms_deform_attn_bwd(value, shapes, loc, attw, gr)
        want = ms_deform_attn_bwd_ref(value, shapes, loc, attw, gr)
        errs = [max_err_scaled(a, b) for a, b in zip(got, want)]
        require(all(e[2] for e in errs), f"K4 {(B, shapes, Lq, M, D, P, locations)} disagrees "
                                         f"with its plain version: max abs errs "
                                         f"{[e[0] for e in errs]}")
        err = max(e[0] for e in errs)
        err_max = max(err_max, err)
        kern = lambda: ms_deform_attn_bwd(value, shapes, loc, attw, gr)   # noqa: E731
        live = _live_corners(loc, shapes)
        n_bytes = 4 * 2 * (value.numel() + loc.numel() + attw.numel()) + 4 * gr.numel()
        b_ms, b_by = bound_ms(n_bytes, 4.0 * D * live)
        plan = _plan(value, shapes)
        rows.append(dict(B=B, shapes=[list(s) for s in shapes], Lq=Lq, M=M, D=D, P=P,
                         locations=locations, path=list(plan.bwd), smem=plan.bwd_smem,
                         max_abs_err=err, max_abs_err_by_output=[e[0] for e in errs],
                         ms=device_ms(kern), kernels_ms=device_ms(kern, ["msda_bwd_kernel"]),
                         event_ms=cuda_time_ms(kern),
                         zero_fill_ms=device_ms(lambda: torch.zeros_like(value)),
                         plain_ms=cuda_time_ms(
                             lambda: ms_deform_attn_bwd_ref(value, shapes, loc, attw, gr),
                             iters=5, warmup=1),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
                         flops=4.0 * D * live, calls_per_step=2 if B == TRAIN_B else 0))
    emit({"phase": "kernels", "kernel": "K4 ms_deform_attn_bwd",
          "tolerance": "1e-5 of each output's largest magnitude, or 1e-4 rel", "cases": rows})
    return rows, err_max


#: elements of each group held CPU against card in the AdamW check (the CPU
#: plain version of all 104 M would take about a minute)
ADAMW_CPU_ELEMENTS = 1 << 21


def kernel_adamw():
    """The fused AdamW update (ops/adamw.py, csrc/adamw.cu) at the main
    path's shapes: every trainable parameter of the flagship recipe in the
    optimizer's regime groups (each with its own -lr), random gradients and
    moments made on the card from a seed, three updates (counts 1 to 3)
    from one state. The kernel must give the same bits as its plain version
    on the card, and as the plain version on the CPU for the first tensors
    of each group (ADAMW_CPU_ELEMENTS). Device ms (profiler) of one update,
    CUDA-event ms, the plain version's ms, and torch's own fused AdamW
    (`torch._fused_adamw_`, one call per group: the same update, rounded in
    its own order) as the library time; the bound is the bytes of 7 floats
    an element (15 operations an element at 67 TFLOP/s is far below)."""
    from multi_modal_tracking_torch.models.build import build_model
    from multi_modal_tracking_torch.ops.adamw import (B1, B2, EPS, AdamWTable, adamw_fused,
                                                      adamw_ref)
    from multi_modal_tracking_torch.train.optimizer import make_optimizer
    cfg = _train_cfg(TRAIN_B, 1)
    model = build_model(SCRIPT, cfg, device="cuda", seed=0)
    opt = make_optimizer(cfg, model)
    shapes = [[p.shape for p in ps] for ps in opt.groups.values()]
    mults, wd = list(opt.mults.values()), opt.weight_decay
    del model, opt
    gc_ = torch.Generator(device="cuda").manual_seed(7)

    def rand(s, scale, pos=False):
        x = torch.randn(s, device="cuda", generator=gc_) * scale
        return x.abs() if pos else x

    state = [tuple([rand(s, scale, i == 3) for s in ss]
                   for i, scale in enumerate((2e-2, 1e-2, 1e-3, 1e-5))) for ss in shapes]
    n = sum(s.numel() for ss in shapes for s in ss)
    neg_lr = torch.tensor([-1e-4 * m for m in mults], device="cuda")

    def copy(groups, dev="cuda", first=None):
        out = []
        for g in groups:
            k, total = 0, 0
            while k < len(g[0]) and (first is None or total < first):
                total += g[0][k].numel()
                k += 1
            out.append(tuple([t.to(dev, copy=True) for t in ts[:k]] for ts in g))
        return out

    def bc_of(count, dev="cuda"):
        return torch.tensor([1.0 - B1 ** count, 1.0 - B2 ** count], device=dev)

    def bits_differing(a, b):
        return sum(int((x.view(torch.int32) != y.to(x.device).view(torch.int32)).sum())
                   for ga, gb in zip(a, b) for ta, tb in zip(ga, gb) for x, y in zip(ta, tb))

    kern, plain = copy(state), copy(state)
    cpu_kern, cpu_plain = copy(state, first=ADAMW_CPU_ELEMENTS), \
        copy(state, "cpu", ADAMW_CPU_ELEMENTS)
    for count in (1, 2, 3):
        adamw_fused(kern, neg_lr, bc_of(count), wd)
        adamw_fused(cpu_kern, neg_lr, bc_of(count), wd)
        adamw_fused(cpu_plain, neg_lr.cpu(), bc_of(count, "cpu"), wd)
        for gi, (ps, gs, ms, vs) in enumerate(plain):
            adamw_ref(ps, gs, ms, vs, neg_lr[gi], bc_of(count)[0], bc_of(count)[1], wd)
    torch.cuda.synchronize()
    card, cpu = bits_differing(kern, plain), bits_differing(cpu_kern, cpu_plain)
    err = max(float((x - y).abs().max()) for ga, gb in zip(kern, plain)
              for ta, tb in zip(ga, gb) for x, y in zip(ta, tb))
    n_cpu = sum(t.numel() for g in cpu_plain for t in g[0])
    require(card == 0 and cpu == 0,
            f"AdamW kernel vs its plain version: {card} of {4 * n} values differ on the card, "
            f"{cpu} of {4 * n_cpu} against the CPU")
    table, bc = AdamWTable(kern), bc_of(3)
    update = lambda: adamw_fused(kern, neg_lr, bc, wd, table)   # noqa: E731

    def plain_update():
        for gi, (ps, gs, ms, vs) in enumerate(plain):
            adamw_ref(ps, gs, ms, vs, neg_lr[gi], bc[0], bc[1], wd)

    steps = [[torch.full((), 3.0, device="cuda") for _ in g[0]] for g in plain]

    def library():
        for (ps, gs, ms, vs), st, m in zip(plain, steps, mults):
            torch._fused_adamw_(ps, gs, ms, vs, [], st, lr=1e-4 * m, beta1=B1, beta2=B2,
                                weight_decay=wd, eps=EPS, amsgrad=False, maximize=False)

    n_bytes = 7 * 4 * n             # each parameter, gradient and moment read once, 3 written
    b_ms, b_by = bound_ms(n_bytes, 15.0 * n)
    ms, lib_ms = device_ms(update, ["adamw_f32_kernel"]), cuda_time_ms(library, iters=10)
    row = dict(name="adamw_f32 (AdamW)", route="cuda",
               source="multi_modal_tracking_torch/csrc/adamw.cu",
               replaces="multi_modal_tracking_tpu/train/optimizer.py:171", max_abs_err=err,
               ms=ms, event_ms=cuda_time_ms(update, iters=10),
               plain_ms=cuda_time_ms(plain_update, iters=5, warmup=1), library_ms=lib_ms,
               library_ratio=ms / lib_ms, bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b_ms,
               per="training step (one update)", parameters=n, groups=len(shapes),
               tensors=sum(len(ss) for ss in shapes), chunks=table.n_chunks,
               bits_equal_on_card=4 * n, bits_equal_against_cpu=4 * n_cpu)
    emit({"phase": "kernels", "kernel": "AdamW adamw_fused", "tolerance": "the same bits", **row})
    return row


# (B, H, Nq, Nk, D, n_mt) of K1/K2's edge cases: n_mt 0, inside a tile, = Nq =
# Nk; Nq != Nk; one query row, Nq 17 and 33 past 16-row tiles, Nk 9 inside a
# 32-key tile, n_mt 8 inside a 16-row tile, at D 16/32/64; the last one is
# large enough to take 64-row K1 blocks (the others take 16)
ATTN_EDGES = [(2, 3, 40, 64, 16, 8), (2, 2, 70, 100, 32, 37), (1, 2, 5, 7, 16, 5),
              (1, 2, 131, 197, 64, 65), (2, 3, 40, 40, 16, 40), (1, 2, 30, 70, 32, 0),
              (1, 2, 1, 9, 16, 0), (1, 2, 1, 9, 64, 8), (2, 3, 17, 9, 16, 8),
              (1, 2, 17, 33, 32, 8), (2, 2, 33, 9, 64, 8), (1, 3, 33, 41, 32, 33),
              (32, 12, 70, 100, 64, 37)]
# (B, spatial_shapes, Lq, M, D, P) of K3's edge cases, by msda_plan's path on
# 132 SMs: gather (generic L, P) at D 8 and 32; staged at D 16 with Lq 37
# (not a multiple of the 32 query warps), at D 128 (2*B*M >= 132) and at
# D 18 (rows staged in 4-byte pieces); the gather kernel's compiled L 2,
# P 4, D 64 form at a ragged Lq; one 32x32 level too large for shared
# memory at B 16 (gather)
MSDA_FWD_EDGES = [(2, ((9, 12), (5, 7)), 17, 2, 8, 3), (1, ((6, 7), (5, 4), (3, 3)), 30, 4, 32, 4),
                  (17, ((9, 12), (5, 7)), 37, 4, 16, 3), (9, ((10, 10), (5, 5)), 21, 8, 128, 4),
                  (17, ((5, 6), (3, 4)), 21, 4, 18, 4), (2, ((6, 6), (6, 6)), 50, 8, 64, 4),
                  (TRAIN_B, ((32, 32),), 40, 8, 64, 4)]
# K4's: D 16 with Lq 37; D 32 on three ragged levels with P 3; a 24x24
# level too large for shared memory beside a staged 18x18 one (both kernels
# in one call); D 128 with a 40x12 level (direct) and with P 5 (two groups
# of four points, staged); D 18 (staged, rows in 4-byte pieces); an odd D
# (direct: the staged kernel holds channel pairs)
MSDA_BWD_EDGES = [(2, ((9, 12), (5, 7)), 37, 4, 16, 4), (2, ((6, 7), (5, 4), (3, 3)), 30, 4, 32, 3),
                  (1, ((18, 18), (24, 24)), 50, 2, 64, 4), (1, ((40, 12),), 21, 2, 128, 2),
                  (1, ((10, 10), (5, 5)), 21, 2, 128, 5), (2, ((5, 6), (3, 4)), 21, 2, 18, 3),
                  (2, ((6, 6), (3, 3)), 13, 2, 33, 4)]


# (B, spatial_shapes, Lq, M, D, P) of K3-bf16's edge cases on 132 SMs: the
# tap kernel with P 2 on mixed levels at Lq 17, on three levels (two rows a
# thread) at Lq 130 (three query tiles, one a block), P 2 at B 16 (two
# tiles a block), one 21x21 level (7 tap blocks), tiny levels; the gather
# kernel where the tap kernel does not reach: five levels, P 5, 3 and 1 at
# D 64, D 8, 32, 16 and 128, and a 25x40 level at D 64 (too large)
MSDA_BF16_EDGES = [(2, ((9, 12), (5, 7)), 17, 2, 64, 2), (1, ((6, 7), (5, 4), (3, 3)), 130, 4, 64, 4),
                   (16, MSDA_SHAPES, 100, 8, 64, 2), (3, ((21, 21),), 70, 8, 64, 4),
                   (2, ((1, 1), (2, 3)), 9, 2, 64, 2), (1, ((3, 3),) * 5, 20, 2, 64, 4),
                   (2, MSDA_SHAPES, 30, 4, 64, 5), (2, ((9, 12), (5, 7)), 17, 2, 64, 3),
                   (1, ((6, 6), (3, 3)), 21, 2, 64, 1),
                   (2, ((9, 12), (5, 7)), 17, 2, 8, 3), (1, ((6, 7), (5, 4), (3, 3)), 30, 4, 32, 4),
                   (16, ((6, 7), (5, 4)), 37, 8, 16, 4), (1, ((9, 9), (4, 4)), 40, 8, 128, 4),
                   (2, ((25, 40),), 40, 8, 64, 4)]


def kernel_edges(g):
    """Narrow widths and ragged tiles for K1 (with its lse) and K2; every
    path of msda_plan for K3 and K4 at narrow and wide D, ragged levels and
    query counts, and levels too large for shared memory."""
    from multi_modal_tracking_torch.ops.attention import (mixed_attention_bwd,
                                                          mixed_attention_bwd_ref,
                                                          mixed_attention_fwd,
                                                          mixed_attention_lse_ref,
                                                          mixed_attention_ref)
    from multi_modal_tracking_torch.ops.msda import (ms_deform_attn_bwd, ms_deform_attn_bwd_ref,
                                                     ms_deform_attn_fwd, ms_deform_attn_ref)
    edge = []
    for (B, H, Nq, Nk, D, n_mt) in ATTN_EDGES:
        q, k, v = _qkv(B, H, Nq, Nk, D, g)
        gr = torch.randn(B, H, Nq, D, generator=g).cuda()
        o_only = mixed_attention_fwd(q, k, v, n_mt, D ** -0.5)
        o, lse = mixed_attention_fwd(q, k, v, n_mt, D ** -0.5, return_lse=True)
        require(torch.equal(o, o_only), f"K1 edge case {(B, H, Nq, Nk, D, n_mt)}: output "
                                        f"depends on whether lse is written")
        err, _, ok = max_err(o, mixed_attention_ref(q, k, v, n_mt, D ** -0.5))
        require(ok, f"K1 edge case {(B, H, Nq, Nk, D, n_mt)}: max abs err {err}")
        lse_err, _, ok = max_err(lse, mixed_attention_lse_ref(q, k, n_mt, D ** -0.5))
        require(ok, f"K1 edge case {(B, H, Nq, Nk, D, n_mt)}: lse max abs err {lse_err}")
        edge.append(dict(kernel="K1", shape=[B, H, Nq, Nk, D, n_mt], max_abs_err=err,
                         lse_max_abs_err=lse_err))
        errs = [max_err(a, b) for a, b in zip(
            mixed_attention_bwd(q, k, v, o, gr, n_mt, D ** -0.5, lse),
            mixed_attention_bwd_ref(q, k, v, gr, n_mt, D ** -0.5))]
        require(all(e[2] for e in errs), f"K2 edge case {(B, H, Nq, Nk, D, n_mt)}: "
                                         f"max abs errs {[e[0] for e in errs]}")
        edge.append(dict(kernel="K2", shape=[B, H, Nq, Nk, D, n_mt],
                         max_abs_err=max(e[0] for e in errs)))
    for (B, shp, Lq, M, D, P) in MSDA_FWD_EDGES:
        value, loc, attw = _msda_inputs(B, shp, Lq, M, D, P, g)
        err, _, ok = max_err(ms_deform_attn_fwd(value, shp, loc, attw),
                             ms_deform_attn_ref(value, shp, loc, attw))
        path = _plan(value, shp).fwd
        require(ok, f"K3 edge case {(B, shp, Lq, M, D, P)} ({path}): max abs err {err}")
        edge.append(dict(kernel="K3", shape=[B, shp, Lq, M, D, P], path=path, max_abs_err=err))
    for (B, shp, Lq, M, D, P) in MSDA_BWD_EDGES:
        value, loc, attw = _msda_inputs(B, shp, Lq, M, D, P, g)
        gr = torch.randn(B, Lq, M * D, generator=g).cuda()
        errs = [max_err_scaled(a, b) for a, b in zip(
            ms_deform_attn_bwd(value, shp, loc, attw, gr),
            ms_deform_attn_bwd_ref(value, shp, loc, attw, gr))]
        path = list(_plan(value, shp).bwd)
        require(all(e[2] for e in errs), f"K4 edge case {(B, shp, Lq, M, D, P)} ({path}): "
                                         f"max abs errs {[e[0] for e in errs]}")
        edge.append(dict(kernel="K4", shape=[B, shp, Lq, M, D, P], path=path,
                         max_abs_err=max(e[0] for e in errs)))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel": "edge cases", "cases": edge})
    return edge


def phase_kernels(g: torch.Generator) -> dict:
    """Every kernel against its plain version; per-frame (K1, K3: the
    tracked frame's launches) and per-step (K2, K4: a training step at the
    final keep) totals for the kernel table."""
    k1_rows, k1_err = kernel_k1(g)
    k2_rows, k2_err = kernel_k2(g)
    k3_rows, k3_err = kernel_k3(g)
    k4_rows, k4_err = kernel_k4(g)
    edges = kernel_edges(g)
    fwd_paths = {r["path"] for r in k3_rows} | {e["path"] for e in edges if e["kernel"] == "K3"}
    bwd_paths = {p for r in k4_rows for p in r["path"]} | {
        p for e in edges if e["kernel"] == "K4" for p in e["path"]}
    require(fwd_paths == {"staged", "gather"} and bwd_paths == {"staged", "direct"},
            f"msda_plan paths checked: K3 {fwd_paths}, K4 {bwd_paths}")
    table = {}
    for key, name, src, repl, rows, err, weight in (
            ("K1", "mixed_attention_fwd (K1)", "mixed_attention.cu", "attention.py:44",
             k1_rows, k1_err, "calls_per_frame"),
            ("K2", "mixed_attention_bwd (K2)", "mixed_attention_bwd.cu", "attention.py:91",
             k2_rows, k2_err, "calls_per_step"),
            ("K3", "msda_fwd (K3)", "msda.cu", "msda.py:171", k3_rows, k3_err,
             "calls_per_frame"),
            ("K4", "msda_bwd (K4)", "msda_bwd.cu", "msda.py:301", k4_rows, k4_err,
             "calls_per_step")):
        tot = _sum_rows([r for r in rows if r.get("locations", "uniform") == "uniform"], weight)
        if key in ("K1", "K2"):
            bounds = _attn_bounds(tot["bytes"], tot["flops"])
        else:
            b_ms, b_by = bound_ms(tot["bytes"], tot["flops"])
            bounds = dict(bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b_ms)
        lib_ms = tot.get("library_ms")
        table[key] = dict(name=name, route="cuda", source=f"multi_modal_tracking_torch/csrc/{src}",
                          replaces=f"multi_modal_tracking_tpu/ops/{repl}", max_abs_err=err,
                          ms=tot["ms"], event_ms=tot["event_ms"], plain_ms=tot["plain_ms"],
                          library_ms=lib_ms, library_ratio=tot["ms"] / lib_ms if lib_ms else None,
                          per="tracked frame" if weight == "calls_per_frame" else "training step",
                          **bounds)
    # K1 and K3 also run in every training step: their device ms and bound
    # per step; K3 and K4 on model-like locations beside the uniform ones
    k1_step = _sum_rows(k1_rows, "calls_per_step")
    table["K1"]["train_step_ms"] = k1_step["ms"]
    table["K1"]["train_step_bound_ms"] = _attn_bounds(k1_step["bytes"], k1_step["flops"])["bound_ms"]
    table["K1"]["train_step_library_ms"] = k1_step["library_ms"]
    k3_step = _sum_rows([r for r in k3_rows if r["locations"] == "uniform"], "calls_per_step")
    model = [r for r in k3_rows if r["locations"] == "model"]
    table["K3"]["train_step_ms"] = k3_step["ms"]
    table["K3"]["train_step_bound_ms"] = bound_ms(k3_step["bytes"], k3_step["flops"])[0]
    table["K3"]["model_locations_ms"] = _sum_rows(model, "calls_per_frame")["ms"]
    table["K3"]["model_locations_train_step_ms"] = _sum_rows(model, "calls_per_step")["ms"]
    table["K4"]["model_locations_ms"] = _sum_rows(
        [r for r in k4_rows if r["locations"] == "model"], "calls_per_step")["ms"]
    table.update(_bf16_table_rows(kernel_k1_bf16(g), kernel_k3_bf16(g), kernel_edges_bf16(g)))
    table.update(_bf16_bwd_table_rows(kernel_k2_bf16(g), kernel_k4_bf16(g),
                                      kernel_edges_bf16_bwd(g)))
    table["AdamW"] = kernel_adamw()
    k1, k2 = table["K1-bf16"], table["K2-bf16"]
    kern_ms = k1["train_step_ms"] + k2["ms"]
    sdpa_ms = k1["train_step_library_ms"] + k2["library_ms"]
    emit({"phase": "kernels", "bf16 attention per training step": dict(
        k1_bf16_ms=k1["train_step_ms"], k2_bf16_ms=k2["ms"], kernels_ms=kern_ms,
        sdpa_fwd_ms=k1["train_step_library_ms"], sdpa_bwd_ms=k2["library_ms"],
        sdpa_fwd_bwd_ms=sdpa_ms, ratio=kern_ms / sdpa_ms,
        note="device ms per bf16 training step at the final keep (12 calls each); SDPA's "
             "backward is its fwd+bwd minus its fwd")})
    return table


# ------------------------------------------------------------ bf16 kernels
def bf16_tol(v: torch.Tensor) -> dict:
    """The bf16 kernels' tolerance against their plain versions: 2^-8 of the
    largest |value| plus one bf16 unit (2^-7) of the output. Each side
    rounds its probabilities or tap weights to bf16 (2^-9 of each term, so
    at most 2^-9 of max|V| per side in the weighted sum; K1-bf16 rounds at
    another point, exp(s - running max) before the division by the row
    sum) and then its output (half a unit each). A wrong mask, tap or tile gives errors of order
    1e-1."""
    return dict(atol=2.0 ** -8 * float(v.abs().max()), rtol=2.0 ** -7)


def _bf16_errors(what: str, got, plain, f32, v, exact: bool = False) -> dict:
    """Kernel against its plain version (bf16_tol), and each against the
    f32 answer on the same inputs: the kernel's error may be at most 1.25x
    the plain version's. `exact` (the MSDA kernels, which round where the
    plain version rounds): at most MAX_DIFFERING of the outputs may differ
    from the plain version's bits."""
    err, rel, ok = max_err(got.float(), plain.float(), bf16_tol(v))
    require(ok, f"{what} disagrees with its plain version: max abs err {err}")
    e_kern = float((got.float() - f32).abs().max())
    e_plain = float((plain.float() - f32).abs().max())
    require(e_kern <= 1.25 * e_plain, f"{what}: error against f32 {e_kern} > 1.25 x the plain "
                                      f"version's {e_plain}")
    share = float((got != plain).float().mean())
    require(not exact or share <= MAX_DIFFERING,
            f"{what}: {share} of the outputs differ from the plain version (> {MAX_DIFFERING})")
    return dict(max_abs_err=err, max_rel_err=rel, tol_atol=bf16_tol(v)["atol"],
                differing_share=share, f32_err=e_kern, plain_f32_err=e_plain,
                f32_err_ratio=e_kern / e_plain)


def kernel_k1_bf16(g):
    """K1-bf16 at the bf16 tracker's shapes (template step; search steps at
    the CE lengths, 12 per frame), at the lockstep N = 12 shapes (batch
    24) and at the bf16 training forward's (batch 2 x 16 at the final
    keep's CE lengths, writing the lse K2-bf16 reads), against its plain
    version and the f32 answer; SDPA at bf16 with the boolean mask as the
    library yardstick."""
    import torch.nn.functional as F
    from multi_modal_tracking_torch.ops.attention import (attention_bf16_plan,
                                                          mixed_attention_bf16,
                                                          mixed_attention_bf16_ref,
                                                          mixed_attention_ref)
    scale = HEAD_D ** -0.5
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [("template_step", B2, N_MT, N_MT, 0, 0, 0, 0)]
    cases += [("search_step", B2, L, L + 2 * N_MT, 0, n, 0, 0) for L, n in CE_LENGTHS]
    cases += [(f"search_step_b{EVAL_BIG}", 2 * EVAL_BIG, L, L + 2 * N_MT, 0, 0, n, 0)
              for L, n in CE_LENGTHS]
    cases += [("train_forward", 2 * TRAIN_B, n, n + N_MT, N_MT, 0, 0, c)
              for n, c in train_attention_lengths(KEEP_FINAL)]
    rows = []
    for form, B, Nq, Nk, n_mt, calls, step_calls, train_calls in cases:
        q, k, v = (t.to(torch.bfloat16) for t in _qkv(B, HEADS, Nq, Nk, HEAD_D, g))
        with_lse = form == "train_forward"
        got = mixed_attention_bf16(q, k, v, n_mt, scale)
        plain = mixed_attention_bf16_ref(q, k, v, n_mt, scale)
        f32 = mixed_attention_ref(q.float(), k.float(), v.float(), n_mt, scale)
        errs = _bf16_errors(f"K1-bf16 {form} Nq={Nq} Nk={Nk}", got, plain, f32, v)
        # key shares: split at the tracking shapes (B*H 24), one share where
        # the blocks fill the card (training, lockstep N = 12)
        splits = attention_bf16_plan(B * HEADS, Nq, Nk, n_sm)
        require(splits > 1 if B == B2 else splits == 1,
                f"K1-bf16 {form} B*H={B * HEADS} Nq={Nq}: attention_bf16_plan chose {splits} "
                f"key shares")
        mask = _allowed(Nq, Nk, n_mt)
        kern = lambda: mixed_attention_bf16(q, k, v, n_mt, scale,  # noqa: E731
                                            return_lse=with_lse)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,  # noqa: E731
                                                     scale=scale)
        n_bytes = 2 * B * HEADS * HEAD_D * (2 * Nq + 2 * Nk) + (4 * B * HEADS * Nq if with_lse
                                                                 else 0)
        flops = 4 * B * HEADS * HEAD_D * _pairs(Nq, Nk, n_mt)
        b_ms, b_by = bound_ms(n_bytes, flops, H100_BF16_FLOPS)
        row = dict(form=form, B=B, Nq=Nq, Nk=Nk, n_mt=n_mt, calls_per_frame=calls,
                   calls_per_lockstep_step=step_calls, calls_per_step=train_calls, splits=splits,
                   **errs, ms=device_ms(kern, K1_BF16_KERNELS),
                   event_ms=cuda_time_ms(kern),
                   plain_ms=cuda_time_ms(lambda: mixed_attention_bf16_ref(q, k, v, n_mt, scale)),
                   library_ms=device_ms(lib), bytes=n_bytes, flops=flops, bound_ms=b_ms,
                   bound_by=b_by)
        row["library_ratio"] = row["ms"] / row["library_ms"]
        rows.append(row)
    emit({"phase": "kernels", "kernel": "K1-bf16 mixed_attention_bf16",
          "tolerance": "atol 2^-8 max|V|, rtol 2^-7; error against f32 <= 1.25 x plain's",
          "library": "scaled_dot_product_attention at bf16 with the boolean mask",
          "cases": rows})
    return rows


def _plan_bf16(B, M, D, shapes, Lq, P):
    from multi_modal_tracking_torch.ops.msda import msda_plan
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return msda_plan(B, M, D, shapes, n_sm, itemsize=2, Lq=Lq, P=P)


def _tap_fwd_flops(B, M, D, shapes, Lq) -> float:
    """The dense products K3-bf16's tap kernel runs: per (b, m) and query
    tile of 64 rows, each level's tap tile (its pixels rounded up to 32)
    times V_l, the two warpgroups the same count (the larger level's): its
    tensor-core floor at 989 TFLOP/s beside the bound."""
    slices = max(-(-h * w // 32) * 32 for h, w in shapes)
    return 2.0 * B * M * -(-Lq // 64) * 64 * 2 * -(-len(shapes) // 2) * slices * D


def _tap_bwd_flops(B, M, D, shapes, Lq, path) -> float:
    """K4-bf16's tap kernel: per (b, m, tap level) and query tile, A^T g and
    g V^T over its six 64-pixel blocks."""
    from multi_modal_tracking_torch.ops.msda import TAP_BWD_MAX_BLOCKS
    levels = sum(1 for p in path if p == "tap")
    return 2 * 2.0 * B * M * -(-Lq // 64) * 64 * 64 * TAP_BWD_MAX_BLOCKS * levels * D


def kernel_k3_bf16(g):
    """K3-bf16 at the bf16 tracker's shape (B 1: one query tile a block),
    the lockstep eval's (B 4: three tiles a block; B 12) and the training
    batch's (B 16), on uniform and model-like locations, against its plain
    version and the f32 answer; msda_plan's tap kernel required, and at
    most MAX_DIFFERING of the outputs not bit-equal to the plain version."""
    from multi_modal_tracking_torch.ops.msda import (ms_deform_attn_bf16,
                                                     ms_deform_attn_bf16_ref, ms_deform_attn_ref)
    rows = []
    Lq = 648
    for B in (1, EVAL_SMALL, EVAL_BIG, TRAIN_B):
        for locations in ("uniform", "model"):
            value, loc, attw = _msda_inputs(B, MSDA_SHAPES, Lq, M_HEADS, M_D, M_P, g, -0.1, 1.1)
            if locations == "model":
                loc = _model_locations(B, MSDA_SHAPES, M_HEADS, M_P, g)
            value, attw = value.to(torch.bfloat16), attw.to(torch.bfloat16)
            got = ms_deform_attn_bf16(value, MSDA_SHAPES, loc, attw)
            plain = ms_deform_attn_bf16_ref(value, MSDA_SHAPES, loc, attw)
            f32 = ms_deform_attn_ref(value.float(), MSDA_SHAPES, loc, attw.float())
            errs = _bf16_errors(f"K3-bf16 B={B} {locations}", got, plain, f32, value, exact=True)
            plan = _plan_bf16(B, M_HEADS, M_D, MSDA_SHAPES, Lq, M_P)
            require(plan.fwd == "tap", f"K3-bf16 B={B}: msda_plan chose {plan.fwd}, not tap")
            kern = lambda: ms_deform_attn_bf16(value, MSDA_SHAPES, loc, attw)   # noqa: E731
            flops = 2.0 * M_D * _live_corners(loc, MSDA_SHAPES)
            n_bytes = 2 * (value.numel() + attw.numel() + got.numel()) + 4 * loc.numel()
            b_ms, b_by = bound_ms(n_bytes, flops, H100_BF16_FLOPS)
            dense = _tap_fwd_flops(B, M_HEADS, M_D, MSDA_SHAPES, Lq)
            rows.append(dict(B=B, Lq=Lq, locations=locations, path=plan.fwd, smem=plan.fwd_smem,
                             tiles_per_block=plan.fwd_tiles, **errs,
                             ms=device_ms(kern, ["msda_fwd_kernel"]),
                             event_ms=cuda_time_ms(kern),
                             plain_ms=cuda_time_ms(lambda: ms_deform_attn_bf16_ref(
                                 value, MSDA_SHAPES, loc, attw), iters=10),
                             library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
                             flops=flops, dense_flops=dense,
                             dense_floor_ms=dense / H100_BF16_FLOPS * 1e3,
                             calls_per_frame=2 if B == 1 else 0,
                             calls_per_lockstep_step=2 if B == EVAL_BIG else 0,
                             calls_per_step=2 if B == TRAIN_B else 0))
    emit({"phase": "kernels", "kernel": "K3-bf16 ms_deform_attn_bf16",
          "tolerance": "atol 2^-8 max|V|, rtol 2^-7; error against f32 <= 1.25 x plain's; "
                       f"at most {MAX_DIFFERING} of the outputs not bit-equal to plain's",
          "dense_floor": "the tap kernel's dense products at 989 TFLOP/s", "cases": rows})
    return rows


# (B, H, Nq, Nk, D, n_mt) on which K1-bf16 runs with every key-share count
# (the plan gives one count per shape): D 16, 32 and 64, n_mt inside a
# share, ragged shares and row tiles, template-only row tiles
K1_SPLIT_EDGES = [(2, 3, 70, 300, 16, 37), (1, 2, 131, 197, 32, 65),
                  (2, 2, 100, 260, 64, 130), (2, 3, 17, 200, 32, 8)]


def _k1_bf16_shares(q, k, v, n_mt, scale, splits):
    """K1-bf16's C entry point with a chosen number of key shares (the
    wrapper takes attention_bf16_plan's): (out, lse). Not counted as a
    launch of the main path."""
    from multi_modal_tracking_torch.ops import _build
    B, H, Nq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Nq, dtype=torch.float32, device=q.device)
    err = _build.library("mixed_attention_bf16").mixed_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), B * H, Nq,
        k.shape[2], D, n_mt, scale, splits, torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"mixed_attention_fwd_bf16 with {splits} key shares")
    return out, lse


def kernel_edges_bf16(g):
    """K1-bf16 on ATTN_EDGES (D 16/32/64, ragged tiles, n_mt 0, Nq != Nk)
    and on K1_SPLIT_EDGES with 1 to BF16_MAX_SPLITS key shares each (lse
    included); K3-bf16 on both paths of msda_plan (MSDA_BF16_EDGES): the
    tap kernel at P 2 and 4, one to three levels, ragged query tiles and
    the query split, the gather kernel at D 8 to 128, P 1, 3 and 5, five
    levels and a level too large for the tap kernel."""
    from multi_modal_tracking_torch.ops.attention import (BF16_MAX_SPLITS, mixed_attention_bf16,
                                                          mixed_attention_bf16_lse_ref,
                                                          mixed_attention_bf16_ref,
                                                          mixed_attention_ref)
    from multi_modal_tracking_torch.ops.msda import (ms_deform_attn_bf16,
                                                     ms_deform_attn_bf16_ref, ms_deform_attn_ref)
    edge = []
    for (B, H, Nq, Nk, D, n_mt) in ATTN_EDGES:
        q, k, v = (t.to(torch.bfloat16) for t in _qkv(B, H, Nq, Nk, D, g))
        errs = _bf16_errors(f"K1-bf16 edge case {(B, H, Nq, Nk, D, n_mt)}",
                            mixed_attention_bf16(q, k, v, n_mt, D ** -0.5),
                            mixed_attention_bf16_ref(q, k, v, n_mt, D ** -0.5),
                            mixed_attention_ref(q.float(), k.float(), v.float(), n_mt,
                                                D ** -0.5), v)
        edge.append(dict(kernel="K1-bf16", shape=[B, H, Nq, Nk, D, n_mt], **errs))
    for (B, H, Nq, Nk, D, n_mt) in K1_SPLIT_EDGES:
        q, k, v = (t.to(torch.bfloat16) for t in _qkv(B, H, Nq, Nk, D, g))
        plain = mixed_attention_bf16_ref(q, k, v, n_mt, D ** -0.5)
        f32 = mixed_attention_ref(q.float(), k.float(), v.float(), n_mt, D ** -0.5)
        lse_ref = mixed_attention_bf16_lse_ref(q, k, n_mt, D ** -0.5)
        for splits in range(1, BF16_MAX_SPLITS + 1):
            what = f"K1-bf16 edge case {(B, H, Nq, Nk, D, n_mt)} with {splits} key shares"
            out, lse = _k1_bf16_shares(q, k, v, n_mt, D ** -0.5, splits)
            errs = _bf16_errors(what, out, plain, f32, v)
            lse_err, _, ok = max_err(lse, lse_ref)
            require(ok, f"{what}: lse max abs err {lse_err}")
            edge.append(dict(kernel="K1-bf16", shape=[B, H, Nq, Nk, D, n_mt], splits=splits,
                             lse_max_abs_err=lse_err, **errs))
    paths = set()
    for (B, shp, Lq, M, D, P) in MSDA_BF16_EDGES:
        value, loc, attw = _msda_inputs(B, shp, Lq, M, D, P, g)
        value, attw = value.to(torch.bfloat16), attw.to(torch.bfloat16)
        plan = _plan_bf16(B, M, D, shp, Lq, P)
        paths.add(plan.fwd)
        errs = _bf16_errors(f"K3-bf16 edge case {(B, shp, Lq, M, D, P)} ({plan.fwd})",
                            ms_deform_attn_bf16(value, shp, loc, attw),
                            ms_deform_attn_bf16_ref(value, shp, loc, attw),
                            ms_deform_attn_ref(value.float(), shp, loc, attw.float()), value,
                            exact=True)
        edge.append(dict(kernel="K3-bf16", shape=[B, shp, Lq, M, D, P], path=plan.fwd,
                         tiles_per_block=plan.fwd_tiles, **errs))
    require(paths == {"tap", "gather"}, f"K3-bf16 edge cases cover {paths}")
    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel": "bf16 edge cases", "cases": edge})
    return edge


def _k2_bf16_case(q, k, v, gr, n_mt, scale):
    """K2-bf16 with K1-bf16's lse, against its plain version and the f32 K2
    (K1 + K2 on the same bf16-exact inputs, as f32): (outputs, plain, f32,
    lse error, lse). A second call on the same input must give the same
    bits (no atomics: the lifecycle phase resumes training bit for bit)."""
    from multi_modal_tracking_torch.ops.attention import (
        mixed_attention_bf16, mixed_attention_bf16_lse_ref, mixed_attention_bwd,
        mixed_attention_bwd_bf16, mixed_attention_bwd_bf16_ref, mixed_attention_fwd)
    o, lse = mixed_attention_bf16(q, k, v, n_mt, scale, return_lse=True)
    require(torch.equal(o, mixed_attention_bf16(q, k, v, n_mt, scale)),
            f"K1-bf16 {tuple(q.shape)} n_mt={n_mt}: output depends on whether lse is written")
    lse_err, _, ok = max_err(lse, mixed_attention_bf16_lse_ref(q, k, n_mt, scale))
    require(ok, f"K1-bf16 {tuple(q.shape)} n_mt={n_mt}: lse max abs err {lse_err}")
    got = mixed_attention_bwd_bf16(q, k, v, gr, n_mt, scale, lse)
    again = mixed_attention_bwd_bf16(q, k, v, gr, n_mt, scale, lse)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"K2-bf16 {tuple(q.shape)} n_mt={n_mt}: two calls on one input differ")
    plain = mixed_attention_bwd_bf16_ref(q, k, v, gr, n_mt, scale)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, gr))
    of, lf = mixed_attention_fwd(qf, kf, vf, n_mt, scale, return_lse=True)
    f32 = mixed_attention_bwd(qf, kf, vf, of, gf, n_mt, scale, lf)
    return got, plain, f32, lse_err, lse


def _k2_bf16_errors(what, got, plain, f32) -> dict:
    """Each of dq, dk, dv against its plain version (bf16_tol of the plain
    output) and against the f32 K2: every ratio of the kernel's f32 error
    to the plain version's must be <= 1.25."""
    errs, ratios = [], []
    for name, x, p, f in zip(("dq", "dk", "dv"), got, plain, f32):
        err, _, ok = max_err(x.float(), p.float(), bf16_tol(p))
        require(ok, f"{what} {name} disagrees with its plain version: {err}")
        e_k, e_p = float((x.float() - f).abs().max()), float((p.float() - f).abs().max())
        errs.append(err)
        ratios.append(e_k / e_p)
    require(max(ratios) <= 1.25, f"{what}: error against the f32 K2 "
                                 f"{ratios} x the plain version's (> 1.25)")
    return dict(max_abs_err=max(errs), max_abs_err_dq_dk_dv=errs,
                f32_err_ratio_dq_dk_dv=ratios, f32_err_ratio=max(ratios),
                plain_f32_err_dq_dk_dv=[float((p.float() - f).abs().max())
                                        for p, f in zip(plain, f32)])


def kernel_k2_bf16(g):
    """K2-bf16 at the training shapes (B 2 x 16, H 12, D 64, n_mt 128) at keep
    1.0 and at the bucketised CE lengths of the final keep, with K1-bf16's
    lse, against the plain version and the f32 K2; SDPA at bf16 (fwd+bwd
    minus fwd) as the library time. The bound counts q, k, v, g, dq, dk, dv
    and the lse: the kernel sums Delta from P and dP and reads no o."""
    import torch.nn.functional as F
    from multi_modal_tracking_torch.ops.attention import (mixed_attention_bwd_bf16,
                                                          mixed_attention_bwd_bf16_ref)
    scale = HEAD_D ** -0.5
    B = 2 * TRAIN_B
    rows = []
    lengths = [(n, c, 1.0) for n, c in train_attention_lengths(1.0)]
    lengths += [(n, c, KEEP_FINAL) for n, c in train_attention_lengths(KEEP_FINAL)]
    for Nq, calls, keep in lengths:
        Nk, n_mt = Nq + N_MT, N_MT
        q, k, v = (t.to(torch.bfloat16) for t in _qkv(B, HEADS, Nq, Nk, HEAD_D, g))
        gr = torch.randn(B, HEADS, Nq, HEAD_D, generator=g).cuda().to(torch.bfloat16)
        got, plain, f32, lse_err, lse = _k2_bf16_case(q, k, v, gr, n_mt, scale)
        errs = _k2_bf16_errors(f"K2-bf16 Nq={Nq} Nk={Nk}", got, plain, f32)
        mask = _allowed(Nq, Nk, n_mt)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=scale)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), gr)
        n_bytes = 2 * B * HEADS * HEAD_D * (3 * Nq + 4 * Nk) + 4 * B * HEADS * Nq
        flops = 10 * B * HEADS * HEAD_D * _pairs(Nq, Nk, n_mt)
        b_ms, b_by = bound_ms(n_bytes, flops, H100_BF16_FLOPS)
        kern = lambda: mixed_attention_bwd_bf16(q, k, v, gr, n_mt, scale, lse)  # noqa: E731
        row = dict(B=B, Nq=Nq, Nk=Nk, n_mt=n_mt, keep=keep,
                   calls_per_step=calls if keep == KEEP_FINAL else 0, lse_max_abs_err=lse_err,
                   **errs, ms=device_ms(kern, K2_BF16_KERNELS),
                   event_ms=cuda_time_ms(kern, iters=20),
                   plain_ms=cuda_time_ms(
                       lambda: mixed_attention_bwd_bf16_ref(q, k, v, gr, n_mt, scale), iters=5),
                   library_ms=device_ms(sdpa_fwd_bwd) - device_ms(sdpa_fwd),
                   bytes=n_bytes, flops=flops, bound_ms=b_ms, bound_by=b_by)
        row["library_ratio"] = row["ms"] / row["library_ms"]
        rows.append(row)
    emit({"phase": "kernels", "kernel": "K2-bf16 mixed_attention_bwd_bf16",
          "tolerance": "bf16_tol of each plain output; error against the f32 K2 <= 1.25 x "
                       "the plain version's",
          "library": "scaled_dot_product_attention at bf16 with the boolean mask: fwd+bwd "
                     "minus fwd", "cases": rows})
    return rows


def _k4_bf16_case(what, value, shapes, loc, attw, gr, tap_only: bool) -> dict:
    """K4-bf16 against its plain version and the f32 K4 on the same
    (bf16-exact) inputs. dValue and dAttw (bf16): bf16_tol of the plain
    output, and the kernel's error against the f32 K4 at most 1.25x the
    plain version's. dLoc (f32 from the same exact products): the f32 K4's
    tolerance (max_err_scaled); its error against f32 is f32 rounding on
    both sides and is printed, not compared. dValue and dAttw round where
    the plain version rounds: at most MAX_DIFFERING of their values may
    differ from its bits. `tap_only` (every level on the tap kernel, which
    has no atomics): a second call on the same input gives the same bits."""
    from multi_modal_tracking_torch.ops.msda import (ms_deform_attn_bwd, ms_deform_attn_bwd_bf16,
                                                     ms_deform_attn_bwd_bf16_ref)
    got = ms_deform_attn_bwd_bf16(value, shapes, loc, attw, gr)
    again = ms_deform_attn_bwd_bf16(value, shapes, loc, attw, gr)
    repeatable = all(torch.equal(a, b) for a, b in zip(got, again))
    require(repeatable or not tap_only, f"{what}: two calls on one input differ")
    plain = ms_deform_attn_bwd_bf16_ref(value, shapes, loc, attw, gr)
    f32 = ms_deform_attn_bwd(value.float(), shapes, loc, attw.float(), gr.float())
    require([t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.bfloat16],
            f"{what}: gradient dtypes {[t.dtype for t in got]}")
    out = {"repeatable": repeatable}
    for name, x, p, f in zip(("dValue", "dLoc", "dAttw"), got, plain, f32):
        if name == "dLoc":
            err, _, ok = max_err_scaled(x, p)
        else:
            err, _, ok = max_err(x.float(), p.float(), bf16_tol(p))
        require(ok, f"{what} {name} disagrees with its plain version: max abs err {err}")
        e_k, e_p = float((x.float() - f).abs().max()), float((p.float() - f).abs().max())
        share = float((x != p).float().mean())
        if name != "dLoc":
            require(e_k <= 1.25 * e_p, f"{what} {name}: error against the f32 K4 {e_k} > "
                                       f"1.25 x the plain version's {e_p}")
            require(share <= MAX_DIFFERING,
                    f"{what} {name}: {share} of the values differ from the plain version")
        out[name] = dict(max_abs_err=err, f32_err=e_k, plain_f32_err=e_p,
                         f32_err_ratio=e_k / e_p if e_p else None, differing_share=share)
    return out


def kernel_k4_bf16(g):
    """K4-bf16 at the training shape (B 16, Lq 648, M 8, D 64, two 18x18
    levels, P 4) on uniform and model-like locations, against its plain
    version and the f32 K4; msda_plan at bf16 must give both levels the tap
    kernel, whose dValue must be the same bits from call to call."""
    from multi_modal_tracking_torch.ops.msda import (ms_deform_attn_bwd_bf16,
                                                     ms_deform_attn_bwd_bf16_ref)
    rows = []
    Lq = 648
    for locations in ("uniform", "model"):
        value, loc, attw = _msda_inputs(TRAIN_B, MSDA_SHAPES, Lq, M_HEADS, M_D, M_P, g)
        if locations == "model":
            loc = _model_locations(TRAIN_B, MSDA_SHAPES, M_HEADS, M_P, g)
        value, attw = value.to(torch.bfloat16), attw.to(torch.bfloat16)
        gr = torch.randn(TRAIN_B, Lq, M_HEADS * M_D, generator=g).cuda().to(torch.bfloat16)
        plan = _plan_bf16(TRAIN_B, M_HEADS, M_D, MSDA_SHAPES, Lq, M_P)
        require(plan.bwd == ("tap", "tap"), f"K4-bf16 plan {plan}")
        errs = _k4_bf16_case(f"K4-bf16 {locations}", value, MSDA_SHAPES, loc, attw, gr, True)
        kern = lambda: ms_deform_attn_bwd_bf16(value, MSDA_SHAPES, loc, attw, gr)  # noqa: E731
        live = _live_corners(loc, MSDA_SHAPES)
        n_bytes = 2 * 2 * (value.numel() + attw.numel()) + 2 * 4 * loc.numel() + 2 * gr.numel()
        b_ms, b_by = bound_ms(n_bytes, 4.0 * M_D * live, H100_BF16_FLOPS)
        dense = _tap_bwd_flops(TRAIN_B, M_HEADS, M_D, MSDA_SHAPES, Lq, plan.bwd)
        rows.append(dict(B=TRAIN_B, Lq=Lq, locations=locations, path=list(plan.bwd),
                         smem=plan.bwd_smem, by_output=errs, repeatable=errs["repeatable"],
                         max_abs_err=max(e["max_abs_err"] for k, e in errs.items()
                                         if k != "repeatable"),
                         f32_err_ratio=max(errs[k]["f32_err_ratio"] or 0.0
                                           for k in ("dValue", "dAttw")),
                         ms=device_ms(kern), kernels_ms=device_ms(kern, ["msda_bwd_kernel"]),
                         event_ms=cuda_time_ms(kern),
                         plain_ms=cuda_time_ms(lambda: ms_deform_attn_bwd_bf16_ref(
                             value, MSDA_SHAPES, loc, attw, gr), iters=5, warmup=1),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
                         flops=4.0 * M_D * live, dense_flops=dense,
                         dense_floor_ms=dense / H100_BF16_FLOPS * 1e3,
                         calls_per_step=2 if locations == "uniform" else 0))
    emit({"phase": "kernels", "kernel": "K4-bf16 ms_deform_attn_bwd_bf16",
          "tolerance": "dValue, dAttw: bf16_tol, error against the f32 K4 <= 1.25 x plain's, "
                       f"at most {MAX_DIFFERING} not bit-equal to plain's; dLoc: 1e-5 of its "
                       "largest magnitude or 1e-4 rel; dValue the same bits on a second call",
          "dense_floor": "the tap kernel's dense products at 989 TFLOP/s", "cases": rows})
    return rows


# K4-bf16's edge cases (D a multiple of 8): the tap kernel at P 2 with
# Lq 37, on three levels over three query tiles, on a 16x24 level (384
# pixels, 6 blocks), at P 2 on tiny levels (blocks without pixels); both
# kernels in one call (an 18x18 tap level beside a 24x24 direct one; a
# 25x25 direct level beside a 9x9 tap one at B 16); the direct kernel at
# P 5 and 3 (D 64) and at D 16, 32 and 128
MSDA_BWD_BF16_EDGES = [(2, ((9, 12), (5, 7)), 37, 4, 64, 2),
                       (1, ((6, 7), (5, 4), (3, 3)), 130, 2, 64, 4),
                       (2, ((16, 24),), 70, 4, 64, 4), (2, ((1, 1), (2, 3)), 9, 2, 64, 2),
                       (1, ((18, 18), (24, 24)), 50, 2, 64, 4),
                       (TRAIN_B, ((25, 25), (9, 9)), 40, 8, 64, 4),
                       (2, ((6, 6), (3, 3)), 20, 2, 64, 5), (2, ((6, 6), (3, 3)), 20, 2, 64, 3),
                       (2, ((9, 12), (5, 7)), 37, 4, 16, 4),
                       (2, ((6, 7), (5, 4), (3, 3)), 30, 4, 32, 3), (1, ((40, 12),), 21, 2, 128, 2)]


def kernel_edges_bf16_bwd(g):
    """K2-bf16 (with K1-bf16's lse) on ATTN_EDGES; K4-bf16 on both of
    msda_plan's backward paths at bf16, ragged levels and query counts."""
    edge, paths = [], set()
    for (B, H, Nq, Nk, D, n_mt) in ATTN_EDGES:
        q, k, v = (t.to(torch.bfloat16) for t in _qkv(B, H, Nq, Nk, D, g))
        gr = torch.randn(B, H, Nq, D, generator=g).cuda().to(torch.bfloat16)
        got, plain, f32, lse_err, _ = _k2_bf16_case(q, k, v, gr, n_mt, D ** -0.5)
        errs = _k2_bf16_errors(f"K2-bf16 edge case {(B, H, Nq, Nk, D, n_mt)}", got, plain, f32)
        edge.append(dict(kernel="K2-bf16", shape=[B, H, Nq, Nk, D, n_mt],
                         lse_max_abs_err=lse_err, **errs))
    for (B, shp, Lq, M, D, P) in MSDA_BWD_BF16_EDGES:
        value, loc, attw = _msda_inputs(B, shp, Lq, M, D, P, g)
        value, attw = value.to(torch.bfloat16), attw.to(torch.bfloat16)
        gr = torch.randn(B, Lq, M * D, generator=g).cuda().to(torch.bfloat16)
        path = list(_plan_bf16(B, M, D, shp, Lq, P).bwd)
        paths.update(path)
        errs = _k4_bf16_case(f"K4-bf16 edge case {(B, shp, Lq, M, D, P)} ({path})", value, shp,
                             loc, attw, gr, set(path) == {"tap"})
        edge.append(dict(kernel="K4-bf16", shape=[B, shp, Lq, M, D, P], path=path,
                         by_output=errs, max_abs_err=max(e["max_abs_err"] for k, e in errs.items()
                                                         if k != "repeatable")))
    require(paths == {"tap", "direct"}, f"K4-bf16 edge cases cover {paths}")
    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel": "bf16 backward edge cases", "cases": edge})
    return edge


def _bf16_bwd_table_rows(k2_rows, k4_rows, edges) -> dict:
    """Per training step totals (final keep; K4-bf16 on uniform locations)."""
    table = {}
    for key, name, src, repl, rows in (
            ("K2-bf16", "mixed_attention_bwd_bf16 (K2-bf16)", "mixed_attention_bwd_bf16.cu",
             "attention.py:91", k2_rows),
            ("K4-bf16", "msda_bwd_bf16 (K4-bf16)", "msda_bwd.cu", "msda.py:301", k4_rows)):
        step = _sum_rows([r for r in rows if r["calls_per_step"]], "calls_per_step")
        b_ms, b_by = bound_ms(step["bytes"], step["flops"], H100_BF16_FLOPS)
        lib = step.get("library_ms")
        errs = [r["max_abs_err"] for r in rows] + [e["max_abs_err"] for e in edges
                                                   if e["kernel"] == key]
        table[key] = dict(
            name=name, route="cuda", source=f"multi_modal_tracking_torch/csrc/{src}",
            replaces=f"multi_modal_tracking_tpu/ops/{repl}", max_abs_err=max(errs),
            f32_err_ratio_max=max(r["f32_err_ratio"] for r in rows),
            ms=step["ms"], event_ms=step["event_ms"], plain_ms=step["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, bound_f32_ms=None, library_ms=lib,
            library_ratio=step["ms"] / lib if lib else None, per="training step (bf16)")
    table["K4-bf16"]["model_locations_ms"] = sum(r["ms"] for r in k4_rows
                                                 if r["locations"] == "model") * 2
    step = _sum_rows([r for r in k4_rows if r["calls_per_step"]], "calls_per_step")
    table["K4-bf16"]["dense_floor_ms"] = step["dense_flops"] / H100_BF16_FLOPS * 1e3
    table["K4-bf16"]["repeatable"] = all(r["repeatable"] for r in k4_rows)
    table["K4-bf16"]["differing_share_max"] = max(r["by_output"][k]["differing_share"]
                                                  for r in k4_rows for k in ("dValue", "dAttw"))
    return table


def _bf16_table_rows(k1_rows, k3_rows, edges) -> dict:
    """Per tracked frame (K1-bf16: 12 search steps; K3-bf16: 2 calls at
    B 1) and per lockstep N = 12 step totals for the kernel table."""
    table = {}
    for key, name, src, repl, rows in (
            ("K1-bf16", "mixed_attention_bf16 (K1-bf16)", "mixed_attention_bf16.cu",
             "attention.py:44", k1_rows),
            ("K3-bf16", "msda_fwd_bf16 (K3-bf16)", "msda.cu", "msda.py:171",
             [r for r in k3_rows if r["locations"] == "uniform"])):
        frame = _sum_rows(rows, "calls_per_frame")
        step = _sum_rows(rows, "calls_per_lockstep_step")
        b_ms, b_by = bound_ms(frame["bytes"], frame["flops"], H100_BF16_FLOPS)
        lib = frame.get("library_ms")
        errs = [r["max_abs_err"] for r in rows] + [e["max_abs_err"] for e in edges
                                                   if e["kernel"] == key]
        table[key] = dict(
            name=name, route="cuda", source=f"multi_modal_tracking_torch/csrc/{src}",
            replaces=f"multi_modal_tracking_tpu/ops/{repl}", max_abs_err=max(errs),
            f32_err_ratio_max=max(r["f32_err_ratio"] for r in rows),
            ms=frame["ms"], event_ms=frame["event_ms"], plain_ms=frame["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, bound_f32_ms=None, library_ms=lib,
            library_ratio=frame["ms"] / lib if lib else None, per="tracked frame (bf16)",
            lockstep_step_ms=step["ms"],
            lockstep_step_bound_ms=bound_ms(step["bytes"], step["flops"], H100_BF16_FLOPS)[0],
            lockstep_step_library_ms=step.get("library_ms"))
    table["K3-bf16"]["model_locations_ms"] = _sum_rows(
        [r for r in k3_rows if r["locations"] == "model"], "calls_per_frame")["ms"]
    for key, rows in (("K1-bf16", k1_rows),
                      ("K3-bf16", [r for r in k3_rows if r["locations"] == "uniform"])):
        step = _sum_rows(rows, "calls_per_step")
        table[key].update(train_step_ms=step["ms"], train_step_bound_ms=bound_ms(
            step["bytes"], step["flops"], H100_BF16_FLOPS)[0],
            train_step_library_ms=step.get("library_ms"))
    uniform = [r for r in k3_rows if r["locations"] == "uniform"]
    table["K3-bf16"].update(
        dense_floor_ms=_sum_rows(uniform, "calls_per_frame")["dense_flops"] / H100_BF16_FLOPS * 1e3,
        train_step_dense_floor_ms=_sum_rows(uniform, "calls_per_step")["dense_flops"]
        / H100_BF16_FLOPS * 1e3,
        differing_share_max=max(r["differing_share"] for r in k3_rows))
    return table


def _params():
    from multi_modal_tracking_torch.eval.params import get_parameters
    return get_parameters("asymmetric_shared_ce", "attention_lasher_newfusion_2layer")


def phase_model(g: torch.Generator) -> None:
    from multi_modal_tracking_torch.models.build import build_model
    params = _params()
    model = build_model(params.script, params.cfg, device="cuda", seed=0)
    ts, ss = params.cfg.DATA.TEMPLATE.SIZE, params.cfg.DATA.SEARCH.SIZE
    t = torch.randn(2, ts, ts, 3, generator=g)
    ot = torch.randn(2, ts, ts, 3, generator=g)
    s = torch.randn(2, ss, ss, 3, generator=g)
    with torch.no_grad():
        tc, otc, sc = t.cuda(), ot.cuda(), s.cuda()
        full = model(tc, otc, sc, use_ce_template_mask=False)["pred_boxes"]
        cache = model.set_online(tc, otc)
        cached = model.forward_track(cache, sc, use_ce_template_mask=False)["pred_boxes"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            model.forward_track(cache, sc, use_ce_template_mask=False)
        torch.cuda.synchronize()
        track_ms = (time.perf_counter() - t0) / 10 * 1e3
        t0 = time.perf_counter()
        for _ in range(10):
            model(tc, otc, sc, use_ce_template_mask=False)
        torch.cuda.synchronize()
        full_ms = (time.perf_counter() - t0) / 10 * 1e3
    cpu_model = build_model(params.script, params.cfg, device="cpu", seed=0)
    with torch.no_grad():
        cpu_cached = cpu_model.forward_track(cpu_model.set_online(t, ot), s,
                                             use_ce_template_mask=False)["pred_boxes"]
    full, cached = full.cpu(), cached.cpu()
    d_cached = float((cached - full).abs().max())
    d_cpu = float((cached - cpu_cached).abs().max())
    require(tuple(full.shape) == (1, 1, 4) and bool(torch.isfinite(full).all()),
            f"model output {tuple(full.shape)} not finite (1, 1, 4)")
    require(d_cached <= BOX_TOL, f"cached path differs from the full forward by {d_cached}")
    require(d_cpu <= BOX_TOL, f"GPU forward_track differs from the CPU one by {d_cpu}")
    emit({"phase": "model", "recipe": "asymmetric_shared_ce/attention_lasher_newfusion_2layer",
          "params": sum(p.numel() for p in model.parameters()),
          "pred_boxes": full.reshape(-1).tolist(), "cached_vs_full_max_abs": d_cached,
          "gpu_vs_cpu_max_abs": d_cpu, "tolerance": BOX_TOL,
          "forward_track_ms": track_ms, "forward_ms": full_ms})


def _sequence(n, H=512, W=640, seed=0):
    """Textured noise with a bright moving 48x48 square; replicated-gray TIR."""
    rng = np.random.default_rng(seed)
    for t in range(n):
        fv = rng.integers(0, 120, (H, W, 3), dtype=np.uint8)
        fi = rng.integers(0, 120, (H, W, 1), dtype=np.uint8)
        x, y = 80 + 5 * t, 60 + 3 * t
        fv[y:y + 48, x:x + 48] = 230
        fi[y:y + 48, x:x + 48] = 200
        yield fv, np.repeat(fi, 3, axis=-1)


def _counters():
    from multi_modal_tracking_torch.ops.adamw import adamw_fused
    from multi_modal_tracking_torch.ops.attention import (mixed_attention, mixed_attention_bf16,
                                                          mixed_attention_bwd,
                                                          mixed_attention_bwd_bf16)
    from multi_modal_tracking_torch.ops.msda import (ms_deform_attn, ms_deform_attn_bf16,
                                                     ms_deform_attn_bwd, ms_deform_attn_bwd_bf16)
    return {"K1": mixed_attention, "K2": mixed_attention_bwd, "K3": ms_deform_attn,
            "K4": ms_deform_attn_bwd, "K1-bf16": mixed_attention_bf16,
            "K2-bf16": mixed_attention_bwd_bf16, "K3-bf16": ms_deform_attn_bf16,
            "K4-bf16": ms_deform_attn_bwd_bf16, "AdamW": adamw_fused}


F32_KERNELS = ("K1", "K2", "K3", "K4")
BF16_KERNELS = ("K1-bf16", "K2-bf16", "K3-bf16", "K4-bf16")
BF16_SERVING = ("K1-bf16", "K3-bf16")          # the bf16 forward kernels
#: kernel launches per training step (one that updates), by compute dtype
TRAIN_LAUNCHES = {torch.float32: {"K1": 12, "K2": 12, "K3": 2, "K4": 2, "AdamW": 1},
                  torch.bfloat16: {"K1-bf16": 12, "K2-bf16": 12, "K3-bf16": 2, "K4-bf16": 2,
                                   "AdamW": 1}}


#: the wrappers that count their launches by kernel too
BY_KERNEL = ("K3", "K3-bf16", "K4-bf16")


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0
    for key in BY_KERNEL:
        by_kernel = _counters()[key].launches_by_kernel
        by_kernel.update(dict.fromkeys(by_kernel, 0))


def read_launches() -> dict:
    out = {k: fn.launches for k, fn in _counters().items()}
    for key in BY_KERNEL:
        out[f"{key}_by_kernel"] = dict(_counters()[key].launches_by_kernel)
    return out


def _all_tap(counts: dict) -> bool:
    """Every K3-bf16 and K4-bf16 launch of a run went to the tap kernels
    (msda_plan's choice at every recipe shape)."""
    return (counts["K3-bf16_by_kernel"]["tap"] == counts["K3-bf16"]
            and counts["K4-bf16_by_kernel"]["tap"] == counts["K4-bf16"]
            and not counts["K4-bf16_by_kernel"]["direct"])


def phase_tracker(smi: str, frames) -> tuple:
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    n_frames, warm = len(frames), 8
    H, W = frames[0][0].shape[:2]
    tracker = create_tracker(_params(), "TRACKINGNET", seed=0,   # update interval 25
                             dtype=torch.float32)
    require(tracker.update_interval == 25, f"update interval {tracker.update_interval}")

    reset_launches()
    tracker.initialize(list(frames[0]), {"init_bbox": [80.0, 60.0, 48.0, 48.0]})
    boxes = []
    for i, (fv, fi) in enumerate(frames[1:], start=1):
        if i == warm + 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        boxes.append(tracker.track([fv, fi])["target_bbox"])
    secs = time.perf_counter() - t0
    launches = read_launches()

    n_track = n_frames - 1
    boxes = np.asarray(boxes)
    require(launches["K1"] >= 12 * n_track, f"K1 launched {launches['K1']} times over "
                                            f"{n_track} frames (need >= 12 per frame)")
    require(launches["K3"] == 2 * n_track, f"K3 launched {launches['K3']} times over "
                                           f"{n_track} frames (need 2 per frame)")
    require(launches["K2"] == launches["K4"] == 0 and not any(launches[k] for k in BF16_KERNELS),
            f"backward or bf16 kernels ran while tracking: {launches}")
    require(bool(np.isfinite(boxes).all()), "non-finite box")
    inside = (boxes[:, 0] >= 0) & (boxes[:, 1] >= 0) & (boxes[:, 2] > 0) & (boxes[:, 3] > 0) \
        & (boxes[:, 0] + boxes[:, 2] <= W) & (boxes[:, 1] + boxes[:, 3] <= H)
    require(bool(inside.all()), "box outside the frame")
    ms = secs / (n_track - warm) * 1e3
    emit({"phase": "tracker", "frames": n_track, "frame_hw": [H, W], "update_interval": 25,
          "launches": launches, "ms_per_frame": ms, "fps": 1e3 / ms,
          "timed_frames": n_track - warm, "card": smi, "last_box": boxes[-1].tolist()})
    return launches, tracker, boxes


def _wall_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Host clock around `iters` calls ending in a synchronise: what a call
    costs the caller, launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _trace_events(prof) -> list:
    """The events of a torch.profiler run, read from its Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _device_events(events) -> list:
    """Every kernel, copy and memset of a trace, in start order."""
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                  key=lambda e: float(e["ts"]))


def _device_intervals(prof) -> list:
    """(start_us, end_us, name) of every kernel, copy and memset in a
    torch.profiler run, in start order."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in _device_events(_trace_events(prof))]


def _busy_us(intervals) -> float:
    """Length of the union of the intervals (the device is busy if any of
    them runs)."""
    busy, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def phase_profile(tracker, frames, smi: str, label: str = "profile",
                  k1: str = "mixed_attention_fwd_kernel", k3: str = "msda_fwd_kernel") -> dict:
    """Where a tracked frame's time goes: each layer of the main path on the
    host clock (launch overhead included), then a torch.profiler trace of
    whole frames for the device's busy time, its idle share, the number of
    device operations per frame and the kernels that take the most time
    (K1's and K3's shares by the kernel names k1 and k3)."""
    from torch.profiler import ProfilerActivity, profile
    from multi_modal_tracking_torch.tracking.tracker import _prep_rgbt
    model = tracker.model
    fv, fi = frames[0]
    with torch.no_grad():
        img_v, img_i = tracker._upload(fv), tracker._upload(fi)
        prep = lambda: _prep_rgbt(img_v, img_i, tracker._state, tracker.search_factor,
                                  tracker.search_size)
        sv, si, _ = prep()
        s_vi = torch.cat([sv, si], dim=0)
        backbone = lambda: model.backbone.forward_search(tracker._cache, s_vi,
                                                         use_ce_template_mask=False)
        feat = backbone()
        fusion = lambda: model.fusion_vi(feat[:1], feat[1:])
        fused = fusion()
        layers = {"upload": _wall_ms(lambda: (tracker._upload(fv), tracker._upload(fi))),
                  "crop_jet_normalise": _wall_ms(prep),
                  "backbone": _wall_ms(backbone),
                  "fusion": _wall_ms(fusion),
                  "head": _wall_ms(lambda: model.box_head(fused))}
    layers["track_total"] = _wall_ms(lambda: tracker.track([fv, fi]))

    n = len(frames)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fv, fi in frames:
            tracker.track([fv, fi])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ivals = _device_intervals(prof)
    require(len(ivals) > 0, "the profiler saw no device operation in the traced frames")
    busy = _busy_us(ivals)
    by_name = {}
    for s, e, name in ivals:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    share = lambda key: sum(t for k, t in by_name.items() if key in k) / busy
    out = {"phase": label, "card": smi, "layers_ms": layers, "traced_frames": n,
           "wall_ms_per_frame_profiled": wall_us / n / 1e3,
           "device_busy_ms_per_frame": busy / n / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "device_ops_per_frame": len(ivals) / n,
           "K1_share_of_busy": share(k1), "K3_share_of_busy": share(k3),
           "top_kernels_ms_per_frame": [[k[:90], t / n / 1e3] for k, t in top]}
    emit(out)
    return out


#: device kernel names of the forward kernels on the tracking path, by the
#: compute dtype of the tracker (substrings of the profiler's names)
TRACK_KERNEL_NAMES = {torch.float32: {"K1": "mixed_attention_fwd_kernel",
                                      "K3": "msda_fwd_kernel"},
                      torch.bfloat16: {"K1-bf16": K1_BF16_KERNELS[0],
                                       "K3-bf16": "msda_fwd_kernel"}}
INIT_BOX = [80.0, 60.0, 48.0, 48.0]


#: profiler sessions tried for a launch count check: a session can lose
#: kernel events (device_ms), so one that saw fewer kernels of a name than
#: were launched is run again; more than were launched is a fault at once
PROFILE_SESSIONS = 3


def _lost_events(launches: dict, by_name: dict) -> bool:
    return any(by_name[k] < launches[k] for k in launches) and \
        all(by_name[k] <= launches[k] for k in launches)


def _name_counts(ivals, names: dict) -> dict:
    """Device intervals whose kernel name holds each of `names`' values."""
    return {k: sum(1 for _, _, n in ivals if sub in n) for k, sub in names.items()}


class _HostClock:
    """Sums the host clock (`seconds`) and the calling thread's CPU time
    (`cpu_seconds`) inside a tracker's frame staging
    (`StaticInputs.load_host`) and step dispatch (`_step`: a graph replay
    or the eager launches): the host's own work of `track`, which waits
    for nothing. The thread time of the whole call also holds the
    spin-wait of its 4-float download. The thread clock ticks in 10 ms
    steps on the card's machine, so over a few hundred short calls it is
    a sample: the host clock is the finer reading."""

    def __init__(self, tracker):
        self.tracker, self.seconds, self.cpu_seconds = tracker, 0.0, 0.0

    def _clocked(self, fn):
        def run(*args, **kwargs):
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.cpu_seconds += time.thread_time() - c0
        return run

    def __enter__(self):
        from multi_modal_tracking_torch.tracking.graphs import StaticInputs
        self.load_host = StaticInputs.load_host
        StaticInputs.load_host = self._clocked(self.load_host)
        self.tracker._step = self._clocked(self.tracker._step)
        return self

    def __exit__(self, *exc):
        from multi_modal_tracking_torch.tracking.graphs import StaticInputs
        StaticInputs.load_host = self.load_host
        del self.tracker._step


def _track_run(tracker, frames, timed_from: int = 9) -> dict:
    """initialize on frames[0], then track every other frame: the boxes,
    and from frame `timed_from` on the host clock (ms per frame), the
    calling thread's CPU ms per frame in the whole of `track`, the host
    and CPU ms per frame in its own work (_HostClock), the kernel launches
    of the whole run and the peak device memory."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tracker.initialize(list(frames[0]), {"init_bbox": INIT_BOX})
    boxes = []
    with _HostClock(tracker) as clock:
        for i, (fv, fi) in enumerate(frames[1:], start=1):
            if i == timed_from:
                torch.cuda.synchronize()
                t0, c0 = time.perf_counter(), time.thread_time()
                h0, hc0 = clock.seconds, clock.cpu_seconds
            boxes.append(tracker.track([fv, fi])["target_bbox"])
        torch.cuda.synchronize()
    n = len(frames) - timed_from
    return dict(boxes=np.asarray(boxes, np.float32),
                ms_per_frame=(time.perf_counter() - t0) / n * 1e3,
                thread_cpu_ms_per_frame=(time.thread_time() - c0) / n * 1e3,
                host_ms_per_frame=(clock.seconds - h0) / n * 1e3,
                host_cpu_ms_per_frame=(clock.cpu_seconds - hc0) / n * 1e3,
                launches=read_launches(), peak_allocated=torch.cuda.max_memory_allocated(),
                peak_reserved=torch.cuda.max_memory_reserved())


def _profile_track(tracker, frames, names: dict, keep: list | None = None) -> dict:
    """torch.profiler over `frames` tracked one by one: device busy ms,
    idle share and operations per frame, and per kernel the launch count
    and the number of device kernels of its name (a graph replay's
    kernels are the graph's nodes). A session run again (lost events)
    tracks the same frames from the same state. `keep`, a list, gets the
    device intervals of the session kept."""
    from torch.profiler import ProfilerActivity, profile
    snap = tracker.snapshot()
    for attempt in range(PROFILE_SESSIONS):
        tracker.restore(snap)
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for fv, fi in frames:
                tracker.track([fv, fi])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        launches = {k: read_launches()[k] for k in names}
        ivals = _device_intervals(prof)
        require(len(ivals) > 0, "the profiler saw no device operation in the traced frames")
        by_name = _name_counts(ivals, names)
        if not _lost_events(launches, by_name):
            break
    busy, n = _busy_us(ivals), len(frames)
    if keep is not None:
        keep.extend(ivals)
    return dict(wall_ms_per_frame=wall_us / n / 1e3, device_busy_ms_per_frame=busy / n / 1e3,
                device_idle_share=1.0 - busy / wall_us, device_ops_per_frame=len(ivals) / n,
                launches=launches, kernels_by_name=by_name, profiler_sessions=attempt + 1)


def _allocator_releases() -> dict:
    """Whether the caching allocator still gives back what it caches: about
    60% of the free memory is cached for a side stream, then asked for on
    the current stream (the allocator must free the other stream's cache
    when cudaMalloc fails), then `empty_cache` must release it. Both stop
    for good while the allocator takes a graph capture to be under way."""
    n = int(torch.cuda.mem_get_info()[0] * 0.6) // 4
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.empty(n, device="cuda").fill_(0)
    torch.cuda.synchronize()
    try:
        torch.empty(n, device="cuda")
        reused = True
    except torch.OutOfMemoryError:
        reused = False
    cached = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_reserved()
    return dict(ok=reused and cached - left >= 3.6 * n, other_stream_cache_reused=reused,
                reserved_gib_before_empty_cache=cached / 2 ** 30,
                reserved_gib_after=left / 2 ** 30)


def _unrepaired_failed_capture() -> dict:
    """What torch.cuda.graph alone leaves after a capture that raised, before
    the repair the runner makes (tracking/graphs.py undo_failed_capture),
    which then runs: whether the thread's stream is the one before, and
    `_allocator_releases`. Printed, not required (a later torch may clean
    up by itself)."""
    from multi_modal_tracking_torch.tracking.graphs import undo_failed_capture
    x = torch.ones(4, device="cuda")
    stream, pool = torch.cuda.current_stream(), torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            x.sum().item()
        raised = None
    except Exception as e:          # the capture's own error: what is probed here
        raised = type(e).__name__
    left = dict(raised=raised, stream_is_the_one_before=torch.cuda.current_stream() == stream,
                allocator=_allocator_releases())
    undo_failed_capture(x.device, pool, stream)
    del graph
    torch.cuda.empty_cache()
    return left


def phase_graphs(smi: str, frames) -> dict:
    """The tracking step as CUDA graphs (tracking/graphs.py) against the
    same step eager (graphs=False) on the same model. First a capture of a
    step that reads a value on the host must raise naming that operation
    and leave the thread's current stream and the caching allocator as they
    were (`_allocator_releases` before and after), and a capture after it
    must work. Then, f32 and bf16: the
    tracker phase's 63 frames at 512x640 (template updates at frames 25
    and 50) four times, graphed (this run captures the graphs), eager,
    graphed, eager; every trajectory bit-equal to the first, and the
    kernel launches of every run equal. Then a profile of the next 10
    frames each way: device busy, idle share and operations per frame,
    and the launch counts against the kernels the profiler saw by name.
    Prints ms per frame on the host clock, the host's own ms and CPU ms
    per frame (_HostClock) and the calling thread's, capture ms per graph,
    the graph pool's bytes and peak memory. Returns the launch counts of a
    graphed run by kernel."""
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.tracking.graphs import StepGraphs
    unrepaired = _unrepaired_failed_capture()
    x = torch.ones(4, device="cuda")
    stream, before = torch.cuda.current_stream(), _allocator_releases()
    runner = StepGraphs(x.device)
    try:
        runner.run(("host read",), lambda: x.sum().item())
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    require("aten._local_scalar_dense" in raised,
            f"capturing a step that reads a value on the host must raise naming "
            f"aten._local_scalar_dense, raised {raised!r}")
    after = _allocator_releases()
    require(torch.cuda.current_stream() == stream and before["ok"] and after["ok"],
            f"after a failed capture: current stream {torch.cuda.current_stream()} (was "
            f"{stream}); the allocator before {before}, after {after}")
    for _ in range(2):          # the key's eager step and its capture, then a replay
        runner.run(("after a failed capture",), lambda: x.mul_(2.0))
    require(x.tolist() == [4.0] * 4 and len(runner) == 1,
            f"a capture after a failed one gave {x.tolist()}, {len(runner)} graphs")
    out, launches = {"failed_capture_raises": True, "torch_alone_after_a_failed_capture":
                     unrepaired, "runner_before_and_after_a_failed_capture": [before, after]}, {}
    for dtype, names in TRACK_KERNEL_NAMES.items():
        label = "f32" if dtype == torch.float32 else "bf16"
        graphed = create_tracker(_params(), "TRACKINGNET", seed=0, dtype=dtype)
        eager = _eager_twin(graphed)
        require(graphed.graphs is not None and eager.graphs is None,
                "create_tracker on CUDA must return a graphed tracker")
        runs = [(name, _track_run(tr, frames[:64]))
                for name, tr in (("graphed_capture", graphed), ("eager", eager),
                                 ("graphed", graphed), ("eager_2", eager))]
        first = runs[0][1]
        for name, run in runs[1:]:
            if not np.array_equal(run["boxes"], first["boxes"]):
                bad = np.flatnonzero((run["boxes"] != first["boxes"]).any(axis=1))
                raise RuntimeError(f"chip_smoke: {label} {name} trajectory differs from the "
                                   f"graphed one from frame {bad[0] + 1} on (frames "
                                   f"{(bad + 1).tolist()}), by up to "
                                   f"{float(np.abs(run['boxes'] - first['boxes']).max())} px")
            require(run["launches"] == first["launches"],
                    f"{label} {name} launches {run['launches']} != graphed {first['launches']}")
        require(len(graphed.graphs) == 2, f"{label}: {len(graphed.graphs)} graphs, expected "
                                         f"2 (search; search + template update)")
        require(all(first["launches"][k] > 0 for k in names), f"{label}: {first['launches']}")
        prof = {"graphed": _profile_track(graphed, frames[64:], names),
                "eager": _profile_track(eager, frames[64:], names)}
        for p in prof.values():
            require(p["launches"] == prof["eager"]["launches"] == p["kernels_by_name"],
                    f"{label}: launches {p['launches']} against eager "
                    f"{prof['eager']['launches']} and the profiler's kernels "
                    f"{p['kernels_by_name']}")
        launches[label] = runs[2][1]["launches"]
        n = 63
        out[label] = dict(
            bit_equal_runs=[name for name, _ in runs[1:]], frames=n,
            ms_per_frame={name: r["ms_per_frame"] for name, r in runs},
            host_ms_per_frame={name: r["host_ms_per_frame"] for name, r in runs},
            host_cpu_ms_per_frame={name: r["host_cpu_ms_per_frame"] for name, r in runs},
            thread_cpu_ms_per_frame={name: r["thread_cpu_ms_per_frame"] for name, r in runs},
            launches_per_run={k: first["launches"][k] for k in names},   # init + 63 frames
            profile=prof, capture_ms={("search_update" if k[-1] else "search"): v
                                      for k, v in graphed.graphs.capture_ms.items()},
            graph_pool_bytes=graphed.graphs.pool_bytes(),
            peak_allocated={name: r["peak_allocated"] for name, r in runs},
            peak_reserved={name: r["peak_reserved"] for name, r in runs})
        del graphed, eager
        torch.cuda.empty_cache()
    emit({"phase": "graphs", "card": smi, **out})
    return launches


def _train_cfg(batch: int, steps: int):
    """The flagship recipe with the synthetic set, no val split and no warm
    starts (their weight files are not in the repository)."""
    from multi_modal_tracking_torch.config import get_default_config
    cfg = get_default_config(SCRIPT)
    cfg.update_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "experiments", SCRIPT, f"{RECIPE}.yaml"))
    cfg.DATA.TRAIN.DATASETS_NAME = ["SyntheticRGBT"]
    cfg.DATA.VAL.DATASETS_NAME = []
    cfg.MODEL.BACKBONE.PRETRAINED = False
    cfg.MODEL.RGBT_PRETRAINED_PATH = ""
    cfg.TRAIN.BATCH_SIZE = batch
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = batch * steps
    return cfg


def _grads_agree(gpu, cpu):
    """The train-step tolerance of the module docstring; returns the worst
    ratios of error to bound (<= 1 passes)."""
    named_cpu = dict(cpu.named_parameters())
    gnorm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in cpu.parameters())))
    floor, total, worst_t, worst_e = 1e-6 * gnorm, 0.0, 0.0, 0.0
    for name, p in gpu.named_parameters():
        g, w = p.grad.detach().cpu().double(), named_cpu[name].grad.double()
        err = float((g - w).norm())
        total += err ** 2
        worst_t = max(worst_t, err / (5e-2 * float(w.norm()) + floor))
        worst_e = max(worst_e, float((g - w).abs().max()) / (1e-1 * float(w.abs().max()) + floor))
    return dict(all=total ** 0.5 / (1e-2 * gnorm), tensor=worst_t, element=worst_e), gnorm


def _step_grads(cfg, batch, dev, dtype, state=None):
    """One full-width training step at batch 2 (dropout and drop path off,
    keep 1.0) on `dev` in `dtype`, from `state` (the weights of the first
    model built): (model, loss, grad norm, seconds)."""
    from multi_modal_tracking_torch.models.build import build_model
    from multi_modal_tracking_torch.train.losses import box_losses
    from multi_modal_tracking_torch.train.train_step import model_inputs
    m = build_model(SCRIPT, cfg, device=dev, dtype=dtype, seed=0,
                    spec_overrides=dict(drop_path_rate=0.0, fusion_dropout=0.0)).train()
    if state is not None:
        m.load_state_dict({k: v.to(dev) for k, v in state.items()})
    x = model_inputs(batch, dev)
    t0 = time.perf_counter()
    loss, _ = box_losses(m(x["t"], x["ot"], x["s"], 1.0)["pred_boxes"], x["gt_xywh"],
                         cfg.TRAIN.IOU_WEIGHT, cfg.TRAIN.L1_WEIGHT)
    loss.backward()
    gnorm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in m.parameters())))
    return m, float(loss.detach()), gnorm, time.perf_counter() - t0


def _grad_dist(a, b) -> float:
    nb = dict(b.named_parameters())
    return float(torch.sqrt(sum(((p.grad.detach().cpu().double()
                                  - nb[n].grad.detach().cpu().double()) ** 2).sum()
                                for n, p in a.named_parameters())))


def _compare_step_gpu_cpu(dtype=torch.float32):
    """One full-width training step at batch 2 (dropout and drop path off,
    keep 1.0) on the GPU against the same step on the CPU (plain versions).
    float32: the bounds of the module docstring. bf16: the bounds of the
    module docstring, against the CPU bf16 step and the GPU f32 step, with
    the CPU's own bf16 drift (its distance from the GPU's f32 gradients) as
    the scale (bf16 gradients of this loss lie far from the f32 ones, ~0.5 G
    on the CPU test's geometry; see tests/test_torch_port_train_step_bf16.py)."""
    from multi_modal_tracking_torch.train.builders import build_train_loader
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    cfg = _train_cfg(batch=2, steps=1)
    batch = batch_to_model_inputs(next(iter(build_train_loader(cfg, seed=1))))
    gpu, loss_gpu, gnorm_gpu, _ = _step_grads(cfg, batch, "cuda", dtype)
    state = {k: v.cpu() for k, v in gpu.state_dict().items()}
    cpu, loss_cpu, gnorm_cpu, cpu_s = _step_grads(cfg, batch, "cpu", dtype, state)
    d_loss = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    d_norm = abs(gnorm_gpu - gnorm_cpu) / gnorm_cpu
    out = dict(dtype=str(dtype).replace("torch.", ""), loss_gpu=loss_gpu, loss_cpu=loss_cpu,
               loss_rel_diff=d_loss, grad_norm_gpu=gnorm_gpu, grad_norm_cpu=gnorm_cpu,
               grad_norm_rel_diff=d_norm, cpu_step_s=cpu_s)
    if dtype == torch.float32:
        require(d_loss <= 1e-3 and d_norm <= 1e-3, f"GPU vs CPU step: loss rel diff {d_loss}, "
                                                   f"grad norm rel diff {d_norm}")
        ratios, _ = _grads_agree(gpu, cpu)
        require(max(ratios.values()) <= 1.0, f"GPU vs CPU gradients beyond the bounds: {ratios}")
        return dict(out, error_over_bound=ratios)
    require({p.grad.dtype for m in (gpu, cpu) for p in m.parameters()} == {torch.float32}
            and {p.dtype for m in (gpu, cpu) for p in m.parameters()} == {torch.float32},
            "bf16 step: parameters or gradients not float32")
    f32, loss_f32, gnorm_f32, _ = _step_grads(cfg, batch, "cuda", torch.float32, state)
    drift = _grad_dist(cpu, f32)
    d_gpu_cpu, d_gpu_f32 = _grad_dist(gpu, cpu), _grad_dist(gpu, f32)
    d_loss_f32 = abs(loss_gpu - loss_f32) / abs(loss_f32)
    require(d_loss <= 2.0 ** -6 and d_loss_f32 <= 2.0 ** -6,
            f"bf16 GPU step: loss rel diff {d_loss} from the CPU bf16 step, {d_loss_f32} from "
            f"the GPU f32 step")
    require(d_gpu_cpu <= 2.0 * drift, f"bf16 GPU vs CPU gradients {d_gpu_cpu} > 2 x the CPU's "
                                      f"bf16 drift from f32 {drift}")
    require(d_gpu_f32 <= 1.5 * drift, f"bf16 GPU vs GPU f32 gradients {d_gpu_f32} > 1.5 x the "
                                      f"CPU's bf16 drift from f32 {drift}")
    return dict(out, grad_dist_gpu_cpu=d_gpu_cpu, grad_dist_gpu_bf16_f32=d_gpu_f32,
                cpu_bf16_drift_from_gpu_f32=drift, grad_dist_over_drift=d_gpu_cpu / drift,
                grad_dist_f32_over_drift=d_gpu_f32 / drift, loss_gpu_f32=loss_f32,
                loss_rel_diff_f32=d_loss_f32, grad_norm_gpu_f32=gnorm_f32)


def _libjpeg() -> dict:
    """Whether this machine has libjpeg's header (as the C++ compiler finds
    it) and its shared library (as ctypes finds it): what the file-based
    datasets would decode with."""
    import ctypes.util
    probe = subprocess.run([os.environ.get("CXX") or "g++", "-fsyntax-only", "-x", "c++", "-"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    return {"jpeglib_h": probe.returncode == 0, "libjpeg": ctypes.util.find_library("jpeg"),
            "libturbojpeg": ctypes.util.find_library("turbojpeg")}


def _timed_batches(loader, n: int) -> tuple:
    """All n batches of `loader` and its ms per batch after the first
    (which starts the threads). The synthetic sequences are rendered
    first: a file dataset would decode instead, and the rendering is
    cached for the life of the dataset object."""
    for ds in loader.sampler.datasets:
        for seq in range(ds.get_num_sequences()):
            ds.get_sequence_info(seq)
    it = iter(loader)
    batches = [next(it)]
    t0 = time.perf_counter()
    batches += list(it)
    require(len(batches) == n, f"the loader gave {len(batches)} batches, expected {n}")
    return batches, (time.perf_counter() - t0) / (n - 1) * 1e3


def phase_train_data(smi: str) -> dict:
    """The training input pipeline on this machine's host at the recipe's
    settings (batch 16, search 288 at 4.5, two templates of 128 at 2.0,
    TRAIN.NUM_WORKER threads): the native loader (the C++ host data
    library, the Trainer's) against the plain one (numpy) on the same seed,
    every key of DATA_BATCHES batches bit for bit, and each one's ms per
    batch; and whether the machine has libjpeg."""
    from multi_modal_tracking_torch.train.builders import build_train_loader
    cfg = _train_cfg(TRAIN_B, DATA_BATCHES)
    native_loader = build_train_loader(cfg, seed=3)
    plain_loader = build_train_loader(cfg, seed=3)
    require(native_loader.sampler.processing.pixels == "native",
            f"the Trainer's loader runs {native_loader.sampler.processing.pixels!r} pixels")
    plain_loader.sampler.processing.pixels = "plain"
    got, native_ms = _timed_batches(native_loader, DATA_BATCHES)
    want, plain_ms = _timed_batches(plain_loader, DATA_BATCHES)
    for b, (x, y) in enumerate(zip(got, want)):
        require(x.keys() == y.keys(), f"batch {b}: keys {sorted(x)} vs {sorted(y)}")
        bad = [k for k in x if x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k])]
        require(not bad, f"batch {b}: native and plain batches differ in {bad}")
    jpeg = _libjpeg()
    print(f"libjpeg on this machine: jpeglib.h {'found' if jpeg['jpeglib_h'] else 'not found'}, "
          f"shared library {jpeg['libjpeg'] or 'not found'}", flush=True)
    out = dict(batches_compared=len(got), batch=TRAIN_B,
               keys=sorted(got[0]), host_data_ms_per_batch=native_ms,
               host_data_ms_per_batch_plain=plain_ms, plain_over_native=plain_ms / native_ms,
               data_workers=cfg.TRAIN.NUM_WORKER, host_cpus=len(os.sched_getaffinity(0)),
               libjpeg=jpeg)
    emit({"phase": "train data", "card": smi, "recipe": f"{SCRIPT}/{RECIPE}",
          "check": "native == plain, every key, bit for bit", **out})
    return out


class _Preloaded:
    """A loader's batches collated before the epoch: the epoch loop and the
    look-ahead without the loader's threads."""

    def __init__(self, loader):
        self.name, self.batches = loader.name, list(loader)

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _epoch_at_pace(tr, dtype, isolated_ms: float, preloaded: bool = False) -> tuple:
    """One epoch of EPOCH_STEPS[dtype] steps through Trainer.cycle_dataset
    at the final keep and the recipe's print interval, the loader and the
    look-ahead running as in training (`preloaded`: the batches collated
    before the epoch, so no loader thread runs beside the steps): ms per
    step over the steps after the first EPOCH_WARM (the clock starts at a
    synchronise before step EPOCH_WARM + 1 and stops at one after the
    epoch), against the isolated step; the device stream's wait on each
    batch's upload (CUDA events) and the loop's wait for the look-ahead's
    batch (host clock). Returns (fields, launch counts)."""
    from multi_modal_tracking_torch.train.builders import build_train_loader
    n = EPOCH_STEPS[dtype]
    loader = build_train_loader(_train_cfg(TRAIN_B, n), seed=2)
    if preloaded:
        loader = _Preloaded(loader)
    step, calls, started = tr._step, [], []

    def clocked(*args, **kwargs):
        if len(calls) == EPOCH_WARM:
            torch.cuda.synchronize()
            started.append(time.perf_counter())
        calls.append(1)
        return step(*args, **kwargs)

    interval = tr.stats.print_interval
    tr._step, tr.stats.print_interval, tr.epoch = clocked, tr.cfg.TRAIN.PRINT_INTERVAL, 51
    reset_launches()
    try:
        tr.cycle_dataset(loader)
        torch.cuda.synchronize()
        secs = time.perf_counter() - started[0]
    finally:
        tr._step, tr.stats.print_interval = step, interval
    counts = read_launches()
    for k, per in TRAIN_LAUNCHES[dtype].items():
        require(counts[k] == per * n, f"{k} launched {counts[k]} times in an epoch of {n} steps")
    waits = tr.input_waits[EPOCH_WARM:]
    require(len(tr.history) == n and len(waits) == n - EPOCH_WARM
            and all(w is not None for _, w in waits), "the epoch did not run through the "
                                                      "look-ahead's uploads")
    upload = [a.elapsed_time(b) for _, (a, b) in waits]
    ms = secs / (n - EPOCH_WARM) * 1e3
    return dict(steps=n, timed_steps=n - EPOCH_WARM, preloaded=preloaded,
                print_interval=tr.cfg.TRAIN.PRINT_INTERVAL,
                ms_per_step_in_epoch=ms, ms_per_step_median=isolated_ms,
                in_epoch_over_isolated=ms / isolated_ms,
                upload_wait_ms_per_step=float(np.mean(upload)),
                upload_wait_ms_max=float(np.max(upload)),
                loader_wait_ms_per_step=float(np.mean([h for h, _ in waits])) * 1e3,
                loss=[m["Loss/total"] for m in tr.history]), counts


#: keep rate of each step of the graphed-vs-eager check: keep 1.0 twice, the
#: final bucket twice, 1.0 again (a replay of the first graph), the bucket
#: once more
GRAPH_KEEPS = (1.0, 1.0, KEEP_FINAL, KEEP_FINAL, 1.0, KEEP_FINAL)
#: the training kernels' device names (substrings) for the profiles' counts
TRAIN_KERNEL_NAMES = {"K1": "mixed_attention_fwd", "K2": "attn_bwd_", "K3": "msda_fwd_kernel",
                      "K4": "msda_bwd_kernel"}


def _train_batches(n: int, seed: int = 4) -> list:
    """n batches of 16 from the recipe's loader, uploaded as model inputs."""
    from multi_modal_tracking_torch.train.builders import build_train_loader
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    from multi_modal_tracking_torch.train.train_step import model_inputs
    loader = build_train_loader(_train_cfg(TRAIN_B, n), seed=seed)
    return [model_inputs(batch_to_model_inputs(b), "cuda") for b in loader]


def _train_state(tr) -> dict:
    """Every tensor of a Trainer's training state by name: weights and BN
    buffers, AdamW's moments, the open accumulation group's mean, the
    host's counters and the generator's state."""
    opt = tr.optimizer
    out = {f"net/{k}": v for k, v in tr.model.state_dict().items()}
    for g in opt.groups:
        for i, (m, v) in enumerate(zip(opt.mu[g], opt.nu[g])):
            out[f"mu/{g}/{i}"], out[f"nu/{g}/{i}"] = m, v
    for i, a in enumerate(opt._acc or ()):
        out[f"acc/{i}"] = a
    out["counters"] = torch.tensor([opt.count, opt.mini_step, tr.epoch])
    out["generator"] = tr.generator.get_state()
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers (so -0.0 differs from 0.0 and a NaN
    equals itself)."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype)
    return t.detach().view(view) if view is not None else t.detach()


def _differing(a: dict, b: dict) -> list:
    """The names of `a` whose tensors are not the same bits in `b`."""
    require(a.keys() == b.keys(), f"states of different keys: {sorted(a.keys() ^ b.keys())[:4]}")
    return [k for k in a if a[k].shape != b[k].shape or a[k].dtype != b[k].dtype
            or not torch.equal(_bits(a[k]), _bits(b[k].to(a[k].device)))]


def _rel_dist(a: dict, b: dict, prefixes) -> float:
    """||a - b|| / ||b|| over the floating tensors whose names start with
    one of `prefixes`, all together."""
    keys = [k for k in a if k.startswith(prefixes) and a[k].is_floating_point()]
    num = sum(float((a[k].double() - b[k].double()).pow(2).sum()) for k in keys)
    den = sum(float(b[k].double().pow(2).sum()) for k in keys)
    return (num / den) ** 0.5


def _graphed_vs_eager(graphed, eager, batches, keeps, eager2=None) -> dict:
    """The same steps from the same state on the same batches through the
    graphed Trainer and its eager twin (graphs=False), with equal launch
    counts. Without `eager2` (bf16): weights, BN buffers, AdamW moments,
    accumulator, counters, generator state and every step's metrics must
    be the same bits. With a second eager twin `eager2` (f32, whose K4
    sums dValue with atomics, so that two eager runs differ and the
    difference grows step by step: module docstring): the counters, the
    generator state, the BN batch counts and the first step's forward
    metrics must be the same bits, the three runs' distances are printed,
    and one replay from the eager run's state is held to it
    (`_one_replay_f32`)."""
    runs, states = {}, {}
    for name, tr in (("graphed", graphed), ("eager", eager), ("eager2", eager2)):
        if tr is None:
            continue
        reset_launches()
        metrics = [tr._step(x, keep) for x, keep in zip(batches, keeps)]
        torch.cuda.synchronize()
        runs[name] = ({f"step{i}/{k}": v for i, m in enumerate(metrics) for k, v in m.items()},
                      read_launches())
        states[name] = _train_state(tr)
    out = dict(steps=len(keeps), keeps=list(keeps), launches=runs["graphed"][1],
               graphs=len(graphed._step.graphs))
    for name in runs:
        require(runs[name][1] == runs["graphed"][1],
                f"launches graphed {runs['graphed'][1]} vs {name} {runs[name][1]}")
    g, e = states["graphed"], states["eager"]
    if eager2 is None:
        diff = _differing(g, e) + _differing(runs["graphed"][0], runs["eager"][0])
        require(not diff, f"graphed and eager training differ in {len(diff)} tensors: {diff[:6]}")
        return dict(out, check="graphed == eager, bit for bit",
                    tensors_compared=len(g) + len(runs["graphed"][0]))
    exact = [k for k in g if k in ("counters", "generator") or k.endswith("num_batches_tracked")]
    first = [f"step0/{k}" for k in ("Loss/total", "Loss/ciou", "Loss/l1", "IoU")]
    diff = _differing({k: g[k] for k in exact}, {k: e[k] for k in exact}) + _differing(
        {k: runs["graphed"][0][k] for k in first}, {k: runs["eager"][0][k] for k in first})
    require(not diff, f"graphed and eager f32 training differ in {diff}")
    e2 = states["eager2"]
    dist = {f"{what}_{pair}": _rel_dist(x, y, prefixes)
            for what, prefixes in (("weights", ("net/",)), ("moments", ("mu/", "nu/")))
            for pair, x, y in (("graphed_eager", g, e), ("graphed_eager2", g, e2),
                               ("eager_eager2", e, e2))}
    return dict(out, check="f32: counters, generator, BN counts, first forward bit for bit",
                eager_runs_same_bits=not _differing(e, e2), rel_dist_after_steps=dist,
                tensors_compared=len(exact) + len(first), tensors_differing=len(_differing(g, e)),
                one_replay=_one_replay_f32(graphed, eager, batches[-1]))


#: f32, one step from the same state: the gradients' distance K4's atomics
#: may leave (measured ~1e-7 of their norm; a wrong capture gives O(1))
F32_GRAD_REL = 1e-4
#: and the distances that leaves in the weights (measured 2.7e-9 of their
#: norm) and in AdamW's moments (about 0.4x the gradients': mu takes 0.1 of
#: the gradient); a stale learning rate, count or moment gives 1e-3 or more
F32_WEIGHTS_REL, F32_MOMENTS_REL = 1e-6, 1e-5


def _one_replay_f32(graphed, eager, x) -> dict:
    """One f32 step at the final keep from the same state: the eager
    Trainer's state loaded into the graphed one's tensors in place (as a
    resume does), then a replay against an eager step on the same batch.
    The forward (losses, IoU, BN statistics), the counters and the
    generator state must be the same bits; the (clipped) gradients within
    F32_GRAD_REL of their norm, the grad norm within 1e-5 of it, and after
    the update the weights within F32_WEIGHTS_REL and the moments within
    F32_MOMENTS_REL of theirs."""
    graphed.model.load_state_dict(eager.model.state_dict())
    graphed.optimizer.load_state_dict(eager.optimizer.state_dict())
    graphed.generator.set_state(eager.generator.get_state())
    require(not _differing(_train_state(graphed), _train_state(eager)), "state load failed")
    n_graphs = len(graphed._step.graphs)
    mg, me = graphed._step(x, KEEP_FINAL), eager._step(x, KEEP_FINAL)
    torch.cuda.synchronize()
    require(len(graphed._step.graphs) == n_graphs, "the one-step check captured a new graph")
    return _one_step_bounds((mg, _train_state(graphed), _grads(graphed)),
                            (me, _train_state(eager), _grads(eager)))


def _grads(tr) -> dict:
    return {f"{i}": t for i, t in enumerate(tr.optimizer.grads)}


def _one_step_bounds(replay: tuple, eager: tuple) -> dict:
    """`_one_replay_f32`'s checks on the (metrics, training state,
    gradients) of a replay and of an eager step from one state."""
    (mg, sg, gg), (me, se, ge) = replay, eager
    exact = [k for k in sg if k in ("counters", "generator") or "running_" in k
             or k.endswith("num_batches_tracked")]
    fwd = ("Loss/total", "Loss/ciou", "Loss/l1", "IoU")
    diff = _differing({k: sg[k] for k in exact}, {k: se[k] for k in exact}) + _differing(
        {k: mg[k] for k in fwd}, {k: me[k] for k in fwd})
    require(not diff, f"f32 replay and eager step from one state differ in {diff}")
    grad_rel = _rel_dist(gg, ge, ("",))
    norm_rel = abs(float(mg["grad_norm"]) - float(me["grad_norm"])) / float(me["grad_norm"])
    weights_rel, moments_rel = _rel_dist(sg, se, ("net/",)), _rel_dist(sg, se, ("mu/", "nu/"))
    require(grad_rel <= F32_GRAD_REL and norm_rel <= 1e-5 and weights_rel <= F32_WEIGHTS_REL
            and moments_rel <= F32_MOMENTS_REL,
            f"f32 replay vs eager from one state: gradients {grad_rel} of their norm apart, "
            f"grad norms {norm_rel}, weights after the update {weights_rel}, moments "
            f"{moments_rel}")
    return dict(bit_equal=len(exact) + len(fwd), grad_rel_dist=grad_rel,
                grad_norm_rel_diff=norm_rel, weights_rel_dist=weights_rel,
                moments_rel_dist=moments_rel)


def _every_recipe_key(tr, cfg, x) -> tuple:
    """The graphed Trainer captures a graph for every keep rate that the
    recipe's keep schedule gives over its TRAIN.EPOCH epochs (bucketed,
    `Trainer._keep_rate`), one step each on batch `x` for the keys it has
    not captured yet, all into its one pool: before them and after each
    capture the pool's bytes and the bytes reserved and allocated in the
    process, and each capture's ms. Returns (fields, launch counts of those
    steps)."""
    keeps = sorted({tr._keep_rate(e) for e in range(cfg.TRAIN.EPOCH)}, reverse=True)
    graphs = tr._step.graphs
    have = {k[0] for k in graphs.capture_ms}
    torch.cuda.synchronize()
    rows = [dict(keep=k, key="captured before") for k in keeps if k in have]
    before = dict(graphs=len(graphs), pool_gib=graphs.pool_bytes() / 2 ** 30,
                  reserved_gib=torch.cuda.memory_reserved() / 2 ** 30,
                  allocated_gib=torch.cuda.memory_allocated() / 2 ** 30)
    reset_launches()
    for keep in keeps:
        if keep in have:
            continue
        tr._step(x, keep)
        torch.cuda.synchronize()
        key = next(k for k in graphs.capture_ms if k[0] == keep)
        rows.append(dict(keep=keep, keep_tokens=round(keep * (cfg.DATA.SEARCH.SIZE // 16) ** 2),
                         pool_gib=graphs.pool_bytes() / 2 ** 30,
                         reserved_gib=torch.cuda.memory_reserved() / 2 ** 30,
                         allocated_gib=torch.cuda.memory_allocated() / 2 ** 30,
                         capture_ms=graphs.capture_ms[key]))
    counts = read_launches()
    require(len(graphs) == len(keeps) and {k[0] for k in graphs.capture_ms} == set(keeps),
            f"{len(graphs)} graphs for the recipe's {len(keeps)} keep rates {keeps}")
    return dict(check="every keep rate of the recipe's schedule captured in one pool",
                epochs=cfg.TRAIN.EPOCH, keep_rates=keeps, graphs=len(graphs), before=before,
                captures=rows, pool_gib=graphs.pool_bytes() / 2 ** 30), counts


def _state_bytes(tr) -> int:
    """Device bytes a Trainer's training state holds outside any pool:
    weights, buffers, static gradients, AdamW's moments, the accumulator,
    the step's static inputs and metrics."""
    opt, step = tr.optimizer, tr._step
    ts = list(tr.model.parameters()) + list(tr.model.buffers()) + (opt.grads or []) + \
        [t for g in opt.groups for t in opt.mu[g] + opt.nu[g]] + (opt._acc or []) + \
        [t for inputs in step._inputs.values() for t in inputs.tensors] + [step._out]
    return sum(t.numel() * t.element_size() for t in ts)


def _isolated_steps(step, inputs, n: int = 5) -> dict:
    """n synchronised steps at the final keep: host clock ms per step; the
    host clock ms until the step call returns (its dispatch; the device may
    still run); and the host's CPU ms in the step calls (time.process_time,
    every thread of the process, the synchronise after each call left out;
    summed over the n calls, as the clock ticks coarsely, then divided)."""
    ms, call, cpu = [], [], 0.0
    for _ in range(n):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        step(inputs, KEEP_FINAL)
        cpu += time.process_time() - c0
        call.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(ms_per_step=ms, ms_per_step_median=float(np.median(ms)),
                host_call_ms_per_step=float(np.median(call)), host_cpu_ms_per_step=cpu / n * 1e3)


def _profile_steps(step, inputs, bf16: bool, n: int = 3) -> dict:
    """torch.profiler over n steps at the final keep: device busy ms, idle
    share and operations per step, the kernels of K1-K4 (their device
    names, TRAIN_KERNEL_NAMES) per step, their shares of busy time and the
    top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(inputs, KEEP_FINAL)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ivals = _device_intervals(prof)
    require(len(ivals) > 0, "the profiler saw no device operation in the traced steps")
    busy = _busy_us(ivals)
    by_name = {}
    for s, e, name in ivals:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    suffix = "-bf16" if bf16 else ""
    ops_by_name = {}
    for _, _, name in ivals:
        ops_by_name[name] = ops_by_name.get(name, 0) + 1

    def mine(k):            # the bf16 kernels' names carry bf16 or bfloat16
        return ("bf16" in k or "bfloat16" in k) == bf16
    return dict(profiled_steps=n, wall_ms_per_step_profiled=wall_us / n / 1e3,
                ops_by_name=ops_by_name,
                device_busy_ms_per_step=busy / n / 1e3, device_idle_share=1.0 - busy / wall_us,
                device_ops_per_step=len(ivals) / n,
                kernels_per_step={k + suffix: sum(1 for _, _, nm in ivals if sub in nm and mine(nm))
                                  / n for k, sub in TRAIN_KERNEL_NAMES.items()},
                kernel_share_of_busy={k + suffix: sum(t for nm, t in by_name.items()
                                                      if sub in nm and mine(nm)) / busy
                                      for k, sub in TRAIN_KERNEL_NAMES.items()},
                top_kernels_ms_per_step=[[k[:90], t / n / 1e3] for k, t in top])


def phase_train(smi: str, save_dir: str, dtype=torch.float32) -> dict:
    """The training main path: Trainer on the full-width recipe at batch 16,
    computing in `dtype` on float32 parameters (bf16: the Trainer's
    default), its step a CUDA graph replay (the default), against an eager
    twin (graphs=False) from the same seed. Returns the launch counts of
    the graphed Trainer's runs and its isolated step's median ms."""
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    from multi_modal_tracking_torch.train.train_step import model_inputs
    from multi_modal_tracking_torch.train.trainer import Trainer
    bf16 = dtype == torch.bfloat16
    cfg = _train_cfg(TRAIN_B, TRAIN_STEPS)
    kw = {} if bf16 else dict(dtype=dtype)          # bf16 through the default
    tr = Trainer(SCRIPT, cfg, save_dir=save_dir, device="cuda", seed=0,
                 print_interval=TRAIN_STEPS, **kw)
    eager = Trainer(SCRIPT, cfg, save_dir=save_dir, device="cuda", seed=0,
                    print_interval=TRAIN_STEPS, graphs=False, **kw)
    require(tr.dtype == dtype and {p.dtype for p in tr.model.parameters()} == {torch.float32},
            f"Trainer dtype {tr.dtype}, parameters {({p.dtype for p in tr.model.parameters()})}")
    require(tr._step.graphs is not None and eager._step.graphs is None,
            "the Trainer does not capture its step by default on the card")
    per_step = TRAIN_LAUNCHES[dtype]
    launches = {k: 0 for k in per_step}
    # f32: a second eager twin gives the eager runs' own spread (K4's atomics)
    eager2 = None if bf16 else Trainer(SCRIPT, cfg, save_dir=save_dir, device="cuda", seed=0,
                                       print_interval=TRAIN_STEPS, graphs=False, **kw)
    batches = _train_batches(len(GRAPH_KEEPS))
    twin = _graphed_vs_eager(tr, eager, batches, GRAPH_KEEPS, eager2)
    del eager2
    torch.cuda.empty_cache()
    for k, n in per_step.items():
        require(twin["launches"][k] == n * len(GRAPH_KEEPS),
                f"{k} launched {twin['launches'][k]} times in {len(GRAPH_KEEPS)} steps")
        launches[k] += twin["launches"][k]
    emit({"phase": "train bf16" if bf16 else "train", "card": smi, **twin})
    keys, counts = _every_recipe_key(tr, cfg, batches[0])
    for k in per_step:
        launches[k] += counts[k]
    emit({"phase": "train bf16" if bf16 else "train", "card": smi, **keys})

    epochs, losses = {}, []
    for epoch, keep in ((1, 1.0), (51, KEEP_FINAL)):
        tr.epoch = epoch
        require(tr._keep_rate(epoch) == keep, f"keep rate {tr._keep_rate(epoch)} at epoch {epoch}")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.cycle_dataset()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_launches()
        for k, n in per_step.items():
            require(counts[k] == n * TRAIN_STEPS, f"{k} launched {counts[k]} times in "
                                                  f"{TRAIN_STEPS} steps at keep {keep}")
            launches[k] += counts[k]
        others = [k for k in F32_KERNELS + BF16_KERNELS if k not in per_step and counts[k]]
        require(not others, f"{dtype} training launched {others}: {counts}")
        if bf16:
            require(_all_tap(counts), f"bf16 training: MSDA kernels {counts['K3-bf16_by_kernel']}, "
                                      f"{counts['K4-bf16_by_kernel']}, expected the tap kernels")
        step_losses = [m["Loss/total"] for m in tr.history]
        require(len(step_losses) == TRAIN_STEPS and all(np.isfinite(step_losses)),
                f"losses {step_losses}")
        losses += step_losses
        epochs[epoch] = dict(keep=keep, launches=counts, ms_per_step_in_epoch=secs / TRAIN_STEPS * 1e3,
                             loss=step_losses, grad_norm=[m["grad_norm"] for m in tr.history])
    require(len(set(losses)) > 1, f"the loss did not change between steps: {losses}")

    # host data time: batches from the threaded loader, after a warm one
    it = iter(tr.train_loader)
    next(it)
    t0 = time.perf_counter()
    batches = list(it)
    data_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    t0 = time.perf_counter()
    inputs = model_inputs(batch_to_model_inputs(batches[-1]), "cuda")
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    del it

    # the isolated step graphed and eager; the memory a step takes beyond
    # the Trainer's state (both Trainers' states are allocated throughout)
    mem, iso = {}, {}
    for name, t in (("graphed", tr), ("eager", eager)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        iso[name] = _isolated_steps(t._step, inputs)
        mem[name] = dict(state_gib=_state_bytes(t) / 2 ** 30,
                         step_peak_beyond_state_gib=(torch.cuda.max_memory_allocated() - base)
                         / 2 ** 30)
    graphs = tr._step.graphs
    mem["graphed"]["pool_gib"] = graphs.pool_bytes() / 2 ** 30
    for name, m in mem.items():
        m["peak_gib"] = m["state_gib"] + m["step_peak_beyond_state_gib"] + m.get("pool_gib", 0.0)
    med = iso["graphed"]["ms_per_step_median"]
    # the epochs at the training pace beside the isolated steps, before the
    # profiler: after a torch.profiler session host-bound steps run slower
    pace, counts = _epoch_at_pace(tr, dtype, med)
    for k in per_step:
        launches[k] += counts[k]
    if bf16:                # the same epoch without loader threads
        pace_preloaded, counts = _epoch_at_pace(tr, dtype, med, preloaded=True)
        for k in per_step:
            launches[k] += counts[k]
    step_ms_after = _isolated_steps(tr._step, inputs)["ms_per_step"]
    moments = [v for g in tr.optimizer.groups for v in tr.optimizer.mu[g] + tr.optimizer.nu[g]]
    require(moments and {v.dtype for v in moments} == {torch.float32}
            and {p.dtype for p in tr.model.parameters()} == {torch.float32},
            "parameters or AdamW moments are not float32")
    # a replay runs every kernel of the eager step (by name and count), K1-K4
    # as many times, and may add its own (the generators' offsets written at
    # each replay); a session that lost events is run again. Copies and
    # memsets are counted, not required: the profiler sees a graph's copy
    # and memset nodes in some sessions and not in others
    for attempt in range(PROFILE_SESSIONS):
        prof = {name: _profile_steps(t._step, inputs, bf16) for name, t in (("graphed", tr),
                                                                           ("eager", eager))}
        by_g, by_e = (prof[k].pop("ops_by_name") for k in ("graphed", "eager"))
        missing = {k: v - by_g.get(k, 0) for k, v in by_e.items()
                   if by_g.get(k, 0) < v and not k.startswith(("Memcpy", "Memset"))}
        if not missing and \
                prof["graphed"]["kernels_per_step"] == prof["eager"]["kernels_per_step"]:
            break
    prof["graphed"]["profiler_sessions"] = attempt + 1
    n_prof = prof["graphed"]["profiled_steps"]
    extra = {k[:90]: (v - by_e.get(k, 0)) / n_prof for k, v in by_g.items() if v > by_e.get(k, 0)}
    require(not missing
            and prof["graphed"]["kernels_per_step"] == prof["eager"]["kernels_per_step"],
            f"a replay lacks kernels of the eager step: {dict(list(missing.items())[:6])}, "
            f"K1-K4 {prof['graphed']['kernels_per_step']} vs {prof['eager']['kernels_per_step']}")
    prof["graphed"]["extra_ops_per_step_in_replay"] = extra
    emit({"phase": "train bf16" if bf16 else "train", "card": smi, "recipe": f"{SCRIPT}/{RECIPE}",
          "batch": TRAIN_B, "dtype": str(dtype).replace("torch.", ""), "epochs": epochs,
          "loss_per_step": losses,
          "ms_per_step_median": med, "ms_per_step": iso["graphed"]["ms_per_step"],
          "samples_per_s": TRAIN_B / med * 1e3,
          "host_call_ms_per_step": iso["graphed"]["host_call_ms_per_step"],
          "host_cpu_ms_per_step": iso["graphed"]["host_cpu_ms_per_step"],
          "eager": dict(iso["eager"], samples_per_s=TRAIN_B / iso["eager"]["ms_per_step_median"]
                        * 1e3, **prof["eager"], memory=mem["eager"]),
          "eager_over_graphed": iso["eager"]["ms_per_step_median"] / med,
          "ms_per_step_after_epochs": step_ms_after,
          "host_data_ms_per_batch": data_ms, "host_upload_ms_per_batch": upload_ms,
          "data_workers": cfg.TRAIN.NUM_WORKER, "host_cpus": len(os.sched_getaffinity(0)),
          "epoch_at_pace": pace,
          **({"epoch_at_pace_preloaded": pace_preloaded} if bf16 else {}),
          **prof["graphed"], "memory": mem["graphed"],
          "peak_memory_gib": mem["graphed"]["peak_gib"],
          "graphed_over_eager_memory": mem["graphed"]["peak_gib"] / mem["eager"]["peak_gib"],
          "graphs": len(graphs),
          "capture_ms": {str(k[:3]): v for k, v in graphs.capture_ms.items()}})
    del tr, eager, inputs
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train bf16" if bf16 else "train",
          "check": "gpu vs cpu step, batch 2, keep 1.0", **_compare_step_gpu_cpu(dtype)})
    return launches, med


def _mae_file(path: str, cfg) -> dict:
    """A bare MAE-style backbone file from a seeded model: `blocks.*` and
    `patch_embed.*` without the `backbone.` prefix, the modal LayerNorm
    pairs folded back to norm1/norm2 (perturbed, so they differ from the
    init), plus pos_embed and mask_token. Returns the dict it saved."""
    from multi_modal_tracking_torch.models.build import build_model
    g = torch.Generator().manual_seed(8)
    sd = {}
    for k, v in build_model(SCRIPT, cfg, device="cpu", seed=7).state_dict().items():
        if not k.startswith("backbone.") or re.search(r"\.norm[12]_i\.", k):
            continue
        k = re.sub(r"\.(norm[12])_v\.", r".\1.", k[len("backbone."):])
        sd[k] = v + 0.1 * torch.randn(v.shape, generator=g) if ".norm" in k else v
    sd["pos_embed"] = torch.randn(1, 197, 768, generator=g)
    sd["mask_token"] = torch.zeros(1, 1, 768)
    torch.save({"model": sd}, path)
    return sd


def _lifecycle_cfg(mae_path: str):
    """The train phase's recipe at 2 steps per epoch, with a SyntheticRGBT
    val split every epoch (2 batches) and the MAE warm start."""
    cfg = _train_cfg(TRAIN_B, LIFE_STEPS)
    cfg.MODEL.BACKBONE.PRETRAINED = True
    cfg.MODEL.BACKBONE.PRETRAINED_PATH = mae_path
    cfg.DATA.VAL.DATASETS_NAME = ["SyntheticRGBT"]
    cfg.DATA.VAL.DATASETS_RATIO = [1]
    cfg.DATA.VAL.SAMPLE_PER_EPOCH = TRAIN_B * LIFE_STEPS
    cfg.TRAIN.VAL_EPOCH_INTERVAL = 1
    cfg.TRAIN.EPOCH = 2
    return cfg


def _timed(fn, out: list):
    """fn wrapped to append its synchronised seconds to `out`."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        return res
    return run


def _lifecycle_train(tr) -> dict:
    """Two epochs of train + val through Trainer.train with a failure
    injected after the second training cycle_dataset call has run (the
    weights, moments and generator have moved on from the checkpoint): the
    fail-safe restart must resume from epoch 1's checkpoint, loading it
    into the tensors the step's graphs hold, and finish at epoch 2."""
    from multi_modal_tracking_torch.utils import checkpoint as ckpt
    save_s, load_s, val_s, train_calls, resumed_from = [], [], [], [], []
    cycle, load = tr.cycle_dataset, tr.load_checkpoint

    def flaky_cycle(loader=None, train=True):
        if train:
            train_calls.append(tr.epoch)
            rec = cycle(loader, train)
            if len(train_calls) == 2:
                raise RuntimeError("chip_smoke: injected failure")
            return rec
        return _timed(cycle, val_s)(loader, train)

    def tracked_load(path=None):
        resumed_from.append(ckpt.latest_checkpoint(tr.ckpt_dir, tr.net_name))
        return _timed(load, load_s)(path)

    tr.cycle_dataset, tr.load_checkpoint = flaky_cycle, tracked_load
    tr.save_checkpoint = _timed(tr.save_checkpoint, save_s)
    tr.train(max_epochs=2, fail_safe=True)
    require(tr.epoch == 2 and train_calls == [1, 2, 2], f"fail-safe run ended at epoch "
                                                      f"{tr.epoch}, train calls {train_calls}")
    require(len(resumed_from) == 1 and resumed_from[0].endswith("MixFormerRGBT_ep0001.pth.tar"),
            f"fail-safe restart resumed from {resumed_from}")
    with open(os.path.join(tr.stats.log_dir, "metrics.jsonl")) as f:
        rows = [(r["loader"], r["epoch"]) for r in map(json.loads, f)]
    # the failed pass logged its epoch before the failure
    require(rows == [("train", 1), ("val", 1), ("train", 2), ("train", 2), ("val", 2)],
            f"metrics rows {rows}")
    path = ckpt.latest_checkpoint(tr.ckpt_dir, tr.net_name)
    require(path.endswith("_ep0002.pth.tar"), f"latest checkpoint {path}")
    return dict(checkpoint=path, save_s=save_s, restart_load_s=load_s,
                val_ms_per_batch_in_cycle=[s / len(tr.val_loader) * 1e3 for s in val_s])


def _same_state(a, b, what: str = "resumed") -> int:
    """Trainer b holds exactly trainer a's training state (`_train_state`,
    bit for bit); returns the number of tensors compared."""
    sa, sb = _train_state(a), _train_state(b)
    diff = _differing(sa, sb)
    require(not diff, f"{what} state differs in {len(diff)} tensors: {diff[:4]}")
    return len(sa)


def _lifecycle_accum(cfg, save_dir: str) -> dict:
    """One epoch of 4 batches at ACCUM_ITER 2, graphed (its two role graphs,
    accumulate and update): the weights move after micro-batches 2 and 4
    only, count is 2, and an eager twin (graphs=False) on the same batches
    ends in the same state and metrics, bit for bit."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg.TRAIN.ACCUM_ITER = 2
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = 4 * TRAIN_B
    cfg.DATA.VAL.DATASETS_NAME = []
    cfg.MODEL.BACKBONE.PRETRAINED = False
    tr = Trainer(SCRIPT, cfg, save_dir=save_dir, device="cuda", seed=0, print_interval=4)
    eager = Trainer(SCRIPT, cfg, save_dir=save_dir, device="cuda", seed=0, print_interval=4,
                    graphs=False)
    step, moved, step_s = tr._step, [], []

    def watched(*args, **kwargs):
        before = [p.detach().clone() for p in tr.model.parameters()]
        m = _timed(step, step_s)(*args, **kwargs)
        moved.append(any(not torch.equal(b, p) for b, p in zip(before, tr.model.parameters())))
        return m

    tr._step = watched
    tr.epoch = eager.epoch = 1
    tr.cycle_dataset()
    tr._step = step
    require(moved == [False, True, False, True] and tr.optimizer.count == 2
            and tr.optimizer.mini_step == 0,
            f"ACCUM_ITER 2: weights moved {moved}, count {tr.optimizer.count}")
    roles = sorted(k[2] for k in step.graphs.capture_ms)
    require(roles == ["accumulate", "update"], f"ACCUM_ITER 2 graphs {roles}")
    eager.cycle_dataset()
    n = _same_state(tr, eager, "ACCUM_ITER 2 graphed vs eager")
    require(tr.history == eager.history, f"ACCUM_ITER 2 metrics graphed {tr.history} vs eager "
                                         f"{eager.history}")
    return dict(accum_moved=moved, accum_count=tr.optimizer.count, accum_graphs=roles,
                accum_tensors_compared=n,
                ms_per_accum_micro_step=[s * 1e3 for s in step_s],
                ms_per_accum_micro_step_median=float(np.median(step_s)) * 1e3)


def phase_lifecycle(smi: str, frames, bf16_step_ms: float) -> dict:
    """Checkpoints and the rest of the training loop at full width, batch
    16, at the Trainer's default compute dtype (bf16 on float32
    parameters): MAE warm start, train + val with an injected failure and
    the fail-safe restart, an exact resume into a fresh Trainer, an
    ACCUM_ITER 2 epoch, and create_tracker (bf16, its default: the float32
    checkpoint loaded, then cast) on the epoch-2 checkpoint against a
    tracker on a copy of the trainer's in-memory model cast the same way.
    Returns the kernel launch counts."""
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.tracking.tracker import RGBTCachedTracker
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    from multi_modal_tracking_torch.train.train_step import model_inputs
    from multi_modal_tracking_torch.train.trainer import Trainer
    from multi_modal_tracking_torch.utils import checkpoint as ckpt
    from multi_modal_tracking_torch.utils.checkpoint import cast_floating
    with tempfile.TemporaryDirectory() as tmp:
        mae_path = os.path.join(tmp, "mae_pretrain_vit_base.pth")
        cfg = _lifecycle_cfg(mae_path)
        mae = _mae_file(mae_path, cfg)
        reset_launches()
        tr = Trainer(SCRIPT, cfg, save_dir=tmp, device="cuda", seed=0, print_interval=LIFE_STEPS)
        require(tr.dtype == torch.bfloat16, f"the Trainer's default dtype is {tr.dtype}")
        got = tr.model.state_dict()
        for k, v in mae.items():
            if k in ("pos_embed", "mask_token"):
                continue
            norm = re.search(r"\.(norm[12])\.", k)
            targets = ([k.replace(norm.group(0), f".{norm.group(1)}{s}.") for s in ("_v", "_i")]
                       if norm else [k])
            require(all(torch.equal(got["backbone." + t].cpu(), v) for t in targets),
                    f"MAE warm start: {k} differs")
        out = _lifecycle_train(tr)
        # where an earlier run of this script ran out of memory: device
        # memory in use and reserved, with the restarted Trainer alive
        out["memory_before_uninterrupted_gib"] = dict(
            allocated=torch.cuda.memory_allocated() / 2 ** 30,
            reserved=torch.cuda.memory_reserved() / 2 ** 30,
            pool=tr._step.graphs.pool_bytes() / 2 ** 30)
        # the same two epochs uninterrupted, in a directory of their own
        whole_dir = os.path.join(tmp, "uninterrupted")
        whole = Trainer(SCRIPT, cfg, save_dir=whole_dir, device="cuda", seed=0,
                        print_interval=LIFE_STEPS)
        whole.train(max_epochs=2, fail_safe=False)
        out["resume_tensors_compared"] = _same_state(whole, tr, "fail-safe restart vs "
                                                                "uninterrupted")
        require(whole.history == tr.history, f"val metrics after the restart {tr.history} "
                                              f"vs uninterrupted {whole.history}")
        out["graphs_after_restart"] = len(tr._step.graphs)
        del whole

        t0 = time.perf_counter()
        state = ckpt.load_checkpoint(out["checkpoint"])
        out["load_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = os.path.getsize(out["checkpoint"])
        del state
        tr2 = Trainer(SCRIPT, cfg, save_dir=tmp, device="cuda", seed=0)
        t0 = time.perf_counter()
        require(tr2.load_checkpoint(), "a fresh Trainer found no checkpoint")
        torch.cuda.synchronize()
        out["resume_s"] = time.perf_counter() - t0
        _same_state(tr, tr2)
        val_in = model_inputs(batch_to_model_inputs(next(iter(tr.val_loader))), "cuda")
        out["val_step_ms"] = _wall_ms(lambda: tr._eval_step(val_in), iters=5, warmup=1)
        del tr2, val_in
        torch.cuda.empty_cache()
        out.update(_lifecycle_accum(_lifecycle_cfg(mae_path), tmp))

        params = _params()
        params.checkpoint = out["checkpoint"]
        loaded = create_tracker(params, "TRACKINGNET", seed=1)
        require({p.dtype for p in loaded.model.parameters()} == {torch.bfloat16},
                "create_tracker's default is not bf16")
        in_memory = RGBTCachedTracker(cast_floating(copy.deepcopy(tr.model).eval(), torch.bfloat16),
                                      template_factor=params.template_factor,
                                      template_size=params.template_size,
                                      search_factor=params.search_factor,
                                      search_size=params.search_size,
                                      update_interval=loaded.update_interval,
                                      ce_keep_rate=None, device="cuda")
        boxes = []
        for tracker in (loaded, in_memory):
            tracker.initialize(list(frames[0]), {"init_bbox": [80.0, 60.0, 48.0, 48.0]})
            boxes.append(np.asarray([tracker.track([fv, fi])["target_bbox"]
                                     for fv, fi in frames[1:LIFE_FRAMES + 1]]))
        d_px = float(np.abs(boxes[0] - boxes[1]).max())
        require(bool(np.isfinite(boxes[0]).all()) and d_px <= 1e-6,
                f"tracker on the checkpoint differs from the in-memory model by {d_px} px")
        launches = read_launches()
        # two epochs with epoch 2 twice (the restart), the uninterrupted two,
        # then the ACCUM_ITER 2 epoch graphed and eager (4 micro-batches, 2
        # updates, each)
        n_steps = 5 * LIFE_STEPS + 8
        require(launches["K2-bf16"] == 12 * n_steps and launches["K4-bf16"] == 2 * n_steps
                and launches["AdamW"] == n_steps - 4
                and launches["K1-bf16"] > 0 and launches["K3-bf16"] > 0
                and not any(launches[k] for k in F32_KERNELS) and _all_tap(launches),
                f"lifecycle launches {launches} ({n_steps} bf16 training steps)")
        del tr, loaded, in_memory
        torch.cuda.empty_cache()
    out.pop("checkpoint")
    emit({"phase": "lifecycle", "card": smi, "recipe": f"{SCRIPT}/{RECIPE}", "batch": TRAIN_B,
          "dtype": "bfloat16",
          "checks": ["MAE warm start equal", "fail-safe restart from _ep0001",
                     "restart == uninterrupted, bit for bit", "resume exact",
                     "ACCUM_ITER 2 moves after batches 2 and 4",
                     "ACCUM_ITER 2 graphed == eager, bit for bit", "checkpoint tracker equal"],
          "tracked_frames": LIFE_FRAMES, "tracker_max_abs_px": d_px, "launches": launches,
          "isolated_bf16_step_ms": bf16_step_ms,
          "accum_micro_step_over_isolated": out["ms_per_accum_micro_step_median"] / bf16_step_ms,
          **out})
    return launches


def _inside(boxes: np.ndarray, H: int, W: int) -> bool:
    return bool(np.isfinite(boxes).all() and (boxes[:, :2] >= 0).all()
                and (boxes[:, 2:] > 0).all() and (boxes[:, 0] + boxes[:, 2] <= W).all()
                and (boxes[:, 1] + boxes[:, 3] <= H).all())


def _eval_run(name: str, fn, seqs, root: str, runs: dict, kernels=("K1", "K3")) -> dict:
    """Time one eval run on the host clock with the launch counts of that
    run alone; check its files. `kernels` must launch, no other kernel may.
    Returns {sequence: float trajectory}."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = fn(os.path.join(root, name))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    require(all(launches[k] > 0 for k in kernels)
            and not any(launches[k] for k in F32_KERNELS + BF16_KERNELS if k not in kernels)
            and ("K3-bf16" not in kernels or _all_tap(launches)),
            f"eval {name}: launches {launches}")
    H, W = seqs[0].frames[0][0].shape[:2]
    floats = {s["seq"]: s["boxes"] for s in stats}
    for seq in seqs:
        path = os.path.join(root, name, f"{seq.name}.txt")
        require(os.path.isfile(path), f"eval {name}: no result file for {seq.name}")
        boxes = np.loadtxt(path)
        require(boxes.shape == (len(seq.frames), 4) and _inside(boxes, H, W)
                and _inside(floats[seq.name], H, W),
                f"eval {name}: {seq.name} boxes not finite {len(seq.frames)}x4 inside the frame")
    frames = sum(len(s.frames) for s in seqs)
    runs[name] = dict(seconds=secs, frames=frames, fps=frames / secs, launches=launches)
    return floats


def _profile_block(bt, seqs, n_frames: int, names=None) -> dict:
    """torch.profiler over one lockstep block of n_frames frames of every
    sequence in `seqs` (already uploaded): device busy time and idle share
    per lockstep step and per frame; with `names` (TRACK_KERNEL_NAMES) the
    block's launch counts must equal the kernels the profiler saw by
    name."""
    from torch.profiler import ProfilerActivity, profile
    N = len(seqs)
    fv = np.stack([np.stack([s.frames[k][0] for s in seqs]) for k in range(1, n_frames + 1)])
    fi = np.stack([np.stack([s.frames[k][1] for s in seqs]) for k in range(1, n_frames + 1)])
    bt.initialize(fv[0], fi[0], np.stack([s.ground_truth_rect[0, 0] for s in seqs]))
    bt.track_block(fv, fi)                               # warm
    for attempt in range(PROFILE_SESSIONS):
        bt.initialize(fv[0], fi[0], np.stack([s.ground_truth_rect[0, 0] for s in seqs]))
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bt.track_block(fv, fi)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        launches = read_launches()
        ivals = _device_intervals(prof)
        require(len(ivals) > 0, "the profiler saw no device operation in the lockstep block")
        extra = {}
        if names is None:
            break
        extra = dict(launches={k: launches[k] for k in names},
                     kernels_by_name=_name_counts(ivals, names), profiler_sessions=attempt + 1)
        if not _lost_events(extra["launches"], extra["kernels_by_name"]):
            break
    if names is not None:
        require(extra["launches"] == extra["kernels_by_name"],
                f"lockstep block: launches {extra['launches']} against the profiler's kernels "
                f"{extra['kernels_by_name']}")
    busy = _busy_us(ivals)
    return dict(batch=N, steps=n_frames, wall_ms_per_step=wall_us / n_frames / 1e3, **extra,
                device_busy_ms_per_step=busy / n_frames / 1e3,
                device_busy_ms_per_frame=busy / n_frames / N / 1e3,
                wall_ms_per_frame=wall_us / n_frames / N / 1e3,
                device_idle_share=1.0 - busy / wall_us,
                device_ops_per_step=len(ivals) / n_frames)


def _eager_twin(tracker):
    """The single-stream tracker's step run eager, on the same model."""
    from multi_modal_tracking_torch.tracking.tracker import RGBTCachedTracker
    t = tracker
    return RGBTCachedTracker(t.model, template_factor=t.template_factor,
                             template_size=t.template_size, search_factor=t.search_factor,
                             search_size=t.search_size, update_interval=t.update_interval,
                             ce_keep_rate=None, graphs=False)


def _lockstep_twin(tracker, graphs: bool = True):
    """The lockstep tracker on a single-stream tracker's model and settings."""
    from multi_modal_tracking_torch.tracking.batched import BatchedRGBTCachedTracker
    t = tracker
    return BatchedRGBTCachedTracker(t.model, template_factor=t.template_factor,
                                    template_size=t.template_size,
                                    search_factor=t.search_factor, search_size=t.search_size,
                                    update_interval=t.update_interval, ce_keep_rate=None,
                                    scan_chunk=EVAL_CHUNK, graphs=graphs)


def _lockstep_runs(seqs, bt, d: str, n: int) -> list:
    """run_sequences_batched over `seqs` in groups of n."""
    from multi_modal_tracking_torch.tracking.batched import run_sequences_batched
    return [st for lo in range(0, len(seqs), n)
            for st in run_sequences_batched(seqs[lo:lo + n], bt, d, chunk=EVAL_CHUNK)]


def _eval_eager_runs(seqs, root: str, runs: dict, single, bt, one_stream: dict,
                     lockstep: dict, names, kernels=("K1", "K3")) -> None:
    """The one-stream and lockstep N = 12 eval runs again with their steps
    eager (graphs=False): every trajectory must equal the graphed run's
    bit for bit. Adds the runs `<name>_eager` to `runs`."""
    from multi_modal_tracking_torch.eval.running import run_dataset
    for name, fn, want in (
            (names[0], lambda d: run_dataset(seqs, single, d, chunk=EVAL_CHUNK), one_stream),
            (names[1], lambda d: _lockstep_runs(seqs, bt, d, EVAL_BIG), lockstep)):
        got = _eval_run(f"{name}_eager", fn, seqs, root, runs, kernels)
        bad = [k for k in want if not np.array_equal(got[k], want[k])]
        require(not bad, f"eval {name}_eager: trajectories of {bad} differ from the graphed "
                         f"run's (by up to "
                         f"{max(float(np.abs(got[k] - want[k]).max()) for k in bad or want)} px)")
        require(runs[f"{name}_eager"]["launches"] == runs[name]["launches"],
                f"eval {name}_eager: launches {runs[f'{name}_eager']['launches']}, graphed "
                f"{runs[name]['launches']}")


def phase_eval(smi: str) -> dict:
    """The evaluation stack on synthetic_rgbt_hard (12 sequences at
    HARD_FRAMES of their 60 frames, 240x320), full width, seed-0 weights:
    run_dataset one stream at a time (A), run_sequences_batched at N = 4
    and 12 (B4, B12), and run_sequence in ROI mode, margin 1.5 (R); A and
    B12 again eager.
    Returns the launch counts of the runs together."""
    from multi_modal_tracking_torch.eval.analysis import TrackerResults, print_results
    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.running import run_dataset, run_sequence
    name = "synthetic_rgbt_hard"
    seqs = get_dataset(name, n_frames=HARD_FRAMES)
    tracker = create_tracker(_params(), name, seed=0, dtype=torch.float32)
    tracked = sum(len(s.frames) - 1 for s in seqs)
    bt = _lockstep_twin(tracker)
    tracker_eager, bt_eager = _eager_twin(tracker), _lockstep_twin(tracker, graphs=False)
    # one untimed block at each batch size (first calls of new GEMM shapes)
    for n in (EVAL_SMALL, EVAL_BIG):
        _profile_block(bt, seqs[:n], 2)
    uploads = {"window": 0, "full": 0, "frames": 0}
    chunk_full, chunk_roi = tracker.track_chunk, tracker.track_chunk_roi

    def counted(fn, key):
        def run(a, b, *args, **kwargs):
            uploads[key] += a.nbytes + b.nbytes
            uploads["frames"] += a.shape[0]
            return fn(a, b, *args, **kwargs)
        return run

    runs = {}
    with tempfile.TemporaryDirectory() as root:
        seq_floats = _eval_run("A", lambda d: run_dataset(seqs, tracker, d, chunk=EVAL_CHUNK),
                               seqs, root, runs)
        want_a = dict(K1=12 * (tracked + len(seqs)), K3=2 * tracked)
        require(all(runs["A"]["launches"][k] == v for k, v in want_a.items()),
                f"eval A: launches {runs['A']['launches']}, expected {want_a}")
        batched = {}
        for n in (EVAL_SMALL, EVAL_BIG):
            batched[n] = _eval_run(f"B{n}", lambda d, n=n: _lockstep_runs(seqs, bt, d, n),
                                   seqs, root, runs)
            steps = (len(seqs) // n) * (max(len(s.frames) for s in seqs) - 1)
            got = runs[f"B{n}"]["launches"]
            require(got["K3"] == 2 * steps and got["K1"] == 12 * (steps + len(seqs) // n),
                    f"eval B{n}: launches {got} over {steps} lockstep steps")
            kernel = "staged" if 2 * n * M_HEADS >= torch.cuda.get_device_properties(0) \
                .multi_processor_count else "gather"
            require(got["K3_by_kernel"][kernel] == got["K3"],
                    f"eval B{n}: K3 kernels {got['K3_by_kernel']}, expected {kernel}")
            worst = max(float(np.abs(batched[n][k] - seq_floats[k]).max()) for k in seq_floats)
            runs[f"B{n}"]["max_abs_px_vs_A"] = worst
            require(worst <= EVAL_PX_TOL, f"eval B{n}: trajectories {worst} px from the "
                                          f"sequential ones (bound {EVAL_PX_TOL})")
        require(runs[f"B{EVAL_BIG}"]["launches"]["K3_by_kernel"]["staged"] > 0
                and runs[f"B{EVAL_SMALL}"]["launches"]["K3_by_kernel"]["gather"] > 0,
                "eval: K3 staged at N=12 and gather at N=4")

        _eval_eager_runs(seqs, root, runs, tracker_eager, bt_eager, seq_floats,
                         batched[EVAL_BIG], ("A", f"B{EVAL_BIG}"))

        tracker.track_chunk = counted(chunk_full, "full")
        tracker.track_chunk_roi = counted(chunk_roi, "window")
        roi_stats = []

        def roi(d):
            roi_stats.extend(run_sequence(s, tracker, d, chunk=EVAL_CHUNK, roi_margin=1.5)
                             for s in seqs)
            return roi_stats
        roi_floats = _eval_run("R", roi, seqs, root, runs)
        del tracker.track_chunk, tracker.track_chunk_roi
        for seq in seqs:
            with open(os.path.join(root, "A", f"{seq.name}.txt"), "rb") as fa, \
                    open(os.path.join(root, "R", f"{seq.name}.txt"), "rb") as fr:
                require(fa.read() == fr.read(), f"eval R: {seq.name}.txt differs from A's")
            require(torch.equal(torch.from_numpy(roi_floats[seq.name]),
                                torch.from_numpy(seq_floats[seq.name])),
                    f"eval R: {seq.name} trajectory differs from A's")
        windowed = sum(s["n_windowed"] for s in roi_stats)
        require(windowed >= 1, "eval R: no chunk was windowed")
        H, W = seqs[0].frames[0][0].shape[:2]
        runs["R"].update(n_chunks=sum(s["n_chunks"] for s in roi_stats), n_windowed=windowed,
                         n_fallback=sum(s["n_fallback"] for s in roi_stats),
                         upload_bytes_per_frame=(uploads["window"] + uploads["full"])
                         / tracked, upload_bytes_per_frame_full=2 * H * W * 3)
        scores = {}
        for key in ("A", f"B{EVAL_BIG}"):
            sc = print_results([TrackerResults(os.path.join(root, key), key)], seqs,
                               report_name=f"{name} {key}")
            scores[key] = {k: float(sc[k][0]) for k in ("AUC", "OP50", "OP75", "Precision")}
    profile = _profile_block(bt, seqs[:EVAL_BIG], EVAL_CHUNK, TRACK_KERNEL_NAMES[torch.float32])
    profile_eager = _profile_block(bt_eager, seqs[:EVAL_BIG], EVAL_CHUNK,
                                   TRACK_KERNEL_NAMES[torch.float32])
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in ("K1", "K2", "K3", "K4")}
    emit({"phase": "eval", "card": smi, "dataset": name, "sequences": len(seqs),
          "frames": sum(len(s.frames) for s in seqs), "tracked_frames": tracked,
          "frame_hw": [H, W], "chunk": EVAL_CHUNK, "px_tolerance": EVAL_PX_TOL,
          "update_interval": bt.update_interval, "runs": runs,
          "profile_b12_block": profile, "profile_b12_block_eager": profile_eager,
          "scores": scores, "launches": launches})
    del bt, bt_eager, tracker, tracker_eager
    torch.cuda.empty_cache()
    return launches, seq_floats


def _centre_px(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-frame distance between the centres of two (n, 4) xywh tracks."""
    return np.hypot((a[:, 0] + a[:, 2] / 2) - (b[:, 0] + b[:, 2] / 2),
                    (a[:, 1] + a[:, 3] / 2) - (b[:, 1] + b[:, 3] / 2))


def _bf16_drift(frames, f32_boxes: np.ndarray, graphed_boxes: np.ndarray) -> dict:
    """The bf16 tracker's centre distance from the f32 trajectory over the
    tracker phase's frames, eager (graphs=False) on the same weights and
    frames: with the bf16 forward kernels (bit-equal to the graphed run),
    with K1-bf16 and with K3-bf16 replaced by their plain versions on the
    same CUDA tensors, with both, and, as a control, with K1-bf16's plain
    version at an attention scale 2^-20 larger (an f32-sized change). Which
    kernel, if any, moves the trajectory away from f32 more than an f32
    perturbation does: with random weights the box sits at its 10 px
    minimum and the trajectory is chaotic."""
    import multi_modal_tracking_torch.ops.attention as attention
    import multi_modal_tracking_torch.ops.msda as msda
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    k1, k3 = attention.mixed_attention_bf16, msda.ms_deform_attn_bf16
    p1, p3 = attention.mixed_attention_bf16_ref, msda.ms_deform_attn_bf16_ref
    out = {}

    def p1_scaled(q, k, v, n_mt, scale):
        return p1(q, k, v, n_mt, scale * (1.0 + 2.0 ** -20))

    for name, f1, f3 in (("kernels", k1, k3), ("plain_K1-bf16", p1, k3),
                         ("plain_K3-bf16", k1, p3), ("plain_both", p1, p3),
                         ("plain_K1-bf16_scale_plus_2^-20", p1_scaled, k3)):
        attention.mixed_attention_bf16, msda.ms_deform_attn_bf16 = f1, f3
        try:
            tracker = create_tracker(_params(), "TRACKINGNET", seed=0, dtype=torch.bfloat16,
                                     graphs=False)
            tracker.initialize(list(frames[0]), {"init_bbox": INIT_BOX})
            boxes = np.asarray([tracker.track([fv, fi])["target_bbox"] for fv, fi in frames[1:]])
        finally:
            attention.mixed_attention_bf16, msda.ms_deform_attn_bf16 = k1, k3
        if name == "kernels":
            require(np.array_equal(boxes, graphed_boxes),
                    "bf16 tracker eager with its kernels differs from the graphed run")
        d = _centre_px(boxes, f32_boxes)
        out[name] = dict(centre_px_vs_f32_mean=float(d.mean()),
                         centre_px_vs_f32_max=float(d.max()),
                         max_abs_px_vs_kernels=float(np.abs(boxes - graphed_boxes).max()))
        del tracker
    return out


def phase_bf16(smi: str, all_frames, f32_boxes: np.ndarray, f32_eval: dict) -> dict:
    """The bf16 serving path, the JAX package's eval dtype: create_tracker(
    dtype=torch.bfloat16) (float32 model loaded, then cast) tracks the
    tracker phase's 63 frames, then a profile of 10 more; then the eval of
    synthetic_rgbt_hard one stream at a time (A16) and in lockstep N = 12
    (B12_16). Each run must launch K1-bf16 and K3-bf16 and no f32 kernel.
    Prints ms per frame, device busy time, idle share and operations per
    frame, the trajectories' distances to the f32 ones (tracker phase, eval
    A) and lockstep's distance to one bf16 stream: drift, not bounded by
    the f32 0.05 px (cuBLAS may take other bf16 GEMM kernels at batch 2 and
    24). Returns the launch counts of the tracked run and of the eval
    runs."""
    from multi_modal_tracking_torch.eval.analysis import TrackerResults, print_results
    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.running import run_dataset
    frames = all_frames[:64]
    n_frames, warm = len(frames), 8
    H, W = frames[0][0].shape[:2]
    tracker = create_tracker(_params(), "TRACKINGNET", seed=0, dtype=torch.bfloat16)
    params = list(tracker.model.parameters())
    require({p.dtype for p in params} == {torch.bfloat16}
            and all(b.dtype != torch.bfloat16 for b in tracker.model.buffers()),
            "bf16 tracker: parameters not all bf16, or a buffer cast")
    reset_launches()
    tracker.initialize(list(frames[0]), {"init_bbox": [80.0, 60.0, 48.0, 48.0]})
    boxes = []
    for i, (fv, fi) in enumerate(frames[1:], start=1):
        if i == warm + 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        boxes.append(tracker.track([fv, fi])["target_bbox"])
    secs = time.perf_counter() - t0
    track_launches = read_launches()
    n_track = n_frames - 1
    boxes = np.asarray(boxes)
    require(track_launches["K1-bf16"] >= 12 * n_track and track_launches["K3-bf16"] == 2 * n_track
            and not any(track_launches[k] for k in F32_KERNELS + ("K2-bf16", "K4-bf16"))
            and _all_tap(track_launches),
            f"bf16 tracker launches {track_launches} over {n_track} frames (need K1-bf16 >= 12 "
            f"and K3-bf16 2 per frame, on its tap kernel; no f32 kernel)")
    require(_inside(boxes, H, W), "bf16 tracker: box not finite or outside the frame")
    d_f32 = _centre_px(boxes, f32_boxes)
    ms = secs / (n_track - warm) * 1e3
    emit({"phase": "bf16 tracker", "card": smi, "frames": n_track, "launches": track_launches,
          "ms_per_frame": ms, "fps": 1e3 / ms, "timed_frames": n_track - warm,
          "centre_px_vs_f32_mean": float(d_f32.mean()), "centre_px_vs_f32_max": float(d_f32.max()),
          "last_box": boxes[-1].tolist(),
          "drift_by_kernel": _bf16_drift(frames, f32_boxes, boxes)})
    prof = phase_profile(tracker, all_frames[64:], smi, label="bf16 profile",
                         k1=K1_BF16_KERNELS[0], k3="msda_fwd_kernel")
    model = tracker.model
    del tracker

    name = "synthetic_rgbt_hard"
    seqs = get_dataset(name, n_frames=HARD_FRAMES)
    single = create_tracker(_params(), name, seed=0, dtype=torch.bfloat16)
    bt = _lockstep_twin(single)
    single_eager, bt_eager = _eager_twin(single), _lockstep_twin(single, graphs=False)
    _profile_block(bt, seqs[:EVAL_BIG], 2)                  # first calls of the batch-24 shapes
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        a16 = _eval_run("A16", lambda d: run_dataset(seqs, single, d, chunk=EVAL_CHUNK), seqs,
                        root, runs, kernels=BF16_SERVING)
        b16 = _eval_run(f"B{EVAL_BIG}_16", lambda d: _lockstep_runs(seqs, bt, d, EVAL_BIG), seqs,
                        root, runs, kernels=BF16_SERVING)
        _eval_eager_runs(seqs, root, runs, single_eager, bt_eager, a16, b16,
                         ("A16", f"B{EVAL_BIG}_16"), kernels=BF16_SERVING)
        got = runs[f"B{EVAL_BIG}_16"]["launches"]
        require(got["K3-bf16_by_kernel"]["tap"] == got["K3-bf16"],
                f"bf16 lockstep N={EVAL_BIG}: K3-bf16 kernels {got['K3-bf16_by_kernel']}, "
                f"expected the tap kernel")
        runs[f"B{EVAL_BIG}_16"]["max_abs_px_vs_A16"] = max(
            float(np.abs(b16[k] - a16[k]).max()) for k in a16)
        runs[f"B{EVAL_BIG}_16"]["centre_px_vs_A16_mean"] = float(np.mean(
            [_centre_px(b16[k], a16[k]).mean() for k in a16]))
        runs["A16"]["centre_px_vs_f32_A_mean"] = float(np.mean(
            [_centre_px(a16[k], f32_eval[k]).mean() for k in a16]))
        runs["A16"]["max_abs_px_vs_f32_A"] = max(float(np.abs(a16[k] - f32_eval[k]).max())
                                                 for k in a16)
        scores = {}
        for key in ("A16", f"B{EVAL_BIG}_16"):
            sc = print_results([TrackerResults(os.path.join(root, key), key)], seqs,
                               report_name=f"{name} {key}")
            scores[key] = {k: float(sc[k][0]) for k in ("AUC", "OP50", "OP75", "Precision")}
    names = TRACK_KERNEL_NAMES[torch.bfloat16]
    block = _profile_block(bt, seqs[:EVAL_BIG], EVAL_CHUNK, names)
    block_eager = _profile_block(bt_eager, seqs[:EVAL_BIG], EVAL_CHUNK, names)
    eval_launches = {k: sum(r["launches"][k] for r in runs.values()) for k in BF16_SERVING}
    emit({"phase": "bf16 eval", "card": smi, "dataset": name, "runs": runs,
          "profile_b12_block": block, "profile_b12_block_eager": block_eager,
          "lockstep_graph_capture_ms": {str(k[0]) + ("_update" if k[-1] else ""): v
                                        for k, v in bt.graphs.capture_ms.items()},
          "lockstep_graph_pool_bytes": bt.graphs.pool_bytes(),
          "scores": scores, "launches": eval_launches})
    del bt, bt_eager, single, single_eager, model
    torch.cuda.empty_cache()
    return {"tracker_bf16": {k: track_launches[k] for k in BF16_SERVING},
            "eval_bf16": eval_launches, "profile": prof}


# ------------------------------------------------ online tracker and stage 2
ONLINE_SCRIPT = "asymmetric_shared_online"
#: the dataset whose TEST.UPDATE_INTERVALS entry (25) the online phases use,
#: so that 63 frames hold two commits (synthetic_rgbt_hard's own entry would
#: never update)
ONLINE_INTERVAL_FROM = "TRACKINGNET"
ONLINE_CPU_FRAMES = 8              # frames of the GPU vs CPU online trajectory
ONLINE_CPU_PX = 0.02               # its bound, px (the CPU tests' tracker tolerance)
SCORE_TOL = 1e-4                   # scores, where boxes are held to 1e-4 too
STAGE2_B, STAGE2_F32_B = 64, 16    # the recipe's batch (bf16) and f32's batch
STAGE2_STEPS = 3


def _online_params():
    from multi_modal_tracking_torch.eval.params import get_parameters
    return get_parameters(ONLINE_SCRIPT, RECIPE)


def _score_head_bias(model) -> torch.Tensor:
    return model.score_branch.score_head.layers[-1].bias


def _centre_score_bias(tracker, frames) -> float:
    """Track `frames` eager with the score head's last bias as built, then
    shift the bias by minus the median logit of that run, so that the
    scores of a run land on both sides of 0.5 (random weights put them all
    on one side). Returns the shift."""
    from multi_modal_tracking_torch.tracking.tracker import RGBTOnlineCachedTracker
    probe = RGBTOnlineCachedTracker(tracker.model, **_tracker_kw(tracker), graphs=False)
    s = _online_run(probe, frames)["scores"].astype(np.float64)
    shift = -float(np.median(np.log(s / (1.0 - s))))
    with torch.no_grad():
        _score_head_bias(tracker.model).add_(shift)
    return shift


def _tracker_kw(t) -> dict:
    return dict(template_factor=t.template_factor, template_size=t.template_size,
                search_factor=t.search_factor, search_size=t.search_size,
                update_interval=t.update_interval, max_score_decay=t.max_score_decay,
                ce_keep_rate=None)


def _flat_state(snap: dict) -> dict:
    """A tracker snapshot as {name/i: tensor}, the frame id as a tensor."""
    from multi_modal_tracking_torch.tracking.graphs import leaves
    out = {"_frame_id": torch.tensor(snap["_frame_id"])}
    for k, v in snap.items():
        if k != "_frame_id":
            out.update({f"{k}/{i}": t for i, t in enumerate(leaves(v))})
    return out


def _online_run(tracker, frames, timed_from: int = 9) -> dict:
    """initialize on frames[0], track the rest with `track`: the boxes and
    scores, ms per frame on the host clock from frame `timed_from` on, the
    launches of the run, the state buffers at the end."""
    reset_launches()
    tracker.initialize(list(frames[0]), {"init_bbox": INIT_BOX})
    boxes, scores = [], []
    for i, (fv, fi) in enumerate(frames[1:], start=1):
        if i == timed_from:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = tracker.track([fv, fi])
        boxes.append(out["target_bbox"])
        scores.append(out["pred_score"])
    torch.cuda.synchronize()
    n = len(frames) - timed_from
    return dict(boxes=np.asarray(boxes, np.float32), scores=np.asarray(scores, np.float32),
                ms_per_frame=(time.perf_counter() - t0) / n * 1e3 if n > 0 else None,
                launches=read_launches(), state=_flat_state(tracker.snapshot()))


def _candidates(scores: np.ndarray, interval: int, decay: float) -> tuple:
    """The online trackers' rule replayed on the host over a run's scores
    (frames 1, 2, ...): the frames whose template candidate was taken, and
    per commit (every `interval` frames) whether it installed a taken
    candidate rather than the base template."""
    best, taken, commits, since = np.float32(-1.0), [], [], False
    for k, s in enumerate(scores, start=1):
        best = np.float32(best * np.float32(decay))
        if s > 0.5 and s > best:
            taken.append(k)
            best, since = s, True
        if k % interval == 0:
            commits.append(since)
            best, since = np.float32(-1.0), False
    return taken, commits


def _add_launches(total: dict, counts: dict, keys) -> None:
    for k in keys:
        total[k] = total.get(k, 0) + counts[k]


def _profiled_ms(fn, iters: int = 20) -> tuple:
    """Device ms per call of `fn` from one torch.profiler session of
    `iters` calls (after 3 untimed ones): the summed durations of every
    kernel, copy and memset over `iters`, and the events per call. The
    score branch is about a hundred small kernels, of which a session has been
    seen to lose one or two in twenty calls (device_ms's check); that
    biases the time low by at most their share."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ivals = _device_intervals(prof)
    require(len(ivals) > 0, "the profiler traced no device event")
    return sum(e - s for s, e, _ in ivals) / iters / 1e3, len(ivals) / iters


def _spm_ms(model) -> dict:
    """Device ms (torch.profiler, `_profiled_ms`) of one call of the score
    branch and of its PrRoI pooling at the tracking shapes (the fused 18x18
    search map, the two 8x8 templates stacked, one box), in the model's
    compute dtype."""
    from multi_modal_tracking_torch.models.layers import compute_dtype
    from multi_modal_tracking_torch.ops.prroi import prroi_pool
    dt, c = compute_dtype(model), model.spec.embed_dim
    g = torch.Generator(device="cuda").manual_seed(0)
    fused = torch.randn(1, 18, 18, c, device="cuda", generator=g).to(dt)
    tmpl = torch.randn(1, 16, 8, c, device="cuda", generator=g).to(dt)
    box = torch.tensor([[0.4, 0.42, 0.55, 0.6]], device="cuda")
    rois = torch.cat([torch.zeros(1, 1, device="cuda"), box * 18], dim=1)
    with torch.no_grad():
        spm, spm_ops = _profiled_ms(lambda: model.score_branch(fused, tmpl, box))
        prroi, prroi_ops = _profiled_ms(lambda: prroi_pool(fused, rois, 4, 4))
    return dict(spm_ms=spm, spm_ops_per_call=spm_ops, prroi_ms=prroi,
                prroi_ops_per_call=prroi_ops)


def _online_eval(dtype, bias_shift: float, root: str, runs: dict) -> dict:
    """synthetic_rgbt_hard one stream (run_dataset) and in lockstep N = 12
    (run_sequences_batched with eval.run's online twin) at update interval
    25, the score bias shifted as the tracking run's. f32: trajectories
    within EVAL_PX_TOL of one stream and the `_score.txt` files
    byte-identical. bf16: the distance and the differing score files are
    printed, not bounded: the bf16 kernels and cuBLAS's bf16 GEMMs round
    differently at batch 2 and 24 (K1-bf16's key shares, other GEMM
    kernels), and with random weights the trajectory is chaotic, as for
    the bf16 cached tracker (bf16 phase, `max_abs_px_vs_A16`)."""
    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.run import _batched_twin, main as eval_cli
    from multi_modal_tracking_torch.eval.running import run_dataset
    from multi_modal_tracking_torch.tracking.batched import BatchedRGBTOnlineCachedTracker
    seqs = get_dataset("synthetic_rgbt_hard", n_frames=HARD_FRAMES)
    single = create_tracker(_online_params(), ONLINE_INTERVAL_FROM, seed=0, dtype=dtype)
    with torch.no_grad():
        _score_head_bias(single.model).add_(bias_shift)
    bt = _batched_twin(single, EVAL_CHUNK)
    require(type(bt) is BatchedRGBTOnlineCachedTracker and bt.update_interval == 25,
            f"eval.run's lockstep twin of the online tracker: {type(bt).__name__}")
    kernels = ("K1", "K3") if dtype == torch.float32 else BF16_SERVING
    label = "f32" if dtype == torch.float32 else "bf16"
    _profile_block(bt, seqs[:EVAL_BIG], 2)          # first calls of the batch-24 shapes
    one = _eval_run(f"online_A_{label}", lambda d: run_dataset(seqs, single, d,
                                                               chunk=EVAL_CHUNK),
                    seqs, root, runs, kernels)
    lock = _eval_run(f"online_B12_{label}", lambda d: _lockstep_runs(seqs, bt, d, EVAL_BIG),
                     seqs, root, runs, kernels)
    worst = max(float(np.abs(lock[k] - one[k]).max()) for k in one)
    differ = []
    for s in seqs:
        with open(os.path.join(root, f"online_A_{label}", f"{s.name}_score.txt"), "rb") as fa, \
                open(os.path.join(root, f"online_B12_{label}", f"{s.name}_score.txt"),
                     "rb") as fb:
            if fa.read() != fb.read():
                differ.append(s.name)
    centre = float(np.mean([_centre_px(lock[k], one[k]).mean() for k in one]))
    runs[f"online_B12_{label}"].update(max_abs_px_vs_one_stream=worst,
                                        centre_px_vs_one_stream_mean=centre,
                                        score_files_differing=differ)
    require(dtype != torch.float32 or (worst <= EVAL_PX_TOL and not differ),
            f"online lockstep N={EVAL_BIG} {label}: {worst} px from one stream (bound "
            f"{EVAL_PX_TOL}), score files differing {differ}")
    del bt, single
    torch.cuda.empty_cache()
    return {k: sum(runs[f"online_{w}_{label}"]["launches"][k] for w in ("A", "B12"))
            for k in kernels}


def phase_online(smi: str, frames) -> dict:
    """The online score-gated tracker of asymmetric_shared_online at full
    width (ViT-B, no CE, LNSpecific fusion x 2, CORNER_UP, the SPM), seed-0
    weights, create_tracker -> RGBTOnlineCachedTracker, update interval 25,
    f32 and bf16. The score head's last bias is centred on one eager run
    (`_centre_score_bias`). Then the tracker phase's 63 frames three times
    (graphed with its captures, eager, graphed): boxes, scores and every
    state buffer bit for bit; at least one commit must install a taken
    candidate (the host replays the rule on the scores, and the state's
    online template must differ from the base exactly when the last commit
    did). f32 only: the full-forward RGBTOnlineTracker on the same model
    within 1e-4 px and 1e-4 in score of the cached one, and a CPU tracker on
    the same weights within ONLINE_CPU_PX over ONLINE_CPU_FRAMES frames (its
    forward's boxes and logits within BOX_TOL on one crop). Then 10 more
    frames profiled graphed and eager (device busy, idle share, launches
    against the profiler's kernels), the score branch's and PrRoI's device
    ms, and synthetic_rgbt_hard one stream against lockstep N = 12
    (`_online_eval`). Prints a line per dtype and one per eval; returns the
    launch counts by dtype."""
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.models.build import build_model
    from multi_modal_tracking_torch.tracking.tracker import (RGBTOnlineCachedTracker,
                                                             RGBTOnlineTracker)
    seq = frames[:64]
    H, W = seq[0][0].shape[:2]
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        for dtype, names in TRACK_KERNEL_NAMES.items():
            label = "f32" if dtype == torch.float32 else "bf16"
            kernels = tuple(names)
            total = launches.setdefault(label, {})
            tracker = create_tracker(_online_params(), ONLINE_INTERVAL_FROM, seed=0, dtype=dtype)
            require(type(tracker) is RGBTOnlineCachedTracker and tracker.update_interval == 25
                    and tracker.graphs is not None and tracker.model.with_score,
                    f"create_tracker({ONLINE_SCRIPT}) gave {type(tracker).__name__}")
            shift = _centre_score_bias(tracker, seq)
            eager = RGBTOnlineCachedTracker(tracker.model, **_tracker_kw(tracker), graphs=False)
            runs = [(name, _online_run(tr, seq)) for name, tr in
                    (("graphed_capture", tracker), ("eager", eager), ("graphed", tracker))]
            first = runs[0][1]
            for name, run in runs[1:]:
                diff = [k for k in ("boxes", "scores")
                        if not np.array_equal(run[k].view(np.int32), first[k].view(np.int32))]
                diff += _differing(run["state"], first["state"])
                require(not diff, f"online {label}: {name} run differs from the graphed one in "
                                  f"{diff[:6]}")
                require(run["launches"] == first["launches"],
                        f"online {label}: {name} launches {run['launches']} != graphed "
                        f"{first['launches']}")
            for _, run in runs:
                _add_launches(total, run["launches"], kernels)
            require(all(first["launches"][k] > 0 for k in kernels)
                    and not any(first["launches"][k] for k in F32_KERNELS + BF16_KERNELS
                                if k not in kernels),
                    f"online {label}: launches {first['launches']}")
            require(_inside(first["boxes"].astype(np.float64), H, W)
                    and bool(np.isfinite(first["scores"]).all()),
                    f"online {label}: a box outside the frame or a score not finite")
            taken, commits = _candidates(first["scores"], 25, tracker.max_score_decay)
            require(len(commits) == 2 and any(commits),
                    f"online {label}: commits {commits}, candidates taken at {taken}: no "
                    f"commit installed a taken candidate")
            base = torch.equal(tracker._online, tracker._template)
            require(base == (not commits[-1]),
                    f"online {label}: the online template is{'' if base else ' not'} the base "
                    f"template after the last commit, which the scores say "
                    f"{'took' if commits[-1] else 'did not take'} a candidate")
            res = dict(score_bias_shift=shift, candidates_taken=len(taken),
                       taken_at=taken, commits=len(commits),
                       commits_of_a_taken_candidate=int(sum(commits)),
                       scores_above_half=int((first["scores"] > 0.5).sum()),
                       bit_equal_runs=[name for name, _ in runs[1:]],
                       ms_per_frame={name: r["ms_per_frame"] for name, r in runs},
                       graphs=len(tracker.graphs), graph_pool_bytes=tracker.graphs.pool_bytes(),
                       capture_ms={("search_commit" if k[-1] else "search"): v
                                   for k, v in tracker.graphs.capture_ms.items()})
            if dtype == torch.float32:
                full = RGBTOnlineTracker(tracker.model, **_tracker_kw(tracker))
                fr = _online_run(full, seq)
                _add_launches(total, fr["launches"], kernels)
                d_box = float(np.abs(fr["boxes"] - first["boxes"]).max())
                d_score = float(np.abs(fr["scores"] - first["scores"]).max())
                require(d_box <= BOX_TOL and d_score <= SCORE_TOL,
                        f"online full vs cached: {d_box} px, scores {d_score} apart")
                res.update(full_vs_cached_max_abs_px=d_box, full_vs_cached_max_abs_score=d_score,
                           full_ms_per_frame=fr["ms_per_frame"])
                del full
                cpu_model = build_model(ONLINE_SCRIPT, _online_params().cfg, device="cpu",
                                        seed=0)
                cpu_model.load_state_dict({k: v.cpu() for k, v in
                                           tracker.model.state_dict().items()})
                cpu = RGBTOnlineCachedTracker(cpu_model, **_tracker_kw(tracker), device="cpu")
                cr = _online_run(cpu, seq[:ONLINE_CPU_FRAMES + 1], timed_from=ONLINE_CPU_FRAMES + 1)
                d_cpu = float(np.abs(cr["boxes"] - first["boxes"][:ONLINE_CPU_FRAMES]).max())
                s_cpu = float(np.abs(cr["scores"] - first["scores"][:ONLINE_CPU_FRAMES]).max())
                g = torch.Generator().manual_seed(5)
                ts, ss = tracker.template_size, tracker.search_size
                t, s = torch.randn(2, ts, ts, 3, generator=g), torch.randn(2, ss, ss, 3, generator=g)
                with torch.no_grad():
                    want = cpu_model.forward_track(cpu_model.set_online(t, t), s,
                                                   use_ce_template_mask=False, run_score_head=True)
                    got = tracker.model.forward_track(tracker.model.set_online(t.cuda(), t.cuda()),
                                                      s.cuda(), use_ce_template_mask=False,
                                                      run_score_head=True)
                d_fwd = max(float((got[k].cpu() - want[k]).abs().max())
                            for k in ("pred_boxes", "pred_scores"))
                require(d_cpu <= ONLINE_CPU_PX and s_cpu <= SCORE_TOL and d_fwd <= BOX_TOL,
                        f"online GPU vs CPU: trajectory {d_cpu} px, scores {s_cpu}, forward "
                        f"{d_fwd}")
                res.update(gpu_vs_cpu_frames=ONLINE_CPU_FRAMES, gpu_vs_cpu_max_abs_px=d_cpu,
                           gpu_vs_cpu_max_abs_score=s_cpu, gpu_vs_cpu_forward_max_abs=d_fwd)
                del cpu, cpu_model
            prof = {"graphed": _profile_track(tracker, frames[64:], names),
                    "eager": _profile_track(eager, frames[64:], names)}
            for p in prof.values():
                require(p["launches"] == prof["eager"]["launches"] == p["kernels_by_name"],
                        f"online {label}: launches {p['launches']} against eager "
                        f"{prof['eager']['launches']} and the profiler's kernels "
                        f"{p['kernels_by_name']}")
                _add_launches(total, p["launches"], kernels)
            spm = _spm_ms(tracker.model)
            busy = prof["graphed"]["device_busy_ms_per_frame"]
            res.update(profile=prof, **spm, spm_share_of_busy=spm["spm_ms"] / busy,
                       prroi_share_of_busy=spm["prroi_ms"] / busy)
            del tracker, eager
            torch.cuda.empty_cache()
            emit({"phase": f"online {label}", "card": smi, "script": ONLINE_SCRIPT,
                  "recipe": RECIPE, "frames": len(seq) - 1, "frame_hw": [H, W],
                  "update_interval": 25, **res})
            runs = {}
            _add_launches(total, _online_eval(dtype, shift, root, runs), kernels)
            emit({"phase": f"online eval {label}", "card": smi, "runs": runs,
                  "launches": dict(total)})
    return launches


def _stage2_cfg(batch: int, steps: int):
    """The online recipe (TRAIN_SCORE) with the synthetic set, no val split
    and no warm starts (the stage-1 checkpoint and the MAE file are not in
    the repository)."""
    from multi_modal_tracking_torch.config import get_default_config
    cfg = get_default_config(ONLINE_SCRIPT)
    cfg.update_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "experiments", ONLINE_SCRIPT, f"{RECIPE}.yaml"))
    cfg.DATA.TRAIN.DATASETS_NAME = ["SyntheticRGBT"]
    cfg.DATA.VAL.DATASETS_NAME = []
    cfg.MODEL.BACKBONE.PRETRAINED = False
    cfg.MODEL.TRACKER_PRETRAINED_PATH = ""
    cfg.MODEL.RGBT_PRETRAINED_PATH = ""
    cfg.TRAIN.BATCH_SIZE = batch
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = batch * steps
    return cfg


def _stage2_batches(batch: int, n: int, seed: int = 6) -> list:
    from multi_modal_tracking_torch.train.builders import build_train_loader
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    from multi_modal_tracking_torch.train.train_step import model_inputs
    loader = build_train_loader(_stage2_cfg(batch, n), seed=seed)
    out = [model_inputs(batch_to_model_inputs(b), "cuda") for b in loader]
    require(all({"gt_xyxy", "labels"} <= x.keys() for x in out),
            "stage-2 batches without gt_xyxy or labels")
    return out


def _frozen_check(tr, before: dict) -> dict:
    """After stage-2 steps: every parameter outside the score branch and
    every buffer (BN statistics) the same bits as `before`, and every score
    parameter moved. Then the gradients of the last step, which the
    optimizer clipped in place: the frozen ones nonzero, and the norm of
    all of them min(grad_norm, GRAD_CLIP_NORM), i.e. the printed grad_norm
    and the clip were taken over the frozen gradients too."""
    after = tr.model.state_dict()
    score = {n for n, _ in tr.model.named_parameters() if n.startswith("score_branch.")}
    moved = [k for k in after if not torch.equal(_bits(after[k]), _bits(before[k]))]
    bad = [k for k in moved if k not in score] + [k for k in score if k not in moved]
    require(score and not bad, f"stage 2: frozen tensors moved or score parameters did not: "
                               f"{bad[:6]}")
    names = [n for n, _ in tr.model.named_parameters()]
    grads = dict(zip(names, tr.optimizer.grads))
    norm = lambda ks: float(torch.sqrt(sum((grads[k].double() ** 2).sum() for k in ks)))  # noqa: E731
    frozen = [k for k in names if k not in score]
    g_all, g_score, g_frozen = norm(names), norm(score), norm(frozen)
    reported = tr.history[-1]["grad_norm"] if tr.history else None
    return dict(moved=len(moved), score_tensors=len(score), frozen_unchanged=len(after) - len(moved),
                clipped_grad_norm=g_all, clipped_score_grad_norm=g_score,
                clipped_frozen_grad_norm=g_frozen, reported_grad_norm=reported)


def _score_step_grads(cfg, batch, dev, dtype, state=None):
    """One stage-2 step's forward and backward at batch 2 (the net in eval
    mode, the score loss) on `dev`: (model, loss, grad norm)."""
    from multi_modal_tracking_torch.models.build import build_model
    from multi_modal_tracking_torch.train.losses import score_loss
    from multi_modal_tracking_torch.train.train_step import model_inputs
    m = build_model(ONLINE_SCRIPT, cfg, device=dev, dtype=dtype, seed=0).eval()
    if state is not None:
        m.load_state_dict({k: v.to(dev) for k, v in state.items()})
    x = model_inputs(batch, dev)
    out = m(x["t"], x["ot"], x["s"], None, run_score_head=True, gt_bboxes=x["gt_xyxy"])
    loss, _ = score_loss(out["pred_scores"], x["labels"], cfg.TRAIN.SCORE_WEIGHT)
    loss.backward()
    for p in m.parameters():                # the box head takes no part in stage 2
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    gnorm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in m.parameters())))
    return m, float(loss.detach()), gnorm


def _stage2_timing(tr, x, bf16: bool) -> dict:
    """The isolated step (5 synchronised steps) and a profile of 3, each
    without a keep rate (no CE: the graph key stays that of the steps
    before), and the memory beyond the Trainer's state."""
    step = lambda inputs, _keep: tr._step(inputs, None)    # noqa: E731
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    iso = _isolated_steps(step, x)
    mem = dict(state_gib=_state_bytes(tr) / 2 ** 30,
               step_peak_beyond_state_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30)
    if tr._step.graphs is not None:
        mem["pool_gib"] = tr._step.graphs.pool_bytes() / 2 ** 30
    prof = _profile_steps(step, x, bf16)
    prof.pop("ops_by_name")
    return dict(iso, **prof, memory=mem)


def phase_stage2(smi: str, save_dir: str) -> dict:
    """Stage 2 of the online recipe (TRAIN_SCORE: the SPM score branch
    trains, everything else is frozen and runs in eval mode): a Trainer at
    the recipe's batch 64 in bf16 (its default), graphed, against an eager
    twin (graphs=False) from the same seed over STAGE2_STEPS steps on the
    same batches, bit for bit (weights, buffers, moments, counters,
    generator, metrics); the frozen parameters and BN statistics unchanged
    bit for bit and the score parameters moved (`_frozen_check`); then bf16
    and f32 at batch 16, graphed, the same checks but the twin (f32: K4's
    atomics); one f32 step at batch 2 on the GPU against the CPU. Prints
    ms per step graphed (and eager at batch 64), device busy, idle share
    and memory. Returns the launch counts by dtype."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    from multi_modal_tracking_torch.train.builders import build_train_loader
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    out, launches = {}, {}
    for dtype, batch, twin in ((torch.bfloat16, STAGE2_B, True),
                               (torch.bfloat16, STAGE2_F32_B, False),
                               (torch.float32, STAGE2_F32_B, False)):
        bf16 = dtype == torch.bfloat16
        label = "bf16" if bf16 else "f32"
        run = f"{label}_b{batch}"
        cfg = _stage2_cfg(batch, STAGE2_STEPS)
        kw = {} if bf16 else dict(dtype=dtype)
        tr = Trainer(ONLINE_SCRIPT, cfg, save_dir=save_dir, device="cuda", seed=0,
                     print_interval=STAGE2_STEPS, **kw)
        require(tr._step.train_score and tr.dtype == dtype and tr._step.graphs is not None
                and list(tr.optimizer.groups) == ["main"],
                f"stage 2 {run}: Trainer step {tr._step.train_score}, groups "
                f"{list(tr.optimizer.groups)}")
        batches = _stage2_batches(batch, STAGE2_STEPS)
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        per = TRAIN_LAUNCHES[dtype]
        res = dict(batch=batch)
        if twin:
            eager = Trainer(ONLINE_SCRIPT, cfg, save_dir=save_dir, device="cuda", seed=0,
                            print_interval=STAGE2_STEPS, graphs=False, **kw)
            twin = _graphed_vs_eager(tr, eager, batches, (None,) * STAGE2_STEPS)
            counts = twin["launches"]
            res["graphed_vs_eager"] = twin
        else:
            reset_launches()
            for x in batches:
                tr._step(x, None)
            torch.cuda.synchronize()
            counts = read_launches()
        for k, n in per.items():
            require(counts[k] == n * STAGE2_STEPS,
                    f"stage 2 {run}: {k} launched {counts[k]} times in {STAGE2_STEPS} steps")
        others = [k for k in F32_KERNELS + BF16_KERNELS if k not in per and counts[k]]
        require(not others, f"stage 2 {run}: launched {others}")
        total = launches.setdefault(label, dict.fromkeys(per, 0))
        _add_launches(total, counts, per)
        # the history of one epoch through cycle_dataset: metrics per step
        reset_launches()
        tr.cycle_dataset(build_train_loader(cfg, seed=7))
        _add_launches(total, read_launches(), per)
        losses = [m["Loss/total"] for m in tr.history]
        require(len(losses) == STAGE2_STEPS and all(np.isfinite(losses))
                and set(tr.history[0]) == {"Loss/total", "Loss/scores", "grad_norm"},
                f"stage 2 {run}: epoch metrics {tr.history}")
        check = _frozen_check(tr, before)
        clip = cfg.TRAIN.GRAD_CLIP_NORM
        want = min(check["reported_grad_norm"], clip)
        require(check["clipped_frozen_grad_norm"] > 0.0
                and abs(check["clipped_grad_norm"] - want) <= 1e-3 * want,
                f"stage 2 {run}: the clipped gradients' norm {check['clipped_grad_norm']} is "
                f"not min(grad_norm, {clip}) = {want}, frozen part "
                f"{check['clipped_frozen_grad_norm']}")
        reset_launches()
        res.update(frozen=check, loss=losses, grad_norm=[m["grad_norm"] for m in tr.history],
                   graphed=_stage2_timing(tr, batches[0], bf16))
        _add_launches(total, read_launches(), per)
        if twin:
            res["eager"] = _stage2_timing(eager, batches[0], bf16)
            res["eager_over_graphed"] = (res["eager"]["ms_per_step_median"]
                                         / res["graphed"]["ms_per_step_median"])
            del eager
        res["samples_per_s"] = batch / res["graphed"]["ms_per_step_median"] * 1e3
        out[run] = res
        del tr, batches
        gc.collect()
        torch.cuda.empty_cache()
    # one f32 step at batch 2 on the GPU against the CPU
    cfg = _stage2_cfg(2, 1)
    batch = batch_to_model_inputs(next(iter(build_train_loader(cfg, seed=1))))
    gpu, loss_gpu, gnorm_gpu = _score_step_grads(cfg, batch, "cuda", torch.float32)
    cpu, loss_cpu, gnorm_cpu = _score_step_grads(
        cfg, batch, "cpu", torch.float32, {k: v.cpu() for k, v in gpu.state_dict().items()})
    d_loss, d_norm = abs(loss_gpu - loss_cpu) / abs(loss_cpu), abs(gnorm_gpu - gnorm_cpu) / gnorm_cpu
    ratios, _ = _grads_agree(gpu, cpu)
    require(d_loss <= 1e-3 and d_norm <= 1e-3 and max(ratios.values()) <= 1.0,
            f"stage 2 GPU vs CPU step: loss {d_loss}, grad norm {d_norm}, gradients {ratios}")
    out["gpu_vs_cpu"] = dict(batch=2, loss_gpu=loss_gpu, loss_cpu=loss_cpu, loss_rel_diff=d_loss,
                             grad_norm_gpu=gnorm_gpu, grad_norm_cpu=gnorm_cpu,
                             grad_norm_rel_diff=d_norm, error_over_bound=ratios)
    del gpu, cpu
    torch.cuda.empty_cache()
    emit({"phase": "stage2", "card": smi, "script": ONLINE_SCRIPT, "recipe": RECIPE, **out,
          "launches": launches})
    return launches


# ---------------------------------------------------------------- families
#: the RGB-T families of the families phase: (label, script, the script whose
#: config it builds from, recipe, K1 calls a backbone pass: 12 a ViT, two
#: ViTs in two-stream); the online two-stream model has no default config
#: (in the JAX package neither) and builds from the two-stream one
FAMILIES = (
    ("two_stream", "mixformer_vit_rgbt", "mixformer_vit_rgbt",
     "attention_lasher_newfusion_2layer", 24),
    ("shared", "mixformer_vit_rgbt_shared", "mixformer_vit_rgbt_shared",
     "baseline_attention_lasher_newfusion_2layer", 12),
    ("unibackbone", "mixformer_vit_rgbt_unibackbone", "mixformer_vit_rgbt_unibackbone",
     "baseline", 12),
    ("fusion_cat", "asymmetric_shared", "asymmetric_shared", "attention_lasher_cat_3layer", 12),
    ("two_stream_online", "mixformer_vit_rgbt_online", "mixformer_vit_rgbt",
     "attention_lasher_newfusion_2layer", 24),
)
FAMILY_STEPS = 3                   # bf16 training steps, graphed then eager
#: (B*H, N) of the ViT family's attention: tracking one stream (two-stream:
#: one modality a backbone call; shared and uni: the stack), lockstep N = 12
#: two-stream, training at batch 16 (two-stream, then shared / uni)
VIT_ATTN_BH = (12, 24, 144, 192, 384)
VIT_N = 452                        # 2 x 64 template tokens + 324 search tokens
FUSION_B = 16                      # the fusion table's batch (training)
#: the fusion table's gradients, kernels against plain versions, with G
#: the norm of all of them: each tensor within FUSION_GRAD_REL of its norm
#: plus FUSION_GRAD_FLOOR G, all together within FUSION_GRAD_ALL G, the
#: bounds tests/test_torch_port_train_step.py holds the port to against
#: JAX. The two sides sum in other orders, and where an input of a ReLU
#: (the FFN) or a bilinear corner choice lies near its switch, the switch
#: flips: a weight in front of a ReLU took 1.07e-3 of its norm at
#: Attention_Fusion_1's 768 channels (measured on one H100). A gradient that
#: is zero but for rounding (a conv bias in front of a GroupNorm) is noise
#: on both sides; a missing or wrong backward path gives O(1)
FUSION_GRAD_REL, FUSION_GRAD_FLOOR, FUSION_GRAD_ALL = 5e-2, 1e-6, 1e-2
DEFORM_SHAPES = ((1, 2), (1, 1), (TRAIN_B, 2))   # (batch, deform groups) timed


def _family_params(script: str, cfg_script: str, recipe: str):
    from multi_modal_tracking_torch.eval.params import get_parameters
    params = get_parameters(cfg_script, recipe)
    params.script = script
    return params


def _tracker_twin(t, graphs: bool):
    """A tracker of the same class on the same model and settings."""
    kw = dict(template_factor=t.template_factor, template_size=t.template_size,
              search_factor=t.search_factor, search_size=t.search_size,
              update_interval=t.update_interval, ce_keep_rate=None, device=t.device,
              graphs=graphs)
    if getattr(t, "online", False):
        kw["max_score_decay"] = t.max_score_decay
    return type(t)(t.model, **kw)


def _family_run(tracker, frames, timed_from: int = 9) -> dict:
    """initialize on frames[0], track the rest: boxes (and scores of an
    online tracker), ms per frame on the host clock from frame `timed_from`
    on, the launches of the run."""
    reset_launches()
    tracker.initialize(list(frames[0]), {"init_bbox": INIT_BOX})
    boxes, scores = [], []
    for i, (fv, fi) in enumerate(frames[1:], start=1):
        if i == timed_from:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = tracker.track([fv, fi])
        boxes.append(out["target_bbox"])
        scores.append(out.get("pred_score", 0.0))
    torch.cuda.synchronize()
    return dict(boxes=np.asarray(boxes, np.float32), scores=np.asarray(scores, np.float32),
                ms_per_frame=(time.perf_counter() - t0) / (len(frames) - timed_from) * 1e3,
                launches=read_launches())


def _family_gpu_vs_cpu(model) -> dict:
    """The f32 model's forward (boxes, and scores with the score branch) on
    the card against a copy on the CPU (the kernels' plain versions) on the
    same random crops (batch 1)."""
    g = torch.Generator().manual_seed(9)
    ts, ss = model.spec.template_size, model.spec.search_size
    t, ot = torch.randn(2, ts, ts, 3, generator=g), torch.randn(2, ts, ts, 3, generator=g)
    s = torch.randn(2, ss, ss, 3, generator=g)
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        want = cpu(t, ot, s, run_score_head=True)
        got = model(t.cuda(), ot.cuda(), s.cuda(), run_score_head=True)
    d = {k: float((got[k].cpu() - want[k]).abs().max()) for k in want}
    require(all(bool(torch.isfinite(v).all()) for v in got.values()) and max(d.values()) <= BOX_TOL,
            f"GPU forward vs CPU: {d} (tolerance {BOX_TOL})")
    del cpu
    return d


def _family_tracking(params, dtype, frames, layers: int, blocks: int,
                     n_track: int = 64) -> dict:
    """create_tracker at `dtype` on the family's script, update interval 25:
    the first `n_track` of the 64 frames (63 tracked by default) graphed
    (with its captures), eager (graphs=False, same model) and graphed
    again, bit for bit with the same launches; 10 more frames profiled
    (busy, idle, launches against the profiler's kernels).
    K1 runs at least `blocks` times a frame, K3 `layers` times. Returns
    (line, tracker)."""
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    names = TRACK_KERNEL_NAMES[dtype]
    k1, k3 = names
    tracker = create_tracker(params, ONLINE_INTERVAL_FROM, seed=0, dtype=dtype)
    require(tracker.update_interval == 25 and tracker.graphs is not None,
            f"{params.script}: create_tracker gave {type(tracker).__name__}")
    eager = _tracker_twin(tracker, graphs=False)
    seq = frames[:n_track]
    torch.cuda.reset_peak_memory_stats()
    runs = [(name, _family_run(tr, seq)) for name, tr in
            (("graphed_capture", tracker), ("eager", eager), ("graphed", tracker))]
    first, n = runs[0][1], len(seq) - 1
    for name, run in runs[1:]:
        diff = [k for k in ("boxes", "scores")
                if not np.array_equal(run[k].view(np.int32), first[k].view(np.int32))]
        require(not diff and run["launches"] == first["launches"],
                f"{params.script} {dtype}: {name} run differs from the graphed one in {diff} "
                f"or launches {run['launches']} vs {first['launches']}")
    got = first["launches"]
    others = [k for k in F32_KERNELS + BF16_KERNELS if k not in names and got[k]]
    require(got[k1] >= blocks * n and got[k3] == layers * n and not others,
            f"{params.script} {dtype}: launches {got} over {n} frames ({blocks} {k1} a frame "
            f"at least, {layers} {k3})")
    H, W = seq[0][0].shape[:2]
    require(_inside(first["boxes"].astype(np.float64), H, W) and
            bool(np.isfinite(first["scores"]).all()),
            f"{params.script} {dtype}: a box outside the frame or a score not finite")
    prof = _profile_track(tracker, frames[64:], names)
    require(prof["launches"] == prof["kernels_by_name"],
            f"{params.script} {dtype}: launches {prof['launches']} against the profiler's "
            f"kernels {prof['kernels_by_name']}")
    out = dict(tracker=type(tracker).__name__, frames=n, bit_equal_runs=["eager", "graphed"],
               launches=got, ms_per_frame={name: r["ms_per_frame"] for name, r in runs},
               graphs=len(tracker.graphs), graph_pool_bytes=tracker.graphs.pool_bytes(),
               peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30, profile=prof)
    return out, tracker


def _family_train_cfg(cfg_script: str, recipe: str, steps: int):
    """The recipe at batch 16 on the synthetic set: no val split, no warm
    starts (the MAE and unimodal files are not in the repository)."""
    from multi_modal_tracking_torch.config import get_default_config
    cfg = get_default_config(cfg_script)
    cfg.update_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "experiments", cfg_script, f"{recipe}.yaml"))
    cfg.DATA.TRAIN.DATASETS_NAME = ["SyntheticRGBT"]
    cfg.DATA.VAL.DATASETS_NAME = []
    cfg.MODEL.BACKBONE.PRETRAINED = False
    cfg.MODEL.RGBT_PRETRAINED_PATH = ""
    cfg.TRAIN.BATCH_SIZE = TRAIN_B
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = TRAIN_B * steps
    return cfg


def _cloned_state(tr) -> dict:
    return {k: v.detach().clone() for k, v in _train_state(tr).items()}


def _graphed_vs_eager_in_place(tr, batches) -> dict:
    """The steps graphed, then, from the state before them (model, AdamW,
    counters and generator loaded back in place), the same steps eager on
    the same Trainer (its step's graphs set aside): weights, BN buffers
    and statistics, moments, counters, generator state and every step's
    metrics the same bits, and the same launches."""
    # copies: on the CPU the optimizer's state_dict holds its live moments
    before = ({k: v.clone() for k, v in tr.model.state_dict().items()},
              copy.deepcopy(tr.optimizer.state_dict()), tr.generator.get_state())
    graphs, runs = tr._step.graphs, {}
    for name in ("graphed", "eager"):
        if name == "eager":
            tr.model.load_state_dict(before[0])
            tr.optimizer.load_state_dict(before[1])
            tr.generator.set_state(before[2])
            tr._step.graphs = None
        reset_launches()
        metrics = [tr._step(x, None) for x in batches]
        torch.cuda.synchronize()
        runs[name] = ({f"step{i}/{k}": v for i, m in enumerate(metrics) for k, v in m.items()},
                      read_launches(), _cloned_state(tr))
    tr._step.graphs = graphs
    (mg, lg, sg), (me, le, se) = runs["graphed"], runs["eager"]
    diff = _differing(sg, se) + _differing(mg, me)
    require(not diff and lg == le, f"graphed and eager training differ in {diff[:6]} or in "
                                   f"launches {lg} vs {le}")
    losses = [float(mg[f"step{i}/Loss/total"]) for i in range(len(batches))]
    require(all(np.isfinite(losses)) and len(set(losses)) > 1, f"losses {losses}")
    return dict(check="graphed == eager, bit for bit", steps=len(batches),
                tensors_compared=len(sg) + len(mg), launches=lg, loss=losses,
                graphs=len(graphs or ()))


def _f32_graphed_vs_eager_in_place(tr, batches) -> dict:
    """The f32 form of `_graphed_vs_eager_in_place`. An f32 step is not
    repeatable bit for bit even without K4 (two eager runs are compared
    below), so it follows the flagship's f32 check (`_graphed_vs_eager`):
    the steps graphed, then twice eager, each from the state before them
    loaded back in place; the counters, the generator state, the BN batch
    counts and the first step's forward metrics the same bits, the same
    launches, the runs' distances printed; then, from one state, one
    replay against one eager step on the last batch, held to
    `_one_replay_f32`'s bounds (forward and BN statistics the same bits,
    gradients within F32_GRAD_REL of their norm, weights and moments after
    the update within F32_WEIGHTS_REL and F32_MOMENTS_REL)."""
    graphs = tr._step.graphs

    def load(state):
        tr.model.load_state_dict(state[0])
        tr.optimizer.load_state_dict(state[1])
        tr.generator.set_state(state[2])

    def saved():
        return ({k: v.clone() for k, v in tr.model.state_dict().items()},
                copy.deepcopy(tr.optimizer.state_dict()), tr.generator.get_state())

    before, runs = saved(), {}
    for name in ("graphed", "eager", "eager2"):
        load(before)
        tr._step.graphs = graphs if name == "graphed" else None
        reset_launches()
        metrics = [tr._step(x, None) for x in batches]
        torch.cuda.synchronize()
        runs[name] = ({f"step{i}/{k}": v for i, m in enumerate(metrics) for k, v in m.items()},
                      read_launches(), _cloned_state(tr))
    (mg, lg, g), (me, le, e), (_, le2, e2) = runs["graphed"], runs["eager"], runs["eager2"]
    exact = [k for k in g if k in ("counters", "generator") or k.endswith("num_batches_tracked")]
    first = [f"step0/{k}" for k in ("Loss/total", "Loss/ciou", "Loss/l1", "IoU")]
    diff = _differing({k: g[k] for k in exact}, {k: e[k] for k in exact}) + _differing(
        {k: mg[k] for k in first}, {k: me[k] for k in first})
    require(not diff and lg == le == le2,
            f"graphed and eager f32 training differ in {diff} or launches {lg} vs {le} vs {le2}")
    losses = [float(mg[f"step{i}/Loss/total"]) for i in range(len(batches))]
    require(all(np.isfinite(losses)) and len(set(losses)) > 1, f"losses {losses}")
    dist = {f"{what}_{pair}": _rel_dist(x, y, prefixes)
            for what, prefixes in (("weights", ("net/",)), ("moments", ("mu/", "nu/")))
            for pair, x, y in (("graphed_eager", g, e), ("eager_eager2", e, e2))}

    # one step from one state: a replay, then the same step eager
    state, one = saved(), {}
    for name in ("graphed", "eager"):
        load(state)
        tr._step.graphs = graphs if name == "graphed" else None
        m = tr._step(batches[-1], None)
        torch.cuda.synchronize()
        one[name] = (m, _cloned_state(tr), {k: t.clone() for k, t in _grads(tr).items()})
    tr._step.graphs = graphs
    return dict(check="f32: counters, generator, BN counts, first forward bit for bit",
                steps=len(batches), launches=lg, loss=losses, graphs=len(graphs or ()),
                eager_runs_same_bits=not _differing(e, e2),
                tensors_differing_graphed_eager=len(_differing(g, e)), rel_dist_after_steps=dist,
                one_replay=_one_step_bounds(one["graphed"], one["eager"]))


def _family_training(script: str, cfg_script: str, recipe: str, save_dir: str,
                     layers: int, blocks: int) -> tuple:
    """The Trainer's default (bf16, graphed) at batch 16: FAMILY_STEPS steps
    graphed against eager (`_graphed_vs_eager_in_place`), `blocks` K1-bf16
    and K2-bf16 and `layers` K3-bf16 and K4-bf16 launches a step, one
    AdamW update; then ms per step, busy, idle and memory
    (`_stage2_timing`). Returns (line, launches)."""
    from multi_modal_tracking_torch.train.builders import build_train_loader
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    from multi_modal_tracking_torch.train.train_step import model_inputs
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg = _family_train_cfg(cfg_script, recipe, FAMILY_STEPS)
    tr = Trainer(script, cfg, save_dir=save_dir, device="cuda", seed=0,
                 print_interval=FAMILY_STEPS)
    require(tr.dtype == torch.bfloat16 and tr._step.graphs is not None
            and tr._keep_rate(1) is None, f"{script}: Trainer {tr.dtype}, keep {tr._keep_rate(1)}")
    batches = [model_inputs(batch_to_model_inputs(b), "cuda")
               for b in build_train_loader(cfg, seed=4)]
    twin = _graphed_vs_eager_in_place(tr, batches)
    got, steps = twin["launches"], FAMILY_STEPS
    want = {"K1-bf16": blocks * steps, "K2-bf16": blocks * steps, "K3-bf16": layers * steps,
            "K4-bf16": layers * steps, "AdamW": steps}
    require(all(got[k] == v for k, v in want.items())
            and not any(got[k] for k in F32_KERNELS), f"{script} training: launches {got}, "
                                                      f"expected {want}")
    reset_launches()
    timing = _stage2_timing(tr, batches[0], True)
    launches = {k: got[k] + read_launches()[k] for k in BF16_KERNELS + ("AdamW",)}
    line = dict(batch=TRAIN_B, dtype="bf16", graphed_vs_eager=twin, **timing,
                regime={g: tr.optimizer.mults[g] for g in tr.optimizer.groups},
                params=sum(p.numel() for p in tr.model.parameters()),
                samples_per_s=TRAIN_B / timing["ms_per_step_median"] * 1e3)
    del tr, batches
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches


def _family_lockstep(params, root: str) -> tuple:
    """Two-stream lockstep N = 12 at bf16 on synthetic_rgbt_hard through the
    CLI's twin of create_tracker's tracker (eval.run._batched_twin: the
    full-forward BatchedRGBTTracker): frames/s, a profiled block; then the
    same through `python -m multi_modal_tracking_torch.eval.run
    mixformer_vit_rgbt attention_lasher_newfusion_2layer --dataset_name
    synthetic_rgbt_hard --batch_sequences 12` (its main, in process):
    a result file per sequence, the bf16 kernels launched."""
    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.run import _batched_twin, main as eval_cli
    from multi_modal_tracking_torch.tracking.batched import BatchedRGBTTracker
    name = "synthetic_rgbt_hard"
    seqs = get_dataset(name, n_frames=HARD_FRAMES)
    tracker = create_tracker(params, name, seed=0)              # bf16, the default
    bt = _batched_twin(tracker, EVAL_CHUNK)
    require(type(bt) is BatchedRGBTTracker and bt.graphs is not None,
            f"lockstep twin {type(bt).__name__}")
    _profile_block(bt, seqs[:EVAL_BIG], 2)                      # first calls untimed
    runs = {}
    _eval_run("B12_bf16", lambda d: _lockstep_runs(seqs, bt, d, EVAL_BIG), seqs, root, runs,
              kernels=("K1-bf16", "K3-bf16"))
    launches = dict(runs["B12_bf16"]["launches"])
    reset_launches()
    prof = _profile_block(bt, seqs[:EVAL_BIG], EVAL_CHUNK)
    for k in ("K1-bf16", "K3-bf16"):
        launches[k] += read_launches()[k]
    del bt, tracker
    torch.cuda.empty_cache()
    # the same through the command line a user runs
    reset_launches()
    t0 = time.perf_counter()
    dirs = eval_cli([params.script, "attention_lasher_newfusion_2layer", "--dataset_name", name,
                     "--batch_sequences", str(EVAL_BIG), "--results_dir",
                     os.path.join(root, "cli")])
    cli = dict(seconds=time.perf_counter() - t0, launches=read_launches())
    require(len(dirs) == 1 and all(os.path.isfile(os.path.join(dirs[0], f"{s.name}.txt"))
                                   for s in seqs)
            and cli["launches"]["K1-bf16"] > 0 and cli["launches"]["K3-bf16"] > 0
            and not any(cli["launches"][k] for k in F32_KERNELS),
            f"eval.run {params.script} --batch_sequences {EVAL_BIG}: {dirs}, {cli['launches']}")
    for k in ("K1-bf16", "K3-bf16"):
        launches[k] += cli["launches"][k]
    torch.cuda.empty_cache()
    return dict(dataset=name, run=runs["B12_bf16"], profile_block=prof, cli=cli), launches


def _plain_msda_fusion(fusion_module, bf16: bool):
    """The fusion module's MSDA call swapped for the plain version (on the
    same CUDA tensors, differentiable by autograd); returns the kernel to
    put back."""
    from multi_modal_tracking_torch.ops.msda import ms_deform_attn_bf16_ref, ms_deform_attn_ref
    kernel = fusion_module.ms_deform_attn
    fusion_module.ms_deform_attn = ms_deform_attn_bf16_ref if bf16 else ms_deform_attn_ref
    return kernel


def _fusion_zoo(g: torch.Generator) -> tuple:
    """All 11 FUSION_CLASS entries at full width (channels 768, d_model 512,
    2 layers; Attention_Fusion_1 at d_model 768, MSDA head dim 96) at batch
    16 on two 18x18 maps, f32, in training mode without dropout: the output
    and the gradients of the inputs and every parameter with K3 and K4
    against the same module with MSDA's plain version on the same CUDA
    tensors (FUSION_GRAD_*); the module on the CPU beside it for the
    forward (batch 2, eval mode). ms of a forward + backward (CUDA events).
    Returns (rows, launches)."""
    import multi_modal_tracking_torch.models.fusion as fusion_module
    from multi_modal_tracking_torch.models.build import init_random
    from multi_modal_tracking_torch.models.fusion import FUSION_CLASSES, build_fusion
    rows, launches = [], dict.fromkeys(F32_KERNELS, 0)
    x_v = torch.randn(FUSION_B, 18, 18, 768, generator=g).cuda()
    x_i = torch.randn(FUSION_B, 18, 18, 768, generator=g).cuda()
    proj = torch.randn(FUSION_B, 18, 18, 768, generator=g).cuda()
    for cls in FUSION_CLASSES:
        mod = init_random(build_fusion(cls, 768, 512, 2, dropout=0.0), 0)
        with torch.no_grad():               # act the zero-initialised offset kernels
            for p in mod.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g))
        mod = mod.cuda().train()
        state = {k: v.clone() for k, v in mod.state_dict().items()}

        def fwd_bwd():
            mod.zero_grad(set_to_none=True)
            a, b = x_v.clone().requires_grad_(), x_i.clone().requires_grad_()
            out = mod(a, b)
            (out * proj).sum().backward()
            return [out.detach(), a.grad, b.grad] + [p.grad for p in mod.parameters()]

        reset_launches()
        got = fwd_bwd()
        counts = read_launches()
        for k in F32_KERNELS:
            launches[k] += counts[k]
        mod.load_state_dict(state)
        kernel = _plain_msda_fusion(fusion_module, False)
        try:
            want = fwd_bwd()
        finally:
            fusion_module.ms_deform_attn = kernel
        mod.load_state_dict(state)
        err, _, ok = max_err(got[0], want[0])
        names = ["x_v", "x_i"] + [n for n, _ in mod.named_parameters()]
        G = float(torch.sqrt(sum((b.double() ** 2).sum() for b in want[1:])))
        apart = {n: float((a - b).double().norm()) for n, a, b in zip(names, got[1:], want[1:])}
        dist = {n: apart[n] / (float(b.norm()) + FUSION_GRAD_FLOOR / FUSION_GRAD_REL * G)
                for n, b in zip(names, want[1:])}
        worst = max(dist, key=dist.get)
        g_all = float(np.sqrt(sum(v ** 2 for v in apart.values()))) / G
        g_err, g_ok = dist[worst], dist[worst] <= FUSION_GRAD_REL and g_all <= FUSION_GRAD_ALL
        attention = cls.startswith("Attention")
        require(ok and g_ok and (counts["K3"] == counts["K4"] == 2) == attention,
                f"fusion {cls}: output error {err}, gradient {worst} {g_err} of its norm "
                f"apart, all {g_all} of theirs, launches {counts}")
        with torch.no_grad():
            cpu = copy.deepcopy(mod).cpu().eval()
            d_cpu = float((cpu(x_v[:2].cpu(), x_i[:2].cpu()) - mod.eval()(x_v[:2], x_i[:2]).cpu())
                          .abs().max())
            mod.train()
        require(d_cpu <= 1e-4, f"fusion {cls}: GPU vs CPU forward {d_cpu}")
        rows.append(dict(fusion_class=cls, out_max_abs_err=err, grad_max_rel_dist=g_err,
                         grad_worst=worst, grad_all_rel_dist=g_all,
                         gpu_vs_cpu_max_abs=d_cpu, launches=counts,
                         msda_head_dim=(768 if cls == "Attention_Fusion_1" else 512) // 8
                         if attention else None,
                         fwd_bwd_event_ms=cuda_time_ms(fwd_bwd, iters=5, warmup=1),
                         params=sum(p.numel() for p in mod.parameters())))
        mod.load_state_dict(state)
        del mod, cpu, got, want
    torch.cuda.empty_cache()
    return rows, launches


def _vit_attention_checks(g: torch.Generator) -> list:
    """K1 and K1-bf16 at the ViT family's shapes (N 452, n_mt 128: the plain
    ViT's mixed attention, VIT_ATTN_BH) against their plain versions, the
    plans printed, ms per call (CUDA events over 50 calls); K2 and K2-bf16
    at the training shapes (B*H 192, 384)."""
    from multi_modal_tracking_torch.ops.attention import (
        attention_bf16_plan, mixed_attention_bf16, mixed_attention_bf16_ref,
        mixed_attention_bwd, mixed_attention_bwd_bf16, mixed_attention_bwd_bf16_ref,
        mixed_attention_bwd_ref, mixed_attention_fwd, mixed_attention_ref, query_warps)
    scale, n_sm, rows = HEAD_D ** -0.5, torch.cuda.get_device_properties(0).multi_processor_count, []
    for bh in VIT_ATTN_BH:
        B = bh // HEADS
        q, k, v = _qkv(B, HEADS, VIT_N, VIT_N, HEAD_D, g)
        out, lse = mixed_attention_fwd(q, k, v, N_MT, scale, return_lse=True)
        err, _, ok = max_err(out, mixed_attention_ref(q, k, v, N_MT, scale))
        require(ok, f"K1 B*H={bh} N={VIT_N} disagrees with its plain version: {err}")
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        errs = _bf16_errors(f"K1-bf16 B*H={bh} N={VIT_N}",
                            mixed_attention_bf16(qb, kb, vb, N_MT, scale),
                            mixed_attention_bf16_ref(qb, kb, vb, N_MT, scale),
                            mixed_attention_ref(qb.float(), kb.float(), vb.float(), N_MT, scale),
                            vb)
        row = dict(BH=bh, Nq=VIT_N, Nk=VIT_N, n_mt=N_MT, k1_max_abs_err=err,
                   k1_query_warps=query_warps(bh, VIT_N, n_sm),
                   k1_bf16_key_shares=attention_bf16_plan(bh, VIT_N, VIT_N, n_sm),
                   k1_bf16=errs,
                   k1_event_ms=cuda_time_ms(lambda: mixed_attention_fwd(q, k, v, N_MT, scale)),
                   k1_bf16_event_ms=cuda_time_ms(
                       lambda: mixed_attention_bf16(qb, kb, vb, N_MT, scale)))
        if bh >= 192:
            gr = torch.randn(B, HEADS, VIT_N, HEAD_D, generator=g).cuda()
            got = mixed_attention_bwd(q, k, v, out, gr, N_MT, scale, lse)
            want = mixed_attention_bwd_ref(q, k, v, gr, N_MT, scale)
            e2 = [max_err_scaled(a, b) for a, b in zip(got, want)]
            require(all(e[2] for e in e2), f"K2 B*H={bh}: {[e[0] for e in e2]}")
            _, lse_b = mixed_attention_bf16(qb, kb, vb, N_MT, scale, return_lse=True)
            grb = gr.to(torch.bfloat16)
            gotb = mixed_attention_bwd_bf16(qb, kb, vb, grb, N_MT, scale, lse_b)
            plainb = mixed_attention_bwd_bf16_ref(qb, kb, vb, grb, N_MT, scale)
            e2b = [max_err(a.float(), b.float(), bf16_tol(b)) for a, b in zip(gotb, plainb)]
            require(all(e[2] for e in e2b), f"K2-bf16 B*H={bh}: {[e[0] for e in e2b]}")
            row.update(k2_max_abs_err=[e[0] for e in e2], k2_bf16_max_abs_err=[e[0] for e in e2b])
        rows.append(row)
    return rows


def _msda_d96_checks(g: torch.Generator) -> list:
    """K3, K4, K3-bf16 and K4-bf16 at Attention_Fusion_1's head dim 96
    (d_model 768 / 8 heads) on the fusion's two 18x18 levels, at batch 1
    and 16, uniform and model-like locations, against their plain versions;
    msda_plan's choice printed (f32: gather and direct, the shared memory
    holds no 648 x 96 slice; bf16: gather and direct, the tap kernels take
    D 64)."""
    from multi_modal_tracking_torch.ops.msda import (ms_deform_attn_bf16, ms_deform_attn_bf16_ref,
                                                     ms_deform_attn_bwd, ms_deform_attn_bwd_ref,
                                                     ms_deform_attn_fwd, ms_deform_attn_ref)
    from multi_modal_tracking_torch.ops.msda import msda_plan
    D, Lq, rows = 96, 648, []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (1, TRAIN_B):
        for locations in ("uniform", "model"):
            value, loc, attw = _msda_inputs(B, MSDA_SHAPES, Lq, M_HEADS, D, M_P, g, -0.1, 1.1)
            if locations == "model":
                loc = _model_locations(B, MSDA_SHAPES, M_HEADS, M_P, g)
            gr = torch.randn(B, Lq, M_HEADS * D, generator=g).cuda()
            err3, _, ok3 = max_err(ms_deform_attn_fwd(value, MSDA_SHAPES, loc, attw),
                                   ms_deform_attn_ref(value, MSDA_SHAPES, loc, attw))
            e4 = [max_err_scaled(a, b) for a, b in
                  zip(ms_deform_attn_bwd(value, MSDA_SHAPES, loc, attw, gr),
                      ms_deform_attn_bwd_ref(value, MSDA_SHAPES, loc, attw, gr))]
            require(ok3 and all(e[2] for e in e4),
                    f"K3/K4 D=96 B={B} {locations}: {err3}, {[e[0] for e in e4]}")
            vb, ab, gb = value.to(torch.bfloat16), attw.to(torch.bfloat16), gr.to(torch.bfloat16)
            errs3 = _bf16_errors(f"K3-bf16 D=96 B={B} {locations}",
                                 ms_deform_attn_bf16(vb, MSDA_SHAPES, loc, ab),
                                 ms_deform_attn_bf16_ref(vb, MSDA_SHAPES, loc, ab),
                                 ms_deform_attn_ref(vb.float(), MSDA_SHAPES, loc, ab.float()),
                                 vb, exact=True)
            errs4 = _k4_bf16_case(f"K4-bf16 D=96 B={B} {locations}", vb, MSDA_SHAPES, loc, ab,
                                  gb, tap_only=False)
            p32 = msda_plan(B, M_HEADS, D, MSDA_SHAPES, n_sm)
            p16 = msda_plan(B, M_HEADS, D, MSDA_SHAPES, n_sm, itemsize=2, Lq=Lq, P=M_P)
            rows.append(dict(B=B, D=D, Lq=Lq, locations=locations, k3_max_abs_err=err3,
                             k4_max_abs_err=[e[0] for e in e4], k3_bf16=errs3, k4_bf16=errs4,
                             plan_f32=p32._asdict(), plan_bf16=p16._asdict()))
    return rows


def _deform_conv_ms(g: torch.Generator) -> list:
    """The modulated deformable conv (plain PyTorch, ops/deform_conv.py) at
    the deform fusions' shape (2 x 768 channels in, 768 out, 18x18, 3x3):
    device ms (CUDA events over 10 calls) of a forward at tracking batch 1
    (deform groups 2 and 1; a CUDA graph replayed) and of forward +
    backward at training batch 16 (eager); one call a frame or step."""
    from multi_modal_tracking_torch.ops.deform_conv import modulated_deform_conv2d
    rows = []
    for B, dg in DEFORM_SHAPES:
        x = torch.randn(B, 18, 18, 1536, generator=g).cuda()
        off = (2 * torch.randn(B, 18, 18, dg * 18, generator=g)).cuda()
        mask = torch.rand(B, 18, 18, dg * 9, generator=g).cuda()
        w = (0.01 * torch.randn(768, 1536, 3, 3, generator=g)).cuda()
        if B == 1:
            # a CUDA graph of the forward, replayed: the eager call's ~100
            # small kernels are paced by the host at batch 1, and a graph
            # replay is what the tracker's frame runs
            torch.cuda.synchronize()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                modulated_deform_conv2d(x, off, mask, w, deform_groups=dg)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                modulated_deform_conv2d(x, off, mask, w, deform_groups=dg)
            fn = graph.replay
        else:
            xs = [t.requires_grad_() for t in (x, off, mask, w)]

            def fn():
                modulated_deform_conv2d(*xs, deform_groups=dg).sum().backward()
        flops = 2.0 * B * 18 * 18 * 9 * 1536 * 768 * (1 if B == 1 else 3)
        rows.append(dict(batch=B, deform_groups=dg, what="forward" if B == 1 else
                         "forward+backward", event_ms=cuda_time_ms(fn, iters=10),
                         matmul_flops=flops, calls_per=("frame" if B == 1 else "step")))
    return rows


def phase_families(smi: str, frames, save_dir: str) -> dict:
    """The RGB-T families beside the flagship (FAMILIES) at full width
    (ViT-B, template 128, search 288, fusion d_model 512, the recipes'
    heads), seeded random weights. For each: the f32 forward on the card
    against the same model on the CPU (BOX_TOL); create_tracker's tracker
    at f32 and bf16 on the tracker phase's 63 frames, graphed against eager
    bit for bit (`_family_tracking`); a few bf16 batch-16 Trainer steps
    graphed against eager bit for bit, BN statistics included
    (`_family_training`). Then two-stream lockstep N = 12 at bf16 on
    synthetic_rgbt_hard; the 11 fusion classes at full width against their
    plain versions (`_fusion_zoo`); K1 / K1-bf16 at the ViT shapes and K3 /
    K4 and their bf16 forms at head dim 96 against their plain versions;
    the deformable conv's device ms. Returns the launch counts: f32 and
    bf16."""
    g = torch.Generator().manual_seed(15)
    f32 = dict.fromkeys(F32_KERNELS, 0)
    bf16 = dict.fromkeys(BF16_KERNELS + ("AdamW",), 0)
    for label, script, cfg_script, recipe, blocks in FAMILIES:
        t0 = time.perf_counter()
        params = _family_params(script, cfg_script, recipe)
        layers = 0 if params.cfg.MODEL.FUSION_CLASS.startswith("RGBT_Fusion") \
            else params.cfg.MODEL.FUSION_LAYERS
        res = {}
        for dtype, total in ((torch.float32, f32), (torch.bfloat16, bf16)):
            line, tracker = _family_tracking(params, dtype, frames, layers, blocks)
            _add_launches(total, line["launches"], TRACK_KERNEL_NAMES[dtype])
            _add_launches(total, line["profile"]["launches"], TRACK_KERNEL_NAMES[dtype])
            if dtype == torch.float32:
                res["gpu_vs_cpu_max_abs"] = _family_gpu_vs_cpu(tracker.model)
                res["params"] = sum(p.numel() for p in tracker.model.parameters())
            res[f"track_{'f32' if dtype == torch.float32 else 'bf16'}"] = line
            del tracker
            torch.cuda.empty_cache()
        res["train_bf16"], counts = _family_training(script, cfg_script, recipe, save_dir,
                                                     layers, blocks)
        _add_launches(bf16, counts, counts)
        emit({"phase": f"families {label}", "card": smi, "script": script,
              "recipe": f"{cfg_script}/{recipe}", "fusion_class": params.cfg.MODEL.FUSION_CLASS,
              "head_type": params.cfg.MODEL.HEAD_TYPE, "tolerance": BOX_TOL, **res,
              "seconds": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory() as root:
        line, counts = _family_lockstep(_family_params(*FAMILIES[0][1:4]), root)
    _add_launches(bf16, counts, ("K1-bf16", "K3-bf16"))
    emit({"phase": "families lockstep", "card": smi, "script": FAMILIES[0][1], **line})
    emit({"phase": "families kernel shapes", "card": smi,
          "k1_vit": _vit_attention_checks(g), "msda_d96": _msda_d96_checks(g)})
    emit({"phase": "families deform conv", "card": smi, "cases": _deform_conv_ms(g)})
    rows, counts = _fusion_zoo(g)
    _add_launches(f32, counts, F32_KERNELS)
    emit({"phase": "families fusion table", "card": smi, "batch": FUSION_B,
          "tolerance": dict(out=KERNEL_TOL, grad_rel_dist=FUSION_GRAD_REL,
                            grad_floor_of_norm=FUSION_GRAD_FLOOR,
                            grad_all_of_norm=FUSION_GRAD_ALL), "classes": rows})
    return {"f32": f32, "bf16": bf16}


# ---------------------------------------------------------------- unimodal
UNI_SCRIPT, UNI_ONLINE = "mixformer_vit", "mixformer_vit_online"
UNI_B, UNI_LARGE_B = 32, 12        # the recipes' batches (ViT-B, ViT-L)
UNI_STEPS = 3                      # bf16 training steps, graphed then eager
MODES = ("RGB", "TIR", "Prompt")
#: cached tracker against the full forward over the 63 frames (px): the
#: cached path attends through the plain f32 einsum, the full forward
#: through K1 (3xTF32), so each frame's box differs by rounding (~1e-5 of
#: the 288 px crop), and the chaotic random-weight trajectory may carry it
#: along; this is eval's lockstep bound, where the same holds
UNI_CACHED_PX = EVAL_PX_TOL
UNI_LOCKSTEP_PX = 1e-3             # f32 lockstep N = 12 against one stream, px
#: (B*H, N, n_mt) of K1 / K2 on this phase's paths at ViT-L's recipe shapes
#: (template 192: 2 x 144 template tokens; search 384: 576 tokens): one
#: stream tracked by the RGB-T ViT-L (one backbone a call), training at
#: batch 12; and ViT-B's training at batch 32 (N 452, n_mt 128)
UNI_ATTN = ((16, 864, 288), (192, 864, 288), (384, 452, 128))
#: the drift check's control: the lockstep run's attention scale times
#: 1 ± each factor; the drift phase also at these score-bias offsets
DRIFT_FACTORS = (2.0 ** -18, 2.0 ** -20, 2.0 ** -22)
DRIFT_OFFSETS = (0.0, 0.5, -0.5)


def _uni_tracker(params, dtype, mode: str, seed: int = 0):
    """create_tracker on a unimodal script at update interval 25
    (ONLINE_INTERVAL_FROM; online size 3 for the online one)."""
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    return create_tracker(params, ONLINE_INTERVAL_FROM, seed=seed, dtype=dtype, mode=mode)


def _uni_twin(t, graphs: bool):
    """A tracker of the same class on the same model and settings."""
    kw = dict(template_factor=t.template_factor, template_size=t.template_size,
              search_factor=t.search_factor, search_size=t.search_size,
              update_interval=t.update_interval, mode=t.mode, device=t.device, graphs=graphs)
    if t.online:
        kw.update(online_size=t.online_size, max_score_decay=t.max_score_decay)
    return type(t)(t.model, **kw)


def _uni_run(tracker, frames) -> dict:
    """`_family_run` with the online tracker's ring at the end."""
    out = _family_run(tracker, frames)
    out["state"] = _flat_state(tracker.snapshot())
    if tracker.online:
        out["n_filled"], out["forget_id"] = int(tracker._n_filled), int(tracker._forget_id)
    return out


def _aligned(names_e: list, names_g: list) -> tuple:
    """(what was matched, eager positions, graphed positions) of two device
    operation sequences: every operation, or where they differ (a graph's
    copies and memsets may be traced otherwise) the kernels alone; the
    positions are None where even those differ."""
    if names_e == names_g:
        return "every operation", range(len(names_e)), range(len(names_g))
    kernel = lambda names: [i for i, m in enumerate(names)      # noqa: E731
                            if not m.startswith(("Memcpy", "Memset"))]
    idx_e, idx_g = kernel(names_e), kernel(names_g)
    if [names_e[i] for i in idx_e] == [names_g[i] for i in idx_g]:
        return "kernels", idx_e, idx_g
    return "kernels", None, None


def _attend_in_frames(eager, snap: dict, frames, graphed: list, busy_ms: float) -> dict:
    """Device ms a frame of the cached path's plain attention (models/vit.py
    `_attend`, an einsum, a masked f32 softmax and an einsum a block) in the
    profiled graphed frames (`graphed`, `_profile_track`'s intervals, and
    their busy ms a frame), and its share of that busy time. A graph
    replay's kernels carry no host call, so they are found by position:
    the eager twin tracks the same frames from the same state (`snap`)
    under torch.profiler with every `_attend` call in a record_function
    range; the device operations launched inside those ranges mark
    positions in the eager run's sequence, and the graphed run's
    operations at those positions are `_attend`'s, where the two name
    sequences are the same (`_aligned`). The eager run's own figures are
    printed beside them."""
    import multi_modal_tracking_torch.models.cvt as cvt
    import multi_modal_tracking_torch.models.vit as vit
    from torch.profiler import ProfilerActivity, profile, record_function
    plain, n = vit._attend, len(frames)
    names_g = [x[2] for x in graphed]

    def tagged(*args, **kw):
        with record_function("_attend"):
            return plain(*args, **kw)

    vit._attend = cvt._attend = tagged
    try:
        for attempt in range(PROFILE_SESSIONS):       # again if the profiler lost events
            eager.restore(snap)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for fv, fi in frames:
                    eager.track([fv, fi])
                torch.cuda.synchronize()
            events = _trace_events(prof)
            dev = _device_events(events)
            matched_on, idx_e, idx_g = _aligned([e["name"] for e in dev], names_g)
            if idx_e is not None:
                break
    finally:
        vit._attend = cvt._attend = plain
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e.get("name") == "_attend"]
    inside = {e["args"]["correlation"] for e in events
              if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
              and any(a <= float(e["ts"]) <= b for a, b in ranges)}
    marked = [i for i, e in enumerate(dev) if e.get("args", {}).get("correlation") in inside]
    eager_ms = sum(float(dev[i]["dur"]) for i in marked) / n / 1e3
    eager_busy = _busy_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                           for e in dev]) / n / 1e3
    out = dict(calls_per_frame=len(ranges) / n, operations_per_frame=len(marked) / n,
               eager_ms_per_frame=eager_ms, eager_busy_ms_per_frame=eager_busy,
               eager_share_of_busy=eager_ms / eager_busy, profiler_sessions=attempt + 1,
               graphed_sequence_matches_eager=idx_e is not None, matched_on=matched_on)
    if idx_e is not None:
        pos = dict(zip(idx_e, idx_g))
        ms = sum(graphed[pos[i]][1] - graphed[pos[i]][0] for i in marked if i in pos) / n / 1e3
        out.update(ms_per_frame=ms, busy_ms_per_frame=busy_ms, share_of_busy=ms / busy_ms)
    else:
        out.update(ms_per_frame="not measured", eager_operations=len(dev),
                   graphed_operations=len(names_g))
    return out


def _uni_tracking(params, dtype, mode: str, frames, shift: float = 0.0, base=None,
                  attend: bool = False, n_track: int = 64) -> tuple:
    """create_tracker's tracker (or, with `base`, a tracker of base's class
    and settings on its model in `mode`) on the first `n_track` of the 64
    frames (63 tracked by default) graphed (with its
    captures), eager and graphed again, bit for bit (boxes, scores, every
    state buffer) with the same launches; 10 more frames profiled, with
    `attend` the plain attention's share of them (`_attend_in_frames`).
    `shift` moves the online tracker's score bias. Returns (line, tracker,
    the first run)."""
    names = TRACK_KERNEL_NAMES[dtype]
    if base is None:
        tracker = _uni_tracker(params, dtype, mode)
    else:
        tracker = _uni_twin(base, graphs=True)
        tracker.mode = mode
    if shift:
        with torch.no_grad():
            _score_head_bias(tracker.model).add_(shift)
    require(tracker.update_interval == 25 and tracker.graphs is not None and tracker.mode == mode,
            f"{params.script} {mode}: create_tracker gave {type(tracker).__name__}")
    eager = _uni_twin(tracker, graphs=False)
    seq = frames[:n_track]
    torch.cuda.reset_peak_memory_stats()
    runs = [(name, _uni_run(tr, seq)) for name, tr in
            (("graphed_capture", tracker), ("eager", eager), ("graphed", tracker))]
    first, n = runs[0][1], len(seq) - 1
    for name, run in runs[1:]:
        diff = [k for k in ("boxes", "scores")
                if not np.array_equal(run[k].view(np.int32), first[k].view(np.int32))]
        diff += _differing(run["state"], first["state"])
        require(not diff and run["launches"] == first["launches"],
                f"{params.script} {mode} {dtype}: {name} run differs from the graphed one in "
                f"{diff[:6]} or launches {run['launches']} vs {first['launches']}")
    H, W = seq[0][0].shape[:2]
    require(_inside(first["boxes"].astype(np.float64), H, W)
            and bool(np.isfinite(first["scores"]).all()),
            f"{params.script} {mode} {dtype}: a box outside the frame or a score not finite")
    snap, graphed = tracker.snapshot(), []
    prof = _profile_track(tracker, frames[64:], names, graphed)
    require(prof["launches"] == prof["kernels_by_name"],
            f"{params.script} {mode} {dtype}: launches {prof['launches']} against the "
            f"profiler's kernels {prof['kernels_by_name']}")
    if attend:
        prof["attend"] = _attend_in_frames(eager, snap, frames[64:], graphed,
                                           prof["device_busy_ms_per_frame"])
    line = dict(tracker=type(tracker).__name__, mode=mode, frames=n,
                bit_equal_runs=["eager", "graphed"], launches=first["launches"],
                ms_per_frame={name: r["ms_per_frame"] for name, r in runs},
                graphs=len(tracker.graphs), graph_pool_bytes=tracker.graphs.pool_bytes(),
                peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30, profile=prof)
    if tracker.online:
        taken, commits = _candidates(first["scores"], 25, tracker.max_score_decay)
        line.update(scores_above_half=int((first["scores"] > 0.5).sum()), taken_at=taken,
                    commit_frames=[25 * (i + 1) for i in range(len(commits))],
                    commits_of_a_taken_candidate=commits, n_filled=first["n_filled"],
                    forget_id=first["forget_id"], online_size=tracker.online_size)
    return line, tracker, first


def _uni_gpu_vs_cpu(model) -> dict:
    """The f32 model on the card against a copy on the CPU on the same
    random crops (batch 1): the full forward (K1 against its plain version)
    and the cached path (set_online + forward_test), boxes and scores."""
    g = torch.Generator().manual_seed(9)
    ts, ss = model.spec.template_size, model.spec.search_size
    t, ot = torch.randn(1, ts, ts, 3, generator=g), torch.randn(1, ts, ts, 3, generator=g)
    s = torch.randn(1, ss, ss, 3, generator=g)
    cpu = copy.deepcopy(model).cpu()
    d = {}
    with torch.no_grad():
        for path in ("full", "cached"):
            if path == "full":
                want, got = (m(*(x.to(dev) for x in (t, ot, s)), run_score_head=True)
                             for m, dev in ((cpu, "cpu"), (model, "cuda")))
            else:
                want, got = (m.forward_test(s.to(dev), m.set_online(t.to(dev), ot.to(dev)),
                                            run_score_head=True)
                             for m, dev in ((cpu, "cpu"), (model, "cuda")))
            for k in want:
                d[f"{path}/{k}"] = float((got[k].cpu() - want[k]).abs().max())
                require(bool(torch.isfinite(got[k]).all()), f"GPU {path} {k} not finite")
    require(max(d.values()) <= BOX_TOL, f"GPU forward vs CPU: {d} (tolerance {BOX_TOL})")
    del cpu
    return d


def _uni_train_cfg(script: str, recipe: str, batch: int, steps: int):
    """The recipe on the synthetic set (SyntheticVideo for a unimodal one,
    SyntheticRGBT for the RGB-T one): no val split, no warm starts."""
    from multi_modal_tracking_torch.config import get_default_config
    cfg = get_default_config(script)
    cfg.update_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "experiments", script, f"{recipe}.yaml"))
    cfg.DATA.TRAIN.DATASETS_NAME = ["SyntheticRGBT" if "rgbt" in script else "SyntheticVideo"]
    cfg.DATA.TRAIN.DATASETS_RATIO = [1]
    cfg.DATA.VAL.DATASETS_NAME = []
    cfg.MODEL.BACKBONE.PRETRAINED = False
    for key in ("TRACKER_PRETRAINED_PATH", "RGBT_PRETRAINED_PATH"):
        if key in cfg.MODEL:
            cfg.MODEL[key] = ""
    cfg.TRAIN.BATCH_SIZE = batch
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = batch * steps
    return cfg


def _uni_training(script: str, recipe: str, batch: int, save_dir: str, steps: int = UNI_STEPS,
                  twin: bool = True, dtype=torch.bfloat16, attention: bool = True) -> tuple:
    """The Trainer, graphed, on the recipe at its default bf16 or at `dtype`:
    `steps` steps graphed against eager (`_graphed_vs_eager_in_place`, bit
    for bit; f32 `_f32_graphed_vs_eager_in_place`), or with twin=False
    graphed alone; the dtype's K1 and K2
    launched, no kernel of the other dtype (attention=False: a model that
    attends through plain PyTorch, CvT: no K1-K4 of either dtype, AdamW
    only); ms per step, busy, idle, memory
    (`_stage2_timing`); stage 2 also the frozen check. Returns (line,
    launches)."""
    from multi_modal_tracking_torch.train.builders import build_train_loader
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    from multi_modal_tracking_torch.train.train_step import model_inputs
    from multi_modal_tracking_torch.train.trainer import Trainer
    bf16 = dtype == torch.bfloat16
    kernels, other = (BF16_KERNELS, F32_KERNELS) if bf16 else (F32_KERNELS, BF16_KERNELS)
    cfg = _uni_train_cfg(script, recipe, batch, steps)
    kw = {} if bf16 else dict(dtype=dtype)
    tr = Trainer(script, cfg, save_dir=save_dir, device="cuda", seed=0, print_interval=steps,
                 **kw)
    require(tr.dtype == dtype and tr._step.graphs is not None,
            f"{script}/{recipe}: Trainer {tr.dtype}")
    batches = [model_inputs(batch_to_model_inputs(b, rgbt=tr.rgbt), "cuda")
               for b in build_train_loader(cfg, seed=4)]
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    if twin:
        check = _graphed_vs_eager_in_place if bf16 else _f32_graphed_vs_eager_in_place
        line = dict(graphed_vs_eager=check(tr, batches))
        got = line["graphed_vs_eager"]["launches"]
    else:
        reset_launches()
        metrics = [tr._step(x, None) for x in batches]
        torch.cuda.synchronize()
        got = read_launches()
        losses = [float(m["Loss/total"]) for m in metrics]
        require(all(np.isfinite(losses)), f"{script}/{recipe}: losses {losses}")
        line = dict(loss=losses)
    if attention:
        ok = got[kernels[0]] > 0 and got[kernels[1]] > 0 and not any(got[k] for k in other)
    else:
        ok = not any(got[k] for k in F32_KERNELS + BF16_KERNELS) and got["AdamW"] > 0
    require(ok, f"{script}/{recipe} training: launches {got}")
    if tr._step.train_score:
        line["frozen"] = _frozen_check(tr, before)
    reset_launches()
    timing = _stage2_timing(tr, batches[0], bf16)
    launches = {k: got[k] + read_launches()[k] for k in kernels + ("AdamW",)}
    line.update(batch=batch, dtype="bf16" if bf16 else "f32", steps=steps,
                accum_iter=cfg.TRAIN.ACCUM_ITER,
                train_score=tr._step.train_score, **timing,
                regime={g: tr.optimizer.mults[g] for g in tr.optimizer.groups},
                params=sum(p.numel() for p in tr.model.parameters()),
                samples_per_s=batch / timing["ms_per_step_median"] * 1e3,
                peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del tr, batches
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches


def _uni_online_eval(dtype, shift, root: str, runs: dict, mode: str = "TIR", params=None,
                     tag: str = "uni", n_frames: int = 60) -> tuple:
    """The online unimodal tracker on synthetic_rgbt_hard in `mode` at update
    interval 25 and online size 3, the score bias shifted: one stream
    (run_dataset) against lockstep N = 12 (eval.run's twin,
    BatchedOnlineTracker). The score bias is shifted by `shift`, or with
    None by minus the median logit of the first sequence tracked eager.
    f32: within UNI_LOCKSTEP_PX of one stream with byte-equal score files;
    bf16: the drift printed. No hand-written kernel runs (the cached path's
    attention is plain). `params`: another online script's (default
    mixformer_vit_online/baseline); `tag` names its runs; `n_frames` the
    frames of each sequence. Returns (line, shift)."""
    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.run import _batched_twin
    from multi_modal_tracking_torch.eval.running import run_dataset
    from multi_modal_tracking_torch.tracking.batched import BatchedOnlineTracker
    seqs = get_dataset("synthetic_rgbt_hard", n_frames=n_frames)
    single = _uni_tracker(params or _family_params(UNI_ONLINE, UNI_ONLINE, "baseline"), dtype,
                          mode)
    if shift is None:               # centre the scores of the first sequence
        probe = _uni_twin(single, graphs=False)
        probe.initialize(list(seqs[0].frames[0]), seqs[0].init_info())
        s = np.asarray([probe.track(list(f))["pred_score"] for f in seqs[0].frames[1:]])
        shift = -float(np.median(np.log(s / (1.0 - s))))
        del probe
    with torch.no_grad():
        _score_head_bias(single.model).add_(shift)
    bt = _batched_twin(single, EVAL_CHUNK)
    require(type(bt) is BatchedOnlineTracker and bt.online_size == 3 and bt.mode == mode,
            f"eval.run's lockstep twin of OnlineTracker: {type(bt).__name__}")
    label = "f32" if dtype == torch.float32 else "bf16"
    a, b = f"{tag}_A_{label}", f"{tag}_B12_{label}"
    one = _eval_run(a, lambda d: run_dataset(seqs, single, d, chunk=EVAL_CHUNK), seqs, root, runs,
                    kernels=())
    lock = _eval_run(b, lambda d: _lockstep_runs(seqs, bt, d, EVAL_BIG), seqs, root, runs,
                     kernels=())
    res = _lockstep_vs_one(one, lock, seqs, root, a, b, runs,
                           UNI_LOCKSTEP_PX if dtype == torch.float32 else None)
    scores = np.concatenate([np.loadtxt(os.path.join(root, a, f"{q.name}_score.txt"))
                             for q in seqs])
    res.update(score_bias_shift=shift, scores_above_half_share=float((scores > 0.5).mean()))
    return res, shift


def _lockstep_vs_one(one, lock, seqs, root, a: str, b: str, runs: dict, bound) -> dict:
    """Lockstep against one stream: the largest box difference, the mean
    centre distance and the sequences whose score files differ, kept in
    runs[b]; with a bound, the difference must be within it and the score
    files byte-equal."""
    worst = max(float(np.abs(lock[k] - one[k]).max()) for k in one)
    differ = []
    for s in seqs:
        with open(os.path.join(root, a, f"{s.name}_score.txt"), "rb") as fa, \
                open(os.path.join(root, b, f"{s.name}_score.txt"), "rb") as fb:
            if fa.read() != fb.read():
                differ.append(s.name)
    centre = float(np.mean([_centre_px(lock[k], one[k]).mean() for k in one]))
    res = dict(max_abs_px_vs_one_stream=worst, centre_px_vs_one_stream_mean=centre,
               score_files_differing=differ)
    runs[b].update(res)
    require(bound is None or (worst <= bound and not differ),
            f"lockstep {b}: {worst} px from one stream (bound {bound}), score files "
            f"differing {differ}")
    return res


def _rgbt_online_drift(frames, root: str, runs: dict, offsets=(0.0,),
                       factors=DRIFT_FACTORS, n_frames: int = 60) -> dict:
    """The open check on the RGB-T online tracker's bf16 lockstep drift
    (asymmetric_shared_online, bf16, synthetic_rgbt_hard one stream against
    lockstep N = 12, the score bias centred as phase_online centres it and
    moved by each of `offsets`), the two runs' attention by turns: both
    with K1-bf16 (whose key shares differ between batch 1 and 12,
    attention_bf16_plan); both with its plain version (batch-invariant but
    for cuBLAS's GEMMs); and, as the control, the plain version in both
    with the lockstep run's attention scale larger or smaller by each of
    `factors` (DRIFT_FACTORS: an f32-sized difference between the two runs,
    as the bf16 phase's drift_by_kernel uses one), on `n_frames` frames of
    each sequence. Each offset's summary says whether the kernels' distance
    lies within the control's spread (at most its largest). The runs' lines
    and launches go to `runs`."""
    import multi_modal_tracking_torch.ops.attention as attention
    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.run import _batched_twin
    from multi_modal_tracking_torch.eval.running import run_dataset
    seqs = get_dataset("synthetic_rgbt_hard", n_frames=n_frames)
    k1, p1 = attention.mixed_attention_bf16, attention.mixed_attention_bf16_ref

    def scaled(factor):
        def p1_scaled(q, k, v, n_mt, scale, **kw):
            return p1(q, k, v, n_mt, scale * factor, **kw)
        return p1_scaled

    probe = create_tracker(_online_params(), ONLINE_INTERVAL_FROM, seed=0, dtype=torch.bfloat16)
    shift = _centre_score_bias(probe, frames[:64])
    del probe
    out = dict(score_bias_shift=shift)
    for offset in offsets:
        tag = f"offset {offset:+g}"
        cases = [("kernels", k1, k1), ("plain_K1-bf16", p1, p1)]
        cases += [(f"plain, lockstep scale x (1 {sign} 2^{int(np.log2(f))})", p1,
                   scaled(1.0 + f if sign == "+" else 1.0 - f))
                  for f in factors for sign in "+-"]
        res, alone = {}, {}
        for name, f_one, f_lock in cases:
            try:
                single = create_tracker(_online_params(), ONLINE_INTERVAL_FROM, seed=0,
                                        dtype=torch.bfloat16)
                with torch.no_grad():
                    _score_head_bias(single.model).add_(shift + offset)
                bt = _batched_twin(single, EVAL_CHUNK)
                kernels = BF16_SERVING if name == "kernels" else ("K3-bf16",)
                # swapped before each run: its launch counts are read from
                # the function in place (reset_launches gives it a count);
                # one stream runs once per function (the controls share the
                # plain one)
                if f_one not in alone:
                    attention.mixed_attention_bf16 = f_one
                    a = f"rgbt_A_{tag}_{name}"
                    alone[f_one] = (a, _eval_run(
                        a, lambda d: run_dataset(seqs, single, d, chunk=EVAL_CHUNK),
                        seqs, root, runs, kernels))
                a, one = alone[f_one]
                attention.mixed_attention_bf16 = f_lock
                b = f"rgbt_B12_{tag}_{name}"
                lock = _eval_run(b, lambda d: _lockstep_runs(seqs, bt, d, EVAL_BIG),
                                 seqs, root, runs, kernels)
                res[name] = _lockstep_vs_one(one, lock, seqs, root, a, b, runs, None)
                res[name]["one_stream_fps"] = runs[a]["fps"]
            finally:
                attention.mixed_attention_bf16 = k1
            del single, bt
            torch.cuda.empty_cache()
        control = [r["max_abs_px_vs_one_stream"] for n, r in res.items() if "scale" in n]
        worst = res["kernels"]["max_abs_px_vs_one_stream"]
        res["summary"] = dict(kernels_px=worst, control_px=control,
                              control_px_range=[min(control), max(control)],
                              plain_px=res["plain_K1-bf16"]["max_abs_px_vs_one_stream"],
                              kernels_within_control_spread=worst <= max(control))
        out[tag] = res
    return out


def phase_drift(smi: str, frames, save_dir: str) -> dict:
    """The spread behind the RGB-T online bf16 drift check
    (`_rgbt_online_drift`): the kernels, their plain version and the
    control at each of DRIFT_OFFSETS (the score bias moved from its
    centred value, which moves the commits and so the trajectories). Run
    alone by `python3 chip_smoke.py drift`; not part of the whole script
    (the unimodal phase ran its first offset there until PR 19). Returns
    the launch counts (the online tracker's path)."""
    launches = dict.fromkeys(BF16_KERNELS + ("AdamW",), 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        runs = {}
        res = _rgbt_online_drift(frames, root, runs, DRIFT_OFFSETS)
        for k in BF16_SERVING:
            launches[k] += sum(r["launches"][k] for r in runs.values())
    within = [res[t]["summary"]["kernels_within_control_spread"]
              for t in res if t != "score_bias_shift"]
    emit({"phase": "drift study", "card": smi, "script": ONLINE_SCRIPT, "runs": runs, **res,
          "offsets_with_kernels_within_control_spread": sum(within), "offsets": len(within),
          "seconds": time.perf_counter() - t0})
    return {"online_bf16": launches}


def _uni_attention_checks(g: torch.Generator) -> list:
    """K1 and K1-bf16 at UNI_ATTN's shapes against their plain versions (ms
    per call, CUDA events), K2 and K2-bf16 at the training ones (B*H 192
    and 384)."""
    from multi_modal_tracking_torch.ops.attention import (
        mixed_attention_bf16, mixed_attention_bf16_ref, mixed_attention_bwd,
        mixed_attention_bwd_bf16, mixed_attention_bwd_bf16_ref, mixed_attention_bwd_ref,
        mixed_attention_fwd, mixed_attention_ref)
    rows = []
    for bh, n, n_mt in UNI_ATTN:
        heads = 16 if n == 864 else HEADS
        B, scale = bh // heads, HEAD_D ** -0.5
        q, k, v = _qkv(B, heads, n, n, HEAD_D, g)
        out, lse = mixed_attention_fwd(q, k, v, n_mt, scale, return_lse=True)
        err, _, ok = max_err(out, mixed_attention_ref(q, k, v, n_mt, scale))
        require(ok, f"K1 B*H={bh} N={n} disagrees with its plain version: {err}")
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        errs = _bf16_errors(f"K1-bf16 B*H={bh} N={n}",
                            mixed_attention_bf16(qb, kb, vb, n_mt, scale),
                            mixed_attention_bf16_ref(qb, kb, vb, n_mt, scale),
                            mixed_attention_ref(qb.float(), kb.float(), vb.float(), n_mt, scale),
                            vb)
        row = dict(BH=bh, heads=heads, N=n, n_mt=n_mt, k1_max_abs_err=err, k1_bf16=errs,
                   k1_event_ms=cuda_time_ms(lambda: mixed_attention_fwd(q, k, v, n_mt, scale)),
                   k1_bf16_event_ms=cuda_time_ms(
                       lambda: mixed_attention_bf16(qb, kb, vb, n_mt, scale)))
        if bh >= 192:
            gr = torch.randn(B, heads, n, HEAD_D, generator=g).cuda()
            got = mixed_attention_bwd(q, k, v, out, gr, n_mt, scale, lse)
            want = mixed_attention_bwd_ref(q, k, v, gr, n_mt, scale)
            e2 = [max_err_scaled(a, b) for a, b in zip(got, want)]
            require(all(e[2] for e in e2), f"K2 B*H={bh} N={n}: {[e[0] for e in e2]}")
            _, lse_b = mixed_attention_bf16(qb, kb, vb, n_mt, scale, return_lse=True)
            grb = gr.to(torch.bfloat16)
            gotb = mixed_attention_bwd_bf16(qb, kb, vb, grb, n_mt, scale, lse_b)
            plainb = mixed_attention_bwd_bf16_ref(qb, kb, vb, grb, n_mt, scale)
            e2b = [max_err(a.float(), b.float(), bf16_tol(b)) for a, b in zip(gotb, plainb)]
            require(all(e[2] for e in e2b), f"K2-bf16 B*H={bh} N={n}: {[e[0] for e in e2b]}")
            row.update(k2_max_abs_err=[e[0] for e in e2], k2_bf16_max_abs_err=[e[0] for e in e2b],
                       k2_event_ms=cuda_time_ms(
                           lambda: mixed_attention_bwd(q, k, v, out, gr, n_mt, scale, lse), 10),
                       k2_bf16_event_ms=cuda_time_ms(
                           lambda: mixed_attention_bwd_bf16(qb, kb, vb, grb, n_mt, scale, lse_b),
                           10))
        rows.append(row)
        del q, k, v, out
    torch.cuda.empty_cache()
    return rows


def phase_unimodal(smi: str, frames, save_dir: str) -> dict:
    """The unimodal MixFormer-ViT family at full width, seeded random
    weights (module docstring, phase 16). Returns the launch counts by
    path: the unimodal paths' f32 and bf16, and those of the RGB-T ViT-L
    recipe the phase runs beside them (`families_bf16`)."""
    from multi_modal_tracking_torch.eval.run import main as eval_cli
    from multi_modal_tracking_torch.tracking.tracker import RGBTracker
    g = torch.Generator().manual_seed(16)
    f32 = dict.fromkeys(F32_KERNELS + ("AdamW",), 0)
    bf16 = dict.fromkeys(BF16_KERNELS + ("AdamW",), 0)
    families_bf16 = dict.fromkeys(BF16_KERNELS + ("AdamW",), 0)
    totals = {torch.float32: f32, torch.bfloat16: bf16}
    attend = {}

    # mixformer_vit/baseline: three modes, f32 and bf16, the cached tracker
    t0 = time.perf_counter()
    params = _family_params(UNI_SCRIPT, UNI_SCRIPT, "baseline")
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        label = "f32" if dtype == torch.float32 else "bf16"
        base = None             # create_tracker's for RGB; the other modes on its model
        for mode in MODES:
            line, tracker, first = _uni_tracking(params, dtype, mode, frames, base=base,
                                                 attend=dtype == torch.bfloat16 and mode == "RGB")
            base = base or tracker
            _add_launches(totals[dtype], line["launches"], totals[dtype])
            require(line["tracker"] == "RGBCachedTracker"
                    and not any(line["launches"][k] for k in F32_KERNELS + BF16_KERNELS),
                    f"{UNI_SCRIPT} {mode} {label}: {line['tracker']}, launches "
                    f"{line['launches']} (the cached path runs no hand-written kernel)")
            if "attend" in line["profile"]:
                attend["RGBCachedTracker"] = line["profile"]["attend"]
            if dtype == torch.float32 and mode == "RGB":
                res["gpu_vs_cpu_max_abs"] = _uni_gpu_vs_cpu(tracker.model)
                res["params"] = sum(p.numel() for p in tracker.model.parameters())
                full = RGBTracker(tracker.model, **{k: getattr(tracker, k) for k in (
                    "template_factor", "template_size", "search_factor", "search_size",
                    "update_interval", "mode")})
                fr = _family_run(full, frames[:64])
                _add_launches(f32, fr["launches"], f32)
                d = float(np.abs(fr["boxes"] - first["boxes"]).max())
                require(fr["launches"]["K1"] == 12 * 63 and d <= UNI_CACHED_PX,
                        f"{UNI_SCRIPT}: cached vs full forward {d} px (bound {UNI_CACHED_PX}), "
                        f"full-forward launches {fr['launches']}")
                res["cached_vs_full"] = dict(max_abs_px=d, bound_px=UNI_CACHED_PX,
                                             full_ms_per_frame=fr["ms_per_frame"],
                                             full_launches={"K1": fr["launches"]["K1"]})
                del full
            res[f"track_{label}_{mode}"] = line
            del tracker
        del base
        torch.cuda.empty_cache()
    res["train_bf16"], counts = _uni_training(UNI_SCRIPT, "baseline", UNI_B, save_dir)
    _add_launches(bf16, counts, counts)
    res["train_f32"], counts = _uni_training(UNI_SCRIPT, "baseline", UNI_B, save_dir,
                                             dtype=torch.float32)
    _add_launches(f32, counts, counts)
    emit({"phase": "unimodal mixformer_vit", "card": smi, "recipe": f"{UNI_SCRIPT}/baseline",
          "tolerance": BOX_TOL, **res, "seconds": time.perf_counter() - t0})

    # mixformer_vit_online/baseline: the ring, the score gate, stage 2
    t0 = time.perf_counter()
    params = _family_params(UNI_ONLINE, UNI_ONLINE, "baseline")
    probe = _uni_twin(_uni_tracker(params, torch.float32, "RGB"), graphs=False)
    s = _family_run(probe, frames[:64])["scores"].astype(np.float64)
    shift = -float(np.median(np.log(s / (1.0 - s))))
    del probe
    res = dict(score_bias_shift=shift)
    for dtype in (torch.float32, torch.bfloat16):
        label = "f32" if dtype == torch.float32 else "bf16"
        line, tracker, first = _uni_tracking(params, dtype, "RGB", frames, shift,
                                             attend=dtype == torch.bfloat16)
        _add_launches(totals[dtype], line["launches"], totals[dtype])
        require(line["tracker"] == "OnlineTracker" and line["online_size"] == 3
                and line["n_filled"] == 3 and line["forget_id"] == 0
                and any(line["commits_of_a_taken_candidate"]),
                f"{UNI_ONLINE} {label}: {line['tracker']}, ring {line.get('n_filled')} / "
                f"{line.get('forget_id')}, commits {line.get('commits_of_a_taken_candidate')}")
        if "attend" in line["profile"]:
            attend["OnlineTracker"] = line["profile"]["attend"]
        res[f"track_{label}"] = line
        del tracker
        torch.cuda.empty_cache()
    res["stage2_bf16"], counts = _uni_training(UNI_ONLINE, "baseline", UNI_B, save_dir)
    _add_launches(bf16, counts, counts)
    emit({"phase": "unimodal mixformer_vit_online", "card": smi,
          "recipe": f"{UNI_ONLINE}/baseline", **res, "seconds": time.perf_counter() - t0})
    emit({"phase": "unimodal cached attention", "card": smi,
          "what": "device ms a bf16 frame of the cached path's plain attention (models/vit.py "
                  "_attend) in the 10 profiled graphed frames, found by position from the "
                  "eager twin's trace of the same frames, and its share of their device "
                  "busy time", **attend})

    # lockstep: the CLI, then N = 12 against one stream (the RGB-T online
    # drift study runs alone: `chip_smoke.py drift`)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        reset_launches()
        dirs = eval_cli([UNI_ONLINE, "baseline", "--dataset_name", "synthetic_rgbt_hard",
                         "--type", "TIR", "--batch_sequences", str(EVAL_BIG), "--results_dir",
                         os.path.join(root, "cli")])
        from multi_modal_tracking_torch.eval.datasets import get_dataset
        names = [s.name for s in get_dataset("synthetic_rgbt_hard")]
        require(len(dirs) == 1 and all(os.path.isfile(os.path.join(dirs[0], f"{n}{x}.txt"))
                                       for n in names for x in ("", "_score")),
                f"eval.run {UNI_ONLINE} --type TIR --batch_sequences {EVAL_BIG}: {dirs}")
        cli = dict(seconds=time.perf_counter() - t0, launches=read_launches())
        runs, drift, tir_shift = {}, {}, None
        for dtype in (torch.float32, torch.bfloat16):
            label = "f32" if dtype == torch.float32 else "bf16"
            drift[label], tir_shift = _uni_online_eval(dtype, tir_shift, root, runs,
                                                       n_frames=HARD_FRAMES)
    emit({"phase": "unimodal lockstep", "card": smi, "script": UNI_ONLINE, "mode": "TIR",
          "frames_per_sequence": HARD_FRAMES, "cli": cli, "runs": runs,
          "unimodal_online_drift": drift, "seconds": time.perf_counter() - t0})

    # ViT-L: mixformer_vit/baseline_large and mixformer_vit_rgbt/baseline_large
    t0 = time.perf_counter()
    res = {}
    params = _family_params(UNI_SCRIPT, UNI_SCRIPT, "baseline_large")
    line, tracker, _ = _uni_tracking(params, torch.bfloat16, "RGB", frames, n_track=LARGE_TRACK)
    res["track_bf16"] = line
    del tracker
    torch.cuda.empty_cache()
    tracker = _uni_tracker(params, torch.float32, "RGB")
    res["gpu_vs_cpu_max_abs"] = _uni_gpu_vs_cpu(tracker.model)
    res["params"] = sum(p.numel() for p in tracker.model.parameters())
    del tracker
    torch.cuda.empty_cache()
    res["train_bf16"], counts = _uni_training(UNI_SCRIPT, "baseline_large", UNI_LARGE_B, save_dir)
    _add_launches(bf16, counts, counts)
    emit({"phase": "unimodal vit_large", "card": smi, "recipe": f"{UNI_SCRIPT}/baseline_large",
          "tolerance": BOX_TOL, **res, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    # the recipe's own TEST sizes (192 / 384): experiments/tracking.yaml,
    # which get_parameters lays over every RGB-T recipe, sets 128 / 288
    from multi_modal_tracking_torch.eval.params import get_parameters
    params = get_parameters("mixformer_vit_rgbt", "baseline_large", tracking_yaml=None)
    require(params.template_size == 192 and params.search_size == 384,
            f"mixformer_vit_rgbt/baseline_large: TEST sizes {params.template_size}, "
            f"{params.search_size}")
    layers = 0 if params.cfg.MODEL.FUSION_CLASS.startswith("RGBT_Fusion") \
        else params.cfg.MODEL.FUSION_LAYERS
    line, tracker = _family_tracking(params, torch.bfloat16, frames, layers, 48,
                                     n_track=LARGE_TRACK)
    _add_launches(families_bf16, line["launches"], BF16_SERVING)
    _add_launches(families_bf16, line["profile"]["launches"], BF16_SERVING)
    n_params = sum(p.numel() for p in tracker.model.parameters())
    del tracker
    torch.cuda.empty_cache()
    # one update: ACCUM_ITER (3) micro-batches of the recipe's 12
    train, counts = _uni_training("mixformer_vit_rgbt", "baseline_large", UNI_LARGE_B, save_dir,
                                  twin=False)
    require(train["accum_iter"] == UNI_STEPS and counts["AdamW"] > 0,
            f"mixformer_vit_rgbt/baseline_large: ACCUM_ITER {train['accum_iter']}, AdamW "
            f"launches {counts['AdamW']}")
    _add_launches(families_bf16, counts, counts)
    emit({"phase": "unimodal vit_large rgbt", "card": smi,
          "recipe": "mixformer_vit_rgbt/baseline_large", "params": n_params, "track_bf16": line,
          "train_bf16": train, "seconds": time.perf_counter() - t0})
    emit({"phase": "unimodal kernel shapes", "card": smi, "k1_k2": _uni_attention_checks(g)})
    return {"f32": f32, "bf16": bf16, "families_bf16": families_bf16}


# ----------------------------------------------------------- cvt / convmae
CVT, CVT_ONLINE = "mixformer_cvt", "mixformer_cvt_online"
CM, CM_ONLINE = "mixformer_convmae", "mixformer_convmae_online"
#: the recipes' batches: CvT-21 (mixformer_cvt 8, its stage 2 32), CvT-24's
#: stage 2 16, ConvMAE-B 32 (and its stage 2), ConvMAE-L 12 (ACCUM_ITER 3)
CVT_B, CVT_ONLINE_B, CVT_LARGE_B, CM_B, CM_LARGE_B = 8, 32, 16, 32, 12
#: CvT's cached tracker against its full forward over the 63 frames (px):
#: both attend through the plain f32 einsum, the cached path over the same
#: keys in other GEMM groupings, so only the order of f32 sums differs
CVT_CACHED_PX = 1e-4


def _cm_params(script: str, recipe: str = "baseline"):
    """The recipe's tracking parameters (its own tree, no tracking overlay);
    an online script's ring of 3 at the update-interval dataset (the CvT
    recipes list 1 for TrackingNet)."""
    params = _family_params(script, script, recipe)
    if script.endswith("online"):
        params.cfg.TEST.ONLINE_SIZES[ONLINE_INTERVAL_FROM] = [3]
    return params


def _no_attention_kernels(line: dict, what: str) -> None:
    require(not any(line["launches"][k] for k in F32_KERNELS + BF16_KERNELS),
            f"{what}: launches {line['launches']} (the cached path attends through plain "
            f"PyTorch)")


def _cached_vs_full(t, frames, bound: float, k1_per_frame: int) -> tuple:
    """RGBCachedTracker against the full-forward RGBTracker on `t`'s model
    and settings over the 63 frames (f32, graphed): the largest box
    difference within `bound`, the full forward's K1 launches
    `k1_per_frame` a frame and the cached path's none. Returns (line, the
    full forward's launches)."""
    from multi_modal_tracking_torch.tracking.tracker import RGBCachedTracker, RGBTracker
    kw = {k: getattr(t, k) for k in ("template_factor", "template_size", "search_factor",
                                     "search_size", "update_interval", "mode")}
    runs = {cls.__name__: _family_run(cls(t.model, **kw), frames[:64])
            for cls in (RGBCachedTracker, RGBTracker)}
    cached, full = runs["RGBCachedTracker"], runs["RGBTracker"]
    d = float(np.abs(full["boxes"] - cached["boxes"]).max())
    require(d <= bound and full["launches"]["K1"] == k1_per_frame * 63
            and not any(cached["launches"][k] for k in F32_KERNELS),
            f"{t.model.__class__.__name__}: cached vs full forward {d} px (bound {bound}), "
            f"launches full {full['launches']} cached {cached['launches']}")
    return (dict(max_abs_px=d, bound_px=bound, cached_ms_per_frame=cached["ms_per_frame"],
                 full_ms_per_frame=full["ms_per_frame"], full_launches={"K1": full["launches"]["K1"]}),
            full["launches"])


def _centred_shift(params, frames) -> float:
    """Minus the median score logit of the f32 online tracker's eager run on
    the 63 frames: the shift that puts scores on both sides of 0.5."""
    probe = _uni_twin(_uni_tracker(params, torch.float32, "RGB"), graphs=False)
    s = _family_run(probe, frames[:64])["scores"].astype(np.float64)
    del probe
    torch.cuda.empty_cache()
    return -float(np.median(np.log(s / (1.0 - s))))


def phase_cvt_convmae(smi: str, frames, save_dir: str) -> dict:
    """The CvT and ConvMAE MixFormer families at full width, seeded random
    weights (module docstring, phase 17). Returns the launch counts of its
    f32 and bf16 paths."""
    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.run import main as eval_cli
    f32 = dict.fromkeys(F32_KERNELS + ("AdamW",), 0)
    bf16 = dict.fromkeys(BF16_KERNELS + ("AdamW",), 0)
    totals = {torch.float32: f32, torch.bfloat16: bf16}
    attend = {}

    # CvT-21 online: GPU vs CPU, cached vs full, the online tracker, stage 2
    t0 = time.perf_counter()
    params = _cm_params(CVT_ONLINE)
    tracker = _uni_tracker(params, torch.float32, "RGB")
    res = dict(params=sum(p.numel() for p in tracker.model.parameters()),
               gpu_vs_cpu_max_abs=_uni_gpu_vs_cpu(tracker.model))
    res["cached_vs_full"], _ = _cached_vs_full(tracker, frames, CVT_CACHED_PX, 0)
    del tracker
    shift = _centred_shift(params, frames)
    res["score_bias_shift"] = shift
    for dtype in (torch.float32, torch.bfloat16):
        label = "f32" if dtype == torch.float32 else "bf16"
        line, tracker, _ = _uni_tracking(params, dtype, "RGB", frames, shift,
                                         attend=dtype == torch.bfloat16)
        _no_attention_kernels(line, f"{CVT_ONLINE} {label}")
        require(line["tracker"] == "OnlineTracker" and line["online_size"] == 3
                and line["n_filled"] == 3 and line["forget_id"] == 0,
                f"{CVT_ONLINE} {label}: {line['tracker']}, ring {line.get('n_filled')} / "
                f"{line.get('forget_id')}")
        if "attend" in line["profile"]:
            attend["cvt OnlineTracker"] = line["profile"]["attend"]
        res[f"track_{label}"] = line
        del tracker
        torch.cuda.empty_cache()
    res["stage2_bf16"], counts = _uni_training(CVT_ONLINE, "baseline", CVT_ONLINE_B, save_dir,
                                               attention=False)
    _add_launches(bf16, counts, counts)
    emit({"phase": "cvt_convmae cvt_online", "card": smi, "recipe": f"{CVT_ONLINE}/baseline",
          "tolerance": BOX_TOL, **res, "seconds": time.perf_counter() - t0})

    # CvT-21 by mixformer_cvt's recipe: training at its batch 8
    t0 = time.perf_counter()
    res = {}
    res["train_bf16"], counts = _uni_training(CVT, "baseline", CVT_B, save_dir, attention=False)
    _add_launches(bf16, counts, counts)
    res["train_f32"], counts = _uni_training(CVT, "baseline", CVT_B, save_dir,
                                             dtype=torch.float32, attention=False)
    _add_launches(f32, counts, counts)
    emit({"phase": "cvt_convmae cvt", "card": smi, "recipe": f"{CVT}/baseline", **res,
          "seconds": time.perf_counter() - t0})

    # ConvMAE-B: the cached tracker, against the full forward (K1), training
    t0 = time.perf_counter()
    params = _cm_params(CM)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        label = "f32" if dtype == torch.float32 else "bf16"
        line, tracker, _ = _uni_tracking(params, dtype, "RGB", frames,
                                         attend=dtype == torch.bfloat16)
        _no_attention_kernels(line, f"{CM} {label}")
        require(line["tracker"] == "RGBCachedTracker", f"{CM}: {line['tracker']}")
        if "attend" in line["profile"]:
            attend["convmae RGBCachedTracker"] = line["profile"]["attend"]
        if dtype == torch.float32:
            res["params"] = sum(p.numel() for p in tracker.model.parameters())
            res["gpu_vs_cpu_max_abs"] = _uni_gpu_vs_cpu(tracker.model)
            res["cached_vs_full"], counts = _cached_vs_full(tracker, frames, UNI_CACHED_PX, 11)
            _add_launches(f32, counts, f32)
        res[f"track_{label}"] = line
        del tracker
        torch.cuda.empty_cache()
    res["train_bf16"], counts = _uni_training(CM, "baseline", CM_B, save_dir)
    _add_launches(bf16, counts, counts)
    res["train_f32"], counts = _uni_training(CM, "baseline", CM_B, save_dir, dtype=torch.float32)
    _add_launches(f32, counts, counts)
    emit({"phase": "cvt_convmae convmae", "card": smi, "recipe": f"{CM}/baseline",
          "tolerance": BOX_TOL, **res, "seconds": time.perf_counter() - t0})

    # ConvMAE-B online: the online tracker in bf16, stage 2
    t0 = time.perf_counter()
    params = _cm_params(CM_ONLINE)
    shift = _centred_shift(params, frames)
    line, tracker, _ = _uni_tracking(params, torch.bfloat16, "RGB", frames, shift)
    _no_attention_kernels(line, f"{CM_ONLINE} bf16")
    require(line["tracker"] == "OnlineTracker" and line["n_filled"] == 3,
            f"{CM_ONLINE}: {line['tracker']}, ring {line.get('n_filled')}")
    del tracker
    torch.cuda.empty_cache()
    res = dict(score_bias_shift=shift, track_bf16=line)
    res["stage2_bf16"], counts = _uni_training(CM_ONLINE, "baseline", CM_B, save_dir)
    _add_launches(bf16, counts, counts)
    emit({"phase": "cvt_convmae convmae_online", "card": smi, "recipe": f"{CM_ONLINE}/baseline",
          **res, "seconds": time.perf_counter() - t0})
    emit({"phase": "cvt_convmae cached attention", "card": smi,
          "what": "device ms a bf16 frame of the plain attention (models/vit.py _attend, which "
                  "models/cvt.py calls) in the 10 profiled graphed frames, found by position "
                  "from the eager twin's trace of the same frames, and its share of their "
                  "device busy time", **attend})

    # lockstep: the CLI, CvT online N = 12 against one stream; ConvMAE's CLI
    t0 = time.perf_counter()
    seqs = get_dataset("synthetic_rgbt_hard")
    n_frames = sum(len(q.frames) for q in seqs)
    with tempfile.TemporaryDirectory() as root:
        cli = {}
        for script, extra in ((CVT_ONLINE, ["--type", "RGB"]), (CM, [])):
            reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dirs = eval_cli([script, "baseline", "--dataset_name", "synthetic_rgbt_hard", *extra,
                             "--batch_sequences", str(EVAL_BIG), "--results_dir",
                             os.path.join(root, script)])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            suffixes = ("", "_score") if script.endswith("online") else ("",)
            require(len(dirs) == 1 and all(os.path.isfile(os.path.join(dirs[0], f"{q.name}{x}.txt"))
                                           for q in seqs for x in suffixes),
                    f"eval.run {script} --batch_sequences {EVAL_BIG}: {dirs}")
            launches = read_launches()
            require(not any(launches[k] for k in F32_KERNELS + BF16_KERNELS),
                    f"eval.run {script}: launches {launches}")
            cli[script] = dict(seconds=secs, frames=n_frames, fps_with_model_build=n_frames / secs,
                               launches=launches)
        # f32, held to one stream (the unimodal phase prints the bf16 drift
        # of the same lockstep twin)
        runs, drift = {}, {}
        drift["f32"], _ = _uni_online_eval(torch.float32, None, root, runs, mode="RGB",
                                           params=_cm_params(CVT_ONLINE), tag="cvt",
                                           n_frames=HARD_FRAMES)
    emit({"phase": "cvt_convmae lockstep", "card": smi, "script": CVT_ONLINE, "mode": "RGB",
          "cli": cli, "runs": runs, "cvt_online_drift": drift,
          "seconds": time.perf_counter() - t0})
    return {"f32": f32, "bf16": bf16}


def phase_large(smi: str, frames, save_dir: str) -> dict:
    """The large recipes of phase 17, run alone (`python3 chip_smoke.py
    large`, module docstring). Returns the launch counts (bf16)."""
    bf16 = dict.fromkeys(BF16_KERNELS + ("AdamW",), 0)
    for script, recipe, batch, attention in ((CVT_ONLINE, "baseline_large", CVT_LARGE_B, False),
                                             (CM, "baseline_large", CM_LARGE_B, True)):
        t0 = time.perf_counter()
        params = _cm_params(script, recipe)
        line, tracker, _ = _uni_tracking(params, torch.bfloat16, "RGB", frames,
                                         n_track=LARGE_TRACK)
        _no_attention_kernels(line, f"{script}/{recipe} bf16")
        n_params = sum(p.numel() for p in tracker.model.parameters())
        del tracker
        torch.cuda.empty_cache()
        # one update: a stage-2 step (CvT-24), ACCUM_ITER's 3 micro-batches (ConvMAE-L)
        steps = 1 if script == CVT_ONLINE else UNI_STEPS
        train, counts = _uni_training(script, recipe, batch, save_dir, steps=steps, twin=False,
                                      attention=attention)
        require(counts["AdamW"] > 0 and train["accum_iter"] == steps,
                f"{script}/{recipe}: ACCUM_ITER {train['accum_iter']}, AdamW launches "
                f"{counts['AdamW']}")
        _add_launches(bf16, counts, counts)
        emit({"phase": f"large {script}/{recipe}", "card": smi, "params": n_params,
              "template_size": params.template_size, "search_size": params.search_size,
              "track_bf16": line, "train_bf16": train, "seconds": time.perf_counter() - t0})
    return {"bf16": bf16}


# ------------------------------------------------------------------- files
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_port_images")
FILE_SEQS, FILE_FRAMES = 2, 64     # LasHeR sequences laid out (test and train), frames each
DEPTH_FRAMES = 16                  # frames of the DepthTrack sequence
FILE_TRAIN_STEPS = 4               # graphed bf16 steps trained from the LasHeR tree
LOADER_BATCHES = 9                 # batches of 16 timed from files (the first not timed)
CE_FRAMES = 16                     # frames tracked per CE mode, graphed and eager
DECODE_REPS = 20                   # decodes of a pair timed (median)


def _png_bytes(arr: np.ndarray) -> bytes:
    """A grey PNG of a uint8 or uint16 (H, W) map: unfiltered scanlines,
    zlib's deflate, the chunks' CRCs; nothing but the standard library."""
    import struct
    import zlib
    h, w = arr.shape
    depth = 16 if arr.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(arr.astype(">u2" if depth == 16 else np.uint8)).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _digest(a: np.ndarray) -> dict:
    import hashlib
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def _fixtures_against_manifest() -> dict:
    """Every committed fixture decoded by the port (JPEG and PNG, the depth
    map also unchanged) against the SHA-256 of the JAX package's decode in
    tests/torch_port_images/manifest.json."""
    from multi_modal_tracking_torch import native
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    bad = []
    for name, entries in sorted(manifest.items()):
        path = os.path.join(FIXTURES, name)
        if _digest(native.imread(path)) != entries["rgb"]:
            bad.append(name)
        if "unchanged" in entries and _digest(native.imread_unchanged(path)) != entries["unchanged"]:
            bad.append(f"{name} (unchanged)")
    require(len(manifest) == 16 and not bad, f"fixtures whose decode differs from the "
                                             f"manifest's digest: {bad} of {len(manifest)}")
    return dict(files=len(manifest), equal_to_manifest=len(manifest) - len(bad),
                bytes=sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in manifest))


def _decode_ms() -> dict:
    """ms to decode one 640x480 RGB-T pair (the committed pair 0): one file
    after the other on the calling thread, and both through
    decode_jpeg_batch on 2 C++ threads (medians of DECODE_REPS)."""
    from multi_modal_tracking_torch import native
    pair = [os.path.join(FIXTURES, f"pair0_{m}.jpg") for m in "vi"]
    one, batch = [], []
    for _ in range(DECODE_REPS):
        t0 = time.perf_counter()
        for p in pair:
            native.decode_jpeg(p)
        one.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        native.decode_jpeg_batch(pair, 480, 640, num_threads=2)
        batch.append((time.perf_counter() - t0) * 1e3)
    return dict(pair_hw=[480, 640], one_thread_ms=float(np.median(one)),
                batch_2_threads_ms=float(np.median(batch)), reps=DECODE_REPS)


def _lay_out_trees(root: str) -> dict:
    """A LasHeR tree (TestingSet and TrainingSet, FILE_SEQS sequences of
    FILE_FRAMES frames each, cycling the committed 640x480 pairs through
    links; init.txt the boxes of the synthetic frames the pairs were written
    from) and a DepthTrack tree (test/<group>/<seq>: DEPTH_FRAMES colour
    frames, linked, and 16-bit depth maps written here with `_png_bytes`).
    Returns the local paths naming them."""
    from multi_modal_tracking_torch.train.data.datasets.synthetic import SyntheticRGBT
    src = SyntheticRGBT(n_sequences=2, n_frames=2, H=480, W=640)
    pairs = [(os.path.join(FIXTURES, f"pair{k}_v.jpg"), os.path.join(FIXTURES, f"pair{k}_i.jpg"),
              src._seq(k)[2][1]) for k in range(2)]
    for split in ("TestingSet/testingset", "TrainingSet/trainingset"):
        for q in range(FILE_SEQS):
            base = os.path.join(root, "lasher", split, f"seq{q:02d}")
            boxes = []
            for t in range(FILE_FRAMES):
                pv, pi, box = pairs[(t + q) % 2]
                for d, target in (("visible", pv), ("infrared", pi)):
                    os.makedirs(os.path.join(base, d), exist_ok=True)
                    os.symlink(target, os.path.join(base, d, f"{t:06d}.jpg"))
                boxes.append(box)
            np.savetxt(os.path.join(base, "init.txt"), np.asarray(boxes), fmt="%d", delimiter=",")
    base = os.path.join(root, "depthtrack", "test", "group01", "seq00")
    os.makedirs(os.path.join(base, "color"))
    os.makedirs(os.path.join(base, "depth"))
    yy, xx = np.mgrid[0:480, 0:640]
    boxes = []
    for t in range(DEPTH_FRAMES):
        pv, _, box = pairs[t % 2]
        os.symlink(pv, os.path.join(base, "color", f"{t:08d}.jpg"))
        dp = (1500 + 6 * xx + 4 * yy + 13 * t).astype(np.uint16)
        x, y, w, h = (int(v) for v in box)
        dp[y:y + h, x:x + w] = 700 + t                  # the target nearer the camera
        with open(os.path.join(base, "depth", f"{t:08d}.png"), "wb") as f:
            f.write(_png_bytes(dp))
        boxes.append(box)
    np.savetxt(os.path.join(base, "groundtruth.txt"), np.asarray(boxes), fmt="%d", delimiter=",")
    return {"lasher_dir": os.path.join(root, "lasher"),
            "depthtrack_dir": os.path.join(root, "depthtrack")}


def _files_vs_arrays(seq, dtype, root: str) -> tuple:
    """create_tracker's flagship tracker (full width, seed 0, graphed) on a
    LasHeR sequence read from files and on the same frames decoded first
    and handed over as arrays: the boxes and result files the same bits,
    the same launches; frames/s of each on the host clock (a run on the
    arrays first captures the graphs, untimed). Returns (line, launches)."""
    from multi_modal_tracking_torch import native
    from multi_modal_tracking_torch.eval.data import RGBTSequence
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.running import run_dataset
    label = "f32" if dtype == torch.float32 else "bf16"
    kernels = ("K1", "K3") if dtype == torch.float32 else BF16_SERVING
    arrays = RGBTSequence(seq.name, [tuple(native.imread(p) for p in fr) for fr in seq.frames],
                          seq.dataset, seq.ground_truth_rect)
    tracker = create_tracker(_params(), "lasher", seed=0, dtype=dtype)
    run_dataset([arrays], tracker, os.path.join(root, label, "warm"), chunk=EVAL_CHUNK)
    runs = {}
    for name, s in (("files", seq), ("arrays", arrays)):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = run_dataset([s], tracker, os.path.join(root, label, name), chunk=EVAL_CHUNK)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs[name] = dict(boxes=stats[0]["boxes"], seconds=secs, fps=len(s.frames) / secs,
                          launches=read_launches())
        with open(os.path.join(root, label, name, f"{seq.name}.txt"), "rb") as f:
            runs[name]["file"] = f.read()
    a, b = runs["files"], runs["arrays"]
    require(np.array_equal(a["boxes"], b["boxes"]) and a["file"] == b["file"]
            and a["launches"] == b["launches"] and all(a["launches"][k] > 0 for k in kernels)
            and not any(a["launches"][k] for k in F32_KERNELS + BF16_KERNELS if k not in kernels)
            and _inside(a["boxes"], 480, 640),
            f"{label} tracking from files against arrays: boxes differ by "
            f"{float(np.abs(a['boxes'] - b['boxes']).max())} px, launches {a['launches']} vs "
            f"{b['launches']}")
    del tracker
    torch.cuda.empty_cache()
    line = dict(dtype=label, frames=len(seq.frames), check="files == arrays, bit for bit",
                files_fps=a["fps"], arrays_fps=b["fps"], files_over_arrays=a["fps"] / b["fps"],
                launches={k: a["launches"][k] for k in kernels})
    return line, {k: a["launches"][k] + b["launches"][k] for k in kernels}


def _eval_cli_on(name: str, root: str, n_seqs: int, n_frames: int) -> tuple:
    """`eval.run` of the flagship recipe (bf16, graphed) on a file tree:
    every sequence's result file with finite boxes inside the frame.
    Returns (line, its results directory, launches)."""
    from multi_modal_tracking_torch.eval.run import main as eval_cli
    reset_launches()
    t0 = time.perf_counter()
    dirs = eval_cli([SCRIPT, RECIPE, "--dataset_name", name, "--results_dir",
                     os.path.join(root, name)])
    secs = time.perf_counter() - t0
    launches = read_launches()
    files = sorted(f for f in os.listdir(dirs[0]) if f.endswith(".txt")
                   and not f.endswith(("_time.txt", "_score.txt")))
    boxes = [np.loadtxt(os.path.join(dirs[0], f)) for f in files]
    require(len(files) == n_seqs and all(b.shape == (n_frames, 4) and _inside(b, 480, 640)
                                         for b in boxes)
            and all(launches[k] > 0 for k in BF16_SERVING),
            f"eval.run --dataset_name {name}: files {files}, launches {launches}")
    return (dict(sequences=n_seqs, frames=n_seqs * n_frames, seconds_with_build=secs,
                 launches={k: launches[k] for k in BF16_SERVING}), dirs[0], launches)


def _train_from_files(save_dir: str) -> tuple:
    """The flagship recipe's Trainer (bf16, graphed, batch 16) on the LasHeR
    training tree: FILE_TRAIN_STEPS steps through cycle_dataset (the loader
    decoding the files, the one-batch look-ahead); then the loader alone
    (ms per batch of 16 from files) and the isolated graphed step. Returns
    (line, launches)."""
    from multi_modal_tracking_torch.train.builders import build_train_loader
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    from multi_modal_tracking_torch.train.train_step import model_inputs
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg = _train_cfg(TRAIN_B, FILE_TRAIN_STEPS)
    cfg.DATA.TRAIN.DATASETS_NAME = ["LasHeR"]
    cfg.DATA.TRAIN.DATASETS_RATIO = [1]
    tr = Trainer(SCRIPT, cfg, save_dir=save_dir, device="cuda", seed=0,
                 print_interval=FILE_TRAIN_STEPS)
    require(tr.dtype == torch.bfloat16 and tr._step.graphs is not None, f"Trainer {tr.dtype}")
    reset_launches()
    tr.epoch = 1
    t0 = time.perf_counter()
    tr.cycle_dataset()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    losses = [m["Loss/total"] for m in tr.history]
    want = {k: v * FILE_TRAIN_STEPS for k, v in TRAIN_LAUNCHES[torch.bfloat16].items()}
    require(len(losses) == FILE_TRAIN_STEPS and all(np.isfinite(losses))
            and {k: launches[k] for k in want} == want and len(tr._step.graphs) >= 1,
            f"training from files: losses {losses}, launches {launches}, graphs "
            f"{len(tr._step.graphs)}")
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = TRAIN_B * LOADER_BATCHES
    batches, loader_ms = _timed_batches(build_train_loader(cfg, seed=4), LOADER_BATCHES)
    x = model_inputs(batch_to_model_inputs(batches[0], rgbt=True), "cuda")
    reset_launches()
    iso = _isolated_steps(lambda inputs, _keep: tr._step(inputs, None), x)
    step_launches = read_launches()
    line = dict(steps=FILE_TRAIN_STEPS, batch=TRAIN_B, loss=losses, graphs=len(tr._step.graphs),
                epoch_seconds_with_captures=secs, loader_ms_per_batch=loader_ms,
                loader_threads=cfg.TRAIN.NUM_WORKER, step_ms=iso["ms_per_step_median"],
                loader_over_step=loader_ms / iso["ms_per_step_median"])
    del tr, batches, x
    gc.collect()
    torch.cuda.empty_cache()
    return line, {k: launches[k] + step_launches[k] for k in want}


def _ce_inputs(g: torch.Generator, B: int = 2) -> list:
    t, ot = (torch.randn(2 * B, 128, 128, 3, generator=g) for _ in range(2))
    s = torch.randn(2 * B, 288, 288, 3, generator=g)
    xy, wh = torch.rand(B, 2, generator=g) * 0.4 + 0.2, torch.rand(B, 2, generator=g) * 0.2 + 0.2
    return [x.cuda() for x in (t, ot, s, torch.cat([xy, wh], 1))]


def _ce_forward_graphed_vs_eager(model, inputs: list, boxes: bool) -> dict:
    """The full forward of a CE model (the GT_BOX boxes a static input like
    the crops) as a CUDA graph (`StepGraphs.run`: the first call eager,
    then captured) on the input sets in turn, against the same forward
    eager on each: the boxes the same bits."""
    from multi_modal_tracking_torch.tracking.graphs import StepGraphs
    static = [x.clone() for x in inputs[0]]
    out = torch.empty(inputs[0][2].shape[0] // 2, 1, 4, device="cuda")
    graphs = StepGraphs(torch.device("cuda"), "CE forward")

    def step():
        with torch.no_grad():
            out.copy_(model(*static[:3], ce_gt_boxes=static[3] if boxes else None)["pred_boxes"])
    got = []
    for x in inputs:
        for dst, src in zip(static, x):
            dst.copy_(src)
        graphs.run(("ce",), step)
        got.append(out.clone())
    with torch.no_grad():
        want = [model(*x[:3], ce_gt_boxes=x[3] if boxes else None)["pred_boxes"] for x in inputs]
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(_bits(a), _bits(b))]
    require(not diff and len(graphs) == 1 and all(torch.isfinite(a).all() for a in got),
            f"CE forward graphed vs eager: input sets {diff} differ")
    return dict(check="graphed == eager, bit for bit", calls=len(inputs), graphs=len(graphs))


def _ce_modes(frames, g: torch.Generator) -> tuple:
    """The CE template-range modes at full width (flagship recipe, seed 0):
    CTR_REC, ALL and GT_BOX, bf16 and f32, the full forward graphed against
    eager (GT_BOX with its boxes), and for CTR_REC and ALL create_tracker's
    cached tracker graphed against its eager twin over CE_FRAMES frames
    (the modes' rows in the search step's ranking), bit for bit. Returns
    (line, launches by dtype)."""
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    launches = {torch.float32: dict.fromkeys(F32_KERNELS, 0),
                torch.bfloat16: dict.fromkeys(BF16_KERNELS, 0)}
    inputs = [_ce_inputs(g) for _ in range(2)]
    inputs.append(inputs[0])
    out = {}
    for mode in ("CTR_REC", "ALL", "GT_BOX"):
        for dtype in (torch.bfloat16, torch.float32):
            label = f"{mode} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
            kernels = ("K1", "K3") if dtype == torch.float32 else BF16_SERVING
            params = _params()
            params.cfg.MODEL.BACKBONE.CE_TEMPLATE_RANGE = mode
            tracker = create_tracker(params, seed=0, dtype=dtype)
            require(tracker.model.backbone.ce_template_range == mode, f"{label}: built "
                    f"{tracker.model.backbone.ce_template_range}")
            reset_launches()
            line = dict(forward=_ce_forward_graphed_vs_eager(tracker.model, inputs,
                                                             mode == "GT_BOX"))
            got = read_launches()
            if mode != "GT_BOX":
                run_g = _family_run(tracker, frames[:CE_FRAMES], timed_from=2)
                run_e = _family_run(_tracker_twin(tracker, graphs=False), frames[:CE_FRAMES],
                                    timed_from=2)
                require(np.array_equal(run_g["boxes"], run_e["boxes"])
                        and run_g["launches"] == run_e["launches"],
                        f"{label} tracker graphed vs eager: "
                        f"{float(np.abs(run_g['boxes'] - run_e['boxes']).max())} px, "
                        f"launches {run_g['launches']} vs {run_e['launches']}")
                line["tracker"] = dict(check="graphed == eager, bit for bit",
                                       frames=CE_FRAMES, ms_per_frame=run_g["ms_per_frame"])
                _add_launches(got, run_g["launches"], kernels)
                _add_launches(got, run_e["launches"], kernels)
            require(all(got[k] > 0 for k in kernels)
                    and not any(got[k] for k in F32_KERNELS + BF16_KERNELS if k not in kernels),
                    f"{label}: launches {got}")
            _add_launches(launches[dtype], got, kernels)
            line["launches"] = {k: got[k] for k in kernels}
            out[label] = line
            del tracker
            torch.cuda.empty_cache()
    return out, launches


def _cvt_trainable_bn(save_dir: str) -> tuple:
    """CvT-21 (mixformer_cvt/baseline) with BACKBONE.FREEZE_BN false: 2
    bf16 steps at batch 8 graphed against eager (`_graphed_vs_eager_in_place`:
    weights, the projection BNs' running statistics, moments, counters and
    generator the same bits), the running statistics moved by the steps.
    Returns (line, launches)."""
    from multi_modal_tracking_torch.train.builders import build_train_loader
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    from multi_modal_tracking_torch.train.train_step import model_inputs
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg = _uni_train_cfg(CVT, "baseline", CVT_B, 2)
    cfg.MODEL.BACKBONE.FREEZE_BN = False
    tr = Trainer(CVT, cfg, save_dir=save_dir, device="cuda", seed=0, print_interval=2)
    stats = {k: v for k, v in tr.model.state_dict().items()
             if ".conv_proj_" in k and k.endswith(("running_mean", "running_var"))}
    require(tr.dtype == torch.bfloat16 and len(stats) == 2 * 3 * sum(tr.model.spec.depth),
            f"CvT trainable BN: {len(stats)} running statistics")
    before = {k: v.clone() for k, v in stats.items()}
    batches = [model_inputs(batch_to_model_inputs(b, rgbt=False), "cuda")
               for b in build_train_loader(cfg, seed=4)]
    check = _graphed_vs_eager_in_place(tr, batches)
    moved = sum(not torch.equal(v, before[k]) for k, v in stats.items())
    require(moved == len(stats) and check["launches"]["AdamW"] == 2
            and not any(check["launches"][k] for k in F32_KERNELS + BF16_KERNELS),
            f"CvT trainable BN: {moved} of {len(stats)} statistics moved, launches "
            f"{check['launches']}")
    line = dict(recipe=f"{CVT}/baseline", freeze_bn=False, batch=CVT_B, graphed_vs_eager=check,
                running_statistics=len(stats), moved=moved)
    launches = {"AdamW": check["launches"]["AdamW"]}
    del tr, batches
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches


def phase_files(smi: str, frames, save_dir: str) -> dict:
    """The file-based data path (module docstring, phase 18): the port's
    decoder on the committed fixtures, LasHeR and DepthTrack trees read by
    the trackers, eval.run and the Trainer, the CE template-range modes and
    CvT's trainable BN. Returns the launch counts by dtype."""
    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.packaging import transform_got10k
    t0 = time.perf_counter()
    f32 = dict.fromkeys(F32_KERNELS + ("AdamW",), 0)
    bf16 = dict.fromkeys(BF16_KERNELS + ("AdamW",), 0)
    res = dict(fixtures=_fixtures_against_manifest(), decode=_decode_ms())
    old_paths = os.environ.get("MMT_LOCAL_PATHS")
    with tempfile.TemporaryDirectory() as root:
        paths = _lay_out_trees(root)
        local = os.path.join(root, "local_paths.json")
        with open(local, "w") as f:
            json.dump(paths, f)
        os.environ["MMT_LOCAL_PATHS"] = local
        try:
            seqs = get_dataset("lasher")
            require(len(seqs) == FILE_SEQS and len(seqs[0].frames) == FILE_FRAMES
                    and isinstance(seqs[0].frames[0][0], str), f"lasher: {len(seqs)} sequences")
            for dtype, totals in ((torch.bfloat16, bf16), (torch.float32, f32)):
                line, counts = _files_vs_arrays(seqs[0], dtype, os.path.join(root, "track"))
                res[f"track_{line['dtype']}"] = line
                _add_launches(totals, counts, counts)
            res["eval_run_lasher"], out_dir, counts = _eval_cli_on("lasher", root, FILE_SEQS,
                                                                   FILE_FRAMES)
            _add_launches(bf16, counts, BF16_SERVING)
            zip_path = transform_got10k(out_dir, os.path.join(root, "zip"), "flagship")
            res["got10k_zip_bytes"] = os.path.getsize(zip_path)
            res["eval_run_depthtrack"], _, counts = _eval_cli_on("depthtrack", root, 1,
                                                                 DEPTH_FRAMES)
            _add_launches(bf16, counts, BF16_SERVING)
            res["train_bf16"], counts = _train_from_files(save_dir)
            _add_launches(bf16, counts, counts)
        finally:
            if old_paths is None:
                os.environ.pop("MMT_LOCAL_PATHS", None)
            else:
                os.environ["MMT_LOCAL_PATHS"] = old_paths
    res["ce_modes"], counts = _ce_modes(frames, torch.Generator().manual_seed(18))
    _add_launches(f32, counts[torch.float32], F32_KERNELS)
    _add_launches(bf16, counts[torch.bfloat16], BF16_KERNELS)
    res["cvt_trainable_bn"], counts = _cvt_trainable_bn(save_dir)
    bf16["AdamW"] += counts["AdamW"]
    emit({"phase": "files", "card": smi, **res, "seconds": time.perf_counter() - t0})
    return {"f32": f32, "bf16": bf16}


# ---------------------------------------------------------------- parallel
PAR_STEPS = 3                      # bf16 graphed steps: NCCL world 1, remat
PAR_GLOO_STEPS = 2                 # f32 eager steps over two gloo ranks
PAR_EVAL_SEQS = 6                  # synthetic_rgbt_hard sequences run over two workers
#: f32 bounds of a data-parallel (or FSDP) run against the one-process run
#: from the same weights: the order of every sum differs (a half batch a
#: rank, the synced BN's two passes, the gradient average). Step 1 runs on
#: the same weights: its loss within 1e-5 rel, its grad norm within 1e-3
#: rel and its clipped gradients all together within 1e-2 of their norm
#: (the train phases' GPU-vs-CPU bounds); step 2's loss and grad norm
#: within 1e-3 rel. The weights after step 2 are not held: AdamW moves
#: every element by about lr whatever its gradient's size, so a
#: rounding-noise gradient (a conv bias before a BN) moves by +-lr in
#: either run
PAR_F32 = dict(loss1_rel=1e-5, grad_norm1_rel=1e-3, grads1=1e-2, metrics2_rel=1e-3)


#: random layers off: each rank draws its own masks for its part of the
#: batch, so a run over ranks matches the one-process run only without them
NO_DROP = dict(drop_path_rate=0.0, fusion_dropout=0.0)


def _par_trainer(dtype, graphs: bool, steps: int, save_dir: str, device="cuda",
                 remat: bool = False, fsdp: bool = False, spec_overrides=None):
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg = _train_cfg(TRAIN_B, steps)
    cfg.TRAIN.REMAT, cfg.TRAIN.FSDP = remat, fsdp
    return Trainer(SCRIPT, cfg, save_dir=save_dir, device=device, seed=0, dtype=dtype,
                   graphs=graphs, spec_overrides=spec_overrides)


def _local_part(x: dict, rank: int, world: int) -> dict:
    """A rank's part of a global batch of model inputs: its slice of the
    samples, RGB then TIR."""
    B = x["gt_xywh"].shape[0]
    lo, hi = rank * B // world, (rank + 1) * B // world
    return {k: torch.cat([v[lo:hi], v[B + lo:B + hi]]) if v.shape[0] == 2 * B else v[lo:hi]
            for k, v in x.items()}


def _run_steps(tr, batches, keep=1.0, first_grads=None) -> list:
    """The Trainer's step on each batch; its metrics. With a dict
    `first_grads`, fill it with the first step's clipped gradients by
    parameter name (each shard gathered, on the CPU)."""
    out = []
    for i, x in enumerate(batches):
        out.append({k: float(v) for k, v in tr._step(x, ce_keep_rate=keep).items()})
        if i == 0 and first_grads is not None:
            names = [n for n, _ in tr.model.named_parameters()]
            first_grads.update({n: _gathered(g).detach().cpu()
                                for n, g in zip(names, tr.optimizer.grads)})
    return out


def _gathered(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of an FSDP shard (a DTensor; a collective), any
    other tensor as it is. Over gloo the shards are gathered as CPU tensors
    with a plain all_gather: with torch 2.11's gloo, the functional
    collectives that DTensor.full_tensor runs ended the process on CUDA
    tensors (a segmentation fault), which FSDP2's own collectives did not."""
    if not hasattr(t, "to_local"):
        return t
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    if dist.get_backend() != "gloo":
        return t.full_tensor()
    local = t.to_local().detach().cpu().contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    dim, = [p.dim for p in t.placements if isinstance(p, Shard)]
    return torch.cat(parts, dim=dim)


def _rank_bytes(tr) -> dict:
    """This rank's bytes of parameters, of AdamW's moments, and of the
    parameters it holds whole (replicated)."""
    from multi_modal_tracking_torch.parallel.mesh import local_tensor
    opt = tr.optimizer
    return dict(params=sum(local_tensor(p).numel() * 4 for p in opt.params),
                moments=sum(m.numel() * 4 for g in opt.groups for m in opt.mu[g] + opt.nu[g]),
                replicated=sum(p.numel() * 4 for p, sh in zip(opt.params, opt.sharded)
                               if not sh))


def _peak(fn) -> dict:
    """fn() with the allocator's peak reset before it: (its result, the
    peak bytes allocated)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def _par_run(tr, batches) -> dict:
    """PAR_GLOO_STEPS steps: the metrics and the first step's gradients
    (shards gathered, on the CPU)."""
    grads1 = {}
    metrics = _run_steps(tr, batches, first_grads=grads1)
    return dict(metrics=metrics, grads1=grads1)


def _par_close(got: dict, want: dict) -> dict:
    """`_par_run` results `got` against `want`: the PAR_F32 distances."""
    m1, w1 = got["metrics"][0], want["metrics"][0]
    res = dict(loss1_rel=abs(m1["Loss/total"] - w1["Loss/total"]) / abs(w1["Loss/total"]),
               grad_norm1_rel=abs(m1["grad_norm"] - w1["grad_norm"]) / w1["grad_norm"],
               grads1=_rel_dist(got["grads1"], want["grads1"], ("",)),
               metrics2_rel=max(abs(g[k] - w[k]) / abs(w[k])
                                for g, w in zip(got["metrics"][1:], want["metrics"][1:])
                                for k in ("Loss/total", "grad_norm")))
    res["within"] = all(res[k] <= PAR_F32[k] for k in PAR_F32)
    return res


def _par_child_gloo(rank: int, world: int, workdir: str) -> dict:
    """Two gloo ranks on the one card: DP and FSDP, f32 eager, against the
    one-process step the parent saved."""
    from multi_modal_tracking_torch.parallel import distributed as D
    D.initialize_distributed(f"file://{workdir}/gloo_store", world, rank, device="cuda",
                             backend="gloo")
    dev = torch.device("cuda", 0)
    batches = torch.load(os.path.join(workdir, "batches.pt"), weights_only=True)
    local = [{k: v.to(dev) for k, v in _local_part(x, rank, world).items()} for x in batches]
    ref = torch.load(os.path.join(workdir, "one_process.pt"), weights_only=False)
    out = dict(rank=rank)
    with tempfile.TemporaryDirectory() as save_dir:
        reset_launches()
        tr = _par_trainer(torch.float32, False, PAR_GLOO_STEPS, save_dir, device=dev,
                          spec_overrides=NO_DROP)
        require(tr.dp is not None and tr.dp.world == world, "gloo DP: no group in the Trainer")
        dp_run = _par_run(tr, local)
        out["launches"] = read_launches()
        out["dp"] = dict(metrics=dp_run["metrics"], bytes=_rank_bytes(tr),
                         vs_one_process=_par_close(dp_run, ref))
        del tr
        torch.cuda.empty_cache()
        reset_launches()
        fs = _par_trainer(torch.float32, False, PAR_GLOO_STEPS, save_dir, device=dev,
                          fsdp=True, spec_overrides=NO_DROP)
        fs_run = _par_run(fs, local)
        out["fsdp_launches"] = read_launches()
        out["fsdp"] = dict(metrics=fs_run["metrics"], bytes=_rank_bytes(fs),
                           n_sharded=sum(fs.optimizer.sharded),
                           vs_dp=_par_close(fs_run, dp_run),
                           vs_one_process=_par_close(fs_run, ref))
        del fs
    D.shutdown_distributed()
    return out


def _par_child_nccl(rank: int, world: int, workdir: str) -> dict:
    """NCCL at world 1: the one-GPU graphed bf16 trainer, remat graphed and
    eager, then the group and the DP trainer, graphed, held against the
    one-GPU one bit for bit."""
    from multi_modal_tracking_torch.parallel import distributed as D
    batches = _train_batches(PAR_STEPS)
    out = {}

    def run(tr) -> tuple:
        """PAR_STEPS steps (peak bytes), the state after them, then 3
        isolated steps at the final keep (ms)."""
        metrics, peak = _peak(lambda: _run_steps(tr, batches))
        state = {k: v.clone() for k, v in _train_state(tr).items()}
        pool = tr._step.graphs.pool_bytes() if tr._step.graphs is not None else 0
        ms = _isolated_steps(tr._step, batches[0], n=3)["ms_per_step_median"]
        return metrics, state, dict(peak_bytes=peak, pool_bytes=pool, ms_per_step_median=ms)

    with tempfile.TemporaryDirectory() as save_dir:
        torch.cuda.empty_cache()
        one = _par_trainer(torch.bfloat16, True, PAR_STEPS, save_dir)
        one_metrics, one_state, one_mem = run(one)
        del one
        torch.cuda.empty_cache()
        reset_launches()
        rg = _par_trainer(torch.bfloat16, True, PAR_STEPS, save_dir, remat=True)
        require(rg.model.backbone.remat, "TRAIN.REMAT did not reach the backbone")
        rg_metrics, rg_peak = _peak(lambda: _run_steps(rg, batches))
        remat_launches = read_launches()
        rg_state = {k: v.clone() for k, v in _train_state(rg).items()}
        rg_mem = dict(peak_bytes=rg_peak, pool_bytes=rg._step.graphs.pool_bytes(),
                      ms_per_step_median=_isolated_steps(rg._step, batches[0], n=3)[
                          "ms_per_step_median"])
        del rg
        torch.cuda.empty_cache()
        re = _par_trainer(torch.bfloat16, False, PAR_STEPS, save_dir, remat=True)
        re_metrics, re_state, re_mem = run(re)
        del re
        torch.cuda.empty_cache()
        graphed_vs_eager = _differing(rg_state, re_state)
        vs_plain = _differing(re_state, one_state)
        out["remat_launches"] = remat_launches
        out["remat"] = dict(
            launches_per_step={k: remat_launches[k] / PAR_STEPS
                               for k in TRAIN_LAUNCHES[torch.bfloat16]},
            graphed=rg_mem, eager=re_mem, no_remat_graphed=one_mem,
            graphed_vs_eager_differing=graphed_vs_eager,
            vs_no_remat_metrics_equal=re_metrics == one_metrics,
            vs_no_remat_differing=len(vs_plain),
            vs_no_remat_weights_rel=_rel_dist(re_state, one_state, ("net/",)))
        require(rg_mem["peak_bytes"] < one_mem["peak_bytes"],
                f"remat's peak is not below the step's without it: {out['remat']}")
        require(rg_metrics == re_metrics and not graphed_vs_eager,
                f"remat graphed != eager: {out['remat']}")
        require(out["remat"]["vs_no_remat_weights_rel"] <= 1e-6,
                f"remat moved the weights away from the step without it: {out['remat']}")
        del rg_state, re_state

        require(D.initialize_distributed(f"file://{workdir}/nccl_store", world, rank,
                                         device="cuda"), "no NCCL group formed")
        out["nccl_version"] = ".".join(str(v) for v in torch.cuda.nccl.version())
        reset_launches()
        dp = _par_trainer(torch.bfloat16, True, PAR_STEPS, save_dir, device=D.local_device())
        require(dp.dp is not None and dp.dp.backend == "nccl" and dp.dp.capturable,
                "NCCL DP: the Trainer has no capturable group")
        dp_metrics = _run_steps(dp, batches)
        out["launches"] = read_launches()
        dp_state = _train_state(dp)
        differing = _differing(dp_state, one_state)
        out["dp_world1"] = dict(
            graphs=len(dp._step.graphs), metrics_equal=dp_metrics == one_metrics,
            n_differing=len(differing), differing=differing[:8],
            max_abs_diff=max([float((dp_state[k].float() - one_state[k].float()).abs().max())
                              for k in differing if dp_state[k].is_floating_point()] or [0.0]))
        require(dp_metrics == one_metrics and not differing,
                f"NCCL world-1 DP != the one-GPU trainer: {out['dp_world1']}")
        del dp, dp_state
    D.shutdown_distributed()
    return out


def _par_spawn(case: str, world: int, workdir: str, timeout: float = 600.0) -> list:
    """Run `case` on `world` child processes of this script; their results.
    A child that fails fails the phase (CalledProcessError)."""
    procs = [subprocess.Popen([sys.executable, "-X", "faulthandler", os.path.abspath(__file__),
                               "_parallel_rank", case, str(r), str(world), workdir])
             for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p in procs:
        if p.returncode:
            raise subprocess.CalledProcessError(p.returncode, p.args)
    return [json.load(open(os.path.join(workdir, f"{case}_{r}.json"))) for r in range(world)]


def _par_eval_devices(smi: str) -> tuple:
    """run_dataset over two worker threads pinned to cuda:0 against the
    sequential run, bit for bit (the files and the boxes), with the same
    launches (each graph counts its own thread's launches at capture).
    Returns (line, the two workers' launches)."""
    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.running import run_dataset
    name = "synthetic_rgbt_hard"
    seqs = get_dataset(name, n_frames=HARD_FRAMES)[:PAR_EVAL_SEQS]
    params = _params()
    made = []

    def factory(device):
        made.append(str(device))
        return create_tracker(params, name, device=device, seed=0)
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        one = run_dataset(seqs, factory("cuda:0"), os.path.join(root, "one"))
        t1 = time.perf_counter()
        one_launches = read_launches()
        made.clear()
        reset_launches()
        two = run_dataset(seqs, None, os.path.join(root, "two"), threads=2,
                          tracker_factory=factory, devices=["cuda:0", "cuda:0"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read_launches()
        same_files = all(open(os.path.join(root, "one", f"{q.name}.txt"), "rb").read() ==
                         open(os.path.join(root, "two", f"{q.name}.txt"), "rb").read()
                         for q in seqs)
    same_boxes = [a["seq"] for a in one] == [b["seq"] for b in two] and all(
        np.array_equal(a["boxes"], b["boxes"]) for a, b in zip(one, two))
    res = dict(sequences=len(seqs), frames=sum(len(q.frames) for q in seqs), workers=made,
               same_files=same_files, same_boxes=same_boxes, one_worker_s=t1 - t0,
               two_workers_s=t2 - t1,
               one_worker_launches={k: one_launches[k] for k in BF16_SERVING},
               two_workers_launches={k: launches[k] for k in BF16_SERVING})
    require(same_files and same_boxes and len(made) == 2 and
            all(launches[k] > 0 and launches[k] == one_launches[k] for k in BF16_SERVING),
            f"run_dataset over devices != sequential: {res}")
    return res, launches


def phase_parallel(smi: str, frames, save_dir: str) -> dict:
    """Multi-GPU slice on the one card (module docstring, phase 19): child
    processes for everything that forms a process group (the main process
    never does). Returns the launch counts of its paths: `f32` gloo DP,
    `fsdp` FSDP over gloo (f32), `bf16` NCCL DP, `remat_bf16` the graphed
    remat steps, `eval_bf16` the two eval workers."""
    t0 = time.perf_counter()
    out = {path: dict.fromkeys((F32_KERNELS if path in ("f32", "fsdp") else BF16_KERNELS)
                               + ("AdamW",), 0)
           for path in ("f32", "fsdp", "bf16", "remat_bf16", "eval_bf16")}
    # the one-process f32 reference of the gloo runs, saved for the children
    workdir, one_bytes = _par_reference(save_dir)
    seconds = {"one_process": time.perf_counter() - t0}
    gloo = _par_spawn("gloo", 2, workdir)
    seconds["gloo"] = time.perf_counter() - t0 - sum(seconds.values())
    for r in gloo:
        require(r["dp"]["vs_one_process"]["within"],
                f"gloo DP rank {r['rank']} against the one-process step: {r['dp']}")
        _add_launches(out["f32"], r["launches"], out["f32"])
        _add_launches(out["fsdp"], r["fsdp_launches"], out["fsdp"])
        fs = r["fsdp"]
        require(fs["vs_dp"]["within"], f"FSDP rank {r['rank']} against DP: {fs}")
        got, dp, rep = fs["bytes"], r["dp"]["bytes"], fs["bytes"]["replicated"]
        require(got["params"] <= 0.5 * dp["params"] + rep
                and got["moments"] <= 0.5 * dp["moments"] + 2 * rep,
                f"FSDP rank {r['rank']} holds {got} against DP's {dp}")
    nccl, = _par_spawn("nccl", 1, workdir)
    seconds["nccl"] = time.perf_counter() - t0 - sum(seconds.values())
    _add_launches(out["bf16"], nccl["launches"], out["bf16"])
    _add_launches(out["remat_bf16"], nccl["remat_launches"], out["remat_bf16"])
    evals, launches = _par_eval_devices(smi)
    seconds["eval"] = time.perf_counter() - t0 - sum(seconds.values())
    _add_launches(out["eval_bf16"], launches, BF16_SERVING)
    require(all(out[p]["AdamW"] > 0 for p in ("f32", "fsdp", "bf16", "remat_bf16")),
            f"a parallel training path launched no AdamW: {out}")
    emit({"phase": "parallel", "card": smi, "nccl": nccl["nccl_version"],
          "dp_nccl_world1_bf16_graphed": nccl["dp_world1"],
          "dp_gloo_2ranks_f32": [dict(r["dp"], rank=r["rank"]) for r in gloo],
          "fsdp_gloo_2ranks_f32": [dict(r["fsdp"], rank=r["rank"]) for r in gloo],
          "one_process_bytes": one_bytes, "remat_bf16": nccl["remat"], "eval_devices": evals,
          "bounds": PAR_F32, "batch": TRAIN_B, "launches_by_path": out,
          "seconds_by_part": seconds, "seconds": time.perf_counter() - t0})
    return out


def _par_reference(save_dir: str) -> tuple:
    """A work directory holding PAR_GLOO_STEPS batches of the recipe and the
    one-process f32 run on them (random layers off), for the children;
    (workdir, that run's parameter and moment bytes)."""
    workdir = tempfile.mkdtemp(dir=save_dir)
    batches = _train_batches(PAR_GLOO_STEPS, seed=7)
    torch.save([{k: v.cpu() for k, v in x.items()} for x in batches],
               os.path.join(workdir, "batches.pt"))
    tr = _par_trainer(torch.float32, False, PAR_GLOO_STEPS, save_dir, spec_overrides=NO_DROP)
    torch.save(_par_run(tr, batches), os.path.join(workdir, "one_process.pt"))
    one_bytes = _rank_bytes(tr)
    del tr, batches
    torch.cuda.empty_cache()
    return workdir, one_bytes


def _parallel_rank(argv) -> None:
    """A child of phase_parallel: `_parallel_rank CASE RANK WORLD WORKDIR`;
    writes WORKDIR/CASE_RANK.json."""
    case, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    fn = {"gloo": _par_child_gloo, "nccl": _par_child_nccl}[case]
    out = fn(rank, world, workdir)
    with open(os.path.join(workdir, f"{case}_{rank}.json"), "w") as f:
        json.dump(out, f)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["_parallel_rank"]:              # a child of phase_parallel
        require(torch.cuda.is_available(), "no CUDA device")
        _parallel_rank(argv[1:])
        return
    dev, smi = phase_device()
    phase_build()
    phases = {"families": phase_families, "unimodal": phase_unimodal, "drift": phase_drift,
              "large": phase_large,
              "cvt_convmae": phase_cvt_convmae, "files": phase_files,
              "parallel": phase_parallel}
    if len(argv) == 1 and argv[0] in phases:    # one phase alone (module docstring)
        frames = list(_sequence(74))
        with tempfile.TemporaryDirectory() as save_dir:
            launches = phases[argv[0]](smi, frames, save_dir)
        emit({"phase": f"{argv[0]} launches", **launches})
        return
    require(not argv, f"unknown arguments {argv}: none, or one of {sorted(phases)}")
    laps = [("start", time.perf_counter())]

    def lap(name: str) -> None:
        """Mark the end of a phase: its seconds go to the "phase seconds" line."""
        laps.append((name, time.perf_counter()))

    phase_bf16_reduction(smi)
    warm_profiler()
    g = torch.Generator().manual_seed(0)
    kernels = phase_kernels(g)
    lap("kernels")
    phase_model(g)
    frames = list(_sequence(74))
    track_launches, tracker, f32_boxes = phase_tracker(smi, frames[:64])
    phase_profile(tracker, frames[64:], smi)
    del tracker
    lap("model, tracker, profile")
    graph_launches = phase_graphs(smi, frames)
    lap("graphs")
    phase_train_data(smi)
    lap("train data")
    with tempfile.TemporaryDirectory() as save_dir:
        train_launches, _ = phase_train(smi, save_dir, torch.float32)
    lap("train")
    with tempfile.TemporaryDirectory() as save_dir:
        train_bf16_launches, bf16_step_ms = phase_train(smi, save_dir, torch.bfloat16)
    lap("train bf16")
    life_launches = phase_lifecycle(smi, frames, bf16_step_ms)
    lap("lifecycle")
    eval_launches, f32_eval = phase_eval(smi)
    lap("eval")
    bf16 = phase_bf16(smi, frames, f32_boxes, f32_eval)
    lap("bf16")
    online = phase_online(smi, frames)
    lap("online")
    with tempfile.TemporaryDirectory() as save_dir:
        stage2 = phase_stage2(smi, save_dir)
    lap("stage2")
    with tempfile.TemporaryDirectory() as save_dir:
        families = phase_families(smi, frames, save_dir)
    lap("families")
    with tempfile.TemporaryDirectory() as save_dir:
        unimodal = phase_unimodal(smi, frames, save_dir)
    lap("unimodal")
    with tempfile.TemporaryDirectory() as save_dir:
        cvt_convmae = phase_cvt_convmae(smi, frames, save_dir)
    lap("cvt_convmae")
    with tempfile.TemporaryDirectory() as save_dir:
        files = phase_files(smi, frames, save_dir)
    lap("files")
    with tempfile.TemporaryDirectory() as save_dir:
        parallel = phase_parallel(smi, frames, save_dir)
    lap("parallel")
    emit({"phase": "phase seconds", **{name: t - laps[i][1]
                                       for i, (name, t) in enumerate(laps[1:])}})
    table = []
    for key in F32_KERNELS:
        by_path = {"tracker": track_launches[key], "graphs": graph_launches["f32"][key],
                   "train": train_launches[key], "eval": eval_launches[key],
                   "stage2": stage2["f32"][key], "families": families["f32"][key],
                   "unimodal": unimodal["f32"][key], "cvt_convmae": cvt_convmae["f32"][key],
                   "files": files["f32"][key], "parallel": parallel["f32"][key],
                   "parallel_fsdp": parallel["fsdp"][key]}
        if key in online["f32"]:
            by_path["online"] = online["f32"][key]
        row = dict(kernels[key], launches=sum(by_path.values()), launches_by_path=by_path)
        table.append({k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "bound_f32_ms", "library_ms",
                                          "library_ratio", "event_ms", "per",
                                          "launches_by_path") + (
            ("train_step_ms", "train_step_bound_ms", "train_step_library_ms") if key == "K1" else
            ("train_step_ms", "train_step_bound_ms", "model_locations_ms",
             "model_locations_train_step_ms") if key == "K3" else
            ("model_locations_ms",) if key == "K4" else ())})
    for key in BF16_KERNELS:
        by_path = {"train_bf16": train_bf16_launches[key], "lifecycle": life_launches[key],
                   "stage2_bf16": stage2["bf16"][key],
                   "families_bf16": families["bf16"][key] + unimodal["families_bf16"][key],
                   "unimodal_bf16": unimodal["bf16"][key],
                   "cvt_convmae_bf16": cvt_convmae["bf16"][key], "files_bf16": files["bf16"][key],
                   "parallel_bf16": parallel["bf16"][key],
                   "parallel_remat_bf16": parallel["remat_bf16"][key]}
        if key in BF16_SERVING:
            by_path.update({path: bf16[path][key] for path in ("tracker_bf16", "eval_bf16")},
                           graphs_bf16=graph_launches["bf16"][key],
                           online_bf16=online["bf16"][key],
                           parallel_eval_bf16=parallel["eval_bf16"][key])
        row = dict(kernels[key], launches=sum(by_path.values()), launches_by_path=by_path)
        table.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "bound_f32_ms", "library_ms", "library_ratio", "event_ms",
            "per", "launches_by_path", "f32_err_ratio_max") + (
            ("lockstep_step_ms", "lockstep_step_bound_ms", "lockstep_step_library_ms",
             "train_step_ms", "train_step_bound_ms", "train_step_library_ms")
            if key in BF16_SERVING else ()) + (
            ("model_locations_ms", "dense_floor_ms", "differing_share_max")
            if key in ("K3-bf16", "K4-bf16") else ()) + (
            ("train_step_dense_floor_ms",) if key == "K3-bf16" else ()) + (
            ("repeatable",) if key == "K4-bf16" else ())})
    by_path = {"train": train_launches["AdamW"], "train_bf16": train_bf16_launches["AdamW"],
               "lifecycle": life_launches["AdamW"], "stage2": stage2["f32"]["AdamW"],
               "stage2_bf16": stage2["bf16"]["AdamW"],
               "families_bf16": families["bf16"]["AdamW"] + unimodal["families_bf16"]["AdamW"],
               "unimodal": unimodal["f32"]["AdamW"], "unimodal_bf16": unimodal["bf16"]["AdamW"],
               "cvt_convmae": cvt_convmae["f32"]["AdamW"],
               "cvt_convmae_bf16": cvt_convmae["bf16"]["AdamW"], "files_bf16": files["bf16"]["AdamW"],
               "parallel": parallel["f32"]["AdamW"], "parallel_fsdp": parallel["fsdp"]["AdamW"],
               "parallel_bf16": parallel["bf16"]["AdamW"],
               "parallel_remat_bf16": parallel["remat_bf16"]["AdamW"]}
    row = dict(kernels["AdamW"], launches=sum(by_path.values()), launches_by_path=by_path)
    table.append({k: row[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "bound_f32_ms", "library_ms", "library_ratio", "event_ms", "per",
        "launches_by_path", "parameters")})
    require(all(r["launches"] > 0 for r in table),
            f"a kernel of a main path never launched: {[r['name'] for r in table if not r['launches']]}")
    # ms is device time (torch.profiler): per tracked frame for K1 and K3
    # (12 search-step calls at the CE lengths, 2 calls at B=1), per training
    # step at the final keep for K2 and K4; train_step_ms is K1's and K3's
    # device time per training step; bound_ms is at 165 TFLOP/s (3xTF32) for
    # K1 and K2, bound_f32_ms at 67 TFLOP/s (f32 CUDA cores) for all four;
    # K1-bf16's and K3-bf16's ms and bound_ms (at 989 TFLOP/s of dense bf16)
    # are per tracked frame of the bf16 tracker, lockstep_step_* per N = 12
    # step, train_step_* per bf16 training step; K2-bf16's and K4-bf16's per
    # bf16 training step at the final keep; the bf16 kernels' launches are
    # those of the bf16 train, lifecycle, tracker and eval phases (and of
    # the online and stage-2 phases: launches_by_path); AdamW
    # (no Pallas kernel: it replaces the optax update XLA fuses) per update
    # of every trainable parameter, launched once per update of the train
    # and lifecycle phases
    emit({"kernels": table})
    emit({"ok": True, "device": dev})


if __name__ == "__main__":
    main()
