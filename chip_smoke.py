#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (seal3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--workspace DIR] [--baseline FILE.cu ...]

Phases, each of which raises (exit code != 0) when it fails:
1. print the card (nvidia-smi name and power limit) and build the CUDA
   kernels from csrc/ with nvcc;
2. K1 (halo_encode_fwd) against its plain PyTorch version at the -O widths
   (L=16, T=2^15, F=4 and F=2), 2^20 random points with 25% invalid:
   max abs diff <= 1e-5 (both fp32; only the summation order differs), and
   both times from CUDA events;
3. the main path at full -O width, bound 1: the port Trainer on the
   synthetic test split (8 views, 800x800) runs init_state (mark_untrained)
   and one full grid update through the NGP density (K1, F=2); the analytic
   scene's occupancy is installed (a random-init field would fill the grid
   with fog), a checkpoint is saved, and the port's CLI
   (`seal3d_tpu_torch.main_nerf --test`) loads it and renders all 8 views.
   K1's launch count over this phase must be > 0 and equal the field calls;
4. K1 against the plain version on the packed samples of a real 800x800
   render chunk (<= 1e-5), timed at that shape;
5. the card's render of a 64x64 view against the same render on the CPU
   through the plain version (a reference on a small input);
6. K1's backward (halo_encode_bwd) against its plain PyTorch version at the
   -O widths (L=16, T=2^15, F=4 and F=2) on random points: M=196,608 (one
   [N, K] train step, 4096 rays x 48) all valid, and M=2^20 with 25% invalid
   rows. The table gradient within BWD_RTOL of its largest entry, invalid
   rows adding nothing; both times from CUDA events (phase 16 times the
   kernel-table row, on a real step's samples);
7. the train path at full -O width through the port's CLI (`python -m
   seal3d_tpu_torch.main_nerf synthetic -O --bound 1.0 --dt_gamma 0
   --min_near 0.05 --max_steps 512 --iters 576 --H 256 --W 256`): the loss
   falls, the step-576 checkpoint holds the optimizer state, K1's backward
   ran once per train step and its forward once per field call, and the val
   PSNR is >= 25 dB. Prints ms per step and train rays/s over the steps
   after the first 48, the seconds of the full and partial grid updates, and
   a torch.profiler breakdown of three more train steps.
8. the hash-encode kernels (hash_encode_fwd, hash_encode_bwd: K3, and K2 as
   the backward's scatter) against their plain PyTorch versions at full NGP
   width (L=16) in both level layouts, 'bucket' at T=2^19 (native levels)
   and 'pallas' at T=2^15 (levels padded to T): the forward at M=2^20 random
   points, F=4 and F=2, max abs diff <= 1e-5; the backward at M=196,608 and
   M=2^20, F=4 and F=2, within BWD_RTOL of its largest entry; both times
   from CUDA events. Also times the per-call stacking copy of the two
   tables and the backward over the dense coarse levels alone;
9. the bucket train path through the CLI (phase 7's command with
   `--grid_backend bucket` and HASH_STEPS steps: T=2^19, 16 levels, F=2
   per grid): phase 7's
   checks with the hash-encode launch counts (K1 launches 0), then the
   trained params through `export_torch_ngp` / `import_torch_ngp` into a
   fresh params tree: every leaf bit-identical;
10. the pallas train path (`--grid_backend pallas`: T=2^15, levels padded):
   the same checks, the `.pth` round trip going through
   `convert_table_layout` (padding rows come back zero): the imported
   tables encode 2^20 random points bit-identically to the trained ones,
   and the MLP leaves are bit-identical.
11. K4 (ladder_plan) against its plain PyTorch version at the -O eval point
   (bound 1, max_steps 512, 256 candidates in groups of 4, 32 coarse steps,
   pool 64), bitfield and occupancy AABB from phase 7's trained state: on
   the busiest chunk of a real 800x800 test view (the demand >= the samples
   the fine repack keeps), and on 32,768 random rays of which 20% miss the
   box, at pool 32 and 64. t0, far, keep and cnt bit-identical to plain.
   Times: events around eager calls against the plain version (and its
   kernel launches, from the profiler); device time (CUDA-graph replays)
   on each case and on the 20 demand probes of one view in one graph, and
   the plain version's (`busy_ms`); the host microseconds of one wrapper
   call (`k4_host_us`). With --baseline .../ladder.cu, other versions of
   csrc/ladder.cu (`git show <commit>:seal3d_tpu_torch/csrc/ladder.cu`, or
   a copy with another constant) are built beside the tree's, must give
   bit-identical outputs and are timed on the same cases in turns;
12. the 8 test views at 800x800 from phase 7's state through
   `Trainer.render_image` with `RenderOptions(tl_kernel=True)` and `False`:
   images within 1e-5, depths within 1e-4, equal sample counts; K4 launched
   once per demand probe and once per rendered chunk; seconds and kernel
   launches per view both ways;
13. K5 (multilevel_lookup forward and backward) through `hashgrid_encode`
   with backend 'pallas' where the fused encode does not apply: (a) L=16,
   T=2^15, 3-D, align_corners, F=4 and F=2, M=2^18; (b) the geometry of
   NGP's background grid (L=4, T=2^19, F=2, 2-D), M=2^20. Against the plain
   gather and its autograd gradient (forward <= 1e-5, backward within
   BWD_RTOL of the largest entry); then the kernels alone on the same
   indices against their plain versions and against the bare
   `index_select` / `index_add_` calls, all timed. The backward also as
   device time on each case: through the wrapper, its gradient's zero fill
   alone, the kernel alone and level by level, beside its atomic-rate
   floor; its plain version's and `index_add_`'s device times too. With
   --baseline .../lookup.cu, other versions of csrc/lookup.cu are built
   beside the tree's, their backward must agree within 2 BWD_RTOL, and is
   timed on the same cases in turns;
14. the bbox edit through the port's CLI at full -O width, 256x256 views
   (`python -m seal3d_tpu_torch.main_SealNeRF synthetic -O --bound 1.0
   --dt_gamma 0 --min_near 0.05 --max_steps 512 --H 256 --W 256
   --seal_config seal_config_bbox --teacher_ckpt <phase 7's step-576 .npz>
   --pretraining_epochs 50 --extra_epochs 500`): the pretrain loss falls;
   timer.json, seal.json and options.json exist; the proxied dataset has
   depths; K1's forward ran once per field call and its backward once per
   pretrain batch and finetune step, the fused Adam and EMA once per
   pretrain batch; all test views are finite; on 4 val
   poses the student against the mapped teacher reads >= 25 dB, and on the
   pixels the edit changes the unedited teacher reads lower than the
   student against the same target (the edit took); after
   restore_grid the bitfield no longer holds the force-fill; the edited
   test views through K4 equal those without. Prints pretrain s per epoch,
   proxy s, finetune ms per step and each stage's share of the wall.
15. K1 over a level range, the per-shard program of the level-sharded
   encode, on the card at the -O widths (L=16, T=2^15, F=4), on 2^20 random
   points and on phase 4's real chunk: `halo_encode_sharded` with (model,
   data) in {(2, 1), (4, 1), (8, 1), (4, 2)}, forward bit-identical to
   `halo_encode`, table gradient within BWD_RTOL of the whole gradient's
   largest entry; every shard program a counted launch. Then the 4 shards of
   model=4 on the real chunk, each writing its columns of the full [M, 16, 4]
   tensor, against their plain versions (<= 1e-5), timed beside the whole
   encode;
16. K1 where the main path runs it: forward and backward, whole and level by
   level (16 one-level launches), on the packed samples of one more train
   step of phase 7's trained state (x, valid and cotangent as the step hands
   them to the kernels), on random points of the same count, on phase 4's
   chunk, on the first pretraining batch of phase 14 (2^19 shell points) and
   on 2^20 random points. Forward <= 1e-5 of plain; backward against the
   plain version fed a float64 cotangent, within BWD_RTOL of the largest
   entry (the fp32 plain version itself strays further on the Seal batch,
   whose thousands of terms per coarse row cancel). Times are device times
   (calls replayed from a CUDA graph; the plain version's from its kernels'
   busy time, `busy_ms`). With --baseline .../halo_encode.cu, other
   versions of csrc/halo_encode.cu (an earlier commit's: `git show
   <commit>:seal3d_tpu_torch/csrc/halo_encode.cu`) are built beside the
   tree's, must give the bit-identical forward, and are timed on the same
   cases in turns.
17. the hash-encode kernels where their paths run them (it runs after phase
   10, on that phase's and phase 9's trained states): forward and backward
   on the arguments of one more train step of the `bucket` state (T=2^19,
   F=4: x and cotangent as the step hands them over), on the busiest packed
   chunk of 800x800 test view 0 rendered from that state, on random points
   of the step's count and on 2^20 random points, and the same four on the
   `pallas` state (T=2^15); the bucket cases also level by level (16
   launches over one-level configs and table slices). Forward <= 1e-5 of
   plain, backward within BWD_RTOL of the largest entry of the plain version
   fed a float64 cotangent. Device times (CUDA-graph replays; the backward
   with the zero fill of its gradient; the plain versions' from their
   kernels' busy time). Beside each case's byte bound, its
   sector floor: the 32-byte table sectors distinct within each warp of 32
   consecutive samples over the L2's sector rate, or those distinct in all
   over the device-memory rate, whichever is larger. Then, around the
   forward's switch from the direct kernel to the tiles, prefixes of both
   real chunks (F=4 with a random cotangent, and F=2) and the first query
   chunk of a full grid update, and ms per train step and seconds per
   800x800 view of both states. With --baseline .../hash_encode.cu, other
   versions of csrc/hash_encode.cu (`git show
   <commit>:seal3d_tpu_torch/csrc/hash_encode.cu`) are built beside the
   tree's, must give the bit-identical forward on every case, and are timed
   on the same cases, steps and views in turns (a copy of the tree's source
   with another constant is such a version too). The kernel-table rows of
   hash_encode_fwd and hash_encode_bwd take their times and bounds from the
   bucket chunk (the table sectors it touches counted once) and the bucket
   step (the whole gradient written once).
18. training and rendering at bound 2 (two cascades), the CLI's default
   (it runs last): (a) the Trainer on WideSyntheticScene at bench.py's
   wide_bound2 recipe (12 views at 192x192, `halo` at T=2^15 `wrap`,
   dt_gamma 1/128, max_steps 512, budget 48, 256 candidates, coarse 64, lr
   3e-3, 4096 rays, eval chunk 2^15 at budget 64 and flat_frac 0.5,
   adaptive budget) for 48 warm-up and B2_STEPS timed steps: train rays/s
   and ms per step (CUDA events); the PSNR of bench.py's view (its first
   training view) and of a held-out view, there and again at
   B2_GATE_STEPS, where bench.py's view must read >= 25 dB (both finite);
   occupied cells on both cascades, K1's launches equal to the field calls,
   and K1 against its plain version on one more step's packed samples
   (some on cascade 1), then a torch.profiler breakdown of three more steps; (b) one 800x800 single-level view of that
   state: seconds, kernel launches, K1 launches, samples, buckets; (c) the
   dense oracle (128 + 128 samples a ray) on the held-out view against the
   fast path, on that state (printed: the fast path never trained the cells
   its grid skips, and the oracle integrates their fog), then after
   B2_DENSE_STEPS dense train steps from it (2 K1 forwards and 1 backward
   each; K1 against plain on one more) and a full grid update (>= 25 dB);
   (d) `python -m
   seal3d_tpu_torch.main_nerf synthetic -O --lr 3e-3 --iters 128 --H 128
   --W 128` with the default bound and dt_gamma: finite val PSNR, K1
   launches equal to the field calls;
19. single-level eval and the dense path at bound 1, on phase 7's state
   (it runs after phase 12): test view 0 at 800x800 through the default
   two-level adaptive render and through the single-level fixed-budget one
   (eval_two_level=False, eval_adaptive=False, eval_flat_frac=0.375):
   seconds, K1 launches and samples of each, their PSNR against each other
   >= 25 dB (bench.py:281-299's self-check, a gate here); then the
   `--dense_render` CLI at a tiny size (60 steps at 32x32, `xla`): its
   step checkpoint is written.
20. the Seal tools (it runs last, after phase 18): (a)-(c) the brush with
   a line stroke on the box's top face, the brush with a curve stroke on
   ball 1's cap and the anchor pulled up from that cap, each through
   main_SealNeRF on phase 7's teacher at phase 14's recipe (finetune cut
   to TOOL_STEPS) and gates (the
   seal.json written into the run's workspace), its stage seconds, and K1
   against its plain version (<= 1e-5) on the mapped samples of the
   busiest proxy chunk, whose peak device memory is printed; (d) a bbox
   edit at bound 2 through the SealTrainer API on phase 18a's state,
   moving WideSyntheticScene's satellite ball on cascade 1 up by 0.3: its
   cascade-1 force-fill in the student's bitfield while it trains, the
   moved ball occupied after restore_grid, the edit gates on 4 held-out
   views; then main_SealNeRF at the CLI's default bound and dt_gamma
   (`-O --lr 3e-3`, 128x128) with the line brush on phase 18d's
   checkpoint: a finite student PSNR; (e) main_SealNeRF --dense_render at
   24x24 with its teacher trained through the dense oracle: both
   checkpoints written; (f) extract_geometry at 256^3 on phase 7's state
   and on (a)'s student: K1 launched once per 2^16-point chunk, vertices
   inside the bound, the lifted stroke in the edited mesh alone. K1's
   launch counts equal the field calls of every edit.
21. TensoRF and Seal on it (it runs after phase 20; of the table's kernels
   only the VM lookups' pair runs here, and in (a) and (c) it must, and
   the fused Adam and EMA, once per pretrain batch of (c) and never in (a)
   or (b)): (a)
   `python -m seal3d_tpu_torch.main_tensoRF synthetic -O --bound 1.0
   --dt_gamma 0 --min_near 0.05 --max_steps 512 --iters 1200 --H 256 --W 256
   --upsample_model_steps 250 450 650 850 1100` (VM at the CLI's full
   width, 128^3 -> 300^3 over five upsamples, the shrink at step 1000): ms
   per step by segment from CUDA events, with the factor shapes after each
   milestone and the shrunk aabb; launches and device-busy ms of a step at
   300^3 and the device ms of its plane / line lookups (the
   `tensorf.sample` ranges forward, the `tensorf.scatter` ranges of their
   backward) and their share of the step; val PSNR
   on 4 views at 256x256 (>= 20 dB); the final shapes equal
   n_to_reso(300^3, shrunk aabb); s per 800x800 view on 2 test views and
   the peak MiB above what is held while one renders; a fresh
   TensoRFTrainer reloads the final .npz and renders a view bit-identical;
   (b) the same CLI with `--cp` at 128x128, 300 steps, one upsample at
   step 150: val PSNR >= 2 dB above the untrained field's, and a `.pth`
   round trip whose `apply` is bit-identical; (c) `python -m
   seal3d_tpu_torch.main_SealTensoRF` with seal_config_bbox on (a)'s
   `.npz` at 15 epochs and 200 steps, 256x256: the stages
   of timer.json, the student against the mapped teacher on 4 val views
   (>= 25 dB), the pixels the edit changes (> 0), the student's aabb drift;
   (d) the VM lookups' kernel pair (`tensorf_vm_rows`, `[tensorf vm]`
   lines) on the first 2^19 rows of (c)'s packed shells at the student's
   factors: both calls of a pretraining batch (density, colour) forward
   and backward against the plain composition and its Functions, device
   times beside theirs, the byte bound and `index_select` / `index_add_`
   of the same corner rows, and the share of corner rows the backward
   sent as atomics.
22. the rest of main_nerf (it runs right after phase 7): (a) a Blender
   tree at nerf_synthetic's layout, written by the port's own code:
   SyntheticScene renders of 100 train, 4 val and 2 test views at 800x800
   (random orbit poses of radius 2.2) as <split>/r_<i>.png through the
   port's PNG writer and transforms_<split>.json through its
   ngp_to_nerf_matrix; (b) NeRFDataset.load of it: seconds, whether cv2
   imports (the loader then reads through it, else through read_png),
   images bit-identical to the written ones and poses within 1e-5; (c)
   `python -m seal3d_tpu_torch.main_nerf <tree> -O --bound 1.0 --scale
   1.0 --dt_gamma 0 --min_near 0.05 --max_steps 512 --iters 288`, then the
   same with --error_map: ms a step after the first 48, launches a step,
   val PSNR on the 4 views (>= 25 dB), K1 launched once a field call, the
   share of error-map cells moved off 0.1, and K1 against its plain
   version on one more error-map step; (d) on the RGB copy at 576 steps,
   plain and with --bg_radius 32,
   its val PSNR >= 2 dB above its untrained field's (on this white
   background the net trains below the plain field in both packages), and
   a .pth round trip of its params in the halo layout (apply and
   background bit-identical on 2^16 points); (e) test view 0 of (c)'s state at 800x800 with
   term_rounds 2 and 4 against 1 at 192 samples a ray (and one round at
   -O's 48, for its time and samples): mean |d image| < 1e-3, share of
   values off by > 2e-2 below 2e-3, mean |d weights_sum| < 1e-3, s a view
   and field samples each way; (f) one --rand_pose 0 --clip_random_init
   guided step where transformers imports (finite loss, the params
   moved), else the CLI's named exit.
23. the three other families at their CLIs' full widths (it runs last):
   (a) `python -m seal3d_tpu_torch.main_dnerf synthetic_dynamic -O --bound
   1.0 --dt_gamma 0 --min_near 0.05 --max_steps 512 --H 256 --W 256
   --num_views 48 --views_per_time 4 --time_multires 2 --deform_reg 1e-3
   --iters 800` (the 5x128 deform net, 16 levels F=2 at T=2^15 `wrap` on
   K1, 64 time slices): ms a step with and without the time-grid updates
   and s an update (8 slices), K1's launches equal to the field calls (one
   a step, 32 an update, one a rendered chunk) and its backward once a
   step, no other kernel; val PSNR at the first step and after the run
   (>= 2 dB over the first and >= 18 dB); how far each deform-net layer
   moved (> 0: through the L1 term alone); K1 launches a step, a view and
   an update; a profiled step; K1 against its plain version on one more
   step's warped samples (forward <= 1e-5, backward within BWD_RTOL) and
   on a time-grid update's first chunk (<= 1e-5); (b) the same CLI with
   `--grid_backend bucket` for 100 steps: the hash-encode launches equal to
   the field calls, the loss falls, the deform net moves, and the
   positions' gradient of one step's warped samples through the kernels on
   the card against the CPU plain version (<= 1e-5 of its largest entry);
   (c) `python -m seal3d_tpu_torch.main_CCNeRF synthetic -O --bound 1.0
   --H 128 --W 128 --iters 1200` (300^3, the CLI's ranks): ms, launches and
   busy ms a step, val PSNR (>= 2 dB over the untrained field and >= 20
   dB), then `--test --compress 8 16 24 48` (its val PSNR >= 2 dB over the
   untrained) and `--compose` of the run's checkpoint with itself (two
   objects, 8 finite test views at 128x128); (d) `python -m
   seal3d_tpu_torch.main_sdf synthetic --iters 300` (T=2^19, 16,384 points
   a step): ms a step, MAE before and after (<= half), the 256^3 mesh's
   vertices. (c) and (d) launch no kernel of the table.
24. the GUI layer headless (it runs last), on phase 7's teacher (its
   checkpoint loaded into a Trainer of phase 7's configuration) in the
   CLI's default window (800x800, OrbitCamera radius 3, fovy 60): (a)
   NeRFViewer: 12 previews between orbit, pan and scale moves with K4 off,
   then on: ms a frame by the downscale the budget picked and the one it
   settles at, K1 once a rendered chunk, K4 once a chunk's probe and once
   a rendered chunk, finite frames; a ds-1 frame bit-identical to
   render_image at the camera's pose and intrinsics; 4 training slices at
   the budget's steps (ms a step, K1 = steps and field calls); a train
   step's rays then equal a never-previewed trainer's; (b) SealController
   at paint_res 64: a stroke across the view's centre lifted, a brush
   config, start_edit at the Seal CLI's pretraining recipe with phase
   14's 50 epochs, a slice and a student preview at a time until pretraining
   ends, then GUI_FT_SLICES finetune slices with previews: lifted points,
   seconds from start_edit to the first student preview, ms and K1 a
   slice, the student against the mapped teacher on 4 val poses (>=
   MIN_GUI_PSNR), override and reset bit for bit, save_checkpoint loading
   back; (c) the texture tool (a PNG by the port's writer, the image plane
   from three lifted corners, one slice, finite renders) and SealViewer on
   the Seal CLI's arguments (its teacher --teacher_ckpt's) exporting a
   192^3 mesh; (d) the time-aware viewer on phase 23a's D-NeRF trainer:
   frames at t = 0, 0.5, 1 differ, K1 once a chunk; (e) --gui through
   main_nerf, main_dnerf and main_SealNeRF raises the RuntimeError naming
   dearpygui before a step (where dearpygui imports, (e) is not run).
25. the multi-device layer on this one card (it runs last; `parallel_phase`,
   `[parallel ...]` lines), at the full -O width and bench.py's operating
   point starting in the flat branch: (a) NCCL at world size 1, 8 steps
   through the collective code against the same steps without a mesh;
   (b) dp2 over gloo (two ranks on the card) against one process with
   pack_shards=2 on the same StepRandom, 16 steps, then 100 with grid
   updates and val PSNR, and no batch-scale collective in a step's log;
   (c) dp2 x tp2 on `halo` over gloo (four ranks, K1 over 8 levels a rank):
   the level-sharded encode against K1 unsharded, 16 steps against (b)'s,
   no table-sized collective over 'model'. Every rank holds its last
   step's first K1 launch against the plain version. Gloo ranks sharing a
   card measure the path's cost and its bytes, not scaling.
26. the march options of RenderOptions (it runs after phase 19, on phase
   7's trained state; `march_options_phase`, `[march options ...]` lines):
   (a) one real 4096-ray train batch through the train march of each
   option (the sort pack, which flat_select 'gather' also runs,
   span_adaptive, the group-granular march, the legacy compaction, the
   two-level march with jitter) on the card and on the CPU: integers
   exact, floats on valid slots within 1e-6; (b) under each option the
   first step's loss (1e-4 relative) and gradients (1e-2 of each leaf's
   largest entry) on the card against the CPU's, then 16 train steps from
   a copy of the state on the default copy's draws: K1 once a field call
   and once a step, finite losses, one 256x256 val view's PSNR beside the
   default copy's (span_adaptive and group_compact within 1.0 dB, the
   legacy and two-level train marches at 20 dB or more); (c) a SealTrainer under compaction flat renders a teacher
   view with no demand probe and K1 once a chunk.
27. the NGP field head's kernel pair (`field_head_phase`, `[field head]`
   lines): its launches on the main paths, each counted right around its
   run (phase 14's bbox edit: one backward a pretraining batch, one
   forward a teacher query chunk, pretraining batch, proxy chunk and test
   chunk, none a finetune step; an 800x800 view of phase 7's state: one a
   rendered chunk; a train step: none); forward and backward at a
   pretraining batch's 2^19 rows against the plain composition (error and
   share of rows with a bf16 flip, gated at 2e-2 and 2%), device times
   beside the plain composition's and the byte bound.
28. Adam and the EMA as one launch (`adam_ema_rows`, `[adam ema]` lines;
   it runs after phase 21, alone: `python3 -c 'import chip_smoke, torch;
   chip_smoke.adam_ema_rows(torch.device("cuda"), (0, 0))'`) at the
   benchmark cells' leaf sets (NGP's two T=2^19 tables moved and five MLP
   leaves EMA-only; TensoRF VM-192 at 300^3, sixteen leaves moved and
   `aabb`): three steps bit for bit against the plain chain, the kernel's
   device time (CUDA-graph replays) beside the plain chain's, the same
   chain as `torch._foreach_*` calls and the byte bound, launches a step
   (one), and the host's microseconds a call. The rows' launches are the
   kernel's in phase 14's NGP edit and phase 21c's TensoRF edit.
The line before the last is the kernel table as JSON (nine rows for the
nine Pallas call sites, K1 over a level range twice, on one card and
across ranks; hash_encode_bwd is both K2 and K3's backward; two more for
the field head, two for the TensoRF VM lookups and two for the fused
Adam and EMA, which replace no Pallas kernel; each
with its launches on the main paths, its error, its time, the plain
version's, the bound from this run's shapes and, where one PyTorch call
computes the same function, that call's time; a row whose own time is
device time has its plain and library times as device time too); the
last line is
{"ok": true, "device": {...}}. There is no CPU path: without a CUDA device
the script exits non-zero before printing any result.
"""

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = 1e-5  # K1 vs plain: fp32 both, summation order only
# K1 backward vs plain, relative to the largest gradient entry: fp32 atomics
# (and the plain index_add_, itself an atomic scatter on the card) sum up to
# a few thousand terms per row in an order that changes from run to run
BWD_RTOL = 1e-5
TRAIN_STEPS = 576
HASH_STEPS = 384    # phases 9-10's CLI runs, cut from TRAIN_STEPS for time
MIN_VAL_PSNR = 25.0  # a field with broken gradients stays near 12-15 dB
MIN_EDIT_PSNR = 25.0  # the student against the mapped teacher, 4 val poses
SEAL_EPOCHS, SEAL_STEPS = 50, 500   # the recipe's pretrain epochs, finetune
TOOL_STEPS = 150    # phase 20a-c's finetune steps, cut from SEAL_STEPS
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s and
# fp32 operations/s outside the tensor cores; the bound of a kernel is the
# larger of its bytes over the first and its operations over the second
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# the rate at which the L2 serves 32-byte sectors to a gather that misses L1:
# phase 16's one-level K1 launches on the fine levels of a real chunk move
# 4.4-4.8e12 bytes/s of them (this card, PERF.md section 6)
L2_SECTOR_BYTES_S = 4.6e12
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
# the csrc files another version of which --baseline takes, known by name
BASELINE_SOURCES = ("halo_encode.cu", "hash_encode.cu", "ladder.cu",
                    "lookup.cu")


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int = 10) -> float:
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_device_ms(fn, iters: int = 20) -> float:
    """Mean device ms per call: `iters` calls captured into one CUDA graph
    and replayed, so the gaps the host leaves between short launches do not
    count (a K1 launch through its wrapper costs the host ~50 us)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, 5) / iters


def busy_ms(fn, calls: int = 3) -> float:
    """Mean device ms per call that fn's kernels and copies keep the card
    busy, from torch.profiler (after one warm-up call): device time, as
    `time_device_ms` gives, for a callable that a CUDA graph cannot hold (a
    plain version that copies host scalars to the card). It leaves out the
    gaps between kernels that a graph replay still counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def time_turns(kernel, plain):
    """(kernel ms, plain ms) of two no-argument callables, timed in turns
    plain, kernel, kernel, plain so clock drift hits both alike."""
    with torch.no_grad():
        p1 = time_ms(plain, 3)
        k1 = time_ms(kernel)
        k2 = time_ms(kernel)
        p2 = time_ms(plain, 3)
    return (k1 + k2) / 2, (p1 + p2) / 2


def compare(kernel, plain):
    """(max abs diff, max |plain|, kernel ms, plain ms) of two no-argument
    callables that return one tensor."""
    with torch.no_grad():
        ref = plain()
        err = float((kernel() - ref).abs().max())
        scale = float(ref.abs().max())
        del ref
    return (err, scale, *time_turns(kernel, plain))


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take for n_bytes moved (each input
    read once, each output written once) and n_ops fp32 operations."""
    by = n_bytes / PEAK_BYTES_S * 1e3
    op = n_ops / PEAK_FP32_S * 1e3
    return {"bound_ms": max(by, op),
            "bound_by": "bytes" if by >= op else "operations"}


def encode_bound(m, n_valid, levels, f, table_rows, valid_bytes=0,
                 hashed_levels=0, touched_bytes=None) -> dict:
    """Bound of a multiresolution encode, forward or backward alike: per row
    x (12 B) and its valid byte, the [M, L*F] fp32 features (forward: out;
    backward: the cotangent in) once, the [rows, F] fp32 table once (read,
    or written as the gradient). touched_bytes: the bytes of the table's
    32-byte sectors that a forward on this data reads, where that is less
    than the whole table. Per valid (row, level): 8 corners x F
    multiply-adds, ~30 operations of cell and weight arithmetic, and 5 per
    corner more where the level is hashed."""
    table_bytes = 4 * f * table_rows
    if touched_bytes is not None:
        table_bytes = min(table_bytes, touched_bytes)
    n_bytes = m * (12 + valid_bytes) + table_bytes + 4 * f * m * levels
    n_ops = n_valid * (levels * (16 * f + 30) + hashed_levels * 40)
    return bound(n_bytes, n_ops)


def count_launches(fn) -> int:
    """Kernel launches of one call of fn (after one warm-up call), from
    torch.profiler's CUDA-runtime events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_KEYS)


def psnr(a, b) -> float:
    return float(-10.0 * torch.log10(((a - b) ** 2).mean()))


def kernel_vs_plain(table, x, valid, cfg):
    """K1 forward: (max abs diff, kernel ms, plain ms)."""
    from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_plain

    err, _, ms, plain_ms = compare(
        lambda: halo_encode(table, x, valid, cfg),
        lambda: halo_encode_plain(table, x, valid, cfg))
    return err, ms, plain_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workspace", default=None,
                    help="keep checkpoint and renders here (default: a "
                         "temporary directory, removed at exit)")
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="FILE.cu",
                    help="another version of csrc/halo_encode.cu, "
                         "hash_encode.cu, ladder.cu or lookup.cu (an earlier "
                         "commit's, say), known by its file name: built "
                         "beside the tree's and timed on the same cases in "
                         "turns (phases 16, 17, 11 and 13); may be given "
                         "more than once")
    args = ap.parse_args(argv)
    baselines = {name: [] for name in BASELINE_SOURCES}
    for src in args.baseline:
        if os.path.basename(src) not in baselines:
            ap.error(f"--baseline {src}: not one of {sorted(baselines)}")
        baselines[os.path.basename(src)].append(src)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script has no CPU "
                         "path)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from seal3d_tpu_torch.runtime.build import build_library, load_library

    t0 = time.perf_counter()
    built = build_library()
    load_library()
    print(f"[build] kernel library {os.path.basename(built.path)}: "
          f"{time.perf_counter() - t0:.2f} s (nvcc {built.seconds:.2f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    seconds = {}    # wall seconds by phase, to see what a run spends
    clock = [time.perf_counter()]

    def lap(phases):
        now = time.perf_counter()
        seconds[phases] = round(now - clock[0], 1)
        clock[0] = now

    with tempfile.TemporaryDirectory() as tmp:
        ws = args.workspace or tmp
        k1_fwd, ds800, chunk = run_phases(dev, ws)
        lap("1-5")
        k1_bwd = k1_bwd_phase(dev)
        lap("6")
        tr7, fwd_launches, bwd_launches = train_phase(os.path.join(ws, "train"))
        k1_fwd["launches"] += fwd_launches
        k1_bwd["launches"] += bwd_launches
        with capture_k1() as seen:      # one more step of the trained state
            tr7.train_step()
        step_case = dict(seen[-1], name="real train step (packed, ray order)")
        lap("7")
        fwd, bwd, err = blender_phase(dev, ws, smi)
        k1_fwd["launches"] += fwd
        k1_bwd["launches"] += bwd
        k1_fwd["max_abs_err"] = max(k1_fwd["max_abs_err"], err)
        torch.cuda.empty_cache()
        lap("22")
        hash_rows = hash_kernels_phase(dev)
        lap("8")
        hash_trainers = {}
        for backend in ("bucket", "pallas"):
            tr, fwd, bwd = train_phase(os.path.join(ws, f"train_{backend}"),
                                       backend, HASH_STEPS)
            pth_round_trip(tr, os.path.join(ws, f"train_{backend}"))
            hash_rows[0]["launches"] += fwd
            hash_rows[1]["launches"] += bwd
            hash_trainers[backend] = tr
        lap("9-10")
        hash_measure_phase(dev, hash_rows, hash_trainers, ds800,
                           baselines["hash_encode.cu"])
        lap("17")
        del hash_trainers, tr
        torch.cuda.empty_cache()
        k4 = ladder_phase(dev, tr7, ds800, ws, baselines["ladder.cu"])
        lap("11-12")
        k1_fwd["launches"] += parity_phase(dev, tr7, ds800, ws)
        lap("19")
        fwd, bwd = march_options_phase(dev, tr7)
        k1_fwd["launches"] += fwd
        k1_bwd["launches"] += bwd
        lap("26")
        k5_rows = lookup_phase(dev, baselines["lookup.cu"])
        lap("13")
        teacher_ckpt = os.path.join(ws, "train", "checkpoints",
                                    f"ngp_step{TRAIN_STEPS:07d}.npz")
        fwd, bwd, k4_seal, seal_case, seal_head, seal_adam = seal_phase(
            dev, os.path.join(ws, "seal"), teacher_ckpt)
        k1_fwd["launches"] += fwd
        k1_bwd["launches"] += bwd
        k4["launches"] += k4_seal
        lap("14")
        head_rows = field_head_phase(dev, tr7, ds800, seal_head)
        lap("27")
        del tr7, ds800
        torch.cuda.empty_cache()
        k1_tp = k1_levels_phase(dev, chunk)
        lap("15")
        k1_measure_phase(dev, k1_bwd, step_case, chunk, seal_case,
                         baselines["halo_encode.cu"])
        lap("16")
        fwd, bwd, err, wide_ckpt, b2_cli_ckpt = bound2_phase(dev, ws)
        k1_fwd["launches"] += fwd
        k1_bwd["launches"] += bwd
        k1_fwd["max_abs_err"] = max(k1_fwd["max_abs_err"], err)
        lap("18")
        torch.cuda.empty_cache()
        fwd, bwd, err = seal_tools_phase(dev, os.path.join(ws, "seal_tools"),
                                         teacher_ckpt, wide_ckpt, b2_cli_ckpt)
        k1_fwd["launches"] += fwd
        k1_bwd["launches"] += bwd
        k1_fwd["max_abs_err"] = max(k1_fwd["max_abs_err"], err)
        lap("20")
        torch.cuda.empty_cache()
        vm_rows, tf_adam = tensorf_phase(dev, os.path.join(ws, "tensorf"))
        lap("21")
        adam_rows = adam_ema_rows(dev, (seal_adam, tf_adam))
        lap("28")
        torch.cuda.empty_cache()
        fwd, bwd, fwd_h, bwd_h, err, dn_tr = families_phase(
            dev, os.path.join(ws, "families"))
        k1_fwd["launches"] += fwd
        k1_bwd["launches"] += bwd
        k1_fwd["max_abs_err"] = max(k1_fwd["max_abs_err"], err)
        hash_rows[0]["launches"] += fwd_h
        hash_rows[1]["launches"] += bwd_h
        lap("23")
        torch.cuda.empty_cache()
        fwd, bwd, k4_gui = gui_phase(dev, os.path.join(ws, "gui"),
                                     teacher_ckpt, dn_tr)
        k1_fwd["launches"] += fwd
        k1_bwd["launches"] += bwd
        k4["launches"] += k4_gui
        del dn_tr
        lap("24")
        torch.cuda.empty_cache()
        k1_ranks = parallel_phase(dev)
        lap("25")
    print(f"[time] wall seconds by phase: {json.dumps(seconds)}")
    kernels = [k1_fwd, k1_bwd, k1_tp, k1_ranks, *hash_rows, k4, *k5_rows,
               *head_rows, *vm_rows, *adam_rows]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for row in kernels:
        check(set(row) == keys, f"kernel row {row.get('name')}: keys "
                                f"{sorted(set(row) ^ keys)} missing or extra")
        check(row["launches"] > 0, f"{row['name']} was launched no time on "
                                   f"the main paths")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def run_phases(dev, ws):
    from seal3d_tpu_torch import main_nerf
    from seal3d_tpu_torch.config import (build_options, build_train_config,
                                         common_parser, grid_defaults,
                                         load_dataset)
    from seal3d_tpu_torch.data.rays import get_full_rays
    from seal3d_tpu_torch.data.synthetic import SyntheticScene
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.models.ngp import NGPConfig
    from seal3d_tpu_torch.ops.halo_encode import halo_encode
    from seal3d_tpu_torch.ops.hashgrid import HashGridConfig
    from seal3d_tpu_torch.render.occupancy import (occupancy_init,
                                                   occupancy_update)
    from seal3d_tpu_torch.render.renderer import march_flat
    from seal3d_tpu_torch.train.checkpoint import map_tree
    from seal3d_tpu_torch.train.trainer import Trainer

    # --- phase 2: K1 vs plain on random points at the -O widths
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15,
                         desired_resolution=2048, gridtype="wrap",
                         backend="halo")
    rng = np.random.default_rng(0)
    m = 2**20
    x = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=m) >= 0.25).to(dev)
    max_err = 0.0
    for f in (4, 2):
        tab = torch.from_numpy(rng.uniform(-1, 1, (cfg.total_params, f))
                               .astype(np.float32)).to(dev)
        err, ms, plain_ms = kernel_vs_plain(tab, x, valid, cfg)
        print(f"[k1 random] M=2^20 L=16 T=2^15 F={f}: max_abs_err {err:.3e} "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        check(err <= TOL, f"K1 F={f} disagrees with plain: {err}")
        max_err = max(max_err, err)
    del x, valid, tab

    # --- phase 3: the main path at full -O width
    ckpt = os.path.join(ws, "checkpoints", "ngp_step0000000.npz")
    argv = ["synthetic", "-O", "--test", "--bound", "1.0", "--dt_gamma", "0",
            "--min_near", "0.05", "--max_steps", "512", "--device", "cuda",
            "--workspace", ws, "--ckpt", ckpt]
    cli = common_parser("chip_smoke").parse_args(argv)
    backend, log2t, gridtype = grid_defaults(cli)
    fcfg = NGPConfig(bound=cli.bound, log2_hashmap_size=log2t,
                     grid_backend=backend, gridtype=gridtype)
    check(backend == "halo", f"-O should select the halo backend: {backend}")

    halo_encode.launches = 0
    t0 = time.perf_counter()
    ds = load_dataset(cli, "test", device=dev)
    torch.cuda.synchronize()
    print(f"[main] synthetic test split {len(ds)} x {ds.h}x{ds.w}: "
          f"{time.perf_counter() - t0:.2f} s")
    tr = Trainer(ngp, fcfg, build_options(cli), build_train_config(cli),
                 dataset=ds, seed=0, device=dev)
    t0 = time.perf_counter()
    tr.init_state()
    torch.cuda.synchronize()
    untrained = int((tr.state.occ.density_grid < 0).sum())
    print(f"[main] init_state (mark_untrained: {untrained} cells untrained): "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    tr.update_grid()
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    grid_launches = halo_encode.launches
    print(f"[main] full grid update (2^21 cells, 2^17 chunks): {grid_s:.3f} s, "
          f"K1 launches {grid_launches}, mean_density "
          f"{float(tr.state.occ.mean_density):.4f}")
    check(grid_launches == 16, f"grid update made {grid_launches} K1 calls")

    occ = occupancy_update(occupancy_init(1, device=dev),
                           SyntheticScene().density, bound=1.0,
                           density_thresh=0.01,
                           generator=torch.Generator(device=dev).manual_seed(2))
    tr.state = tr.state._replace(occ=occ)
    tr.save_checkpoint(ckpt)
    n_occ = int(np.unpackbits(occ.bitfield.cpu().numpy()).sum())
    print(f"[main] analytic occupancy installed ({n_occ} occupied cells), "
          f"checkpoint {os.path.basename(ckpt)}")

    t0 = time.perf_counter()
    tr2 = main_nerf.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = halo_encode.launches
    stats = tr2.render_stats
    check(len(stats) == 8, f"{len(stats)} views rendered, expected 8")
    for i, s in enumerate(stats):
        print(f"[main] view {i}: {s['seconds']:.3f} s, chunks rendered "
              f"{s['chunks_rendered']} skipped {s['chunks_skipped']}, "
              f"buckets {s['buckets']}, samples {s['samples']}")
        check(s["chunks_rendered"] >= 1, f"view {i} rendered no chunk")
        check(s["nonfinite"] == 0, f"view {i} has non-finite pixels")
    field_calls = grid_launches + sum(s["chunks_rendered"] for s in stats)
    print(f"[main] main_nerf --test: {cli_s:.2f} s for 8 views; "
          f"K1 launches {launches} (field calls {field_calls})")
    check(launches > 0 and launches == field_calls,
          f"K1 launches {launches} != field calls {field_calls}")
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    check(len(pngs) == 8, f"{len(pngs)} PNGs written")

    # --- phase 4: K1 vs plain on the packed samples of a real chunk
    st = tr2.state
    rays = get_full_rays(torch.as_tensor(ds.poses[0], device=dev),
                         tr2._intrinsics, ds.h, ds.w)
    sel, _, _ = tr2._chunk_layout(ds.h, ds.w, tr2.cfg.eval_chunk)
    full = [s for s in sel if (s >= 0).all()]  # chunks without pad slots
    aabb = tr2._march_aabb(st.occ.occ_aabb)
    demand = [int(tr2._eval_demand(st.occ.bitfield, rays["rays_o"][s],
                                   rays["rays_d"][s], aabb, len(s))[0])
              for s in full]
    idx = torch.as_tensor(full[int(np.argmax(demand))], device=dev)
    opts = dataclasses.replace(tr2.eval_opts, flat_frac=tr2.cfg.eval_flat_frac)
    mf = march_flat(rays["rays_o"][idx], rays["rays_d"][idx], st.occ.bitfield,
                    opts, aabb)
    xn = ((mf.xyzs + fcfg.bound) / (2.0 * fcfg.bound)).contiguous()
    table = torch.cat([st.ema_params["encoder"], st.ema_params["encoder_color"]],
                      dim=-1)
    err, ms, plain_ms = kernel_vs_plain(table, xn, mf.valid, fcfg.grid)
    print(f"[k1 chunk] view 0, busiest chunk: M={xn.shape[0]} "
          f"({int(mf.valid.sum())} valid) F=4: max_abs_err {err:.3e} "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    check(err <= TOL, f"K1 disagrees with plain on a real chunk: {err}")
    max_err = max(max_err, err)

    # --- phase 5: card vs CPU (plain version) on a small view
    small = SyntheticScene().make_dataset(n_views=1, h=64, w=64, seed=2,
                                          device=dev)
    imgs = []
    for device in (dev, torch.device("cpu")):
        t = Trainer(ngp, fcfg, tr2.opts, tr2.cfg, dataset=small, device=device)
        t.state = map_tree(st, lambda _, v: v.to(device))
        imgs.append(t.render_image(small.poses[0], 64, 64))
        check(t.render_stats[-1]["chunks_rendered"] == 1,
              "the 64x64 reference view rendered nothing")
    d_img = float((imgs[0][0].cpu() - imgs[1][0]).abs().max())
    d_dep = float((imgs[0][1].cpu() - imgs[1][1]).abs().max())
    print(f"[ref] 64x64 view ({t.render_stats[-1]['samples']} samples), card "
          f"vs CPU plain path: image max diff {d_img:.3e}, depth max diff "
          f"{d_dep:.3e}")
    check(d_img <= 1e-3 and d_dep <= 1e-3,
          f"card render disagrees with the CPU reference: {d_img} {d_dep}")
    # the row is timed at the real chunk: its bound from that chunk's shapes
    n_valid = int(mf.valid.sum())
    return {"name": "halo_encode_fwd", "route": "cuda",
            "source": "seal3d_tpu_torch/csrc/halo_encode.cu",
            "replaces": "seal3d_tpu/ops/pallas/halo_encode.py:368",
            "launches": launches, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            **encode_bound(xn.shape[0], n_valid, 16, 4, table.shape[0],
                           valid_bytes=1)}, ds, {
        "name": "real render chunk (packed, ray order)", "cfg": fcfg.grid,
        "table": table.detach(), "x": xn, "valid": mf.valid, "g": None}


def k1_bwd_phase(dev):
    """Phase 6 -> the kernel-table row of halo_encode_bwd, timed at the
    M=196,608 F=4 case (random points; phase 16 replaces the row's times
    and bound by those of a real train step); max_abs_err is that case's;
    every case is checked."""
    from seal3d_tpu_torch.ops.halo_encode import (halo_encode_bwd,
                                                  halo_encode_bwd_plain)
    from seal3d_tpu_torch.ops.hashgrid import HashGridConfig

    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15,
                         desired_resolution=2048, gridtype="wrap",
                         backend="halo")
    n = cfg.total_params
    rng = np.random.default_rng(1)
    result = None
    for m, frac_invalid in ((4096 * 48, 0.0), (2**20, 0.25)):
        x = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32)).to(dev)
        valid = None
        if frac_invalid:
            valid = torch.from_numpy(rng.uniform(size=m) >= frac_invalid).to(dev)
        for f in (4, 2):
            g = torch.from_numpy(rng.uniform(-1, 1, (m, 16 * f))
                                 .astype(np.float32)).to(dev)
            err, scale, ms, plain_ms = compare(
                lambda: halo_encode_bwd(g, x, valid, cfg, n),
                lambda: halo_encode_bwd_plain(g, x, valid, cfg, n))
            msg = ""
            if valid is not None:  # invalid rows' (nonzero) g adds nothing
                alone = halo_encode_bwd(torch.where(valid[:, None], g, 0.0),
                                        x, None, cfg, n)
                ref = halo_encode_bwd_plain(g, x, valid, cfg, n)
                inv = float((alone - ref).abs().max())
                check(inv <= BWD_RTOL * scale,
                      f"K1 bwd: invalid rows changed the gradient by {inv}")
                msg = f", invalid rows add {inv:.3e}"
                del alone, ref
            print(f"[k1 bwd] M={m} L=16 T=2^15 F={f} invalid {frac_invalid}: "
                  f"max_abs_err {err:.3e} (max |grad| {scale:.3e}, "
                  f"rel {err / scale:.3e}){msg}; kernel {ms:.3f} ms plain "
                  f"{plain_ms:.3f} ms")
            check(err <= BWD_RTOL * scale,
                  f"K1 bwd M={m} F={f} disagrees with plain: {err} of {scale}")
            if result is None:
                result = {
                    "name": "halo_encode_bwd", "route": "cuda",
                    "source": "seal3d_tpu_torch/csrc/halo_encode.cu",
                    "replaces": "seal3d_tpu/ops/pallas/halo_encode.py:429",
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": None,
                    **encode_bound(m, m, 16, f, n)}
    return result


def train_phase(ws, backend="halo", steps=TRAIN_STEPS):
    """Phase 7 (halo, the -O default), 9 (bucket) or 10 (pallas) -> (the
    trainer, forward launches, backward launches) of the backend's kernels
    over the CLI training run of `steps` steps."""
    from seal3d_tpu_torch import main_nerf
    from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_bwd
    from seal3d_tpu_torch.ops.hash_encode import hash_encode, hash_encode_bwd
    from seal3d_tpu_torch.train import checkpoint as ckpt_io

    families = {"K1": (halo_encode, halo_encode_bwd),
                "hash-encode": (hash_encode, hash_encode_bwd)}
    own = "K1" if backend == "halo" else "hash-encode"
    tag = "[train]" if backend == "halo" else f"[train {backend}]"
    argv = ["synthetic", "-O", "--bound", "1.0", "--dt_gamma", "0",
            "--min_near", "0.05", "--max_steps", "512", "--iters",
            str(steps), "--H", "256", "--W", "256", "--device", "cuda",
            "--workspace", ws]
    if backend != "halo":
        argv += ["--grid_backend", backend]
    for fns in families.values():
        for fn in fns:
            fn.launches = 0
    # the CLI's own checkpoint writes, timed (the reference writes them
    # compressed too; their cost grows with the table)
    saves, save_state = [], ckpt_io.save_state

    def timed_save(path, state, full=True):
        t_save = time.perf_counter()
        save_state(path, state, full=full)
        saves.append((path, full, time.perf_counter() - t_save,
                      os.path.getsize(path)))

    ckpt_io.save_state = timed_save
    t0 = time.perf_counter()
    try:
        tr = main_nerf.main(argv)
    finally:
        ckpt_io.save_state = save_state
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    fwd, bwd = (fn.launches for fn in families[own])
    others = {name: [fn.launches for fn in fns]
              for name, fns in families.items() if name != own}
    check(tr.fcfg.grid_backend == backend,
          f"the CLI picked {tr.fcfg.grid_backend}, expected {backend}")

    st = tr.train_stats
    grid = st["grid_updates"]
    full = [s for f, s in grid if f]
    part = [s for f, s in grid if not f]
    step_ms = st["window_s"] / st["window_steps"] * 1e3
    rays_s = tr.cfg.num_rays * st["window_steps"] / st["window_s"]
    g = tr.fcfg.grid
    print(f"{tag} main_nerf {steps} steps at 256x256, grid "
          f"{g.backend}/{g.gridtype} T=2^{g.log2_hashmap_size} "
          f"({g.total_params} rows): {cli_s:.2f} s in all (data, training, "
          f"eval, 8 test renders)")
    print(f"{tag} steps {st['steps'] - st['window_steps'] + 1}-"
          f"{st['steps']}: {step_ms:.3f} ms per step, {rays_s:.0f} train "
          f"rays/s (grid updates included); full grid update "
          f"{np.mean(full):.4f} s (x{len(full)}), partial "
          f"{np.mean(part):.4f} s (x{len(part)}); final flat_frac "
          f"{tr.opts.flat_frac}")
    losses = [h["loss"] for h in tr.history]
    print(f"{tag} logged losses {[round(v, 5) for v in losses]} at steps "
          f"{[h['step'] for h in tr.history]}")
    check(len(losses) >= 2 and losses[-1] < losses[0],
          f"{backend}: the loss did not fall: {losses}")
    ckpt = os.path.join(ws, "checkpoints", f"ngp_step{steps:07d}.npz")
    with np.load(ckpt) as data:
        keys = [k for k in data.files if k.startswith("opt_state/")]
        counts = [int(data["opt_state/0/count"]), int(data["opt_state/1/count"])]
    print(f"{tag} {os.path.basename(ckpt)}: {len(keys)} opt_state arrays, "
          f"counts {counts}")
    check(counts == [steps] * 2 and len(keys) == 2 * 7 + 2,
          f"{backend}: checkpoint optimizer state: {len(keys)} keys, counts "
          f"{counts}")
    n_full, n_part = len(full), len(part)
    chunks = sum(s["chunks_rendered"] for s in tr.render_stats)
    field_calls = steps + grid_field_calls(grid, 1) + chunks
    print(f"{tag} {own} launches: backward {bwd} (train steps "
          f"{steps}), forward {fwd} (field calls {field_calls}: "
          f"{steps} steps, {n_full}x16 + {n_part}x3 grid-update chunks, "
          f"{chunks} rendered eval/test chunks); other kernels "
          f"(forward, backward) {others}")
    check(bwd == steps, f"{own} bwd launches {bwd} != steps "
                              f"{steps}")
    check(fwd == field_calls, f"{own} fwd launches {fwd} != field calls "
                              f"{field_calls}")
    check(all(n == 0 for c in others.values() for n in c),
          f"{backend}: other kernels launched: {others}")
    psnr = tr.eval_history[-1]["psnr"]
    print(f"{tag} val PSNR {psnr:.2f} dB over 4 views at 256x256 (for "
          f"reading only, not like for like: the JAX reference reached 38.92 "
          f"dB after 576 steps on a train view in its TPU run, "
          f"BENCH_r05.json)")
    check(psnr >= MIN_VAL_PSNR, f"{backend}: val PSNR {psnr:.2f} < "
                                f"{MIN_VAL_PSNR}")
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    check(len(pngs) == 8, f"{backend}: {len(pngs)} test PNGs written")
    # the CLI writes two compressed checkpoints (the step one with the
    # optimizer state, the eval's _best without), as the reference does
    print(f"{tag} the CLI's .npz checkpoints (np.savez_compressed): "
          + ", ".join(f"{os.path.basename(p)} ("
                      f"{'full' if full else 'no optimizer state'}, "
                      f"{size / 2**20:.1f} MiB) {sec:.2f} s"
                      for p, full, sec, size in saves))
    profile_steps(tr)
    return tr, fwd, bwd


# phase 22: main_nerf on a Blender tree at nerf_synthetic's layout (800x800
# views in <split>/r_<i>.png, transforms_<split>.json), cut from its 100 /
# 100 / 200 train / val / test views to 100 / 4 / 2
BLENDER_VIEWS = {"train": 100, "val": 4, "test": 2}
BLENDER_HW = 800
# (c)'s two RGBA runs (plain, --error_map), cut from steps for time;
# (d)'s RGB pair keeps steps, the background-net gap's reference
BLENDER_C_STEPS = 288
BG_RADIUS = 32.0
TERM_ROUNDS = (2, 4)
# (d): the background net's cost on the tree's RGB copy (plain minus
# --bg_radius val PSNR after this recipe's 576 steps) in the JAX package:
# 31.26 - 14.97 dB from scripts/bg_gap_witness.py on the tree at 200x200
# on the CPU (xla backend); the port's cost on the card may exceed it by
# at most BG_GAP_TOL_DB
BG_GAP_REF_DB = 16.29
BG_GAP_TOL_DB = 1.0


def write_blender_tree(dev, root, rgb_root, hw=BLENDER_HW):
    """Phase 22a -> {split: (ngp-convention poses [n, 4, 4], images [n, H,
    W, 4] uint8)} written under root as RGBA, as nerf_synthetic's frames
    are: SyntheticScene renders at random orbit poses of radius 2.2 (fov 50
    degrees, as its make_dataset) on white and on black, whose difference
    is the alpha and whose black render the premultiplied colour; PNGs by
    the port's writer, NeRF-convention matrices by ngp_to_nerf_matrix at
    scale 1; the same views on white as RGB under rgb_root."""
    from concurrent.futures import ThreadPoolExecutor

    from seal3d_tpu_torch.data.provider import ngp_to_nerf_matrix, rand_poses
    from seal3d_tpu_torch.data.synthetic import SyntheticScene
    from seal3d_tpu_torch.train.video import write_png

    scene, h = SyntheticScene(), hw
    fx = 0.5 * h / np.tan(np.deg2rad(25.0))
    intr = np.array([fx, fx, h / 2, h / 2], np.float32)
    rng = np.random.default_rng(22)
    written = {}
    for split, n in BLENDER_VIEWS.items():
        poses = rand_poses(rng, n, radius=2.2,
                           theta_range=(30, 120)).astype(np.float32)
        frames, imgs, rgbs = [], [], []
        for i, pose in enumerate(poses):
            white, _ = scene.render_view(pose, intr, h, h, chunk=2**16,
                                         device=dev)
            black, _ = scene.render_view(pose, intr, h, h, chunk=2**16,
                                         device=dev, bg=0.0)
            alpha = (1.0 - (white - black).mean(-1, keepdim=True)).clamp(0, 1)
            straight = torch.where(alpha > 0, black / alpha.clamp_min(1e-8),
                                   0.0)
            rgba = torch.cat([straight, alpha], -1)
            imgs.append((rgba.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
            rgbs.append((white.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
            frames.append({"file_path": f"./{split}/r_{i}", "rotation": 0.0,
                           "transform_matrix":
                               ngp_to_nerf_matrix(pose, scale=1.0).tolist()})
        for top, views in ((root, imgs), (rgb_root, rgbs)):
            os.makedirs(os.path.join(top, split), exist_ok=True)
            # zlib lets go of the GIL: the PNGs compress side by side
            with ThreadPoolExecutor(8) as pool:
                list(pool.map(lambda i: write_png(os.path.join(
                    top, split, f"r_{i}.png"), views[i]), range(n)))
            with open(os.path.join(top, f"transforms_{split}.json"), "w") as f:
                json.dump({"camera_angle_x": float(2 * np.arctan(0.5 * h / fx)),
                           "frames": frames}, f, indent=1)
        written[split] = (poses, np.stack(imgs))
    return written


def png_filter_rows(path) -> list:
    """Rows of an 8-bit PNG under each scanline filter type 0-4."""
    from seal3d_tpu_torch.data.provider import png_scanlines

    raw, _, w, c = png_scanlines(path)
    rows = np.frombuffer(raw, np.uint8)[::w * c + 1]
    return np.bincount(rows, minlength=5).tolist()


def blender_cli(argv, tag, min_psnr=MIN_VAL_PSNR, steps=TRAIN_STEPS):
    """main_nerf on the Blender tree with the kernel counts set to 0 just
    before and read just after -> (trainer, K1 forward, K1 backward
    launches). Prints ms a step after the warm-up steps, launches a step,
    val PSNR (gated at min_psnr) and checks that K1 ran once a field call
    and no other kernel of the table ran."""
    from seal3d_tpu_torch import main_nerf
    from seal3d_tpu_torch.train.trainer import TIMING_WARMUP

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    tr = main_nerf.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    fwd, bwd = counts.pop("halo_encode"), counts.pop("halo_encode_bwd")
    st = tr.train_stats
    step_ms = st["window_s"] / st["window_steps"] * 1e3
    chunks = sum(s["chunks_rendered"] for s in tr.render_stats)
    field_calls = (steps + grid_field_calls(st["grid_updates"], 1)
                   + chunks)
    psnr_db = tr.eval_history[-1]["psnr"]
    prof = profile_steps(tr, n=3)
    hw = f"{BLENDER_HW}x{BLENDER_HW}"
    print(f"[blender {tag}] main_nerf {steps} steps on "
          f"{len(tr.dataset)} {hw} views: {cli_s:.2f} s in all (load, "
          f"train, eval, test renders); steps {TIMING_WARMUP + 1}-"
          f"{steps}: {step_ms:.3f} ms a step (grid updates included); "
          f"{prof['launches']:.0f} launches and {prof['busy_ms']:.3f} ms of "
          f"device time a step (flat_frac {tr.opts.flat_frac}); val PSNR "
          f"{psnr_db:.2f} dB over {BLENDER_VIEWS['val']} views at {hw}")
    print(f"[blender {tag}] K1 launches: backward {bwd} (train steps "
          f"{steps}), forward {fwd} (field calls {field_calls}, "
          f"{chunks} rendered eval/test chunks); the other kernels {counts}")
    check(bwd == steps, f"{tag}: K1 bwd launches {bwd} != steps")
    check(fwd == field_calls, f"{tag}: K1 fwd launches {fwd} != field "
                              f"calls {field_calls}")
    check(not any(counts.values()), f"{tag}: other kernels ran: {counts}")
    check(psnr_db >= min_psnr, f"{tag}: val PSNR {psnr_db:.2f} < {min_psnr}")
    return tr, fwd, bwd


def term_rounds_renders(tr, pose):
    """Phase 22e: test view 0 at 800x800 with term_rounds 1, 2 and 4 on
    tr's state -> {(rounds, samples a ray): (image, weights_sum, s a view,
    field samples, chunks by bucket)}; weights_sum from the view rendered on
    white and on black (image = C + (1 - weights_sum) * bg). One round at
    -O's 48 samples a ray, then 1, 2 and 4 rounds at 192 (the TrainConfig
    default: -O's budget caps dense chunks, whose one round then thins its
    samples where the rounds' larger total budget keeps them), every round
    at the chunk's whole budget, so the comparison sees what termination
    drops."""
    h = BLENDER_HW
    cfg, opts = tr.cfg, tr.eval_opts
    out = {}
    try:
        for r, k in ((1, cfg.eval_budget_per_ray), (1, 192),
                     *((r, 192) for r in TERM_ROUNDS)):
            tr.cfg = dataclasses.replace(cfg, eval_budget_per_ray=k)
            tr.eval_opts = dataclasses.replace(
                opts, budget_per_ray=k, term_rounds=r,
                term_budget_fracs=(1.0,) * r if r > 1 else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            white, _ = tr.render_image(pose, h, h, bg_color=1.0)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            stats = tr.render_stats[-1]
            black, _ = tr.render_image(pose, h, h, bg_color=0.0)
            out[r, k] = (white, 1.0 - (white - black).mean(-1), sec,
                         stats["samples"], stats["buckets"])
    finally:
        tr.cfg, tr.eval_opts = cfg, opts
    return out


def blender_phase(dev, ws, smi):
    """Phase 22: real-scene loading and the rest of main_nerf's options on
    the card. (a) a Blender tree at nerf_synthetic's layout, RGBA, and an
    RGB copy on white; (b) its load, through cv2 where it imports and
    through the zlib reader; (c) main_nerf on it without and with
    --error_map (random backgrounds); (d) on the RGB copy with and without
    --bg_radius, and a .pth round trip of the background net; (e) term_rounds 2 and 4 against 1
    on test view 0; (f) a CLIP-guided step, or the CLI's named exit where
    transformers does not import. The CLI runs load with cv2 hidden. ->
    (K1 forward launches, backward launches, K1 forward max abs error
    against plain)."""
    from seal3d_tpu_torch.data import provider

    print(f"[blender] card: {smi}")
    root = os.path.join(ws, "blender_scene")
    rgb_root = os.path.join(ws, "blender_scene_rgb")
    t0 = time.perf_counter()
    written = write_blender_tree(dev, root, rgb_root)
    filters = png_filter_rows(os.path.join(root, "train", "r_0.png"))
    print(f"[blender] (a) wrote {sum(BLENDER_VIEWS.values())} views at "
          f"{BLENDER_HW}x{BLENDER_HW} ({BLENDER_VIEWS}; nerf_synthetic has "
          f"100 / 100 / 200), RGBA and an RGB copy on white, in "
          f"{time.perf_counter() - t0:.2f} s; rows of train/r_0.png by PNG "
          f"filter type 0-4: {filters}")

    # (b) the loader as the CLI calls it; where cv2 imports, also without
    # it (the reader that runs on a machine with no cv2)
    poses = np.concatenate([written["train"][0], written["val"][0]])
    images = np.concatenate([written["train"][1], written["val"][1]])
    cv2 = provider.cv2
    print(f"[blender] (b) cv2 " + ("does not import here" if cv2 is None else
                                   f"{cv2.__version__} imports here; the "
                                   f"CLI runs below hide it"))
    for name, mod in ([("cv2", cv2)] if cv2 is not None else []) + [
            ("read_png", None)]:
        provider.cv2 = mod
        try:
            t0 = time.perf_counter()
            ds = provider.NeRFDataset.load(root, split="trainval", scale=1.0)
            load_s = time.perf_counter() - t0
        finally:
            provider.cv2 = cv2
        same = (ds.images.shape == images.shape
                and np.array_equal(ds.images, images))
        pose_err = float(np.abs(ds.poses - poses).max())
        print(f"[blender] (b) NeRFDataset.load trainval ({len(ds)} views) "
              f"through {name}: {load_s:.2f} s "
              f"({load_s / len(ds) * 1e3:.1f} ms a view); images "
              f"bit-identical to the written ones: {same}; poses max abs "
              f"diff {pose_err:.2e}")
        check(same, f"{name}: the loaded images differ from the written ones")
        check(pose_err <= 1e-5, f"{name}: loaded poses differ by {pose_err}")
        del ds
    del written, images
    provider.cv2 = None
    try:
        return blender_runs(dev, ws, root, rgb_root)
    finally:
        provider.cv2 = cv2


def blender_runs(dev, ws, root, rgb_root):
    """Phase 22 (c)-(f) on the RGBA tree under root and its RGB copy under
    rgb_root -> (K1 forward launches, backward launches, K1 forward max abs
    error against plain)."""
    from seal3d_tpu_torch import main_nerf
    from seal3d_tpu_torch.data.provider import NeRFDataset
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.ops.raymarch import sph_from_ray
    from seal3d_tpu_torch.train.checkpoint import (export_torch_ngp,
                                                   flatten_tree,
                                                   import_torch_ngp, map_tree)

    def recipe(steps):
        return ["-O", "--bound", "1.0", "--scale", "1.0", "--dt_gamma", "0",
                "--min_near", "0.05", "--max_steps", "512", "--iters",
                str(steps), "--device", "cuda"]

    launches = np.zeros(2, np.int64)
    # (c) without and with the error map, on random backgrounds
    argv_c = [root] + recipe(BLENDER_C_STEPS)
    tr_c, *n = blender_cli(argv_c + ["--workspace",
                                     os.path.join(ws, "bl_c")], "plain",
                           steps=BLENDER_C_STEPS)
    launches += n
    tr_e, *n = blender_cli(argv_c + ["--error_map", "--workspace",
                                     os.path.join(ws, "bl_em")], "error_map",
                           steps=BLENDER_C_STEPS)
    launches += n
    emap = tr_e.state.error_map
    moved = float((emap != 0.1).float().mean())
    print(f"[blender error_map] map {tuple(emap.shape)}: {moved:.4f} of the "
          f"cells moved off 0.1; mean {float(emap.mean()):.5f}")
    check(moved > 0, "the error map never moved")
    with capture_k1(first_only=True) as seen:      # compared, not counted
        tr_e.train_step()
    err = k1_case_vs_plain(dict(seen[0], name="an error-map train step"),
                           "[blender]")
    del tr_e

    # (d) the background net on the RGB copy (the net paints the pixels
    # that RGBA's random backgrounds would fill), gated on its PSNR cost
    # against the plain field on the same copy
    argv_d = [rgb_root] + recipe(TRAIN_STEPS)
    tr_p, *n = blender_cli(argv_d + ["--workspace",
                                     os.path.join(ws, "bl_rgb")], "rgb")
    launches += n
    psnr_p = tr_p.eval_history[-1]["psnr"]
    del tr_p
    tr_d, *n = blender_cli(argv_d + ["--bg_radius", str(BG_RADIUS),
                                     "--workspace", os.path.join(ws, "bl_bg")],
                           "bg", min_psnr=0.0)
    launches += n
    gap = psnr_p - tr_d.eval_history[-1]["psnr"]
    print(f"[blender bg] val PSNR {tr_d.eval_history[-1]['psnr']:.2f} dB "
          f"with the net against {psnr_p:.2f} without: it costs {gap:.2f} "
          f"dB (the JAX package's cost on this tree: {BG_GAP_REF_DB} dB; "
          f"gate: at most {BG_GAP_TOL_DB} dB more)")
    check(gap <= BG_GAP_REF_DB + BG_GAP_TOL_DB,
          f"the background net costs {gap:.2f} dB, the JAX package's "
          f"{BG_GAP_REF_DB}")
    # the .pth round trip: exported in the halo layout as it is (the
    # reference's native layout keeps too few rows of the coarse levels,
    # which wrap indexing reads past the native level size) and imported
    # as `--ckpt x.pth` does
    path = os.path.join(ws, "bl_bg", "ngp.pth")
    export_torch_ngp(path, tr_d.state.params)
    fresh = map_tree(ngp.init(tr_d.fcfg,
                              generator=torch.Generator().manual_seed(7)),
                     lambda _, t: t.to(dev))
    loaded = import_torch_ngp(path, fresh, grid_cfg=tr_d.fcfg.grid)
    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.rand((2**16, 3), device=dev, generator=gen) * 2 - 1
    d = torch.nn.functional.normalize(
        torch.randn((2**16, 3), device=dev, generator=gen), dim=-1)
    sph = sph_from_ray(x, d, BG_RADIUS)
    with torch.no_grad():
        outs = [(*ngp.apply(p, tr_d.fcfg, x, d),
                 ngp.background(p, tr_d.fcfg, sph, d))
                for p in (tr_d.state.params, loaded)]
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    keys = [k for k, _ in flatten_tree(loaded) if "bg" in k]
    native = os.path.join(ws, "bl_bg", "ngp_native.pth")
    export_torch_ngp(native, tr_d.state.params, grid_cfg=tr_d.fcfg.grid)
    lossy = import_torch_ngp(native, fresh, grid_cfg=tr_d.fcfg.grid)
    lost = int((lossy["encoder"] != tr_d.state.params["encoder"])
               .any(-1).sum())
    print(f"[blender bg] .pth round trip ({os.path.getsize(path) / 2**20:.1f}"
          f" MiB, leaves {keys}): apply and background on 2^16 points "
          f"{'bit-identical' if same else 'DIFFER'}; through the native "
          f"layout {lost} rows of the encoder table change (coarse levels)")
    check(same, "the .pth round trip changed apply or background")
    del tr_d, loaded, fresh, lossy

    # (e) transmittance-terminated rounds on (c)'s state
    pose = NeRFDataset.load(root, split="test", scale=1.0).poses[0]
    renders, *n = k1_counted(lambda: term_rounds_renders(tr_c, pose))
    launches += n
    for (r, k), (_, _, sec, samples, buckets) in renders.items():
        print(f"[blender rounds] test view 0 at {BLENDER_HW}x{BLENDER_HW}, "
              f"{k} samples a ray, term_rounds {r}: {sec:.3f} s, {samples} "
              f"field samples, chunks by bucket {buckets}")
    img1, w1 = renders[1, 192][:2]
    for r in TERM_ROUNDS:
        img, wsum = renders[r, 192][:2]
        diff = (img - img1).abs()
        mean, out = float(diff.mean()), float((diff > 2e-2).float().mean())
        werr = float((wsum - w1).abs().mean())
        print(f"[blender rounds] term_rounds {r} against 1 at 192: mean "
              f"|d image| {mean:.2e}, share of values off by > 2e-2 "
              f"{out:.2e}, mean |d weights_sum| {werr:.2e}")
        check(mean < 1e-3 and out < 2e-3 and werr < 1e-3,
              f"term_rounds {r} differs from one round: {mean}, {out}, "
              f"{werr}")
    del tr_c, renders

    # (f) CLIP guidance: one guided step where transformers imports
    try:
        import transformers  # noqa: F401
        why = None
    except ImportError as e:
        why = str(e)
    argv_f = ["synthetic", "-O", "--bound", "1.0", "--dt_gamma", "0",
              "--min_near", "0.05", "--max_steps", "512", "--iters", "1",
              "--H", "64", "--W", "64", "--device", "cuda", "--rand_pose", "0",
              "--clip_text", "a red chair", "--clip_random_init",
              "--workspace", os.path.join(ws, "bl_clip")]
    if why is None:
        tr, *n = k1_counted(lambda: main_nerf.main(argv_f))
        launches += n
        loss = tr.history[0]["loss"]
        init = dict(flatten_tree(ngp.init(
            tr.fcfg, generator=torch.Generator().manual_seed(0))))
        moved = [k for k, v in flatten_tree(tr.state.params)
                 if not torch.equal(v.cpu(), init[k])]
        print(f"[blender clip] one guided step (random-init CLIP): loss "
              f"{loss:.5f}, leaves moved {len(moved)}")
        check(np.isfinite(loss) and moved, "the guided step did nothing")
    else:
        try:
            main_nerf.main(argv_f)
            msg = ""
        except SystemExit as e:
            msg = str(e)
        print(f"[blender clip] the guided step was not run: transformers "
              f"does not import here ({why}); the CLI exits with: {msg!r}")
        check("--clip_text needs" in msg, "the CLI did not exit with the "
                                          "named error")
    return int(launches[0]), int(launches[1]), err


def hash_kernels_phase(dev):
    """Phase 8 -> the kernel-table rows of hash_encode_fwd (timed at the
    bucket layout, M=2^20, F=4) and hash_encode_bwd (bucket, M=196,608,
    F=4); max_abs_err is the largest over every case, each of which is
    checked."""
    from seal3d_tpu_torch.ops.hash_encode import (hash_encode,
                                                  hash_encode_bwd,
                                                  hash_encode_bwd_plain,
                                                  hash_encode_plain)
    from seal3d_tpu_torch.ops.hashgrid import HashGridConfig

    rng = np.random.default_rng(8)
    layouts = {"bucket": 19, "pallas": 15}
    fwd = {"name": "hash_encode_fwd", "route": "cuda",
           "source": "seal3d_tpu_torch/csrc/hash_encode.cu",
           "replaces": "seal3d_tpu/ops/pallas/hash_encode.py:189",
           "launches": 0, "max_abs_err": 0.0}
    bwd = {"name": "hash_encode_bwd", "route": "cuda",
           "source": "seal3d_tpu_torch/csrc/hash_encode.cu",
           "replaces": "seal3d_tpu/ops/pallas/hash_encode.py:256; "
                       "seal3d_tpu/ops/pallas/bucket_grad.py:102",
           "launches": 0, "max_abs_err": 0.0}
    m = 2**20
    x = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32)).to(dev)
    for backend, log2t in layouts.items():
        cfg = HashGridConfig(num_levels=16, log2_hashmap_size=log2t,
                             backend=backend)
        for f in (4, 2):
            tab = torch.from_numpy(rng.uniform(-1, 1, (cfg.total_params, f))
                                   .astype(np.float32)).to(dev)
            err, _, ms, plain_ms = compare(
                lambda: hash_encode(tab, x, cfg),
                lambda: hash_encode_plain(tab, x, cfg))
            print(f"[hash fwd] {backend} T=2^{log2t} ({cfg.total_params} "
                  f"rows) M=2^20 L=16 F={f}: max_abs_err {err:.3e} kernel "
                  f"{ms:.3f} ms plain {plain_ms:.3f} ms")
            check(err <= TOL, f"hash fwd {backend} F={f} disagrees with "
                              f"plain: {err}")
            fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
            if backend == "bucket" and f == 4:
                hashed = sum(h for *_, h, _ in cfg.level_params)
                fwd.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                           **encode_bound(m, m, 16, f, cfg.total_params,
                                          hashed_levels=hashed))
            del tab
    for backend, log2t in layouts.items():
        cfg = HashGridConfig(num_levels=16, log2_hashmap_size=log2t,
                             backend=backend)
        n = cfg.total_params
        for mb in (4096 * 48, 2**20):
            xb = x[:mb]
            for f in (4, 2):
                g = torch.from_numpy(rng.uniform(-1, 1, (mb, 16 * f))
                                     .astype(np.float32)).to(dev)
                err, scale, ms, plain_ms = compare(
                    lambda: hash_encode_bwd(g, xb, cfg, n),
                    lambda: hash_encode_bwd_plain(g, xb, cfg, n))
                hashed = sum(h for *_, h, _ in cfg.level_params)
                bnd = encode_bound(mb, mb, 16, f, n, hashed_levels=hashed)
                print(f"[hash bwd] {backend} T=2^{log2t} M={mb} L=16 F={f}: "
                      f"max_abs_err {err:.3e} (max |grad| {scale:.3e}, rel "
                      f"{err / scale:.3e}); kernel {ms:.3f} ms plain "
                      f"{plain_ms:.3f} ms bound {bnd['bound_ms']:.4f} ms")
                check(err <= BWD_RTOL * scale,
                      f"hash bwd {backend} M={mb} F={f} disagrees with "
                      f"plain: {err} of {scale}")
                bwd["max_abs_err"] = max(bwd["max_abs_err"], err)
                if backend == "bucket" and mb == 4096 * 48 and f == 4:
                    bwd.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                               **bnd)
    # what the bucket field pays around the kernels: the per-call stacking
    # of the sigma and color tables into one F=4 table (as the reference),
    # and the backward over the dense coarse levels alone (levels 0-4: their
    # atomics contend, thousands of samples per entry), per (sample, level)
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=19,
                         backend="bucket")
    t2 = [torch.zeros((cfg.total_params, 2), device=dev) for _ in range(2)]
    cat_ms = time_ms(lambda: torch.cat(t2, dim=-1))
    dense = sum(not h for *_, h, _ in cfg.level_params)
    coarse = HashGridConfig(
        num_levels=dense, log2_hashmap_size=19, backend="bucket",
        desired_resolution=16 * cfg.per_level_scale ** (dense - 1))
    check(all(not h for *_, h, _ in coarse.level_params),
          "the coarse config has a hashed level")
    mb = 4096 * 48
    xb = x[:mb]
    g = torch.from_numpy(rng.uniform(-1, 1, (mb, 16 * 4))
                         .astype(np.float32)).to(dev)
    all_ms = time_ms(lambda: hash_encode_bwd(g, xb, cfg, cfg.total_params))
    gc = g.reshape(mb, 16, 4)[:, :dense].contiguous()
    coarse_ms = time_ms(lambda: hash_encode_bwd(gc, xb, coarse,
                                                coarse.total_params))
    # K2's own function (a scatter-add of per-corner rows into the table)
    # as one PyTorch call, index_add_, on this backward's corner keys: the
    # kernel above also forms the rows (weights x cotangent) on the way
    from seal3d_tpu_torch.ops.hashgrid import corner_indices_weights

    with torch.no_grad():
        keys, w = corner_indices_weights(xb, cfg)          # [M, L, 8]
        rows = (g.reshape(mb, 16, 1, 4) * w[..., None]).reshape(-1, 4)
        keys = keys.reshape(-1)
        del w
        lib_ms = time_ms(lambda: torch.zeros(
            (cfg.total_params, 4), device=dev).index_add_(0, keys, rows), 5)
    print(f"[hash bwd] the scatter alone as index_add_ ({keys.shape[0]} rows "
          f"of F=4 into {cfg.total_params}): {lib_ms:.3f} ms")
    del keys, rows
    print(f"[hash] stacking the two T=2^19 tables (torch.cat, "
          f"{4 * 4 * cfg.total_params / 2**20:.1f} MiB out): {cat_ms:.3f} ms "
          f"per field call")
    print(f"[hash bwd] contention, bucket T=2^19 M={mb} F=4 uniform points: "
          f"all 16 levels {all_ms:.3f} ms ({all_ms / 16 * 1e3:.1f} us per "
          f"level), the {dense} dense levels alone {coarse_ms:.3f} ms "
          f"({coarse_ms / dense * 1e3:.1f} us per level)")
    return [fwd, bwd]


O_ARGV = ["synthetic", "-O", "--bound", "1.0", "--dt_gamma", "0",
          "--min_near", "0.05", "--max_steps", "512", "--device", "cuda"]


def k4_random_rays(dev, n, seed, miss=0.2):
    """n rays from radius 3 around the unit box: a share `miss` along lines
    that pass 2.0 from its centre (outside the box's sphere of radius
    sqrt 3), the others towards uniform points inside [-0.9, 0.9]^3."""
    rng = np.random.default_rng(seed)

    def unit(m):
        v = rng.normal(size=(m, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    n_miss = int(n * miss)
    o = 3.0 * unit(n)
    d = rng.uniform(-0.9, 0.9, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dm = unit(n_miss)
    p = unit(n_miss)
    p -= (p * dm).sum(1, keepdims=True) * dm
    p *= 2.0 / np.linalg.norm(p, axis=1, keepdims=True)
    o[:n_miss], d[:n_miss] = p - 3.0 * dm, dm
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in (o, d))


def k4_host_us(dev, calls: int = 200) -> float:
    """Host microseconds per call of the ladder_plan wrapper: the host clock
    over `calls` back-to-back calls, read before the closing sync (the
    kernel takes less than the enqueue, so the queue never backs up), on
    random rays of one render chunk at the -O eval point. Builds its own
    inputs, so that it can time another version of ops/ladder.py put in the
    tree's place: python3 -c 'import chip_smoke, torch;
    print(chip_smoke.k4_host_us(torch.device("cuda")))'"""
    from seal3d_tpu_torch.ops.ladder import ladder_plan, pack_tables

    ro, rd = k4_random_rays(dev, 32768, seed=12)
    bitfield = torch.randint(0, 256, (2**18,), dtype=torch.uint8, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(12))
    tables = pack_tables(bitfield, 64)
    aabb = torch.tensor([-1.0, -1, -1, 1, 1, 1], device=dev)
    kw = dict(bound=1.0, min_near=0.05, max_steps=512, num_candidates=256,
              group=4, n_coarse=32, pool=64)
    for _ in range(10):
        ladder_plan(ro, rd, *tables, aabb, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        ladder_plan(ro, rd, *tables, aabb, **kw)
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def ladder_phase(dev, tr7, ds, ws, baselines):
    """Phases 11 and 12 -> the kernel-table row of ladder_plan (K4). tr7:
    phase 7's trainer (its state is the trained teacher); ds: the 800x800
    test split; baselines: other versions of csrc/ladder.cu, timed in turns
    with the tree's."""
    from seal3d_tpu_torch.config import (build_options, build_train_config,
                                         common_parser)
    from seal3d_tpu_torch.data.rays import get_full_rays
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.ops import ladder as k4
    from seal3d_tpu_torch.ops.ladder import (ladder_plan, ladder_plan_plain,
                                             pack_tables)
    from seal3d_tpu_torch.render.renderer import march_flat
    from seal3d_tpu_torch.train.trainer import Trainer

    cli = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--workspace", os.path.join(ws, "ladder")])
    trainers = {}
    for on in (False, True):
        t = Trainer(ngp, tr7.fcfg,
                    dataclasses.replace(build_options(cli), tl_kernel=on),
                    build_train_config(cli), dataset=ds, device=dev)
        t.state = tr7.state
        trainers[on] = t
    t_on = trainers[True]
    eo, chunk, st = t_on.eval_opts, t_on.cfg.eval_chunk, tr7.state
    check(eo.tl_kernel_ok(t_on.cfg.eval_budget_per_ray, None)
          and not trainers[False].eval_opts.tl_kernel_ok(
              t_on.cfg.eval_budget_per_ray, None),
          "the -O eval options do not take the ladder kernel")

    # --- phase 11: K4 vs plain on the busiest chunk of test view 0, on
    # random rays at both pooled views and on the probes of one whole view
    kw = dict(bound=eo.bound, min_near=eo.min_near, max_steps=eo.max_steps,
              num_candidates=eo.num_candidates, group=eo.tl_group,
              n_coarse=eo.coarse_steps, pool=eo.tl_pool)
    cg = eo.num_candidates // eo.tl_group
    rays = get_full_rays(torch.as_tensor(ds.poses[0], device=dev),
                         t_on._intrinsics, ds.h, ds.w)
    sel, _, _ = t_on._chunk_layout(ds.h, ds.w, chunk)
    tables = pack_tables(st.occ.bitfield, eo.tl_pool)
    aabb = t_on._march_aabb(st.occ.occ_aabb)
    full = [torch.as_tensor(s_, device=dev) for s_ in sel if (s_ >= 0).all()]
    demand = [float(ladder_plan(rays["rays_o"][i], rays["rays_d"][i], *tables,
                                aabb, **kw)[3].sum()) for i in full]
    idx = full[int(np.argmax(demand))]
    ro, rd = rays["rays_o"][idx].contiguous(), rays["rays_d"][idx].contiguous()
    t0, far, keep, cnt = ladder_plan(ro, rd, *tables, aabb, **kw)
    check(keep.dtype == torch.bool and keep.shape == (chunk, cg),
          f"K4 keep is {keep.dtype} {tuple(keep.shape)}")
    fine = float(cnt.sum())
    hit = int((t0 < 1e9).sum())
    bucket = t_on._pick_bucket(chunk, int(fine), int(keep.sum()))
    mf = march_flat(ro, rd, st.occ.bitfield,
                    dataclasses.replace(eo, flat_frac=bucket), aabb, None,
                    tables)
    kept = int(mf.valid.sum())
    ms, plain_ms = time_turns(
        lambda: ladder_plan(ro, rd, *tables, aabb, **kw),
        lambda: ladder_plan_plain(ro, rd, *tables, aabb, **kw))
    plain_launches = count_launches(
        lambda: ladder_plan_plain(ro, rd, *tables, aabb, **kw))
    print(f"[k4] view 0, busiest chunk: N={chunk} rays ({hit} hit the box) "
          f"CG={cg} g={eo.tl_group} n_coarse={eo.coarse_steps} pool="
          f"{eo.tl_pool}: {int(keep.sum())} kept groups, demand {fine:.0f}, "
          f"fine repack keeps {kept} at bucket {bucket}")
    print(f"[k4] events around eager calls: kernel {ms:.4f} ms (1 launch) "
          f"plain {plain_ms:.3f} ms ({plain_launches} launches)")
    check(fine >= kept > 0, f"K4 demand {fine} < fine repack's {kept}")

    rro, rrd = k4_random_rays(dev, chunk, seed=11)
    cases = [("busiest chunk of test view 0", ro, rd, tables, kw)]
    for pool in (32, 64):
        cases.append((f"{chunk} random rays, 20% miss the box, pool {pool}",
                      rro, rrd, pack_tables(st.occ.bitfield, pool),
                      dict(kw, pool=pool)))
    names = baseline_names(baselines)
    dev_ms_chunk = None
    err = 0.0
    for tag, r_o, r_d, tabs, kw_ in cases:
        with torch.no_grad():
            out = ladder_plan(r_o, r_d, *tabs, aabb, **kw_)
            ref = ladder_plan_plain(r_o, r_d, *tabs, aabb, **kw_)
            diff = [k for k, a_, b_ in zip(("t0", "far", "keep", "cnt"),
                                           out, ref) if not torch.equal(a_, b_)]
            check(not diff, f"K4 on {tag}: {diff} not bit-identical to plain")
            err = max(err, *(float((a_.float() - b_.float()).abs().max())
                             for a_, b_ in zip(out, ref)))
            for src, name in zip(baselines, names[1:]):
                with other_library(src):
                    other = ladder_plan(r_o, r_d, *tabs, aabb, **kw_)
                check(all(torch.equal(a_, b_) for a_, b_ in zip(other, out)),
                      f"K4 of {name} differs from the tree's on {tag}")
            dev_ms = in_turns(baselines, lambda: time_device_ms(
                lambda: ladder_plan(r_o, r_d, *tabs, aabb, **kw_)))
        n_hit = int((out[0] < 1e9).sum())
        print(f"[k4 cases] {tag}: {n_hit} of {r_o.shape[0]} rays hit the box, "
              f"{int(out[2].sum())} kept groups; t0, far, keep and cnt "
              f"bit-identical to plain"
              + ("" if len(names) == 1 else " (and every baseline's)")
              + "; device ms: " + "; ".join(
                  f"{name} {sum(dev_ms[name]) / 2:.4f} {dev_ms[name]}"
                  for name in names))
        if dev_ms_chunk is None:    # the first case: the busiest chunk
            dev_ms_chunk = sum(dev_ms["tree"]) / 2
            plain_dev_ms = busy_ms(
                lambda: ladder_plan_plain(ro, rd, *tables, aabb, **kw))

    # the 20 demand probes of one view, as render_image issues them (pad
    # slots get rays that miss the box), back to back in one graph
    ok = torch.from_numpy(sel >= 0).to(dev)[..., None]
    selt = torch.from_numpy(np.clip(sel, 0, None)).to(dev)
    b = t_on.opts.bound
    ro_c = torch.where(ok, rays["rays_o"][selt],
                       torch.tensor([3.0 * b, 0.0, 0.0], device=dev))
    rd_c = torch.where(ok, rays["rays_d"][selt],
                       torch.tensor([1.0, 0.0, 0.0], device=dev))
    with torch.no_grad():
        view_ms = in_turns(baselines, lambda: time_device_ms(
            lambda: [ladder_plan(ro_c[i], rd_c[i], *tables, aabb, **kw)
                     for i in range(len(sel))], 5))
    host = k4_host_us(dev)
    print(f"[k4 cases] the {len(sel)} demand probes of view 0 in one graph, "
          f"device ms: " + "; ".join(
              f"{name} {sum(view_ms[name]) / 2:.4f} {view_ms[name]}"
              for name in names))
    print(f"[k4 cases] host us per ladder_plan wrapper call: {host:.1f}; "
          f"the plain version's device ms on the busiest chunk: "
          f"{plain_dev_ms:.4f}")
    # per hit ray ~30 operations per coarse step and ~25 per group, ~20 more
    # per kept group (the 128^3 test); rays that miss the box need none
    row = {"name": "ladder_plan", "route": "cuda",
           "source": "seal3d_tpu_torch/csrc/ladder.cu",
           "replaces": "seal3d_tpu/ops/pallas/ladder.py:230",
           "launches": 0, "max_abs_err": err, "ms": dev_ms_chunk,
           "plain_ms": plain_dev_ms, "library_ms": None,
           **bound(chunk * (24 + 12 + cg) + 24
                   + sum(t.numel() for t in tables),
                   hit * (eo.coarse_steps * 30 + cg * 25)
                   + int(keep.sum()) * 20)}
    del rays, mf, ro_c, rd_c

    # --- phase 12: the 8 test views with and without K4
    for on in (False, True):    # one warm-up view each way
        trainers[on].render_image(ds.poses[0], ds.h, ds.w)
        trainers[on].render_stats.clear()
    ladder_plan.launches = 0
    d_img = d_dep = 0.0
    for vi in range(len(ds)):
        off = trainers[False].render_image(ds.poses[vi], ds.h, ds.w)
        on = trainers[True].render_image(ds.poses[vi], ds.h, ds.w)
        d_img = max(d_img, float((on[0] - off[0]).abs().max()))
        d_dep = max(d_dep, float((on[1] - off[1]).abs().max()))
    launches = ladder_plan.launches
    s_off = list(trainers[False].render_stats)
    s_on = list(trainers[True].render_stats)
    probes = len(sel) * len(ds)
    rendered = sum(s_["chunks_rendered"] for s_ in s_on)
    sec = {on: float(np.mean([s_["seconds"] for s_ in stats]))
           for on, stats in ((False, s_off), (True, s_on))}
    per_view = {on: count_launches(
        lambda: trainers[on].render_image(ds.poses[0], ds.h, ds.w))
        for on in (False, True)}
    print(f"[k4 render] {len(ds)} views {ds.h}x{ds.w}, tl_kernel on vs off: "
          f"image max diff "
          f"{d_img:.3e}, depth max diff {d_dep:.3e}, samples "
          f"{[s_['samples'] for s_ in s_on]}; K4 launches {launches} "
          f"({probes} probes + {rendered} rendered chunks)")
    print(f"[k4 render] s per view: off {sec[False]:.4f} on {sec[True]:.4f}; "
          f"kernel launches for view 0: off {per_view[False]} on "
          f"{per_view[True]}")
    check(d_img <= 1e-5 and d_dep <= 1e-4,
          f"the tl_kernel render differs: image {d_img} depth {d_dep}")
    check([s_["samples"] for s_ in s_on] == [s_["samples"] for s_ in s_off],
          "the tl_kernel render kept other sample counts")
    check(all(s_["nonfinite"] == 0 for s_ in s_on), "non-finite pixels")
    check(launches > 0 and launches == probes + rendered,
          f"K4 launches {launches} != probes {probes} + chunks {rendered}")
    row["launches"] = launches
    return row


def lookup_phase(dev, baselines):
    """Phase 13 -> the kernel-table rows of multilevel_lookup_fwd and
    multilevel_lookup_bwd (K5), timed at case (a) F=4; max_abs_err is the
    largest over every case, each of which is checked. baselines: other
    versions of csrc/lookup.cu, whose backward is timed in turns with the
    tree's."""
    from seal3d_tpu_torch.ops.hashgrid import (HashGridConfig, gather_encode,
                                               hashgrid_encode,
                                               lookup_indices)
    from seal3d_tpu_torch.ops.lookup import (multilevel_lookup,
                                             multilevel_lookup_bwd,
                                             multilevel_lookup_bwd_plain,
                                             multilevel_lookup_plain)

    base = {"route": "cuda", "source": "seal3d_tpu_torch/csrc/lookup.cu",
            "launches": 0, "max_abs_err": 0.0}
    fwd = {"name": "multilevel_lookup_fwd",
           "replaces": "seal3d_tpu/ops/pallas/lookup.py:104", **base}
    bwd = {"name": "multilevel_lookup_bwd",
           "replaces": "seal3d_tpu/ops/pallas/lookup.py:156", **base}
    cases = [("3-D align_corners", dict(num_levels=16, log2_hashmap_size=15,
                                        align_corners=True), 2**18, (4, 2)),
             ("2-D background grid", dict(num_levels=4, log2_hashmap_size=19,
                                          desired_resolution=2048,
                                          input_dim=2), 2**20, (2,))]
    rng = np.random.default_rng(13)
    multilevel_lookup.launches = multilevel_lookup_bwd.launches = 0
    drives = 0
    counted = [0, 0]
    timed = []
    for tag, kw, m, widths in cases:
        cfg = HashGridConfig(backend="pallas", **kw)
        levels, n_rows = cfg.num_levels, cfg.total_params
        x = torch.from_numpy(rng.uniform(0, 1, (m, cfg.input_dim))
                             .astype(np.float32)).to(dev)
        for f in widths:
            tab = torch.from_numpy(rng.uniform(-1, 1, (n_rows, f))
                                   .astype(np.float32)).to(dev)
            ct = torch.from_numpy(rng.uniform(-1, 1, (m, levels * f))
                                  .astype(np.float32)).to(dev)
            # the path: hashgrid_encode and its autograd backward
            before = (multilevel_lookup.launches,
                      multilevel_lookup_bwd.launches)
            t = tab.clone().requires_grad_()
            out = hashgrid_encode(t, x, cfg)
            out.backward(ct)
            counted[0] += multilevel_lookup.launches - before[0]
            counted[1] += multilevel_lookup_bwd.launches - before[1]
            drives += 1
            tp = tab.clone().requires_grad_()
            ref = gather_encode(tp, x, cfg).reshape(m, -1)
            ref.backward(ct)
            e_f = float((out.detach() - ref.detach()).abs().max())
            e_b = float((t.grad - tp.grad).abs().max())
            scale = float(tp.grad.abs().max())
            del t, tp, out, ref, ct

            # the kernels alone, on the indices the path hands them
            with torch.no_grad():
                idx, _ = lookup_indices(x, cfg)
                n = idx.shape[1]
                rows = (idx.to(torch.int64) + torch.arange(
                    levels, device=dev)[:, None] * (n_rows // levels)
                        ).reshape(-1)
                g = torch.from_numpy(rng.uniform(-1, 1, (levels, n, f))
                                     .astype(np.float32)).to(dev)
                g2 = g.reshape(-1, f)
                same = torch.equal(multilevel_lookup(tab, idx),
                                   multilevel_lookup_plain(tab, idx))
                f_ms, f_plain = time_turns(
                    lambda: multilevel_lookup(tab, idx),
                    lambda: multilevel_lookup_plain(tab, idx))
                f_lib = time_ms(lambda: tab.index_select(0, rows))
                gk = multilevel_lookup_bwd(g, idx, n_rows)
                gp = multilevel_lookup_bwd_plain(g, idx, n_rows)
                e_k = float((gk - gp).abs().max())
                k_scale = float(gp.abs().max())
                del gk, gp
                _, b_plain = time_turns(
                    lambda: multilevel_lookup_bwd(g, idx, n_rows),
                    lambda: multilevel_lookup_bwd_plain(g, idx, n_rows))
                b_lib = time_ms(lambda: torch.zeros(
                    (n_rows, f), device=dev).index_add_(0, rows, g2))
            print(f"[k5] {tag} L={levels} T=2^{cfg.log2_hashmap_size} F={f} "
                  f"M={m} ({levels * n} pairs): hashgrid_encode vs plain "
                  f"gather fwd max_abs_err {e_f:.3e}, bwd max_abs_err "
                  f"{e_b:.3e} (max |grad| {scale:.3e}, rel "
                  f"{e_b / scale:.3e}); kernel alone fwd "
                  f"{'bit-identical' if same else 'DIFFERS'}, bwd rel "
                  f"{e_k / k_scale:.3e}")
            print(f"[k5]   fwd kernel {f_ms:.3f} ms plain {f_plain:.3f} ms "
                  f"index_select {f_lib:.3f} ms; bwd plain {b_plain:.3f} ms "
                  f"index_add_ {b_lib:.3f} ms")
            check(e_f <= TOL, f"K5 fwd {tag} F={f} disagrees: {e_f}")
            check(same, f"K5 fwd {tag} F={f}: kernel differs from plain")
            check(e_b <= BWD_RTOL * scale,
                  f"K5 bwd {tag} F={f} disagrees: {e_b} of {scale}")
            check(e_k <= BWD_RTOL * k_scale,
                  f"K5 bwd kernel {tag} F={f} disagrees: {e_k} of {k_scale}")
            fwd["max_abs_err"] = max(fwd["max_abs_err"], e_f)
            bwd["max_abs_err"] = max(bwd["max_abs_err"], e_b, e_k)
            if "ms" not in fwd:
                # idx 4 B and one row out per pair; the rows gathered, at
                # most the whole table; no arithmetic but the row address
                pairs = levels * n
                fwd.update(ms=f_ms, plain_ms=f_plain, library_ms=f_lib,
                           **bound(pairs * (4 + 4 * f)
                                   + 4 * f * min(pairs, n_rows), pairs))
                # device time, as the kernel's own (lookup_bwd_measure)
                bwd.update(plain_ms=time_device_ms(
                    lambda: multilevel_lookup_bwd_plain(g, idx, n_rows)),
                           library_ms=time_device_ms(lambda: torch.zeros(
                               (n_rows, f), device=dev).index_add_(0, rows,
                                                                    g2)),
                           **bound(pairs * (4 + 4 * f) + 4 * f * n_rows,
                                   pairs * f))
            timed.append(dict(tag=f"{tag} F={f}", g=g, idx=idx,
                              n_rows=n_rows, scale=k_scale))
            del tab, g2, rows
    print(f"[k5] launches through hashgrid_encode and its backward: forward "
          f"{counted[0]}, backward {counted[1]} ({drives} calls)")
    check(counted == [drives, drives],
          f"K5 launches {counted} != hashgrid_encode calls {drives}")
    fwd["launches"], bwd["launches"] = counted
    bwd["ms"] = lookup_bwd_measure(dev, timed, baselines)
    return [fwd, bwd]


def atomic_sectors(idx, t_rows, f) -> int:
    """The 32-byte gradient sectors that K5's backward sends to the L2: for
    each run of 32 consecutive (level, pair) items (a warp's vector atomic),
    the distinct sectors its valid rows fall in, summed."""
    levels, n = idx.shape
    ok = (idx >= 0) & (idx < t_rows)
    base = torch.arange(levels, device=idx.device)[:, None] * t_rows
    sec = torch.where(ok, (idx.long() + base) * (4 * f) // 32, -1).flatten()
    sec = torch.nn.functional.pad(sec, (0, -sec.numel() % 32), value=-1)
    s = sec.view(-1, 32).sort(dim=1).values
    new = torch.cat([s[:, :1] >= 0, (s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)],
                    dim=1)
    return int(new.sum())


def lookup_bwd_measure(dev, timed, baselines) -> float:
    """Phase 13, end: K5's backward as device time (CUDA-graph replays) on
    each case, every version (the tree's, then every lookup.cu --baseline) in
    turns: through the wrapper (with the zero fill of its gradient), the
    zero fill alone, the kernel alone on a gradient allocated once, and the
    kernel alone level by level (one-level launches on slices of idx, g and
    the gradient). Beside them the atomic-rate floor: the 32-byte sectors
    that one vector atomic a pair sends to the L2 (`atomic_sectors`) over
    the rate at which the tree's kernel sends them on the same pairs at
    rows drawn uniformly from T (first case of each width F).
    -> the tree's wrapper time on the first case."""
    from seal3d_tpu_torch.ops import lookup as k5
    from seal3d_tpu_torch.ops.lookup import multilevel_lookup_bwd

    names = baseline_names(baselines)
    first = None
    rates = {}
    for case in timed:
        g, idx, n_rows = case["g"], case["idx"], case["n_rows"]
        levels, n = idx.shape
        f, t_rows = g.shape[-1], n_rows // levels
        gtab = torch.zeros((n_rows, f), device=dev)
        ops = {"wrapper": lambda: multilevel_lookup_bwd(g, idx, n_rows),
               "kernel": lambda: k5._run(k5._BWD, g, idx, gtab, t_rows, f,
                                         multilevel_lookup_bwd)}
        for l in range(levels):
            ops[f"L{l}"] = (lambda l=l: k5._run(
                k5._BWD, g[l:l + 1], idx[l:l + 1],
                gtab[l * t_rows:(l + 1) * t_rows], t_rows, f,
                multilevel_lookup_bwd))
        with torch.no_grad():
            ref = multilevel_lookup_bwd(g, idx, n_rows)
            for src, name in zip(baselines, names[1:]):
                with other_library(src):
                    d = float((multilevel_lookup_bwd(g, idx, n_rows)
                               - ref).abs().max())
                check(d <= 2 * BWD_RTOL * case["scale"],
                      f"K5 bwd of {name} differs from the tree's on "
                      f"{case['tag']}: {d} of {case['scale']}")
            del ref
            times = {name: {} for name in names}
            for op, fn in ops.items():
                for name, pair in in_turns(
                        baselines,
                        lambda fn=fn: time_device_ms(fn)).items():
                    times[name][op] = sum(pair) / 2
            zero_ms = time_device_ms(
                lambda: torch.zeros((n_rows, f), device=dev))
            if f not in rates:
                # the same pairs and cotangent at uniform rows of T: at case
                # (a), 64 adds a row on every level
                uni = torch.randint(0, t_rows, idx.shape, dtype=torch.int32,
                                    device=dev,
                                    generator=torch.Generator(device=dev)
                                    .manual_seed(13))
                rates[f] = atomic_sectors(uni, t_rows, f) / (time_device_ms(
                    lambda: k5._run(k5._BWD, g, uni, gtab, t_rows, f,
                                    multilevel_lookup_bwd)) * 1e-3)
                del uni
            rate = rates[f]
            pairs = int(((idx >= 0) & (idx < t_rows)).sum())
            every = atomic_sectors(idx, t_rows, f)
        print(f"[k5 bwd] {case['tag']}: {levels} levels x {n} pairs "
              f"({pairs} valid), [{n_rows}, {f}] gradient; its zero fill "
              f"{zero_ms:.4f} ms; atomic sectors at {rate / 1e9:.1f} G/s "
              f"(these pairs at uniform rows) -> atomic-rate floor "
              f"{every / rate * 1e3:.4f} ms ({every} sectors)")
        for name in names:
            tm = times[name]
            per = [tm[f"L{l}"] * 1e3 for l in range(levels)]
            print(f"[k5 bwd]   {name}: wrapper {tm['wrapper']:.4f} ms, kernel "
                  f"alone {tm['kernel']:.4f} ms; level by level, us: "
                  f"{[round(u, 1) for u in per]} (sum {sum(per) / 1e3:.4f} "
                  f"ms)")
        if first is None:
            first = times["tree"]["wrapper"]
        del gtab
    return first


def seal_phase(dev, ws, teacher_ckpt):
    """Phase 14 -> (K1 forward launches, K1 backward launches, K4 launches)
    of the bbox edit through the CLI and of the edited views' renders, the
    K1 arguments of its first pretraining batch, the field head's
    (forward, backward) launches of the edit, and the fused Adam and EMA's
    (one a pretraining batch)."""
    from seal3d_tpu_torch import main_SealNeRF
    from seal3d_tpu_torch.config import common_parser, load_dataset
    from seal3d_tpu_torch.ops.adam import adam_ema
    from seal3d_tpu_torch.ops.field_head import field_head_bwd, field_head_fwd
    from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_bwd
    from seal3d_tpu_torch.ops.hash_encode import hash_encode, hash_encode_bwd
    from seal3d_tpu_torch.ops.ladder import ladder_plan
    from seal3d_tpu_torch.seal.renderer import hack_bitfield

    epochs, steps = SEAL_EPOCHS, SEAL_STEPS
    here = os.path.dirname(os.path.abspath(__file__))
    argv = O_ARGV + ["--H", "256", "--W", "256", "--seal_config",
                     os.path.join(here, "seal_config_bbox"),
                     "--teacher_ckpt", teacher_ckpt,
                     "--pretraining_epochs", str(epochs), "--extra_epochs",
                     str(steps), "--workspace", ws]
    for fn in (halo_encode, halo_encode_bwd, hash_encode, hash_encode_bwd,
               ladder_plan, field_head_fwd, field_head_bwd, adam_ema):
        fn.launches = 0
    t0 = time.perf_counter()
    with capture_k1(lambda x: x.shape[0] == 2**19, first_only=True) as seen:
        st = main_SealNeRF.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    head = field_head_fwd.launches, field_head_bwd.launches
    adam_n = adam_ema.launches
    check(len(seen) == 1, "no pretraining batch of 2^19 points was seen")
    seal_case = dict(seen[0], name="Seal pretraining batch (shell points)")
    fwd, bwd = halo_encode.launches, halo_encode_bwd.launches
    check(hash_encode.launches == 0 and hash_encode_bwd.launches == 0
          and ladder_plan.launches == 0, "the -O edit launched other kernels")

    timer = edit_outputs(st, ws, epochs, f"[seal] main_SealNeRF bbox edit "
                                         f"at 256x256: {cli_s:.2f} s in all;")

    # every field call went through K1: count them
    calls = edit_launch_check(st, epochs, steps, fwd, bwd, "[seal]")
    # the field head's kernel: every field call but the grid updates'
    # density queries and the finetune steps, which train the MLPs
    head_calls = (calls["queries"] + calls["batches"] + calls["proxy"]
                  + calls["test"])
    print(f"[seal] field head launches: backward {head[1]} (one a pretrain "
          f"batch, {calls['batches']}; none a finetune step), forward "
          f"{head[0]} ({head_calls}: {calls['queries']} teacher queries, "
          f"{calls['batches']} pretrain batches, {calls['proxy']} proxy "
          f"chunks, {calls['test']} test chunks)")
    check(head == (head_calls, calls["batches"]),
          f"field head launches {head} != ({head_calls}, {calls['batches']})")
    print(f"[seal] fused Adam and EMA launches {adam_n} (one a pretrain "
          f"batch, {calls['batches']})")
    check(adam_n == calls["batches"], f"fused Adam and EMA launches "
                                      f"{adam_n} != {calls['batches']}")
    check(len(st.render_stats) == 8
          and all(s_["nonfinite"] == 0 for s_ in st.render_stats),
          "edited test views: count or non-finite pixels")
    print_edit_timer(st, timer, steps, "[seal]")

    # the edit took: student vs mapped teacher, unedited teacher vs the same
    cli = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--H", "256", "--W", "256", "--workspace", ws])
    val = load_dataset(cli, "val", device=dev)
    edit_gates(dev, st, teacher_ckpt, val, "[seal]")

    forced = hack_bitfield(torch.zeros_like(st.state.occ.bitfield),
                           st._hack_bytes, st._hack_masks)
    bits = st.state.occ.bitfield
    held = int((((bits & forced) == forced) & (forced != 0)).sum())
    n_forced = int((forced != 0).sum())
    print(f"[seal] after restore_grid {held} of {n_forced} force-filled "
          f"bytes are still fully set")
    check(n_forced > 0 and held < n_forced,
          "restore_grid left the force-fill in the bitfield")

    # the edited test views through K4
    test = load_dataset(cli, "test", device=dev)
    off = [st.render_image(p, test.h, test.w) for p in test.poses]
    st.eval_opts = dataclasses.replace(st.eval_opts, tl_kernel=True)
    before = len(st.render_stats)
    on = [st.render_image(p, test.h, test.w) for p in test.poses]
    st.eval_opts = dataclasses.replace(st.eval_opts, tl_kernel=False)
    d_img = max(float((a[0] - b[0]).abs().max()) for a, b in zip(on, off))
    d_dep = max(float((a[1] - b[1]).abs().max()) for a, b in zip(on, off))
    n_chunks = -(-test.h * test.w // st.cfg.eval_chunk)
    expect = len(test) * n_chunks + sum(
        s_["chunks_rendered"] for s_ in st.render_stats[before:])
    k4 = ladder_plan.launches
    print(f"[seal] edited test views with K4 vs without: image max diff "
          f"{d_img:.3e}, depth max diff {d_dep:.3e}; K4 launches {k4}")
    check(d_img <= 1e-5 and d_dep <= 1e-4,
          f"edited views differ with K4: {d_img} {d_dep}")
    check(k4 > 0 and k4 == expect, f"K4 launches {k4} != {expect}")
    return fwd, bwd, k4, seal_case, head, adam_n


def edit_outputs(st, ws, epochs, head):
    """The files and the stage-1 result of one edit through the CLI or the
    API: timer.json, seal.json and options.json written, the pretrain loss
    falling over `epochs` epochs, the proxied dataset carrying depths ->
    the timer dict."""
    for name in ("timer.json", "seal.json", "options.json"):
        check(os.path.exists(os.path.join(ws, name)), f"{name} not written")
    with open(os.path.join(ws, "timer.json")) as f:
        timer = json.load(f)
    losses = st.pretrain_losses
    print(f"{head} pretrain loss {losses[0]:.5f} -> {losses[-1]:.5f} over "
          f"{len(losses)} epochs")
    check(len(losses) == epochs and losses[-1] < losses[0]
          and np.all(np.isfinite(losses)), f"pretrain losses {losses}")
    ds = st.dataset
    check(ds.depths is not None and ds.images.dtype == np.uint8
          and float(ds.depths.max()) > 0, "the proxied dataset has no depths")
    return timer


def edit_launch_check(st, epochs, steps, fwd, bwd, tag):
    """K1's launches over one edit against its field calls: the backward
    once per pretrain batch and finetune step; the forward once per teacher
    query chunk (2^18 shell points), pretrain batch, finetune step,
    grid-update chunk (a full update 16 a cascade, a partial one 3; the
    hacked start and restore_grid are full), proxy chunk rendered and
    edited test-view chunk rendered. -> the counts of teacher query chunks,
    pretrain batches, proxy chunks and test chunks."""
    shells = {k: (int(v["weight"].sum()), v["n_batches"])
              for k, v in st.pretrain_data.items()}
    queries = sum(-(-n // 2**18) for n, _ in shells.values())
    batches = epochs * sum(nb for _, nb in shells.values())
    grid = st.train_stats["grid_updates"]
    n_full = sum(1 for full, _ in grid if full) + 2   # hacked start, restore
    n_part = sum(1 for full, _ in grid if not full)
    cas = st.opts.cascades
    ps = st.proxy_stats
    proxy_chunks = ps["chunks_grid"] + ps["chunks_packed"]
    test_chunks = sum(s_["chunks_rendered"] for s_ in st.render_stats)
    field_calls = (queries + batches + steps + cas * (16 * n_full + 3 * n_part)
                   + proxy_chunks + test_chunks)
    print(f"{tag} shells (points, batches) {shells}; K1 launches: backward "
          f"{bwd} ({batches} pretrain batches + {steps} finetune steps), "
          f"forward {fwd} (field calls {field_calls}: {queries} teacher "
          f"queries, {batches} + {steps} steps, {n_full}x{16 * cas} + "
          f"{n_part}x{3 * cas} grid-update chunks, {proxy_chunks} proxy "
          f"chunks of {ps}, {test_chunks} test chunks)")
    check(bwd == batches + steps, f"{tag} K1 bwd launches {bwd} != "
                                  f"{batches + steps}")
    check(fwd == field_calls, f"{tag} K1 fwd launches {fwd} != field calls "
                              f"{field_calls}")
    return {"queries": queries, "batches": batches, "proxy": proxy_chunks,
            "test": test_chunks}


def print_edit_timer(st, timer, steps, tag):
    """The stage seconds of timer.json and each stage's share of them."""
    wall = (timer["pretrain_init"] + timer["pretraining_total"]
            + timer["proxy_dataset"] + timer["training_total"])
    ts = st.train_stats
    print(f"{tag} init {timer['pretrain_init']:.3f} s, pretrain "
          f"{timer['pretraining_avg']:.4f} s per epoch "
          f"({timer['pretraining_total']:.2f} s), proxy "
          f"{timer['proxy_dataset']:.3f} s for {st.proxy_stats['views']} "
          f"views, finetune {timer['training_total']:.2f} s "
          f"({ts['window_s'] / ts['window_steps'] * 1e3:.3f} ms per step "
          f"after the first {steps - ts['window_steps']}, grid updates "
          f"included; final flat_frac {st.opts.flat_frac}); shares of "
          f"{wall:.2f} s: init {timer['pretrain_init'] / wall:.3f} pretrain "
          f"{timer['pretraining_total'] / wall:.3f} proxy "
          f"{timer['proxy_dataset'] / wall:.3f} finetune "
          f"{timer['training_total'] / wall:.3f}")


def edit_gates(dev, st, teacher_ckpt, val, tag, gate=True,
               plain_teacher=None):
    """The edit took: on the 4 poses of `val`, the student against the
    mapped teacher reads >= MIN_EDIT_PSNR; on the pixels the edit changes
    (those where the mapped teacher's view differs from the unedited
    teacher's by > 0.1; at least 100) the student is closer to the mapped
    teacher than the unedited teacher is. gate=False prints the same
    numbers and checks only that the student's PSNR is finite.
    plain_teacher: the unedited teacher's trainer, loaded; by default an NGP
    one loads `teacher_ckpt`. -> (student PSNR, edited pixels)."""
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.train.trainer import Trainer

    if plain_teacher is None:
        plain_teacher = Trainer(ngp, st.fcfg, st.opts, st.cfg, dataset=val,
                                device=dev, name="teacher_unedited")
        plain_teacher.load_checkpoint(teacher_ckpt)
    ps_student, ps_teacher = [], []
    n_px, se_student, se_teacher = 0, 0.0, 0.0
    for pose in val.poses[:4]:
        target, _ = st.render_teacher_view(pose, val.h, val.w)
        edited = st.render_image(pose, val.h, val.w)[0]
        unedited = plain_teacher.render_image(pose, val.h, val.w)[0]
        ps_student.append(psnr(edited, target))
        ps_teacher.append(psnr(unedited, target))
        mask = (target - unedited).abs().amax(-1) > 0.1
        n_px += int(mask.sum())
        se_student += float(((edited - target) ** 2)[mask].sum())
        se_teacher += float(((unedited - target) ** 2)[mask].sum())
    edit_student = edit_teacher = float("nan")   # no pixel changed
    if n_px:
        edit_student = -10.0 * np.log10(se_student / (3 * n_px))
        edit_teacher = -10.0 * np.log10(se_teacher / (3 * n_px))
    print(f"{tag} {len(ps_student)} val poses at {val.h}x{val.w} against "
          f"the mapped teacher: student "
          f"{np.mean(ps_student):.2f} dB {[round(v, 2) for v in ps_student]}, "
          f"unedited teacher {np.mean(ps_teacher):.2f} dB "
          f"{[round(v, 2) for v in ps_teacher]}; on the {n_px} pixels the "
          f"edit changes: student {edit_student:.2f} dB, unedited teacher "
          f"{edit_teacher:.2f} dB")
    check(np.isfinite(np.mean(ps_student)), f"{tag} student PSNR "
                                            f"{ps_student}")
    if gate:
        check(n_px >= 100, f"{tag} the edit changes only {n_px} pixels of "
                           f"4 val views")
        check(np.mean(ps_student) >= MIN_EDIT_PSNR,
              f"{tag} student PSNR {np.mean(ps_student):.2f} < "
              f"{MIN_EDIT_PSNR}")
        check(edit_teacher < edit_student,
              f"{tag} on the edited pixels the unedited teacher is as close "
              f"to the target as the student: the edit did not take")
    return float(np.mean(ps_student)), n_px


# phase 20's edits of the procedural scene (data/synthetic.py): a 9x9 line
# stroke on the box's top face (y = -0.27), a curve stroke on ball 1's cap
# around its +y pole, an anchor pulled up from that pole. An anchor of
# radius 0.08 pulled by 0.12 changes too few pixels of the 4 val views (its
# spike is nearly the white of the background) for the edit gate's 100.
BRUSH = {"normal": [0.0, 1.0, 0.0], "brushPressure": 0.05, "brushDepth": 1.0,
         "attenuationDistance": 0.05, "attenuationMode": "linear"}
BOX_TOP = dict(x=(-0.35, -0.05), z=(-0.40, -0.15), y=-0.27)
B2_EDIT_EPOCHS, B2_EDIT_STEPS = 50, 150     # phase 20d's API edit
B2_CLI_EPOCHS, B2_CLI_STEPS = 20, 100       # phase 20d's Seal CLI at bound 2
MESH_RES = 256


def seal_tool_configs():
    """{name: seal.json dict} of phase 20's brush and anchor edits."""
    gx, gz = np.meshgrid(np.linspace(*BOX_TOP["x"], 9),
                         np.linspace(*BOX_TOP["z"], 9))
    line = np.stack([gx, np.full_like(gx, BOX_TOP["y"]), gz], -1)
    rng = np.random.default_rng(0)
    theta = np.arccos(rng.uniform(np.cos(0.6), 1.0, 160))
    phi = rng.uniform(0, 2 * np.pi, 160)
    cap = np.array([0.35, 0.1, 0.0]) + 0.22 * np.stack(
        [np.sin(theta) * np.cos(phi), np.cos(theta),
         np.sin(theta) * np.sin(phi)], -1)
    pole = cap[np.argsort(-cap[:, 1])[:8]]
    return {
        "brush_line": dict(type="brush", raw=line.reshape(-1, 3).tolist(),
                           brushType="line", **BRUSH),
        "brush_curve": dict(type="brush", raw=cap.tolist(),
                            brushType="curve", **BRUSH),
        "anchor": dict(type="anchor", raw=pole.tolist(),
                       translation=[0.0, 0.25, 0.0], radius=0.12),
    }


def write_seal_config(ws, config) -> str:
    """A directory under ws holding `config` as its seal.json."""
    os.makedirs(ws, exist_ok=True)
    with open(os.path.join(ws, "seal.json"), "w") as f:
        json.dump(config, f, indent=1)
    return ws


@contextlib.contextmanager
def capture_k1_fwd():
    """Record the arguments (cfg, table, x, valid) of K1's forward launches
    while the block runs: yields a list that holds the last one."""
    from seal3d_tpu_torch.ops import halo_encode as k1

    seen, fwd = [], k1._launch_fwd

    def rec_fwd(table, x, valid, cfg, *rest):
        seen[:] = [dict(cfg=cfg, table=table.detach(), x=x, valid=valid)]
        return fwd(table, x, valid, cfg, *rest)

    k1._launch_fwd = rec_fwd
    try:
        yield seen
    finally:
        k1._launch_fwd = fwd


def busiest_proxy_chunk(dev, st, tag):
    """The proxy chunk of the most kept samples over the edit's training
    views, rendered once more through the mapped teacher: its peak device
    memory, and K1's forward on its mapped, packed positions against the
    plain version (<= TOL). These launches count for no path. -> (max abs
    error, peak MiB)."""
    from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_plain
    from seal3d_tpu_torch.render.renderer import render_rays

    h, w = st.dataset.h, st.dataset.w
    chunk = min(st.cfg.eval_chunk, h * w)
    best = (-1, None, None)
    for pose in st.dataset.poses:
        ro, rd, _ = st._teacher_view_setup(pose, h, w, chunk)
        for ci in range(ro.shape[0]):
            need = int(st._teacher_demand(st.teacher_bitfield, ro[ci], rd[ci]))
            if need > best[0]:
                best = (need, ro[ci], rd[ci])
    need, ro, rd = best
    frac = st._covering_frac(float(need), chunk)
    opts = dataclasses.replace(st._teacher_opts, flat_frac=frac)
    bg = torch.ones((chunk, 3), device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with capture_k1_fwd() as seen:
        out = render_rays(st.teacher_params, st.teacher_field, st.fcfg,
                          st.teacher_bitfield, ro, rd, opts, bg_color=bg)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    check(bool(torch.isfinite(out["image"]).all()), f"{tag} busiest chunk")
    check(len(seen) == 1, f"{tag} the busiest chunk launched no K1")
    case = seen[0]
    cfg, t, x, v = (case[k] for k in ("cfg", "table", "x", "valid"))
    with torch.no_grad():
        err = float((halo_encode(t, x, v, cfg)
                     - halo_encode_plain(t, x, v, cfg)).abs().max())
    n_valid = x.shape[0] if v is None else int(v.sum())
    print(f"{tag} busiest proxy chunk ({chunk} rays, {need} kept samples, "
          f"flat_frac {frac}): rendered in {sec:.4f} s (host clock, synced), "
          f"peak device memory {peak:.1f} MiB above the {base / 2**20:.1f} "
          f"MiB held; K1 fwd on its mapped samples (M={x.shape[0]}, "
          f"{n_valid} valid) max_abs_err {err:.3e}")
    check(err <= TOL, f"{tag} K1 fwd on the busiest proxy chunk: {err}")
    return err, peak


def seal_tools_phase(dev, ws, teacher_ckpt, wide_ckpt, b2_cli_ckpt):
    """Phase 20, the Seal tools: (a)-(c) the brush (line, curve) and anchor
    edits through main_SealNeRF at bound 1 on phase 7's teacher, each with
    phase 14's recipe (TOOL_STEPS finetune steps) and gates; (d) a bbox
    edit at bound 2 through the
    SealTrainer API on phase 18a's WideSyntheticScene state, moving its
    cascade-1 satellite ball, then the Seal CLI at its default bound and
    dt_gamma on phase 18d's checkpoint; (e) the --dense_render Seal CLI at
    a tiny size; (f) extract_geometry at 256^3 on phase 7's state and on
    edit (a)'s student. -> (K1 forward launches, backward launches, max
    forward error)."""
    from seal3d_tpu_torch import main_SealNeRF
    from seal3d_tpu_torch.config import common_parser, load_dataset

    configs = seal_tool_configs()
    total_f = total_b = 0
    err = 0.0
    cli = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--H", "256", "--W", "256", "--workspace", ws])
    val = load_dataset(cli, "val", device=dev)
    students = {}
    for name, config in configs.items():
        tag = f"[tools {name}]"
        run_ws = os.path.join(ws, name)
        cfg_dir = write_seal_config(os.path.join(ws, f"{name}_config"),
                                    config)
        argv = O_ARGV + ["--H", "256", "--W", "256", "--seal_config",
                         cfg_dir, "--teacher_ckpt", teacher_ckpt,
                         "--pretraining_epochs",
                         str(SEAL_EPOCHS), "--extra_epochs",
                         str(TOOL_STEPS), "--workspace", run_ws]
        t0 = time.perf_counter()
        st, fwd, bwd = k1_counted(lambda: main_SealNeRF.main(argv))
        sec = time.perf_counter() - t0
        check(st.mapper.kind == config["type"], f"{tag} mapper {st.mapper.kind}")
        timer = edit_outputs(st, run_ws, SEAL_EPOCHS,
                             f"{tag} main_SealNeRF at 256x256: {sec:.2f} s in "
                             f"all;")
        edit_launch_check(st, SEAL_EPOCHS,
                          TOOL_STEPS, fwd, bwd, tag)
        check(len(st.render_stats) == 8
              and all(s_["nonfinite"] == 0 for s_ in st.render_stats),
              f"{tag} edited test views: count or non-finite pixels")
        print_edit_timer(st, timer, TOOL_STEPS, tag)
        total_f, total_b = total_f + fwd, total_b + bwd
        e, _ = busiest_proxy_chunk(dev, st, tag)
        err = max(err, e)
        edit_gates(dev, st, teacher_ckpt, val, tag)
        students[name] = st

    f, b, e = bound2_edit_phase(dev, ws, wide_ckpt, b2_cli_ckpt,
                                configs["brush_line"])
    total_f, total_b, err = total_f + f, total_b + b, max(err, e)
    f, b = dense_edit_phase(ws, configs["brush_line"])
    total_f, total_b = total_f + f, total_b + b
    total_f += mesh_phase(dev, ws, teacher_ckpt, students["brush_line"])
    return total_f, total_b, err


def bound2_edit_phase(dev, ws, wide_ckpt, b2_cli_ckpt, brush):
    """Phase 20d: the bbox edit of WideSyntheticScene's satellite ball at
    (1.45, 0.1, 0.2) (on cascade 1), moved up by 0.3, through the
    SealTrainer API at phase 18a's recipe; its force-filled cells on
    cascade 1 set in the student's bitfield while it trains, >= 90% of the
    moved ball's core cells occupied after restore_grid (the field's
    interior is free where no view or shell pins it), phase 14's gates on
    4 held-out
    views. Then main_SealNeRF at the CLI's default bound and dt_gamma with
    `brush` on phase 18d's checkpoint: a finite student PSNR. -> (K1
    forward launches, backward launches, max forward error)."""
    from seal3d_tpu_torch import main_SealNeRF
    from seal3d_tpu_torch.config import common_parser, load_dataset
    from seal3d_tpu_torch.data.synthetic import WideSyntheticScene
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.ops.bitfield import GRID_CELLS
    from seal3d_tpu_torch.seal.mappers import build_mapper
    from seal3d_tpu_torch.seal.renderer import force_fill_cells
    from seal3d_tpu_torch.seal.trainer import PretrainConfig, SealTrainer
    from seal3d_tpu_torch.train.trainer import Trainer

    tag = "[tools bound2]"
    scene = WideSyntheticScene()
    ds = scene.make_dataset(n_views=12, h=192, w=192, seed=0, device=dev)
    val = scene.make_dataset(n_views=4, h=192, w=192, seed=1, device=dev)
    fcfg, opts, tcfg = wide_bound2_recipe()
    teacher = Trainer(ngp, fcfg, opts, tcfg, dataset=ds, device=dev)
    teacher.load_checkpoint(wide_ckpt)
    g = np.linspace(-0.3, 0.3, 3)
    raw = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3) \
        + [1.45, 0.1, 0.2]
    move = np.eye(4)
    move[1, 3] = 0.3
    run_ws = os.path.join(ws, "bound2_edit")
    mapper = build_mapper({"type": "bbox", "raw": raw.tolist(),
                           "transform": move.tolist(),
                           "scale": [1.0, 1.0, 1.0]}, workspace=run_ws)
    st = SealTrainer(ngp, fcfg, opts,
                     dataclasses.replace(tcfg, workspace=run_ws), mapper,
                     teacher_params=teacher.state.params,
                     teacher_bitfield=teacher.state.occ.bitfield, dataset=ds,
                     seed=3, device=dev)
    st.init_state()
    # the student's bitfield as it trains (the hacked one) is read just
    # before restore_grid drops the force-fill
    hacked, restore = {}, st.restore_grid

    def read_then_restore():
        hacked["bits"] = st.state.occ.bitfield.clone()
        restore()

    st.restore_grid = read_then_restore
    pcfg = PretrainConfig(epochs=B2_EDIT_EPOCHS, lr=0.05)
    t0 = time.perf_counter()
    timer, fwd, bwd = k1_counted(
        lambda: st.train_edit(pcfg, finetune_steps=B2_EDIT_STEPS, log=False))
    sec = time.perf_counter() - t0
    edit_outputs(st, run_ws, B2_EDIT_EPOCHS,
                 f"{tag} SealTrainer.train_edit at 192x192, bound 2 "
                 f"({opts.cascades} cascades): {sec:.2f} s in all;")
    edit_launch_check(st, B2_EDIT_EPOCHS, B2_EDIT_STEPS, fwd, bwd, tag)
    print_edit_timer(st, timer, B2_EDIT_STEPS, tag)

    cells = force_fill_cells(mapper.force_fill_bound, 2, 2.0)
    c1 = cells[cells >= GRID_CELLS]
    core = force_fill_cells(np.array([[[1.37, 0.32, 0.12],
                                       [1.53, 0.48, 0.28]]]), 2, 2.0)
    core = core[core >= GRID_CELLS]

    def held(bits, ids):
        b = bits.cpu().numpy()
        return int(((b[ids >> 3] >> (ids & 7)) & 1).sum())

    print(f"{tag} cascade-1 force-filled cells set in the student's "
          f"bitfield while it trained: {held(hacked['bits'], c1)} of "
          f"{len(c1)}; the moved ball's core after restore_grid: "
          f"{held(st.state.occ.bitfield, core)} of {len(core)} cells")
    check(len(c1) > 0 and held(hacked["bits"], c1) == len(c1),
          f"{tag} the force-fill on cascade 1 is not in the bitfield")
    check(len(core) > 0 and held(st.state.occ.bitfield, core)
          >= 0.9 * len(core),
          f"{tag} the moved ball's core is not occupied after restore_grid")
    e, _ = busiest_proxy_chunk(dev, st, tag)
    edit_gates(dev, st, wide_ckpt, val, tag)
    total_f, total_b = fwd, bwd
    del st, teacher
    torch.cuda.empty_cache()

    tag = "[tools bound2 cli]"
    run_ws = os.path.join(ws, "bound2_cli_edit")
    argv = ["synthetic", "-O", "--lr", "3e-3", "--H", "128", "--W", "128",
            "--device", "cuda", "--seal_config",
            write_seal_config(os.path.join(ws, "bound2_cli_config"), brush),
            "--teacher_ckpt", b2_cli_ckpt, "--pretraining_epochs",
            str(B2_CLI_EPOCHS), "--extra_epochs", str(B2_CLI_STEPS),
            "--workspace", run_ws]
    t0 = time.perf_counter()
    cli_st, fwd, bwd = k1_counted(lambda: main_SealNeRF.main(argv))
    sec = time.perf_counter() - t0
    check(cli_st.opts.bound == 2.0 and cli_st.opts.dt_gamma == 1 / 128
          and cli_st.opts.cascades == 2, f"{tag} the CLI's defaults moved")
    timer = edit_outputs(cli_st, run_ws, B2_CLI_EPOCHS,
                         f"{tag} main_SealNeRF -O --lr 3e-3 at 128x128, "
                         f"bound {cli_st.opts.bound}, dt_gamma "
                         f"{cli_st.opts.dt_gamma}: {sec:.2f} s in all;")
    edit_launch_check(cli_st, B2_CLI_EPOCHS, B2_CLI_STEPS, fwd, bwd, tag)
    print_edit_timer(cli_st, timer, B2_CLI_STEPS, tag)
    args = common_parser("chip_smoke").parse_args(
        ["synthetic", "--H", "128", "--W", "128", "--workspace", run_ws])
    edit_gates(dev, cli_st, b2_cli_ckpt, load_dataset(args, "val", device=dev),
               tag, gate=False)
    return total_f + fwd, total_b + bwd, e


def dense_edit_phase(ws, brush):
    """Phase 20e: main_SealNeRF with --dense_render at the CPU test's tiny
    size (24x24, T=2^12), the teacher trained 48 steps through the dense
    oracle in the same call: it exits and writes both checkpoints. -> (K1
    forward launches, backward launches)."""
    from seal3d_tpu_torch import main_SealNeRF

    tag = "[tools dense]"
    run_ws, tws = os.path.join(ws, "dense_edit"), os.path.join(ws, "dense_t")
    argv = ["synthetic", "-O", "--bound", "1.0", "--dt_gamma", "0",
            "--min_near", "0.05", "--max_steps", "512", "--H", "24", "--W",
            "24", "--num_rays", "256", "--log2_hashmap_size", "12",
            "--device", "cuda", "--dense_render", "--seal_config",
            write_seal_config(os.path.join(ws, "dense_config"), brush),
            "--teacher_ckpt", "scratch", "--train_teacher", "48",
            "--teacher_workspace", tws, "--pretraining_epochs", "6",
            "--pretraining_batch_size", "8192",
            "--pretraining_local_point_step", "0.04",
            "--pretraining_surrounding_point_step", "0.08",
            "--pretraining_global_point_step", "0.2", "--extra_epochs", "32",
            "--workspace", run_ws]
    t0 = time.perf_counter()
    st, fwd, bwd = k1_counted(lambda: main_SealNeRF.main(argv))
    sec = time.perf_counter() - t0
    written = [os.path.exists(os.path.join(d, "checkpoints", f))
               for d, f in ((tws, "sealnerf_teacher_step0000048.npz"),
                            (run_ws, "sealnerf_student_step0000032.npz"))]
    print(f"{tag} main_SealNeRF --dense_render at 24x24 (teacher 48 dense "
          f"steps, student 6 epochs + 32 steps): {sec:.2f} s; checkpoints "
          f"written {written}; K1 launches forward {fwd}, backward {bwd}")
    check(all(written) and not st.use_dense, f"{tag} checkpoints {written}")
    check(fwd > 0 and bwd > 0, f"{tag} K1 launches {fwd} / {bwd}")
    return fwd, bwd


def mesh_phase(dev, ws, teacher_ckpt, student):
    """Phase 20f: extract_geometry at MESH_RES^3 (2^16-point chunks) as
    main_nerf --save_mesh runs it on phase 7's state (its EMA params) and as
    main_SealNeRF runs it on edit (a)'s student (its params), at the CLIs'
    threshold min(10, mean density): K1 launched once per chunk, every
    vertex inside the bound, and the box's top face inside the stroke's
    interior (the median height of the vertices there below y = 0, above
    which the torus passes) lifted in the edited mesh by at least half the
    brush's pressure. The iso level (~1) lies ~0.07 outside the scene's
    soft box (density 60 sigmoid(-60 d)), so both faces sit above y = -0.27.
    -> K1 forward launches."""
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.runtime.mesh_export import (extract_geometry,
                                                      save_mesh)
    from seal3d_tpu_torch.train.trainer import Trainer

    teacher = Trainer(ngp, student.fcfg, student.opts, student.cfg,
                      device=dev, name="mesh_teacher")
    teacher.load_checkpoint(teacher_ckpt)
    chunks = MESH_RES**3 // 2**16
    total, face = 0, {}
    for name, params, occ in (
            ("teacher", teacher.state.ema_params, teacher.state.occ),
            ("brush_line", student.state.params, student.state.occ)):
        thr = min(10.0, float(occ.mean_density))
        t0 = time.perf_counter()
        (verts, tris), fwd, _ = k1_counted(lambda: extract_geometry(
            lambda x: ngp.density(params, student.fcfg, x)["sigma"],
            bound=1.0, resolution=MESH_RES, threshold=thr, device=dev))
        sec = time.perf_counter() - t0
        save_mesh(os.path.join(ws, "meshes", f"{name}.ply"), verts, tris)
        x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
        top = ((x > BOX_TOP["x"][0] + 0.05) & (x < BOX_TOP["x"][1] - 0.05)
               & (z > BOX_TOP["z"][0] + 0.05) & (z < BOX_TOP["z"][1] - 0.05)
               & (y > -0.45) & (y < 0.0))
        face[name] = float(np.median(y[top])) if top.any() else float("nan")
        print(f"[tools mesh] {name}: {MESH_RES}^3 lattice at threshold "
              f"{thr:.4f}: {len(verts)} vertices, {len(tris)} triangles in "
              f"{sec:.2f} s (host clock: {chunks} density chunks on the card "
              f"and the C++ marching tetrahedra); K1 launches {fwd}; the "
              f"box's top face inside the stroke: {int(top.sum())} vertices "
              f"at median y {face[name]:.4f}")
        check(fwd == chunks, f"mesh {name}: K1 launches {fwd} != {chunks}")
        check(len(verts) > 1000 and len(tris) > 1000,
              f"mesh {name}: {len(verts)} vertices")
        check(bool((np.abs(verts) <= 1.0 + 1e-6).all()),
              f"mesh {name}: a vertex lies outside the bound")
        total += fwd
    lift = face["brush_line"] - face["teacher"]
    print(f"[tools mesh] the stroke lifted the face by {lift:.4f} (the "
          f"brush's pressure {BRUSH['brushPressure']})")
    check(lift >= 0.5 * BRUSH["brushPressure"],
          f"the brush did not lift the mesh's face: {face}")
    return total


# phase 21a's iterations and upsamples (128^3 -> 300^3, log-spaced; the last
# after the shrink at 1000, so the final shape is n_to_reso of the shrunk
# box), cut from 1500 / (300, 500, 700, 900, 1100) when phase 23 came
TF_STEPS = 1200
TF_UPSAMPLE = (250, 450, 650, 850, 1100)
TF_SEAL_EPOCHS, TF_SEAL_STEPS = 10, 120     # phase 21c, cut from 50 / 500
TF_VOXELS = 300**3                          # the CLI's --resolution1 cubed
MIN_TF_PSNR = 20.0      # phase 21a, 4 val views at 256x256
CP_STEPS, CP_UPSAMPLE, MIN_CP_GAIN_DB = 300, 150, 2.0   # phase 21b


def kernel_counters():
    """Every kernel wrapper of the table, by name (their launch counts)."""
    from seal3d_tpu_torch.ops import (adam, halo_encode, hash_encode, ladder,
                                      lookup, tensorf_vm)

    return {"adam_ema": adam.adam_ema,
            "halo_encode": halo_encode.halo_encode,
            "halo_encode_bwd": halo_encode.halo_encode_bwd,
            "halo_encode_levels": halo_encode.halo_encode_levels,
            "hash_encode": hash_encode.hash_encode,
            "hash_encode_bwd": hash_encode.hash_encode_bwd,
            "ladder_plan": ladder.ladder_plan,
            "multilevel_lookup": lookup.multilevel_lookup,
            "multilevel_lookup_bwd": lookup.multilevel_lookup_bwd,
            "vm_features": tensorf_vm.vm_features,
            "vm_features_bwd": tensorf_vm.vm_features_bwd}


def tensorf_phase(dev, ws):
    """Phase 21: (a) TensoRF VM through main_tensoRF at full width, (b) CP
    at 128x128, (c) main_SealTensoRF on (a)'s teacher, (d) the VM lookups'
    kernel pair on a batch of (c). Of the table's kernels only that pair
    runs, in (a) and (c), and the fused Adam and EMA, once a pretraining
    batch of (c). -> the pair's two kernel rows, and the fused Adam and
    EMA's launches in (c)."""
    from seal3d_tpu_torch import main_SealTensoRF, main_tensoRF
    from seal3d_tpu_torch.config import common_parser, load_dataset
    from seal3d_tpu_torch.models import tensorf
    from seal3d_tpu_torch.train import checkpoint as ckpt_io
    from seal3d_tpu_torch.train.tensorf_trainer import TensoRFTrainer

    counters = reset_counters()

    # ---- (a) VM at the CLI's full width
    ws_a = os.path.join(ws, "vm")
    argv = O_ARGV + ["--iters", str(TF_STEPS), "--H", "256", "--W", "256",
                     "--upsample_model_steps", *map(str, TF_UPSAMPLE),
                     "--workspace", ws_a]
    t0 = time.perf_counter()
    tr = main_tensoRF.main(argv)
    torch.cuda.synchronize()
    print(f"[tensorf] main_tensoRF VM {TF_STEPS} steps at 256x256 "
          f"(resolution 128^3 -> 300^3, upsamples at {TF_UPSAMPLE}, shrink "
          f"at {tr.shrink_step}): {time.perf_counter() - t0:.2f} s in all "
          f"(data, training, eval, 8 test renders)")
    for seg in tr.segment_stats:
        ms = (seg["window_s"] / seg["window_steps"] * 1e3
              if seg["window_steps"] else float("nan"))
        print(f"[tensorf] steps {seg['step']}-{seg['step'] + seg['steps']} "
              f"at resolution {seg['resolution']}: {ms:.3f} ms per step "
              f"(CUDA events over the {seg['window_steps']} steps after "
              f"the first {seg['steps'] - seg['window_steps']}, grid "
              f"updates included)")
    aabb = tr.state.params["aabb"].cpu().numpy()
    final = ckpt_io.tensorf_resolution(tr.state.params)
    want = tensorf.n_to_reso(TF_VOXELS, aabb)
    factors = ("sigma_mat", "sigma_vec", "color_mat", "color_vec")
    shapes = {k: tuple(v.shape) for k, v in
              ckpt_io.flatten_tree(tr.state.params)
              if k.split("/")[0] in factors}
    print(f"[tensorf] shrunk aabb {np.round(aabb, 4).tolist()}; final "
          f"resolution {final} (n_to_reso(300^3, aabb) = {want}); factor "
          f"shapes {shapes}")
    check(final == want, f"final TensoRF resolution {final} != {want}")
    check(bool((np.abs(aabb) < tr.fcfg.bound).any()),
          f"the shrink left the box whole: {aabb}")
    psnr_a = tr.eval_history[-1]["psnr"]
    print(f"[tensorf] val PSNR {psnr_a:.2f} dB over 4 views at 256x256")
    check(psnr_a >= MIN_TF_PSNR, f"TensoRF val PSNR {psnr_a:.2f} < "
                                 f"{MIN_TF_PSNR}")
    vm_a = tuple(read_counters(counters)[k]
                 for k in ("vm_features", "vm_features_bwd"))
    print(f"[tensorf] VM lookups' kernel launches in (a) (forward, "
          f"backward): {vm_a}")

    cli800 = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--H", "800", "--W", "800", "--workspace", ws_a])
    test800 = load_dataset(cli800, "test", device=dev)
    train_ds = tr.dataset
    tr.attach_dataset(test800)      # the 800x800 views' intrinsics
    secs, peaks, imgs = [], [], []
    for pose in test800.poses[:2]:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img, _ = tr.render_image(pose, test800.h, test800.w)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append((torch.cuda.max_memory_allocated() - held) / 2**20)
        imgs.append(img)
    rs = tr.render_stats[-1]
    print(f"[tensorf] 800x800 test views: {[round(v, 3) for v in secs]} s "
          f"per view, peak {[round(v, 1) for v in peaks]} MiB above what is "
          f"held ({rs['chunks_rendered']} chunks of {tr.cfg.eval_chunk} "
          f"rays rendered, {rs['chunks_skipped']} skipped, {rs['samples']} "
          f"samples)")
    check(all(torch.isfinite(i).all() for i in imgs), "non-finite 800x800")

    ckpt = os.path.join(ws_a, "checkpoints", f"tensorf_step{TF_STEPS:07d}.npz")
    fresh = TensoRFTrainer(tr.fcfg, tr.opts, tr.cfg, dataset=test800,
                           device=dev, name="tensorf_reload",
                           upsample_steps=(), shrink_step=None)
    fresh.init_state()
    fresh.load_checkpoint(ckpt)
    again, _ = fresh.render_image(test800.poses[0], test800.h, test800.w)
    same = torch.equal(again, imgs[0])
    print(f"[tensorf] {os.path.basename(ckpt)} reloaded into a fresh "
          f"TensoRFTrainer at {ckpt_io.tensorf_resolution(fresh.state.params)}"
          f": test view 0 {'bit-identical' if same else 'DIFFERS'} "
          f"(max diff {float((again - imgs[0]).abs().max()):.3e})")
    check(same, "the reloaded TensoRF state renders another image")
    # a few more steps (on the training views), profiled; after the reload
    # check, which needs the state the CLI saved
    tr.attach_dataset(train_ds)
    prof = profile_steps(tr)
    fwd_ms = bwd_ms = 0.0
    from torch.autograd import DeviceType
    for e in prof["events"]:
        if e.device_type != DeviceType.CPU:
            continue
        if e.key == "tensorf.sample":
            fwd_ms += e.device_time_total / 1e3 / prof["n"]
        elif e.key == "tensorf.scatter":
            bwd_ms += e.device_time_total / 1e3 / prof["n"]
    share = (fwd_ms + bwd_ms) / max(prof["busy_ms"], 1e-9)
    print(f"[tensorf] one step at {final}: {prof['launches']:.0f} launches, "
          f"device busy {prof['busy_ms']:.3f} ms; lookups: forward "
          f"(tensorf.sample) {fwd_ms:.3f} ms, backward (tensorf.scatter) "
          f"{bwd_ms:.3f} ms of device time, {share:.3f} of the "
          f"busy time")
    check(fwd_ms > 0 and bwd_ms > 0, "the profiler saw no lookup on the card")
    del fresh, test800, imgs, again
    vm_fcfg = tr.fcfg
    del tr
    torch.cuda.empty_cache()

    # ---- (b) CP at 128x128
    ws_b = os.path.join(ws, "cp")
    argv = O_ARGV + ["--cp", "--iters", str(CP_STEPS), "--H", "128", "--W",
                     "128", "--upsample_model_steps", str(CP_UPSAMPLE),
                     "--workspace", ws_b]
    t0 = time.perf_counter()
    cp = main_tensoRF.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli128 = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--H", "128", "--W", "128"])
    val128 = load_dataset(cli128, "val", device=dev)
    untrained = TensoRFTrainer(cp.fcfg, cp.opts, dataclasses.replace(
        cp.cfg, workspace=None), dataset=val128, device=dev,
        upsample_steps=(), shrink_step=None)
    untrained.init_state()
    untrained.update_grid(full=True)
    psnr0 = untrained.evaluate(dataset=val128)
    psnr_b = cp.eval_history[-1]["psnr"]
    print(f"[tensorf cp] main_tensoRF --cp {CP_STEPS} steps at 128x128 "
          f"(upsample at {CP_UPSAMPLE} to "
          f"{ckpt_io.tensorf_resolution(cp.state.params)}): {cli_s:.2f} s; "
          f"val PSNR {psnr_b:.2f} dB against {psnr0:.2f} untrained")
    check(psnr_b >= psnr0 + MIN_CP_GAIN_DB,
          f"CP val PSNR {psnr_b:.2f} not {MIN_CP_GAIN_DB} dB above the "
          f"untrained {psnr0:.2f}")
    pth = os.path.join(ws_b, "tensorf_cp.pth")
    ckpt_io.export_torch_tensorf(pth, cp.state.params, step=CP_STEPS)
    loaded, res = ckpt_io.import_torch_tensorf(pth, cp.fcfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand((2**18, 3), device=dev, generator=gen) * 2 - 1
    d = torch.nn.functional.normalize(
        torch.randn((2**18, 3), device=dev, generator=gen), dim=-1)
    with torch.no_grad():
        a = tensorf.apply(cp.state.params, cp.fcfg, x, d)
        b = tensorf.apply(loaded, cp.fcfg, x, d)
    same = all(torch.equal(u, v) for u, v in zip(a, b))
    leaves = dict(ckpt_io.flatten_tree(loaded))
    differ = [k for k, v in ckpt_io.flatten_tree(cp.state.params)
              if not torch.equal(v, leaves[k])]
    print(f"[tensorf cp] .pth round trip at {res}: apply on 2^18 points "
          f"{'bit-identical' if same else 'DIFFERS'}; leaves that differ: "
          f"{differ}")
    check(same and not differ, ".pth round trip (CP) changed the field")
    del cp, untrained, loaded, a, b
    torch.cuda.empty_cache()
    adam_ab = read_counters(counters)["adam_ema"]
    check(adam_ab == 0, f"the fused Adam and EMA ran {adam_ab} times in "
                        f"(a) and (b), which train through _apply_grads")

    # ---- (c) Seal on (a)'s teacher
    ws_c = os.path.join(ws, "seal")
    here = os.path.dirname(os.path.abspath(__file__))
    argv = O_ARGV + ["--H", "256", "--W", "256", "--seal_config",
                     os.path.join(here, "seal_config_bbox"),
                     "--teacher_ckpt", ckpt, "--pretraining_epochs",
                     str(TF_SEAL_EPOCHS), "--extra_epochs",
                     str(TF_SEAL_STEPS), "--workspace", ws_c]
    t0 = time.perf_counter()
    st = main_SealTensoRF.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    timer = edit_outputs(st, ws_c, TF_SEAL_EPOCHS,
                         f"[tensorf seal] main_SealTensoRF bbox edit at "
                         f"256x256: {cli_s:.2f} s in all;")
    print_edit_timer(st, timer, TF_SEAL_STEPS, "[tensorf seal]")
    check(len(st.render_stats) == 8
          and all(s_["nonfinite"] == 0 for s_ in st.render_stats),
          "edited TensoRF test views: count or non-finite pixels")
    cli256 = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--H", "256", "--W", "256", "--workspace", ws_c])
    val = load_dataset(cli256, "val", device=dev)
    plain = TensoRFTrainer(vm_fcfg, st.opts, st.cfg, dataset=val, device=dev,
                           name="teacher_unedited", upsample_steps=(),
                           shrink_step=None)
    plain.load_checkpoint(ckpt)
    student_db, n_px = edit_gates(dev, st, ckpt, val, "[tensorf seal]",
                                  gate=False, plain_teacher=plain)
    with np.load(ckpt) as data:
        t_aabb = data["params/aabb"]
    s_aabb = st.state.params["aabb"].cpu().numpy()
    print(f"[tensorf seal] student aabb {np.round(s_aabb, 4).tolist()} "
          f"against the teacher's {np.round(t_aabb, 4).tolist()}: drift "
          f"{np.round(s_aabb - t_aabb, 4).tolist()} (the finetune's one Adam "
          f"moves it, as in the JAX package)")
    check(student_db >= MIN_EDIT_PSNR, f"TensoRF student PSNR "
                                       f"{student_db:.2f} < {MIN_EDIT_PSNR}")
    check(n_px > 0, "the TensoRF edit changes no pixel")

    launched = read_counters(counters)
    print(f"[tensorf] kernel launches over phase 21: {launched}")
    vm = {k: launched.pop(k) for k in ("vm_features", "vm_features_bwd")}
    adam_c = launched.pop("adam_ema")
    batches = TF_SEAL_EPOCHS * sum(v["n_batches"]
                                   for v in st.pretrain_data.values())
    check(adam_c == batches, f"the fused Adam and EMA ran {adam_c} times "
                             f"in (c), not once a pretraining batch "
                             f"({batches})")
    check(vm_a[0] > 0 and vm_a[1] > 0 and all(
        v > u for v, u in zip(vm.values(), vm_a)),
        f"the VM lookups' kernels did not run in (a) and (c): (a) {vm_a}, "
        f"phase 21 {vm}")
    check(not any(launched.values()), "another kernel ran on the TensoRF "
                                      "path")
    return tensorf_vm_rows(dev, st, tuple(vm.values())), adam_c


VM_ROWS = 2**19     # phase 21d: a Seal-3D pretraining batch


def tensorf_vm_rows(dev, st, launches):
    """Phase 21d: the VM lookups' kernel pair (ops/tensorf_vm.py) on the
    first VM_ROWS rows of phase 21c's packed shells (grid order, with the
    weight-0 padding rows of the shells that end before, whose cotangents
    are zero) at the student's factors: the two calls of a pretraining
    batch (density, colour) forward
    and backward against the plain composition, device times beside the
    plain path's and one PyTorch call a corner of the same gathers
    (`index_select`) and scatters (`index_add_`), the byte bound, and the
    share of corner rows the backward sent as atomics. `launches`: the
    pair's (forward, backward) launches over phase 21's main paths. -> the
    two kernel rows."""
    from seal3d_tpu_torch.models import tensorf
    from seal3d_tpu_torch.ops import tensorf_vm as vm

    params = st.state.params
    shells = st.pretrain_data.values()
    pts = torch.cat([v["points"].reshape(-1, 3) for v in shells])[:VM_ROWS]
    wgt = torch.cat([v["weight"].reshape(-1) for v in shells])[:VM_ROWS]
    xn = tensorf._normalize(params, pts).contiguous()
    n = xn.shape[0]
    calls = [(params[f"{nm}_mat"], params[f"{nm}_vec"], nm == "sigma")
             for nm in ("sigma", "color")]
    # random cotangents, zero on the padding rows as the weighted loss's
    gen = torch.Generator(device=dev).manual_seed(21)
    cts = [torch.randn((n, 1 if red else sum(m.shape[0] for m in mats)),
                       generator=gen, device=dev) * wgt[:, None]
           for mats, _, red in calls]
    cts = [ct[:, 0].contiguous() if red else ct
           for ct, (_, _, red) in zip(cts, calls)]
    rows = [[vm._cell_rows(f) for f in mats + vecs]
            for mats, vecs, _ in calls]
    shapes = [[(m.shape[0], m.shape[1], m.shape[2], v.shape[1])
               for m, v in zip(mats, vecs)] for mats, vecs, _ in calls]

    def fwd(fn):
        return [fn(mats, vecs, xn, True, red) for mats, vecs, red in calls]

    def bwd():
        return [vm.vm_features_bwd(r, sh, xn, ct, True, red, False)[0]
                for r, sh, ct, (_, _, red) in zip(rows, shapes, cts, calls)]

    leaves = [[t.detach().clone().requires_grad_(True) for t in m + v]
              for m, v, _ in calls]
    outs = [vm.vm_features_plain(lv[:3], lv[3:], xn, True, red)
            for lv, (_, _, red) in zip(leaves, calls)]
    p_cts = [ct if red else ct.T for ct, (_, _, red) in zip(cts, calls)]

    def plain_bwd():
        return [torch.autograd.grad(o, lv, ct, retain_graph=True)
                for o, lv, ct in zip(outs, leaves, p_cts)]

    comps = vm._comps_counter(xn.device)
    with torch.no_grad():
        got, want = fwd(vm.vm_features), fwd(vm.vm_features_plain)
        c0 = int(comps)
        g_got = bwd()
        torch.cuda.synchronize()
        sent = int(comps) - c0
    g_want = plain_bwd()
    err_f = max(float((a - b).abs().max()) for a, b in zip(got, want))
    err_b = max(float((a - b).abs().max()) for gs, ws in zip(g_got, g_want)
                for a, b in zip(gs, ws))
    scale_f = max(float(b.abs().max()) for b in want)
    scale_b = max(float(b.abs().max()) for ws in g_want for b in ws)
    k_fwd = time_device_ms(lambda: fwd(vm.vm_features))
    k_bwd = time_device_ms(bwd)
    with torch.no_grad():
        p_fwd = busy_ms(lambda: fwd(vm.vm_features_plain))
    p_bwd = busy_ms(plain_bwd)

    # the same corner rows through one PyTorch call each: the gathers from
    # the [R, cells] factors, the scatters of [N, R] rows into [cells, R]
    corners = []
    for mats, vecs, _ in calls:
        for i in range(3):
            a, b = vm.MAT_IDS[i]
            r, h, w = mats[i].shape
            _, i00, _, _ = vm._plane_corners(xn[:, a], xn[:, b], h, w, True)
            _, x0, _ = vm._line_corners(xn[:, vm.VEC_IDS[i]],
                                        vecs[i].shape[1], True)
            for f, idx in ((mats[i].reshape(r, -1), i00),
                           (mats[i].reshape(r, -1), i00 + 1),
                           (mats[i].reshape(r, -1), i00 + w),
                           (mats[i].reshape(r, -1), i00 + w + 1),
                           (vecs[i], x0), (vecs[i], x0 + 1)):
                corners.append((f.detach(), idx,
                                torch.randn((n, r), generator=gen,
                                            device=dev)))
    with torch.no_grad():
        lib_fwd = busy_ms(lambda: [f.index_select(1, idx)
                                   for f, idx, _ in corners])
        lib_bwd = busy_ms(lambda: [
            torch.zeros((f.shape[1], f.shape[0]), device=dev).index_add_(
                0, idx, g) for f, idx, g in corners])

    # bytes: xn once a call, every factor once, the features out; the
    # backward reads xn and the cotangents and writes every factor's
    # cotangent (the gathers it repeats, the scratch and the transposes
    # are the design's). Operations: per rank and point, the plane's blend
    # (11), the line's (3), the product (1) and the sum or store (1);
    # backward twice that
    n_feat = sum(m.shape[0] for m in calls[1][0])
    n_params = sum(t.numel() for mats, vecs, _ in calls for t in mats + vecs)
    ranks = sum(m.shape[0] for mats, _, _ in calls for m in mats)
    fwd_bound = bound(2 * 12 * n + 4 * n_params + 4 * n * (1 + n_feat),
                      16 * ranks * n)
    bwd_bound = bound(2 * 12 * n + 4 * n * (1 + n_feat) + 8 * n_params,
                      32 * ranks * n)
    whole = 6 * n * ranks       # 4 corner rows a plane, 2 a line
    print(f"[tensorf vm] {n} shell rows (phase 21c's, grid order) at "
          f"{[tuple(m.shape) for m in calls[1][0]]}: forward {k_fwd:.4f} ms "
          f"(bound {fwd_bound['bound_ms']:.4f}, plain {p_fwd:.4f}, "
          f"index_select {lib_fwd:.4f}), backward {k_bwd:.4f} ms (bound "
          f"{bwd_bound['bound_ms']:.4f}, plain {p_bwd:.4f}, index_add_ "
          f"{lib_bwd:.4f}); max error forward {err_f:.3e} of {scale_f:.3e}, "
          f"factors' cotangents {err_b:.3e} of {scale_b:.3e}; atomics sent "
          f"{sent} of {whole} corner-row components "
          f"({100 * sent / whole:.2f}%); launches over phase 21 (forward, "
          f"backward) {launches}")
    check(err_f <= 1e-5 * scale_f and err_b <= 1e-5 * scale_b,
          f"VM kernel against the plain path: {err_f} of {scale_f}, {err_b} "
          f"of {scale_b}")
    check(0 < sent < whole, f"VM backward atomics: {sent} of {whole}")
    common = {"route": "CUDA C++, nvcc + ctypes",
              "source": "seal3d_tpu_torch/csrc/tensorf_vm.cu",
              "replaces": "none (XLA runs the JAX package's gathers and "
                          "blends on the TPU)"}
    return [dict(common, name="tensorf VM fwd", launches=launches[0],
                 max_abs_err=err_f, ms=k_fwd, plain_ms=p_fwd,
                 library_ms=lib_fwd, **fwd_bound),
            dict(common, name="tensorf VM bwd", launches=launches[1],
                 max_abs_err=err_b, ms=k_bwd, plain_ms=p_bwd,
                 library_ms=lib_bwd, **bwd_bound)]


def adam_ema_rows(dev, launches):
    """Phase 28: Adam and the EMA as one launch (ops/adam.py) at the
    benchmark cells' leaf sets, against the plain chain (three steps, bit
    for bit), timed beside it and beside the same chain as
    `torch._foreach_*` calls -> the two kernel rows, whose launches are
    `launches`: the kernel's on the main paths (phase 14's NGP edit, phase
    21c's TensoRF edit)."""
    import math

    from seal3d_tpu_torch.models import ngp, tensorf
    from seal3d_tpu_torch.ops import adam as fused
    from seal3d_tpu_torch.train.checkpoint import map_tree, map_trees
    from seal3d_tpu_torch.train.optim import Optimizer, apply_updates

    decay = 0.95
    opt = Optimizer(0.07, math.inf)

    def plain(grads, state, params, ema):
        updates, state = opt.update(grads, state)
        params = {**params, **apply_updates({k: params[k] for k in grads},
                                            updates)}
        return params, state, map_trees(
            lambda e, p: e * decay + p * (1.0 - decay), ema, params)

    rows = []
    for name, main_path, params, moved in (
            ("NGP", launches[0], ngp.init(ngp.NGPConfig(
                grid_backend="bucket"), device=dev), lambda k: "encoder" in k),
            ("TensoRF", launches[1], tensorf.init(tensorf.TensoRFConfig(
                resolution=(300, 300, 300)), device=dev),
             lambda k: k != "aabb")):
        gen = torch.Generator(device=dev).manual_seed(28)
        keys = [k for k in params if moved(k)]
        ema = map_tree(params, lambda _, t: t + 0.01 * torch.randn(
            t.shape, generator=gen, device=dev))

        def grads_of():
            return map_tree({k: params[k] for k in keys}, lambda _, t: (
                torch.randn(t.shape, generator=gen, device=dev)
                * (torch.rand(t.shape, generator=gen, device=dev) < 0.5)))

        state = opt.init({k: params[k] for k in keys})
        a = b = (params, state, ema)
        err = 0.0
        for _ in range(3):
            g = grads_of()
            a = opt.update_with_ema(g, a[1], a[0], a[2], decay)
            b = plain(g, b[1], b[0], b[2])
            for x, y in zip(flatten_leaves(a), flatten_leaves(b)):
                err = max(err, float((x.float() - y.float()).abs().max()))
        check(err == 0.0, f"adam_ema at {name}'s leaves: {err} off the "
                          f"plain chain")
        g, (params3, state3, ema3) = grads_of(), a
        moved_n = sum(t.numel() for k in keys for t in flatten_leaves(
            params[k]))
        frozen_n = sum(t.numel() for k in params if not moved(k)
                       for t in flatten_leaves(params[k]))
        with torch.no_grad():
            ms = time_device_ms(lambda: opt.update_with_ema(
                g, state3, params3, ema3, decay))
            plain_ms = busy_ms(lambda: plain(g, state3, params3, ema3))
            per_step = count_launches(lambda: opt.update_with_ema(
                g, state3, params3, ema3, decay))
            plain_launches = count_launches(
                lambda: plain(g, state3, params3, ema3))
            lib_ms = time_device_ms(foreach_chain(
                opt, g, state3, params3, ema3, decay, keys))
            torch.cuda.synchronize()
            calls = 200
            t0 = time.perf_counter()
            for _ in range(calls):
                opt.update_with_ema(g, state3, params3, ema3, decay)
            host_us = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
        n_bytes = (fused.MOVED_BYTES * moved_n
                   + fused.EMA_ONLY_BYTES * frozen_n)
        bnd = bound(n_bytes, 20 * moved_n + 3 * frozen_n)
        print(f"[adam ema] {name}: {moved_n} moved and {frozen_n} EMA-only "
              f"elements in {len(flatten_leaves(params))} leaves: kernel "
              f"{ms:.4f} ms ({n_bytes / ms / 1e6:.1f} GB/s, "
              f"{100 * bnd['bound_ms'] / ms:.1f}% of the byte bound "
              f"{bnd['bound_ms']:.4f}), plain {plain_ms:.4f} ms in "
              f"{plain_launches} launches, torch._foreach_* {lib_ms:.4f} "
              f"ms; launches a step {per_step} (on the main path "
              f"{main_path}); host {host_us:.1f} us a call; max error {err}")
        check(per_step == 1, f"adam_ema at {name}'s leaves: {per_step} "
                             f"launches a step")
        rows.append(dict(
            name=f"adam ema ({name} leaves)", route="CUDA C++, nvcc + ctypes",
            source="seal3d_tpu_torch/csrc/adam_ema.cu",
            replaces="none (XLA fuses optax's chain on the TPU)",
            launches=main_path, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, **bnd))
    return rows


def flatten_leaves(tree) -> list:
    from seal3d_tpu_torch.train.checkpoint import flatten_tree

    return [t for _, t in flatten_tree(tree)]


def foreach_chain(opt, grads, state, params, ema, decay, keys):
    """The same step as `torch._foreach_*` calls over the leaf lists, its
    scalars formed on the host (so a CUDA graph holds it)."""
    b1, b2 = opt.b1, opt.b2
    count = 3     # any step: the time does not depend on it
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    g = flatten_leaves({k: grads[k] for k in keys})
    p = flatten_leaves({k: params[k] for k in keys})
    m = flatten_leaves(state[0].mu)
    v = flatten_leaves(state[0].nu)
    e = flatten_leaves({k: ema[k] for k in keys})
    fp = flatten_leaves({k: params[k] for k in params if k not in keys})
    fe = flatten_leaves({k: ema[k] for k in params if k not in keys})

    def step():
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(m, b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
            torch._foreach_mul(v, b2))
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, bc2)), opt.eps)
        upd = torch._foreach_mul(
            torch._foreach_div(torch._foreach_div(mu, bc1), den), -opt.lr)
        new_p = torch._foreach_add(p, upd)
        new_e = torch._foreach_add(torch._foreach_mul(e, decay),
                                   torch._foreach_mul(new_p, 1 - decay))
        new_fe = torch._foreach_add(torch._foreach_mul(fe, decay),
                                    torch._foreach_mul(fp, 1 - decay))
        return new_p, mu, nu, new_e, new_fe

    return step


# phase 23: the D-NeRF, CCNeRF and SDF CLIs at their families' full widths
DN_ARGV = ["synthetic_dynamic", "-O", "--bound", "1.0", "--dt_gamma", "0",
           "--min_near", "0.05", "--max_steps", "512", "--H", "256", "--W",
           "256", "--num_views", "48", "--views_per_time", "4",
           "--time_multires", "2", "--deform_reg", "1e-3"]
DN_STEPS, DN_BUCKET_STEPS = 800, 100      # 23a on K1, 23b on `bucket`
DN_GRID_CALLS = 8 * 4   # a time-grid update: 8 slices of 2^19 points, 2^17
# CCNeRF's views at 128x128, cut from 256x256 for time: its renders (4
# evaluations, 16 test views) were a fifth of phase 23 at 256x256
CC_ARGV = ["synthetic", "-O", "--bound", "1.0", "--H", "128", "--W", "128"]
CC_STEPS, CC_COMPRESS = 1200, ("8", "16", "24", "48")
SDF_STEPS = 300
MIN_FAMILY_GAIN_DB = 2.0   # over the untrained field (tests/test_dnerf.py,
MIN_DN_PSNR = 18.0         # tests/test_ccnerf.py); absolute floors from
MIN_CC_PSNR = 20.0         # PERF.md's PR 12 prediction
MAX_SDF_MAE_FRAC = 0.5     # of the untrained field's (tests/test_sdf.py)


def reset_counters():
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def read_counters(counters):
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in counters.items()}


def step_ms(tr) -> float:
    """ms per train step over the timing window, grid updates included."""
    st = tr.train_stats
    return st["window_s"] / max(st["window_steps"], 1) * 1e3


def families_phase(dev, ws):
    """Phase 23 -> (K1 forward, K1 backward, hash forward, hash backward
    launches on its main paths, K1's largest forward error, 23a's D-NeRF
    trainer)."""
    f1, b1, err, dn_tr = dnerf_halo_phase(dev, os.path.join(ws, "dnerf"))
    fh, bh = dnerf_bucket_phase(dev, os.path.join(ws, "dnerf_bucket"))
    ccnerf_phase(dev, os.path.join(ws, "ccnerf"))
    sdf_phase(os.path.join(ws, "sdf"))
    return f1, b1, fh, bh, err, dn_tr


def dnerf_field_calls(tr, steps):
    """K1 (or hash) forward launches of a main_dnerf run: one a step, 32 a
    time-grid update, one a rendered chunk (val and test views)."""
    return (steps + DN_GRID_CALLS * len(tr.train_stats["grid_updates"])
            + sum(s["chunks_rendered"] for s in tr.render_stats))


def deform_moved(tr, fresh) -> list:
    """Max |w - w_init| of each deform-net layer."""
    return [float((a["w"] - b["w"]).abs().max()) for a, b in zip(
        tr.state.params["deform_net"], fresh.state.params["deform_net"])]


def dnerf_untrained(tr, val):
    """A DNeRFTrainer of tr's config and seed at its init, after the first
    step's time-grid update (slices 0-7; the val views sit at time 0)."""
    from seal3d_tpu_torch.train.dnerf_trainer import DNeRFTrainer

    fresh = DNeRFTrainer(tr.fcfg, tr.opts, dataclasses.replace(
        tr.cfg, workspace=None), dataset=tr.dataset, device=tr.device,
        time_size=tr.time_size, deform_reg=tr.deform_reg)
    fresh.init_state()
    fresh.update_grid()
    return fresh, fresh.evaluate(dataset=val)


def dnerf_halo_phase(dev, ws):
    """Phase 23a: main_dnerf -O (K1) at full width for DN_STEPS steps ->
    (K1 forward, backward launches, K1's largest forward error, the
    trainer)."""
    from seal3d_tpu_torch import main_dnerf
    from seal3d_tpu_torch.config import common_parser, load_dataset
    from seal3d_tpu_torch.ops import halo_encode as k1

    counters = reset_counters()
    t0 = time.perf_counter()
    tr = main_dnerf.main(DN_ARGV + ["--iters", str(DN_STEPS),
                                    "--workspace", ws])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = read_counters(counters)
    fwd, bwd = launched["halo_encode"], launched["halo_encode_bwd"]
    calls = dnerf_field_calls(tr, DN_STEPS)
    upd = [s for _, s in tr.train_stats["grid_updates"]]
    in_window = sum(upd[1:])   # the updates after step 48 fall in the window
    ms = step_ms(tr)
    ms_steps = (tr.train_stats["window_s"] - in_window) / max(
        tr.train_stats["window_steps"], 1) * 1e3
    print(f"[dnerf] main_dnerf -O {DN_STEPS} steps at 256x256 (48 views, 4 "
          f"a time; deform 5x128, 16 levels F=2 at T=2^15 wrap on K1, 64 "
          f"time slices): {wall:.2f} s in all; {ms:.3f} ms a step with the "
          f"time-grid updates, {ms_steps:.3f} without; {len(upd)} updates "
          f"of 8 slices, {np.mean(upd):.3f} s each (first {upd[0]:.3f})")
    print(f"[dnerf] K1 launches: forward {fwd} (field calls {calls}: "
          f"{DN_STEPS} steps, {DN_GRID_CALLS} a grid update, 1 a rendered "
          f"chunk), backward {bwd} (steps {DN_STEPS}); the others "
          f"{ {k: v for k, v in launched.items() if v and 'halo' not in k} }")
    check(fwd == calls and bwd == DN_STEPS,
          f"D-NeRF K1 launches {fwd} / {bwd} != {calls} / {DN_STEPS}")
    check(not any(v for k, v in launched.items() if "halo_encode" not in k),
          f"another kernel ran on the D-NeRF -O path: {launched}")
    cli, _ = common_parser("chip_smoke").parse_known_args(DN_ARGV)
    val = load_dataset(cli, "val", device=dev)
    fresh, psnr0 = dnerf_untrained(tr, val)
    psnr1 = tr.eval_history[-1]["psnr"]
    moved = deform_moved(tr, fresh)
    print(f"[dnerf] val PSNR {psnr1:.2f} dB over 4 views at 256x256 after "
          f"{DN_STEPS} steps, {psnr0:.2f} at the first step; deform_net "
          f"moved max |dw| by layer {[round(v, 5) for v in moved]} (from "
          f"its zero head, through the L1 term alone)")
    check(psnr1 >= psnr0 + MIN_FAMILY_GAIN_DB and psnr1 >= MIN_DN_PSNR,
          f"D-NeRF val PSNR {psnr1:.2f} (untrained {psnr0:.2f})")
    check(all(v > 0 for v in moved), f"deform_net did not move: {moved}")
    del fresh
    _, f_step, b_step = k1_counted(tr.train_step)
    (_, _), f_view, _ = k1_counted(lambda: tr.render_image_t(
        val.poses[0], val.h, val.w, float(val.times[0])))
    t0 = time.perf_counter()
    _, f_grid, _ = k1_counted(tr.update_grid)
    grid_s = time.perf_counter() - t0
    print(f"[dnerf] K1 launches: a step {f_step} forward / {b_step} "
          f"backward, a 256x256 view {f_view}, a time-grid update {f_grid} "
          f"({grid_s:.3f} s)")
    check((f_step, b_step, f_grid) == (1, 1, DN_GRID_CALLS),
          "D-NeRF K1 launches a step / grid update")
    prof = profile_steps(tr)
    print(f"[dnerf] a step: {prof['launches']:.0f} launches, device busy "
          f"{prof['busy_ms']:.3f} ms")
    with capture_k1() as seen:
        tr.train_step()
    err = k1_case_vs_plain(dict(seen[-1], name="a D-NeRF step's warped "
                                "samples ([N, K] grid)"), "[dnerf]")
    chunk = {}
    launch = k1._launch_fwd

    def first_chunk(table, x, valid, cfg, *rest):
        if not chunk:
            chunk.update(table=table.detach(), x=x, valid=valid, cfg=cfg)
        return launch(table, x, valid, cfg, *rest)

    k1._launch_fwd = first_chunk
    try:
        tr.update_grid()
    finally:
        k1._launch_fwd = launch
    with torch.no_grad():
        e_grid = float((k1.halo_encode(chunk["table"], chunk["x"], None,
                                       chunk["cfg"])
                        - k1.halo_encode_plain(chunk["table"], chunk["x"],
                                               None, chunk["cfg"]))
                       .abs().max())
    print(f"[dnerf] K1 on a time-grid update's chunk (M="
          f"{chunk['x'].shape[0]}, warped at jittered times): fwd "
          f"max_abs_err {e_grid:.3e}")
    check(e_grid <= TOL, f"K1 on the D-NeRF grid chunk: {e_grid}")
    return fwd, bwd, max(err, e_grid), tr


def dnerf_bucket_phase(dev, ws):
    """Phase 23b: main_dnerf --grid_backend bucket (K3 forward, K2 backward,
    the positions' gradient) for DN_BUCKET_STEPS steps."""
    from seal3d_tpu_torch import main_dnerf
    from seal3d_tpu_torch.ops import hash_encode as k3

    counters = reset_counters()
    t0 = time.perf_counter()
    tr = main_dnerf.main(DN_ARGV + ["--grid_backend", "bucket", "--iters",
                                    str(DN_BUCKET_STEPS), "--workspace", ws])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = read_counters(counters)
    fwd, bwd = launched["hash_encode"], launched["hash_encode_bwd"]
    calls = dnerf_field_calls(tr, DN_BUCKET_STEPS)
    losses = [h["loss"] for h in tr.history]
    fresh = type(tr)(tr.fcfg, tr.opts, dataclasses.replace(
        tr.cfg, workspace=None), device=tr.device, time_size=tr.time_size)
    fresh.init_state()
    moved = deform_moved(tr, fresh)
    print(f"[dnerf bucket] main_dnerf --grid_backend bucket (T=2^19 hash, "
          f"F=2) {DN_BUCKET_STEPS} steps: {wall:.2f} s in all, "
          f"{step_ms(tr):.3f} ms a step; loss {losses}; val PSNR "
          f"{tr.eval_history[-1]['psnr']:.2f} dB; hash-encode launches "
          f"forward {fwd} (field calls {calls}), backward {bwd}; deform_net "
          f"moved {[round(v, 5) for v in moved]}")
    check(fwd == calls and bwd == DN_BUCKET_STEPS,
          f"D-NeRF bucket launches {fwd} / {bwd}")
    check(not any(v for k, v in launched.items() if "hash_encode" not in k),
          f"another kernel ran on the D-NeRF bucket path: {launched}")
    check(losses[-1] < losses[0], f"D-NeRF bucket loss did not fall: "
                                  f"{losses}")
    check(all(v > 0 for v in moved), f"deform_net did not move: {moved}")
    seen = {}
    launch = k3._launch_fwd

    def record(table, x, cfg):
        seen.update(table=table.detach(), x=x.detach(), cfg=cfg)
        return launch(table, x, cfg)

    k3._launch_fwd = record
    try:
        tr.train_step()
    finally:
        k3._launch_fwd = launch
    table, x, cfg = seen["table"], seen["x"], seen["cfg"]
    gen = torch.Generator(device=dev).manual_seed(23)
    cot = torch.randn((x.shape[0], cfg.num_levels * table.shape[1]),
                      generator=gen, device=dev)
    xg = x.clone().requires_grad_()
    (k3.hash_encode(table, xg, cfg).reshape(x.shape[0], -1) * cot).sum() \
        .backward()
    want = k3.bucket_dx(cot.cpu(), table.cpu(), x.cpu(), cfg)
    err = float((xg.grad.cpu() - want).abs().max())
    scale = float(want.abs().max())
    print(f"[dnerf bucket] positions' gradient of one step's warped samples "
          f"(M={x.shape[0]}) on the card against the CPU plain version: "
          f"max_abs_err {err:.3e} of max |dx| {scale:.3e}")
    check(err <= 1e-5 * scale, f"bucket dx on the card: {err} of {scale}")
    return fwd, bwd


def ccnerf_phase(dev, ws):
    """Phase 23c: main_CCNeRF at the CLI's ranks and 300^3, then --compress
    and --compose on the run's checkpoint. No kernel of the table runs."""
    from seal3d_tpu_torch import main_CCNeRF
    from seal3d_tpu_torch.config import common_parser, load_dataset
    from seal3d_tpu_torch.train.cc_trainer import CCNeRFTrainer

    counters = reset_counters()
    t0 = time.perf_counter()
    tr = main_CCNeRF.main(CC_ARGV + ["--iters", str(CC_STEPS),
                                     "--workspace", ws])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cli = common_parser("chip_smoke").parse_args(CC_ARGV)
    val = load_dataset(cli, "val", device=dev)
    fresh = CCNeRFTrainer(tr.fcfg, tr.opts, dataclasses.replace(
        tr.cfg, workspace=None), dataset=tr.dataset, device=dev)
    fresh.init_state()
    psnr0 = fresh.evaluate(dataset=val)
    del fresh
    psnr1 = tr.eval_history[-1]["psnr"]
    prof = profile_steps(tr)
    print(f"[ccnerf] main_CCNeRF {CC_STEPS} steps at 128x128 (300^3, ranks "
          f"vd {tr.fcfg.rank_vec_density} md {tr.fcfg.rank_mat_density} vc "
          f"{tr.fcfg.rank_vec} mc {tr.fcfg.rank_mat}, K=3 residual outputs "
          f"a sample, 128 samples a ray): {wall:.2f} s in all; "
          f"{step_ms(tr):.3f} ms a step, {prof['launches']:.0f} launches, "
          f"busy {prof['busy_ms']:.3f} ms; val PSNR {psnr1:.2f} dB, "
          f"untrained {psnr0:.2f}")
    check(psnr1 >= psnr0 + MIN_FAMILY_GAIN_DB and psnr1 >= MIN_CC_PSNR,
          f"CCNeRF val PSNR {psnr1:.2f} (untrained {psnr0:.2f})")
    del tr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cmp = main_CCNeRF.main(CC_ARGV + ["--test", "--compress", *CC_COMPRESS,
                                      "--workspace", ws])
    cmp_s = time.perf_counter() - t0
    cmp.state = cmp.state._replace(ema_params=cmp.state.params)
    psnr_c = cmp.evaluate(dataset=val)
    ranks = {f: [g["S"].shape[1] for g in cmp.state.params["objects"][0][f]]
             for f in ("vec_density", "mat_density", "vec_color",
                       "mat_color")}
    print(f"[ccnerf] --test --compress {' '.join(CC_COMPRESS)}: {cmp_s:.2f} "
          f"s (8 test renders); ranks {ranks}; val PSNR {psnr_c:.2f} dB")
    check(psnr_c >= psnr0 + MIN_FAMILY_GAIN_DB,
          f"compressed CCNeRF PSNR {psnr_c:.2f}")
    del cmp
    ckpt = os.path.join(ws, "checkpoints", f"ccnerf_step{CC_STEPS:07d}.npz")
    t0 = time.perf_counter()
    # the composed scene's renders: only their finiteness is read
    cps = main_CCNeRF.main(CC_ARGV + ["--test", "--ckpt", ckpt, "--compose",
                                      ckpt, "--workspace",
                                      os.path.join(ws, "cps")])
    n_obj = len(cps.state.params["objects"])
    print(f"[ccnerf] --compose {os.path.basename(ckpt)}: "
          f"{time.perf_counter() - t0:.2f} s, {n_obj} objects, "
          f"{len(cps.render_stats)} test views, non-finite values "
          f"{sum(s['nonfinite'] for s in cps.render_stats)}")
    check(n_obj == 2 and len(cps.render_stats) == 8 and not any(
        s["nonfinite"] for s in cps.render_stats), "composed CCNeRF render")
    launched = read_counters(counters)
    check(not any(launched.values()), f"a kernel ran on the CCNeRF path: "
                                      f"{launched}")


def sdf_phase(ws):
    """Phase 23d: main_sdf synthetic at the CLI's defaults (T=2^19, 16,384
    points a step). No kernel of the table runs (the plain gather)."""
    from seal3d_tpu_torch import main_sdf
    from seal3d_tpu_torch.data.sdf_provider import load_mesh
    from seal3d_tpu_torch.train.sdf_trainer import SDFTrainer

    counters = reset_counters()
    t0 = time.perf_counter()
    tr = main_sdf.main(["synthetic", "--iters", str(SDF_STEPS),
                        "--workspace", ws])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fresh = SDFTrainer(tr.cfg, tr.dataset, num_points=tr.num_points)
    mae0, mae1 = fresh.evaluate(), tr.evaluate()
    verts, faces = load_mesh(os.path.join(ws, "sdf_mesh.ply"))
    st = tr.train_stats
    print(f"[sdf] main_sdf synthetic {SDF_STEPS} steps: {wall:.2f} s in all "
          f"(the 256^3 mesh included); "
          f"{st['window_s'] / st['window_steps'] * 1e3:.3f} ms a step; MAE "
          f"{mae0:.5f} untrained, {mae1:.5f} after; mesh {len(verts)} "
          f"vertices, {len(faces)} triangles")
    check(mae1 <= MAX_SDF_MAE_FRAC * mae0, f"SDF MAE {mae1} of {mae0}")
    check(len(verts) > 0 and np.abs(verts).max() <= 1.0 + 1e-5,
          "SDF mesh empty or outside the bound")
    launched = read_counters(counters)
    check(not any(launched.values()), f"a kernel ran on the SDF path: "
                                      f"{launched}")


@contextlib.contextmanager
def capture_k1(want=lambda x: True, first_only=False):
    """Record the arguments K1 is launched with while the block runs: yields
    a list that gains one dict (cfg, table, x, valid, g) per forward launch
    on positions `x` for which want(x) holds and whose backward launch
    follows; with first_only, the first such pair alone."""
    from seal3d_tpu_torch.ops import halo_encode as k1

    seen, last = [], {}
    fwd, bwd = k1._launch_fwd, k1._launch_bwd

    def rec_fwd(table, x, valid, cfg, *rest):
        if want(x) and not (first_only and seen):
            last.update(cfg=cfg, table=table.detach(), x=x, valid=valid)
        return fwd(table, x, valid, cfg, *rest)

    def rec_bwd(g, x, *rest):
        if last and x.data_ptr() == last["x"].data_ptr():
            seen.append(dict(last, g=g.detach().reshape(x.shape[0], -1)
                             .clone()))
            last.clear()
        return bwd(g, x, *rest)

    k1._launch_fwd, k1._launch_bwd = rec_fwd, rec_bwd
    try:
        yield seen
    finally:
        k1._launch_fwd, k1._launch_bwd = fwd, bwd


@contextlib.contextmanager
def other_library(source):
    """Launch the kernels from a build of the tree's CUDA sources with
    `source`, another version of one of them known by its file name, in
    its place while the block runs (None: the tree's build). A version from
    before a trailing argument was added (K1's row stride) ignores it,
    which suits every timed case: packed rows."""
    from seal3d_tpu_torch.runtime.kernels import library

    if source is None:
        yield
        return
    with library(other_build(source)):
        yield


@functools.cache
def other_build(source):
    from seal3d_tpu_torch.runtime.build import CSRC_DIR, build_library

    name = os.path.basename(source)
    sources = [source if os.path.basename(s) == name else s
               for s in glob.glob(os.path.join(CSRC_DIR, "*.cu"))]
    built = build_library(sources)
    print(f"[baseline build] {name}: {built.seconds:.1f} s for the "
          f"{len(sources)} csrc/*.cu files (0.0: an identical build existed)")
    return ctypes.CDLL(built.path)


def in_turns(baselines, fn):
    """fn() under each version of a kernel source, the tree's and then
    every baseline, and once more in reverse order -> {display name:
    [first result, second result]}."""
    names = baseline_names(baselines)
    out = {name: [] for name in names}
    order = list(zip([None, *baselines], names))
    for src, name in order + order[::-1]:
        with other_library(src):
            out[name].append(fn())
    return out


def baseline_names(baselines):
    """Display names of the versions timed: the tree's, then each baseline
    file as <its directory>/<its name>."""
    return ["tree"] + [os.path.basename(os.path.dirname(os.path.abspath(b)))
                       + "/" + os.path.basename(b) for b in baselines]


def k1_levels_phase(dev, chunk):
    """Phase 15 -> the kernel-table row of K1 over a level range (the
    per-shard program of the level-sharded encode), timed as the 4 shards of
    n_model=4 on the real render chunk, each writing its columns of the full
    feature tensor."""
    from seal3d_tpu_torch.ops.halo_encode import (halo_encode,
                                                  halo_encode_levels,
                                                  halo_encode_plain,
                                                  halo_encode_sharded)

    cfg = chunk["cfg"]
    levels, t_rows, f = cfg.num_levels, 2**cfg.log2_hashmap_size, 4
    rng = np.random.default_rng(15)
    m = 2**20
    x = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=m) >= 0.25).to(dev)
    tab = torch.from_numpy(rng.uniform(-1, 1, (cfg.total_params, f))
                           .astype(np.float32)).to(dev)
    inputs = [("random M=2^20", tab, x, valid),
              ("real chunk", chunk["table"], chunk["x"], chunk["valid"])]
    halo_encode_levels.launches = 0
    expect = 0
    for tag, t, xx, vv in inputs:
        mm = xx.shape[0]
        g = torch.empty((mm, levels * f), device=dev).uniform_(
            -1, 1, generator=torch.Generator(device=dev).manual_seed(15))
        whole = t.clone().requires_grad_()
        ref = halo_encode(whole, xx, vv, cfg).reshape(mm, -1)
        ref.backward(g)
        scale = float(whole.grad.abs().max())
        for n_model, n_data in ((2, 1), (4, 1), (8, 1), (4, 2)):
            ts = t.clone().requires_grad_()
            out = halo_encode_sharded(ts, xx, vv, cfg, n_model, n_data)
            out.backward(g)
            expect += 2 * n_model * n_data
            same = torch.equal(out.detach(), ref.detach())
            err = float((ts.grad - whole.grad).abs().max())
            print(f"[k1 levels] {tag} M={mm} model={n_model} data={n_data}: "
                  f"forward {'bit-identical' if same else 'DIFFERS'} to the "
                  f"whole encode, table gradient max_abs_err {err:.3e} (max "
                  f"|grad| {scale:.3e}, rel {err / scale:.3e})")
            check(same, f"sharded forward {tag} model={n_model} differs")
            check(err <= BWD_RTOL * scale,
                  f"sharded gradient {tag} model={n_model}: {err} of {scale}")
            del ts, out
        del whole, ref, g
    launches = halo_encode_levels.launches
    print(f"[k1 levels] level-range launches {launches} (shard programs, "
          f"forward and backward: {expect})")
    check(launches == expect, f"level-range launches {launches} != {expect}")

    # the 4 shard programs of n_model=4 against their plain versions
    _, t, xx, vv = inputs[1]
    per = levels // 4
    shards = [t[j * per * t_rows:(j + 1) * per * t_rows] for j in range(4)]
    full = torch.empty((xx.shape[0], levels, f), device=dev)

    def kernel():
        for j, tj in enumerate(shards):
            halo_encode_levels(tj, xx, vv, cfg, j * per, per, out=full)
        return full

    def plain():
        return torch.cat([halo_encode_plain(tj, xx, vv, cfg,
                                            range(j * per, (j + 1) * per))
                          for j, tj in enumerate(shards)], dim=1)

    err, _, ms, plain_ms = compare(kernel, plain)
    with torch.no_grad():
        whole_ms = time_ms(lambda: halo_encode(t, xx, vv, cfg))
    n_valid = int(vv.sum())
    print(f"[k1 levels] real chunk M={xx.shape[0]} ({n_valid} valid), 4 "
          f"shards of {per} levels into their columns of [M, {levels}, {f}]: "
          f"max_abs_err {err:.3e}; the 4 launches {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, the whole encode in one launch {whole_ms:.3f} "
          f"ms")
    check(err <= TOL, f"level-range K1 disagrees with plain: {err}")
    return {"name": "halo_encode_levels", "route": "cuda",
            "source": "seal3d_tpu_torch/csrc/halo_encode.cu",
            "replaces": "seal3d_tpu/ops/pallas/halo_encode.py:497",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            **encode_bound(xx.shape[0], n_valid, levels, f, t.shape[0],
                           valid_bytes=1)}


def k1_measure_phase(dev, bwd_row, step_case, chunk, seal_case, baselines):
    """Phase 16: K1 where the main path runs it. Forward and backward, whole
    and level by level, on the packed samples of a real train step, on
    random points of the same count, on the real render chunk, on one Seal
    pretraining batch and on 2^20 random points; each version of the kernels
    (the tree's, then every halo_encode.cu --baseline) timed in turns, as
    device time (`time_device_ms`; the plain backward's is `busy_ms`). The
    backward is held against the plain version fed
    a float64 cotangent, within BWD_RTOL of its largest entry.
    Updates the backward's kernel-table row to the real train step."""
    from seal3d_tpu_torch.ops import halo_encode as k1
    from seal3d_tpu_torch.ops.halo_encode import (halo_encode, halo_encode_bwd,
                                                  halo_encode_bwd_plain,
                                                  halo_encode_levels,
                                                  halo_encode_plain)
    from seal3d_tpu_torch.ops.hashgrid import corner_indices_weights

    cfg = step_case["cfg"]
    levels, t_rows = cfg.num_levels, 2**cfg.log2_hashmap_size
    rng = np.random.default_rng(16)

    def uniform(m):
        return torch.from_numpy(rng.uniform(0, 1, (m, 3))
                                .astype(np.float32)).to(dev)

    m20 = 2**20
    cases = [
        dict(step_case, per_level=True),
        dict(step_case, per_level=True, x=uniform(step_case["x"].shape[0]),
             name="random points, the train step's count and valid"),
        dict(chunk, per_level=True),
        dict(seal_case, per_level=False),
        dict(name="random points M=2^20, 25% invalid", cfg=cfg,
             table=step_case["table"], x=uniform(m20),
             valid=torch.from_numpy(rng.uniform(size=m20) >= 0.25).to(dev),
             g=torch.from_numpy(rng.uniform(-1, 1, (m20, levels * 4))
                                .astype(np.float32)).to(dev),
             per_level=False)]
    variants = [None, *baselines]
    names = baseline_names(baselines)
    results = []
    for case in cases:
        t, x, v, g = case["table"], case["x"], case["valid"], case["g"]
        m, f, n = x.shape[0], t.shape[1], t.shape[0]
        n_valid = m if v is None else int(v.sum())
        ops = {"fwd": lambda: halo_encode(t, x, v, cfg)}
        if g is not None:
            ops["bwd"] = lambda: halo_encode_bwd(g, x, v, cfg, n)
        if case["per_level"]:
            for l in range(levels):
                tl = t[l * t_rows:(l + 1) * t_rows]
                ops[f"fwd L{l}"] = (lambda tl=tl, l=l: halo_encode_levels(
                    tl, x, v, cfg, l, 1))
                if g is not None:
                    gl = g.reshape(m, levels, f)[:, l].contiguous()
                    ops[f"bwd L{l}"] = (lambda gl=gl, l=l: halo_encode_bwd(
                        gl, x, v, cfg, t_rows, range(l, l + 1)))
        # right first: the tree's against plain, every baseline against it
        with torch.no_grad():
            ref_f = halo_encode(t, x, v, cfg)
            err_f = float((ref_f - halo_encode_plain(t, x, v, cfg)).abs().max())
            check(err_f <= TOL, f"K1 fwd on {case['name']}: {err_f}")
            err_b = err_p = scale = plain_ms = None
            if g is not None:
                ref_b = halo_encode_bwd(g, x, v, cfg, n)
                exact = halo_encode_bwd_plain(g.double(), x, v, cfg, n)
                scale = float(exact.abs().max())
                err_b = float((ref_b - exact).abs().max())
                err_p = float((halo_encode_bwd_plain(g, x, v, cfg, n)
                               - exact).abs().max())
                del exact
                check(err_b <= BWD_RTOL * scale,
                      f"K1 bwd on {case['name']}: {err_b} of {scale}")
            for src, name in zip(variants[1:], names[1:]):
                with other_library(src):
                    check(torch.equal(halo_encode(t, x, v, cfg), ref_f),
                          f"K1 fwd of {name} is not bit-identical to the "
                          f"tree's on {case['name']}")
                    if g is not None:
                        d = float((halo_encode_bwd(g, x, v, cfg, n)
                                   - ref_b).abs().max())
                        check(d <= 5 * BWD_RTOL * scale,
                              f"K1 bwd of {name} differs from the tree's on "
                              f"{case['name']}: {d} of {scale}")
            del ref_f
            # timed in turns: every version, then every version in reverse
            times = {name: {op: 0.0 for op in ops} for name in names}
            for op, fn in ops.items():
                order = list(zip(variants, names))
                for src, name in order + order[::-1]:
                    with other_library(src):
                        times[name][op] += time_device_ms(fn) / 2
            if g is not None and case is cases[0]:
                plain_ms = busy_ms(lambda: halo_encode_bwd_plain(
                    g, x, v, cfg, n))
                # the backward's function as one PyTorch call: index_add_
                # of the step's corner rows (g * w, invalid rows zero)
                keys, w = corner_indices_weights(x, cfg)
                gv = g if v is None else g * v[:, None]
                contrib = (gv.reshape(m, levels, 1, f)
                           * w[..., None]).reshape(-1, f)
                keys = keys.reshape(-1)
                lib_ms = time_device_ms(lambda: torch.zeros(
                    (n, f), device=dev).index_add_(0, keys, contrib))
                del keys, w, contrib
                print(f"[k1 cases] {case['name']}: the backward's scatter as "
                      f"index_add_ of its {m * levels * 8} corner rows: "
                      f"{lib_ms:.4f} ms of device time")
        print(f"[k1 cases] {case['name']}: M={m} ({n_valid} valid) L={levels}"
              f" F={f}; tree fwd max_abs_err {err_f:.3e}"
              + ("" if g is None else
                 f", bwd max_abs_err {err_b:.3e} of max |grad| {scale:.3e} "
                 f"against the float64 plain sum (rel {err_b / scale:.3e}, "
                 f"tolerance {BWD_RTOL:.0e}; the fp32 plain version's rel "
                 f"{err_p / scale:.3e})")
              + ("" if len(names) == 1 else "; baselines: forward "
                 "bit-identical, backward within tolerance"))
        for name in names:
            tm = times[name]
            line = f"[k1 cases]   {name}: fwd {tm['fwd']:.4f} ms"
            if g is not None:
                line += f", bwd {tm['bwd']:.4f} ms"
            print(line)
            if case["per_level"]:
                for op in ("fwd", "bwd")[:1 if g is None else 2]:
                    per = [tm[f"{op} L{l}"] * 1e3 for l in range(levels)]
                    print(f"[k1 cases]     {op} level by level, us: "
                          f"{[round(u, 1) for u in per]} (sum "
                          f"{sum(per) / 1e3:.4f} ms)")
        results.append({"case": case["name"], "m": m, "valid": n_valid,
                        "ms": times})
        if case is cases[0]:
            bwd_row.update(
                ms=times["tree"]["bwd"], plain_ms=plain_ms, library_ms=lib_ms,
                max_abs_err=max(bwd_row["max_abs_err"], err_b),
                **encode_bound(m, n_valid, levels, f, n, valid_bytes=1))
    print("[k1 cases json] " + json.dumps(results))


@contextlib.contextmanager
def capture_hash():
    """Record the arguments the hash-encode kernels are launched with while
    the block runs: yields a list that gains one dict (cfg, table, x, g) per
    forward launch; g is the cotangent of the backward launch on the same
    positions where one follows, else None."""
    from seal3d_tpu_torch.ops import hash_encode as k3

    seen = []
    fwd, bwd = k3._launch_fwd, k3._launch_bwd

    def rec_fwd(table, x, cfg):
        seen.append(dict(cfg=cfg, table=table.detach(), x=x, g=None))
        return fwd(table, x, cfg)

    def rec_bwd(g, x, cfg, n_rows):
        for rec in reversed(seen):
            if rec["x"].data_ptr() == x.data_ptr():
                rec["g"] = g.detach().reshape(x.shape[0], -1).clone()
                break
        return bwd(g, x, cfg, n_rows)

    k3._launch_fwd, k3._launch_bwd = rec_fwd, rec_bwd
    try:
        yield seen
    finally:
        k3._launch_fwd, k3._launch_bwd = fwd, bwd


def one_level_config(cfg, level):
    """A one-level HashGridConfig with the geometry and size of `level` of
    cfg: the kernels run on it over that level's slice of the table."""
    base = cfg.base_resolution * cfg.per_level_scale ** level
    one = dataclasses.replace(cfg, num_levels=1, base_resolution=base,
                              desired_resolution=base)
    res, _, n, hashed, scale = cfg.level_params[level]
    check(one.level_params[0] == (res, 0, n, hashed, scale),
          f"one-level config of level {level}: {one.level_params[0]} != "
          f"{(res, 0, n, hashed, scale)}")
    return one


def sector_counts(x, cfg, f):
    """The 32-byte table sectors an encode of positions x touches, summed
    over the levels: (corner requests, sectors distinct within each warp of
    32 consecutive samples, sectors distinct over the whole batch). The
    second is what the caches must serve however the lanes are ordered; the
    third must come from device memory at least once."""
    from seal3d_tpu_torch.ops.hashgrid import corner_indices_weights

    per = 32 // (4 * f)      # table rows in one sector; level offsets are
    m = x.shape[0]           # multiples of 8 rows, so sectors do not straddle
    warp = (torch.arange(m, device=x.device) // 32)[:, None]
    in_warp = distinct = 0
    for level in range(cfg.num_levels):
        idx, _ = corner_indices_weights(x, cfg, range(level, level + 1))
        sec = idx[:, 0] // per
        n_sec = cfg.level_params[level][2] // per + 1
        distinct += int(torch.unique(sec).numel())
        in_warp += int(torch.unique(warp * n_sec + sec).numel())
    return m * cfg.num_levels * 8, in_warp, distinct


def hash_measure_phase(dev, rows, trainers, ds800, baselines):
    """Phase 17: the hash-encode kernels where their paths run them. rows:
    the kernel-table rows of hash_encode_fwd and hash_encode_bwd, updated to
    the bucket path's real chunk and real step; trainers: phase 9's and 10's
    trained trainers by backend; ds800: the 800x800 test split."""
    from seal3d_tpu_torch.config import (build_options, build_train_config,
                                         common_parser)
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.ops import hash_encode as k3
    from seal3d_tpu_torch.ops.hash_encode import (hash_encode,
                                                  hash_encode_bwd,
                                                  hash_encode_bwd_plain,
                                                  hash_encode_plain)
    from seal3d_tpu_torch.ops.hashgrid import corner_indices_weights
    from seal3d_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(17)
    variants = [None, *baselines]
    names = baseline_names(baselines)
    cli = common_parser("chip_smoke").parse_args(O_ARGV)

    def uniform(m):
        return torch.from_numpy(rng.uniform(0, 1, (m, 3))
                                .astype(np.float32)).to(dev)

    cases, viewers, grid_queries = [], {}, {}
    for backend, tr in trainers.items():
        cfg = tr.fcfg.grid
        with capture_hash() as seen:     # one more step of the trained state
            tr.train_step()
        steps = [c for c in seen if c["g"] is not None]
        check(len(steps) == 1, f"{backend}: {len(steps)} train-step encodes "
                               f"were captured")
        state = tr.state
        with capture_hash() as seen:     # the density queries of a full update
            tr.update_grid(full=True)
        tr.state = state
        grid_queries[backend] = seen[0]
        viewer = Trainer(ngp, tr.fcfg, build_options(cli),
                         build_train_config(cli), dataset=ds800, device=dev)
        viewer.state = tr.state
        viewers[backend] = viewer
        with capture_hash() as seen:
            viewer.render_image(ds800.poses[0], ds800.h, ds800.w)
        chunk = max(seen, key=lambda c: c["x"].shape[0])
        n_chunks = len(seen)
        del seen
        m_step = steps[0]["x"].shape[0]
        big = backend == "bucket"
        cases += [
            dict(steps[0], backend=backend, per_level=big,
                 name=f"{backend}: real train step (packed, ray order)"),
            dict(chunk, backend=backend, per_level=big,
                 name=f"{backend}: busiest packed chunk of test view 0 "
                      f"({n_chunks} chunks)"),
            dict(steps[0], backend=backend, per_level=False,
                 x=uniform(m_step),
                 name=f"{backend}: random points, the train step's count"),
            dict(backend=backend, per_level=big, cfg=cfg,
                 table=steps[0]["table"], x=uniform(2**20),
                 g=torch.from_numpy(rng.uniform(
                     -1, 1, (2**20, cfg.num_levels * 4))
                     .astype(np.float32)).to(dev),
                 name=f"{backend}: random points M=2^20")]

    results = []
    for case in cases:
        cfg, t, x, g = case["cfg"], case["table"], case["x"], case["g"]
        m, f, n = x.shape[0], t.shape[1], t.shape[0]
        levels = cfg.num_levels
        hashed = sum(h for *_, h, _ in cfg.level_params)
        ops = {"fwd": lambda: hash_encode(t, x, cfg)}
        if g is not None:
            ops["bwd"] = lambda: hash_encode_bwd(g, x, cfg, n)
        if case["per_level"]:
            for l in range(levels):
                one = one_level_config(cfg, l)
                _, off, rows_l, _, _ = cfg.level_params[l]
                tl = t[off:off + rows_l]
                ops[f"fwd L{l}"] = (lambda tl=tl, one=one:
                                    hash_encode(tl, x, one))
                if g is not None:
                    gl = g.reshape(m, levels, f)[:, l].contiguous()
                    ops[f"bwd L{l}"] = (lambda gl=gl, one=one, rows_l=rows_l:
                                        hash_encode_bwd(gl, x, one, rows_l))
        with torch.no_grad():
            # right first: the tree's against plain, every baseline against it
            ref_f = hash_encode(t, x, cfg)
            plain_f = hash_encode_plain(t, x, cfg)
            err_f = float((ref_f - plain_f).abs().max())
            del plain_f
            check(err_f <= TOL, f"hash fwd on {case['name']}: {err_f}")
            err_b = err_p = scale = None
            if g is not None:
                ref_b = hash_encode_bwd(g, x, cfg, n)
                exact = hash_encode_bwd_plain(g.double(), x, cfg, n)
                scale = float(exact.abs().max())
                err_b = float((ref_b - exact).abs().max())
                err_p = float((hash_encode_bwd_plain(g, x, cfg, n)
                               - exact).abs().max())
                del exact
                check(err_b <= BWD_RTOL * scale,
                      f"hash bwd on {case['name']}: {err_b} of {scale}")
            for src, name in zip(variants[1:], names[1:]):
                with other_library(src):
                    check(torch.equal(hash_encode(t, x, cfg), ref_f),
                          f"hash fwd of {name} is not bit-identical to the "
                          f"tree's on {case['name']}")
                    if g is not None:
                        d = float((hash_encode_bwd(g, x, cfg, n)
                                   - ref_b).abs().max())
                        check(d <= 5 * BWD_RTOL * scale,
                              f"hash bwd of {name} differs from the tree's "
                              f"on {case['name']}: {d} of {scale}")
            del ref_f
            times = {name: {} for name in names}
            for op, fn in ops.items():
                for name, pair in in_turns(
                        baselines, lambda fn=fn: time_device_ms(fn)).items():
                    times[name][op] = sum(pair) / 2
            requests, in_warp, distinct = sector_counts(x, cfg, f)
        # the forward reads only the table sectors its samples touch; the
        # backward writes the whole gradient
        bnd_f = encode_bound(m, m, levels, f, n, hashed_levels=hashed,
                             touched_bytes=32 * distinct)
        bnd_b = encode_bound(m, m, levels, f, n, hashed_levels=hashed)
        floor_ms = max(in_warp * 32 / L2_SECTOR_BYTES_S,
                       distinct * 32 / PEAK_BYTES_S) * 1e3
        print(f"[hash cases] {case['name']}: M={m} L={levels} F={f} "
              f"({n} rows); tree fwd max_abs_err {err_f:.3e}"
              + ("" if g is None else
                 f", bwd max_abs_err {err_b:.3e} of max |grad| {scale:.3e} "
                 f"against the float64 plain sum (rel {err_b / scale:.3e}, "
                 f"tolerance {BWD_RTOL:.0e}; the fp32 plain version's rel "
                 f"{err_p / scale:.3e})")
              + ("" if len(names) == 1 else "; baselines: forward "
                 "bit-identical, backward within tolerance"))
        print(f"[hash cases]   byte bound forward {bnd_f['bound_ms']:.4f} ms "
              f"({32 * distinct} of {4 * f * n} table bytes touched), "
              f"backward {bnd_b['bound_ms']:.4f} ms; sectors: "
              f"{requests} corner requests, {in_warp} distinct within warps "
              f"of 32 consecutive samples, {distinct} distinct in all -> "
              f"sector floor {floor_ms:.4f} ms")
        for name in names:
            tm = times[name]
            line = f"[hash cases]   {name}: fwd {tm['fwd']:.4f} ms"
            if g is not None:
                line += f", bwd {tm['bwd']:.4f} ms (with its zero fill)"
            print(line)
            if case["per_level"]:
                for op in ("fwd", "bwd")[:1 if g is None else 2]:
                    per = [tm[f"{op} L{l}"] * 1e3 for l in range(levels)]
                    print(f"[hash cases]     {op} level by level, us: "
                          f"{[round(u, 1) for u in per]} (sum "
                          f"{sum(per) / 1e3:.4f} ms)")
        results.append({"case": case["name"], "m": m, "requests": requests,
                        "sectors_in_warp": in_warp, "sectors": distinct,
                        "floor_ms": floor_ms, "bound_ms": bnd_f["bound_ms"],
                        "bwd_bound_ms": bnd_b["bound_ms"], "ms": times})
        # the kernel-table rows: the bucket path's real chunk and real step
        if case["backend"] == "bucket" and "chunk" in case["name"]:
            with torch.no_grad():
                plain_ms = busy_ms(lambda: hash_encode_plain(t, x, cfg))
            rows[0].update(ms=times["tree"]["fwd"], plain_ms=plain_ms,
                           max_abs_err=max(rows[0]["max_abs_err"], err_f),
                           **bnd_f)
        if "real train step" in case["name"]:
            with torch.no_grad():
                # K2's (bucket) or K3 bwd's (pallas) own function as one
                # PyTorch call on this step's keys
                keys, w = corner_indices_weights(x, cfg)
                contrib = (g.reshape(m, levels, 1, f)
                           * w[..., None]).reshape(-1, f)
                keys = keys.reshape(-1)
                lib_ms = time_device_ms(lambda: torch.zeros(
                    (n, f), device=dev).index_add_(0, keys, contrib))
                zero_ms = time_device_ms(
                    lambda: torch.zeros((n, f), device=dev))
                del keys, w, contrib
            print(f"[hash cases]   the same scatter as index_add_: "
                  f"{lib_ms:.3f} ms of device time; the zero fill of the "
                  f"[{n}, {f}] gradient alone: {zero_ms:.4f} ms")
        if case["backend"] == "bucket" and "real train step" in case["name"]:
            with torch.no_grad():
                plain_ms = busy_ms(lambda: hash_encode_bwd_plain(g, x, cfg, n))
            rows[1].update(ms=times["tree"]["bwd"], plain_ms=plain_ms,
                           library_ms=lib_ms,
                           max_abs_err=max(rows[1]["max_abs_err"], err_b),
                           **bnd_b)
    print("[hash cases json] " + json.dumps(results))

    # the forward's switch from the direct kernel to the tiles, by size, on
    # what the paths send: prefixes of each real chunk (whole rays of it;
    # F=4 with a random cotangent for the backward, and F=2 on the table's
    # first two columns) and the first query chunk of a full grid update.
    # Versions with another switch come in as baselines.
    gen = torch.Generator(device=dev).manual_seed(17)
    swept = []
    for case in cases:
        if "chunk" not in case["name"]:
            continue
        m_all, width = case["x"].shape[0], case["cfg"].num_levels * 4
        for m in (2**16, 98304, 2**17, 196608, 2**18, 2**19, m_all):
            g = torch.empty((m, width), device=dev)
            swept.append(dict(case, x=case["x"][:m].contiguous(),
                              g=g.uniform_(-1, 1, generator=gen),
                              name=f"{case['backend']}: the first {m} rows "
                                   f"of the real chunk"))
        half = case["table"][:, :2].contiguous()
        for m in (2**17, 196608, 2**18, 2**19, m_all):
            swept.append(dict(case, table=half, g=None,
                              x=case["x"][:m].contiguous(),
                              name=f"{case['backend']}: the first {m} rows "
                                   f"of the real chunk, F=2"))
        swept.append(dict(grid_queries[case["backend"]],
                          backend=case["backend"],
                          name=f"{case['backend']}: the first query chunk of "
                               f"a full grid update"))
    for case in swept:
        cfg, t, x, g = case["cfg"], case["table"], case["x"], case["g"]
        with torch.no_grad():
            fwd = in_turns(baselines, lambda: time_device_ms(
                lambda: hash_encode(t, x, cfg)))
            bwd = None if g is None else in_turns(
                baselines, lambda: time_device_ms(
                    lambda: hash_encode_bwd(g, x, cfg, t.shape[0])))
        out_mib = x.shape[0] * cfg.num_levels * t.shape[1] * 4 / 2**20
        print(f"[hash sizes] {case['name']} (M={x.shape[0]}, F={t.shape[1]}, "
              f"output {out_mib:.1f} MiB), ms: " + "; ".join(
                  f"{name}: fwd {sum(fwd[name]) / 2:.4f}"
                  + ("" if bwd is None else f" bwd {sum(bwd[name]) / 2:.4f}")
                  for name in names))

    # the paths' own times, tree and baselines in turns: ms per train step
    # (host clock over 32 steps of the trained state, ending in a sync) and
    # seconds per 800x800 view (render_image's own clock)
    def step_ms(tr, n=32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            tr.train_step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def view_s(viewer):
        viewer.render_image(ds800.poses[0], ds800.h, ds800.w)
        return viewer.render_stats[-1]["seconds"]

    for backend, tr in trainers.items():
        step_ms(tr, 4)
        view_s(viewers[backend])
        st = in_turns(baselines, lambda: step_ms(tr))
        # autograd launches the step's backward from a thread of its own
        check(all(other_build(src) in k3._BWD._bound for src in baselines),
              f"{backend}: a train step under a baseline did not launch its "
              f"backward from that baseline's build")
        vw = in_turns(baselines, lambda: view_s(viewers[backend]))
        for name in names:
            print(f"[hash path] {backend}, {name}: "
                  f"{np.mean(st[name]):.3f} ms per train step "
                  f"{[round(v, 3) for v in st[name]]}, "
                  f"{np.mean(vw[name]):.4f} s per 800x800 view "
                  f"{[round(v, 4) for v in vw[name]]}")


B2_STEPS = 400      # phase 18's timed steps, after TIMING_WARMUP (48)
# phase 18 trains on to this many steps before its PSNR gate: at bound 2
# and lr 3e-3 the field leaves a slow first phase between steps ~450 and
# ~1200 (scripts/probe_bound2_steps.py; PERF.md section 6)
B2_GATE_STEPS = 1200
B2_CLI_ITERS = 128  # phase 18d's CLI run at the default bound, cut from 256
B2_DENSE_STEPS = 64  # phase 18c's dense steps before the oracle comparison
MIN_PARITY_DB = 25.0  # bench.py's own structural-collapse line, a gate here


def k1_counted(fn):
    """(fn(), K1 forward launches, backward launches): the counts set to 0
    just before fn runs and read just after."""
    from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_bwd

    halo_encode.launches = halo_encode_bwd.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, halo_encode.launches, halo_encode_bwd.launches


def k1_case_vs_plain(case, tag):
    """K1 forward and backward on one captured case (cfg, table, x, valid,
    g) against their plain versions: forward <= TOL, backward within
    BWD_RTOL of the largest entry of the plain version fed a float64
    cotangent -> forward max abs error. These launches count for no path."""
    from seal3d_tpu_torch.ops.halo_encode import (halo_encode, halo_encode_bwd,
                                                  halo_encode_bwd_plain,
                                                  halo_encode_plain)

    cfg, t, x, v, g = (case[k] for k in ("cfg", "table", "x", "valid", "g"))
    n = t.shape[0]
    with torch.no_grad():
        err_f = float((halo_encode(t, x, v, cfg)
                       - halo_encode_plain(t, x, v, cfg)).abs().max())
        exact = halo_encode_bwd_plain(g.double(), x, v, cfg, n)
        scale = float(exact.abs().max())
        err_b = float((halo_encode_bwd(g, x, v, cfg, n) - exact).abs().max())
        err_p = float((halo_encode_bwd_plain(g, x, v, cfg, n)
                       - exact).abs().max())
    n_valid = x.shape[0] if v is None else int(v.sum())
    print(f"{tag} K1 on {case['name']}: M={x.shape[0]} ({n_valid} valid) "
          f"F={t.shape[1]}: fwd max_abs_err {err_f:.3e}; bwd max_abs_err "
          f"{err_b:.3e} of max |grad| {scale:.3e} against the float64 plain "
          f"sum (rel {err_b / scale:.3e}; the fp32 plain version's rel "
          f"{err_p / scale:.3e})")
    check(err_f <= TOL, f"K1 fwd on {case['name']}: {err_f}")
    check(err_b <= BWD_RTOL * scale,
          f"K1 bwd on {case['name']}: {err_b} of {scale}")
    return err_f


def grid_field_calls(grid_updates, cascades):
    """K1 forward launches of a train loop's grid updates: a full update
    queries 2^21 cells a cascade in 2^17-cell chunks, a partial one 2^18 +
    2^16 cells a cascade (3 chunks)."""
    n_full = sum(1 for full, _ in grid_updates if full)
    return cascades * (16 * n_full + 3 * (len(grid_updates) - n_full))


def bound2_phase(dev, ws):
    """Phase 18: training and rendering at bound 2 (two cascades), the CLI's
    default. (a) bench.py's wide_bound2 recipe through the Trainer API on
    WideSyntheticScene: train rays/s, val PSNR of one view, both cascades
    occupied, K1 launches equal to the field calls, K1 against its plain
    version on one more step's packed samples; (b) one 800x800
    single-level view of that state; (c) the dense oracle on the 192x192
    held-out view against the fast path, before and after B2_DENSE_STEPS
    dense train steps (K1 against plain on one more) and a full grid
    update; (d) the CLI at its default bound and dt_gamma.
    The PSNR gate is taken at B2_GATE_STEPS, after the recipe's timed
    steps.
    -> (K1 forward launches, backward launches, max forward error, a
    checkpoint of (a)'s state at B2_GATE_STEPS, (d)'s step checkpoint)."""
    from seal3d_tpu_torch import main_nerf
    from seal3d_tpu_torch.data.synthetic import WideSyntheticScene
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.train.trainer import TIMING_WARMUP, Trainer

    # --- (a) bench.py:148-176's recipe
    scene = WideSyntheticScene()
    t0 = time.perf_counter()
    ds = scene.make_dataset(n_views=12, h=192, w=192, seed=0, device=dev)
    val = scene.make_dataset(n_views=1, h=192, w=192, seed=1, device=dev)
    torch.cuda.synchronize()
    print(f"[bound2] WideSyntheticScene: 12 train + 1 val views at 192x192: "
          f"{time.perf_counter() - t0:.2f} s")
    fcfg, opts, tcfg = wide_bound2_recipe()
    steps = TIMING_WARMUP + B2_STEPS
    tr = Trainer(ngp, fcfg, opts, tcfg, dataset=ds, seed=2, device=dev)
    check(opts.cascades == 2, f"bound 2 has {opts.cascades} cascades")

    def psnrs():
        """(bench.py's measure: `evaluate(max_views=1)`, the first training
        view; the held-out val view)."""
        return tr.evaluate(max_views=1), tr.evaluate(val)

    def train_and_eval():
        tr.init_state()
        tr.train(steps=steps, log_every=10**9)
        timed, early = dict(tr.train_stats), psnrs()
        tr.train(steps=B2_GATE_STEPS - steps, log_every=10**9)
        grid = timed["grid_updates"] + tr.train_stats["grid_updates"]
        return timed, grid, early, psnrs()

    (st, grid, early, late), fwd, bwd = k1_counted(train_and_eval)
    step_ms = st["window_s"] / st["window_steps"] * 1e3
    rays_s = tcfg.num_rays * st["window_steps"] / st["window_s"]
    n_full = sum(1 for f, _ in grid if f)
    occupied = np.unpackbits(tr.state.occ.bitfield.cpu().numpy()).reshape(
        2, -1).sum(1)
    chunks = sum(s_["chunks_rendered"] for s_ in tr.render_stats)
    field_calls = B2_GATE_STEPS + grid_field_calls(grid, 2) + chunks
    print(f"[bound2] train: {steps} steps ({TIMING_WARMUP} warm-up), steps "
          f"{TIMING_WARMUP + 1}-{steps}: {step_ms:.3f} ms per step, "
          f"{rays_s:.0f} train rays/s (CUDA events, grid updates included); "
          f"then on to step {B2_GATE_STEPS}: grid updates {n_full} full, "
          f"{len(grid) - n_full} partial; final flat_frac "
          f"{tr.opts.flat_frac}; loss {tr.history[-1]['loss']:.5f}")
    for at, (p_train, p_val) in ((steps, early), (B2_GATE_STEPS, late)):
        print(f"[bound2] PSNR at step {at}: {p_train:.2f} dB on bench.py's "
              f"view (evaluate(max_views=1): the first training view; the "
              f"JAX reference's TPU run read 35.51 dB at step 448, "
              f"BENCH_r05.json, not like for like), {p_val:.2f} dB on the "
              f"held-out val view (192x192)")
    print(f"[bound2] occupied cells by cascade {occupied.tolist()}; K1 "
          f"launches: forward {fwd} (field calls {field_calls}: "
          f"{B2_GATE_STEPS} steps, {n_full}x32 + {len(grid) - n_full}x6 "
          f"grid-update chunks, {chunks} eval chunks), backward {bwd}")
    check(all(np.isfinite(early + late)), f"non-finite PSNR: {early, late}")
    check(late[0] >= MIN_VAL_PSNR, f"bound-2 PSNR {late[0]:.2f} < "
                                   f"{MIN_VAL_PSNR} at step {B2_GATE_STEPS}")
    check((occupied > 0).all(), f"a cascade holds no occupied cell: "
                                f"{occupied.tolist()}")
    check(fwd > 0 and fwd == field_calls,
          f"bound 2: K1 fwd launches {fwd} != field calls {field_calls}")
    check(bwd == B2_GATE_STEPS,
          f"bound 2: K1 bwd launches {bwd} != steps {B2_GATE_STEPS}")
    wide_ckpt = tr.save_checkpoint(os.path.join(
        ws, "bound2_wide", f"wide_step{B2_GATE_STEPS:07d}.npz"))
    with capture_k1() as seen:
        tr.train_step()
    err = k1_case_vs_plain(dict(seen[-1], name="one bound-2 train step's "
                                "packed samples"), "[bound2]")
    n_outer = int(((seen[-1]["x"] * 4.0 - 2.0).abs().amax(-1) > 1.0)
                  [seen[-1]["valid"]].sum())
    print(f"[bound2] of which on cascade 1 (|x| > 1): {n_outer}")
    check(n_outer > 0, "no packed sample of the step lies on cascade 1")
    profile_steps(tr)
    total_f, total_b = fwd, bwd

    # --- (b) one 800x800 single-level view of that state
    ds800 = scene.make_dataset(n_views=1, h=800, w=800, seed=1, device=dev)
    tr.attach_dataset(ds800)
    check(not tr.eval_opts.two_level_ok(tcfg.eval_budget_per_ray),
          "bound 2 should render single-level")
    tr.render_image(ds800.poses[0], 800, 800)      # warm-up
    t0 = time.perf_counter()
    (img, _), fwd, _ = k1_counted(
        lambda: tr.render_image(ds800.poses[0], 800, 800))
    sec = time.perf_counter() - t0
    s8 = tr.render_stats[-1]
    launches = count_launches(lambda: tr.render_image(ds800.poses[0], 800,
                                                      800))
    gt = torch.as_tensor(ds800.images[0], device=dev).float() / 255.0
    print(f"[bound2 1l] 800x800 view: {sec:.4f} s (host clock, synced), "
          f"{launches} kernel launches, K1 launches {fwd}, chunks rendered "
          f"{s8['chunks_rendered']} skipped {s8['chunks_skipped']}, buckets "
          f"{s8['buckets']}, samples {s8['samples']}; PSNR against the "
          f"analytic view {psnr(img.clamp(0, 1), gt):.2f} dB")
    check(s8["nonfinite"] == 0, "non-finite pixels in the 800x800 view")
    check(fwd == s8["chunks_rendered"] > 0,
          f"800x800: K1 launches {fwd} != chunks {s8['chunks_rendered']}")
    total_f += fwd
    tr.attach_dataset(ds)

    # --- (c) the dense oracle against the fast path on the held-out view.
    # A field the fast path trained was never queried in the cells its
    # occupancy grid skips, and holds a fog there (sigma ~0.3) that the
    # dense oracle integrates: B2_DENSE_STEPS dense steps train it out
    # first, then a full grid update gives the fast path the new field's
    # occupancy.
    dense = Trainer(ngp, fcfg, dataclasses.replace(opts, num_steps=128,
                                                   upsample_steps=128),
                    tcfg, dataset=ds, device=dev, use_dense=True)
    dense.state = tr.state
    gt = torch.as_tensor(val.images[0], device=dev).float() / 255.0

    def both():
        """(fast path, dense oracle) renders of the held-out view."""
        return (tr.render_image(val.poses[0], 192, 192)[0].clamp(0, 1),
                dense.render_image(val.poses[0], 192, 192)[0].clamp(0, 1))

    def field_calls():    # of the last two renders
        return (tr.render_stats[-1]["chunks_rendered"]
                + 2 * dense.render_stats[-1]["chunks_rendered"])

    (fast, oracle), fwd, _ = k1_counted(both)
    check(fwd == field_calls(), f"dense: K1 launches {fwd}")
    total_f += fwd
    print(f"[bound2 dense] the fast path's state, 192x192 held-out view: "
          f"dense (128 + 128 samples a ray) vs fast path "
          f"{psnr(oracle, fast):.2f} dB; against the analytic view: dense "
          f"{psnr(oracle, gt):.2f} dB, fast {psnr(fast, gt):.2f} dB")
    t0 = time.perf_counter()
    _, fwd, bwd = k1_counted(
        lambda: [dense.train_step() for _ in range(B2_DENSE_STEPS)])
    sec = time.perf_counter() - t0
    print(f"[bound2 dense] {B2_DENSE_STEPS} dense train steps (4096 rays x "
          f"256 samples): {sec / B2_DENSE_STEPS * 1e3:.2f} ms per step "
          f"(host clock, synced); K1 launches forward {fwd}, backward {bwd}")
    check(fwd == 2 * B2_DENSE_STEPS and bwd == B2_DENSE_STEPS,
          f"dense steps: K1 launches {fwd} / {bwd}")
    total_f, total_b = total_f + fwd, total_b + bwd
    with capture_k1() as seen:
        dense.train_step()
    err = max(err, k1_case_vs_plain(dict(seen[-1], name="a dense train "
                                         "step's samples"), "[bound2 dense]"))
    tr.state = dense.state
    t0 = time.perf_counter()
    _, fwd, _ = k1_counted(lambda: tr.update_grid(full=True))
    dense.state = tr.state
    check(fwd == 32, f"a full grid update at C=2 made {fwd} K1 calls")
    total_f += fwd
    t1 = time.perf_counter()
    (fast, oracle), fwd, _ = k1_counted(both)
    sec = time.perf_counter() - t1
    check(fwd == field_calls(), f"dense: K1 launches {fwd}")
    total_f += fwd
    sd = dense.render_stats[-1]
    db = psnr(oracle, fast)
    print(f"[bound2 dense] after the dense steps and a full grid update "
          f"({t1 - t0:.3f} s): dense vs fast path {db:.2f} dB; against the "
          f"analytic view: dense {psnr(oracle, gt):.2f} dB, fast "
          f"{psnr(fast, gt):.2f} dB; the dense view {sd['samples']} samples, "
          f"both views {sec:.4f} s")
    check(sd["nonfinite"] == 0, "non-finite pixels in the dense render")
    check(db >= MIN_PARITY_DB, f"dense vs fast path {db:.2f} dB < "
                               f"{MIN_PARITY_DB}")
    del dense, tr
    torch.cuda.empty_cache()

    # --- (d) the CLI at its default bound (2.0) and dt_gamma (1/128)
    argv = ["synthetic", "-O", "--lr", "3e-3", "--iters", str(B2_CLI_ITERS),
            "--H", "128", "--W", "128", "--device", "cuda", "--workspace",
            os.path.join(ws, "bound2_cli")]
    t0 = time.perf_counter()
    cli, fwd, bwd = k1_counted(lambda: main_nerf.main(argv))
    sec = time.perf_counter() - t0
    psnr_c = cli.eval_history[-1]["psnr"]
    chunks = sum(s_["chunks_rendered"] for s_ in cli.render_stats)
    field_calls = B2_CLI_ITERS + grid_field_calls(
        cli.train_stats["grid_updates"], 2) + chunks
    print(f"[bound2 cli] main_nerf synthetic -O --lr 3e-3 --iters "
          f"{B2_CLI_ITERS} at "
          f"128x128 (bound {cli.opts.bound}, dt_gamma {cli.opts.dt_gamma}, "
          f"{cli.opts.num_candidates} candidates): {sec:.2f} s in all; val "
          f"PSNR {psnr_c:.2f} dB; K1 launches forward {fwd} (field calls "
          f"{field_calls}), backward {bwd}")
    check(cli.opts.bound == 2.0 and cli.opts.dt_gamma == 1 / 128
          and cli.opts.cascades == 2, "the CLI's defaults moved")
    check(np.isfinite(psnr_c), f"the bound-2 CLI's val PSNR: {psnr_c}")
    check(fwd == field_calls and bwd == B2_CLI_ITERS,
          f"bound-2 CLI: K1 launches {fwd} / {bwd}, field calls "
          f"{field_calls}, steps {B2_CLI_ITERS}")
    cli_ckpt = os.path.join(ws, "bound2_cli", "checkpoints",
                            f"ngp_step{B2_CLI_ITERS:07d}.npz")
    check(os.path.exists(cli_ckpt), f"{cli_ckpt} not written")
    return total_f + fwd, total_b + bwd, err, wide_ckpt, cli_ckpt


def wide_bound2_recipe():
    """bench.py:148-176's wide_bound2 recipe -> (NGPConfig, RenderOptions,
    TrainConfig): halo at T=2^15 `wrap`, dt_gamma 1/128, max_steps 512,
    budget 48, 256 candidates, coarse 64, lr 3e-3, 4096 rays, eval chunk
    2^15 at budget 64 and flat_frac 0.5, adaptive budget."""
    from seal3d_tpu_torch.models.ngp import NGPConfig
    from seal3d_tpu_torch.render.renderer import RenderOptions
    from seal3d_tpu_torch.train.trainer import TrainConfig

    fcfg = NGPConfig(bound=2.0, log2_hashmap_size=15, grid_backend="halo",
                     gridtype="wrap")
    opts = RenderOptions(bound=2.0, dt_gamma=1.0 / 128, max_steps=512,
                         budget_per_ray=48, num_candidates=256,
                         min_near=0.05, coarse_steps=64)
    tcfg = TrainConfig(lr=3e-3, max_steps=30000, num_rays=4096,
                       eval_chunk=2**15, eval_budget_per_ray=64,
                       eval_flat_frac=0.5, random_bg=False,
                       adaptive_budget=True)
    return fcfg, opts, tcfg


def parity_phase(dev, tr7, ds, ws):
    """Phase 19: single-level eval and the dense path at bound 1. Test view 0
    (800x800) of phase 7's trained state through the default two-level
    adaptive render and through the single-level fixed-budget render of
    bench.py's parity check; their PSNR against each other >= 25 dB. Then
    the --dense_render CLI at a tiny size. -> K1 forward launches."""
    from seal3d_tpu_torch import main_nerf
    from seal3d_tpu_torch.config import (build_options, build_train_config,
                                         common_parser)
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.train.trainer import Trainer

    cli = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--workspace", os.path.join(ws, "parity")])
    cfg2 = build_train_config(cli)
    cfg1 = dataclasses.replace(cfg2, eval_two_level=False,
                               eval_adaptive=False, eval_flat_frac=0.375)
    out, total = {}, 0
    for tag, cfg in (("2l", cfg2), ("1l", cfg1)):
        t = Trainer(ngp, tr7.fcfg, build_options(cli), cfg, dataset=ds,
                    device=dev)
        t.state = tr7.state
        t.render_image(ds.poses[0], ds.h, ds.w)       # warm-up
        t0 = time.perf_counter()
        (img, _), fwd, _ = k1_counted(
            lambda: t.render_image(ds.poses[0], ds.h, ds.w))
        sec = time.perf_counter() - t0
        s_ = t.render_stats[-1]
        check(fwd == s_["chunks_rendered"] and s_["nonfinite"] == 0,
              f"{tag}: K1 launches {fwd}, chunks {s_['chunks_rendered']}")
        print(f"[parity] {tag} {ds.h}x{ds.w} test view 0: {sec:.4f} s, K1 "
              f"launches "
              f"{fwd}, chunks rendered {s_['chunks_rendered']} skipped "
              f"{s_['chunks_skipped']}, buckets {s_['buckets']}, samples "
              f"{s_['samples']}")
        out[tag] = img
        total += fwd
    db = psnr(out["2l"].clamp(0, 1), out["1l"].clamp(0, 1))
    print(f"[parity] 2l vs 1l fixed budget (flat_frac 0.375): {db:.2f} dB "
          f"(bench.py:281-299's self-check, a gate here: >= "
          f"{MIN_PARITY_DB})")
    check(db >= MIN_PARITY_DB, f"2l vs 1l {db:.2f} dB < {MIN_PARITY_DB}")

    dws = os.path.join(ws, "dense_cli")
    t0 = time.perf_counter()
    tr = main_nerf.main([
        "synthetic", "--workspace", dws, "--iters", "60", "--num_rays", "128",
        "--H", "32", "--W", "32", "--bound", "1.0", "--dense_render",
        "--num_steps", "32", "--upsample_steps", "0", "--min_near", "0.05",
        "--log2_hashmap_size", "13", "--eval_interval", "1000", "--device",
        "cuda"])
    ckpts = os.listdir(os.path.join(dws, "checkpoints"))
    print(f"[parity] --dense_render CLI (xla backend, 60 steps at 32x32): "
          f"{time.perf_counter() - t0:.2f} s, val PSNR "
          f"{tr.eval_history[-1]['psnr']:.2f} dB, checkpoints {sorted(ckpts)}")
    check("ngp_step0000060.npz" in ckpts and tr.use_dense,
          f"the --dense_render CLI wrote {ckpts}")
    return total


def pth_round_trip(tr, ws):
    """Phases 9-10, end: the trained params through export_torch_ngp and
    import_torch_ngp into a fresh params tree. The native (bucket) layout
    must come back leaf for leaf bit-identical; a padded (pallas) layout
    loses its never-addressed padding rows (zeros on import), so there the
    tables must encode 2^20 random points bit-identically and the MLP
    leaves come back bit-identical."""
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.ops.hash_encode import hash_encode
    from seal3d_tpu_torch.train.checkpoint import (export_torch_ngp,
                                                   flatten_tree,
                                                   import_torch_ngp, map_tree)

    cfg = tr.fcfg.grid
    path = os.path.join(ws, "ngp.pth")
    export_torch_ngp(path, tr.state.params, step=int(tr.state.step),
                     grid_cfg=cfg)
    fresh = ngp.init(tr.fcfg, generator=torch.Generator().manual_seed(7))
    fresh = map_tree(fresh, lambda _, t: t.to(tr.device))
    loaded = dict(flatten_tree(import_torch_ngp(path, fresh, grid_cfg=cfg)))
    padded = cfg.backend == "pallas"
    x = torch.rand((2**20, 3), device=tr.device,
                   generator=torch.Generator(device=tr.device).manual_seed(3))
    same, differ = [], []
    for k, v in flatten_tree(tr.state.params):
        if padded and k in ("encoder", "encoder_color"):
            with torch.no_grad():
                ok = torch.equal(hash_encode(v, x, cfg),
                                 hash_encode(loaded[k], x, cfg))
            rows = int((v != loaded[k]).any(-1).sum())
            print(f"[pth {cfg.backend}] {k}: {rows} of {v.shape[0]} rows "
                  f"differ (padding), encode of 2^20 points "
                  f"{'bit-identical' if ok else 'DIFFERS'}")
        else:
            ok = torch.equal(v, loaded[k])
        (same if ok else differ).append(k)
    print(f"[pth {cfg.backend}] {os.path.getsize(path) / 2**20:.1f} MiB .pth "
          f"round trip: {len(same)} leaves bit-identical "
          f"{'(tables by their encode)' if padded else ''}, differ: {differ}")
    check(not differ, f".pth round trip ({cfg.backend}) changed {differ}")


def profile_steps(tr, n: int = 3):
    """torch.profiler over n train steps (after one warm-up step under the
    profiler): kernel launches, device busy time (kernels only), the host
    time and device-timeline span of the `step.*` and `render.*` ranges (the
    backward's kernels run on autograd's own thread, outside its range's
    span), and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for i in range(n + 1):
            tr.train_step()
            if i == n:
                torch.cuda.synchronize()
            prof.step()
    events = traced[0]
    # record_function ranges of the port
    stage = ("step.", "render.", "tensorf.", "ProfilerStep")
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not e.key.startswith(stage)),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / n
    print(f"[profile] one train step (flat_frac {tr.opts.flat_frac}, mean of "
          f"{n}): device busy {busy:.3f} ms in kernels, {launches:.0f} kernel "
          f"launches")
    spans = {}
    for e in events:   # a range's host time, and its span on the device
        if e.key.startswith(stage):
            host, dev = spans.get(e.key, (0.0, 0.0))
            if e.device_type == DeviceType.CUDA:
                dev += e.device_time_total
            else:
                host += e.cpu_time_total
            spans[e.key] = (host, dev)
    for key in sorted(spans):
        host, dev = spans[key]
        print(f"[profile]   {key:<18s} host {host / 1e3 / n:7.3f} ms, device "
              f"span {dev / 1e3 / n:7.3f} ms")
    for e in kernels[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / n:7.3f} ms "
              f"x{e.count // n:<4d} {e.key[:88]}")
    return {"busy_ms": busy, "launches": launches, "events": events, "n": n}


# phase 24: the GUI layer headless, on phase 7's teacher in the CLI's
# default window (800x800, OrbitCamera radius 3.0, fovy 60)
GUI_MOVES = [("orbit", 60.0, -20.0), ("scale", 1.0, 0.0), ("pan", 40.0, 25.0),
             ("orbit", -90.0, 10.0), ("orbit", 30.0, 45.0),
             ("scale", -2.0, 0.0), ("pan", -60.0, -10.0),
             ("orbit", 120.0, 0.0), ("orbit", 0.0, -60.0), ("scale", 1.5, 0.0),
             ("pan", 20.0, -40.0), ("orbit", -45.0, 30.0)]
GUI_SLICES = 4          # 24a's teacher train slices
GUI_FT_SLICES = 8       # 24b's finetune slices after pretraining
MIN_GUI_PSNR = 20.0     # 24b's student against the mapped teacher (PERF.md)
GUI_MESH_RES = 192      # SealViewer._export_mesh's default
GUI_BRUSH = dict(brush_pressure=0.05, attenuation_distance=0.05,
                 rgb=[1.0, 0.2, 0.1])
K1_NAMES = ("halo_encode", "halo_encode_bwd", "ladder_plan")


def counted(fn, total):
    """(fn(), {kernel: launches while fn ran}): each count read just before
    and just after fn (so that a path's totals keep counting); K1's and
    K4's are also added to `total`."""
    counters = kernel_counters()
    before = {k: f.launches for k, f in counters.items()}
    out = fn()
    torch.cuda.synchronize()
    launched = {k: f.launches - before[k] for k, f in counters.items()}
    for k in total:
        total[k] += launched[k]
    return out, launched


def tree_leaves(tree) -> dict:
    from seal3d_tpu_torch.train.checkpoint import flatten_tree

    return {k: v.clone() for k, v in flatten_tree(tree)}


def leaves_equal(tree, want: dict) -> bool:
    from seal3d_tpu_torch.train.checkpoint import flatten_tree

    got = dict(flatten_tree(tree))
    return set(got) == set(want) and all(torch.equal(got[k], v)
                                         for k, v in want.items())


def phase7_trainer(dev, ws, ckpt):
    """A Trainer of phase 7's CLI configuration on its 256x256 trainval
    split, phase 7's final checkpoint loaded -> (trainer, its CLI
    arguments)."""
    from seal3d_tpu_torch.config import (build_options, build_train_config,
                                         common_parser, grid_defaults,
                                         load_dataset)
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.models.ngp import NGPConfig
    from seal3d_tpu_torch.train.trainer import Trainer

    args = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--iters", str(TRAIN_STEPS), "--H", "256", "--W", "256",
                  "--workspace", ws])
    backend, log2t, gridtype = grid_defaults(args)
    fcfg = NGPConfig(bound=args.bound, log2_hashmap_size=log2t,
                     grid_backend=backend, gridtype=gridtype)
    tr = Trainer(ngp, fcfg, build_options(args), build_train_config(args),
                 dataset=load_dataset(args, "trainval", device=dev),
                 device=dev, name="ngp")
    tr.init_state()
    tr.load_checkpoint(ckpt)
    return tr, args


def gui_phase(dev, ws, teacher_ckpt, dn_tr):
    """Phase 24 -> (K1 forward, K1 backward, K4 launches on its paths): (a)
    the viewer on phase 7's teacher, (b) an edit through SealController,
    (c) the texture tool and SealViewer's mesh export, (d) the D-NeRF
    viewer on phase 23a's trainer, (e) --gui through the three CLIs."""
    from seal3d_tpu_torch.config import common_parser

    tr, args7 = phase7_trainer(dev, os.path.join(ws, "teacher"),
                               teacher_ckpt)
    view_args = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--workspace", ws])
    check((view_args.W, view_args.H, view_args.radius, view_args.fovy)
          == (800, 800, 3.0, 60.0), "the CLI's window defaults moved")
    totals = dict.fromkeys(K1_NAMES, 0)
    for launched in (gui_viewer_phase(dev, tr, view_args),
                     gui_edit_phase(dev, ws, tr, args7, view_args,
                                    teacher_ckpt),
                     gui_texture_mesh_phase(dev, ws, tr, view_args,
                                            teacher_ckpt),
                     gui_dnerf_phase(dn_tr, ws)):
        for k in totals:
            totals[k] += launched[k]
    gui_cli_phase(ws, teacher_ckpt)
    print(f"[gui] kernel launches over phase 24's paths: {totals}")
    return tuple(totals[k] for k in K1_NAMES)


def gui_viewer_phase(dev, tr, args) -> dict:
    """Phase 24a: NeRFViewer, headless, on phase 7's teacher: 12 previews
    between camera moves with K4 off, then on (a fresh camera and budget
    each time): ms a frame by the downscale the budget picked, K1 once a
    rendered chunk, K4 once a chunk's demand probe and once a rendered
    chunk, finite frames; a frame at downscale 1 bit-identical to
    render_image at the camera's pose and intrinsics; 4 training slices at
    the budget's steps; the train rays then equal a fresh trainer's."""
    from seal3d_tpu_torch.gui.state import (DynamicBudget, OrbitCamera,
                                            camera_intrinsics)
    from seal3d_tpu_torch.gui.viewer import NeRFViewer
    from seal3d_tpu_torch.train.trainer import Trainer

    v = NeRFViewer(args, tr)
    total = dict.fromkeys(K1_NAMES, 0)
    chunk = tr.cfg.eval_chunk
    for tl in (False, True):
        tr.eval_opts = dataclasses.replace(tr.eval_opts, tl_kernel=tl)
        v.cam = OrbitCamera(args.W, args.H, radius=args.radius,
                            fovy=args.fovy)
        v.budget = DynamicBudget()
        by_ds = {}
        for kind, dx, dy in GUI_MOVES:
            if kind == "scale":
                v.cam.scale(dx)
            else:
                getattr(v.cam, kind)(dx, dy)
            ds = v.budget.downscale
            t0 = time.perf_counter()
            buf, launched = counted(v.render_frame, total)
            ms = (time.perf_counter() - t0) * 1e3
            st = tr.render_stats[-1]
            n_chunks = -(-(args.H // ds) * (args.W // ds) // chunk)
            k4_want = n_chunks + st["chunks_rendered"] if tl else 0
            check(bool(np.isfinite(buf).all()) and st["nonfinite"] == 0,
                  f"[gui view] a non-finite preview at ds {ds}")
            check(launched["halo_encode"] == st["chunks_rendered"]
                  and launched["ladder_plan"] == k4_want
                  and not any(n for k, n in launched.items()
                              if k not in ("halo_encode", "ladder_plan")),
                  f"[gui view] launches {launched} for "
                  f"{st['chunks_rendered']} of {n_chunks} chunks")
            by_ds.setdefault(ds, []).append(
                (ms, launched["halo_encode"], launched["ladder_plan"]))
        print(f"[gui view] tl_kernel={tl}: {len(GUI_MOVES)} previews of the "
              f"{args.W}x{args.H} window; by downscale: " + "; ".join(
                  f"ds {d}: {len(r)} frames, ms {[round(x[0], 1) for x in r]}"
                  f", K1 {[x[1] for x in r]}, K4 {[x[2] for x in r]}"
                  for d, r in sorted(by_ds.items()))
              + f"; settled at ds {v.budget.downscale}")
    tr.eval_opts = dataclasses.replace(tr.eval_opts, tl_kernel=False)

    def preview_and_ref():
        v.budget.downscale = 1
        frame = counted(v.render_frame, total)[0].copy()
        with camera_intrinsics(tr, v.cam.intrinsics):
            ref = tr.render_image(v.cam.pose, args.H, args.W)[0]
        return frame, ref.cpu().numpy()

    # the gate runs under deterministic algorithms; the default mode is
    # reported beside it (one run of PR 13 saw 1 ulp there, which no
    # isolated repeat reproduced)
    diffs = {}
    for det in (False, True):
        torch.use_deterministic_algorithms(det)
        try:
            frame, ref = preview_and_ref()
        finally:
            torch.use_deterministic_algorithms(False)
        diffs[det] = (int((frame != ref).sum()),
                      float(np.abs(frame - ref).max()))
    print(f"[gui view] a ds-1 preview against render_image at the camera's "
          f"pose and intrinsics, (values that differ, max diff): default "
          f"mode {diffs[False]}, deterministic algorithms {diffs[True]}")
    check(diffs[True][0] == 0, "a ds-1 preview differs from render_image")

    rows = []
    for _ in range(GUI_SLICES):
        steps = v.budget.train_steps
        t0 = time.perf_counter()
        _, launched = counted(v.train_slice, total)
        ms = (time.perf_counter() - t0) * 1e3
        grid = tr.train_stats["grid_updates"]
        fwd_want = steps + grid_field_calls(grid, 1)
        check(launched["halo_encode_bwd"] == steps
              and launched["halo_encode"] == fwd_want,
              f"[gui view] a slice of {steps} steps launched {launched}")
        rows.append((steps, ms / steps, len(grid)))
    print(f"[gui view] {GUI_SLICES} training slices (steps, ms a step, "
          f"grid updates): {[(s, round(m, 2), g) for s, m, g in rows]}; "
          f"next slice {v.budget.train_steps} steps")
    fresh = Trainer(tr.field, tr.fcfg, tr.opts, tr.cfg, dataset=tr.dataset,
                    device=dev, name="never_previewed")
    rand = tr.draw_step_random()
    a, b = tr.sample_batch(rand), fresh.sample_batch(rand)
    same = all(torch.equal(a[k], b[k]) for k in ("rays_o", "rays_d", "gt"))
    print(f"[gui view] after {2 * len(GUI_MOVES) + 1} previews a train "
          f"step's rays equal a never-previewed trainer's: {same}")
    check(same, "a preview's intrinsics leaked into the train rays")
    return total


def gui_edit_phase(dev, ws, tr, args7, view, teacher_ckpt) -> dict:
    """Phase 24b: SealController on the teacher (paint_res 64): a stroke
    across the view's centre lifted, the brush config, start_edit at the
    Seal CLI's pretraining recipe with phase 14's 50 epochs, a slice and a
    student preview at a time until pretraining ends, then GUI_FT_SLICES
    finetune slices each with a preview; the student against the mapped
    teacher on 4 val poses (>= MIN_GUI_PSNR); override and reset bit for
    bit; save_checkpoint loads back."""
    from seal3d_tpu_torch import main_SealNeRF
    from seal3d_tpu_torch.config import common_parser, load_dataset
    from seal3d_tpu_torch.gui.state import (OrbitCamera, SealController,
                                            ToolState)
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.train.trainer import Trainer

    total = dict.fromkeys(K1_NAMES, 0)

    ctl = SealController(tr, ngp, tr.fcfg, tr.dataset,
                         workspace=os.path.join(ws, "edit"),
                         cam=OrbitCamera(view.W, view.H, radius=view.radius,
                                         fovy=view.fovy),
                         paint_res=64, seed=1)
    p0, e0 = tree_leaves(tr.state.params), tree_leaves(tr.state.ema_params)
    ctl.session.state = ToolState.BRUSH
    for x in (20, 28, 36, 44):
        ctl.painter.drag(x, 32)
    n_mask = len(ctl.painter.indices())
    n_pts, launched = counted(ctl.finish_stroke, total)
    print(f"[gui edit] a stroke of {n_mask} of 64x64 pixels lifted to "
          f"{n_pts} surface points (K1 {launched['halo_encode']})")
    check(n_pts > 50, f"[gui edit] only {n_pts} points lifted")
    for k, val in GUI_BRUSH.items():
        setattr(ctl.session, k, val)
    cfg = ctl.session.brush_config()
    sa = main_SealNeRF.add_seal_args(common_parser("chip_smoke")).parse_args(
        O_ARGV + ["--seal_config", "unused"])
    kw = dict(pretrain_epochs=SEAL_EPOCHS,
              pretrain_batch=sa.pretraining_batch_size,
              lr=sa.pretraining_lr,
              local_point_step=sa.pretraining_local_point_step,
              surrounding_point_step=sa.pretraining_surrounding_point_step,
              global_point_step=sa.pretraining_global_point_step)
    t0 = time.perf_counter()
    counted(lambda: ctl.start_edit(cfg, **kw), total)
    t_init = time.perf_counter() - t0
    st = ctl.student
    batches = sum(v["n_batches"] for v in st.pretrain_data.values())
    first_preview, pre, ft, previews = None, [], [], []

    def preview():
        return ctl.render_frame(view.H, view.W)

    while st.is_pretraining:
        t1 = time.perf_counter()
        _, launched = counted(ctl.train_slice, total)
        pre.append((time.perf_counter() - t1) * 1e3)
        check(launched["halo_encode_bwd"] == batches
              and launched["halo_encode"] == batches,
              f"[gui edit] a pretraining slice launched {launched}, "
              f"{batches} batches")
        t1 = time.perf_counter()
        (img, _), _ = counted(preview, total)
        previews.append((time.perf_counter() - t1) * 1e3)
        check(bool(np.isfinite(img).all()), "[gui edit] a non-finite preview")
        if first_preview is None:
            first_preview = time.perf_counter() - t0
    check(len(st.pretrain_losses) == SEAL_EPOCHS
          and bool(np.all(np.isfinite(st.pretrain_losses))),
          f"[gui edit] pretrain losses {st.pretrain_losses}")
    for i in range(GUI_FT_SLICES):
        steps = ctl.budget.train_steps
        t1 = time.perf_counter()
        _, launched = counted(ctl.train_slice, total)
        ms = (time.perf_counter() - t1) * 1e3
        check(launched["halo_encode_bwd"] == steps,
              f"[gui edit] a finetune slice of {steps} steps: {launched}")
        ft.append((steps, ms, launched["halo_encode"],
                   launched["halo_encode_bwd"], launched["ladder_plan"]))
        (img, _), _ = counted(preview, total)
        check(bool(np.isfinite(img).all()), "[gui edit] a non-finite preview")
    losses = st.pretrain_losses
    shells = {k: int(v["weight"].sum()) for k, v in st.pretrain_data.items()}
    print(f"[gui edit] start_edit (mapper, student, shells of {shells} "
          f"points, {batches} batches) {t_init:.3f} s; start_edit to the "
          f"first student preview {first_preview:.3f} s; "
          f"pretraining slices ms {np.median(pre):.1f} median "
          f"({min(pre):.1f}-{max(pre):.1f}), K1 {batches} + {batches} a "
          f"slice; pretrain loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"student previews ms {np.median(previews):.1f} median")
    print(f"[gui edit] finetune slices (steps, ms, K1 fwd, K1 bwd, K4; the "
          f"first with the proxied dataset and stage 2's set-up): "
          f"{[(s, round(m, 1), f, b, k) for s, m, f, b, k in ft]}; ms a step "
          f"after the first {np.median([m / s for s, m, *_ in ft[1:]]):.2f} "
          f"median; the budget at ds {ctl.budget.downscale}")
    val = load_dataset(args7, "val", device=dev)
    ps, n_px = edit_gates(dev, st, teacher_ckpt, val, "[gui edit]",
                          gate=False, plain_teacher=tr)
    check(ps >= MIN_GUI_PSNR, f"[gui edit] student {ps:.2f} dB against the "
                              f"mapped teacher < {MIN_GUI_PSNR}")
    sp, se = tree_leaves(st.state.params), tree_leaves(st.state.ema_params)
    ctl.override_teacher()
    over = leaves_equal(tr.state.params, sp) and leaves_equal(
        tr.state.ema_params, se)
    ctl.reset_teacher()
    reset = leaves_equal(tr.state.params, p0) and leaves_equal(
        tr.state.ema_params, e0)
    path = ctl.save_checkpoint()
    back = Trainer(tr.field, tr.fcfg, tr.opts, tr.cfg, device=dev,
                   name="loaded_back")
    back.load_checkpoint(path)
    loaded = leaves_equal(back.state.params, p0) and leaves_equal(
        back.state.ema_params, e0)
    print(f"[gui edit] override: the teacher's leaves are the student's, "
          f"bit for bit {over}; reset: the snapshot's {reset}; "
          f"save_checkpoint {os.path.basename(path)} loads back {loaded}")
    check(over and reset and loaded, "[gui edit] override / reset / save")
    return total


def gui_texture_mesh_phase(dev, ws, tr, view, teacher_ckpt) -> dict:
    """Phase 24c: the texture tool (a PNG written by the port's writer, the
    image plane from three lifted corners of a stroke, one pretraining
    slice, finite renders), then SealViewer on the Seal CLI's arguments (its
    teacher loaded from --teacher_ckpt) and its mesh export at
    GUI_MESH_RES^3."""
    from seal3d_tpu_torch.config import (build_options, common_parser,
                                         grid_defaults)
    from seal3d_tpu_torch import main_SealNeRF
    from seal3d_tpu_torch.gui.state import (OrbitCamera, SealController,
                                            ToolState)
    from seal3d_tpu_torch.gui.viewer import SealViewer
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.models.ngp import NGPConfig
    from seal3d_tpu_torch.train.trainer import Trainer
    from seal3d_tpu_torch.train.video import write_png

    total = dict.fromkeys(K1_NAMES, 0)

    os.makedirs(ws, exist_ok=True)
    png = os.path.join(ws, "texture.png")
    yy, xx = np.mgrid[0:64, 0:64]
    checker = ((xx // 8 + yy // 8) % 2).astype(np.uint8)
    write_png(png, np.stack([checker * 230, np.full_like(checker, 40),
                             255 - checker * 200], -1).astype(np.uint8))
    ctl = SealController(tr, ngp, tr.fcfg, tr.dataset,
                         workspace=os.path.join(ws, "texture"),
                         cam=OrbitCamera(view.W, view.H, radius=view.radius,
                                         fovy=view.fovy),
                         paint_res=64, seed=2)
    ctl.session.state = ToolState.TEXTURE
    for x in (22, 32, 42):
        ctl.painter.drag(x, 32)
    pts = counted(ctl.lift_mask, total)[0]
    ctl.painter.clear()
    corners = np.stack([pts[np.argmin(pts[:, 0] + pts[:, 1])],
                        pts[np.argmax(pts[:, 0] - pts[:, 1])],
                        pts[np.argmax(pts[:, 1] - pts[:, 0])]])
    area = float(np.linalg.norm(np.cross(corners[1] - corners[0],
                                         corners[2] - corners[0])))
    ctl.session.paint(corners)
    ctl.session.paint(pts)
    cfg = ctl.texture_config(png)
    counted(lambda: ctl.start_edit(
        cfg, pretrain_epochs=1, pretrain_batch=2**19, local_point_step=0.01,
        surrounding_point_step=0.02, global_point_step=0.1), total)
    check(counted(ctl.train_slice, total)[0],
          "[gui texture] the slice did not run")

    def preview():
        ctl.budget.downscale = 2
        return counted(lambda: ctl.render_frame(view.H, view.W), total)[0]

    img_s, dep_s = preview()
    ctl.show_student = False
    img_t, _ = preview()
    finite = all(bool(np.isfinite(a).all()) for a in (img_s, dep_s, img_t))
    print(f"[gui texture] {len(pts)} lifted stroke points, corners o/w/h "
          f"{np.round(corners, 3).tolist()} (plane area {area:.4f}); the "
          f"mapper's flags {sorted(ctl.student.mapper.flags)}; one slice; "
          f"student and teacher previews finite {finite}, mean |d| "
          f"{float(np.abs(img_s - img_t).mean()):.4f}")
    check(finite and area > 1e-3 and "image" in ctl.student.mapper.flags,
          "[gui texture] corners, mapper or renders")
    ctl.reset_teacher()

    ws_v = os.path.join(ws, "viewer")
    here = os.path.dirname(os.path.abspath(__file__))
    args = main_SealNeRF.add_seal_args(common_parser("chip_smoke")).parse_args(
        O_ARGV + ["--iters", str(TRAIN_STEPS), "--H", "256", "--W", "256",
                  "--seal_config", os.path.join(here, "seal_config_bbox"),
                  "--teacher_ckpt", teacher_ckpt, "--teacher_workspace",
                  os.path.join(ws_v, "teacher"), "--workspace", ws_v])
    backend, log2t, gridtype = grid_defaults(args)
    fcfg = NGPConfig(bound=args.bound, log2_hashmap_size=log2t,
                     grid_backend=backend, gridtype=gridtype)

    def make_trainer(tcfg, ds, name):     # main_SealNeRF's
        return Trainer(ngp, fcfg, build_options(args), tcfg, dataset=ds,
                       seed=args.seed, device=args.device, name=name,
                       use_dense=args.dense_render)

    v = SealViewer(args, ngp, fcfg, make_trainer)
    check(int(v.trainer.state.step) == TRAIN_STEPS,
          "[gui mesh] SealViewer's teacher is not --teacher_ckpt's")
    t0 = time.perf_counter()
    (verts, tris), launched = counted(lambda: v._export_mesh(GUI_MESH_RES),
                                      total)
    mesh_s = time.perf_counter() - t0
    chunks = -(-GUI_MESH_RES**3 // 2**16)
    inside = bool(np.all(np.abs(verts) <= args.bound + 1e-5))
    print(f"[gui mesh] SealViewer on the Seal CLI's arguments (teacher "
          f"--teacher_ckpt, step {int(v.trainer.state.step)}); "
          f"_export_mesh at {GUI_MESH_RES}^3: {len(verts)} verts, "
          f"{len(tris)} tris, {mesh_s:.2f} s, K1 {launched['halo_encode']} "
          f"launches ({chunks} chunks of 2^16 points), vertices inside the "
          f"bound {inside}")
    check(len(verts) > 1000 and inside
          and launched["halo_encode"] == chunks, "[gui mesh] the mesh")
    return total


def gui_dnerf_phase(dn_tr, ws) -> dict:
    """Phase 24d: the time-aware NeRFViewer on phase 23a's D-NeRF trainer:
    frames at t = 0, 0.5 and 1 (downscale 1 of the 256x256 window) differ,
    K1 once a rendered chunk."""
    from seal3d_tpu_torch.config import common_parser
    from seal3d_tpu_torch.gui.viewer import NeRFViewer

    args, _ = common_parser("chip_smoke").parse_known_args(
        DN_ARGV + ["--workspace", ws])
    v = NeRFViewer(args, dn_tr)
    check(v._time_aware, "[gui dnerf] the viewer has no time slider")
    total = dict.fromkeys(K1_NAMES, 0)
    frames, ms = [], []
    for t in (0.0, 0.5, 1.0):
        v.time_value, v.budget.downscale = t, 1
        t0 = time.perf_counter()
        buf, launched = counted(v.render_frame, total)
        ms.append((time.perf_counter() - t0) * 1e3)
        st = dn_tr.render_stats[-1]
        check(bool(np.isfinite(buf).all())
              and launched["halo_encode"] == st["chunks_rendered"]
              and launched["halo_encode_bwd"] == 0,
              f"[gui dnerf] frame at t={t}: {launched}, {st}")
        frames.append(buf.copy())
    d = [float(np.abs(frames[i] - frames[j]).mean())
         for i, j in ((0, 1), (1, 2), (0, 2))]
    print(f"[gui dnerf] frames at t = 0, 0.5, 1 ({args.W}x{args.H}, ds 1): "
          f"ms {[round(m, 1) for m in ms]}, K1 a frame "
          f"{dn_tr.render_stats[-1]['chunks_rendered']}, mean |d| between "
          f"them {[round(x, 5) for x in d]}")
    check(min(d) > 1e-4, "[gui dnerf] frames at other times do not differ")
    return total


def gui_cli_phase(ws, teacher_ckpt):
    """Phase 24e: `--gui` through main_nerf, main_dnerf and main_SealNeRF
    raises the RuntimeError naming dearpygui before a train step (this
    machine has no dearpygui; where it imports, --gui would open a window,
    and (e) is not run)."""
    from seal3d_tpu_torch import gui, main_dnerf, main_nerf, main_SealNeRF

    if gui.HAS_DPG:
        print("[gui cli] dearpygui imports here: --gui opens a window, so "
              "(e) is not run")
        return
    here = os.path.dirname(os.path.abspath(__file__))
    small = ["--H", "64", "--W", "64", "--num_views", "4"]
    runs = {
        "main_nerf": (main_nerf.main, O_ARGV + small),
        "main_dnerf": (main_dnerf.main, DN_ARGV + small),
        "main_SealNeRF": (main_SealNeRF.main, O_ARGV + small + [
            "--seal_config", os.path.join(here, "seal_config_bbox"),
            "--teacher_ckpt", teacher_ckpt, "--teacher_workspace",
            os.path.join(ws, "cli_teacher")]),
    }
    for name, (fn, argv) in runs.items():
        out = os.path.join(ws, f"cli_{name}")
        msg = ""
        counters = kernel_counters()
        bwd0 = counters["halo_encode_bwd"].launches
        try:
            fn(argv + ["--workspace", out, "--gui"])
        except RuntimeError as e:
            msg = str(e)
        steps = counters["halo_encode_bwd"].launches - bwd0
        print(f"[gui cli] {name} --gui: RuntimeError {msg!r}; train steps "
              f"{steps}, checkpoints written "
              f"{os.path.exists(os.path.join(out, 'checkpoints'))}")
        check("dearpygui" in msg and steps == 0
              and not os.path.exists(os.path.join(out, "checkpoints")),
              f"[gui cli] {name} --gui")



# phase 25: the multi-device layer on one card. The -O NGP field at full
# width (two grids stacked at F=4, 16 levels, T=2^15 wrap) at bench.py's
# operating point (bound 1, max_steps 512, 256 candidates, budget 48, 4096
# rays), starting in the flat branch (flat_frac 0.5) with warm budget
# retunes, on the procedural scene. Gloo ranks that share the card measure
# the path's cost and its collective bytes, not scaling.
PAR_VIEWS, PAR_HW, PAR_VAL = 24, 128, 4
PAR_FIRST = 16          # steps after the first grid update, before the next
PAR_LOOP = 100          # (b)'s steps with grid updates, before val PSNR
PAR_WORLD1_STEPS = 8    # (a)
PAR_TIMEOUT = 300.0     # each launch's own timeout
# (b)'s val PSNR: dp2 and one process at each seed (init and draws), the
# gap held on the mean over the seeds to the north star's 0.3 dB. A pair of
# runs on the card differs by the order of K1's atomic sums alone, and that
# noise grows through Adam and the grid updates: single pairs read 0.03-0.45
# dB apart after 216 steps, so one pair cannot hold 0.3 dB; the mean over
# four seeds of dp2 against the mean of two one-process runs has a quarter
# of a pair's variance. The two one-process runs of each seed are the
# control, printed beside the gate.
PAR_SEEDS = (0, 1, 2, 3)
PAR_PSNR_GAP = 0.3
# `step_agreement`: a run on a mesh against a run without it, the first
# step's gradients (relative L2) and the params' mean |diff| as a share of
# their mean |change| over the steps. Measured on the card without a fault:
# gradients <= 1.7e-5, share <= 3e-4; with a planted fault (a CPU run at a
# cut size, 16 steps, where no fault reads 1e-7): a rank's table gradient
# left out of the sum 1e-2 and 0.15, the MLP weights' 5e-2 and 0.011
PAR_GRAD_TOL = 1e-3
PAR_PARAM_SHARE = 0.003
PAR_ENCODE_ROWS = 2**17


def parallel_spec(dev):
    from seal3d_tpu_torch.data.synthetic import SyntheticScene
    from seal3d_tpu_torch.models.ngp import NGPConfig
    from seal3d_tpu_torch.render.renderer import RenderOptions
    from seal3d_tpu_torch.train.trainer import TrainConfig

    scene = SyntheticScene()
    ds = scene.make_dataset(n_views=PAR_VIEWS, h=PAR_HW, w=PAR_HW, seed=0,
                            device=dev)
    val = scene.make_dataset(n_views=PAR_VAL, h=PAR_HW, w=PAR_HW, seed=1,
                             device=dev)
    spec = {
        "fcfg": NGPConfig(bound=1.0, log2_hashmap_size=15,
                          grid_backend="halo", gridtype="wrap"),
        "opts": RenderOptions(bound=1.0, dt_gamma=0.0, max_steps=512,
                              budget_per_ray=48, num_candidates=256,
                              min_near=0.05, coarse_steps=64, flat_frac=0.5),
        "tcfg": TrainConfig(lr=1e-2, max_steps=30000, num_rays=4096,
                            eval_chunk=2**15, eval_budget_per_ray=48,
                            eval_flat_frac=0.5, random_bg=False,
                            adaptive_budget=True, retune_warm=True),
        "dataset": ds, "grid_first": True}
    return spec, val


def mean_diff(a: dict, b: dict) -> float:
    """Mean |a - b| over every entry of every leaf."""
    return float(np.concatenate([np.abs(a[k] - v).ravel()
                                 for k, v in b.items()]).mean())


def rel_l2(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every entry of every leaf."""
    d = np.concatenate([(a[k] - v).ravel() for k, v in b.items()])
    n = np.concatenate([v.ravel() for v in b.values()])
    return float(np.linalg.norm(d) / max(np.linalg.norm(n), 1e-30))


def step_agreement(r: dict, ref: dict, floor: dict, tag: str, loss_tol):
    """Hold a run on a mesh (r) against a run without it in this process
    (ref) on the same StepRandom, beside a run without it in r's process
    (floor). Two runs differ, the more so in two processes: K1's backward
    and the composite's backward sum with atomics, the MLP rounds
    cotangents to bf16 after those sums, and Adam takes a full step on an
    entry whose gradient is that noise, so that after 8 steps two runs
    agree to 1e-5 of a leaf's largest entry at a few entries in ten and
    their mean |diff| varies tenfold between calls. Gates: the loss of
    every step within loss_tol relative; the first step's gradients within
    PAR_GRAD_TOL relative (L2 over all leaves; the floor reads ~2e-5); the
    params' mean |diff| after the steps within PAR_PARAM_SHARE of their
    mean |change| over the steps. A wrong reduction misses by far more: a
    lost rank's or a doubled gradient is O(1) off. -> None; prints the
    numbers."""
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(r["losses"],
                                                       ref["losses"]))
    g, g0 = rel_l2(r["grads"], ref["grads"]), rel_l2(floor["grads"],
                                                     ref["grads"])
    p, p0 = (mean_diff(r["params"], ref["params"]),
             mean_diff(floor["params"], ref["params"]))
    print(f"[parallel {tag}] {len(r['losses'])} steps against no mesh: loss "
          f"rel {loss_rel:.3e}; first step's gradients rel L2 {g:.3e} (a run "
          f"without the mesh in the rank's process: {g0:.3e}); params mean "
          f"|diff| {p:.3e} ({p0:.3e}) against their mean |change| "
          f"{ref['moved']:.3e}")
    check(loss_rel <= loss_tol, f"({tag}) loss differs by {loss_rel}")
    check(g <= PAR_GRAD_TOL, f"({tag}) first-step gradients {g} from the "
                             f"run without the mesh (floor {g0})")
    check(p <= PAR_PARAM_SHARE * ref["moved"],
          f"({tag}) params {p} from the run without the mesh, of a mean "
          f"change {ref['moved']}")


def log_bytes(log) -> int:
    return sum(c.nbytes for c in log)


def parallel_phase(dev):
    """Phase 25 -> the kernel-table row of K1 over each rank's level range
    (dp2 x tp2 on one card). (a) NCCL at world size 1: 8 steps through the
    collective code against the same 8 steps without a mesh
    (`step_agreement`: the loss 1e-5 relative at every step; the first
    step's gradients within PAR_GRAD_TOL, the params' mean |diff| within
    PAR_PARAM_SHARE of their mean |change|, each printed beside a run
    without the mesh in the rank's process). (b) dp2 over gloo, two ranks
    on the card, against one process with pack_shards=2 on the same
    StepRandom: the 16 steps before the second grid update
    (`step_agreement`, the loss 1e-4 relative), then PAR_LOOP steps with
    grid updates; at each of PAR_SEEDS the two ranks end with the same
    state, bit for bit (`state_fingerprint`), and the mean over the seeds
    of dp2's val PSNR less the one-process runs' is within PAR_PSNR_GAP
    (two one-process runs a seed, one in each rank's process, are the
    control); the step log holds no batch-scale collective. (c) dp2 x tp2 on
    `halo` over gloo, four ranks: the level-sharded encode on 2^17 random
    rows against K1 unsharded (features 1e-5, each shard's table gradient
    1e-5 of the largest entry); 16 steps with a finite loss within 1e-3
    relative of (b)'s, the same state on every rank after them; no
    table-sized collective on 'model'. Every rank
    holds its last step's first K1 launch against halo_encode_plain
    (1e-5)."""
    import dataclasses as dc

    from seal3d_tpu_torch.ops.halo_encode import (halo_encode,
                                                  halo_encode_levels,
                                                  halo_encode_plain)
    from seal3d_tpu_torch.parallel import programs
    from seal3d_tpu_torch.parallel.launch import launch
    from seal3d_tpu_torch.parallel.mesh import (find_batch_collectives,
                                                find_table_collectives)
    from seal3d_tpu_torch.train.checkpoint import level_shard

    spec, val = parallel_spec(dev)
    n_rays, cands = spec["tcfg"].num_rays, spec["opts"].num_candidates
    k1_errs = []

    # --- (a) NCCL, world size 1
    t0 = time.perf_counter()
    a_spec = dict(spec, steps=PAR_WORLD1_STEPS, k1_check=True)
    ref = programs.train_rank(dev, a_spec)
    ((ref2, a),) = launch(programs.run_all, 1, args=(
        [(programs.train_rank, a_spec),
         (programs.train_rank, dict(a_spec, mesh=(1,)))],),
        backend="nccl", device="cuda", timeout=PAR_TIMEOUT)
    k1_errs.append(a["k1_err"])
    print(f"[parallel a] nccl world 1: K1 {a['k1_err']:.3e}; collectives a "
          f"step {len(a['log'])} ({log_bytes(a['log'])} bytes); "
          f"{time.perf_counter() - t0:.1f} s")
    step_agreement(a, ref, ref2, "a", 1e-5)

    # --- (b) dp2 over gloo, two ranks on the card
    t0 = time.perf_counter()
    b_spec = dict(spec, steps=PAR_FIRST, loop=PAR_LOOP, eval=val,
                  k1_check=True)
    one_spec = dict(b_spec, opts=dc.replace(spec["opts"], pack_shards=2,
                                            march_two_level=False))
    one = programs.train_rank(dev, dict(one_spec, loop=0, eval=None))
    jobs = []
    for seed in PAR_SEEDS:    # one process, then dp2, on each seed
        jobs += [(programs.train_rank, dict(one_spec, seed=seed)),
                 (programs.train_rank, dict(b_spec, seed=seed, mesh=(2,)))]
    runs = launch(programs.run_all, 2, args=(jobs,), backend="gloo",
                  device="cuda", timeout=PAR_TIMEOUT)
    n_seeds = len(PAR_SEEDS)
    singles = [[rr[2 * i] for rr in runs] for i in range(n_seeds)]
    dp2 = [[rr[2 * i + 1] for rr in runs] for i in range(n_seeds)]
    gaps = [d[0]["psnr"] - (s0["psnr"] + s1["psnr"]) / 2
            for d, (s0, s1) in zip(dp2, singles)]
    control = [s0["psnr"] - s1["psnr"] for s0, s1 in singles]
    gap, ctrl = float(np.mean(gaps)), float(np.mean(control))
    b = dp2[0]
    r = b[0]
    k1_step = sum(r["launches"].values()) / r["steps"]
    def dbs(xs, sign=""):
        return "[" + ", ".join(f"{float(x):{sign}.3f}" for x in xs) + "]"

    print(f"[parallel b] gloo dp2 on one card, {PAR_FIRST} + {PAR_LOOP} "
          f"steps at seeds {list(PAR_SEEDS)}: val PSNR dp2 "
          f"{dbs(d[0]['psnr'] for d in dp2)} dB, one process "
          f"{[dbs(x['psnr'] for x in s) for s in singles]}; dp2 less one "
          f"process {dbs(gaps, '+')}, mean {gap:+.3f} dB (gate "
          f"{PAR_PSNR_GAP}); control, one process less one process "
          f"{dbs(control, '+')}, mean {ctrl:+.3f} dB; "
          f"{r['step_ms']:.2f} ms a step (one process "
          f"{singles[0][0]['step_ms']:.2f}), flat_frac "
          f"{r['loop_flat_frac']}; a step: {len(r['log'])} collectives, "
          f"{log_bytes(r['log'])} bytes, K1 launches {k1_step:.1f} a rank; "
          f"{time.perf_counter() - t0:.1f} s")
    for one2, r in zip(singles[0], b):
        step_agreement(r, one, one2, "b", 1e-4)
    for seed, d in zip(PAR_SEEDS, dp2):
        check(d[0]["fingerprint"] == d[1]["fingerprint"],
              f"(b) seed {seed}: the ranks' states differ after the loop")
        for r in d:
            check(r["pack_shards"] == 2, f"(b) pack_shards {r['pack_shards']}")
            bad = find_batch_collectives(r["log"], n_rays * cands // 2)
            check(not bad, f"(b) batch-scale collectives: {bad}")
            k1_errs.append(r["k1_err"])
    check(abs(gap) <= PAR_PSNR_GAP,
          f"(b) val PSNR of dp2 less one process, mean over seeds {gap:+.3f}"
          f" dB (control {ctrl:+.3f})")

    # --- (c) dp2 x tp2 on halo over gloo, four ranks on the card
    t0 = time.perf_counter()
    fcfg = dc.replace(spec["fcfg"], grid_shard_levels=True)
    cfg = fcfg.grid
    levels, t_rows = cfg.num_levels, 2**cfg.log2_hashmap_size
    rng = np.random.default_rng(25)
    m = PAR_ENCODE_ROWS
    enc = {"cfg": cfg, "mesh": (2, 2),
           "table": rng.uniform(-1, 1, (levels * t_rows, 4)).astype(
               np.float32),
           "x": rng.uniform(0, 1, (m, 3)).astype(np.float32),
           "valid": rng.uniform(size=m) >= 0.25,
           "g": rng.uniform(-1, 1, (m, levels * 4)).astype(np.float32)}
    c_spec = dict(spec, fcfg=fcfg, steps=PAR_FIRST, k1_check=True,
                  mesh=(2, 2))
    c = launch(programs.run_all, 4, args=([(programs.encode_rank, enc),
                                           (programs.train_rank, c_spec)],),
               backend="gloo", device="cuda", timeout=PAR_TIMEOUT)
    whole = torch.from_numpy(enc["table"]).to(dev).requires_grad_()
    xw = torch.from_numpy(enc["x"]).to(dev)
    vw = torch.from_numpy(enc["valid"]).to(dev)
    ref_out = halo_encode(whole, xw, vw, cfg).reshape(m, -1)
    ref_out.backward(torch.from_numpy(enc["g"]).to(dev))
    ref_out = ref_out.detach().cpu().numpy()
    ref_grad = whole.grad.cpu().numpy()
    scale = float(np.abs(ref_grad).max())
    per = levels // 2
    feat_err = grad_err = loss_rel = 0.0
    launches, tables, finite = 0, [], True
    for e, r in c:
        i, j = e["coords"]
        rows = slice(i * m // 2, (i + 1) * m // 2)
        feat_err = max(feat_err, float(np.abs(e["out"] - ref_out[rows]).max()))
        shard = ref_grad[j * per * t_rows:(j + 1) * per * t_rows]
        grad_err = max(grad_err, float(np.abs(e["grad"] - shard).max()))
        tables.extend(find_table_collectives(e["log"] + r["log"],
                                             levels * t_rows, 2))
        finite = finite and all(np.isfinite(r["losses"]))
        loss_rel = max([loss_rel] + [abs(x - y) / abs(y) for x, y in
                                     zip(r["losses"], b[0]["losses"])])
        k1_errs.append(r["k1_err"])
        launches += r["launches"]["halo_encode_levels"]
    e0, r0 = c[0]
    model_bytes = sum(x.nbytes for x in r0["log"] if x.axis == "model")
    print(f"[parallel c] gloo dp2 x tp2 (halo, 8 levels a rank): encode of "
          f"{m} rows features max_abs_err {feat_err:.3e}, shard gradients "
          f"{grad_err:.3e} (rel {grad_err / scale:.3e}); {PAR_FIRST} steps "
          f"loss rel to (b) {loss_rel:.3e}; a step: {len(r0['log'])} "
          f"collectives, {log_bytes(r0['log'])} bytes ({model_bytes} over "
          f"'model'), level-range K1 launches "
          f"{r0['launches']['halo_encode_levels'] / r0['steps']:.1f} a rank; "
          f"{time.perf_counter() - t0:.1f} s")
    check(feat_err <= TOL, f"(c) sharded features differ by {feat_err}")
    check(grad_err <= BWD_RTOL * scale,
          f"(c) shard gradients differ by {grad_err} of {scale}")
    check(finite, "(c) non-finite loss")
    check(loss_rel <= 1e-3, f"(c) loss differs from (b)'s by {loss_rel}")
    check(not tables, f"(c) table-sized collectives over 'model': {tables}")
    check(len({r["fingerprint"] for _, r in c}) == 1,
          "(c) the ranks' states differ after the steps")
    check(max(k1_errs) <= TOL, f"a rank's K1 disagrees with plain: "
                               f"{max(k1_errs)}")

    # the kernel's row: a rank's level-range forward on the rows and levels
    # its last step handed K1
    case = r0["k1_case"]
    rng_ = case["levels"]
    full = np.concatenate([r0["params"]["encoder"],
                           r0["params"]["encoder_color"]], -1)
    table = torch.from_numpy(np.ascontiguousarray(level_shard(
        torch.from_numpy(full), cfg, 2, rng_.start // per).numpy())).to(dev)
    x = torch.from_numpy(case["x"]).to(dev)
    valid = (None if case["valid"] is None
             else torch.from_numpy(case["valid"]).to(dev))
    with torch.no_grad():
        err = float((halo_encode_levels(table, x, valid, cfg, rng_.start,
                                        len(rng_))
                     - halo_encode_plain(table, x, valid, cfg, rng_))
                    .abs().max())
        ms = time_device_ms(lambda: halo_encode_levels(
            table, x, valid, cfg, rng_.start, len(rng_)))
        plain_ms = busy_ms(lambda: halo_encode_plain(table, x, valid, cfg,
                                                     rng_))
    n_valid = x.shape[0] if valid is None else int(valid.sum())
    print(f"[parallel k1] a rank's level range {rng_.start}-{rng_.stop - 1}"
          f" on its step's {x.shape[0]} rows ({n_valid} valid): "
          f"{ms:.4f} ms device, plain {plain_ms:.3f} ms")
    return {"name": "halo_encode_levels (dp2 x tp2 ranks)", "route": "cuda",
            "source": "seal3d_tpu_torch/csrc/halo_encode.cu",
            "replaces": "seal3d_tpu/ops/pallas/halo_encode.py:497",
            "launches": launches,
            "max_abs_err": max(err, feat_err, *k1_errs),
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            **encode_bound(x.shape[0], n_valid, len(rng_), 4,
                           table.shape[0], valid_bytes=1)}



# phase 26: the march options of RenderOptions on phase 7's trained state
MO_STEPS = 16           # (b)'s train steps under each option
MO_LOSS_RTOL = 1e-4     # (b): a step's loss on the card vs the CPU
MO_GRAD_TOL = 1e-2      # (b): its gradients, of each leaf's largest entry
MO_NEAR_DB = 1.0        # span_adaptive and the grouped march: other samples
MO_MIN_DB = 20.0        # the legacy and two-level train marches: a floor
MO_MARCH_ATOL = 1e-6    # (a): the card's floats on valid slots vs the CPU's
MO_PROXY_VIEWS = 2      # (c): the views proxy_datasets renders


def march_options_marches(opts, n):
    """{name: march(rays_o, rays_d, bitfield, aabb, jitter) -> MarchedRays}
    of the train march under each option of phase 26 at opts' train point,
    n rays."""
    from seal3d_tpu_torch.ops import raymarch as rm
    from seal3d_tpu_torch.render.renderer import flat_budget

    budget, k = flat_budget(n, opts), opts.budget_per_ray
    one = dict(bound=opts.bound, cascades=opts.cascades,
               max_steps=opts.max_steps, min_near=opts.min_near,
               num_candidates=opts.num_candidates)
    flat = dict(one, k=k, budget=budget, dt_gamma=opts.dt_gamma,
                occ_stride=opts.occ_stride, coarse_steps=opts.coarse_steps)
    grouped = dict(one, k=k, budget=budget, occ_stride=opts.occ_stride,
                   coarse_steps=opts.coarse_steps)

    def f(fn, **kw):
        return lambda ro, rd, bf, aabb, jit: fn(ro, rd, bf, aabb=aabb,
                                                perturb=jit, **kw)

    return {
        "sort": f(rm.march_rays_flat, **flat),
        "span_adaptive": f(rm.march_rays_flat, span_adaptive=True, **flat),
        "group_compact": f(rm.march_rays_flat_grouped, **grouped),
        "legacy_flat": f(rm.march_rays, dt_gamma=opts.dt_gamma,
                         budget=n * k, **one),
        "two_level_train": f(rm.march_rays_flat_2level, k=k, budget=budget,
                             occ_stride=opts.occ_stride,
                             coarse_steps=opts.coarse_steps,
                             group=opts.tl_group, kg=opts.tl_kg,
                             pool=opts.tl_pool, **one),
    }


def packs_differ(a, b, atol) -> list:
    """The fields of two MarchedRays that differ: valid, ray_id, offsets
    and counts exactly; the floats on a's valid slots beyond atol."""
    bad = [f for f in ("valid", "ray_id", "offsets", "counts")
           if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())]
    v = a.valid.cpu()
    for f in ("xyzs", "dirs", "deltas", "ts"):
        x, y = getattr(a, f).cpu()[v], getattr(b, f).cpu()[v]
        if x.shape != y.shape or float((x - y).abs().max()) > atol:
            bad.append(f)
    return bad


def step_card_vs_cpu(t, rand) -> dict:
    """One train step's loss and gradients from t's state on the card
    against the same step on the CPU (the kernels' plain versions there):
    the loss's relative difference, the sample counts, and the leaf whose
    gradient is furthest off, as a share of that leaf's largest entry on
    the CPU. No parameter moves."""
    from seal3d_tpu_torch.train.checkpoint import flatten_tree, map_tree

    st, batch = t.state, t.sample_batch(rand)

    def step(to):
        loss, grads, out = t.loss_and_grads(
            map_tree(st.params, lambda _, x: to(x)),
            type(st.occ)(*map(to, st.occ)),
            {k: to(v) for k, v in batch.items()}, to(rand.jitter))
        return (float(loss), dict(flatten_tree(grads)),
                int(out["num_samples"]))

    (lg, gg, ng), (lc, gc, nc) = step(lambda x: x), step(
        lambda x: None if x is None else x.cpu())
    errs = {k: float((gg[k].cpu() - v).abs().max())
            / max(float(v.abs().max()), 1e-30) for k, v in gc.items()}
    worst = max(errs, key=errs.get)
    return {"loss_rel": abs(lg - lc) / abs(lc), "samples": (ng, nc),
            "worst": worst, "grad_err": errs[worst]}


def march_options_phase(dev, tr7):
    """Phase 26 -> (K1 forward, K1 backward launches): the march options of
    RenderOptions at the full -O width on phase 7's trained state. (a) One
    4096-ray train batch (its jitter included) through each option's train
    march on the card and the same functions on the CPU: valid, ray_id,
    offsets and counts exact, floats on valid slots within MO_MARCH_ATOL.
    (flat_select='gather' packs by the sort pack in the port: nothing of
    its own to run.) (b) Under each option (span_adaptive, group_compact,
    compaction flat, march_two_level) and the default: the first step's
    loss and gradients on the card against the same step on the CPU
    (MO_LOSS_RTOL, MO_GRAD_TOL of each leaf's largest entry, equal sample
    counts), then MO_STEPS train steps from a copy of the state, on the
    draws of the default copy's: K1 launches equal to the field calls,
    finite losses, one 256x256 val view's PSNR beside the default copy's
    (gates MO_NEAR_DB, MO_MIN_DB).
    The legacy copy retunes no budget and probes no eval demand. (c) A
    SealTrainer (bbox) on the state with compaction flat renders one
    teacher view and proxies MO_PROXY_VIEWS views: no demand probe, no
    per-chunk fractions, K1 once a chunk; the student (the teacher's
    params, unedited) against the teacher printed."""
    from seal3d_tpu_torch.config import common_parser, load_dataset
    from seal3d_tpu_torch.data.provider import NeRFDataset
    from seal3d_tpu_torch.seal.mappers import build_mapper, load_mapper_config
    from seal3d_tpu_torch.seal.trainer import SealTrainer
    from seal3d_tpu_torch.train.checkpoint import map_tree
    from seal3d_tpu_torch.train.trainer import Trainer

    opts, ds = tr7.opts, tr7.dataset
    args = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--H", "256", "--W", "256"])
    val = load_dataset(args, "val", device=dev)
    gt = torch.as_tensor(val.images[0], device=dev).float() / 255.0
    cfg = dataclasses.replace(tr7.cfg, workspace=None)

    def copy(state):
        return map_tree(state, lambda _, t: t.clone())

    def trainer(o, name, cls=Trainer, **kw):
        t = cls(tr7.field, tr7.fcfg, o, cfg, dataset=ds, device=dev,
                name=name, **kw)
        t.state = copy(tr7.state)
        return t

    # --- (a) the marches of one real train batch, card against CPU
    t_phase = t0 = time.perf_counter()
    base = trainer(opts, "mo_default")
    rands = [base.draw_step_random() for _ in range(MO_STEPS)]
    batch = base.sample_batch(rands[0])
    st = tr7.state
    on_card = (batch["rays_o"], batch["rays_d"], st.occ.bitfield,
               tr7._march_aabb(st.occ.occ_aabb), rands[0].jitter)
    on_cpu = [a.cpu() for a in on_card]
    n = on_card[0].shape[0]
    for name, fn in march_options_marches(opts, n).items():
        with torch.no_grad():
            card, cpu = fn(*on_card), fn(*on_cpu)
            ms = time_ms(lambda: fn(*on_card), 5)
            dev_ms = busy_ms(lambda: fn(*on_card))
        bad = packs_differ(cpu, card, MO_MARCH_ATOL)
        print(f"[march options a] {name}: {int(card.valid.sum())} samples "
              f"in {card.valid.shape[0]} slots, {ms:.3f} ms a march "
              f"(device busy {dev_ms:.3f}); card vs CPU "
              f"{'same' if not bad else 'DIFFER in ' + ', '.join(bad)}")
        check(not bad, f"phase 26 (a) {name}: card and CPU differ in {bad}")
    print(f"[march options a] {time.perf_counter() - t0:.2f} s")

    # --- (b) training under each option on the default copy's draws
    variants = {"default": {}, "span_adaptive": dict(span_adaptive=True),
                "group_compact": dict(group_compact=True),
                "legacy_flat": dict(compaction="flat"),
                "two_level_train": dict(march_two_level=True)}
    fwd_all = bwd_all = 0
    db = {}
    for name, kw in variants.items():
        t0 = time.perf_counter()
        t = base if name == "default" else trainer(
            dataclasses.replace(opts, **kw), f"mo_{name}")
        sc = step_card_vs_cpu(t, rands[0])
        print(f"[march options b] {name}: first step card vs CPU: loss rel "
              f"{sc['loss_rel']:.3e}, samples {sc['samples'][0]} / "
              f"{sc['samples'][1]}, worst gradient {sc['worst']} "
              f"{sc['grad_err']:.3e} of its largest entry")
        check(sc["loss_rel"] <= MO_LOSS_RTOL
              and sc["samples"][0] == sc["samples"][1]
              and sc["grad_err"] <= MO_GRAD_TOL,
              f"phase 26 {name}: the first step on the card vs the CPU {sc}")
        probes = []
        demand = t._eval_demand
        t._eval_demand = lambda *a: probes.append(1) or demand(*a)
        t1 = time.perf_counter()
        losses, fwd, bwd = k1_counted(
            lambda: [float(t.train_step(r)["loss"]) for r in rands])
        step_ms = (time.perf_counter() - t1) / MO_STEPS * 1e3
        if name == "legacy_flat":
            t._retune_budget()
        (img, _), rfwd, _ = k1_counted(
            lambda: t.render_image(val.poses[0], val.h, val.w))
        s_ = t.render_stats[-1]
        if name == "legacy_flat":   # no budget retune, no demand probe
            check(t.opts.flat_frac == opts.flat_frac and not probes,
                  f"phase 26 legacy: flat_frac {t.opts.flat_frac}, "
                  f"{len(probes)} eval demand probes")
        db[name] = psnr(img.clamp(0, 1), gt[..., :3])
        fwd_all += fwd + rfwd
        bwd_all += bwd
        print(f"[march options b] {name}: {MO_STEPS} steps, {step_ms:.2f} "
              f"ms a step (the first included), losses {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, K1 fwd {fwd} bwd {bwd}; val view 0 "
              f"{db[name]:.3f} dB in {s_['seconds']:.3f} s "
              f"({s_['chunks_rendered']} chunks, K1 {rfwd}, {s_['samples']} "
              f"samples, buckets {s_['buckets']}); "
              f"{time.perf_counter() - t0:.2f} s")
        check(np.isfinite(losses).all(), f"phase 26 {name}: loss {losses}")
        check(fwd == MO_STEPS and bwd == MO_STEPS,
              f"phase 26 {name}: K1 {fwd} / {bwd} for {MO_STEPS} steps")
        check(rfwd == s_["chunks_rendered"] and s_["nonfinite"] == 0,
              f"phase 26 {name}: K1 {rfwd} for {s_['chunks_rendered']} "
              f"chunks, {s_['nonfinite']} non-finite")
    gaps = {k: round(v - db["default"], 3) for k, v in db.items()}
    print(f"[march options b] val PSNR against the default copy's "
          f"{db['default']:.3f} dB: {json.dumps(gaps)}")
    for name in ("span_adaptive", "group_compact"):
        check(abs(gaps[name]) <= MO_NEAR_DB,
              f"phase 26 {name} {gaps[name]} dB from the default")
    for name in ("legacy_flat", "two_level_train"):
        check(db[name] >= MO_MIN_DB, f"phase 26 {name} {db[name]:.2f} dB")

    # --- (c) Seal teacher renders under the legacy compaction
    t0 = time.perf_counter()
    mapper = build_mapper(load_mapper_config(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "seal_config_bbox")))
    flat = dataclasses.replace(opts, compaction="flat")
    sealt = trainer(flat, "mo_seal", cls=SealTrainer, mapper=mapper,
                    teacher_params=st.ema_params,
                    teacher_bitfield=st.occ.bitfield)
    sealt.attach_dataset(NeRFDataset(
        poses=ds.poses[:MO_PROXY_VIEWS], images=ds.images[:MO_PROXY_VIEWS],
        intrinsics=ds.intrinsics, h=ds.h, w=ds.w))
    probes = []
    demand = sealt._teacher_demand
    sealt._teacher_demand = lambda *a: probes.append(1) or demand(*a)
    (timg, _), tfwd, _ = k1_counted(
        lambda: sealt.render_teacher_view(val.poses[0], val.h, val.w))
    _, pfwd, _ = k1_counted(sealt.proxy_datasets)
    simg, _ = sealt.render_image(val.poses[0], val.h, val.w)
    chunks = -(-val.h * val.w // min(cfg.eval_chunk, val.h * val.w))
    print(f"[march options c] Seal teacher under compaction flat: "
          f"{len(probes)} demand probes; a view K1 {tfwd} ({chunks} chunks), "
          f"proxy_datasets of {MO_PROXY_VIEWS} views K1 {pfwd} (per-chunk "
          f"fractions: {sealt.proxy_stats or 'none'}); the student (the "
          f"teacher's params) against the mapped teacher "
          f"{psnr(simg.clamp(0, 1), timg.clamp(0, 1)):.2f} dB; "
          f"{time.perf_counter() - t0:.2f} s")
    check(not probes and not sealt.proxy_stats and tfwd == chunks
          and pfwd == MO_PROXY_VIEWS * chunks
          and bool(torch.isfinite(timg).all()),
          f"phase 26 (c): {len(probes)} probes, K1 {tfwd} / {pfwd}")
    print(f"[march options] phase 26: {time.perf_counter() - t_phase:.1f} s "
          f"(budget 45)")
    return fwd_all + tfwd + pfwd, bwd_all


FIELD_HEAD_ROWS = 2**19     # a Seal-3D pretraining batch


def field_head_phase(dev, tr7, ds800, seal_head):
    """Phase 27: the field head's kernel pair (ops/field_head.py). Its
    launches where the main paths run it: one 800x800 view of phase 7's
    state (one forward a rendered chunk) and one train step of that state
    (none: the step trains the MLPs), beside the bbox edit's `seal_head`
    (forward, backward) from phase 14. Then at a pretraining batch's 2^19
    rows and the published widths, on features in +-1 and unit directions:
    forward and backward against the plain composition (errors over the
    largest value, and the share of rows off by more than 8 fp32 ulps of
    it: the bf16 flips), device times beside the plain composition's and
    the byte bound. -> its two kernel rows."""
    from seal3d_tpu_torch.config import (build_options, build_train_config,
                                         common_parser)
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.ops.mlp import mlp_init
    from seal3d_tpu_torch.ops import field_head as fh
    from seal3d_tpu_torch.train.trainer import Trainer

    counters = (fh.field_head_fwd, fh.field_head_bwd)
    cli = common_parser("chip_smoke").parse_args(O_ARGV)
    viewer = Trainer(ngp, tr7.fcfg, build_options(cli),
                     build_train_config(cli), dataset=ds800, device=dev)
    viewer.state = tr7.state
    for fn in counters:
        fn.launches = 0
    viewer.render_image(ds800.poses[0], ds800.h, ds800.w)
    view = tuple(fn.launches for fn in counters)
    chunks = viewer.render_stats[-1]["chunks_rendered"]
    for fn in counters:
        fn.launches = 0
    tr7.train_step()
    step = tuple(fn.launches for fn in counters)
    print(f"[field head] launches (forward, backward): an 800x800 view "
          f"{view} ({chunks} chunks rendered), a train step {step}, the "
          f"bbox edit {seal_head}")
    check(view == (chunks, 0) and step == (0, 0),
          f"field head launches: view {view} of {chunks} chunks, train step "
          f"{step}")

    m = FIELD_HEAD_ROWS
    gen = torch.Generator().manual_seed(27)
    nets = [[{"w": l["w"].to(dev)} for l in mlp_init(dims, generator=gen)]
            for dims in ([32, 64, 16], [63, 64, 64, 3])]
    ws = [l["w"] for net in nets for l in net]
    g = torch.Generator(device=dev).manual_seed(27)
    enc = torch.rand((m, 16, 4), generator=g, device=dev) * 2 - 1
    d = torch.nn.functional.normalize(
        torch.randn((m, 3), generator=g, device=dev), dim=-1)
    gs = torch.randn((m,), generator=g, device=dev)
    gr = torch.randn((m, 3), generator=g, device=dev)

    def off(got, want):
        scale = float(want.abs().max())
        err = (got - want).abs().reshape(m, -1).amax(1) / scale
        return float(err.max()), float((err > 8 * 2.0**-23).float().mean())

    with torch.no_grad():
        sigma, rgb = fh.field_head_fwd(enc, d, ws)
        ps, pr = fh.field_head_plain(enc, d, *nets, 4)
        g_enc = fh.field_head_bwd(enc, d, ws, gs, gr)
    x = enc.clone().requires_grad_(True)
    ps2, pr2 = fh.field_head_plain(x, d, *nets, 4)
    (pg,) = torch.autograd.grad([ps2, pr2], [x], [gs, gr], retain_graph=True)
    errs = {"sigma": off(sigma, ps), "rgb": off(rgb, pr),
            "enc cotangent": off(g_enc, pg)}
    k_fwd = time_device_ms(lambda: fh.field_head_fwd(enc, d, ws))
    k_bwd = time_device_ms(lambda: fh.field_head_bwd(enc, d, ws, gs, gr))
    with torch.no_grad():
        p_fwd = busy_ms(lambda: fh.field_head_plain(enc, d, *nets, 4))
    p_bwd = busy_ms(lambda: torch.autograd.grad([ps2, pr2], [x], [gs, gr],
                                                retain_graph=True))
    n_fwd = count_launches(lambda: fh.field_head_plain(x, d, *nets, 4))
    n_bwd = count_launches(lambda: torch.autograd.grad(
        [ps2, pr2], [x], [gs, gr], retain_graph=True))
    # bytes: features and directions in, sigma and rgb out; the backward
    # reads them again with both cotangents and writes the features'
    # cotangent. Operations: the fp32 output-layer backwards (K = 16 and
    # K = 3, 2 per multiply-add); the bf16 products at the tensor cores'
    # peak take about a quarter of the byte bound
    fwd_bound = bound(m * (256 + 12 + 4 + 12), 0)
    bwd_bound = bound(m * (256 + 12 + 4 + 12 + 256), m * 64 * 19 * 2)
    print(f"[field head] {m} rows: forward {k_fwd:.4f} ms (bound "
          f"{fwd_bound['bound_ms']:.4f}, plain {p_fwd:.4f} in {n_fwd} "
          f"launches), backward {k_bwd:.4f} ms (bound "
          f"{bwd_bound['bound_ms']:.4f}, plain {p_bwd:.4f} in {n_bwd} "
          f"launches); max error / share of rows off by > 8 ulps: "
          + ", ".join(f"{k} {e:.3e} / {s:.5f}" for k, (e, s) in errs.items()))
    for k, (e, s) in errs.items():
        check(e <= 2e-2 and s <= 0.02, f"field head {k}: error {e:.3e}, "
                                       f"{s:.5f} of the rows off")
    common = {"route": "CUDA C++, nvcc + ctypes",
              "source": "seal3d_tpu_torch/csrc/field_head.cu",
              "replaces": "none (XLA fuses the chain on the TPU; upstream "
                          "analogue ffmlp)",
              "library_ms": None}
    return [dict(common, name="field_head fwd",
                 launches=seal_head[0] + view[0],
                 max_abs_err=max(errs["sigma"][0], errs["rgb"][0]),
                 ms=k_fwd, plain_ms=p_fwd, **fwd_bound),
            dict(common, name="field_head bwd", launches=seal_head[1],
                 max_abs_err=errs["enc cotangent"][0], ms=k_bwd,
                 plain_ms=p_bwd, **bwd_bound)]


if __name__ == "__main__":
    main(sys.argv[1:])
